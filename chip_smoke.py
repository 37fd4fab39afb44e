#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from ``anerf_torch/csrc`` with nvcc
(sm_90a, one process per source, all started together), then:

1. kernel phase: K1 (one net, R=4096 rays x S=16) and K2 (two nets,
   R=4096 x S=64) at the SURREAL recipe's full width on realistic
   inputs, then at the train step's shapes (R=2048; K2 with viewfac,
   which the gate takes there), each held against
   its plain PyTorch twin on the card, two calls on the same inputs
   bit-identical, with median kernel time, the twin's time, the card's
   bound and achieved TFLOP/s;
2. backward kernel phase: K4 (two nets, R=2048 x S=64, with viewfac)
   and K3 (one net, R=2048 x S=16), the train step's shapes, held
   against their
   plain twins on the same inputs and the same incoming cotangent (that
   of an rgb loss after compositing), plus a ragged point count (S=24,
   R=171: a part-full last tile, every third ray across two tiles) with
   and without framecodes; kernel time, twin time, bound and achieved
   TFLOP/s; each pass's device time (per-tile, pullback, denc, bias, dW)
   from one profiled call; and two calls on the same inputs must give
   bit-identical outputs;
2b. viewfac phase (``viewfac_phase``): K-vf1 and K-vf2 (the view
   factorization's per-ray operand and fold, ``csrc/viewfac.cu``)
   against their twins at the train step's R=2048 and a ragged R=1999,
   bit-identical over two calls, timed beside their bounds and their
   ``torch.bmm`` yardsticks (one call for K-vf1, two for K-vf2), with
   K-vf2's two kernels from one profiled call;
   K2 and K4 with viewfac against the dense form (``rc.viewfac`` off) at
   anerf_tpu's bars between the two chains, both forms timed in turns
   with K4's passes; the flagship step with viewfac and dense, eager
   and bundled, in turns;
2c. fuse_tform phase (``fuse_tform_phase``): K1-K4's in-kernel rigid
   transform forms (the depths and each ray's affine rows in place of
   the points) against their twins at a ragged point count and at the
   kernel phases' shapes, two calls bit-identical, each timed in turns
   with its dense form beside its bound and twin (K3/K4 with their
   passes); one flagship step's maps and gradients against the dense
   form on the same state, batch and draws, beside the floor of the
   dense form against itself with its points rescaled by one rounding;
   5 eager flagship steps launching the fuse_tform forms once a step and
   the point forms never; the flagship step both ways, eager and
   bundled, in turns; the render path both ways in turns (eval rays/s,
   the fuse_tform forms of K1/K2 once a chunk, the frames against the
   dense form's);
3. path phase: ``ImageRenderer.render_path`` renders bullet-time frames
   at 512x512 with 4096-ray chunks through the port's render path; the
   launch counts of K1 and K2 must each equal the number of chunks, the
   maps must be finite, and one chunk is checked against the plain
   (unfused) path on the card;
4. train phase: 25 steps of ``make_train_step`` at the SURREAL recipe
   (``testing_utils.build_flagship``: 2048 rays, pose refinement every
   20 steps); each of K1-K4 must launch once a step, K-vf1 twice and
   K-vf2 once (viewfac on the coarse pass, ``FLAGSHIP_STEP``), the losses must be
   finite and fall, the pose bank must hold still through step 18 and
   move at step 19, and one step's NeRF gradients on the fused backend
   must agree with the plain backend's; train rays/s over steps 5-24,
   seconds per step, peak device memory and a profile of one step;
5. split-MLP kernel phase: K5 and K6 (``fused_mlp``) on the encodings
   the plain encoders make of a two-subject scene, held against their
   twins (forward rows as in 1, every output of K6 as in 2): at a ragged
   4104 points with and without framecodes, then K5 at the eval coarse
   chunk (n=262,144) and the train shapes (n=131,072 and 32,768) and K6
   at the train shapes, with kernel time, twin time, bound and TFLOP/s,
   the two-call determinism check of both, and K6's passes as in 2;
6. multi-subject path phase: one bullet-time frame of the two-subject
   model at 512x512 (chunk 4096); K5 must launch 3 times a chunk and
   K1-K4 never, and one chunk must match the plain path;
7. multi-subject train phase: 12 steps of
   ``build_flagship(2048, n_subjects=2)`` (two subjects with different
   rest poses); K5 and K6 must launch 3 times a step and K1-K4 never,
   the losses must be finite, one step's NeRF gradients must agree with
   the plain backend's, and the same rays as subject 0 and subject 1
   must give other colors and the same densities; train rays/s, ms/step,
   peak memory and a profile of one step;
2d. encmlp_shapes phase (``encmlp_shapes_phase``, ROADMAP B.1): K1-K4
   built per static shape, at R=2048 (K2/K4 at S=64, K1/K3 at S=16, the
   train step's tile) on weights whose composited cotangent reaches
   every net: five view PE rows, seven (viewfac at S=64, with K-vf1 and
   K-vf2 at their own build against their twins), four kp bands at six
   layers (also under fuse_tform), four layers (no skip layer), the
   windowed bone directions and framecodes of 8 (zero-padded to 16),
   then surreal_single's one view row at its 96 (viewfac) and 48
   samples, and (ROADMAP B.1.2: the trunk input in device memory where
   it does not fit) two 8x512 nets (viewfac with K-vf1/K-vf2 at a
   256-wide views layer; also under fuse_tform), nine layers, eight kp
   bands and 16 layers of 512 at ten bands: each against its twin at
   the flagship's bars (the nine and 16 layers against an f64
   evaluation of the chain, ``DEEP_ENC_LAYERS``), two calls
   bit-identical, launches counted exactly, timed beside its twin and
   its bound; then (ROADMAP B.1.3: the views input at every width) 11
   view rows (also under fuse_tform), framecodes of 32, and 21 view rows
   with framecodes of 128 (the views input out of K1/K2's shared
   memory; also at two 8x512 nets), K-vf1/K-vf2 at 11 and 21 rows at
   their own builds; then (ROADMAP B.1.4's first part: the WIDE nets,
   K5/K6's body inside K1-K4, the activations in device memory) two
   8x768 nets (a 384-wide views layer: K-vf1/K-vf2 at HV 384; also under
   fuse_tform), two 8x1024 nets (the flagship1024's build), 8x1024 with
   21 view rows and framecodes of 128 (the views input rebuilt in each
   views block) and two 8x2048 nets (at R=1024, ``ENC_SHAPE_RS``), each
   held to its twin at the flagship's bars or, where K3/K4's RN-added
   sums miss them, to the f64 chain by the deep nets' rule; then
   (ROADMAP B.1.4's kp-band row) the cap F_MAX, 13 kp bands, at two
   8x256 and two 8x512 nets, held to the twin at the flagship's bars
   (the encode rounds as the twin's, bit for bit); then (B.1.4's depth
   rows: K1/K2's and K3/K4's recompute's sums rounded to nearest past 16
   layers, 8 WIDE) 20x512 at ten kp bands, 24x512 at seven, 24x256,
   32x256, 16x1024 and 16x2048 (R=512) at ten; every shape past 8 layers
   held to the f64 chain from the encode's own f32 bands;
2e. vf_widths phase (``vf_widths_phase``): K-vf1/K-vf2 at 11 view rows
   and a 256-wide views layer, and at 9 rows and views layers of 384,
   512 and 1024 and 21 rows at 512 (the WIDE nets'), each launched once
   and counted, then against their twins, bit-identical twice, timed
   beside ``torch.bmm``;
2f. views_kernel phase (``views_kernel_phase``, ROADMAP C.15): K5/K6
   at the views widths past 672 (views parts 648 + 32, 792 + 1 + 16 and
   1512 + 1 + 128: builds of views width 688, 832 and 1664, the last
   also at two 8x1024 nets) against their twins at 4104 and 131,072
   points, bit-identical twice, counted, timed at 131,072 with K6's
   passes;
8. single-net phase: ``configs/surreal_single.txt`` (one net, 96 + 48
   samples, no view PE bands: K1/K3 at the one-view-row build, viewfac
   on the coarse pass, where the gate prices S = 96 at the 128-point
   tile): one chunk rendered (K1 twice and K-vf1 once, K3-K6 never;
   maps within MAP_TOL of the plain path and of the split route, which
   the port took before, forced), 2 train steps (K1 and K3 twice a
   step, K-vf1 twice, K-vf2 once, K5/K6 never, finite losses), one
   step's NeRF gradients with viewfac off and the split route's, each
   against the step on the twins in f64 by the deep nets' rule and
   against each other at the bars those imply, and with viewfac on
   against off at viewfac's (``_check_routes``);
   then ``single_bundled`` (``bundled_phase`` on the recipe, K1/K3 and
   the viewfac kernels its counts a step) and ``single_timing`` (the
   train step eager and bundled and a 4096-ray eval chunk, the fused
   route in turns with the split route);
8b. wide_flagship phase (``wide_flagship_phase``): ``build_flagship(
   2048)`` with two 8x512 nets (K1-K4 and K-vf1/K-vf2 at the 256-wide
   views layer): a 4096-ray eval chunk (K2 and K1 once; maps within
   MAP_TOL of the plain path), 5 eager steps (``FLAGSHIP_STEP`` a step,
   K5/K6 never), one step's NeRF gradients of the fused route and of
   the split route it replaces (forced, ``_split_route``), each against
   an f64 evaluation of the step's chain by the deep nets' rule and
   against each other at the bars those imply (``_check_routes``),
   viewfac against dense at viewfac's bars, and
   both routes timed in turns (the step eager and bundled, the eval
   chunk); then ``wide_bundled``
   (``bundled_phase`` at the same nets);
8c. views_flagship phase (``wide_flagship_phase`` with ``VIEWS10``,
   ROADMAP B.1.3): the same at two 8x256 nets with 21 view rows and
   framecodes of 128 (the split route: K5/K6 at views width 1648); then
   ``views_bundled`` (``bundle_once``: one call of a 10-step bundle,
   its counters those of the warm-up steps and the capture, a finite
   loss); then ``ms_views`` (``ms_views_phase``, C.15): the two-subject
   model at 11 view rows, 4 eager steps through K5/K6 (3 a step,
   ``split_train``: finite losses, the fused-vs-plain gradients) and a
   10-step bundle (``bundle_once``), where K5/K6 raised before;
8d. flagship1024 phase (``wide_flagship_phase`` with ``W1024``, ROADMAP
   B.1.4's first part): the same as 8b at two 8x1024 nets, on K1-K4's
   WIDE body (K-vf1/K-vf2 at a 512-wide views layer), the split route it
   replaces K5/K6 at 8x1024; then ``flagship1024_bundled``
   (``bundle_once``);
8e. kp_cap phase (``kp_cap_phase``, ROADMAP B.1.4's kp-band row): the
   flagship recipe at ``multires`` = F_MAX (13 kp bands): one chunk of
   KP_CAP_CHUNK rays at the eval variant (K2 and K1 once each; maps
   finite and within MAP_TOL of the same chunk on their twins, disp_map
   on the rays lit on both sides; against the plain path at most
   KP_CAP_PLAIN_RAYS rays past MAP_TOL a map) and one train step
   (``FLAGSHIP_STEP``, K5/K6 never; a finite loss), launches counted;
8f. deep_flagship phase (``wide_flagship_phase`` with ``DEEP_FLAGSHIP``,
   ROADMAP B.1.4's depth row): the same as 8b at two 24x512 nets with
   one eager step, the split route it replaces K5/K6 at 24x512;
9. cli_train phase: K1-K4 held against their twins and timed at the
   shapes ``configs/mixamo.txt``'s step gives them (R=3072; S=16 for
   K1/K3, S=64 for K2/K4); then that recipe (joint mode, 3072 rays, L1, rot6d) trained for 40 steps
   through ``anerf_torch.run_train.train`` on a 24-frame 512x512
   synthetic data store of a realistic body size: each of K1-K4 must
   launch once a step and K5/K6 never, no step may wait for the stream
   (``set_sync_debug_mode(1)`` over the steps followed by no logging,
   checkpoint or validation), the logged losses must be finite, the pose
   bank must hold still through step 18 and move at step 19, the
   checkpoints, pose checkpoints, ``args.txt``, ``metrics.jsonl`` and the
   validation render's ``psnr.txt``/``ssim.txt`` must be written, and a
   second call must resume at step 40 with the parameters, moments and
   pose bank bit-identical to the first call's final ones; CLI train
   rays/s over steps 10-39, the Prefetcher's ms per batch and one
   profiled CLI step's device busy share and host waits (the
   DeviceFeeder's event wait among them);
10. cli_flipflop phase: ``configs/surreal.txt`` with pose refinement in
   the alternating mode (interval 4, pose every 2nd step, reset
   snapshots) for 12 steps through ``run_train.train``: at every step
   the NeRF parameters and Adam count must change exactly when the host
   gate says the NeRF fires, the pose bank exactly when it says the pose
   fires, the snapshot must equal the pre-update bank at each pose-turn
   start, kp_tracker_mean must be finite, and no step may wait for the
   stream;
11. cli_multisubject phase: two synthetic subjects of different body
   sizes, a store each, through ``run_train.train`` at the mixamo recipe
   for 4 steps: K5 and K6 three times a step, K1-K4 never;
12. cli_render phase (run right after cli_train, on its logdir):
   ``anerf_torch.run_render.main`` renders every render type from the
   mixamo checkpoint ``ckpt_00000040.pt`` and its 512x512 store (bullet,
   val with --eval, selected with the refined pose bank, interpolate
   with mixed framecodes, retarget, animate, poserot, bubble,
   correction, then mesh at res 64): each run's files written and
   frames finite, K1 and K2 launched once per chunk and K3-K6 never;
   a bullet frame and a mixed-framecode frame re-rendered through K1/K2's
   plain twins within 1e-3 of the frame's max, from that checkpoint
   and, for frames with content, from it with its NeRF weights drawn
   from seed 5; the mesh's density grid within 1e-3 of the same grid
   computed on the host CPU (off the joints, where the bone direction
   has none), and a mesh with vertices; seconds per bullet frame and eval rays/s through the
   entry point, the grid's device ms and points/s, and the host's
   meshing and turntable seconds;
13. grammar phases (run after 8; K5/K6 are also built for the trunk
   widths 117, 1152 and 1197 at the start): K5 and K6 at those widths
   (the kp + bone encodings of 'querypts' + 'axisang', 'relpos' +
   'axisang' and 'cat' + 'reldir') held against their twins at a
   ragged 4104 points with views 216 (+16) and 648 + 1 (+16), two calls
   bit-identical, and timed at n=131,072 with K6's passes; then the
   'relpos' + 'axisang' + 'rayangle' recipe at full width
   (``build_flagship(2048)``, cutoff windows on): 12 train steps with
   K5/K6 three times a step and K1-K4 never, losses finite and falling,
   fused gradients against the plain backend's, train rays/s and a
   profile of one step, and one 512x512 bullet-time frame (K5 three
   times a chunk, one chunk against the plain path); then 'cat' +
   'reldir' + 'world' and 'querypts' + 'axisang' + 'relray' without
   cutoff windows and 'relpos' + 'reldir' + 'relray' with
   ``normalize_cutoff``: one chunk rendered and 2 train steps each
   through K5/K6;
14. bundled phases (``train_bundled`` and ``train_bundled_tf``, the
   flagship under fuse_tform, after 4; ``ms_bundled`` after 7):
   ``make_multi_train_step`` at 10 steps a dispatch, each step after the
   first call's warm-up and capture a replay of one CUDA graph, on the
   flagship (K1-K4) and the two-subject model (K5/K6), 30 steps each
   (``bundled_phase``): parameters and pose bank against 30 eager steps
   from the same state and batches without draws, the pose bank (read
   after every replay) first moving at step 19, with draws on each
   replay's coarse depths fresh and bit-equal to the eager steps', the
   loss falling, one profiled bundle launching each kernel 10 times its
   count a step, no host sync inside a bundle; eager and bundled host
   ms/step and train rays/s (medians of alternating windows), device
   busy shares and peak memory;
15. cli_bundled phase (after 11): ``configs/mixamo.txt`` through
   ``run_train.train`` at ``--steps_per_dispatch 10`` on cli_train's
   store, 40 steps: the launch counters of the warm-up and capture,
   the pose bank first moving at step 19, no host sync inside a bundle
   window, logs, checkpoints and validation metrics; CLI train rays/s
   beside cli_train's one step a dispatch;
16. net_shapes phase (after 13; K5/K6 are also built for the nets of
   ``NET_SHAPES`` at the start): K5 and K6 at nets other than 8x256
   (6x256, 8x128, 10x256, 8x512, 4x128 without a skip layer, 8x384,
   8x1024, 6x768, 32x256; a net runs padded to the next multiple of
   256, past 512 with its activations in device memory) on the
   two-subject model's parts, held against their twins at a ragged
   4104 points (K6 on a composited cotangent), two calls bit-identical,
   checked (K6 of a net past 24 layers against an f64 evaluation of
   its chain, ``DEEP_NET_LAYERS``) and timed at n=131,072 with K6's
   passes and bounds at the real shape; then 2 train steps at each net
   (K5/K6 three times a step, K1-K4 never);
17. cli_net_width phase (after 15): ``configs/mixamo.txt`` at
   ``netwidth = 1024`` (the WIDE nets) and ``mlp_backend = 'pallas'``
   through ``run_train.train`` on a synthetic store, 4 steps, K1-K4 (and
   K-vf1/K-vf2) as ``FLAGSHIP_STEP`` counts them a step and K5/K6
   never, finite losses, then 10 more at ``--steps_per_dispatch`` 10
   (its counters those of the warm-up steps and the capture); then one
   bullet frame of its checkpoint through ``run_render.main`` (K1 and K2
   once a chunk, finite frames);
17b. cli_views phase (after 17, ``cli_net_width_phase`` with
   ``CLI_VIEWS``): the same recipe at ``multires_views = 5`` and
   ``framecode_size = 32`` (K1-K4 at 11 view rows and framecodes of
   32), 4 steps, then 10 more at ``--steps_per_dispatch`` 10 (its
   counters those of the warm-up steps and the capture), then one
   bullet frame through ``run_render.main``;
17c. cli_net_depth phase (after 17b, ``cli_net_width_phase`` with
   ``CLI_DEPTH``): the same recipe at two 24-layer nets, 4 steps (K1-K4
   as ``FLAGSHIP_STEP`` counts them, K5/K6 never), then one bullet
   frame through ``run_render.main``;
18. cli_fuse_tform phase (after 17): ``configs/mixamo.txt`` with
   ``fuse_tform = True`` through ``run_train.train`` on cli_train's
   store, 4 steps, K1-K4's fuse_tform forms once a step and their point
   forms never, finite losses;
19. dist_train phase (after 18; ROADMAP A.7, ``anerf_torch/parallel``):
   (a) a world of one under NCCL in this process: 3 flagship steps
   (pose every step) through ``shard_train_step`` bit-identical to
   ``make_train_step``'s under deterministic algorithms (the plain step
   run twice shows the bar can hold); (b) two gloo ranks spawned with
   ``torch.multiprocessing``, both on this card, on the flagship at full
   width without draws, the 2048-ray batch split 1024/1024 against the
   one-rank step on the same rays: the loss within 1e-5, each tree's
   all-reduced gradient at the backward bars, the NeRF parameters' and
   the pose bank's updates after 3 steps at DIST_NERF_UPD_COS_MIN and
   DIST_UPD_COS_MIN (beside one rank on the same rays permuted), the
   ranks' states bit-equal, K1-K4, K-vf1 and K-vf2 counted on each rank;
   (c) in (a)'s NCCL world of one, bundles of 3 steps through
   ``shard_train_step(..., stacked=True)`` (the CUDA graph holding the
   step's collectives), three calls bit-identical to as many eager
   sharded steps under deterministic algorithms, one replayed bundle
   profiled (K1-K4 once a step, K-vf1 twice, K-vf2 once, the NCCL
   kernels as many a step as one eager step's), and its ms/step in
   turns with the plain bundle's (``make_multi_train_step`` without a
   group); (d) in (b)'s ranks, a bundle of 3 steps on each (under gloo
   the steps' body in turn) bit-equal to as many eager sharded steps
   from the same start under deterministic algorithms, the ranks'
   bundles bit-equal, its launches counted;
20. dist_render phase: two gloo ranks render one 512x512 bullet frame
   at chunk 4096 (2048 rays a rank a chunk) through the sharded
   ``ImageRenderer``: K1 and K2 once a chunk on each rank, the ranks'
   frames bit-equal, within MAP_TOL of the one-rank frame (whether
   bit-equal is printed).  Two ranks share one card in 19 and 20, so
   their times are no scaling numbers.

Each phase prints its host seconds as it ends.  Every backward kernel's
dW pass is its two kernels (the point slices' partial tiles and their
sum in slice order); its passes line gives the pass's bound beside its
ms.

Prints the card (nvidia-smi name and power limit), a ``kernels`` JSON
line (K1-K6, K-vf1 ``vf_operand``, K-vf2 ``vf_fold`` and K1-K4's
fuse_tform forms ``encmlp_*_tf``; each kernel's launches are those of
the run whose shapes its row times: the flagship train steps for K1-K4
and K-vf1/K-vf2, the flagship train steps under fuse_tform for the
``_tf`` rows, the multi-subject train step for K5/K6; ``launches_by_path`` adds every path's, the
bundled ones counted at warm-up and capture; K1's and K2's rows add ``train_shape``, the
backward kernels' ``passes_ms``, K1-K4's ``cli_train_shape`` the
times, bound, error and launches at the CLI mixamo step's shapes, and
K5's and K6's ``trunk_widths`` those of the grammar phase's widths with
the launches of the path that runs each, and ``net_shapes`` those of
the net_shapes phase's nets with the launches of their train steps;
``dist_train``, ``dist_bundled`` and ``dist_render`` in
``launches_by_path`` add both ranks' launches;
K1-K4's and K-vf1/K-vf2's ``enc_shapes`` the times, bound, error and
launches of each of the encmlp_shapes phase's shapes, and K1, K3,
K-vf1 and K-vf2 ``surreal_single_times``, single_timing's numbers;
K1-K4's and K-vf1/K-vf2's ``wide_flagship_times`` the wide_flagship
phase's (the 8x512 step and eval chunk, both routes),
``launches_by_path`` also ``kp_cap_render`` and ``kp_cap_train``,
``views_flagship_times`` the views_flagship phase's,
``flagship1024_times`` the flagship1024 phase's and
``deep_flagship_times`` the deep_flagship phase's; K5's and K6's
``views_widths`` the views_kernel phase's numbers at each views width
with the launches of the path that runs it; K-vf1's and K-vf2's
``enc_shapes`` also the vf_widths phase's;
K2's and K4's ``viewfac_vs_dense`` the two forms' ms in turns; the
``_tf`` rows their dense forms' ms in turns, ``train_shape`` (K1/K2)
and ``fuse_tform_times``, the flagship step's and the render's both
ways),
and as its last line ``{"ok": true, "device": {...}}``.  Any
failure raises: the exit code is then non-zero and the last line is
not printed.  Without CUDA, or outside a checkout of the repository,
it fails the same way.
"""
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

# K1/K2 against their twins, on the raw rows [r, g, b, sigma]: both
# compute the same bf16-operand chain, so they differ by f32 summation
# order, sinf/expf rounding and the bf16 re-cast flips these cause
# between layers.  A flip moves one activation by one bf16 ulp (2^-8
# relative) and the rows by far less on average, so: mean |d| below
# 1e-3 x the channel's max |value|, the worst point below 2e-2 x it.
RAW_MEAN_TOL = 1e-3
RAW_MAX_TOL = 2e-2
# rendered maps against the plain unfused path: the bar anerf_tpu holds
# its fused kernels to (tests/test_pallas_encmlp.py:53)
MAP_TOL = 1e-3
# K3/K4 against their twins, every output (dp, denc, dcodes, each weight
# and bias gradient): the bar anerf_tpu holds between its own two
# backward implementations (tests/test_pallas_encmlp.py:236-237)
BWD_COS_MIN = 0.9999
BWD_RATIO_TOL = 5e-3
# one train step's NeRF gradients, fused against plain backend: the bar
# anerf_tpu holds its fused backend to against XLA
# (tests/test_pallas_encmlp.py:257-258)
GRAD_COS_MIN = 0.98
GRAD_RATIO_TOL = 0.1
TRAIN_STEPS = 25
# the kernels of one flagship train step: K1-K4 once each, and with
# viewfac on the coarse pass (K2/K4; the default, which the cost gate
# takes at S=64) K-vf1 before K2 and again before K4, K-vf2 after K4
FLAGSHIP_STEP = {'encmlp_fwd': 1, 'encmlp_dual_fwd': 1, 'encmlp_bwd': 1,
                 'encmlp_dual_bwd': 1, 'vf_operand': 2, 'vf_fold': 1}
# viewfac against the dense form (the same kernels with rc.viewfac off):
# anerf_tpu's bars between its two chains (tests/test_pallas_encmlp.py:
# 57-80, 166-200): the rgb rows within 2e-2 of their scale and sigma,
# which the views layer does not touch, within 1e-5; gradients at cosine
# > 0.998 and norm within 3%
VF_RGB_TOL = 2e-2
VF_SIGMA_TOL = 1e-5
VF_COS_MIN = 0.998
VF_RATIO_TOL = 3e-2
# K-vf1 (M, bf16) against its twin: the 27 exact products of each value
# summed in f32 in another order (the tensor cores' against the twin's
# sequential one), then rounded to bf16, so a value may land one bf16
# step (2^-7 of it, at most) away.  Where the 27 terms cancel to less
# than a bf16 step's worth of the f32 sums' own rounding, no order's sum
# is good to a bf16 step (``vf_m_check`` prints how many values of the
# exact sum, rounded, lie past one step of the twin's): each value may
# also differ by VF_M_SUM_ULPS x 2^-24 of the sum of its terms'
# magnitudes, the rounding of the two f32 sums
VF_M_ULP = 2. ** -7
VF_M_SUM_ULPS = 2.
# fuse_tform (the in-kernel rigid transform) against the dense form on
# one flagship step (same state, batch and draws).  The two forms round
# the points' transform differently (~1.8 f32 ulp apart on average), and
# the bf16 chain turns that into a flipped rounding or ReLU mask here and
# there: anerf_tpu's 8-ray bars (tests/test_pallas_encmlp.py:84-121; 1e-4
# maps, cosine 0.9999) do not hold at the 2048-ray step for any such
# change (the dense form against itself with its points scaled by
# 1 + 2^-22 reads below them too; the check prints that floor).  So the
# gradients are held at anerf_tpu's bar between two chains that round
# differently (viewfac's, VF_COS_MIN / VF_RATIO_TOL), and the maps at
# the bar the fused path is held to against the plain one (MAP_TOL) at
# the worst ray and 1e-5 of the scale on average
TF_COS_MIN = VF_COS_MIN
TF_RATIO_TOL = VF_RATIO_TOL
TF_MAP_TOL = MAP_TOL
TF_MAP_MEAN_TOL = 1e-5
TF_STEPS = 5            # eager flagship steps under fuse_tform, counted
CLI_TF_STEPS = 4        # cli_fuse_tform: run_train.train steps
# one flagship train step under fuse_tform: K1-K4's fuse_tform forms
# once each (counted apart from the point forms), viewfac as in
# FLAGSHIP_STEP
FLAGSHIP_STEP_TF = {'encmlp_fwd_tf': 1, 'encmlp_dual_fwd_tf': 1,
                    'encmlp_bwd_tf': 1, 'encmlp_dual_bwd_tf': 1,
                    'vf_operand': 2, 'vf_fold': 1}
MS_STEPS = 12           # multi-subject train steps
SINGLE_STEPS = 2        # surreal_single train steps
SINGLE_CHUNK = 4096     # surreal_single's eval chunk (its config's)
# the kernels of one surreal_single train step: K1 on the coarse and the
# importance samples and K3 for both, K-vf1 before the coarse pass's K1
# and K3, K-vf2 after that K3 (the gate takes viewfac at S = 96, priced
# at the 128-point tile the loop ends at; not at S = 48)
SINGLE_STEP = {'encmlp_fwd': 2, 'encmlp_bwd': 2, 'vf_operand': 2,
               'vf_fold': 1}
CLI_STEPS = 40          # cli_train: anerf_torch.run_train.train steps
FF_STEPS = 12           # cli_flipflop steps
CLI_MS_STEPS = 4        # cli_multisubject steps
BUNDLE = 10             # bundled phases: steps per dispatch (bench.py's)
BUNDLED_STEPS = 30      # bundled phases: steps, in bundles of BUNDLE
TIMING_WINDOWS = 5      # eager and bundled windows of BUNDLE steps, in turns
TIMING_ROUNDS = 2       # flagship_timing's rounds of each mode, in turns
# a bundle against as many eager steps from the same state and batches,
# no draws: the same kernels on the same inputs, but cuBLAS may pick
# other algorithms inside a graph and atomic sums (the gathers'
# backward) round in any order, and Adam turns a flipped sign of a
# near-zero gradient into a whole step, so each parameter leaf's and
# the pose bank's update over the run is held in direction and size,
# and the last loss within BUNDLE_LOSS_RTOL
BUNDLE_COS_MIN = 0.9999
BUNDLE_RATIO_TOL = 1e-3
BUNDLE_LOSS_RTOL = 1e-4
ROOT = os.path.dirname(os.path.abspath(__file__))
# the CLI phases' data stores and logdirs (removed at the end)
WORK = os.path.join(ROOT, '_smoke_work')

# published dense peaks (NVIDIA data sheets) by card:
# (bf16 tensor FLOP/s, f32 FLOP/s, HBM bytes/s)
PEAKS = {'H100 PCIe': (756e12, 51e12, 2.0e12),
         'H100 NVL': (835e12, 60e12, 3.9e12),
         'H100': (989e12, 67e12, 3.35e12)}     # SXM


def _peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    return PEAKS['H100']


def _time_ms(fn, reps, windows=5):
    """Device time per call of ``fn``: CUDA events around ``reps``
    back-to-back calls (the host queues each call while the device runs
    the last, so host work stays out of the reading), after a warm-up;
    the median over ``windows`` such runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    return statistics.median(per_call)


def _graph_ms(fn, reps, windows=5):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after a warm-up call), CUDA events around a replay, the median
    over ``windows`` replays.  For kernels of a few microseconds, whose
    wrappers' Python can take longer than the kernel: the replay leaves
    the host's launch rate out of the reading."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per_call.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(per_call)


def _rel_err(ref, got):
    """Per-channel (max |d|, mean |d|) over the channel's max |ref|."""
    out = []
    for c in range(ref.shape[0]):
        scale = ref[c].abs().max().item() + 1e-6
        d = (ref[c] - got[c]).abs()
        out.append((d.max().item() / scale, d.mean().item() / scale))
    return out


def kernel_inputs(FE, T, rc, cfg, params, S, R, device, codes=True,
                  tile=1024, fuse_tform=False):
    """K1/K2 operands at R rays x S samples from a synthetic scene
    (``codes=False``: a config without framecodes), the viewfac gate
    priced at a point tile of ``tile`` (the render path's 1024: dense;
    the train step's 512: viewfac at S >= 32 where ``rc.viewfac``).
    ``fuse_tform``: the same points as the in-kernel transform takes
    them, the depths (R, S) in place of the points and the rays' affine
    rows (``tform_rows``) appended as a ninth operand."""
    import torch
    from anerf_torch.models.factory import embed_state
    from anerf_torch.ops import encoders, rays as ray_ops
    _, bones, _, kps, skts, cyls = T.synthetic_pose(9, seed=0)
    b = T.to_device(T.synthetic_batch(R, 9, kps, skts, bones, cyls, seed=1),
                    device)
    near, far = ray_ops.get_near_far_in_cylinder(b['rays_o'], b['rays_d'],
                                                 b['cyls'], 0., 1.)
    z = ray_ops.sample_from_lineseg(near, far, S)
    pts = b['rays_o'][:, None] + b['rays_d'][:, None] * z[..., None]
    pts_t = encoders.transform_batch_pts_cm(pts, b['skts'])
    rays_t = encoders.transform_batch_rays(b['rays_d'][:, None], b['skts'])
    rays_t_norm = encoders.vec_norm(rays_t)[:, 0]
    tau = embed_state(cfg, rc, 10000)['tau']
    cams = b['cam_idxs'] if codes else None
    tf = (FE.tform_rows(b['skts'], b['rays_o'], b['rays_d']) if fuse_tform
          else None)
    st, est, p, enc, cutoff, tau_t = FE._build_call(
        rc, pts_t, rays_t_norm, params['cutoff_dist'], tau, cams, tile,
        tf_rows=tf, z_vals=z if fuse_tform else None)
    if not codes:     # the views weights without the framecode rows
        params = {k: dict(params[k], views_linear={
            'w': params[k]['views_linear']['w'][:-cfg.framecode_size],
            'b': params[k]['views_linear']['b']}) for k in ('coarse', 'fine')}
    codes = [FE._codes(params[k], cams) if cams is not None else None
             for k in ('coarse', 'fine')]
    flats = [FE.flatten_params_cm(params[k], st, est.J, est.view_nb)
             for k in ('coarse', 'fine')]
    if fuse_tform:
        return st, est, p, enc, codes, cutoff, tau_t, flats, tf
    return st, est, p, enc, codes, cutoff, tau_t, flats


def _check_close(name, ref, got):
    """Raw rows of a kernel against its twin; returns max |d|."""
    import torch
    worst_max = worst_mean = max_abs = 0.
    for net, (r, g) in enumerate(zip(ref, got)):
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name}: non-finite kernel output')
        max_abs = max(max_abs, (r - g).abs().max().item())
        for ch, (mx, mn) in enumerate(_rel_err(r, g)):
            print(f'  {name} net{net} ch{ch}: max|d|/scale {mx:.3e} '
                  f'mean|d|/scale {mn:.3e}')
            worst_max, worst_mean = max(worst_max, mx), max(worst_mean, mn)
    if worst_max > RAW_MAX_TOL or worst_mean > RAW_MEAN_TOL:
        raise AssertionError(
            f'{name} disagrees with its plain twin: max {worst_max:.3e}'
            f' (tol {RAW_MAX_TOL}), mean {worst_mean:.3e} '
            f'(tol {RAW_MEAN_TOL})')
    return max_abs


def _calls(FE, st, est, p, enc, codes, cutoff, tau, flats, nnet, tf=None):
    """(kernel, twin) closures of K1 (nnet=1, the fine net) or K2;
    ``tf``: the affine rows under fuse_tform (``p`` the depths)."""
    if nnet == 1:
        args = (st, est, p, enc, codes[1], cutoff, tau, flats[1], tf)
        return (lambda: [FE.encmlp_fwd(*args)],
                lambda: [FE.encmlp_fwd_plain(*args)])
    args = (st, est, p, enc, *codes, cutoff, tau, *flats, tf)
    return (lambda: list(FE.encmlp_dual_fwd(*args)),
            lambda: list(FE.encmlp_dual_fwd_plain(*args)))


def kernel_phase(FE, T, rc, cfg, params, peaks, device, R=4096):
    import torch
    # ragged point counts (the last 64-point tile part-full) and a
    # config without framecodes, checked only
    for name, S, nnet, Rr, codes in (('encmlp_fwd', 16, 1, 7, True),
                                     ('encmlp_dual_fwd', 24, 2, 3, False)):
        ins = kernel_inputs(FE, T, rc, cfg, params, S, Rr, device, codes)
        run, plain = _calls(FE, *ins, nnet)
        print(f'{name} n={Rr * S} codes={codes}:')
        _check_close(name, plain(), run())
    rows = []
    # the eval chunk's shapes (the kernels line), then the train step's
    for name, S, nnet, Rr in (('encmlp_fwd', 16, 1, R),
                              ('encmlp_dual_fwd', 64, 2, R),
                              ('encmlp_fwd', 16, 1, R // 2),
                              ('encmlp_dual_fwd', 64, 2, R // 2)):
        # the train step's shapes at its tile: K2 with viewfac
        st, est, p, enc, codes, cutoff, tau, flats = kernel_inputs(
            FE, T, rc, cfg, params, S, Rr, device,
            tile=1024 if Rr == R else 512)
        run, plain = _calls(FE, st, est, p, enc, codes, cutoff, tau, flats,
                            nnet)
        got = run()
        torch.cuda.synchronize()
        print(f'{name} R={Rr} S={S}:')
        max_abs = _check_close(name, plain(), got)
        _check_deterministic(name, _named(got), _named(run()))
        del got
        row = _timed_row(
            name, 'encmlp_fwd.cu', 345 if nnet == 1 else 709,
            FE.kernel_cost(st, est, p.shape[0], nnet), _time_ms(run, 10),
            _time_ms(plain, 2), max_abs, peaks, f'R={Rr} S={S}')
        if Rr == R:
            rows.append(row)
        else:     # the train shape, beside the eval row
            eval_row = next(r for r in rows if r['name'] == name)
            eval_row['train_shape'] = {k: row[k] for k in (
                'ms', 'plain_ms', 'bound_ms', 'max_abs_err')}
            eval_row['train_shape']['points'] = Rr * S
    return rows


def _named(outs):
    """A forward kernel's outputs as the named list
    ``_check_deterministic`` takes."""
    return [(f'out{i}', t) for i, t in enumerate(outs)]


def _timed_row(name, source, tpu_line, cost, ms, plain_ms, max_abs, peaks,
               shape, tpu_file='pallas_encmlp.py'):
    """Print a kernel's time against its twin and its bound; return its
    row of the ``kernels`` line (launches filled in later)."""
    t_ops = cost['bf16_flops'] / peaks[0] + cost['f32_flops'] / peaks[1]
    t_bytes = cost['bytes'] / peaks[2]
    bound_ms = 1e3 * max(t_ops, t_bytes)
    print(f'{name}: {shape} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
          f'bound {bound_ms:.4f} ms ({cost["bf16_flops"]:.3e} bf16 FLOP, '
          f'{cost["bytes"] / 1e6:.1f} MB), '
          f'{cost["bf16_flops"] / (ms * 1e-3) / 1e12:.1f} TFLOP/s')
    return dict(name=name, route='cuda', source=f'anerf_torch/csrc/{source}',
                replaces=f'anerf_tpu/ops/{tpu_file}:{tpu_line}',
                launches=None, max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by='operations' if t_ops >= t_bytes else 'bytes',
                library_ms=None)


def _cmp(ref, got):
    """(cosine, norm ratio, worst |d| over max |ref|, max |d|) of two
    tensors."""
    a, b = ref.double().ravel(), got.double().ravel()
    na, nb = a.norm().item(), b.norm().item()
    cos = 1.0 if na == nb == 0 else (a @ b).item() / (na * nb + 1e-300)
    d = (a - b).abs()
    return (cos, nb / na if na > 0 else 1.0,
            d.max().item() / (a.abs().max().item() + 1e-30), d.max().item())


def _check_deterministic(name, first, second):
    """Two calls of a kernel on the same inputs must give bit-identical
    outputs (no atomics: every sum runs in a fixed order)."""
    import torch
    for (k, a), (_, b) in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f'{name} {k} differs between two calls on '
                                 'the same inputs')
    print(f'  {name}: {len(first)} outputs bit-identical over two calls')


# the passes of each backward kernel by kernel name (substrings of the
# profiler's demangled names); the dW pass is its two kernels, the
# partial tiles of the point slices and their sum in slice order
DW_KERNELS = ('dw_kernel', 'dw_sum_kernel')
# K-vf1 (M before the backward), K4's Gram pass and K-vf2's kernels (the
# column blocks' denc sum past 256 views columns)
VF_KERNELS = ('vf_m_mma_kernel', 'vf_gram_kernel', 'vf_fold_kernel',
              'vf_fold_sum_kernel', 'vf_denc_sum_kernel')
BWD_PASSES = {
    'encmlp_dual_bwd': (('per-tile', ('bwd_tile_kernel<2,',)),
                        ('pullback', ('pullback_kernel<2,',)),
                        ('denc', ('denc_kernel<2,',)),
                        ('bias', ('bias_kernel',)), ('dW', DW_KERNELS),
                        ('viewfac', VF_KERNELS)),
    'encmlp_bwd': (('per-tile', ('bwd_tile_kernel<1,',)),
                   ('pullback', ('pullback_kernel<1,',)),
                   ('denc', ('denc_kernel<1,',)),
                   ('bias', ('bias_kernel',)), ('dW', DW_KERNELS),
                   ('viewfac', VF_KERNELS)),
    'vf_fold': (('fold', ('vf_fold_kernel',)),
                ('slice sum', ('vf_fold_sum_kernel',)),
                ('denc sum', ('vf_denc_sum_kernel',))),
    'mlp_bwd': (('per-tile', ('mlp_bwd_tile_kernel',)),
                ('dx', ('dx_kernel',)), ('bias', ('bias_kernel',)),
                ('dW', DW_KERNELS)),
}


def pass_times(name, run, shape, dw=None, peaks=None):
    """Device ms of each pass of backward kernel ``name`` over one
    profiled call of ``run`` (after a warm-up), grouped by kernel name;
    'other' is the rest of the call (weight packing, output
    allocation).  ``dw``: the dW pass's work (``fused_mlp.dw_cost``),
    whose bound on ``peaks`` is printed and returned beside its ms as
    'dW_bound_ms'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = _device_ms
    events = [e for e in prof.key_averages()
              if dev(e) > 0 and str(e.device_type).endswith('CUDA')]
    if not events:
        print(f'{name} passes: device time not measured (no CUDA events)')
        return None
    out = {}
    for label, keys in BWD_PASSES[name]:
        out[label] = sum(dev(e) for e in events
                         if any(k in e.key for k in keys))
    out['other'] = sum(dev(e) for e in events) - sum(out.values())
    line = ', '.join(f'{k} {v:.3f}' for k, v in out.items())
    if dw is not None:
        out['dW_bound_ms'] = 1e3 * max(
            dw['bf16_flops'] / peaks[0] + dw['f32_flops'] / peaks[1],
            dw['bytes'] / peaks[2])
        line += (f' (dW bound {out["dW_bound_ms"]:.3f}: '
                 f'{dw["bf16_flops"]:.3e} bf16 FLOP, '
                 f'{dw["bytes"] / 1e6:.1f} MB)')
    print(f'{name} passes at {shape} (one profiled call, device ms): '
          + line)
    return out


def _bwd_calls(FE, st, est, p, enc, codes, cutoff, tau, flats, g, nnet,
               tf=None):
    """(kernel, twin) closures of K3 (nnet=1) or K4, each returning the
    named outputs [(name, tensor)]: dp, denc, dcodes, every gradient;
    ``tf`` as ``_calls`` takes it (dp is the points' cotangent either
    way)."""
    def named(out):
        if nnet == 1:
            dp, denc, dc, gr = out
            items = [('dp', dp), ('denc', denc), ('dcodes', dc)]
            items += [(f'g{i}', x) for i, x in enumerate(gr)]
        else:
            dp, denc, dcc, dcf, grc, grf = out
            items = [('dp', dp), ('denc', denc), ('dcodes_c', dcc),
                     ('dcodes_f', dcf)]
            items += [(f'coarse.g{i}', x) for i, x in enumerate(grc)]
            items += [(f'fine.g{i}', x) for i, x in enumerate(grf)]
        return [(k, v) for k, v in items if v is not None]
    if nnet == 1:
        args = (st, est, p, enc, codes[1], cutoff, tau, flats[1], g[0], tf)
        return (lambda: named(FE.encmlp_bwd(*args)),
                lambda: named(FE.encmlp_bwd_plain(*args)))
    args = (st, est, p, enc, *codes, cutoff, tau, *flats, g[0], g[1], tf)
    return (lambda: named(FE.encmlp_dual_bwd(*args)),
            lambda: named(FE.encmlp_dual_bwd_plain(*args)))


def _check_bwd(name, ref, got):
    """Every output of K3/K4 against its twin; returns max |d|."""
    import torch
    worst, max_abs = [], 0.
    for (k, r), (_, g) in zip(ref, got):
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name}: non-finite {k}')
        cos, ratio, rel, mx = _cmp(r, g)
        max_abs = max(max_abs, mx)
        worst.append((cos, k, ratio, rel))
        if cos < BWD_COS_MIN or abs(ratio - 1) > BWD_RATIO_TOL:
            raise AssertionError(f'{name} {k} disagrees with its twin: '
                                 f'cos {cos:.6f} ratio {ratio:.5f}')
    print(f'  {name}: {len(got)} outputs, worst |d|/max|ref| of each: '
          + ', '.join(f'{k} {rel:.1e}' for _, k, _, rel in worst))
    worst.sort()
    for cos, k, ratio, rel in worst[:4]:
        print(f'  {name} {k}: cos {cos:.7f} ratio {ratio:.5f} '
              f'worst |d|/max|ref| {rel:.3e}')
    return max_abs


def _composited_cotangent(FE, ins, nnet, device):
    """The raw cotangent a train step hands K3/K4: the gradient of an
    rgb MSE after compositing each net's raw (4, n) along its rays,
    taken through the plain forward on the kernel's inputs.  (A random
    N(0, 1) cotangent on every point weighs the points the compositing
    ignores as much as the rest; there the kernel's recompute, rounded
    in another order than the twin's, flips a ReLU mask now and then,
    which moves whole elements of the cotangents; the phase prints the
    cosines that gives as well.)"""
    st, est, p, enc, codes, cutoff, tau, flats = ins[:8]
    tf = ins[8] if len(ins) > 8 else None   # the fuse_tform form's rows
    if nnet == 2:
        outs = FE.encmlp_dual_fwd_plain(st, est, p, enc, *codes, cutoff, tau,
                                        *flats, tf)
    else:
        outs = [FE.encmlp_fwd_plain(st, est, p, enc, codes[1], cutoff, tau,
                                    flats[1], tf)]
    return _composite_grad(outs, est.S, device)


def _composite_grad(outs, S, device):
    """d(rgb MSE after compositing) / d raw for raw rows (4, n), n = R x S
    points in ray order, each a list entry; stacked (nnet, 4, n)."""
    import torch
    from anerf_torch.ops import compositing
    raws = [o.detach().requires_grad_(True) for o in outs]
    R = raws[0].shape[1] // S
    gen = torch.Generator(device=device).manual_seed(0)
    z = torch.linspace(0.5, 1.5, S, device=device).expand(R, S)
    rays_d = torch.randn((R, 3), generator=gen, device=device)
    target = torch.rand((R, 3), generator=gen, device=device)
    loss = 0.
    for raw in raws:
        r4 = raw.reshape(4, R, S)
        ret = compositing.raw2outputs_rows(r4[3], r4[0], r4[1], r4[2], z,
                                           rays_d)
        loss = loss + ((ret['rgb_map'] - target) ** 2).mean()
    return torch.stack(torch.autograd.grad(loss, raws))


def bwd_kernel_phase(FE, T, rc, cfg, params, peaks, device, R=2048):
    import torch
    # ragged point counts, checked only: S=24, R=171 is 4104 points, 64
    # full 64-point tiles and a part-full one, and every third ray
    # crosses a tile boundary
    for name, nnet, codes in (('encmlp_dual_bwd', 2, False),
                              ('encmlp_bwd', 1, True)):
        ins = kernel_inputs(FE, T, rc, cfg, params, 24, 171, device, codes)
        g = _composited_cotangent(FE, ins, nnet, device)
        run, plain = _bwd_calls(FE, *ins, g, nnet)
        print(f'{name} n=4104 S=24 codes={codes}:')
        _check_bwd(name, plain(), run())
    rows = []
    for name, S, nnet in (('encmlp_dual_bwd', 64, 2), ('encmlp_bwd', 16, 1)):
        # the train step's tile: K4 with viewfac
        ins = kernel_inputs(FE, T, rc, cfg, params, S, R, device, tile=512)
        st, est, p = ins[0], ins[1], ins[2]
        run, plain = _bwd_calls(FE, *ins,
                                _composited_cotangent(FE, ins, nnet, device),
                                nnet)
        got = run()
        torch.cuda.synchronize()
        print(f'{name} R={R} S={S}:')
        max_abs = _check_bwd(name, plain(), got)
        _check_deterministic(name, got, run())
        del got
        # why the bar takes the composited cotangent: a random one on
        # every point, printed only
        g_rand = torch.randn((nnet, 4, p.shape[0]), device=device,
                             generator=torch.Generator(device).manual_seed(0))
        run_r, plain_r = _bwd_calls(FE, *ins, g_rand, nnet)
        cos, k = min((_cmp(r, g)[0], k)
                     for (k, r), (_, g) in zip(plain_r(), run_r()))
        print(f'  {name} with an N(0, 1) cotangent on every point (not '
              f'held to the bar): worst cos {cos:.7f} ({k})')
        rows.append(_timed_row(
            name, 'encmlp_bwd.cu', 480 if nnet == 1 else 744,
            FE.kernel_cost(st, est, p.shape[0], nnet, backward=True),
            _time_ms(run, 5), _time_ms(plain, 1, windows=3), max_abs, peaks,
            f'R={R} S={S}'))
        rows[-1]['passes_ms'] = pass_times(
            name, run, f'R={R} S={S}',
            FE.fused_mlp.dw_cost(st, p.shape[0], nnet), peaks)
    return rows


def _vf_check_rows(name, ref, got):
    """K2's raw rows with viewfac against the dense form's (VF_RGB_TOL on
    rgb, VF_SIGMA_TOL on sigma, of each channel's max)."""
    for net, (r, g) in enumerate(zip(ref, got)):
        for ch in range(4):
            scale = r[ch].abs().max().item() + 1e-6
            d = (r[ch] - g[ch]).abs().max().item() / scale
            tol = VF_SIGMA_TOL if ch == 3 else VF_RGB_TOL
            print(f'  {name} net{net} ch{ch} viewfac vs dense: max|d|/scale '
                  f'{d:.3e} (bar {tol})')
            if d > tol:
                raise AssertionError(f'{name}: viewfac and dense differ past '
                                     f'the bar at net {net} ch {ch}')


def vf_m_check(name, est, enc, wvx, got, ref, exact=False):
    """K-vf1's M ``got`` against ``ref`` (the twin's, or another
    build's) on the view rows ``enc`` and weights ``wvx``: every value
    within VF_M_ULP of ``ref`` plus VF_M_SUM_ULPS x 2^-24 of the sum of
    its 27 terms' magnitudes; prints how many values differ, how many
    lie past one bf16 step and the worst of those over the sum bound
    (and, ``exact``, how many values of the exact sum, rounded to bf16,
    lie past one bf16 step of ``ref``).  Raises where a value misses the
    bar or is not finite."""
    import torch
    from anerf_torch.ops.fused_mlp import viewfac_m
    E = enc.to(torch.bfloat16).float()
    S = torch.stack([viewfac_m(E.abs(), w.float().abs(), est.J)
                     for w in wvx])
    x, y = ref.float(), got.float()
    if exact:
        nb = E.shape[1] // est.J
        ex = torch.einsum('rbj,nbjh->nrjh', E.double().reshape(-1, nb, est.J),
                          wvx.double().reshape(len(wvx), nb, est.J, -1))
        ex = ex.float().to(torch.bfloat16).float()
        print(f'  {name}: the exact sums rounded to bf16 lie past one bf16 '
              f'step of the reference at '
              f'{((ex - x).abs() > VF_M_ULP * x.abs()).sum().item()} values')
        del ex
    d = (y - x).abs()
    step = d > VF_M_ULP * x.abs()
    slack = (d - VF_M_ULP * x.abs()) / (2. ** -24 * S).clamp_min(1e-38)
    worst = slack[step].max().item() if step.any() else 0.
    bad = (step & (slack > VF_M_SUM_ULPS)).sum().item()
    print(f'{name}: M {tuple(y.shape)}, {(d > 0).float().mean().item():.2e} '
          f'of the values differ, {step.sum().item()} past one bf16 step '
          f'(worst {worst:.3f} f32 ulps of the sum of its terms, bar '
          f'{VF_M_SUM_ULPS}), {bad} past the bar')
    if bad or not torch.isfinite(y).all():
        raise AssertionError(f'{name}: M disagrees')
    return d.max().item()


def viewfac_kernels(FE, est, enc, wvx, peaks, device, R):
    """K-vf1 (M) and K-vf2 (the fold, on Gram matrices drawn N(0, 1) from
    seed 0, in bf16) on the view rows ``enc`` (R, 648) and both nets'
    ``wvx``: each against its twin (K-vf1 each value within VF_M_ULP of
    it, K-vf2 at ``_check_bwd``'s bars), two calls bit-identical.  With
    ``peaks``: each timed beside its bound (``vf_cost``), its twin and
    its yardstick in PyTorch (K-vf1: one ``torch.bmm`` of both nets' M;
    K-vf2: two, dWvx over nnet x J batches and denc over J batches with
    the nets side by side, bf16 outputs), all in one call, kernels and
    yardsticks replayed from CUDA graphs (``_graph_ms``), and K-vf2's
    two kernels' device ms from one profiled call; returns their rows."""
    import torch
    J, HV, nnet = est.J, wvx.shape[-1], wvx.shape[0]
    run = lambda: FE.vf_operand(est, enc, wvx)
    plain = lambda: FE.vf_operand_plain(est, enc, wvx)
    got, ref_m = run(), plain()
    m_err = vf_m_check(f'vf_operand R={R}', est, enc, wvx, got, ref_m,
                       exact=peaks is not None)
    _check_deterministic('vf_operand', [('M', got)], [('M', run())])

    gen = torch.Generator(device=device).manual_seed(0)
    gw = torch.randn((nnet, R, J, HV), generator=gen,
                     device=device).to(torch.bfloat16)
    fold = lambda: FE.vf_fold(est, gw, enc, wvx)
    fold_plain = lambda: FE.vf_fold_plain(est, gw, enc, wvx)
    got = list(zip(('dWvx', 'denc'), fold()))
    P, slice_ = FE.vf_fold_plan(R)
    print(f'vf_fold R={R} ({P} partial sums over slices of {slice_} '
          'rays):')
    ref = list(zip(('dWvx', 'denc'), fold_plain()))
    max_abs = _check_bwd('vf_fold', ref, got)
    _check_deterministic('vf_fold', got, list(zip(('dWvx', 'denc'),
                                                  fold())))
    if peaks is None:
        return []

    # the yardsticks: the same products as PyTorch calls on operands laid
    # out for them (outside the timing), each checked against the twin
    nb = enc.shape[1] // J
    E = enc.to(torch.bfloat16).reshape(R, nb, J).permute(2, 0, 1)
    m_ops = (E.contiguous(), torch.cat(
        [w.reshape(nb, J, HV).permute(1, 0, 2) for w in wvx], -1
    ).contiguous())
    dw_ops = (E.transpose(1, 2).repeat(nnet, 1, 1).contiguous(),
              gw.permute(0, 2, 1, 3).reshape(nnet * J, R, HV).contiguous())
    denc_ops = (gw.permute(2, 1, 0, 3).reshape(J, R, nnet * HV).contiguous(),
                wvx.reshape(nnet, nb, J, HV).permute(2, 0, 3, 1)
                .reshape(J, nnet * HV, nb).contiguous())
    lib_m = lambda: torch.bmm(*m_ops)
    lib_fold = lambda: (torch.bmm(*dw_ops), torch.bmm(*denc_ops))
    m_lib = lib_m().reshape(J, R, nnet, HV).permute(2, 1, 0, 3)
    dw_lib, denc_lib = lib_fold()
    for k, a, b in (('M', ref_m, m_lib),
                    ('dWvx', ref[0][1], dw_lib.reshape(nnet, J, nb, HV)
                     .permute(0, 2, 1, 3).reshape(ref[0][1].shape)),
                    ('denc', ref[1][1], denc_lib.permute(1, 2, 0)
                     .reshape(ref[1][1].shape))):
        cos = _cmp(a.float(), b.float())[0]
        if cos < 0.9999:
            raise AssertionError(f'the torch.bmm yardstick of {k} computes '
                                 f'another function (cos {cos:.6f})')
    del ref_m, m_lib, dw_lib, denc_lib
    ms = {k: _graph_ms(f, 20) for k, f in (
        ('vf_operand', run), ('m_lib', lib_m), ('vf_fold', fold),
        ('fold_lib', lib_fold))}
    rows = []
    for name, line, cost, plain_ms, err, lib, what in (
            ('vf_operand', 151, FE.vf_cost(est, R, nnet, HV),
             _time_ms(plain, 5), m_err, ms['m_lib'],
             'torch.bmm (J, R, 27) x (J, 27, 2 HV), both nets'),
            ('vf_fold', 199, FE.vf_cost(est, R, nnet, HV, fold=True),
             _time_ms(fold_plain, 3), max_abs, ms['fold_lib'],
             'two calls: torch.bmm (2 J, 27, R) x (2 J, R, HV) for dWvx '
             'and (J, R, 2 HV) x (J, 2 HV, 27) for denc, bf16 outputs')):
        row = _timed_row(name, 'viewfac.cu', line, cost, ms[name], plain_ms,
                         err, peaks, f'R={R} two nets',
                         tpu_file='pallas_mlp.py')
        row['library_ms'], row['library'] = lib, what
        print(f'{name}: {what}: {lib:.4f} ms against the kernel\'s '
              f'{ms[name]:.4f}')
        rows.append(row)
    rows[1]['passes_ms'] = pass_times('vf_fold', fold,
                                      f'R={R} two nets, {P} partials')
    return rows


def viewfac_phase(FE, T, rc, cfg, params, peaks, device, gpu_line, R=2048):
    """The view factorization at the flagship train step's shapes (R=2048
    x S=64 coarse samples, the gate's 512-point tile): K-vf1 and K-vf2
    (``viewfac_kernels``) at R and, checked only, at a ragged R of 1999
    rays; K2 and K4 with viewfac against the same kernels with
    ``rc.viewfac`` off at anerf_tpu's bars between the two chains, and
    both timed in turns (dense, viewfac, viewfac, dense), with K4's
    passes; then the flagship step both ways, eager and bundled, in
    turns (``flagship_timing``).  (K2/K4 with viewfac against
    their twins: the kernel phases' train shapes.)  Returns (the
    K-vf1 and K-vf2 rows, {K2/K4 name: their dense and viewfac ms})."""
    import torch
    S = 64
    ins = kernel_inputs(FE, T, rc, cfg, params, S, R, device, tile=512)
    rc_dense = dataclasses.replace(rc, viewfac=False)
    ins_d = kernel_inputs(FE, T, rc_dense, cfg, params, S, R, device,
                          tile=512)
    if not ins[1].viewfac or ins_d[1].viewfac:
        raise AssertionError('the gate did not take viewfac at S=64 only '
                             'where rc.viewfac holds')
    st, est, p, enc, codes, cutoff, tau, flats = ins
    wvx = FE._wvx(st, flats)
    rows = viewfac_kernels(FE, est, enc, wvx, peaks, device, R)
    vf_ragged = 1999
    print(f'K-vf1/K-vf2 at a ragged R={vf_ragged} (the first rays of the '
          f'same inputs):')
    viewfac_kernels(FE, est, enc[:vf_ragged].contiguous(), wvx, None, device,
                    vf_ragged)

    # K2 and K4: viewfac against dense; timed in turns
    times = {}
    fwd_vf, fwd_d = _calls(FE, *ins, 2)[0], _calls(FE, *ins_d, 2)[0]
    _vf_check_rows('encmlp_dual_fwd', fwd_d(), fwd_vf())
    g = _composited_cotangent(FE, ins, 2, device)
    bwd_vf, bwd_d = _bwd_calls(FE, *ins, g, 2)[0], _bwd_calls(FE, *ins_d, g,
                                                               2)[0]
    worst = []
    for (k, a), (_, b) in zip(bwd_d(), bwd_vf()):
        cos, ratio, rel, _ = _cmp(a, b)
        worst.append((cos, k, ratio))
        if cos < VF_COS_MIN or abs(ratio - 1) > VF_RATIO_TOL:
            raise AssertionError(f'encmlp_dual_bwd {k}: viewfac against '
                                 f'dense cos {cos:.6f} ratio {ratio:.5f}')
    worst.sort()
    print('  encmlp_dual_bwd viewfac vs dense, worst outputs: ' + ', '.join(
        f'{k} cos {c:.6f} ratio {r:.4f}' for c, k, r in worst[:4])
        + f' (bars {VF_COS_MIN}, {VF_RATIO_TOL})')
    for name, dense, vf, reps in (('encmlp_dual_fwd', fwd_d, fwd_vf, 10),
                                  ('encmlp_dual_bwd', bwd_d, bwd_vf, 5)):
        t = [_time_ms(dense, reps), _time_ms(vf, reps), _time_ms(vf, reps),
             _time_ms(dense, reps)]
        times[name] = {'dense_ms': statistics.median([t[0], t[3]]),
                       'viewfac_ms': statistics.median([t[1], t[2]]),
                       'turns': t}
        print(f'{name} R={R} S={S}: dense {t[0]:.3f} ms, viewfac {t[1]:.3f},'
              f' viewfac {t[2]:.3f}, dense {t[3]:.3f} ({gpu_line})')
    for mode, run in (('dense', bwd_d), ('viewfac', bwd_vf)):
        times['encmlp_dual_bwd'][f'{mode}_passes_ms'] = pass_times(
            'encmlp_dual_bwd', run, f'R={R} S={S} {mode}')
    del fwd_vf, fwd_d, bwd_vf, bwd_d, g, ins, ins_d
    times['flagship_step'] = flagship_timing(
        T, device, gpu_line, 'viewfac against dense',
        {'viewfac': dict(viewfac=True), 'dense': dict(viewfac=False)})
    return rows, times


def flagship_timing(T, device, gpu_line, what, modes,
                    title='flagship step', n_rays=2048, route=None):
    """The flagship train step (``build_flagship(n_rays,
    steps_per_dispatch=BUNDLE, **modes[mode])``) in each of two modes:
    after each bundle's warm-up and capture, TIMING_ROUNDS rounds in
    turns of BUNDLE eager steps and one bundle of each; host ms/step
    (medians), the
    clock ending in ``synchronize()``.  ``route``: {mode: a context
    manager factory} around that mode's every call (the eager steps read
    the route at each call, a bundle at its capture).  Returns {mode:
    {'eager', 'bundled'}: ms}."""
    import torch
    from anerf_torch.training import trainer as TT
    route = route or {}
    ctx = lambda m: route[m]() if m in route else contextlib.nullcontext()
    runs = {}
    for mode, over in modes.items():
        setup, state, batches, multi = T.build_flagship(
            n_rays, device=device, compute_dtype='bfloat16',
            steps_per_dispatch=BUNDLE, **over)
        eager = TT.make_train_step(setup)
        g = torch.Generator(device=device).manual_seed(7)
        with ctx(mode):
            state, _ = multi(state, batches, g)       # warm-up, capture
            one = {k: v[0] for k, v in batches.items()}
            state, _ = eager(state, one, g)
        runs[mode] = [state, batches, multi, eager, g, one]
    torch.cuda.synchronize()
    first, second = modes
    ms = {(m, k): [] for m in runs for k in ('eager', 'bundled')}
    for w in range(TIMING_ROUNDS):
        for m in ((first, second) if w % 2 == 0 else (second, first)):
            state, batches, multi, eager, g, one = runs[m]
            for k in ('eager', 'bundled'):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx(m):
                    if k == 'eager':
                        for _ in range(BUNDLE):
                            state, _ = eager(state, one, g)
                    else:
                        state, _ = multi(state, batches, g)
                torch.cuda.synchronize()
                ms[m, k].append(1e3 * (time.perf_counter() - t0) / BUNDLE)
            runs[m][0] = state
    out = {m: {k: statistics.median(ms[m, k]) for k in ('eager', 'bundled')}
           for m in runs}
    print(f'{title}, {what} (medians of {TIMING_ROUNDS} rounds in '
          f'turns, ms/step): ' + ', '.join(
              f'{m} eager {out[m]["eager"]:.2f} bundled '
              f'{out[m]["bundled"]:.2f}' for m in out)
          + f'; rounds {({f"{m} {k}": [round(x, 2) for x in v] for (m, k), v in ms.items()})} ({gpu_line})')
    del runs
    torch.cuda.empty_cache()
    return out


def _turns(a, b, reps, windows=5):
    """Device ms per call of ``a`` and ``b`` in turns: a, b, b, a."""
    return [_time_ms(f, reps, windows) for f in (a, b, b, a)]


def _tf_step_check(FE, setup, state, batch, device):
    """One flagship step's maps and gradients under fuse_tform against
    the dense form on the same state, batch and draws (render_rays and
    ``loss_and_grads`` with generators seeded alike): the maps within
    TF_MAP_TOL of each map's scale at the worst ray and TF_MAP_MEAN_TOL
    on average, every NeRF and pose gradient leaf at TF_COS_MIN /
    TF_RATIO_TOL.  Printed beside them, the floor: the dense form against
    itself with its points scaled by 1 + 2^-22 (about the two forms' mean
    rounding difference).  Returns the worst readings of both."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    from anerf_torch.ops import encoders
    from anerf_torch.training import trainer as TT
    maps, grads = {}, {}
    scaled = lambda f: lambda *a: f(*a) * (1. + 2. ** -22)
    for mode in ('tf', 'dense', 'floor'):
        s2 = dataclasses.replace(setup, rc=dataclasses.replace(
            setup.rc, fuse_tform=mode == 'tf'))
        with _Wrapped(encoders, **({'transform_batch_pts_cm': scaled}
                                   if mode == 'floor' else {})):
            _, g_nerf, g_pose = TT.loss_and_grads(
                s2, state, batch,
                torch.Generator(device=device).manual_seed(3))
            pose, _ = TT.get_batch_pose(s2, state['pose_params'], batch)
            with torch.no_grad():
                maps[mode] = raycaster.render_rays(
                    s2.rc, state['params'], batch['rays_o'],
                    batch['rays_d'], s2.near, s2.far, pose,
                    embed_state(s2.cfg, s2.rc, 10000),
                    cam_idxs=batch['cam_idxs'],
                    generator=torch.Generator(device=device).manual_seed(3))
        grads[mode] = g_nerf + g_pose
    worst = {}
    for mode in ('tf', 'floor'):
        mx = mn = 0.
        for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
            ref, got = maps['dense'][k], maps[mode][k]
            scale = ref.abs().max().item() + 1e-6
            d = (ref - got).abs()
            mx = max(mx, d.max().item() / scale)
            mn = max(mn, d.mean().item() / scale)
        worst[mode] = [mx, mn]
    names = _leaf_names(state['params']) + [
        f'pose.{k}' for k in _leaf_names(state['pose_params'])]
    leaves = {}
    for mode in ('tf', 'floor'):
        leaves[mode] = []
        for k, a, b in zip(names, grads['dense'], grads[mode]):
            if a.norm().item() == 0:
                if b.norm().item() != 0:
                    raise AssertionError(f'{k}: a {mode} gradient where the '
                                         'dense form has none')
                continue
            cos, ratio, _, _ = _cmp(a.float(), b.float())
            leaves[mode].append((cos, k, ratio))
        leaves[mode].sort()
        worst[mode] += [leaves[mode][0][0], max(abs(r - 1) for _, _, r in
                                                leaves[mode])]
    for mode, what in (('tf', 'fuse_tform'), ('floor', 'floor: dense with '
                                              'points x (1 + 2^-22)')):
        mx, mn, cos, dr = worst[mode]
        print(f'  {what} vs dense: maps worst max|d|/scale {mx:.3e}, mean '
              f'{mn:.3e}; {len(leaves[mode])} gradient leaves, worst cos '
              f'{cos:.7f}, worst |ratio - 1| {dr:.2e}: ' + ', '.join(
                  f'{k} cos {c:.7f} ratio {r:.5f}'
                  for c, k, r in leaves[mode][:3]))
    mx, mn, cos, dr = worst['tf']
    if mx > TF_MAP_TOL or mn > TF_MAP_MEAN_TOL:
        raise AssertionError(f'fuse_tform maps off the dense form: max '
                             f'{mx:.3e}, mean {mn:.3e}')
    if cos < TF_COS_MIN or dr > TF_RATIO_TOL:
        raise AssertionError(f'fuse_tform gradients off the dense form: cos '
                             f'{cos:.6f}, |ratio - 1| {dr:.2e}')
    return worst


def fuse_tform_phase(FE, T, rc, cfg, params, peaks, device, gpu_line):
    """The in-kernel rigid transform (``rc.fuse_tform``; K1-K4 on the
    depths and the rays' affine rows): K1-K4's fuse_tform forms against
    their twins at a ragged point count and at the kernel phases' shapes
    (K1/K2 at the eval chunk R=4096 and the train step's R=2048, K3/K4 at
    the train step's on a composited cotangent), two calls
    bit-identical, each timed in turns with its dense form on the same
    points (dense, fuse_tform, fuse_tform, dense) beside its bound and
    twin, with K3/K4's passes; one flagship step's maps and gradients
    against the dense form (``_tf_step_check``); TF_STEPS eager flagship
    steps launching FLAGSHIP_STEP_TF a step and the point forms never;
    the flagship step both ways, eager and bundled, in turns
    (``flagship_timing``); the render path both ways
    (``tform_render_timing``).  Returns (the four rows, the train steps'
    launch counts, the render's, {name: times})."""
    import torch
    for name, S, nnet, Rr, codes in (('encmlp_fwd', 16, 1, 7, True),
                                     ('encmlp_dual_fwd', 24, 2, 3, False)):
        ins = kernel_inputs(FE, T, rc, cfg, params, S, Rr, device, codes,
                            fuse_tform=True)
        run, plain = _calls(FE, *ins[:8], nnet, tf=ins[8])
        print(f'{name} fuse_tform n={Rr * S} codes={codes}:')
        _check_close(f'{name}_tf', plain(), run())
    rows, times = [], {}
    for name, S, nnet, Rr in (('encmlp_fwd', 16, 1, 4096),
                              ('encmlp_dual_fwd', 64, 2, 4096),
                              ('encmlp_fwd', 16, 1, 2048),
                              ('encmlp_dual_fwd', 64, 2, 2048)):
        tile = 1024 if Rr == 4096 else 512
        ins = kernel_inputs(FE, T, rc, cfg, params, S, Rr, device, tile=tile,
                            fuse_tform=True)
        st, est = ins[:2]
        if not est.fuse_tform or est.viewfac != (tile == 512 and S == 64):
            raise AssertionError(f'{name}: statics {est}')
        run, plain = _calls(FE, *ins[:8], nnet, tf=ins[8])
        dense = _calls(FE, *kernel_inputs(FE, T, rc, cfg, params, S, Rr,
                                          device, tile=tile), nnet)[0]
        got = run()
        torch.cuda.synchronize()
        print(f'{name} fuse_tform R={Rr} S={S}:')
        max_abs = _check_close(f'{name}_tf', plain(), got)
        _check_deterministic(f'{name}_tf', _named(got), _named(run()))
        d = max((a - b).abs().max().item() / (a.abs().max().item() + 1e-6)
                for x, y in zip(dense(), got) for a, b in zip(x, y))
        print(f'  {name}_tf against the dense form on the same points: '
              f'worst max|d|/scale of a channel {d:.3e} (not held)')
        del got
        t = _turns(dense, run, 10)
        row = _timed_row(
            f'{name}_tf', 'encmlp_fwd.cu', 345 if nnet == 1 else 709,
            FE.kernel_cost(st, est, Rr * S, nnet), statistics.median(t[1:3]),
            _time_ms(plain, 2), max_abs, peaks, f'R={Rr} S={S} fuse_tform')
        row.update(dense_ms=statistics.median([t[0], t[3]]), turns_ms=t)
        print(f'{name} R={Rr} S={S}: dense {t[0]:.3f} ms, fuse_tform '
              f'{t[1]:.3f}, fuse_tform {t[2]:.3f}, dense {t[3]:.3f} '
              f'({gpu_line})')
        if Rr == 4096:
            rows.append(row)
        else:     # the train shape, beside the eval row
            eval_row = next(r for r in rows if r['name'] == f'{name}_tf')
            eval_row['train_shape'] = {k: row[k] for k in (
                'ms', 'plain_ms', 'bound_ms', 'max_abs_err', 'dense_ms',
                'turns_ms')}
            eval_row['train_shape']['points'] = Rr * S
    for name, S, nnet in (('encmlp_dual_bwd', 64, 2), ('encmlp_bwd', 16, 1)):
        ins = kernel_inputs(FE, T, rc, cfg, params, S, 2048, device,
                            tile=512, fuse_tform=True)
        st, est = ins[:2]
        n = 2048 * S
        g = _composited_cotangent(FE, ins, nnet, device)
        run, plain = _bwd_calls(FE, *ins[:8], g, nnet, tf=ins[8])
        dense = _bwd_calls(FE, *kernel_inputs(FE, T, rc, cfg, params, S, 2048,
                                              device, tile=512), g, nnet)[0]
        got = run()
        torch.cuda.synchronize()
        print(f'{name} fuse_tform R=2048 S={S}:')
        max_abs = _check_bwd(f'{name}_tf', plain(), got)
        _check_deterministic(f'{name}_tf', got, run())
        del got
        t = _turns(dense, run, 5)
        row = _timed_row(
            f'{name}_tf', 'encmlp_bwd.cu', 480 if nnet == 1 else 744,
            FE.kernel_cost(st, est, n, nnet, backward=True),
            statistics.median(t[1:3]), _time_ms(plain, 1, windows=3),
            max_abs, peaks, f'R=2048 S={S} fuse_tform')
        row.update(dense_ms=statistics.median([t[0], t[3]]), turns_ms=t)
        print(f'{name} R=2048 S={S}: dense {t[0]:.3f} ms, fuse_tform '
              f'{t[1]:.3f}, fuse_tform {t[2]:.3f}, dense {t[3]:.3f} '
              f'({gpu_line})')
        row['passes_ms'] = pass_times(
            name, run, f'R=2048 S={S} fuse_tform',
            FE.fused_mlp.dw_cost(st, n, nnet), peaks)
        rows.append(row)

    # the flagship step: both forms on one state and batch, then eager
    # steps under fuse_tform, counted
    setup, state, batch, step = T.build_flagship(
        2048, device=device, compute_dtype='bfloat16', fuse_tform=True)
    if not (setup.rc.fuse_tform and setup.rc.mlp_backend == 'fused'):
        raise AssertionError('the flagship setup lost fuse_tform')
    print('flagship step, fuse_tform against dense (same state, batch and '
          'draws):')
    times['step_check'] = _tf_step_check(FE, setup, state, batch, device)
    gen = torch.Generator(device=device).manual_seed(0)
    losses = []
    FE.reset_launch_counts()
    for _ in range(TF_STEPS):
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    expect = {k: 0 for k in counts}
    expect.update({k: TF_STEPS * n for k, n in FLAGSHIP_STEP_TF.items()})
    print(f'train under fuse_tform: {TF_STEPS} steps, launches {counts}')
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError('non-finite losses under fuse_tform')
    del setup, state, batch, step
    times['flagship_step'] = flagship_timing(
        T, device, gpu_line, 'fuse_tform against dense',
        {'fuse_tform': dict(fuse_tform=True), 'dense': dict(fuse_tform=False)})
    render_counts, times['render'] = tform_render_timing(
        FE, T, rc, cfg, params, device, gpu_line)
    return rows, counts, render_counts, times


def tform_render_timing(FE, T, rc, cfg, params, device, gpu_line, H=512,
                        chunk=4096, n_bullet=3):
    """``render_path`` of ``n_bullet`` bullet-time frames at H x H with
    fuse_tform and with the dense form, after a warm-up of each, in turns
    (dense, fuse_tform, fuse_tform, dense): eval rays/s of each, K1's and
    K2's fuse_tform forms once a chunk and nothing else under fuse_tform,
    and the frames within TF_MAP_TOL / TF_MAP_MEAN_TOL of the dense
    form's.  Returns (the launch counts of a fuse_tform render, {mode:
    eval rays/s})."""
    import numpy as np
    import torch
    from anerf_torch.models.factory import embed_state
    from anerf_torch.render.renderer import ImageRenderer
    rd, _ = _bullet_data(T, n_bullet, H)
    state = embed_state(cfg, rc, 10000)
    rend = {m: ImageRenderer(dataclasses.replace(rc, fuse_tform=m == 'tf'),
                             params, state, chunk=chunk, near=0., far=1.,
                             device=device) for m in ('dense', 'tf')}
    if not rend['tf'].rc.fuse_tform:
        raise AssertionError('the eval variant dropped fuse_tform')
    n_chunks = 0
    inner = rend['tf']._render_chunk

    def counted(*args):
        nonlocal n_chunks
        n_chunks += 1
        return inner(*args)
    rend['tf']._render_chunk = counted
    for r in rend.values():
        r.render_path(rd)                # warm-up
    rays_s, out = {'dense': [], 'tf': []}, {}
    for m in ('dense', 'tf', 'tf', 'dense'):
        torch.cuda.synchronize()
        if m == 'tf':
            n_chunks = 0
            FE.reset_launch_counts()
        t0 = time.perf_counter()
        out[m] = rend[m].render_path(rd)
        torch.cuda.synchronize()
        rays_s[m].append(_frame_rays(out[m]) / (time.perf_counter() - t0))
        if m == 'tf':
            counts = FE.launch_counts()
    expect = {k: 0 for k in counts}
    expect.update(encmlp_fwd_tf=n_chunks, encmlp_dual_fwd_tf=n_chunks)
    if counts != expect or n_chunks == 0:
        raise AssertionError(f'fuse_tform render launches {counts}, '
                             f'expected {expect}')
    worst = []
    for k in ('rgbs', 'accs', 'disps'):
        ref, got = out['dense'][k], out['tf'][k]
        if not np.isfinite(got).all():
            raise AssertionError(f'non-finite {k} under fuse_tform')
        scale = np.abs(ref).max() + 1e-6
        d = np.abs(ref - got)
        worst.append((d.max() / scale, d.mean() / scale, k))
    print(f'render fuse_tform vs dense, {n_bullet} frames {H}x{H}, {n_chunks}'
          f' chunks: ' + ', '.join(f'{k} max|d|/scale {a:.3e} mean {b:.3e}'
                                   for a, b, k in worst))
    if max(w[0] for w in worst) > TF_MAP_TOL or \
            max(w[1] for w in worst) > TF_MAP_MEAN_TOL:
        raise AssertionError('fuse_tform frames off the dense form')
    med = {m: statistics.median(v) for m, v in rays_s.items()}
    print(f'render: eval rays/s dense {rays_s["dense"][0]:.1f}, fuse_tform '
          f'{rays_s["tf"][0]:.1f}, fuse_tform {rays_s["tf"][1]:.1f}, dense '
          f'{rays_s["dense"][1]:.1f} (in turns; {gpu_line})')
    return counts, {'dense': med['dense'], 'fuse_tform': med['tf'],
                    'turns': [rays_s['dense'][0], rays_s['tf'][0],
                              rays_s['tf'][1], rays_s['dense'][1]]}


def split_inputs(FM, T, cfg, rc2, params2, R, S, device, codes=True,
                 cat_subject=False):
    """K5/K6 operands at R rays x S samples of the synthetic scene of
    ``rc2``'s subjects (``synthetic_pose(n_subjects=...)``): the plain
    encoders' encodings (``raycaster.encode_inputs``) as the train step
    makes them, for a model of several subjects the subject channel as
    its own part as the raycaster hands it over (``cat_subject``:
    appended to the view encoding, anerf_tpu's 649-wide part), the fine
    net's framecodes as their own part (``codes=False``: a net without
    them).  Returns (st, xs, xvs, flat)."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    from anerf_torch.models.nerf_mlp import framecode_select
    from anerf_torch.ops import rays as ray_ops
    ns = rc2.n_subjects
    _, bones, _, kps, skts, cyls = T.synthetic_pose(9, n_subjects=ns)
    b = T.to_device(T.synthetic_batch(R, 9, kps, skts, bones, cyls, seed=1),
                    device)
    subj = torch.as_tensor(T.subject_of_frame(9, ns), device=device)
    near, far = ray_ops.get_near_far_in_cylinder(b['rays_o'], b['rays_d'],
                                                 b['cyls'], 0., 1.)
    z = ray_ops.sample_from_lineseg(near, far, S)
    pts = b['rays_o'][:, None] + b['rays_d'][:, None] * z[..., None]
    pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    net = params2['fine']
    with torch.no_grad():
        v, r, d = raycaster.encode_inputs(rc2, params2, pts, b['rays_o'],
                                          b['rays_d'], pose,
                                          embed_state(cfg, rc2, 10000))
        ch = subj[b['kp_idx']].to(d.dtype)[:, None, None].expand(R, S, 1)
        if ns == 1:
            parts = [[v, r], [d]]
        else:
            parts = [[v, r], [torch.cat([d, ch], -1)] if cat_subject
                     else [d, ch]]
        if codes:
            c = framecode_select(net['framecodes'], b['cam_idxs'])
            parts[1].append(c[:, None].expand(R, S, c.shape[-1]))
        else:
            net = dict(net, views_linear={
                'w': net['views_linear']['w'][:-cfg.framecode_size],
                'b': net['views_linear']['b']})
    xs, xvs = [[a.reshape(R * S, a.shape[-1]).to(torch.bfloat16).contiguous()
                for a in ps] for ps in parts]
    st = FM.MLPStatic(depth=rc2.nerf.depth, width=rc2.nerf.width,
                      dparts=tuple(x.shape[1] for x in xs),
                      vparts=tuple(x.shape[1] for x in xvs),
                      half=rc2.nerf.width // 2, skips=tuple(rc2.nerf.skips))
    return st, xs, xvs, FM.flatten_params(net, st)


def _split_calls(FM, st, xs, xvs, flat, g=None):
    """(kernel, twin) closures of K5 (raw rows as (4, n), for
    ``_check_close``) or, given the cotangent g (n, 4), of K6 (named
    outputs for ``_check_bwd``: each part's cotangent, every gradient)."""
    if g is None:
        return (lambda: [FM.mlp_fwd(st, xs, xvs, flat).T],
                lambda: [FM.mlp_fwd_plain(st, xs, xvs, flat).T])

    def named(out):
        dxs, dxvs, grads = out
        return ([(f'dx{i}', x) for i, x in enumerate(dxs)]
                + [(f'dxv{i}', x) for i, x in enumerate(dxvs)]
                + [(f'g{i}', x) for i, x in enumerate(grads)])
    return (lambda: named(FM.mlp_bwd(st, xs, xvs, flat, g)),
            lambda: named(FM.mlp_bwd_plain(st, xs, xvs, flat, g)))


def _split_cotangent(FM, st, xs, xvs, flat, S, device):
    """K6's incoming cotangent (n, 4): that of an rgb loss after
    compositing K5's twin output along its rays."""
    raw = FM.mlp_fwd_plain(st, xs, xvs, flat).T
    return _composite_grad([raw], S, device)[0].T.contiguous()


def split_mlp_phase(FM, T, cfg, rc2, params2, peaks, device):
    """K5 and K6 against their twins on the two-subject scene's
    encodings: checked at a ragged 4104 points (S=24, R=171) with the
    raycaster's parts and with a 649-wide odd one without framecodes,
    then checked and timed at the eval coarse chunk (K5, R=4096 x S=64)
    and the train shapes (R=2048 x S=64 and x S=16, both kernels).
    Returns the kernels' rows at n=131,072."""
    import torch
    for codes, cat in ((True, False), (False, True)):
        st, xs, xvs, flat = split_inputs(FM, T, cfg, rc2, params2, 171, 24,
                                         device, codes, cat)
        print(f'mlp_fwd, mlp_bwd n=4104 S=24 parts {st.dparts} / '
              f'{st.vparts}:')
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        _check_close('mlp_fwd', plain(), run())
        g = _split_cotangent(FM, st, xs, xvs, flat, 24, device)
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        _check_bwd('mlp_bwd', plain(), run())
    timed = {}
    for R, S in ((4096, 64), (2048, 64), (2048, 16)):
        st, xs, xvs, flat = split_inputs(FM, T, cfg, rc2, params2, R, S,
                                         device)
        n = R * S
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        got = run()
        torch.cuda.synchronize()
        print(f'mlp_fwd R={R} S={S}:')
        max_abs = _check_close('mlp_fwd', plain(), got)
        _check_deterministic('mlp_fwd', _named(got), _named(run()))
        del got
        timed['mlp_fwd', n] = _timed_row(
            'mlp_fwd', 'mlp_fwd.cu', 267, FM.kernel_cost(st, n),
            _time_ms(run, 10), _time_ms(plain, 2), max_abs, peaks, f'n={n}',
            tpu_file='pallas_mlp.py')
        if R != 2048:
            continue
        g = _split_cotangent(FM, st, xs, xvs, flat, S, device)
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        got = run()
        torch.cuda.synchronize()
        print(f'mlp_bwd R={R} S={S}:')
        max_abs = _check_bwd('mlp_bwd', plain(), got)
        _check_deterministic('mlp_bwd', got, run())
        del got
        timed['mlp_bwd', n] = _timed_row(
            'mlp_bwd', 'mlp_bwd.cu', 276, FM.kernel_cost(st, n, backward=True),
            _time_ms(run, 5), _time_ms(plain, 1, windows=3), max_abs, peaks,
            f'n={n}', tpu_file='pallas_mlp.py')
        timed['mlp_bwd', n]['passes_ms'] = pass_times(
            'mlp_bwd', run, f'n={n}', FM.dw_cost(st, n), peaks)
    ws = FM.cuda_build.library('mlp_bwd').mlp_bwd_workspace_bytes(131072)
    print(f'mlp_bwd workspace at n=131,072: {ws / 2**30:.3f} GiB')
    # the rows of the train step's coarse samples
    return [timed['mlp_fwd', 131072], timed['mlp_bwd', 131072]]


def path_phase(FE, T, rc, cfg, params, device, gpu_line, per_chunk,
               n_bullet=3, what='path', H=512, chunk=4096):
    """``ImageRenderer.render_path`` over ``n_bullet`` bullet-time frames:
    each kernel must launch ``per_chunk[name]`` times a chunk (the rest
    none), the maps must be finite and not empty, and one chunk must
    match the plain path.  Returns the launch counts of the timed
    render."""
    import numpy as np
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    from anerf_torch.render.renderer import ImageRenderer, kp_to_valid_rays

    W = H
    rd, focal = _bullet_data(T, n_bullet, H)
    state = embed_state(cfg, rc, 10000)
    renderer = ImageRenderer(rc, params, state, chunk=chunk, near=0.,
                             far=1., device=device)
    n_chunks = 0
    inner = renderer._render_chunk

    def counted(*args):
        nonlocal n_chunks
        n_chunks += 1
        return inner(*args)

    renderer._render_chunk = counted
    renderer.render_path(rd)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    n_chunks = 0
    FE.reset_launch_counts()
    t0 = time.perf_counter()
    out = renderer.render_path(rd)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = FE.launch_counts()
    print(f'{what}: {len(rd["c2ws"])} frames {H}x{W}, {n_chunks} chunks, '
          f'launches {counts}')
    expect = {k: per_chunk.get(k, 0) * n_chunks for k in counts}
    if counts != expect or n_chunks == 0:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    for k in ('rgbs', 'accs', 'disps'):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f'non-finite {k}')
    if out['accs'].min() < 0. or out['accs'].max() > 1.:
        raise AssertionError('acc outside [0, 1]')
    if out['accs'].max() < 0.5:
        raise AssertionError('empty frames: the checks below would be vacuous')
    n_rays = _frame_rays(out)
    print(f'{what}: {n_rays} rays in {dt:.3f} s: {n_rays / dt:.1f} rays/s, '
          f'{dt / len(rd["c2ws"]):.3f} s/frame, acc mean '
          f'{out["accs"].mean():.4f} ({gpu_line})')
    profile_frame(renderer, rd)

    # one chunk from the middle of frame 0 against the plain path
    rays, valid, cyl, _ = kp_to_valid_rays(
        rd['c2ws'][:1], H, W, focal, kps=rd['kp3d'][:1], ext_scale=0.001)
    ro, rdir = rays[0]
    mid = max(len(ro) // 2 - chunk // 2, 0)
    sl = slice(mid, mid + chunk)
    C = len(ro[sl])
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    pose = {'kps': t(rd['kp3d'][0]).expand(C, 24, 3),
            'skts': t(rd['skts'][0]).expand(C, 24, 4, 4),
            'bones': t(rd['bones'][0]).expand(C, 24, 3),
            'cyls': t(cyl[0]).expand(C, 5)}
    cam = torch.full((C,), int(rd['cam_idxs'][0]), dtype=torch.long,
                     device=device)
    res = {}
    for backend in ('fused', 'plain'):
        rc_b = dataclasses.replace(renderer.rc, mlp_backend=backend)
        with torch.inference_mode():
            res[backend] = raycaster.render_rays(
                rc_b, renderer.params, t(ro[sl]), t(rdir[sl]), 0., 1., pose,
                renderer.state, cam_idxs=cam)
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        ref, got = res['plain'][k], res['fused'][k]
        scale = ref.abs().max().item() + 1e-6
        err = (ref - got).abs().max().item()
        print(f'  chunk {k}: max|d| {err:.3e} scale {scale:.3e} '
              f'rel {err / scale:.3e}')
        if err > MAP_TOL * scale:
            raise AssertionError(f'fused path disagrees on {k}')
    return counts


def _bullet_data(T, n_bullet, H):
    """The render data of ``n_bullet`` bullet-time frames of the synthetic
    subject at H x H, and the focal length."""
    import numpy as np
    from anerf_torch.render.poses import load_bullettime
    focal = 0.8 * H
    rest, bones, _, kps, _, _ = T.synthetic_pose(9, seed=0)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 1.2        # the subject's cylinder fills ~1/5 of the frame
    rd = load_bullettime(kps, bones, np.stack([c2w] * len(kps)), focal,
                         rest, selected_idxs=[0], n_bullet=n_bullet)
    rd['hwf'] = (np.full(3, H), np.full(3, H), rd['focals'])
    return rd, focal


def _frame_rays(out):
    """The rays ``render_path`` cast: those of each frame's box."""
    return sum(int((br[0] - tl[0]) * (br[1] - tl[1]))
               for tl, br in out['bboxes'])


def _device_ms(event):
    """Device ms of a profiler event (the attribute's name differs across
    torch versions)."""
    return getattr(event, 'self_device_time_total',
                   getattr(event, 'self_cuda_time_total', 0)) / 1e3


def _profile(what, run, top):
    """Run ``run`` once under torch.profiler; print its wall time, the
    device's busy share, the ``top`` kernels by device time and the host
    calls that wait for the device.  Returns (events, device-ms function)
    or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = _device_ms
    # device kernels only: a kernel launched inside an autograd Function
    # also counts as device time of the Function's own event
    events = [e for e in prof.key_averages()
              if dev(e) > 0 and str(e.device_type).endswith('CUDA')]
    busy_ms = sum(dev(e) for e in events)
    if busy_ms == 0:
        print('profile: device time not measured (no CUDA events)')
        return None
    print(f'profile: {what} {wall_ms:.1f} ms wall (profiled), device '
          f'busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.1%}, '
          f'{sum(e.count for e in events)} device kernels and copies')
    for e in sorted(events, key=dev, reverse=True)[:top]:
        print(f'  {dev(e):9.3f} ms {e.count:5d}x  {e.key[:90]}')
    # host calls that wait for the device (each one drains the queue)
    for e in prof.key_averages():
        if 'Synchronize' in e.key or e.key.startswith('cudaMemcpy'):
            print(f'  host {e.key}: {e.count}x, '
                  f'{e.cpu_time_total / 1e3:.1f} ms')
    return events, dev


def profile_frame(renderer, rd):
    """Device time by kernel over one rendered frame."""
    one = {k: (v[:1] if k != 'hwf' else tuple(x[:1] for x in v))
           for k, v in rd.items()}
    _profile('one frame', lambda: renderer.render_path(one), 12)


def train_phase(FE, T, device, gpu_line):
    """25 flagship train steps through the kernels; returns the launch
    counts of the run."""
    import torch
    setup, state, batch, step = T.build_flagship(
        2048, device=device, compute_dtype='bfloat16')
    if setup.rc.mlp_backend != 'fused' or setup.cfg.opt_pose_step != 20:
        raise AssertionError('the flagship setup changed')
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = step(state, batch, gen)          # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    setup, state, batch, step = T.build_flagship(
        2048, device=device, compute_dtype='bfloat16')
    gen = torch.Generator(device=device).manual_seed(0)
    bank = [state['pose_params']['bones'].clone()]
    losses = []
    FE.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        if i == 5:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
        bank.append(state['pose_params']['bones'].clone())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = FE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    print(f'train: {TRAIN_STEPS} steps, launches {counts}')
    expect = {k: 0 for k in counts}
    expect.update({k: TRAIN_STEPS * n for k, n in FLAGSHIP_STEP.items()})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    first, last = losses[:5].mean().item(), losses[-5:].mean().item()
    print(f'train: total_loss first 5 {first:.5f}, last 5 {last:.5f}')
    if not last < first:
        raise AssertionError('the loss did not fall')
    moved = [not torch.equal(bank[i + 1], bank[i]) for i in range(TRAIN_STEPS)]
    if any(moved[:19]) or not moved[19]:
        raise AssertionError(f'pose bank moved at steps '
                             f'{[i for i, m in enumerate(moved) if m]}, '
                             'expected first at 19')
    n_timed = TRAIN_STEPS - 5
    print(f'train: {2048 * n_timed / dt:.1f} train rays/s, '
          f'{dt / n_timed * 1e3:.2f} ms/step over steps 5-{TRAIN_STEPS - 1}, '
          f'peak device memory of a step {peak / 2**30:.2f} GiB '
          f'({gpu_line})')
    profile_step(step, state, batch, gen, K1_K4_GROUPS)
    check_backend_grads(setup, state, batch, device, 'train')
    return counts


def check_backend_grads(setup, state, batch, device, what):
    """One step's NeRF gradients, fused against plain backend, on the
    card."""
    import torch
    from anerf_torch.training import trainer as TT
    grads = {}
    for backend in ('fused', 'plain'):
        s2 = dataclasses.replace(setup, rc=dataclasses.replace(
            setup.rc, mlp_backend=backend))
        _, g_nerf, _ = TT.loss_and_grads(
            s2, state, batch, torch.Generator(device=device).manual_seed(3))
        grads[backend] = g_nerf
    names = _leaf_names(state['params'])
    worst = []
    for k, a, b in zip(names, grads['plain'], grads['fused']):
        if a.norm().item() == 0:
            if b.norm().item() != 0:
                raise AssertionError(f'{k}: fused gradient where plain has none')
            continue
        cos, ratio, _, _ = _cmp(a.float(), b.float())
        worst.append((cos, k, ratio))
        if cos < GRAD_COS_MIN or abs(ratio - 1) > GRAD_RATIO_TOL:
            raise AssertionError(f'fused gradient of {k} disagrees with plain:'
                                 f' cos {cos:.5f} ratio {ratio:.4f}')
    worst.sort()
    print(f'{what}: fused vs plain NeRF gradients, {len(worst)} leaves, '
          'worst: ' + ', '.join(f'{k} cos {c:.5f} ratio {r:.4f}'
                                for c, k, r in worst[:3]))


def split_train(FE, T, device, gpu_line, what, build, n_steps, falls):
    """``n_steps`` train steps of the setup ``build()`` makes, which the
    fused backend routes to the plain encode and K5/K6 (after one
    warm-up step on a separate state): K5 and K6 must launch 3 times a
    step and K1-K4 never, the losses must be finite (and, ``falls``, the
    last three below the first three); train rays/s over steps 2 to the
    last, ms/step, peak memory and a profile of one step, then the
    fused-vs-plain gradients of one step.  Returns (setup, state, batch,
    launch counts)."""
    import torch
    setup, state, batch, step = build()
    gen = torch.Generator(device=device).manual_seed(0)
    state, _ = step(state, batch, gen)          # warm-up
    torch.cuda.synchronize()
    setup, state, batch, step = build()
    gen = torch.Generator(device=device).manual_seed(0)
    losses = []
    FE.reset_launch_counts()
    for i in range(n_steps):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == n_steps - 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = FE.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu()
    print(f'{what}: {n_steps} steps, launches {counts}')
    expect = {k: 0 for k in counts}
    expect.update(mlp_fwd=3 * n_steps, mlp_bwd=3 * n_steps)
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    if falls and not losses[-3:].mean() < losses[:3].mean():
        raise AssertionError(f'the loss did not fall: {losses.tolist()}')
    n_timed = n_steps - 2
    print(f'{what}: total_loss {losses[0]:.5f} -> '
          f'{losses[-1]:.5f}; {2048 * n_timed / dt:.1f} train rays/s, '
          f'{dt / n_timed * 1e3:.2f} ms/step over steps 2-{n_steps - 1}, '
          f'peak device memory of a step {peak / 2**30:.2f} GiB '
          f'({gpu_line})')
    profile_step(step, state, batch, gen, K5_K6_GROUPS)
    check_backend_grads(setup, state, batch, device, what)
    return setup, state, batch, counts


def ms_train_phase(FE, T, device, gpu_line):
    """MS_STEPS multi-subject train steps (``build_flagship(2048,
    n_subjects=2)``) through K5/K6 (``split_train``); returns the launch
    counts of the run.  Then the subject channel reaching the output."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state

    def build():
        out = T.build_flagship(2048, n_subjects=2, device=device,
                               compute_dtype='bfloat16')
        if out[0].rc.mlp_backend != 'fused' or out[0].rc.n_subjects != 2:
            raise AssertionError('the multi-subject setup changed')
        return out
    setup, state, batch, counts = split_train(
        FE, T, device, gpu_line, 'multi-subject train', build, MS_STEPS,
        falls=False)

    # the same rays as subject 0 and as subject 1: other colors, the
    # same densities (the channel enters the views branch only)
    rc_e = setup.rc.eval_variant()
    pose = {k: batch[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    n = batch['rays_o'].shape[0]
    outs = []
    with torch.inference_mode():
        for subj in (0, 1):
            outs.append(raycaster.render_rays(
                rc_e, state['params'], batch['rays_o'], batch['rays_d'],
                setup.near, setup.far, pose,
                embed_state(setup.cfg, setup.rc, MS_STEPS),
                cam_idxs=batch['cam_idxs'],
                subject_idxs=torch.full((n,), subj, dtype=torch.long,
                                        device=device)))
    d_rgb = (outs[0]['rgb_map'] - outs[1]['rgb_map']).abs().max().item()
    d_alpha = (outs[0]['alpha'] - outs[1]['alpha']).abs().max().item()
    print(f'multi-subject: subject 0 vs 1 on the same rays: rgb max|d| '
          f'{d_rgb:.3e}, alpha max|d| {d_alpha:.3e}')
    if not (d_rgb > 1e-4 and d_alpha <= 1e-6):
        raise AssertionError('the subject channel does not reach the output '
                             'as it should')
    return counts


def _single_over():
    """``configs/surreal_single.txt``'s settings (its N_rand apart)."""
    from anerf_torch.utils.config import parse_config_txt
    over = parse_config_txt(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'configs',
        'surreal_single.txt'))
    return over.pop('N_rand'), over


def _split_route(FE):
    """``render_rays`` forced onto the split route (the plain encode and
    K5/K6), the route surreal_single took before K1-K4 were built for its
    one view row: a yardstick, for the ``with`` block only."""
    return _Wrapped(FE, kernel_shape_ok=lambda _: (lambda rc: False))


def _step_grads(FE, setup, state, batch, device):
    """One train step's NeRF gradients on the same state, batch and
    draws, by route: {route: [(leaf name, gradient)]}.  'dense': K1-K4
    with viewfac off, 'twins': their twins, 'f64': the twins' chain in
    f64 (``_f64_twins``), 'split': the plain encode and K5/K6
    (``_split_route``), 'split_twins': the same on K5/K6's twins,
    'viewfac': K1-K4 with viewfac on."""
    import torch
    from anerf_torch.training import trainer as TT
    FM = FE.fused_mlp
    grads = {}
    for route in ('dense', 'twins', 'f64', 'split', 'split_twins',
                  'viewfac'):
        s2 = dataclasses.replace(setup, rc=dataclasses.replace(
            setup.rc, viewfac=route == 'viewfac'))
        with contextlib.ExitStack() as routing:
            if route.startswith('split'):
                routing.enter_context(_split_route(FE))
            if route == 'split_twins':
                routing.enter_context(_Wrapped(
                    FM, mlp_fwd=lambda _: FM.mlp_fwd_plain,
                    mlp_bwd=lambda _: FM.mlp_bwd_plain))
            if route == 'f64':
                routing.enter_context(_f64_twins(FE))
            if route in ('twins', 'f64'):
                routing.enter_context(_kernel_twins(FE, backward=True))
            _, g, _ = TT.loss_and_grads(
                s2, state, batch,
                torch.Generator(device=device).manual_seed(3))
        grads[route] = list(zip(_leaf_names(state['params']), g))
    return grads


def _check_routes(what, grads):
    """``_step_grads``'s routes held: the fused route's dense form and
    the split route it replaces each against the f64 step by the deep
    nets' rule (``_check_bwd_f64``), each with its own twins (K1-K4's,
    K5/K6's); the two against each other at the bars those imply, leaf
    by leaf: within the sum of the two routes' angles to the f64 step,
    and a norm ratio within their two ratio bars.  A direct bar at the
    backward kernels' cosine (0.9999) cannot bind the two routes: they
    differ in the encode (the double-angle bands against the plain
    encoders' sines), whose bf16 rounding alone moves a step's gradients
    by ~1e-4 of cosine (surreal_single on an H100: 0.9999370 while nvcc
    contracted the kernels' encode, 0.9998551 with it rounded as the
    twins', on coarse.pts_linears.3.b; K1-K4's twins themselves read
    0.9998764 against the f64 step on coarse.pts_linears.0.b).  Then
    viewfac against dense at anerf_tpu's bars between those two chains
    (VF_COS_MIN, VF_RATIO_TOL)."""
    bars = {}
    for route, twin in (('dense', 'twins'), ('split', 'split_twins')):
        print(f'{what}: one step\'s NeRF gradients, the {route} route '
              'against the f64 chain:')
        bars[route] = {}
        _check_bwd_f64(f'{what} {route}', grads['f64'], grads[route],
                       grads[twin], bars[route])
    rows = []
    for (k, a), (_, b) in zip(grads['split'], grads['dense']):
        cos, ratio = _cmp(a.float(), b.float())[:2]
        (cd, td), (cs, ts) = bars['dense'][k], bars['split'][k]
        cos_bar = math.cos(math.acos(cd) + math.acos(cs))
        lo, hi = (1. - td) / (1. + ts), (1. + td) / (1. - ts)
        rows.append((cos - cos_bar, k, cos, cos_bar, ratio, lo, hi))
    rows.sort()
    worst = min(rows, key=lambda x: x[2])
    print(f'{what}: one step\'s NeRF gradients, the dense route against '
          f'the split route, {len(rows)} leaves, closest to the bar: '
          + ', '.join(f'{k} cos {c:.7f} (bar {cb:.7f}) ratio {r:.5f} '
                      f'({lo:.5f}-{hi:.5f})'
                      for _, k, c, cb, r, lo, hi in rows[:4])
          + f'; the worst cosine {worst[1]} {worst[2]:.7f} (bar '
          f'{worst[3]:.7f})')
    bad = [r[1:] for r in rows if r[0] < 0 or not r[5] <= r[4] <= r[6]]
    if bad:
        raise AssertionError(f'{what}: the dense gradients disagree with '
                             f'the split route: {bad}')
    worst = sorted((_cmp(a.float(), b.float())[:2] + (k,))
                   for (k, a), (_, b) in zip(grads['dense'],
                                             grads['viewfac']))
    print(f'{what}: one step\'s NeRF gradients, the viewfac route against '
          f'the dense route, {len(worst)} leaves, worst: '
          + ', '.join(f'{k} cos {c:.7f} ratio {r:.5f}'
                      for c, r, k in worst[:4])
          + f' (bars {VF_COS_MIN}, {VF_RATIO_TOL})')
    bad = [(k, c, r) for c, r, k in worst
           if c < VF_COS_MIN or abs(r - 1) > VF_RATIO_TOL]
    if bad:
        raise AssertionError(f'{what}: the viewfac gradients disagree '
                             f'with the dense route: {bad}')


def single_net_phase(FE, T, device, gpu_line):
    """``configs/surreal_single.txt`` on the card: its settings over
    ``build_flagship``'s recipe (which adds framecodes and pose
    refinement), ``mlp_backend`` as shipped: one net on 96 coarse and 48
    importance samples at one view PE row, a shape K1-K4 are built for
    (``kernel_shape_ok``), where the gate takes viewfac for the coarse
    pass (S = 96 prices at the 128-point tile).  One chunk of the train
    batch's rays rendered at the eval variant (K1 twice, K-vf1 once,
    K3-K6 never; maps finite and within ``MAP_TOL`` of the plain path,
    and of the split route), then ``SINGLE_STEPS`` train steps (K1 and K3
    twice a step, K-vf1 twice, K-vf2 once, K5/K6 never; finite losses),
    then one step's NeRF gradients on the same state, batch and draws:
    the fused route with viewfac off and the split route (forced,
    ``_split_route``) each against the step on K1-K4's twins in f64 and
    against each other, and with viewfac on against it off
    (``_check_routes``).  Returns the launch counts of the train
    steps."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    n_rays, over = _single_over()
    # weights from seed 1, whose random density is positive inside the
    # subject's cylinder (seed 0's renders empty maps)
    setup, state, batch, step = T.build_flagship(
        n_rays, device=device, compute_dtype='bfloat16', seed=1, **over)
    rc = setup.rc
    if (rc.mlp_backend != 'fused' or not rc.single_net
            or rc.view_embed.num_freqs != 0 or not FE.kernel_shape_ok(rc)):
        raise AssertionError('the surreal_single recipe changed')
    what = 'surreal_single'
    pose = {k: batch[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    res = {}
    for route in ('fused', 'split', 'plain'):
        rc_b = dataclasses.replace(
            rc.eval_variant(),
            mlp_backend='plain' if route == 'plain' else 'fused')
        FE.reset_launch_counts()
        with torch.inference_mode(), (_split_route(FE) if route == 'split'
                                      else contextlib.nullcontext()):
            res[route] = raycaster.render_rays(
                rc_b, state['params'], batch['rays_o'], batch['rays_d'],
                setup.near, setup.far, pose, embed_state(setup.cfg, rc, 10000),
                cam_idxs=batch['cam_idxs'])
        torch.cuda.synchronize()
        if route == 'fused':
            counts = FE.launch_counts()
    print(f'{what} render: {batch["rays_o"].shape[0]} rays, '
          f'launches {counts}')
    expect = {k: 0 for k in counts}
    expect.update(encmlp_fwd=2, vf_operand=1)
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        got = res['fused'][k]
        if not torch.isfinite(got).all():
            raise AssertionError(f'{what}: non-finite {k}')
        for ref_route in ('plain', 'split'):
            ref = res[ref_route][k]
            scale = ref.abs().max().item() + 1e-6
            err = (ref - got).abs().max().item()
            print(f'  {what} {k} against the {ref_route} route: max|d| '
                  f'{err:.3e} scale {scale:.3e}')
            if err > MAP_TOL * scale:
                raise AssertionError(f'{what}: fused route disagrees with '
                                     f'the {ref_route} route on {k}')
    if res['fused']['acc_map'].max() < 0.5:
        raise AssertionError(f'{what}: empty maps, the check above would '
                             'be vacuous')
    del res
    gen = torch.Generator(device=device).manual_seed(0)
    FE.reset_launch_counts()
    losses = []
    for _ in range(SINGLE_STEPS):
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    losses = torch.stack(losses).cpu()
    print(f'{what} train: {SINGLE_STEPS} steps, launches {counts}, '
          f'total_loss {losses.tolist()} ({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update({k: SINGLE_STEPS * n for k, n in SINGLE_STEP.items()})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    # one step's NeRF gradients by route (``_check_routes``)
    _check_routes(what, _step_grads(FE, setup, state, batch, device))
    return counts


def single_timing(FE, T, device, gpu_line):
    """surreal_single's fused route against the split route it replaces
    (``_split_route``), in turns: the train step eager and bundled
    (``flagship_timing``), and eval rays/s of a 4096-ray chunk (the
    config's chunk) at the eval variant, device ms in turns (split,
    fused, fused, split).  Returns {'step': ..., 'eval': ...}."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    n_rays, over = _single_over()
    out = {'step': flagship_timing(
        T, device, gpu_line, 'fused route against the split route',
        {'fused': dict(seed=1, **over), 'split': dict(seed=1, **over)},
        title='surreal_single step', n_rays=n_rays,
        route={'split': lambda: _split_route(FE)})}
    setup, state, _, _ = T.build_flagship(
        n_rays, device=device, compute_dtype='bfloat16', seed=1, **over)
    rc = setup.rc.eval_variant()
    _, bones, _, kps, skts, cyls = T.synthetic_pose(
        9, ext_scale=setup.cfg.ext_scale)
    b = T.to_device(T.synthetic_batch(SINGLE_CHUNK, 9, kps, skts, bones,
                                      cyls, seed=1), device)
    pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    est = embed_state(setup.cfg, rc, 10000)

    def chunk(route):
        def run():
            with torch.inference_mode(), (
                    _split_route(FE) if route == 'split'
                    else contextlib.nullcontext()):
                return raycaster.render_rays(
                    rc, state['params'], b['rays_o'], b['rays_d'],
                    setup.near, setup.far, pose, est, cam_idxs=b['cam_idxs'])
        return run
    t = [_time_ms(chunk(r), 3) for r in ('split', 'fused', 'fused', 'split')]
    ms = {'split': statistics.median([t[0], t[3]]),
          'fused': statistics.median([t[1], t[2]])}
    out['eval'] = {'chunk': SINGLE_CHUNK, 'turns_ms': t,
                   **{f'{k}_ms': v for k, v in ms.items()},
                   **{f'{k}_rays_s': SINGLE_CHUNK / (v * 1e-3)
                      for k, v in ms.items()}}
    print(f'surreal_single eval chunk of {SINGLE_CHUNK} rays, device ms in '
          f'turns: split {t[0]:.3f}, fused {t[1]:.3f}, fused {t[2]:.3f}, '
          f'split {t[3]:.3f}: fused {out["eval"]["fused_rays_s"]:.1f} eval '
          f'rays/s, split {out["eval"]["split_rays_s"]:.1f} ({gpu_line})')
    return out


# the wide_flagship phase (ROADMAP B.1.2): the flagship recipe with two
# nets 512 wide, on K1-K4 since B.1.2 (K-vf1/K-vf2 at a 256-wide views
# layer); its eager steps, and the eval chunk of WIDE_CHUNK rays (K2 at
# 262,144 points, K1 at 65,536)
W512 = dict(netwidth=512, netwidth_fine=512)
WIDE_STEPS = 5
WIDE_CHUNK = 4096
# the flagship1024 phase (ROADMAP B.1.4's first part): the flagship
# recipe with two 8 x 1024 nets, on K1-K4's WIDE body (K-vf1/K-vf2 at a
# 512-wide views layer), through the same phase
W1024 = dict(netwidth=1024, netwidth_fine=1024)
# the deep_flagship phase (ROADMAP B.1.4's depth row): the flagship
# recipe with two 24 x 512 nets, one eager step on K1-K4's deep builds
# (K3/K4's per-tile sums rounded to nearest), held with the split route
# it replaces (K5/K6 at 24 x 512) against the f64 step, both timed
DEEP_FLAGSHIP = dict(W512, netdepth=24, netdepth_fine=24)
# cli_net_depth: the mixamo recipe at two 24-layer nets through
# run_train.train and run_render.main (cli_net_width_phase)
CLI_DEPTH = dict(netdepth=24, netdepth_fine=24)


def _eval_viewfac(FE, rc):
    """K-vf1's launches a render chunk of ``rc``: 1 where the viewfac
    gate takes K2's coarse pass at the eval tile of 1024 (from 11 view
    rows), else 0."""
    erc = rc.eval_variant()
    est = FE._statics(erc, rc.n_joints, rc.N_samples, erc.pallas_tile,
                      True)[1]
    return int(est.viewfac and FE.viewfac_taken(est, erc.pallas_tile))


def wide_flagship_phase(FE, T, device, gpu_line, what='wide_flagship',
                        over=W512, title='wide flagship step (8 x 512)',
                        steps=WIDE_STEPS):
    """``build_flagship(2048)`` with two 8 x 512 nets on the card (or
    with the config overrides ``over``: the views flagship's 21 view
    rows and framecodes of 128, VIEWS10; the deep flagship's two 24 x
    512 nets, DEEP_FLAGSHIP), its
    weights from the first of NET_SEEDS whose eval chunk renders the
    subject (acc_map above 0.5 somewhere): one chunk of WIDE_CHUNK rays at
    the eval variant (K2 and K1 once each, nothing else; maps finite and
    within ``MAP_TOL`` of the plain path), then ``steps`` eager train
    steps (``FLAGSHIP_STEP`` a step, K5/K6 never; finite losses), one
    step's NeRF gradients on the same state, batch and draws (the fused
    route's dense form and the split route it replaces, ``_split_route``,
    each against the step on K1-K4's twins in f64 (``_f64_twins``), the
    two against each other, viewfac against dense: ``_check_routes``),
    and both
    routes timed in turns: the step eager and
    bundled (``flagship_timing``), and the eval chunk (device ms: split,
    fused, fused, split).  Returns (the eager steps' launch counts, the
    seed, the times)."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    for seed in NET_SEEDS:
        setup, state, batch, step = T.build_flagship(
            2048, device=device, compute_dtype='bfloat16', seed=seed, **over)
        rc = setup.rc
        if (rc.mlp_backend != 'fused' or not FE.kernel_shape_ok(rc)
                or any(getattr(setup.cfg, k) != v for k, v in over.items())):
            raise AssertionError(f'{what}: not the fused route at {over}')
        erc = rc.eval_variant()
        _, bones, _, kps, skts, cyls = T.synthetic_pose(
            9, ext_scale=setup.cfg.ext_scale)
        b = T.to_device(T.synthetic_batch(WIDE_CHUNK, 9, kps, skts, bones,
                                          cyls, seed=1), device)
        pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
        est = embed_state(setup.cfg, rc, 10000)

        def chunk(route, backend='fused'):
            def run():
                with torch.inference_mode(), (
                        _split_route(FE) if route == 'split'
                        else contextlib.nullcontext()):
                    return raycaster.render_rays(
                        dataclasses.replace(erc, mlp_backend=backend),
                        state['params'], b['rays_o'], b['rays_d'],
                        setup.near, setup.far, pose, est,
                        cam_idxs=b['cam_idxs'])
            return run
        FE.reset_launch_counts()
        got = chunk('fused')()
        torch.cuda.synchronize()
        counts = FE.launch_counts()
        if got['acc_map'].max() >= 0.5:
            break
    else:
        raise AssertionError(f'{what}: no seed of {NET_SEEDS} renders the '
                             'subject')
    print(f'{what} eval chunk: {WIDE_CHUNK} rays, weights from seed {seed}, '
          f'launches {counts}')
    shape = FE.kernel_shape(*FE._statics(rc, rc.n_joints, 64,
                                         FE.DEFAULT_TILE, True))
    n_c, n_e = 2048 * rc.N_samples, WIDE_CHUNK * rc.N_samples
    if str(device).startswith('cuda'):   # the builds' own reckoning
        print(f'{what}: workspaces of the build {shape}: K4 '
              f'{FE.cuda_build.library("bwd", enc=shape).encmlp_bwd_workspace_bytes(n_c, 2)} '
              f'bytes at the train step\'s n={n_c}, K1/K2\'s trunk input '
              f'{FE.cuda_build.library("fwd", enc=shape).encmlp_fwd_workspace_bytes(n_c)} '
              f'bytes there and '
              f'{FE.cuda_build.library("fwd", enc=shape).encmlp_fwd_workspace_bytes(n_e)} '
              f'at the eval chunk\'s n={n_e}')
    expect = {k: 0 for k in counts}
    expect.update(encmlp_fwd=1, encmlp_dual_fwd=1,
                  vf_operand=_eval_viewfac(FE, rc))
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    ref = chunk('fused', 'plain')()
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f'{what}: non-finite {k}')
        scale = ref[k].abs().max().item() + 1e-6
        err = (ref[k] - got[k]).abs().max().item()
        print(f'  {what} {k} against the plain path: max|d| {err:.3e} '
              f'scale {scale:.3e}')
        if err > MAP_TOL * scale:
            raise AssertionError(f'{what}: fused route disagrees with the '
                                 f'plain path on {k}')
    del got, ref
    gen = torch.Generator(device=device).manual_seed(0)
    FE.reset_launch_counts()
    losses = []
    for _ in range(steps):
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    losses = torch.stack(losses).cpu()
    print(f'{what} train: {steps} steps, launches {counts}, '
          f'total_loss {losses.tolist()} ({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update({k: steps * n for k, n in FLAGSHIP_STEP.items()})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    _check_routes(what, _step_grads(FE, setup, state, batch, device))
    train_counts = counts
    t = [_time_ms(chunk(r), 3) for r in ('split', 'fused', 'fused', 'split')]
    ms = {'split': statistics.median([t[0], t[3]]),
          'fused': statistics.median([t[1], t[2]])}
    times = {'eval': {'chunk': WIDE_CHUNK, 'turns_ms': t,
                      **{f'{k}_ms': v for k, v in ms.items()},
                      **{f'{k}_rays_s': WIDE_CHUNK / (v * 1e-3)
                         for k, v in ms.items()}}}
    print(f'{what} eval chunk of {WIDE_CHUNK} rays, device ms in turns: '
          f'split {t[0]:.3f}, fused {t[1]:.3f}, fused {t[2]:.3f}, split '
          f'{t[3]:.3f}: fused {times["eval"]["fused_rays_s"]:.1f} eval '
          f'rays/s, split {times["eval"]["split_rays_s"]:.1f} ({gpu_line})')
    del setup, state, batch, step
    torch.cuda.empty_cache()
    times['step'] = flagship_timing(
        T, device, gpu_line, 'fused route against the split route',
        {'fused': dict(seed=seed, **over), 'split': dict(seed=seed, **over)},
        title=title, route={'split': lambda: _split_route(FE)})
    return train_counts, seed, times


# the kp_cap phase (ROADMAP B.1.4's kp-band row): the flagship recipe at
# the kp band cap F_MAX through the entry points: an eval chunk of
# KP_CAP_CHUNK rays and one train step.  disp_map (compositing's
# 1 / (depth / acc)) is held to the twins on the rays whose unclamped
# acc reaches KP_CAP_ACC_MIN on both sides.  Below it disp is the mean
# of 1 / z over weights that are a few quanta each (alpha = 1 - exp(-x)
# comes in steps of 2^-24), so the MLP's last-bit differences move it
# by whole percents, and where acc is 1e-8 or less on one side only,
# compositing's guard (``isclose(acc, 0)``) zeroes that side's disp
# alone: the worst such ray is printed, its acc, disp and depth on both
# sides.  Against the plain path (each band's exact sine) at most
# KP_CAP_PLAIN_RAYS rays may pass MAP_TOL on any map (disp_map on the
# rays lit on both sides), twice the most the twins part from it by on
# the CPU at 4096 rays on a scene that renders the subject: 11 rays of
# rgb0 and acc0 (whole flips of opacity) at 13 bands, 2 at 14, 3 at 15,
# 0 at 7 and 10, and lit rays' disp never (scripts/kp_band_cap.py
# --render --rays 4096)
KP_CAP_CHUNK = 4096
KP_CAP_ACC_MIN = 1e-3
KP_CAP_PLAIN_RAYS = 22


def kp_cap_phase(FE, T, device, gpu_line):
    """``build_flagship(2048, multires=F_MAX)`` on the card, its weights
    from the first of NET_SEEDS whose eval chunk renders the subject
    (acc_map above 0.5 somewhere): one chunk of KP_CAP_CHUNK rays at the
    eval variant (K2 and K1 once each, K-vf1 where the eval gate takes
    viewfac, nothing else; maps finite and within ``MAP_TOL`` of the
    same chunk on K1/K2's twins, whose encode the kernels' matches bit
    for bit, disp_map on the rays lit on both sides; against the plain
    path at most KP_CAP_PLAIN_RAYS rays past MAP_TOL on each map), then
    one eager train step (``FLAGSHIP_STEP``, K5/K6 never; a finite
    loss).  Returns (the chunk's launch counts, the step's)."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    over = dict(multires=FE.F_MAX)
    for seed in NET_SEEDS:
        setup, state, batch, step = T.build_flagship(
            2048, device=device, compute_dtype='bfloat16', seed=seed, **over)
        rc = setup.rc
        shape = FE.kernel_shape(*FE._statics(rc, rc.n_joints, 64,
                                             FE.DEFAULT_TILE, True))
        if rc.mlp_backend != 'fused' or shape[0] != FE.F_MAX:
            raise AssertionError(f'kp_cap: not the fused route at {over}')
        _, bones, _, kps, skts, cyls = T.synthetic_pose(
            9, ext_scale=setup.cfg.ext_scale)
        b = T.to_device(T.synthetic_batch(KP_CAP_CHUNK, 9, kps, skts, bones,
                                          cyls, seed=1), device)
        pose = {k: b[k] for k in ('kps', 'skts', 'bones', 'cyls')}
        est = embed_state(setup.cfg, rc, 10000)

        def chunk(backend, twins=False):
            with torch.inference_mode(), (
                    _kernel_twins(FE) if twins
                    else contextlib.nullcontext()):
                return raycaster.render_rays(
                    dataclasses.replace(rc.eval_variant(),
                                        mlp_backend=backend),
                    state['params'], b['rays_o'], b['rays_d'], setup.near,
                    setup.far, pose, est, cam_idxs=b['cam_idxs'])
        FE.reset_launch_counts()
        got = chunk('fused')
        torch.cuda.synchronize()
        render_counts = FE.launch_counts()
        if got['acc_map'].max() >= 0.5:
            break
    else:
        raise AssertionError(f'kp_cap: no seed of {NET_SEEDS} renders the '
                             'subject')
    print(f'kp_cap eval chunk: {KP_CAP_CHUNK} rays at {FE.F_MAX} kp bands '
          f'(build {shape}), weights from seed {seed}, launches '
          f'{render_counts}')
    expect = {k: 0 for k in render_counts}
    expect.update(encmlp_fwd=1, encmlp_dual_fwd=1,
                  vf_operand=_eval_viewfac(FE, rc))
    if render_counts != expect:
        raise AssertionError(f'launch counts {render_counts}, expected '
                             f'{expect}')
    ref, plain = chunk('fused', twins=True), chunk('plain')
    # each side's unclamped acc, and the rays lit on both sides of each
    # comparison with the kernels
    for r in (got, ref, plain):
        r['acc_raw'] = r['weights'].sum(-1)
    lit = {who: (r['acc_raw'] >= KP_CAP_ACC_MIN)
           & (got['acc_raw'] >= KP_CAP_ACC_MIN)
           for who, r in (('twins', ref), ('plain', plain))}
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        if not torch.isfinite(got[k]).all():
            raise AssertionError(f'kp_cap: non-finite {k}')
        errs = {}
        for who, r in (('twins', ref), ('plain', plain)):
            scale = r[k].abs().max().item() + 1e-6
            d = (r[k] - got[k]).abs().reshape(KP_CAP_CHUNK, -1).amax(1) / scale
            held = (lit[who] if k == 'disp_map'
                    else torch.ones_like(d, dtype=torch.bool))
            errs[who] = (d[held].max().item(), int((d[held] > MAP_TOL).sum()),
                         int(held.sum()), d.max().item())
        print(f'  kp_cap {k}: max|d|/scale %.3e against the twins on %d '
              f'rays (%.3e on all {KP_CAP_CHUNK}); %.3e against the plain '
              'path (exact sines) on %d rays, %d of them past MAP_TOL (%.3e '
              'on all)' % (errs['twins'][0], errs['twins'][2],
                           errs['twins'][3], errs['plain'][0],
                           errs['plain'][2], errs['plain'][1],
                           errs['plain'][3]))
        if errs['twins'][0] > MAP_TOL:
            raise AssertionError(f'kp_cap: the kernels disagree with their '
                                 f'twins on {k}')
        if errs['plain'][1] > KP_CAP_PLAIN_RAYS:
            raise AssertionError(f'kp_cap: {errs["plain"][1]} rays of {k} '
                                 'past MAP_TOL against the plain path, more '
                                 f'than {KP_CAP_PLAIN_RAYS}')
    # the worst disp_map ray against the twins, with what compositing made
    # it from: depth = acc / disp where the guard left disp standing
    d = (ref['disp_map'] - got['disp_map']).abs()
    scale = ref['disp_map'].abs().max().item() + 1e-6
    i = int(d.argmax())
    sides = []
    for who, r in (('kernels', got), ('twins', ref)):
        a_i, disp_i = r['acc_raw'][i].item(), r['disp_map'][i].item()
        sides.append(f'{who} acc {a_i:.3e} disp {disp_i:.5f} depth '
                     + (f'{a_i / disp_i:.5f}' if disp_i > 0
                        else 'not kept (the guard zeroed disp)'))
    dark = ~lit['twins']
    print(f'  kp_cap disp_map, the worst ray against the twins ({i}, '
          f'{d[i].item() / scale:.3e} of the scale): ' + '; '.join(sides)
          + f'; {int(dark.sum())} rays below KP_CAP_ACC_MIN on a side, '
          f'{int((d[dark] > MAP_TOL * scale).sum())} of them past MAP_TOL')
    del got, ref, plain
    FE.reset_launch_counts()
    state, stats = step(state, batch,
                        torch.Generator(device=device).manual_seed(0))
    loss = stats['total_loss'].item()
    counts = FE.launch_counts()
    print(f'kp_cap train: 1 step, launches {counts}, total_loss {loss} '
          f'({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update(FLAGSHIP_STEP)
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not math.isfinite(loss):
        raise AssertionError(f'kp_cap: non-finite loss {loss}')
    return render_counts, counts


# views inputs past the flagship's (ROADMAP B.1.3, C.15): the views
# flagship (21 view rows, framecodes of 128: views_flagship, views_bundled,
# through wide_flagship_phase); K5/K6 at views widths past 672
# (views_kernel_phase): name -> (subjects, config overrides over the
# SURREAL recipe), views parts 648 + 32, 792 + 1 + 16 and 1512 + 1 + 128
# (views widths 688, 832 and 1664, the ceiling; the last also at two
# 8 x 1024 nets, WIDE, where the views input goes through the column
# buffer of the A operands); the two-subject model at
# 11 view rows through K5/K6 (ms_views_phase); K-vf1/K-vf2 at a view row
# count and views width no encode shape of ENC_SHAPES brings
# (vf_widths_phase); mixamo at 11 view rows and framecodes of 32 through
# the entry points (cli_views)
VIEWS10 = dict(multires_views=10, framecode_size=128)
VIEWS_WIDTHS = {'680': (1, dict(framecode_size=32)),
                '809': (2, dict(multires_views=5)),
                '1641': (2, VIEWS10),
                '1641_w1024': (2, dict(VIEWS10, netwidth=1024,
                                       netwidth_fine=1024))}
MS_VIEWS = dict(multires_views=5)
MS_VIEWS_STEPS = 4
VF_WIDTHS = ((11, 256), (9, 384), (9, 512), (9, 1024), (21, 512))
CLI_VIEWS = dict(multires_views=5, framecode_size=32)


def _views_model(FM, T, device, name, ns, over):
    """(cfg, rc, params) of VIEWS_WIDTHS' ``name``: the weights of the
    first of NET_SEEDS whose K6 cotangent at both of the phase's shapes
    (R=171 x S=24, R=2048 x S=64) reaches a quarter of the points (a
    check on weights of no density compares zeros)."""
    for seed in NET_SEEDS:
        cfg, rc, params = _grammar_model(T, device, seed, ns, **over)
        shares = []
        for R, S in ((171, 24), (2048, 64)):
            st, xs, xvs, flat = split_inputs(FM, T, cfg, rc, params, R, S,
                                             device)
            g = _split_cotangent(FM, st, xs, xvs, flat, S, device)
            shares.append((g.abs().sum(-1) > 0).float().mean().item())
        if min(shares) >= 0.25:
            print(f'views width {name}: weights from seed {seed}')
            return cfg, rc, params
    raise AssertionError(f'views width {name}: no seed of {NET_SEEDS} gives '
                         'a cotangent on a quarter of the points')


def views_kernel_phase(FM, T, peaks, device):
    """K5 and K6 at the views widths of VIEWS_WIDTHS (builds of their
    own, ``fused_mlp.views_pad``) against their twins on the plain
    encoders' encodings: at a ragged 4104 points (S=24, R=171), then at
    the train step's coarse samples (R=2048 x S=64, n=131,072), each
    check two calls bit-identical and its launches counted exactly, the
    latter timed beside the twin and the bound, with K6's passes.
    Returns {views parts' sum: (K5 row, K6 row)} at n=131,072."""
    import torch
    rows = {}
    for name, (ns, over) in VIEWS_WIDTHS.items():
        cfg, rc, params = _views_model(FM, T, device, name, ns, over)
        for R, S in ((171, 24), (2048, 64)):
            st, xs, xvs, flat = split_inputs(FM, T, cfg, rc, params, R, S,
                                             device)
            n = R * S
            if sum(st.vparts) != int(name.split('_')[0]):
                raise AssertionError(f'views parts {st.vparts}, expected '
                                     f'{name} columns')
            label = f'views {st.vparts} (width {st.xv_pad}) n={n}'
            print(f'mlp_fwd, mlp_bwd {label}:')
            run, plain = _split_calls(FM, st, xs, xvs, flat)
            got = _counted(FM, run, {'mlp_fwd': 1}, 'mlp_fwd')
            max_abs = _check_close('mlp_fwd', plain(), got)
            _check_deterministic('mlp_fwd', _named(got), _named(run()))
            del got
            g = _split_cotangent(FM, st, xs, xvs, flat, S, device)
            _check_cotangent(g)
            brun, bplain = _split_calls(FM, st, xs, xvs, flat, g)
            got = _counted(FM, brun, {'mlp_bwd': 1}, 'mlp_bwd')
            max_abs_b = _check_bwd('mlp_bwd', bplain(), got)
            _check_deterministic('mlp_bwd', got, brun())
            del got
            if R != 2048:
                continue
            fwd = _timed_row(
                'mlp_fwd', 'mlp_fwd.cu', 267, FM.kernel_cost(st, n),
                _time_ms(run, 10), _time_ms(plain, 2), max_abs, peaks,
                label, tpu_file='pallas_mlp.py')
            bwd = _timed_row(
                'mlp_bwd', 'mlp_bwd.cu', 276,
                FM.kernel_cost(st, n, backward=True), _time_ms(brun, 5),
                _time_ms(bplain, 1, windows=3), max_abs_b, peaks, label,
                tpu_file='pallas_mlp.py')
            bwd['passes_ms'] = pass_times('mlp_bwd', brun, label,
                                          FM.dw_cost(st, n), peaks)
            fwd['views_width'] = bwd['views_width'] = st.xv_pad
            rows[name] = (fwd, bwd)
        del cfg, rc, params
        torch.cuda.empty_cache()
    return rows


def vf_widths_phase(FE, peaks, device, R=2048):
    """K-vf1/K-vf2 at each (view rows, views width) of VF_WIDTHS (their
    own build) on view rows drawn U(-1, 1) and views weights N(0,
    1/sqrt(rows)) of two nets from seed 5: one call of each counted
    exactly, then ``viewfac_kernels`` (against their twins, two calls
    bit-identical, timed beside ``torch.bmm``).  Returns (their rows,
    the launches counted)."""
    import torch
    rows, counts = [], {k: 0 for k in FE.launch_counts()}
    for nb, hv in VF_WIDTHS:
        est = FE.EncStatic(J=24, kp_freqs=tuple(2. ** k for k in range(7)),
                           view_nb=nb, S=64, rpt=8, has_codes=True,
                           viewfac=True)
        gen = torch.Generator(device=device).manual_seed(5)
        nbj = nb * 3 * est.J
        enc = torch.rand((R, nbj), generator=gen, device=device) * 2 - 1
        wvx = (torch.randn((2, nbj, hv), generator=gen, device=device)
               / nbj ** 0.5).to(torch.bfloat16)
        M = _counted(FE, lambda: FE.vf_operand(est, enc, wvx),
                     {'vf_operand': 1}, 'vf_operand')
        counts['vf_operand'] += 1
        counts['vf_fold'] += 1
        gw = torch.randn((2, R, est.J, hv), generator=gen,
                         device=device).to(torch.bfloat16)
        _counted(FE, lambda: FE.vf_fold(est, gw, enc, wvx),
                 {'vf_fold': 1}, 'vf_fold')
        del M, gw
        print(f'K-vf1/K-vf2 at {nb} view rows, views width {hv}:')
        for r in viewfac_kernels(FE, est, enc, wvx, peaks, device, R):
            r['label'] = f'{nb} view rows, HV {hv}, R={R} two nets'
            rows.append(r)
    return rows, counts


def bundle_once(FE, T, device, gpu_line, what, kernels, **build_kw):
    """One call of ``build_flagship(2048, steps_per_dispatch=BUNDLE,
    **build_kw)``'s bundled step (2 warm-up steps, the capture, the
    replays): the launch counters those of the warm-up steps and the
    capture (each of ``kernels`` (counter -> launches a step)
    ``_GraphStep.WARMUP`` + 1 times, the rest 0), a finite last loss.
    Returns the counters."""
    import torch
    from anerf_torch.training import trainer as TT
    setup, state, batches, multi = T.build_flagship(
        2048, device=device, compute_dtype='bfloat16',
        steps_per_dispatch=BUNDLE, **build_kw)
    FE.reset_launch_counts()
    state, stats = multi(state, batches,
                         torch.Generator(device=device).manual_seed(7))
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    W = TT._GraphStep.WARMUP
    expect = {k: 0 for k in counts}
    expect.update({k: (W + 1) * n for k, n in kernels.items()})
    loss = stats['total_loss'].float().cpu()
    print(f'{what}: one call of {BUNDLE} steps, launch counters {counts} '
          f'({W} warm-up steps and the capture), last total_loss '
          f'{loss.tolist()} ({gpu_line})')
    if counts != expect:
        raise AssertionError(f'{what}: launch counts {counts}, expected '
                             f'{expect}')
    if not torch.isfinite(loss).all():
        raise AssertionError(f'{what}: non-finite loss {loss.tolist()}')
    return counts


def ms_views_phase(FE, T, device, gpu_line):
    """The two-subject model at 11 view rows (MS_VIEWS: views parts
    792 + 1 + 16, a K5/K6 build of views width 832; before C.15 K5/K6
    raised there): MS_VIEWS_STEPS eager train steps (``split_train``:
    K5/K6 3 times a step, K1-K4 never, finite losses, the fused-vs-plain
    gradients of one step), then one bundle of BUNDLE steps
    (``bundle_once``).  Returns (the eager steps' launch counts, the
    bundle's)."""
    def build():
        out = T.build_flagship(2048, n_subjects=2, device=device,
                               compute_dtype='bfloat16', seed=4, **MS_VIEWS)
        if out[0].rc.n_subjects != 2 or out[0].rc.view_embed.out_dim != 792:
            raise AssertionError('the two-subject setup at 11 view rows '
                                 'changed')
        return out
    _, _, _, counts = split_train(FE, T, device, gpu_line,
                                  'multi-subject train at 11 view rows',
                                  build, MS_VIEWS_STEPS, falls=False)
    bundled = bundle_once(FE, T, device, gpu_line,
                          'multi-subject bundle at 11 view rows',
                          {'mlp_fwd': 3, 'mlp_bwd': 3}, n_subjects=2, seed=4,
                          **MS_VIEWS)
    return counts, bundled


# encmlp_shapes phase (ROADMAP B.1): K1-K4 at static shapes past the
# flagship's, each its own build (``fused_encmlp.kernel_shape``): name ->
# (config overrides over the SURREAL recipe, under fuse_tform, K1/K3's
# samples alone or None for K2/K4 at S = 64 and K1/K3 at 16).  Five and
# seven view PE rows (seven: viewfac at S = 64, the gate's), four kp
# bands at six layers, four layers (no skip layer), the windowed bone
# directions, framecodes of 8 (zero-padded to 16: the flagship's build),
# six layers under fuse_tform, and surreal_single's one view row at its
# own samples (``ENC_SINGLE``: K1/K3 at S = 96, viewfac, the coarse pass,
# and 48, the fine pass); then the shapes whose trunk input leaves shared
# memory in some of K1-K4 (ROADMAP B.1.2): two 8 x 512 nets (viewfac on
# K2/K4 with K-vf1/K-vf2 at a 256-wide views layer), the same under
# fuse_tform, nine layers, eight kp bands, and the gate's corner, 16
# layers of 512 at ten kp bands; then the views inputs of B.1.3: eleven
# view rows (K1/K2's trunk input out of shared memory; K-vf1/K-vf2 at 33
# columns a joint), also under fuse_tform, framecodes of 32 (the codes'
# k-slice over two ring stages under viewfac), and the corner, 21 view
# rows with framecodes of 128 (the views input out of K1/K2's shared
# memory, rebuilt 256 columns at a time), also at two 8 x 512 nets
# (K-vf1/K-vf2 at HV = 256); then the WIDE nets of B.1.4's first part;
# then its kp-band row: the cap F_MAX (fused_encmlp.F_MAX, 13 bands) at
# two 8 x 256 and two 8 x 512 nets, held to the twin at the flagship's
# bars like every shape of eight layers (not the f64 rule: with the
# encode rounded as the twin's, bit for bit, a rule from the f64 chain
# would only widen with the recurrence's f32 noise); then B.1.4's depth
# rows, the nets past 16 layers at 256 and 512 wide and past 8 WIDE
# (K1/K2's and K3/K4's recompute's sums rounded to nearest past 8
# layers, ENC_DEEP in csrc/encmlp_common.cuh): the three shapes that
# missed the f64 rule before (20 x 512 at ten bands, 24 x 512 at seven,
# the cap at 512 wide, 24 x 256 at ten) and the other caps (32 x 256,
# 16 x 1024 and 16 x 2048 at ten bands)
ENC_SHAPES = {
    'nb5': (dict(multires_views=2), False, None),
    'nb7': (dict(multires_views=3), False, None),
    'nf4_depth6': (dict(multires=4, netdepth=6, netdepth_fine=6), False,
                   None),
    'depth4': (dict(netdepth=4, netdepth_fine=4), False, None),
    'cutoff_bones': (dict(cutoff_bones=True), False, None),
    'codes8': (dict(framecode_size=8), False, None),
    'nf4_depth6_tf': (dict(multires=4, netdepth=6, netdepth_fine=6), True,
                      None),
    'nb1': (dict(multires_views=0), False, (96, 48)),
    'w512': (dict(netwidth=512, netwidth_fine=512), False, None),
    'w512_tf': (dict(netwidth=512, netwidth_fine=512), True, None),
    'depth9': (dict(netdepth=9, netdepth_fine=9), False, None),
    'nf8': (dict(multires=8), False, None),
    'w512_depth16_nf10': (dict(netwidth=512, netwidth_fine=512, netdepth=16,
                               netdepth_fine=16, multires=10), False, None),
    'nb11': (dict(multires_views=5), False, None),
    'nb11_tf': (dict(multires_views=5), True, None),
    'codes32': (dict(framecode_size=32), False, None),
    'nb21_codes128': (VIEWS10, False, None),
    'nb21_codes128_w512': (dict(VIEWS10, netwidth=512, netwidth_fine=512),
                           False, None),
    'w768': (dict(netwidth=768, netwidth_fine=768), False, None),
    'w768_tf': (dict(netwidth=768, netwidth_fine=768), True, None),
    'w1024': (W1024, False, None),
    'w1024_nb21_codes128': (dict(VIEWS10, **W1024), False, None),
    'w2048': (dict(netwidth=2048, netwidth_fine=2048), False, None),
    'nf13': (dict(multires=13), False, None),
    'nf13_w512': (dict(W512, multires=13), False, None),
    'w512_depth20_nf10': (dict(W512, netdepth=20, netdepth_fine=20,
                               multires=10), False, None),
    'depth24_nf10': (dict(netdepth=24, netdepth_fine=24, multires=10), False,
                     None),
    'w512_depth24': (dict(W512, netdepth=24, netdepth_fine=24), False, None),
    'depth32_nf10': (dict(netdepth=32, netdepth_fine=32, multires=10), False,
                     None),
    'w1024_depth16_nf10': (dict(W1024, netdepth=16, netdepth_fine=16,
                                multires=10), False, None),
    'w2048_depth16_nf10': (dict(netwidth=2048, netwidth_fine=2048,
                                netdepth=16, netdepth_fine=16, multires=10),
                           False, None),
}
ENC_SINGLE = 'nb1'
ENC_SHAPE_R = 2048
SHAPE_WINDOWS = 2       # the shapes' timing windows (medians)
# shapes checked at fewer rays than ENC_SHAPE_R: the 2048-wide nets, whose
# twins (f32, and f64 where a check takes the f64 chain) would not fit the
# card's memory beside K4's workspace (20.4 GB at R = 2048 at 8 layers,
# 37.6 GB at 16)
ENC_SHAPE_RS = {'w2048': 1024, 'w2048_depth16_nf10': 512}


def enc_shape_key(FE, T, over):
    """The K1-K4 build (``kernel_shape``) of the SURREAL recipe with
    ``over``, from its statics alone."""
    from anerf_torch.models.factory import build_raycast_config
    rc = build_raycast_config(T.surreal_config(**over), n_framecodes=9)
    st, est = FE._statics(rc, rc.n_joints, 1, FE.DEFAULT_TILE,
                          rc.nerf.use_framecode)
    return FE.kernel_shape(st, est)


def _enc_shape_calls(FE, T, rc, cfg, params, S, nnet, device, tf, tile=512,
                     R=ENC_SHAPE_R):
    """K1 (nnet 1, the fine net) or K2 at R x S, and K3 or K4 on the
    composited cotangent, as (forward (run, plain), backward (run,
    plain), the inputs)."""
    ins = kernel_inputs(FE, T, rc, cfg, params, S, R, device,
                        tile=tile, fuse_tform=tf)
    g = _composited_cotangent(FE, ins, nnet, device)
    rows = ins[8] if tf else None   # the affine rows under fuse_tform
    return (_calls(FE, *ins[:8], nnet, rows),
            _bwd_calls(FE, *ins[:8], g, nnet, rows), ins)


# past the flagship's depth the encmlp_shapes phase holds K1-K4 to the
# f64 chain from the encode's own f32 bands (``_f64_twins(f32_encode=
# True)``: the twins' products, and what follows them, in f64 from the
# same f32 inputs) by ``_check_close_f64`` and ``_check_bwd_f64``, as
# net_shapes holds K6 past DEEP_NET_LAYERS.  There no two f32
# evaluations meet the flagship's bars: a longer chain carries the
# kernels' and the twins' other summation orders further (at 16 layers
# of 512 at ten bands K4 and the twin read cosine 0.99816 and 0.99782
# against the f64 chain, 0.99858 against each other, before the kernels'
# encode rounded as the twins').  The encode stays f32 in the chain: it is
# the twins' bit for bit in the kernels, so only the products are under
# test; with the encode in f64 too, the recurrence's f32 noise (which
# doubles with each kp band) would enter the twin's distance and widen
# the bar (twin~f64 0.98487 at 24 x 256, ten bands; scripts/check_k6_f64.py
# --f32-encode).  A WIDE net of at most 8 layers is held to the twin at
# the flagship's bars first, and, where it misses them, to the f64 chain,
# the encode in f64: its backward adds each mma's sum with rounding (K6's
# WIDE chain), so it reads further from the twin, whose sums run in
# another order.
DEEP_ENC_LAYERS = 8


def _counted(FE, run, expect, name):
    """``run()`` with the launch counters zeroed before; every counter
    must read ``expect`` (the rest 0) after.  Returns the outputs."""
    import torch
    FE.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f'{name}: launch counts {counts}, expected '
                             f'{want}')
    return out


def enc_shape_model(FE, T, name, over, samples, device):
    """(cfg, rc, params, plan) of shape ``name``: the SURREAL recipe with
    ``over`` in bf16, the plan of (S, nets) its checks run (K2/K4 at
    S = 64 and K1/K3 at 16, or K1/K3 alone at each S of ``samples``),
    and the weights of the first of NET_SEEDS whose random density gives
    every net of the plan a composited cotangent on a quarter of the
    points (else the backward checks would compare zeros)."""
    import torch
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    cfg = T.surreal_config(compute_dtype='bfloat16', **over)
    rc = build_raycast_config(cfg, n_framecodes=9)
    plan = ([(S, 1) for S in samples] if samples
            else [(64, 2), (16, 1)])
    for seed in NET_SEEDS:
        params = params_to(init_raycaster_params(
            torch.Generator().manual_seed(seed), rc, cfg), device)
        shares = []
        for S, nnet in plan:
            g = _composited_cotangent(FE, kernel_inputs(
                FE, T, rc, cfg, params, S, 171, device, tile=512), nnet,
                device)
            shares += [(gi.abs().sum(0) > 0).float().mean().item()
                       for gi in g]
        if min(shares) >= 0.25:
            break
    else:
        raise AssertionError(f'{name}: no seed of {NET_SEEDS} gives every '
                             'net a cotangent on a quarter of the points')
    print(f'{name}: weights from seed {seed}, cotangents on '
          f'{min(shares):.1%} of the points or more')
    return cfg, rc, params, plan


def _held(name, check, deep, ref_f64, run_plain, got):
    """``got`` against the twin at the flagship's bars (``check``: a
    ``_check_close``/``_check_bwd``-like function of (name, ref, got)),
    or against the f64 chain (``ref_f64()``, with the twin ``run_plain()``
    beside it: ``_check_close_f64``/``_check_bwd_f64``) where ``deep``
    (past DEEP_ENC_LAYERS), or where a WIDE net misses the bars (``deep``
    None).  Returns max |d| against the twin."""
    f64 = {_check_close: _check_close_f64, _check_bwd: _check_bwd_f64}[check]
    if not deep:
        try:
            return check(name, run_plain(), got)
        except AssertionError as e:
            if deep is not None:
                raise
            print(f'  {name}: a WIDE net misses the twin\'s bars ({e}); '
                  'held to the f64 chain')
    ref = ref_f64()
    return f64(name, ref, got, run_plain())


# the kp-band cap's shapes, whose K1 trunk input (the encode's bf16
# output, in its workspace at these shapes) must equal the twin's bit
# for bit (``trunk_input_bits``): the kernels round every operation of
# the encode as the twin's PyTorch operations do (csrc/encmlp_common.cuh)
KP_CAP_SHAPES = ('nf13', 'nf13_w512')


def trunk_input_bits(FE, ins):
    """K1's bf16 trunk input on the operands ``ins`` (``kernel_inputs``:
    the fine net) against the twin's encode: {column group: share of
    entries whose bits differ}, or None where the build keeps the trunk
    input in shared memory.  Launches the build itself, beside the
    wrapper (uncounted), so that it can read the workspace back."""
    import torch
    st, est, p, enc, codes, cutoff, tau, flats = ins[:8]
    J, F = est.J, len(est.kp_freqs)
    R, n = enc.shape[0], p.shape[0]
    lib = FE.cuda_build.library('fwd', enc=FE.kernel_shape(st, est))
    nx = int(lib.encmlp_fwd_workspace_bytes(n))
    dx = (2 * F + 1) * J + 3 * J
    if nx < n * dx * 2:
        return None
    xwork = torch.zeros(nx, dtype=torch.uint8, device=p.device)
    wbuf, bbuf = FE._packs(st, [flats[1]])
    out = torch.empty((4, n), dtype=torch.float32, device=p.device)
    code = FE._codes_operand([codes[1]], st, est, R, p.device)
    vf_m = FE._vf_m(st, est, enc, [flats[1]])
    with torch.cuda.device(p.device):
        err = lib.encmlp_fwd(
            p.data_ptr(), enc.data_ptr(), code.data_ptr(), cutoff.data_ptr(),
            tau.data_ptr(), wbuf.data_ptr(), bbuf.data_ptr(), FE._ptr(vf_m),
            None, xwork.data_ptr(), out.data_ptr(), n, est.S, R,
            FE.cuda_build.stream(p.device))
    if err != 0:
        raise RuntimeError(f'encmlp_fwd launch failed: cudaError {err}')
    torch.cuda.synchronize()
    xk = xwork[:n * dx * 2].view(torch.int16).view(n, dx)
    v, r, _ = FE._encode_plain(est, p, enc, cutoff, tau)
    xt = torch.cat([v, r], 1).to(torch.bfloat16).view(torch.int16)
    diff = (xk != xt).float()
    groups = {'all': diff, 'distance': diff[:, :J],
              'bones': diff[:, (2 * F + 1) * J:]}
    groups.update({f'band{k + 1}': diff[:, (1 + 2 * k) * J:(3 + 2 * k) * J]
                   for k in range(F)})
    return {k: g.mean().item() for k, g in groups.items()}


def enc_shape_check(FE, T, name, over, tf, peaks, device, samples=None):
    """K1-K4 at one shape on the card, at R = ENC_SHAPE_R (or the
    shape's ENC_SHAPE_RS) and the train
    step's 512-point tile (the gate's viewfac where it takes it), on
    weights whose composited cotangent is not zero: K2/K4
    at S = 64 and K1/K3 at S = 16 (``samples``: K1/K3 alone at each S
    of it), each against its twin at the flagship's bars (``_check_close``,
    ``_check_bwd`` on the composited cotangent; past DEEP_ENC_LAYERS, and
    where a WIDE net misses them, the f64 chain's rule), two calls bit-identical,
    its launches counted exactly (K-vf1 before K2/K4 under viewfac,
    K-vf2 after K4), timed (CUDA graph replays, ``_graph_ms``; back to
    back as well) beside its twin and its bound (``kernel_cost``);
    K-vf1/K-vf2 against their twins and timed (``viewfac_kernels``)
    where the gate takes viewfac at a view row count other than the
    flagship's (its own K-vf1/K-vf2 build).  Returns ({kernel name: {S:
    row}}, the K-vf1/K-vf2 rows, the launches counted)."""
    import torch
    cfg, rc, params, plan = enc_shape_model(FE, T, name, over, samples,
                                            device)
    suffix = '_tf' if tf else ''
    R = ENC_SHAPE_RS.get(name, ENC_SHAPE_R)
    rows, vf_rows, total = {}, [], {}
    for S, nnet in plan:
        (fwd, fwd_plain), (bwd, bwd_plain), ins = _enc_shape_calls(
            FE, T, rc, cfg, params, S, nnet, device, tf, R=R)
        st, est = ins[0], ins[1]
        key = FE.kernel_shape(st, est)
        vf = est.viewfac
        # past DEEP_ENC_LAYERS the f64 chain from the encode's own f32
        # bands; a WIDE net's where it misses the twin's bars (None), with
        # the encode in f64
        deep = (True if st.depth > DEEP_ENC_LAYERS
                else None if st.width > 512 else False)

        def f64(plain):
            def ref():
                with _f64_twins(FE, f32_encode=bool(deep)):
                    return plain()
            return ref
        fname = ('encmlp_fwd' if nnet == 1 else 'encmlp_dual_fwd') + suffix
        bname = ('encmlp_bwd' if nnet == 1 else 'encmlp_dual_bwd') + suffix
        n = R * S
        label = (f'{name} {key} R={R} S={S}'
                 f'{" viewfac" if vf else ""}')
        print(f'{fname} {label}:')
        got = _counted(FE, fwd, {fname: 1, 'vf_operand': int(vf)}, fname)
        max_abs = _held(fname, _check_close, deep, f64(fwd_plain), fwd_plain,
                        got)
        _check_deterministic(fname, _named(got), _named(fwd()))
        del got
        if name in KP_CAP_SHAPES and nnet == 1:
            bits = trunk_input_bits(FE, ins)
            if bits is None or any(bits.values()):
                raise AssertionError(f'{name}: K1\'s trunk input is not the '
                                     f'twin\'s bit for bit: {bits}')
            print(f'  {name}: K1\'s trunk input equals the twin\'s bit for '
                  f'bit ({len(bits) - 3} bands, the distances and the bone '
                  'columns)')
        print(f'{bname} {label}:')
        got = _counted(FE, bwd, {bname: 1, 'vf_operand': int(vf),
                                 'vf_fold': int(vf)}, bname)
        max_abs_b = _held(bname, _check_bwd, deep, f64(bwd_plain), bwd_plain,
                          got)
        _check_deterministic(bname, got, bwd())
        del got
        for k, cnt in ((fname, 1), (bname, 1), ('vf_operand', 2 * vf),
                       ('vf_fold', int(vf))):
            total[k] = total.get(k, 0) + cnt
        for kname, run, plain, err, bw, tpu in (
                (fname, fwd, fwd_plain, max_abs, False,
                 345 if nnet == 1 else 709),
                (bname, bwd, bwd_plain, max_abs_b, True,
                 480 if nnet == 1 else 744)):
            # the device's ms from CUDA graph replays of the wrapper (its
            # weight packing included): a call's host work outlasts K1's
            # ~0.4 ms at S = 16, which back-to-back calls would read;
            # those calls' ms beside it as 'wrapper_ms' (2 windows each,
            # SHAPE_WINDOWS, to keep the phase's time)
            row = _timed_row(
                kname, 'encmlp_bwd.cu' if bw else 'encmlp_fwd.cu', tpu,
                FE.kernel_cost(st, est, n, nnet, backward=bw),
                _graph_ms(run, 3 if bw else 5, SHAPE_WINDOWS),
                _time_ms(plain, 1, windows=1) if bw
                else _time_ms(plain, 1, SHAPE_WINDOWS),
                err, peaks, label)
            row.update(shape=dict(zip(('kp_bands', 'view_rows',
                                       'bone_window', 'depth', 'width',
                                       'framecodes'), key)),
                       points=n, viewfac=vf,
                       wrapper_ms=_time_ms(run, 3 if bw else 5,
                                           SHAPE_WINDOWS))
            if bw:   # the backward's passes, from one profiled call
                row['passes_ms'] = pass_times(
                    kname[:-3] if tf else kname, run, label,
                    FE.fused_mlp.dw_cost(st, n, nnet), peaks)
            print(f'  {kname} {label}: {row["wrapper_ms"]:.3f} ms a call '
                  'back to back')
            rows.setdefault(kname, {})[S] = row
        if vf and (est.view_nb, st.half) != FE.cuda_build.FLAGSHIP_VF:
            # K-vf1/K-vf2 at a view row count or width of their own build
            wvx = FE._wvx(st, ins[7])
            vf_rows = viewfac_kernels(FE, est, ins[3], wvx[:nnet], peaks,
                                      device, R)
            for r in vf_rows:
                r['label'] = label
        del fwd, fwd_plain, bwd, bwd_plain, ins
        torch.cuda.empty_cache()
    return rows, vf_rows, total


def encmlp_shapes_phase(FE, T, peaks, device, gpu_line):
    """K1-K4 at every shape of ``ENC_SHAPES`` and at surreal_single's
    (``ENC_SINGLE``) through ``enc_shape_check``.  Returns ({shape name:
    its rows}, {shape name: its K-vf1/K-vf2 rows}, the launches counted
    over the phase, {shape name: its launches})."""
    rows, vf_rows, by_shape = {}, {}, {}
    total = {k: 0 for k in FE.launch_counts()}
    if any(ENC_SHAPES[k][0]['multires'] != FE.F_MAX for k in KP_CAP_SHAPES):
        raise AssertionError(f'{KP_CAP_SHAPES} are not at the kp band cap '
                             f'{FE.F_MAX}')
    for name, (over, tf, samples) in ENC_SHAPES.items():
        t0 = time.perf_counter()
        rows[name], vf, counts = enc_shape_check(FE, T, name, over, tf,
                                                 peaks, device, samples)
        print(f'[shape {name}: {time.perf_counter() - t0:.1f} s]')
        if vf:
            vf_rows[name] = vf
        by_shape[name] = counts
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    print(f'encmlp_shapes: {len(ENC_SHAPES)} shapes, launches {total} '
          f'({gpu_line})')
    return rows, vf_rows, total, by_shape


def split_chunk_and_steps(FE, device, gpu_line, what, setup, state, batch,
                          step, passes, n_steps):
    """A recipe the fused backend routes to the plain encode and K5/K6,
    checked on the card: one chunk of the train batch's rays rendered at
    the eval variant (K5 ``passes`` times: once per net and sample set,
    K1-K4 never; maps finite and within ``MAP_TOL`` of the plain path,
    and not empty), then ``n_steps`` train steps (K5 and K6 ``passes``
    times a step, finite losses).  Returns the launch counts of the train
    steps."""
    import torch
    from anerf_torch.models import raycaster
    from anerf_torch.models.factory import embed_state
    rc = setup.rc
    pose = {k: batch[k] for k in ('kps', 'skts', 'bones', 'cyls')}
    res = {}
    for backend in ('fused', 'plain'):
        FE.reset_launch_counts()
        with torch.inference_mode():
            res[backend] = raycaster.render_rays(
                dataclasses.replace(rc.eval_variant(), mlp_backend=backend),
                state['params'], batch['rays_o'], batch['rays_d'],
                setup.near, setup.far, pose,
                embed_state(setup.cfg, rc, 10000),
                cam_idxs=batch['cam_idxs'])
        torch.cuda.synchronize()
        if backend == 'fused':
            counts = FE.launch_counts()
    print(f'{what} render: {batch["rays_o"].shape[0]} rays, '
          f'launches {counts}')
    expect = {k: 0 for k in counts}
    expect['mlp_fwd'] = passes
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    for k in ('rgb_map', 'acc_map', 'disp_map', 'rgb0', 'acc0'):
        ref, got = res['plain'][k], res['fused'][k]
        if not torch.isfinite(got).all():
            raise AssertionError(f'{what}: non-finite {k}')
        scale = ref.abs().max().item() + 1e-6
        err = (ref - got).abs().max().item()
        print(f'  {what} {k}: max|d| {err:.3e} scale {scale:.3e}')
        if err > MAP_TOL * scale:
            raise AssertionError(f'{what}: fused path disagrees on {k}')
    if res['fused']['acc_map'].max() < 0.5:
        raise AssertionError(f'{what}: empty maps, the check above would '
                             'be vacuous')
    gen = torch.Generator(device=device).manual_seed(0)
    FE.reset_launch_counts()
    losses = []
    for _ in range(n_steps):
        state, stats = step(state, batch, gen)
        losses.append(stats['total_loss'])
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    losses = torch.stack(losses).cpu()
    print(f'{what} train: {n_steps} steps, launches {counts}, '
          f'total_loss {losses.tolist()} ({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update(mlp_fwd=passes * n_steps, mlp_bwd=passes * n_steps)
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    return counts


# the grammar phase: the encoders outside the flagship recipe.  K5/K6 are
# built for a trunk width each besides the flagship's 432: the SURREAL
# recipe's kp + bone encodings of 'querypts' + 'axisang' (45 + 72),
# 'relpos' + 'axisang' (1080 + 72) and 'cat' + 'reldir' (1125 + 72)
GRAMMAR_WIDTHS = {117: dict(kp_dist_type='querypts', bone_type='axisang',
                            use_cutoff=False),
                  1152: dict(kp_dist_type='relpos', bone_type='axisang'),
                  1197: dict(kp_dist_type='cat', bone_type='reldir',
                             use_cutoff=False)}
# K6 also at the train shape on weights whose density reaches few points
# (a sparse cotangent, no vacuity guard): width -> seed.  Its 1152-deep
# trunk products once flipped ReLU masks here that the twin kept
# (scripts/check_k6_f64.py), repaired in mma_slices' RN accumulation
SPARSE_SEEDS = {1152: 4}
# the recipe trained and rendered at full width: a 1152-wide trunk, the
# 'rayangle' view encoding (216) and framecodes (16)
GRAMMAR_RECIPE = dict(kp_dist_type='relpos', bone_type='axisang',
                      view_type='rayangle')
GRAMMAR_STEPS = 12
# the other combinations, checked, not timed: (overrides, the seed of
# weights whose fine net's random density is positive inside the
# subject's cylinder, so that the chunk has content)
GRAMMAR_COMBOS = {
    'cat-reldir-world': (dict(kp_dist_type='cat', bone_type='reldir',
                              view_type='world', use_cutoff=False), 2),
    'querypts-axisang-relray': (dict(kp_dist_type='querypts',
                                     bone_type='axisang', view_type='relray',
                                     use_cutoff=False), 1),
    'relpos-reldir-relray-normalize': (dict(kp_dist_type='relpos',
                                            normalize_cutoff=True), 1)}
GRAMMAR_COMBO_STEPS = 2


def _grammar_model(T, device, seed, n_subjects=1, **over):
    """(cfg, rc, params on ``device``) of the SURREAL recipe with the
    encoder overrides ``over``, weights from ``seed``."""
    import torch
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    cfg = T.surreal_config(compute_dtype='bfloat16', **over)
    rc = build_raycast_config(cfg, n_framecodes=9, n_subjects=n_subjects)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(seed), rc, cfg), device)
    return cfg, rc, params


def _check_cotangent(g):
    """K6's incoming cotangent (n, 4) must reach a good share of the
    points, or the check against the twin compares zeros."""
    share = (g.abs().sum(-1) > 0).float().mean().item()
    print(f'  cotangent non-zero on {share:.1%} of the points')
    if share < 0.25:
        raise AssertionError('K6 cotangent is zero on most points: the '
                             'check would be vacuous')


def grammar_kernel_phase(FM, T, peaks, device):
    """K5 and K6 built for the trunk widths of ``GRAMMAR_WIDTHS`` against
    their twins on the plain encoders' encodings of each: at a ragged
    4104 points (S=24, R=171) with the views input 'rayangle' (216) of a
    one-subject model and 'relray' + subject channel (648 + 1) of a
    two-subject one, each with and without framecodes (16); then at the
    train step's coarse samples (R=2048 x S=64, n=131,072, views
    216 + 16), with kernel and twin time, bound and TFLOP/s, and K6's
    passes.  Every check also holds two calls bit-identical.  The
    weights come from seed 3, whose fine net's random density is
    positive on most points at every width, as the multi-subject
    model's seed 4 is at 432 (K6's cotangent, that of a composited
    loss, is zero where the density is: a check on weights of no
    density, such as seed 4's here, compares zeros).  At the widths of
    ``SPARSE_SEEDS`` K6 is held once more at the train shape on those
    seeds' weights, whose cotangent reaches few points (which must be
    non-zero somewhere).  Returns {width: (K5 row, K6 row)} at
    n=131,072."""
    import torch
    rows = {}
    for dx, over in GRAMMAR_WIDTHS.items():
        for view, ns in (('rayangle', 1), ('relray', 2)):
            cfg, rc, params = _grammar_model(T, device, 3, ns, view_type=view,
                                             **over)
            for codes in (True, False):
                st, xs, xvs, flat = split_inputs(FM, T, cfg, rc, params, 171,
                                                 24, device, codes)
                if st.dnet != dx:
                    raise AssertionError(f'trunk {st.dparts}, expected {dx}')
                print(f'mlp_fwd, mlp_bwd n=4104 S=24 parts {st.dparts} / '
                      f'{st.vparts}:')
                run, plain = _split_calls(FM, st, xs, xvs, flat)
                _check_close('mlp_fwd', plain(), run())
                _check_deterministic('mlp_fwd', _named(run()), _named(run()))
                g = _split_cotangent(FM, st, xs, xvs, flat, 24, device)
                _check_cotangent(g)
                run, plain = _split_calls(FM, st, xs, xvs, flat, g)
                got = run()
                _check_bwd('mlp_bwd', plain(), got)
                _check_deterministic('mlp_bwd', got, run())
        cfg, rc, params = _grammar_model(T, device, 3, view_type='rayangle',
                                         **over)
        st, xs, xvs, flat = split_inputs(FM, T, cfg, rc, params, 2048, 64,
                                         device)
        n = 2048 * 64
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        got = run()
        print(f'mlp_fwd trunk {dx} R=2048 S=64:')
        max_abs = _check_close('mlp_fwd', plain(), got)
        _check_deterministic('mlp_fwd', _named(got), _named(run()))
        del got
        fwd = _timed_row(
            'mlp_fwd', 'mlp_fwd.cu', 267, FM.kernel_cost(st, n),
            _time_ms(run, 10), _time_ms(plain, 2), max_abs, peaks,
            f'trunk {st.dparts} views {st.vparts} n={n}',
            tpu_file='pallas_mlp.py')
        g = _split_cotangent(FM, st, xs, xvs, flat, 64, device)
        _check_cotangent(g)
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        got = run()
        print(f'mlp_bwd trunk {dx} R=2048 S=64:')
        max_abs = _check_bwd('mlp_bwd', plain(), got)
        _check_deterministic('mlp_bwd', got, run())
        del got
        bwd = _timed_row(
            'mlp_bwd', 'mlp_bwd.cu', 276, FM.kernel_cost(st, n, backward=True),
            _time_ms(run, 5), _time_ms(plain, 1, windows=3), max_abs, peaks,
            f'trunk {st.dparts} views {st.vparts} n={n}',
            tpu_file='pallas_mlp.py')
        bwd['passes_ms'] = pass_times('mlp_bwd', run, f'trunk {dx} n={n}',
                                      FM.dw_cost(st, n), peaks)
        rows[dx] = (fwd, bwd)
        if dx in SPARSE_SEEDS:
            cfg, rc, params = _grammar_model(T, device, SPARSE_SEEDS[dx],
                                             view_type='rayangle', **over)
            st, xs, xvs, flat = split_inputs(FM, T, cfg, rc, params, 2048,
                                             64, device)
            g = _split_cotangent(FM, st, xs, xvs, flat, 64, device)
            share = (g.abs().sum(-1) > 0).float().mean().item()
            print(f'mlp_bwd trunk {dx} R=2048 S=64, seed '
                  f'{SPARSE_SEEDS[dx]}: cotangent on {share:.2%} of the '
                  'points')
            if share == 0:
                raise AssertionError('the sparse cotangent is zero')
            run, plain = _split_calls(FM, st, xs, xvs, flat, g)
            _check_bwd('mlp_bwd', plain(), run())
    return rows


def grammar_path_phase(FE, T, device, gpu_line):
    """``GRAMMAR_RECIPE`` at full width on the card (a 1152-wide trunk
    and views of 216 + 16, which the fused backend routes to the plain
    encode and K5/K6): ``GRAMMAR_STEPS`` train steps of
    ``build_flagship(2048)`` (``split_train``: K5/K6 three times a step,
    K1-K4 never, losses finite and falling, fused gradients against the
    plain backend's), then one bullet-time frame at 512x512 in 4096-ray
    chunks (``path_phase``: K5 three times a chunk, one chunk against the
    plain path).  Returns the launch counts of the train steps and of the
    frame."""
    def build():
        out = T.build_flagship(2048, device=device, compute_dtype='bfloat16',
                               **GRAMMAR_RECIPE)
        rc = out[0].rc
        if (rc.mlp_backend != 'fused' or FE.kernel_shape_ok(rc)
                or rc.kp_embed.out_dim + rc.bone_embed.out_dim != 1152
                or rc.view_embed.out_dim != 216):
            raise AssertionError('the grammar recipe changed')
        return out
    counts = split_train(FE, T, device, gpu_line, 'grammar train', build,
                         GRAMMAR_STEPS, falls=True)[3]
    # weights from seed 1, whose random density is positive inside the
    # subject's cylinder
    cfg, rc, params = _grammar_model(T, device, 1, **GRAMMAR_RECIPE)
    render = path_phase(FE, T, rc, cfg, params, device, gpu_line,
                        {'mlp_fwd': 3}, n_bullet=1, what='grammar path')
    return counts, render


def grammar_combos_phase(FE, T, device, gpu_line):
    """Each recipe of ``GRAMMAR_COMBOS`` (``build_flagship(2048)`` with
    the weights of its seed) renders one chunk and takes
    ``GRAMMAR_COMBO_STEPS`` train steps through K5/K6
    (``split_chunk_and_steps``).  Returns their launch counts by
    recipe."""
    out = {}
    for name, (over, seed) in GRAMMAR_COMBOS.items():
        setup, state, batch, step = T.build_flagship(
            2048, device=device, compute_dtype='bfloat16', seed=seed, **over)
        if setup.rc.mlp_backend != 'fused' or FE.kernel_shape_ok(setup.rc):
            raise AssertionError(f'{name}: not on the split route')
        out[name] = split_chunk_and_steps(FE, device, gpu_line, name, setup,
                                          state, batch, step, 3,
                                          GRAMMAR_COMBO_STEPS)
    return out


# the net_shapes phase (ROADMAP C.9): K5/K6 built for nets other than
# 8 x 256, on the two-subject model's parts (trunk 360 + 72, views
# 649 + 16): the skip layer at other depths (6, 10), none (4), widths
# padded to 256 (128) and to 512 (384), and 512 wide
NET_SHAPES = ((6, 256), (8, 128), (10, 256), (8, 512), (4, 128), (8, 384),
              (8, 1024), (6, 768), (32, 256))
# the weights of each shape come from the first of these seeds whose
# random density makes K6's composited cotangent reach a quarter of the
# points (else the check would compare zeros); the encmlp_shapes phase
# takes them so for K1-K4 (nine layers find theirs at seed 12)
NET_SEEDS = tuple(range(1, 17))
NET_STEPS = 2           # train steps at each shape
# past this depth (K6's compensated sums, mlp_bwd_common.cuh DEEP_NET)
# the bf16 chain of a net is itself ill-conditioned at the train step's
# n=131,072: at 32 x 256 the twin reads cosine 0.99977 against an f64
# evaluation of the same chain (K6 0.99984), so no two f32 evaluations
# meet the 0.9999 bar there.  The phase then holds K6 to the f64 chain:
# each output's 1 - cosine to it within the bar's 1e-4, or within
# DEEP_F64_RATIO times the twin's own (two f32 evaluations of that
# chain, K6 and the twin, read 1.37e-4 and 1.32e-4 on one output).  (At
# 4104 points every net is held to the twin.)
DEEP_NET_LAYERS = 24
DEEP_F64_RATIO = 2.
NET_CLI_WIDTH = 1024    # the width run_train trains the mixamo recipe at
NET_CLI_STEPS = 4


def _net_model(FM, T, device, depth, width):
    """(cfg, rc, params, (st, xs, xvs, flat), g) of the two-subject
    SURREAL recipe with a ``depth`` x ``width`` net on the fused backend
    at n = 171 x 24 points, weights from the first of ``NET_SEEDS``
    whose K6 cotangent reaches 25% of the points."""
    for seed in NET_SEEDS:
        cfg, rc, params = _grammar_model(T, device, seed, 2, netdepth=depth,
                                         netwidth=width, mlp_backend='pallas')
        ins = split_inputs(FM, T, cfg, rc, params, 171, 24, device, True,
                           cat_subject=True)
        g = _split_cotangent(FM, *ins, 24, device)
        share = (g.abs().sum(-1) > 0).float().mean().item()
        if share >= 0.25:
            print(f'{depth}x{width}: weights from seed {seed}, cotangent '
                  f'on {share:.1%} of the points')
            return cfg, rc, params, ins, g
    raise AssertionError(f'{depth}x{width}: no seed of {NET_SEEDS} gives a '
                         'cotangent on a quarter of the points')


def _f64_chain(FM, fn):
    """``fn()`` with ``fused_mlp``'s products in float64 on the same
    bf16-rounded operands (scripts/check_k6_f64.py's): a twin's chain
    evaluated in f64."""
    from scripts.check_k6_f64 import _f64_products
    with _f64_products(FM):
        return fn()


def _check_bwd_f64(name, ref, got, twin, bars=None):
    """A deep net's backward outputs ``got`` against ``ref``, an f64
    evaluation of the twin's chain (``_f64_chain``): each at 1 - cosine
    within max(1 - BWD_COS_MIN, DEEP_F64_RATIO x the twin's own 1 -
    cosine to it).  ``bars``: a dict that takes each output's (cosine
    bar, ratio bar), and then each norm ratio is held too, within
    max(BWD_RATIO_TOL, DEEP_F64_RATIO x the twin's own |ratio - 1|)
    (``_check_routes``; not the deep shapes', whose cosine bar can be as
    wide as the twin's 0.97 on a leaf where K6's norm reads 0.97 and its
    twin's 1.0015).  Returns max |d| against the twin."""
    import torch
    rows, max_abs = [], 0.
    for (k, r), (_, a), (_, t) in zip(ref, got, twin):
        if not torch.isfinite(a).all():
            raise AssertionError(f'{name}: non-finite {k}')
        (ck, rk), (ct, rt) = _cmp(r, a)[:2], _cmp(r, t)[:2]
        max_abs = max(max_abs, _cmp(t, a)[3])
        bar = 1. - max(1. - BWD_COS_MIN, DEEP_F64_RATIO * (1. - ct))
        ratio_tol = max(BWD_RATIO_TOL, DEEP_F64_RATIO * abs(rt - 1.))
        if bars is not None:
            bars[k] = (bar, ratio_tol)
        rows.append((ck - bar, k, ck, ct, rk, rt))
        if ck < bar or (bars is not None and abs(rk - 1.) > ratio_tol):
            raise AssertionError(f'{name} {k}: cos {ck:.7f} ratio {rk:.5f} '
                                 f'against the f64 chain, the twin '
                                 f'{ct:.7f} and {rt:.5f}')
    rows.sort()
    worst = max(rows, key=lambda x: abs(x[4] - 1.))
    print(f'  {name} against the f64 chain, closest to the bar: '
          + ', '.join(f'{k} kernel {ck:.7f} twin {ct:.7f}'
                      for _, k, ck, ct, _, _ in rows[:4])
          + f'; worst norm ratio {worst[1]} kernel {worst[4]:.5f} twin '
          f'{worst[5]:.5f}')
    return max_abs


def _check_close_f64(name, ref, got, twin):
    """A deep net's raw rows ``got`` against ``ref``, the f64 chain
    (``_f64_twins``): the worst channel's max and mean |d| / scale within
    the flagship's bars or DEEP_F64_RATIO x the twin's own, whichever is
    wider.  Returns max |d| against the twin."""
    import torch
    worst = {}
    for who, rows in (('kernel', got), ('twin', twin)):
        errs = [e for r, x in zip(ref, rows) for e in _rel_err(r, x)]
        worst[who] = (max(e[0] for e in errs), max(e[1] for e in errs))
    max_tol = max(RAW_MAX_TOL, DEEP_F64_RATIO * worst['twin'][0])
    mean_tol = max(RAW_MEAN_TOL, DEEP_F64_RATIO * worst['twin'][1])
    print(f'  {name} against the f64 chain: kernel max|d|/scale '
          f'{worst["kernel"][0]:.3e} mean {worst["kernel"][1]:.3e}, twin '
          f'{worst["twin"][0]:.3e} and {worst["twin"][1]:.3e}; bars '
          f'{max_tol:.3e}, {mean_tol:.3e}')
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError(f'{name}: non-finite kernel output')
    if worst['kernel'][0] > max_tol or worst['kernel'][1] > mean_tol:
        raise AssertionError(f'{name} disagrees with the f64 chain')
    return max((t - g).abs().max().item() for t, g in zip(twin, got))


def _f64_twins(FE, f32_encode=False):
    """K1-K4's twins (``FE.encmlp_*_plain``) as the f64 chain for the
    ``with`` block: every f32 tensor argument in f64 (the encode runs in
    f64 too) and ``fused_mlp``'s products in f64 on the same bf16-rounded
    operands (``_f64_chain``), the outputs back in f32.  ``f32_encode``:
    the arguments stay f32, so the chain starts from the encode's own f32
    bands (the kernels' bits) and only the products and what follows
    them run in f64 (scripts/check_k6_f64.py --f32-encode)."""
    import torch

    def up(a):
        return (a.double() if torch.is_tensor(a) and a.dtype == torch.float32
                and not f32_encode else a)

    def down(a):
        if isinstance(a, (list, tuple)):
            return type(a)(down(x) for x in a)
        return (a.float() if torch.is_tensor(a) and a.dtype == torch.float64
                else a)

    def wrap(plain):
        return lambda *a: down(_f64_chain(
            FE.fused_mlp, lambda: plain(*[up(x) for x in a])))
    return _Wrapped(FE, **{k: wrap for k in (
        'encmlp_fwd_plain', 'encmlp_dual_fwd_plain', 'encmlp_bwd_plain',
        'encmlp_dual_bwd_plain')})


def net_shapes_phase(FE, FM, T, peaks, device, gpu_line):
    """K5 and K6 at each net of ``NET_SHAPES`` (``fused_mlp.
    kernel_static``: built at the next multiple of 256 wide, the net
    padded) against their twins on the two-subject scene's encodings: at
    a ragged 4104 points (S=24, R=171), K6 on a composited cotangent, two
    calls bit-identical; then at the train step's coarse samples
    (R=2048 x S=64, n=131,072), checked again (K6 of a net deeper than
    DEEP_NET_LAYERS against the f64 chain) and timed, the bound from
    ``kernel_cost`` at the real (unpadded) shape, with K6's passes; then
    ``NET_STEPS`` train steps of ``build_flagship(2048, n_subjects=2)``
    at the net (K5 and K6 three times a step, K1-K4 never, finite
    losses).  Returns ({'DxW': (K5 row, K6 row)}, {'DxW': launch
    counts})."""
    import torch
    rows, counts = {}, {}
    for depth, width in NET_SHAPES:
        key = f'{depth}x{width}'
        cfg, rc, params, (st, xs, xvs, flat), g = _net_model(
            FM, T, device, depth, width)
        print(f'mlp_fwd, mlp_bwd {key} n=4104 S=24 parts {st.dparts} / '
              f'{st.vparts} (built {FM.kernel_static(st).width} wide):')
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        _check_close('mlp_fwd', plain(), run())
        _check_deterministic('mlp_fwd', _named(run()), _named(run()))
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        got = run()
        _check_bwd('mlp_bwd', plain(), got)
        _check_deterministic('mlp_bwd', got, run())
        st, xs, xvs, flat = split_inputs(FM, T, cfg, rc, params, 2048, 64,
                                         device, cat_subject=True)
        n = 2048 * 64
        shape = f'{key} trunk {st.dparts} views {st.vparts} n={n}'
        run, plain = _split_calls(FM, st, xs, xvs, flat)
        print(f'mlp_fwd {key} R=2048 S=64:')
        max_abs = _check_close('mlp_fwd', plain(), run())
        fwd = _timed_row(
            'mlp_fwd', 'mlp_fwd.cu', 267, FM.kernel_cost(st, n),
            _time_ms(run, 5, 3), _time_ms(plain, 1, 3), max_abs, peaks,
            shape, tpu_file='pallas_mlp.py')
        g = _split_cotangent(FM, st, xs, xvs, flat, 64, device)
        run, plain = _split_calls(FM, st, xs, xvs, flat, g)
        print(f'mlp_bwd {key} R=2048 S=64:')
        if depth > DEEP_NET_LAYERS:
            from scripts.check_k6_f64 import _named as named
            ref = named(*_f64_chain(FM, lambda: FM._mlp_bwd_tile(
                st, xs, xvs, flat, g)))
            max_abs = _check_bwd_f64('mlp_bwd', ref, run(), plain())
        else:
            max_abs = _check_bwd('mlp_bwd', plain(), run())
        bwd = _timed_row(
            'mlp_bwd', 'mlp_bwd.cu', 276, FM.kernel_cost(st, n, backward=True),
            _time_ms(run, 3, 3), _time_ms(plain, 1, 1), max_abs, peaks,
            shape, tpu_file='pallas_mlp.py')
        bwd['passes_ms'] = pass_times('mlp_bwd', run, shape,
                                      FM.dw_cost(st, n), peaks)
        rows[key] = (fwd, bwd)
        del xs, xvs, g, run, plain
        setup, state, batch, step = T.build_flagship(
            2048, n_subjects=2, device=device, compute_dtype='bfloat16',
            netdepth=depth, netwidth=width, mlp_backend='pallas')
        if (setup.rc.mlp_backend != 'fused'
                or (setup.rc.nerf.depth, setup.rc.nerf.width) != (depth,
                                                                  width)):
            raise AssertionError(f'{key}: not the fused backend at the net')
        gen = torch.Generator(device=device).manual_seed(0)
        FE.reset_launch_counts()
        losses = []
        for _ in range(NET_STEPS):
            state, stats = step(state, batch, gen)
            losses.append(stats['total_loss'])
        torch.cuda.synchronize()
        counts[key] = FE.launch_counts()
        losses = torch.stack(losses).cpu()
        print(f'net {key} train: {NET_STEPS} steps, launches '
              f'{counts[key]}, total_loss {losses.tolist()} ({gpu_line})')
        expect = {k: 0 for k in counts[key]}
        expect.update(mlp_fwd=3 * NET_STEPS, mlp_bwd=3 * NET_STEPS)
        if counts[key] != expect:
            raise AssertionError(f'{key}: launch counts {counts[key]}, '
                                 f'expected {expect}')
        if not torch.isfinite(losses).all():
            raise AssertionError(f'{key}: non-finite losses {losses}')
        del setup, state, batch, step
    return rows, counts


# c16_shapes phase (ROADMAP C.16): K5/K6 past the caps they had before
# that repair, name -> (depth, width, trunk parts, views parts, points): nets
# 2304 and 4096 wide, 65 and 128 layers, depth x width past the old
# 65,536 (40 x 2048) and at the new ceiling (64 x 4096), a 41-band
# reldist trunk (2064 columns) and the widest trunk, 23 view rows with
# framecodes of 128 (views width 1792) and the widest views input.  The
# parts are drawn on the card (uniform in [-1, 1), as encodings lie),
# the weights with the model's init (``nerf_mlp._linear_init``) from the
# first of NET_SEEDS whose composited cotangent reaches a quarter of
# the points.  The points: the train step's coarse samples, fewer where
# a net's workspace and twins would crowd the card.
C16_SHAPES = {
    'w2304': (8, 2304, (360, 72), (648, 16), 131072),
    'w4096': (8, 4096, (360, 72), (648, 16), 32768),
    'd65': (65, 256, (360, 72), (648, 16), 131072),
    'd128': (128, 256, (360, 72), (648, 16), 131072),
    'd40w2048': (40, 2048, (360, 72), (648, 16), 16384),
    'd64w4096': (64, 4096, (360, 72), (648, 16), 4096),
    'dx2064': (8, 256, (1992, 72), (648, 16), 131072),
    'dx4096': (8, 256, (4024, 72), (648, 16), 131072),
    'xv1792': (8, 256, (360, 72), (1656, 128), 131072),
    'xv4096': (8, 256, (360, 72), (3960, 128), 131072),
}
# the twins' points a call: every layer's f64 activations and
# cotangents of a chunk take up to 8 GiB, beside K6's workspace
C16_TWIN_BYTES = 2 ** 33
# the two trains through build_flagship: one subject at 2304 wide (K1-K4
# refuse it, so the split route runs), two subjects at 23 view rows with
# framecodes (views parts 1656 + 1 + 16, a views width of 1696)
# (subjects, config overrides, the net's width and view PE columns)
C16_TRAINS = {'w2304_train': (1, dict(netwidth=2304, netwidth_fine=2304),
                              (2304, 648)),
              'ms_views23_train': (2, dict(multires_views=11), (256, 1656))}


def c16_builds(FM):
    """(trunk width, depth, compiled width, views width) of every K5/K6
    library the c16_shapes phase runs (its trains' builds among them)."""
    return [(sum(dp), d, FM.kernel_static(FM.MLPStatic(
        d, w, dp, vp, w // 2, (4,))).width, FM.views_pad(sum(vp)))
        for d, w, dp, vp, _ in C16_SHAPES.values()] + [
        # the two-subject train: 23 view rows' 1656 columns, the subject
        # channel and 16 framecodes
        (432, 8, 256, FM.views_pad(1656 + 1 + 16))]


def _c16_net(FM, device, depth, width, dparts, vparts, seed):
    """The ``flatten_params`` operands of a random net of the model's
    init (``nerf_mlp._linear_init``, drawn on ``device``)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)

    def lin(fan_in, fan_out):
        bound = fan_in ** -0.5
        u = lambda *shape: (torch.rand(shape, generator=gen, device=device)
                            * 2. - 1.) * bound
        return {'w': u(fan_in, fan_out), 'b': u(fan_out)}
    dnet = sum(dparts)
    pts = [lin(dnet if i == 0 else width + (dnet if i - 1 == 4 else 0),
               width) for i in range(depth)]
    net = {'pts_linears': pts, 'alpha_linear': lin(width, 1),
           'feature_linear': lin(width, width),
           'views_linear': lin(width + sum(vparts), width // 2),
           'rgb_linear': lin(width // 2, 3)}
    st = FM.MLPStatic(depth, width, tuple(dparts), tuple(vparts), width // 2,
                      (4,))
    return st, FM.flatten_params(net, st)


def _c16_inputs(FM, device, name, S=64):
    """(st, xs, xvs, flat, g) of C16_SHAPES' ``name``: parts drawn on the
    card, the weights of the first of NET_SEEDS whose composited
    cotangent (rays of S samples) reaches a quarter of the points (tried
    on the first 8192)."""
    import torch
    depth, width, dparts, vparts, n = C16_SHAPES[name]
    gen = torch.Generator(device=device).manual_seed(0)
    draw = lambda w: (torch.rand((n, w), generator=gen, device=device) * 2.
                      - 1.).to(torch.bfloat16)
    xs, xvs = [draw(w) for w in dparts], [draw(w) for w in vparts]
    probe = min(n, 8192)
    for seed in NET_SEEDS:
        st, flat = _c16_net(FM, device, depth, width, dparts, vparts, seed)
        g = _split_cotangent(FM, st, [x[:probe] for x in xs],
                             [x[:probe] for x in xvs], flat, S, device)
        share = (g.abs().sum(-1) > 0).float().mean().item()
        if share >= 0.25:
            print(f'c16 {name}: weights from seed {seed}, cotangent on '
                  f'{share:.1%} of the first {probe} points')
            raw = _c16_twin_fwd(FM, st, xs, xvs, flat)[0]
            g = _composite_grad([raw], S, device)[0].T.contiguous()
            return st, xs, xvs, flat, g
        del flat
    raise AssertionError(f'c16 {name}: no seed of {NET_SEEDS} gives a '
                         'cotangent on a quarter of the points')


def _c16_chunks(st, n):
    """The twins' point chunks [(a, b)], whole rays of 64 samples, each
    within C16_TWIN_BYTES of f64 activations and cotangents."""
    per = 8 * 3 * (st.depth * st.width + st.dnet + st.xv)
    step = max(64, C16_TWIN_BYTES // per // 64 * 64)
    return [(a, min(n, a + step)) for a in range(0, n, step)]


def _ms_once(fn):
    """(fn(), its device ms): CUDA events around one call (a twin's,
    whose seconds dwarf a warm-up's savings)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _c16_twin_fwd(FM, st, xs, xvs, flat, f64=False):
    """K5's twin (raw (4, n)) over point chunks; ``f64``: its chain in
    float64 (``_f64_chain``)."""
    import torch
    n, outs = xs[0].shape[0], []
    for a, b in _c16_chunks(st, n):
        run = lambda: FM.mlp_fwd_plain(st, [x[a:b] for x in xs],
                                       [x[a:b] for x in xvs], flat)
        outs.append(_f64_chain(FM, run) if f64 else run())
    return [torch.cat(outs).T]


def _c16_twin_bwd(FM, st, xs, xvs, flat, g, f64=False):
    """K6's twin over point chunks as named outputs: the part cotangents
    (bf16, as K6 writes them; ``f64``: the chain's f64 values) and every
    gradient, the chunks' sums added in f64 (f32 for the twin)."""
    import torch
    from scripts.check_k6_f64 import _named
    n, dx, dxv, grads = xs[0].shape[0], [], [], None
    for a, b in _c16_chunks(st, n):
        args = (st, [x[a:b] for x in xs], [x[a:b] for x in xvs], flat,
                g[a:b])
        if f64:
            out = _f64_chain(FM, lambda: FM._mlp_bwd_tile(*args))
        else:
            out = FM.mlp_bwd_plain(*args)
        dx.append(out[0])
        dxv.append(out[1])
        gr = [x.double() for x in out[2]]
        grads = gr if grads is None else [u + v for u, v in zip(grads, gr)]
        del out
    cat = lambda parts: [torch.cat(p) for p in zip(*parts)]
    return _named(cat(dx), cat(dxv),
                  [x if f64 else x.float() for x in grads])


def c16_shapes_phase(FE, FM, T, peaks, device, gpu_line):
    """K5 and K6 at each shape of C16_SHAPES, which they refused before
    this phase's PR (ROADMAP C.16), against their twins at the
    flagship's bars (K5's rows, K6's cotangents and gradients on a
    composited cotangent; the twins over point chunks), or, past
    DEEP_NET_LAYERS and at WIDE where the twin's bars miss, against the
    f64 chain (``_check_close_f64``, ``_check_bwd_f64``); two calls
    bit-identical, launches counted exactly, both timed beside the twin
    and the bound (``kernel_cost``; K6's passes, the dW pass's bound from
    ``dw_cost``; each twin timed on its checking call), K6's workspace
    and the phase's peak device memory printed.  Then the C16_TRAINS, NET_STEPS
    train steps each through ``build_flagship``: K5 and K6 three times a
    step, K1-K4 never, finite losses.  Returns ({name: (K5 row, K6
    row)}, {name: launch counts})."""
    import torch
    rows, counts = {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, (depth, width, dparts, vparts, n) in C16_SHAPES.items():
        st, xs, xvs, flat, g = _c16_inputs(FM, device, name)
        wide, deep = width > 512, depth > DEEP_NET_LAYERS
        shape = (f'{name}: {depth}x{width} trunk {st.dparts} views '
                 f'{st.vparts} n={n}')
        ws = FM._library('mlp_bwd', st).mlp_bwd_workspace_bytes(n)
        print(f'mlp_fwd, mlp_bwd {shape} (built {FM.kernel_static(st).width}'
              f' wide, views width {st.xv_pad}; K6 workspace '
              f'{ws / 2**30:.2f} GiB):')
        t0 = time.perf_counter()
        FE.reset_launch_counts()
        run, _ = _split_calls(FM, st, xs, xvs, flat)
        got = run()
        _check_deterministic('mlp_fwd', _named(got), _named(run()))
        twin, twin_ms = _ms_once(lambda: _c16_twin_fwd(FM, st, xs, xvs,
                                                       flat))
        try:
            if deep:
                raise AssertionError('past DEEP_NET_LAYERS')
            max_abs = _check_close('mlp_fwd', twin, got)
        except AssertionError as e:
            if not (deep or wide):
                raise
            print(f'  mlp_fwd: {e}; against the f64 chain')
            max_abs = _check_close_f64(
                'mlp_fwd', _c16_twin_fwd(FM, st, xs, xvs, flat, f64=True),
                got, twin)
        del got, twin
        fwd = _timed_row('mlp_fwd', 'mlp_fwd.cu', 267, FM.kernel_cost(st, n),
                         _time_ms(run, 1, 3), twin_ms, max_abs, peaks, shape,
                         tpu_file='pallas_mlp.py')
        run, _ = _split_calls(FM, st, xs, xvs, flat, g)
        got = run()
        _check_deterministic('mlp_bwd', got, run())
        twin, twin_ms = _ms_once(lambda: _c16_twin_bwd(FM, st, xs, xvs, flat,
                                                       g))
        try:
            if deep:
                raise AssertionError('past DEEP_NET_LAYERS')
            max_abs = _check_bwd('mlp_bwd', twin, got)
        except AssertionError as e:
            if not (deep or wide):
                raise
            print(f'  mlp_bwd: {e}; against the f64 chain')
            max_abs = _check_bwd_f64(
                'mlp_bwd', _c16_twin_bwd(FM, st, xs, xvs, flat, g, f64=True),
                got, twin)
        del got, twin
        bwd = _timed_row(
            'mlp_bwd', 'mlp_bwd.cu', 276, FM.kernel_cost(st, n, backward=True),
            _time_ms(run, 1, 1), twin_ms, max_abs, peaks, shape,
            tpu_file='pallas_mlp.py')
        bwd['passes_ms'] = pass_times('mlp_bwd', run, shape,
                                      FM.dw_cost(st, n), peaks)
        for row in (fwd, bwd):
            row.update(shape=shape, points=n, workspace_bytes=ws)
        torch.cuda.synchronize()
        counts[name] = FE.launch_counts()
        # K5: the two checked calls, the timing's warm-up and 3 windows;
        # K6: the two checked calls, the timing's warm-up and window, the
        # profiled passes' warm-up and call
        expect = {k: 0 for k in counts[name]}
        expect.update(mlp_fwd=2 + 1 + 3, mlp_bwd=2 + 1 + 1 + 2)
        if counts[name] != expect:
            raise AssertionError(f'c16 {name}: launch counts {counts[name]},'
                                 f' expected {expect}')
        rows[name] = (fwd, bwd)
        print(f'  c16 {name}: {time.perf_counter() - t0:.1f} s')
        del st, xs, xvs, flat, g, run
        torch.cuda.empty_cache()
    for name, (ns, over, widths) in C16_TRAINS.items():
        setup, state, batch, step = T.build_flagship(
            2048, n_subjects=ns, device=device, compute_dtype='bfloat16',
            mlp_backend='pallas', **over)
        rc = setup.rc
        if (rc.mlp_backend != 'fused' or FE.kernel_shape_ok(rc)
                or (rc.nerf.width, rc.view_embed.out_dim) != widths):
            raise AssertionError(f'{name}: not the fused backend on the '
                                 f'split route at {widths}')
        gen = torch.Generator(device=device).manual_seed(0)
        FE.reset_launch_counts()
        losses = []
        for _ in range(NET_STEPS):
            state, stats = step(state, batch, gen)
            losses.append(stats['total_loss'])
        torch.cuda.synchronize()
        counts[name] = FE.launch_counts()
        losses = torch.stack(losses).cpu()
        print(f'c16 {name}: {NET_STEPS} steps, launches {counts[name]}, '
              f'total_loss {losses.tolist()} ({gpu_line})')
        expect = {k: 0 for k in counts[name]}
        expect.update(mlp_fwd=3 * NET_STEPS, mlp_bwd=3 * NET_STEPS)
        if counts[name] != expect:
            raise AssertionError(f'{name}: launch counts {counts[name]}, '
                                 f'expected {expect}')
        if not torch.isfinite(losses).all():
            raise AssertionError(f'{name}: non-finite losses {losses}')
        del setup, state, batch, step, rc
        torch.cuda.empty_cache()
    print(f'c16_shapes: peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({gpu_line})')
    return rows, counts


def cli_net_width_phase(FE, device, gpu_line, what='cli_net_width',
                        over=None, bundled=False):
    """``configs/mixamo.txt`` at ``netwidth = NET_CLI_WIDTH`` (or with
    the config overrides ``over``: CLI_VIEWS' 11 view rows and
    framecodes of 32) and ``mlp_backend = 'pallas'`` through
    ``run_train.train`` on a
    synthetic store: ``NET_CLI_STEPS`` steps, each launching K1-K4 as
    ``FLAGSHIP_STEP`` counts them (K1-K4 are built for 512-wide nets
    since ROADMAP B.1.2; K-vf1/K-vf2 at the 256-wide views layer) and
    K5/K6 never, finite losses; with ``bundled``, BUNDLE more steps at
    ``--steps_per_dispatch`` BUNDLE (the counters those of the warm-up
    steps and the capture, finite losses); then one bullet frame of its
    checkpoint through ``run_render.main`` (K1 and K2 once a chunk,
    nothing else, finite frames).  Returns the launch counts of the
    train steps."""
    import numpy as np
    import torch
    from anerf_torch import run_render as RR
    from anerf_torch.data.writer import make_synthetic_store
    from anerf_torch.render.renderer import ImageRenderer
    from anerf_torch.run_train import train
    from anerf_torch.training import trainer as TT
    if over is None:
        over = dict(netwidth=NET_CLI_WIDTH, netwidth_fine=NET_CLI_WIDTH)
    name = 'wide' if what == 'cli_net_width' else what
    store = os.path.join(WORK, 'wide.npstore')
    if not os.path.exists(store):
        make_synthetic_store(store, n_frames=8, H=256, W=256,
                             body_scale=450.0, blob_radius=2, seed=2)
    wcfg = _cli_config('mixamo.txt', mlp_backend='pallas',
                       dataset_type=('synthetic',), datadir=store,
                       basedir=os.path.join(WORK, 'logs'), expname=name,
                       n_iters=NET_CLI_STEPS, num_workers=4,
                       i_weights=NET_CLI_STEPS, **over)
    rec = {'losses': []}

    def on_step(i, state, stats):
        if stats is None:
            rec['views'] = state['params']['fine']['views_linear']['w'].shape
            FE.reset_launch_counts()
        else:
            rec['losses'].append(stats['total_loss'])
        if i == NET_CLI_STEPS:
            torch.cuda.synchronize()
            rec['counts'] = FE.launch_counts()

    train(wcfg, device=device, on_step=on_step)
    counts = rec['counts']
    losses = torch.stack(rec['losses']).cpu()
    print(f'{what}: {over}, {NET_CLI_STEPS} steps, '
          f'views layer {tuple(rec["views"])}, launches {counts}, '
          f'total_loss {losses.tolist()} ({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update({k: NET_CLI_STEPS * n for k, n in FLAGSHIP_STEP.items()})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    views = (wcfg.netwidth + (1 + 2 * wcfg.multires_views) * 72
             + (wcfg.framecode_size if wcfg.opt_framecode else 0),
             wcfg.netwidth // 2)
    if tuple(rec['views']) != views:
        raise AssertionError(f'views layer {rec["views"]}, expected {views}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    if bundled:   # BUNDLE more steps at BUNDLE a dispatch, resumed
        brec = {'losses': []}

        def on_bundle(i, state, stats):
            if stats is None:
                FE.reset_launch_counts()
            else:
                brec['losses'].append(stats['total_loss'])
            if i == NET_CLI_STEPS + BUNDLE:
                torch.cuda.synchronize()
                brec['counts'] = FE.launch_counts()
        train(dataclasses.replace(wcfg, n_iters=NET_CLI_STEPS + BUNDLE,
                                  steps_per_dispatch=BUNDLE,
                                  i_weights=NET_CLI_STEPS + BUNDLE),
              device=device, on_step=on_bundle)
        bl = torch.stack(brec['losses']).float().cpu()
        W = TT._GraphStep.WARMUP
        bexpect = {k: 0 for k in brec['counts']}
        bexpect.update({k: (W + 1) * n for k, n in FLAGSHIP_STEP.items()})
        print(f'{what}: {BUNDLE} more steps at {BUNDLE} a dispatch, launch '
              f'counters {brec["counts"]} ({W} warm-up steps and the '
              f'capture), total_loss {bl.tolist()}')
        if brec['counts'] != bexpect or not torch.isfinite(bl).all():
            raise AssertionError(f'{what} bundled: launch counts '
                                 f'{brec["counts"]}, expected {bexpect}, '
                                 f'losses {bl.tolist()}')
    logdir = os.path.join(WORK, 'logs', name)
    last = NET_CLI_STEPS + (BUNDLE if bundled else 0)
    chunks = [0]

    def count_chunks(fn):
        def run(*args):
            chunks[0] += 1
            return fn(*args)
        return run
    FE.reset_launch_counts()
    with _Wrapped(ImageRenderer, _render_chunk=count_chunks):
        out = RR.main(['--nerf_args', os.path.join(logdir, 'args.txt'),
                       '--ckptpath', os.path.join(
                           logdir, f'ckpt_{last:08d}.pt'),
                       '--outputdir', os.path.join(WORK, f'render_{name}'),
                       '--render_type', 'bullet', '--n_bullet', '1',
                       '--runname', name], device=device)
    torch.cuda.synchronize()
    rcounts = FE.launch_counts()
    print(f'{what} render: {len(out["rgbs"])} bullet frame '
          f'{out["rgbs"].shape[1]}x{out["rgbs"].shape[2]} through '
          f'run_render.main, {chunks[0]} chunks, launches {rcounts}')
    expect = {k: 0 for k in rcounts}
    expect.update(encmlp_fwd=chunks[0], encmlp_dual_fwd=chunks[0],
                  vf_operand=chunks[0] * _eval_viewfac(
                      FE, out['renderer'].rc))
    if rcounts != expect or not chunks[0] or len(out['rgbs']) != 1:
        raise AssertionError(f'{what} render: launches {rcounts} '
                             f'for {chunks[0]} chunks')
    for k in ('rgbs', 'accs', 'disps'):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f'{what} render: non-finite {k}')
    return counts


def cli_fuse_tform_phase(FE, device, gpu_line):
    """``configs/mixamo.txt`` with ``fuse_tform = True`` through
    ``run_train.train`` on cli_train's store: CLI_TF_STEPS steps, each
    launching K1-K4's fuse_tform forms once (viewfac as FLAGSHIP_STEP_TF)
    and their point forms never, finite losses.  Returns the launch
    counts."""
    import torch
    from anerf_torch.run_train import train
    tcfg = _cli_config('mixamo.txt', fuse_tform=True,
                       dataset_type=('synthetic',),
                       datadir=os.path.join(WORK, 'mixamo.npstore'),
                       basedir=os.path.join(WORK, 'logs'),
                       expname='fuse_tform', n_iters=CLI_TF_STEPS,
                       num_workers=4)
    rec = {'losses': []}

    def on_step(i, state, stats):
        if stats is None:
            FE.reset_launch_counts()
        else:
            rec['losses'].append(stats['total_loss'])
        if i == CLI_TF_STEPS:
            torch.cuda.synchronize()
            rec['counts'] = FE.launch_counts()

    train(tcfg, device=device, on_step=on_step)
    counts = rec['counts']
    losses = torch.stack(rec['losses']).cpu()
    print(f'cli_fuse_tform: {CLI_TF_STEPS} steps, launches {counts}, '
          f'total_loss {losses.tolist()} ({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update({k: CLI_TF_STEPS * n for k, n in FLAGSHIP_STEP_TF.items()})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    return counts


def _cli_config(config, **over):
    """A shipped recipe from ``configs/`` with overrides."""
    from anerf_torch.utils.config import load_config
    return load_config(os.path.join(ROOT, 'configs', config), **over)


class SyncWatch:
    """``torch.cuda.set_sync_debug_mode(1)`` over the windows between two
    ``on_step`` calls that hold one train step and nothing else (no
    logging read, checkpoint or validation render after the earlier
    call): every 'synchroniz' warning raised inside such a window is a
    host wait on the stream inside a step.  A wait on an event, such as
    the DeviceFeeder's on a slot's copy three batches back, raises no
    warning; the profiled step of ``cli_train`` prints its host time."""

    def __init__(self, periodic):
        import warnings
        self.periodic = periodic          # i -> the loop works at step i
        self.caught = warnings.catch_warnings(record=True)
        self.log = None
        self.armed = False
        self.mark = 0
        self.windows = 0
        self.faults = []

    def __enter__(self):
        import warnings
        self.log = self.caught.__enter__()
        warnings.simplefilter('always')
        return self

    def __exit__(self, *exc):
        self.pause()
        self.caught.__exit__(*exc)

    def pause(self):
        """First thing in ``on_step``: close the window that ends here."""
        import torch
        torch.cuda.set_sync_debug_mode(0)
        if self.armed:
            self.windows += 1
            self.faults += [str(w.message) for w in self.log[self.mark:]
                            if 'synchroniz' in str(w.message)]
        self.armed = False

    def resume(self, i, last):
        """Last thing in ``on_step(i)``; ``last``: no step follows."""
        import torch
        self.armed = not last and not self.periodic(i)
        self.mark = len(self.log)
        if self.armed:
            torch.cuda.set_sync_debug_mode(1)

    def check(self, what):
        print(f'{what}: set_sync_debug_mode(1) over {self.windows} steps: '
              f'{len(self.faults)} synchronizing calls')
        if self.faults or not self.windows:
            raise AssertionError(f'{what}: host syncs inside a train step: '
                                 f'{self.faults[:5]}')


def _periodic(cfg):
    return lambda i: (i % cfg.i_print == 0 or i % cfg.i_weights == 0
                      or (cfg.opt_pose and i % cfg.i_pose_weights == 0)
                      or i % cfg.i_testset == 0)


def _device_busy(prof):
    """(device busy ms, device kernels and copies) of a profile, or None
    when it holds no device time."""
    dev = _device_ms
    events = [e for e in prof.key_averages()
              if dev(e) > 0 and str(e.device_type).endswith('CUDA')]
    busy = sum(dev(e) for e in events)
    if busy == 0:
        return None
    return busy, sum(e.count for e in events)


def cli_train_phase(FE, T, rc, cfg, params, peaks, device, gpu_line):
    """``configs/mixamo.txt`` (joint mode) trained through
    ``anerf_torch.run_train.train`` on a 24-frame 512x512 synthetic store
    of a realistic body size: K1-K4 held against their twins and timed
    at the shapes the recipe's step gives them (R=3072; S=16 for K1/K3,
    S=64 for K2/K4) first; then CLI_STEPS steps,
    each launching K1-K4 once and K5/K6 never, no host sync inside a
    step, every logged loss finite, the pose bank still through step 18
    and moved at step 19 (the joint gate's first fire), the checkpoints,
    logs and validation metrics written; then a resume to step 41 that
    restores the final state bit for bit, and a second resume to step 45
    whose step 44 is profiled.
    Prints CLI train rays/s over steps 10-39 and the Prefetcher's ms per
    batch.  Returns the launch counts of the train steps, by kernel
    name K1-K4's times, bounds and errors at the recipe's shapes, the
    logdir and the CLI train rays/s."""
    import numpy as np
    import torch
    from anerf_torch.data.loaders import load_data
    from anerf_torch.data.writer import make_synthetic_store
    from anerf_torch.run_train import train
    from anerf_torch.training.trainer import tree_leaves
    from torch.profiler import ProfilerActivity, profile

    # K1-K4 at this recipe's shapes: held, then timed and bounded
    shapes = {}
    R = 3072
    for name, S, nnet, bwd, line in (
            ('encmlp_fwd', 16, 1, False, 345),
            ('encmlp_dual_fwd', 64, 2, False, 709),
            ('encmlp_bwd', 16, 1, True, 480),
            ('encmlp_dual_bwd', 64, 2, True, 744)):
        ins = kernel_inputs(FE, T, rc, cfg, params, S, R, device)
        st, est, p = ins[:3]
        print(f'{name} R={R} S={S} (mixamo recipe):')
        if bwd:
            g = _composited_cotangent(FE, ins, nnet, device)
            run, plain = _bwd_calls(FE, *ins, g, nnet)
            max_abs = _check_bwd(name, plain(), run())
            ms, plain_ms = _time_ms(run, 5), _time_ms(plain, 1, windows=3)
        else:
            run, plain = _calls(FE, *ins, nnet)
            max_abs = _check_close(name, plain(), run())
            ms, plain_ms = _time_ms(run, 10), _time_ms(plain, 2)
        row = _timed_row(
            name, 'encmlp_bwd.cu' if bwd else 'encmlp_fwd.cu', line,
            FE.kernel_cost(st, est, p.shape[0], nnet, backward=bwd), ms,
            plain_ms, max_abs, peaks, f'R={R} S={S}')
        shapes[name] = {k: row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                             'bound_by', 'max_abs_err')}
        shapes[name]['points'] = p.shape[0]
        del ins, run, plain

    t0 = time.perf_counter()
    store = make_synthetic_store(os.path.join(WORK, 'mixamo.npstore'),
                                 n_frames=24, H=512, W=512, body_scale=450.0,
                                 blob_radius=4)
    print(f'cli_train: synthetic store 24 x 512x512 written in '
          f'{time.perf_counter() - t0:.1f} s')
    over = dict(dataset_type=('synthetic',), datadir=store,
                basedir=os.path.join(WORK, 'logs'), n_iters=CLI_STEPS,
                i_print=10, i_weights=20, i_pose_weights=20, i_testset=40,
                num_workers=4)
    ccfg = _cli_config('mixamo.txt', **over)
    if not (ccfg.opt_pose_joint and ccfg.opt_pose_step == 20
            and ccfg.loss_fn == 'L1' and ccfg.opt_rot6d):
        raise AssertionError('the mixamo recipe changed')

    # the loader alone, timed on the host: a fresh Prefetcher's first
    # 40 batches (its workers' throughput; the clock starts before its
    # threads do), and one thread's get_batch
    pf, _, _ = load_data(ccfg)
    t0 = time.perf_counter()
    n = sum(1 for _, _ in zip(range(40), pf))
    loader_ms = (time.perf_counter() - t0) / n * 1e3
    pf.stop()
    ds, rng = pf.dataset, np.random.default_rng(0)
    idxs = np.sort(rng.integers(0, len(ds), ccfg.N_sample_images))
    ds.get_batch(idxs, rng)
    t0 = time.perf_counter()
    for _ in range(10):
        ds.get_batch(idxs, rng)
    batch_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f'cli_train: Prefetcher ({ccfg.num_workers} workers) '
          f'{loader_ms:.3f} ms per batch over its first {n} batches of '
          f'{ccfg.N_rand} rays ({ccfg.N_sample_images} images); one '
          f'thread\'s get_batch {batch_ms:.3f} ms ({gpu_line})')

    rec = {'banks': [], 'losses': [], 'counts': None}
    watch = SyncWatch(_periodic(ccfg))

    def on_step(i, state, stats):
        watch.pause()
        if stats is None:
            FE.reset_launch_counts()
        else:
            rec['losses'].append(stats['total_loss'])
        rec['banks'].append(state['pose_params']['bones'].clone())
        if i == 10:
            torch.cuda.synchronize()
            rec['t0'] = time.perf_counter()
        if i == CLI_STEPS:
            torch.cuda.synchronize()
            rec['dt'] = time.perf_counter() - rec['t0']
            rec['counts'] = FE.launch_counts()
        watch.resume(i, last=i == CLI_STEPS)

    with watch:
        final = train(ccfg, device=device, on_step=on_step)
    torch.cuda.synchronize()
    watch.check('cli_train')
    counts = rec['counts']
    val = {k: v - counts[k] for k, v in FE.launch_counts().items()}
    print(f'cli_train: {CLI_STEPS} steps, launches {counts}; the '
          f'validation render (4 frames at 256x256) {val}')
    expect = {k: 0 for k in counts}
    expect.update({k: CLI_STEPS * n for k, n in FLAGSHIP_STEP.items()})
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not (val['encmlp_fwd'] == val['encmlp_dual_fwd'] > 0
            and sum(val.values()) == 2 * val['encmlp_fwd']):
        raise AssertionError(f'validation render launches {val}')
    losses = torch.stack(rec['losses']).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    banks = rec['banks']
    moved = [not torch.equal(banks[i + 1], banks[i])
             for i in range(CLI_STEPS)]
    if any(moved[:19]) or not moved[19]:
        raise AssertionError(f'pose bank moved at steps '
                             f'{[i for i, m in enumerate(moved) if m]}, '
                             'expected first at 19')
    logdir = os.path.join(ccfg.basedir, ccfg.expname)
    files = sorted(os.listdir(logdir))
    need = ['args.txt', 'ckpt_00000020.pt', 'ckpt_00000040.pt',
            'metrics.jsonl', 'pose_ckpt_00000020.pt',
            'pose_ckpt_00000040.pt', 'psnr.txt', 'ssim.txt']
    if not set(need) <= set(files):
        raise AssertionError(f'logdir holds {files}, expected {need}')
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    logged = [r['total_loss'] for r in recs if 'total_loss' in r]
    if len(logged) != CLI_STEPS // ccfg.i_print or \
            not np.isfinite(logged).all():
        raise AssertionError(f'logged losses {logged}')
    val_m = {}
    for name in ('psnr', 'ssim'):
        lines = open(os.path.join(logdir, f'{name}.txt')).read().split()
        if len(lines) != 1 or not np.isfinite(float(lines[0])):
            raise AssertionError(f'{name}.txt holds {lines}')
        val_m[name] = float(lines[0])
    print(f'cli_train: total_loss {losses[0]:.5f} -> {losses[-1]:.5f}; '
          f'logged {logged}; validation psnr {val_m["psnr"]:.3f} ssim '
          f'{val_m["ssim"]:.4f}; files {files}')
    n_timed = CLI_STEPS - 10
    rays_s = ccfg.N_rand * n_timed / rec['dt']
    print(f'cli_train: {rays_s:.1f} CLI train '
          f'rays/s, {rec["dt"] / n_timed * 1e3:.2f} ms/step over steps '
          f'10-{CLI_STEPS - 1} (the loop as run: Prefetcher, DeviceFeeder, '
          f'step, logs at 20 and 30, checkpoints at 20), loader '
          f'{loader_ms:.3f} ms per batch ({gpu_line})')

    # resume: one more step from the final checkpoint
    res = {}

    def on_resume(i, state, stats):
        if stats is None:
            res['start'] = i
            res['state'] = {k: [t.clone() for t in tree_leaves(state[k])]
                            for k in ('params', 'pose_params')}
            for m in ('mu', 'nu'):
                res['state'][m] = [t.clone() for t in tree_leaves(
                    state['opt_state'][m])]
            res['count'] = state['opt_state']['count']

    train(_cli_config('mixamo.txt', **dict(over, n_iters=CLI_STEPS + 1)),
          device=device, on_step=on_resume)
    want = {'params': tree_leaves(final['params']),
            'pose_params': tree_leaves(final['pose_params']),
            'mu': tree_leaves(final['opt_state']['mu']),
            'nu': tree_leaves(final['opt_state']['nu'])}
    same = all(len(want[k]) == len(res['state'][k]) and all(
        torch.equal(a, b) for a, b in zip(want[k], res['state'][k]))
        for k in want)
    print(f'cli_train: resumed at step {res["start"]}, NeRF Adam count '
          f'{res["count"]}, parameters, moments and pose bank equal to the '
          f'first run\'s final ones: {same}')
    if res['start'] != CLI_STEPS or res['count'] != CLI_STEPS or not same:
        raise AssertionError('the resume did not restore the final state')

    # one CLI step profiled inside the loop: a third call resumes at
    # step 41 and runs 4 steps; the window from on_step(44) to
    # on_step(45) holds the Prefetcher's hand-over, the DeviceFeeder
    # (its fourth batch, so it waits on the event of its first) and
    # step 44, with no logging, checkpoint or validation
    prof = {}
    at = CLI_STEPS + 4

    def on_profiled(i, state, stats):
        if i == at:
            torch.cuda.synchronize()
            prof['p'] = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            prof['p'].start()
            prof['t0'] = time.perf_counter()
        elif i == at + 1:
            torch.cuda.synchronize()
            prof['wall_ms'] = 1e3 * (time.perf_counter() - prof['t0'])
            prof['p'].stop()

    train(_cli_config('mixamo.txt', **dict(over, n_iters=at + 1)),
          device=device, on_step=on_profiled)
    busy = _device_busy(prof['p'])
    if busy is None:
        print('cli_train: one CLI step profiled: device time not measured')
    else:
        print(f'cli_train: one CLI step (step {at}: hand-over, '
              f'feeder and step) profiled: {prof["wall_ms"]:.1f} ms wall, '
              f'device busy {busy[0]:.1f} ms = '
              f'{busy[0] / prof["wall_ms"]:.1%}, {busy[1]} device kernels '
              f'and copies ({gpu_line})')
    # the host's waits in that window: the DeviceFeeder's event wait
    # (which set_sync_debug_mode does not report) and the two
    # synchronizes around the profiled window
    for e in prof['p'].key_averages():
        if 'Synchronize' in e.key or e.key.startswith('cudaMemcpy'):
            print(f'  host {e.key}: {e.count}x, '
                  f'{e.cpu_time_total / 1e3:.3f} ms')
    return counts, shapes, logdir, rays_s


def _clone_state(x):
    """A train state with every tensor copied."""
    import torch
    if isinstance(x, dict):
        return {k: _clone_state(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clone_state(v) for v in x]
    return x.clone() if torch.is_tensor(x) else x


def _after_replay(hook):
    """``hook()`` after every ``CUDAGraph.replay`` inside a ``with``
    block: the host's view of each replayed step (a clone it takes is
    queued after the replay)."""
    import torch

    def wrap(replay):
        def run(graph):
            replay(graph)
            hook()
        return run
    return _Wrapped(torch.cuda.CUDAGraph, replay=wrap)


def _kernel_launches(events, name):
    """Launches of device kernels named ``name`` (not as the tail of a
    longer name) among a profile's ``key_averages()``."""
    import re
    pat = re.compile(r'(?<![A-Za-z0-9_])' + re.escape(name))
    return sum(e.count for e in events
               if _device_ms(e) > 0 and str(e.device_type).endswith('CUDA')
               and pat.search(e.key))


# the kernels of a bundled phase: launch counter -> (device kernel name,
# launches a step)
BUNDLE_K1_K4 = {'encmlp_fwd': ('encmlp_fwd_kernel<1,', 1),
                'encmlp_dual_fwd': ('encmlp_fwd_kernel<2,', 1),
                'encmlp_bwd': ('bwd_tile_kernel<1,', 1),
                'encmlp_dual_bwd': ('bwd_tile_kernel<2,', 1),
                'vf_operand': ('vf_m_mma_kernel', 2),
                'vf_fold': ('vf_fold_kernel', 1)}
BUNDLE_K5_K6 = {'mlp_fwd': ('mlp_fwd_kernel', 3),
                'mlp_bwd': ('mlp_bwd_tile_kernel', 3)}
# surreal_single (SINGLE_STEP): K1 and K3 twice a step, K-vf1 twice,
# K-vf2 once, K2/K4 and K5/K6 never
BUNDLE_SINGLE = {'encmlp_fwd': ('encmlp_fwd_kernel<1,', 2),
                 'encmlp_bwd': ('bwd_tile_kernel<1,', 2),
                 'encmlp_dual_fwd': ('encmlp_fwd_kernel<2,', 0),
                 'encmlp_dual_bwd': ('bwd_tile_kernel<2,', 0),
                 'vf_operand': ('vf_m_mma_kernel', 2),
                 'vf_fold': ('vf_fold_kernel', 1),
                 'mlp_fwd': ('mlp_fwd_kernel', 0),
                 'mlp_bwd': ('mlp_bwd_tile_kernel', 0)}
# under fuse_tform: the template's last argument (TF) true, and the point
# forms of the same kernels never launched
BUNDLE_K1_K4_TF = {
    'encmlp_fwd_tf': ('encmlp_fwd_kernel<1, false, true>', 1),
    'encmlp_dual_fwd_tf': ('encmlp_fwd_kernel<2, true, true>', 1),
    'encmlp_bwd_tf': ('bwd_tile_kernel<1, false, true>', 1),
    'encmlp_dual_bwd_tf': ('bwd_tile_kernel<2, true, true>', 1),
    'encmlp_fwd': ('encmlp_fwd_kernel<1, false, false>', 0),
    'encmlp_dual_fwd': ('encmlp_fwd_kernel<2, true, false>', 0),
    'encmlp_bwd': ('bwd_tile_kernel<1, false, false>', 0),
    'encmlp_dual_bwd': ('bwd_tile_kernel<2, true, false>', 0),
    'vf_operand': ('vf_m_mma_kernel', 2), 'vf_fold': ('vf_fold_kernel', 1)}


def bundled_phase(FE, T, device, gpu_line, what, kernels, **build_kw):
    """``make_multi_train_step`` on the card: ``build_flagship(2048,
    steps_per_dispatch=BUNDLE, **build_kw)``, BUNDLED_STEPS steps in
    bundles (the first call warms up and captures the step's CUDA graph,
    every later step is a replay).  Checks:
    1. no draws (perturb 0, no noise), ten stacked batches: the
       parameters and pose bank against BUNDLED_STEPS eager steps from
       the same state and batches (BUNDLE_COS_MIN, BUNDLE_RATIO_TOL,
       BUNDLE_LOSS_RTOL), and the pose bank, read after every replay,
       still through step 18 and moved at step 19;
    2. draws on, one batch ten times: the coarse depths of every replay
       differ from the last replay's and equal, bit for bit, those the
       eager steps draw from a generator seeded alike; the last loss of
       the third bundle below the first's;
    3. one bundle profiled: each kernel of ``kernels`` (counter ->
       (device kernel, launches a step)) launched BUNDLE x its count,
       the device busy share beside that of one eager step;
    4. TIMING_WINDOWS windows of BUNDLE eager steps and one bundle each,
       in turns, no host sync inside a bundle (``set_sync_debug_mode(
       'error')``): host ms/step and train rays/s (medians), peak memory.
    ``build_kw`` names weights whose random density is positive inside
    the cylinder (``seed``): without draws, weights of no density give
    no gradient.  Returns the launch counters of part 1's bundles (those
    of the warm-up steps and the capture: a replay passes no
    wrapper)."""
    import torch
    from anerf_torch.ops import rays as ray_ops
    from anerf_torch.training import trainer as TT
    from torch.profiler import ProfilerActivity, profile
    K, N, W = BUNDLE, BUNDLED_STEPS, TT._GraphStep.WARMUP

    def build(**over):
        return T.build_flagship(2048, device=device, compute_dtype='bfloat16',
                                steps_per_dispatch=K, **dict(build_kw, **over))

    def gen():
        return torch.Generator(device=device).manual_seed(7)

    def one(batches, j):
        return {k: v[j] for k, v in batches.items()}

    # 1. no draws: against eager steps; the pose bank's first move
    setup, state, batches, multi = build(perturb=0., raw_noise_std=0.)
    eager = TT.make_train_step(setup)
    ref, g = _clone_state(state), gen()
    for s in range(N):
        ref, ref_stats = eager(ref, one(batches, s % K), g)
    p0 = [t.clone() for t in TT.tree_leaves(state['params'])]
    bank0 = state['pose_params']['bones'].clone()
    banks = []
    FE.reset_launch_counts()
    g = gen()
    with _after_replay(lambda: banks.append(
            state['pose_params']['bones'].clone())):
        for _ in range(N // K):
            state, stats = multi(state, batches, g)
    torch.cuda.synchronize()
    counts = FE.launch_counts()
    expect = {k: 0 for k in counts}
    expect.update({k: (W + 1) * n for k, (_, n) in kernels.items()})
    print(f'{what}: {N} steps in bundles of {K}: launch counters {counts} '
          f'({W} warm-up steps and the capture; replays pass no wrapper)')
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if len(banks) != N - W:
        raise AssertionError(f'{len(banks)} replays, expected {N - W}')
    after = [bank0] * W + banks
    moved = [s for s in range(W, N) if not torch.equal(after[s],
                                                       after[s - 1])]
    if not moved or moved[0] != 19:
        raise AssertionError(f'pose bank moved at steps {moved}, expected '
                             'first at 19')
    worst, max_d = [], 0.
    for name, a0, a, b in zip(
            _leaf_names(state['params']) + ['pose bank'], p0 + [bank0],
            TT.tree_leaves(ref['params']) + [ref['pose_params']['bones']],
            TT.tree_leaves(state['params']) + [state['pose_params']['bones']]):
        cos, ratio, _, d = _cmp(a - a0, b - a0)
        max_d = max(max_d, (a - b).abs().max().item())
        worst.append((cos, name, ratio))
        if cos < BUNDLE_COS_MIN or abs(ratio - 1) > BUNDLE_RATIO_TOL:
            raise AssertionError(f'{what}: {name} after {N} steps: update '
                                 f'cos {cos:.6f} ratio {ratio:.5f} against '
                                 'the eager steps')
    la, lb = ref_stats['total_loss'].item(), stats['total_loss'].item()
    worst.sort()
    print(f'{what}: against {N} eager steps: max |d| {max_d:.3e}, last '
          f'total_loss {lb:.6f} vs {la:.6f}; worst updates: ' + ', '.join(
              f'{k} cos {c:.7f} ratio {r:.6f}' for c, k, r in worst[:3])
          + f'; pose bank moved first at step {moved[0]}')
    if abs(la - lb) > BUNDLE_LOSS_RTOL * abs(la):
        raise AssertionError(f'{what}: last loss {lb} against eager {la}')
    del ref, multi, p0, banks, after

    # 2. draws on: fresh per replay, the eager steps' own
    setup, state, batches, multi = build()
    same = {k: v[:1].expand(K, *v.shape[1:]).contiguous()
            for k, v in batches.items()}
    eager = TT.make_train_step(setup)
    ref = _clone_state(state)
    live = {'eager': []}

    def lineseg(fn):
        def run(*args, **kwargs):
            z = fn(*args, **kwargs)
            if torch.cuda.is_current_stream_capturing():
                live['graph'] = z           # the graph's buffer
            else:
                live['eager'].append(z)
            return z
        return run
    zs, losses = [], []
    with _Wrapped(ray_ops, sample_from_lineseg=lineseg):
        g = gen()
        for _ in range(N):
            ref, _ = eager(ref, one(same, 0), g)
        z_eager, live['eager'] = live['eager'], []
        g = gen()
        with _after_replay(lambda: zs.append(live['graph'].clone())):
            for _ in range(N // K):
                state, stats = multi(state, same, g)
                losses.append(stats['total_loss'])
    z_bundle = live['eager'] + zs
    if len(z_bundle) != N:
        raise AssertionError(f'{len(z_bundle)} draws, expected {N}')
    repeated = [s for s in range(1, N)
                if torch.equal(z_bundle[s], z_bundle[s - 1])]
    as_eager = sum(torch.equal(a, b) for a, b in zip(z_bundle, z_eager))
    losses = [x.item() for x in losses]
    print(f'{what}: draws on: coarse depths of consecutive steps equal at '
          f'{repeated} (none expected), bit-equal to the eager steps\' '
          f'at {as_eager} of {N} steps; last losses of the bundles '
          f'{losses}')
    if repeated or as_eager != N:
        raise AssertionError(f'{what}: replays do not draw as the eager '
                             'steps do')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'{what}: the loss did not fall: {losses}')
    del ref, z_eager, z_bundle, zs, live

    # 3. one bundle and one eager step profiled
    busy = {}
    for mode in ('eager', 'bundled'):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if mode == 'eager':
                state, _ = eager(state, one(same, 0), g)
            else:
                state, _ = multi(state, same, g)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        b = sum(_device_ms(e) for e in events
                if str(e.device_type).endswith('CUDA'))
        busy[mode] = (b or None, wall)
        if mode == 'bundled':
            got = {k: _kernel_launches(events, kern)
                   for k, (kern, _) in kernels.items()}
    want = {k: K * n for k, (_, n) in kernels.items()}
    print(f'{what}: one profiled bundle launched {got} (expected {want})')
    if got != want:
        raise AssertionError(f'{what}: profiled launches {got}, expected '
                             f'{want}')

    # 4. eager and bundled windows in turns
    ms = {'eager': [], 'bundled': []}
    peak = {}
    for w in range(TIMING_WINDOWS):
        for mode in ('eager', 'bundled'):
            torch.cuda.synchronize()
            if w == 0:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if mode == 'eager':
                for j in range(K):
                    state, _ = eager(state, one(same, j), g)
            else:
                torch.cuda.set_sync_debug_mode('error')
                try:
                    state, _ = multi(state, same, g)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms[mode].append(1e3 * (time.perf_counter() - t0) / K)
            if w == 0:
                peak[mode] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2**30
    med = {k: statistics.median(v) for k, v in ms.items()}
    share = {k: ('not measured' if b is None else f'{b:.1f} of {wall:.1f} '
                 f'ms = {b / wall:.1%}') for k, (b, wall) in busy.items()}
    print(f'{what}: eager {med["eager"]:.2f} ms/step '
          f'({2048e3 / med["eager"]:.1f} train rays/s), bundled '
          f'{med["bundled"]:.2f} ms/step ({2048e3 / med["bundled"]:.1f} '
          f'train rays/s): medians of {TIMING_WINDOWS} windows of {K} '
          f'steps each, in turns (eager {[round(x, 2) for x in ms["eager"]]}'
          f', bundled {[round(x, 2) for x in ms["bundled"]]}); no host sync '
          f'inside a bundle; device busy (profiled): one eager step '
          f'{share["eager"]}, a bundle {share["bundled"]}; peak device '
          f'memory eager {peak["eager"]:.2f} GiB, bundled '
          f'{peak["bundled"]:.2f} GiB, reserved with the graph held '
          f'{held:.2f} GiB ({gpu_line})')
    return counts


def cli_bundled_phase(FE, device, gpu_line, eager_rays_s):
    """``configs/mixamo.txt`` through ``run_train.train`` at
    ``--steps_per_dispatch`` BUNDLE on ``cli_train``'s store: CLI_STEPS
    steps in four bundles (each ``on_step`` call after a bundle), logs
    and checkpoints every 20 steps (multiples of BUNDLE, as the cadences
    must be), a validation render at 40.  Checks: the launch counters
    of the steps those of the warm-up steps and the capture (K1-K4 each
    ``_GraphStep.WARMUP`` + 1 times, K5/K6 never); the pose bank, read
    after every replay, still through step 18 and moved at 19; no host
    sync inside the windows from ``on_step(10)`` and ``on_step(30)`` (a
    bundle with the loader's hand-over and the DeviceFeeder, no logging
    or checkpoint); finite logged losses, the checkpoints, pose
    checkpoints and validation metrics written.  Prints CLI train rays/s
    over steps 10-29 beside ``cli_train``'s one-step-a-dispatch figure
    (``eager_rays_s``, steps 10-39), and the device busy share of the
    profiled window from ``on_step(30)`` to ``on_step(40)``, and the peak
    device memory over steps 10-29.  Returns the launch counters."""
    import numpy as np
    import torch
    from anerf_torch.run_train import train
    from anerf_torch.training import trainer as TT
    from torch.profiler import ProfilerActivity, profile
    over = dict(dataset_type=('synthetic',),
                datadir=os.path.join(WORK, 'mixamo.npstore'),
                basedir=os.path.join(WORK, 'logs'), expname='mixamo_spd',
                n_iters=CLI_STEPS, i_print=20, i_weights=20,
                i_pose_weights=20, i_testset=40, num_workers=4,
                steps_per_dispatch=BUNDLE)
    ccfg = _cli_config('mixamo.txt', **over)
    rec = {'seen': [], 'banks': []}
    watch = SyncWatch(_periodic(ccfg))

    def on_step(i, state, stats):
        watch.pause()
        rec['seen'].append(i)
        if stats is None:
            FE.reset_launch_counts()
            rec['bank0'] = state['pose_params']['bones'].clone()
            rec['state'] = state
        else:
            rec.setdefault('losses', []).append(stats['total_loss'])
        if i in (10, 30):
            torch.cuda.synchronize()
            rec[f't{i}'] = time.perf_counter()
        if i == 10:
            torch.cuda.reset_peak_memory_stats()
        if i == 30:
            rec['peak'] = torch.cuda.max_memory_allocated() / 2**30
            rec['prof'] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            rec['prof'].start()
        if i == CLI_STEPS:
            torch.cuda.synchronize()
            rec['wall_ms'] = 1e3 * (time.perf_counter() - rec['t30'])
            rec['prof'].stop()
            rec['counts'] = FE.launch_counts()
        watch.resume(i, last=i == CLI_STEPS)

    def after_replay():
        rec['banks'].append(rec['state']['pose_params']['bones'].clone())
    with watch, _after_replay(after_replay):
        train(ccfg, device=device, on_step=on_step)
    torch.cuda.synchronize()
    watch.check('cli_bundled')
    counts, W = rec['counts'], TT._GraphStep.WARMUP
    print(f'cli_bundled: on_step at {rec["seen"]}, launch counters {counts}'
          f' ({W} warm-up steps and the capture)')
    expect = {k: 0 for k in counts}
    expect.update({k: (W + 1) * n for k, (_, n) in BUNDLE_K1_K4.items()})
    if counts != expect or rec['seen'] != list(range(0, CLI_STEPS + 1,
                                                     BUNDLE)):
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    after = [rec['bank0']] * W + rec['banks']
    moved = [s for s in range(W, CLI_STEPS)
             if not torch.equal(after[s], after[s - 1])]
    if len(after) != CLI_STEPS or not moved or moved[0] != 19:
        raise AssertionError(f'{len(after)} steps, pose bank moved at '
                             f'{moved}, expected first at 19')
    logdir = os.path.join(ccfg.basedir, ccfg.expname)
    files = sorted(os.listdir(logdir))
    need = ['ckpt_00000020.pt', 'ckpt_00000040.pt', 'metrics.jsonl',
            'pose_ckpt_00000020.pt', 'pose_ckpt_00000040.pt', 'psnr.txt',
            'ssim.txt']
    with open(os.path.join(logdir, 'metrics.jsonl')) as f:
        logged = [r['total_loss'] for r in map(json.loads, f)
                  if 'total_loss' in r]
    if not set(need) <= set(files) or len(logged) != 2 \
            or not np.isfinite(logged).all():
        raise AssertionError(f'logdir {files}, logged losses {logged}')
    rays_s = ccfg.N_rand * 20 / (rec['t30'] - rec['t10'])
    busy = _device_busy(rec['prof'])
    share = ('not measured' if busy is None else
             f'{busy[0]:.1f} of {rec["wall_ms"]:.1f} ms = '
             f'{busy[0] / rec["wall_ms"]:.1%}')
    print(f'cli_bundled: {rays_s:.1f} CLI train rays/s over steps 10-29 at '
          f'{BUNDLE} steps a dispatch ({ccfg.N_rand * 1e3 / rays_s:.2f} '
          f'ms/step), against {eager_rays_s:.1f} at one step a dispatch '
          f'(cli_train, steps 10-39); device busy over steps 30-39 '
          f'(loader hand-over, feeder, one bundle, profiled) {share}; peak '
          f'device memory over steps 10-29 {rec["peak"]:.2f} GiB; logged '
          f'{logged}; pose bank first moved at step {moved[0]} ({gpu_line})')
    return counts


def cli_flipflop_phase(FE, device, gpu_line):
    """The alternating mode at the flagship's width: ``configs/surreal.txt``
    with pose refinement, ``opt_pose_flipflop``, ``opt_pose_interval=4``,
    ``opt_pose_step=2``, ``opt_pose_reset`` and ``opt_pose_warmup=0`` on a
    synthetic store, FF_STEPS steps through ``run_train.train``.  At every
    step: the NeRF parameters and the NeRF Adam count change exactly when
    the host gate says the NeRF fires, the pose bank exactly when it
    says the pose fires, the snapshot equals the pre-update bank at each
    pose-turn start and is left alone otherwise, kp_tracker_mean is
    finite, and no host sync.  Returns the launch counts."""
    import torch
    from anerf_torch.data.writer import make_synthetic_store
    from anerf_torch.run_train import train
    from anerf_torch.training import flipflop as FF
    from anerf_torch.training.trainer import step_gates, tree_leaves
    store = make_synthetic_store(os.path.join(WORK, 'surreal.npstore'),
                                 n_frames=16, H=256, W=256, body_scale=450.0,
                                 blob_radius=2, seed=1)
    fcfg = _cli_config('surreal.txt', dataset_type=('synthetic',),
                       datadir=store, basedir=os.path.join(WORK, 'logs'),
                       n_iters=FF_STEPS, num_workers=4, opt_pose=True,
                       opt_pose_flipflop=True, opt_pose_interval=4,
                       opt_pose_step=2, opt_pose_reset=True,
                       opt_pose_warmup=0)
    prev, log = {}, []
    watch = SyncWatch(_periodic(fcfg))

    def snap(state):
        return {'nerf': [t.clone() for t in tree_leaves(state['params'])],
                'count': state['opt_state']['count'],
                'bank': {k: v.clone() for k, v in
                         state['pose_params'].items()},
                'snap': {k: v.clone() for k, v in
                         state['pose_snapshot'].items()}}

    def on_step(i, state, stats):
        watch.pause()
        if stats is None:
            FE.reset_launch_counts()
        else:
            s = i - 1
            g = step_gates(fcfg, s)
            now = snap(state)
            nerf_moved = any(not torch.equal(a, b) for a, b in
                             zip(prev['nerf'], now['nerf']))
            bank_moved = any(not torch.equal(prev['bank'][k], now['bank'][k])
                             for k in now['bank'])
            turn_start = FF.snapshot_gate(g.ff, s + 1)
            want_snap = prev['bank'] if turn_start else prev['snap']
            snap_ok = all(torch.equal(now['snap'][k], want_snap[k])
                          for k in want_snap)
            log.append((s, g.nerf, g.pose, turn_start, nerf_moved,
                        now['count'] - prev['count'], bank_moved, snap_ok,
                        stats['kp_tracker_mean']))
        prev.update(snap(state))
        watch.resume(i, last=i == FF_STEPS)

    with watch:
        train(fcfg, device=device, on_step=on_step)
    torch.cuda.synchronize()
    watch.check('cli_flipflop')
    counts = FE.launch_counts()
    bad = []
    for s, nerf, pose, turn, nm, dc, bm, sok, km in log:
        km = float(km)
        print(f'  cli_flipflop step {s}: gates nerf {int(nerf)} pose '
              f'{int(pose)} turn start {int(turn)}; NeRF moved {int(nm)}, '
              f'Adam count +{dc}, bank moved {int(bm)}, snapshot ok '
              f'{int(sok)}, kp_tracker_mean {km:.5f}')
        if nm != nerf or dc != int(nerf) or bm != pose or not sok or \
                km != km or abs(km) == float('inf'):
            bad.append(s)
    fires = [sum(x[1] for x in log), sum(x[2] for x in log),
             sum(x[3] for x in log)]
    print(f'cli_flipflop: {FF_STEPS} steps, NeRF turns {fires[0]}, pose '
          f'fires {fires[1]}, pose-turn starts {fires[2]}, launches {counts}'
          f' ({gpu_line})')
    if bad or len(log) != FF_STEPS or 0 in fires:
        raise AssertionError(f'cli_flipflop: the gates did not hold at '
                             f'steps {bad}')
    # every K2 and K4 launch ran viewfac: K-vf1 before each, K-vf2 after K4
    if not (counts['vf_operand'] == counts['encmlp_dual_fwd']
            + counts['encmlp_dual_bwd'] and counts['vf_fold']
            == counts['encmlp_dual_bwd'] > 0):
        raise AssertionError(f'cli_flipflop: K2/K4 without viewfac: {counts}')
    return counts


def cli_multisubject_phase(FE, device, gpu_line):
    """Two synthetic subjects of different body sizes, each its own
    store, through ``run_train.train`` (``ConcatDataset``, a rest pose
    per subject, the subject channel) at ``configs/mixamo.txt``'s
    recipe: CLI_MS_STEPS steps, K5 and K6 three times a step and K1-K4
    never, finite losses.  Returns the launch counts."""
    import torch
    from anerf_torch.data.writer import make_synthetic_store
    from anerf_torch.run_train import train
    d = os.path.join(WORK, 'two')
    for name, scale, seed in (('a', 450.0, 2), ('b', 400.0, 3)):
        make_synthetic_store(os.path.join(d, f'{name}.npstore'), n_frames=8,
                             H=256, W=256, body_scale=scale, blob_radius=2,
                             seed=seed)
    mcfg = _cli_config('mixamo.txt', subject=('a', 'b'),
                       dataset_type=('synthetic', 'synthetic'), datadir=d,
                       basedir=os.path.join(WORK, 'logs'), expname='two',
                       n_iters=CLI_MS_STEPS, num_workers=4)
    rec = {'losses': []}

    def on_step(i, state, stats):
        if stats is None:
            rec['subjects'] = state['params']['coarse']['views_linear'][
                'w'].shape
            FE.reset_launch_counts()
        else:
            rec['losses'].append(stats['total_loss'])
        if i == CLI_MS_STEPS:
            torch.cuda.synchronize()
            rec['counts'] = FE.launch_counts()

    train(mcfg, device=device, on_step=on_step)
    counts = rec['counts']
    losses = torch.stack(rec['losses']).cpu()
    print(f'cli_multisubject: {CLI_MS_STEPS} steps, views layer '
          f'{tuple(rec["subjects"])}, launches {counts}, total_loss '
          f'{losses.tolist()} ({gpu_line})')
    expect = {k: 0 for k in counts}
    expect.update(mlp_fwd=3 * CLI_MS_STEPS, mlp_bwd=3 * CLI_MS_STEPS)
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')
    if not torch.isfinite(losses).all():
        raise AssertionError(f'non-finite losses {losses.tolist()}')
    return counts


# the cli_render phase's runs of ``anerf_torch.run_render``: render type,
# its flags (frames at the store's 512x512)
RENDER_RUNS = (
    ('bullet', ['--n_bullet', '4']),
    ('val', ['--eval']),
    ('selected', ['--render_refined', '--selected_idxs', '0', '12']),
    ('interpolate', ['--mix_framecodes', '--selected_idxs', '0', '6',
                     '--n_step', '3']),
    ('retarget', ['--selected_idxs', '3', '9']),
    ('animate', ['--selected_idxs', '0', '6', '--n_step', '2']),
    ('poserot', ['--selected_idxs', '5', '--n_bullet', '6']),
    ('bubble', ['--selected_idxs', '7', '--n_step', '3']),
    ('correction', ['--render_refined', '--selected_idxs', '5',
                    '--n_step', '2']),
)
MESH_RES = 64
MESH_IDX = 2


class _Wrapped:
    """Replace attributes of an object by wrappers for the duration of a
    ``with`` block: ``wrappers`` maps a name to ``f(original)``."""

    def __init__(self, obj, **wrappers):
        self.obj, self.wrappers, self.saved = obj, wrappers, {}

    def __enter__(self):
        for name, wrap in self.wrappers.items():
            self.saved[name] = getattr(self.obj, name)
            setattr(self.obj, name, wrap(self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.obj, name, fn)


def _kernel_twins(FE, backward=False):
    """K1 and K2 (and with ``backward`` K3 and K4) replaced by their plain
    twins, on the card's tensors."""
    twins = dict(_fwd=lambda _: FE.encmlp_fwd_plain,
                 _dual_fwd=lambda _: FE.encmlp_dual_fwd_plain)
    if backward:
        twins.update(encmlp_bwd=lambda _: FE.encmlp_bwd_plain,
                     encmlp_dual_bwd=lambda _: FE.encmlp_dual_bwd_plain)
    return _Wrapped(FE, **twins)


def _clocked(times, name):
    """A wrapper that adds each call's host seconds, the device drained
    on both sides, to ``times[name]``."""
    import torch

    def wrap(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.) + time.perf_counter() - t0
            return out
        return run
    return wrap


def _frame(rd, i):
    """Frame ``i`` of a render_data dict as a one-frame render_data."""
    import numpy as np
    one = {}
    for k, v in rd.items():
        if k == 'hwf':
            one[k] = tuple(np.atleast_1d(x)[i:i + 1] for x in v)
        elif k in ('bgs', 'bg_idxs_len', 'cam_idxs_len', 'kp_idxs_len') \
                or v is None or np.ndim(v) == 0:
            one[k] = v
        else:
            one[k] = v[i:i + 1]
    return one


def _maps_close(what, ref, got):
    """Rendered maps within MAP_TOL of the frame's max."""
    import numpy as np
    for k in ('rgbs', 'accs'):
        scale = float(np.abs(ref[k]).max()) + 1e-6
        err = float(np.abs(ref[k] - got[k]).max())
        print(f'  {what} {k}: max|d| {err:.3e} scale {scale:.3e} rel '
              f'{err / scale:.3e}')
        if err > MAP_TOL * scale:
            raise AssertionError(f'{what}: the kernels\' {k} disagree with '
                                 'their twins\'')


def cli_render_phase(FE, logdir, ckpt, device, gpu_line):
    """``anerf_torch.run_render.main`` on ``cli_train``'s mixamo
    checkpoint and its 512x512 store: every render type (RENDER_RUNS,
    then ``mesh``), each run's files written and its frames finite, K1
    and K2 launched once per chunk and K3-K6 never; one bullet frame and
    one mixed-framecode interpolate frame re-rendered through K1/K2's
    plain twins within MAP_TOL, from the checkpoint and from the same
    checkpoint with its NeRF weights drawn from seed 5 (whose frames,
    unlike the trained ones, are not empty); the mesh's density grid
    against the same grid computed on the host CPU, within MAP_TOL off
    the joints, and a mesh with vertices.  Prints seconds per bullet frame and eval rays/s through
    the entry point, the grid's device ms and points/s and the host
    meshing and turntable seconds.  Returns the launch counts of all
    runs."""
    import numpy as np
    import torch
    from anerf_torch import run_render as RR
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import init_raycaster_params
    from anerf_torch.render import mesh as M
    from anerf_torch.render.renderer import ImageRenderer

    outdir = os.path.join(WORK, 'render')
    base = ['--nerf_args', os.path.join(logdir, 'args.txt'), '--ckptpath',
            ckpt,
            '--outputdir', outdir]
    total = {}
    chunks = [0]

    def count_chunks(fn):
        def run(*args):
            chunks[0] += 1
            return fn(*args)
        return run

    def run(render_type, flags, runname):
        """One entry-point run: its chunks and launches checked, its
        files listed; returns (output, host seconds, launch counts)."""
        chunks[0] = 0
        torch.cuda.synchronize()
        FE.reset_launch_counts()
        t0 = time.perf_counter()
        out = RR.main(base + ['--render_type', render_type,
                              '--runname', runname] + flags, device=device)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = FE.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        expect = {k: 0 for k in counts}
        expect.update(encmlp_fwd=chunks[0], encmlp_dual_fwd=chunks[0])
        if counts != expect or (render_type != 'mesh' and not chunks[0]):
            raise AssertionError(f'cli_render {runname}: launches {counts} '
                                 f'for {chunks[0]} chunks')
        files = sorted(os.listdir(out['outdir']))
        if render_type != 'mesh':
            n = len(out['rgbs'])
            need = [f'{i:04d}.png' for i in range(n)]
            video = ([f'{render_type}.mp4'] if f'{render_type}.mp4' in files
                     else [f'{render_type}_{i:04d}.png' for i in range(n)])
            if render_type == 'val':
                need += ['score_final.txt', 'scores.npy']
            if not n or not set(need + video) <= set(files):
                raise AssertionError(f'cli_render {runname}: {n} frames, '
                                     f'files {files}')
            for k in ('rgbs', 'accs', 'disps'):
                if not np.isfinite(out[k]).all():
                    raise AssertionError(f'cli_render {runname}: '
                                         f'non-finite {k}')
            print(f'cli_render {runname}: {n} frames '
                  f'{out["rgbs"].shape[1]}x{out["rgbs"].shape[2]}, '
                  f'{chunks[0]} chunks, launches {counts}, {dt:.3f} s, '
                  f'acc max {out["accs"].max():.3f}, files {len(files)}')
        return out, dt, counts

    with _Wrapped(ImageRenderer, _render_chunk=count_chunks):
        run('bullet', ['--n_bullet', '4'], 'warm-up')
        times = {}
        outs = {}
        with _Wrapped(ImageRenderer,
                      render_path=_clocked(times, 'render_path')):
            for render_type, flags in RENDER_RUNS:
                outs[render_type], dt, _ = run(render_type, flags,
                                               render_type)
                times.setdefault('entry', {})[render_type] = dt
                times.setdefault('path', {})[render_type] = \
                    times.pop('render_path')
    b = outs['bullet']
    n_rays = sum(int((br[0] - tl[0]) * (br[1] - tl[1]))
                 for tl, br in b['bboxes'])
    n = len(b['rgbs'])
    print(f'cli_render: bullet through the entry point: '
          f'{times["entry"]["bullet"] / n:.3f} s per 512x512 frame '
          f'(main() as called: config, store, checkpoint, PNGs), '
          f'render_path {times["path"]["bullet"] / n:.3f} s per frame, '
          f'{n_rays / times["path"]["bullet"]:.1f} eval rays/s over '
          f'{n_rays} rays in {n} frames ({gpu_line})')
    for rt, dt in times['entry'].items():
        print(f'  cli_render {rt}: main() {dt:.3f} s, render_path '
              f'{times["path"][rt]:.3f} s')
    with open(os.path.join(outdir, 'val', 'score_final.txt')) as f:
        print(f'cli_render val --eval: {f.read().split()}')

    # one bullet frame and one mixed-framecode frame through the twins.
    # After 40 steps the trained density is negative everywhere (the
    # synthetic frames are mostly background, which an empty field
    # matches), so its frames are empty and agree trivially; the same
    # checkpoint with the NeRF weights drawn afresh from seed 5 (positive
    # density around the body) renders frames with content, and those
    # are held to the twins too
    seeded = os.path.join(WORK, 'ckpt_seed5.pt')
    ck = torch.load(ckpt, map_location='cpu', weights_only=False)
    cfg, rc, *_, attrs = RR.load_everything(RR.parse_args(base))
    ck['params'] = dict(init_raycaster_params(
        torch.Generator().manual_seed(5), rc, cfg),
        cutoff_dist=ck['params']['cutoff_dist'])
    torch.save(ck, seeded)
    base[base.index(ckpt)] = seeded
    with _Wrapped(ImageRenderer, _render_chunk=count_chunks):
        for rt in ('bullet', 'interpolate'):
            outs[f'{rt} seed 5'] = run(rt, dict(RENDER_RUNS)[rt],
                                       f'{rt}_seed5')[0]
    base[base.index(seeded)] = ckpt
    before = FE.launch_counts()
    for name, i in (('bullet', 1), ('interpolate', 1), ('bullet seed 5', 1),
                    ('interpolate seed 5', 1)):
        rd = outs[name]['render_data']
        if name.startswith('interpolate') and not (
                np.ndim(rd['cam_idxs'][i]) == 1
                and 0 < rd['cam_idxs'][i][2] < 1):
            raise AssertionError(f'frame {i} mixes no framecodes: '
                                 f'{rd["cam_idxs"][i]}')
        with _kernel_twins(FE):
            ref = outs[name]['renderer'].render_path(_frame(rd, i))
        got = {k: outs[name][k][i:i + 1] for k in ('rgbs', 'accs')}
        _maps_close(f'cli_render {name} frame {i}, kernels vs twins', ref,
                    got)
        if name.endswith('seed 5') and got['accs'].max() < 0.5:
            raise AssertionError(f'{name}: empty frame, the check above '
                                 'would be vacuous')
    if FE.launch_counts() != before:
        raise AssertionError('the twins launched a kernel')

    # the mesh: its density grid timed and held against the host's
    renderer = outs['bullet']['renderer']
    rest = np.asarray(attrs['rest_pose'], np.float32)
    pose = RR.mesh_pose(attrs['kp3d'], attrs['bones'], rest, MESH_IDX,
                        device)
    grid = lambda: M.extract_density_grid(renderer.rc, renderer.params, pose,
                                          1.0, MESH_RES,
                                          state=renderer.state)
    sigma = grid()
    grid_ms = _time_ms(grid, 1, windows=3)
    n_pts = (MESH_RES + 1) ** 3
    cpu = torch.device('cpu')
    t0 = time.perf_counter()
    sigma_cpu = M.extract_density_grid(
        renderer.rc, params_to(renderer.params, cpu),
        {k: v.to(cpu) for k, v in pose.items()}, 1.0, MESH_RES,
        state={k: None if v is None else v.to(cpu)
               for k, v in renderer.state.items()})
    cpu_s = time.perf_counter() - t0
    # the grid's centre is the root joint itself, where the bone
    # direction encoding normalizes a zero vector: no direction, so the
    # two devices' roundoff picks two; every other point is compared
    t = np.linspace(-1., 1., MESH_RES + 1, dtype=np.float32)
    pts = np.stack(np.meshgrid(t, t, t), -1) + \
        pose['kps'][0, 0].cpu().numpy()
    at_joint = np.linalg.norm(pts[..., None, :] - pose['kps'][0].cpu()
                              .numpy(), axis=-1).min(-1) < 1e-4
    d = np.abs(sigma - sigma_cpu)
    scale = float(np.abs(sigma_cpu).max()) + 1e-6
    err = float(d[~at_joint].max())
    print(f'cli_render mesh: density grid {MESH_RES + 1}^3 = {n_pts} '
          f'points: {grid_ms:.3f} ms on the card (CUDA events, one call: '
          f'points up, densities down), {n_pts / grid_ms * 1e3:.4g} '
          f'points/s; against the host CPU\'s grid ({cpu_s:.2f} s): max|d| '
          f'{err:.3e} scale {scale:.3e} rel {err / scale:.3e}, mean rel '
          f'{float(d.mean()) / scale:.3e} over {int((~at_joint).sum())} '
          f'points ({int(at_joint.sum())} on a joint: max|d| '
          f'{float(d[at_joint].max(initial=0.)):.3e}); density range '
          f'[{sigma.min():.3f}, {sigma.max():.3f}] ({gpu_line})')
    if err > MAP_TOL * scale or not np.isfinite(sigma).all():
        raise AssertionError('cli_render mesh: the density grid disagrees '
                             'with the host\'s')
    # the surface of the densest half percent: a trained-for-40-steps
    # field stays below the default threshold of 10
    thres = float(np.quantile(sigma, 0.995))
    mtimes = {}
    with _Wrapped(M, marching_tetrahedra=_clocked(mtimes, 'marching'),
                  render_turntable=_clocked(mtimes, 'turntable'),
                  extract_density_grid=_clocked(mtimes, 'grid')):
        out, dt, _ = run('mesh', ['--mesh_res', str(MESH_RES),
                                  '--mesh_thres', f'{thres:.6f}',
                                  '--selected_idxs', str(MESH_IDX)], 'mesh')
    (m,) = out['meshes']
    files = sorted(os.listdir(out['outdir']))
    need = [f'mesh_{MESH_IDX:05d}.ply']
    turn = ([f'mesh_{MESH_IDX:05d}.mp4'] if need[0][:-3] + 'mp4' in files
            else [f'mesh_{MESH_IDX:05d}_{i:04d}.png' for i in range(20)])
    print(f'cli_render mesh: threshold {thres:.4f} (99.5th percentile), '
          f'{len(m["verts"])} vertices, {len(m["faces"])} faces; main() '
          f'{dt:.2f} s: grid {mtimes["grid"]:.3f} s, marching tetrahedra '
          f'{mtimes["marching"]:.2f} s (host), 20-view 256x256 turntable '
          f'{mtimes.get("turntable", 0.):.2f} s (host); files {len(files)}')
    if not len(m['verts']) or not set(need + turn) <= set(files):
        raise AssertionError(f'cli_render mesh: {len(m["verts"])} vertices, '
                             f'files {files}')
    print(f'cli_render: launches over all runs {total} ({gpu_line})')
    return total


def _leaf_names(tree, prefix=''):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f'{prefix}{k}.')]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f'{prefix}{i}.')]
    return [] if tree is None else [prefix[:-1]]


# a step's device kernels by the fused kernel and pass they belong to
# (name substrings); K3's and K4's dW and bias passes share their names
K1_K4_GROUPS = {'K1 encmlp_fwd_kernel<1>': ('encmlp_fwd_kernel<1,',),
                'K2 encmlp_fwd_kernel<2>': ('encmlp_fwd_kernel<2,',),
                'K3 per-tile bwd_tile_kernel<1>': ('bwd_tile_kernel<1,',),
                'K3 pullback, denc <1>': ('pullback_kernel<1,',
                                          'denc_kernel<1,'),
                'K4 per-tile bwd_tile_kernel<2>': ('bwd_tile_kernel<2,',),
                'K4 pullback, denc <2>': ('pullback_kernel<2,',
                                          'denc_kernel<2,'),
                'K3+K4 dW dw_kernel, dw_sum_kernel': DW_KERNELS,
                'K3+K4 bias_kernel': ('bias_kernel',),
                'K-vf1 vf_m_mma_kernel': ('vf_m_mma_kernel',),
                'K3/K4 vf_gram_kernel': ('vf_gram_kernel',),
                'K-vf2 vf_fold(_sum)_kernel': VF_KERNELS[2:]}
K5_K6_GROUPS = {'K5 mlp_fwd_kernel': ('mlp_fwd_kernel',),
                'K6 mlp_bwd_tile_kernel': ('mlp_bwd_tile_kernel',),
                'K6 dx_kernel': ('dx_kernel',),
                'K6 dW dw_kernel, dw_sum_kernel': DW_KERNELS,
                'K6 bias_kernel': ('bias_kernel',)}


def profile_step(step, state, batch, gen, groups):
    """Device time by kernel over one train step, and each group's share
    of it."""
    res = _profile('one train step', lambda: step(state, batch, gen), 15)
    if res is None:
        return
    events, dev = res
    for g, keys in groups.items():
        ms = sum(dev(e) for e in events if any(k in e.key for k in keys))
        print(f'  {g}: {ms:.3f} ms')


# ---- several ranks (ROADMAP A.7) --------------------------------------------

DIST_STEPS = 3          # dist_train: train steps of each form
DIST_RAYS = 2048        # dist_train: the global batch (the flagship's)
DIST_H = 512            # dist_render: the frame's side
DIST_TIMEOUT = 300      # seconds the spawned ranks of a phase may take
DIST_LOSS_RTOL = 1e-5   # two ranks' loss against one rank's
# the updates after DIST_STEPS steps, two ranks against one.  Each
# backward call rounds the weights' gradients to bf16 (the weights' dtype,
# anerf_tpu's ``gr.astype(d)``), so two ranks round two halves that one
# rank rounds as one sum; where the halves cancel, Adam's sign-like first
# steps turn that rounding into a whole step.  The pose bank's gradient
# takes no bf16 rounding (its update at cosine > 0.9999); the NeRF
# parameters' update is held at 0.999 (measured 0.99961 on an H100,
# beside 0.99993 for one rank on the same rays permuted, which moves only
# the f32 order of the sums)
DIST_UPD_COS_MIN = 0.9999
DIST_NERF_UPD_COS_MIN = 0.999


def _spawn_ranks(fn, world, *args):
    """``fn(rank, world, *args)`` in ``world`` spawned processes (each
    loads the kernels' libraries the parent built).  A rank that raises
    fails the call with its traceback, and one that outlives
    DIST_TIMEOUT seconds is killed and fails it; no process of the call
    outlives it."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(world,) + args, nprocs=world,
                             join=False, start_method='spawn')
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f'{fn.__name__}: the ranks did not end '
                                   f'within {DIST_TIMEOUT} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _dist_dir(name):
    """A fresh directory under WORK for a phase's store and results."""
    import tempfile
    os.makedirs(WORK, exist_ok=True)
    return tempfile.mkdtemp(prefix=name, dir=WORK)


def _cpu_state(x):
    import torch
    if isinstance(x, dict):
        return {k: _cpu_state(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_cpu_state(v) for v in x]
    return x.detach().cpu().clone() if torch.is_tensor(x) else x


def _flagship_dist(T, device, n_rays, **over):
    """The flagship setup, state and batch, with the pose optimizer
    firing every step (``opt_pose_step`` 1), so that the pose bank's
    reduced gradient moves it in every step; seed 1's weights, whose
    density is positive inside the subject's cylinder (seed 0's renders
    nothing, and its loss barely moves)."""
    setup, state, batch, _ = T.build_flagship(
        n_rays, device=device, compute_dtype='bfloat16', seed=1, **over)
    setup = dataclasses.replace(setup, cfg=dataclasses.replace(
        setup.cfg, opt_pose_step=1))
    return setup, state, batch


def _sync(device):
    import torch
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def _dist_rank_init(rank, world, store):
    import torch
    sys.path.insert(0, ROOT)
    from anerf_torch.parallel import sharding as S
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S.init_distributed(backend='gloo', init_method=f'file://{store}',
                       rank=rank, world_size=world)
    return S


def _dist_train_rank(rank, world, store, out, device, n_rays):
    """One rank of dist_train (b): the flagship's gradients on this
    rank's half of the ``n_rays`` batch, all-reduced, then DIST_STEPS
    steps of ``shard_train_step``, counted and timed."""
    import torch
    S = _dist_rank_init(rank, world, store)
    from anerf_torch import testing_utils as T
    from anerf_torch.ops import fused_encmlp as FE
    from anerf_torch.training import trainer as TT
    try:
        setup, state, batch = _flagship_dist(T, device, n_rays, perturb=0.,
                                             raw_noise_std=0.)
        mesh = S.make_mesh(world)
        # rank 0's state to every rank, as run_train starts (the same
        # bits here: gloo's broadcast on CUDA tensors)
        S.replicate_state(mesh, state)
        msetup = dataclasses.replace(setup, mesh=mesh)
        stats, g_nerf, g_pose = TT.loss_and_grads(
            msetup, state, S.shard_batch(mesh, batch))
        grads = [S.all_reduce_mean(mesh, g) for g in (g_nerf, g_pose)]
        loss0 = float(TT.reduce_stats(mesh, stats)['total_loss'])
        start = _cpu_state(state)
        step = S.shard_train_step(setup, mesh)
        FE.reset_launch_counts()
        losses, ms = [], []
        for _ in range(DIST_STEPS):
            _sync(device)
            t0 = time.perf_counter()
            state, st = step(state, batch, None)
            losses.append(float(st['total_loss']))
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = FE.launch_counts()
        # (d) DIST_STEPS steps bundled into one call (under gloo the
        # steps' body in turn) against as many eager sharded steps from
        # the same start, both under deterministic algorithms (the
        # gathers' backward atomics change bits from run to run)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            ref = _state_on(start, device)
            for _ in range(DIST_STEPS):
                ref, _ = step(ref, batch, None)
            bundle = S.shard_train_step(setup, mesh, stacked=True,
                                        steps=DIST_STEPS)
            stacked = {k: torch.stack([v] * DIST_STEPS)
                       for k, v in batch.items()}
            bundled = _state_on(start, device)
            FE.reset_launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            bundled, _ = bundle(bundled, stacked, None)
            _sync(device)
            bundle_ms = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
            bundle_counts = FE.launch_counts()
        finally:
            torch.use_deterministic_algorithms(False)
        bundle_same = all(torch.equal(a, b) for a, b in zip(
            TT._state_tensors(ref), TT._state_tensors(bundled))) and \
            ref['step'] == bundled['step']
    finally:
        torch.distributed.destroy_process_group()
    torch.save({'counts': counts, 'losses': losses, 'ms': ms,
                'loss0': loss0, 'grads': _cpu_state(grads), 'start': start,
                'state': _cpu_state(state), 'bundle_same': bundle_same,
                'bundle_counts': bundle_counts, 'bundle_ms': bundle_ms,
                'bundle_state': _cpu_state(bundled)},
               os.path.join(out, f'rank{rank}.pt'))


def _state_on(x, device):
    """A copy of a train state (nested dicts and lists) on ``device``."""
    import torch
    if isinstance(x, dict):
        return {k: _state_on(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_state_on(v, device) for v in x]
    return x.to(device, copy=True) if torch.is_tensor(x) else x


def _flat_tree(leaves):
    import torch
    return torch.cat([t.double().reshape(-1) for t in leaves])


def dist_train_phase(FE, T, device, gpu_line, backend='nccl'):
    """Training over several ranks: (a) a world of one under NCCL in
    this process, DIST_STEPS flagship steps through ``shard_train_step``
    bit-identical to ``make_train_step``'s (both under deterministic
    algorithms, the gathers' backward atomics included; the plain step
    run twice shows that the bar can hold); (b) two gloo ranks in
    spawned processes, both on this card, on the flagship at full width
    without draws: the 2048-ray batch split 1024/1024 against the
    one-rank step on the same rays (the loss within DIST_LOSS_RTOL, each
    tree's all-reduced gradient at the backward bars, the updates after
    DIST_STEPS steps at DIST_NERF_UPD_COS_MIN for the NeRF parameters
    and DIST_UPD_COS_MIN for the pose bank, each printed beside one rank
    on the same rays permuted, the ranks' states bit-equal),
    K1-K4, K-vf1 and K-vf2 counted on each rank; (c) bundles in (a)'s
    world (``dist_bundle_nccl``); (d) a bundle on each of (b)'s ranks
    bit-equal to its eager sharded steps.  Returns the two ranks' launch
    counts of (b) and of (d), each summed.  (``backend='gloo'``
    rehearses (a) and (c) on the CPU.)"""
    import torch
    import torch.distributed as dist
    from anerf_torch.parallel import sharding as S
    from anerf_torch.training.trainer import _state_tensors, make_train_step

    # (a) NCCL, a world of one
    work = _dist_dir('dist_train_a')
    S.init_distributed(backend=backend,
                       init_method=f'file://{work}/store', rank=0,
                       world_size=1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        setup, state, batch = _flagship_dist(T, device, DIST_RAYS)
        mesh = S.make_mesh(1)
        S.replicate_state(mesh, state)
        runs, ms = {}, {}
        for name, step in (('plain', make_train_step(setup)),
                           ('plain again', make_train_step(setup)),
                           ('sharded', S.shard_train_step(setup, mesh))):
            st = _clone_state(state)
            gen = torch.Generator(device=device).manual_seed(0)
            FE.reset_launch_counts()
            runs[name] = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DIST_STEPS):
                st, _ = step(st, batch, gen)
                runs[name].append(_state_tensors(_clone_state(st)))
            torch.cuda.synchronize()
            ms[name] = (time.perf_counter() - t0) * 1e3 / DIST_STEPS
            counts = FE.launch_counts()
        dist_bundle_nccl(FE, device, gpu_line, setup, state, batch, mesh,
                         backend)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    same = lambda a, b: all(torch.equal(x, y) for s, t in zip(a, b)
                            for x, y in zip(s, t))
    expect = {k: 0 for k in counts}
    expect.update({k: DIST_STEPS * n for k, n in FLAGSHIP_STEP.items()})
    print(f'dist_train (a): {backend} world of one, {DIST_STEPS} flagship '
          f'steps: '
          f'shard_train_step bit-identical to make_train_step '
          f'{same(runs["plain"], runs["sharded"])}, make_train_step to '
          f'itself {same(runs["plain"], runs["plain again"])}; launches '
          f'{counts}; ms/step ' + ', '.join(f'{k} {v:.2f}'
                                            for k, v in ms.items())
          + f' (deterministic algorithms; {gpu_line})')
    if not same(runs['plain'], runs['sharded']):
        raise AssertionError('a world of one through shard_train_step is '
                             'not bit-identical to make_train_step')
    if counts != expect:
        raise AssertionError(f'launch counts {counts}, expected {expect}')

    # (b) two gloo ranks on this card
    work = _dist_dir('dist_train_b')
    t0 = time.perf_counter()
    _spawn_ranks(_dist_train_rank, 2, f'{work}/store', work, str(device),
                 DIST_RAYS)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f'rank{r}.pt'),
                        weights_only=False) for r in range(2)]
    from anerf_torch.training import trainer as TT
    setup, state, batch = _flagship_dist(T, device, DIST_RAYS, perturb=0.,
                                         raw_noise_std=0.)
    stats, g_nerf, g_pose = TT.loss_and_grads(setup, state, batch)
    start = _cpu_state(state)
    step = make_train_step(setup)
    losses, one_ms = [], []
    for _ in range(DIST_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, st = step(state, batch, None)
        losses.append(float(st['total_loss']))
        one_ms.append((time.perf_counter() - t1) * 1e3)
    end = _cpu_state(state)
    # beside it: the same one-rank steps on the batch with its rays
    # permuted, the same sums in another f32 order and no ranks
    perm = torch.randperm(DIST_RAYS, generator=torch.Generator().manual_seed(
        0)).to(device)
    swap = {k: v[perm] for k, v in batch.items()}
    setup, state, _ = _flagship_dist(T, device, DIST_RAYS, perturb=0.,
                                     raw_noise_std=0.)
    step = make_train_step(setup)
    for _ in range(DIST_STEPS):
        state, _ = step(state, swap, None)
    floor = _cpu_state(state)
    r0 = ranks[0]
    if not all(torch.equal(a, b) for a, b in zip(
            _state_tensors(r0['state']), _state_tensors(ranks[1]['state']))):
        raise AssertionError('the two ranks\' states differ')
    for r, res in enumerate(ranks):
        want = {k: 0 for k in res['counts']}
        want.update({k: DIST_STEPS * n for k, n in FLAGSHIP_STEP.items()})
        if res['counts'] != want:
            raise AssertionError(f'rank {r}: launch counts {res["counts"]}, '
                                 f'expected {want}')
    for name, ref, got in (('NeRF', g_nerf, r0['grads'][0]),
                           ('pose', g_pose, r0['grads'][1])):
        cos, ratio, _, _ = _cmp(_flat_tree(ref).cpu(), _flat_tree(got))
        print(f'  dist_train (b) {name} gradient, all-reduced against one '
              f'rank: cos {cos:.9f} ratio {ratio:.9f}')
        if cos < BWD_COS_MIN or abs(ratio - 1) > BWD_RATIO_TOL:
            raise AssertionError(f'dist_train: the {name} gradient disagrees')
    for name, bar in (('params', DIST_NERF_UPD_COS_MIN),
                      ('pose_params', DIST_UPD_COS_MIN),
                      ('opt_state', None), ('pose_opt_state', None)):
        upd = [_flat_tree(_state_tensors({name: e[name]})) -
               _flat_tree(_state_tensors({name: s[name]}))
               for s, e in ((start, end), (r0['start'], r0['state']),
                            (start, floor))]
        cos, ratio, _, _ = _cmp(upd[0], upd[1])
        fcos, fratio, _, _ = _cmp(upd[0], upd[2])
        print(f'  dist_train (b) {name} update after {DIST_STEPS} steps: '
              f'cos {cos:.7f} ratio {ratio:.6f}'
              + (f' (bar {bar})' if bar else ' (not held)')
              + f'; one rank on the permuted rays cos {fcos:.7f} ratio '
              f'{fratio:.6f}')
        if bar and cos < bar:
            raise AssertionError(f'dist_train: the {name} update disagrees')
    # the loss of one step on the same state and rays (in the step and
    # from loss_and_grads); the later steps' start from states that
    # differ where Adam's first steps turn a gradient at noise level into
    # a whole step, which the update bars above hold
    pairs = [('loss before', float(stats['total_loss']), r0['loss0'])] + [
        (f'loss step {i}', a, b) for i, (a, b) in enumerate(
            zip(losses, r0['losses']))]
    for what, a, b in pairs:
        held = what in ('loss before', 'loss step 0')
        print(f'  dist_train (b) {what}: one rank {a:.7f}, two ranks '
              f'{b:.7f}, rel {abs(a - b) / abs(a):.2e}'
              + ('' if held else ' (not held: the states differ)'))
        if held and abs(a - b) > DIST_LOSS_RTOL * abs(a):
            raise AssertionError(f'dist_train: {what} disagrees')
    print(f'dist_train (b): two gloo ranks on one card, {DIST_RAYS // 2} '
          f'rays each, '
          f'ms/step by rank ' + '; '.join(
              ', '.join(f'{m:.1f}' for m in res['ms']) for res in ranks)
          + f', one rank on {DIST_RAYS} rays '
          + ', '.join(f'{m:.1f}' for m in one_ms)
          + f' (steps 1-{DIST_STEPS}, the first with its warm-up); the two '
          f'ranks share the card, so this is no scaling number; the spawn '
          f'took {spawn_s:.1f} s; the ranks\' states bit-equal; launches a '
          f'rank {r0["counts"]} ({gpu_line})')
    for r, res in enumerate(ranks):
        want = {k: 0 for k in res['bundle_counts']}
        want.update({k: DIST_STEPS * n for k, n in FLAGSHIP_STEP.items()})
        if not res['bundle_same']:
            raise AssertionError(f'rank {r}: the bundle is not bit-equal to '
                                 f'{DIST_STEPS} eager sharded steps')
        if res['bundle_counts'] != want:
            raise AssertionError(f'rank {r}: bundle launch counts '
                                 f'{res["bundle_counts"]}, expected {want}')
    if not all(torch.equal(a, b) for a, b in zip(
            _state_tensors(r0['bundle_state']),
            _state_tensors(ranks[1]['bundle_state']))):
        raise AssertionError('the two ranks\' bundles differ')
    print(f'dist_train (d): two gloo ranks, a bundle of {DIST_STEPS} steps '
          f'each (the steps\' body in turn: gloo cannot be captured) '
          f'bit-equal to {DIST_STEPS} eager sharded steps on each rank, the '
          f'ranks\' bundles bit-equal; launches a rank '
          f'{r0["bundle_counts"]}; ms/step by rank ' + ', '.join(
              f'{res["bundle_ms"]:.1f}' for res in ranks)
          + f' (deterministic algorithms; {gpu_line})')
    total = lambda key: {k: sum(res[key][k] for res in ranks)
                         for k in r0[key]}
    return total('counts'), total('bundle_counts')


def dist_bundle_nccl(FE, device, gpu_line, setup, state, batch, mesh,
                     backend):
    """dist_train (c), in (a)'s world of one under deterministic
    algorithms: bundles of DIST_STEPS steps through ``shard_train_step(
    ..., stacked=True)`` (the first call warms up and captures the step,
    its collectives in the graph; every later step replays it), three
    calls each bit-identical to as many eager sharded steps drawing from
    a generator seeded alike; one eager step and one replayed bundle
    profiled: K1-K4, K-vf1 and K-vf2 DIST_STEPS times their count a
    step, the NCCL kernels DIST_STEPS times the eager step's; then, with
    deterministic algorithms off, the bundle's ms/step in turns with the
    plain bundle's (``make_multi_train_step`` of the setup without a
    group: no collectives), TIMING_WINDOWS calls each."""
    import torch
    from anerf_torch.parallel import sharding as S
    from anerf_torch.training import trainer as TT
    from torch.profiler import ProfilerActivity, profile
    K = DIST_STEPS
    stacked = {k: torch.stack([v] * K) for k, v in batch.items()}
    eager = S.shard_train_step(setup, mesh)
    bundle = S.shard_train_step(setup, mesh, stacked=True, steps=K)
    ref, st = _clone_state(state), _clone_state(state)
    g_ref = torch.Generator(device=device).manual_seed(0)
    g_st = torch.Generator(device=device).manual_seed(0)
    same = []
    for _ in range(3):
        for _ in range(K):
            ref, _ = eager(ref, batch, g_ref)
        st, _ = bundle(st, stacked, g_st)
        same.append(ref['step'] == st['step'] and all(
            torch.equal(a, b) for a, b in zip(TT._state_tensors(ref),
                                              TT._state_tensors(st))))
    launches, nccl = {}, {}
    for mode in ('eager', 'bundle'):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if mode == 'eager':
                ref, _ = eager(ref, batch, g_ref)
            else:
                st, _ = bundle(st, stacked, g_st)
            torch.cuda.synchronize()
        events = prof.key_averages()
        launches[mode] = {k: _kernel_launches(events, kern)
                          for k, (kern, _) in BUNDLE_K1_K4.items()}
        nccl[mode] = {e.key: e.count for e in events
                      if _device_ms(e) > 0
                      and str(e.device_type).endswith('CUDA')
                      and 'nccl' in e.key.lower()}
    want = {k: K * n for k, (_, n) in BUNDLE_K1_K4.items()}
    n_eager, n_bundle = (sum(nccl[m].values()) for m in ('eager', 'bundle'))
    print(f'dist_train (c): {backend} world of one, bundles of {K} steps '
          f'through shard_train_step(stacked=True), three calls '
          f'bit-identical to {K} eager sharded steps each: {same}; one '
          f'replayed bundle launched {launches["bundle"]} (expected '
          f'{want}) and NCCL kernels {nccl["bundle"]} ({n_bundle}; one '
          f'eager step {nccl["eager"]}, {n_eager}) (deterministic '
          f'algorithms; {gpu_line})')
    if not all(same):
        raise AssertionError('the NCCL bundle is not bit-identical to the '
                             'eager sharded steps')
    if launches['bundle'] != want or n_bundle != K * n_eager:
        raise AssertionError(f'bundle launches {launches["bundle"]}, NCCL '
                             f'{n_bundle}; expected {want}, {K * n_eager}')
    del ref, st, eager, bundle
    torch.use_deterministic_algorithms(False)
    runs = {'sharded': S.shard_train_step(setup, mesh, stacked=True,
                                          steps=K),
            'plain': TT.make_multi_train_step(setup, K)}
    states = {k: _clone_state(state) for k in runs}
    gens = {k: torch.Generator(device=device).manual_seed(0) for k in runs}
    for k, run in runs.items():         # warm-up and capture
        states[k], _ = run(states[k], stacked, gens[k])
    ms = {k: [] for k in runs}
    for _ in range(TIMING_WINDOWS):
        for k, run in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[k], _ = run(states[k], stacked, gens[k])
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3 / K)
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f'dist_train (c): bundled ms/step, {TIMING_WINDOWS} calls of {K} '
          f'steps each in turns: sharded (collectives captured) '
          f'{med["sharded"]:.3f} (' + ', '.join(
              f'{x:.3f}' for x in ms['sharded']) + f'), plain '
          f'{med["plain"]:.3f} (' + ', '.join(f'{x:.3f}' for x in ms['plain'])
          + f'); medians ({gpu_line})')


def _dist_render_rank(rank, world, store, out, device, H):
    """One rank of dist_render: its blocks of one H x H bullet frame's
    4096-ray chunks, counted and timed after a warm-up render."""
    import torch
    S = _dist_rank_init(rank, world, store)
    from anerf_torch import testing_utils as T
    from anerf_torch.ops import fused_encmlp as FE
    try:
        renderer, rd = _dist_renderer(T, device, H, S.make_mesh(world))
        n_chunks = 0
        inner = renderer._render_chunk

        def counted(*args):
            nonlocal n_chunks
            n_chunks += 1
            return inner(*args)

        renderer._render_chunk = counted
        renderer.render_path(rd)        # warm-up: cuBLAS, allocator
        _sync(device)
        n_chunks = 0
        FE.reset_launch_counts()
        t0 = time.perf_counter()
        frame = renderer.render_path(rd)
        _sync(device)
        s = time.perf_counter() - t0
        counts = FE.launch_counts()
    finally:
        torch.distributed.destroy_process_group()
    torch.save({'frame': frame, 'counts': counts, 'n_chunks': n_chunks,
                's': s}, os.path.join(out, f'rank{rank}.pt'))


def _dist_renderer(T, device, H, mesh=None):
    """The render path phase's renderer (seed 1's weights, chunk 4096)
    over ``mesh``, and one H x H bullet frame."""
    import torch
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            embed_state,
                                            init_raycaster_params)
    from anerf_torch.render.renderer import ImageRenderer
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), device)
    rd, _ = _bullet_data(T, 1, H)
    return ImageRenderer(rc, params, embed_state(cfg, rc, 10000),
                         chunk=4096, near=0., far=1., device=device,
                         mesh=mesh), rd


def dist_render_phase(FE, T, device, gpu_line):
    """Rendering over two gloo ranks on this card: one DIST_H x DIST_H
    (512 x 512) bullet frame at chunk 4096 (2048 rays a rank a chunk),
    K1 and K2 once a chunk on each rank, the ranks' frames bit-equal
    and within MAP_TOL of the frame's max of the one-rank frame (whether
    bit-equal is printed).  Returns the two ranks' launch counts,
    summed."""
    import numpy as np
    import torch
    work = _dist_dir('dist_render')
    t0 = time.perf_counter()
    _spawn_ranks(_dist_render_rank, 2, f'{work}/store', work, str(device),
                 DIST_H)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f'rank{r}.pt'),
                        weights_only=False) for r in range(2)]
    renderer, rd = _dist_renderer(T, device, DIST_H)
    renderer.render_path(rd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = renderer.render_path(rd)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        want = {k: 0 for k in res['counts']}
        want.update(encmlp_fwd=res['n_chunks'],
                    encmlp_dual_fwd=res['n_chunks'])
        if res['counts'] != want or res['n_chunks'] == 0:
            raise AssertionError(f'rank {r}: launch counts {res["counts"]}, '
                                 f'expected {want}')
    f0, f1 = ranks[0]['frame'], ranks[1]['frame']
    if not all(np.array_equal(f0[k], f1[k]) for k in ('rgbs', 'disps',
                                                      'accs')):
        raise AssertionError('the two ranks\' frames differ')
    if one['accs'].max() < 0.5:
        raise AssertionError('an empty frame: the check would be vacuous')
    bits = {k: bool(np.array_equal(one[k], f0[k]))
            for k in ('rgbs', 'disps', 'accs')}
    _maps_close('dist_render two ranks vs one', one, f0)
    print(f'dist_render: one {DIST_H}x{DIST_H} frame, '
          f'{ranks[0]["n_chunks"]} chunks '
          f'of 4096 rays, 2048 a rank; bit-equal to one rank {bits}; '
          f'launches a rank {ranks[0]["counts"]}; s/frame by rank '
          f'{ranks[0]["s"]:.3f}, {ranks[1]["s"]:.3f}, one rank {one_s:.3f}: '
          f'the two ranks share the card, so this is no scaling number; '
          f'the spawn took {spawn_s:.1f} s ({gpu_line})')
    return {k: sum(res['counts'][k] for res in ranks)
            for k in ranks[0]['counts']}


# ---- the offline tools (ROADMAP A.8) ----------------------------------------

OFFLINE_FRAMES = (4, 256, 256)  # the segmentation phase's frames
OFFLINE_MARGIN = 1e-3   # least top-2 logit gap of every pixel's colour
OFFLINE_POSES = 64      # poses scored through the FK source
OFFLINE_RTOL = 1e-5     # the card's pose metrics against the CPU's


def offline_phase(device, gpu_line):
    """The offline tools' device paths: (1) a small segmentation net
    scripted here with ``torch.jit.script`` (two 1x1 convolutions, so a
    pixel's logits depend on its colour alone; random weights from a
    seeded generator; frames of blocks of six colours, each colour's
    top-2 logit gap at least OFFLINE_MARGIN on the CPU, so that argmax
    has no ties) run through ``data.mask_extract.torchscript_seg_fn`` on
    the card and on the CPU: the labels and ``segment_person``'s masks
    equal; (2) ``eval.metrics.pose_metrics_from_smpl_params``' FK source
    on the card against the CPU within OFFLINE_RTOL.  Imports no cv2,
    imageio or h5py (the card's machine has none of them)."""
    import numpy as np
    import torch
    from anerf_torch.data.mask_extract import (segment_person,
                                               torchscript_seg_fn)
    from anerf_torch.eval.metrics import pose_metrics_from_smpl_params
    from anerf_torch.ops.fk import fk
    from anerf_torch.skeleton import SMPL_REST_POSE

    class Seg(torch.nn.Module):
        def __init__(self, g: torch.Generator):
            super().__init__()
            self.a = torch.nn.Conv2d(3, 16, 1)
            self.b = torch.nn.Conv2d(16, 21, 1)
            with torch.no_grad():
                for t in (self.a.weight, self.a.bias, self.b.weight,
                          self.b.bias):
                    t.copy_(torch.randn(t.shape, generator=g))

        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return self.b(torch.relu(self.a(x)))

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, 'seg.ts')
    torch.jit.script(Seg(torch.Generator().manual_seed(0))).save(path)
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (6, 3), dtype=np.uint8)
    n, H, W = OFFLINE_FRAMES
    blocks = rng.integers(0, 6, (n, H // 32, W // 32))
    imgs = palette[blocks.repeat(32, 1).repeat(32, 2)]
    # every colour's logits on the CPU: the top-2 gap
    logits = torch.jit.load(path)(torch.from_numpy(
        ((palette[None, None].astype(np.float32) / 255. - [0.485, 0.456,
         0.406]) / [0.229, 0.224, 0.225]).astype(np.float32).transpose(
            0, 3, 1, 2)))[0, :, 0]
    top2 = logits.topk(2, dim=0).values
    margin = float((top2[0] - top2[1]).min().detach())
    if margin < OFFLINE_MARGIN:
        raise AssertionError(f'offline: a colour\'s top-2 logit gap is '
                             f'{margin}, under {OFFLINE_MARGIN}')
    devices = {'card': device, 'cpu': 'cpu'}
    times, labels, masks = {}, {}, {}
    for k, dev in devices.items():
        fn = torchscript_seg_fn(path, device=dev)
        fn(imgs[:1])                    # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        labels[k] = fn(imgs)
        times[k] = (time.perf_counter() - t0) * 1e3
    got, ref = labels['card'], labels['cpu']
    person = int(ref.reshape(-1)[0])
    for k in devices:
        masks[k] = segment_person(imgs, lambda _, v=labels[k]: v, person)
    n_labels = len(np.unique(ref))
    same_masks = np.array_equal(masks['card'], masks['cpu'])
    print(f'offline: torchscript_seg_fn on {n} frames of {H}x{W}: labels '
          f'equal to the CPU\'s {np.array_equal(got, ref)} ({n_labels} '
          f'labels; least top-2 logit gap {margin:.4f}), person masks '
          f'equal {same_masks}; ms ' + ', '.join(
              f'{k} {v:.1f}' for k, v in times.items()) + f' ({gpu_line})')
    if not np.array_equal(got, ref) or not same_masks or n_labels < 2:
        raise AssertionError('offline: the card\'s labels differ from the '
                             'CPU\'s, or hold one label')

    rng = np.random.default_rng(1)
    bones = rng.normal(scale=0.3, size=(OFFLINE_POSES, 24, 3))
    pelvis = rng.normal(scale=0.1, size=(OFFLINE_POSES, 3))
    rest = SMPL_REST_POSE           # metres, scored in mm
    # the ground truth: FK of the poses with noise added, on the CPU
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
    gt_kps = fk(f32(bones + rng.normal(scale=0.05, size=bones.shape)),
                f32(pelvis), f32(rest))[0].numpy()
    a, b = (pose_metrics_from_smpl_params(gt_kps, bones=bones, pelvis=pelvis,
                                          rest_pose=rest, device=dev)
            for dev in devices.values())
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b)
    print(f'offline: pose_metrics_from_smpl_params (FK source) on '
          f'{OFFLINE_POSES} poses, {device} {a} against cpu {b}: worst '
          f'relative difference {worst:.2e} (bar {OFFLINE_RTOL})')
    if worst > OFFLINE_RTOL or not 0 < b['mpjpe']:
        raise AssertionError('offline: the card\'s pose metrics differ')


class PhaseClock:
    """Host seconds of each phase, printed as it ends, so that the run
    can be kept inside its time limit."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def mark(self, name):
        now = time.perf_counter()
        print(f'[phase {name}: {now - self.last:.1f} s, '
              f'{now - self.t0:.1f} s in all]', flush=True)
        self.last = now


def _shape_entry(row, shape, paths, shape_counts, name):
    """A kernel row of the encmlp_shapes phase as an entry of its
    kernel's ``enc_shapes``: its numbers and the launches of the path
    that runs its shape (surreal_single's train steps for its one view
    row, else that shape's calls in the phase)."""
    entry = {f: row[f] for f in (
        'ms', 'wrapper_ms', 'plain_ms', 'bound_ms', 'bound_by',
        'max_abs_err', 'library_ms', 'shape', 'points', 'viewfac', 'label',
        'passes_ms')
        if f in row}
    if shape == ENC_SINGLE:
        return dict(entry, launches=paths['single_train'][name],
                    launches_path='single_train')
    return dict(entry, launches=shape_counts[shape][name],
                launches_path=f'encmlp_shapes {shape}')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from anerf_torch import testing_utils as T
    from anerf_torch.interop import params_to
    from anerf_torch.models.factory import (build_raycast_config,
                                            init_raycaster_params)
    from anerf_torch.ops import fused_encmlp as FE
    from anerf_torch.ops import fused_mlp as FM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_line = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(gpu_line)
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {torch.cuda.get_device_name(0)}')
    net_builds = [(432, d, FM.kernel_static(FM.MLPStatic(
        d, w, (432,), (665,), w // 2, (4,))).width) for d, w in NET_SHAPES]
    # K5/K6 at the views widths past 672: VIEWS_WIDTHS' and the views
    # flagship's split route (1512 + 128 columns)
    net_builds += [(432, 8, over.get('netwidth', 256),
                    FM.views_pad(int(k.split('_')[0])))
                   for k, (_, over) in VIEWS_WIDTHS.items()]
    net_builds.append((432, 8, 256, FM.views_pad(1640)))
    # K5/K6 at the deep flagship's nets, its split route
    net_builds.append((432, DEEP_FLAGSHIP['netdepth'],
                       DEEP_FLAGSHIP['netwidth']))
    # K5/K6 past their former caps (ROADMAP C.16)
    net_builds += c16_builds(FM)
    # K1-K4 and K-vf1/K-vf2 at the encode shapes past the flagship's, and
    # at cli_views' (mixamo at 11 view rows and framecodes of 32)
    enc_builds = [enc_shape_key(FE, T, over)
                  for over, _, _ in ENC_SHAPES.values()]
    enc_builds.append(enc_shape_key(FE, T, CLI_VIEWS))
    enc_builds += [enc_shape_key(FE, T, o) for o in (DEEP_FLAGSHIP,
                                                     CLI_DEPTH)]
    build_s = FE.build_kernels(verbose=True,
                               trunk_widths=tuple(GRAMMAR_WIDTHS),
                               shapes=net_builds, enc_shapes=enc_builds,
                               view_shapes=VF_WIDTHS)
    print(f'kernel build: {build_s:.1f} s (encode shapes '
          f'{sorted(set(enc_builds))})')

    device = torch.device('cuda')
    cfg = T.surreal_config(compute_dtype='bfloat16')
    rc = build_raycast_config(cfg, n_framecodes=9)
    if rc.mlp_backend != 'fused':
        raise AssertionError(f'the recipe maps to {rc.mlp_backend!r}')
    # seed 1: its random density is positive inside the subject's
    # cylinder (seed 0's is negative everywhere and renders empty frames)
    params = params_to(init_raycaster_params(
        torch.Generator().manual_seed(1), rc, cfg), device)
    peaks = _peaks(torch.cuda.get_device_name(0))

    # the two-subject model (the subject channel on the views branch):
    # seed 4, whose fine net's random density is positive inside the
    # cylinder (seed 1's is not: the extra views row shifts its draws)
    rc2 = build_raycast_config(cfg, n_framecodes=9, n_subjects=2)
    params2 = params_to(init_raycaster_params(
        torch.Generator().manual_seed(4), rc2, cfg), device)

    clock = PhaseClock()
    rows = kernel_phase(FE, T, rc, cfg, params, peaks, device)
    clock.mark('kernel')
    rows += bwd_kernel_phase(FE, T, rc, cfg, params, peaks, device)
    clock.mark('bwd_kernel')
    vf_rows, vf_times = viewfac_phase(FE, T, rc, cfg, params, peaks, device,
                                      gpu_line)
    for row in rows:
        if row['name'] in vf_times:
            row['viewfac_vs_dense'] = vf_times[row['name']]
    rows += vf_rows
    clock.mark('viewfac')
    tf_rows, paths_tf, render_tf, tf_times = fuse_tform_phase(
        FE, T, rc, cfg, params, peaks, device, gpu_line)
    for row in tf_rows:
        row['fuse_tform_times'] = {k: v for k, v in tf_times.items()
                                   if k != 'step_check'}
    rows += tf_rows
    clock.mark('fuse_tform')
    shape_rows, shape_vf_rows, paths_shapes, shape_counts = \
        encmlp_shapes_phase(FE, T, peaks, device, gpu_line)
    clock.mark('encmlp_shapes')
    vfw_rows, vfw_counts = vf_widths_phase(FE, peaks, device)
    clock.mark('vf_widths')
    views_rows = views_kernel_phase(FM, T, peaks, device)
    clock.mark('views_kernel')
    rows += split_mlp_phase(FM, T, cfg, rc2, params2, peaks, device)
    clock.mark('split_mlp')
    grammar_rows = grammar_kernel_phase(FM, T, peaks, device)
    clock.mark('grammar_kernel')
    paths = {'render': path_phase(FE, T, rc, cfg, params, device, gpu_line,
                                  {'encmlp_fwd': 1, 'encmlp_dual_fwd': 1})}
    clock.mark('render')
    paths['train'] = train_phase(FE, T, device, gpu_line)
    clock.mark('train')
    paths['train_bundled'] = bundled_phase(FE, T, device, gpu_line,
                                           'train_bundled', BUNDLE_K1_K4,
                                           seed=1)
    clock.mark('train_bundled')
    paths['train_tf'] = paths_tf
    paths['render_tf'] = render_tf
    paths['train_bundled_tf'] = bundled_phase(
        FE, T, device, gpu_line, 'train_bundled_tf', BUNDLE_K1_K4_TF, seed=1,
        fuse_tform=True)
    clock.mark('train_bundled_tf')
    paths['ms_render'] = path_phase(FE, T, rc2, cfg, params2, device,
                                    gpu_line, {'mlp_fwd': 3}, n_bullet=1,
                                    what='multi-subject path')
    clock.mark('ms_render')
    paths['ms_train'] = ms_train_phase(FE, T, device, gpu_line)
    clock.mark('ms_train')
    paths['ms_bundled'] = bundled_phase(FE, T, device, gpu_line,
                                        'ms_bundled', BUNDLE_K5_K6,
                                        n_subjects=2, seed=4)
    clock.mark('ms_bundled')
    paths['single_train'] = single_net_phase(FE, T, device, gpu_line)
    clock.mark('single_train')
    paths['single_bundled'] = bundled_phase(
        FE, T, device, gpu_line, 'single_bundled', BUNDLE_SINGLE, seed=1,
        **_single_over()[1])
    clock.mark('single_bundled')
    single_times = single_timing(FE, T, device, gpu_line)
    clock.mark('single_timing')
    paths['wide_train'], wide_seed, wide_times = wide_flagship_phase(
        FE, T, device, gpu_line)
    clock.mark('wide_flagship')
    paths['wide_bundled'] = bundled_phase(
        FE, T, device, gpu_line, 'wide_bundled', BUNDLE_K1_K4,
        seed=wide_seed, **W512)
    clock.mark('wide_bundled')
    paths['views_train'], views_seed, views_times = wide_flagship_phase(
        FE, T, device, gpu_line, 'views_flagship', VIEWS10,
        'views flagship step (21 view rows, framecodes of 128)')
    clock.mark('views_flagship')
    paths['views_bundled'] = bundle_once(
        FE, T, device, gpu_line, 'views_bundled',
        {k: n for k, (_, n) in BUNDLE_K1_K4.items()}, seed=views_seed,
        **VIEWS10)
    clock.mark('views_bundled')
    paths['ms_views_train'], paths['ms_views_bundled'] = ms_views_phase(
        FE, T, device, gpu_line)
    clock.mark('ms_views')
    paths['flagship1024_train'], f1024_seed, f1024_times = \
        wide_flagship_phase(FE, T, device, gpu_line, 'flagship1024', W1024,
                            'flagship1024 step (8 x 1024)')
    clock.mark('flagship1024')
    paths['flagship1024_bundled'] = bundle_once(
        FE, T, device, gpu_line, 'flagship1024_bundled',
        {k: n for k, (_, n) in BUNDLE_K1_K4.items()}, seed=f1024_seed,
        **W1024)
    clock.mark('flagship1024_bundled')
    paths['kp_cap_render'], paths['kp_cap_train'] = kp_cap_phase(
        FE, T, device, gpu_line)
    clock.mark('kp_cap')
    paths['deep_flagship_train'], _, deep_times = wide_flagship_phase(
        FE, T, device, gpu_line, 'deep_flagship', DEEP_FLAGSHIP,
        'deep flagship step (24 x 512)', steps=1)
    clock.mark('deep_flagship')
    paths['vf_widths'] = vfw_counts
    paths['encmlp_shapes'] = paths_shapes
    paths['grammar_train'], paths['grammar_render'] = grammar_path_phase(
        FE, T, device, gpu_line)
    clock.mark('grammar_path')
    for name, counts in grammar_combos_phase(FE, T, device,
                                             gpu_line).items():
        paths[f'grammar_{name}'] = counts
    clock.mark('grammar_combos')
    net_rows, net_counts = net_shapes_phase(FE, FM, T, peaks, device,
                                            gpu_line)
    for key, counts in net_counts.items():
        paths[f'net_{key}'] = counts
    clock.mark('net_shapes')
    c16_rows, c16_counts = c16_shapes_phase(FE, FM, T, peaks, device,
                                            gpu_line)
    for key, counts in c16_counts.items():
        paths[f'c16_{key}'] = counts
    clock.mark('c16_shapes')
    import shutil
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        paths['cli_train'], cli_shapes, logdir, cli_rays_s = \
            cli_train_phase(FE, T, rc, cfg, params, peaks, device, gpu_line)
        clock.mark('cli_train')
        paths['cli_render'] = cli_render_phase(
            FE, logdir, os.path.join(logdir, 'ckpt_00000040.pt'), device,
            gpu_line)
        clock.mark('cli_render')
        paths['cli_flipflop'] = cli_flipflop_phase(FE, device, gpu_line)
        clock.mark('cli_flipflop')
        paths['cli_multisubject'] = cli_multisubject_phase(FE, device,
                                                           gpu_line)
        clock.mark('cli_multisubject')
        paths['cli_bundled'] = cli_bundled_phase(FE, device, gpu_line,
                                                 cli_rays_s)
        clock.mark('cli_bundled')
        paths['cli_net_width'] = cli_net_width_phase(FE, device, gpu_line,
                                                     bundled=True)
        clock.mark('cli_net_width')
        paths['cli_views'] = cli_net_width_phase(
            FE, device, gpu_line, 'cli_views', CLI_VIEWS, bundled=True)
        clock.mark('cli_views')
        paths['cli_net_depth'] = cli_net_width_phase(
            FE, device, gpu_line, 'cli_net_depth', CLI_DEPTH)
        clock.mark('cli_net_depth')
        paths['cli_fuse_tform'] = cli_fuse_tform_phase(FE, device, gpu_line)
        clock.mark('cli_fuse_tform')
        paths['dist_train'], paths['dist_bundled'] = dist_train_phase(
            FE, T, device, gpu_line)
        clock.mark('dist_train')
        paths['dist_render'] = dist_render_phase(FE, T, device, gpu_line)
        clock.mark('dist_render')
        offline_phase(device, gpu_line)
        clock.mark('offline')
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # each row's launches come from the path whose shapes it times: the
    # flagship train step for K1-K4, the multi-subject one for K5/K6;
    # K1-K4's cli_train_shape holds the CLI mixamo step's launches with
    # the times at its shapes
    main_path = {'mlp_fwd': 'ms_train', 'mlp_bwd': 'ms_train',
                 **{f'{k}_tf': 'train_tf' for k in (
                     'encmlp_fwd', 'encmlp_dual_fwd', 'encmlp_bwd',
                     'encmlp_dual_bwd')}}
    # K5/K6 at the grammar's trunk widths: the times at the train step's
    # coarse samples, the launches of the path that runs that width
    width_path = {117: 'grammar_querypts-axisang-relray',
                  1152: 'grammar_train', 1197: 'grammar_cat-reldir-world'}
    for row in rows:
        name = row['name']
        row['launches'] = paths[main_path.get(name, 'train')][name]
        if name in ('mlp_fwd', 'mlp_bwd'):
            k = name == 'mlp_bwd'
            row['trunk_widths'] = {
                str(dx): dict({f: r[k][f] for f in (
                    'ms', 'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err',
                    'passes_ms') if f in r[k]},
                    launches=paths[width_path[dx]][name],
                    launches_path=width_path[dx])
                for dx, r in grammar_rows.items()}
            # K5/K6 at the nets of the net_shapes phase: the times at the
            # train step's coarse samples, the launches of that net's
            # train steps
            row['net_shapes'] = {
                key: dict({f: r[k][f] for f in (
                    'ms', 'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err',
                    'passes_ms') if f in r[k]},
                    launches=paths[f'net_{key}'][name],
                    launches_path=f'net_{key}')
                for key, r in net_rows.items()}
            # K5/K6 past their former caps (C.16): each
            # shape's times, the launches of its counted checks
            row['c16_shapes'] = {
                key: dict({f: r[k][f] for f in (
                    'ms', 'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err',
                    'passes_ms', 'shape', 'points', 'workspace_bytes')
                    if f in r[k]},
                    launches=paths[f'c16_{key}'][name],
                    launches_path=f'c16_shapes {key}')
                for key, r in c16_rows.items()}
            # K5/K6 at the views widths past 672 (C.15): the times at the
            # train step's coarse samples, the launches of the two-subject
            # steps at 11 view rows for 809 columns, else of the phase's
            # counted checks (one at n=4104, one at n=131,072)
            row['views_widths'] = {
                key: dict({f: r[k][f] for f in (
                    'ms', 'plain_ms', 'bound_ms', 'bound_by', 'max_abs_err',
                    'passes_ms', 'views_width', 'shape') if f in r[k]},
                    **({'launches': paths['ms_views_train'][name],
                        'launches_path': 'ms_views_train'} if key == '809'
                       else {'launches': 2,
                             'launches_path': 'views_kernel'}))
                for key, r in views_rows.items()}
        if name in cli_shapes:
            row['cli_train_shape'] = dict(
                cli_shapes[name], launches=paths['cli_train'][name])
        # K1-K4 (and K-vf1/K-vf2) at the encode shapes past the
        # flagship's: each shape's times at its own build, the launches
        # of its path (surreal_single's train steps for its one view
        # row, else the shapes phase's counted calls)
        enc = {}
        for shape, by_kernel in shape_rows.items():
            for S, r in by_kernel.get(name, {}).items():
                enc[f'{shape} S={S}'] = _shape_entry(r, shape, paths,
                                                     shape_counts, name)
        for shape, vrs in shape_vf_rows.items():
            for r in vrs:
                if r['name'] == name:
                    enc[shape] = _shape_entry(r, shape, paths, shape_counts,
                                              name)
        for r in vfw_rows:   # K-vf1/K-vf2 at VF_WIDTHS
            if r['name'] == name:
                enc[r['label']] = dict(
                    {f: r[f] for f in ('ms', 'plain_ms', 'bound_ms',
                                       'bound_by', 'max_abs_err',
                                       'library_ms', 'label', 'passes_ms')
                     if f in r},
                    launches=vfw_counts[name], launches_path='vf_widths')
        if enc:
            row['enc_shapes'] = enc
        if name in SINGLE_STEP:
            row['surreal_single_times'] = single_times
        if name in FLAGSHIP_STEP:
            row['wide_flagship_times'] = wide_times
            row['views_flagship_times'] = views_times
            row['flagship1024_times'] = f1024_times
            row['deep_flagship_times'] = deep_times
        row['launches_by_path'] = {k: v[name] for k, v in paths.items()}
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

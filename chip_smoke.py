#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases knn,egcl,serve,bwd,train,fpfh,robust,cli,serve_extra,variants,
                                    multiway,tools,dist,point,extras,kitti]

Builds the CUDA kernels from `se3_equi_graph_registration_tpu_torch/csrc`
(one nvcc per source, in parallel) and holds each against its plain PyTorch
version on the card at the main paths' shapes. B1 packed, B1 exact (over a
window and over the whole cloud, at k <= 128 and at 128 < k <= 1024) and B4
each have a warp-a-query kernel on the paths and the thread-a-query kernel
kept to compare; the EGCL forward
and backward have, at C=32, a bf16 tensor-core tile kernel for fast mode
and an fp32 register-blocked tile kernel for accurate mode, each built a
second time for 32 < C <= 36 (KITTI's C=33, one head: zero pads), the bf16
one at 48 channels and the fp32 one at 36, and a SIMT kernel for the other
shapes that each tile kernel is also timed and held against; all are held
against their plain versions, and each pair is timed in the same run. Then
it drives the four main paths, each with the launch counters set to 0 just
before it and read just after (`--phases` runs a subset:
`knn` is the k-NN kernel checks alone, `egcl` the EGCL forward's, `bwd`
the EGCL backward's, for iterating on a kernel; with no argument
everything runs):
- serving at the full `fast_tpu_config` (N=2048, k=16, C=32, 3 layers, 4
  heads, top_k=128), seeded random weights: `Registrar.register` and
  `BatchingServer`, checked against the same Registrar on the CPU, every
  k-NN launch on the warp kernel; the engine's other configurations
  (exact and approx whole-cloud graphs, a window with exact keys), each
  k-NN launch on the exact warp kernel and every accurate EGCL launch on
  the fp32 tile kernel, and a profile of `register()` at `EngineConfig()`
  defaults (whole-cloud exact k-NN, accurate EGCL) at B=64 with its
  counters;
- training: `make_train_step` with Adam at B=64 (2 knn, 6 EGCL forward and
  6 EGCL backward launches per step, on the warp k-NN and the bf16 tile
  kernels in fast mode), an accurate step (fp32 tile kernels) checked
  against the same step on the CPU, fast-against-accurate gradients
  printed, and 3 steps at `EngineConfig()` defaults at B=64 (every EGCL
  launch on the fp32 tile kernels) with a profile;
- the checkpoint-free pipeline at full width (N=2048, k_normals 30, k_fpfh
  60, tile 128, window 768, chunked keys, top_m 512, 512 hypotheses, 5 IRLS
  and 10 ICP steps, quaternion Kabsch): `register_fpfh` at 4 branches and 1
  (2 chunked k-NN launches, all warp, and 2 SPFH per call, all on the
  packed-count kernel, no B1) against the same call on the CPU on a seeded
  bumpy surface pair (also at 60 ICP steps), then
  `register_fpfh_batch` at B=8 and 32, and a profile of one b=1 call; then
  `register_fpfh` at its defaults (knn_method='approx': 2 whole-cloud k-NN
  launches at k=60 on the exact warp kernel, no B4 or B5) at 4 branches
  against the CPU; then at k_fpfh=300, b=1, on the two routes that reach
  B1's exact keys beyond k=128: fused with exact keys over W=768 (2 k-NN
  launches on the large-k warp kernel and 2 SPFH) and at its defaults (2
  whole-cloud k-NN launches on it), each against the CPU and timed;
- the robust evaluation path (`robust`): a `.pth` written by the port's
  exporter from the seeded weights, loaded by
  `Registrar.from_checkpoint(robust=True)` on the card and on the CPU
  (spectral reweighting over the top 256, 5 IRLS steps, 'sharp' fusion);
  B=64 `make_pair_batch` requests at 70% and at 10% inliers, with
  `pose_error` and recall against the ground truth; a Registrar with 60
  ICP steps at each scale of the pyramid (0.1, 0.0) on 4 bumpy-surface
  pairs at N=2048 (~5 points an occupied 0.1 m cell); one fused
  `register_fpfh` over the same pyramid at 60 steps a scale. Each card
  call against the same call on the CPU, timed with CUDA events after a
  warm-up and profiled, its launches counted by kernel variant (2 warp k-NN
  and 6 bf16 tile EGCL a Registrar call; 2 warp B4 and 2 'redux' B5 a
  register_fpfh);
- the command-line entry point (`cli`), `train/cli.main` as a user calls
  it, at the 3dmatch and the kitti preset at full width (N=2048, k=16, 3
  layers, B=8; C=32 with 4 heads and top_k=128, C=33 with 1 head and
  top_k=2048), each on a dataset root in the reference's format written
  here from a seed by the port's `data/synthetic` archive writers (16
  train, 8 val, 8 test pairs of 5000 putative correspondences drawn by
  `make_raw_pair`; 3DMatch train pickles of torch tensors, KITTI at LiDAR
  scale with FPFH 33): `cli train` for one epoch (2 steps, a validation batch;
  the whole-cloud exact warp k-NN, B2 and B3 on the fp32 tile kernels,
  built at 32 channels for C=32 and at 36 for C=33), `cli export` (no
  launch) read
  back by `convert_reference_checkpoint`, `cli eval` on the card and with
  `--device cpu`, one step with `engine.remat=true` (B2 launched 12 times
  against 6), the same step on the CPU, and a step's time and profile. It runs with torch's default
  TF32 flags and restores the smoke's after;
- the rest of serving (`serve_extra`): (a) `register(clique_prefilter=True)`
  at `fast_tpu_config` on 2048 correspondences, 40% of them gross outliers,
  the exact clique timed on the host; (b) `register_raw` at the kitti
  preset's engine config (N=2048, C=33, 1 head, top_k=2048; the fp32 tile
  EGCL built at 36 channels)
  on a bumpy-surface pair of 20 000 points a cloud, without and with a
  0.03 m voxel, with the gather FPFH's card-vs-CPU divergence by stage
  printed (normals, the source pick, the bins); (c) the Registrar exported
  on the card at B=16, saved, and loaded in a fresh interpreter that
  imports torch and the port's op library only, its run-time launches
  counted (2 warp k-NN and 6 bf16 tile EGCL a call), run again with TF32 on
  globally, and the host time of a loaded call against eager `_apply` and
  `register()`; (d) the fused pipeline (chunked, W=768, N=2048, batch 8,
  SVD Kabsch) exported and loaded, 2 B4 and 2 B5 counted in the loaded
  call; (e) the host cost of a knn_window call through its custom op
  against the allocation and ctypes launch alone, over 1000 calls;
- the model variants (`variants`), at full width, each timed with CUDA
  events after a warm-up: (a) a 'cluster' Registrar (the reference
  checkpoints' edge orientation) from a `.pth` the port's exporter writes
  from the seeded weights, eval_fusion head, B=16 (2 whole-cloud warp k-NN
  and no EGCL kernel a call: the plain EGNN, as the JAX package routes
  'cluster'); (b) an 'invariant' Registrar, B=16, the same counts, and the
  rotation equivariance of its pose and its EGNN on the card; (c) 5 train
  steps at `fast_tpu_config(bf16_params=True)`, B=16 (2 packed warp k-NN,
  6 bf16 tile B2 and 6 bf16 tile B3 a step; bf16 live parameters within
  one bf16 ulp of their fp32 masters); (d) one train step with the PointNet
  encoder at `EngineConfig(use_pointnet=True)`, B=8 (2 whole-cloud warp
  k-NN, 6 fp32 tile B2 and B3);
- multiway registration (`multiway`), the offline path of
  examples/multiway_registration.py: (a) its scenario at its own knobs (6
  fragments of one bumpy terrain, 1024 points each, seed 0; 12 pairwise
  `register_fpfh` edges at knn_method='approx', top_m 256, trimmed ICP of
  15 steps, 2 whole-cloud exact warp k-NN an edge; one chain link
  corrupted by 5 deg / 30 cm; the robust pose graph, geman, 30 steps),
  the graph held within 0.5 deg / 1 cm of the truth; (b) the same scenario
  at N=2048 through the fused path (chunked, W=768: 2 warp B4 and 2
  'redux' B5 an edge), every edge's error printed, no truth gate (some
  closures fail at this N in the reference too); (c) `tools/multiway.
  optimize_logs` over `.log` files written and read back, card against
  CPU for (a) and (b), and `optimize_pose_graph` at V=60, E=180 (a 3DMatch
  scene's size), least squares and geman, card against CPU; (d) (b)'s
  poses as quaternion `.txt` files against ground-truth `.pkl` files from
  `data/preprocess/pairs` (the native FPFH on the card) through
  `tools/eval_files`; (e) times with CUDA events, best of 3 after a
  warm-up, of a pairwise `register_fpfh` at (a)'s and (b)'s knobs and of
  the pose graph at V=6 and V=60, on the card and on the CPU, and the
  launches of one pose-graph call;
- the tools that settle ROADMAP Queue C (`tools`): (a) the port's model
  trained 300 fast steps at `fast_tpu_config`, B=16, from the seeded init,
  once with the reference's 'dot' head and once with the 'cosine' head,
  the head's effective correspondence count 1/Σŵ² printed every 50 steps
  (live at >= 8); on each trained model the fast-against-accurate gradient
  table of `tools/grad_budget` at N=2048, B=8, over the train loss with
  packed and with exact keys on the fast side and over its
  well-conditioned terms (corr + sim + equi), against the reference's chip
  table (worst cosine 0.786, median relative L2 0.029); (b) `tools/scenario_table.run_scenario`
  at 20 seeds, N=1024, ransac with 4 branches, on the 60% and both 40% rows,
  at 'approx' (2 whole-cloud warp B1 a call) and fused with chunked keys at
  W=768 (2 warp B4, 2 'redux' B5 a call), the counts against the
  reference's; (c) the robust phase's ICP Registrar (60 point-ICP steps a
  scale over (0.1, 0.0), B=4) card vs CPU beside the card against itself
  with the source or the target one float32 ulp up or down (the spread of
  its five answers), and the CPU against itself with the source one ulp
  up;
- data parallelism (`dist`): a process group of one rank over NCCL (a tcp
  store on 127.0.0.1, the card) and a 'data' mesh over it:
  `Registrar.register` at `fast_tpu_config`, B=64, and a BatchingServer
  over the mesh Registrar; `register_fpfh_batch` at B=8, fused and chunked
  at W=768; 2 `fit` steps at B=16 at `fast_tpu_config` in accurate mode;
  each with and without the mesh; then the group is destroyed;
- point-axis sharding (`point`): the 2-axis train step of
  `parallel/point_sharding` in a one-rank NCCL group over a {data: 1,
  point: 1} mesh at BASELINE.json config 5's dense size (N=8192, B=2,
  k=16, C=32, 3 layers, 4 heads, top_k=128, accurate, the 'cosine' head):
  the all-gather regime against the same step on the CPU and against the
  unsharded `make_train_step` on the kernels, the halo regime (W=64, the
  ring's wrap-around a local copy at one rank) against its twin, and both
  steps timed;
- the rest of the JAX package (`extras`), at fast_tpu_config's sizes (B=16,
  N=2048, K=16, C=32, 3 layers): (a) the model zoo of `models/variants`
  (CleanEGNN, GCL, GCLrf, ClofGCL, EGCLVel, the SO(3) tensor-product
  layer) over B1's whole-cloud exact graph (1 warp launch), card vs CPU
  under fp32 matmuls and rotation equivariance on the card, then the
  legacy GCN (the dense [16, 2048, 2048] Gaussian adjacency, one
  GraphConvolution, pooling) card vs CPU at a gate that a TF32 einsum
  fails; (b) `utils/reversible.reversible_sequence` of 4 and 12 blocks of
  width-256 MLPs over [32768, 256] streams against the plain composition:
  gradients, the inverse, peak memory and time; (c) the SO(3) basis in
  float64 (SH l ≤ 3 and `get_basis` at max_degree 2 over 2048·16 edge
  directions) card vs CPU and its identities on the card; (d) the example
  twins as users call them: `register_pair` at N=2048, fast and --robust
  (2 warp B1, 6 bf16 tile B2 each), `global_registration` at its default,
  at --overlap 0.4 (2 whole-cloud warp B1 each) and with the fused knobs
  (2 warp B4, 2 'redux' B5), `denoise` for 50 steps at n=2048, k=16 (the
  plain EGNN and k-NN: no kernel), and the `multihost_train` worker in a
  one-rank NCCL group (N=2048, 16 pairs, 2 epochs: 4 warp B1, 12 fp32 tile
  B2 and 12 B3);
- KITTI's width in fast mode (`kitti`; N=2048, C=33, 1 head, top_k=2048,
  3 layers, on the bf16 tile kernels built at 48 channels): (a) a `.pth`
  the port's exporter writes from seeded weights, served as README.md
  shows by `Registrar.from_checkpoint(path, robust=True)` on the card and
  on the CPU: `register()` at B=16 and 64 (2 warp B1 and 6 B2 a call),
  `register_raw` on a 20 000-point bumpy-surface pair (3 warp B1, 6 B2);
  (b) one fast train step at B=8 (2 warp B1, 6 B2 and 6 B3), card against
  CPU on the same batch and weights, then 5 timed steps and a profile.
Any failed check raises (non-zero exit, no result line). The last line is
one JSON object with the device.

Tolerances (kernel vs its plain version, same inputs, on the card):
- knn, B1 packed (k=16/W=384 and k=60/W=768), B4 (k=60/W=768), B1 exact
  (k=16/W=384, and the whole cloud of N=2048 at k=16 and k=60; k=300 at
  W=768 and over the whole cloud on the large-k warp kernel, the thread
  kernel in blocks of 64 queries beside it), at B=64 and at one cloud,
  and the CPU emulation's edge cases at small size and more (k up to the
  large-k kernel's 1024, where the thread kernel, which stops near 840,
  is left out): the warp kernel, the thread kernel and the plain version
  give identical lists (the same keys from the same round-to-nearest d²:
  unique within a query in packed mode, ties to the lower id in exact
  mode).
- egcl, h′: max |Δ| ≤ tol · max|ref h′|; coordinates through their update
  u = x′ − x: max |Δu| ≤ tol · max|ref u| + ε₃₂ · max|x|, the last term
  being the fp32 spacing at which x′ = x + u can be read back. The update
  is ~4e-3 against |x| ~1.5 at the served weights, so a check on x′ itself
  would pass a kernel that left the coordinates unchanged.
- egcl accurate: tol 1e-4 (fp32; only summation order differs: sequential
  FMAs against cuBLAS; measured 2.4e-7 on h′ for SIMT, 3.5e-7 for the fp32
  tile kernel, whose SiLU runs on the fast exponential and divide); the
  fp32 tile kernel in every case (K=7, 12, 16, 20, head widths 1, 8 and 32,
  repeated and collinear points, B=1, with and without agg_m); fp32 tile
  against SIMT at twice the tolerance. The same at C=33 with one head on
  the kernel built at 36 channels (K=7, 16, 20, repeated points, B=1, with
  and without agg_m), against SIMT and timed beside it at B=8 and B=64.
- egcl fast: tol 2e-2 on h′ and 1e-2 on u (measured 2.2e-3 on h′ and
  5.5e-4 on u at C=32): both round the same operands to bf16, but a sum that
  differs in its last fp32 bit can round to the next bf16 value (2⁻⁸
  relative), and that propagates. At C=33 on the bf16 tile kernel built at
  48 channels the same, with its stages and agg_m, in the cases of the
  fp32 kernel at C=33 and with three heads of 11 (heads that straddle the
  16-channel k-steps); against SIMT at twice the tolerances, both timed at
  B=8 and B=64.
- register() card vs CPU: ‖ΔR‖_F/√2 ≤ 2e-3, |Δt| ≤ 2e-3 m, covariance and
  similarity mean within 2e-2 relative (fast mode on both sides). The
  robust phase holds its three cases at the same gate (the fused
  register_fpfh at its R and t part).
- egcl agg_m output: as h′ (1e-4 accurate, 2e-2 fast, of its scale).
- egcl tile kernel: one bare mma tile against a matrix product of the same
  bf16 values, 1e-5 of its scale (fp32 sums in another order); its per-edge
  stages s1 and m against the plain version's as h′ (2e-2 of the scale);
  the layer as egcl fast, in every case (K=12, 16, 20, head widths 8 and
  32, repeated points, B=1, with and without agg_m); tile against SIMT (the
  same function in two orders of summation) at twice the fast tolerances.
- egcl_backward, dh, dx and each of the 11 parameter gradients, relative
  to the tensor's max-abs scale: accurate 1e-4 (fp32; the neighbor and
  parameter sums are atomic, so their order changes from run to run, and
  a parameter gradient sums 2.1 M edges; measured ≤ 3.1e-6); fast 5e-3
  (a sum that differs in its last fp32 bit can round an operand to the
  next bf16 value, 2⁻⁸ relative, as in the forward; measured ≤ 2e-4).
  The fp32 tile backward in the forward's cases and on the coordinate path
  at B=8, and against SIMT at twice the tolerance; at C=33 with one head
  on the kernel built at 36 channels the same (the C=33 forward's cases
  and the coordinate path), timed beside SIMT at B=8 and B=64.
  Two cases in each mode: random dagg_m and dagg_x at the seeded weights,
  and the coordinate path alone (dagg_m = 0, the coord output drawn at
  O(1/√C) instead of the init's 1e-3 gain). At the seeded weights the
  terms through the coordinate MLP (dm += Wc0ᵀ·dcm_in, drel += dax·scale)
  move every tensor by 1e-5 to 4e-4 of its scale, under the tolerances; in
  the second case they carry all of it. Fast mode holds both kernels in
  both cases.
- egcl_backward tile kernel: one bare transposed-operand product (Dᵀ·A over
  16 edges, as the parameter gradients run it) against a matrix product of
  the same bf16 values, 1e-5 of its scale; its per-edge cotangents dcm_in,
  dv and du against the plain version's at 2e-2 of the scale, as the
  forward's stages (measured ≤ 8.3e-4 in the CPU emulation); the backward
  at fast 5e-3 in every case (K=12, 16, 20, head widths 8 and 32, repeated
  points, B=1); tile against SIMT (the same function in two orders of
  summation) at 1e-2 of the scale. At C=33 on the kernel built at 48
  channels the same: its stages, the C=33 cases, three heads of 11 and the
  coordinate path, against SIMT at 1e-2, both timed at B=8 and B=64.
- train, accurate step at B=2 (every EGCL launch on the fp32 tile kernels),
  card vs CPU: loss within 1e-4 relative;
  every parameter's gradient at cosine ≥ 0.9999 and relative L2 ≤ 1e-4
  (measured 1.6e-6); post-Adam parameters within 1e-6 where the gradient
  exceeds 1e-3 of its tensor's max, and within 2·lr everywhere (Adam's
  first update is ±lr·g/(|g|+ε), so an element whose gradient sits at the
  noise floor may flip sign).
- train, fast against accurate on the card: only finiteness is checked.
  At these untrained weights the similarity softmax saturates, and the two
  modes are different functions (the reference's gradient budget,
  BASELINE.md); the table is printed.
- spfh (B5), both modes, both kernels (the packed-count kernel the wrapper
  launches and the ballot kernel kept to compare): distances within 1e-6
  relative; at most 1e-4 of the edge-channels in another bin (fp noise at a
  boundary); SPFH values within 1e-3 (of 100 per channel) where a center's
  counts all agree; and bit for bit: distances and SPFH equal, no
  edge-channel in another bin (the same operations in the same order, each
  rounded on its own), at full width and on the edge cases (B=1, K=16, 33,
  100 and 300, repeated points).
- TF32 enabled: the normals and the branch verification equal their
  TF32-off values within 1e-6 (they use no matmul).
- register_fpfh at its defaults (whole-cloud k-NN, gather FPFH): the k-NN
  lists of the pair's two clouds identical card vs CPU; both poses within
  0.5 deg and 5 mm of the ground truth; card vs CPU ‖ΔR‖_F/√2 ≤ 2e-3 and
  |Δt| ≤ 2e-3 m with ICP run to its fixed point (60 steps: 3.79e-6 and
  3.87e-6 m measured). At the default 10 steps pair 6 measured 2.73e-3 and
  1.41e-3 m, printed and not held: the lists are identical and the normals
  agree within 3e-7 with none oriented the other way, but the gather FPFH
  does not (7630 of 135168 entries moved by more than 0.1, at most 27.9;
  not traced further), so the matches differ and 10 ICP steps end short of
  the fixed point (H100 80GB HBM3, 700 W).
- register_fpfh at k_fpfh=300 (fused with exact keys over W=768, and at
  its defaults): the default path's gate, both poses within 0.5 deg and 5
  mm of the truth and card vs CPU within 2e-3 at 60 ICP steps; 2 k-NN
  launches a call, both on the large-k kernel, and 2 'redux' SPFH on the
  fused route.
- cli: each command's launches by kernel exactly as counted from the
  dataset (train: 2 k-NN, 6 B2 and 6 B3 a step and 2 k-NN and 6 B2 a
  validation batch; eval: 2 and 6 a test batch; export: none); the export
  reads back to the trained weights exactly; eval card vs CPU of one
  checkpoint directory: every pair's pose at the accurate gate of
  tests/test_torch_serving.py::_compare (‖ΔR‖_F/√2 and |Δt| ≤ 1e-4), the
  summaries' translation error within 1e-2 cm and recall, precision and F1
  within 1e-4 (the rotation error is printed, not held: arccos((tr - 1)/2)
  in float32 moves ~4e-3 deg an ulp of the trace near the 0.03 deg the
  KITTI test split's inlier-only pairs reach); because the pose of those
  pairs is a Kabsch fit over correct correspondences whatever the EGNN
  weighs them, eval also holds what the EGNN hands the head, card vs CPU:
  the embeddings h_src and h_tgt, the correspondence logits and the Kabsch
  weights within 1e-4 of their scale; remat: the loss equal bit for bit,
  every parameter's gradient within 1e-4 of its scale (B3 sums by atomics,
  so two backward runs differ in order); one train step on the same batch
  and weights, card vs CPU: every loss term within 1e-4 relative, every
  gradient at cosine >= 0.9999 and relative L2 <= 1e-4 (the train phase's
  accurate gates), taken with the CPU on the card's side of each ReLU of
  the head's score MLP whose input the two round to opposite sides of 0,
  after the inputs of those layers agree card vs CPU within 1e-5 of each
  layer's largest (SCORE_KINK_TOL; measured ≤ 6.9e-7). At the kitti
  preset's cli-trained weights one such input sits within ~1.5e-6 of 0,
  and in about half the trainings (the atomics' order moves the weights'
  last bits) the two take opposite branches, which moves
  egnn.embedding_in.weight's gradient by 1.01e-3 relative L2 whatever EGCL
  kernel runs (egcl_f32_numerics.py); the gap on each
  side's own branches is printed.
- variants: (a) and (b) card vs CPU, R and t within 2e-5 (the plain EGNN
  in fp32 on both sides, the 'cluster' sums by atomics on the card); (b)
  the target rotated by Q: R' = QR and t' = Qt within 1e-4; the EGNN in
  fp64 (a copy of the weights): h(Qx) = h(x) and its coordinate update
  u(Qx) = Q u(x) within 1e-6 of their scales (measured on the CPU 4.5e-8
  and 5.3e-8). In fp32 the invariant mode's ratio feature √‖x_row ×
  x_col‖² / ‖rel‖² is ill-conditioned at N=2048 (‖x_row × x_col‖² comes
  from a cancellation, then divides by the ‖rel‖² of close neighbours: 2.2
  off its fp64 value at a scale of 138), so the fp32 h moves by ~3e-2 of
  its scale under a rotation, bounded by its fp32-against-fp64 gaps at x
  and Qx; both printed; (c) after 5 fast steps every live parameter bf16
  and within one bf16 ulp of its fp32 master, the losses finite; step 1
  card vs CPU from the same init and batch in fast mode is printed, not
  held (bf16 operands summed in another order, at the seeded weights'
  saturated similarity softmax: the first card run found a master 2 lr
  off, an Adam first step of the other sign, where the gradient exceeded
  1e-2 of its tensor's max); the same bf16 step in accurate mode (fp32
  tile B2 and B3) is held at the train gate: the loss within 1e-4
  relative, the gradients at cosine >= 0.9999, the fp32 masters within
  1e-6 where the CPU's first gradient exceeds 1e-3 of its tensor's max and
  2 lr everywhere (plus the fp32 rounding of the two updates); (d) the
  cli phase's train gates, every loss term within 1e-4 relative and every
  gradient at cosine >= 0.9999, and the relative L2 within the larger of
  1e-4 and two fp32 spacings of the largest similarity: at the seeded
  weights the train head's softmax over similarities of ~8e3 is one-hot,
  and a spacing there scales the runner-up's weight and every gradient on
  the Kabsch path by that much (the first card run measured 1.01e-4 on
  `egnn.gcl_1.edge_mlp.head_biases` at cosine 1 - 3.6e-11: a scale, not a
  direction).
- kitti: (a) register() card vs CPU at the serve gate at B=16 and 64;
  register_raw as serve_extra's (b) (the tables identical, matches ≥ 99.5%,
  register() on the CPU's matched set at the serve gate, the full gap
  printed); (b) the fast train step, card vs CPU: every loss term within
  BWD_TOL_FAST (5e-3) relative; the score-MLP's ReLU inputs within
  EGNN_TOL_FAST (2e-2) of each layer's largest, and with the CPU on the
  card's side of each ReLU whose input the two put on opposite sides of 0
  (the cli gate's guard), every gradient within EGNN_TOL_FAST relative L2.
  Fast mode rounds the EGNN's operands to bf16 on both sides in another
  order of the fp32 sums, so the score MLP's inputs agree only to the fast
  forward's tolerance and the cli gate's SCORE_KINK_TOL (1e-5, fp32 on
  both sides) does not apply; the same step on the card on the SIMT
  kernels is printed beside it (the gap is the rounding order's).
- serve_extra: (a) the clique keeps ≥ 80% of the inliers and ≤ 10% of the
  outliers, the card's clique_inliers equal the host labels' count (both
  sides label on the host), R and t at the serving gate (2e-3); (b) the
  fitted clouds and both k-NN tables identical card vs CPU, matches equal
  on ≥ 99.5% of the rows (the gather FPFH's fp floor can flip a near-tie
  match: one bin flip moves its center's row and the ~60 rows that average
  it), the card's register() on the CPU's matched set at the serving gate;
  the full register_raw gap is printed, not held (its inputs differ where
  a match flipped; 1.9e-3 to 3.1e-3 in ‖ΔR‖/√2 over this smoke's runs, H100
  80GB HBM3, 700 W); (c) the loaded Registrar's
  R, t, similarity mean and covariance within 1e-6 (of the scale for the
  last two) of register()'s on the same batch, equal with TF32 on, launches
  exact, no model, train, serving or data module imported; (d) each output
  within 1e-6 of its scale of register_fpfh_batch's, launches exact.
- register_fpfh card vs CPU, same seed: both within 0.5 deg and 5 mm of the
  ground truth; ‖ΔR‖_F/√2 ≤ 2e-3 and |Δt| ≤ 2e-3 m between them. The
  batch: all but at most one pair within 0.5 deg and 5 mm. The gap between
  card and CPU is fp noise amplified by plane ICP, whose end state on
  independently sampled surfaces wanders at the 1e-3 level: over 12 seeded
  pairs at 4 branches and 1 it measured 1.2e-4 to 3.3e-3 (4 of 24 above
  2e-3) while every run stayed within 0.19 deg and 1.8 mm of the truth
  (H100 80GB HBM3, 700 W). The check runs on pair 6 (2.8e-4 at both), and
  again at 60 ICP steps at the same gate, where ICP's fixed point leaves
  only the descriptors' differences; pairs 0-5 at 60 steps are printed,
  not held.
- tools: (a) the accurate side's gradients of corr + sim + equi on the
  card against the same gradients on the CPU, same weights and batch:
  every tensor at cosine >= 0.9999 (the train phase's gate; the relative
  L2 is printed, not held: at a one-hot softmax an fp32 spacing of the
  largest similarity scales the Kabsch path's gradients, as the cli phase
  found). The train loss itself is printed, not held: its pose terms take
  the arccos of cosines within ~1e-6 of 1 once the pose is good, clamped
  at 1 − 1e-6 (`losses._safe_arccos`, the reference's), so an fp32
  rounding moves a pair across the clamp and switches its gradient on or
  off (the first card run: 0.898 on egnn.gcl_0.coord_mlp_0.bias with the
  'cosine' head, all of it in the pose terms: corr + sim + equi at cosine
  1.0000000 in the same runs). The pairs on the two sides of the clamp are printed.
  The fast-against-accurate tables, and fast on the card against fast on
  the CPU, are printed, not held; every loss finite; (b) every call
  returns a finite pose, the counts printed; (c) card vs CPU and every
  1-ulp call at the serve gate, the gaps printed. Every path's launches
  exact.
- dist: the mesh calls against the calls without it: R and t within 1e-6,
  the covariance, similarity mean and weights within 1e-6 of their largest
  entry (the same rows in one batch); fit: step 1's losses within 1e-6
  relative, the parameters after step 2 within 1e-6 where the first
  gradient exceeds 1e-3 of its tensor's max and 2 lr a step everywhere
  (B3 sums by atomics, so even two runs without the mesh differ: that
  control is printed). Launches exact.
- point: KITTI's loss (corr + sim + equi; at the seeded init rot sits at
  the arccos clamp, √(2e-6) = 1.4e-3 rad, so the 3DMatch pose terms give
  the coordinate path no gradient and a 1e-7 change of the trace moves the
  loss 7e-5) within 1e-4, the gradients Adam applies within 1e-4 of each
  tensor's largest (POINT_GRAD_TOL) and the parameters after one Adam step
  within 5e-4 (the JAX dry run's: above 2·lr, since Adam's first step
  moves a weight by ~lr·sign(g), which hides a wrong scale that the
  gradients show), for the card against the CPU, against the unsharded
  step and the halo step against its twin. A row whose
  neighbour set differs between two k-NN graphs passes only as a tie
  (every swapped neighbour's float64 d² within 8 float32 spacings of the
  expansion's scale of the row's k-th). The point steps launch no kernel,
  the unsharded step 2 B1, 6 B2 and 6 B3 (fp32 tile).
- extras: (a) every variant's outputs (coordinates through their updates
  u = x′ − x, beyond the read-back floor of one fp32 spacing of max|x| a
  layer, as for egcl) card vs CPU within 1e-4 of each output's scale (fp32
  both sides, under fp32 matmuls) and rotation equivariance on the card within 2e-4 of the
  scale (the JAX tests' 2e-4); the legacy GCN card vs CPU within 1e-5 of
  the scale (fp32 sits ~5e-7 from fp64 there, a TF32 einsum ~4e-4), its
  adjacency symmetric within 1e-5; the card's whole-cloud graph equal to
  the plain version's. (b) reversible against plain: outputs, every
  gradient and the inverse within 1e-4 of the scale, and a smaller peak.
  (c) SH and the basis card vs CPU within 1e-10, Y(Rx) = D(R)Y(x) within
  1e-10 and the basis's equivariance within 1e-8 (the JAX tests'). (d)
  `global_registration` under 1 deg at full overlap (the JAX test's
  gate); the examples' launches exact.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
SLEEP_CYCLES_PER_CALL = 400_000   # ~0.2 ms at the H100's clocks, above a wrapper's host time
BWD_TOL_ACCURATE = 1e-4
EGNN_TOL_ACCURATE = 1e-4     # card vs CPU after a whole accurate EGNN pass, of the scale
# card vs CPU in fast mode after the EGNN (and through it), of the scale: the
# fast forward's tolerance on h′ (a sum that differs in its last fp32 bit can
# round an operand to the next bf16 value, 2⁻⁸ relative, and that propagates)
EGNN_TOL_FAST = 2e-2
BWD_TOL_FAST = 5e-3
# csrc/spfh.cu, fp32 operations per edge: d and d² (8), sqrt and d̂ (5), the
# two source-pick dots (12), the v cross, norm and divides (20), w (9), four
# Darboux dots (20), α/φ bins (12), 12 θ sector tests (36) and their
# compares (24), the distance select (1)
SPFH_EDGE_OPS = 147
# the checkpoint-free pipeline's full width (register_fpfh defaults, the
# fused/chunked fast mode): N, k_normals, k_fpfh, tile, window
FPFH_N, FPFH_KN, FPFH_K, FPFH_TILE, FPFH_WINDOW = 2048, 30, 60, 128, 768
FPFH_BATCHES = (8, 32)      # register_fpfh_batch sizes timed
# seeded pairs of the printed 60-step ICP sweep, card vs CPU: ~7.4 s a pair,
# most of it the CPU side; 6 (once 12) keep the whole smoke near half its limit
ICP60_SWEEP_PAIRS = 6
KNN_LARGE_K = 300           # exact keys beyond k = 128: csrc/knn_exact_large.cu
# the robust phase's ICP cases: steps a scale, the pyramid's coarse cell (m),
# and the Registrar's bumpy-surface pairs
ROBUST_ICP_ITERS, ROBUST_VOXEL, ROBUST_ICP_PAIRS = 60, 0.1, 4


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps):
    """Device ms a call of fn, over `reps` calls. The timed calls queue up
    behind a device-side sleep that outlasts their enqueue, so a kernel
    shorter than its host launch path is timed on the device, not the host."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bound_ms(nbytes, ops, peak_ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile_call(torch, call, label):
    """Device time by kernel over one warm call under torch.profiler, and
    the device-busy share of that call's wall time (profiler on); returns
    (wall ms, device-busy ms, device operations: kernels and copies), or
    None when no device time was recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if total_ms == 0:
        log("profile: the profiler recorded no device time (not measured)")
        return None
    ops = sum(e.count for e in dev)
    log(f"profile {label}: wall {wall_ms:.2f} ms (profiler on), device "
        f"busy {total_ms:.2f} ms ({100 * total_ms / wall_ms:.1f}%), {len(dev)} kernels, "
        f"{ops} device operations")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:90]}")
    return wall_ms, total_ms, ops


def egcl_errors(torch, got, ref, x, accurate):
    """(max|Δh′|, max|Δu|, scale h′, scale u) for u = x′ − x; raises beyond
    the stated tolerances."""
    (gh, gx), (rh, rx) = got, ref
    tol_h, tol_u = (1e-4, 1e-4) if accurate else (2e-2, 1e-2)
    eh, sh = (gh - rh).abs().max().item(), rh.abs().max().item()
    eu, su = ((gx - x) - (rx - x)).abs().max().item(), (rx - x).abs().max().item()
    ulp = torch.finfo(torch.float32).eps * x.abs().max().item()
    check(su > 0, "egcl: the plain version moved no coordinate")
    check(eh <= tol_h * sh and eu <= tol_u * su + ulp,
          f"egcl accurate={accurate}: max|Δh′| {eh} (scale {sh}, tol {tol_h}), "
          f"max|Δu| {eu} (scale {su}, tol {tol_u}, read-back {ulp})")
    return eh, eu, sh, su


def backward_errors(got, ref, accurate, what, tol=None):
    """{name: (max|Δ|, max|ref|)} over dh, dx and the 11 parameter gradients
    of egcl_backward against its plain version (or another kernel, at
    `tol`); raises beyond the stated tolerances (module docstring)."""
    (gh, gx, gg), (rh, rx, rg) = got, ref
    pairs = dict(dh=(gh, rh), dx=(gx, rx), **{k: (gg[k], rg[k]) for k in rg})
    if tol is None:
        tol = BWD_TOL_ACCURATE if accurate else BWD_TOL_FAST
    errs = {}
    for name, (a, b) in pairs.items():
        scale = b.abs().max().item()
        errs[name] = ((a - b).abs().max().item(), scale)
        check(scale > 0, f"egcl_backward {what}: plain {name} is all zero")
    worst = max(errs, key=lambda k: errs[k][0] / errs[k][1])
    check(all(e <= tol * s for e, s in errs.values()),
          f"egcl_backward {what} accurate={accurate}: {worst} max|Δ| {errs[worst][0]} against "
          f"scale {errs[worst][1]} (tol {tol} of the scale)")
    return errs


def only(variant, n):
    """An EGCL wrapper's launches_by_variant with n launches of `variant`
    and none of the others."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    return {**dict.fromkeys(egcl.VARIANTS, 0), variant: n}


def by_row(wrapper, by_variant, c=32):
    """An EGCL wrapper's launches by kernel row on a path of width c, each
    in the row of the width its kernel was built at: the bf16 tile kernel's
    'tile' in the row named as the wrapper (CP=32) at C=32, '_cp48' (CP=48)
    at 32 < C <= 36; the fp32 tile kernel's 'tile_f32' in '_f32' (CP=32) at
    C=32, '_f32_cp36' (CP=36) at 32 < C <= 36. The SIMT kernels have no row
    of their own: a path that launched one fails."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    cp, tp = egcl.f32_width(c), egcl.tile_width(c)
    check(cp is not None or by_variant["tile_f32"] == 0,
          f"{wrapper}: 'tile_f32' launches at C={c}, which no fp32 tile width runs")
    check(tp is not None or by_variant["tile"] == 0,
          f"{wrapper}: 'tile' launches at C={c}, which no bf16 tile width runs")
    check(by_variant["simt"] == 0, f"{wrapper}: {by_variant['simt']} SIMT launches at C={c} "
          f"on a driven path")
    f32 = f"{wrapper}_f32_cp36" if cp == 36 else f"{wrapper}_f32"
    tile = f"{wrapper}_cp48" if tp == 48 else wrapper
    return {tile: by_variant["tile"], f32: by_variant["tile_f32"]}


def reset_backward_counters(eb):
    eb.egcl_backward.launches = 0
    eb.egcl_backward.launches_by_variant = dict.fromkeys(eb.egcl.VARIANTS, 0)


def log_backward_errors(errs, what):
    worst = max(errs, key=lambda q: errs[q][0] / errs[q][1])
    log(f"egcl_backward[{what}]: worst {worst} rel {errs[worst][0] / errs[worst][1]:.3g}; rel "
        "per tensor " + ", ".join(f"{q} {e / s_:.2g}" for q, (e, s_) in errs.items()))


def egcl_backward_tile_checks(torch, p, h, xs, nbr, gen):
    """The backward tile kernel from the bottom up: one bare transposed-
    operand product against d.T @ a, its per-edge cotangents (dcm_in, dv,
    du) against the plain version's, then the backward in every case the
    kernel has a path for."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    dev = h.device
    d = torch.randn(16, 32, generator=gen).to(torch.bfloat16).to(dev)
    a = torch.randn(16, 32, generator=gen).to(torch.bfloat16).to(dev)
    got = eb.bwd_tile_probe(d, a)
    torch.cuda.synchronize()
    ref = d.double().T @ a.double()
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-5 * scale, f"transposed mma tile: max|Δ| {err} against scale {scale}")
    log(f"egcl_backward tile: one transposed-operand product (Dᵀ·A over 16 edges) vs matmul "
        f"max|Δ| {err:.3g} (scale {scale:.3g})")

    b8 = min(8, h.shape[0])
    h8, x8, nbr8 = h[:b8].contiguous(), xs[:b8].contiguous(), nbr[:b8].contiguous()
    dm8 = torch.randn(*h8.shape, generator=gen).to(dev)
    dx8 = torch.randn(*x8.shape, generator=gen).to(dev)
    stages = eb.egcl_backward_tile_stages(h8, x8, nbr8, p, dm8, dx8)
    torch.cuda.synchronize()
    refs = eb.backward_stages_plain(h8, x8, nbr8, p, dm8, dx8, accurate=False)
    for name, g_, r_ in zip(("dcm_in", "dv", "du"), stages, refs):
        err, scale = (g_ - r_).abs().max().item(), r_.abs().max().item()
        check(scale > 0 and err <= 2e-2 * scale,
              f"egcl_backward tile stage {name}: max|Δ| {err} against scale {scale}")
        log(f"egcl_backward tile stage {name} B={b8}: max|Δ| {err:.3g} (rel {err / scale:.3g})")

    p1 = egcl.params_from_layer(EGNN(in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1,
                                     num_heads=1).to(dev).gcl_0)
    x_dup = x8.clone()
    x_dup[:, 1::2] = x_dup[:, ::2]                 # every point twice: degenerate frames
    k = nbr.shape[-1]
    wide = torch.cat([nbr8, nbr8.flip(1)[..., :4]], dim=-1).contiguous()
    cases = [(f"K={k}, head width {p.head_width}", h8, x8, nbr8, p, dm8, dx8),
             ("K=12", h8, x8, nbr8[..., :12].contiguous(), p, dm8, dx8),
             (f"K={k + 4} (two row tiles)", h8, x8, wide, p, dm8, dx8),
             ("head width 32", h8, x8, nbr8, p1, dm8, dx8),
             ("repeated points", h8, x_dup, nbr8, p, dm8, dx8),
             ("B=1", h8[:1].contiguous(), x8[:1].contiguous(), nbr8[:1].contiguous(), p,
              dm8[:1].contiguous(), dx8[:1].contiguous())]
    for name, h_, x_, nbr_, p_, dm_, dx_ in cases:
        check(egcl.egcl_variant(32, nbr_.shape[-1], p_.head_width, False) == "tile",
              f"egcl_backward tile case {name} is not routed to the tile kernel")
        reset_backward_counters(eb)
        got = eb.egcl_backward(h_, x_, nbr_, p_, dm_, dx_, False)
        torch.cuda.synchronize()
        check(eb.egcl_backward.launches_by_variant == only("tile", 1),
              f"egcl_backward tile case {name} launched {eb.egcl_backward.launches_by_variant}")
        check(all(bool(torch.isfinite(t_).all()) for t_ in (got[0], got[1], *got[2].values())),
              f"egcl_backward tile case {name}: non-finite output")
        errs = backward_errors(got, eb.egcl_backward_plain(h_, x_, nbr_, p_, dm_, dx_, False),
                               False, f"tile case {name}")
        log_backward_errors(errs, f"tile case {name}, B={h_.shape[0]}")


def egcl_backward_f32_checks(torch, p, h, xs, nbr, gen):
    """The fp32 tile backward in every case of `f32_cases` and on the
    coordinate path alone (dagg_m = 0, the coord output at O(1/√C)), each
    against the plain accurate version at BWD_TOL_ACCURATE."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    dev = h.device
    b8 = min(8, h.shape[0])
    h8, x8, nbr8 = h[:b8].contiguous(), xs[:b8].contiguous(), nbr[:b8].contiguous()
    dm8 = torch.randn(*h8.shape, generator=gen).to(dev)
    dx8 = torch.randn(*x8.shape, generator=gen).to(dev)
    pc = p._replace(wc1=torch.randn(1, 32, generator=gen).to(dev) / 32 ** 0.5)
    cases = [(*case, dm8) for case in f32_cases(torch, p, h8, x8, nbr8)]
    cases.append(("coordinate path", h8, x8, nbr8, pc, torch.zeros_like(dm8)))
    for name, h_, x_, nbr_, p_, dm_ in cases:
        b_ = h_.shape[0]
        dm_, dx_ = dm_[:b_].contiguous(), dx8[:b_].contiguous()
        check(egcl.egcl_variant(32, nbr_.shape[-1], p_.head_width, True) == "tile_f32",
              f"egcl_backward f32 case {name} is not routed to the fp32 tile kernel")
        reset_backward_counters(eb)
        got = eb.egcl_backward(h_, x_, nbr_, p_, dm_, dx_, True)
        torch.cuda.synchronize()
        check(eb.egcl_backward.launches_by_variant == only("tile_f32", 1),
              f"egcl_backward f32 case {name} launched {eb.egcl_backward.launches_by_variant}")
        check(all(bool(torch.isfinite(t_).all()) for t_ in (got[0], got[1], *got[2].values())),
              f"egcl_backward f32 case {name}: non-finite output")
        errs = backward_errors(got, eb.egcl_backward_plain(h_, x_, nbr_, p_, dm_, dx_, True),
                               True, f"f32 case {name}")
        log_backward_errors(errs, f"f32 case {name}, B={b_}")


def egcl_backward_phase(torch, p, h, xs, nbr, gen):
    """B2 with agg_m (the fp32 tile kernel in accurate mode, the bf16 tile
    kernel in fast), then B3 against their plain versions at the main path's
    shapes, on random cotangents and on the coordinate path alone: the bf16
    tile kernel from the bottom up and the fp32 tile kernel in every case;
    each mode through its tile kernel and the SIMT kernel, timed beside the
    plain version, the two held against each other (C=33 is
    `egcl_backward_c33_phase`'s). Returns the rows of the bf16 and the fp32
    tile kernels at C=32."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    dev = h.device
    b, n, c = h.shape
    k = nbr.shape[-1]
    egcl_backward_tile_checks(torch, p, h, xs, nbr, gen)
    egcl_backward_f32_checks(torch, p, h, xs, nbr, gen)
    packed = egcl.pack_for_kernels(p)
    dagg_m = torch.randn(b, n, c, generator=gen).to(dev)
    dagg_x = torch.randn(b, n, 3, generator=gen).to(dev)
    # the coordinate path alone: every cotangent reaches the edge MLP through
    # dm = Wc0ᵀ·dcm_in, and drel's dax·scale term is at full weight
    pc = p._replace(wc1=torch.randn(1, c, generator=gen).to(dev) / c ** 0.5)
    packed_c, zero_m = egcl.pack_for_kernels(pc), torch.zeros_like(dagg_m)
    stats, outs = {}, {}
    for accurate in (True, False):
        mode = "accurate" if accurate else "fast"
        reset_egcl_counters(egcl)
        gh, gx, gm = egcl.egcl_layer(h, xs, nbr, p, accurate, packed, return_aggm=True)
        torch.cuda.synchronize()
        want = egcl.egcl_variant(c, k, p.head_width, accurate)
        check(egcl.egcl_layer.launches_by_variant == only(want, 1),
              f"egcl with agg_m, {mode}: launched {egcl.egcl_layer.launches_by_variant}")
        rh, rx, rm = egcl.egcl_layer_plain(h, xs, nbr, p, accurate, return_aggm=True)
        egcl_errors(torch, (gh, gx), (rh, rx), xs, accurate)
        em, sm = (gm - rm).abs().max().item(), rm.abs().max().item()
        check(em <= (1e-4 if accurate else 2e-2) * sm,
              f"egcl agg_m accurate={accurate}: max|Δ| {em} against scale {sm}")
        ms_aggm = cuda_ms(torch, lambda: egcl.egcl_layer(h, xs, nbr, p, accurate, packed,
                                                          return_aggm=True), 10)
        log(f"egcl with agg_m {mode} ({want}): max|Δ| {em:.3g} (rel {em / sm:.3g}), "
            f"{ms_aggm:.4f} ms")
        ref = eb.egcl_backward_plain(h, xs, nbr, p, dagg_m, dagg_x, accurate)
        ref_c = eb.egcl_backward_plain(h, xs, nbr, pc, zero_m, dagg_x, accurate)
        plain = cuda_ms(torch, lambda: eb.egcl_backward_plain(h, xs, nbr, p, dagg_m,
                                                               dagg_x, accurate), 2)
        for variant in (want, "simt"):
            name = f"{mode} {variant}"
            reset_backward_counters(eb)
            got = eb.egcl_backward(h, xs, nbr, p, dagg_m, dagg_x, accurate, packed, variant)
            torch.cuda.synchronize()
            got_c = eb.egcl_backward(h, xs, nbr, pc, zero_m, dagg_x, accurate, packed_c,
                                     variant)
            torch.cuda.synchronize()
            check(eb.egcl_backward.launches_by_variant == only(variant, 2),
                  f"egcl_backward[{name}] launched {eb.egcl_backward.launches_by_variant}")
            errs = backward_errors(got, ref, accurate, f"{name}, random cotangents")
            errs_c = backward_errors(got_c, ref_c, accurate, f"{name}, coordinate path")
            ms = cuda_ms(torch, lambda: eb.egcl_backward(h, xs, nbr, p, dagg_m, dagg_x,
                                                          accurate, packed, variant), 5)
            stats[name] = (ms, plain, max(e for e, _ in (*errs.values(), *errs_c.values())))
            outs[name] = got
            log_backward_errors(errs, f"{name}, random cotangents, B={b} N={n} C={c} K={k}")
            log_backward_errors(errs_c, f"{name}, coordinate path")
            log(f"egcl_backward[{name}]: kernel {ms:.4f} ms, plain {plain:.3f} ms")
    # the two kernels of a mode against each other: one function, two orders of summation
    for a, b_, accurate, tol in (("fast tile", "fast simt", False, 1e-2),
                                 ("accurate tile_f32", "accurate simt", True,
                                  2 * BWD_TOL_ACCURATE)):
        errs = backward_errors(outs[a], outs[b_], accurate, f"{a} vs {b_}", tol=tol)
        log_backward_errors(errs, f"{a} vs {b_}")
    ops, nbytes = egcl_backward_bound(c, p.head_width, b, n, k, packed.simt.numel())
    fb, fby = bound_ms(nbytes, ops, PEAK_BF16)
    ab, aby = bound_ms(nbytes, ops, PEAK_FP32)
    log(f"egcl_backward bound: {ops / (b * n * k):.0f} FLOP/edge; fast vs bf16 peak "
        f"{fb:.4f} ms (tile {stats['fast tile'][0]:.4f} ms at "
        f"{100 * fb / stats['fast tile'][0]:.2f}%, SIMT {stats['fast simt'][0]:.4f} ms); "
        f"accurate vs fp32 peak {ab:.4f} ms (tile_f32 {stats['accurate tile_f32'][0]:.4f} ms "
        f"at {100 * ab / stats['accurate tile_f32'][0]:.2f}%, SIMT "
        f"{stats['accurate simt'][0]:.4f} ms at {100 * ab / stats['accurate simt'][0]:.2f}%)")
    src = "se3_equi_graph_registration_tpu_torch/csrc/"
    replaces = "se3_equi_graph_registration_tpu/ops/pallas/egcl_backward.py:53"
    row = lambda name, source, stat, simt, bound, by, variant: dict(
        name=name, route="cuda", source=src + source, replaces=replaces, launches=0,
        max_abs_err=stats[stat][2], ms=stats[stat][0], plain_ms=stats[stat][1], bound_ms=bound,
        bound_by=by, library_ms=None, variant=variant, simt_ms=stats[simt][0],
        simt_source=src + "egcl_backward.cu")
    return (row("egcl_backward", "egcl_backward_tile.cu", "fast tile", "fast simt", fb, fby,
                "tile"),
            row("egcl_backward_f32", "egcl_backward_tile_f32.cu", "accurate tile_f32",
                "accurate simt", ab, aby, "tile_f32"))


def egcl_backward_c33_phase(torch, xs, nbr, gen):
    """B3 at KITTI's width (C=33, one head) on the tile kernels built at a
    padded width, in both modes (`egcl_backward_c33_mode`): accurate on the
    fp32 kernel at CP=36, fast on the bf16 kernel at CP=48. Returns their
    rows, fp32 then bf16."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    dev = xs.device
    bsz, n = xs.shape[:2]
    p33, h33 = c33_inputs(torch, xs, nbr, gen)
    dm = torch.randn(bsz, n, 33, generator=gen).to(dev)
    dx = torch.randn(bsz, n, 3, generator=gen).to(dev)
    pc = p33._replace(wc1=torch.randn(1, 33, generator=gen).to(dev) / 33 ** 0.5)
    p3 = c33_heads3(torch, dev)
    packed = egcl.pack_for_kernels(p33)
    return tuple(egcl_backward_c33_mode(torch, p33, p3, pc, packed, h33, xs, nbr, dm, dx, accurate)
                 for accurate in (True, False))


def egcl_backward_c33_mode(torch, p33, p3, pc, packed, h33, xs, nbr, dm, dx, accurate):
    """B3 at C=33 in one mode on its tile kernel ('tile_f32' built at CP=36
    in accurate mode, 'tile' at CP=48 in fast mode): in fast mode first its
    per-edge cotangents (dcm_in, dv, du) against the plain fast version's
    at 2e-2 of the scale; then the backward in every case of `c33_cases`,
    with three heads of 11 (`p3`) and on the coordinate path alone (dagg_m
    = 0, the coord output `pc` at O(1/√C)), against the plain version at
    the mode's tolerance (BWD_TOL_ACCURATE, BWD_TOL_FAST); then at B=8 and
    at the run's batch the tile and the SIMT kernel, each against the plain
    version, against each other at twice the tolerance and timed, with the
    bound at C=33 on the mode's peak. Returns the kernel's row (its numbers
    at the run's batch, B=8's under `b8`)."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    bsz, n = xs.shape[:2]
    b8 = min(8, bsz)
    tile = "tile_f32" if accurate else "tile"
    cp = egcl.f32_width(33) if accurate else egcl.tile_width(33)
    mode = f"{'accurate' if accurate else 'fast'} {tile} CP={cp}"
    h8, x8, nbr8 = h33[:b8].contiguous(), xs[:b8].contiguous(), nbr[:b8].contiguous()
    dm8, dx8 = dm[:b8].contiguous(), dx[:b8].contiguous()
    if not accurate:
        stages = eb.egcl_backward_tile_stages(h8, x8, nbr8, p33, dm8, dx8)
        torch.cuda.synchronize()
        refs = eb.backward_stages_plain(h8, x8, nbr8, p33, dm8, dx8, accurate=False)
        for name, g_, r_ in zip(("dcm_in", "dv", "du"), stages, refs):
            err, scale = (g_ - r_).abs().max().item(), r_.abs().max().item()
            check(scale > 0 and err <= 2e-2 * scale,
                  f"egcl_backward C=33 tile stage {name}: max|Δ| {err} against scale {scale}")
            log(f"egcl_backward {mode} stage {name} B={b8}: max|Δ| {err:.3g} "
                f"(rel {err / scale:.3g})")
    cases = [(*case, dm8) for case in c33_cases(torch, p33, h8, x8, nbr8)]
    cases.append(("C=33, 3 heads of 11", h8, x8, nbr8, p3, dm8))
    cases.append(("C=33, coordinate path", h8, x8, nbr8, pc, torch.zeros_like(dm8)))
    for name, h_, x_, nbr_, p_, dm_ in cases:
        b_ = h_.shape[0]
        dm_, dx_ = dm_[:b_].contiguous(), dx8[:b_].contiguous()
        check(egcl.egcl_variant(33, nbr_.shape[-1], p_.head_width, accurate) == tile,
              f"egcl_backward case {name} is not routed to the {tile} kernel")
        reset_backward_counters(eb)
        got = eb.egcl_backward(h_, x_, nbr_, p_, dm_, dx_, accurate)
        torch.cuda.synchronize()
        check(eb.egcl_backward.launches_by_variant == only(tile, 1),
              f"egcl_backward case {name} launched {eb.egcl_backward.launches_by_variant}")
        check(all(bool(torch.isfinite(t_).all()) for t_ in (got[0], got[1], *got[2].values())),
              f"egcl_backward case {name}: non-finite output")
        errs = backward_errors(got, eb.egcl_backward_plain(h_, x_, nbr_, p_, dm_, dx_, accurate),
                               accurate, f"{mode} case {name}")
        log_backward_errors(errs, f"{mode} case {name}, B={b_}")
    tol = BWD_TOL_ACCURATE if accurate else BWD_TOL_FAST
    stats = {}
    for b in sorted({b8, bsz}):
        h_, x_, nbr_ = h33[:b].contiguous(), xs[:b].contiguous(), nbr[:b].contiguous()
        dm_, dx_ = dm[:b].contiguous(), dx[:b].contiguous()
        k = nbr_.shape[-1]
        ref = eb.egcl_backward_plain(h_, x_, nbr_, p33, dm_, dx_, accurate)
        plain = cuda_ms(torch, lambda: eb.egcl_backward_plain(h_, x_, nbr_, p33, dm_, dx_,
                                                               accurate), 2)
        outs = {}
        for variant in (tile, "simt"):
            reset_backward_counters(eb)
            got = eb.egcl_backward(h_, x_, nbr_, p33, dm_, dx_, accurate, packed, variant)
            torch.cuda.synchronize()
            check(eb.egcl_backward.launches_by_variant == only(variant, 1),
                  f"egcl_backward C=33 {variant} launched {eb.egcl_backward.launches_by_variant}")
            errs = backward_errors(got, ref, accurate, f"C=33 {variant} B={b}")
            ms = cuda_ms(torch, lambda: eb.egcl_backward(h_, x_, nbr_, p33, dm_, dx_, accurate,
                                                          packed, variant), 5)
            stats[b, variant] = (ms, plain, max(e for e, _ in errs.values()))
            outs[variant] = got
            log_backward_errors(errs, f"C=33, 1 head, {mode if variant == tile else 'simt'}, "
                                      f"B={b} N={n} K={k}")
            log(f"egcl_backward[C=33 {'accurate' if accurate else 'fast'} {variant}] B={b}: "
                f"kernel {ms:.4f} ms, plain {plain:.3f} ms")
        errs = backward_errors(outs[tile], outs["simt"], accurate,
                               f"C=33 {tile} vs simt B={b}", tol=2 * tol)
        log_backward_errors(errs, f"C=33 {tile} vs simt, B={b}")
        ops, nbytes = egcl_backward_bound(33, p33.head_width, b, n, k, packed.simt.numel())
        bound, by = bound_ms(nbytes, ops, PEAK_FP32 if accurate else PEAK_BF16)
        stats[b, "bound"] = (bound, by)
        tile_ms, simt_ms = stats[b, tile][0], stats[b, "simt"][0]
        log(f"egcl_backward C=33 {mode} B={b}: bound {ops / (b * n * k):.0f} FLOP/edge, "
            f"{bound:.4f} ms ({by}, {'fp32' if accurate else 'bf16'} peak); {tile} "
            f"{tile_ms:.4f} ms at {100 * bound / tile_ms:.2f}%, SIMT {simt_ms:.4f} ms at "
            f"{100 * bound / simt_ms:.2f}% ({simt_ms / tile_ms:.2f}x); {card_line()}")
    src = "se3_equi_graph_registration_tpu_torch/csrc/"
    return c33_row(stats, "egcl_backward_f32_cp36" if accurate else "egcl_backward_cp48",
                   src + ("egcl_backward_tile_f32.cu" if accurate else "egcl_backward_tile.cu"),
                   "se3_equi_graph_registration_tpu/ops/pallas/egcl_backward.py:53",
                   src + "egcl_backward.cu", bsz, b8, tile, cp)


PHASES = ("knn", "egcl", "serve", "bwd", "train", "fpfh", "robust", "cli", "serve_extra",
          "variants", "multiway", "tools", "dist", "point", "extras", "kitti")
ROW_ORDER = ("knn_window", "knn_exact_large", "egcl_layer", "egcl_layer_f32", "egcl_layer_f32_cp36",
             "egcl_layer_cp48", "egcl_backward", "egcl_backward_f32", "egcl_backward_f32_cp36",
             "egcl_backward_cp48", "knn_chunked", "spfh")
# the phases whose paths launch each kernel row's kernel
DRIVEN_BY = dict(knn_window=("serve", "train", "fpfh", "robust", "cli", "serve_extra",
                             "variants", "multiway", "tools", "dist", "point", "extras",
                             "kitti"),
                 # register_fpfh at k_fpfh = KNN_LARGE_K, fused and at its defaults
                 knn_exact_large=("fpfh",),
                 egcl_layer=("serve", "train", "robust", "serve_extra", "variants", "tools",
                             "dist", "extras"),
                 egcl_layer_f32=("serve", "train", "cli", "variants", "tools", "dist", "point",
                                 "extras"),
                 egcl_backward=("train", "variants", "tools"),
                 egcl_backward_f32=("train", "cli", "variants", "tools", "dist", "point",
                                    "extras"),
                 # the fp32 tile kernels built at CP=36: KITTI's C=33 (the kitti preset)
                 egcl_layer_f32_cp36=("cli", "serve_extra"),
                 egcl_backward_f32_cp36=("cli",),
                 # the bf16 tile kernels built at CP=48: KITTI's C=33 in fast mode
                 egcl_layer_cp48=("kitti",),
                 egcl_backward_cp48=("kitti",),
                 knn_chunked=("fpfh", "robust", "serve_extra", "multiway", "tools", "dist",
                              "extras"),
                 spfh=("fpfh", "robust", "serve_extra", "multiway", "tools", "dist", "extras"))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES) + " (default: all)")
    phases = tuple(ap.parse_args(argv).phases.split(","))
    if not phases or any(ph not in PHASES for ph in phases):
        ap.error(f"--phases takes names from {PHASES}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build
    from se3_equi_graph_registration_tpu_torch.train import engine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s (parallel nvcc, sm_90a)")
    for name, out in logs.items():
        for line in out.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")

    rows = run(torch, dev, engine.fast_tpu_config(), bsz=64, phases=phases)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi: no output"


def record_launches(rows, path, launches, by_variant=None):
    """Write one path's launch counts {kernel name: n}, and for the k-NN rows
    {kernel name: {variant: n}}, into the rows."""
    for name, n in launches.items():
        if name in rows:
            rows[name].setdefault("launches_by_path", {})[path] = n
            rows[name]["launches"] = sum(rows[name]["launches_by_path"].values())
    for name, counts in (by_variant or {}).items():
        if name in rows:
            for v, n in counts.items():
                rows[name]["launches_by_variant"][v] += n


def check_knn_warp(fn, what):
    """Every launch of the k-NN wrapper `fn` since its counters were reset
    was the warp kernel; returns its counts by variant."""
    counts = dict(fn.launches_by_variant)
    check(fn.launches > 0 and counts == {"warp": fn.launches, "thread": 0},
          f"{what}: k-NN launches by kernel {counts}, want all {fn.launches} 'warp'")
    return counts


def reset_knn_counters(knn):
    for fn in (knn.knn_window, knn.knn_chunked):
        fn.launches = 0
        fn.launches_by_variant = {"warp": 0, "thread": 0}
    knn.knn_window.launches_by_source = dict.fromkeys(knn.WINDOW_SOURCES, 0)


def reset_egcl_counters(egcl):
    egcl.egcl_layer.launches = 0
    egcl.egcl_layer.launches_by_variant = dict.fromkeys(egcl.VARIANTS, 0)


def run(torch, dev, cfg, bsz, phases=PHASES):
    """The chosen phases at `cfg` with `bsz` pairs (clouds, for B4 and B5);
    returns the kernel rows of the phases that ran, in ROW_ORDER."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops import morton
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine

    n, k, c, tile, window = cfg.num_nodes, cfg.k, cfg.hidden_nf, cfg.egnn_tile, cfg.egnn_window
    rng = np.random.default_rng(0)
    pb = make_pair_batch(rng, batch=bsz, n=n, feat_dim=cfg.in_node_nf)
    x = torch.from_numpy(pb.src_pts).to(dev)
    _, xs, _ = morton.sort_by_curve(torch.zeros(bsz, n, 1, device=dev), x)
    xs = xs.contiguous()
    gen = torch.Generator().manual_seed(0)
    cpu_model = engine.build_model(cfg, "eval_fusion", device="cpu")
    checkpoints.init_weights(cpu_model, gen)
    sd = cpu_model.state_dict()
    layer_model = engine.build_model(cfg, "eval_fusion", device=dev)
    layer_model.load_state_dict(sd)
    p = egcl.params_from_layer(layer_model.egnn.gcl_0)
    h = torch.randn(bsz, n, c, generator=gen).to(dev)
    nbr = knn.knn_window(xs, k, tile=tile, window=window, packed=True)
    rows = {}

    if "knn" in phases:
        rows["knn_window"], rows["knn_exact_large"], rows["knn_chunked"] = knn_phase(
            torch, x, xs, k, tile, window)
    if "egcl" in phases:
        rows["egcl_layer"], rows["egcl_layer_f32"] = egcl_phase(torch, p, h, xs, nbr, gen)
        rows["egcl_layer_f32_cp36"], rows["egcl_layer_cp48"] = egcl_c33_phase(torch, xs, nbr,
                                                                               gen)
    if "serve" in phases:
        serve_phase(torch, dev, cfg, bsz, sd, rows)
    if "bwd" in phases:
        rows["egcl_backward"], rows["egcl_backward_f32"] = egcl_backward_phase(
            torch, p, h, xs, nbr, gen)
        rows["egcl_backward_f32_cp36"], rows["egcl_backward_cp48"] = egcl_backward_c33_phase(
            torch, xs, nbr, gen)
    if "train" in phases:
        train_phase(torch, dev, cfg, bsz, rows)
    if "fpfh" in phases:
        rows["spfh"] = fpfh_kernel_phase(torch, dev, bsz)
        register_fpfh_phase(torch, dev, rows)
        register_fpfh_default_phase(torch, dev, rows)
        register_fpfh_large_k_phase(torch, dev, rows)
    if "robust" in phases:
        robust_phase(torch, dev, cfg, bsz, sd, rows)
    if "cli" in phases:
        cli_phase(torch, dev, rows)
    if "serve_extra" in phases:
        serve_extra_phase(torch, dev, cfg, sd, rows)
    if "variants" in phases:
        variants_phase(torch, dev, cfg, sd, rows)
    if "multiway" in phases:
        multiway_phase(torch, dev, rows)
    if "tools" in phases:
        tools_phase(torch, dev, cfg, sd, rows)
    if "dist" in phases:
        dist_phase(torch, dev, cfg, bsz, sd, rows)
    if "point" in phases:
        point_phase(torch, dev, rows)
    if "extras" in phases:
        extras_phase(torch, dev, cfg, rows)
    if "kitti" in phases:
        kitti_phase(torch, dev, rows)
    for name, row in rows.items():
        if any(ph in phases for ph in DRIVEN_BY[name]):
            check(row["launches"] > 0, f"{name}: no launch on the paths this run drove")
    return [rows[name] for name in ROW_ORDER if name in rows]


# The emulated test's edge cases (tests/test_torch_knn_warp_emulated.py) at
# small size, and a few more: (kernel, b, n, k, tile, window, include_self,
# cloud kind). Exact keys over the whole cloud (window None) take the cloud
# unsorted, as the whole-cloud paths do.
KNN_EDGE_CASES = (
    ("window", 2, 128, 1, 128, 128, True, "uniform"),
    ("window", 1, 768, 60, 128, 768, True, "uniform"),
    ("window", 1, 1024, 30, 128, 1024, True, "uniform"),
    ("window", 1, 512, 16, 128, 384, False, "uniform"),
    ("window", 1, 384, 16, 128, 384, True, "repeated"),
    ("window", 1, 384, 16, 128, 384, True, "offset"),
    ("window", 1, 128, 128, 128, 128, True, "uniform"),
    ("window", 1, 384, 16, 64, 320, True, "uniform"),
    ("chunked", 2, 128, 16, 128, 128, True, "uniform"),
    ("chunked", 1, 512, 1, 128, 256, True, "uniform"),
    ("chunked", 1, 512, 30, 128, 384, True, "uniform"),
    ("chunked", 1, 1024, 30, 128, 1024, True, "uniform"),
    ("chunked", 1, 384, 16, 128, 384, False, "uniform"),
    ("chunked", 1, 384, 30, 128, 384, True, "repeated"),
    ("chunked", 1, 384, 16, 128, 384, True, "offset"),
    ("chunked", 1, 384, 30, 128, 384, True, "class0"),
    ("exact", 2, 256, 16, 128, 128, True, "uniform"),
    ("exact", 1, 1024, 30, 128, 1024, True, "uniform"),
    ("exact", 1, 512, 16, 128, 384, False, "uniform"),
    ("exact", 1, 384, 30, 128, 384, True, "repeated"),
    ("exact", 1, 384, 16, 128, 384, True, "offset"),
    ("exact", 1, 384, 128, 128, 384, True, "uniform"),
    ("exact", 1, 1280, 16, 128, None, True, "uniform"),
    ("exact", 1, 2000, 60, 125, None, True, "uniform"),
    ("exact", 1, 2039, 8, 1, None, True, "uniform"),
    ("exact", 1, 640, 16, 128, None, False, "uniform"),
    ("exact", 1, 1280, 16, 128, None, True, "repeated"),
    ("exact", 1, 1280, 16, 128, None, True, "equal"),
    ("exact", 1, 640, 16, 128, None, True, "offset"),
    ("exact", 1, 640, 90, 128, None, True, "offset"),
    ("exact", 2, 256, 1, 128, None, True, "uniform"),
    ("exact", 1, 1152, 128, 128, None, True, "uniform"),
    ("exact", 1, 3000, 128, 120, None, True, "uniform"),
    # exact keys at 128 < k <= 1024 (csrc/knn_exact_large.cu): k = 129, 256,
    # W and the kernel's limit, repeated and equal points, no self, B=2
    ("exact", 2, 1024, 129, 128, 768, True, "repeated"),
    ("exact", 1, 2048, 256, 128, 768, False, "uniform"),
    ("exact", 2, 1024, 300, 128, 768, True, "offset"),
    ("exact", 1, 768, 768, 128, 768, True, "uniform"),
    ("exact", 2, 2048, 129, 128, None, False, "repeated"),
    ("exact", 1, 2048, 301, 128, None, True, "repeated"),
    ("exact", 1, 1280, 256, 128, None, True, "equal"),
    ("exact", 1, 640, 640, 128, None, False, "uniform"),
    ("exact", 1, 3000, 840, 120, None, True, "uniform"),
    ("exact", 2, 2048, 1024, 128, None, True, "repeated"),
    ("exact", 1, 2048, 1024, 128, 1024, False, "uniform"),
)


def edge_cloud(torch, dev, seed, b, n, kind, sort=True):
    """The emulated test's clouds: uniform in a 3 m cube, curve-sorted unless
    `sort=False`; 'repeated' (every point twice), 'offset' (moved by 1e3: d²
    lost to cancellation), 'equal' (one point n times), 'class0' (unsorted,
    every 3rd point near the origin)."""
    from se3_equi_graph_registration_tpu_torch.ops import morton

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (b, n, 3)).astype(np.float32)
    if kind == "class0":
        x = rng.uniform(0.5, 1.0, (b, n, 3)).astype(np.float32)
        x[:, ::3] = rng.uniform(-0.1, 0.1, (b, len(range(0, n, 3)), 3))
        return torch.from_numpy(x).to(dev)
    if kind == "repeated":
        x[:, 1::2] = x[:, ::2]
    if kind == "offset":
        x += np.float32(1e3)
    if kind == "equal":
        x[:] = x[:, :1]
    if not sort:
        return torch.from_numpy(x).to(dev)
    _, xs, _ = morton.sort_by_curve(torch.zeros(b, n, 0), torch.from_numpy(x))
    return xs.contiguous().to(dev)


def surface_clouds(torch, dev, bsz, sort=True):
    """`bsz` bumpy-surface clouds at FPFH_N points, posed: the checkpoint-
    free path's k-NN input, curve-sorted (the fused path) or as sampled
    (`sort=False`, the default 'approx' path's whole-cloud k-NN)."""
    from se3_equi_graph_registration_tpu_torch.ops import morton

    x = torch.from_numpy(np.stack([p[0] @ p[2].T for p in surface_pairs(bsz, 100)])).to(dev)
    if not sort:
        return x.contiguous()
    _, xs, _ = morton.sort_by_curve(x[..., :0], x)
    return xs.contiguous()


def knn_pair(torch, fn, plain, x, what, **kw):
    """The warp and the thread kernel of one k-NN on x, each launched once
    and counted by variant (the thread kernel only where it takes k: up to
    ~840 exact keys); both must equal the plain version bit for bit. For
    `knn_window`, the warp launch must run the source `knn_window_source`
    names for the shape."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn

    counts = fn.launches_by_variant
    before = dict(counts)
    by_source = dict(knn.knn_window.launches_by_source)
    kernels = [("warp", fn(x, **kw))]
    torch.cuda.synchronize()
    thread_takes_k = True
    if fn is knn.knn_window:
        packed = kw.get("packed", False)
        source = knn.knn_window_source(packed, kw["window"], kw["k"])
        check(fn.launches_by_source[source] == by_source[source] + 1,
              f"{what}: the warp launch did not run csrc/{source}.cu "
              f"({fn.launches_by_source}, before {by_source})")
        smem = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
        try:
            knn.thread_queries_per_block(kw["k"], kw["tile"], packed, smem)
        except ValueError:
            thread_takes_k = False     # beyond its lists: the warp kernel alone
    if thread_takes_k:
        kernels.append(("thread", fn(x, variant="thread", **kw)))
        torch.cuda.synchronize()
    check({v: counts[v] - before[v] for v in counts} == {"warp": 1, "thread": len(kernels) - 1},
          f"{what}: launches by kernel {counts} (before {before})")
    ref = plain(x, **kw)
    for name, got in kernels:
        if not torch.equal(got, ref):
            bad = torch.nonzero(torch.any(got != ref, -1))
            b, q = bad[0].tolist()
            check(False, f"{what}: the {name} kernel's lists differ from the plain version in "
                  f"{len(bad)} rows; first (cloud {b}, query {q}): {got[b, q].tolist()} against "
                  f"{ref[b, q].tolist()}")


def knn_phase(torch, x, xs, k, tile, window):
    """B1 and B4, each kernel pair against its plain version and each other
    (bit for bit) and timed in the same run, at B=64 and at one cloud: B1
    packed at the served k=16/W=384 and at the checkpoint-free k=60/W=768,
    B4 at k=60/W=768, B1 exact at k=16/W=384 on the served clouds (`xs`,
    curve-sorted) and over the whole cloud at the engine default's k=16 on
    the unsorted served clouds (`x`) and at register_fpfh's default k=60 on
    unsorted surface clouds, B1 exact at k=300 (the large-k kernel) at
    W=768 and over the whole cloud; then the edge cases. Returns the
    knn_window, knn_exact_large and knn_chunked rows."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn

    dev = xs.device
    bsz, n, _ = xs.shape
    surf = surface_clouds(torch, dev, bsz)
    w1 = knn.knn_window
    cases = {
        "B1 packed": (w1, knn.knn_window_plain, xs, dict(k=k, tile=tile, window=window,
                                                          packed=True)),
        "B1 packed on surfaces": (w1, knn.knn_window_plain, surf,
                                  dict(k=FPFH_K, tile=FPFH_TILE, window=FPFH_WINDOW,
                                       packed=True)),
        "B4": (knn.knn_chunked, knn.knn_chunked_plain, surf, dict(k=FPFH_K, tile=FPFH_TILE,
                                                                   window=FPFH_WINDOW)),
        "B1 exact": (w1, knn.knn_window_plain, xs, dict(k=k, tile=tile, window=window,
                                                         packed=False)),
        "B1 whole cloud": (w1, knn.knn_window_plain, x, dict(k=k, tile=tile, window=None,
                                                              packed=False)),
        "B1 whole cloud on surfaces": (w1, knn.knn_window_plain,
                                       surface_clouds(torch, dev, bsz, sort=False),
                                       dict(k=FPFH_K, tile=FPFH_TILE, window=None,
                                            packed=False)),
    }
    stats = {}
    for name, (fn, plain, data, kw) in cases.items():
        for b in (bsz, 1):
            xb = data[:b].contiguous()
            w = kw["window"] or n
            what = f"{name} B={b} k={kw['k']} W={w}"
            knn_pair(torch, fn, plain, xb, what, **kw)
            ms = cuda_ms(torch, lambda: fn(xb, **kw), 20)
            thread = cuda_ms(torch, lambda: fn(xb, variant="thread", **kw), 20)
            plain_ms = cuda_ms(torch, lambda: plain(xb, **kw), 3) if b == bsz else None
            bb, bby = bound_ms(xb.numel() * 4 + n * b * kw["k"] * 4, n * b * w * 8, PEAK_FP32)
            stats[name, b] = dict(ms=ms, thread_ms=thread, plain_ms=plain_ms, bound_ms=bb,
                                  bound_by=bby)
            log(f"knn {what}: warp and thread kernels identical to the plain version; warp "
                f"{ms:.4f} ms, thread {thread:.4f} ms ({thread / ms:.2f}x)"
                + (f", plain {plain_ms:.3f} ms" if plain_ms else "")
                + f", bound {bb:.4f} ms ({bby}; warp at {100 * bb / ms:.2f}%, thread at "
                f"{100 * bb / thread:.2f}%)")
    # exact keys at k = 300 (csrc/knn_exact_large.cu), over the fused path's
    # window and over the whole cloud, beside the thread kernel (csrc/knn.cu,
    # in blocks of fewer queries than the tile once the lists outgrow 128 a
    # block), the plain version and torch.topk over the plain version's d²
    for name, data, w in (("B1 exact large k", surf, FPFH_WINDOW),
                          ("B1 whole cloud large k",
                           surface_clouds(torch, dev, bsz, sort=False), None)):
        kw = dict(k=KNN_LARGE_K, tile=FPFH_TILE, window=w, packed=False)
        for b in (bsz, 1):
            xb = data[:b].contiguous()
            what = f"{name} B={b} k={KNN_LARGE_K} W={w or n}"
            knn_pair(torch, w1, knn.knn_window_plain, xb, what, **kw)
            ms = cuda_ms(torch, lambda: w1(xb, **kw), 20)
            thread = cuda_ms(torch, lambda: w1(xb, variant="thread", **kw), 10 if w else 3)
            plain_ms = topk_ms = None
            if b == bsz:
                plain_ms = cuda_ms(torch, lambda: knn.knn_window_plain(xb, **kw), 3)
                d2, _ = knn.window_sq_dists(xb, FPFH_TILE, w or n)
                topk_ms = cuda_ms(torch, lambda: torch.topk(d2, KNN_LARGE_K, largest=False), 3)
                del d2
            bb, bby = bound_ms(xb.numel() * 4 + n * b * KNN_LARGE_K * 4, n * b * (w or n) * 8,
                               PEAK_FP32)
            stats[name, b] = dict(ms=ms, thread_ms=thread, plain_ms=plain_ms, bound_ms=bb,
                                  bound_by=bby, topk_ms=topk_ms)
            log(f"knn {what}: the large-k warp kernel and the thread kernel identical to the "
                f"plain version; warp {ms:.4f} ms, thread {thread:.4f} ms ({thread / ms:.2f}x)"
                + (f", plain {plain_ms:.3f} ms ({plain_ms / ms:.2f}x the warp kernel), "
                   f"torch.topk over the plain d² {topk_ms:.3f} ms" if plain_ms else "")
                + f", bound {bb:.4f} ms ({bby}; warp at {100 * bb / ms:.2f}%, thread at "
                f"{100 * bb / thread:.2f}%)")
    for i, (kind, b, n_, k_, t_, w_, inc, cloud) in enumerate(KNN_EDGE_CASES):
        x_ = edge_cloud(torch, dev, i, b, n_, cloud, sort=w_ is not None)
        kw = dict(k=k_, tile=t_, window=w_, include_self=inc)
        what = f"edge case {i} ({kind} b={b} n={n_} k={k_} T={t_} W={w_} self={inc} {cloud})"
        if kind == "chunked":
            knn_pair(torch, knn.knn_chunked, knn.knn_chunked_plain, x_, what, **kw)
        else:
            knn_pair(torch, w1, knn.knn_window_plain, x_, what, packed=kind == "window", **kw)
    log(f"knn edge cases: {len(KNN_EDGE_CASES)} (packed and chunked: W 128-1024, k 1-128, no "
        "self, repeated points, offset 1e3, class 0, B=1 and 2; exact: W 128-1024 and the "
        "whole cloud at N 256-3000 over 1-3 chunks, tiles 1, 120, 125 and 128, k 1-128 and, "
        "on the large-k kernel, 129, 256, 300, 301, 640, 768, 840 and 1024, no self, repeated "
        "and equal points, offset 1e3, B=1 and 2): warp and thread kernels (the thread kernel "
        "to k = 840) identical to the plain version")

    def row(name, source, thread_source, replaces, case, extra):
        big, one = stats[case, bsz], stats[case, 1]
        return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                    max_abs_err=0.0, ms=big["ms"], plain_ms=big["plain_ms"],
                    bound_ms=big["bound_ms"], bound_by=big["bound_by"], library_ms=None,
                    variant="warp", thread_ms=big["thread_ms"], ms_b1=one["ms"],
                    thread_ms_b1=one["thread_ms"], bound_ms_b1=one["bound_ms"],
                    launches_by_variant={"warp": 0, "thread": 0},
                    thread_source=thread_source, **extra)

    def shape(case):
        big, one = stats[case, bsz], stats[case, 1]
        return dict(ms=big["ms"], thread_ms=big["thread_ms"], plain_ms=big["plain_ms"],
                    bound_ms=big["bound_ms"], ms_b1=one["ms"], thread_ms_b1=one["thread_ms"],
                    bound_ms_b1=one["bound_ms"])

    src = "se3_equi_graph_registration_tpu_torch/csrc/"
    b1 = "se3_equi_graph_registration_tpu/ops/pallas/knn_kernel.py:26"
    shapes = {"packed k=60 W=768": shape("B1 packed on surfaces"),
              f"exact k={k} W={window}": shape("B1 exact"),
              f"exact whole cloud k={k} N={n}": shape("B1 whole cloud"),
              f"exact whole cloud k={FPFH_K} N={n}": shape("B1 whole cloud on surfaces")}
    large = {f"exact whole cloud k={KNN_LARGE_K} N={n}": dict(
        shape("B1 whole cloud large k"), topk_ms=stats["B1 whole cloud large k", bsz]["topk_ms"])}
    return (row("knn_window", src + "knn_warp.cu", src + "knn.cu", b1, "B1 packed",
                dict(exact_source=src + "knn_exact_warp.cu", shapes=shapes)),
            row("knn_exact_large", src + "knn_exact_large.cu", src + "knn.cu", b1,
                "B1 exact large k", dict(k=KNN_LARGE_K, window=FPFH_WINDOW, shapes=large,
                                         topk_ms=stats["B1 exact large k", bsz]["topk_ms"])),
            row("knn_chunked", src + "knn_chunked_warp.cu", src + "knn_chunked.cu",
                "se3_equi_graph_registration_tpu/ops/pallas/knn_kernel.py:93", "B4", {}))


def egcl_tile_checks(torch, p, h, xs, nbr, gen):
    """The tile kernel from the bottom up: one bare mma tile against a
    matrix product, its per-edge stages (first layer, then the chain to the
    LayerNorm) against the plain version's, then the layer in every case the
    kernel has a path for."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    dev = h.device
    a = torch.randn(16, 16, generator=gen).to(torch.bfloat16).to(dev)
    w = torch.randn(32, 16, generator=gen).to(dev)
    got = egcl.mma_tile_probe(a, w)
    torch.cuda.synchronize()
    ref = a.double() @ w[:8].to(torch.bfloat16).double().T
    err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    check(err <= 1e-5 * scale, f"mma tile: max|Δ| {err} against scale {scale}")
    log(f"egcl tile: one mma.m16n8k16 tile vs matmul max|Δ| {err:.3g} (scale {scale:.3g})")

    b8 = min(8, h.shape[0])
    h8, x8, nbr8 = h[:b8].contiguous(), xs[:b8].contiguous(), nbr[:b8].contiguous()
    s1, m = egcl.egcl_tile_stages(h8, x8, nbr8, p)
    torch.cuda.synchronize()
    _, rs1, rm, _ = egcl.edge_stages_plain(h8, x8, nbr8, p, accurate=False)
    for name, g_, r_ in (("s1 (first layer)", s1, rs1), ("m (chain to LayerNorm)", m, rm)):
        err, scale = (g_ - r_).abs().max().item(), r_.abs().max().item()
        check(err <= 2e-2 * scale, f"egcl tile stage {name}: max|Δ| {err} against scale {scale}")
        log(f"egcl tile stage {name} B={b8}: max|Δ| {err:.3g} (rel {err / scale:.3g})")

    p1 = egcl.params_from_layer(EGNN(in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1,
                                     num_heads=1).to(dev).gcl_0)
    x_dup = x8.clone()
    x_dup[:, 1::2] = x_dup[:, ::2]                 # every point twice: degenerate frames
    k = nbr.shape[-1]
    wide = torch.cat([nbr8, nbr8.flip(1)[..., :4]], dim=-1).contiguous()
    cases = [(f"K={k}, head width {p.head_width}", h8, x8, nbr8, p),
             ("K=12", h8, x8, nbr8[..., :12].contiguous(), p),
             (f"K={k + 4} (two row tiles)", h8, x8, wide, p),
             ("head width 32", h8, x8, nbr8, p1),
             ("repeated points", h8, x_dup, nbr8, p),
             ("B=1", h8[:1].contiguous(), x8[:1].contiguous(), nbr8[:1].contiguous(), p)]
    for name, h_, x_, nbr_, p_ in cases:
        check(egcl.egcl_variant(h_.shape[-1], nbr_.shape[-1], p_.head_width, False) == "tile",
              f"egcl tile case {name} is not routed to the tile kernel")
        gh, gx, gm = egcl.egcl_layer(h_, x_, nbr_, p_, False, return_aggm=True)
        gh2, gx2 = egcl.egcl_layer(h_, x_, nbr_, p_, False)
        torch.cuda.synchronize()
        check(torch.equal(gh, gh2) and torch.equal(gx, gx2),
              f"egcl tile case {name}: asking for agg_m changed h′ or x′")
        rh, rx, rm = egcl.egcl_layer_plain(h_, x_, nbr_, p_, False, return_aggm=True)
        check(all(bool(torch.isfinite(t_).all()) for t_ in (gh, gx, gm)),
              f"egcl tile case {name}: non-finite output")
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), (rh, rx), x_, accurate=False)
        em, sm = (gm - rm).abs().max().item(), rm.abs().max().item()
        check(em <= 2e-2 * sm, f"egcl tile case {name}: agg_m max|Δ| {em} against scale {sm}")
        log(f"egcl tile case {name} B={h_.shape[0]}: rel h′ {eh / sh:.3g}, u {eu / su:.3g}, "
            f"agg_m {em / sm:.3g}; same with and without agg_m")


def f32_cases(torch, p, h8, x8, nbr8):
    """The cases of the fp32 tile kernels at B=8: (name, h, x, nbr, p) for
    K=16, 12, 7 (masked rows) and 20 (two row tiles), head widths 8, 32 and
    1, repeated points and points on a line through the origin (x_i × x_j =
    0 exactly: the identity frame on every edge), and B=1."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    dev = h8.device
    layer = lambda heads: egcl.params_from_layer(EGNN(
        in_node_nf=32, hidden_nf=32, out_node_nf=32, n_layers=1, num_heads=heads).to(dev).gcl_0)
    x_dup = x8.clone()
    x_dup[:, 1::2] = x_dup[:, ::2]                 # every point twice: degenerate frames
    x_line = (x8[..., :1] * torch.tensor([1.0, -1.0, 1.0], device=dev)).contiguous()
    k = nbr8.shape[-1]
    wide = torch.cat([nbr8, nbr8.flip(1)[..., :4]], dim=-1).contiguous()
    return [(f"K={k}, head width {p.head_width}", h8, x8, nbr8, p),
            ("K=12", h8, x8, nbr8[..., :12].contiguous(), p),
            ("K=7", h8, x8, nbr8[..., :7].contiguous(), p),
            (f"K={k + 4} (two row tiles)", h8, x8, wide, p),
            ("head width 32", h8, x8, nbr8, layer(1)),
            ("head width 1", h8, x8, nbr8, layer(32)),
            ("repeated points", h8, x_dup, nbr8, p),
            ("collinear points", h8, x_line, nbr8, p),
            ("B=1", h8[:1].contiguous(), x8[:1].contiguous(), nbr8[:1].contiguous(), p)]


def c33_inputs(torch, xs, nbr, gen):
    """KITTI's layer shape, C=33 with one head: (p33, its weights seeded
    apart from the smoke's other draws; h [B,N,33] from gen), on the clouds
    xs and the graph nbr of the C=32 checks."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    dev = xs.device
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(33)
        m33 = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=1)
    p33 = egcl.params_from_layer(m33.to(dev).gcl_0)
    return p33, torch.randn(*xs.shape[:2], 33, generator=gen).to(dev)


def c33_cases(torch, p33, h8, x8, nbr8):
    """The cases of the fp32 tile kernels built at CP=36, at C=33 with one
    head and B=8: (name, h, x, nbr, p) for K=16, 7 (masked rows) and 20 (two
    row tiles), repeated points and B=1."""
    x_dup = x8.clone()
    x_dup[:, 1::2] = x_dup[:, ::2]                 # every point twice: degenerate frames
    k = nbr8.shape[-1]
    wide = torch.cat([nbr8, nbr8.flip(1)[..., :4]], dim=-1).contiguous()
    return [(f"C=33, K={k}", h8, x8, nbr8, p33),
            ("C=33, K=7", h8, x8, nbr8[..., :7].contiguous(), p33),
            (f"C=33, K={k + 4} (two row tiles)", h8, x8, wide, p33),
            ("C=33, repeated points", h8, x_dup, nbr8, p33),
            ("C=33, B=1", h8[:1].contiguous(), x8[:1].contiguous(), nbr8[:1].contiguous(), p33)]


def egcl_bound(c, wh, b, n, k, weights):
    """B2's least time at width c and head width wh over b clouds (fp32
    peak): its FLOP an edge and a center, each input read once."""
    edge_ops = 2 * c * (c + 12) + 2 * c * wh + 2 * c * c + 2 * c + 12 * c
    center_ops = 2 * c * c + 2 * 2 * c * c + 2 * c * c
    ops = b * n * (k * edge_ops + center_ops)
    nbytes = 4 * b * n * (2 * c + 6 + k) + weights * 4
    return ops, nbytes


def egcl_backward_bound(c, wh, b, n, k, weights):
    """B3's FLOP and bytes at width c and head width wh over b clouds."""
    fwd_edge = 2 * c * (c + 12) + 2 * c * wh + 2 * c * c + 2 * c + 12 * c
    bwd_edge = (2 * c * c * 4 + 2 * c * wh * 2 + 2 * 12 * c * 2 + 2 * c   # products
                + 20 * c + 150)                                          # LN, SiLU, geometry
    center = 3 * 2 * c * c
    ops = b * n * (k * (fwd_edge + bwd_edge) + center)
    nbytes = 4 * b * n * (2 * c + 6 + k) + 2 * 4 * b * n * (c + 3) + weights * 4
    return ops, nbytes


def egcl_f32_checks(torch, p, h, xs, nbr):
    """The fp32 tile forward in every case of `f32_cases`, with and without
    agg_m, against the plain accurate version (1e-4 of the scale on h′, the
    update and agg_m)."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    b8 = min(8, h.shape[0])
    cases = f32_cases(torch, p, h[:b8].contiguous(), xs[:b8].contiguous(),
                      nbr[:b8].contiguous())
    for name, h_, x_, nbr_, p_ in cases:
        check(egcl.egcl_variant(h_.shape[-1], nbr_.shape[-1], p_.head_width, True) == "tile_f32",
              f"egcl f32 case {name} is not routed to the fp32 tile kernel")
        reset_egcl_counters(egcl)
        gh, gx, gm = egcl.egcl_layer(h_, x_, nbr_, p_, True, return_aggm=True)
        gh2, gx2 = egcl.egcl_layer(h_, x_, nbr_, p_, True)
        torch.cuda.synchronize()
        check(egcl.egcl_layer.launches_by_variant == only("tile_f32", 2),
              f"egcl f32 case {name} launched {egcl.egcl_layer.launches_by_variant}")
        check(torch.equal(gh, gh2) and torch.equal(gx, gx2),
              f"egcl f32 case {name}: asking for agg_m changed h′ or x′")
        rh, rx, rm = egcl.egcl_layer_plain(h_, x_, nbr_, p_, True, return_aggm=True)
        check(all(bool(torch.isfinite(t_).all()) for t_ in (gh, gx, gm)),
              f"egcl f32 case {name}: non-finite output")
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), (rh, rx), x_, accurate=True)
        em, sm = (gm - rm).abs().max().item(), rm.abs().max().item()
        check(em <= 1e-4 * sm, f"egcl f32 case {name}: agg_m max|Δ| {em} against scale {sm}")
        log(f"egcl f32 case {name} B={h_.shape[0]}: rel h′ {eh / sh:.3g}, u {eu / su:.3g}, "
            f"agg_m {em / sm:.3g}; same with and without agg_m")


def egcl_phase(torch, p, h, xs, nbr, gen):
    """B2 against its plain version: the bf16 tile kernel from the bottom up
    and the fp32 tile kernel in every case, then at the main path's shape
    the fp32 tile and SIMT kernels in accurate mode and the bf16 tile and
    SIMT kernels in fast mode, each timed beside the plain version and the
    two kernels of a mode held against each other (C=33 is
    `egcl_c33_phase`'s). Returns the rows of the bf16 and the fp32 tile
    kernels at C=32."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    bsz, n, c = h.shape
    k = nbr.shape[-1]
    egcl_tile_checks(torch, p, h, xs, nbr, gen)
    egcl_f32_checks(torch, p, h, xs, nbr)
    packed = egcl.pack_for_kernels(p)
    stats, outs, plains = {}, {}, {}
    for name, accurate, variant in (("accurate tile_f32", True, "tile_f32"),
                                    ("accurate simt", True, "simt"),
                                    ("fast tile", False, "tile"), ("fast simt", False, "simt")):
        reset_egcl_counters(egcl)
        gh, gx = egcl.egcl_layer(h, xs, nbr, p, accurate, packed, variant=variant)
        torch.cuda.synchronize()
        check(egcl.egcl_layer.launches_by_variant == only(variant, 1),
              f"egcl[{name}] launched {egcl.egcl_layer.launches_by_variant}")
        ref = egcl.egcl_layer_plain(h, xs, nbr, p, accurate)
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), ref, xs, accurate)
        ms = cuda_ms(torch, lambda: egcl.egcl_layer(h, xs, nbr, p, accurate, packed,
                                                     variant=variant), 10)
        if accurate not in plains:
            plains[accurate] = cuda_ms(torch, lambda: egcl.egcl_layer_plain(h, xs, nbr, p,
                                                                             accurate), 3)
        stats[name], outs[name] = (ms, plains[accurate], max(eh, eu)), (gh, gx)
        log(f"egcl[{name}] B={bsz} N={n} C={c} K={k}: max|Δh′| {eh:.3g} (rel {eh / sh:.3g}), "
            f"max|Δu| {eu:.3g} (rel {eu / su:.3g} of the update scale {su:.3g}), "
            f"kernel {ms:.4f} ms, plain {plains[accurate]:.3f} ms")
    # the two kernels of a mode against each other: one function, two orders of summation
    ulp = torch.finfo(torch.float32).eps * xs.abs().max().item()
    for a, b, tol_h, tol_u in (("fast tile", "fast simt", 2 * 2e-2, 2 * 1e-2),
                               ("accurate tile_f32", "accurate simt", 2e-4, 2e-4)):
        (th, tx), (sh_, sx) = outs[a], outs[b]
        dh, hs = (th - sh_).abs().max().item(), sh_.abs().max().item()
        du, us = ((tx - xs) - (sx - xs)).abs().max().item(), (sx - xs).abs().max().item()
        check(dh <= tol_h * hs and du <= tol_u * us + ulp,
              f"egcl {a} vs {b}: max|Δh′| {dh} (scale {hs}), max|Δu| {du} (scale {us})")
        log(f"egcl {a} vs {b}: max|Δh′| {dh:.3g} (rel {dh / hs:.3g}), max|Δu| {du:.3g} "
            f"(rel {du / us:.3g})")
    ops, nbytes = egcl_bound(c, p.head_width, bsz, n, k, packed.simt.numel())
    fb, fby = bound_ms(nbytes, ops, PEAK_BF16)
    ab, aby = bound_ms(nbytes, ops, PEAK_FP32)
    log(f"egcl bound: {ops / (bsz * n * k):.0f} FLOP/edge; fast vs bf16 peak {fb:.4f} ms "
        f"(tile at {100 * fb / stats['fast tile'][0]:.2f}%), accurate vs fp32 peak {ab:.4f} ms "
        f"(tile_f32 at {100 * ab / stats['accurate tile_f32'][0]:.2f}%, SIMT at "
        f"{100 * ab / stats['accurate simt'][0]:.2f}%)")
    src = "se3_equi_graph_registration_tpu_torch/csrc/"
    replaces = "se3_equi_graph_registration_tpu/ops/pallas/egcl_kernel.py:116"
    row = lambda name, source, stat, simt, bound, by, variant: dict(
        name=name, route="cuda", source=src + source, replaces=replaces, launches=0,
        max_abs_err=stats[stat][2], ms=stats[stat][0], plain_ms=stats[stat][1], bound_ms=bound,
        bound_by=by, library_ms=None, variant=variant, simt_ms=stats[simt][0],
        simt_source=src + "egcl.cu")
    return (row("egcl_layer", "egcl_tile.cu", "fast tile", "fast simt", fb, fby, "tile"),
            row("egcl_layer_f32", "egcl_tile_f32.cu", "accurate tile_f32", "accurate simt", ab,
                aby, "tile_f32"))


def egcl_c33_phase(torch, xs, nbr, gen):
    """B2 at KITTI's width (C=33, one head) on the tile kernels built at a
    padded width, in both modes (`egcl_c33_mode`): accurate on the fp32
    kernel at CP=36, fast on the bf16 kernel at CP=48. Returns their rows,
    fp32 then bf16."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    p33, h33 = c33_inputs(torch, xs, nbr, gen)
    packed = egcl.pack_for_kernels(p33)
    check(packed.f32 is not None and packed.f32.numel() == 15552 and packed.tile is not None
          and packed.tile.numel() == 8832 and packed.tile_bwd.numel() == 4992,
          "egcl C=33: the tile buffers are not the CP=36 and CP=48 ones")
    p3 = c33_heads3(torch, xs.device)
    return tuple(egcl_c33_mode(torch, p33, p3, packed, h33, xs, nbr, accurate)
                 for accurate in (True, False))


def c33_heads3(torch, dev):
    """A C=33 layer with three heads of 11 (heads that straddle the
    16-channel k-steps), seeded apart from the smoke's other draws."""
    from se3_equi_graph_registration_tpu_torch.models.egnn import EGNN
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(11)
        m = EGNN(in_node_nf=33, hidden_nf=33, out_node_nf=33, n_layers=1, num_heads=3)
    return egcl.params_from_layer(m.to(dev).gcl_0)


def egcl_c33_mode(torch, p33, p3, packed, h33, xs, nbr, accurate):
    """B2 at C=33 in one mode on its tile kernel ('tile_f32' built at CP=36
    in accurate mode, 'tile' at CP=48 in fast mode): in fast mode first its
    per-edge stages s1 and m against the plain fast version's at 2e-2 of
    the scale; then the layer in every case of `c33_cases` and with three
    heads of 11 (`p3`), with and without agg_m, against the plain version
    at the mode's tolerance (`egcl_errors`; agg_m as h′); then at B=8 and
    at the run's batch the tile and the SIMT kernel (`variant='simt'`),
    each against the plain version, against each other at twice the
    tolerance and timed, with the bound at C=33 on the mode's peak. Returns
    the kernel's row (its numbers at the run's batch, B=8's under `b8`)."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl

    bsz, n = xs.shape[:2]
    b8 = min(8, bsz)
    tile = "tile_f32" if accurate else "tile"
    cp = egcl.f32_width(33) if accurate else egcl.tile_width(33)
    mode = f"{'accurate' if accurate else 'fast'} {tile} CP={cp}"
    tol_h, tol_u = (1e-4, 1e-4) if accurate else (2e-2, 1e-2)
    h8, x8, nbr8 = h33[:b8].contiguous(), xs[:b8].contiguous(), nbr[:b8].contiguous()
    if not accurate:
        s1, m = egcl.egcl_tile_stages(h8, x8, nbr8, p33)
        torch.cuda.synchronize()
        _, rs1, rm, _ = egcl.edge_stages_plain(h8, x8, nbr8, p33, accurate=False)
        for name, g_, r_ in (("s1 (first layer)", s1, rs1), ("m (chain to LayerNorm)", m, rm)):
            err, scale = (g_ - r_).abs().max().item(), r_.abs().max().item()
            check(err <= 2e-2 * scale,
                  f"egcl C=33 tile stage {name}: max|Δ| {err} against scale {scale}")
            log(f"egcl {mode} stage {name} B={b8}: max|Δ| {err:.3g} (rel {err / scale:.3g})")
    for name, h_, x_, nbr_, p_ in c33_cases(torch, p33, h8, x8, nbr8) + [
            ("C=33, 3 heads of 11", h8, x8, nbr8, p3)]:
        check(egcl.egcl_variant(33, nbr_.shape[-1], p_.head_width, accurate) == tile,
              f"egcl case {name} is not routed to the {tile} kernel")
        reset_egcl_counters(egcl)
        gh, gx, gm = egcl.egcl_layer(h_, x_, nbr_, p_, accurate, return_aggm=True)
        gh2, gx2 = egcl.egcl_layer(h_, x_, nbr_, p_, accurate)
        torch.cuda.synchronize()
        check(egcl.egcl_layer.launches_by_variant == only(tile, 2),
              f"egcl case {name} launched {egcl.egcl_layer.launches_by_variant}")
        check(torch.equal(gh, gh2) and torch.equal(gx, gx2),
              f"egcl case {name}: asking for agg_m changed h′ or x′")
        rh, rx, rm = egcl.egcl_layer_plain(h_, x_, nbr_, p_, accurate, return_aggm=True)
        check(all(bool(torch.isfinite(t_).all()) for t_ in (gh, gx, gm)),
              f"egcl case {name}: non-finite output")
        eh, eu, sh, su = egcl_errors(torch, (gh, gx), (rh, rx), x_, accurate)
        em, sm = (gm - rm).abs().max().item(), rm.abs().max().item()
        check(em <= tol_h * sm, f"egcl case {name}: agg_m max|Δ| {em} against scale {sm}")
        log(f"egcl {mode} case {name} B={h_.shape[0]}: rel h′ {eh / sh:.3g}, u {eu / su:.3g}, "
            f"agg_m {em / sm:.3g}; same with and without agg_m")
    stats = {}
    ulp = torch.finfo(torch.float32).eps * xs.abs().max().item()
    for b in sorted({b8, bsz}):
        h_, x_, nbr_ = h33[:b].contiguous(), xs[:b].contiguous(), nbr[:b].contiguous()
        k = nbr_.shape[-1]
        ref = egcl.egcl_layer_plain(h_, x_, nbr_, p33, accurate)
        plain = cuda_ms(torch, lambda: egcl.egcl_layer_plain(h_, x_, nbr_, p33, accurate), 3)
        outs = {}
        for variant in (tile, "simt"):
            reset_egcl_counters(egcl)
            got = egcl.egcl_layer(h_, x_, nbr_, p33, accurate, packed, variant=variant)
            torch.cuda.synchronize()
            check(egcl.egcl_layer.launches_by_variant == only(variant, 1),
                  f"egcl C=33 {variant} launched {egcl.egcl_layer.launches_by_variant}")
            eh, eu, sh, su = egcl_errors(torch, got, ref, x_, accurate)
            ms = cuda_ms(torch, lambda: egcl.egcl_layer(h_, x_, nbr_, p33, accurate, packed,
                                                         variant=variant), 10)
            stats[b, variant] = (ms, plain, max(eh, eu))
            outs[variant] = got
            log(f"egcl[C=33, 1 head, {'accurate' if accurate else 'fast'} {variant}] B={b} "
                f"N={n} K={k}: max|Δh′| {eh:.3g} (rel {eh / sh:.3g}), max|Δu| {eu:.3g} "
                f"(rel {eu / su:.3g}), kernel {ms:.4f} ms, plain {plain:.3f} ms")
        (th, tx), (sh_, sx) = outs[tile], outs["simt"]
        dh, hs = (th - sh_).abs().max().item(), sh_.abs().max().item()
        du, us = ((tx - x_) - (sx - x_)).abs().max().item(), (sx - x_).abs().max().item()
        check(dh <= 2 * tol_h * hs and du <= 2 * tol_u * us + ulp,
              f"egcl C=33 {tile} vs simt B={b}: max|Δh′| {dh} (scale {hs}), max|Δu| {du} "
              f"(scale {us})")
        ops, nbytes = egcl_bound(33, p33.head_width, b, n, k, packed.simt.numel())
        bound, by = bound_ms(nbytes, ops, PEAK_FP32 if accurate else PEAK_BF16)
        stats[b, "bound"] = (bound, by)
        tile_ms, simt_ms = stats[b, tile][0], stats[b, "simt"][0]
        log(f"egcl C=33 {mode} B={b}: {tile} vs simt max|Δh′| {dh:.3g} (rel {dh / hs:.3g}), "
            f"max|Δu| {du:.3g} (rel {du / us:.3g}); bound {ops / (b * n * k):.0f} FLOP/edge, "
            f"{bound:.4f} ms ({by}, {'fp32' if accurate else 'bf16'} peak); {tile} "
            f"{tile_ms:.4f} ms at {100 * bound / tile_ms:.2f}%, SIMT {simt_ms:.4f} ms at "
            f"{100 * bound / simt_ms:.2f}% ({simt_ms / tile_ms:.2f}x); {card_line()}")
    src = "se3_equi_graph_registration_tpu_torch/csrc/"
    return c33_row(stats, "egcl_layer_f32_cp36" if accurate else "egcl_layer_cp48",
                   src + ("egcl_tile_f32.cu" if accurate else "egcl_tile.cu"),
                   "se3_equi_graph_registration_tpu/ops/pallas/egcl_kernel.py:116",
                   src + "egcl.cu", bsz, b8, tile, cp)


def c33_row(stats, name, source, replaces, simt_source, bsz, b8, variant, cp):
    """A kernel row of a tile kernel built at the padded width cp (the fp32
    one at 36, the bf16 one at 48), from a C=33 phase's stats: the numbers
    at the run's batch, B=8's under `b8`."""
    at = lambda b: dict(ms=stats[b, variant][0], plain_ms=stats[b, variant][1],
                        bound_ms=stats[b, "bound"][0], bound_by=stats[b, "bound"][1],
                        simt_ms=stats[b, "simt"][0])
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0,
                max_abs_err=max(stats[b, variant][2] for b in {b8, bsz}), **at(bsz),
                library_ms=None, variant=variant, width=f"C=33, one head, built at CP={cp}",
                simt_source=simt_source, b8=at(b8))


def serve_gap(a, b, what, sim=True):
    """Two register() answers (card, CPU) held at the serve gate: finite, det R
    = 1, ‖ΔR‖_F/√2 and |Δt| ≤ 2e-3, covariance and similarity mean within 2e-2
    relative; returns the (ΔR, Δt, Δcov, Δsim) gaps. sim=False: a
    BatchingServer answer carries its coalesced batch's similarity mean, not
    its own."""
    Ra, ta, ia = a
    Rb, tb, ib = b
    dR = np.linalg.norm(np.asarray(Ra) - Rb, axis=(-2, -1)).max() / np.sqrt(2)
    dt = np.abs(np.asarray(ta) - tb).max()
    ca, cb = np.asarray(ia["pose_covariance"]), np.asarray(ib["pose_covariance"])
    dc = np.abs(ca - cb).max() / np.abs(cb).max()
    ds = (abs(ia["similarity_mean"] - ib["similarity_mean"])
          / abs(ib["similarity_mean"]) if sim else 0.0)
    check(np.all(np.isfinite(Ra)) and np.all(np.isfinite(ta)) and np.all(np.isfinite(ca)),
          f"{what}: non-finite output")
    check(np.abs(np.linalg.det(Ra) - 1).max() < 1e-3, f"{what}: det R != 1")
    check(dR <= 2e-3 and dt <= 2e-3 and dc <= 2e-2 and ds <= 2e-2,
          f"{what}: card vs CPU dR {dR} dt {dt} dcov {dc} dsim {ds}")
    return dR, dt, dc, ds


def serve_phase(torch, dev, cfg, bsz, sd, rows):
    """The served path: Registrar.register and BatchingServer at `cfg`
    against the same Registrar on the CPU, with the launch counters; the
    engine's other configurations; pairs/s and two profiles."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn

    n = cfg.num_nodes
    reg = serving.Registrar(sd, cfg, device=dev)
    cpu_reg = serving.Registrar(sd, cfg, device="cpu")
    reqs = make_pair_batch(np.random.default_rng(1), batch=bsz, n=n, feat_dim=cfg.in_node_nf)
    args = lambda sl: (reqs.src_pts[sl], reqs.src_feat[sl], reqs.tgt_pts[sl], reqs.tgt_feat[sl])

    same = serve_gap
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    per_call = []

    def counted(fn):
        k0, e0 = knn.knn_window.launches, egcl.egcl_layer.launches
        out = fn()
        per_call.append((knn.knn_window.launches - k0, egcl.egcl_layer.launches - e0))
        return out

    t_serve = time.perf_counter()
    calls = [(f"B=1 #{i}", i) for i in range(3)] + [
        (f"B={b}", slice(0, b)) for b in (16, bsz)]
    results = [(name, sl, counted(lambda: reg.register(*args(sl))))
               for name, sl in calls]
    server = serving.BatchingServer(reg, max_batch=4, max_wait_ms=20)
    try:
        futs = [server.submit(*args(i)) for i in range(3)]
        served = [f.result(timeout=300) for f in futs]
    finally:
        server.close()
    check(not server._thread.is_alive(), "BatchingServer thread still running")
    rates = {}
    for b, reps in ((1, 20), (16, 10), (bsz, 5)):
        sl = slice(0, b) if b > 1 else 0
        reg.register(*args(sl))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            reg.register(*args(sl))
        rates[b] = b * reps / (time.perf_counter() - t1)
    launches = (knn.knn_window.launches, egcl.egcl_layer.launches)
    by_variant = dict(egcl.egcl_layer.launches_by_variant)
    knn_by_variant = check_knn_warp(knn.knn_window, "serve")
    log(f"serve: main path run {time.perf_counter() - t_serve:.1f} s, launches knn "
        f"{launches[0]} ({knn_by_variant}) egcl {launches[1]} ({by_variant})")
    for kd, ed in per_call:
        check(kd == 2 and ed == 2 * cfg.n_layers,
              f"register() launched knn {kd}, egcl {ed} (want 2, {2 * cfg.n_layers})")
    check(launches[0] > 0 and launches[1] > 0, "a kernel of the path never launched")
    want = egcl.egcl_variant(cfg.hidden_nf, cfg.k, cfg.hidden_nf // cfg.num_heads,
                             cfg.egnn_accurate)
    check(by_variant == only(want, launches[1]),
          f"serve: EGCL launches by kernel {by_variant}, want all {launches[1]} {want}")
    record_launches(rows, "serve", dict(knn_window=launches[0],
                                        **by_row("egcl_layer", by_variant)),
                    dict(knn_window=knn_by_variant))

    other_configs(torch, dev, cfg, sd, args, same, rows)

    for name, sl, res in results:
        t1 = time.perf_counter()
        dR, dt, _, _ = same(res, cpu_reg.register(*args(sl)), f"register {name}")
        log(f"register {name}: card vs CPU max‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m "
            f"(CPU run {time.perf_counter() - t1:.1f} s)")
    for i, res in enumerate(served):
        same(res, reg.register(*args(i)), f"BatchingServer request {i}", sim=False)
    log("BatchingServer: 3 concurrent submits answered, equal to register()")
    log("pairs/s (register(), host clock incl. H2D and result copy): "
        + ", ".join(f"B={b}: {r:.1f}" for b, r in rates.items()))
    profile_call(torch, lambda: reg.register(*args(0)), "register() B=1")
    profile_call(torch, lambda: reg.register(*args(slice(0, bsz))), f"register() B={bsz}")


def grad_cosines(torch, a, b):
    """{name: (cosine, relative L2)} of two gradient dicts."""
    out = {}
    for name, ga in a.items():
        x, y = ga.double().flatten(), b[name].double().flatten()
        cos = float(x @ y / (x.norm() * y.norm()).clamp_min(1e-300))
        out[name] = (cos, float((x - y).norm() / y.norm().clamp_min(1e-300)))
    return out


def train_phase(torch, dev, cfg, bsz, rows):
    """The training path at `cfg`: seeded weights and Adam, one warm step and
    5 timed steps at `bsz` with the launch counters; an accurate step at B=2
    on the card against the same step on the CPU; the fast-against-accurate
    gradient table at B=8; a profile of one warm step."""
    import dataclasses

    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import engine

    rng = np.random.default_rng(2)
    batch = lambda b, dv: engine.batch_to_device(
        tuple(make_pair_batch(rng, batch=b, n=cfg.num_nodes, feat_dim=cfg.in_node_nf)), dv)
    state = engine.init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = engine.make_train_step(state.model, state.optimizer, cfg)
    batches = [batch(bsz, dev) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batches[1])
    torch.cuda.synchronize()
    counters = (knn.knn_window, egcl.egcl_layer, eb.egcl_backward)
    for fn in counters:
        fn.launches = 0
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    reset_backward_counters(eb)
    per_step, totals = [], []
    t0 = time.perf_counter()
    for i in range(5):
        before = [fn.launches for fn in counters]
        state, m = step(state, batches[i % 2])
        per_step.append([fn.launches - b0 for fn, b0 in zip(counters, before)])
        totals.append(m["total"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    losses = torch.stack(totals).cpu()
    L = cfg.n_layers
    check(bool(torch.all(torch.isfinite(losses))), f"train: non-finite loss {losses}")
    for counts in per_step:
        check(counts == [2, 2 * L, 2 * L],
              f"train step launched knn/egcl/egcl_backward {counts} (want 2, {2 * L}, {2 * L})")
    by_variant = dict(egcl.egcl_layer.launches_by_variant)
    want = egcl.egcl_variant(cfg.hidden_nf, cfg.k, cfg.hidden_nf // cfg.num_heads,
                             cfg.egnn_accurate)
    check(by_variant == only(want, launches[1]),
          f"train: EGCL launches by kernel {by_variant}, want all {launches[1]} {want}")
    bwd_by_variant = dict(eb.egcl_backward.launches_by_variant)
    check(bwd_by_variant == only(want, launches[2]),
          f"train: EGCL backward launches by kernel {bwd_by_variant}, want all {launches[2]} "
          f"{want}")
    knn_by_variant = check_knn_warp(knn.knn_window, "train")
    record_launches(rows, "train", dict(knn_window=launches[0],
                                        **by_row("egcl_layer", by_variant),
                                        **by_row("egcl_backward", bwd_by_variant)),
                    dict(knn_window=knn_by_variant))
    log(f"train B={bsz}: 5 steps in {dt:.3f} s, {5 * bsz / dt:.1f} pairs/s (host clock, "
        f"synchronized at the end), losses {[round(float(v), 4) for v in losses]}; launches "
        f"knn {launches[0]} ({knn_by_variant}) egcl {launches[1]} ({by_variant}) "
        f"egcl_backward {launches[2]} "
        f"({bwd_by_variant}); peak memory of "
        f"the 6 steps {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # --- the accurate step on the card against the same step on the CPU ---
    acfg = dataclasses.replace(cfg, egnn_accurate=True)
    cpu = engine.init_state(acfg, torch.Generator().manual_seed(1), device="cpu")
    card_model = engine.build_model(acfg, device=dev)
    card_model.load_state_dict(cpu.model.state_dict())
    card = engine.TrainState(card_model, engine.build_optimizer(card_model, acfg))
    small = batch(2, "cpu")
    small_card = {k: v.to(dev) for k, v in small.items()}

    def grads(model, b):
        model.zero_grad(set_to_none=True)
        lb = engine.train_loss(model, acfg, b)
        lb.total.backward()
        g = {n: q.grad.detach().float().cpu() for n, q in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(lb.total.detach()), g

    t1 = time.perf_counter()
    lc, gc = grads(cpu.model, small)
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    reset_backward_counters(eb)
    lg, gg = grads(card.model, small_card)
    acc_fwd = dict(egcl.egcl_layer.launches_by_variant)
    acc_bwd = dict(eb.egcl_backward.launches_by_variant)
    check(acc_fwd == only("tile_f32", 2 * L) and acc_bwd == only("tile_f32", 2 * L),
          f"train accurate B=2: EGCL launches by kernel {acc_fwd}, backward {acc_bwd}, want "
          f"all {2 * L} tile_f32")
    record_launches(rows, "train accurate B=2",
                    dict(knn_window=knn.knn_window.launches, **by_row("egcl_layer", acc_fwd),
                         **by_row("egcl_backward", acc_bwd)),
                    dict(knn_window=check_knn_warp(knn.knn_window, "train accurate B=2")))
    cos = grad_cosines(torch, gg, gc)
    for st, b in ((cpu, small), (card, small_card)):
        engine.make_train_step(st.model, st.optimizer, acfg)(st, b)
    cpu_sd = cpu.model.state_dict()
    dp, dp_big = {}, {}
    for n, q in card.model.named_parameters():
        d = (q.detach().cpu() - cpu_sd[n]).abs()
        big = gc[n].abs() > 1e-3 * gc[n].abs().max()
        dp[n], dp_big[n] = float(d.max()), float(d[big].max()) if bool(big.any()) else 0.0
    worst = min(cos, key=lambda k: cos[k][0])
    worst_l2 = max(cos, key=lambda k: cos[k][1])
    worst_p, worst_big = max(dp, key=dp.get), max(dp_big, key=dp_big.get)
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"train card vs CPU: loss {lg} vs {lc}")
    check(cos[worst][0] >= 0.9999, f"train card vs CPU: gradient cosine {worst} {cos[worst]}")
    check(cos[worst_l2][1] <= 1e-4,
          f"train card vs CPU: gradient relative L2 {worst_l2} {cos[worst_l2]}")
    check(dp_big[worst_big] <= 1e-6,
          f"train card vs CPU: post-Adam |Δ| where |g| is above the noise floor, "
          f"{worst_big} {dp_big[worst_big]}")
    check(dp[worst_p] <= 2 * acfg.lr, f"train card vs CPU: post-Adam |Δ| {worst_p} {dp[worst_p]}")
    log(f"train accurate B=2 card vs CPU: loss {lg:.6f} vs {lc:.6f} (rel {abs(lg - lc) / abs(lc):.2g}); "
        f"worst gradient cosine {worst} {cos[worst][0]:.6f}, worst relative L2 {worst_l2} "
        f"{cos[worst_l2][1]:.2g}; post-Adam max|Δ| {worst_big} {dp_big[worst_big]:.3g} where "
        f"|g| > 1e-3 of its max, {worst_p} {dp[worst_p]:.3g} everywhere (lr {acfg.lr}); CPU side "
        f"{time.perf_counter() - t1:.1f} s; launches egcl {acc_fwd} egcl_backward {acc_bwd}")

    # --- fast against accurate on the card, same weights and batch ---
    mid = batch(8, dev)
    fcfg = dataclasses.replace(acfg, egnn_accurate=False)
    _, ga = grads(card.model, mid)
    card.model.zero_grad(set_to_none=True)
    lb = engine.train_loss(card.model, fcfg, mid)
    lb.total.backward()
    gf = {n: q.grad.detach().float().cpu() for n, q in card.model.named_parameters()}
    card.model.zero_grad(set_to_none=True)
    check(all(bool(torch.all(torch.isfinite(g))) for g in gf.values()), "fast gradients not finite")
    table = sorted(grad_cosines(torch, gf, ga).items(), key=lambda kv: kv[1][0])
    rels = sorted(r for _, (_, r) in table)
    log(f"train fast vs accurate gradients B=8 (card, {len(table)} tensors), worst first; "
        f"median rel L2 {rels[len(rels) // 2]:.3g}:")
    for name, (c, r) in table[:6]:
        log(f"  | {name} | {c:.4f} | {r:.3g} |")

    profile_call(torch, lambda: step(state, batches[0]), f"train step B={bsz}")
    default_train_step(torch, dev, cfg, bsz, batch, rows)


def default_train_step(torch, dev, cfg, bsz, batch, rows):
    """Training at `EngineConfig()` defaults (whole-cloud exact k-NN, the
    accurate fp32 tile EGCL kernels, SVD Kabsch) at `bsz` pairs: one warm
    step, 3 timed steps with the launch counters (2 knn, 2·L egcl and 2·L
    egcl_backward a step, every EGCL launch 'tile_f32'), then a profile of
    one step."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import engine

    dcfg = engine.EngineConfig(**{f: getattr(cfg, f) for f in (
        "num_nodes", "k", "in_node_nf", "hidden_nf", "n_layers", "num_heads", "top_k")})
    check(dcfg.egnn_accurate and dcfg.knn_method == "exact", "EngineConfig() defaults changed")
    state = engine.init_state(dcfg, torch.Generator().manual_seed(0), device=dev)
    step = engine.make_train_step(state.model, state.optimizer, dcfg)
    batches = [batch(bsz, dev) for _ in range(2)]
    state, _ = step(state, batches[1])
    torch.cuda.synchronize()
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    reset_backward_counters(eb)
    totals = []
    t0 = time.perf_counter()
    for i in range(3):
        state, m = step(state, batches[i % 2])
        totals.append(m["total"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    L = dcfg.n_layers
    losses = torch.stack(totals).cpu()
    fwd, bwd = dict(egcl.egcl_layer.launches_by_variant), dict(eb.egcl_backward.launches_by_variant)
    check(bool(torch.all(torch.isfinite(losses))), f"train defaults: non-finite loss {losses}")
    check(knn.knn_window.launches == 6 and fwd == only("tile_f32", 6 * L)
          and bwd == only("tile_f32", 6 * L),
          f"train defaults: 3 steps launched knn {knn.knn_window.launches}, egcl {fwd}, "
          f"egcl_backward {bwd} (want 6, {6 * L} and {6 * L} tile_f32)")
    knn_by_variant = check_knn_warp(knn.knn_window, "train defaults")
    record_launches(rows, "train defaults", dict(knn_window=knn.knn_window.launches,
                                                 **by_row("egcl_layer", fwd),
                                                 **by_row("egcl_backward", bwd)),
                    dict(knn_window=knn_by_variant))
    log(f"train at EngineConfig() defaults B={bsz}: 3 steps in {dt:.3f} s, "
        f"{3 * bsz / dt:.1f} pairs/s (host clock, synchronized at the end), losses "
        f"{[round(float(v), 4) for v in losses]}; launches knn {knn.knn_window.launches} "
        f"({knn_by_variant}) egcl {fwd} egcl_backward {bwd}")
    profile_call(torch, lambda: step(state, batches[0]),
                 f"train step at EngineConfig() defaults (exact whole-cloud k-NN, accurate "
                 f"fp32 tile EGCL, SVD Kabsch) B={bsz}")


def bumpy_surface(seed=0):
    """The Gaussian-bump height field of tests/test_global_registration.py
    (locally distinctive geometry): surf(rng, n) samples n points of it with
    2 mm noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.6, 1.6, (30, 2))
    amps = rng.uniform(-0.35, 0.35, 30)
    widths = rng.uniform(0.08, 0.3, 30)

    def surf(rng2, n):
        xy = np.stack([rng2.uniform(-1, 1, n), rng2.uniform(-1, 1, n)], -1)
        z = np.zeros(n)
        for (cx, cy), a, w in zip(centers, amps, widths):
            z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
        pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        return pts + rng2.standard_normal(pts.shape).astype(np.float32) * 0.002

    return surf


def pose_err(Rh, th, R, t):
    """(rotation error in degrees, max |Δt|) of an estimate against the truth."""
    return (float(np.degrees(np.linalg.norm(Rh - R) / np.sqrt(2))),
            float(np.abs(th - t).max()))


def surface_pairs(count, seed):
    """`count` (src, tgt, R, t): the bumpy surface sampled twice
    independently at FPFH_N points, tgt under a random pose."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation

    surf, rng = bumpy_surface(), np.random.default_rng(seed)
    out = []
    for _ in range(count):
        src = surf(rng, FPFH_N)
        R = random_rotation(rng).astype(np.float32)
        t = (rng.standard_normal(3) * 0.3).astype(np.float32)
        out.append((src, (surf(rng, FPFH_N) @ R.T + t).astype(np.float32), R, t))
    return out


def spfh_bin_flips(spfh, ref, dist_ref):
    """(edge-channel entries in another bin, max|ΔSPFH| over centers whose
    counts all agree): counts come back from rows scaled to 100."""
    valid = (dist_ref > 0).sum(-1, keepdim=True).double()
    cg = (spfh.double() * valid / 100.0).round()
    cr = (ref.double() * valid / 100.0).round()
    dc = (cg - cr).abs()
    same = dc.sum(-1) == 0
    return float(dc.sum() / 2), float((spfh - ref).abs()[same].max())


# B5's edge cases: (clouds, K, cloud kind); every case runs both kernels in
# both modes against the plain version, bit for bit. K=100 and K=300 take
# the packed kernel's 8- and 16-bit fields; 'repeated' has every point twice
# (the duplicate and the self pair are invalid edges).
SPFH_EDGE_CASES = ((1, 60, "surface"), (8, 16, "surface"), (8, 33, "surface"),
                   (8, 60, "repeated"), (2, 100, "surface"), (1, 300, "surface"))


def spfh_inputs(torch, dev, bsz, k, kind="surface"):
    """(xs, normals, nbr) at full width: `bsz` curve-sorted surface clouds,
    B4's lists at K=60 (the fused path's), the plain exact window k-NN
    otherwise."""
    from se3_equi_graph_registration_tpu_torch.ops import fpfh, morton
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn

    xs = surface_clouds(torch, dev, bsz)
    if kind == "repeated":
        x = xs.clone()
        x[:, 1::2] = x[:, ::2]
        _, xs, _ = morton.sort_by_curve(x[..., :0], x)
        xs = xs.contiguous()
    if k == FPFH_K and kind == "surface":
        nbr = knn.knn_chunked(xs, k, FPFH_TILE, FPFH_WINDOW)
    else:   # exact window keys: csrc/knn_exact_warp.cu to k = 128, knn_exact_large.cu beyond
        nbr = knn.knn_window(xs, k, FPFH_TILE, FPFH_WINDOW, packed=False)
    normals = fpfh.estimate_normals_window(xs, nbr[..., :min(k, FPFH_KN)]).contiguous()
    return xs, normals, nbr


def spfh_against_plain(torch, xs, normals, nbr, accurate, variant, what):
    """One launch of the variant against the plain version: the existing gate
    (distances 1e-6 relative, 1e-4 of the edge-channels in another bin, 1e-3
    where the counts agree) and bit-for-bit equality; returns (dist max rel,
    edge-channels in another bin, max|ΔSPFH| where the counts agree)."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import spfh

    tile, w = FPFH_TILE, FPFH_WINDOW
    sg, dg = spfh.spfh(xs, normals, nbr, tile, w, accurate, variant)
    torch.cuda.synchronize()
    sr, dr = spfh.spfh_plain(xs, normals, nbr, tile, w, accurate)
    derr = float(((dg - dr).abs() / dr.abs().clamp_min(1e-30)).max())
    flips, serr = spfh_bin_flips(sg, sr, dr)
    check(torch.isfinite(sg).all() and derr <= 1e-6 and flips <= 1e-4 * nbr.numel()
          and serr <= 1e-3,
          f"spfh {what}: dist rel {derr}, {flips} edge-channels in another bin, "
          f"max|ΔSPFH| {serr} where the counts agree")
    check(torch.equal(dg, dr) and flips == 0 and serr == 0 and torch.equal(sg, sr),
          f"spfh {what}: not bit for bit: dist rel {derr}, {flips} edge-channels in another "
          f"bin, max|ΔSPFH| {serr} where the counts agree")
    return derr, flips, serr


def fpfh_kernel_phase(torch, dev, bsz):
    """B5, both kernels (the packed-count 'redux' the wrapper launches and
    the 'ballot' kernel kept to compare), against the plain version in both
    modes on `bsz` curve-sorted surface clouds at full width on B4's lists,
    and on the edge cases; each timed beside the plain version and the
    bound, with registers, resident blocks and waves. The TF32 pin. Returns
    the B5 row."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import spfh

    n, k, tile, w = FPFH_N, FPFH_K, FPFH_TILE, FPFH_WINDOW
    xs, normals, got = spfh_inputs(torch, dev, bsz, k)
    edges = bsz * n * k
    before = dict(spfh.spfh.launches_by_variant)
    ms, errs = {}, {}
    for accurate in (True, False):
        mode = "accurate" if accurate else "fast"
        for variant in spfh.VARIANTS:
            derr, flips, serr = spfh_against_plain(torch, xs, normals, got, accurate, variant,
                                                   f"{variant} {mode}")
            errs[variant, mode] = serr
            log(f"spfh[{variant}, {mode}] B={bsz} N={n} K={k} W={w}: dist max rel {derr:.3g}, "
                f"{flips:.0f} of {edges} edge-channels in another bin, max|ΔSPFH| {serr:.3g} "
                f"where the counts agree (of 100 per channel); bit for bit")
        # in turns: redux, ballot, ballot, redux
        for variant in (*spfh.VARIANTS, *reversed(spfh.VARIANTS)):
            t = cuda_ms(torch, lambda: spfh.spfh(xs, normals, got, tile, w, accurate, variant), 20)
            ms[variant, mode] = min(ms.get((variant, mode), t), t)
        ms["plain", mode] = cuda_ms(
            torch, lambda: spfh.spfh_plain(xs, normals, got, tile, w, accurate), 3)
    for b, kk, kind in SPFH_EDGE_CASES:
        x, nrm, nb = spfh_inputs(torch, dev, b, kk, kind)
        for accurate in (True, False):
            for variant in spfh.VARIANTS:
                spfh_against_plain(torch, x, nrm, nb, accurate, variant,
                                   f"{variant} B={b} K={kk} {kind} accurate={accurate}")
        log(f"spfh edge case B={b} K={kk} {kind}: both kernels bit for bit in both modes")
    compared = {v: spfh.spfh.launches_by_variant[v] - before[v] for v in spfh.VARIANTS}
    check(all(c > 0 for c in compared.values()), f"spfh comparisons launched {compared}")
    nbytes5 = xs.numel() * 4 * 2 + edges * 4 * 2 + bsz * n * 33 * 4
    b5, b5by = bound_ms(nbytes5, edges * SPFH_EDGE_OPS, PEAK_FP32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occupancy = {}
    for variant in spfh.VARIANTS:
        per_sm, grid = spfh.occupancy(variant, bsz, n, k, tile, w, dev)
        occupancy[variant] = dict(blocks_per_sm=per_sm, grid=grid, waves=grid / (per_sm * sms))
        log(f"spfh[{variant}] B={bsz} N={n} K={k} W={w}: accurate {ms[variant, 'accurate']:.4f} "
            f"ms, fast {ms[variant, 'fast']:.4f} ms ({100 * b5 / ms[variant, 'accurate']:.1f}% "
            f"of the bound); {per_sm} blocks an SM of {sms}, grid {grid} blocks = "
            f"{grid / (per_sm * sms):.2f} waves")
    log(f"spfh bound: {SPFH_EDGE_OPS} fp32 operations per edge, {nbytes5 / 1e6:.1f} MB: "
        f"{b5:.4f} ms ({b5by}); plain {ms['plain', 'accurate']:.3f} ms accurate, "
        f"{ms['plain', 'fast']:.3f} fast")
    tf32_check(torch, xs, got)
    return dict(name="spfh", route="cuda",
                source="se3_equi_graph_registration_tpu_torch/csrc/spfh_redux.cu",
                replaces="se3_equi_graph_registration_tpu/ops/pallas/spfh_kernel.py:62",
                launches=0, max_abs_err=max(errs.values()), ms=ms["redux", "accurate"],
                plain_ms=ms["plain", "accurate"], bound_ms=b5, bound_by=b5by, library_ms=None,
                variant="redux", fast_ms=ms["redux", "fast"], ballot_ms=ms["ballot", "accurate"],
                ballot_fast_ms=ms["ballot", "fast"], plain_fast_ms=ms["plain", "fast"],
                ballot_source="se3_equi_graph_registration_tpu_torch/csrc/spfh.cu",
                occupancy=occupancy, launches_by_variant=dict.fromkeys(spfh.VARIANTS, 0))


def tf32_check(torch, xs, nbr):
    """With TF32 enabled for matmuls, the normals' moments and the branch
    verification equal their TF32-off values (they use no matmul); a
    matmul-based verification, printed for contrast, does not."""
    from se3_equi_graph_registration_tpu_torch.core.se3 import matrix_exp_so3
    from se3_equi_graph_registration_tpu_torch.ops import fpfh
    from se3_equi_graph_registration_tpu_torch.ops.knn import pairwise_sq_dists
    from se3_equi_graph_registration_tpu_torch.registration import _branch_verify_ms

    b = min(8, xs.shape[0])
    x, nb = xs[:b], nbr[:b, :, :FPFH_KN].contiguous()
    n_keep = int(0.35 * x.shape[1])
    g = torch.Generator().manual_seed(3)
    R = matrix_exp_so3((torch.randn(b, 4, 3, generator=g) * 1e-3).to(x.device))
    t = (torch.randn(b, 4, 3, generator=g) * 1e-3).to(x.device)
    tgt = (x + 1e-3 * torch.randn(x.shape, generator=g).to(x.device)).flip(-2).contiguous()

    def matmul_verify():
        posed = torch.einsum("bkij,bnj->bkni", R, x) + t[..., None, :]
        d2 = pairwise_sq_dists(posed, tgt[:, None])
        return torch.mean(torch.topk(d2.amin(-1), n_keep, dim=-1, largest=False).values, -1)

    prev = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out[tf32] = (fpfh.estimate_normals_window(x, nb), _branch_verify_ms(R, t, x, tgt, n_keep),
                         matmul_verify())
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    dn = float((out[True][0] - out[False][0]).abs().max())
    dv = float(((out[True][1] - out[False][1]).abs() / out[False][1].abs()).max())
    dm = float(((out[True][2] - out[False][2]).abs() / out[False][2].abs()).max())
    check(dn <= 1e-6 and dv <= 1e-6, f"TF32 reached fp32-pinned work: normals {dn}, verify {dv}")
    log(f"TF32 on: normals max|Δ| {dn:.3g}, branch verify rel {dv:.3g} (fp32-pinned); a "
        f"matmul-based verify moves by rel {dm:.3g} (the hazard the pin removes)")


def register_fpfh_phase(torch, dev, rows):
    """The checkpoint-free path at full width (fused, chunked, W=768,
    N=2048): register_fpfh on the card against the same call on the CPU, at
    4 branches and 1, with the launch counters; pairs/s at b=1 and of
    register_fpfh_batch at B=8 and 32; a profile of one b=1 call."""
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    kw = dict(knn_method="fused", knn_packed="chunked", window=FPFH_WINDOW)
    (src, tgt, R, t), = surface_pairs(1, 6)
    counters = dict(knn_window=knn.knn_window, egcl_layer=egcl.egcl_layer,
                    egcl_backward=eb.egcl_backward, knn_chunked=knn.knn_chunked, spfh=spfh.spfh)
    for fn in counters.values():
        fn.launches = 0
    reset_knn_counters(knn)
    spfh.spfh.launches_by_variant = dict.fromkeys(spfh.VARIANTS, 0)

    rates = {}
    t0 = time.perf_counter()
    for br in (4, 1):
        before = {k_: fn.launches for k_, fn in counters.items()}
        Rc, tc, ic = registration.register_fpfh(src, tgt, ransac_branches=br, **kw)
        torch.cuda.synchronize()
        d = {k_: fn.launches - before[k_] for k_, fn in counters.items()}
        check(d == dict(knn_window=0, egcl_layer=0, egcl_backward=0, knn_chunked=2, spfh=2),
              f"register_fpfh launched {d} (want knn_chunked 2, spfh 2, nothing else)")
        t1 = time.perf_counter()
        Rp, tp, ip = registration.register_fpfh(src, tgt, ransac_branches=br, device="cpu", **kw)
        cpu_s = time.perf_counter() - t1
        dR = float(np.linalg.norm(Rc - Rp) / np.sqrt(2))
        dt = float(np.abs(tc - tp).max())
        (ec, etc), (ep, etp) = pose_err(Rc, tc, R, t), pose_err(Rp, tp, R, t)
        check(all(np.isfinite(a).all() for a in (Rc, tc, ic["weights"], ic["pose_covariance"])),
              f"register_fpfh branches={br}: non-finite output")
        check(ec < 0.5 and etc < 5e-3 and ep < 0.5 and etp < 5e-3,
              f"register_fpfh branches={br}: ground truth missed, card {ec} deg {etc} m, "
              f"CPU {ep} deg {etp} m")
        check(dR <= 2e-3 and dt <= 2e-3, f"register_fpfh branches={br}: card vs CPU dR {dR} dt {dt}")
        log(f"register_fpfh branches={br} N={FPFH_N} fused/chunked W={FPFH_WINDOW}: launches {d}; "
            f"ground truth card {ec:.4f} deg {etc * 1e3:.3f} mm, CPU {ep:.4f} deg "
            f"{etp * 1e3:.3f} mm; card vs CPU ‖ΔR‖/√2 {dR:.3g}, |Δt| {dt:.3g} m "
            f"(CPU run {cpu_s:.1f} s)")
        reps = 10
        t1 = time.perf_counter()
        for _ in range(reps):
            registration.register_fpfh(src, tgt, ransac_branches=br, **kw)
        rates[f"b=1, {br} branches"] = reps / (time.perf_counter() - t1)
    for b in FPFH_BATCHES:
        pairs = surface_pairs(b, 200 + b)
        bs = np.stack([p[0] for p in pairs])
        bt = np.stack([p[1] for p in pairs])
        before = {k_: fn.launches for k_, fn in counters.items()}
        Rb, tb, _ = registration.register_fpfh_batch(bs, bt, seed=1, **kw)
        torch.cuda.synchronize()
        d = {k_: fn.launches - before[k_] for k_, fn in counters.items()}
        check(d["knn_chunked"] == 2 and d["spfh"] == 2 and d["knn_window"] == 0,
              f"register_fpfh_batch B={b} launched {d}")
        ok = sum(e[0] < 0.5 and e[1] < 5e-3
                 for e in (pose_err(Rb[i], tb[i], *pairs[i][2:]) for i in range(b)))
        check(np.isfinite(Rb).all() and ok >= b - 1,
              f"register_fpfh_batch B={b}: {ok} of {b} pairs recovered")
        torch.cuda.reset_peak_memory_stats()
        reps = 3
        t1 = time.perf_counter()
        for _ in range(reps):
            registration.register_fpfh_batch(bs, bt, seed=1, **kw)
        rates[f"batch B={b}"] = b * reps / (time.perf_counter() - t1)
        log(f"register_fpfh_batch B={b}: {ok}/{b} pairs within 0.5 deg / 5 mm; launches {d}; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = {k_: fn.launches for k_, fn in counters.items()}
    chunked_by_variant = check_knn_warp(knn.knn_chunked, "register_fpfh")
    spfh_by_variant = dict(spfh.spfh.launches_by_variant)
    check(spfh_by_variant == {**dict.fromkeys(spfh.VARIANTS, 0), "redux": launches["spfh"]},
          f"register_fpfh: spfh launches by kernel {spfh_by_variant}, want all "
          f"{launches['spfh']} 'redux'")
    log(f"register_fpfh path: run {time.perf_counter() - t0:.1f} s, launches {launches}; "
        f"knn_chunked by kernel {chunked_by_variant}, spfh by kernel {spfh_by_variant}")
    log("register_fpfh pairs/s (host clock incl. sampling, H2D, noise draw and result copy; "
        "robust = 4 branches): " + ", ".join(f"{k_}: {r:.2f}" for k_, r in rates.items()))
    for name in ("knn_chunked", "spfh"):
        check(launches[name] > 0, f"{name} never launched on the register_fpfh path")
    record_launches(rows, "register_fpfh", launches,
                    dict(knn_chunked=chunked_by_variant, spfh=spfh_by_variant))
    profile_call(torch, lambda: registration.register_fpfh(src, tgt, **kw), "register_fpfh b=1")
    fused_icp60(torch, src, tgt, kw)


def fused_icp60(torch, src, tgt, kw):
    """The fused path card against CPU with ICP run to its fixed point (60
    steps), on pair 6 at the default path's gate (module docstring), then
    the sweep over ICP60_SWEEP_PAIRS pairs at 60 steps, printed and not held."""
    from se3_equi_graph_registration_tpu_torch import registration

    def gap(s, t):
        Rc, tc, _ = registration.register_fpfh(s, t, icp_iters=60, **kw)
        Rp, tp, _ = registration.register_fpfh(s, t, icp_iters=60, device="cpu", **kw)
        return float(np.linalg.norm(Rc - Rp) / np.sqrt(2)), float(np.abs(tc - tp).max())

    dR, dt = gap(src, tgt)
    log(f"register_fpfh fused/chunked W={FPFH_WINDOW} at 60 ICP steps, pair 6: card vs CPU "
        f"‖ΔR‖/√2 {dR:.3g}, |Δt| {dt:.3g} m")
    check(dR <= 2e-3 and dt <= 2e-3,
          f"register_fpfh fused at 60 ICP steps: card vs CPU dR {dR} dt {dt}")
    t0 = time.perf_counter()
    sweep = [gap(*surface_pairs(1, seed)[0][:2]) for seed in range(ICP60_SWEEP_PAIRS)]
    worst = max(range(ICP60_SWEEP_PAIRS), key=lambda i: max(sweep[i]))
    log(f"register_fpfh fused at 60 ICP steps, {ICP60_SWEEP_PAIRS} seeded pairs (not held): "
        f"card vs CPU "
        f"‖ΔR‖/√2 {min(a for a, _ in sweep):.3g} to {max(a for a, _ in sweep):.3g}, |Δt| "
        f"{min(b for _, b in sweep):.3g} to {max(b for _, b in sweep):.3g} m; over 2e-3: "
        f"{sum(max(p) > 2e-3 for p in sweep)} of {ICP60_SWEEP_PAIRS} (worst: pair {worst}); "
        f"{time.perf_counter() - t0:.1f} s")


def register_fpfh_default_phase(torch, dev, rows):
    """The checkpoint-free path at its defaults (knn_method='approx': the
    whole-cloud exact k-NN at k = max(k_normals, k_fpfh) = 60, gather FPFH,
    4 branches), b=1, N=2048, on the card against the same call on the CPU,
    with the launch counters (2 knn_window launches, both on the exact warp
    kernel, no B4 or B5); the k-NN lists of its two clouds card against CPU
    (identical) and its descriptors (printed); both poses against the truth,
    and card against CPU at 60 ICP steps (module docstring); pairs/s."""
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops import fpfh
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn, spfh

    (src, tgt, R, t), = surface_pairs(1, 6)
    counters = dict(knn_window=knn.knn_window, knn_chunked=knn.knn_chunked, spfh=spfh.spfh)
    for fn in counters.values():
        fn.launches = 0
    reset_knn_counters(knn)
    t0 = time.perf_counter()
    Rc, tc, ic = registration.register_fpfh(src, tgt)
    torch.cuda.synchronize()
    d = {k_: fn.launches for k_, fn in counters.items()}
    check(d == dict(knn_window=2, knn_chunked=0, spfh=0),
          f"register_fpfh at its defaults launched {d} (want knn_window 2, nothing else)")
    knn_by_variant = check_knn_warp(knn.knn_window, "register_fpfh at its defaults")
    record_launches(rows, "register_fpfh approx", dict(knn_window=d["knn_window"]),
                    dict(knn_window=knn_by_variant))
    t1 = time.perf_counter()
    Rp, tp, _ = registration.register_fpfh(src, tgt, device="cpu")
    cpu_s = time.perf_counter() - t1
    dR = float(np.linalg.norm(Rc - Rp) / np.sqrt(2))
    dt = float(np.abs(tc - tp).max())
    (ec, etc), (ep, etp) = pose_err(Rc, tc, R, t), pose_err(Rp, tp, R, t)
    log(f"register_fpfh at its defaults (approx, whole-cloud exact k-NN k=60, 4 branches) "
        f"N={FPFH_N}: launches {d}, knn_window by kernel {knn_by_variant}; ground truth card "
        f"{ec:.4f} deg {etc * 1e3:.3f} mm, CPU {ep:.4f} deg {etp * 1e3:.3f} mm; card vs CPU "
        f"‖ΔR‖/√2 {dR:.3g}, |Δt| {dt:.3g} m (CPU run {cpu_s:.1f} s)")
    # what the kernel hands the pipeline, card against CPU: the lists, then the descriptors
    clouds = torch.from_numpy(np.stack([src, tgt])).to(dev)
    kk = max(registration.DEFAULTS["k_normals"], registration.DEFAULTS["k_fpfh"])
    lists = knn.knn_window(clouds, kk, FPFH_TILE, None)
    lists_cpu = knn.knn_window(clouds.cpu(), kk, FPFH_TILE, None)
    check(torch.equal(lists.cpu(), lists_cpu),
          "register_fpfh at its defaults: the card's k-NN lists differ from the CPU's")
    desc = registration._descriptors(clouds, kk, 30, 60, "approx", FPFH_WINDOW, False)
    desc_cpu = registration._descriptors(clouds.cpu(), kk, 30, 60, "approx", FPFH_WINDOW, False)
    dn = float(torch.minimum((desc[0].cpu() - desc_cpu[0]).abs(),
                             (desc[0].cpu() + desc_cpu[0]).abs()).max())
    flipped = int(((desc[0].cpu() * desc_cpu[0]).sum(-1) < 0).sum())
    df = (desc[1].cpu() - desc_cpu[1]).abs()
    log(f"register_fpfh at its defaults: k-NN lists of both clouds identical card vs CPU; "
        f"normals max|Δ| {dn:.3g} up to sign, {flipped} of {2 * FPFH_N} oriented the other "
        f"way; FPFH max|Δ| {float(df.max()):.3g}, entries off by more than 1e-3 of 100: "
        f"{int((df > 0.1).sum())} of {df.numel()}")
    # the gather FPFH's own rounding floor: the CPU's fp32 against fp64 arithmetic
    # on the same points, normals and lists
    d64 = (desc_cpu[1].double() - fpfh.fpfh(clouds.cpu().double(), desc_cpu[0].double(),
                                            nbr=lists_cpu[..., :60])).abs()
    log(f"register_fpfh at its defaults, on the CPU: the fp32 gather FPFH against the same in "
        f"fp64 (same points, normals and lists): max|Δ| {float(d64.max()):.3g}, entries off "
        f"by more than 0.1: {int((d64 > 0.1).sum())} of {d64.numel()} (the method's own "
        f"rounding floor: a value at a bin edge moves one count, weighted by 1/d)")
    check(all(np.isfinite(a).all() for a in (Rc, tc, ic["weights"], ic["pose_covariance"])),
          "register_fpfh at its defaults: non-finite output")
    check(ec < 0.5 and etc < 5e-3 and ep < 0.5 and etp < 5e-3,
          f"register_fpfh at its defaults: ground truth missed, card {ec} deg {etc} m, "
          f"CPU {ep} deg {etp} m")
    Rc60, tc60, _ = registration.register_fpfh(src, tgt, icp_iters=60)
    Rp60, tp60, _ = registration.register_fpfh(src, tgt, icp_iters=60, device="cpu")
    dR60 = float(np.linalg.norm(Rc60 - Rp60) / np.sqrt(2))
    dt60 = float(np.abs(tc60 - tp60).max())
    log(f"register_fpfh at its defaults but 60 ICP steps: card vs CPU ‖ΔR‖/√2 {dR60:.3g}, "
        f"|Δt| {dt60:.3g} m")
    check(dR60 <= 2e-3 and dt60 <= 2e-3,
          f"register_fpfh at its defaults but 60 ICP steps: card vs CPU dR {dR60} dt {dt60}")
    reps = 5
    t2 = time.perf_counter()
    for _ in range(reps):
        registration.register_fpfh(src, tgt)
    rate = reps / (time.perf_counter() - t2)
    log(f"register_fpfh at its defaults: {rate:.2f} pairs/s at b=1 (host clock incl. "
        f"sampling, H2D, noise draw and result copy); path run "
        f"{time.perf_counter() - t0:.1f} s")


def register_fpfh_large_k_phase(torch, dev, rows):
    """The checkpoint-free path at k_fpfh = KNN_LARGE_K (300) on the two
    routes that reach B1's exact keys beyond k = 128, b=1, N=2048, 4
    branches: fused with exact keys over the window (knn_packed=False,
    W=768: the TPU kernel's own path; 2 knn_window launches on the large-k
    warp kernel and 2 'redux' B5 a call) and at its defaults (the whole
    cloud; 2 knn_window launches on the large-k kernel, no B4 or B5). Each
    on the card against the same call on the CPU at the default path's
    gate: both poses within 0.5 deg and 5 mm of the truth, card vs CPU
    within 2e-3 at 60 ICP steps; launches exact; a call timed with CUDA
    events."""
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn, spfh

    (src, tgt, R, t), = surface_pairs(1, 6)
    routes = {"fused exact W=768": (dict(knn_method="fused", knn_packed=False,
                                          window=FPFH_WINDOW, k_fpfh=KNN_LARGE_K),
                                     dict(knn_window=2, knn_chunked=0, spfh=2)),
              "defaults (approx, whole cloud)": (dict(k_fpfh=KNN_LARGE_K),
                                                 dict(knn_window=2, knn_chunked=0, spfh=0))}
    counters = dict(knn_window=knn.knn_window, knn_chunked=knn.knn_chunked, spfh=spfh.spfh)
    for route, (kw, want) in routes.items():
        what = f"register_fpfh k_fpfh={KNN_LARGE_K}, {route}"
        for fn in counters.values():
            fn.launches = 0
        reset_knn_counters(knn)
        spfh.spfh.launches_by_variant = dict.fromkeys(spfh.VARIANTS, 0)
        Rc, tc, ic = registration.register_fpfh(src, tgt, **kw)
        torch.cuda.synchronize()
        d = {k_: fn.launches for k_, fn in counters.items()}
        sources = dict(knn.knn_window.launches_by_source)
        check(d == want and sources["knn_exact_large"] == 2
              and knn.knn_window.launches_by_variant == {"warp": 2, "thread": 0}
              and spfh.spfh.launches_by_variant.get("redux", 0) == want["spfh"],
              f"{what}: launches {d}, knn_window by source {sources}, by kernel "
              f"{knn.knn_window.launches_by_variant}, spfh by kernel "
              f"{spfh.spfh.launches_by_variant} (want {want}, knn_window all on the large-k "
              "kernel, spfh all 'redux')")
        record_launches(rows, f"register_fpfh k_fpfh={KNN_LARGE_K} {route}",
                        dict(knn_exact_large=2), dict(knn_exact_large={"warp": 2, "thread": 0}))
        t1 = time.perf_counter()
        Rp, tp, _ = registration.register_fpfh(src, tgt, device="cpu", **kw)
        cpu_s = time.perf_counter() - t1
        dR = float(np.linalg.norm(Rc - Rp) / np.sqrt(2))
        dt = float(np.abs(tc - tp).max())
        (ec, etc), (ep, etp) = pose_err(Rc, tc, R, t), pose_err(Rp, tp, R, t)
        check(all(np.isfinite(a).all() for a in (Rc, tc, ic["weights"], ic["pose_covariance"])),
              f"{what}: non-finite output")
        check(ec < 0.5 and etc < 5e-3 and ep < 0.5 and etp < 5e-3,
              f"{what}: ground truth missed, card {ec} deg {etc} m, CPU {ep} deg {etp} m")
        Rc60, tc60, _ = registration.register_fpfh(src, tgt, icp_iters=60, **kw)
        Rp60, tp60, _ = registration.register_fpfh(src, tgt, icp_iters=60, device="cpu", **kw)
        dR60 = float(np.linalg.norm(Rc60 - Rp60) / np.sqrt(2))
        dt60 = float(np.abs(tc60 - tp60).max())
        check(dR60 <= 2e-3 and dt60 <= 2e-3,
              f"{what} at 60 ICP steps: card vs CPU dR {dR60} dt {dt60}")
        ms = event_ms(torch, lambda: registration.register_fpfh(src, tgt, **kw), 5)
        log(f"{what}, N={FPFH_N}, b=1: launches {d}, knn_window by source {sources}; ground "
            f"truth card {ec:.4f} deg {etc * 1e3:.3f} mm, CPU {ep:.4f} deg {etp * 1e3:.3f} mm; "
            f"card vs CPU ‖ΔR‖/√2 {dR:.3g}, |Δt| {dt:.3g} m (CPU run {cpu_s:.1f} s), at 60 ICP "
            f"steps {dR60:.3g}, {dt60:.3g} m; {ms:.2f} ms a call (CUDA events, 5 calls)")


def event_ms(torch, fn, reps):
    """Device-clock ms a call of fn, over `reps` calls after a warm-up call,
    between two CUDA events; for calls that end in a device-to-host copy
    (they wait for their own work), so no device sleep ahead of them."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def counted_launches(knn, egcl, spfh):
    """{wrapper name: {variant: launches}} of the k-NN, EGCL and SPFH
    wrappers since their counters were last set to 0."""
    return dict(knn_window=dict(knn.knn_window.launches_by_variant),
                knn_chunked=dict(knn.knn_chunked.launches_by_variant),
                egcl_layer=dict(egcl.egcl_layer.launches_by_variant),
                spfh=dict(spfh.spfh.launches_by_variant))


def reset_all_counters(knn, egcl, spfh):
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    spfh.spfh.launches = 0
    spfh.spfh.launches_by_variant = dict.fromkeys(spfh.VARIANTS, 0)


def surface_requests(count, seed, n, c, inlier_ratio=0.7):
    """`count` Registrar requests on the bumpy surface at n points: the
    source sampled at n points, the target its posed copy with 2 mm noise,
    a share `1 - inlier_ratio` of the targets moved to other surface points
    (outliers), and descriptors made as make_pair_batch makes them. Returns
    (src, src_feat, tgt, tgt_feat, R, t) stacked over the pairs."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation

    surf, rng = bumpy_surface(), np.random.default_rng(seed)
    cols = [[] for _ in range(6)]
    for _ in range(count):
        src = surf(rng, n)
        R = random_rotation(rng).astype(np.float32)
        t = (rng.standard_normal(3) * 0.3).astype(np.float32)
        inl = rng.uniform(size=n) < inlier_ratio
        tgt = np.where(inl[:, None], src, surf(rng, n)) @ R.T + t
        tgt = tgt + rng.standard_normal(tgt.shape) * 0.002
        f = rng.standard_normal((n, c)).astype(np.float32)
        f /= np.linalg.norm(f, axis=1, keepdims=True) + 1e-6
        ft = np.where(inl[:, None], f + rng.standard_normal((n, c)) * 0.1,
                      rng.standard_normal((n, c)))
        ft /= np.linalg.norm(ft, axis=1, keepdims=True) + 1e-6
        for col, a in zip(cols, (src, f, tgt, ft, R, t)):
            col.append(np.asarray(a, np.float32))
    return tuple(np.stack(col) for col in cols)


def robust_phase(torch, dev, cfg, bsz, sd, rows):
    """The robust evaluation path at full width: a `.pth` written by the
    port's exporter from the seeded weights, loaded by
    `Registrar.from_checkpoint(robust=True)` on the card and on the CPU
    (spectral reweighting over the top 256, 5 IRLS steps, 'sharp' fusion),
    B=`bsz` make_pair_batch requests served by both and held at the serve
    gate; pose_error against the ground truth and recall at 70% and 10%
    inliers; then a Registrar with 60 ICP steps a scale over the pyramid
    (ROBUST_VOXEL, 0.0) on bumpy-surface requests, and one fused
    register_fpfh over the same pyramid at 60 steps, each card against CPU
    at the serve gate. Each is timed with CUDA events after a warm-up and
    profiled over one call, and its launches are counted by kernel variant
    with the counters set to 0 just before it."""
    import dataclasses
    import os

    from se3_equi_graph_registration_tpu_torch import registration, serving
    from se3_equi_graph_registration_tpu_torch.core.se3 import integrate_trans, pose_error
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine, metrics

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "robust_smoke.pth")
    checkpoints.export_reference_checkpoint(sd, path, n_layers=cfg.n_layers,
                                            num_heads=cfg.num_heads, hidden=cfg.hidden_nf)
    width = dict(k=cfg.k, in_node_nf=cfg.in_node_nf, hidden_nf=cfg.hidden_nf,
                 n_layers=cfg.n_layers, num_heads=cfg.num_heads, top_k=cfg.top_k)
    reg = serving.Registrar.from_checkpoint(path, num_nodes=cfg.num_nodes, robust=True, **width)
    cpu_reg = serving.Registrar.from_checkpoint(path, num_nodes=cfg.num_nodes, robust=True,
                                                device="cpu", **width)
    check(reg.device == dev and reg.cfg == engine.robust_eval_config(
        num_nodes=cfg.num_nodes, **width), "from_checkpoint: not the robust config on the card")
    log(f"robust: {path} ({os.path.getsize(path)} bytes) written by the port's exporter, "
        f"loaded by from_checkpoint(robust=True) on {reg.device} and the CPU")
    cases = {}

    def drive(name, call, cpu_call, reps, want, gate=serve_gap):
        """One path: counters at 0, the card call (checked against `want`,
        {wrapper: {variant: launches}}), its timing with CUDA events and a
        profile of one call, then the CPU call and the gate."""
        reset_all_counters(knn, egcl, spfh)
        got = call()
        torch.cuda.synchronize()
        launches = counted_launches(knn, egcl, spfh)
        nonzero = {w: {v: n for v, n in c.items() if n} for w, c in launches.items()}
        check({w: c for w, c in nonzero.items() if c} == want,
              f"robust {name}: launches by kernel {nonzero}, want {want}")
        ms = event_ms(torch, call, reps)
        profile_call(torch, call, f"robust {name}")
        t0 = time.perf_counter()
        ref = cpu_call()
        cpu_s = time.perf_counter() - t0
        gaps = gate(got, ref, f"robust {name}")
        cases[name] = dict(ms=ms, launches=want, gaps=gaps)
        log(f"robust {name}: card vs CPU ‖ΔR‖/√2 {gaps[0]:.3g}, |Δt| {gaps[1]:.3g} m"
            + (f", Δcov {gaps[2]:.3g}, Δsim {gaps[3]:.3g} (relative)" if len(gaps) > 2 else "")
            + f"; {ms:.2f} ms a call (CUDA events, {reps} calls after a warm-up); launches "
            f"{want}; CPU run {cpu_s:.1f} s")
        record_launches(rows, f"robust {name}",
                        dict(knn_window=sum(launches["knn_window"].values()),
                             knn_chunked=sum(launches["knn_chunked"].values()),
                             spfh=sum(launches["spfh"].values()),
                             **by_row("egcl_layer", launches["egcl_layer"])),
                        {w: launches[w] for w in ("knn_window", "knn_chunked", "spfh")})
        return got

    n_layers2 = 2 * cfg.n_layers
    served = {"knn_window": {"warp": 2}, "egcl_layer": {"tile": n_layers2}}
    tile = egcl.egcl_variant(cfg.hidden_nf, cfg.k, cfg.hidden_nf // cfg.num_heads,
                             cfg.egnn_accurate)
    check(tile == "tile", f"robust: fast mode at C={cfg.hidden_nf} runs {tile}, not the tile kernel")
    for ratio in (0.7, 0.1):
        pb = make_pair_batch(np.random.default_rng(21), batch=bsz, n=cfg.num_nodes,
                             feat_dim=cfg.in_node_nf, inlier_ratio=ratio)
        args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
        R, t, _ = drive(f"serve B={bsz} {int(ratio * 100)}% inliers",
                        lambda: reg.register(*args), lambda: cpu_reg.register(*args), 5, served)
        pred = integrate_trans(torch.from_numpy(R), torch.from_numpy(t))
        gt = torch.from_numpy(pb.gt_pose)
        rre, rte = pose_error(gt, pred)
        recall, _ = metrics.registration_recall(pred, torch.from_numpy(pb.src_pts),
                                                torch.from_numpy(pb.tgt_pts))
        check(torch.isfinite(rre).all() and torch.isfinite(rte).all(), "pose_error not finite")
        log(f"robust serve {int(ratio * 100)}% inliers, B={bsz} (seeded random weights, not "
            f"trained): pose_error RRE median {float(rre.median()):.3f} deg (max "
            f"{float(rre.max()):.3f}), RTE median {float(rte.median()):.3f} cm (max "
            f"{float(rte.max()):.3f}); RRE < 15 deg and RTE < 30 cm: "
            f"{int(((rre < 15) & (rte < 30)).sum())}/{bsz}; registration recall (tau 0.09) "
            f"{float(recall.mean()):.3f}")

    # ICP over the voxel pyramid at 60 steps a scale, on the bumpy surface at
    # ~5 points an occupied ROBUST_VOXEL cell (N points on a 2 m x 2 m patch)
    icp_reg = serving.Registrar(sd, dataclasses.replace(
        reg.cfg, icp_iters=ROBUST_ICP_ITERS, icp_voxels=(ROBUST_VOXEL, 0.0)), device=dev)
    icp_cpu = serving.Registrar(sd, icp_reg.cfg, device="cpu")
    src, sf, tgt, tf, Rg, tg = surface_requests(ROBUST_ICP_PAIRS, 31, cfg.num_nodes,
                                                cfg.in_node_nf)
    args = (src, sf, tgt, tf)
    R, t, _ = drive(f"Registrar ICP {ROBUST_ICP_ITERS} steps over ({ROBUST_VOXEL}, 0.0), "
                    f"B={ROBUST_ICP_PAIRS} surface pairs", lambda: icp_reg.register(*args),
                    lambda: icp_cpu.register(*args), 3, served)
    errs = [pose_err(R[i], t[i], Rg[i], tg[i]) for i in range(ROBUST_ICP_PAIRS)]
    log(f"robust Registrar ICP pyramid against the truth: worst {max(e[0] for e in errs):.4f} "
        f"deg, {1e3 * max(e[1] for e in errs):.3f} mm")

    (fsrc, ftgt, fR, ft), = surface_pairs(1, 6)
    kw = dict(knn_method="fused", knn_packed="chunked", window=FPFH_WINDOW,
              icp_iters=ROBUST_ICP_ITERS, icp_voxels=(ROBUST_VOXEL, 0.0))

    def fpfh_gap(a, b, what):
        dR = float(np.linalg.norm(a[0] - b[0]) / np.sqrt(2))
        dt = float(np.abs(a[1] - b[1]).max())
        check(all(np.isfinite(x).all() for x in (a[0], a[1], a[2]["pose_covariance"])),
              f"{what}: non-finite output")
        check(dR <= 2e-3 and dt <= 2e-3, f"{what}: card vs CPU dR {dR} dt {dt}")
        return dR, dt

    Rf, tf_, _ = drive(f"register_fpfh fused ICP {ROBUST_ICP_ITERS} steps over "
                       f"({ROBUST_VOXEL}, 0.0)",
                       lambda: registration.register_fpfh(fsrc, ftgt, **kw),
                       lambda: registration.register_fpfh(fsrc, ftgt, device="cpu", **kw), 3,
                       {"knn_chunked": {"warp": 2}, "spfh": {"redux": 2}}, gate=fpfh_gap)
    ef = pose_err(Rf, tf_, fR, ft)
    check(ef[0] < 0.5 and ef[1] < 5e-3, f"robust register_fpfh pyramid missed the truth: {ef}")
    log(f"robust register_fpfh pyramid against the truth: {ef[0]:.4f} deg, "
        f"{1e3 * ef[1]:.3f} mm")
    return cases

CLI_PAIRS = (16, 8, 8)        # train, val, test pairs of the cli phase's roots
CLI_CORR = 5000               # putative correspondences a pair


def write_cli_root(torch, root, dataset, c, seed):
    """A dataset root in the reference's on-disk format, written by the
    port's `data/synthetic` archive writers: CLI_PAIRS train, val and test
    pairs of CLI_CORR putative correspondences each (`make_raw_pair`: a
    known pose, geometric inlier labels), `{train,val,test}_files.txt`;
    3DMatch train and val pickles hold torch tensors with a leading batch
    axis, the others numpy dicts (KITTI's at LiDAR scale with the 33 FPFH
    channels)."""
    from se3_equi_graph_registration_tpu_torch.data import synthetic

    n_train, n_val, n_test = CLI_PAIRS
    if dataset == "kitti":
        synthetic.write_reference_kitti_archive(root, n_train, n_val, n_test, n_points=CLI_CORR,
                                                feat_dim=c, seed=seed)
    else:
        synthetic.write_reference_train_archive(root, n_train, n_val, n_points=CLI_CORR,
                                                feat_dim=c, seed=seed)
        synthetic.write_reference_test_archive(root, n_test, n_points=CLI_CORR, feat_dim=c,
                                               seed=seed + 1)


def quiet_cli(cli, argv):
    """cli.main(argv) with its standard output kept; returns (result, the
    output's lines that are not the printed config)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return out, [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(("[epoch", "done", "wrote", "resumed", "run."))]


def cli_counts(knn, egcl, eb):
    """{wrapper name: {variant: launches}} of the k-NN, EGCL forward and
    EGCL backward wrappers since their counters were last set to 0."""
    return dict(knn_window=dict(knn.knn_window.launches_by_variant),
                egcl_layer=dict(egcl.egcl_layer.launches_by_variant),
                egcl_backward=dict(eb.egcl_backward.launches_by_variant))


def cli_phase(torch, dev, rows):
    """The command-line entry point at full width on the card, for the
    3dmatch and the kitti preset (N=2048, k=16, 3 layers, B=8; C=32 with 4
    heads and top_k=128, C=33 with 1 head and top_k=2048): a dataset root in
    the reference's format, `cli train` for one epoch (2 steps and a
    validation batch), `cli export` of the checkpoint directory read back by
    `convert_reference_checkpoint`, `cli eval` on the card and with
    `--device cpu`, one step with `engine.remat=true` against one without,
    then a step's wall time and a profile. Each command runs with the launch
    counters set to 0 just before it. Runs with torch's default TF32 flags
    (matmul off, cuDNN on) and restores the smoke's after."""
    import os
    import tempfile

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for preset, c in (("3dmatch", 32), ("kitti", 33)):
                t0 = time.perf_counter()
                cli_preset(torch, dev, rows, preset, c, os.path.join(tmp, preset))
                log(f"cli {preset}: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


# The head's score MLP (models/pose_head.py): 2H → H → H/2 → 1 with ReLUs
# after its first two layers. A ReLU whose input the card and the CPU round
# to opposite sides of 0 gives each its own branch, and the two gradients
# differ by that unit's whole contribution: at the kitti preset's
# cli-trained weights one `mlp.dense_1` input sits within 1.5e-6 of 0 and
# moves egnn.embedding_in.weight's gradient by 1.01e-3 (relative L2) when
# it changes side, whatever EGCL kernel trained or differentiates the step
# (egcl_f32_numerics.py). The cli phase's gradient gate therefore holds the
# CPU on the card's side of such units, after checking that card and CPU
# agree on every input of these layers within SCORE_KINK_TOL of the layer's
# largest (an input that changes side lies within that gap of 0).
SCORE_RELU_LAYERS = ("mlp.dense_0", "mlp.dense_1")
SCORE_KINK_TOL = 1e-5


def score_relu_hooks(model, fn):
    """Forward hooks calling fn(layer name, output) on the score MLP's two
    ReLU layers (their output is the ReLU's input); fn's return value, if
    not None, replaces the output."""
    for name, module in model.named_modules():
        if name.endswith(SCORE_RELU_LAYERS):
            layer = name[name.index("mlp."):]
            module.register_forward_hook(lambda m, i, o, layer=layer: fn(layer, o))


def follow_card(torch, name, o, card_pre, moved):
    """The CPU's ReLU input o of score-MLP layer `name`, moved to the card's
    value where the two lie on opposite sides of 0 (the gradient still
    flows through o); records (units moved, max |card − CPU|, max |o|)."""
    pc = card_pre[name]
    other = (o > 0) != (pc > 0)
    moved[name] = (int(other.sum()), float((pc - o).abs().max()), float(o.abs().max()))
    return o + torch.where(other, (pc - o).detach(), torch.zeros_like(o))


# KITTI's width in fast mode (the kitti phase): a KITTI checkpoint served as
# README.md shows, `from_checkpoint(..., robust=True)`, and fast training at
# that width; the batches of its register() calls and of its train step
KITTI_FAST = dict(in_node_nf=33, hidden_nf=33, num_heads=1, top_k=2048)
KITTI_SERVE_B = (16, 64)
KITTI_TRAIN_B = 8


def kitti_phase(torch, dev, rows):
    """KITTI's width (C=33, one head, top_k=2048, N=2048) in fast mode, on
    the bf16 tile kernels built at CP=48: (a) a `.pth` the port's exporter
    writes from seeded weights, served by `Registrar.from_checkpoint(path,
    robust=True, **KITTI_FAST)` on the card and on the CPU: `register()` at
    B=16 and 64 on make_pair_batch requests, each held at the serve gate
    (`serve_gap`) and timed; then `register_raw` on a bumpy-surface pair
    through the same Registrar: the k-NN tables identical card vs CPU, the
    matches equal on ≥ 99.5% of the rows, `register()` on the CPU's
    matched set at the serve gate, the full register_raw gap printed (the
    gather FPFH's card-vs-CPU differences move a few matches; serve_extra's
    accurate case measured 1.9e-3 there); (b) one fast train step at B=8
    (`fast_tpu_config(**KITTI_FAST)`, seeded weights), card against CPU on
    the same batch: every loss term within BWD_TOL_FAST relative; the
    score-MLP's ReLU inputs (SCORE_RELU_LAYERS) within EGNN_TOL_FAST of each
    layer's largest, and with the CPU on the card's side of each such ReLU
    whose input the two put on opposite sides of 0 (the cli gate's guard),
    every gradient within EGNN_TOL_FAST relative L2; the gap on each side's
    own branches, the cosines and the same card step on the SIMT kernels
    (forced, a comparison and not a path: its launches are not recorded)
    printed. The cli gate's SCORE_KINK_TOL (1e-5) holds fp32 on both sides;
    fast mode rounds the EGNN's operands to bf16 on both sides in another
    order of the fp32 sums, so its inputs agree only to the fast forward's
    tolerance. Then 5 timed steps and a profile of one. Every path's
    launches exact, counters at 0 just before it: 2 k-NN (3 for
    register_raw) and 2·L B2 on 'tile' (and 2·L B3 a step), no SIMT."""
    import os

    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch, random_rotation
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine

    t_phase = time.perf_counter()
    cfg = engine.robust_eval_config(**KITTI_FAST)
    L, c = cfg.n_layers, cfg.hidden_nf
    variant = egcl.egcl_variant(c, cfg.k, c // cfg.num_heads, cfg.egnn_accurate)
    check(not cfg.egnn_accurate and variant == "tile" and egcl.tile_width(c) == 48,
          f"kitti: fast mode at C={c} runs {variant}, not the bf16 tile kernel built at 48")
    model = engine.build_model(cfg, "eval_fusion", device="cpu")
    checkpoints.init_weights(model, torch.Generator().manual_seed(21))
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "kitti_fast_smoke.pth")
    checkpoints.export_reference_checkpoint(model.state_dict(), path, n_layers=L,
                                            num_heads=cfg.num_heads, hidden=c)
    reg = serving.Registrar.from_checkpoint(path, robust=True, device=dev, **KITTI_FAST)
    cpu_reg = serving.Registrar.from_checkpoint(path, robust=True, device="cpu", **KITTI_FAST)
    check(reg.device == dev and reg.cfg == cfg, f"kitti: from_checkpoint built {reg.cfg}")
    log(f"kitti: {path} ({os.path.getsize(path)} bytes) written by the port's exporter, loaded "
        f"by from_checkpoint(robust=True, {KITTI_FAST}) on {reg.device} and the CPU")

    def counted(what, call, knn_n):
        """One card call with the counters at 0 just before it; checks and
        records its launches (knn_n k-NN, 2·L B2, all 'tile')."""
        reset_knn_counters(knn)
        reset_egcl_counters(egcl)
        reset_backward_counters(eb)
        out = call()
        torch.cuda.synchronize()
        fwd = dict(egcl.egcl_layer.launches_by_variant)
        check(knn.knn_window.launches == knn_n and fwd == only("tile", 2 * L)
              and eb.egcl_backward.launches == 0,
              f"kitti {what}: launches knn {knn.knn_window.launches}, egcl {fwd}, backward "
              f"{eb.egcl_backward.launches_by_variant}")
        record_launches(rows, f"kitti {what}", dict(knn_window=knn_n, **by_row("egcl_layer", fwd, c)),
                        dict(knn_window=check_knn_warp(knn.knn_window, f"kitti {what}")))
        return out

    # (a) register() at B=16 and 64
    for b in KITTI_SERVE_B:
        pb = make_pair_batch(np.random.default_rng(30 + b), batch=b, n=cfg.num_nodes,
                             feat_dim=c)
        args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)
        got = counted(f"register() B={b}", lambda: reg.register(*args), 2)
        ms = event_ms(torch, lambda: reg.register(*args), 5)
        profile_call(torch, lambda: reg.register(*args), f"kitti fast register() B={b}")
        t1 = time.perf_counter()
        gaps = serve_gap(got, cpu_reg.register(*args), f"kitti register() B={b}")
        log(f"kitti fast register() B={b} (robust, C=33, top_k=2048): card vs CPU ‖ΔR‖/√2 "
            f"{gaps[0]:.3g}, |Δt| {gaps[1]:.3g} m, Δcov {gaps[2]:.3g}, Δsim {gaps[3]:.3g}; "
            f"{ms:.2f} ms a call ({b / ms * 1e3:.1f} pairs/s; CUDA events, 5 calls after a "
            f"warm-up); CPU {time.perf_counter() - t1:.1f} s; launches knn 2, egcl "
            f"{only('tile', 2 * L)}")

    # (a) register_raw through the same Registrar
    surf, rng = bumpy_surface(), np.random.default_rng(12)
    R = random_rotation(rng).astype(np.float32)
    src = surf(rng, EXTRA_RAW_POINTS)
    tgt = (surf(rng, EXTRA_RAW_POINTS) @ R.T + np.float32([0.1, -0.2, 0.05])).astype(np.float32)
    t1 = time.perf_counter()
    card = counted("register_raw", lambda: reg.register_raw(src, tgt), 3)
    card_s = time.perf_counter() - t1
    cc = {k: v.cpu() for k, v in reg.raw_correspondences(src, tgt).items()}
    ref = cpu_reg.raw_correspondences(src, tgt)
    check(torch.equal(cc["nbr_src"], ref["nbr_src"]) and torch.equal(cc["nbr_tgt"], ref["nbr_tgt"]),
          "kitti register_raw: k-NN tables differ card vs CPU")
    same_rows = float((cc["matches"] == ref["matches"]).float().mean())
    check(same_rows >= 0.995, f"kitti register_raw: matches equal on only {same_rows:.4f} of "
          f"the rows")
    keys = ("src_pts", "src_feat", "tgt_pts", "tgt_feat")
    on_set = serve_gap(reg.register(*(ref[k].numpy() for k in keys)),
                       cpu_reg.register(*(ref[k].numpy() for k in keys)),
                       "kitti register() on the CPU's matched set")
    full = cpu_reg.register_raw(src, tgt)
    fR = float(np.linalg.norm(card[0] - full[0]) / np.sqrt(2))
    ft = float(np.abs(card[1] - full[1]).max())
    log(f"kitti fast register_raw ({EXTRA_RAW_POINTS} points a cloud): card {card_s:.2f} s; "
        f"k-NN tables identical; matches equal {same_rows:.4f}; register() on the CPU's matched "
        f"set card vs CPU ‖ΔR‖/√2 {on_set[0]:.3g}, |Δt| {on_set[1]:.3g} m (held); full "
        f"register_raw card vs CPU ‖ΔR‖/√2 {fR:.3g}, |Δt| {ft:.3g} m (printed)")

    # (b) one fast train step at B=8, card against CPU
    tcfg = engine.fast_tpu_config(**KITTI_FAST)
    state = engine.init_state(tcfg, torch.Generator().manual_seed(22), device="cpu")
    sd = state.model.state_dict()
    pb = make_pair_batch(np.random.default_rng(23), batch=KITTI_TRAIN_B, n=tcfg.num_nodes,
                         feat_dim=c)
    batch = engine.batch_to_device(tuple(pb), dev)
    card_model = engine.build_model(tcfg, device=dev)
    card_model.load_state_dict(sd)
    card_pre = {}
    score_relu_hooks(card_model, lambda name, o: card_pre.__setitem__(name, o.detach().cpu()))
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    reset_backward_counters(eb)
    lb = engine.train_loss(card_model, tcfg, batch)
    lb.total.backward()
    torch.cuda.synchronize()
    fwd, bwd = dict(egcl.egcl_layer.launches_by_variant), dict(eb.egcl_backward.launches_by_variant)
    check(knn.knn_window.launches == 2 and fwd == only("tile", 2 * L) and bwd == only("tile", 2 * L),
          f"kitti fast train step: launches knn {knn.knn_window.launches}, egcl {fwd}, "
          f"backward {bwd}")
    record_launches(rows, f"kitti fast train step B={KITTI_TRAIN_B}",
                    dict(knn_window=2, **by_row("egcl_layer", fwd, c),
                         **by_row("egcl_backward", bwd, c)),
                    dict(knn_window=check_knn_warp(knn.knn_window, "kitti fast train step")))
    terms = {k: float(v.detach()) for k, v in lb._asdict().items()}
    gcard = {n: q.grad.detach().cpu() for n, q in card_model.named_parameters()}
    # the same step on the card with both EGCL wrappers sent to SIMT
    pick = egcl.check_variant
    egcl.check_variant = lambda variant, *shape: "simt"
    try:
        card_model.zero_grad(set_to_none=True)
        engine.train_loss(card_model, tcfg, batch).total.backward()
        gsimt = {n: q.grad.detach().cpu() for n, q in card_model.named_parameters()}
    finally:
        egcl.check_variant = pick
    t1 = time.perf_counter()
    cpu = {}
    for follow in (False, True):
        model = engine.build_model(tcfg, device="cpu")
        model.load_state_dict(sd)
        moved = {}
        if follow:
            score_relu_hooks(model, lambda name, o: follow_card(torch, name, o, card_pre, moved))
        lbc = engine.train_loss(model, tcfg, {k: v.cpu() for k, v in batch.items()})
        lbc.total.backward()
        gcpu = {n: q.grad for n, q in model.named_parameters()}
        cpu[follow] = ({k: float(v.detach()) for k, v in lbc._asdict().items()},
                       grad_cosines(torch, gcard, gcpu), moved, grad_cosines(torch, gsimt, gcpu))
    (_, raw, _, raw_simt), (cpu_terms, cos, moved, _) = cpu[False], cpu[True]
    raw_l2, simt_l2 = max(raw, key=lambda k: raw[k][1]), max(raw_simt, key=lambda k: raw_simt[k][1])
    worst, worst_l2 = min(cos, key=lambda k: cos[k][0]), max(cos, key=lambda k: cos[k][1])
    dl = {k: abs(terms[k] - cpu_terms[k]) / max(abs(cpu_terms[k]), 1e-30) for k in terms}
    log(f"kitti fast train step B={KITTI_TRAIN_B} card vs CPU: loss terms card "
        f"{json.dumps(terms)}, relative |Δ| {json.dumps(dl)}; score-MLP ReLU inputs card vs "
        f"CPU (units on opposite sides of 0, max |Δ|, max |input|): {json.dumps(moved)}; on the "
        f"card's branches worst gradient cosine {worst} {cos[worst][0]:.6f}, worst relative L2 "
        f"{worst_l2} {cos[worst_l2][1]:.3g} (each on its own branches: {raw_l2} "
        f"{raw[raw_l2][1]:.3g}; the card on the SIMT kernels, on its own branches: {simt_l2} "
        f"{raw_simt[simt_l2][1]:.3g}); CPU side {time.perf_counter() - t1:.1f} s")
    check(all(v <= BWD_TOL_FAST for v in dl.values()),
          f"kitti fast train step card vs CPU: loss terms {dl}")
    check(set(moved) == set(card_pre) == set(SCORE_RELU_LAYERS)
          and all(gap <= EGNN_TOL_FAST * top for _, gap, top in moved.values()),
          f"kitti fast train step card vs CPU: score-MLP ReLU inputs {moved}")
    check(cos[worst_l2][1] <= EGNN_TOL_FAST,
          f"kitti fast train step card vs CPU: gradients {worst_l2} {cos[worst_l2]}")
    # 5 timed steps and a profile of one
    tstate = engine.TrainState(card_model, engine.build_optimizer(card_model, tcfg))
    step = engine.make_train_step(tstate.model, tstate.optimizer, tcfg)
    step(tstate, batch)
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    reset_backward_counters(eb)
    ms = event_ms(torch, lambda: step(tstate, batch), 5)
    fwd, bwd = dict(egcl.egcl_layer.launches_by_variant), dict(eb.egcl_backward.launches_by_variant)
    check(knn.knn_window.launches == 12 and fwd == only("tile", 12 * L)
          and bwd == only("tile", 12 * L),
          f"kitti fast train steps: launches knn {knn.knn_window.launches}, egcl {fwd}, "
          f"backward {bwd} over 6 steps")
    record_launches(rows, "kitti fast train 6 steps",
                    dict(knn_window=12, **by_row("egcl_layer", fwd, c),
                         **by_row("egcl_backward", bwd, c)),
                    dict(knn_window=check_knn_warp(knn.knn_window, "kitti fast train steps")))
    prof = profile_call(torch, lambda: step(tstate, batch),
                        f"kitti fast train step B={KITTI_TRAIN_B}")
    busy = (f"device {prof[1]:.3f} ms of a {prof[0]:.2f} ms profiled wall, "
            f"{100 * prof[1] / prof[0]:.1f}% busy (profiler on)") if prof else "not measured"
    log(f"kitti fast train step B={KITTI_TRAIN_B} N={tcfg.num_nodes} C={c}: {ms:.2f} ms a step "
        f"(CUDA events, 5 steps after a warm one), {busy}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")


def cli_preset(torch, dev, rows, preset, c, base):
    """One preset of the cli phase (its docstring), in the directory `base`."""
    import os

    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, cli, config, engine

    write_cli_root(torch, os.path.join(base, "data"), preset, c, seed=5)
    ckpt, pth = os.path.join(base, "ckpt"), os.path.join(base, "export.pth")
    # per-item sampling streams: the card's and the CPU's eval see the same pairs
    common = ["--preset", preset, "--set", f"data.root={base}/data",
              "data.legacy_sampling_rng=true", f"run.checkpoint_dir={ckpt}",
              f"run.log_path={base}/log.jsonl", "run.epochs=1"]
    cfg, _ = config.parse_cli(common)
    ecfg, L = cfg.engine, cfg.engine.n_layers
    variant = egcl.egcl_variant(ecfg.hidden_nf, ecfg.k, ecfg.hidden_nf // ecfg.num_heads, True)
    width = egcl.f32_width(ecfg.hidden_nf)
    check((preset, variant, width) in (("3dmatch", "tile_f32", 32), ("kitti", "tile_f32", 36)),
          f"cli {preset}: accurate EGCL at C={ecfg.hidden_nf} runs {variant} at width {width}")
    steps = CLI_PAIRS[0] // cfg.data.batch_size
    val, test = (n // cfg.data.batch_size for n in CLI_PAIRS[1:])     # drop_last
    check(cfg.data.batch_size == 8 and ecfg.num_nodes == cfg.data.num_node == 2048,
          f"cli {preset}: preset widths changed {cfg.data}")

    def counted(what, argv, want):
        reset_knn_counters(knn)
        reset_egcl_counters(egcl)
        reset_backward_counters(eb)
        t1 = time.perf_counter()
        out, lines = quiet_cli(cli, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        counts = cli_counts(knn, egcl, eb)
        got = {w: {v: n for v, n in cnt.items() if n} for w, cnt in counts.items()}
        got = {w: cnt for w, cnt in got.items() if cnt}
        check(got == want, f"cli {preset} {what}: launches by kernel {got}, want {want}")
        for ln in lines:
            log(f"  cli {preset} {what} | {ln}")
        if want:
            fwd, bwd = counts["egcl_layer"], counts["egcl_backward"]
            record_launches(rows, f"cli {preset} {what}",
                            dict(knn_window=knn.knn_window.launches,
                                 **by_row("egcl_layer", fwd, ecfg.hidden_nf),
                                 **by_row("egcl_backward", bwd, ecfg.hidden_nf)),
                            dict(knn_window=counts["knn_window"]))
        log(f"cli {preset} {what}: {secs:.2f} s (host clock), launches {got}")
        return out

    # --- train: one epoch of `steps` steps and the validation batches
    state = counted("train", ["train", *common], {
        "knn_window": {"warp": 2 * (steps + val)},
        "egcl_layer": {variant: 2 * L * (steps + val)},
        "egcl_backward": {variant: 2 * L * steps}})
    check(state.step == steps, f"cli {preset} train: {state.step} steps, want {steps}")
    rows_log = [json.loads(ln) for ln in open(f"{base}/log.jsonl")]
    check(len(rows_log) == 1 and all(np.isfinite(v) for v in rows_log[0].values()),
          f"cli {preset} train log {rows_log}")
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    # --- export: no kernel; the file reads back to the trained weights
    counted("export", ["export", *common, "--checkpoint", ckpt, "--out", pth], {})
    back = checkpoints.convert_reference_checkpoint(pth, n_layers=L, num_heads=ecfg.num_heads,
                                                    hidden=ecfg.hidden_nf)
    check(set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd),
          f"cli {preset} export: the .pth does not read back to the trained weights")
    # --- eval on the card and on the CPU; spies keep each pair's pose and
    # what the EGNN gives the eval head (the embeddings, the correspondence
    # logits and the Kabsch weights), which the pose alone may not show: at
    # kitti every test correspondence is an inlier and top_k = N
    poses, heads = {}, {}
    real, real_apply = engine.metrics_lib.calculate_pose_error, engine._apply_with_graphs

    def spy(gt, pred):
        poses.setdefault(spy.device, []).append(pred.detach().cpu())
        return real(gt, pred)

    def apply_spy(*a, **kw):
        out = real_apply(*a, **kw)
        heads.setdefault(spy.device, []).append(
            {k: getattr(out, k).detach().cpu() for k in ("h_src", "h_tgt", "scores", "weights")})
        return out

    engine.metrics_lib.calculate_pose_error = spy
    engine._apply_with_graphs = apply_spy
    try:
        evals = {}
        for device in ("cuda", "cpu"):
            spy.device = device
            argv = ["eval", *common, "--checkpoint", ckpt,
                    "--set", f"run.eval_output={base}/eval_{device}.txt"]
            if device == "cpu":
                t1 = time.perf_counter()
                evals[device], _ = quiet_cli(cli, argv + ["--device", "cpu"])
                log(f"cli {preset} eval --device cpu: {time.perf_counter() - t1:.1f} s")
            else:
                evals[device] = counted("eval", argv, {"knn_window": {"warp": 2 * test},
                                                       "egcl_layer": {variant: 2 * L * test}})
    finally:
        engine.metrics_lib.calculate_pose_error = real
        engine._apply_with_graphs = real_apply
    P = {d: torch.cat(v) for d, v in poses.items()}
    H = {d: {k: torch.cat([o[k] for o in v]) for k in v[0]} for d, v in heads.items()}
    rel = {k: float((H["cuda"][k] - H["cpu"][k]).abs().max() / H["cpu"][k].abs().max())
           for k in H["cpu"]}
    log(f"cli {preset} eval card vs CPU, max|Δ| of the scale: " + ", ".join(
        f"{k} {v:.3g}" for k, v in rel.items()))
    check(all(v <= EGNN_TOL_ACCURATE for v in rel.values()),
          f"cli {preset} eval: card vs CPU EGNN embeddings and head outputs {rel}")
    check(P["cuda"].shape == P["cpu"].shape == (CLI_PAIRS[2], 4, 4)
          and bool(torch.isfinite(P["cuda"]).all()), f"cli {preset} eval poses {P['cuda'].shape}")
    dR = float((P["cuda"][:, :3, :3] - P["cpu"][:, :3, :3]).flatten(1).norm(dim=1).max())
    dR /= 2 ** 0.5
    dt = float((P["cuda"][:, :3, 3] - P["cpu"][:, :3, 3]).abs().max())
    ds = {k: abs(evals["cuda"][k] - evals["cpu"][k]) for k in evals["cpu"]}
    log(f"cli {preset} eval card vs CPU: per-pair max‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m; "
        f"summary card {json.dumps(evals['cuda'])}; |Δ| {json.dumps(ds)}")
    check(dR <= 1e-4 and dt <= 1e-4, f"cli {preset} eval: card vs CPU poses dR {dR} dt {dt}")
    check(evals["cuda"]["num_pairs"] == CLI_PAIRS[2] and ds["avg_translation_error_cm"] <= 1e-2
          and all(ds[k] <= 1e-4 for k in ("avg_registration_recall", "avg_precision", "avg_f1")),
          f"cli {preset} eval: card vs CPU summaries {evals}")
    # --- remat: one step with engine.remat=true against one without, same weights and batch
    batch = engine.batch_to_device(next(iter(cli._loader(cfg, "train", shuffle=False)())), dev)
    losses, card_pre = {}, {}
    for remat in (False, True):
        rcfg, _ = config.parse_cli(common + ["--set", f"engine.remat={str(remat).lower()}"])
        model = engine.build_model(rcfg.engine, device=dev)
        model.load_state_dict(sd)
        if remat:
            score_relu_hooks(model, lambda name, o: card_pre.__setitem__(name, o.detach().cpu()))
        reset_egcl_counters(egcl)
        reset_backward_counters(eb)
        lb = engine.train_loss(model, rcfg.engine, batch)
        lb.total.backward()
        torch.cuda.synchronize()
        losses[remat] = (lb.total.detach().cpu(), dict(egcl.egcl_layer.launches_by_variant),
                         dict(eb.egcl_backward.launches_by_variant),
                         {n: q.grad.detach().cpu() for n, q in model.named_parameters()})
        terms = {k: float(v.detach()) for k, v in lb._asdict().items()}
    (l0, f0, b0, g0), (l1, f1, b1, g1) = losses[False], losses[True]
    worst = max(g0, key=lambda n: float((g1[n] - g0[n]).abs().max() / g0[n].abs().max()))
    rel = float((g1[worst] - g0[worst]).abs().max() / g0[worst].abs().max())
    log(f"cli {preset} remat step: loss {float(l1):.6f} vs {float(l0):.6f}; EGCL launches "
        f"{f1} vs {f0}, backward {b1} vs {b0}; worst gradient |Δ| {worst} {rel:.3g} of its scale")
    check(f0 == only(variant, 2 * L) and f1 == only(variant, 4 * L)
          and b0 == b1 == only(variant, 2 * L),
          f"cli {preset} remat: EGCL launches {f1} vs {f0}, backward {b1} vs {b0}")
    check(torch.equal(l0, l1), f"cli {preset} remat: loss {l1} vs {l0}")
    check(rel <= BWD_TOL_ACCURATE, f"cli {preset} remat: gradient {worst} moved {rel} of its scale")
    # --- the same step on the CPU: every loss term and every gradient, first
    # as it falls (printed), then on the card's side of each score-MLP ReLU
    # whose input the two put on opposite sides of 0 (held; SCORE_KINK_TOL)
    t1 = time.perf_counter()
    cpu = {}
    for follow in (False, True):
        model = engine.build_model(ecfg, device="cpu")
        model.load_state_dict(sd)
        moved = {}
        if follow:
            score_relu_hooks(model, lambda name, o: follow_card(torch, name, o, card_pre, moved))
        lb = engine.train_loss(model, ecfg, {k: v.cpu() for k, v in batch.items()})
        lb.total.backward()
        cpu[follow] = ({k: float(v.detach()) for k, v in lb._asdict().items()},
                       grad_cosines(torch, g1, {n: q.grad for n, q in model.named_parameters()}),
                       moved)
    (_, raw, _), (cpu_terms, cos, moved) = cpu[False], cpu[True]
    raw_l2 = max(raw, key=lambda k: raw[k][1])
    worst, worst_l2 = min(cos, key=lambda k: cos[k][0]), max(cos, key=lambda k: cos[k][1])
    dl = {k: abs(terms[k] - cpu_terms[k]) / abs(cpu_terms[k]) for k in terms}
    log(f"cli {preset} train step card vs CPU: loss terms card {json.dumps(terms)}, relative "
        f"|Δ| {json.dumps(dl)}; score-MLP ReLU inputs card vs CPU (units on opposite sides "
        f"of 0, max |Δ|, max |input|): {json.dumps(moved)}; on the card's branches worst "
        f"gradient cosine {worst} {cos[worst][0]:.6f}, worst relative L2 {worst_l2} "
        f"{cos[worst_l2][1]:.2g} (each on its own branches: {raw_l2} {raw[raw_l2][1]:.2g}); "
        f"CPU side {time.perf_counter() - t1:.1f} s")
    check(all(v <= 1e-4 for v in dl.values()), f"cli {preset} train card vs CPU: loss terms {dl}")
    check(set(moved) == set(card_pre) == set(SCORE_RELU_LAYERS)
          and all(gap <= SCORE_KINK_TOL * top for _, gap, top in moved.values()),
          f"cli {preset} train card vs CPU: score-MLP ReLU inputs {moved}")
    check(cos[worst][0] >= 0.9999 and cos[worst_l2][1] <= 1e-4,
          f"cli {preset} train card vs CPU: gradients {worst} {cos[worst]}, {worst_l2} "
          f"{cos[worst_l2]}")
    # --- a step's wall time and a profile of one step
    step = engine.make_train_step(state.model, state.optimizer, ecfg)
    step(state, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t1) / 5 * 1e3
    prof = profile_call(torch, lambda: step(state, batch),
                        f"cli {preset} train step B={cfg.data.batch_size}")
    busy = (f"device {prof[1]:.3f} ms of a {prof[0]:.2f} ms profiled wall, "
            f"{100 * prof[1] / prof[0]:.1f}% busy (profiler on)") if prof else "not measured"
    log(f"cli {preset} train step B={cfg.data.batch_size} N={ecfg.num_nodes} C={ecfg.hidden_nf}: "
        f"{wall:.2f} ms a step (host clock, 5 steps after a warm one, synchronized), {busy}; "
        f"{card_line()}")


def other_configs(torch, dev, cfg, sd, args, same, rows):
    """Every other configuration the engine accepts launches both kernels
    on the card and matches the CPU: the whole-cloud graph ('exact' and
    'approx', fp32 EGCL, SVD Kabsch) and the Morton-curve window with exact
    keys, every k-NN launch on the exact warp kernel. Two pairs each,
    counters reset per configuration. Then a profile of `register()` at
    `EngineConfig()` defaults (the whole-cloud exact graph and the accurate
    EGCL kernels) at the largest batch."""
    import dataclasses

    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.train import engine

    base = dataclasses.asdict(cfg)
    variants = {
        "exact": dict(knn_method="exact", knn_packed=False, egnn_impl="xla",
                      egnn_accurate=True, kabsch_solver="svd"),
        "approx": dict(knn_method="approx", knn_packed=False, egnn_accurate=False),
        "morton window, exact keys": dict(knn_packed=False, curve="morton",
                                          egnn_accurate=True),
    }
    for name, kw in variants.items():
        vcfg = engine.EngineConfig(**dict(base, **kw))
        reg = serving.Registrar(sd, vcfg, device=dev)
        reset_knn_counters(knn)
        reset_egcl_counters(egcl)
        res = reg.register(*args(slice(0, 2)))
        kd, ed = knn.knn_window.launches, egcl.egcl_layer.launches
        by_variant = dict(egcl.egcl_layer.launches_by_variant)
        check(kd == 2 and ed == 2 * vcfg.n_layers,
              f"config {name}: register() launched knn {kd}, egcl {ed}")
        knn_by_variant = check_knn_warp(knn.knn_window, f"config {name}")
        want = egcl.egcl_variant(vcfg.hidden_nf, vcfg.k, vcfg.hidden_nf // vcfg.num_heads,
                                 vcfg.egnn_accurate)
        check(by_variant == only(want, ed), f"config {name}: EGCL launches by kernel {by_variant}")
        record_launches(rows, f"config {name}", dict(knn_window=kd,
                                                     **by_row("egcl_layer", by_variant)),
                        dict(knn_window=knn_by_variant))
        dR, dt, _, _ = same(res, serving.Registrar(sd, vcfg, device="cpu").register(
            *args(slice(0, 2))), f"config {name}")
        log(f"config {name}: launches knn {kd} ({knn_by_variant}) egcl {ed} ({by_variant}); "
            f"card vs CPU max‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m")
    dcfg = engine.EngineConfig(**{f: base[f] for f in ("num_nodes", "k", "in_node_nf",
                                                       "hidden_nf", "n_layers", "num_heads",
                                                       "top_k")})
    reg = serving.Registrar(sd, dcfg, device=dev)
    bsz = len(args(slice(None))[0])
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    profile_call(torch, lambda: reg.register(*args(slice(0, bsz))),
                 f"register() at EngineConfig() defaults (exact whole-cloud k-NN, accurate "
                 f"fp32 tile EGCL) B={bsz}")
    by_variant = dict(egcl.egcl_layer.launches_by_variant)
    check(by_variant == only("tile_f32", 4 * dcfg.n_layers),
          f"register() at EngineConfig() defaults, 2 calls: EGCL launches by kernel "
          f"{by_variant}, want {4 * dcfg.n_layers} tile_f32")
    knn_by_variant = check_knn_warp(knn.knn_window, "register() at EngineConfig() defaults")
    record_launches(rows, "serve defaults", dict(knn_window=knn.knn_window.launches,
                                                 **by_row("egcl_layer", by_variant)),
                    dict(knn_window=knn_by_variant))
    log(f"register() at EngineConfig() defaults, 2 calls: launches knn "
        f"{knn.knn_window.launches} ({knn_by_variant}) egcl {by_variant}")


# serve_extra: the clique prefilter's correspondences (CLIQUE_N, a share
# CLIQUE_OUTLIERS of gross outliers), register_raw's raw clouds (points a
# cloud, the voxel of the downsampled case), the Registrar export's batch
EXTRA_CLIQUE_N, EXTRA_CLIQUE_OUTLIERS = 2048, 0.4
EXTRA_RAW_POINTS, EXTRA_RAW_VOXEL = 20000, 0.03
EXTRA_EXPORT_B, EXTRA_FPFH_B = 16, 8
OP_OVERHEAD_CALLS = 1000

# The deployment site of a Registrar artifact: a fresh interpreter that
# imports torch and the port's op library only, loads the program, runs it
# on the saved inputs with the launch counters at 0, then again with TF32
# switched on globally, and reports what it counted and imported.
EXPORT_CHILD = r"""
import json, sys, time
import torch
from se3_equi_graph_registration_tpu_torch.ops.kernels import load_program
from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
path, inputs, outputs = sys.argv[1:4]
fn = load_program(path)
params, batch = torch.load(inputs)
def run():
    out = fn(params, batch)
    torch.cuda.synchronize()
    return out
run()
t0 = time.perf_counter()
for _ in range(10):
    run()
host_ms = (time.perf_counter() - t0) * 100.0
counts = []
results = []
for tf32 in (False, True):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    knn.knn_window.launches_by_variant = {"warp": 0, "thread": 0}
    egcl.egcl_layer.launches_by_variant = dict.fromkeys(egcl.VARIANTS, 0)
    results.append([t.cpu() for t in run()])
    counts.append({"knn_window": knn.knn_window.launches_by_variant,
                   "egcl_layer": egcl.egcl_layer.launches_by_variant,
                   "tf32_after": torch.backends.cuda.matmul.allow_tf32})
torch.save(results, outputs)
mods = sorted(m for m in sys.modules if m.startswith("se3_equi_graph_registration_tpu")
              or m == "jax" or m.startswith("jax."))
print(json.dumps({"counts": counts, "host_ms": host_ms, "modules": mods}))
"""


def outlier_requests(n, frac, c, seed):
    """One correspondence set as the JAX prefilter test builds it: a rigid
    copy of n Gaussian points with the first `frac` of the targets replaced
    by gross outliers, and random descriptors; (src, feat, tgt, n_bad)."""
    from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation

    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n, 3)).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    tgt = src @ R.T + np.float32([0.2, -0.1, 0.3])
    n_bad = int(frac * n)
    tgt[:n_bad] = rng.standard_normal((n_bad, 3)).astype(np.float32) * 2.0
    return src, rng.standard_normal((n, c)).astype(np.float32), tgt, n_bad


def serve_extra_phase(torch, dev, cfg, sd, rows):
    """The rest of serving, at full width on the card (module docstring):
    (a) the clique prefilter, (b) register_raw at the kitti preset, (c) the
    Registrar's torch.export artifact loaded in a fresh process, (d) the
    pipeline's artifact, (e) export times, sizes and the ops' host cost."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        extra_clique(torch, dev, cfg, sd, rows)
        extra_register_raw(torch, dev, rows)
        extra_registrar_export(torch, dev, cfg, sd, rows, tmp)
        extra_pipeline_export(torch, dev, rows, os.path.join(tmp, "register.pt2"))
    extra_op_overhead(torch, dev)
    log(f"serve_extra: {time.perf_counter() - t_phase:.1f} s")


def extra_clique(torch, dev, cfg, sd, rows):
    """(a) register(clique_prefilter=True) at `cfg`, card against CPU: the
    labels come from the host on both sides (equal); the poses at the serve
    gate; the solver's time printed."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn

    reg = serving.Registrar(sd, cfg, device=dev)
    cpu_reg = serving.Registrar(sd, cfg, device="cpu")
    src, feat, tgt, n_bad = outlier_requests(EXTRA_CLIQUE_N, EXTRA_CLIQUE_OUTLIERS,
                                             cfg.in_node_nf, 7)
    t0 = time.perf_counter()
    lbl = reg._clique_labels(src, tgt, 0.10)
    solve_s = time.perf_counter() - t0
    kept_in, kept_out = lbl[n_bad:].mean(), lbl[:n_bad].mean()
    check(kept_in >= 0.8 and kept_out <= 0.1,
          f"clique: kept {kept_in:.3f} of the inliers and {kept_out:.3f} of the outliers")
    reset_knn_counters(knn)
    reset_egcl_counters(egcl)
    t0 = time.perf_counter()
    card = reg.register(src, feat, tgt, feat, clique_prefilter=True)
    card_s = time.perf_counter() - t0
    kd, by_variant = knn.knn_window.launches, dict(egcl.egcl_layer.launches_by_variant)
    want = egcl.egcl_variant(cfg.hidden_nf, cfg.k, cfg.hidden_nf // cfg.num_heads,
                             cfg.egnn_accurate)
    check(kd == 2 and by_variant == only(want, 2 * cfg.n_layers),
          f"clique register(): launches knn {kd}, egcl {by_variant}")
    record_launches(rows, "serve_extra clique", dict(knn_window=kd,
                                                     **by_row("egcl_layer", by_variant)),
                    dict(knn_window=check_knn_warp(knn.knn_window, "clique register()")))
    check(card[2]["clique_inliers"] == [int(lbl.sum())],
          f"clique: card clique_inliers {card[2]['clique_inliers']}, host labels {lbl.sum()}")
    dR, dt, _, _ = serve_gap(card, cpu_reg.register(src, feat, tgt, feat, labels=lbl),
                             "clique register()")
    log(f"clique prefilter (N={EXTRA_CLIQUE_N}, {EXTRA_CLIQUE_OUTLIERS:.0%} outliers, tau "
        f"0.10): consistency graph + exact clique {solve_s:.2f} s on the host, clique "
        f"{int(lbl.sum())} (inliers kept {kept_in:.4f}, outliers {kept_out:.4f}); card "
        f"register(clique_prefilter=True) {card_s:.2f} s; card vs CPU max‖ΔR‖/√2 {dR:.3g}, "
        f"max|Δt| {dt:.3g} m")


def extra_register_raw(torch, dev, rows):
    """(b) register_raw at the kitti preset's engine config (N=2048, C=33, 1
    head, top_k=2048; the fp32 tile EGCL built at CP=36), seeded weights, on a bumpy
    surface pair of EXTRA_RAW_POINTS points, without and with a voxel:
    the k-NN tables identical card vs CPU, descriptor entries apart by more
    than 0.1 counted, matches equal on ≥ 99.5% of the rows, the card's
    register() on the CPU's matched set at the serve gate; the full
    register_raw gap card vs CPU printed."""
    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import random_rotation
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, config, engine

    kcfg = config.preset("kitti").engine
    model = engine.build_model(kcfg, "eval_fusion", device="cpu")
    checkpoints.init_weights(model, torch.Generator().manual_seed(1))
    reg = serving.Registrar(model.state_dict(), kcfg, device=dev)
    cpu_reg = serving.Registrar(model.state_dict(), kcfg, device="cpu")
    surf, rng = bumpy_surface(), np.random.default_rng(11)
    R = random_rotation(rng).astype(np.float32)
    src = surf(rng, EXTRA_RAW_POINTS)
    tgt = (surf(rng, EXTRA_RAW_POINTS) @ R.T + np.float32([0.1, -0.2, 0.05])).astype(np.float32)
    keys = ("src_pts", "src_feat", "tgt_pts", "tgt_feat")
    for voxel in (0.0, EXTRA_RAW_VOXEL):
        reset_knn_counters(knn)
        reset_egcl_counters(egcl)
        t0 = time.perf_counter()
        card = reg.register_raw(src, tgt, voxel=voxel)
        card_s = time.perf_counter() - t0
        kd, by_variant = knn.knn_window.launches, dict(egcl.egcl_layer.launches_by_variant)
        check(kd == 3 and by_variant == only("tile_f32", 2 * kcfg.n_layers),
              f"register_raw voxel={voxel}: launches knn {kd} (1 descriptor table, 2 "
              f"graphs), egcl {by_variant}")
        record_launches(rows, f"serve_extra register_raw voxel={voxel}",
                        dict(knn_window=kd, **by_row("egcl_layer", by_variant, kcfg.hidden_nf)),
                        dict(knn_window=check_knn_warp(knn.knn_window, "register_raw")))
        c = {k: v.cpu() for k, v in reg.raw_correspondences(src, tgt, voxel=voxel).items()}
        ref = cpu_reg.raw_correspondences(src, tgt, voxel=voxel)
        check(torch.equal(c["src_pts"], ref["src_pts"]), "register_raw: fitted clouds differ")
        check(torch.equal(c["nbr_src"], ref["nbr_src"]) and torch.equal(c["nbr_tgt"],
                                                                          ref["nbr_tgt"]),
              f"register_raw voxel={voxel}: k-NN tables differ card vs CPU")
        far = int((c["src_feat"] - ref["src_feat"]).abs().gt(0.1).sum())
        same_rows = float((c["matches"] == ref["matches"]).float().mean())
        log(f"register_raw voxel={voxel}: gather FPFH card vs CPU by stage (source "
            f"clouds): {fpfh_divergence(torch, dev, ref['src_pts'], ref['nbr_src'], 30, 60)}")
        check(same_rows >= 0.995, f"register_raw voxel={voxel}: matches equal on only "
              f"{same_rows:.4f} of the rows")
        on_cpu_set = reg.register(*(ref[k].numpy() for k in keys))
        dR, dt, _, _ = serve_gap(on_cpu_set, cpu_reg.register(*(ref[k].numpy() for k in keys)),
                                 f"register() on the CPU's matched set, voxel={voxel}")
        full = cpu_reg.register_raw(src, tgt, voxel=voxel)
        fR = np.linalg.norm(card[0] - full[0]) / np.sqrt(2)
        ft = float(np.abs(card[1] - full[1]).max())
        log(f"register_raw voxel={voxel} ({EXTRA_RAW_POINTS} points a cloud, kitti preset, "
            f"N={kcfg.num_nodes}): card {card_s:.2f} s; k-NN tables identical; source "
            f"descriptor entries apart by > 0.1: {far} of {c['src_feat'].numel()}; matches "
            f"equal {same_rows:.4f}; register() on the CPU's set card vs CPU max‖ΔR‖/√2 "
            f"{dR:.3g}, max|Δt| {dt:.3g} m; full register_raw card vs CPU ‖ΔR‖/√2 {fR:.3g}, "
            f"|Δt| {ft:.3g} m")


def fpfh_divergence(torch, dev, x, nbr, k_normals, k_fpfh):
    """Where the gather FPFH of the same clouds x [B, N, 3] and k-NN table
    nbr [B, N, K] (CPU tensors) parts card from CPU, stage by stage as
    `ops/fpfh.fpfh` computes it: the normals (max |Δ|, sign flips),
    the Darboux source pick (edges whose source end swapped), and the α, φ
    and θ bins (edges in another bin, all and where the pick agrees)."""
    from se3_equi_graph_registration_tpu_torch.ops import fpfh
    from se3_equi_graph_registration_tpu_torch.ops.knn import gather_rows

    per = {}
    for d in ("cpu", dev):
        xd, nd = x.to(d), nbr.to(d)
        normals = fpfh.estimate_normals(xd, orient="local", nbr=nd[..., :k_normals])
        nf = nd[..., :k_fpfh]
        p_j, n_j = gather_rows(xd, nf), gather_rows(normals, nf)
        n_i = normals[..., :, None, :].expand_as(p_j)
        dv = p_j - xd[..., :, None, :]
        dist = torch.linalg.vector_norm(dv, dim=-1)
        dhat = dv / (dist[..., None] + 1e-12)
        cos_i = torch.abs(torch.sum(n_i * dhat, dim=-1))
        cos_j = torch.abs(torch.sum(n_j * dhat, dim=-1))
        take_i = (cos_i >= cos_j - fpfh.PICK_TIE)[..., None]
        u = torch.where(take_i, n_i, n_j)
        n_t = torch.where(take_i, n_j, n_i)
        dvec = torch.where(take_i, dhat, -dhat)
        v = torch.linalg.cross(dvec, u, dim=-1)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        w = torch.linalg.cross(u, v, dim=-1)
        feats = (torch.sum(v * n_t, dim=-1), torch.sum(u * dvec, dim=-1),
                 torch.atan2(torch.sum(w * n_t, dim=-1), torch.sum(u * n_t, dim=-1)))
        spans = ((-1.0, 1.0), (-1.0, 1.0), (-np.pi, np.pi))
        bins = [torch.floor(torch.clamp((f - lo) / (hi - lo), 0.0, 1.0 - 1e-7) * 11)
                for f, (lo, hi) in zip(feats, spans)]
        per[d] = [t.cpu() for t in (normals, take_i[..., 0], cos_i - cos_j, *bins)]
    (na, ta, ga, *ba), (nb, tb, gb, *bb) = per["cpu"], per[dev]
    pick = ta != tb
    flips = [int((a != b).sum()) for a, b in zip(ba, bb)]
    flips_same_pick = [int(((a != b) & ~pick).sum()) for a, b in zip(ba, bb)]
    return dict(normals_max=float((na - nb).abs().max()),
                normals_opposed=int(((na * nb).sum(-1) < 0).sum()),
                pick_swapped=int(pick.sum()), edges=int(pick.numel()),
                pick_gap_max=float(ga[pick].abs().max()) if pick.any() else 0.0,
                bin_flips_alpha_phi_theta=flips,
                bin_flips_where_pick_agrees=flips_same_pick)


def extra_registrar_export(torch, dev, cfg, sd, rows, tmp):
    """(c) The Registrar at `cfg` exported on the card at B=EXTRA_EXPORT_B,
    saved, and loaded in a fresh interpreter (EXPORT_CHILD): its outputs
    equal register()'s on the same batch (within 1e-6, of the scale for the
    covariance and the similarity), 2 warp k-NN and 2·L bf16 tile EGCL
    launches counted at run time, and the same outputs with TF32 switched
    on globally."""
    import json
    import os

    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch

    reg = serving.Registrar(sd, cfg, device=dev)
    b, n = EXTRA_EXPORT_B, cfg.num_nodes
    pb = make_pair_batch(np.random.default_rng(3), batch=b, n=n, feat_dim=cfg.in_node_nf)
    path, inputs, outputs = (os.path.join(tmp, f) for f in ("registrar.pt2", "in.pt", "out.pt"))
    t0 = time.perf_counter()
    size = reg.export_compiled(path, batch=b)
    export_s = time.perf_counter() - t0
    batch = {"src_pts": pb.src_pts, "src_feat": pb.src_feat, "tgt_pts": pb.tgt_pts,
             "tgt_feat": pb.tgt_feat, "labels": np.ones((b, n), np.float32)}
    batch = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev) for k, v in batch.items()}
    params = {k: v.detach() for k, v in reg.model.state_dict().items()}
    torch.save((params, batch), inputs)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", EXPORT_CHILD, path, inputs, outputs],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    child_s = time.perf_counter() - t0
    check(res.returncode == 0, f"export child failed:\n{res.stdout}\n{res.stderr[-4000:]}")
    report = json.loads(res.stdout.strip().splitlines()[-1])
    allowed = ("se3_equi_graph_registration_tpu_torch", "se3_equi_graph_registration_tpu_torch.ops")
    stray = [m for m in report["modules"]
             if m not in allowed and not m.startswith(("se3_equi_graph_registration_tpu_torch.ops.",))]
    check(not stray, f"the artifact's loader imported {stray}")
    want_counts = {"knn_window": {"warp": 2, "thread": 0},
                   "egcl_layer": only("tile", 2 * cfg.n_layers), "tf32_after": None}
    for counts, tf32 in zip(report["counts"], (False, True)):
        check({**counts, "tf32_after": None} == want_counts and counts["tf32_after"] == tf32,
              f"loaded Registrar (TF32 {tf32}): run-time launches {counts}")
    record_launches(rows, "serve_extra loaded Registrar", dict(knn_window=4,
                                                               egcl_layer=4 * cfg.n_layers),
                    dict(knn_window={"warp": 4, "thread": 0}))
    R, t, info = reg.register(*(np.asarray(a) for a in (pb.src_pts, pb.src_feat, pb.tgt_pts,
                                                         pb.tgt_feat)))
    loaded = torch.load(outputs)
    gaps = []
    for out in loaded:
        lR, lt, lsim, lcov = (a.numpy() for a in out)
        gaps.append((float(np.abs(lR - R).max()), float(np.abs(lt - t).max()),
                     abs(float(lsim.mean()) - info["similarity_mean"]) / abs(info["similarity_mean"]),
                     float(np.abs(lcov - info["pose_covariance"]).max()
                           / np.abs(info["pose_covariance"]).max())))
        check(max(gaps[-1]) <= 1e-6, f"loaded Registrar vs register(): gaps {gaps[-1]}")
    check(all(torch.equal(a, c) for a, c in zip(*loaded)),
          "loaded Registrar: TF32 on globally changed the outputs")
    with torch.no_grad():
        reg._apply(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            reg._apply(batch)
        torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 100.0
    args = tuple(np.asarray(a) for a in (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat))
    reg.register(*args)
    t0 = time.perf_counter()
    for _ in range(10):
        reg.register(*args)
    register_ms = (time.perf_counter() - t0) * 100.0
    log(f"Registrar export (fast_tpu_config, B={b}): export {export_s:.2f} s, artifact "
        f"{size} bytes; fresh-process load + runs {child_s:.1f} s, imports {report['modules']}; "
        f"run-time launches {report['counts'][0]}; loaded vs register() gaps (R, t, sim, cov) "
        f"{gaps[0]}, TF32 on {gaps[1]} (outputs equal); host ms a call: loaded program "
        f"{report['host_ms']:.2f} (device-resident batch), eager _apply {eager_ms:.2f}, "
        f"register() {register_ms:.2f} (numpy in and out)")


def extra_pipeline_export(torch, dev, rows, path):
    """(d) The checkpoint-free pipeline exported at knn_method='fused',
    knn_packed='chunked', window 768, N=2048, batch EXTRA_FPFH_B and the SVD
    Kabsch (the other knobs register_fpfh's defaults), loaded: equal to
    register_fpfh_batch with the same seed's noise (within 1e-6 of each
    output's scale), 2 B4 and 2 B5 launches counted in the loaded call, no
    B1. The quaternion Kabsch's 60 power steps a solve unroll in the trace:
    at the default solver the export took 101.35 s and the artifact 36.0 MB,
    with SVD 63.84 s and 29.5 MB (the card machine's host, torch 2.11)."""
    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.ops.ransac import gumbel_noise

    b, seed = EXTRA_FPFH_B, 5
    kw = dict(knn_method="fused", knn_packed="chunked", window=FPFH_WINDOW, solver="svd")
    t0 = time.perf_counter()
    size = registration.export_compiled(path, batch=b, n_points=FPFH_N, **kw)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = registration.load_exported(path)
    load_s = time.perf_counter() - t0
    pairs = surface_pairs(b, 21)
    src = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    R, t, info = registration.register_fpfh_batch(src, tgt, seed=seed, **kw)
    noise = torch.as_tensor(gumbel_noise(seed, (512, 3, 512), b)).to(dev)
    xs, xt = torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)
    fn(xs, xt, noise)
    torch.cuda.synchronize()
    reset_all_counters(knn, egcl, spfh)
    t0 = time.perf_counter()
    out = [a.cpu().numpy() for a in fn(xs, xt, noise)]
    call_ms = (time.perf_counter() - t0) * 1e3
    counts = counted_launches(knn, egcl, spfh)
    check(counts["knn_chunked"] == {"warp": 2, "thread": 0}
          and counts["spfh"] == {"redux": 2, "ballot": 0}
          and sum(counts["knn_window"].values()) == 0,
          f"loaded pipeline: run-time launches {counts}")
    record_launches(rows, "serve_extra loaded pipeline", dict(knn_chunked=2, spfh=2),
                    dict(knn_chunked=counts["knn_chunked"], spfh=counts["spfh"]))
    gaps = [float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
            for g, w in zip(out, (R, t, info["weights"], info["pose_covariance"]))]
    check(max(gaps) <= 1e-6, f"loaded pipeline vs register_fpfh_batch: gaps {gaps}")
    log(f"pipeline export (fused, chunked, W={FPFH_WINDOW}, N={FPFH_N}, batch {b}, SVD): export "
        f"{export_s:.2f} s, artifact {size} bytes, load {load_s:.2f} s; loaded call "
        f"{call_ms:.1f} ms (host clock, incl. the result copy); launches {counts}; gaps "
        f"(R, t, weights, cov) {gaps}")


def extra_op_overhead(torch, dev):
    """(e) The host cost of a custom op: one knn_window call on one cloud
    (packed keys, k=16, W=384) through the wrapper and its op, the op called
    directly, and the allocation plus the ctypes launch alone, each over
    OP_OVERHEAD_CALLS calls."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn

    x = torch.rand(1, 2048, 3, device=dev)
    b, n, k, tile, w = 1, 2048, 16, 128, 384
    _, pad_tiles, max_tile = knn._geometry(n, tile, w, True, k)

    def direct():
        out = torch.empty((b, n, k), dtype=torch.int32, device=dev)
        knn._launch("knn_warp", "knn_warp_launch", x, out, b, n, k, tile, w, pad_tiles,
                    max_tile, 1, knn._queries_per_warp(b, n))

    paths = {"wrapper + op": lambda: knn.knn_window(x, k, tile, w, packed=True),
             "op": lambda: knn.knn_window_op(x, k, tile, w, True, True, "warp", 0),
             "alloc + ctypes launch": direct}
    times = {}
    for name, fn in paths.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_OVERHEAD_CALLS):
            fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e6 / OP_OVERHEAD_CALLS
    fx_config = getattr(torch.fx, "config", None)
    log(f"torch {torch.__version__}: the export's stack-trace switch "
        f"(torch.fx.config.do_not_emit_stack_traces) "
        f"{'present' if hasattr(fx_config, 'do_not_emit_stack_traces') else 'absent'}")
    log("host µs a knn_window call on one cloud: " + ", ".join(
        f"{name} {us:.2f}" for name, us in times.items())
        + f"; the op adds {times['op'] - times['alloc + ctypes launch']:.2f}")


VARIANTS_PAIRS = 16           # register() requests of (a), (b); train pairs of (c)
VARIANTS_POINTNET_PAIRS = 8   # train pairs of (d)


def variants_phase(torch, dev, cfg, sd, rows):
    """The model variants at full width (N=2048, k=16, C=32, 3 layers, 4
    heads, top_k=128), each timed with CUDA events after a warm-up and
    profiled over one call, its
    launches counted by kernel with the counters at 0 just before it:
    (a) a 'cluster' Registrar from a `.pth` the port's exporter writes from
    the seeded weights (the reference checkpoints' orientation), eval_fusion
    head, at `EngineConfig()` otherwise; (b) an 'invariant' Registrar and
    the EGNN's rotation equivariance on the card; (c) 5 train steps at
    `fast_tpu_config(bf16_params=True)`, then its first step and the same
    step in accurate mode against the CPU; (d) one train step with the
    PointNet encoder at `EngineConfig(use_pointnet=True)`. Each against the
    same call on the CPU."""
    import copy
    import dataclasses
    import os

    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import build, egcl, knn
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb
    from se3_equi_graph_registration_tpu_torch.train import checkpoints, engine

    t_phase = time.perf_counter()
    width = dict(num_nodes=cfg.num_nodes, k=cfg.k, in_node_nf=cfg.in_node_nf,
                 hidden_nf=cfg.hidden_nf, n_layers=cfg.n_layers, num_heads=cfg.num_heads,
                 top_k=cfg.top_k)
    L, b = cfg.n_layers, VARIANTS_PAIRS
    pb = make_pair_batch(np.random.default_rng(41), batch=b, n=cfg.num_nodes,
                         feat_dim=cfg.in_node_nf)
    args = (pb.src_pts, pb.src_feat, pb.tgt_pts, pb.tgt_feat)

    def counts():
        return (dict(knn.knn_window.launches_by_variant),
                dict(egcl.egcl_layer.launches_by_variant),
                dict(eb.egcl_backward.launches_by_variant))

    def reset():
        reset_knn_counters(knn)
        reset_egcl_counters(egcl)
        reset_backward_counters(eb)

    def record(path, got):
        kc, fc, bc = got
        record_launches(rows, f"variants {path}",
                        dict(knn_window=sum(kc.values()), **by_row("egcl_layer", fc),
                             **by_row("egcl_backward", bc)), dict(knn_window=kc))

    results = {}

    def serve(name, reg, cpu_reg):
        """One Registrar at B=16: one counted call, card vs CPU (R and t
        within 2e-5), CUDA-event time; 2 whole-cloud warp k-NN and no EGCL
        kernel a call (the plain EGNN)."""
        reset()
        R, t, info = reg.register(*args)
        got = counts()
        check(got == ({"warp": 2, "thread": 0}, only("simt", 0), only("simt", 0)),
              f"variants {name}: launches knn/egcl/egcl_backward {got}, want 2 warp k-NN, "
              f"no EGCL")
        record(name, got)
        ms = event_ms(torch, lambda: reg.register(*args), 5)
        profile_call(torch, lambda: reg.register(*args), f"variants {name} register() B={b}")
        t1 = time.perf_counter()
        Rc, tc, ic = cpu_reg.register(*args)
        cpu_s = time.perf_counter() - t1
        dR, dt = float(np.abs(R - Rc).max()), float(np.abs(t - tc).max())
        check(np.all(np.isfinite(R)) and np.all(np.isfinite(t))
              and np.abs(np.linalg.det(R) - 1).max() < 1e-3, f"variants {name}: bad pose")
        check(dR <= 2e-5 and dt <= 2e-5, f"variants {name}: card vs CPU max|ΔR| {dR} max|Δt| {dt}")
        results[name] = ms
        log(f"variants {name} register() B={b}: {ms:.2f} ms a call (CUDA events, 5 calls "
            f"after a warm-up); card vs CPU max|ΔR| {dR:.3g}, max|Δt| {dt:.3g} m; launches "
            f"k-NN {got[0]}, EGCL none; CPU run {cpu_s:.1f} s")
        return R, t

    # (a) 'cluster' from a .pth: the reference checkpoints' own semantics
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "variants_smoke.pth")
    checkpoints.export_reference_checkpoint(sd, path, n_layers=cfg.n_layers,
                                            num_heads=cfg.num_heads, hidden=cfg.hidden_nf)
    kw = dict(width, fast=False, direction="cluster")
    reg = serving.Registrar.from_checkpoint(path, device=dev, **kw)
    cpu_reg = serving.Registrar.from_checkpoint(path, device="cpu", **kw)
    check(reg.cfg == engine.EngineConfig(**width, direction="cluster") and reg._kp is None,
          f"variants: from_checkpoint built {reg.cfg}")
    serve("(a) cluster .pth", reg, cpu_reg)

    # (b) 'invariant': the served call, then the EGNN's equivariance on the card
    icfg = engine.EngineConfig(**width, so3_mode="invariant")
    reg = serving.Registrar(sd, icfg, device=dev)
    R, t = serve("(b) invariant", reg, serving.Registrar(sd, icfg, device="cpu"))
    Q = torch.from_numpy(np.asarray([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]],
                                    np.float32)).to(dev)
    Rq, tq, _ = reg.register(pb.src_pts, pb.src_feat,
                             (torch.from_numpy(pb.tgt_pts).to(dev) @ Q.T).cpu().numpy(),
                             pb.tgt_feat)
    Qn = Q.cpu().numpy()
    eq_R = float(np.abs(Rq - Qn @ R).max())
    eq_t = float(np.abs(tq - t @ Qn.T).max())
    # the EGNN's property, in fp64 on the card (an fp64 copy of the weights):
    # the ratio feature √‖x_row × x_col‖² / ‖rel‖² of the invariant mode is
    # ill-conditioned in fp32 at N=2048 (close neighbours), so the fp32 gap
    # is printed beside the fp32-against-fp64 gap that bounds it
    x = torch.from_numpy(pb.src_pts).to(dev)
    h = torch.from_numpy(pb.src_feat).to(dev)
    nbr = knn.knn_window(x, cfg.k, tile=128, window=None)
    e64 = copy.deepcopy(reg.model.egnn).double()
    with torch.no_grad():
        H1, X1 = e64(h.double(), x.double(), nbr)
        H2, X2 = e64(h.double(), x.double() @ Q.double().T, nbr)
        h1, _ = reg.model.egnn(h, x, nbr)
        h2, _ = reg.model.egnn(h, x @ Q.T, nbr)
    scale = H1.abs().max()
    eq_h = float((H2 - H1).abs().max() / scale)
    U1, U2 = X1 - x.double(), X2 - x.double() @ Q.double().T
    eq_u = float((U2 - U1 @ Q.double().T).abs().max() / U1.abs().max())
    gap32 = float((h2 - h1).abs().max() / scale)
    floor32 = float(((h1 - H1).abs().max() + (h2 - H2).abs().max()) / scale)
    log(f"variants (b) invariant equivariance on the card, target rotated by Q: max|R' - QR| "
        f"{eq_R:.3g}, max|t' - Qt| {eq_t:.3g} m; the EGNN in fp64: h(Qx) vs h(x) {eq_h:.3g} "
        f"of the scale, update u(Qx) vs Q u(x) {eq_u:.3g} of the scale (update max "
        f"{float(U1.abs().max()):.3g}); in fp32: h(Qx) vs h(x) {gap32:.3g}, fp32 against fp64 "
        f"at x and Qx {floor32:.3g} of the scale")
    check(eq_R <= 1e-4 and eq_t <= 1e-4 and eq_h <= 1e-6 and eq_u <= 1e-6,
          f"variants (b) invariant: not equivariant on the card: R {eq_R} t {eq_t} h {eq_h} "
          f"u {eq_u}")

    def batches(n_pairs, seed, dv):
        rng = np.random.default_rng(seed)
        return [engine.batch_to_device(tuple(make_pair_batch(
            rng, batch=n_pairs, n=cfg.num_nodes, feat_dim=cfg.in_node_nf)), dv)
            for _ in range(2)]

    def first_step(bcfg, bt, seed):
        """One bf16 train step from the same seeded init on the card and on
        the CPU: (loss card, loss CPU, [master gradients], [masters after],
        for each side), the gradients as Adam sees them (a pre-step hook)."""
        out = []
        for dv in (dev, "cpu"):
            st = engine.init_state(bcfg, torch.Generator().manual_seed(seed), device=dv)
            g = []
            st.optimizer.adam.register_step_pre_hook(lambda *_, g=g, st=st: g.extend(
                t_.grad.detach().cpu().clone() for t_ in st.optimizer.sr.master))
            st, m_ = engine.make_train_step(st.model, st.optimizer, bcfg)(
                st, {k: v.to(dv) for k, v in bt.items()})
            out.append((float(m_["total"]), g,
                        [t_.detach().cpu().clone() for t_ in st.optimizer.sr.master]))
        return out

    def master_gaps(card, cpu_, floor):
        """(max|Δ| of the masters where the CPU's first gradient exceeds
        `floor` of its tensor's max, max|Δ| everywhere, the worst gradient
        cosine)."""
        worst, worst_big, cos = 0.0, 0.0, 1.0
        for a, r, ga, g in zip(card[2], cpu_[2], card[1], cpu_[1]):
            d = (a - r).abs()
            big = g.abs() > floor * g.abs().max()
            worst = max(worst, float(d.max()))
            worst_big = max(worst_big, float(d[big].max()) if bool(big.any()) else 0.0)
            x, y = ga.double().flatten(), g.double().flatten()
            cos = min(cos, float(x @ y / (x.norm() * y.norm()).clamp_min(1e-300)))
        return worst_big, worst, cos

    # (c) bf16 parameters, fast_tpu_config: 2 packed B1, 6 bf16-tile B2 and B3 a step
    bcfg = engine.fast_tpu_config(**width, bf16_params=True)
    state = engine.init_state(bcfg, torch.Generator().manual_seed(3), device=dev)
    check(all(p.dtype == torch.bfloat16 for p in state.model.parameters())
          and all(m.dtype == torch.float32 for m in state.optimizer.sr.master),
          "variants (c): live parameters not bf16 or masters not fp32")
    cards = batches(b, 43, dev)
    step = engine.make_train_step(state.model, state.optimizer, bcfg)
    reset()
    per_step, losses = [], []
    for i in range(5):
        before = (knn.knn_window.launches, egcl.egcl_layer.launches, eb.egcl_backward.launches)
        state, m = step(state, cards[i % 2])
        per_step.append([n - n0 for n, n0 in zip(
            (knn.knn_window.launches, egcl.egcl_layer.launches, eb.egcl_backward.launches),
            before)])
        losses.append(m["total"])
    got = counts()
    torch.cuda.synchronize()
    check(all(c == [2, 2 * L, 2 * L] for c in per_step)
          and got == ({"warp": 10, "thread": 0}, only("tile", 10 * L), only("tile", 10 * L)),
          f"variants (c) bf16: launches per step {per_step}, by kernel {got}")
    record("(c) bf16 train", got)
    ulps = max(float(((p.detach().float() - m_).abs() / torch.ldexp(
        torch.ones_like(m_), torch.frexp(m_).exponent - 8)).max())
        for p, m_ in zip(state.model.parameters(), state.optimizer.sr.master))
    losses = [float(v) for v in losses]
    check(all(p.dtype == torch.bfloat16 for p in state.model.parameters()) and ulps <= 1.0
          and all(np.isfinite(losses)),
          f"variants (c): live parameters not bf16, or {ulps} bf16 ulps from their masters, "
          f"or losses {losses}")
    ms = event_ms(torch, lambda: step(state, cards[0]), 3)
    profile_call(torch, lambda: step(state, cards[0]), f"variants (c) bf16 train step B={b}")
    results["(c) bf16 train"] = ms
    t1 = time.perf_counter()
    fast = first_step(bcfg, cards[0], 3)
    fb, fa, fcos = master_gaps(*fast, 1e-3)
    log(f"variants (c) bf16 train step B={b}: {ms:.2f} ms a step (CUDA events, 3 steps after "
        f"5); launches per step {per_step[0]} (knn {got[0]}, egcl {got[1]}, egcl_backward "
        f"{got[2]}); losses {[round(v, 4) for v in losses]}; live within {ulps:.3g} bf16 ulps "
        f"of the masters after 5 steps. Step 1 card vs CPU in fast mode (printed, not held: "
        f"bf16 operands summed in another order, at a saturated similarity softmax): loss "
        f"{fast[0][0]:.6f} vs {fast[1][0]:.6f}, worst gradient cosine {fcos:.6f}, masters "
        f"max|Δ| {fb:.3g} where |g| > 1e-3 of its max, {fa:.3g} everywhere (lr {bcfg.lr}); "
        f"CPU step {time.perf_counter() - t1:.1f} s")
    # the same bf16 step in accurate mode (fp32 tile B2 and B3), held at the train gate
    acfg = dataclasses.replace(bcfg, egnn_accurate=True)
    reset()
    acc = first_step(acfg, cards[0], 3)
    got = counts()
    check(got == ({"warp": 2, "thread": 0}, only("tile_f32", 2 * L), only("tile_f32", 2 * L)),
          f"variants (c) bf16 accurate: launches {got}")
    record("(c) bf16 accurate step", got)
    ab, aa, acos = master_gaps(*acc, 1e-3)
    dl = abs(acc[0][0] - acc[1][0]) / abs(acc[1][0])
    log(f"variants (c) bf16 accurate step 1, B={b}, card vs CPU: loss {acc[0][0]:.6f} vs "
        f"{acc[1][0]:.6f} (rel {dl:.2g}), worst gradient cosine {acos:.8f}, masters max|Δ| "
        f"{ab:.3g} where |g| > 1e-3 of its max, {aa:.3g} everywhere; launches knn {got[0]}, "
        f"egcl {got[1]}, egcl_backward {got[2]}")
    # 2 lr, and the fp32 rounding of the two updates of an element
    check(dl <= 1e-4 and acos >= 0.9999 and ab <= 1e-6 and aa <= 2.001 * acfg.lr,
          f"variants (c) bf16 accurate: card vs CPU loss {dl}, cosine {acos}, masters {ab}, {aa}")

    # (d) the PointNet encoder, EngineConfig: 2 exact B1, 6 fp32-tile B2 and B3 a step
    pcfg = engine.EngineConfig(**width, use_pointnet=True)
    state = engine.init_state(pcfg, torch.Generator().manual_seed(4), device="cpu")
    psd = state.model.state_dict()
    card_model = engine.build_model(pcfg, device=dev)
    card_model.load_state_dict(psd)
    card = engine.TrainState(card_model, engine.build_optimizer(card_model, pcfg))
    pbatch = batches(VARIANTS_POINTNET_PAIRS, 44, dev)[0]

    def grads(model, bt):
        model.zero_grad(set_to_none=True)
        lb = engine.train_loss(model, pcfg, bt)
        lb.total.backward()
        g = {n: q.grad.detach().float().cpu() for n, q in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return {k: float(v.detach()) for k, v in lb._asdict().items()}, g

    reset()
    terms, gg = grads(card.model, pbatch)
    got = counts()
    torch.cuda.synchronize()
    check(got == ({"warp": 2, "thread": 0}, only("tile_f32", 2 * L), only("tile_f32", 2 * L)),
          f"variants (d) pointnet: launches {got}")
    record("(d) pointnet train", got)
    pstep = engine.make_train_step(card.model, card.optimizer, pcfg)
    ms = event_ms(torch, lambda: pstep(card, pbatch), 3)
    profile_call(torch, lambda: pstep(card, pbatch),
                 f"variants (d) pointnet train step B={VARIANTS_POINTNET_PAIRS}")
    t1 = time.perf_counter()
    cpu_terms, gc = grads(state.model, {k: v.cpu() for k, v in pbatch.items()})
    cpu_s = time.perf_counter() - t1
    cos = grad_cosines(torch, gg, gc)
    worst, worst_l2 = min(cos, key=lambda k: cos[k][0]), max(cos, key=lambda k: cos[k][1])
    dl = {k: abs(terms[k] - cpu_terms[k]) / abs(cpu_terms[k]) for k in terms}
    # the train head's softmax over similarities in the thousands is one-hot
    # at seeded weights: an fp32 spacing of the largest similarity moves the
    # runner-up's weight, and with it every Kabsch-path gradient, by that
    # much relative (a scale: the cosine stays at 1); the relative L2 gate is
    # the cli phase's 1e-4 or two such spacings, whichever is larger
    with torch.no_grad():
        sim = float(engine._apply_with_graphs(card.model, pcfg, pbatch).similarity.abs().max())
    l2_tol = max(1e-4, 2 * float(np.finfo(np.float32).eps) * sim)
    check(all(v <= 1e-4 for v in dl.values()), f"variants (d) pointnet: loss terms {dl}")
    check(cos[worst][0] >= 0.9999 and cos[worst_l2][1] <= l2_tol,
          f"variants (d) pointnet: gradients {worst} {cos[worst]}, {worst_l2} {cos[worst_l2]} "
          f"(relative L2 gate {l2_tol:.3g})")
    check(any(n.startswith("pointnet.") and float(g.abs().max()) > 0 for n, g in gg.items()),
          "variants (d) pointnet: the encoder got no gradient")
    results["(d) pointnet train"] = ms
    log(f"variants (d) pointnet train step B={VARIANTS_POINTNET_PAIRS}: {ms:.2f} ms a step "
        f"(CUDA events, 3 steps after a warm-up); launches knn {got[0]}, egcl {got[1]}, "
        f"egcl_backward {got[2]}; card vs CPU: loss terms relative |Δ| max "
        f"{max(dl.values()):.2g}, worst gradient cosine {worst} {cos[worst][0]:.12f}, worst "
        f"relative L2 {worst_l2} {cos[worst_l2][1]:.3g} (gate {l2_tol:.3g}: max|similarity| "
        f"{sim:.1f}); CPU side {cpu_s:.1f} s")
    log(f"variants: {json.dumps({k: round(v, 3) for k, v in results.items()})} ms; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card_line()}")

# the multiway phase: examples/multiway_registration.py's scenario and knobs
MULTIWAY_V, MULTIWAY_N = 6, 1024      # fragments, points a fragment
MULTIWAY_ITERS = 30                   # the robust graph's Gauss-Newton steps
MULTIWAY_KNOBS = dict(n_points=MULTIWAY_N, top_m=256, icp_trim="auto", icp_iters=15)
MULTIWAY_GATE = (0.5, 1.0)            # (a)'s graph against the truth: deg, cm
# graphs card vs CPU, ‖ΔR‖_F/√2 and max|Δt| (m): the same Gauss-Newton steps in
# fp32, measured ≤ 4.8e-7 on an H100 80GB HBM3 at 700 W
MULTIWAY_CPU_TOL = 1e-5
GRAPH_V, GRAPH_ITERS = 60, 15         # a 3DMatch scene's fragments; its graph's steps


def multiway_scene(torch, n, V=MULTIWAY_V, seed=0):
    """examples/multiway_registration.py's scenario, its draws in its order:
    one bumpy terrain, V fragment poses in gentle motion (windows overlap
    ~70%), fragment i's n points in its own frame. Returns (fragments,
    ground-truth poses [V, 4, 4])."""
    from se3_equi_graph_registration_tpu_torch.core.se3 import matrix_exp_so3

    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0 + 0.5 * V, (12 * V, 2))
    amps = rng.uniform(-0.35, 0.35, 12 * V)
    widths = rng.uniform(0.08, 0.3, 12 * V)

    def sample_window(x0):
        xy = np.stack([rng.uniform(x0, x0 + 2.0, n), rng.uniform(-1, 1, n)], -1)
        z = np.zeros(n)
        for (cx, cy), a, w in zip(centers, amps, widths):
            z += a * np.exp(-((xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2) / w)
        pts = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
        return pts + rng.standard_normal(pts.shape).astype(np.float32) * 0.002

    gt = [np.eye(4, dtype=np.float32)]
    for _ in range(1, V):
        w = rng.standard_normal(3).astype(np.float32) * 0.05
        d = np.eye(4, dtype=np.float32)
        d[:3, :3] = matrix_exp_so3(torch.from_numpy(w)).numpy()
        d[:3, 3] = [0.4, 0, 0] + rng.standard_normal(3) * 0.02
        gt.append(gt[-1] @ d)
    gt = np.stack(gt)
    frags = [(sample_window(0.4 * i - 1.0) - gt[i, :3, 3]) @ gt[i, :3, :3] for i in range(V)]
    return frags, gt


def multiway_edges(V=MULTIWAY_V):
    """The example's edges: the odometry chain, skip-2 and skip-3 closures."""
    return ([(i, i + 1) for i in range(V - 1)] + [(i, i + 2) for i in range(V - 2)]
            + [(i, i + 3) for i in range(V - 3)])


def traj_err(traj, gt):
    """Per-pose (rotation in degrees, translation in cm) of [V, 4, 4] poses
    against the truth, as the example measures them: the angle from
    ‖ΔR‖_F/√2, since arccos misreads near zero angle."""
    d = np.linalg.norm(traj[:, :3, :3] - gt[:, :3, :3], axis=(1, 2)) / np.sqrt(2)
    return (np.degrees(2 * np.arcsin(np.clip(d / 2, 0, 1))),
            np.linalg.norm(traj[:, :3, 3] - gt[:, :3, 3], axis=1) * 100)


def edge_truth(gt, edges):
    """inv(T_i) @ T_j [E, 4, 4] in float64: the pose of fragment j in i's frame."""
    g = gt.astype(np.float64)
    return np.stack([np.linalg.inv(g[i]) @ g[j] for i, j in edges])


def corrupt_chain_link(torch, rels):
    """The example's simulated failure: the middle chain link off by 5 deg
    about x and 30 cm along x."""
    from se3_equi_graph_registration_tpu_torch.core.se3 import matrix_exp_so3

    rels = rels.copy()
    bad = (MULTIWAY_V - 1) // 2
    rels[bad, :3, :3] = matrix_exp_so3(torch.from_numpy(np.float32([0.087, 0, 0]))).numpy() \
        @ rels[bad, :3, :3]
    rels[bad, :3, 3] += np.float32([0.3, 0, 0])
    return rels


def chain_init(rels, V=MULTIWAY_V):
    """Absolute poses integrated along the odometry chain (the first V - 1 edges)."""
    init = [np.eye(4, dtype=np.float32)]
    for i in range(V - 1):
        init.append(init[-1] @ rels[i])
    return np.stack(init)


def best_event_ms(torch, fn, reps=3):
    """The least device-clock ms of `reps` calls, one call between two CUDA
    events each, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def best_host_ms(fn, reps=3):
    """The least host-clock ms of `reps` calls after a warm-up call (CPU runs)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def scene_graph(seed=0, V=GRAPH_V):
    """A pose graph of a 3DMatch scene's size: V fragments on a rising
    circle of 2 m radius, the chain, skip-2 and skip-3 edges and 6 closures
    across the circle (E = 3V), each measured with 0.01 rad / 1 cm noise;
    6 skip closures grossly wrong (0.3 rad, 50 cm); the init integrated
    along the noisy chain. Returns (gt R, gt t, (R0, t0, edges, R_rel, t_rel))."""
    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(V) / V
    c, s_, o, z = np.cos(a), np.sin(a), np.ones(V), np.zeros(V)
    Rg = np.stack([np.stack([c, -s_, z], -1), np.stack([s_, c, z], -1),
                   np.stack([z, z, o], -1)], -2).astype(np.float32)
    tg = np.stack([2 * (c - 1), 2 * s_, 0.02 * np.arange(V)], -1).astype(np.float32)
    edges = multiway_edges(V) + [(i, i + V // 2) for i in range(6)]

    def expm(w):
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    R_rel, t_rel = [], []
    for i, j in edges:
        R_rel.append(expm(rng.standard_normal(3) * 0.01) @ Rg[i].T @ Rg[j])
        t_rel.append(Rg[i].T @ (tg[j] - tg[i]) + rng.standard_normal(3) * 0.01)
    R_rel, t_rel = np.stack(R_rel).astype(np.float32), np.stack(t_rel).astype(np.float32)
    for e in rng.choice(np.arange(V - 1, 3 * V - 6), 6, replace=False):
        R_rel[e] = expm(np.float64([0.3, 0.0, 0.0])) @ R_rel[e]
        t_rel[e] += np.float32([0.5, 0.0, 0.0])
    R0, t0 = [Rg[0]], [tg[0]]
    for k in range(V - 1):
        t0.append(t0[-1] + R0[-1] @ t_rel[k])
        R0.append(R0[-1] @ R_rel[k])
    return Rg, tg, (np.stack(R0).astype(np.float32), np.stack(t0).astype(np.float32),
                    np.asarray(edges, np.int32), R_rel, t_rel)


def multiway_phase(torch, dev, rows):
    """Multiway registration (module docstring, `multiway`): (a) the
    example's scenario on the card with the truth gate; (b) at N=2048
    through the fused path; (c) the pose graph card against CPU through
    `.log` files, and at V=60; (d) file evaluation of (b)'s poses; (e)
    times and the launches of a pose-graph call."""
    import os
    import tempfile

    from se3_equi_graph_registration_tpu_torch import registration
    from se3_equi_graph_registration_tpu_torch.core import se3_np
    from se3_equi_graph_registration_tpu_torch.core.quaternions import (
        rotation_matrix_to_quaternion)
    from se3_equi_graph_registration_tpu_torch.data.preprocess import pairs
    from se3_equi_graph_registration_tpu_torch.ops import pose_graph
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.tools import eval_files, multiway
    from se3_equi_graph_registration_tpu_torch.utils.trajectory import (
        read_trajectory_log, write_trajectory_log)

    t_phase = time.perf_counter()
    edges = multiway_edges()
    E, V = len(edges), MULTIWAY_V
    kind = {1: "chain", 2: "skip-2", 3: "skip-3"}
    counters = dict(knn_window=knn.knn_window, knn_chunked=knn.knn_chunked, spfh=spfh.spfh,
                    egcl_layer=egcl.egcl_layer)
    knobs_b = dict(MULTIWAY_KNOBS, n_points=FPFH_N, knn_method="fused", knn_packed="chunked",
                   window=FPFH_WINDOW)
    times = {}

    def register_edges(frags, knobs, want, tag):
        """register_fpfh of fragment j onto fragment i for every edge (i, j),
        each with its launches held to `want`: T_ij [E, 4, 4], j's frame to i's."""
        rels = []
        for i, j in edges:
            before = {k: fn.launches for k, fn in counters.items()}
            R, t, info = registration.register_fpfh(frags[j], frags[i], seed=i * 100 + j,
                                                    device=dev, **knobs)
            d = {k: fn.launches - before[k] for k, fn in counters.items()}
            check(d == want, f"multiway {tag} edge {i}->{j}: launches {d}, want {want}")
            check(all(np.isfinite(a).all() for a in (R, t, info["pose_covariance"])),
                  f"multiway {tag} edge {i}->{j}: non-finite output")
            T = np.eye(4, dtype=np.float32)
            T[:3, :3], T[:3, 3] = R, t
            rels.append(T)
        return np.stack(rels)

    def report_edges(rels, gt, tag):
        rot, cm = traj_err(rels.astype(np.float64), edge_truth(gt, edges))
        log(f"multiway {tag}, each edge against the truth: " + "; ".join(
            f"{i}->{j} ({kind[j - i]}) {r:.3f} deg {c:.3f} cm"
            for (i, j), r, c in zip(edges, rot, cm)))
        return rot, cm

    def robust_graph(rels, dv):
        bad = corrupt_chain_link(torch, rels)
        init = chain_init(bad)
        opt = pose_graph.optimize_trajectory(init, np.asarray(edges, np.int32), bad,
                                             weights=np.ones(E, np.float32), robust="geman",
                                             iters=MULTIWAY_ITERS, device=dv)
        return init, bad, opt.cpu().numpy()

    # (a) the example's scenario at its own knobs: 2 exact warp B1 an edge
    frags_a, gt_a = multiway_scene(torch, MULTIWAY_N)
    reset_all_counters(knn, egcl, spfh)
    t0 = time.perf_counter()
    rels_a = register_edges(frags_a, MULTIWAY_KNOBS,
                            dict(knn_window=2, knn_chunked=0, spfh=0, egcl_layer=0), "(a)")
    reg_s = time.perf_counter() - t0
    got = counted_launches(knn, egcl, spfh)
    check(got["knn_window"] == {"warp": 2 * E, "thread": 0},
          f"multiway (a): k-NN launches by kernel {got['knn_window']}, want all {2 * E} 'warp'")
    record_launches(rows, "multiway (a)", dict(knn_window=2 * E),
                    dict(knn_window=got["knn_window"]))
    rot_a, cm_a = report_edges(rels_a, gt_a, f"(a) N={MULTIWAY_N} approx")
    init, bad_a, opt = robust_graph(rels_a, dev)
    (r0, c0), (r1, c1) = traj_err(init, gt_a), traj_err(opt, gt_a)
    log(f"multiway (a) N={MULTIWAY_N}, {E} edges ({reg_s:.1f} s of register_fpfh on the card, "
        f"launches {got['knn_window']}): odometry chain max {r0.max():.3f} deg / "
        f"{c0.max():.3f} cm; optimized graph (geman, {MULTIWAY_ITERS} steps) max "
        f"{r1.max():.3f} deg / {c1.max():.3f} cm (gate {MULTIWAY_GATE[0]} deg / "
        f"{MULTIWAY_GATE[1]} cm)")
    off = [f"{i}->{j}" for (i, j), r, c in zip(edges, rot_a, cm_a) if r > 2 or c > 5]
    check(r1.max() <= MULTIWAY_GATE[0] and c1.max() <= MULTIWAY_GATE[1],
          f"multiway (a): the graph is {r1.max()} deg / {c1.max()} cm from the truth; "
          f"edges off by more than 2 deg or 5 cm: {off}")

    # (b) full width through the fused path: 2 warp B4 and 2 'redux' B5 an edge
    frags_b, gt_b = multiway_scene(torch, FPFH_N)
    reset_all_counters(knn, egcl, spfh)
    t0 = time.perf_counter()
    rels_b = register_edges(frags_b, knobs_b,
                            dict(knn_window=0, knn_chunked=2, spfh=2, egcl_layer=0), "(b)")
    reg_s = time.perf_counter() - t0
    got = counted_launches(knn, egcl, spfh)
    check(got["knn_chunked"] == {"warp": 2 * E, "thread": 0}
          and got["spfh"] == {**dict.fromkeys(spfh.VARIANTS, 0), "redux": 2 * E},
          f"multiway (b): launches by kernel {got}")
    record_launches(rows, "multiway (b)", dict(knn_chunked=2 * E, spfh=2 * E),
                    dict(knn_chunked=got["knn_chunked"], spfh=got["spfh"]))
    rot_b, cm_b = report_edges(rels_b, gt_b, f"(b) N={FPFH_N} fused")
    init, bad_b, opt = robust_graph(rels_b, dev)
    (r0, c0), (r1, c1) = traj_err(init, gt_b), traj_err(opt, gt_b)
    log(f"multiway (b) N={FPFH_N} fused/chunked W={FPFH_WINDOW}, {E} edges ({reg_s:.1f} s, "
        f"launches knn_chunked {got['knn_chunked']}, spfh {got['spfh']}): odometry chain max "
        f"{r0.max():.3f} deg / {c0.max():.3f} cm; optimized graph max {r1.max():.3f} deg / "
        f"{c1.max():.3f} cm (not held: closures can fail at this N)")

    def rot_gap(a, b):
        return float((np.linalg.norm(a[..., :3, :3] - b[..., :3, :3], axis=(-2, -1))
                      / np.sqrt(2)).max())

    with tempfile.TemporaryDirectory() as tmp:
        # (c) tools/multiway over .log files: main on the card, then with --device cpu
        for tag, bad, gt in (("(a)", bad_a, gt_a), ("(b)", bad_b, gt_b)):
            logs = []
            for name, keep in (("odometry", lambda i, j: j == i + 1),
                               ("closures", lambda i, j: j != i + 1)):
                path = os.path.join(tmp, f"{name}{tag}.log")
                write_trajectory_log(path, {f"{i}_{j}": bad[e] for e, (i, j) in enumerate(edges)
                                            if keep(i, j)})
                logs += ["--log", path]
            outs = {}
            for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
                out = os.path.join(tmp, f"optimized{tag}-{side}.log")
                multiway.main(logs + ["--out", out, "--iters", str(MULTIWAY_ITERS)] + extra)
                back = read_trajectory_log(out)
                outs[side] = np.stack([back[f"0_{k}"] for k in range(V)])
            dR, dt = rot_gap(outs["card"], outs["cpu"]), float(
                np.abs(outs["card"][:, :3, 3] - outs["cpu"][:, :3, 3]).max())
            r1, c1 = traj_err(outs["card"], gt)
            log(f"multiway (c) {tag} tools/multiway over .log files: card vs CPU ‖ΔR‖/√2 "
                f"{dR:.3g}, max|Δt| {dt:.3g} m (8 decimals in the file); the card's log "
                f"against the truth max {r1.max():.3f} deg / {c1.max():.3f} cm")
            check(dR <= MULTIWAY_CPU_TOL and dt <= MULTIWAY_CPU_TOL,
                  f"multiway (c) {tag}: card vs CPU dR {dR} dt {dt}")
            if tag == "(a)":
                check(r1.max() <= MULTIWAY_GATE[0] and c1.max() <= MULTIWAY_GATE[1],
                      f"multiway (c) (a): the card's log is {r1.max()} deg / {c1.max()} cm off")

        # (c) a 3DMatch scene's size, least squares and geman, card vs CPU
        Rg, tg, graph = scene_graph()
        for robust in (None, "geman"):
            Rc, tc = pose_graph.optimize_pose_graph(*graph, iters=GRAPH_ITERS, robust=robust,
                                                    device=dev)
            Rp, tp = pose_graph.optimize_pose_graph(*graph, iters=GRAPH_ITERS, robust=robust,
                                                    device="cpu")
            Rc, tc, Rp, tp = Rc.cpu().numpy(), tc.cpu().numpy(), Rp.numpy(), tp.numpy()
            dR, dt = rot_gap(Rc, Rp), float(np.abs(tc - tp).max())
            e0 = np.abs(graph[1] - tg).max() * 100
            rd = np.degrees(2 * np.arcsin(np.clip(
                np.linalg.norm(Rc - Rg, axis=(1, 2)) / np.sqrt(2) / 2, 0, 1))).max()
            check(np.isfinite(Rc).all() and np.isfinite(tc).all() and dR <= MULTIWAY_CPU_TOL
                  and dt <= MULTIWAY_CPU_TOL,
                  f"multiway (c) V={GRAPH_V} robust={robust}: card vs CPU dR {dR} dt {dt}")
            log(f"multiway (c) optimize_pose_graph V={GRAPH_V} E={len(graph[2])} "
                f"robust={robust} ({GRAPH_ITERS} steps; 6 closures grossly wrong): card vs CPU "
                f"‖ΔR‖/√2 {dR:.3g}, max|Δt| {dt:.3g} m; against the truth max {rd:.3f} deg / "
                f"{np.abs(tc - tg).max() * 100:.3f} cm (init {e0:.3f} cm)")

        # (d) (b)'s card poses as quaternion lines against build_pair truth files
        gt_dir, pred_dir = os.path.join(tmp, "gt"), os.path.join(tmp, "pred")
        os.makedirs(pred_dir)
        truth = edge_truth(gt_b, edges)
        feats = {j: pairs.extract_fpfh(frags_b[j], voxel_size=0.03, backend="native",
                                       device=dev) for j in sorted({j for _, j in edges})}
        names, inliers = [], []
        for e, (i, j) in enumerate(edges):
            pts, f = feats[j]
            f = pairs.normalize_descriptors(f)
            pair = pairs.build_pair(pts, se3_np.transform(pts, truth[e]), f, f, truth[e], 0.10,
                                    file_0=f"fragment_{j}", file_1=f"fragment_{i}")
            inliers.append(float(pair["labels"].mean()))
            pairs.save_pair(os.path.join(gt_dir, f"{i}_{j}.pkl"), pair)
            q = rotation_matrix_to_quaternion(torch.from_numpy(rels_b[e, :3, :3])).numpy()
            with open(os.path.join(pred_dir, f"{i}_{j}.txt"), "w") as fh:
                fh.write(" ".join(repr(float(v)) for v in
                                  np.concatenate([q[1:], q[:1], rels_b[e, :3, 3]])) + "\n")
            names.append(f"{i}_{j}")
        summary = eval_files.evaluate_pairwise_frames(
            [n + ".pkl" for n in names], [n + ".txt" for n in names], gt_dir, pred_dir, tmp)
        with open(os.path.join(tmp, "evaluation_results.txt")) as fh:
            report = fh.read().strip().replace("\n", "; ")
        d_cm = abs(summary["avg_translation_error_cm"] - float(np.mean(cm_b)))
        d_deg = abs(summary["avg_rotation_error_deg"] - float(np.mean(rot_b)))
        log(f"multiway (d) tools/eval_files over (b)'s {E} card poses and build_pair truth "
            f"files (native FPFH on the card at 0.03 m, {min(len(p) for p, _ in feats.values())}"
            f"-{max(len(p) for p, _ in feats.values())} points, labels {min(inliers):.3f}-"
            f"{max(inliers):.3f} inliers): {report}; against (b)'s own errors: translation "
            f"|Δ| {d_cm:.3g} cm, rotation |Δ| {d_deg:.3g} deg (arccos near zero angle)")
        check(all(np.isfinite(v) for v in summary.values()) and d_cm <= 1e-3 and d_deg <= 0.1
              and 0.0 <= summary["avg_registration_recall"] <= 1.0,
              f"multiway (d): report {summary}, against (b) {d_cm} cm {d_deg} deg")

    # (e) times: CUDA events on the card, best of 3 after a warm-up; host clock on the CPU
    times["register_fpfh (a) N=1024 approx"] = best_event_ms(
        torch, lambda: registration.register_fpfh(frags_a[1], frags_a[0], seed=1, device=dev,
                                                  **MULTIWAY_KNOBS))
    times["register_fpfh (b) N=2048 fused"] = best_event_ms(
        torch, lambda: registration.register_fpfh(frags_b[1], frags_b[0], seed=1, device=dev,
                                                  **knobs_b))
    small = (chain_init(bad_a), np.asarray(edges, np.int32), bad_a)
    kw6 = dict(weights=np.ones(E, np.float32), robust="geman", iters=MULTIWAY_ITERS)
    kw60 = dict(robust="geman", iters=GRAPH_ITERS)
    calls = {f"pose graph V={V} E={E} geman {MULTIWAY_ITERS} steps":
             lambda dv: pose_graph.optimize_trajectory(*small, device=dv, **kw6),
             f"pose graph V={GRAPH_V} E={len(graph[2])} geman {GRAPH_ITERS} steps":
             lambda dv: pose_graph.optimize_pose_graph(*graph, device=dv, **kw60)}
    for name, call in calls.items():
        times[name + ", card"] = best_event_ms(torch, lambda: call(dev))
        times[name + ", CPU (host clock)"] = best_host_ms(lambda: call("cpu"))
        profile_call(torch, lambda: (call(dev), torch.cuda.synchronize()),
                     f"multiway (e) {name}, one call")
    log("multiway (e) ms: " + json.dumps({k: round(v, 3) for k, v in times.items()}))
    log(f"multiway: phase {time.perf_counter() - t_phase:.1f} s; {card_line()}")


# --- tools: the Queue C verdicts on the card (module docstring, `tools`) ---
TOOLS_TRAIN_B, TOOLS_TRAIN_STEPS, TOOLS_PROBE_EVERY = 16, 300, 50
TOOLS_NEFF = 8.0              # the softmax is live once 1/Σŵ² reaches this
TOOLS_TABLE_B, TOOLS_TABLE_SEED = 8, 13
TOOLS_SEEDS = 20
# BASELINE.md:240-244, the reference on the TPU: ransac, 4 branches, N=1024,
# 20 seeds; rows 60%, 40% + icp_trim=0.35, 40% + icp_trim='auto'
TOOLS_REF_COUNTS = {"approx": (20, 16, 15), "fused W=768": (16, 16, 14)}
TOOLS_REF_WORST_COS, TOOLS_REF_MEDIAN_REL = 0.786, 0.029    # BASELINE.md:523-531
TOOLS_CLAMP = 1e-6            # losses._safe_arccos: 1 − cos below it has no gradient


def kernel_counters():
    """The five kernel wrappers by row-family name."""
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    return dict(knn_window=knn.knn_window, knn_chunked=knn.knn_chunked,
                egcl_layer=egcl.egcl_layer, egcl_backward=eb.egcl_backward, spfh=spfh.spfh)


def zero_counters():
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl, knn, spfh
    from se3_equi_graph_registration_tpu_torch.ops.kernels import egcl_backward as eb

    reset_all_counters(knn, egcl, spfh)
    reset_backward_counters(eb)


def launches_since_zero():
    """{wrapper: {variant: launches}} of every wrapper that launched since
    `zero_counters`, variants with no launch left out."""
    return {name: {v: n for v, n in fn.launches_by_variant.items() if n}
            for name, fn in kernel_counters().items() if fn.launches}


def counted(rows, path, call, want):
    """Run `call` with the counters at 0 and hold its launches to `want`
    ({wrapper: {variant: n}}); record them in the kernel rows."""
    import torch

    zero_counters()
    out = call()
    torch.cuda.synchronize()
    got = launches_since_zero()
    check(got == want, f"{path}: launches {got}, want {want}")
    egcl_v = lambda w: {v: got.get(w, {}).get(v, 0) for v in ("tile", "tile_f32", "simt")}
    record_launches(rows, path, dict(knn_window=sum(got.get("knn_window", {}).values()),
                                     knn_chunked=sum(got.get("knn_chunked", {}).values()),
                                     spfh=sum(got.get("spfh", {}).values()),
                                     **by_row("egcl_layer", egcl_v("egcl_layer")),
                                     **by_row("egcl_backward", egcl_v("egcl_backward"))),
                    {w: got[w] for w in ("knn_window", "knn_chunked", "spfh") if w in got})
    return out


def effective_count(torch, model, cfg, batch):
    """The batch mean of 1/Σŵ² over the train head's Kabsch softmax weights:
    1 when the softmax is one-hot, the labelled count when uniform."""
    from se3_equi_graph_registration_tpu_torch.train import engine

    w = engine._apply_with_graphs(model, cfg, batch).weights.double()
    return float((1.0 / (w * w).sum(-1)).mean())


def tools_conditioned():
    """The train loss's terms whose gradient is well conditioned: corr, sim
    and equi. The pose terms take the arccos of cosines within ~1e-6 of 1
    once the pose is good, and `_safe_arccos` clamps at 1 − 1e-6: an fp32
    rounding moves a pair across the clamp and switches its gradient."""
    from se3_equi_graph_registration_tpu_torch.train import losses

    return losses.LossWeights(corr=1.0, sim=1.0, rot=0.0, trans=0.0, equi=1.0)


def tools_phase(torch, dev, cfg, sd, rows):
    """The tools that settle ROADMAP Queue C on the card: (a) fast-mode
    gradients on trained weights (Queue C item 3); (b) the scenario table's
    60% and 40% rows at 20 seeds, 'approx' and fused W=768 (item 4); (c) the
    ICP Registrar's covariance card vs CPU beside the CPU's own 1-ulp
    sensitivity (item 1)."""
    t_phase = time.perf_counter()
    tools_gradients(torch, dev, cfg, rows)
    tools_scenarios(torch, dev, rows)
    tools_icp_covariance(torch, dev, cfg, sd, rows)
    log(f"tools: phase {time.perf_counter() - t_phase:.1f} s; {card_line()}")


def arccos_margins(torch, params, cfg, batch):
    """Per pair, 1 − cos of the rotation angle and of the translation
    direction angle that `train/losses.pose_loss` takes the arccos of
    (float64; its `_safe_arccos` clamps at 1 − 1e-6, where the gradient
    is 0)."""
    from se3_equi_graph_registration_tpu_torch.core.se3 import decompose_trans
    from se3_equi_graph_registration_tpu_torch.train import engine

    model = engine.build_model(cfg, device=batch["src_pts"].device)
    model.load_state_dict(params)
    out = engine._apply_with_graphs(model, cfg, batch)
    gR, gt = decompose_trans(batch["gt_pose"])
    rot = ((out.R.mT @ gR).diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    trans = (out.t * gt).sum(-1) / torch.clamp(out.t.norm(dim=-1) * gt.norm(dim=-1), min=1e-8)
    return (1.0 - rot.double().cpu().numpy()), (1.0 - trans.double().cpu().numpy())


def tools_gradients(torch, dev, cfg, rows):
    """(a) Train the port's model at `cfg` (B=16, seeded init and pairs)
    with the reference's 'dot' head and with the 'cosine' head, printing
    the head's effective correspondence count every TOOLS_PROBE_EVERY steps;
    then on each trained model at N=2048, B=8 the fast-against-accurate
    gradient table of `tools/grad_budget` over the train loss (packed keys,
    and exact keys on the fast side: --same-graph) and over its
    well-conditioned terms (corr + sim + equi). Gate: the accurate side on
    the card against the accurate side on the CPU, same weights and batch,
    over the well-conditioned terms, every tensor at cosine >= 0.9999. The
    full loss card vs CPU is printed beside the pairs whose pose-loss arccos
    argument lies on the two sides of its clamp on the two devices."""
    import dataclasses

    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.tools import grad_budget
    from se3_equi_graph_registration_tpu_torch.train import engine

    n, c, L = cfg.num_nodes, cfg.in_node_nf, cfg.n_layers
    rng = np.random.default_rng(11)
    pool = [engine.batch_to_device(tuple(make_pair_batch(rng, batch=TOOLS_TRAIN_B, n=n,
                                                         feat_dim=c)), dev) for _ in range(8)]
    table_batch = engine.batch_to_device(tuple(make_pair_batch(
        np.random.default_rng(TOOLS_TABLE_SEED), batch=TOOLS_TABLE_B, n=n, feat_dim=c)), dev)
    table_cpu = {key: v.cpu() for key, v in table_batch.items()}
    conditioned = lambda q: dataclasses.replace(q, loss_weights=tools_conditioned())
    fwd = lambda var: {"knn_window": {"warp": 2}, "egcl_layer": {var: 2 * L}}
    fwd_bwd = lambda var: dict(fwd(var), egcl_backward={var: 2 * L})
    verdicts = {}
    for head in ("dot", "cosine"):
        tcfg = dataclasses.replace(cfg, weight_mode=head)
        state = engine.init_state(tcfg, torch.Generator().manual_seed(0), device=dev)
        step = engine.make_train_step(state.model, state.optimizer, tcfg)
        probes = [(0, effective_count(torch, state.model, tcfg, pool[0]))]

        def train():
            nonlocal state
            for i in range(1, TOOLS_TRAIN_STEPS + 1):
                state, m = step(state, pool[i % len(pool)])
                if i % TOOLS_PROBE_EVERY == 0:
                    probes.append((i, effective_count(torch, state.model, tcfg, pool[0])))
            return m

        t0 = time.perf_counter()
        forwards = TOOLS_TRAIN_STEPS + TOOLS_TRAIN_STEPS // TOOLS_PROBE_EVERY
        m = counted(rows, f"tools (a) train '{head}'", train, {
            "knn_window": {"warp": 2 * forwards}, "egcl_layer": {"tile": 2 * L * forwards},
            "egcl_backward": {"tile": 2 * L * TOOLS_TRAIN_STEPS}})
        dt = time.perf_counter() - t0
        check(np.isfinite(float(m["total"])), f"tools (a) '{head}': non-finite loss")
        live = next((i for i, e in probes if e >= TOOLS_NEFF), None)
        log(f"tools (a) '{head}' head: {TOOLS_TRAIN_STEPS} fast steps at B={TOOLS_TRAIN_B} in "
            f"{dt:.1f} s ({1e3 * dt / TOOLS_TRAIN_STEPS:.2f} ms a step, host clock, probes "
            f"included), last loss {float(m['total']):.4f}; effective correspondences "
            f"1/Σŵ² by step: " + ", ".join(f"{i}: {e:.3f}" for i, e in probes)
            + (f"; >= {TOOLS_NEFF} from step {live}" if live is not None else
               f"; never >= {TOOLS_NEFF} (max {max(e for _, e in probes):.3f}): saturated"))

        params = {key: v.detach().clone() for key, v in state.model.state_dict().items()}
        acc_cfg = grad_budget.accurate_twin(tcfg)
        sides = {"packed keys": tcfg, "exact keys (--same-graph)":
                 dataclasses.replace(tcfg, knn_packed=False),
                 "corr + sim + equi, packed keys": conditioned(tcfg)}
        grads = {what: counted(rows, f"tools (a) '{head}' fast gradients, {what}",
                               lambda: grad_budget.gradients(params, q, table_batch),
                               fwd_bwd("tile")) for what, q in sides.items()}
        acc = {what: counted(rows, f"tools (a) '{head}' accurate gradients, {what}",
                             lambda: grad_budget.gradients(params, q, table_batch),
                             fwd_bwd("tile_f32"))
               for what, q in (("train loss", acc_cfg), ("corr + sim + equi",
                                                          conditioned(acc_cfg)))}
        t1 = time.perf_counter()
        acc_cpu = {what: grad_budget.gradients(params, q, table_cpu)
                   for what, q in (("train loss", acc_cfg),
                                   ("corr + sim + equi", conditioned(acc_cfg)))}
        fast_cpu = grad_budget.gradients(params, tcfg, table_cpu)
        margins = counted(rows, f"tools (a) '{head}' accurate forward",
                          lambda: arccos_margins(torch, params, acc_cfg, table_batch),
                          fwd("tile_f32"))
        margins_cpu = arccos_margins(torch, params, acc_cfg, table_cpu)
        gate = grad_budget.compare(acc["corr + sim + equi"], acc_cpu["corr + sim + equi"])
        full = grad_budget.compare(acc["train loss"], acc_cpu["train loss"])
        check(gate[0][1] >= 0.9999, f"tools (a) '{head}': accurate gradients of corr + sim + "
                                    f"equi card vs CPU, {gate[0][0]} cosine {gate[0][1]}")
        straddle = {name: int(np.sum((a > TOOLS_CLAMP) != (b > TOOLS_CLAMP)))
                    for name, a, b in zip(("rotation", "translation"), margins, margins_cpu)}
        log(f"tools (a) '{head}' gate, accurate gradients of corr + sim + equi card vs CPU "
            f"(B={TOOLS_TABLE_B}; CPU {time.perf_counter() - t1:.1f} s): worst cosine "
            f"{gate[0][0]} {gate[0][1]:.7f}, worst rel L2 {max(r[2] for r in gate):.3g}. "
            f"The train loss card vs CPU (printed, not held): worst cosine {full[0][0]} "
            f"{full[0][1]:.7f}, worst rel L2 {max(r[2] for r in full):.3g}; pairs whose "
            f"1 − cos lies on the two sides of the arccos clamp ({TOOLS_CLAMP}) on the two "
            f"devices: {straddle}; 1 − cos of the translation angle, card: "
            + ", ".join(f"{v:.3g}" for v in margins[1]) + "; CPU: "
            + ", ".join(f"{v:.3g}" for v in margins_cpu[1]))
        emul = grad_budget.compare(grads["packed keys"], fast_cpu)
        wc, wr, mr = grad_budget.summary(emul)
        log(f"tools (a) '{head}' fast on the card vs fast on the CPU (the plain versions round "
            f"the same operands to bf16 and sum in another order; printed, not held): worst "
            f"cosine {emul[0][0]} {wc:.7f}, worst rel L2 {wr:.3g}, median rel L2 {mr:.3g}")
        for what, g in grads.items():
            ref = acc["corr + sim + equi" if what.startswith("corr") else "train loss"]
            table = grad_budget.compare(g, ref)
            wc, wr, mr = grad_budget.summary(table)
            log(f"tools (a) '{head}' fast vs accurate, {what}, N={n} B={TOOLS_TABLE_B}: worst "
                f"cosine {wc:.7f}, worst rel L2 {wr:.3g}, median rel L2 {mr:.3g} "
                f"({len(table)} tensors); the table, worst first:")
            for name, cs, rel in table:
                log(f"  | {name} | {cs:.7f} | {rel:.3g} |")
            verdicts[(head, what)] = (wc, wr, mr)
    for (head, what), (wc, wr, mr) in verdicts.items():
        parity = wc >= TOOLS_REF_WORST_COS and mr <= TOOLS_REF_MEDIAN_REL
        log(f"tools (a) verdict '{head}' {what}: worst cosine {wc:.4f} (reference chip "
            f"{TOOLS_REF_WORST_COS}), median rel L2 {mr:.3g} (reference {TOOLS_REF_MEDIAN_REL}): "
            + ("parity" if parity else "beyond the reference's budget"))


def tools_scenarios(torch, dev, rows):
    """(b) tools/scenario_table.run_scenario at TOOLS_SEEDS seeds, N=1024,
    ransac with 4 branches, on the 60% and both 40% rows, in the default
    'approx' column (B1 whole cloud) and knn_method='fused' with chunked
    keys at W=768 (B4, B5). Every call must return a finite pose; the
    counts are printed against the reference's."""
    from se3_equi_graph_registration_tpu_torch.tools import scenario_table

    surf = scenario_table.make_bumpy_surface()
    cols = {"approx": ({}, {"knn_window": {"warp": 2 * TOOLS_SEEDS}}),
            "fused W=768": (dict(knn_method="fused", knn_packed="chunked", window=FPFH_WINDOW),
                            {"knn_chunked": {"warp": 2 * TOOLS_SEEDS},
                             "spfh": {"redux": 2 * TOOLS_SEEDS}})}
    counts = {col: [] for col in cols}
    for label, x_range, _, knobs in scenario_table.SCENARIOS[1:]:
        for col, (extra, want) in cols.items():
            t0 = time.perf_counter()
            rot, trans, ok = counted(
                rows, f"tools (b) {label} {col}",
                lambda: scenario_table.run_scenario(surf, "ransac", x_range, TOOLS_SEEDS, knobs,
                                                    dict(extra, ransac_branches=4), device=dev),
                want)
            check(np.all(np.isfinite(rot)) and np.all(np.isfinite(trans)),
                  f"tools (b) {label} {col}: a non-finite pose")
            counts[col].append(int(ok))
            log(f"tools (b) [{col}] " + scenario_table.cell_line(label, "ransac", rot, trans, ok)
                + f"  ({time.perf_counter() - t0:.1f} s)")
    for col, got in counts.items():
        ref = TOOLS_REF_COUNTS[col]
        below = [b - a for a, b in zip(got, ref) if b - a > 2]
        above = [a - b for a, b in zip(got, ref) if a - b > 2]
        log(f"tools (b) verdict {col}: {got} of {TOOLS_SEEDS} against the reference's {ref} "
            f"(BASELINE.md, TPU): " + (
                "parity (each within 2)" if not below and not above else
                f"no cell more than 2 below, {len(above)} above by more than 2"
                if not below else "more than 2 below in a cell: a fault, failing seeds above"))


def tools_icp_covariance(torch, dev, cfg, sd, rows):
    """(c) The ICP Registrar of the robust phase (60 point-ICP steps a scale
    over (ROBUST_VOXEL, 0.0), B=4 bumpy-surface pairs): card vs CPU at the
    serve gate, and the CPU against itself with every source coordinate one
    float32 ulp up, which measures the method's own sensitivity to a
    rounding."""
    import dataclasses

    from se3_equi_graph_registration_tpu_torch import serving
    from se3_equi_graph_registration_tpu_torch.train import engine

    width = dict(k=cfg.k, in_node_nf=cfg.in_node_nf, hidden_nf=cfg.hidden_nf,
                 n_layers=cfg.n_layers, num_heads=cfg.num_heads, top_k=cfg.top_k)
    rcfg = dataclasses.replace(engine.robust_eval_config(num_nodes=cfg.num_nodes, **width),
                               icp_iters=ROBUST_ICP_ITERS, icp_voxels=(ROBUST_VOXEL, 0.0))
    card, cpu = serving.Registrar(sd, rcfg, device=dev), serving.Registrar(sd, rcfg, device="cpu")
    src, sf, tgt, tf, _, _ = surface_requests(ROBUST_ICP_PAIRS, 31, cfg.num_nodes, cfg.in_node_nf)
    got = counted(rows, "tools (c) ICP Registrar", lambda: card.register(src, sf, tgt, tf),
                  {"knn_window": {"warp": 2}, "egcl_layer": {"tile": 2 * cfg.n_layers}})
    ulp = lambda a, d: np.nextafter(a, np.float32(d * np.inf))
    moved = {"source +1 ulp": (ulp(src, 1), sf, tgt, tf),
             "source -1 ulp": (ulp(src, -1), sf, tgt, tf),
             "target +1 ulp": (src, sf, ulp(tgt, 1), tf),
             "target -1 ulp": (src, sf, ulp(tgt, -1), tf)}
    outs = {name: counted(rows, f"tools (c) ICP Registrar, {name}",
                          lambda: card.register(*args),
                          {"knn_window": {"warp": 2}, "egcl_layer": {"tile": 2 * cfg.n_layers}})
            for name, args in moved.items()}
    card_ulp = {name: serve_gap(out, got, f"tools (c) card, {name}, vs card")[2]
                for name, out in outs.items()}
    covs = [np.asarray(o[2]["pose_covariance"]) for o in [got, *outs.values()]]
    spread = max(np.abs(a - b).max() / np.abs(b).max() for a in covs for b in covs)
    t0 = time.perf_counter()
    ref = cpu.register(src, sf, tgt, tf)
    up = cpu.register(*moved["source +1 ulp"])
    cpu_s = time.perf_counter() - t0
    card_gap = serve_gap(got, ref, "tools (c) card vs CPU")
    ulp_gap = serve_gap(up, ref, "tools (c) CPU, source +1 ulp, vs CPU")
    log(f"tools (c) ICP Registrar ({ROBUST_ICP_ITERS} steps over ({ROBUST_VOXEL}, 0.0), "
        f"B={ROBUST_ICP_PAIRS}): card vs CPU ‖ΔR‖/√2 {card_gap[0]:.3g}, |Δt| {card_gap[1]:.3g} m, "
        f"Δcov {card_gap[2]:.3g}; the CPU against itself with the source +1 ulp: "
        f"‖ΔR‖/√2 {ulp_gap[0]:.3g}, |Δt| {ulp_gap[1]:.3g} m, Δcov {ulp_gap[2]:.3g} (relative "
        f"to the largest entry; 2 CPU calls {cpu_s:.1f} s); the card against itself, Δcov "
        + ", ".join(f"{name} {v:.3g}" for name, v in card_ulp.items())
        + f", the largest between any two of the card's five answers {spread:.3g}. Float64 is "
        f"not run: ops/icp.py, ops/kabsch.py and ops/voxel.py compute in float32 by design "
        f"(the reference's precision) and the k-NN wrappers take float32 only")
    log("tools (c) verdict: " + (
        f"the method's: the card's own answers under 1-ulp input changes lie up to "
        f"{spread:.3g} apart, the card from the CPU {card_gap[2]:.3g}"
        if spread >= card_gap[2] else
        f"the card's gap to the CPU {card_gap[2]:.3g} exceeds the spread of its own answers "
        f"under 1-ulp input changes {spread:.3g}"))


# --- dist: data parallelism over pairs, a world of one card over NCCL ---
DIST_FIT_B = 16
DIST_FPFH_B = 8


def dist_phase(torch, dev, cfg, bsz, sd, rows):
    """A process group of one rank over NCCL (a tcp store on 127.0.0.1, the
    card): `Registrar.register` at `cfg`, B=`bsz`, and a BatchingServer over
    the mesh Registrar; `register_fpfh_batch` at B=8, fused and chunked at
    W=768; 2 `fit` steps at B=16 at `cfg` in accurate mode: each with and
    without the mesh, gated equal. The group is destroyed at the end."""
    import dataclasses
    import socket

    import torch.distributed as tdist

    from se3_equi_graph_registration_tpu_torch import registration, serving
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.parallel import global_mesh, init_distributed
    from se3_equi_graph_registration_tpu_torch.tools import grad_budget
    from se3_equi_graph_registration_tpu_torch.train import engine

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multi = init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev, timeout_s=120.0)
    try:
        check(not multi and tdist.is_initialized() and tdist.get_backend() == "nccl",
              "dist: not a one-rank NCCL group")
        mesh = global_mesh({"data": 1})
        check(mesh.backend == "nccl" and mesh.device == dev, f"dist: mesh {mesh}")
        try:
            serving.Registrar(sd, cfg, device="cpu", mesh=mesh)
            check(False, "dist: an NCCL mesh on a CPU Registrar did not raise")
        except ValueError:
            pass
        L, gaps = cfg.n_layers, {}

        def gap(a, b, relative=False):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            return float(np.abs(a - b).max() / (np.abs(b).max() if relative else 1.0))

        # (a) the Registrar and a BatchingServer over it
        reqs = make_pair_batch(np.random.default_rng(41), batch=bsz, n=cfg.num_nodes,
                               feat_dim=cfg.in_node_nf)
        args = (reqs.src_pts, reqs.src_feat, reqs.tgt_pts, reqs.tgt_feat)
        served = {"knn_window": {"warp": 2}, "egcl_layer": {"tile": 2 * L}}
        reg = serving.Registrar(sd, cfg, device=dev)
        mreg = serving.Registrar(sd, cfg, device=dev, mesh=mesh)
        a = counted(rows, "dist register", lambda: reg.register(*args), served)
        b = counted(rows, "dist register, mesh", lambda: mreg.register(*args), served)
        gaps["register R, t, cov, sim"] = max(
            gap(a[0], b[0]), gap(a[1], b[1]),
            gap(a[2]["pose_covariance"], b[2]["pose_covariance"], True),
            gap(a[2]["similarity_mean"], b[2]["similarity_mean"], True))
        server = serving.BatchingServer(mreg, max_batch=4, max_wait_ms=20)
        try:
            futs = [server.submit(*(x[i] for x in args)) for i in range(3)]
            answers = [f.result(timeout=300) for f in futs]
        finally:
            server.close()
        check(not server._thread.is_alive(), "dist: BatchingServer thread still running")
        gaps["BatchingServer R, t"] = max(max(gap(R, a[0][i]), gap(t, a[1][i]))
                                          for i, (R, t, _) in enumerate(answers))

        # (b) register_fpfh_batch, fused and chunked
        pairs = surface_pairs(DIST_FPFH_B, 43)
        src = np.stack([p[0] for p in pairs])
        tgt = np.stack([p[1] for p in pairs])
        kw = dict(knn_method="fused", knn_packed="chunked", window=FPFH_WINDOW, seed=5, device=dev)
        want = {"knn_chunked": {"warp": 2}, "spfh": {"redux": 2}}
        fa = counted(rows, "dist register_fpfh_batch",
                     lambda: registration.register_fpfh_batch(src, tgt, **kw), want)
        fb = counted(rows, "dist register_fpfh_batch, mesh",
                     lambda: registration.register_fpfh_batch(src, tgt, mesh=mesh, **kw), want)
        gaps["register_fpfh_batch R, t, cov, weights"] = max(
            gap(fa[0], fb[0]), gap(fa[1], fb[1]),
            gap(fa[2]["pose_covariance"], fb[2]["pose_covariance"], True),
            gap(fa[2]["weights"], fb[2]["weights"], True))
        for name, v in gaps.items():
            check(v <= 1e-6, f"dist {name}: mesh vs no mesh max|Δ| {v}")

        # (c) 2 fit steps (2 epochs of one batch) from one seeded init, in
        # accurate mode: fast mode's bf16 operands turn any fp32 difference
        # of step 1 (B3's atomic sums, the loss shares' order) into a
        # rounding flip in step 2
        fcfg = dataclasses.replace(cfg, egnn_accurate=True)
        batch = engine.batch_to_device(tuple(make_pair_batch(
            np.random.default_rng(47), batch=DIST_FIT_B, n=cfg.num_nodes,
            feat_dim=cfg.in_node_nf)), dev)
        init = engine.init_state(fcfg, torch.Generator().manual_seed(0), device=dev)
        g0 = counted(rows, "dist first-step gradients", lambda: grad_budget.gradients(
            init.model.state_dict(), fcfg, batch), {"knn_window": {"warp": 2},
                                                    "egcl_layer": {"tile_f32": 2 * L},
                                                    "egcl_backward": {"tile_f32": 2 * L}})

        def run_fit(m):
            state = engine.init_state(fcfg, torch.Generator().manual_seed(0), device=dev)
            logged = []
            engine.fit(state.model, state.optimizer, fcfg, state, lambda: [batch], 2,
                       logger=lambda e, met: logged.append(met), mesh=m)
            return ({key: v.detach().double().cpu() for key, v in state.model.state_dict().items()},
                    logged)

        want = {"knn_window": {"warp": 4}, "egcl_layer": {"tile_f32": 4 * L},
                "egcl_backward": {"tile_f32": 4 * L}}
        p_a, m_a = counted(rows, "dist fit", lambda: run_fit(None), want)
        p_m, m_m = counted(rows, "dist fit, mesh", lambda: run_fit(mesh), want)
        p_c, m_c = counted(rows, "dist fit, again", lambda: run_fit(None), want)

        def param_gaps(p, q):
            """(max|Δ| where the first gradient is above 1e-3 of its
            tensor's largest, max|Δ| everywhere)."""
            big, every = 0.0, 0.0
            for key, g in g0.items():
                d = (p[key] - q[key]).abs().numpy()
                sel = np.abs(g) > 1e-3 * np.abs(g).max()
                every = max(every, float(d.max()))
                if sel.any():
                    big = max(big, float(d[sel].max()))
            return big, every

        def loss_gaps(p, q):
            """Each step's largest loss-term gap, relative."""
            return [max(abs(a[key] - b[key]) / max(abs(a[key]), 1e-30)
                        for key in a if key != "epoch_seconds") for a, b in zip(p, q)]

        mesh_gap, ctrl_gap = param_gaps(p_a, p_m), param_gaps(p_a, p_c)
        mesh_loss, ctrl_loss = loss_gaps(m_a, m_m), loss_gaps(m_a, m_c)
        check(mesh_loss[0] <= 1e-6, f"dist fit: step 1 losses mesh vs no mesh, {mesh_loss}")
        check(mesh_gap[0] <= 1e-6 and mesh_gap[1] <= 2 * 2 * cfg.lr,
              f"dist fit: parameters mesh vs no mesh {mesh_gap}")
        log(f"dist: mesh against no mesh, max|Δ| (covariance, similarity and weights "
            f"relative to their largest) " + ", ".join(
                f"{name} {v:.3g}" for name, v in gaps.items()) + f"; fit, 2 steps "
            f"B={DIST_FIT_B}: losses relative by step {[f'{v:.3g}' for v in mesh_loss]}, "
            f"parameters {mesh_gap[0]:.3g} where the first gradient is above 1e-3 of its "
            f"tensor's max and {mesh_gap[1]:.3g} everywhere (lr {cfg.lr}); two runs without "
            f"the mesh: losses {[f'{v:.3g}' for v in ctrl_loss]}, parameters "
            f"{ctrl_gap[0]:.3g} and {ctrl_gap[1]:.3g} (B3's atomic sums)")
    finally:
        tdist.destroy_process_group()
    log(f"dist: phase {time.perf_counter() - t_phase:.1f} s; {card_line()}")


# --- point: point-axis sharding, mesh {data: 1, point: 1} over one card ---
# BASELINE.json config 5 ("Dense scaling: 8K-16K pts/frame") in accurate
# mode. 'cosine': at a seeded init the 'dot' head's softmax is one-hot, so
# its Kabsch solve sees one point and rounding sets the pose terms. The
# loss is KITTI's (`tools_conditioned`): at this init the 3DMatch pose
# terms sit at the arccos clamp, so they give the coordinate path no
# gradient and switch it on a rounding; the equi term reaches it smoothly.
POINT_CFG = dict(num_nodes=8192, k=16, in_node_nf=32, hidden_nf=32, n_layers=3, num_heads=4,
                 top_k=128, weight_mode="cosine")
POINT_B, POINT_HALO = 2, 64
POINT_TIE_ULPS = 8            # a tie: within 8 float32 spacings of the d² expansion's scale
# The gradients Adam applies, within 1e-4 of each tensor's largest: the
# attention kernels' gradient sums 2·8192·16 edge terms in float32, and the
# card's plain matrix product lands 5.0e-5 of its largest from both the CPU
# and the kernel step (`parallel.dryrun` holds 1e-5 at N=64). A lost share or
# a wrong scale of a collective's transpose is of the order of 1.
POINT_GRAD_TOL = 1e-4


def knn_ties(torch, x, a, b, what):
    """The rows whose neighbour sets differ between the graphs a and b
    [B, N, K] of clouds x [B, N, 3]; fails unless every neighbour in one set
    and not the other lies, in float64, within POINT_TIE_ULPS float32
    spacings of (|x_i| + max|x|)² of the row's k-th d²: a tie that rounding
    decides."""
    rows = (a.sort(-1).values != b.sort(-1).values).any(-1).nonzero().tolist()
    xd = x.double()
    top = xd.norm(dim=-1).amax(-1)
    for bi, r in rows:
        d2 = ((xd[bi] - xd[bi, r]) ** 2).sum(-1)
        kth = d2[a[bi, r].long()].max()
        swapped = torch.tensor(sorted(set(a[bi, r].tolist()) ^ set(b[bi, r].tolist())),
                               device=x.device)
        tol = POINT_TIE_ULPS * 2.0 ** -24 * float((xd[bi, r].norm() + top[bi]) ** 2)
        check(bool(((d2[swapped] - kth).abs() <= tol).all()),
              f"point {what}: row ({bi}, {r}) differs beyond a tie: "
              f"{(d2[swapped] - kth).tolist()} against {tol}")
    return len(rows)


def point_phase(torch, dev, rows):
    """The 2-axis train step of `parallel/point_sharding` in a one-rank NCCL
    group, mesh {data: 1, point: 1}, at N=8192, B=2 (POINT_CFG): (a) the
    all-gather regime's step on the card against the same step on the CPU
    (a mesh with no group); (b) the same step against the unsharded
    `make_train_step` on the card (2 whole-cloud B1, 6 fp32 tile B2 and 6
    B3), after counting the rows whose neighbour sets differ between the
    sharded k-NN (matrix-product expansion, `fp32_matmuls`) and B1 (the
    fixed-order formula), each a tie; gated on the step itself when no row
    differs, else on the step run over B1's graph; (c) the halo regime
    (W=64) against its twin (`parallel.dryrun.halo_twin`). Loss within
    1e-4, the gradients Adam applies within POINT_GRAD_TOL of each tensor's
    largest (they see a lost share or a wrong scale of the reduce-scatter,
    which one Adam step hides), parameters after the step within 5e-4 (the
    JAX dry run's).
    The sharded steps launch no kernel (the JAX package's slab EGNN is
    XLA, its slab k-NN lax.top_k); both steps timed with CUDA events, best
    of 3 after a warm-up."""
    import socket

    import torch.distributed as tdist

    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn
    from se3_equi_graph_registration_tpu_torch.parallel import (global_mesh, init_distributed,
                                                                make_mesh)
    from se3_equi_graph_registration_tpu_torch.parallel import point_sharding as ps
    from se3_equi_graph_registration_tpu_torch.parallel.dryrun import (grad_gap, halo_twin,
                                                                       update_grads)
    from se3_equi_graph_registration_tpu_torch.train import engine

    t_phase = time.perf_counter()
    cfg = engine.EngineConfig(**POINT_CFG, loss_weights=tools_conditioned())
    L, sides = cfg.n_layers, ("src_pts", "tgt_pts")
    host = engine.batch_to_device(tuple(make_pair_batch(
        np.random.default_rng(53), batch=POINT_B, n=cfg.num_nodes, feat_dim=cfg.in_node_nf)),
        "cpu")
    batch = {key: v.to(dev) for key, v in host.items()}

    def fresh(device):
        return engine.init_state(cfg, torch.Generator().manual_seed(0), device=device)

    def run_step(mesh, b, device, halo=None):
        """One point-sharded step from the seeded init → (its losses, the
        gradients Adam applied, the state, the step)."""
        state = fresh(device)
        grads = update_grads(state)
        step = ps.make_point_sharded_train_step(state.model, state.optimizer, cfg, mesh,
                                                halo=halo)
        _, m = step(state, ps.shard_points_batch(b, mesh))
        return {key: float(v) for key, v in m.items()}, grads, state, step

    def params(model):
        return {key: v.detach().double().cpu() for key, v in model.state_dict().items()}

    def gaps(m_a, g_a, model_a, m_b, g_b, model_b, what):
        """(|Δ| of the loss, the gradient gap, max|Δ| of the parameters)."""
        pa, pb = params(model_a), params(model_b)
        out = (abs(m_a["total"] - m_b["total"]), grad_gap(g_a, g_b),
               max(float((pa[key] - pb[key]).abs().max()) for key in pa))
        check(out[0] <= 1e-4 and out[1] <= POINT_GRAD_TOL and out[2] <= 5e-4,
              f"point {what}: loss, gradient, parameter gaps {out}")
        return out

    # the CPU side of (a), before the group: a mesh with no group
    t0 = time.perf_counter()
    cpu_mesh = make_mesh({"data": 1, "point": 1}, device="cpu")
    m_cpu, g_cpu, st_cpu, _ = run_step(cpu_mesh, host, "cpu")
    with torch.no_grad():
        cpu_graphs = [ps.sharded_knn_batched(host[key], cfg.k, cpu_mesh) for key in sides]
    t_cpu = time.perf_counter() - t0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multi = init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev, timeout_s=120.0)
    try:
        check(not multi and tdist.is_initialized() and tdist.get_backend() == "nccl",
              "point: not a one-rank NCCL group")
        mesh = global_mesh({"data": 1, "point": 1})
        check(mesh.backend == "nccl" and mesh.group("point") is not None
              and mesh.group("data") is not None, f"point: mesh {mesh}")
        blk = ps.shard_points_batch(batch, mesh)
        # (a) the all-gather regime, card against CPU
        m_a, g_a, st_a, step_a = counted(rows, "point step", lambda: run_step(mesh, batch, dev),
                                         {})
        with torch.no_grad():
            graphs = [ps.sharded_knn_batched(batch[key], cfg.k, mesh) for key in sides]
        cpu_ties = sum(knn_ties(torch, batch[key], g, c.to(dev), "card vs CPU sharded k-NN")
                       for key, g, c in zip(sides, graphs, cpu_graphs))
        gap_a = gaps(m_a, g_a, st_a.model, m_cpu, g_cpu, st_cpu.model, "(a) card vs CPU")

        # (b) against the unsharded step on the kernels
        with torch.no_grad():
            b1 = [knn.knn_window(batch[key].contiguous(), cfg.k, tile=128, window=None,
                                 packed=False) for key in sides]
        b1_ties = sum(knn_ties(torch, batch[key], g, b, "sharded k-NN vs B1")
                      for key, g, b in zip(sides, graphs, b1))
        st_u = fresh(dev)
        g_u = update_grads(st_u)
        step_u = engine.make_train_step(st_u.model, st_u.optimizer, cfg)
        _, m_u = counted(rows, "point unsharded step", lambda: step_u(st_u, batch),
                         {"knn_window": {"warp": 2}, "egcl_layer": {"tile_f32": 2 * L},
                          "egcl_backward": {"tile_f32": 2 * L}})
        m_b, g_b, st_b, gated_on = m_a, g_a, st_a, "the point step"
        if b1_ties:       # the same step, its k-NN answered with B1's graph
            calls = []

            def on_b1(x, k, m):
                for key, g in zip(sides, b1):
                    if torch.equal(x, batch[key]):
                        calls.append(key)
                        return g
                raise RuntimeError("point (b): the step's k-NN got a cloud of no side")

            sharded_knn = ps.sharded_knn_batched
            ps.sharded_knn_batched = on_b1
            try:
                m_b, g_b, st_b, _ = run_step(mesh, batch, dev)
            finally:
                ps.sharded_knn_batched = sharded_knn
            check(sorted(calls) == sorted(sides),
                  f"point (b): B1's graph answered the step's k-NN for {calls}, not {sides}")
            gated_on = "the point step over B1's graph"
        m_u = {key: float(v) for key, v in m_u.items()}
        gap_b = gaps(m_b, g_b, st_b.model, m_u, g_u, st_u.model, "(b) vs unsharded")

        # (c) the halo regime against its twin
        m_c, g_c, st_c, _ = counted(rows, "point halo step",
                                    lambda: run_step(mesh, batch, dev, POINT_HALO), {})
        st_t = fresh(dev)
        g_t = update_grads(st_t)
        twin = halo_twin(st_t, cfg, batch, mesh, POINT_HALO)
        gap_c = gaps(m_c, g_c, st_c.model, twin, g_t, st_t.model, "(c) halo vs twin")

        point_ms = best_event_ms(torch, lambda: step_a(st_a, blk))
        plain_ms = best_event_ms(torch, lambda: step_u(st_u, batch))
        show = lambda g: (f"loss |Δ| {g[0]:.3g}, gradients max|Δ|/max {g[1]:.3g}, "
                          f"parameters max|Δ| {g[2]:.3g}")
        log(f"point: N={cfg.num_nodes} B={POINT_B} k={cfg.k} C={cfg.hidden_nf} {L} layers, "
            f"accurate, mesh {mesh.shape} over NCCL: (a) card vs CPU {show(gap_a)}, sharded "
            f"k-NN rows differing card vs CPU {cpu_ties} (ties); (b) sharded k-NN vs B1 rows "
            f"differing {b1_ties} (ties), {gated_on} vs the unsharded step {show(gap_b)}; (c) "
            f"halo W={POINT_HALO} vs its twin {show(gap_c)}; losses {m_a}; step ms (CUDA "
            f"events, best of 3): point-sharded {point_ms:.2f}, unsharded {plain_ms:.2f}; "
            f"CPU side {t_cpu:.1f} s")
    finally:
        tdist.destroy_process_group()
    log(f"point: phase {time.perf_counter() - t_phase:.1f} s; {card_line()}")


# --- extras: the model zoo, reversible blocks, the SO(3) basis and the
# example twins, at fast_tpu_config's sizes (B=16, N=2048, K=16, C=32, 3
# layers) ---
EXTRAS_B = 16
EXTRAS_TOL = 1e-4          # the variants card vs CPU, of each output's max-abs scale (fp32)
EXTRAS_EQUI_TOL = 2e-4     # rotation equivariance on the card, of the scale (the JAX tests')
# the dense [B, N, N] GCN card vs CPU, of the scale: fp32 sits ~5e-7 from
# fp64 there, an einsum on TF32 operands ~4e-4 and on bf16 ones ~2.6e-3
# (tests/test_torch_zoo.py plants both on the CPU and sees this gate fail)
EXTRAS_GCN_TOL = 1e-5
EXTRAS_GCN_SIGMA = 0.5
REV_WIDTH, REV_ROWS, REV_BLOCKS = 256, 32768, (4, 12)
REV_TOL = 1e-4             # reversible against plain gradients, of each tensor's scale
SH_TOL, SH_IDENTITY_TOL = 1e-10, 1e-8
EXTRAS_DENOISE_STEPS = 50


def rel_gap(torch, got, ref):
    """max|got − ref| / max|ref|, in float64 on the host."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def gcn_forward(torch, layer, h, x):
    """The legacy GCN path at `x` [B, N, 3]: (the Gaussian adjacency
    [B, N, N], one GraphConvolution of h, its max and mean pooling)."""
    from se3_equi_graph_registration_tpu_torch.models import variants

    adj = variants.build_gaussian_adjacency(x, EXTRAS_GCN_SIGMA)
    out = layer(h, adj)
    return adj, out, variants.GlobalPooling()(out)


def seeded(module, seed):
    """`module` with the engine's seeded init (LeCun-normal kernels, zero
    biases, a 1e-3-gain coord output)."""
    import torch

    from se3_equi_graph_registration_tpu_torch.train.checkpoints import init_weights

    init_weights(module, torch.Generator().manual_seed(seed))
    return module


def extras_phase(torch, dev, cfg, rows):
    """The modules of the JAX package that are not on the registration
    paths, and the example twins as users call them: (a) the model zoo over
    B1's whole-cloud exact graph, card vs CPU and rotation equivariance on
    the card, and the legacy GCN at N=2048; (b) reversible blocks against
    their plain composition, with peak memory; (c) the SO(3) basis in
    float64, card vs CPU and its identities; (d) register_pair,
    global_registration, denoise and the multihost_train worker, each with
    its launches counted."""
    t_phase = time.perf_counter()
    extras_variants(torch, dev, cfg, rows)
    extras_reversible(torch, dev)
    extras_so3_basis(torch, dev)
    extras_examples(torch, dev, cfg, rows)
    log(f"extras: phase {time.perf_counter() - t_phase:.1f} s; {card_line()}")


def zoo_outputs(torch, mods, h, x, v, nbr):
    """Every variant's outputs on the device of its inputs (coordinates as
    their updates x' − x), under fp32 matmuls, {name: tensor}."""
    from se3_equi_graph_registration_tpu_torch.ops.edge_geometry import edge_geometry
    from se3_equi_graph_registration_tpu_torch.ops.numerics import fp32_matmuls

    with torch.no_grad(), fp32_matmuls():
        out = {}
        out["clean h"], xc = mods["clean"](h, x, nbr)
        out["clean Δx"] = xc - x
        out["gcl h"] = mods["gcl"](h, nbr)
        out["rf Δx"] = mods["rf"](x, nbr) - x
        out["clof h"], xf = mods["clof"](h, x, nbr)
        out["clof Δx"] = xf - x
        out["vel h"], xv, out["vel v"] = mods["vel"](h, x, v, nbr)
        out["vel Δx"] = xv - x
        out["so3_tp"] = mods["so3_tp"](edge_geometry(x, nbr).so3)
    return out


def extras_variants(torch, dev, cfg, rows):
    """(a) of the extras phase."""
    import copy

    from se3_equi_graph_registration_tpu_torch.data.synthetic import (make_pair_batch,
                                                                       random_rotation)
    from se3_equi_graph_registration_tpu_torch.models import variants
    from se3_equi_graph_registration_tpu_torch.ops.kernels import knn
    from se3_equi_graph_registration_tpu_torch.ops.numerics import fp32_matmuls

    t0 = time.perf_counter()
    n, k, c, L = cfg.num_nodes, cfg.k, cfg.hidden_nf, cfg.n_layers
    pb = make_pair_batch(np.random.default_rng(61), batch=EXTRAS_B, n=n, feat_dim=c)
    h, x = torch.from_numpy(pb.src_feat), torch.from_numpy(pb.src_pts)
    v = torch.from_numpy((np.random.default_rng(62).standard_normal(x.shape) * 0.1)
                         .astype(np.float32))
    hd, xd, vd = h.to(dev), x.to(dev), v.to(dev)
    nbr_d = counted(rows, "extras zoo graph", lambda: knn.knn_window(xd, k, tile=cfg.egnn_tile),
                    {"knn_window": {"warp": 1}})
    nbr = nbr_d.cpu()
    check(torch.equal(nbr, knn.knn_window(x, k, tile=cfg.egnn_tile)),
          "extras: the card's whole-cloud graph differs from the plain version's")
    mods = dict(clean=seeded(variants.CleanEGNN(c, c, c, L), 1),
                gcl=seeded(variants.GCL(c, c), 2), rf=seeded(variants.GCLrf(c), 3),
                clof=seeded(variants.ClofGCL(c, c), 4), vel=seeded(variants.EGCLVel(c, c), 5),
                so3_tp=seeded(variants.SO3TensorProductLayer(3, c), 6))
    card = {name: copy.deepcopy(m).to(dev) for name, m in mods.items()}
    got = zoo_outputs(torch, card, hd, xd, vd, nbr_d)
    zoo_ms = best_event_ms(torch, lambda: zoo_outputs(torch, card, hd, xd, vd, nbr_d))
    t1 = time.perf_counter()
    ref = zoo_outputs(torch, mods, h, x, v, nbr)
    cpu_s = time.perf_counter() - t1
    gaps = {key: rel_gap(torch, got[key], ref[key]) for key in ref}
    # a coordinate update u = x' − x is read back at x's fp32 spacing, one
    # rounding a layer: at CleanEGNN's 1e-3-gain coord output that floor
    # (3 · 2⁻²³ · max|x|) is ~4e-4 of u's scale, so the gate takes the gap
    # above it
    spacing = float(np.finfo(np.float32).eps) * float(x.abs().max())
    floor = {key: (L if key.startswith("clean") else 1) * spacing if "Δx" in key else 0.0
             for key in ref}
    above = {key: max(0.0, float((got[key].double().cpu() - ref[key].double()).abs().max())
                      - floor[key]) / float(ref[key].abs().max()) for key in ref}
    # ClofGCL's degeneracy cut, ‖x_i × x_j‖ < 1e-3 ‖x_i‖‖x_j‖, in float64
    xj = torch.take_along_dim(x.double()[:, :, None, :], nbr.long()[..., None], dim=1)
    xi = x.double()[:, :, None, :].expand_as(xj)
    ratio = torch.linalg.cross(xi, xj, dim=-1).norm(dim=-1) / (xi.norm(dim=-1) * xj.norm(dim=-1))
    degen, near = int((ratio < 1e-3).sum()), int(((ratio - 1e-3).abs() < 1e-6).sum())
    # rotation equivariance on the card: h and the tensor-product layer's
    # output invariant, coordinate updates and velocities rotated
    R = torch.from_numpy(random_rotation(np.random.default_rng(63)).astype(np.float32)).to(dev)
    rot = zoo_outputs(torch, card, hd, xd @ R.T, vd @ R.T, nbr_d)
    vector = ("rf Δx", "clof Δx", "vel Δx", "vel v")
    equi = {key: rel_gap(torch, rot[key], got[key] @ R.T if key in vector else got[key])
            for key in ("gcl h", "so3_tp", "clof h", "vel h") + vector}
    log(f"extras (a) zoo B={EXTRAS_B} N={n} K={k} C={c}: card vs CPU max|Δ| of the scale "
        + ", ".join(f"{key} {g:.3g}" for key, g in gaps.items())
        + "; above the coordinates' read-back floor " + ", ".join(
            f"{key} {above[key]:.3g} (floor {floor[key] / float(ref[key].abs().max()):.3g})"
            for key in ref if floor[key])
        + f"; equivariance on the card " + ", ".join(f"{key} {g:.3g}" for key, g in equi.items())
        + f"; ClofGCL degenerate edges {degen} of {ratio.numel()}, within 1e-6 of the cut "
        f"{near}; all variants {zoo_ms:.2f} ms (CUDA events, best of 3), CPU side {cpu_s:.1f} s")
    check(all(g <= EXTRAS_TOL for g in above.values()), f"extras zoo: card vs CPU {above}")
    check(all(g <= EXTRAS_EQUI_TOL for g in equi.values()), f"extras zoo: equivariance {equi}")

    # the legacy GCN path: the dense adjacency and its [N, N] einsum
    layer = seeded(variants.GraphConvolution(c, c), 7)
    card_gcn = copy.deepcopy(layer).to(dev)
    with torch.no_grad(), fp32_matmuls():
        on_card = gcn_forward(torch, card_gcn, hd, xd)
        gcn_ms = best_event_ms(torch, lambda: gcn_forward(torch, card_gcn, hd, xd))
        on_cpu = gcn_forward(torch, layer, h, x)
    adj = on_card[0]
    sym = float((adj - adj.transpose(1, 2)).abs().max() / adj.abs().max())
    gcn = {name: rel_gap(torch, a, b) for name, a, b in zip(("adjacency", "features", "pooled"),
                                                             on_card, on_cpu)}
    shapes = [tuple(t.shape) for t in on_card]
    log(f"extras (a) legacy GCN B={EXTRAS_B} N={n} sigma {EXTRAS_GCN_SIGMA}: card vs CPU "
        + ", ".join(f"{name} {g:.3g}" for name, g in gcn.items())
        + f" of the scale (gate {EXTRAS_GCN_TOL}); adjacency symmetry {sym:.3g}; shapes {shapes};"
        f" {gcn_ms:.2f} ms (CUDA events, best of 3); (a) {time.perf_counter() - t0:.1f} s")
    check(shapes == [(EXTRAS_B, n, n), (EXTRAS_B, n, c), (EXTRAS_B, 2 * c)],
          f"extras GCN shapes {shapes}")
    check(sym <= 1e-5 and all(g <= EXTRAS_GCN_TOL for g in gcn.values()),
          f"extras GCN: card vs CPU {gcn}, symmetry {sym}")


def rev_mlps(torch, n_blocks, seed):
    """(fs, gs): 2·n_blocks width-REV_WIDTH MLPs (Linear, SiLU, Linear),
    torch's default init from `seed`."""
    from torch import nn

    torch.manual_seed(seed)
    mlp = lambda: nn.Sequential(nn.Linear(REV_WIDTH, REV_WIDTH), nn.SiLU(),
                                nn.Linear(REV_WIDTH, REV_WIDTH))
    return (nn.ModuleList(mlp() for _ in range(n_blocks)),
            nn.ModuleList(mlp() for _ in range(n_blocks)))


def plain_sequence(fs, gs, a1, a2):
    """The reversible blocks' composition with autograd's own backward."""
    for f, g in zip(fs, gs):
        a1 = a1 + f(a2)
        a2 = a2 + g(a1)
    return a1, a2


def extras_reversible(torch, dev):
    """(b) of the extras phase: `reversible_sequence` of REV_BLOCKS blocks
    over [REV_ROWS, REV_WIDTH] streams against the plain composition: the
    gradients of the inputs and of every parameter, the inverse, the peak
    memory of the forward and backward above what was allocated before,
    and their time."""
    from se3_equi_graph_registration_tpu_torch.ops.numerics import fp32_matmuls
    from se3_equi_graph_registration_tpu_torch.utils import reversible

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(71)
    x1, x2, c1, c2 = (torch.randn(REV_ROWS, REV_WIDTH, generator=gen).to(dev) for _ in range(4))

    def backward(run, fs, gs):
        params = list(fs.parameters()) + list(gs.parameters())
        for p in params:
            p.grad = None
        a1, a2 = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        y1, y2 = run(fs, gs, a1, a2)
        torch.autograd.backward([y1, y2], [c1, c2])
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
        check(all(p.grad is not None for p in params), "extras reversible: a parameter got "
              "no gradient")
        grads = {"x1": a1.grad, "x2": a2.grad}
        grads.update({f"p{i}": p.grad.clone() for i, p in enumerate(params)})
        return peak, grads, (y1.detach(), y2.detach())

    report = []
    with fp32_matmuls():
        for blocks in REV_BLOCKS:
            fs, gs = (m.to(dev) for m in rev_mlps(torch, blocks, 72))
            peak_r, g_r, y_r = backward(reversible.reversible_sequence, fs, gs)
            peak_p, g_p, y_p = backward(plain_sequence, fs, gs)
            out = max(rel_gap(torch, a, b) for a, b in zip(y_r, y_p))
            grad = max(rel_gap(torch, g_r[key], g_p[key]) for key in g_p)
            with torch.no_grad():
                back = reversible.invert_sequence(fs, gs, *y_r)
            inv = max(rel_gap(torch, a, b) for a, b in zip(back, (x1, x2)))
            ms_r = best_event_ms(torch, lambda: backward(reversible.reversible_sequence, fs, gs))
            ms_p = best_event_ms(torch, lambda: backward(plain_sequence, fs, gs))
            report.append(f"{blocks} blocks: outputs {out:.3g}, gradients {grad:.3g} (worst of "
                          f"{len(g_p)} tensors), inverse {inv:.3g} of the scale; peak above the "
                          f"start {peak_r:.1f} MiB reversible against {peak_p:.1f} MiB plain; "
                          f"forward+backward {ms_r:.2f} ms against {ms_p:.2f} ms (CUDA events, "
                          f"best of 3)")
            check(out <= REV_TOL and grad <= REV_TOL and inv <= REV_TOL,
                  f"extras reversible, {blocks} blocks: outputs {out}, gradients {grad}, "
                  f"inverse {inv}")
            check(peak_r < peak_p, f"extras reversible, {blocks} blocks: peak {peak_r} MiB, "
                  f"plain {peak_p} MiB")
    log(f"extras (b) reversible, width {REV_WIDTH} MLPs over [{REV_ROWS}, {REV_WIDTH}] streams: "
        + "; ".join(report) + f"; (b) {time.perf_counter() - t0:.1f} s")


def extras_so3_basis(torch, dev):
    """(c) of the extras phase: the real spherical harmonics of the
    2048·16 edge directions of one cloud's k-NN graph (self-loops out) and
    the kernel basis at max_degree 2, in float64 on the card, against the
    CPU and against their identities Y(Rx) = D(R) Y(x) (l ≤ 3) and
    K(Rr) = D_out(R) K(r) D_in(R)ᵀ."""
    from se3_equi_graph_registration_tpu_torch.core.so3_basis import basis, wigner
    from se3_equi_graph_registration_tpu_torch.core.so3_basis import spherical_harmonics as sh
    from se3_equi_graph_registration_tpu_torch.data.synthetic import make_pair_batch
    from se3_equi_graph_registration_tpu_torch.ops.knn import knn_graph

    t0 = time.perf_counter()
    x = torch.from_numpy(make_pair_batch(np.random.default_rng(64), batch=1, n=2048).src_pts[0])
    nbr = knn_graph(x, 16, include_self=False).long()
    rel = (x[:, None, :] - x[nbr]).reshape(-1, 3).double()
    rel_d = rel.to(dev)
    angles = np.random.default_rng(65).uniform(-np.pi, np.pi, 3)
    R = wigner.rot(*angles)
    R_d = torch.from_numpy(R).to(dev)
    sh_cpu, sh_id = 0.0, 0.0
    for l in range(4):
        Y = sh.spherical_harmonics_xyz(l, rel_d)
        D = torch.from_numpy(wigner.wigner_d_from_matrix(l, R)).to(dev)
        sh_id = max(sh_id, float((sh.spherical_harmonics_xyz(l, rel_d @ R_d.T) - Y @ D.T)
                                 .abs().max()))
        sh_cpu = max(sh_cpu, float((Y.cpu() - sh.spherical_harmonics_xyz(l, rel)).abs().max()))
    on_card, on_cpu = basis.get_basis(rel_d, 2), basis.get_basis(rel, 2)
    rotated = basis.get_basis(rel_d @ R_d.T, 2)
    basis_cpu, basis_id = 0.0, 0.0
    for key, K in on_card.items():
        d_in, d_out = map(int, key.split(","))
        D_in, D_out = (torch.from_numpy(wigner.irr_repr(d, *angles)).to(dev) for d in (d_in, d_out))
        want = torch.einsum("ij,njkf,lk->nilf", D_out, K, D_in)
        basis_id = max(basis_id, float((rotated[key] - want).abs().max()))
        basis_cpu = max(basis_cpu, float((K.cpu() - on_cpu[key]).abs().max()))
    log(f"extras (c) SO(3) basis, float64, {rel.shape[0]} edge directions: SH l ≤ 3 card vs CPU "
        f"max|Δ| {sh_cpu:.3g}, Y(Rx) − D(R)Y(x) on the card {sh_id:.3g}; get_basis(max_degree "
        f"2, {len(on_card)} keys) card vs CPU {basis_cpu:.3g}, equivariance on the card "
        f"{basis_id:.3g}; (c) {time.perf_counter() - t0:.1f} s")
    check(sh_cpu <= SH_TOL and basis_cpu <= SH_TOL, f"extras SO(3) basis card vs CPU: SH "
          f"{sh_cpu}, basis {basis_cpu}")
    check(sh_id <= SH_TOL and basis_id <= SH_IDENTITY_TOL, f"extras SO(3) basis identities: "
          f"SH {sh_id}, basis {basis_id}")


def extras_examples(torch, dev, cfg, rows):
    """(d) of the extras phase: the example twins as a user calls them on
    the card, each with its launches counted and timed on the host clock."""
    import socket

    import torch.distributed as tdist

    from se3_equi_graph_registration_tpu_torch.examples import (denoise, global_registration,
                                                                multihost_train, register_pair)

    secs = {}

    def timed(name, call, want):
        t0 = time.perf_counter()
        out = counted(rows, f"extras {name}", call, want)
        secs[name] = time.perf_counter() - t0
        return out

    L, card = cfg.n_layers, str(dev)
    fast = {"knn_window": {"warp": 2}, "egcl_layer": {"tile": 2 * L}}
    rp = timed("register_pair", lambda: register_pair.main(["--n", "2048", "--device", card]),
               fast)
    rr = timed("register_pair --robust",
               lambda: register_pair.main(["--n", "2048", "--robust", "--device", card]), fast)
    for out in (rp, rr):
        check(abs(np.linalg.det(out["R"]) - 1) < 1e-4 and np.all(np.isfinite(out["t"]))
              and np.isfinite(out["rot_err_deg"]), f"extras register_pair: {out}")
    whole = {"knn_window": {"warp": 2}}
    gr = timed("global_registration", lambda: global_registration.main(["--device", card]), whole)
    check(gr["rot_err_deg"] < 1.0, f"extras global_registration: {gr['rot_err_deg']} deg")
    go = timed("global_registration --overlap 0.4",
               lambda: global_registration.main(["--overlap", "0.4", "--device", card]), whole)
    gf = timed("global_registration, fused knobs",
               lambda: global_registration.global_registration(
                   global_registration.parse_args(["--device", card]), knn_method="fused",
                   knn_packed="chunked", window=FPFH_WINDOW),
               {"knn_chunked": {"warp": 2}, "spfh": {"redux": 2}})
    dn = timed("denoise", lambda: denoise.denoise(EXTRAS_DENOISE_STEPS, 2048, 16, device=dev), {})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        logs = timed("multihost_train worker", lambda: multihost_train.worker(
            f"127.0.0.1:{port}", 1, 0, 2, 2048, dev),
            {"knn_window": {"warp": 4}, "egcl_layer": {"tile_f32": 4 * L},
             "egcl_backward": {"tile_f32": 4 * L}})
        check(tdist.is_initialized() and tdist.get_backend() == "nccl"
              and tdist.get_world_size() == 1, "extras multihost_train: not a one-rank NCCL group")
        check(len(logs) == 2 and all(np.isfinite(logs)), f"extras multihost_train losses {logs}")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    log(f"extras (d) examples on the card: register_pair R error vs the truth "
        f"{rp['rot_err_deg']:.2f} deg (seeded weights), --robust {rr['rot_err_deg']:.2f} deg; "
        f"global_registration {gr['rot_err_deg']:.3f} deg / {gr['trans_err_cm']:.3f} cm, "
        f"--overlap 0.4 {go['rot_err_deg']:.3f} deg / {go['trans_err_cm']:.3f} cm, fused "
        f"{gf['rot_err_deg']:.3f} deg / {gf['trans_err_cm']:.3f} cm; denoise "
        f"{EXTRAS_DENOISE_STEPS} steps at n=2048 k=16: MSE {dn['baseline']:.5f} -> "
        f"{dn['final']:.5f}; multihost_train worker (NCCL, one rank, N=2048, 16 pairs, 2 "
        f"epochs) losses {logs}; host seconds " + ", ".join(
            f"{name} {t:.2f}" for name, t in secs.items()))


if __name__ == "__main__":
    sys.exit(main())

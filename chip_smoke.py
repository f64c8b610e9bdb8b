#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100;
the kernels are built for sm_90a). Every phase is fatal on failure:

  1. the card (name and power limit from nvidia-smi), torch, CUDA and nvcc;
  2. build every CUDA kernel (K1-K3, the radix pass K5 and its inverse K6
     of the partition engine, K4 of the static viewer path and the probes
     P1 and P2) from wildgaussians_torch/csrc with nvcc, one process per
     source, all started together, printing nvcc's register and
     shared-memory report;
  3. check, on a 20k-Gaussian surfel scene at 512x384: each kernel against
     its plain PyTorch version on the card (K1 and K2 for 1-3 color passes,
     K3; K1's per-tile saturation vote bit for bit wherever K1 is held), the
     whole render path on the card against the same path on the
     CPU, and one training step on the card against the same step on the
     CPU from the same init (every parameter's gradient, the metrics, and
     the SSIM map the card's step computed against the CPU's on its inputs,
     with the process's TF32 flags left at torch's defaults: the entry
     points pin full f32 themselves); then the store functions on the card
     against the CPU, from the CPU
     step's store copied to each device with the same split normals:
     densify_and_prune (both abs-gradient modes, size pruning on; alive masks
     and stats equal unless a deciding value lies within 1e-6 of its
     threshold, at most 2 such slots), reset_opacity and grow_capacity;
     then the training step with the uncertainty model (dino, no dropout,
     acting from the first step, the head's convolution scaled so that
     loss_mult is 0 on some pixels and 1 on others), card vs CPU: its loss, every metric, the
     head's gradients beside the Gaussians', its loss_mult and new
     batch-norm statistics; the DINO features of a render letterboxed to
     336 (timed on the card) and loss_mult_for_image, card vs CPU;
     then the same render path and training step with `pallas_binning:
     partition`, and K5 and K6 against their plain versions (bit for bit)
     on every call the card's partition step made; then the saturation
     cull on an occluded scene (tests/test_satcull.py's, scaled up: 5 wall
     layers of 128x128 Gaussians in front of 4,000 far points, opacity
     0.99, alpha's cap): the per-tile
     saturation depths against the plain walk's (bit for bit) and the
     CPU's binning and blend from the same preprocess arrays, the pooled
     map culls cells and moves the image by at most 5e-3, a +inf map
     changes nothing, bit for bit; one training step under a map of camera
     0, card vs CPU (and the maps the steps write back); the render path
     and one training step with `pallas_binning: gather` and with
     `rasterizer_backend: tiled`, card vs CPU;
  4. the serving path at full width: a 1.5M-Gaussian, SH-degree-3,
     appearance-on checkpoint in the JAX package's format, loaded through
     WildGaussians and asked for 8 renders at 1280x720 from 4 poses (one with
     depth, one with an explicit embedding; the first is a warm-up); K1 held
     against its plain version on the arguments the first request and the
     depth request passed it (recorded by wrapping the wrapper for those
     requests), and timed on the first's beside its bound;
  5. where a request's time goes, on the same model: the render's stage
     spans timed on the device (wildgaussians_torch/spans.py), then one
     torch.profiler window of requests for the device's busy time, idle
     share and launches per request, and the kernels that take most of it;
  6. the training path at full width: WildGaussians(train_dataset=...) from
     the surfel scene's 1.5M points plus the default's 50,000 sky candidates,
     with the serving renders of step 4 as ground truth at 1280x720 and
     configs/default.yml (uncertainty disabled), for 8 train_iteration steps
     (the first a warm-up): step time, loss, PSNR and counters per step,
     peak memory, device time per stage span, and one torch.profiler window
     of steps; every kernel of the step launches once per step. The set-up's
     k-NN init statistic (ops/knn.py) is held on the card against the CPU on
     the points the set-up passed it (rtol 1e-6). K1, K2 and
     K3 are held against their plain versions on the arguments the warm-up
     step passed them, and K2 and K3 timed there beside their plain
     versions, their bounds and (K3) the PyTorch call that computes the
     same function. Then "train_uncertainty": the same set-up and steps with
     configs/default.yml's uncertainty model (the random-init DINOv2, dropout
     0.5) acting from the first step (no warm-up, no protected window), with
     its spans (dino_gt on a camera's first visit, dino_pred,
     uncertainty_head, uncertainty_loss), each step's share of pixels whose
     loss_mult is 0, and its batch-norm statistics moved and finite; K1-K3
     held on its first step's arguments;
  7. the partition engine at full width, through the same two phases: the
     checkpoint of step 4 with its config naming `pallas_binning:
     partition`, asked for 4 renders, and 4 training steps from step 6's
     set-up with `pallas_binning: partition` (the first of each a warm-up):
     request and step times, the engine's stage spans, a profiler window,
     peak memory, loss and PSNR, and the render's agreement with the sort
     engine's (printed only: entry order may differ where 24-bit depth keys
     tie). K1 and K5 are held against their plain versions on the arguments
     the first request passed them, K1, K2, K3, K5 and K6 on those of the
     first step, and K5 and K6 timed on each of that step's calls beside
     their bounds, their plain versions and the PyTorch calls that compute
     the same function. K5 runs 15 times per request and per step, K6 15
     times per step. The partition step's K2 also writes the two per-pass
     abs rows (each summed over the passes);
  7b. "train_satcull": step 6's set-up with `saturation_culling: true`, 8
     steps over the 4 cameras (each visited twice; a first visit runs
     under a +inf map): as step 6, plus each step's binned entries against
     its camera's first visit, each camera's share of finite supertiles,
     and, from the parameters after the steps, one camera's image without a
     map against the same with its last visit's map and with a map of its
     own exit depths (measured under the trainer's big-Gaussian pool, which
     the cull also reallocates; held within 5e-3 with a pool of every
     Gaussian, fatal); whether the cull fired is reported, not required. "gather_serve" and "gather_train": the
     gather engine (`pallas_binning: gather`) through phases 4 and 6, 4
     requests and 4 steps (K1 and K2 held on the first's arguments; the
     engine runs no K3). "tiled" and "tiled_train": the tiled backend
     (`rasterizer_backend: tiled`, plain torch, no kernel) through the same
     two phases, 2 requests and 2 steps (none traced: a tiled request
     issues ~58k launches, a step ~330k). "trajectory": 30 frames between
     the 4 serving poses whose appearance blends training embeddings 1 and
     5 (`trajectory_get_cameras`, `trajectory_get_embeddings`),
     `render_frames` to a .tar.gz: frames per second, each frame within
     1/255 of the model's render of its camera (K1 held on the first).
     "reference_import": the serving checkpoint written in the reference's
     layout (`chkpnt-30000.pth`), imported (`io/reference_import.py`),
     loaded and asked for pose 0, which must equal the serving render bit
     for bit; the seconds of the write, the import and the load;
  8. "densify" and "partition_densify": step 6's set-up under each engine
     with densify_from_iter 1, densification_interval 2,
     opacity_reset_interval 3 and the capacity of its live count rounded up
     to 256, for 5 steps: iteration 2 densifies and grows the store, 3
     resets the opacities, 4 densifies with size pruning, 5 trains on the
     grown store. Per step its ms, loss, the densify / reset_opacity /
     grow_capacity spans, stats and capacity; K1-K3 (and K5, K6) held
     against their plain versions on the last step's arguments;
  8b. "mesh": the multi-GPU paths at one rank, a one-rank NCCL group on a
     free loopback port (fatal if it cannot form: nothing falls back to
     one device). "mesh_serve" and "mesh_partition_serve": a warm-up and a
     timed request of pose 0 under the Gaussian-sharded sort engine and
     under the tile-sharded partition path, the image against the single
     device's (bit for bit expected; fatal beyond TOL_PIXEL), K1 (and K5)
     held on the request's own band calls; "mesh_train" and
     "mesh_partition_train": MESH_STEPS steps with `shard_gaussian_store`
     under each engine against the same steps on one device from the same
     set-up (losses step for step, fatal beyond TOL_METRIC; send_drops 0;
     times and spans beside the single device's), K1-K3 (and K5, K6) held
     on the last step's arguments;
  9. "cli" and "cli_nerfw", the training CLI end to end, in process
     (`wildgaussians_torch.train.main`, the shipped configs as they ship,
     uncertainty on (at 200 iterations their warm-up keeps loss_mult off
     and their protected window the head still), 200 iterations, the
     JSONL logger and, where installed, tensorboard): a
     COLMAP scene ("cli": configs/default.yml, the default protocol) and a
     Photo Tourism capture ("cli_nerfw": configs/phototourism.yml, the
     NeRF-W protocol, which fits an appearance embedding to each scored
     image's left half, here in 16 iterations of the config's 128) written
     to disk from the surfel scene's 1.5M points and 16 of the serving
     model's renders as 8-bit PNGs (1280x720; the capture in 1280x720,
     1024x768, 960x720 and 1022x683, whose halves are 511 wide and whose
     height is no multiple of 16, as a Photo Tourism photo's may be; one
     test image has that size). Seconds, from the CLI's spans, of the
     dataset load (of which points3D.bin parsing), image decoding, set-up,
     evaluation per image (render, embedding fit, PNG encode, metrics), and
     of the steps, the embedding fits (ms per iteration, s per image) and
     the whole phase; peak memory.
     Fatal: a non-zero exit, train/psnr not rising between its two windows,
     a non-finite result, a missing checkpoint file, a ply whose vertex
     count is not the live count, the reloaded checkpoint's render of test
     image 0 off the archived PNG by more than 1/255 on over 0.1 % of the
     pixels, NeRF-W results that are not the right halves' metrics; K1-K3
     held against their plain versions on the arguments of the first step,
     of the first embedding iteration ("cli_nerfw") and of the first
     evaluation render ("cli": K1);
 10. "raster", the rasterizer API at bench.py's shapes (1.5M Gaussians,
     1280x720, d_max 10, d_small 4): rasterize_gaussians(backend="pallas")
     on the random and the surfel scene, 8 forward-only calls, 4 forward +
     backward calls of an L1 loss (sort engine) and one forward + backward
     under the partition engine each, with ms per call, num_rendered and
     overflow; K1-K3 (and K5, K6) held on the first call of each kind; then
     one GaussianRasterizer call with SH degree 3 against
     rasterize_gaussians on the colors it precomputes;
 11. "static", the sort-once / blend-many viewer path on the surfel scene:
     bin_static once per pose, 20 render_static frames per pose with the
     background chained from the previous frame (bench.py's static mode):
     bin ms, ms per frame and frames per second; K4 held against its plain
     version, against K1 (bit for bit with bg 0) and the frame against
     rasterize_gaussians (within 1e-6), and timed;
 12. "probes": P1 on the random and the surfel scene (what
     `python -m wildgaussians_torch.profiles.probe_cfin` prints), the
     torch.sort sections of probe_sortdesign and P2's five run-scatter
     configurations; P1 held against K1's walked counts and its plain
     version, P2 bit for bit against its plain version, both timed.

Each path's launch counts are read over exactly that path's requests or
steps (the counts are set to 0 just before them; the launches of the holds
between them are not counted). It prints one {"kernels": [...]} line, the
nvidia-smi line of the card, and as its last line {"ok": true, "device":
{...}}. Without a CUDA card it exits with 1 and prints no result.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
DEVICE = "cuda"             # the card (store checks; the raster, static and probes scenes)
CHECK_N, CHECK_W, CHECK_H = 20_000, 512, 384
FULL_N, FULL_W, FULL_H = 1_500_000, 1280, 720
# K1 against its plain version, split by whether the two stop each pixel
# at the same entry (blend.blend_stops_plain): such a pixel can differ only
# where an alpha sits on the 1/255 floor, within TOL_PIXEL on all but
# TOL_FRAC of the pixels and TOL_MAX on all; a pixel whose stop flips (T
# at the 1e-4 stop, K1's product against the plain version's log-space
# sum) by at most the summed weight alpha T of the entries between the two
# stops (times the largest color), which at alpha's 0.99 cap reaches 1e-2;
# at most TOL_FRAC of the pixels may flip
TOL_PIXEL, TOL_FRAC, TOL_MAX = 1e-4, 1e-4, 5e-3
# the whole path, card vs CPU: the same float ops, but exp/log/matmul round
# differently, which can flip a corner cull or a depth-key tie
TOL_PATH_PIXEL, TOL_PATH_FRAC = 1e-3, 1e-3
# H100 SXM peaks (NVIDIA data sheet, dense): FP32 outside the tensor cores,
# HBM3 bandwidth; the SFU issues 1/16 of the FP32 flop rate
PEAK_FP32, PEAK_BYTES, SFU_COST = 67e12, 3.35e12, 16
# K1's FP32 operations (an FMA is two) per (pixel, entry) pair, by the work
# the pair needs (blend.blend_pair_counts): the power and its test; exp (at
# the SFU's cost), alpha, its clamp and test; the T (1 - alpha) test; the
# weight, then 3 FMAs per color pass
OPS_EVALUATED, OPS_EXP, OPS_USED, OPS_CONTRIB, OPS_PER_PASS = 12, 3 + SFU_COST, 3, 1, 6
# K2 walks the same pairs and repeats K1's work on them; a contributing pair
# then needs the gradient chain (the weight, dalpha with its divide, dpower,
# dmx/dmy, the three conic terms, dop, the abs channel and the T update: 40
# operations) and per pass cg, the prefix, the suffix and dcol (13), plus one
# add per gradient row (7 + 3 per pass) for the sum over the tile's pixels
K2_OPS_CONTRIB, K2_OPS_PER_PASS = 40 + 7, 13 + 3
# with the per-pass abs rows (the partition engine), per contributing pair
# and pass: that pass's dalpha with its divide, dpower, |dmx|, |dmy| and
# their two sums
K2_OPS_PASS_ABS = 20
# K1, K4, P1 and K2 need not evaluate a pixel block's pairs with an entry
# whose alpha reaches 1/255 on none of the block's pixels: their bounds count
# K1's evaluated and exp work only on the blocks each entry reaches
# (blend.blend_pair_counts with the kernels' 8x4 warp blocks), plus one test
# per (block, entry): the least q = d^T C d on each of the block's 4 pixel
# rows against 2 log(255 op) (12 operations a row; the log and the -cb/ca
# divide at the SFU's cost, and 7 more). Each timing line keeps the bound
# that counts that work on every pair as `bound_ms_all_pairs`
WARP_BLOCK = (8, 4)
OPS_REACH = 4 * 12 + 2 * SFU_COST + 7
# K2 against its plain version, per gradient row: max |error| over max |row|.
# The kernel sums each entry's values over 256 pixels in another order (a
# butterfly over each warp's 32 pixels, then the warps' sums), runs T as a
# product where the plain version uses exp of a log-space prefix, and
# multiplies by a fast reciprocal of 1 - alpha where it divides
TOL_ROW = 2e-3
# one training step, card vs CPU, from the same state: per parameter, the
# share of elements outside atol 5e-3 max|g| + rtol 5e-2 (a corner cull or a
# T stop that flips between the devices moves single Gaussians); metrics
TOL_GRAD_ATOL, TOL_GRAD_RTOL, TOL_GRAD_FRAC, TOL_METRIC = 5e-3, 5e-2, 1e-3, 1e-3
# the SSIM map a training step computes, on the card against the CPU on the
# same inputs, with torch's default TF32 flags in the process: the step pins
# full f32 (device.full_f32), so the two differ by f32 rounding alone (under
# cuDNN's TF32 by up to ~0.08: SSIM's variances cancel to within C2 = 9e-4)
TOL_SSIM = 1e-5
# the uncertainty model, card vs CPU: DINO features of one render at 336 and
# loss_mult_for_image within TOL_UNC of their largest value; a step's
# new batch-norm statistics within TOL_UNC (relative, floor TOL_UNC of the
# largest); its loss_mult (0 or 1 past the warm-up) and the thresholded
# loss_mult_for_image may differ on at most TOL_MULT_FRAC of the pixels (a
# value at the threshold 1 may fall either way)
TOL_UNC, TOL_MULT_FRAC = 1e-4, 1e-3
# the check phase's step with the uncertainty model: on from the first
# step (no warm-up, no protected window), without dropout so that both
# devices run the same head, whose 1x1 convolution is scaled by
# CHECK_HEAD_SCALE so that loss_mult is 1 on some pixels and 0 on the others
# (an initial head gives u ~ 1, below the threshold everywhere)
CHECK_UNCERTAINTY = dict(uncertainty_mode="dino", uncertainty_dropout=0.0,
                         uncertainty_warmup_start=0, uncertainty_warmup_iters=0,
                         uncertainty_protected_iters=0)
CHECK_HEAD_SCALE = 15.0
# the k-NN init statistic on the card against the CPU: the same operations,
# each rounded once (a true division, no fused sums)
TOL_KNN = 1e-6
# the store functions on the card against the CPU (densify_and_prune,
# reset_opacity): a slot whose deciding value lies within TOL_DECIDE
# (relative) of its threshold may be decided either way (exp, sigmoid and log
# round differently on the two devices); at most TOL_NEAR such slots. Live
# parameters within TOL_STORE_RTOL, with an absolute floor of TOL_STORE_ATOL
# times the tensor's largest |value|: a split child's position is the
# parent's plus an offset that may cancel it, so an ulp of the offset can be
# a large part of a small coordinate
TOL_DECIDE, TOL_NEAR, TOL_STORE_RTOL, TOL_STORE_ATOL = 1e-6, 2, 1e-5, 1e-6
PROFILE_REQUESTS = 5
CHECK_SKY = 2000            # sky candidates of the check phase's training set
TRAIN_STEPS, TRAIN_PROFILE_STEPS = 8, 2
# the full-width step with the uncertainty model (configs/default.yml's, its
# dropout 0.5) acting from the first step
TRAIN_UNCERTAINTY = dict(uncertainty_warmup_start=0, uncertainty_protected_iters=0)
PARTITION_REQUESTS, PARTITION_STEPS = 4, 4
# each training path's configuration over configs/default.yml
TRAIN_OVERRIDES = {
    "train": dict(uncertainty_mode="disabled"),
    "train_uncertainty": TRAIN_UNCERTAINTY,
    "partition_train": dict(uncertainty_mode="disabled", pallas_binning="partition"),
    "train_satcull": dict(uncertainty_mode="disabled", saturation_culling=True),
    "gather_train": dict(uncertainty_mode="disabled", pallas_binning="gather"),
    "tiled_train": dict(uncertainty_mode="disabled", rasterizer_backend="tiled"),
}
# "train_satcull": 8 steps over the 4 cameras (each visited twice); the
# gather engine's paths; the tiled backend's (requests, steps); the
# trajectory's frames between the 4 serving poses
# (the tiled steps are not traced: every gradient must show in them, and
# a fresh Gaussian is a sphere, whose rotation gets none in the first)
SATCULL_STEPS, GATHER_REQUESTS, GATHER_STEPS, TILED_REQUESTS, TILED_STEPS = 8, 4, 4, 2, 2
TRAJECTORY_FRAMES = 30
# the saturation cull changes an image by less than the early exit's
# tolerance (tests/test_satcull.py's bound); the occluded check scene: wall
# layers of SAT_WALL x SAT_WALL Gaussians in front of SAT_FAR far points
TOL_CULL = 5e-3
SAT_WALL, SAT_FAR = 128, 4000
# the test's walls are at opacity 0.99, alpha's cap, where the entry at
# which a pixel stops can carry a weight of up to 1e-2 (T before it under
# 1e-4 / (1 - 0.99)): K1's product and its plain version's log-space sum
# round T differently, so a pixel whose stop flips may differ by up to
# 1e-2, which K1's hold bounds by that weight (check_kernel)
SAT_OPACITY = 0.99
# a trajectory frame against the model's render of its camera: within 1/255
TOL_FRAME = 1.0 / 255.0
# the densify phase's schedule: iteration 2 densifies (and grows the store),
# 3 resets the opacities, 4 densifies with size pruning, 5 trains on the
# grown store
DENSIFY_STEPS = 5
DENSIFY_OVERRIDES = dict(densify_from_iter=1, densification_interval=2, opacity_reset_interval=3)
# the "mesh" phase: one rank of NCCL on the card (the sharded engines'
# band code, all-to-all, gathers and reductions at world size 1); its
# training schedule: iterations 3 and 6 densify (3 grows the store) and
# reset, 2, 4 and 5 are plain steps, before and after the growth; the last
# step's kernel arguments are recorded (on the single device too, so that
# both hold the same references), so steps 4 and 5 are compared
MESH_STEPS = 6
MESH_OVERRIDES = dict(uncertainty_mode="disabled", shard_gaussian_store=True,
                      densify_from_iter=1, densification_interval=3, opacity_reset_interval=3)
# the rasterizer API, the static viewer path and the probes run at bench.py's
# knobs: d_max 10, d_small 4 (big fraction 0.16), chunk 256
RASTER_D_MAX, RASTER_D_SMALL = 10, 4
RASTER_FWD, RASTER_BWD, STATIC_FRAMES = 8, 4, 20
# the static frame against the pallas backend's frame of the same scene (the
# JAX test's bound, tests/test_rasterize_pallas.py), and the
# GaussianRasterizer against rasterize_gaussians on the colors it computes
TOL_STATIC = 1e-6
# the training CLI's phases: CLI_IMAGES renders of the serving model as the
# photos (the every-8th split: 14 train, 2 test), CLI_ITERS iterations (two
# train/psnr windows of 100); the Photo Tourism capture's image sizes, in
# turn, and its NeRF-W test images (one of 1022x683, one of 960x720). The
# NeRF-W protocol's embedding fits run CLI_NERFW_FIT_ITERS iterations, not
# the config's 128: once the tile budget has grown (step 10: the sky's
# first-step footprints overflow it), an iteration takes ~0.2 s on an H100
# (80GB HBM3, 700 W), so the run's 8 fits of 128 would add ~200 s (of 32,
# ~50 s) to a script that must end well inside its time limit
CLI_IMAGES, CLI_ITERS, CLI_NERFW_FIT_ITERS = 16, 200, 16
CLI_EVAL_FEW = {"cli": "100,200", "cli_nerfw": "200"}
CLI_NERFW_SIZES = ((1280, 720), (1024, 768), (960, 720), (1022, 683))
CLI_NERFW_TEST = (3, 10)
# the reloaded checkpoint's render of a test image against the PNG the CLI
# archived: within 1/255 on all but this share of the pixels
TOL_RELOAD_FRAC = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


_START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's or a check's line also gets the
    script's wall-clock seconds so far (`t_s`)."""
    if "phase" in obj or "check" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_line():
    from wildgaussians_torch.ops import _build
    out = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                         check=True).stdout
    return [ln for ln in out.splitlines() if "release" in ln][0].strip()


def kernels():
    """Every kernel of the serving and training paths, over the sort and
    the partition engine, of the rasterizer API, the static viewer path and
    the probes, with its wrapper, its plain version and the paths that
    launch it."""
    from wildgaussians_torch.ops import blend, partition, static_blend
    from wildgaussians_torch.profiles import probe_cfin, probe_sortdesign
    return [dict(name="blend_fwd", route="cuda", source="wildgaussians_torch/csrc/blend_fwd.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:376",
                 wrapper=blend.blend_forward, plain=blend.blend_forward_plain,
                 paths=("serve", "train", "train_uncertainty", "partition_serve",
                        "partition_train", "densify", "partition_densify", "cli", "cli_nerfw",
                        "train_satcull", "gather_serve", "gather_train", "trajectory",
                        "reference_import", "raster", "mesh_serve", "mesh_partition_serve",
                        "mesh_train", "mesh_partition_train")),
            dict(name="blend_bwd", route="cuda", source="wildgaussians_torch/csrc/blend_bwd.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:493",
                 also_replaces=["wildgaussians_tpu/ops/rasterize_pallas.py:482",
                                "wildgaussians_tpu/ops/rasterize_pallas.py:501"],
                 wrapper=blend.blend_backward, plain=blend.blend_backward_plain,
                 paths=("train", "train_uncertainty", "partition_train", "densify",
                        "partition_densify", "cli", "cli_nerfw", "train_satcull", "gather_train",
                        "raster", "mesh_train", "mesh_partition_train")),
            dict(name="tier2_merge", route="cuda",
                 source="wildgaussians_torch/csrc/tier2_merge.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:872",
                 wrapper=blend.tier2_merge, plain=blend.tier2_merge_plain,
                 paths=("train", "train_uncertainty", "partition_train", "densify",
                        "partition_densify", "cli", "cli_nerfw", "train_satcull", "raster",
                        "mesh_train", "mesh_partition_train")),
            dict(name="blend_fwd_planar", route="cuda",
                 source="wildgaussians_torch/csrc/blend_fwd_planar.cu",
                 replaces="wildgaussians_tpu/ops/rasterize_pallas.py:1472",
                 wrapper=static_blend.blend_forward_planar,
                 plain=static_blend.blend_forward_planar_plain, paths=("static",)),
            dict(name="radix_pass", route="cuda", source="wildgaussians_torch/csrc/radix_pass.cu",
                 replaces="wildgaussians_tpu/ops/partition.py:173",
                 wrapper=partition.radix_pass, plain=partition.radix_pass_plain,
                 paths=("partition_serve", "partition_train", "partition_densify", "raster",
                        "mesh_partition_serve", "mesh_partition_train")),
            dict(name="radix_unpass", route="cuda",
                 source="wildgaussians_torch/csrc/radix_unpass.cu",
                 replaces="wildgaussians_tpu/ops/partition.py:376",
                 wrapper=partition.radix_unpass, plain=partition.radix_unpass_plain,
                 paths=("partition_train", "partition_densify", "raster",
                        "mesh_partition_train")),
            dict(name="probe_cfin", route="cuda", source="wildgaussians_torch/csrc/probe_cfin.cu",
                 replaces="tools/profiles/probe_cfin.py:95",
                 wrapper=probe_cfin.probe_cfin, plain=probe_cfin.probe_cfin_plain,
                 paths=("probes",)),
            dict(name="run_scatter", route="cuda", source="wildgaussians_torch/csrc/run_scatter.cu",
                 replaces="tools/profiles/probe_sortdesign.py:161",
                 wrapper=probe_sortdesign.run_scatter, plain=probe_sortdesign.run_scatter_plain,
                 paths=("probes",))]


def kernel_by_name(name):
    return next(k for k in kernels() if k["name"] == name)


@contextlib.contextmanager
def replaced(module, attr, fn):
    """Within the block, `module.attr` is `fn`."""
    orig = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def calls_of(module, attr, record):
    """A context in which a call of `module.attr` first hands its arguments
    to `record`."""
    orig = getattr(module, attr)

    def call(*args, **kwargs):
        record(*args, **kwargs)
        return orig(*args, **kwargs)
    # one attribute dict for both: a kernel wrapper counts its launches on
    # its module-level name, which is `call` within the block
    call.__dict__ = orig.__dict__
    return replaced(module, attr, call)


def results_of(module, attr, record):
    """A context in which a call of `module.attr` hands its result to `record`."""
    orig = getattr(module, attr)

    def call(*args, **kwargs):
        out = orig(*args, **kwargs)
        record(out)
        return out
    return replaced(module, attr, call)


def blend_calls(captured, first=False):
    """A context in which each blend kernel's wrapper keeps its arguments in
    `captured[kernel name]` (those of its last call, or with `first` of its
    first), detached from the autograd graph (the backward gets the
    forward's output final_T, which is part of it), and K3's `sums`, which
    it updates in place, as a copy. A K1 or K2 call on a band of the grid
    (a sharded engine's tile_base and num_tiles) keeps them as positional
    arguments after an `order` of None, as the wrappers and their plain
    versions take them."""
    from wildgaussians_torch.ops import blend
    stack = contextlib.ExitStack()
    for name, attr in (("blend_fwd", "blend_forward"), ("blend_bwd", "blend_backward"),
                       ("tier2_merge", "tier2_merge")):
        def record(*args, name=name, order=None, **band):
            # the tile order changes no result: the holds and timings call
            # the wrappers without it, and the wrappers compute it
            del order
            if first and name in captured:
                return
            if band:
                # K1: 5 arguments before `order`; K2: 11 (with gte_pass)
                head = 5 if name == "blend_fwd" else 11
                args = (args + (None,) * head)[:head] + (
                    None, band.get("tile_base", 0), band.get("num_tiles"))
            args = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
            captured[name] = (args[0].clone(),) + args[1:] if name == "tier2_merge" else args
        stack.enter_context(calls_of(blend, attr, record))
    return stack


def radix_calls(captured):
    """A context in which K5's and K6's wrappers append the arguments of
    every call to `captured["radix_pass"]` / `captured["radix_unpass"]`, as
    (args, kwargs), by reference (nothing changes them after the call)."""
    from wildgaussians_torch.ops import partition
    stack = contextlib.ExitStack()
    for attr in ("radix_pass", "radix_unpass"):
        def record(*args, attr=attr, **kwargs):
            captured.setdefault(attr, []).append((args, kwargs))
        stack.enter_context(calls_of(partition, attr, record))
    return stack


def kernel_calls(captured, radix):
    """blend_calls(captured) and radix_calls(radix) together."""
    stack = contextlib.ExitStack()
    stack.enter_context(blend_calls(captured))
    stack.enter_context(radix_calls(radix))
    return stack


def set_config(ckpt, key, value):
    """Make the checkpoint's config.yaml set `key` to `value` (its last key
    wins)."""
    with open(os.path.join(ckpt, "config.yaml"), "a", encoding="utf8") as f:
        f.write(f"{key}: {value}\n")
    return ckpt


def set_binning(ckpt, binning):
    """Make the checkpoint's config.yaml name `binning`."""
    return set_config(ckpt, "pallas_binning", binning)


def check_radix(calls, label):
    """K5 and K6 against their plain versions on recorded calls: both only
    move values, so bit for bit (an invalid Gaussian's attributes may be
    NaN, and move as they are). Returns each recorded kernel's largest
    |difference| (0), by name."""
    worst = {}
    for name in ("radix_pass", "radix_unpass"):
        if name not in calls:
            continue     # a request runs no K6
        k = kernel_by_name(name)
        worst[name] = 0.0
        for args, kwargs in calls[name]:
            got = k["wrapper"](*args, **kwargs)
            want = k["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            if name == "radix_pass":
                check(torch.equal(got[1], want[1]), f"radix_pass bases differ at {label}")
                got, want = got[0], want[0]
            worst[name] = max(worst[name], float((got - want).abs().nan_to_num(0.0).max()))
            check(got.shape == want.shape
                  and torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"{name} differs from its plain version at {label}, "
                  f"pass {args[2]} of a {tuple(args[0].shape)} table")
        emit({"check": name, "at": label, "calls": len(calls[name]), "equal": True})
    return worst


def camera(pose, width, height, f):
    from wildgaussians_torch.types import new_cameras
    return new_cameras(poses=np.asarray(pose, np.float32)[None],
                       intrinsics=np.array([[f, f, width / 2, height / 2]], np.float32),
                       camera_models=np.zeros((1,), np.int32),
                       distortion_parameters=np.zeros((1, 6), np.float32),
                       image_sizes=np.array([[width, height]], np.int32))


# (yaw, translation) of the four serving poses
POSE_PARAMS = ((0.0, (0.0, 0.0, 0.0)), (0.06, (0.4, -0.1, 0.5)),
               (-0.08, (-0.5, 0.1, 1.0)), (0.03, (0.2, 0.15, -0.5)))


def pose_of(yaw, t):
    """The camera-to-world [3, 4] pose of a yaw about y and a translation."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.concatenate([R, np.array(t, dtype=np.float64)[:, None]], axis=1)


def poses():
    """Four camera-to-world poses around the surfel scene's identity camera."""
    return [pose_of(yaw, t) for yaw, t in POSE_PARAMS]


def make_checkpoint(root, name, n, width, height):
    from wildgaussians_torch.scenes import write_surfel_checkpoint
    return write_surfel_checkpoint(os.path.join(root, name), n, width, height, SEED)


def pixel_errors(kernel_out, plain_out):
    """[T, 256]: each pixel's largest |difference| over colors and final_T."""
    kc, kt = kernel_out[:2]
    pc, pt = plain_out[:2]
    return torch.maximum((kc - pc).abs().amax(dim=(0, 3)), (kt - pt).abs())


def band_kw(inputs):
    """{tile_base, num_tiles} of a recorded K1 (8 arguments) or K2 (14) call
    on a band of the grid (blend_calls), else {}."""
    tail = {8: inputs[6:8], 14: inputs[12:14]}.get(len(inputs))
    return {} if tail is None else dict(tile_base=tail[0], num_tiles=tail[1])


def check_kernel(k, inputs, label):
    """K1 against its plain version, the pixels split by whether the two
    stop them at the same entry (TOL_PIXEL, TOL_FRAC, TOL_MAX above)."""
    from wildgaussians_torch.ops import blend
    out = k["wrapper"](*inputs)
    plain = k["plain"](*inputs)
    torch.cuda.synchronize()
    err = pixel_errors(out, plain)
    same, flip_w = blend.blend_stops_plain(*inputs[:4], out[1], **band_kw(inputs))
    total = err.numel()
    max_same = float(err[same].max()) if bool(same.any()) else 0.0
    over = int((err[same] > TOL_PIXEL).sum())
    flipped = int((~same).sum())
    cmax = max(1.0, float(inputs[0][6:].abs().max())) if inputs[0].shape[1] else 1.0
    flip_excess = float((err - flip_w * cmax - TOL_PIXEL)[~same].max()) if flipped else 0.0
    walked_diff = int((out[2] != plain[2]).sum())
    saturated = int(out[3].sum())
    emit({"check": k["name"], "at": label, "max_abs_err": float(err.max()),
          "max_abs_err_same_stop": max_same, "pixels_over_1e-4_same_stop": over,
          "pixels_stop_flipped": flipped,
          "max_flip_weight": float(flip_w[~same].max()) if flipped else 0.0,
          "max_abs_err_flipped": float(err[~same].max()) if flipped else 0.0,
          "pixels": total, "tiles_walked_differently": walked_diff,
          "tiles_saturated": saturated, "tiles": int(out[3].numel()),
          "saturation_vote_equal": bool(torch.equal(out[3], plain[3]))})
    check(max_same <= TOL_MAX and over <= TOL_FRAC * total,
          f"{k['name']} disagrees with its plain version at {label} where both stop at the "
          f"same entry: max {max_same}, {over} of {total} pixels over {TOL_PIXEL}")
    check(flipped <= TOL_FRAC * total,
          f"{k['name']} stops {flipped} of {total} pixels at another entry than its plain "
          f"version at {label}")
    check(flip_excess <= 0.0,
          f"{k['name']} moves a pixel whose stop flips by {flip_excess} more than the weight "
          f"of the entries between the two stops at {label}")
    max_err = float(err.max())
    check(torch.equal(out[3], plain[3]),
          f"{k['name']}'s saturation vote differs from its plain version's at {label} on "
          f"{int((out[3] != plain[3]).sum())} tiles")
    return max_err, over


def time_cuda_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved, ops, ops_all_pairs):
    """(ms, bound_by, ms_all_pairs): the larger of the bytes over the memory
    rate and the operations over the FP32 rate, and the same with the
    operations that evaluate every pair."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"),
            max(t_bytes, ops_all_pairs / PEAK_FP32 * 1e3))


def walk_ops(pairs, rest):
    """The operations of a forward walk (`pairs` from blend.blend_pair_counts
    with WARP_BLOCK) with `rest` operations after the evaluated and exp work:
    (with the reach test, evaluating only the blocks each entry reaches;
    evaluating every pair)."""
    return (pairs["reach_tests"] * OPS_REACH + pairs["evaluated_reached"] * OPS_EVALUATED
            + pairs["exp_reached"] * OPS_EXP + rest,
            pairs["evaluated"] * OPS_EVALUATED + pairs["exp"] * OPS_EXP + rest)


def blend_bound_ms(table, tile_counts, walked, n_passes, pairs):
    """Least time for K1's (and K4's) work on these inputs: the walked
    entries' table columns read once plus the outputs written once over the
    memory rate, against the operations these inputs need (`pairs`, by
    kind, from blend.blend_pair_counts with WARP_BLOCK) over the FP32 rate.
    Returns (ms, bound_by, ms_all_pairs)."""
    T = int(tile_counts.shape[0])
    walked_entries = int(walked.sum())
    bytes_moved = (walked_entries * table.shape[0] * 4 + T * 8
                   + (3 * n_passes + 1) * 256 * T * 4 + T * 4)
    return bound_ms(bytes_moved, *walk_ops(pairs, pairs["used"] * OPS_USED + pairs["contributing"]
                                           * (OPS_CONTRIB + OPS_PER_PASS * n_passes)))


def blend_inputs(pkg, n_passes, grid):
    b = pkg.blend
    return (b["table"][:6 + 3 * n_passes], b["tile_starts"], b["tile_counts"], grid, n_passes)


def k2_inputs(pkg, n_passes, grid, gcol=None, seed=SEED):
    """K2's arguments on the blend inputs of `pkg`: K1's outputs on the card
    and the color cotangent `gcol` (random when None) with a random summed
    gt_eff."""
    from wildgaussians_torch.ops import blend
    b = pkg.blend
    table = b["table"][:6 + 3 * n_passes]
    colors, final_t = blend.blend_forward(table, b["tile_starts"], b["tile_counts"], grid,
                                          n_passes)[:2]
    g = torch.Generator(device=table.device).manual_seed(seed)
    if gcol is None:
        gcol = torch.randn(colors.shape, generator=g, device=table.device) * 1e-3
    gte = torch.randn(final_t.shape, generator=g, device=table.device) * 1e-3
    return (table, b["tile_starts"], b["tile_counts"], grid, n_passes, gcol.contiguous(),
            gte, colors, final_t, (0.5 * grid.width, 0.5 * grid.height))


def check_k2(inputs, label):
    """K2 against its plain version, per gradient row (TOL_ROW)."""
    k = kernel_by_name("blend_bwd")
    out = k["wrapper"](*inputs)
    plain = k["plain"](*inputs)
    torch.cuda.synchronize()
    row_max = plain.abs().amax(dim=1)
    row_err = (out - plain).abs().amax(dim=1)
    rel = (row_err / torch.clamp_min(row_max, 1e-30)).tolist()
    emit({"check": "blend_bwd", "at": label, "rows": len(rel), "entries": int(out.shape[1]),
          "max_abs_err": float(row_err.max()), "row_rel_err": rel})
    check(torch.isfinite(out).all() and max(rel) <= TOL_ROW,
          f"blend_bwd disagrees with its plain version at {label}: row errors {rel}")
    return float(row_err.max()), max(rel)


def check_k3(sums, big_list, bigs, label):
    """K3 against its plain version: exactly, on a pool with a valid slot."""
    k = kernel_by_name("tier2_merge")
    out = k["wrapper"](sums.clone(), big_list, bigs)
    plain = k["plain"](sums.clone(), big_list, bigs)
    torch.cuda.synchronize()
    err = float((out - plain).abs().max())
    valid = int((big_list < sums.shape[1]).sum())
    emit({"check": "tier2_merge", "at": label, "rows": int(sums.shape[0]), "n": int(sums.shape[1]),
          "m_cap": int(big_list.shape[0]), "valid": valid, "max_abs_err": err,
          "equal": bool(torch.equal(out, plain))})
    check(torch.equal(out, plain), f"tier2_merge differs from its plain version at {label}")
    check(valid > 0, f"tier2_merge's pool is empty at {label}")
    return err


def training_set(cams, images, xyz, colors):
    """A Dataset of the given cameras and float images, seeded by a point
    cloud with colors in [0, 1]."""
    from wildgaussians_torch.types import Cameras
    cameras = Cameras.cat(cams)
    return dict(cameras=cameras, images=list(images), masks=None,
                points3D_xyz=np.asarray(xyz, np.float32),
                points3D_rgb=np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8),
                image_paths=[f"{i:03d}.png" for i in range(len(cams))], image_paths_root=".",
                mask_paths=None, mask_paths_root=None, metadata={}, images_points3D_indices=None)


def surfel_points(n, width, height):
    """The surfel scene's points and colors (the same draws as its checkpoint)."""
    from wildgaussians_torch.scenes import make_surfel_scene
    xyz, _s, _r, _o, colors = make_surfel_scene(np.random.default_rng(SEED), n, width, height,
                                                width / 1.4)
    return xyz, colors


def full_training_set(serve_model, cams):
    """The full-width training set: the serving renders of `cams` (the sort
    engine's) as ground truth, seeded by the surfel scene's points."""
    images = [serve_model.render(cam)["color"] for cam in cams]
    xyz, colors = surfel_points(FULL_N, FULL_W, FULL_H)
    return training_set(cams, images, xyz, colors), xyz


def check_train_step(gpu_model, cams, binning="sort", uncertainty=False, extra=None):
    """One training step with `pallas_binning: binning` (and the config
    overrides `extra`) on the card against the same step on the CPU from the
    same state (the CPU model's init copied to the card), at active SH
    degree 3 with anisotropic scales so that every parameter gets gradient:
    every parameter's gradient, read where the step hands it to Adam, and
    the metrics; and the SSIM map the card's step computed against the
    CPU's `ssim` on its inputs (TOL_SSIM). With `uncertainty`, the step runs
    the uncertainty model (CHECK_UNCERTAINTY; the head's gradients join the
    parameters'), and check_uncertainty holds its parts. With
    `saturation_culling` in `extra`, both steps bin under one map of camera
    0 (cull_map), and the maps they write back are compared. Returns the K5/K6 calls of the
    card's step (radix_calls) and the CPU model after its step."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.models import gaussian_store as gs
    from wildgaussians_torch.models import wildgaussians as trainer
    images = [gpu_model.render(cam)["color"] for cam in cams]
    xyz, colors = surfel_points(CHECK_N, CHECK_W, CHECK_H)
    ds = training_set(cams, images, xyz, colors)
    overrides = dict(uncertainty_mode="disabled", num_sky_gaussians=CHECK_SKY,
                     pallas_binning=binning, **(extra or {}))
    if uncertainty:
        overrides.update(CHECK_UNCERTAINTY)
    cpu = WildGaussians(train_dataset=ds, config_overrides=overrides, device="cpu")
    card = WildGaussians(train_dataset=ds, config_overrides=overrides)
    rng = np.random.default_rng(SEED)
    with torch.no_grad():
        for k, sigma in (("scales", 0.3), ("rotations", 0.2)):
            p = cpu.params[k]
            p.add_(torch.as_tensor(rng.normal(0, sigma, p.shape).astype(np.float32)))
        if uncertainty:
            cpu.uparams["conv_w"].mul_(CHECK_HEAD_SCALE)
        for k, p in card._trainable().items():
            p.copy_(cpu._trainable()[k].to(p.device))
    for m in (cpu, card):
        m.aux = m.aux._replace(
            active_sh_degree=torch.tensor(3, dtype=torch.int32, device=m.device),
            filter_3D=cpu.aux.filter_3D.to(m.device))
    sat = None
    if overrides.get("saturation_culling"):
        sat = cull_map(cpu)
        for m in (cpu, card):
            m._sat_cache_for(*m._pad_wh[0])[0] = sat.to(m.device)
    grads, metrics, seconds, radix, ssim_io, loss_mult = {}, {}, {}, {}, {}, {}
    ssim = trainer.ssim

    def record_ssim(img, gt, *args, **kwargs):
        out = ssim(img, gt, *args, **kwargs)
        ssim_io.update(img=img.detach().cpu(), gt=gt.detach().cpu(), out=out.detach().cpu())
        return out
    for name, m in (("cpu", cpu), ("card", card)):
        def record(_params, g, *_args, name=name, **_kwargs):
            grads[name] = {k: v.detach().to("cpu", copy=True) for k, v in g.items()}
        if uncertainty:
            def terms(*args, name=name, orig=m._uncertainty_terms):
                out = orig(*args)
                loss_mult[name] = out[1].cpu()
                return out
            m._uncertainty_terms = terms
        t0 = time.perf_counter()
        with calls_of(gs, "adam_update", record), \
                replaced(trainer, "ssim", record_ssim) if name == "card" else \
                contextlib.nullcontext(), \
                radix_calls(radix) if name == "card" else contextlib.nullcontext():
            metrics[name] = m.train_iteration(0, camera_id=0)
        seconds[name] = time.perf_counter() - t0
    m_cpu, m_card = metrics["cpu"], metrics["card"]
    per_param = {}
    alive = cpu.aux.alive
    for k, want in grads["cpu"].items():
        got = grads["card"][k]
        if want.shape[0] == alive.shape[0]:
            # a dead slot's gradient may be NaN, as in the JAX package (the
            # norm's derivative at 0 where a zero slot meets a camera centre)
            want, got = want[alive], got[alive]
        scale = float(want.abs().max())
        over = (got - want).abs() > TOL_GRAD_ATOL * scale + TOL_GRAD_RTOL * want.abs()
        per_param[k] = {"max_abs": scale, "max_err_rel": float((got - want).abs().max()) / max(scale, 1e-30),
                        "share_over_tol": float(over.float().mean())}
        check(scale > 0 and torch.isfinite(got).all(), f"train step: {k} has no finite gradient")
        check(per_param[k]["share_over_tol"] <= TOL_GRAD_FRAC,
              f"train step: the gradient of {k} differs between the card and the CPU: {per_param[k]}")
    metric_err = {k: abs(m_card[k] - v) / max(abs(v), 1e-12) for k, v in m_cpu.items()}
    sat_maps = {}
    if sat is not None:
        new = [m._sat_cache_for(*m._pad_wh[0])[0].cpu() for m in (cpu, card)]
        sat_maps = {"map_depth": float(sat.max()),
                    "new_map_finite_share": float(torch.isfinite(new[0]).float().mean()),
                    "new_map_equal_share": float((new[0] == new[1]).float().mean())}
        check(sat_maps["new_map_equal_share"] >= 0.99,
              f"the step's saturation maps differ between the card and the CPU: {sat_maps}")
    # the step's SSIM map against the CPU's on the same inputs, with the
    # process's TF32 flags at torch's defaults
    ssim_err = float((ssim(ssim_io["img"], ssim_io["gt"], size_average=False)
                      - ssim_io["out"]).abs().max())
    emit({"check": "train step, card vs CPU", "binning": binning, "size": [CHECK_W, CHECK_H],
          "uncertainty": uncertainty, "overrides": extra or {}, **sat_maps, "gaussians": int(m_cpu["num_gaussians"]),
          "cpu_step_s": seconds["cpu"], "metrics_cpu": m_cpu, "metrics_card": m_card,
          "metric_rel_err": metric_err, "gradients": per_param,
          "ssim_map_max_abs_diff": ssim_err,
          "tf32_flags": {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                         "float32_matmul_precision": torch.get_float32_matmul_precision()}})
    check(all(e <= TOL_METRIC for e in metric_err.values()),
          f"train step metrics differ between the card and the CPU: {metric_err}")
    check(ssim_err <= TOL_SSIM, f"the step's SSIM map differs from the CPU's by {ssim_err}")
    if uncertainty:
        check_uncertainty(cpu, card, loss_mult, images[0])
    return radix, cpu


def cull_map(model):
    """A saturation map for camera 0 that culls about half of the cells:
    every supertile at the median distance of the live Gaussians from the
    camera. (At the check size nothing saturates in an initial store, so a
    map of its own exit depths would be all +inf and cull nothing.)"""
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    from wildgaussians_torch.ops.sort_engine import supertile_shape
    xyz = model.params["xyz"].detach()[model.aux.alive]
    median = torch.linalg.norm(xyz - model._poses_dev[0][:, 3], dim=-1).median()
    return torch.full(supertile_shape(make_grid(*model._pad_wh[0], 16)), float(median))


def occluded_scene(width, height):
    """tests/test_satcull.py's occluded scene, scaled up: 5 wall layers of
    SAT_WALL x SAT_WALL Gaussians at z 4.6-5.4 over the frame (red, sigma
    the layer's spacing; over 256 entries a tile, so that the exit chunk's
    end lies in the wall) in front of SAT_FAR far points at z = 20 (blue),
    seen by the identity camera at a 60 degree field of view, every
    opacity SAT_OPACITY. Returns (xyz, scales, rotations, opacities,
    colors) and the focal length."""
    rng = np.random.default_rng(SEED)
    xyz, scales = [], []
    for z in (4.6, 4.8, 5.0, 5.2, 5.4):
        ext = z * 0.75
        xs, ys = np.meshgrid(np.linspace(-ext, ext, SAT_WALL), np.linspace(-ext, ext, SAT_WALL))
        xyz.append(np.stack([xs.ravel(), ys.ravel(), np.full(xs.size, z)], -1))
        scales.append(np.full((xs.size, 3), 2 * ext / (SAT_WALL - 1)))
    n_wall = sum(len(x) for x in xyz)
    xyz.append(np.stack([rng.uniform(-12, 12, SAT_FAR), rng.uniform(-12, 12, SAT_FAR),
                         np.full(SAT_FAR, 20.0)], -1))
    scales.append(np.full((SAT_FAR, 3), 0.6))
    xyz, scales = np.concatenate(xyz), np.concatenate(scales)
    n = len(xyz)
    rots = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    opac = np.full(n, SAT_OPACITY)
    colors = np.zeros((n, 3))
    colors[:n_wall, 0] = 0.9
    colors[n_wall:, 2] = 0.9
    f = width / (2 * np.tan(np.radians(30.0)))
    return tuple(np.asarray(a, np.float32) for a in (xyz, scales, rots, opac, colors)), f


def render_occluded(scene, f, width, height, device, sat_super=None, pre=None):
    """The occluded scene's sort-engine render on `device` (the preprocess
    of `pre`'s arrays when given), as tests/test_torch_satcull.py renders
    it: (image [H, W, 3], the blend's aux, the preprocess)."""
    from wildgaussians_torch.cameras import make_camera_params
    from wildgaussians_torch.ops import blend
    from wildgaussians_torch.ops.gaussians import compute_cov3d, preprocess
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    xyz, scales, rots, opac, colors = (torch.as_tensor(a, device=device) for a in scene)
    with torch.no_grad():
        if pre is None:
            cam, _w, _h = make_camera_params(camera(np.eye(4)[:3], width, height, f),
                                             device=torch.device(device))
            pre = preprocess(xyz, compute_cov3d(scales, rots), opac, cam, width, height, 0.1)
        else:
            pre = pre._replace(**{k: v.to(device) for k, v in pre._asdict().items()})
        (out,), aux = blend.rasterize_multi(
            pre.mean2d, pre.conic, pre.opacity, [colors], pre.depth, pre.rect_min, pre.rect_max,
            pre.tiles_touched, pre.valid, torch.zeros(3, device=device),
            grid=make_grid(width, height, 16), max_tiles_per_gaussian=16, d_small=4,
            big_fraction=0.5, sat_super=sat_super)
    return out[0], aux, pre


def check_satcull(errs):
    """The saturation cull on the occluded scene at the check size: K1 (and
    its vote) against its plain version on the unculled table, the per-tile
    saturation depths against those of the plain walk (bit for bit) and of
    the whole binning and blend on the CPU from the same preprocess arrays;
    the pooled map culls cells and changes the image by at most TOL_CULL; a
    +inf map changes nothing, bit for bit."""
    from wildgaussians_torch.ops import blend
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    from wildgaussians_torch.ops.sort_engine import (_sort_engine_sizes, pool_sat_depth,
                                                     sat_depth_from_walk, supertile_shape)
    w, h = CHECK_W, CHECK_H
    grid = make_grid(w, h, 16)
    scene, f = occluded_scene(w, h)
    img0, aux0, pre = render_occluded(scene, f, w, h, DEVICE)
    label = f"the occluded scene at {w}x{h}, {len(scene[0])} Gaussians"
    inputs = (aux0["table"], aux0["tile_starts"], aux0["tile_counts"], grid, 1)
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), inputs, label))
    _c, _t, p_walked, p_sat = blend.blend_forward_plain(*inputs)
    depth_bits = _sort_engine_sizes(grid, len(scene[0]), 16, 4, 0.5).depth_bits
    plain_depth = sat_depth_from_walk(p_walked, p_sat, aux0["tile_starts"], aux0["tile_counts"],
                                      aux0["sorted_key"], depth_bits)
    check(torch.equal(plain_depth, aux0["sat_depth"]),
          f"sat_depth differs from the plain walk's at {label}")
    _i, aux_cpu, _p = render_occluded(scene, f, w, h, "cpu", pre=pre)
    sat_card, sat_cpu = aux0["sat_depth"].cpu(), aux_cpu["sat_depth"]
    differ = int((sat_card != sat_cpu).sum())
    finite = torch.isfinite(sat_card)
    check(bool(finite.any()), f"no tile saturated at {label}")
    check(differ <= 0.005 * sat_card.numel(),
          f"sat_depth differs between the card and the CPU on {differ} tiles")
    sat_super = pool_sat_depth(aux0["sat_depth"], grid)
    img1, aux1, _p = render_occluded(scene, f, w, h, DEVICE, sat_super=sat_super, pre=pre)
    vis = [int(aux0["vis_count"].sum()), int(aux1["vis_count"].sum())]
    diff = float((img1 - img0).abs().max())
    inf_map = torch.full(supertile_shape(grid), torch.inf, device=DEVICE)
    img_inf, aux_inf, _p = render_occluded(scene, f, w, h, DEVICE, sat_super=inf_map, pre=pre)
    identity = torch.equal(img_inf, img0) and all(
        torch.equal(aux_inf[k], aux0[k]) for k in ("table", "tile_starts", "sorted_flat",
                                                   "walked", "saturated", "sat_depth"))
    emit({"check": "saturation cull", "at": label, "tiles": int(sat_card.numel()),
          "tiles_saturated": int(finite.sum()), "sat_depth_equal_plain_walk": True,
          "sat_depth_tiles_differ_cpu": differ,
          "map_finite_share": float(torch.isfinite(sat_super).float().mean()),
          "visible_cells": vis, "binned_entries": [int(aux0["tile_counts"].sum()),
                                                   int(aux1["tile_counts"].sum())],
          "max_abs_diff_with_map": diff, "inf_map_identity": identity})
    check(vis[1] < vis[0], f"the cull did not fire at {label}")
    check(diff <= TOL_CULL, f"the map changes the image by {diff} at {label}")
    check(identity, f"a +inf map changes the render at {label}")


def check_uncertainty(cpu, card, loss_mult, image):
    """The uncertainty model of one training step on the card against the
    CPU's (check_train_step with `uncertainty`): the step's loss_mult and
    new batch-norm statistics; the DINO features of `image` (a render)
    letterboxed to 336, also timed on the card beside its FP32 bound; and
    loss_mult_for_image of camera 0's padded image from the same head and
    statistics (the CPU model's), with its threshold at 1 (TOL_UNC,
    TOL_MULT_FRAC)."""
    from wildgaussians_torch.models.uncertainty import DINO_SIZE, resize_valid
    lm_diff = float((loss_mult["card"] != loss_mult["cpu"]).float().mean())
    bn_err = {}
    for k in ("mean", "var"):
        want = cpu._uncertainty.bn_state[k]
        got = card._uncertainty.bn_state[k].cpu()
        bn_err[k] = float(((got - want).abs() / torch.clamp_min(
            want.abs(), TOL_UNC * float(want.abs().max()))).max())
    h, w = image.shape[:2]

    def feats(m):
        img = torch.as_tensor(image, device=m.device)
        return m._uncertainty.dino_features(resize_valid(img, DINO_SIZE, DINO_SIZE, h, w,
                                                         letterbox=True))
    want = feats(cpu)
    got = feats(card)
    dino_err = float((got.cpu() - want).abs().max() / want.abs().max())
    dino_ms = time_cuda_ms(lambda: feats(card), iters=10)
    dino = card._uncertainty.dino
    d, t, blocks = dino.embed_dim, (DINO_SIZE // dino.patch_size) ** 2 + 5, dino.num_heads
    # the ViT's multiply-adds (2 operations each): per block qkv, q k^T, a v,
    # proj and the MLP; then the patch embedding
    dino_ops = 2 * (blocks * (t * d * 3 * d + 2 * t * t * d + t * d * d + 2 * t * d * 4 * d)
                    + (t - 5) * d * 3 * dino.patch_size ** 2)
    # loss_mult_for_image from one head and one set of statistics
    card._uncertainty.bn_state = {k: v.to(card.device)
                                  for k, v in cpu._uncertainty.bn_state.items()}
    card_head = {k: v.detach().to(card.device) for k, v in cpu.uparams.items()}
    aw, ah = cpu._sizes[0]
    want = cpu._uncertainty.loss_mult_for_image(cpu.uparams, cpu._train_images[0],
                                                 cpu._pixmask[0], ah, aw)
    got = card._uncertainty.loss_mult_for_image(card_head, card._train_images[0],
                                                card._pixmask[0], ah, aw).cpu()
    lmfi_err = float((got - want).abs().max() / want.abs().max())
    lmfi_diff = float(((got > 1) != (want > 1)).float().mean())
    zero = float((loss_mult["cpu"] == 0).float().mean())
    emit({"check": "uncertainty, card vs CPU", "size": [CHECK_W, CHECK_H],
          "step_loss_mult_share_differing": lm_diff, "step_loss_mult_share_zero": zero,
          "bn_state_rel_err": bn_err, "dino_features_rel_err": dino_err,
          "dino_features_ms": dino_ms, "dino_features_bound_ms": dino_ops / PEAK_FP32 * 1e3,
          "loss_mult_for_image_rel_err": lmfi_err,
          "loss_mult_for_image_share_over_1": float((want > 1).float().mean()),
          "loss_mult_for_image_threshold_share_differing": lmfi_diff})
    check(lm_diff <= TOL_MULT_FRAC, f"the step's loss_mult differs on {lm_diff} of the pixels")
    check(0 < zero < 1, f"the step's loss_mult is 0 on {zero} of the pixels")
    check(max(bn_err.values()) <= TOL_UNC, f"the batch-norm statistics differ: {bn_err}")
    check(dino_err <= TOL_UNC, f"DINO features differ by {dino_err} of their largest")
    check(lmfi_err <= TOL_UNC and lmfi_diff <= TOL_MULT_FRAC,
          f"loss_mult_for_image differs: {lmfi_err}, threshold on {lmfi_diff} of the pixels")


def store_on(model, device):
    """A copy of `model`'s store (params, Adam, aux) on `device`."""
    from wildgaussians_torch.models import gaussian_store as gs
    def copy(x):
        return x.detach().to(device, copy=True)
    params = {k: copy(v) for k, v in model.params.items()}
    adam = gs.AdamState({k: copy(v) for k, v in model.adam.mu.items()},
                        {k: copy(v) for k, v in model.adam.nu.items()}, copy(model.adam.step))
    return params, adam, gs.AuxState(*[copy(x) for x in model.aux])


def near_thresholds(store, out, config, extent, size_pruning):
    """The slots whose deciding value in densify_and_prune lies within
    TOL_DECIDE (relative) of its threshold, on the CPU's values: the mean
    gradient (and the mean abs gradient against its quantile), a selected
    slot's max scale, and after densify every slot's activated opacity (and
    max scale, with size pruning)."""
    from wildgaussians_torch.models import gaussian_store as gs
    params, _adam, aux = store
    new_params = out[0]

    def near(values, threshold):
        threshold = torch.as_tensor(threshold, dtype=torch.float32)
        return (values - threshold).abs() <= TOL_DECIDE * threshold.abs()
    alive = aux.alive
    denom = torch.clamp_min(aux.denom, 1e-12)
    grads = torch.nan_to_num(aux.xyz_grad / denom)[:, 0]
    flagged = near(grads, config.densify_grad_threshold) & alive
    sel = (grads >= config.densify_grad_threshold) & alive
    if config.use_gof_abs_gradient:
        gabs = torch.nan_to_num(aux.xyz_gradient_accum_abs / denom)[:, 0]
        q = gs._masked_quantile(gabs, alive, 1.0 - torch.sum(sel) / torch.clamp_min(alive.sum(), 1))
        flagged |= near(gabs, q) & alive
        sel |= (gabs >= q) & alive
    max_scale = torch.amax(torch.exp(params["scales"]), dim=1)
    flagged |= near(max_scale, torch.tensor(config.percent_dense) * torch.tensor(extent)) & sel
    flagged |= near(torch.sigmoid(new_params["opacities"])[:, 0], 0.005)
    if size_pruning:
        flagged |= near(torch.amax(torch.exp(new_params["scales"]), dim=1),
                        torch.tensor(0.1) * torch.tensor(extent))
    return int(flagged.sum())


def store_close(got, want, label):
    """Each tensor of `want` (CPU) equal to `got` (card) where it is not
    finite (a sky Gaussian's opacity logit is +inf; NaN equals NaN), else within
    TOL_STORE_RTOL |want| + TOL_STORE_ATOL max|want|. Returns the largest
    error over the scale and the elements outside plain TOL_STORE_RTOL."""
    worst, outside_rtol = 0.0, 0
    for k, w in want.items():
        g = got[k].cpu()
        finite = torch.isfinite(w)
        g_nf, w_nf = g[~finite], w[~finite]
        check(bool(((g_nf == w_nf) | (g_nf.isnan() & w_nf.isnan())).all()),
              f"{label}: {k} differs where not finite")
        g, w = g[finite], w[finite]
        if w.numel() == 0:
            continue
        scale = float(w.abs().max())
        err = (g - w).abs()
        over = err > TOL_STORE_RTOL * w.abs() + TOL_STORE_ATOL * scale
        check(not bool(over.any()), f"{label}: {k} differs between the card and the CPU "
                                    f"({int(over.sum())} elements, max {float(err.max())})")
        worst = max(worst, float(err.max()) / max(scale, 1e-30))
        outside_rtol += int((err > TOL_STORE_RTOL * w.abs()).sum())
    return worst, outside_rtol


def check_store_ops(cpu_model):
    """densify_and_prune (both abs modes, size pruning on), reset_opacity and
    grow_capacity on the card against the CPU, each from one store (the CPU
    model's after its training step, copied to each device) with the same
    split normals: alive masks and stats equal unless a deciding value lies
    within TOL_DECIDE of its threshold (at most TOL_NEAR such slots), live
    parameters, Adam's moments and aux buffers close (store_close); growth
    exactly. The extent is the one at which half the live Gaussians are
    cloned rather than split (the check cameras' own spread is so small
    that size pruning would remove every Gaussian)."""
    import dataclasses
    from wildgaussians_torch.models import gaussian_store as gs
    c = cpu_model.aux.alive.shape[0]
    max_scale = torch.amax(torch.exp(cpu_model.params["scales"].detach()), dim=1)
    extent = float(max_scale[cpu_model.aux.alive].median()) / cpu_model.config.percent_dense
    g = torch.Generator().manual_seed(SEED)
    normals = (torch.randn((c, 3), generator=g), torch.randn((c, 3), generator=g))
    for use_abs in (True, False):
        config = dataclasses.replace(cpu_model.config, use_gof_abs_gradient=use_abs)
        outs = {}
        for dev in ("cpu", DEVICE):
            store = store_on(cpu_model, dev)
            with replaced(gs, "split_normals",
                          lambda _c, _g, dev=dev: tuple(x.to(dev) for x in normals)):
                outs[dev] = gs.densify_and_prune(*store, config, extent, True,
                                                 torch.Generator(device=dev))
        near = near_thresholds(store_on(cpu_model, "cpu"), outs["cpu"], config, extent, True)
        (cp, ca, cx, cs), (gp, ga, gx, gst) = outs["cpu"], outs[DEVICE]
        stats = {k: (int(v), int(gst[k])) for k, v in cs.items()}
        alive_equal = torch.equal(gx.alive.cpu(), cx.alive)
        label = f"densify_and_prune, abs {use_abs}, card vs CPU"
        check(near <= TOL_NEAR, f"{label}: {near} deciding values within {TOL_DECIDE}")
        check(near > 0 or (alive_equal and all(a == b for a, b in stats.values())),
              f"{label}: alive masks or stats differ: {stats}")
        live = cx.alive
        worst, outside = (0.0, 0)
        if alive_equal:
            def rows(params):
                return {k: v.detach().cpu()[live] if v.shape[0] == c else v.detach().cpu()
                        for k, v in params.items()}
            worst, outside = store_close(rows(gp), rows(cp), label)
            for name in ("mu", "nu"):
                store_close(getattr(ga, name), getattr(ca, name), f"{label}, Adam {name}")
            store_close({f: getattr(gx, f) for f in gs.AuxState._fields if f != "alive"},
                        {f: getattr(cx, f) for f in gs.AuxState._fields if f != "alive"}, label)
        check(stats["clones"][0] > 0 and stats["splits"][0] > 0 and stats["n_alive"][0] > 0,
              f"{label}: nothing to compare: {stats}")
        emit({"check": "densify_and_prune, card vs CPU", "use_gof_abs_gradient": use_abs,
              "size_pruning": True, "extent": extent, "capacity": c, "stats": stats,
              "alive_equal": alive_equal,
              "near_threshold_slots": near, "max_err_over_scale": worst,
              "elements_outside_rtol": outside})
    # the opacity reset and a growth, each from the last densified CPU store
    def copy_store(dev):
        def to(x):
            return x.detach().to(dev, copy=True)
        return ({k: to(v) for k, v in cp.items()},
                gs.AdamState({k: to(v) for k, v in ca.mu.items()},
                             {k: to(v) for k, v in ca.nu.items()}, to(ca.step)),
                gs.AuxState(*[to(x) for x in cx]))
    resets = {}
    for dev in ("cpu", DEVICE):
        p, a, x = copy_store(dev)
        resets[dev] = (gs.reset_opacity(p, a, x)[0], x)
    live = cx.alive
    worst, outside = store_close({"opacities": resets[DEVICE][0]["opacities"][live.to(DEVICE)]},
                                 {"opacities": resets["cpu"][0]["opacities"][live]},
                                 "reset_opacity, card vs CPU")
    capped = gs.reset_capped_opacity(*resets[DEVICE])[live.to(DEVICE)]
    emit({"check": "reset_opacity, card vs CPU", "max_err_over_scale": worst,
          "elements_outside_rtol": outside, "max_capped_opacity": float(capped.max())})
    check(float(capped.max()) <= 0.01 * (1 + 1e-5), "reset_opacity left an opacity over 0.01")

    def flat(store):
        p, a, x = store
        out = {f"params/{k}": v.detach() for k, v in p.items()}
        out.update({f"mu/{k}": v for k, v in a.mu.items()})
        out.update({f"nu/{k}": v for k, v in a.nu.items()})
        out.update({f"aux/{f}": getattr(x, f) for f in gs.AuxState._fields})
        return out
    grown = {dev: flat(gs.grow_capacity(*copy_store(dev), c + 4096)) for dev in ("cpu", DEVICE)}
    check(grown["cpu"].keys() == grown[DEVICE].keys(), "grow_capacity: the store's keys")
    for k, v in grown["cpu"].items():
        g = grown[DEVICE][k].cpu()
        check(v.shape == g.shape and bool(((v == g) | (v.isnan() & g.isnan())).all()),
              f"grow_capacity, card vs CPU: {k}")
    emit({"check": "grow_capacity, card vs CPU", "capacity": [c, c + 4096], "equal": True})


def phase_check(tmp, errs):
    """Kernels against their plain versions at 512x384, the whole render
    path and one training step on the card against the CPU."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.ops import blend
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    ckpt = make_checkpoint(tmp, "check", CHECK_N, CHECK_W, CHECK_H)
    cam = camera(poses()[1], CHECK_W, CHECK_H, CHECK_W / 1.4)
    gpu = WildGaussians(checkpoint=ckpt)
    pkg = gpu.render_pkg(cam, options={"outputs": ["depth"]})
    grid = make_grid(CHECK_W, CHECK_H, 16)
    k = kernel_by_name("blend_fwd")
    for n_passes in (1, 2, 3):
        label = f"{CHECK_W}x{CHECK_H}, {CHECK_N} Gaussians, {n_passes} passes"
        errs["blend_fwd"].append(check_kernel(k, blend_inputs(pkg, n_passes, grid), label))
        errs["blend_bwd"].append(check_k2(k2_inputs(pkg, n_passes, grid), label))
    big_list = pkg.blend["big_list"]
    n = gpu.params["xyz"].shape[0]
    g = torch.Generator(device=gpu.device).manual_seed(SEED)
    rows = blend.grad_rows(2)
    errs["tier2_merge"].append(check_k3(
        torch.randn((rows, n), generator=g, device=gpu.device), big_list,
        torch.randn((rows, big_list.shape[0]), generator=g, device=gpu.device),
        f"{CHECK_N} Gaussians"))
    opts = {"outputs": ["depth"], "embedding": gpu.get_train_embedding(2)}
    compare_render_path(gpu, WildGaussians(checkpoint=ckpt, device="cpu"), cam, opts, "sort")
    train_cams = [camera(p, CHECK_W, CHECK_H, CHECK_W / 1.4) for p in poses()[:2]]
    _radix, cpu_model = check_train_step(gpu, train_cams)
    check_store_ops(cpu_model)
    del cpu_model
    # the same step with the uncertainty model
    check_train_step(gpu, train_cams, uncertainty=True)
    # the partition engine: the render path and one training step, card vs
    # CPU, and K5/K6 on the arguments the card's step passed them
    set_binning(ckpt, "partition")
    compare_render_path(WildGaussians(checkpoint=ckpt), WildGaussians(checkpoint=ckpt, device="cpu"),
                        cam, opts, "partition")
    radix, _cpu_model = check_train_step(gpu, train_cams, binning="partition")
    check(set(radix) == {"radix_pass", "radix_unpass"}, f"the partition step ran {set(radix)}")
    for name, err in check_radix(radix, f"a partition training step at {CHECK_W}x{CHECK_H}, "
                                        f"{CHECK_N} points + {CHECK_SKY} sky").items():
        errs[name].append(err)
    del radix
    # the saturation cull: on the occluded scene, then one step under a map
    check_satcull(errs)
    check_train_step(gpu, train_cams, extra=dict(saturation_culling=True))
    # the gather engine and the tiled backend: the render path and one
    # training step each, card vs CPU
    set_binning(ckpt, "gather")
    compare_render_path(WildGaussians(checkpoint=ckpt), WildGaussians(checkpoint=ckpt, device="cpu"),
                        cam, opts, "gather")
    check_train_step(gpu, train_cams, binning="gather")
    set_config(set_binning(ckpt, "sort"), "rasterizer_backend", "tiled")
    compare_render_path(WildGaussians(checkpoint=ckpt), WildGaussians(checkpoint=ckpt, device="cpu"),
                        cam, opts, "tiled backend")
    check_train_step(gpu, train_cams, extra=dict(rasterizer_backend="tiled"))
    del gpu, pkg
    torch.cuda.empty_cache()


def compare_render_path(card, cpu, cam, opts, binning):
    """The whole render path of two models of one checkpoint, card vs CPU."""
    on_card = card.render(cam, options=opts)
    on_cpu = cpu.render(cam, options=opts)
    for key in ("color", "accumulation"):
        d = np.abs(on_card[key] - on_cpu[key])
        d = d.max(-1) if d.ndim == 3 else d
        emit({"check": "render path, card vs CPU", "binning": binning, "output": key,
              "max_abs_diff": float(d.max()), "pixels_over_1e-3": int((d > TOL_PATH_PIXEL).sum()),
              "pixels": int(d.size)})
        check((d > TOL_PATH_PIXEL).mean() <= TOL_PATH_FRAC,
              f"{key} on the card differs from the CPU ({binning})")
    rel = np.abs(on_card["depth"] - on_cpu["depth"]) / max(float(on_cpu["depth"].max()), 1e-6)
    check((rel > TOL_PATH_PIXEL).mean() <= TOL_PATH_FRAC,
          f"depth on the card differs from the CPU ({binning})")


def load_checkpoint(tmp):
    """The full-width surfel checkpoint, written and loaded through
    WildGaussians; the seconds each took."""
    from wildgaussians_torch import WildGaussians
    t0 = time.perf_counter()
    ckpt = make_checkpoint(tmp, "full", FULL_N, FULL_W, FULL_H)
    t1 = time.perf_counter()
    model = WildGaussians(checkpoint=ckpt)
    torch.cuda.synchronize()
    return ckpt, model, {"checkpoint_write_s": t1 - t0,
                         "checkpoint_load_s": time.perf_counter() - t1}


def launches_per_unit(model, path):
    """Each kernel's launches per request or step of `path`: one, and for
    K5 and K6 one per radix pass of the partition engine."""
    per = {k["name"]: 1 for k in kernels() if path in k["paths"]}
    if "partition" in path:
        sizes = engine_sizes(model)
        for name in ("radix_pass", "radix_unpass"):
            if name in per:
                per[name] = sizes.L1 + sizes.L_A + sizes.L2
    return per


def phase_serve(model, cams, requests, path, errs, reference=None, extra=None,
                profile_requests=PROFILE_REQUESTS):
    """The serving path `path` at full width: `requests` ((pose, options)
    pairs, the first a warm-up) of `model`, each timed and its output
    checked, with each kernel's launches per request. K1 (and K5 on the
    partition path) is held against its plain version on the arguments the
    first request, and the first depth request, passed it (outside the
    timed requests), and timed on the first's. Then per-pose counters,
    where a request's time goes (phase_profile over `profile_requests`, none if 0), and with a
    `reference`
    model pose 0's agreement with its render (printed only: the engines'
    entry order may differ where 24-bit depth keys tie). Returns each
    kernel's launches over the requests and K1's timing."""
    ks = [k for k in kernels() if path in k["paths"]]
    per_request = launches_per_unit(model, path)
    hold_at = {0, next((i for i, (_p, o) in enumerate(requests) if o and "outputs" in o), 0)}
    if not ks:
        hold_at = set()    # the tiled backend launches no kernel
    for k in ks:
        k["wrapper"].launches = 0
    request_ms, acc_means, per_request_launches, timing, peak = [], [], [], None, 0
    for i, (pose_i, opts) in enumerate(requests):
        captured, radix = {}, {}
        before = {k["name"]: k["wrapper"].launches for k in ks}
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        with kernel_calls(captured, radix) if i in hold_at else contextlib.nullcontext():
            out = model.render(cams[pose_i], options=opts)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - r0) * 1e3)
        per_request_launches.append({k["name"]: k["wrapper"].launches - before[k["name"]]
                                     for k in ks})
        check(out["color"].shape == (FULL_H, FULL_W, 3), f"color shape {out['color'].shape}")
        check(all(np.isfinite(v).all() for v in out.values()), "non-finite render output")
        acc_means.append(float(out["accumulation"].mean()))
        check(acc_means[-1] > 0.5, f"mean accumulation {acc_means[-1]} <= 0.5")
        check((opts is not None and "outputs" in opts) == ("depth" in out), "depth output")
        if i > 0:     # the peak over the requests after the warm-up, not over the holds
            peak = max(peak, torch.cuda.max_memory_allocated())
        if i in hold_at:
            fwd = captured["blend_fwd"]
            label = (f"{path} request {i} at {FULL_W}x{FULL_H}, {FULL_N} Gaussians, "
                     f"pose {pose_i}, {fwd[4]} passes")
            check(set(radix) == {n for n in per_request if n == "radix_pass"},
                  f"{label} ran {set(radix)}")
            errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), fwd, label))
            for name, err in check_radix(radix, label).items():
                errs[name].append(err)
            if i == 0:
                timing = time_k1(fwd, label)
            del captured, radix, fwd
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    # the requests' own launches (not those of the holds)
    launches = {k["name"]: sum(per[k["name"]] for per in per_request_launches) for k in ks}
    for i, per in enumerate(per_request_launches):
        check(per == per_request, f"{path} request {i} launched {per}, not {per_request}")

    per_pose = []
    for i, cam in enumerate(cams):
        pkg = model.render_pkg(cam)
        per_pose.append({"pose": i, "overflow": int(pkg.overflow),
                         "num_rendered": int(pkg.num_rendered)})
        if pkg.blend:
            per_pose[-1].update(table=list(pkg.blend["table"].shape),
                                binned_entries=int(pkg.blend["tile_counts"].sum()),
                                walked_entries=int(pkg.blend["walked"].sum()))
        check(int(pkg.overflow) == 0, f"overflow {int(pkg.overflow)} at pose {i} ({path})")
    del pkg
    if reference is not None:
        d = np.abs(model.render(cams[0])["color"] - reference.render(cams[0])["color"])
        extra = dict(extra or {}, vs_reference_pose0={
            "max_abs_diff": float(d.max()), "pixels_over_1e-3": int((d.max(-1) > 1e-3).sum()),
            "psnr_db": float(-10 * np.log10(max(np.mean(d ** 2), 1e-20)))})
    emit({"phase": path, "binning": model.config.pallas_binning,
          "backend": model.config.rasterizer_backend, "gaussians": FULL_N,
          "size": [FULL_W, FULL_H], "request_ms": request_ms, "warmup_ms": request_ms[0],
          "steady_mean_ms": float(np.mean(request_ms[1:])), "launches_per_request": per_request,
          "mean_accumulation": acc_means, "per_pose": per_pose,
          "peak_mem_gib_after_warmup": peak / 2 ** 30, **(extra or {})})
    if profile_requests:
        phase_profile(model, cams[0], path, profile_requests)
    return launches, timing


def time_k1(inputs, label):
    """K1 timed on the arguments one request passed it, beside its plain
    version and its bound."""
    from wildgaussians_torch.ops import blend
    k = kernel_by_name("blend_fwd")
    n_passes = inputs[4]
    ms = time_cuda_ms(lambda: k["wrapper"](*inputs), iters=20)
    plain_ms = time_cuda_ms(lambda: k["plain"](*inputs), iters=3, warmup=1)
    walked = k["wrapper"](*inputs)[2]
    pairs = blend.blend_pair_counts(*inputs[:4], warp_block=WARP_BLOCK, **band_kw(inputs))
    bound, bound_by, bound_all_pairs = blend_bound_ms(inputs[0], inputs[2], walked, n_passes,
                                                      pairs)
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=None,
               bound_ms_all_pairs=bound_all_pairs)
    emit({"phase": "timing", "kernel": k["name"], "at": label, "passes": n_passes,
          "pairs": pairs, "walked_pairs": int(walked.sum()) * 256,
          "binned_entries": int(inputs[2].sum()), "walked_entries": int(walked.sum()), **out})
    return out


def _union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_window(prof, traced_us, n, unit):
    """What one torch.profiler window over n `unit`s (request or step) shows,
    per unit: the traced time, the device's busy time (the union of its
    kernel and copy intervals), its idle share, its launches and the device
    ops that take most of it."""
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in prof.events() if e.device_type == cuda]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in device_events])
    by_name = {}
    for e in device_events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {f"traced_{unit}_ms": traced_us / 1e3 / n, "device_busy_ms": busy_us / 1e3 / n,
            "device_idle_share": 1.0 - busy_us / traced_us,
            f"device_launches_per_{unit}": len(device_events) / n,
            "top_device_ops": [{"name": name[:90], f"ms_per_{unit}": us / 1e3 / n,
                                f"per_{unit}": count / n} for name, (us, count) in top]}


def phase_profile(model, cam, path, n):
    """Where a request's time goes (pose 0, raw + toned passes): the stage
    spans over n requests, then one torch.profiler window over as many,
    whose device busy time (the union of its kernel and copy intervals),
    idle share and launch count are all read from that window."""
    from wildgaussians_torch.spans import SpanTimer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SpanTimer() as timer:
        for _ in range(n):
            model.render(cam)
    stages = timer.ms()
    spans_wall_ms = (time.perf_counter() - t0) * 1e3 / n
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            model.render(cam)
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    window = device_window(prof, traced_us, n, "request")
    emit({"phase": "profile", "path": path, "requests": n,
          "request_ms_with_spans": spans_wall_ms,
          "stage_device_ms": {name: ms / n for name, (ms, _c) in stages.items()},
          # the traced window is lengthened by the profiler itself; beside it,
          # the traced busy time over the request time with spans only
          "busy_over_untraced_request": window["device_busy_ms"] / spans_wall_ms, **window})


def phase_train(serve_model, cams, path, n_steps, profile_steps, errs):
    """The training path `path` at full width, under TRAIN_OVERRIDES[path]
    ("train": the sort engine, "partition_train", "gather_train": the
    partition and gather engines, "train_satcull": the sort engine with the
    saturation cull, "tiled_train": the tiled backend, all with uncertainty
    disabled; "train_uncertainty": the sort engine with configs/default.yml's
    uncertainty model acting from the first step; see the module
    docstring): n_steps steps, the first a warm-up whose kernel arguments
    are recorded and held right after it (hold_step, outside the timed
    steps); spans on the steps between, a profiler window on the last
    profile_steps (none if 0). With the uncertainty model, also each step's share of
    pixels whose loss_mult is 0 (read after the steps) and whether its
    batch-norm statistics moved and stayed finite; with the cull, what it
    culled (satcull_report). Returns each kernel's launches over the steps
    and the timings of hold_step."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.models import gaussian_store as gs
    from wildgaussians_torch.models import wildgaussians as trainer
    from wildgaussians_torch.spans import SpanTimer
    overrides = dict(TRAIN_OVERRIDES[path])
    binning = overrides.get("pallas_binning", "sort")
    ks = [k for k in kernels() if path in k["paths"]]
    uncertainty = path == "train_uncertainty"
    satcull = overrides.get("saturation_culling", False)
    ds, xyz = full_training_set(serve_model, cams)
    knn_points = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with calls_of(trainer, "mean_knn_dist2", lambda pts, *_a, **_k: knn_points.append(pts)):
        model = WildGaussians(train_dataset=ds, config_overrides=overrides)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    loss_mults, bn0, rendered = [], None, []
    if satcull:
        check(model._use_satcull(), f"{path}: the cull is off")
    if uncertainty:
        check(model.config.uncertainty_mode == "dino", "train_uncertainty's config")
        bn0 = {k: v.clone() for k, v in model._uncertainty.bn_state.items()}

        def terms(*args, orig=model._uncertainty_terms):
            out = orig(*args)
            loss_mults.append(out[1])
            return out
        model._uncertainty_terms = terms
    if path == "train":
        check(len(knn_points) == 1 and knn_points[0].device.type == model.device.type,
              "the set-up's k-NN call")
        hold_knn(knn_points[0], f"{path} set-up, the surfel scene's points and the sky's")
    del knn_points
    per_step = launches_per_unit(model, path)
    stages_of = partition_stages(engine_sizes(model)) if binning == "partition" else None
    n_plain = n_steps - profile_steps
    # per parameter over the steps before the profiled ones, taken where
    # each step hands its gradients to Adam and read after the step, outside
    # its timing: every gradient finite, and its largest |g|
    grad_max, pending = {}, []

    def observe(_params, grads, *_args, **_kwargs):
        pending.append(grads)

    def fold():
        alive = model.aux.alive
        for k, g in pending.pop().items():
            if g.shape[0] == alive.shape[0]:
                g = g[alive]   # a dead slot's gradient may be NaN (see check_train_step)
            m = torch.where(torch.isfinite(g), g.abs(), torch.inf).max()
            grad_max[k] = m if k not in grad_max else torch.maximum(grad_max[k], m)
    for k in ks:
        k["wrapper"].launches = 0
    steps, per_step_launches, timings = [], [], None

    def run(step):
        """One timed step; the warm-up's kernel arguments are recorded and
        held after it."""
        nonlocal timings
        captured, radix = {}, {}
        before = {k["name"]: k["wrapper"].launches for k in ks}
        torch.cuda.synchronize()
        r0 = time.perf_counter()
        with kernel_calls(captured, radix) if step == 0 else contextlib.nullcontext(), \
                results_of(trainer, "render_internal", rendered.append) if satcull else \
                contextlib.nullcontext():
            metrics = model.train_iteration(step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - r0) * 1e3
        per_step_launches.append({k["name"]: k["wrapper"].launches - before[k["name"]]
                                  for k in ks})
        steps.append({"step": step, "ms": ms, **{key: metrics[key] for key in (
            "loss", "psnr", "num_rendered", "overflow", "max_tiles", "num_gaussians",
            "uncertainty_loss", "beta") if key in metrics}})
        check(np.isfinite(metrics["loss"]), f"{path}: loss at step {step} is {metrics['loss']}")
        if satcull:
            pkg = rendered.pop()
            steps[-1].update(camera=model._last_camera_id,
                             binned_entries=pkg.blend["tile_counts"].sum())
            del pkg
        if step < n_plain:
            fold()
        if step == 0 and ks:
            label = (f"{path} step 0 at {FULL_W}x{FULL_H}, {metrics['num_gaussians']} "
                     f"Gaussians, {captured['blend_fwd'][4]} passes")
            timings = hold_step(captured, radix, stages_of, label, errs)
            del captured, radix
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        return ms

    with calls_of(gs, "adam_update", observe):
        run(0)
        with SpanTimer() as timer:
            for step in range(1, n_plain):
                run(step)
    window = {}
    if profile_steps:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            traced_us = sum(run(step) for step in range(n_plain, n_steps)) * 1e3
        window = device_window(prof, traced_us, profile_steps, "step")
    # the steps' own launches (not those of hold_step's checks)
    launches = {k["name"]: sum(per[k["name"]] for per in per_step_launches) for k in ks}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    stages = timer.ms()
    for i, per in enumerate(per_step_launches):
        check(per == per_step, f"{path} step {i} launched {per}, not {per_step}")
    grad_max = {k: float(v) for k, v in grad_max.items()}
    for k, v in grad_max.items():
        check(np.isfinite(v), f"a gradient of {k} is not finite")
        # at active SH degree 0 (the first 1000 iterations) nothing reads the
        # higher SH bands: their gradient is exactly zero, as in the JAX package
        if k == "features_rest" and int(model.aux.active_sh_degree) == 0:
            check(v == 0.0, f"features_rest has gradient {v} at SH degree 0")
        else:
            check(v > 0.0, f"{k} got no gradient in {n_plain} steps")
    n_span = max(n_plain - 1, 1)
    extra = {}
    if satcull:
        extra = satcull_report(model, steps)
    if uncertainty:
        bn = model._uncertainty.bn_state
        moved = {k: float((bn[k] - bn0[k]).abs().max()) for k in bn}
        check(all(v > 0 for v in moved.values()) and all(bool(torch.isfinite(v).all())
                                                          for v in bn.values()),
              f"{path}: the batch-norm statistics did not move or are not finite: {moved}")
        # over the warm-up (uncertainty_warmup_iters) a pixel that the model
        # down-weights gets 1 - iteration / warm-up, not 0
        extra = {"loss_mult_share_zero": [float((lm == 0).float().mean()) for lm in loss_mults],
                 "loss_mult_share_below_1": [float((lm < 1).float().mean()) for lm in loss_mults],
                 "bn_state_max_moved": moved, "uncertainty_dropout": model.config.uncertainty_dropout}
        check(len(loss_mults) == n_steps, f"{path}: {len(loss_mults)} loss_mult maps")
    emit({"phase": path, "binning": binning, "backend": model.config.rasterizer_backend,
          "points": int(len(xyz)),
          "capacity": int(model.params["xyz"].shape[0]), "size": [FULL_W, FULL_H],
          "setup_s": setup_s, "steps": steps, "warmup_ms": steps[0]["ms"],
          "steady_mean_ms": float(np.mean([st["ms"] for st in steps[1:max(n_plain, 2)]])),
          "launches_per_step": per_step, "peak_mem_gib_after_warmup": peak_gib,
          "grad_max_abs": grad_max,
          **({"engine_sizes": engine_sizes(model)._asdict()} if stages_of else {}),
          "stage_device_ms": {name: ms / n_span for name, (ms, _c) in stages.items()},
          "stage_spans_per_step": {name: c / n_span for name, (_ms, c) in stages.items()},
          **extra, **window})
    return launches, timings


def satcull_report(model, steps):
    """What the saturation cull did over a training path's steps: each
    step's binned entries (read here, after the steps) against its camera's
    first visit, which runs under a +inf map; each camera's share of finite
    supertiles in its map; and, for the camera whose map is the most
    finite, renders (as its step renders it, from the parameters after the
    steps) without a map, with the map its last visit left (a revisit) and
    with a map pooled from the unculled render itself, each against the
    unculled image: measured under the trainer's config, and held (fatal,
    TOL_CULL) for the render's own map with a big-Gaussian pool of every
    Gaussian. Under the trainer's pool (`pallas_big_fraction`), which the
    sky's footprints overflow, the cull also changes which Gaussians get
    the pool's deep slots: a culled cell lowers its Gaussian's visible
    count, frees a slot, and a Gaussian that was cut to its cheap slots
    gets its cells back, so the images differ by more than the cull
    itself."""
    from wildgaussians_torch.device import full_f32
    from wildgaussians_torch.models import gaussian_store as gs
    from wildgaussians_torch.models.renderer import render_internal
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    from wildgaussians_torch.ops.sort_engine import pool_sat_depth
    first = {}
    for st in steps:
        st["binned_entries"] = int(st["binned_entries"])
        c = st["camera"]
        if c in first:
            st["binned_vs_first_visit"] = st["binned_entries"] / max(first[c], 1)
        else:
            first[c] = st["binned_entries"]
    n_cams = len(model.train_cameras)
    check(all(sum(st["camera"] == c for st in steps) >= 2 for c in range(n_cams)),
          "train_satcull: a camera was not visited twice")
    check(len(model._sat_caches) == 1, f"train_satcull: {len(model._sat_caches)} canvases")
    (pw, ph), cache = next(iter(model._sat_caches.items()))
    finite = torch.isfinite(cache).float().mean(dim=(1, 2)).tolist()
    c = int(np.argmax(finite))
    aw, ah = model._sizes[c]
    config = model.config

    def render(gaussians, sat):
        return render_internal(
            gaussians, model.params, model.mlp, model.aux.active_sh_degree, model.aux.alive,
            config, model._poses_dev[c], model._intr_dev[c], pw, ph,
            embedding=model.params["appearance_embeddings"][c],
            kernel_size=config.kernel_size, actual_size=(aw, ah), sat_super=sat)

    def against(pkg, full):
        d = (pkg.render - full.render).abs()
        return {"max_abs_diff": float(d.max()), "pixels_over_1e-3": int((d.amax(-1) > 1e-3).sum()),
                "visible_cells": [int(pkg.blend["vis_count"].sum()),
                                  int(full.blend["vis_count"].sum())],
                "binned_entries": [int(pkg.blend["tile_counts"].sum()),
                                   int(full.blend["tile_counts"].sum())],
                "overflow": [int(pkg.overflow), int(full.overflow)]}

    out = {}
    big_fraction = config.pallas_big_fraction
    with torch.no_grad(), full_f32():
        gaussians = gs.get_gaussians(model.params, model.aux)
        for pool, fraction in (("trainer_pool", big_fraction), ("full_pool", 1.0)):
            config.pallas_big_fraction = fraction
            try:
                full = render(gaussians, None)
                own = pool_sat_depth(full.sat_depth, make_grid(pw, ph, 16),
                                     margin=config.saturation_margin)
                out[pool] = {"big_fraction": fraction,
                             "own_map": against(render(gaussians, own), full),
                             "own_map_finite_share": float(torch.isfinite(own).float().mean())}
                if pool == "trainer_pool":
                    out[pool]["revisit"] = against(render(gaussians, cache[c]), full)
            finally:
                config.pallas_big_fraction = big_fraction
            del full
        del gaussians
    revisits = [st["binned_vs_first_visit"] for st in steps if "binned_vs_first_visit" in st]
    report = {"satcull": {"finite_supertile_share": finite, "map_shape": list(cache.shape[1:]),
                          "revisit_binned_vs_first_visit": revisits, "camera": c,
                          # the same parameters binned with and without a map
                          "cull_fired": out["trainer_pool"]["own_map"]["visible_cells"][0]
                          < out["trainer_pool"]["own_map"]["visible_cells"][1],
                          **out, "margin": config.saturation_margin}}
    check(out["full_pool"]["own_map"]["max_abs_diff"] <= TOL_CULL,
          f"train_satcull: camera {c}'s own map changes its image: {report}")
    return report


def trajectory(n_frames):
    """A viewer trajectory of n_frames through the four serving poses (yaw
    and translation interpolated linearly, segment by segment) at full
    width, whose appearance blends training embeddings 1 and 5 from the
    first frame to the last."""
    frames = []
    f = FULL_W / 1.4
    for i in range(n_frames):
        u = i / (n_frames - 1)
        x = u * (len(POSE_PARAMS) - 1)
        seg = min(int(x), len(POSE_PARAMS) - 2)
        a = x - seg
        (y0, t0), (y1, t1) = POSE_PARAMS[seg], POSE_PARAMS[seg + 1]
        pose = pose_of((1 - a) * y0 + a * y1, (1 - a) * np.array(t0) + a * np.array(t1))
        frames.append({"pose": pose.astype(np.float32),
                       "intrinsics": np.array([f, f, FULL_W / 2, FULL_H / 2], np.float32),
                       "appearance_weights": np.array([1.0 - u, u], np.float32)})
    return {"camera_model": "pinhole", "image_size": (FULL_W, FULL_H), "frames": frames,
            "fps": 30.0, "appearances": [{"embedding_train_index": 1},
                                         {"embedding_train_index": 5}]}


def phase_trajectory(model, tmp, errs):
    """Trajectory rendering: TRAJECTORY_FRAMES frames between the serving
    poses with blended appearance (`trajectory_get_cameras`,
    `trajectory_get_embeddings`), written by `render_frames` to a .tar.gz;
    frames per second and the spans of the render and the PNG encoding;
    then each archived frame against the model's render of its camera and
    embedding (TOL_FRAME), and K1 held on the first frame's arguments.
    Returns each kernel's launches over the frames."""
    import tarfile
    from wildgaussians_torch import evaluation
    from wildgaussians_torch.spans import SpanTimer
    from wildgaussians_torch.utils import image_to_srgb, read_image
    traj = trajectory(TRAJECTORY_FRAMES)
    cams = evaluation.trajectory_get_cameras(traj)
    embs = evaluation.trajectory_get_embeddings(model, traj)
    check(len(cams) == len(embs) == TRAJECTORY_FRAMES, "the trajectory's cameras and embeddings")
    check(np.array_equal(embs[0], model.get_train_embedding(1))
          and np.allclose(embs[-1], model.get_train_embedding(5)), "the trajectory's embeddings")
    ks = [k for k in kernels() if "trajectory" in k["paths"]]
    out = os.path.join(tmp, "trajectory.tar.gz")
    reset_counts(ks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SpanTimer() as timer:
        evaluation.render_frames(model, cams, out, fps=traj["fps"], embeddings=embs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts(ks)
    check(launches == {k["name"]: TRAJECTORY_FRAMES for k in ks},
          f"trajectory: launches {launches} for {TRAJECTORY_FRAMES} frames")
    spans = timer.ms()
    worst, captured = 0.0, {}
    with tarfile.open(out, "r:gz") as tar:
        names = sorted(tar.getnames())
        check(names == [f"{i:05d}.png" for i in range(TRAJECTORY_FRAMES)],
              f"trajectory archive holds {names[:3]}...")
        for i in range(TRAJECTORY_FRAMES):
            got = read_image(tar.extractfile(names[i])).astype(np.float32) / 255.0
            with blend_calls(captured, first=True) if i == 0 else contextlib.nullcontext():
                color = model.render(cams[i:i + 1], options={"embedding": embs[i]})["color"]
            want = image_to_srgb(color, np.uint8, color_space="srgb",
                                 allow_alpha=True).astype(np.float32) / 255.0
            check(got.shape == (FULL_H, FULL_W, 3), f"trajectory frame {i}: {got.shape}")
            worst = max(worst, float(np.abs(got - want).max()))
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), captured["blend_fwd"],
                                          f"trajectory frame 0 at {FULL_W}x{FULL_H}"))
    emit({"phase": "trajectory", "frames": TRAJECTORY_FRAMES, "size": [FULL_W, FULL_H],
          "seconds": seconds, "frames_per_s": TRAJECTORY_FRAMES / seconds,
          "archive_mib": os.path.getsize(out) / 2 ** 20,
          "span_ms": {name: ms for name, (ms, _c) in spans.items()},
          "max_abs_diff_vs_render": worst, "launches": launches})
    check(worst <= TOL_FRAME, f"a trajectory frame differs from its render by {worst}")
    return launches


def reference_state(ckpt):
    """The checkpoint's live Gaussians as the reference's state dict
    (`GaussianModel.state_dict()`'s keys, torch Linear weights [out, in]),
    as tests/test_reference_import.py fabricates one."""
    flat = dict(np.load(next(os.path.join(ckpt, x) for x in os.listdir(ckpt)
                             if x.startswith("chkpnt-") and x.endswith(".npz"))))
    alive = flat["aux/alive"]

    def t(key, live=True):
        x = flat[key][alive] if live else flat[key]
        return torch.from_numpy(np.ascontiguousarray(x))
    n = int(alive.sum())
    state = {name: t(f"params/{name}") for name in (
        "xyz", "features_dc", "features_rest", "scales", "rotations", "opacities", "embeddings")}
    state["appearance_embeddings"] = t("params/appearance_embeddings", live=False)
    for i, mi in enumerate((0, 2, 4)):
        state[f"appearance_mlp.mlp.{mi}.weight"] = t(f"params/appearance_mlp/w{i}", False).T
        state[f"appearance_mlp.mlp.{mi}.bias"] = t(f"params/appearance_mlp/b{i}", False)
    state["filter_3D"] = t("aux/filter_3D")
    state["max_radii2D"] = torch.zeros(n)
    for name in ("denom", "xyz_grad", "xyz_gradient_accum_abs", "xyz_gradient_accum_abs_max"):
        state[name] = torch.zeros((n, 1))
    state["active_sh_degree"] = torch.tensor(int(flat["aux/active_sh_degree"]), dtype=torch.int32)
    state["spatial_lr_scale"] = torch.tensor(1.0)
    state["optimizer"] = None
    return state


def phase_reference_import(model, ckpt, cams, tmp, errs):
    """The reference checkpoint import at full width: the serving
    checkpoint's parameters written in the reference's layout as
    `chkpnt-<step>.pth` with its config as config.yaml (the sort engine),
    imported by `io.reference_import`, loaded through WildGaussians and
    asked for pose 0, which must equal `model`'s render bit for bit (the
    import pads the store to a larger capacity, whose dead slots bin no
    entry). The seconds of the write, the import and the load; K1 held on
    the request's arguments. Returns each kernel's launches over the
    request."""
    import yaml
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.io.reference_import import import_reference_checkpoint
    src, dst = os.path.join(tmp, "reference"), os.path.join(tmp, "imported")
    os.makedirs(src)
    t0 = time.perf_counter()
    with open(os.path.join(ckpt, "config.yaml"), encoding="utf8") as f:
        cfg = yaml.safe_load(f)
    cfg["pallas_binning"] = "sort"
    with open(os.path.join(src, "config.yaml"), "w", encoding="utf8") as f:
        yaml.safe_dump(cfg, f)
    state = reference_state(ckpt)
    torch.save(state, os.path.join(src, "chkpnt-30000.pth"))
    n = int(state["xyz"].shape[0])
    del state
    t1 = time.perf_counter()
    import_reference_checkpoint(src, dst)
    t2 = time.perf_counter()
    imported = WildGaussians(checkpoint=dst)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ks = [k for k in kernels() if "reference_import" in k["paths"]]
    reset_counts(ks)
    captured = {}
    with blend_calls(captured):
        got = imported.render(cams[0])
    launches = launch_counts(ks)
    want = model.render(cams[0])
    same = all(np.array_equal(got[k], want[k]) for k in ("color", "accumulation"))
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), captured["blend_fwd"],
                                          f"reference_import pose 0 at {FULL_W}x{FULL_H}"))
    emit({"phase": "reference_import", "gaussians": n,
          "capacity": int(imported.params["xyz"].shape[0]), "loaded_step": imported._loaded_step,
          "pth_write_s": t1 - t0, "import_s": t2 - t1, "load_s": t3 - t2,
          "pth_mib": os.path.getsize(os.path.join(src, "chkpnt-30000.pth")) / 2 ** 20,
          "render_equal": same,
          "max_abs_diff": float(np.abs(got["color"] - want["color"]).max()),
          "launches": launches})
    check(imported._loaded_step == 30000 and same,
          "the imported checkpoint's render differs from the serving render")
    del imported
    torch.cuda.empty_cache()
    return launches


def live_count(ds, config):
    """The training set's points plus the sky points a camera sees: the
    store's live count after set-up."""
    from wildgaussians_torch.models.sky import get_sky_points
    sky, _d = get_sky_points(config.num_sky_gaussians, ds["points3D_xyz"], ds["cameras"])
    return len(ds["points3D_xyz"]) + len(sky)


def phase_densify(serve_model, cams, path, errs):
    """Densify/prune, opacity reset and capacity growth at full width
    ("densify": the sort engine, "partition_densify": the partition engine):
    phase 6's set-up with DENSIFY_OVERRIDES and the capacity of its live
    count rounded up to 256, trained DENSIFY_STEPS steps (iteration 2
    densifies and grows, 3 resets, 4 densifies with size pruning, 5 trains on
    the grown store). Per step: ms, loss, the densify, reset_opacity and
    grow_capacity spans, the densify stats and the capacity before and
    after. Fatal: a loss that is not finite, a densify whose n_alive is not
    the store's live count, no growth at iteration 2, a reset that leaves a
    live `reset_capped_opacity` over 0.01, a step that does not launch each
    kernel of the path as often as the engine's sizes say; K1-K3 (and K5,
    K6) are held against their plain versions on the arguments of the last
    step, on the grown store. Returns each kernel's launches over the steps."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.config import load_config_yaml
    from wildgaussians_torch.models import gaussian_store as gs
    from wildgaussians_torch.models import wildgaussians as trainer
    from wildgaussians_torch.spans import SpanTimer
    binning = "partition" if path == "partition_densify" else "sort"
    ks = [k for k in kernels() if path in k["paths"]]
    ds, _xyz = full_training_set(serve_model, cams)
    n_live = live_count(ds, load_config_yaml(os.path.join(trainer._CONFIG_DIR, "default.yml")))
    capacity0 = (n_live + 255) // 256 * 256
    model = WildGaussians(train_dataset=ds, config_overrides=dict(
        uncertainty_mode="disabled", pallas_binning=binning, initial_capacity=capacity0,
        **DENSIFY_OVERRIDES))
    check(int(model.aux.alive.sum()) == n_live, f"{path}: live count after set-up")
    stats = []
    reset_counts(ks)
    torch.cuda.reset_peak_memory_stats()
    steps, launches, captured, radix = [], {k["name"]: 0 for k in ks}, {}, {}
    for step in range(DENSIFY_STEPS):
        iteration = step + 1
        capacity = int(model.aux.alive.shape[0])
        per_step = launches_per_unit(model, path)
        before = launch_counts(ks)
        last = step == DENSIFY_STEPS - 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SpanTimer() as timer, results_of(gs, "densify_and_prune", stats.append), \
                kernel_calls(captured, radix) if last else contextlib.nullcontext():
            metrics = model.train_iteration(step)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        spans = timer.ms()
        ran = {name: c - before[name] for name, c in launch_counts(ks).items()}
        check(ran == per_step, f"{path} step {step} launched {ran}, not {per_step}")
        for name, c in ran.items():
            launches[name] += c
        row = {"step": step, "iteration": iteration, "ms": ms, "loss": metrics["loss"],
               "psnr": metrics["psnr"], "num_gaussians": metrics["num_gaussians"],
               "capacity_before": capacity, "capacity_after": int(model.aux.alive.shape[0]),
               "span_ms": {name: spans[name][0] for name in ("densify", "reset_opacity",
                                                             "grow_capacity") if name in spans},
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        check(np.isfinite(metrics["loss"]), f"{path}: loss at iteration {iteration}")
        densifies = iteration > 1 and iteration % DENSIFY_OVERRIDES["densification_interval"] == 0
        resets = iteration % DENSIFY_OVERRIDES["opacity_reset_interval"] == 0
        check(("densify" in spans) == densifies and ("reset_opacity" in spans) == resets,
              f"{path}: the schedule at iteration {iteration} ran {sorted(spans)}")
        if densifies:
            st = {k: int(v) for k, v in stats.pop()[3].items()}
            row["densify_stats"] = st
            check(st["n_alive"] == int(model.aux.alive.sum()),
                  f"{path}: n_alive {st['n_alive']} is not the store's live count")
        if iteration == 2:
            check(row["capacity_after"] > capacity, f"{path}: iteration 2 did not grow the store")
        if resets:
            live = model.aux.alive
            capped = float(gs.reset_capped_opacity(model.params, model.aux)[live].max())
            row["after_reset"] = {
                "max_capped_opacity": capped,
                "max_activated_opacity": float(torch.sigmoid(model.params["opacities"].detach())[live]
                                               .max())}
            check(capped <= 0.01 * (1 + 1e-5), f"{path}: an opacity over 0.01 after the reset")
        steps.append(row)
    label = (f"{path} iteration {DENSIFY_STEPS} at {FULL_W}x{FULL_H}, grown store of "
             f"{int(model.aux.alive.shape[0])} slots, {int(model.aux.alive.sum())} live")
    # each row's peak is over the steps so far; the last step's includes the
    # recorder's references to its kernels' arguments
    emit({"phase": path, "binning": binning, "points": n_live, "capacity": capacity0,
          "overrides": DENSIFY_OVERRIDES, "steps": steps,
          "peak_mem_gib_before_recorded_step": steps[-2]["peak_mem_gib"]})
    stages_of = partition_stages(engine_sizes(model)) if binning == "partition" else None
    hold_step(captured, radix, stages_of, label, errs)
    del model, captured, radix
    torch.cuda.empty_cache()
    return launches


def mesh_group():
    """Join a one-rank NCCL group on a free loopback port (the sharded paths
    at world size 1 on this card); raises if it cannot form."""
    import socket
    from wildgaussians_torch.parallel.multihost import global_tile_mesh, init_multihost
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    init_multihost(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, local_rank=0)
    check(torch.distributed.get_backend() == "nccl", "the mesh's group is not NCCL")
    return global_tile_mesh()


def timed_request(model, cam, mesh=None, record=None):
    """(render_pkg of cam, ms on the host clock, device synchronised), under
    the mesh when given, the kernel arguments into `record` (captured,
    radix) when given."""
    from wildgaussians_torch.parallel.mesh import use_mesh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_mesh(mesh), contextlib.ExitStack() as stack:
        if record is not None:
            stack.enter_context(blend_calls(record[0], first=True))
            stack.enter_context(radix_calls(record[1]))
        pkg = model.render_pkg(cam)
    torch.cuda.synchronize()
    return pkg, (time.perf_counter() - t0) * 1e3


def mesh_serve(mesh, model, cams, path, errs):
    """A request of pose 0 under the mesh (the sharded sort engine, or the
    tile-sharded partition path for a partition checkpoint) after a
    warm-up one (NCCL sets its communicator up at the first collective),
    against the same request without it: the image (bit for bit expected,
    fatal over TOL_PIXEL), the two requests' times, send_drops (0 at
    D = 1); K1 (and K5) held on the request's own arguments. Returns its
    launches."""
    ks = [k for k in kernels() if path in k["paths"]]
    timed_request(model, cams[0])
    single, single_ms = timed_request(model, cams[0])
    _pkg, warmup_ms = timed_request(model, cams[0], mesh)
    captured, radix = {}, {}
    reset_counts(ks)
    pkg, ms = timed_request(model, cams[0], mesh, (captured, radix))
    launches = launch_counts(ks)
    diff = float(torch.maximum((pkg.render - single.render).abs().amax(-1),
                               (pkg.accumulation - single.accumulation).abs()).max())
    drops = int(pkg.send_drops)
    emit({"phase": path, "binning": model.config.pallas_binning, "mesh_ranks": mesh.size,
          "card": card_line(), "ms": ms, "single_device_ms": single_ms,
          "warmup_ms": warmup_ms, "max_abs_diff_single_device": diff,
          "bit_equal": bool(torch.equal(pkg.render, single.render)), "send_drops": drops,
          "launches": launches})
    check(diff <= TOL_PIXEL, f"{path}: the image is {diff} off the single-device one")
    check(drops == 0, f"{path}: {drops} send drops at one rank")
    label = f"{path}, pose 0 at {FULL_W}x{FULL_H}"
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), captured["blend_fwd"],
                                          label))
    for name, err in check_radix({k: v for k, v in radix.items() if k == "radix_pass"},
                                 label).items():
        errs[name].append(err)
    return launches


def mesh_steps(model, cams, path, mesh, record=None):
    """MESH_STEPS training steps on the cameras step_camera_id picks, under
    the mesh when given; per step (ms, loss, spans, send_drops, capacity),
    the last step's kernel arguments into `record` (captured, radix) and
    each kernel's launches per step checked (launches_per_unit)."""
    from wildgaussians_torch.parallel.mesh import use_mesh
    from wildgaussians_torch.parallel.multihost import step_camera_id
    from wildgaussians_torch.spans import SpanTimer
    ks = [k for k in kernels() if path in k["paths"]]
    rows, launches = [], {k["name"]: 0 for k in ks}
    for step in range(MESH_STEPS):
        last = record is not None and step == MESH_STEPS - 1
        per_step = launches_per_unit(model, path)
        before = launch_counts(ks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SpanTimer() as timer, use_mesh(mesh), \
                kernel_calls(*record) if last else contextlib.nullcontext():
            metrics = model.train_iteration(step, camera_id=step_camera_id(step, len(cams)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ran = {name: c - before[name] for name, c in launch_counts(ks).items()}
        if mesh is not None:
            check(ran == per_step, f"{path} step {step} launched {ran}, not {per_step}")
            for name, c in ran.items():
                launches[name] += c
        rows.append({"step": step, "ms": ms, "loss": metrics["loss"], "psnr": metrics["psnr"],
                     "send_drops": metrics["send_drops"], "overflow": metrics["overflow"],
                     "capacity": int(model.aux.alive.shape[0]),
                     "span_ms": {k: v[0] for k, v in timer.ms().items()}})
        check(np.isfinite(metrics["loss"]), f"{path}: loss at step {step}")
    return rows, launches


def mesh_train(mesh, serve_model, cams, path, errs):
    """MESH_STEPS training steps with `shard_gaussian_store` under the mesh
    (the sort engine's sharded path, or the partition engine's tile-sharded
    one), from phase 6's set-up with MESH_OVERRIDES, against the same steps
    on one device without the mesh from the same set-up: per-step losses
    (fatal beyond TOL_METRIC, relative), send_drops (0, fatal), each step's
    time and spans beside the single device's; K1-K3 (and K5, K6) held on
    the last mesh step's arguments. Returns the mesh steps' launches."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.config import load_config_yaml
    from wildgaussians_torch.models import wildgaussians as trainer
    binning = "partition" if "partition" in path else "sort"
    ds, _xyz = full_training_set(serve_model, cams)
    n_live = live_count(ds, load_config_yaml(os.path.join(trainer._CONFIG_DIR, "default.yml")))
    overrides = dict(MESH_OVERRIDES, pallas_binning=binning,
                     initial_capacity=(n_live + 255) // 256 * 256)
    single = WildGaussians(train_dataset=ds, config_overrides=overrides)
    single_rows, _l = mesh_steps(single, cams, path, None, ({}, {}))
    del single
    torch.cuda.empty_cache()
    model = WildGaussians(train_dataset=ds, config_overrides=overrides)
    captured, radix = {}, {}
    torch.cuda.reset_peak_memory_stats()
    rows, launches = mesh_steps(model, cams, path, mesh, (captured, radix))
    rel = [abs(a["loss"] - b["loss"]) / max(abs(b["loss"]), 1e-12)
           for a, b in zip(rows, single_rows)]
    plain = (3, 4)      # iterations 4 and 5: plain steps on the grown store
    emit({"phase": path, "binning": binning, "mesh_ranks": mesh.size, "card": card_line(),
          "overrides": overrides, "steps": rows, "single_device_steps": single_rows,
          "loss_rel_diff": rel, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "slots_per_rank": int(model.aux.alive.shape[0]),
          "plain_step_ms": float(np.mean([rows[i]["ms"] for i in plain])),
          "single_device_plain_step_ms": float(np.mean([single_rows[i]["ms"] for i in plain])),
          "plain_step_span_ms": {k: float(np.mean([rows[i]["span_ms"].get(k, 0.0)
                                                   for i in plain]))
                                 for k in rows[plain[0]]["span_ms"]},
          "single_device_plain_step_span_ms": {
              k: float(np.mean([single_rows[i]["span_ms"].get(k, 0.0) for i in plain]))
              for k in single_rows[plain[0]]["span_ms"]}})
    check(max(rel) <= TOL_METRIC, f"{path}: the losses are {rel} off the single device's")
    check(all(r["send_drops"] == 0 for r in rows), f"{path}: send drops at one rank")
    check(rows[2]["capacity"] > rows[1]["capacity"], f"{path}: iteration 3 did not grow the store")
    label = (f"{path} step {MESH_STEPS} at {FULL_W}x{FULL_H}, sharded store of "
             f"{int(model.aux.alive.shape[0])} slots")
    stages_of = partition_stages(engine_sizes(model)) if binning == "partition" else None
    hold_step(captured, radix, stages_of, label, errs)
    del model, captured, radix
    torch.cuda.empty_cache()
    return launches


def phase_mesh(serve_model, ckpt, cams, errs):
    """The multi-GPU paths at world size 1: a one-rank NCCL group on the
    card (fatal if it cannot form: nothing falls back to the single-device
    path), a request under the sharded sort engine and under the
    tile-sharded partition path ("mesh_serve", "mesh_partition_serve"), and
    MESH_STEPS training steps with the sharded store under each
    ("mesh_train", "mesh_partition_train"). Returns each path's launches."""
    from wildgaussians_torch import WildGaussians
    mesh = mesh_group()
    launches = {}
    try:
        for path, binning in (("mesh_serve", "sort"), ("mesh_partition_serve", "partition")):
            # a model of its own: under the mesh its store shards (the
            # config's shard_gaussian_store), and a sharded store serves
            # only under that mesh
            model = WildGaussians(checkpoint=set_binning(ckpt, binning))
            launches[path] = mesh_serve(mesh, model, cams, path, errs)
            del model
            torch.cuda.empty_cache()
        set_binning(ckpt, "sort")
        for path in ("mesh_train", "mesh_partition_train"):
            launches[path] = mesh_train(mesh, serve_model, cams, path, errs)
    finally:
        torch.distributed.destroy_process_group()
    return launches


def cli_poses(n):
    """n camera-to-world poses on a loop around the surfel scene's identity
    camera (the serving poses' range of yaw and offsets)."""
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        yaw = 0.07 * np.sin(a)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t = np.array([0.45 * np.cos(a), 0.12 * np.sin(2 * a), 0.6 * np.sin(a)])
        out.append(np.concatenate([R, t[:, None]], axis=1))
    return out


def write_cli_scene(root, serve_model, kind):
    """A scene on disk for the training CLI: the surfel scene's FULL_N points
    with their colors, and CLI_IMAGES 8-bit PNGs, each the serving model's
    render from one of cli_poses. "cli": a COLMAP scene (sparse/0, all
    1280x720; the every-8th split gives 14 train, 2 test images).
    "cli_nerfw": a Photo Tourism capture (phototourism/brandenburg-gate,
    sparse/, images in CLI_NERFW_SIZES in turn, and a nerfw_split.csv with
    CLI_NERFW_TEST as the test images). Returns (scene dir, points3D.bin
    write seconds)."""
    from wildgaussians_torch.datasets.colmap_utils import (Camera, Image, rotmat2qvec,
                                                           write_cameras_binary,
                                                           write_images_binary,
                                                           write_points3D_arrays_binary)
    from wildgaussians_torch.utils import convert_image_dtype, save_image
    if kind == "cli":
        scene, sparse, sizes = root / "colmap", root / "colmap" / "sparse" / "0", [(FULL_W, FULL_H)]
    else:
        scene = root / "phototourism" / "brandenburg-gate"
        sparse, sizes = scene / "sparse", list(CLI_NERFW_SIZES)
    sparse.mkdir(parents=True)
    (scene / "images").mkdir()
    f = FULL_W / 1.4
    cameras = {i + 1: Camera(i + 1, "PINHOLE", w, h, np.array([f, f, w / 2, h / 2]))
               for i, (w, h) in enumerate(sizes)}
    images, names = {}, []
    for i, pose in enumerate(cli_poses(CLI_IMAGES)):
        cam_id = i % len(sizes) + 1
        w, h = sizes[cam_id - 1]
        color = serve_model.render(camera(pose, w, h, f))["color"]
        name = f"{i:03d}.png"
        save_image(scene / "images" / name, convert_image_dtype(color, np.uint8))
        w2c = np.linalg.inv(np.concatenate([pose, [[0, 0, 0, 1]]], axis=0))
        images[i + 1] = Image(i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], cam_id, name,
                              np.zeros((0, 2)), np.zeros((0,), np.int64))
        names.append(name)
    write_cameras_binary(cameras, sparse / "cameras.bin")
    write_images_binary(images, sparse / "images.bin")
    xyz, colors = surfel_points(FULL_N, FULL_W, FULL_H)
    t0 = time.perf_counter()
    write_points3D_arrays_binary(xyz.astype(np.float64),
                                 np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8),
                                 sparse / "points3D.bin")
    write_s = time.perf_counter() - t0
    if kind == "cli_nerfw":
        rows = ["filename\tid\tsplit\tdataset"] + [
            f"{n}\t{i}\t{'test' if i in CLI_NERFW_TEST else 'train'}\tbrandenburg"
            for i, n in enumerate(names)]
        (scene / "nerfw_split.csv").write_text("\n".join(rows) + "\n")
    return scene, write_s


def cli_events(out):
    """(train/psnr by step, every record) of the CLI's JSONL log."""
    with open(out / "logs" / "events.jsonl", encoding="utf8") as fh:
        records = [json.loads(line) for line in fh]
    psnr = {r["step"]: r["value"] for r in records if r.get("tag") == "train/psnr"}
    return psnr, records


def ply_vertices(path):
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"element vertex"):
                return int(line.split()[-1])
            if line.strip() == b"end_header":
                break
    raise RuntimeError(f"no vertex count in {path}")


def archive_png(archive, member):
    """An 8-bit PNG from a predictions archive, as an array."""
    import tarfile
    from wildgaussians_torch.utils import read_image
    with tarfile.open(archive, "r:gz") as tf:
        return read_image(tf.extractfile(member))


def check_cli_outputs(kind, scene, out, fits):
    """The CLI run's outputs (see phase_cli); `fits` are the run's embedding
    fits, in order. Returns what they show."""
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.datasets.colmap import load_colmap_dataset
    from wildgaussians_torch.datasets.phototourism import load_phototourism_dataset
    from wildgaussians_torch.evaluation import compute_metrics
    from wildgaussians_torch.utils import image_to_srgb
    step = CLI_ITERS
    psnr, records = cli_events(out)
    windows = sorted(psnr)
    check(windows == list(range(100, step + 1, 100)), f"{kind}: train/psnr windows {windows}")
    check(psnr[windows[-1]] > psnr[windows[0]],
          f"{kind}: train/psnr did not rise: {[psnr[w] for w in windows]}")
    with open(out / f"results-{step}.json", encoding="utf8") as fh:
        results = json.load(fh)
    metrics = results["metrics"]
    check(all(np.isfinite(metrics[k]) for k in ("psnr", "ssim", "mae", "mse")),
          f"{kind}: results {metrics}")
    ckpt = out / f"checkpoint-{step}"
    for name in (f"chkpnt-{step}.npz", "point_cloud.ply", "config.yaml", "nb-info.json"):
        check((ckpt / name).is_file(), f"{kind}: {ckpt / name} is missing")
    with np.load(ckpt / f"chkpnt-{step}.npz") as npz:
        live = int(npz["aux/alive"].sum())
    vertices = ply_vertices(ckpt / "point_cloud.ply")
    check(vertices == live, f"{kind}: the ply holds {vertices} vertices, the store {live} live")
    from wildgaussians_torch.config import config_from_yaml_str
    config = config_from_yaml_str((ckpt / "config.yaml").read_text(encoding="utf8"))

    # the reloaded checkpoint renders test camera 0 as the CLI archived it
    if kind == "cli":
        test = load_colmap_dataset(scene, split="test")
    else:
        test = load_phototourism_dataset(scene, split="test")
    name = os.path.relpath(test["image_paths"][0], test["image_paths_root"])
    archive = out / f"predictions-{step}.tar.gz"
    archived = archive_png(archive, f"color/{os.path.splitext(name)[0]}.png")
    # its embedding under NeRF-W: the last fit of its left half (eval-all's)
    test_embedding = next((f["embedding"] for f in reversed(fits) if f["image"] == name), None)
    check((test_embedding is not None) == (kind == "cli_nerfw"),
          f"{kind}: the fitted embedding of test image {name}")
    model = WildGaussians(checkpoint=str(ckpt))
    opts = {"embedding": test_embedding} if test_embedding is not None else None
    again = image_to_srgb(model.render(test["cameras"][0], options=opts)["color"], np.uint8)
    del model
    diff = np.abs(again.astype(np.int32) - archived.astype(np.int32)).max(-1)
    within = float((diff <= 1).mean())
    check(again.shape == archived.shape and within >= 1.0 - TOL_RELOAD_FRAC,
          f"{kind}: the reloaded checkpoint's render of {name} differs from the archived PNG "
          f"({within} of pixels within 1/255)")
    shown = {"train_psnr_windows": {str(w): psnr[w] for w in windows}, "results": metrics,
             "tile_budget_after": {"max_tiles_per_gaussian": config.max_tiles_per_gaussian,
                                   "pallas_big_fraction": config.pallas_big_fraction},
             "results_protocol": results["evaluation_protocol"], "ply_vertices": vertices,
             "reload_test0": {"image": name, "share_within_1_of_255": within,
                              "max_diff": int(diff.max())},
             "event_records": len(records)}
    if kind == "cli_nerfw":
        # the NeRF-W metrics: each test image's right half
        psnrs = []
        for path in test["image_paths"]:
            stem = os.path.splitext(os.path.relpath(path, test["image_paths_root"]))[0]
            gt, pred = (archive_png(archive, f"{d}/{stem}.png") for d in ("gt-color", "color"))
            w = gt.shape[1]
            psnrs.append(compute_metrics(pred[:, w // 2:], gt[:, w // 2:])["psnr"])
        shown["right_half_psnr"] = psnrs
        check(abs(float(np.mean(psnrs)) - metrics["psnr"]) <= 1e-4,
              f"{kind}: results psnr {metrics['psnr']} is not the right halves' {psnrs}")
        check(results["evaluation_protocol"] == "nerfw", f"{kind}: protocol")
    return shown


def phase_cli(serve_model, kind, errs):
    """The training CLI in process (`wildgaussians_torch.train.main`) at full
    width: "cli" trains configs/default.yml on a COLMAP scene and scores it
    under the default protocol; "cli_nerfw" trains configs/phototourism.yml
    on a Photo Tourism capture (four image sizes) and scores it under the
    NeRF-W protocol, which fits an appearance embedding to each scored
    image's left half (CLI_NERFW_FIT_ITERS Adam iterations of a one-pass
    render and its backward; under "-scaled", with the uncertainty model's
    mask). Both with the shipped configs' uncertainty model, CLI_ITERS
    iterations and the JSONL (and, where installed, the tensorboard)
    logger. Fatal: a non-zero exit, train/psnr not rising between its two
    windows, a non-finite result, a missing checkpoint file, a ply whose
    vertex count is not the live count, a reloaded checkpoint whose render
    of test image 0 differs from the archived PNG by more than 1/255 on
    more than 0.1 % of the pixels, and (NeRF-W) results that are not the
    right halves' metrics. K1-K3 are held against their plain versions on the arguments
    of the first training step, of the first embedding iteration
    ("cli_nerfw") and of the first evaluation render ("cli": K1), after
    the run (those launches are not counted). Returns each kernel's
    launches over the run."""
    import importlib.util
    from pathlib import Path
    from wildgaussians_torch import train as ttrain
    from wildgaussians_torch.models.uncertainty import UncertaintyModel
    from wildgaussians_torch.models.wildgaussians import WildGaussians
    from wildgaussians_torch.spans import SpanTimer
    ks = [k for k in kernels() if kind in k["paths"]]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"wg_{kind}_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        scene, points_write_s = write_cli_scene(root, serve_model, kind)
        write_s = time.perf_counter() - t0
        out = root / "out"
        logger = "both" if importlib.util.find_spec("tensorboard") else "jsonl"
        argv = ["--data", str(scene), "--output", str(out), "--set", f"iterations={CLI_ITERS}",
                "--eval-few-iters", CLI_EVAL_FEW[kind], "--logger", logger]
        if kind == "cli_nerfw":
            argv += ["--dataset-type", "phototourism", "--set",
                     f"appearance_embedding_optim_iters={CLI_NERFW_FIT_ITERS}"]
        step_ms, captured, fits = [], {"train": {}, "embed": {}, "eval": {}}, []

        def train_iteration(self, step, camera_id=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with blend_calls(captured["train"], first=True) if step == 0 \
                    else contextlib.nullcontext():
                metrics = orig_train_iteration(self, step, camera_id)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return metrics
        orig_train_iteration = WildGaussians.train_iteration

        def optimize_embedding(self, dataset, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with blend_calls(captured["embed"], first=True):
                out_ = orig_optimize(self, dataset, **kwargs)
            fits.append({"image": os.path.relpath(dataset["image_paths"][0],
                                                  dataset["image_paths_root"]),
                         "size": [int(x) for x in dataset["cameras"].image_sizes[0]],
                         "s": time.perf_counter() - t0,
                         "iterations": len(out_["metrics"]["loss"]),
                         "psnr_first_last": [out_["metrics"]["psnr"][0],
                                             out_["metrics"]["psnr"][-1]],
                         "embedding": out_["embedding"]})
            return out_
        orig_optimize = WildGaussians.optimize_embedding

        def render(self, camera_, **kwargs):
            with blend_calls(captured["eval"], first=True) if not captured["eval"] \
                    else contextlib.nullcontext():
                return orig_render(self, camera_, **kwargs)
        orig_render = WildGaussians.render

        # the share of canvas pixels the "-scaled" fits keep (loss_mult > 1)
        fit_mask_share = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(results_of(
                UncertaintyModel, "loss_mult_for_image",
                lambda lm: fit_mask_share.append(float((lm > 1).float().mean()))))
            stack.enter_context(replaced(WildGaussians, "train_iteration", train_iteration))
            stack.enter_context(replaced(WildGaussians, "optimize_embedding", optimize_embedding))
            stack.enter_context(replaced(WildGaussians, "render", render))
            timer = stack.enter_context(SpanTimer())
            reset_counts(ks)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc = ttrain.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = launch_counts(ks)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        spans = {k: (ms / 1e3, n) for k, (ms, n) in timer.ms().items()}
        del timer
        check(rc == 0, f"{kind}: the CLI exited with {rc}")
        shown = check_cli_outputs(kind, scene, out, fits)
    # the holds, after the counted run
    for unit, what in (("train", "the first training step"),
                       ("embed", "the first embedding iteration"),
                       ("eval", "the first evaluation render")):
        if captured[unit]:
            label = f"{kind}, {what}, {captured[unit]['blend_fwd'][4]} passes"
            hold_raster(captured[unit], {}, label, errs)
    check(bool(captured["train"]) and bool(captured["embed"] if kind == "cli_nerfw"
                                           else captured["eval"]), f"{kind}: recorded calls")
    del captured
    torch.cuda.empty_cache()
    # seconds by span: (sum, count); a span is the device timeline from its
    # start to its end, the host's time where it does host work alone
    n_images = spans.get("eval_render", (0.0, 0))[1]
    per_image = {k: spans.get(k, (0.0, 0))[0] / max(n_images, 1)
                 for k in ("eval_render", "embedding_fit", "png_encode", "eval_metrics")}
    fit_s = sum(f["s"] for f in fits)
    iters = sum(f["iterations"] for f in fits)
    emit({"phase": kind, "argv": argv, "size": [FULL_W, FULL_H], "points": FULL_N,
          "images": CLI_IMAGES, "scene_write_s": write_s, "points3D_write_s": points_write_s,
          "cli_s": run_s, "phase_s": time.perf_counter() - t_phase,
          **{f"{k}_s": spans.get(k, (0.0, 0))[0] for k in
             ("dataset_load", "points3D_parse", "image_decode", "setup")},
          "points3D_parses": spans.get("points3D_parse", (0.0, 0))[1],
          "steps": len(step_ms), "warmup_step_ms": step_ms[0],
          "steady_step_ms": float(np.mean(step_ms[1:])),
          "step_ms_1_to_9": float(np.mean(step_ms[1:10])),
          "step_ms_20_on": float(np.mean(step_ms[20:])),
          # eval_render is the protocol's render: under NeRF-W it holds the
          # embedding fit (embedding_fit) of the image's left half
          "eval_all_images": n_images, "eval_all_s_per_image": per_image,
          "optimize_embedding": {"fits": len(fits), "s": fit_s,
                                 "s_per_image": fit_s / max(len(fits), 1),
                                 "iterations": iters,
                                 "ms_per_iteration": fit_s * 1e3 / max(iters, 1),
                                 "each": [{k: v for k, v in f.items() if k != "embedding"}
                                          for f in fits]},
          # the uncertainty model's spans: (s, count)
          "uncertainty_spans_s": {k: spans[k] for k in ("dino_gt", "dino_pred", "uncertainty_head",
                                                        "uncertainty_loss") if k in spans},
          "scaled_fit_mask_share_over_1": fit_mask_share,
          "peak_mem_gib": peak_gib, "launches": launches, **shown})
    return launches


def hold_knn(points, label):
    """The k-NN init statistic (`ops/knn.py`, the JAX trainer's default
    native k-NN's function) on the card against the same call on the CPU, on
    the points the training set-up passed it: within TOL_KNN."""
    from wildgaussians_torch.ops.knn import mean_knn_dist2
    t0 = time.perf_counter()
    card = mean_knn_dist2(points).cpu()
    t1 = time.perf_counter()
    cpu = mean_knn_dist2(points.cpu())
    over = (card - cpu).abs() > TOL_KNN * cpu.abs()
    emit({"check": "mean_knn_dist2, card vs CPU", "at": label, "points": int(points.shape[0]),
          "points_differ": int((card != cpu).sum()), "points_over_rtol": int(over.sum()),
          "max_abs_diff": float((card - cpu).abs().max()), "card_s": t1 - t0,
          "cpu_s": time.perf_counter() - t1})
    check(not bool(over.any()), f"mean_knn_dist2 differs between the card and the CPU at {label}")


def k2_bound_ms(inputs, walked, pairs):
    """Least time for K2's work on these inputs: the walked entries' table
    columns, the cotangent and forward packs read once and the walked
    entries' gradient rows written once over the memory rate, against the
    operations the pairs need over the FP32 rate: the reach test per
    (warp block, entry), K1's evaluated and exp work on the blocks each
    entry reaches, its used work, and the gradient chain per contributing
    pair (`pairs` from blend.blend_pair_counts with WARP_BLOCK). Returns
    (ms, bound_by, ms_all_pairs); ms_all_pairs counts the evaluated and exp
    work on every pixel instead, with no reach test."""
    from wildgaussians_torch.ops import blend
    table, _s, tile_counts, _g, n_passes = inputs[:5]
    pass_abs = len(inputs) > 10 and inputs[10] is not None
    T = int(tile_counts.shape[0])
    w = int(walked.sum())
    bytes_moved = (w * table.shape[0] * 4 + T * 8 + 2 * n_passes * T * 256 * 3 * 4
                   + (2 + (n_passes if pass_abs else 0)) * T * 256 * 4
                   + w * blend.grad_rows(n_passes, pass_abs) * 4)
    rest = (pairs["used"] * OPS_USED
            + pairs["contributing"] * (K2_OPS_CONTRIB + K2_OPS_PER_PASS * n_passes
                                       + (K2_OPS_PASS_ABS * n_passes if pass_abs else 0)))
    return bound_ms(bytes_moved, *walk_ops(pairs, rest))


def k3_bound_ms(sums, big_list, bigs):
    """K3 moves bytes: the pool's indices read once, and each valid (row,
    slot)'s value read once and element of `sums` read and written once (a
    padding slot's value is never read). Returns
    (ms, "bytes", sector_ms): sector_ms moves `sums` in the card's 32-byte
    sectors instead, each distinct sector that a valid slot touches read
    once and written once (neighbouring big slots lie a few elements apart,
    so most adds move a sector of their own each way)."""
    rows, n = sums.shape
    idx = big_list[big_list < n].long()     # sorted: a row's sectors ascend
    valid = int(idx.shape[0])
    head = big_list.shape[0] * 4 + rows * valid * 4
    bytes_moved = head + 2 * rows * valid * 4
    sectors = 0
    if valid:
        addr = (sums.data_ptr() + 4 * (torch.arange(rows, device=idx.device)[:, None]
                                       * sums.stride(0) + idx[None, :])) // 32
        sectors = rows + int((addr[:, 1:] != addr[:, :-1]).sum())
    return (bytes_moved / PEAK_BYTES * 1e3, "bytes",
            (head + 2 * sectors * 32) / PEAK_BYTES * 1e3)


def hold_step(captured, radix, stages, label, errs):
    """K1, K2 and K3 (the gather engine runs no K3), and on the partition
    path K5 and K6, on the arguments a training step passed them (`captured` from blend_calls, `radix` from
    radix_calls): each checked against its plain version; K2 and K3 timed
    beside their plain versions, with their bounds, and K3 also beside
    `index_add_` on its valid slots; K5 and K6 timed per call (time_radix,
    `stages` naming each call's stage)."""
    from wildgaussians_torch.ops import blend
    fwd, k2 = captured["blend_fwd"], captured["blend_bwd"]
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), fwd, label))
    errs["blend_bwd"].append(check_k2(k2, label))
    walked = blend.blend_forward(*fwd)[2]
    pairs = blend.blend_pair_counts(*k2[:4], warp_block=WARP_BLOCK, **band_kw(k2))
    out = {}
    ms = time_cuda_ms(lambda: blend.blend_backward(*k2), iters=10)
    plain_ms = time_cuda_ms(lambda: blend.blend_backward_plain(*k2), iters=1, warmup=1)
    bound, by, bound_all_pairs = k2_bound_ms(k2, walked, pairs)
    out["blend_bwd"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)
    emit({"phase": "timing", "kernel": "blend_bwd", "at": label, "passes": k2[4], "pairs": pairs,
          "binned_entries": int(k2[1][-1]), "walked_entries": int(walked.sum()),
          "bound_ms_all_pairs": bound_all_pairs, **out["blend_bwd"]})
    if "tier2_merge" not in captured:    # the gather engine sums with one scatter
        return out
    sums, big_list, bigs = captured["tier2_merge"]
    errs["tier2_merge"].append(check_k3(sums, big_list, bigs, label))
    scratch = sums.clone()
    ms = time_cuda_ms(lambda: blend.tier2_merge(scratch, big_list, bigs), iters=20)
    plain_ms = time_cuda_ms(lambda: blend.tier2_merge_plain(scratch, big_list, bigs), iters=5)
    valid = big_list < sums.shape[1]
    idx, vals = big_list[valid].long(), bigs[:, valid].contiguous()
    library_ms = time_cuda_ms(lambda: scratch.index_add_(1, idx, vals), iters=20)
    bound, by, bound_sectors = k3_bound_ms(sums, big_list, bigs)
    out["tier2_merge"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                              library_ms=library_ms, bound_ms_sectors=bound_sectors)
    emit({"phase": "timing", "kernel": "tier2_merge", "at": label, "rows": int(sums.shape[0]),
          "n": int(sums.shape[1]), "m_cap": int(big_list.shape[0]), "valid": int(valid.sum()),
          **out["tier2_merge"]})
    if stages is not None:
        check(set(radix) == {"radix_pass", "radix_unpass"}, f"{label} ran {set(radix)}")
        for name, err in check_radix(radix, label).items():
            errs[name].append(err)
        out.update(time_radix(radix, stages, label))
    return out


def radix_bytes(name, args, kwargs):
    """The bytes one K5 or K6 call must move on these arguments: K5 reads
    the table's rows (its key row from `keys`) once and writes the output
    once; K6 reads the key row, the gradient columns of the entries that
    are not holes, and writes its output once. Over the memory rate, the
    call's bound."""
    if name == "radix_pass":
        table, _keys = args[:2]
        rows, R = table.shape
        return rows * R * 4 + rows * kwargs["R_out"] * 4
    gin, keys = args[:2]
    real = int((keys < float(kwargs["sentinel"])).sum())
    return keys.shape[0] * 4 + gin.shape[0] * (real + keys.shape[0]) * 4


def radix_library(name, args, kwargs):
    """One PyTorch call for the same function, on the same arguments: for K5
    a stable sort of the digits and an index_select of the rows (no gaps or
    sentinels); for K6 an index_select by the destinations, computed first
    and outside the call."""
    from wildgaussians_torch.ops import partition
    B = kwargs["B"]
    if name == "radix_pass":
        table, keys, p = args[:3]
        return lambda: table.index_select(
            1, torch.sort(partition.digits(keys, p, B), stable=True).indices)
    gin, keys, p, bases = args[:4]
    dest = partition._destinations(keys, p, bases, B)
    return lambda: gin.index_select(1, dest)


def time_radix(radix, stages, label):
    """K5 and K6 on every call a training step made (`radix`, radix_calls):
    ms per call beside its bound, its plain version and the library call,
    and the TB/s it moved (radix_bytes over its ms); the sums over the
    step."""
    out = {}
    for name in ("radix_pass", "radix_unpass"):
        k = kernel_by_name(name)
        rows = []
        for i, (args, kwargs) in enumerate(radix[name]):
            ms = time_cuda_ms(lambda: k["wrapper"](*args, **kwargs), iters=5)
            moved = radix_bytes(name, args, kwargs)
            rows.append(dict(
                stage=stages[name][i], p=args[2], shape=list(args[0].shape), ms=ms,
                plain_ms=time_cuda_ms(lambda: k["plain"](*args, **kwargs), iters=1, warmup=1),
                library_ms=time_cuda_ms(radix_library(name, args, kwargs), iters=3, warmup=1),
                bound_ms=moved / PEAK_BYTES * 1e3, tb_per_s=moved / (ms * 1e-3) / 1e12))
        sums = {key: float(sum(r[key] for r in rows))
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out[name] = dict(**sums, bound_by="bytes", per="training step",
                         launches_per_step=len(rows))
        emit({"phase": "timing", "kernel": name, "at": label, "per_step": sums, "calls": rows})
    return out


def partition_stages(sizes):
    """The stage of each K5 call of a step, in order, and of each K6 call."""
    k5 = (["presort"] * sizes.L1 + ["rank"] * sizes.L_A + ["tile"] * sizes.L2)
    k6 = (["tile"] * sizes.L2 + ["rank"] * sizes.L_A + ["presort"] * sizes.L1)
    return {"radix_pass": k5, "radix_unpass": k6}


def scene_tensors(kind, n, width, height):
    """bench.py's random (`make_random_scene`) or surfel scene of n
    Gaussians from SEED on the card, the identity camera with focal length
    width / 1.4, and that camera's CameraParams."""
    from wildgaussians_torch.cameras import make_camera_params
    from wildgaussians_torch.scenes import make_random_scene, make_surfel_scene
    make = make_random_scene if kind == "random" else make_surfel_scene
    arrays = make(np.random.default_rng(SEED), n, width, height, width / 1.4)
    dev = torch.device(DEVICE)
    cam = camera(np.eye(4)[:3], width, height, width / 1.4)
    params, _w, _h = make_camera_params(cam, device=dev)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in arrays), params


def reset_counts(ks):
    for k in ks:
        k["wrapper"].launches = 0


def launch_counts(ks):
    return {k["name"]: k["wrapper"].launches for k in ks}


def hold_raster(captured, radix, label, errs):
    """K1, K2 and K3 (and K5, K6 where the partition engine ran) against
    their plain versions on the arguments one rasterize_gaussians call
    passed them (blend_calls / radix_calls)."""
    errs["blend_fwd"].append(check_kernel(kernel_by_name("blend_fwd"), captured["blend_fwd"],
                                          label))
    if "blend_bwd" in captured:
        errs["blend_bwd"].append(check_k2(captured["blend_bwd"], label))
        errs["tier2_merge"].append(check_k3(*captured["tier2_merge"], label))
    for name, err in check_radix(radix, label).items():
        errs[name].append(err)


def phase_raster(errs):
    """The rasterizer API at bench.py's shapes: rasterize_gaussians(backend=
    "pallas") on the random and the surfel scene (1.5M Gaussians, 1280x720,
    d_max 10, d_small 4): RASTER_FWD forward-only calls (the first a
    warm-up), RASTER_BWD forward + backward calls of an L1 loss against a
    seeded target, under the sort engine, and one forward + backward with
    binning="partition"; then a GaussianRasterizer call with SH degree 3
    `shs` on the surfel scene against rasterize_gaussians on the colors it
    precomputes. The kernels are held against their plain versions on the
    first call of each kind (outside the counted calls). Returns each
    kernel's launches over the counted calls."""
    from wildgaussians_torch.ops import raster_api
    from wildgaussians_torch.ops.rasterize import rasterize_gaussians
    from wildgaussians_torch.ops.sh import eval_sh_switch
    ks = [k for k in kernels() if "raster" in k["paths"]]
    launches = {k["name"]: 0 for k in ks}
    knobs = dict(kernel_size=0.1, backend="pallas", max_tiles_per_gaussian=RASTER_D_MAX,
                 d_small=RASTER_D_SMALL, chunk=256)
    for kind in ("random", "surfel"):
        (xyz, scales, rots, opac, colors), cam = scene_tensors(kind, FULL_N, FULL_W, FULL_H)
        g = torch.Generator(device=xyz.device).manual_seed(SEED)
        target = torch.rand((FULL_H, FULL_W, 3), generator=g, device=xyz.device)
        out_rows = {}
        for mode, binning, calls in (("forward", "sort", RASTER_FWD),
                                     ("forward+backward", "sort", RASTER_BWD),
                                     ("forward+backward", "partition", 1)):
            ms, info = [], None
            for i in range(calls):
                captured, radix = {}, {}
                params = [t.clone().requires_grad_(mode != "forward")
                          for t in (xyz, scales, rots, opac, colors)]
                reset_counts(ks)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with kernel_calls(captured, radix) if i == 0 else contextlib.nullcontext(), \
                        torch.set_grad_enabled(mode != "forward"):
                    out = rasterize_gaussians(*params, cam, FULL_W, FULL_H, binning=binning,
                                              **knobs)
                    if mode != "forward":
                        (out.color - target).abs().mean().backward()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                for name, c in launch_counts(ks).items():
                    launches[name] += c
                if i == 0:
                    check(out.color.shape == (FULL_H, FULL_W, 3)
                          and bool(torch.isfinite(out.color).all()), f"{kind} {mode} color")
                    if mode != "forward":
                        check(all(bool(torch.isfinite(p.grad).all()) and float(p.grad.abs().max()) > 0
                                  for p in params), f"{kind} {mode} {binning}: gradients")
                    info = {"num_rendered": int(out.num_rendered), "overflow": int(out.overflow)}
                    label = f"raster {kind} {mode} {binning} at {FULL_W}x{FULL_H}, {FULL_N}"
                    hold_raster(captured, radix, label, errs)
                    del captured, radix
                    torch.cuda.empty_cache()
                del out, params
            out_rows[f"{mode} {binning}"] = {"calls": calls, "ms": ms,
                                              "steady_mean_ms": float(np.mean(ms[1:] or ms)),
                                              **info}
        emit({"phase": "raster", "scene": kind, "gaussians": FULL_N, "size": [FULL_W, FULL_H],
              "d_max": RASTER_D_MAX, "d_small": RASTER_D_SMALL, **out_rows})
    # GaussianRasterizer at SH degree 3 on the surfel scene
    g = torch.Generator(device=xyz.device).manual_seed(SEED)
    shs = torch.randn((FULL_N, 16, 3), generator=g, device=xyz.device) * 0.2
    settings = raster_api.GaussianRasterizationSettings(
        image_height=FULL_H, image_width=FULL_W, tanfovx=float(cam.tan_fov[0]),
        tanfovy=float(cam.tan_fov[1]), kernel_size=0.1, subpixel_offset=None,
        bg=torch.zeros(3, device=xyz.device), scale_modifier=1.0,
        viewmatrix=cam.viewmatrix.T, projmatrix=cam.projmatrix.T, sh_degree=3,
        campos=cam.campos, prefiltered=False, debug=False)
    means2d = torch.zeros((FULL_N, 2), device=xyz.device, requires_grad=True)
    reset_counts(ks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    color, radii, acc = raster_api.GaussianRasterizer(settings)(
        xyz, means2d, opac, shs=shs, scales=scales, rotations=rots, backend="pallas",
        max_tiles_per_gaussian=RASTER_D_MAX, d_small=RASTER_D_SMALL)
    color.mean().backward()
    torch.cuda.synchronize()
    api_ms = (time.perf_counter() - t0) * 1e3
    for name, c in launch_counts(ks).items():
        launches[name] += c
    with torch.no_grad():
        dirs = xyz - cam.campos[None]
        dirs = dirs / torch.clamp_min(torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-12)
        cols = torch.clamp_min(eval_sh_switch(3, 3, shs.transpose(1, 2), dirs) + 0.5, 0.0)
        want = rasterize_gaussians(xyz, scales, rots, opac, cols, cam, FULL_W, FULL_H, **knobs)
    diff = float((color.detach() - want.color.permute(2, 0, 1)).abs().max())
    emit({"phase": "raster", "api": "GaussianRasterizer", "sh_degree": 3, "ms": api_ms,
          "vs_rasterize_gaussians_max_abs_diff": diff,
          "means2d_grad_max_abs": float(means2d.grad.abs().max()),
          "visible": int((radii > 0).sum()), "mean_accumulation": float(acc.mean())})
    check(diff <= TOL_STATIC, f"GaussianRasterizer differs from rasterize_gaussians by {diff}")
    check(float(means2d.grad.abs().max()) > 0, "GaussianRasterizer: no means2D gradient")
    return launches


def phase_static(errs):
    """The static viewer path on the surfel scene (1.5M Gaussians, 1280x720,
    d_max 10, d_small 4) from the 4 poses: bin_static once per pose, then
    STATIC_FRAMES render_static frames, each with bg chained from the
    previous frame's mean (bench.py's static mode). K4 is held on the first
    frame's arguments against its plain version, against K1 on the same
    table (bg 0: bit for bit), and a frame with a background against
    rasterize_gaussians (backend "pallas") of the same pose and background
    within TOL_STATIC. Returns K4's launches over the frames and its
    timing."""
    from wildgaussians_torch.cameras import make_camera_params
    from wildgaussians_torch.ops import blend, static_blend
    from wildgaussians_torch.ops.rasterize import bin_static, rasterize_gaussians, render_static
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    k4 = kernel_by_name("blend_fwd_planar")
    ks = [k for k in kernels() if "static" in k["paths"]]
    (xyz, scales, rots, opac, colors), _cam = scene_tensors("surfel", FULL_N, FULL_W, FULL_H)
    knobs = dict(max_tiles_per_gaussian=RASTER_D_MAX, d_small=RASTER_D_SMALL, chunk=256)
    grid = make_grid(FULL_W, FULL_H, 16)
    launches, timing, per_pose = 0, None, []
    for pose_i, pose in enumerate(poses()):
        cam, _w, _h = make_camera_params(camera(pose, FULL_W, FULL_H, FULL_W / 1.4),
                                         device=xyz.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sb = bin_static(xyz, scales, rots, opac, colors, cam, FULL_W, FULL_H, kernel_size=0.1,
                        **knobs)
        torch.cuda.synchronize()
        bin_ms = (time.perf_counter() - t0) * 1e3
        captured = []
        with calls_of(static_blend, "blend_forward_planar",
                      lambda *a: captured.append(a)):
            color, final_t = render_static(sb, FULL_N, FULL_W, FULL_H, **knobs)   # warm-up
        carry = color.mean()
        reset_counts(ks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STATIC_FRAMES):
            bg = torch.zeros(3, device=xyz.device) + 0.0 * carry
            color, final_t = render_static(sb, FULL_N, FULL_W, FULL_H, bg=bg, **knobs)
            carry = color.mean()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / STATIC_FRAMES
        launches += launch_counts(ks)["blend_fwd_planar"]
        check(color.shape == (FULL_H, FULL_W, 3) and bool(torch.isfinite(color).all()),
              "static frame")
        per_pose.append({"pose": pose_i, "bin_ms": bin_ms, "frame_ms": frame_ms,
                         "fps": 1e3 / frame_ms, "binned_entries": int(sb.tile_starts[-1]),
                         "mean_accumulation": float(1.0 - final_t.mean())})
        if pose_i == 0:
            args = captured[0]
            label = f"static frame, pose 0, {FULL_W}x{FULL_H}, {FULL_N} surfel Gaussians"
            out = k4["wrapper"](*args)
            plain = k4["plain"](*args[:6])     # the tile order does not change the result
            torch.cuda.synchronize()
            err = (out - plain).abs().amax(dim=(0, 1))
            over = int((err > TOL_PIXEL).sum())
            max_err = float(err.max())
            emit({"check": "blend_fwd_planar", "at": label, "max_abs_err": max_err,
                  "pixels_over_1e-4": over, "pixels": err.numel()})
            check(max_err <= TOL_MAX and over <= TOL_FRAC * err.numel(),
                  f"blend_fwd_planar disagrees with its plain version at {label}")
            errs["blend_fwd_planar"].append((max_err, over))
            table, starts, counts = args[:3]
            zero = k4["wrapper"](table, starts, counts, grid, 1,
                                 torch.zeros(3, device=xyz.device))
            kc, kt, walked, _sat = blend.blend_forward(table, starts, counts, grid, 1)
            torch.cuda.synchronize()
            equal_k1 = bool(torch.equal(zero[0, :3], kc[0].permute(2, 0, 1))
                            and torch.equal(zero[0, 3], kt))
            bg_test = torch.tensor([0.2, 0.5, 0.1], device=xyz.device)
            color_bg, final_t_bg = render_static(sb, FULL_N, FULL_W, FULL_H, bg=bg_test, **knobs)
            ref = rasterize_gaussians(xyz, scales, rots, opac, colors, cam, FULL_W, FULL_H,
                                      kernel_size=0.1, backend="pallas", bg=bg_test, **knobs)
            vs_pallas = max(float((color_bg - ref.color).abs().max()),
                            float((final_t_bg - ref.final_T).abs().max()))
            emit({"check": "blend_fwd_planar vs blend_fwd (bg 0)", "at": label,
                  "equal": equal_k1, "static_vs_rasterize_gaussians_max_abs_diff": vs_pallas})
            check(equal_k1, "K4 with bg 0 is not K1 bit for bit")
            check(vs_pallas <= TOL_STATIC, f"static frame differs from rasterize_gaussians by "
                                           f"{vs_pallas}")
            pairs = blend.blend_pair_counts(table, starts, counts, grid, warp_block=WARP_BLOCK)
            # K1's work: the same walk, and the same four output planes
            bound, by, bound_all_pairs = blend_bound_ms(table, counts, walked, 1, pairs)
            timing = dict(ms=time_cuda_ms(lambda: k4["wrapper"](*args), iters=20),
                          plain_ms=time_cuda_ms(lambda: k4["plain"](*args[:6]), iters=3,
                                                warmup=1),
                          bound_ms=bound, bound_by=by, library_ms=None,
                          bound_ms_all_pairs=bound_all_pairs)
            emit({"phase": "timing", "kernel": "blend_fwd_planar", "at": label, "pairs": pairs,
                  "walked_entries": int(walked.sum()), **timing})
            del args, captured, out, plain, zero, ref, color_bg, final_t_bg
            torch.cuda.empty_cache()
    frame_ms_mean = float(np.mean([p["frame_ms"] for p in per_pose]))
    emit({"phase": "static", "gaussians": FULL_N, "size": [FULL_W, FULL_H],
          "frames_per_pose": STATIC_FRAMES, "per_pose": per_pose,
          "frame_ms_mean": frame_ms_mean,
          # every pose renders the same number of frames: all frames over all their time
          "fps": 1e3 / frame_ms_mean})
    return {"blend_fwd_planar": launches}, timing


def probe_bound_ms(table, tile_counts, walked, pairs):
    """Least time of P1's work: K1's walk without the colors: the walked
    entries' six geometry rows read once and [T, 3] written, against K1's
    operations per pair but the weight and the color FMAs (`pairs` with
    WARP_BLOCK). Returns (ms, bound_by, ms_all_pairs)."""
    T = int(tile_counts.shape[0])
    bytes_moved = int(walked.sum()) * 6 * 4 + T * 8 + T * 12
    return bound_ms(bytes_moved, *walk_ops(pairs, pairs["used"] * OPS_USED))


def phase_probes(errs):
    """The probes: P1 on the sort engine's table of the random and the
    surfel scene at the JAX probe's settings (what probe_cfin prints), then
    probe_sortdesign's torch.sort sections and P2's five run-scatter
    configurations. Then, outside the counted run, P1 against K1's walked
    counts (every tile) and its plain version (>= 99.9 % of tiles), P2
    against its plain version bit for bit on each configuration, and P1's
    timing beside its bound and plain version. Returns the launches over
    the probes' run and the timings (sums over the two frames and the five
    configurations)."""
    from wildgaussians_torch.ops import blend
    from wildgaussians_torch.profiles import probe_cfin, probe_sortdesign
    ks = [k for k in kernels() if "probes" in k["paths"]]
    reset_counts(ks)
    frames, summaries = {}, {}
    for kind in ("random", "surfel"):
        arrays, cam = scene_tensors(kind, FULL_N, FULL_W, FULL_H)
        table, starts, counts, grid = probe_cfin.probe_table(arrays, cam, FULL_W, FULL_H)
        out = probe_cfin.probe_cfin(table, starts, counts, grid)
        summaries[kind] = probe_cfin.cfin_summary(out, counts)
        frames[kind] = (table, starts, counts, grid, out)
        print(f"probe_cfin {kind}:", flush=True)
        probe_cfin.print_summary(summaries[kind])
        del arrays
    sorts = probe_sortdesign.sort_measurements(torch.device(DEVICE), log=lambda *a: None)
    scatter = probe_sortdesign.scatter_measurements(torch.device(DEVICE))
    launches = launch_counts(ks)
    emit({"phase": "probes", "probe_cfin": summaries, "sorts": sorts, "run_scatter": scatter})

    timing = {"probe_cfin": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_ms_all_pairs=0.0,
                                 library_ms=None, per="the random and the surfel frame")}
    for kind, (table, starts, counts, grid, out) in frames.items():
        label = f"probe_cfin {kind} scene, {FULL_N} Gaussians, {FULL_W}x{FULL_H}"
        walked = blend.blend_forward(table, starts, counts, grid, 1)[2]
        plain = probe_cfin.probe_cfin_plain(table, starts, counts, grid)
        torch.cuda.synchronize()
        k1_equal = bool(torch.equal(out[:, 2], walked))
        agree = float((out == plain).all(dim=1).float().mean())
        emit({"check": "probe_cfin", "at": label, "walked_equal_k1": k1_equal,
              "tiles_agreeing_with_plain": agree})
        check(k1_equal, f"P1's walked counts differ from K1's at {label}")
        check(agree >= 0.999, f"P1 agrees with its plain version on {agree} of tiles at {label}")
        errs["probe_cfin"].append(float((out - plain).abs().max()))
        pairs = blend.blend_pair_counts(table, starts, counts, grid, warp_block=WARP_BLOCK)
        bound, by, bound_all_pairs = probe_bound_ms(table, counts, walked, pairs)
        emit({"phase": "timing", "kernel": "probe_cfin", "at": label, "pairs": pairs,
              "walked_entries": int(walked.sum()), "bound_ms": bound,
              "bound_ms_all_pairs": bound_all_pairs})
        t = timing["probe_cfin"]
        t["ms"] += time_cuda_ms(lambda: probe_cfin.probe_cfin(table, starts, counts, grid),
                                iters=20)
        t["plain_ms"] += time_cuda_ms(lambda: probe_cfin.probe_cfin_plain(table, starts, counts,
                                                                          grid),
                                      iters=2, warmup=1)
        t["bound_ms"] += bound
        t["bound_ms_all_pairs"] += bound_all_pairs
        t["bound_by"] = by
    emit({"phase": "timing", "kernel": "probe_cfin", **timing["probe_cfin"]})
    del frames
    torch.cuda.empty_cache()

    t = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bound_by="bytes",
             per="the five run-scatter configurations")
    for row in scatter:
        src, st = probe_sortdesign.scatter_inputs(row["C"], row["K"], row["E"], row["RUN"],
                                                  torch.device(DEVICE))
        got = probe_sortdesign.run_scatter(src, st, row["E"], row["RUN"])
        want = probe_sortdesign.run_scatter_plain(src, st, row["E"], row["RUN"])
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"run_scatter differs from its plain version at {row}")
        t["plain_ms"] += time_cuda_ms(lambda: probe_sortdesign.run_scatter_plain(
            src, st, row["E"], row["RUN"]), iters=3, warmup=1)
        for key in ("ms", "bound_ms", "library_ms"):
            t[key] += row[key]
        del src, st, got, want
    errs["run_scatter"].append(0.0)
    emit({"phase": "timing", "kernel": "run_scatter", **t})
    timing["run_scatter"] = t
    return launches, timing


def engine_sizes(model):
    from wildgaussians_torch.ops.partition_engine import engine_d_small, partition_engine_sizes
    from wildgaussians_torch.ops.rasterize_tiled import make_grid
    c = model.config
    return partition_engine_sizes(make_grid(FULL_W, FULL_H, 16), int(model.params["xyz"].shape[0]),
                                  c.max_tiles_per_gaussian, engine_d_small(c.pallas_d_small),
                                  c.pallas_big_fraction)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wildgaussians_torch import WildGaussians
    from wildgaussians_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_line()})

    ks = kernels()
    t0 = time.perf_counter()
    logs = _build.build([k["name"] for k in ks])
    for name, log in logs.items():
        emit({"phase": "build", "kernel": name, "seconds": log.seconds,
              "ptxas": [ln.strip() for ln in log.log.splitlines()
                        if "registers" in ln or "bytes smem" in ln or "spill" in ln]})
    emit({"phase": "build", "wall_s": time.perf_counter() - t0})

    errs = {k["name"]: [] for k in ks}
    launches, timings = {}, {}
    with tempfile.TemporaryDirectory(prefix="wg_chip_smoke_") as tmp:
        phase_check(tmp, errs)
        ckpt, serve_model, load_s = load_checkpoint(tmp)
        cams = [camera(p, FULL_W, FULL_H, FULL_W / 1.4) for p in poses()]
        emb = serve_model.get_train_embedding(5)
        requests = [(0, None), (1, None), (2, None), (3, None), (0, {"outputs": ["depth"]}),
                    (1, {"embedding": emb}), (2, None), (3, None)]
        launches["serve"], k1 = phase_serve(serve_model, cams, requests, "serve", errs,
                                            extra=load_s)
        timings["blend_fwd"] = k1
        torch.cuda.empty_cache()
        launches["train"], k2k3 = phase_train(serve_model, cams, "train", TRAIN_STEPS,
                                              TRAIN_PROFILE_STEPS, errs)
        timings.update(k2k3)
        torch.cuda.empty_cache()
        # the same path with the uncertainty model acting from the first step
        launches["train_uncertainty"], _k2k3 = phase_train(
            serve_model, cams, "train_uncertainty", TRAIN_STEPS, TRAIN_PROFILE_STEPS, errs)
        torch.cuda.empty_cache()
        # the sort engine's steps with the saturation cull
        launches["train_satcull"], _k2k3 = phase_train(
            serve_model, cams, "train_satcull", SATCULL_STEPS, TRAIN_PROFILE_STEPS, errs)
        torch.cuda.empty_cache()

        # the partition engine at full width, after the sort engine's paths:
        # the same checkpoint, its config now naming the engine
        part_model = WildGaussians(checkpoint=set_binning(ckpt, "partition"))
        check(part_model.config.pallas_binning == "partition", "the checkpoint's binning")
        launches["partition_serve"], _k1 = phase_serve(
            part_model, cams, [(i % len(cams), None) for i in range(PARTITION_REQUESTS)],
            "partition_serve", errs, reference=serve_model,
            extra={"engine_sizes": engine_sizes(part_model)._asdict()})
        del part_model
        torch.cuda.empty_cache()
        launches["partition_train"], part = phase_train(serve_model, cams, "partition_train",
                                                        PARTITION_STEPS, 1, errs)
        timings.update({name: part[name] for name in ("radix_pass", "radix_unpass")})
        torch.cuda.empty_cache()
        # the gather engine, as the partition engine
        gather_model = WildGaussians(checkpoint=set_binning(ckpt, "gather"))
        check(gather_model.config.pallas_binning == "gather", "the checkpoint's binning")
        launches["gather_serve"], _k1 = phase_serve(
            gather_model, cams, [(i % len(cams), None) for i in range(GATHER_REQUESTS)],
            "gather_serve", errs, reference=serve_model)
        del gather_model
        torch.cuda.empty_cache()
        launches["gather_train"], _k2 = phase_train(serve_model, cams, "gather_train",
                                                    GATHER_STEPS, 1, errs)
        torch.cuda.empty_cache()
        # the tiled backend (plain torch, no kernel): requests and steps
        tiled_model = WildGaussians(checkpoint=set_config(set_binning(ckpt, "sort"),
                                                          "rasterizer_backend", "tiled"))
        set_config(ckpt, "rasterizer_backend", "auto")
        check(tiled_model.config.rasterizer_backend == "tiled", "the checkpoint's backend")
        # (no profiled request or step: a tiled request issues ~58k
        # launches, a step ~330k, whose traces take tens of seconds to
        # minutes to read)
        launches["tiled"], _k1 = phase_serve(
            tiled_model, cams, [(i % len(cams), None) for i in range(TILED_REQUESTS)], "tiled", errs,
            reference=serve_model, profile_requests=0)
        del tiled_model
        torch.cuda.empty_cache()
        launches["tiled_train"], _t = phase_train(serve_model, cams, "tiled_train", TILED_STEPS,
                                                  0, errs)
        torch.cuda.empty_cache()
        # trajectory rendering and the reference checkpoint import
        launches["trajectory"] = phase_trajectory(serve_model, tmp, errs)
        launches["reference_import"] = phase_reference_import(serve_model, ckpt, cams, tmp, errs)
        torch.cuda.empty_cache()
        # densify/prune, the opacity reset and capacity growth under each engine
        for path in ("densify", "partition_densify"):
            launches[path] = phase_densify(serve_model, cams, path, errs)
        # the multi-GPU paths, at one rank
        launches.update(phase_mesh(serve_model, ckpt, cams, errs))
        # the training CLI end to end, under each evaluation protocol
        for path in ("cli", "cli_nerfw"):
            launches[path] = phase_cli(serve_model, path, errs)
        del serve_model
        torch.cuda.empty_cache()

    # the rasterizer API, the static viewer path and the probes, at bench.py's
    # shapes
    launches["raster"] = phase_raster(errs)
    torch.cuda.empty_cache()
    launches["static"], timings["blend_fwd_planar"] = phase_static(errs)
    torch.cuda.empty_cache()
    launches["probes"], probe_timings = phase_probes(errs)
    timings.update(probe_timings)

    entries = []
    for k in ks:
        name = k["name"]
        by_path = {path: per.get(name, 0) for path, per in launches.items()}
        for path in k["paths"]:
            check(by_path[path] > 0, f"{name} was not launched on the {path} path")
        entry = {"name": name, "route": k["route"], "source": k["source"],
                 "replaces": k["replaces"], "paths": list(k["paths"]),
                 "launches": sum(by_path.values()), "launches_by_path": by_path,
                 "max_abs_err": max(e[0] if isinstance(e, tuple) else e for e in errs[name]),
                 **timings[name]}
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        if name in ("blend_fwd", "blend_fwd_planar"):
            entry["pixels_over_1e-4"] = max(o for _, o in errs[name])
        if name == "blend_bwd":
            entry["max_row_rel_err"] = max(r for _, r in errs[name])
        entries.append(entry)
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's eval, train, stretch, general-SA-level and
serving paths in float32 and bfloat16, its CLI, its visualisers, its
offline scoring, its data parallelism and FLOT's flow scan on one NVIDIA
GPU (or several, for phase 21) and check them.

    python3 chip_smoke.py [--profile DIR] [--dp-only | --flot-only]

Phases, each printing one line:
  1. card       the card's name and power limit (nvidia-smi);
  2. build      nvcc build of ratrack_tpu_torch/csrc/*.cu: seconds, and
                registers / spill bytes per kernel from ptxas;
  3. kernel     every kernel at the main-path shapes (8 streams, 512-point
                clouds) against its plain PyTorch version on the same CUDA
                tensors: max abs error vs 1e-4 * max|plain| + 1e-5, selected
                indices equal, median CUDA-event times over 20 runs; B3's
                selection launch also on its own for each stage (indices
                equal to the plain `knn`; its time, the plain version's,
                one library call's and its bound);
  4. slice      Track4D(npoint=512, k_max=32, sinkhorn_iters=500) with
                seeded random weights, the cached eval scan over 8
                synthetic streams x 4 frames on the GPU against the same
                weights and inputs on the CPU (plain versions): cls and
                flow within 1e-3, labels / track ids mismatching on at most
                1% of points / slots, kernel launch counts as expected;
  5. throughput the scan at 8 streams x 32 frames, frames/s (no gate);
  6. train_kernel the train kernels B9 (SA pair, 6 level configs) and B10
                (correlator, both stages) at the main-path shapes, forward
                and backward against their plain versions under autograd
                on the same CUDA tensors: outputs and batch statistics
                within 1e-4 * max|plain| + 1e-5, selections identical;
                every gradient with cosine >= 0.9999 and, in norm, no
                further from the plain version run in float64 than 1e-3
                of its norm plus twice the float32 plain version's
                distance (max-pool near-ties, see kernels/cases.py::
                compare_train); median CUDA-event ms of a forward and of
                a backward call (each one launch of the wrapper); for
                B10's stage 1 products_torch_ms, its backward's four
                pair-layer products as torch.matmul (float32, TF32 off; a
                yardstick, used nowhere in the port); and how many of the
                forward's and the backward's thread-block clusters the
                card holds at once;
  7. train_slice make_scan_train_step over 8 synthetic streams x 2 frames
                from the same seeded weights on the GPU (float32) and on
                the CPU (plain versions) in float64 and float32: against
                the float64 run, in norm, per-frame losses within 1e-3
                relative, each step's gradient leaves within 1e-3 of the
                whole gradient's norm, BN running statistics within 1e-4
                relative, each plus twice the CPU float32 run's own error
                (see phase_train_slice); train launch counts
                9T / 9T / 2T / 2T and no eval kernel; everything finite;
  8. train_throughput make_scan_train_step at 8 streams x 32 frames (the
                JAX scenario train_512pt_8streams): one warm-up, median of
                3, frames/s, ms/frame, peak device memory (no gate);
  9. stretch_kernel the stretch kernels at 8192 points, one stream, against
                their plain versions on the same CUDA tensors: B5 tiled kNN
                (both stages of the split correlator, Z-sorted clouds; also
                at 16384), B4 apply (both stages), B6 farthest point
                sampling (8192 points with the cloud mask, 512 with none;
                also 16384), B7 Sinkhorn (8 streams, m and n from 0..32);
                B5 again on the clouds unsorted, as B10's selection takes
                them in train stretch (no weight in the summary);
                B1 and B2 again at 8192 points x 512 centers. Indices
                identical, values within phase 3's tolerance (B7: u, v and
                Z within 1e-4 on the valid block, the matching equal);
                then the public Sinkhorn's default, the two-pass
                log-sum-exp, on scores uniform in [0, 100) on the card
                against the CPU: finite, and within twice the CPU float32
                run's distance from float64 (check_safe_lse);
  10. stretch_slice Track4D(npoint=512, exact_fps, mov_budget=512,
                sinkhorn_kernel) at 8192 points, 1 stream x 2 frames on
                the GPU against the CPU (plain versions): phase 4's gates,
                launch counts 6T+3 / 6T+3 / 2T / 2T / 6T+3 / T for B1, B2,
                B5, B4, B6, B7 and none of B3;
  11. stretch_throughput the cached eval scan at 8192 x 16 frames and
                16384 x 8 frames, one stream, and the 512-point 8 x 32 scan
                with sinkhorn_kernel=True: one warm-up, median of 3,
                frames/s and peak device memory (no gate).
  12. scale_kernel the one-scale kernels B1' (eval) and B8 (train, forward
                and backward) on every scale of three levels that are not
                a same-depth pair (one scale; three scales; two scales of
                depths 2 and 3), 8 streams x 512 points x 512 centers, 35
                input channels, against their plain versions as in phases
                3 and 6; B1' also at 8192 points x 512 centers, one stream;
                and a pair launch (B1, B9) against two one-scale launches:
                outputs, indices, statistics and weight gradients equal
                bit for bit, the feature gradient (float atomics) within
                1e-5 of its largest element; B9 twice on the same inputs:
                everything but the feature gradient identical;
  13. general_slice those three `SetAbstractionMSG` levels in eval and in
                one train forward + backward on the card against the CPU:
                eval outputs within 1e-4 x max + 1e-5; train outputs and
                running statistics likewise, gradients by phase 6's float64
                yardstick; launch counts by the JAX module's routing: eval
                1 / 3 / 0 of B1' and 0 / 0 / 1 of B1 (two scales take the
                pair kernel whatever their depths), train 1 / 3 / 2 of B8
                forward and backward and none of B9;
  14. serving   `serve.RadarTracker` over Track4D(npoint=512) on the card:
                8 streams x 4 synthetic scans against the same tracker on
                the CPU (0 label, point-track-id and track-id mismatches,
                flow and conf within 1e-3), then per-call wall time (median
                and worst of 50 calls after 5 warm-up calls) of `track()`
                on one stream (bucket 1) and of 8 submits + one `step()`
                (bucket 8) on random 360-point scans, with
                `sinkhorn_kernel` off and on; `last_bucket` and the launch
                counts of a step (9 B1, 9 B2, 2 B3, and 1 B7 when on);
  15. train_stretch make_scan_train_step over Track4D(npoint=512,
                exact_fps, mov_budget=512): one frame step of one stream
                at 8192 points on the card against float64 and float32
                runs on the CPU at phase 7's gates, launch counts 9 / 9 /
                2 / 2 of B9 / B10 forward and backward, 9 of B6 and 2 of
                B5 a frame step (5 at 16384 points, where the three
                fp1 levels select through it too); then frames/s and peak
                memory at 8192 points x 2 streams x 8 frames and 16384 x 1
                x 4 (one warm-up, median of 3, no gate).
  16. cli       the port's CLI (`ratrack_tpu_torch.main.main`) in this
                process, in a temporary directory: train with
                configs/synth_train.yaml (4 streams x 8-frame scans at 256
                points, cut to 2 epochs with 1 of pretraining: the
                `cuts` field), launch counts 9 / 9 / 2 / 2 of B9 / B10 a
                frame step and no eval kernel, the checkpoint files; eval
                with configs/synth_eval.yaml from that best.pt (the cached
                scan, B1 / B2 6T+3 and B3 2T a chunk, no train kernel),
                frames/s as the CLI measures them, the seconds the loop
                waited for the data pipeline and those the pipeline spent
                building records, the MOT table; the eval on 6 frames of
                each val clip on the card and with --cpu from the same
                file: 0 result files, label and track-id mismatches, conf
                and the segmentation / flow means within 5e-4; then one
                train epoch and one eval over a VoD fixture tree (10
                frames of delft_2 and of delft_10) with its MOT table and
                the native library's route.
  17. offline_eval the port's offline scoring of the results tree that
                phase 16's VoD fixture eval wrote on the card: the Kalman
                re-tracker (`eval.run_kf.evaluate_kf`, ego compensation
                off and on, and `run_kf.main --json`), the conversion to
                KITTI detections and the detection-AP tables
                (`eval.run_ap.convert_results_tree`, `eval.detection_ap`,
                `run_ap.main --json`): the KF table beside phase 16's
                Sinkhorn table, the converted detections, the seconds;
                fails on a converted-file count other than the frame
                count, a KF metric not finite, or a CLI's JSON unequal to
                its function's result.
  18. pipelined `train.make_pipelined_eval_step` (every stage that needs
                no earlier frame once over the B x T block): (a) B1, B2
                and B3 at its launch shape, 8 x 32 = 256 clouds of 512
                points, against their plain versions at phase 3's gates,
                and B7 on 256 problems of 33 x 33 x 500 iterations with
                phase 9's gate on Z and the matching (the potentials are
                defined up to a shift along which rounding drifts: their
                distances from the plain version and from a float64 run
                are reported, not gated); (b) the step over 8 streams x 4 frames on the
                card against the card's sequential scan and against the
                CPU pipelined step, phase 4's gates, launch counts 9 / 9 /
                2 a block; with `sinkhorn_kernel=True` one launch of B7
                besides them and the CPU step's tracking at phase 4's
                gates;
                (c) at 8 x 32: one warm-up, median of 3, frames/s, ms a
                frame, peak memory, launch counts 9 / 9 / 2 again, and
                the CUDA kernels launched a block (torch.profiler) beside
                those of a 4-frame block of the cached scan, beside phase
                5's frames/s (no gate); (d) `sinkhorn_tol=1e-4`: the
                iterations each of the 256 streams of that block runs on
                the card and on the CPU (min / median / max), the step's
                and the cached scan's frames/s against tol 0, the step's
                tracking against the CPU step's at phase 4's gates.
  19. bf16      the bfloat16 compute dtype (`Track4D(dtype=torch.bfloat16)`,
                config `dtype: bfloat16`): (a) the bfloat16 instantiations
                of B1 and B2 (phase 3's six configs each), B3 (both
                stages), B1' (phase 12's scales) and B4 (both stages at
                8192 points) against their plain versions at
                compute_dtype=bfloat16 on the same CUDA tensors: indices
                equal, values within one bfloat16 step of the largest
                (2^-8 max|plain| + 1e-5), ms, plain ms and the bound with
                products at the bfloat16 rate (989 TFLOP/s) and each
                tensor's bytes at its own width (B2 reads bfloat16
                features); (b) the cached scan of a bfloat16 model over 8
                streams x 4 frames on the card against the same model on
                the CPU: launch counts 6T+3 / 6T+3 / 2T of the bfloat16
                B1 / B2 / B3 and none of the float32 ones; over the valid
                points cls within 0.02 on average and 0.5 at most, flow
                within 0.05 and 1.0 (bf16_gap_gate says why), points in
                another cluster (labels up to renumbering) on at most 1%,
                the raw label and track-id mismatches reported; the CPU's
                association on the card's pipelined affinities giving the
                card's track ids in 99% of the slots; then at 8 x 32 the
                float32 and the bfloat16 scans in turns (a b b a; one
                warm-up, median of 3 each): frames/s and peak memory of
                both; (c) the pipelined step likewise
                (9 / 9 / 2 bfloat16 launches a block), its 8 x 4 block
                against the CPU's bfloat16 scan; (d) one frame of the
                bfloat16 stretch model at 8192 points (B5 and the bfloat16
                B4 twice, B6, B7) against the CPU at (b)'s gates; (e) the
                three general SA levels in bfloat16 on the card against
                the CPU (1 / 3 launches of the bfloat16 B1', 1 of B1);
                (f) `serve.RadarTracker` over the bfloat16 model, 8
                streams x 4 scans on the card against the CPU: 9 / 9 / 2
                bfloat16 launches a step, flow within 0.05 on average,
                points in another cluster on at most 1%, the label and
                track-id mismatches reported.
  20. bf16_train training in bfloat16 (the train kernels B9 / B10 / B8 run
                in float32 behind casts, as JAX's take no compute dtype):
                (a) make_scan_train_step of Track4D(npoint=512, k_max=32,
                dtype=bfloat16) over 8 streams x 4 frames on the card and
                on the CPU from one seed, and the float32 model on the CPU
                as the yardstick: B9 / B10 launches those of the float32
                step; the loss items of each frame (frame 0 within 2e-2
                of the CPU's); a bfloat16 cls of 0.998 or more rounds to
                1.0 and the reference's BCE gives a stream the largest
                float and NaN gradients (reproduced on purpose, ROADMAP),
                so the NaN gradient leaves must be the CPU's and the
                finite ones |g - g_f32| <= 1e-2 |G| + 2 |g_cpu - g_f32|
                in norm, each and together, g_cpu the farther of two CPU
                bfloat16 runs (the seeded weights, and those weights
                moved by 1e-6 relative: a float32-sized difference), the
                angle to g_f32 at most twice the CPU runs' larger one, and
                |g - g_cpu| <= 1e-2 |G| + twice what that move does to the
                CPU's gradient (a cosine of 0.99 between two bfloat16 runs
                holds for none: PERF.md section 6), the running statistics
                likewise; (b) the three general SA levels in
                one bfloat16 train step on the card against the CPU (B8
                forward and backward, 1 / 3 / 2 launches each), outputs
                within 2^-8 of max plus twice the CPU's bfloat16 error;
                (c) the float32 and bfloat16 train scans at 8 x 32 in
                turns (a b b a): frames/s, ms a frame, peak memory, NaN
                parameters after; (d) the CLI on configs/synth_train.yaml
                cut to 1 epoch in bfloat16: finite losses, launch counts,
                the checkpoint restored into a bfloat16 and a float32
                model; (e) the eval CLI with vis_dir (one PNG a frame;
                where matplotlib is absent a line says so) and the 3D
                visualiser over a VoD fixture frame.
  21. dp        data parallelism over clip streams (parallel/mesh.py):
                (a) make_scan_train_step(ts, mesh) over 8 streams x 4
                frames of the seeded 512-point model, the ranks one card
                each under NCCL (4 or 2 with that many cards; on one card
                one NCCL rank in this process, then two gloo ranks
                sharing the card, a check of the split's numerics and no
                speed figure), spawned by torch.multiprocessing, against
                the unsharded scan from the same weights: frame 0's loss
                items, gradient leaves (over the whole gradient's norm)
                and BN statistics within twice the larger distance of two
                unsharded runs (the same run again: B9 / B10's atomics;
                weights moved by 1e-7 relative: float32 rounding through
                the max-pools' near-ties) plus 1e-5; exactly two
                all-reduces a frame step (count_collectives), B9 / B10
                launched 9 / 9 / 2 / 2 a frame step on every rank, every
                rank's parameters equal after the scan; the sharded cached
                eval scan at phase 4's gates against the unsharded one,
                no collective; (b) with a card a rank, the train scan at
                32 frames in turns w1 wn ww ww wn w1: 8 streams in one
                process, the 8 split over the ranks, 8 a rank: frames/s,
                peak memory a rank; (c) the train CLI under torchrun (4,
                2 or 1 NCCL ranks) on configs/synth_train.yaml cut to 1
                epoch against the one-process CLI: epoch 0's losses within
                2e-2, one checkpoint set written by rank 0, restored into a
                one-process model. `--dp-only` runs phase 21 alone after
                the build (the run for a machine of several cards).
  22. flot      FLOT (configs/flot_8192.yaml, seeded weights, eps 0.08,
                gamma 1), run after phase 20: (a) on the main path's
                inputs, 8 streams of 8192 points, B5 at k = 32 (FLOT's
                graph) against its plain version, indices, keys and
                validity equal, beside one library call (cdist + topk of
                32); B11 on the features FLOT computes there against its
                plain twin, the flow within 5e-4 m; times as phase 3's;
                (b) the flow scan over 2 streams x 2 frames on the card
                against the CPU: flow and ot_flow within 1e-4 m, launches
                counted from zero just before (B5 a frame and one more at
                the block's first, B11 a frame); (c) the scan at 8 streams
                x 16 frames, frames/s and peak memory (no gate).
                `--flot-only` runs phase 22 alone after the build.
  23. dbscan    B12 (run after phase 4, on its model): DBSCAN's inputs of
                one cached eval frame step of that model over 8, 32 and
                256 synthetic streams of 512 points, under the model's
                motion mask (what the main path clusters) and under the
                valid mask: the kernel's labels from square_distance(x, x)
                equal to dbscan_reference's on the card (torch.equal), the
                route's too, one launch a call; median CUDA-event ms of
                the kernel, of the route (distances and kernel) and of the
                plain version, and the kernel's bound: the bytes of d2 it
                reads (a masked-in row's 32-byte sectors that hold a
                masked-in column) and of the mask and labels, at 3.35
                TB/s.
Then one JSON line with every kernel's route, source, launches (B1-B3
from phase 5's run, train kernels from phase 8's, B5 / B4 / B6 / B7 from
phase 11's 8192-point run, B1' and B8 from phase 13's, the bfloat16
instantiations from phase 19's (b), (d) and (e), B11 from phase 22 (b),
B12 from phase 5's),
error, times
summed over the calls one frame step of that path makes (6 B1, 6 B2, 2 B3;
9 B9, 2 B10; 2 B5, 2 B4, 6 B6, 1 B7; 1 B12; for B1' the 4 and for B8 the 6
scales that phase 13's three levels launch one by one; the bfloat16
rows as their float32 ones), the roofline
bound of the same work (the largest of bytes / 3.35 TB/s, matrix-product
operations / 165 TFLOP/s, the card's fastest float32-accurate product:
3xTF32, a third of the 495 TF32 rate, or for the bfloat16 rows / 989
TFLOP/s, and the other float32 operations /
67 TFLOP/s, counted by kernels/cases.py::*_work) and, where one PyTorch
call computes the same function, that call's time; for B1 also its
two sa1 calls of a stretch frame (8192 points x 512 centers: stretch_ms,
stretch_plain_ms, stretch_bound_ms), likewise for B2 its two fp1 calls of
a stretch frame (8192 unknowns x 512 known points), and for B3 its two
selection launches of an eval step (select_ms, select_plain_ms,
select_library_ms, select_bound_ms), for B5 FLOT's graph at k = 32
(graph_ms, graph_plain_ms, graph_library_ms, graph_bound_ms), for B12
its call at 32 and at 256 streams (b32_ms, b32_plain_ms, b32_bound_ms and
the b256 ones); and last
the result line. Any failed check exits non-zero before the result line
(phases 6-8, 12-20, 21 and 22 (b) and (c) record their failed checks
and go on, so that one run reports
all of them; the script then exits non-zero; a rank that fails fails the
spawn, and with it the script). With no CUDA device, or without the ratrack_tpu_torch
package beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time

N_STREAMS = 8
N_MAX = 512
K_MAX = 32
SINKHORN_ITERS = 500
SLICE_T = 4
SCAN_T = 32
TRAIN_SLICE_T = 2
TRAIN_SCAN_T = 32
STRETCH_N = 8192
STRETCH_BIG_N = 16384
STRETCH_NPOINT = 512
STRETCH_SLICE_T = 2
STRETCH_SCAN = ((8192, 16), (16384, 8))    # (points, frames), one stream
TRAIN_STRETCH_SLICE_N = 8192                # one stream, one frame step
TRAIN_STRETCH_SCAN = ((8192, 2, 8), (16384, 1, 4))  # points, streams, frames
SERVE_SCANS = 4
CLI_TRAIN_CUTS = {"epochs": 2, "pretrain_epochs": 1}   # of synth_train.yaml
CLI_CUT_FRAMES = 6        # synth_frames of the eval run on card and CPU
CLI_VOD_FRAMES = 10       # fixture frames of each VoD clip (train, val)
PIPE_EXIT_TOL = 1e-4      # the early exit of phase 18 (d)
SERVE_CALLS = 50
SERVE_WARMUP = 5
BF16_TRAIN_T = 4          # frames of phase 20 (a)
BF16_TRAIN_PERTURB = 1e-6  # phase 20 (a): relative noise on a CPU run's
                           # weights, a difference of float32's size
BF16_CLI_CUTS = {"epochs": 1, "dtype": "bfloat16"}  # of synth_train.yaml
DP_T = 4                  # frames of phase 21 (a)
DP_CLASS = 1e-5           # phase 21 (a): the float32 reduction class
DP_PERTURB = 1e-7         # phase 21 (a): relative noise on the yardstick
                          # run's weights, float32's rounding
DP_CLI_CUTS = {"epochs": 1}   # of synth_train.yaml (dp 4), phase 21 (c)
FLOT_CONFIG = "configs/flot_8192.yaml"
FLOT_STREAMS = 8          # phase 22: the FLOT cell's 8 streams of
FLOT_N = 8192             # 8192 points, all valid,
FLOT_K = 32               # a kNN graph of 32
FLOT_SLICE = (2, 2)       # streams, frames of the scan held to the CPU's
FLOT_SCAN_T = 16          # frames of the timed scan, the cell's block
# the scan on the card against the CPU's (tests/test_torch_port_flot.py
# FLOW_TOL) and B11 against its twin (KERNEL_FLOW_TOL: float32 sums of up
# to 8192 terms in another order, barycentres ~60 m out), in metres
FLOT_FLOW_TOL = 1e-4
FLOT_KERNEL_TOL = 5e-4
DBSCAN_STREAMS = (N_STREAMS, 32, 256)   # phase 23: the slice's, b32's, b256's
REPS = 20
SEED = 0
# B6's launch shapes timed against each other: (threads a block, blocks a
# stream) of one block and of a thread-block cluster, per cloud size
FPS_SHAPES = ((1024, 1), (128, 1), (128, 2), (128, 8))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
PRODUCT_OPS_PER_S = 495e12 / 3  # float32-accurate products: 3xTF32
BF16_PRODUCT_OPS_PER_S = 989e12  # products of bfloat16 operands

KERNELS = {
    "sa_pair": dict(
        source="ratrack_tpu_torch/csrc/sa_pair.cu",
        replaces="ratrack_tpu/ops/pallas_sa.py:192 (_sa_pair_kernel)"),
    "sa_scale": dict(
        source="ratrack_tpu_torch/csrc/sa_pair.cu",
        replaces="ratrack_tpu/ops/pallas_sa.py:145 (_sa_kernel)"),
    "three_interpolate": dict(
        source="ratrack_tpu_torch/csrc/fp.cu",
        replaces="ratrack_tpu/ops/pallas_fp.py:54 (_fp_kernel)"),
    "knn_weight_aggregate": dict(
        source="ratrack_tpu_torch/csrc/correlator.cu",
        replaces="ratrack_tpu/ops/pallas_correlator.py:68 (_corr_kernel)"),
    "sa_pair_train_fwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:1160 "
                 "(_pair_fwd_kernel_pk)"),
    "sa_pair_train_bwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:1229 "
                 "(_pair_bwd_kernel_pk)"),
    "sa_scale_train_fwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:246 (_fwd_kernel)"),
    "sa_scale_train_bwd": dict(
        source="ratrack_tpu_torch/csrc/sa_pair_train.cu",
        replaces="ratrack_tpu/ops/pallas_sa_train.py:287 (_bwd_kernel)"),
    "knn_weight_aggregate_train_fwd": dict(
        source="ratrack_tpu_torch/csrc/correlator.cu",
        replaces="ratrack_tpu/ops/pallas_correlator_train.py:184 "
                 "(_fwd_kernel)"),
    "knn_weight_aggregate_train_bwd": dict(
        source="ratrack_tpu_torch/csrc/correlator_train.cu",
        replaces="ratrack_tpu/ops/pallas_correlator_train.py:251 "
                 "(_bwd_kernel)"),
    "knn_tiled": dict(
        source="ratrack_tpu_torch/csrc/knn_tiled.cu",
        replaces="ratrack_tpu/ops/pallas_knn.py:81 (_knn_kernel)"),
    "knn_gather_apply": dict(
        source="ratrack_tpu_torch/csrc/correlator.cu",
        replaces="ratrack_tpu/ops/pallas_correlator.py:287 (_apply_kernel)"),
    "furthest_point_sample": dict(
        source="ratrack_tpu_torch/csrc/fps.cu",
        replaces="ratrack_tpu/ops/pallas_fps_kernel.py:63 (_fps_kernel)"),
    "sinkhorn_uv": dict(
        source="ratrack_tpu_torch/csrc/sinkhorn.cu",
        replaces="ratrack_tpu/ops/pallas_sinkhorn.py:44 (_kernel)"),
    "transport_flow": dict(
        source="ratrack_tpu_torch/csrc/transport.cu",
        replaces="none (FLOT's transport; the JAX package runs no FLOT)"),
    "dbscan_labels": dict(
        source="ratrack_tpu_torch/csrc/dbscan.cu",
        replaces="none (DBSCAN's labels; the JAX package's dbscan is plain "
                 "JAX)"),
}
# the bfloat16-operand instantiations (phase 19), by the float32 kernel
# they instantiate
BF16_OF = {"sa_pair_bf16": "sa_pair", "sa_scale_bf16": "sa_scale",
           "three_interpolate_bf16": "three_interpolate",
           "knn_weight_aggregate_bf16": "knn_weight_aggregate",
           "knn_gather_apply_bf16": "knn_gather_apply"}
KERNELS.update({name: dict(
    source=KERNELS[base]["source"],
    replaces=KERNELS[base]["replaces"][:-1] + ", compute_dtype=bfloat16)")
    for name, base in BF16_OF.items()})
BF16_KERNELS = tuple(BF16_OF)
EVAL_KERNELS = ("sa_pair", "three_interpolate", "knn_weight_aggregate")
STRETCH_KERNELS = ("knn_tiled", "knn_gather_apply", "furthest_point_sample",
                   "sinkhorn_uv")
SCALE_KERNELS = ("sa_scale", "sa_scale_train_fwd", "sa_scale_train_bwd")
FLOT_KERNELS = ("transport_flow",)
CLUSTER_KERNELS = ("dbscan_labels",)   # one launch a frame step, every path
TRAIN_KERNELS = tuple(k for k in KERNELS if k not in
                      EVAL_KERNELS + STRETCH_KERNELS + SCALE_KERNELS
                      + BF16_KERNELS + FLOT_KERNELS + CLUSTER_KERNELS)


FAILED: list = []   # failed checks of phases 6-8 and 12-20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def record_failure(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    FAILED.append(msg)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of fn() in ms. A spin kernel queued before the
    start event keeps the stream busy while the host enqueues fn's work,
    so host overhead does not count."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, got, want, got_idx, want_idx, rel=1e-4):
    """A kernel against its plain version: indices equal, values within
    rel * max|plain| + 1e-5 (phase 3's 1e-4; 2^-8 for a bfloat16
    instantiation, see variant), finite."""
    err = (got - want).abs().max().item()
    tol = rel * want.abs().max().item() + 1e-5
    idx_equal = bool(torch.equal(got_idx.long(), want_idx.long()))
    finite = bool(torch.isfinite(got).all().item())
    if not (err <= tol and idx_equal and finite):
        fail(f"{name}: max_abs_err {err} (tol {tol}), indices equal "
             f"{idx_equal}, finite {finite}")
    return err, tol


def new_summary(names):
    return {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None,
                    bytes=0, mm_ops=0, ops=0) for k in names}


def roofline(nbytes, mm_ops, ops, product_rate=PRODUCT_OPS_PER_S):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes, to do mm_ops matrix-product operations at product_rate (the
    3xTF32 rate; the bfloat16 rate for the bfloat16 instantiations) or to
    do ops other float32 operations, whichever is longest."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mm_ops / product_rate, ops / FP32_OPS_PER_S)
    return (1000.0 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def tally(entry, weight, err, ms, plain_ms, library_ms, nbytes, mm_ops,
          ops):
    """Add `weight` calls of one config to a kernel's per-frame-step sums."""
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms"] += weight * ms
    entry["plain_ms"] += weight * plain_ms
    if library_ms is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + weight * library_ms
    entry["bytes"] += weight * nbytes
    entry["mm_ops"] += weight * mm_ops
    entry["ops"] += weight * ops


def run_kernel_cases(torch, phase, runs, summary):
    """Each run: dict(kernel, config, run_k, run_p, check(got, want) ->
    (err, tol), work(got) -> (bytes, ops), library (a callable or None),
    products (a callable or None: a yardstick timed beside the kernel),
    weight (calls per frame step that count in the kernel's summary))."""
    with torch.inference_mode():
        for r in runs:
            got, want = r["run_k"](), r["run_p"]()
            torch.cuda.synchronize()
            err, tol = r["check"](got, want)
            work = r["work"](got)
            bound_ms, bound_by = roofline(
                *work, r.get("product_rate", PRODUCT_OPS_PER_S))
            ms = device_ms(torch, r["run_k"])
            plain_ms = device_ms(torch, r["run_p"])
            library_ms = (device_ms(torch, r["library"])
                          if r.get("library") else None)
            products_ms = (device_ms(torch, r["products"])
                           if r.get("products") else None)
            emit(phase=phase, kernel=r["kernel"], config=r["config"],
                 max_abs_err=err, tol=tol, indices_equal=True, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 products_torch_ms=products_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
            tally(summary[r["kernel"]], r.get("weight", 1), err, ms,
                  plain_ms, library_ms, *work)
            del got, want


def variant(torch, kw):
    """(kernel-name suffix, relative tolerance, product rate) of a kernel
    case: its bfloat16 instantiation's where kw asks for bfloat16 operands
    (within one bfloat16 step of the largest plain value: both multiply
    the same rounded operands exactly, but a float32 sum in another order
    can round a later layer's operand to the neighbouring bfloat16)."""
    if kw.get("compute_dtype") == torch.bfloat16:
        return "_bf16", 2.0 ** -8, BF16_PRODUCT_OPS_PER_S
    return "", 1e-4, PRODUCT_OPS_PER_S


def check_sa(torch, name, rel=1e-4):
    def check(got, want):
        errs = [compare(torch, f"{name}.{t}", got[i], want[i], got[i + 2],
                        want[i + 2], rel) for i, t in enumerate("ab")]
        return max(e for e, _ in errs), min(t for _, t in errs)
    return check


def check_out_idx(torch, name, rel=1e-4):
    return lambda got, want: compare(torch, name, got[0], want[0], got[1],
                                     want[1], rel)


def sa_run(torch, cases, fused_sa, name, kw, weight=1):
    sfx, rel, rate = variant(torch, kw)
    return dict(kernel="sa_pair" + sfx, config=name, weight=weight,
                run_k=lambda: fused_sa.sa_pair(**kw, return_indices=True),
                run_p=lambda: fused_sa.sa_pair_reference(**kw),
                check=check_sa(torch, f"sa_pair{sfx}[{name}]", rel),
                work=lambda got: cases.sa_pair_work(kw, *got),
                product_rate=rate)


def fp_run(torch, cases, fused_fp, name, kw, weight=1):
    sfx, rel, rate = variant(torch, kw)
    return dict(kernel="three_interpolate" + sfx, config=name,
                weight=weight,
                run_k=lambda: fused_fp.fused_three_interpolate(
                    **kw, return_indices=True),
                run_p=lambda: fused_fp.three_interpolate_reference(**kw),
                check=check_out_idx(torch, f"three_interpolate{sfx}[{name}]",
                                    rel),
                work=lambda got: cases.three_interpolate_work(kw, got[0]),
                product_rate=rate,
                # one library call for the 3-NN selection: top-3 of the
                # dense distance matrix
                library=lambda: torch.topk(
                    torch.cdist(kw["unknown"], kw["known"]), 3, dim=-1,
                    largest=False))


def corr_run(torch, cases, fused_correlator, stage, kw):
    """B3 (both launches) against its plain version."""
    sfx, rel, rate = variant(torch, kw)
    name = f"knn_weight_aggregate{sfx}"
    return dict(
        kernel=name, config=f"stage{stage}",
        run_k=lambda: fused_correlator.fused_knn_weight_aggregate(
            **kw, return_indices=True),
        run_p=lambda: fused_correlator.knn_weight_aggregate_reference(**kw),
        check=check_out_idx(torch, f"{name}[stage{stage}]", rel),
        work=lambda got: cases.corr_work(kw, got[0]), product_rate=rate)


def select_run(torch, cases, fused_correlator, knn, name, kw):
    """B3's selection launch alone, against the plain `knn`."""
    q, p, mask = kw["query"], kw["points"], kw["mask_p"]

    def check(got, want):
        if not torch.equal(got.long(), want[1]):
            fail(f"knn_select[{name}]: indices differ from the plain knn")
        return 0.0, 0.0
    return dict(kernel="knn_select", config=name,
                run_k=lambda: fused_correlator.launch_knn(q, p, mask, 16),
                run_p=lambda: knn(16, q, p, mask),
                check=check,
                work=lambda got: cases.knn_select_work(q, p, mask, got),
                # one library selection: top-16 of the masked dense
                # distance matrix
                library=lambda: torch.topk(
                    torch.cdist(q, p).masked_fill_(
                        ~mask.unsqueeze(1), float("inf")), 16, dim=-1,
                    largest=False))


def phase_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa
    from ratrack_tpu_torch.ops.neighborhood import knn

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc1, m1, pc2, m2 = cases.clouds(seed, N_STREAMS, N_MAX)
    runs = []
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_case(level, head, pc1, m1, gen),
                                 dev)
            runs.append(sa_run(torch, cases, fused_sa, f"{head}.{level}", kw))
        for level in cases.FP_LEVELS:
            kw = cases.to_device(cases.fp_case(level, pc1, m1, gen), dev)
            runs.append(fp_run(torch, cases, fused_fp, f"{head}.{level}", kw))
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        runs.append(corr_run(torch, cases, fused_correlator, stage, kw))
        runs.append(select_run(torch, cases, fused_correlator, knn,
                               f"stage{stage}", kw))
    summary = new_summary(EVAL_KERNELS + ("knn_select",))
    run_kernel_cases(torch, "kernel", runs, summary)
    return summary


def sinkhorn_run(torch, seed: int, streams: int, report=fail,
                 gauge_free: bool = False):
    """B7's run on `streams` problems of (K_MAX + 1) squared and
    SINKHORN_ITERS iterations against its plain version (a failed check
    goes to `report`). The potentials u, v are defined only up to a shift
    (u + a, v - a), which the iterations do not contract: rounding drifts
    along it (by 1e-4 between two float32 orders of the plain loop on 256
    problems, and on a problem with no valid row or column, whose
    potentials drift by a constant an iteration, by more), while Z = c + u
    + v, what the association reads, stays within ~1e-6. With gauge_free
    the gate holds Z alone, and the potentials' distances (kernel from
    plain, both from a float64 run of the plain loop) are reported."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_sinkhorn
    from ratrack_tpu_torch.tracker import associate

    dev = torch.device("cuda")
    kw, meta = cases.sinkhorn_case(seed, streams, K_MAX, SINKHORN_ITERS)
    kw64 = {k: v.double() if torch.is_tensor(v) else v
            for k, v in kw.items()}
    kw, meta = cases.to_device(kw, dev), cases.to_device(meta, dev)

    def check_sinkhorn(got, want):
        """u, v on the valid rows / columns (unless gauge_free) and Z on
        the valid block within 1e-4 absolute (the kernel sums in another
        order than torch, a few ulps an iteration); the matching equal."""
        k = K_MAX
        ar = torch.arange(k + 1, device=dev)
        rows = (ar < meta["m"].unsqueeze(1)) | (ar == k)
        cols = (ar < meta["n"].unsqueeze(1)) | (ar == k)

        def uv_err(pair, ref, sel):
            return max((pair[0].double() - ref[0])[rows & sel]
                       .abs().max().item(),
                       (pair[1].double() - ref[1])[cols & sel]
                       .abs().max().item())
        err = 0.0 if gauge_free else uv_err(got, want, True)
        z = [kw["c"] + u.unsqueeze(2) + v.unsqueeze(1)
             - meta["norm"].reshape(-1, 1, 1) for u, v in (got, want)]
        block = rows.unsqueeze(2) & cols.unsqueeze(1)
        err = max(err, (z[0] - z[1])[block].abs().max().item())
        if gauge_free:
            ref64 = [x.to(dev) for x in
                     fused_sinkhorn.sinkhorn_uv_reference(**kw64)]
            both = ((meta["m"] > 0) & (meta["n"] > 0)).unsqueeze(1)
            parts = {}
            for side, sel in (("both_sides", both), ("an_empty_side", ~both)):
                if bool(sel.any()):
                    parts[side] = dict(
                        problems=int(sel.sum()),
                        kernel_vs_plain=uv_err(got, want, sel),
                        kernel_vs_float64=uv_err(got, ref64, sel),
                        plain_vs_float64=uv_err(want, ref64, sel))
            emit(phase="pipelined", part="sinkhorn_potentials",
                 problems=streams, z_max_abs_err=err, **parts)
        prev = torch.arange(k, device=dev, dtype=torch.int32).expand(
            streams, k).contiguous()
        nxt = torch.full((streams,), k, device=dev, dtype=torch.int32)
        a, b = [associate(meta["scores"], meta["m"], meta["n"], prev, nxt,
                          0.9, SINKHORN_ITERS, 0.01, use_fused_kernel=fused)
                for fused in (True, False)]
        same = (torch.equal(a.matched_prev, b.matched_prev)
                and torch.equal(a.track_id, b.track_id))
        finite = bool(torch.isfinite(got[0]).all()
                      and torch.isfinite(got[1]).all())
        if not (err <= 1e-4 and same and finite):
            report(f"sinkhorn_uv[{streams}]: max abs err {err} (tol 1e-4), "
                   f"matching equal {same}, finite {finite}")
        return err, 1e-4
    return dict(
        kernel="sinkhorn_uv", config=f"{streams}x{K_MAX + 1}",
        run_k=lambda: fused_sinkhorn.sinkhorn_uv(**kw),
        run_p=lambda: fused_sinkhorn.sinkhorn_uv_reference(**kw),
        check=check_sinkhorn,
        work=lambda got: cases.sinkhorn_work(kw, *got))


def phase_stretch_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import (fused_correlator, fused_fp, fused_knn,
                                       fused_sa, sampling)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 2)
    clouds = {n: cases.stretch_clouds(seed, n)
              for n in (STRETCH_N, STRETCH_BIG_N)}
    pc1, m1, pc2, m2 = clouds[STRETCH_N]
    runs = []

    def check_knn(name):
        def check(got, want):
            idx_ok = bool(torch.equal(got[0], want[0]))
            valid_ok = bool(torch.equal(got[2], want[2]))
            want_keys = want[1][want[2]]
            err = ((got[1][want[2]] - want_keys).abs().max().item()
                   if valid_ok and want_keys.numel() else 0.0)
            tol = 1e-4 * want_keys.abs().max().item() + 1e-5
            if not (idx_ok and valid_ok and err <= tol):
                fail(f"{name}: indices equal {idx_ok}, validity equal "
                     f"{valid_ok}, key err {err} (tol {tol})")
            return err, tol
        return check

    def library_knn(kw):
        # one library selection: top-16 of the masked dense distance matrix
        gone = ~kw["points_mask"].unsqueeze(1)
        return lambda: torch.topk(
            torch.cdist(kw["query"], kw["points"]).masked_fill_(
                gone, float("inf")), kw["k"], dim=-1, largest=False)

    # Z-sorted as the split correlator sorts them (the stretch eval path);
    # unsorted as B10's selection takes them in train stretch (no weight)
    for n, (c1, cm1, c2, cm2) in clouds.items():
        for stage, zsorted in ((1, True), (2, True), (1, False), (2, False)):
            if n != STRETCH_N and stage == 2:
                continue
            kw = cases.to_device(
                cases.knn_tiled_case(stage, c1, cm1, c2, cm2) if zsorted
                else dict(query=c1, points=c2 if stage == 1 else c1,
                          points_mask=cm2 if stage == 1 else cm1, k=16), dev)
            name = f"{n}.stage{stage}" + ("" if zsorted else ".unsorted")
            runs.append(dict(
                kernel="knn_tiled", config=name,
                weight=int(n == STRETCH_N and zsorted),
                run_k=lambda kw=kw: fused_knn.knn_indices_tiled(
                    **kw, return_keys=True),
                run_p=lambda kw=kw: fused_knn.knn_indices_tiled_reference(
                    **kw),
                check=check_knn(f"knn_tiled[{name}]"),
                work=lambda got, kw=kw: cases.knn_tiled_work(kw, got[0],
                                                             got[1]),
                library=library_knn(kw)))

    for stage in (1, 2):
        kw = cases.to_device(cases.apply_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        name = f"{STRETCH_N}.stage{stage}"

        def check_apply(got, want, kw=kw, name=name):
            return compare(torch, f"knn_gather_apply[{name}]", got, want,
                           kw["idx"], kw["idx"])
        runs.append(dict(
            kernel="knn_gather_apply", config=name,
            run_k=lambda kw=kw: fused_correlator.knn_gather_apply(**kw),
            run_p=lambda kw=kw: fused_correlator.knn_gather_apply_reference(
                **kw),
            check=check_apply,
            work=lambda got, kw=kw: cases.corr_work(kw, got, select=False),
            # stage 1's two pair-layer products as torch.matmul (float32,
            # TF32 off): a yardstick, not a library call for the function
            products=(cases.apply_products(kw, kw["idx"]) if kw["mlp_ws"]
                      else None)))

    def check_fps(name):
        def check(got, want):
            bad = int((got != want).sum())
            if bad:
                fail(f"{name}: {bad} of {want.numel()} samples differ")
            return 0.0, 0.0
        return check

    fps_kws = {}
    centers = cases.fps_centers(pc1, m1, STRETCH_NPOINT)
    # per 8192-point frame step: sa1 of both heads on the cloud, sa2 and
    # sa3 of both heads on the 512 centers with no mask
    for name, xyz, mask, weight in (
            (f"{STRETCH_N}.masked", pc1, m1, 2),
            (f"{STRETCH_NPOINT}.nomask", centers, None, 4),
            (f"{STRETCH_BIG_N}.masked", clouds[STRETCH_BIG_N][0],
             clouds[STRETCH_BIG_N][1], 0)):
        kw = cases.to_device(cases.fps_case(xyz, mask, STRETCH_NPOINT), dev)
        fps_kws[name] = kw
        runs.append(dict(
            kernel="furthest_point_sample", config=name, weight=weight,
            run_k=lambda kw=kw: sampling.furthest_point_sample(**kw),
            run_p=lambda kw=kw: sampling.furthest_point_sample_reference(
                **kw),
            check=check_fps(f"furthest_point_sample[{name}]"),
            work=lambda got, kw=kw: cases.fps_work(kw, got)))

    runs.append(sinkhorn_run(torch, seed, N_STREAMS))

    # B1 and B2 where N != M: the cloud against its 512 sampled centers
    # (B1's two sa1 calls a stretch frame summed into the kernels line)
    for head in ("pn_head", "mse"):
        sa_kw = cases.to_device(cases.sa_case(
            "sa1", head, pc1, m1, gen, npoint=STRETCH_NPOINT), dev)
        runs.append(sa_run(torch, cases, fused_sa,
                           f"{STRETCH_N}.{head}.sa1", sa_kw, weight=1))
    # (B2's two fp1 calls a stretch frame, both at 128 channels)
    fp_kw = cases.to_device(cases.fp_case("fp1", pc1, m1, gen,
                                          npoint=STRETCH_NPOINT), dev)
    runs.append(fp_run(torch, cases, fused_fp, f"{STRETCH_N}.fp1", fp_kw,
                       weight=2))

    summary = new_summary(STRETCH_KERNELS + ("sa_pair", "three_interpolate"))
    run_kernel_cases(torch, "stretch_kernel", runs, summary)

    # B6 again with its launch shape forced: one block against a cluster,
    # each equal to the kernel's own choice (held to the plain loop above)
    for name, kw in fps_kws.items():
        want = sampling.furthest_point_sample(**kw)
        n = kw["xyz"].shape[1]
        for shape in FPS_SHAPES:
            if n > 16 * shape[0] * shape[1]:      # over 16 points a thread
                continue
            got = sampling.furthest_point_sample(**kw, shape=shape)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"furthest_point_sample[{name}] with {shape[0]} threads "
                     f"x {shape[1]} blocks a stream differs from its default")
            emit(phase="stretch_kernel", kernel="furthest_point_sample",
                 config=name, threads=shape[0], blocks_per_stream=shape[1],
                 indices_equal=True,
                 ms=device_ms(torch, lambda: sampling.furthest_point_sample(
                     **kw, shape=shape)))
    meta = cases.sinkhorn_case(seed, N_STREAMS, K_MAX, SINKHORN_ITERS)[1]
    check_safe_lse(torch, seed, meta["m"], meta["n"])
    out = {k: summary[k] for k in STRETCH_KERNELS}
    out["sa_pair_stretch"] = summary["sa_pair"]
    out["three_interpolate_stretch"] = summary["three_interpolate"]
    return out


def check_safe_lse(torch, seed: int, m, n):
    """The public Sinkhorn's default, the two-pass log-sum-exp, on scores
    uniform in [0, 100) (where the bounded form overflows) with B7's case's
    m and n, SINKHORN_ITERS iterations, on the card and on the CPU: the
    coupling finite on the card, and on the valid block no further from the
    CPU's float64 run than twice the CPU float32 run is plus 1e-5 of its
    largest entry."""
    import numpy as np
    from ratrack_tpu_torch.tracker.sinkhorn import \
        log_optimal_transport_masked
    rng = np.random.RandomState(seed + 5)
    b, k = m.shape[0], K_MAX
    scores = torch.from_numpy((rng.rand(b, k, k) * 100).astype(np.float32))

    def coupling(x, device):
        return log_optimal_transport_masked(
            x.to(device), m.to(device), n.to(device), 0.9,
            SINKHORN_ITERS).cpu().double()

    card = coupling(scores, "cuda")
    cpu32, cpu64 = coupling(scores, "cpu"), coupling(scores.double(), "cpu")
    ar = torch.arange(k + 1)
    rows = (ar < m.unsqueeze(1)) | (ar == k)
    cols = (ar < n.unsqueeze(1)) | (ar == k)
    block = rows.unsqueeze(2) & cols.unsqueeze(1)
    card_err = (card - cpu64)[block].abs().max().item()
    cpu_err = (cpu32 - cpu64)[block].abs().max().item()
    tol = 2 * cpu_err + 1e-5 * cpu64[block].abs().max().item()
    finite = bool(torch.isfinite(card).all())
    emit(phase="stretch_kernel", check="sinkhorn_safe_lse",
         scores="uniform [0, 100)", streams=b, k=k, iters=SINKHORN_ITERS,
         finite=finite, card_err_vs_f64=card_err, cpu_f32_err_vs_f64=cpu_err,
         card_err_vs_cpu_f32=(card - cpu32)[block].abs().max().item(),
         tol=tol)
    if not (finite and card_err <= tol):
        fail(f"safe-LSE Sinkhorn on the card: finite {finite}, error "
             f"{card_err} against float64 (tol {tol})")


def counters():
    from ratrack_tpu_torch.ops import (fused_correlator,
                                       fused_correlator_train, fused_fp,
                                       fused_knn, fused_sa, fused_sa_train,
                                       fused_sinkhorn, sampling)
    from ratrack_tpu_torch.tracker.dbscan import dbscan_labels
    return {"knn_tiled": fused_knn.knn_indices_tiled,
            "knn_gather_apply": fused_correlator.knn_gather_apply,
            "furthest_point_sample": sampling.furthest_point_sample,
            "sinkhorn_uv": fused_sinkhorn.sinkhorn_uv,
            "sa_pair": fused_sa.sa_pair,
            "sa_scale": fused_sa.sa_scale,
            "sa_scale_train_fwd": fused_sa_train.sa_scale_train_fwd,
            "sa_scale_train_bwd": fused_sa_train.sa_scale_train_bwd,
            "three_interpolate": fused_fp.fused_three_interpolate,
            "knn_weight_aggregate":
                fused_correlator.fused_knn_weight_aggregate,
            "sa_pair_train_fwd": fused_sa_train.sa_pair_train_fwd,
            "sa_pair_train_bwd": fused_sa_train.sa_pair_train_bwd,
            "knn_weight_aggregate_train_fwd":
                fused_correlator_train.knn_weight_aggregate_train_fwd,
            "knn_weight_aggregate_train_bwd":
                fused_correlator_train.knn_weight_aggregate_train_bwd,
            # the bfloat16 instantiations count on their own
            "sa_pair_bf16": fused_sa.sa_pair.bf16,
            "sa_scale_bf16": fused_sa.sa_scale.bf16,
            "three_interpolate_bf16": fused_fp.fused_three_interpolate.bf16,
            "knn_weight_aggregate_bf16":
                fused_correlator.fused_knn_weight_aggregate.bf16,
            "knn_gather_apply_bf16": fused_correlator.knn_gather_apply.bf16,
            "dbscan_labels": dbscan_labels}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in counters().items()}


def expected_launches(t: int):
    # per frame: pn_head(pc1) + decoder mse = 6 SA pairs and 6 FP; 2
    # correlator stages; plus the pc2 head once at block entry (3 + 3)
    return {**{k: 0 for k in TRAIN_KERNELS + STRETCH_KERNELS + SCALE_KERNELS
               + BF16_KERNELS},
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_weight_aggregate": 2 * t, "dbscan_labels": t}


def expected_stretch_launches(t: int):
    # as expected_launches, with the split correlator (a tiled kNN and an
    # apply per stage) in place of B3, a farthest point sampling per SA
    # level and one Sinkhorn launch per frame
    return {**{k: 0 for k in TRAIN_KERNELS + SCALE_KERNELS + BF16_KERNELS},
            "knn_weight_aggregate": 0,
            "sa_pair": 6 * t + 3, "three_interpolate": 6 * t + 3,
            "knn_tiled": 2 * t, "knn_gather_apply": 2 * t,
            "furthest_point_sample": 6 * t + 3, "sinkhorn_uv": t,
            "dbscan_labels": t}


def expected_train_launches(t: int):
    # per frame step: 3 PNHeads (pc1, pc2, the decoder's mse) x 3 SA
    # levels, forward and backward; 2 correlator stages; no eval kernel
    return {**{k: 0 for k in EVAL_KERNELS + STRETCH_KERNELS + SCALE_KERNELS
               + BF16_KERNELS},
            "sa_pair_train_fwd": 9 * t, "sa_pair_train_bwd": 9 * t,
            "knn_weight_aggregate_train_fwd": 2 * t,
            "knn_weight_aggregate_train_bwd": 2 * t, "dbscan_labels": t}


def make_frames(torch, seed: int, t: int, device, n_max: int = N_MAX,
                streams: int = N_STREAMS, n_static: int = 300):
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip, \
        to_tensors
    clips = [stack_frames(synthetic_clip(seed + s, t, n_max=n_max,
                                         g_max=K_MAX, n_static=n_static,
                                         n_objects=5))
             for s in range(streams)]
    return to_tensors(stack_frames(clips), device)


def stretch_frames(torch, seed: int, t: int, device, n_max: int,
                   streams: int = 1):
    """`streams` streams of the stretch scenarios' synthetic clips."""
    from ratrack_tpu_torch.kernels.cases import stretch_static_points
    return make_frames(torch, seed, t, device, n_max, streams,
                       stretch_static_points(n_max))


def stretch_model(torch, seed: int, device, sinkhorn_kernel: bool = True):
    from ratrack_tpu_torch.models import Track4D
    return Track4D(npoint=STRETCH_NPOINT, k_max=K_MAX,
                   sinkhorn_iters=SINKHORN_ITERS, exact_fps=True,
                   mov_budget=512, sinkhorn_kernel=sinkhorn_kernel,
                   generator=torch.Generator().manual_seed(seed),
                   device=device)


def tracking_gap(torch, got, want, pc1):
    """cls and flow max abs error and label / track id mismatches between
    two (B, T, ...) output dicts."""
    got = {k: got[k].cpu() for k in ("cls", "warp", "labels", "track_id")}
    want = {k: want[k].cpu() for k in got}
    pc1 = pc1.cpu()
    return dict(
        cls_max_abs_err=(got["cls"] - want["cls"]).abs().max().item(),
        flow_max_abs_err=((got["warp"] - pc1) - (want["warp"] - pc1))
        .abs().max().item(),
        label_mismatch=int((got["labels"] != want["labels"]).sum()),
        label_total=got["labels"].numel(),
        track_id_mismatch=int((got["track_id"] != want["track_id"]).sum()),
        track_id_total=got["track_id"].numel(),
        finite=bool(torch.isfinite(got["cls"]).all()
                    and torch.isfinite(got["warp"]).all()))


def gate_tracking(name, gap, report=record_failure):
    """Phase 4's gates on a tracking_gap: finite, cls and flow within 1e-3,
    labels and track ids mismatching on at most 1%."""
    if not gap["finite"]:
        report(f"{name}: outputs not finite")
    if gap["cls_max_abs_err"] > 1e-3 or gap["flow_max_abs_err"] > 1e-3:
        report(f"{name}: cls err {gap['cls_max_abs_err']} / flow err "
               f"{gap['flow_max_abs_err']} > 1e-3")
    if (gap["label_mismatch"] > 0.01 * gap["label_total"]
            or gap["track_id_mismatch"] > 0.01 * gap["track_id_total"]):
        report(f"{name}: mismatches: labels {gap['label_mismatch']}, "
               f"track ids {gap['track_id_mismatch']}")


def compare_slice(torch, phase, model, frames_cpu, want_launches, streams,
                  t, n_max):
    """The cached eval scan of `model` (on the CPU, plain versions) over
    frames_cpu, then the same on the card: shapes, finiteness, cls and flow
    within 1e-3, labels / track ids mismatching on at most 1%, launch
    counts as given. Leaves the model on the card."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    scan = make_scan_eval_step_cached(model)
    t0 = time.perf_counter()
    _, cpu = scan(init_state(streams, K_MAX, device="cpu"), frames_cpu)
    cpu_s = time.perf_counter() - t0

    dev = torch.device("cuda")
    model.to(dev)
    frames = FrameBatch(*[x.to(dev) for x in frames_cpu])
    reset_counters()
    _, gpu = scan(init_state(streams, K_MAX, device=dev), frames)
    torch.cuda.synchronize()
    launches = read_counters()
    if launches != want_launches:
        fail(f"{phase} launch counts {launches}, expected {want_launches}")
    for k, shape in (("cls", (streams, t, n_max)),
                     ("warp", (streams, t, n_max, 3)),
                     ("labels", (streams, t, n_max)),
                     ("track_id", (streams, t, K_MAX))):
        if tuple(gpu[k].shape) != shape:
            fail(f"{phase} {k} shape {tuple(gpu[k].shape)}, expected {shape}")
    gap = tracking_gap(torch, gpu, cpu, frames_cpu.pc1)
    emit(phase=phase, streams=streams, frames=t, points=n_max,
         **{k: v for k, v in gap.items() if k != "finite"},
         clustered_points=int((cpu["labels"] >= 0).sum()),
         live_tracks=int((cpu["track_id"] >= 0).sum()),
         launches=launches, cpu_seconds=cpu_s)
    gate_tracking(phase, gap, fail)


def phase_slice(torch, seed: int):
    from ratrack_tpu_torch.models import Track4D

    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    compare_slice(torch, "slice", model,
                  make_frames(torch, seed, SLICE_T, "cpu"),
                  expected_launches(SLICE_T), N_STREAMS, SLICE_T, N_MAX)
    return model


def phase_stretch_slice(torch, seed: int):
    model = stretch_model(torch, seed, "cpu")
    compare_slice(torch, "stretch_slice", model,
                  stretch_frames(torch, seed, STRETCH_SLICE_T, "cpu",
                                 STRETCH_N),
                  expected_stretch_launches(STRETCH_SLICE_T), 1,
                  STRETCH_SLICE_T, STRETCH_N)
    return model


def dbscan_inputs(torch, model, seed: int, streams: int):
    """DBSCAN's input in one cached eval frame step of `model` over
    `streams` synthetic streams on the model's device: (x, the motion mask
    it is given, the valid mask)."""
    from ratrack_tpu_torch.models import track4d
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    dev = next(model.parameters()).device
    frames = make_frames(torch, seed, 1, dev, streams=streams)
    seen, route = [], track4d.dbscan

    def record(x, mask, *args):
        seen.append((x, mask))
        return route(x, mask, *args)
    track4d.dbscan = record
    try:
        make_scan_eval_step_cached(model)(
            init_state(streams, K_MAX, device=dev), frames)
    finally:
        track4d.dbscan = route
    (x, mov), = seen
    return x, mov, frames.mask1[:, 0].contiguous()


def dbscan_bytes(mask) -> int:
    """The bytes B12 moves for one call: of each masked-in row of d2 the
    32-byte sectors that hold a masked-in column (it loads no other), the
    mask, and the int32 labels it writes."""
    b, n = mask.shape
    cols = mask.new_zeros((b, -(-n // 8) * 8))
    cols[:, :n] = mask
    sectors = cols.reshape(b, -1, 8).any(-1).sum(-1)
    return int((mask.sum(-1) * sectors).sum()) * 32 + 5 * b * n


def phase_dbscan(torch, model, seed: int):
    """Phase 23: B12 on the DBSCAN input of phase 4's model (on the card)
    against the plain version. -> summary entries: dbscan_labels (the
    8-stream call under the motion mask, one a frame step), dbscan_b32 and
    dbscan_b256 (the same at 32 and 256 streams)."""
    from ratrack_tpu_torch.ops.neighborhood import square_distance
    from ratrack_tpu_torch.tracker.dbscan import (dbscan, dbscan_labels,
                                                  dbscan_reference)

    eps, min_samples = model.dbscan_eps, model.min_obj_points
    iters = model.dbscan_max_iters
    summary = new_summary(("dbscan_labels", "dbscan_b32", "dbscan_b256"))
    with torch.inference_mode():
        for streams in DBSCAN_STREAMS:
            x, mov, valid = dbscan_inputs(torch, model, seed + streams,
                                          streams)
            d2 = square_distance(x, x)
            for name, mask in (("motion", mov), ("valid", valid)):
                before = dbscan_labels.launches
                got = dbscan_labels(d2, mask, eps, min_samples, iters)
                launched = dbscan_labels.launches - before
                want = dbscan_reference(x, mask, eps, min_samples, iters)
                routed = dbscan(x, mask, eps, min_samples, iters)
                torch.cuda.synchronize()
                equal = bool(torch.equal(got, want)
                             and torch.equal(routed, want))
                if not (equal and launched == 1):
                    fail(f"dbscan_labels[{streams}, {name}]: labels equal "
                         f"{equal}, launches {launched}")
                nbytes = dbscan_bytes(mask)
                bound_ms, bound_by = roofline(nbytes, 0, 0)
                ms = device_ms(torch, lambda: dbscan_labels(
                    d2, mask, eps, min_samples, iters))
                route_ms = device_ms(torch, lambda: dbscan(
                    x, mask, eps, min_samples, iters))
                plain_ms = device_ms(torch, lambda: dbscan_reference(
                    x, mask, eps, min_samples, iters))
                emit(phase="dbscan", kernel="dbscan_labels", streams=streams,
                     points=N_MAX, mask=name,
                     masked_points=int(mask.sum()),
                     clustered_points=int((want >= 0).sum()),
                     clusters=int((want.max(-1).values + 1).sum()),
                     labels_equal=True, ms=ms, route_ms=route_ms,
                     plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                     bound_by=bound_by, d2_bound_ms=roofline(
                         d2.numel() * 4, 0, 0)[0])
                if name == "motion":
                    key = ("dbscan_labels" if streams == N_STREAMS
                           else f"dbscan_b{streams}")
                    tally(summary[key], 1, 0.0, ms, plain_ms, None, nbytes,
                          0, 0)
            del x, mov, valid, d2, got, want, routed
    return summary


def timed_scans(torch, scan, state0, frames, reps: int = 3):
    """One warm-up, then `reps` synchronised scans -> (seconds of each,
    launch counts of the first, outputs of the last, peak bytes)."""
    scan(state0, frames)                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches, out = [], None, None
    for rep in range(reps):
        if rep == 0:
            reset_counters()
        t0 = time.perf_counter()
        _, out = scan(state0, frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = read_counters()
    return times, launches, out, torch.cuda.max_memory_allocated()


def phase_stretch_throughput(torch, model, seed: int, card: str,
                             eval_fps: float, profile_dir):
    """The stretch scans (model: the 8192 / 16384-point Track4D on the
    card), then the 512-point 8-stream scan with the Sinkhorn kernel,
    beside phase 5's frames/s (eval_fps). Returns the launch counts of the
    8192-point scan."""
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    dev = torch.device("cuda")
    scan = make_scan_eval_step_cached(model)
    kept = None
    for n_max, t in STRETCH_SCAN:
        frames = stretch_frames(torch, seed + 300, t, dev, n_max)
        times, launches, out, peak = timed_scans(
            torch, scan, init_state(1, K_MAX, device=dev), frames)
        if launches != expected_stretch_launches(t):
            fail(f"stretch throughput launch counts {launches}, expected "
                 f"{expected_stretch_launches(t)}")
        if not torch.isfinite(out["cls"]).all():
            fail("stretch throughput outputs not finite")
        dt = statistics.median(times)
        emit(phase="stretch_throughput", points=n_max, streams=1,
             frames_per_stream=t, sinkhorn_iters=SINKHORN_ITERS,
             sinkhorn_kernel=True, frames_per_s=t / dt,
             ms_per_frame=1000.0 * dt / t, scan_seconds=times,
             peak_memory_gib=peak / 2 ** 30, card=card, launches=launches)
        if n_max == STRETCH_N:
            kept = launches
            if profile_dir:
                profile_scan(torch, scan, init_state(1, K_MAX, device=dev),
                             frames, profile_dir, 4, "stretch")
        del frames, out

    small = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    sinkhorn_kernel=True,
                    generator=torch.Generator().manual_seed(seed), device=dev)
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    times, launches, out, peak = timed_scans(
        torch, make_scan_eval_step_cached(small),
        init_state(N_STREAMS, K_MAX, device=dev), frames)
    want = {**expected_launches(SCAN_T), "sinkhorn_uv": SCAN_T}
    if launches != want:
        fail(f"sinkhorn-kernel throughput launch counts {launches}, "
             f"expected {want}")
    if not torch.isfinite(out["cls"]).all():
        fail("sinkhorn-kernel throughput outputs not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * SCAN_T
    emit(phase="stretch_throughput", points=N_MAX, streams=N_STREAMS,
         frames_per_stream=SCAN_T, sinkhorn_iters=SINKHORN_ITERS,
         sinkhorn_kernel=True, frames_per_s=n_frames / dt,
         ms_per_frame=1000.0 * dt / n_frames, scan_seconds=times,
         peak_memory_gib=peak / 2 ** 30,
         frames_per_s_eager_sinkhorn=eval_fps, card=card, launches=launches)
    return kept


def phase_throughput(torch, model, seed: int, card: str, profile_dir):
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached

    dev = torch.device("cuda")
    scan = make_scan_eval_step_cached(model)
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    times, launches, out, _ = timed_scans(torch, scan, state0, frames)
    if launches != expected_launches(SCAN_T):
        fail(f"throughput launch counts {launches}, expected "
             f"{expected_launches(SCAN_T)}")
    if not torch.isfinite(out["cls"]).all():
        fail("throughput outputs not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * SCAN_T
    emit(phase="throughput", streams=N_STREAMS, frames_per_stream=SCAN_T,
         sinkhorn_iters=SINKHORN_ITERS, frames_per_s=n_frames / dt,
         ms_per_frame=1000.0 * dt / n_frames, scan_seconds=times,
         card=card, launches=launches)
    if profile_dir:
        profile_scan(torch, scan, state0, frames, profile_dir)
    return launches, n_frames / dt


def profile_scan(torch, scan, state0, frames, profile_dir, t: int = 4,
                 name: str = "eval", *extra):
    """torch.profiler over a t-frame scan(state0, frames, *extra): the top
    ops by device time into profile_dir/key_averages_<name>.txt, and the
    device busy share of the wall time printed as a `profile` line."""
    from torch.profiler import ProfilerActivity, profile
    from ratrack_tpu_torch.data import FrameBatch
    short = FrameBatch(*[x[:, :t] for x in frames])
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan(state0, short, *extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: an operator row repeats its kernels' device time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    with open(os.path.join(profile_dir, f"key_averages_{name}.txt"),
              "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    emit(phase="profile", scan=name, frames_per_stream=t, wall_s=wall,
         device_busy_s=device_us / 1e6,
         device_busy_share=device_us / 1e6 / wall)


def phase_train_kernels(torch, seed: int):
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator_train, fused_sa_train

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    pc1, m1, pc2, m2 = cases.clouds(seed, N_STREAMS, N_MAX)

    def corr_kernel(**kw):
        return fused_correlator_train.fused_knn_weight_aggregate_train(
            **kw, return_indices=True)

    sa = (cases.sa_train_loss, cases.sa_train_run,
          fused_sa_train.sa_pair_train,
          fused_sa_train.sa_pair_train_reference)
    corr = (cases.corr_train_loss, cases.corr_train_run, corr_kernel,
            fused_correlator_train.knn_weight_aggregate_train_reference)
    runs = []   # (kernel, config, kwargs, (loss fn, run fn, kernel, plain))
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            runs.append(("sa_pair_train", f"{head}.{level}", cases.to_device(
                cases.sa_train_case(level, head, pc1, m1, gen), dev), sa))
    for stage in (1, 2):
        runs.append(("knn_weight_aggregate_train", f"stage{stage}",
                     cases.to_device(cases.corr_train_case(
                         stage, pc1, m1, pc2, m2, gen), dev), corr))

    def work(kernel, kw, outs):
        if kernel == "sa_pair_train":
            return dict(zip(("fwd", "bwd"), cases.sa_train_work(kw, outs)))
        return dict(fwd=cases.corr_work(kw, outs["out"]),
                    bwd=cases.corr_train_bwd_work(kw, outs["out"]))

    from ratrack_tpu_torch.kernels import build
    lib = build.load()
    emit(phase="train_kernel", check="sa_train_clusters",
         launches_per_forward=2,
         launches_per_backward=2, blocks_per_cluster=8,
         clusters_of_a_pair_launch=2 * N_STREAMS,
         forward_clusters_held_at_once=lib.ratrack_sa_train_fwd_clusters(
             N_STREAMS, 2),
         backward_clusters_held_at_once=lib.ratrack_sa_train_bwd_clusters(
             N_STREAMS, 2))
    summary = new_summary(TRAIN_KERNELS)
    for kernel, config, kw, fns in runs:
        # a train frame step runs the pn_head on both clouds, the mse once
        train_kernel_case(torch, cases, summary, "train_kernel", kernel,
                          config, kw, fns, work,
                          2 if config.startswith("pn_head") else 1)
    return summary


def train_kernel_case(torch, cases, summary, phase, kernel, config, kw, fns,
                      work, weight):
    """One train kernel config forward and backward against its plain
    version (fns = loss fn, run fn, kernel wrapper, plain version; work
    (kernel, kw, outputs) -> {"fwd": (bytes, ops), "bwd": ...}): checks by
    cases.compare_train with the float64 yardstick, times, bounds, and
    `weight` calls added to summary[kernel_fwd / kernel_bwd]."""
    loss_fn, run_fn, fk, fp = fns
    got, want = run_fn(fk, kw), run_fn(fp, kw)
    want64 = run_fn(fp, cases.to_float64(kw))
    torch.cuda.synchronize()
    bad, errs = cases.compare_train(got, want, want64)
    if bad:
        record_failure(f"{kernel}[{config}]: " + "; ".join(bad))
    err = {"fwd": max(v for k, v in errs.items() if k in want[0]),
           "bwd": max(v for k, v in errs.items() if k in want[1])}
    ms = {}
    for side, fn in (("kernel", fk), ("plain", fp)):
        with torch.no_grad():
            ms[f"{side}_fwd"] = device_ms(torch, lambda fn=fn: fn(**kw))
        loss, _, leaves = loss_fn(fn, kw)
        flat = [x for _, x in cases.flat_leaves(leaves)]
        ms[f"{side}_bwd"] = device_ms(
            torch, lambda loss=loss, flat=flat: torch.autograd.grad(
                loss, flat, retain_graph=True))
        del loss, leaves, flat
    products_ms = None
    if kernel == "knn_weight_aggregate_train" and kw["mlp_ws"]:
        products_ms = device_ms(torch, cases.corr_train_products(fk, kw))
    w = work(kernel, kw, got[0])
    bounds = {part: roofline(*w[part]) for part in w}
    emit(phase=phase, kernel=kernel, config=config,
         fwd_max_abs_err=err["fwd"], grad_max_abs_err=err["bwd"],
         indices_equal=True, fwd_ms=ms["kernel_fwd"],
         fwd_plain_ms=ms["plain_fwd"], bwd_ms=ms["kernel_bwd"],
         bwd_plain_ms=ms["plain_bwd"], products_torch_ms=products_ms,
         fwd_bound_ms=bounds["fwd"][0], fwd_bound_by=bounds["fwd"][1],
         bwd_bound_ms=bounds["bwd"][0], bwd_bound_by=bounds["bwd"][1])
    for part in ("fwd", "bwd"):
        tally(summary[f"{kernel}_{part}"], weight, err[part],
              ms[f"kernel_{part}"], ms[f"plain_{part}"], None, *w[part])


def _train_run(torch, seed: int, device: str, dtype, stretch_n: int = 0):
    """Track4D from the seed trained on `device` in `dtype`, one frame a
    scan call so that each step's gradients can be read -> per-frame loss
    items, per-step gradients, launch counts, BN running statistics,
    parameters (float64 on the CPU except the parameters). By default the
    512-point model over N_STREAMS streams x TRAIN_SLICE_T frames; with
    stretch_n the stretch model (512 centers, true FPS, compact DBSCAN)
    over one stream x one frame of stretch_n points."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    dev = torch.device(device)
    if stretch_n:
        streams, n_frames = 1, 1
        model = stretch_model(torch, seed, dev, sinkhorn_kernel=False)
        frames = stretch_frames(torch, seed + 7, n_frames, dev, stretch_n)
    else:
        streams, n_frames = N_STREAMS, TRAIN_SLICE_T
        model = Track4D(npoint=N_MAX, k_max=K_MAX,
                        sinkhorn_iters=SINKHORN_ITERS,
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
        frames = make_frames(torch, seed + 7, n_frames, dev)
    model = model.to(dtype=dtype)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100,
                           device=dev))
    frames = FrameBatch(*[x.to(dtype) if x.is_floating_point() else x
                          for x in frames])
    state = init_state(streams, K_MAX, device=dev, dtype=dtype)
    items, grads = [], []
    reset_counters()
    t0 = time.perf_counter()
    for t in range(n_frames):
        state, it = scan(state, FrameBatch(*[x[:, t:t + 1] for x in frames]),
                         False)
        items.append({k: v[0].double().cpu() for k, v in it.items()})
        grads.append({n: p.grad.detach().double().cpu()
                      for n, p in model.named_parameters()})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(items=items, grads=grads, launches=read_counters(),
                seconds=time.perf_counter() - t0,
                stats={n: b.double().cpu() for n, b in model.named_buffers()
                       if b.is_floating_point()},
                params=[p.detach() for p in model.parameters()])


def phase_train_slice(torch, seed: int):
    """The card's float32 train steps against a float64 run on the CPU.
    A float32 run on the CPU measures how far float32 itself strays from
    float64: the max-pools make the gradient ill-conditioned (near-ties
    route a cotangent to either of two slots), and Adam's first update,
    about lr * sign(g), turns every near-zero gradient element that
    rounding flips into a 2 * lr step apart. So each check, on a whole
    tensor in norm (errors land on different elements in different
    runs), is |gpu - f64| <= tol + 2 |cpu32 - f64|: the card may be off
    float64 by 1e-3 (each frame's losses over the streams; each gradient
    leaf, of the whole gradient's norm) or 1e-4 (each BN running
    statistic) plus twice what the CPU's float32 run is off by."""
    compare_train_runs(torch, seed, "train_slice",
                       expected_train_launches(TRAIN_SLICE_T),
                       dict(streams=N_STREAMS, frames=TRAIN_SLICE_T))


def compare_train_runs(torch, seed: int, phase: str, want: dict, shape: dict,
                       stretch_n: int = 0):
    """_train_run on the CPU in float64 and float32 and on the card, held
    together by phase_train_slice's gates; `want` the card's launch
    counts, `shape` what the phase's line says of its size."""
    ref = _train_run(torch, seed, "cpu", torch.float64, stretch_n)
    cpu = _train_run(torch, seed, "cpu", torch.float32, stretch_n)
    gpu = _train_run(torch, seed, "cuda", torch.float32, stretch_n)
    if gpu["launches"] != want:
        record_failure(f"{phase} launch counts {gpu['launches']}, "
                       f"expected {want}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 [v for it in gpu["items"] for v in it.values()]
                 + [g for gr in gpu["grads"] for g in gr.values()]
                 + gpu["params"])
    if not finite:
        record_failure(f"{phase}: loss, gradients or parameters not finite")

    worst = {}   # check -> (err / tol, where, gpu err, cpu32 err)

    def note(check, ratio, where, g_err, c_err):
        if ratio >= worst.get(check, (-1.0,))[0]:
            worst[check] = (ratio, where, g_err, c_err)

    for f, (y, c, g) in enumerate(zip(ref["items"], cpu["items"],
                                      gpu["items"])):
        for k in y:
            eg, ec = (g[k] - y[k]).norm().item(), (c[k] - y[k]).norm().item()
            note("loss", eg / (1e-3 * y[k].norm().item() + 2 * ec + 1e-6),
                 f"frame {f} {k}", eg, ec)
    for s, (y, c, g) in enumerate(zip(ref["grads"], cpu["grads"],
                                      gpu["grads"])):
        total = torch.cat([x.flatten() for x in y.values()]).norm().item()
        for n in y:
            eg, ec = (g[n] - y[n]).norm().item(), (c[n] - y[n]).norm().item()
            note("grad", eg / (1e-3 * total + 2 * ec + 1e-6),
                 f"step {s} {n}", eg / total, ec / total)
    for n, y in ref["stats"].items():
        eg = (gpu["stats"][n] - y).norm().item()
        ec = (cpu["stats"][n] - y).norm().item()
        note("bn_stats", eg / (1e-4 * y.norm().item() + 2 * ec + 1e-6), n,
             eg, ec)
    emit(phase=phase, **shape,
         worst={k: dict(err_over_tol=v[0], at=v[1], gpu_err=v[2],
                        cpu32_err=v[3]) for k, v in worst.items()},
         losses_gpu=[{k: v.tolist() for k, v in it.items()}
                     for it in gpu["items"]],
         launches=gpu["launches"], cpu64_seconds=ref["seconds"],
         cpu32_seconds=cpu["seconds"], gpu_seconds=gpu["seconds"])
    for check, (ratio, where, g_err, c_err) in worst.items():
        if ratio > 1.0:
            record_failure(f"{phase} {check} at {where}: error {g_err} "
                           f"against float64, the CPU's float32 {c_err}")


def phase_train_throughput(torch, seed: int, card: str, profile_dir):
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    dev = torch.device("cuda")
    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed), device=dev)
    scan = make_scan_train_step(
        create_train_state(model, TrainConfig(), steps_per_epoch=100,
                           device=dev))
    frames = make_frames(torch, seed + 200, TRAIN_SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    scan(state0, frames, False)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, launches = [], None
    for rep in range(3):
        if rep == 0:
            reset_counters()
        t0 = time.perf_counter()
        _, items = scan(state0, frames, False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = read_counters()
    if launches != expected_train_launches(TRAIN_SCAN_T):
        record_failure(f"train throughput launch counts {launches}, "
                       f"expected {expected_train_launches(TRAIN_SCAN_T)}")
    if not all(bool(torch.isfinite(v).all()) for v in items.values()):
        record_failure("train throughput losses not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * TRAIN_SCAN_T
    emit(phase="train_throughput", streams=N_STREAMS,
         frames_per_stream=TRAIN_SCAN_T, sinkhorn_iters=SINKHORN_ITERS,
         frames_per_s=n_frames / dt, ms_per_frame=1000.0 * dt / n_frames,
         scan_seconds=times,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         loss_first_last=[items["Loss"][0].mean().item(),
                          items["Loss"][-1].mean().item()],
         card=card, launches=launches)
    if profile_dir:
        profile_scan(torch, scan, state0, frames, profile_dir, 4, "train",
                     False)
    return launches


def phase_scale_kernels(torch, seed: int):
    """Phase 12: kernels B1' and B8 against their plain versions, and a
    pair launch against two one-scale launches."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_sa, fused_sa_train

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 3)
    pc1, m1, _, _ = cases.clouds(seed, N_STREAMS, N_MAX)
    spc, sm, _, _ = cases.stretch_clouds(seed, STRETCH_N)
    summary = new_summary(SCALE_KERNELS)

    def eval_run(name, kw, weight):
        return dict(kernel="sa_scale", config=name, weight=weight,
                    run_k=lambda: fused_sa.sa_scale(**kw,
                                                    return_indices=True),
                    run_p=lambda: fused_sa.sa_scale_reference(**kw),
                    check=check_out_idx(torch, f"sa_scale[{name}]"),
                    work=lambda got: cases.sa_scale_work(kw, *got))

    # in eval the two scales of mixed_depth run as one B1 launch on the
    # model's path: its scales are checked here and count for no launch
    runs = [eval_run(f"{level}.{i}", cases.to_device(kw, dev),
                     int(level != "mixed_depth"))
            for level in cases.GENERAL_LEVELS
            for i, kw in enumerate(cases.sa_scale_cases(level, pc1, m1, gen))]
    runs.append(eval_run(
        f"{STRETCH_N}.one_scale.0", cases.to_device(cases.sa_scale_cases(
            "one_scale", spc, sm, gen, npoint=STRETCH_NPOINT)[0], dev), 0))
    run_kernel_cases(torch, "scale_kernel", runs, summary)

    fns = (cases.sa_scale_train_loss, cases.sa_scale_train_run,
           fused_sa_train.sa_scale_train,
           fused_sa_train.sa_scale_train_reference)
    for level in cases.GENERAL_LEVELS:
        for i, kw in enumerate(cases.sa_scale_train_cases(level, pc1, m1,
                                                          gen)):
            train_kernel_case(
                torch, cases, summary, "scale_kernel", "sa_scale_train",
                f"{level}.{i}", cases.to_device(kw, dev), fns,
                lambda _, kw, outs: dict(zip(
                    ("fwd", "bwd"), cases.sa_scale_train_work(kw, outs))), 1)

    # a pair launch == two one-scale launches
    worst, bad = 0.0, []
    for level in cases.SA_LEVELS:
        kw = cases.to_device(cases.sa_case(level, "pn_head", pc1, m1, gen),
                             dev)
        pair = fused_sa.sa_pair(**kw, return_indices=True)
        for t, single in enumerate(cases.split_sa_case(kw)):
            out, idx = fused_sa.sa_scale(**single, return_indices=True)
            worst = max(worst, (out - pair[t]).abs().max().item())
            if not (torch.equal(out, pair[t])
                    and torch.equal(idx, pair[t + 2])):
                bad.append(f"sa_pair[{level}] scale {t}")
        kw = cases.to_device(cases.sa_train_case(level, "pn_head", pc1, m1,
                                                 gen), dev)
        outs, grads = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
        # the same launch again: everything but dPF (float atomics) repeats
        outs2, grads2 = cases.sa_train_run(fused_sa_train.sa_pair_train, kw)
        if not all(torch.equal(v, outs2[k]) for k, v in outs.items()) or \
                not all(torch.equal(g, grads2[k]) for k, g in grads.items()
                        if not k.startswith("pf")):
            bad.append(f"sa_pair_train[{level}] differs from run to run")
        for t, (tag, single) in enumerate(zip(
                "ab", cases.split_sa_train_case(kw))):
            o1, g1 = cases.sa_scale_train_run(fused_sa_train.sa_scale_train,
                                              single, seed=t)
            pairs = [(v, outs[cases.pair_key(k, tag)]) for k, v in o1.items()]
            pairs += [(g, grads[cases.pair_key(k, tag)])
                      for k, g in g1.items()
                      if k != "pf"]
            for a, b in pairs:
                worst = max(worst, (a.double() - b.double()).abs().max().item())
                if not torch.equal(a, b):
                    bad.append(f"sa_pair_train[{level}] scale {t}")
            # dPF is scattered with float atomics, in another order each run
            d = (g1["pf"] - grads[f"pf{tag}"]).abs().max().item()
            if d > 1e-5 * grads[f"pf{tag}"].abs().max().item() + 1e-7:
                bad.append(f"sa_pair_train[{level}] scale {t}: dPF off {d}")
    emit(phase="scale_kernel", check="pair_equals_two_singles",
         max_abs_err=worst, failures=sorted(set(bad)))
    if bad:
        record_failure("a pair launch differs from two one-scale launches: "
                       + "; ".join(sorted(set(bad))))
    return summary


def general_level(torch, level: str, seed: int, dtype, device,
                  compute_dtype=None):
    """A `SetAbstractionMSG` of cases.GENERAL_LEVELS with seeded weights and
    batch norm statistics, in eval mode, on `device` in `dtype`, computing
    in compute_dtype (None: float32)."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.models import SetAbstractionMSG, init_parameters
    radii, nsamples, mlps, c_feat = cases.GENERAL_LEVELS[level]
    gen = torch.Generator().manual_seed(seed)
    mod = SetAbstractionMSG(N_MAX, radii, nsamples, mlps, 3 + c_feat,
                            dtype=compute_dtype or torch.float32)
    init_parameters(mod, gen)
    with torch.no_grad():
        for name, buf in mod.named_buffers():
            noise = torch.rand(buf.shape, generator=gen)
            buf.copy_(0.2 * noise - 0.1 if name.endswith("running_mean")
                      else 0.5 + noise)
        for name, prm in mod.named_parameters():
            if ".bn_" in name:
                prm.add_(0.2 * torch.rand(prm.shape, generator=gen) - 0.1)
    return mod.eval().requires_grad_(False).to(device=device, dtype=dtype)


def phase_general_slice(torch, seed: int):
    """Phase 13: the general SA level, eval and one train step, the card
    against the CPU. Returns the card's launch counts over all levels."""
    from ratrack_tpu_torch.kernels import cases

    pc1, m1, _, _ = cases.clouds(seed, N_STREAMS, N_MAX)
    gen = torch.Generator().manual_seed(seed + 4)
    c_feat = cases.GENERAL_LEVELS["one_scale"][3]
    feats = torch.randn((N_STREAMS, N_MAX, c_feat), generator=gen)
    total = {k: 0 for k in SCALE_KERNELS}
    zero = {k: 0 for k in counters()}

    def run(level, device, dtype, train):
        mod = general_level(torch, level, seed + 5, dtype, device)
        xyz, mask = pc1.to(device=device, dtype=dtype), m1.to(device)
        f = feats.to(device=device, dtype=dtype).clone()
        if not train:
            with torch.no_grad():
                return {"out": mod(xyz, f, mask)[1]}, {}
        mod.train().requires_grad_(True)
        f.requires_grad_(True)
        out = mod(xyz, f, mask)[1]
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            seed + 6)).to(device=device, dtype=dtype)
        (out * cot).sum().backward()
        outs = {"out": out.detach(),
                **{n: b.detach().clone() for n, b in mod.named_buffers()}}
        grads = {"features": f.grad,
                 **{n: p.grad for n, p in mod.named_parameters()}}
        return outs, grads

    for level, (radii, *_rest) in cases.GENERAL_LEVELS.items():
        n_scales = len(radii)
        for train in (False, True):
            want = run(level, "cpu", torch.float32, train)
            want64 = run(level, "cpu", torch.float64, train) if train else None
            reset_counters()
            got = run(level, "cuda", torch.float32, train)
            torch.cuda.synchronize()
            launches = read_counters()
            names = (("sa_scale_train_fwd", "sa_scale_train_bwd") if train
                     else ("sa_scale",))
            expect = {**zero, **{k: n_scales for k in names}}
            if not train and n_scales == 2:   # eval: two scales -> one B1
                expect = {**zero, "sa_pair": 1}
            if launches != expect:
                record_failure(f"general slice {level} train={train}: "
                               f"launch counts {launches}, expected {expect}")
            for k in names:
                total[k] += launches[k]
            got = tuple({k: v.cpu() for k, v in part.items()} for part in got)
            bad, errs = cases.compare_train(got, want, want64)
            if bad:
                record_failure(f"general slice {level} train={train}: "
                               + "; ".join(bad))
            emit(phase="general_slice", level=level, scales=n_scales,
                 train=train, streams=N_STREAMS, points=N_MAX,
                 out_max_abs_err=errs["out"],
                 worst_max_abs_err=max(errs.values()),
                 launches={k: v for k, v in launches.items() if v})
    return total


def serve_scans(seed: int, n_scans: int):
    """A synthetic stream as raw scans [x y z RCS v_r]: scan 0 the first
    record's pc2 side, scan t + 1 record t's pc1 side."""
    import numpy as np
    from ratrack_tpu_torch.data import stack_frames, synthetic_clip
    s = stack_frames(synthetic_clip(seed, n_scans, n_max=N_MAX, g_max=K_MAX,
                                    n_static=300, n_objects=5))
    scans = [np.concatenate([s.pc2[0][s.mask2[0]], s.ft2[0][s.mask2[0]]], 1)]
    for i in range(n_scans):
        scans.append(np.concatenate([s.pc1[i][s.mask1[i]],
                                     s.ft1[i][s.mask1[i]]], 1))
    return scans


def phase_serving(torch, seed: int, card: str):
    """Phase 14: the serving entry point on the card against the CPU, then
    its per-call wall time."""
    import numpy as np
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.serve import RadarTracker

    def model(device, sinkhorn_kernel=False):
        return Track4D(npoint=N_MAX, k_max=K_MAX,
                       sinkhorn_iters=SINKHORN_ITERS,
                       sinkhorn_kernel=sinkhorn_kernel,
                       generator=torch.Generator().manual_seed(seed),
                       device=device)

    scans = [serve_scans(seed + 400 + s, SERVE_SCANS)
             for s in range(N_STREAMS)]
    results = {}
    for device in ("cpu", "cuda"):
        svc = RadarTracker(model(device), n_max=N_MAX, max_streams=N_STREAMS)
        sids = [svc.open_stream() for _ in range(N_STREAMS)]
        outs = []
        for t in range(SERVE_SCANS + 1):
            for sid in sids:
                svc.submit(sid, scans[sid][t])
            res = svc.step()
            if t == 0 and res:
                record_failure("serving: a first scan gave a result")
            if t > 0:
                outs.append([res[sid] for sid in sids])
        results[device] = outs
    bad = {"labels": 0, "point_track_id": 0, "track_id": 0}
    flow_err = conf_err = 0.0
    clustered = 0
    for step_c, step_g in zip(results["cpu"], results["cuda"]):
        for c, g in zip(step_c, step_g):
            for k in bad:
                bad[k] += int((getattr(c, k) != getattr(g, k)).sum())
            flow_err = max(flow_err, float(np.abs(c.flow - g.flow).max()))
            conf_err = max(conf_err, float(np.abs(c.conf - g.conf).max()))
            clustered += int((c.labels >= 0).sum())
            if not (np.isfinite(g.flow).all() and g.flow.shape == (N_MAX, 3)
                    and g.labels.shape == (N_MAX,)
                    and g.track_id.shape == (K_MAX,)):
                record_failure("serving: output shape or finiteness")
    emit(phase="serving", check="card_vs_cpu", streams=N_STREAMS,
         scans=SERVE_SCANS, mismatches=bad, clustered_points=clustered,
         flow_max_abs_err=flow_err, conf_max_abs_err=conf_err)
    if any(bad.values()) or flow_err > 1e-3 or conf_err > 1e-3:
        record_failure(f"serving card vs CPU: mismatches {bad}, flow err "
                       f"{flow_err}, conf err {conf_err}")

    rng = np.random.RandomState(seed)

    def scan():
        return np.concatenate([rng.randn(360, 3).astype(np.float32) * 10,
                               rng.randn(360, 2).astype(np.float32)], axis=1)

    step_launches = {"sa_pair": 9, "three_interpolate": 9,
                     "knn_weight_aggregate": 2, "dbscan_labels": 1}
    for sinkhorn_kernel in (False, True):
        net = model("cuda", sinkhorn_kernel)
        for name, bucket in (("serve_latency_1stream", 1),
                             ("serve_throughput_8streams", N_STREAMS)):
            svc = RadarTracker(net, n_max=N_MAX, max_streams=bucket)
            sids = [svc.open_stream() for _ in range(bucket)]

            def call():
                if bucket == 1:
                    return svc.track(sids[0], scan())
                for sid in sids:
                    svc.submit(sid, scan())
                return svc.step()

            call()                                   # first scans: no pair
            for _ in range(SERVE_WARMUP):
                call()
            times = []
            reset_counters()
            for _ in range(SERVE_CALLS):
                t0 = time.perf_counter()
                out = call()
                times.append(1000.0 * (time.perf_counter() - t0))
            launches = read_counters()
            want = {**{k: 0 for k in counters()},
                    **{k: v * SERVE_CALLS for k, v in step_launches.items()},
                    "sinkhorn_uv": SERVE_CALLS * int(sinkhorn_kernel)}
            if launches != want:
                record_failure(f"{name} launch counts {launches}, expected "
                               f"{want}")
            if svc.last_bucket != bucket or out is None:
                record_failure(f"{name}: bucket {svc.last_bucket}, expected "
                               f"{bucket}")
            emit(phase="serving", scenario=name, bucket=svc.last_bucket,
                 sinkhorn_kernel=sinkhorn_kernel, calls=SERVE_CALLS,
                 ms_per_call_median=statistics.median(times),
                 ms_per_call_worst=max(times), ms_per_call_best=min(times),
                 scans_per_s=1000.0 * bucket / statistics.median(times),
                 launches_per_step={k: v // SERVE_CALLS
                                    for k, v in launches.items() if v},
                 card=card)


def expected_train_stretch_launches(t: int, n_max: int):
    # as expected_train_launches, plus a farthest point sampling per SA
    # level (3 heads x 3 levels) and the tiled kNN as the selection of both
    # correlator stages; at 16384 points the three fp1 levels (16384
    # unknown x 512 known points) select through it too
    per_frame = 2 + (3 if n_max * STRETCH_NPOINT > 4 * 1024 * 1024 else 0)
    return {**expected_train_launches(t), "furthest_point_sample": 9 * t,
            "knn_tiled": per_frame * t}


def phase_train_stretch(torch, seed: int, card: str):
    """Phase 15: the train stretch path, one frame step against the CPU,
    then frames/s and peak memory of the two scenarios."""
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    n = TRAIN_STRETCH_SLICE_N
    compare_train_runs(torch, seed, "train_stretch_slice",
                       expected_train_stretch_launches(1, n),
                       dict(points=n, streams=1, frames=1), stretch_n=n)
    dev = torch.device("cuda")
    for n_max, streams, t in TRAIN_STRETCH_SCAN:
        model = stretch_model(torch, seed, dev, sinkhorn_kernel=False)
        scan = make_scan_train_step(create_train_state(
            model, TrainConfig(), steps_per_epoch=100, device=dev))
        frames = stretch_frames(torch, seed + 500, t, dev, n_max, streams)
        state0 = init_state(streams, K_MAX, device=dev)
        scan(state0, frames, False)                       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, launches = [], None
        for rep in range(3):
            if rep == 0:
                reset_counters()
            t0 = time.perf_counter()
            _, items = scan(state0, frames, False)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if rep == 0:
                launches = read_counters()
        want = expected_train_stretch_launches(t, n_max)
        if launches != want:
            record_failure(f"train stretch {n_max} launch counts {launches}, "
                           f"expected {want}")
        if not all(bool(torch.isfinite(v).all()) for v in items.values()):
            record_failure(f"train stretch {n_max}: losses not finite")
        dt = statistics.median(times)
        emit(phase="train_stretch", points=n_max, streams=streams,
             frames_per_stream=t, sinkhorn_iters=SINKHORN_ITERS,
             sinkhorn_kernel=False, frames_per_s=streams * t / dt,
             ms_per_frame=1000.0 * dt / (streams * t), scan_seconds=times,
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             loss_first_last=[items["Loss"][0].mean().item(),
                              items["Loss"][-1].mean().item()],
             card=card, launches=launches)
        del model, scan, frames, items


def run_cli(cfg: dict, tmp: str, name: str, cpu: bool = False):
    """The port's CLI in this process on cfg (written as tmp/name.yaml);
    its console output is kept out of this script's (run.log has it).
    -> (what `main` returns, the console output)."""
    import contextlib
    import io
    import yaml
    from ratrack_tpu_torch.main import main as cli

    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = cli(["--config", path] + (["--cpu"] if cpu else []))
    return res, out.getvalue()


def result_tree_diff(got_root: str, want_root: str):
    """Two result trees compared by the rule of the CLI parity tests:
    -> (result files in one tree only, result lines whose points differ,
    lines with the same points and another track id, the largest conf
    difference)."""
    import numpy as np
    from ratrack_tpu_torch.eval.export import parse_frame_results

    def tree(root):
        return {os.path.relpath(os.path.join(d, n), root):
                parse_frame_results(os.path.join(d, n))
                for d, _, names in os.walk(root) for n in names}

    got, want = tree(got_root), tree(want_root)
    files = len(set(got) ^ set(want))
    labels = ids = 0
    conf_err = 0.0
    for path in set(got) & set(want):
        labels += abs(len(got[path]) - len(want[path]))
        for (gc, gt, gp), (wc, wt, wp) in zip(got[path], want[path]):
            if gp.shape != wp.shape or not np.array_equal(gp, wp):
                labels += 1
            elif gt != wt:
                ids += 1
            conf_err = max(conf_err, abs(gc - wc))
    return files, labels, ids, conf_err


def expected_cli_eval_launches(stats: dict, t: int):
    """Eval kernel launches of the CLI's chunked scan: a cached chunk
    launches as expected_launches(t), an uncached one 9 B1 and 9 B2 a
    frame (both heads and the decoder's) and 2 B3."""
    cached = stats["cached_chunks"]
    plain = stats["chunks"] - cached
    want = {k: cached * v for k, v in expected_launches(t).items()}
    want["sa_pair"] += plain * 9 * t
    want["three_interpolate"] += plain * 9 * t
    want["knn_weight_aggregate"] += plain * 2 * t
    want["dbscan_labels"] += plain * t
    return want


def phase_cli(torch, card: str, tmp: str):
    """Phase 16: the port's CLI on the card, in this process, in the
    temporary directory tmp: train with configs/synth_train.yaml (cut to
    CLI_TRAIN_CUTS), eval with configs/synth_eval.yaml from that best.pt,
    the eval on a cut of the val frames on the card and with --cpu from the
    same file (result trees and metric means held equal), then one train
    epoch and one eval over a VoD fixture tree. -> that eval's dataset
    root, results tree, min_obj_points and MOT table, for phase 17."""
    import yaml
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.data import native
    from ratrack_tpu_torch.data.fixture import make_vod_fixture
    from ratrack_tpu_torch.data.pipeline import (CLIP_RANGES, TRAIN_CLIPS,
                                                 VAL_CLIPS)
    from ratrack_tpu_torch.eval.run import format_table

    here = os.path.dirname(os.path.abspath(__file__))

    def shipped(name):
        with open(os.path.join(here, "configs", name)) as f:
            return yaml.safe_load(f)

    def mot(m):
        return {k: m[k] for k in ("samota", "amota", "mota")}

    dirs = {"checkpoints_dir": os.path.join(tmp, "checkpoints"),
            "results_dir": os.path.join(tmp, "results")}
    train_cfg = {**shipped("synth_train.yaml"), **CLI_TRAIN_CUTS, **dirs}
    reset_counters()
    t0 = time.time()
    res, _ = run_cli(train_cfg, tmp, "train")
    launches = read_counters()
    epochs = res["train"]
    steps = sum(e["frames"] for e in epochs) // train_cfg["dp"]
    if launches != expected_train_launches(steps):
        record_failure(f"cli train launch counts {launches}, expected "
                       f"{expected_train_launches(steps)}")
    models = os.path.join(dirs["checkpoints_dir"],
                          train_cfg["exp_name"], "models")
    found = sorted(os.listdir(models))
    want_files = ["best.pt", "last.pt"] + [
        f"last{e}.pt" for e in range(CLI_TRAIN_CUTS["epochs"])]
    if found != sorted(want_files):
        record_failure(f"cli checkpoints {found}, expected {want_files}")
    emit(phase="cli", step="train", config="configs/synth_train.yaml",
         cuts={**CLI_TRAIN_CUTS, **{k: "<tmp>" for k in dirs}},
         streams=train_cfg["dp"], frames_per_scan=train_cfg[
             "scan_frames"], points=train_cfg["n_max"],
         frames_per_s=[e["fps"] for e in epochs],
         frame_steps=[e["frames"] for e in epochs],
         data_wait_s=[e["data_wait_s"] for e in epochs],
         data_build_s=[e["data_build_s"] for e in epochs],
         seconds_per_epoch=[e["seconds"] for e in epochs],
         loss=[e["Loss"] for e in epochs], launches=launches,
         checkpoints=found, seconds=time.time() - t0, card=card)

    eval_cfg = {**shipped("synth_eval.yaml"), **dirs}
    reset_counters()
    res, _ = run_cli(eval_cfg, tmp, "eval")
    launches = read_counters()
    ev = res["eval"]
    want = expected_cli_eval_launches(ev, eval_cfg["scan_frames"])
    if launches != want:
        record_failure(f"cli eval launch counts {launches}, expected "
                       f"{want}")
    if not all(math.isfinite(v) for v in {**ev["seg"],
                                           **ev["flow"]}.values()):
        record_failure("cli eval: metric means not finite")
    emit(phase="cli", step="eval", config="configs/synth_eval.yaml",
         cuts={k: "<tmp>" for k in dirs}, frames=ev["frames"],
         frames_per_s=ev["fps"], data_wait_s=ev["data_wait_s"],
         data_build_s=ev["data_build_s"], eval_seconds=ev["seconds"],
         chunks=ev["chunks"], cached_chunks=ev["cached_chunks"],
         mot=mot(ev["mot"]), seg=ev["seg"], launches=launches,
         checkpoint=os.path.join("<tmp>", train_cfg["exp_name"],
                                 "models", "best.pt"), card=card)
    print(format_table(ev["mot"]), flush=True)

    cut = {**eval_cfg, "synth_frames": CLI_CUT_FRAMES}
    runs = {}
    for device in ("cuda", "cpu"):
        cfg = {**cut, "results_dir": os.path.join(tmp, f"res_{device}")}
        runs[device] = run_cli(cfg, tmp, f"cut_{device}",
                               cpu=device == "cpu")[0]["eval"]
    files, labels, ids, conf_err = result_tree_diff(
        os.path.join(tmp, "res_cuda"), os.path.join(tmp, "res_cpu"))
    mean_err = max(abs(runs["cuda"][g][k] - runs["cpu"][g][k])
                   for g in ("seg", "flow") for k in runs["cpu"][g])
    emit(phase="cli", step="card_vs_cpu", frames=runs["cpu"]["frames"],
         synth_frames=CLI_CUT_FRAMES,
         mismatches={"files": files, "labels": labels,
                     "track_ids": ids},
         conf_err=conf_err, metric_mean_err=mean_err,
         cpu_frames_per_s=runs["cpu"]["fps"],
         mot_card=mot(runs["cuda"]["mot"]),
         mot_cpu=mot(runs["cpu"]["mot"]))
    if files or labels or ids or conf_err > 5e-4 or mean_err > 5e-4:
        record_failure(f"cli card vs cpu: files {files}, labels "
                       f"{labels}, track ids {ids}, conf {conf_err}, "
                       f"metric means {mean_err}")

    root = os.path.join(tmp, "vod")
    clips_dir = os.path.join(tmp, "clips")
    os.makedirs(clips_dir)
    for clip in TRAIN_CLIPS + VAL_CLIPS:
        first = CLIP_RANGES[clip][0]
        frames = []
        if clip in ("delft_2", "delft_10"):
            frames = list(range(first, first + CLI_VOD_FRAMES))
            make_vod_fixture(root, frames)
        with open(os.path.join(clips_dir, f"{clip}.txt"), "w") as f:
            f.write("\n".join(str(i) for i in frames))
    vod = {**train_cfg, "dataset": "vod", "dataset_path": root,
           "clips_dir": clips_dir, "epochs": 1, "exp_name": "vod"}
    t0 = time.time()
    tr = run_cli(vod, tmp, "vod_train")[0]["train"][0]
    ev = run_cli({**vod, "eval": True, "load_checkpoint": True},
                 tmp, "vod_eval")[0]["eval"]
    emit(phase="cli", step="vod_fixture", clips=["delft_2", "delft_10"],
         frames_per_clip=CLI_VOD_FRAMES, train_frames_per_s=tr["fps"],
         train_data_build_s=tr["data_build_s"],
         train_seconds=tr["seconds"], train_loss=tr["Loss"],
         eval_data_build_s=ev["data_build_s"], eval_frames=ev["frames"],
         eval_frames_per_s=ev["fps"], mot=mot(ev["mot"]),
         native_route=native.route(), seconds=time.time() - t0)
    print(format_table(ev["mot"]), flush=True)
    if ev["frames"] != CLI_VOD_FRAMES - 1:
        record_failure(f"cli vod eval: {ev['frames']} frames, expected "
                       f"{CLI_VOD_FRAMES - 1}")
    return dict(root=root, results=vod["results_dir"],
                min_obj_points=vod.get("min_obj_points",
                                       Config().min_obj_points),
                frames=ev["frames"], mot=mot(ev["mot"]))


def captured_json(main, argv):
    """A port CLI's `main(argv)` in this process -> the JSON object it
    printed."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue())


def phase_offline_eval(vod: dict, tmp: str, card: str):
    """Phase 17: the port's offline scoring of the results tree phase 16's
    VoD fixture eval wrote on the card: the Kalman re-tracker
    (`eval.run_kf.evaluate_kf`, ego compensation off and on, and its CLI
    with --json), the conversion to KITTI detections with the detection-AP
    tables (`eval.run_ap.convert_results_tree`, `eval.detection_ap.
    load_annotations` / `official_evaluation`, and its CLI with --json).
    Fails on a converted-file count other than the tree's frame count, a
    KF metric that is not finite, or a CLI whose JSON differs from the
    function's own result."""
    from ratrack_tpu_torch.eval import detection_ap, run_ap, run_kf

    t0 = time.time()
    root, results = vod["root"], vod["results"]
    frames = sum(name.endswith(".txt") for d, _, names in os.walk(results)
                 for name in names)
    common = ["--results", results, "--dataset", root, "--min-obj-points",
              str(vod["min_obj_points"])]
    kf = {}
    for ego in (False, True):
        m = run_kf.evaluate_kf(results, root, split="val",
                               min_obj_points=vod["min_obj_points"],
                               ego_comp=ego)
        flat = {k: v for k, v in m.items() if not isinstance(v, dict)}
        if not all(math.isfinite(v) for v in flat.values()):
            record_failure(f"offline_eval: KF metrics not finite: {flat}")
        printed = captured_json(run_kf.main, common + ["--json"]
                                + (["--ego-comp"] if ego else []))
        if printed != json.loads(json.dumps(flat)):
            record_failure(f"offline_eval: run_kf --json printed {printed}, "
                           f"evaluate_kf returned {flat}")
        kf["ego_on" if ego else "ego_off"] = {
            k: m[k] for k in ("samota", "amota", "mota")}

    gt_dir = os.path.join(root, "lidar", "training", "label_2")
    out_dt = os.path.join(tmp, "kitti_dets")
    converted = run_ap.convert_results_tree(results, root, out_dt)
    if converted != frames:
        record_failure(f"offline_eval: {converted} converted files, the "
                       f"results tree has {frames} frames")
    detections = 0
    for name in os.listdir(out_dt):
        with open(os.path.join(out_dt, name)) as f:
            detections += sum(1 for line in f if line.strip())
    dt_annos, ids = detection_ap.load_annotations(out_dt)
    gt_annos, _ = detection_ap.load_annotations(gt_dir, ids)
    ap = detection_ap.official_evaluation(gt_annos, dt_annos)
    printed = captured_json(run_ap.main, [
        "--gt", gt_dir, "--results", results, "--dataset", root,
        "--out-dt", os.path.join(tmp, "kitti_dets_cli"), "--json"])
    if printed != json.loads(json.dumps(ap)):
        record_failure("offline_eval: run_ap --json printed another table "
                       "than official_evaluation returned")
    emit(phase="offline_eval", clips=sorted(os.listdir(results)),
         frames=frames, kf=kf, sinkhorn=vod["mot"],
         converted_files=converted, detections=detections,
         ap_summary=ap["summary"], seconds=time.time() - t0, card=card)


def expected_pipelined_launches():
    # one block, whatever T: 3 PNHeads (pc1, pc2, the decoder's mse) x 3 SA
    # and 3 FP levels, 2 correlator stages, one DBSCAN over the B x T clouds
    return {**{k: 0 for k in TRAIN_KERNELS + STRETCH_KERNELS + SCALE_KERNELS
               + BF16_KERNELS},
            "sa_pair": 9, "three_interpolate": 9, "knn_weight_aggregate": 2,
            "dbscan_labels": 1}


def cuda_kernels_of(torch, fn):
    """(CUDA kernels fn() launches, device busy share of its wall time),
    by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    return sum(e.count for e in kernels), busy_s / wall


def pipelined_kernel_runs(torch, seed: int, streams: int):
    """Phase 3's runs of B1, B2 and B3 (and B3's selection launch) at
    `streams` clouds, weighted per block."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa
    from ratrack_tpu_torch.ops.neighborhood import knn

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    pc1, m1, pc2, m2 = cases.clouds(seed, streams, N_MAX)
    runs = []
    # the block's three PNHeads: pc1 and pc2 share the pn_head's levels
    for head, weight in (("pn_head", 2), ("mse", 1)):
        for level in cases.SA_LEVELS:
            kw = cases.to_device(cases.sa_case(level, head, pc1, m1, gen),
                                 dev)
            runs.append(sa_run(torch, cases, fused_sa, f"{head}.{level}", kw,
                               weight))
        for level in cases.FP_LEVELS:
            kw = cases.to_device(cases.fp_case(level, pc1, m1, gen), dev)
            runs.append(fp_run(torch, cases, fused_fp, f"{head}.{level}", kw,
                               weight))
    for stage in (1, 2):
        kw = cases.to_device(cases.corr_case(stage, pc1, m1, pc2, m2, gen),
                             dev)
        runs.append(corr_run(torch, cases, fused_correlator, stage, kw))
        runs.append(select_run(torch, cases, fused_correlator, knn,
                               f"stage{stage}", kw))
    return runs


def phase_pipelined(torch, seed: int, card: str, eval_fps: float):
    """Phase 18: the pipelined eval step (see the module docstring)."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.tracker import sinkhorn
    from ratrack_tpu_torch.train import (make_pipelined_eval_step,
                                         make_scan_eval_step,
                                         make_scan_eval_step_cached)

    dev = torch.device("cuda")
    # (a) the kernels at the block's launch shape
    streams = N_STREAMS * SCAN_T
    summary = new_summary(EVAL_KERNELS + ("knn_select", "sinkhorn_uv"))
    runs = pipelined_kernel_runs(torch, seed, streams)
    runs.append(sinkhorn_run(torch, seed, streams, record_failure,
                             gauge_free=True))
    run_kernel_cases(torch, "pipelined_kernel", runs, summary)
    del runs        # their tensors would count in (c)'s peak memory
    for name, entry in summary.items():
        bound_ms, bound_by = roofline(entry["bytes"], entry["mm_ops"],
                                      entry["ops"])
        emit(phase="pipelined", part="kernels_a_block", kernel=name,
             streams=streams, points=N_MAX, max_abs_err=entry["max_abs_err"],
             ms=entry["ms"], plain_ms=entry["plain_ms"],
             library_ms=entry["library_ms"], bound_ms=bound_ms,
             bound_by=bound_by)

    # (b) 8 x SLICE_T: card against the card's sequential scan and the CPU
    def model_on(device, **kw):
        return Track4D(npoint=N_MAX, k_max=K_MAX,
                       sinkhorn_iters=SINKHORN_ITERS,
                       generator=torch.Generator().manual_seed(seed),
                       device=device, **kw)
    frames_cpu = make_frames(torch, seed, SLICE_T, "cpu")
    t0 = time.perf_counter()
    _, cpu = make_pipelined_eval_step(model_on("cpu"))(
        init_state(N_STREAMS, K_MAX, device="cpu"), frames_cpu)
    cpu_s = time.perf_counter() - t0
    model = model_on(dev)
    frames = FrameBatch(*[x.to(dev) for x in frames_cpu])
    step = make_pipelined_eval_step(model)
    reset_counters()
    _, gpu = step(init_state(N_STREAMS, K_MAX, device=dev), frames)
    torch.cuda.synchronize()
    launches = read_counters()
    _, seq = make_scan_eval_step(model)(
        init_state(N_STREAMS, K_MAX, device=dev), frames)
    if launches != expected_pipelined_launches():
        record_failure(f"pipelined launch counts {launches}, expected "
                       f"{expected_pipelined_launches()}")
    vs_scan = tracking_gap(torch, gpu, seq, frames_cpu.pc1)
    vs_cpu = tracking_gap(torch, gpu, cpu, frames_cpu.pc1)
    gate_tracking("pipelined vs the card's scan", vs_scan)
    gate_tracking("pipelined vs the CPU step", vs_cpu)
    # the same block with sinkhorn_kernel: its B * T matchings in one B7
    reset_counters()
    _, gpu_b7 = make_pipelined_eval_step(model_on(dev, sinkhorn_kernel=True))(
        init_state(N_STREAMS, K_MAX, device=dev), frames)
    torch.cuda.synchronize()
    launches_b7 = read_counters()
    if launches_b7 != {**expected_pipelined_launches(), "sinkhorn_uv": 1}:
        record_failure(f"pipelined sinkhorn_kernel launch counts "
                       f"{launches_b7}, expected one sinkhorn_uv besides "
                       f"{expected_pipelined_launches()}")
    vs_cpu_b7 = tracking_gap(torch, gpu_b7, cpu, frames_cpu.pc1)
    gate_tracking("pipelined with B7 vs the CPU step", vs_cpu_b7)
    emit(phase="pipelined", part="check", streams=N_STREAMS, frames=SLICE_T,
         points=N_MAX, vs_card_scan=vs_scan, vs_cpu_pipelined=vs_cpu,
         live_tracks=int((cpu["track_id"] >= 0).sum()), launches=launches,
         sinkhorn_kernel_vs_cpu_pipelined=vs_cpu_b7,
         sinkhorn_kernel_launches=launches_b7, cpu_seconds=cpu_s)
    del cpu, gpu, seq, gpu_b7

    # (c) 8 x 32: frames/s, peak memory, launches a block
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    times, launches, out, peak = timed_scans(torch, step, state0, frames)
    if launches != expected_pipelined_launches():
        record_failure(f"pipelined 8 x {SCAN_T} launch counts {launches}")
    if not torch.isfinite(out["cls"]).all():
        record_failure("pipelined 8 x 32 outputs not finite")
    dt = statistics.median(times)
    n_frames = N_STREAMS * SCAN_T
    kernels_block, busy = cuda_kernels_of(torch, lambda: step(state0, frames))
    short = FrameBatch(*[x[:, :SLICE_T] for x in frames])
    cached = make_scan_eval_step_cached(model)
    kernels_cached, busy_cached = cuda_kernels_of(
        torch, lambda: cached(state0, short))
    emit(phase="pipelined", part="throughput", streams=N_STREAMS,
         frames_per_stream=SCAN_T, points=N_MAX,
         sinkhorn_iters=SINKHORN_ITERS, frames_per_s=n_frames / dt,
         ms_per_frame=1000.0 * dt / n_frames, scan_seconds=times,
         peak_memory_gib=peak / 2 ** 30, launches=launches,
         cuda_kernels_a_block=kernels_block,
         cuda_kernels_a_frame_step=kernels_block / SCAN_T,
         device_busy_share=busy,
         cached_scan_cuda_kernels_a_frame_step=kernels_cached / SLICE_T,
         cached_scan_device_busy_share=busy_cached,
         cached_scan_frames_per_s=eval_fps, card=card)
    fps0 = n_frames / dt

    # (d) the early exit: iterations a stream, card against the CPU
    exit_model = model_on(dev, sinkhorn_tol=PIPE_EXIT_TOL)
    times, _, out, _ = timed_scans(torch, make_pipelined_eval_step(exit_model),
                                   state0, frames)
    fps_exit = n_frames / statistics.median(times)
    c_times, _, _, _ = timed_scans(torch,
                                   make_scan_eval_step_cached(exit_model),
                                   state0, frames)
    scores = out["aff"].reshape(-1, K_MAX, K_MAX)
    m, n = out["m"].reshape(-1), out["n"].reshape(-1)
    counts = {}
    for where in ("cpu", dev):
        c, log_mu, log_nu, _ = sinkhorn.transport_problem(
            scores.to(where), m.to(where), n.to(where), exit_model.sinkhorn_alpha)
        counts[str(where)] = sinkhorn.sinkhorn_uv_early_exit(
            c, log_mu, log_nu, SINKHORN_ITERS, PIPE_EXIT_TOL,
            safe_lse=False)[2].cpu()
    card_n, cpu_n = counts[str(dev)], counts["cpu"]
    both = ((m > 0) & (n > 0)).cpu()

    def stats(x):
        x = x.float()
        return ([x.min().item(), x.median().item(), x.max().item()]
                if x.numel() else None)
    apart = int(((card_n - cpu_n).abs() > 1)[both].sum())
    if apart > 0.01 * int(both.sum()) or int(card_n.max()) > SINKHORN_ITERS:
        record_failure(f"early exit: {apart} streams more than one iteration "
                       f"from the CPU's count")
    frames_cpu32 = FrameBatch(*[x[:, :SLICE_T].cpu() for x in frames])
    _, cpu_exit = make_pipelined_eval_step(
        model_on("cpu", sinkhorn_tol=PIPE_EXIT_TOL))(
        init_state(N_STREAMS, K_MAX, device="cpu"), frames_cpu32)
    _, gpu_exit = make_pipelined_eval_step(exit_model)(
        state0, FrameBatch(*[x[:, :SLICE_T] for x in frames]))
    exit_gap = tracking_gap(torch, gpu_exit, cpu_exit, frames_cpu32.pc1)
    gate_tracking("pipelined early exit vs the CPU step", exit_gap)
    emit(phase="pipelined", part="early_exit", tol=PIPE_EXIT_TOL,
         streams=int(m.numel()), iters_card_min_median_max=stats(card_n),
         iters_cpu_min_median_max=stats(cpu_n),
         iters_card_with_a_row_and_a_column=stats(card_n[both]),
         streams_without_a_row_or_a_column=int((~both).sum()),
         streams_more_than_one_apart=apart,
         frames_per_s=fps_exit, frames_per_s_tol0=fps0,
         cached_scan_frames_per_s=N_STREAMS * SCAN_T
         / statistics.median(c_times),
         cached_scan_frames_per_s_tol0=eval_fps, vs_cpu=exit_gap, card=card)
    del out, frames


# ---- phase 19: bfloat16 -------------------------------------------------

def bf16_kernel_runs(torch, seed: int):
    """Phase 19 (a): the runs of B1, B1', B2, B3 and B4 in bfloat16, each
    at the shapes of its float32 row (phases 3, 12 and 9), weighted per
    frame step as there."""
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_correlator, fused_fp, fused_sa

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 19)
    pc1, m1, pc2, m2 = cases.clouds(seed, N_STREAMS, N_MAX)
    spc1, sm1, spc2, sm2 = cases.stretch_clouds(seed, STRETCH_N)
    rel, rate = variant(torch, {"compute_dtype": torch.bfloat16})[1:]

    def bf16(kw):
        return cases.to_device(cases.bf16_case(kw), dev)

    runs = []
    for head in ("pn_head", "mse"):
        for level in cases.SA_LEVELS:
            runs.append(sa_run(torch, cases, fused_sa, f"{head}.{level}",
                               bf16(cases.sa_case(level, head, pc1, m1,
                                                  gen))))
        for level in cases.FP_LEVELS:
            runs.append(fp_run(torch, cases, fused_fp, f"{head}.{level}",
                               bf16(cases.fp_case(level, pc1, m1, gen))))
    for stage in (1, 2):
        runs.append(corr_run(torch, cases, fused_correlator, stage, bf16(
            cases.corr_case(stage, pc1, m1, pc2, m2, gen))))
    # B1' as phase 12 weighs it: mixed_depth's two scales take one B1
    for level in cases.GENERAL_LEVELS:
        for i, kw in enumerate(cases.sa_scale_cases(level, pc1, m1, gen)):
            kw, name = bf16(kw), f"{level}.{i}"
            runs.append(dict(
                kernel="sa_scale_bf16", config=name,
                weight=int(level != "mixed_depth"),
                run_k=lambda kw=kw: fused_sa.sa_scale(**kw,
                                                      return_indices=True),
                run_p=lambda kw=kw: fused_sa.sa_scale_reference(**kw),
                check=check_out_idx(torch, f"sa_scale_bf16[{name}]", rel),
                work=lambda got, kw=kw: cases.sa_scale_work(kw, *got),
                product_rate=rate))
    for stage in (1, 2):
        kw = bf16(cases.apply_case(stage, spc1, sm1, spc2, sm2, gen))
        name = f"knn_gather_apply_bf16[{STRETCH_N}.stage{stage}]"
        runs.append(dict(
            kernel="knn_gather_apply_bf16", config=f"{STRETCH_N}.stage{stage}",
            run_k=lambda kw=kw: fused_correlator.knn_gather_apply(**kw),
            run_p=lambda kw=kw: fused_correlator.knn_gather_apply_reference(
                **kw),
            check=lambda got, want, kw=kw, name=name: compare(
                torch, name, got, want, kw["idx"], kw["idx"], rel),
            work=lambda got, kw=kw: cases.corr_work(kw, got, select=False),
            product_rate=rate))
    return runs


def as_bf16(launches: dict) -> dict:
    """A float32 path's expected launch counts for its bfloat16 model: each
    float32 kernel's count moved to its bfloat16 instantiation."""
    out = dict(launches)
    for bf, base in BF16_OF.items():
        out[bf], out[base] = out[base], 0
    return out


def partition_mismatch(labels_a, labels_b):
    """Points of (..., N) label arrays whose cluster differs up to
    renumbering: each cluster of a is mapped to the cluster of b that holds
    most of its points (noise, -1, to noise), and a point counts where its
    mapped label is not its label in b."""
    a = labels_a.reshape(-1, labels_a.shape[-1]).long()
    b = labels_b.reshape(-1, labels_b.shape[-1]).long()
    bad = 0
    for la, lb in zip(a, b):
        k = int(max(la.max(), lb.max())) + 2
        pairs = ((la + 1) * k + lb + 1).bincount(minlength=k * k)
        best = pairs.reshape(k, k).argmax(1) - 1
        best[0] = -1
        bad += int((best[la + 1] != lb).sum())
    return bad


def bf16_gap(torch, got, want, pc1, mask):
    """tracking_gap of two (B, T, ...) bfloat16 runs, with the mean cls and
    flow errors over the valid points and the points clustered apart
    (labels up to renumbering, partition_mismatch)."""
    def cast(out):
        return {k: out[k].float() if out[k].is_floating_point() else out[k]
                for k in ("cls", "warp", "labels", "track_id")}
    got = {k: v.cpu() for k, v in cast(got).items()}
    want = {k: v.cpu() for k, v in cast(want).items()}
    valid = mask.cpu()
    d_cls = (got["cls"] - want["cls"]).abs()[valid]
    d_flow = (got["warp"] - want["warp"]).abs()[valid]
    return dict(tracking_gap(torch, got, want, pc1),
                cls_mean_abs_err=d_cls.mean().item(),
                flow_mean_abs_err=d_flow.mean().item(),
                clustered_apart=partition_mismatch(got["labels"],
                                                   want["labels"]))


def association_replay(torch, model, out, new_seq):
    """Track ids the CPU's association gives on a pipelined step's own
    (B, T) affinities and counts (`match_structure`, then `assign_ids`
    frame by frame, as the step's phases C and D), against the ids the
    step returned -> mismatching slots. It holds the card's association
    exactly, apart from the affinities that bfloat16 rounds differently on
    the card and on the CPU."""
    from ratrack_tpu_torch.tracker import association as assoc
    aff = out["aff"].cpu()
    b, t, k, _ = aff.shape
    ms = assoc.match_structure(
        aff.reshape(b * t, k, k), out["m"].cpu().reshape(-1),
        out["n"].cpu().reshape(-1), model.sinkhorn_alpha,
        model.sinkhorn_iters, model.sinkhorn_tol)
    ms = assoc.MatchStructure(*[x.reshape(b, t, k) for x in ms])
    tid = torch.full((b, k), -1, dtype=torch.int32)
    next_id = torch.zeros((b,), dtype=torch.int32)
    bad = 0
    for s in range(t):
        tid = torch.where(new_seq[:, s, None].cpu(), torch.full_like(tid, -1),
                          tid)
        res = assoc.assign_ids(assoc.MatchStructure(*[x[:, s] for x in ms]),
                               tid, next_id, aff[:, s],
                               model.match_conf_thres)
        tid, next_id = res.track_id, res.next_id
        bad += int((tid != out["track_id"][:, s].cpu()).sum())
    return bad


def bf16_gap_gate(name, gap, report=record_failure):
    """Phase 19's gates on a bf16_gap: finite; over the valid points cls
    within 0.02 on average and 0.5 at most, flow within 0.05 on average and
    1.0 at most (the JAX package's own two bfloat16 paths differ by 0.009 /
    0.195 and 0.023 / 0.375 on tests/test_torch_port_bf16.py's model: a
    bfloat16 step in the heads moves random weights' large logits); points
    clustered apart on at most 1% (phase 4's budget). The raw label and
    track-id mismatches are reported, not gated: a bfloat16 step in an
    affinity moves a match where two candidates are that close, and the
    ids of every later frame follow (association_replay holds the card's
    association on its own affinities instead)."""
    if not gap["finite"]:
        report(f"{name}: outputs not finite")
    if (gap["cls_mean_abs_err"] > 0.02 or gap["cls_max_abs_err"] > 0.5
            or gap["flow_mean_abs_err"] > 0.05
            or gap["flow_max_abs_err"] > 1.0):
        report(f"{name}: cls err {gap['cls_mean_abs_err']} mean / "
               f"{gap['cls_max_abs_err']} max, flow err "
               f"{gap['flow_mean_abs_err']} / {gap['flow_max_abs_err']}")
    if gap["clustered_apart"] > 0.01 * gap["label_total"]:
        report(f"{name}: {gap['clustered_apart']} points clustered apart")


def paired_scans(torch, steps, state0, frames):
    """Each (name, step) timed in turns (a b b a: one warm-up, median of 3
    each time) -> {name: dict(frames_per_s of both turns, peak_memory_gib,
    launches of the first turn)}."""
    n_frames = frames.pc1.shape[0] * frames.pc1.shape[1]
    out = {name: dict(frames_per_s=[]) for name, _ in steps}
    for name, step in steps + steps[::-1]:
        times, launches, _, peak = timed_scans(torch, step, state0, frames)
        entry = out[name]
        entry["frames_per_s"].append(n_frames / statistics.median(times))
        entry.setdefault("peak_memory_gib", peak / 2 ** 30)
        entry.setdefault("launches", launches)
    return out


def phase_bf16(torch, seed: int, card: str):
    """Phase 19: the bfloat16 compute dtype. (a) the bfloat16 kernels
    against their plain versions; (b) the cached scan at 8 x 4 against the
    CPU and at 8 x 32 beside float32; (c) the pipelined step likewise;
    (d) one stretch frame at 8192 points through B4 against the CPU; (e)
    the three general SA levels against the CPU (B1'); (f) serve.
    RadarTracker against the CPU. Returns (summary, launch counts of the
    bfloat16 kernels on their paths)."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (make_pipelined_eval_step,
                                         make_scan_eval_step_cached)

    dev = torch.device("cuda")
    bf = torch.bfloat16
    summary = new_summary(BF16_KERNELS)
    run_kernel_cases(torch, "bf16_kernel", bf16_kernel_runs(torch, seed),
                     summary)
    for name, entry in summary.items():
        bound_ms, bound_by = roofline(entry["bytes"], entry["mm_ops"],
                                      entry["ops"], BF16_PRODUCT_OPS_PER_S)
        emit(phase="bf16", part="kernels_a_frame_step", kernel=name,
             max_abs_err=entry["max_abs_err"], ms=entry["ms"],
             plain_ms=entry["plain_ms"], library_ms=entry["library_ms"],
             bound_ms=bound_ms, bound_by=bound_by, card=card)
    kept = {}

    def model_on(device, dtype, **kw):
        return Track4D(npoint=N_MAX, k_max=K_MAX,
                       sinkhorn_iters=SINKHORN_ITERS, dtype=dtype,
                       generator=torch.Generator().manual_seed(seed),
                       device=device, **kw)

    # (b) and (c) at 8 x 4: the card against the CPU's bfloat16 scan
    frames_cpu = make_frames(torch, seed, SLICE_T, "cpu")
    t0 = time.perf_counter()
    _, cpu = make_scan_eval_step_cached(model_on("cpu", bf))(
        init_state(N_STREAMS, K_MAX, device="cpu"), frames_cpu)
    cpu_s = time.perf_counter() - t0
    model = model_on(dev, bf)
    frames = FrameBatch(*[x.to(dev) for x in frames_cpu])
    checks = {}
    for part, make in (("scan", make_scan_eval_step_cached),
                       ("pipelined", make_pipelined_eval_step)):
        reset_counters()
        _, gpu = make(model)(init_state(N_STREAMS, K_MAX, device=dev),
                             frames)
        torch.cuda.synchronize()
        launches = read_counters()
        want = as_bf16(expected_launches(SLICE_T) if part == "scan"
                       else expected_pipelined_launches())
        if launches != want:
            record_failure(f"bf16 {part} launch counts {launches}, "
                           f"expected {want}")
        if gpu["cls"].dtype != bf:
            record_failure(f"bf16 {part}: cls is {gpu['cls'].dtype}")
        gap = bf16_gap(torch, gpu, cpu, frames_cpu.pc1, frames_cpu.mask1)
        bf16_gap_gate(f"bf16 {part} vs the CPU bf16 scan", gap)
        if part == "pipelined":
            gap["association_replay_mismatch"] = bad = association_replay(
                torch, model, gpu, frames.new_seq)
            if bad > 0.01 * gpu["track_id"].numel():
                record_failure(f"bf16 pipelined: the CPU's association on "
                               f"the card's affinities differs in {bad} "
                               f"track-id slots")
        checks[part] = dict(gap, launches={k: v for k, v in
                                           launches.items() if v})
    emit(phase="bf16", part="check", streams=N_STREAMS, frames=SLICE_T,
         points=N_MAX, vs_cpu_bf16_scan=checks,
         clustered_points=int((cpu["labels"] >= 0).sum()),
         live_tracks=int((cpu["track_id"] >= 0).sum()), cpu_seconds=cpu_s)
    kept.update({k: v for k, v in checks["scan"]["launches"].items()})
    del cpu, gpu

    # (b), (c) at 8 x 32, float32 and bfloat16 in turns
    frames = make_frames(torch, seed + 100, SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    f32 = model_on(dev, torch.float32)
    for part, make in (("scan", make_scan_eval_step_cached),
                       ("pipelined", make_pipelined_eval_step)):
        res = paired_scans(torch, [("float32", make(f32)),
                                   ("bfloat16", make(model))], state0, frames)
        if res["bfloat16"]["launches"] != as_bf16(
                expected_launches(SCAN_T) if part == "scan"
                else expected_pipelined_launches()):
            record_failure(f"bf16 {part} 8 x {SCAN_T} launch counts "
                           f"{res['bfloat16']['launches']}")
        emit(phase="bf16", part=f"{part}_throughput", streams=N_STREAMS,
             frames_per_stream=SCAN_T, points=N_MAX,
             sinkhorn_iters=SINKHORN_ITERS,
             **{dt: {k: v for k, v in r.items() if k != "launches"}
                for dt, r in res.items()},
             bfloat16_launches={k: v for k, v in
                                res["bfloat16"]["launches"].items() if v},
             card=card)
    del frames, f32, model

    # (d) one stretch frame at 8192 points: B5 and B4 on the split path
    smodel = Track4D(npoint=STRETCH_NPOINT, k_max=K_MAX,
                     sinkhorn_iters=SINKHORN_ITERS, exact_fps=True,
                     mov_budget=512, sinkhorn_kernel=True, dtype=bf,
                     generator=torch.Generator().manual_seed(seed),
                     device="cpu")
    sframes = stretch_frames(torch, seed, 1, "cpu", STRETCH_N)
    scan = make_scan_eval_step_cached(smodel)
    t0 = time.perf_counter()
    _, cpu = scan(init_state(1, K_MAX, device="cpu"), sframes)
    cpu_s = time.perf_counter() - t0
    smodel.to(dev)
    reset_counters()
    _, gpu = scan(init_state(1, K_MAX, device=dev),
                  FrameBatch(*[x.to(dev) for x in sframes]))
    torch.cuda.synchronize()
    launches = read_counters()
    want = as_bf16(expected_stretch_launches(1))
    if launches != want:
        record_failure(f"bf16 stretch launch counts {launches}, expected "
                       f"{want}")
    gap = bf16_gap(torch, gpu, cpu, sframes.pc1, sframes.mask1)
    bf16_gap_gate("bf16 stretch frame vs the CPU", gap)
    emit(phase="bf16", part="stretch_frame", points=STRETCH_N, streams=1,
         frames=1, vs_cpu=gap, launches={k: v for k, v in launches.items()
                                         if v}, cpu_seconds=cpu_s)
    kept["knn_gather_apply_bf16"] = launches["knn_gather_apply_bf16"]
    del smodel, cpu, gpu

    # (e) the general SA levels in bfloat16: B1' on the card
    pc1, m1, _, _ = cases.clouds(seed, N_STREAMS, N_MAX)
    gen = torch.Generator().manual_seed(seed + 4)
    c_feat = cases.GENERAL_LEVELS["one_scale"][3]
    feats = torch.randn((N_STREAMS, N_MAX, c_feat), generator=gen)
    kept["sa_scale_bf16"] = 0
    for level, (radii, *_rest) in cases.GENERAL_LEVELS.items():
        out = {}
        for device in ("cpu", dev):
            mod = general_level(torch, level, seed + 5, torch.float32,
                                device, compute_dtype=bf)
            reset_counters()
            with torch.no_grad():
                out[str(device)] = mod(pc1.to(device), feats.to(device),
                                       m1.to(device))[1].float().cpu()
            torch.cuda.synchronize()
        launches = read_counters()
        n_scales = len(radii)
        want = as_bf16({**{k: 0 for k in counters()},
                        **({"sa_pair": 1} if n_scales == 2
                           else {"sa_scale": n_scales})})
        if launches != want:
            record_failure(f"bf16 general level {level}: launch counts "
                           f"{launches}, expected {want}")
        kept["sa_scale_bf16"] += launches["sa_scale_bf16"]
        got, ref = out[str(dev)], out["cpu"]
        err = (got - ref).abs().max().item()
        tol = 2.0 ** -8 * ref.abs().max().item() + 1e-5
        if not err <= tol:
            record_failure(f"bf16 general level {level}: err {err} > {tol}")
        emit(phase="bf16", part="general_level", level=level,
             scales=n_scales, max_abs_err=err, tol=tol,
             launches={k: v for k, v in launches.items() if v})

    # (f) serving a bfloat16 model: RadarTracker on the card and the CPU
    import numpy as np
    from ratrack_tpu_torch.serve import RadarTracker
    scans = [serve_scans(seed + 400 + s, SERVE_SCANS)
             for s in range(N_STREAMS)]
    served = {}
    for device in ("cpu", dev):
        svc = RadarTracker(model_on(device, bf), n_max=N_MAX,
                           max_streams=N_STREAMS)
        sids = [svc.open_stream() for _ in range(N_STREAMS)]
        reset_counters()
        outs = []
        for t in range(SERVE_SCANS + 1):
            for sid in sids:
                svc.submit(sid, scans[sid][t])
            res = svc.step()
            outs += [res[sid] for sid in sids] if t > 0 else []
        served[str(device)] = outs
    launches = read_counters()
    want = as_bf16({**{k: 0 for k in counters()}, "sa_pair": 9 * SERVE_SCANS,
                    "three_interpolate": 9 * SERVE_SCANS,
                    "knn_weight_aggregate": 2 * SERVE_SCANS,
                    "dbscan_labels": SERVE_SCANS})
    if launches != want:
        record_failure(f"bf16 serving launch counts {launches}, expected "
                       f"{want}")
    got, ref = served[str(dev)], served["cpu"]
    labels = [torch.from_numpy(np.stack([o.labels for o in outs]))
              for outs in (got, ref)]
    flow_err = [float(np.abs(g.flow - c.flow)[:g.n_points].mean())
                for g, c in zip(got, ref)]
    gap = dict(
        label_mismatch=int((labels[0] != labels[1]).sum()),
        clustered_apart=partition_mismatch(*labels),
        track_id_mismatch=sum(int((g.track_id != c.track_id).sum())
                              for g, c in zip(got, ref)),
        flow_mean_abs_err=float(np.mean(flow_err)),
        finite=all(np.isfinite(g.flow).all() for g in got))
    if (not gap["finite"] or gap["flow_mean_abs_err"] > 0.05
            or gap["clustered_apart"] > 0.01 * labels[0].numel()):
        record_failure(f"bf16 serving vs the CPU: {gap}")
    emit(phase="bf16", part="serving", streams=N_STREAMS, scans=SERVE_SCANS,
         vs_cpu=gap, launches={k: v for k, v in launches.items() if v})
    return summary, {k: kept.get(k, 0) for k in BF16_KERNELS}


def bf16_train_run(torch, seed: int, device: str, dtype, n_frames: int,
                   perturb: float = 0.0):
    """Track4D(npoint=512, k_max=32) from the seed computing in `dtype`
    (float32 parameters) trained on `device` over N_STREAMS synthetic
    streams x n_frames, one frame a scan call -> per-frame loss items, the
    first step's gradient and running statistics (float64 on the CPU), the
    launch counts and seconds of the run. perturb: the weights multiplied
    by 1 + perturb * N(0, 1) before training (how far a float32-sized
    difference moves the run)."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    dev = torch.device(device)
    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    dtype=dtype, generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    if perturb:
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for prm in model.parameters():
                prm.mul_(1.0 + perturb * torch.randn(prm.shape,
                                                     generator=gen))
    scan = make_scan_train_step(create_train_state(
        model, TrainConfig(), steps_per_epoch=100, device=dev))
    frames = make_frames(torch, seed + 7, n_frames, dev)
    state = init_state(N_STREAMS, K_MAX, device=dev)
    items = []
    reset_counters()
    t0 = time.perf_counter()
    for t in range(n_frames):
        state, it = scan(state, FrameBatch(*[x[:, t:t + 1] for x in frames]),
                         False)
        items.append({k: v[0].double().cpu() for k, v in it.items()})
        if t == 0:
            grads = {n: prm.grad.detach().double().cpu()
                     for n, prm in model.named_parameters()}
            stats = {n: b.double().cpu() for n, b in model.named_buffers()
                     if b.is_floating_point()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(items=items, grads=grads, stats=stats,
                launches=read_counters(), seconds=time.perf_counter() - t0)


def bf16_rule(torch, got, cpus, f32, rel: float):
    """The bfloat16 yardstick of tests/test_torch_port_bf16_train.py on
    {name: tensor} dicts (and on all of each together, "all"): each
    |got - f32| <= rel |f32 (all)| + 2 max |cpu - f32| over the CPU's
    bfloat16 runs `cpus`, the CPU's own bfloat16 error the allowance ->
    {name: err / bound}."""
    def flat(d):
        return torch.cat([d[n].double().flatten() for n in sorted(f32)])
    total = flat(f32).norm().item()
    ratios = {}
    for name in list(f32) + ["all"]:
        def pick(d):
            return flat(d) if name == "all" else d[name].double()
        f = pick(f32)
        e_got = (pick(got) - f).norm().item()
        e_cpu = max((pick(c) - f).norm().item() for c in cpus)
        ratios[name] = e_got / (rel * total + 2 * e_cpu + 1e-12)
    return ratios


def cosine(a, b):
    return float((a * b).sum() / (a.norm() * b.norm() + 1e-300))


def phase_bf16_train(torch, seed: int, card: str, tmp: str):
    """Phase 20: training in bfloat16 (see the module docstring)."""
    bf = torch.bfloat16
    dev = torch.device("cuda")

    # (a) the card against the CPU, 8 streams x BF16_TRAIN_T frames. A
    # bfloat16 cls of 0.998 or more rounds to 1.0, and the reference's BCE
    # then gives a NaN gradient (ROADMAP, reproduced on purpose): the
    # leaves it reaches must be the same on the card, and the others are
    # held to the float32 run by the CPU's own bfloat16 error.
    cpu = bf16_train_run(torch, seed, "cpu", bf, BF16_TRAIN_T)
    f32 = bf16_train_run(torch, seed, "cpu", torch.float32, BF16_TRAIN_T)
    moved = bf16_train_run(torch, seed, "cpu", bf, 1,
                           perturb=BF16_TRAIN_PERTURB)
    gpu = bf16_train_run(torch, seed, "cuda", bf, BF16_TRAIN_T)
    want = expected_train_launches(BF16_TRAIN_T)
    if gpu["launches"] != want:
        record_failure(f"bf16 train launch counts {gpu['launches']}, "
                       f"expected {want} (the float32 step's)")

    def nan_leaves(run):
        return sorted(n for n, g in run["grads"].items()
                      if not bool(torch.isfinite(g).all()))
    nan_gpu, nan_cpu = nan_leaves(gpu), nan_leaves(cpu)
    if nan_gpu != nan_cpu or nan_leaves(f32):
        record_failure(f"bf16 train: NaN gradient leaves differ: card "
                       f"{len(nan_gpu)}, CPU {len(nan_cpu)}, float32 "
                       f"{len(nan_leaves(f32))}")
    losses = []
    for t, (g, c, f) in enumerate(zip(gpu["items"], cpu["items"],
                                      f32["items"])):
        keys = sorted(f)
        vec = [torch.cat([d[k] for k in keys]) for d in (g, c, f)]
        # the largest float: a stream whose BCE was infinite
        sat = [v.abs() >= 1e30 for v in vec[:2]]
        if not torch.equal(*sat):
            record_failure(f"bf16 train frame {t}: saturated loss items "
                           f"differ: card {sat[0].tolist()}, CPU "
                           f"{sat[1].tolist()}")
        keep = ~(sat[0] | sat[1])
        if t == 0:
            err = ((vec[0] - vec[1]).abs() / vec[1].abs().clamp_min(1e-6)
                   )[keep].max().item()
            ok = err <= 2e-2
        else:
            err = bf16_rule(torch, {"l": vec[0][keep]}, [{"l": vec[1][keep]}],
                            {"l": vec[2][keep]}, 2e-2)["all"]
            ok = err <= 1.0
        if not ok:
            record_failure(f"bf16 train frame {t} losses: {err}")
        losses.append({"frame": t, "check": err,
                       "saturated_items": int(sat[0].sum()),
                       **{k: g[k].tolist() for k in keys}})
    finite = [n for n in sorted(f32["grads"]) if n not in nan_gpu + nan_cpu
              + nan_leaves(moved)]
    grad_ratio = bf16_rule(
        torch, {n: gpu["grads"][n] for n in finite},
        [{n: r["grads"][n] for n in finite} for r in (cpu, moved)],
        {n: f32["grads"][n] for n in finite}, 1e-2)
    stat_ratio = bf16_rule(torch, gpu["stats"], [cpu["stats"],
                                                 moved["stats"]],
                           f32["stats"], 1e-4)["all"]

    def flat(r):
        return torch.cat([r["grads"][n].flatten() for n in finite])
    g_gpu, g_cpu, g_f32, g_moved = (flat(r) for r in (gpu, cpu, f32, moved))
    total = g_f32.norm().item()
    dist = {"card_cpu": (g_gpu - g_cpu).norm().item() / total,
            "cpu_f32": (g_cpu - g_f32).norm().item() / total,
            "card_f32": (g_gpu - g_f32).norm().item() / total,
            "cpu_perturbed": (g_moved - g_cpu).norm().item() / total}
    cos = {"card_cpu": cosine(g_gpu, g_cpu), "cpu_f32": cosine(g_cpu, g_f32),
           "card_f32": cosine(g_gpu, g_f32),
           "perturbed_f32": cosine(g_moved, g_f32),
           "cpu_perturbed": cosine(g_moved, g_cpu)}
    angle = {k: math.degrees(math.acos(min(1.0, v))) for k, v in cos.items()}
    worst = max((v, k) for k, v in grad_ratio.items())
    checks = {
        "grad_vs_f32": worst[0] <= 1.0,
        "angle_vs_f32": angle["card_f32"] <= 2 * max(
            angle["cpu_f32"], angle["perturbed_f32"]),
        "grad_vs_cpu": dist["card_cpu"] <= 1e-2
        + 2 * dist["cpu_perturbed"],
        "stats_vs_f32": stat_ratio <= 1.0}
    for name, ok in checks.items():
        if not ok:
            record_failure(f"bf16 train gradient check {name}: worst leaf "
                           f"{worst}, distances {dist}, cosines {cos}, "
                           f"statistics {stat_ratio}")
    emit(phase="bf16_train", part="card_vs_cpu", streams=N_STREAMS,
         frames=BF16_TRAIN_T, points=N_MAX, losses=losses,
         nan_grad_leaves=len(nan_gpu), finite_grad_leaves=len(finite),
         grad_leaves=len(f32["grads"]), nan_leaves_first=nan_gpu[:3],
         grad_distance_of_norm=dist, grad_cosine=cos, grad_angle_deg=angle,
         grad_worst_leaf=dict(err_over_bound=worst[0], at=worst[1]),
         stats_err_over_bound=stat_ratio, perturb=BF16_TRAIN_PERTURB,
         checks=checks, launches={k: v for k, v in gpu["launches"].items()
                                  if v},
         cpu_seconds=cpu["seconds"], gpu_seconds=gpu["seconds"])

    # (b) the general SA levels (B8) in one bfloat16 train step
    from ratrack_tpu_torch.kernels import cases
    pc1, m1, _, _ = cases.clouds(seed, N_STREAMS, N_MAX)
    gen = torch.Generator().manual_seed(seed + 4)
    c_feat = cases.GENERAL_LEVELS["one_scale"][3]
    feats = torch.randn((N_STREAMS, N_MAX, c_feat), generator=gen)
    zero = {k: 0 for k in counters()}

    def level_step(level, device, compute):
        mod = general_level(torch, level, seed + 5, torch.float32, device,
                            compute)
        mod.train().requires_grad_(True)
        f = feats.to(device=device, dtype=compute).clone().requires_grad_(
            True)
        out = mod(pc1.to(device), f, m1.to(device))[1]
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            seed + 6)).to(device)
        (out.float() * cot).sum().backward()
        res = {"out": out.detach().float().cpu(),
               "features": f.grad.float().cpu(),
               **{n: prm.grad.cpu() for n, prm in mod.named_parameters()},
               **{n: b.detach().cpu() for n, b in mod.named_buffers()}}
        return res

    b8 = {"sa_scale_train_fwd": 0, "sa_scale_train_bwd": 0}
    for level, (radii, *_rest) in cases.GENERAL_LEVELS.items():
        want = level_step(level, "cpu", bf)
        truth = level_step(level, "cpu", torch.float32)
        reset_counters()
        got = level_step(level, dev, bf)
        torch.cuda.synchronize()
        launches = read_counters()
        n = len(radii)
        expect = {**zero, "sa_scale_train_fwd": n, "sa_scale_train_bwd": n}
        if launches != expect:
            record_failure(f"bf16 general level {level}: launch counts "
                           f"{launches}, expected {expect}")
        for k in b8:
            b8[k] += launches[k]
        scale = truth["out"].abs().max().item()
        e_out = (got["out"] - truth["out"]).abs().max().item()
        e_cpu = (want["out"] - truth["out"]).abs().max().item()
        ratios = bf16_rule(torch, got, [want], truth, 1e-3)
        worst = max((v, k) for k, v in ratios.items())
        if (e_out > 2.0 ** -8 * scale + 2 * e_cpu + 1e-5 or worst[0] > 1.0
                or not all(bool(torch.isfinite(v).all())
                           for v in got.values())):
            record_failure(f"bf16 general level {level}: out err {e_out} "
                           f"(CPU {e_cpu}, max {scale}), worst {worst}")
        emit(phase="bf16_train", part="general_level", level=level,
             scales=n, out_max_abs_err=e_out, cpu_out_max_abs_err=e_cpu,
             worst_err_over_bound=worst[0], worst_at=worst[1],
             launches={k: v for k, v in launches.items() if v})

    # (c) train scan 8 x 32, float32 and bfloat16 in turns
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    frames = make_frames(torch, seed + 200, TRAIN_SCAN_T, dev)
    state0 = init_state(N_STREAMS, K_MAX, device=dev)
    steps, models = [], []
    for name, dtype in (("float32", torch.float32), ("bfloat16", bf)):
        model = Track4D(npoint=N_MAX, k_max=K_MAX,
                        sinkhorn_iters=SINKHORN_ITERS, dtype=dtype,
                        generator=torch.Generator().manual_seed(seed),
                        device=dev)
        scan = make_scan_train_step(create_train_state(
            model, TrainConfig(), steps_per_epoch=100, device=dev))
        steps.append((name, lambda s, f, scan=scan: scan(s, f, False)))
        models.append(model)
    turns = paired_scans(torch, steps, state0, frames)
    for (name, _), model in zip(steps, models):
        turns[name]["nan_params_after"] = sum(
            int((~torch.isfinite(prm)).sum()) for prm in model.parameters())
    for name, entry in turns.items():
        if entry["launches"] != expected_train_launches(TRAIN_SCAN_T):
            record_failure(f"bf16 train throughput {name}: launch counts "
                           f"{entry['launches']}")
        entry["launches"] = {k: v for k, v in entry["launches"].items()
                             if v}
        entry["ms_per_frame"] = [1000.0 / x for x in entry["frames_per_s"]]
    emit(phase="bf16_train", part="throughput", streams=N_STREAMS,
         frames_per_stream=TRAIN_SCAN_T, turns="a b b a", **turns,
         bf16_over_f32=[b / a for a, b in zip(
             turns["float32"]["frames_per_s"],
             turns["bfloat16"]["frames_per_s"][::-1])], card=card)

    # (d) the CLI: configs/synth_train.yaml, 1 epoch, dtype bfloat16
    from ratrack_tpu_torch.config import Config
    from ratrack_tpu_torch.models import model_from_config
    from ratrack_tpu_torch.train import checkpoint as ckpt
    import yaml
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "synth_train.yaml")) as f:
        train_cfg = {**yaml.safe_load(f), **BF16_CLI_CUTS,
                     "exp_name": "bf16_train",
                     "checkpoints_dir": os.path.join(tmp, "checkpoints"),
                     "results_dir": os.path.join(tmp, "results")}
    reset_counters()
    t0 = time.time()
    (ep,) = run_cli(train_cfg, tmp, "bf16_train")[0]["train"]
    launches = read_counters()
    want = expected_train_launches(ep["frames"] // train_cfg["dp"])
    if launches != want:
        record_failure(f"bf16 cli train launch counts {launches}, expected "
                       f"{want}")
    items = {k: ep[k] for k in ("Loss", "SceneFlowLoss", "SegLoss",
                                "TrackingLoss")}
    if not all(math.isfinite(v) for v in items.values()):
        record_failure(f"bf16 cli train losses {items}")
    models_dir = os.path.join(tmp, "checkpoints", "bf16_train", "models")
    saved = torch.load(os.path.join(models_dir, "last.pt"),
                       map_location="cpu", weights_only=True)["model"]
    restored = {}
    for dtype in ("bfloat16", "float32"):
        fields = {k: v for k, v in train_cfg.items()
                  if k in Config.__dataclass_fields__}
        model = model_from_config(Config(**{**fields, "dtype": dtype}),
                                  device=dev)
        ckpt.restore_model(models_dir, "last", model)
        # equal to the file, NaN where the file has NaN
        restored[dtype] = all(
            bool(((a.cpu() == saved[n]) | (a.cpu().isnan()
                                           & saved[n].isnan())).all())
            for n, a in model.state_dict().items())
    if not all(restored.values()):
        record_failure(f"bf16 cli checkpoint restore: {restored}")
    nan_params = sum(int(v.isnan().sum()) for v in saved.values()
                     if v.is_floating_point())
    emit(phase="bf16_train", part="cli", config="configs/synth_train.yaml",
         cuts={**BF16_CLI_CUTS, "checkpoints_dir": "<tmp>"},
         streams=train_cfg["dp"], frames_per_scan=train_cfg["scan_frames"],
         frames=ep["frames"], frames_per_s=ep["fps"], losses=items,
         restored=restored, nan_params_saved=nan_params,
         launches={k: v for k, v in launches.items() if v},
         seconds=time.time() - t0, card=card)

    # (e) the visualisers: the eval CLI's vis_dir (matplotlib, where the
    # machine has it) and the 3D scene of a VoD fixture frame (numpy)
    from ratrack_tpu_torch.data.fixture import make_vod_fixture
    from ratrack_tpu_torch.utils import vis3d
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("matplotlib is absent: the eval CLI's vis_dir is not rendered",
              flush=True)
    else:
        # the seeded weights (the bfloat16 run's may be NaN, see (a))
        with open(os.path.join(here, "configs", "synth_eval.yaml")) as f:
            eval_cfg = {**yaml.safe_load(f), "synth_frames": CLI_CUT_FRAMES,
                        "load_checkpoint": False, "exp_name": "vis",
                        "checkpoints_dir": os.path.join(tmp, "checkpoints"),
                        "results_dir": os.path.join(tmp, "vis_results"),
                        "vis_dir": os.path.join(tmp, "vis")}
        t0 = time.time()
        ev = run_cli(eval_cfg, tmp, "bf16_vis")[0]["eval"]
        pngs = sorted(os.path.relpath(os.path.join(d, n), eval_cfg["vis_dir"])
                      for d, _, names in os.walk(eval_cfg["vis_dir"])
                      for n in names)
        if len(pngs) != ev["frames"] or not pngs:
            record_failure(f"vis_dir: {len(pngs)} PNGs for {ev['frames']} "
                           f"frames")
        emit(phase="bf16_train", part="vis_dir", frames=ev["frames"],
             pngs=len(pngs), first=pngs[:1], seconds=time.time() - t0)
    root = os.path.join(tmp, "vod_vis")
    make_vod_fixture(root, range(0, 2))
    html = os.path.join(tmp, "scene.html")
    vis3d.main(["--dataset", root, "--frame", "00001", "--out", html,
                "--lidar", "--velocity"])
    scene = vis3d.parse_scene_html(html)
    if [p["name"] for p in scene["points"]] != ["lidar", "radar"]:
        record_failure(f"vis3d scene: {[p['name'] for p in scene['points']]}")
    emit(phase="bf16_train", part="vis3d", points=[
        len(p["xyz"]) // 3 for p in scene["points"]],
         line_sets=len(scene["lines"]), html_bytes=os.path.getsize(html))
    return b8



def dp_worlds(count: int):
    """Phase 21's runs as (backend, ranks, cards): with two cards or more
    one NCCL rank a card, as many as divide the 8 streams (4 or 2); on one
    card a NCCL rank alone and two gloo ranks sharing it."""
    if count >= 2:
        w = 4 if count >= 4 else 2
        return [("nccl", w, w)]
    return [("nccl", 1, 1), ("gloo", 2, 1)]


def dp_model(torch, seed: int, dev, mesh=None, perturb: float = 0.0):
    """The seeded 512-point model in training on `dev` (each weight moved
    by `perturb` relative noise where that is not 0), replicated over
    `mesh` where one is given -> (train state, scan)."""
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.parallel import replicate
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         make_scan_train_step)
    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed), device=dev)
    if perturb:
        noise = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + perturb * torch.randn(p.shape, generator=noise)
                       .to(dev))
    ts = create_train_state(model, TrainConfig(), steps_per_epoch=100,
                            device=dev)
    if mesh is not None:
        replicate(mesh, ts)
    return ts, make_scan_train_step(ts, mesh)


def dp_train(torch, seed: int, dev, mesh=None, perturb: float = 0.0):
    """make_scan_train_step over N_STREAMS streams x DP_T frames on `dev`,
    sharded over `mesh` where one is given (the weights moved by `perturb`,
    see dp_model), one scan call a frame -> loss
    items of each frame (gathered), frame 0's gradients and BN statistics
    (float64, on the CPU), each frame's collectives, the kernel launches
    of the whole run and the parameters after it."""
    from ratrack_tpu_torch.data import FrameBatch
    from ratrack_tpu_torch.parallel import (count_collectives, gather_clips,
                                            shard_clips)
    from ratrack_tpu_torch.tracker import init_state
    ts, scan = dp_model(torch, seed, dev, mesh, perturb)
    frames = make_frames(torch, seed + 7, DP_T, dev)
    state = init_state(N_STREAMS, K_MAX, device=dev)
    if mesh is not None:
        frames, state = shard_clips(mesh, frames), shard_clips(mesh, state)
    out = {"items": [], "collectives": []}
    reset_counters()
    for t in range(DP_T):
        with count_collectives() as counts:
            state, items = scan(state, FrameBatch(*[x[:, t:t + 1]
                                                    for x in frames]), False)
        out["collectives"].append(dict(counts))
        items = {k: v[0] for k, v in items.items()}
        if mesh is not None:
            items = gather_clips(mesh, items)
        out["items"].append({k: v.double().cpu() for k, v in items.items()})
        if t == 0:
            out["grads"] = {n: p.grad.double().cpu()
                            for n, p in ts.model.named_parameters()}
            out["stats"] = {n: b.double().cpu()
                            for n, b in ts.model.named_buffers()}
    torch.cuda.synchronize()
    out["launches"] = read_counters()
    out["params"] = torch.cat([p.detach().flatten().cpu()
                               for p in ts.model.parameters()])
    return out


def dp_eval(torch, seed: int, dev, mesh=None):
    """The cached eval scan of the seeded model over N_STREAMS streams x
    SLICE_T frames on `dev`, sharded over `mesh` where one is given ->
    outputs (gathered, on the CPU), the scan's collectives, its kernel
    launches."""
    from ratrack_tpu_torch.models import Track4D
    from ratrack_tpu_torch.parallel import (count_collectives, gather_clips,
                                            shard_clips)
    from ratrack_tpu_torch.tracker import init_state
    from ratrack_tpu_torch.train import make_scan_eval_step_cached
    model = Track4D(npoint=N_MAX, k_max=K_MAX, sinkhorn_iters=SINKHORN_ITERS,
                    generator=torch.Generator().manual_seed(seed), device=dev)
    frames = make_frames(torch, seed + 3, SLICE_T, dev)
    state = init_state(N_STREAMS, K_MAX, device=dev)
    if mesh is not None:
        frames, state = shard_clips(mesh, frames), shard_clips(mesh, state)
    reset_counters()
    with count_collectives() as counts:
        _, outs = make_scan_eval_step_cached(model, mesh)(state, frames)
    torch.cuda.synchronize()
    launches = read_counters()
    if mesh is not None:
        outs = gather_clips(mesh, outs)
    return {"outs": {k: v.cpu() for k, v in outs.items()},
            "collectives": dict(counts), "launches": launches}


def dp_speed(torch, seed: int, dev, mesh):
    """(b): the train scan over TRAIN_SCAN_T frames, in turns w1 wn ww ww
    wn w1 after a warm-up of each: w1 N_STREAMS streams on rank 0 without
    a mesh (the others wait), wn the same N_STREAMS streams sharded over
    the ranks, ww N_STREAMS streams a rank (N_STREAMS x dp in all); each
    time from the barrier before to the barrier after, so the slowest
    rank counts -> the seconds and peak memory of each."""
    import torch.distributed as dist
    from ratrack_tpu_torch.parallel import shard_clips
    from ratrack_tpu_torch.tracker import init_state
    _, scan_s = dp_model(torch, seed, dev, mesh)
    scan_u = dp_model(torch, seed, dev)[1] if mesh.rank == 0 else None
    runs = {}
    for key, streams in (("w1", N_STREAMS), ("wn", N_STREAMS),
                         ("ww", N_STREAMS * mesh.dp)):
        args = (init_state(streams, K_MAX, device=dev),
                make_frames(torch, seed + 200, TRAIN_SCAN_T, dev,
                            streams=streams))
        if key == "w1":
            runs[key] = (scan_u, args)
        else:
            runs[key] = (scan_s, shard_clips(mesh, args))
    out = {f"{k}_{m}": [] for k in runs for m in ("s", "peak_gib")}

    def run(key, timed=True):
        scan, args = runs[key]
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if scan is not None:
            scan(*args, False)
        torch.cuda.synchronize()
        dist.barrier()
        if timed:
            out[key + "_s"].append(time.perf_counter() - t0)
            out[key + "_peak_gib"].append(
                torch.cuda.max_memory_allocated() / 2 ** 30)

    for key in runs:
        run(key, timed=False)                           # warm-ups
    for key in ("w1", "wn", "ww", "ww", "wn", "w1"):
        run(key)
    return out


def dp_rank(rank: int, root: str, backend: str, world: int, seed: int,
            speed: bool):
    """One rank of phase 21, spawned by torch.multiprocessing (or, for a
    world of one, called in this process): joins the group (NCCL, one card
    a rank; or gloo, every rank on card 0), runs
    (a) and, where `speed`, (b), and saves what it measured to
    <root>/rank<rank>.pt."""
    import torch
    import torch.distributed as dist
    from ratrack_tpu_torch.parallel import init_from_env, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank if backend == "nccl" else 0)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rendezvous = f"file://{root}/rendezvous"
    try:
        if backend == "nccl":
            init_from_env(init_method=rendezvous)
        else:
            torch.cuda.set_device(0)
            init_from_env("cpu", init_method=rendezvous)
        try:
            mesh = make_mesh()
            dev = torch.device("cuda", torch.cuda.current_device())
            out = {"devices": mesh.devices,
                   "train": dp_train(torch, seed, dev, mesh),
                   "eval": dp_eval(torch, seed, dev, mesh)}
            if speed:
                out["speed"] = dp_speed(torch, seed, dev, mesh)
        finally:
            dist.destroy_process_group()
    finally:              # a rank run in this process leaves no torchrun env
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))


def dp_distance(a, b):
    """How far run b is from run a at frame 0: loss items (the largest
    |b - a| / |a| over the items, in norm over the streams), gradient
    leaves (the largest |b - a| over the whole gradient's norm |G|), BN
    statistics (the largest |b - a| / |a| over the buffers) -> ({check:
    distance}, {check: where})."""
    import torch
    total = torch.cat([g.flatten() for g in a["grads"].values()]).norm()
    parts = dict(
        items={k: ((b["items"][0][k] - v).norm() / v.norm()).item()
               for k, v in a["items"][0].items()},
        grads={n: ((b["grads"][n] - g).norm() / total).item()
               for n, g in a["grads"].items()},
        stats={n: ((b["stats"][n] - s).norm() / s.norm()).item()
               for n, s in a["stats"].items()})
    at = {k: max(v, key=v.get) for k, v in parts.items()}
    return {k: parts[k][at[k]] for k in parts}, at


def dp_cli(torch, card: str, tmp: str, world: int, dev):
    """(c): the train CLI under torchrun, `world` ranks on the card (NCCL),
    over configs/synth_train.yaml cut to DP_CLI_CUTS, against the
    one-process CLI on the same config in this process."""
    import yaml
    from ratrack_tpu_torch.config import load_config
    from ratrack_tpu_torch.models import model_from_config
    from ratrack_tpu_torch.train import (create_train_state,
                                         restore_train_state)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "synth_train.yaml")) as f:
        cfg = {**yaml.safe_load(f), **DP_CLI_CUTS,
               "checkpoints_dir": os.path.join(tmp, "checkpoints"),
               "results_dir": os.path.join(tmp, "results")}
    if cfg["dp"] % world:
        fail(f"dp cli: dp {cfg['dp']} does not divide over {world} ranks")
    path = os.path.join(tmp, "dp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({**cfg, "exp_name": "dp"}, f)
    with socket.socket() as sock:                 # a free port for rank 0
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
         f"--nproc_per_node={world}", "--master_addr=127.0.0.1",
         f"--master_port={port}", "-m", "ratrack_tpu_torch.main",
         "--config", path], cwd=here,
        env={**os.environ, "PYTHONPATH": here}, capture_output=True,
        text=True, timeout=600)
    dp_seconds = time.time() - t0
    if run.returncode != 0:
        fail(f"dp cli: torchrun exited {run.returncode}:\n"
             f"{run.stderr[-4000:]}")
    t0 = time.time()
    one = run_cli({**cfg, "exp_name": "one"}, tmp, "dp_one")[0]["train"][0]
    one_seconds = time.time() - t0

    def history(name):
        with open(os.path.join(tmp, "checkpoints", name,
                               "loss_history.csv")) as f:
            head, *rows = f.read().strip().splitlines()
        return head, [[float(x) for x in r.split(",")] for r in rows]
    (head, got), (want_head, want) = history("dp"), history("one")
    rel = max(abs(g - w) / max(abs(w), 1e-5) for g, w in zip(got[0], want[0]))
    models = os.path.join(tmp, "checkpoints", "dp", "models")
    found = sorted(os.listdir(models))
    with open(os.path.join(tmp, "checkpoints", "dp", "run.log")) as f:
        log = f.read()
    ts = create_train_state(model_from_config(load_config(path), device=dev),
                            load_config(path), steps_per_epoch=1, device=dev)
    restore_train_state(models, "last", ts)
    steps = one["frames"] // cfg["dp"]        # one optimizer step a frame
    finite = all(bool(torch.isfinite(p).all())
                 for p in ts.model.parameters())
    emit(phase="dp", part="cli", config="configs/synth_train.yaml",
         cuts=DP_CLI_CUTS, ranks=world, backend="nccl", streams=cfg["dp"],
         loss_dp=dict(zip(head.split(",")[1:], got[0][1:])),
         loss_one=dict(zip(want_head.split(",")[1:], want[0][1:])),
         max_rel_err=rel, tolerance=2e-2, checkpoints=found,
         restored_step=ts.step, run_log=[line for line in log.splitlines()
                                         if line.startswith(("mesh:",
                                                             "[train"))],
         dp_seconds=dp_seconds, one_process_seconds=one_seconds, card=card)
    if head != want_head or len(got) != len(want) or rel > 2e-2:
        record_failure(f"dp cli: loss history {got} against {want}")
    if found != ["best.pt", "last.pt", "last0.pt"]:
        record_failure(f"dp cli: checkpoints {found}")
    if log.count("FINISH") != 1 or "mesh: dp=" not in log:
        record_failure("dp cli: run.log has not one rank's mesh line and "
                       "FINISH")
    if ts.step != steps or not finite:
        record_failure(f"dp cli: restored step {ts.step} (expected {steps}),"
                       f" finite {finite}")


def flot_model(torch, seed: int, device):
    """FLOT built from configs/flot_8192.yaml with seeded weights, and
    epsilon = ln 0.05, gamma = 0 (eps 0.08, gamma 1) as the benchmark sets
    them: a plan that separates features, so the flow sees the cost."""
    from ratrack_tpu_torch.config import load_config
    from ratrack_tpu_torch.models import model_from_config
    here = os.path.dirname(os.path.abspath(__file__))
    model = model_from_config(load_config(os.path.join(here, FLOT_CONFIG)),
                              generator=torch.Generator().manual_seed(seed),
                              device=device)
    model.epsilon.fill_(math.log(0.05))
    model.gamma.fill_(0.0)
    return model


def flot_frames(torch, seed: int, streams: int, t: int, device):
    """The FLOT cell's clouds: FLOT_N points all valid (5 objects of 12)."""
    return make_frames(torch, seed, t, device, FLOT_N, streams, FLOT_N - 60)


def phase_flot(torch, seed: int, card: str):
    """Phase 22: B5 at k = 32 and B11 on the main path's inputs against
    their plain versions; FLOT's scan on the card against the CPU's, with
    its launch counts; the timed scan at the cell's shape."""
    from ratrack_tpu_torch.data import to_tensors
    from ratrack_tpu_torch.kernels import cases
    from ratrack_tpu_torch.ops import fused_knn, fused_transport
    from ratrack_tpu_torch.train.step import make_scan_flow_step_cached

    dev = torch.device("cuda")
    summary = new_summary(("transport_flow", "knn_graph"))
    model = flot_model(torch, seed, dev)
    frames = flot_frames(torch, seed + 22, FLOT_STREAMS, 1, dev)
    pc1 = frames.pc1[:, 0].contiguous()
    pc2 = frames.pc2[:, 0].contiguous()

    def check_graph(got, want):
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        if not same:
            fail(f"knn_tiled k={FLOT_K}: indices, keys or validity differ "
                 f"from the plain version")
        return 0.0, 0.0

    graph = dict(query=pc1, points=pc1, points_mask=None, k=FLOT_K)
    runs = [dict(
        kernel="knn_graph", config=f"{FLOT_STREAMS}x{FLOT_N}.k{FLOT_K}",
        run_k=lambda: fused_knn.knn_indices_tiled(pc1, pc1, k=FLOT_K,
                                                  return_keys=True),
        run_p=lambda: fused_knn.knn_indices_tiled_reference(pc1, pc1,
                                                            k=FLOT_K),
        check=check_graph,
        work=lambda got: cases.knn_tiled_work(graph, got[0], got[1]),
        # one library selection: the top 32 of the dense distance matrix
        library=lambda: torch.topk(torch.cdist(pc1, pc1), FLOT_K, dim=-1,
                                   largest=False))]

    with torch.inference_mode():
        f1 = model.features(pc1, model.graph(pc1))
        f2 = model.features(pc2, model.graph(pc2))
        f1 = f1 / torch.sqrt(torch.sum(f1 ** 2, -1, keepdim=True) + 1e-8)
        f2 = f2 / torch.sqrt(torch.sum(f2 ** 2, -1, keepdim=True) + 1e-8)
        eps = torch.exp(model.epsilon) + 0.03
        gamma = torch.exp(model.gamma)
    transport = dict(f=f1, g=f2, p=pc1, q=pc2, eps=eps,
                     power=gamma / (gamma + eps), iters=model.nb_iter,
                     support2=float(model.support_m) ** 2)

    def check_transport(got, want):
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all().item())
        if not (err <= FLOT_KERNEL_TOL and finite):
            fail(f"transport_flow: max_abs_err {err} m (tol "
                 f"{FLOT_KERNEL_TOL}), finite {finite}")
        return err, FLOT_KERNEL_TOL

    runs.append(dict(
        kernel="transport_flow",
        config=f"{FLOT_STREAMS}x{FLOT_N}x{FLOT_N}",
        run_k=lambda: fused_transport.transport_flow(**transport),
        run_p=lambda: fused_transport.transport_flow_reference(**transport),
        check=check_transport,
        work=lambda got: cases.transport_flow_work(transport, got)))
    run_kernel_cases(torch, "flot_kernel", runs, summary)
    del runs, graph, transport, f1, f2

    # the scan: FLOT_SLICE on the card against the CPU from one seed
    b, t = FLOT_SLICE
    cpu_frames = flot_frames(torch, seed + 23, b, t, "cpu")
    t0 = time.perf_counter()
    want = make_scan_flow_step_cached(flot_model(torch, seed, "cpu"))(
        cpu_frames)
    cpu_s = time.perf_counter() - t0
    scan = make_scan_flow_step_cached(model)
    card_frames = to_tensors(cpu_frames, dev)
    fused_knn.knn_indices_tiled.launches = 0
    fused_transport.transport_flow.launches = 0
    got = scan(card_frames)
    torch.cuda.synchronize()
    launches = dict(knn_tiled=fused_knn.knn_indices_tiled.launches,
                    transport_flow=fused_transport.transport_flow.launches)
    # a graph a frame and pc2's at the block's first; a transport a frame
    if launches != dict(knn_tiled=t + 1, transport_flow=t):
        record_failure(f"flot slice launch counts {launches}, expected "
                       f"{dict(knn_tiled=t + 1, transport_flow=t)}")
    gaps = {key: (got[key].cpu() - want[key]).abs().max().item()
            for key in ("flow", "ot_flow")}
    for key, gap in gaps.items():
        if not gap <= FLOT_FLOW_TOL:
            record_failure(f"flot slice {key}: max gap {gap} m to the CPU "
                           f"(tol {FLOT_FLOW_TOL})")
    emit(phase="flot_slice", streams=b, frames=t, n=FLOT_N,
         flow_gap_m=gaps["flow"], ot_flow_gap_m=gaps["ot_flow"],
         tol_m=FLOT_FLOW_TOL, launches=launches, cpu_seconds=cpu_s)
    del got, want, card_frames, cpu_frames

    # the scan at the cell's shape: FLOT_STREAMS x FLOT_SCAN_T, no gate
    frames = flot_frames(torch, seed + 24, FLOT_STREAMS, FLOT_SCAN_T, dev)
    scan(frames)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for rep in range(3):
        fused_knn.knn_indices_tiled.launches = 0
        fused_transport.transport_flow.launches = 0
        t0 = time.perf_counter()
        scan(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    scan_launches = dict(
        knn_tiled=fused_knn.knn_indices_tiled.launches,
        transport_flow=fused_transport.transport_flow.launches)
    if scan_launches != dict(knn_tiled=FLOT_SCAN_T + 1,
                             transport_flow=FLOT_SCAN_T):
        record_failure(f"flot throughput launch counts {scan_launches}")
    dt = statistics.median(times)
    emit(phase="flot_throughput", streams=FLOT_STREAMS, frames=FLOT_SCAN_T,
         n=FLOT_N, seconds=times,
         frames_per_s=FLOT_STREAMS * FLOT_SCAN_T / dt,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=card, launches=scan_launches)
    return summary, {"transport_flow": launches["transport_flow"]}


def run_phase_dp(torch, card: str):
    tmp = tempfile.mkdtemp(prefix="ratrack_dp_")
    try:
        phase_dp(torch, SEED, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if FAILED:
        fail(f"{len(FAILED)} failed checks in phase 21")


def phase_dp(torch, seed: int, card: str, tmp: str):
    """Phase 21: data parallelism over clip streams (parallel/mesh.py)."""
    count = torch.cuda.device_count()
    dev = torch.device("cuda", 0)
    t0 = time.time()
    ref = [dp_train(torch, seed, dev) for _ in range(2)]
    moved = dp_train(torch, seed, dev, perturb=DP_PERTURB)
    ref_eval = dp_eval(torch, seed, dev)
    repeat, repeat_at = dp_distance(ref[0], ref[1])
    rounding, rounding_at = dp_distance(ref[0], moved)
    yard = {k: max(repeat[k], rounding[k]) for k in repeat}
    gate = {k: 2 * v + DP_CLASS for k, v in yard.items()}
    emit(phase="dp", part="yardstick", streams=N_STREAMS, frames=DP_T,
         points=N_MAX, repeat=repeat, repeat_at=repeat_at,
         weights_moved=rounding, weights_moved_at=rounding_at,
         perturb=DP_PERTURB, gate=gate, float32_class=DP_CLASS,
         seconds=time.time() - t0,
         rule="sharded distance <= 2 x the larger of two unsharded runs' "
              "distances (the same run again: B9 / B10's atomics; weights "
              "moved by float32 rounding: the max-pools' near-ties) + the "
              "float32 class")
    for backend, world, cards in dp_worlds(count):
        root = tempfile.mkdtemp(prefix=f"dp_{backend}{world}_", dir=tmp)
        speed = backend == "nccl" and world > 1
        t0 = time.time()
        if world == 1:
            dp_rank(0, root, backend, world, seed, speed)
        else:
            torch.multiprocessing.spawn(dp_rank, args=(
                root, backend, world, seed, speed), nprocs=world, join=True)
        seconds = time.time() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
        got = ranks[0]["train"]
        dist_, dist_at = dp_distance(ref[0], got)
        later = max(((got["items"][f][k] - v).norm() / v.norm()).item()
                    for f in range(1, DP_T)
                    for k, v in ref[0]["items"][f].items())
        replicated = all(torch.equal(r["train"]["params"], got["params"])
                         for r in ranks)
        launches = [r["train"]["launches"] for r in ranks]
        emit(phase="dp", part="train", backend=backend, ranks=world,
             cards=cards, devices=ranks[0]["devices"],
             streams_per_rank=N_STREAMS // world, frames=DP_T,
             distance=dist_, distance_at=dist_at, gate=gate,
             later_frames_items_rel=later,
             collectives=got["collectives"], launches=launches[0],
             ranks_replicated=replicated, spawn_seconds=seconds,
             note=None if cards == world else
             "ranks share one card through gloo: a check of the split's "
             "numerics on the card's kernels, no speed figure")
        for k, v in dist_.items():
            if v > gate[k]:
                record_failure(f"dp {backend} x{world} {k}: distance {v} > "
                               f"gate {gate[k]}")
        want = [{"all_reduce": 2}] * DP_T
        if any(r["train"]["collectives"] != want for r in ranks):
            record_failure(f"dp {backend} x{world} collectives "
                           f"{[r['train']['collectives'] for r in ranks]}")
        if any(x != expected_train_launches(DP_T) for x in launches):
            record_failure(f"dp {backend} x{world} launches {launches}")
        if not replicated:
            record_failure(f"dp {backend} x{world}: parameters differ "
                           f"between ranks after the scan")
        ev = ranks[0]["eval"]
        gap = tracking_gap(torch, ev["outs"], ref_eval["outs"],
                           make_frames(torch, seed + 3, SLICE_T, "cpu").pc1)
        emit(phase="dp", part="eval", backend=backend, ranks=world,
             collectives=[r["eval"]["collectives"] for r in ranks],
             launches=ev["launches"], **gap)
        gate_tracking(f"dp eval {backend} x{world}", gap)
        if any(r["eval"]["collectives"] for r in ranks) or any(
                r["eval"]["launches"] != expected_launches(SLICE_T)
                for r in ranks):
            record_failure(f"dp eval {backend} x{world}: collectives or "
                           f"launches")
        if speed:
            sp = [r["speed"] for r in ranks]
            fps = {k: streams * TRAIN_SCAN_T / statistics.median(
                sp[0][k + "_s"]) for k, streams in (
                ("w1", N_STREAMS), ("wn", N_STREAMS),
                ("ww", N_STREAMS * world))}
            emit(phase="dp", part="speed", backend=backend, ranks=world,
                 cards=cards, frames_per_stream=TRAIN_SCAN_T,
                 streams={"w1": N_STREAMS, "wn": N_STREAMS,
                          "ww": N_STREAMS * world},
                 order="w1 wn ww ww wn w1",
                 seconds={k: sp[0][k + "_s"] for k in fps},
                 frames_per_s=fps,
                 speedup={k: fps[k] / fps["w1"] for k in ("wn", "ww")},
                 peak_gib_per_rank={k: [max(s[k + "_peak_gib"]) for s in sp]
                                    for k in fps}, card=card)
    if count < 2:
        emit(phase="dp", part="speed", skipped=f"{count} card: a speed "
             "figure needs one card a rank")
    dp_cli(torch, card, tmp, 4 if count >= 4 else 2 if count >= 2 else 1,
           dev)


def ptxas_summary(log: str):
    """[{kernel, registers, spill_stores}] from nvcc's -Xptxas -v output."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?([a-z][a-z_]*_kernel)[EI]", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.append({"kernel": name, "spill_stores": int(m.group(1))})
        m = re.search(r"Used (\d+) registers", line)
        if m and out and out[-1]["kernel"] == name:
            out[-1]["registers"] = int(m.group(1))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables of 4-frame "
                         "eval, train and 8192-point stretch scans (and "
                         "device busy-share lines)")
    ap.add_argument("--dp-only", action="store_true",
                    help="only phase 21 (data parallelism over the cards) "
                         "after the build: the run for a machine of "
                         "several cards")
    ap.add_argument("--flot-only", action="store_true",
                    help="only phase 22 (FLOT: B5 at k = 32, B11, the "
                         "flow scan) after the build")
    args = ap.parse_args()

    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ratrack_tpu_torch")):
        fail("the ratrack_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from ratrack_tpu_torch.kernels import build
    build.load()
    emit(phase="build", seconds=build.last_build["seconds"],
         cached=build.last_build["cached"],
         ptxas=ptxas_summary(build.last_build["log"]))
    if args.dp_only:
        run_phase_dp(torch, card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if args.flot_only:
        phase_flot(torch, SEED, card)
        if FAILED:
            fail(f"{len(FAILED)} failed checks in phase 22")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    summary = phase_kernels(torch, SEED)
    model = phase_slice(torch, SEED)
    summary.update(phase_dbscan(torch, model, SEED))
    launches, eval_fps = phase_throughput(torch, model, SEED, card,
                                          args.profile)
    del model
    summary.update(phase_train_kernels(torch, SEED))
    phase_train_slice(torch, SEED)
    train_launches = phase_train_throughput(torch, SEED, card, args.profile)
    if FAILED:
        fail(f"{len(FAILED)} failed checks in phases 6-8")
    summary.update(phase_stretch_kernels(torch, SEED))
    model = phase_stretch_slice(torch, SEED)
    stretch_launches = phase_stretch_throughput(torch, model, SEED, card,
                                                eval_fps, args.profile)
    del model
    summary.update(phase_scale_kernels(torch, SEED))
    scale_launches = phase_general_slice(torch, SEED)
    phase_serving(torch, SEED, card)
    phase_train_stretch(torch, SEED, card)
    tmp = tempfile.mkdtemp(prefix="ratrack_cli_")
    try:
        vod = phase_cli(torch, card, tmp)
        phase_offline_eval(vod, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_pipelined(torch, SEED, card, eval_fps)
    bf16_summary, bf16_launches = phase_bf16(torch, SEED, card)
    summary.update(bf16_summary)
    tmp = tempfile.mkdtemp(prefix="ratrack_bf16_train_")
    try:
        phase_bf16_train(torch, SEED, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    flot_summary, flot_launches = phase_flot(torch, SEED, card)
    summary.update(flot_summary)
    if FAILED:
        fail(f"{len(FAILED)} failed checks in phases 12-20 and 22")
    run_phase_dp(torch, card)
    launches = {**{k: launches[k] for k in EVAL_KERNELS},
                **{k: train_launches[k] for k in TRAIN_KERNELS},
                **{k: stretch_launches[k] for k in STRETCH_KERNELS},
                **{k: launches[k] for k in CLUSTER_KERNELS},
                **scale_launches, **bf16_launches, **flot_launches}
    if not all(launches.values()):
        fail(f"a kernel was never launched on its path: {launches}")

    kernels = []
    for name, meta in KERNELS.items():
        entry = summary[name]
        bound_ms, bound_by = roofline(
            entry["bytes"], entry["mm_ops"], entry["ops"],
            BF16_PRODUCT_OPS_PER_S if name in BF16_KERNELS
            else PRODUCT_OPS_PER_S)
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=entry["max_abs_err"], ms=entry["ms"],
            plain_ms=entry["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=entry["library_ms"]))
    # B1 and B2 at the stretch shape: both heads' sa1 (8192 points x 512
    # centers) and fp1 (8192 unknowns x 512 known points); B3's selection
    # launches of an eval step; B5 at k = 32, FLOT's graph; B12 at 32 and
    # 256 streams
    for name, part, prefix in (("sa_pair", "sa_pair_stretch", "stretch"),
                               ("three_interpolate",
                                "three_interpolate_stretch", "stretch"),
                               ("knn_weight_aggregate", "knn_select",
                                "select"),
                               ("knn_tiled", "knn_graph", "graph"),
                               ("dbscan_labels", "dbscan_b32", "b32"),
                               ("dbscan_labels", "dbscan_b256", "b256")):
        entry = summary[part]
        bound_ms, _ = roofline(entry["bytes"], entry["mm_ops"], entry["ops"])
        extra = {f"{prefix}_ms": entry["ms"],
                 f"{prefix}_plain_ms": entry["plain_ms"],
                 f"{prefix}_bound_ms": bound_ms}
        if entry["library_ms"] is not None:
            extra[f"{prefix}_library_ms"] = entry["library_ms"]
        next(k for k in kernels if k["name"] == name).update(extra)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

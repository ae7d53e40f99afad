#!/usr/bin/env python3
"""Drive heatnet_tpu_torch on one CUDA card, end to end.

    python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi);
2. the build of ``heatnet_tpu_torch/csrc/*.cu`` and its time;
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes, with the error beside its stated tolerance and
   CUDA-event times of the kernel, the plain version and, for the grouped
   conv, ``F.conv2d(groups=64)`` (a yardstick only; the port never calls it),
   the card time of each call's kernels (torch.profiler) beside them and
   each stage's share of its bound. The grouped conv's gradients
   (``GroupedConv3x3Function``) are checked at the four training shapes
   (batch 10, 320x640 crop): forward and dx against autograd of the plain
   version, dk in relative L2 norm, with times of the forward and dx
   kernels, ``F.conv2d`` and ``torch.nn.grad.conv2d_input(groups=64)`` (the
   yardsticks) and the dk library call;
4. the main path: a 16-frame 320x704 heatnet-pack-v1 directory served by
   ``heatnet_tpu_torch.cli.inference.main`` with ResNeXt-50 at full depth and
   width (random weights, seed 0) at batch 8, the kernels' launch counts
   read around that run, then the same weights served again through the
   plain versions for the class-map agreement, and one forward checked for
   finite logits of the right shapes;
4b. the training path: a 12-frame 320x960 heatnet-train-pack-v1 directory
   trained by ``heatnet_tpu_torch.cli.train_plain.main`` with ResNeXt-50 at
   full depth and width, batch 10, 320x640 crop, for 4 steps, the kernels'
   launch counts read around that run (16 forward and 16 dx launches per
   step), finite losses, step time and peak memory; one step's loss and
   gradients with the kernels against the same step through the plain
   versions (and through the library's grouped conv, which measures how far
   bf16 rounding alone moves them); 5 steps on one repeated batch, whose
   loss must fall;
4c. the adversarial trainer: a 32-frame 320x960 day/night train pack and a
   random IR-only ResNeXt-50 teacher checkpoint, trained by
   ``heatnet_tpu_torch.cli.train_conf.main`` at the JAX bench's adversarial
   operating point (ResNeXt-50 full depth and width, 6 ``cyclegan`` critics,
   batch 16, 320x640 crop, ``--moddrop --irscale``, the teacher on,
   ``--pretraining`` from phase 4b's checkpoint) for 8 steps, 4 of each
   phase; the kernels' launch counts read around each step (a critic step:
   32 forward, 0 dx, 0 fused; a seg step: 32 forward, 32 dx and 16 fused,
   the teacher's), finite losses, seg- and critic-step p50/p95 and peak
   memory; one seg step's loss and gradients and one critic step's loss
   with the kernels against the plain versions (and the library's grouped
   conv), and phase isolation on the card. The run has ``--testroot_day``
   and ``--testroot_night`` (8-frame trees): its periodic eval every 2
   epochs logs ``combined_Test mean IoU`` twice and leaves a ``_best``
   checkpoint, the steps' launches unchanged;
5. the slice's later paths, each with its launches read around it:
   5a. late-fusion ResNeXt-50 served at batch 8 from a 320x704 pack through
       ``eval.validate.inference``: 1 ingest launch (its two-output mode) and
       19 fused grouped-conv launches per forward, class maps against the
       plain versions, forward p50/p95;
   5b. PSPNet-ResNet-50, RGB only, served the same way: 1 ingest launch and
       no grouped conv per forward;
   5c. ``cli.train_conf --late_fusion`` at phase 4c's operating point for 8
       steps (38 forward grouped-conv launches per critic step; 38 forward,
       38 dx and 16 fused per seg step), step p50/p95 and peak memory, and a
       seg and a critic step against the plain versions as in 4c;
   5d. ``cli.train_conf --arch pspnet`` with an IR-only PSPNet teacher for
       8 steps (no port kernel on this path), step p50/p95, peak memory, and
       a seg step's loss under two dropout draws (dropout is live);
   5e. ``cli.inference --arch resnext101``: 33 fused launches per forward;
   5f. evaluation on trees the phase writes with the port's PNG writer (no
       cv2 needed): first the ingest kernel and the fused grouped conv at the
       eval shapes (batch 16; stages at 80x176/40x88 and, for MFNet's
       480x640, 120x160/60x80) against their plain versions, then
       ``cli.train_conf --eval FR_day``, ``FR_night`` (320x960
       Freiburg trees of 18 and 13 frames) and ``MF_day`` (9 RGBA 480x640
       frames) with phase 4c's checkpoint, the launches read around each
       (1 ingest and 16 fused per batch of 16 for Freiburg, 0 and 16 for
       MFNet's host-normalised frames), IoU vectors, frames/s on the host
       clock beside the decode time per frame and the card time per batch;
       the same evaluations through the plain versions (class maps agree on
       >= 0.99 of pixels, IoU vectors side by side); ``--infer`` with
       ``--im_save_dir`` on a capture tree, its ``pred_*.png`` decoded and
       held against the palette-coded class maps; ``cli.inference --batch 8``
       on that tree;
6. the IR-only trainers (``BASELINE.json`` config #5 and the uncertainty
   pretrainer): first the grouped conv's forward, fused and dx forms at
   their stage shapes (netSeg at batch 2, 64x64 and 32x32; the encoders at
   batch 4, 40x80 and 20x40) against their plain versions, then
   6a. ``cli.train_cyclegan`` at its defaults (9-block generators, netSeg
       ResNeXt-50 (3,4,6,3) with 12 classes, batch 2 of 256x256) on a
       KAIST-layout tree of 640x512 PNG frames the phase writes, 2 epochs of
       3 steps: 32 forward and 32 dx launches per generator step, none per
       discriminator step, finite losses, host-clock step ms p50/p95, peak
       memory, the five checkpoints; one generator step's loss and
       gradients with the kernels against the plain versions (and the
       library's grouped conv), as in 4b;
   6b. ``cli.test_cyclegan --run_seg --limit 4`` on 6a's checkpoints: 8
       translations and 4 seg maps that ``read_png`` decodes, 16 fused
       launches per frame, seg maps against the plain versions' (>= 0.99);
   6c. ``cli.train_uncertainty`` at its defaults (two (2,2,2,2) encoders,
       batch 4 of 80x160) on a train pack, 4 steps: 16 forward and 16 dx
       launches per step, finite losses, step ms, peak memory, the
       checkpoint;
7. Vistas pretraining and MFNet adversarial training, on trees the phase
   writes with the port's PNG writer (phase 3d first holds the grouped conv
   at their stage shapes: forward and dx at batch 30, 96x192 and 48x96;
   fused at eval batch 16 there; all three at batch 16, 96x96 and 48x48):
   7a. ``cli.main`` at ``experiments/heatnet_conf.json``'s full width
       (ResNeXt-50, RGB, 3x3 stem, leaky ReLU 0.01, 13 classes, Adam 1e-5
       with the poly decay, no clip) on a 1024x768 Vistas tree, batch 30 of
       384x768, 2 epochs of 2 steps, 8 decode threads, each epoch validating
       20 frames (a full eval batch of 16 and a padded one): 16 forward and
       16 dx launches per step and 16 fused per eval batch, read around
       each, finite losses, the epoch-0 checkpoint, step ms p50/p95 (CUDA
       events), the host clock's step and batch-wait times, peak memory,
       and the host's ms per batch of decode and augmentation;
   7b. ``cli.main --resume <7a> --evaluate``: 7a's epoch-0 mIoU within 1e-6;
   7c. one Vistas step at batch 30 with ``--bn-groups 3``, kernels against
       the plain versions (and the library's grouped conv), as in 4b, and
       the running mean of the first BN against group 0's batch mean;
   7d. ``cli.main --arch pspnet`` for 2 steps at batch 30: no port kernel
       launched, finite losses, step ms, peak memory;
   7e. ``cli.train_conf --trainsetname MF --bn_groups 2`` on a 480x640
       MFNet train tree (16 day + 16 night frames), 6 cyclegan critics and
       the IR teacher, batch 16 of 384x384, 2 critic and 2 seg steps: 32/0/0
       and 32/32/16 launches per critic and seg step, finite losses, peak
       memory, and phase isolation on an MF batch as in 4c;
8. the MFNet harness and its tools:
   8a. MFNet, RTFNet (ResNet-50 encoders) and SegNet at full width, random
       weights from seed 0: the card's float32 eval forward (TF32 off)
       against the same weights' forward on the CPU on one 192x256 frame,
       class maps on >= 0.999 of pixels, logits within 1e-3 of max |logit|;
   8b. ``cli.train_baseline --model_name {MFNet,RTFNet,SegNet}`` at the CLI's
       defaults (batch 8 of 480x640, lr 0.01, SGD) for 2 epochs of 3 steps on
       a tree of 24 train and 5 + 5 test frames the phase writes with the
       port's PNG writer, then day and night evaluation: no port kernel
       launched (read around each step and the run), finite losses, step ms
       p50/p95 (CUDA events), peak memory, eval frames/s, overall accuracy
       and mIoU per split;
   8c. ``--test --resume`` on 8b's RTFNet checkpoint: the combined matrix
       equals 8b's day + night matrices exactly;
   8d. ``cli.run_demo`` on 4 frames with that checkpoint: each ``_pred.png``
       equals the palette-coded class map of a float32 eval forward;
   8e. ``cli.eval_hotnet`` on a run directory of phase 4c's checkpoint, and
       ``cli.dataset_qa freiburg`` and ``mfnet`` on phase 5f's trees: 1
       ingest + 16 fused launches per Freiburg batch of 16, 0 + 16 per MFNet
       batch, the IoUs of 5f's validators bit for bit;
9. int8 serving, the borders mode, reference checkpoints, the Vistas
   relabelling (phase 4c's segnet weights):
   9a. ``int8_conv`` (``csrc/int8_conv.cu``: one launch runs its quantize
       pass and its product) at each int8 layer shape of a batch-8 forward of
       ResNeXt-50 at 320x960 (the layers JAX's predicates quantize, found by
       ``tools/int8_compare.py::jax_int8_layers``), equal to its plain
       version bit for bit, with eager and card times (the quantize pass and
       the product apart, their sum and its share of the bound), the bound
       (int8 at 1979 TOPS), ``torch._int_mm`` on the 1x1 layers and cuDNN's
       bf16 ``F.conv2d`` of the same shape (another function's time, a
       yardstick only). The inputs are post-ReLU, as the model's layers see
       them (half zeros), and signed for a second equality check and card
       time. The card times come from a child process
       (``--int8-card-times``): once this process has launched kernels
       outside a profiler window for a while, torch.profiler loses kernel
       records while keeping their launches, so a late window reads 0. The
       child reads each shape, and the int8 kernels of one batch-8 int8
       forward at 320x960, and holds the kernel records to two per launch,
       taking a window again where it lost some;
   9b. ``cli.inference --quant int8 --batch 8`` on a 16-frame pack: the
       launches against JAX's predicates, class maps against bf16 (>= 0.90)
       and against the int8 plain versions (>= 0.99), forward p50/p95 at batch
       8 and 32 beside bf16's, batch 1 and an uncalibrated model serving the
       bf16 maps bit for bit with no int8 launch;
   9c. ``--borders-data`` on a 4-frame 768x384 tree, bf16 and int8 (batch 1:
       the float maps), its PNGs written;
   9d. ``cli.convert_checkpoint`` of the weights under the reference's names,
       then ``cli.inference --resume``: bf16 maps bit for bit;
   9e. ``cli.generate_vistas`` on a 4-frame PNG Vistas tree (the native
       relabeller must serve it), one ``cli.main`` step on its output;
10. Freiburg PNG training trees and packs, and the serving artifact, on
    trees the phase writes with the port's PNG writer (650x1920 frames, so
    every resize to 960x320 runs):
   10a. a train tree of 32 day and 16 night frames, 4 day stamps shared with
       an 8-frame test tree: ``cli.pack_frames --train`` with the test trees
       and again with ``--split test``; frame counts, ``meta.json``, the
       excluded stamps, and the pack's items against
       ``FreiburgThermalDataset``'s on the tree, bit for bit; host ms per
       batch of 16 from the tree and from the pack (one thread);
   10b. ``cli.train_conf`` at phase 4c's operating point with ``--dataroot``
       the tree and the test trees given: 2 critic steps of 32/0/0 and 2 seg
       steps of 32/32/16 launches (forward/dx/fused), finite losses, step
       p50 and the run's wall time;
   10c. ``cli.train_plain`` (batch 10) and ``cli.train_uncertainty`` (batch
       4) on the tree, 2 steps each: 16 + 16 launches per step;
   10d. ``cli.pack_frames`` of a 32-frame capture tree, then
       ``cli.inference --batch 8`` on the pack and on the tree with phase
       4c's weights: class maps bit for bit, 1 ingest + 16 fused launches
       per forward;
   10e. ``cli.export_model`` of phase 4c's weights (ResNeXt-50, raw inputs,
       320x704, symbolic batch, on the card); a child process
       (``--serve-artifact``) that imports torch and
       ``heatnet_tpu_torch.ops`` only loads it and serves batch 1 and 8: 1
       ingest + 16 fused launches per call counted there, its class maps
       against 10d's ``cli.inference`` maps, batch-8 p50/p95 beside the
       eager forward's; then ``--quant int8 --calib-data`` the capture tree:
       the int8 launches by JAX's predicates at a symbolic batch, the maps
       against the in-process int8 model's (>= 0.99);
11. the trainers' remaining parts:
   11a. ``cli.train_plain`` at 4b's operating point for 4 steps under
       ``HEATNET_BN_IMPL=lean`` and under the default BN, from the same
       weights and batches: 16/16/0 launches per step read around each, the
       losses within 1e-2 relative, step p50/p95 (after the first step) and
       peak memory of both; one
       step's loss and gradients, lean against default, each gradient within
       max(0.05, 2x the distance of the default BN with cuDNN's grouped conv);
       ``lean_bn_act`` on the card against its float32 CPU counterpart;
   11b. ``cli.train_conf --vis --log_everyn 1`` at 4c's operating point for 2
       critic and 2 seg steps, and the same run without ``--vis``: the JAX
       trainer's panel names, 32 fused launches per vis forward, the model,
       RNG and train flags unchanged by each, the label maps against the
       plain versions (>= 0.99), the losses bit for bit (both runs with
       cuDNN deterministic and the critics' bilinear resizes given a
       fixed-order backward: CUDA's adds with atomics, so without it no two
       runs agree from the second seg step on);
   11c. CLAHE: ``VistasDataset(contrast_enhancement=True)`` (eval and train
       chains) and the default ``VistasBordersDataset`` on trees the phase
       writes, against the same loaders with cv2's CLAHE where cv2 imports,
       and the Lab conversions on 2^20 colours; host ms per item with and
       without CLAHE;
   11d. ``cli.main`` (structure 1 1 1 1, batch 4 of 192x384, 2 steps and a
       validation) alone and as rank 0 of 1 under a torchrun-style
       environment (NCCL): losses, weights, BN statistics and IoUs bit for
       bit, the same launches;
   11e. a child process (``--profile-serving``) serves 3 batch-8 forwards
       inside ``utils/profiling.trace`` and ``annotate``: the trace names the
       ingest and fused grouped-conv kernels and the span;
       ``scan_benchmark`` of the forward beside the CUDA-event p50;
12. the capture path, host code at the shipped rig's sizes
   (``experiments/calibrations/example_rig``: RGB 1920x1080, IR 640x512);
   the kernels' launch counts are read around 12b-12c and must stay 0:
   12a. the native C++ library (``heatnet_tpu_torch/native``) built afresh
       with ``g++`` (its seconds printed); the relabeller against
       ``data/mappings.py::relabel_vistas_image`` on 1024x768 panoptic maps
       (ms per frame of both), ``thermal_to_8bit`` and ``gray_binarize``
       against numpy versions on 640x512 frames, ``Synchronizer`` and
       ``BurstSampler`` on four synthetic 30 Hz streams, ``MessageBus``'s
       round trip and its oversized-message ``BufferError``;
   12b. ``cli.dump_capture --calib`` the shipped camchain on a capture the
       phase writes (two RGB and two IR streams and a lidar stream of
       32768x4 points, 10 frames each at 30 Hz with 1 ms skew, ``tf.jsonl``,
       ``origin.json``): windows, frames, manifests of 5 paths, vehicle
       lines, heat stats and the HTML; where cv2 imports, the port's maps
       equal cv2's and every rectified frame equals ``cv2.remap`` of its
       source bit for bit; host ms per rectified frame and the dump's wall
       time;
   12c. ``ThermalDriveDataset`` on the dumped tree (with and without
       ``contrast_enhancement``), ``cli.visualize_data`` on a 640x512
       ``make_drive_dump`` tree, ``cli.camera_focus`` on the dumped
       ``fl_rgb`` frames, ``cli.plot_heatmap`` on the dump's heat stats, with
       host ms per item;
13. height-sharded serving (``parallel/spatial.py``): ResNeXt-50 early fusion
   at full width and depth (random weights, seed 0) serves batch 1 of a
   640x1920 raw frame (a 650x1920 Freiburg source frame cut to 640 rows, so
   that each shard holds a multiple of 8 rows) split by rows over 4 worker
   processes on the one card, joined in a gloo group (``--spatial-worker``;
   two NCCL ranks cannot share a card): each runs ``serve_frame``
   (``shard_rows``, the ingest kernel on its raw rows, the model under
   ``spatial_parallel`` with the fused grouped conv on halo-extended shards,
   argmax) and rank 0 gathers the class map. At 160 rows per shard (20 at
   stride 8) ASPP's rates 24 and 36 reach two shards away. The class map
   against the unsharded forward of the same weights here (>= 0.999 of
   pixels) with the largest logit difference relative to the largest
   |logit|; 1 ingest and 16 fused launches per forward read in each worker;
   the unsharded forward's p50, each worker's (4 processes share the card:
   not a latency figure), the exchanges' bytes and ms per forward and the
   rows the halo-extended grouped convs compute beyond their shards;
14. the total time and one ``{"kernels": [...]}`` JSON line (each kernel's
   launches on every path); the last line is ``{"ok": true, "device": {...}}``.

Launch counts: the grouped-conv kernel has one count per entry point, the
epilogue-free forward (``grouped_conv3x3``), the fused BN affine + act
forward (``grouped_conv3x3_fused``) and the input gradient
(``grouped_conv3x3_dx``); the int8 conv one (``int8_conv``).

Without a card, or run from a directory that does not hold the package, it
prints no result and exits non-zero. ``--int8-card-times SPEC OUT`` is phase
9a's child process (SPEC and OUT are JSON files), ``--serve-artifact SPEC
OUT`` phase 10e's, ``--profile-serving OUT`` phase 11e's, ``--spatial-worker
SPEC OUT`` phase 13's workers; none is an entry point.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core peak, same source
INT8_OP_PER_S = 1979e12     # dense int8 tensor-core peak, same source
N_BATCH, H_IN, W_IN = 8, 320, 704
# (name, C, channels per group, dilation, H, W, launches per forward) of
# ResNeXt-50's grouped convs at a 320x704 input (trgb_segnet.py:92-96)
STAGES = (("mod2", 128, 2, 1, 80, 176, 3), ("mod3", 256, 4, 1, 40, 88, 4),
          ("mod4", 512, 8, 2, 40, 88, 6), ("mod5", 1024, 16, 4, 40, 88, 3))
MIN_AGREEMENT = 0.99
# The training path: batch 10 of 320x640 crops from 320x960 frames, and the
# grouped convs at that crop (the same stages at 80x160 and 40x80)
N_TRAIN, CROP, TRAIN_STEPS = 10, (320, 640), 4
LEAN_STEPS = 4  # phase 11a: cli.train_plain steps under each BN
TRAIN_STAGES = (("mod2", 128, 2, 1, 80, 160, 3), ("mod3", 256, 4, 1, 40, 80, 4),
                ("mod4", 512, 8, 2, 40, 80, 6), ("mod5", 1024, 16, 4, 40, 80, 3))
DK_TOL = 1e-2       # relative L2 of dk (cuDNN's, bf16) against autograd of plain
STEP_LOSS_TOL = 1e-2
GRAD_TOL = 0.05     # per tensor of norm >= 1e-4 (tests/test_train_parity.py:226),
                    # or twice the library's distance (see phase 4b)
# The adversarial operating point (tools/bench_train_step.py:140-170): batch
# 16, 6 cyclegan critics; 32 day and 16 night frames, 2 steps per epoch
N_ADV, ADV_EPOCHS = 16, 4
ADV_FRAMES = (32, 16)
# Evaluation (phase 5f): Freiburg day/night trees at the source size
# 320x960 (frame counts not multiples of the eval batch, 16), an MFNet tree
# at 480x640, and 8-frame trees for phase 4c's periodic eval
EVAL_BATCH, N_EVAL_DAY, N_EVAL_NIGHT, N_EVAL_MF, N_PERIODIC = 16, 18, 13, 9, 8
# The IR-only trainers (phases 6a-6c): cli.train_cyclegan at batch 2 of
# 256x256 KAIST frames, 2 epochs of 3 steps; cli.test_cyclegan on 4 frames;
# cli.train_uncertainty at batch 4 of 80x160, 4 steps. (N, C, cpg, d, H, W)
# of their grouped convs: netSeg at 64x64 and 32x32, the encoders at 40x80
# and 20x40
N_GAN, GAN_EPOCHS, GAN_ITERS, N_GAN_TEST, N_UNC, UNC_STEPS = 2, 2, 3, 4, 4, 4
GAN_STAGES = ((2, 128, 2, 1, 64, 64), (2, 256, 4, 1, 32, 32), (2, 512, 8, 2, 32, 32),
              (2, 1024, 16, 4, 32, 32), (4, 128, 2, 1, 40, 80), (4, 256, 4, 1, 20, 40),
              (4, 512, 8, 2, 20, 40), (4, 1024, 16, 4, 20, 40))
# Vistas pretraining (phases 7a-7d): cli.main at experiments/heatnet_conf.json
# (batch 30 of 384x768 crops from 1024x768 frames, 2 epochs of 2 steps, 20
# validation frames: one full eval batch of 16 and a padded one), and MFNet
# adversarial training (7e) at batch 16 of 384x384 crops from 480x640
# frames. (which, N, C, cpg, d, H, W) of their grouped convs: "fwd_dx" at
# the Vistas step's stages (mod2 at 96x192, mod3-5 at 48x96), "fused" at
# its eval batch's, "all" at the MF steps' (96x96, 48x48)
N_VIS, VIS_HW, VIS_EPOCHS, N_VIS_VAL, N_MF, MF_CROP = 30, (384, 768), 2, 20, 16, (384, 384)
# The MFNet harness (phases 8a-8d): MFNet, RTFNet and SegNet through
# cli.train_baseline at its defaults (batch 8 of 480x640, float32), 2 epochs
# of 3 steps on 24 train frames, 5 day and 5 night test frames (a padded eval
# batch of 8 each); the card's forward against the CPU's at 192x256 (class
# maps on >= 0.999 of pixels, logits within 1e-3 of the largest |logit|);
# cli.run_demo on 4 frames
HARNESS_MODELS = ("MFNet", "RTFNet", "SegNet")
N_HARNESS, N_HARNESS_TRAIN, N_HARNESS_TEST, HARNESS_EPOCHS, N_DEMO = 8, 24, 5, 2, 4
HARNESS_CHECK_HW, HARNESS_AGREE, HARNESS_REL_TOL = (192, 256), 0.999, 1e-3
# Freiburg training trees (phase 10): source frames of 650x1920 (the size
# tools/png_decode_time.py takes for Freiburg's frames), 32 day and 16 night
# frames, 4 day stamps shared with an 8-frame test tree; a 32-frame capture
# tree; the artifact's agreement with cli.inference (bit for bit expected)
TREE_HW, TREE_FRAMES, TREE_SHARED, N_TREE_TEST = (650, 1920), (32, 16), 4, 8
EXPORT_AGREE, EXPORT_INT8_AGREE = 0.999, 0.99
VIS_MF_STAGES = tuple(
    (which, n, c, cpg, d, h if c == 128 else h // 2, w if c == 128 else w // 2)
    for which, n, h, w in (("fwd_dx", N_VIS, 96, 192), ("fused", EVAL_BATCH, 96, 192),
                           ("all", N_MF, 96, 96))
    for c, cpg, d in ((128, 2, 1), (256, 4, 1), (512, 8, 2), (1024, 16, 4)))


def write_fr_tree(root: str, n: int, seed: int) -> str:
    """A Freiburg test tree (ImagesRGB/ImagesIR/SegmentationClass, the
    getPaths layout) of ``n`` 320x960 frames: 8-bit RGB, 16-bit IR in
    [21000, 26000), ``.npy`` labels 0-13, written with the port's writer."""
    from heatnet_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    for d in ("ImagesRGB", "ImagesIR", "SegmentationClass"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        stamp = f"{1700000000 + 1000 * seed + i}_{100 * i:09d}"
        write_png(os.path.join(root, "ImagesRGB", f"{stamp}_rgb.png"),
                  rng.randint(0, 256, (320, 960, 3)).astype(np.uint8), level=1)
        write_png(os.path.join(root, "ImagesIR", f"{stamp}_ir.png"),
                  rng.randint(21000, 26000, (320, 960)).astype(np.uint16), level=1)
        np.save(os.path.join(root, "SegmentationClass", f"{stamp}.npy"),
                rng.randint(0, 14, (320, 960)).astype(np.uint8))
    return root


def write_mfnet_tree(root: str, n: int, seed: int, train: bool = False) -> str:
    """An MFNet tree: ``n`` RGBA 480x640 images (alpha = IR), labels 0-8,
    ``test_day.txt``. With ``train`` the names alternate day (D) and night
    (N), and the day frames get teacher labels 0-12
    (``labels_from_rgbteacher/``) and ``train.txt`` lists them all."""
    from heatnet_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    for d in ("images", "labels") + (("labels_from_rgbteacher",) if train else ()):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    names = [f"{i:05d}" + ("N" if train and i % 2 else "D") for i in range(n)]
    for name in names:
        write_png(os.path.join(root, "images", name + ".png"),
                  rng.randint(0, 256, (480, 640, 4)).astype(np.uint8), level=1)
        write_png(os.path.join(root, "labels", name + ".png"),
                  rng.randint(0, 9, (480, 640)).astype(np.uint8), level=1)
        if train and name.endswith("D"):
            write_png(os.path.join(root, "labels_from_rgbteacher", name + ".png"),
                      rng.randint(0, 13, (480, 640)).astype(np.uint8), level=1)
    with open(os.path.join(root, "test_day.txt"), "w") as f:
        f.write("\n".join(n for n in names if n.endswith("D")))
    if train:
        with open(os.path.join(root, "train.txt"), "w") as f:
            f.write("\n".join(names))
    return root


def write_vistas_tree(root: str, n: int, seed: int, copies: int = 1) -> str:
    """A relabelled-Vistas tree (``images/``, ``labels/``: uint16 class * 256
    + instance, classes 0-13) of ``n`` 1024x768 frames, each under
    ``copies`` names."""
    from heatnet_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    for d in ("images", "labels"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i in range(n):
        name = f"v{i:05d}_0.png"
        write_png(os.path.join(root, "images", name),
                  rng.randint(0, 256, (768, 1024, 3)).astype(np.uint8), level=1)
        # classes in blocks a learner can fit, instance ids random
        cls = (np.arange(768)[:, None] // 96 + np.arange(1024)[None, :] // 128 + i) % 14
        write_png(os.path.join(root, "labels", name),
                  (cls * 256 + rng.randint(0, 256, (768, 1024))).astype(np.uint16), level=1)
        for k in range(1, copies):
            for d in ("images", "labels"):
                shutil.copy(os.path.join(root, d, name),
                            os.path.join(root, d, f"v{i:05d}_{k}.png"))
    return root


def write_fr_train_tree(root: str, n_day: int, n_night: int, hw, seed: int,
                        shared_stamps=()) -> str:
    """A Freiburg train tree (``*/*/fl_{rgb,ir_aligned,rgb_labels}/*.png``,
    ``data/synthetic.py::make_freiburg_train``'s layout) of ``hw`` frames:
    8-bit RGB, 16-bit IR in [21000, 26000), labels 0-12 in bands; night
    frames have no labels. The first day frames take ``shared_stamps``
    ((sec, nsec) of a test tree's frames)."""
    from heatnet_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    bands = ((np.arange(h)[:, None] * 5 // h + np.arange(w)[None, :] * 6 // w) % 13
             ).astype(np.uint8)
    for i in range(n_day + n_night):
        night = i >= n_day
        base = os.path.join(root, "seq01_night" if night else "seq00_day", "drive0")
        sec, nsec = (shared_stamps[i] if i < len(shared_stamps)
                     else (1500000000 + 1000 * seed + i, 1000 * i))
        stamp = f"{sec}_{nsec:09d}.png"
        for d in ("fl_rgb", "fl_ir_aligned") + (() if night else ("fl_rgb_labels",)):
            os.makedirs(os.path.join(base, d), exist_ok=True)
        write_png(os.path.join(base, "fl_ir_aligned", "fl_ir_aligned_" + stamp),
                  rng.randint(21000, 26000, (h, w)).astype(np.uint16), level=1)
        write_png(os.path.join(base, "fl_rgb", "fl_rgb_" + stamp),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8), level=1)
        if not night:
            write_png(os.path.join(base, "fl_rgb_labels", "fl_rgb_labels_" + stamp),
                      np.roll(bands, i, axis=1), level=1)
    return root


def capture_tree_from(fr_root: str, root: str) -> str:
    """The frames of a Freiburg test tree as a capture tree (fl_rgb/ +
    fl_ir_aligned/, stamped names), as ``--infer`` and ``cli.inference`` read."""
    for d in ("fl_rgb", "fl_ir_aligned"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for name in sorted(os.listdir(os.path.join(fr_root, "ImagesRGB"))):
        stamp = name[:-len("_rgb.png")]
        shutil.copy(os.path.join(fr_root, "ImagesRGB", name),
                    os.path.join(root, "fl_rgb", f"fl_rgb_{stamp}.png"))
        shutil.copy(os.path.join(fr_root, "ImagesIR", stamp + "_ir.png"),
                    os.path.join(root, "fl_ir_aligned", f"fl_ir_aligned_{stamp}.png"))
    return root


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def reference_names(port_state_dict, prefix: str = "module.trgb_segnet."):
    """A ResNeXtSeg ``state_dict`` under the reference's module names, as
    its checkpoints hold them: each block's ``conv1``/``bn2``/``conv2``/
    ``bn3``/``conv3`` nested in ``convs``, the stem's ``conv1``/``bn1`` as
    ``conv1_2``/``bn1_2`` and ``prefix`` (a ``DataParallel``-wrapped
    ``trgb_segnet``) in front."""
    out = {}
    for key, t in port_state_dict.items():
        parts = key.split(".")
        if parts[0].startswith("mod1") and len(parts) > 1 and parts[1] in ("conv1", "bn1"):
            parts[1] += "_2"
        elif (len(parts) > 2 and parts[0].startswith("mod") and parts[1].startswith("block")
              and parts[2] in ("conv1", "bn2", "conv2", "bn3", "conv3")):
            parts.insert(2, "convs")
        out[prefix + ".".join(parts)] = t
    return out


def int8_card_times(spec_path: str, out_path: str) -> None:
    """Phase 9a's child: card time (torch.profiler) of ``int8_conv`` at each
    layer shape of ``spec["configs"]`` (cin, cout, k, s, p, d, groups, n, h,
    w), and of the int8 kernels of one batch-8 int8 forward of ResNeXt-50
    (random weights, seed 0, calibrated on its first frame) at
    ``spec["frame"]``, written to ``out_path``. A window whose kernel records
    do not match its launches reads null."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from heatnet_tpu_torch.models import get_model
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import fused_preproc as fp
    from heatnet_tpu_torch.ops import int8_conv
    from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def card_ms(fn, calls: int, tries: int = 3):
        """[ms per call of the int8 kernels, of their quantize passes, of
        their products, records, launches] over calls. A launch runs two
        kernels (int8_conv_quantize, int8_conv_gemm), so a window holds two
        records per launch; one that lost records (rare in a fresh process
        too) is taken again, up to ``tries`` windows."""
        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            before = int8_conv.INT8_CONV.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            launched = int8_conv.INT8_CONV.launches - before
            recs = [e for e in prof.events() if e.device_type.name == "CUDA"
                    and "int8_conv" in e.name]
            quant = [e for e in recs if "int8_conv_quantize" in e.name]
            if recs and len(recs) == 2 * launched and len(quant) == launched:
                total, q = (sum(e.device_time_total for e in r) / 1e3 / calls
                            for r in (recs, quant))
                return [total, q, total - q, len(recs), launched]
        return [None, None, None, len(recs), launched]

    # each shape on its phase 9a inputs: a post-ReLU x (half zeros, as the
    # layers see it) and the same x before the ReLU (signed, no zeros)
    layers = []
    for cin, cout, k, s, p, d, groups, n, h, w in spec["configs"]:
        x_signed = (torch.randn((n, h, w, cin), generator=g, device=dev) * 2).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        w_q, w_scale = int8_conv.quantize_weight(
            torch.randn((cout, cin // groups, k, k), generator=g, device=dev))
        w_pack = int8_conv.pack_weight(w_q, groups)
        x_scale = (x_signed.float().abs().amax() / 100).reshape(())
        ep = None if groups == 1 else (torch.rand(cout, generator=g, device=dev) + 0.5,
                                       torch.randn(cout, generator=g, device=dev) * 0.1,
                                       "relu", 0.01)
        args = (w_scale, x_scale, None, s, p, d, groups, ep)
        row = {}
        for tag, x in (("relu", torch.relu(x_signed)), ("signed", x_signed)):
            row[tag] = card_ms(lambda: int8_conv.int8_conv2d(x, w_q, w_pack, *args), 5)
        layers.append(row)
        del x_signed, x

    model = get_model("net_resnext50", classes=13, input_channels=4)
    init_params(model, torch.Generator().manual_seed(0))
    convert_int8(model)
    model = prepare_for_inference(model, dev)
    fh, fw = spec["frame"]
    rgb = torch.randint(0, 256, (8, fh, fw, 3), generator=g, device=dev, dtype=torch.uint8)
    ir = torch.randint(21000, 26000, (8, fh, fw, 1), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int16).view(torch.uint16)
    x_in = fp.early_fusion_input(rgb, ir, 0, fw, model.compute_dtype)
    with torch.no_grad():
        calibrate_int8(model, [(x_in[:1],)])
        fwd = card_ms(lambda: model(x_in), 2)
    with open(out_path, "w") as f:
        json.dump({"layers": layers, "forward": fwd}, f)


def serve_artifact(spec_path: str, out_path: str) -> None:
    """Phase 10e's child: load ``spec["artifact"]`` (``cli.export_model``)
    with ``torch`` and ``heatnet_tpu_torch.ops`` and nothing else of the
    port, serve the frames of ``spec["rgb"]`` / ``spec["ir"]`` (.npy) at
    batch 1 and 8 and all of them in batches of 8, and write the class maps,
    the launches of each call, the batch-8 p50/p95 (host clock, frames on
    the card, to a synchronise) and the port's modules it imported to
    ``out_path`` (.npz)."""
    import torch

    sys.path.insert(0, ROOT)
    import heatnet_tpu_torch.ops as ops

    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda")
    rgb = torch.from_numpy(np.load(spec["rgb"])).to(dev)
    ir = torch.from_numpy(np.load(spec["ir"]).view(np.int16)).to(dev).view(torch.uint16)
    t0 = time.perf_counter()
    serve = torch.export.load(spec["artifact"]).module()
    load_s = time.perf_counter() - t0
    kernels = (ops.fused_preproc.INGEST, ops.grouped_conv.GROUPED_CONV3X3,
               ops.grouped_conv.GROUPED_CONV3X3_FUSED, ops.grouped_conv.GROUPED_CONV3X3_DX,
               ops.int8_conv.INT8_CONV)

    def counts():
        return {k.name: k.launches for k in kernels}

    calls = {}
    with torch.no_grad():
        for n in (1, 8):
            before = counts()
            serve(rgb[:n], ir[:n])
            torch.cuda.synchronize()
            calls[n] = {k: v - before[k] for k, v in counts().items()}
        maps = torch.cat([serve(rgb[i:i + 8], ir[i:i + 8]) for i in range(0, len(rgb), 8)])
        ms = []
        for i in range(23):
            t1 = time.perf_counter()
            serve(rgb[:8], ir[:8])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
    np.savez(out_path, maps=maps.cpu().numpy(), meta=json.dumps({
        "launches_batch1": calls[1], "launches_batch8": calls[8], "total": counts(),
        "ms_p50_p95": [float(np.percentile(ms[3:], 50)), float(np.percentile(ms[3:], 95))],
        "load_s": load_s, "dtype": str(maps.dtype),
        "modules": sorted(m for m in sys.modules if m.startswith("heatnet_tpu_torch"))}))


def profile_serving(out_path: str) -> None:
    """Phase 11e's child: ResNeXt-50 (random weights, seed 0) serving batch 8
    of raw frames at 320x704; 3 forwards inside ``utils/profiling.trace``,
    each in an ``annotate`` span; the trace's kernel and span events, the
    launches counted around the window, ``scan_benchmark`` of the forward and
    the CUDA-event p50 of 20 forwards, written to ``out_path`` (.json). A
    fresh process, so that the profiler keeps every kernel record."""
    import torch

    sys.path.insert(0, ROOT)
    from heatnet_tpu_torch.models import get_model
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import fused_preproc as fp
    from heatnet_tpu_torch.ops import grouped_conv as gc
    from heatnet_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    kernels = (fp.INGEST, gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED,
               gc.GROUPED_CONV3X3_DX)
    model = get_model("net_resnext50", classes=13, input_channels=4)
    init_params(model, torch.Generator().manual_seed(0))
    model = prepare_for_inference(model, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rgb = torch.randint(0, 256, (N_BATCH, H_IN, W_IN, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    ir = torch.randint(21000, 26000, (N_BATCH, H_IN, W_IN, 1), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int16).view(torch.uint16)

    def forward(rgb, ir):
        x = fp.early_fusion_input(rgb, ir, 0, W_IN, model.compute_dtype)
        return model(x)[0].argmax(-1)

    span = "heatnet_serving_forward"
    trace_dir = os.path.join(os.path.dirname(out_path), "trace_11e")
    with torch.no_grad():
        for _ in range(3):
            forward(rgb, ir)
        torch.cuda.synchronize()
        before = {k.name: k.launches for k in kernels}
        with profiling.trace(trace_dir):
            for _ in range(3):
                with profiling.annotate(span):
                    forward(rgb, ir)
            torch.cuda.synchronize()
        launches = {k.name: k.launches - before[k.name] for k in kernels}
        scan_s = profiling.scan_benchmark(forward, (rgb, ir), 2, 8, reps=3)
        start = [torch.cuda.Event(enable_timing=True) for _ in range(20)]
        end = [torch.cuda.Event(enable_timing=True) for _ in range(20)]
        for s, e in zip(start, end):
            s.record()
            forward(rgb, ir)
            e.record()
        torch.cuda.synchronize()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    with open(out_path, "w") as f:
        json.dump({"launches": launches,
                   "ingest_events": sum("ingest" in e["name"] for e in kern),
                   "gc_events": sum("grouped_conv3x3" in e["name"] for e in kern),
                   "kernel_events": len(kern), "span": span,
                   "span_events": sum(e.get("name") == span
                                      and e.get("cat") == "user_annotation" for e in events),
                   "scan_ms": scan_s * 1e3,
                   "event_ms_p50": float(np.percentile(
                       [s.elapsed_time(e) for s, e in zip(start, end)], 50))}, f)


CAPTURE_FRAMES = 10       # phase 12b: frames per stream at 30 Hz, 1 ms skew
CAPTURE_LIDAR_POINTS = 32768
RELABEL_HW = (768, 1024)  # the panoptic map cli.generate_vistas relabels (--width 1024)


def capture_phase(work: str, zero_counts, read_counts) -> dict:
    """Phase 12, the capture path, on the host: 12a the native library,
    12b ``cli.dump_capture`` on a capture at the shipped rig's sizes through
    its camchain, 12c ``ThermalDriveDataset`` and the three small CLIs on
    what it wrote. ``zero_counts``/``read_counts`` are the kernels' launch
    counters, read around 12b-12c; the path launches no kernel. Returns the
    phase's record (``fail`` on any disagreement)."""
    from heatnet_tpu_torch.cli import camera_focus, dump_capture, plot_heatmap, visualize_data
    from heatnet_tpu_torch.data import calibration
    from heatnet_tpu_torch.data.loaders import ThermalDriveDataset, imread_bgr
    from heatnet_tpu_torch.data.mappings import VISTAS_TO_HEATNET, relabel_vistas_image
    from heatnet_tpu_torch.data.png import read_png, write_png
    from heatnet_tpu_torch.data.synthetic import make_drive_dump
    from heatnet_tpu_torch.native import bindings as native
    from heatnet_tpu_torch.utils.gps_heatmap import collect_heat_stats

    rec = {}
    t_12 = time.perf_counter()

    # 12a. the native library: a fresh g++ build, then each component
    zero_counts()
    with mock.patch.object(native, "BUILD_DIR", os.path.join(work, "native_build")):
        t0 = time.perf_counter()
        so = native.build()
        build_s = time.perf_counter() - t0
    rng = np.random.RandomState(21)
    h, w = RELABEL_HW
    blocks = (np.arange(h)[:, None] // 48 * 7 + np.arange(w)[None, :] // 64) % 70
    panoptic = [(blocks * 256 + rng.randint(0, 6, (h, w)) + i).astype(np.uint16)
                for i in range(4)]
    native.get_lib()  # loaded (built by 9e) before the relabellers are timed
    relabel_ms, relabelled = {}, {}
    for name, fn in (("native", native.relabel_vistas_image_native),
                     ("numpy", relabel_vistas_image)):
        t0 = time.perf_counter()
        relabelled[name] = [fn(m, VISTAS_TO_HEATNET) for m in panoptic]
        relabel_ms[name] = (time.perf_counter() - t0) * 1e3 / len(panoptic)
    relabel_equal = all(np.array_equal(a, b) for a, b in zip(relabelled["native"],
                                                             relabelled["numpy"]))
    ir = rng.randint(19000, 33000, (512, 640)).astype(np.uint16)
    grey = rng.randint(0, 256, (512, 640)).astype(np.uint8)
    v = np.minimum(ir.astype(np.float32), np.float32(30000.0))
    lo, hi = v.min(), v.max()
    u8 = ((v - lo) * (np.float32(255.0) / (hi - lo))).astype(np.uint8)
    want_inv = (255 - u8).astype(np.uint8)
    got_inv, got_mask = native.thermal_to_8bit(ir)
    thermal_equal = (np.array_equal(got_inv, want_inv) and np.array_equal(
        got_mask, np.where(want_inv > 100, 255, 0).astype(np.uint8)))
    binarize_equal = np.array_equal(native.gray_binarize(grey),
                                    np.where(grey > 140, 255, 0).astype(np.uint8))
    pushes = sorted((100.0 + i / 30 + s * 0.001, s, 1000 * s + i)
                    for s in range(4) for i in range(60))
    tuples = {}
    for name, obj in (("sync", native.Synchronizer(4, slop_s=0.016)),
                      ("burst", native.BurstSampler(4, slop_s=0.016, burst_period=1.0,
                                                    burst_img_count=5))):
        got = []
        for t, s, fid in pushes:
            obj.push(s, t, fid)
            out = obj.poll()
            if out is not None:
                got.append(out[1].tolist())
        tuples[name] = got
    want_sync = [[1000 * s + i for s in range(4)] for i in range(60)]
    sync_ok = (tuples["sync"] == want_sync and tuples["burst"]
               == [t for i, t in enumerate(want_sync) if i % 30 < 5])
    bus = native.MessageBus()
    sub = bus.subscribe("rgb_0", 2)
    for i in range(3):
        bus.publish("rgb_0", 1.0 + i, f"frame{i}".encode())
    got = [bus.poll(sub), bus.poll(sub), bus.poll(sub)]
    bus.publish("rgb_0", 5.0, b"x" * 4096)
    try:
        bus.poll(sub, max_len=1024)
        oversized_raised = False
    except BufferError:
        oversized_raised = True
    bus_ok = (got == [(2.0, b"frame1"), (3.0, b"frame2"), None] and oversized_raised
              and bus.poll(sub, max_len=4096) == (5.0, b"x" * 4096))
    print(f"  12a. native library: g++ build {build_s:.1f} s ({os.path.basename(so)}); "
          f"relabel of {len(panoptic)} {w}x{h} panoptic maps: native = numpy "
          f"{relabel_equal}, ms per frame native {relabel_ms['native']:.2f}, numpy "
          f"{relabel_ms['numpy']:.2f}; thermal_to_8bit = numpy {thermal_equal}, "
          f"gray_binarize = numpy {binarize_equal} (640x512); Synchronizer and "
          f"BurstSampler on 4 streams at 30 Hz: {len(tuples['sync'])} and "
          f"{len(tuples['burst'])} tuples as expected {sync_ok}; MessageBus round trip "
          f"and the oversized message's BufferError {bus_ok}", flush=True)
    if not (relabel_equal and thermal_equal and binarize_equal and sync_ok and bus_ok):
        fail("the native library disagrees with its numpy counterparts")
    rec["native"] = {"launches": read_counts(), "build_s": build_s,
                     "relabel_ms_per_frame": relabel_ms, "relabel_hw": [h, w]}

    # 12b. cli.dump_capture through the shipped camchain, at its sizes
    camchain = os.path.join(ROOT, "experiments", "calibrations", "example_rig",
                            "front_stereo", "camchain.yaml")
    thermal = calibration.load_kalibr_yaml(os.path.join(
        ROOT, "experiments", "calibrations", "example_rig", "thermal", "camchain.yaml"))
    cams = calibration.load_kalibr_yaml(camchain)
    rgb_wh, ir_wh = cams["left"].resolution, thermal["thermal"].resolution
    cap = os.path.join(work, "capture")
    topics = ["rgb_fl_burst", "rgb_fr_burst", "ir_left_burst", "ir_right_burst", "lidar_burst"]
    prefixes = ["fl_rgb", "fr_rgb", "fl_ir", "fr_ir", "lidar"]
    crng = np.random.RandomState(22)
    base = 1594000000.0
    ramp = (np.arange(rgb_wh[1])[:, None, None] // 4 + np.arange(rgb_wh[0])[None, :, None] // 8
            + np.arange(3)[None, None, :] * 40)
    sources = {t: [] for t in topics}
    t0 = time.perf_counter()
    for ti, topic in enumerate(topics):
        d = os.path.join(cap, "streams", topic)
        os.makedirs(d)
        for i in range(CAPTURE_FRAMES):
            t = base + i / 30 + ti * 0.001
            stem = os.path.join(d, f"{int(t)}_{int(round((t - int(t)) * 1e9))}")
            if topic.startswith("lidar"):
                np.save(stem + ".npy", crng.standard_normal(
                    (CAPTURE_LIDAR_POINTS, 4)).astype(np.float32))
            elif topic.startswith("ir"):
                frame = crng.randint(21000, 26000, (ir_wh[1], ir_wh[0])).astype(np.uint16)
                write_png(stem + ".png", frame, level=1)
            else:
                frame = ((ramp + i * 3 + crng.randint(0, 32, ramp.shape)) % 256).astype(np.uint8)
                write_png(stem + ".png", frame, level=1)
                sources[topic].append(frame)
    with open(os.path.join(cap, "tf.jsonl"), "w") as f:
        for i in range(CAPTURE_FRAMES + 2):
            f.write(json.dumps({"t": base - 1 / 30 + i / 30, "parent": "odom_combined",
                                "child": "base_link", "translation": [15.0 * i, 2.0 * i, 0.0],
                                "rotation": [0.0, 0.0, 0.0, 1.0]}) + "\n")
    with open(os.path.join(cap, "origin.json"), "w") as f:
        json.dump({"position": [413135.0, 5318474.0, 0.0]}, f)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rectifier = calibration.StereoRectifier(cams["left"], cams["right"],
                                            cams["right"].T_cn_cnm1[:3, :3],
                                            cams["right"].T_cn_cnm1[:3, 3])
    maps_s = time.perf_counter() - t0
    rectifier.remap(sources["rgb_fl_burst"][0], True)  # the plan of the left maps
    t0 = time.perf_counter()
    for frame in sources["rgb_fl_burst"][:4]:
        rectifier.remap(frame, True)
    rect_ms = (time.perf_counter() - t0) * 1e3 / 4

    zero_counts()
    out_root = os.path.join(work, "dumped")
    t0 = time.perf_counter()
    save_dir = dump_capture.main(["--capture", cap, "--out", out_root, "--topics", *topics,
                                  "--prefixes", *prefixes, "--calib", camchain,
                                  "--calib-cams", "left", "right"])
    dump_s = time.perf_counter() - t0
    if save_dir is None:
        fail("cli.dump_capture wrote no tree")
    n_windows = CAPTURE_FRAMES - 4  # each synced tuple from the 5th on closes a window
    listing = {p: sorted(os.listdir(os.path.join(save_dir, p))) for p in prefixes}
    vehicle = [line for f in os.listdir(os.path.join(save_dir, "vehicle"))
               for line in open(os.path.join(save_dir, "vehicle", f))]
    manifests = {p: [line.split() for f in os.listdir(os.path.join(save_dir, "paths"))
                     if f.startswith(p + "_drive_")
                     for line in open(os.path.join(save_dir, "paths", f))] for p in prefixes}
    heat = [f for f in os.listdir(save_dir) if f.startswith("heat_stats_")]
    heat_lines = open(os.path.join(save_dir, heat[0])).read().split() if heat else []
    html = open(os.path.join(save_dir, "heatmap.html")).read()
    frames_ok = all(len(v) == 5 * n_windows for v in listing.values())
    manifest_ok = all(len(m) == n_windows and all(
        len(line) == 5 and all(os.path.isfile(q) for q in line) for line in m)
        for m in manifests.values())
    groups = [[g.split() for g in line.split(" / ") if g.strip()] for line in vehicle]
    vehicle_ok = len(vehicle) == n_windows and all(
        len(gs) == 5 and all(len(g) == 7 for g in gs) for gs in groups)
    n_heat = len(heat_lines) // 2
    heat_ok = (n_heat >= n_windows and all(47.9 < float(x) < 48.1 for x in heat_lines[0::2])
               and f"{n_heat} points" in html and "base64," in html)
    lidar = np.load(os.path.join(save_dir, "lidar", listing["lidar"][0]))
    ir0 = read_png(os.path.join(save_dir, "fl_ir", listing["fl_ir"][0]))
    rgb0 = read_png(os.path.join(save_dir, "fl_rgb", listing["fl_rgb"][0]))
    shapes_ok = (lidar.shape == (CAPTURE_LIDAR_POINTS, 4) and ir0.dtype == np.uint16
                 and ir0.shape == (ir_wh[1], ir_wh[0])
                 and rgb0.shape == (rgb_wh[1], rgb_wh[0], 3))
    try:
        import cv2
    except ImportError:
        cv2 = None
    cv2_equal = None
    if cv2 is not None:
        T = cams["right"].T_cn_cnm1
        r1, r2, p1, p2, _ = cv2.fisheye.stereoRectify(
            cams["left"].K, cams["left"].D, cams["right"].K, cams["right"].D, rgb_wh,
            T[:3, :3], T[:3, 3], cv2.CALIB_ZERO_DISPARITY, fov_scale=1.0, balance=0.0)
        cv2_equal = {}
        for topic, prefix, cam, r, p in (("rgb_fl_burst", "fl_rgb", cams["left"], r1, p1),
                                         ("rgb_fr_burst", "fr_rgb", cams["right"], r2, p2)):
            maps = cv2.fisheye.initUndistortRectifyMap(cam.K, cam.D, r, p, rgb_wh,
                                                       cv2.CV_16SC2)
            ours = rectifier.maps_left if prefix == "fl_rgb" else rectifier.maps_right
            want = {cv2.remap(f, *maps, interpolation=cv2.INTER_LINEAR).tobytes()
                    for f in sources[topic]}
            cv2_equal[prefix] = (np.array_equal(ours[0], maps[0])
                                 and np.array_equal(ours[1], maps[1]) and all(
                read_png(os.path.join(save_dir, prefix, f)).tobytes() in want
                for f in listing[prefix]))
    launches_12b = read_counts()
    print(f"  12b. cli.dump_capture of {CAPTURE_FRAMES} frames per stream (RGB "
          f"{rgb_wh[0]}x{rgb_wh[1]} x2, IR {ir_wh[0]}x{ir_wh[1]} x2, lidar "
          f"{CAPTURE_LIDAR_POINTS}x4) through {os.path.relpath(camchain, ROOT)}: "
          f"{n_windows} windows, {sum(len(v) for v in listing.values())} files, manifests "
          f"{ {p: len(m) for p, m in manifests.items()} } lines of 5 paths {manifest_ok}, "
          f"frames {frames_ok}, vehicle lines {vehicle_ok}, {n_heat} heat points and the "
          f"HTML {heat_ok}, shapes {shapes_ok}; frames equal to cv2 "
          f"{cv2.__version__ if cv2 else '(cv2 does not import)'}'s remap on cv2's maps, "
          f"bit for bit: {cv2_equal}; host ms: maps {maps_s * 1e3:.1f}, "
          f"{rect_ms:.1f} per rectified {rgb_wh[0]}x{rgb_wh[1]} RGB frame, capture "
          f"written in {write_s:.1f} s, dump wall time {dump_s:.1f} s; launches "
          f"{launches_12b}", flush=True)
    if not (frames_ok and manifest_ok and vehicle_ok and heat_ok and shapes_ok):
        fail("cli.dump_capture did not write the expected tree")
    if cv2_equal is not None and not all(cv2_equal.values()):
        fail(f"the rectified frames differ from cv2's: {cv2_equal}")
    rec["dump_capture"] = {"launches": launches_12b, "windows": n_windows,
                           "dump_s": dump_s, "rectify_ms_per_frame": rect_ms,
                           "maps_ms": maps_s * 1e3, "equal_cv2": cv2_equal}

    # 12c. the loaders and the small CLIs on what 12b wrote
    zero_counts()
    item_ms = {}
    for name, opts in (("default", {}), ("contrast_enhancement",
                                         {"contrast_enhancement": True, "load_right": False})):
        ds = ThermalDriveDataset(os.path.join(save_dir, "paths"), **opts)  # the manifests
        n = len(ds) if not opts else 1  # CLAHE on 5 full frames per item: one item
        t0 = time.perf_counter()
        items = [ds[i] for i in range(n)]
        item_ms[name] = (time.perf_counter() - t0) * 1e3 / n
        if len(ds) != n_windows:
            fail(f"ThermalDriveDataset found {len(ds)} bursts, expected {n_windows}")
        for it in items:
            right = opts.get("load_right", True)
            ok = (len(it["rgb_fl"]) == len(it["ir_fl"]) == 5
                  and (not right or len(it["rgb_fr"]) == len(it["ir_fr"]) == 5)
                  and all(x.shape == (rgb_wh[1], rgb_wh[0], 3) and x.dtype == np.float32
                          and 0 <= x.min() and x.max() <= 1 for x in it["rgb_fl"])
                  and all(x.shape == (ir_wh[1], ir_wh[0], 1) for x in it["ir_fl"] + it["ir_fr"])
                  and np.array_equal(it["ir_fl"][0][..., 0],
                                     read_png(it["paths_left"][0].replace("fl_rgb", "fl_ir"))))
            if not opts:
                ok = ok and np.array_equal(it["org_left"], imread_bgr(it["paths_left"][0]))
            if not ok:
                fail(f"ThermalDriveDataset ({name}) item differs from the dumped tree")
    dd = make_drive_dump(os.path.join(work, "drive_dump"), n_drives=1, n_bursts=4, burst=2,
                         hw=(ir_wh[1], ir_wh[0]))
    t0 = time.perf_counter()
    n_vis = visualize_data.main(["-s", dd, "--save-dir", os.path.join(work, "vis_out")])
    vis_ms = (time.perf_counter() - t0) * 1e3 / max(n_vis, 1)
    vis_files = sorted(os.listdir(os.path.join(work, "vis_out")))
    overlay = read_png(os.path.join(work, "vis_out", vis_files[1]))
    t0 = time.perf_counter()
    fdes = camera_focus.main(["--images", os.path.join(save_dir, "fl_rgb")])
    focus_ms = (time.perf_counter() - t0) * 1e3 / max(len(fdes), 1)
    lats, _ = collect_heat_stats(save_dir)
    t0 = time.perf_counter()
    n_plot = plot_heatmap.main(["--core-dir", save_dir, "--out",
                                os.path.join(work, "heatmaps.html")])
    plot_ms = (time.perf_counter() - t0) * 1e3
    launches_12c = read_counts()
    print(f"  12c. ThermalDriveDataset on the dump: {n_windows} bursts, host ms per item "
          f"{ {k: round(v, 1) for k, v in item_ms.items()} }; cli.visualize_data on a "
          f"{ir_wh[0]}x{ir_wh[1]} drive dump: {n_vis} triples ({len(vis_files)} files, "
          f"overlay {overlay.shape}), {vis_ms:.1f} ms each; cli.camera_focus: "
          f"{len(fdes)} FDEs, {focus_ms:.1f} ms per frame; cli.plot_heatmap: {n_plot} "
          f"points, {plot_ms:.1f} ms; launches {launches_12c}", flush=True)
    if (n_vis != 4 or len(vis_files) != 12 or overlay.shape != (ir_wh[1], ir_wh[0], 3)
            or len(fdes) != 5 * n_windows or not all(np.isfinite(list(fdes.values())))
            or n_plot != len(lats) or n_plot != n_heat):
        fail("the capture CLIs did not run as expected")
    if any(v for r in (rec["native"]["launches"], launches_12b, launches_12c)
           for v in r.values()):
        fail(f"the capture path launched kernels: {rec['native']['launches']}, "
             f"{launches_12b}, {launches_12c}")
    rec["capture_tools"] = {"launches": launches_12c, "item_ms": item_ms,
                            "visualize_ms_per_triple": vis_ms, "focus_ms_per_frame": focus_ms,
                            "plot_heatmap_ms": plot_ms}
    print(f"  phase 12: {time.perf_counter() - t_12:.1f} s", flush=True)
    return rec


SPATIAL_HW = (640, 1920)  # phase 13: a 650x1920 Freiburg source frame cut to 640 rows
SPATIAL_PROCS = 4         # processes sharing the card, one shard of rows each
SPATIAL_REPS = 10         # timed forwards, after one warm-up and the counted one
SPATIAL_TIMEOUT_S = 420   # for the workers together
SPATIAL_MIN_AGREEMENT = 0.999  # outside the unsharded forward's near ties (below)
# The gathered logits against the unsharded forward's: both round bf16 sums,
# in another order where cuDNN takes another engine for a shard's rows, so
# the largest difference is a bf16 step or two of the largest |logit|; a row
# out of place would move logits by their own size
SPATIAL_LOGIT_TOL = 2.0 ** -7
SPATIAL_PER_FORWARD = {"ingest": 1, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16,
                       "grouped_conv3x3_dx": 0, "int8_conv": 0}


def spatial_worker(spec_path: str, out_path: str) -> None:
    """Phase 13's worker, rank ``RANK`` of ``WORLD_SIZE`` in a gloo group on
    the one card: ResNeXt-50 from ``spec["weights"]`` serves the frame of
    ``spec["frames"]`` split by rows (``parallel/spatial.py::serve_frame``:
    ``shard_rows``, the ingest kernel on its raw rows, the model under
    ``spatial_parallel``, argmax, the class map gathered). One warm-up
    forward, one with the launches and the exchanges read around it, then
    ``spec["reps"]`` timed forwards (host clock, each after a barrier, to a
    synchronise). Each halo exchange after the warm-up is timed by CUDA
    events recorded around its ``all_gather`` on the stream, read after the
    forward's synchronise: the device-to-host copy, gloo and the copy back.
    Writes its record to ``out_path`` (.json) and, rank 0, the class map and
    the gathered logits beside it (.npz)."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from heatnet_tpu_torch.models import net_resnext50
    from heatnet_tpu_torch.models.layers import prepare_for_inference
    from heatnet_tpu_torch.ops import fused_preproc as fp
    from heatnet_tpu_torch.ops import grouped_conv as gc
    from heatnet_tpu_torch.ops import int8_conv
    from heatnet_tpu_torch.parallel import mesh as pm
    from heatnet_tpu_torch.parallel import spatial

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{spec['port']}",
                            rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=SPATIAL_TIMEOUT_S))
    model = net_resnext50(classes=13, input_channels=4)
    model.load_state_dict(torch.load(spec["weights"], map_location="cpu", weights_only=True))
    model = prepare_for_inference(model, dev)
    frames = dict(np.load(spec["frames"]))
    mesh = pm.create_mesh()
    kernels = (fp.INGEST, gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED,
               gc.GROUPED_CONV3X3_DX, int8_conv.INT8_CONV)

    events, exchange_ms = [], []

    def timed_all_gather(group, t):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = pm.all_gather(group, t)
        end.record()
        events.append((start, end))
        return out

    def serve():
        out = spatial.serve_frame(model, frames, mesh, dev)
        torch.cuda.synchronize()
        exchange_ms.append(sum(a.elapsed_time(b) for a, b in events))
        events.clear()
        return out

    serve()
    exchange_ms.clear()
    for k in kernels:
        k.launches = 0
    spatial.reset_exchange()
    dist.barrier()
    with mock.patch.object(spatial, "all_gather", timed_all_gather):
        pred, seg, _ = serve()
        launches = {k.name: k.launches for k in kernels}
        exchange = dict(spatial.EXCHANGE)
        seg_full = pm.gather_rows(seg, pm.spatial_sharding(mesh))
        ms = []
        for _ in range(spec["reps"]):
            dist.barrier()
            t0 = time.perf_counter()
            serve()
            ms.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        np.savez(out_path[:-len(".json")] + ".npz", pred=pred.cpu().numpy(),
                 seg=seg_full.cpu().numpy())
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "launches": launches, "exchange": exchange,
                   "exchange_ms": exchange_ms, "shard": list(seg.shape), "ms": ms}, f)
    dist.destroy_process_group()


def spatial_phase(work: str, card: str, zero_counts, read_counts) -> dict:
    """Phase 13: one 640x1920 frame served by ResNeXt-50 split by rows over
    ``SPATIAL_PROCS`` worker processes on the one card (``spatial_worker``),
    against the unsharded forward of the same weights here, through the
    kernels and through their plain versions. Returns the phase's record
    (``fail`` on any disagreement)."""
    import torch

    from heatnet_tpu_torch.data.loaders import to_device
    from heatnet_tpu_torch.models import net_resnext50
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import fused_preproc as fp
    from heatnet_tpu_torch.ops import grouped_conv as gc

    t_13 = time.perf_counter()
    dev = torch.device("cuda")
    h, w = SPATIAL_HW
    net = net_resnext50(classes=13, input_channels=4)
    init_params(net, torch.Generator().manual_seed(0))
    weights = os.path.join(work, "spatial_weights.pt")
    torch.save(net.state_dict(), weights)
    net = prepare_for_inference(net, dev)
    prng = np.random.RandomState(13)
    frames = {"rgb": prng.randint(0, 256, (1, h, w, 3)).astype(np.uint8),
              "ir": prng.randint(21000, 26000, (1, h, w, 1)).astype(np.uint16)}
    frames_path = os.path.join(work, "spatial_frames.npz")
    np.savez(frames_path, **frames)

    # the unsharded forward of the same weights, a comparison only
    rgb, ir = to_device(frames["rgb"], dev), to_device(frames["ir"], dev)

    def forward():
        with torch.no_grad():
            seg = net(fp.early_fusion_input(rgb, ir, 0, w, net.compute_dtype))[0]
            pred = seg.argmax(dim=-1)
        torch.cuda.synchronize()
        return seg, pred

    zero_counts()
    seg_ref, pred_ref = forward()
    once = read_counts()
    ms_ref = []
    for _ in range(SPATIAL_REPS + 3):
        t0 = time.perf_counter()
        forward()
        ms_ref.append((time.perf_counter() - t0) * 1e3)
    ref_p50 = float(np.percentile(ms_ref[3:], 50))

    def ingest_plain(rgb, ir, lo, hi, out_dtype=torch.bfloat16):
        return torch.cat([fp.rgb_plain(rgb[..., lo:hi, :]),
                          fp.ir_plain(ir[..., lo:hi, :])], -1).to(out_dtype)

    def conv_plain(x, w, scale, bias, groups, dilation=1, act="relu", slope=0.01):
        return gc.grouped_conv3x3_plain(x, w, groups, dilation, scale, bias, act, slope)

    zero_counts()
    with mock.patch.object(fp, "early_fusion_input", ingest_plain), \
            mock.patch.object(gc, "grouped_conv3x3_fused", conv_plain):
        _, pred_plain = forward()
    if any(read_counts().values()):
        fail(f"phase 13: the plain-version forward launched a kernel: {read_counts()}")
    zero_counts()

    spec = os.path.join(work, "spatial_spec.json")
    with open(spec, "w") as f:
        json.dump({"port": free_port(), "weights": weights, "frames": frames_path,
                   "reps": SPATIAL_REPS}, f)
    outs = [os.path.join(work, f"spatial_rank{r}.json") for r in range(SPATIAL_PROCS)]
    env = dict(os.environ, WORLD_SIZE=str(SPATIAL_PROCS))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--spatial-worker",
                               spec, outs[r]], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(SPATIAL_PROCS)]
    logs = []
    try:
        for p in procs:
            remaining = max(1.0, SPATIAL_TIMEOUT_S - (time.perf_counter() - t0))
            logs.append(p.communicate(timeout=remaining)[0])
    except subprocess.TimeoutExpired:
        fail(f"phase 13: a worker did not exit within {SPATIAL_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    workers_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"phase 13: worker {r} exited {p.returncode}:\n{log[-3000:]}")
    recs = []
    for out in outs:
        with open(out) as f:
            recs.append(json.load(f))
    got = np.load(outs[0][:-len(".json")] + ".npz")
    pred, seg = got["pred"], torch.from_numpy(got["seg"]).to(dev)
    if pred.shape != (1, h, w) or seg.shape != seg_ref.shape or not bool(
            torch.isfinite(seg).all()):
        fail(f"phase 13: gathered class map {pred.shape}, logits {tuple(seg.shape)}")
    pred = torch.from_numpy(pred).to(dev).long()
    top2 = seg_ref.float().topk(2, dim=-1).values
    max_diff = float((seg.float() - seg_ref.float()).abs().max())
    rel = max_diff / float(seg_ref.float().abs().max())
    # where the unsharded forward's two best logits lie within twice the
    # largest difference, the class may rightly flip; elsewhere it may not
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * max_diff
    same = pred == pred_ref
    agree_raw = float(same.float().mean())
    agree = float((same | near_tie).float().mean())
    agree_plain = float((pred == pred_plain).float().mean())
    agree_ref_plain = float((pred_ref == pred_plain).float().mean())
    exact = bool(torch.equal(seg, seg_ref))

    stage_rows = [(name, d, h // SPATIAL_PROCS // stride, n)
                  for name, d, stride, n in (("mod2", 1, 4, 3), ("mod3", 1, 8, 4),
                                             ("mod4", 2, 8, 6), ("mod5", 4, 8, 3))]
    print(f"  {card}", flush=True)
    print(f"  unsharded forward at {h}x{w}, batch 1 (host clock, ingest to argmax): p50 "
          f"{ref_p50:.3f} ms; launches {once}", flush=True)
    for rec in recs:
        ex = rec["exchange"]
        print(f"  worker {rec['rank']}: shard {rec['shard']}; launches per forward "
              f"{rec['launches']}; forward p50 {float(np.percentile(rec['ms'], 50)):.3f} ms "
              f"({SPATIAL_PROCS} processes share one card: not a latency figure); "
              f"exchanges per forward {ex['calls']}, {ex['bytes'] / 1e6:.3f} MB received, "
              f"p50 {float(np.percentile(rec['exchange_ms'], 50)):.3f} ms (CUDA events "
              f"around each all_gather: to the host, gloo, back); grouped convs: {ex['extra_rows']} extra rows beside {ex['rows']} shard rows",
              flush=True)
    print("  extra rows per grouped conv, per shard: " + ", ".join(
        f"{name} 2x{d} of {rows} ({2 * d / rows:.1%}) x{n}" for name, d, rows, n in stage_rows),
        flush=True)
    print(f"  class map against the unsharded forward: {agree:.6f} of pixels equal or "
          f"near ties (need >= {SPATIAL_MIN_AGREEMENT}; {agree_raw:.6f} equal, "
          f"{float(near_tie.float().mean()):.6f} near ties, top-2 gap <= {2 * max_diff:.3g}); "
          f"largest logit difference {rel:.3g} of the largest |logit| (need <= "
          f"{SPATIAL_LOGIT_TOL:.3g}; logits bit for bit: {exact})", flush=True)
    print(f"  class map against the unsharded forward through the plain versions: "
          f"{agree_plain:.6f} of pixels (need >= {MIN_AGREEMENT}; the unsharded kernel "
          f"forward's: {agree_ref_plain:.6f}); workers {workers_s:.1f} s; phase 13 "
          f"{time.perf_counter() - t_13:.1f} s", flush=True)
    bad = [rec["rank"] for rec in recs if rec["launches"] != SPATIAL_PER_FORWARD]
    if bad:
        fail(f"phase 13: workers {bad} launched other than {SPATIAL_PER_FORWARD} per forward")
    if rel > SPATIAL_LOGIT_TOL:
        fail(f"phase 13: largest logit difference {rel} of the largest |logit| > "
             f"{SPATIAL_LOGIT_TOL}")
    if agree < SPATIAL_MIN_AGREEMENT:
        fail(f"phase 13: class-map agreement {agree} < {SPATIAL_MIN_AGREEMENT}")
    if agree_plain < MIN_AGREEMENT:
        fail(f"phase 13: class-map agreement with the plain versions {agree_plain} < "
             f"{MIN_AGREEMENT}")
    launches = {k: sum(rec["launches"][k] for rec in recs) for k in SPATIAL_PER_FORWARD}
    return {"spatial_serving": {
        "launches": launches, "agreement": agree, "agreement_equal": agree_raw,
        "near_tie_share": float(near_tie.float().mean()), "max_logit_diff_rel": rel,
        "logits_bit_for_bit": exact, "agreement_plain": agree_plain,
        "unsharded_forward_ms_p50": ref_p50,
        "worker_forward_ms_p50": [float(np.percentile(rec["ms"], 50)) for rec in recs],
        "exchange_per_forward": [rec["exchange"] for rec in recs],
        "exchange_ms_p50": [float(np.percentile(rec["exchange_ms"], 50)) for rec in recs],
        "workers_s": workers_s}}


def main() -> None:
    if sys.argv[1:2] == ["--int8-card-times"]:
        int8_card_times(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--serve-artifact"]:
        serve_artifact(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--profile-serving"]:
        profile_serving(sys.argv[2])
        return
    if sys.argv[1:2] == ["--spatial-worker"]:
        spatial_worker(*sys.argv[2:4])
        return
    with tempfile.TemporaryDirectory() as work:
        run_phases(work)


def run_phases(work: str) -> None:
    """Every phase; ``work`` holds what one phase hands to the next."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "heatnet_tpu_torch", "csrc")):
        fail(f"no heatnet_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)

    import torch.nn.functional as F

    from heatnet_tpu_torch.cli import inference as cli
    from heatnet_tpu_torch.cli import train_conf, train_plain
    from heatnet_tpu_torch.data.loaders import DeviceAugment, batch_iterator
    from heatnet_tpu_torch.data.packed import (PackedFrameDataset,
                                               PackedFreiburgTrainDataset,
                                               write_pack, write_train_pack)
    from heatnet_tpu_torch.eval import validate
    from heatnet_tpu_torch.io.checkpoint import save_checkpoint
    from heatnet_tpu_torch.kernels import build
    from heatnet_tpu_torch.models import ConfSegnet, ResNeXtSeg, get_model
    from heatnet_tpu_torch.models.layers import init_params, prepare_for_inference
    from heatnet_tpu_torch.ops import fused_preproc as fp
    from heatnet_tpu_torch.ops import grouped_conv as gc
    from heatnet_tpu_torch.train import adversarial as adv
    from heatnet_tpu_torch.train.state import init_model
    from heatnet_tpu_torch.train.supervised import cross_entropy_ignore

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}",
          flush=True)
    with open(os.path.join(build.BUILD_DIR, "nvcc.log")) as f:
        for line in f:
            if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                print("  ptxas:", line.strip())

    def time_ms(fn, reps: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps: int = 10, windows: int = 5) -> float:
        """Card time of every kernel one call launches (torch.profiler), so
        that a call whose host side outlasts its kernels reads its kernels.
        A window in which the profiler kept no kernel record is taken again."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(windows):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            total = sum(e.device_time_total for e in prof.key_averages()
                        if e.device_type.name == "CUDA")
            if total > 0:
                return total / 1e3 / reps
        fail(f"torch.profiler kept no kernel record in {windows} windows")

    def check(name, out, ref, tol_fn, tol_text) -> float:
        torch.cuda.synchronize()
        out, ref = out.detach().float(), ref.detach().float()
        if out.shape != ref.shape:
            fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
        diff = (out - ref).abs()
        err = float(diff.max())
        ok = bool(torch.isfinite(out).all()) and bool((diff <= tol_fn(ref)).all())
        print(f"  {name}: max_abs_err {err:.3g} (tolerance {tol_text}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version")
        return err

    rng = np.random.RandomState(0)

    def frames(n, h, w):
        rgb = torch.from_numpy(rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8))
        ir = rng.randint(20000, 27000, (n, h, w, 1)).astype(np.uint16)
        ir = torch.from_numpy(ir.view(np.int16)).to(dev).view(torch.uint16)
        return rgb.to(dev), ir

    # 3a. ingest: f32 bit-for-bit up to 1e-6; bf16 within one rounding step
    print("kernels: ingest", flush=True)
    tol = {torch.float32: (lambda r: 1e-6, "1e-6"),
           torch.bfloat16: (lambda r: 2.0 ** -8, "2^-8, one bf16 ulp below 1")}
    ingest_err, ingest_ms = 0.0, {}
    for w_full, lo, hi in ((960, 148, 852), (W_IN, 0, W_IN)):
        rgb, ir = frames(N_BATCH, H_IN, w_full)
        plain_rgb = fp.rgb_plain(rgb[..., lo:hi, :])
        plain_ir = fp.ir_plain(ir[..., lo:hi, :])
        for dtype in (torch.bfloat16, torch.float32):
            t_fn, t_text = tol[dtype]
            tag = f"{w_full}[{lo}:{hi}] {str(dtype)[6:]}"
            ingest_err = max(ingest_err, check(
                f"early_fusion_input {tag}", fp.early_fusion_input(rgb, ir, lo, hi, dtype),
                torch.cat([plain_rgb, plain_ir], -1).to(dtype), t_fn, t_text))
            r_out, i_out = fp.inference_preprocess_fused(rgb, ir, lo, hi, dtype)
            ingest_err = max(ingest_err, check(
                f"inference_preprocess_fused rgb {tag}", r_out, plain_rgb.to(dtype), t_fn, t_text))
            ingest_err = max(ingest_err, check(
                f"inference_preprocess_fused ir {tag}", i_out, plain_ir.to(dtype), t_fn, t_text))
        ingest_err = max(ingest_err, check(
            f"rgb_normalize_fused {w_full}", fp.rgb_normalize_fused(rgb),
            fp.rgb_plain(rgb).to(torch.bfloat16), *tol[torch.bfloat16]))
        ingest_err = max(ingest_err, check(
            f"ir_normalize_fused {w_full}", fp.ir_normalize_fused(ir),
            fp.ir_plain(ir).to(torch.bfloat16), *tol[torch.bfloat16]))
        ingest = lambda: fp.early_fusion_input(rgb, ir, lo, hi)
        k_ms, k_dev = time_ms(ingest), device_ms(ingest)
        p_ms = time_ms(lambda: torch.cat([fp.rgb_plain(rgb[..., lo:hi, :]),
                                          fp.ir_plain(ir[..., lo:hi, :])], -1)
                       .to(torch.bfloat16))
        n_pix = N_BATCH * H_IN * (hi - lo)
        b_ms, b_by = bound_ms(n_pix * (3 + 2) + n_pix * 4 * 2, n_pix * 4 * 4)
        ingest_ms[(w_full, lo, hi)] = (k_ms, p_ms, b_ms, b_by, k_dev)
        print(f"  early_fusion_input bf16 ({N_BATCH},{H_IN},{w_full}) window "
              f"{lo}:{hi}: kernel_ms {k_ms:.4f} (device {k_dev:.4f}) plain_ms "
              f"{p_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); share of bound, eager "
              f"{b_ms / k_ms:.3f} / card {b_ms / k_dev:.3f}", flush=True)

    # 3b. grouped conv, plain and fused with each act, at every stage shape.
    # Both sides round f32 sums to bf16 once; they differ only where the
    # summation order moves a sum across a rounding boundary: one bf16 step.
    print("kernels: grouped_conv3x3", flush=True)
    gc_tol = (lambda r: 2.0 ** -7 * r.abs() + 1e-3, "2^-7 |plain| + 1e-3")
    gc_err, gc_rows = 0.0, []
    for name, c, cpg, d, h, w, count in STAGES:
        g = torch.Generator(device="cpu").manual_seed(c)
        x = torch.randn((N_BATCH, h, w, c), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
              ).to(dev, torch.bfloat16)
        scale = (torch.rand(c, generator=g) + 0.5).to(dev)
        bias = (torch.randn(c, generator=g) * 0.1).to(dev)
        gc_err = max(gc_err, check(
            f"grouped_conv3x3 {name}", gc.grouped_conv3x3(x, wt, c // cpg, d),
            gc.grouped_conv3x3_plain(x, wt, c // cpg, d), *gc_tol))
        for act in ("relu", "leaky_relu", "elu", "none"):
            gc_err = max(gc_err, check(
                f"grouped_conv3x3_fused {name} {act}",
                gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d, act, 0.01),
                gc.grouped_conv3x3_plain(x, wt, c // cpg, d, scale, bias, act, 0.01),
                *gc_tol))
        fused = lambda: gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d)
        k_ms, k_dev = time_ms(fused), device_ms(fused)
        p_ms = time_ms(lambda: gc.grouped_conv3x3_plain(
            x, wt, c // cpg, d, scale, bias, "relu"), reps=5)
        x_cl = x.permute(0, 3, 1, 2)
        lib = lambda: F.conv2d(x_cl, wt, padding=d, dilation=d, groups=c // cpg)
        l_ms, l_dev = time_ms(lib), device_ms(lib)
        n_bytes = 2 * x.numel() * 2 + wt.numel() * 2 + 2 * c * 4
        flops = 2 * x.numel() * cpg * 9
        b_ms, b_by = bound_ms(n_bytes, flops)
        gc_rows.append((name, count, k_ms, p_ms, l_ms, b_ms, n_bytes, flops, k_dev, l_dev))
        print(f"  {name} (C {c}, cpg {cpg}, d {d}, {N_BATCH}x{h}x{w}) fused relu: "
              f"kernel_ms {k_ms:.4f} (device {k_dev:.4f}) plain_ms {p_ms:.4f} "
              f"library_ms {l_ms:.4f} (device {l_dev:.4f}) bound_ms {b_ms:.4f} "
              f"({b_by}, {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
              f"share of bound {b_ms / k_ms:.3f}", flush=True)

    # 3b'. the shapes of phase 13's shards: ingest on one shard's raw rows,
    # and the fused grouped conv at batch 1 on each stage's halo-extended
    # shard (its rows plus d a side), against the plain versions
    print("kernels: phase 13's shard shapes", flush=True)
    s_rows, s_w = SPATIAL_HW[0] // SPATIAL_PROCS, SPATIAL_HW[1]
    rgb, ir = frames(1, s_rows, s_w)
    for dtype in (torch.bfloat16, torch.float32):
        ingest_err = max(ingest_err, check(
            f"early_fusion_input (1,{s_rows},{s_w}) window 0:{s_w} {str(dtype)[6:]}",
            fp.early_fusion_input(rgb, ir, 0, s_w, dtype),
            torch.cat([fp.rgb_plain(rgb), fp.ir_plain(ir)], -1).to(dtype), *tol[dtype]))
    for name, c, cpg, d, _, _, _ in STAGES:
        stride = 4 if name == "mod2" else 8
        shape = (1, s_rows // stride + 2 * d, s_w // stride, c)
        g = torch.Generator(device="cpu").manual_seed(c + 13)
        x = torch.randn(shape, generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
              ).to(dev, torch.bfloat16)
        scale = (torch.rand(c, generator=g) + 0.5).to(dev)
        bias = (torch.randn(c, generator=g) * 0.1).to(dev)
        for act in ("relu", "leaky_relu", "elu", "none"):
            gc_err = max(gc_err, check(
                f"grouped_conv3x3_fused {name} {shape} {act}",
                gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d, act, 0.01),
                gc.grouped_conv3x3_plain(x, wt, c // cpg, d, scale, bias, act, 0.01),
                *gc_tol))

    # 3c. the grouped conv's gradients at the training shapes, against
    # autograd of the plain version in f32 on the same bf16-valued inputs
    print("kernels: grouped_conv3x3 gradients (GroupedConv3x3Function)", flush=True)
    dx_err, dx_rows = 0.0, []
    for name, c, cpg, d, h, w, count in TRAIN_STAGES:
        groups = c // cpg
        g = torch.Generator(device="cpu").manual_seed(c + 1)
        x = torch.randn((N_TRAIN, h, w, c), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5).to(dev)
        dy = torch.randn((N_TRAIN, h, w, c), generator=g).to(dev, torch.bfloat16)
        xk, wk = x.clone().requires_grad_(), wt.clone().requires_grad_()
        y = gc.differentiable_grouped_conv3x3(xk, wk, groups, d)
        y.backward(dy)
        xr = x.float().requires_grad_()
        wr = wt.to(torch.bfloat16).float().requires_grad_()
        y_ref = gc.grouped_conv3x3_plain(xr, wr, groups, d)
        y_ref.backward(dy.float())
        check(f"forward {name}", y, y_ref, *gc_tol)
        dx_err = max(dx_err, check(f"dx {name}", xk.grad, xr.grad, *gc_tol))
        rel = float((wk.grad - wr.grad).norm() / wr.grad.norm())
        print(f"  dk {name}: rel L2 {rel:.3g} (tolerance {DK_TOL}) "
              f"{'ok' if rel <= DK_TOL else 'FAIL'}", flush=True)
        if not rel <= DK_TOL or wk.grad.dtype != torch.float32:
            fail(f"dk {name} disagrees with autograd of the plain version")
        del xr, wr, y_ref, xk, wk, y

        wb = wt.to(torch.bfloat16)
        w_flip = gc.dx_weight(wb, groups)
        fwd = lambda: gc.grouped_conv3x3(x, wb, groups, d)
        f_ms, f_dev = time_ms(fwd), device_ms(fwd)
        fp_ms = time_ms(lambda: gc.grouped_conv3x3_plain(x, wb, groups, d), reps=5)
        x_cl = x.permute(0, 3, 1, 2)
        f_lib = lambda: F.conv2d(x_cl, wb, padding=d, dilation=d, groups=groups)
        fl_ms, fl_dev = time_ms(f_lib), device_ms(f_lib)
        dxk = lambda: gc.grouped_conv3x3_dx(dy, wb, groups, d)
        k_ms, k_dev = time_ms(dxk), device_ms(dxk)
        p_ms = time_ms(lambda: gc.grouped_conv3x3_plain(dy, w_flip, groups, d), reps=5)
        dy_cl = dy.permute(0, 3, 1, 2)
        dx_lib = lambda: torch.nn.grad.conv2d_input(
            (N_TRAIN, c, h, w), wb, dy_cl, padding=d, dilation=d, groups=groups)
        l_ms, l_dev = time_ms(dx_lib), device_ms(dx_lib)
        dk_ms = time_ms(lambda: gc.grouped_conv3x3_weight_grad(x, dy, groups, d))
        n_bytes = 2 * x.numel() * 2 + wb.numel() * 2
        flops = 2 * x.numel() * cpg * 9
        b_ms, b_by = bound_ms(n_bytes, flops)
        dx_rows.append((name, count, k_ms, p_ms, l_ms, b_ms, n_bytes, flops, f_ms, dk_ms,
                        fl_ms, fp_ms, f_dev, fl_dev, k_dev, l_dev))
        print(f"  {name} (C {c}, cpg {cpg}, d {d}, {N_TRAIN}x{h}x{w}), bound_ms "
              f"{b_ms:.4f} per direction ({b_by}, {n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP):\n"
              f"    forward kernel_ms {f_ms:.4f} (device {f_dev:.4f}) plain_ms "
              f"{fp_ms:.4f} library_ms {fl_ms:.4f} (device {fl_dev:.4f}, conv2d) "
              f"share of bound {b_ms / f_ms:.3f}\n"
              f"    dx kernel_ms {k_ms:.4f} (device {k_dev:.4f}) plain_ms {p_ms:.4f} "
              f"library_ms {l_ms:.4f} (device {l_dev:.4f}, conv2d_input) share of "
              f"bound {b_ms / k_ms:.3f}; dk library_ms {dk_ms:.4f}", flush=True)
        del x, dy, dy_cl, x_cl
    torch.cuda.empty_cache()

    # 3d. the grouped conv at the stage shapes of Vistas pretraining (forward
    # and dx at batch 30, fused at eval batch 16, 384x768) and of MFNet
    # adversarial training (all three at batch 16, 384x384)
    print("kernels: grouped_conv3x3 at the Vistas (batch 30 / 16, 384x768) and MFNet "
          "(batch 16, 384x384) stage shapes", flush=True)
    for which, n, c, cpg, d, h, w in VIS_MF_STAGES:
        g = torch.Generator(device="cpu").manual_seed(c + h + n)
        x = torch.randn((n, h, w, c), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
              ).to(dev, torch.bfloat16)
        where = f"(N {n}, C {c}, cpg {cpg}, d {d}, {h}x{w})"
        if which != "fused":
            gc_err = max(gc_err, check(f"grouped_conv3x3 {where}",
                                       gc.grouped_conv3x3(x, wt, c // cpg, d),
                                       gc.grouped_conv3x3_plain(x, wt, c // cpg, d), *gc_tol))
            dx_err = max(dx_err, check(
                f"grouped_conv3x3_dx {where}", gc.grouped_conv3x3_dx(x, wt, c // cpg, d),
                gc.grouped_conv3x3_plain(x, gc.dx_weight(wt, c // cpg), c // cpg, d),
                *gc_tol))
        if which != "fwd_dx":
            scale = (torch.rand(c, generator=g) + 0.5).to(dev)
            bias = (torch.randn(c, generator=g) * 0.1).to(dev)
            gc_err = max(gc_err, check(
                f"grouped_conv3x3_fused {where}",
                gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d, "leaky_relu", 0.01),
                gc.grouped_conv3x3_plain(x, wt, c // cpg, d, scale, bias, "leaky_relu", 0.01),
                *gc_tol))
        del x, wt
    torch.cuda.empty_cache()

    # 4. the main path through the CLI
    print("main path: cli.inference, ResNeXt-50 (3,4,6,3), batch 8", flush=True)
    iters = 3
    with tempfile.TemporaryDirectory() as pack:
        prng = np.random.RandomState(1)
        write_pack(pack, prng.randint(0, 256, (16, H_IN, W_IN, 3)).astype(np.uint8),
                   prng.randint(21000, 26000, (16, H_IN, W_IN, 1)).astype(np.uint16))
        argv = ["--data", pack, "--batch", str(N_BATCH), "--iters", str(iters)]
        kernels = (fp.INGEST, gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        run = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        forwards = 1 + iters + 2  # warm-up, timing iterations, two batches
        print(f"  launches {launches} over {forwards} forwards "
              f"({wall:.1f} s wall, batch 1 network {run.network_seconds * 1e3:.2f} ms)",
              flush=True)
        if (launches["ingest"] < forwards or launches["grouped_conv3x3"]
                or launches["grouped_conv3x3_fused"] != 16 * forwards):
            fail(f"expected >= {forwards} ingest and {16 * forwards} fused grouped-conv "
                 f"launches, got {launches}")
        maps = run.maps
        if maps.shape != (16, H_IN, W_IN) or maps.dtype != np.uint8 or maps.max() >= 13:
            fail(f"class maps {maps.shape} {maps.dtype} max {maps.max()}")

        def ingest_plain(rgb, ir, lo, hi, out_dtype=torch.bfloat16):
            return torch.cat([fp.rgb_plain(rgb[..., lo:hi, :]),
                              fp.ir_plain(ir[..., lo:hi, :])], -1).to(out_dtype)

        def conv_plain(x, w, scale, bias, groups, dilation=1, act="relu", slope=0.01):
            return gc.grouped_conv3x3_plain(x, w, groups, dilation, scale, bias,
                                            act, slope)

        for k in kernels:
            k.launches = 0
        with mock.patch.object(fp, "early_fusion_input", ingest_plain), \
                mock.patch.object(gc, "grouped_conv3x3_fused", conv_plain):
            plain = cli.main(argv)
        if any(k.launches for k in kernels):
            fail("the plain-version run launched a kernel")
        agree = float((plain.maps == maps).mean())
        print(f"  class-map agreement with the plain versions: {agree:.6f} "
              f"(need >= {MIN_AGREEMENT})", flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"class-map agreement {agree} < {MIN_AGREEMENT}")

        model = get_model("net_resnext50", classes=13, input_channels=4)
        init_params(model, torch.Generator().manual_seed(0))
        model = prepare_for_inference(model, dev)
        ds = PackedFrameDataset(pack)
        batch, _ = next(validate.batched((ds[i] for i in range(N_BATCH)), N_BATCH,
                                         ["rgb", "ir"]))
        with torch.no_grad():
            seg, taps, cert = model(*validate.ingest(batch, "ir_rgb", dev,
                                                     model.compute_dtype))
        want = [(N_BATCH, H_IN, W_IN, 13), (N_BATCH, 40, 88, 512), (N_BATCH, 40, 88, 1024),
                (N_BATCH, 40, 88, 512), (N_BATCH, 80, 176, 256), (N_BATCH, 80, 176, 64)]
        got = [tuple(t.shape) for t in taps]
        if seg.dtype != torch.float32 or got != want or cert is not None:
            fail(f"forward outputs {seg.dtype} {got}")
        if not all(bool(torch.isfinite(t).all()) for t in taps):
            fail("non-finite values in the forward's outputs")
        if not np.array_equal(seg.argmax(-1).to(torch.uint8).cpu().numpy(), maps[:N_BATCH]):
            fail("a direct forward disagrees with the CLI's class maps")
        print("  forward: float32 logits, 6 taps of the JAX shapes, all finite", flush=True)
    del model, seg, taps
    torch.cuda.empty_cache()

    # 4b. the training path through the CLI
    print(f"main path: cli.train_plain, ResNeXt-50 (3,4,6,3), batch {N_TRAIN}, "
          f"{CROP[0]}x{CROP[1]} crop, {TRAIN_STEPS} steps", flush=True)
    train_kernels = (gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_DX)
    with tempfile.TemporaryDirectory() as tmp:
        prng = np.random.RandomState(2)
        n_frames, h_full, w_full = 12, 320, 960
        # labels in bands a learner can fit; images random
        bands = (np.arange(h_full)[:, None] // 64 + np.arange(w_full)[None, :] // 192) % 13
        pack = os.path.join(tmp, "train")
        write_train_pack(
            pack, prng.randint(0, 256, (n_frames, h_full, w_full, 3)).astype(np.uint8),
            prng.randint(21000, 26000, (n_frames, h_full, w_full)).astype(np.uint16),
            np.broadcast_to(bands, (n_frames, h_full, w_full)).astype(np.uint8),
            prng.randint(0, 256, (n_frames, h_full, w_full, 3)).astype(np.uint8),
            prng.randint(21000, 26000, (n_frames, h_full, w_full)).astype(np.uint16))
        # one step per epoch (12 frames, batch 10), a checkpoint per epoch
        argv = ["--dataroot", pack, "--batch_size", str(N_TRAIN),
                "--n_epochs", str(TRAIN_STEPS), "--decay_epoch", "2",
                "--max_iters_per_epoch", "1",
                "--checkpointname", os.path.join(tmp, "ck"),
                "--log_dir", os.path.join(tmp, "runs")]
        for k in train_kernels:
            k.launches = 0
        gc.layout_copies.update(x=0, dy=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train_plain.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        train_launches = {k.name: k.launches for k in train_kernels}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        copies = dict(gc.layout_copies)
        step_ms = [s * 1e3 for s in run.step_seconds]
        print(f"  launches {train_launches} over {len(run.losses)} steps "
              f"({wall:.1f} s wall); layout copies {copies}", flush=True)
        print(f"  losses {[round(v, 6) for v in run.losses]}; step ms (host, "
              f"augmentation to loss) {[round(v, 2) for v in step_ms]}, p50 "
              f"{np.percentile(step_ms, 50):.2f} p95 {np.percentile(step_ms, 95):.2f}; "
              f"peak memory {peak_gb:.2f} GB", flush=True)
        if (len(run.losses) != TRAIN_STEPS
                or any(v != 16 * TRAIN_STEPS for v in train_launches.values())):
            fail(f"expected {TRAIN_STEPS} steps of 16 forward and 16 dx grouped-conv "
                 f"launches, got {len(run.losses)} steps, {train_launches}")
        if not all(np.isfinite(run.losses)):
            fail(f"non-finite training loss {run.losses}")
        saved = torch.load(run.checkpoint, map_location="cpu", weights_only=True)
        served = get_model("net_resnext50", classes=13, input_channels=4)
        served.load_state_dict(saved["state_dict"], strict=True)
        if saved["epoch"] != TRAIN_STEPS:
            fail(f"checkpoint epoch {saved['epoch']}")
        plain_ckpt = shutil.copy(run.checkpoint, os.path.join(work, "train_plain.pth"))

        ds = PackedFreiburgTrainDataset(pack)
        raw = next(batch_iterator(ds, N_TRAIN, seed=0))
        batch = DeviceAugment(CROP, dev)(torch.Generator().manual_seed(1), raw)

    # one step's loss and gradients, kernels against the plain versions
    model = init_model(ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=4), 0, dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def one_step_grads():
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        seg = model(batch["rgb_day"], batch["ir_day"])[0]
        loss = cross_entropy_ignore(seg, batch["label_day"], ignore_index=-1)
        loss.backward()
        return float(loss.detach()), {k: p.grad.float().clone()
                                      for k, p in model.named_parameters()
                                      if p.grad is not None}

    def fwd_plain(x, w, groups, dilation=1):
        return gc.grouped_conv3x3_plain(x, w, groups, dilation)

    def dx_plain(dy, w, groups, dilation=1):
        return gc.grouped_conv3x3_plain(dy, gc.dx_weight(w, groups), groups, dilation)

    def fwd_library(x, w, groups, dilation=1):
        return F.conv2d(x.permute(0, 3, 1, 2), w, padding=dilation,
                        dilation=dilation, groups=groups).permute(0, 2, 3, 1)

    def dx_library(dy, w, groups, dilation=1):
        n, h, w_, c = dy.shape
        return torch.nn.grad.conv2d_input(
            (n, c, h, w_), w, dy.permute(0, 3, 1, 2), padding=dilation,
            dilation=dilation, groups=groups).permute(0, 2, 3, 1)

    def group_of(name: str) -> str:
        head = name.removeprefix("trgb_segnet.").removeprefix("netSeg.").split(".")[0]
        if head.startswith("mod"):
            return head[:4]
        if head.startswith("netG_"):
            return "generators"
        return "critics" if head.startswith("critics_") else "head"

    def hold_step(what, losses, grads):
        """Fail unless the kernels' loss is within STEP_LOSS_TOL of the plain
        versions' and each gradient tensor within max(GRAD_TOL, 2x the
        library's distance from the plain versions).

        At random init, bf16 rounding taken in another order moves the deep
        stages' gradients far more than GRAD_TOL (f32 gradients move up to
        31 % under a 1e-4 input change, tools/grad_noise.py); another bf16
        implementation (the library's grouped conv) measures how far."""
        (loss_k, loss_p, loss_l), (grads_k, grads_p, grads_l) = losses, grads
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        rows = []
        for k, gp in grads_p.items():
            if float(gp.norm()) >= 1e-4:
                rows.append((k, float((grads_k[k] - gp).norm() / gp.norm()),
                             float((grads_l[k] - gp).norm() / gp.norm())))
        within = sum(rk < GRAD_TOL for _, rk, _ in rows)
        bad = [r for r in rows if r[1] > max(GRAD_TOL, 2.0 * r[2])]
        print(f"  {what}, kernels vs plain versions: loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(rel {loss_rel:.3g}, tolerance {STEP_LOSS_TOL}; library {loss_l:.6f}); "
              f"{len(rows)} gradient tensors of norm >= 1e-4, {within} within rel L2 "
              f"{GRAD_TOL}", flush=True)
        for group in ("mod1", "mod2", "mod3", "mod4", "mod5", "head", "critics",
                      "generators"):
            sel = [r for r in rows if group_of(r[0]) == group]
            if sel:
                print(f"    {group}: {len(sel)} tensors, rel L2 kernel-plain max "
                      f"{max(r[1] for r in sel):.3g}, library-plain max "
                      f"{max(r[2] for r in sel):.3g}, largest ratio "
                      f"{max(r[1] / max(r[2], 1e-12) for r in sel):.3g}", flush=True)
        if not loss_rel <= STEP_LOSS_TOL or bad or len(rows) < 50:
            fail(f"{what} with kernels disagrees with the plain versions: "
                 f"loss rel {loss_rel:.3g}, {bad[:5]}")

    loss_k, grads_k = one_step_grads()
    for k in train_kernels:
        k.launches = 0
    with mock.patch.object(gc, "grouped_conv3x3", fwd_plain), \
            mock.patch.object(gc, "grouped_conv3x3_dx", dx_plain):
        loss_p, grads_p = one_step_grads()
    with mock.patch.object(gc, "grouped_conv3x3", fwd_library), \
            mock.patch.object(gc, "grouped_conv3x3_dx", dx_library):
        loss_l, grads_l = one_step_grads()
    if any(k.launches for k in train_kernels):
        fail("the plain-version training step launched a kernel")
    hold_step("one step", (loss_k, loss_p, loss_l), (grads_k, grads_p, grads_l))
    del grads_k, grads_p, grads_l

    # 5 steps on one repeated batch: the loss must fall
    model.load_state_dict(start)
    opt_ns = train_plain.build_parser().parse_args(["--dataroot", "-"])
    state = train_plain.create_state(model, opt_ns, steps_per_epoch=1)
    rep_losses, rep_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        rep_losses.append(float(train_plain.train_step(state, batch)))
        rep_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  5 steps on one batch: losses {[round(v, 6) for v in rep_losses]}; "
          f"step ms (host, forward to loss, batch on the card) "
          f"{[round(v, 2) for v in rep_ms]}", flush=True)
    if not (all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0]):
        fail(f"the loss did not fall on a repeated batch: {rep_losses}")
    del model, state, start, batch
    torch.cuda.empty_cache()

    # 4c. the adversarial trainer through the CLI
    print(f"main path: cli.train_conf, ResNeXt-50 (3,4,6,3) + 6 cyclegan critics, "
          f"batch {N_ADV}, {CROP[0]}x{CROP[1]} crop, --moddrop --irscale, IR teacher, "
          f"--pretraining, {ADV_EPOCHS * (ADV_FRAMES[0] // N_ADV)} steps",
          flush=True)
    all_kernels = (fp.INGEST, gc.GROUPED_CONV3X3, gc.GROUPED_CONV3X3_FUSED,
                   gc.GROUPED_CONV3X3_DX)

    def counts():
        return {k.name: k.launches for k in all_kernels}

    prng = np.random.RandomState(3)
    (n_day, n_night), h_full, w_full = ADV_FRAMES, 320, 960
    bands = (np.arange(h_full)[:, None] // 64 + np.arange(w_full)[None, :] // 192) % 13
    adv_pack = os.path.join(work, "adv")
    # random frames: none is a frame of the test trees below
    write_train_pack(
        adv_pack, prng.randint(0, 256, (n_day, h_full, w_full, 3)).astype(np.uint8),
        prng.randint(21000, 26000, (n_day, h_full, w_full)).astype(np.uint16),
        np.broadcast_to(bands, (n_day, h_full, w_full)).astype(np.uint8),
        prng.randint(0, 256, (n_night, h_full, w_full, 3)).astype(np.uint8),
        prng.randint(21000, 26000, (n_night, h_full, w_full)).astype(np.uint16),
        test_stamps_filtered=True)
    t0 = time.perf_counter()
    periodic_day = write_fr_tree(os.path.join(work, "periodic_day"), N_PERIODIC, 1)
    periodic_night = write_fr_tree(os.path.join(work, "periodic_night"), N_PERIODIC, 2)
    print(f"  test trees for the periodic eval: 2 x {N_PERIODIC} frames written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    teacher_net = ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=1)
    init_params(teacher_net, torch.Generator().manual_seed(5))
    teacher_ckpt = save_checkpoint(
        {"epoch": 1, "state_dict": {"trgb_segnet." + k: v for k, v in
                                    teacher_net.state_dict().items()}},
        os.path.join(work, "teacher.pth"))
    del teacher_net

    # the launches of each step, read around it by wrapping the steps the CLI makes
    per_step = []
    make_steps = train_conf.make_adversarial_steps

    def counted_steps(*args):
        def wrap(step_fn, phase):
            def step(*a):
                before = counts()
                metrics = step_fn(*a)
                per_step.append((phase, {k: v - before[k] for k, v in counts().items()}))
                return metrics
            return step
        seg_fn, critic_fn = make_steps(*args)
        return wrap(seg_fn, "train_seg"), wrap(critic_fn, "train_critic")

    argv = ["--dataroot", adv_pack, "--batch_size", str(N_ADV), "--discarch", "cyclegan",
            "--num_critics", "6", "--moddrop", "--irscale",
            "--night_supervision_model", teacher_ckpt,
            "--pretraining", "--pretraining_path", plain_ckpt,
            "--iter_initial_critic_phase", "2", "--iter_critic_phase", "2",
            "--iter_seg_phase", "2", "--n_epochs", str(ADV_EPOCHS // 2),
            "--testroot_day", periodic_day, "--testroot_night", periodic_night,
            "--eval_everyn", "2", "--checkpointname", os.path.join(work, "conf"),
            "--log_dir", os.path.join(work, "runs_4c")]
    for k in all_kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(train_conf, "make_adversarial_steps", counted_steps):
        adv_run = train_conf.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    adv_launches = counts()
    adv_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_step = {"train_critic": {"ingest": 0, "grouped_conv3x3": 32,
                                  "grouped_conv3x3_fused": 0, "grouped_conv3x3_dx": 0},
                 "train_seg": {"ingest": 0, "grouped_conv3x3": 32,
                               "grouped_conv3x3_fused": 16, "grouped_conv3x3_dx": 32}}
    print(f"  launches {adv_launches} over {len(adv_run.phases)} steps "
          f"({adv_run.phases.count('train_critic')} critic, "
          f"{adv_run.phases.count('train_seg')} seg; {wall:.1f} s wall)", flush=True)
    for phase in ("train_critic", "train_seg"):
        seen = [c for p, c in per_step if p == phase]
        print(f"  per {phase} step: {seen[0] if seen else None} (want {want_step[phase]})",
              flush=True)
        if len(seen) < 2 or any(c != want_step[phase] for c in seen):
            fail(f"{phase}: expected >= 2 steps of {want_step[phase]} launches, got {seen}")
    if [p for p, _ in per_step] != adv_run.phases:
        fail("the counted steps are not the run's steps")
    step_stats = {}
    for phase in ("train_critic", "train_seg"):
        losses = adv_run.losses[phase]
        ms = [t * 1e3 for t, p in zip(adv_run.step_seconds, adv_run.phases) if p == phase]
        step_stats[phase] = (float(np.percentile(ms, 50)), float(np.percentile(ms, 95)))
        print(f"  {phase}: losses {[round(v, 6) for v in losses]}; step ms (host, "
              f"augmentation to loss) {[round(v, 2) for v in ms]}, p50 "
              f"{step_stats[phase][0]:.2f} p95 {step_stats[phase][1]:.2f}", flush=True)
        if not all(np.isfinite(losses)):
            fail(f"non-finite {phase} loss {losses}")
    print(f"  peak memory {adv_peak_gb:.2f} GB", flush=True)
    # the periodic eval: epochs 0 and 2 of 4, each night then day through the
    # validators (one padded batch of 16 per 8-frame tree), outside the steps
    step_sum = {k: sum(c[k] for _, c in per_step) for k in adv_launches}
    periodic_launches = {k: adv_launches[k] - step_sum[k] for k in adv_launches}
    logged = [json.loads(line) for name in os.listdir(os.path.join(work, "runs_4c"))
              for line in open(os.path.join(work, "runs_4c", name))]
    combined = [r["combined_Test mean IoU"] for r in logged if "combined_Test mean IoU" in r]
    best = os.path.join(work, "conf_best.pth")
    want_periodic = {"ingest": 4, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 64,
                     "grouped_conv3x3_dx": 0}
    print(f"  periodic eval: combined_Test mean IoU {combined} (run.evals {adv_run.evals}); "
          f"launches outside the steps {periodic_launches} (want {want_periodic}); "
          f"_best checkpoint {'written' if os.path.exists(best) else 'MISSING'}", flush=True)
    # best_iou starts at 0, so a first eval of mean IoU 0 is no new best
    if (len(combined) != 2 or combined != adv_run.evals
            or os.path.exists(best) != (max(combined) > 0)
            or periodic_launches != want_periodic):
        fail("phase 4c's periodic eval did not run as expected")
    saved = torch.load(adv_run.checkpoint, map_location="cpu", weights_only=True)
    conf_net = ConfSegnet(disc_arch="cyclegan", num_critics=6)
    conf_net.load_state_dict(saved["state_dict"], strict=True)
    # written after the last eval, at the end of epoch 2 of 0-3
    if saved["epoch"] != ADV_EPOCHS - 1 or saved["best_iou"] != max(combined):
        fail(f"checkpoint epoch {saved['epoch']}, best_iou {saved['best_iou']}")
    del conf_net, saved

    # one seg step's loss and gradients and one critic step's loss, kernels
    # against the plain versions, from the same weights and inputs
    cfg = adv.AdversarialConfig(moddrop=True, irscale=True, night_supervision=True)
    raw = next(batch_iterator(PackedFreiburgTrainDataset(adv_pack), N_ADV, seed=0))
    batch = DeviceAugment(CROP, dev)(torch.Generator().manual_seed(1), raw)
    draws = adv.draw_seg_aug(torch.Generator().manual_seed(2))
    draws.moddrop = draws.irscale = True  # both augmentations in the checked step

    def fused_library(x, w, scale, bias, groups, dilation=1, act="relu", slope=0.01):
        y = fwd_library(x, w, groups, dilation).float() * scale + bias
        return gc.apply_act(y, act, slope).to(x.dtype)

    def hold_adv_steps(what, model, teacher):
        """One seg step's loss and gradients and one critic step's loss with
        the kernels against the plain versions (and the library's grouped
        conv), from the same weights, batch and draws."""
        seg_loss_fn, critic_loss_fn = adv.make_adversarial_losses(model, cfg, teacher)
        start = {k: v.clone() for k, v in model.state_dict().items()}

        def adv_seg_grads():
            model.load_state_dict(start)
            loss, _ = seg_loss_fn(batch, draws)
            loss.backward()
            return float(loss.detach()), {k: p.grad.float().clone()
                                          for k, p in model.named_parameters()
                                          if p.grad is not None}

        def adv_critic_loss():
            model.load_state_dict(start)
            with torch.no_grad():
                return float(critic_loss_fn(batch)[0])

        loss_k, grads_k = adv_seg_grads()
        closs_k = adv_critic_loss()
        for k in all_kernels:
            k.launches = 0
        with mock.patch.object(gc, "grouped_conv3x3", fwd_plain), \
                mock.patch.object(gc, "grouped_conv3x3_dx", dx_plain), \
                mock.patch.object(gc, "grouped_conv3x3_fused", conv_plain):
            loss_p, grads_p = adv_seg_grads()
            closs_p = adv_critic_loss()
        with mock.patch.object(gc, "grouped_conv3x3", fwd_library), \
                mock.patch.object(gc, "grouped_conv3x3_dx", dx_library), \
                mock.patch.object(gc, "grouped_conv3x3_fused", fused_library):
            loss_l, grads_l = adv_seg_grads()
        if any(counts().values()):
            fail(f"the plain-version {what} steps launched a kernel")
        hold_step(f"one {what} seg step", (loss_k, loss_p, loss_l),
                  (grads_k, grads_p, grads_l))
        closs_rel = abs(closs_k - closs_p) / abs(closs_p)
        print(f"  one {what} critic step, kernels vs plain versions: loss {closs_k:.6f} "
              f"vs {closs_p:.6f} (rel {closs_rel:.3g}, tolerance {STEP_LOSS_TOL})",
              flush=True)
        if not closs_rel <= STEP_LOSS_TOL:
            fail(f"the {what} critic step's loss with kernels disagrees with the "
                 "plain versions")
        model.load_state_dict(start)

    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6), 0, dev)
    teacher = train_conf.load_teacher(teacher_ckpt, "ir", False, dev)
    hold_adv_steps("adversarial", model, teacher)

    def check_isolation(model, cfg, teacher, batch, draws):
        """Phase isolation on the card: each step leaves the frozen side
        untouched and moves the trained side."""
        state = adv.make_phase_optimizers(model, lambda count: 1e-4)
        seg_step, critic_step = adv.make_adversarial_steps(model, cfg, teacher)

        def snapshot(prefix):
            return {k: p.detach().clone() for k, p in model.named_parameters()
                    if k.startswith(prefix)}

        for phase, frozen, trained in (("train_critic", "trgb_segnet.", "critics_"),
                                       ("train_seg", "critics_", "trgb_segnet.")):
            before, moved = snapshot(frozen), snapshot(trained)
            if phase == "train_seg":
                seg_step(state, batch, draws)
            else:
                critic_step(state, batch)
            torch.cuda.synchronize()
            kept = all(torch.equal(v, p) for v, p in zip(before.values(),
                                                         snapshot(frozen).values()))
            changed = sum(not torch.equal(v, p) for v, p in zip(moved.values(),
                                                               snapshot(trained).values()))
            print(f"  phase isolation, {phase} step: {len(before)} {frozen}* parameters "
                  f"{'unchanged' if kept else 'CHANGED'}; {changed} of {len(moved)} "
                  f"{trained}* parameters moved", flush=True)
            if not kept or not changed:
                fail(f"phase isolation broken in the {phase} step")

    check_isolation(model, cfg, teacher, batch, draws)
    del model, teacher
    torch.cuda.empty_cache()

    # 5. the slice's later paths: late fusion and PSPNet, served and trained,
    # and the deeper ResNeXt. Each is driven with the counts set to 0 just
    # before it and read just after.
    serve_pack = os.path.join(work, "serve")
    prng = np.random.RandomState(4)
    write_pack(serve_pack, prng.randint(0, 256, (16, H_IN, W_IN, 3)).astype(np.uint8),
               prng.randint(21000, 26000, (16, H_IN, W_IN, 1)).astype(np.uint16))
    serve_frames = [PackedFrameDataset(serve_pack)[i] for i in range(16)]
    n_serve = -(-len(serve_frames) // N_BATCH)

    def ingest_pair_plain(rgb, ir, lo=148, hi=852, out_dtype=torch.bfloat16):
        return (fp.rgb_plain(rgb[..., lo:hi, :]).to(out_dtype),
                fp.ir_plain(ir[..., lo:hi, :]).to(out_dtype))

    def serve_path(what, model, modalities, per_forward, plain_patches):
        """Serve the 16 frames at batch 8 through ``validate.inference`` with
        the counts read around it; again through the plain versions for the
        class-map agreement; then p50/p95 of ``validate.predict`` on one
        batch (host clock: H2D, ingest, forward, argmax)."""
        t0 = time.perf_counter()
        for k in all_kernels:
            k.launches = 0
        maps = validate.inference(model, iter(serve_frames), N_BATCH, dev, modalities)
        torch.cuda.synchronize()
        got = counts()
        want = {k: v * n_serve for k, v in per_forward.items()}
        print(f"  launches {got} over {n_serve} forwards (want {want})", flush=True)
        if got != want:
            fail(f"{what}: expected {want} launches, got {got}")
        if maps.shape != (16, H_IN, W_IN) or maps.dtype != np.uint8 or maps.max() >= 13:
            fail(f"{what}: class maps {maps.shape} {maps.dtype} max {maps.max()}")
        with contextlib.ExitStack() as stack:
            for obj, name, fn in plain_patches:
                stack.enter_context(mock.patch.object(obj, name, fn))
            plain_maps = validate.inference(model, iter(serve_frames), N_BATCH, dev,
                                            modalities)
        if any(counts()[k] != want[k] for k in want):
            fail(f"{what}: the plain-version run launched a kernel")
        agree = float((plain_maps == maps).mean())
        keys = validate.modality_keys(modalities)
        batch, _ = next(validate.batched(iter(serve_frames), N_BATCH, keys))
        times = []
        for _ in range(13):
            t1 = time.perf_counter()
            validate.predict(model, batch, modalities, dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        p50, p95 = (float(np.percentile(times[3:], q)) for q in (50, 95))
        print(f"  class-map agreement with the plain versions: {agree:.6f} (need >= "
              f"{MIN_AGREEMENT}); batch-{N_BATCH} forward (host clock, H2D to argmax) "
              f"p50 {p50:.2f} p95 {p95:.2f} ms; {time.perf_counter() - t0:.1f} s",
              flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"{what}: class-map agreement {agree} < {MIN_AGREEMENT}")
        return {"launches": got, "agreement": agree, "forward_ms_p50_p95": (p50, p95)}

    # 5a. late-fusion ResNeXt-50 serving: RGB and IR from one ingest launch,
    # 19 fused grouped convs (mod2_1 and mod2_2 3 each, 4, 6, 3)
    print(f"main path: eval.validate.inference, late-fusion ResNeXt-50 (3,4,6,3), "
          f"batch {N_BATCH}, {H_IN}x{W_IN}", flush=True)
    lf_net = get_model("net_resnext50", classes=13, input_channels=4, late_fusion=True)
    init_params(lf_net, torch.Generator().manual_seed(0))
    lf_net = prepare_for_inference(lf_net, dev)
    later = {"late_fusion_serving": serve_path(
        "late-fusion serving", lf_net, "ir_rgb",
        {"ingest": 1, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 19,
         "grouped_conv3x3_dx": 0},
        [(fp, "inference_preprocess_fused", ingest_pair_plain),
         (gc, "grouped_conv3x3_fused", conv_plain)])}
    rgb_n, ir_n = validate.ingest(serve_frames[0], "ir_rgb", dev, lf_net.compute_dtype,
                                  late_fusion=True)
    with torch.no_grad():
        seg, taps, _ = lf_net(rgb_n, ir_n)
    got = [t.shape[-1] for t in taps]
    if got != [13, 768, 1024, 512, 512, 128] or not all(
            bool(torch.isfinite(t).all()) for t in taps):
        fail(f"late-fusion forward: taps {got}, or non-finite values")
    del lf_net, seg, taps, rgb_n, ir_n
    torch.cuda.empty_cache()

    # 5b. PSPNet-ResNet-50 serving, RGB only (tools/bench_pspnet.py:52-64):
    # one ingest launch per forward, no grouped conv
    print(f"main path: eval.validate.inference, PSPNet-ResNet-50, RGB only, batch "
          f"{N_BATCH}, {H_IN}x{W_IN}", flush=True)
    psp_net = get_model("pspnet", backend="resnet50", in_channels=3)
    init_params(psp_net, torch.Generator().manual_seed(0))
    psp_net = prepare_for_inference(psp_net, dev)
    later["pspnet_serving"] = serve_path(
        "PSPNet serving", psp_net, "rgb",
        {"ingest": 1, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 0,
         "grouped_conv3x3_dx": 0},
        [(fp, "rgb_normalize_fused", lambda x, d: fp.rgb_plain(x).to(d))])
    (x,) = validate.ingest(serve_frames[0], "rgb", dev, psp_net.compute_dtype)
    with torch.no_grad():
        seg, taps, _ = psp_net(x)
    got = [tuple(t.shape) for t in taps]
    if got != [(1, H_IN, W_IN, 13), (1, 40, 88, 2048), (1, 40, 88, 1024),
               (1, 40, 88, 512), (1, 80, 176, 256), (1, 80, 176, 64)] or \
            seg.dtype != torch.float32 or not bool(torch.isfinite(seg).all()):
        fail(f"PSPNet forward: {seg.dtype} taps {got}, or non-finite logits")
    del psp_net, seg, taps, x
    torch.cuda.empty_cache()

    def train_conf_path(what, flags, teacher_path, want):
        """``cli.train_conf`` for 4 critic and 4 seg steps at the adversarial
        operating point, the launches of each step read around it."""
        per_step.clear()
        argv = ["--dataroot", adv_pack, "--batch_size", str(N_ADV), "--discarch",
                "cyclegan", "--num_critics", "6", "--moddrop", "--irscale",
                "--night_supervision_model", teacher_path, *flags,
                "--iter_initial_critic_phase", "2", "--iter_critic_phase", "2",
                "--iter_seg_phase", "2", "--n_epochs", str(ADV_EPOCHS // 2),
                "--checkpointname", os.path.join(work, f"conf_{len(later)}"),
                "--log_dir", os.path.join(work, "runs")]
        for k in all_kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(train_conf, "make_adversarial_steps", counted_steps):
            run = train_conf.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, peak = counts(), torch.cuda.max_memory_allocated() / 1e9
        print(f"  launches {got} over {len(run.phases)} steps ({wall:.1f} s wall)",
              flush=True)
        out = {"launches": got, "peak_memory_gb": peak}
        for phase in ("train_critic", "train_seg"):
            seen = [c for p, c in per_step if p == phase]
            print(f"  per {phase} step: {seen[0] if seen else None} (want "
                  f"{want[phase]})", flush=True)
            if len(seen) < 2 or any(c != want[phase] for c in seen):
                fail(f"{what} {phase}: expected >= 2 steps of {want[phase]} launches, "
                     f"got {seen}")
            losses = run.losses[phase]
            ms = [t * 1e3 for t, p in zip(run.step_seconds, run.phases) if p == phase]
            out[phase + "_ms_p50_p95"] = (float(np.percentile(ms, 50)),
                                          float(np.percentile(ms, 95)))
            print(f"  {phase}: losses {[round(v, 6) for v in losses]}; step ms (host, "
                  f"augmentation to loss) {[round(v, 2) for v in ms]}, p50 "
                  f"{out[phase + '_ms_p50_p95'][0]:.2f} p95 "
                  f"{out[phase + '_ms_p50_p95'][1]:.2f}", flush=True)
            if not all(np.isfinite(losses)):
                fail(f"{what}: non-finite {phase} loss {losses}")
        print(f"  peak memory {peak:.2f} GB", flush=True)
        return out

    # 5c. train_conf --late_fusion: 38 grouped convs per train-mode forward
    # pair (mod2_2 adds 3 to each of day and night)
    print(f"main path: cli.train_conf --late_fusion, ResNeXt-50 + 6 cyclegan critics, "
          f"batch {N_ADV}, {CROP[0]}x{CROP[1]} crop, --moddrop --irscale, IR teacher, "
          f"{ADV_EPOCHS * 2} steps", flush=True)
    later["train_conf_late_fusion"] = train_conf_path(
        "train_conf --late_fusion", ["--late_fusion"], teacher_ckpt,
        {"train_critic": {"ingest": 0, "grouped_conv3x3": 38, "grouped_conv3x3_fused": 0,
                          "grouped_conv3x3_dx": 0},
         "train_seg": {"ingest": 0, "grouped_conv3x3": 38, "grouped_conv3x3_fused": 16,
                       "grouped_conv3x3_dx": 38}})
    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6, late_fusion=True),
                       0, dev)
    teacher = train_conf.load_teacher(teacher_ckpt, "ir", False, dev)
    hold_adv_steps("late-fusion", model, teacher)
    del model, teacher
    torch.cuda.empty_cache()

    # 5d. train_conf --arch pspnet with an IR-only PSPNet teacher: no port
    # kernel on this path (dense convs only); dropout live in both phases
    print(f"main path: cli.train_conf --arch pspnet, PSPNet-ResNet-50 + 6 cyclegan "
          f"critics, batch {N_ADV}, {CROP[0]}x{CROP[1]} crop, --moddrop --irscale, "
          f"IR PSPNet teacher, {ADV_EPOCHS * 2} steps", flush=True)
    psp_teacher = get_model("pspnet", backend="resnet50", in_channels=1)
    init_params(psp_teacher, torch.Generator().manual_seed(0))
    psp_teacher_ckpt = save_checkpoint(
        {"epoch": 1, "state_dict": {"trgb_segnet." + k: v for k, v in
                                    psp_teacher.state_dict().items()}},
        os.path.join(work, "psp_teacher.pth"))
    del psp_teacher
    none = {k.name: 0 for k in all_kernels}
    later["train_conf_pspnet"] = train_conf_path(
        "train_conf --arch pspnet", ["--arch", "pspnet"], psp_teacher_ckpt,
        {"train_critic": none, "train_seg": none})
    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6, arch="pspnet"),
                       0, dev)
    teacher = train_conf.load_teacher(psp_teacher_ckpt, "ir", False, dev, "pspnet")
    seg_loss_fn, _ = adv.make_adversarial_losses(model, cfg, teacher)
    drop_losses = []
    for seed in (10, 10, 11):
        draws.dropout = model.draw_dropout(N_ADV, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            drop_losses.append(float(seg_loss_fn(batch, draws)[0]))
    print(f"  seg-step loss from one state under dropout masks of generator seeds "
          f"10, 10, 11: {drop_losses}", flush=True)
    if not all(np.isfinite(drop_losses)) or drop_losses[2] == drop_losses[0]:
        fail(f"PSPNet dropout is not live in the seg step: {drop_losses}")
    draws.dropout = None
    del model, teacher, seg_loss_fn
    torch.cuda.empty_cache()

    # 5e. cli.inference --arch resnext101: 33 fused grouped convs per forward
    print(f"main path: cli.inference --arch resnext101 (3,4,23,3), batch {N_BATCH}",
          flush=True)
    for k in all_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    r101 = cli.main(["--data", serve_pack, "--batch", str(N_BATCH), "--iters", "1",
                     "--arch", "resnext101"])
    torch.cuda.synchronize()
    forwards = 1 + 1 + n_serve  # warm-up, one timing iteration, the batches
    got = counts()
    want = {"ingest": forwards, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 33 * forwards,
            "grouped_conv3x3_dx": 0}
    print(f"  launches {got} over {forwards} forwards (want {want}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if got != want or r101.maps.shape != (16, H_IN, W_IN) or r101.maps.max() >= 13:
        fail(f"cli.inference --arch resnext101: launches {got}, maps {r101.maps.shape}")
    later["resnext101_serving"] = {"launches": got}
    torch.cuda.empty_cache()

    # 5f. evaluation: the validators through cli.train_conf --eval / --infer on
    # trees written here with the port's PNG writer, phase 4c's weights
    print(f"main path: evaluation, cli.train_conf --eval FR_day / FR_night / MF_day and "
          f"--infer, ResNeXt-50 (3,4,6,3) early fusion, phase 4c's checkpoint, batch "
          f"{EVAL_BATCH}", flush=True)
    t_5f = time.perf_counter()
    from heatnet_tpu_torch.data import loaders
    from heatnet_tpu_torch.data.png import read_png
    from heatnet_tpu_torch.utils.vis import color_code_labels

    t0 = time.perf_counter()
    fr_day = write_fr_tree(os.path.join(work, "fr_day"), N_EVAL_DAY, 3)
    fr_night = write_fr_tree(os.path.join(work, "fr_night"), N_EVAL_NIGHT, 4)
    mf_root = write_mfnet_tree(os.path.join(work, "mfnet"), N_EVAL_MF, 5)
    capture = capture_tree_from(fr_day, os.path.join(work, "capture"))
    print(f"  trees written in {time.perf_counter() - t0:.1f} s: Freiburg day "
          f"{N_EVAL_DAY} and night {N_EVAL_NIGHT} frames (320x960), MFNet "
          f"{N_EVAL_MF} (480x640), a capture tree of the day frames", flush=True)
    # the kernels at the shapes evaluation gives them, against their plain
    # versions: ingest at batch 16 of 320x960 frames (the 148:852 window), the
    # fused grouped conv at batch 16 on the 320x704 and the 480x640 stages
    rgb, ir = frames(EVAL_BATCH, H_IN, 960)
    ingest_err = max(ingest_err, check(
        f"early_fusion_input ({EVAL_BATCH},{H_IN},960)[148:852] bf16",
        fp.early_fusion_input(rgb, ir, 148, 852, torch.bfloat16),
        torch.cat([fp.rgb_plain(rgb[..., 148:852, :]), fp.ir_plain(ir[..., 148:852, :])],
                  -1).to(torch.bfloat16), *tol[torch.bfloat16]))
    del rgb, ir
    for geo, (h2, w2) in (("320x704", (80, 176)), ("480x640", (120, 160))):
        for name, c, cpg, d, _, _, _ in STAGES:
            h, w = (h2, w2) if name == "mod2" else (h2 // 2, w2 // 2)
            g = torch.Generator(device="cpu").manual_seed(c + h)
            x = torch.randn((EVAL_BATCH, h, w, c), generator=g).to(dev, torch.bfloat16)
            wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
                  ).to(dev, torch.bfloat16)
            scale = (torch.rand(c, generator=g) + 0.5).to(dev)
            bias = (torch.randn(c, generator=g) * 0.1).to(dev)
            gc_err = max(gc_err, check(
                f"grouped_conv3x3_fused {name} {geo} ({EVAL_BATCH},{h},{w},{c})",
                gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d),
                gc.grouped_conv3x3_plain(x, wt, c // cpg, d, scale, bias, "relu"), *gc_tol))
    del x, wt, scale, bias
    torch.cuda.empty_cache()
    eval_argv =["--resume", adv_run.checkpoint, "--discarch", "cyclegan",
                 "--num_critics", "6", "--log_dir", os.path.join(work, "runs_5f")]
    recorded = {}

    def recording(fn, what):
        """``fn`` with its frames counted and its wall time (decode ahead on
        threads, H2D, ingest, forward, counts) taken on the host clock."""
        def run(model, frames, *a, **kw):
            seen = []

            def counted():
                for f in frames:
                    seen.append(1)
                    yield f
            t1 = time.perf_counter()
            ious = fn(model, counted(), *a, **kw)
            torch.cuda.synchronize()
            recorded[what] = (ious, len(seen), time.perf_counter() - t1)
            return ious
        return run

    eval_results = {}
    for what, flags, fn_name, n_frames, per_batch in (
            ("FR_day", ["--testroot_day", fr_day], "validate_model", N_EVAL_DAY,
             {"ingest": 1, "grouped_conv3x3_fused": 16}),
            ("FR_night", ["--testroot_night", fr_night], "validate_model", N_EVAL_NIGHT,
             {"ingest": 1, "grouped_conv3x3_fused": 16}),
            ("MF_day", ["--testroot_mfnet", mf_root], "validate_model_mfnet", N_EVAL_MF,
             {"ingest": 0, "grouped_conv3x3_fused": 16})):
        batches = -(-n_frames // EVAL_BATCH)
        want = {k.name: per_batch.get(k.name, 0) * batches for k in all_kernels}
        for k in all_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(train_conf, fn_name,
                               recording(getattr(train_conf, fn_name), what)):
            miou = train_conf.main(["--eval", what, *flags, *eval_argv])
        wall = time.perf_counter() - t0
        got = counts()
        ious, n_seen, secs = recorded[what]
        print(f"  --eval {what}: IoUs {np.round(ious, 6).tolist()} mean {miou:.6f}; "
              f"launches {got} over {batches} batches (want {want}); {n_seen} frames in "
              f"{secs:.3f} s, {n_seen / secs:.1f} frames/s (host clock, decode ahead + "
              f"H2D + forward + counts; CLI call {wall:.1f} s)", flush=True)
        ok = (ious.shape == (12,) and np.all((ious >= 0) | np.isnan(ious))
              and np.all((ious <= 1) | np.isnan(ious)) and np.isfinite(miou)
              and abs(miou - float(np.nanmean(ious))) < 1e-12)
        if got != want or n_seen != n_frames or not ok:
            fail(f"--eval {what}: launches {got}, {n_seen} frames, IoUs {ious}")
        eval_results[what] = {"launches": got, "ious": ious.tolist(), "mean_iou": miou,
                              "frames": n_seen, "seconds": secs,
                              "frames_per_s": n_seen / secs}

    # the same evaluations through the plain versions, from the same weights;
    # the decode time per frame (one thread) and the card time per batch
    conf_net = ConfSegnet(disc_arch="cyclegan", num_critics=6)
    conf_net.load_state_dict(torch.load(adv_run.checkpoint, map_location="cpu",
                                        weights_only=True)["state_dict"], strict=True)
    seg_net = train_conf.eval_copy(conf_net.trgb_segnet, dev)
    del conf_net
    for what, ds, modalities, validator, patches in (
            ("FR_day", loaders.FreiburgThermalTestDataset(*loaders.get_test_paths([fr_day])),
             "ir_rgb", validate.validate_model,
             [(fp, "early_fusion_input", ingest_plain), (gc, "grouped_conv3x3_fused", conv_plain)]),
            ("MF_day", loaders.MFNetDataset(mf_root, "day"), "ir_rgb",
             validate.validate_model_mfnet, [(gc, "grouped_conv3x3_fused", conv_plain)])):
        t0 = time.perf_counter()
        frames_ = [ds[i] for i in range(len(ds))]
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
        maps_k = validate.inference(seg_net, frames_, EVAL_BATCH, dev, modalities)
        ious_k = validator(seg_net, frames_, modalities, device=dev)
        with contextlib.ExitStack() as stack:
            for obj, name, fn in patches:
                stack.enter_context(mock.patch.object(obj, name, fn))
            maps_p = validate.inference(seg_net, frames_, EVAL_BATCH, dev, modalities)
            ious_p = validator(seg_net, frames_, modalities, device=dev)
        agree = float((maps_k == maps_p).mean())
        batch, _ = next(validate.batched(iter(frames_), EVAL_BATCH,
                                         validate.modality_keys(modalities)))
        card_ms = time_ms(lambda: validate.predict(seg_net, batch, modalities, dev), reps=5)
        print(f"  {what}, kernels vs plain versions: class-map agreement {agree:.6f} "
              f"(need >= {MIN_AGREEMENT}); IoUs kernels {np.round(ious_k, 6).tolist()}, "
              f"plain {np.round(ious_p, 6).tolist()}; CLI pass equal to this pass: "
              f"{np.allclose(ious_k, eval_results[what]['ious'], equal_nan=True)}",
              flush=True)
        print(f"  {what}: decode {decode_ms:.2f} ms per frame (one thread: PNG decode, "
              f"resize, crop); batch of {EVAL_BATCH} {card_ms:.2f} ms on the card clock "
              f"(H2D, ingest, forward, argmax; CUDA events)", flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"{what}: class-map agreement {agree} < {MIN_AGREEMENT}")
        eval_results[what].update(agreement_with_plain=agree, plain_ious=ious_p.tolist(),
                                  decode_ms_per_frame=decode_ms, batch_card_ms=card_ms)

    # --infer with --im_save_dir: the dumps against the palette-coded maps
    dumps = os.path.join(work, "dumps")
    n_cap = len(os.listdir(os.path.join(capture, "fl_rgb")))
    batches = -(-n_cap // EVAL_BATCH)
    for k in all_kernels:
        k.launches = 0
    train_conf.main(["--infer", capture, "--im_save_dir", dumps, *eval_argv])
    got = counts()
    want = {"ingest": batches, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16 * batches,
            "grouped_conv3x3_dx": 0}
    infer_ds = loaders.FreiburgInferDataset(capture)
    maps = validate.inference(seg_net, [infer_ds[i] for i in range(n_cap)], EVAL_BATCH, dev)
    same = np.mean([(read_png(os.path.join(dumps, f"pred_{i}.png"))
                     == (np.clip(color_code_labels(maps[i]), 0, 1) * 255).astype(np.uint8)
                     ).all(-1).mean() for i in range(n_cap)])
    print(f"  --infer: launches {got} (want {want}); {n_cap} pred_*.png decoded, "
          f"{same:.6f} of pixels equal to the palette-coded class maps", flush=True)
    if got != want or same < MIN_AGREEMENT:
        fail(f"--infer: launches {got}, dump agreement {same}")
    eval_results["infer"] = {"launches": got, "dump_agreement": float(same)}
    del seg_net

    # cli.inference on the capture tree, batch 8, decode ahead on threads
    for k in all_kernels:
        k.launches = 0
    served = cli.main(["--data", capture, "--batch", str(N_BATCH), "--iters", "1"])
    torch.cuda.synchronize()
    forwards = 1 + 1 + -(-n_cap // N_BATCH)  # warm-up, one timing iteration, batches
    got = counts()
    want = {"ingest": forwards, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16 * forwards,
            "grouped_conv3x3_dx": 0}
    print(f"  cli.inference --data <capture tree> --batch {N_BATCH}: launches {got} (want "
          f"{want}); {served.frames_per_second:.1f} frames/s end to end; phase "
          f"{time.perf_counter() - t_5f:.1f} s", flush=True)
    if got != want or served.maps.shape != (n_cap, H_IN, W_IN):
        fail(f"cli.inference on a capture tree: launches {got}, maps {served.maps.shape}")
    eval_results["cli_inference_png"] = {"launches": got,
                                         "frames_per_s": served.frames_per_second}
    later.update({f"eval_{k}": v for k, v in eval_results.items()})
    torch.cuda.empty_cache()

    # 6. the IR-only trainers (config #5 and the uncertainty pretrainer), each
    # path driven with the counts set to 0 just before it and read just after
    from heatnet_tpu_torch.cli import test_cyclegan, train_cyclegan, train_uncertainty
    from heatnet_tpu_torch.data.loaders import KAISTCycleGANDataset
    from heatnet_tpu_torch.data.synthetic import make_kaist
    from heatnet_tpu_torch.train import cyclegan as cg

    t_6 = time.perf_counter()
    print("kernels: grouped_conv3x3 forward, fused and dx at the IR-only trainers' "
          "stage shapes", flush=True)
    for n, c, cpg, d, h, w in GAN_STAGES:
        g = torch.Generator(device="cpu").manual_seed(c + h + n)
        x = torch.randn((n, h, w, c), generator=g).to(dev, torch.bfloat16)
        wt = (torch.randn((c, cpg, 3, 3), generator=g) / (9 * cpg) ** 0.5
              ).to(dev, torch.bfloat16)
        scale = (torch.rand(c, generator=g) + 0.5).to(dev)
        bias = (torch.randn(c, generator=g) * 0.1).to(dev)
        where = f"(N {n}, C {c}, cpg {cpg}, d {d}, {h}x{w})"
        gc_err = max(gc_err, check(f"grouped_conv3x3 {where}",
                                   gc.grouped_conv3x3(x, wt, c // cpg, d),
                                   gc.grouped_conv3x3_plain(x, wt, c // cpg, d), *gc_tol))
        gc_err = max(gc_err, check(
            f"grouped_conv3x3_fused {where}",
            gc.grouped_conv3x3_fused(x, wt, scale, bias, c // cpg, d),
            gc.grouped_conv3x3_plain(x, wt, c // cpg, d, scale, bias, "relu"), *gc_tol))
        dx_err = max(dx_err, check(
            f"grouped_conv3x3_dx {where}", gc.grouped_conv3x3_dx(x, wt, c // cpg, d),
            gc.grouped_conv3x3_plain(x, gc.dx_weight(wt, c // cpg), c // cpg, d), *gc_tol))

    # 6a. cli.train_cyclegan at its defaults on a KAIST-layout tree at KAIST's
    # 640x512 (PNG bytes): 9 residual blocks, netSeg (3,4,6,3) with 12 classes
    print(f"main path: cli.train_cyclegan, 2 x 9-block generators + 2 discriminators + "
          f"netSeg ResNeXt-50 (3,4,6,3), 12 classes, batch {N_GAN}, 256x256, "
          f"{GAN_EPOCHS} epochs of {GAN_ITERS} steps", flush=True)
    t0 = time.perf_counter()
    kaist = make_kaist(os.path.join(work, "kaist"), n_day=8, n_night=8, hw=(512, 640),
                       seed=6)
    print(f"  KAIST tree (8 day + 8 night 640x512 frames, labels 0-11) written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gan_steps = []  # (kind, launches, host ms, losses)
    make_gan_steps = train_cyclegan.make_cyclegan_steps

    def counted_gan_steps(*nets):
        def wrap(step_fn, kind):
            def step(*a):
                before = counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = step_fn(*a)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                loss = float(out[2]["loss_G"]) if kind == "generator" else float(out)
                gan_steps.append((kind, {k: v - before[k] for k, v in counts().items()},
                                  ms, loss))
                return out
            return step
        g_fn, da_fn, db_fn = make_gan_steps(*nets)
        return (wrap(g_fn, "generator"), wrap(da_fn, "discriminator"),
                wrap(db_fn, "discriminator"))

    gan_ckpt = os.path.join(work, "cyclegan_ckpts")
    for k in all_kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(train_cyclegan, "make_cyclegan_steps", counted_gan_steps):
        last_g = train_cyclegan.main([
            "--dataroot", kaist, "--batchSize", str(N_GAN), "--n_epochs", str(GAN_EPOCHS),
            "--decay_epoch", "1", "--max_iters_per_epoch", str(GAN_ITERS),
            "--checkpoint_dir", gan_ckpt, "--log_dir", os.path.join(work, "runs_6a")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, gan_peak = counts(), torch.cuda.max_memory_allocated() / 1e9
    want = {"generator": {"ingest": 0, "grouped_conv3x3": 32, "grouped_conv3x3_fused": 0,
                          "grouped_conv3x3_dx": 32},
            "discriminator": {k.name: 0 for k in all_kernels}}
    print(f"  launches {got} over {len(gan_steps)} steps ({wall:.1f} s wall); last "
          f"loss_G {last_g:.6f}", flush=True)
    gan_out = {"launches": got, "peak_memory_gb": gan_peak}
    for kind, n_want in (("generator", GAN_EPOCHS * GAN_ITERS),
                         ("discriminator", 2 * GAN_EPOCHS * GAN_ITERS)):
        seen = [r for r in gan_steps if r[0] == kind]
        print(f"  per {kind} step: {seen[0][1] if seen else None} (want {want[kind]})",
              flush=True)
        if len(seen) != n_want or any(r[1] != want[kind] for r in seen):
            fail(f"train_cyclegan: expected {n_want} {kind} steps of {want[kind]} "
                 f"launches, got {[r[1] for r in seen]}")
        ms, losses = [r[2] for r in seen], [r[3] for r in seen]
        gan_out[kind + "_step_ms_p50_p95"] = (float(np.percentile(ms, 50)),
                                              float(np.percentile(ms, 95)))
        print(f"  {kind}: losses {[round(v, 6) for v in losses]}; step ms (host, "
              f"synchronised) {[round(v, 2) for v in ms]}, p50 "
              f"{gan_out[kind + '_step_ms_p50_p95'][0]:.2f} p95 "
              f"{gan_out[kind + '_step_ms_p50_p95'][1]:.2f}", flush=True)
        if not all(np.isfinite(losses)):
            fail(f"train_cyclegan: non-finite {kind} loss {losses}")
    print(f"  peak memory {gan_peak:.2f} GB", flush=True)
    opt_ns = train_cyclegan.build_parser().parse_args([])
    for name in cg.NET_NAMES:
        path = os.path.join(gan_ckpt, name + ".pth")
        if not os.path.exists(path):
            fail(f"train_cyclegan wrote no {path}")
    saved_seg = torch.load(os.path.join(gan_ckpt, "netSeg.pth"), map_location="cpu",
                           weights_only=True)
    ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=1, classes=12).load_state_dict(
        saved_seg, strict=True)
    print(f"  checkpoints: {', '.join(n + '.pth' for n in cg.NET_NAMES)}; netSeg's "
          f"loads strictly ({len(saved_seg)} entries)", flush=True)

    # one generator step's loss and gradients, kernels against the plain versions
    gan_nets = train_cyclegan.build_nets(opt_ns, dev)
    gan_start = {n: {k: v.clone() for k, v in net.state_dict().items()}
                 for n, net in gan_nets.items()}
    gan_state = cg.CycleGANState.create(gan_nets, lambda count: opt_ns.lr)
    g_fn = cg.make_cyclegan_steps(*(gan_nets[k] for k in (
        "netG_A2B", "netG_B2A", "netD_A", "netD_B", "netSeg")))[0]
    captured = {}

    def capture_grads():  # the generator optimizer's step, replaced by a read
        captured.update({k: p.grad.float().clone()
                         for k, p in gan_state.g.model.named_parameters()
                         if p.grad is not None})
        gan_state.g.optimizer.zero_grad(set_to_none=True)

    gan_state.g.apply_gradients = capture_grads
    items = [KAISTCycleGANDataset(kaist)[i] for i in range(N_GAN)]
    gan_batch = train_cyclegan.device_batch(
        {k: np.stack([it[k] for it in items]) for k in items[0]}, dev)

    def gan_grads():
        for n, net in gan_nets.items():
            net.load_state_dict(gan_start[n])
        captured.clear()
        metrics = g_fn(gan_state, gan_batch)[2]
        return float(metrics["loss_G"]), dict(captured)

    loss_k, grads_k = gan_grads()
    for k in all_kernels:
        k.launches = 0
    with mock.patch.object(gc, "grouped_conv3x3", fwd_plain), \
            mock.patch.object(gc, "grouped_conv3x3_dx", dx_plain):
        loss_p, grads_p = gan_grads()
    with mock.patch.object(gc, "grouped_conv3x3", fwd_library), \
            mock.patch.object(gc, "grouped_conv3x3_dx", dx_library):
        loss_l, grads_l = gan_grads()
    if any(counts().values()):
        fail("the plain-version generator step launched a kernel")
    hold_step("one CycleGAN generator step", (loss_k, loss_p, loss_l),
              (grads_k, grads_p, grads_l))
    gan_out["generator_step_check"] = {"loss_kernels": loss_k, "loss_plain": loss_p}
    later["train_cyclegan"] = gan_out
    del gan_nets, gan_state, gan_start, grads_k, grads_p, grads_l, captured
    torch.cuda.empty_cache()

    # 6b. cli.test_cyclegan --run_seg on 6a's checkpoints: 16 fused launches per
    # frame (netSeg in eval mode on real_B), class maps against the plain versions
    print("main path: cli.test_cyclegan --run_seg --limit 4, 6a's checkpoints, batch 1",
          flush=True)
    gan_test_out = os.path.join(work, "cyclegan_out")
    test_argv = ["--dataroot", kaist, "--checkpoint_dir", gan_ckpt, "--run_seg",
                 "--limit", str(N_GAN_TEST)]
    for k in all_kernels:
        k.launches = 0
    t0 = time.perf_counter()
    n_frames = test_cyclegan.main(test_argv + ["--output_dir", gan_test_out])
    torch.cuda.synchronize()
    got = counts()
    want = {"ingest": 0, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16 * N_GAN_TEST,
            "grouped_conv3x3_dx": 0}
    print(f"  launches {got} over {n_frames} frames (want {want}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if n_frames != N_GAN_TEST or got != want:
        fail(f"cli.test_cyclegan: {n_frames} frames, launches {got}")
    translations = sorted(os.listdir(os.path.join(gan_test_out, "A"))) + sorted(
        os.listdir(os.path.join(gan_test_out, "B")))
    segs = [read_png(os.path.join(gan_test_out, f"seg_{i:04d}.png")) for i in range(n_frames)]
    trans = [read_png(os.path.join(gan_test_out, sub, f"{i:04d}.png"))
             for sub in ("A", "B") for i in range(n_frames)]
    if len(translations) != 2 * N_GAN_TEST or any(
            t.shape != (256, 256, 3) for t in trans + segs):
        fail(f"cli.test_cyclegan wrote {translations} and seg maps "
             f"{[s.shape for s in segs]}")
    with mock.patch.object(gc, "grouped_conv3x3_fused", conv_plain):
        test_cyclegan.main(test_argv + ["--output_dir", gan_test_out + "_plain"])
    if counts() != want:
        fail("the plain-version cli.test_cyclegan launched a kernel")
    plain_segs = [read_png(os.path.join(gan_test_out + "_plain", f"seg_{i:04d}.png"))
                  for i in range(n_frames)]
    agree = float(np.mean([(a == b).all(-1).mean() for a, b in zip(segs, plain_segs)]))
    print(f"  {len(trans)} translations and {len(segs)} seg maps decode (256x256 RGB); "
          f"class-map agreement with the plain versions {agree:.6f} (need >= "
          f"{MIN_AGREEMENT})", flush=True)
    if agree < MIN_AGREEMENT:
        fail(f"cli.test_cyclegan: class-map agreement {agree} < {MIN_AGREEMENT}")
    later["test_cyclegan"] = {"launches": got, "agreement": agree}
    torch.cuda.empty_cache()

    # 6c. cli.train_uncertainty at its defaults: two (2,2,2,2) encoders on IR
    # subsampled to 80x160, batch 4, on a train pack
    print(f"main path: cli.train_uncertainty, encoders (2,2,2,2) x 2 + seg and "
          f"uncertainty decoders, batch {N_UNC}, 80x160, {UNC_STEPS} steps", flush=True)
    prng = np.random.RandomState(8)
    unc_pack = os.path.join(work, "unc_pack")
    n_frames = 2 * N_UNC  # 2 steps per epoch, 2 epochs
    write_train_pack(
        unc_pack, prng.randint(0, 256, (n_frames, 320, 960, 3)).astype(np.uint8),
        prng.randint(21000, 26000, (n_frames, 320, 960)).astype(np.uint16),
        np.broadcast_to(bands % 12, (n_frames, 320, 960)).astype(np.uint8),
        prng.randint(0, 256, (2, 320, 960, 3)).astype(np.uint8),
        prng.randint(21000, 26000, (2, 320, 960)).astype(np.uint16))
    unc_per_step = []
    make_unc_step = train_uncertainty.make_uncertainty_step

    def counted_unc_step(*mods):
        step_fn = make_unc_step(*mods)

        def step(*a):
            before = counts()
            out = step_fn(*a)
            unc_per_step.append({k: v - before[k] for k, v in counts().items()})
            return out
        return step

    for k in all_kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(train_uncertainty, "make_uncertainty_step", counted_unc_step):
        unc_run = train_uncertainty.main([
            "--dataroot", unc_pack, "--batch_size", str(N_UNC), "--n_epochs", "2",
            "--checkpointname", os.path.join(work, "ir_uncertainty"),
            "--log_dir", os.path.join(work, "runs_6c")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, unc_peak = counts(), torch.cuda.max_memory_allocated() / 1e9
    want = {"ingest": 0, "grouped_conv3x3": 16, "grouped_conv3x3_fused": 0,
            "grouped_conv3x3_dx": 16}
    ms = [t * 1e3 for t in unc_run.step_seconds]
    unc_p = (float(np.percentile(ms, 50)), float(np.percentile(ms, 95)))
    print(f"  launches {got} over {len(unc_run.losses)} steps ({wall:.1f} s wall); per "
          f"step {unc_per_step[0] if unc_per_step else None} (want {want})", flush=True)
    print(f"  losses (seg + uncertainty) {[round(v, 6) for v in unc_run.losses]}; step ms "
          f"(host, augmentation to loss) {[round(v, 2) for v in ms]}, p50 {unc_p[0]:.2f} "
          f"p95 {unc_p[1]:.2f}; peak memory {unc_peak:.2f} GB", flush=True)
    if len(unc_per_step) != UNC_STEPS or any(c != want for c in unc_per_step):
        fail(f"train_uncertainty: expected {UNC_STEPS} steps of {want} launches, got "
             f"{unc_per_step}")
    if not all(np.isfinite(unc_run.losses)):
        fail(f"train_uncertainty: non-finite loss {unc_run.losses}")
    saved = torch.load(unc_run.checkpoint, map_location="cpu", weights_only=True)
    torch.nn.ModuleDict(train_uncertainty.build_modules(
        (2, 2, 2, 2), torch.device("cpu"))).load_state_dict(saved["state_dict"], strict=True)
    print(f"  checkpoint {os.path.basename(unc_run.checkpoint)}: epoch {saved['epoch']}, "
          f"{len(saved['state_dict'])} entries, loads strictly", flush=True)
    if saved["epoch"] != 2:
        fail(f"train_uncertainty checkpoint epoch {saved['epoch']}")
    later["train_uncertainty"] = {"launches": got, "step_ms_p50_p95": unc_p,
                                  "peak_memory_gb": unc_peak}
    print(f"  phases 6a-6c: {time.perf_counter() - t_6:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # 7. Vistas pretraining through cli.main and MFNet adversarial training
    # through cli.train_conf --trainsetname MF, each path driven with the
    # counts set to 0 just before it and read just after
    from heatnet_tpu_torch.cli import main as vistas_cli
    from heatnet_tpu_torch.data.loaders import MFNetTrainDataset, VistasDataset, to_device
    from heatnet_tpu_torch.models.layers import BatchNorm
    from heatnet_tpu_torch.utils.config import load_config

    t_7 = time.perf_counter()
    t0 = time.perf_counter()
    vis_val = write_vistas_tree(os.path.join(work, "vistas_val"), N_VIS_VAL, 9)
    n_unique = N_VIS * VIS_EPOCHS // 3
    vis_train = write_vistas_tree(os.path.join(work, "vistas_train"), n_unique, 10, copies=3)
    print(f"  Vistas trees written in {time.perf_counter() - t0:.1f} s: {N_VIS_VAL} "
          f"validation frames, {3 * n_unique} train frames ({n_unique} x 3 names), "
          "1024x768", flush=True)
    vis_steps, vis_evals = [], []  # (launches, card ms) of each step; launches per eval batch
    make_vis_step, make_vis_eval = vistas_cli.make_train_step, vistas_cli.make_eval_step

    def counted_vis_step(*a, **kw):
        step_fn = make_vis_step(*a, **kw)

        def step(*args):
            before = counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(*args)
            end.record()
            torch.cuda.synchronize()
            vis_steps.append(({k: v - before[k] for k, v in counts().items()},
                              start.elapsed_time(end)))
            return out
        return step

    def counted_vis_eval(*a, **kw):
        eval_fn = make_vis_eval(*a, **kw)

        def step(*args):
            before = counts()
            out = eval_fn(*args)
            vis_evals.append({k: v - before[k] for k, v in counts().items()})
            return out
        return step

    def run_vistas(argv):
        vis_steps.clear()
        vis_evals.clear()
        for k in all_kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(vistas_cli, "make_train_step", counted_vis_step), \
                mock.patch.object(vistas_cli, "make_eval_step", counted_vis_eval):
            out = vistas_cli.main(argv + ["-j", "8", "--log-dir", os.path.join(work, "runs_7")])
        torch.cuda.synchronize()
        return out, counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9

    # 7a. cli.main at experiments/heatnet_conf.json's full width
    print(f"main path: cli.main (Vistas pretraining), ResNeXt-50 (3,4,6,3) RGB, 3x3 stem, "
          f"leaky ReLU, batch {N_VIS} of {VIS_HW[0]}x{VIS_HW[1]}, {VIS_EPOCHS} epochs of "
          f"2 steps, validation of {N_VIS_VAL} frames", flush=True)
    vis_ck = os.path.join(work, "vistas_ck")
    vis_run, vis_launches, wall, vis_peak = run_vistas(
        ["--data", vis_train, "--valdata", vis_val, "--batch-size", str(N_VIS),
         "--epochs", str(VIS_EPOCHS), "--checkpoint-dir", vis_ck, "--print-freq", "1"])
    eval_batches = -(-N_VIS_VAL // EVAL_BATCH)
    want_vis_step = {"ingest": 0, "grouped_conv3x3": 16, "grouped_conv3x3_fused": 0,
                     "grouped_conv3x3_dx": 16}
    want_eval = {"ingest": 0, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16,
                 "grouped_conv3x3_dx": 0}
    step_card = [ms for _, ms in vis_steps]
    vis_p = (float(np.percentile(step_card, 50)), float(np.percentile(step_card, 95)))
    host_ms = [t * 1e3 for t in vis_run.step_seconds]
    data_ms = [t * 1e3 for t in vis_run.data_seconds]
    print(f"  launches {vis_launches} over {len(vis_steps)} steps and {len(vis_evals)} eval "
          f"batches ({wall:.1f} s wall); per step {vis_steps[0][0] if vis_steps else None} "
          f"(want {want_vis_step}); per eval batch {vis_evals[0] if vis_evals else None} "
          f"(want {want_eval})", flush=True)
    print(f"  losses {[round(v, 6) for v in vis_run.losses]}; mIoU per epoch "
          f"{[round(v, 6) for v in vis_run.mious]}; step ms (CUDA events, forward to Adam) "
          f"{[round(v, 2) for v in step_card]}, p50 {vis_p[0]:.2f} p95 {vis_p[1]:.2f}; "
          f"step ms (host clock, H2D to loss) {[round(v, 2) for v in host_ms]}; wait for "
          f"the batch ms (host decode and augmentation, 8 threads, prefetch 2) "
          f"{[round(v, 2) for v in data_ms]}; peak memory {vis_peak:.2f} GB", flush=True)
    if (len(vis_steps) != 2 * VIS_EPOCHS or any(c != want_vis_step for c, _ in vis_steps)
            or len(vis_evals) != VIS_EPOCHS * eval_batches
            or any(c != want_eval for c in vis_evals)):
        fail(f"cli.main: expected {2 * VIS_EPOCHS} steps of {want_vis_step} and "
             f"{VIS_EPOCHS * eval_batches} eval batches of {want_eval} launches, got "
             f"{[c for c, _ in vis_steps]} and {vis_evals}")
    if not all(np.isfinite(vis_run.losses)) or len(vis_run.mious) != VIS_EPOCHS:
        fail(f"cli.main: losses {vis_run.losses}, mIoUs {vis_run.mious}")
    saved = torch.load(vis_run.checkpoint, map_location="cpu", weights_only=True)
    if saved["epoch"] != 1 or saved["best_iou"] != vis_run.mious[0]:
        fail(f"cli.main: checkpoint epoch {saved['epoch']}, best_iou {saved['best_iou']}")
    # the host's share: one batch's decode and augmentation on 8 threads, and
    # one thread's ms per frame, apart from the card
    ds = VistasDataset(vis_train, width=VIS_HW[1], height=VIS_HW[0])
    t0 = time.perf_counter()
    vis_raw = next(batch_iterator(ds, N_VIS, seed=0, workers=8))
    host_batch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(4):
        ds[i]
    host_frame_ms = (time.perf_counter() - t0) * 1e3 / 4
    print(f"  host: {host_batch_ms:.1f} ms per batch of {N_VIS} on 8 threads (PNG decode, "
          f"scale jitter, pad, crop, flip, colour jitter, rotation, normalisation), "
          f"{host_frame_ms:.1f} ms per frame on one thread; card {vis_p[0]:.2f} ms per step "
          f"-> {N_VIS / max(host_batch_ms, vis_p[0]) * 1e3:.1f} frames/s when both overlap",
          flush=True)
    later["vistas_train"] = {
        "launches": vis_launches, "step_ms_p50_p95_cuda_events": vis_p,
        "step_ms_host": host_ms, "batch_wait_ms": data_ms, "peak_memory_gb": vis_peak,
        "host_ms_per_batch_8_threads": host_batch_ms, "host_ms_per_frame_1_thread": host_frame_ms,
        "mious": vis_run.mious, "losses": vis_run.losses}

    # 7b. --resume <7a's checkpoint> --evaluate: the mIoU of 7a's epoch-0 validation
    print("main path: cli.main --resume <7a> --evaluate", flush=True)
    miou, eval_launches, wall, _ = run_vistas(
        ["--data", vis_train, "--valdata", vis_val, "--resume", vis_run.checkpoint,
         "--evaluate"])
    print(f"  mIoU {miou:.9f} vs 7a's {vis_run.mious[0]:.9f} (tolerance 1e-6); launches "
          f"{eval_launches} over {len(vis_evals)} eval batches ({wall:.1f} s)", flush=True)
    if abs(miou - vis_run.mious[0]) > 1e-6 or any(c != want_eval for c in vis_evals):
        fail(f"cli.main --evaluate: mIoU {miou} vs {vis_run.mious[0]}, launches {vis_evals}")
    later["vistas_evaluate"] = {"launches": eval_launches, "miou": miou}

    # 7c. one Vistas step with --bn-groups 3, kernels against the plain versions
    conf = load_config(vistas_cli.DEFAULT_CONFIG)
    vis_args = vistas_cli.build_parser().parse_args(
        ["--data", "-", "--valdata", "-", "--bn-groups", "3"])
    model = init_model(vistas_cli.build_model(vis_args, conf), 0, dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    vb = {"image": to_device(vis_raw["image"], dev),
          "label": to_device(vis_raw["label"], dev).long()}
    bn = next(m for m in model.modules() if isinstance(m, BatchNorm) and m.groups == 3)
    seen = []
    hook = bn.register_forward_hook(lambda m, inp, out: seen.append(inp[0].detach()))

    def vis_grads():
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        seen.clear()
        loss = cross_entropy_ignore(model(vb["image"])[0], vb["label"])
        loss.backward()
        return float(loss.detach()), {k: p.grad.float().clone()
                                      for k, p in model.named_parameters()
                                      if p.grad is not None}

    loss_k, grads_k = vis_grads()
    x0 = seen[0][:N_VIS // 3].float()
    m = bn.flax_momentum
    hook.remove()
    bn_name = next(k for k, mod in model.named_modules() if mod is bn)
    mean0 = m * start[bn_name + ".running_mean"] + (1 - m) * x0.mean((0, 2, 3))
    stat_rel = float((bn.running_mean - mean0).norm() / mean0.norm())
    for k in all_kernels:
        k.launches = 0
    with mock.patch.object(gc, "grouped_conv3x3", fwd_plain), \
            mock.patch.object(gc, "grouped_conv3x3_dx", dx_plain):
        loss_p, grads_p = vis_grads()
    with mock.patch.object(gc, "grouped_conv3x3", fwd_library), \
            mock.patch.object(gc, "grouped_conv3x3_dx", dx_library):
        loss_l, grads_l = vis_grads()
    if any(counts().values()):
        fail("the plain-version Vistas step launched a kernel")
    hold_step(f"one Vistas step (--bn-groups 3, batch {N_VIS})", (loss_k, loss_p, loss_l),
              (grads_k, grads_p, grads_l))
    print(f"  {bn_name}'s running mean after the step vs group 0's batch mean: rel L2 "
          f"{stat_rel:.3g} (tolerance 1e-3)", flush=True)
    if not stat_rel <= 1e-3:
        fail(f"--bn-groups 3: the running mean is not group 0's (rel {stat_rel})")
    later["vistas_step_check"] = {"launches": {k.name: 0 for k in all_kernels},
                                  "loss_kernels": loss_k, "loss_plain": loss_p,
                                  "running_mean_rel": stat_rel}
    del model, start, grads_k, grads_p, grads_l, vb, seen
    torch.cuda.empty_cache()

    # 7d. cli.main --arch pspnet: PSPNet-ResNet-50 with dropout, no port kernel
    print(f"main path: cli.main --arch pspnet, batch {N_VIS} of {VIS_HW[0]}x{VIS_HW[1]}, "
          "2 steps", flush=True)
    psp_run, psp_launches, wall, psp_peak = run_vistas(
        ["--data", vis_train, "--valdata", vis_val, "--arch", "pspnet", "--batch-size",
         str(N_VIS), "--epochs", "1", "--max-steps-per-epoch", "2", "--checkpoint-dir",
         os.path.join(work, "vistas_psp_ck")])
    psp_card = [ms for _, ms in vis_steps]
    print(f"  launches {psp_launches} ({wall:.1f} s wall); losses "
          f"{[round(v, 6) for v in psp_run.losses]}; step ms (CUDA events) "
          f"{[round(v, 2) for v in psp_card]}; peak memory {psp_peak:.2f} GB", flush=True)
    if (any(psp_launches.values()) or len(psp_run.losses) != 2
            or not all(np.isfinite(psp_run.losses))):
        fail(f"cli.main --arch pspnet: launches {psp_launches}, losses {psp_run.losses}")
    later["vistas_pspnet"] = {"launches": psp_launches, "step_ms_cuda_events": psp_card,
                              "peak_memory_gb": psp_peak}
    torch.cuda.empty_cache()

    # 7e. cli.train_conf --trainsetname MF --bn_groups 2: an MFNet tree at
    # 480x640, 2 critic and 2 seg steps at batch 16 of 384x384, the IR teacher
    print(f"main path: cli.train_conf --trainsetname MF --bn_groups 2, ResNeXt-50 + 6 "
          f"cyclegan critics, batch {N_MF} of {MF_CROP[0]}x{MF_CROP[1]}, --irscale, IR "
          "teacher, 4 steps", flush=True)
    mf_train = write_mfnet_tree(os.path.join(work, "mfnet_train"), 2 * N_MF, 11, train=True)
    per_step.clear()
    for k in all_kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(train_conf, "make_adversarial_steps", counted_steps):
        mf_run = train_conf.main([
            "--trainsetname", "MF", "--dataroot", mf_train, "--bn_groups", "2",
            "--batch_size", str(N_MF), "--discarch", "cyclegan", "--num_critics", "6",
            "--irscale", "--night_supervision_model", teacher_ckpt,
            "--iter_initial_critic_phase", "2", "--iter_critic_phase", "2",
            "--iter_seg_phase", "2", "--n_epochs", "2",
            "--checkpointname", os.path.join(work, "conf_mf"),
            "--log_dir", os.path.join(work, "runs_7e")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mf_launches, mf_peak = counts(), torch.cuda.max_memory_allocated() / 1e9
    print(f"  launches {mf_launches} over {len(mf_run.phases)} steps ({wall:.1f} s wall); "
          f"peak memory {mf_peak:.2f} GB", flush=True)
    mf_out = {"launches": mf_launches, "peak_memory_gb": mf_peak}
    for phase in ("train_critic", "train_seg"):
        seen_c = [c for p, c in per_step if p == phase]
        ms = [t * 1e3 for t, p in zip(mf_run.step_seconds, mf_run.phases) if p == phase]
        print(f"  per {phase} step: {seen_c} (want {want_step[phase]}); losses "
              f"{[round(v, 6) for v in mf_run.losses[phase]]}; step ms (host, augmentation "
              f"to loss) {[round(v, 2) for v in ms]}", flush=True)
        if (len(seen_c) != 2 or any(c != want_step[phase] for c in seen_c)
                or not all(np.isfinite(mf_run.losses[phase]))):
            fail(f"train_conf --trainsetname MF {phase}: launches {seen_c}, losses "
                 f"{mf_run.losses[phase]}")
        mf_out[phase + "_ms_host"] = ms
    raw = next(batch_iterator(MFNetTrainDataset(mf_train), N_MF, seed=0))
    mf_batch = DeviceAugment(MF_CROP, dev, mfnet=True)(torch.Generator().manual_seed(1), raw)
    mf_cfg = adv.AdversarialConfig(irscale=True, night_supervision=True)
    mf_draws = adv.draw_seg_aug(torch.Generator().manual_seed(2))
    mf_draws.irscale = True
    model = init_model(ConfSegnet(disc_arch="cyclegan", num_critics=6, bn_groups=2), 0, dev)
    teacher = train_conf.load_teacher(teacher_ckpt, "ir", False, dev)
    check_isolation(model, mf_cfg, teacher, mf_batch, mf_draws)
    later["train_conf_mf"] = mf_out
    del model, teacher, mf_batch
    torch.cuda.empty_cache()
    print(f"  phases 7a-7e: {time.perf_counter() - t_7:.1f} s", flush=True)

    # 8. the MFNet harness (MFNet, RTFNet, SegNet through cli.train_baseline,
    # cli.run_demo) and the harness tools (cli.eval_hotnet, cli.dataset_qa),
    # each path driven with the counts set to 0 just before it and read just after
    import copy

    from heatnet_tpu_torch.cli import dataset_qa, eval_hotnet, run_demo, train_baseline
    from heatnet_tpu_torch.data.synthetic import make_mfnet

    t_8 = time.perf_counter()
    zero = {k.name: 0 for k in all_kernels}
    # 8a. each baseline's eval forward on the card against the same weights'
    # forward on the CPU, float32 with TF32 off, one 192x256 frame. SegNet's
    # unpooling is discontinuous: where two values of a pool cell lie within
    # rounding, another summation order may record the other's position and
    # the unpool moves that value by a pixel (one such switch moves 0.07 % of
    # the logits by up to 12 % of max |logit|). So the card's SegNet records
    # its own argmaxes, each that differs from the CPU's must be a near-tie
    # (within 1e-5 of its cell's maximum, relative), and then pools and
    # unpools at the CPU's, which the logits are held to
    from heatnet_tpu_torch.models import segnet_baseline

    real_pool = segnet_baseline.pool_with_indices
    x = torch.from_numpy(np.random.RandomState(12).rand(1, *HARNESS_CHECK_HW, 4)
                         .astype(np.float32))
    harness_check = {}
    for name in HARNESS_MODELS:
        model = train_baseline.build_model(name)
        init_params(model, torch.Generator().manual_seed(0))
        cpu_model = prepare_for_inference(copy.deepcopy(model), torch.device("cpu"),
                                          dtype=torch.float32)
        card_model = prepare_for_inference(model, dev, dtype=torch.float32)
        cpu_idx, switched = [], []

        def recording_pool(t):
            pooled, idx = real_pool(t)
            cpu_idx.append(idx)
            return pooled, idx

        def cpu_index_pool(t):
            cells = segnet_baseline.pool_cells(t)
            own, ref = cells.argmax(-1), cpu_idx[len(switched)].to(t.device)
            top = cells.amax(-1)
            gap = (top - torch.gather(cells, -1, ref[..., None])[..., 0]).abs()
            differ = own != ref
            switched.append((int(differ.sum()), bool(
                (gap[differ] <= 1e-5 * top[differ].abs()).all())))
            return torch.gather(cells, -1, ref[..., None])[..., 0], ref

        with torch.no_grad():
            with mock.patch.object(segnet_baseline, "pool_with_indices", recording_pool):
                want = cpu_model(x)
            with mock.patch.object(segnet_baseline, "pool_with_indices", cpu_index_pool):
                got = card_model(x.to(dev)).cpu()
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / scale
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        flips = [n for n, _ in switched]
        ties = all(ok for _, ok in switched)
        print(f"  8a. {name} eval forward, card vs CPU, float32, 1x{HARNESS_CHECK_HW[0]}x"
              f"{HARNESS_CHECK_HW[1]}: class maps agree on {agree:.6f} (need >= "
              f"{HARNESS_AGREE}); max |diff| / max |logit| {rel:.3g} (need <= "
              f"{HARNESS_REL_TOL}; max |logit| {scale:.4g})"
              + (f"; pool argmaxes the card chose otherwise, per level {flips}, all at "
                 f"near-ties: {ties}" if switched else ""), flush=True)
        if (tuple(got.shape) != (1, *HARNESS_CHECK_HW, 9) or not bool(torch.isfinite(got).all())
                or agree < HARNESS_AGREE or rel > HARNESS_REL_TOL or not ties):
            fail(f"{name}: card forward {tuple(got.shape)} against the CPU's: agreement "
                 f"{agree}, relative error {rel}, argmax switches {switched}")
        harness_check[name] = {"agreement": agree, "max_rel_err": rel,
                               "pool_argmax_switches": flips}
        del model, cpu_model, card_model
    torch.cuda.empty_cache()

    # 8b. cli.train_baseline at its defaults (batch 8 of 480x640, lr 0.01) for
    # 2 epochs on a tree of 24 train frames and 5 day + 5 night test frames
    t0 = time.perf_counter()
    harness_root = make_mfnet(os.path.join(work, "harness"), n_train=N_HARNESS_TRAIN,
                              n_test=N_HARNESS_TEST, hw=(480, 640), seed=13)
    print(f"main path: cli.train_baseline, batch {N_HARNESS} of 480x640, {HARNESS_EPOCHS} "
          f"epochs of {N_HARNESS_TRAIN // N_HARNESS} steps, float32; tree of "
          f"{N_HARNESS_TRAIN} train and {N_HARNESS_TEST} + {N_HARNESS_TEST} test frames "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    harness_steps = []  # (launches, card ms) of each step
    make_harness_step = train_baseline.make_train_step

    def counted_harness_step(*a, **kw):
        step_fn = make_harness_step(*a, **kw)

        def step(*args):
            before = counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(*args)
            end.record()
            torch.cuda.synchronize()
            harness_steps.append(({k: v - before[k] for k, v in counts().items()},
                                  start.elapsed_time(end)))
            return out
        return step

    harness_runs = {}
    for name in HARNESS_MODELS:
        harness_steps.clear()
        for k in all_kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with mock.patch.object(train_baseline, "make_train_step", counted_harness_step):
            run = train_baseline.main([
                "--model_name", name, "--data_dir", harness_root, "--epoch_max",
                str(HARNESS_EPOCHS), "--checkpointname", os.path.join(work, f"{name}_ck"),
                "--log_dir", os.path.join(work, "runs_8")])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, peak = counts(), torch.cuda.max_memory_allocated() / 1e9
        card = [ms for _, ms in harness_steps]
        host = [s * 1e3 for s in run.step_seconds]
        eval_fps = sum(run.eval_frames.values()) / sum(run.eval_seconds.values())
        print(f"  8b. {name}: launches {got} (want none); steps {len(run.losses)}, losses "
              f"{[round(v, 6) for v in run.losses]}; step ms (CUDA events, H2D to SGD) "
              f"p50 {np.percentile(card, 50):.2f} p95 {np.percentile(card, 95):.2f}, each "
              f"{[round(v, 2) for v in card]}; host clock p50 {np.percentile(host, 50):.2f}; "
              f"peak memory {peak:.2f} GB; eval {eval_fps:.1f} frames/s (decode ahead, H2D, "
              f"forward, confusion matrix); day acc {run.overall_acc['day']:.4f} mIoU "
              f"{run.miou['day']:.4f}, night acc {run.overall_acc['night']:.4f} mIoU "
              f"{run.miou['night']:.4f}; {wall:.1f} s wall", flush=True)
        if (got != zero or any(c != zero for c, _ in harness_steps)
                or len(run.losses) != HARNESS_EPOCHS * (N_HARNESS_TRAIN // N_HARNESS)
                or not all(np.isfinite(run.losses))
                or any(int(cf.sum()) != N_HARNESS_TEST * 480 * 640
                       for cf in run.confusion.values())):
            fail(f"cli.train_baseline {name}: launches {got}, losses {run.losses}, "
                 f"matrices {[int(cf.sum()) for cf in run.confusion.values()]}")
        harness_runs[name] = run
        later[f"train_baseline_{name}"] = {
            "launches": got, "losses": run.losses, "step_ms_cuda_events": card,
            "step_ms_p50_p95": (float(np.percentile(card, 50)), float(np.percentile(card, 95))),
            "step_ms_host": host, "peak_memory_gb": peak, "eval_frames_per_s": eval_fps,
            "overall_acc": run.overall_acc, "miou": run.miou,
            "card_vs_cpu": harness_check[name]}
        torch.cuda.empty_cache()

    # 8c. --test --resume <8b's RTFNet checkpoint>: combined (test.txt, the day
    # then the night names) equals 8b's day + night matrices exactly
    rtf = harness_runs["RTFNet"]
    for k in all_kernels:
        k.launches = 0
    test_run = train_baseline.main(["--model_name", "RTFNet", "--data_dir", harness_root,
                                    "--test", "--resume", rtf.checkpoint,
                                    "--log_dir", os.path.join(work, "runs_8")])
    got = counts()
    same = np.array_equal(test_run.confusion["combined"],
                          rtf.confusion["day"] + rtf.confusion["night"])
    print(f"  8c. --test --resume (RTFNet): launches {got}; combined matrix equal to "
          f"8b's day + night: {same}", flush=True)
    if not same or got != zero:
        fail(f"--test combined matrix differs from day + night (launches {got})")
    later["train_baseline_test"] = {"launches": got, "combined_equals_day_plus_night": same}

    # 8d. cli.run_demo on 4 frames with that checkpoint: the _pred.png files
    # against the palette-coded class maps of a float32 eval forward
    demo_dir = os.path.join(work, "demo", "image")
    weights = os.path.join(work, "demo", "weights")
    os.makedirs(demo_dir)
    os.makedirs(os.path.join(weights, "RTFNet"))
    shutil.copy(rtf.checkpoint, os.path.join(weights, "RTFNet", "final"))
    names = sorted(open(os.path.join(harness_root, "test.txt")).read().split())[:N_DEMO]
    for n in names:
        shutil.copy(os.path.join(harness_root, "images", n + ".png"),
                    os.path.join(demo_dir, n + ".png"))
    for k in all_kernels:
        k.launches = 0
    outs = run_demo.main(["--model_name", "RTFNet", "--image_dir", demo_dir,
                          "--model_dir", weights])
    got = counts()
    model = train_baseline.build_model("RTFNet")
    model.load_state_dict(torch.load(rtf.checkpoint, map_location="cpu",
                                     weights_only=True)["state_dict"])
    model = prepare_for_inference(model, dev, dtype=torch.float32)
    images = np.stack([read_png(os.path.join(demo_dir, n + ".png")) for n in names])
    with torch.no_grad():
        maps = model(torch.from_numpy(images.astype(np.float32) / 255.0).to(dev)
                     ).argmax(-1).cpu().numpy()
    palette = np.asarray(run_demo.MFNET_PALETTE, np.uint8)
    same = [bool(np.array_equal(read_png(p), palette[m])) for p, m in zip(outs, maps)]
    print(f"  8d. cli.run_demo (RTFNet, {len(outs)} frames): launches {got}; each "
          f"_pred.png equal to the palette-coded class maps: {same}", flush=True)
    if len(outs) != N_DEMO or not all(same) or got != zero:
        fail(f"cli.run_demo: {len(outs)} files, equal {same}, launches {got}")
    later["run_demo"] = {"launches": got, "equal": same}
    del model
    torch.cuda.empty_cache()

    # 8e. the harness tools on phase 4c's checkpoint and phase 5f's trees: the
    # IoUs of 5f's validators, bit for bit; 1 ingest + 16 fused launches per
    # Freiburg batch of 16, 0 + 16 per MFNet batch
    run_dir = os.path.join(work, "hotnet_run")
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump({"modalities": "ir_rgb", "arch": "custom", "structure": [3, 4, 6, 3],
                   "cert_branch": False, "late_fusion": False}, f)
    shutil.copy(adv_run.checkpoint, os.path.join(run_dir, "checkpoint_best.pth"))
    fr_batches = -(-N_EVAL_DAY // EVAL_BATCH), -(-N_EVAL_NIGHT // EVAL_BATCH)
    mf_batches = -(-N_EVAL_MF // EVAL_BATCH)
    tools = {}
    for what, module, fn_names, argv, batches, want_ious in (
            ("eval_hotnet", eval_hotnet, ("validate_model",),
             ["--runs", run_dir, "--testroot_day", fr_day, "--testroot_night", fr_night],
             {"ingest": sum(fr_batches)}, [eval_results["FR_night"]["ious"],
                                          eval_results["FR_day"]["ious"]]),
            ("dataset_qa_freiburg", dataset_qa, ("validate_model",),
             ["freiburg", "--data", fr_day, "--split", "day", "--checkpoint",
              adv_run.checkpoint], {"ingest": fr_batches[0]}, [eval_results["FR_day"]["ious"]]),
            ("dataset_qa_mfnet", dataset_qa, ("validate_model_mfnet",),
             ["mfnet", "--data", mf_root, "--split", "day", "--checkpoint",
              adv_run.checkpoint], {"ingest": 0, "fused_batches": mf_batches},
             [eval_results["MF_day"]["ious"]])):
        seen = []

        def recording(fn):
            def run(*a, **kw):
                ious = fn(*a, **kw)
                seen.append(np.asarray(ious))
                return ious
            return run

        n_batches = batches.get("fused_batches", batches["ingest"])
        want = {**zero, "ingest": batches["ingest"], "grouped_conv3x3_fused": 16 * n_batches}
        for k in all_kernels:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            for fn_name in fn_names:
                stack.enter_context(mock.patch.object(
                    module, fn_name, recording(getattr(module, fn_name))))
            if module is eval_hotnet:
                result = module.main(argv + ["--log_dir", os.path.join(work, "runs_8e")])
            else:
                result = module.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        equal = len(seen) == len(want_ious) and all(
            np.array_equal(a, np.asarray(b), equal_nan=True) for a, b in zip(seen, want_ious))
        print(f"  8e. {what}: launches {got} (want {want}); IoUs equal to phase 5f's, bit "
              f"for bit: {equal}; result {result}; {wall:.1f} s", flush=True)
        if got != want or not equal:
            fail(f"{what}: launches {got} (want {want}); IoUs {seen} against {want_ious}")
        tools[what] = {"launches": got, "ious_equal_5f": equal, "seconds": wall}
    later.update(tools)
    print(f"  phases 8a-8e: {time.perf_counter() - t_8:.1f} s", flush=True)

    # 9. int8 serving (csrc/int8_conv.cu through ops/quant.py), the borders
    # mode, reference checkpoints and the Vistas relabelling. Each path is
    # driven with the counts set to 0 just before it and read just after.
    from heatnet_tpu_torch.cli import convert_checkpoint, generate_vistas
    from heatnet_tpu_torch.data.png import write_png
    from heatnet_tpu_torch.models.layers import GroupedConv
    from heatnet_tpu_torch.ops import int8_conv
    from heatnet_tpu_torch.ops.quant import calibrate_int8, convert_int8
    from heatnet_tpu_torch.tools.int8_compare import jax_int8_layers

    t_9 = time.perf_counter()
    q_kernels = all_kernels + (int8_conv.INT8_CONV,)

    def q_counts():
        return {k.name: k.launches for k in q_kernels}

    def zero_counts():
        for k in q_kernels:
            k.launches = 0

    # phase 4c's segnet as a ResNeXtSeg checkpoint, and a 320x960 pack
    saved = torch.load(adv_run.checkpoint, map_location="cpu", weights_only=True)
    seg_sd = {k[len("trgb_segnet."):]: v for k, v in saved["state_dict"].items()
              if k.startswith("trgb_segnet.")}
    seg_ckpt = os.path.join(work, "conf_segnet.pth")
    torch.save(seg_sd, seg_ckpt)
    q_pack = os.path.join(work, "int8_pack")
    prng = np.random.RandomState(9)
    write_pack(q_pack, prng.randint(0, 256, (16, 320, 960, 3)).astype(np.uint8),
               prng.randint(21000, 26000, (16, 320, 960, 1)).astype(np.uint16))
    q_frames = [PackedFrameDataset(q_pack)[i] for i in range(16)]
    batch8, _ = next(validate.batched(iter(q_frames), N_BATCH, ["rgb", "ir"]))

    def seg_model(quant):
        m = get_model("net_resnext50", classes=13, input_channels=4)
        m.load_state_dict(seg_sd, strict=True)
        if quant:
            convert_int8(m)
        return prepare_for_inference(m, dev)

    # which layers JAX quantizes at batch 8 x 320x960, from the float model's
    # layer inputs and JAX's predicates (tools/int8_compare.py)
    f_model = seg_model(False)
    shapes, q_layers, configs = jax_int8_layers(
        f_model, lambda: validate.predict(f_model, batch8, "ir_rgb", dev))
    n_grouped = sum(isinstance(f_model.get_submodule(k), GroupedConv) for k in shapes)
    per_fwd = {"ingest": 1, "grouped_conv3x3": 0,
               "grouped_conv3x3_fused": n_grouped - sum(
                   isinstance(f_model.get_submodule(k), GroupedConv) for k in q_layers),
               "grouped_conv3x3_dx": 0, "int8_conv": len(q_layers)}
    print(f"int8 serving: by JAX's predicates a batch-8 forward of ResNeXt-50 at 320x960 "
          f"launches {per_fwd} ({len(shapes)} conv() layers, {n_grouped} grouped)",
          flush=True)

    # 9a. the kernel against its plain version at each int8 layer shape
    def valid_taps(size_in, size_out, k, s, p, d):
        return sum(sum(0 <= o * s - p + t * d < size_in for o in range(size_out))
                   for t in range(k))

    def lines_read(size_in, size_out, k, s, p, d):
        """Input rows (or columns) that some valid tap reads: a strided 1x1
        conv reads every s-th, and NHWC rows make the skipped pixels free."""
        return len({o * s - p + t * d for o in range(size_out) for t in range(k)}
                   & set(range(size_in)))

    print(f"kernels: int8_conv at the {len(configs)} layer shapes of that forward, "
          "bit for bit against the plain version", flush=True)
    torch.cuda.empty_cache()
    spec_path, times_path = os.path.join(work, "int8_spec.json"), os.path.join(
        work, "int8_card_times.json")
    with open(spec_path, "w") as f:
        json.dump({"configs": list(configs), "frame": [320, 960]}, f)
    t_child = time.perf_counter()
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--int8-card-times",
                            spec_path, times_path], capture_output=True, text=True,
                           timeout=300)
    if child.returncode != 0:
        fail(f"the int8 card-time process: rc {child.returncode}\n{child.stderr[-3000:]}")
    with open(times_path) as f:
        card = json.load(f)
    fwd_card_ms, fwd_q_ms, fwd_g_ms, fwd_recs, fwd_launched = card["forward"]
    print(f"  card times (torch.profiler) from a process of its own, "
          f"{time.perf_counter() - t_child:.1f} s", flush=True)
    i8_rows, i8_err = [], 0.0
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    # inputs: a post-ReLU x, as every int8 layer of the model sees (half of
    # it zeros), and for the equality check also the same x before the ReLU
    for ((cin, cout, k, s, p, d, groups, n, h, w), names), card_row in zip(
            configs.items(), card["layers"]):
        (k_dev, k_q, k_g, n_rec, n_launch) = card_row["relu"]
        k_dev_signed = card_row["signed"][0]
        g = torch.Generator().manual_seed(cin + cout + k + d + h)
        x_signed = (torch.randn((n, h, w, cin), generator=g) * 2).to(dev, torch.bfloat16)
        x_signed = x_signed.permute(0, 3, 1, 2)
        x = torch.relu(x_signed)
        w_q, w_scale = int8_conv.quantize_weight(
            torch.randn((cout, cin // groups, k, k), generator=g))
        w_q, w_scale = w_q.to(dev), w_scale.to(dev)
        w_pack = int8_conv.pack_weight(w_q, groups)
        x_scale = (x_signed.float().abs().amax() / 100).reshape(())
        ep = None if groups == 1 else ((torch.rand(cout, generator=g) + 0.5).to(dev),
                                       (torch.randn(cout, generator=g) * 0.1).to(dev),
                                       "relu", 0.01)
        args = (w_scale, x_scale, None, s, p, d, groups, ep)
        what = (f"{cin}->{cout} {k}x{k} s{s} d{d}{f' g{groups}' if groups > 1 else ''} "
                f"at {n}x{h}x{w} (x{len(names)}, e.g. {names[0]})")
        for xi in (x, x_signed):
            out = int8_conv.int8_conv2d(xi, w_q, w_pack, *args)
            ref = int8_conv.int8_conv2d_plain(xi, w_q, *args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            i8_err = max(i8_err, err)
            if not torch.equal(out, ref):
                fail(f"int8_conv {what}: max |kernel - plain| {err}, not bit for bit")
        fn = lambda: int8_conv.int8_conv2d(x, w_q, w_pack, *args)
        k_ms = time_ms(fn)
        p_ms = time_ms(lambda: int8_conv.int8_conv2d_plain(x, w_q, *args), reps=2)
        ho, wo = out.shape[2], out.shape[3]
        lib_ms = None
        if k == 1 and groups == 1 and cin % 8 == 0 and cout % 8 == 0 and n * ho * wo > 16:
            a = int8_conv.quantize_input(x[:, :, ::s, ::s], x_scale).to(torch.int8)
            a = a.permute(0, 2, 3, 1).reshape(-1, cin).contiguous()
            b = w_q.view(cout, cin).t()
            lib_ms = time_ms(lambda: torch._int_mm(a, b))
        # a yardstick only: cuDNN's bf16 conv of the same shape computes
        # another function (float operands, no quantization)
        w_bf = w_q.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        cudnn_ms = time_ms(lambda: F.conv2d(x, w_bf, None, s, p, d, groups))
        del w_bf
        macs = (n * cout * (cin // groups) * valid_taps(h, ho, k, s, p, d)
                * valid_taps(w, wo, k, s, p, d))
        n_bytes = (n * cin * 2 * lines_read(h, ho, k, s, p, d) * lines_read(w, wo, k, s, p, d)
                   + n * ho * wo * cout * 2 + w_q.numel() + cout * 4)
        b_ms, b_by = bound_ms(n_bytes, 2 * macs, INT8_OP_PER_S)
        i8_rows.append({"layer": what, "per_forward": len(names), "ms": k_ms,
                        "device_ms": k_dev, "device_ms_quantize": k_q,
                        "device_ms_gemm": k_g, "device_ms_signed_x": k_dev_signed,
                        "plain_ms": p_ms, "library_ms": lib_ms,
                        "cudnn_bf16_ms": cudnn_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
                        "ops": 2 * macs, "share_of_bound": b_ms / k_ms,
                        "card_share_of_bound": None if k_dev is None else b_ms / k_dev})
        print(f"  {what}: equal; card ms quantize {fmt(k_q)} + product {fmt(k_g)} = "
              f"{fmt(k_dev)} ({fmt(k_dev_signed)} on the signed x; {n_rec} records of "
              f"{n_launch} launches), bound_ms {b_ms:.4f} ({b_by}), share of the bound "
              f"{fmt(None if k_dev is None else b_ms / k_dev)} (card), {b_ms / k_ms:.3f} "
              f"(eager); kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f}; _int_mm "
              f"{'-' if lib_ms is None else f'{lib_ms:.4f}'}; cuDNN bf16 F.conv2d "
              f"{cudnn_ms:.4f} (another function's time, a yardstick only)", flush=True)
        del x, x_signed, out, ref
    torch.cuda.empty_cache()
    i8 = {key: sum(r["per_forward"] * r[key] for r in i8_rows)
          for key in ("ms", "plain_ms")}
    for key in ("device_ms", "device_ms_quantize", "device_ms_gemm", "device_ms_signed_x",
                "cudnn_bf16_ms"):
        i8[key] = (None if any(r[key] is None for r in i8_rows)
                   else sum(r["per_forward"] * r[key] for r in i8_rows))
    i8_bound, i8_by = bound_ms(sum(r["per_forward"] * r["bytes"] for r in i8_rows),
                               sum(r["per_forward"] * r["ops"] for r in i8_rows), INT8_OP_PER_S)
    lib_rows = [r for r in i8_rows if r["library_ms"] is not None]
    i8_lib = sum(r["per_forward"] * r["library_ms"] for r in lib_rows)
    i8_lib_kernel = sum(r["per_forward"] * r["ms"] for r in lib_rows)
    i8_lib_card = (None if any(r["device_ms"] is None for r in lib_rows)
                   else sum(r["per_forward"] * r["device_ms"] for r in lib_rows))
    print(f"  one forward's {len(q_layers)} int8 launches: card ms quantize "
          f"{fmt(i8['device_ms_quantize'])} + product {fmt(i8['device_ms_gemm'])} = "
          f"{fmt(i8['device_ms'])} ({fmt(i8['device_ms_signed_x'])} on the signed x), "
          f"bound_ms {i8_bound:.4f} ({i8_by}), share of the bound "
          f"{fmt(None if i8['device_ms'] is None else i8_bound / i8['device_ms'])}; "
          f"kernel_ms {i8['ms']:.4f} plain_ms {i8['plain_ms']:.4f}; its "
          f"{sum(r['per_forward'] for r in lib_rows)} 1x1 launches card {fmt(i8_lib_card)} "
          f"(eager {i8_lib_kernel:.4f}) ms against _int_mm {i8_lib:.4f} ms; cuDNN bf16 "
          f"F.conv2d on the same shapes {i8['cudnn_bf16_ms']:.4f} ms (another function, "
          "a yardstick only)", flush=True)
    print(f"  the int8 kernels of one batch-8 int8 forward at 320x960 (random weights): "
          f"device {fmt(fwd_card_ms)} ms, quantize {fmt(fwd_q_ms)}, product "
          f"{fmt(fwd_g_ms)} ({fwd_recs} records of {fwd_launched} launches, 2 "
          "forwards)", flush=True)
    if fwd_launched != 2 * len(q_layers):
        fail(f"the card-time forward launched {fwd_launched} int8 kernels, want "
             f"{2 * len(q_layers)}")
    i8["forward_device_ms"] = fwd_card_ms

    # 9b. cli.inference --quant int8 --batch 8 on phase 4c's weights
    print("main path: cli.inference --quant int8 --batch 8, ResNeXt-50 (3,4,6,3) early "
          "fusion, phase 4c's weights, 16 frames of 320x960, calibrated on the first "
          "frame", flush=True)
    iters = 3
    q_argv = ["--data", q_pack, "--resume", seg_ckpt, "--iters", str(iters)]
    zero_counts()
    t0 = time.perf_counter()
    run_q = cli.main(q_argv + ["--batch", str(N_BATCH), "--quant", "int8"])
    torch.cuda.synchronize()
    got_q, wall = q_counts(), time.perf_counter() - t0
    b1 = 1 + 1 + iters  # calibration, warm-up and timing forwards, at batch 1
    b8 = 16 // N_BATCH
    want = {k: v * b8 for k, v in per_fwd.items()}
    want["ingest"] += b1
    want["grouped_conv3x3_fused"] += 16 * b1
    print(f"  launches {got_q} ({b1} batch-1 and {b8} batch-8 forwards; want {want}); "
          f"{run_q.frames_per_second:.1f} frames/s end to end; {wall:.1f} s", flush=True)
    if got_q != want:
        fail(f"cli.inference --quant int8: launches {got_q}, want {want}")
    if run_q.maps.shape != (16, 320, 960) or run_q.maps.max() >= 13:
        fail(f"int8 class maps {run_q.maps.shape} max {run_q.maps.max()}")
    zero_counts()
    run_bf = cli.main(q_argv + ["--batch", str(N_BATCH)])
    bf_counts = q_counts()
    agree_bf = float((run_q.maps == run_bf.maps).mean())

    def int8_plain(x, w_q, w_pack, *a):
        return int8_conv.int8_conv2d_plain(x, w_q, *a)

    zero_counts()
    with mock.patch.object(int8_conv, "int8_conv2d", int8_plain):
        run_p = cli.main(q_argv + ["--batch", str(N_BATCH), "--quant", "int8"])
    if q_counts()["int8_conv"] or bf_counts["int8_conv"]:
        fail("the bf16 or the plain-version run launched the int8 kernel")
    agree_plain = float((run_q.maps == run_p.maps).mean())
    print(f"  class-map agreement: int8 with bf16 {agree_bf:.6f} (need >= 0.90), with the "
          f"int8 plain versions on the card {agree_plain:.6f} (need >= 0.99)", flush=True)
    if agree_bf < 0.90 or agree_plain < 0.99:
        fail(f"int8 agreement: bf16 {agree_bf}, plain {agree_plain}")

    q_model = seg_model(True)
    calibrate_int8(q_model, [validate.ingest({k: q_frames[0][k] for k in ("rgb", "ir")},
                                             "ir_rgb", dev, q_model.compute_dtype)])
    batch32, _ = next(validate.batched(iter(q_frames * 2), 32, ["rgb", "ir"]))
    fwd_ms, fwd_launches = {}, {}
    for b, batch in ((N_BATCH, batch8), (32, batch32)):
        times = {"int8": [], "bf16": []}
        zero_counts()
        validate.predict(q_model, batch, "ir_rgb", dev)
        fwd_launches[b] = q_counts()["int8_conv"]
        for _ in range(13):
            for tag, m in (("int8", q_model), ("bf16", f_model)):
                t1 = time.perf_counter()
                validate.predict(m, batch, "ir_rgb", dev)
                torch.cuda.synchronize()
                times[tag].append((time.perf_counter() - t1) * 1e3)
        fwd_ms[b] = {tag: (float(np.percentile(v[3:], 50)), float(np.percentile(v[3:], 95)))
                     for tag, v in times.items()}
        print(f"  batch {b} forward (host clock, H2D to argmax), p50/p95 ms: int8 "
              f"{fwd_ms[b]['int8'][0]:.2f}/{fwd_ms[b]['int8'][1]:.2f}, bf16 "
              f"{fwd_ms[b]['bf16'][0]:.2f}/{fwd_ms[b]['bf16'][1]:.2f}; "
              f"{fwd_launches[b]} int8 launches", flush=True)

    zero_counts()
    r1q = cli.main(q_argv[:-2] + ["--iters", "1", "--quant", "int8"])  # batch 1
    n1 = q_counts()["int8_conv"]
    r1f = cli.main(q_argv[:-2] + ["--iters", "1"])
    unc = seg_model(True)
    zero_counts()
    unc_maps = validate.predict(unc, batch8, "ir_rgb", dev)
    n_unc = q_counts()["int8_conv"]
    unc_equal = bool(torch.equal(unc_maps, validate.predict(f_model, batch8, "ir_rgb", dev)))
    b1_equal = bool(np.array_equal(r1q.maps, r1f.maps))
    print(f"  batch 1 (frame at a time) with --quant int8: {n1} int8 launches, class maps "
          f"equal to bf16's: {b1_equal}; an uncalibrated int8 model at batch 8: {n_unc} "
          f"int8 launches, maps equal to bf16's: {unc_equal}", flush=True)
    if n1 or not b1_equal or n_unc or not unc_equal:
        fail("batch-1 or uncalibrated int8 serving is not the float path")
    later["int8_serving"] = {
        "launches": got_q, "per_batch8_forward": per_fwd, "agreement_bf16": agree_bf,
        "agreement_plain": agree_plain, "forward_ms_p50_p95": fwd_ms,
        "int8_launches_per_forward": fwd_launches, "frames_per_s": run_q.frames_per_second,
        "batch1_equal_bf16": b1_equal, "uncalibrated_equal_bf16": unc_equal}
    del q_model, unc, f_model
    torch.cuda.empty_cache()

    # 9c. the Vistas-borders mode on a 768x384 tree the phase writes
    print("main path: cli.inference --borders-data, RGB Vistas segnet (7x7 stem), 4 "
          "frames of 768x384, bf16 and --quant int8", flush=True)
    bdir = os.path.join(work, "borders")
    os.makedirs(bdir)
    prng = np.random.RandomState(10)
    lines = []
    for i in range(4):
        borders = np.zeros((384, 768), np.uint8)
        borders[prng.randint(0, 384, 6), :] = 1
        borders[:, prng.randint(0, 768, 6)] = 1
        paths = [os.path.join(bdir, f"{k}_{i}.png") for k in ("borders", "ids", "image", "dt")]
        write_png(paths[0], borders, level=1)
        write_png(paths[1], (prng.randint(0, 14, (384, 768)) * 256
                             + prng.randint(0, 256, (384, 768))).astype(np.uint16), level=1)
        write_png(paths[2], prng.randint(0, 256, (384, 768, 3)).astype(np.uint8), level=1)
        write_png(paths[3], prng.randint(0, 30, (384, 768)).astype(np.uint8), level=1)
        lines.append(" ".join(paths))
    with open(os.path.join(bdir, "paths.txt"), "w") as f:
        f.write("\n".join(lines))
    borders_out = {}
    for quant in ("none", "int8"):
        out_dir = os.path.join(work, f"borders_{quant}")
        zero_counts()
        t0 = time.perf_counter()
        run_b = cli.main(["--borders-data", os.path.join(bdir, "paths.txt"), "--iters", "3",
                          "--im-save-dir", out_dir, "--quant", quant])
        torch.cuda.synchronize()
        pngs = sorted(os.listdir(out_dir))
        ok = (len(pngs) == 12 and np.array_equal(
            read_png(os.path.join(out_dir, "pred_0.png")),
            (np.clip(color_code_labels(run_b.maps[0]), 0, 1) * 255).astype(np.uint8)))
        borders_out[quant] = {"launches": q_counts(), "network_ms": run_b.network_seconds * 1e3,
                              "pngs": len(pngs), "maps": run_b.maps}
        print(f"  --quant {quant}: Network took {run_b.network_seconds * 1e3:.2f} ms; "
              f"launches {q_counts()}; {len(pngs)} PNGs, pred_0.png the palette-coded "
              f"map: {ok}; {time.perf_counter() - t0:.1f} s", flush=True)
        if not ok or run_b.maps.shape[0] != 4:
            fail(f"--borders-data --quant {quant}: {pngs}, maps {run_b.maps.shape}")
    if borders_out["int8"]["launches"]["int8_conv"] or not np.array_equal(
            borders_out["int8"]["maps"], borders_out["none"]["maps"]):
        fail("--borders-data at batch 1: int8 is not the float path")
    later["borders_serving"] = {
        "launches": borders_out["none"]["launches"],
        **{f"network_ms_{q}": v["network_ms"] for q, v in borders_out.items()}}

    # 9d. a reference-named checkpoint through cli.convert_checkpoint
    ref_path = os.path.join(work, "reference.pth.tar")
    torch.save({"state_dict": reference_names(seg_sd), "epoch": 3}, ref_path)
    conv_path = os.path.join(work, "converted.pth")
    convert_checkpoint.main(["--torch-checkpoint", ref_path, "--out", conv_path,
                             "--to-rename", "module.trgb_segnet.", "--rename", ""])
    conv_sd = torch.load(conv_path, map_location="cpu", weights_only=True)["state_dict"]
    same_tensors = set(conv_sd) == set(seg_sd) and all(
        torch.equal(conv_sd[k], v) for k, v in seg_sd.items())
    zero_counts()
    run_c = cli.main(["--data", q_pack, "--resume", conv_path, "--batch", str(N_BATCH),
                      "--iters", "1"])
    same_maps = bool(np.array_equal(run_c.maps, run_bf.maps))
    print(f"  9d. cli.convert_checkpoint of phase 4c's weights under the reference's names: "
          f"tensors bit for bit {same_tensors}; cli.inference --resume maps equal to "
          f"phase 4c's bf16 maps bit for bit: {same_maps}; launches {q_counts()}", flush=True)
    if not (same_tensors and same_maps):
        fail("the converted reference checkpoint does not serve phase 4c's weights")
    later["convert_checkpoint"] = {"launches": q_counts(), "maps_equal": same_maps}

    # 9e. cli.generate_vistas on a PNG Vistas tree, then one cli.main step on it
    vroot = os.path.join(work, "vistas_src")
    for d in ("training/images", "v1.2/instances"):
        os.makedirs(os.path.join(vroot, d))
    prng = np.random.RandomState(11)
    for i in range(4):
        write_png(os.path.join(vroot, f"training/images/s{i}.png"),
                  prng.randint(0, 256, (960, 1280, 3)).astype(np.uint8), level=1)
        cls = (np.arange(960)[:, None] // 120 + np.arange(1280)[None, :] // 160 + i) % 66
        write_png(os.path.join(vroot, f"v1.2/instances/s{i}.png"),
                  (cls * 256 + prng.randint(0, 3, (960, 1280))).astype(np.uint16), level=1)
    gen = os.path.join(work, "vistas_gen")
    from heatnet_tpu_torch.native import bindings as native
    native_calls = []
    real_relabel = native.relabel_vistas_image_native
    with mock.patch.object(native, "relabel_vistas_image_native",
                           lambda *a, **k: native_calls.append(1) or real_relabel(*a, **k)):
        n_gen = generate_vistas.main(["--vistas_root", vroot, "--out", gen])
    relabeller = "native" if len(native_calls) == n_gen else "numpy"
    print(f"  9e. the relabeller that served cli.generate_vistas: {relabeller} "
          f"({len(native_calls)} native calls for {n_gen} frames)", flush=True)
    if relabeller != "native":
        fail("cli.generate_vistas --use_native did not relabel with the native library")
    labels = read_png(os.path.join(gen, "labels", "s0.png"))
    zero_counts()
    gen_run = vistas_cli.main(["--data", gen, "--valdata", gen, "--batch-size", "4",
                               "--epochs", "1", "--checkpoint-dir",
                               os.path.join(work, "gen_ck"), "--log-dir",
                               os.path.join(work, "runs_9e")])
    torch.cuda.synchronize()
    print(f"  9e. cli.generate_vistas: {n_gen} frames, labels {labels.shape} classes "
          f"{sorted(set((labels // 256).ravel().tolist()))}; cli.main on them: losses "
          f"{gen_run.losses}, mIoU {gen_run.mious}; launches {q_counts()}", flush=True)
    if (n_gen != 4 or labels.shape != (768, 1024) or int((labels // 256).max()) > 13
            or len(gen_run.losses) != 1 or not np.isfinite(gen_run.losses).all()):
        fail("cli.generate_vistas + cli.main did not run as expected")
    later["generate_vistas_main"] = {"launches": q_counts(), "losses": gen_run.losses,
                                     "relabeller": relabeller}
    print(f"  phases 9a-9e: {time.perf_counter() - t_9:.1f} s", flush=True)

    # 10. Freiburg PNG training trees and packs, and the serving artifact.
    # Each path is driven with the counts set to 0 just before it and read
    # just after.
    from heatnet_tpu_torch.cli import export_model, pack_frames, train_uncertainty
    from heatnet_tpu_torch.data.loaders import (FreiburgInferDataset, FreiburgThermalDataset,
                                                get_test_paths, get_test_stamps)

    t_10 = time.perf_counter()
    n_day, n_night = TREE_FRAMES
    print(f"main path: Freiburg PNG training tree of {n_day} day + {n_night} night frames "
          f"at {TREE_HW[0]}x{TREE_HW[1]} (resized to 960x320), {TREE_SHARED} day stamps "
          f"shared with an {N_TREE_TEST}-frame test tree", flush=True)
    t0 = time.perf_counter()
    tree_test_day = write_fr_tree(os.path.join(work, "tree_test_day"), N_TREE_TEST, 7)
    tree_test_night = write_fr_tree(os.path.join(work, "tree_test_night"), N_TREE_TEST, 8)
    test_stamps = get_test_stamps(get_test_paths([tree_test_night, tree_test_day])[2])
    shared = sorted(get_test_stamps(get_test_paths([tree_test_day])[2]))[:TREE_SHARED]
    tree = write_fr_train_tree(os.path.join(work, "fr_train_tree"), n_day, n_night,
                               TREE_HW, 12, shared)
    print(f"  trees written in {time.perf_counter() - t0:.1f} s", flush=True)

    # 10a. the packer, against the tree's own items
    tree_pack = os.path.join(work, "fr_train_pack")
    t0 = time.perf_counter()
    packed_day = pack_frames.main(["--data", tree, "--out", tree_pack, "--train", "--quiet",
                                   "--testroot_day", tree_test_day,
                                   "--testroot_night", tree_test_night])
    pack_s = time.perf_counter() - t0
    test_pack = os.path.join(work, "fr_test_split_pack")
    pack_frames.main(["--data", tree, "--out", test_pack, "--train", "--quiet",
                      "--split", "test", "--testroot_day", tree_test_day,
                      "--testroot_night", tree_test_night])
    metas = []
    for d in (tree_pack, test_pack):
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    kept_day = n_day - TREE_SHARED
    want_test = (-(-kept_day // 100), -(-n_night // 100))  # ceil(1 %) of each set
    want_metas = [{"format": "heatnet-train-pack-v1", "split": split, "n_day": nd,
                   "n_night": nn, "height": 320, "width": 960, "test_stamps_filtered": True}
                  for split, nd, nn in (("train", kept_day - want_test[0],
                                         n_night - want_test[1]),
                                        ("test",) + want_test)]
    tree_ds = FreiburgThermalDataset(tree, test_stamps=test_stamps)
    excluded = {tuple(int(t) for t in os.path.basename(p).split(".")[0].split("_")[-2:])
                for p in tree_ds.ir_day_files} & set(shared)
    pack_ds = PackedFreiburgTrainDataset(tree_pack)
    t0 = time.perf_counter()
    tree_items = [tree_ds[i] for i in range(len(tree_ds))]
    tree_item_s = (time.perf_counter() - t0) / len(tree_ds)
    t0 = time.perf_counter()
    pack_items = [pack_ds[i] for i in range(len(pack_ds))]
    pack_item_s = (time.perf_counter() - t0) / len(pack_ds)
    items_equal = len(tree_items) == len(pack_items) == packed_day and all(
        np.array_equal(a[k], b[k]) for a, b in zip(tree_items, pack_items) for k in a)
    del tree_items, pack_items
    host_ms = {}
    for what, ds in (("tree", FreiburgThermalDataset(tree, test_stamps=test_stamps)),
                     ("pack", PackedFreiburgTrainDataset(tree_pack))):
        t0 = time.perf_counter()
        items = [ds[i] for i in range(N_ADV)]
        {k: np.stack([it[k] for it in items]) for k in items[0]}
        host_ms[what] = (time.perf_counter() - t0) * 1e3
    print(f"  10a. cli.pack_frames --train: {packed_day} day frames in {pack_s:.1f} s; "
          f"meta {metas[0]}; --split test meta {metas[1]}; test stamps left in the tree's "
          f"day set: {sorted(excluded)}; pack items = tree items bit for bit: {items_equal} "
          f"({1e3 * tree_item_s:.1f} ms per item from the tree, {1e3 * pack_item_s:.2f} from "
          f"the pack); host ms per batch of {N_ADV} (one thread): tree {host_ms['tree']:.1f}, "
          f"pack {host_ms['pack']:.1f}", flush=True)
    if metas != want_metas or excluded or not items_equal:
        fail(f"cli.pack_frames: meta {metas} (want {want_metas}), stamps {excluded}, "
             f"items equal {items_equal}")
    later["pack_frames_train"] = {"launches": {}, "pack_s": pack_s, "meta": metas[0],
                                  "items_equal_tree": items_equal,
                                  "tree_ms_per_item": tree_item_s * 1e3,
                                  "host_ms_per_batch16": host_ms}

    # 10b. train_conf at phase 4c's operating point from the PNG tree
    print(f"main path: cli.train_conf from the PNG tree, ResNeXt-50 (3,4,6,3) + 6 cyclegan "
          f"critics, batch {N_ADV}, {CROP[0]}x{CROP[1]} crop, --moddrop --irscale, IR teacher, "
          "2 critic + 2 seg steps", flush=True)
    per_step.clear()
    tree_argv = ["--dataroot", tree, "--batch_size", str(N_ADV), "--discarch", "cyclegan",
                 "--num_critics", "6", "--moddrop", "--irscale",
                 "--night_supervision_model", teacher_ckpt,
                 "--iter_initial_critic_phase", "2", "--iter_critic_phase", "2",
                 "--iter_seg_phase", "2", "--n_epochs", "2",
                 "--testroot_day", tree_test_day, "--testroot_night", tree_test_night,
                 "--eval_everyn", "1000", "--checkpointname", os.path.join(work, "tree_conf"),
                 "--log_dir", os.path.join(work, "runs_10b")]
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train_conf, "make_adversarial_steps", counted_steps):
        tree_run = train_conf.main(tree_argv)
    torch.cuda.synchronize()
    tree_wall = time.perf_counter() - t0
    tree_launches = q_counts()
    tree_steps = {}
    for phase in ("train_critic", "train_seg"):
        seen = [c for p, c in per_step if p == phase]
        ms = [t * 1e3 for t, p in zip(tree_run.step_seconds, tree_run.phases) if p == phase]
        tree_steps[phase] = float(np.percentile(ms, 50))
        print(f"  per {phase} step: {seen} (want {want_step[phase]}); losses "
              f"{[round(v, 6) for v in tree_run.losses[phase]]}; step ms (host, augmentation "
              f"to loss) {[round(v, 2) for v in ms]}", flush=True)
        if (len(seen) != 2 or any(c != want_step[phase] for c in seen)
                or not all(np.isfinite(tree_run.losses[phase]))):
            fail(f"train_conf from a PNG tree, {phase}: launches {seen}, losses "
                 f"{tree_run.losses[phase]}")
    print(f"  {len(tree_run.phases)} steps in {tree_wall:.1f} s wall (eval at epoch 0, "
          f"the tree's host chain on one producer thread)", flush=True)
    later["train_conf_tree"] = {"launches": tree_launches, "wall_s": tree_wall,
                                "step_ms_p50": tree_steps}

    # 10c. train_plain and train_uncertainty on the tree, 2 steps each
    tree_trainers = {}
    for what, mod, extra, want in (
            ("train_plain", train_plain,
             ["--batch_size", str(N_TRAIN), "--max_iters_per_epoch", "2"], 16),
            ("train_uncertainty", train_uncertainty,
             ["--batch_size", str(N_UNC), "--max_iters_per_epoch", "2"], 16)):
        zero_counts()
        t0 = time.perf_counter()
        run = mod.main(["--dataroot", tree, "--n_epochs", "1", *extra, "--checkpointname",
                        os.path.join(work, f"tree_{what}"),
                        "--log_dir", os.path.join(work, f"runs_10c_{what}")])
        torch.cuda.synchronize()
        got = q_counts()
        steps = len(run.losses)
        want_c = {"ingest": 0, "grouped_conv3x3": want * steps, "grouped_conv3x3_fused": 0,
                  "grouped_conv3x3_dx": want * steps, "int8_conv": 0}
        print(f"  10c. cli.{what} from the tree: {steps} steps, losses "
              f"{[round(float(v), 6) for v in run.losses]}, launches {got} (want {want_c}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if steps != 2 or got != want_c or not np.isfinite(run.losses).all():
            fail(f"cli.{what} from a PNG tree: {steps} steps, launches {got}")
        tree_trainers[what] = {"launches": got, "losses": [float(v) for v in run.losses]}
    later.update({f"{k}_tree": v for k, v in tree_trainers.items()})

    # 10d. a capture tree and its pack through cli.inference at batch 8
    capture = os.path.join(tree, "seq00_day", "drive0")  # fl_rgb/ + fl_ir_aligned/
    cap_pack = os.path.join(work, "capture_pack")
    t0 = time.perf_counter()
    n_cap = pack_frames.main(["--data", capture, "--out", cap_pack, "--quiet"])
    cap_pack_s = time.perf_counter() - t0
    served = {}
    for what, data in (("pack", cap_pack), ("tree", capture)):
        zero_counts()
        run = cli.main(["--data", data, "--resume", seg_ckpt, "--batch", str(N_BATCH),
                        "--iters", "1"])
        served[what] = (run, q_counts())
    n_fwd = 2 + -(-n_cap // N_BATCH)  # warm-up + 1 timed at batch 1, then batches of 8
    want_d = {"ingest": n_fwd, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16 * n_fwd,
              "grouped_conv3x3_dx": 0, "int8_conv": 0}
    cap_equal = bool(np.array_equal(served["pack"][0].maps, served["tree"][0].maps))
    print(f"  10d. cli.pack_frames: {n_cap} frames in {cap_pack_s:.1f} s; cli.inference "
          f"--batch {N_BATCH} on the pack and on the tree, phase 4c's weights: maps "
          f"{served['pack'][0].maps.shape} bit for bit {cap_equal}; launches "
          f"{served['pack'][1]} and {served['tree'][1]} (want {want_d}); frames/s "
          f"{served['pack'][0].frames_per_second:.1f} and "
          f"{served['tree'][0].frames_per_second:.1f}", flush=True)
    if not cap_equal or any(c != want_d for _, c in served.values()):
        fail("cli.inference on a pack and on its capture tree disagree")
    later["inference_capture_pack"] = {"launches": served["pack"][1],
                                       "frames_per_s": served["pack"][0].frames_per_second}
    later["inference_capture_tree"] = {"launches": served["tree"][1],
                                       "frames_per_s": served["tree"][0].frames_per_second}
    cli_maps = served["pack"][0].maps

    # 10e. the serving artifact, served by a child process without the model code
    cap_frames = PackedFrameDataset(cap_pack)
    spec = {"rgb": os.path.join(work, "art_rgb.npy"), "ir": os.path.join(work, "art_ir.npy")}
    np.save(spec["rgb"], np.asarray(cap_frames.rgb))
    np.save(spec["ir"], np.asarray(cap_frames.ir))

    def serve_in_child(artifact):
        spec_path, out = os.path.join(work, "art_spec.json"), os.path.join(work, "art_out.npz")
        with open(spec_path, "w") as f:
            json.dump(dict(spec, artifact=artifact), f)
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-artifact",
                                spec_path, out], capture_output=True, text=True, timeout=900)
        if child.returncode != 0:
            fail(f"the artifact's child process failed:\n{child.stderr[-4000:]}")
        res = np.load(out)
        return res["maps"], json.loads(str(res["meta"]))

    def eager_ms(model, batch):
        rgb = torch.from_numpy(batch["rgb"]).to(dev)
        ir = torch.from_numpy(batch["ir"].view(np.int16)).to(dev).view(torch.uint16)
        ms = []
        with torch.no_grad():
            for _ in range(23):
                t1 = time.perf_counter()
                model(*validate.normalize_frames([rgb, ir], model.compute_dtype))[0].argmax(-1)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
        return [float(np.percentile(ms[3:], 50)), float(np.percentile(ms[3:], 95))]

    print("main path: cli.export_model of phase 4c's weights (ResNeXt-50, raw inputs, "
          f"{H_IN}x{W_IN}, symbolic batch, cuda), served by a child process", flush=True)
    artifact = os.path.join(work, "heatnet.pt2")
    t0 = time.perf_counter()
    export_model.main(["--resume", seg_ckpt, "--out", artifact])
    export_s = time.perf_counter() - t0
    art_maps, art = serve_in_child(artifact)
    agree = float((art_maps == cli_maps).mean())
    cap8, _ = next(validate.batched((cap_frames[i] for i in range(N_BATCH)), N_BATCH,
                                    ["rgb", "ir"]))
    f_model = seg_model(False)
    eager = eager_ms(f_model, cap8)
    del f_model
    want_call = {"ingest": 1, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 16,
                 "grouped_conv3x3_dx": 0, "int8_conv": 0}
    foreign = [m for m in art["modules"] if not m.startswith(
        ("heatnet_tpu_torch.ops", "heatnet_tpu_torch.kernels")) and m != "heatnet_tpu_torch"]
    print(f"  10e. exported in {export_s:.1f} s ({os.path.getsize(artifact) / 1e6:.1f} MB), "
          f"loaded in the child in {art['load_s']:.1f} s; its port modules {art['modules']}; "
          f"launches per call: batch 1 {art['launches_batch1']}, batch 8 "
          f"{art['launches_batch8']} (want {want_call}); maps {art_maps.shape} {art['dtype']}, "
          f"agreement with cli.inference {agree:.6f} (need >= {EXPORT_AGREE}); batch-8 p50/p95 "
          f"ms: artifact {art['ms_p50_p95'][0]:.2f}/{art['ms_p50_p95'][1]:.2f}, eager forward "
          f"{eager[0]:.2f}/{eager[1]:.2f}", flush=True)
    if (foreign or art["launches_batch1"] != want_call or art["launches_batch8"] != want_call
            or art_maps.shape != cli_maps.shape or agree < EXPORT_AGREE):
        fail(f"the exported artifact: modules {foreign}, launches {art['launches_batch8']}, "
             f"agreement {agree}")
    later["export_serving"] = {"launches": art["total"], "export_s": export_s,
                               "agreement_cli_inference": agree,
                               "ms_p50_p95_batch8": art["ms_p50_p95"],
                               "eager_ms_p50_p95_batch8": eager}

    print("main path: cli.export_model --quant int8 --calib-data the capture tree, served "
          "by a child process", flush=True)
    artifact8 = os.path.join(work, "heatnet_int8.pt2")
    t0 = time.perf_counter()
    export_model.main(["--resume", seg_ckpt, "--out", artifact8, "--quant", "int8",
                       "--calib-data", capture])
    export8_s = time.perf_counter() - t0
    art8_maps, art8 = serve_in_child(artifact8)
    q_model = seg_model(True)
    cap_ds = FreiburgInferDataset(capture)
    calibrate_int8(q_model, [validate.ingest({k: cap_ds[i][k] for k in ("rgb", "ir")},
                                             "ir_rgb", dev, q_model.compute_dtype)
                             for i in range(min(len(cap_ds), 8))])
    zero_counts()
    q_maps = torch.cat([validate.predict(q_model, b, "ir_rgb", dev) for b, _ in
                        validate.batched((cap_frames[i] for i in range(n_cap)), N_BATCH,
                                         ["rgb", "ir"])]).cpu().numpy()
    q_per_fwd = {k: v // -(-n_cap // N_BATCH) for k, v in q_counts().items()}
    f_model = seg_model(False)
    shapes8, q_layers8, _ = jax_int8_layers(
        f_model, lambda: validate.predict(f_model, cap8, "ir_rgb", dev))
    del f_model
    n_gr8 = sum(isinstance(q_model.get_submodule(k), GroupedConv) for k in shapes8)
    want8 = {"ingest": 1, "grouped_conv3x3": 0,
             "grouped_conv3x3_fused": n_gr8 - sum(
                 isinstance(q_model.get_submodule(k), GroupedConv) for k in q_layers8),
             "grouped_conv3x3_dx": 0, "int8_conv": len(q_layers8)}
    q_eager = eager_ms(q_model, cap8)
    del q_model
    agree8 = float((art8_maps == q_maps).mean())
    print(f"  10e. --quant int8: exported in {export8_s:.1f} s; launches per call: batch 1 "
          f"{art8['launches_batch1']}, batch 8 {art8['launches_batch8']}; the in-process int8 "
          f"model per batch-8 forward {q_per_fwd}; JAX's predicates at a symbolic batch "
          f"(batch 8) {want8}; agreement with the in-process int8 model {agree8:.6f} (need >= "
          f"{EXPORT_INT8_AGREE}); batch-8 p50/p95 ms: artifact {art8['ms_p50_p95'][0]:.2f}/"
          f"{art8['ms_p50_p95'][1]:.2f}, eager int8 {q_eager[0]:.2f}/{q_eager[1]:.2f}",
          flush=True)
    if (art8["launches_batch8"] != want8 or art8["launches_batch1"] != want8
            or q_per_fwd != want8 or agree8 < EXPORT_INT8_AGREE):
        fail(f"the int8 artifact: launches {art8['launches_batch8']} (want {want8}), "
             f"agreement {agree8}")
    later["export_serving_int8"] = {"launches": art8["total"], "export_s": export8_s,
                                    "agreement_in_process": agree8,
                                    "per_call": art8["launches_batch8"],
                                    "ms_p50_p95_batch8": art8["ms_p50_p95"],
                                    "eager_ms_p50_p95_batch8": q_eager}
    torch.cuda.empty_cache()
    print(f"  phases 10a-10e: {time.perf_counter() - t_10:.1f} s", flush=True)

    # 11. the trainers' remaining parts: the lean BN, --vis, CLAHE, data
    # parallelism, profiling
    t_11 = time.perf_counter()
    from heatnet_tpu_torch.cli import main as main_cli
    from heatnet_tpu_torch.data import clahe, loaders
    from heatnet_tpu_torch.data.loaders import VistasBordersDataset, VistasDataset
    from heatnet_tpu_torch.models import critics as critics_module
    from heatnet_tpu_torch.ops import lean_bn

    def bn_impl(impl):
        if impl == "lean":
            os.environ["HEATNET_BN_IMPL"] = "lean"
        else:
            os.environ.pop("HEATNET_BN_IMPL", None)

    # 11a. the lean BN in cli.train_plain at phase 4b's operating point
    print(f"main path: cli.train_plain under HEATNET_BN_IMPL=lean and the default, "
          f"ResNeXt-50 (3,4,6,3), batch {N_TRAIN}, {CROP[0]}x{CROP[1]} crop, "
          f"{LEAN_STEPS} steps each from the same weights and batches", flush=True)
    prng = np.random.RandomState(2)
    bands = (np.arange(320)[:, None] // 64 + np.arange(960)[None, :] // 192) % 13
    lean_pack = os.path.join(work, "lean_train")
    write_train_pack(
        lean_pack, prng.randint(0, 256, (12, 320, 960, 3)).astype(np.uint8),
        prng.randint(21000, 26000, (12, 320, 960)).astype(np.uint16),
        np.broadcast_to(bands, (12, 320, 960)).astype(np.uint8),
        prng.randint(0, 256, (12, 320, 960, 3)).astype(np.uint8),
        prng.randint(21000, 26000, (12, 320, 960)).astype(np.uint16))
    lean_out = {}
    for impl in ("default", "lean"):
        bn_impl(impl)
        per_step = []
        real_step = train_plain.train_step

        def counted_plain_step(state, batch, real_step=real_step, per_step=per_step):
            before = counts()
            loss = real_step(state, batch)
            float(loss)
            per_step.append({k: v - before[k] for k, v in counts().items()})
            return loss

        for k in all_kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(train_plain, "train_step", counted_plain_step):
            run = train_plain.main(["--dataroot", lean_pack, "--batch_size", str(N_TRAIN),
                                    "--n_epochs", str(LEAN_STEPS), "--decay_epoch", "2",
                                    "--max_iters_per_epoch", "1",
                                    "--checkpointname", os.path.join(work, f"lean_{impl}"),
                                    "--log_dir", os.path.join(work, "runs_11a")])
        torch.cuda.synchronize()
        ms = [s * 1e3 for s in run.step_seconds[1:]]  # the first picks cuDNN's plans
        lean_out[impl] = {"launches": counts(), "per_step": per_step, "losses": run.losses,
                          "step_ms_p50_p95": (float(np.percentile(ms, 50)),
                                              float(np.percentile(ms, 95))),
                          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        o = lean_out[impl]
        print(f"  {impl}: launches per step {per_step}; losses "
              f"{[round(v, 6) for v in run.losses]}; step ms (host, augmentation to loss, "
              f"after the first) p50 {o['step_ms_p50_p95'][0]:.2f} p95 "
              f"{o['step_ms_p50_p95'][1]:.2f}; peak memory {o['peak_memory_gb']:.2f} GB",
              flush=True)
        want = {"ingest": 0, "grouped_conv3x3": 16, "grouped_conv3x3_fused": 0,
                "grouped_conv3x3_dx": 16}
        if len(per_step) != LEAN_STEPS or any(c != want for c in per_step):
            fail(f"train_plain ({impl} BN): expected {LEAN_STEPS} steps of {want}, got "
                 f"{per_step}")
    bn_impl("default")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lean_out["lean"]["losses"],
                                                    lean_out["default"]["losses"])]
    print(f"  losses lean vs default: rel {[f'{v:.3g}' for v in loss_rel]} (tolerance "
          f"{STEP_LOSS_TOL})", flush=True)
    if not all(v <= STEP_LOSS_TOL for v in loss_rel):
        fail(f"lean BN losses {lean_out['lean']['losses']} vs default "
             f"{lean_out['default']['losses']}")

    raw = next(batch_iterator(PackedFreiburgTrainDataset(lean_pack), N_TRAIN, seed=0))
    batch = DeviceAugment(CROP, dev)(torch.Generator().manual_seed(1), raw)
    model = init_model(ResNeXtSeg(structure=(3, 4, 6, 3), input_channels=4), 0, dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def step0_grads(impl):
        bn_impl(impl)
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        seg = model(batch["rgb_day"], batch["ir_day"])[0]
        loss = cross_entropy_ignore(seg, batch["label_day"], ignore_index=-1)
        loss.backward()
        bn_impl("default")
        return float(loss.detach()), {k: p.grad.float().clone()
                                      for k, p in model.named_parameters()
                                      if p.grad is not None}

    calls = []
    real_apply = lean_bn.LeanBNAct.apply
    with mock.patch.object(lean_bn.LeanBNAct, "apply",
                           lambda *a: calls.append(1) or real_apply(*a)):
        loss_lean, grads_lean = step0_grads("lean")
        n_abn = len(calls)
        loss_def, grads_def = step0_grads("default")
        with mock.patch.object(gc, "grouped_conv3x3", fwd_library), \
                mock.patch.object(gc, "grouped_conv3x3_dx", dx_library):
            loss_lib, grads_lib = step0_grads("default")
    print(f"  step 0: {n_abn} ABN layers through the lean op, {len(calls) - n_abn} with "
          f"the default", flush=True)
    if not n_abn or len(calls) != n_abn:
        fail("the lean BN step did not run through ops/lean_bn.py, or the default did")
    hold_step("lean BN step 0 against the default BN (the library's distance: the "
              "default BN with cuDNN's grouped conv)", (loss_lean, loss_def, loss_lib),
              (grads_lean, grads_def, grads_lib))
    del model, start, batch, grads_lean, grads_def, grads_lib
    torch.cuda.empty_cache()

    # the lean op on the card against its float32 CPU counterpart
    g = torch.Generator().manual_seed(11)
    y = torch.randn((4, 64, 24, 40), generator=g) * 1.5 + 0.3
    scale, bias = torch.rand(64, generator=g) + 0.5, torch.randn(64, generator=g) * 0.2
    ct = torch.randn(y.shape, generator=g)
    lean_cmp = {}
    for where in ("cpu", "cuda"):
        ins = [t.detach().to(where).requires_grad_(True) for t in (y, scale, bias)]
        a, mean, var = lean_bn.lean_bn_act(*ins, 1e-5, "leaky_relu", 0.01)
        a.backward(ct.to(where))
        lean_cmp[where] = [t.detach().cpu() for t in (a, mean, var)] + [
            t.grad.cpu() for t in ins]
    lean_cpu_err = max(float((c - r).abs().max() / (r.abs().max() + 1e-12))
                       for c, r in zip(lean_cmp["cuda"], lean_cmp["cpu"]))
    print(f"  lean_bn_act float32 on the card vs the CPU (a, mean, var, dy, dscale, dbias): "
          f"max error {lean_cpu_err:.3g} of each tensor's largest value (need <= 1e-5)",
          flush=True)
    if lean_cpu_err > 1e-5:
        fail(f"lean_bn_act on the card disagrees with the CPU: {lean_cpu_err}")
    later["lean_train_plain"] = {
        "launches": lean_out["lean"]["launches"], "cpu_rel_err": lean_cpu_err,
        **{f"{impl}_{k}": v for impl, o in lean_out.items() for k, v in o.items()
           if k in ("step_ms_p50_p95", "peak_memory_gb", "losses")}}

    # 11b. train_conf --vis at phase 4c's operating point
    print(f"main path: cli.train_conf --vis --log_everyn 1, 4c's point (batch {N_ADV}, 6 "
          f"cyclegan critics, --moddrop --irscale, IR teacher), 2 critic + 2 seg steps, and "
          f"the same run without --vis", flush=True)
    vis_kernels_counts, vis_checks, vis_ms = [], [], []
    real_render = train_conf.render_vis

    def vis_maps(model, batch):
        flags = [(m, m.training) for m in model.modules()]
        model.eval()
        try:
            with torch.no_grad():
                out = model([batch["rgb_day"], batch["ir_day"]],
                            [batch["rgb_night"], batch["ir_night"]])
        finally:
            for m, t in flags:
                m.training = t
        return torch.stack([out["pred_label_a"][0].argmax(-1),
                            out["pred_label_b"][0].argmax(-1)])

    def plain_fused(x, w, scale, bias, groups, dilation=1, act="relu", slope=0.01):
        return gc.grouped_conv3x3_plain(x, w, groups, dilation, scale, bias, act, slope)

    def counted_render(model, batch, it, vis_dir, modalities, cert_branch=False):
        state = {k: v.clone() for k, v in model.state_dict().items()}
        rng = (torch.get_rng_state(), torch.cuda.get_rng_state())
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        paths = real_render(model, batch, it, vis_dir, modalities, cert_branch)
        torch.cuda.synchronize()
        vis_ms.append((time.perf_counter() - t0) * 1e3)
        vis_kernels_counts.append({k: v - before[k] for k, v in counts().items()})
        same = (all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
                and torch.equal(rng[0], torch.get_rng_state())
                and torch.equal(rng[1], torch.cuda.get_rng_state())
                and all(m.training for m in model.modules()))
        maps_k = vis_maps(model, batch)
        with mock.patch.object(gc, "grouped_conv3x3_fused", plain_fused):
            maps_p = vis_maps(model, batch)
        vis_checks.append((same, float((maps_k == maps_p).float().mean())))
        del state
        return paths

    class DeterministicResize(torch.autograd.Function):
        """``F.interpolate``'s bilinear resize with a backward that takes the
        same sums in a fixed order (the interpolation matrices, one einsum):
        the CUDA backward adds with atomics, so the critics' resizes make a
        seg step's gradient differ in its last bits from run to run."""

        @staticmethod
        def forward(ctx, x, hw):
            ctx.in_hw = x.shape[2:]
            return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)

        @staticmethod
        def backward(ctx, dy):
            def weights(n_in, n_out):
                eye = torch.eye(n_in, device=dy.device, dtype=dy.dtype)[None]
                return F.interpolate(eye, size=n_out, mode="linear", align_corners=False)[0]

            ay, ax = weights(ctx.in_hw[0], dy.shape[2]), weights(ctx.in_hw[1], dy.shape[3])
            return torch.einsum("ncHW,hH,wW->nchw", dy, ay, ax), None

    def deterministic_resize(x, hw):
        if tuple(x.shape[2:]) == tuple(hw):
            return x
        return DeterministicResize.apply(x, tuple(hw))

    def vis_run(vis: bool, tag: str):
        argv = ["--dataroot", adv_pack, "--batch_size", str(N_ADV), "--discarch",
                "cyclegan", "--num_critics", "6", "--moddrop", "--irscale",
                "--night_supervision_model", teacher_ckpt,
                "--iter_initial_critic_phase", "2", "--iter_critic_phase", "2",
                "--iter_seg_phase", "2", "--n_epochs", "1", "--log_everyn", "1",
                "--checkpointname", os.path.join(work, f"vis_{tag}"),
                "--log_dir", os.path.join(work, f"runs_11b_{tag}")] + (
                    ["--vis"] if vis else [])
        with mock.patch.object(train_conf, "render_vis", counted_render), \
                mock.patch.object(critics_module, "resize_bilinear", deterministic_resize):
            return train_conf.main(argv)

    # why: the CUDA backward of a critic-sized bilinear upsample, repeated
    x_up = torch.randn((N_ADV, 1, 10, 20), device=dev, requires_grad=True)
    dy_up = torch.randn((N_ADV, 1) + CROP, device=dev)
    up_grads = set()
    for _ in range(8):
        x_up.grad = None
        F.interpolate(x_up, size=CROP, mode="bilinear", align_corners=False).backward(dy_up)
        up_grads.add(x_up.grad.cpu().numpy().tobytes())
    del x_up, dy_up
    torch.backends.cudnn.deterministic = True
    no_vis = vis_run(False, "plain")
    with_vis = vis_run(True, "vis")
    vis_dir = os.path.join(work, "runs_11b_vis", "vis")
    names = sorted(os.listdir(vis_dir))
    want_names = sorted(f"{it:07d}_{n}.png" for it in range(1, 5)
                        for n in ("label_day", "label_night", "rgb_day", "ir_day"))
    same_losses = with_vis.losses == no_vis.losses
    torch.backends.cudnn.deterministic = False
    want_vis = {"ingest": 0, "grouped_conv3x3": 0, "grouped_conv3x3_fused": 32,
                "grouped_conv3x3_dx": 0}
    print(f"  phases {with_vis.phases}; {len(names)} panels {names[:5]}...; launches per vis "
          f"forward {vis_kernels_counts} (want {want_vis}: the segnet's 16 per day and "
          f"night forward, fused); vis ms per log point {[round(v, 1) for v in vis_ms]}",
          flush=True)
    print(f"  model, RNG and train flags unchanged by every vis forward: "
          f"{[c[0] for c in vis_checks]}; label maps (frame 0, day and night) against the "
          f"plain versions: {[round(c[1], 6) for c in vis_checks]} (need >= "
          f"{MIN_AGREEMENT})", flush=True)
    print(f"  losses with --vis {with_vis.losses}; without {no_vis.losses}; equal bit for "
          f"bit: {same_losses} (both runs: cuDNN deterministic, the critics' resizes with "
          f"a fixed-order backward; F.interpolate's own backward of a 10x20 -> "
          f"{CROP[0]}x{CROP[1]} upsample gave {len(up_grads)} distinct gradients in 8 "
          f"repeats)", flush=True)
    if (names != want_names or len(vis_kernels_counts) != 4
            or any(c != want_vis for c in vis_kernels_counts)
            or not all(c[0] for c in vis_checks)
            or any(c[1] < MIN_AGREEMENT for c in vis_checks)):
        fail(f"train_conf --vis: panels {names}, launches {vis_kernels_counts}, checks "
             f"{vis_checks}")
    if not same_losses:
        fail("the --vis run's losses differ from the run without --vis")
    later["train_conf_vis"] = {
        "launches": {k: sum(c[k] for c in vis_kernels_counts) for k in want_vis},
        "panels": len(names), "vis_ms": vis_ms, "losses_equal": same_losses,
        "agreement": [c[1] for c in vis_checks],
        "interpolate_backward_distinct_in_8": len(up_grads)}
    torch.cuda.empty_cache()

    # 11c. CLAHE in the Vistas loaders
    clahe_root = write_vistas_tree(os.path.join(work, "clahe_vistas"), 8, 12)
    try:
        import cv2
    except ImportError:
        cv2 = None

    def cv2_clahe(image_bgr, clip_limit=2.0, grid=8):
        lab = cv2.cvtColor(image_bgr, cv2.COLOR_BGR2LAB)
        lab[..., 0] = cv2.createCLAHE(clipLimit=clip_limit,
                                      tileGridSize=(grid, grid)).apply(lab[..., 0])
        return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)

    def items(ds, n):
        t0 = time.perf_counter()
        out = [ds[i] for i in range(n)]
        return out, (time.perf_counter() - t0) * 1e3 / n

    clahe_ms, clahe_equal = {}, {}
    for name, make in (("vistas_eval", lambda ce: VistasDataset(
                            clahe_root, 768, 384, augment_data=False,
                            contrast_enhancement=ce)),
                       ("vistas_train", lambda ce: VistasDataset(
                            clahe_root, 768, 384, contrast_enhancement=ce, seed=3)),
                       ("borders_default", lambda ce: VistasBordersDataset(
                            os.path.join(work, "borders", "paths.txt"), 768, 384,
                            **({} if ce else {"contrast_enhancement": False}), seed=3))):
        n = 4
        got, clahe_ms[name] = items(make(True), n)
        _, clahe_ms[name + "_without"] = items(make(False), n)
        if cv2 is not None:
            with mock.patch.object(loaders, "apply_clahe", cv2_clahe):
                want, _ = items(make(True), n)
            clahe_equal[name] = all(np.array_equal(a[k], b[k]) for a, b in zip(got, want)
                                    for k in b)
    if cv2 is not None:
        px = np.random.RandomState(13).randint(0, 256, (1 << 20, 1, 3)).astype(np.uint8)
        clahe_equal["bgr2lab_2^20"] = np.array_equal(clahe.bgr_to_lab(px),
                                                     cv2.cvtColor(px, cv2.COLOR_BGR2LAB))
        clahe_equal["lab2rgb_2^20"] = np.array_equal(clahe.lab_to_rgb(px),
                                                     cv2.cvtColor(px, cv2.COLOR_LAB2RGB))
    print(f"  11c. CLAHE: host ms per item {({k: round(v, 1) for k, v in clahe_ms.items()})}"
          f" (1024x768 Vistas frames, 768x384 borders frames, one thread); equal to cv2 "
          f"{cv2.__version__ if cv2 else '(cv2 does not import)'} on every pixel: "
          f"{clahe_equal}", flush=True)
    if cv2 is not None and not all(clahe_equal.values()):
        fail(f"CLAHE differs from cv2: {clahe_equal}")
    later["clahe"] = {"launches": {}, "host_ms_per_item": clahe_ms, "equal_cv2": clahe_equal}

    # 11d. cli.main data parallel as one process under a launcher's environment
    print("main path: cli.main (structure 1 1 1 1, batch 4 of 192x384, 2 steps and a "
          "validation) alone and as rank 0 of 1 under a torchrun-style environment (NCCL)",
          flush=True)
    main_tree = clahe_root
    dp_out = {}
    torch.backends.cudnn.deterministic = True
    for tag in ("plain", "nccl"):
        argv = ["--data", main_tree, "--valdata", main_tree, "--width", "384", "--height",
                "192", "--batch-size", "4", "--epochs", "1", "--structure", "1", "1", "1",
                "1", "--checkpoint-dir", os.path.join(work, f"dp_{tag}"), "--log-dir",
                os.path.join(work, "runs_11d"), "-j", "8"]
        for k in all_kernels:
            k.launches = 0
        env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
        with mock.patch.dict(os.environ, env if tag == "nccl" else {}):
            run = main_cli.main(argv)
            backend = (torch.distributed.get_backend() if torch.distributed.is_initialized()
                       else None)
            if backend is not None:
                torch.distributed.destroy_process_group()
        dp_out[tag] = {"launches": counts(), "losses": run.losses, "mious": run.mious,
                       "backend": backend, "state": torch.load(
                           run.checkpoint, map_location="cpu", weights_only=True)}
    torch.backends.cudnn.deterministic = False
    a, b = dp_out["plain"], dp_out["nccl"]
    same_state = all(torch.equal(v, b["state"]["state_dict"][k])
                     for k, v in a["state"]["state_dict"].items())
    print(f"  plain: losses {a['losses']}, mIoU {a['mious']}, launches {a['launches']}",
          flush=True)
    print(f"  rank 0 of 1 ({b['backend']}): losses {b['losses']}, mIoU {b['mious']}, "
          f"launches {b['launches']}; equal bit for bit: losses "
          f"{a['losses'] == b['losses']}, IoUs {a['mious'] == b['mious']}, weights and BN "
          f"statistics after the steps {same_state}; 2 ranks on one card cannot share "
          f"NCCL, so a 2-card run is not made here", flush=True)
    if (b["backend"] != "nccl" or a["losses"] != b["losses"] or a["mious"] != b["mious"]
            or not same_state or a["launches"] != b["launches"] or len(a["losses"]) != 2):
        fail("cli.main under the launcher's environment differs from the plain run")
    later["main_data_parallel"] = {"launches": b["launches"], "losses": b["losses"],
                                   "mious": b["mious"]}
    del dp_out
    torch.cuda.empty_cache()

    # 11e. profiling: trace, annotate and scan_benchmark in a child process
    prof_out = os.path.join(work, "profile_serving.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile-serving",
                           prof_out], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"the profiling child failed: {proc.stderr[-3000:]}")
    with open(prof_out) as f:
        prof = json.load(f)
    print(f"  11e. 3 batch-{N_BATCH} serving forwards ({H_IN}x{W_IN}) in trace/annotate "
          f"(child process, {time.perf_counter() - t0:.1f} s): trace events: ingest "
          f"kernels {prof['ingest_events']}, grouped-conv kernels {prof['gc_events']}, "
          f"'{prof['span']}' spans {prof['span_events']}; launches {prof['launches']}; "
          f"scan_benchmark {prof['scan_ms']:.3f} ms per forward, CUDA events p50 "
          f"{prof['event_ms_p50']:.3f} ms", flush=True)
    if (prof["ingest_events"] < 3 or prof["gc_events"] < 48 or prof["span_events"] < 3
            or prof["launches"] != {"ingest": 3, "grouped_conv3x3": 0,
                                    "grouped_conv3x3_fused": 48, "grouped_conv3x3_dx": 0}
            or not prof["scan_ms"] > 0):
        fail(f"the profiling trace: {prof}")
    later["profile_serving"] = prof
    print(f"  phases 11a-11e: {time.perf_counter() - t_11:.1f} s", flush=True)

    # 12. the capture path (host code): the native library, cli.dump_capture,
    # ThermalDriveDataset and the small CLIs; the counts are read around it
    print("capture path: the native library, cli.dump_capture at the shipped rig's "
          "sizes, ThermalDriveDataset, cli.visualize_data, cli.camera_focus and "
          "cli.plot_heatmap", flush=True)

    later.update(capture_phase(work, zero_counts, q_counts))

    # 13. height-sharded serving: one 640x1920 frame split by rows over 4
    # gloo processes on the card, each ingesting its rows and running the
    # fused grouped conv on halo-extended shards; launches read in each worker
    print(f"spatial path: parallel.spatial.serve_frame, ResNeXt-50 (3,4,6,3) early fusion, "
          f"batch 1 of {SPATIAL_HW[0]}x{SPATIAL_HW[1]} split by rows over {SPATIAL_PROCS} "
          f"gloo processes on one card", flush=True)
    torch.cuda.empty_cache()
    later.update(spatial_phase(work, card, zero_counts, q_counts))

    # 14. the record: each kernel's launches on every path, read around it
    paths = {"serving": launches, "train_plain": train_launches, "train_conf": adv_launches,
             **{name: r["launches"] for name, r in later.items()}}

    def by_path(*names):
        return {path: sum(c.get(n, 0) for n in names) for path, c in paths.items()}

    k_ms, p_ms, b_ms, b_by, k_dev = ingest_ms[(W_IN, 0, W_IN)]
    per_seg = want_step["train_seg"]
    per_critic = want_step["train_critic"]
    sums = [sum(r[1] * r[i] for r in gc_rows) for i in (2, 3, 4)]
    gc_bound, gc_by = bound_ms(sum(r[1] * r[6] for r in gc_rows),
                               sum(r[1] * r[7] for r in gc_rows))
    dx_sums = [sum(r[1] * r[i] for r in dx_rows) for i in (2, 3, 4, 8, 9, 10, 11)]

    def stage_list(rows, cols):
        return [{"stage": r[0], "per_forward": r[1], "bound_ms": r[5],
                 **{k: r[i] for k, i in cols.items()},
                 "share_of_bound": r[5] / r[cols["ms"]]} for r in rows]

    dx_bound, dx_by = bound_ms(sum(r[1] * r[6] for r in dx_rows),
                               sum(r[1] * r[7] for r in dx_rows))
    record = {"kernels": [
        {"name": "ingest", "route": "cuda",
         "source": "heatnet_tpu_torch/csrc/ingest.cu",
         "replaces": "heatnet_tpu/ops/pallas_preproc.py:60 (_ir_kernel), "
                     "heatnet_tpu/ops/pallas_preproc.py:68 (_rgb_kernel)",
         "launches": sum(by_path("ingest").values()),
         "launches_by_path": by_path("ingest"), "max_abs_err": ingest_err,
         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": None, "device_ms": k_dev,
         "device_share_of_bound": b_ms / k_dev,
         "work": f"early-fusion input, bf16, batch {N_BATCH} x {H_IN}x{W_IN}"},
        {"name": "grouped_conv3x3", "route": "cuda",
         "source": "heatnet_tpu_torch/csrc/grouped_conv3x3.cu",
         "replaces": "heatnet_tpu/ops/pallas_grouped_conv.py:141 (_kernel_fused), "
                     "heatnet_tpu/ops/pallas_grouped_conv.py:121 (_kernel)",
         "launches": sum(by_path("grouped_conv3x3", "grouped_conv3x3_fused").values()),
         "launches_by_path": {"forward": by_path("grouped_conv3x3"),
                              "fused": by_path("grouped_conv3x3_fused")},
         "max_abs_err": gc_err,
         "train_conf_launches": {
             "forward": adv_launches["grouped_conv3x3"],
             "fused": adv_launches["grouped_conv3x3_fused"],
             "per_critic_step": {"forward": per_critic["grouped_conv3x3"],
                                 "fused": per_critic["grouped_conv3x3_fused"]},
             "per_seg_step": {"forward": per_seg["grouped_conv3x3"],
                              "fused": per_seg["grouped_conv3x3_fused"]}},
         "ms": sums[0], "plain_ms": sums[1], "bound_ms": gc_bound,
         "bound_by": gc_by, "library_ms": sums[2],
         "stages": stage_list(gc_rows, {"ms": 2, "plain_ms": 3, "library_ms": 4,
                                        "device_ms": 8, "library_device_ms": 9}),
         "work": f"one forward's 16 launches (3/4/6/3 per stage), batch {N_BATCH}, "
                 "fused bn3 + relu"},
        {"name": "grouped_conv3x3_dx", "route": "cuda",
         "source": "heatnet_tpu_torch/csrc/grouped_conv3x3.cu",
         "replaces": "heatnet_tpu/ops/pallas_grouped_conv.py:297 (grouped_conv3x3 "
                     "custom VJP: forward _kernel :121, dx of _bwd :313)",
         "launches": sum(by_path("grouped_conv3x3_dx").values()),
         "launches_by_path": by_path("grouped_conv3x3_dx"), "max_abs_err": dx_err,
         "ms": dx_sums[0], "plain_ms": dx_sums[1], "bound_ms": dx_bound,
         "bound_by": dx_by, "library_ms": dx_sums[2],
         "train_forward_launches": train_launches["grouped_conv3x3"],
         "train_conf_launches": {"dx": adv_launches["grouped_conv3x3_dx"],
                                 "per_critic_step": per_critic["grouped_conv3x3_dx"],
                                 "per_seg_step": per_seg["grouped_conv3x3_dx"]},
         "train_forward_ms": dx_sums[3], "train_forward_library_ms": dx_sums[5],
         "train_forward_plain_ms": dx_sums[6], "dk_library_ms": dx_sums[4],
         "stages": stage_list(dx_rows, {"ms": 2, "plain_ms": 3, "library_ms": 4,
                                        "device_ms": 14, "library_device_ms": 15,
                                        "train_forward_ms": 8,
                                        "train_forward_library_ms": 10,
                                        "train_forward_device_ms": 12,
                                        "train_forward_library_device_ms": 13,
                                        "dk_library_ms": 9}),
         "work": f"one training step's 16 dx launches (3/4/6/3 per stage), batch "
                 f"{N_TRAIN}, {CROP[0]}x{CROP[1]} crop; library: conv2d_input"},
        {"name": "int8_conv", "route": "cuda",
         "source": "heatnet_tpu_torch/csrc/int8_conv.cu",
         "replaces": "not a TPU kernel: XLA's int8 conv_general_dilated in "
                     "heatnet_tpu/models/layers.py:531 (GroupedConvDense's int8 arm) and "
                     "heatnet_tpu/models/layers.py:859 (Int8Conv)",
         "launches": sum(by_path("int8_conv").values()),
         "launches_by_path": by_path("int8_conv"), "max_abs_err": i8_err,
         "ms": i8["ms"], "plain_ms": i8["plain_ms"], "bound_ms": i8_bound,
         "bound_by": i8_by, "library_ms": i8_lib, "device_ms": i8["device_ms"],
         "device_ms_signed_x": i8["device_ms_signed_x"],
         "device_ms_quantize": i8["device_ms_quantize"],
         "device_ms_gemm": i8["device_ms_gemm"], "cudnn_bf16_ms": i8["cudnn_bf16_ms"],
         "forward_device_ms": i8["forward_device_ms"],
         "library_covers_ms": i8_lib_kernel, "library_covers_device_ms": i8_lib_card,
         "stages": i8_rows,
         "work": f"one batch-{N_BATCH} forward's {len(q_layers)} int8 launches, ResNeXt-50 "
                 "early fusion at 320x960; bound at 1979 TOPS int8 (H100 SXM data sheet); "
                 "library: torch._int_mm (cuBLASLt) on the 1x1 layers with 8-multiple "
                 "channels only, beside the kernel's time on the same layers "
                 "(library_covers_ms, _device_ms); cudnn_bf16_ms: cuDNN's bf16 conv of "
                 "each shape, another function's time, a yardstick only"},
    ]}
    record["train_conf"] = {
        "steps": dict(zip(("critic", "seg"), (adv_run.phases.count("train_critic"),
                                              adv_run.phases.count("train_seg")))),
        "critic_step_ms_p50_p95": step_stats["train_critic"],
        "seg_step_ms_p50_p95": step_stats["train_seg"], "peak_memory_gb": adv_peak_gb}
    record.update({name: {k: v for k, v in r.items() if k != "launches"}
                   for name, r in later.items()})
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

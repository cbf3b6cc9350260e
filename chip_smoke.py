#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py


From the repository root on a host with a Hopper card and nvcc. Phases, one
JSON line each; any failure raises (non-zero exit, no result line):

  1. env       torch/CUDA versions and the card (plus nvidia-smi's name and
               power limit on a line of its own); the library calls' f32
               precision pinned to full f32 by the port's own
               utils.misc.set_f32_precision, which build_model applies to
               every model: every f32 limit below holds that setting.
  2. build     nvcc builds the kernels of realpdebench_tpu_torch/csrc (or
               finds them built): one nvcc per source, all at once, at
               niceness 10 in a thread (BackgroundBuild), while the card
               runs phases 13e's CNO steps and rollouts and 13d (which
               launch no kernel of the port's; their lines say
               nvcc_running where they ended during the build); then the
               library is loaded, and the build phase says how long it was
               waited for.
  3. kernel    the forward kernels K1, the T-stage (et, it) and K2 against
               their plain twins on the card at the full rollout width
               (B·Tp=208, Hp=70, Wp=134, C=64, modes 4/12/16), in float32
               and bfloat16; CUDA-event medians of kernel and twin. Every
               variant is held: the T-stage's registers variant (chosen at
               these shapes) and, bit for bit against it, its generic one,
               which is also chosen and checked at a [20, 18] map outside
               the instantiated range; K1's and K2's mma variants
               (bfloat16) and tf32 ones (float32: 3xTF32 on the tensor
               cores) and, named, their fma ones in both dtypes, each also
               against the variant chosen. Two calls of K1, the T-stage and
               K2 are bit-equal.
               K1's, the T-stage's and K2's times are device times of
               queued launches (see queued_ms).
  4. backward  the backward and tail kernels, K2A-lite, K2A, K12B, K3F and
               K3B (K2A-lite's, K12B's, K3F's and K3B's mma variants in
               bfloat16 and tf32 variants in float32 and, named, their fma
               ones, each also against the other; K1's and K2's tf32 and
               fma ones in float32 at this width too), and the
               T-stage adjoints (et_adj, it_adj), against
               their twins at the training width (B·Tp=832: the f32 twins
               fit the card's memory), in float32 and bfloat16; K2A-lite
               against K2A; two K1 (f32), K2A-lite, K12B, K3F and K3B calls
               bit-equal; K1's, K2's, K2A-lite's, K12B's, K3F's and K3B's
               times at this width as device times of queued launches (the
               fma variants of these six beside their chosen ones in both
               dtypes), the others CUDA-event medians.
  4b. geometry every FNO kernel against its twin at the other shipped
               geometries (combustion: width 64, fsi: width 128, modes
               4/16/16) at the cylinder's windows and padding, batch 2, in
               both dtypes (K1, K2, K2A-lite, K12B, K3F and K3B mma in
               bfloat16, tf32 in float32, asserted: every shipped geometry
               takes it), and
               which of K2A-lite and K2A each takes; and the combustion
               surrogate's (width 64, modes 4/16/16) at its own 20x128x128
               windows (Hp = Wp = 134), F = 1, batch 16, in float32 (its
               shipped dtype), each kernel also timed beside its bound.
  5. slice     the cylinder FNO3d at the benchmark configuration (width 64,
               4 layers, bf16 compute, seeded random weights) rolled out 10
               steps at batch 8 through make_rollout_fn; the launch counters
               prove the kernels ran, every K1 and K2 launch the mma variant
               and every T-stage launch the registers one; compared with the
               same rollout through the plain f32 path on the card; rollout
               frames/s; then torch.profiler over PROFILE_STEPS more
               rollouts (slice_profile).
  5a. slice_f32 the same rollout in float32 as the shipped config runs it
               (compute_dtype null): exact launch and variant counts (K1
               and K2 tf32, the T-stage registers), within KERNEL_TOL's
               f32 bound (1e-4, relative L2 and max|Δ|/max|ref|) of the
               plain f32 rollout; frames/s.
  6. train     bench.py's training step (batch 32, Adam at lr 1e-4, cosine
               over 4000 updates, no clipping, Identity normalizer) through
               make_train_step: one counted step (exact launch counts),
               compared with the same step from the same weights through
               the plain f32 path with autograd (loss, every gradient, the
               running statistics); two more forward-backward passes equal
               bit for bit; 2 warm-up steps and 5 windows of 10 steps:
               median steps/s, loss, peak memory.
  7. profile   torch.profiler over PROFILE_STEPS more training steps (as
               every profile phase): device time by kernel, the host's
               wall time, the device's idle share.
  7a. train_f32 phases 6-7 for the same step as the shipped config runs
               it, in float32 (compute_dtype null): K1, K2, K2A-lite,
               K12B, K3F and K3B in their tf32 variants (the T-stage
               registers), the loss, every gradient
               and the running statistics against the plain f32 step within
               F32_LIMITS (1e-5 relative; 1e-4 relative L2); then its
               profile (train_f32_profile).
  7c. surrogate_fno_train_f32, surrogate_fno_rollout_f32  the combustion
               surrogate FNO (configs/combustion/surrogate_model/fno.yaml:
               modes 4/16/16, width 64, 4 layers, 17 → 1 channels) on
               20x128x128 windows in f32 as shipped: its training step at
               batch 16 (Gaussian normalizer; every FNO kernel tf32 but the
               T-stage, the fused tail at F = 1) within F32_LIMITS of the
               plain f32 step, two passes bit-equal, steps/s, then its
               profile; and the generator's prediction over one 40-frame
               trajectory (tools/generate_surrogate_data, windows of 20)
               within 1e-4 of the plain f32 path; exact launch counts.
  7b. fsi_train the fsi FNO (configs/fsi/fno.yaml: width 128, modes 4/16/16,
               batch 32, Gaussian normalizer) trained in float32 (the
               config's dtype; every FNO kernel but the T-stage tf32 at
               width 128 too) and
               bfloat16: one counted step each (exact
               launch and variant counts), the loss and every gradient
               against the plain f32 step at batch 2, two passes bit-equal,
               steps/s and peak memory.
  8. ta        the temporal-attention kernels TA forward and backward
               against their twin at the UNet's level-0 width of the
               training step (B 12, S 64·128, T 20, h 4, d 32), in float32
               and bfloat16 (each kernel's tf32 variant in float32 and mma
               variant in bfloat16 and, named, its fma one, each also
               against the other); two calls of each bit-equal; device
               times of queued launches, and scaled_dot_product_attention
               with the bias as a float mask as the library yardstick; then
               (ta_level) the forward's and the backward's tf32 and mma
               variants at the site counts of every level the UNet step
               launches them at (B 12 × 8192, 2048, 512 and the mid block's
               512): against the twin, bit-equal, queued time and bound;
               and the tf32 variants at the surrogate UNet's levels (B 2 ×
               16384, 4096 and the mid block's 4096 sites); and both
               variants at WDNO's padded coefficient T (geometry wdno_t12:
               B 16 × 2048 and 512 sites at T 12, the cylinder's; wdno_t8:
               B 16 × 2048 at T 8, controlled_cylinder's).
  9. unet_rollout  the cylinder UNet3d (configs/cylinder/unet.yaml: dim_mults
               1/2/4, bf16 compute, seeded random weights) rolled out 5
               steps at eval batch 12 through make_rollout_fn with a
               Gaussian normalizer; exact launch counts (every TA forward
               the mma variant); compared with the plain f32 rollout;
               frames/s and peak memory.
  9a. unet_rollout_f32 the same rollout in float32 as the shipped config
               runs it (compute_dtype null): every TA forward the tf32
               variant, within UNET_F32_ROLLOUT (1e-4 relative L2 and
               max|Δ|/max|ref|) of the plain f32 rollout, two rollouts
               bit-equal under cudnn.deterministic; frames/s, peak memory.
 10. unet_train    its training step at batch 12 (Adam at lr 1e-4, cosine
               over 10000 updates, no clipping; the ResnetBlocks
               rematerialised, remat's default): one counted step (exact
               launch counts; every TA forward and backward the mma
               variant), the loss
               and every gradient against the plain f32 step (at batch 6:
               the plain f32 step keeps every activation, which at 12 does
               not fit the card), two passes bit-equal under
               cudnn.deterministic and equal bit for bit to a pass without
               remat, whose steps/s and peak memory one window records; 2
               warm-up steps and 5 windows of 5 steps; then a profile of 3
               steps.
 10a. unet_train_f32 the same step in float32 as shipped, remat on: every TA
               forward and backward the tf32 variant, the loss within 1e-5
               relative and every gradient within 1e-4 relative L2 of the
               plain f32 step at batch 6, two passes bit-equal; 2 windows
               of 3 steps, peak memory; then its profile (unet_f32_profile).
               Measurement only (cudnn_tf32_on): the same step with
               cuDNN's TF32 switched on around it, one window's steps/s and
               its loss and gradients' distance from the plain f32 step.
 10b. surrogate_unet_train_f32  the combustion surrogate UNet
               (configs/combustion/surrogate_model/unet.yaml: dim_mults
               1/2, dim = H = 128, 17 → 1 channels) trained at batch 2 on
               20x128x128 windows in f32 as shipped, remat on: exact TA
               counts (tf32), the loss and every gradient within 1e-5 /
               1e-4 of the plain f32 step at batch 1, two passes bit-equal,
               steps/s, peak memory.
 10c. wdno_train_f32, wdno_sample_f32, wdno_train, wdno_sample  WDNO as
               configs/cylinder/wdno.yaml ships it (dim 256, dim_mults 1/2,
               bior1.1, sigmoid schedule over 1000 steps, DDIM 10 at eta
               1, clip 1.0, remat on) on the 20x64x128x3 windows (48
               channels on the 12x32x64 coefficient grid), its denoiser in
               f32 as shipped and in bf16: the loss and every gradient
               against the plain f32 step from the same weights and the same
               injected t and noise at batch 4 (f32 1e-5 / 1e-4, bf16 1e-2
               / 1e-1), then one counted step at batch 16 (6 TA forwards
               and 6 backwards, tf32 or mma) and, in f32, a timed window of
               2 steps and peak memory; one counted DDIM sample at batch 16
               (60 TA forwards), timed in frames/s (f32), and a sample at
               batch 2 against the plain f32 sample on the same injected
               draws, both under cudnn.deterministic (WDNO_F32_SAMPLE,
               WDNO_BF16_SAMPLE: the first step multiplies the denoiser's
               rounding by 1825) with its first forward alone at the UNet
               rollout's limits.
 11. gk_scores the Galerkin scores kernel against its twin at the cylinder
               width (B 16, N 20·64·128 = 163840 tokens, h 4, d 64, in the
               q/k/v Dense's [B, N, h·d] layout), in float32 and bfloat16,
               the variant each dtype chooses (mma) and, named, the other,
               each also against the other; two calls of each bit-equal;
               device times of queued launches of both, CUDA-event medians
               of the twin and of the step's forward and backward of the
               scores (the kernel, then autograd through the plain
               recompute).
 12. gk_rollout    the cylinder Galerkin Transformer
               (configs/cylinder/galerkin_transformer.yaml: width 256, 4
               heads, 1 encoder layer, bf16 compute, seeded random weights)
               rolled out 1 step at eval batch 16 through make_rollout_fn
               with a Gaussian normalizer; exact launch counts (the scores
               in their mma variant); compared with the plain f32 rollout;
               frames/s (median of 10) and peak memory.
 13. gk_train      its training step at batch 16 (Adam at lr 0.01, cosine over
               5000 updates, no clipping; dropout from the model's seeded
               generator): one counted step, the loss and every gradient
               against the plain f32 step from the same weights and the same
               dropout masks (both at batch 16: the f32 step fits the card),
               two passes bit-equal; 2 warm-up steps and 5 windows of 3
               steps; then a profile of 3 steps.
 13a. gk_rollout_f32, gk_train_f32  phases 12-13 as the shipped config runs
               them, in float32 (compute_dtype null): the scores in f32 (mma
               variant), exact counts, within 1e-4 (rollout) and F32_LIMITS
               (step, at the largest of batches 16, 12, 8 that fits; a line
               says so where 16 does not) of the plain f32 path; steps/s,
               peak memory, then a profile (gk_f32_profile).
 13b. deeponet_train_f32, deeponet_rollout_f32, deeponet_train,
      deeponet_rollout  configs/cylinder/deeponet.yaml (p 128, dropout 0.1)
               at full width: the training step at batch 32 and the rollout
               at eval batch 64 × 10 steps, in f32 as shipped and in bf16.
               No kernel of the port's runs (every count 0): f32 is held
               against a float64 copy of the same weights (the step's loss,
               every gradient and the BatchNorms' running statistics at
               batch 2 within F32_LIMITS; the rollout in chunks of 8 within
               1e-4 relative L2 and max|Δ|/max|ref|), two f32 passes
               bit-equal under cudnn.deterministic, then a profile
               (deeponet_f32_profile); bf16 against f32 at the bf16 limits
               (the branch's gradients at FAMILY_BF16_PREFIX_LIMITS);
               steps/s, frames/s, peak memory.
 13c. transolver_*  the same for configs/cylinder/transolver.yaml (width
               256, 8 heads, 16 slices, mlp_ratio 4, 1 block): batch 16,
               eval 16 × 3; the f32 step at the shipped batch 16 with
               grad_accum 1 (the one-node LayerNorm of models/base keeps
               x, mean and rstd alone): an out-of-memory error fails the
               run, as it does in every phase.
 13d. dpot_s_train_f32, dpot_s_rollout_f32, dpot_l_train_f32,
      dpot_l_rollout_f32  configs/cylinder/dpot_{s,l}.yaml (embed 1024 /
               1536, depth 6 / 24, 673M parameters for DPOT-L) at full
               width in their shipped f32, the windows resized to 128x128
               and back: the step at batch 16 and the rollout at eval batch
               64 × 1, as 13b holds DeepONet (float64 copy, every kernel
               count 0, profiles dpot_s_f32_profile, dpot_l_f32_profile);
               each step's weights kept as a bare backbone.
 13e. cno_train_f32, cno_rollout_f32, cno_train, cno_rollout, mwt_*
               configs/cylinder/{cno,mwt}.yaml at full width (CNO: 7.93M
               parameters, LeakyReLU, remat on, batch 16; MWT: 5.50M, alpha
               5, 4 CZ cells, batch 32; eval 64 × 3 both), as 13b holds
               DeepONet, with two differences: the f32 step is held to its
               float64 copy on the same activation sides (Kinks: a
               pre-activation within rounding of 0 takes the other slope in
               f32; the copy with its own sides within 2e-2), and CNO's
               repetitions and rollout references are cut (FAMILY_CUTS,
               listed under "reduced"); profiles cno_f32_profile,
               mwt_f32_profile.
 13f. cno_lrelu CNO's filtered activation (activation lrelu, a narrow CNO
               on the cylinder window, batch 2): one forward-backward in
               f32 against float64 on the same sides, every count 0.
 14. loop      python -m realpdebench_tpu_torch train, in this process
               (train.__main__.main, which the CLI's train subcommand
               runs), on a synthetic cylinder tree (data/synthetic: 16 real
               trajectories at 64x128, 4 numerical at 128x256, 300 frames;
               an HDF5 tree where h5py imports, else the same arrays in
               memory through data.fluid.with_arrays): configs/cylinder/
               fno.yaml in bf16 on numerical data, 12 steps at batch 32
               with validation every step (num_update // 50 is 0 below 100
               steps; 54 real windows at test batch 64) and a checkpoint
               at each, the split keys and the
               other cuts as overrides listed under "reduced" beside the
               shipped values. Exact launch counts (12 steps and 12
               validation forwards, every kernel in its mma variant, the
               T-stage registers); loop and StepTimer steps/s beside the
               bare step's; the device's idle share over the traced
               iterations 10-12 and where the host's gaps fall (waiting
               for a batch, validation, checkpoint); the checkpoint
               reloaded in a fresh model predicts bit for bit; the 13
               metrics on the card within 1e-4 of the CPU's on the same
               arrays; then a resume to 13 steps (RESUME_STEPS; starts at
               12, the optimizer's count goes on to 13) and a 2-step finetune on
               real data from the checkpoint, each with exact counts.
 15. eval      python -m realpdebench_tpu_torch eval (eval.__main__.main)
               on that checkpoint, bf16, test batch 64, 10 autoregressive
               steps over the 14 real test windows, probe diagnostic on:
               the 13 metrics, normalized MSE, probe error, frames/s
               including reading, exact launch counts (K1, T-stage, K2);
               held against the same checkpoint rolled out through the
               plain f32 path on the card: predictions within 5e-2
               relative L2, each metric within 5e-2 relative (1e-3
               absolute where the f32 value is below 1e-2; r2 compared
               as its residual share 1 - r2, here and against the CPU).
 16. unet_loop, unet_eval  phases 14 and 15 for configs/cylinder/unet.yaml
               (dim 64, dim_mults 1/2/4, batch 12 and test batch 12 as
               shipped, N_autoregressive 5) in bf16 on the same tree: 12
               steps (validation and a checkpoint every step, as
               num_update // 50 is 0 below 100 steps; iterations 10-12
               traced), a resume to 13, no finetune; exact TA forward and
               backward counts, all mma; reload bit-equal; the card's
               metrics within 1e-4 of the CPU's; loop steps/s beside the
               bare step's (phase 10), idle share, peak memory. Eval over
               the test split's unseen trajectories (test_mode unseen: 8
               windows, 1 batch), against the plain f32 path as in 15.
 17. gk_loop, gk_eval  the same for configs/cylinder/galerkin_transformer.yaml
               (width 256, 4 heads, batch 16, N_autoregressive 1, dropout
               from the run's seeded generator): exact scores counts, mma;
               eval over 14 unseen windows (1 batch).
 17a. deeponet_loop, deeponet_eval, transolver_loop, transolver_eval,
      cno_loop, cno_eval, mwt_loop, mwt_eval  the
               same for configs/cylinder/{deeponet,transolver,cno,mwt}.yaml
               in their shipped f32 (no --compute_dtype), at the shipped
               batches (32, 16, 16 and 32; test batch 64 but Transolver's
               16, N_autoregressive 10, 3, 3 and 3): every kernel count 0;
               eval against the same checkpoint's f32 rollout. CNO's
               loop runs 2 steps (CNO_LOOP_STEPS: a CNO validation of the
               54 windows is ≈ 140 TFLOP in full f32) and a resume to 3:
               no traced iteration, no StepTimer window.
 17b'. wdno_loop, wdno_eval, dmd_eval  configs/cylinder/wdno.yaml in its
               shipped f32 through train on the same tree: 1 step with its
               one validation sweep (54 windows, each a 10-step DDIM
               sample) at test batch 14, the rescaler computed on the card
               from the numerical train split and its cache read back, the
               checkpoint reloaded sampling bit for bit from reseeded
               generators under cudnn.deterministic, the 13 metrics of those samples within 1e-4 of
               the CPU's; eval over the 14 unseen windows at
               N_autoregressive 1: exact counts (60 tf32 TA forwards a
               batch); 4 windows through the kernels and the plain f32
               path from reseeded generators (the loops' eval checks on
               the metrics, the predictions within 1e-4 relative L2, the
               kernels' metrics within 1e-4 of the CPU's); then eval with configs/cylinder/dmd.yaml
               (the host DMD, no checkpoint, the host rollout): every
               kernel count 0, the 13 metrics and the normalized MSE within
               1e-4 of the same eval on the CPU.
Every train and eval run of phases 14-18 starts from PyTorch's default TF32
switches (cudnn's on) and must leave them full f32 (C1).
 17b. dpot_finetune  python -m realpdebench_tpu_torch train --is_finetune
               on real data (configs/cylinder/dpot_s.yaml, f32, 2 steps)
               from the bare DPOT-S backbone of phase 13d (the dpot_model.
               prefix taken off, as a pretrained backbone comes): no
               launch, and every weight within 3·lr a step of the
               backbone's, which a backbone not loaded would miss.
 17c. surrogate_loop  python -m realpdebench_tpu_torch train-surrogate with
               the surrogate FNO's shipped config on an Arrow surrogate
               tree (3 synthetic pairs of 40 frames at 128x128, written by
               tools/convert_hdf5_to_hf.write_surrogate_train: no h5py
               here), 50 iterations: one evaluation, one checkpoint, exact
               counts (tf32), loop steps/s.
 18. arrow     whether this host imports datasets and pyarrow; where it
               does, the tree written as an Arrow V2 tree through the
               converter's writer (tools/convert_hdf5_to_hf.write_dataset_v2
               from the arrays in memory, or convert_dataset_v2 from the
               HDF5 files), 8 windows of each split and type held bit for
               bit against the HDF5 class's (mask_prob 0, noise 0), the
               seconds a window in both backends, and the bf16 FNO
               loop for 4 steps with --use_hf_dataset true (exact counts).
               Where it does not, one line says so.
Each loop phase lists its cuts under "reduced" beside the shipped values:
the tree, n_sim_frame, the split sizes, generated id files, num_update,
max_to_keep, compute_dtype (the dtype the path ran: bfloat16, or null for
f32 as shipped), the eval's test_mode, and N_plot and
N_plot_probe, which are 0 where matplotlib is missing.
`python3 chip_smoke.py --only-loop` runs env, build and phases 14-18 alone
and prints neither the summary nor the result line.
`python3 chip_smoke.py --limit-controls` runs env and limit_controls alone
(no build, no summary, no result line): the readings of FAMILY_FREE_KINKS
and FAMILY_BF16_ZERO_GRAD from CNO's and MWT's sound steps beside those of
controls, the f32 steps with TF32 on and CNO's steps with one BatchNorm's
statistics left out; it fails where the planted fault passes.
Every kernel's time stands beside its bound: the larger of the bytes it
must move (inputs read once, outputs written once) over HBM's 3.35 TB/s and
its operations over the peak of its type (989 TFLOP/s bf16 tensor cores,
495 TFLOP/s TF32 tensor cores for the tf32 variants, 67 TFLOP/s FP32), from
the published H100 SXM figures at 700 W. Then the per-kernel summary line
(launches by path, and by variant for the kernels that have variants; the
f32 route of K1, K2, K2A-lite, K12B, K3F, K3B and the TA forward and backward under
"tf32", K1's and K2's also under "train_width_tf32"), and the last line
{"ok": true, "device": {...}}.

The port imports neither JAX nor the JAX package; neither does this script.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

from unittest import mock

import numpy as np
import torch
from torch.nn.functional import scaled_dot_product_attention

from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer, build_normalizer
from realpdebench_tpu_torch.eval.rollout import make_rollout_fn
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.ops import fno_layer as fl
from realpdebench_tpu_torch.ops import fno_tail as ft
from realpdebench_tpu_torch.ops import galerkin as tga
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops import temporal_attention as tta
from realpdebench_tpu_torch.ops.activations import gelu, gelu_grad
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import (
    make_generator,
    set_f32_precision,
    use_expandable_segments,
)

use_expandable_segments()      # before the first allocation on the card

# the benchmark's rollout (bench.py): eval batch 8, 10 steps, 20x64x128x3
BATCH, STEPS = 8, 10
SHAPE_IN = SHAPE_OUT = (20, 64, 128, 3)
MODEL = dict(model_name="fno", modes1=4, modes2=12, modes3=16, n_layers=4,
             width=64)
PAD = 6
TP, HP, WP = (n + PAD for n in SHAPE_IN[:3])
C, M1, M2, M3 = MODEL["width"], MODEL["modes1"], MODEL["modes2"], MODEL["modes3"]
# the benchmark's training step (bench.py): batch 32, Adam, cosine schedule
TRAIN_BATCH = 32
TRAIN_CFG = dict(lr=1e-4, scheduler="cosine", num_update=4000, clip_grad_norm=0.0)
WARMUP, WINDOWS, WINDOW_STEPS = 2, 5, 10
PROFILE_STEPS = 1    # steps (or rollouts) a profile phase traces (the run's time limit)

# kernel vs twin, as max|Δ| / max|ref|. f32: both sides accumulate in f32 in
# another order. bf16: both compute in f32 from the same bf16 inputs and
# round once, so they differ by at most one bf16 step (2^-8 relative).
# Statistics (f32 on both sides, from the unrounded s): relative to the sum
# of |terms| per channel, for f32 partial sums over ~2M positions.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
STATS_TOL = 1e-4
# bf16 kernel rollout vs f32 plain rollout over 10 autoregressive steps:
# relative L2 error of the whole prediction, and max|Δ| / max|ref|.
ROLLOUT_REL_L2 = 5e-2
ROLLOUT_MAX = 1e-1
# bf16 kernel training step vs the f32 plain step from the same weights over
# 4 layers (fixed before the first run): the loss relative to the plain
# loss; each gradient and each running-statistics vector as relative L2.
# The conv biases' true gradient is 0 (the BatchNorm after each layer
# cancels them): both sides' largest |gradient| is held to 1e-2 of the
# largest gradient of the same layer's pointwise weight.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_STATS_REL_L2 = 2e-2
TRAIN_ZERO_GRAD = 1e-2
# the shipped cylinder FNO step in float32 (compute_dtype null): the f32
# variants against the plain f32 step from the same weights, both in f32
# (fixed before the first run, from the fsi f32 step's measured 6e-8 loss,
# 6e-6 gradient and 1e-7 statistics distances, PERF.md): the loss within 1e-5
# relative, each gradient and statistics vector within 1e-4 relative L2
F32_LIMITS = (1e-5, 1e-4, 1e-4)
# per training step: 4 layers forward (K1, 2 T-stages, K2) and backward
# (K2A-lite, 2 T-stage adjoints, K12B), one fused tail + loss
TRAIN_LAUNCHES = {"k1": 4, "t_stage": 16, "k2": 4, "k2a": 0, "k2a_lite": 4,
                  "k12b": 4, "k3f": 1, "k3b": 1, "ta_fwd": 0, "ta_bwd": 0,
                  "gk_scores": 0}

# the other shipped FNO geometries: (name, width, modes, window (T, H, W),
# output channels F, batch, dtypes, timed). combustion's and fsi's widths
# and modes at the cylinder's 20x64x128 windows and padding 6 (the kernels'
# limits depend on C and the modes), both dtypes, batch 2; and the
# combustion surrogate's (configs/combustion/surrogate_model/fno.yaml) at
# its own 20x128x128 windows (Hp = Wp = 134), F = 1, at its training batch
# 16 in its shipped f32, each kernel timed beside its bound
GEO_BATCH = 2
SURROGATE_WINDOW = (20, 128, 128)
GEOMETRIES = (("combustion", 64, (4, 16, 16), SHAPE_IN[:3], SHAPE_OUT[-1], GEO_BATCH,
               (torch.float32, torch.bfloat16), False),
              ("fsi", 128, (4, 16, 16), SHAPE_IN[:3], SHAPE_OUT[-1], GEO_BATCH,
               (torch.float32, torch.bfloat16), False),
              ("surrogate", 64, (4, 16, 16), SURROGATE_WINDOW, 1, 16, (torch.float32,), True))
# the fsi FNO (configs/fsi/fno.yaml: width 128, modes 4/16/16, 4 layers,
# batch 32, lr 0.01 over 5000 updates, Gaussian normalizer; compute_dtype
# null, which the port takes as float32), trained in float32 and bfloat16;
# its loss and gradients against the plain f32 step at batch 2, where the
# plain step's autograd temporaries fit the card
FSI_MODEL = dict(model_name="fno", modes1=4, modes2=16, modes3=16, n_layers=4, width=128)
FSI_BATCH, FSI_CMP_BATCH = 32, 2
FSI_TRAIN_CFG = dict(lr=0.01, scheduler="cosine", num_update=5000, clip_grad_norm=0.0)
FSI_WINDOWS, FSI_WINDOW_STEPS = 1, 2   # one window: the whole run's time limit
# per-variant launches of each path that launches variants, for the
# summary line (the other paths launch none)
VARIANTS_BY_PATH = {}
# the bare training steps' steps/s by phase (train, unet_train, gk_train),
# beside the loops'
BARE_STEPS_PER_S = {}

# temporal attention at the UNet's level 0 in the training step (B, S, T, h, d)
TA_SHAPE = (12, 64 * 128, 20, 4, 32)
# the sites of the UNet step's 8 TA backward calls a sample (dim_mults 1/2/4 on
# 64x128 frames): level 0 (init, down 0, up 0), level 1 (down 1, up 1),
# level 2 (down 2, up 2) and the mid block
TA_LEVELS = (("level0", 64 * 128), ("level1", 32 * 64), ("level2", 16 * 32), ("mid", 16 * 32))
# TA backward's d(pos_bias), an f32 sum over all B·S sites, against the
# twin's, relative to the sum over sites of P·(|dP| + |Σ P·dP|), the size
# of what each site adds (both sides accumulate in f32 in another order)
TA_DPB_TOL = 1e-6

# the cylinder UNet3d (configs/cylinder/unet.yaml): windows of 20x64x128x3
# in and out, dim = H = 64, eval and train batch 12, 5 rollout steps
UNET_SHAPE = (20, 64, 128, 3)
UNET_MODEL = dict(model_name="unet", dim_mults=[1, 2, 4])
UNET_BATCH, UNET_STEPS = 12, 5
UNET_CMP_BATCH = 6      # the training step's comparison with the f32 plain step
UNET_TRAIN_CFG = dict(lr=1e-4, scheduler="cosine", num_update=10000,
                      clip_grad_norm=0.0)
UNET_WINDOW_STEPS = 5
# the bf16 step's timing windows and the rollout's timed repeats, cut to
# the whole run's time limit
UNET_WINDOWS, UNET_ROLLOUTS = 1, 1
# temporal attentions per forward at dim_mults (1, 2, 4): init, 3 down, mid, 3 up
UNET_TA_PER_FORWARD = 8
# bf16 kernels vs the f32 plain path (TF32 off), fixed before the first
# run: the rollout over 5 steps as for FNO; one training step's loss within
# 1e-2 relative and every gradient within 1e-1 relative L2, looser than
# FNO's 5e-2 because some 30 convolutions each round to bf16 on the way
UNET_ROLLOUT_REL_L2, UNET_ROLLOUT_MAX = 5e-2, 1e-1
UNET_LOSS_REL, UNET_GRAD_REL_L2 = 1e-2, 1e-1
# the shipped f32 UNet (compute_dtype null) on the TA kernels' tf32 variants
# vs the plain f32 path (TF32 off), fixed before the first run: the rollout
# within 1e-4 relative L2 and 1e-4 max|Δ|/max|ref|; one training step's loss
# within 1e-5 relative and every gradient within 1e-4 relative L2 (at
# UNET_CMP_BATCH). Its step is timed over 2 windows of 3 steps.
UNET_F32_ROLLOUT = (1e-4, 1e-4)
UNET_F32_LOSS_REL, UNET_F32_GRAD_REL_L2 = 1e-5, 1e-4
UNET_F32_BATCH = UNET_BATCH
UNET_F32_WINDOWS = (1, 3)       # one window: the whole run's time limit

# the cylinder Galerkin Transformer (configs/cylinder/galerkin_transformer.yaml
# with the JAX registry's key mapping): windows of 20x64x128x3 in and out,
# N = 163840 tokens a sample, train and eval batch 16, 1 rollout step
GK_SHAPE = (20, 64, 128, 3)
GK_MODEL = dict(model_name="galerkin_transformer", n_hidden=256, num_encoder_layers=1,
                n_head=4, dim_feedforward=256, attention_type="galerkin",
                layer_norm=False, attn_norm=True, norm_eps=1e-7, fourier_modes_x=16,
                fourier_modes_y=20, fourier_modes_t=4, num_regressor_layers=1,
                freq_dim=128, encoder_dropout=0.05, xavier_init=0.01,
                diagonal_weight=0.01, seed=0)
GK_BATCH, GK_STEPS, GK_ROLLOUTS = 16, 1, 4      # rollouts timed: the run's time limit
GK_TRAIN_CFG = dict(lr=0.01, scheduler="cosine", num_update=5000, clip_grad_norm=0.0)
GK_WINDOW_STEPS = 3
GK_WINDOWS = 1       # timing windows: the whole run's time limit
GK_DROPOUT_SEED = 11
# the scores kernel at the encoder's width: (B, N, h, d)
GK_SCORES_SHAPE = (GK_BATCH, GK_SHAPE[0] * GK_SHAPE[1] * GK_SHAPE[2], GK_MODEL["n_head"],
                   GK_MODEL["n_hidden"] // GK_MODEL["n_head"])
# the scores against their twin, as max|Δ| / max|ref| in both dtypes: the
# output is f32 and both sides compute it in f32 from the same inputs, so
# bf16 inputs earn no looser limit (KERNEL_TOL's bf16 entry is for kernels
# that round their output to bf16)
GK_SCORES_TOL = 1e-4
# bf16 kernels vs the f32 plain path (TF32 off), fixed before the first run:
# the 1-step rollout as for FNO; the step's loss within 1e-2 relative and
# every gradient within 5e-2 relative L2. The regressor's conv bias (the
# BatchNorm after it cancels it) and the imaginary part of the DC spectral
# weight (the inverse rfft drops it) have a true gradient of 0: held as
# TRAIN_ZERO_GRAD holds FNO's conv biases, to 1e-2 of the largest gradient
# of the conv weight, and of the spectral weight.
GK_ROLLOUT_REL_L2, GK_ROLLOUT_MAX = 5e-2, 1e-1
GK_LOSS_REL, GK_GRAD_REL_L2 = 1e-2, 5e-2

# DeepONet and Transolver (configs/cylinder/{deeponet,transolver}.yaml as
# shipped: full width, the shipped train and eval batches and
# N_autoregressive, compute_dtype null) on 20x64x128x3 windows, with no
# kernel of the port's: their products are cuBLAS and cuDNN calls, as in
# the JAX package they are XLA's. f32 is held against a float64 copy of
# the same weights (the step at FAMILY_CMP_BATCH, the rollout in chunks of
# FAMILY_CHUNK windows) within F32_LIMITS and FAMILY_F32_ROLLOUT, fixed
# before the first run from PERF.md's f32 limits; bf16 against f32 within
# the bf16 limits of the FNO's step and rollout. Steps timed in windows.
FAMILIES = ("deeponet", "transolver", "cno", "mwt")
FAMILY_SHAPE = (20, 64, 128, 3)
FAMILY_CMP_BATCH, FAMILY_CHUNK = 2, 8
FAMILY_DROPOUT_SEED = 12
FAMILY_WINDOWS = (1, 3)          # (windows, steps a window)
FAMILY_ROLLOUTS = 1  # rollouts timed (the whole run's time limit)
FAMILY_F32_ROLLOUT = (1e-4, 1e-4)
FAMILY_BF16_LOSS_REL, FAMILY_BF16_GRAD_REL_L2 = TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2
# DeepONet's branch in bf16 (fixed before the first chip run): a bf16
# conv's rounding flips the sign of pre-activations near 0 at its ReLUs and
# moves the BatchNorms' statistics, so the branch's gradients are far from
# the f32 step's: the JAX package's own bf16 step is 0.19-0.30 relative L2
# off its f32 step there (CPU, 8x32x32 windows, p 8 and 128), the port's
# 0.10-0.26 at the same size; held to 5e-1. The layers after the branch
# keep FAMILY_BF16_GRAD_REL_L2.
# CNO in bf16 (fixed before its first chip run), for the same reason: its
# 22 BatchNormed k3 convolutions and LeakyReLUs take bf16 roundings that move
# the statistics and the kinks; the JAX package's own bf16 step is a median
# 0.06-0.08 and at worst 0.2-0.9 relative L2 off its f32 step (CPU, 4x32x32
# windows, 3 levels, channel_multiplier 8 and 16), the port's a median 0.05
# and at worst 0.19: every CNO gradient held to 5e-1. MWT in bf16 (fixed
# before its first chip run): its wavelet matmuls round the coefficients to
# bf16 at every level of every cell (the details are differences of
# neighbours), and the Fourier kernel's products run in bf16; the port's
# bf16 step is a median 0.007-0.011 and at worst 0.10-0.20 relative L2 off
# its f32 step (CPU, 4x16x32 to 4x64x128 windows, c 2 and 4, alpha 3 and 5;
# the JAX package's bf16 MWT does not run on the CPU): the cells' gradients
# held to 3e-1, Lk's and Lc's to the common limit.
FAMILY_BF16_PREFIX_LIMITS = {"deeponet": {"branch.": 5e-1}, "cno": {"": 5e-1},
                             "mwt": {"MWT_CZ.": 3e-1}}
# CNO's conv biases before a BatchNorm in bf16 (set after the first card
# run showed 2.9e-2 of their conv weight's largest gradient, over
# TRAIN_ZERO_GRAD): bf16 rounds each conv's output, bias included, before
# the statistics, so their gradient is bf16 noise, not 0; the JAX package's
# own bf16 CNO puts them at up to 0.51 (median 0.05) of that scale (CPU,
# 4x32x32 windows, channel_multiplier 16), the port at 7e-3 there: 1e-1.
# On an H100 a CNO bf16 step with one BatchNorm left out reads 0.475
# (--limit-controls)
FAMILY_BF16_ZERO_GRAD = {"cno": 1e-1}
# CNO and MWT (configs/cylinder/{cno,mwt}.yaml as shipped: CNO 7.93M
# parameters, channel_multiplier 32, 3 levels, a ResidualBlock a level and 6
# at the neck (the YAML's "N_res_neck: 8," falls back to 6), LeakyReLU,
# `remat` on, batch 16, eval 64 × 3; MWT 5.50M parameters, c 4, k 3, alpha
# 5, 4 CZ cells, batch 32, eval 64 × 3) go through the phases of DeepONet
# and Transolver at the same limits. Their products are cuDNN's and
# cuBLAS's, their FFTs cuFFT's: no kernel of the port's. A CNO forward is
# ≈ 2.6 TFLOP a 20x64x128 window in full f32 (C1): its float64 references
# and its repetitions are cut to the run's time limit (FAMILY_CUTS, each
# cut listed in the phase's reduced; shapes and batches as shipped): one
# timed step and no further warm-up (the counted step and the comparisons
# warm it), the bit-equal repeat at the comparison batch (the pass that
# records the activation sides against the plain one, under
# cudnn.deterministic) instead of the step's, the rollout timed by its
# counted run alone, the rollout's references (float64 for f32, f32 for
# bf16) on its first ref_windows windows.
FAMILY_CUTS = {"cno": dict(windows=(1, 1), warmup=0, repeat_batch=False, rollouts=0,
                           ref_windows=4)}
# CNO's filtered activation on the card (the lrelu mode; no shipped config
# runs it): a narrow CNO (3 levels, channel_multiplier 8, 2 neck blocks,
# latent 16) on the cylinder window at batch 2, one forward-backward in f32
# against a float64 copy within F32_LIMITS
CNO_LRELU_MODEL = dict(model_name="cno", N_layers=3, N_res=1, N_res_neck=2,
                       channel_multiplier=8, latent_lift_proj_dim=16, activation="lrelu")
CNO_LRELU_BATCH = 2
# CNO's and MWT's f32 steps against a float64 copy that takes its own
# activation sides (see Kinks): the gradients within 2e-2 relative L2, four
# times CNO's 4.8e-3 of the first card run (set after it); F32_LIMITS
# hold on the same sides. On an H100 the f32 steps with TF32 on read
# 8.2e-2 (CNO) and 4.8e-2 (MWT), CNO's with one BatchNorm left out 1.27
# (--limit-controls)
FAMILY_FREE_KINKS = 2e-2
# DPOT-S and DPOT-L (configs/cylinder/dpot_{s,l}.yaml as shipped: embed 1024
# and 1536, depth 6 and 24, f32) on the same windows, resized to their
# 128x128 and back, in f32 only (their shipped dtype), held against a
# float64 copy as DeepONet and Transolver are: cuBLAS products and cuFFT
# transforms, no kernel of the port's. Each step's weights are also saved
# as a bare backbone (the dpot_model. prefix taken off), which the
# dpot_finetune phase loads as a pretrained backbone comes.
DPOT_FAMILIES = ("dpot_s", "dpot_l")
# the kernel-free phases that run while nvcc builds the kernels (phase 2,
# BackgroundBuild): the families whose steps the card's arithmetic bounds
# (CNO's cuDNN convolutions, DPOT's cuBLAS products), so that sharing the
# host's cores with the compiler moves them least; nvcc at niceness 10
BUILD_OVERLAP, BUILD_NICE = ("cno", *DPOT_FAMILIES), 10
BACKBONES = {}
DPOT_FINETUNE_STEPS = 2

# the combustion surrogate (configs/combustion/surrogate_model/{fno,unet}.yaml
# in their shipped f32): 17 channels in (the 15 numerical fields and the two
# parameter planes), 1 out, on SURROGATE_WINDOW (the combustion frames
# without subsampling). The FNO step at its batch 16 and the UNet step at
# its batch 2 (held against the plain f32 step at SURROGATE_UNET_CMP_BATCH);
# the generator's prediction over one SURROGATE_FRAMES-frame trajectory in
# windows of 20 frames; the train-surrogate CLI on an Arrow tree of
# SURROGATE_SIMS synthetic pairs for SURROGATE_LOOP_STEPS iterations (one
# evaluation, one checkpoint)
SURROGATE_IN, SURROGATE_OUT = (*SURROGATE_WINDOW, 17), (*SURROGATE_WINDOW, 1)
SURROGATE_FRAMES = 40
SURROGATE_UNET_CMP_BATCH = 1
SURROGATE_FNO_WINDOWS, SURROGATE_UNET_WINDOWS = (3, 5), (1, 2)
SURROGATE_SIMS, SURROGATE_LOOP_STEPS = 3, 50
# the TA sites of the surrogate UNet's levels (dim_mults 1/2 on 128x128
# frames): level 0 (init, down 0, up 1), level 1 (down 1, up 0) and the mid
# block, at its batch 2
SURROGATE_TA_LEVELS = (("level0", 128 * 128), ("level1", 64 * 64), ("mid", 64 * 64))

# WDNO as shipped (configs/cylinder/wdno.yaml: dim 256, dim_mults 1/2,
# bior1.1, the sigmoid schedule over 1000 steps, DDIM 10 steps at eta 1,
# batch 16, lr 5e-5, clip 1.0, f32, remat on) on the 20x64x128x3 windows:
# the window pair becomes 48 channels (8 subbands x 6) on the padded
# coefficient grid 12x32x64, where the denoiser's temporal attention runs at
# T 12 over 2048 sites (level 0) and 512 (level 1 and mid); 6 TA calls a
# forward (init, 2 down, mid, 2 up), 10 forwards a sample
WDNO_CONFIG = "cylinder/wdno.yaml"
WDNO_SHAPE = (20, 64, 128, 3)
WDNO_BATCH = 16
WDNO_TA_PER_FORWARD, WDNO_SAMPLE_STEPS = 6, 10
WDNO_CMP_BATCH = 4          # the step's comparison: the plain f32 step keeps every activation
WDNO_SAMPLE_CMP_BATCH = 2   # the samples' comparison
WDNO_WINDOW_STEPS = 2       # one timed window (the whole run's time limit)
# limits fixed before the first run. A step: the UNet's (f32 1e-5 / 1e-4;
# bf16 1e-2 / 1e-1). A sample against the plain f32 sample on the same
# draws: the first DDIM step multiplies the denoiser's rounding by
# sqrt(1/abar - 1) = 1825 (t 999) before the clip to +-1; on the CPU
# (tools/torch_wdno_precision.py, dims 64 and 256) an f32 sample sits
# 6.0e-6-1.6e-5 (relative L2) and 1.9e-5-1.30e-4 (max|d|/max|ref|) from its
# float64 replay, the first forward alone 1.7-2.5e-6; two f32 paths may sit
# twice that apart: relative L2 1e-4, max|d|/max|ref| 5e-4, the first
# forward at UNET_F32_ROLLOUT. bf16 against f32 there: 2.35-2.55e-2
# relative L2, 0.085-0.140 max: 5e-2, 3e-1
WDNO_F32_SAMPLE = (1e-4, 5e-4)
WDNO_BF16_SAMPLE = (5e-2, 3e-1)
# the TA kernels at WDNO's T (ta_level, geometry wdno): cylinder's T 12 at
# both site counts, and controlled_cylinder's 5 coefficient frames padded to
# T 8 (dim_mults 1/2/4) at its level 0, batch 16
WDNO_TA_LEVELS = (("level0", 32 * 64), ("level1", 16 * 32))
WDNO_T8_LEVELS = (("level0", 32 * 64),)

# published H100 SXM peaks (dense, 700 W): HBM, and the operations of a
# bf16 row on the tensor cores, of an f32 row on the FP32 pipes, and of the
# tf32 variants' f32 rows on the tensor cores ("tf32"): their products
# counted once, as a bf16 row's are, not three times for the 3xTF32 passes
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}

_PALLAS = "realpdebench_tpu/ops/pallas/"
SOURCES = {
    "k1": ("fno_k1.cu", "fno_layer.py:331"),
    "t_stage": ("fno_tstage.cu", "fno_layer.py:1161"),
    "k2": ("fno_k2.cu", "fno_layer.py:393"),
    "k2a_lite": ("fno_k2a.cu", "fno_layer.py:504"),
    "k2a": ("fno_k2a.cu", "fno_layer.py:487"),
    "k12b": ("fno_k12b.cu", "fno_layer.py:618"),
    "k3f": ("fno_tail.cu", "fno_tail.py:73"),
    "k3b": ("fno_tail.cu", "fno_tail.py:102"),
    "ta_fwd": ("temporal_attention.cu", "temporal_attention.py:69"),
    "ta_bwd": ("temporal_attention.cu", "temporal_attention.py:84"),
    "gk_scores": ("galerkin_scores.cu", "galerkin.py:43"),
}
SOURCES = {k: ("realpdebench_tpu_torch/csrc/" + s, _PALLAS + r)
           for k, (s, r) in SOURCES.items()}


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started, and whether nvcc was still building the kernels when it
    ended (BackgroundBuild)."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=time.perf_counter() - START)
        if BackgroundBuild.running():
            obj["nvcc_running"] = True
    print(json.dumps(obj), flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float, dtype, variant: str = "") -> dict:
    """The least time the card could take to move ``n_bytes`` and do
    ``ops`` operations in ``dtype`` (on the tensor cores' tf32 peak for the
    ``tf32`` variant), and which of the two sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["tf32" if variant == "tf32" else dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=ops)


def add_bounds(*bs: dict) -> dict:
    n, ops = sum(b["bytes"] for b in bs), sum(b["ops"] for b in bs)
    return dict(bound_ms=sum(b["bound_ms"] for b in bs),
                bound_by="bytes" if all(b["bound_by"] == "bytes" for b in bs)
                else "operations", bytes=n, ops=ops)


def dft_ops(BT: int, Cg: int = C, Hp: int = HP, Wp: int = WP, m2: int = M2,
            m3: int = M3) -> int:
    """The truncated (W, H) DFT of K1, its inverse in K2, and their adjoints
    in K2A and K12B, per call: a real W contraction (Hp·Wp·m3 positions, 2
    real multiply-adds each) and a complex H one (Hp·m3·2m2, 4 each), per
    (image, channel)."""
    return BT * Cg * (Hp * Wp * m3 * 4 + Hp * m3 * 2 * m2 * 8)


def tstage_work(inp, kind: str, dtype) -> tuple:
    """(bound, library call) of the T-stage ``kind`` on ``inp``: a complex
    [Tout, Tin] map along T over Y·C complex columns; the library call is
    one complex64 matmul on the same values (no complex bf16 product
    exists), prepared outside the timing."""
    mr, mi = fl._tmats_on(inp.device, kind, TP, M1)
    Tin, Tout = mr.shape
    B, Y, C2 = inp.shape[0] // Tin, inp.shape[1], inp.shape[2]
    work = bound(nbytes(inp) * (1 + Tout / Tin), 8 * B * Y * (C2 // 2) * Tin * Tout,
                 dtype)
    yv = inp.float().view(B, Tin, Y, 2, C2 // 2)
    yc = torch.complex(yv[..., 0, :], yv[..., 1, :]).reshape(B, Tin, -1)
    mc = torch.complex(mr, mi).t().contiguous()
    return work, lambda: torch.matmul(mc, yc)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` launches of ``fn`` timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def queued_ms(fns, n: int = 24, reps: int = 7) -> float:
    """Device time per call, for kernels short enough that a wrapper's host
    time before the launch (some 0.05-0.1 ms of checks and allocations, which
    cuda_ms's events include) shows: the card is put to sleep while the host
    queues ``n`` calls, taken in turn from ``fns`` (the same call on different
    inputs, together larger than the 50 MB L2, where the inputs are small), so
    the events bracket kernels that run back to back. Median over ``reps``."""
    for fn in fns:
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(n):
            fns[i % len(fns)]()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def tstage_times(dev, gen, kind: str, B: int, dtype) -> tuple:
    """((kernel, twin) ms, library ms, the single-launch CUDA-event ms of the
    kernel, bound) of the T-stage ``kind`` at batch ``B``, as device times of
    queued launches over four input sets."""
    mr, mi = fl._tmats_on(dev, kind, TP, M1)
    ys = [torch.randn(B * mr.shape[0], 2 * M2 * M3, 2 * C, generator=gen,
                      device=dev).to(dtype) for _ in range(4)]
    calls = [tstage_work(y, kind, dtype) for y in ys]
    times = (queued_ms([lambda y=y: fl.t_stage(y, kind, TP, M1) for y in ys]),
             queued_ms([lambda y=y: fl.t_stage_plain(y, mr, mi) for y in ys], n=8, reps=3))
    library = queued_ms([c for _, c in calls])
    single = cuda_ms(lambda: fl.t_stage(ys[0], kind, TP, M1))
    return times, library, single, calls[0][0]


def expect_variants(path: str, **want) -> dict:
    """The per-variant launch counts since the last reset, checked against
    ``want`` (kernel → {variant: count}; kernels not named: no launch)."""
    got = {k: dict(v) for k, v in kernels.VARIANTS.items()}
    full = {k: dict.fromkeys(v, 0) for k, v in kernels.VARIANTS.items()}
    for k, v in want.items():
        full[k].update(v)
    if got != full:
        raise AssertionError(f"{path} launched the variants {got}, expected {full}")
    return got


def run_as(kernel: str, variant: str, fn):
    """``fn()``, which must launch ``kernel`` once, as ``variant``."""
    before = dict(kernels.VARIANTS[kernel])
    out = fn()
    delta = {k: n - before[k] for k, n in kernels.VARIANTS[kernel].items()}
    if delta != {**dict.fromkeys(delta, 0), variant: 1}:
        raise AssertionError(f"{kernel}: expected one launch of the {variant} variant, "
                             f"counted {delta}")
    return out


def compare(name, got, ref, tol) -> dict:
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / scale
    row = dict(name=name, max_abs_err=err, limit_abs=tol * scale,
               max_rel_err=rel, limit_rel=tol)
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its twin: {row}")
    return row


def compare_sums(name, got, ref, terms, tol=STATS_TOL) -> dict:
    """An f32 accumulator against its twin, relative to the sum of the
    |terms| it adds (elementwise), within ``tol``."""
    diff = (got.float() - ref.float()).abs()
    rel = (diff / terms.clamp_min(1e-30)).max().item()
    row = dict(name=name, max_abs_err=diff.max().item(),
               max_rel_to_terms=rel, limit_rel=tol)
    if not rel <= tol:
        raise AssertionError(f"{name}: accumulator disagrees with its twin: {row}")
    return row


def tf32_entry(k: str, rows: list, times: dict, work: dict, single: dict) -> dict:
    """Kernel ``k``'s f32 route for the summary line: the tf32 variant's
    worst errors over ``rows`` (its checks against the twin), its queued and
    twin ms, the named fma variant's ms, and both bounds."""
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                max_rel_err=max(r.get("max_rel_err", r.get("max_rel_to_terms")) for r in rows),
                ms=times[k][0], plain_ms=times[k][1], fma_variant_ms=times[f"{k}_fma"][0],
                single_launch_ms=single.get(k), bound_ms=work[k]["bound_ms"],
                bound_by=work[k]["bound_by"], fma_bound_ms=work[f"{k}_fma"]["bound_ms"])


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0], device=name,
              device_count=torch.cuda.device_count(),
              capability=list(torch.cuda.get_device_capability(0)),
              nvidia_smi=smi))
    print(smi, flush=True)
    # the plain twins are the reference: full f32 library calls, no TF32, as
    # the port sets them for every model it builds
    set_f32_precision()
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path, compile_s = kernels.build()
    kernels.library()
    emit(dict(phase="build", library=path.name, compile_s=compile_s,
              total_s=time.perf_counter() - t0))


class BackgroundBuild:
    """The build phase with its nvcc runs (kernels.build) in a thread, at
    niceness BUILD_NICE, while the main thread drives phases that launch no
    kernel of the port's (BUILD_OVERLAP); ``finish()`` waits for it, loads
    the library and emits the build phase, with the seconds it was waited
    for. A failed build raises there. The phases that end while nvcc runs
    say so (nvcc_running): their host shares its cores with the compiler."""

    _thread = None

    def __init__(self):
        self.t0 = time.perf_counter()
        self.result, self.error = None, None
        BackgroundBuild._thread = threading.Thread(target=self._run, name="nvcc")
        BackgroundBuild._thread.start()

    def _run(self):
        try:
            self.result = kernels.build(nice=BUILD_NICE)
        except BaseException as e:          # raised again in finish()
            self.error = e

    @staticmethod
    def running() -> bool:
        return BackgroundBuild._thread is not None and BackgroundBuild._thread.is_alive()

    def finish(self, overlapped: list) -> None:
        t0 = time.perf_counter()
        BackgroundBuild._thread.join()
        waited = time.perf_counter() - t0
        if self.error is not None:
            raise self.error
        path, compile_s = self.result
        kernels.library()
        emit(dict(phase="build", library=path.name, compile_s=compile_s,
                  total_s=time.perf_counter() - self.t0, waited_s=waited, nice=BUILD_NICE,
                  overlapped_with=overlapped))


def check_tstage_generic(dev, gen, dtype, y, tol) -> list:
    """The T-stage's generic variant: chosen for a [20, 18] map (the shorter
    side above the instantiated register counts) and held against the twin;
    named at the main path's 'et' shape and held bit for bit against the
    registers variant."""
    mr, mi = (torch.randn(20, 18, generator=gen, device=dev) / 20 for _ in range(2))
    inp = y[: 2 * 20].contiguous()
    if kernels.t_stage_variant(dtype, C, 20, 18) != "generic":
        raise AssertionError("a [20, 18] T map did not choose the generic variant")
    rows = [compare("t_stage/generic/20x18",
                    run_as("t_stage", "generic", lambda: kernels.t_stage(inp, mr, mi)),
                    fl.t_stage_plain(inp, mr, mi), tol)]
    mats = fl._tmats_on(dev, "et", TP, M1)
    named = run_as("t_stage", "generic", lambda: kernels.t_stage(y, *mats, variant="generic"))
    if not torch.equal(named, kernels.t_stage(y, *mats)):
        raise AssertionError("the T-stage's variants differ at the main path's shape")
    return rows


def phase_kernels(dev) -> dict:
    """Each kernel against its twin at the rollout width; returns per-kernel
    summaries (bf16 errors and times: the dtype of the main path)."""
    B = BATCH
    BT = B * TP
    summary = {k: dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0)
               for k in ("k1", "t_stage", "k2")}
    cst = fl._ct_on(dev, HP, WP, M2, M3)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(1)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        x = rn(BT, HP * WP // 2, 2 * C).to(dtype)
        a, b = 1 + 0.1 * rn(C), 0.1 * rn(C)
        wp, bp = rn(C, C) / C ** 0.5, 0.1 * rn(C)
        tol = KERNEL_TOL[dtype]
        rows, times = [], {}
        tc = "mma" if dtype == torch.bfloat16 else "tf32"   # K1's and K2's choice
        for act in ("none", "exact"):
            k1 = lambda **kw: fl.k1(x, a, b, Hp=HP, Wp=WP, m2=M2, m3=M3, act=act, **kw)
            k1p = lambda: fl.k1_plain(x, a, b, cst, Hp=HP, Wp=WP, act=act)
            y, y_ref = run_as("k1", tc, k1), k1p()
            rows.append(compare(f"k1/{act}", y, y_ref, tol))
            # the fma variant, named, on the same inputs: against the twin and
            # against the variant chosen
            y_fma = run_as("k1", "fma", lambda: k1(variant="fma"))
            rows += [compare(f"k1_fma/{act}", y_fma, y_ref, tol),
                     compare(f"k1_fma/vs_{tc}/{act}", y_fma, y, tol)]
            del y_fma
            if not torch.equal(y, k1()):
                raise AssertionError(f"two identical k1 calls differ ({dtype})")
            del y_ref
            mats = {k: fl._tmats_on(dev, k, TP, M1) for k in ("et", "it")}
            ins = {"et": y, "it": y[: B * 2 * M1].contiguous()}
            for kind in ("et", "it"):
                got = run_as("t_stage", "registers",
                             lambda: fl.t_stage(ins[kind], kind, TP, M1))
                rows.append(compare(f"t_stage/{kind}/{act}", got,
                                    fl.t_stage_plain(ins[kind], *mats[kind]), tol))
                if not torch.equal(got, fl.t_stage(ins[kind], kind, TP, M1)):
                    raise AssertionError(f"two identical t_stage calls differ ({dtype})")
            gsp = fl.t_stage(fl.t_stage(y, "et", TP, M1), "it", TP, M1)
            k2 = lambda **kw: fl.k2(gsp, x, a, b, wp, bp, Hp=HP, Wp=WP, m2=M2, m3=M3,
                                    act=act, **kw)
            k2p = lambda: fl.k2_plain(gsp, x, a, b, wp, bp, cst, Hp=HP, Wp=WP,
                                      act=act)
            (s, st), (s_ref, st_ref) = run_as("k2", tc, k2), k2p()
            sr = s_ref.float().view(-1, C)
            terms = torch.stack([sr.abs().sum(0), (sr * sr).sum(0)])
            # the fma variant, named, on the same inputs: against the twin and
            # against the variant chosen (mma in bf16, tf32 in f32)
            fma_s, fma_st = run_as("k2", "fma", lambda: k2(variant="fma"))
            for name, sv, stv in (("k2", s, st), ("k2_fma", fma_s, fma_st)):
                rows.append(compare(f"{name}/s/{act}", sv, s_ref, tol))
                rows.append(compare_sums(f"{name}/stats/{act}", stv, st_ref, terms))
            rows.append(compare(f"k2_fma/vs_{tc}/s/{act}", fma_s, s, tol))
            rows.append(compare_sums(f"k2_fma/vs_{tc}/stats/{act}", fma_st, st, terms))
            del fma_s, fma_st
            if not all(torch.equal(u, v) for u, v in zip((s, st), k2())):
                raise AssertionError(f"two identical k2 calls differ ({dtype})")
            if act == "exact":   # layers 1.. of the path; layer 0 is 'none'
                times = dict(k1=(queued_ms([k1], n=16, reps=5), cuda_ms(k1p)),
                             k2=(queued_ms([k2], n=8, reps=5), cuda_ms(k2p)))
                single = dict(k1=cuda_ms(k1), k2=cuda_ms(k2))
                times["k2_fma"] = (queued_ms([lambda: k2(variant="fma")], n=4, reps=3),
                                   times["k2"][1])
                times["k1_fma"] = (queued_ms([lambda: k1(variant="fma")], n=8, reps=5),
                                   times["k1"][1])
                # the DFT tables (under 0.1 MB) are left out of the bytes
                k1_work = (nbytes(x, a, b, y), dft_ops(BT), dtype)
                k2_work = (nbytes(gsp, x, a, b, wp, bp, s, st),
                           dft_ops(BT) + BT * HP * WP * C * C * 2, dtype)
                work = dict(k1=bound(*k1_work, tc), k1_fma=bound(*k1_work),
                            k2=bound(*k2_work, tc), k2_fma=bound(*k2_work))
                rows += check_tstage_generic(dev, g, dtype, y, tol)
                if dtype == torch.float32:   # K1's and K2's f32 route, for the summary line
                    for k in ("k1", "k2"):
                        summary[k]["tf32"] = tf32_entry(k, [r for r in rows if r["name"].startswith(
                            f"{k}/") and "/stats/" not in r["name"]], times, work, single)
        del s, st, s_ref, st_ref, sr, y, gsp
        library = {}
        for kind in ("et", "it"):
            key = f"t_stage_{kind}"
            times[key], library[key], single[key], work[key] = tstage_times(
                dev, g, kind, B, dtype)
        torch.cuda.synchronize()
        emit(dict(phase="kernel", dtype=str(dtype).replace("torch.", ""),
                  shapes=dict(BT=BT, Hp=HP, Wp=WP, C=C, modes=[M1, M2, M3]),
                  checks=rows, ms={k: dict(kernel=v[0], plain=v[1], **work[k],
                                           library=library.get(k),
                                           single_launch=single.get(k))
                                   for k, v in times.items()}))
        if dtype == torch.bfloat16:
            for k in summary:
                mine = [r for r in rows
                        if r["name"].startswith(k + "/") and "/stats/" not in r["name"]]
                for key in ("max_abs_err", "max_rel_err"):
                    summary[k][key] = max(r[key] for r in mine)
            for k in ("k1", "k2"):
                summary[k]["ms"], summary[k]["plain_ms"] = times[k]
                summary[k].update(work[k], library_ms=None)
            summary["k2"].update(fma_variant_ms=times["k2_fma"][0],
                                 single_launch_ms=single["k2"])
            summary["k1"].update(fma_variant_ms=times["k1_fma"][0],
                                 single_launch_ms=single["k1"])
            # one layer's T-stage: one 'et' and one 'it' launch
            pair = ("t_stage_et", "t_stage_it")
            summary["t_stage"].update(
                ms=sum(times[k][0] for k in pair), plain_ms=sum(times[k][1] for k in pair),
                library_ms=sum(library[k] for k in pair),
                single_launch_ms=sum(single[k] for k in pair),
                **add_bounds(*(work[k] for k in pair)))
    return summary


def k12b_terms(x, a, b, s, ds, ds1, ds2, dx_ref) -> tuple:
    """The sums of |terms| of K12B's four accumulators (dWp, da, db, dbp),
    elementwise, from the twin's dx."""
    C = x.shape[-1] // 2
    v = lambda q: q.float().view(-1, C)
    x2 = v(x)
    z = gelu(x2 * a + b, "exact")
    dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
    du = v(dx_ref) / a
    return (z.abs().t() @ dse.abs(), (du * x2).abs().sum(0), du.abs().sum(0),
            dse.abs().sum(0))


def k3b_terms(s, tail, gl, dims, tail_dims) -> tuple:
    """The sums of |terms| of K3B's four accumulators (dk1, db1, dk2, db2)."""
    B, Tp, Hp, Wp, Cs = dims
    T, H, W = tail_dims
    target, k1w, b1w, k2w, b2w = tail
    zt = s.float().view(B, Tp, Hp, Wp, Cs)[:, :T, :H, :W].reshape(-1, Cs)
    u1 = zt @ k1w + b1w
    h1 = gelu(u1, "exact")
    do = 2 * gl * (h1 @ k2w + b2w - target.reshape(-1, k2w.shape[1]))
    du1 = (do @ k2w.t()) * gelu_grad(u1, "exact")
    return (zt.abs().t() @ du1.abs(), du1.abs().sum(0), h1.abs().t() @ do.abs(),
            do.abs().sum(0))


def phase_backward(dev) -> dict:
    """The backward and tail kernels against their twins at the training
    width, and K2 there in f32; returns per-kernel summaries (bf16 errors
    and times; K2's and K12B's f32 route under "tf32")."""
    B = TRAIN_BATCH
    BT = B * TP
    T, H, W = SHAPE_IN[:3]
    F = SHAPE_OUT[-1] * (SHAPE_OUT[0] // SHAPE_IN[0])
    geo = dict(Hp=HP, Wp=WP, m2=M2, m3=M3)
    cst = fl._ct_on(dev, HP, WP, M2, M3)
    lite = fl._lite_on(dev, HP, WP, M2, M3)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(3)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        tol = KERNEL_TOL[dtype]
        x = rn(BT, HP * WP // 2, 2 * C).to(dtype)
        a, b = 1 + 0.1 * rn(C), 0.1 * rn(C)
        wp, bp = rn(C, C) / C ** 0.5, 0.1 * rn(C)
        tc = "mma" if dtype == torch.bfloat16 else "tf32"   # K1, K2, K2A-lite, K12B, K3F, K3B
        k1 = lambda **kw: fl.k1(x, a, b, **geo, act="exact", **kw)
        y = run_as("k1", tc, k1)
        rows, times, work, library, single = [], {}, {}, {}, {}
        # K1 at the width the training step launches it: in f32 its tf32 and
        # named fma variants against the twin (f32 temporaries of 2 GB) and
        # against each other; two calls bit-equal
        y_fma = run_as("k1", "fma", lambda: k1(variant="fma"))
        if dtype == torch.float32:
            y_ref = fl.k1_plain(x, a, b, cst, Hp=HP, Wp=WP, act="exact")
            rows += [compare("k1/y", y, y_ref, tol), compare("k1_fma/y", y_fma, y_ref, tol)]
            del y_ref
            if not torch.equal(y, k1()):
                raise AssertionError("two identical k1 calls differ (float32, BT 832)")
        rows.append(compare(f"k1_fma/vs_{tc}/y", y_fma, y, tol))
        del y_fma
        torch.cuda.empty_cache()
        gsp = rn(*y.shape).to(dtype)
        k2 = lambda **kw: fl.k2(gsp, x, a, b, wp, bp, **geo, act="exact", **kw)
        s, st = run_as("k2", tc, k2)
        if dtype == torch.float32:
            # the tf32 variant and the fma one against the twin at this width
            # too (the twin's f32 temporaries fit beside x, y and s), and
            # against each other; two calls bit-equal
            s_ref, st_ref = fl.k2_plain(gsp, x, a, b, wp, bp, cst, Hp=HP, Wp=WP, act="exact")
            sr = s_ref.view(-1, C)
            terms = torch.stack([sr.abs().sum(0), (sr * sr).sum(0)])
            del sr
            fma_s, fma_st = run_as("k2", "fma", lambda: k2(variant="fma"))
            for name, sv, stv in (("k2", s, st), ("k2_fma", fma_s, fma_st)):
                rows.append(compare(f"{name}/s", sv, s_ref, tol))
                rows.append(compare_sums(f"{name}/stats", stv, st_ref, terms))
            rows.append(compare("k2_fma/vs_tf32/s", fma_s, s, tol))
            rows.append(compare_sums("k2_fma/vs_tf32/stats", fma_st, st, terms))
            if not all(torch.equal(u, v) for u, v in zip((s, st), k2())):
                raise AssertionError("two identical k2 calls differ (float32, BT 832)")
            del s_ref, st_ref, fma_s, fma_st, terms
            torch.cuda.empty_cache()
        # K1's times at this width (bf16: held against its twin at the
        # rollout width in the kernel phase)
        times["k1"] = (queued_ms([k1], n=8, reps=5), None)
        single["k1"] = cuda_ms(k1, reps=10)
        work["k1"] = bound(nbytes(x, a, b, y), dft_ops(BT), dtype, tc)
        times["k1_fma"] = (queued_ms([lambda: k1(variant="fma")], n=4, reps=3), None)
        work["k1_fma"] = bound(nbytes(x, a, b, y), dft_ops(BT), dtype)
        # K2 at the width the training step launches it (held against its
        # twin at the rollout width in the kernel phase: the f32 twin's
        # temporaries do not fit beside this phase's tensors)
        times["k2"] = (queued_ms([k2], n=8, reps=5), None)
        single["k2"] = cuda_ms(k2, reps=10)
        k2_work = (nbytes(gsp, x, a, b, wp, bp, s, st),
                   dft_ops(BT) + BT * HP * WP * C * C * 2, dtype)
        work["k2"], work["k2_fma"] = bound(*k2_work, tc), bound(*k2_work)
        times["k2_fma"] = (queued_ms([lambda: k2(variant="fma")], n=4, reps=3), None)
        del x, st
        # cotangents at the scale the step gives them: ds ~ 1/n_pos per
        # position, the statistics' cotangents ~ 1/n_pos too
        npos = BT * HP * WP
        ds, dy = (rn(*s.shape) / npos).to(dtype), (rn(*y.shape) / npos).to(dtype)
        ds1, ds2 = rn(C) / npos, rn(C) / npos
        adj_in = {"it_adj": dy, "et_adj": dy[: B * 2 * M1].contiguous()}
        for kind, inp in adj_in.items():
            mats = fl._tmats_on(dev, kind, TP, M1)
            got = run_as("t_stage", "registers", lambda: fl.t_stage(inp, kind, TP, M1))
            rows.append(compare(f"t_stage/{kind}", got, fl.t_stage_plain(inp, *mats), tol))
            if not torch.equal(got, fl.t_stage(inp, kind, TP, M1)):
                raise AssertionError(f"two identical t_stage calls differ ({kind}, {dtype})")
            del got
            key = f"t_stage_{kind}"
            times[key], library[key], single[key], work[key] = tstage_times(
                dev, g, kind, B, dtype)
        k2a = lambda: fl.k2a(s, ds, ds1, ds2, **geo)
        k2a_p = lambda: fl.k2a_plain(s, ds, ds1, ds2, cst, Hp=HP, Wp=WP)
        k2l = lambda **kw: fl.k2a_lite(ds, gsp, y, ds1, ds2, wp, bp, **geo, **kw)
        k2l_p = lambda: fl.k2a_lite_plain(ds, gsp, y, ds1, ds2, wp, bp, lite, cst,
                                          Hp=HP, Wp=WP)
        full, lite_dg = k2a(), run_as("k2a_lite", tc, k2l)
        lite_ref = k2l_p()
        rows.append(compare("k2a/dg", full, k2a_p(), tol))
        rows.append(compare("k2a_lite/dg", lite_dg, lite_ref, tol))
        rows.append(compare("k2a_lite/vs_k2a", lite_dg, full, tol))
        if not torch.equal(lite_dg, k2l()):
            raise AssertionError(f"two identical k2a_lite calls differ ({dtype})")
        # the fma variant, named, on the same inputs: against the twin, K2A
        # and the variant chosen
        fma_dg = run_as("k2a_lite", "fma", lambda: k2l(variant="fma"))
        rows += [compare("k2a_lite_fma/dg", fma_dg, lite_ref, tol),
                 compare("k2a_lite_fma/vs_k2a", fma_dg, full, tol),
                 compare(f"k2a_lite_fma/vs_{tc}/dg", fma_dg, lite_dg, tol)]
        del fma_dg, lite_ref
        work["k2a"] = bound(nbytes(s, ds, ds1, ds2, full), dft_ops(BT), dtype)
        # the lite fit's correction: a [2Y, C] x [C, C] product per image
        k2l_work = (nbytes(ds, gsp, y, ds1, ds2, wp, bp, lite_dg),
                    dft_ops(BT) + BT * 2 * (2 * M2 * M3) * C * C * 2, dtype)
        work["k2a_lite"], work["k2a_lite_fma"] = bound(*k2l_work, tc), bound(*k2l_work)
        del full, lite_dg
        times["k2a"] = (cuda_ms(k2a), cuda_ms(k2a_p))
        times["k2a_lite"] = (queued_ms([k2l], n=8, reps=5), cuda_ms(k2l_p))
        single["k2a_lite"] = cuda_ms(k2l, reps=10)
        times["k2a_lite_fma"] = (queued_ms([lambda: k2l(variant="fma")], n=4, reps=3),
                                 times["k2a_lite"][1])

        x = rn(BT, HP * WP // 2, 2 * C).to(dtype)
        k12 = lambda **kw: fl.k12b(x, a, b, wp, s, ds, ds1, ds2, dy, **geo, act="exact", **kw)
        k12_p = lambda: fl.k12b_plain(x, a, b, wp, s, ds, ds1, ds2, dy, cst, Hp=HP,
                                      Wp=WP, act="exact")
        got, ref = run_as("k12b", tc, k12), k12_p()
        if not all(torch.equal(u, w) for u, w in zip(got, k12())):
            raise AssertionError(f"two identical k12b calls differ ({dtype})")
        # the fma variant, named, on the same inputs: against the twin and
        # against the variant chosen (mma in bf16, tf32 in f32)
        held = [("k12b", got), ("k12b_fma", run_as("k12b", "fma", lambda: k12(variant="fma")))]
        # the adjoint DFT, and two [positions, C] x [C, C] products (dz, dWp)
        k12b_work = (nbytes(x, a, b, wp, s, ds, ds1, ds2, dy, *got),
                     dft_ops(BT) + 2 * BT * HP * WP * C * C * 2, dtype)
        work["k12b"], work["k12b_fma"] = bound(*k12b_work, tc), bound(*k12b_work)
        terms = k12b_terms(x, a, b, s, ds, ds1, ds2, ref[0])
        for kname, gk in held:
            rows.append(compare(f"{kname}/dx", gk[0], ref[0], tol))
            for name, gv, rv, tv in zip(("dwp", "da", "db", "dbp"), gk[1:], ref[1:], terms):
                rows.append(compare_sums(f"{kname}/{name}", gv, rv, tv))
        rows.append(compare(f"k12b_fma/vs_{tc}/dx", held[1][1][0], got[0], tol))
        for name, gv, rv, tv in zip(("dwp", "da", "db", "dbp"), held[1][1][1:], got[1:], terms):
            rows.append(compare_sums(f"k12b_fma/vs_{tc}/{name}", gv, rv, tv))
        del got, ref, terms, held
        times["k12b"] = (queued_ms([k12], n=8, reps=5), cuda_ms(k12_p, reps=5))
        single["k12b"] = cuda_ms(k12, reps=10)
        times["k12b_fma"] = (queued_ms([lambda: k12(variant="fma")], n=4, reps=3),
                             times["k12b"][1])

        kw = dict(dims=(B, TP, HP, WP, C), tail_dims=(T, H, W), act="exact")
        tail = (rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128),
                rn(128, F) / 128 ** 0.5, 0.1 * rn(F))
        gl = torch.tensor(1.0 / (B * T * H * W * F), device=dev)
        k3f = lambda **kv: ft.k3f(s, *tail, **kw, **kv)
        k3f_p = lambda: ft.k3f_plain(s, *tail, **kw)
        k3b = lambda **kv: ft.k3b(s, *tail, gl, **kw, **kv)
        k3b_p = lambda: ft.k3b_plain(s, *tail, gl, **kw)
        # K3F and K3B in the variant chosen (mma in bf16, tf32 in f32) and,
        # named, the fma one on the same inputs: against the twin and against
        # each other; two calls of the chosen one bit-equal
        sse, sse_ref = run_as("k3f", tc, k3f), k3f_p()
        rows.append(compare_sums("k3f/sse", sse, sse_ref, sse_ref))
        if not torch.equal(sse, k3f()):
            raise AssertionError(f"two identical k3f calls differ ({dtype})")
        sse_fma = run_as("k3f", "fma", lambda: k3f(variant="fma"))
        rows += [compare_sums("k3f_fma/sse", sse_fma, sse_ref, sse_ref),
                 compare_sums("k3f/vs_fma", sse, sse_fma, sse_ref)]
        got, ref = run_as("k3b", tc, k3b), k3b_p()
        if not all(torch.equal(u, w) for u, w in zip(got, k3b())):
            raise AssertionError(f"two identical k3b calls differ ({dtype})")
        held = [("k3b", got), ("k3b_fma", run_as("k3b", "fma", lambda: k3b(variant="fma")))]
        # the tail reads only the crop of s; fc1 and fc2 per position, three
        # of each in the backward (recompute, data and weight gradients)
        npos, crop = B * T * H * W, B * T * H * W * C * s.element_size()
        fc = npos * (2 * C * tail[1].shape[1] + 2 * tail[3].shape[0] * F)
        k3f_work = (crop + nbytes(*tail, sse), fc, dtype)
        k3b_work = (crop + nbytes(*tail, gl, *got), 3 * fc, dtype)
        work["k3f"], work["k3f_fma"] = bound(*k3f_work, tc), bound(*k3f_work)
        work["k3b"], work["k3b_fma"] = bound(*k3b_work, tc), bound(*k3b_work)
        terms = k3b_terms(s, tail, gl, kw["dims"], kw["tail_dims"])
        for kname, gk in held:
            rows.append(compare(f"{kname}/ds", gk[0], ref[0], tol))
            for name, gv, rv, tv in zip(("dk1", "db1", "dk2", "db2"), gk[1:], ref[1:], terms):
                rows.append(compare_sums(f"{kname}/{name}", gv, rv, tv))
        rows.append(compare(f"k3b_fma/vs_{tc}/ds", held[1][1][0], got[0], tol))
        for name, gv, rv, tv in zip(("dk1", "db1", "dk2", "db2"), held[1][1][1:], got[1:], terms):
            rows.append(compare_sums(f"k3b_fma/vs_{tc}/{name}", gv, rv, tv))
        del got, ref, terms, held
        times["k3f"] = (queued_ms([k3f], n=8, reps=5), cuda_ms(k3f_p, reps=5))
        single["k3f"] = cuda_ms(k3f, reps=10)
        times["k3b"] = (queued_ms([k3b], n=8, reps=5), cuda_ms(k3b_p, reps=5))
        single["k3b"] = cuda_ms(k3b, reps=10)
        times["k3f_fma"] = (queued_ms([lambda: k3f(variant="fma")], n=4, reps=3), times["k3f"][1])
        times["k3b_fma"] = (queued_ms([lambda: k3b(variant="fma")], n=4, reps=3), times["k3b"][1])
        torch.cuda.synchronize()
        emit(dict(phase="backward", dtype=str(dtype).replace("torch.", ""),
                  shapes=dict(BT=BT, Hp=HP, Wp=WP, C=C, modes=[M1, M2, M3],
                              tail=[B, T, H, W, F]),
                  checks=rows, ms={k: dict(kernel=v[0], plain=v[1], **work[k],
                                           library=library.get(k),
                                           single_launch=single.get(k))
                                   for k, v in times.items()}))
        if dtype == torch.float32:   # the f32 route of the tf32 kernels, for the summary line
            tf32 = {k: tf32_entry(k, [r for r in rows if r["name"].startswith(k + "/")], times,
                                  work, single)
                    for k in ("k1", "k2", "k2a_lite", "k12b", "k3f", "k3b")}
        if dtype == torch.bfloat16:
            summary["k2_train_width"] = dict(ms=times["k2"][0], single_launch_ms=single["k2"],
                                             bound_ms=work["k2"]["bound_ms"],
                                             fma_variant_ms=times["k2_fma"][0],
                                             tf32=tf32["k2"])
            summary["k1_train_width"] = dict(ms=times["k1"][0], fma_variant_ms=times["k1_fma"][0],
                                             single_launch_ms=single["k1"],
                                             bound_ms=work["k1"]["bound_ms"], tf32=tf32["k1"])
            for k in ("k2a_lite", "k2a", "k12b", "k3f", "k3b"):
                mine = [r for r in rows if r["name"].startswith(k + "/")]
                summary[k] = dict(
                    max_abs_err=max(r["max_abs_err"] for r in mine),
                    max_rel_err=max(r.get("max_rel_err", r.get("max_rel_to_terms"))
                                    for r in mine),
                    ms=times[k][0], plain_ms=times[k][1], library_ms=None, **work[k])
            for k in ("k2a_lite", "k12b", "k3f", "k3b"):
                summary[k].update(fma_variant_ms=times[f"{k}_fma"][0],
                                  single_launch_ms=single[k])
            for k in ("k2a_lite", "k12b", "k3f", "k3b"):
                summary[k]["tf32"] = tf32[k]
            adj = [r for r in rows if r["name"].startswith("t_stage/")]
            pair = ("t_stage_et_adj", "t_stage_it_adj")
            summary["t_stage_adjoint"] = dict(
                max_abs_err=max(r["max_abs_err"] for r in adj),
                max_rel_err=max(r["max_rel_err"] for r in adj),
                ms=sum(times[k][0] for k in pair), plain_ms=sum(times[k][1] for k in pair),
                library_ms=sum(library[k] for k in pair),
                single_launch_ms=sum(single[k] for k in pair),
                bound_ms=add_bounds(*(work[k] for k in pair))["bound_ms"])
        del s, y, gsp, ds, dy, x
        torch.cuda.empty_cache()
    return summary


class _PlainPath:
    """The same model with every layer through the plain oracle."""

    def __init__(self, model):
        self.model = model

    def predict(self, x):
        with torch.inference_mode():
            return self.model(x, reference=True)


def phase_slice(dev, compute_dtype="bfloat16") -> dict:
    """bench.py's rollout through make_rollout_fn in bf16 (phase slice, the
    kernels' mma variants, within ROLLOUT_* of the plain f32 rollout, then
    its profile) or, with ``compute_dtype`` None, in float32 as the shipped
    config runs it (phase slice_f32: K1 and K2 tf32, within KERNEL_TOL's
    f32 bound); returns the launch counts of the counted rollout."""
    f32 = compute_dtype is None
    path = "rollout_f32" if f32 else "rollout"
    model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), compute_dtype=compute_dtype,
                        device=dev, generator=make_generator(0), **MODEL).eval()
    g = torch.Generator(device=dev).manual_seed(2)
    x_raw = torch.randn(BATCH, *SHAPE_IN, generator=g, device=dev)
    y_raw = torch.randn(BATCH, SHAPE_OUT[0] * STEPS, *SHAPE_OUT[1:],
                        generator=g, device=dev)
    rollout = make_rollout_fn(model, IdentityNormalizer(), STEPS)

    # the main path, counted: nothing but this run between reset and read
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred, _, _ = rollout(x_raw, y_raw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    per_predict = dict.fromkeys(kernels.LAUNCHES, 0)
    per_predict.update(k1=MODEL["n_layers"], k2=MODEL["n_layers"],
                       t_stage=2 * MODEL["n_layers"])
    for k, n in per_predict.items():
        if launches[k] != n * STEPS:
            raise AssertionError(f"{k} launched {launches[k]} times in a "
                                 f"{STEPS}-step rollout, expected {n * STEPS}")
    variants = expect_variants(
        f"a {STEPS}-step rollout", k1={"tf32" if f32 else "mma": per_predict["k1"] * STEPS},
        k2={"tf32" if f32 else "mma": per_predict["k2"] * STEPS},
        t_stage={"registers": per_predict["t_stage"] * STEPS})
    VARIANTS_BY_PATH[path] = variants

    want = (BATCH, STEPS * SHAPE_OUT[0], *SHAPE_OUT[1:])
    if tuple(pred.shape) != want or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"rollout output {tuple(pred.shape)} (want {want}) "
                             "or not finite")

    ref_model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), device=dev,
                            **MODEL).eval()
    ref_model.load_state_dict(model.state_dict(), strict=True)
    ref, _, _ = make_rollout_fn(_PlainPath(ref_model), IdentityNormalizer(),
                                STEPS)(x_raw, y_raw)
    rel_l2 = ((pred - ref).norm() / ref.norm()).item()
    max_rel = ((pred - ref).abs().max() / ref.abs().max()).item()
    lim_l2, lim_max = ((KERNEL_TOL[torch.float32],) * 2 if f32
                       else (ROLLOUT_REL_L2, ROLLOUT_MAX))
    row = dict(rel_l2=rel_l2, limit_rel_l2=lim_l2,
               max_abs_over_max_ref=max_rel, limit_max=lim_max,
               ref_abs_max=ref.abs().max().item())
    if not (rel_l2 <= lim_l2 and max_rel <= lim_max):
        raise AssertionError(f"{path}: kernel rollout vs f32 plain rollout: {row}")

    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(x_raw, y_raw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    frames = BATCH * STEPS * SHAPE_OUT[0]
    emit(dict(phase="slice_f32" if f32 else "slice", batch=BATCH, steps=STEPS,
              shape=list(want), launches=launches, variants=variants, vs_plain_f32=row,
              first_rollout_s=first_s, rollout_s=secs, frames_per_s=frames / med,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    if not f32:
        phase_profile(rollout, x_raw, y_raw, "slice_profile")
    return launches


def _rel_l2(got, ref) -> float:
    f = lambda t: torch.view_as_real(t) if t.is_complex() else t.float()
    return ((f(got) - f(ref)).norm() / f(ref).norm()).item()


def _grads(model):
    """Every parameter's gradient; those autograd left None (DPOT's
    classification head, whose output the wrapper discards) are left out."""
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def _fno_vs_plain(what, batch, loss, grads, ref_loss, ref_grads, model, ref_model,
                  limits=(TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2, TRAIN_STATS_REL_L2)) -> dict:
    """An FNO step's loss, gradients and BatchNorm running statistics against
    the plain f32 step's from the same weights, within ``limits`` (loss,
    gradients, statistics; the bf16 TRAIN_* limits by default); raises
    naming what missed."""
    loss_lim, grad_lim, stats_lim = limits
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    cmp = dict(batch=batch, loss=loss.item(), ref_loss=ref_loss.item(),
               loss_rel=loss_rel, limit_loss_rel=loss_lim, grad_rel_l2={},
               limit_grad_rel_l2=grad_lim, zero_grads={},
               limit_zero_grad=TRAIN_ZERO_GRAD, stats_rel_l2={},
               limit_stats_rel_l2=stats_lim)
    bad = [] if loss_rel <= loss_lim else ["loss"]
    for name, gr in ref_grads.items():
        if name.startswith("convs.") and name.endswith(".bias"):
            scale = ref_grads[name[:-4] + "weight"].abs().max().item()
            worst = max(grads[name].abs().max().item(), gr.abs().max().item()) / scale
            cmp["zero_grads"][name] = worst
            bad += [] if worst <= TRAIN_ZERO_GRAD else [name]
            continue
        rel = _rel_l2(grads[name], gr)
        cmp["grad_rel_l2"][name] = rel
        bad += [] if rel <= grad_lim else [name]
    ref_bufs = dict(ref_model.named_buffers())
    for name, buf in model.named_buffers():
        if "running" in name:
            rel = _rel_l2(buf, ref_bufs[name])
            cmp["stats_rel_l2"][name] = rel
            bad += [] if rel <= stats_lim else [name]
    cmp["worst_grad_rel_l2"] = max(cmp["grad_rel_l2"].values())
    cmp["worst_stats_rel_l2"] = max(cmp["stats_rel_l2"].values())
    if bad:
        raise AssertionError(f"{what}: {bad}: {cmp}")
    return cmp


def phase_train(dev, compute_dtype="bfloat16") -> dict:
    """bench.py's training step through make_train_step, in bf16 (phase
    train, the kernels' mma variants) or, with ``compute_dtype`` None, in
    float32 as the shipped config runs it (phase train_f32: K1, K2,
    K2A-lite, K12B, K3F and K3B tf32, within F32_LIMITS of the plain step);
    returns the launch counts of the counted step."""
    path = "train" if compute_dtype else "train_f32"
    tc = "mma" if compute_dtype else "tf32"   # every FNO kernel's but the T-stage's
    model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), compute_dtype=compute_dtype,
                        device=dev, generator=make_generator(0), **MODEL)
    ref_model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), device=dev, **MODEL)
    ref_model.load_state_dict(model.state_dict(), strict=True)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(TRAIN_BATCH, *SHAPE_IN, generator=g, device=dev)
    y = torch.randn(TRAIN_BATCH, *SHAPE_OUT, generator=g, device=dev)
    opt = build_optimizer(TRAIN_CFG, model.parameters())
    step = make_train_step(model, IdentityNormalizer(), opt, grad_accum=1)

    # the main path, counted: nothing but this step between reset and read
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"one {path} step launched {launches}, "
                             f"expected {TRAIN_LAUNCHES}")
    variants = expect_variants(f"one {path} step", **{
        k: {"registers" if k == "t_stage" else tc: n}
        for k, n in TRAIN_LAUNCHES.items() if n})
    VARIANTS_BY_PATH[path] = variants
    grads = _grads(model)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"training loss {loss.item()} is not finite")

    # the same step from the same weights through the plain f32 path
    ref_model.train()
    ref_loss = ref_model(x, y=y, reference=True)
    ref_loss.backward()
    ref_grads = _grads(ref_model)
    limits = (TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2, TRAIN_STATS_REL_L2) if compute_dtype \
        else F32_LIMITS
    cmp = _fno_vs_plain(f"{path}: kernel step vs f32 plain step", TRAIN_BATCH, loss,
                        grads, ref_loss, ref_grads, model, ref_model, limits)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    del ref_model, ref_loss, ref_grads
    torch.cuda.empty_cache()

    # determinism: the same forward-backward twice, bit for bit
    rep = []
    for _ in range(2):
        opt.zero_grad()
        rep.append(model.loss(x, y))
        rep[-1].backward()
        rep.append(_grads(model))
    same = torch.equal(rep[0], rep[2]) and all(
        torch.equal(rep[1][n], rep[3][n]) for n in rep[1])
    if not same:
        raise AssertionError("two identical forward-backward passes differ")
    del rep

    for _ in range(WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = [], []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            loss = step(x, y)
        losses.append(loss.item())      # synchronises
        rates.append(WINDOW_STEPS / (time.perf_counter() - t0))
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"training losses {losses} are not finite")
    frames = TRAIN_BATCH * SHAPE_OUT[0]
    med = statistics.median(rates)
    BARE_STEPS_PER_S[path] = med
    emit(dict(phase=path, batch=TRAIN_BATCH, cfg=TRAIN_CFG, launches=launches,
              variants=variants, vs_plain_f32=cmp, bitwise_repeatable=same, first_step_s=first_s,
              window_steps_per_s=rates, steps_per_s=med,
              frames_per_s=med * frames, losses=losses,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_with_plain_step_gb=ref_peak))
    phase_profile(step, x, y, "profile" if compute_dtype else "train_f32_profile")
    return launches


def _sdpa_call(q, k, v, do, pb, heads: int, chunks: int, backward: bool):
    """scaled_dot_product_attention on [B·S, h, T, d] views of the tokens,
    pos_bias as a float mask (q is pre-scaled: scale 1), over ``chunks``
    equal parts of the sites; with ``backward`` also the gradients of q, k,
    v and the mask. The library yardstick of TA: the port never calls it."""
    B, S, T, Fd = q.shape
    split = lambda z: z.view(B * S, T, heads, Fd // heads).transpose(1, 2).chunk(chunks)
    mask = pb.detach().to(q.dtype, copy=True)
    parts = list(zip(split(q), split(k), split(v), split(do)))
    if backward:
        mask.requires_grad_()
        parts = [(*(z.detach().requires_grad_() for z in p[:3]), p[3]) for p in parts]

    def call():
        outs = []
        for qc, kc, vc, dc in parts:
            o = scaled_dot_product_attention(qc, kc, vc, attn_mask=mask, scale=1.0)
            if backward:
                torch.autograd.grad(o, (qc, kc, vc, mask), dc)
            outs.append(o.detach())
        return outs
    return call


def sdpa_yardstick(q, k, v, do, pb, heads: int, o_ref) -> dict:
    """CUDA-event medians of SDPA forward and forward+backward on TA's
    inputs: over the whole batch of sites, or, where SDPA refuses it, over
    the fewest equal chunks it takes (``library_chunks``); and its output's
    max|Δ|/max|ref| against the kernel's."""
    refused = None
    for chunks in (1, 2, 4, 8):
        fwd, fwd_bwd = (_sdpa_call(q, k, v, do, pb, heads, chunks, b) for b in (False, True))
        try:
            outs = fwd()
            fwd_bwd()
            torch.cuda.synchronize()
        except RuntimeError as e:
            refused = str(e).splitlines()[0][:200]
            continue
        o = torch.cat(outs).transpose(1, 2).reshape(o_ref.shape).float()
        err = ((o - o_ref.float()).abs().max() / o_ref.float().abs().max()).item()
        del outs, o
        return dict(library_ms=cuda_ms(fwd, reps=10),
                    library_fwd_bwd_ms=cuda_ms(fwd_bwd, reps=10),
                    library_chunks=chunks, library_refused=refused,
                    library_max_rel_err=err)
    raise RuntimeError(f"scaled_dot_product_attention refused every chunking: {refused}")


def _dpb_terms(q, k, v, pb, do, heads: int):
    """Σ over sites of P·(|dP| + |Σ_j P·dP|): the size of what each site
    adds to d(pos_bias), in f32."""
    B, S, T, Fd = q.shape
    spl = lambda z: z.float().view(B, S, T, heads, Fd // heads)
    with torch.no_grad():
        p = torch.softmax(torch.einsum("bsihd,bsjhd->bshij", spl(q), spl(k)) + pb,
                          dim=-1)
        dp = torch.einsum("bsihd,bsjhd->bshij", spl(do), spl(v))
        return (p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())).sum((0, 1))


def _ta_inputs(dev, B, S, T, h, d, dtype, seed):
    """q pre-scaled by d**-0.5 as the model hands it over; k, v, do N(0, 1);
    the bias N(0, 1), as the bias table's init."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda: torch.randn(B, S, T, h * d, generator=g, device=dev)
    q = (rn() * d ** -0.5).to(dtype)
    k, v, do = rn().to(dtype), rn().to(dtype), rn().to(dtype)
    return q, k, v, torch.randn(h, T, T, generator=g, device=dev), do


def check_ta_bwd(name, q, k, v, pb, do, h, tol, variant=None) -> tuple:
    """TA backward (the variant named, or chosen) against autograd through
    the twin in f32 from the same inputs: dq, dk, dv within ``tol`` of
    max|ref|, dpb within TA_DPB_TOL of its sum of |terms|. Returns (rows,
    outputs, the reference)."""
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v, pb)]
    ref = torch.autograd.grad(tta.temporal_attention_tokens_plain(*leaves, h), leaves,
                              do.float())
    got = kernels.ta_bwd(q, k, v, pb, do, h, variant=variant)
    rows = [compare(f"{name}/{n}", u, r.to(q.dtype), tol)
            for n, u, r in zip(("dq", "dk", "dv"), got, ref)]
    rows.append(compare_sums(f"{name}/dpb", got[3], ref[3], _dpb_terms(q, k, v, pb, do, h),
                             TA_DPB_TOL))
    return rows, got, ref


def phase_ta(dev) -> dict:
    """TA forward and backward against the twin at the UNet's level-0
    width, each in the variant its dtype chooses (tf32 in f32, mma in bf16)
    and, named, its fma one on the same inputs; both at every level of the
    UNet step in both dtypes; returns per-kernel summaries (bf16 errors and
    times; the f32 route's under "tf32")."""
    B, S, T, h, d = TA_SHAPE
    plain = tta.temporal_attention_tokens_plain
    nsites, summary = B * S, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, pb, do = _ta_inputs(dev, B, S, T, h, d, dtype, seed=5)
        tol = KERNEL_TOL[dtype]
        chosen = "mma" if dtype == torch.bfloat16 else "tf32"
        fwd = lambda **kv: kernels.ta_fwd(q, k, v, pb, h, **kv)
        bwd = lambda **kv: kernels.ta_bwd(q, k, v, pb, do, h, **kv)
        o = run_as("ta_fwd", chosen, fwd)
        o_ref = plain(q, k, v, pb, h)
        rows = [compare("ta_fwd/o", o, o_ref, tol)]
        bwd_rows, got, ref = run_as("ta_bwd", chosen,
                                    lambda: check_ta_bwd("ta_bwd", q, k, v, pb, do, h, tol))
        rows += bwd_rows
        same = torch.equal(o, fwd()) and all(
            torch.equal(a, b) for a, b in zip(got, bwd()))
        if not same:
            raise AssertionError(f"two identical TA calls differ ({dtype})")
        # the fma variants, named, on the same inputs
        o_fma = run_as("ta_fwd", "fma", lambda: fwd(variant="fma"))
        rows += [compare("ta_fwd_fma/o", o_fma, o_ref, tol),
                 compare("ta_fwd/vs_fma/o", o, o_fma, tol)]
        if not torch.equal(o_fma, fwd(variant="fma")):
            raise AssertionError(f"two identical TA forward calls (fma) differ ({dtype})")
        del o_fma
        fma_rows, fma, _ = run_as("ta_bwd", "fma", lambda: check_ta_bwd(
            "ta_bwd_fma", q, k, v, pb, do, h, tol, variant="fma"))
        rows += fma_rows
        rows += [compare(f"ta_bwd/vs_fma/{n}", u, w, tol)
                 for n, u, w in zip(("dq", "dk", "dv"), got, fma)]
        rows.append(compare_sums("ta_bwd/vs_fma/dpb", got[3], fma[3],
                                 _dpb_terms(q, k, v, pb, do, h), TA_DPB_TOL))
        del fma, ref

        def bwd_plain():
            ls = [t.detach().requires_grad_() for t in (q, k, v, pb)]
            return torch.autograd.grad(plain(*ls, h), ls, do)

        del o_ref
        times = dict(ta_fwd=(queued_ms([fwd], n=8, reps=5), cuda_ms(lambda: plain(q, k, v, pb, h))),
                     ta_bwd=(queued_ms([bwd], n=8, reps=5), cuda_ms(bwd_plain, reps=10)))
        times["ta_fwd_fma"] = (queued_ms([lambda: fwd(variant="fma")], n=8, reps=5),
                               times["ta_fwd"][1])
        times["ta_bwd_fma"] = (queued_ms([lambda: bwd(variant="fma")], n=4, reps=3),
                               times["ta_bwd"][1])
        single = dict(ta_fwd=cuda_ms(fwd), ta_bwd=cuda_ms(bwd))
        # scores and the value mix, 2·T·T·d each per (site, head); the
        # backward recomputes the scores and adds dP, dq, dk and dv
        fwd_work = (nbytes(q, k, v, pb, o), nsites * h * T * T * d * 4, dtype)
        bwd_work = (nbytes(q, k, v, pb, do, *got), nsites * h * T * T * d * 10, dtype)
        work = dict(ta_fwd=bound(*fwd_work, chosen), ta_bwd=bound(*bwd_work, chosen),
                    ta_fwd_fma=bound(*fwd_work), ta_bwd_fma=bound(*bwd_work))
        lib = sdpa_yardstick(q, k, v, do, pb, h, o)
        torch.cuda.synchronize()
        emit(dict(phase="ta", dtype=str(dtype).replace("torch.", ""),
                  shapes=dict(B=B, S=S, T=T, h=h, d=d), checks=rows,
                  bitwise_repeatable=same, library=lib,
                  ms={n: dict(kernel=t[0], plain=t[1], **work[n]) for n, t in times.items()},
                  ta_fwd_single_launch_ms=single["ta_fwd"],
                  ta_bwd_single_launch_ms=single["ta_bwd"]))
        # SDPA has no backward alone: the backward row's yardstick is its
        # forward and backward together
        library = dict(ta_fwd=lib["library_ms"], ta_bwd=lib["library_fwd_bwd_ms"])
        for n in ("ta_fwd", "ta_bwd"):
            mine = [r for r in rows if r["name"].startswith(n + "/")]
            if dtype == torch.float32:   # the f32 route, for the summary line
                summary.setdefault(n, {})["tf32"] = dict(
                    tf32_entry(n, mine, times, work, single), library_ms=library[n])
                continue
            summary.setdefault(n, {}).update(
                max_abs_err=max(r["max_abs_err"] for r in mine),
                max_rel_err=max(r.get("max_rel_err", r.get("max_rel_to_terms"))
                                for r in mine),
                ms=times[n][0], plain_ms=times[n][1], **work[n],
                fma_variant_ms=times[f"{n}_fma"][0], library_ms=library[n],
                single_launch_ms=single[n])
        del q, k, v, do, o, got
        torch.cuda.empty_cache()
    for n, levels in zip(("ta_fwd", "ta_bwd"), phase_ta_levels(dev)):
        summary[n]["levels"] = levels["bfloat16"]
        summary[n]["tf32"]["levels"] = levels["float32"]
    surrogate = phase_ta_levels(dev, 2, SURROGATE_TA_LEVELS, (torch.float32,), "surrogate")
    for n, levels in zip(("ta_fwd", "ta_bwd"), surrogate):
        summary[n]["tf32"]["surrogate_levels"] = levels["float32"]
    for key, levels, T in (("wdno_levels", WDNO_TA_LEVELS, 12),
                           ("wdno_t8_levels", WDNO_T8_LEVELS, 8)):
        wdno = phase_ta_levels(dev, WDNO_BATCH, levels, geometry=f"wdno_t{T}", T=T)
        for n, by_dtype in zip(("ta_fwd", "ta_bwd"), wdno):
            summary[n][key] = by_dtype["bfloat16"]
            summary[n]["tf32"][key] = by_dtype["float32"]
    return summary


def phase_ta_levels(dev, B=TA_SHAPE[0], levels=TA_LEVELS,
                    dtypes=(torch.float32, torch.bfloat16), geometry="cylinder",
                    T=TA_SHAPE[2]) -> tuple:
    """TA forward's and backward's tensor-core variants (mma in bf16, tf32
    in f32) at the site counts of every level the UNet step launches them
    at (the cylinder's TA_LEVELS at batch 12, the surrogate's
    SURROGATE_TA_LEVELS at batch 2, or WDNO's at T 12 and 8, batch 16):
    against the twin, two calls bit-equal, the device time of queued
    launches beside the bound; returns ({dtype: {level: (ms, bound_ms)}} of
    the forward, the same of the backward)."""
    _, _, _, h, d = TA_SHAPE
    fwd_out, out = {}, {}
    for dtype in dtypes:
        tc = "mma" if dtype == torch.bfloat16 else "tf32"
        name = str(dtype).replace("torch.", "")
        fwd_out[name], out[name] = {}, {}
        for i, (level, S) in enumerate(levels):
            q, k, v, pb, do = _ta_inputs(dev, B, S, T, h, d, dtype, seed=20 + i)
            tol = KERNEL_TOL[dtype]
            fwd = lambda: kernels.ta_fwd(q, k, v, pb, h)
            o = run_as("ta_fwd", tc, fwd)
            rows = [compare(f"ta_fwd/{level}/o", o, tta.temporal_attention_tokens_plain(
                q, k, v, pb, h), tol)]
            if not torch.equal(o, fwd()):
                raise AssertionError(f"two identical TA forward calls differ at {level} "
                                     f"({name})")
            bwd_rows, got, _ = run_as("ta_bwd", tc, lambda: check_ta_bwd(
                f"ta_bwd/{level}", q, k, v, pb, do, h, tol))
            rows += bwd_rows
            if not all(torch.equal(a, b)
                       for a, b in zip(got, kernels.ta_bwd(q, k, v, pb, do, h))):
                raise AssertionError(f"two identical TA backward calls differ at {level} "
                                     f"({name})")
            # the smallest level's inputs (126 MB in bf16) are larger than L2 already
            fwd_ms = queued_ms([fwd], n=8, reps=5)
            ms = queued_ms([lambda: kernels.ta_bwd(q, k, v, pb, do, h)], n=8, reps=5)
            fwd_work = bound(nbytes(q, k, v, pb, o), B * S * h * T * T * d * 4, dtype, tc)
            work = bound(nbytes(q, k, v, pb, do, *got), B * S * h * T * T * d * 10, dtype, tc)
            emit(dict(phase="ta_level", geometry=geometry, dtype=name, variant=tc, level=level,
                      shapes=dict(B=B, S=S, T=T, h=h, d=d), checks=rows, fwd_ms=fwd_ms,
                      fwd_bound_ms=fwd_work["bound_ms"], ms=ms, bound_ms=work["bound_ms"]))
            fwd_out[name][level] = dict(sites=B * S, ms=fwd_ms, bound_ms=fwd_work["bound_ms"])
            out[name][level] = dict(sites=B * S, ms=ms, bound_ms=work["bound_ms"])
            del q, k, v, pb, do, o, got
            torch.cuda.empty_cache()
    return fwd_out, out


def gaussian_normalizer():
    """Gaussian normalizer with seeded per-channel statistics, the same for
    inputs and targets (the cylinder's are the same fields u, v, p)."""
    r = np.random.default_rng(0)
    mean, std = r.normal(size=3), r.uniform(0.5, 2.0, size=3)
    return build_normalizer("gaussian", stats=dict(
        mean_inputs=mean, mean_targets=mean, std_inputs=std, std_targets=std))


def _unet(dev, compute_dtype=None, **kw):
    return build_model(shapes=(UNET_SHAPE, UNET_SHAPE), compute_dtype=compute_dtype,
                       device=dev, generator=make_generator(0), **UNET_MODEL, **kw)


def _expect(launches: dict, path: str, variants=None, **want) -> dict:
    """Exact launch counts (kernels not named: none) and per-variant counts
    (``variants``: kernel → {variant: count}; none named: none launched)."""
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        raise AssertionError(f"{path} launched {launches}, expected {full}")
    return expect_variants(path, **(variants or {}))


def _unet_path(compute_dtype, base: str) -> tuple:
    """(path name, TA variant, reduced) of a UNet phase in bf16 or, with
    ``compute_dtype`` None, in f32 as the shipped config runs it."""
    if compute_dtype:
        return base, "mma", dict(compute_dtype=dict(here=compute_dtype, shipped=None))
    return f"{base}_f32", "tf32", {}


def phase_unet_rollout(dev, norm, compute_dtype="bfloat16") -> dict:
    """The UNet's 5-step rollout in bf16 (phase unet_rollout) or, with
    ``compute_dtype`` None, in f32 as shipped (unet_rollout_f32: the TA
    forward's tf32 variant, within UNET_F32_ROLLOUT of the plain f32
    rollout, two rollouts bit-equal under cudnn.deterministic); returns the
    launch counts of the counted rollout."""
    path, tc, reduced = _unet_path(compute_dtype, "unet_rollout")
    model = _unet(dev, compute_dtype).eval()
    g = torch.Generator(device=dev).manual_seed(6)
    x_raw = torch.randn(UNET_BATCH, *UNET_SHAPE, generator=g, device=dev)
    y_raw = torch.randn(UNET_BATCH, UNET_SHAPE[0] * UNET_STEPS, *UNET_SHAPE[1:],
                        generator=g, device=dev)
    rollout = make_rollout_fn(model, norm, UNET_STEPS)

    # the main path, counted: nothing but this run between reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred, _, _ = rollout(x_raw, y_raw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH[path] = _expect(
        launches, f"a {UNET_STEPS}-step UNet rollout ({path})",
        variants=dict(ta_fwd={tc: UNET_TA_PER_FORWARD * UNET_STEPS}),
        ta_fwd=UNET_TA_PER_FORWARD * UNET_STEPS)
    want = (UNET_BATCH, UNET_STEPS * UNET_SHAPE[0], *UNET_SHAPE[1:])
    if tuple(pred.shape) != want or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"UNet rollout output {tuple(pred.shape)} (want {want}) "
                             "or not finite")

    ref_model = _unet(dev).eval()
    ref_model.load_state_dict(model.state_dict(), strict=True)
    ref, _, _ = make_rollout_fn(_PlainPath(ref_model), norm, UNET_STEPS)(x_raw, y_raw)
    rel_l2 = ((pred - ref).norm() / ref.norm()).item()
    max_rel = ((pred - ref).abs().max() / ref.abs().max()).item()
    lim_l2, lim_max = (UNET_ROLLOUT_REL_L2, UNET_ROLLOUT_MAX) if compute_dtype \
        else UNET_F32_ROLLOUT
    row = dict(rel_l2=rel_l2, limit_rel_l2=lim_l2, max_abs_over_max_ref=max_rel,
               limit_max=lim_max, ref_abs_max=ref.abs().max().item(),
               rel_l2_by_step=[((pred[:, i:i + UNET_SHAPE[0]] - ref[:, i:i + UNET_SHAPE[0]])
                                .norm() / ref[:, i:i + UNET_SHAPE[0]].norm()).item()
                               for i in range(0, want[1], UNET_SHAPE[0])])
    if not (rel_l2 <= lim_l2 and max_rel <= lim_max):
        raise AssertionError(f"{path}: kernel UNet rollout vs f32 plain rollout: {row}")
    del ref_model, ref
    torch.cuda.empty_cache()
    same = None
    if not compute_dtype:
        # determinism: the same rollout twice, bit for bit, with cuDNN held to
        # deterministic algorithms
        torch.backends.cudnn.deterministic = True
        same = torch.equal(rollout(x_raw, y_raw)[0], rollout(x_raw, y_raw)[0])
        torch.backends.cudnn.deterministic = False
        if not same:
            raise AssertionError(f"{path}: two identical rollouts differ")
    del pred
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(UNET_ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(x_raw, y_raw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    emit(dict(phase=path, batch=UNET_BATCH, steps=UNET_STEPS, shape=list(want),
              launches=launches, variants=VARIANTS_BY_PATH[path], vs_plain_f32=row,
              bitwise_repeatable=same, first_rollout_s=first_s, rollout_s=secs,
              frames_per_s=UNET_BATCH * want[1] / med,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, reduced=reduced))
    return launches


def _steps_per_s(step, x, y, n: int) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        loss = step(x, y)
    loss = loss.item()      # synchronises
    return n / (time.perf_counter() - t0), loss


def _plain_grads(model, xn, yn) -> tuple:
    """Loss and gradients of the f32 model through the plain path."""
    model.zero_grad(set_to_none=True)
    loss = model(xn, y=yn, reference=True)
    loss.backward()
    return loss.item(), _grads(model)


def _unet_pass(model, xn, yn) -> tuple:
    """One forward-backward of ``model`` from zeroed gradients: (loss,
    gradients)."""
    model.zero_grad(set_to_none=True)
    loss = model.loss(xn, yn)
    loss.backward()
    return loss.detach(), _grads(model)


def phase_unet_train(dev, norm, compute_dtype="bfloat16") -> dict:
    """The UNet's training step through make_train_step, remat at its
    default (on), in bf16 (phase unet_train; one window also timed with
    remat off, and the two held bit for bit) or, with ``compute_dtype``
    None, in f32 as shipped (unet_train_f32: the TA kernels' tf32 variants,
    the loss and gradients within UNET_F32_LOSS_REL and UNET_F32_GRAD_REL_L2
    of the plain f32 step, then its profile unet_f32_profile); returns the
    launch counts of the counted step."""
    path, tc, reduced = _unet_path(compute_dtype, "unet_train")
    batch = UNET_BATCH if compute_dtype else UNET_F32_BATCH
    if batch != UNET_BATCH:
        reduced["batch"] = dict(here=batch, shipped=UNET_BATCH)
    model = _unet(dev, compute_dtype)
    ref_model = _unet(dev)
    ref_model.load_state_dict(model.state_dict(), strict=True)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(batch, *UNET_SHAPE, generator=g, device=dev)
    y = torch.randn(batch, *UNET_SHAPE, generator=g, device=dev)
    opt = build_optimizer(UNET_TRAIN_CFG, model.parameters())
    step = make_train_step(model, norm, opt, grad_accum=1)

    # the main path, counted: nothing but this step between reset and read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y).item()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH[path] = _expect(
        launches, f"one UNet training step ({path})",
        variants=dict(ta_fwd={tc: UNET_TA_PER_FORWARD}, ta_bwd={tc: UNET_TA_PER_FORWARD}),
        ta_fwd=UNET_TA_PER_FORWARD, ta_bwd=UNET_TA_PER_FORWARD)
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    if not loss == loss or abs(loss) == float("inf"):
        raise AssertionError(f"UNet training loss {loss} is not finite")

    # the kernel path's loss and gradients against the plain f32 path's from
    # the weights before the step, both at UNET_CMP_BATCH: the f32 plain
    # step (every activation kept) at batch 12 does not fit an 80 GB card
    xn, yn = norm.preprocess(x, y)
    n = UNET_CMP_BATCH
    ref_loss, ref_grads = _plain_grads(ref_model, xn[:n], yn[:n])
    half = _unet(dev, compute_dtype)
    half.load_state_dict(ref_model.state_dict(), strict=True)
    half_loss = half(xn[:n], y=yn[:n])
    half_loss.backward()
    loss, grads = half_loss.item(), _grads(half)
    del half, half_loss
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    lim_loss, lim_grad = (UNET_LOSS_REL, UNET_GRAD_REL_L2) if compute_dtype \
        else (UNET_F32_LOSS_REL, UNET_F32_GRAD_REL_L2)
    cmp = dict(batch=n, loss=loss, ref_loss=ref_loss, loss_rel=loss_rel,
               limit_loss_rel=lim_loss, limit_grad_rel_l2=lim_grad,
               grad_rel_l2={n: _rel_l2(grads[n], gr) for n, gr in ref_grads.items()})
    cmp["worst_grad_rel_l2"] = max(cmp["grad_rel_l2"].values())
    bad = [] if loss_rel <= lim_loss else ["loss"]
    bad += [n for n, r in cmp["grad_rel_l2"].items() if not r <= lim_grad]
    if bad:
        raise AssertionError(f"{path}: kernel UNet step vs f32 plain step: {bad}: {cmp}")
    tf32_on = None
    if not compute_dtype:
        # measurement only: the same step with cuDNN's convolutions in TF32
        # (PyTorch's default, which build_model turns off), its loss and
        # gradients against the plain f32 step; its speed below
        fast = _unet(dev)
        fast.load_state_dict(ref_model.state_dict(), strict=True)
        torch.backends.cudnn.allow_tf32 = True
        try:
            fast_loss = fast(xn[:n], y=yn[:n])
            fast_loss.backward()
        finally:
            set_f32_precision()
        fast_rel = {k: _rel_l2(p.grad, ref_grads[k]) for k, p in fast.named_parameters()}
        tf32_on = dict(batch=n, loss_rel=abs(fast_loss.item() - ref_loss) / abs(ref_loss),
                       worst_grad_rel_l2=max(fast_rel.values()),
                       median_grad_rel_l2=statistics.median(fast_rel.values()))
        del fast, fast_loss
    del ref_model, ref_grads, grads
    torch.cuda.empty_cache()

    # determinism: the same forward-backward twice, bit for bit, with
    # cuDNN held to deterministic algorithms (its default ones may use atomics)
    torch.backends.cudnn.deterministic = True
    rep = [_unet_pass(model, xn, yn) for _ in range(2)]
    same = torch.equal(rep[0][0], rep[1][0]) and all(
        torch.equal(rep[0][1][n], rep[1][1][n]) for n in rep[0][1])
    if not same:
        raise AssertionError(f"{path}: two identical UNet forward-backward passes differ")
    remat_off = None
    if compute_dtype:
        # the cost of rematerialisation: the same weights without it, the
        # same numbers bit for bit, and one window's steps/s and peak
        bare = _unet(dev, compute_dtype, remat=False)
        bare.load_state_dict(model.state_dict(), strict=True)
        off = _unet_pass(bare, xn, yn)
        remat_off = dict(bitwise_equal=torch.equal(off[0], rep[0][0]) and all(
            torch.equal(off[1][n], rep[0][1][n]) for n in off[1]))
        if not remat_off["bitwise_equal"]:
            raise AssertionError(f"{path}: the step without remat differs from the step with it")
        del off
        bare_step = make_train_step(bare, norm, build_optimizer(UNET_TRAIN_CFG, bare.parameters()),
                                    grad_accum=1)
        torch.backends.cudnn.deterministic = False
        bare_step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        remat_off["steps_per_s"], _ = _steps_per_s(bare_step, x, y, UNET_WINDOW_STEPS)
        remat_off["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del bare, bare_step
        torch.cuda.empty_cache()
        torch.backends.cudnn.deterministic = True
    del rep
    windows, window_steps = (UNET_WINDOWS, UNET_WINDOW_STEPS) if compute_dtype \
        else UNET_F32_WINDOWS
    det_rate = None
    if compute_dtype:   # the f32 step's is not timed: the whole run's time limit
        step(x, y)
        det_rate, _ = _steps_per_s(step, x, y, window_steps)
    torch.backends.cudnn.deterministic = False

    for _ in range(WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = zip(*(_steps_per_s(step, x, y, window_steps) for _ in range(windows)))
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"UNet training losses {losses} are not finite")
    med = statistics.median(rates)
    BARE_STEPS_PER_S[path] = med
    if tf32_on is not None:
        torch.backends.cudnn.allow_tf32 = True
        try:
            step(x, y)      # cuDNN picks its TF32 algorithms
            tf32_on["steps_per_s"], _ = _steps_per_s(step, x, y, window_steps)
        finally:
            set_f32_precision()
    emit(dict(phase=path, batch=batch, cfg=UNET_TRAIN_CFG, launches=launches,
              variants=VARIANTS_BY_PATH[path], vs_plain_f32=cmp, bitwise_repeatable=same,
              first_step_s=first_s, window_steps_per_s=list(rates), steps_per_s=med,
              frames_per_s=med * batch * UNET_SHAPE[0], losses=list(losses),
              deterministic_cudnn_steps_per_s=det_rate, remat=model.remat,
              without_remat=remat_off,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_first_step_gb=first_peak,
              peak_mem_with_plain_step_gb=ref_peak, cudnn_tf32_on=tf32_on, reduced=reduced))
    phase_profile(step, x, y, "unet_profile" if compute_dtype else "unet_f32_profile")
    return launches


def _wdno(dev, compute_dtype=None, **kw):
    """The shipped cylinder WDNO (rescaler ones: no dataset), its denoiser
    in ``compute_dtype`` (None: f32, as shipped)."""
    from realpdebench_tpu_torch.config import load_config

    cfg = {**load_config(WDNO_CONFIG).to_dict(), "compute_dtype": compute_dtype, **kw}
    return build_model(shapes=(WDNO_SHAPE, WDNO_SHAPE), device=dev,
                       generator=make_generator(0), **cfg)


def _wdno_inputs(dev, batch: int, seed: int) -> tuple:
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, *WDNO_SHAPE, generator=g, device=dev)
    return g, x, torch.randn(batch, *WDNO_SHAPE, generator=g, device=dev)


def phase_wdno_train(dev, compute_dtype=None) -> dict:
    """WDNO's training step as shipped (phase wdno_train_f32: the TA
    kernels' tf32 variants) or with its denoiser in bf16 (wdno_train:
    mma): the loss and every gradient against the plain f32 step from the
    same weights, both at WDNO_CMP_BATCH with the same injected t and
    noise; then one counted step at batch 16 through make_train_step (its
    own draws, exact TA counts) and, in f32, one timed window; returns the
    counted step's launch counts."""
    from realpdebench_tpu_torch.config import load_config

    path, tc, reduced = _unet_path(compute_dtype, "wdno_train")
    model = _wdno(dev, compute_dtype)
    ref_model = _wdno(dev)
    ref_model.load_state_dict(model.state_dict(), strict=True)
    g, x, y = _wdno_inputs(dev, WDNO_BATCH, 10)
    n = WDNO_CMP_BATCH
    t = torch.randint(0, model.num_timesteps, (n,), generator=g, device=dev)
    noise = torch.randn(n, *model.model_shape, model.channels, generator=g, device=dev)

    def loss_and_grads(m, reference):
        m.zero_grad(set_to_none=True)
        loss = m.loss(x[:n], y[:n], t=t, noise=noise, reference=reference)
        loss.backward()
        out = loss.item(), _grads(m)
        m.zero_grad(set_to_none=True)
        return out

    torch.cuda.reset_peak_memory_stats()
    ref_loss, ref_grads = loss_and_grads(ref_model, True)
    del ref_model
    loss, grads = loss_and_grads(model, False)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    lim_loss, lim_grad = (UNET_LOSS_REL, UNET_GRAD_REL_L2) if compute_dtype \
        else (UNET_F32_LOSS_REL, UNET_F32_GRAD_REL_L2)
    cmp = dict(batch=n, loss=loss, ref_loss=ref_loss,
               loss_rel=abs(loss - ref_loss) / abs(ref_loss), limit_loss_rel=lim_loss,
               limit_grad_rel_l2=lim_grad,
               grad_rel_l2={k: _rel_l2(grads[k], r) for k, r in ref_grads.items()})
    cmp["worst_grad_rel_l2"] = max(cmp["grad_rel_l2"].values())
    bad = [] if cmp["loss_rel"] <= lim_loss else ["loss"]
    bad += [k for k, r in cmp["grad_rel_l2"].items() if not r <= lim_grad]
    if bad:
        raise AssertionError(f"{path}: kernel WDNO step vs f32 plain step: {bad}: {cmp}")
    del grads, ref_grads
    _free()

    opt = build_optimizer(_train_cfg(load_config(WDNO_CONFIG).to_dict()), model.parameters())
    step = make_train_step(model, IdentityNormalizer(), opt)
    # the main path, counted: nothing but this step between reset and read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    first = step(x, y).item()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH[path] = _expect(
        launches, f"one WDNO training step ({path})",
        variants=dict(ta_fwd={tc: WDNO_TA_PER_FORWARD}, ta_bwd={tc: WDNO_TA_PER_FORWARD}),
        ta_fwd=WDNO_TA_PER_FORWARD, ta_bwd=WDNO_TA_PER_FORWARD)
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    rate = last = None
    if not compute_dtype:
        torch.cuda.reset_peak_memory_stats()
        rate, last = _steps_per_s(step, x, y, WDNO_WINDOW_STEPS)
        BARE_STEPS_PER_S[path] = rate
    if not all(v == v and abs(v) < float("inf") for v in (first, last or 0.0)):
        raise AssertionError(f"{path}: losses {first}, {last} are not finite")
    emit(dict(phase=path, batch=WDNO_BATCH, launches=launches,
              variants=VARIANTS_BY_PATH[path], vs_plain_f32=cmp, first_step_s=first_s,
              window_steps=WDNO_WINDOW_STEPS if rate else 0, steps_per_s=rate,
              frames_per_s=rate * WDNO_BATCH * WDNO_SHAPE[0] if rate else None,
              losses=[first, last], remat=model.remat, peak_mem_first_step_gb=first_peak,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if rate else first_peak,
              peak_mem_with_plain_step_gb=ref_peak, reduced=reduced))
    return launches


def phase_wdno_sample(dev, compute_dtype=None) -> dict:
    """WDNO's DDIM sample (10 steps, eta 1) as shipped (wdno_sample_f32: a
    counted, timed sample at batch 16 from the model's own draws) or in
    bf16 (wdno_sample), each against the plain f32 sample on the same
    injected draws at WDNO_SAMPLE_CMP_BATCH (WDNO_F32_SAMPLE,
    WDNO_BF16_SAMPLE) and its first forward alone against the plain one
    (UNET_F32_ROLLOUT; bf16 the UNet rollout's limits); returns the counted
    sample's launch counts (bf16: the compared one's)."""
    path, tc, reduced = _unet_path(compute_dtype, "wdno_sample")
    model = _wdno(dev, compute_dtype)
    g, x, _ = _wdno_inputs(dev, WDNO_BATCH, 11)
    per_sample = WDNO_TA_PER_FORWARD * WDNO_SAMPLE_STEPS
    secs = None

    def counted(fn, what):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        VARIANTS_BY_PATH[path] = _expect(launches, what, variants=dict(ta_fwd={tc: per_sample}),
                                         ta_fwd=per_sample)
        return out, launches, time.perf_counter() - t0

    if not compute_dtype:
        # the main path, counted and timed: one sample at batch 16
        torch.cuda.reset_peak_memory_stats()
        pred, launches, secs = counted(lambda: model.predict(x),
                                       f"one WDNO sample at batch {WDNO_BATCH} ({path})")
        if tuple(pred.shape) != (WDNO_BATCH, *WDNO_SHAPE) or not bool(torch.isfinite(pred).all()):
            raise AssertionError(f"{path}: sample {tuple(pred.shape)} or not finite")
        del pred
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = WDNO_SAMPLE_CMP_BATCH
    draws = [torch.randn(n, *model.model_shape, model.channels, generator=g, device=dev)
             for _ in range(model.n_draws())]
    ref_model = _wdno(dev).eval()
    ref_model.load_state_dict(model.state_dict(), strict=True)
    # both sides with cuDNN's deterministic algorithms: its default f32 ones
    # differ from call to call, which the first DDIM step amplifies, so the
    # comparison would read otherwise on every run
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            got, small, _ = counted(lambda: model.sample(x[:n], draws=draws),
                                    f"one WDNO sample at batch {n} ({path})")
            if compute_dtype:
                launches = small
            ref = ref_model.sample(x[:n], draws=draws, reference=True)
            cond = model.to_coef_tensor(x[:n])[..., : 8 * model.c_in]
            state = model.set_conditions(draws[0], cond)
            eps, eps_ref = model.model(state), ref_model.model(state, reference=True)
    finally:
        torch.backends.cudnn.deterministic = False
    dist = lambda a, b: dict(rel_l2=_rel_l2(a, b),
                             max_abs_over_max_ref=((a - b).abs().max() / b.abs().max()).item())
    lim = WDNO_BF16_SAMPLE if compute_dtype else WDNO_F32_SAMPLE
    lim_eps = (UNET_ROLLOUT_REL_L2, UNET_ROLLOUT_MAX) if compute_dtype else UNET_F32_ROLLOUT
    row = dict(batch=n, sample=dist(got, ref), limit_sample=lim, first_forward=dist(eps, eps_ref),
               limit_first_forward=lim_eps, ref_abs_max=ref.abs().max().item())
    bad = [k for k, (a, b) in (("sample", lim), ("first_forward", lim_eps))
           if not (row[k]["rel_l2"] <= a and row[k]["max_abs_over_max_ref"] <= b)]
    if bad:
        raise AssertionError(f"{path}: kernel WDNO sample vs f32 plain sample: {bad}: {row}")
    emit(dict(phase=path, batch=WDNO_BATCH if secs else n, ddim_steps=WDNO_SAMPLE_STEPS,
              eta=model.ddim_eta, launches=launches, variants=VARIANTS_BY_PATH[path],
              vs_plain_f32=row, sample_s=secs,
              frames_per_s=WDNO_BATCH * WDNO_SHAPE[0] / secs if secs else None,
              peak_mem_gb=peak, reduced=reduced))
    return launches


def phase_gk_scores(dev) -> dict:
    """The scores kernel against its twin at the cylinder width; returns its
    summary (bf16 errors and times: the dtype of the main path)."""
    B, N, h, d = GK_SCORES_SHAPE
    eps = GK_MODEL["norm_eps"]
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(8)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        k = rn(B, N, h * d)
        v = (0.5 * k + rn(B, N, h * d)).to(dtype)     # correlated, as q/k/v are
        k = k.to(dtype)
        aff = [1 + 0.1 * rn(h, d), 0.1 * rn(h, d), 1 + 0.1 * rn(h, d), 0.1 * rn(h, d)]
        run = lambda **kv: kernels.gk_scores(k, v, *aff, heads=h, eps=eps, **kv)
        plain = lambda: tga.galerkin_scores_plain(k, v, *aff, h, eps)
        chosen = kernels.gk_scores_variant(dtype, d)
        other = "fma" if chosen == "mma" else "mma"
        ref = plain()
        got = run_as("gk_scores", chosen, run)
        alt = run_as("gk_scores", other, lambda: run(variant=other))
        rows = [compare("gk_scores", got, ref, GK_SCORES_TOL),
                compare(f"gk_scores_{other}", alt, ref, GK_SCORES_TOL),
                compare(f"gk_scores/vs_{other}", got, alt, GK_SCORES_TOL)]
        same = torch.equal(got, run()) and torch.equal(alt, run(variant=other))
        if not same:
            raise AssertionError(f"two identical gk_scores calls differ ({dtype})")
        del ref, alt
        # the training step's forward and backward of the scores: the kernel,
        # then autograd through the plain recompute (the JAX custom_vjp's)
        leaves = [t.detach().requires_grad_() for t in (k, v, *aff)]
        ct = rn(B, h, d, d)
        fwd_bwd = lambda: torch.autograd.grad(
            tga.galerkin_scores(*leaves, h, eps), leaves, ct)
        times = (queued_ms([run], n=8, reps=5), cuda_ms(plain, reps=5),
                 cuda_ms(fwd_bwd, reps=5), queued_ms([lambda: run(variant=other)], n=8, reps=5),
                 cuda_ms(run))
        # the products: 2·d·d per (token, head); LayerNorm's few operations
        # per element are left out
        work = bound(nbytes(k, v, *aff, got), 2 * B * N * h * d * d, dtype)
        emit(dict(phase="gk_scores", dtype=str(dtype).replace("torch.", ""),
                  shapes=dict(B=B, N=N, h=h, d=d), variant=chosen, checks=rows,
                  bitwise_repeatable=same,
                  ms=dict(kernel=times[0], plain=times[1], library=None,
                          kernel_fwd_plain_bwd=times[2], **{f"{other}_variant": times[3]},
                          single_launch=times[4], **work)))
        if dtype == torch.bfloat16:
            summary = dict(max_abs_err=max(r["max_abs_err"] for r in rows),
                           max_rel_err=max(r["max_rel_err"] for r in rows),
                           ms=times[0], plain_ms=times[1], library_ms=None,
                           fwd_plain_bwd_ms=times[2], **{f"{other}_variant_ms": times[3]},
                           single_launch_ms=times[4], **work)
        del k, v, got, leaves
        torch.cuda.empty_cache()
    return {"gk_scores": summary}


def _gk(dev, compute_dtype=None):
    return build_model(shapes=(GK_SHAPE, GK_SHAPE), compute_dtype=compute_dtype,
                       device=dev, generator=make_generator(0), **GK_MODEL)


def _gk_path(compute_dtype, base: str) -> str:
    return base if compute_dtype else f"{base}_f32"


def phase_gk_rollout(dev, norm, compute_dtype="bfloat16") -> dict:
    """The GK's 1-step rollout in bf16 (phase gk_rollout) or, with
    ``compute_dtype`` None, in f32 as shipped (gk_rollout_f32: the scores in
    f32, within KERNEL_TOL's f32 bound of the plain f32 rollout); returns
    the launch counts of the counted rollout."""
    path = _gk_path(compute_dtype, "gk_rollout")
    model = _gk(dev, compute_dtype).eval()
    g = torch.Generator(device=dev).manual_seed(9)
    x_raw = torch.randn(GK_BATCH, *GK_SHAPE, generator=g, device=dev)
    y_raw = torch.randn(GK_BATCH, GK_SHAPE[0] * GK_STEPS, *GK_SHAPE[1:], generator=g,
                        device=dev)
    rollout = make_rollout_fn(model, norm, GK_STEPS)

    # the main path, counted: nothing but this run between reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred, _, _ = rollout(x_raw, y_raw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_scores = GK_MODEL["num_encoder_layers"] * GK_STEPS
    VARIANTS_BY_PATH[path] = _expect(
        launches, f"a {GK_STEPS}-step GK rollout ({path})",
        variants=dict(gk_scores={"mma": n_scores}), gk_scores=n_scores)
    want = (GK_BATCH, GK_STEPS * GK_SHAPE[0], *GK_SHAPE[1:])
    if tuple(pred.shape) != want or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"GK rollout output {tuple(pred.shape)} (want {want}) "
                             "or not finite")

    ref_model = _gk(dev).eval()
    ref_model.load_state_dict(model.state_dict(), strict=True)
    ref, _, _ = make_rollout_fn(_PlainPath(ref_model), norm, GK_STEPS)(x_raw, y_raw)
    rel_l2 = ((pred - ref).norm() / ref.norm()).item()
    max_rel = ((pred - ref).abs().max() / ref.abs().max()).item()
    lim_l2, lim_max = (GK_ROLLOUT_REL_L2, GK_ROLLOUT_MAX) if compute_dtype \
        else (KERNEL_TOL[torch.float32],) * 2
    row = dict(rel_l2=rel_l2, limit_rel_l2=lim_l2, max_abs_over_max_ref=max_rel,
               limit_max=lim_max, ref_abs_max=ref.abs().max().item())
    if not (rel_l2 <= lim_l2 and max_rel <= lim_max):
        raise AssertionError(f"{path}: kernel GK rollout vs f32 plain rollout: {row}")
    del ref_model, ref, pred
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(GK_ROLLOUTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(x_raw, y_raw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    emit(dict(phase=path, batch=GK_BATCH, steps=GK_STEPS, shape=list(want),
              launches=launches, variants=VARIANTS_BY_PATH[path], vs_plain_f32=row,
              first_rollout_s=first_s, rollout_s=secs, frames_per_s=GK_BATCH * want[1] / med,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    return launches


def _gk_grad_checks(grads, ref_grads) -> tuple:
    """(relative L2 of each gradient, the zero-gradient entries' worst share
    of their scale); the true zeros are held apart."""
    rel, zero = {}, {}
    for name, gr in ref_grads.items():
        got = grads[name]
        if name.startswith("regressor.convs.") and name.endswith(".bias"):
            scale = ref_grads[name[:-4] + "weight"].abs().max().item()
            zero[name] = max(got.abs().max().item(), gr.abs().max().item()) / scale
            continue
        if name.startswith("regressor.spectral_conv.") and name.endswith(".weights1"):
            dc = (slice(None), slice(None), 0, 0, 0)
            scale = torch.view_as_real(gr).abs().max().item()
            zero[name + "[DC].imag"] = max(got[dc].imag.abs().max().item(),
                                           gr[dc].imag.abs().max().item()) / scale
            got, gr = got.clone(), gr.clone()
            got[dc] = got[dc].real.to(got.dtype)
            gr[dc] = gr[dc].real.to(gr.dtype)
        rel[name] = _rel_l2(got, gr)
    return rel, zero


def phase_gk_train(dev, norm, compute_dtype="bfloat16") -> dict:
    """The Galerkin Transformer's training step through make_train_step, in
    bf16 (phase gk_train) or, with ``compute_dtype`` None, in f32 as shipped
    (gk_train_f32: the scores in f32, the loss and gradients within
    F32_LIMITS of the plain f32 step; at the shipped batch 16, where an
    out-of-memory error fails the run); returns the launch counts of the
    counted step."""
    path = _gk_path(compute_dtype, "gk_train")
    batch = GK_BATCH
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(batch, *GK_SHAPE, generator=g, device=dev)
    y = torch.randn(batch, *GK_SHAPE, generator=g, device=dev)
    model = _gk(dev, compute_dtype)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    opt = build_optimizer(GK_TRAIN_CFG, model.parameters())
    step = make_train_step(model, norm, opt, grad_accum=1)

    # the main path, counted: nothing but this step between reset and read
    model.reseed_dropout(GK_DROPOUT_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y).item()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_scores = GK_MODEL["num_encoder_layers"]
    VARIANTS_BY_PATH[path] = _expect(
        launches, f"one GK training step ({path})",
        variants=dict(gk_scores={"mma": n_scores}), gk_scores=n_scores)
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    if not loss == loss or abs(loss) == float("inf"):
        raise AssertionError(f"GK training loss {loss} is not finite")

    # the counted step against the plain f32 path from the weights before
    # the step, with the same dropout masks
    xn, yn = norm.preprocess(x, y)
    grads = _grads(model)
    ref_model = _gk(dev)
    ref_model.load_state_dict(init, strict=True)
    ref_model.reseed_dropout(GK_DROPOUT_SEED)
    ref_loss, ref_grads = _plain_grads(ref_model, xn, yn)
    del ref_model, init
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    rel, zero = _gk_grad_checks(grads, ref_grads)
    lim_loss, lim_grad = (GK_LOSS_REL, GK_GRAD_REL_L2) if compute_dtype else F32_LIMITS[:2]
    cmp = dict(batch=batch, loss=loss, ref_loss=ref_loss, loss_rel=loss_rel,
               limit_loss_rel=lim_loss, grad_rel_l2=rel,
               limit_grad_rel_l2=lim_grad, zero_grads=zero,
               limit_zero_grad=TRAIN_ZERO_GRAD, worst_grad_rel_l2=max(rel.values()))
    bad = [] if loss_rel <= lim_loss else ["loss"]
    bad += [k for k, r in rel.items() if not r <= lim_grad]
    bad += [k for k, r in zero.items() if not r <= TRAIN_ZERO_GRAD]
    if bad:
        raise AssertionError(f"{path}: kernel GK step vs f32 plain step: {bad}: {cmp}")
    del ref_grads, grads
    torch.cuda.empty_cache()

    # determinism: the same forward-backward twice, bit for bit, the dropout
    # stream restarted before each
    rep = []
    for _ in range(2):
        opt.zero_grad()
        model.reseed_dropout(GK_DROPOUT_SEED)
        rep_loss = model.loss(xn, yn)
        rep_loss.backward()
        rep.append((rep_loss.detach(), _grads(model)))
    same = torch.equal(rep[0][0], rep[1][0]) and all(
        torch.equal(rep[0][1][k], rep[1][1][k]) for k in rep[0][1])
    if not same:
        raise AssertionError("two identical GK forward-backward passes differ")
    del rep, rep_loss
    torch.cuda.empty_cache()

    for _ in range(WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = zip(*(_steps_per_s(step, x, y, GK_WINDOW_STEPS)
                          for _ in range(GK_WINDOWS)))
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"GK training losses {losses} are not finite")
    med = statistics.median(rates)
    BARE_STEPS_PER_S[path] = med
    reduced = {} if batch == GK_BATCH else dict(batch=dict(here=batch, shipped=GK_BATCH))
    if compute_dtype:
        reduced["compute_dtype"] = dict(here=compute_dtype, shipped=None)
    emit(dict(phase=path, batch=batch, cfg=GK_TRAIN_CFG, launches=launches,
              variants=VARIANTS_BY_PATH[path], vs_plain_f32=cmp, bitwise_repeatable=same,
              first_step_s=first_s, window_steps_per_s=list(rates), steps_per_s=med,
              frames_per_s=med * batch * GK_SHAPE[0], losses=list(losses),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_first_step_gb=first_peak,
              peak_mem_with_plain_step_gb=ref_peak, reduced=reduced))
    phase_profile(step, x, y, "gk_profile" if compute_dtype else "gk_f32_profile")
    return launches


def _family_cfg(family: str) -> dict:
    """The family's shipped cylinder config (the port's copy)."""
    from realpdebench_tpu_torch.config import load_config

    return load_config(f"cylinder/{family}.yaml").to_dict()


def _family(dev, family: str, compute_dtype=None, state=None):
    """The family at its shipped cylinder config and full width, weights from
    make_generator(0) (or ``state``); compute_dtype "float64" gives the f64
    reference copy (``.double()``, everything computed in f64)."""
    kw = _family_cfg(family)
    kw.pop("compute_dtype")
    f64 = compute_dtype == "float64"
    # weights that ``state`` replaces are drawn where the model is built
    model = build_model(shapes=(FAMILY_SHAPE, FAMILY_SHAPE), device=dev,
                        compute_dtype=None if f64 else compute_dtype,
                        generator=make_generator(0) if state is None else None, **kw)
    if state is not None:
        model.load_state_dict(state, strict=True)
    if f64:
        model.double()
        model.compute_dtype = torch.float64
    return model


def _family_pass(model, xn, yn) -> tuple:
    """One forward-backward in train mode from zeroed gradients, the dropout
    stream restarted: (loss, gradients, running statistics)."""
    model.train()
    model.zero_grad(set_to_none=True)
    model.reseed_dropout(FAMILY_DROPOUT_SEED)
    if model.compute_dtype == torch.float64:
        xn, yn = xn.double(), yn.double()
    loss = model.loss(xn, yn)
    loss.backward()
    stats = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    return loss.detach(), _grads(model), stats


class Kinks:
    """The kinks of a model's piecewise-linear activations held fixed
    between two passes: CNO's LeakyReLUs, MWT's ReLUs, the filtered leaky
    ReLU of CNO's lrelu mode. A pre-activation within rounding of 0 takes
    the other slope in float32 than in float64, and the gradient flowing
    back through it moves by the slopes' difference: over a full-width step
    that puts the float32 gradients 1e-3 to 5e-3 relative L2 from float64's
    (the first card runs: CNO 4.8e-3, MWT 1.0e-3, cno_lrelu 2.5e-4; on
    the CPU CNO's is 4.5e-3 at 4x16x32 windows, and 1e-5 with SiLU in place
    of LeakyReLU). Inside ``record()`` each activation's choice of side runs
    through torch.where (where(x > 0, x, slope·x) for the (Leaky)ReLUs,
    which is them bit for bit, forward and backward) and keeps the
    condition, in call order (the forward's, then the checkpoints'
    recomputes); inside ``replay()`` a later pass (the float64 copy's)
    takes the same sides, so that both compute the same piecewise-linear
    function. ``PATCHES``: the module, its attribute that the activation is
    looked up on, and the activation's name there."""

    PATCHES = {"cno": ("models.cno", "F", "leaky_relu"), "mwt": ("models.mwt", "F", "relu"),
               "cno_lrelu": ("ops.filtered_lrelu", "torch", "where")}

    def __init__(self, key: str):
        import importlib

        module, self.attr, self.name = self.PATCHES[key]
        self.module = importlib.import_module(f"realpdebench_tpu_torch.{module}")
        self.sides, self.used = [], 0

    @contextlib.contextmanager
    def _patched(self, side):
        owner, name = getattr(self.module, self.attr), self.name
        if name == "where":
            act = lambda cond, x, other: torch.where(side(cond), x, other)
        else:
            act = lambda x, negative_slope=0.0: torch.where(side(x > 0), x,
                                                           x * negative_slope)

        class Shim:
            def __getattr__(self, key):
                return act if key == name else getattr(owner, key)

        with mock.patch.object(self.module, self.attr, Shim()):
            yield

    def record(self):
        def side(cond):
            self.sides.append(cond)
            return cond
        return self._patched(side)

    @contextlib.contextmanager
    def replay(self):
        def side(cond):
            self.used += 1
            return self.sides[self.used - 1]
        with self._patched(side):
            yield
        if self.used != len(self.sides):
            raise AssertionError(f"replayed {self.used} of {len(self.sides)} {self.name}s")


def _f32_vs_f64(path: str, family: str, kinks_key: str, model, ref_model, xn, yn) -> dict:
    """One f32 forward-backward of ``model`` against its float64 copy
    ``ref_model`` (same weights) within F32_LIMITS, on the same activation
    sides (``Kinks``): the pass that records them is the plain f32 pass bit
    for bit (cuDNN held to deterministic algorithms for the two); beside it
    the float64 copy with its own sides within FAMILY_FREE_KINKS."""
    kinks = Kinks(kinks_key)
    state = {k: t.clone() for k, t in model.state_dict().items()}

    def run(m):                 # every pass from the same weights and statistics
        m.load_state_dict(state, strict=True)
        return _family_pass(m, xn, yn)

    torch.backends.cudnn.deterministic = True
    try:
        plain = run(model)
        with kinks.record():
            got = run(model)
    finally:
        torch.backends.cudnn.deterministic = False
    if not (torch.equal(plain[0], got[0])
            and all(torch.equal(plain[1][k], got[1][k]) for k in got[1])):
        raise AssertionError(f"{path}: the recording pass is not the f32 pass")
    del plain
    free = run(ref_model)
    with kinks.replay():
        ref = run(ref_model)
    cmp = _family_vs(path, family, got, ref, F32_LIMITS)
    cmp["free_kinks"] = _family_vs(path, family, got, free,
                                   (F32_LIMITS[0], FAMILY_FREE_KINKS, F32_LIMITS[2]))
    cmp["kinks_replayed"] = len(kinks.sides)
    cmp["recording_pass_bit_equal"] = True      # (raised above otherwise)
    return cmp


def _zero_grad(family: str, name: str) -> bool:
    """The conv biases a BatchNorm follows, which it cancels (true gradient
    0): DeepONet's branch, every CNO block's but lift's and project's."""
    if family == "deeponet":
        return name.startswith("branch.conv") and name.endswith(".0.bias")
    if family == "cno":
        return not name.startswith(("lift.", "project.")) and name.endswith(
            ("convolution.bias", "convolution1.bias", "convolution2.bias"))
    return False


def _family_vs(path, family, got, ref, limits, prefix_limits=None,
               zero_limit=TRAIN_ZERO_GRAD) -> dict:
    """A family step's (loss, gradients, statistics) against the reference's
    within ``limits`` (loss relative, gradients and statistics relative L2;
    ``prefix_limits``: parameter-name prefix → its gradients' own limit);
    the conv biases a BatchNorm cancels (``_zero_grad``) held to
    ``zero_limit`` of their conv weight's largest gradient."""
    (loss, grads, stats), (ref_loss, ref_grads, ref_stats) = got, ref
    lim_loss, lim_grad, lim_stats = limits
    prefix_limits = prefix_limits or {}
    grad_limit = lambda name: next((v for k, v in prefix_limits.items()
                                    if name.startswith(k)), lim_grad)
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    rel, zero = {}, {}
    for name, gr in ref_grads.items():
        if _zero_grad(family, name):
            scale = ref_grads[name[:-4] + "weight"].abs().max().item()
            zero[name] = max(grads[name].abs().max().item(), gr.abs().max().item()) / scale
            continue
        rel[name] = _rel_l2(grads[name], gr)
    srel = {n: _rel_l2(stats[n], r) for n, r in ref_stats.items()}
    cmp = dict(loss=loss.item(), ref_loss=ref_loss.item(), loss_rel=loss_rel,
               limit_loss_rel=lim_loss, worst_grad_rel_l2=max(rel.values()),
               limit_grad_rel_l2=lim_grad, limit_grad_rel_l2_by_prefix=prefix_limits,
               grad_rel_l2=rel, zero_grads=zero, limit_zero_grad=zero_limit,
               stats_rel_l2=srel, limit_stats_rel_l2=lim_stats)
    bad = [] if loss_rel <= lim_loss else ["loss"]
    bad += [k for k, r in rel.items() if not r <= grad_limit(k)]
    bad += [k for k, r in zero.items() if not r <= zero_limit]
    bad += [k for k, r in srel.items() if not r <= lim_stats]
    if bad:
        raise AssertionError(f"{path}: step vs its reference: {bad}: {cmp}")
    return cmp


def phase_family_train(dev, norm, family: str, compute_dtype=None) -> dict:
    """The training step of ``family`` (deeponet, transolver) at its shipped
    cylinder config and batch, through make_train_step: in f32 as shipped
    ({family}_train_f32: the loss, every gradient and the running
    statistics within F32_LIMITS of a float64 copy of the same weights and
    batch at FAMILY_CMP_BATCH; two passes bit-equal under
    cudnn.deterministic; then a profile) or in bf16 ({family}_train: within
    the bf16 limits of the f32 step at FAMILY_CMP_BATCH). No kernel of the
    port's runs: every count stays 0. The step runs at the shipped batch
    with grad_accum 1; an out-of-memory error fails the run. Returns the
    launch counts of the counted step."""
    path = f"{family}_train" if compute_dtype else f"{family}_train_f32"
    cfg = _family_cfg(family)
    batch = int(cfg["train_batch_size"])
    train_cfg = _train_cfg(cfg)
    reduced = {} if compute_dtype is None else dict(
        compute_dtype=dict(here=compute_dtype, shipped=None))
    cuts = FAMILY_CUTS.get(family, {})
    windows, window_steps = cuts.get("windows", FAMILY_WINDOWS)
    if "windows" in cuts:
        reduced["timing"] = dict(here=f"{windows} window of {window_steps} steps",
                                 other_families=f"{FAMILY_WINDOWS[0]} windows of "
                                                f"{FAMILY_WINDOWS[1]} steps")
    model = _family(dev, family, compute_dtype)
    init = {k: t.clone() for k, t in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(batch, *FAMILY_SHAPE, generator=g, device=dev)
    y = torch.randn(batch, *FAMILY_SHAPE, generator=g, device=dev)
    opt = build_optimizer(train_cfg, model.parameters())
    step = make_train_step(model, norm, opt, grad_accum=1)
    # the main path, counted: nothing but this step between reset and read
    model.reseed_dropout(FAMILY_DROPOUT_SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y).item()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH[path] = _expect(launches, f"one {family} training step ({path})")
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    if not loss == loss or abs(loss) == float("inf"):
        raise AssertionError(f"{path}: training loss {loss} is not finite")

    # the step's arithmetic against its reference from the weights before
    # the step, at FAMILY_CMP_BATCH, with the same dropout masks: f32 against
    # a float64 copy, bf16 against f32
    n = FAMILY_CMP_BATCH
    xn, yn = norm.preprocess(x[:n], y[:n])
    if compute_dtype is None and family in Kinks.PATCHES:
        cmp = _f32_vs_f64(path, family, family, _family(dev, family, None, init),
                          _family(dev, family, "float64", init), xn, yn)
    elif compute_dtype is None:
        got = _family_pass(_family(dev, family, compute_dtype, init), xn, yn)
        ref = _family_pass(_family(dev, family, "float64", init), xn, yn)
        cmp = _family_vs(path, family, got, ref, F32_LIMITS)
        del got, ref
    else:
        got = _family_pass(_family(dev, family, compute_dtype, init), xn, yn)
        ref = _family_pass(_family(dev, family, None, init), xn, yn)
        cmp = _family_vs(path, family, got, ref, (FAMILY_BF16_LOSS_REL,
                                                  FAMILY_BF16_GRAD_REL_L2, TRAIN_STATS_REL_L2),
                         FAMILY_BF16_PREFIX_LIMITS.get(family),
                         FAMILY_BF16_ZERO_GRAD.get(family, TRAIN_ZERO_GRAD))
        del got, ref
    cmp.update(batch=n, reference="float64" if compute_dtype is None else "float32")
    del init
    _free()

    same = None
    xn, yn = norm.preprocess(x, y)
    if compute_dtype is None and not cuts.get("repeat_batch", True):
        # the recording pass against the plain one, bit for bit (above)
        same = cmp.get("recording_pass_bit_equal")
        if same is not True:
            raise AssertionError(f"{path}: repeat_batch=False, but no recording pass was "
                                 "held bit for bit (a family without Kinks.PATCHES)")
        reduced["bitwise_repeat"] = dict(here=f"batch {n} (the recording pass)",
                                         other_families=f"batch {batch}")
    elif compute_dtype is None:
        # determinism: the same forward-backward twice (a microbatch of the
        # step's size), bit for bit, with cuDNN held to deterministic
        # algorithms
        torch.backends.cudnn.deterministic = True
        rep = [_family_pass(model, xn, yn) for _ in range(2)]
        torch.backends.cudnn.deterministic = False
        same = torch.equal(rep[0][0], rep[1][0]) and all(
            torch.equal(rep[0][1][k], rep[1][1][k]) for k in rep[0][1])
        if not same:
            raise AssertionError(f"{path}: two identical forward-backward passes differ")
        del rep
        _free()

    for _ in range(cuts.get("warmup", WARMUP)):
        step(x, y)
    if "warmup" in cuts:
        reduced["warmup_steps"] = dict(here=cuts["warmup"], other_families=WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = zip(*(_steps_per_s(step, x, y, window_steps) for _ in range(windows)))
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"{path}: training losses {losses} are not finite")
    med = statistics.median(rates)
    BARE_STEPS_PER_S[path] = med
    if family in DPOT_FAMILIES:
        BACKBONES[family] = save_backbone(model)
    emit(dict(phase=path, config=f"cylinder/{family}.yaml", batch=batch, grad_accum=1,
              cfg=train_cfg, launches=launches, vs_reference=cmp, bitwise_repeatable=same,
              first_step_s=first_s, window_steps_per_s=list(rates), steps_per_s=med,
              frames_per_s=med * batch * FAMILY_SHAPE[0], losses=list(losses),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_first_step_gb=first_peak, reduced=reduced))
    if compute_dtype is None:
        phase_profile(step, x, y, f"{family}_f32_profile")
    del model, step, opt
    _free()
    return launches


def _chunked_rollout(model, norm, n_steps, x_raw, y_raw, chunk: int):
    rollout = make_rollout_fn(model, norm, n_steps)
    return torch.cat([rollout(x_raw[i:i + chunk], y_raw[i:i + chunk])[0]
                      for i in range(0, x_raw.shape[0], chunk)])


def phase_family_rollout(dev, norm, family: str, compute_dtype=None) -> dict:
    """The rollout of ``family`` at its shipped eval batch and
    N_autoregressive through make_rollout_fn: in f32 as shipped
    ({family}_rollout_f32: within FAMILY_F32_ROLLOUT of a float64 copy's
    rollout of the same inputs) or in bf16 ({family}_rollout: within the
    bf16 rollout limits of the f32 rollout); every kernel count 0;
    frames/s, peak memory. Returns the launch counts of the counted
    rollout."""
    path = f"{family}_rollout" if compute_dtype else f"{family}_rollout_f32"
    cfg = _family_cfg(family)
    batch, n_steps = int(cfg["test_batch_size"]), int(cfg["N_autoregressive"])
    model = _family(dev, family, compute_dtype).eval()
    g = torch.Generator(device=dev).manual_seed(14)
    x_raw = torch.randn(batch, *FAMILY_SHAPE, generator=g, device=dev)
    y_raw = torch.randn(batch, FAMILY_SHAPE[0] * n_steps, *FAMILY_SHAPE[1:], generator=g,
                        device=dev)
    rollout = make_rollout_fn(model, norm, n_steps)

    # the main path, counted: nothing but this run between reset and read
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred, _, _ = rollout(x_raw, y_raw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH[path] = _expect(launches, f"a {n_steps}-step {family} rollout ({path})")
    want = (batch, n_steps * FAMILY_SHAPE[0], *FAMILY_SHAPE[1:])
    if tuple(pred.shape) != want or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"{path}: output {tuple(pred.shape)} (want {want}) or not finite")

    cuts = FAMILY_CUTS.get(family, {})
    n_ref = cuts.get("ref_windows", batch)
    ref_model = _family(dev, family, "float64" if compute_dtype is None else None,
                        model.state_dict()).eval()
    ref = _chunked_rollout(ref_model, norm, n_steps, x_raw[:n_ref], y_raw[:n_ref],
                           FAMILY_CHUNK)
    pred = pred[:n_ref]
    rel_l2 = ((pred - ref).norm() / ref.norm()).item()
    max_rel = ((pred - ref).abs().max() / ref.abs().max()).item()
    lim_l2, lim_max = FAMILY_F32_ROLLOUT if compute_dtype is None \
        else (ROLLOUT_REL_L2, ROLLOUT_MAX)
    row = dict(reference="float64" if compute_dtype is None else "float32",
               windows=n_ref, rel_l2=rel_l2, limit_rel_l2=lim_l2, max_abs_over_max_ref=max_rel,
               limit_max=lim_max, ref_abs_max=ref.abs().max().item())
    if not (rel_l2 <= lim_l2 and max_rel <= lim_max):
        raise AssertionError(f"{path}: rollout vs its reference: {row}")
    del ref_model, ref, pred
    _free()

    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(cuts.get("rollouts", FAMILY_ROLLOUTS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(x_raw, y_raw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs or [first_s])      # no timed rollout: the counted one
    reduced = {} if compute_dtype is None else dict(
        compute_dtype=dict(here=compute_dtype, shipped=None))
    if n_ref < batch:
        reduced["reference_windows"] = dict(here=n_ref, other_families=batch)
    if "rollouts" in cuts:
        reduced["timed_rollouts"] = dict(here=cuts["rollouts"], other_families=FAMILY_ROLLOUTS)
    emit(dict(phase=path, config=f"cylinder/{family}.yaml", batch=batch, steps=n_steps,
              shape=list(want), launches=launches, vs_reference=row,
              first_rollout_s=first_s, rollout_s=secs, frames_per_s=batch * want[1] / med,
              peak_mem_gb=max(first_peak, torch.cuda.max_memory_allocated() / 1e9),
              reduced=reduced))
    del model, rollout
    _free()
    return launches


# the controls of FAMILY_FREE_KINKS and FAMILY_BF16_ZERO_GRAD (python3
# chip_smoke.py --limit-controls): CNO's f32 and bf16 steps at the
# phases' comparison batch, weights and inputs, sound and with a planted
# fault, and the f32 steps of CNO and MWT with TF32 on. The fault leaves
# one BatchNorm's batch statistics out: it normalises by its running
# statistics, at their initial 0 and 1, so the layer passes its input on
# and its conv bias takes a true gradient
CONTROL_BN = "res_nets.0.batch_norm1"


@contextlib.contextmanager
def _bn_left_out(model, name: str):
    """``model``'s BatchNorm ``name`` (a CNO's) on its running statistics in
    every pass, the checkpoints' recomputes included."""
    from realpdebench_tpu_torch.models import cno

    target, bn = model.get_submodule(name), cno._bn
    faulty = lambda m, x, o: bn(m, x, cno._Opts(o.dt, False, False) if m is target else o)
    with mock.patch.object(cno, "_bn", faulty):
        yield


def phase_limit_controls(dev, norm) -> None:
    """Each limit's sound reading beside readings of controls that it must
    fail (limit_controls): FAMILY_FREE_KINKS (the worst gradient's relative
    L2 of an f32 step against its float64 copy, each on its own activation
    sides) of CNO's and MWT's sound f32 steps, of both with cuDNN's and
    cuBLAS's TF32 on (and, beside it, the TF32 step against the float64
    copy on its sides, which F32_LIMITS hold), and of CNO's with
    CONTROL_BN left out;
    FAMILY_BF16_ZERO_GRAD (the largest gradient of a conv bias a BatchNorm
    cancels over its conv weight's largest) of CNO's sound bf16 step and of
    its step with CONTROL_BN left out, against the sound f32 step. Inputs
    and weights as phase_family_train's comparison. Raises where the
    planted fault passes its limit."""
    inf = float("inf")
    free = lambda got, ref: _family_vs("limit_controls", family, got, ref, (inf, inf, inf),
                                       zero_limit=inf)
    out = {}
    for family in ("cno", "mwt"):
        batch = int(_family_cfg(family)["train_batch_size"])
        g = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn(batch, *FAMILY_SHAPE, generator=g, device=dev)
        y = torch.randn(batch, *FAMILY_SHAPE, generator=g, device=dev)
        xn, yn = norm.preprocess(x[:FAMILY_CMP_BATCH], y[:FAMILY_CMP_BATCH])
        del x, y
        model = _family(dev, family)
        init = {k: t.clone() for k, t in model.state_dict().items()}

        def run(m, ctx=contextlib.nullcontext()):
            m.load_state_dict(init, strict=True)
            with ctx:
                return _family_pass(m, xn, yn)

        ref = _family(dev, family, "float64", init)
        f64 = run(ref)
        sound = run(model)
        kinks = Kinks(family)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            with kinks.record():
                tf32 = run(model)
        finally:
            set_f32_precision()
        with kinks.replay():
            same = run(ref)
        reads = dict(sound=free(sound, f64), tf32_on=free(tf32, f64),
                     tf32_on_same_sides=free(tf32, same))
        del tf32, same, ref, kinks
        if family == "cno":
            reads["bn_left_out"] = free(run(model, _bn_left_out(model, CONTROL_BN)), f64)
        row = {k: dict(worst_grad_rel_l2=v["worst_grad_rel_l2"], loss_rel=v["loss_rel"])
               for k, v in reads.items()}
        out[f"{family}_f32_free_kinks"] = dict(limit=FAMILY_FREE_KINKS, readings=row)
        if family == "cno":
            bf16 = _family(dev, family, "bfloat16", init)
            reads = dict(sound=free(run(bf16), sound), bn_left_out=free(
                run(bf16, _bn_left_out(bf16, CONTROL_BN)), sound))
            bias = CONTROL_BN.replace("batch_norm", "convolution") + ".bias"
            out["cno_bf16_zero_grad"] = dict(
                limit=FAMILY_BF16_ZERO_GRAD["cno"], planted_bias=bias,
                readings={k: dict(worst=max(v["zero_grads"].values()),
                                  planted_bias=v["zero_grads"][bias]) for k, v in reads.items()})
            del bf16
        del model, f64, sound, reads
        _free()
    emit(dict(phase="limit_controls", batch=FAMILY_CMP_BATCH, control_bn=CONTROL_BN, **out))
    fault_kinks = out["cno_f32_free_kinks"]["readings"]["bn_left_out"]["worst_grad_rel_l2"]
    fault_zero = out["cno_bf16_zero_grad"]["readings"]["bn_left_out"]["planted_bias"]
    if not (fault_kinks > FAMILY_FREE_KINKS and fault_zero > FAMILY_BF16_ZERO_GRAD["cno"]):
        raise AssertionError("a planted fault passes its limit: "
                             f"{fault_kinks}, {fault_zero}")


def phase_cno_lrelu(dev, norm) -> dict:
    """CNO's filtered activation on the card (cno_lrelu): CNO_LRELU_MODEL on
    the cylinder window, one training forward-backward at CNO_LRELU_BATCH
    in f32 against a float64 copy of the same weights and batch within
    F32_LIMITS on the same activation sides (``_f32_vs_f64``: loss,
    gradients, the activations' biases among them, and running
    statistics); every kernel count 0. Returns the launch counts."""
    shapes = (FAMILY_SHAPE, FAMILY_SHAPE)
    model = build_model(shapes=shapes, device=dev, generator=make_generator(0),
                        **CNO_LRELU_MODEL)
    ref = build_model(shapes=shapes, device=dev, **CNO_LRELU_MODEL)
    ref.load_state_dict(model.state_dict(), strict=True)
    ref.double()
    ref.compute_dtype = torch.float64
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(CNO_LRELU_BATCH, *FAMILY_SHAPE, generator=g, device=dev)
    y = torch.randn(CNO_LRELU_BATCH, *FAMILY_SHAPE, generator=g, device=dev)
    xn, yn = norm.preprocess(x, y)
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = _family_pass(model, xn, yn)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH["cno_lrelu"] = _expect(launches, "the lrelu CNO (cno_lrelu)")
    biases = [n for n in got[1] if n.endswith("activation.bias")]
    if not biases:
        raise AssertionError("cno_lrelu: no filtered activation with a bias")
    cmp = _f32_vs_f64("cno_lrelu", "cno", "cno_lrelu", model, ref, xn, yn)
    emit(dict(phase="cno_lrelu", model=CNO_LRELU_MODEL, batch=CNO_LRELU_BATCH,
              shape=list(FAMILY_SHAPE), parameters=sum(p.numel() for p in model.parameters()),
              activation_biases=len(biases), launches=launches, vs_reference=dict(
                  cmp, reference="float64"), forward_backward_s=secs,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              reduced=dict(config="a narrow CNO in the lrelu mode; every shipped config "
                                  "runs LeakyReLU")))
    del model, ref, got
    _free()
    return launches


def phase_geometries(dev) -> dict:
    """Every FNO kernel against its twin at the other shipped geometries
    (GEOMETRIES), each in the variant its dtype chooses (K1, K2, K2A-lite,
    K12B, K3F and K3B mma in bfloat16, tf32 in float32: every shipped
    geometry's block fits; asserted per call): K1, the four T-stage maps,
    K2, K2A and (where the geometry has lite statics) K2A-lite, K12B, K3F
    and K3B. Records which of K2A-lite and K2A the geometry's backward
    takes. A timed geometry's kernels are also timed (device time of queued
    launches) beside their bounds; returns {kernel: {ms, bound_ms, ...}} of
    those."""
    timed = {}
    for name, Cg, (m1, m2, m3), (T, H, W), F, B, dtypes, timing in GEOMETRIES:
        Tp, Hp, Wp = T + PAD, H + PAD, W + PAD
        BT = B * Tp
        geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
        cst = fl._ct_on(dev, Hp, Wp, m2, m3)
        lite = fl._lite_on(dev, Hp, Wp, m2, m3)
        for dtype in dtypes:
            g = torch.Generator(device=dev).manual_seed(5)
            rn = lambda *sh: torch.randn(*sh, generator=g, device=dev)
            tol = KERNEL_TOL[dtype]
            tc = "mma" if dtype == torch.bfloat16 else "tf32"  # asserted per call
            x = rn(BT, Hp * Wp // 2, 2 * Cg).to(dtype)
            a, b = 1 + 0.1 * rn(Cg), 0.1 * rn(Cg)
            wp, bp = rn(Cg, Cg) / Cg ** 0.5, 0.1 * rn(Cg)
            k1 = lambda: fl.k1(x, a, b, **geo, act="exact")
            y = run_as("k1", tc, k1)
            rows = [compare("k1", y, fl.k1_plain(x, a, b, cst, Hp=Hp, Wp=Wp, act="exact"), tol)]
            short = y[: B * 2 * m1].contiguous()
            maps = (("et", y), ("it", short), ("it_adj", y), ("et_adj", short))
            for kind, inp in maps:
                got = run_as("t_stage", "registers", lambda: fl.t_stage(inp, kind, Tp, m1))
                rows.append(compare(f"t_stage/{kind}", got,
                                    fl.t_stage_plain(inp, *fl._tmats_on(dev, kind, Tp, m1)), tol))
            gsp = rn(*y.shape).to(dtype)
            k2 = lambda: fl.k2(gsp, x, a, b, wp, bp, **geo, act="exact")
            s, st = run_as("k2", tc, k2)
            s_ref, st_ref = fl.k2_plain(gsp, x, a, b, wp, bp, cst, Hp=Hp, Wp=Wp, act="exact")
            sr = s_ref.float().view(-1, Cg)
            rows += [compare("k2/s", s, s_ref, tol),
                     compare_sums("k2/stats", st, st_ref,
                                  torch.stack([sr.abs().sum(0), (sr * sr).sum(0)]))]
            del s_ref, sr
            npos = BT * Hp * Wp
            ds, dy = (rn(*s.shape) / npos).to(dtype), (rn(*y.shape) / npos).to(dtype)
            ds1, ds2 = rn(Cg) / npos, rn(Cg) / npos
            full = fl.k2a(s, ds, ds1, ds2, **geo)
            rows.append(compare("k2a/dg", full, fl.k2a_plain(s, ds, ds1, ds2, cst, Hp=Hp, Wp=Wp),
                                tol))
            k2l = lambda: fl.k2a_lite(ds, gsp, y, ds1, ds2, wp, bp, **geo)
            if lite is not None:
                lg = run_as("k2a_lite", tc, k2l)
                rows += [compare("k2a_lite/dg", lg, fl.k2a_lite_plain(
                             ds, gsp, y, ds1, ds2, wp, bp, lite, cst, Hp=Hp, Wp=Wp), tol),
                         compare("k2a_lite/vs_k2a", lg, full, tol)]
                del lg
            k12 = lambda: fl.k12b(x, a, b, wp, s, ds, ds1, ds2, dy, **geo, act="exact")
            got = run_as("k12b", tc, k12)
            ref = fl.k12b_plain(x, a, b, wp, s, ds, ds1, ds2, dy, cst, Hp=Hp, Wp=Wp, act="exact")
            rows.append(compare("k12b/dx", got[0], ref[0], tol))
            terms = k12b_terms(x, a, b, s, ds, ds1, ds2, ref[0])
            for n, gv, rv, tv in zip(("dwp", "da", "db", "dbp"), got[1:], ref[1:], terms):
                rows.append(compare_sums(f"k12b/{n}", gv, rv, tv))
            del ref, terms
            kw = dict(dims=(B, Tp, Hp, Wp, Cg), tail_dims=(T, H, W), act="exact")
            tail = (rn(B, T, H, W, F), rn(Cg, 128) / Cg ** 0.5, 0.1 * rn(128),
                    rn(128, F) / 128 ** 0.5, 0.1 * rn(F))
            gl = torch.tensor(1.0 / (B * T * H * W * F), device=dev)
            k3f = lambda: ft.k3f(s, *tail, **kw)
            k3b = lambda: ft.k3b(s, *tail, gl, **kw)
            sse_ref = ft.k3f_plain(s, *tail, **kw)
            sse = run_as("k3f", tc, k3f)
            rows.append(compare_sums("k3f/sse", sse, sse_ref, sse_ref))
            tgot = run_as("k3b", tc, k3b)
            ref = ft.k3b_plain(s, *tail, gl, **kw)
            rows.append(compare("k3b/ds", tgot[0], ref[0], tol))
            terms = k3b_terms(s, tail, gl, kw["dims"], kw["tail_dims"])
            for n, gv, rv, tv in zip(("dk1", "db1", "dk2", "db2"), tgot[1:], ref[1:], terms):
                rows.append(compare_sums(f"k3b/{n}", gv, rv, tv))
            del ref, terms
            times = {}
            if timing:
                # each kernel's device time at this geometry beside its
                # bound, the work counted as at the cylinder's (§3)
                dft = dft_ops(BT, Cg, Hp, Wp, m2, m3)
                crop = B * T * H * W * Cg * s.element_size()
                fc = B * T * H * W * (2 * Cg * 128 + 2 * 128 * F)
                assert (Tp, m1) == (TP, M1)      # tstage_work's maps
                work = dict(
                    k1=(k1, bound(nbytes(x, a, b, y), dft, dtype, tc)),
                    t_stage=(lambda: [fl.t_stage(i, k, Tp, m1) for k, i in maps[:2]],
                             add_bounds(*(tstage_work(i, k, dtype)[0] for k, i in maps[:2]))),
                    k2=(k2, bound(nbytes(gsp, x, a, b, wp, bp, s, st),
                                  dft + npos * Cg * Cg * 2, dtype, tc)),
                    k12b=(k12, bound(nbytes(x, a, b, wp, s, ds, ds1, ds2, dy, *got),
                                     dft + 2 * npos * Cg * Cg * 2, dtype, tc)),
                    k3f=(k3f, bound(crop + nbytes(*tail, sse), fc, dtype, tc)),
                    k3b=(k3b, bound(crop + nbytes(*tail, gl, *tgot), 3 * fc, dtype, tc)))
                if lite is not None:
                    work["k2a_lite"] = (k2l, bound(
                        nbytes(ds, gsp, y, ds1, ds2, wp, bp, full),
                        dft + BT * 2 * (2 * m2 * m3) * Cg * Cg * 2, dtype, tc))
                for k, (fn, bd) in work.items():
                    times[k] = dict(ms=queued_ms([fn], n=8, reps=5), bound_ms=bd["bound_ms"],
                                    bound_by=bd["bound_by"], variant="registers"
                                    if k == "t_stage" else tc, shape=dict(
                                        BT=BT, Hp=Hp, Wp=Wp, C=Cg, F=F))
                timed.update({f"{k}": v for k, v in times.items()})
            torch.cuda.synchronize()
            emit(dict(phase="geometry", name=name, dtype=str(dtype).replace("torch.", ""),
                      shapes=dict(BT=BT, Hp=Hp, Wp=Wp, C=Cg, F=F, window=[T, H, W],
                                  modes=[m1, m2, m3]),
                      variants=dict(k1=tc, k2=tc, k2a_lite=tc, k12b=tc, k3f=tc, k3b=tc),
                      k2a_route="k2a_lite" if lite is not None else "k2a",
                      worst_rel=max(r.get("max_rel_err", r.get("max_rel_to_terms"))
                                    for r in rows),
                      times=times or None, checks=rows))
            del x, y, s, st, st_ref, gsp, ds, dy, full, got, tgot, sse, sse_ref
            torch.cuda.empty_cache()
    return timed


def phase_fsi_train(dev, norm) -> dict:
    """The fsi FNO's training step (FSI_MODEL at batch FSI_BATCH, Gaussian
    normalizer) in float32, the config's dtype, and in bfloat16: one counted
    step (exact launch and variant counts), the loss and every gradient at
    FSI_CMP_BATCH against the plain f32 step from the same weights, two
    forward-backward passes bit-equal, then FSI_WINDOWS windows of
    FSI_WINDOW_STEPS steps: steps/s and peak memory. Returns the launches
    of the two counted steps together."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(FSI_BATCH, *SHAPE_IN, generator=g, device=dev)
    y = torch.randn(FSI_BATCH, *SHAPE_OUT, generator=g, device=dev)
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    total_variants = {k: dict.fromkeys(v, 0) for k, v in kernels.VARIANTS.items()}
    for cdt in (None, "bfloat16"):
        dtype = torch.bfloat16 if cdt else torch.float32
        model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), compute_dtype=cdt, device=dev,
                            generator=make_generator(1), **FSI_MODEL)
        opt = build_optimizer(FSI_TRAIN_CFG, model.parameters())
        step = make_train_step(model, norm, opt, grad_accum=1)
        # the main path, counted: nothing but this step between reset and read
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if launches != TRAIN_LAUNCHES:
            raise AssertionError(f"one fsi step ({dtype}) launched {launches}, "
                                 f"expected {TRAIN_LAUNCHES}")
        # every FNO kernel but the T-stage: tf32 in f32 at C 128 too (the blocks fit)
        tc = "mma" if cdt else "tf32"
        variants = expect_variants(f"one fsi step ({dtype})", k1={tc: 4},
                                   t_stage={"registers": 16}, k2={tc: 4}, k2a_lite={tc: 4},
                                   k12b={tc: 4}, k3f={tc: 1}, k3b={tc: 1})
        first_peak = torch.cuda.max_memory_allocated() / 1e9
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"fsi training loss {loss.item()} is not finite")
        for k, n in launches.items():
            total[k] += n
        for k, counts in variants.items():
            for v, n in counts.items():
                total_variants[k][v] += n

        # the comparison at FSI_CMP_BATCH, fresh weights from the same seed
        cmp_model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), compute_dtype=cdt, device=dev,
                                generator=make_generator(1), **FSI_MODEL)
        ref_model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), device=dev, **FSI_MODEL)
        ref_model.load_state_dict(cmp_model.state_dict(), strict=True)
        xn, yn = norm.preprocess(x[:FSI_CMP_BATCH], y[:FSI_CMP_BATCH])
        closs = cmp_model.loss(xn, yn)
        closs.backward()
        ref_loss = ref_model(xn, y=yn, reference=True)
        ref_loss.backward()
        cmp = _fno_vs_plain(f"fsi {dtype} kernel step vs f32 plain step", FSI_CMP_BATCH,
                            closs, _grads(cmp_model), ref_loss, _grads(ref_model),
                            cmp_model, ref_model)
        del ref_model, ref_loss
        rep = []
        for _ in range(2):
            cmp_model.zero_grad()
            rep.append(cmp_model.loss(xn, yn))
            rep[-1].backward()
            rep.append(_grads(cmp_model))
        same = torch.equal(rep[0], rep[2]) and all(
            torch.equal(rep[1][n], rep[3][n]) for n in rep[1])
        if not same:
            raise AssertionError(f"two identical fsi forward-backward passes differ ({dtype})")
        del cmp_model, rep
        torch.cuda.empty_cache()

        step(x, y)   # warm-up
        rates, losses = [], []
        for _ in range(FSI_WINDOWS):
            rate, last = _steps_per_s(step, x, y, FSI_WINDOW_STEPS)
            rates.append(rate)
            losses.append(last)
        if not all(v == v and abs(v) < float("inf") for v in losses):
            raise AssertionError(f"fsi training losses {losses} are not finite")
        med = statistics.median(rates)
        emit(dict(phase="fsi_train", dtype=str(dtype).replace("torch.", ""), batch=FSI_BATCH,
                  model=FSI_MODEL, cfg=FSI_TRAIN_CFG, launches=launches, variants=variants,
                  vs_plain_f32=cmp, bitwise_repeatable=same, first_step_s=first_s,
                  window_steps_per_s=rates, steps_per_s=med,
                  frames_per_s=med * FSI_BATCH * SHAPE_OUT[0], losses=losses,
                  peak_mem_first_step_gb=first_peak,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
        del model, opt, step, loss
        torch.cuda.empty_cache()
    VARIANTS_BY_PATH["fsi_train"] = total_variants
    return total


def _surrogate_cfg(model: str) -> dict:
    """The surrogate's shipped config (the port's copy)."""
    from realpdebench_tpu_torch.config import load_config

    return load_config(f"combustion/surrogate_model/{model}.yaml").to_dict()


def surrogate_normalizer():
    """Gaussian normalizer with seeded statistics for the surrogate's 17
    input channels and 1 target channel."""
    r = np.random.default_rng(1)
    return build_normalizer("gaussian", stats=dict(
        mean_inputs=r.normal(size=17), std_inputs=r.uniform(0.5, 2.0, size=17),
        mean_targets=r.normal(size=1), std_targets=r.uniform(0.5, 2.0, size=1)))


def _surrogate_model(dev, model: str, state=None):
    cfg = _surrogate_cfg(model)
    m = build_model(shapes=(SURROGATE_IN, SURROGATE_OUT), device=dev,
                    generator=None if state is not None else make_generator(0), **cfg)
    if state is not None:
        m.load_state_dict(state, strict=True)
    return m


def _train_cfg(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("lr", "scheduler", "num_update", "step_size",
                                "clip_grad_norm")}


def _f32_fno_variants(counts: dict) -> dict:
    """Every FNO kernel's launches in its tf32 variant, the T-stage's in
    its registers one."""
    return {k: {"registers" if k == "t_stage" else "tf32": n} for k, n in counts.items() if n}


def phase_surrogate_fno_train(dev) -> dict:
    """The surrogate FNO's training step (modes 4/16/16, width 64, 4 layers,
    17 → 1 channels, batch 16, f32 as shipped) through make_train_step with
    a Gaussian normalizer: exact launch counts (every FNO kernel tf32 but
    the T-stage), the loss, every gradient and the running statistics
    within F32_LIMITS of the plain f32 step from the same weights, two
    passes bit-equal; steps/s, peak memory, then a profile. Returns the
    counted step's launches."""
    path = "surrogate_fno_train_f32"
    cfg = _surrogate_cfg("fno")
    batch, norm = int(cfg["train_batch_size"]), surrogate_normalizer()
    model = _surrogate_model(dev, "fno")
    ref_model = _surrogate_model(dev, "fno", model.state_dict())
    g = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(batch, *SURROGATE_IN, generator=g, device=dev)
    y = torch.randn(batch, *SURROGATE_OUT, generator=g, device=dev)
    opt = build_optimizer(_train_cfg(cfg), model.parameters())
    step = make_train_step(model, norm, opt, grad_accum=1)

    # the main path, counted: nothing but this step between reset and read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    want = {k: n for k, n in TRAIN_LAUNCHES.items() if n}
    VARIANTS_BY_PATH[path] = _expect(launches, f"one surrogate FNO step ({path})",
                                     variants=_f32_fno_variants(want), **want)
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    grads = _grads(model)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{path}: training loss {loss.item()} is not finite")

    xn, yn = norm.preprocess(x, y)
    ref_model.train()
    ref_loss = ref_model(xn, y=yn, reference=True)
    ref_loss.backward()
    cmp = _fno_vs_plain(f"{path}: kernel step vs f32 plain step", batch, loss, grads,
                        ref_loss, _grads(ref_model), model, ref_model, F32_LIMITS)
    del ref_model, ref_loss, grads
    _free()
    rep = []
    for _ in range(2):
        opt.zero_grad()
        rep.append(model.loss(xn, yn))
        rep[-1].backward()
        rep.append(_grads(model))
    same = torch.equal(rep[0], rep[2]) and all(torch.equal(rep[1][n], rep[3][n])
                                               for n in rep[1])
    if not same:
        raise AssertionError(f"{path}: two identical forward-backward passes differ")
    del rep
    windows, window_steps = SURROGATE_FNO_WINDOWS
    for _ in range(WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = zip(*(_steps_per_s(step, x, y, window_steps) for _ in range(windows)))
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"{path}: training losses {losses} are not finite")
    med = statistics.median(rates)
    BARE_STEPS_PER_S[path] = med
    emit(dict(phase=path, config="combustion/surrogate_model/fno.yaml", batch=batch,
              shape_in=list(SURROGATE_IN), shape_out=list(SURROGATE_OUT),
              cfg=_train_cfg(cfg), launches=launches, variants=VARIANTS_BY_PATH[path],
              vs_plain_f32=cmp, bitwise_repeatable=same, first_step_s=first_s,
              window_steps_per_s=list(rates), steps_per_s=med,
              frames_per_s=med * batch * SURROGATE_IN[0], losses=list(losses),
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_first_step_gb=first_peak))
    phase_profile(step, x, y, "surrogate_fno_f32_profile")
    del model, step, opt
    _free()
    return launches


def phase_surrogate_fno_rollout(dev) -> dict:
    """The generator's prediction (tools/generate_surrogate_data
    .surrogate_trajectory) of one SURROGATE_FRAMES-frame trajectory with the
    surrogate FNO in f32, windows of 20 frames: exact launch counts (K1
    and K2 tf32, the T-stage registers), within FAMILY_F32_ROLLOUT of the
    same prediction through the plain f32 path; frames/s."""
    from realpdebench_tpu_torch.tools.generate_surrogate_data import (
        surrogate_predictor,
        surrogate_trajectory,
    )

    path = "surrogate_fno_rollout_f32"
    norm = surrogate_normalizer()
    model = _surrogate_model(dev, "fno")
    T = SURROGATE_WINDOW[0]
    inp = np.random.default_rng(16).standard_normal(
        (SURROGATE_FRAMES, *SURROGATE_IN[1:]), dtype=np.float32)
    predict = surrogate_predictor(model, norm, dev)
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = surrogate_trajectory(predict, inp, T)
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n = -(-SURROGATE_FRAMES // T)                   # forwards, a partial tail included
    want = {k: n * v for k, v in PREDICT_LAUNCHES.items()}
    VARIANTS_BY_PATH[path] = _expect(launches, f"the surrogate prediction ({path})",
                                     variants=_f32_fno_variants(want), **want)
    if out.shape != (SURROGATE_FRAMES, *SURROGATE_WINDOW[1:]) or not np.isfinite(out).all():
        raise AssertionError(f"{path}: output {out.shape} or not finite")

    def plain(window):
        xw = torch.from_numpy(window).to(dev)
        xn, _ = norm.preprocess(xw, xw[..., :1])
        model.eval()
        with torch.inference_mode():
            _, pred = norm.postprocess(xn, model(xn, reference=True))
        return pred.cpu().numpy()

    ref = surrogate_trajectory(plain, inp, T)
    rel_l2 = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    max_rel = float(np.abs(out - ref).max() / np.abs(ref).max())
    lim_l2, lim_max = FAMILY_F32_ROLLOUT
    row = dict(reference="plain f32 path", rel_l2=rel_l2, limit_rel_l2=lim_l2,
               max_abs_over_max_ref=max_rel, limit_max=lim_max)
    if not (rel_l2 <= lim_l2 and max_rel <= lim_max):
        raise AssertionError(f"{path}: prediction vs the plain f32 path: {row}")
    secs = []
    for _ in range(FAMILY_ROLLOUTS):
        t0 = time.perf_counter()
        surrogate_trajectory(predict, inp, T)
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    emit(dict(phase=path, config="combustion/surrogate_model/fno.yaml", frames=SURROGATE_FRAMES,
              window=T, forwards=n, launches=launches, variants=VARIANTS_BY_PATH[path],
              vs_plain_f32=row, first_s=first_s, seconds=secs,
              frames_per_s=SURROGATE_FRAMES / med,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    del model
    _free()
    return launches


def phase_surrogate_unet_train(dev) -> dict:
    """The surrogate UNet's training step (dim_mults 1/2, dim = H = 128,
    17 → 1 channels, batch 2, f32 as shipped, remat on) through
    make_train_step: exact TA launch counts (tf32), the loss and every
    gradient within UNET_F32_LOSS_REL and UNET_F32_GRAD_REL_L2 of the plain
    f32 step at SURROGATE_UNET_CMP_BATCH, two passes bit-equal under
    cudnn.deterministic; steps/s, peak memory. Returns the counted step's
    launches."""
    from realpdebench_tpu_torch.models.unet import TemporalAttention

    path = "surrogate_unet_train_f32"
    cfg = _surrogate_cfg("unet")
    batch, norm = int(cfg["train_batch_size"]), surrogate_normalizer()
    model = _surrogate_model(dev, "unet")
    n_ta = sum(isinstance(m, TemporalAttention) for m in model.modules())
    init = {k: t.clone() for k, t in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(batch, *SURROGATE_IN, generator=g, device=dev)
    y = torch.randn(batch, *SURROGATE_OUT, generator=g, device=dev)
    opt = build_optimizer(_train_cfg(cfg), model.parameters())
    step = make_train_step(model, norm, opt, grad_accum=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y).item()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    VARIANTS_BY_PATH[path] = _expect(
        launches, f"one surrogate UNet step ({path})",
        variants=dict(ta_fwd={"tf32": n_ta}, ta_bwd={"tf32": n_ta}), ta_fwd=n_ta, ta_bwd=n_ta)
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    if not loss == loss or abs(loss) == float("inf"):
        raise AssertionError(f"{path}: training loss {loss} is not finite")

    xn, yn = norm.preprocess(x, y)
    n = SURROGATE_UNET_CMP_BATCH
    ref_model = _surrogate_model(dev, "unet", init)
    ref_loss, ref_grads = _plain_grads(ref_model, xn[:n], yn[:n])
    del ref_model
    half = _surrogate_model(dev, "unet", init)
    half_loss = half(xn[:n], y=yn[:n])
    half_loss.backward()
    got_loss, grads = half_loss.item(), _grads(half)
    del half, half_loss, init
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = abs(got_loss - ref_loss) / abs(ref_loss)
    cmp = dict(batch=n, loss=got_loss, ref_loss=ref_loss, loss_rel=loss_rel,
               limit_loss_rel=UNET_F32_LOSS_REL, limit_grad_rel_l2=UNET_F32_GRAD_REL_L2,
               grad_rel_l2={k: _rel_l2(grads[k], gr) for k, gr in ref_grads.items()})
    cmp["worst_grad_rel_l2"] = max(cmp["grad_rel_l2"].values())
    bad = [] if loss_rel <= UNET_F32_LOSS_REL else ["loss"]
    bad += [k for k, r in cmp["grad_rel_l2"].items() if not r <= UNET_F32_GRAD_REL_L2]
    if bad:
        raise AssertionError(f"{path}: kernel UNet step vs f32 plain step: {bad}: {cmp}")
    del ref_grads, grads
    _free()
    torch.backends.cudnn.deterministic = True
    rep = [_unet_pass(model, xn, yn) for _ in range(2)]
    torch.backends.cudnn.deterministic = False
    same = torch.equal(rep[0][0], rep[1][0]) and all(
        torch.equal(rep[0][1][k], rep[1][1][k]) for k in rep[0][1])
    if not same:
        raise AssertionError(f"{path}: two identical forward-backward passes differ")
    del rep
    windows, window_steps = SURROGATE_UNET_WINDOWS
    step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = zip(*(_steps_per_s(step, x, y, window_steps) for _ in range(windows)))
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"{path}: training losses {losses} are not finite")
    med = statistics.median(rates)
    BARE_STEPS_PER_S[path] = med
    emit(dict(phase=path, config="combustion/surrogate_model/unet.yaml", batch=batch,
              shape_in=list(SURROGATE_IN), shape_out=list(SURROGATE_OUT),
              cfg=_train_cfg(cfg), launches=launches, variants=VARIANTS_BY_PATH[path],
              ta_per_forward=n_ta, vs_plain_f32=cmp, bitwise_repeatable=same,
              first_step_s=first_s, window_steps_per_s=list(rates), steps_per_s=med,
              frames_per_s=med * batch * SURROGATE_IN[0], losses=list(losses),
              remat=model.remat, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_first_step_gb=first_peak, peak_mem_with_plain_step_gb=ref_peak))
    del model, step, opt
    _free()
    return launches


def phase_surrogate_loop(dev) -> dict:
    """python -m realpdebench_tpu_torch train-surrogate (train.surrogate.main,
    which the CLI runs) with the surrogate FNO's shipped config on an Arrow
    surrogate tree (tools.convert_hdf5_to_hf.write_surrogate_train from
    SURROGATE_SIMS synthetic pairs of 40 frames at 128x128: this host has no
    h5py), --use_hf_dataset, SURROGATE_LOOP_STEPS iterations: one
    evaluation over the test crops and one checkpoint; exact launch counts
    (the steps' and the evaluation's forwards, every FNO kernel tf32 but the
    T-stage); loop steps/s, peak memory. Returns its launches."""
    import math
    import shutil
    import tempfile

    from realpdebench_tpu_torch.tools.convert_hdf5_to_hf import write_surrogate_train
    from realpdebench_tpu_torch.train.surrogate import EVAL_EVERY
    from realpdebench_tpu_torch.train.surrogate import main as surrogate_main

    path = "surrogate_loop"
    cfg = _surrogate_cfg("fno")
    work = tempfile.mkdtemp(prefix="chip_smoke_surrogate_")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(18)
        H, W = SURROGATE_WINDOW[1:]
        pairs = ((f"{40 + 10 * i}NH3_{0.6 + 0.2 * i:.1f}.h5",
                  rng.standard_normal((SURROGATE_FRAMES, H, W), dtype=np.float32),
                  rng.standard_normal((SURROGATE_FRAMES, H, W, 15), dtype=np.float32))
                 for i in range(SURROGATE_SIMS))
        write_surrogate_train(f"{work}/data/combustion", pairs, step=SURROGATE_WINDOW[0],
                              n_sim_frame=SURROGATE_FRAMES)
        tree_s = time.perf_counter() - t0
        argv = ["--config", "combustion/surrogate_model/fno.yaml", "--dataset_root",
                f"{work}/data", "--use_hf_dataset", "--results_path", f"{work}/results",
                "--num_update", str(SURROGATE_LOOP_STEPS),
                # the surrogate datasets' defaults, which the tree was written with
                "--step", str(SURROGATE_WINDOW[0]), "--n_sim_frame", str(SURROGATE_FRAMES)]
        _free()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        exp, model, opt, hist = cli_run(surrogate_main, f"the {path}", argv)
        wall = time.perf_counter() - t0
        n_test = int(SURROGATE_SIMS * SURROGATE_FRAMES / 0.8 * 0.2)
        test_batches = math.ceil(n_test / int(cfg["test_batch_size"]))
        n_eval = SURROGATE_LOOP_STEPS // EVAL_EVERY
        want = {k: SURROGATE_LOOP_STEPS * TRAIN_LAUNCHES.get(k, 0)
                + n_eval * test_batches * PREDICT_LAUNCHES.get(k, 0) for k in TRAIN_LAUNCHES}
        want = {k: n for k, n in want.items() if n}
        launches = dict(kernels.LAUNCHES)
        VARIANTS_BY_PATH[path] = _expect(launches, f"the {path}",
                                         variants=_f32_fno_variants(want), **want)
        losses = hist["train_loss"]
        if len(losses) != SURROGATE_LOOP_STEPS or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"the {path}'s {len(losses)} train losses: {losses}")
        if len(hist["test"]["rmse"]) != n_eval or opt.count != SURROGATE_LOOP_STEPS:
            raise AssertionError(f"the {path}: {hist['test']}, {opt.count} updates")
        kept = sorted(os.listdir(f"{exp}/ckpt"))
        if kept != [f"checkpoint_{SURROGATE_LOOP_STEPS}.pth"]:
            raise AssertionError(f"the {path}'s checkpoints: {kept}")
        emit(dict(phase=path, config="combustion/surrogate_model/fno.yaml",
                  data="Arrow surrogate tree written from arrays (write_surrogate_train)",
                  tree_s=tree_s, batch=int(cfg["train_batch_size"]), test_windows=n_test,
                  test_batches=test_batches, evaluations=n_eval, wall_s=wall,
                  loop_steps_per_s=hist["perf"]["loop_steps_per_sec"],
                  bare_step_steps_per_s=BARE_STEPS_PER_S.get("surrogate_fno_train_f32"),
                  launches=launches, variants=VARIANTS_BY_PATH[path],
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  first_losses=losses[:5], last_losses=losses[-5:], test=hist["test"],
                  tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT),
                  reduced=dict(num_update=dict(here=SURROGATE_LOOP_STEPS,
                                               shipped=cfg["num_update"]),
                               tree=dict(here=f"{SURROGATE_SIMS} synthetic pairs of "
                                              f"{SURROGATE_FRAMES} frames at {H}x{W}",
                                         shipped="the published surrogate-train pairs"))))
        del model, opt
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _free()
    return launches


def save_backbone(model) -> str:
    """``model``'s weights as a bare pretrained backbone comes: a state dict
    without the wrapper's ``dpot_model.`` prefix, in a temporary file."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix="chip_smoke_backbone_", suffix=".pth")
    os.close(fd)
    torch.save({k[len("dpot_model."):]: v.detach().cpu()
                for k, v in model.state_dict().items()}, path)
    return path


def phase_dpot_finetune(dev, run) -> dict:
    """python -m realpdebench_tpu_torch train --is_finetune on real data from
    a bare DPOT-S backbone (the dpot_s_train_f32 step's weights, the
    dpot_model. prefix taken off; a one-step DPOT-S run writes one where
    that phase did not run), configs/cylinder/dpot_s.yaml in its shipped
    f32, DPOT_FINETUNE_STEPS steps on the loops' tree: no kernel launch,
    finite losses, and every weight within 3·lr a step of the backbone's
    (Adam moves each by about lr a step: a backbone that was not loaded
    would be a fresh initialisation, far from it). Returns its launches."""
    import math

    from realpdebench_tpu_torch.config import load_config
    from realpdebench_tpu_torch.train.__main__ import main as train_main

    path, config = "dpot_finetune", "cylinder/dpot_s.yaml"
    if "dpot_s" not in BACKBONES:
        model = _family(dev, "dpot_s")
        cfg = _family_cfg("dpot_s")
        g = torch.Generator(device=dev).manual_seed(19)
        x = torch.randn(2, *FAMILY_SHAPE, generator=g, device=dev)
        make_train_step(model, gaussian_normalizer(), build_optimizer(
            _train_cfg(cfg), model.parameters()))(x, x)
        BACKBONES["dpot_s"] = save_backbone(model)
        del model
    backbone = BACKBONES.pop("dpot_s")
    shipped = load_config(config)
    cuts = {k: LOOP_OVERRIDES[k] for k in ("n_sim_frame", "n_sim_in_distribution",
                                           "n_sim_out_distribution", "generate_ids_if_missing",
                                           "max_to_keep")}
    cuts["num_update"] = (DPOT_FINETUNE_STEPS, shipped.num_update)
    argv = ["--config", config, "--dataset_root", run.root, "--results_path",
            f"{run.work}/results_{path}", "--train_data_type", "real", "--is_finetune",
            "--checkpoint_path", backbone]
    for k, (v, _) in cuts.items():
        argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    try:
        _free()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        _, model, opt, hist = cli_run(train_main, f"the {path}", argv,
                                      dataset_class=run.dataset_class)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        VARIANTS_BY_PATH[path] = _expect(launches, f"the {path}")
        losses = hist["train_loss"]
        if opt.count != DPOT_FINETUNE_STEPS or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{path}: {opt.count} updates, losses {losses}")
        start = torch.load(backbone, map_location=dev, weights_only=True)
        moved = max((p.detach() - start[k[len("dpot_model."):]]).abs().max().item()
                    for k, p in model.named_parameters())
        limit = 3 * float(shipped.lr) * DPOT_FINETUNE_STEPS
        if not moved <= limit:
            raise AssertionError(f"{path}: the weights moved {moved} from the backbone "
                                 f"(limit {limit}): the backbone was not loaded")
        emit(dict(phase=path, config=config, backbone="bare (no dpot_model. prefix), "
                  "written by the DPOT-S step on this card", data=run.data_source(),
                  wall_s=wall, steps=len(losses), losses=losses, val_rmse=hist["val"]["rmse"],
                  max_abs_from_backbone=moved, limit_from_backbone=limit,
                  launches=launches, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT),
                  reduced={k: dict(here=v, shipped=sv) for k, (v, sv) in cuts.items()}))
        del model, opt, start
    finally:
        os.remove(backbone)
    _free()
    return launches



def phase_profile(step, x, y, phase: str = "profile", steps: int = PROFILE_STEPS) -> None:
    """torch.profiler over ``steps`` calls of ``step(x, y)`` (training
    steps, or rollouts): device time by kernel against the host's wall
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device time of the kernels themselves: an autograd function's row
    # also carries the time of the kernels it launched through ctypes
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in ka
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    emit(dict(phase=phase, steps=steps, reduced=dict(steps=dict(here=steps, uncut=3)),
              wall_ms=wall * 1e3, device_ms=total,
              idle_share=1 - total / (wall * 1e3),
              kernels=[dict(name=k[:160], ms=ms, count=n) for k, ms, n in rows[:40]]))


# the loop and eval phases: the shipped cylinder configs through the entry
# points on a synthetic tree at the cylinder's resolution (real 64x128 u, v;
# numerical 128x256 u, v, p, as sub_s_numerical is 2). The tree's size and
# the keys its splits need are cut from the published dataset's; each
# override below stands beside the shipped value.
# 300 frames a trajectory (the whole run's time limit: it halves each
# validation and the tree's making against 600)
LOOP_TREE = dict(scenario="cylinder", n_frame=300, seed=0,
                 sizes={"real": (16, 64, 128), "numerical": (4, 128, 256)})
# 12 steps (the whole run's time limit): validation and a checkpoint every
# step, iterations 10-12 traced, StepTimer's one window of 10 after 2
# warm-up steps
LOOP_STEPS = 12
LOOP_OVERRIDES = {  # key: (value here, shipped value)
    "n_sim_frame": (300, 3990),
    "n_sim_in_distribution": (1, 10),
    "n_sim_out_distribution": (1, 10),
    "generate_ids_if_missing": (True, None),
    "num_update": (LOOP_STEPS, 4000),
    "max_to_keep": (2, None),
    "N_plot_probe": (0, 12),
}
LOOP_PROFILE = (10, 19)          # the loop's own iterations traced (utils/profiling)
RESUME_STEPS = 1                 # each loop resumed this far (the run's time limit)
LOOP_METRICS_REL = 1e-4          # the sweep on the card vs on the CPU, per metric
EVAL_METRIC_REL, EVAL_METRIC_ABS, EVAL_SMALL = 5e-2, 1e-3, 1e-2


def _compared(name: str, value: float) -> float:
    """A metric as the loops and evals compare it: r2 by its residual share
    1 - r2 (the squared error over the targets' spread), whose scale is its
    own; r2 itself lies near 0 by chance, where a relative or 1e-3 absolute
    limit on it asks far more than the same limit on the rmse."""
    return 1.0 - value if name == "r2" else value

EVAL_PLAIN_CHUNK = 16            # the plain f32 rollout, 16 windows at a time
# the forward of one FNO predict (4 layers); a training step's is TRAIN_LAUNCHES
PREDICT_LAUNCHES = dict(k1=4, t_stage=8, k2=4)
# the UNet's and the GK's loops and evaluations: their shipped configs in
# bf16 on the same tree, at the shipped widths and batches. Validation (the
# 54 real val windows) and a checkpoint come every num_update // 50 steps,
# which below 100 steps is every step: 12 steps are what a phase of about a
# minute buys at the UNet's ~2.5 s a validation, and trace iterations 10-12
# (StepTimer's one window of 10 after 2 warm-up steps needs all 12). Eval
# reads the test split's unseen trajectories (test_mode): 8 windows at the
# UNet's 5 steps. The plots need matplotlib: where it is missing, N_plot and
# N_plot_probe are 0.
MODEL_LOOP_STEPS = 12
MODEL_TEST_MODE = "unseen"
FAMILY_LOOP_STEPS = 12
# CNO's and Transolver's loops run 2 steps (the whole run's time limit): a
# CNO validation of the 54 windows is ≈ 140 TFLOP in full f32, Transolver's
# sweeps took 54 of its 12-step loop's 64 s; no traced iteration, no
# StepTimer window
CNO_LOOP_STEPS = TRANSOLVER_LOOP_STEPS = 2
# the bf16 FNO loop again, on the Arrow tree the converter writes from the
# same arrays (--use_hf_dataset true): a few steps, exact counts
ARROW_STEPS = 2          # the whole run's time limit
ARROW_WINDOWS = 8       # windows of each split and type held bit for bit, and timed
# WDNO's loop and eval in its shipped f32 (the TA kernels' tf32 variants):
# 1 step with its one validation sweep (each of the 54 val windows a DDIM
# sample of 10 denoiser forwards), no trace, no StepTimer window, no
# resume; the eval over the 14 unseen test windows at N_autoregressive 1
# [5]; test batch 14 [64]: the eval's windows in one batch, the sweep's in
# 4 (at 64 the sweep would sample 64 padded windows). The reload samples 2
# val windows; 4 test windows go through the plain f32 path too.
WDNO_LOOP_STEPS = 1
WDNO_TEST_BATCH = 14
WDNO_RELOAD_WINDOWS, WDNO_PLAIN_WINDOWS = 2, 4
# DMD (configs/cylinder/dmd.yaml: test batch 12, n_predict 20, input_feature
# 2, N_autoregressive 1): eval only, on the same tree (all 56 test windows)
DMD_CONFIG = "cylinder/dmd.yaml"
# each loop path: its config, the compute dtype it runs (None: f32, as the
# configs ship), its steps, the kernel launches of one training step and of
# one forward, its eval phase, its bare step's phase and its other cuts
# (key: (value here, shipped value)). Transolver's and CNO's loops are not
# resumed (resume False): a resume re-runs their slowest part, a
# validation sweep, and the whole run's time limit took it; the FNO's,
# UNet's, GK's, DeepONet's and MWT's loops hold the resume. DeepONet and Transolver run in their
# shipped f32, at the shipped batches, and launch no kernel.
LOOPS = {
    "loop": dict(config="cylinder/fno.yaml", dtype="bfloat16", steps=LOOP_STEPS,
                 step=TRAIN_LAUNCHES, predict=PREDICT_LAUNCHES, eval="eval", bare="train"),
    "unet_loop": dict(config="cylinder/unet.yaml", dtype="bfloat16", steps=MODEL_LOOP_STEPS,
                      step=dict(ta_fwd=UNET_TA_PER_FORWARD, ta_bwd=UNET_TA_PER_FORWARD),
                      predict=dict(ta_fwd=UNET_TA_PER_FORWARD), eval="unet_eval",
                      bare="unet_train"),
    "gk_loop": dict(config="cylinder/galerkin_transformer.yaml", dtype="bfloat16",
                    steps=MODEL_LOOP_STEPS,
                    step=dict(gk_scores=GK_MODEL["num_encoder_layers"]),
                    predict=dict(gk_scores=GK_MODEL["num_encoder_layers"]),
                    eval="gk_eval", bare="gk_train"),
    "deeponet_loop": dict(config="cylinder/deeponet.yaml", dtype=None,
                          steps=FAMILY_LOOP_STEPS, step={}, predict={},
                          eval="deeponet_eval", bare="deeponet_train_f32"),
    "transolver_loop": dict(config="cylinder/transolver.yaml", dtype=None,
                            steps=TRANSOLVER_LOOP_STEPS, step={}, predict={},
                            eval="transolver_eval", bare="transolver_train_f32",
                            resume=False),
    "cno_loop": dict(config="cylinder/cno.yaml", dtype=None, steps=CNO_LOOP_STEPS,
                     step={}, predict={}, eval="cno_eval", bare="cno_train_f32",
                     resume=False),
    "mwt_loop": dict(config="cylinder/mwt.yaml", dtype=None, steps=FAMILY_LOOP_STEPS,
                     step={}, predict={}, eval="mwt_eval", bare="mwt_train_f32"),
    "wdno_loop": dict(config=WDNO_CONFIG, dtype=None, steps=WDNO_LOOP_STEPS,
                      step=dict(ta_fwd=WDNO_TA_PER_FORWARD, ta_bwd=WDNO_TA_PER_FORWARD),
                      predict=dict(ta_fwd=WDNO_TA_PER_FORWARD * WDNO_SAMPLE_STEPS),
                      eval="wdno_eval", bare="wdno_train_f32", variant="tf32",
                      cuts={"test_batch_size": (WDNO_TEST_BATCH, 64)},
                      eval_cuts={"N_autoregressive": (1, 5)}),
}
# the loops whose model samples (WDNO): their own loop and eval phases
SAMPLED_LOOPS = ("wdno_loop",)
# PyTorch's own defaults of the TF32 switches, which each CLI run starts
# from, and the full-f32 state the port must leave after it
TF32_DEFAULTS = (False, True, "highest")
F32_EXACT = (False, False, "highest")


def tf32_state() -> tuple:
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def tf32_defaults() -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = TF32_DEFAULTS[:2]
    torch.set_float32_matmul_precision(TF32_DEFAULTS[2])


def cli_run(main, what: str, *args, **kwargs):
    """An entry point's ``main(*args, **kwargs)``, started from PyTorch's
    default TF32 switches; the port must leave them full f32."""
    tf32_defaults()
    out = main(*args, **kwargs)
    check_f32_exact(what)
    return out


def check_f32_exact(what: str) -> tuple:
    """The TF32 switches as ``what`` left them: full f32, or raise."""
    if tf32_state() != F32_EXACT:
        raise AssertionError(f"{what} left the TF32 switches at {tf32_state()}, "
                             f"not {F32_EXACT}")
    return tf32_state()


class LoopRun:
    """The tree, each loop's argv and the loops' checkpoints, shared by
    phase_loop, phase_eval and phase_arrow; ``close`` removes the tree."""

    def __init__(self):
        import importlib.util
        import tempfile

        from realpdebench_tpu_torch.data.fluid import Cylinder, with_arrays
        from realpdebench_tpu_torch.data.synthetic import fluid_arrays, make_fluid_tree

        self.work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
        self.root = f"{self.work}/data"
        self.ckpt_dirs = {}
        t0 = time.perf_counter()
        self.h5py = importlib.util.find_spec("h5py") is not None
        self.plots = importlib.util.find_spec("matplotlib") is not None
        if self.h5py:
            make_fluid_tree(self.root, **LOOP_TREE)
            self.arrays = self.dataset_class = None
        else:
            # no h5py on this host: the same arrays in memory, read by the
            # cylinder dataset with its window reader replaced
            self.arrays = fluid_arrays(**LOOP_TREE)
            self.dataset_class = with_arrays(Cylinder, self.arrays)
        self.tree_s = time.perf_counter() - t0

    def overrides(self, path: str, evaluating: bool = False) -> dict:
        """key: (value here, shipped value) of the loop ``path``."""
        if path == "loop":
            return dict(LOOP_OVERRIDES)
        from realpdebench_tpu_torch.config import load_config

        shipped = load_config(LOOPS[path]["config"])
        out = {k: LOOP_OVERRIDES[k] for k in (
            "n_sim_frame", "n_sim_in_distribution", "n_sim_out_distribution",
            "generate_ids_if_missing", "max_to_keep")}
        out["num_update"] = (LOOPS[path]["steps"], shipped.num_update)
        out.update(LOOPS[path].get("cuts", {}))
        if evaluating:
            out.update(LOOPS[path].get("eval_cuts", {}))
        for k in ("N_plot", "N_plot_probe"):
            if shipped.get(k) and not self.plots:
                out[k] = (0, shipped.get(k))
        if evaluating:
            out["test_mode"] = (MODEL_TEST_MODE, "all")
        return out

    def argv(self, path: str, evaluating: bool = False) -> list:
        argv = ["--config", LOOPS[path]["config"], "--dataset_root", self.root,
                "--results_path", f"{self.work}/results"]
        if LOOPS[path]["dtype"]:
            argv += ["--compute_dtype", LOOPS[path]["dtype"]]
        for k, (v, _) in self.overrides(path, evaluating).items():
            argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
        return argv

    def reduced(self, path: str, evaluating: bool = False) -> dict:
        r = {k: dict(here=v, shipped=s)
             for k, (v, s) in self.overrides(path, evaluating).items()}
        # the dtype each path ran: None is f32, as shipped
        r["compute_dtype"] = dict(here=LOOPS[path]["dtype"], shipped=None)
        n_real, h, w = LOOP_TREE["sizes"]["real"]
        n_num, hn, wn = LOOP_TREE["sizes"]["numerical"]
        r["tree"] = dict(here=f"{n_real} real trajectories at {h}x{w} and {n_num} "
                              f"numerical at {hn}x{wn}, {LOOP_TREE['n_frame']} frames "
                              "each, synthetic (data/synthetic)",
                         shipped="the published cylinder trees")
        if not self.plots and ("N_plot" in r or "N_plot_probe" in r):
            r["plots"] = "this host has no matplotlib: N_plot and N_plot_probe are 0"
        return r

    def data_source(self) -> str:
        return ("HDF5 tree (h5py)" if self.h5py else
                "in-memory arrays (data.fluid.with_arrays): this host has no h5py")

    def close(self) -> None:
        import shutil

        shutil.rmtree(self.work, ignore_errors=True)


def _parse(argv, evaluating: bool = False):
    from realpdebench_tpu_torch.config import make_arg_parser, parse_config

    parser = make_arg_parser()
    if evaluating:
        parser.add_argument("--checkpoint_path")
        parser.add_argument("--test_mode", default="all")
    return parse_config(parser, argv)


def _free() -> None:
    """Release what the previous phase left on the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _expected(loop: dict, n_steps: int, n_predicts: int) -> dict:
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    for k, v in loop["step"].items():
        want[k] += n_steps * v
    for k, v in loop["predict"].items():
        want[k] += n_predicts * v
    return want


def _check_launches(what: str, loop: dict, n_steps: int, n_predicts: int) -> tuple:
    """The counts since the last reset against n_steps training steps and
    n_predicts forwards of ``loop``'s model, every kernel in its mma
    variant (the loop's ``variant`` where it names one; T-stage: registers)."""
    launches = dict(kernels.LAUNCHES)
    want = _expected(loop, n_steps, n_predicts)
    if launches != want:
        raise AssertionError(f"{what} launched {launches}, expected {want} "
                             f"({n_steps} steps, {n_predicts} forwards)")
    variants = expect_variants(what, **{
        k: {"registers" if k == "t_stage" else loop.get("variant", "mma"): n}
        for k, n in want.items() if n})
    return launches, variants
def _interval_union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(intervals, spans) -> float:
    """Length of the union of ``intervals`` that lies inside ``spans``."""
    spans = _interval_union(spans)
    total, j = 0.0, 0
    for a, b in intervals:
        for s, e in spans:
            lo, hi = max(a, s), min(b, e)
            if hi > lo:
                total += hi - lo
    return total


def loop_trace_summary(path: str) -> dict:
    """The device's idle share over the traced loop iterations, and which
    of the main thread's spans (waiting for a batch, validation, checkpoint,
    the step's own host time) the idle time falls in, from the Chrome trace
    torch.profiler wrote."""
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in ev
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ann = [e for e in ev if e.get("cat") == "user_annotation"]
    steps = [e for e in ann if e["name"] == "train_step"]
    if not dev or not steps:
        raise AssertionError(f"the loop trace holds {len(dev)} device events and "
                             f"{len(steps)} steps")
    t0 = min(e["ts"] for e in steps)
    t1 = max(max(e["ts"] + e["dur"] for e in ann), max(b for _, b in dev))
    busy = _interval_union([(max(a, t0), min(b, t1)) for a, b in dev if b > t0 and a < t1])
    idle, cur = [], t0
    for a, b in busy:
        if a > cur:
            idle.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        idle.append((cur, t1))
    window = t1 - t0
    idle_total = sum(b - a for a, b in idle)
    main_tid = steps[0]["tid"]
    spans = {}
    for e in ann:
        spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"], e["tid"]))
    by_span = {name: _overlap(idle, [(a, b) for a, b, t in sp if t == main_tid]) / 1e3
               for name, sp in spans.items() if any(t == main_tid for *_, t in sp)}
    host_ms = {name: sum(b - a for a, b, _ in sp) / 1e3 for name, sp in spans.items()}
    largest = sorted(idle, key=lambda g: g[0] - g[1])[:5]

    def where(g):
        best = max(((n, _overlap([g], [(a, b) for a, b, t in sp if t == main_tid]))
                    for n, sp in spans.items()), key=lambda p: p[1], default=(None, 0))
        return best[0] if best[1] > 0 else "none"

    copies = [e for e in ev if e.get("cat") == "gpu_memcpy"]
    return dict(
        steps=len(steps), window_ms=window / 1e3,
        device_busy_ms=(window - idle_total) / 1e3, idle_share=idle_total / window,
        idle_ms_in_host_span=by_span,
        idle_ms_outside_spans=(idle_total / 1e3 - sum(by_span.values())),
        host_span_ms=host_ms,
        largest_gaps=[dict(ms=(b - a) / 1e3, during=where((a, b))) for a, b in largest],
        memcpy_ms=sum(e["dur"] for e in copies) / 1e3,
        memcpy_by_kind={k: sum(e["dur"] for e in copies if e["name"].startswith(k)) / 1e3
                        for k in ("Memcpy HtoD", "Memcpy DtoH", "Memcpy DtoD")})


def phase_loop(dev, run: LoopRun, path: str = "loop") -> dict:
    """python -m realpdebench_tpu_torch train, in this process, for the loop
    ``path``: its steps on numerical data with validation every
    num_update // 50 steps and a checkpoint at each; then a resume
    RESUME_STEPS further and, for the FNO, a 2-step finetune on real data from its
    checkpoint. Returns the launch counts of these runs."""
    import math

    from realpdebench_tpu_torch.data.loader import DataLoader
    from realpdebench_tpu_torch.data.normalizer import build_normalizer
    from realpdebench_tpu_torch.eval.metrics import METRIC_NAMES
    from realpdebench_tpu_torch.train import make_eval_step
    from realpdebench_tpu_torch.train.__main__ import main as train_main
    from realpdebench_tpu_torch.train.checkpoint import CheckpointManager
    from realpdebench_tpu_torch.train.loop import (
        build_datasets,
        load_reference_or_orbax_checkpoint,
        model_kwargs,
        validation_arrays,
    )

    loop, base = LOOPS[path], run.argv(path)
    steps = loop["steps"]
    cfg = _parse(base)
    train_ds, val_ds, norm_ds = build_datasets(cfg, "numerical",
                                               dataset_class=run.dataset_class)
    batch, test_batch = int(cfg.train_batch_size), int(cfg.test_batch_size)
    val_batches = math.ceil(len(val_ds) / test_batch)
    val_every = max(1, steps // 50)
    prof_dir = f"{run.work}/profile_{path}"

    # the main path, counted: nothing but the training run between reset and read
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    exp1, model, opt, hist = cli_run(
        train_main, f"the {path}",
        [*base, "--train_data_type", "numerical", "--profile_dir", prof_dir],
        dataset_class=run.dataset_class)
    wall = time.perf_counter() - t0
    n_val = steps // val_every
    launches, variants = _check_launches(f"the {path}", loop, steps, n_val * val_batches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = hist["train_loss"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the {path}'s {len(losses)} train losses: {losses}")
    if len(hist["val"]["rmse"]) != n_val:
        raise AssertionError(f"{len(hist['val']['rmse'])} validations, expected {n_val}")
    ckpt_dir = f"{exp1}/ckpt"
    steps_kept = CheckpointManager(ckpt_dir).all_steps()
    if steps_kept != [steps - val_every, steps]:
        raise AssertionError(f"checkpoints kept: {steps_kept}")
    traced = min(LOOP_PROFILE[1], steps) - LOOP_PROFILE[0] + 1
    trace = loop_trace_summary(f"{prof_dir}/trace.json") if traced > 0 else None
    if trace is not None and trace["steps"] != traced:
        raise AssertionError(f"the trace holds {trace['steps']} steps")

    # reload: the checkpoint in a fresh model predicts bit for bit as the
    # trained model on one validation batch
    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
    fresh = build_model(train_dataset=train_ds, device=dev, generator=make_generator(1),
                        **model_kwargs(cfg))
    load_reference_or_orbax_checkpoint(ckpt_dir, fresh)
    items = [val_ds[i] for i in range(min(test_batch, len(val_ds)))]
    xb = torch.from_numpy(np.stack([it[0] for it in items])).to(dev)
    yb = torch.from_numpy(np.stack([it[1] for it in items])).to(dev)
    xn, _ = normalizer.preprocess(xb, yb)
    if not torch.equal(model.predict(xn), fresh.predict(xn)):
        raise AssertionError("the reloaded checkpoint predicts otherwise than the "
                             "trained model")
    del fresh, xb, yb, xn

    # the 13 metrics of the sweep on the card against the CPU's on copies of
    # the same arrays (u and v: the real data's p is not measured); beside
    # them, the loop's own last validation
    c = 2
    _, preds, targets = validation_arrays(
        make_eval_step(model, normalizer, c),
        DataLoader(val_ds, batch_size=test_batch, num_workers=12, pad_last=True,
                   pin_memory=dev.type == "cuda"), dev)
    metric_cmp = _metrics_card_vs_cpu(preds, targets, c, loop_last_validation={
        name: hist["val"][name][-1] for name in METRIC_NAMES})
    del preds, targets, model
    _free()

    # resume RESUME_STEPS further from the run's checkpoint directory
    resume, total = None, dict(launches)
    if loop.get("resume", True):
        kernels.reset_launches()
        _, _, opt2, hist2 = cli_run(
            train_main, f"the resumed {path}",
            [*base, "--train_data_type", "numerical", "--num_update",
             str(steps + RESUME_STEPS), "--resume", ckpt_dir], dataset_class=run.dataset_class)
        end = steps + RESUME_STEPS
        n_val2 = sum(1 for i in range(steps + 1, end + 1) if i % max(1, end // 50) == 0)
        resume_launches, _ = _check_launches(f"the resumed {path}", loop, RESUME_STEPS,
                                             n_val2 * val_batches)
        resume = dict(start_iteration=hist2["perf"]["start_iteration"],
                      steps=len(hist2["train_loss"]), optimizer_count=opt2.count,
                      optimizer_count_saved=opt.count, losses=hist2["train_loss"])
        if (resume["start_iteration"], resume["steps"], opt.count, opt2.count) != (
                steps, RESUME_STEPS, steps, end):
            raise AssertionError(f"resume: {resume}")
        del opt2
        total = {k: launches[k] + resume_launches[k] for k in launches}

    finetune = None
    if path == "loop":
        # finetune on real data from the first run's checkpoint, 2 steps
        _free()
        kernels.reset_launches()
        _, _, opt3, hist3 = cli_run(
            train_main, "the finetune",
            [*base, "--train_data_type", "real", "--is_finetune", "--checkpoint_path",
             ckpt_dir, "--num_update", "2"], dataset_class=run.dataset_class)
        ft_launches, _ = _check_launches("the finetune", loop, 2, 2 * val_batches)
        if opt3.count != 2 or not all(math.isfinite(v) for v in hist3["train_loss"]):
            raise AssertionError(f"finetune: {opt3.count} updates, losses "
                                 f"{hist3['train_loss']}")
        finetune = dict(steps=len(hist3["train_loss"]), losses=hist3["train_loss"],
                        val_rmse=hist3["val"]["rmse"])
        total = {k: total[k] + ft_launches[k] for k in total}

    perf = hist["perf"]
    reduced = run.reduced(path)
    if trace is None:
        reduced["trace"] = (f"{steps} steps: no iteration traced ({LOOP_PROFILE[0]}-"
                            f"{LOOP_PROFILE[1]}), no StepTimer window")
    if resume is None:
        reduced["resume"] = dict(here=None, other_loops=f"{RESUME_STEPS} step")
    emit(dict(phase=path, config=loop["config"], data=run.data_source(),
              tree_s=run.tree_s, reduced=reduced, batch=batch,
              test_batch=test_batch, val_windows=len(val_ds),
              train_windows=len(train_ds), val_batches=val_batches,
              validations=n_val, wall_s=wall,
              loop_steps_per_s=perf["loop_steps_per_sec"],
              step_timer_steps_per_s=perf.get("steps_per_sec"),
              step_timer_ms_p50=perf.get("step_ms_p50"),
              step_timer_ms_p95=perf.get("step_ms_p95"),
              bare_step_steps_per_s=BARE_STEPS_PER_S.get(loop["bare"]),
              validation_s=perf["validation_s"], checkpoint_s=perf["checkpoint_s"],
              batch_assembly_s=perf["batch_assembly_s"],
              trace=trace, launches=launches, variants=variants, peak_mem_gb=peak,
              first_losses=losses[:10], last_losses=losses[-10:],
              metrics_card_vs_cpu=metric_cmp, limit_metrics_rel=LOOP_METRICS_REL,
              tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT),
              reload_bit_equal=True, resume=resume, finetune=finetune))
    VARIANTS_BY_PATH[path] = variants
    run.ckpt_dirs[path] = ckpt_dir
    return total


def _rollout_arrays(predictor, normalizer, test_ds, batch, chunk, dev, c, n_steps):
    """The whole test split rolled out (physical units, on the card)."""
    from realpdebench_tpu_torch.data.loader import DataLoader, to_device
    from realpdebench_tpu_torch.eval.rollout import finalize_rollout

    rollout = make_rollout_fn(predictor, normalizer, n_steps)
    preds, targets = [], []
    batches = to_device(DataLoader(test_ds, batch_size=batch, num_workers=12,
                                   pad_last=True, pin_memory=dev.type == "cuda"), dev)
    try:
        for x, y, mask in batches:
            n = int(mask.sum())
            for i in range(0, n, chunk):
                j = min(i + chunk, n)
                pn, xn, yn = rollout(x[i:j], y[i:j])
                _, p, t = finalize_rollout(normalizer, pn, xn, yn, c)
                preds.append(p)
                targets.append(t)
    finally:
        batches.close()
    return torch.cat(preds), torch.cat(targets)


def phase_eval(dev, run: LoopRun, path: str = "loop") -> dict:
    """python -m realpdebench_tpu_torch eval, in this process, on the loop
    ``path``'s checkpoint in bf16 at the config's test batch and
    autoregressive steps; the metrics against the same checkpoint through
    the plain f32 path."""
    import math

    from realpdebench_tpu_torch.config import load_config
    from realpdebench_tpu_torch.data.normalizer import build_normalizer
    from realpdebench_tpu_torch.eval.__main__ import build_eval_datasets
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main
    from realpdebench_tpu_torch.eval.metrics import METRIC_NAMES, eval_metrics
    from realpdebench_tpu_torch.train.loop import (
        load_reference_or_orbax_checkpoint,
        model_kwargs,
    )

    loop, name = LOOPS[path], LOOPS[path]["eval"]
    ckpt_dir = run.ckpt_dirs[path]
    argv = [*run.argv(path, evaluating=True), "--checkpoint_path", ckpt_dir]
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, results = cli_run(eval_main, f"the {name}", argv, dataset_class=run.dataset_class)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9

    cfg = _parse(argv, evaluating=True)
    test_ds, train_ds, norm_ds = build_eval_datasets(cfg, run.dataset_class)
    batch, n_steps = int(cfg.test_batch_size), int(cfg.N_autoregressive)
    if n_steps != load_config(loop["config"]).N_autoregressive:
        raise AssertionError(f"N_autoregressive {n_steps} is not the shipped one")
    n_predicts = math.ceil(len(test_ds) / batch) * n_steps
    launches, variants = _check_launches(f"the {name}", loop, 0, n_predicts)
    frames = len(test_ds) * n_steps * SHAPE_OUT[0]
    keys = [*METRIC_NAMES, "normalized_mse"]
    keys += ["probe_error"] if cfg.get("probe_diagnostic") else []
    if set(results) != set(keys) or not all(math.isfinite(results[k]) for k in keys):
        raise AssertionError(f"eval results not finite, or not {keys}: {results}")

    # the same checkpoint through the plain f32 path, and the bf16 kernels
    # once more for the predictions themselves
    c = 2
    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
    kw = model_kwargs(cfg)
    kw.pop("compute_dtype")
    plain = build_model(train_dataset=train_ds, device=dev, **kw).eval()
    load_reference_or_orbax_checkpoint(ckpt_dir, plain)
    ref, targets = _rollout_arrays(_PlainPath(plain), normalizer, test_ds, batch,
                                   EVAL_PLAIN_CHUNK, dev, c, n_steps)
    del plain
    bf16 = build_model(train_dataset=train_ds, device=dev, **model_kwargs(cfg))
    load_reference_or_orbax_checkpoint(ckpt_dir, bf16)
    pred, _ = _rollout_arrays(bf16, normalizer, test_ds, batch, batch, dev, c, n_steps)
    del bf16
    rel_l2 = ((pred[..., :c] - ref[..., :c]).norm() / ref[..., :c].norm()).item()
    # chunked as run_eval chunks the sweep
    ref_metrics = dict(zip(METRIC_NAMES, (float(v) for v in eval_metrics(
        ref, targets, c, batch if n_steps > 4 else None))))
    cmp, bad = {}, [] if rel_l2 <= ROLLOUT_REL_L2 else ["predictions"]
    for m in METRIC_NAMES:
        got, want = _compared(m, results[m]), _compared(m, ref_metrics[m])
        small = abs(want) < EVAL_SMALL
        err = abs(got - want) if small else abs(got - want) / abs(want)
        cmp[m] = dict(eval=results[m], f32_plain=ref_metrics[m], err=err,
                      limit=EVAL_METRIC_ABS if small else EVAL_METRIC_REL,
                      kind="abs" if small else "rel")
        bad += [] if err <= cmp[m]["limit"] else [m]
    if bad:
        raise AssertionError(f"{name} vs plain f32 eval: {bad}: rel_l2 {rel_l2}, {cmp}")
    del pred, ref, targets
    emit(dict(phase=name, config=loop["config"], data=run.data_source(),
              reduced=run.reduced(path, evaluating=True), batch=batch,
              n_autoregressive=n_steps, test_windows=len(test_ds), results=results,
              eval_s=secs, frames_per_s=frames / secs, launches=launches,
              tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT),
              variants=variants, peak_mem_gb=peak,
              vs_plain_f32=dict(pred_rel_l2=rel_l2, limit_rel_l2=ROLLOUT_REL_L2,
                                metrics=cmp)))
    VARIANTS_BY_PATH[name] = variants
    return launches


def _metric_rel(name: str, got: float, want: float) -> float:
    """A metric's distance as the loops compare it (``_compared``):
    relative, absolute where ``want`` is 0, 0 where both are NaN."""
    import math

    a, b = _compared(name, got), _compared(name, want)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b) / abs(b) if b else abs(a - b)


def _metrics_card_vs_cpu(preds, targets, c: int, **beside) -> dict:
    """The 13 metrics of the card's own predictions on the card and on the
    CPU, within LOOP_METRICS_REL of each other (or raise); each ``beside``
    (label → {metric: value}) stands beside them."""
    from realpdebench_tpu_torch.eval.metrics import METRIC_NAMES, eval_metrics

    card = eval_metrics(preds, targets, c)
    host = eval_metrics(preds.cpu(), targets.cpu(), c)
    out = {name: dict(card=float(a), cpu=float(b), rel=_metric_rel(name, float(a), float(b)),
                      **{k: v[name] for k, v in beside.items()})
           for name, a, b in zip(METRIC_NAMES, card, host)}
    bad = [name for name, row in out.items() if not row["rel"] <= LOOP_METRICS_REL]
    if bad:
        raise AssertionError(f"metrics on the card vs the CPU: {bad}: {out}")
    return out


def phase_wdno_loop(dev, run: LoopRun, path: str = "wdno_loop") -> dict:
    """python -m realpdebench_tpu_torch train for WDNO in its shipped f32,
    in this process: WDNO_LOOP_STEPS step on numerical data with its one
    validation sweep (each val window a DDIM sample) and a checkpoint; the
    rescaler computed on the card from the tree, its cache read back; the
    checkpoint in a fresh model samples bit for bit as the trained model,
    both generators reseeded; the 13 metrics of those samples on the card
    within LOOP_METRICS_REL of the CPU's. Returns the loop's launch counts."""
    import math

    from realpdebench_tpu_torch.data.normalizer import build_normalizer
    from realpdebench_tpu_torch.models.wdno import compute_wdno_rescaler, rescaler_cache
    from realpdebench_tpu_torch.train import make_eval_step
    from realpdebench_tpu_torch.train.__main__ import main as train_main
    from realpdebench_tpu_torch.train.checkpoint import CheckpointManager
    from realpdebench_tpu_torch.train.loop import (
        build_datasets,
        load_reference_or_orbax_checkpoint,
        model_kwargs,
    )

    loop, base = LOOPS[path], run.argv(path)
    steps = loop["steps"]
    cfg = _parse(base)
    train_ds, val_ds, norm_ds = build_datasets(cfg, "numerical", dataset_class=run.dataset_class)
    test_batch = int(cfg.test_batch_size)
    val_batches = math.ceil(len(val_ds) / test_batch)
    cache = rescaler_cache(run.root, cfg.dataset_name, cfg.wave_type, cfg.pad_mode)
    if os.path.exists(cache):
        raise AssertionError(f"{cache} exists before the first WDNO run")

    # the main path, counted: nothing but the training run between reset and read
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    exp1, model, _, hist = cli_run(train_main, f"the {path}",
                                   [*base, "--train_data_type", "numerical"],
                                   dataset_class=run.dataset_class)
    wall = time.perf_counter() - t0
    launches, variants = _check_launches(f"the {path}", loop, steps, steps * val_batches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = hist["train_loss"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"the {path}'s {len(losses)} train losses: {losses}")
    if len(hist["val"]["rmse"]) != steps:
        raise AssertionError(f"{len(hist['val']['rmse'])} validations, expected {steps}")
    ckpt_dir = f"{exp1}/ckpt"
    if CheckpointManager(ckpt_dir).all_steps() != list(range(1, steps + 1))[-2:]:
        raise AssertionError(f"checkpoints kept: {CheckpointManager(ckpt_dir).all_steps()}")
    cached = compute_wdno_rescaler(None, cfg.wave_type, cfg.pad_mode, run.root, cfg.dataset_name)
    if not np.array_equal(model.rescaler.cpu().numpy(), cached[: model.channels]):
        raise AssertionError("the rescaler's cache does not read back as the run's rescaler")

    # reload: the checkpoint in a fresh model samples bit for bit as the
    # trained model on a few validation windows, both generators reseeded,
    # with cuDNN held to deterministic algorithms (its default f32 ones
    # differ from call to call, and the first DDIM step amplifies any
    # difference); beside it, whether the default ones gave the same bits
    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
    fresh = build_model(train_dataset=train_ds, device=dev, generator=make_generator(1),
                        **model_kwargs(cfg))
    load_reference_or_orbax_checkpoint(ckpt_dir, fresh)
    items = [val_ds[i] for i in range(WDNO_RELOAD_WINDOWS)]
    xb, yb = (torch.from_numpy(np.stack([it[j] for it in items])).to(dev) for j in (0, 1))
    c = 2

    def samples(deterministic: bool) -> list:
        torch.backends.cudnn.deterministic = deterministic
        try:
            outs = []
            for m in (model, fresh):
                m.reseed_dropout(int(cfg.seed))
                outs.append(make_eval_step(m, normalizer, c)(xb, yb))
            return outs
        finally:
            torch.backends.cudnn.deterministic = False

    default = samples(False)
    default_equal = torch.equal(default[0][1], default[1][1])
    outs = samples(True)
    if not torch.equal(outs[0][1], outs[1][1]):
        raise AssertionError("the reloaded checkpoint samples otherwise than the trained model")
    metric_cmp = _metrics_card_vs_cpu(outs[0][1], outs[0][2], c)
    del default
    del fresh, model, outs, xb, yb
    _free()

    perf = hist["perf"]
    emit(dict(phase=path, config=loop["config"], data=run.data_source(), tree_s=run.tree_s,
              reduced=dict(run.reduced(path), trace=f"{steps} step: no iteration traced, no "
                           "StepTimer window, no resume"),
              batch=int(cfg.train_batch_size), test_batch=test_batch,
              val_windows=len(val_ds), train_windows=len(train_ds), val_batches=val_batches,
              validations=steps, wall_s=wall, loop_steps_per_s=perf["loop_steps_per_sec"],
              bare_step_steps_per_s=BARE_STEPS_PER_S.get(loop["bare"]),
              validation_s=perf["validation_s"], checkpoint_s=perf["checkpoint_s"],
              batch_assembly_s=perf["batch_assembly_s"], launches=launches,
              variants=variants, peak_mem_gb=peak, losses=losses,
              validation=hist["val"], rescaler=dict(cache=os.path.basename(cache),
                                                    channels=int(cached.size)),
              reload_windows=WDNO_RELOAD_WINDOWS, reload_bit_equal=True,
              reload_bit_equal_default_cudnn=default_equal,
              metrics_card_vs_cpu=metric_cmp, limit_metrics_rel=LOOP_METRICS_REL,
              tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT)))
    VARIANTS_BY_PATH[path] = variants
    run.ckpt_dirs[path] = ckpt_dir
    return launches


def phase_wdno_eval(dev, run: LoopRun, path: str = "wdno_loop") -> dict:
    """python -m realpdebench_tpu_torch eval on WDNO's checkpoint in its
    shipped f32 over the unseen test windows; exact counts; then
    WDNO_PLAIN_WINDOWS windows sampled from the checkpoint through the
    kernels and through the plain f32 path from reseeded generators: the
    loops' eval checks on their metrics, the predictions within
    WDNO_F32_SAMPLE's relative L2, and the kernels' 13 metrics on the card
    within LOOP_METRICS_REL of the CPU's on the same arrays."""
    import math

    from realpdebench_tpu_torch.data.normalizer import build_normalizer
    from realpdebench_tpu_torch.eval.__main__ import build_eval_datasets
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main
    from realpdebench_tpu_torch.eval.metrics import METRIC_NAMES, eval_metrics
    from realpdebench_tpu_torch.eval.rollout import finalize_rollout
    from realpdebench_tpu_torch.train.loop import (
        load_reference_or_orbax_checkpoint,
        model_kwargs,
    )

    loop, name = LOOPS[path], LOOPS[path]["eval"]
    ckpt_dir = run.ckpt_dirs[path]
    argv = [*run.argv(path, evaluating=True), "--checkpoint_path", ckpt_dir]
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, results = cli_run(eval_main, f"the {name}", argv, dataset_class=run.dataset_class)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = _parse(argv, evaluating=True)
    test_ds, train_ds, norm_ds = build_eval_datasets(cfg, run.dataset_class)
    batch, n_steps = int(cfg.test_batch_size), int(cfg.N_autoregressive)
    launches, variants = _check_launches(f"the {name}", loop, 0,
                                         math.ceil(len(test_ds) / batch) * n_steps)
    keys = [*METRIC_NAMES, "normalized_mse"]
    keys += ["probe_error"] if cfg.get("probe_diagnostic") else []
    if set(results) != set(keys) or not all(math.isfinite(results[k]) for k in keys
                                            if k not in ("mid_f_error", "rel_mid_f_error")):
        raise AssertionError(f"eval results not finite, or not {keys}: {results}")

    c = 2
    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
    build = lambda: load_reference_or_orbax_checkpoint(ckpt_dir, build_model(
        train_dataset=train_ds, device=dev, generator=make_generator(int(cfg.seed)),
        **model_kwargs(cfg)))

    # kernels against the plain f32 path on a few windows, the same draws:
    # the loops' eval checks (each metric within EVAL_METRIC_REL, or
    # EVAL_METRIC_ABS below EVAL_SMALL), the predictions within the sample
    # phase's relative L2 (WDNO_F32_SAMPLE[0], tighter than the loops' 5e-2)
    items = [test_ds[i] for i in range(WDNO_PLAIN_WINDOWS)]
    xb, yb = (torch.from_numpy(np.stack([it[j] for it in items])).to(dev) for j in (0, 1))
    kernel, plain = build(), build().eval()
    outs = []
    torch.backends.cudnn.deterministic = True       # as in phase_wdno_sample
    try:
        for m, predictor in ((kernel, kernel), (plain, _PlainPath(plain))):
            m.reseed_dropout(int(cfg.seed))
            pn, xn, yn = make_rollout_fn(predictor, normalizer, n_steps)(xb, yb)
            outs.append(finalize_rollout(normalizer, pn, xn, yn, c)[1:])
    finally:
        torch.backends.cudnn.deterministic = False
    del kernel, plain
    (got, target), (ref, _) = outs
    metric_cmp = _metrics_card_vs_cpu(got, target, c)
    ref_metrics = [float(v) for v in eval_metrics(ref, target, c)]
    row = dict(windows=WDNO_PLAIN_WINDOWS, rel_l2=_rel_l2(got[..., :c], ref[..., :c]),
               limit_rel_l2=WDNO_F32_SAMPLE[0],
               max_abs_over_max_ref=((got - ref).abs().max() / ref.abs().max()).item(),
               metrics={})
    bad = [] if row["rel_l2"] <= WDNO_F32_SAMPLE[0] else ["predictions"]
    for m, a, b in zip(METRIC_NAMES, (float(v) for v in eval_metrics(got, target, c)),
                       ref_metrics):
        small = abs(_compared(m, b)) < EVAL_SMALL
        err = abs(_compared(m, a) - _compared(m, b)) if small else _metric_rel(m, a, b)
        limit = EVAL_METRIC_ABS if small else EVAL_METRIC_REL
        row["metrics"][m] = dict(kernels=a, f32_plain=b, err=err, limit=limit)
        bad += [] if err <= limit else [m]
    if bad:
        raise AssertionError(f"{name}: kernel samples vs plain f32 samples: {bad}: {row}")
    del outs, got, ref, target
    _free()
    emit(dict(phase=name, config=loop["config"], data=run.data_source(),
              reduced=run.reduced(path, evaluating=True), batch=batch,
              n_autoregressive=n_steps, test_windows=len(test_ds), results=results,
              eval_s=secs, frames_per_s=len(test_ds) * n_steps * SHAPE_OUT[0] / secs,
              launches=launches, variants=variants, peak_mem_gb=peak,
              tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT),
              metrics_card_vs_cpu=metric_cmp,
              limit_metrics_rel=LOOP_METRICS_REL, vs_plain_f32=row))
    VARIANTS_BY_PATH[name] = variants
    return launches


def phase_dmd_eval(dev, run: LoopRun) -> dict:
    """python -m realpdebench_tpu_torch eval with configs/cylinder/dmd.yaml
    on the loops' tree, no checkpoint: the forecast on the host, the
    normalizer and the metric sweep on the card, every kernel count 0; the
    13 metrics and the normalized MSE within LOOP_METRICS_REL of the same
    eval on the CPU."""
    from realpdebench_tpu_torch.config import load_config
    from realpdebench_tpu_torch.eval.__main__ import build_eval_datasets
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    shipped = load_config(DMD_CONFIG)
    over = {k: LOOP_OVERRIDES[k] for k in ("n_sim_frame", "n_sim_in_distribution",
                                            "n_sim_out_distribution", "generate_ids_if_missing")}
    for k in ("N_plot", "N_plot_probe"):
        if shipped.get(k) and not run.plots:
            over[k] = (0, shipped.get(k))
    argv = ["--config", DMD_CONFIG, "--dataset_root", run.root,
            "--results_path", f"{run.work}/results"]
    for k, (v, _) in over.items():
        argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    _free()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, card = cli_run(eval_main, "the dmd_eval", argv, dataset_class=run.dataset_class)
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the dmd_eval launched {launches}")
    t0 = time.perf_counter()
    _, host = cli_run(eval_main, "the dmd_eval on the CPU", [*argv, "--device", "cpu"],
                      dataset_class=run.dataset_class)
    cpu_s = time.perf_counter() - t0
    cmp = {k: dict(card=card[k], cpu=b, rel=_metric_rel(k, card[k], b)) for k, b in host.items()}
    bad = [k for k, row in cmp.items() if not row["rel"] <= LOOP_METRICS_REL]
    if bad or set(card) != set(host):
        raise AssertionError(f"dmd_eval on the card vs the CPU: {bad}: {cmp}")
    cfg = _parse(argv, evaluating=True)
    test_ds = build_eval_datasets(cfg, run.dataset_class)[0]
    emit(dict(phase="dmd_eval", config=DMD_CONFIG, data=run.data_source(),
              reduced={k: dict(here=v, shipped=s) for k, (v, s) in over.items()},
              batch=int(cfg.test_batch_size), n_predict=int(cfg.n_predict),
              n_autoregressive=int(cfg.N_autoregressive), test_windows=len(test_ds),
              eval_s=secs, cpu_eval_s=cpu_s,
              frames_per_s=len(test_ds) * int(cfg.n_predict) / secs, launches=launches,
              card_vs_cpu=cmp, limit_rel=LOOP_METRICS_REL,
              tf32_switches=dict(before=TF32_DEFAULTS, after=F32_EXACT)))
    return launches


def phase_arrow(dev, run: LoopRun):
    """The Arrow (Hugging Face V2) backend, where this host imports datasets
    and pyarrow: the loop's tree written through the converter's writer,
    ARROW_WINDOWS windows of each split and type against the HDF5 class's
    (in memory where h5py is missing; mask_prob 0, noise 0) bit for bit,
    the seconds a window of both backends, and the bf16 FNO loop for ARROW_STEPS steps with
    --use_hf_dataset true (exact counts). Returns its launches, or None
    where the host lacks the packages."""
    import importlib.util
    import math

    have = {m: importlib.util.find_spec(m) is not None for m in ("datasets", "pyarrow")}
    if not all(have.values()):
        emit(dict(phase="arrow", host_imports=have,
                  skipped="this host does not import datasets and pyarrow: the Arrow "
                          "backend is held by the CPU tests alone"))
        return None
    import datasets
    import pyarrow

    from realpdebench_tpu_torch.data.fluid import Cylinder
    from realpdebench_tpu_torch.data.hf_datasets import CylinderHFDataset
    from realpdebench_tpu_torch.tools import convert_hdf5_to_hf as conv
    from realpdebench_tpu_torch.train.__main__ import main as train_main

    keys = {k: LOOP_OVERRIDES[k][0] for k in (
        "n_sim_frame", "n_sim_in_distribution", "n_sim_out_distribution",
        "generate_ids_if_missing")}
    h5_cls = run.dataset_class or Cylinder
    for dtype in ("real", "numerical"):     # the id files the index files come from
        h5_cls("cylinder", run.root, dtype, "train", **keys)
    # the tree as Arrow: from the HDF5 files where there are files, else
    # from the same arrays through the converter's writer
    t0 = time.perf_counter()
    if run.arrays is None:
        conv.convert_dataset_v2(run.root, "cylinder")
    else:
        for dtype, sims in run.arrays.items():
            conv.write_dataset_v2(f"{run.root}/cylinder", dtype, (
                conv.fluid_row(n, ch["u"], ch["v"], ch.get("p"))
                for n, ch in sorted(sims.items())))
    write_s = time.perf_counter() - t0

    windows = []
    for mode in ("train", "val", "test"):
        for dtype in ("real", "numerical"):
            ds = [cls("cylinder", run.root, dtype, mode, mask_prob=0.0, noise_scale=0.0,
                      **keys) for cls in (h5_cls, CylinderHFDataset)]
            if len(ds[0]) != len(ds[1]):
                raise AssertionError(f"{mode}/{dtype}: {len(ds[0])} HDF5 windows, "
                                     f"{len(ds[1])} Arrow windows")
            if not len(ds[0]):      # numerical data has a train split alone
                windows.append(dict(split=mode, type=dtype, windows=0))
                continue
            picks = np.linspace(0, len(ds[0]) - 1, ARROW_WINDOWS).astype(int).tolist()
            items, secs = [], []
            for d in ds:
                t0 = time.perf_counter()
                items.append([d[i] for i in picks])
                secs.append((time.perf_counter() - t0) / len(picks))
            for i, ref, got in zip(picks, *items):
                if not all(a.dtype == b.dtype and np.array_equal(a, b)
                           for a, b in zip(ref, got)):
                    raise AssertionError(f"{mode}/{dtype} window {i}: the Arrow item "
                                         "differs from the HDF5 class's")
            windows.append(dict(split=mode, type=dtype, windows=len(ds[0]), checked=picks,
                                shape=list(items[0][0][0].shape[1:]), bit_equal=True,
                                hdf5_class_s_per_window=secs[0],
                                arrow_s_per_window=secs[1]))

    # the bf16 FNO loop on the Arrow tree
    loop = LOOPS["loop"]
    base = [*run.argv("loop"), "--use_hf_dataset", "true", "--train_data_type", "numerical",
            "--num_update", str(ARROW_STEPS), "--results_path", f"{run.work}/arrow"]
    val_batches = math.ceil(len(CylinderHFDataset("cylinder", run.root, "real", "val",
                                                  **keys)) / int(_parse(base).test_batch_size))
    _free()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    _, _, _, hist = cli_run(train_main, "the Arrow loop", base)
    wall = time.perf_counter() - t0
    n_val = ARROW_STEPS // max(1, ARROW_STEPS // 50)
    launches, variants = _check_launches("the Arrow-backed loop", loop, ARROW_STEPS,
                                         n_val * val_batches)
    if len(hist["train_loss"]) != ARROW_STEPS or not all(
            math.isfinite(v) for v in hist["train_loss"]):
        raise AssertionError(f"the Arrow-backed loop's losses: {hist['train_loss']}")
    emit(dict(phase="arrow", host_imports=have, datasets=datasets.__version__,
              pyarrow=pyarrow.__version__, data=run.data_source(), write_s=write_s,
              windows=windows, steps=ARROW_STEPS, validations=n_val, wall_s=wall,
              loop_steps_per_s=hist["perf"]["loop_steps_per_sec"],
              batch_assembly_s=hist["perf"]["batch_assembly_s"],
              losses=hist["train_loss"], launches=launches, variants=variants,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    VARIANTS_BY_PATH["arrow"] = variants
    return launches


def loop_and_eval(dev) -> dict:
    """The loop and eval phases of each loop path, then the Arrow backend
    and the DPOT finetune, on one synthetic tree; then the train-surrogate
    loop on its own Arrow tree; their launch counts by path."""
    run = LoopRun()
    out = {}
    try:
        for path, loop in LOOPS.items():
            sampled = path in SAMPLED_LOOPS
            out[path] = (phase_wdno_loop if sampled else phase_loop)(dev, run, path)
            out[loop["eval"]] = (phase_wdno_eval if sampled else phase_eval)(dev, run, path)
        out["dmd_eval"] = phase_dmd_eval(dev, run)
        arrow = phase_arrow(dev, run)
        if arrow is not None:
            out["arrow"] = arrow
        out["dpot_finetune"] = phase_dpot_finetune(dev, run)
    finally:
        run.close()
    out["surrogate_loop"] = phase_surrogate_loop(dev)
    _free()
    return out


def family_phases(dev, norm, family: str) -> dict:
    """A family's step and rollout phases (phases 13b-13e): f32, then bf16
    but for DPOT's (f32 only). Returns their launch counts by path."""
    out = {}
    dtypes = (None,) if family in DPOT_FAMILIES else (None, "bfloat16")
    for dtype in dtypes:
        suffix = "" if dtype else "_f32"
        out[f"{family}_train{suffix}"] = phase_family_train(dev, norm, family, dtype)
        out[f"{family}_rollout{suffix}"] = phase_family_rollout(dev, norm, family, dtype)
    return out


def main() -> None:
    name = phase_env()
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--only-loop"]:
        # iterating on the entry points: the loop, eval and Arrow phases
        # alone, without the summary and result lines
        phase_build()
        loop_and_eval(dev)
        return
    norm = gaussian_normalizer()
    if sys.argv[1:] == ["--limit-controls"]:
        # two limits' readings against their controls, without the build,
        # the summary and the result lines
        phase_limit_controls(dev, norm)
        return
    build = BackgroundBuild()
    by_path = {}
    for family in BUILD_OVERLAP:
        by_path.update(family_phases(dev, norm, family))
    build.finish(list(by_path))
    summary = phase_kernels(dev)
    summary.update(phase_backward(dev))
    adjoint = summary.pop("t_stage_adjoint")
    summary["t_stage"].update({f"adjoint_{k}": adjoint[k] for k in (
        "ms", "plain_ms", "library_ms", "single_launch_ms", "bound_ms")})
    for k in ("k1", "k2"):
        train_width = summary.pop(f"{k}_train_width")
        summary[k].update({f"train_width_{n}": v for n, v in train_width.items()})
    for key in ("max_abs_err", "max_rel_err"):
        summary["t_stage"][key] = max(summary["t_stage"][key], adjoint[key])
    for k, t in phase_geometries(dev).items():
        summary[k]["surrogate"] = t
    summary.update(phase_ta(dev))
    by_path["rollout"] = phase_slice(dev)
    torch.cuda.empty_cache()
    by_path["rollout_f32"] = phase_slice(dev, compute_dtype=None)
    torch.cuda.empty_cache()
    by_path["train"] = phase_train(dev)
    torch.cuda.empty_cache()
    by_path["train_f32"] = phase_train(dev, compute_dtype=None)
    torch.cuda.empty_cache()
    by_path["surrogate_fno_train_f32"] = phase_surrogate_fno_train(dev)
    by_path["surrogate_fno_rollout_f32"] = phase_surrogate_fno_rollout(dev)
    by_path["fsi_train"] = phase_fsi_train(dev, norm)
    torch.cuda.empty_cache()
    by_path["unet_rollout"] = phase_unet_rollout(dev, norm)
    _free()
    by_path["unet_rollout_f32"] = phase_unet_rollout(dev, norm, compute_dtype=None)
    _free()
    by_path["unet_train"] = phase_unet_train(dev, norm)
    _free()
    by_path["unet_train_f32"] = phase_unet_train(dev, norm, compute_dtype=None)
    _free()
    by_path["surrogate_unet_train_f32"] = phase_surrogate_unet_train(dev)
    _free()
    for dtype in (None, "bfloat16"):
        suffix = "" if dtype else "_f32"
        by_path[f"wdno_train{suffix}"] = phase_wdno_train(dev, dtype)
        _free()
        by_path[f"wdno_sample{suffix}"] = phase_wdno_sample(dev, dtype)
        _free()
    summary.update(phase_gk_scores(dev))
    by_path["gk_rollout"] = phase_gk_rollout(dev, norm)
    torch.cuda.empty_cache()
    by_path["gk_train"] = phase_gk_train(dev, norm)
    _free()
    by_path["gk_rollout_f32"] = phase_gk_rollout(dev, norm, compute_dtype=None)
    _free()
    by_path["gk_train_f32"] = phase_gk_train(dev, norm, compute_dtype=None)
    _free()
    for family in FAMILIES:
        if family not in BUILD_OVERLAP:
            by_path.update(family_phases(dev, norm, family))
    by_path["cno_lrelu"] = phase_cno_lrelu(dev, norm)
    by_path.update(loop_and_eval(dev))
    emit({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k][0], replaces=SOURCES[k][1],
             launches=sum(p[k] for p in by_path.values()),
             launches_by_path={n: p[k] for n, p in by_path.items()},
             variants_by_path={n: v[k] for n, v in VARIANTS_BY_PATH.items()}
             if k in kernels.VARIANTS else None, **summary[k])
        for k in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

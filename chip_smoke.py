#!/usr/bin/env python3
"""Drives the PyTorch / CUDA port of SQAIR (sqair_tpu_torch) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It needs one Hopper card (sm_90a) and the CUDA toolkit, and no network.
Phases, one line each with its own numbers and seconds:

  device         card name, power limit, torch and CUDA versions
  build          nvcc build of sqair_tpu_torch/csrc (or the cached library)
  kernels        every forward kernel against its plain PyTorch version at
                 the shapes the eval and train steps give it (seeded inputs),
                 the fused glimpse encoder's masked and unmasked at 160 rows
                 (every output, the saved tensors included), the fused
                 propagation unroll's at 160 rows and 3 slots (the ten
                 outputs and every residual field) and the fused discovery
                 unroll's at 160 rows and 3 slots on the data generator's
                 frames (the nine outputs, every residual field, the
                 glimpses and the input encoder's layers); the GRU also
                 saving zr and c, as the train step calls it; the MLP,
                 vanilla-RNN, GRU, glimpse and propagation forwards run
                 twice at each shape and must give the same bits
  kernels-bwd    every backward kernel against its plain version at the
                 shapes the train step gives it, the deferred pass's 1600
                 and 4800 rows included, the glimpse backward and the
                 propagation and discovery backwards (every input's and
                 weight's gradient); the vanilla-RNN, MLP, glimpse,
                 propagation and discovery backwards run twice and must
                 give the same bits
  eval           3 eval steps of the release model's flags at full width
                 (weights from a seed, data from the port's generator), with
                 the launch counts of every kernel
  eval-check     batch 0 re-run through the plain versions on the card and
                 on the CPU with the same noise
  timing         CUDA-event medians per forward kernel (kernel, plain
                 version, a chain of torch.addmm + activation or, for the
                 glimpse, propagation and discovery kernels, the port's
                 unfused path, and the bound) and of the eval step
  profile        the device's busy time in one eval step (torch.profiler)
  eval-glimpse   the same 3 eval steps with SQAIR_FUSE_GLIMPSE=1: the glimpse
                 kernel's launch counts and the metrics against the switch-off
                 steps under the same noise; the eval step's time
  eval-cells     the same with SQAIR_FUSE_CELLS=1 and SQAIR_FUSE_GLIMPSE=1
                 (the JAX package's all-opt-in configuration; at the release
                 flags propagation runs fused and discovery unfused): one
                 fused_prop launch per frame, the metrics against the
                 switch-off steps; the eval step's time and busy time
  eval-disc      3 eval steps at DISC_FLAGS (the release flags with
                 early_disc_logit_scale 1, the JAX module default that
                 bench.py takes: no early-discovery lever, so that both
                 frame kernels run), with no switch and with both switches
                 under the same noise: one fused_disc and one fused_prop
                 launch per frame, the metrics against switch off; both
                 settings' eval step time and busy time
  train          3 train steps (record_mode="train", backward, the release
                 flags' RMSProp) on batches of the device-resident sampler,
                 with the launch counts of all six kernels per step
  train-check    one train step's gradients in thirteen runs with the same
                 noise: every kernel with no switch, the glimpse switch and
                 both switches, and with both switches at DISC_FLAGS ("disc");
                 the plain versions on the card with each and on the CPU,
                 and a float64 referee for each switch setting (the plain
                 versions on the card).  Each run goes twice, the second
                 time with the gradient through the kinks at which some run
                 crossed its referee zeroed (``kinks``; in the fused
                 propagation and discovery, per row-slot).  Gate: every
                 kernel run and the CPU run lies, per parameter, at most
                 max(GRAD_TOL, 2 x its plain run's distance) of the
                 parameter's largest referee gradient from its referee.
                 The distances between pairs of runs are printed
  train-timing   CUDA-event medians per backward kernel (kernel, plain
                 version, torch.autograd.grad through the addmm chain or the
                 unfused path, and the bound) and of the train step
  train-profile  the device's busy time in one train step
  train-glimpse  3 train steps with SQAIR_FUSE_GLIMPSE=1 and their launch
                 counts; the train step's time and busy time
  train-cells    3 train steps with both switches and their launch counts;
                 the train step's time and busy time
  train-disc     3 train steps at DISC_FLAGS with no switch and 3 with both
                 switches, from the same weights, batches and noise: exact
                 launch counts, the first step's metrics against switch off
                 (the later steps' distances printed: the updates move the
                 two models apart), both settings' train step time and busy
                 time
  eval-cli       a checkpoint of the trained model swept by
                 sqair_tpu_torch.scripts.eval on the card twice, with
                 SQAIR_FUSE_GLIMPSE=1 alone and with both switches (64
                 sequences of the port's generator): each sweep's nine metric
                 files, its resume and its launch counts; the two sweeps'
                 metrics agree

  release-eval   the release checkpoint in the port's format
                 (sqair_tpu_torch/release/mnist_mlp/1) swept by
                 sqair_tpu_torch.scripts.eval on the card over the 256-sequence
                 font valid set of its flags.json (8 batches of 32, T = 10):
                 launch counts; its nine metrics printed beside the release
                 run's own files (other noise: not gated); batch 0 again with
                 its noise recorded and the render tensors, and on the CPU
                 with that noise: metrics within METRIC_TOL, the resampled
                 particle the same where the two largest perturbed
                 log-weights lie more than 1e-3 apart, and those examples'
                 render tensors within METRIC_TOL
  rollout        sqair_tpu_torch.scripts.rollout on the release checkpoint, 32
                 examples, 100 frames, 5 conditioning frames, with no switch,
                 the glimpse switch and both: launch counts (a generated frame
                 also runs the where prior's cell once a slot), finite
                 outputs, rollout.npz's shapes, discovery's presence 0 in
                 every generated frame; every kernel call of the rollout held
                 against its plain version on the same inputs on the card
                 (checked_calls: within KERNEL_ATOL + KERNEL_RTOL |plain|; the
                 frame kernels under the flip rule below and with a float64
                 referee, as ped-kernels); the same rollout through the plain
                 versions on the card under the recorded noise: the first
                 presence draw that it samples otherwise than the kernels'
                 must have its uniform within FLIP_MARGIN of both
                 probabilities; the two rollouts' distances (generation
                 amplifies the calls' rounding differences: reported, not
                 gated) and the first frame at which they lie PART_AT apart;
                 wall ms and frames/s of one rollout
  rollout-disc   a 10-frame rollout at DISC_FLAGS with both switches and
                 weights from a seed (fused_disc on the generation path),
                 gated as rollout
  experiment     the training CLI (python -m sqair_tpu_torch.scripts.experiment)
                 in this process at the release flags (the synthetic data
                 config's 2048 sequences, T = 10, the device-resident
                 sampler, B = 32, k = 5, full width), 20 steps a run: 10
                 steps a call (one captured CUDA graph of 10 train steps,
                 replayed) against 1 a call; a run killed right after its
                 save at step 10, resumed, against the uninterrupted one; a
                 captured chain of GATE_STEPS (3) steps against as many eager
                 train steps; each gate bit-identical, or within twice the
                 distance of two eager runs of the same steps (printed).  Then, with no
                 switch and both at the release flags and both at DISC_FLAGS:
                 one capture launches N times an eager step's kernels (N = 1,
                 10); the train step's wall ms (median, min, max of repeats),
                 frames/s and device-busy share of eager steps and of N = 1
                 and N = 10 graphs
  ped-kernels    the pedestrian configuration (``ped_flags``: 64x48 frames,
                 32x12 glimpses, the MLP model's module defaults, B = 32,
                 k = 5, T = 10; no early-discovery lever, so that both
                 switches fuse discovery too): every forward and backward
                 kernel against its plain version at each shape of its train
                 step, the glimpse kernels masked and unmasked, the 4800-row
                 decoder, the frame kernels on frames of the port's
                 pedestrian data (their forwards' fields that cross the
                 kernels' own crops held to the float64 plain version where
                 over the fixed bound: ``frame_fields_check``); each kernel's
                 device ms a call there
  ped-eval       3 eval steps of the pedestrian model (weights from a seed,
                 batches of the device sampler over the pedestrian data
                 config's 2048 sequences) with no switch, the glimpse switch
                 and both: launch counts, metrics against no switch
  ped-train      3 train steps in each setting: launch counts, the first
                 step's metrics against no switch
  ped-train-check  one train step's gradients: the kernels with no switch
                 and with both, the plain versions on the card with each and
                 on the CPU, against float64 referees, kinks masked, gated as
                 train-check
  ped-experiment a 10-step graph against 10 eager steps (both switches); the
                 training CLI on the pedestrian data and model configs with
                 --on_device_data --steps_per_call 10 and from the host (10
                 steps, an eval at 0 and 10, launch counts); then both
                 switches timed as the experiment phase times its settings
  font-data      the font glyph banks read from the port's glyph file (their
                 SHA-256), then the training CLI for FONT_CLI_STEPS (2) steps
                 at the small-digit data and model configs and at the release
                 flags with their own font data config, on
                 FONT_TRAIN_SEQUENCES train and FONT_VALID_SEQUENCES valid
                 sequences (a render of a glyph bank fails the phase): the
                 retuned flags, finite losses, the last step's eval
  on-device-data OnDeviceSeqMNIST renders bench.py's set on the card (64
                 stroke templates, 50x50, T = 10, 2048 sequences, generator
                 seed 42); the same draws rendered on the CPU agree to 1e-5;
                 counts within n_objects, pixels within [0, 1]; render ms
  conv-setup     the conv configuration (``conv_flags``: conv_mnist_model's
                 module defaults, conv channels 32,64, 256 wide, n_what 50,
                 20x20 glimpses, B = 32, k = 5, T = 10 on 50x50 frames of the
                 stroke-digit data the release phases use; weights from a
                 seed): its feature widths (10816 and 1600) and cuDNN's
                 settings after the model is loaded (deterministic, no TF32)
  conv-kernels   the MLP kernel at the conv shapes (one linear layer: the
                 input encoder's 10816 -> 256, the glimpse encoder's 1600 ->
                 256, the subpixel decoder's seed 50 -> 400), forward and
                 backward (the encoders' dx included): device ms a call, the
                 plain version's, the library call's and the bound
  conv-eval      3 eval steps with no switch and with both switches (the
                 conv model fuses nothing: the same launches and metrics),
                 every kernel call held to its plain version (checked_calls)
  conv-train     3 train steps in each setting, every forward and backward
                 call held to its plain version (checked_bwd_calls; the input
                 encoder's 10816-wide dx must be among them), launch counts
  conv-train-check  one train step's gradients, the kernels and the plain
                 versions on the card, against the float64 referee, gated as
                 train-check
  conv-profile   the train step's time and its device time by group
                 (convolutions, the twelve kernels, the rest) in one step
  conv-experiment  a GATE_STEPS-step graph against as many eager steps; eager and N = 1
                 and N = 10 graphs timed as the experiment phase times its
                 settings; the training CLI on the conv config with
                 --on_device_data --steps_per_call 10
  conv-eval-cli, conv-rollout  a conv checkpoint swept by scripts/eval.py
                 and rolled out for 10 frames by scripts/rollout.py (both
                 build the model from its flags.json), every kernel call of
                 the rollout held to its plain version
  options        the release flags with LSTM cells in all three roles, with
                 the rw prior and with the guided prior: 3 eval and 3 train
                 steps each, no switch and both, every call held to its plain
                 version, launch counts (LSTM cells keep the frame kernels off)
  options-optimizers  3 graphed train steps of adam, sgd and momentum
                 against as many eager steps, bit for bit
  options-coverage  the training CLI for 3 steps with --disc_coverage_signal
                 --coverage_lr_mult 10 at DISC_FLAGS with both switches: no
                 fused discovery launch, the coverage rows' updates scaled
  dp-nccl1       data parallelism (sqair_tpu_torch/parallel) in this process,
                 one rank over NCCL: 3 RMSProp steps of the parallel train step
                 at the release flags (B 32, k 5, T 10) against the
                 single-process step on the same noise, and the parallel eval
                 step against the eval step: bit-identical; launch counts; one
                 profiled parallel step shows NCCL's all-reduce (the profiler's
                 nccl:all_reduce record) and lists NCCL's kernels on the device
                 (one rank's in-place SUM launches none)
  dp-two-ranks   two worker processes (``--dp-worker``) share the card
                 through gloo (named: NCCL refuses two ranks on one device),
                 global B 32, 3 steps with no switch and with both switches,
                 every kernel call of a rank's step (80 rows) held to its plain
                 version (checked_calls, checked_bwd_calls), launch counts at
                 the rank's shapes, the ranks' parameter digests equal after
                 every step; the ranks' recorded noise replayed here through a
                 two-shard oracle (per-shard gradients, (g0 + g1) / 2,
                 RMSProp): parameters and finalized metrics bit-identical
  dp-cli         the training CLI with --coordinator_address at
                 --num_processes 1 over NCCL for 20 steps against the same run
                 without a coordinator: the same records and parameters
  tools          tools/time_step_torch.py (eager and an N = 10 graph) and
                 tools/profile_step_torch.py (the sub-steps and a trace) at
                 the release flags, short; tools/eval_one_ckpt_torch.py and
                 tools/diag_presence_logits_torch.py on the release checkpoint
                 over 2 batches; tools/promote_release_torch.py of dp-cli's
                 run, the promoted checkpoint swept by scripts/eval.py;
                 notebooks/play_torch.py --quick_train; which path the native
                 datagen binding took

Each phase group prints its seconds (``seconds=``), and the last phase
line the total.  ``--only=conv,options,dp`` runs those phase groups alone
after the build, for development, and prints no result lines (dp: the
dp-* phases and tools).

It exits non-zero on any failure.  The last two lines are a JSON object of
the kernels' numbers and the JSON result line.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

import numpy as np

REPO = Path(__file__).resolve().parent
RELEASE_FLAGS = REPO / "release_models" / "mnist_mlp" / "1" / "flags.json"
# the release checkpoint in the port's format, and the JAX package's run dir
# whose metric files it reproduces
PORT_RELEASE = REPO / "sqair_tpu_torch" / "release" / "mnist_mlp" / "1"
RELEASE_RUN = REPO / "release_models" / "mnist_mlp" / "1"
SEED = 0
N_BATCHES = 3
N_TRAIN_STEPS = 3
CLI_SEQUENCES = 64  # eval-cli: two batches of 32
REPS = 10
STEP_REPS = 5  # timed repeats of a whole eval or train step
IMG = (50, 50)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# tolerances, with why: the kernel and its plain version compute the same
# f32 sums in another order, over at most 2500 terms of size ~1
KERNEL_ATOL, KERNEL_RTOL = 1e-5, 1e-4
# a backward's weight gradients sum up to 4800 products in another order
# than cuBLAS; small entries of a sum with cancellation carry the error of
# the large ones, so the bound is relative to each gradient's largest entry
BWD_TOL = 1e-4  # |d| <= BWD_TOL max|value| + 1e-6, per gradient tensor
# the eval metrics sum the forward differences over T x 2S dependent cell steps
METRIC_TOL = 1e-4  # on |a - b| / (|b| + 1)
# a presence draw that two runs sample differently counts as crossed only
# where its uniform lies within this of both runs' probabilities (the f32
# differences of a kernel and its plain version move a probability by
# ~1e-6); any other flip fails, and frames from the first crossed flip on
# are reported, not gated
FLIP_MARGIN = 1e-4
# two rollouts count as parted from the first frame at which a field lies
# this far apart (scaled as METRIC_TOL); reported, not gated
PART_AT = 1e-2
# a whole step's parameter gradients: every f32 difference of the step,
# carried through T x 2S dependent cells, VIMCO and the transient penalty,
# and summed over up to 4800 rows with cancellation.  A run of the plain
# versions on the card lies up to ~1.5e-2 of a parameter's largest gradient
# from a float64 referee (scale_offset, PERF.md): train-check holds each run
# to the referee at max(GRAD_TOL, 2x that run's distance), per parameter
GRAD_TOL = 1e-2  # |g - g64| <= max(GRAD_TOL max|g64|, 2 |g_plain - g64|) + 1e-6
# train-check's runs: name -> (model: the card's, a CPU copy or a float64
# copy on the card; switches; plain versions), and the float64 referee of
# each switch setting
# ("cells" is the JAX package's all-opt-in configuration: the frame kernels,
# at the release flags only propagation's, and the glimpse encoder)
# ("disc": both switches on the model at DISC_FLAGS, where discovery runs
# fused too)
SWITCHES = {"off": {}, "glimpse": {"SQAIR_FUSE_GLIMPSE": "1"},
            "cells": {"SQAIR_FUSE_CELLS": "1", "SQAIR_FUSE_GLIMPSE": "1"},
            "disc": {"SQAIR_FUSE_CELLS": "1", "SQAIR_FUSE_GLIMPSE": "1"}}
TRAIN_RUNS = {"kernels": ("card", "off", False), "plain_on_card": ("card", "off", True),
              "cpu": ("cpu", "off", True), "glimpse_kernels": ("card", "glimpse", False),
              "glimpse_plain": ("card", "glimpse", True),
              "cells_kernels": ("card", "cells", False), "cells_plain": ("card", "cells", True),
              "disc_kernels": ("disc_card", "disc", False),
              "disc_plain": ("disc_card", "disc", True),
              "referee": ("f64", "off", True), "referee_on": ("f64", "glimpse", True),
              "referee_cells": ("f64", "cells", True), "referee_disc": ("disc_f64", "disc", True)}
REFEREES = {"off": "referee", "glimpse": "referee_on", "cells": "referee_cells",
            "disc": "referee_disc"}
# the gate: each run against its referee, per parameter, at
# max(GRAD_TOL, 2 x the distance of the plain run on the card with the same
# switches) of the parameter's largest referee gradient.  A scalar whose
# gradient is a sum with heavy cancellation (scale_offset) can lie 1.5e-2
# from the referee in a kernel-free run; a bound on a pair of f32 runs
# cannot tell that from a kernel's fault, one on the distance to the
# referee can.  The CPU run, with no kernel at all, is held to it too.
REFEREE_GATE = {"kernels": ("plain_on_card",), "cpu": ("plain_on_card",),
                "glimpse_kernels": ("glimpse_plain",), "cells_kernels": ("cells_plain",),
                "disc_kernels": ("disc_plain",)}
# pairs of runs whose distances are printed (not gated)
GRADIENT_PAIRS = {"kernels_vs_plain_on_card": ("kernels", "plain_on_card"),
                  "kernels_vs_cpu": ("kernels", "cpu"),
                  "plain_on_card_vs_cpu": ("plain_on_card", "cpu"),
                  "switch_on_kernels_vs_switch_off_plain": ("glimpse_kernels", "plain_on_card"),
                  "switch_on_plain_vs_switch_off_plain": ("glimpse_plain", "plain_on_card"),
                  "cells_kernels_vs_cells_plain": ("cells_kernels", "cells_plain"),
                  "cells_kernels_vs_switch_off_plain": ("cells_kernels", "plain_on_card"),
                  "disc_kernels_vs_disc_plain": ("disc_kernels", "disc_plain")}
# the runs of one group make the same calls, so that a kink of one lines up
# with the same kink of another (the cells and disc switches fuse others)
KINK_GROUPS = {"off": "off_glimpse", "glimpse": "off_glimpse", "cells": "cells", "disc": "disc"}
# DISC_FLAGS: the release flags with these levers (no early-discovery logit
# lever: the JAX package then fuses discovery under SQAIR_FUSE_CELLS)
DISC_LEVERS = {"early_disc_logit_scale": 1.0}

FORWARD = ("fused_mlp", "fused_vanilla_rnn", "fused_gru", "fused_glimpse", "fused_prop",
           "fused_disc")
KERNELS = {
    "fused_mlp": dict(source="sqair_tpu_torch/csrc/fused_mlp.cu",
                      replaces="sqair_tpu/ops/fused.py:111"),
    "fused_vanilla_rnn": dict(source="sqair_tpu_torch/csrc/fused_rnn.cu",
                              replaces="sqair_tpu/ops/fused.py:201"),
    "fused_gru": dict(source="sqair_tpu_torch/csrc/fused_rnn.cu",
                      replaces="sqair_tpu/ops/fused.py:308"),
    "fused_mlp_bwd": dict(source="sqair_tpu_torch/csrc/fused_bwd.cu",
                          replaces="sqair_tpu/ops/fused.py:130"),
    "fused_vanilla_rnn_bwd": dict(source="sqair_tpu_torch/csrc/fused_bwd.cu",
                                  replaces="sqair_tpu/ops/fused.py:218"),
    "fused_gru_bwd": dict(source="sqair_tpu_torch/csrc/fused_bwd.cu",
                          replaces="sqair_tpu/ops/fused.py:330"),
    "fused_glimpse": dict(source="sqair_tpu_torch/csrc/fused_glimpse.cu",
                          replaces="sqair_tpu/ops/fused_glimpse.py:264"),
    "fused_glimpse_bwd": dict(source="sqair_tpu_torch/csrc/fused_glimpse.cu",
                              replaces="sqair_tpu/ops/fused_glimpse.py:299"),
    "fused_prop": dict(source="sqair_tpu_torch/csrc/fused_prop.cu",
                       replaces="sqair_tpu/ops/fused_cells.py:1332"),
    "fused_prop_bwd": dict(source="sqair_tpu_torch/csrc/fused_prop.cu",
                           replaces="sqair_tpu/ops/fused_cells.py:1363"),
    "fused_disc": dict(source="sqair_tpu_torch/csrc/fused_disc.cu",
                       replaces="sqair_tpu/ops/fused_cells.py:733"),
    "fused_disc_bwd": dict(source="sqair_tpu_torch/csrc/fused_disc.cu",
                           replaces="sqair_tpu/ops/fused_cells.py:765"),
}
# the CUDA kernels redesigned for Hopper whose profile rows are always
# printed, and the wrappers whose two runs on the same inputs must give the
# same bits (the kernels check)
REDESIGNED = ("fused_mlp_kernel", "fused_vrnn_kernel", "fused_gru_kernel", "vrnn_bwd_kernel",
              "mlp_bwd_kernel", "prop_bwd_kernel", "tile_reduce_kernel", "glimpse_bwd_kernel",
              "prop_fwd_kernel", "glimpse_fwd_kernel", "disc_bwd_kernel", "gru_bwd_kernel",
              "disc_fwd_kernel")
SAME_BITS = ("fused_mlp", "fused_vanilla_rnn", "fused_gru", "fused_vanilla_rnn_bwd",
             "fused_mlp_bwd", "fused_prop_bwd", "fused_glimpse_bwd", "fused_prop", "fused_glimpse",
             "fused_disc_bwd", "fused_gru_bwd", "fused_disc")
GLIMPSE_SWITCH = SWITCHES["glimpse"]
CELLS_SWITCH = SWITCHES["cells"]
# the experiment phase: a CLI run's steps, the graphed chain's steps a call,
# the timing's repeats; the release flags the phase sets itself
CLI_STEPS, CHAIN_STEPS, TIMING_REPEATS = 20, 10, 3
# cut depths: the experiment and conv graph gates' steps, the
# font-data CLI runs' steps and valid sequences
GATE_STEPS, FONT_CLI_STEPS, FONT_VALID_SEQUENCES = 3, 2, 64
# the valid sequences of the CLI runs (evals at their first and last step)
CLI_VALID = 64
# font-data: the release font run's train sequences (its flags.json has 16384;
# the host renders each call)
FONT_TRAIN_SEQUENCES = 2048
# on-device-data: bench.py's fixed set of sequences
ON_DEVICE_SEQUENCES = 2048
# the rollout phase: scripts/rollout.py on the release checkpoint
ROLLOUT = dict(n_examples=32, rollout_len=100, condition_frames=5)
ROLLOUT_SETTINGS = (("no_switch", {}), ("glimpse", GLIMPSE_SWITCH), ("both", CELLS_SWITCH))
ROLLOUT_REPEATS = 1
DISC_ROLLOUT_LEN = 10
CLI_SET = {"git_commit", "resume", "results_dir", "run_name", "data_config", "seq_len",
           "stage_itr", "train_itr", "save_itr", "report_loss_every", "log_itr", "fig_itr",
           "steps_per_call", "on_device_data"}


def log(phase, t0, **fields):
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body} seconds={time.perf_counter() - t0:.3f}", flush=True)


def jdump(obj):
    return json.dumps(obj, separators=(",", ":"))


class Failure(Exception):
    pass


def glimpse_hw(F):
    """(gh, gw) of the flags' glimpse: ``glimpse_hw`` "h,w" where the flags
    have it (the pedestrian model config), else the square glimpse_size."""
    if F.get("glimpse_hw"):
        gh, gw = (int(v) for v in str(F["glimpse_hw"]).split(","))
        return gh, gw
    g = int(F["glimpse_size"])
    return g, g


def glimpse_shapes(F, rows, T, img=IMG):
    """The fused glimpse encoder's calls of one step on frames of ``img``,
    as (shape, calls): twice per propagation slot with the mask (when
    masked_glimpse), once per discovery slot without it."""
    h, w = 32 * int(F["n_units"]), int(F["n_what"])
    S = int(F["n_steps_per_image"])
    base = dict(n=rows, img=list(img), glimpse=list(glimpse_hw(F)), d1=h, d2=h, n_what=w)
    masked = F.get("masked_glimpse", True)
    prop = dict(base, d_mi=h if masked else 0, d_m=128 if masked else 0)
    return [(prop, 2 * S * T), (dict(base, d_mi=0, d_m=0), S * T)]


def prop_shape(F, rows, img=IMG):
    """The fused propagation kernel's shape at the flags ``F``."""
    h = 32 * int(F["n_units"])
    return dict(n=rows, S=int(F["n_steps_per_image"]), img=list(img),
                glimpse=list(glimpse_hw(F)), n_what=int(F["n_what"]), U=h, SP=h // 2, WB=128,
                MH=128)


# the kernel of a cell of each flag name (the LSTM runs in plain PyTorch, as
# the JAX package runs it in XLA)
CELL_KERNELS = {"VanillaRNN": "fused_vanilla_rnn", "GRU": "fused_gru", "LSTM": None}


def is_conv(F):
    """Whether the flags' model is the conv model (``conv_mnist_model``)."""
    return str(F.get("model_config", "")).endswith("conv_mnist_model.py")


def conv_features(F, size):
    """The width of a ConvEncoder's flattened features on a side-``size``
    input: one stride-2 SAME conv a channel count of ``conv_channels``."""
    channels = [int(c) for c in str(F.get("conv_channels", "32,64")).split(",")]
    h, w = size
    for _ in channels:
        h, w = -(-h // 2), -(-w // 2)
    return h * w * channels[-1]


def coverage_on(F):
    """The coverage signal is on (the conv config leaves it off)."""
    return bool(F.get("disc_coverage_signal")) and not is_conv(F)


def prop_fusable(F):
    """Whether the JAX package fuses propagation under SQAIR_FUSE_CELLS at
    the flags ``F``: a VanillaRNN transition, a GRU temporal cell, and the
    MLP glimpse encoder (a ConvEncoder's MLP_0 has one layer)."""
    return (not is_conv(F) and F.get("transition", "VanillaRNN") == "VanillaRNN"
            and F.get("time_transition", "GRU") == "GRU")


def disc_fusable(F):
    """Whether the JAX package fuses discovery under SQAIR_FUSE_CELLS at the
    flags ``F``: no early-discovery logit lever, no coverage signal, a
    VanillaRNN transition and the MLP encoders (the kernel's MLP depths
    hold for every MLP model this script loads)."""
    if is_conv(F):
        return False
    return not (float(F.get("early_disc_logit_bias", 0.0))
                or float(F.get("early_disc_logit_clamp", 0.0))
                or float(F.get("early_disc_logit_scale", 1.0)) != 1.0
                or coverage_on(F) or F.get("transition", "VanillaRNN") != "VanillaRNN")


def disc_shape(F, rows, img=IMG):
    """The fused discovery kernel's shape at the flags ``F`` (the
    conditioning is the propagation summary, n_hidden wide)."""
    h = 32 * int(F["n_units"])
    return dict(n=rows, S=int(F["n_steps_per_image"]), img=list(img),
                glimpse=list(glimpse_hw(F)), n_what=int(F["n_what"]), U=h, SP=h // 2, C=h)


def main_path_shapes(F, B, k, T, train=False, img=IMG, fuse_glimpse=False, fuse_cells=False,
                     generate=False):
    """Every forward kernel call of one eval or train step on frames of
    ``img``, as (kernel, shape, calls per step).  In the train record the decode, the
    discovery where prior and the count prior leave the time loop and run
    once over all T frames (rows T*B*k, or T*B*k*S for the decode).  With
    ``fuse_glimpse`` (SQAIR_FUSE_GLIMPSE) the glimpse encoder and its mask
    leave fused_mlp for the fused glimpse kernel.  With ``fuse_cells``
    (SQAIR_FUSE_CELLS) each frame's propagation slots are one fused_prop
    call where the flags let it (``prop_fusable``), and where they let it
    (``disc_fusable``) its input encoder and discovery slots one fused_disc
    call; their MLPs, cells and glimpses leave the other kernels.  With
    ``generate`` (sample_from_prior: a rollout) the train record keeps its
    log-probs and decode in the loop, and every frame also samples
    discovery's where prior, its cell once a slot.

    The conv model (``is_conv``) fuses nothing under either switch (JAX's
    gates refuse its one-layer encoder MLPs): its encoders' and its
    subpixel decoder's seed MLPs are one linear fused_mlp layer each, its
    convolutions cuDNN's.  A cell flag of LSTM takes the cell's calls out
    of the kernels (``CELL_KERNELS``) and keeps the frame kernels off; the
    coverage signal widens the discovery presence MLP by 16 and keeps the
    discovery unfused."""
    h = 32 * int(F["n_units"])
    w, S = int(F["n_what"]), int(F["n_steps_per_image"])
    gh, gw = glimpse_hw(F)
    g = gh * gw
    rows = B * k
    slots = rows * S
    sp = h // 2
    conv = is_conv(F)
    cov = 16 if coverage_on(F) else 0
    fuse_glimpse = fuse_glimpse and not conv
    deferred = T if train and not generate else 1  # rows factor of the out-of-loop calls
    per_call = T // deferred  # calls factor of the same calls
    fuse_prop = fuse_cells and prop_fusable(F)
    prop = 0 if fuse_prop else 1  # calls factor of the propagation slots' calls
    fuse_disc = fuse_cells and disc_fusable(F)
    disc = 0 if fuse_disc else 1  # calls factor of the discovery's calls
    if conv:
        encoders = [(conv_features(F, img), [h], ["id"], rows, T),  # input encoder
                    (conv_features(F, (gh, gw)), [h], ["id"], rows, 3 * S * T)]  # glimpse
        decoder = (w, [400], ["id"], slots * deferred, per_call)  # subpixel decoder's seed
    else:
        encoders = [(img[0] * img[1], [h, h], ["elu", "elu"], rows, disc * T),
                    (g, [h, h], ["elu", "elu"], rows,
                     0 if fuse_glimpse else (disc + 2 * prop) * S * T)]
        decoder = (w, [h, h, g], ["elu", "elu", "id"], slots * deferred, per_call)
    mlp = encoders + [  # (d_in, widths, transfers, rows, calls per step)
        (h, [128, g], ["elu", "sigmoid"], rows, 0 if fuse_glimpse else 2 * prop * S * T),  # mask
        (h, [h, h, 8], ["elu", "elu", "id"], rows, disc * S * T),  # disc where
        (2 * h + 4, [h, h, 8], ["elu", "elu", "id"], rows, prop * S * T),  # prop where
        (h + w + cov, [sp, 1], ["elu", "id"], rows, disc * S * T),  # disc presence
        (2 * h + w, [sp, 1], ["elu", "id"], rows, prop * S * T),  # prop presence
        (h, [128, 4], ["elu", "id"], rows, prop * S * T),     # where bias
        (h, [3 * w], ["sigmoid"], rows, prop * S * T),        # what gates
        (w + 4, [h, h], ["elu", "elu"], slots, T),            # latent encoder
        (1, [10, S + 1], ["elu", "id"], rows * deferred, per_call),       # count prior
        decoder,
    ]
    cells = [  # (kernel, d_x, units, rows, calls per step)
        (CELL_KERNELS[F.get("transition", "VanillaRNN")], h + h + w + 5, h, rows,
         disc * S * T),  # discovery transition
        (CELL_KERNELS[F.get("transition", "VanillaRNN")], 3 * w + 10 + h, h, rows,
         prop * S * T),  # propagation transition
        ("fused_vanilla_rnn", 4, 4, rows * deferred,
         (2 if generate else 1) * S * per_call),  # where prior
        (CELL_KERNELS[F.get("prior_transition", "GRU")], w + 4, h, slots, T),  # prop prior
        (CELL_KERNELS[F.get("time_transition", "GRU")], h + 4 + 2 * w, h, rows,
         prop * S * T),  # temporal cell
    ]
    out = [("fused_mlp", dict(d_in=d, widths=ws, acts=a, n=n), c) for d, ws, a, n, c in mlp
           if c]
    for kernel in ("fused_vanilla_rnn", "fused_gru"):
        out += [(kernel, dict(dx=d, units=u, n=n), c) for kn, d, u, n, c in cells
                if c and kn == kernel]
    if fuse_glimpse:
        out += [("fused_glimpse", shape, c) for shape, c in glimpse_shapes(F, rows, T, img)
                if c and not (fuse_prop if shape["d_mi"] else fuse_disc)]
    if fuse_prop:
        out += [("fused_prop", prop_shape(F, rows, img), T)]
    if fuse_disc:
        out += [("fused_disc", disc_shape(F, rows, img), T)]
    return out


def expected_launches(shapes, steps, backward=False):
    """Launches of each kernel of ``shapes`` over ``steps`` steps; with
    ``backward``, also one backward launch per forward call (every call's
    output reaches the loss)."""
    names = [name for name in FORWARD if any(kn == name for kn, _, _ in shapes)]
    out = {name: steps * sum(c for kn, _, c in shapes if kn == name) for name in names}
    if backward:
        out.update({name + "_bwd": out[name] for name in names})
    return out


def needs_dx(kernel, shape, img=IMG):
    """False for the one call whose input carries no gradient: the MLP
    input encoder reads the frames (the conv input encoder's MLP reads the
    convolutions' features, whose gradient it gives)."""
    return not (kernel == "fused_mlp" and shape["d_in"] == img[0] * img[1])


def fwd_geometry(fused, kernel, shape):
    """The host's launch geometry of a forward kernel redesigned for Hopper."""
    if kernel == "fused_mlp":
        return fused.mlp_fwd_geometry(shape["n"], [shape["d_in"]] + shape["widths"])
    geometry = fused.vrnn_fwd_geometry if kernel == "fused_vanilla_rnn" else fused.gru_fwd_geometry
    return geometry(shape["n"], shape["dx"], shape["units"])


def make_inputs(torch, kernel, shape, gen, device):
    """Seeded inputs at a kernel's shape: x in [0, 1) like the image and the
    probabilities, weights of lecun scale, small biases."""
    def rand(*s):
        return torch.rand(s, generator=gen, device=device)

    def weight(d_in, d_out):
        return torch.randn((d_in, d_out), generator=gen, device=device) / math.sqrt(d_in)

    def bias(d):
        return 0.1 * torch.randn((d,), generator=gen, device=device)

    if kernel == "fused_mlp":
        dims = [shape["d_in"]] + shape["widths"]
        params = tuple((weight(a, b), bias(b)) for a, b in zip(dims[:-1], dims[1:]))
        return (rand(shape["n"], shape["d_in"]), params, tuple(shape["acts"]))
    n, dx, u = shape["n"], shape["dx"], shape["units"]
    x, h = rand(n, dx), 2 * rand(n, u) - 1
    if kernel == "fused_vanilla_rnn":
        return (x, h, weight(dx, u), weight(u, u), bias(u))
    return (x, h, weight(dx, 2 * u), weight(u, 2 * u), bias(2 * u), weight(dx, u),
            weight(u, u), bias(u))


def make_bwd_inputs(torch, fused, kernel, args, gen):
    """The backward's inputs for forward inputs ``args``: the saved tensors
    from the plain forward and a seeded output gradient."""
    if kernel == "fused_mlp":
        x, params, acts = args
        saved = fused.mlp_plain_acts(x, params, acts)
        g = torch.randn(saved[-1].shape, generator=gen, device=x.device)
        return (x, params, acts, saved, g)
    if kernel == "fused_vanilla_rnn":
        x, h, w, u, b = args
        hn = fused.vanilla_rnn_plain(*args)
        return (x, h, w, u, hn, torch.randn(hn.shape, generator=gen, device=x.device))
    x, h, wg, ug, bg, wc, uc, bc = args
    hn, zr, c = fused.gru_plain_saving(*args)
    return (x, h, wg, ug, wc, uc, zr, c, torch.randn(hn.shape, generator=gen, device=x.device))


def flat_grads(kernel, out):
    """The backward's results as a flat list of tensors (None where skipped)."""
    if kernel == "fused_mlp":
        dx, dparams = out
        return [dx] + [t for p in dparams for t in p]
    return list(out)


def work(kernel, shape, backward=False, need_dx=True):
    """(bytes read once and written once, f32 FLOPs) of one call, forward or
    backward.  A backward does twice the forward's products, less the
    input's gradient where it is skipped."""
    n = shape["n"]
    if kernel == "fused_mlp":
        dims = [shape["d_in"]] + shape["widths"]
        weights = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        macs = n * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        if not backward:
            return 4 * (n * dims[0] + weights + n * dims[-1]), 2 * macs
        acts = n * sum(dims[1:])
        w_only = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        nbytes = 4 * (n * dims[0] + w_only + acts + n * dims[-1]  # x, W, saved, g
                      + (n * dims[0] if need_dx else 0) + weights)  # dx, dW, db
        return nbytes, 2 * (2 * macs - (0 if need_dx else n * dims[0] * dims[1]))
    dx, u = shape["dx"], shape["units"]
    mult = 1 if kernel == "fused_vanilla_rnn" else 3  # the GRU's gates + candidate
    weights = mult * ((dx + u) * u + u)
    macs = n * mult * (dx + u) * u
    if not backward:
        return 4 * (n * (dx + u) + weights + n * u), 2 * macs
    saved = n * u if kernel == "fused_vanilla_rnn" else 3 * n * u  # h' | zr, c
    nbytes = 4 * (n * (dx + u) + (weights - mult * u) + saved + n * u  # x, h, W, saved, g
                  + n * (dx + u) + weights)                            # dx, dh, dW, db
    return nbytes, 2 * 2 * macs


def library_fn(torch, kernel):
    """The same function as one chain of torch.addmm + activation (a
    yardstick only: the port never calls it)."""
    F = torch.nn.functional
    act = {"id": lambda z: z, "elu": F.elu, "sigmoid": torch.sigmoid, "tanh": torch.tanh}
    if kernel == "fused_mlp":
        def mlp(x, params, acts):
            for (w, b), a in zip(params, acts):
                x = act[a](torch.addmm(b, x, w))
            return x
        return mlp
    if kernel == "fused_vanilla_rnn":
        return lambda x, h, w, u, b: torch.tanh(torch.addmm(torch.addmm(b, x, w), h, u))

    def gru(x, h, wg, ug, bg, wc, uc, bc):
        zr = torch.sigmoid(torch.addmm(torch.addmm(bg, x, wg), h, ug))
        z, r = zr[:, :h.shape[1]], zr[:, h.shape[1]:]
        c = torch.tanh(torch.addmm(torch.addmm(bc, x, wc), r * h, uc))
        return (1 - z) * h + z * c
    return gru


def library_bwd_fn(torch, kernel, args, need_dx, gen):
    """A call of torch.autograd.grad through the addmm chain's graph (built
    once) for the same gradients as the backward kernel."""
    leaves = []

    def leaf(t, grad=True):
        t = t.detach().clone().requires_grad_(grad)
        if grad:
            leaves.append(t)
        return t

    if kernel == "fused_mlp":
        x, params, acts = args
        lib_args = (leaf(x, need_dx), tuple((leaf(w), leaf(b)) for w, b in params), acts)
    else:
        lib_args = tuple(leaf(t) for t in args)
    y = library_fn(torch, kernel)(*lib_args)
    g = torch.randn(y.shape, generator=gen, device=y.device)
    return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)


def glimpse_inputs(torch, shape, gen, device):
    """Seeded inputs of one fused glimpse call: (img, where logits, mask
    input or None, mask params or None, encoder params, head W, head b)."""
    n, (H, W), (gh, gw) = shape["n"], shape["img"], shape["glimpse"]
    d1, d2, nw, d_mi, d_m = (shape[k] for k in ("d1", "d2", "n_what", "d_mi", "d_m"))

    def weight(a, b):
        return torch.randn((a, b), generator=gen, device=device) / math.sqrt(a)

    def bias(d, loc=0.0):
        return loc + 0.1 * torch.randn((d,), generator=gen, device=device)

    img = torch.rand((n, H, W), generator=gen, device=device)
    wl = torch.randn((n, 4), generator=gen, device=device)
    mi = mask = None
    if d_mi:
        mi = torch.randn((n, d_mi), generator=gen, device=device)
        mask = ((weight(d_mi, d_m), bias(d_m)), (weight(d_m, gh * gw), bias(gh * gw, 1.0)))
    enc = ((weight(gh * gw, d1), bias(d1)), (weight(d1, d2), bias(d2)))
    return img, wl, mi, mask, enc, weight(d2, 2 * nw), bias(2 * nw)


def glimpse_dims(shape):
    return (shape["glimpse"][0], shape["glimpse"][1], shape["n_what"])


def crop_macs(H, W, gh, gw, backward=False):
    """Multiply-adds of one row's bilinear crop at the two non-zeros of each
    interpolation row (a row of wy or wx weights at most two pixels):
    A = img wx^T (2 per element of A [H, gw]) and g0 = wy A (2 per glimpse
    pixel); the backward forms A again, dwy and dwx at the two pixels of
    each row (gw- and H-long sums) and dA = wy^T dg0 (2 gw per row of wy)."""
    if not backward:
        return 2 * H * gw + 2 * gh * gw
    return 2 * H * gw + 2 * gh * gw + 2 * gh * gw + 2 * gw * H


def glimpse_work(shape, backward=False):
    """(bytes read once and written once, f32 FLOPs) of one fused glimpse
    call.  Forward: the crop (``crop_macs``), the mask MLP, the encoder and
    the head; the outputs loc and scale.  Backward: twice the products of
    the mask, the encoder and the head, and the crop's backward; it reads
    the saved tensors and the output gradients and writes every parameter's
    gradient, where's and the mask input's."""
    n, (H, W), (gh, gw) = shape["n"], shape["img"], shape["glimpse"]
    d1, d2, nw, d_mi, d_m = (shape[k] for k in ("d1", "d2", "n_what", "d_mi", "d_m"))
    G, D = gh * gw, 2 * nw
    mats = [(d_mi, d_m), (d_m, G)] if d_mi else []
    mats += [(G, d1), (d1, d2), (d2, D)]
    weights = sum(a * b for a, b in mats)
    biases = sum(b for _, b in mats)
    mlp_macs = n * weights
    crop = n * crop_macs(H, W, gh, gw)
    inputs = n * (H * W + 4 + d_mi)
    if not backward:
        return 4 * (inputs + weights + biases + n * D), 2 * (crop + mlp_macs)
    saved = n * (G + d1 + d2 + nw + ((G + d_m) if d_mi else 0))
    nbytes = 4 * (inputs + weights + saved + n * D            # in: img, wl, mi, W, saved, g
                  + n * (4 + d_mi) + weights + biases)       # out: dwl, dmi, dW, db
    return nbytes, 2 * (2 * mlp_macs + n * crop_macs(H, W, gh, gw, backward=True))


def glimpse_library_fn(torch, stn, shape):
    """The port's unfused chain for the same function: stn's crop (two
    batched matmuls), the mask and encoder as torch.addmm + activation, and
    the head (a yardstick only: the fused path never calls it)."""
    F = torch.nn.functional
    nw = shape["n_what"]

    def chain(img, wl, mi, mask, enc, head_w, head_b):
        g = stn.extract_glimpse(img, stn.to_coords(wl), shape["glimpse"])
        flat = g.reshape(g.shape[0], -1)
        if mi is not None:
            (wm1, bm1), (wm2, bm2) = mask
            flat = flat * torch.sigmoid(torch.addmm(bm2, F.elu(torch.addmm(bm1, mi, wm1)), wm2))
        (we1, be1), (we2, be2) = enc
        h = F.elu(torch.addmm(be2, F.elu(torch.addmm(be1, flat, we1)), we2))
        hp = torch.addmm(head_b, h, head_w)
        return hp[:, :nw], F.softplus(hp[:, nw:]) + 1e-2
    return chain


def glimpse_library_bwd_fn(torch, stn, shape, args, gen):
    """torch.autograd.grad through the unfused chain's graph (built once) for
    the gradients the backward kernel gives: where, the mask input, every
    weight and bias."""
    img, wl, mi, mask, enc, head_w, head_b = args
    leaves = []

    def leaf(t):
        t = t.detach().clone().requires_grad_()
        leaves.append(t)
        return t

    lib_args = (img.clone(), leaf(wl), None if mi is None else leaf(mi),
                None if mask is None else tuple((leaf(w), leaf(b)) for w, b in mask),
                tuple((leaf(w), leaf(b)) for w, b in enc), leaf(head_w), leaf(head_b))
    loc, scale = glimpse_library_fn(torch, stn, shape)(*lib_args)
    g = [torch.randn(t.shape, generator=gen, device=t.device) for t in (loc, scale)]
    return lambda: torch.autograd.grad((loc, scale), leaves, g, retain_graph=True)


def prop_dims(shape):
    """(S, gh, gw, n_what, U, SP, WB, MH) of a fused propagation shape."""
    return (shape["S"], shape["glimpse"][0], shape["glimpse"][1], shape["n_what"],
            shape["U"], shape["SP"], shape["WB"], shape["MH"])


def prop_inputs(torch, fc, shape, gen, device):
    """Seeded inputs of one fused propagation call: (args, weights) with args
    (img, what_tm1, where_tm1, pres_tm1, ht, h0 [B, U], eps_w, eps_x, u) and
    the 38 weights of ``fc.weights_flat``, lecun-scaled, the mask's output
    bias at 1 and the steps predictor's at 5 (objects mostly live)."""
    S, gh, gw, nw, U, SP, WB, MH = prop_dims(shape)
    n, (H, W), G = shape["n"], shape["img"], gh * gw

    def rnd(*s):
        return torch.randn(s, generator=gen, device=device)

    def weight(a, b):
        return rnd(a, b) / math.sqrt(a)

    def bias(d, loc=0.0):
        return loc + 0.1 * rnd(d)

    d_rnn, d_tin = 3 * nw + 10 + U, U + 4 + 2 * nw
    p = fc.PropParams(
        wb=((weight(U, WB), bias(WB)), (weight(WB, 4), bias(4))),
        mask=((weight(U, MH), bias(MH)), (weight(MH, G), bias(G, 1.0))),
        ge_enc=((weight(G, U), bias(U)), (weight(U, U), bias(U))),
        ge_head=(weight(U, 2 * nw), bias(2 * nw)),
        rnn=(weight(d_rnn, U), weight(U, U), bias(U)),
        stp=((weight(2 * U + 4, U), bias(U)), (weight(U, U), bias(U)), (weight(U, 8), bias(8))),
        stp_offset=torch.tensor(-3.0, device=device),
        tril=torch.tril(0.2 * rnd(4, 4)),
        gru=(weight(d_tin, 2 * U), weight(U, 2 * U), bias(2 * U), weight(d_tin, U),
             weight(U, U), bias(U)),
        td=(weight(U, 2 * nw), bias(2 * nw)), gates=(weight(U, 3 * nw), bias(3 * nw, 1.0)),
        sp=((weight(2 * U + nw, SP), bias(SP)), (weight(SP, 1), bias(1, 5.0))))
    s3w, s3b = p.stp[2]
    fold = torch.cat([torch.zeros(4, device=device), torch.ones(4, device=device)])
    p = p._replace(stp=(p.stp[0], p.stp[1], (s3w, s3b + fold * (p.stp_offset - 1.0))))
    args = (torch.rand((n, H, W), generator=gen, device=device), 0.5 * rnd(S, n, nw),
            0.5 * rnd(S, n, 4), (torch.rand((S, n, 1), generator=gen, device=device) < 0.7).float(),
            0.3 * rnd(S, n, U), 0.1 * rnd(n, U), rnd(S, n, 4), rnd(S, n, nw),
            torch.rand((S, n, 1), generator=gen, device=device))
    return args, tuple(t.contiguous() for t in fc.weights_flat(p))


def prop_work(shape, backward=False):
    """(bytes read once and written once, f32 FLOPs) of one fused propagation
    call.  Forward, per row and slot: the where-bias and mask MLPs, two
    crops (img wx^T, then wy A), two encoders and heads, the transition, the
    estimator, the GRU, the temporal head and gates, the steps predictor;
    it reads the frames, the inputs and the weights and writes the outputs
    and the residual rows.  Backward: twice the dense products (the input's
    and the weight's gradient of each), the two crops' backward
    (``crop_macs``); it reads what the forward read, the saved
    outputs, the residual rows and the output gradients, and writes the
    input and weight gradients."""
    S, gh, gw, nw, U, SP, WB, MH = prop_dims(shape)
    n, (H, W), G = shape["n"], shape["img"], gh * gw
    d_rnn, d_stp, d_tin, d_spf = 3 * nw + 10 + U, 2 * U + 4, U + 4 + 2 * nw, 2 * U + nw
    mats = [(U, WB), (WB, 4), (U, MH), (MH, G), (G, U), (U, U), (U, 2 * nw), (G, U), (U, U),
            (U, 2 * nw), (d_rnn, U), (U, U), (d_stp, U), (U, U), (U, 8), (d_tin, 2 * U),
            (U, 2 * U), (d_tin, U), (U, U), (U, 2 * nw), (U, 3 * nw), (d_spf, SP), (SP, 1)]
    dense = sum(a * b for a, b in mats)  # the encoder's products counted twice, once a glimpse
    crop = crop_macs(H, W, gh, gw)
    weights = (dense - (G * U + U * U + U * 2 * nw)) + 16  # each matrix once, and tril
    biases = WB + 4 + MH + G + U + U + 2 * nw + U + U + U + 8 + 3 * U + 2 * nw + 3 * nw + SP + 1
    rows = S * n
    inputs = n * H * W + rows * (nw + 4 + 1 + U + 4 + nw + 1) + n * U
    outputs = rows * (3 * nw + 3 * 4 + 3 + U)
    from sqair_tpu_torch.ops.fused_cells import residual_layout
    R = residual_layout(prop_dims(shape))[1]
    if not backward:
        return 4 * (inputs + weights + biases + outputs + rows * R), 2 * rows * (dense + 2 * crop)
    crop_bwd = 2 * crop_macs(H, W, gh, gw, backward=True)
    saved = rows * (2 * nw + 2 * 4 + 2 + U)
    nbytes = 4 * (inputs + weights + saved + rows * R + outputs          # in
                  + rows * (nw + 4 + 1 + U) + n * U + weights + biases)  # out
    return nbytes, 2 * rows * (2 * dense + crop_bwd)


def prop_library_fns(torch, propagate, args, gen):
    """The port's unfused propagation of one frame, ``Propagate._ssm``, on the
    same inputs, and torch.autograd.grad through its graph (built once) for
    the inputs' and the propagation core's parameters' gradients: a
    yardstick only (the model's own weights; the plain versions and no
    switch must be active while these run and are built)."""
    from sqair_tpu_torch.ops.noise import ReplayNoise

    img, wt1, wh1, p1, th, _, eps_w, eps_x, u = args
    table = {}
    for kk in range(wt1.shape[0]):
        table.update({(kk, "where"): eps_w[kk], (kk, "what"): eps_x[kk],
                      (kk, "presence"): u[kk]})
    noise = ReplayNoise(table, img.device)

    def inputs(wt1, wh1, p1, th):
        z = tuple(t.transpose(0, 1) for t in (wt1, wh1, p1))
        return z + (torch.zeros_like(z[2]),), (th.transpose(0, 1),)

    def fwd():
        return propagate._ssm(img, *inputs(wt1, wh1, p1, th), noise)

    cell = propagate.ssm_cell
    with torch.inference_mode(False), torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_() for t in (wt1, wh1, p1, th)]
        leaves += [*cell.parameters(), *cell.glimpse_encoder.parameters(),
                   *cell.temporal_cell.parameters()]
        stacked, _, dwhat, dwhere, ts = propagate._ssm(img, *inputs(*leaves[:4]), noise)
        outs = [*stacked.values(), dwhat, dwhere, *ts]
        cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in outs]
    # the temporal cell's h0 takes no part (the temporal state is given)
    return fwd, lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True,
                                            allow_unused=True)


def disc_dims(shape):
    """(S, gh, gw, n_what, U, SP) of a fused discovery shape."""
    return (shape["S"], shape["glimpse"][0], shape["glimpse"][1], shape["n_what"], shape["U"],
            shape["SP"])


def disc_inputs(torch, fc, shape, gen, device, frames):
    """Seeded inputs of one fused discovery call: (args, weights) with args
    (img, img flat, cond, h0 [B, U], eps_w, eps_x, u) and the 23 weights of
    ``fc.disc_weights_flat``, lecun-scaled, the scale offset at the release
    flags' -3 and the steps predictor's output bias at the release flags' 1
    (some objects die).  ``frames`` [n, H, W] are frames of the port's data
    generator, as the main path gives the kernel: over white noise the crop
    turns a rounding difference of where into ~20x that in the glimpse."""
    S, gh, gw, nw, U, SP = disc_dims(shape)
    n, C, G = shape["n"], shape["C"], gh * gw

    def rnd(*s):
        return torch.randn(s, generator=gen, device=device)

    def weight(a, b):
        return rnd(a, b) / math.sqrt(a)

    def bias(d, loc=0.0):
        return loc + 0.1 * rnd(d)

    HW = frames.shape[1] * frames.shape[2]
    p = fc.DiscParams(
        enc_in=((weight(HW, U), bias(U)), (weight(U, U), bias(U))),
        rnn=(weight(U + C + nw + 5, U), weight(U, U), bias(U)),
        stp=((weight(U, U), bias(U)), (weight(U, U), bias(U)), (weight(U, 8), bias(8))),
        stp_offset=torch.tensor(-3.0, device=device),
        ge_enc=((weight(G, U), bias(U)), (weight(U, U), bias(U))),
        ge_head=(weight(U, 2 * nw), bias(2 * nw)),
        sp=((weight(U + nw, SP), bias(SP)), (weight(SP, 1), bias(1, 1.0))))
    s3w, s3b = p.stp[2]
    fold = torch.cat([torch.zeros(4, device=device), torch.ones(4, device=device)])
    p = p._replace(stp=(p.stp[0], p.stp[1], (s3w, s3b + fold * p.stp_offset)))
    img = frames[:n].to(device).contiguous()
    args = (img, img.reshape(n, -1), 0.5 * rnd(n, C), 0.1 * rnd(n, U), rnd(S, n, 4),
            rnd(S, n, nw), torch.rand((S, n, 1), generator=gen, device=device))
    return args, tuple(t.contiguous() for t in fc.disc_weights_flat(p))


def disc_work(shape, backward=False):
    """(bytes read once and written once, f32 FLOPs) of one fused discovery
    call.  Forward: the input encoder per row; per row and slot the
    transition, the estimator, the crop (img wx^T, then wy A), the glimpse
    encoder and head, the steps predictor; it reads the frames, the
    conditioning, h0, the noise and the weights and writes the outputs, the
    residual rows, the glimpses and the input encoder's layers.  Backward:
    twice the dense products less the frames' gradient (none), the crop's
    backward (``crop_macs``); it reads what the forward
    read, the saved outputs, the residuals and the output gradients, and
    writes the conditioning's, h0's and the weights' gradients."""
    S, gh, gw, nw, U, SP = disc_dims(shape)
    n, (H, W), C, G = shape["n"], shape["img"], shape["C"], gh * gw
    HW, d_rnn, d_spf = H * W, U + C + nw + 5, U + nw
    enc = HW * U + U * U
    slot = (d_rnn * U + U * U + U * U + U * U + U * 8 + G * U + U * U + U * 2 * nw
            + d_spf * SP + SP)
    crop = crop_macs(H, W, gh, gw)
    weights = enc + slot
    biases = 5 * U + 8 + 2 * U + 2 * nw + SP + 1
    rows = S * n
    R = 5 * U + SP + 1
    inputs = n * (HW + C + U) + rows * (4 + nw + 1)
    outputs = rows * (3 * nw + 3 * 4 + 3)
    saved = rows * (R + G) + n * 2 * U
    if not backward:
        return (4 * (inputs + weights + biases + outputs + saved),
                2 * (n * enc + rows * (slot + crop)))
    crop_bwd = crop_macs(H, W, gh, gw, backward=True)
    nbytes = 4 * (inputs + weights + rows * (2 * nw + 2 * 4 + 2) + saved + outputs  # in
                  + n * (C + U) + weights + biases)                             # out
    return nbytes, 2 * (2 * (n * enc + rows * slot) - n * HW * U + rows * crop_bwd)


def disc_library_fns(torch, discover, args, gen):
    """The port's unfused discovery of one frame, ``Discover._discover``, on
    the same frames, conditioning and noise, and torch.autograd.grad through
    its graph (built once) for the conditioning's and the discovery core's
    parameters' gradients: a yardstick only (the model's own weights and h0;
    the plain versions and no switch must be active while these run and are
    built)."""
    from sqair_tpu_torch.ops.noise import ReplayNoise

    img, _, cond, _, eps_w, eps_x, u = args
    table = {}
    for kk in range(eps_w.shape[0]):
        table.update({(kk, "where"): eps_w[kk], (kk, "what"): eps_x[kk],
                      (kk, "presence"): u[kk]})
    noise = ReplayNoise(table, img.device)
    cell = discover.cell
    with torch.inference_mode(False), torch.enable_grad():
        leaves = [cond.detach().clone().requires_grad_()]
        leaves += [*cell.parameters(), *cell.input_encoder.parameters(),
                   *cell.glimpse_encoder.parameters()]
        hidden, _ = discover._discover(img, leaves[0], noise)
        outs = [o for o in hidden.values() if o.requires_grad]  # not the presence draws
        cots = [torch.randn(o.shape, generator=gen, device=o.device) for o in outs]
    # the glimpse mask takes no part (discovery's glimpse is unmasked)
    return (lambda: discover._discover(img, cond, noise),
            lambda: torch.autograd.grad(outs, leaves, cots, retain_graph=True,
                                        allow_unused=True))


def near_integer_u(torch, fg, img, wl, dims):
    """How many interpolation coordinates u lie within 1e-5 of an integer
    (where a rounding difference flips a term of the where-gradient)."""
    _, (_, uy, _), (_, ux, _) = fg.coords_and_interp(wl, img.shape[1], img.shape[2], *dims[:2])
    u = torch.cat([uy.flatten(), ux.flatten()])
    return int(torch.sum(torch.abs(u - torch.round(u)) < 1e-5))


def device_ms(torch, fn, calls=50, reps=REPS):
    """Median over ``reps`` of the device time per call of ``fn``, from CUDA
    events around ``calls`` back-to-back calls.  A spin kernel runs first,
    so that the host has queued every call before the device reaches them
    and the events time the device, not the host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def step_ms(torch, fn, reps):
    """Median wall time of ``fn`` (one step) between CUDA events."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_device(torch, fn):
    """Device time of one call of ``fn`` under torch.profiler (ms, summed over
    the device's own activities: kernels, copies, sets), and the eight
    largest of them by name, followed by the kernels of ``REDESIGNED``
    where they are not among them.  Only the device's activities are
    recorded: a CPU op's self device time repeats the kernels it launched,
    and recording the CPU ops of an eager step (~10^4) took ~10x the step."""
    busy, top, _ = profile_groups(torch, fn)
    return busy, top


def profile_groups(torch, fn):
    """``profile_device`` of one call of ``fn``, and its device time summed
    by group: "kernels" (the port's CUDA kernels), "convolutions" (cuDNN's)
    and "other" (PyTorch's elementwise and reduction kernels, copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return None, [], {}
    groups = collections.Counter()
    for key, ms, _ in rows:
        low = key.lower()
        groups["kernels" if "sqair::" in key else
               "convolutions" if any(w in low for w in ("cudnn", "conv", "wgrad", "dgrad",
                                                         "fprop", "xmma", "implicit_gemm"))
               else "other"] += ms
    rows.sort(key=lambda r: -r[1])
    top = [dict(name=k[:60], ms=round(ms, 3), count=c) for i, (k, ms, c) in enumerate(rows)
           if i < 8 or any(name in k for name in REDESIGNED)]
    return sum(ms for _, ms, _ in rows), top, dict(groups)


def metric_distance(torch, got, want, what="metrics"):
    """The largest |a - b| / (|b| + 1) over the metrics, and its metric."""
    worst, worst_key = 0.0, None
    for key, ref in want.items():
        a = got[key].detach().double().cpu()
        b = ref.detach().double().cpu()
        if not torch.isfinite(a).all():
            raise Failure(f"{what}: metric {key} is not finite: {a}")
        err = float(torch.max(torch.abs(a - b) / (torch.abs(b) + 1.0)))
        if err > worst:
            worst, worst_key = err, key
    return worst, worst_key


def compare_metrics(torch, got, want, what):
    """``metric_distance``, which must be at most METRIC_TOL."""
    worst, worst_key = metric_distance(torch, got, want, what)
    if worst > METRIC_TOL:
        raise Failure(f"{what}: metric {worst_key} differs by {worst:.3g} > {METRIC_TOL}: "
                      f"{got[worst_key]} vs {want[worst_key]}")
    return worst, worst_key


def scaled_err(torch, got, want):
    """(max |got - want|, max |want|) of two tensors."""
    a, b = got.detach().double().cpu(), want.detach().double().cpu()
    return float(torch.max(torch.abs(a - b))), float(torch.max(torch.abs(b)))


def grad_errors(torch, got, want, what):
    """Per parameter (share, name, err, largest): err = max |got - want|,
    largest = max |want|, share = err / largest; sorted, worst last."""
    out = []
    for name in want:
        a, b = got[name], want[name]
        if (a is None) != (b is None):
            raise Failure(f"{what}: {name} has a gradient on one side only")
        if b is None:
            continue
        if not torch.isfinite(a).all():
            raise Failure(f"{what}: {name} gradient is not finite")
        err, size = scaled_err(torch, a, b)
        out.append((err / (size + 1e-30), name, err, size))
    return sorted(out)


def plain_glimpse(fg):
    """The fused glimpse encoder's kernels replaced by its plain versions
    inside its autograd Function (whose backward is the hand-written one, as
    the kernel's: autograd of the plain forward would take other
    subgradients at exact zeros, e.g. 1 for softplus'(0)), as a context
    manager."""
    def fwd(*args, save):
        out = fg.glimpse_plain_fwd(*args)
        return out if save else out[:2]

    return mock.patch.multiple(fg, _fwd_cuda=fwd, _bwd_cuda=fg.glimpse_plain_bwd)


def plain_cells(fc):
    """The fused propagation's and discovery's kernels replaced by their
    plain versions inside their autograd Functions (with the hand-written
    backwards, as ``plain_glimpse``), as a context manager."""
    return mock.patch.multiple(fc, _fwd_cuda=fc.prop_plain_fwd, _bwd_cuda=fc.prop_plain_bwd,
                               _disc_fwd_cuda=fc.disc_plain_fwd,
                               _disc_bwd_cuda=fc.disc_plain_bwd)


@contextlib.contextmanager
def plain_versions(fused, fg, fc):
    """Every kernel wrapper replaced by its plain version (autograd of plain
    tensor ops for a gradient; the glimpse encoder's and the propagation
    and discovery unrolls' hand-written backwards)."""
    with mock.patch.multiple(fused, fused_mlp=fused.mlp_plain,
                             fused_vanilla_rnn=fused.vanilla_rnn_plain,
                             fused_gru=fused.gru_plain), plain_glimpse(fg), plain_cells(fc):
        yield


@contextlib.contextmanager
def switched(switches):
    """The environment with exactly ``switches`` of SQAIR_FUSE_GLIMPSE and
    SQAIR_FUSE_CELLS set."""
    with mock.patch.dict(os.environ, switches):
        for name in CELLS_SWITCH:
            if name not in switches:
                os.environ.pop(name, None)
        yield


@contextlib.contextmanager
def presence_sites(torch, model):
    """Records the probability of every presence draw of each frame the
    model's timestep runs, as float64 numpy [B, S] on the CPU:
    {t: {"prop": propagation's posterior, "prop_prior": its prior (drawn
    under sample_from_prior), "disc": discovery's posterior}}."""
    sites = {}

    def hook(module, args, out):
        prop, disc = out["prop"], out["disc"]
        probs = dict(prop=prop["presence_prob"][..., 0], disc=disc["presence_prob"][..., 0],
                     prop_prior=torch.sigmoid(prop["prior_stats"][-1][..., 0]))
        sites[args[6]] = {key: v.detach().double().cpu().numpy() for key, v in probs.items()}

    handle = model.sequence.timestep.register_forward_hook(hook)
    try:
        yield sites
    finally:
        handle.remove()


def site_uniforms(table, t, n_slots):
    """The uniforms [B, S] of frame t's presence draws, keyed as
    ``presence_sites`` keys their probabilities (the prior's where the
    noise table has it)."""
    def arr(v):
        return v.double().cpu().numpy() if hasattr(v, "cpu") else np.asarray(v, np.float64)

    out = {kind: np.concatenate([arr(table[(t, kind, k, "presence")]) for k in range(n_slots)],
                                -1) for kind in ("prop", "disc")}
    if (t, "prop", "prior", "presence") in table:
        out["prop_prior"] = arr(table[(t, "prop", "prior", "presence")])
    return out


def first_flip(sites_a, sites_b, table, margin=None):
    """(frame of the first presence draw that two runs under the same noise
    sample differently, or None; whether each such draw of that frame is
    crossed, its uniform within ``margin`` of both runs' probabilities)."""
    margin = FLIP_MARGIN if margin is None else margin
    for t in sorted(sites_a):
        flips, crossed = 0, True
        for key, u in site_uniforms(table, t, sites_a[t]["prop"].shape[-1]).items():
            pa, pb = sites_a[t][key], sites_b[t][key]
            differ = (u < pa) != (u < pb)
            flips += int(differ.sum())
            near = (np.abs(u - pa) < margin) & (np.abs(u - pb) < margin)
            crossed = crossed and bool(np.all(near[differ]))
        if flips:
            return t, crossed
    return None, True


def frame_errors(torch, got, ref):
    """{field: [T] largest |a - b| / (|b| + 1) of each frame} of two records
    (float64, on the referee's device; numpy on the CPU)."""
    out = {}
    for key, b in ref.items():
        a, b = got[key].to(b.device).double(), b.double()
        err = torch.abs(a - b) / (torch.abs(b) + 1.0)
        out[key] = err.reshape(err.shape[0], -1).max(-1).values.cpu().numpy()
    return out


@contextlib.contextmanager
def kinks(torch, AIREncoder, AIRDecoder, D, keep=None, fc=None):
    """Records where one train step meets the kinks of its gradient: the
    where of every glimpse crop and paste (their interpolation weights
    relu(1 - |u - p|) turn the where-gradient around where a coordinate u
    crosses an integer), the input of every relu (the transient penalty)
    and the presence draws; with ``fc`` (ops/fused_cells), the where of
    both crops of every fused propagation call, [S, B, 8] (the where-bias
    location from the residual rows, then the sampled where), and of the
    crop of every fused discovery call, [S, B, 4].  With ``keep``, the
    gradient through the kinks that ``keep[kind][call]`` (1 or 0 per row of
    a where, per row-slot of a fused call, per entry of a relu's input) does
    not keep is zeroed: see ``kinks_crossed``."""
    rec = dict(glimpse=[], paste=[], relu=[], presence=[], prop=[], disc=[])
    real_enc, real_dec = AIREncoder.forward, AIRDecoder.forward
    real_relu, real_sample = torch.nn.functional.relu, D.Bernoulli.sample

    class Keep(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(k)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * ctx.saved_tensors[0], None

    def kept(kind, x, rows):
        if keep is not None and x.requires_grad:
            k = keep[kind][len(rec[kind])].to(x.device, x.dtype)
            x = Keep.apply(x, k[..., None] if rows else k)
        rec[kind].append(x.detach().clone())
        return x

    def enc(self, img, where=None, mask_inpt=None):
        where = None if where is None else kept("glimpse", where, True)
        return real_enc(self, img, where, mask_inpt)

    def dec(self, what, where, presence=None):
        return real_dec(self, what, kept("paste", where, True), presence)

    def relu(x, *args, **kw):
        return real_relu(kept("relu", x, False), *args, **kw)

    def sample(self, u):
        out = real_sample(self, u)
        rec["presence"].append(out.detach().clone())
        return out

    calls = dict(prop={}, disc={})  # a fused call's residual blob address -> its index

    def prop_fwd(*args):
        out = real_prop(*args)
        lo, hi = fc.residual_layout(args[-1])[0]["gwl"]
        calls["prop"][out[10].data_ptr()] = len(rec["prop"])
        rec["prop"].append(torch.cat([out[10][..., lo:hi], out[3]], -1).detach().clone())
        return out

    def disc_fwd(*args):
        out = real_disc(*args)
        calls["disc"][out[9].data_ptr()] = len(rec["disc"])
        rec["disc"].append(out[3].detach().clone())
        return out

    def cells_bwd(kind, real, i_res):
        """A fused backward that zeroes the crop gradient of the row-slots
        whose kinks ``keep[kind]`` does not keep (its residual blob, args[i_res],
        names the forward call)."""
        def bwd(*args):
            res = args[i_res]
            k = keep[kind][calls[kind][res.data_ptr()]].reshape(res.shape[:2])
            return real(*args, crop_keep=k.to(res.device, res.dtype).contiguous())
        return bwd

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(AIREncoder, "forward", enc))
        stack.enter_context(mock.patch.object(AIRDecoder, "forward", dec))
        stack.enter_context(mock.patch.object(torch.nn.functional, "relu", relu))
        stack.enter_context(mock.patch.object(D.Bernoulli, "sample", sample))
        if fc is not None:
            real_prop, real_disc = fc.prop_fwd, fc.disc_fwd
            stack.enter_context(mock.patch.object(fc, "prop_fwd", prop_fwd))
            stack.enter_context(mock.patch.object(fc, "disc_fwd", disc_fwd))
            for kind, name, i_res in (("prop", "prop_bwd", 11), ("disc", "disc_bwd", 9)):
                if keep is not None and keep.get(kind):
                    stack.enter_context(mock.patch.object(
                        fc, name, cells_bwd(kind, getattr(fc, name), i_res)))
        yield rec


def kinks_crossed(torch, fg, stn, a, b, fused, img, glimpse):
    """Per kind, per call of two runs' ``kinks`` records: the rows of a
    where whose crop or paste coordinates lie on another side of an integer
    in run a than in run b, and the relu entries of another sign; with the
    number of presence draws that differ; and the row-slots of each fused
    propagation call whose two crops' coordinates differ in side ("prop"),
    and of each fused discovery call whose crop's do ("disc").
    The crop coordinates are computed as the run computed them: the glimpse
    kernel's order for a [B, 4] where when ``fused`` (SQAIR_FUSE_GLIMPSE on)
    and in the propagation kernel, else stn's."""
    (H, W), (gh, gw) = img, glimpse

    def crop_u(w):
        if fused and w.ndim == 2:
            _, (_, uy, _), (_, ux, _) = fg.coords_and_interp(w, H, W, gh, gw)
        else:
            uy, ux = stn.crop_coords(stn.to_coords(w), glimpse, img)
        return torch.cat([uy, ux], -1)

    def paste_u(w):
        return torch.cat(stn.paste_coords(stn.to_coords(w), glimpse, img), -1)

    def sides(ua, ub):
        ua, ub = ua.to(ub.device, torch.float64), ub.double()
        p = torch.round(ub)
        return torch.any(torch.sign(ua - p) != torch.sign(ub - p), -1)

    def cells_u(w):  # every crop of each row-slot, in the kernel's order
        flat, us = w.reshape(-1, w.shape[-1]), []
        for i in range(0, flat.shape[1], 4):
            _, (_, uy, _), (_, ux, _) = fg.coords_and_interp(flat[:, i:i + 4], H, W, gh, gw)
            us += [uy, ux]
        return torch.cat(us, -1)

    out = dict(glimpse=[sides(crop_u(x), crop_u(y)) for x, y in zip(a["glimpse"], b["glimpse"])],
               paste=[sides(paste_u(x), paste_u(y)) for x, y in zip(a["paste"], b["paste"])],
               relu=[(x.to(y.device) > 0) != (y > 0) for x, y in zip(a["relu"], b["relu"])],
               prop=[sides(cells_u(x), cells_u(y)) for x, y in zip(a["prop"], b["prop"])],
               disc=[sides(cells_u(x), cells_u(y)) for x, y in zip(a["disc"], b["disc"])])
    flips = sum(int(torch.sum(x.to(y.device, torch.float64) != y.double()))
                for x, y in zip(a["presence"], b["presence"]))
    return out, flips


def step_gradients(torch, model, obs, nums, noise, l2):
    """The parameter gradients of one train-record loss (no update)."""
    params = dict(model.sequence.named_parameters())
    model.sequence.zero_grad(set_to_none=True)
    target, aux = model.loss_and_metrics(obs, noise, nums, l2_weight=l2, record_mode="train")
    target.backward()
    grads = {n: (None if p.grad is None else p.grad.detach().clone()) for n, p in params.items()}
    model.sequence.zero_grad(set_to_none=True)
    return grads, float(target.detach())


def train_check(torch, model, disc_model, batch, flags, disc_flags, l2, device, img=IMG,
                runs=TRAIN_RUNS, referees=REFEREES, gates=REFEREE_GATE, pairs=GRADIENT_PAIRS):
    """One train step's parameter gradients, run by run (``runs``; by
    default every kernel with no switch, the glimpse switch and both
    switches, and with both switches on ``disc_model`` (DISC_FLAGS, where
    discovery runs fused too); the plain versions on the card with each and
    on the CPU; and a float64 referee for each switch setting (the plain
    versions on the card)), with the same noise, on frames of ``img``.  f32 rounding moves a run across a kink of the
    step's gradient now and then, and one crossing can move a parameter's
    gradient by 10% (PERF.md); so every run goes twice, the second time
    with the gradient through the kinks at which some run lies on another
    side than its referee zeroed, in every run whose calls line up with it
    (``KINK_GROUPS``: the cells and disc switches make other calls).  The gate and
    the printed ``pairs`` are those of the second pass: each gated run
    (``gates``) lies, on every parameter, at most
    max(GRAD_TOL, 2 x its plain run's distance) of that parameter's largest
    referee gradient from its referee."""
    from sqair_tpu_torch.models.air import AIRDecoder, AIREncoder
    from sqair_tpu_torch.ops import distributions as D
    from sqair_tpu_torch.ops import fused, stn
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise

    def copied(m, to):
        out = copy.copy(m)
        out.sequence = to(copy.deepcopy(m.sequence))
        return out

    wheres = {where for where, _, _ in runs.values()}
    models = {"card": model, "disc_card": disc_model}
    for where, base, to in (("cpu", model, lambda s: s.cpu()), ("f64", model, lambda s: s.double()),
                            ("disc_f64", disc_model, lambda s: s.double())):
        if where in wheres:
            models[where] = copied(base, to)
    B, k = int(flags["batch_size"]), int(flags["k_particles"])
    T = int(batch["imgs"].shape[0])
    referee = {name: referees[sw] for name, (_, sw, _) in runs.items()}
    run_flags = {where: disc_flags if where.startswith("disc") else flags for where in models}
    noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 6), device,
                           record=True)

    def gradients(name, keep=None):
        where, sw, plain = runs[name]
        m, switches = models[where], SWITCHES[sw]
        with contextlib.ExitStack() as stack:
            stack.enter_context(switched(switches))
            if plain:
                stack.enter_context(plain_versions(fused, fg, fc))
            rec = stack.enter_context(kinks(torch, AIREncoder, AIRDecoder, D, keep, fc))
            fused.reset_launches()
            src = noise if noise.table == {} else ReplayNoise(
                {key: v.to(m.device) for key, v in noise.table.items()}, m.device, m.dtype)
            grads, target = step_gradients(torch, m, batch["imgs"].to(m.device, m.dtype),
                                           batch["nums"].to(m.device, m.dtype), src, l2)
        launched = dict(fused.launches)
        if plain and sum(launched.values()):
            raise Failure(f"the plain train re-run {name} launched a kernel: {launched}")
        if not plain and device.type == "cuda":
            want = expected_launches(main_path_shapes(
                run_flags[where], B, k, T, train=True, img=img,
                fuse_glimpse="SQAIR_FUSE_GLIMPSE" in switches,
                fuse_cells="SQAIR_FUSE_CELLS" in switches), 1, backward=True)
            if launched != want:
                raise Failure(f"train-check run {name} launched {launched}, not {want}")
        return grads, target, rec

    def masks(records):
        """Per group of runs whose calls line up (``KINK_GROUPS``): the union
        of the kinks that any of its runs crossed against its referee."""
        out, crossed, flips = {}, {}, {}
        for name, (_, sw, _) in runs.items():
            if name in referees.values():
                continue
            c, flips[name] = kinks_crossed(torch, fg, stn, records[name], records[referee[name]],
                                           sw != "off", img, glimpse_hw(flags))
            crossed[name] = {kind: int(sum(int(x.sum()) for x in v)) for kind, v in c.items()}
            group = KINK_GROUPS[sw]
            u = out.get(group)
            out[group] = c if u is None else {kd: [m | x for m, x in zip(u[kd], c[kd])]
                                              for kd in c}
        return out, crossed, flips

    first = {name: gradients(name) for name in runs}
    union, crossed, flips = masks({n: r[2] for n, r in first.items()})
    keep = {group: {kind: [~m for m in v] for kind, v in u.items()}
            for group, u in union.items()}
    second = {name: gradients(name, keep[KINK_GROUPS[sw]])[0]
              for name, (_, sw, _) in runs.items()}

    def pairs_of(g):
        return {pair: grad_errors(torch, g[a], g[b], pair) for pair, (a, b) in pairs.items()}

    def distances(g):
        return {name: grad_errors(torch, g[name], g[referee[name]], name)
                for name in runs if name not in referees.values()}

    dist = distances(second)
    # the gate: per parameter, err <= max(GRAD_TOL largest, 2 err of the plain run) + 1e-6
    gate = {}
    for run, plains in gates.items():
        plain_err = {n: max(e for p in plains for _, m, e, _ in dist[p] if m == n)
                     for _, n, _, _ in dist[run]}
        rows = []
        for _, n, e, size in dist[run]:
            bound = max(GRAD_TOL * size, 2.0 * plain_err[n]) + 1e-6
            rows.append((e / bound, n, e, bound))
        gate[run] = sorted(rows)
    return dict(
        targets={name: r[1] for name, r in first.items()}, crossed=crossed, flips=flips,
        masked={f"{g}.{kind}": int(sum(int(m.sum()) for m in v))
                for g, u in union.items() for kind, v in u.items()},
        errors=pairs_of(second), unmasked=pairs_of({n: r[0] for n, r in first.items()}),
        distance=dist, unmasked_distance=distances({n: r[0] for n, r in first.items()}),
        gate=gate,
        ratio={run: dist[run][-1][0] / (max(dist[p][-1][0] for p in plains) + 1e-30)
               for run, plains in gates.items()})


def report_train_check(tc, phase, t0, gates=REFEREE_GATE):
    """Prints ``train_check``'s result ``tc`` as three ``phase`` lines and
    fails where a gated run lies over its bound."""
    errors, dist = tc["errors"], tc["distance"]
    gmax = max(size for _, _, _, size in errors[next(iter(errors))])

    def worst(errs):
        return [dict(name=n, share=f"{sh:.2e}", err=f"{e:.2e}", largest=f"{sz:.2e}")
                for sh, n, e, sz in errs[-3:]]

    log(phase, t0, params=len(errors[next(iter(errors))]),
        largest_grad=f"{gmax:.3e}", targets=jdump({n: f"{v:.5f}" for n, v in tc["targets"].items()}),
        kinks_crossed=jdump(tc["crossed"]), kinks_masked=jdump(tc["masked"]),
        presence_flips=jdump(tc["flips"]),
        pairs_unmasked=jdump({pair: f"{errs[-1][0]:.3e}" for pair, errs in tc["unmasked"].items()}),
        pairs=jdump({pair: worst(errs) for pair, errs in errors.items()}))
    log(phase, t0, referee="float64 plain versions on the card, per switch setting",
        distance=jdump({run: f"{errs[-1][0]:.3e}" for run, errs in dist.items()}),
        unmasked=jdump({run: f"{errs[-1][0]:.3e}" for run, errs in tc["unmasked_distance"].items()}),
        worst=jdump({run: worst(errs) for run, errs in dist.items()}),
        where_bias_mlp=jdump({run: f"{max(sh for sh, n, _, _ in errs if '_where_bias_mlp' in n):.3e}"
                              for run, errs in dist.items()}),
        kernels_over_plain=jdump({run: f"{v:.3f}" for run, v in tc["ratio"].items()}))
    log(phase, t0, gate=jdump({run: [dict(name=n, of_bound=f"{r:.3f}", err=f"{e:.2e}",
                                                  bound=f"{b:.2e}") for r, n, e, b in gated[-2:]]
                                       for run, gated in tc["gate"].items()}),
        tol=f"|g-g64|<=max({GRAD_TOL:g}max|g64|,2|g_plain-g64|)+1e-6 per parameter")
    for run, gated in tc["gate"].items():
        for of_bound, name, err, bound in gated:
            if of_bound > 1.0:
                raise Failure(f"{phase}: train gradients, {run}: {name} lies {err:.3g} from its float64 "
                              f"referee, over the bound {bound:.3g} (tol {GRAD_TOL:g} of its "
                              f"largest gradient, or twice the distance of "
                              f"{' / '.join(gates[run])})")



def cli_argv(release, root, run_name, steps_per_call):
    """The training CLI's arguments: the release flags (its font data
    switched to the synthetic config, whose 2048 sequences are bench.py's),
    T = 10 with no curriculum, the device-resident sampler, 20 steps with a
    heartbeat and a save every 10 and an eval at 0 and 20."""
    argv = [f"--{k}={v}" for k, v in release.items()
            if k not in CLI_SET and not k.startswith("font_") and k != "synth_valid_samples"]
    return argv + ["--data_config=sqair_tpu/configs/synth_seq_mnist_data.py", "--seq_len=10",
                   f"--synth_valid_samples={CLI_VALID}",
                   "--stage_itr=0", "--on_device_data", f"--train_itr={CLI_STEPS}",
                   "--save_itr=10", "--report_loss_every=10", f"--log_itr={CLI_STEPS}",
                   f"--fig_itr={CLI_STEPS}", f"--steps_per_call={steps_per_call}",
                   f"--results_dir={root}", f"--run_name={run_name}", "--device=cuda"]


def run_cli(pexp, pflags, argv):
    """The CLI's main() from a clean flag registry, its output kept aside:
    (run dir, model, train state, output)."""
    import io

    saved = sys.argv
    pflags.reset()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            logdir, model, state = pexp.main(argv)
    finally:
        sys.argv = saved
        pflags.reset()
    return logdir, model, state, out.getvalue()


def cli_records(logdir):
    """metrics.jsonl without the host's frames_per_sec."""
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "frames_per_sec"}
                for line in f]


def params_distance(torch, a, b):
    """The largest |a - b| over two modules' parameters (and mean_img)."""
    sa, sb = a.state_dict(), b.state_dict()
    return max(float(torch.max(torch.abs(sa[n] - sb[n]))) for n in sa)


def records_distance(got, want):
    """The largest |a - b| / (|b| + 1) over two runs' metrics.jsonl records."""
    if [sorted(r) for r in got] != [sorted(r) for r in want]:
        raise Failure(f"the runs' records differ in steps or keys: {len(got)} vs {len(want)}")
    return max((abs(g[k] - w[k]) / (abs(w[k]) + 1.0) for g, w in zip(got, want) for k in w),
               default=0.0)


def walls_ms(torch, fn, repeats, steps=1):
    """Wall ms a train step of ``fn`` (``steps`` steps a call), host clock
    around each call and a synchronize: each repeat's, sorted."""
    out = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t) / steps)
    return sorted(out)


def kernel_tables(fused):
    """(forward wrappers, plain forwards, backward wrappers, plain backwards)
    of the MLP and cell kernels, by kernel name."""
    names = ("fused_mlp", "fused_vanilla_rnn", "fused_gru")
    plain = ("mlp", "vanilla_rnn", "gru")
    return ({n: getattr(fused, n) for n in names},
            {n: getattr(fused, p + "_plain") for n, p in zip(names, plain)},
            {n: getattr(fused, n + "_bwd") for n in names},
            {n: getattr(fused, p + "_bwd_plain") for n, p in zip(names, plain)})


def frame_fields_check(torch, what, fields, referee_fields, referee=False, stats=None):
    """(largest |kernel - plain|, refereed) over the (name, kernel, plain)
    ``fields`` of a kernel's forward, each of which must lie within
    |d| <= KERNEL_ATOL + KERNEL_RTOL |plain|.  With ``referee``, a field
    over that bound is held instead to the plain version's float64 value
    (``referee_fields()``, in the order of ``fields``): max |kernel - f64|
    <= max(KERNEL_ATOL, 2 max |plain - f64|), the rule of train-check.  The frame kernels crop the frame at a where that
    they compute themselves, so a rounding difference of the where moves
    the glimpse by the frame's contrast between neighbouring pixels: on the
    pedestrian frames (textured silhouettes) the float32 plain version
    itself lies over the fixed bound from float64.  ``refereed`` holds each
    refereed field's distances; ``stats``, where given, keeps the largest
    |d| over its fixed bound ("of_tol") and distance to float64 over its
    bound ("of_referee")."""
    worst, refereed, ref = 0.0, {}, None
    stats = {} if stats is None else stats
    for i, (name, a, b) in enumerate(fields):
        diff = torch.abs(a - b)
        if a.shape == b.shape:
            worst = max(worst, float(diff.max()))
            of_tol = float(torch.max(diff / (KERNEL_ATOL + KERNEL_RTOL * torch.abs(b))))
            stats["of_tol"] = max(stats.get("of_tol", 0.0), of_tol)
            if of_tol <= 1.0:
                continue
        if a.shape != b.shape or not referee:
            raise Failure(f"{what}: {name} disagrees with the plain version "
                          f"(max |d| {float(diff.max()):.3g})")
        ref = referee_fields() if ref is None else ref
        r = ref[i]
        err_k = float(torch.max(torch.abs(a.double() - r)))
        err_p = float(torch.max(torch.abs(b.double() - r)))
        bound = max(KERNEL_ATOL, 2.0 * err_p)
        stats["of_referee"] = max(stats.get("of_referee", 0.0), err_k / bound)
        refereed[name] = dict(vs_plain=f"{float(diff.max()):.3e}", kernel_vs_f64=f"{err_k:.3e}",
                              plain_vs_f64=f"{err_p:.3e}", bound=f"{bound:.3e}")
        if not err_k <= bound:
            raise Failure(f"{what}: {name} lies {err_k:.3g} from its float64 value, over the "
                          f"bound {bound:.3g} (twice the plain version's {err_p:.3g})")
    return worst, refereed


def check_kernels(torch, flags, disc_flags, B, k, T, img, frames, gen, device,
                  phase="kernels", modes=("eval", "train"), referee=False):
    """Every kernel against its plain version on the card, with seeded
    inputs from ``gen``, at the shapes of ``modes`` steps at ``flags`` on
    frames of ``img`` (see the module's docstring: the phases ``phase`` and
    ``phase``-bwd): the MLP and cell forwards, and their backwards at the
    train step's shapes; the fused glimpse encoder masked and unmasked; the
    fused propagation unroll at ``flags`` and the fused discovery unroll at
    ``disc_flags`` on ``frames`` [n, H, W] of a data generator (with
    ``referee``, their forwards' fields as ``frame_fields_check`` says).
    Returns the entries, with their inputs and errors, for the timing."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    # every distinct forward shape, with its calls per step of each mode
    shapes = {}
    for mode in modes:
        for kernel, shape, calls in main_path_shapes(flags, B, k, T, train=mode == "train",
                                                     img=img):
            key = (kernel, jdump(shape))
            entry = shapes.setdefault(key, dict(kernel=kernel, shape=shape, eval=0, train=0))
            entry[mode] += calls
    wrappers, plains, bwd_wrappers, bwd_plains = kernel_tables(fused)
    with torch.inference_mode():
        for entry in shapes.values():
            t0 = time.perf_counter()
            kernel, shape = entry["kernel"], entry["shape"]
            args = make_inputs(torch, kernel, shape, gen, device)
            got = wrappers[kernel](*args)
            want = plains[kernel](*args)
            pairs = [(got, want)]
            if kernel == "fused_gru":  # and as the train step calls it, saving zr and c
                saved = fused._gru_fwd_cuda(*args, save=True)
                pairs += list(zip(saved, fused.gru_plain_saving(*args)))
            torch.cuda.synchronize()
            abs_err, rel_err, ok = 0.0, 0.0, True
            for a, b in pairs:
                diff = torch.abs(a - b)
                abs_err = max(abs_err, float(torch.max(diff)))
                # relative error where the value is not near 0 (|value| >= 1e-2)
                big = torch.abs(b) >= 1e-2
                if big.any():
                    rel_err = max(rel_err, float(torch.max(diff[big] / torch.abs(b[big]))))
                ok = ok and a.shape == b.shape and bool(
                    torch.all(diff <= KERNEL_ATOL + KERNEL_RTOL * torch.abs(b)))
            extra = {}
            if kernel in SAME_BITS:
                same = torch.equal(got, wrappers[kernel](*args))
                if kernel == "fused_gru":
                    same = same and torch.equal(saved[0], got) and all(
                        torch.equal(a, b) for a, b in zip(saved, fused._gru_fwd_cuda(*args,
                                                                                     save=True)))
                extra = dict(same_bits=bool(same),
                             geometry=jdump(fwd_geometry(fused, kernel, shape)))
            log(phase, t0, kernel=kernel, shape=jdump(shape),
                max_abs_err=f"{abs_err:.3e}", max_rel_err=f"{rel_err:.3e}",
                tol=f"|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|value|", ok=ok, **extra)
            if not ok:
                raise Failure(f"{kernel} {shape}: kernel disagrees with its plain version")
            if not extra.get("same_bits", True):
                raise Failure(f"{kernel} {shape}: two runs of the kernel differ")
            entry.update(args=args, abs_err=abs_err)

    # ------------------------------------------------------- kernels-bwd
    bwd_entries = [e for e in shapes.values() if e["train"]]
    with torch.inference_mode():
        for entry in bwd_entries:
            t0 = time.perf_counter()
            kernel, shape = entry["kernel"], entry["shape"]
            need_dx = needs_dx(kernel, shape, img)
            bargs = make_bwd_inputs(torch, fused, kernel, entry["args"], gen)
            got = flat_grads(kernel, bwd_wrappers[kernel](*bargs, need_dx=need_dx))
            want = flat_grads(kernel, bwd_plains[kernel](*bargs))
            if not need_dx:
                want[0] = None
            torch.cuda.synchronize()
            worst_abs, worst_share = 0.0, 0.0
            for i, (a, b) in enumerate(zip(got, want)):
                if b is None:
                    if a is not None:
                        raise Failure(f"{kernel}_bwd {shape}: gradient {i} was not skipped")
                    continue
                if a.shape != b.shape:
                    raise Failure(f"{kernel}_bwd {shape}: gradient {i} has shape "
                                  f"{tuple(a.shape)}, expected {tuple(b.shape)}")
                err, size = scaled_err(torch, a, b)
                if not err <= BWD_TOL * size + 1e-6:
                    raise Failure(f"{kernel}_bwd {shape}: gradient {i} differs by {err:.3g} "
                                  f"(largest {size:.3g})")
                worst_abs = max(worst_abs, err)
                worst_share = max(worst_share, err / (size + 1e-30))
            extra = {}
            if kernel + "_bwd" in SAME_BITS:
                again = flat_grads(kernel, bwd_wrappers[kernel](*bargs, need_dx=need_dx))
                if kernel == "fused_mlp":
                    geometry = fused.mlp_bwd_geometry(shape["n"],
                                                      [shape["d_in"]] + shape["widths"])
                elif kernel == "fused_gru":
                    geometry = fused.gru_bwd_geometry(shape["n"], shape["dx"], shape["units"])
                else:
                    geometry = fused.vrnn_bwd_geometry(shape["n"], shape["dx"], shape["units"],
                                                       need_dx)
                extra = dict(same_bits=all((a is None and b is None) or torch.equal(a, b)
                                           for a, b in zip(got, again)),
                             geometry=jdump(geometry))
            log(phase + "-bwd", t0, kernel=kernel + "_bwd", shape=jdump(shape),
                need_dx=need_dx, max_abs_err=f"{worst_abs:.3e}",
                max_err_share=f"{worst_share:.3e}",
                tol=f"|d|<={BWD_TOL:g}max|value|+1e-6", ok=True, **extra)
            if not extra.get("same_bits", True):
                raise Failure(f"{kernel}_bwd {shape}: two runs of the kernel differ")
            entry.update(bwd_args=bargs, bwd_abs_err=worst_abs, need_dx=need_dx)

    # the fused glimpse encoder, masked (propagation) and unmasked (discovery)
    glimpse_entries = []
    with torch.inference_mode():
        for shape, calls in glimpse_shapes(flags, B * k, T, img):
            t0 = time.perf_counter()
            dims, masked = glimpse_dims(shape), bool(shape["d_mi"])
            args = glimpse_inputs(torch, shape, gen, device)
            got = fg._fwd_cuda(*args, dims, save=True)
            same_g = all(torch.equal(a, b)
                         for a, b in zip(got, fg._fwd_cuda(*args, dims, save=True)))
            want = fg.glimpse_plain_fwd(*args, dims)
            torch.cuda.synchronize()
            names = ["loc", "scale", "g0", "h1", "h2"] + (["mask", "mhid"] if masked else [])
            worst = 0.0
            for name, a, b in zip(names, got, want, strict=True):
                diff = torch.abs(a - b)
                if a.shape != b.shape or not torch.all(
                        diff <= KERNEL_ATOL + KERNEL_RTOL * torch.abs(b)):
                    raise Failure(f"fused_glimpse {shape}: output {name} disagrees with the "
                                  f"plain version (max |d| {float(diff.max()):.3g})")
                worst = max(worst, float(diff.max()))
            log(phase, t0, kernel="fused_glimpse", shape=jdump(shape), outputs=len(names),
                max_abs_err=f"{worst:.3e}", tol=f"|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|value|",
                ok=True, same_bits=same_g,
                geometry=jdump(fg.glimpse_fwd_geometry([shape["n"]])))
            if "fused_glimpse" in SAME_BITS and not same_g:
                raise Failure(f"fused_glimpse {shape}: two runs of the kernel differ")

            t0 = time.perf_counter()
            saved = tuple(want[2:5]) + (want[1],) + tuple(want[5:])
            n, nw = shape["n"], shape["n_what"]
            dloc = torch.randn((n, nw), generator=gen, device=device)
            dscale = torch.randn((n, nw), generator=gen, device=device)
            bargs = args[:6] + (saved, dloc, dscale, dims)
            got_b = fg.fused_glimpse_bwd(*bargs)
            same_gb = all(torch.equal(a, b) for a, b in zip(got_b, fg.fused_glimpse_bwd(*bargs)))
            want_b = fg.glimpse_plain_bwd(*bargs)
            torch.cuda.synchronize()
            bnames = ["dwl"] + (["dmi", "dWm1", "dbm1", "dWm2", "dbm2"] if masked else []) + [
                "dWe1", "dbe1", "dWe2", "dbe2", "dWh", "dbh"]
            worst_b, share_b = 0.0, 0.0
            for name, a, b in zip(bnames, got_b, want_b, strict=True):
                err, size = scaled_err(torch, a, b)
                if a.shape != b.shape or not err <= BWD_TOL * size + 1e-6:
                    if name == "dwl":
                        print(f"[{phase}-bwd] u within 1e-5 of an integer: "
                              f"{near_integer_u(torch, fg, args[0], args[1], dims)}", flush=True)
                    raise Failure(f"fused_glimpse_bwd {shape}: {name} differs by {err:.3g} "
                                  f"(largest {size:.3g})")
                worst_b, share_b = max(worst_b, err), max(share_b, err / (size + 1e-30))
            log(phase + "-bwd", t0, kernel="fused_glimpse_bwd", shape=jdump(shape),
                gradients=len(bnames), max_abs_err=f"{worst_b:.3e}",
                max_err_share=f"{share_b:.3e}",
                u_near_integer=near_integer_u(torch, fg, args[0], args[1], dims),
                tol=f"|d|<={BWD_TOL:g}max|value|+1e-6", ok=True, same_bits=same_gb,
                geometry=jdump(fg.glimpse_bwd_geometry([n])))
            if "fused_glimpse_bwd" in SAME_BITS and not same_gb:
                raise Failure(f"fused_glimpse_bwd {shape}: two runs of the kernel differ")
            glimpse_entries.append(dict(shape=shape, calls=calls, args=args, bargs=bargs,
                                        abs_err=worst, bwd_abs_err=worst_b))

    # the fused propagation unroll (SQAIR_FUSE_CELLS), one call per frame
    t0 = time.perf_counter()
    pshape = prop_shape(flags, B * k, img)
    pdims = prop_dims(pshape)
    pargs, pweights = prop_inputs(torch, fc, pshape, gen, device)
    poffs = fc.residual_layout(pdims)[0]
    with torch.inference_mode():
        got = fc._fwd_cuda(*pargs, pweights, pdims)
        same_p = all(torch.equal(a, b) for a, b in zip(got, fc._fwd_cuda(*pargs, pweights, pdims)))
        want = fc.prop_plain_fwd(*pargs, pweights, pdims)
        torch.cuda.synchronize()
        fields = list(zip(fc.OUT_FIELDS, got, want)) + [
            (f"residual.{name}", got[10][..., lo:hi], want[10][..., lo:hi])
            for name, (lo, hi) in poffs.items()]

        def prop_referee():
            w64 = fc.prop_plain_fwd(*(a.double() for a in pargs),
                                    tuple(t.double() for t in pweights), pdims)
            return list(w64[:10]) + [w64[10][..., lo:hi] for lo, hi in poffs.values()]

        worst_p, refereed_p = frame_fields_check(torch, f"fused_prop {pshape}", fields,
                                                 prop_referee, referee)
        lo, hi = poffs["gwl"]
        near = sum(near_integer_u(torch, fg, pargs[0], w.reshape(-1, 4), pdims[1:4])
                   for w in (want[10][..., lo:hi], want[3]))
        log(phase, t0, kernel="fused_prop", shape=jdump(pshape), outputs=len(fields),
            presence=f"{float(want[7].sum()):.0f}/{want[7].numel()}",
            max_abs_err=f"{worst_p:.3e}", tol=f"|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|value|",
            ok=True, same_bits=same_p, geometry=jdump(fc.prop_fwd_geometry([B * k])),
            **({"referee": jdump(refereed_p)} if refereed_p else {}))
        if "fused_prop" in SAME_BITS and not same_p:
            raise Failure(f"fused_prop {pshape}: two runs of the kernel differ")

        t0 = time.perf_counter()
        cots = tuple(torch.randn(t.shape, generator=gen, device=device) for t in want[:10])
        saved = (want[0], want[2], want[3], want[5], want[6], want[7], want[9])
        pbargs = (*pargs, pweights, saved, want[10], cots, pdims)
        got_b = fc._bwd_cuda(*pbargs)
        same_pb = all(torch.equal(a, b) for a, b in zip(got_b, fc._bwd_cuda(*pbargs)))
        want_b = fc.prop_plain_bwd(*pbargs)
        torch.cuda.synchronize()
        bnames = ["dwhat_tm1", "dwhere_tm1", "dpres_tm1", "dtemporal_h", "dh0"] + [
            "d" + n for n in fc.WEIGHT_NAMES]
        worst_pb, share_pb = 0.0, 0.0
        for name, a, b in zip(bnames, got_b, want_b, strict=True):
            err, size = scaled_err(torch, a, b)
            if a.shape != b.shape or not err <= BWD_TOL * size + 1e-6:
                raise Failure(f"fused_prop_bwd {pshape}: {name} differs by {err:.3g} "
                              f"(largest {size:.3g}; u within 1e-5 of an integer: {near})")
            worst_pb, share_pb = max(worst_pb, err), max(share_pb, err / (size + 1e-30))
        log(phase + "-bwd", t0, kernel="fused_prop_bwd", shape=jdump(pshape),
            gradients=len(bnames), max_abs_err=f"{worst_pb:.3e}", max_err_share=f"{share_pb:.3e}",
            u_near_integer=near, tol=f"|d|<={BWD_TOL:g}max|value|+1e-6", ok=True,
            same_bits=same_pb, geometry=jdump(fc.prop_bwd_geometry([B * k])))
        if not same_pb:
            raise Failure(f"fused_prop_bwd {pshape}: two runs of the kernel differ")
    prop_entry = dict(calls=T, abs_err=worst_p, bwd_abs_err=worst_pb)

    # the fused discovery unroll (SQAIR_FUSE_CELLS where discovery fuses),
    # one call per frame, on frames of the port's data generators
    t0 = time.perf_counter()
    dshape = disc_shape(disc_flags, B * k, img)
    ddims = disc_dims(dshape)
    dargs, dweights = disc_inputs(torch, fc, dshape, gen, device, frames)
    doffs = fc.disc_residual_layout(ddims)[0]
    with torch.inference_mode():
        got = fc._disc_fwd_cuda(*dargs, dweights, ddims)
        same_d = all(torch.equal(a, b)
                     for a, b in zip(got, fc._disc_fwd_cuda(*dargs, dweights, ddims)))
        want = fc.disc_plain_fwd(*dargs, dweights, ddims)
        torch.cuda.synchronize()
        fields = list(zip(fc.DISC_OUT_FIELDS, got, want)) + [
            (f"residual.{name}", got[9][..., lo:hi], want[9][..., lo:hi])
            for name, (lo, hi) in doffs.items()] + [
            ("glimpses", got[10], want[10]), ("input_encoder", got[11], want[11])]

        def disc_referee():
            w64 = fc.disc_plain_fwd(*(a.double() for a in dargs),
                                    tuple(t.double() for t in dweights), ddims)
            return (list(w64[:9]) + [w64[9][..., lo:hi] for lo, hi in doffs.values()]
                    + [w64[10], w64[11]])

        worst_d, refereed_d = frame_fields_check(torch, f"fused_disc {dshape}", fields,
                                                 disc_referee, referee)
        near_d = near_integer_u(torch, fg, dargs[0], want[3].reshape(-1, 4), ddims[1:4])
        log(phase, t0, kernel="fused_disc", shape=jdump(dshape), outputs=len(fields),
            presence=f"{float(want[7].sum()):.0f}/{want[7].numel()}",
            max_abs_err=f"{worst_d:.3e}", tol=f"|d|<={KERNEL_ATOL:g}+{KERNEL_RTOL:g}|value|",
            ok=True, same_bits=same_d, geometry=jdump(fc.disc_fwd_geometry(
                [B * k, ddims[0], *dshape["img"], *ddims[1:], dshape["C"]])),
            **({"referee": jdump(refereed_d)} if refereed_d else {}))
        if "fused_disc" in SAME_BITS and not same_d:
            raise Failure(f"fused_disc {dshape}: two runs of the kernel differ")

        t0 = time.perf_counter()
        cots = tuple(torch.randn(t.shape, generator=gen, device=device) for t in want[:9])
        saved = (want[0], want[2], want[3], want[5], want[6], want[7])
        dbargs = (*dargs, dweights, saved, want[9], want[10], want[11], cots, ddims)
        got_b = fc._disc_bwd_cuda(*dbargs)
        same_db = all(torch.equal(a, b) for a, b in zip(got_b, fc._disc_bwd_cuda(*dbargs)))
        want_b = fc.disc_plain_bwd(*dbargs)
        torch.cuda.synchronize()
        bnames = ["dcond", "dh0"] + ["d" + n for n in fc.DISC_WEIGHT_NAMES]
        worst_db, share_db = 0.0, 0.0
        for name, a, b in zip(bnames, got_b, want_b, strict=True):
            err, size = scaled_err(torch, a, b)
            if a.shape != b.shape or not err <= BWD_TOL * size + 1e-6:
                raise Failure(f"fused_disc_bwd {dshape}: {name} differs by {err:.3g} "
                              f"(largest {size:.3g}; u within 1e-5 of an integer: {near_d})")
            worst_db, share_db = max(worst_db, err), max(share_db, err / (size + 1e-30))
        log(phase + "-bwd", t0, kernel="fused_disc_bwd", shape=jdump(dshape),
            gradients=len(bnames), max_abs_err=f"{worst_db:.3e}", max_err_share=f"{share_db:.3e}",
            u_near_integer=near_d, tol=f"|d|<={BWD_TOL:g}max|value|+1e-6", ok=True,
            same_bits=same_db, geometry=jdump(fc.disc_bwd_geometry([B * k])))
        if "fused_disc_bwd" in SAME_BITS and not same_db:
            raise Failure(f"fused_disc_bwd {dshape}: two runs of the kernel differ")
    disc_entry = dict(calls=T, abs_err=worst_d, bwd_abs_err=worst_db)
    return types.SimpleNamespace(
        shapes=shapes, bwd_entries=bwd_entries, glimpse_entries=glimpse_entries,
        prop=dict(shape=pshape, dims=pdims, args=pargs, weights=pweights, bargs=pbargs,
                  **prop_entry),
        disc=dict(shape=dshape, dims=ddims, args=dargs, weights=dweights, bargs=dbargs,
                  **disc_entry))



def run():
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.data import (DeviceDatasetSampler, create_seq_dataset,
                                      make_template_bank)
    import numpy as np

    from sqair_tpu_torch.ops import build, fused, stn
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.scripts import eval as port_eval
    from sqair_tpu_torch.training import make_eval_step, make_train_step
    from sqair_tpu_torch.training.checkpoint import save_checkpoint

    stn.full_fp32_matmul()  # no TF32 anywhere, the plain versions included
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log("device", t0, name=repr(kind), count=torch.cuda.device_count(),
        capability=torch.cuda.get_device_capability(0), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(card, flush=True)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    build.library()
    log("build", t0, cached=build.last_build["cached"],
        build_seconds=f"{build.last_build['seconds']:.3f}",
        library=Path(build.last_build["path"]).name)
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--only=")]
    if only:
        # a development run of some phase groups: no result lines
        groups = {"conv": conv_phases, "options": options_phases, "dp": dp_phases}
        for name in only[0]:
            groups[name](torch, card, device)
        log("total", t_all, ok=True, only=jdump(only[0]))
        return 0

    # ----------------------------------------------------------- kernels
    flags = json.loads(RELEASE_FLAGS.read_text())
    disc_flags = dict(flags, **DISC_LEVERS)
    B, k = int(flags["batch_size"]), int(flags["k_particles"])
    T = int(flags.get("font_timesteps", 10))
    eval_shapes = main_path_shapes(flags, B, k, T)
    train_shapes = main_path_shapes(flags, B, k, T, train=True)
    wrappers, plains, bwd_wrappers, bwd_plains = kernel_tables(fused)
    gen = torch.Generator(device=device).manual_seed(SEED)
    frames = create_seq_dataset(n_samples=-(-B * k // T), n_timesteps=T, canvas_size=IMG,
                                obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 8,
                                templates=make_template_bank(256, 28, seed=SEED))["imgs"]
    frames = torch.from_numpy(frames.reshape(-1, *IMG).astype("float32") / 255.0)
    kc = check_kernels(torch, flags, disc_flags, B, k, T, IMG, frames, gen, device)
    shapes, bwd_entries, glimpse_entries = kc.shapes, kc.bwd_entries, kc.glimpse_entries
    pshape, pdims, pargs, pweights, pbargs = (kc.prop[key] for key in
                                              ("shape", "dims", "args", "weights", "bargs"))
    dshape, ddims, dargs, dweights, dbargs = (kc.disc[key] for key in
                                              ("shape", "dims", "args", "weights", "bargs"))
    prop_entry, disc_entry = kc.prop, kc.disc

    # -------------------------------------------------------------- eval
    t0 = time.perf_counter()
    n_seq = N_BATCHES * B
    data = create_seq_dataset(n_samples=n_seq, n_timesteps=T, canvas_size=IMG,
                              obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 1,
                              templates=make_template_bank(256, 28, seed=SEED))
    imgs = data["imgs"].astype("float32") / 255.0  # [T, N, 50, 50]
    nums = data["nums"].astype("float32").repeat(T, 0)  # [T, N, 3]
    model = mlp_mnist_model.load(flags, imgs.shape[2:], mean_img=imgs.mean((0, 1)),
                                 device=device, seed=SEED)
    eval_step = make_eval_step(model)
    log("eval-setup", t0, sequences=n_seq, T=T, B=B, k=k,
        params=sum(p.numel() for p in model.sequence.parameters()))

    batches = [(imgs[:, i * B:(i + 1) * B], nums[:, i * B:(i + 1) * B])
               for i in range(N_BATCHES)]
    noise_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    fused.reset_launches()
    t0 = time.perf_counter()
    # batch 0's noise is recorded for the re-runs below
    noises = [GeneratorNoise(noise_gen, device, record=(i == 0)) for i in range(N_BATCHES)]
    results = [eval_step(obs, gt, noise) for (obs, gt), noise in zip(batches, noises)]
    noise0 = noises[0].table
    torch.cuda.synchronize()
    eval_counts = dict(fused.launches)
    expected = expected_launches(eval_shapes, N_BATCHES)
    for i, m in enumerate(results):
        for key, v in m.items():
            if not torch.isfinite(v).all():
                raise Failure(f"batch {i}: metric {key} is not finite")
    log("eval", t0, steps=N_BATCHES, launches=jdump(eval_counts), expected=jdump(expected),
        iwae=f"{float(results[0]['iwae']):.4f}",
        num_step_accuracy=f"{float(results[0]['num_step_accuracy']):.4f}",
        mse=f"{float(results[0]['mse']):.5f}")
    if eval_counts != expected:
        raise Failure(f"launch counts {eval_counts} differ from the eval path's {expected}")

    t0 = time.perf_counter()
    obs0, gt0 = batches[0]
    with plain_versions(fused, fg, fc):
        fused.reset_launches()
        plain = eval_step(obs0, gt0, ReplayNoise(noise0, device))
        if sum(fused.launches.values()):
            raise Failure("the plain re-run launched a kernel")
    err_plain, _ = compare_metrics(torch, results[0], plain, "kernels vs plain on the card")
    cpu_model = copy.copy(model)
    cpu_model.sequence = copy.deepcopy(model.sequence).cpu()
    cpu = make_eval_step(cpu_model)(obs0, gt0, ReplayNoise(
        {key: v.cpu() for key, v in noise0.items()}, "cpu"))
    err_cpu, _ = compare_metrics(torch, results[0], cpu, "card vs the CPU")
    log("eval-check", t0, vs_plain_on_card=f"{err_plain:.3e}", vs_cpu=f"{err_cpu:.3e}",
        tol=METRIC_TOL, metrics=len(plain))

    # ------------------------------------------------------------ timing
    rows = {name: dict(weight=0, ms=0.0, plain=0.0, lib=0.0, bound=0.0, t_bytes=0.0,
                       t_ops=0.0, err=0.0) for name in KERNELS}

    def add_row(name, weight, ms, plain_ms, lib_ms, t_bytes, t_ops, err):
        r = rows[name]
        r["weight"] += weight
        r["ms"] += weight * ms
        r["plain"] += weight * plain_ms
        r["lib"] += weight * lib_ms
        r["bound"] += weight * max(t_bytes, t_ops)
        r["t_bytes"] += weight * t_bytes
        r["t_ops"] += weight * t_ops
        r["err"] = max(r["err"], err)

    with torch.inference_mode():
        for entry in shapes.values():
            t0 = time.perf_counter()
            kernel, shape, args = entry["kernel"], entry["shape"], entry["args"]
            ms = device_ms(torch, lambda: wrappers[kernel](*args))
            plain_ms = device_ms(torch, lambda: plains[kernel](*args))
            lib = library_fn(torch, kernel)
            lib_ms = device_ms(torch, lambda: lib(*args))
            nbytes, flops = work(kernel, shape)
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
            log("timing", t0, kernel=kernel, shape=jdump(shape),
                calls_per_eval_step=entry["eval"], calls_per_train_step=entry["train"],
                ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{max(t_bytes, t_ops):.5f}",
                bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
            # the kernels line weights each shape by its calls in a train step,
            # the main path of this slice
            add_row(kernel, entry["train"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                    entry["abs_err"])
        for entry in glimpse_entries:
            t0 = time.perf_counter()
            shape, args = entry["shape"], entry["args"]
            ms = device_ms(torch, lambda: fg.fused_glimpse_encoder(
                *args, shape["glimpse"], shape["n_what"]))
            plain_ms = device_ms(torch, lambda: fg.glimpse_plain_fwd(*args, glimpse_dims(shape)))
            chain = glimpse_library_fn(torch, stn, shape)
            lib_ms = device_ms(torch, lambda: chain(*args))
            nbytes, flops = glimpse_work(shape)
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
            log("timing", t0, kernel="fused_glimpse", shape=jdump(shape),
                calls_per_step=entry["calls"], ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
                library_ms=f"{lib_ms:.5f}", bound_ms=f"{max(t_bytes, t_ops):.5f}",
                mflop=f"{flops / 1e6:.1f}", mbyte=f"{nbytes / 1e6:.2f}",
                bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
            add_row("fused_glimpse", entry["calls"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                    entry["abs_err"])
        t0 = time.perf_counter()
        ms = device_ms(torch, lambda: fc._fwd_cuda(*pargs, pweights, pdims), calls=10)
        plain_ms = device_ms(torch, lambda: fc.prop_plain_fwd(*pargs, pweights, pdims),
                             calls=10)
        with switched({}), plain_versions(fused, fg, fc):
            lib_fwd, _ = prop_library_fns(torch, model.sequence.timestep.propagate, pargs, gen)
            lib_ms = device_ms(torch, lib_fwd, calls=10)
        nbytes, flops = prop_work(pshape)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
        log("timing", t0, kernel="fused_prop", shape=jdump(pshape),
            calls_per_step=prop_entry["calls"], ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{lib_ms:.5f}", bound_ms=f"{max(t_bytes, t_ops):.5f}",
            mflop=f"{flops / 1e6:.1f}", mbyte=f"{nbytes / 1e6:.2f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
        add_row("fused_prop", prop_entry["calls"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                prop_entry["abs_err"])
        t0 = time.perf_counter()
        ms = device_ms(torch, lambda: fc._disc_fwd_cuda(*dargs, dweights, ddims), calls=10)
        plain_ms = device_ms(torch, lambda: fc.disc_plain_fwd(*dargs, dweights, ddims),
                             calls=10)
        with switched({}), plain_versions(fused, fg, fc):
            lib_fwd, _ = disc_library_fns(torch, model.sequence.timestep.discover, dargs, gen)
            lib_ms = device_ms(torch, lib_fwd, calls=10)
        nbytes, flops = disc_work(dshape)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
        log("timing", t0, kernel="fused_disc", shape=jdump(dshape),
            calls_per_step=disc_entry["calls"], ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}",
            library_ms=f"{lib_ms:.5f}", bound_ms=f"{max(t_bytes, t_ops):.5f}",
            mflop=f"{flops / 1e6:.1f}", mbyte=f"{nbytes / 1e6:.2f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
        add_row("fused_disc", disc_entry["calls"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                disc_entry["abs_err"])

    t0 = time.perf_counter()
    step_noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 3), device)
    eval_step_ms = step_ms(torch, lambda: eval_step(obs0, gt0, step_noise), 2 * STEP_REPS)
    log("timing", t0, eval_step_ms=f"{eval_step_ms:.3f}",
        frames_per_s=f"{B * T / (eval_step_ms / 1e3):.1f}", reps=2 * STEP_REPS, B=B, T=T, k=k,
        card=repr(card))

    t0 = time.perf_counter()
    busy_ms, top = profile_device(torch, lambda: eval_step(obs0, gt0, step_noise))
    if busy_ms is None:
        log("profile", t0, device_busy="not-measured (the profiler saw no device time)")
    else:
        log("profile", t0, device_busy_ms=f"{busy_ms:.3f}", step_ms=f"{eval_step_ms:.3f}",
            busy_share=f"{busy_ms / eval_step_ms:.3f}", top=jdump(top), card=repr(card))

    # ------------------------------------------------------ eval-glimpse
    t0 = time.perf_counter()
    with switched(GLIMPSE_SWITCH):
        # the eval phase's generator, from the same seed: the same noise
        replay_gen = torch.Generator(device=device).manual_seed(SEED + 2)
        fused.reset_launches()
        glimpse_results = [eval_step(obs, gt, GeneratorNoise(replay_gen, device))
                           for obs, gt in batches]
        torch.cuda.synchronize()
        glimpse_eval_counts = dict(fused.launches)
        expected = expected_launches(main_path_shapes(flags, B, k, T, fuse_glimpse=True),
                                     N_BATCHES)
        if glimpse_eval_counts != expected:
            raise Failure(f"launch counts {glimpse_eval_counts} with SQAIR_FUSE_GLIMPSE differ "
                          f"from the eval path's {expected}")
        err_switch, worst_metric = max(
            compare_metrics(torch, got, want, f"eval batch {i}, switch on vs off")
            for i, (got, want) in enumerate(zip(glimpse_results, results)))
        eval_glimpse_ms = step_ms(torch, lambda: eval_step(obs0, gt0, step_noise), 2 * STEP_REPS)
    log("eval-glimpse", t0, steps=N_BATCHES, launches=jdump(glimpse_eval_counts),
        expected=jdump(expected), vs_switch_off=f"{err_switch:.3e}",
        worst_metric=worst_metric, tol=METRIC_TOL,
        eval_step_ms=f"{eval_glimpse_ms:.3f}", eval_step_ms_switch_off=f"{eval_step_ms:.3f}",
        card=repr(card))

    # -------------------------------------------------------- eval-cells
    t0 = time.perf_counter()
    with switched(CELLS_SWITCH):
        replay_gen = torch.Generator(device=device).manual_seed(SEED + 2)
        fused.reset_launches()
        cells_results = [eval_step(obs, gt, GeneratorNoise(replay_gen, device))
                         for obs, gt in batches]
        torch.cuda.synchronize()
        cells_eval_counts = dict(fused.launches)
        expected = expected_launches(
            main_path_shapes(flags, B, k, T, fuse_glimpse=True, fuse_cells=True), N_BATCHES)
        if cells_eval_counts != expected:
            raise Failure(f"launch counts {cells_eval_counts} with SQAIR_FUSE_CELLS differ "
                          f"from the eval path's {expected}")
        err_cells, worst_metric = max(
            compare_metrics(torch, got, want, f"eval batch {i}, cells switch on vs off")
            for i, (got, want) in enumerate(zip(cells_results, results)))
        eval_cells_ms = step_ms(torch, lambda: eval_step(obs0, gt0, step_noise), 2 * STEP_REPS)
        busy_ms, _ = profile_device(torch, lambda: eval_step(obs0, gt0, step_noise))
    log("eval-cells", t0, steps=N_BATCHES, launches=jdump(cells_eval_counts),
        expected=jdump(expected), vs_switch_off=f"{err_cells:.3e}", worst_metric=worst_metric,
        tol=METRIC_TOL, eval_step_ms=f"{eval_cells_ms:.3f}",
        eval_step_ms_glimpse_only=f"{eval_glimpse_ms:.3f}",
        eval_step_ms_switch_off=f"{eval_step_ms:.3f}",
        frames_per_s=f"{B * T / (eval_cells_ms / 1e3):.1f}",
        device_busy_ms="not-measured" if busy_ms is None else f"{busy_ms:.3f}",
        card=repr(card))

    # --------------------------------------------------------- eval-disc
    # the model at DISC_FLAGS (the same weights: the levers hold none), with
    # no switch and with both switches, under the eval phase's noise
    t0 = time.perf_counter()

    def load_disc_model():
        return mlp_mnist_model.load(disc_flags, imgs.shape[2:], mean_img=imgs.mean((0, 1)),
                                    device=device, seed=SEED)

    disc_model = load_disc_model()
    disc_eval = make_eval_step(disc_model)
    disc_runs = {}
    for label, switches in (("off", {}), ("on", CELLS_SWITCH)):
        with switched(switches):
            replay_gen = torch.Generator(device=device).manual_seed(SEED + 2)
            fused.reset_launches()
            res_d = [disc_eval(obs, gt, GeneratorNoise(replay_gen, device)) for obs, gt in batches]
            torch.cuda.synchronize()
            counts = dict(fused.launches)
            expected = expected_launches(main_path_shapes(
                disc_flags, B, k, T, fuse_glimpse=bool(switches), fuse_cells=bool(switches)),
                N_BATCHES)
            if counts != expected:
                raise Failure(f"launch counts {counts} at DISC_FLAGS, switches {switches}, "
                              f"differ from the eval path's {expected}")
            ms = step_ms(torch, lambda: disc_eval(obs0, gt0, step_noise), 2 * STEP_REPS)
            busy_ms, _ = profile_device(torch, lambda: disc_eval(obs0, gt0, step_noise))
        disc_runs[label] = dict(results=res_d, counts=counts, ms=ms, busy=busy_ms)
    err_disc, worst_metric = max(
        compare_metrics(torch, got, want, f"eval batch {i} at DISC_FLAGS, both switches vs off")
        for i, (got, want) in enumerate(zip(disc_runs["on"]["results"],
                                            disc_runs["off"]["results"])))
    off_d, on_d = disc_runs["off"], disc_runs["on"]
    log("eval-disc", t0, steps=N_BATCHES, launches=jdump(on_d["counts"]),
        launches_switch_off=jdump(off_d["counts"]), vs_switch_off=f"{err_disc:.3e}",
        worst_metric=worst_metric, tol=METRIC_TOL, eval_step_ms=f"{on_d['ms']:.3f}",
        eval_step_ms_switch_off=f"{off_d['ms']:.3f}",
        frames_per_s=f"{B * T / (on_d['ms'] / 1e3):.1f}",
        frames_per_s_switch_off=f"{B * T / (off_d['ms'] / 1e3):.1f}",
        device_busy_ms="not-measured" if on_d["busy"] is None else f"{on_d['busy']:.3f}",
        device_busy_ms_switch_off=("not-measured" if off_d["busy"] is None
                                   else f"{off_d['busy']:.3f}"),
        card=repr(card))

    # ------------------------------------------------------------- train
    t0 = time.perf_counter()
    sampler = DeviceDatasetSampler(data, device)
    optimizer, l2 = mlp_mnist_model.make_optimizer(flags)
    train_step = make_train_step(model, optimizer, l2_weight=l2)
    params = dict(model.sequence.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    data_gen = torch.Generator(device=device).manual_seed(SEED + 4)
    train_noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 5), device)
    train_batches = [sampler.sample(data_gen, B) for _ in range(N_TRAIN_STEPS)]
    torch.cuda.synchronize()
    log("train-setup", t0, optimizer=type(train_step.state.optimizer).__name__,
        learning_rate=flags["learning_rate"], schedule=flags["schedule"],
        train_itr=flags["train_itr"], l2=l2, sampler_sequences=sampler.n)
    t0 = time.perf_counter()
    fused.reset_launches()
    train_metrics = [train_step(b["imgs"], b["nums"], train_noise) for b in train_batches]
    torch.cuda.synchronize()
    train_counts = dict(fused.launches)
    expected = expected_launches(train_shapes, N_TRAIN_STEPS, backward=True)
    for i, m in enumerate(train_metrics):
        for key, v in m.items():
            if not torch.isfinite(v).all():
                raise Failure(f"train step {i}: metric {key} is not finite")
    changed = sorted(n for n, p in params.items() if not torch.equal(p.detach(), before[n]))
    frozen = sorted(set(params) - set(changed))
    log("train", t0, steps=N_TRAIN_STEPS, launches=jdump(train_counts),
        expected=jdump(expected), target=f"{float(train_metrics[-1]['target']):.4f}",
        iwae=f"{float(train_metrics[-1]['iwae']):.4f}",
        num_step_accuracy=f"{float(train_metrics[-1]['num_step_accuracy']):.4f}",
        params_changed=f"{len(changed)}/{len(params)}", unchanged=jdump(frozen))
    if train_counts != expected:
        raise Failure(f"launch counts {train_counts} differ from the train path's {expected}")
    if frozen != ["decoder.background_std", "decoder.output_std"]:
        raise Failure(f"parameters that did not change: {frozen} (only the decoder stds, "
                      "which get no gradient, should stay)")

    # ------------------------------------------------------- train-check
    t0 = time.perf_counter()
    tc = train_check(torch, model, disc_model, train_batches[0], flags, disc_flags, l2, device)
    report_train_check(tc, "train-check", t0)

    # ------------------------------------------------------ train-timing
    with torch.inference_mode():
        for entry in bwd_entries:
            t0 = time.perf_counter()
            kernel, shape, bargs = entry["kernel"], entry["shape"], entry["bwd_args"]
            need_dx = entry["need_dx"]
            ms = device_ms(torch, lambda: bwd_wrappers[kernel](*bargs, need_dx=need_dx))
            plain_ms = device_ms(torch, lambda: bwd_plains[kernel](*bargs))
            nbytes, flops = work(kernel, shape, backward=True, need_dx=need_dx)
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
            with torch.inference_mode(False):
                lib = library_bwd_fn(torch, kernel, entry["args"], need_dx, gen)
                lib_ms = device_ms(torch, lib)
            log("train-timing", t0, kernel=kernel + "_bwd", shape=jdump(shape),
                need_dx=need_dx, calls_per_train_step=entry["train"], ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{max(t_bytes, t_ops):.5f}",
                bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
            add_row(kernel + "_bwd", entry["train"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                    entry["bwd_abs_err"])
        for entry in glimpse_entries:
            t0 = time.perf_counter()
            shape, bargs = entry["shape"], entry["bargs"]
            ms = device_ms(torch, lambda: fg.fused_glimpse_bwd(*bargs))
            plain_ms = device_ms(torch, lambda: fg.glimpse_plain_bwd(*bargs))
            nbytes, flops = glimpse_work(shape, backward=True)
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
            with torch.inference_mode(False):
                lib = glimpse_library_bwd_fn(torch, stn, shape, entry["args"], gen)
                lib_ms = device_ms(torch, lib)
            log("train-timing", t0, kernel="fused_glimpse_bwd", shape=jdump(shape),
                calls_per_train_step=entry["calls"], ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
                bound_ms=f"{max(t_bytes, t_ops):.5f}", mflop=f"{flops / 1e6:.1f}",
                mbyte=f"{nbytes / 1e6:.2f}",
                bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
            add_row("fused_glimpse_bwd", entry["calls"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                    entry["bwd_abs_err"])
        t0 = time.perf_counter()
        ms = device_ms(torch, lambda: fc._bwd_cuda(*pbargs), calls=10)
        plain_ms = device_ms(torch, lambda: fc.prop_plain_bwd(*pbargs), calls=10)
        with torch.inference_mode(False), switched({}), plain_versions(fused, fg, fc):
            _, lib_bwd = prop_library_fns(torch, model.sequence.timestep.propagate, pargs, gen)
            lib_ms = device_ms(torch, lib_bwd, calls=10)
        nbytes, flops = prop_work(pshape, backward=True)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
        log("train-timing", t0, kernel="fused_prop_bwd", shape=jdump(pshape),
            calls_per_train_step=prop_entry["calls"], ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
            bound_ms=f"{max(t_bytes, t_ops):.5f}", mflop=f"{flops / 1e6:.1f}",
            mbyte=f"{nbytes / 1e6:.2f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
        add_row("fused_prop_bwd", prop_entry["calls"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                prop_entry["bwd_abs_err"])
        t0 = time.perf_counter()
        ms = device_ms(torch, lambda: fc._disc_bwd_cuda(*dbargs), calls=10)
        plain_ms = device_ms(torch, lambda: fc.disc_plain_bwd(*dbargs), calls=10)
        with torch.inference_mode(False), switched({}), plain_versions(fused, fg, fc):
            _, lib_bwd = disc_library_fns(torch, model.sequence.timestep.discover, dargs, gen)
            lib_ms = device_ms(torch, lib_bwd, calls=10)
        nbytes, flops = disc_work(dshape, backward=True)
        t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
        log("train-timing", t0, kernel="fused_disc_bwd", shape=jdump(dshape),
            calls_per_train_step=disc_entry["calls"], ms=f"{ms:.5f}",
            plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
            bound_ms=f"{max(t_bytes, t_ops):.5f}", mflop=f"{flops / 1e6:.1f}",
            mbyte=f"{nbytes / 1e6:.2f}",
            bound_by="bytes" if t_bytes >= t_ops else "operations", card=repr(card))
        add_row("fused_disc_bwd", disc_entry["calls"], ms, plain_ms, lib_ms, t_bytes, t_ops,
                disc_entry["bwd_abs_err"])

    t0 = time.perf_counter()
    timing_batch = train_batches[-1]
    train_step_ms = step_ms(
        torch, lambda: train_step(timing_batch["imgs"], timing_batch["nums"], train_noise),
        STEP_REPS)
    log("train-timing", t0, train_step_ms=f"{train_step_ms:.3f}",
        frames_per_s=f"{B * T / (train_step_ms / 1e3):.1f}", reps=STEP_REPS, B=B, T=T, k=k,
        card=repr(card))

    t0 = time.perf_counter()
    busy_ms, top = profile_device(
        torch, lambda: train_step(timing_batch["imgs"], timing_batch["nums"], train_noise))
    if busy_ms is None:
        log("train-profile", t0, device_busy="not-measured (the profiler saw no device time)")
    else:
        log("train-profile", t0, device_busy_ms=f"{busy_ms:.3f}",
            step_ms=f"{train_step_ms:.3f}", busy_share=f"{busy_ms / train_step_ms:.3f}",
            top=jdump(top), card=repr(card))

    # ----------------------------------------------------- train-glimpse
    t0 = time.perf_counter()
    with switched(GLIMPSE_SWITCH):
        fused.reset_launches()
        glimpse_metrics = [train_step(b["imgs"], b["nums"], train_noise) for b in train_batches]
        torch.cuda.synchronize()
        glimpse_train_counts = dict(fused.launches)
        expected = expected_launches(
            main_path_shapes(flags, B, k, T, train=True, fuse_glimpse=True), N_TRAIN_STEPS,
            backward=True)
        for i, m in enumerate(glimpse_metrics):
            for key, v in m.items():
                if not torch.isfinite(v).all():
                    raise Failure(f"switch-on train step {i}: metric {key} is not finite")
        if glimpse_train_counts != expected:
            raise Failure(f"launch counts {glimpse_train_counts} with SQAIR_FUSE_GLIMPSE differ "
                          f"from the train path's {expected}")
        train_glimpse_ms = step_ms(
            torch, lambda: train_step(timing_batch["imgs"], timing_batch["nums"], train_noise),
            STEP_REPS)
        busy_ms, _ = profile_device(
            torch, lambda: train_step(timing_batch["imgs"], timing_batch["nums"], train_noise))
    log("train-glimpse", t0, steps=N_TRAIN_STEPS, launches=jdump(glimpse_train_counts),
        expected=jdump(expected), target=f"{float(glimpse_metrics[-1]['target']):.4f}",
        train_step_ms=f"{train_glimpse_ms:.3f}",
        train_step_ms_switch_off=f"{train_step_ms:.3f}",
        device_busy_ms="not-measured" if busy_ms is None else f"{busy_ms:.3f}",
        card=repr(card))

    # ------------------------------------------------------- train-cells
    t0 = time.perf_counter()
    with switched(CELLS_SWITCH):
        fused.reset_launches()
        cells_metrics = [train_step(b["imgs"], b["nums"], train_noise) for b in train_batches]
        torch.cuda.synchronize()
        cells_train_counts = dict(fused.launches)
        expected = expected_launches(
            main_path_shapes(flags, B, k, T, train=True, fuse_glimpse=True, fuse_cells=True),
            N_TRAIN_STEPS, backward=True)
        for i, m in enumerate(cells_metrics):
            for key, v in m.items():
                if not torch.isfinite(v).all():
                    raise Failure(f"cells-switch train step {i}: metric {key} is not finite")
        if cells_train_counts != expected:
            raise Failure(f"launch counts {cells_train_counts} with SQAIR_FUSE_CELLS differ "
                          f"from the train path's {expected}")
        train_cells_ms = step_ms(
            torch, lambda: train_step(timing_batch["imgs"], timing_batch["nums"], train_noise),
            STEP_REPS)
        busy_ms, _ = profile_device(
            torch, lambda: train_step(timing_batch["imgs"], timing_batch["nums"], train_noise))
    log("train-cells", t0, steps=N_TRAIN_STEPS, launches=jdump(cells_train_counts),
        expected=jdump(expected), target=f"{float(cells_metrics[-1]['target']):.4f}",
        train_step_ms=f"{train_cells_ms:.3f}", train_step_ms_glimpse_only=f"{train_glimpse_ms:.3f}",
        train_step_ms_switch_off=f"{train_step_ms:.3f}",
        frames_per_s=f"{B * T / (train_cells_ms / 1e3):.1f}",
        device_busy_ms="not-measured" if busy_ms is None else f"{busy_ms:.3f}",
        card=repr(card))

    # -------------------------------------------------------- train-disc
    # two models at DISC_FLAGS from the same weights, one trained with no
    # switch and one with both, on the same batches and noise
    t0 = time.perf_counter()
    disc_off = load_disc_model()
    for name, p in disc_off.sequence.named_parameters():
        if not torch.equal(p, dict(disc_model.sequence.named_parameters())[name]):
            raise Failure(f"train-disc: the two models' {name} differ before training")
    for label, m, switches in (("off", disc_off, {}), ("on", disc_model, CELLS_SWITCH)):
        opt_d, _ = mlp_mnist_model.make_optimizer(disc_flags)
        step_d = make_train_step(m, opt_d, l2_weight=l2)
        noise_d = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 5), device)
        with switched(switches):
            fused.reset_launches()
            metrics_d = [step_d(b["imgs"], b["nums"], noise_d) for b in train_batches]
            torch.cuda.synchronize()
            counts = dict(fused.launches)
            expected = expected_launches(main_path_shapes(
                disc_flags, B, k, T, train=True, fuse_glimpse=bool(switches),
                fuse_cells=bool(switches)), N_TRAIN_STEPS, backward=True)
            if counts != expected:
                raise Failure(f"launch counts {counts} of the train step at DISC_FLAGS, "
                              f"switches {switches}, differ from {expected}")
            ms = step_ms(torch, lambda: step_d(timing_batch["imgs"], timing_batch["nums"],
                                               noise_d), STEP_REPS)
            busy_ms, _ = profile_device(
                torch, lambda: step_d(timing_batch["imgs"], timing_batch["nums"], noise_d))
        disc_runs["train_" + label] = dict(metrics=metrics_d, counts=counts, ms=ms, busy=busy_ms)
    off_t, on_t = disc_runs["train_off"], disc_runs["train_on"]
    # the first step's metrics come from the same weights; the updates move
    # the two models apart by the gradients' kink crossings (train-check),
    # so the later steps' distances are printed, not gated
    err_train_disc, worst_metric = compare_metrics(
        torch, on_t["metrics"][0], off_t["metrics"][0],
        "train step 0 at DISC_FLAGS, both switches vs off")
    later = [metric_distance(torch, got, want)
             for got, want in zip(on_t["metrics"][1:], off_t["metrics"][1:])]
    log("train-disc", t0, steps=N_TRAIN_STEPS, launches=jdump(on_t["counts"]),
        launches_switch_off=jdump(off_t["counts"]), vs_switch_off=f"{err_train_disc:.3e}",
        worst_metric=worst_metric, tol=METRIC_TOL,
        later_steps_vs_switch_off=jdump([f"{e:.3e} ({k})" for e, k in later]),
        target=f"{float(on_t['metrics'][-1]['target']):.4f}",
        train_step_ms=f"{on_t['ms']:.3f}", train_step_ms_switch_off=f"{off_t['ms']:.3f}",
        frames_per_s=f"{B * T / (on_t['ms'] / 1e3):.1f}",
        frames_per_s_switch_off=f"{B * T / (off_t['ms'] / 1e3):.1f}",
        device_busy_ms="not-measured" if on_t["busy"] is None else f"{on_t['busy']:.3f}",
        device_busy_ms_switch_off=("not-measured" if off_t["busy"] is None
                                   else f"{off_t['busy']:.3f}"),
        card=repr(card))

    # ---------------------------------------------------------- eval-cli
    # the saved checkpoint swept twice, each time into a run dir of its own:
    # with the glimpse switch alone, then with both switches
    cli_data = create_seq_dataset(n_samples=CLI_SEQUENCES, n_timesteps=T, canvas_size=IMG,
                                  obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 7,
                                  templates=make_template_bank(256, 28, seed=SEED))
    ckpt_step = train_step.state.step
    n_cli = CLI_SEQUENCES // B
    sweeps = {}
    for label, switches, fuse_cells in (("glimpse", GLIMPSE_SWITCH, False),
                                        ("glimpse+cells", CELLS_SWITCH, True)):
        t0 = time.perf_counter()
        run_root = tempfile.mkdtemp(prefix="sqair_eval_cli_")
        try:
            run_dir = os.path.join(run_root, "1")
            save_checkpoint(run_dir, ckpt_step, model.sequence, train_step.state.optimizer)
            shutil.copyfile(RELEASE_FLAGS, os.path.join(run_dir, "flags.json"))
            npz = os.path.join(run_root, "valid.npz")
            np.savez(npz, imgs=cli_data["imgs"], nums=cli_data["nums"])
            argv = ["--checkpoint_dir", run_dir, "--data_npz", npz, "--eval_batch_size", str(B)]
            with switched(switches):
                fused.reset_launches()
                done = port_eval.main(argv)
                torch.cuda.synchronize()
                cli_counts = dict(fused.launches)
                again = port_eval.main(argv)
            expected = expected_launches(
                main_path_shapes(flags, B, k, T, fuse_glimpse=True, fuse_cells=fuse_cells), n_cli)
            files = {}
            for m in port_eval.METRICS:
                path = os.path.join(run_dir, f"{port_eval.METRIC_FILES[m]}_valid.txt")
                with open(path) as f:
                    lines = f.read().splitlines()
                values = [float(v) for v in lines[0].split(":")[1].split()] if lines else []
                if len(lines) != 1 or not values or not all(math.isfinite(v) for v in values):
                    raise Failure(f"eval-cli ({label}): {path} holds {lines}, not one finite line")
                files[port_eval.METRIC_FILES[m]] = values if len(values) > 1 else values[0]
        finally:
            shutil.rmtree(run_root)
        if done != [ckpt_step] or again != []:
            raise Failure(f"eval-cli ({label}): evaluated {done} then {again}, expected "
                          f"[{ckpt_step}] then []")
        if cli_counts != expected:
            raise Failure(f"eval-cli ({label}): launch counts {cli_counts} differ from "
                          f"{expected}")
        sweeps[label] = files
        log("eval-cli", t0, switches=label, step=ckpt_step, batches=n_cli,
            launches=jdump(cli_counts), expected=jdump(expected), resumed_skips=True,
            metric_files=len(files), logpx=files["logpx"], acc=files["acc"])
    # the same checkpoint, data and noise: the two sweeps' metrics agree
    worst, worst_key = 0.0, None
    for key, want in sweeps["glimpse"].items():
        got = np.asarray(sweeps["glimpse+cells"][key], np.float64)
        want = np.asarray(want, np.float64)
        err = float(np.max(np.abs(got - want) / (np.abs(want) + 1.0)))
        if err >= worst:
            worst, worst_key = err, key
    if worst > METRIC_TOL:
        raise Failure(f"eval-cli: metric file {worst_key} differs between the sweeps by "
                      f"{worst:.3g} > {METRIC_TOL}")
    print(f"[eval-cli] sweeps_agree worst={worst:.3e} worst_file={worst_key} tol={METRIC_TOL}",
          flush=True)

    # ---------------------- the release checkpoint: its eval sweep, rollouts
    release_eval_phase(torch, card, device)
    rollout_phases(torch, card, device)

    # -------------------------------------------------------- experiment
    experiment_phase(torch, flags, disc_flags, data, B, k, T, card, device)

    # ---------------- the pedestrian configuration, the font data, on-device data
    pedestrian_phases(torch, card, device)
    font_data_phase(torch, card, device)
    on_device_data_phase(torch, card, device)

    # ------------------------------- the conv model, the model and optimizer options
    conv_phases(torch, card, device)
    options_phases(torch, card, device)

    # ------------- data parallelism across processes, the tools and the notebook
    dp_phases(torch, card, device)

    kernels = []
    for name, meta in KERNELS.items():
        r = rows[name]
        w = r["weight"]
        launches = (disc_runs["train_on"]["counts"] if name.startswith("fused_disc") else
                    cells_train_counts if name.startswith("fused_prop") else
                    glimpse_train_counts if name.startswith("fused_glimpse") else train_counts)
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[name], max_abs_err=r["err"], ms=r["ms"] / w,
            plain_ms=r["plain"] / w, bound_ms=r["bound"] / w,
            bound_by="bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
            library_ms=r["lib"] / w))
    log("total", t_all, ok=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def step_runners(torch, load, sampler, B, T, device):
    """Models of one configuration (``load(run_flags)``: weights from SEED),
    and their eager train steps and captured chains on batches of the
    device ``sampler``, all from the same data and noise seeds."""
    from sqair_tpu_torch.configs.mlp_mnist_model import make_optimizer
    from sqair_tpu_torch.ops.noise import GeneratorNoise
    from sqair_tpu_torch.training import init_train, make_train_step
    from sqair_tpu_torch.training.graph import make_chained_train_step

    def seeds():
        return (torch.Generator(device=device).manual_seed(SEED + 8),
                torch.Generator(device=device).manual_seed(SEED + 9))

    def eager_step(run_flags):
        """(model, step(): one eager train step on the next batch)."""
        model = load(run_flags)
        factory, l2 = make_optimizer(run_flags)
        step = make_train_step(model, factory, l2)
        g_data, g_noise = seeds()

        def one():
            b = sampler.sample(g_data, B)
            return step(b["imgs"], b["nums"], GeneratorNoise(g_noise, device))
        return model, one

    def eager_run(run_flags, steps):
        """(model, last metrics) of ``steps`` eager train steps."""
        model, one = eager_step(run_flags)
        for _ in range(steps):
            metrics = one()
        return model, {key: v.clone() for key, v in metrics.items()}

    def chained(run_flags, steps):
        """(model, chain) of a chain of ``steps`` train steps a call, from
        eager_run's weights and seeds."""
        model = load(run_flags)
        factory, l2 = make_optimizer(run_flags)
        state = init_train(model, factory)
        g_data, g_noise = seeds()
        chain = make_chained_train_step(model, state, lambda: sampler.sample(g_data, B), steps,
                                        T, l2, lambda itr: GeneratorNoise(g_noise, device),
                                        [g_data, g_noise])
        return model, chain

    return types.SimpleNamespace(eager_step=eager_step, eager_run=eager_run, chained=chained)


def graph_gate(torch, runners, run_flags, phase, switches=None, steps=CHAIN_STEPS):
    """A captured chain of ``steps`` train steps against as many eager
    steps from the same weights, data and noise: bit-identical, or within
    twice the distance of two eager runs of the same steps.  Returns that
    eager-vs-eager distance (parameters, metrics)."""
    t0 = time.perf_counter()
    with switched(switches or {}):
        eager_a, m_a = runners.eager_run(run_flags, steps)
        eager_b, m_b = runners.eager_run(run_flags, steps)
        ee_params = params_distance(torch, eager_a.sequence, eager_b.sequence)
        ee_metrics = metric_distance(torch, m_b, m_a)[0]
        graph_model, chain = runners.chained(run_flags, steps)
        m_graph = {key: v.clone() for key, v in chain().items()}
        ge_params = params_distance(torch, graph_model.sequence, eager_a.sequence)
        ge_metrics = metric_distance(torch, m_graph, m_a)[0]
        chain.release()
    log(phase, t0, gate="graph_vs_eager", steps=steps, opt=run_flags.get("opt", "rmsprop"),
        switches=jdump(sorted(switches or {})), params=f"{ge_params:.3e}",
        metrics=f"{ge_metrics:.3e}", eager_vs_eager_params=f"{ee_params:.3e}",
        eager_vs_eager_metrics=f"{ee_metrics:.3e}",
        bit_identical=ge_params == 0.0 and ge_metrics == 0.0)
    if ge_params > 2 * ee_params or ge_metrics > 2 * ee_metrics:
        raise Failure(f"{phase}: a graph of {steps} steps lies {ge_params:.3g} "
                      f"(parameters) / {ge_metrics:.3g} (metrics) from the eager steps, over "
                      f"twice the eager runs' {ee_params:.3g} / {ee_metrics:.3g}")
    return ee_params, ee_metrics


def time_settings(torch, runners, settings, B, k, T, img, card, phase):
    """For each (label, flags, switches) of ``settings``: one eager train
    step's launches against ``main_path_shapes``; a capture of N = 1 and N =
    CHAIN_STEPS steps launches N times as many; the wall ms a step (median,
    min, max of TIMING_REPEATS calls), frames/s and device-busy share of
    eager steps and of both graphs."""
    from sqair_tpu_torch.ops import fused

    for label, run_flags, switches in settings:
        t0 = time.perf_counter()
        with switched(switches):
            _, eager = runners.eager_step(run_flags)
            eager()
            torch.cuda.synchronize()
            fused.reset_launches()
            eager()
            torch.cuda.synchronize()
            one_step = dict(fused.launches)
            expected = expected_launches(main_path_shapes(
                run_flags, B, k, T, train=True, img=img,
                fuse_glimpse="SQAIR_FUSE_GLIMPSE" in switches,
                fuse_cells="SQAIR_FUSE_CELLS" in switches), 1, backward=True)
            if one_step != expected:
                raise Failure(f"{phase} {label}: an eager step launched {one_step}, "
                              f"not {expected}")
            timing = {"eager": (walls_ms(torch, eager, TIMING_REPEATS),
                                profile_device(torch, eager)[0], 1)}
            for n in (1, CHAIN_STEPS):
                _, chain = runners.chained(run_flags, n)
                chain()
                torch.cuda.synchronize()
                if chain.launches != {name: n * c for name, c in one_step.items()}:
                    raise Failure(f"{phase} {label}: a capture of {n} steps launched "
                                  f"{chain.launches}, not {n} x {one_step}")
                timing[f"graph_n{n}"] = (walls_ms(torch, chain, TIMING_REPEATS, n),
                                         profile_device(torch, chain)[0], n)
                chain.release()
        out = {}
        for mode, (walls, busy, n) in timing.items():
            median = statistics.median(walls)
            out[mode] = dict(
                step_ms=f"{median:.3f}", min_ms=f"{walls[0]:.3f}", max_ms=f"{walls[-1]:.3f}",
                frames_per_s=f"{B * T / (median / 1e3):.1f}",
                busy_ms_a_call="not-measured" if busy is None else f"{busy:.3f}",
                busy_share="not-measured" if busy is None else f"{busy / (median * n):.3f}")
        log(phase, t0, setting=label, repeats=TIMING_REPEATS, B=B, T=T, k=k,
            img=jdump(list(img)), eager_step_launches=jdump(one_step), timing=jdump(out),
            card=repr(card))


def experiment_phase(torch, flags, disc_flags, data, B, k, T, card, device):
    """The training CLI and its graphed train step on the card (see the
    module's docstring)."""
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.data import DeviceDatasetSampler
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.scripts import experiment as pexp

    release = json.loads(RELEASE_FLAGS.read_text())
    sampler = DeviceDatasetSampler(data, device)
    mean_img = data["imgs"].mean((0, 1)) / 255.0
    runners = step_runners(torch, lambda run_flags: mlp_mnist_model.load(
        run_flags, IMG, mean_img=mean_img, device=device, seed=SEED), sampler, B, T, device)

    # the allowance of the bit gates: two eager runs of the same steps
    ee_params, ee_metrics = graph_gate(torch, runners, flags, "experiment", steps=GATE_STEPS)

    # the CLI: 10 steps a call against 1, and a killed and resumed run
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sqair_experiment_")

    class Killed(Exception):
        pass

    real_save = pexp.save_checkpoint

    def save_then_die(run_dir, step, *args, **kwargs):
        real_save(run_dir, step, *args, **kwargs)
        if step == 10:
            raise Killed

    try:
        runs = {}
        for name, n in (("n10", CHAIN_STEPS), ("n1", 1)):
            fused.reset_launches()
            runs[name] = run_cli(pexp, pflags, cli_argv(release, root, name, n))
            runs[name] += (dict(fused.launches),)
        with mock.patch.object(pexp, "save_checkpoint", save_then_die):
            try:
                run_cli(pexp, pflags, cli_argv(release, root, "cut", CHAIN_STEPS))
                raise Failure("experiment: the run to be cut at step 10 was not")
            except Killed:
                pass
        runs["resumed"] = run_cli(pexp, pflags, [f"--results_dir={root}", "--run_name=cut",
                                                  "--resume"])
        records = {name: cli_records(r[0]) for name, r in runs.items()}
        n_params = params_distance(torch, runs["n10"][1].sequence, runs["n1"][1].sequence)
        n_records = records_distance(records["n10"], records["n1"])
        r_params = params_distance(torch, runs["resumed"][1].sequence, runs["n10"][1].sequence)
        r_records = records_distance([r for r in records["resumed"] if r["step"] > 10],
                                     [r for r in records["n10"] if r["step"] > 10])
        heartbeats = {name: [dict(step=r["step"], target=f"{r['target']:.4f}")
                             for r in recs if "target" in r] for name, recs in records.items()}
        steps = {name: r[2].step for name, r in runs.items()}
    finally:
        shutil.rmtree(root)
    counts = runs["n10"][4]
    log("experiment", t0, gate="cli", steps=jdump(steps), n10_vs_n1_params=f"{n_params:.3e}",
        n10_vs_n1_records=f"{n_records:.3e}", resumed_vs_uninterrupted_params=f"{r_params:.3e}",
        resumed_vs_uninterrupted_records=f"{r_records:.3e}",
        eager_vs_eager_params=f"{ee_params:.3e}", eager_vs_eager_metrics=f"{ee_metrics:.3e}",
        heartbeats=jdump(heartbeats), launches_n10_run=jdump(counts), card=repr(card))
    if steps != {"n10": CLI_STEPS, "n1": CLI_STEPS, "resumed": CLI_STEPS}:
        raise Failure(f"experiment: the CLI runs ended at {steps}")
    if n_params > 2 * ee_params or n_records > 2 * ee_metrics:
        raise Failure(f"experiment: 10 steps a call and 1 a call differ by {n_params:.3g} "
                      f"(parameters) / {n_records:.3g} (records), over twice the eager runs'")
    if r_params > 2 * ee_params or r_records > 2 * ee_metrics:
        raise Failure(f"experiment: the resumed run differs from the uninterrupted one by "
                      f"{r_params:.3g} (parameters) / {r_records:.3g} (records)")
    # the run's launches: the evals at steps 0 and 20 (the CLI_VALID valid
    # sequences each), the graph's warm-up step and its capture of 10 steps
    # (each replay launches the capture's kernels again, uncounted)
    evals = 2 * (CLI_VALID // B)
    expected = collections.Counter(expected_launches(main_path_shapes(flags, B, k, T), evals))
    expected.update(expected_launches(main_path_shapes(flags, B, k, T, train=True),
                                      1 + CHAIN_STEPS, backward=True))
    if counts != dict(expected) or any(v == 0 for v in counts.values()):
        raise Failure(f"experiment: the CLI's run launched {counts}, not {dict(expected)}")

    # timing and launch counts: eager steps and graphs of 1 and 10 steps
    time_settings(torch, runners, (("release_no_switch", flags, {}),
                                   ("release_both", flags, CELLS_SWITCH),
                                   ("disc_both", disc_flags, CELLS_SWITCH)),
                  B, k, T, IMG, card, "experiment")


def ped_flags():
    """The pedestrian configuration's flags: the JAX package's module
    defaults of mlp_mnist_model, pedestrian_model and pedestrian_data (the
    port's tables of them: 64x48 frames, 32x12 glimpses, 256 wide, n_what
    50, k 5, 3 slots, T 10), its training defaults (RMSProp at 1e-5) and the
    CLI's batch size, 32.  No early-discovery lever: with both switches the
    discovery runs fused too."""
    from sqair_tpu_torch.configs import mlp_mnist_model, pedestrian_data, pedestrian_model

    return dict(mlp_mnist_model.DEFAULTS, **mlp_mnist_model.TRAIN_DEFAULTS,
                **pedestrian_data.PED_DEFAULTS, **pedestrian_model.PED_MODEL_DEFAULTS,
                batch_size=32)


def ped_kernel_times(torch, kc, card, phase="ped-kernels"):
    """Device ms a call of every kernel, forward and backward, at the shapes
    of ``kc`` (``check_kernels``' entries), beside its bound; one line a
    shape, then each kernel's ms weighted by its calls a train step (the
    glimpse kernels at the glimpse switch's calls, the frame kernels at one
    call a frame)."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    wrappers, _, bwd_wrappers, _ = kernel_tables(fused)
    rows = collections.defaultdict(lambda: [0, 0.0, 0.0])

    def timed(name, shape, calls, fn, nbytes_flops, n_calls=20):
        t0 = time.perf_counter()
        ms = device_ms(torch, fn, calls=n_calls, reps=5)
        nbytes, flops = nbytes_flops
        bound = 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_F32)
        log(phase, t0, timing=name, shape=jdump(shape), calls_per_train_step=calls,
            ms=f"{ms:.5f}", bound_ms=f"{bound:.5f}", card=repr(card))
        r = rows[name]
        r[0] += calls
        r[1] += calls * ms
        r[2] += calls * bound

    with torch.inference_mode():
        for e in kc.shapes.values():
            kernel, shape, args = e["kernel"], e["shape"], e["args"]
            timed(kernel, shape, e["train"], lambda: wrappers[kernel](*args), work(kernel, shape))
        for e in kc.bwd_entries:
            kernel, shape, bargs, need_dx = e["kernel"], e["shape"], e["bwd_args"], e["need_dx"]
            timed(kernel + "_bwd", shape, e["train"],
                  lambda: bwd_wrappers[kernel](*bargs, need_dx=need_dx),
                  work(kernel, shape, backward=True, need_dx=need_dx))
        for e in kc.glimpse_entries:
            shape, args, bargs = e["shape"], e["args"], e["bargs"]
            timed("fused_glimpse", shape, e["calls"], lambda: fg.fused_glimpse_encoder(
                *args, shape["glimpse"], shape["n_what"]), glimpse_work(shape))
            timed("fused_glimpse_bwd", shape, e["calls"], lambda: fg.fused_glimpse_bwd(*bargs),
                  glimpse_work(shape, backward=True))
        p, d = kc.prop, kc.disc
        timed("fused_prop", p["shape"], p["calls"],
              lambda: fc._fwd_cuda(*p["args"], p["weights"], p["dims"]), prop_work(p["shape"]),
              n_calls=5)
        timed("fused_prop_bwd", p["shape"], p["calls"], lambda: fc._bwd_cuda(*p["bargs"]),
              prop_work(p["shape"], backward=True), n_calls=5)
        timed("fused_disc", d["shape"], d["calls"],
              lambda: fc._disc_fwd_cuda(*d["args"], d["weights"], d["dims"]),
              disc_work(d["shape"]), n_calls=5)
        timed("fused_disc_bwd", d["shape"], d["calls"], lambda: fc._disc_bwd_cuda(*d["bargs"]),
              disc_work(d["shape"], backward=True), n_calls=5)
    out = {name: (r[1] / r[0], r[2] / r[0]) for name, r in rows.items() if r[0]}
    print(f"[{phase}] ms_a_call_weighted=" + jdump({n: f"{v[0]:.5f}" for n, v in out.items()})
          + " bound_ms_weighted=" + jdump({n: f"{v[1]:.5f}" for n, v in out.items()})
          + f" card={card!r}", flush=True)
    if set(out) != set(KERNELS):
        raise Failure(f"{phase}: timed {sorted(out)}, not the twelve kernels")


# ped-train-check's runs: the kernels with no switch and with both (where
# the discovery fuses too at these flags), the plain versions on the card
# and on the CPU with each, and a float64 referee for each setting.  The
# gate holds each run on the card to its referee at max(GRAD_TOL, 2 x the
# farther of the setting's two kernel-free runs, card and CPU), per
# parameter: on the textured pedestrian frames a kernel-free f32 run lies
# 2-5% of a parameter's largest gradient from float64 (10x the release
# flags'), and one kernel-free run alone gave a bound that another
# kernel-free run (the CPU's) exceeded on the card (PERF.md)
PED_TRAIN_RUNS = {"kernels": ("card", "off", False), "plain_on_card": ("card", "off", True),
                  "cpu": ("cpu", "off", True), "both_kernels": ("card", "disc", False),
                  "both_plain": ("card", "disc", True), "both_cpu": ("cpu", "disc", True),
                  "referee": ("f64", "off", True), "referee_both": ("f64", "disc", True)}
PED_REFEREES = {"off": "referee", "disc": "referee_both"}
PED_GATE = {"kernels": ("plain_on_card", "cpu"), "plain_on_card": ("plain_on_card", "cpu"),
            "both_kernels": ("both_plain", "both_cpu"), "both_plain": ("both_plain", "both_cpu")}
PED_PAIRS = {"kernels_vs_plain_on_card": ("kernels", "plain_on_card"),
             "kernels_vs_cpu": ("kernels", "cpu"),
             "plain_on_card_vs_cpu": ("plain_on_card", "cpu"),
             "both_kernels_vs_both_plain": ("both_kernels", "both_plain"),
             "both_plain_vs_both_cpu": ("both_plain", "both_cpu"),
             "both_kernels_vs_switch_off_plain": ("both_kernels", "plain_on_card")}
PED_SETTINGS = (("no_switch", {}), ("glimpse", GLIMPSE_SWITCH), ("both", CELLS_SWITCH))


def pedestrian_phases(torch, card, device):
    """ped-kernels, ped-eval, ped-train, ped-train-check and ped-experiment
    (see the module's docstring)."""
    from sqair_tpu_torch.configs import pedestrian_data, pedestrian_model
    from sqair_tpu_torch.data import DeviceDatasetSampler, create_pedestrian_dataset
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise
    from sqair_tpu_torch.scripts import experiment as pexp
    from sqair_tpu_torch.training import make_eval_step, make_train_step

    flags = ped_flags()
    B, k, T = int(flags["batch_size"]), int(flags["k_particles"]), int(flags["ped_timesteps"])
    t0 = time.perf_counter()
    data = create_pedestrian_dataset(
        n_samples=int(flags["ped_train_samples"]), n_timesteps=T,
        canvas_size=pedestrian_data.parse_hw(flags["ped_canvas"]),
        obj_size=pedestrian_data.parse_hw(flags["ped_obj"]), seed=int(flags["ped_seed"]))
    img = tuple(int(v) for v in data["imgs"].shape[2:])
    mean_img = data["imgs"].mean((0, 1)) / 255.0
    sampler = DeviceDatasetSampler(data, device)

    def load(run_flags=flags):
        return pedestrian_model.load(run_flags, img, mean_img=mean_img, device=device, seed=SEED)

    log("ped-setup", t0, sequences=sampler.n, T=T, B=B, k=k, img=jdump(list(img)),
        glimpse=jdump(list(glimpse_hw(flags))), n_what=flags["n_what"],
        n_hidden=32 * int(flags["n_units"]), disc_fusable=disc_fusable(flags))

    # -------------------------------------------------------- ped-kernels
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    frames = data["imgs"][:, :-(-B * k // T)].reshape(-1, *img)[:B * k]
    frames = torch.from_numpy(frames.astype("float32") / 255.0)
    kc = check_kernels(torch, flags, flags, B, k, T, img, frames, gen, device,
                       phase="ped-kernels", modes=("train",), referee=True)
    ped_kernel_times(torch, kc, card)

    # ----------------------------------------------------------- ped-eval
    data_gen = torch.Generator(device=device).manual_seed(SEED + 11)
    batches = [sampler.sample(data_gen, B) for _ in range(N_BATCHES)]
    model = load()
    eval_step = make_eval_step(model)
    evals = {}
    for label, switches in PED_SETTINGS:
        t0 = time.perf_counter()
        with switched(switches):
            replay_gen = torch.Generator(device=device).manual_seed(SEED + 12)
            fused.reset_launches()
            res = [eval_step(b["imgs"], b["nums"], GeneratorNoise(replay_gen, device))
                   for b in batches]
            torch.cuda.synchronize()
            counts = dict(fused.launches)
            expected = expected_launches(main_path_shapes(
                flags, B, k, T, img=img, fuse_glimpse="SQAIR_FUSE_GLIMPSE" in switches,
                fuse_cells="SQAIR_FUSE_CELLS" in switches), N_BATCHES)
            for i, m in enumerate(res):
                for key, v in m.items():
                    if not torch.isfinite(v).all():
                        raise Failure(f"ped-eval {label} batch {i}: metric {key} is not finite")
            if counts != expected:
                raise Failure(f"ped-eval {label}: launch counts {counts} differ from the eval "
                              f"path's {expected}")
            err, worst_metric = (0.0, None) if label == "no_switch" else max(
                compare_metrics(torch, got, want, f"ped-eval batch {i}, {label} vs no switch")
                for i, (got, want) in enumerate(zip(res, evals["no_switch"])))
        evals[label] = res
        log("ped-eval", t0, setting=label, steps=N_BATCHES, launches=jdump(counts),
            expected=jdump(expected), vs_switch_off=f"{err:.3e}", worst_metric=worst_metric,
            tol=METRIC_TOL, iwae=f"{float(res[0]['iwae']):.4f}",
            num_step_accuracy=f"{float(res[0]['num_step_accuracy']):.4f}")

    # ---------------------------------------------------------- ped-train
    trained = {}
    for label, switches in PED_SETTINGS:
        t0 = time.perf_counter()
        m = load()
        factory, l2 = pedestrian_model.make_optimizer(flags)
        step = make_train_step(m, factory, l2_weight=l2)
        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 13), device)
        with switched(switches):
            fused.reset_launches()
            metrics = [step(b["imgs"], b["nums"], noise) for b in batches]
            torch.cuda.synchronize()
            counts = dict(fused.launches)
            expected = expected_launches(main_path_shapes(
                flags, B, k, T, train=True, img=img,
                fuse_glimpse="SQAIR_FUSE_GLIMPSE" in switches,
                fuse_cells="SQAIR_FUSE_CELLS" in switches), N_TRAIN_STEPS, backward=True)
        for i, mt in enumerate(metrics):
            for key, v in mt.items():
                if not torch.isfinite(v).all():
                    raise Failure(f"ped-train {label} step {i}: metric {key} is not finite")
        if counts != expected:
            raise Failure(f"ped-train {label}: launch counts {counts} differ from the train "
                          f"path's {expected}")
        # the first step's metrics come from the same weights, batch and noise
        err, worst_metric = (0.0, None) if label == "no_switch" else compare_metrics(
            torch, metrics[0], trained["no_switch"][0], f"ped-train step 0, {label} vs no switch")
        trained[label] = metrics
        log("ped-train", t0, setting=label, steps=N_TRAIN_STEPS, launches=jdump(counts),
            expected=jdump(expected), step0_vs_switch_off=f"{err:.3e}",
            worst_metric=worst_metric, tol=METRIC_TOL,
            target=f"{float(metrics[-1]['target']):.4f}")

    t0 = time.perf_counter()
    _, l2 = pedestrian_model.make_optimizer(flags)
    tc = train_check(torch, load(), None, batches[0], flags, flags, l2, device, img=img,
                     runs=PED_TRAIN_RUNS, referees=PED_REFEREES, gates=PED_GATE,
                     pairs=PED_PAIRS)
    report_train_check(tc, "ped-train-check", t0, PED_GATE)

    # ----------------------------------------------------- ped-experiment
    runners = step_runners(torch, load, sampler, B, T, device)
    graph_gate(torch, runners, flags, "ped-experiment", CELLS_SWITCH)
    root = tempfile.mkdtemp(prefix="sqair_ped_experiment_")
    try:
        for on_device in (True, False):
            t0 = time.perf_counter()
            name = "on_device" if on_device else "host"
            argv = ["--data_config=sqair_tpu/configs/pedestrian_data.py",
                    "--model_config=sqair_tpu/configs/pedestrian_model.py", "--seq_len=10",
                    "--stage_itr=0", "--eval_on_train=false", f"--train_itr={CHAIN_STEPS}",
                    f"--save_itr={CHAIN_STEPS}", f"--report_loss_every={CHAIN_STEPS}",
                    f"--log_itr={CHAIN_STEPS}", f"--fig_itr={CHAIN_STEPS}",
                    f"--results_dir={root}", f"--run_name={name}", "--device=cuda"]
            if on_device:
                argv += ["--on_device_data", f"--steps_per_call={CHAIN_STEPS}"]
            fused.reset_launches()
            logdir, _, state, _ = run_cli(pexp, pflags, argv)
            counts = dict(fused.launches)
            check_cli_run(logdir, state.step, "ped-experiment " + name)
            # the evals at steps 0 and 10, and the train steps' captures (on the
            # device: the warm-up step and one capture of 10 steps; from the
            # host: the warm-up and the capture of a step of 1)
            ev = 2 * (int(flags["ped_valid_samples"]) // B)
            expected = collections.Counter(expected_launches(
                main_path_shapes(flags, B, k, T, img=img), ev))
            expected.update(expected_launches(
                main_path_shapes(flags, B, k, T, train=True, img=img),
                1 + (CHAIN_STEPS if on_device else 1), backward=True))
            log("ped-experiment", t0, cli=name, argv=jdump(argv[:2] + argv[-2:]),
                steps=state.step, launches=jdump(counts), expected=jdump(dict(expected)))
            if counts != dict(expected):
                raise Failure(f"ped-experiment {name}: the CLI launched {counts}, not "
                              f"{dict(expected)}")
    finally:
        shutil.rmtree(root)
    # timed with both switches only: the other two settings run the kernels
    # that the release flags time
    time_settings(torch, runners, [("ped_both", flags, CELLS_SWITCH)], B, k, T, img, card,
                  "ped-experiment")


def check_cli_run(logdir, step, what, steps=CHAIN_STEPS):
    """A CLI run reached ``steps`` steps (``step``), its heartbeat there is
    finite and its eval there ran, with finite metrics."""
    records = cli_records(logdir)
    if step != steps:
        raise Failure(f"{what}: the CLI stopped at step {step}, not {steps}")
    beats = [r for r in records if r["step"] == steps and "target" in r]
    evals = [r for r in records if r["step"] == steps and any(
        key.endswith("/test") for key in r)]
    if not beats or not evals:
        raise Failure(f"{what}: no heartbeat or no eval at step {steps}: {records}")
    bad = [(key, v) for r in beats + evals for key, v in r.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise Failure(f"{what}: metrics not finite: {bad}")
    return beats[0], evals[0]


# a CLI run of the font-data phase in an interpreter of its own (the data
# configs' retunes hold for a whole process, the first one winning, so a run
# sees only its own configs' as a user's run does), with any render of a
# glyph bank an error: the banks must come from the glyph file
FONT_CLI = """
import json, sys
from sqair_tpu_torch.data import synthetic
from sqair_tpu_torch.scripts import experiment

def rendered(*args):
    raise RuntimeError("a glyph bank was rendered, not read from the glyph file")

synthetic.render_font_digit_bank = rendered
_, _, state = experiment.main(json.loads(sys.argv[1]))
print(json.dumps(dict(step=state.step)))
"""


def font_data_phase(torch, card, device):
    """font-data (see the module's docstring)."""
    import hashlib
    import importlib.util

    from sqair_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    banks = {}
    for n, size, seed in ((256, 28, 0), (256, 20, 0)):
        if (n, size, seed) not in synthetic.stored_font_banks():
            raise Failure(f"font-data: the glyph file holds no bank {(n, size, seed)}")
        bank, labels = synthetic.make_font_digit_bank(n, size, seed)
        banks[f"{n}x{size}px_seed{seed}"] = hashlib.sha256(
            bank.tobytes() + labels.tobytes()).hexdigest()
    log("font-data", t0, glyph_file=str(synthetic.GLYPH_FILE.relative_to(REPO)),
        sha256=jdump(banks),
        matplotlib_installed=importlib.util.find_spec("matplotlib") is not None)

    release = json.loads(RELEASE_FLAGS.read_text())
    n = FONT_CLI_STEPS
    common = ["--seq_len=10", "--stage_itr=0", "--on_device_data", f"--steps_per_call={n}",
              f"--train_itr={n}", f"--save_itr={n}", f"--report_loss_every={n}",
              f"--log_itr={n}", f"--fig_itr={n}", f"--font_valid_samples={FONT_VALID_SEQUENCES}",
              "--device=cuda"]
    # the release flags, less the synthetic data config's (which the font
    # config does not define); the small-digit pair's retunes are left to
    # its configs, and its sequences at the config's default
    given = {k: v for k, v in release.items() if k not in CLI_SET and not k.startswith("synth_")}
    retuned = {"output_std", "disc_step_bias", "font_obj_size", "font_train_samples",
               "model_config"}
    runs = (("release_font", [f"--{k}={v}" for k, v in given.items()
                              if k != "font_train_samples"]
             + [f"--data_config={release['data_config']}",
                f"--font_train_samples={FONT_TRAIN_SEQUENCES}"]),
            ("small_digit", [f"--{k}={v}" for k, v in given.items() if k not in retuned]
             + ["--data_config=sqair_tpu/configs/small_digit_seq_mnist_data.py",
                "--model_config=sqair_tpu/configs/small_digit_mnist_model.py"]))
    want = dict(release_font=tuple(release[f] for f in ("font_obj_size", "output_std",
                                                        "disc_step_bias")),
                small_digit=(20, 0.1, 2.0))
    root = tempfile.mkdtemp(prefix="sqair_font_data_")
    try:
        for name, argv in runs:
            t0 = time.perf_counter()
            argv = argv + common + [f"--results_dir={root}", f"--run_name={name}"]
            out = subprocess.run([sys.executable, "-c", FONT_CLI, json.dumps(argv)], cwd=REPO,
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                raise Failure(f"font-data {name}: the CLI failed: {out.stderr[-3000:]}")
            step = json.loads(out.stdout.strip().splitlines()[-1])["step"]
            logdir = os.path.join(root, name, "1")
            beat, ev = check_cli_run(logdir, step, f"font-data {name}", steps=n)
            with open(os.path.join(logdir, "flags.json")) as f:
                used = json.load(f)
            got = (used["font_obj_size"], used["output_std"], used["disc_step_bias"])
            log("font-data", t0, run=name, data_config=used["data_config"],
                model_config=used["model_config"], train_samples=used["font_train_samples"],
                obj_size=got[0], output_std=got[1], disc_step_bias=got[2], steps=step,
                target=f"{beat['target']:.4f}",
                eval=jdump({key: f"{ev[key]:.4f}" for key in
                            ("iwae/test", "num_step_accuracy/test", "target/test")}),
                card=repr(card))
            if got != want[name]:
                raise Failure(f"font-data {name}: font_obj_size, output_std and "
                              f"disc_step_bias are {got}, not {want[name]}")
    finally:
        shutil.rmtree(root)


def on_device_data_phase(torch, card, device):
    """on-device-data (see the module's docstring)."""
    from sqair_tpu_torch.data import DeviceDatasetSampler, OnDeviceSeqMNIST, make_template_bank

    t0 = time.perf_counter()
    templates = make_template_bank(64, 28)
    kw = dict(canvas_size=(50, 50), n_timesteps=10)
    gen = OnDeviceSeqMNIST(templates, device=device, **kw)
    draws = gen.draw(torch.Generator(device=device).manual_seed(42), ON_DEVICE_SEQUENCES)
    out = gen.render(draws)
    torch.cuda.synchronize()
    walls = walls_ms(torch, lambda: gen.render(draws), TIMING_REPEATS)
    cpu = OnDeviceSeqMNIST(templates, device="cpu", **kw).render(
        {key: v.cpu() for key, v in draws.items()})
    errs = {key: float(torch.max(torch.abs(out[key].cpu() - cpu[key]))) for key in cpu}
    counts = out["nums"][0].sum(-1)
    imgs = out["imgs"]
    sampler = DeviceDatasetSampler(out, device)
    batch = sampler.sample(torch.Generator(device=device).manual_seed(0), 32)
    log("on-device-data", t0, sequences=ON_DEVICE_SEQUENCES, T=kw["n_timesteps"],
        shape=jdump(list(imgs.shape)), card_vs_cpu=jdump({k: f"{v:.3e}" for k, v in errs.items()}),
        tol=1e-5, objects=jdump({int(c): int((counts == c).sum()) for c in counts.unique()}),
        pixels=f"[{float(imgs.min()):.3f}, {float(imgs.max()):.3f}]",
        render_ms=f"{statistics.median(walls):.3f}", render_ms_min=f"{walls[0]:.3f}",
        render_ms_max=f"{walls[-1]:.3f}", batch=jdump(list(batch["imgs"].shape)),
        card=repr(card))
    if max(errs.values()) > 1e-5:
        raise Failure(f"on-device-data: the card's render differs from the CPU's: {errs}")
    if not (bool((counts >= 0).all()) and bool((counts <= 2).all())):
        raise Failure("on-device-data: object counts outside n_objects (0, 2)")
    if not (float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0 + 1e-6):
        raise Failure("on-device-data: pixels outside [0, 1]")


def font_valid_set(flags):
    """The font data config's valid set at ``flags`` (a dict), raw (imgs
    uint8 [T, N, H, W], nums [1, N, C]), made as the config makes it."""
    from sqair_tpu_torch.configs.font_seq_mnist_data import make_sets

    return make_sets(types.SimpleNamespace(**flags), ("valid",))["valid"]


def release_eval_phase(torch, card, device):
    """release-eval (see the module's docstring)."""
    from sqair_tpu_torch.models.model import resampling_index
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.scripts import eval as port_eval
    from sqair_tpu_torch.training import make_eval_step
    from sqair_tpu_torch.training.checkpoint import find_checkpoints, restore_params

    t0 = time.perf_counter()
    flags = json.loads((PORT_RELEASE / "flags.json").read_text())
    valid = font_valid_set(flags)
    B, k, T = int(flags["batch_size"]), int(flags["k_particles"]), valid["imgs"].shape[0]
    n_batches = valid["imgs"].shape[1] // B
    root = tempfile.mkdtemp(prefix="sqair_release_eval_")
    try:
        run_dir = os.path.join(root, "1")
        os.makedirs(run_dir)
        (step, ckpt), = find_checkpoints(str(PORT_RELEASE)).items()
        shutil.copyfile(ckpt, os.path.join(run_dir, os.path.basename(ckpt)))
        shutil.copyfile(PORT_RELEASE / "flags.json", os.path.join(run_dir, "flags.json"))
        npz = os.path.join(root, "valid.npz")
        np.savez(npz, imgs=valid["imgs"], nums=valid["nums"])
        fused.reset_launches()
        done = port_eval.main(["--checkpoint_dir", run_dir, "--data_npz", npz,
                               "--eval_batch_size", str(B), "--device", device.type])
        torch.cuda.synchronize()
        counts = dict(fused.launches)
        files = {}
        for m in port_eval.METRICS:
            name = f"{port_eval.METRIC_FILES[m]}_valid.txt"
            rows = {}
            for path, key in ((os.path.join(run_dir, name), "card"),
                              (RELEASE_RUN / name, "release")):
                with open(path) as f:
                    line = f.read().splitlines()[0]
                rows[key] = [float(v) for v in line.split(":")[1].split()]
            if not all(math.isfinite(v) for v in rows["card"]):
                raise Failure(f"release-eval: {name} is not finite: {rows['card']}")
            files[port_eval.METRIC_FILES[m]] = rows
    finally:
        shutil.rmtree(root)
    expected = expected_launches(main_path_shapes(flags, B, k, T), n_batches)
    if done != [step]:
        raise Failure(f"release-eval: evaluated {done}, expected [{step}]")
    if counts != expected:
        raise Failure(f"release-eval: launch counts {counts} differ from {expected}")

    # batch 0 again, its noise recorded (each batch's noise is a generator
    # seeded with NOISE_SEED), with the render tensors; then on the CPU
    imgs = valid["imgs"][:, :B].astype(np.float32) / 255.0
    nums = valid["nums"][:, :B].astype(np.float32).repeat(T, 0)
    model = mlp_model_load(flags, imgs.shape[2:], device)
    restore_params(ckpt, model.sequence)
    noise = GeneratorNoise(torch.Generator(device=device).manual_seed(port_eval.NOISE_SEED),
                           device, record=True)
    card_aux = render_step(torch, model, imgs, nums, noise)
    table = {key: v.cpu() for key, v in noise.table.items()}
    cpu_model = copy.copy(model)
    cpu_model.sequence = copy.deepcopy(model.sequence).cpu()
    cpu_aux = render_step(torch, cpu_model, imgs, nums, ReplayNoise(table, "cpu"))
    err_cpu, worst = compare_metrics(torch, card_aux["metrics"], cpu_aux["metrics"],
                                     "release-eval batch 0, card vs the CPU")
    # the resampled particle: the same where the two largest perturbed
    # log-weights lie more than 1e-3 apart
    weights = torch.softmax(cpu_aux["log_weights"].double(), -1)
    u = table[("resample",)].double().clamp(min=torch.finfo(torch.float32).tiny)
    perturbed = torch.sort(-torch.log(-torch.log(u)) + torch.log(weights + 1e-38), -1).values
    clear = (perturbed[:, -1] - perturbed[:, -2] > 1e-3).numpy()
    card_idx = resampling_index(torch.softmax(card_aux["log_weights"], -1),
                                ReplayNoise(noise.table, device)).cpu().numpy()
    cpu_idx = resampling_index(torch.softmax(cpu_aux["log_weights"], -1),
                               ReplayNoise(table, "cpu")).numpy()
    if not np.array_equal(card_idx[clear], cpu_idx[clear]):
        raise Failure(f"release-eval: resampled particles differ: {card_idx} vs {cpu_idx}")
    # their render tensors, as the CPU tests hold them: |a - b| / (|b| + 1)
    render_err = {}
    for key, v in cpu_aux["render"].items():
        a = card_aux["render"][key].cpu().double()[:, torch.from_numpy(clear)]
        b = v.double()[:, torch.from_numpy(clear)]
        render_err[key] = float(torch.max(torch.abs(a - b) / (torch.abs(b) + 1.0)))
    worst_render = max(render_err, key=render_err.get)
    if not render_err[worst_render] <= METRIC_TOL:
        raise Failure(f"release-eval: render tensor {worst_render} of the card lies "
                      f"{render_err[worst_render]:.3g} from the CPU's, over {METRIC_TOL} "
                      f"(each: {jdump(render_err)})")
    log("release-eval", t0, checkpoint=str(PORT_RELEASE.relative_to(REPO)), step=step,
        sequences=valid["imgs"].shape[1], batches=n_batches, T=T, launches=jdump(counts),
        expected=jdump(expected),
        metrics=jdump({name: dict(card=r["card"], release_run=r["release"])
                       for name, r in files.items()}),
        batch0_card_vs_cpu=f"{err_cpu:.3e}", worst_metric=worst, tol=METRIC_TOL,
        resampled_index_equal=f"{int(clear.sum())}/{B}",
        render_vs_cpu=jdump({key: f"{v:.3e}" for key, v in render_err.items()}),
        card=repr(card))


def mlp_model_load(flags, img_shape, device, seed=SEED):
    """The MLP model of ``flags``, weights from ``seed``."""
    from sqair_tpu_torch.configs import mlp_mnist_model

    return mlp_mnist_model.load(flags, img_shape, mean_img=np.zeros(img_shape, np.float32),
                                device=device, seed=seed)


def render_step(torch, model, imgs, nums, noise):
    """(record "full") aux of loss_and_metrics with the render tensors,
    without autograd, the metrics finalised."""
    from sqair_tpu_torch.models import Model

    with torch.inference_mode():
        obs = torch.as_tensor(imgs, device=model.device)
        gt = torch.as_tensor(nums, device=model.device)
        _, aux = model.loss_and_metrics(obs, noise, gt, render=True)
    aux["metrics"] = Model.finalize_metrics(aux["metrics"])
    return aux


def kernel_calls(fused, fg, fc):
    """{kernel: (module, the function that launches it, its plain version on
    the same positional arguments)}: the six forward kernels of an eval step
    or a rollout.  Each launching function takes its wrapper's arguments and
    a ``save`` flag; the plain versions return everything the kernel can."""
    return {
        "fused_mlp": (fused, "_mlp_fwd_cuda", fused.mlp_plain_acts),
        "fused_vanilla_rnn": (fused, "_vrnn_fwd_cuda", fused.vanilla_rnn_plain),
        "fused_gru": (fused, "_gru_fwd_cuda", fused.gru_plain_saving),
        "fused_glimpse": (fg, "_fwd_cuda", fg.glimpse_plain_fwd),
        "fused_prop": (fc, "_fwd_cuda", fc.prop_plain_fwd),
        "fused_disc": (fc, "_disc_fwd_cuda", fc.disc_plain_fwd),
    }


def as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def to_double(torch, args):
    """The arguments with every float tensor (also inside tuples) in float64."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.double() if a.is_floating_point() else a
        if isinstance(a, (tuple, list)):
            return type(a)(conv(t) for t in a)
        return a
    return tuple(conv(a) for a in args)


def frame_fields(fc, kernel, outs):
    """(name, tensor) of each output field of a frame kernel's forward, its
    residual blob split by field."""
    if kernel == "fused_prop":
        offs = fc.residual_layout(outs["dims"])[0]
        return (list(zip(fc.OUT_FIELDS, outs["out"][:10])) + [
            (f"residual.{n}", outs["out"][10][..., lo:hi]) for n, (lo, hi) in offs.items()])
    offs = fc.disc_residual_layout(outs["dims"])[0]
    return (list(zip(fc.DISC_OUT_FIELDS, outs["out"][:9])) + [
        (f"residual.{n}", outs["out"][9][..., lo:hi]) for n, (lo, hi) in offs.items()] + [
        ("glimpses", outs["out"][10]), ("input_encoder", outs["out"][11])])


@contextlib.contextmanager
def checked_calls(torch, label):
    """Every kernel launch inside the block held against its plain version
    on the same inputs, on the card, call by call (the plain versions launch
    nothing, so the launch counts stay the block's, and the block gets the
    kernels' outputs).  Each output (a frame kernel's: each field) lies
    within |d| <= KERNEL_ATOL + KERNEL_RTOL |plain|, or else within
    max(KERNEL_ATOL, 2x the plain version's distance) of the plain version
    in float64 on the same inputs: the rule of ``frame_fields_check``, for
    sums whose terms are far larger than their result (cancellation), where
    the fixed bound is below float32's own error.  The frame kernels draw
    presences inside: the first presence of a row that the kernel draws
    otherwise than its plain version must have its uniform within
    FLIP_MARGIN of both probabilities (such a call is counted as crossed,
    not gated; any other flip fails).  Yields {kernel: dict(calls,
    max_abs_err, of_tol: the largest |d| over its fixed bound, refereed:
    calls held to float64, of_referee: the largest distance to float64 over
    its bound, crossed)}, filled as the block runs."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    table = kernel_calls(fused, fg, fc)
    plain = {kernel: fn for kernel, (_, _, fn) in table.items()}
    report = {}

    def held(kernel, st, fields, referee):
        worst, refereed = frame_fields_check(torch, f"{label}: {kernel} call {st['calls']}",
                                             fields, referee, referee=True, stats=st)
        st["max_abs_err"] = max(st["max_abs_err"], worst)
        st["refereed"] += bool(refereed)

    def flipped(kernel, st, args, got, want):
        """Whether a frame kernel drew a presence otherwise than its plain
        version, at a near-tie (else this fails)."""
        u = args[8] if kernel == "fused_prop" else args[6]
        S = u.shape[0]
        differ = (got[7] != want[7]).reshape(S, -1)  # [S, B]
        if not bool(differ.any()):
            return False
        rows = torch.nonzero(differ.any(0))[:, 0]
        first = differ.int().argmax(0)[rows]  # each row's first slot that differs
        u_, pk, pp = (t.reshape(S, -1)[first, rows] for t in (u, got[6], want[6]))
        near = (torch.abs(u_ - pk) < FLIP_MARGIN) & (torch.abs(u_ - pp) < FLIP_MARGIN)
        if not bool(near.all()):
            raise Failure(f"{label}: {kernel} call {st['calls']} draws a presence otherwise "
                          f"than its plain version, its uniform over {FLIP_MARGIN} from the "
                          "probabilities")
        st["crossed"] += 1
        return True

    def checking(kernel, real):
        def call(*args, **kw):
            out = real(*args, **kw)
            got, want = as_tuple(out), as_tuple(plain[kernel](*args))
            st = report.setdefault(kernel, dict(calls=0, max_abs_err=0.0, of_tol=0.0,
                                                refereed=0, of_referee=0.0, crossed=0))
            st["calls"] += 1

            def ref_out():
                return as_tuple(plain[kernel](*to_double(torch, args)))

            if kernel in ("fused_prop", "fused_disc"):
                if flipped(kernel, st, args, got, want):
                    return out
                named = [frame_fields(fc, kernel, dict(out=o, dims=args[-1]))
                         for o in (got, want)]
                fields = [(n, a, b) for (n, a), (_, b) in zip(*named)]
                held(kernel, st, fields, lambda: [t for _, t in frame_fields(
                    fc, kernel, dict(out=ref_out(), dims=args[-1]))])
            else:
                keep = [i for i, a in enumerate(got) if a is not None and a.numel()]

                def referee():
                    ref = ref_out()
                    return [ref[i] for i in keep]

                held(kernel, st, [(f"output {i}", got[i], want[i]) for i in keep], referee)
            return out
        return call

    with contextlib.ExitStack() as stack:
        for kernel, (module, name, _) in table.items():
            stack.enter_context(mock.patch.object(module, name,
                                                  checking(kernel, getattr(module, name))))
        yield report
    for st in report.values():
        st.update(max_abs_err=f"{st['max_abs_err']:.3e}", of_tol=f"{st['of_tol']:.3f}",
                  of_referee=f"{st['of_referee']:.3f}")


def rollout_vs_plain(torch, model, obs, cond, table, out, sites, switches, label):
    """The kernels' rollout ``out`` (its presence probabilities ``sites``)
    against the same rollout through the plain versions on the card under
    the recorded noise ``table``.  The first presence draw that the two
    sample otherwise must be crossed (FLIP_MARGIN).  Generation amplifies
    the calls' rounding differences frame by frame (PERF.md §6), so the
    distances are reported, not gated (``checked_calls`` gates the calls):
    returns the frame of the first flip, the largest distance of each
    window (the inferred frames, then the generated ones before the first
    flip), the first frame at which the two lie PART_AT apart, and the
    distance at every tenth frame."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg
    from sqair_tpu_torch.ops.noise import ReplayNoise
    from sqair_tpu_torch.scripts import rollout

    with switched(switches), plain_versions(fused, fg, fc):
        fused.reset_launches()
        with presence_sites(torch, model) as plain_sites:
            plain = rollout.generate(model, obs, ReplayNoise(table, obs.device))
        if sum(fused.launches.values()):
            raise Failure(f"{label}: the plain run launched a kernel")
    T = obs.shape[0]
    t, crossed = first_flip(sites, plain_sites, table)
    if not crossed:
        raise Failure(f"{label}: the kernels draw a presence at frame {t} otherwise than the "
                      f"plain versions, its uniform over {FLIP_MARGIN} from the probabilities")
    errs = frame_errors(torch, out, plain)
    worst = np.max(np.stack(list(errs.values())), 0)  # [T]
    flip = T if t is None else t
    over = np.nonzero(worst > PART_AT)[0]

    def window(frames):
        if frames.start >= frames.stop:
            return None
        field = max(errs, key=lambda n: float(np.max(errs[n][frames])))
        return dict(field=field, distance=f"{float(np.max(errs[field][frames])):.3e}")

    return dict(first_flip=t, inferred=window(slice(0, min(cond, flip))),
                generated=window(slice(cond, flip)),
                parted_at=int(over[0]) if over.size else None,
                every_10th={int(i): f"{float(worst[i]):.2e}" for i in range(0, T, 10)})


def rollout_phases(torch, card, device):
    """rollout and rollout-disc (see the module's docstring)."""
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.scripts import rollout

    release = json.loads((PORT_RELEASE / "flags.json").read_text())
    B, T, cond = ROLLOUT["n_examples"], ROLLOUT["rollout_len"], ROLLOUT["condition_frames"]
    k = int(release["k_particles"])
    argv = [f"--checkpoint_dir={PORT_RELEASE}", f"--device={device.type}"] + [
        f"--{key}={v}" for key, v in ROLLOUT.items()]
    for label, switches in ROLLOUT_SETTINGS:
        t0 = time.perf_counter()
        captured = {}
        real_generate = rollout.generate

        def generate(model, obs, noise):
            captured.update(model=model, obs=obs)
            with presence_sites(torch, model) as sites:
                out = real_generate(model, obs, noise)
            captured["sites"] = sites
            return out

        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED), device,
                               record=True)
        out_dir = tempfile.mkdtemp(prefix="sqair_rollout_")
        try:
            pflags.reset()
            with switched(switches), mock.patch.object(rollout, "generate", generate):
                fused.reset_launches()
                with checked_calls(torch, f"rollout ({label})") as calls:
                    result = rollout.main(argv + [f"--out_dir={out_dir}"], noise=noise)
                    torch.cuda.synchronize()
                    counts = dict(fused.launches)
            with np.load(result["npz"]) as f:
                npz = {key: f[key].shape for key in f.files}
        finally:
            pflags.reset()
            shutil.rmtree(out_dir)
        model, obs, out = captured["model"], captured["obs"], result["outputs"]
        expected = expected_launches(main_path_shapes(
            release, B, k, T, fuse_glimpse=bool(switches), fuse_cells=label == "both",
            generate=True), 1)
        if counts != expected:
            raise Failure(f"rollout ({label}): launch counts {counts} differ from {expected}")
        for key, v in out.items():
            if not bool(torch.isfinite(v).all()):
                raise Failure(f"rollout ({label}): {key} is not finite")
        disc_pres = float(out["disc_pres"][cond:].abs().max())
        if disc_pres != 0.0:
            raise Failure(f"rollout ({label}): discovery's presence is {disc_pres} in a "
                          "generated frame")
        if npz["canvas"] != (T, B) + IMG or npz["conditioned"] != (cond, B) + IMG:
            raise Failure(f"rollout ({label}): rollout.npz holds {npz}")
        vs_plain = rollout_vs_plain(torch, model, obs, cond, noise.table, out,
                                    captured["sites"], switches, f"rollout ({label})")
        table = noise.table
        with switched(switches):
            walls = walls_ms(torch, lambda: rollout.generate(model, obs, ReplayNoise(
                table, device)), ROLLOUT_REPEATS)
        ms = statistics.median(walls)
        log("rollout", t0, setting=label, checkpoint=str(PORT_RELEASE.relative_to(REPO)),
            examples=B, frames=T, conditioned=cond, launches=jdump(counts),
            expected=jdump(expected), npz=jdump({key: list(v) for key, v in npz.items()}),
            generated_disc_pres=disc_pres, calls=jdump(calls), vs_plain=jdump(vs_plain),
            mean_objects=f"{float(out['presence'][cond:].sum(-1).mean()):.3f}",
            wall_ms=f"{ms:.3f}", wall_ms_min=f"{walls[0]:.3f}", wall_ms_max=f"{walls[-1]:.3f}",
            frames_per_s=f"{B * T / (ms / 1e3):.1f}", card=repr(card))
        del model, obs, out, result, captured

    # kernel #7 on the generation path: DISC_FLAGS, both switches, seed weights
    t0 = time.perf_counter()
    disc_flags = dict(release, sample_from_prior=True, generate_after=cond - 1, **DISC_LEVERS)
    valid = font_valid_set(release)
    frames = valid["imgs"][:cond, :B].astype(np.float32) / 255.0
    padded = np.zeros((DISC_ROLLOUT_LEN,) + frames.shape[1:], np.float32)
    padded[:cond] = frames
    model = mlp_model_load(disc_flags, IMG, device)
    obs = torch.from_numpy(padded).to(device)
    noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED), device, record=True)
    with switched(CELLS_SWITCH), presence_sites(torch, model) as sites:
        fused.reset_launches()
        with checked_calls(torch, "rollout-disc") as calls:
            out = rollout.generate(model, obs, noise)
            torch.cuda.synchronize()
            counts = dict(fused.launches)
    expected = expected_launches(main_path_shapes(
        disc_flags, B, k, DISC_ROLLOUT_LEN, fuse_glimpse=True, fuse_cells=True, generate=True), 1)
    if counts != expected or not counts.get("fused_disc"):
        raise Failure(f"rollout-disc: launch counts {counts} differ from {expected}")
    if float(out["disc_pres"][cond:].abs().max()) != 0.0:
        raise Failure("rollout-disc: discovery's presence is not 0 in a generated frame")
    vs_plain = rollout_vs_plain(torch, model, obs, cond, noise.table, out, sites,
                                CELLS_SWITCH, "rollout-disc")
    with switched(CELLS_SWITCH):
        walls = walls_ms(torch, lambda: rollout.generate(model, obs, ReplayNoise(
            noise.table, device)), ROLLOUT_REPEATS)
    ms = statistics.median(walls)
    log("rollout-disc", t0, examples=B, frames=DISC_ROLLOUT_LEN, conditioned=cond,
        launches=jdump(counts), expected=jdump(expected), calls=jdump(calls),
        vs_plain=jdump(vs_plain), wall_ms=f"{ms:.3f}",
        frames_per_s=f"{B * DISC_ROLLOUT_LEN / (ms / 1e3):.1f}", card=repr(card))


# ---------------------------------------------------------------- the conv model
# conv-train-check's runs: the kernels, the plain versions on the card, and
# the float64 referee; no switch (the conv model fuses nothing).  No CPU run:
# a full-width conv train step on the host's cores took ~10x the card's
# whole run of it
CONV_TRAIN_RUNS = {"kernels": ("card", "off", False), "plain_on_card": ("card", "off", True),
                   "referee": ("f64", "off", True)}
CONV_GATE = {"kernels": ("plain_on_card",)}
CONV_PAIRS = {"kernels_vs_plain_on_card": ("kernels", "plain_on_card")}
CONV_SEQUENCES = 256
CONV_ROLLOUT_LEN = 10
# the options phase: the graphed optimizers' steps, the coverage CLI's steps
OPTION_CHAIN_STEPS, COVERAGE_CLI_STEPS = 3, 3
OPTION_MODELS = (("lstm_cells", dict(transition="LSTM", time_transition="LSTM",
                                     prior_transition="LSTM")),
                 ("prior_rw", dict(prop_prior_type="rw")),
                 ("prior_guided", dict(prop_prior_type="guided")))
BWD_KERNELS = ("fused_mlp_bwd", "fused_vanilla_rnn_bwd", "fused_gru_bwd")


def conv_flags():
    """The conv configuration's flags: the JAX package's module defaults of
    mlp_mnist_model and conv_mnist_model (the port's tables of them:
    conv_channels 32,64, conv_kernel 3, 256 wide, n_what 50, k 5, 3 slots,
    20x20 glimpses), its training defaults (RMSProp at 1e-5) and the CLI's
    batch size, 32; T 10 on 50x50 frames."""
    from sqair_tpu_torch.configs import conv_mnist_model, mlp_mnist_model

    return dict(mlp_mnist_model.DEFAULTS, **mlp_mnist_model.TRAIN_DEFAULTS,
                **conv_mnist_model.CONV_DEFAULTS, batch_size=32,
                model_config="sqair_tpu/configs/conv_mnist_model.py")


@contextlib.contextmanager
def checked_bwd_calls(torch, label, frames=False):
    """Every call of the MLP, vanilla-RNN and GRU backward wrappers (with
    ``frames``, also of the glimpse, propagation and discovery backward
    wrappers) inside the block held against its plain version on the same
    inputs, on the card: each gradient within |d| <= BWD_TOL max|plain| +
    1e-6, or else within max(that, 2x the plain version's distance) of the
    plain version in float64 (the rule of ``frame_fields_check``).  Yields
    {kernel: dict(calls, max_abs_err, of_tol, refereed, shapes: {shape:
    calls})}: an MLP / RNN call's shape is [rows, d_in, widths..., dx], a
    frame kernel's its first input's."""
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops import fused_cells as fc
    from sqair_tpu_torch.ops import fused_glimpse as fg

    # kernel: (module, wrapper, plain version, the inputs' count)
    table = {"fused_mlp_bwd": (fused, "fused_mlp_bwd", fused.mlp_bwd_plain, 5),
             "fused_vanilla_rnn_bwd": (fused, "fused_vanilla_rnn_bwd",
                                       fused.vanilla_rnn_bwd_plain, 6),
             "fused_gru_bwd": (fused, "fused_gru_bwd", fused.gru_bwd_plain, 9)}
    if frames:
        table.update({"fused_glimpse_bwd": (fg, "fused_glimpse_bwd", fg.glimpse_plain_bwd, 10),
                      "fused_prop_bwd": (fc, "prop_bwd", fc.prop_plain_bwd, 14),
                      "fused_disc_bwd": (fc, "disc_bwd", fc.disc_plain_bwd, 14)})
    report = {}

    def flat(kernel, out):
        return flat_grads("fused_mlp", out) if kernel == "fused_mlp_bwd" else list(out)

    def checking(kernel, real):
        _, _, plain, n_args = table[kernel]

        def call(*args, **kw):
            out = real(*args, **kw)
            inputs = args[:n_args]
            # the frame kernels' crop_keep is an input; the MLP's need_dx
            # and the like are the wrapper's own
            kw_in = {} if kernel in BWD_KERNELS else kw
            got, want = flat(kernel, out), flat(kernel, plain(*inputs, **kw_in))
            st = report.setdefault(kernel, dict(calls=0, max_abs_err=0.0, of_tol=0.0,
                                                refereed=0, shapes=collections.Counter()))
            st["calls"] += 1
            x = inputs[0]
            if kernel in BWD_KERNELS:
                widths = ([w.shape[1] for w, _ in inputs[1]] if kernel == "fused_mlp_bwd"
                          else [inputs[1].shape[1]])
                shape = [x.shape[0], x.shape[1]] + widths + [got[0] is not None]
            else:
                shape = list(x.shape)
            st["shapes"][jdump(shape)] += 1
            ref = None
            for i, (a, b) in enumerate(zip(got, want, strict=True)):
                if a is None:
                    continue
                d = float(torch.max(torch.abs(a - b))) if a.numel() else 0.0
                bound = BWD_TOL * (float(torch.max(torch.abs(b))) if b.numel() else 0.0) + 1e-6
                st["max_abs_err"] = max(st["max_abs_err"], d)
                st["of_tol"] = max(st["of_tol"], d / bound)
                if d <= bound:
                    continue
                if ref is None:
                    ref = flat(kernel, plain(*to_double(torch, inputs),
                                             **dict(zip(kw_in, to_double(torch,
                                                                         kw_in.values())))))
                err_k = float(torch.max(torch.abs(a.double() - ref[i])))
                err_p = float(torch.max(torch.abs(b.double() - ref[i])))
                st["refereed"] += 1
                if not err_k <= max(bound, 2.0 * err_p):
                    raise Failure(f"{label}: {kernel} call {st['calls']} gradient {i} lies "
                                  f"{err_k:.3g} from its float64 value (plain {err_p:.3g}, "
                                  f"bound {bound:.3g})")
            return out
        return call

    with contextlib.ExitStack() as stack:
        for kernel, (module, name, _, _) in table.items():
            stack.enter_context(mock.patch.object(module, name,
                                                  checking(kernel, getattr(module, name))))
        yield report
    for st in report.values():
        st.update(max_abs_err=f"{st['max_abs_err']:.3e}", of_tol=f"{st['of_tol']:.3f}",
                  shapes=dict(st["shapes"]))


def finite(metrics, what):
    for i, m in enumerate(metrics):
        for key, v in m.items():
            if not bool(v.isfinite().all()):
                raise Failure(f"{what} {i}: metric {key} is not finite")


def conv_kernel_times(torch, F, B, k, T, card, phase="conv-kernels"):
    """Device ms a call of the MLP kernel's conv shapes (one linear layer: the
    input encoder's, the glimpse encoder's and the subpixel decoder's seed
    MLP), forward and backward (the encoders' dx included), beside the plain
    version, the library call and the bound, with their calls a train step."""
    from sqair_tpu_torch.ops import fused

    wrappers, plains, bwd_wrappers, bwd_plains = kernel_tables(fused)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    for kernel, shape, calls in main_path_shapes(F, B, k, T, train=True):
        if kernel != "fused_mlp" or shape["acts"] != ["id"] or len(shape["widths"]) != 1:
            continue
        if shape["widths"] == [3 * int(F["n_what"])]:
            continue  # the what gates are one sigmoid layer of the MLP model too
        t0 = time.perf_counter()
        args = make_inputs(torch, kernel, shape, gen, torch.device("cuda"))
        need_dx = needs_dx(kernel, shape)
        with torch.inference_mode():
            ms = device_ms(torch, lambda: wrappers[kernel](*args), calls=20, reps=5)
            plain_ms = device_ms(torch, lambda: plains[kernel](*args), calls=20, reps=5)
            lib = library_fn(torch, kernel)
            lib_ms = device_ms(torch, lambda: lib(*args), calls=20, reps=5)
            bargs = make_bwd_inputs(torch, fused, kernel, args, gen)
            bwd_ms = device_ms(torch, lambda: bwd_wrappers[kernel](*bargs, need_dx=need_dx),
                               calls=20, reps=5)
            bwd_plain_ms = device_ms(torch, lambda: bwd_plains[kernel](*bargs), calls=20, reps=5)
            got = flat_grads(kernel, bwd_wrappers[kernel](*bargs, need_dx=need_dx))
            want = flat_grads(kernel, bwd_plains[kernel](*bargs))
        err = max(float(torch.max(torch.abs(a - b))) for a, b in zip(got, want) if a is not None)
        with torch.inference_mode(False):
            lib_b = library_bwd_fn(torch, kernel, args, need_dx, gen)
            bwd_lib_ms = device_ms(torch, lib_b, calls=20, reps=5)
        out = {}
        for label, backward in (("fwd", False), ("bwd", True)):
            nbytes, flops = work(kernel, shape, backward=backward, need_dx=need_dx)
            t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
            out[label] = dict(bound=max(t_bytes, t_ops),
                              by="bytes" if t_bytes >= t_ops else "operations")
        log(phase, t0, shape=jdump(shape), need_dx=need_dx, calls_per_train_step=calls,
            ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{lib_ms:.5f}",
            bound_ms=f"{out['fwd']['bound']:.5f}", bound_by=out["fwd"]["by"],
            bwd_ms=f"{bwd_ms:.5f}", bwd_plain_ms=f"{bwd_plain_ms:.5f}",
            bwd_library_ms=f"{bwd_lib_ms:.5f}", bwd_bound_ms=f"{out['bwd']['bound']:.5f}",
            bwd_bound_by=out["bwd"]["by"], bwd_max_abs_err=f"{err:.3e}", card=repr(card))


def conv_phases(torch, card, device):
    """conv-setup, conv-kernels, conv-eval, conv-train, conv-train-check,
    conv-profile, conv-experiment and conv-rollout (see the module's
    docstring)."""
    from sqair_tpu_torch.configs import conv_mnist_model
    from sqair_tpu_torch.data import (DeviceDatasetSampler, create_seq_dataset,
                                      make_template_bank)
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.scripts import experiment as pexp
    from sqair_tpu_torch.scripts import rollout
    from sqair_tpu_torch.training import make_eval_step, make_train_step

    flags = conv_flags()
    B, k, T = int(flags["batch_size"]), int(flags["k_particles"]), 10
    t0 = time.perf_counter()
    data = create_seq_dataset(n_samples=CONV_SEQUENCES, n_timesteps=T, canvas_size=IMG,
                              obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 21,
                              templates=make_template_bank(256, 28, seed=SEED))
    mean_img = data["imgs"].mean((0, 1)) / 255.0
    sampler = DeviceDatasetSampler(data, device)

    def load(run_flags=flags):
        return conv_mnist_model.load(run_flags, IMG, mean_img=mean_img, device=device, seed=SEED)

    model = load()
    ts = model.sequence.timestep
    deterministic = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if deterministic != (True, False, False, False):
        raise Failure(f"conv: the cuDNN settings after loading the conv model are {deterministic}")
    log("conv-setup", t0, sequences=sampler.n, T=T, B=B, k=k, img=jdump(list(IMG)),
        conv_channels=flags["conv_channels"], conv_kernel=flags["conv_kernel"],
        n_hidden=32 * int(flags["n_units"]), n_what=flags["n_what"],
        glimpse=flags["glimpse_size"], input_features=ts._input_encoder.MLP_0.w_0.shape[0],
        glimpse_features=ts._glimpse_encoder.glimpse_encoder.MLP_0.w_0.shape[0],
        params=sum(p.numel() for p in model.sequence.parameters()),
        cudnn_deterministic=True)

    conv_kernel_times(torch, flags, B, k, T, card)

    # ---------------------------------------------------------- conv-eval
    data_gen = torch.Generator(device=device).manual_seed(SEED + 22)
    batches = [sampler.sample(data_gen, B) for _ in range(N_BATCHES)]
    eval_step = make_eval_step(model)
    evals = {}
    for label, switches in (("no_switch", {}), ("both", CELLS_SWITCH)):
        t0 = time.perf_counter()
        with switched(switches):
            replay_gen = torch.Generator(device=device).manual_seed(SEED + 23)
            fused.reset_launches()
            with checked_calls(torch, f"conv-eval ({label})") as calls:
                res = [eval_step(b["imgs"], b["nums"], GeneratorNoise(replay_gen, device))
                       for b in batches]
                torch.cuda.synchronize()
                counts = dict(fused.launches)
        expected = expected_launches(main_path_shapes(flags, B, k, T), N_BATCHES)
        finite(res, f"conv-eval {label} batch")
        if counts != expected:
            raise Failure(f"conv-eval {label}: launch counts {counts} differ from {expected}")
        err, worst_metric = (0.0, None) if label == "no_switch" else max(
            compare_metrics(torch, got, want, f"conv-eval batch {i}, both switches vs none")
            for i, (got, want) in enumerate(zip(res, evals["no_switch"])))
        evals[label] = res
        with switched(switches):
            ms = step_ms(torch, lambda: eval_step(batches[0]["imgs"], batches[0]["nums"],
                                                  GeneratorNoise(replay_gen, device)), STEP_REPS)
        log("conv-eval", t0, setting=label, steps=N_BATCHES, launches=jdump(counts),
            expected=jdump(expected), calls=jdump(calls), vs_switch_off=f"{err:.3e}",
            worst_metric=worst_metric, tol=METRIC_TOL, iwae=f"{float(res[0]['iwae']):.4f}",
            eval_step_ms=f"{ms:.3f}", frames_per_s=f"{B * T / (ms / 1e3):.1f}", card=repr(card))

    # --------------------------------------------------------- conv-train
    trained = {}
    for label, switches in (("no_switch", {}), ("both", CELLS_SWITCH)):
        t0 = time.perf_counter()
        m = load()
        factory, l2 = conv_mnist_model.make_optimizer(flags)
        step = make_train_step(m, factory, l2_weight=l2)
        params = dict(m.sequence.named_parameters())
        before = {n: p.detach().clone() for n, p in params.items()}
        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 24), device)
        with switched(switches):
            fused.reset_launches()
            with checked_calls(torch, f"conv-train ({label})") as calls, \
                    checked_bwd_calls(torch, f"conv-train ({label})") as bwd_calls:
                metrics = [step(b["imgs"], b["nums"], noise) for b in batches]
                torch.cuda.synchronize()
                counts = dict(fused.launches)
        expected = expected_launches(main_path_shapes(flags, B, k, T, train=True),
                                     N_TRAIN_STEPS, backward=True)
        finite(metrics, f"conv-train {label} step")
        if counts != expected:
            raise Failure(f"conv-train {label}: launch counts {counts} differ from {expected}")
        wide = [sh for sh in bwd_calls["fused_mlp_bwd"]["shapes"]
                if json.loads(sh)[1] == ts._input_encoder.MLP_0.w_0.shape[0]
                and json.loads(sh)[-1]]
        if not wide:
            raise Failure(f"conv-train {label}: no MLP backward wrote the input encoder's dx")
        frozen = sorted(n for n, p in params.items() if torch.equal(p.detach(), before[n]))
        if frozen != ["decoder.background_std", "decoder.output_std"]:
            raise Failure(f"conv-train {label}: parameters that did not change: {frozen}")
        err, worst_metric = (0.0, None) if label == "no_switch" else compare_metrics(
            torch, metrics[0], trained["no_switch"][0], "conv-train step 0, both vs none")
        trained[label] = metrics
        log("conv-train", t0, setting=label, steps=N_TRAIN_STEPS, launches=jdump(counts),
            expected=jdump(expected), calls=jdump(calls), bwd_calls=jdump(bwd_calls),
            step0_vs_switch_off=f"{err:.3e}", worst_metric=worst_metric, tol=METRIC_TOL,
            target=f"{float(metrics[-1]['target']):.4f}")

    t0 = time.perf_counter()
    _, l2 = conv_mnist_model.make_optimizer(flags)
    tc = train_check(torch, load(), None, batches[0], flags, flags, l2, device,
                     runs=CONV_TRAIN_RUNS, referees={"off": "referee"}, gates=CONV_GATE,
                     pairs=CONV_PAIRS)
    report_train_check(tc, "conv-train-check", t0, CONV_GATE)

    # ------------------------------------------------------- conv-profile
    # where one eager train step's device time goes: the convolutions
    # (cuDNN), the twelve kernels, the rest (the step's time: conv-experiment)
    t0 = time.perf_counter()
    m = load()
    factory, l2 = conv_mnist_model.make_optimizer(flags)
    step = make_train_step(m, factory, l2_weight=l2)
    noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 25), device)
    b = batches[0]
    step(b["imgs"], b["nums"], noise)
    busy_ms, top, groups = profile_groups(torch, lambda: step(b["imgs"], b["nums"], noise))
    log("conv-profile", t0,
        device_busy_ms="not-measured" if busy_ms is None else f"{busy_ms:.3f}",
        by_group=jdump({g: f"{v:.3f} ms ({v / busy_ms:.3f})" for g, v in groups.items()}
                       if busy_ms else {}), top=jdump(top), card=repr(card))

    # ---------------------------------------------------- conv-experiment
    runners = step_runners(torch, load, sampler, B, T, device)
    graph_gate(torch, runners, flags, "conv-experiment", steps=GATE_STEPS)
    time_settings(torch, runners, (("conv_no_switch", flags, {}),), B, k, T, IMG, card,
                  "conv-experiment")
    root = tempfile.mkdtemp(prefix="sqair_conv_experiment_")
    try:
        t0 = time.perf_counter()
        argv = ["--model_config=sqair_tpu/configs/conv_mnist_model.py",
                "--data_config=sqair_tpu/configs/synth_seq_mnist_data.py", "--seq_len=10",
                "--stage_itr=0", "--eval_on_train=false", f"--synth_valid_samples={CLI_VALID}",
                f"--train_itr={CHAIN_STEPS}", f"--save_itr={CHAIN_STEPS}",
                f"--report_loss_every={CHAIN_STEPS}", f"--log_itr={CHAIN_STEPS}",
                f"--fig_itr={CHAIN_STEPS}", "--on_device_data",
                f"--steps_per_call={CHAIN_STEPS}", f"--results_dir={root}",
                "--run_name=conv", "--device=cuda"]
        fused.reset_launches()
        logdir, _, state, _ = run_cli(pexp, pflags, argv)
        counts = dict(fused.launches)
        check_cli_run(logdir, state.step, "conv-experiment")
        ev = 2 * (CLI_VALID // B)
        expected = collections.Counter(expected_launches(main_path_shapes(flags, B, k, T), ev))
        expected.update(expected_launches(main_path_shapes(flags, B, k, T, train=True),
                                          1 + CHAIN_STEPS, backward=True))
        log("conv-experiment", t0, cli="on_device", steps=state.step, launches=jdump(counts),
            expected=jdump(dict(expected)))
        if counts != dict(expected):
            raise Failure(f"conv-experiment: the CLI launched {counts}, not {dict(expected)}")
    finally:
        shutil.rmtree(root)

    # ------------------------------------------ conv-eval-cli, conv-rollout
    # a checkpoint of the conv model swept by scripts/eval.py and rolled out
    # by scripts/rollout.py, both building the model from its flags.json
    from sqair_tpu_torch.scripts import eval as port_eval
    from sqair_tpu_torch.training.checkpoint import save_checkpoint

    cond = ROLLOUT["condition_frames"]
    run_root = tempfile.mkdtemp(prefix="sqair_conv_run_")
    try:
        t0 = time.perf_counter()
        run_dir = os.path.join(run_root, "1")
        save_checkpoint(run_dir, 7, model.sequence)
        with open(os.path.join(run_dir, "flags.json"), "w") as f:
            json.dump(dict(flags, data_config="sqair_tpu/configs/synth_seq_mnist_data.py",
                           synth_valid_samples=B, synth_train_samples=B), f)
        npz = os.path.join(run_root, "valid.npz")
        np.savez(npz, imgs=data["imgs"][:, :CLI_SEQUENCES], nums=data["nums"][:, :CLI_SEQUENCES])
        fused.reset_launches()
        done = port_eval.main(["--checkpoint_dir", run_dir, "--data_npz", npz,
                               "--eval_batch_size", str(B)])
        torch.cuda.synchronize()
        counts = dict(fused.launches)
        expected = expected_launches(main_path_shapes(flags, B, k, T), CLI_SEQUENCES // B)
        with open(os.path.join(run_dir, "logpx_valid.txt")) as f:
            logpx = f.read().split()
        log("conv-eval-cli", t0, evaluated=done, launches=jdump(counts),
            expected=jdump(expected), logpx=logpx)
        if done != [7] or counts != expected or not math.isfinite(float(logpx[-1])):
            raise Failure(f"conv-eval-cli: evaluated {done}, launched {counts}, logpx {logpx}")

        t0 = time.perf_counter()
        captured = {}
        real_generate = rollout.generate

        def generate(m, obs, noise):
            captured.update(model=m, obs=obs)
            return real_generate(m, obs, noise)

        noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED), device,
                               record=True)
        out_dir = os.path.join(run_root, "rollout")
        pflags.reset()
        try:
            with mock.patch.object(rollout, "generate", generate):
                fused.reset_launches()
                with checked_calls(torch, "conv-rollout") as calls:
                    result = rollout.main(
                        [f"--checkpoint_dir={run_dir}", f"--out_dir={out_dir}", "--device=cuda",
                         f"--n_examples={B}", f"--rollout_len={CONV_ROLLOUT_LEN}",
                         f"--condition_frames={cond}"], noise=noise)
                    torch.cuda.synchronize()
                    counts = dict(fused.launches)
        finally:
            pflags.reset()
        out, gm, obs = result["outputs"], captured["model"], captured["obs"]
        gen_flags = dict(flags, sample_from_prior=True, generate_after=cond - 1)
        expected = expected_launches(main_path_shapes(gen_flags, B, k, CONV_ROLLOUT_LEN,
                                                      generate=True), 1)
        if counts != expected:
            raise Failure(f"conv-rollout: launch counts {counts} differ from {expected}")
        for key, v in out.items():
            if not bool(torch.isfinite(v).all()):
                raise Failure(f"conv-rollout: {key} is not finite")
        if float(out["disc_pres"][cond:].abs().max()) != 0.0:
            raise Failure("conv-rollout: discovery's presence is not 0 in a generated frame")
        walls = walls_ms(torch, lambda: rollout.generate(gm, obs, ReplayNoise(
            noise.table, device)), ROLLOUT_REPEATS)
        ms = statistics.median(walls)
        log("conv-rollout", t0, examples=B, frames=CONV_ROLLOUT_LEN, conditioned=cond,
            launches=jdump(counts), expected=jdump(expected), calls=jdump(calls),
            canvas=jdump(list(out["canvas"].shape)), wall_ms=f"{ms:.3f}",
            frames_per_s=f"{B * CONV_ROLLOUT_LEN / (ms / 1e3):.1f}", card=repr(card))
    finally:
        shutil.rmtree(run_root)


def options_phases(torch, card, device):
    """options-eval, options-train, options-optimizers and options-coverage
    (see the module's docstring)."""
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.data import DeviceDatasetSampler, create_seq_dataset, make_template_bank
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise
    from sqair_tpu_torch.scripts import experiment as pexp
    from sqair_tpu_torch.training import make_eval_step, make_train_step

    release = json.loads(RELEASE_FLAGS.read_text())
    B, k, T = int(release["batch_size"]), int(release["k_particles"]), 10
    data = create_seq_dataset(n_samples=CONV_SEQUENCES, n_timesteps=T, canvas_size=IMG,
                              obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 31,
                              templates=make_template_bank(256, 28, seed=SEED))
    sampler = DeviceDatasetSampler(data, device)
    mean_img = data["imgs"].mean((0, 1)) / 255.0

    def load(run_flags):
        return mlp_mnist_model.load(run_flags, IMG, mean_img=mean_img, device=device, seed=SEED)

    data_gen = torch.Generator(device=device).manual_seed(SEED + 32)
    batches = [sampler.sample(data_gen, B) for _ in range(N_BATCHES)]
    for name, options in OPTION_MODELS:
        run_flags = dict(release, **options)
        for label, switches in (("no_switch", {}), ("both", CELLS_SWITCH)):
            t0 = time.perf_counter()
            model = load(run_flags)
            eval_step = make_eval_step(model)
            factory, l2 = mlp_mnist_model.make_optimizer(run_flags)
            step = make_train_step(model, factory, l2_weight=l2)
            noise = GeneratorNoise(torch.Generator(device=device).manual_seed(SEED + 33), device)
            with switched(switches):
                fused.reset_launches()
                with checked_calls(torch, f"options-eval ({name}, {label})") as calls:
                    res = [eval_step(b["imgs"], b["nums"], noise) for b in batches]
                    torch.cuda.synchronize()
                eval_counts = dict(fused.launches)
                fused.reset_launches()
                with checked_bwd_calls(torch, f"options-train ({name}, {label})") as bwd:
                    metrics = [step(b["imgs"], b["nums"], noise) for b in batches]
                    torch.cuda.synchronize()
                train_counts = dict(fused.launches)
            sw = dict(fuse_glimpse=bool(switches), fuse_cells=bool(switches))
            want_eval = expected_launches(main_path_shapes(run_flags, B, k, T, **sw), N_BATCHES)
            want_train = expected_launches(main_path_shapes(run_flags, B, k, T, train=True, **sw),
                                           N_TRAIN_STEPS, backward=True)
            finite(res, f"options-eval {name} {label} batch")
            finite(metrics, f"options-train {name} {label} step")
            if eval_counts != want_eval or train_counts != want_train:
                raise Failure(f"options {name} {label}: launch counts {eval_counts} / "
                              f"{train_counts} differ from {want_eval} / {want_train}")
            log("options", t0, model=name, setting=label, steps=N_BATCHES,
                eval_launches=jdump(eval_counts), train_launches=jdump(train_counts),
                calls=jdump(calls), bwd_calls=jdump(bwd),
                iwae=f"{float(res[0]['iwae']):.4f}",
                target=f"{float(metrics[-1]['target']):.4f}", card=repr(card))

    # 3 graphed steps of each optimizer against as many eager steps
    runners = step_runners(torch, load, sampler, B, T, device)
    for opt in ("adam", "sgd", "momentum"):
        graph_gate(torch, runners, dict(release, opt=opt), f"options-optimizers ({opt})",
                   steps=OPTION_CHAIN_STEPS)

    # the coverage signal through the CLI, at DISC_FLAGS with both switches
    root = tempfile.mkdtemp(prefix="sqair_coverage_")
    try:
        t0 = time.perf_counter()
        n = COVERAGE_CLI_STEPS
        argv = [f"--{k_}={v}" for k_, v in release.items()
                if k_ not in CLI_SET and not k_.startswith("font_")
                and k_ != "synth_valid_samples"] + [
            "--data_config=sqair_tpu/configs/synth_seq_mnist_data.py", "--seq_len=10",
            "--stage_itr=0", "--eval_on_train=false", f"--synth_valid_samples={CLI_VALID}",
            "--early_disc_logit_scale=1.0", "--disc_coverage_signal", "--coverage_lr_mult=10",
            f"--train_itr={n}", f"--save_itr={n}", f"--report_loss_every={n}",
            f"--log_itr={n}", f"--fig_itr={n}", "--on_device_data", f"--steps_per_call={n}",
            f"--results_dir={root}", "--run_name=coverage", "--device=cuda"]
        cov_flags = dict(release, early_disc_logit_scale=1.0, disc_coverage_signal=True)
        with switched(CELLS_SWITCH):
            fused.reset_launches()
            logdir, model, state, _ = run_cli(pexp, pflags, argv)
            counts = dict(fused.launches)
        records = cli_records(logdir)
        beats = [r for r in records if r["step"] == n and "target" in r]
        if state.step != n or not beats or not all(math.isfinite(r["target"]) for r in beats):
            raise Failure(f"options-coverage: the CLI ended at {state.step} with {beats}")
        ev = 2 * (CLI_VALID // B)
        sw = dict(fuse_glimpse=True, fuse_cells=True)
        expected = collections.Counter(expected_launches(
            main_path_shapes(cov_flags, B, k, T, **sw), ev))
        expected.update(expected_launches(main_path_shapes(cov_flags, B, k, T, train=True, **sw),
                                          1 + n, backward=True))
        rows = model.sequence.timestep.discover.cell.steps_predictor.MLP_0.w_0
        scaled = [p for p in state.optimizer.row_scales]
        log("options-coverage", t0, steps=state.step, launches=jdump(counts),
            expected=jdump(dict(expected)), steps_predictor_rows=rows.shape[0],
            scaled_parameters=len(scaled), target=f"{beats[-1]['target']:.4f}",
            card=repr(card))
        if counts != dict(expected) or counts.get("fused_disc") or counts.get("fused_disc_bwd"):
            raise Failure(f"options-coverage: the CLI launched {counts}, not {dict(expected)}")
        if len(scaled) != 1 or scaled[0] is not rows:
            raise Failure("options-coverage: the coverage rows' update is not scaled")
    finally:
        shutil.rmtree(root)


# ------------------------------------------------- data parallelism, the tools
DP_STEPS = 3
DP_SETTINGS = (("no_switch", {}), ("both", CELLS_SWITCH))
DP_WORLD = 2
DP_TIMEOUT = 900


def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def param_digest(module):
    """SHA-256 of a module's parameters' bytes, in state_dict order."""
    import hashlib

    h = hashlib.sha256()
    for v in module.state_dict().values():
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_batches(torch, B, T):
    """DP_STEPS global batches (imgs [T, B, 50, 50], nums [T, B, 3]) of the
    stroke-digit data, as CPU tensors."""
    from sqair_tpu_torch.data import create_seq_dataset, make_template_bank

    data = create_seq_dataset(n_samples=DP_STEPS * B, n_timesteps=T, canvas_size=IMG,
                              obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 41,
                              templates=make_template_bank(256, 28, seed=SEED))
    imgs = torch.from_numpy(data["imgs"].astype("float32") / 255.0)
    nums = torch.from_numpy(data["nums"].astype("float32").repeat(T, 0))
    return [(imgs[:, i * B:(i + 1) * B].contiguous(), nums[:, i * B:(i + 1) * B].contiguous())
            for i in range(DP_STEPS)]


def same_bits(torch, got, want, what):
    """(bit-identical, the largest |a - b| / (|b| + 1)) of two dicts of tensors."""
    if sorted(got) != sorted(want):
        raise Failure(f"{what}: keys {sorted(got)} differ from {sorted(want)}")
    same = all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)
    dist = max((float(torch.max(torch.abs(got[k].cpu().double() - want[k].cpu().double())
                                / (torch.abs(want[k].cpu().double()) + 1.0)))
                for k in want if want[k].numel()), default=0.0)
    return same, dist


def dp_nccl1_phase(torch, flags, B, k, T, batches, card, device):
    """dp-nccl1 (see the module's docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.ops import fused
    from sqair_tpu_torch.ops.noise import GeneratorNoise, ReplayNoise
    from sqair_tpu_torch.parallel import distributed
    from sqair_tpu_torch.parallel.mesh import (make_mesh, make_parallel_eval_step,
                                               make_parallel_train_step)
    from sqair_tpu_torch.training import make_eval_step, make_train_step

    t0 = time.perf_counter()
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = make_mesh()
        models = [mlp_model_load(flags, IMG, device) for _ in range(2)]
        factory, l2 = mlp_mnist_model.make_optimizer(flags)
        par = make_parallel_train_step(models[0], factory, mesh, l2)
        one = make_train_step(models[1], factory, l2)
        gen = torch.Generator(device=device).manual_seed(SEED + 42)
        counts, steps = collections.Counter(), []
        for obs, nums in batches:
            obs, nums = obs.to(device), nums.to(device)
            noise = GeneratorNoise(gen, device, record=True)
            fused.reset_launches()
            m_par = par(obs, nums, noise)
            torch.cuda.synchronize()
            counts.update(fused.launches)
            m_one = one(obs, nums, ReplayNoise(noise.table, device))
            same_m, d_m = same_bits(torch, m_par, m_one, "dp-nccl1 metrics")
            same_p, d_p = same_bits(torch, models[0].sequence.state_dict(),
                                    models[1].sequence.state_dict(), "dp-nccl1 parameters")
            steps.append(dict(metrics=same_m, params=same_p, d_metrics=f"{d_m:.3e}",
                              d_params=f"{d_p:.3e}", target=f"{float(m_par['target']):.4f}"))
        noise = GeneratorNoise(gen, device, record=True)
        e_par = make_parallel_eval_step(models[0], mesh)(obs, nums, noise)
        e_one = make_eval_step(models[1])(obs, nums, ReplayNoise(noise.table, device))
        same_e, d_e = same_bits(torch, e_par, e_one, "dp-nccl1 eval")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            par(obs, nums, GeneratorNoise(gen, device))
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the collectives the process group ran (the profiler's nccl:* records)
        reduces = {e.key: e.count for e in events
                   if e.device_type == DeviceType.CPU and e.key.startswith("nccl:")}
        # NCCL's kernels on the device, if any (one rank's in-place SUM has none)
        nccl = {e.key[:80]: round(e.self_device_time_total / 1e3, 4) for e in events
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and ("nccl" in e.key.lower() or "onerank" in e.key.lower())}
        backend, nccl_version = mesh.backend, torch.cuda.nccl.version()
    finally:
        distributed.shutdown()
    expected = expected_launches(main_path_shapes(flags, B, k, T, train=True), DP_STEPS,
                                 backward=True)
    log("dp-nccl1", t0, backend=backend, world=1, B=B, k=k, T=T, steps=jdump(steps),
        eval_bit_identical=same_e, eval_distance=f"{d_e:.3e}", launches=jdump(dict(counts)),
        expected=jdump(expected), nccl_records=jdump(reduces), nccl_device_ms=jdump(nccl),
        nccl=jdump(nccl_version),
        card=repr(card))
    if backend != "nccl":
        raise Failure(f"dp-nccl1: the process group's backend is {backend}, not nccl")
    if not all(s["metrics"] and s["params"] for s in steps) or not same_e:
        raise Failure("dp-nccl1: the one-process parallel steps differ from the one-shard "
                      f"steps: {steps}, eval distance {d_e:.3g}")
    if dict(counts) != expected:
        raise Failure(f"dp-nccl1: launch counts {dict(counts)} differ from {expected}")
    if not reduces.get("nccl:all_reduce"):
        raise Failure(f"dp-nccl1: the profiled parallel step ran no NCCL all-reduce: {reduces}")


def dp_worker(spec_path, rank):
    """One rank of dp-two-ranks (``chip_smoke.py --dp-worker SPEC RANK``):
    joins the gloo process group, runs DP_STEPS parallel train steps of its
    rows of each global batch in each of DP_SETTINGS, every kernel call held
    to its plain version, and writes its noise, metrics, parameter digests,
    parameters and launch counts to SPEC's out path."""
    import torch

    sys.path.insert(0, str(REPO))
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.ops import build, fused, stn
    from sqair_tpu_torch.ops.noise import GeneratorNoise
    from sqair_tpu_torch.parallel import distributed
    from sqair_tpu_torch.parallel.mesh import make_mesh, make_parallel_train_step

    stn.full_fp32_matmul()
    spec = torch.load(spec_path, weights_only=False)
    device = torch.device("cuda")
    build.library()
    # two ranks on one card: gloo, named (NCCL refuses a second rank on a device)
    distributed.initialize(spec["address"], DP_WORLD, rank, backend="gloo", device="cuda",
                           timeout_s=DP_TIMEOUT)
    out = {}
    try:
        mesh = make_mesh()
        for label, switches in DP_SETTINGS:
            with switched(switches):
                model = mlp_model_load(spec["flags"], IMG, device)
                factory, l2 = mlp_mnist_model.make_optimizer(spec["flags"])
                step = make_parallel_train_step(model, factory, mesh, l2)
                gen = torch.Generator(device=device).manual_seed(
                    distributed.rank_seed(SEED + 43, rank))
                res = dict(tables=[], metrics=[], digests=[])
                fused.reset_launches()
                what = f"dp-two-ranks ({label}) rank {rank}"
                with checked_calls(torch, what) as calls, \
                        checked_bwd_calls(torch, what, frames=True) as bwd:
                    for obs, nums in spec["batches"]:
                        noise = GeneratorNoise(gen, device, record=True)
                        m = step(obs.to(device), nums.to(device), noise)
                        res["metrics"].append({key: v.cpu() for key, v in m.items()})
                        res["tables"].append({key: v.cpu() for key, v in noise.table.items()})
                        res["digests"].append(param_digest(model.sequence))
                    torch.cuda.synchronize()
                res.update(counts=dict(fused.launches), calls=calls, bwd=bwd,
                           params={n: v.cpu() for n, v in model.sequence.state_dict().items()})
            out[label] = res
    finally:
        distributed.shutdown()
    torch.save(out, f"{spec['out']}.{rank}")
    return 0


def dp_two_ranks_phase(torch, flags, B, k, T, batches, card, device):
    """dp-two-ranks (see the module's docstring)."""
    from sqair_tpu_torch.configs import mlp_mnist_model
    from sqair_tpu_torch.models import Model
    from sqair_tpu_torch.ops.noise import ReplayNoise

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="sqair_dp_")
    try:
        spec = os.path.join(root, "spec.pt")
        torch.save(dict(flags=flags, batches=batches, address=f"127.0.0.1:{free_port()}",
                        out=os.path.join(root, "out.pt")), spec)
        logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(DP_WORLD)]
        procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--dp-worker",
                                   spec, str(r)], cwd=REPO, stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
        try:
            rcs = [p.wait(timeout=DP_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if rcs != [0] * DP_WORLD:
            tails = [open(os.path.join(root, f"rank{r}.log")).read()[-3000:]
                     for r in range(DP_WORLD)]
            raise Failure(f"dp-two-ranks: the workers exited with {rcs}:\n" + "\n".join(tails))
        ranks = [torch.load(os.path.join(root, f"out.pt.{r}"), weights_only=False)
                 for r in range(DP_WORLD)]
    finally:
        shutil.rmtree(root)
    log("dp-two-ranks", t0, workers=DP_WORLD, backend="gloo", card=repr(card))

    rows = B // DP_WORLD
    for label, switches in DP_SETTINGS:
        t0 = time.perf_counter()
        got = [r[label] for r in ranks]
        agree = [got[0]["digests"][i] == got[1]["digests"][i] for i in range(DP_STEPS)]
        sw = dict(fuse_glimpse=bool(switches), fuse_cells=bool(switches))
        expected = expected_launches(main_path_shapes(flags, rows, k, T, train=True, **sw),
                                     DP_STEPS, backward=True)
        # the two-shard oracle in this process, on the ranks' noise
        with switched(switches):
            model = mlp_model_load(flags, IMG, device)
            factory, l2 = mlp_mnist_model.make_optimizer(flags)
            params = list(model.sequence.parameters())
            opt = factory(params)
            dists = []
            for i, (obs, nums) in enumerate(batches):
                grads, metrics = [], []
                for s in range(DP_WORLD):
                    sl = slice(s * rows, (s + 1) * rows)
                    model.sequence.zero_grad(set_to_none=True)
                    target, aux = model.loss_and_metrics(
                        obs[:, sl].to(device), ReplayNoise(got[s]["tables"][i], device),
                        nums[:, sl].to(device), l2_weight=l2, record_mode="train")
                    target.backward()
                    grads.append([p.grad for p in params])
                    metrics.append({key: v.detach() for key, v in aux["metrics"].items()})
                for p, g0, g1 in zip(params, *grads):
                    p.grad = None if g0 is None else (g0 + g1) / 2
                opt.step()
                want = Model.finalize_metrics({key: (metrics[0][key] + metrics[1][key]) / 2
                                               for key in metrics[0]})
                same_m, d_m = same_bits(torch, got[0]["metrics"][i], want,
                                        f"dp-two-ranks {label} metrics")
                dists.append(dict(metrics=same_m, d_metrics=f"{d_m:.3e}"))
            same_p, d_p = same_bits(torch, got[0]["params"], model.sequence.state_dict(),
                                    f"dp-two-ranks {label} parameters")
        log("dp-two-ranks", t0, setting=label, B=B, rows_a_rank=rows * k, k=k, T=T,
            steps=DP_STEPS, digests_agree=jdump(agree), launches=jdump(got[0]["counts"]),
            launches_rank1=jdump(got[1]["counts"]), expected=jdump(expected),
            calls=jdump(got[0]["calls"]), bwd_calls=jdump(got[0]["bwd"]),
            calls_rank1=jdump(got[1]["calls"]), oracle_metrics=jdump(dists),
            params_bit_identical=same_p, params_distance=f"{d_p:.3e}",
            target=f"{float(got[0]['metrics'][-1]['target']):.4f}", card=repr(card))
        if not all(agree):
            raise Failure(f"dp-two-ranks {label}: the ranks' parameters part: {agree}")
        # every kernel call, forward and backward, held to its plain version
        for r, g in enumerate(got):
            held = {kn: st["calls"] for kn, st in {**g["calls"], **g["bwd"]}.items()}
            if g["counts"] != expected or held != expected:
                raise Failure(f"dp-two-ranks {label}: rank {r} launched {g['counts']} and held "
                              f"{held} calls, not {expected}")
        if not same_p or not all(d["metrics"] for d in dists):
            # a sum of two gradients is the same in either order and halving
            # is exact: any distance is a kernel or a reduction that is not
            # deterministic
            raise Failure(f"dp-two-ranks {label}: the ranks' step differs from the two-shard "
                          f"oracle: parameters {d_p:.3g}, metrics {dists}")


def dp_cli_phase(torch, card, root):
    """dp-cli (see the module's docstring); returns the coordinated run's dir."""
    from sqair_tpu_torch.experiment import flags as pflags
    from sqair_tpu_torch.scripts import experiment as pexp

    t0 = time.perf_counter()
    release = json.loads(RELEASE_FLAGS.read_text())
    coordinator = [f"--coordinator_address=127.0.0.1:{free_port()}", "--num_processes=1",
                   "--process_id=0"]
    runs = {name: run_cli(pexp, pflags, cli_argv(release, root, name, 1) + extra)
            for name, extra in (("alone", []), ("coordinated", coordinator))}
    records = {name: cli_records(r[0]) for name, r in runs.items()}
    d_records = records_distance(records["coordinated"], records["alone"])
    d_params = params_distance(torch, runs["coordinated"][1].sequence,
                               runs["alone"][1].sequence)
    joined = "multi-process: process 0/1" in runs["coordinated"][3]
    steps = {name: r[2].step for name, r in runs.items()}
    log("dp-cli", t0, backend="nccl", steps=jdump(steps), joined_process_group=joined,
        records=len(records["coordinated"]), records_distance=f"{d_records:.3e}",
        params_distance=f"{d_params:.3e}", card=repr(card))
    if steps != {"alone": CLI_STEPS, "coordinated": CLI_STEPS} or not joined:
        raise Failure(f"dp-cli: the runs ended at {steps} (process group joined: {joined})")
    if d_records or d_params:
        raise Failure(f"dp-cli: the coordinated run differs from the run alone: records "
                      f"{d_records:.3g}, parameters {d_params:.3g}")
    return runs["coordinated"][0]


def quiet(fn, *args):
    """``fn(*args)`` from a clean flag registry, its output kept aside:
    (result, output)."""
    import io

    from sqair_tpu_torch.experiment import flags as pflags

    saved = sys.argv
    pflags.reset()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = fn(*args)
    finally:
        sys.argv = saved
        pflags.reset()
    return result, out.getvalue()


NATIVE_CHECK = """
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
from sqair_tpu_torch.data import make_template_bank, native
gen = native.generate_sequences(make_template_bank(16, 12, seed=0), 64, 6, canvas_size=(30, 30),
                                n_objects=(0, 2), seed=7)
print(json.dumps(dict(path="native" if native.native_available() else "numpy",
                      imgs_sha256=hashlib.sha256(gen["imgs"].tobytes()).hexdigest()[:16],
                      shape=list(gen["imgs"].shape))))
"""


def tools_phase(torch, card, device, run_dir):
    """tools (see the module's docstring): ``run_dir`` is dp-cli's run."""
    from sqair_tpu_torch.data import create_seq_dataset, make_template_bank
    from sqair_tpu_torch.scripts import eval as port_eval

    for sub in ("tools", "notebooks"):
        if str(REPO / sub) not in sys.path:
            sys.path.insert(0, str(REPO / sub))
    import diag_presence_logits_torch
    import eval_one_ckpt_torch
    import play_torch
    import profile_step_torch
    import promote_release_torch
    import time_step_torch

    root = tempfile.mkdtemp(prefix="sqair_tools_")
    try:
        t0 = time.perf_counter()
        ts, _ = quiet(time_step_torch.main, ["--steps", "4", "--trials", "1",
                                             "--chain", str(CHAIN_STEPS)])
        log("tools", t0, tool="time_step_torch", eager_ms_a_step=f"{ts['eager'][0]:.3f}",
            graph_n10_ms_a_step=f"{ts['graph'][0]:.3f}", warm_target=f"{ts['warm_target']:.4f}",
            card=repr(card))
        t0 = time.perf_counter()
        trace = os.path.join(root, "trace")
        ps, _ = quiet(profile_step_torch.main, ["--iters", "1", "--warmup", "1",
                                                "--trace", trace])
        if not os.path.exists(os.path.join(trace, "trace.json")):
            raise Failure("tools: profile_step_torch wrote no trace")
        log("tools", t0, tool="profile_step_torch",
            ms=jdump({key: f"{v:.3f}" for key, v in ps.items()}), card=repr(card))

        # the release checkpoint, 2 batches (the font train set cut: only
        # mean_img reads it, and the checkpoint holds its own)
        cut = json.dumps({"font_train_samples": 64})
        t0 = time.perf_counter()
        ev, _ = quiet(eval_one_ckpt_torch.main, [str(PORT_RELEASE), "1000000", "2", cut])
        finite([{key: torch.as_tensor(v) for key, v in ev.items()}], "tools: eval_one_ckpt")
        log("tools", t0, tool="eval_one_ckpt_torch", batches=2, iwae=f"{ev['iwae']:.4f}",
            num_step_accuracy=f"{ev['num_step_accuracy']:.4f}",
            acc_per_t=jdump([round(float(x), 4) for x in ev["num_step_acc_per_t"]]),
            card=repr(card))
        t0 = time.perf_counter()
        diag, _ = quiet(diag_presence_logits_torch.main, [str(PORT_RELEASE), "1000000", cut])
        log("tools", t0, tool="diag_presence_logits_torch",
            kept=jdump({t: r["kept"] for t, r in diag.items()}),
            median_on_count=jdump({t: round(float(np.median(r["on_count"])), 3)
                                   for t, r in diag.items() if r["on_count"].size}),
            card=repr(card))

        # dp-cli's run promoted, and the promoted checkpoint swept
        t0 = time.perf_counter()
        out = os.path.join(root, "release", "1")
        path, _ = quiet(promote_release_torch.main, ["--run_dir", run_dir, "--out", out])
        data = create_seq_dataset(n_samples=CLI_SEQUENCES, n_timesteps=10, canvas_size=IMG,
                                  obj_size=(28, 28), n_objects=(0, 2), seed=SEED + 7,
                                  templates=make_template_bank(256, 28, seed=SEED))
        npz = os.path.join(root, "valid.npz")
        np.savez(npz, imgs=data["imgs"], nums=data["nums"])
        done, _ = quiet(port_eval.main, ["--checkpoint_dir", out, "--data_npz", npz])
        with open(os.path.join(out, "logpx_valid.txt")) as f:
            logpx = f.read().split()
        log("tools", t0, tool="promote_release_torch", promoted=os.path.basename(path),
            swept=jdump(done), logpx=logpx[-1] if logpx else "none", card=repr(card))
        if done != [CLI_STEPS]:
            raise Failure(f"tools: the promoted checkpoint's sweep evaluated {done}")

        t0 = time.perf_counter()
        (metrics, figs), printed = quiet(play_torch.main, [
            "--quick_train", "--results_dir", os.path.join(root, "play"),
            "--fig_dir", os.path.join(root, "figs"), "--eval_batches", "2"])
        skipped = "figures skipped: matplotlib is not installed" in printed
        finite([{key: torch.as_tensor(v) for key, v in metrics.items()}], "tools: play_torch")
        log("tools", t0, tool="play_torch", quick_train=True, iwae=f"{metrics['iwae']:.4f}",
            figures=len(figs), figures_skipped=skipped, card=repr(card))
        if not (figs or skipped):
            raise Failure("tools: play_torch drew no figures and did not say it skipped them")

        # the native binding in a process of its own, as a user's would
        # run it: native where the library runs on this host, else numpy
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", NATIVE_CHECK, str(REPO)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise Failure(f"tools: the native binding's process exited with "
                          f"{out.returncode}: {out.stderr[-1000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        log("tools", t0, tool="native_datagen", **{k: jdump(v) for k, v in res.items()})
    finally:
        shutil.rmtree(root)


def dp_phases(torch, card, device):
    """dp-nccl1, dp-two-ranks, dp-cli and tools (see the module's docstring)."""
    flags = json.loads(RELEASE_FLAGS.read_text())
    B, k, T = int(flags["batch_size"]), int(flags["k_particles"]), 10
    batches = dp_batches(torch, B, T)
    dp_nccl1_phase(torch, flags, B, k, T, batches, card, device)
    dp_two_ranks_phase(torch, flags, B, k, T, batches, card, device)
    root = tempfile.mkdtemp(prefix="sqair_dp_cli_")
    try:
        run_dir = dp_cli_phase(torch, card, root)
        tools_phase(torch, card, device, run_dir)
    finally:
        shutil.rmtree(root)


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--dp-worker"]:
            sys.exit(dp_worker(sys.argv[2], int(sys.argv[3])))
        sys.exit(run())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)

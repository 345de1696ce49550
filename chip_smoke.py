#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``taming_event_flow_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--profile DIR]

1. Prints the card (``nvidia-smi`` name and power limit), sets both TF32
   flags off, builds the CUDA kernels from
   ``taming_event_flow_tpu_torch/csrc``.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   with its time by CUDA events, on the device (the profiler's time of all
   the call runs there; CUDA-event time, with a line that says so, where
   the profiler's traces keep coming back without it) and on the host (issuing the call), the plain
   version's, a library yardstick's and its memory bound:
   the splat and the gather at the DSEC eval path's shapes, the fused
   dual-stencil gather at the training path's (the splat backward, C=4, at
   10 and 5 windows, and the gather backward, C=2, at 10 and 2 windows;
   both at 10 windows with a training step's shares of zero-valued rows),
   bitwise against its plain version there and at C = 1..4 with
   misaligned pointers, and the autograd Functions' location gradients
   running the fused kernel alone (no stack after it). The splat also on a
   clustered input (events on a few hundred edges, a generator of its
   own), each input beside the splat of its real rows alone (no zero rows
   at (0, 0)); the splat and the gather at C = 1..4 with aligned and
   misaligned pointers.
3. Eval phase: the DSEC eval protocol (``configs/eval_dsec.yml``: 480x640,
   P=10, 65,536-event bucket, FWL/RSAT/AEE, Iterative warping, bf16
   forward, flow_bw store) through ``EvalPipeline`` with a full-width
   RecEVFlowNet (seeded weights) on synthetic event windows; the launch
   counters must show the splat and the gather ran (and the backward kernel
   did not). Then one window in float32 on the card and on the CPU (plain
   versions), whose metrics must agree.
4. Row-gather phase: the row gather kernel against its plain version
   (bitwise) at the study's four shapes (``tools/bench_dma_gather.py``:
   307,200 x W rows, W = 8 and 128, 655,360 scattered and contiguous
   indices), at the rectified remap's (a DSEC window's P*H*W = 3,072,000
   rows of W = 2, a 1-based index with a zeroed border), at the u32 wire's
   coordinate lookup (a window's 655,360 raw pixels in the 307,200 x 2
   forward map) and at W = 1, an unaligned W = 3 and a W = 4 table at a
   4-byte offset (the scalar path), timed beside ``torch.index_select``
   and its bytes bound.
5. Rectified DSEC phase: the eval protocol of step 3 on a synthetic
   rectified sequence (raw integer events, a radial forward map giving the
   list's fractional coordinates through ``data.rectify_events``, a
   backward mapping turned into ``remap_idx`` by ``data.remap_index`` with
   a zeroed border). Three windows derive the count input on the card from
   the raw coordinates and ``EvalPipeline.cur_ridx`` (the row gather must
   launch on each), three more ship the host-built input; on one window
   the derived input and event mask must equal the host-built ones
   bitwise, and float32 metrics card against CPU must agree. Then
   ``compute_pol_iwe`` on that window's flow under both rounding settings,
   card against CPU.
6. Training phase: the training configuration (``configs/train_flow.yml``
   at the batch ``bench.py`` measures: 128x128, P=10, B=8, 8,192 events per
   pass and lane, Iterative loss, Adam after clip 100) through
   ``make_train_step`` for one warm-up and five steps (the first captures
   the step's CUDA graph, the rest are timed); losses must be
   finite and change, every parameter must get a finite non-zero gradient,
   and the launch counters must show 124 splats, 80 gathers and 116 fused
   gathers per step. One more step counts the fused gathers' zero-valued
   rows and their bytes bound; the profiled step (``--profile``) prints the
   fused gathers' and the stack/cat kernels' launches and device time.
   Then float32 on the card
   against the CPU at B=1 (:func:`card_vs_cpu`): the step's loss, the loss's
   flow gradient on identical flows and the model's parameter gradients
   for one flow cotangent must agree. Printed beside them: the card's
   float32 model gradients against float64 under each float32 setting of
   :func:`precision_settings` (IEEE by the torch 2.9+ precision API,
   deterministic cuDNN, cuDNN off, TF32 on), the same for one convolution
   and one upsampling alone (:func:`precision_ops_probe`), and the gaps
   over the first 1 and 3 passes.
7. Training CLI phase: ``train_flow_torch.train`` on the card with
   ``configs/train_flow.yml``'s values (``TRAIN_CLI_CONFIG``, no PyYAML
   needed) over two synthetic sequences of 8,192 events per 10 ms pass:
   two epochs, then a warm start from that run for one more. Through
   ``.h5`` files and the port's ``H5Loader`` where h5py imports, else a
   subclass serving the same arrays from memory (:func:`memory_loader`).
   The losses must be finite and change, the warm start must restore the
   model and replay the history, the checkpoint must load on the card with
   its Adam step count equal to the steps taken, and the launch counters
   must show 124 splats, 80 gathers and 116 fused gathers per step. Prints
   ms per step, the loop's ``SectionTimer`` report and the loader's host
   ms per loss window.
8. Eval CLI phase: ``eval_flow_torch.test`` on the card, evaluating the run
   step 7 wrote, its loader served from memory where h5py is missing.
   (a) ``configs/eval_dsec.yml``'s values (``EVAL_DSEC_CLI``) over a
   rectified and an unrectified synthetic sequence of 480x640 with 10 Hz
   GT flow: ``metrics_0.yml`` holds a finite entry per sequence and
   metric, each sequence's ``flow_bw/`` one 16-bit PNG per evaluated
   window, every window launches the eval phase's splats and gathers, the
   row gather twice on the rectified sequence (the u32 wire's coordinate
   lookup and the count remap) and never on the other (``cur_ridx`` and
   ``cur_rect`` come from the loader through ``batch_stream``),
   and no fused gather; ``prepare_dsec_submission.prepare`` on the tree
   writes one ``%06d.png`` per flag. (b) One short rectified sequence in
   float32 (TF32 off) through the CLI on the card and on the CPU: two row
   gathers per window on the card, metrics within
   the pipeline-parity tolerance, ``flow_bw`` within one u16 lattice step
   on at least 99.9% of pixels. (c) ``configs/eval_mvsec.yml``'s values
   (P = 1, masked and cropped AEE, ``mask_output``) with every panel
   stored: ``events``, ``flow``, ``iwe``, ``flow_bw``, ``flow_gt`` and
   ``error_flow`` hold a PNG per pass, and every pass splats and gathers.
   Prints ms per GT window of CLI wall and the CLI's ``SectionTimer``
   reports beside the card.
9. Registry phase: the variants of the model and loss registries at full
   width. (a) ``make_train_step`` with the Linear loss at the training
   phase's configuration (B = 8, 1 + 3 steps): finite, changing losses,
   ``LINEAR_LAUNCHES`` per step; at B = 1 the step loss and the loss's
   flow gradient on identical flows, card against CPU. (b) The DSEC
   protocol with ``metrics.warping: Linear`` over unrectified and
   rectified synthetic windows: finite FWL/RSAT/AEE,
   ``LINEAR_WINDOW_LAUNCHES`` per window (and one row gather on a
   rectified one); one window of each in float32, card against CPU. (c)
   EVFlowNet, RecFireFlowNet and FireFlowNet at their default widths:
   float32 flows at 480x640 card against CPU within ``FAMILY_FLOW_TOL``,
   then each through ``train_flow_torch.train`` (one epoch at
   ``TRAIN_CLI_CONFIG``'s values, the Iterative loss's launches per step
   scaled by the flow scales) and ``eval_flow_torch.test`` (the DSEC
   values over two one-window sequences: finite metrics, ``flow_bw`` PNGs,
   the eval phase's launches per window, a recurrent carry reset at the
   rollover). (d) ``data.voxel: 4`` through both CLIs with RecEVFlowNet:
   a 4-channel model, no count input derived, finite losses and metrics;
   ``events_to_voxel`` on the card against the host's grid.
10. Multi-device phase (``parallel/``, on ``torch.distributed``): ranks
   in children started with ``spawn`` (CUDA forbids ``fork``), held to
   one-process runs on the card (:func:`parallel_references`). (a) NCCL
   over a world of one: the event-parallel step at the training cell
   (B = 8), whose all-reduced gradients must be bitwise the local ones,
   against ``make_train_step`` within the training-agreement tolerances.
   (b) Event axis 2 and (c) data axis 2 on two gloo ranks that share
   ``cuda:0``: the loss and its flow gradient on identical flows (handed
   to every rank), the full step's loss, parameters bitwise equal on both
   ranks after 2 steps, 124 / 80 / 116 launches a step, each on half the
   one-process launch's events (b) or lanes (c). (d) The event-sharded
   DSEC eval on those ranks, 3 unrectified and 3 rectified windows: FWL,
   RSAT, AEE against one process, 2 splats and 10 gathers a window and a
   row gather a rectified one. (e) ``train_flow_torch.train`` with
   ``parallel: {event: 2}`` and ``{data: 2}`` for one epoch (epoch loss
   within 1e-5 of one rank's) and ``eval_flow_torch.test`` on the DSEC
   values (metrics within the CLI row, equal ``flow_bw`` file lists, rank
   0 alone writing). (f) (b)-(d) over NCCL with one card a rank where the
   machine has two, else a line that says it was skipped. Times from ranks
   that share one card are not a scaling figure.
11. Options and wires phase: the registry options and the wire formats.
   (a) ``norm: IN`` RecEVFlowNet flows at 480x640 in float32, card against
   CPU (``FAMILY_FLOW_TOL``), and ``compute_dtype: bfloat16`` flows
   against the float32 model of the same seed (``BF16_FLOW_TOL``; flows,
   carry and parameters float32); then each through the training cell (B
   = 8, 1 + ``OPT_STEPS`` steps): finite, changing losses, every gradient
   (a conv bias before an instance norm may be zero), 124 / 80 / 116
   launches a step. (b) ``batched_sweep``: loss and flow gradient against
   the looped sweep on identical flows (the training-agreement
   tolerances), then through the training cell with its launches a step
   (``BATCHED_LAUNCHES``), ms/step and peak memory beside the default's
   (JAX's ``triangular_warp: false`` and ``warp_remat`` have no field in
   the port, which builds the default's table). (c) The DSEC cell,
   unrectified and rectified, on the plain, packed and u32 wires:
   FWL/RSAT/AEE across wires within the kernel tolerance (bitwise or not,
   printed), launches a window (2 row gathers on a rectified u32 one),
   bytes uploaded a window. (e) The staging ring: a 30-window rectified
   sequence on the u32 wire, its metrics and u16 ``flow_bw`` copied to
   the host by a reader thread and one pass overflowing the bucket, staged
   through the ring and by blocking uploads: ``flow_bw`` and
   FWL/RSAT/AEE bitwise, launches equal (kept out of the phase's
   totals), ``h2d_async_bytes`` equal to ``h2d_bytes``, slot waits
   counted. (d) ``train_flow_torch.train`` with
   ``runtime.packed_wire`` on and off: the first two step losses within
   ``WIRE_STEP_RTOL``, bytes uploaded a step.
12. JAX run phase: a run as the JAX package's trainer leaves it, at full
   width. (a) ``checkpoint.msgpack`` written by a msgpack writer kept here
   (:func:`flax_to_bytes`, the subset ``flax.serialization.to_bytes``
   writes; a CPU test holds its bytes to flax's): the seeded model after 3
   port steps through ``models.state_dict_to_flax_params``, the optax
   state of Adam after the clip with those steps' moments and count 3,
   ``step`` 3 and ``epoch`` 1, the training CLI's config as run params and
   a two-epoch loss history. (b) ``train_flow_torch.train --prev_runid``
   that run at the training CLI's values for two epochs: the parameters
   and both Adam moments as loaded bitwise what was written, Adam's step 3
   on every parameter, the history replayed and epochs 1 and 2 trained,
   finite losses, 124 / 80 / 116 launches a step. (c)
   ``eval_flow_torch.test`` on the run at ``configs/eval_dsec.yml``'s
   values over a rectified and an unrectified sequence: the model holds
   the written weights, the metrics, the PNG tree, the eval phase's
   launches a window and two row gathers a rectified one. (d)
   ``examples/streaming_inference_torch.py``'s ``stream()`` from the run at
   480x640, 32,768 events a slice, 100 timed passes on each wire (p50 and
   p99 ms/pass printed); the u16 map bitwise the lattice decode of its
   pass's float32 map. (e) 3 streaming passes under
   ``utils.profile_trace``: the trace holds the ``stream_pass`` ranges and
   the card's kernel rows.
13. Transposed-conv phase: ``use_upsample_conv: false`` (the JAX
   package's stride-2 SAME transposed-conv decoders) in the full-width
   RecEVFlowNet. (a) The training cell (B = 8, 1 + ``OPT_STEPS`` steps)
   beside the default model: finite, changing losses, every gradient,
   124 / 80 / 116 launches a step, ms/step of both; then card against CPU
   at B = 1 (:func:`card_vs_cpu` without its probes). (b) The DSEC cell
   (bf16, 3 windows): finite metrics, 2 splats and 10 gathers a window,
   ms/pass in turns with the default model; one window in float32 card
   against CPU. (c) ``train_flow_torch.train`` for one epoch and
   ``eval_flow_torch.test`` over two GT windows with the flag: the run's
   decoders are ``transposed_conv2d``, the launches exact. (d) A JAX
   ``checkpoint.msgpack`` of the model (``ConvTranspose_0`` leaves and
   Adam moments, :func:`flax_to_bytes`) warm-started: parameters and
   moments bitwise. (e) The decoders' device ms in a bf16 window and a
   training step, replayed alone, against the default's upsample and
   conv, beside the whole window's and step's device time.
14. Determinism phase: one seed gives one run on the card. (a) The splat
   kernel twice on identical inputs at the DSEC shape (M = 655,360, C = 4,
   480x640, rounded and fractional), the training shape (B = 8, C = 4,
   128x128) and the ``d_maps`` shape (C = 2): every bit equal, within the
   kernel tolerance of its plain version and within its fixed-point error
   bound of a float64 sum of the same products; 65,536 points on one
   pixel with random-sign values over 1e-6 to 1e3, bitwise equal over 20
   calls and within the bound of the exact sum; NaN and +-Inf values where
   the plain version puts them; each lane of a batched call bitwise the
   lane alone and padded. (b) The training cell from one seed for 1 + 5
   steps, and with ``use_upsample_conv: false``, ``norm: IN``,
   ``compute_dtype: bfloat16`` and the Linear loss for 1 + 2 steps, in
   this process and in a child: every step's loss, every parameter, Adam's
   moments and the carry bitwise equal. (c) One training step (default
   and transposed-conv decoders) in a child process under
   ``torch.use_deterministic_algorithms(True)`` with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: it must run to its end, so no op
   that torch flags is left on the path (``torch.histc`` must raise
   there; a step with ``F.interpolate``'s backward is printed, which
   torch 2.11 does not flag). (d) The
   training CLI at step 7's values (one epoch) twice: every step's loss
   and the epoch loss bitwise equal. (e) ``EvalPipeline`` on 3 DSEC windows
   twice, unrectified and rectified: FWL, RSAT, AEE and ``flow_bw`` bitwise
   equal. The launches of (b), (d) and (e) must be exact. (f) The
   gather-form upsample's backward twice at a decoder's shape, bitwise
   equal. (g) The default and
   transposed-decoder training cells of (b) twice more, in a child
   process once no other uses the card: on the free card (bitwise (b)'s
   run), then beside a filler tensor that leaves free only what that run
   grew the child's allocator pool by plus 256 MiB: every bit of losses,
   parameters, Adam moments and carry equal, both digests printed.
15. Bench phase: ``python3 bench_torch.py`` (the port of ``bench.py``) in a
   child process at ``bench.py``'s sizes: both gates ``ok``, every time
   finite and positive, ``mfu`` and ``bandwidth_util`` in (0, 1.05], the
   headline equal to the printed ``warps_per_step`` over
   ``train_step_ms``, this card's peaks, each section's launches exact;
   its JSON line printed.
16. Graph phase: the training step as the port runs it on the card (a
   CUDA graph of the unpack, the passes, the loss and the backward from a
   window shape's second step on), against the same steps run eagerly,
   for the Iterative and the Linear loss: ten steps of the training
   window's shape, then three rounds of three shapes in turn (half and a
   quarter of its events, each captured once, and the first); every loss,
   parameter and the carry bitwise equal (or the widest gaps printed, the
   loss's within the training cell's limit), launches exact a step, the
   counters at three captures and the steps replayed; one more replayed
   step's warp kernels counted by name in CUPTI's records against the
   capture's launches (which each replay adds to the counters); ms a
   step and peak memory of both. Then the DSEC eval window step as a CUDA
   graph, for the full-width RecEVFlowNet and E-RAFT (bf16, rectified, the
   u32 wire with the card's lookup): five windows graphed (the second
   captured while the eval CLI's ``MetricsConsumer`` thread copies the
   first's metrics to the host) against the same windows run by
   ``window.eager``: FWL, RSAT, AEE, ``flow_bw``, flows, carry and slot
   state bitwise equal, launches exact a window (a replay adds the
   capture's), the capture with the garbage collector off; ms a window of
   both.
17. E-RAFT phase: the correlation lookup of ``models/eraft.py`` on the
   kernels at the shapes it runs them in: at DSEC's 480x640 (4,800 lanes
   of 81 taps over the 60x80 to 7x10 levels, centres on, near and far off
   the grid) the gather bitwise its plain version at every level and
   through ``lookup``; at the training shape (128x128, B = 2) the map
   gradient (the splat, through the autograd Function) within
   KERNEL_RTOL of its plain version; the launches of a bf16 eval pass
   (48 gathers) and of a training forward and backward of two passes
   (96 gathers, 96 splats) exact; the lookup's time and bound.
18. Prints the ``kernels`` JSON line and, last, ``{"ok": true, ...}``.
   A line after the card's first print gives the version of h5py, PyYAML,
   cv2 and tensorboard there (``null`` where one does not import).

Any failure raises, and the script exits non-zero without the last line.
It imports nothing of JAX or the JAX package.
"""

import argparse
import contextlib
import copy
import hashlib
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RES = (480, 640)
PASSES = 10
N_PAD = 65536
SPLAT_M = PASSES * N_PAD  # RSAT/FWL splat over the window's event slots
GATHER_M = PASSES * N_PAD + RES[0] * RES[1]  # last pass: events + grid
METRIC_RTOL, METRIC_ATOL = 2e-3, 2e-4  # the JAX suite's pipeline parity
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
N_WINDOWS = 3  # the first one warms cuDNN up and is not timed
CLUSTER_SEGMENTS = 300  # edges of the clustered splat input
DEVICE = "cuda"

# training slice: configs/train_flow.yml at bench.py's bench_train batch
TRAIN_RES = (128, 128)
TRAIN_B = 8
TRAIN_N = 8192  # events per pass and lane
TRAIN_STEPS = 5  # after one warm-up step
# a training run's steps before those timed: the eager warm-up and the step
# that captures the CUDA graph
UNTIMED = 2
# kernel launches per training step (10 passes, Iterative loss "two")
TRAIN_LAUNCHES = {"splat_bilinear": 124, "gather_bilinear": 80,
                  "gather_fused": 116, "row_gather": 0}
FUSED_M = PASSES * TRAIN_N  # the IWE splat at tref 5 holds all ten windows
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, float32
TRAIN_GRAD_TOL = 1e-3  # max abs error per tensor, x that tensor's max |g|
JITTER = 1e-6  # relative move of weights or flows for the CPU's own gap
GAP_PASSES = (1, 3)  # f32 model-gradient gaps over the first passes too
KINK_JITTER = 1e-7  # relative move of the weights for f64's own gradient gap
# f32 model gradients on the card with f64's ReLU masks against f64, global
# relative L2 (the CPU's f32 sits at 2.53e-7 with its own masks)
KINK_GRAD_TOL = 1e-5
# rectified slice: a mild radial distortion and a border of out-of-source
# pixels, as cv2's remap leaves around a rectified DSEC frame
RECT_K = 0.05
RECT_BORDER = 4
TIMING_ROUNDS = 3  # more timed passes over the eval windows (per route)
TRAIN_LOSS = {"res": TRAIN_RES, "passes_loss": PASSES, "scales_loss": 1,
              "iterative_mode": "two", "round_ts": False}
TRAIN_OPT = {"name": "Adam", "lr": 1e-5}
TRAIN_CLIP = 100.0
FLOW_SCALING = 32.0

# configs/eval_dsec.yml, with the training config's loss keys
# (configs/train_flow.yml) that the eval CLI merges in
DSEC_CONFIG = {
    "data": {"mode": "gtflow", "window": 0.1, "passes_loss": PASSES,
             "voxel": None},
    "loader": {"resolution": list(RES), "augment": [],
               "n_events_pad": N_PAD},
    "loss": {"flow_scaling": 32, "round_ts": False},
    "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"],
                "inference_dtype": "bfloat16"},
    "vis": {"enabled": False, "store": True, "bars": True,
            "mask_output": False, "dynamic": True, "show": ["flow_bw"]},
}
MODEL_CONFIG = {"name": "RecEVFlowNet", "final_w_scale": 0.01}

# training CLI: configs/train_flow.yml's values (data.path and loader.seed
# are set at run time; n_epochs is the phase's, not the yml's 500)
TRAIN_CLI_CONFIG = {
    "experiment": "Default",
    "data": {"mode": "time", "window": 0.01, "passes_loss": PASSES,
             "scales_loss": 1, "voxel": None, "cache": False},
    "model": MODEL_CONFIG,
    "loss": {"warping": "Iterative", "iterative_mode": "two",
             "round_ts": False, "flow_scaling": 32,
             "flow_spat_smooth_weight": None,
             "flow_temp_smooth_weight": None, "clip_grad": TRAIN_CLIP},
    "optimizer": TRAIN_OPT,
    "loader": {"batch_size": 1, "resolution": list(TRAIN_RES),
               "augment": ["Horizontal", "Vertical", "Polarity"],
               "augment_prob": [0.5, 0.5, 0.5],
               "max_num_grad_events": 10000, "n_events_pad": None},
    "vis": {"verbose": True, "enabled": False, "store": False, "px": 400},
}
CLI_SEQUENCES = 2
CLI_DURATION = 0.25  # s: 24 passes of 10 ms, 2 loss windows a sequence
CLI_EVENTS = TRAIN_N * 25  # 8,192 events per 10 ms pass
CLI_EPOCHS = 2  # then a warm start for one more
CLI_TIMED_WINDOWS = 3  # loss windows of the loader timed alone

# eval CLI: configs/eval_dsec.yml's values (data.path is set at run time)
EVAL_DSEC_CLI = {
    "data": {"mode": "gtflow", "window": 0.1, "passes_loss": PASSES,
             "cache": False},
    "loader": {"resolution": list(RES), "augment": [],
               "max_num_grad_events": None, "n_events_pad": N_PAD,
               "seed": None},
    "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"],
                "inference_dtype": "bfloat16"},
    "vis": {"enabled": False, "px": 400, "bars": True, "store": True,
            "mask_output": False, "dynamic": True, "show": ["flow_bw"]},
}
# configs/eval_mvsec.yml's values; eval_time spans the synthetic sequence,
# and every panel renders and stores with no display
MVSEC_RES = (260, 346)
EVAL_MVSEC_CLI = {
    "data": {"mode": "gtflow", "window": 1, "passes_loss": 1,
             "cache": False},
    "loader": {"resolution": list(MVSEC_RES), "augment": [],
               "max_num_grad_events": None, "n_events_pad": 16384,
               "seed": None},
    "metrics": {"warping": "Iterative", "name": ["FWL", "RSAT", "AEE"],
                "eval_time": [0.0, 1000.0], "mask_aee": True,
                "res_aee": [256, 256], "vertical_crop_aee": 190},
    "vis": {"enabled": False, "px": 400, "bars": True, "store": True,
            "mask_output": True, "dynamic": False, "show": None},
}
MVSEC_PANELS = ("events", "flow", "iwe", "flow_bw", "flow_gt", "error_flow")
GT_WINDOW = 0.1  # s: DSEC's GT flow rate, 10 Hz
EVAL_CLI_EVENTS = 40_000 * PASSES  # per GT window: ~40k events a pass
# GT windows evaluated per sequence. A sequence of n GT frames gives n - 2
# at P = 10: the first frame has no window before it, and the last frame's
# tenth pass lands past it by rounding (row 2.9 + 0.1 > 3), so the loader
# rolls over and the partial window is dropped, as in the JAX loader.
EVAL_CLI_WINDOWS = 3
PARITY_WINDOWS = 2  # card against CPU
MVSEC_PASSES = 5  # P = 1, window 1: n GT frames give n - 1 passes
MVSEC_GT_WINDOW = 0.022  # s: MVSEC outdoor_day GT at ~45 Hz
MVSEC_EVENTS = 10_000  # per GT window (~0.45 Mev/s)
PNG_SHARE = 0.999  # flow_bw pixels within one lattice step, card vs CPU

# registry phase: the Linear loss and validation, the model families, voxel
# input. Kernel launches per Linear training step (RecEVFlowNet: 4 flow
# scales, scales_loss 1): per scale one gather of every event's arrival
# flow and two 4-channel IWE splats (forward, backward); in the backward a
# fused gather per IWE splat and the arrival gather's d_maps splat
LINEAR_LAUNCHES = {"splat_bilinear": 12, "gather_bilinear": 4,
                   "gather_fused": 8, "row_gather": 0}
LINEAR_STEPS = 3  # after one warm-up step
# per Linear DSEC window: one gather per pass (each event's arrival flow),
# RSAT/FWL's two splats and one splat of the P - 1 older maps pushed to the
# latest pass (the AEE flow); a rectified window adds its row gather
LINEAR_WINDOW_LAUNCHES = {"splat_bilinear": 3, "gather_bilinear": PASSES,
                          "gather_fused": 0}
LINEAR_WINDOWS = 3  # the first one warms up
# the families at their default widths (models/model.py, models/fire.py)
FAMILIES = {
    "EVFlowNet": {"name": "EVFlowNet", "base_channels": 64,
                  "num_encoders": 4, "num_residual_blocks": 2,
                  "final_w_scale": 0.01},
    "RecFireFlowNet": {"name": "RecFireFlowNet", "base_channels": 32,
                       "final_w_scale": 0.01},
    "FireFlowNet": {"name": "FireFlowNet", "base_channels": 32,
                    "final_w_scale": 0.01},
}
FAMILY_PASSES = 2  # card against CPU, float32 at 480x640
FAMILY_FLOW_TOL = 1e-4  # max abs error / max |flow|
VOXEL_BINS = 4  # data.voxel, the value tests/test_e2e.py sets


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def time_ms(fn, reps=50, warmup=5):
    """Mean time per call of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after warm-up; inputs stay L2-warm between calls): the device's
    time, or the host's launch time where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel=None):
    """Device time per call of ``fn`` from a profiler trace, all its
    kernels or those whose name holds ``kernel``, or CUDA-event time where
    five traces show none (``tools/bench_dma_gather.py:device_ms``)."""
    from taming_event_flow_tpu_torch.tools import bench_dma_gather

    return bench_dma_gather.device_ms(fn, kernel=kernel)


def host_us(fn, reps=50):
    """Host time per call of ``fn`` in microseconds: the time to issue
    ``reps`` back-to-back calls without waiting for the device (for a
    kernel wrapper: its checks, output allocation and launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes, nops):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def n_taps(loc, h, w, skip_integer):
    """In-frame taps the kernels work on for ``loc [M, 2]``; the splat
    (``skip_integer``) has one tap per axis at an integer coordinate."""
    import torch

    y, x = loc[..., 0], loc[..., 1]
    y0, x0 = torch.floor(y), torch.floor(x)
    every = torch.ones_like(y, dtype=torch.bool)
    second_y = (y != y0) if skip_integer else every
    second_x = (x != x0) if skip_integer else every
    total = 0
    for ty, has_y in ((y0, every), (y0 + 1, second_y)):
        ok_y = has_y & (ty >= 0) & (ty <= h - 1)
        for tx, has_x in ((x0, every), (x0 + 1, second_x)):
            total += int((ok_y & has_x & (tx >= 0) & (tx <= w - 1)).sum())
    return total


def window_points(rng, n_slots):
    """``n_slots`` event slots of ``N_PAD`` rows as the eval path holds
    them: ~40k real events per slot at fractional locations (some out of
    frame, a quarter exactly integer), then zero padding rows at (0, 0).
    Returns ``(loc [n_slots * N_PAD, 2] float32, real [n_slots * N_PAD])``.
    """
    h, w = RES
    loc = np.zeros((n_slots, N_PAD, 2), np.float32)
    real = np.zeros((n_slots, N_PAD), np.float32)
    for s in range(n_slots):
        n = int(N_PAD * rng.uniform(0.58, 0.64))  # 38k-42k of 65,536
        pts = np.stack([rng.uniform(-2, h + 1, n), rng.uniform(-2, w + 1, n)],
                       -1)
        pts[: n // 4] = np.round(pts[: n // 4])
        loc[s, :n] = pts
        real[s, :n] = 1.0
    return loc.reshape(-1, 2), real.reshape(-1)


# -------------------------------------------------------------- kernel phase


def clustered_points(rng, n_slots):
    """``window_points``' slot layout with the real events drawn within
    +-1 px of ``CLUSTER_SEGMENTS`` random line segments (10-120 px long,
    the same in every slot), as edges fill a real recording; the rest zero
    padding rows at (0, 0). Returns ``(loc, real)`` like ``window_points``.
    """
    h, w = RES
    a = np.stack([rng.uniform(0, h, CLUSTER_SEGMENTS),
                  rng.uniform(0, w, CLUSTER_SEGMENTS)], -1)
    d = rng.normal(size=(CLUSTER_SEGMENTS, 2))
    d *= (rng.uniform(10, 120, CLUSTER_SEGMENTS)
          / np.linalg.norm(d, axis=-1))[:, None]
    loc = np.zeros((n_slots, N_PAD, 2), np.float32)
    real = np.zeros((n_slots, N_PAD), np.float32)
    for s in range(n_slots):
        n = int(N_PAD * rng.uniform(0.58, 0.64))
        seg = rng.integers(0, CLUSTER_SEGMENTS, n)
        t = rng.uniform(0, 1, (n, 1))
        loc[s, :n] = a[seg] + t * d[seg] + rng.uniform(-1, 1, (n, 2))
        real[s, :n] = 1.0
    return loc.reshape(-1, 2), real.reshape(-1)


def splat_inputs(rng, loc, real):
    """The splat's values as RSAT's splat holds them, (pos, neg, pos*ts,
    neg*ts) per event and zero on the padding rows; ``(loc [1, M, 2],
    values [1, M, 4], real [M] bool)`` on the card."""
    import torch

    m = loc.shape[0]
    p = rng.choice([-1.0, 1.0], m)
    ts = rng.uniform(0, PASSES, m)
    vals = np.stack([p > 0, p < 0, (p > 0) * ts, (p < 0) * ts],
                    -1).astype(np.float32) * real[:, None]
    return (torch.from_numpy(loc)[None].to(DEVICE),
            torch.from_numpy(vals)[None].to(DEVICE),
            torch.from_numpy(real > 0).to(DEVICE))


def check_splat(name, loc, values, counts_exact):
    """The splat kernel against its plain version: within the kernel
    tolerance, and the count planes bitwise where ``counts_exact`` (integer
    locations: sums of 0/1 values, exact in any order)."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    out_k = cuda_warp.splat_bilinear(loc, values, RES)
    out_p = cuda_warp.splat_bilinear_plain(loc, values, RES)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(torch.allclose(out_k, out_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
          f"splat kernel disagrees with its plain version ({name}): "
          f"max abs err {err}")
    if counts_exact:
        check(torch.equal(out_k[..., :2], out_p[..., :2]),
              f"splat count planes not exact ({name})")
    print(f"splat {name}: max_abs_err {err:.3e} "
          f"(max |out| {float(out_p.abs().max()):.3f})")
    return err


def splat_times(loc, values):
    """``(event ms, device ms of splat_kernel alone)`` on these inputs (the
    call's zero fill, maximum and finish pass, the same for every input of
    one shape, left out)."""
    from taming_event_flow_tpu_torch.ops import cuda_warp

    call = lambda: cuda_warp.splat_bilinear(loc, values, RES)  # noqa: E731
    return time_ms(call), device_ms(call, "splat_kernel")


def check_widths(rng):
    """Splat and gather at C = 1..4 on small inputs, with pointers aligned
    (the vector instances for C = 2 and 4) and one float off (the scalar
    instances), against their plain versions."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    h, w, m = 37, 53, 5000
    for c in (1, 2, 3, 4):
        for off in (0, 1):
            def arr(shape, scale, low=0.0):
                n = int(np.prod(shape))
                buf = torch.from_numpy((rng.uniform(low, scale, n + off))
                                       .astype(np.float32)).to(DEVICE)
                return buf[off:].view(shape)

            loc = arr((2, m, 2), 1.0)
            loc.mul_(torch.tensor([h + 3.0, w + 3.0], device=DEVICE)).sub_(2)
            loc[:, : m // 3] = torch.round(loc[:, : m // 3])
            vals = arr((2, m, c), 1.0, -1.0)
            vals[:, -m // 4:] = 0.0
            maps = arr((2, h, w, c), 1.0, -1.0)
            got = cuda_warp.splat_bilinear(loc, vals, (h, w))
            ref = cuda_warp.splat_bilinear_plain(loc, vals, (h, w))
            g_got = cuda_warp.gather_bilinear(maps, loc)
            g_ref = cuda_warp.gather_bilinear_plain(maps, loc)
            torch.cuda.synchronize()
            check(torch.allclose(got, ref, rtol=KERNEL_RTOL,
                                 atol=KERNEL_ATOL),
                  f"splat C={c}, offset {4 * off} B: "
                  f"{float((got - ref).abs().max())}")
            check(torch.equal(g_got, g_ref),
                  f"gather C={c}, offset {4 * off} B: not bitwise")
    print("splat and gather at C = 1..4, aligned and 4 bytes off: agree "
          "with their plain versions (gather bitwise)")


def kernel_phase(rng, rng_cluster):
    import torch
    import torch.nn.functional as F

    from taming_event_flow_tpu_torch.ops import cuda_warp

    dev = torch.device(DEVICE)
    h, w = RES
    results = {}

    # splat inputs: the window's P event slots as the main path holds them
    # (window_points), with (pos, neg, pos*ts, neg*ts) per event like
    # RSAT's splat and zero values on the padding rows
    loc_f, values, real = splat_inputs(rng, *window_points(rng, PASSES))
    check(loc_f.shape[1] == SPLAT_M, "splat shape")
    loc_r = torch.round(loc_f)
    splat_err = max(check_splat("rounded", loc_r, values, True),
                    check_splat("fractional", loc_f, values, False))
    # the same points clustered on edges (a generator of their own)
    c_loc, c_vals, c_real = splat_inputs(
        rng_cluster, *clustered_points(rng_cluster, PASSES))
    c_loc_r = torch.round(c_loc)
    splat_err = max(splat_err,
                    check_splat("clustered rounded", c_loc_r, c_vals, True),
                    check_splat("clustered fractional", c_loc, c_vals, False))
    check_widths(rng_cluster)

    # the main path's splat: rounded locations (RSAT/FWL)
    taps = n_taps(loc_r[0], h, w, skip_integer=True)
    nbytes = (loc_r.numel() + values.numel() + h * w * 4) * 4
    nops = taps * (1 + 2 * 4)  # weight product + C (mul, atomic add)
    b_ms, b_by = bound_ms(nbytes, nops)
    flat_idx, wv = [], []
    for idx, weight in cuda_warp._taps(loc_r, h, w):
        flat_idx.append(idx.reshape(-1))
        wv.append((values * weight[..., None]).reshape(-1, 4))
    flat_idx, wv = torch.cat(flat_idx), torch.cat(wv)

    def lib_splat():
        return torch.zeros(h * w, 4, device=dev).index_put_(
            (flat_idx,), wv, accumulate=True)

    call = lambda: cuda_warp.splat_bilinear(loc_r, values, RES)  # noqa: E731
    ms, kernel_ms = splat_times(loc_r, values)
    results["splat_bilinear"] = {
        "name": "splat_bilinear",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:128",
        "max_abs_err": splat_err,
        "ms": ms,
        # all the call runs on the device: the scratch's zero fill and the
        # three kernels, like the library call's torch.zeros and index_put_
        "device_ms": device_ms(call),
        "kernel_only_device_ms": kernel_ms,
        "host_us": host_us(call),
        "plain_ms": time_ms(
            lambda: cuda_warp.splat_bilinear_plain(loc_r, values, RES),
            reps=10),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib_splat),
        "library_device_ms": device_ms(lib_splat),
        "library_host_us": host_us(lib_splat, reps=10),
    }
    print(f"splat call on the device {results['splat_bilinear']['device_ms']:.5f}"
          f" ms, of which splat_kernel {kernel_ms:.5f} ms")
    # the other inputs, each beside the splat of its real rows alone (the
    # contention-free reference: no zero rows at (0, 0))
    variants = {}
    for name, lc, vl, keep in (
            ("rounded", loc_r, values, real),
            ("fractional", loc_f, values, real),
            ("clustered rounded", c_loc_r, c_vals, c_real),
            ("clustered fractional", c_loc, c_vals, c_real)):
        variants[name] = {
            "all rows": (ms, kernel_ms)
            if name == "rounded" else splat_times(lc, vl),
            "real rows": splat_times(lc[:, keep].contiguous(),
                                     vl[:, keep].contiguous())}
        print(f"splat {name} (event ms, splat_kernel device ms): "
              f"{variants[name]['all rows']} over all {lc.shape[1]} rows, "
              f"{variants[name]['real rows']} over the "
              f"{int(keep.sum())} real rows alone")
    results["splat_bilinear"]["inputs"] = variants

    # gather inputs: a flow map and the last pass's lookup points, P event
    # slots (window_points) followed by the H*W pixel grid
    maps = torch.from_numpy(
        rng.normal(size=(1, h, w, 2)).astype(np.float32) * 4).to(dev)
    grid_pts = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                    indexing="ij"), -1).reshape(-1, 2)
    gl = np.concatenate([window_points(rng, PASSES)[0],
                         grid_pts.astype(np.float32)])
    mg = gl.shape[0]
    check(mg == GATHER_M, "gather shape")
    gloc = torch.from_numpy(gl)[None].to(dev)
    out_k = cuda_warp.gather_bilinear(maps, gloc)
    out_p = cuda_warp.gather_bilinear_plain(maps, gloc)
    torch.cuda.synchronize()
    gerr = float((out_k - out_p).abs().max())
    check(torch.equal(out_k, out_p),
          f"gather kernel is not bitwise its plain version: {gerr}")
    grid = torch.stack([2 * gloc[..., 1] / (w - 1) - 1,
                        2 * gloc[..., 0] / (h - 1) - 1], -1)[:, None]
    maps_nchw = maps.permute(0, 3, 1, 2).contiguous()

    def lib_gather():
        return F.grid_sample(maps_nchw, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib_err = float((lib_gather()[:, :, 0].transpose(1, 2) - out_p)
                    .abs().max())
    print(f"gather: max_abs_err {gerr:.3e}; grid_sample yardstick differs "
          f"by {lib_err:.3e} (coordinate normalisation)")
    taps = n_taps(gloc[0], h, w, skip_integer=False)
    nbytes = (gloc.numel() + maps.numel() + mg * 2) * 4
    b_ms, b_by = bound_ms(nbytes, taps * (1 + 2 * 2))
    call = lambda: cuda_warp.gather_bilinear(maps, gloc)  # noqa: E731
    results["gather_bilinear"] = {
        "name": "gather_bilinear",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:206",
        "max_abs_err": gerr,
        "ms": time_ms(call),
        "device_ms": device_ms(call),
        "host_us": host_us(call),
        "plain_ms": time_ms(
            lambda: cuda_warp.gather_bilinear_plain(maps, gloc), reps=10),
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": time_ms(lib_gather),
        "library_device_ms": device_ms(lib_gather),
        "library_host_us": host_us(lib_gather),
    }
    return results


def fused_points(rng, batch, h, w):
    """``[B, FUSED_M, 2]`` lookup points as the training backward meets
    them: fractional, some out of frame, and the first quarter of each lane
    at exactly integer coordinates (where the dual stencil spans three taps
    per axis)."""
    loc = np.stack([rng.uniform(-2, h + 1, (batch, FUSED_M)),
                    rng.uniform(-2, w + 1, (batch, FUSED_M))],
                   -1).astype(np.float32)
    loc[:, : FUSED_M // 4] = np.round(loc[:, : FUSED_M // 4])
    return loc


def n_dual_taps(loc, h, w):
    """``(taps, y taps)`` the fused kernel reads for ``loc [..., 2]``: per
    axis, the in-frame taps of floor and floor+1, and of floor-1 too at an
    exactly integer coordinate."""
    import torch

    def axis(c, size):
        c0 = torch.floor(c)
        count = torch.zeros_like(c)
        for k in (-1, 0, 1):
            t = c0 + k
            ok = (t >= 0) & (t <= size - 1)
            count += (ok & (c == c0)) if k == -1 else ok
        return count

    ny, nx = axis(loc[..., 0], h), axis(loc[..., 1], w)
    return int((ny * nx).sum()), int(ny.sum())


def bits(t):
    """The float32 tensor's bit patterns (int32): equal only where every
    bit is, the sign of a zero included."""
    import torch

    return t.contiguous().view(torch.int32)


def check_fused_bitwise(tag, maps, loc, vals, with_gv):
    """The fused kernel against its plain version, every bit of gv (where
    asked) and d_loc (dy, dx); returns the max abs error."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    got = cuda_warp.gather_fused_dloc(maps, loc, vals, with_gv=with_gv)
    gv, dy, dx = cuda_warp.gather_fused_plain(maps, loc, vals,
                                              with_gv=with_gv)
    ref = (gv, torch.stack([dy, dx], -1))
    torch.cuda.synchronize()
    pairs = [(a, b) for a, b in zip(got, ref) if b is not None]
    check(got[0] is None if not with_gv else got[0] is not None,
          f"fused gather ({tag}): gv returned where not asked, or not")
    e = max(float((a - b).abs().max()) for a, b in pairs)
    check(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
          f"fused gather is not bitwise its plain version ({tag}, with_gv "
          f"{with_gv}): max abs err {e}")
    return e


def check_fused_widths(rng):
    """The fused gather at C = 1..4 on small inputs with pointers aligned
    (the vector instances for C = 2 and 4) and one float off (the scalar
    instances), integer coordinates on y, on x and on both, zero-valued
    rows at (0, 0), with and without gather values: bitwise."""
    import torch

    h, w, m = 37, 53, 5000
    for c in (1, 2, 3, 4):
        for off in (0, 1):
            def arr(shape, low, high):
                n = int(np.prod(shape))
                buf = torch.from_numpy(rng.uniform(low, high, n + off)
                                       .astype(np.float32)).to(DEVICE)
                return buf[off:].view(shape)

            loc = arr((2, m, 2), 0.0, 1.0)
            loc.mul_(torch.tensor([h + 3.0, w + 3.0], device=DEVICE)).sub_(2)
            loc[:, : m // 4] = torch.round(loc[:, : m // 4])
            loc[:, m // 4: m // 3, 0] = torch.round(loc[:, m // 4: m // 3, 0])
            loc[:, m // 3: m // 2, 1] = torch.round(loc[:, m // 3: m // 2, 1])
            vals = arr((2, m, c), -1.0, 1.0)
            vals[:, -m // 8:] = 0.0
            loc[:, -m // 8:] = 0.0
            maps = arr((2, h, w, c), -1.0, 1.0)
            for with_gv in (True, False):
                check_fused_bitwise(f"C={c}, offset {4 * off} B", maps, loc,
                                    vals, with_gv)
    print("fused gather at C = 1..4, aligned and 4 bytes off, integer "
          "coordinates and zero-valued rows, with and without gather "
          "values: bitwise its plain version")


def check_backward_kernels(maps4, maps2, loc, vals4, cot2):
    """The two Functions' location gradients at the training shapes run
    the fused gather and nothing else on the device: no stack after it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from taming_event_flow_tpu_torch.ops import cuda_warp

    lc = loc.clone().requires_grad_()
    splat = cuda_warp.SplatBilinearFn.apply(lc, vals4, TRAIN_RES)
    gather = cuda_warp.GatherBilinearFn.apply(maps2, lc)
    for tag, out, g in (("SplatBilinearFn", splat, maps4),
                        ("GatherBilinearFn", gather, cot2)):
        # a trace the profiler returns without device rows shows nothing:
        # trace again, up to five times
        names = []
        for _ in range(5):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.autograd.grad(out, lc, g, retain_graph=True)
                torch.cuda.synchronize()
            names = [a.key for a in prof.key_averages()
                     if a.device_type == DeviceType.CUDA
                     and not a.is_user_annotation
                     and a.self_device_time_total]
            if names:
                break
        check(names and all("gather_fused_kernel" in n for n in names),
              f"{tag}.backward runs more than the fused gather: {names}")
        print(f"{tag}.backward (location gradient) on the device: {names}")


def fused_case(tag, maps, loc, vals, plain=False):
    """Hold the fused gather bitwise to its plain version with and
    without gather values, then time it as the training path calls it
    (``gather_fused_dloc`` without gather values): event, device (all the
    call runs there, and the kernel alone) and host time beside its
    bound."""
    from taming_event_flow_tpu_torch.ops import cuda_warp

    b, h, w, c = maps.shape
    n = loc.shape[0] * loc.shape[1]
    e = max(check_fused_bitwise(tag, maps, loc, vals, True),
            check_fused_bitwise(tag, maps, loc, vals, False))
    # without gather values a row whose values are all zero reads no taps
    work = ~(vals == 0).all(-1)
    taps, ytaps = n_dual_taps(loc[work], h, w)
    nbytes = (loc.numel() + vals.numel() + maps.numel() + 2 * n) * 4
    nops = taps * c * 4 + ytaps * c * 6 + n * c * 4
    b_ms, b_by = bound_ms(nbytes, nops)
    call = lambda: cuda_warp.gather_fused_dloc(  # noqa: E731
        maps, loc, vals, with_gv=False)
    case = {"max_abs_err": e, "B": b, "M": loc.shape[1], "C": c,
            "zero_rows": int(n - int(work.sum())),
            "ms": time_ms(call), "device_ms": device_ms(call),
            "kernel_only_device_ms": device_ms(call, "gather_fused_kernel"),
            "host_us": host_us(call), "bound_ms": b_ms, "bound_by": b_by}
    if plain:
        case["plain_ms"] = time_ms(
            lambda: cuda_warp.gather_fused_dloc_plain(maps, loc, vals,
                                                      with_gv=False),
            reps=10)
    return case


def fused_phase(rng, seed):
    """The fused dual-stencil gather at the training path's shapes: the
    splat backward (the C=4 IWE cotangent image, the splat's values) and
    the gather backward (the C=2 flow map, the gather's cotangent), both
    without gather values, as the path calls them, at their largest launch
    (10 windows) beside the library yardstick; then at 5 (C=4) and 2 (C=2,
    the step's smallest launch) windows and at 10 windows with the step's
    shares of zero-valued rows, some at (0, 0) (``tools/
    bench_fused_shapes``' inputs, a generator of their own); every case
    bitwise its plain version, and at C = 1..4 with misaligned pointers;
    the two Functions' location gradients run nothing but the kernel."""
    import torch
    import torch.nn.functional as F

    from taming_event_flow_tpu_torch.ops import cuda_warp
    from taming_event_flow_tpu_torch.tools import bench_fused_shapes as shapes

    dev = torch.device(DEVICE)
    h, w = TRAIN_RES
    loc = torch.from_numpy(fused_points(rng, TRAIN_B, h, w)).to(dev)
    n = loc.shape[0] * loc.shape[1]
    q = FUSED_M // 4  # the integer points; the yardstick skips them
    grid = torch.stack([2 * loc[:, q:, 1] / (w - 1) - 1,
                        2 * loc[:, q:, 0] / (h - 1) - 1], -1)[:, None]
    # grid_sample's coordinate normalisation moves a point by ~1e-5 px: one
    # within that of an integer may land on the other side, where the
    # derivative stencil jumps, so the agreement is read on the others
    frac = loc[:, q:] - torch.floor(loc[:, q:])
    clear = ((frac > 1e-3) & (frac < 1 - 1e-3)).all(-1)
    cases, err, inputs = {}, 0.0, {}
    for tag, c in (("splat_backward", 4), ("gather_backward", 2)):
        maps = torch.from_numpy(rng.normal(size=(TRAIN_B, h, w, c))
                                .astype(np.float32)).to(dev)
        vals = torch.from_numpy(rng.normal(size=(TRAIN_B, FUSED_M, c))
                                .astype(np.float32)).to(dev)
        inputs[c] = (maps, vals)
        ref = cuda_warp.gather_fused_plain(maps, loc, vals)
        cases[tag] = fused_case(tag, maps, loc, vals, plain=True)
        err = max(err, cases[tag].pop("max_abs_err"))

        maps_nchw = maps.permute(0, 3, 1, 2).contiguous()
        g_out = vals[:, q:].permute(0, 2, 1)[:, :, None].contiguous()

        def lib():
            # two calls the port never makes: grid_sample forward (gv) and
            # its grid gradient (the location gradient x (size - 1) / 2)
            out = F.grid_sample(maps_nchw, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            _, d_grid = torch.ops.aten.grid_sampler_2d_backward(
                g_out, maps_nchw, grid, 0, 0, True, [False, True])
            return out, d_grid

        out, d_grid = lib()
        lib_err = max(
            float((out[:, :, 0].transpose(1, 2) - ref[0][:, q:])[clear]
                  .abs().max()),
            float((d_grid[:, 0, :, 0] * (2 / (w - 1)) - ref[2][:, q:])[clear]
                  .abs().max()),
            float((d_grid[:, 0, :, 1] * (2 / (h - 1)) - ref[1][:, q:])[clear]
                  .abs().max()))
        cases[tag].update(library_ms=time_ms(lib),
                          library_device_ms=device_ms(lib),
                          library_host_us=host_us(lib))
        print(f"gather_fused {tag} (B={TRAIN_B}, M={FUSED_M}, C={c}): "
              f"bitwise; {cases[tag]}; grid_sample + "
              f"grid_sampler_2d_backward on the {n - TRAIN_B * q} "
              f"non-integer points ({int(clear.sum())} more than 1e-3 px "
              f"from an integer: differ by {lib_err:.3e})")

    check_backward_kernels(inputs[4][0], inputs[2][0], loc, inputs[4][1],
                           inputs[2][1])
    check_fused_widths(np.random.default_rng([seed, 3]))
    more = {}
    for i, (tag, (c, m, zero)) in enumerate(shapes.CASES.items()):
        if (m == FUSED_M and not zero[0]) or zero[0] == 1.0:
            continue  # the two cases above; the stream alone is the study's
        maps, lc, vals = shapes.fused_inputs([seed, 4, i], c, m, zero)
        more[tag] = fused_case(tag, maps, lc, vals)
        err = max(err, more[tag].pop("max_abs_err"))
        print(f"gather_fused {tag} (B={TRAIN_B}, M={m}, C={c}, "
              f"{more[tag]['zero_rows']} zero-valued rows, "
              f"{int((lc == 0).all(-1).sum())} rows at (0, 0)): "
              f"bitwise; {more[tag]}")

    entry = {
        "name": "gather_fused",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "taming_event_flow_tpu/ops/pallas_warp.py:281",
        "max_abs_err": err,
        **cases["splat_backward"],
        "gather_backward": cases["gather_backward"],
        "shapes": more,
    }
    return {"gather_fused": entry}


def radial_maps():
    """A mild radial distortion at ``RES``: the forward map in the file's
    layout (``[y_raw, x_raw] = (x_rect, y_rect)``) and an approximate
    backward mapping (``[y_rect, x_rect] = (x_raw, y_raw)``), float32."""
    h, w = RES
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cy, cx = (h - 1) / 2, (w - 1) / 2
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (cy ** 2 + cx ** 2)
    fwd = np.stack([cx + (xx - cx) * (1 + RECT_K * r2),
                    cy + (yy - cy) * (1 + RECT_K * r2)], -1)
    bwd = np.stack([cx + (xx - cx) * (1 - RECT_K * r2),
                    cy + (yy - cy) * (1 - RECT_K * r2)], -1)
    return fwd.astype(np.float32), bwd.astype(np.float32)


def rectified_index(bwd):
    """``remap_idx [H, W]`` of the backward mapping (``data.remap_index``)
    with a zeroed border: the out-of-source pixels cv2 leaves."""
    from taming_event_flow_tpu_torch.data import remap_index

    ridx = remap_index(bwd, RES)
    b = RECT_BORDER
    ridx[:b] = ridx[-b:] = 0
    ridx[:, :b] = ridx[:, -b:] = 0
    return ridx


def row_gather_phase(rng):
    """The row gather at the study's shapes (the twin's inputs and
    measurement), at the rectified remap's (the count rows of a DSEC window
    and the index ``derive_count_input`` builds from a remap index) and at
    widths that take the scalar path; bitwise against its plain version."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp
    from taming_event_flow_tpu_torch.tools import bench_dma_gather as study

    dev = torch.device(DEVICE)
    err = 0.0
    studies = {}
    for w in study.STUDY_WIDTHS:
        table, streams = study.study_inputs(study.STUDY_ROWS, w,
                                            study.STUDY_M, device=dev)
        for stream, idx in streams.items():
            r = study.measure(table, idx)
            err = max(err, r.pop("max_abs_err"))
            studies[f"W{w}_{stream}"] = r
            rate = {k: study.STUDY_M / (r[k] * 1e-3) / 1e6
                    for k in ("ms", "library_ms", "plain_ms", "device_ms",
                              "library_device_ms") if r[k] > 0}
            print(f"row_gather study W={w} {stream}: {r}; M rows/s {rate}")
        del table, streams

    # the remap: P lanes of H*W count rows plus one zero row each, gathered
    # by the 1-based index (0 -> the zero row), as derive_count_input does
    h, w = RES
    rows = h * w + 1
    ridx = torch.from_numpy(rectified_index(radial_maps()[1])).to(dev)
    counts = rng.integers(0, 4, (PASSES, rows, 2)).astype(np.float32)
    counts[:, -1] = 0.0
    table = torch.from_numpy(counts.reshape(-1, 2)).to(dev)
    src = torch.where(ridx > 0, ridx - 1, h * w).reshape(1, -1).to(
        torch.int32)
    idx = (src + torch.arange(PASSES, dtype=torch.int32,
                              device=dev)[:, None] * rows).reshape(-1)
    check(idx.shape[0] == PASSES * h * w, "remap shape")
    remap = study.measure(table, idx)
    err = max(err, remap.pop("max_abs_err"))
    remap["host_us"] = host_us(lambda: cuda_warp.row_gather(table, idx))
    remap["library_host_us"] = host_us(
        lambda: torch.index_select(table, 0, idx))
    print(f"row_gather remap (M={idx.shape[0]}, W=2): {remap}")

    # the u32 wire's lookup: a window's P * N_PAD raw pixels (padding rows
    # at pixel 0, as the packed words hold them) in the forward map's
    # H*W rows of (x_rect, y_rect)
    fwd = torch.from_numpy(radial_maps()[0]).to(dev).reshape(h * w, 2)
    # (a generator of its own: the rectified phase's data stay as they were)
    lrng = np.random.default_rng(3)
    pix = lrng.integers(0, h * w, PASSES * N_PAD).astype(np.int32)
    pix[lrng.uniform(size=pix.shape) < 0.4] = 0
    lookup = study.measure(fwd, torch.from_numpy(pix).to(dev))
    err = max(err, lookup.pop("max_abs_err"))
    print(f"row_gather rect lookup (M={pix.shape[0]}, table {h * w} x 2): "
          f"bitwise its plain version; {lookup}")

    # the scalar path: W = 1, an odd W, and a table off 16-byte alignment
    for r_, w_, m_, off in ((100000, 1, 200000, 0), (100000, 3, 200001, 0),
                            (100000, 4, 200000, 1)):
        buf = torch.from_numpy(rng.normal(size=r_ * w_ + off)
                               .astype(np.float32)).to(dev)
        tab = buf[off:].view(r_, w_)
        ix = torch.from_numpy(rng.integers(-3, r_ + 3, m_)
                              .astype(np.int32)).to(dev)
        got = cuda_warp.row_gather(tab, ix)
        ref = cuda_warp.row_gather_plain(tab, ix)
        torch.cuda.synchronize()
        check(torch.equal(got, ref),
              f"row_gather disagrees with its plain version at W={w_}, "
              f"offset {off * 4} B")
        print(f"row_gather W={w_} (table at a {off * 4}-byte offset, some "
              f"indices out of range): bitwise equal")
    entry = {
        "name": "row_gather",
        "route": "cuda",
        "source": "taming_event_flow_tpu_torch/csrc/warp_kernels.cu",
        "replaces": "scripts/bench_dma_gather.py:54",
        "max_abs_err": err,
        **remap,
        "bound_by": "bytes",
        "study": studies,
        "rect_lookup": lookup,
    }
    return {"row_gather": entry}


# --------------------------------------------------------------- slice phase


def synthetic_windows(rng, n_windows):
    """DSEC-shaped GT windows: P passes of ~40k real events each (integer
    pixel coordinates, sorted window-normalised ts, +-1 polarity), plus a
    random GT flow map per window."""
    h, w = RES
    windows = []
    for _ in range(n_windows):
        passes = []
        for _ in range(PASSES):
            n = int(rng.integers(38000, 42000))
            ev = np.zeros((1, n, 4), np.float32)
            ev[0, :, 0] = np.sort(rng.uniform(0, 1, n))
            ev[0, 0, 0] = 0.0
            ev[0, :, 1] = rng.integers(0, h, n)
            ev[0, :, 2] = rng.integers(0, w, n)
            ev[0, :, 3] = rng.choice([-1.0, 1.0], n)
            passes.append({"event_list": ev})
        gt = rng.normal(size=(1, h, w, 2)).astype(np.float32) * 4
        passes[-1]["gtflow"] = gt
        windows.append(passes)
    return windows


def run_windows(pipe, windows, flows=None):
    """Drive the pipeline as the eval loop does; returns per-window host
    metrics and the seconds per window (synchronised). Each window's last
    flow is appended to ``flows`` when given."""
    import torch

    mets, secs = [], []
    for passes in windows:
        t0 = time.perf_counter()
        for b in passes:
            b = pipe.ensure_bucket(b)
            flow = pipe.ingest(b, {"ts": 0.0})
        if flows is not None:
            flows.append(flow)
        check(pipe.passes_done == pipe.passes, "window did not complete")
        m = pipe.boundary_metrics(passes[-1], {"ts": 0.0})
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append(m)
    return mets, secs


def check_metrics(m, tag):
    for k in ("fwl", "rsat", "aee"):
        check(np.isfinite(float(m[k])), f"{tag}: {k} not finite")
    fb = m["flow_bw"]
    check(fb.shape == (1, RES[0], RES[1], 2) and fb.dtype == np.uint16,
          f"{tag}: flow_bw {fb.shape} {fb.dtype}")


def slice_phase(rng, n_windows, profile_dir):
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    windows = synthetic_windows(rng, n_windows)
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    check(pipe.windowed and pipe.use_extras, "DSEC config must run windowed")

    reset_launches()
    mets, secs = run_windows(pipe, windows)
    launches = dict(LAUNCHES)
    # per window: the RSAT/FWL splat pair and one gather per pass
    expect = {"splat_bilinear": 2 * n_windows,
              "gather_bilinear": PASSES * n_windows, "gather_fused": 0,
              "row_gather": 0}
    check(launches == expect,
          f"eval path launches {launches}, expected {expect}")
    for i, m in enumerate(mets):
        check_metrics(m, f"window {i}")
        print(f"bf16 window {i}: {secs[i] * 1e3:.2f} ms  FWL "
              f"{float(m['fwl']):.6f}  RSAT {float(m['rsat']):.6f}  AEE "
              f"{float(m['aee']):.6f}")
    warm = secs[1:] if len(secs) > 1 else secs
    # the host's pace varies window to window: time more passes over the
    # same windows
    for _ in range(TIMING_ROUNDS):
        warm += run_windows(pipe, windows)[1]
    ms_pass = float(np.mean(warm)) / PASSES * 1e3
    print(f"slice: {ms_pass:.3f} ms/pass (mean of {len(warm)} warm "
          f"windows, bf16 forward; per window "
          f"{', '.join(f'{s * 1e3:.2f}' for s in warm)} ms); launches "
          f"{launches}")

    if profile_dir:
        profile_window(pipe, windows[-1], profile_dir)

    # float32 on the card (TF32 off) against the CPU's plain versions
    m_card = check_f32_card_vs_cpu(model, DSEC_CONFIG, windows[:1])
    for k in ("fwl", "rsat", "aee"):
        print(f"bf16 vs f32 {k} (window 0): "
              f"{float(mets[0][k]):.7f} vs {float(m_card[k]):.7f}")
    return launches, ms_pass, model


def check_f32_card_vs_cpu(model, config, windows, ridx=None, flows=None):
    """One window in float32 (TF32 off) on the card and on the CPU (plain
    versions): FWL/RSAT/AEE must agree. ``ridx`` sets ``cur_ridx`` on both;
    the card's last flow goes to ``flows``."""
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    cfg32 = copy.deepcopy(config)
    del cfg32["metrics"]["inference_dtype"]
    card = EvalPipeline(cfg32, model, device=DEVICE)
    card.cur_ridx = ridx
    (m_card,), _ = run_windows(card, windows, flows)
    t0 = time.perf_counter()
    cpu = EvalPipeline(cfg32, copy.deepcopy(model).cpu(), device="cpu")
    cpu.cur_ridx = ridx
    (m_cpu,), _ = run_windows(cpu, windows)
    print(f"cpu window: {time.perf_counter() - t0:.1f} s")
    for k in ("fwl", "rsat", "aee"):
        a, b = float(m_card[k]), float(m_cpu[k])
        print(f"f32 {k}: card {a:.7f} cpu {b:.7f} "
              f"rel {abs(a - b) / abs(b):.2e}")
        check(math.isclose(a, b, rel_tol=METRIC_RTOL, abs_tol=METRIC_ATOL),
              f"{k}: card {a} vs cpu {b} beyond rtol {METRIC_RTOL}")
    return m_card


def rectified_windows(rng, n_windows, fwd, ridx):
    """``synthetic_windows`` made rectified as the loader makes them
    (``data/base.py assemble_sample``): the raw integer coordinates go to
    ``event_raw_xy``, the list carries the forward map's fractional ones
    (``data.rectify_events``), and the host builds the count input at the
    raw coordinates and remaps it through the index (zero where it is 0)."""
    from taming_event_flow_tpu_torch.data import (
        events_to_channels_np,
        rectify_events,
    )

    h, w = RES
    src = np.where(ridx > 0, ridx - 1, 0).reshape(-1)
    windows = synthetic_windows(rng, n_windows)
    for passes in windows:
        for b in passes:
            ev = b["event_list"]
            ys, xs, ps = (ev[0, :, k].copy() for k in (1, 2, 3))
            b["event_raw_xy"] = np.stack([ys, xs], -1).astype(
                np.uint16)[None]
            rx, ry = rectify_events(fwd, xs, ys)
            ev[0, :, 1], ev[0, :, 2] = ry, rx
            cnt = events_to_channels_np(xs, ys, ps, RES).reshape(-1, 2)
            net = np.where((ridx > 0)[..., None],
                           cnt[src].reshape(h, w, 2), 0.0).astype(np.float32)
            b["net_input"] = net[None]
            b["event_mask"] = (net.sum(-1, keepdims=True) > 0).astype(
                np.float32)[None]
    return windows


def rectified_phase(rng, model, n_windows, ms_plain, profile_dir):
    """The DSEC protocol on a rectified sequence: the count input derived
    on the card (raw coordinates + ``cur_ridx``, one row gather per window)
    against the host-built input shipped, bitwise; float32 metrics card
    against CPU; ``compute_pol_iwe`` card against CPU."""
    import torch

    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        compute_pol_iwe,
        reset_launches,
    )
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline
    from taming_event_flow_tpu_torch.training.step import _derive_inputs

    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    windows = rectified_windows(rng, n_windows, fwd, ridx[0])
    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    pipe.cur_ridx = ridx

    reset_launches()
    mets, secs = run_windows(pipe, windows)
    launches = dict(LAUNCHES)
    expect = {"splat_bilinear": 2 * n_windows,
              "gather_bilinear": PASSES * n_windows, "gather_fused": 0,
              "row_gather": n_windows}
    check(launches == expect,
          f"rectified path launches {launches}, expected {expect}")
    for i, m in enumerate(mets):
        check_metrics(m, f"rectified window {i}")

    # the same windows with the host-built input shipped (no index): the
    # metrics agree (same inputs, checked bitwise below), then both routes
    # are timed in turns over TIMING_ROUNDS passes through the windows
    host = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    host_mets, _ = run_windows(host, windows)
    for i, (a, b) in enumerate(zip(mets, host_mets)):
        for k in ("fwl", "rsat", "aee"):
            check(math.isclose(float(a[k]), float(b[k]), rel_tol=KERNEL_RTOL,
                               abs_tol=KERNEL_ATOL),
                  f"rectified window {i}: {k} derived {a[k]} vs host {b[k]}")
    secs = {"derived": [], "host": []}
    for _ in range(TIMING_ROUNDS):
        for route, runner in (("derived", pipe), ("host", host)):
            secs[route] += run_windows(runner, windows)[1]
    ms_derived, ms_host = (float(np.mean(secs[r])) / PASSES * 1e3
                           for r in ("derived", "host"))
    print("rectified windows, derived / host-built input: " + ", ".join(
        f"{a * 1e3:.2f} / {b * 1e3:.2f} ms"
        for a, b in zip(secs["derived"], secs["host"])))
    print(f"rectified slice: {ms_derived:.3f} ms/pass with the count input "
          f"derived on the card, {ms_host:.3f} ms/pass with the host-built "
          f"input shipped (mean of {len(secs['host'])} warm windows each, "
          f"in turns); unrectified slice {ms_plain:.3f} ms/pass (bf16 "
          f"forward); launches {launches}")

    if profile_dir:
        profile_run(lambda: run_windows(pipe, windows[-1:]), profile_dir,
                    "rectified", trace=False)

    # one window: derived input and mask bitwise the host-built ones
    passes = [pipe.ensure_bucket(b) for b in windows[0]]
    stack = lambda k: torch.from_numpy(  # noqa: E731
        np.stack([b[k] for b in passes])).to(DEVICE)
    x, _, emask = _derive_inputs(RES, stack("event_list"), None, None, None,
                                 stack("event_raw_xy"), pipe.cur_ridx)
    check(torch.equal(x, stack("net_input"))
          and torch.equal(emask, stack("event_mask")),
          "derived rectified input differs from the host-built one")
    print(f"derived rectified input and event mask equal the host-built "
          f"ones bitwise ({int((x.sum(-1) > 0).sum())} active pixels over "
          f"{PASSES} passes, {int((pipe.cur_ridx == 0).sum())} out-of-source "
          f"pixels)")

    flows = []
    check_f32_card_vs_cpu(model, DSEC_CONFIG, windows[:1], ridx, flows)
    flow = flows[0]
    ev = stack("event_list")[-1]
    p = ev[..., 3]
    pol = torch.stack([p > 0, p < 0], -1).float()
    for rounding in ((True, True), (False, False)):
        got = compute_pol_iwe(flow, ev, RES, pol, *rounding)
        ref = compute_pol_iwe(flow.cpu(), ev.cpu(), RES, pol.cpu(),
                              *rounding)
        e = float((got.cpu() - ref).abs().max())
        check(torch.allclose(got.cpu(), ref, rtol=KERNEL_RTOL,
                             atol=KERNEL_ATOL),
              f"compute_pol_iwe {rounding}: card vs cpu {e}")
        print(f"compute_pol_iwe (round_idx, round_flow) = {rounding}: card "
              f"vs cpu max abs err {e:.3e} (max {float(ref.max()):.3f})")
    return launches, ms_derived, ms_host


def profile_run(fn, out_dir, tag, trace=True, watch=()):
    """Kernel-time breakdown of one call of ``fn`` (torch.profiler): the
    table goes to ``<out_dir>/profile_<tag>.txt``, the ten kernels with the
    most device time to stdout, and for each name in ``watch`` the
    launches and device ms of the kernels whose name holds it. Returns
    the wall and the device time, in ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    table = averages.table(sort_by="self_cuda_time_total", row_limit=60)
    # device time: the kernels' and copies' own rows (each op's row would
    # count its kernels a second time)
    # (a user annotation such as the optimizer step's spans its kernels on
    # the device timeline and would count them again)
    device_rows = [a for a in averages if a.device_type == DeviceType.CUDA
                   and not a.is_user_annotation]
    busy = sum(a.self_device_time_total for a in device_rows) / 1e6  # s
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(f"wall {wall * 1e3:.3f} ms, device time "
                f"{busy * 1e3:.3f} ms\n{table}\n")
    if trace:
        prof.export_chrome_trace(os.path.join(out_dir, f"trace_{tag}.json"))
    print(f"profile {tag}: wall {wall * 1e3:.3f} ms, device time "
          f"{busy * 1e3:.3f} ms (device idle {1 - busy / wall:.1%} of the "
          f"wall) -> {out_dir}")
    top = sorted(device_rows, key=lambda a: -a.self_device_time_total)[:10]
    for a in top:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms  {a.count:6d}x  "
              f"{a.key[:90]}")
    for name in watch:
        rows = [a for a in device_rows if name in a.key]
        print(f"profile {tag}: kernels named *{name}*: "
              f"{sum(a.count for a in rows)} launches, "
              f"{sum(a.self_device_time_total for a in rows) / 1e3:.5f} ms")
    return wall * 1e3, busy * 1e3


def profile_window(pipe, passes, out_dir):
    """Kernel-time breakdown of one warm bf16 eval window."""
    profile_run(lambda: run_windows(pipe, [passes]), out_dir, "window")


# ------------------------------------------------------------ training phase


def train_window(rng, batch, device=DEVICE, n=TRAIN_N):
    """One training window of ``PASSES`` passes of ``n`` events a lane as
    ``bench.py``'s ``_synthetic_events`` builds it (uniform integer pixels,
    uniform ts, +-1 polarity), every event on the gradient path, with the
    count input derived on the device. On the card unless the caller asks
    for the CPU."""
    import torch

    from taming_event_flow_tpu_torch.ops import derive_count_input
    from taming_event_flow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    shape = (PASSES, batch, n)
    ev = np.zeros(shape + (4,), np.float32)
    ev[..., 0] = rng.uniform(0, 1, shape)
    ev[..., 1] = rng.integers(0, TRAIN_RES[0], shape)
    ev[..., 2] = rng.integers(0, TRAIN_RES[1], shape)
    ev[..., 3] = rng.choice([-1.0, 1.0], shape)
    ev = torch.from_numpy(ev).to(dev)
    p = ev[..., 3]
    return {"net_input": derive_count_input(ev, TRAIN_RES),
            "event_list": ev,
            "pol_mask": torch.stack([p > 0, p < 0], dim=-1).float(),
            "grad_mask": torch.ones(shape + (1,), device=dev)}


def build_trainer(batch, device, warping="Iterative",
                  model_config=MODEL_CONFIG, loss=TRAIN_LOSS):
    """The training slice: full-width RecEVFlowNet of ``model_config``
    (seed 0), Adam after the global-norm clip, the ``warping`` loss of
    ``loss``; returns ``(model, step, state)``."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    model = build_model(model_config, num_bins=2, device=device, seed=0)
    opt = build_optimizer(TRAIN_OPT, model.parameters(),
                          clip_grad=TRAIN_CLIP, device=device)
    step = make_train_step(model, opt, LossConfig(**loss),
                           warping, flow_scaling=FLOW_SCALING,
                           res=TRAIN_RES)
    return model, step, init_train_state(model, batch, *TRAIN_RES,
                                         device=device)


def check_grads(model, tag):
    """Every parameter got a finite, non-zero gradient; a conv bias right
    before an instance norm (``norm: IN``), whose gradient the norm's mean
    removes, a finite one."""
    import torch

    names, grads = zip(*((n, p.grad) for n, p in model.named_parameters()))
    check(all(g is not None for g in grads), f"{tag}: a gradient is missing")
    params = dict(model.named_parameters())
    normed = {n for n in names if n.endswith("conv2d.bias") and
              n.replace("conv2d.bias", "norm_layer.weight") in params}
    ok = torch.stack([torch.isfinite(g).all()
                      & ((g != 0).any() | (n in normed))
                      for n, g in zip(names, grads)]).cpu()
    bad = [n for n, good in zip(names, ok.tolist()) if not good]
    check(not bad, f"{tag}: non-finite or all-zero gradients: {bad}")


def padding_cost(model, window):
    """What the rows purged to (0, 0) cost the splat: the tref-5 IWE splat
    of each flow scale, with and without them."""
    import torch

    from taming_event_flow_tpu_torch.objectives import warp_table_triangular
    from taming_event_flow_tpu_torch.ops import cuda_warp
    from taming_event_flow_tpu_torch.training import run_passes

    tref = PASSES // 2
    with torch.no_grad():
        carry = model.init_state(TRAIN_B, *TRAIN_RES, device=DEVICE)
        flows, _ = run_passes(model, carry, window["net_input"],
                              FLOW_SCALING)
        ts = window["event_list"][..., 0:1] + torch.arange(
            PASSES, device=DEVICE).reshape(-1, 1, 1, 1)
    for s in range(flows.shape[1]):
        with torch.no_grad():
            loc, mask = warp_table_triangular(
                flows[:, s], window["event_list"][..., 1:3], ts,
                window["pol_mask"], TRAIN_RES)
        loc = loc[tref].permute(1, 0, 2, 3).reshape(TRAIN_B, -1, 2)
        mask = mask[tref].permute(1, 0, 2, 3).reshape(TRAIN_B, -1, 2)
        loc = loc.contiguous()
        vals = torch.cat([mask, mask * 0.5], -1).contiguous()
        at_origin = (mask.sum(-1) == 0) & (loc == 0).all(-1)
        keep = int((~at_origin).sum(1).min())
        # per lane, the first `keep` rows that are not purged: the same
        # points the splat counts, without the zero atomics on pixel (0, 0)
        order = torch.argsort(at_origin.int(), dim=1, stable=True)[:, :keep]
        loc_k = torch.gather(loc, 1, order[..., None].expand(-1, -1, 2))
        vals_k = torch.gather(vals, 1, order[..., None].expand(-1, -1, 4))
        loc_k, vals_k = loc_k.contiguous(), vals_k.contiguous()
        times = {}
        for tag, lc, vl in (("with", loc, vals), ("without", loc_k, vals_k)):
            call = lambda: cuda_warp.splat_bilinear(  # noqa: E731
                lc, vl, TRAIN_RES)
            times[tag] = (time_ms(call), device_ms(call, "splat_kernel"))
        n0 = int(at_origin.sum())
        print(f"padding rows, scale {s}: {n0} of {at_origin.numel()} rows of "
              f"the tref-{tref} IWE splat sit purged at (0, 0) "
              f"({n0 / TRAIN_B:.0f} per lane); splat (event ms, device ms) "
              f"{times['with']} with them, {times['without']} on the {keep} "
              f"per lane without")


def fused_gather_census(step, state, window):
    """One more training step with the two Functions' backward watched:
    per width C, the fused gathers' launches and points, the share of rows
    whose values are all zero (which read no taps) and of those at (0, 0),
    and the bytes bound of them all (each launch's loc, values, map and
    d_loc once). ``tools/bench_fused_shapes.ZERO_SHARE`` carries the share
    to the kernel phases' zero-row inputs. Returns the new state."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    stats = {}

    def record(maps, loc, vals):
        zero = (vals == 0).all(-1)
        s = stats.setdefault(vals.shape[-1], {"launches": 0, "points": 0,
                                              "bytes": 0, "zero": [],
                                              "at_origin": []})
        s["launches"] += 1
        s["points"] += zero.numel()
        s["bytes"] += (loc.numel() + vals.numel() + maps.numel()
                       + 2 * zero.numel()) * 4
        s["zero"].append(zero.sum())
        s["at_origin"].append((zero & (loc == 0).all(-1)).sum())

    splat_bw = cuda_warp.SplatBilinearFn.backward
    gather_bw = cuda_warp.GatherBilinearFn.backward

    def splat_spy(ctx, g):
        if ctx.needs_input_grad[0]:
            loc, values = ctx.saved_tensors
            record(g, loc, values)
        return splat_bw(ctx, g)

    def gather_spy(ctx, g):
        if ctx.needs_input_grad[1]:
            maps, loc = ctx.saved_tensors
            record(maps, loc, g)
        return gather_bw(ctx, g)

    cuda_warp.SplatBilinearFn.backward = staticmethod(splat_spy)
    cuda_warp.GatherBilinearFn.backward = staticmethod(gather_spy)
    try:
        # eager: a graph's replay runs no Python, so no spy
        state, _ = step.eager(state, window)
    finally:
        cuda_warp.SplatBilinearFn.backward = staticmethod(splat_bw)
        cuda_warp.GatherBilinearFn.backward = staticmethod(gather_bw)
    launches = sum(s["launches"] for s in stats.values())
    check(launches == TRAIN_LAUNCHES["gather_fused"],
          f"census saw {launches} fused gathers in a step")
    total = 0
    for c, s in sorted(stats.items()):
        zero = int(torch.stack(s["zero"]).sum())
        origin = int(torch.stack(s["at_origin"]).sum())
        total += s["bytes"]
        print(f"fused gathers of a training step at C={c}: {s['launches']} "
              f"launches, {s['points']} points, zero-valued rows "
              f"{zero / s['points']:.6f} of them ({zero}; at (0, 0) "
              f"{origin}); bytes bound {bound_ms(s['bytes'], 0)[0]:.5f} ms")
    print(f"fused gathers of a training step: bytes bound "
          f"{bound_ms(total, 0)[0]:.5f} ms ({total} B)")
    return state


def max_ratio(got, ref):
    """``max |got - ref| / max |ref|``."""
    return float((got.cpu() - ref).abs().max() / ref.abs().max())


def grad_gaps(model, ref_model):
    """Per parameter ``max |g - g_ref| / max |g_ref|``: the worst
    ``(ratio, name)`` and the global relative L2 error."""
    ref = dict(ref_model.named_parameters())
    worst, diff2, norm2 = (-1.0, None), 0.0, 0.0
    for name, p in model.named_parameters():
        g, r = p.grad.cpu(), ref[name].grad
        worst = max(worst, (max_ratio(g, r), name),
                    key=lambda t: t[0])
        diff2 += float(((g - r) ** 2).sum())
        norm2 += float((r ** 2).sum())
    return worst, math.sqrt(diff2 / norm2)


def card_vs_cpu(rng, model_config=MODEL_CONFIG, probes=True):
    """Float32 on the card (TF32 off) against the CPU's plain versions, at
    B=1 from the same weights on the same window, for the full-width model
    of ``model_config``.

    The loss's gradient is discontinuous in the flows (the derivative
    stencil jumps where a warped point crosses an integer coordinate), so
    the whole step's parameter gradients move with the convolutions'
    rounding on either device. The check holds each half of the chain
    apart: (a) the whole step's loss; (b) the loss's flow gradient on
    identical flows (the warp and its kernels, forward and backward); (c)
    the parameter gradients of the P passes for one flow cotangent (the
    model's backward), in float64 on both devices. Printed beside them:
    the whole step's gradient gap next to the CPU's own gap when its
    weights move by ``JITTER``, and the float32 model gradients against
    float64 on either device, then the float32 probes; ``probes`` off
    leaves out the jittered runs, the float32 gradients and the probes,
    and runs the checks alone."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import (
        LossConfig,
        iterative_loss,
    )
    from taming_event_flow_tpu_torch.training import run_passes

    w_card = train_window(rng, 1)
    w_cpu = {k: v.cpu() for k, v in w_card.items()}
    cfg = LossConfig(**TRAIN_LOSS)

    def flows_of(model, w, dtype=torch.float32):
        dev = next(model.parameters()).device
        carry = model.init_state(1, *TRAIN_RES, dtype=dtype, device=dev)
        return run_passes(model, carry, w["net_input"].to(dtype),
                          FLOW_SCALING)[0]

    # (a) the whole step; the CPU once more with its weights jittered
    runs = {}
    jittered = (("jitter", "cpu", w_cpu, JITTER),) if probes else ()
    for tag, dev, w, jitter in (("card", DEVICE, w_card, 0.0),
                                ("cpu", "cpu", w_cpu, 0.0)) + jittered:
        model, step, state = build_trainer(1, dev, model_config=model_config)
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                noise = torch.randn(p.shape, generator=gen).to(dev)
                p.mul_(1 + jitter * noise)
            flows = flows_of(model, w).cpu()
        t0 = time.perf_counter()
        _, loss = step(state, w)
        runs[tag] = (model, flows, float(loss))
        print(f"{tag} train step: {time.perf_counter() - t0:.1f} s")
    a, b = runs["card"][2], runs["cpu"][2]
    rel = abs(a - b) / abs(b)
    print(f"f32 train loss: card {a:.8f} cpu {b:.8f} rel {rel:.2e}")
    check(rel <= TRAIN_LOSS_RTOL, f"train loss: card {a} vs cpu {b}")
    for tag in ("card", "jitter")[:1 + probes]:
        (worst, name), glob = grad_gaps(runs[tag][0], runs["cpu"][0])
        print(f"f32 whole step, {tag} vs cpu: flows max abs error / max "
              f"|flow| {max_ratio(runs[tag][1], runs['cpu'][1]):.2e}; "
              f"gradients worst {worst:.2e} ({name}), global {glob:.2e}")

    # (b) the loss's flow gradient on identical flows
    flows = runs["cpu"][1]
    gen = torch.Generator().manual_seed(2)
    cases = (("card", DEVICE, w_card, flows), ("cpu", "cpu", w_cpu, flows))
    if probes:
        cases += (("jitter", "cpu", w_cpu, flows * (1 + JITTER * torch.randn(
            flows.shape, generator=gen))),)
    g_flow = {}
    for tag, dev, w, fl in cases:
        f = fl.to(dev).requires_grad_()
        iterative_loss(f, w["event_list"], w["pol_mask"], w["grad_mask"],
                       cfg).backward()
        g_flow[tag] = f.grad
    ratio = max_ratio(g_flow["card"], g_flow["cpu"])
    own = (f"; cpu with flows jittered vs cpu "
           f"{max_ratio(g_flow['jitter'], g_flow['cpu']):.2e}"
           if probes else "")
    print(f"f32 loss flow gradient on identical flows, card vs cpu: max abs "
          f"error / max |g| {ratio:.2e}{own}")
    check(ratio <= TRAIN_GRAD_TOL, f"loss flow gradient off by {ratio}")

    # (c) the model's backward for one flow cotangent
    models = {}
    for dtype in (torch.float64, torch.float32)[:1 + probes]:
        for dev, w in ((DEVICE, w_card), ("cpu", w_cpu)):
            m = build_model(model_config, num_bins=2, device=dev,
                            seed=0).to(dtype)
            flows_of(m, w, dtype).backward(g_flow["cpu"].to(dev))
            models[dev, dtype] = m
    ref = models["cpu", torch.float64]
    (worst, name), glob = grad_gaps(models[DEVICE, torch.float64], ref)
    print(f"f64 model gradients for one flow cotangent, card vs cpu: worst "
          f"max abs error / max |g| {worst:.2e} ({name}), global "
          f"{glob:.2e}")
    check(worst <= TRAIN_GRAD_TOL,
          f"model gradients: {name} off by {worst} x its max |g|")
    if not probes:
        return
    for dev in (DEVICE, "cpu"):
        (w32, n32), g32 = grad_gaps(models[dev, torch.float32], ref)
        print(f"f32 model gradients on {dev} vs f64 on cpu: worst {w32:.2e} "
              f"({n32}), global {g32:.2e}")
    f32_backward_probe(lambda m: flows_of(m, w_card).backward(
        g_flow["cpu"].to(DEVICE)), ref)
    kink_probe(lambda m, dev, dtype: flows_of(
        m, w_card if dev == DEVICE else w_cpu, dtype).backward(
            g_flow["cpu"].to(dev)))

    # the same gaps over the first passes only: a gap that grows with the
    # passes comes through the recurrence
    for passes in GAP_PASSES:
        models = {}
        for dev, dtype, w in ((DEVICE, torch.float32, w_card),
                              ("cpu", torch.float32, w_cpu),
                              ("cpu", torch.float64, w_cpu)):
            m = build_model(model_config, num_bins=2, device=dev,
                            seed=0).to(dtype)
            first = {"net_input": w["net_input"][:passes]}
            flows_of(m, first, dtype).backward(
                g_flow["cpu"][:passes].to(dev))
            models[dev, dtype] = m
        ref_p = models["cpu", torch.float64]
        for dev in (DEVICE, "cpu"):
            (w32, n32), g32 = grad_gaps(models[dev, torch.float32], ref_p)
            print(f"f32 model gradients on {dev} vs f64 on cpu, first "
                  f"{passes} passes: worst {w32:.2e} ({n32}), global "
                  f"{g32:.2e}")


def precision_settings():
    """``(tag, [(owner, attribute, value), ...])`` of the float32 settings
    the probes try, each set on top of ``set_tf32(False)``."""
    import torch

    b = torch.backends
    return (("as set", []),
            ("conv.fp32_precision=ieee", [(b.cudnn.conv, "fp32_precision",
                                           "ieee")]),
            ("deterministic", [(b.cudnn, "deterministic", True)]),
            ("cudnn off", [(b.cudnn, "enabled", False)]),
            ("every fp32_precision=ieee", [
                (b, "fp32_precision", "ieee"),
                (b.cuda.matmul, "fp32_precision", "ieee"),
                (b.cudnn, "fp32_precision", "ieee"),
                (b.cudnn.conv, "fp32_precision", "ieee")]),
            ("set_tf32(True)", [(b.cudnn, "allow_tf32", True),
                                (b.cuda.matmul, "allow_tf32", True)]))


def under(pairs, fn):
    """``fn()`` with each ``(owner, attribute, value)`` set, all restored
    after (in reverse order)."""
    before = [(o, a, getattr(o, a)) for o, a, _ in pairs]
    try:
        for o, a, v in pairs:
            setattr(o, a, v)
        return fn()
    finally:
        for o, a, v in reversed(before):
            setattr(o, a, v)


def precision_ops_probe(seed=0):
    """Float32 on the card against float64 on the CPU, op by op, under each
    of :func:`precision_settings`: a 3x3 convolution (64 -> 128 channels,
    2x32x32) forward and its three gradients, and the decoders' bilinear x2
    upsampling forward and backward. Prints ``max |err| / max |ref|`` per
    output: ~1e-7 is float32, ~1e-3 is TF32's 10-bit mantissa."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 64, 32, 32, generator=gen, dtype=torch.float64)
    w = torch.randn(128, 64, 3, 3, generator=gen, dtype=torch.float64) / 24
    b = torch.randn(128, generator=gen, dtype=torch.float64)
    g = torch.randn(2, 128, 32, 32, generator=gen, dtype=torch.float64)
    gu = torch.randn(2, 64, 64, 64, generator=gen, dtype=torch.float64)

    def leaf(t, dev, dtype):
        return t.to(dev, dtype, copy=True).requires_grad_()

    def ops(dev, dtype):
        xs = [leaf(t, dev, dtype) for t in (x, w, b)]
        y = F.conv2d(*xs, padding=1)
        y.backward(g.to(dev, dtype))
        xu = leaf(x, dev, dtype)
        u = F.interpolate(xu, scale_factor=2, mode="bilinear",
                          align_corners=False)
        u.backward(gu.to(dev, dtype))
        return {"conv y": y, "conv dx": xs[0].grad, "conv dw": xs[1].grad,
                "conv db": xs[2].grad, "upsample y": u,
                "upsample dx": xu.grad}

    ref = ops("cpu", torch.float64)
    for tag, pairs in precision_settings():
        try:
            got = under(pairs, lambda: ops(DEVICE, torch.float32))
        except (AttributeError, RuntimeError) as e:
            print(f"precision probe, {tag}: not available ({e})")
            continue
        errs = ", ".join(
            f"{k} {max_ratio(v.detach().double(), ref[k].detach()):.2e}"
            for k, v in got.items())
        print(f"precision probe, {tag}: {errs}")


def f32_backward_probe(backward, ref):
    """The card's float32 model gradients for one flow cotangent against
    float64 on the CPU (``ref``) under each of :func:`precision_settings`.
    ``backward(m)`` runs the passes of model ``m`` and their backward."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model

    cudnn = torch.backends.cudnn
    print(f"cudnn settings: allow_tf32 {cudnn.allow_tf32}, conv "
          f"fp32_precision {getattr(cudnn.conv, 'fp32_precision', None)}, "
          f"deterministic {cudnn.deterministic}, benchmark {cudnn.benchmark}"
          f"; cuda.matmul allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")

    def run():
        m = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
        backward(m)
        return m

    for tag, pairs in precision_settings():
        try:
            m = under(pairs, run)
        except (AttributeError, RuntimeError) as e:
            print(f"f32 model gradients, {tag}: not available ({e})")
            continue
        (worst, name), glob = grad_gaps(m, ref)
        print(f"f32 model gradients on {DEVICE}, {tag}, vs f64 on cpu: "
              f"worst {worst:.2e} ({name}), global {glob:.2e}")
    precision_ops_probe()


def kink_probe(backward):
    """Whether the card's float32 gradient gap is the model's own jumps:
    float64 on the CPU against itself with every weight moved by
    ``KINK_JITTER`` (relative); the ReLU inputs that float32 puts on the
    other side of zero from float64 (ReLU's derivative jumps there); and
    float32 on the card with float64's ReLU masks, which must sit within
    ``KINK_GRAD_TOL`` of float64. ``backward(m, dev, dtype)`` runs the
    passes of model ``m`` and their backward."""
    import torch

    from taming_event_flow_tpu_torch.models import blocks, build_model

    def run(dev, dtype, jitter=0.0, masks=None):
        seen = []

        def relu(x):
            seen.append(x.detach().cpu().double())
            if masks is None:
                return torch.relu(x)
            return x * masks[len(seen) - 1].to(x.device, x.dtype)

        blocks._ACTIVATIONS["relu"] = relu
        try:
            m = build_model(MODEL_CONFIG, num_bins=2, device=dev,
                            seed=0).to(dtype)
        finally:
            blocks._ACTIVATIONS["relu"] = torch.relu
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for p in m.parameters() if jitter else ():
                noise = torch.randn(p.shape, generator=gen, dtype=dtype)
                p.mul_(1 + jitter * noise.to(dev))
        backward(m, dev, dtype)
        return m, seen

    ref, ref_in = run("cpu", torch.float64)
    moved, _ = run("cpu", torch.float64, KINK_JITTER)
    (worst, name), glob = grad_gaps(moved, ref)
    print(f"f64 model gradients on cpu, weights moved by {KINK_JITTER:g}, "
          f"vs unmoved: worst {worst:.2e} ({name}), global {glob:.2e}")
    total = sum(x.numel() for x in ref_in)
    for dev in (DEVICE, "cpu"):
        _, got = run(dev, torch.float32)
        across = [(a > 0) != (b > 0) for a, b in zip(got, ref_in)]
        n = int(sum(int(f.sum()) for f in across))
        near = max((float(b[f].abs().max()) for f, b in zip(across, ref_in)
                    if f.any()), default=0.0)
        print(f"ReLU inputs across zero from f64 on cpu, f32 on {dev}: {n} "
              f"of {total} (largest |f64 input| among them {near:.2e})")
    masked, _ = run(DEVICE, torch.float32, masks=[b > 0 for b in ref_in])
    (worst, name), glob = grad_gaps(masked, ref)
    print(f"f32 model gradients on {DEVICE} with f64's ReLU masks vs f64 on "
          f"cpu: worst {worst:.2e} ({name}), global {glob:.2e}")
    check(glob <= KINK_GRAD_TOL,
          f"f32 model gradients with f64's ReLU masks off by {glob}")


def train_phase(rng, profile_dir):
    import torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches

    model, step, state = build_trainer(TRAIN_B, DEVICE)
    windows = [train_window(rng, TRAIN_B) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for i, window in enumerate(windows):
        t0 = time.perf_counter()
        state, loss = step(state, window)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"train step {i}: loss not finite")
        check_grads(model, f"train step {i}")
        print(f"train step {i}{' (warm-up)' if i == 0 else ''}: loss "
              f"{losses[-1]:.7f}  {secs[-1] * 1e3:.2f} ms")
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # what the tensors asked for, without the allocator's rounding and
    # unsplit cached blocks
    asked = torch.cuda.memory_stats().get("requested_bytes.all.peak")
    expect = {name: n * len(windows) for name, n in TRAIN_LAUNCHES.items()}
    check(launches == expect,
          f"training path launches {launches}, expected {expect}")
    check(all(a != b for a, b in zip(losses, losses[1:])),
          f"the loss did not change between steps: {losses}")
    check(state.step == len(windows), "step count")
    ms_step = float(np.mean(secs[UNTIMED:])) * 1e3
    per_step = {k: v / len(windows) for k, v in launches.items()}
    print(f"train: {ms_step:.3f} ms/step (mean of {len(secs) - UNTIMED} "
          f"steps after the warm-up and the capture, "
          f"B={TRAIN_B}, {TRAIN_RES[0]}x{TRAIN_RES[1]}, P={PASSES}, "
          f"N={TRAIN_N}); launches {launches} ({per_step} per step); peak "
          f"memory {peak / 2**30:.3f} GiB ({peak} B; requested {asked} B)")

    padding_cost(model, windows[-1])
    state = fused_gather_census(step, state, windows[-1])
    if profile_dir:
        # the fused gathers, and the stack/cat kernels (none of them after
        # a fused gather, check_backward_kernels shows)
        profile_run(lambda: step(state, windows[-1]), profile_dir, "train",
                    trace=False, watch=("gather_fused_kernel", "CatArray"))

    card_vs_cpu(rng)
    return launches, ms_step


# ------------------------------------------------------- training CLI phase


def optional_imports():
    """The version of each optional host package the JAX package's data and
    tracking paths use, or ``None`` where it does not import."""
    import importlib

    found = {}
    for name in ("h5py", "yaml", "cv2", "tensorboard"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = None
    return found


class _MemoryDataset:
    """One dataset of a ``_MemoryFile``: its array, shape, dtype and
    attrs; reading it (``ds[...]``) gives numpy, as ``h5py`` does."""

    def __init__(self, data, attrs):
        self._data = np.asarray(data)
        self.shape, self.dtype, self.attrs = (self._data.shape,
                                              self._data.dtype, attrs)

    def __getitem__(self, idx):
        return self._data[idx]


class _MemoryFile:
    """The part of an ``h5py.File`` (or of one of its groups, under
    ``prefix``) that ``H5Loader`` reads, over a ``data.SyntheticSequence``
    held in memory: the events, the file's attrs, the GT flow maps with
    their ``timestamp_from/to`` attrs (``flow/*``), and the rectification
    map and calibration strings of a rectified sequence."""

    def __init__(self, seq, prefix=""):
        self.seq, self.prefix = seq, prefix
        self.attrs = seq.attrs

    def __getitem__(self, name):
        path = self.prefix + name
        if path in self.seq.datasets:
            return _MemoryDataset(self.seq.datasets[path],
                                  self.seq.dataset_attrs.get(path, {}))
        if name not in self:
            raise KeyError(path)
        return _MemoryFile(self.seq, path + "/")

    def __contains__(self, name):
        path = self.prefix + name
        return path in self.seq.datasets or any(
            k.startswith(path + "/") for k in self.seq.datasets)

    def get(self, name):
        return self[name] if name in self else None

    def visititems(self, fn):
        for path in sorted(self.seq.datasets):
            if path.startswith(self.prefix):
                fn(path[len(self.prefix):], self[path[len(self.prefix):]])

    def close(self):
        pass


def memory_loader(sequences):
    """A subclass of the port's ``H5Loader`` that serves ``sequences``
    (path -> ``SyntheticSequence``) from memory: it overrides only the
    methods that list and open the files, so every other line of the
    loader runs as on ``.h5`` files."""
    from taming_event_flow_tpu_torch.data import H5Loader

    class MemoryH5Loader(H5Loader):
        def list_files(self, root):
            return sorted(p for p in sequences
                          if os.path.dirname(p) == os.path.normpath(root))

        def open_file(self, path):
            return _MemoryFile(sequences[path])

    return MemoryH5Loader


def train_cli_config(path, seed):
    """``configs/train_flow.yml``'s values (``TRAIN_CLI_CONFIG``) merged
    over the port's defaults, without PyYAML, reading ``path``."""
    from taming_event_flow_tpu_torch.configs import YAMLParser, deep_merge

    parser = YAMLParser()
    cfg = copy.deepcopy(TRAIN_CLI_CONFIG)
    cfg["data"]["path"] = path
    cfg["loader"]["seed"] = seed
    deep_merge(parser.config, cfg)
    return parser


def run_train_cli(parser, work, patched, prev_runid=""):
    """``train_flow_torch.train`` on the card with ``parser``'s config,
    ``train_flow_torch``'s names in ``patched`` replaced for the run.
    Prints the run's output; returns its id, wall seconds and output."""
    import contextlib
    import io

    import torch

    import train_flow_torch

    args = argparse.Namespace(path_mlflow=work, path_cache="",
                              prev_runid=prev_runid)
    saved = {k: getattr(train_flow_torch, k) for k in patched}
    for k, v in patched.items():
        setattr(train_flow_torch, k, v)
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            runid = train_flow_torch.train(args, parser, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            setattr(train_flow_torch, k, v)
    text = out.getvalue()
    print(text.replace("\r", "\n").strip())
    return runid, wall, text


def cli_train_data(work, seed, write=True):
    """The training CLI's two synthetic sequences under ``<work>/data``:
    ``.h5`` files for the port's ``H5Loader`` where h5py imports (written
    unless ``write`` is off, for a process that finds them written), else
    the same arrays in memory (:func:`memory_loader`). Returns the data
    directory, the loader class and a line naming the source."""
    from taming_event_flow_tpu_torch.data import (
        H5Loader,
        synthetic_sequence,
        write_synthetic_h5,
    )

    data_dir = os.path.join(work, "data")
    kwargs = [dict(n_events=CLI_EVENTS, res=TRAIN_RES, duration=CLI_DURATION,
                   seed=seed * 10 + i) for i in range(CLI_SEQUENCES)]
    paths = [os.path.join(data_dir, f"seq{i}.h5") for i in range(len(kwargs))]
    try:
        import h5py  # noqa: F401
    except ImportError:
        return (data_dir, memory_loader(
            {p: synthetic_sequence(**kw) for p, kw in zip(paths, kwargs)}),
            "memory (no h5py) through a subclass of H5Loader")
    if write:
        for path, kw in zip(paths, kwargs):
            write_synthetic_h5(path, **kw)
    return data_dir, H5Loader, "h5 files through H5Loader"


def train_cli_phase(seed, work):
    """The training CLI, ``train_flow_torch.train``, on the card at full
    width: two epochs over two synthetic sequences, then a warm start from
    that run for one more epoch. Data through ``.h5`` files and the port's
    ``H5Loader`` where h5py imports, else through ``memory_loader``.
    Returns the launches of both runs, the loop's ms per optimizer step,
    the loader's host ms per loss window, the warm run's id, and the data
    directory with its loader class."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.tracking import (
        default_store,
        load_checkpoint,
    )
    from taming_event_flow_tpu_torch.training import stack_window
    from taming_event_flow_tpu_torch.utils import SectionTimer

    data_dir, loader_cls, source = cli_train_data(work, seed)
    print(f"train_cli: {CLI_SEQUENCES} sequences of {CLI_EVENTS} events "
          f"({CLI_DURATION} s), data from {source}")

    timers = []

    class Timer(SectionTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    def run(prev_runid, n_epochs):
        parser = train_cli_config(data_dir, seed)
        parser.config["loader"]["n_epochs"] = n_epochs
        return run_train_cli(parser, work, {"H5Loader": loader_cls,
                                            "SectionTimer": Timer},
                             prev_runid)

    def losses(runid):
        return [v for _, v, _ in default_store().read_metric(runid, "loss")]

    reset_launches()
    run1, wall1, _ = run("", CLI_EPOCHS)
    ckpt1, epoch1 = load_checkpoint(run1)
    # the warm start resumes at the checkpoint's epoch: one more
    run2, wall2, text2 = run(run1, epoch1 + 1)
    launches = dict(LAUNCHES)

    steps = [t.counts.get("step_dispatch", 0) for t in timers]
    loss1, loss2 = losses(run1), losses(run2)
    print(f"train_cli: run 1 epoch losses {loss1}; warm run {loss2}")
    check(len(loss1) == CLI_EPOCHS and len(loss2) == CLI_EPOCHS + 1,
          "train_cli: epoch losses logged")
    check(loss2[:CLI_EPOCHS] == loss1, "train_cli: history not replayed")
    new = loss1 + loss2[CLI_EPOCHS:]
    check(all(math.isfinite(v) for v in new), f"train_cli: losses {new}")
    check(len(set(new)) == len(new), f"train_cli: losses did not change {new}")
    check(f"Model restored from {run1}" in text2,
          "train_cli: the warm start did not restore the model")
    check(steps[0] >= 3 * CLI_EPOCHS and steps[1] >= 3,
          f"train_cli: steps per run {steps}")

    ckpt2, _ = load_checkpoint(run2, map_location=DEVICE)
    adam = [int(s["step"]) for s in ckpt2["optimizer"]["state"].values()]
    check(ckpt2["step"] == ckpt1["step"] + steps[1] and set(adam) == {
        ckpt2["step"]}, f"train_cli: checkpoint step {ckpt2['step']}, Adam "
          f"steps {set(adam)}, run-1 checkpoint {ckpt1['step']} + {steps[1]}")
    check(all(v.device.type == torch.device(DEVICE).type
              for v in ckpt2["model"].values()),
          "train_cli: checkpoint not on the card")
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE)
    model.load_state_dict(ckpt2["model"])

    expect = {name: n * sum(steps) for name, n in TRAIN_LAUNCHES.items()}
    check(launches == expect,
          f"train_cli launches {launches}, expected {expect}")

    for i, (t, wall) in enumerate(zip(timers, (wall1, wall2))):
        loop = sum(t.totals.values())
        print(f"train_cli run {i + 1}: {steps[i]} steps, loop "
              f"{loop / steps[i] * 1e3:.3f} ms/step, train() "
              f"{wall / steps[i] * 1e3:.3f} ms/step wall ({wall:.2f} s, set-up "
              f"and checkpoints included)")

    # the loader's host time per loss window, alone
    loader = loader_cls(train_cli_config(data_dir, seed).config, shuffle=True)
    n_batches, t0 = 0, time.perf_counter()
    for _ in range(CLI_TIMED_WINDOWS):
        stack_window([loader.next_batch() for _ in range(PASSES)])
        n_batches += PASSES
    ms = (time.perf_counter() - t0) * 1e3
    loader.close()
    ms_window = ms / CLI_TIMED_WINDOWS
    print(f"train_cli loader: {ms_window:.3f} ms per loss window of "
          f"{PASSES} passes ({ms / n_batches:.3f} ms per pass, stack "
          f"included; {source})")
    ms_step = sum(sum(t.totals.values()) for t in timers) / sum(steps) * 1e3
    return launches, ms_step, ms_window, run2, (data_dir, loader_cls)


# ----------------------------------------------------------- eval CLI phase


def eval_cli_data(work, tag, specs, write=True):
    """Synthetic sequences (name -> ``synthetic_sequence`` kwargs) under
    ``<work>/eval_<tag>``: ``.h5`` files for the port's ``H5Loader`` where
    h5py imports (written unless ``write`` is off), else the same arrays in
    memory (:func:`memory_loader`). Returns the data directory and the
    loader class."""
    from taming_event_flow_tpu_torch.data import (
        H5Loader,
        synthetic_sequence,
        write_synthetic_h5,
    )

    root = os.path.join(work, f"eval_{tag}")
    paths = {os.path.join(root, f"{name}.h5"): kw
             for name, kw in specs.items()}
    try:
        import h5py  # noqa: F401
    except ImportError:
        return root, memory_loader(
            {p: synthetic_sequence(**kw) for p, kw in paths.items()})
    if write:
        for p, kw in paths.items():
            write_synthetic_h5(p, **kw)
    return root, H5Loader


def dsec_sequence(n_frames, seed, rectify=False, res=RES,
                  events=EVAL_CLI_EVENTS, gt_window=GT_WINDOW):
    """``synthetic_sequence`` kwargs: ``n_frames`` GT flow frames
    ``gt_window`` apart, ``events`` events per GT window."""
    return dict(n_events=events * n_frames, res=res,
                duration=gt_window * n_frames, n_flow_frames=n_frames,
                seed=seed, rectify=rectify)


def eval_cli_run(tag, values, data_dir, loader_cls, runid, work,
                 device=None):
    """``eval_flow_torch.test`` on run ``runid`` with the config
    ``values`` (no PyYAML needed) over ``data_dir``, its loader patched to
    ``loader_cls``. Returns the results, the CLI's wall seconds, its
    pipeline (the ``SectionTimer`` in ``tm``; ``windows``: the sequence
    and launches of every window, taken at its boundary; ``resets``: the
    carry's absolute sum before and after each sequence start), the results
    directory and the launches of the run."""
    import contextlib
    import io

    import torch

    import eval_flow_torch
    from taming_event_flow_tpu_torch.configs import YAMLParser
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    pipes = []

    class Pipe(EvalPipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.windows = []
            self.resets = []  # (carry |sum| before, after) per rollover
            self._seen = {}
            pipes.append(self)

        def start_sequence(self):
            before = sum(float(c.abs().sum()) for c in self.carry)
            super().start_sequence()
            self.resets.append(
                (before, sum(float(c.abs().sum()) for c in self.carry)))

        def boundary_outputs(self, batch, meta):
            now = dict(LAUNCHES)
            self.windows.append((meta["sequence"], {
                k: v - self._seen.get(k, 0) for k, v in now.items()}))
            self._seen = now
            return super().boundary_outputs(batch, meta)

    device = device or DEVICE
    parser = YAMLParser()
    parser.merge(values)
    parser.merge({"data": {"path": data_dir}})
    path_results = os.path.join(work, f"results_{tag}")
    args = argparse.Namespace(runid=runid, path_mlflow=work,
                              path_results=path_results + "/")
    patched = {"H5Loader": loader_cls, "EvalPipeline": Pipe}
    saved = {k: getattr(eval_flow_torch, k) for k in patched}
    for k, v in patched.items():
        setattr(eval_flow_torch, k, v)
    out = io.StringIO()
    try:
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            results = eval_flow_torch.test(args, parser, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        for k, v in saved.items():
            setattr(eval_flow_torch, k, v)
    print(out.getvalue().strip())
    return (results, wall, pipes[-1], os.path.join(path_results, runid),
            launches)


def read_png(path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    check(img is not None, f"{path} does not read")
    return img


def check_metrics_file(res_dir, results, seqs, names):
    """``metrics_0.yml``: one finite entry per sequence and metric, equal
    to what the CLI returned."""
    import yaml

    found = sorted(f for f in os.listdir(res_dir) if f.startswith("metrics_"))
    check(found == ["metrics_0.yml"], f"metric files {found}")
    with open(os.path.join(res_dir, "metrics_0.yml")) as f:
        mets = yaml.safe_load(f)
    check(mets == results, f"metrics_0.yml {mets} != returned {results}")
    check(sorted(mets) == sorted(names), f"metrics {sorted(mets)}")
    for name in names:
        check(sorted(mets[name]) == sorted(seqs),
              f"{name}: sequences {sorted(mets[name])}, expected {seqs}")
        for seq, v in mets[name].items():
            check(math.isfinite(float(v)), f"{name} {seq}: {v}")
    return mets


def check_dsec_tree(tree, seq, n_windows, passes=PASSES, res=RES):
    """One 16-bit ``flow_bw`` PNG per evaluated window of ``seq``, named
    by the window's last pass, with that pass's line in ``timestamps.txt``
    (which has one for every pass the loader gave), each decoding to
    ``[H, W, 2]``. Returns the PNGs' paths."""
    from taming_event_flow_tpu_torch.utils import decode_dsec_flow

    d = os.path.join(tree, seq, "flow_bw")
    names = sorted(os.listdir(d))
    check(len(names) == n_windows,
          f"{seq}: {len(names)} flow_bw PNGs for {n_windows} windows")
    with open(os.path.join(tree, seq, "timestamps.txt")) as f:
        stamps = f.read().split()
    for i, name in enumerate(names):
        check(name == f"{(i + 1) * passes - 1:09d}.png", f"{seq}: {name}")
        check(int(name[:9]) < len(stamps),
              f"{seq}: no timestamp for {name} ({len(stamps)} lines)")
        img = read_png(os.path.join(d, name))
        check(img.dtype == np.uint16 and img.shape == (*res, 3),
              f"{seq}/{name}: {img.dtype} {img.shape}")
        check(decode_dsec_flow(img).shape == (*res, 2), f"{seq}/{name}")
    return [os.path.join(d, n) for n in names]


def submission_check(tree, runid, seqs, work):
    """``prepare_dsec_submission.prepare`` on the CLI's tree with a
    synthetic ``<seq>_flag.npy`` (every window but the first) and
    ``<seq>.txt``: one ``%06d.png`` per flag."""
    import prepare_dsec_submission

    root = os.path.join(work, "dsec_submissions")
    dst = os.path.join(root, runid, "eval_0")
    shutil.copytree(tree, dst)
    expect = {}
    for seq in seqs:
        n = len(os.listdir(os.path.join(dst, seq, "flow_bw")))
        flags = np.ones(n, np.int64)
        flags[0] = 0
        np.save(os.path.join(root, f"{seq}_flag.npy"), flags)
        with open(os.path.join(root, f"{seq}.txt"), "w") as f:
            f.write("# from_timestamp_us, to_timestamp_us, file_index\n")
            for i in range(n):
                f.write(f"{i * 100000}, {(i + 1) * 100000}, "
                        f"{2 * i + 1:06d}\n")
        expect[seq] = [f"{2 * i + 1:06d}.png" for i in range(int(flags.sum()))]
    prepare_dsec_submission.prepare(argparse.Namespace(
        runid=runid, path=root + "/", eval_id=0))
    for seq in seqs:
        got = sorted(os.listdir(os.path.join(dst, "submission", seq)))
        check(got == expect[seq], f"submission {seq}: {got}")
        for name in got:
            img = read_png(os.path.join(dst, "submission", seq, name))
            check(img.dtype == np.uint16, f"submission {seq}/{name}")
    return {seq: len(v) for seq, v in expect.items()}


def eval_cli_phase(seed, work, runid, eval_launches, gpu):
    """The eval CLI, ``eval_flow_torch.test``, on the card, evaluating the
    run the training-CLI phase wrote: (a) the DSEC submission protocol over
    a rectified and an unrectified sequence, then the submission formatter
    on its tree; (b) one short rectified sequence in float32 on the card
    and on the CPU; (c) the MVSEC per-pass protocol with every panel stored.
    ``eval_launches``: the eval phase's launches per window. Returns the
    launches of the card's runs and the wall ms per GT window of (a)."""
    t_phase = time.perf_counter()
    all_launches = []

    # (a) the DSEC submission protocol
    frames = EVAL_CLI_WINDOWS + 2
    specs = {"seq_rect": dsec_sequence(frames, seed * 10 + 20, rectify=True),
             "seq_plain": dsec_sequence(frames, seed * 10 + 21)}
    data_dir, loader_cls = eval_cli_data(work, "dsec", specs)
    results, wall, pipe, res_dir, launches = eval_cli_run(
        "dsec", EVAL_DSEC_CLI, data_dir, loader_cls, runid, work)
    all_launches.append(launches)
    names = EVAL_DSEC_CLI["metrics"]["name"]
    check_metrics_file(res_dir, results, list(specs), names)
    tree = os.path.join(res_dir, "results", "eval_0")
    n_windows = len(pipe.windows)
    per_seq = {seq: [w for s, w in pipe.windows if s == seq]
               for seq in specs}
    for seq, windows in per_seq.items():
        check(len(windows) == EVAL_CLI_WINDOWS,
              f"{seq}: {len(windows)} windows evaluated")
        check_dsec_tree(tree, seq, len(windows))
        # a rectified window on the default u32 wire: the coordinate lookup
        # in the forward map and the count input's remap
        rows = 2 if seq == "seq_rect" else 0
        for i, w in enumerate(windows):
            expect = {"splat_bilinear": eval_launches["splat_bilinear"],
                      "gather_bilinear": eval_launches["gather_bilinear"],
                      "gather_fused": 0, "row_gather": rows}
            check(w == expect, f"eval_cli {seq} window {i}: launches {w}, "
                  f"expected {expect}")
    n_sub = submission_check(tree, runid, list(specs), work)
    ms_window = wall / n_windows * 1e3
    print(f"eval_cli (a) DSEC: GT windows "
          f"{ {s: len(w) for s, w in per_seq.items()} }, metrics {results}; "
          f"launches {launches}; submission PNGs {n_sub}")
    print(f"eval_cli (a): {ms_window:.3f} ms per GT window of CLI wall "
          f"({wall:.3f} s, set-up, loader and PNG writeback included; bf16 "
          f"forward) on {gpu}")
    print(f"eval_cli (a) on {gpu}: {pipe.tm.report()}")

    # (b) card against CPU through the CLI, float32 with TF32 off
    values = copy.deepcopy(EVAL_DSEC_CLI)
    del values["metrics"]["inference_dtype"]
    # rectified: the remap index comes from the loader through
    # batch_stream, and the card's row gather is held to the CPU's plain one
    data_dir, loader_cls = eval_cli_data(
        work, "parity", {"seq_parity": dsec_sequence(
            PARITY_WINDOWS + 2, seed * 10 + 22, rectify=True)})
    runs = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        res, _, p, rdir, launches = eval_cli_run(
            f"parity_{dev}", values, data_dir, loader_cls, runid, work,
            device=dev)
        runs[dev] = (res, rdir, len(p.windows))
        if dev == DEVICE:
            all_launches.append(launches)
            check(launches["row_gather"] == 2 * PARITY_WINDOWS,
                  f"parity: {launches['row_gather']} row gathers for "
                  f"{PARITY_WINDOWS} rectified u32 windows")
        print(f"eval_cli (b) {dev}: {time.perf_counter() - t0:.1f} s")
    (r_card, d_card, n_card), (r_cpu, d_cpu, n_cpu) = runs[DEVICE], runs["cpu"]
    check(n_card == n_cpu == PARITY_WINDOWS,
          f"parity windows: card {n_card}, cpu {n_cpu}")
    check(sorted(r_card) == sorted(r_cpu), "parity: metric names")
    for name in r_cpu:
        for seq, v in r_cpu[name].items():
            a, b = float(r_card[name][seq]), float(v)
            print(f"eval_cli (b) f32 {name} {seq}: card {a:.7f} cpu {b:.7f} "
                  f"rel {abs(a - b) / max(abs(b), 1e-30):.2e}")
            check(math.isclose(a, b, rel_tol=METRIC_RTOL,
                               abs_tol=METRIC_ATOL),
                  f"eval_cli {name} {seq}: card {a} vs cpu {b}")
    pngs = [check_dsec_tree(os.path.join(d, "results", "eval_0"),
                            "seq_parity", n_card) for d in (d_card, d_cpu)]
    worst, differ, total, within = 0, 0, 0, 0
    for a, b in zip(*pngs):
        check(os.path.basename(a) == os.path.basename(b), f"{a} vs {b}")
        diff = np.abs(read_png(a).astype(np.int64)
                      - read_png(b).astype(np.int64)).max(-1)
        worst = max(worst, int(diff.max()))
        differ += int((diff > 0).sum())
        within += int((diff <= 1).sum())
        total += diff.size
    print(f"eval_cli (b) flow_bw card vs cpu: max {worst} lattice steps, "
          f"{differ / total:.4%} of {total} pixels differ, "
          f"{within / total:.4%} within one step")
    check(within / total >= PNG_SHARE,
          f"flow_bw: {within / total:.4%} of pixels within one step")

    # (c) the MVSEC per-pass protocol, every panel stored
    data_dir, loader_cls = eval_cli_data(work, "mvsec", {
        "seq_mvsec": dsec_sequence(MVSEC_PASSES + 1, seed * 10 + 23,
                                   res=MVSEC_RES, events=MVSEC_EVENTS,
                                   gt_window=MVSEC_GT_WINDOW)})
    results, wall, pipe, res_dir, launches = eval_cli_run(
        "mvsec", EVAL_MVSEC_CLI, data_dir, loader_cls, runid, work)
    all_launches.append(launches)
    check_metrics_file(res_dir, results, ["seq_mvsec"],
                       EVAL_MVSEC_CLI["metrics"]["name"])
    n_pass = len(pipe.windows)
    check(n_pass == MVSEC_PASSES, f"mvsec: {n_pass} passes")
    tree = os.path.join(res_dir, "results", "eval_0", "seq_mvsec")
    stored = {k: len(os.listdir(os.path.join(tree, k))) for k in MVSEC_PANELS}
    check(all(n == n_pass for n in stored.values()),
          f"mvsec panels stored {stored} over {n_pass} passes")
    # every pass splats and gathers: the validation update and the iwe
    # panel (compute_pol_iwe with round_flow=False, as eval_flow.py calls
    # it: a bilinear flow lookup, so no row gather on this unrectified
    # sequence)
    for _, w in pipe.windows:
        check(w["splat_bilinear"] >= 1 and w["gather_bilinear"] >= 1
              and w["gather_fused"] == 0 and w["row_gather"] == 0,
              f"mvsec pass launches {w}")
    print(f"eval_cli (c) MVSEC: {n_pass} passes, panels stored {stored}, "
          f"metrics {results}; launches {launches}")
    print(f"eval_cli (c): {wall / n_pass * 1e3:.3f} ms per GT window of CLI "
          f"wall on {gpu}")
    print(f"eval_cli (c) on {gpu}: {pipe.tm.report()}")

    total_launches = {k: sum(l[k] for l in all_launches)
                      for k in all_launches[0]}
    print(f"eval_cli phase: {time.perf_counter() - t_phase:.1f} s (data, "
          f"three protocols, the CPU's float32 run)")
    return total_launches, ms_window


# ------------------------------------------------------------ registry phase


def linear_train(rng):
    """(a) The training slice with the Linear loss: 1 warm-up and
    ``LINEAR_STEPS`` steps at B = 8 (timed after the capture), launches
    per step against ``LINEAR_LAUNCHES``; then card against CPU at B = 1
    (step loss, and the loss's flow gradient on identical flows). Returns
    the launches and ms per step."""
    import torch

    from taming_event_flow_tpu_torch.objectives import LossConfig, linear_loss
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.training import run_passes

    model, step, state = build_trainer(TRAIN_B, DEVICE, "Linear")
    windows = [train_window(rng, TRAIN_B) for _ in range(LINEAR_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for i, window in enumerate(windows):
        t0 = time.perf_counter()
        state, loss = step(state, window)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"linear step {i}: loss not finite")
        check_grads(model, f"linear step {i}")
        print(f"linear train step {i}{' (warm-up)' if i == 0 else ''}: loss "
              f"{losses[-1]:.7f}  {secs[-1] * 1e3:.2f} ms")
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    expect = {k: n * len(windows) for k, n in LINEAR_LAUNCHES.items()}
    check(launches == expect,
          f"linear training launches {launches}, expected {expect}")
    check(all(a != b for a, b in zip(losses, losses[1:])),
          f"linear: the loss did not change between steps: {losses}")
    ms_step = float(np.mean(secs[UNTIMED:])) * 1e3
    print(f"registry (a) linear train: {ms_step:.3f} ms/step (mean of "
          f"{len(secs) - UNTIMED} steps after the warm-up and the capture, "
          f"B={TRAIN_B}, {TRAIN_RES[0]}x"
          f"{TRAIN_RES[1]}, P={PASSES}, N={TRAIN_N}, f32); launches "
          f"{launches} ({ {k: v // len(windows) for k, v in launches.items()} }"
          f" per step); peak memory {peak / 2**30:.3f} GiB ({peak} B)")

    # card against CPU at B = 1: the step's loss from the same weights, and
    # the loss's flow gradient on identical flows
    w_card = train_window(rng, 1)
    w_cpu = {k: v.cpu() for k, v in w_card.items()}
    step_loss, flows = {}, None
    for tag, dev, w in (("card", DEVICE, w_card), ("cpu", "cpu", w_cpu)):
        model, step, state = build_trainer(1, dev, "Linear")
        if dev == "cpu":
            with torch.no_grad():
                flows = run_passes(model, state.carry, w["net_input"],
                                   FLOW_SCALING)[0]
        step_loss[tag] = float(step(state, w)[1])
    a, b = step_loss["card"], step_loss["cpu"]
    rel = abs(a - b) / abs(b)
    print(f"registry (a) f32 linear step loss: card {a:.8f} cpu {b:.8f} rel "
          f"{rel:.2e}")
    check(rel <= TRAIN_LOSS_RTOL, f"linear loss: card {a} vs cpu {b}")
    grads = {}
    for tag, dev, w in (("card", DEVICE, w_card), ("cpu", "cpu", w_cpu)):
        f = flows.to(dev).requires_grad_()
        linear_loss(f, w["event_list"], w["pol_mask"], w["grad_mask"],
                    LossConfig(**TRAIN_LOSS)).backward()
        grads[tag] = f.grad
    ratio = max_ratio(grads["card"], grads["cpu"])
    print(f"registry (a) f32 linear loss flow gradient on identical flows, "
          f"card vs cpu: max abs error / max |g| {ratio:.2e}")
    check(ratio <= TRAIN_GRAD_TOL, f"linear loss flow gradient off by {ratio}")
    return launches, ms_step


def linear_validation(rng):
    """(b) The DSEC eval protocol with ``metrics.warping: Linear`` over
    ``LINEAR_WINDOWS`` synthetic windows, unrectified and rectified (count
    input derived on the card through ``cur_ridx``): launches per window
    against ``LINEAR_WINDOW_LAUNCHES``, finite metrics; then one window of
    each in float32, card against CPU. Returns the launches and the ms per
    window of each route."""
    from taming_event_flow_tpu_torch.metrics import LinearValidation
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    cfg = copy.deepcopy(DSEC_CONFIG)
    cfg["metrics"]["warping"] = "Linear"
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    routes = {"unrectified": (synthetic_windows(rng, LINEAR_WINDOWS), None),
              "rectified": (rectified_windows(rng, LINEAR_WINDOWS, fwd,
                                              ridx[0]), ridx)}
    total, ms = {}, {}
    for route, (windows, r) in routes.items():
        pipe = EvalPipeline(cfg, model, device=DEVICE)
        check(isinstance(pipe.criteria, LinearValidation) and pipe.windowed
              and pipe.use_extras, "Linear DSEC config must run windowed")
        pipe.cur_ridx = r
        reset_launches()
        mets, secs = run_windows(pipe, windows)
        launches = dict(LAUNCHES)
        expect = {k: n * len(windows)
                  for k, n in LINEAR_WINDOW_LAUNCHES.items()}
        expect["row_gather"] = 0 if r is None else len(windows)
        check(launches == expect, f"linear validation {route} launches "
              f"{launches}, expected {expect}")
        for i, m in enumerate(mets):
            check_metrics(m, f"linear {route} window {i}")
            print(f"registry (b) linear {route} window {i}: "
                  f"{secs[i] * 1e3:.2f} ms  FWL {float(m['fwl']):.6f}  RSAT "
                  f"{float(m['rsat']):.6f}  AEE {float(m['aee']):.6f}")
        ms[route] = float(np.mean(secs[1:])) * 1e3
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        print(f"registry (b) linear {route}: launches {launches} "
              f"({ {k: v // len(windows) for k, v in launches.items()} } per "
              f"window), {ms[route]:.3f} ms per warm window (bf16 forward)")
        check_f32_card_vs_cpu(model, cfg, windows[:1], r)
    return total, ms


def family_forward(name, cfg, rng):
    """A family at its default width on identical weights, float32 at
    480x640 over ``FAMILY_PASSES`` passes with the carry handed on: the
    card's flows against the CPU's. Returns the worst gap (max abs error
    over max |flow|) and the card's ms per pass."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model

    model = build_model(cfg, num_bins=2, device=DEVICE, seed=0).eval()
    cpu = copy.deepcopy(model).cpu()
    carry = model.init_state(1, *RES, device=DEVICE)
    carry_cpu = cpu.init_state(1, *RES)
    worst, secs = 0.0, []
    with torch.inference_mode():
        for _ in range(FAMILY_PASSES):
            x = torch.from_numpy(rng.poisson(
                0.07, (1, *RES, 2)).astype(np.float32))
            t0 = time.perf_counter()
            flow, carry = model(x.to(DEVICE), carry)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            ref, carry_cpu = cpu(x, carry_cpu)
            check(flow.shape == ref.shape and bool(torch.isfinite(flow).all()),
                  f"{name}: flow {tuple(flow.shape)}")
            worst = max(worst, max_ratio(flow, ref))
    check(worst <= FAMILY_FLOW_TOL,
          f"{name}: card vs cpu flow off by {worst:.2e} of max |flow|")
    print(f"registry (c) {name} ({cfg}): f32 flows {tuple(flow.shape)} card "
          f"vs cpu max abs error / max |flow| {worst:.2e} over "
          f"{FAMILY_PASSES} passes; card {secs[-1] * 1e3:.2f} ms a pass")
    return worst


@contextlib.contextmanager
def count_calls(module, name):
    """Count the calls of ``module.name`` inside the ``with`` block; yields
    the count as ``[n]``."""
    import importlib

    mod = importlib.import_module(module)
    orig = getattr(mod, name)
    count = [0]

    def counted(*a, **k):
        count[0] += 1
        return orig(*a, **k)

    setattr(mod, name, counted)
    try:
        yield count
    finally:
        setattr(mod, name, orig)


def registry_train_cli(tag, change, seed, work, train_data, recurrent):
    """``train_flow_torch.train`` for one epoch at ``TRAIN_CLI_CONFIG``'s
    values with ``change`` merged in (its ``model`` replacing the
    config's), over the training-CLI phase's data. Checks finite losses,
    that every carry reset left zeros and, for a ``recurrent`` model, that
    the rollover reset a non-zero carry. Returns the run id, its launches,
    its steps and the number of ``derive_count_input`` calls."""
    import train_flow_torch
    from taming_event_flow_tpu_torch.configs import deep_merge
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.tracking import default_store
    from taming_event_flow_tpu_torch.utils import SectionTimer

    data_dir, loader_cls = train_data
    parser = train_cli_config(data_dir, seed)
    change = copy.deepcopy(change)
    model = change.pop("model", None)
    deep_merge(parser.config, change)
    if model is not None:
        parser.config["model"] = model
    parser.config["loader"]["n_epochs"] = 1
    resets, timers = [], []
    reset_carry = train_flow_torch.reset_carry

    def spy_reset(carry, mask):
        out = reset_carry(carry, mask)
        resets.append((sum(float(c.abs().sum()) for c in carry),
                       sum(float(c.abs().sum()) for c in out)))
        return out

    class Timer(SectionTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    reset_launches()
    with count_calls("taming_event_flow_tpu_torch.training.step",
                     "derive_count_input") as derived:
        runid, wall, _ = run_train_cli(parser, work, {
            "H5Loader": loader_cls, "SectionTimer": Timer,
            "reset_carry": spy_reset})
    launches = dict(LAUNCHES)
    losses = [v for _, v, _ in default_store().read_metric(runid, "loss")]
    steps = timers[0].counts.get("step_dispatch", 0)
    check(len(losses) == 1 and all(math.isfinite(v) for v in losses),
          f"{tag} train_cli: losses {losses}")
    check(steps >= 3, f"{tag} train_cli: {steps} steps")
    check(all(after == 0.0 for _, after in resets)
          and any(before > 0 for before, _ in resets) == recurrent,
          f"{tag} train_cli: carry resets (|sum| before, after) {resets}")
    print(f"registry {tag} train_cli: run {runid}, {steps} steps, epoch loss "
          f"{losses}, {wall:.2f} s; launches {launches}; carry resets "
          f"(|sum| before, after) {resets}; derive_count_input calls "
          f"{derived[0]}")
    return runid, launches, steps, derived[0]


def registry_eval_cli(tag, runid, values, eval_data, work, eval_launches,
                      recurrent):
    """``eval_flow_torch.test`` at ``EVAL_DSEC_CLI``'s values (with
    ``values`` merged in) on run ``runid`` over the registry's two
    one-window sequences: finite metrics per sequence, a ``flow_bw`` PNG
    per window, per-window launches equal to ``eval_launches``, and a
    recurrent model's carry reset from non-zero to zero at the rollover.
    Returns the launches and the number of ``derive_count_input`` calls."""
    from taming_event_flow_tpu_torch.configs import deep_merge

    data_dir, loader_cls, seqs = eval_data
    cfg = copy.deepcopy(EVAL_DSEC_CLI)
    deep_merge(cfg, copy.deepcopy(values))
    with count_calls("taming_event_flow_tpu_torch.training.step",
                     "derive_count_input") as derived:
        results, wall, pipe, res_dir, launches = eval_cli_run(
            f"registry_{tag}", cfg, data_dir, loader_cls, runid, work)
    check_metrics_file(res_dir, results, seqs, cfg["metrics"]["name"])
    tree = os.path.join(res_dir, "results", "eval_0")
    for seq in seqs:
        check_dsec_tree(tree, seq, 1)
    check(len(pipe.windows) == len(seqs),
          f"{tag} eval_cli: {len(pipe.windows)} windows")
    for seq, w in pipe.windows:
        check(w == eval_launches,
              f"{tag} eval_cli {seq}: launches {w}, expected {eval_launches}")
    rolled = [r for r in pipe.resets if r[0] > 0]
    check(all(after == 0.0 for _, after in pipe.resets)
          and (bool(rolled) == recurrent),
          f"{tag} eval_cli: carry resets (|sum| before, after) "
          f"{pipe.resets}")
    print(f"registry {tag} eval_cli: metrics {results}; {len(pipe.windows)} "
          f"GT windows, {wall * 1e3 / len(pipe.windows):.3f} ms per GT "
          f"window of CLI wall; launches {launches}; carry resets "
          f"{pipe.resets}; derive_count_input calls {derived[0]}")
    return launches, derived[0]


def registry_phase(seed, work, train_data, eval_launches, gpu):
    """The registry variants on the card at full width: (a) Linear
    training, (b) Linear validation, (c) the EVFlowNet and Fire families
    (card against CPU, then both CLIs), (d) voxel input through both CLIs.
    ``eval_launches``: the eval phase's launches per window. Returns the
    launches of every run the phase drove and its numbers."""
    import torch

    from taming_event_flow_tpu_torch.data import events_to_voxel_np
    from taming_event_flow_tpu_torch.ops import events_to_voxel
    from taming_event_flow_tpu_torch.tracking import load_checkpoint

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 3])
    runs = []
    train_launches, ms_step = linear_train(rng)
    runs.append(train_launches)
    val_launches, ms_window = linear_validation(rng)
    runs.append(val_launches)

    # (c) the families, then (d) voxel input, through both CLIs; the eval
    # data: two sequences of one GT window each (a rollover between)
    seqs = ["seq_a", "seq_b"]
    data_dir, loader_cls = eval_cli_data(work, "registry", {
        s: dsec_sequence(3, seed * 10 + 30 + i) for i, s in enumerate(seqs)})
    eval_data = (data_dir, loader_cls, seqs)
    gaps = {}
    for name, cfg in FAMILIES.items():
        gaps[name] = family_forward(name, cfg, rng)
        recurrent = name.startswith("Rec")
        runid, launches, steps, _ = registry_train_cli(
            name, {"model": cfg}, seed, work, train_data, recurrent)
        scales = 1 if "Fire" in name else 4
        expect = {k: n * scales // 4 * steps
                  for k, n in TRAIN_LAUNCHES.items()}
        check(launches == expect,
              f"{name} train_cli launches {launches}, expected {expect}")
        runs.append(launches)
        launches, _ = registry_eval_cli(name, runid, {}, eval_data, work,
                                        eval_launches, recurrent)
        runs.append(launches)

    change = {"data": {"voxel": VOXEL_BINS}}
    runid, launches, steps, derived = registry_train_cli(
        "voxel", change, seed, work, train_data, True)
    check(derived == 0, f"voxel train_cli derived the count input {derived}x")
    check(launches == {k: n * steps for k, n in TRAIN_LAUNCHES.items()},
          f"voxel train_cli launches {launches}")
    runs.append(launches)
    ckpt, _ = load_checkpoint(runid, map_location=DEVICE)
    c_in = ckpt["model"]["arch.encoders.0.conv.conv2d.weight"].shape[1]
    check(c_in == VOXEL_BINS, f"voxel model takes {c_in} input channels")
    launches, derived = registry_eval_cli("voxel", runid, change, eval_data,
                                          work, eval_launches, True)
    check(derived == 0, f"voxel eval_cli derived the count input {derived}x")
    runs.append(launches)

    # the device twin of the loader's voxel grid, at the DSEC size
    n = EVAL_CLI_EVENTS // PASSES
    xs = rng.integers(0, RES[1], n).astype(np.float32)
    ys = rng.integers(0, RES[0], n).astype(np.float32)
    ts = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    ps = rng.choice([-1.0, 1.0], n).astype(np.float32)
    got = events_to_voxel(*(torch.from_numpy(a).to(DEVICE)
                            for a in (xs, ys, ts, ps)), VOXEL_BINS, RES)
    ref = events_to_voxel_np(xs, ys, ts, ps, VOXEL_BINS, RES)
    err = float(np.abs(got.cpu().numpy() - ref).max())
    check(err <= KERNEL_ATOL, f"events_to_voxel card vs host {err}")
    print(f"registry (d) voxel: {c_in} input channels; events_to_voxel on "
          f"the card vs the host grid at {RES[0]}x{RES[1]}, {n} events: max "
          f"abs err {err:.2e}")

    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    print(f"registry phase: {time.perf_counter() - t_phase:.1f} s on {gpu}; "
          f"launches {total}; family flow gaps {gaps}")
    return total, ms_step, ms_window


# ------------------------------------------------ multi-device phase (10)

PAR_STEPS = 2  # event-parallel steps each mesh takes, parameters compared
PAR_WINDOWS = 3  # unrectified and rectified DSEC windows of (d) each
PAR_TIMEOUT = 900.0  # seconds the ranks of one spawn may take
PAR_CLI_PAD = 16384  # loader.n_events_pad of the CLI runs of (e)
PAR_EVAL_FRAMES = 4  # GT frames of each eval CLI sequence of (e): 2 windows
PAR_LOSS_RTOL = 1e-5  # the CLI's first steps' losses, 2 ranks against 1
# the CLI's epoch loss, 2 ranks against 1: a one-rank run repeats bit for
# bit (phase 14), but the event axis splits each splat and loss sum into
# two shards and the data axis sums the gradient over two ranks, so the
# float sums take another order; the loss's gradient jumps in the flows and
# Adam's first updates are sign-like, so that reordering grows over the
# steps: two-rank runs lay within 2.41e-3 of a one-rank run over 4 steps
# (PERF.md, Findings)
PAR_EPOCH_RTOL = 1e-2
STEEP_G = 1e-7  # |g| under 10 x Adam's eps: the first update is steep in g
# each kernel's rows among its launch's arguments: (index of B or None, of M)
LAUNCH_ROWS = {"splat_bilinear": (3, 4), "gather_bilinear": (3, 4),
               "gather_fused": (5, 6), "row_gather": (None, 3)}
# (e): the training CLI's changes; the one-rank runs drop "parallel". The
# data-axis run streams one lane a rank from its shard of the two files,
# whose augmentation draws are seeded per shard: no augmentation there
PAR_CLI_CASES = {
    "event": {"parallel": {"event": 2},
              "loader": {"n_events_pad": PAR_CLI_PAD}},
    "data": {"parallel": {"data": 2},
             "loader": {"batch_size": 2, "augment": [], "augment_prob": [],
                        "n_events_pad": PAR_CLI_PAD}},
}


@contextlib.contextmanager
def launch_rows():
    """Record ``(kernel, B, M)`` of every kernel launch inside the block
    (the counters count them all the same)."""
    from taming_event_flow_tpu_torch.ops import cuda_warp

    real = cuda_warp._launch
    rows = []

    def spy(kernel, counter, dev, *args):
        real(kernel, counter, dev, *args)
        ib, im = LAUNCH_ROWS[counter]
        rows.append((counter, 1 if ib is None else args[ib], args[im]))

    cuda_warp._launch = spy
    try:
        yield rows
    finally:
        cuda_warp._launch = real


def launch_delta(before):
    from taming_event_flow_tpu_torch.ops import LAUNCHES

    return {k: v - before.get(k, 0) for k, v in LAUNCHES.items()}


def par_train_window(seed):
    """The training cell's window, the same in every process."""
    return train_window(np.random.default_rng([seed, 10]), TRAIN_B)


def par_eval_windows(seed):
    """(d)'s unrectified and rectified DSEC windows and the index."""
    rng = np.random.default_rng([seed, 11])
    plain = synthetic_windows(rng, PAR_WINDOWS)
    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    return plain, rectified_windows(rng, PAR_WINDOWS, fwd, ridx[0]), ridx


def par_eval_specs(seed):
    return {"seq_rect": dsec_sequence(PAR_EVAL_FRAMES, seed * 10 + 30,
                                      rectify=True),
            "seq_plain": dsec_sequence(PAR_EVAL_FRAMES, seed * 10 + 31)}


def eval_windows_on(pipe, windows, ridx):
    """The windows through ``pipe``: metrics, launches and seconds of each
    window."""
    from taming_event_flow_tpu_torch.ops import LAUNCHES

    pipe.cur_ridx = ridx
    mets, launches, secs = [], [], []
    for w in windows:
        before = dict(LAUNCHES)
        (m,), (sec,) = run_windows(pipe, [w])
        launches.append(launch_delta(before))
        mets.append({k: float(m[k]) for k in ("fwl", "rsat", "aee")})
        secs.append(sec)
    return {"metrics": mets, "launches": launches, "secs": secs}


def recording(make):
    """A stand-in for a step builder that records every step's loss in
    ``.losses`` of the steps it built (``.steps``)."""
    def build(*a, **k):
        step = make(*a, **k)

        def rec(state, window):
            state, loss = step(state, window)
            rec.losses.append(float(loss))
            return state, loss

        rec.losses = []
        build.steps.append(rec)
        return rec

    build.steps = []
    return build


def par_cli_parser(data_dir, seed, change, ranks):
    """``TRAIN_CLI_CONFIG``'s values for one epoch with ``change`` (its
    ``parallel`` section only when ``ranks`` > 1)."""
    from taming_event_flow_tpu_torch.configs import deep_merge

    parser = train_cli_config(data_dir, seed)
    parser.config["loader"]["n_epochs"] = 1
    change = copy.deepcopy(change)
    if ranks == 1:
        change.pop("parallel")
    deep_merge(parser.config, change)
    return parser


def epoch_losses(work, runid):
    from taming_event_flow_tpu_torch.tracking import TrackingStore

    return [v for _, v, _ in TrackingStore(work).read_metric(runid, "loss")]


def build_mesh_trainer(mesh):
    """``build_trainer``'s model and optimizer (seed 0) replicated over
    ``mesh``, its train step under the mesh and this rank's carry."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.parallel import replicate, shard_state
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    opt = build_optimizer(TRAIN_OPT, model.parameters(),
                          clip_grad=TRAIN_CLIP, device=DEVICE)
    replicate(model, opt)
    step = make_train_step(model, opt, LossConfig(**TRAIN_LOSS),
                           flow_scaling=FLOW_SCALING, res=TRAIN_RES,
                           mesh=mesh)
    state = shard_state(
        init_train_state(model, TRAIN_B, *TRAIN_RES, device=DEVICE), mesh)
    return model, step, state


def mesh_flow_loss(mesh, window, flows):
    """The loss and its flow gradient on the given flows, with this rank's
    lanes and events: the loss summed over the data axis, the gradient
    averaged over the event axis (on the event axis's rank 0; each rank
    alone holds E times its shard's part)."""
    import torch
    import torch.distributed as dist

    from taming_event_flow_tpu_torch.objectives import (
        LossConfig,
        iterative_loss,
    )
    from taming_event_flow_tpu_torch.parallel.mesh import take

    b0, b1 = mesh.lanes(TRAIN_B)
    e0, e1 = mesh.events(TRAIN_N)
    f = torch.from_numpy(flows[:, :, b0:b1]).to(DEVICE).requires_grad_()
    ev, pol, gm = (take(take(window[k], 1, b0, b1), 2, e0, e1)
                   for k in ("event_list", "pol_mask", "grad_mask"))
    loss = iterative_loss(f, ev, pol, gm, LossConfig(**TRAIN_LOSS),
                          event_axis=mesh.event_group)
    loss.backward()
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=mesh.data_group)
    grad = f.grad
    dist.all_reduce(grad, group=mesh.event_group)
    grad /= mesh.n_event
    return float(loss), (grad.cpu().numpy() if mesh.event_index == 0
                         else None)


def mesh_steps(mesh, window):
    """``PAR_STEPS`` event-parallel steps on this rank's part of the
    window: losses, seconds, launches and ``(kernel, B, M)`` rows of each
    step; the parameters are checked bitwise equal on every rank."""
    import torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES
    from taming_event_flow_tpu_torch.parallel import (
        check_replicated,
        shard_window_2d,
    )

    model, step, state = build_mesh_trainer(mesh)
    local = shard_window_2d(window, mesh)
    out = {"losses": [], "secs": [], "launches": [], "rows": []}
    for _ in range(PAR_STEPS):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with launch_rows() as rows:
            state, loss = step(state, local)
        out["losses"].append(float(loss))
        torch.cuda.synchronize()
        out["secs"].append(time.perf_counter() - t0)
        out["launches"].append(launch_delta(before))
        out["rows"].append(rows)
    params = list(model.state_dict().values())
    check_replicated(params)
    out["checksum"] = float(sum(p.double().sum() for p in params))
    return out


def nccl_world_of_one(rank, world, url, seed):
    """(a): the event-parallel step on the ``(1, 1)`` mesh over NCCL,
    against ``make_train_step`` in the same process from the same weights:
    the all-reduced gradients inside the step must be bitwise the local
    ones."""
    import torch
    import torch.distributed as dist

    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        kernel_build,
        reset_launches,
        set_deterministic,
        set_tf32,
    )
    from taming_event_flow_tpu_torch.parallel import (
        init_distributed,
        make_event_mesh,
    )
    from taming_event_flow_tpu_torch.training import step as train_step

    check(init_distributed({"coordinator": url, "num_processes": world,
                            "process_id": rank}, device="cuda:0"),
          "no process group")
    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    out = {"backend": dist.get_backend()}
    check(out["backend"] == "nccl", f"backend {out['backend']}")
    window = par_train_window(seed)
    model_p, step_p, state_p = build_trainer(TRAIN_B, DEVICE)
    state_p, loss_p = step_p(state_p, window)
    grads_p = {n: p.grad.detach().clone()
               for n, p in model_p.named_parameters()}

    identity = []
    # the name the train step looks up
    real = train_step.reduce_gradients

    def spy(params, mesh):
        before = [p.grad.clone() for p in params]
        real(params, mesh)
        identity.append(all(torch.equal(b, p.grad)
                            for b, p in zip(before, params)))

    train_step.reduce_gradients = spy
    try:
        reset_launches()
        mesh = make_event_mesh(1, 1)
        model, step, state = build_mesh_trainer(mesh)
        secs = []
        for i in range(1 + PAR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, window)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if i == 0:
                loss_m = float(loss)
                grad_gap, param_bad = 0.0, 0
                for n, p in model.named_parameters():
                    g = grads_p[n]
                    grad_gap = max(grad_gap, float(
                        (p.grad - g).abs().max() / g.abs().max()))
                    want = dict(model_p.named_parameters())[n].detach()
                    tol = torch.where(g.abs() < STEEP_G,
                                      torch.full_like(want, TRAIN_OPT["lr"]),
                                      1e-6 + 2e-3 * want.abs())
                    param_bad += int(((p.detach() - want).abs() > tol).sum())
        out["launches"] = dict(LAUNCHES)
    finally:
        train_step.reduce_gradients = real
    out.update(identity=identity, loss=loss_m, loss_plain=float(loss_p),
               grad_gap=grad_gap, param_bad=param_bad, secs=secs)
    return out


def par_cli_rank(seed, work, runid):
    """(e) on one rank: both training CLI cases, then the eval CLI; with
    the kernel launches of the three runs (``eval_cli_run`` resets the
    counters for its own)."""
    import train_flow_torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES

    out = {}
    before = dict(LAUNCHES)
    data_dir, loader_cls, _ = cli_train_data(work, seed, write=False)
    for tag, change in PAR_CLI_CASES.items():
        parser = par_cli_parser(data_dir, seed, change, ranks=2)
        root = os.path.join(work, f"par_{tag}_2")
        os.makedirs(root, exist_ok=True)
        steps = recording(train_flow_torch.make_train_step)
        trained, wall, _ = run_train_cli(parser, root, {
            "H5Loader": loader_cls, "make_train_step": steps})
        out[tag] = (trained, wall, steps.steps[0].losses)
    launches = launch_delta(before)
    data_dir, loader_cls = eval_cli_data(work, "par", par_eval_specs(seed),
                                         write=False)
    results, wall, pipe, res_dir, eval_launches = eval_cli_run(
        "par2", EVAL_DSEC_CLI, data_dir, loader_cls, runid, work)
    out["launches"] = {k: n + eval_launches[k] for k, n in launches.items()}
    out["eval"] = {"results": results, "wall": wall, "res_dir": res_dir,
                   "windows": pipe.windows, "sharded":
                   pipe.eval_mesh is not None}
    return out


def mesh_rank(rank, world, url, spec):
    """(b)-(e), or (b)-(d) for (f), on one rank of ``spec["backend"]``:
    gloo ranks share ``cuda:0``, NCCL ranks take one card each. Returns
    what it measured and the kernel counters of the whole run."""
    import torch.distributed as dist

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        kernel_build,
        reset_launches,
        set_deterministic,
        set_tf32,
    )
    from taming_event_flow_tpu_torch.parallel import (
        init_distributed,
        make_event_mesh,
    )
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    nccl = spec["backend"] == "nccl"
    check(init_distributed(
        {"coordinator": url, "num_processes": world, "process_id": rank},
        backend=spec["backend"], device=f"cuda:{rank if nccl else 0}"),
        "no process group")
    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    reset_launches()
    out = {"backend": dist.get_backend()}
    window = par_train_window(spec["seed"])
    for tag, shape in (("event", (1, 2)), ("data", (2, 1))):
        mesh = make_event_mesh(*shape)
        out[tag] = {"flow": mesh_flow_loss(mesh, window, spec["flows"]),
                    "steps": mesh_steps(mesh, window)}
    plain, rect, ridx = par_eval_windows(spec["seed"])
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    check(pipe.eval_mesh is not None, "the eval pipeline did not shard")
    out["eval"] = {"plain": eval_windows_on(pipe, plain, None),
                   "rect": eval_windows_on(pipe, rect, ridx),
                   "slots": pipe.criteria.n_events}
    out["launches"] = dict(LAUNCHES)
    if spec["clis"]:
        out["cli"] = par_cli_rank(spec["seed"], spec["work"], spec["runid"])
        for k, n in out["cli"]["launches"].items():
            out["launches"][k] += n
    return out


def parallel_references(seed):
    """The one-process runs (b)-(d) hold their ranks to, on the card: the
    training cell's loss and flow gradient on given flows, two steps with
    the rows of each launch, and (d)'s eval windows."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import (
        LossConfig,
        iterative_loss,
    )
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline
    from taming_event_flow_tpu_torch.training import run_passes

    ref = {}
    window = par_train_window(seed)
    model, step, state = build_trainer(TRAIN_B, DEVICE)
    with torch.no_grad():
        flows, _ = run_passes(model, state.carry, window["net_input"],
                              FLOW_SCALING)
    f = flows.clone().requires_grad_()
    loss = iterative_loss(f, window["event_list"], window["pol_mask"],
                          window["grad_mask"], LossConfig(**TRAIN_LOSS))
    loss.backward()
    ref.update(flows=flows.cpu().numpy(), loss=float(loss),
               grad=f.grad.cpu().numpy(), step_losses=[], rows=[])
    for _ in range(PAR_STEPS):
        # eager, as the mesh steps run: a replay calls no launch wrapper
        with launch_rows() as rows:
            state, loss = step.eager(state, window)
        ref["step_losses"].append(float(loss))
        ref["rows"].append(rows)

    plain, rect, ridx = par_eval_windows(seed)
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    ref["eval"] = {"plain": eval_windows_on(pipe, plain, None),
                   "rect": eval_windows_on(pipe, rect, ridx)}
    return ref


def cli_references(seed, work, runid):
    """(e)'s one-rank runs of both CLIs on the card: each training case's
    epoch loss, wall seconds and step losses, and the eval CLI's results
    and their directory."""
    import train_flow_torch

    data_dir, loader_cls, _ = cli_train_data(work, seed, write=False)
    ref = {}
    for tag, change in PAR_CLI_CASES.items():
        root = os.path.join(work, f"par_{tag}_1")
        os.makedirs(root, exist_ok=True)
        steps = recording(train_flow_torch.make_train_step)
        rid, wall, _ = run_train_cli(
            par_cli_parser(data_dir, seed, change, ranks=1), root,
            {"H5Loader": loader_cls, "make_train_step": steps})
        ref[tag] = (epoch_losses(root, rid), wall, steps.steps[0].losses)
    data_dir, loader_cls = eval_cli_data(work, "par", par_eval_specs(seed))
    results, wall, _, res_dir, _ = eval_cli_run(
        "par1", EVAL_DSEC_CLI, data_dir, loader_cls, runid, work)
    ref["eval"] = {"results": results, "wall": wall, "res_dir": res_dir}
    return ref


def flow_bw_files(res_dir):
    tree = os.path.join(res_dir, "results", "eval_0")
    return {seq: sorted(os.listdir(os.path.join(tree, seq, "flow_bw")))
            for seq in sorted(os.listdir(tree))}


def check_mesh_results(out, ref, label):
    """(b)-(d) of ranks ``out`` against the one-process ``ref``; prints
    the times under ``label``. Returns the ms per step and per window."""
    times = {}
    for tag, (n_data, n_event) in (("event", (1, 2)), ("data", (2, 1))):
        ranks = [r[tag] for r in out]
        # the loss and its flow gradient on identical flows
        loss = ranks[0]["flow"][0]
        if n_data == 1:
            grad = ranks[0]["flow"][1]
        else:
            grad = np.concatenate([r["flow"][1] for r in ranks], axis=2)
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        gap = float(np.abs(grad - ref["grad"]).max()
                    / np.abs(ref["grad"]).max())
        print(f"phase 10 {label} {tag} axis 2: loss on identical flows "
              f"{loss:.7f} vs {ref['loss']:.7f} (rel {rel:.2e}), flow "
              f"gradient gap {gap:.2e} of max |g|")
        check(rel <= TRAIN_LOSS_RTOL, f"{label} {tag}: loss rel {rel:.2e}")
        check(gap <= TRAIN_GRAD_TOL, f"{label} {tag}: flow gradient {gap}")
        # the full step
        steps = [r["steps"] for r in ranks]
        rel = abs(steps[0]["losses"][0] - ref["step_losses"][0]) \
            / abs(ref["step_losses"][0])
        check(rel <= TRAIN_LOSS_RTOL, f"{label} {tag}: step loss rel {rel}")
        check(len({s["checksum"] for s in steps}) == 1,
              f"{label} {tag}: parameters differ between ranks")
        for s in steps:
            check(all(n == TRAIN_LAUNCHES for n in s["launches"]),
                  f"{label} {tag}: launches a step {s['launches']}")
            for got, want in zip(s["rows"], ref["rows"]):
                # as multisets: the backward may take independent branches
                # in another order
                shard = [(k, b // n_data, m // n_event) for k, b, m in want]
                check(sorted(got) == sorted(shard), f"{label} {tag}: launch "
                      "rows differ from the one-process step's shard")
        ms = [1e3 * t for s in steps for t in s["secs"][1:]]
        times[tag] = float(np.mean(ms))
        print(f"phase 10 {label} {tag} axis 2: step losses "
              f"{steps[0]['losses']} (one process {ref['step_losses']}; "
              f"rel {rel:.2e}); parameters bitwise equal on every rank; "
              f"launches a step {steps[0]['launches'][0]}, each on "
              f"{'N/2 events' if n_data == 1 else 'B/2 lanes'}; "
              f"{times[tag]:.3f} ms/step")
    # (d) the sharded DSEC eval
    for kind, rows in (("plain", 0), ("rect", 1)):
        want = ref["eval"][kind]
        for r in out:
            got = r["eval"][kind]
            for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
                for k in ("fwl", "rsat", "aee"):
                    check(math.isclose(g[k], w[k], rel_tol=METRIC_RTOL,
                                       abs_tol=METRIC_ATOL),
                          f"{label} eval {kind} window {i} {k}: {g[k]} vs "
                          f"{w[k]}")
            expect = {"splat_bilinear": 2, "gather_bilinear": PASSES,
                      "gather_fused": 0, "row_gather": rows}
            check(all(n == expect for n in got["launches"]),
                  f"{label} eval {kind}: launches {got['launches']}")
        ms = [1e3 * t for r in out for t in r["eval"][kind]["secs"][1:]]
        times[f"eval_{kind}"] = float(np.mean(ms))
        gaps = max(abs(g[k] - w[k]) / abs(w[k])
                   for g, w in zip(out[0]["eval"][kind]["metrics"],
                                   want["metrics"])
                   for k in ("fwl", "rsat", "aee"))
        print(f"phase 10 {label} eval {kind}: {out[0]['eval']['slots']} "
              f"slots a rank; FWL/RSAT/AEE within rel {gaps:.2e} of one "
              f"process; launches a window "
              f"{out[0]['eval'][kind]['launches'][0]}; "
              f"{times[f'eval_{kind}']:.3f} ms/window")
    return times


def check_cli_results(out, ref, work):
    """(e): both CLIs on 2 ranks against their one-rank runs ``ref``."""
    for tag in PAR_CLI_CASES:
        runid, wall, steps = out[0]["cli"][tag]
        check(out[1]["cli"][tag][0] == "rank1", f"(e) {tag}: rank 1's id")
        check(out[1]["cli"][tag][2] == steps,
              f"(e) {tag}: the ranks' step losses differ")
        got = epoch_losses(os.path.join(work, f"par_{tag}_2"), runid)
        want, wall1, want_steps = ref[tag]
        check(len(got) == len(want) == 1, f"(e) {tag}: losses {got} {want}")
        check(len(steps) == len(want_steps) >= PAR_STEPS,
              f"(e) {tag}: steps {steps} {want_steps}")
        rel = abs(got[0] - want[0]) / abs(want[0])
        rel_steps = max(abs(a - b) / abs(b) for a, b in
                        zip(steps[:PAR_STEPS], want_steps[:PAR_STEPS]))
        print(f"phase 10 (e) train_cli {tag}: 2 ranks on one card, epoch "
              f"loss {got}, steps {steps} ({wall:.2f} s); one rank {want}, "
              f"steps {want_steps} ({wall1:.2f} s); first {PAR_STEPS} "
              f"steps rel {rel_steps:.2e}, epoch rel {rel:.2e}")
        check(rel_steps <= PAR_LOSS_RTOL,
              f"(e) {tag}: first steps' losses rel {rel_steps:.2e}")
        check(rel <= PAR_EPOCH_RTOL, f"(e) {tag}: epoch loss rel {rel:.2e}")
    e2, e1 = out[0]["cli"]["eval"], ref["eval"]
    check(out[1]["cli"]["eval"]["results"] is None,
          "(e) eval: rank 1 returned results")
    check(e2["sharded"], "(e) eval: the CLI's pipeline did not shard")
    for metric, seqs in e1["results"].items():
        for seq, v in seqs.items():
            a, b = float(e2["results"][metric][seq]), float(v)
            check(math.isclose(a, b, rel_tol=METRIC_RTOL,
                               abs_tol=METRIC_ATOL),
                  f"(e) eval {metric} {seq}: {a} vs {b}")
    files = sorted(f for f in os.listdir(e2["res_dir"]) if f.endswith(".yml"))
    check(files == ["eval_0.yml", "metrics_0.yml"],
          f"(e) eval: result files {files} (rank 0 alone writes)")
    check(flow_bw_files(e2["res_dir"]) == flow_bw_files(e1["res_dir"]),
          "(e) eval: flow_bw file lists differ")
    for r in out:
        for seq, w in r["cli"]["eval"]["windows"]:
            expect = {"splat_bilinear": 2, "gather_bilinear": PASSES,
                      "gather_fused": 0,
                      "row_gather": int(seq == "seq_rect")}
            check(w == expect, f"(e) eval {seq}: launches {w}")
    print(f"phase 10 (e) eval_cli: 2 ranks on one card {e2['results']} "
          f"({e2['wall']:.2f} s), one rank {e1['results']} "
          f"({e1['wall']:.2f} s); flow_bw files "
          f"{ {k: len(v) for k, v in flow_bw_files(e2['res_dir']).items()} }"
          f" on rank 0 alone")


def parallel_phase(seed, work, runid):
    """Phase 10: the multi-device layer. (a) NCCL over a world of one; (b)
    the event axis and (c) the data axis on two gloo ranks that share
    ``cuda:0``; (d) the event-sharded DSEC eval and (e) both CLIs on those
    ranks; (f) (b)-(d) over NCCL with one card a rank, when there are two.
    Returns the ranks' kernel counters and the ms of each shared-card case."""
    import torch

    from taming_event_flow_tpu_torch.parallel.spawn import run_ranks

    t_phase = time.perf_counter()
    ref = parallel_references(seed)
    ref_cli = cli_references(seed, work, runid)
    print("phase 10 references on one process: "
          f"{time.perf_counter() - t_phase:.1f} s")
    rdv = tempfile.mkdtemp(prefix="rdv_", dir=work)

    def url(tag):
        return "file://" + os.path.join(rdv, tag)

    launches = {k: 0 for k in TRAIN_LAUNCHES}
    (a,) = run_ranks(nccl_world_of_one, 1, (url("a"), seed),
                     timeout=PAR_TIMEOUT)
    rel = abs(a["loss"] - a["loss_plain"]) / abs(a["loss_plain"])
    print(f"phase 10 (a) NCCL, world of one: all-reduced gradients bitwise "
          f"the local ones in {len(a['identity'])} steps "
          f"({all(a['identity'])}); step loss {a['loss']:.7f} vs "
          f"make_train_step {a['loss_plain']:.7f} (rel {rel:.2e}); "
          f"gradients within {a['grad_gap']:.2e} of max |g|; "
          f"{a['param_bad']} parameters outside tolerance; "
          f"{float(np.mean(a['secs'][1:])) * 1e3:.3f} ms/step")
    check(a["identity"] and all(a["identity"]),
          "(a) the one-rank all-reduce changed the gradients")
    check(rel <= TRAIN_LOSS_RTOL, f"(a) loss rel {rel:.2e}")
    check(a["grad_gap"] <= TRAIN_GRAD_TOL, f"(a) gradient {a['grad_gap']}")
    check(a["param_bad"] == 0, f"(a) {a['param_bad']} parameters off")
    for k in launches:
        launches[k] += a["launches"][k]

    spec = {"backend": "gloo", "seed": seed, "flows": ref["flows"],
            "clis": True, "work": work, "runid": runid}
    t0 = time.perf_counter()
    out = run_ranks(mesh_rank, 2, (url("shared"), spec), timeout=PAR_TIMEOUT)
    print(f"phase 10 (b)-(e): two gloo ranks on one card, "
          f"{time.perf_counter() - t0:.1f} s")
    times = check_mesh_results(out, ref, "(b)-(d) two ranks on one card")
    check_cli_results(out, ref_cli, work)
    for r in out:
        for k in launches:
            launches[k] += r["launches"][k]

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        spec = dict(spec, backend="nccl", clis=False)
        out = run_ranks(mesh_rank, 2, (url("cards"), spec),
                        timeout=PAR_TIMEOUT)
        check_mesh_results(out, ref, "(f) NCCL, one card a rank")
        for r in out:
            for k in launches:
                launches[k] += r["launches"][k]
    else:
        print(f"phase 10 (f): skipped: {n_cards} card on this machine, "
              "NCCL over one card a rank needs two")
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s; times from "
          "ranks sharing one card are not a scaling figure")
    return launches, times


# ------------------------------------------------ options and wires phase

OPT_STEPS = 3  # steps of each training option, after one warm-up
# model options through the training cell; each keeps the Iterative
# loss's launches a step
MODEL_OPTIONS = {"norm_in": {"norm": "IN"},
                 "compute_bf16": {"compute_dtype": "bfloat16"}}
# the batched sweep's launches a step at the training cell (S = 4 flow
# scales, P = 10, one loss scale, "two"): one splat per (scale, window) in
# place of 11, so 4 forward splats and the 4 fused gathers behind them
BATCHED_LAUNCHES = {"splat_bilinear": 84, "gather_bilinear": 80,
                    "gather_fused": 76, "row_gather": 0}
# compute_dtype bf16 flows vs the f32 model's, x max|flow|: a few times the
# gap the card measured (8.8e-3), and at least a ninth of it, so that flows
# computed in float32 fail
BF16_FLOW_TOL = (1e-3, 3e-2)
WIRES = {"plain": {"packed_wire": False},
         "packed": {"packed_wire": True, "u32_wire": False},
         "u32": {"packed_wire": True, "u32_wire": True}}
WIRE_WINDOWS = 3  # DSEC windows per data kind
WIRE_STEP_RTOL = 1e-5  # the training CLI's first steps, packed vs plain
RING_WINDOWS = 30  # the staging ring check's rectified sequence
RING_GROW_AT = 15  # its window whose fourth pass overflows the bucket


def option_steps(tag, rng, model_change=None, loss_change=None,
                 expect=TRAIN_LAUNCHES, phase="options"):
    """The training cell (B = 8) with a model or loss option: one warm-up
    and ``OPT_STEPS`` steps, timed after the capture. Checks finite,
    changing losses, every parameter's gradient and ``expect`` launches a
    step; returns the launches, ms/step and peak memory (GiB). ``phase``
    heads its line."""
    import torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches

    model, step, state = build_trainer(
        TRAIN_B, DEVICE, model_config=dict(MODEL_CONFIG, **(model_change
                                                             or {})),
        loss=dict(TRAIN_LOSS, **(loss_change or {})))
    windows = [train_window(rng, TRAIN_B) for _ in range(OPT_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, secs = [], []
    for i, window in enumerate(windows):
        t0 = time.perf_counter()
        state, loss = step(state, window)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(loss))
        check(math.isfinite(losses[-1]), f"{tag} step {i}: loss not finite")
        check_grads(model, f"{tag} step {i}")
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: n * len(windows) for k, n in expect.items()}
    check(launches == want, f"{tag}: launches {launches}, expected {want}")
    check(all(a != b for a, b in zip(losses, losses[1:])),
          f"{tag}: the loss did not change between steps: {losses}")
    ms = float(np.mean(secs[UNTIMED:])) * 1e3
    print(f"{phase} {tag}: losses {[f'{v:.7f}' for v in losses]}; "
          f"{ms:.3f} ms/step (mean of {len(secs) - UNTIMED} steps after the "
          f"warm-up and the capture, B={TRAIN_B}); "
          f"launches a step {expect}; peak memory {peak:.3f} GiB")
    del model, step, state, windows
    torch.cuda.empty_cache()
    return launches, ms, peak


def model_option_flows(rng):
    """(a): ``norm: IN`` in float32, card against CPU, and ``compute_dtype:
    bfloat16`` against the float32 model (same seed, same weights) on the
    card: two passes of a DSEC count input at 480x640 through the
    full-width RecEVFlowNet."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import derive_count_input

    xs = [derive_count_input(torch.from_numpy(b["event_list"]), RES)
          for b in synthetic_windows(rng, 1)[0][:2]]  # [1, H, W, 2] each

    def run(model, dev):
        carry = model.init_state(1, *RES, device=dev)
        out = []
        with torch.no_grad():
            for x in xs:
                x = x.to(dev)
                flows, carry = model(x, carry)
                out.append(flows)
        return torch.stack(out), carry

    model = build_model(dict(MODEL_CONFIG, norm="IN"), num_bins=2,
                        device=DEVICE, seed=0)
    card, _ = run(model, torch.device(DEVICE))
    cpu, _ = run(copy.deepcopy(model).cpu(), torch.device("cpu"))
    gap = float((card.cpu() - cpu).abs().max() / cpu.abs().max())
    print(f"options (a) norm IN float32 flows at {RES[0]}x{RES[1]}, card vs "
          f"CPU: max abs err / max |flow| {gap:.3e} (max |flow| "
          f"{float(cpu.abs().max()):.4f})")
    check(gap <= FAMILY_FLOW_TOL, f"norm IN card vs cpu {gap:.3e}")
    f32 = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    bf = build_model(dict(MODEL_CONFIG, compute_dtype="bfloat16"),
                     num_bins=2, device=DEVICE, seed=0)
    ref, _ = run(f32, torch.device(DEVICE))
    got, carry = run(bf, torch.device(DEVICE))
    check(got.dtype == torch.float32
          and all(c.dtype == torch.float32 for c in carry)
          and all(p.dtype == torch.float32 for p in bf.parameters()),
          "compute_dtype: flows, carry and parameters must stay float32")
    gap = float((got - ref).abs().max() / ref.abs().max())
    print(f"options (a) compute_dtype bfloat16 flows vs the float32 model on "
          f"the card: max abs err / max |flow| {gap:.3e}; flows and carry "
          f"float32")
    lo, hi = BF16_FLOW_TOL
    check(lo <= gap <= hi, f"compute_dtype bf16 gap {gap:.3e}")


def batched_sweep_check(rng):
    """(b), first half: the batched sweep's loss and flow gradient against
    the looped sweep on identical flows at the training cell, on the
    card."""
    import torch

    from taming_event_flow_tpu_torch.objectives import (
        LOSS_REGISTRY,
        LossConfig,
    )
    from taming_event_flow_tpu_torch.training.step import run_passes

    model, _, state = build_trainer(TRAIN_B, DEVICE)
    window = train_window(rng, TRAIN_B)
    with torch.no_grad():
        flows, _ = run_passes(model, state.carry, window["net_input"],
                              FLOW_SCALING)
    del model

    def value_and_grad(cfg):
        f = flows.clone().requires_grad_()
        loss = LOSS_REGISTRY["Iterative"](
            f, window["event_list"], window["pol_mask"], window["grad_mask"],
            cfg)
        loss.backward()
        return float(loss.detach()), f.grad

    base = LossConfig(**TRAIN_LOSS)
    ref_loss, ref_g = value_and_grad(base)
    loss, g = value_and_grad(base._replace(batched_sweep=True))
    rel = abs(loss - ref_loss) / abs(ref_loss)
    gap = float((g - ref_g).abs().max() / ref_g.abs().max())
    print(f"options (b) batched_sweep: loss {loss:.7f} vs looped "
          f"{ref_loss:.7f} (rel {rel:.2e}); flow gradient max abs err / max "
          f"|g| {gap:.2e}")
    check(rel <= TRAIN_LOSS_RTOL, f"batched_sweep: loss rel {rel:.2e}")
    check(gap <= TRAIN_GRAD_TOL, f"batched_sweep: flow gradient {gap:.2e}")


def stage_bytes(pipe, bufs):
    """Bytes one window uploads on ``pipe``'s wire (the forward map and
    the rectification index are on the card already, once a sequence)."""
    import torch

    staged = pipe.stage_window(bufs)
    parts = list(staged) + [pipe.stage_pols(bufs)]
    if isinstance(staged[1], dict):
        parts += [v for k, v in staged[1].items() if k != "rect"]
    return sum(t.numel() * t.element_size() for t in parts
               if torch.is_tensor(t))


def wire_windows(rng):
    """The DSEC cell's windows, unrectified and rectified, with what the
    plain wire ships: the host-built count input, event mask and polarity
    masks. Returns ``{kind: (windows, ridx, rect)}``."""
    from taming_event_flow_tpu_torch.data import events_to_channels_np

    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    out = {"unrectified": (synthetic_windows(rng, WIRE_WINDOWS), None, None),
           "rectified": (rectified_windows(rng, WIRE_WINDOWS, fwd, ridx[0]),
                         ridx, fwd)}
    for windows, _, _ in out.values():
        for passes in windows:
            for b in passes:
                ev = b["event_list"][0]
                if "net_input" not in b:
                    net = events_to_channels_np(ev[:, 2], ev[:, 1], ev[:, 3],
                                                RES).astype(np.float32)
                    b["net_input"] = net[None]
                    b["event_mask"] = (net.sum(-1, keepdims=True) > 0
                                       ).astype(np.float32)[None]
                b["event_list_pol_mask"] = np.stack(
                    [ev[:, 3] > 0, ev[:, 3] < 0], -1).astype(np.float32)[None]
    return out


def wire_phase(rng):
    """(c): the DSEC cell on the plain, packed and u32 wires, unrectified
    and rectified: metrics across wires (within the kernel tolerance, and
    whether they are bitwise is printed), launches a window (on the
    rectified u32 wire 2 row gathers: the coordinate lookup and the count
    remap) and bytes uploaded a window. The benchmark's DSEC cells time
    the wire the pipeline runs by default. Returns the launches."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        reset_launches,
        unpack_event_wire,
    )
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    total = {k: 0 for k in TRAIN_LAUNCHES}
    for kind, (windows, ridx, rect) in wire_windows(rng).items():
        mets = {}
        for wire, runtime in WIRES.items():
            pipe = EvalPipeline(dict(DSEC_CONFIG, runtime=runtime), model,
                                device=DEVICE)
            pipe.cur_ridx, pipe.cur_rect = ridx, rect
            reset_launches()
            mets[wire], _ = run_windows(pipe, windows)
            launches = dict(LAUNCHES)
            for k in total:
                total[k] += launches[k]
            rows = 0
            if kind == "rectified" and wire != "plain":
                rows = 2 if wire == "u32" else 1
            want = {"splat_bilinear": 2 * WIRE_WINDOWS,
                    "gather_bilinear": PASSES * WIRE_WINDOWS,
                    "gather_fused": 0, "row_gather": rows * WIRE_WINDOWS}
            check(launches == want,
                  f"wire {wire} {kind}: launches {launches}, expected {want}")
            bufs = [pipe.ensure_bucket(b) for b in windows[0]]
            nbytes = stage_bytes(pipe, bufs)
            staged = pipe.stage_window(bufs)[1]
            check(isinstance(staged, dict) == (wire == "u32"),
                  f"wire {wire} {kind}: staged {type(staged)}")
            if wire == "u32":
                # the card's unpacking (with the rectified lookup's row
                # gather) is bitwise the host's event list; padding rows
                # (p = 0, at raw pixel 0) take that pixel's coordinates
                ev, _ = unpack_event_wire(staged["ts"], staged["yxp"],
                                          staged.get("rect"))
                ev = ev.cpu().numpy()
                host = np.stack([b["event_list"] for b in bufs])
                real = host[..., 3] != 0
                check(np.array_equal(ev[real], host[real])
                      and np.array_equal(ev[..., [0, 3]], host[..., [0, 3]]),
                      f"u32 {kind}: the unpacked events differ from the "
                      "host's")
                how = ("looked up by the row gather" if rect is not None
                       else "unpacked")
                print(f"options (c) {kind} u32: the card's unpacked event "
                      f"list (coordinates {how}) bitwise the host's")
            print(f"options (c) {kind} {wire}: {nbytes} bytes uploaded a "
                  f"window; launches a window "
                  f"{ {k: v // WIRE_WINDOWS for k, v in launches.items()} }")
        for wire in ("packed", "u32"):
            bitwise = True
            for i, (a, b) in enumerate(zip(mets[wire], mets["plain"])):
                for k in ("fwl", "rsat", "aee"):
                    bitwise &= float(a[k]) == float(b[k])
                    check(math.isclose(float(a[k]), float(b[k]),
                                       rel_tol=KERNEL_RTOL,
                                       abs_tol=KERNEL_ATOL),
                          f"wire {wire} {kind} window {i} {k}: {a[k]} vs "
                          f"plain {b[k]}")
            print(f"options (c) {kind}: {wire} wire's FWL/RSAT/AEE "
                  f"{'bitwise equal to' if bitwise else 'within rel 1e-5 of'}"
                  f" the plain wire's over {WIRE_WINDOWS} windows")
    return total


def blocking_ring(device):
    """A staging ring that uploads as the pipeline did before it had one,
    as the per-pass path's ``_dev`` still does: pageable buffers, each a
    blocking copy to the card, counted ``h2d_bytes`` alone."""
    import torch

    from taming_event_flow_tpu_torch.pipeline.staging import StagingRing
    from taming_event_flow_tpu_torch.utils.diagnostics import count

    class BlockingRing(StagingRing):
        def upload(self, name):
            host = self.slots[self.k][name].numpy()
            count("h2d_bytes", host.nbytes)
            return torch.as_tensor(host, device=self.device)

    ring = BlockingRing(device)
    ring.cuda = False  # pageable buffers, no events
    return ring


def ring_windows(pipe, windows, blocking, reader=True):
    """Drive ``windows`` through ``pipe`` as the eval CLI does, its reader
    thread copying each window's metrics and u16 ``flow_bw`` to the host
    while the next windows stage and replay (without ``reader``, the
    outputs stay on the card until the last window is in); ``blocking``
    swaps in :func:`blocking_ring`. Under a CPU profile, for the
    program's counters. Returns the host outputs, the launches, the
    counters' sums, the bucket growths warned and the seconds
    (synchronised)."""
    import queue
    import threading
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.utils.diagnostics import recorded

    if blocking:
        pipe._ring = blocking_ring(pipe.device)
    q, outs, errs = queue.Queue(maxsize=4 if reader else 0), {}, []

    def read():
        while (item := q.get()) is not None:
            j, mets, flow_bw = item
            try:
                host = {k: float(v.cpu()) for k, v in mets.items()}
                host["flow_bw"] = flow_bw.cpu().numpy()
                outs[j] = host
            except Exception as e:  # raised once the thread is joined
                errs.append(e)

    thread = threading.Thread(target=read, name="ring-reader", daemon=True)
    if reader:
        thread.start()
    reset_launches()
    t_ns = time.time_ns()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]), \
            warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        for j, passes in enumerate(windows):
            for b in passes:
                pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
            q.put((j,) + pipe.boundary_outputs(passes[-1], {"ts": 0.0}))
        q.put(None)
        if not reader:
            thread.start()
        thread.join(timeout=600)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(not thread.is_alive() and not errs, f"ring reader: {errs}")
    names = ("h2d_bytes", "h2d_async_bytes", "stage_slot_waits",
             "eval_graph_replays", "eval_graph_captures")
    mine = [e for e in recorded() if e.start_ns >= t_ns
            and e.value is not None]
    counts = {k: sum(e.value for e in mine if e.name == k) for k in names}
    grew = sum("event bucket grew" in str(w.message) for w in warned)
    return [outs.get(j) for j in range(len(windows))], dict(LAUNCHES), \
        counts, grew, secs


def staging_ring_check(rng):
    """(e): a rectified DSEC sequence of ``RING_WINDOWS`` windows on the
    default u32 wire through the staging ring against the same windows
    staged by blocking uploads, both read back by a reader thread as in
    the eval CLI, one pass of window ``RING_GROW_AT`` overflowing the
    bucket: ``flow_bw`` (u16) and FWL/RSAT/AEE bitwise, the launches
    equal, graphs replayed alike; every byte of the ring's path counted
    ``h2d_async_bytes``. Then the first windows again through the ring,
    their outputs read after the last: bitwise, and slot waits counted
    (the host a window ahead). Its launches stay out of the phase's
    totals. Returns the ms a window of both."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline
    from taming_event_flow_tpu_torch.training.window import (
        pad_batch_events,
    )

    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    windows = rectified_windows(rng, RING_WINDOWS, fwd, ridx[0])
    bucket = max(b["event_list"].shape[1] for w in windows for b in w)
    grow = windows[RING_GROW_AT]
    grow[3] = pad_batch_events(grow[3], bucket + 4096)
    cfg = dict(DSEC_CONFIG, loader=dict(DSEC_CONFIG["loader"],
                                        n_events_pad=bucket))
    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    res = {}
    for tag in ("blocking", "ring"):
        pipe = EvalPipeline(cfg, model, device=DEVICE)
        pipe.cur_ridx, pipe.cur_rect = ridx, fwd
        check(pipe.windowed and pipe.u32_wire, f"ring {tag}: not windowed")
        res[tag] = ring_windows(pipe, windows, tag == "blocking")
        del pipe
    (ref, ref_launch, ref_n, ref_grew, ref_s) = res["blocking"]
    (out, launch, n, grew, secs) = res["ring"]
    ms = (secs * 1e3 / RING_WINDOWS, ref_s * 1e3 / RING_WINDOWS)
    print(f"options (e) staging ring: {RING_WINDOWS} rectified u32 windows "
          f"(bucket {bucket}, grown {grew} time(s) at window "
          f"{RING_GROW_AT}), read back on a thread; {n['h2d_async_bytes']:.0f}"
          f" of {n['h2d_bytes']:.0f} bytes uploaded through the ring "
          f"(blocking: {ref_n['h2d_bytes']:.0f}); "
          f"{n['stage_slot_waits']:.0f} slot waits; replays "
          f"{n['eval_graph_replays']:.0f}, captures "
          f"{n['eval_graph_captures']:.0f}; launches a window "
          f"{ {k: v / RING_WINDOWS for k, v in launch.items()} } (blocking "
          f"{ {k: v / RING_WINDOWS for k, v in ref_launch.items()} }); ms a "
          f"window (profiled) ring {ms[0]:.3f}, blocking {ms[1]:.3f}")
    check(ref_grew == grew == 1, f"ring: bucket growths {ref_grew} {grew}")
    check(all(o is not None for o in out + ref), "ring: a window is missing")
    for j, (a, b) in enumerate(zip(out, ref)):
        check(a["flow_bw"].dtype == np.uint16
              and np.array_equal(a["flow_bw"], b["flow_bw"]),
              f"ring window {j}: flow_bw differs from blocking staging")
        for k in ("fwl", "rsat", "aee"):
            check(a[k] == b[k], f"ring window {j} {k}: {a[k]} vs blocking "
                                f"{b[k]}")
    check(launch == ref_launch,
          f"ring: launches {launch}, blocking staging {ref_launch}")
    for k in ("eval_graph_replays", "eval_graph_captures"):
        check(n[k] == ref_n[k] > 0, f"ring: {k} {n[k]} vs {ref_n[k]}")
    check(n["h2d_async_bytes"] == n["h2d_bytes"] == ref_n["h2d_bytes"] > 0,
          "ring: h2d_async_bytes and h2d_bytes differ")
    check(ref_n["h2d_async_bytes"] == 0 and ref_n["stage_slot_waits"] == 0,
          f"ring: blocking staging counted {ref_n}")
    print(f"options (e) staging ring: flow_bw (u16) and FWL/RSAT/AEE of "
          f"every window bitwise blocking staging's, launches equal")
    # the reader's blocking copies hold the stream, so the host rarely
    # gets a window ahead above; with the outputs left on the card it does,
    # and waits for the slot it refills
    pipe = EvalPipeline(cfg, model, device=DEVICE)
    pipe.cur_ridx, pipe.cur_rect = ridx, fwd
    ahead, _, n_ahead, _, secs = ring_windows(
        pipe, windows[:RING_GROW_AT], False, reader=False)
    for j, (a, b) in enumerate(zip(ahead, ref)):
        check(np.array_equal(a["flow_bw"], b["flow_bw"])
              and all(a[k] == b[k] for k in ("fwl", "rsat", "aee")),
              f"ring window {j} (no reader): differs from blocking staging")
    print(f"options (e) staging ring, outputs read after the last window: "
          f"{n_ahead['stage_slot_waits']:.0f} slot waits in {RING_GROW_AT} "
          f"windows, {secs * 1e3 / RING_GROW_AT:.3f} ms a window "
          f"(profiled), outputs bitwise")
    check(n_ahead["stage_slot_waits"] > 0, "ring: no slot wait counted with "
          "the host ahead (the device should set the pace)")
    return ms


def train_wire_ab(seed, work, train_data):
    """(d): ``train_flow_torch.train`` at ``TRAIN_CLI_CONFIG``'s values
    for one epoch with ``runtime.packed_wire`` on and off: the first two
    steps' losses within ``WIRE_STEP_RTOL`` (the card's CLI is not
    reproducible past its second step), the bytes each step uploads.
    Returns the launches."""
    import train_flow_torch
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches

    data_dir, loader_cls = train_data
    out, total = {}, {k: 0 for k in TRAIN_LAUNCHES}
    real_stack = train_flow_torch.stack_window
    for packed in (True, False):
        sent = []

        def stack(*a, **k):
            w = real_stack(*a, **k)
            sent.append(sum(v.nbytes for v in w.values()))
            return w

        steps = recording(train_flow_torch.make_train_step)
        parser = train_cli_config(data_dir, seed)
        parser.config["loader"]["n_epochs"] = 1
        parser.config["runtime"] = {"packed_wire": packed}
        parser.config["vis"]["verbose"] = False
        root = os.path.join(work, f"wire_{packed}")
        os.makedirs(root, exist_ok=True)
        reset_launches()
        run_train_cli(parser, root, {"H5Loader": loader_cls,
                                     "make_train_step": steps,
                                     "stack_window": stack})
        for k in total:
            total[k] += LAUNCHES[k]
        n = len(steps.steps[0].losses)
        want = {k: v * n for k, v in TRAIN_LAUNCHES.items()}
        check(dict(LAUNCHES) == want,
              f"train wire {packed}: launches {dict(LAUNCHES)}, {want}")
        out[packed] = (steps.steps[0].losses, float(np.mean(sent)))
    (on, b_on), (off, b_off) = out[True], out[False]
    rel = max(abs(a - b) / abs(b) for a, b in zip(on[:2], off[:2]))
    print(f"options (d) train_cli packed wire on / off: first steps "
          f"{on[:2]} / {off[:2]} (rel {rel:.2e}); {b_on:.0f} / {b_off:.0f} "
          f"bytes uploaded a step ({len(on)} steps)")
    check(len(on) == len(off) >= 2, f"train wire: steps {len(on)} {len(off)}")
    check(rel <= WIRE_STEP_RTOL, f"train wire: first steps rel {rel:.2e}")
    return total


def options_phase(seed, work, train_data, gpu):
    """Phase 11: the registry options and the wires. (a) ``norm: IN`` and
    ``compute_dtype: bfloat16`` flows, then each through the training
    cell; (b) ``batched_sweep`` at the training cell against the looped
    sweep, with its launches, ms/step and peak memory; (c) the DSEC cell
    on the three wires; (e) the staging ring against blocking uploads; (d)
    the training CLI on the packed and the plain wire. Returns the
    launches."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 11])
    total = {k: 0 for k in TRAIN_LAUNCHES}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    model_option_flows(rng)
    peaks = {}
    launches, _, peaks["default"] = option_steps("default", rng)
    add(launches)
    for tag, change in MODEL_OPTIONS.items():
        launches, _, peaks[tag] = option_steps(tag, rng, model_change=change)
        add(launches)
    batched_sweep_check(rng)
    launches, _, peaks["batched_sweep"] = option_steps(
        "batched_sweep", rng, loss_change={"batched_sweep": True},
        expect=BATCHED_LAUNCHES)
    add(launches)
    print(f"options (b) peak memory (GiB) on {gpu}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in peaks.items()))
    add(wire_phase(rng))
    staging_ring_check(np.random.default_rng([seed, 11, 5]))
    add(train_wire_ab(seed, work, train_data))
    print(f"phase 11 options and wires: {time.perf_counter() - t_phase:.1f} "
          f"s; launches {total}")
    return total


# ------------------------------------------------------- JAX run phase (12)

JAX_RUN_STEPS = 3  # port steps whose Adam state the JAX checkpoint holds
JAX_RUN_EPOCH = 1  # the checkpoint's epoch: the warm start trains 1 and 2
JAX_RUN_EPOCHS = 3  # n_epochs of the warm start
JAX_RUN_HISTORY = [0.3125, 0.25]  # the run's logged losses, epochs 0 and 1
JAX_EVAL_WINDOWS = 2  # GT windows per sequence of (c)
STREAM_EVENTS = 32768  # events a slice, the example's default
STREAM_PASSES = 100  # timed passes per wire, after one warm-up pass
PROFILE_PASSES = 3
PROFILE_TRIES = 3  # traces that may come back without the card's rows
LATTICE = 1.0 / 128  # the u16 wire's step, px
MSGPACK_MAX_LEAF = 2**30  # flax chunks a larger array (MAX_CHUNK_SIZE)


def _msgpack_len(n, codes, out):
    """The msgpack length header of the 8-, 16- or 32-bit form in
    ``codes`` (``None``: the type has no 8-bit form)."""
    for code, fmt, cap in zip(codes, "BHI", (0xff, 0xffff, 0xffffffff)):
        if code is not None and n <= cap:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"msgpack: length {n} over 32 bits")


def _msgpack_int(n):
    if 0 <= n < 0x80 or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    for code, fmt, lo, hi in ((0xcc, "B", 0, 0xff), (0xd0, "b", -0x80, -1),
                              (0xcd, "H", 0, 0xffff),
                              (0xd1, "h", -0x8000, -1),
                              (0xce, "I", 0, 0xffffffff),
                              (0xd2, "i", -0x80000000, -1),
                              (0xcf, "Q", 0, 2**64 - 1),
                              (0xd3, "q", -2**63, -1)):
        if lo <= n <= hi:
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"msgpack: integer {n} over 64 bits")


def _msgpack_ext(code, arr, out):
    """flax's ext ``code`` (1 ndarray, 3 numpy scalar): msgpack ``(shape,
    dtype name, C-order bytes)`` (``flax/serialization.py:
    _ndarray_to_bytes``)."""
    if arr.nbytes > MSGPACK_MAX_LEAF:
        raise ValueError(f"an array of {arr.nbytes} bytes: flax would chunk "
                         "it, and this writer does not")
    payload = []
    _msgpack_pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")],
                  payload)
    data = b"".join(payload)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(data) in fix:
        out.append(bytes([fix[len(data)]]))
    else:
        _msgpack_len(len(data), (0xc7, 0xc8, 0xc9), out)
    out += [bytes([code]), data]


def _msgpack_pack(obj, out):
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _msgpack_ext(1, obj, out)
    elif isinstance(obj, np.generic):
        _msgpack_ext(3, np.asarray(obj), out)
    elif isinstance(obj, int):
        out.append(_msgpack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        if len(data) < 32:
            out.append(bytes([0xa0 | len(data)]))
        else:
            _msgpack_len(len(data), (0xd9, 0xda, 0xdb), out)
        out.append(data)
    elif isinstance(obj, bytes):
        _msgpack_len(len(obj), (0xc4, 0xc5, 0xc6), out)
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        if len(obj) < 16:
            out.append(bytes([0x90 | len(obj)]))
        else:
            _msgpack_len(len(obj), (None, 0xdc, 0xdd), out)
        for v in obj:
            _msgpack_pack(v, out)
    elif isinstance(obj, dict):
        if len(obj) < 16:
            out.append(bytes([0x80 | len(obj)]))
        else:
            _msgpack_len(len(obj), (None, 0xde, 0xdf), out)
        for k, v in obj.items():
            _msgpack_pack(k, out)
            _msgpack_pack(v, out)
    else:
        raise TypeError(f"msgpack: {type(obj).__name__} is not in the "
                        "subset flax writes")


def flax_to_bytes(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree``, a
    state dict of maps with string keys, numpy arrays and scalars, Python
    scalars and ``None``. Test scaffolding: the card has no JAX, so the
    smoke writes the JAX package's checkpoint itself (a CPU test holds
    these bytes to flax's)."""
    out = []
    _msgpack_pack(tree, out)
    return b"".join(out)


def jax_checkpoint_tree(model, optimizer, step, epoch):
    """What ``taming_event_flow_tpu/tracking/checkpoint.py:save_checkpoint``
    serialises for this model and its Adam state: ``params``, the optax
    state of ``chain(clip_by_global_norm, adam)`` under flax's state dict
    (the clip's ``EmptyState`` as ``{}``, Adam's ``count`` a 0-d int32
    array), ``step`` and ``epoch`` as int64 scalars."""
    from taming_event_flow_tpu_torch.models import state_dict_to_flax_params

    named = list(model.named_parameters())
    states = [optimizer.state[p] for _, p in named]
    counts = {int(s["step"]) for s in states}
    check(len(counts) == 1, f"Adam step counts {counts}")

    def moments(key):
        return state_dict_to_flax_params({n: s[key]
                                          for (n, _), s in zip(named, states)})

    adam = {"count": np.asarray(counts.pop(), np.int32),
            "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")}
    return {"params": state_dict_to_flax_params(model.state_dict()),
            "opt_state": {"0": {}, "1": {"0": adam, "1": {}}},
            "step": np.int64(step), "epoch": np.int64(epoch)}


def write_jax_run(seed, work, data_dir, model_config=MODEL_CONFIG,
                  tag="jax_run (a)"):
    """(a) A run as the JAX trainer leaves it: the training CLI's config
    (its model ``model_config``) as run params, a short loss history, and
    ``checkpoint.msgpack`` of the full-width model after ``JAX_RUN_STEPS``
    port steps (seeded weights, Adam after the clip) at B = 1; each
    decoder's leaves are the JAX layer's (``conv`` or, with
    ``use_upsample_conv: false``, ``ConvTranspose_0``). Returns the run id
    and what was written (parameters and Adam state on the host)."""
    import torch

    from taming_event_flow_tpu_torch import tracking
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    rng = np.random.default_rng([seed, 12])
    model = build_model(model_config, num_bins=2, device=DEVICE, seed=seed)
    opt = build_optimizer(TRAIN_OPT, model.parameters(),
                          clip_grad=TRAIN_CLIP, device=DEVICE)
    step = make_train_step(model, opt, LossConfig(**TRAIN_LOSS), "Iterative",
                           flow_scaling=FLOW_SCALING, res=TRAIN_RES)
    state = init_train_state(model, 1, *TRAIN_RES, device=DEVICE)
    losses = []
    for _ in range(JAX_RUN_STEPS):
        state, loss = step(state, train_window(rng, 1, device=DEVICE))
        losses.append(float(loss))
    check(all(math.isfinite(v) for v in losses),
          f"{tag}: losses {losses}")
    tree = jax_checkpoint_tree(model, opt, state.step, JAX_RUN_EPOCH)
    adam = tree["opt_state"]["1"]["0"]
    check(int(adam["count"]) == JAX_RUN_STEPS == state.step,
          f"{tag}: Adam count {adam['count']}, steps {state.step}")
    leaf = ("conv" if model_config.get("use_upsample_conv", True)
            else "ConvTranspose_0")
    for t in (tree["params"], adam["mu"], adam["nu"]):
        decoders = {k: set(v) for k, v in t["arch"].items()
                    if k.startswith("decoder_")}
        check(len(decoders) == len(model.arch.decoders)
              and all(v == {leaf} for v in decoders.values()),
              f"{tag}: decoder leaves {decoders}, expected {leaf}")
    blob = flax_to_bytes(tree)

    config = train_cli_config(data_dir, seed).config
    config["model"] = dict(config["model"], **model_config)
    tracking.set_tracking_uri(work)
    tracking.set_experiment(config["experiment"])
    runid = tracking.start_run().info.run_id
    tracking.log_params({k: str(v) for k, v in config.items()})
    tracking.log_params({"prev_runid": ""})
    for epoch, v in enumerate(JAX_RUN_HISTORY):
        tracking.log_metric("loss", v, step=epoch)
    path = os.path.join(tracking.default_store().artifact_dir(runid, "model"),
                        "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(blob)
    tracking.end_run()
    named = list(model.named_parameters())
    written = {"params": {n: p.detach().cpu().clone() for n, p in named}}
    for key in ("exp_avg", "exp_avg_sq"):
        written[key] = {n: opt.state[p][key].cpu().clone() for n, p in named}
    n_params = sum(v.numel() for v in written["params"].values())
    check(all(bool(v.abs().sum() > 0) for v in written["exp_avg_sq"].values()),
          f"{tag}: an Adam second moment is all zero")
    print(f"{tag}: run {runid}, checkpoint.msgpack {len(blob)} bytes "
          f"({n_params} parameters with mu and nu, count {JAX_RUN_STEPS}, "
          f"epoch {JAX_RUN_EPOCH}; decoders' leaves {leaf}); step losses "
          f"{losses}")
    del model, opt, named
    torch.cuda.empty_cache()
    return runid, written


def jax_warm_start(seed, work, train_data, runid, written,
                   model_config=MODEL_CONFIG, tag="jax_run (b)"):
    """(b) ``train_flow_torch.train --prev_runid <the JAX run>`` on the
    card at the training CLI's values (its model ``model_config``) for two
    epochs: the parameters and both Adam moments restored bit for bit,
    Adam's step ``JAX_RUN_STEPS`` on every parameter, the start epoch and
    the replayed history, finite losses, the launches exact per step.
    Returns the launches."""
    from taming_event_flow_tpu_torch.models import optax_state_to_torch
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.tracking import (
        default_store,
        load_checkpoint,
    )
    from taming_event_flow_tpu_torch.utils import SectionTimer

    data_dir, loader_cls = train_data
    timers, loaded = [], {}

    class Timer(SectionTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    def recording(tree, model, optimizer):
        optax_state_to_torch(tree, model, optimizer)
        named = list(model.named_parameters())
        loaded["params"] = {n: p.detach().cpu().clone() for n, p in named}
        for key in ("exp_avg", "exp_avg_sq", "step"):
            loaded[key] = {n: optimizer.state[p][key].cpu().clone()
                           for n, p in named}

    parser = train_cli_config(data_dir, seed)
    parser.config["loader"]["n_epochs"] = JAX_RUN_EPOCHS
    parser.config["model"].update(model_config)
    reset_launches()
    run2, wall, text = run_train_cli(
        parser, work, {"H5Loader": loader_cls, "SectionTimer": Timer,
                       "optax_state_to_torch": recording}, runid)
    launches = dict(LAUNCHES)

    check(f"Model restored from {runid}" in text,
          f"{tag}: the warm start did not restore the JAX run")
    check(sorted(loaded) == ["exp_avg", "exp_avg_sq", "params", "step"],
          f"{tag}: the optax state was not loaded")
    for key in ("params", "exp_avg", "exp_avg_sq"):
        check(sorted(loaded[key]) == sorted(written[key]),
              f"{tag} {key}: names differ")
        for n, v in written[key].items():
            check(torch_equal(loaded[key][n], v),
                  f"{tag} {key} {n}: not bitwise what was written")
    steps_loaded = {float(v) for v in loaded["step"].values()}
    check(steps_loaded == {float(JAX_RUN_STEPS)},
          f"{tag}: Adam steps {steps_loaded}")

    history = default_store().read_metric(run2, "loss")
    values = [v for _, v, _ in history]
    new_epochs = [s for _, _, s in history][len(JAX_RUN_HISTORY):]
    check(values[:len(JAX_RUN_HISTORY)] == JAX_RUN_HISTORY,
          f"{tag}: history {values}")
    check(new_epochs == list(range(JAX_RUN_EPOCH, JAX_RUN_EPOCHS)),
          f"{tag}: epochs trained {new_epochs}")
    new = values[len(JAX_RUN_HISTORY):]
    check(all(math.isfinite(v) for v in new), f"{tag} losses {new}")
    steps = timers[0].counts.get("step_dispatch", 0)
    check(steps >= 3 * len(new_epochs), f"{tag}: {steps} steps")
    expect = {name: n * steps for name, n in TRAIN_LAUNCHES.items()}
    check(launches == expect,
          f"{tag} launches {launches}, expected {expect}")
    ckpt, _ = load_checkpoint(run2)
    adam = {int(s["step"]) for s in ckpt["optimizer"]["state"].values()}
    check(adam == {ckpt["step"]}
          and JAX_RUN_STEPS < ckpt["step"] <= JAX_RUN_STEPS + steps,
          f"{tag}: checkpoint step {ckpt['step']}, Adam steps {adam}")
    print(f"{tag}: warm run {run2} from {runid}: {steps} steps over "
          f"epochs {new_epochs}, losses {values}; parameters, exp_avg and "
          f"exp_avg_sq bitwise the written ones, Adam step "
          f"{JAX_RUN_STEPS}; launches {launches}; {wall:.2f} s")
    return launches


def torch_equal(a, b):
    import torch

    return a.dtype == b.dtype and torch.equal(a, b)


def jax_eval(seed, work, runid, written, eval_launches, gpu):
    """(c) ``eval_flow_torch.test`` on the JAX run at
    ``configs/eval_dsec.yml``'s values over a rectified and an unrectified
    sequence: the model holds the written parameters, ``metrics_0.yml`` a
    finite entry per sequence and metric, the ``flow_bw`` tree a PNG per
    window, and every window the eval phase's launches (two row gathers on
    a rectified one, the u32 wire's lookup and the remap). Returns the
    launches."""
    frames = JAX_EVAL_WINDOWS + 2
    specs = {"seq_rect": dsec_sequence(frames, seed * 10 + 40, rectify=True),
             "seq_plain": dsec_sequence(frames, seed * 10 + 41)}
    data_dir, loader_cls = eval_cli_data(work, "jax_run", specs)
    results, wall, pipe, res_dir, launches = eval_cli_run(
        "jax_run", EVAL_DSEC_CLI, data_dir, loader_cls, runid, work)
    held = {n: p.detach().cpu() for n, p in pipe.model.named_parameters()}
    check(all(torch_equal(held[n], v)
              for n, v in written["params"].items()),
          "jax_run (c): the eval model does not hold the JAX run's weights")
    check_metrics_file(res_dir, results, list(specs),
                       EVAL_DSEC_CLI["metrics"]["name"])
    tree = os.path.join(res_dir, "results", "eval_0")
    for seq in specs:
        windows = [w for s, w in pipe.windows if s == seq]
        check(len(windows) == JAX_EVAL_WINDOWS,
              f"jax_run (c) {seq}: {len(windows)} windows")
        check_dsec_tree(tree, seq, len(windows))
        rows = 2 if seq == "seq_rect" else 0
        for i, w in enumerate(windows):
            expect = {"splat_bilinear": eval_launches["splat_bilinear"],
                      "gather_bilinear": eval_launches["gather_bilinear"],
                      "gather_fused": 0, "row_gather": rows}
            check(w == expect, f"jax_run (c) {seq} window {i}: launches {w},"
                  f" expected {expect}")
    print(f"jax_run (c): metrics {results}; launches {launches}; "
          f"{wall / len(pipe.windows) * 1e3:.3f} ms per GT window of CLI "
          f"wall on {gpu}")
    return launches


def streaming_example():
    """``examples/streaming_inference_torch.py``, imported by its path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "streaming_inference_torch.py")
    spec = importlib.util.spec_from_file_location("streaming_inference_torch",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def stream_args(example, runid, work, wire, passes):
    return example.parse_args([
        "--runid", runid, "--path_mlflow", work, "--height", str(RES[0]),
        "--width", str(RES[1]), "--n_events", str(STREAM_EVENTS),
        "--passes", str(passes), "--wire", wire, "--device", DEVICE])


def jax_stream(work, runid, gpu):
    """(d) The streaming example from the JAX run at 480x640,
    ``STREAM_EVENTS`` a slice, ``STREAM_PASSES`` timed passes on each wire
    (p50 and p99 ms/pass printed); the u16 wire's map bitwise the lattice
    decode of the same pass's float32 map, and within one lattice step of
    the f32 wire's map of the same slices. Returns ``{wire: (p50, p99)}``."""
    from taming_event_flow_tpu_torch.utils import flow_to_u16, u16_to_flow

    example = streaming_example()
    maps, times = {}, {}
    for wire in ("f32", "u16"):
        flow, lat = example.stream(stream_args(example, runid, work, wire,
                                               STREAM_PASSES))
        check(flow.shape == (1, *RES, 2) and np.isfinite(flow).all(),
              f"jax_run (d) {wire}: flow {flow.shape}")
        maps[wire] = flow
        times[wire] = (float(np.percentile(lat, 50)),
                       float(np.percentile(lat, 99)))
        print(f"jax_run (d) stream {wire}: p50 {times[wire][0]:.3f} ms, p99 "
              f"{times[wire][1]:.3f} ms, mean {lat.mean():.3f} ms per pass "
              f"over {len(lat)} passes ({RES[0]}x{RES[1]}, {STREAM_EVENTS} "
              f"events a slice; upload, encode, forward, read-back) on {gpu}")

    # the same pass read on both wires: the u16 map is the lattice decode
    seen = {}
    real = example.read_map

    def spy(flow, wire):
        out = real(flow, wire)
        seen["f32"], seen["out"] = flow.clone(), out
        return out

    example.read_map = spy
    example.stream(stream_args(example, runid, work, "u16", 1))
    ref = u16_to_flow(flow_to_u16(seen["f32"]).cpu().numpy())
    check(np.array_equal(seen["out"], ref),
          "jax_run (d): the u16 wire's map is not the lattice decode of its "
          "pass's float32 map")
    gap = float(np.abs(maps["u16"] - maps["f32"]).max())
    print(f"jax_run (d): u16 map bitwise the decode of its pass's f32 map; "
          f"u16 vs f32 wire over the same slices: max {gap:.3e} px "
          f"(lattice {LATTICE:.3e}), max |flow| "
          f"{float(np.abs(maps['f32']).max()):.3f} px")
    check(gap <= LATTICE * (1 + 1e-3), f"jax_run (d): u16 vs f32 {gap}")
    return times


def jax_profile(work, runid):
    """(e) ``PROFILE_PASSES`` streaming passes under
    ``utils.profile_trace``: the trace file holds the example's
    ``stream_pass`` annotation and the card's kernel rows. Returns the
    trace's kernel rows."""
    from taming_event_flow_tpu_torch.utils import profile_trace

    example = streaming_example()
    for attempt in range(1, PROFILE_TRIES + 1):
        logdir = os.path.join(work, f"stream_profile_{attempt}")
        with profile_trace(logdir):
            example.stream(stream_args(example, runid, work, "f32",
                                       PROFILE_PASSES))
        files = [f for f in os.listdir(logdir) if f.endswith(".json")]
        check(len(files) == 1, f"jax_run (e): trace files {files}")
        with open(os.path.join(logdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        passes = sum(e.get("name") == "stream_pass" for e in events)
        kernels = sum(e.get("cat") == "kernel" for e in events)
        print(f"jax_run (e) trace {attempt}: {files[0]}, {len(events)} "
              f"events, {passes} stream_pass ranges, {kernels} kernel rows")
        check(passes >= PROFILE_PASSES + 1,
              f"jax_run (e): {passes} stream_pass ranges")
        if kernels:
            return kernels
    check(False, f"jax_run (e): {PROFILE_TRIES} traces without a kernel row")


def jax_run_phase(seed, work, train_data, eval_launches, gpu):
    """Phase 12: a run the JAX package made, at full width, on the card:
    (a) its ``checkpoint.msgpack`` written, (b) warm-started by the
    training CLI, (c) evaluated by the eval CLI, (d) streamed by the
    example on both wires, (e) a few streaming passes profiled. Returns
    the launches of (b) and (c) and the streaming times."""
    t_phase = time.perf_counter()
    runid, written = write_jax_run(seed, work, train_data[0])
    runs = [jax_warm_start(seed, work, train_data, runid, written),
            jax_eval(seed, work, runid, written, eval_launches, gpu)]
    times = jax_stream(work, runid, gpu)
    jax_profile(work, runid)
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    print(f"phase 12 jax_run: {time.perf_counter() - t_phase:.1f} s on "
          f"{gpu}; launches {total}")
    return total, times


# ------------------------------------------- transposed-conv phase (13)

# use_upsample_conv: false, the JAX package's transposed-conv decoders
TRANSPOSED_CONFIG = dict(MODEL_CONFIG, use_upsample_conv=False)
MODEL_KINDS = {"default": MODEL_CONFIG, "transposed": TRANSPOSED_CONFIG}
DECODER_REPS = 1  # profiled replays of a window's or a step's 40 calls


def decoder_calls(model, run):
    """The ``(decoder, input)`` of every decoder call ``run()`` makes
    through ``model``, each input detached (a copy)."""
    calls = []
    hooks = [d.register_forward_pre_hook(
        lambda m, a: calls.append((m, a[0].detach().clone())))
        for d in model.arch.decoders]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def decoder_device_ms(calls, backward):
    """Device ms of the decoder calls replayed on their inputs: forward
    only in inference mode, or forward and backward (input and parameter
    gradients) for a cotangent of ones."""
    import torch

    from taming_event_flow_tpu_torch.tools import bench_dma_gather

    if not backward:
        def replay():
            with torch.inference_mode():
                for m, x in calls:
                    m(x)
        return bench_dma_gather.device_ms(replay, reps=DECODER_REPS)
    with torch.no_grad():
        cots = [torch.ones_like(m(x)) for m, x in calls]
    leaves = [x.requires_grad_() for _, x in calls]

    def replay():
        for (m, _), x, g in zip(calls, leaves, cots):
            m(x).backward(g)
    return bench_dma_gather.device_ms(replay, reps=DECODER_REPS)


def transposed_windows(rng, gpu):
    """(b): the DSEC cell (480x640, bf16) through ``EvalPipeline`` with the
    transposed-conv RecEVFlowNet over ``N_WINDOWS`` windows: finite
    metrics, 2 splats and 10 gathers a window; ms/pass in turns with the
    default model on the same windows; one window in float32, card
    against CPU. Returns the launches, the models, their pipelines and
    the windows."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    windows = synthetic_windows(rng, N_WINDOWS)
    models = {k: build_model(cfg, num_bins=2, device=DEVICE, seed=0)
              for k, cfg in MODEL_KINDS.items()}
    pipes = {k: EvalPipeline(DSEC_CONFIG, m, device=DEVICE)
             for k, m in models.items()}
    run_windows(pipes["default"], windows[:1])  # warm-up
    reset_launches()
    mets, secs = run_windows(pipes["transposed"], windows)
    launches = dict(LAUNCHES)
    expect = {"splat_bilinear": 2 * N_WINDOWS,
              "gather_bilinear": PASSES * N_WINDOWS, "gather_fused": 0,
              "row_gather": 0}
    check(launches == expect,
          f"transposed (b) launches {launches}, expected {expect}")
    for i, m in enumerate(mets):
        check_metrics(m, f"transposed (b) window {i}")
        print(f"transposed (b) bf16 window {i}: {secs[i] * 1e3:.2f} ms  FWL "
              f"{float(m['fwl']):.6f}  RSAT {float(m['rsat']):.6f}  AEE "
              f"{float(m['aee']):.6f}")
    warm = {k: [] for k in pipes}
    for _ in range(TIMING_ROUNDS):
        for k, pipe in pipes.items():
            warm[k] += run_windows(pipe, windows)[1]
    print(f"transposed (b) ms/pass (bf16, {len(warm['default'])} warm "
          f"windows each, in turns) on {gpu}: " + ", ".join(
              f"{k} {float(np.mean(v)) / PASSES * 1e3:.3f}"
              for k, v in warm.items()))
    check_f32_card_vs_cpu(models["transposed"], DSEC_CONFIG, windows[:1])
    return launches, models, pipes, windows


def transposed_profile(models, pipes, window, rng, out_dir, gpu):
    """(e): for the default and the transposed-conv model, the device time
    of one bf16 DSEC window and of one training step (B = 8) under the
    profiler, and of their decoders' calls replayed alone: the default's
    bilinear upsample, conv and ReLU, the transposed conv and ReLU. The
    window's decoder calls are those of the model cast to bf16, as the
    eval step casts it, over the window's passes."""
    import torch

    from taming_event_flow_tpu_torch.ops import derive_count_input

    xs = [derive_count_input(torch.from_numpy(b["event_list"]).to(DEVICE),
                             RES).to(torch.bfloat16) for b in window]
    batch = train_window(rng, TRAIN_B)
    for kind, model in models.items():
        net = copy.deepcopy(model).to(torch.bfloat16)

        def passes():
            carry = net.init_state(1, *RES, dtype=torch.bfloat16,
                                   device=DEVICE)
            with torch.inference_mode():
                for x in xs:
                    _, carry = net(x, carry)

        calls = decoder_calls(net, passes)
        dec_window = decoder_device_ms(calls, backward=False)
        _, busy_window = profile_run(
            lambda: run_windows(pipes[kind], [window]), out_dir,
            f"window_{kind}", trace=False)
        del net, calls

        trained, step, state = build_trainer(
            TRAIN_B, DEVICE, model_config=MODEL_KINDS[kind])
        for _ in range(UNTIMED):  # the eager warm-up and the capture
            state, _ = step(state, batch)
        # eager: the pre-hooks run in Python, which a replay skips
        calls = decoder_calls(trained, lambda: step.eager(state, batch))
        dec_step = decoder_device_ms(calls, backward=True)
        _, busy_step = profile_run(lambda: step(state, batch), out_dir,
                                   f"train_{kind}", trace=False)
        print(f"transposed (e) {kind} decoders' device ms on {gpu}: "
              f"{dec_window:.3f} a bf16 window ({len(xs)} passes; the "
              f"window {busy_window:.3f} ms), {dec_step:.3f} a training "
              f"step forward and backward (B = {TRAIN_B}, {len(calls)} "
              f"calls; the step {busy_step:.3f} ms)")
        del trained, step, state, calls
        torch.cuda.empty_cache()


def transposed_phase(seed, work, train_data, eval_launches, gpu,
                     profile_dir):
    """Phase 13: ``use_upsample_conv: false`` (the JAX package's
    transposed-conv decoders) in the full-width RecEVFlowNet of
    ``configs/train_flow.yml``. (a) The training cell beside the default
    model, then card against CPU at B = 1; (b) the DSEC cell; (c) both
    CLIs with the flag; (d) a JAX-format checkpoint with
    ``ConvTranspose_0`` leaves and Adam moments, warm-started; (e) the
    decoders' device time against the default's. Returns the launches of
    the transposed model's runs."""
    import torch

    from taming_event_flow_tpu_torch.tracking import load_checkpoint

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 13])
    runs, secs = [], {}

    def lap(part):
        secs[part] = time.perf_counter() - t_phase - sum(secs.values())

    change = {"use_upsample_conv": False}
    _, ms_default, _ = option_steps("(a) default", rng, phase="transposed")
    launches, ms, _ = option_steps("(a) transposed", rng, model_change=change,
                                   phase="transposed")
    runs.append(launches)
    print(f"transposed (a) ms/step on {gpu}: default {ms_default:.3f}, "
          f"transposed {ms:.3f}")
    lap("(a) steps")
    card_vs_cpu(rng, model_config=TRANSPOSED_CONFIG, probes=False)
    lap("(a) card vs cpu")

    launches, models, pipes, windows = transposed_windows(rng, gpu)
    runs.append(launches)
    lap("(b)")

    runid, launches, steps, _ = registry_train_cli(
        "transposed (c)", {"model": TRANSPOSED_CONFIG}, seed, work,
        train_data, True)
    check(launches == {k: n * steps for k, n in TRAIN_LAUNCHES.items()},
          f"transposed (c) train_cli launches {launches}")
    runs.append(launches)
    ckpt, _ = load_checkpoint(runid, map_location=DEVICE)
    decoders = sorted({k.rsplit(".", 1)[0] for k in ckpt["model"]
                       if k.startswith("arch.decoders.")})
    check(decoders and all(d.endswith(".transposed_conv2d")
                           for d in decoders),
          f"transposed (c): the run's decoders {decoders}")
    seqs = ["seq_a", "seq_b"]
    data_dir, loader_cls = eval_cli_data(work, "transposed", {
        s: dsec_sequence(3, seed * 10 + 50 + i) for i, s in enumerate(seqs)})
    launches, _ = registry_eval_cli("transposed (c)", runid, {},
                                    (data_dir, loader_cls, seqs), work,
                                    eval_launches, True)
    runs.append(launches)
    lap("(c)")

    runid, written = write_jax_run(seed, work, train_data[0],
                                   model_config=TRANSPOSED_CONFIG,
                                   tag="transposed (d)")
    runs.append(jax_warm_start(seed, work, train_data, runid, written,
                               model_config=TRANSPOSED_CONFIG,
                               tag="transposed (d)"))
    lap("(d)")

    transposed_profile(models, pipes, windows[-1], rng,
                       profile_dir or os.path.join(work, "profile"), gpu)
    del models, pipes
    torch.cuda.empty_cache()
    lap("(e)")
    total = {k: sum(r[k] for r in runs) for k in runs[0]}
    print(f"phase 13 transposed: {time.perf_counter() - t_phase:.1f} s on "
          f"{gpu} (" + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f"); launches {total}")
    return total, (ms_default, ms)


# ------------------------------------------------ determinism phase (14)

DET_PILE = 65_536  # points on one pixel in the adversarial splat
DET_REPEATS = 20  # launches of the adversarial splat, every one bitwise
DET_STEPS = TRAIN_STEPS  # after one warm-up, the default training cell
DET_OPTION_STEPS = 2  # after one warm-up, each option's training cell
# each option's (model change, loss): the cells phases 9, 11 and 13 train
DET_OPTIONS = {
    "transposed": ({"use_upsample_conv": False}, "Iterative"),
    "norm IN": ({"norm": "IN"}, "Iterative"),
    "bf16": ({"compute_dtype": "bfloat16"}, "Iterative"),
    "Linear": ({}, "Linear"),
}
DET_TIMEOUT = 600.0  # seconds the detector's child process may take
DET_FREE_TAGS = ("default", "transposed")  # (g)'s cells
# (g): what the filler leaves free beyond the cell's pool growth
DET_HEADROOM = 1 << 28
DET_MARK = "determinism detector: ran to its end"


def splat_bound_check(tag, loc, values, res, out):
    """``out`` (the kernel's splat) against a float64 sum of the same
    float32 products: within the fixed point's bound, ``n 2^(-k-1)`` a
    pixel of ``n`` non-zero products, plus half an ulp of ``out`` (its one
    rounding) and the float64 sum's own rounding. Returns the largest
    share of the bound used."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    b, m, c = values.shape
    h, w = res
    exact = torch.zeros(b * h * w, c, dtype=torch.float64, device=DEVICE)
    taps = torch.zeros_like(exact)
    mag = torch.zeros_like(exact)
    base = (torch.arange(b, device=DEVICE) * (h * w))[:, None]
    for idx, weight in cuda_warp._taps(loc, h, w):
        prod = (values * weight[..., None]).reshape(-1, c)  # f32, as rounded
        flat = (idx + base).reshape(-1)
        exact.index_add_(0, flat, prod.double())
        taps.index_add_(0, flat, (prod != 0).double())
        mag.index_add_(0, flat, prod.double().abs())
    ks = cuda_warp.splat_scale_exponent(values)  # one a lane
    step = torch.tensor([2.0 ** (-k - 1) for k in ks], dtype=torch.float64,
                        device=DEVICE).repeat_interleave(h * w)[:, None]
    got = out.reshape(-1, c)
    ulp = (torch.nextafter(got.abs(), torch.tensor(math.inf, device=DEVICE))
           - got.abs()).double()
    bound = taps * step + ulp / 2 + taps * mag * 2.0 ** -52
    err = (got.double() - exact).abs()
    share = float((err / bound.clamp_min(1e-300)).max())
    check(bool((err <= bound).all()),
          f"determinism (a) splat {tag}: beyond the fixed-point bound "
          f"(k = {ks}, {share:.3f} of it)")
    return f"{min(ks)}..{max(ks)}" if len(set(ks)) > 1 else ks[0], share


def splat_twice(tag, loc, values, res):
    """The splat kernel twice on identical inputs, every bit equal; against
    its plain version within the kernel tolerance and against a float64
    sum within its error bound. Returns the output."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    first = cuda_warp.splat_bilinear(loc, values, res)
    again = cuda_warp.splat_bilinear(loc, values, res)
    plain = cuda_warp.splat_bilinear_plain(loc, values, res)
    torch.cuda.synchronize()
    check(torch.equal(bits(first), bits(again)),
          f"determinism (a) splat {tag}: two calls differ")
    err = float((first - plain).abs().max())
    check(torch.allclose(first, plain, rtol=KERNEL_RTOL, atol=KERNEL_ATOL),
          f"determinism (a) splat {tag}: {err} from its plain version")
    k, share = splat_bound_check(tag, loc, values, res, first)
    print(f"determinism (a) splat {tag} [B, M, C] = {list(values.shape)} at "
          f"{res[0]}x{res[1]}: two calls bitwise equal; plain version "
          f"max abs err {err:.3e}; k = {k}, float64 sum within {share:.3f} "
          f"of the bound")
    return first


def lane_by_lane(loc, values, whole):
    """Each lane of a batched splat (``whole``) bitwise the splat of that
    lane alone and of that lane padded with as many zero rows at (0, 0):
    its fixed-point scale is its own (the batched sweep's ``[T*B]`` splat
    against the looped sweep's)."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    res = tuple(whole.shape[1:3])
    for b in range(values.shape[0]):
        one = cuda_warp.splat_bilinear(loc[b:b + 1].contiguous(),
                                       values[b:b + 1].contiguous(), res)
        padded = cuda_warp.splat_bilinear(
            torch.cat([loc[b:b + 1], torch.zeros_like(loc[b:b + 1])], 1),
            torch.cat([values[b:b + 1], torch.zeros_like(values[b:b + 1])],
                      1), res)
        check(torch.equal(bits(one), bits(whole[b:b + 1]))
              and torch.equal(bits(padded), bits(one)),
              f"determinism (a) lane {b}: alone, padded and in the batch "
              f"differ")
    print(f"determinism (a) splat lane by lane: each of {values.shape[0]} "
          f"lanes alone and padded with zero rows bitwise its lane of the "
          f"batched call")


def adversarial_splat(rng):
    """``DET_PILE`` points on one pixel (an integer location: each adds
    its value), random signs, magnitudes log-uniform over 1e-6 to 1e3, C =
    4: ``DET_REPEATS`` calls bitwise equal, each channel within the bound
    of its exactly rounded sum (``math.fsum``)."""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    y, x = 123, 456
    loc = torch.tensor([float(y), float(x)], device=DEVICE).repeat(
        1, DET_PILE, 1).contiguous()
    vals = (10.0 ** rng.uniform(-6, 3, (DET_PILE, 4))
            * rng.choice([-1.0, 1.0], (DET_PILE, 4))).astype(np.float32)
    values = torch.from_numpy(vals)[None].to(DEVICE)
    outs = [cuda_warp.splat_bilinear(loc, values, RES)
            for _ in range(DET_REPEATS)]
    plain = cuda_warp.splat_bilinear_plain(loc, values, RES)
    torch.cuda.synchronize()
    check(all(torch.equal(bits(outs[0]), bits(o)) for o in outs[1:]),
          f"determinism (a) adversarial splat: {DET_REPEATS} calls differ")
    out = outs[0]
    rest = out.clone()
    rest[0, y, x] = 0
    check(not bool(rest.any()), "determinism (a) adversarial: another pixel")
    (k,) = cuda_warp.splat_scale_exponent(values)
    got = out[0, y, x].double().cpu().numpy()
    worst = 0.0
    for ch in range(4):
        exact = math.fsum(vals[:, ch].astype(np.float64))
        bound = (DET_PILE * 2.0 ** (-k - 1)
                 + float(np.spacing(np.float32(abs(got[ch])))) / 2
                 + float(np.spacing(abs(exact))) / 2)
        err = abs(float(got[ch]) - exact)
        check(err <= bound, f"determinism (a) adversarial channel {ch}: "
              f"{err} from the exact sum {exact}, bound {bound}")
        worst = max(worst, err / bound)
    plain_err = float((plain[0, y, x].double().cpu()
                       - torch.tensor([math.fsum(vals[:, ch].astype(
                           np.float64)) for ch in range(4)])).abs().max())
    print(f"determinism (a) adversarial splat, {DET_PILE} points on one "
          f"pixel, |v| in [1e-6, 1e3]: {DET_REPEATS} calls bitwise equal; "
          f"k = {k}, within {worst:.3f} of the bound of the exact sum "
          f"(the plain version's float32 sum: {plain_err:.3e} from it)")


def nonfinite_splat(rng):
    """NaN and +-Inf values at fractional in-frame locations (all four taps
    of non-zero weight), among finite ones: NaN and each infinity where
    the plain version's float sums put them, the finite pixels within the
    kernel tolerance, two calls bitwise equal. (At an integer coordinate the
    kernel issues the one tap of weight 1, where the plain version also
    adds 0 x v to the zero-weight neighbours: an infinite value makes NaN
    there, as the kernel's gather counterpart documents.)"""
    import torch

    from taming_event_flow_tpu_torch.ops import cuda_warp

    nan, inf = float("nan"), float("inf")
    special = [  # ((y, x), values): NaN; +Inf; -Inf; +Inf + -Inf; Inf + 5
        ((10.25, 20.5), (nan, 1, 1, 1)), ((30.25, 40.5), (1, inf, 1, 1)),
        ((50.25, 60.5), (1, 1, -inf, 1)), ((70.25, 80.5), (inf, 1, 1, 1)),
        ((70.25, 80.5), (-inf, 1, 1, 1)), ((90.25, 100.5), (1, 1, 1, inf)),
        ((90.25, 100.5), (1, 1, 1, 5))]
    n = 10_000
    h, w = RES
    loc = np.stack([rng.uniform(0, h - 1, n), rng.uniform(0, w - 1, n)],
                   -1).astype(np.float32)
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    loc[: len(special)] = [p for p, _ in special]
    vals[: len(special)] = [v for _, v in special]
    loc = torch.from_numpy(loc)[None].to(DEVICE)
    values = torch.from_numpy(vals)[None].to(DEVICE)
    got = cuda_warp.splat_bilinear(loc, values, RES)
    again = cuda_warp.splat_bilinear(loc, values, RES)
    ref = cuda_warp.splat_bilinear_plain(loc, values, RES)
    torch.cuda.synchronize()
    check(torch.equal(bits(got), bits(again)),
          "determinism (a) non-finite: two calls")
    for name, fn in (("NaN", torch.isnan), ("+Inf", torch.isposinf),
                     ("-Inf", torch.isneginf)):
        check(torch.equal(fn(got), fn(ref)),
              f"determinism (a) non-finite: {name} not where the plain "
              f"version puts it")
    fin = torch.isfinite(ref)
    check(torch.allclose(got[fin], ref[fin], rtol=KERNEL_RTOL,
                         atol=KERNEL_ATOL), "determinism (a) non-finite: "
          "finite pixels")
    print(f"determinism (a) non-finite values: {int(torch.isnan(got).sum())}"
          f" NaN, {int(torch.isposinf(got).sum())} +Inf, "
          f"{int(torch.isneginf(got).sum())} -Inf outputs where the plain "
          f"version has them; two calls bitwise equal")


def det_splats(rng):
    """(a): the splat at the DSEC, training and ``d_maps`` shapes, the
    adversarial pile, non-finite values."""
    import torch

    lo, vals, _ = splat_inputs(rng, *window_points(rng, PASSES))
    lo_r = torch.round(lo)
    splat_twice("DSEC rounded", lo_r, vals, RES)
    splat_twice("DSEC fractional", lo, vals, RES)
    tloc = torch.from_numpy(fused_points(rng, TRAIN_B, *TRAIN_RES)).to(DEVICE)
    iwe = rng.uniform(0, 1, (TRAIN_B, FUSED_M, 4)).astype(np.float32)
    iwe[:, -FUSED_M // 4:] = 0.0  # rows off the gradient path
    iwe = torch.from_numpy(iwe).to(DEVICE)
    whole = splat_twice("training", tloc, iwe, TRAIN_RES)
    lane_by_lane(tloc, iwe, whole)
    cot = torch.from_numpy((rng.normal(size=(TRAIN_B, FUSED_M, 2)) * 1e-4)
                           .astype(np.float32)).to(DEVICE)
    splat_twice("d_maps", tloc, cot, TRAIN_RES)
    adversarial_splat(rng)
    nonfinite_splat(rng)


def det_train_run(model_change, warping, n_steps, seed):
    """One seeded run of the training cell (B = 8) with ``model_change`` and
    the ``warping`` loss: the seeded model, ``n_steps`` windows drawn from
    ``seed``. Returns every step's loss, the parameters, each parameter's
    Adam moments and step, and the carry."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.objectives import LossConfig
    from taming_event_flow_tpu_torch.training import (
        build_optimizer,
        init_train_state,
        make_train_step,
    )

    model = build_model(dict(MODEL_CONFIG, **model_change), num_bins=2,
                        device=DEVICE, seed=0)
    params = list(model.parameters())
    opt = build_optimizer(TRAIN_OPT, params, clip_grad=TRAIN_CLIP,
                          device=DEVICE)
    step = make_train_step(model, opt, LossConfig(**TRAIN_LOSS), warping,
                           flow_scaling=FLOW_SCALING, res=TRAIN_RES)
    state = init_train_state(model, TRAIN_B, *TRAIN_RES, device=DEVICE)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, train_window(rng, TRAIN_B))
        losses.append(loss)
    torch.cuda.synchronize()
    out = {"loss": torch.stack(losses)}
    out.update({f"param {k}": v.detach().clone()
                for k, v in model.state_dict().items()})
    for i, p in enumerate(params):
        for key, v in opt.state[p].items():
            out[f"adam {i} {key}"] = torch.as_tensor(v).clone()
    out.update({f"carry {i}": c.clone() for i, c in enumerate(state.carry)})
    return out


def det_cases():
    """(b)'s configurations: ``(tag, model change, loss, steps)``."""
    return [("default", {}, "Iterative", DET_STEPS + 1)] + [
        (tag, change, warping, DET_OPTION_STEPS + 1)
        for tag, (change, warping) in DET_OPTIONS.items()]


def det_digests(seed, run_log=None, tags=None, grown=None):
    """One seeded run of each of (b)'s configurations (those of ``tags``
    only, when given): per configuration, each tensor's dtype, shape and
    SHA-256 of its bytes. ``run_log`` gets each run's losses, ``grown``
    the bytes each run grew the allocator's pool by."""
    import torch

    out = {}
    for i, (tag, change, warping, n) in enumerate(det_cases()):
        if tags is not None and tag not in tags:
            continue
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        run = det_train_run(change, warping, n, seed * 100 + i)
        if grown is not None:
            grown[tag] = torch.cuda.max_memory_reserved() - base
        out[tag] = {k: f"{v.dtype} {list(v.shape)} " + hashlib.sha256(
            v.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
            .numpy().tobytes()).hexdigest() for k, v in run.items()}
        if run_log is not None:
            run_log[tag] = run["loss"].tolist()
        del run
        torch.cuda.empty_cache()
    return out


DET_DIGESTS = "determinism digests: "


def det_train_child(seed):
    """(b)'s second runs, in a process of their own: prints the digests of
    :func:`det_digests` as one JSON line."""
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )

    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    print(DET_DIGESTS + json.dumps(det_digests(seed)), flush=True)


def det_training(seed):
    """(b), this process's half: the training cell from one seed, 1 +
    ``DET_STEPS`` steps, then each option of ``DET_OPTIONS`` for 1 +
    ``DET_OPTION_STEPS``. Returns the launches its runs must make, the
    digests of :func:`det_digests` and each run's losses."""
    losses = {}
    ours = det_digests(seed, losses)
    expect = {k: 0 for k in TRAIN_LAUNCHES}
    for _, _, warping, n in det_cases():
        per_step = LINEAR_LAUNCHES if warping == "Linear" else TRAIN_LAUNCHES
        for k, v in per_step.items():
            expect[k] += n * v
    return expect, ours, losses


def det_compare(child, ours, losses):
    """(b), the comparison: the runs of ``child`` (:func:`det_train_child`,
    started beside this process's) against ``ours``: every step's loss,
    parameter, Adam moment and the carry bitwise equal across the two
    processes."""
    out = finish_child(child, "(b)")
    line = [ln for ln in out.splitlines() if ln.startswith(DET_DIGESTS)]
    check(line, "determinism (b): the child printed no digests")
    theirs = json.loads(line[-1][len(DET_DIGESTS):])
    for tag, digests in ours.items():
        differ = sorted(k for k in set(digests) | set(theirs[tag])
                        if digests.get(k) != theirs[tag].get(k))
        check(not differ,
              f"determinism (b) {tag}: two runs differ in {differ[:8]}")
        print(f"determinism (b) {tag}: two runs, in two processes, of 1 + "
              f"{len(losses[tag]) - 1} steps bitwise equal in "
              f"{len(digests)} tensors (losses "
              f"{[f'{v:.9g}' for v in losses[tag]]})")


def detector_child():
    """(c), in a process of its own: one training step of the default and
    of the transposed-conv model under ``torch.use_deterministic_algorithms
    (True)``, which raises at any op on the path that has no deterministic
    implementation; ``torch.histc`` on the card must raise there (the
    detector is armed); then one more step with ``F.interpolate``'s
    backward put back, printed whether it raises or not (torch 2.11 does
    not flag it, though it adds with atomics: (f) prints two of its calls
    apart). Run with ``CUBLAS_WORKSPACE_CONFIG`` set."""
    import torch
    import torch.nn.functional as F

    from taming_event_flow_tpu_torch.models import blocks
    from taming_event_flow_tpu_torch.models import model as model_mod
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )

    set_tf32(False)
    set_deterministic()
    torch.use_deterministic_algorithms(True)
    kernel_build.load()
    steps = {}
    for tag, change in (("default", {}),
                        ("transposed", {"use_upsample_conv": False})):
        _, step, state = steps[tag] = build_trainer(
            TRAIN_B, DEVICE, model_config=dict(MODEL_CONFIG, **change))
        _, loss = step(state, train_window(np.random.default_rng(0),
                                           TRAIN_B))
        check(math.isfinite(float(loss)), f"detector {tag}: loss {loss}")
        print(f"detector {tag}: one step under deterministic algorithms, "
              f"loss {float(loss):.9g}", flush=True)
    # armed: an op without a deterministic implementation raises
    try:
        torch.histc(torch.rand(100, device=DEVICE))
    except RuntimeError as err:
        check("deterministic" in str(err), f"detector armed: {err}")
        print(f"detector armed: {str(err).splitlines()[0][:100]}",
              flush=True)
    else:
        check(False, "detector: torch.histc on the card did not raise")
    # F.interpolate's bilinear backward, which the upsample replaces, in
    # the default decoders (the coarser scales' upsampled flows get no
    # gradient with scales_loss 1): printed, whether it raises or not
    blocks.upsample_bilinear = model_mod.upsample_bilinear = (
        lambda x, f: F.interpolate(x, scale_factor=f, mode="bilinear",
                                   align_corners=False))
    _, step, state = steps["default"]
    try:
        # eager: a capture would record the patched backward, not run it
        step.eager(state, train_window(np.random.default_rng(0), TRAIN_B))
        print("detector: a step with F.interpolate's backward ran (torch "
              f"{torch.__version__} does not flag it)", flush=True)
    except RuntimeError as err:
        print(f"detector: a step with F.interpolate's backward raised: "
              f"{str(err).splitlines()[0][:100]}", flush=True)
    print(DET_MARK, flush=True)


def start_child(call, env=None):
    """``python -c "import chip_smoke; chip_smoke.<call>"`` from this file's
    directory, its output piped."""
    return subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish_child(proc, tag):
    """Wait for a child of :func:`start_child` (killed after
    ``DET_TIMEOUT``); it must exit 0. Returns its output."""
    try:
        out, _ = proc.communicate(timeout=DET_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0:
        print(out[-4000:])
    check(proc.returncode == 0,
          f"determinism {tag}: the child exited {proc.returncode}")
    return out


def det_cli(seed, work, train_data):
    """(d): the training CLI at phase 7's values (one rank, one epoch)
    twice: every step's loss and the epoch loss bitwise equal. Returns the
    launches it must make (steps x the Iterative loss's per step)."""
    import train_flow_torch

    data_dir, loader_cls = train_data
    runs = []
    for _ in range(2):
        steps = recording(train_flow_torch.make_train_step)
        root = tempfile.mkdtemp(prefix="det_cli_", dir=work)
        parser = train_cli_config(data_dir, seed)
        parser.config["loader"]["n_epochs"] = 1
        runid, _, _ = run_train_cli(parser, root, {
            "H5Loader": loader_cls, "make_train_step": steps})
        runs.append((steps.steps[0].losses, epoch_losses(root, runid)))
    as_bits = [[struct.pack("<d", v) for v in r[0] + r[1]] for r in runs]
    check(as_bits[0] == as_bits[1] and runs[0][0],
          f"determinism (d): two CLI runs differ: {runs}")
    print(f"determinism (d) training CLI twice: {len(runs[0][0])} step "
          f"losses and the epoch loss {runs[0][1]} bitwise equal")
    return {k: 2 * len(runs[0][0]) * v for k, v in TRAIN_LAUNCHES.items()}


def det_eval(rng):
    """(e): ``EvalPipeline`` on the same 3 DSEC windows twice, unrectified
    and rectified (the count input derived on the card): FWL, RSAT, AEE and
    the ``flow_bw`` u16 maps bitwise equal. Returns the launches it must
    make."""
    from taming_event_flow_tpu_torch.models import build_model
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline

    model = build_model(MODEL_CONFIG, num_bins=2, device=DEVICE, seed=0)
    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    cases = (("unrectified", synthetic_windows(rng, N_WINDOWS), None),
             ("rectified", rectified_windows(rng, N_WINDOWS, fwd, ridx[0]),
              ridx))
    for tag, windows, r in cases:
        runs = []
        for _ in range(2):
            pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
            pipe.cur_ridx = r
            runs.append(run_windows(pipe, windows)[0])
        for i, (a, b) in enumerate(zip(*runs)):
            for k in ("fwl", "rsat", "aee"):
                check(struct.pack("<d", float(a[k])) == struct.pack(
                    "<d", float(b[k])), f"determinism (e) {tag} window {i}: "
                      f"{k} {float(a[k])!r} vs {float(b[k])!r}")
            check(np.array_equal(a["flow_bw"], b["flow_bw"]),
                  f"determinism (e) {tag} window {i}: flow_bw differs")
        print(f"determinism (e) DSEC {tag}: {N_WINDOWS} windows twice, FWL "
              f"RSAT AEE and flow_bw bitwise equal (FWL "
              f"{[f'{float(m['fwl']):.9g}' for m in runs[0]]})")
    n = 2 * N_WINDOWS
    return {"splat_bilinear": 2 * 2 * n, "gather_bilinear": 2 * PASSES * n,
            "gather_fused": 0, "row_gather": n}


def digest_of(digests):
    """One SHA-256 over a configuration's tensor digests."""
    return hashlib.sha256(json.dumps(digests, sort_keys=True)
                          .encode()).hexdigest()


DET_FREE = "determinism free memory: "


def det_free_child(seed):
    """(g), in a process of its own, so that its allocator's pool starts
    empty and a run grows it by what the run needs: (b)'s default and
    transposed-decoder cells on the free card, then each beside a filler
    tensor that holds all of the card's free memory but that growth plus
    ``DET_HEADROOM``. Prints one JSON line: per cell both runs' digests
    and losses, the memory left free, the growth, and the launches."""
    import torch

    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        kernel_build,
        set_deterministic,
        set_tf32,
    )

    set_tf32(False)
    set_deterministic()
    kernel_build.load()
    out = {}
    for tag in DET_FREE_TAGS:
        grown, losses, held_losses = {}, {}, {}
        free_run = det_digests(seed, losses, (tag,), grown)[tag]
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        filler = torch.empty(max(free - grown[tag] - DET_HEADROOM, 0),
                             dtype=torch.uint8, device=DEVICE)
        try:
            left = torch.cuda.mem_get_info()[0]
            held = det_digests(seed, held_losses, (tag,))[tag]
        finally:
            del filler
            torch.cuda.empty_cache()
        out[tag] = {"free": free_run, "held": held, "losses": losses[tag],
                    "held_losses": held_losses[tag], "left": left,
                    "total": total, "grown": grown[tag]}
    out["launches"] = dict(LAUNCHES)
    print(DET_FREE + json.dumps(out), flush=True)


def det_free_memory(seed, gpu, ref):
    """(g): :func:`det_free_child` in a child process, once no other
    process uses the card. Each cell's run on the free card must be
    bitwise (b)'s (``ref``), and its run beside the filler bitwise that:
    losses, parameters, Adam moments and carry. Prints both digests."""
    out = finish_child(start_child(f"det_free_child({seed})"), "(g)")
    line = [ln for ln in out.splitlines() if ln.startswith(DET_FREE)]
    check(line, "determinism (g): the child printed no digests")
    runs = json.loads(line[-1][len(DET_FREE):])
    expect = {k: 0 for k in TRAIN_LAUNCHES}
    for tag, _, _, n in det_cases():
        if tag in DET_FREE_TAGS:
            for k, v in TRAIN_LAUNCHES.items():
                expect[k] += 2 * n * v
    check(runs["launches"] == expect, f"determinism (g) launches "
          f"{runs['launches']}, expected {expect}")
    for tag in DET_FREE_TAGS:
        r = runs[tag]
        print(f"determinism (g) {tag} on {gpu}: free card "
              f"{digest_of(r['free'])} (losses "
              f"{[f'{v:.9g}' for v in r['losses']]}); beside a filler, "
              f"{r['left'] / 2**30:.3f} of {r['total'] / 2**30:.3f} GiB left "
              f"free (the run grew its pool {r['grown'] / 2**30:.3f} GiB), "
              f"{digest_of(r['held'])} (losses "
              f"{[f'{v:.9g}' for v in r['held_losses']]})")
        check(r["free"] == ref[tag], f"determinism (g) {tag}: the free "
              f"card's run differs from (b)'s")
        differ = sorted(k for k in r["free"]
                        if r["free"][k] != r["held"].get(k))
        check(not differ, f"determinism (g) {tag}: "
              f"{r['left'] / 2**30:.3f} GiB free changes {differ[:8]}")


def det_upsample():
    """(f): the gather-form upsample's backward (the decoders' and the
    per-scale upsampling's) twice at a decoder's shape: bitwise equal."""
    import torch

    from taming_event_flow_tpu_torch.models import blocks

    gen = torch.Generator(device=DEVICE).manual_seed(14)
    x = torch.randn(TRAIN_B, 128, 32, 32, device=DEVICE, generator=gen,
                    requires_grad=True)
    g = torch.randn(TRAIN_B, 128, 64, 64, device=DEVICE, generator=gen)
    a, b = (torch.autograd.grad(blocks.upsample_bilinear(x, 2), x, g)[0]
            for _ in range(2))
    check(torch.equal(bits(a), bits(b)), "determinism (f): the upsample "
          "backward differs between two calls")
    print("determinism (f) the gather upsample backward at [8, 128, 32, 32] "
          "x 2: two calls bitwise equal")


def determinism_phase(seed, work, train_data, gpu):
    """Phase 14: one seed gives one run on the card. (a) The splat twice on
    identical inputs at the DSEC, training and ``d_maps`` shapes, within
    its plain version's tolerance and its fixed-point bound; a pile of
    ``DET_PILE`` points on one pixel ``DET_REPEATS`` times; NaN and +-Inf
    values. (b) The training cell from one seed, and each option of
    ``DET_OPTIONS``, here and in a child process: losses, parameters, Adam
    moments, carry bitwise. (c) One step under
    ``torch.use_deterministic_algorithms(True)`` in another child. (d)
    The training CLI twice. (e) The DSEC eval pipeline twice, unrectified
    and rectified. (g) The default and transposed cells of (b) on the
    free card and beside a filler tensor, in a third child once the others
    have ended (:func:`det_free_memory`). (f) The upsample's backward
    twice. The first two children start first and run beside (a)-(e).
    Returns this process's launches of (b), (d) and (e)."""
    import torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 14])
    secs = {}

    def lap(part):
        secs[part] = time.perf_counter() - t_phase - sum(secs.values())

    # (c) needs CUBLAS_WORKSPACE_CONFIG before CUDA starts
    detector = start_child("detector_child()",
                           {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    trainer = start_child(f"det_train_child({seed})")
    try:
        det_splats(rng)
        lap("(a)")
        reset_launches()
        expect, digests, losses = det_training(seed)
        lap("(b) here")
        for k, v in det_cli(seed, work, train_data).items():
            expect[k] += v
        lap("(d)")
        for k, v in det_eval(rng).items():
            expect[k] += v
        launches = dict(LAUNCHES)
        check(launches == expect, f"determinism launches {launches}, "
              f"expected {expect}")
        lap("(e)")
        det_compare(trainer, digests, losses)
        lap("(b) wait")
    except BaseException:
        for proc in (detector, trainer):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        raise
    out = finish_child(detector, "(c)")
    print("\n".join(f"determinism (c) {line}" for line in
                    out.strip().splitlines()[-6:]))
    check(DET_MARK in out, "determinism (c): the detector did not finish")
    lap("(c) wait")
    det_free_memory(seed, gpu, digests)
    lap("(g)")
    det_upsample()
    lap("(f)")
    print(f"phase 14 determinism: {time.perf_counter() - t_phase:.1f} s on "
          f"{gpu} (" + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f"); launches {launches}")
    return launches


# ----------------------------------------------------- bench phase (15)

BENCH_TIMEOUT = 600.0  # seconds bench_torch.py's child process may take
BENCH_SHARE_MAX = 1.05  # mfu and bandwidth_util: a share of a peak


def bench_expected_launches():
    """The launches ``bench_torch.main`` makes on the card, by section:
    the eval protocols' windows (one warm-up, then its timing loops) at 10
    gathers (DSEC, one a pass) or 2 (MVSEC: the pass and its backward
    re-warp) a window and 2 splats a window with the boundary metrics;
    the training steps (the counted one, the warm-up and the timed ones)
    at the training cell's launches a step."""
    import bench_torch as bt

    def windows(passes):
        return 1 + bt.TIMING_LOOPS * max(1, bt.EVAL_ITERS // passes)

    def eval_launches(splats, gathers):
        return {"splat_bilinear": splats, "gather_bilinear": gathers,
                "gather_fused": 0, "row_gather": 0}

    train = {k: (2 + bt.TRAIN_ITERS) * v for k, v in TRAIN_LAUNCHES.items()}
    return {
        "dsec_480x640_inference": eval_launches(0, PASSES * windows(PASSES)),
        "dsec_480x640_protocol": eval_launches(2 * windows(PASSES),
                                               PASSES * windows(PASSES)),
        "mvsec_260x346_eval": eval_launches(0, 2 * windows(1)),
        "train_b8": train, "train_b1": train,
    }


def bench_phase(gpu):
    """Phase 15: ``python3 bench_torch.py`` in a child process on the card,
    at ``bench.py``'s sizes and iterations: both gates ``ok``, every time
    finite and positive, ``0 < mfu, bandwidth_util <= BENCH_SHARE_MAX``,
    the headline equal to ``warps_per_step / train_step_ms`` as printed,
    the peaks of this card and the launches of each section exact.
    Prints the bench's line; returns its launches summed over sections."""
    import torch

    import bench_torch as bt

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "bench_torch.py"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:])
    check(proc.returncode == 0, f"bench (15): bench_torch.py exited "
          f"{proc.returncode}")
    line = proc.stdout.strip().splitlines()[-1]
    print(f"bench (15) bench_torch.py on {gpu}: {line}")
    out = json.loads(line)
    d = out["detail"]
    check(d["kernel_correctness"] == "ok" and d["sharded_check"] == "ok"
          and d["regression_guard"]["ok"] is True,
          f"bench (15) gates: {d['kernel_correctness']}, "
          f"{d['sharded_check']}")
    times = [d["train_step_ms"], d["train_b1"]["train_step_ms"]] + [
        d[k][t] for k in ("dsec_480x640_inference", "dsec_480x640_protocol",
                          "mvsec_260x346_eval")
        for t in ("pass_ms", "window_ms") if t in d[k]]
    check(all(math.isfinite(t) and t > 0 for t in times),
          f"bench (15) times {times}")
    for k in ("mfu", "bandwidth_util"):
        check(0 < d[k] <= BENCH_SHARE_MAX, f"bench (15) {k} {d[k]}")
    want = d["warps_per_step"] / (d["train_step_ms"] * 1e-3) / 1e6
    check(abs(out["value"] - want) <= 1e-3 * want,
          f"bench (15) headline {out['value']}, warps over ms {want}")
    check(d["hw_peaks"] == bt.card_peaks(torch.cuda.get_device_name(0))
          and d["device"] == gpu, f"bench (15) card {d['device']}, peaks "
          f"{d['hw_peaks']}")
    expect = bench_expected_launches()
    check(d["kernel_launches"] == expect, f"bench (15) launches "
          f"{d['kernel_launches']}, expected {expect}")
    total = {k: sum(v[k] for v in d["kernel_launches"].values())
             for k in TRAIN_LAUNCHES}
    print(f"phase 15 bench: {time.perf_counter() - t_phase:.1f} s on {gpu}; "
          f"{out['value']} Mevents/s at {d['train_step_ms']} ms/step, mfu "
          f"{d['mfu']}, bandwidth_util {d['bandwidth_util']}; launches "
          f"{total}")
    return total, out


# ------------------------------------------------------- graph phase (16)

GRAPH_STEPS = 10  # steps of the training window's shape, graphed and eager
# then rounds of three shapes in turn: half and a quarter of the events,
# each warmed up and captured once, and the first shape again
GRAPH_ROUNDS = 3
GRAPH_LIMITS = "benchmark/limits/iter_train_b8.json"
# the kernels of csrc/warp_kernels.cu that each launch counter stands for
# (a splat is three, a scan, the splat and a finish pass)
WARP_KERNELS = {"splat_bilinear": ("splat_scan_kernel", "splat_kernel",
                                   "splat_finish_kernel"),
                "gather_bilinear": ("gather_kernel",),
                "gather_fused": ("gather_fused_kernel",),
                "row_gather": ("row_gather_kernel",)}


def graph_windows(rng):
    """Phase 16's windows: ``GRAPH_STEPS`` of the training shape, then
    ``GRAPH_ROUNDS`` rounds of half its events, a quarter and the training
    shape; and the indices of the steps that run eagerly (each shape's
    first) and that capture (each shape's second)."""
    first = [train_window(rng, TRAIN_B) for _ in range(GRAPH_STEPS)]
    half = [train_window(rng, TRAIN_B, n=TRAIN_N // 2)
            for _ in range(GRAPH_ROUNDS)]
    quarter = [train_window(rng, TRAIN_B, n=TRAIN_N // 4)
               for _ in range(GRAPH_ROUNDS)]
    windows = first + [w for i in range(GRAPH_ROUNDS)
                       for w in (half[i], quarter[i], first[i])]
    eager_at = {0, GRAPH_STEPS, GRAPH_STEPS + 1}
    capture_at = {1, GRAPH_STEPS + 3, GRAPH_STEPS + 4}
    return windows, eager_at, capture_at


def graph_run(warping, windows, eager):
    """The seeded trainer of :func:`build_trainer` with the ``warping``
    loss over ``windows``: through ``step.eager``, or as the port runs it on
    the card (a CUDA graph from each window shape's second step), under a
    CPU-only profile so that its counters record. Returns every step's
    loss, the parameters and the carry (one dict), each step's launches and
    synchronised seconds, the peak memory, the profile's record, and the
    step and its state after the last window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from taming_event_flow_tpu_torch.ops import LAUNCHES
    from taming_event_flow_tpu_torch.utils.diagnostics import recorded

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, step, state = build_trainer(TRAIN_B, DEVICE, warping)
    call = step.eager if eager else step
    losses, launches, secs = [], [], []
    t0_ns = time.time_ns()
    with (contextlib.nullcontext() if eager
          else profile(activities=[ProfilerActivity.CPU])):
        for w in windows:
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = call(state, w)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches.append(launch_delta(before))
            losses.append(loss)
    rows = [e for e in recorded() if e.start_ns >= t0_ns]
    out = {"loss": torch.stack(losses)}
    out.update({f"param {k}": v.detach().clone()
                for k, v in model.state_dict().items()})
    out.update({f"carry {i}": c.clone() for i, c in enumerate(state.carry)})
    return (out, launches, secs, torch.cuda.max_memory_allocated(), rows,
            step, state)


def replay_kernels(step, state, window):
    """One replayed step under the profiler with CUDA activity on: the
    launches of each kernel of ``WARP_KERNELS`` by name in CUPTI's kernel
    records, and the number of device rows (a trace without them is taken
    again, up to five times)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, window)
            torch.cuda.synchronize()
        rows = [a for a in prof.key_averages()
                if a.device_type == DeviceType.CUDA
                and not a.is_user_annotation]
        if rows:
            break
    found = {counter: {k: sum(a.count for a in rows
                              if re.search(rf"\b{k}\b", a.key))
                       for k in kernels}
             for counter, kernels in WARP_KERNELS.items()}
    return found, len(rows)


def graph_phase(seed, gpu):
    """Phase 16: the training step as a CUDA graph. For the Iterative and
    the Linear loss, the windows of :func:`graph_windows` (three shapes,
    interleaved after the first ten steps: each shape warms up, captures
    once and then replays) graphed against the same steps run eagerly from
    the same weights: every step's loss, every parameter and the carry
    bitwise equal (else the widest gaps printed, the loss's within the
    training cell's ``loss1_gap``), each step's launches exact, three
    captures and ``train_graph_replays`` equal to the steps replayed. Then
    one more replayed step under the profiler: each warp kernel's launches
    by name in CUPTI's records equal to those the capture counted (what a
    replay adds to ``ops.LAUNCHES``) and to the expected launches a step.
    Prints ms a step (synchronised each step) and the peak memory of both.
    Returns the launches and the Iterative ms a step, graphed and eager."""
    import torch

    from taming_event_flow_tpu_torch.training import graphed

    t_phase = time.perf_counter()
    windows, eager_at, capture_at = graph_windows(
        np.random.default_rng([seed, 16]))
    total = {k: 0 for k in TRAIN_LAUNCHES}
    times = {}
    for warping, per_step in (("Iterative", TRAIN_LAUNCHES),
                              ("Linear", LINEAR_LAUNCHES)):
        g_out, g_launches, g_secs, g_peak, rows, step, state = graph_run(
            warping, windows, eager=False)
        e_out, e_launches, e_secs, e_peak, _, _, _ = graph_run(
            warping, windows, eager=True)
        for i, (a, b) in enumerate(zip(g_launches, e_launches)):
            check(a == per_step and b == per_step, f"graph (16) {warping} "
                  f"step {i}: launches {a} graphed, {b} eager, expected "
                  f"{per_step}")
        for k in total:
            total[k] += sum(n[k] for n in g_launches + e_launches)
        counted = {name: sum(e.value for e in rows if e.name == name
                             and e.value is not None)
                   for name in ("train_graph_captures",
                                "train_graph_replays")}
        replayed = len(windows) - len(eager_at)
        check(counted == {"train_graph_captures": len(capture_at),
                          "train_graph_replays": replayed},
              f"graph (16) {warping}: counters {counted}, expected "
              f"{len(capture_at)} captures and {replayed} replays")
        differ = [k for k in e_out if not torch.equal(bits(g_out[k]),
                                                      bits(e_out[k]))]
        if differ:
            gaps = sorted(((float((g_out[k] - e_out[k]).abs().max()
                                  / e_out[k].abs().max().clamp_min(1e-30)),
                            k) for k in differ), reverse=True)
            with open(os.path.join(os.path.dirname(
                    os.path.abspath(__file__)), GRAPH_LIMITS)) as f:
                limit = json.load(f)["limits"]["loss1_gap"]
            loss_gap = float(((g_out["loss"] - e_out["loss"]).abs()
                              / e_out["loss"].abs()).max())
            print(f"graph (16) {warping}: graphed and eager differ in "
                  f"{len(differ)} of {len(e_out)} tensors; widest relative "
                  f"gaps {gaps[:5]}; the losses' {loss_gap:.3e} (the "
                  f"training cells' loss1_gap {limit})")
            check(loss_gap <= limit, f"graph (16) {warping}: loss gap "
                  f"{loss_gap} over {limit}")
        else:
            print(f"graph (16) {warping}: {len(windows)} steps over three "
                  f"shapes graphed and eager bitwise equal in all "
                  f"{len(e_out)} tensors (every step's loss, the "
                  f"parameters, the carry; losses "
                  f"{[f'{v:.9g}' for v in e_out['loss'].tolist()]})")
        # a replay's launches are the capture's: count its kernels on the
        # device instead
        g = step.graphs.graphs[graphed.signature(state.carry, windows[2])]
        found, n_rows = replay_kernels(step, state, windows[2])
        bad = {c: k for c, k in found.items()
               if set(k.values()) != {g.launches[c]}
               or g.launches[c] != per_step[c]}
        check(not bad, f"graph (16) {warping}: a replayed step's kernels "
              f"{found} ({n_rows} device rows) against the capture's "
              f"launches {g.launches}, expected {per_step}")
        print(f"graph (16) {warping}: one replayed step's warp kernels in "
              f"CUPTI's records {found}, the capture's launches "
              f"{g.launches}")
        replays = [t for i, t in enumerate(g_secs[:GRAPH_STEPS])
                   if i not in eager_at | capture_at]
        warm = e_secs[1:GRAPH_STEPS]
        times[warping] = (float(np.mean(replays)) * 1e3,
                          float(np.mean(warm)) * 1e3)
        kept = len(step.graphs.graphs)
        print(f"graph (16) {warping} on {gpu}: {times[warping][0]:.3f} "
              f"ms/step replayed, {times[warping][1]:.3f} eager (B = "
              f"{TRAIN_B}, N = {TRAIN_N}, each step synchronised; the "
              f"graphed run under a CPU-only profile); capture steps "
              f"{[round(g_secs[i] * 1e3, 1) for i in sorted(capture_at)]}"
              f" ms; {kept} graphs in one pool; peak memory "
              f"{g_peak / 2**30:.3f} GiB graphed, {e_peak / 2**30:.3f} "
              f"eager ({g_peak} / {e_peak} B)")
        del g_out, e_out, step, state, g
        torch.cuda.empty_cache()
    for k, n in eval_graph_phase(seed, gpu).items():
        total[k] += n
    print(f"phase 16 graph: {time.perf_counter() - t_phase:.1f} s on {gpu}; "
          f"launches {total}")
    return total, times["Iterative"]


EVAL_GRAPH_WINDOWS = 5  # graphed: the warm-up, the capture, three replays


def eval_graph_run(model, windows, fwd, ridx, graphed_run):
    """The DSEC protocol (``DSEC_CONFIG``, bf16) of ``model`` over the
    rectified ``windows`` on the u32 wire with the card's rectification
    lookup, each window's metrics and u16 ``flow_bw`` read back by the eval
    CLI's ``MetricsConsumer`` on its thread. ``graphed_run``: the window
    step as the port runs it on the card (a CUDA graph from the second
    window on), its capture held until the reader thread has copied the
    first window's metrics to the host during it; else ``window.eager``.
    Returns each window's host metrics, flow, launches and synchronised
    seconds, the last carry and slot state, and the window step."""
    import gc
    import threading

    import torch

    from taming_event_flow_tpu_torch.ops import LAUNCHES
    from taming_event_flow_tpu_torch.pipeline import EvalPipeline
    from taming_event_flow_tpu_torch.pipeline import eval as pipe_eval
    from taming_event_flow_tpu_torch.training import graphed

    pipe = EvalPipeline(DSEC_CONFIG, model, device=DEVICE)
    pipe.cur_ridx = ridx
    pipe.cur_rect = fwd
    capturing, copied = threading.Event(), threading.Event()

    class CopiedDuringCapture(graphed.CudaGraph):
        def capture(self, fn, pool=None):
            def held():
                capturing.set()
                check(copied.wait(60), "graph (16) eval: the reader thread "
                      "copied nothing to the host during the capture")
                check(not gc.isenabled(), "graph (16) eval: the garbage "
                      "collector is on inside the capture")
                return fn()
            return super().capture(held, pool)

    if graphed_run:
        pipe._window_step.graphs.graph_cls = CopiedDuringCapture
    else:
        pipe._window_step = pipe._window_step.eager
    host = []
    to_host = pipe_eval._to_host

    def reading(dev_mets):
        if graphed_run and not copied.is_set():
            capturing.wait(60)
            try:
                out = to_host(dev_mets)
            finally:
                copied.set()
        else:
            out = to_host(dev_mets)
        host.append(out)
        return out

    pipe_eval._to_host = reading
    consumer = pipe_eval.MetricsConsumer(pipe.metric_names)
    flows, launches, secs = [], [], []
    try:
        with torch.inference_mode():
            for passes in windows:
                before = dict(LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in passes:
                    flow = pipe.ingest(pipe.ensure_bucket(b), {"ts": 0.0})
                dev_mets, flow_bw = pipe.boundary_outputs(passes[-1],
                                                          {"ts": 0.0})
                dev_mets["flow_bw"] = flow_bw
                consumer.put(dev_mets, "seq")
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                launches.append(launch_delta(before))
                flows.append(flow)
        consumer.close()
    finally:
        pipe_eval._to_host = to_host
    return {"host": host, "flows": flows, "carry": pipe.carry,
            "vstate": pipe.vstate.tensors(), "launches": launches,
            "secs": secs, "pipe": pipe}


def eval_graph_phase(seed, gpu):
    """Phase 16, eval: the DSEC window step as a CUDA graph. For the
    full-width RecEVFlowNet and E-RAFT (bf16, rectified, the u32 wire with
    the rectification looked up on the card), ``EVAL_GRAPH_WINDOWS``
    windows graphed (the first eager, the second captured while the eval
    CLI's reader thread copies the first's metrics to the host, the rest
    replayed) against the same windows run by ``window.eager``: every
    window's FWL, RSAT, AEE, u16 ``flow_bw`` and flow, the last carry and
    slot state bitwise equal; each window's launches exact (a replay adds
    those its capture counted to ``ops.LAUNCHES``); one capture, with the
    garbage collector off. A kernel missing from the graph would leave a
    stale buffer, which windows of other events would show. (CUPTI's
    kernel records of a replayed window are not counted here: late in a
    long process they missed one of its two row gathers, in every trace
    of a run.) Prints ms a window (synchronised) of both and peak memory.
    Returns the launches."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model

    fwd, bwd = radial_maps()
    ridx = rectified_index(bwd)[None]
    windows = rectified_windows(np.random.default_rng([seed, 16, 1]),
                                EVAL_GRAPH_WINDOWS, fwd, ridx[0])
    total = {k: 0 for k in TRAIN_LAUNCHES}
    for name, cfg, per_pass in (
            ("RecEVFlowNet", MODEL_CONFIG, 1),
            ("ERAFT", ERAFT_CONFIG, 1 + ERAFT_PASS_GATHERS)):
        model = build_model(dict(cfg), num_bins=2, device=DEVICE, seed=0)
        expect = {"splat_bilinear": 2, "gather_bilinear": PASSES * per_pass,
                  "gather_fused": 0, "row_gather": 2}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        got = eval_graph_run(model, windows, fwd, ridx, True)
        g_peak = torch.cuda.max_memory_allocated()
        want = eval_graph_run(model, windows, fwd, ridx, False)
        step = got["pipe"]._window_step
        graphs = [g for g in step.graphs.graphs.values() if g is not None]
        check(len(step.graphs.graphs) == 1 and len(graphs) == 1,
              f"graph (16) eval {name}: {len(graphs)} captures")
        for i, (a, b) in enumerate(zip(got["launches"], want["launches"])):
            check(a == b == expect, f"graph (16) eval {name} window {i}: "
                  f"launches {a} graphed, {b} eager, expected {expect}")
        for k in total:
            total[k] += sum(n[k] for n in got["launches"] + want["launches"])
        differ = []
        for i, (a, b) in enumerate(zip(got["host"], want["host"])):
            check_metrics(b, f"graph (16) eval {name} window {i}")
            differ += [f"window {i} {k}" for k in b
                       if np.asarray(a[k]).tobytes()
                       != np.asarray(b[k]).tobytes()]
        tensors = {f"flow {i}": (a, b) for i, (a, b) in enumerate(
            zip(got["flows"], want["flows"]))}
        tensors.update({f"carry {i}": ab for i, ab in enumerate(
            zip(got["carry"], want["carry"]))})
        tensors.update({f"slot state {i}": ab for i, ab in enumerate(
            zip(got["vstate"], want["vstate"]))})
        differ += [k for k, (a, b) in tensors.items()
                   if not torch.equal(bits(a), bits(b))]
        check(not differ, f"graph (16) eval {name}: graphed and eager "
              f"differ in {differ}")
        print(f"graph (16) eval {name}: {EVAL_GRAPH_WINDOWS} DSEC windows "
              f"graphed (captured while the reader thread copied) and eager "
              f"bitwise equal: FWL, RSAT, AEE, flow_bw, flows, carry, "
              f"{len(got['vstate'])} slot-state tensors (FWL "
              f"{[f'{float(h['fwl']):.9g}' for h in want['host']]})")
        (g,) = graphs
        check(g.launches == expect, f"graph (16) eval {name}: the "
              f"capture's launches {g.launches}, expected {expect}")
        replayed = float(np.mean(got["secs"][2:])) * 1e3
        eager = float(np.mean(want["secs"][1:])) * 1e3
        print(f"graph (16) eval {name} on {gpu}: {replayed:.3f} ms a window "
              f"replayed, {eager:.3f} eager (bf16, {RES[0]}x{RES[1]}, "
              f"P = {PASSES}, each window synchronised); capture window "
              f"{got['secs'][1] * 1e3:.1f} ms; the capture's launches "
              f"{g.launches}; peak memory {g_peak / 2**30:.3f} GiB graphed")
        del got, want, step, graphs, g, model
        torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------- E-RAFT phase

# E-RAFT's lookup (models/eraft.py): a gather a pyramid level and
# iteration, over one lane of (2r + 1)^2 taps a query position at 1/8 of the
# padded input; in training also a splat of the map gradient a gather (the
# coordinates are detached, so no fused gather)
ERAFT_CONFIG = {"name": "ERAFT", "iters": 12, "corr_levels": 4,
                "corr_radius": 4, "hidden_dim": 128, "context_dim": 128,
                "fnet_dim": 256}
ERAFT_TRAIN = (2, (128, 128), 2)  # B, resolution, passes
ERAFT_PASS_GATHERS = ERAFT_CONFIG["iters"] * ERAFT_CONFIG["corr_levels"]


def eraft_centres(rng, batch, h, w):
    """Lookup centres ``[B, 2, h, w]`` float32 (x, y) at ``h x w`` query
    positions, in a random order: a third on the pixel grid (the first
    iteration's), a third within 3 px of it, a third up to 40 px off
    (most of their taps out of frame at every level)."""
    import torch

    from taming_event_flow_tpu_torch.models import eraft

    n = h * w
    third = n // 3
    flow = np.zeros((batch, 2, n), np.float32)
    flow[..., third:2 * third] = rng.uniform(-3, 3, (batch, 2, third))
    flow[..., 2 * third:] = rng.uniform(-40, 40, (batch, 2, n - 2 * third))
    flow = flow[..., rng.permutation(n)].reshape(batch, 2, h, w)
    return (eraft.coords_grid(batch, h, w, DEVICE)
            + torch.from_numpy(flow).to(DEVICE))


def eraft_pyramid(rng, batch, h, w, dim=256):
    """The float32 correlation pyramid of two seeded feature maps ``[B,
    dim, h, w]`` (``models/eraft.py: corr_pyramid``)."""
    import torch

    from taming_event_flow_tpu_torch.models import eraft

    f1, f2 = (torch.from_numpy(rng.standard_normal((batch, dim, h, w))
                               .astype(np.float32)).to(DEVICE)
              for _ in range(2))
    return eraft.corr_pyramid(f1, f2, ERAFT_CONFIG["corr_levels"])


def eraft_taps(pyramid, coords):
    """Each level's gather input as ``models/eraft.py: lookup`` builds it:
    ``(maps [B h w, h_l, w_l, 1], loc [B h w, K, 2])``."""
    from taming_event_flow_tpu_torch.models import eraft

    b, _, h, w = coords.shape
    centre = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2).flip(-1)
    offsets = eraft.tap_offsets(ERAFT_CONFIG["corr_radius"], coords.device)
    return [(maps, (centre / 2 ** level + offsets).contiguous())
            for level, maps in enumerate(pyramid)]


def out_of_frame(loc, h, w):
    """Share of the taps in ``loc [..., 2]`` none of whose corners lies in
    an ``h x w`` map."""
    y, x = loc[..., 0], loc[..., 1]
    return float(((y <= -1) | (y >= h) | (x <= -1) | (x >= w)).float()
                 .mean())


def eraft_phase(seed, gpu):
    """Phase 17: E-RAFT's correlation lookup on the card (``models/
    eraft.py``), at the shapes the model runs the bilinear kernels in: (a)
    at DSEC's 480x640 (B = 1, 60x80 = 4,800 lanes of 81 taps), every level
    of a seeded correlation pyramid gathered by the kernel at ``centre /
    2^l + tap offsets`` bitwise against ``gather_bilinear_plain``, with
    centres on the grid, near it and far outside the frame, and the whole
    ``lookup`` bitwise against the same built from the plain gathers; (b)
    at the training shape (128x128, B = 2: 512 lanes), the map gradient
    through the autograd Function (the splat kernel) within KERNEL_RTOL of
    ``splat_bilinear_plain`` at every level; (c) the launches of one DSEC
    eval pass (the bf16 eval copy, ``training/step.py: _eval_net``) and of
    one training forward and backward of two passes with the carry, each
    exact; the lookup's time and its memory bound. Returns the launches,
    and the lookup's and the map gradient's timings."""
    import torch

    from taming_event_flow_tpu_torch.models import build_model, eraft
    from taming_event_flow_tpu_torch.ops import (
        LAUNCHES,
        cuda_warp,
        reset_launches,
    )
    from taming_event_flow_tpu_torch.ops.warp import gather_values
    from taming_event_flow_tpu_torch.training.step import _eval_net

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 17])
    radius = ERAFT_CONFIG["corr_radius"]
    k = (2 * radius + 1) ** 2
    total = {name: 0 for name in LAUNCHES}

    # (a) the lookup at DSEC's shape
    h, w = (n // 8 for n in RES)
    pyramid = eraft_pyramid(rng, 1, h, w)
    coords = eraft_centres(rng, 1, h, w)
    shares = []
    for level, (maps, loc) in enumerate(eraft_taps(pyramid, coords)):
        got = cuda_warp.gather_bilinear(maps, loc)
        want = cuda_warp.gather_bilinear_plain(maps, loc)
        check(torch.equal(got, want), f"eraft (17) lookup level {level} "
              f"({tuple(maps.shape)}, {tuple(loc.shape)}): not bitwise, "
              f"widest gap {float((got - want).abs().max())}")
        shares.append(out_of_frame(loc, maps.shape[1], maps.shape[2]))
    check(0 < shares[0] < 1, f"eraft (17) lookup: out-of-frame shares "
          f"{shares}, not a mix")
    plain = torch.cat([cuda_warp.gather_bilinear_plain(maps, loc)
                       for maps, loc in eraft_taps(pyramid, coords)], dim=1)
    plain = plain.reshape(1, h, w, -1).permute(0, 3, 1, 2)
    reset_launches()
    got = eraft.lookup(pyramid, coords, radius)
    check(LAUNCHES["gather_bilinear"] == len(pyramid),
          f"eraft (17) lookup: launches {dict(LAUNCHES)}")
    check(torch.equal(got, plain), "eraft (17) lookup: the model's lookup "
          "is not bitwise the plain gathers'")
    print(f"eraft (17) lookup at {h}x{w} queries, 81 taps, levels "
          f"{[tuple(p.shape[1:3]) for p in pyramid]}: kernel bitwise the "
          f"plain gather at every level and through models/eraft.py: "
          f"lookup; out-of-frame tap shares "
          f"{[round(v, 4) for v in shares]}")
    lookup = lambda: eraft.lookup(pyramid, coords, radius)  # noqa: E731
    lanes = h * w
    nbytes = lanes * len(pyramid) * ((2 * radius + 2) ** 2 + k + 2) * 4
    b_ms, _ = bound_ms(nbytes, 0)
    timing = {"lookup": {"shape": f"{lanes} lanes x {k} taps x "
                                  f"{len(pyramid)} levels, C = 1",
                         "ms": time_ms(lookup),
                         "device_ms": device_ms(lookup, "gather_kernel"),
                         "host_us": host_us(lookup), "bound_ms": b_ms}}
    del pyramid, coords, got, plain, want

    # (b) the map gradient at the training shape
    batch, res, passes = ERAFT_TRAIN
    th, tw = (n // 8 for n in res)
    pyramid = eraft_pyramid(rng, batch, th, tw)
    coords = eraft_centres(rng, batch, th, tw)
    worst = 0.0
    for level, (maps, loc) in enumerate(eraft_taps(pyramid, coords)):
        maps = maps.detach().requires_grad_(True)
        g = torch.from_numpy(rng.standard_normal(
            (loc.shape[0], k, 1)).astype(np.float32)).to(DEVICE)
        gather_values(maps, loc).backward(g)
        want = cuda_warp.splat_bilinear_plain(loc, g, tuple(maps.shape[1:3]))
        torch.cuda.synchronize()
        gap = float((maps.grad - want).abs().max())
        check(torch.allclose(maps.grad, want, rtol=KERNEL_RTOL,
                             atol=KERNEL_ATOL),
              f"eraft (17) map gradient level {level} "
              f"({tuple(maps.shape)}): widest gap {gap}")
        worst = max(worst, gap)
        if level == 0:
            splat = lambda: cuda_warp.splat_bilinear(  # noqa: E731
                loc, g, tuple(maps.shape[1:3]))
            timing["map_gradient"] = {
                "shape": f"{loc.shape[0]} lanes x {k} taps, "
                         f"{th}x{tw}, C = 1",
                "ms": time_ms(splat),
                "device_ms": device_ms(splat, "splat"),
                "host_us": host_us(splat)}
    print(f"eraft (17) map gradient at {th}x{tw} queries, B = {batch}: "
          f"the splat kernel within {KERNEL_RTOL} of the plain splat at "
          f"every level (widest gap {worst:.3e})")
    del pyramid, coords

    # (c) launches of an eval pass and of a training forward and backward
    model = build_model(ERAFT_CONFIG, num_bins=2, device=DEVICE, seed=seed)
    net = _eval_net(model, torch.bfloat16)
    x = torch.from_numpy(rng.poisson(0.3, (1,) + RES + (2,))
                         .astype(np.float32)).to(DEVICE)
    carry = net.init_state(1, *RES, torch.bfloat16, DEVICE)
    with torch.no_grad():
        _, carry = net(x.bfloat16(), carry)  # cuDNN's first calls
        reset_launches()
        flows, carry = net(x.bfloat16(), carry)
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    check(launches == dict({n: 0 for n in LAUNCHES},
                           gather_bilinear=ERAFT_PASS_GATHERS),
          f"eraft (17) eval pass: launches {launches}, expected "
          f"{ERAFT_PASS_GATHERS} gathers")
    check(bool(torch.isfinite(flows).all()), "eraft (17) eval pass: flows "
          "not finite")
    for n in total:
        total[n] += launches[n]
    with torch.no_grad():
        pass_ms = time_ms(lambda: net(x.bfloat16(), carry), reps=5,
                          warmup=1)
    del net, flows, carry

    model.train()
    x = torch.from_numpy(rng.poisson(0.3, (batch,) + res + (2,))
                         .astype(np.float32)).to(DEVICE)
    carry = model.init_state(batch, *res, torch.float32, DEVICE)
    reset_launches()
    loss = 0.0
    for _ in range(passes):
        flows, carry = model(x, carry)
        loss = loss + (flows * flows).mean()
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    per = passes * ERAFT_PASS_GATHERS
    check(launches == dict({n: 0 for n in LAUNCHES}, gather_bilinear=per,
                           splat_bilinear=per),
          f"eraft (17) training forward and backward: launches {launches}, "
          f"expected {per} gathers and {per} splats")
    check(all(bool(torch.isfinite(p.grad).all()) for p in
              model.parameters() if p.grad is not None),
          "eraft (17) training: a gradient is not finite")
    for n in total:
        total[n] += launches[n]
    print(f"eraft (17) eval pass (bf16 copy, eval mode, {RES[0]}x{RES[1]}) "
          f"{pass_ms:.3f} ms synchronised on {gpu}; launches a pass "
          f"{ERAFT_PASS_GATHERS} gathers; training forward and backward of "
          f"{passes} passes at {res[0]}x{res[1]}, B = {batch}: {per} "
          f"gathers and {per} splats")
    print(f"phase 17 eraft: {time.perf_counter() - t_phase:.1f} s on "
          f"{gpu}; launches {total}")
    del model, x, carry, loss
    torch.cuda.empty_cache()
    return total, timing


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler breakdown")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from taming_event_flow_tpu_torch.ops import (
        kernel_build,
        set_deterministic,
        set_tf32,
    )

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(json.dumps({"imports": optional_imports()}))
    set_tf32(False)
    set_deterministic()
    lib = kernel_build.load()
    print(f"built {lib.path} in {lib.build_seconds:.2f} s")
    for name, regs, spill in kernel_build.ptxas_report(lib.build_log):
        print(f"  ptxas: {name}: {regs} registers, {spill} bytes spilled")

    rng = np.random.default_rng(args.seed)
    # the clustered splat input draws from a stream of its own, so the
    # other phases see the same data as before it
    kernels = kernel_phase(rng, np.random.default_rng([args.seed, 2]))
    kernels.update(fused_phase(rng, args.seed))
    # the row-gather and rectified phases draw from a stream of their own,
    # so the earlier phases see the same data as before them
    rng_rect = np.random.default_rng([args.seed, 1])
    kernels.update(row_gather_phase(rng_rect))
    eval_launches, ms_pass, model = slice_phase(rng, N_WINDOWS, args.profile)
    rect_launches, ms_rect, ms_rect_host = rectified_phase(
        rng_rect, model, N_WINDOWS, ms_pass, args.profile)
    del model
    train_launches, ms_step = train_phase(rng, args.profile)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="train_cli_", dir=build)
    try:
        cli_launches, ms_cli, ms_loader, runid, train_data = \
            train_cli_phase(args.seed, work)
        per_window = {k: v // N_WINDOWS for k, v in eval_launches.items()}
        eval_cli_launches, ms_eval_cli = eval_cli_phase(
            args.seed, work, runid, per_window, gpu)
        registry_launches, ms_linear, ms_linear_window = registry_phase(
            args.seed, work, train_data, per_window, gpu)
        par_launches, par_times = parallel_phase(args.seed, work, runid)
        option_launches = options_phase(args.seed, work, train_data, gpu)
        jax_launches, stream_times = jax_run_phase(args.seed, work,
                                                   train_data, per_window,
                                                   gpu)
        trans_launches, trans_ms = transposed_phase(
            args.seed, work, train_data, per_window, gpu, args.profile)
        det_launches = determinism_phase(args.seed, work, train_data, gpu)
        bench_launches, bench = bench_phase(gpu)
        graph_launches, graph_ms = graph_phase(args.seed, gpu)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    eraft_launches, eraft_times = eraft_phase(args.seed, gpu)
    kernels["gather_bilinear"]["eraft_lookup"] = eraft_times["lookup"]
    kernels["splat_bilinear"]["eraft_map_gradient"] = \
        eraft_times["map_gradient"]

    paths = {"dsec_eval": eval_launches, "dsec_rectified": rect_launches,
             "train": train_launches, "train_cli": cli_launches,
             "eval_cli": eval_cli_launches, "registry": registry_launches,
             "parallel": par_launches, "options": option_launches,
             "jax_run": jax_launches, "transposed": trans_launches,
             "determinism": det_launches, "bench": bench_launches,
             "graph": graph_launches, "eraft": eraft_launches}
    entries = []
    for name in ("splat_bilinear", "gather_bilinear", "gather_fused",
                 "row_gather"):
        e = dict(kernels[name])
        e["launches_by_path"] = {p: n[name] for p, n in paths.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        entries.append(e)
    for e in entries:
        rows = [e] + ([dict(e["gather_backward"], name="  C=2")]
                      if "gather_backward" in e else [])
        for r in rows:
            print(f"{r['name']}: event {r['ms']:.5f} ms, device "
                  f"{r['device_ms']:.5f} ms (wrapper and launch "
                  f"{r['ms'] - r['device_ms']:.5f} ms), host "
                  f"{r['host_us']:.3f} us per call; library event "
                  f"{r['library_ms']:.5f} ms, device "
                  f"{r['library_device_ms']:.5f} ms, host "
                  f"{r['library_host_us']:.3f} us; bound "
                  f"{r['bound_ms']:.5f} ms")
    for tag, r in kernels["gather_fused"]["shapes"].items():
        print(f"gather_fused {tag}: event {r['ms']:.5f} ms, device "
              f"{r['device_ms']:.5f} ms, host {r['host_us']:.3f} us per "
              f"call; bound {r['bound_ms']:.5f} ms")
    print(f"slice_ms_per_pass {ms_pass:.4f}")
    print(f"rectified_ms_per_pass {ms_rect:.4f} (derived on the card), "
          f"{ms_rect_host:.4f} (host-built input shipped)")
    print(f"train_ms_per_step {ms_step:.4f}")
    print(f"train_cli_ms_per_step {ms_cli:.4f} (loop wall, B=1); loader "
          f"{ms_loader:.4f} ms per loss window on the host")
    print(f"eval_cli_ms_per_gt_window {ms_eval_cli:.4f} (CLI wall, DSEC "
          f"protocol, bf16)")
    print(f"linear_train_ms_per_step {ms_linear:.4f} (B={TRAIN_B}, f32); "
          f"linear_window_ms {ms_linear_window} (DSEC, bf16)")
    print("parallel_ms (two gloo ranks sharing one card, not a scaling "
          "figure): " + ", ".join(f"{k} {v:.4f}"
                                  for k, v in par_times.items()))
    print(f"transposed_train_ms_per_step {trans_ms[1]:.4f} (default "
          f"{trans_ms[0]:.4f} in the same phase; B={TRAIN_B}, f32)")
    print("stream_ms_per_pass (480x640, the JAX run): " + ", ".join(
        f"{w} p50 {p50:.3f} p99 {p99:.3f}"
        for w, (p50, p99) in stream_times.items()))
    print(f"bench_torch {bench['value']} Mevents/s (B=8, "
          f"{bench['detail']['train_step_ms']} ms/step, mfu "
          f"{bench['detail']['mfu']}); B=1 "
          f"{bench['detail']['train_b1']['train_step_ms']} ms/step; DSEC "
          f"{bench['detail']['dsec_480x640_inference']['pass_ms']} ms/pass")
    print(f"graph_train_ms_per_step {graph_ms[0]:.4f} replayed, "
          f"{graph_ms[1]:.4f} eager (B={TRAIN_B}, f32, synchronised)")
    for tag, r in eraft_times.items():
        print(f"eraft {tag} ({r['shape']}): event {r['ms']:.5f} ms, device "
              f"{r['device_ms']:.5f} ms, host {r['host_us']:.3f} us per "
              f"call" + (f"; bound {r['bound_ms']:.5f} ms"
                         if "bound_ms" in r else ""))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke check of the PyTorch / CUDA port (``ufm_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``ufm_torch/csrc`` (nvcc, sm_90a, one
process per source, all started together) and reads their SASS (the
attention libraries must hold wgmma (HGMMA) instructions, and ptxas must not
have serialized them; the window library must hold TMA loads (UTMALDG) and
use no local memory), holds each kernel against its plain PyTorch version
at the main paths' shapes (the attention backward also for bitwise
repeatability; the window kernel on five flows, iid, smooth and split, with
its count of TMA-staged tiles held equal to ``staged_tiles``, and at the
rest of its domain, C = 5, 12, 32, 64 and P = 7, 9; the window backward
against its plain version in fp64, dq, dflow and dbias bitwise repeatable,
at UFM-Refine's training shape and the same widths), holds the
bf16 GELU kernel bit for bit to the JAX package's output on every finite
bf16 input (``tests/golden/gelu_bf16_table.npz``) and to its plain version,
holds the fused fc1 + GELU kernel (``linear_gelu``: the MLP's first product
with the GELU as its epilogue) to the GELU of its own pre-activation bit for
bit, to the exact product and to its plain version at the MLP shapes and at
row, K and N tails, and to the table on every finite bf16 pre-activation,
and in its training launch (y and the pre-activation h in one launch) to
the inference launch and to the plain version, its gradient to the two-op
route's; holds the GELU gradient kernel (``gelu_backward``) bit for bit to
the JAX package's VJP on every finite bf16 input under six cotangent sets
(``tests/golden/gelu_bf16_vjp_table.npz``) and to its plain version at the
training shapes; then drives three paths with seeded random weights at full
width:

- UFM-Base (ViT-L/14 encoder, 24 layers; 12 info-sharing layers; both DPT
  heads; 560x420), answering requests through
  ``predict_correspondences_batched``: 36 flash-attention launches and 36
  fused fc1 + GELU launches (one per transformer block's MLP) per forward;
  the same forward with a gradient recorded gives the same flow bit for
  bit, and on the two-op path (grad mode under activation checkpointing:
  fc1, then the GELU kernel) holds the fused one's flow
  (``fused_mlp_model``);
- UFM-Refine (the same backbone and heads, the patch-MLP classification head,
  the UNet and the window refinement), the same way: 36 flash-attention
  launches and 1 window-refinement launch per forward;
- UFM-Base training at batch 2 on 420x560 (``make_train_step`` and ``fit``,
  fp32 master weights): 36 flash-attention forward launches and 36 backward
  calls, 36 fused fc1 + GELU launches (writing the pre-activation) and 36
  GELU gradient launches per step; UFM-Refine the same way (``refine_train``): also one
  window forward and one window backward launch a step, no call of the
  window refinement's plain versions, its gradients at batch 1 held to the
  plain window refinement's and to the plain step's with fp32 attention,
  and reported against the plain step's with bf16 attention
  (``refine_train_self_check``).

The port's parallel and training options, at the same width: the sharded
step (``make_sharded_train_step``: FSDP2 over one NCCL rank, a (1, 1, 1)
mesh; the card is alone) held to ``make_train_step`` from the same weights,
and ``fit(mesh=...)`` through a checkpoint and its resumption
(``sharded_train``); ``make_data_parallel_forward`` of UFM-Base and
UFM-Refine at batch 2, held to their own forwards (``data_parallel``: 36 and
36 + 1 launches); the batch-2 step under ``train_remat`` with no policy and
each of the JAX package's policy names, with its time, peak memory and
launches (attention: 72 where the backward runs the attention forward
again, 36 where a policy keeps its outputs; the MLPs: fc1 and the
standalone GELU under remat, 72 or 36 launches, the fused kernel without),
its gradients held to no remat's (``remat``); and UFM-Base with the ``moge_conv`` head, held to its
plain-attention forward (``moge``).

The rest of the attention forward's domain (fp32 and fp16 at any head dim,
bf16 at D != 64) runs the mma kernel (``csrc/flash_attention_fwd_any.cu``),
held to its plain version at ten cases (``kernel``, ``flash_attention_fwd_any``);
the rest of the backward's domain runs the mma backward
(``csrc/flash_attention_bwd_any.cu``), held to fp64 and for bitwise
repeatability at ten cases (``kernel``, ``flash_attention_bwd_any``);
the repository's two tiny fp32 anchors run on it against their CPU goldens,
built from ``tests/golden/torch_port_fp32_anchor.npz`` (``fp32_anchor``);
UFM-Base at full width in fp32 answers a 480x640 request eagerly and
captured, 36 launches of it a forward, none of the wgmma kernel, its flow
held to plain attention (``fp32_path``); and ``ufm infer`` runs in this
process on the bundled parallax pair with the trained tiny checkpoint, its
pair, checkpoint and panels read and written by the port's own codecs, its
flow held to the port's CPU run (``entry``). UFM-Base in fp32 trains at
batch 2 on 420x560 (``fp32_train``: ``make_train_step``, then ``fit``; 36
mma forward launches and 36 mma backward calls a step, none of the
wgmma or bf16 MLP kernels; its gradients at batch 1 held to plain attention
with TF32 off); ``fine_tune`` fits the trained tiny checkpoint on the card
and on the CPU (losses held together, TF32 off) and takes one train step of
the tiny config in bf16 (D = 32 / 24: the mma kernels in bf16). Every
bf16 D = 64 training path makes no mma backward call
(``bf16_training_paths``).

Around them: the kernel path of two tiny models at head dim 64 held to the
JAX package's bf16 goldens (``tests/golden/torch_port_bf16_d64_*.npz``, no JAX
needed: ``bf16_golden``); the flagship UFM-Base saved with
``save_pretrained`` and read back with ``from_pretrained``, its answer bitwise
the same (``checkpoint``); tiled inference of a 1080x1920 pair (a coarse
forward, then 20 tiles in forwards of 16 and 4: 108 attention launches;
``tiled``, with its own plain-attention check), and the same with UFM-Refine
(``tiled_refine``: 36 attention and 1 window launch a forward, each forward
held to the plain window refinement's); EPE and cycle metrics of
three 540x720 pairs with analytic flow (``eval``); and the flow moved by
cuDNN's TF32 in the fp32 heads (``tf32``).

The models answer through captured predict programs (one CUDA
graph per key, replayed): ``captured`` holds them against the eager pipeline
(UFM-Base at batch 1 and 2, UFM-Refine at batch 1; latency, the idle share of
one profiled window of requests, launches per replay by the counters and by
the profiler); ``batch_rows`` shows that a pair's answer does not depend on
the other pairs of its batch, and that its slot moves it only through
cuDNN's TF32 convolutions; ``serve`` drives the HTTP daemon (``UFMServer``,
lanes of 4) with 8 client threads over loopback, each response held to a
direct predict of its pair among other neighbours; ``stream`` drives
``stream_predict`` on the card.
The UFM-Refine stage breakdown (``refine_path``) runs eagerly: its CUDA
events sit around Python calls that a replay does not make.

Every model variant through every entry point of the JAX package (each
path's launches counted exactly, and no call of the plain attention or
window refinement): ``refine_serve`` and ``refine_stream`` drive UFM-Refine
through the daemon and ``stream_predict`` as ``serve`` and ``stream`` drive
UFM-Base, and ``stream_predict_staged`` with the network's backbone and
refinement tail as its two stages; ``serve`` and ``refine_serve`` give the
batch-size dependence in px (a pair at batch 4 against the pair alone,
held within 0.1 px); ``artifact_batch4`` runs ``ufm export --random-init
--batch 4`` for both models in this process, holds each artifact bitwise to
the live network and serves it through ``ufm serve --artifact`` (the lane
width pinned to 4) under 8 clients; ``uniflowmatch`` runs the variant
without the uncertainty head (requests eager and captured, a batch-1
artifact, training with its gradients against plain attention);
``refine_fp32`` runs UFM-Refine in fp32 (the mma attention pair beside the
window pair: requests, training, gradients against the plain step);
``refine_remat`` the UFM-Refine step under two remat policies and
``refine_sharded`` its sharded step on the world-1 mesh.

Deployment (the kernels are dispatcher ops, ``ufm_torch/ops/library.py``, so
``torch.export`` traces them as graph nodes): ``export`` exports the
flagship UFM-Base on the card at batch 1 (parameters stored in fp32 and in
bf16), loads it back and holds its raw outputs to the live network's (36
attention launches a call, by the counters and the profiler); ``export_cpu``
traces the flagship on the CPU and runs the moved program on the card;
``artifact_predict`` holds ``ArtifactUFM`` (the artifact in the captured
predict API) to the live model on a 480x640 pair; ``serve_artifact`` starts
``python -m ufm_torch.cli serve --artifact`` and sends it one request;
``artifact_refine`` exports UFM-Refine (36 + 1 launches a call);
``loader`` builds the native loader from the repository alone (no image
library linked: the port's own PNG / JPEG decoders), decodes PNG files
written here, the committed JPEG cases (bitwise their committed libjpeg and
cv2 decodes, through the loader and ``read_rgb``) and the committed
1080x1920 JPEG pair (against libjpeg's SHA-256; decode ms and frames/s at 1,
2, 4 and 8 threads), and streams 32 pairs of it from the files into
UFM-Base, bitwise the stream of the same frames from memory; then the same
for the pair transcoded to arithmetic coding (decodes against the Huffman
pair's SHA-256s, the stream bitwise the Huffman files' stream), and frame 1
of each pair cut inside its AC scans (libjpeg's block-smoothed SHA-256);
``jpeg_entry`` runs ``ufm infer`` on that pair in this process and sends it
as a JSON request to a ``UFMServer``, with cv2 and PIL unimportable, runs
``ufm infer`` on the arithmetic pair (bitwise the Huffman pair's flow) and
sends a JSON request carrying a cut JPEG (a 400 naming its key).
Artifacts are written under ``build/`` and removed at the end.

Each path's launch counts are set to 0 just before it and read just after;
every inference path that runs the bf16 backbone launches the fused fc1 +
GELU kernel 36 times a forward and the standalone GELU kernel never; every
training path the GELU kernel 36 times a step (72 under a remat policy that
recomputes it) and the fused kernel never.
Each phase prints one JSON line; any failed check raises and the script exits
non-zero without printing a result. The last three lines are the card's name
and power limit (as ``nvidia-smi`` prints them), the kernels' summary, and
``{"ok": true, "device": {...}}``.

Needs a CUDA device and the ``ufm_torch`` package beside this script.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import unittest.mock

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # without tensor cores
PEAK_TF32_FLOPS = 495e12
# fp32-accurate products on the tensor cores: three TF32 products (3xTF32)
# for each fp32 one, i.e. 165 TFLOP/s of fp32 work
PEAK_FP32_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12

# main-path attention shapes at batch 1 and their calls per forward
ATTN_SHAPES = (
    ("encoder", (2, 1201, 16, 64), 24),
    ("info_sharing", (1, 2400, 12, 64), 12),
    ("ragged", (1, 77, 2, 64), 0),
)
LAUNCHES_PER_FORWARD = sum(n for _, _, n in ATTN_SHAPES)  # 36
# the tiled path's attention shapes (16 tiles a forward) and their calls per
# such forward; timed beside the batch-1 shapes
TILED_ATTN_SHAPES = (
    ("tiled_encoder", (32, 1201, 16, 64), 24),
    ("tiled_info_sharing", (16, 2400, 12, 64), 12),
)

# kernel vs the fp32 reference on the same bf16 inputs: at most twice the
# plain bf16 version's error (which rounds the logits to bf16), and never
# held tighter than 4e-3 (a few bf16 ulps of outputs of order 1)
KERNEL_ERR_FLOOR = 4e-3

# main-path attention shapes of a batch-2 train step (the encoder sees both
# views: 2B) and their backward calls per step
ATTN_BWD_SHAPES = (
    ("encoder", (4, 1201, 16, 64), 24),
    ("info_sharing", (2, 2400, 12, 64), 12),
    ("ragged", (1, 77, 2, 64), 0),
)
# backward kernel vs the fp32 reference: each of dq, dk, dv within twice the
# plain bf16 backward's error, and never held tighter than two bf16 ulps of
# the reference's largest element (2^-7 of it)
BWD_ERR_FLOOR_REL = 2.0**-7
# the forward's row log-sum-exp vs torch.logsumexp of the fp32 scores
# (values ~10: fp32 rounding of the scores and of exp2 / log2)
LSE_ATOL = 1e-4
# time_ms queues each timed batch behind this many cycles of device sleep
# (~25 ms at 1.98 GHz), far longer than the host takes to enqueue a batch
QUEUE_SLEEP_CYCLES = 50_000_000
# host time per launch: back-to-back launches without a sync at a shape whose
# kernels take less device time than the host spends launching them
LAUNCH_HOST_REPS = 1000
# the JAX package's bf16 GELU over every bf16 bit pattern (written by
# tests/test_torch_port_gelu.py): the kernel must give these bits on every
# finite input
GELU_TABLE = os.path.join(HERE, "tests", "golden", "gelu_bf16_table.npz")
# fp32 operations per element on the kernel's main branch (-x c, 0.5 x, t^2,
# 8 Horner steps of 2, 1 - t P, h e): the operations bound's count
GELU_OPS_PER_ELEMENT = 22
# element counts off the 8-element vector and an empty tensor
GELU_ODD_COUNTS = (1, 7, 8 * 1001 + 3, 0)
# the MLP hidden activations of one batch-1 forward, and their MLPs per
# forward: the encoder's (2 views x 1201 tokens, 4096) and the info
# sharing's (2400 tokens, 3072)
GELU_SHAPES = (("encoder", (2, 1201, 4096), 24), ("info_sharing", (1, 2400, 3072), 12))
# GELU launches per forward of either model: one per transformer block's MLP
GELU_PER_FORWARD = sum(n for _, _, n in GELU_SHAPES)  # 36
# the JAX package's gradient of the bf16 GELU (jax.vjp of fast_exact_gelu)
# over every bf16 bit pattern under six cotangent sets (written by
# tests/test_torch_port_gelu_vjp.py): the gradient kernel must give these bits
# on every finite input
GELU_VJP_TABLE = os.path.join(HERE, "tests", "golden", "gelu_bf16_vjp_table.npz")
# fp32 operations per element on the gradient kernel's main branch, an fma
# counted as 2 (csrc/gelu_bf16_bwd.cu: -x c, t^2, P's 8 Horner steps, 1 - t P,
# the half share's 2 products, 0.5 x, h g, t g_p, the 8 transposed steps (an
# fma and a product, the last product unused), tc g_u, its double, the
# selected sum (an fma and an add), the t share's product and the last sum):
# the operations bound's count
GELU_BWD_OPS_PER_ELEMENT = 55
# the MLP hidden activations of one batch-2 train step and their MLPs a step
GELU_BWD_SHAPES = (("encoder", (4, 1201, 4096), 24), ("info_sharing", (2, 2400, 3072), 12))
# cotangents at the training shapes: seeded normals, and the same with this
# share of them replaced by +0, -0 and values of 1e-38 (the zeros' signs and
# the flushes)
GELU_BWD_ZERO_SHARE = 0.05
# the fused fc1 + GELU kernel (ufm_torch::linear_gelu_bf16): (M, K, N) of
# the MLPs of one batch-1 forward and their calls, of one forward of 16 tiles
# (the encoder at batch 32, info sharing at 16), and rows off the 128-row
# tile with K / N tails
LINEAR_GELU_SHAPES = (("encoder", (2402, 1024, 4096), 24), ("info_sharing", (2400, 768, 3072), 12))
LINEAR_GELU_TILED_SHAPES = (("encoder_tiled", (38432, 1024, 4096), 24), ("info_sharing_tiled", (38400, 768, 3072), 12))
LINEAR_GELU_ODD = ((1, 1024, 4096), (7, 1024, 4096), (129, 1024, 4096), (130, 48, 200))
# y against the plain version (F.linear, then the GELU's plain chain), relative L2
LINEAR_GELU_REL_L2 = 4e-3
# the fused op's training route at the MLP shapes of a batch-2 train step, (M,
# K, N) and calls a step; its dx, dw and db against the two-op route's
# (F.linear, then the GELU op: the same gradient kernel and products on
# F.linear's h, which differs from the kernel's h by an ulp where fp32 sums
# round apart), relative L2: the bar of y against the plain version, for the
# same cause
LINEAR_GELU_TRAIN_SHAPES = (("encoder", (4804, 1024, 4096), 24), ("info_sharing", (4800, 768, 3072), 12))
LINEAR_GELU_GRAD_REL_L2 = LINEAR_GELU_REL_L2
# the bias's spread in the kernel's cases (phase_linear_gelu.operands)
LINEAR_GELU_BIAS_STD = 0.1
# the share of h allowed more than one bf16 ulp from the exact product + bias
# (fp32 sums in another order than the reference's)
LINEAR_GELU_ULP_SHARE = 1e-3
# fc2's input gradient with the GELU gradient as its epilogue
# (ufm_torch::linear_gelu_bf16_bwd) at the train step's MLP shapes: g (M, N2),
# w2 (N2, N), h (M, N) = LINEAR_GELU_TRAIN_SHAPES' (M, K, N) with N2 = K; its
# epilogue's issue floor counts this many warp instructions a 32-element warp
# slice (the VJP chain's ~60 instructions an element, csrc/gelu_bf16_bwd.cu)
# at one a scheduler a clock, four schedulers an SM, at the card's maximum SM clock
LINEAR_GELU_BWD_ISSUE_INSTR = 60
LINEAR_GELU_BWD_ODD = ((1, 64, 128), (4803, 1024, 4096), (300, 200, 136))
# the SwiGLU FFN's w12 with the gate in its epilogue (ufm_torch::linear_swiglu_bf16):
# (M, K, H) of the 40 ViT-g/14 blocks of a batch-1 and a batch-4 forward
# (M = 2B x 1205 tokens) and their calls, and rows, K and H off the tiles
LINEAR_SWIGLU_SHAPES = (("vitg_b1", (2410, 1536, 4096), 40), ("vitg_b4", (9640, 1536, 4096), 40))
LINEAR_SWIGLU_ODD = ((1, 1536, 4096), (1077, 1536, 4096), (130, 48, 200))
# the share of y allowed more than one bf16 ulp from the exact gate of the
# exact halves rounded to bf16 (fp32 sums land a half across a rounding
# boundary), and y against the composition (F.linear, then the gate), relative L2
LINEAR_SWIGLU_ULP_SHARE = 5e-3
LINEAR_SWIGLU_REL_L2 = 4e-3
ATTENTION_LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd")
# the attention pair over the rest of the domain (TF32 mma.sync)
ANY_LIBRARIES = ("flash_attention_fwd_any", "flash_attention_bwd_any")
# the kernels the profiler counts, by the name of their __global__ function
KERNEL_NAMES = ("flash_attention_fwd_kernel", "window_refinement_fwd_kernel", "gelu_bf16_fwd_kernel",
                "linear_gelu_bf16_fwd_kernel", "flash_attention_fwd_any_kernel", "window_refinement_fwd_any_kernel",
                "linear_swiglu_bf16_fwd_kernel")

# the mma attention forward (csrc/flash_attention_fwd_any.cu), the rest
# of the TPU kernel's domain: (case, dtype, q (B, Sq, H, D), Sk, calls a
# batch-1 forward of UFM-Base in fp32). The fp32 flagship's two shapes, the
# fp32 anchors' (head dims 32 and 24), fp32 at D = 128 and 256 (the kernel's
# wider instances), bf16 at D = 32 and 128 (the ViT-L width in 32 or 8
# heads), fp16 at D = 64 and a ragged fp16 case (Sq != Sk, D not a multiple
# of 8); S = 1201 leaves a ragged last 64-key tile (49 keys)
ANY_ATTN_CASES = (
    ("fp32_encoder", "float32", (2, 1201, 16, 64), 1201, 24),
    ("fp32_info_sharing", "float32", (1, 2400, 12, 64), 2400, 12),
    ("fp32_anchor_encoder", "float32", (4, 13, 2, 32), 13, 0),
    ("fp32_anchor_info_sharing", "float32", (2, 24, 2, 24), 24, 0),
    ("fp32_d128", "float32", (2, 1201, 8, 128), 1201, 0),
    ("fp32_d256", "float32", (1, 1201, 4, 256), 1201, 0),
    ("bf16_d32", "bfloat16", (2, 1201, 32, 32), 1201, 0),
    ("bf16_d128", "bfloat16", (2, 1201, 8, 128), 1201, 0),
    ("fp16_d64", "float16", (2, 1201, 16, 64), 1201, 0),
    ("fp16_ragged", "float16", (1, 77, 3, 40), 130, 0),
)
ANY_PER_FORWARD = sum(n for *_, n in ANY_ATTN_CASES)  # 36
# fp32: within max(2x the plain fp32 version's error against fp64, this).
# bf16 and fp16 (the kernel computes in fp32, then rounds once): besides the
# plain version's bar, every element within one ulp of the type of the fp64
# reference rounded to the type, plus this for the fp32 sums' own error near
# zero
ANY_FP32_ERR_FLOOR = 1e-5
# the mma attention backward (csrc/flash_attention_bwd_any.cu), the rest
# of the TPU backward's domain: (case, dtype, q (B, Sq, H, D), Sk, calls a
# batch-2 train step of UFM-Base in fp32). The fp32 step's two shapes (the
# encoder sees both views: 2B), fp32 at D = 128 and 256, the shapes of a
# tiny_real224 step at batch 2 (D = 32 / 24), bf16 at D = 32 and 128, fp16 at
# D = 64, and a ragged case (Sq != Sk, D not a multiple of 8, a non-contiguous
# g); the cases with Sq == Sk take q, k, v as views of one fused qkv tensor
ANY_BWD_CASES = (
    ("fp32_encoder", "float32", (4, 1201, 16, 64), 1201, 24),
    ("fp32_info_sharing", "float32", (2, 2400, 12, 64), 2400, 12),
    ("fp32_d128", "float32", (2, 1201, 8, 128), 1201, 0),
    ("fp32_d256", "float32", (1, 1201, 4, 256), 1201, 0),
    ("fp32_tiny_encoder", "float32", (4, 193, 2, 32), 193, 0),
    ("fp32_tiny_info_sharing", "float32", (2, 384, 2, 24), 384, 0),
    ("bf16_d32", "bfloat16", (2, 1201, 32, 32), 1201, 0),
    ("bf16_d128", "bfloat16", (2, 1201, 8, 128), 1201, 0),
    ("fp16_d64", "float16", (2, 1201, 16, 64), 1201, 0),
    ("ragged", "float32", (1, 77, 3, 40), 130, 0),
)
ANY_BWD_PER_STEP = sum(n for *_, n in ANY_BWD_CASES)  # 36
# each of dq, dk, dv against fp64: within max(2x the plain version's error in
# the same dtype, this times the reference's largest element): fp32's own
# floor, two bf16 ulps (BWD_ERR_FLOOR_REL, the wgmma backward's), two fp16 ulps
ANY_BWD_FLOOR_REL = {"float32": 1e-5, "bfloat16": BWD_ERR_FLOOR_REL, "float16": 2.0**-10}
# the repository's two tiny fp32 anchors, from tests/golden/torch_port_fp32_anchor.npz
# (written by tests/test_torch_port_fp32.py), against their CPU goldens at the
# port's CPU bar, cuDNN TF32 off; the inputs are seeded_inputs()'s numpy draws
FP32_ANCHORS = ("ufm_base_tiny", "ufm_refine_tiny_pallas")
FP32_ANCHOR_ATOL = 1e-4
FP32_ANCHOR_SEED, FP32_ANCHOR_SHAPE = 20260817, (2, 42, 56, 3)
# UFM-Base at full width in fp32, 480x640 batch 1: flow against the same model
# on plain attention
FP32_FLOW_BAR_PX = 1e-3
# the same with cuDNN's and the matmuls' TF32 on (the port's default): the
# heads' TF32 rounding turns the attentions' last-bit differences into ~1e-3
# relative ones (5.8e-3 px measured on an H100); held with room
FP32_FLOW_BAR_TF32_ON_PX = 2e-2
# `ufm infer` on the bundled parallax pair with the trained tiny checkpoint,
# against the port's CPU run of the same checkpoint
TINY_REAL = os.path.join(HERE, "examples", "checkpoints", "tiny_real224")
ENTRY_FLOW_BAR_PX = 1e-3
# the same with TF32 on, the default `ufm infer` runs with (0.045 px measured
# on an H100: the CPU run has no TF32); held with room
ENTRY_FLOW_BAR_TF32_ON_PX = 0.1

# training: batch 2 at the model resolution (the JAX package's train
# benchmark shape, bench_train.py), one warm-up and 3 timed steps of
# make_train_step at the JAX package's defaults (peak learning rate 1e-4,
# 100 warm-up steps of 10000; the first step's rate is 0), then 2 steps of
# fit. fit's schedule spans its own 2 steps and so cannot warm up: it runs
# at 3e-6, the rate the warm-up has reached by then (1e-4 without warm-up
# makes the loss of the random model jump, measured on an H100)
TRAIN_BATCH, TRAIN_HW = 2, (420, 560)
TRAIN_STEPS, FIT_STEPS = 4, 2
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL_STEPS = 1e-4, 100, 10000
FIT_LR = 3e-6
# kernel vs plain-attention gradients at batch 1, relative L2 per optimizer
# group: the plain path rounds all 36 layers' logits to bf16 where the kernels
# keep them in fp32 (forward flow relative L2 1.5e-2 for the same reason);
# the gradients carry that rounding through the forward and the backward
TRAIN_GRAD_REL_L2_BOUND = 1e-1
# UFM-Base in fp32 (the mma forward and backward), batch 1, TF32 off:
# kernel vs plain-attention gradients, relative L2 per optimizer group (both
# fp32: only the sums' order differs)
FP32_TRAIN_GRAD_REL_L2_BOUND = 1e-3
# fine-tuning the trained tiny checkpoint: fit for this many steps on a
# seeded batch at the checkpoint's resolution, on the card and on the CPU
# port from the same weights (TF32 off); each step's loss within this of the
# CPU's, relative
FINE_TUNE_BATCH, FINE_TUNE_STEPS, FINE_TUNE_LR = 2, 3, 1e-5
FINE_TUNE_LOSS_REL = 1e-4
# the launch counters' names (ufm_torch.ops.launches.COUNTERS: each kernel's
# source): wgmma attention forward and backward, window, GELU, fused fc1 +
# GELU, mma attention forward and backward, window backward, GELU gradient,
# fc2's input gradient with the GELU gradient as its epilogue, the SwiGLU
# FFN's w12 with the gate as its epilogue
COUNTER_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "window_refinement_fwd", "gelu_bf16_fwd",
                   "linear_gelu_bf16_fwd", "flash_attention_fwd_any", "flash_attention_bwd_any",
                   "window_refinement_bwd", "gelu_bf16_bwd", "linear_gelu_bf16_bwd", "linear_swiglu_bf16_fwd")
(FWD_AT, BWD_AT, WINDOW_AT, GELU_AT, FUSED_AT, ANY_FWD_AT, ANY_BWD_AT, WINDOW_BWD_AT, GELU_BWD_AT,
 FUSED_BWD_AT, SWIGLU_AT) = COUNTER_KERNELS
ATTENTION_AT = (FWD_AT, BWD_AT, ANY_FWD_AT, ANY_BWD_AT)


def launch_counts(**n) -> dict:
    """Launches by kernel name, every counter's: ``n`` where given, else 0."""
    unknown = set(n) - set(COUNTER_KERNELS)
    if unknown:
        raise KeyError(f"no launch counter named {sorted(unknown)}")
    return {k: n.get(k, 0) for k in COUNTER_KERNELS}
# sharded training (ufm_torch.parallel) at world 1 over NCCL, on a
# (data, fsdp, model) = (1, 1, 1) mesh: the batch-2 step of make_sharded_train_step
# against make_train_step from the same weights and batch (3 steps each, at
# FIT_LR), then fit(mesh=...) stopping after 1 step (its checkpoint) and
# resuming for the 2nd. Step-0 metrics within SHARDED_METRIC_REL of the
# unsharded step's; each group's change of the fp32 values the optimizer
# steps (masters, fp32 parameters) within TRAIN_GRAD_REL_L2_BOUND
SHARDED_STEPS, SHARDED_METRIC_REL = 3, 1e-3
# data-parallel forward at batch 2 against the same network's forward: max
# abs difference over the output's largest value
DATA_PARALLEL_BATCH, DATA_PARALLEL_BAR = 2, 1e-5
# train_remat and each train_remat_policy (the JAX package's names): label,
# train_remat, policy, attention forward launches and standalone GELU
# launches a step (the forward runs again in the backward unless its outputs
# are kept: no policy keeps the GELU op's but everything_saveable,
# nn/layers.py::REMAT_POLICIES). Without remat the MLPs take the fused fc1 +
# GELU kernel (36 launches a step), no standalone GELU, and fc2's input
# gradient with the GELU gradient as its epilogue (36 a step); under remat
# fc1, the standalone GELU and the standalone GELU gradient (36 a step)
REMAT_CASES = (
    ("none", False, None, 36, 0),
    ("full", True, None, 72, 72),
    ("everything_saveable", True, "everything_saveable", 36, 36),
    ("nothing_saveable", True, "nothing_saveable", 72, 72),
    ("dots_saveable", True, "dots_saveable", 72, 72),
    ("checkpoint_dots", True, "checkpoint_dots", 72, 72),
    ("dots_with_no_batch_dims_saveable", True, "dots_with_no_batch_dims_saveable", 72, 72),
    ("checkpoint_dots_with_no_batch_dims", True, "checkpoint_dots_with_no_batch_dims", 72, 72),
    ("attn_out", True, "dots_with_no_batch_dims_and_attn_out_saveable", 36, 72),
)
REMAT_TIMED_STEPS = 3
# the moge_conv head on UFM-Base: the JAX package's MoGeConvFeature defaults
# (reads the 768-wide info-sharing output), flow output
MOGE_HEAD = {"input_dim": 768, "dims": (256, 128, 64), "output_dim": 2}
# main path with the kernel vs the same weights with the plain attention:
# bf16 rounding of 36 attention layers (the plain version rounds its logits to
# bf16, the kernel keeps them in fp32) feeds the fp32 heads
FLOW_REL_L2_BOUND = 2e-2

# window-refinement cases: (B, H, W, C), P, flow kind, its scale in px, calls
# per forward. "flagship" is the main path's shape at batch 1 (one call per
# forward) with iid flow of sigma 6 px; "edges" puts windows across every
# border plus one far outside each image on both sides; "flagship_smooth" and
# "flagship_split" give the flagship shape a smooth flow (MOTION, iid noise
# of sigma 0.5 px) and two such motions split by a diagonal. The rest of the
# domain (window_refinement_fwd_any_kernel): C = 5 (rows not 16-byte
# aligned, one load a channel) at P = 7 with "edges"' windows, C = 32 at P = 7
# and C = 64 at P = 9 (no staging: two boxes outgrow shared memory), C = 12
# at P = 9 on the smooth flow (staged boxes of 12 channels, about 3 tiles in
# 4 at this span). A case named "edges..." puts windows outside the image.
WINDOW_CASES = (
    ("flagship", (1, 420, 560, 16), 5, "iid", 6.0, 1),
    ("edges", (2, 24, 44, 8), 5, "iid", 40.0, 0),
    ("small_window", (2, 24, 44, 4), 3, "iid", 15.0, 0),
    ("flagship_smooth", (1, 420, 560, 16), 5, "smooth", 0.5, 0),
    ("flagship_split", (1, 420, 560, 16), 5, "split", 0.5, 0),
    ("edges_c5_p7", (2, 24, 44, 5), 7, "iid", 40.0, 0),
    ("c32_p7", (1, 64, 96, 32), 7, "iid", 6.0, 0),
    ("c64_p9", (1, 64, 96, 64), 9, "iid", 6.0, 0),
    ("smooth_c12_p9", (1, 420, 560, 12), 9, "smooth", 0.5, 0),
)
# the window backward (csrc/window_refinement_bwd.cu) against the plain
# backward in fp64: UFM-Refine's training shape (batch 2, one call a train
# step) on an iid and a smooth flow, "edges"' windows across and wholly
# outside the image, the rest of the domain as above, and the widened
# UFM-Refine's training shape (C = 12, P = 9) on the smooth flow. Same columns.
WINDOW_BWD_CASES = (
    ("train", (2, 420, 560, 16), 5, "iid", 6.0, 1),
    ("train_smooth", (2, 420, 560, 16), 5, "smooth", 0.5, 0),
    ("edges", (2, 24, 44, 8), 5, "iid", 40.0, 0),
    ("edges_c5_p7", (2, 24, 44, 5), 7, "iid", 40.0, 0),
    ("c32_p7", (1, 64, 96, 32), 7, "iid", 6.0, 0),
    ("c64_p9", (1, 64, 96, 64), 9, "iid", 6.0, 0),
    ("smooth_c12_p9", (2, 420, 560, 12), 9, "smooth", 0.5, 0),
)
# each gradient of the backward kernel within max(2x the plain fp32
# backward's own error, this share of the fp64 gradient's largest element)
# of the plain backward in fp64 (df sums up to (P+3)^2 contributions a
# pixel with fp32 atomics in a varying order)
WINDOW_BWD_FLOOR_REL = 1e-5
# the smooth motion, as of a wide-baseline pair after matching: an affine map
# about the image centre (scale, rotation in degrees, translation in px); the
# split flow moves the pixels below the diagonal y / H = x / W split_px
# further along y (an occlusion edge; a tile across it spans more rows than
# the kernel's staged box holds)
MOTION = {"scale": 1.05, "degrees": 3.0, "shift": (25.0, -12.0), "split_px": 40.0}
# the kernel's tiles that stage their taps in shared memory (TMA): nearly all
# of a smooth flow's, some but not all of a split flow's
SMOOTH_STAGED_SHARE_MIN = 0.95
# kernel vs plain version, both fp32 (the bars of tests/test_window_dots.py)
WINDOW_RESIDUAL_ATOL = 2e-5
WINDOW_LOG_SOFTMAX_ATOL = 2e-4
# refined flow with the window kernel vs the plain refinement, same weights
# and attention path: only the fp32 summation order differs
REFINED_FLOW_MAX_ABS = 1e-3
WINDOW_TEMPERATURE = 4.0
# one tile of the window kernel: the shape its host cost per launch is taken at
WINDOW_HOST_SHAPE = (1, 8, 32, 16)

# the kernel path of the d = 64 tiny models vs the JAX package's bf16
# forward: the cross-backend bar of tests/test_golden.py:110
BF16_GOLDENS = ("base", "refine")
BF16_GOLDEN_ATOL = 0.15
# tiled inference: a 1080x1920 pair is 5 x 4 tiles of 560x420 at overlap 0.33,
# answered by a coarse forward and forwards of 16 and 4 tiles
TILED_HW, TILED_BATCHES, TILED_TILES = (1080, 1920), [1, 16, 4], 20
# eval: three pairs with analytic flow, at the bundled pairs' size
EVAL_HW, EVAL_SEEDS = (540, 720), (0, 1, 2)
# the EPE budget the heads' TF32 convolutions are held to (SURVEY.md 6)
TF32_BUDGET_PX = 0.1
# captured vs eager pipeline on the same inputs: the graph replays the eager
# run's kernels, so only a kernel whose result depends on its launch could
# move a bit; flow relative L2 and covisibility max abs difference
CAPTURED_BAR = 1e-5
# captured: (label, batch) of UFM-Base at 480x640; UFM-Refine at batch 1
CAPTURED_BASE_BATCHES = (1, 2)
# serve: client threads x requests each, the lane width and batching window
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_MAX_DELAY_MS = 8, 8, 4, 3.0
SERVE_HW = (480, 640)
# captured: requests in the one profiled window of each mode (idle share)
PROFILE_REQUESTS = 5
# batch_rows / serve: flow relative L2 and covisibility max abs difference
# between one pair's answers at two slots of a lane-width batch. cuDNN's TF32
# convolutions in the fp32 heads give the last slot another reduction order:
# 1.39e-3 / 6.7e-4 at 480x640 with random weights (this script's batch_rows
# and serve on an H100); 5e-3 leaves room for other weights and inputs while
# a crossed or stale row (relative L2 ~1 between two pairs) fails it
SLOT_BAR = 5e-3
# stream: pairs through stream_predict in lane-width batches (the last padded)
STREAM_PAIRS = 14
# serve: a pair's flow in a lane-width batch against the pair alone at batch
# 1 (another program: other GEMM and convolution algorithms), end-point
# difference in px: the 0.1 px EPE drift budget of SURVEY.md 6, held on
# every pixel
BATCH_DRIFT_BUDGET_PX = 0.1
# artifact_batch4: the lane width `ufm serve --artifact` is asked for; the
# CLI pins it to the artifact's batch (SERVE_MAX_BATCH)
SERVE_ARTIFACT_ASKED_BATCH = 2
# export: an artifact's raw outputs against the live network on the same
# inputs (the same kernels and ops: bitwise expected), flow relative L2 and
# covisibility max abs difference; parameters stored in bf16 against the fp32
# artifact, max abs difference over the largest value of each output (the
# JAX package's bound, tests/test_export.py:159); a program traced on the CPU
# and moved to the card against the live card model, flow relative L2
ARTIFACT_BAR = 1e-5
ARTIFACT_BF16_DRIFT = 5e-2
ARTIFACT_CPU_BAR = 2e-2
# artifacts are written here (git-ignored) and removed at the end
ARTIFACT_DIR = os.path.join(HERE, "build", "chip_smoke_artifacts")
# loader: PNG pairs written by this script, decoded exactly; the committed
# JPEG cases (tests/test_torch_port_jpeg.py wrote them and their libjpeg and
# cv2 decodes) bitwise; the committed 1080x1920 JPEG pair timed and streamed
LOADER_PAIRS, LOADER_HW = 8, (480, 640)
LOADER_JPEG = os.path.join(HERE, "tests", "golden", "loader_smooth")
LOADER_JPEG_MEAN_ABS = 6  # tests/test_torch_port_loader.py's bar
JPEG_CASES = os.path.join(HERE, "tests", "golden", "jpeg_cases")
JPEG_PAIR = os.path.join(HERE, "tests", "golden", "jpeg_pair")
JPEG_PAIR_FILES = ("frame0.jpg", "frame1.jpg")
JPEG_STREAM_PAIRS = 32
JPEG_DECODE_REPS = 12  # one frame on one thread, the median of these
JPEG_THREADS = (1, 2, 4, 8)
JPEG_FRAMES_PER_COUNT = 48  # frames decoded at each thread count
# the pair transcoded to arithmetic coding (the DCT coefficients unchanged:
# its decodes are the Huffman pair's SHA-256s) and cut.json: frame 1 of each
# pair cut inside its AC scans, with libjpeg's block-smoothed SHA-256
# (tests/test_torch_port_jpeg_arith.py wrote them)
JPEG_PAIR_ARITH = os.path.join(HERE, "tests", "golden", "jpeg_pair_arith")
# a lossless (SOF3) file, 240x320, predictor 5, a restart every two MCU rows,
# and its samples (tests/test_torch_port_jpeg_lossless.py writes both)
JPEG_LOSSLESS = os.path.join(HERE, "tests", "golden", "jpeg_lossless")
JPEG_CUT_REPS = 5  # a cut frame's decode ms: the median of these


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


# each path's launches of the standalone GELU kernel, of the fused fc1 + GELU
# kernel, of the GELU gradient kernel and of the fused fc2 input-gradient +
# GELU gradient kernel, by the name of its launches_by_path entry
GELU_LAUNCHES, FUSED_LAUNCHES, GELU_BWD_LAUNCHES, FUSED_BWD_LAUNCHES = {}, {}, {}, {}


def mlp_counts(ge, lg) -> dict:
    """The four MLP kernels' counters (``ufm_torch.ops.gelu`` and
    ``ufm_torch.ops.linear_gelu`` modules), by kernel name."""
    return {GELU_AT: ge.LAUNCHES, FUSED_AT: lg.LAUNCHES, GELU_BWD_AT: ge.BWD_LAUNCHES, FUSED_BWD_AT: lg.BWD_LAUNCHES}


def mlp_path(path: str, launched: dict, fused: int, two_op: int = 0, backward: int = 0,
             fused_backward: int = 0) -> None:
    """Record a path's launches of the four MLP kernels (``launched``: by
    kernel name) and hold them to what the code gives for its bf16 MLPs:
    ``fused`` forwards through the fused fc1 + GELU kernel (every MLP outside
    activation checkpointing, with a gradient recorded or not: GELU_PER_FORWARD
    a forward of the backbone), ``two_op`` forwards of fc1 then the standalone
    GELU (under checkpointing, the backward's recomputes included),
    ``backward`` launches of the standalone GELU gradient (an MLP backward
    under checkpointing) and ``fused_backward`` launches of the fused fc2
    input-gradient + GELU gradient kernel (an MLP backward outside it)."""
    for store, name in ((GELU_LAUNCHES, GELU_AT), (FUSED_LAUNCHES, FUSED_AT), (GELU_BWD_LAUNCHES, GELU_BWD_AT),
                        (FUSED_BWD_LAUNCHES, FUSED_BWD_AT)):
        store[path] = store.get(path, 0) + launched[name]
    got = (launched[GELU_AT], launched[FUSED_AT], launched[GELU_BWD_AT], launched[FUSED_BWD_AT])
    want = (two_op, fused, backward, fused_backward)
    check(got == want, f"{path}: {got} GELU / fused fc1 + GELU / GELU gradient / fused fc2 + GELU gradient "
          f"launches, expected {want}")


# the launches of the paths recorded by record_path, {path: {kernel: n}}
# (the three MLP kernels: mlp_path)
PATH_LAUNCHES = {}
MLP_KERNELS = (GELU_AT, FUSED_AT, GELU_BWD_AT, FUSED_BWD_AT)


def record_path(path: str, launched: dict, fused: int, two_op: int = 0, backward: int = 0,
                fused_backward: int = 0) -> None:
    """Record a path's launches (a ``ufm_torch.ops.launches`` snapshot, by
    kernel name) for the kernels' summary: each attention and window kernel
    it ran, and the four MLP kernels through ``mlp_path``, held there to
    ``fused`` / ``two_op`` MLP forwards and ``backward`` / ``fused_backward``
    MLP backwards (a path with no bf16 MLP launches none of them)."""
    paths = PATH_LAUNCHES.setdefault(path, {})
    for name in COUNTER_KERNELS:
        if launched[name] and name not in MLP_KERNELS:
            paths[name] = paths.get(name, 0) + launched[name]
    mlp_path(path, launched, fused, two_op, backward, fused_backward)


def record_steps(path: str, launched: dict, each: dict, steps: int) -> None:
    """record_path for ``steps`` train steps of ``each`` launches a step."""
    record_path(path, launched, steps * each[FUSED_AT], steps * each[GELU_AT], steps * each[GELU_BWD_AT],
                steps * each[FUSED_BWD_AT])


def with_recorded_paths(kernel: dict) -> dict:
    """``kernel`` (one entry of the summary) with the recorded paths that
    ran it added to its ``launches_by_path`` and ``launches``."""
    for path, counts in PATH_LAUNCHES.items():
        if kernel["name"] in counts:
            kernel["launches_by_path"][path] = counts[kernel["name"]]
            kernel["launches"] += counts[kernel["name"]]
    return kernel


def time_ms(fn, reps: int = 10, batches: int = 7) -> float:
    """Median over ``batches`` of CUDA-event time per call, ``reps`` calls a
    batch, after a warm-up. Each batch queues behind a device sleep, so the
    events time the card even where a call's launch costs the host more than
    the card's run of it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this check needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit(
        "device",
        nvidia_smi=smi,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    return smi


def sass_counts(path) -> dict:
    """HGMMA (wgmma), HMMA (mma.sync) and UTMALDG (TMA load) instructions in
    a library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA", "UTMALDG")}


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel in nvcc's
    ``-Xptxas -v`` output, by kernel name (template arguments kept, as
    mangled)."""
    out = {}
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, (\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S):
        short = re.search(r"[a-z][a-z_]*_kernel(?:I(?:L[ib]\d+E|f|13__nv_bfloat16|6__half)+E)?", m.group(1))
        out[short.group(0) if short else m.group(1)] = {
            "registers": int(m.group(5)), "stack_frame": int(m.group(2)), "spill_stores": int(m.group(3)),
            "spill_loads": int(m.group(4))}
    return out


def phase_build():
    import ufm_torch
    from ufm_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(ufm_torch.__file__))
    check(os.path.dirname(pkg) == HERE, f"ufm_torch imported from {pkg}, not from this checkout")
    t0 = time.perf_counter()
    paths = _build.build(force=True)  # from this checkout's sources, with nvcc's report
    seconds = time.perf_counter() - t0
    ptxas = {n: ptxas_report(log) for n, log in _build.BUILD_LOGS.items()}
    sass = {n: sass_counts(p) for n, p in zip(_build.KERNEL_SOURCES, paths)}
    # ptxas's warning when it cannot keep wgmma instructions in flight together
    # ("... wgmma.mma_async instructions are serialized due to ...")
    serialized = {n: [ln.strip() for ln in log.splitlines() if "wgmma" in ln and "serialized" in ln]
                  for n, log in _build.BUILD_LOGS.items()}
    serialized = {n: lines for n, lines in serialized.items() if lines}
    emit("build", seconds=seconds, kernels=list(_build.KERNEL_SOURCES), ptxas=ptxas, sass=sass,
         wgmma_serialized=serialized)
    for name in ATTENTION_LIBRARIES + ("linear_gelu_bf16_fwd", "linear_gelu_bf16_bwd", "linear_swiglu_bf16_fwd"):
        check(sass[name]["HGMMA"] > 0, f"{name}: no HGMMA (wgmma) instruction in its SASS")
    check(not serialized, f"ptxas serialized the wgmma instructions of {sorted(serialized)}")
    for name in ("window_refinement_fwd", "window_refinement_bwd", "linear_gelu_bf16_fwd", "linear_gelu_bf16_bwd",
                 "linear_swiglu_bf16_fwd"):
        check(sass[name]["UTMALDG"] > 0, f"{name}: no UTMALDG (TMA load) in its SASS")
    for name in ("window_refinement_fwd", "window_refinement_bwd", "gelu_bf16_fwd", "linear_gelu_bf16_fwd",
                 "gelu_bf16_bwd", "linear_swiglu_bf16_fwd"):
        local = {k: v for k, v in ptxas[name].items() if v["stack_frame"] or v["spill_stores"] or v["spill_loads"]}
        check(bool(ptxas[name]) and not local, f"{name} uses local memory: {local}")
    # the fused MLP backward spills a few dozen bytes a thread (values live
    # across its products): reported, not refused
    emit("build_fused_mlp_backward", library="linear_gelu_bf16_bwd", ptxas=ptxas["linear_gelu_bf16_bwd"])
    # the mma attention pair: tensor-core products, and no local memory in the
    # head dims the repository's models run (DP = 32 / 64; the others reported)
    for name in ANY_LIBRARIES:
        check(sass[name]["HMMA"] + sass[name]["HGMMA"] > 0, f"{name}: no tensor-core instruction (HMMA, HGMMA)")
        local = {k: v for k, v in ptxas[name].items() if v["stack_frame"] or v["spill_stores"] or v["spill_loads"]}
        check(bool(ptxas[name]) and not any(re.search(r"Li(32|64)E", k) for k in local),
              f"{name} uses local memory at DP = 32 / 64: {local}")
        emit("build_mma", library=name, local_memory=local,
             registers={k: v["registers"] for k, v in ptxas[name].items()})
    t0 = time.perf_counter()
    host = _build._host_library_path("ufm_runtime")
    if host.exists():
        host.unlink()  # from this checkout's source
    _build.load_host_library("ufm_runtime")
    emit("build_host", library=host.name, seconds=time.perf_counter() - t0)


def attention_bound_ms(b, s, h, d):
    flops = 4 * b * h * s * s * d
    nbytes = 4 * b * s * h * d * 2  # q, k, v read once, out written once, bf16
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernel():
    import torch.nn.functional as F

    from ufm_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, (b, s, h, d), calls in ATTN_SHAPES + TILED_ATTN_SHAPES:
        if name != "ragged":  # the main path's layout: strided views of the fused qkv projection
            qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        scale = d**-0.5
        out = fa.flash_attention(q, k, v, scale=scale)
        plain = fa.attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        ref = fa.attention_reference(q.float(), k.float(), v.float(), scale)
        err = (out.float() - ref).abs().max().item()
        plain_err = (plain.float() - ref).abs().max().item()
        tol = max(2 * plain_err, KERNEL_ERR_FLOOR)
        check(bool(torch.isfinite(out).all()), f"{name}: kernel output not finite")
        check(err <= tol, f"{name}: kernel error {err:.3e} > {tol:.3e}")

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
        plain_ms = time_ms(lambda: fa.attention_reference(q, k, v, scale), reps=3, batches=5)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        bound_ms, bound_by = attention_bound_ms(b, s, h, d)
        rows[name] = dict(
            shape=[b, s, h, d], calls_per_forward=calls, max_abs_err=err, plain_max_abs_err=plain_err, tol=tol,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, tflops=4 * b * h * s * s * d / ms / 1e9,
        )
        emit("kernel", kernel="flash_attention_fwd", case=name, **rows[name])
    return rows


def _any_peak(dtype, fma: bool) -> float:
    """The rate an operation on ``dtype`` inputs is bound by: fp32-accurate
    products on the tensor cores (3xTF32, 165 TFLOP/s of fp32 work) for fp32,
    the card's 989 TFLOP/s for bf16 and fp16; with ``fma``, fp32 FMA's 67
    TFLOP/s outside the tensor cores for every dtype (the rate PRs 12-13's
    fp32 shares were stated against)."""
    if fma:
        return PEAK_FP32_FLOPS
    return PEAK_FP32_3XTF32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def any_attention_bound_ms(b, sq, sk, h, d, dtype, fma: bool = False):
    """The bound of a forward on ``dtype`` inputs: its 4 B H Sq Sk D
    operations at :func:`_any_peak`'s rate against q, k, v read once and the
    output written once."""
    flops = 4 * b * h * sq * sk * d
    nbytes = 2 * b * h * d * (sq + sk) * dtype.itemsize
    t_ops, t_bytes = flops / _any_peak(dtype, fma) * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# significant bits and the smallest normal exponent (frexp's) of the 16-bit types
_HALF_TYPES = {torch.bfloat16: (8, -125), torch.float16: (11, -13)}


def type_ulp(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype``'s numbers (bf16 or fp16) at each of ``x``'s
    values, which are of that type (subnormals spaced as the smallest
    normals; 0 at 0)."""
    bits, min_e = _HALF_TYPES[dtype]
    _, e = torch.frexp(x)
    return torch.where(x == 0, torch.zeros_like(x), torch.ldexp(torch.ones_like(x), e.clamp(min=min_e) - bits))


def any_inputs(gen, dtype, b, sq, sk, h, d):
    """q (B, Sq, H, D), k and v (B, Sk, H, D) in ``dtype``: views of one fused
    (B, S, 3, H, D) qkv tensor where Sq == Sk (the models' layout), else
    three tensors."""
    if sq == sk:
        return torch.randn(b, sq, 3, h, d, generator=gen, device="cuda").to(dtype).unbind(2)
    return tuple(torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype) for s in (sq, sk, sk))


def d_strided(t: torch.Tensor) -> torch.Tensor:
    """The values of ``t`` as a view with D stride 2: no 16-byte cp.async
    takes its rows, so the mma kernels stage it element by element (fp32 by
    4-byte cp.async, bf16 / fp16 by plain loads)."""
    wide = torch.zeros(*t.shape[:-1], 2 * t.shape[-1], dtype=t.dtype, device=t.device)
    wide[..., ::2] = t
    return wide[..., ::2]


def phase_any_kernel():
    """The mma attention forward against its plain version (matmul TF32
    off) at each of ANY_ATTN_CASES, against an fp64 reference: fp32 within
    max(2x the plain fp32 error, 1e-5); bf16 and fp16 within max(2x the plain
    version's error, 4e-3) and every element within one ulp of the type of
    the reference rounded to the type (+1e-5); the row log-sum-exp against
    fp64; one launch of it and none of the wgmma kernel per call; at the
    small cases, D-strided inputs (staged element by element, not by 16-byte
    cp.async) give the same bits; timed beside its plain version and SDPA on
    the same tensors, its share of both bounds (3xTF32 / tensor cores, and
    fp32 FMA) beside."""
    import torch.nn.functional as F

    from ufm_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, dtype, (b, sq, h, d), sk, calls in ANY_ATTN_CASES:
        dt = getattr(torch, dtype)
        q, k, v = any_inputs(gen, dt, b, sq, sk, h, d)
        scale = d**-0.5
        before = (fa.LAUNCHES, fa.ANY_LAUNCHES)
        out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
        torch.cuda.synchronize()
        launched = (fa.LAUNCHES - before[0], fa.ANY_LAUNCHES - before[1])
        wide = torch.float64
        ref, ref_lse = fa.attention_reference(q.to(wide), k.to(wide), v.to(wide), scale, with_lse=True)
        plain = fa.attention_reference(q, k, v, scale)
        err = (out.to(wide) - ref).abs().max().item()
        plain_err = (plain.to(wide) - ref).abs().max().item()
        lse_err = (lse.to(wide) - ref_lse).abs().max().item()
        tol = max(2 * plain_err, ANY_FP32_ERR_FLOOR if dt == torch.float32 else KERNEL_ERR_FLOOR)
        ulp_excess = None
        if dt != torch.float32:
            ref_t = ref.to(dt).to(wide)
            ulp_excess = ((out.to(wide) - ref_t).abs() - type_ulp(ref_t, dt)).max().item()
            check(ulp_excess <= ANY_FP32_ERR_FLOOR,
                  f"{name}: an element is {ulp_excess:.3e} past one {dtype} ulp of the fp64 reference")
            del ref_t
        del ref, ref_lse, plain
        check(launched == (0, 1), f"{name}: {launched} wgmma / mma launches for one call, expected (0, 1)")
        check(out.dtype == dt and bool(torch.isfinite(out).all()), f"{name}: kernel output {out.dtype}, not finite")
        check(err <= tol, f"{name}: mma kernel error {err:.3e} > {tol:.3e}")
        check(lse_err <= LSE_ATOL, f"{name}: row log-sum-exp error {lse_err:.3e} > {LSE_ATOL}")
        staging_equal = None
        if not calls and b * h * sq * sk <= 1 << 16:  # the small cases: the element-wise staging paths too
            out_s, lse_s = fa.flash_attention_forward(*(d_strided(x) for x in (q, k, v)), scale, with_lse=True)
            staging_equal = torch.equal(out, out_s) and torch.equal(lse, lse_s)
            check(staging_equal, f"{name}: D-strided inputs (element-wise staging) change the output")

        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, scale=scale))
        plain_ms = time_ms(lambda: fa.attention_reference(q, k, v, scale), reps=3, batches=5)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        bound_ms, bound_by = any_attention_bound_ms(b, sq, sk, h, d, dt)
        fma_bound_ms, _ = any_attention_bound_ms(b, sq, sk, h, d, dt, fma=True)
        rows[name] = dict(
            dtype=dtype, shape=[b, sq, h, d], sk=sk, calls_per_fp32_forward=calls, max_abs_err=err,
            plain_max_abs_err=plain_err, tol=tol, ulp_excess_max=ulp_excess, lse_max_abs_err=lse_err,
            staging_paths_bitwise_equal=staging_equal, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
            fma_bound_ms=fma_bound_ms, share_of_fma_bound=fma_bound_ms / ms,
            tflops=4 * b * h * sq * sk * d / ms / 1e9,
        )
        emit("kernel", kernel="flash_attention_fwd_any", case=name, **rows[name])
        del q, k, v, out, lse
    return rows


def attention_bwd_bound_ms(b, s, h, d):
    """The backward's own cost: 10 B H S^2 D operations (five S x S x D
    products, the TPU kernel's CostEstimate); q, k, v, o, g read once, dq,
    dk, dv written once (bf16), lse read and delta written once (fp32)."""
    flops = 10 * b * h * s * s * d
    nbytes = 8 * b * s * h * d * 2 + 2 * b * h * s * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_bwd_kernel():
    from ufm_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for name, (b, s, h, d), calls in ATTN_BWD_SHAPES:
        if calls:  # the main path's layout: strided views of the fused qkv projection
            qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        g = torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        scale = d**-0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
        grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
        plain = fa.attention_backward_reference(q, k, v, g, scale)
        torch.cuda.synchronize()
        ref = fa.attention_backward_reference(q.float(), k.float(), v.float(), g.float(), scale)
        errs = {}
        for gname, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
            err = (got.float() - want).abs().max().item()
            plain_err = (pl.float() - want).abs().max().item()
            tol = max(2 * plain_err, BWD_ERR_FLOOR_REL * want.abs().max().item())
            check(_finite(got), f"backward {name}: {gname} not finite")
            check(err <= tol, f"backward {name}: {gname} error {err:.3e} > {tol:.3e}")
            errs[gname] = dict(max_abs_err=err, plain_max_abs_err=plain_err, tol=tol)
        del ref, plain
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        lse_err = (lse - torch.logsumexp(scores, dim=-1)).abs().max().item()
        del scores
        check(lse_err <= LSE_ATOL, f"backward {name}: lse error {lse_err:.3e} > {LSE_ATOL}")
        again = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
        repeatable = all(torch.equal(a, b) for a, b in zip(grads, again))
        check(repeatable, f"backward {name}: two calls on the same inputs differ")
        del again

        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, g, scale))
        plain_ms = time_ms(lambda: fa.attention_backward_reference(q, k, v, g, scale), reps=3, batches=5)
        fwd_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, scale))
        fwd_lse_ms = time_ms(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True))
        library_ms = sdpa_backward_ms(q, k, v, g, scale)
        bound_ms, bound_by = attention_bwd_bound_ms(b, s, h, d)
        rows[name] = dict(
            shape=[b, s, h, d], calls_per_step=calls, **{f"{k}_{f}": v for k, e in errs.items() for f, v in e.items()},
            lse_max_abs_err=lse_err, max_abs_err=max(e["max_abs_err"] for e in errs.values()),
            bitwise_repeatable=repeatable,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, tflops=10 * b * h * s * s * d / ms / 1e9,
            fwd_ms=fwd_ms, fwd_with_lse_ms=fwd_lse_ms,
        )
        if not calls:  # a shape whose kernels are shorter than their launch: the host's cost
            rows[name]["host_us_per_launch"] = {
                "fwd": host_us_per_launch(lambda: fa.flash_attention_forward(q, k, v, scale)),
                "fwd_with_lse": host_us_per_launch(lambda: fa.flash_attention_forward(q, k, v, scale, with_lse=True)),
                "bwd": host_us_per_launch(lambda: fa.flash_attention_backward(q, k, v, out, lse, g, scale)),
            }
        emit("kernel", kernel="flash_attention_bwd", case=name, **rows[name])
    return rows


def any_attention_bwd_bound_ms(b, sq, sk, h, d, dtype, fma: bool = False):
    """The backward's own cost on ``dtype`` inputs: 10 B H Sq Sk D operations
    (five products, the TPU kernel's CostEstimate) at :func:`_any_peak`'s
    rate against q, o, g, k, v read once and dq, dk, dv written once, plus
    lse read and delta written once (fp32)."""
    flops = 10 * b * h * sq * sk * d
    nbytes = 4 * b * h * d * (sq + sk) * dtype.itemsize + 2 * b * h * sq * 4
    t_ops, t_bytes = flops / _any_peak(dtype, fma) * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_backward_ms(q, k, v, g, scale):
    """The time of the backward of scaled_dot_product_attention on the same
    (B, H, S, D) views (torch.autograd.grad)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    gt = g.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))


def phase_any_bwd_kernel():
    """The mma attention backward through ``flash_attention_backward``
    (after the mma forward with lse) at each of ANY_BWD_CASES, matmul
    TF32 off: dq, dk and dv against an fp64 reference, each within max(2x
    the plain version's error in the same dtype, ANY_BWD_FLOOR_REL of the
    reference's largest element); two calls bitwise equal; one launch of it
    and none of the wgmma backward per call; at the small cases, D-strided
    q, k, v, g (staged element by element) give the same bits; timed beside
    its plain version and SDPA's backward on the same tensors, its share of
    both bounds beside."""
    from ufm_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {}
    for name, dtype, (b, sq, h, d), sk, calls in ANY_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v = any_inputs(gen, dt, b, sq, sk, h, d)
        if sq == sk:
            g = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt)
        else:  # a non-contiguous output gradient
            g = torch.randn(b, sq, h, d + 8, generator=gen, device="cuda").to(dt)[..., 8:]
        scale = d**-0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale, with_lse=True)
        before = (fa.BWD_LAUNCHES, fa.ANY_BWD_LAUNCHES)
        grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
        again = fa.flash_attention_backward(q, k, v, out, lse, g, scale)
        torch.cuda.synchronize()
        launched = (fa.BWD_LAUNCHES - before[0], fa.ANY_BWD_LAUNCHES - before[1])
        check(launched == (0, 2), f"backward {name}: {launched} wgmma / mma backward calls for two, expected (0, 2)")
        repeatable = all(torch.equal(a, c) for a, c in zip(grads, again))
        check(repeatable, f"backward {name}: two calls on the same inputs differ")
        staging_equal = None
        if not calls and b * h * sq * sk <= 1 << 20:  # the small cases: the element-wise staging paths too
            strided = fa.flash_attention_backward(*(d_strided(x) for x in (q, k, v)), out, lse, d_strided(g), scale)
            staging_equal = all(torch.equal(a, c) for a, c in zip(grads, strided))
            check(staging_equal, f"backward {name}: D-strided inputs (element-wise staging) change the gradients")
            del strided
        del again
        wide = torch.float64
        ref = fa.attention_backward_reference(q.to(wide), k.to(wide), v.to(wide), g.to(wide), scale)
        plain = fa.attention_backward_reference(q, k, v, g, scale)
        errs = {}
        for gname, got, want, pl in zip(("dq", "dk", "dv"), grads, ref, plain):
            err = (got.to(wide) - want).abs().max().item()
            plain_err = (pl.to(wide) - want).abs().max().item()
            tol = max(2 * plain_err, ANY_BWD_FLOOR_REL[dtype] * want.abs().max().item())
            check(got.dtype == dt and _finite(got), f"backward {name}: {gname} {got.dtype}, not finite")
            check(err <= tol, f"backward {name}: {gname} error {err:.3e} > {tol:.3e}")
            errs[gname] = dict(max_abs_err=err, plain_max_abs_err=plain_err, tol=tol)
        del ref, plain

        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, g, scale))
        plain_ms = time_ms(lambda: fa.attention_backward_reference(q, k, v, g, scale), reps=3, batches=5)
        library_ms = sdpa_backward_ms(q, k, v, g, scale)
        bound_ms, bound_by = any_attention_bwd_bound_ms(b, sq, sk, h, d, dt)
        fma_bound_ms, _ = any_attention_bwd_bound_ms(b, sq, sk, h, d, dt, fma=True)
        rows[name] = dict(
            dtype=dtype, shape=[b, sq, h, d], sk=sk, calls_per_fp32_step=calls,
            **{f"{k}_{f}": v for k, e in errs.items() for f, v in e.items()},
            max_abs_err=max(e["max_abs_err"] for e in errs.values()), bitwise_repeatable=repeatable,
            staging_paths_bitwise_equal=staging_equal,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms, fma_bound_ms=fma_bound_ms, share_of_fma_bound=fma_bound_ms / ms,
            tflops=10 * b * h * sq * sk * d / ms / 1e9,
        )
        emit("kernel", kernel="flash_attention_bwd_any", case=name, **rows[name])
        del q, k, v, g, out, lse, grads
    return rows


def host_us_per_launch(fn, reps: int = LAUNCH_HOST_REPS) -> float:
    """Host wall time per call of ``reps`` back-to-back calls without a sync
    (the device drains afterwards, outside the clock)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def gelu_bound_ms(numel: int):
    """Bytes: x read once, y written once (bf16). Operations:
    GELU_OPS_PER_ELEMENT fp32 operations an element."""
    t_ops = GELU_OPS_PER_ELEMENT * numel / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * numel / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _gelu_chain(x: torch.Tensor) -> torch.Tensor:
    """The port's bf16 GELU before the kernel: jax.nn.gelu's chain as four
    PyTorch ops (mul, mul, erfc, mul), each rounding to bf16; timed here as
    what the kernel replaced."""
    return (x * 0.5) * torch.special.erfc(x * -0.70703125)


def phase_gelu():
    """The bf16 GELU kernel (``ufm_torch::gelu_bf16``) against the JAX
    package's output (the committed table) on all 65,536 bf16 bit patterns,
    bit for bit on the 65,280 finite ones, and against its plain version on
    the card and on the CPU; odd element counts, an empty, a misaligned and a
    non-contiguous input against the plain version; fp32 refused. Then the
    kernel, ``F.gelu`` (the library call), the plain version and the 4-op
    chain it replaced timed at the MLP shapes of one batch-1 forward, and
    the host's cost per launch. Returns (rows by shape, host us per launch,
    max abs error against the table)."""
    import torch.nn.functional as F

    from ufm_torch.ops import gelu

    with np.load(GELU_TABLE) as z:
        want_bits, finite = torch.from_numpy(z["y_bits"].view(np.int16).copy()), torch.from_numpy(z["finite"])
    x = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)  # x[i] has bits i
    check(torch.equal(finite, torch.isfinite(x)) and int(finite.sum()) == 65280, "the GELU table's finite mask")
    card = gelu.gelu_bf16(x.cuda()).cpu()
    plain_card = gelu.fast_exact_gelu_reference(x.cuda()).cpu()
    plain_cpu = gelu.gelu_bf16(x)  # the op's CPU implementation
    mismatches = {
        "kernel_vs_table": int((_bits(card) != want_bits)[finite].sum()),
        "kernel_vs_plain_on_card": int((_bits(card) != _bits(plain_card))[finite].sum()),
        "kernel_vs_plain_on_cpu": int((_bits(card) != _bits(plain_cpu))[finite].sum()),
        "plain_on_cpu_vs_table": int((_bits(plain_cpu) != want_bits)[finite].sum()),
    }
    want = want_bits.view(torch.bfloat16)
    max_abs_err = (card.float() - want.float())[finite].abs().max().item()
    nonfinite_nan_agree = bool(torch.equal(torch.isnan(card)[~finite], torch.isnan(want)[~finite]))

    gen = torch.Generator(device="cuda").manual_seed(6)
    odd = {}
    base = (torch.randn(8 * 1001 + 16, generator=gen, device="cuda") * 4).to(torch.bfloat16)
    cases = {f"n{n}": base[:n] for n in GELU_ODD_COUNTS}
    cases["misaligned"] = base[3:8 * 1001 + 3]  # base address 6 bytes past a 16-byte boundary
    cases["non_contiguous"] = base[:40 * 200].view(40, 200).t()
    for name, t in cases.items():
        before = gelu.LAUNCHES
        got = gelu.gelu_bf16(t)
        launched = gelu.LAUNCHES - before
        plain = gelu.fast_exact_gelu_reference(t.contiguous())
        ok = got.shape == t.shape and torch.equal(_bits(got.contiguous()), _bits(plain))
        odd[name] = dict(numel=t.numel(), bitwise_plain=ok, launches=launched)
        check(ok, f"gelu {name}: the kernel differs from the plain version")
        check(launched == int(t.numel() > 0), f"gelu {name}: {launched} launches")
    try:
        gelu.gelu_bf16(base.float())
        refused = False
    except ValueError:
        refused = True

    rows = {}
    for name, shape, per_forward in GELU_SHAPES:
        h = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        check(torch.equal(_bits(gelu.gelu_bf16(h)), _bits(gelu.fast_exact_gelu_reference(h))),
              f"gelu {name}: the kernel differs from the plain version")
        ms = time_ms(lambda: gelu.gelu_bf16(h))
        library_ms = time_ms(lambda: F.gelu(h, approximate="none"))
        plain_ms = time_ms(lambda: gelu.fast_exact_gelu_reference(h), reps=3, batches=5)
        chain_ms = time_ms(lambda: _gelu_chain(h))
        bound_ms, bound_by = gelu_bound_ms(h.numel())
        rows[name] = dict(shape=list(shape), mlps_per_forward=per_forward, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, chain_ms=chain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          share_of_bound=bound_ms / ms, gbytes_per_s=4 * h.numel() / ms / 1e6)
        emit("kernel", kernel="gelu_bf16_fwd", case=name, **rows[name])
        del h
    small = torch.randn(1, 64, generator=gen, device="cuda").to(torch.bfloat16)
    host = {"kernel": host_us_per_launch(lambda: gelu.gelu_bf16(small)),
            "f_gelu": host_us_per_launch(lambda: F.gelu(small, approximate="none")),
            "chain": host_us_per_launch(lambda: _gelu_chain(small))}
    per_forward = {k: sum(r["mlps_per_forward"] * r[k] for r in rows.values())
                   for k in ("ms", "plain_ms", "library_ms", "chain_ms", "bound_ms")}
    emit("gelu", inputs=int(finite.sum()), mismatches=mismatches, max_abs_err=max_abs_err,
         nonfinite_nan_agree=nonfinite_nan_agree, odd=odd, fp32_refused=refused, per_forward_ms=per_forward,
         launches_per_mlp={"kernel": 1, "f_gelu": 1, "chain": 4}, host_us_per_call=host)
    for k, n in mismatches.items():
        check(n == 0, f"gelu: {n} finite bf16 inputs differ ({k})")
    check(refused, "gelu: the kernel took an fp32 tensor")
    return rows, host["kernel"], max_abs_err


def linear_gelu_bound_ms(m: int, k: int, n: int):
    """Operations: 2 M N K on the tensor cores. Bytes: x, W and b read once,
    y written once (bf16)."""
    t_ops = 2 * m * n * k / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (m * k + n * k + n + m * n) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _ordered_bf16(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of the values (one apart for one ulp)."""
    u = t.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(u < 0x8000, u + 0x8000, 0xFFFF - u)


def _preact_check(pre, x, w, b) -> dict:
    """The kernel's h against the exact product + bias (float64): the share
    of elements more than one bf16 ulp from it rounded to bf16, the most
    ulps, the most where fp32 summation cannot move the sum by half an ulp,
    and whether every element lies within one ulp plus fp32 summation's
    error bound (K 2^-24 sum |x w| + 2^-24 |b|: a sum that cancels to near
    zero has few correct bits in any fp32 order)."""
    xd, wd, bd = x.double(), w.double(), b.double()
    ref = xd @ wd.t() + bd
    gamma = x.shape[-1] * 2.0**-24 * (xd.abs() @ wd.abs().t() + bd.abs())
    ulp = torch.ldexp(torch.ones_like(ref), (torch.frexp(ref).exponent - 8).clamp_min(-133))
    ulps = (_ordered_bf16(pre) - _ordered_bf16(ref.to(torch.bfloat16))).abs()
    bounded = gamma <= 0.5 * ulp
    return dict(share_over_1ulp=(ulps > 1).double().mean().item(), max_ulps=int(ulps.max()),
                max_ulps_where_summation_bounded=int(ulps[bounded].max()) if bool(bounded.any()) else 0,
                within_ulp_plus_summation_bound=bool(((pre.double() - ref).abs() <= ulp + gamma).all()))


def phase_linear_gelu():
    """The fused fc1 + GELU kernel (``ufm_torch::linear_gelu_bf16``) at the
    MLP shapes of a batch-1 forward and of a tiled forward, at rows off the
    128-row tile and at K / N tails: y is the bf16 GELU of its own h bit for
    bit (h read back through ``preact_out``), h against the exact product +
    bias, y against the plain version (F.linear, then the GELU's plain
    chain). Every finite bf16 value as h (W = 0, the bias holds the values)
    against the JAX package's table. An empty x launches nothing; fp32, a
    wrong shape and a misaligned operand are refused. Then the kernel under
    each schedule, ``F.linear`` alone, the parent's pair (``F.linear`` + the
    GELU op), the library pair (``F.linear`` + ``F.gelu``) and the plain
    version timed at each MLP shape, the bound, and the host's cost per
    call. Returns (rows by case, host us per call, max abs error against the
    plain version)."""
    import torch.nn.functional as F

    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg

    gen = torch.Generator(device="cuda").manual_seed(11)

    def operands(m, k, n):
        """h's spread as in the flagship: a LayerNorm output times W of std
        1 / sqrt(K) (the seeded init) gives h ~ N(0, 1); the bias adds 1%.
        (The GELU kernel of the parent's pair slows down as more of h lies
        on the erfc's tail, where it leaves its fast path.)"""
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)
        b = (torch.randn(n, generator=gen, device="cuda") * LINEAR_GELU_BIAS_STD).to(torch.bfloat16)
        return x, w, b

    rows = {}
    cases = [(name, shape, calls, True) for name, shape, calls in LINEAR_GELU_SHAPES + LINEAR_GELU_TILED_SHAPES]
    cases += [(f"m{m}_k{k}_n{n}", (m, k, n), 0, False) for m, k, n in LINEAR_GELU_ODD]
    for name, (m, k, n), calls, timed in cases:
        x, w, b = operands(m, k, n)
        pre = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        before = lg.LAUNCHES
        y = lg.launch(x, w, b, preact_out=pre)
        plain = lg.linear_gelu_reference(x, w, b)
        torch.cuda.synchronize()
        diff = y.float() - plain.float()
        row = dict(shape=[m, k, n], calls_per_forward=calls, launches=lg.LAUNCHES - before,
                   gelu_of_h_mismatches=int((_bits(y) != _bits(ge.fast_exact_gelu_reference(pre))).sum()),
                   **_preact_check(pre, x, w, b), max_abs_diff_vs_plain=diff.abs().max().item(),
                   rel_l2_vs_plain=(diff.norm() / plain.float().norm()).item(),
                   share_differs_from_plain=(y != plain).double().mean().item())
        del diff, plain
        check(row["launches"] == 1, f"linear_gelu {name}: {row['launches']} launches")
        check(row["gelu_of_h_mismatches"] == 0, f"linear_gelu {name}: y is not gelu_bf16(h) on "
                                                 f"{row['gelu_of_h_mismatches']} elements")
        check(row["within_ulp_plus_summation_bound"] and row["share_over_1ulp"] <= LINEAR_GELU_ULP_SHARE
              and row["max_ulps_where_summation_bounded"] <= 2, f"linear_gelu {name}: h {row}")
        check(row["rel_l2_vs_plain"] <= LINEAR_GELU_REL_L2, f"linear_gelu {name}: y vs plain {row['rel_l2_vs_plain']:.3e}")
        if timed:
            row["ms"] = time_ms(lambda: lg.launch(x, w, b))
            for schedule in ("serial", "cooperative"):
                row[f"{schedule}_ms"] = time_ms(lambda: lg.launch(x, w, b, schedule=schedule))
            row["linear_only_ms"] = time_ms(lambda: F.linear(x, w, b))
            row["parent_pair_ms"] = time_ms(lambda: ge.gelu_bf16(F.linear(x, w, b)))
            row["library_ms"] = time_ms(lambda: F.gelu(F.linear(x, w, b), approximate="none"))
            row["plain_ms"] = time_ms(lambda: lg.linear_gelu_reference(x, w, b), reps=3, batches=5)
            row["bound_ms"], row["bound_by"] = linear_gelu_bound_ms(m, k, n)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["tflops"] = 2 * m * n * k / row["ms"] / 1e9
        rows[name] = row
        emit("kernel", kernel="linear_gelu_bf16_fwd", case=name, **row)
        del x, w, b, pre, y

    # every finite bf16 value as h: W = 0 and the bias holds the values (h =
    # 0 + b; -0 comes out +0, so it is left out)
    with np.load(GELU_TABLE) as z:
        want_bits = torch.from_numpy(z["y_bits"].view(np.int16).copy())
    values = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)
    held = torch.isfinite(values) & (_bits(values) != -32768)
    bias = torch.where(held, values, torch.zeros_like(values)).cuda()
    table = {}
    for schedule in lg.SCHEDULES:
        y = lg.launch(torch.zeros(3, 64, dtype=torch.bfloat16, device="cuda"),
                      torch.zeros(65536, 64, dtype=torch.bfloat16, device="cuda"), bias, schedule=schedule).cpu()
        table[schedule] = int(((_bits(y) != want_bits) & held).sum())
    before = lg.LAUNCHES
    x, w, b = operands(8, 64, 128)
    empty = lg.linear_gelu_bf16(x[:0], w, b)
    refused = {}
    flat = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16, device="cuda")
    for what, args in (("fp32", (x.float(), w, b)), ("k_mismatch", (x[:, :56], w, b)),
                       ("bias_length", (x, w, b[:64])), ("misaligned", (flat[1:1 + 8 * 64].view(8, 64), w, b))):
        try:
            lg.launch(*args)
            refused[what] = False
        except ValueError:
            refused[what] = True
    no_launch = lg.LAUNCHES == before
    host = {"kernel": host_us_per_launch(lambda: lg.linear_gelu_bf16(x, w, b)),
            "parent_pair": host_us_per_launch(lambda: ge.gelu_bf16(F.linear(x, w, b))),
            "linear_only": host_us_per_launch(lambda: F.linear(x, w, b))}
    keys = ("ms", "serial_ms", "cooperative_ms", "linear_only_ms", "parent_pair_ms", "library_ms", "plain_ms",
            "bound_ms")
    per_forward = {k: sum(rows[n]["calls_per_forward"] * rows[n][k] for n, _, _ in LINEAR_GELU_SHAPES) for k in keys}
    tiled = {k: sum(rows[n]["calls_per_forward"] * rows[n][k] for n, _, _ in LINEAR_GELU_TILED_SHAPES) for k in keys}
    max_abs_err = max(r["max_abs_diff_vs_plain"] for r in rows.values())
    emit("linear_gelu", table_mismatches=table, empty_shape=list(empty.shape), refused=refused,
         refusals_launched_nothing=no_launch, per_forward_ms=per_forward, tiled_forward_ms=tiled,
         launches_per_mlp={"kernel": 1, "parent_pair": 2, "library_pair": 2}, host_us_per_call=host,
         max_abs_err=max_abs_err)
    check(all(v == 0 for v in table.values()), f"linear_gelu: the GELU of a bf16 h differs from the table {table}")
    check(tuple(empty.shape) == (0, 128) and no_launch, "linear_gelu: an empty x or a refused call launched")
    check(all(refused.values()), f"linear_gelu: the kernel took what it refuses: {refused}")
    return rows, host["kernel"], max_abs_err


def phase_linear_swiglu():
    """The SwiGLU FFN's w12 with the gate in its epilogue
    (``ufm_torch::linear_swiglu_bf16``) at the 40 ViT-g/14 blocks' shape of a
    batch-1 and a batch-4 forward and off the tiles: y against the exact gate
    of the exact halves rounded to bf16 (within one bf16 ulp on all but
    LINEAR_SWIGLU_ULP_SHARE) and against the composition the FFN runs
    without it (F.linear, then the gate in fp32); an empty x launches
    nothing. Then the kernel, ``F.linear`` alone, the pair it replaces
    (``F.linear`` then DINOv2's ``F.silu(x1) * x2``), the port's composition
    and the bound timed at each forward shape, and the host's cost per
    call. Returns the summary entry."""
    import torch.nn.functional as F

    from benchmark.harness.swiglu import linear_swiglu_bound_ms
    from ufm_torch.ops import linear_swiglu as ls

    gen = torch.Generator(device="cuda").manual_seed(13)

    def operands(m, k, hidden):
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w12 = (torch.randn(2 * hidden, k, generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)
        b12 = (torch.randn(2 * hidden, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        return x, w12, b12

    def pair(x, w12, b12):
        x1, x2 = F.linear(x, w12, b12).chunk(2, dim=-1)
        return F.silu(x1) * x2

    rows = {}
    cases = [(name, shape, calls) for name, shape, calls in LINEAR_SWIGLU_SHAPES]
    cases += [(f"m{m}_k{k}_h{h}", (m, k, h), 0) for m, k, h in LINEAR_SWIGLU_ODD]
    for name, (m, k, hidden), calls in cases:
        x, w12, b12 = operands(m, k, hidden)
        before = ls.LAUNCHES
        y = ls.launch(x, w12, b12)
        torch.cuda.synchronize()
        h = (x.double() @ w12.double().t() + b12.double()).float().to(torch.bfloat16).double()
        h1, h2 = h.chunk(2, dim=-1)
        exact = (h1 * torch.sigmoid(h1) * h2).float().to(torch.bfloat16)
        ulps = (_ordered_bf16(y) - _ordered_bf16(exact)).abs()
        plain = ls.linear_swiglu_reference(x, w12, b12).float()
        row = dict(shape=[m, k, hidden], calls_per_forward=calls, launches=ls.LAUNCHES - before,
                   share_over_1ulp=(ulps > 1).double().mean().item(), max_ulps=int(ulps.max()),
                   rel_l2_vs_plain=((y.float() - plain).norm() / plain.norm()).item(),
                   max_abs_diff_vs_plain=(y.float() - plain).abs().max().item())
        del h, h1, h2, exact, ulps, plain
        check(row["launches"] == 1, f"linear_swiglu {name}: {row['launches']} launches")
        check(row["share_over_1ulp"] <= LINEAR_SWIGLU_ULP_SHARE, f"linear_swiglu {name}: {row}")
        check(row["rel_l2_vs_plain"] <= LINEAR_SWIGLU_REL_L2, f"linear_swiglu {name}: {row}")
        if calls:
            row["ms"] = time_ms(lambda: ls.launch(x, w12, b12))
            row["linear_only_ms"] = time_ms(lambda: F.linear(x, w12, b12))
            row["pair_ms"] = time_ms(lambda: pair(x, w12, b12))
            row["plain_ms"] = time_ms(lambda: ls.linear_swiglu_reference(x, w12, b12))
            row["bound_ms"], row["bound_by"] = linear_swiglu_bound_ms(m, k, hidden)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["share_of_bound_of_pair"] = row["bound_ms"] / row["pair_ms"]
            row["tflops"] = 2 * m * k * 2 * hidden / row["ms"] / 1e9
        rows[name] = row
        emit("kernel", kernel="linear_swiglu_bf16_fwd", case=name, **row)
        del x, w12, b12, y
    x, w12, b12 = operands(8, 64, 64)
    before = ls.LAUNCHES
    empty = ls.linear_swiglu_bf16(x[:0], w12, b12)
    check(tuple(empty.shape) == (0, 64) and ls.LAUNCHES == before, "linear_swiglu: an empty x launched")
    host = {"kernel": host_us_per_launch(lambda: ls.linear_swiglu_bf16(x, w12, b12)),
            "pair": host_us_per_launch(lambda: pair(x, w12, b12))}
    b1 = rows["vitg_b1"]
    emit("linear_swiglu", per_forward_ms={k: b1["calls_per_forward"] * b1[k]
                                          for k in ("ms", "linear_only_ms", "pair_ms", "plain_ms", "bound_ms")},
         host_us_per_call=host, kernel_over_pair={n: rows[n]["ms"] / rows[n]["pair_ms"] for n, *_ in
                                                  LINEAR_SWIGLU_SHAPES})
    return {
        "name": "linear_swiglu_bf16_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/linear_swiglu_bf16_fwd.cu",
        "replaces": None,
        "replaces_note": "no TPU kernel (the JAX package has no SwiGLU FFN): w12 -> silu(x1) * x2 of DINOv2's "
                         "SwiGLUFFNFused as one kernel",
        "launches": 0,
        "launches_by_path": {},
        "op": "ufm_torch::linear_swiglu_bf16",
        "max_abs_err": max(r["max_abs_diff_vs_plain"] for r in rows.values()),
        "ms": b1["calls_per_forward"] * b1["ms"],
        "plain_ms": b1["calls_per_forward"] * b1["plain_ms"],
        "bound_ms": b1["calls_per_forward"] * b1["bound_ms"],
        "bound_by": b1["bound_by"],
        "library_ms": b1["calls_per_forward"] * b1["pair_ms"],
        "library": "F.linear(x, w12, b12) then F.silu(x1) * x2 (DINOv2's SwiGLUFFNFused): no single PyTorch call "
                   "computes the product and the gate",
        "per_forward": "times sum the 40 ViT-g/14 blocks of one batch-1 forward",
        "ms_by_case": {n: r["ms"] for n, r in rows.items() if "ms" in r},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in rows.items() if "ms" in r},
        "host_us_per_launch": host["kernel"],
    }


def gelu_bwd_bound_ms(numel: int):
    """Bytes: g and x read once, dx written once (bf16). Operations:
    GELU_BWD_OPS_PER_ELEMENT fp32 operations an element."""
    t_ops = GELU_BWD_OPS_PER_ELEMENT * numel / PEAK_FP32_FLOPS * 1e3
    t_bytes = 6 * numel / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _differ(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Where two bf16 tensors' bits differ, NaN counted equal to NaN."""
    return (_bits(got) != _bits(want)) & ~(torch.isnan(got) & torch.isnan(want))


def _gelu_bwd_cotangents(shape, gen) -> torch.Tensor:
    """Seeded normal cotangents with GELU_BWD_ZERO_SHARE of them each +0, -0
    and 1e-38 (flushed where XLA's CPU flushes)."""
    g = torch.randn(shape, generator=gen, device="cuda")
    pick = torch.rand(shape, generator=gen, device="cuda")
    share = GELU_BWD_ZERO_SHARE
    g = torch.where(pick < share, 0.0, torch.where(pick < 2 * share, -0.0, torch.where(pick < 3 * share, 1e-38, g)))
    return g.to(torch.bfloat16)


def phase_gelu_backward():
    """The GELU gradient kernel (``ufm_torch::gelu_bf16_bwd``) against the JAX
    package's VJP (the committed table) on all 65,536 bf16 bit patterns under
    each of its six cotangent sets: bit for bit on the finite inputs (NaN
    equal to NaN), NaN on the others; against its plain version (run on the
    card) at the train step's MLP shapes, with normal cotangents and with a
    share of them zero, signed zero and tiny; odd element counts, a
    misaligned and a non-contiguous operand against the plain version; fp32
    and mismatched shapes refused without a launch. Then timed at the train
    step's MLP shapes beside its bound, ``aten.gelu_backward`` (the library
    call) and the plain version; the host's cost per launch. Returns (rows by
    shape, host us per launch, max abs error against the table)."""
    from ufm_torch.ops import _build, gelu

    with np.load(GELU_VJP_TABLE) as z:
        sets, g_bits, dx_bits = [str(n) for n in z["sets"]], z["g_bits"], z["dx_bits"]
        finite = torch.from_numpy(z["finite"])
    x = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)  # x[i] has bits i
    check(torch.equal(finite, torch.isfinite(x)) and int(finite.sum()) == 65280, "the VJP table's finite mask")
    table, max_abs_err = {}, 0.0
    for name, gb, db in zip(sets, g_bits, dx_bits):
        g = torch.from_numpy(gb.view(np.int16).copy()).view(torch.bfloat16)
        want = torch.from_numpy(db.view(np.int16).copy()).view(torch.bfloat16)
        card = gelu.gelu_bf16_bwd(g.cuda(), x.cuda()).cpu()
        plain_card = gelu.fast_exact_gelu_vjp_reference(x.cuda(), g.cuda()).cpu()
        table[name] = {"kernel_vs_table": int(_differ(card, want)[finite].sum()),
                       "kernel_vs_plain_on_card": int(_differ(card, plain_card).sum()),
                       "nonfinite_x_nan": bool(torch.isnan(card[~finite]).all())}
        both = finite & ~torch.isnan(want)
        max_abs_err = max(max_abs_err, (card.float() - want.float())[both].abs().max().item())

    gen = torch.Generator(device="cuda").manual_seed(8)
    odd = {}
    base = (torch.randn(2, 8 * 1001 + 16, generator=gen, device="cuda") * 4).to(torch.bfloat16)
    cases = {f"n{n}": (base[0, :n], base[1, :n]) for n in GELU_ODD_COUNTS}
    cases["misaligned"] = (base[0, 3:8 * 1001 + 3], base[1, :8 * 1001])  # g 6 bytes past a 16-byte boundary
    cases["non_contiguous"] = (base[0, :40 * 200].view(40, 200).t(), base[1, :40 * 200].view(200, 40))
    for name, (g, h) in cases.items():
        before = gelu.BWD_LAUNCHES
        got = gelu.gelu_bf16_bwd(g, h)
        launched = gelu.BWD_LAUNCHES - before
        ok = got.shape == h.shape and not bool(_differ(got, gelu.fast_exact_gelu_vjp_reference(h, g)).any())
        odd[name] = dict(numel=h.numel(), bitwise_plain=ok, launches=launched)
        check(ok, f"gelu_backward {name}: the kernel differs from the plain version")
        check(launched == int(h.numel() > 0), f"gelu_backward {name}: {launched} launches")
    refused = {}
    before = gelu.BWD_LAUNCHES
    for what, args in (("fp32", (base[0].float(), base[1])), ("shape", (base[0, :8], base[1, :16]))):
        try:
            gelu.launch_backward(*args)
            refused[what] = False
        except ValueError:
            refused[what] = True
    refusals_launched_nothing = gelu.BWD_LAUNCHES == before

    rows = {}
    for name, shape, per_step in GELU_BWD_SHAPES:
        h = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        mismatches = {}
        for label, cot in (("normal", g), ("zeros_and_tiny", _gelu_bwd_cotangents(shape, gen))):
            got = gelu.gelu_bf16_bwd(cot, h)
            mismatches[label] = int(_differ(got, gelu.fast_exact_gelu_vjp_reference(h, cot)).sum())
            del cot
        ms = time_ms(lambda: gelu.gelu_bf16_bwd(g, h))
        library_ms = time_ms(lambda: torch.ops.aten.gelu_backward(g, h, approximate="none"))
        plain_ms = time_ms(lambda: gelu.fast_exact_gelu_vjp_reference(h, g), reps=2, batches=3)
        bound_ms, bound_by = gelu_bwd_bound_ms(h.numel())
        rows[name] = dict(shape=list(shape), mlps_per_step=per_step, plain_mismatches=mismatches, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                          share_of_bound=bound_ms / ms, gbytes_per_s=6 * h.numel() / ms / 1e6)
        emit("kernel", kernel="gelu_bf16_bwd", case=name, **rows[name])
        for label, n in mismatches.items():
            check(n == 0, f"gelu_backward {name}, {label} cotangents: {n} elements differ from the plain version")
        del h, g
        _free_card_memory()
    small = torch.randn(2, 64, generator=gen, device="cuda").to(torch.bfloat16)
    host = {"kernel": host_us_per_launch(lambda: gelu.gelu_bf16_bwd(small[0], small[1])),
            "library": host_us_per_launch(lambda: torch.ops.aten.gelu_backward(small[0], small[1]))}
    per_step = {k: sum(r["mlps_per_step"] * r[k] for r in rows.values())
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    emit("gelu_backward", inputs=int(finite.sum()), sets=sets, table=table, max_abs_err=max_abs_err, odd=odd,
         refused=refused, refusals_launched_nothing=refusals_launched_nothing, per_step_ms=per_step,
         host_us_per_call=host, ptxas=ptxas_report(_build.BUILD_LOGS.get("gelu_bf16_bwd", "")))
    for name, row in table.items():
        check(row["kernel_vs_table"] == 0 and row["kernel_vs_plain_on_card"] == 0 and row["nonfinite_x_nan"],
              f"gelu_backward, cotangents {name}: {row}")
    check(all(refused.values()) and refusals_launched_nothing, f"gelu_backward refusals: {refused}")
    return rows, host["kernel"], max_abs_err


def phase_linear_gelu_train():
    """The fused op's training route at the MLP shapes of a batch-2 train
    step: under autograd, one launch gives y and h
    (``ufm_torch::linear_gelu_bf16_preact``); y bit for bit the inference
    launch's and the GELU's plain chain of h, h bit for bit the inference
    launch's ``preact_out``, and against the exact product + bias; y
    against the plain version (F.linear, then the GELU's plain chain); the
    gradient: dx, dw and db bit for bit ``dh w``, ``dh^T x`` and the column
    sums of ``dh = gelu_bf16_bwd(dy, h)`` on the saved h, and against the
    two-op route (F.linear, then the GELU op) within LINEAR_GELU_GRAD_REL_L2.
    Timed: the training launch beside the inference launch, and the fused
    op's backward beside the two-op route's. Returns rows by shape."""
    import torch.nn.functional as F

    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import library
    from ufm_torch.ops import linear_gelu as lg

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {}
    for name, (m, k, n), per_step in LINEAR_GELU_TRAIN_SHAPES:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device="cuda") * k**-0.5).to(torch.bfloat16)
        b = (torch.randn(n, generator=gen, device="cuda") * LINEAR_GELU_BIAS_STD).to(torch.bfloat16)
        dy = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        pre = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        y_inf = lg.launch(x, w, b, preact_out=pre)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        before = (lg.LAUNCHES, ge.LAUNCHES, ge.BWD_LAUNCHES)
        y = library.linear_gelu_bf16(*leaves)
        h = y.grad_fn.saved_tensors[2]
        got = torch.autograd.grad(y, leaves, dy)
        launched = (lg.LAUNCHES - before[0], ge.LAUNCHES - before[1], ge.BWD_LAUNCHES - before[2])
        dh = ge.gelu_bf16_bwd(dy, h)
        formulas = (dh.mm(w), dh.t().mm(x), dh.sum(0))
        two = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y_two = ge.gelu_bf16(F.linear(*two))
        want = torch.autograd.grad(y_two, two, dy)
        plain = lg.linear_gelu_reference(x, w, b)
        torch.cuda.synchronize()
        row = dict(shape=[m, k, n], calls_per_step=per_step, launches=launched,
                   y_vs_inference_bitwise=torch.equal(_bits(y.detach()), _bits(y_inf)),
                   h_vs_preact_out_bitwise=torch.equal(_bits(h), _bits(pre)),
                   y_vs_gelu_of_h_bitwise=torch.equal(_bits(y.detach()), _bits(ge.fast_exact_gelu_reference(h))),
                   h_share_differs_from_f_linear=(h != F.linear(x, w, b)).double().mean().item(),
                   **_preact_check(h, x, w, b),
                   y_rel_l2_vs_plain=((y.detach().float() - plain.float()).norm() / plain.float().norm()).item(),
                   grads_bitwise_formulas={g_name: torch.equal(_bits(a), _bits(c)) for g_name, a, c
                                           in zip(("dx", "dw", "db"), got, formulas)},
                   grad_rel_l2_vs_two_op={g_name: ((a.float() - c.float()).norm() / c.float().norm()).item()
                                          for g_name, a, c in zip(("dx", "dw", "db"), got, want)})
        del plain, dh, formulas

        def fused_step():
            out = library.linear_gelu_bf16(*leaves)
            torch.autograd.grad(out, leaves, dy)

        def two_op_step():
            out = ge.gelu_bf16(F.linear(*two))
            torch.autograd.grad(out, two, dy)

        row["ms"] = time_ms(lambda: lg.launch(x, w, b))
        row["with_preact_ms"] = time_ms(lambda: lg.launch_preact(x, w, b))
        row["fused_forward_backward_ms"] = time_ms(fused_step)
        row["two_op_forward_backward_ms"] = time_ms(two_op_step)
        rows[name] = row
        emit("kernel", kernel="linear_gelu_bf16_fwd", case=f"{name}_train", **row)
        check(launched == (1, 0, 1), f"linear_gelu_train {name}: (fused, GELU, GELU gradient) launches {launched}")
        check(row["y_vs_inference_bitwise"] and row["h_vs_preact_out_bitwise"] and row["y_vs_gelu_of_h_bitwise"],
              f"linear_gelu_train {name}: {row}")
        check(row["within_ulp_plus_summation_bound"] and row["y_rel_l2_vs_plain"] <= LINEAR_GELU_REL_L2,
              f"linear_gelu_train {name}: h or y {row}")
        check(all(row["grads_bitwise_formulas"].values()), f"linear_gelu_train {name}: {row['grads_bitwise_formulas']}")
        for g_name, r in row["grad_rel_l2_vs_two_op"].items():
            check(r <= LINEAR_GELU_GRAD_REL_L2, f"linear_gelu_train {name}: {g_name} vs the two-op route {r:.3e}")
        del x, w, b, dy, pre, y_inf, leaves, y, h, got, two, y_two, want
        _free_card_memory()
    per_step = {k: sum(r["calls_per_step"] * r[k] for r in rows.values())
                for k in ("ms", "with_preact_ms", "fused_forward_backward_ms", "two_op_forward_backward_ms")}
    emit("linear_gelu_train", per_step_ms=per_step)
    return rows


def linear_gelu_bwd_bound_ms(m: int, n2: int, n: int):
    """Operations: 2 M N N2 on the tensor cores. Bytes: g, w2 and h read
    once, dh written once (bf16)."""
    t_ops = 2 * m * n * n2 / PEAK_BF16_FLOPS * 1e3
    t_bytes = 2 * (m * n2 + n2 * n + 2 * m * n) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def _ulp_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_ordered_bf16(a) - _ordered_bf16(b)).abs()


def phase_linear_gelu_backward():
    """fc2's input gradient with the GELU gradient as its epilogue
    (``ufm_torch::linear_gelu_bf16_bwd``) at the train step's MLP shapes:
    dh bit for bit the plain VJP and the standalone gradient kernel of the
    kernel's own dy (the check instance's dy_out), and the op's launch bit
    for bit the check instance's; dy against cuBLAS's g.mm(w2) (elements
    that differ, the largest gap in ulps) and against the exact product
    (float64; within one ulp plus fp32 summation's bound everywhere, more
    than one ulp on at most LINEAR_GELU_ULP_SHARE of the elements); every
    bf16 h under three cotangent scales; rows off the tile and N2 / N tails;
    fp32, a misaligned w2 and a non-contiguous w2 refused without a launch;
    the profiler sees the kernel by its name. Timed beside its bound, its
    epilogue's issue floor, cuBLAS g.mm(w2) alone, g.mm(w2) +
    aten.gelu_backward (the library pair), g.mm(w2) + gelu_bf16_bwd (the
    parent's route), the plain version and each schedule. Then an MLP at the
    encoder's widths: its five gradients through the route against the
    two-node route's (bit for bit where the kernel's dy is cuBLAS's, else
    within LINEAR_GELU_GRAD_REL_L2), one fused launch and no standalone
    gradient. Returns (rows by shape, host us per launch, max abs error of dh
    against the plain version)."""
    from ufm_torch.nn.layers import Mlp
    from ufm_torch.ops import _build
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg

    clock = _max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows, max_abs_err = {}, 0.0
    for name, (m, n2, n), per_step in LINEAR_GELU_TRAIN_SHAPES:
        g = torch.randn(m, n2, generator=gen, device="cuda").to(torch.bfloat16)
        w2 = (torch.randn(n2, n, generator=gen, device="cuda") * n2**-0.5).to(torch.bfloat16)
        h = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
        dy = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        before = lg.BWD_LAUNCHES
        dh = lg.launch_backward(g, w2, h, dy_out=dy)
        launched = lg.BWD_LAUNCHES - before
        plain_own = ge.fast_exact_gelu_vjp_reference(h, dy)
        cublas = g.mm(w2)
        gaps = _ulp_gaps(dy, cublas)
        row = dict(shape_m_n2_n=[m, n2, n], calls_per_step=per_step, launches=launched,
                   dh_vs_plain_of_own_dy_mismatches=int(_differ(dh, plain_own).sum()),
                   dh_vs_gelu_bwd_of_own_dy_mismatches=int(_differ(dh, ge.gelu_bf16_bwd(dy, h)).sum()),
                   op_launch_vs_check_instance_bitwise=torch.equal(_bits(lg.linear_gelu_bf16_bwd(g, w2, h)), _bits(dh)),
                   dy_vs_cublas_differing=int((gaps > 0).sum()), dy_vs_cublas_max_ulps=int(gaps.max()),
                   dy_vs_exact=_preact_check(dy, g, w2.t(), torch.zeros(n, dtype=torch.bfloat16, device="cuda")),
                   dh_share_differs_from_parent_route=(_differ(dh, ge.gelu_bf16_bwd(cublas, h))).double().mean().item())
        both = ~(torch.isnan(dh) | torch.isnan(plain_own))
        max_abs_err = max(max_abs_err, (dh.float() - plain_own.float())[both].abs().max().item())
        del plain_own, gaps
        schedules = {sch: time_ms(lambda: lg.launch_backward(g, w2, h, schedule=sch)) for sch in lg.BWD_SCHEDULES}
        row["ms"] = schedules.pop("pingpong")
        row.update({f"{sch}_ms": ms for sch, ms in schedules.items()})
        row["cublas_mm_ms"] = time_ms(lambda: g.mm(w2))
        row["parent_pair_ms"] = time_ms(lambda: ge.gelu_bf16_bwd(g.mm(w2), h))
        row["library_pair_ms"] = time_ms(lambda: torch.ops.aten.gelu_backward(g.mm(w2), h, approximate="none"))
        row["plain_ms"] = time_ms(lambda: lg.linear_gelu_bwd_reference(g, w2, h), reps=2, batches=3)
        row["bound_ms"], row["bound_by"] = linear_gelu_bwd_bound_ms(m, n2, n)
        row["issue_floor_ms"] = m * n / 32 * LINEAR_GELU_BWD_ISSUE_INSTR / (4 * sms * clock) * 1e3
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        emit("kernel", kernel="linear_gelu_bf16_bwd", case=name, **row)
        check(launched == 1, f"linear_gelu_backward {name}: {launched} launches")
        check(row["dh_vs_plain_of_own_dy_mismatches"] == 0 and row["dh_vs_gelu_bwd_of_own_dy_mismatches"] == 0
              and row["op_launch_vs_check_instance_bitwise"], f"linear_gelu_backward {name}: dh {row}")
        ex = row["dy_vs_exact"]
        check(ex["within_ulp_plus_summation_bound"] and ex["share_over_1ulp"] <= LINEAR_GELU_ULP_SHARE
              and ex["max_ulps_where_summation_bounded"] <= 2, f"linear_gelu_backward {name}: dy {ex}")
        del g, w2, h, dy, dh, cublas
        _free_card_memory()

    # every bf16 h, under small, unit and large cotangents
    hb = torch.from_numpy(np.arange(65536, dtype=np.uint16).view(np.int16).reshape(128, 512)).view(torch.bfloat16)
    hb = hb.cuda()
    table = {}
    for scale in (1e-3, 1.0, 30.0):
        g = (torch.randn(128, 64, generator=gen, device="cuda") * scale).to(torch.bfloat16)
        w2 = (torch.randn(64, 512, generator=gen, device="cuda") / 8).to(torch.bfloat16)
        dy = torch.empty(128, 512, dtype=torch.bfloat16, device="cuda")
        dh = lg.launch_backward(g, w2, hb, dy_out=dy)
        table[str(scale)] = int(_differ(dh, ge.fast_exact_gelu_vjp_reference(hb, dy)).sum())
    odd = {}
    for m, n2, n in LINEAR_GELU_BWD_ODD:
        g = torch.randn(m, n2, generator=gen, device="cuda").to(torch.bfloat16)
        w2 = (torch.randn(n2, n, generator=gen, device="cuda") * n2**-0.5).to(torch.bfloat16)
        h = (torch.randn(m, n, generator=gen, device="cuda") * 3).to(torch.bfloat16)
        dy = torch.empty(m, n, dtype=torch.bfloat16, device="cuda")
        per_schedule = {}
        for sch in lg.BWD_SCHEDULES:
            dh = lg.launch_backward(g, w2, h, dy_out=dy, schedule=sch)
            per_schedule[sch] = int(_differ(dh, ge.fast_exact_gelu_vjp_reference(h, dy)).sum())
        odd[f"m{m}_n2{n2}_n{n}"] = per_schedule
    base = torch.zeros(64 * 128 + 8, dtype=torch.bfloat16, device="cuda")
    g, h = torch.zeros(8, 64, dtype=torch.bfloat16, device="cuda"), torch.zeros(8, 128, dtype=torch.bfloat16, device="cuda")
    refused, before = {}, lg.BWD_LAUNCHES
    for what, args in (("fp32", (g.float(), base[:64 * 128].view(64, 128), h)),
                       ("misaligned_w2", (g, base[1:1 + 64 * 128].view(64, 128), h)),
                       ("non_contiguous_w2", (g, base[:64 * 128].view(128, 64).t(), h)),
                       ("n_off_8", (g, base[:64 * 100].view(64, 100), h[:, :100]))):
        try:
            lg.launch_backward(*args)
            refused[what] = False
        except ValueError:
            refused[what] = True
    refusals_launched_nothing = lg.BWD_LAUNCHES == before
    # the profiler sees the kernel by its __global__ name
    g = torch.randn(4804, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    w2 = (torch.randn(1024, 4096, generator=gen, device="cuda") / 32).to(torch.bfloat16)
    h = torch.randn(4804, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lg.linear_gelu_bf16_bwd(g, w2, h)
        torch.cuda.synchronize()
    profiled = sum(e.count for e in prof.key_averages() if "linear_gelu_bf16_bwd_kernel" in e.key)
    small = (g[:64, :64].contiguous(), w2[:64, :128].contiguous(), h[:64, :128].contiguous())
    host_us = host_us_per_launch(lambda: lg.linear_gelu_bf16_bwd(*small))
    del g, w2, h, small
    _free_card_memory()

    # an MLP at the encoder's widths: the route against the two-node route
    torch.manual_seed(0)
    mlp = Mlp(1024, 4096).to("cuda", torch.bfloat16)
    with torch.no_grad():
        mlp.fc1.bias.normal_(0.0, LINEAR_GELU_BIAS_STD)
    x = torch.randn(4, 1201, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    cot = torch.randn(4, 1201, 1024, generator=gen, device="cuda").to(torch.bfloat16)

    def mlp_grads(fused):
        xt = x.clone().requires_grad_(True)
        mlp.zero_grad(set_to_none=True)
        before = (lg.BWD_LAUNCHES, ge.BWD_LAUNCHES)
        out = mlp(xt) if fused else mlp.fc2(lg.linear_gelu_bf16(xt, mlp.fc1.weight, mlp.fc1.bias))
        out.backward(cot)
        torch.cuda.synchronize()
        return [xt.grad] + [p.grad for p in mlp.parameters()], (lg.BWD_LAUNCHES - before[0], ge.BWD_LAUNCHES - before[1])

    got, got_launched = mlp_grads(True)
    want, want_launched = mlp_grads(False)
    hpre = lg.launch_preact(x, mlp.fc1.weight, mlp.fc1.bias)[1]
    dy_kernel = torch.empty(4 * 1201, 4096, dtype=torch.bfloat16, device="cuda")
    lg.launch_backward(cot.reshape(-1, 1024), mlp.fc2.weight, hpre, dy_out=dy_kernel)
    dy_equal = torch.equal(_bits(dy_kernel), _bits(cot.reshape(-1, 1024).mm(mlp.fc2.weight)))
    names = ("dx", "dw1", "db1", "dw2", "db2")
    mlp_row = dict(launches_fused_route=got_launched, launches_two_node_route=want_launched,
                   dy_kernel_equals_cublas=dy_equal,
                   bitwise={k: torch.equal(_bits(a), _bits(b)) for k, a, b in zip(names, got, want)},
                   rel_l2={k: ((a.float() - b.float()).norm() / b.float().norm()).item()
                           for k, a, b in zip(names, got, want)})
    del mlp, x, cot, got, want, hpre, dy_kernel
    _free_card_memory()
    per_step = {k: sum(r["calls_per_step"] * r[k] for r in rows.values())
                for k in ("ms", "serial_ms", "rr3_ms", "cublas_mm_ms", "parent_pair_ms", "library_pair_ms",
                          "plain_ms", "bound_ms", "issue_floor_ms")}
    emit("linear_gelu_backward", table_mismatches=table, odd=odd, refused=refused,
         refusals_launched_nothing=refusals_launched_nothing, profiler_kernel_count=profiled, mlp=mlp_row,
         per_step_ms=per_step, max_sm_clock_hz=clock, host_us_per_call=host_us,
         ptxas=ptxas_report(_build.BUILD_LOGS.get("linear_gelu_bf16_bwd", "")))
    check(all(v == 0 for v in table.values()), f"linear_gelu_backward: every-bf16-h mismatches {table}")
    check(all(v == 0 for r in odd.values() for v in r.values()), f"linear_gelu_backward: tails {odd}")
    check(all(refused.values()) and refusals_launched_nothing, f"linear_gelu_backward refusals: {refused}")
    check(profiled == 1, f"linear_gelu_backward: the profiler saw {profiled} linear_gelu_bf16_bwd_kernel launches")
    check(got_launched == (1, 0) and want_launched == (0, 1), f"linear_gelu_backward MLP launches {mlp_row}")
    if dy_equal:
        check(all(mlp_row["bitwise"].values()), f"linear_gelu_backward MLP: dy equal, gradients not bitwise {mlp_row}")
    check(all(r <= LINEAR_GELU_GRAD_REL_L2 for r in mlp_row["rel_l2"].values()),
          f"linear_gelu_backward MLP gradients vs the two-node route {mlp_row['rel_l2']}")
    return rows, host_us, max_abs_err


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def phase_main_path():
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg

    t0 = time.perf_counter()
    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
    torch.cuda.synchronize()
    emit("model", seconds=time.perf_counter() - t0, params=sum(p.numel() for p in model.parameters()),
         device=str(model.device), compute_dtype=model.config.compute_dtype)

    rng = np.random.default_rng(0)
    requests = (
        ("480x640_b1", rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)),
        ("1080x1920_b1", rng.integers(0, 256, (2, 1080, 1920, 3), dtype=np.uint8)),
        ("480x640_b2", rng.integers(0, 256, (2, 2, 480, 640, 3), dtype=np.uint8)),
    )
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = fa.ANY_LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # the main path's counts start here
    results, latencies = {}, {}
    for name, pair in requests:
        src, tgt = pair[0], pair[1]
        b = src.shape[0] if src.ndim == 4 else 1
        h, w = src.shape[-3], src.shape[-2]
        times = []
        for _ in range(4):  # one warm-up, three timed
            before = (fa.LAUNCHES, ge.LAUNCHES, lg.LAUNCHES)
            t = time.perf_counter()
            res = model.predict_correspondences_batched(source_image=src, target_image=tgt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(fa.LAUNCHES - before[0] == LAUNCHES_PER_FORWARD,
                  f"{name}: {fa.LAUNCHES - before[0]} kernel launches in one forward, expected {LAUNCHES_PER_FORWARD}")
            mlps = (ge.LAUNCHES - before[1], lg.LAUNCHES - before[2])
            check(mlps == (0, GELU_PER_FORWARD),
                  f"{name}: {mlps} GELU / fused fc1 + GELU launches in one forward, expected (0, {GELU_PER_FORWARD})")
        flow, covis = res.flow.flow_output, res.covisibility.mask
        cov, conf = res.flow.flow_covariance, res.keypoint_confidence
        check(tuple(flow.shape) == (b, 2, h, w), f"{name}: flow shape {tuple(flow.shape)}")
        check(tuple(covis.shape) == (b, h, w), f"{name}: covisibility shape {tuple(covis.shape)}")
        check(tuple(cov.shape) == (b, 3, h, w), f"{name}: covariance shape {tuple(cov.shape)}")
        check(tuple(conf.shape) == (b, h, w), f"{name}: confidence shape {tuple(conf.shape)}")
        check(all(_finite(x) for x in (flow, covis, cov, conf)), f"{name}: non-finite outputs")
        latencies[name] = statistics.median(times[1:])
        results[name] = res
        emit("request", request=name, batch=b, input_hw=[h, w], first_s=times[0], latency_s=latencies[name],
             pairs_per_s=b / latencies[name], flow_abs_mean=flow.abs().mean().item(),
             covis_mean=covis.mean().item())
    launches = fa.LAUNCHES
    check(fa.ANY_LAUNCHES == 0, f"the bf16 d = 64 path launched the mma attention kernel {fa.ANY_LAUNCHES} times")
    mlp_path("ufm_base", mlp_counts(ge, lg), 4 * len(requests) * GELU_PER_FORWARD)
    emit("main_path", launches=launches, mma_launches=fa.ANY_LAUNCHES, forwards=4 * len(requests),
         launches_per_forward=LAUNCHES_PER_FORWARD,
         gelu_launches=ge.LAUNCHES, linear_gelu_launches=lg.LAUNCHES,
         pairs_per_s_b1=1.0 / latencies["480x640_b1"], max_memory_allocated=torch.cuda.max_memory_allocated())
    return model, requests[0][1], results["480x640_b1"], launches


def phase_fused_mlp_model(model):
    """The flagship UFM-Base forward at batch 1 on the fused path without a
    gradient (36 fused fc1 + GELU launches), with one (grad mode, parameters
    that require grad: the 36 launches also write the pre-activation; the
    same flow bit for bit) and on the two-op path of the same weights (grad
    mode under activation checkpointing: fc1, then 36 standalone GELU
    launches): flow within FLOW_REL_L2_BOUND."""
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg

    net = model.net
    img1, img2 = _normalized_pair(1, TRAIN_HW, seed=4)
    ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
    with torch.no_grad():
        fused = net(img1, img2)["flow"].float()
    torch.cuda.synchronize()
    mlp_path("ufm_base_fused_check", mlp_counts(ge, lg), GELU_PER_FORWARD)
    wanted = [p.requires_grad for p in net.parameters()]
    net.requires_grad_(True)
    flows = {}
    try:
        for label, remat in (("grad", False), ("two_op", True)):
            ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
            _set_remat(net, remat, None)
            with torch.enable_grad():
                flows[label] = net(img1, img2)["flow"].detach().float()
            torch.cuda.synchronize()
            if remat:
                mlp_path("ufm_base_two_op_check", mlp_counts(ge, lg), 0, two_op=GELU_PER_FORWARD)
            else:
                mlp_path("ufm_base_fused_grad_check", mlp_counts(ge, lg), GELU_PER_FORWARD)
    finally:
        _set_remat(net, False, None)
        for p, want in zip(net.parameters(), wanted):
            p.requires_grad_(want)
    two_op = flows["two_op"]
    rel = ((fused - two_op).norm() / two_op.norm()).item()
    emit("fused_mlp_model", input_hw=list(TRAIN_HW), flow_rel_l2=rel, flow_max_abs_diff=(fused - two_op).abs().max().item(),
         bound=FLOW_REL_L2_BOUND, grad_mode_bitwise=torch.equal(fused, flows["grad"]))
    check(torch.equal(fused, flows["grad"]), "the fused path's flow with a gradient recorded differs from without")
    check(_finite(fused) and rel <= FLOW_REL_L2_BOUND, f"fused vs two-op MLPs: flow relative L2 {rel:.3e}")
    del fused, two_op, flows
    _free_card_memory()


def phase_self_check(model, pair, kernel_res):
    from ufm_torch.ops import flash_attention as fa

    model.attention_impl = "torch"
    fa.LAUNCHES = 0
    res = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    torch.cuda.synchronize()
    check(fa.LAUNCHES == 0, "the plain-attention run launched the kernel")
    model.attention_impl = None
    f_k, f_t = kernel_res.flow.flow_output.float(), res.flow.flow_output.float()
    rel = ((f_k - f_t).norm() / f_t.norm()).item()
    covis_diff = (kernel_res.covisibility.mask - res.covisibility.mask).abs().max().item()
    emit("self_check", flow_rel_l2=rel, flow_rel_l2_bound=FLOW_REL_L2_BOUND, covis_max_abs_diff=covis_diff)
    check(rel <= FLOW_REL_L2_BOUND, f"kernel vs plain attention: flow relative L2 {rel:.3e} > {FLOW_REL_L2_BOUND}")


def _load_bf16_golden(name: str):
    """(config, inputs, flat params, outputs) of a d = 64 golden written by
    tests/test_torch_port_bf16.py (numpy only: the card has no JAX)."""
    with np.load(os.path.join(HERE, "tests", "golden", f"torch_port_bf16_d64_{name}.npz")) as z:
        files = {k: z[k] for k in z.files}
    params = {k[len("params/"):]: v for k, v in files.items() if k.startswith("params/")}
    out = {k[len("out/"):]: v for k, v in files.items() if k.startswith("out/")}
    return json.loads(str(files["config"])), (files["input_1"], files["input_2"]), params, out


def phase_bf16_golden():
    """The kernel path (attention, and the window kernel for UFM-Refine) of
    the d = 64 tiny models, from the goldens' JAX parameters, against the JAX
    package's bf16 outputs."""
    from ufm_torch.checkpoint import load_jax_params
    from ufm_torch.models import UFMArchConfig, UFMNet
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.ops import window_refinement as wr

    fa.LAUNCHES = wr.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
    for name in BF16_GOLDENS:
        cfg, (i1, i2), params, want = _load_bf16_golden(name)
        with torch.device("cuda"):
            net = UFMNet(UFMArchConfig.from_dict(cfg))
        load_jax_params(net, params)
        refine = net.cfg.has_classification_head
        if refine:
            net.refinement_impl = None  # the window kernel (the golden's config asks for the plain "xla")
        before = (fa.LAUNCHES, wr.LAUNCHES, mlp_counts(ge, lg))
        with torch.inference_mode():
            got = net(torch.from_numpy(i1).cuda(), torch.from_numpy(i2).cuda())
        torch.cuda.synchronize()
        launched = (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1])
        layers = cfg["encoder_kwargs"]["depth"] + cfg["info_sharing_kwargs"]["depth"]
        check(launched == (layers, int(refine)), f"bf16 golden {name}: {launched} attention / window launches")
        mlp_path("bf16_golden", {k: n - before[2][k] for k, n in mlp_counts(ge, lg).items()},
                 layers if net.cfg.compute_dtype == "bfloat16" else 0)
        diffs = {k: (got[k].float().cpu() - torch.from_numpy(v)).abs().max().item() for k, v in want.items()}
        emit("bf16_golden", model=name, input_hw=list(i1.shape[1:3]), max_abs_diff=diffs, bound=BF16_GOLDEN_ATOL,
             launches={"flash_attention_fwd": launched[0], "window_refinement_fwd": launched[1]})
        for k, d in diffs.items():
            check(d <= BF16_GOLDEN_ATOL, f"bf16 golden {name}: {k} differs from JAX by {d:.4f} > {BF16_GOLDEN_ATOL}")
    return {"flash_attention_fwd": fa.LAUNCHES, "window_refinement_fwd": wr.LAUNCHES}


def _outputs_equal(a, b) -> bool:
    def fields(r):
        return r.flow.flow_output, r.flow.flow_covariance, r.covisibility and r.covisibility.mask, r.keypoint_confidence

    return all(x is y if x is None or y is None else torch.equal(x, y) for x, y in zip(fields(a), fields(b)))


def phase_checkpoint(model, pair):
    """``save_pretrained`` of the flagship into the gitignored build/, read
    back by ``from_pretrained`` on the card: the same answer, bit for bit."""
    from ufm_torch.models import UniFlowMatchConfidence

    directory = os.path.join(HERE, "build", "chip_smoke_checkpoint")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        t = time.perf_counter()
        model.save_pretrained(directory)
        save_s = time.perf_counter() - t
        size = {name: os.path.getsize(os.path.join(directory, name)) for name in os.listdir(directory)}
        t = time.perf_counter()
        loaded = UniFlowMatchConfidence.from_pretrained(directory)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    same_params = all(torch.equal(a, b) for a, b in zip(model.net.state_dict().values(), loaded.net.state_dict().values()))
    want = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    again = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    got = loaded.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    torch.cuda.synchronize()
    emit("checkpoint", file_bytes=size, save_s=save_s, load_s=load_s, device=str(loaded.device),
         params_bitwise_equal=same_params, outputs_bitwise_equal=_outputs_equal(want, got),
         original_repeats_bitwise=_outputs_equal(want, again),
         flow_max_abs_diff=(want.flow.flow_output - got.flow.flow_output).abs().max().item())
    check(loaded.device.type == "cuda", f"from_pretrained loaded onto {loaded.device}")
    check(same_params, "parameters differ after save_pretrained / from_pretrained")
    check(_outputs_equal(want, got), "outputs differ after save_pretrained / from_pretrained")


def phase_tiled(model):
    """Tiled inference of a 1080x1920 pair: a coarse forward, then the 20
    tiles in forwards of 16 and 4. A warm-up call, then the counted and
    timed one. Then the self-check: each of that call's forwards again, on
    the same inputs, with the plain attention; and the whole call with the
    plain attention. Its tile windows sit at the rounded median of its own
    coarse flow, so the plain run may place a window 1 px away, and a model
    with random weights does not follow the shift of its window: the whole
    call is held to the bar only where no window moved."""
    from ufm_torch.models import tiled
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.utils.example_pairs import synthetic_pair

    src, tgt, gt, _ = synthetic_pair(h=TILED_HW[0], w=TILED_HW[1], seed=0)
    calls = []  # (batch, host s, device ms, source, target, flow) of each model call
    predict = model.predict_correspondences_batched

    def timed_predict(source_image, target_image, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        res = predict(source_image=source_image, target_image=target_image, **kwargs)
        end.record()
        torch.cuda.synchronize()
        calls.append((res.flow.flow_output.shape[0], time.perf_counter() - t, start.elapsed_time(end),
                      source_image, target_image, res.flow.flow_output))
        return res

    model.predict_correspondences_batched = timed_predict
    try:
        tiled.predict_correspondences_tiled(model, src, tgt)  # warm-up
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        fa.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # the tiled path's counts start here
        t = time.perf_counter()
        flow, covis = tiled.predict_correspondences_tiled(model, src, tgt)
        total_s = time.perf_counter() - t
        launches, mlps = fa.LAUNCHES, mlp_counts(ge, lg)
        peak = torch.cuda.max_memory_allocated()
        stats = dict(tiled.last_tile_stats)
        kernel_calls = list(calls)

        model.attention_impl = "torch"
        fa.LAUNCHES = 0
        forward_rel = []
        for _, _, _, s_img, t_img, f_kernel in kernel_calls:
            f_plain = predict(source_image=s_img, target_image=t_img).flow.flow_output.float()
            forward_rel.append(((f_kernel.float() - f_plain).norm() / f_plain.norm()).item())
        calls.clear()
        plain_flow, _ = tiled.predict_correspondences_tiled(model, src, tgt)
        plain_calls = list(calls)
        plain_launches = fa.LAUNCHES
    finally:
        model.attention_impl = None
        del model.predict_correspondences_batched  # back to the unwrapped method
    batches = [c[0] for c in kernel_calls]
    model_s = sum(c[1] for c in kernel_calls)
    epe = np.linalg.norm(flow - gt, axis=-1)
    emit("tiled", input_hw=list(TILED_HW), tile_stats=stats, batches=batches, launches=launches,
         launches_expected=LAUNCHES_PER_FORWARD * len(TILED_BATCHES), total_s=total_s,
         coarse_device_ms=kernel_calls[0][2], coarse_host_s=kernel_calls[0][1],
         tiles_device_ms=sum(c[2] for c in kernel_calls[1:]), tiles_host_s=sum(c[1] for c in kernel_calls[1:]),
         tiles_device_ms_by_forward=[c[2] for c in kernel_calls[1:]], stitch_host_s=total_s - model_s,
         max_memory_allocated=peak, epe_random_weights_px=float(epe.mean()), covis_mean=float(covis.mean()))
    check(stats.get("tiles") == TILED_TILES, f"tiled: {stats} (expected {TILED_TILES} tiles)")
    check(batches == TILED_BATCHES, f"tiled: forwards at batches {batches}, expected {TILED_BATCHES}")
    check(launches == LAUNCHES_PER_FORWARD * len(TILED_BATCHES), f"tiled: {launches} attention launches")
    mlp_path("ufm_base_tiled", mlps, GELU_PER_FORWARD * len(TILED_BATCHES))
    check(flow.shape == (*TILED_HW, 2) and covis.shape == TILED_HW, f"tiled: shapes {flow.shape} {covis.shape}")
    check(bool(np.isfinite(flow).all() and np.isfinite(covis).all()), "tiled: non-finite outputs")

    moved = sum(int(not np.array_equal(a, b)) for k, p in zip(kernel_calls[1:], plain_calls[1:])
                for a, b in zip(k[4], p[4]))
    rel = float(np.linalg.norm(flow - plain_flow) / np.linalg.norm(plain_flow))
    emit("tiled_self_check", forward_flow_rel_l2=forward_rel, windows_moved=moved, call_flow_rel_l2=rel,
         flow_rel_l2_bound=FLOW_REL_L2_BOUND)
    check(plain_launches == 0, "the plain-attention tiled run launched the kernel")
    check(max(forward_rel) <= FLOW_REL_L2_BOUND,
          f"tiled forwards, kernel vs plain attention: flow relative L2 {max(forward_rel):.3e} > {FLOW_REL_L2_BOUND}")
    if moved == 0:
        check(rel <= FLOW_REL_L2_BOUND, f"tiled, kernel vs plain attention: flow relative L2 {rel:.3e} > {FLOW_REL_L2_BOUND}")
    return launches


def phase_tiled_refine(model):
    """Tiled inference of a 1080x1920 pair with the full-width UFM-Refine
    (eager): a coarse forward, then the 20 tiles in forwards of 16 and 4,
    each forward 36 attention launches and 1 window launch; each forward
    held, on the same inputs, to the same forward with the plain window
    refinement: its refinement residual and log_softmax within the window
    kernel's bars (WINDOW_RESIDUAL_ATOL, WINDOW_LOG_SOFTMAX_ATOL: the
    residual is a small part of the flow, which the flow's relative L2,
    also held within FLOW_REL_L2_BOUND, would hardly see), the regression
    flow the windows sit at reported equal or not; the host's stitching
    seconds and peak memory."""
    from ufm_torch.models import tiled
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.ops import window_refinement as wr
    from ufm_torch.utils.example_pairs import synthetic_pair

    src, tgt, _, _ = synthetic_pair(h=TILED_HW[0], w=TILED_HW[1], seed=0)
    calls = []  # (batch, host s, device ms, source, target, flow, launches, refinement) of each model call
    refined = []  # the refinement stage's outputs of the call in flight
    predict, refine_tail = model.predict_correspondences_batched, model.net.refine_tail
    model.capture_graphs = False

    def recording_tail(*args, **kwargs):
        out = refine_tail(*args, **kwargs)
        refined.append(out)
        return out

    def timed_predict(source_image, target_image, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        before = (fa.LAUNCHES, wr.LAUNCHES)
        refined.clear()
        t = time.perf_counter()
        start.record()
        res = predict(source_image=source_image, target_image=target_image, **kwargs)
        end.record()
        torch.cuda.synchronize()
        check(len(refined) == 1, f"tiled refine: {len(refined)} refinement stages in one forward")
        calls.append((res.flow.flow_output.shape[0], time.perf_counter() - t, start.elapsed_time(end),
                      source_image, target_image, res.flow.flow_output,
                      (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1]), refined.pop()))
        return res

    model.predict_correspondences_batched = timed_predict
    model.net.refine_tail = recording_tail
    try:
        tiled.predict_correspondences_tiled(model, src, tgt)  # warm-up
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        # the tiled UFM-Refine path's counts start here
        fa.LAUNCHES = wr.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0
        t = time.perf_counter()
        flow, covis = tiled.predict_correspondences_tiled(model, src, tgt)
        total_s = time.perf_counter() - t
        launches = {"flash_attention_fwd": fa.LAUNCHES, "window_refinement_fwd": wr.LAUNCHES}
        mlps = mlp_counts(ge, lg)
        peak = torch.cuda.max_memory_allocated()
        stats = dict(tiled.last_tile_stats)
        kernel_calls = list(calls)

        model.refinement_impl = "torch"
        wr.LAUNCHES = 0
        forward_rel, residual_err, log_softmax_err, same_regression = [], [], [], []
        for _, _, _, s_img, t_img, f_kernel, _, r_kernel in kernel_calls:
            refined.clear()
            f_plain = predict(source_image=s_img, target_image=t_img).flow.flow_output.float()
            (r_plain,) = refined
            forward_rel.append(((f_kernel.float() - f_plain).norm() / f_plain.norm()).item())
            for errs, key in ((residual_err, "refinement_residual"), (log_softmax_err, "refinement_log_softmax")):
                errs.append((r_kernel[key] - r_plain[key]).abs().max().item())
            same_regression.append(torch.equal(r_kernel["regression_flow"], r_plain["regression_flow"]))
        plain_window_launches = wr.LAUNCHES
    finally:
        model.refinement_impl = None
        del model.predict_correspondences_batched, model.net.refine_tail  # back to the unwrapped methods
    batches = [c[0] for c in kernel_calls]
    model_s = sum(c[1] for c in kernel_calls)
    emit("tiled_refine", input_hw=list(TILED_HW), tile_stats=stats, batches=batches, launches=launches,
         launches_by_forward=[list(c[6]) for c in kernel_calls], total_s=total_s,
         coarse_device_ms=kernel_calls[0][2], tiles_device_ms=sum(c[2] for c in kernel_calls[1:]),
         tiles_host_s=sum(c[1] for c in kernel_calls[1:]), stitch_host_s=total_s - model_s,
         max_memory_allocated=peak, forward_flow_rel_l2_vs_plain_window=forward_rel,
         flow_rel_l2_bound=FLOW_REL_L2_BOUND, forward_residual_max_abs_err=residual_err,
         residual_atol=WINDOW_RESIDUAL_ATOL, forward_log_softmax_max_abs_err=log_softmax_err,
         log_softmax_atol=WINDOW_LOG_SOFTMAX_ATOL, forward_same_regression_flow=same_regression,
         covis_mean=float(covis.mean()))
    check(stats.get("tiles") == TILED_TILES, f"tiled refine: {stats} (expected {TILED_TILES} tiles)")
    check(batches == TILED_BATCHES, f"tiled refine: forwards at batches {batches}, expected {TILED_BATCHES}")
    check(all(c[6] == (LAUNCHES_PER_FORWARD, 1) for c in kernel_calls),
          f"tiled refine: attention / window launches by forward {[c[6] for c in kernel_calls]}")
    mlp_path("ufm_refine_tiled", mlps, GELU_PER_FORWARD * len(TILED_BATCHES))
    check(plain_window_launches == 0, "the plain-window tiled forwards launched the window kernel")
    check(flow.shape == (*TILED_HW, 2) and covis.shape == TILED_HW, f"tiled refine: shapes {flow.shape} {covis.shape}")
    check(bool(np.isfinite(flow).all() and np.isfinite(covis).all()), "tiled refine: non-finite outputs")
    check(max(forward_rel) <= FLOW_REL_L2_BOUND,
          f"tiled refine forwards, window kernel vs plain: flow relative L2 {max(forward_rel):.3e} > {FLOW_REL_L2_BOUND}")
    check(max(residual_err) <= WINDOW_RESIDUAL_ATOL,
          f"tiled refine forwards, window kernel vs plain: residual error {max(residual_err):.3e} > {WINDOW_RESIDUAL_ATOL}")
    check(max(log_softmax_err) <= WINDOW_LOG_SOFTMAX_ATOL,
          f"tiled refine forwards, window kernel vs plain: log_softmax error {max(log_softmax_err):.3e} > "
          f"{WINDOW_LOG_SOFTMAX_ATOL}")
    return launches


def phase_eval(model):
    """Flow metrics against the analytic flow, and forward-backward cycle
    metrics, of three synthetic pairs held in memory (no image files).
    With random weights this checks the pipeline, not accuracy: the cycle is
    scored over every in-image pixel, not the model's covisibility."""
    from ufm_torch.eval import cycle_consistency_metrics, flow_metrics
    from ufm_torch.models.tiled import flow_and_covisibility
    from ufm_torch.utils.example_pairs import synthetic_pair

    rows = []
    for seed in EVAL_SEEDS:
        img0, img1, gt, valid = synthetic_pair(h=EVAL_HW[0], w=EVAL_HW[1], seed=seed)
        fwd, _ = flow_and_covisibility(model.predict_correspondences_batched(source_image=img0, target_image=img1))
        bwd, _ = flow_and_covisibility(model.predict_correspondences_batched(source_image=img1, target_image=img0))
        rows.append({**flow_metrics(fwd[0], gt, valid), **cycle_consistency_metrics(fwd[0], bwd[0])})
    agg = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    emit("eval", pairs=len(rows), input_hw=list(EVAL_HW), aggregate=agg)
    check(all(np.isfinite(v) for r in rows for v in r.values()), f"eval: non-finite metrics {rows}")


def phase_tf32(model, pair):
    """The flagship's flow on one request with cuDNN's TF32 on (PyTorch's
    default, which the fp32 DPT heads' convolutions take), then off."""
    prev = torch.backends.cudnn.allow_tf32
    runs = {}
    try:
        for allow in (True, False):
            torch.backends.cudnn.allow_tf32 = allow
            model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])  # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
            torch.cuda.synchronize()
            runs[allow] = (res, time.perf_counter() - t)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (on, on_s), (off, off_s) = runs[True], runs[False]
    d = (on.flow.flow_output - off.flow.flow_output).float()
    epe = d.norm(dim=1)
    covis = (on.covisibility.mask - off.covisibility.mask).abs()
    emit("tf32", input_hw=list(pair[0].shape[:2]), flow_abs_diff_max_px=d.abs().max().item(),
         flow_abs_diff_mean_px=d.abs().mean().item(), epe_mean_px=epe.mean().item(), epe_max_px=epe.max().item(),
         budget_px=TF32_BUDGET_PX, within_budget=epe.mean().item() <= TF32_BUDGET_PX,
         covis_abs_diff_max=covis.max().item(), latency_s={"tf32_on": on_s, "tf32_off": off_s},
         flow_abs_mean_px=off.flow.flow_output.abs().mean().item())
    check(_finite(d), "tf32: non-finite flow")
    # the TF32 flags are part of a program's key: a replay of the TF32
    # graph for the fp32 request would show no difference at all
    check(d.abs().max().item() > 0, "tf32: TF32 on and off gave the same flow (one program for both?)")


def motion_flow(h, w, split):
    """(H, W, 2) xy flow of MOTION (with ``split``, the second motion below
    the diagonal), on the card."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                            torch.arange(w, dtype=torch.float32, device="cuda"), indexing="ij")
    a, s = math.radians(MOTION["degrees"]), MOTION["scale"]
    dx, dy = xs - (w - 1) / 2, ys - (h - 1) / 2
    fx = s * (math.cos(a) * dx - math.sin(a) * dy) - dx + MOTION["shift"][0]
    fy = s * (math.sin(a) * dx + math.cos(a) * dy) - dy + MOTION["shift"][1]
    if split:
        fy = fy + MOTION["split_px"] * (ys / h > xs / w)
    return torch.stack([fx, fy], dim=-1)


def window_inputs(shape, p, kind, scale, far, seed=0):
    """Seeded q, f, flow, bias on the card. The flow is iid noise of sigma
    ``scale`` ("iid"), or MOTION ("smooth", "split") plus such noise; with
    ``far``, one window of each image lies far outside it on each side."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, f = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    flow = torch.randn((*shape[:3], 2), generator=gen, device="cuda") * scale
    if kind != "iid":
        flow += motion_flow(*shape[1:3], split=kind == "split")
    if far:
        flow[:, 0, 0] = -500.0
        flow[:, -1, -1] = 1e6
    return q, f, flow, torch.randn(p * p, generator=gen, device="cuda")


def window_taps(flow: torch.Tensor, p: int):
    """In-image taps of each pixel's (P+3)^2 window (the kernel's clamp and
    floor): (their total, the share of pixels whose window touches the
    image)."""
    from ufm_torch.ops.window_refinement import base_grid

    _, h, w, _ = flow.shape
    r, m = (p - 1) // 2, (p - 1) // 2 + 4
    pos = flow.float() + base_grid(h, w, flow.device)
    x0 = pos[..., 0].clamp(-m, w + m).floor()
    y0 = pos[..., 1].clamp(-m, h + m).floor()
    nx = ((x0 + r + 2).clamp(max=w - 1) - (x0 - r - 1).clamp(min=0) + 1).clamp(min=0)
    ny = ((y0 + r + 2).clamp(max=h - 1) - (y0 - r - 1).clamp(min=0) + 1).clamp(min=0)
    taps = nx * ny
    return taps.sum().item(), (taps > 0).float().mean().item()


def window_bound_ms(shape, p, in_image_taps):
    """Bytes: q, f, flow read once, residual and log_softmax written once.
    Operations: 2C per in-image tap (the taps outside the image are zeros the
    kernel never reads), the cubic x pass (K rows x P x 4 FMA) and y pass
    (P x P x 4 FMA), and ~10 per score for temperature, bias, softmax,
    log_softmax and the residual."""
    b, h, w, c = shape
    n, k = b * h * w, p + 3
    nbytes = 4 * (n * (2 * c + 2 + 2 + p * p) + p * p)
    flops = 2 * c * in_image_taps + n * (8 * k * p + 8 * p * p + 10 * p * p)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_window_kernel():
    from ufm_torch.ops import window_refinement as wr

    rows = {}
    for name, shape, p, kind, scale, calls in WINDOW_CASES:
        q, f, flow, bias = window_inputs(shape, p, kind, scale, far=name.startswith("edges"))
        counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        res, ls = wr.window_refinement(q, f, flow, bias, WINDOW_TEMPERATURE, p, staged_count=counter)
        ref_res, ref_ls = wr.window_refinement_reference(q, f, flow, bias, WINDOW_TEMPERATURE, p)
        torch.cuda.synchronize()
        res_err = (res - ref_res).abs().max().item()
        ls_err = (ls - ref_ls).abs().max().item()
        taps, share = window_taps(flow, p)
        staged, tiles = wr.staged_tiles(flow, p, shape[-1]), wr.tile_count(*shape[:3])
        check(_finite(res) and _finite(ls), f"window {name}: kernel output not finite")
        check(res_err <= WINDOW_RESIDUAL_ATOL, f"window {name}: residual error {res_err:.3e} > {WINDOW_RESIDUAL_ATOL}")
        check(ls_err <= WINDOW_LOG_SOFTMAX_ATOL, f"window {name}: log_softmax error {ls_err:.3e} > {WINDOW_LOG_SOFTMAX_ATOL}")
        check(counter.item() == staged, f"window {name}: the kernel staged {counter.item()} tiles, staged_tiles {staged}")
        if name in ("flagship", "flagship_smooth", "flagship_split"):
            check(share > 0.5, f"window {name}: only {share:.3f} of the windows touch the image")
        if name == "flagship_smooth":
            check(staged >= SMOOTH_STAGED_SHARE_MIN * tiles, f"window {name}: {staged} of {tiles} tiles staged")
        if name == "flagship_split":
            check(0 < staged < tiles, f"window {name}: {staged} of {tiles} tiles staged, expected both paths")
        if name == "smooth_c12_p9":
            check(0.5 * tiles < staged < tiles, f"window {name}: {staged} of {tiles} tiles staged, expected both paths")

        ms = time_ms(lambda: wr.window_refinement(q, f, flow, bias, WINDOW_TEMPERATURE, p))
        plain_ms = time_ms(lambda: wr.window_refinement_reference(q, f, flow, bias, WINDOW_TEMPERATURE, p), reps=3, batches=5)
        bound_ms, bound_by = window_bound_ms(shape, p, taps)
        rows[name] = dict(
            shape=list(shape), p=p, flow=kind, flow_scale=scale, calls_per_forward=calls, residual_max_abs_err=res_err,
            log_softmax_max_abs_err=ls_err, in_image_share=share, in_image_taps=taps, tiles=tiles,
            staged_tiles=staged, staged_tile_share=staged / tiles, ms=ms, plain_ms=plain_ms,
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        )
        if shape[-1] in (4, 8, 16) and p <= 5 and name.startswith("flagship"):
            # the any-C / any-P kernel on the fixed instance's shape: the same bars
            any_counter = torch.zeros(1, dtype=torch.int32, device="cuda")
            a_res, a_ls = wr.launch(q, f, flow, bias, WINDOW_TEMPERATURE, p, any_counter, any_kernel=True)
            torch.cuda.synchronize()
            a_errs = ((a_res - ref_res).abs().max().item(), (a_ls - ref_ls).abs().max().item())
            check(a_errs[0] <= WINDOW_RESIDUAL_ATOL and a_errs[1] <= WINDOW_LOG_SOFTMAX_ATOL,
                  f"window {name}, any-C / any-P kernel: residual / log_softmax errors {a_errs}")
            check(any_counter.item() == staged, f"window {name}, any-C / any-P kernel: staged {any_counter.item()} "
                  f"tiles, staged_tiles {staged}")
            any_ms = time_ms(lambda: wr.launch(q, f, flow, bias, WINDOW_TEMPERATURE, p, any_kernel=True))
            rows[name].update(any_kernel_ms=any_ms, any_kernel_vs_fixed=any_ms / ms, any_kernel_max_abs_err=a_errs)
        emit("kernel", kernel="window_refinement_fwd", case=name, **rows[name])
    # the host's cost per launch, at one tile (the kernel is shorter than its launch)
    q, f, flow, bias = window_inputs(WINDOW_HOST_SHAPE, 5, "iid", 6.0, far=False)
    host_us = host_us_per_launch(lambda: wr.window_refinement(q, f, flow, bias, WINDOW_TEMPERATURE, 5))
    emit("kernel", kernel="window_refinement_fwd", case="host", shape=list(WINDOW_HOST_SHAPE), host_us_per_launch=host_us)
    return rows, host_us


def window_bwd_bound_ms(shape, p, in_image_taps):
    """Bytes: q, f, flow, log_softmax and the two cotangents read once; dq,
    df, dflow and dbias written once. Operations: per in-image tap the dot,
    the dq and df updates (6C) and the dflow sums (4), and the x pass of the
    three tap gradients (24); per pixel the y pass of two score gradients
    (K rows x P x 4 FMA each) and ~10 per score for g_s."""
    b, h, w, c = shape
    n, k, pp = b * h * w, p + 3, p * p
    nbytes = 4 * (n * (2 * c + 2 + 2 + 2 * pp + 2 * c + 2) + pp)
    flops = (6 * c + 28) * in_image_taps + n * (16 * k * p + 10 * pp)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_window_bwd_kernel():
    """The window backward kernel against the plain backward in fp64 on the
    same inputs (q, f, flow, bias, the forward kernel's log_softmax and
    seeded cotangents) at WINDOW_BWD_CASES: each of dq, df, dflow and dbias
    within max(2x the plain fp32 backward's own error, WINDOW_BWD_FLOOR_REL
    of its largest element); dq, dflow and dbias the same bits over two
    calls (df's difference reported); the tiles the kernel staged (its
    counter) equal to staged_tiles, all but a few of a smooth flow's at C =
    16 and none of an iid flow's. Timed: the kernel, the plain backward, and
    the earlier route of the op's gradient (autograd over the plain
    forward)."""
    from ufm_torch.ops import library
    from ufm_torch.ops import window_refinement as wr

    rows = {}
    names = ("dq", "df", "dflow", "dbias")
    for name, shape, p, kind, scale, calls in WINDOW_BWD_CASES:
        q, f, flow, bias = window_inputs(shape, p, kind, scale, far=name.startswith("edges"), seed=1)
        _, ls = wr.window_refinement(q, f, flow, bias, WINDOW_TEMPERATURE, p)
        gen = torch.Generator(device="cuda").manual_seed(2)
        g_res = torch.randn((*shape[:3], 2), generator=gen, device="cuda")
        g_ls = torch.randn((*shape[:3], p, p), generator=gen, device="cuda")
        args = (q, f, flow, bias, ls, g_res, g_ls)
        before = wr.BWD_LAUNCHES
        got = library.window_refinement_bwd(*args, WINDOW_TEMPERATURE, p)
        again = library.window_refinement_bwd(*args, WINDOW_TEMPERATURE, p)
        counter = torch.zeros(1, dtype=torch.int32, device="cuda")
        counted = wr.launch_backward(*args, WINDOW_TEMPERATURE, p, staged_count=counter)
        torch.cuda.synchronize()
        check(wr.BWD_LAUNCHES == before + 3, f"window bwd {name}: {wr.BWD_LAUNCHES - before} launches for 3 calls")
        staged, tiles = wr.staged_tiles(flow, p, shape[-1]), wr.tile_count(*shape[:3])
        check(counter.item() == staged, f"window bwd {name}: the kernel staged {counter.item()} tiles, staged_tiles {staged}")
        if name == "train_smooth":
            check(staged >= SMOOTH_STAGED_SHARE_MIN * tiles, f"window bwd {name}: {staged} of {tiles} tiles staged")
        if name == "train":
            check(staged == 0, f"window bwd {name}: {staged} of {tiles} tiles of an iid flow staged")
        plain = wr.window_refinement_backward_reference(*args, WINDOW_TEMPERATURE, p)
        ref = wr.window_refinement_backward_reference(*(t.double() for t in args), WINDOW_TEMPERATURE, p)
        errs, plain_errs, bars = {}, {}, {}
        for g_name, k, pl, r in zip(names, got, plain, ref):
            check(_finite(k), f"window bwd {name}: {g_name} not finite")
            errs[g_name] = (k.double() - r).abs().max().item()
            plain_errs[g_name] = (pl.double() - r).abs().max().item()
            bars[g_name] = max(2 * plain_errs[g_name], WINDOW_BWD_FLOOR_REL * r.abs().max().item())
        repeat = {g: torch.equal(a, b) and torch.equal(a, k) for g, a, b, k in zip(names, got, again, counted)}
        df_spread = max((got[1] - again[1]).abs().max().item(), (got[1] - counted[1]).abs().max().item())
        taps, share = window_taps(flow, p)

        ms = time_ms(lambda: library.window_refinement_bwd(*args, WINDOW_TEMPERATURE, p))
        plain_ms = time_ms(lambda: wr.window_refinement_backward_reference(*args, WINDOW_TEMPERATURE, p),
                           reps=2, batches=3)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, f, flow, bias)]

        def parent_route():  # the parent's backward: autograd over the plain forward
            outs = wr.window_refinement_reference(*leaves, WINDOW_TEMPERATURE, p)
            return torch.autograd.grad(outs, leaves, (g_res, g_ls))

        parent_ms = time_ms(parent_route, reps=2, batches=3)
        bound_ms, bound_by = window_bwd_bound_ms(shape, p, taps)
        rows[name] = dict(
            shape=list(shape), p=p, flow=kind, flow_scale=scale, calls_per_step=calls, max_abs_err=errs,
            plain_max_abs_err=plain_errs, tol=bars, bitwise_repeatable=repeat, df_run_to_run_max_abs_diff=df_spread,
            in_image_share=share, in_image_taps=taps, tiles=tiles, staged_tiles=staged,
            staged_tile_share=staged / tiles, ms=ms, plain_ms=plain_ms, parent_route_ms=parent_ms,
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        )
        emit("kernel", kernel="window_refinement_bwd", case=name, **rows[name])
        for g_name in names:
            check(errs[g_name] <= bars[g_name],
                  f"window bwd {name}: {g_name} error {errs[g_name]:.3e} > {bars[g_name]:.3e}")
        check(repeat["dq"] and repeat["dflow"] and repeat["dbias"],
              f"window bwd {name}: dq / dflow / dbias not bitwise repeatable: {repeat}")
        del args, got, again, counted, plain, ref, leaves
    return rows


def _timed(fn, events):
    """``fn`` with a CUDA event pair recorded around each call (device time
    between the two points, waits for the host included)."""

    def wrapper(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        events.append((start, end, args))
        return out

    return wrapper


def phase_refine_path():
    from ufm_torch.models import UniFlowMatchClassificationRefinement, ufm_refine_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.ops import window_refinement as wr

    t0 = time.perf_counter()
    model = UniFlowMatchClassificationRefinement.from_config(ufm_refine_config(), seed=0)
    # eager: the stage breakdown's CUDA events sit around Python calls that a
    # graph replay does not make (``captured`` runs this model captured)
    model.capture_graphs = False
    torch.cuda.synchronize()
    emit("refine_model", seconds=time.perf_counter() - t0, params=sum(p.numel() for p in model.parameters()),
         device=str(model.device), compute_dtype=model.config.compute_dtype)
    forward_events, tail_events = [], []
    model.network_apply = _timed(model.network_apply, forward_events)
    model.net.refine_tail = _timed(model.net.refine_tail, tail_events)

    rng = np.random.default_rng(1)
    requests = (
        ("refine_480x640_b1", rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)),
        ("refine_480x640_b2", rng.integers(0, 256, (2, 2, 480, 640, 3), dtype=np.uint8)),
    )
    p = model.config.refinement_range
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = wr.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # the refine path's counts start here
    results, latencies = {}, {}
    for name, pair in requests:
        src, tgt = pair[0], pair[1]
        b = src.shape[0] if src.ndim == 4 else 1
        h, w = src.shape[-3], src.shape[-2]
        times = []
        forward_events.clear()
        tail_events.clear()
        for _ in range(4):  # one warm-up, three timed
            before = (fa.LAUNCHES, wr.LAUNCHES, ge.LAUNCHES, lg.LAUNCHES)
            t = time.perf_counter()
            res = model.predict_correspondences_batched(source_image=src, target_image=tgt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launched = (fa.LAUNCHES - before[0], wr.LAUNCHES - before[1], ge.LAUNCHES - before[2],
                        lg.LAUNCHES - before[3])
            check(launched == (LAUNCHES_PER_FORWARD, 1, 0, GELU_PER_FORWARD),
                  f"{name}: {launched} attention / window / GELU / fused fc1 + GELU launches in one forward, "
                  f"expected ({LAUNCHES_PER_FORWARD}, 1, 0, {GELU_PER_FORWARD})")
        flow, covis = res.flow.flow_output, res.covisibility.mask
        check(tuple(flow.shape) == (b, 2, h, w), f"{name}: flow shape {tuple(flow.shape)}")
        check(tuple(covis.shape) == (b, h, w), f"{name}: covisibility shape {tuple(covis.shape)}")
        check(_finite(flow) and _finite(covis) and _finite(res.flow.flow_covariance), f"{name}: non-finite outputs")
        latencies[name] = statistics.median(times[1:])
        results[name] = res
        fwd_ms = statistics.median(s.elapsed_time(e) for s, e, _ in forward_events[1:])
        tail_ms = statistics.median(s.elapsed_time(e) for s, e, _ in tail_events[1:])
        regression_flow = tail_events[-1][2][2]
        _, share = window_taps(regression_flow, p)
        staged_share = wr.staged_tiles(regression_flow, p) / wr.tile_count(*regression_flow.shape[:3])
        emit("refine_request", request=name, batch=b, input_hw=[h, w], first_s=times[0], latency_s=latencies[name],
             pairs_per_s=b / latencies[name], forward_ms=fwd_ms, refine_tail_ms=tail_ms,
             refine_tail_share=tail_ms / fwd_ms, window_in_image_share=share, window_staged_tile_share=staged_share,
             regression_flow_abs_max=regression_flow.abs().max().item(), flow_abs_mean=flow.abs().mean().item())
    launches = {"flash_attention_fwd": fa.LAUNCHES, "window_refinement_fwd": wr.LAUNCHES}
    mlp_path("ufm_refine", mlp_counts(ge, lg), 4 * len(requests) * GELU_PER_FORWARD)
    emit("refine_path", launches=launches, forwards=4 * len(requests),
         pairs_per_s_b1=1.0 / latencies["refine_480x640_b1"], max_memory_allocated=torch.cuda.max_memory_allocated())
    del model.network_apply, model.net.refine_tail  # back to the unwrapped methods
    return model, requests[0][1], results["refine_480x640_b1"], launches


def phase_refine_self_check(model, pair, kernel_res):
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import window_refinement as wr

    def run():
        res = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
        torch.cuda.synchronize()
        return res.flow.flow_output.float()

    f_k = kernel_res.flow.flow_output.float()
    model.refinement_impl = "torch"
    wr.LAUNCHES = 0
    f_plain_window = run()
    check(wr.LAUNCHES == 0, "the plain-refinement run launched the window kernel")
    model.refinement_impl = None
    window_diff = (f_k - f_plain_window).abs().max().item()

    model.attention_impl = "torch"
    fa.LAUNCHES = 0
    f_plain_attn = run()
    check(fa.LAUNCHES == 0, "the plain-attention run launched the attention kernel")
    model.attention_impl = None
    rel = ((f_k - f_plain_attn).norm() / f_plain_attn.norm()).item()
    emit("refine_self_check", window_flow_max_abs_diff=window_diff, window_bound=REFINED_FLOW_MAX_ABS,
         attention_flow_rel_l2=rel, attention_bound=FLOW_REL_L2_BOUND)
    check(window_diff <= REFINED_FLOW_MAX_ABS,
          f"window kernel vs plain refinement: refined flow max abs diff {window_diff:.3e} > {REFINED_FLOW_MAX_ABS}")
    check(rel <= FLOW_REL_L2_BOUND, f"kernel vs plain attention (refine): flow relative L2 {rel:.3e} > {FLOW_REL_L2_BOUND}")


def _group_grads(net):
    from ufm_torch.training.trainer import group_of

    out = {}
    for name, p in net.named_parameters():
        if p.grad is not None:
            out.setdefault(group_of(name), []).append(p.grad.float().flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def phase_train():
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch

    t0 = time.perf_counter()
    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
    net = model.net
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    optimizer = make_optimizer(net, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS)
    step = make_train_step(net, optimizer)
    masters = optimizer.masters()
    torch.cuda.synchronize()
    emit("train_model", seconds=time.perf_counter() - t0, params=sum(p.numel() for p in net.parameters()),
         bf16_params=sum(p.numel() for p in net.parameters() if p.dtype == torch.bfloat16),
         fp32_masters=sum(m.numel() for m in masters.values()),
         groups={label: sum(p.numel() for p, _ in pairs) for label, _, pairs in optimizer.groups})

    fwd_events, opt_events = [], []
    net.forward = _timed(net.forward, fwd_events)
    optimizer.step = _timed(optimizer.step, opt_events)
    torch.cuda.reset_peak_memory_stats()
    # the training path's counts start here
    fa.LAUNCHES = fa.BWD_LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0
    fa.ANY_LAUNCHES = fa.ANY_BWD_LAUNCHES = 0
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        before = (fa.LAUNCHES, fa.BWD_LAUNCHES, ge.LAUNCHES, lg.LAUNCHES, ge.BWD_LAUNCHES, lg.BWD_LAUNCHES)
        t = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launched = (fa.LAUNCHES - before[0], fa.BWD_LAUNCHES - before[1], ge.LAUNCHES - before[2],
                    lg.LAUNCHES - before[3], ge.BWD_LAUNCHES - before[4], lg.BWD_LAUNCHES - before[5])
        check(launched == (LAUNCHES_PER_FORWARD, LAUNCHES_PER_FORWARD, 0, GELU_PER_FORWARD, 0, GELU_PER_FORWARD),
              f"train step {i}: {launched} attention forward launches / backward calls / GELU / fused fc1 + GELU "
              "/ GELU gradient / fused fc2 + GELU gradient launches, expected 36 / 36 / 0 / 36 / 0 / 36")
        check((fa.ANY_LAUNCHES, fa.ANY_BWD_LAUNCHES) == (0, 0),
              f"bf16 train step {i}: mma attention launches ({fa.ANY_LAUNCHES}, {fa.ANY_BWD_LAUNCHES})")
        vals = {k: v.item() for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"train step {i}: non-finite metrics {vals}")
        losses.append(vals["total_loss"])
        emit("train_step", step=i, seconds=times[-1], **vals)
    del net.forward, optimizer.step  # back to the unwrapped methods
    fwd_ms = [s.elapsed_time(e) for s, e, _ in fwd_events]
    bwd_ms = [fe.elapsed_time(os_) for (_, fe, _), (os_, _, _) in zip(fwd_events, opt_events)]
    opt_ms = [s.elapsed_time(e) for s, e, _ in opt_events]
    step_s = statistics.median(times[1:])

    fit_losses = []
    out = fit(net, (batch for _ in range(FIT_STEPS)), num_steps=FIT_STEPS, learning_rate=FIT_LR,
              warmup_steps=0, log_every=1, log_fn=lambda line: None,
              on_metrics=lambda _, vals: fit_losses.append(vals["total_loss"]))
    torch.cuda.synchronize()
    check(out["step"] == FIT_STEPS and len(fit_losses) == FIT_STEPS, f"fit ran {out['step']} steps")
    check(all(np.isfinite(v) for v in fit_losses), f"fit: non-finite losses {fit_losses}")
    launches = {"flash_attention_fwd": fa.LAUNCHES, "flash_attention_bwd": fa.BWD_LAUNCHES}
    steps = TRAIN_STEPS + FIT_STEPS
    check((fa.ANY_LAUNCHES, fa.ANY_BWD_LAUNCHES) == (0, 0), "the bf16 fit launched an mma attention kernel")
    check(launches == {"flash_attention_fwd": steps * LAUNCHES_PER_FORWARD, "flash_attention_bwd": steps * LAUNCHES_PER_FORWARD},
          f"training path launches {launches} over {steps} steps, expected 36 + 36 per step")
    mlp_path("ufm_base_train", mlp_counts(ge, lg), steps * GELU_PER_FORWARD, fused_backward=steps * GELU_PER_FORWARD)
    trajectory = losses + fit_losses
    check(trajectory[-1] < trajectory[0], f"loss did not fall on the fixed batch: {trajectory}")
    emit("train_path", batch=TRAIN_BATCH, input_hw=list(TRAIN_HW), learning_rate=TRAIN_LR,
         warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS, fit_learning_rate=FIT_LR, steps=steps,
         launches=launches, mma_launches=[fa.ANY_LAUNCHES, fa.ANY_BWD_LAUNCHES],
         first_step_s=times[0], step_ms=step_s * 1e3, pairs_per_s=TRAIN_BATCH / step_s,
         forward_loss_ms=statistics.median(fwd_ms[1:]), backward_ms=statistics.median(bwd_ms[1:]),
         optimizer_ms=statistics.median(opt_ms[1:]), max_memory_allocated=torch.cuda.max_memory_allocated(),
         loss_trajectory=trajectory)
    return model, batch, launches


def phase_train_self_check(model, batch):
    one = {k: v[:1] for k, v in batch.items()}
    _kernel_vs_plain_grads(model, one, "train_self_check", BF16_TRAIN_EACH, TRAIN_GRAD_REL_L2_BOUND)


# a bf16 UFM-Base (or UniFlowMatch) train step: 36 attention forward launches
# and backward calls, 36 fused fc1 + GELU launches (each writing the
# pre-activation) and 36 launches of fc2's input gradient with the GELU
# gradient as its epilogue
BF16_TRAIN_EACH = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, flash_attention_bwd=LAUNCHES_PER_FORWARD,
                                linear_gelu_bf16_fwd=GELU_PER_FORWARD, linear_gelu_bf16_bwd=GELU_PER_FORWARD)
# UFM-Refine training (refine_train): TRAIN_BATCH at TRAIN_HW, TRAIN_STEPS of
# make_train_step, then FIT_STEPS of fit, as train: each step the launches
# of a bf16 UFM-Base step and one launch each of the window forward and
# backward
REFINE_TRAIN_EACH = {**BF16_TRAIN_EACH, WINDOW_AT: 1, WINDOW_BWD_AT: 1}
# the kernels of the window backward at a width that stages (C <= 16, C % 4
# == 0), by the name of their __global__ function: the direct kernel, the
# staged kernel, the dbias sum
WINDOW_BWD_KERNEL_NAMES = ("window_refinement_bwd_kernel", "window_refinement_bwd_staged_kernel",
                           "window_refinement_bias_kernel")
# UFM-Refine in fp32: each train step 36 mma attention forward launches and
# backward calls, one window forward and one window backward launch
REFINE_FP32_TRAIN_EACH = launch_counts(window_refinement_fwd=1, flash_attention_fwd_any=ANY_PER_FORWARD,
                                       flash_attention_bwd_any=ANY_BWD_PER_STEP, window_refinement_bwd=1)
# UniFlowMatch (no uncertainty head): the metrics of the JAX package's
# ufm_total_loss for its outputs (tests/test_torch_port_paths.py holds the
# port's names to JAX's)
FLOW_ONLY_METRICS = ("flow_loss", "epe", "total_loss")
# UFM-Refine under remat (refine_remat): no remat, then the two policies of
# REMAT_CASES that recompute the attention forward and that keep it
REFINE_REMAT_CASES = tuple(c for c in REMAT_CASES if c[0] in ("none", "nothing_saveable", "attn_out"))
# the seeds of refine_train_self_check's batch-1 synthetic batches
REFINE_SELF_CHECK_SEEDS = (0, 1, 2)
# the widened UFM-Refine (wide_refine_config): window P and feature width C
# (the shape of chip_smoke's smooth_c12_p9 window cases)
WIDE_WINDOW = (9, 12)


@contextlib.contextmanager
def _plain_calls():
    """Count calls of the plain versions of the attention (forward and
    backward) and of the window refinement (forward and backward) while the
    block runs, in any thread: a dict {"attention": n, "window": n}. The
    models reach the plain forwards through ops.attention's and
    ops.refinement's own names for them."""
    from ufm_torch.ops import attention as at
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import refinement as rf
    from ufm_torch.ops import window_refinement as wr

    calls = {"attention": 0, "window": 0}
    patched = [("attention", fa, "attention_reference"), ("attention", at, "attention_reference"),
               ("attention", fa, "attention_backward_reference"), ("window", wr, "window_refinement_reference"),
               ("window", rf, "window_refinement_reference"), ("window", wr, "window_refinement_backward_reference")]
    saved = [getattr(m, name) for _, m, name in patched]

    def counting(kind, fn):
        def wrapper(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return wrapper

    for (kind, m, name), fn in zip(patched, saved):
        setattr(m, name, counting(kind, fn))
    try:
        yield calls
    finally:
        for (_, m, name), fn in zip(patched, saved):
            setattr(m, name, fn)


def _device_ms(fn, names):
    """Run ``fn`` once inside a ``torch.profiler`` window (CUDA activity):
    its host ms, the device busy ms (the union of the kernels' intervals),
    and the device ms of the kernels whose names contain one of ``names``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, named_us, named = [], 0.0, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.name.startswith(("Memcpy", "Memset")):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        if any(n in evt.name for n in names):
            named_us += evt.time_range.end - evt.time_range.start
            named += 1
    check(bool(spans), "the profiler recorded no kernel")
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3, "idle_share": 1 - busy_us / 1e3 / wall_ms,
            "named_ms": named_us / 1e3, "named_kernels": named}


def phase_model_train(cls=None, config=None, label="refine_train", path="ufm_refine_train", each=None,
                      metric_names=None, falls_through_fit=True):
    """A model (``cls``, UFM-Refine by default) on ``config``
    (``ufm_refine_config()`` by default: the UNet and the patch MLP, bf16
    backbone, 5 x 5 window at C = 16) trains at TRAIN_BATCH on TRAIN_HW:
    TRAIN_STEPS of make_train_step, then FIT_STEPS of fit, each step's
    launches held to ``each`` (REFINE_TRAIN_EACH by default), no call of the
    plain attention or window refinement, finite metrics (named
    ``metric_names`` where given; a refine model's include the refinement
    loss), a loss that falls from the first step to the last (to the last of
    make_train_step's without ``falls_through_fit``: fit's fresh optimizer
    may take a first step up); the spans, step ms, pairs/s, peak memory, one more
    step under the profiler (its busy ms and idle share; for UFM-Refine the
    window backward's kernel ms within it, and the staged-tile share of the
    model's own regression flow in that step). ``path`` names the path in
    the kernels' launch counts."""
    from ufm_torch.models import UniFlowMatchClassificationRefinement, ufm_refine_config
    from ufm_torch.ops import launches as counters
    from ufm_torch.ops import window_refinement as wr
    from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch

    each = each or REFINE_TRAIN_EACH
    t0 = time.perf_counter()
    model = (cls or UniFlowMatchClassificationRefinement).from_config(config or ufm_refine_config(), seed=0)
    net = model.net
    refine = model.config.has_classification_head
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    optimizer = make_optimizer(net, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS)
    step = make_train_step(net, optimizer)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    window = {}
    if refine:
        window = {"window_p": model.config.refinement_range,
                  "window_c": model.config.classification_head_kwargs["output_dim"]}
    losses, refine_losses, times = [], [], []

    def run():
        for i in range(TRAIN_STEPS):
            before = counters.snapshot()
            t = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launched = counters.since(before)
            check(launched == each, f"{label} step {i}: launches {launched}, expected {each}")
            vals = {k: v.item() for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in vals.values()) and ("refinement_loss" in vals) == refine,
                  f"{label} step {i}: metrics {vals}")
            check(metric_names is None or set(vals) == set(metric_names),
                  f"{label} step {i}: metric names {sorted(vals)}, expected {sorted(metric_names or ())}")
            losses.append(vals["total_loss"])
            if refine:
                refine_losses.append(vals["refinement_loss"])
            emit(f"{label}_step", step=i, seconds=times[-1], **vals)

    torch.cuda.reset_peak_memory_stats()
    counters.reset()  # this training path's counts start here
    with _plain_calls() as plain_calls:
        spans = _span_ms(net, optimizer, run)
        peak = torch.cuda.max_memory_allocated()
        fit_losses = []
        before = counters.snapshot()
        out = fit(net, (batch for _ in range(FIT_STEPS)), num_steps=FIT_STEPS, learning_rate=FIT_LR,
                  warmup_steps=0, log_every=1, log_fn=lambda line: None,
                  on_metrics=lambda _, vals: fit_losses.append(vals["total_loss"]))
        torch.cuda.synchronize()
        fit_launched = counters.since(before)
        launched = counters.snapshot()
        tail_events = []
        if refine:
            net.refine_tail = _timed(net.refine_tail, tail_events)  # its third argument is the regression flow
        profiled = _device_ms(lambda: step(batch), WINDOW_BWD_KERNEL_NAMES if refine else ())
        if refine:
            del net.refine_tail  # back to the method
    if refine:
        regression_flow = tail_events[-1][2][2].detach()
        window["window_staged_tile_share_in_step"] = wr.staged_tiles(
            regression_flow, window["window_p"], window["window_c"]) / wr.tile_count(*regression_flow.shape[:3])
        window["window_bwd_kernel_ms_in_step"] = profiled["named_ms"]
        # the window backward's kernels, one each (at C <= 16, C % 4 == 0)
        check(profiled["named_kernels"] == len(WINDOW_BWD_KERNEL_NAMES),
              f"the profiled step ran {profiled['named_kernels']} window backward kernels, expected "
              f"{len(WINDOW_BWD_KERNEL_NAMES)}")
    check(out["step"] == FIT_STEPS and len(fit_losses) == FIT_STEPS, f"{label} fit ran {out['step']} steps")
    check(all(np.isfinite(v) for v in fit_losses), f"{label} fit: non-finite losses {fit_losses}")
    check(fit_launched == {k: FIT_STEPS * n for k, n in each.items()},
          f"{label} fit: launches {fit_launched} over {FIT_STEPS} steps")
    check(plain_calls == {"attention": 0, "window": 0}, f"{label} called plain versions: {plain_calls}")
    trajectory = losses + fit_losses
    falling = trajectory if falls_through_fit else losses
    check(falling[-1] < falling[0], f"{label}: the loss did not fall on the fixed batch: {trajectory}")
    steps = TRAIN_STEPS + FIT_STEPS
    record_steps(path, launched, each, steps)
    launches = launched
    step_s = statistics.median(times[1:])
    emit(label, model=type(model).__name__, compute_dtype=model.config.compute_dtype, batch=TRAIN_BATCH,
         input_hw=list(TRAIN_HW), setup_s=setup_s, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
         fit_learning_rate=FIT_LR, steps=steps, launches=launches, launches_per_step=each,
         plain_calls=plain_calls, first_step_s=times[0], step_ms=step_s * 1e3, pairs_per_s=TRAIN_BATCH / step_s,
         spans_ms=spans, max_memory_allocated=peak, loss_trajectory=trajectory,
         refinement_loss_trajectory=refine_losses, profiled_step_ms=profiled["wall_ms"],
         profiled_step_device_busy_ms=profiled["device_busy_ms"], profiled_step_idle_share=profiled["idle_share"],
         **window)
    del out, step, optimizer
    _free_card_memory()
    return model, batch, launches


@contextlib.contextmanager
def _wide_plain_attention(dtype=torch.float32):
    """While the block runs, the plain attention (impl ``"torch"``) computes
    in ``dtype``: q, k and v upcast, the output cast back to their dtype."""
    from ufm_torch.ops import attention as at

    plain = at.attention_reference
    at.attention_reference = lambda q, k, v, scale: plain(q.to(dtype), k.to(dtype), v.to(dtype), scale).to(q.dtype)
    try:
        yield
    finally:
        at.attention_reference = plain


def _refine_classes(regression_flow, gt_flow, p):
    """Each pixel's target class in ``refinement_classification_loss`` for
    this regression flow: the rounded offset to the ground truth, -1 where
    the offset lies outside the P x P window (no supervision)."""
    r = (p - 1) // 2
    off = gt_flow - regression_flow
    jx, iy = ((torch.round(off[..., i]) + r).clamp(0, p - 1) for i in (0, 1))
    inside = (off[..., 0].abs() <= r + 0.5) & (off[..., 1].abs() <= r + 0.5)
    return torch.where(inside, iy * p + jx, -1)


def phase_refine_train_self_check(model, label="refine_train_self_check", against_plain_step=True,
                                  train_each=None, bound=TRAIN_GRAD_REL_L2_BOUND):
    """Each optimizer group's gradient of one step at batch 1, on the
    synthetic batch of each of REFINE_SELF_CHECK_SEEDS with its own ground
    truth, four ways: through every kernel (REFINE_TRAIN_EACH launches, the
    backward ones twice: see below); with the plain window refinement (the
    attention kernels kept: the window kernels' own part); with plain
    attention and the plain window refinement (the plain step: bf16 logits,
    as the JAX package's plain attention, for a bf16 model); and the plain
    step with its attention in a wider type (q, k, v upcast: fp32 for a bf16
    model, fp64 for an fp32 one), the witness. Without
    ``against_plain_step`` only the first two.

    The refinement loss's target class is the rounded offset from a step's
    own regression flow to the ground truth, a step function: between two
    roundings of the step 0.2% of pixels change class, which alone moves the
    classification head's gradient ~0.1 (measured on an H100, PERF.md). So
    each step's gradient is taken of the same loss with the classes fixed:
    ``ufm_total_loss(out, one, weights={"refinement": 0.0})[0] +
    refinement_classification_loss(out["refinement_log_softmax"],
    fixed_flow, one["gt_flow"], one.get("valid"))``, where fixed_flow is the
    witness's regression flow (without ``against_plain_step``, the kernel
    step's), detached as the loss detaches its own. Held, each group, with
    the classes fixed: the kernel step within ``bound`` of the plain-window
    step and of the plain step. ``train_each``: a train step's launches
    (REFINE_TRAIN_EACH by default). Reported: the same readings of the loss
    as it is (each step's own classes), the plain step's distance from the
    witness, the share of pixels whose class differs between two steps' own
    regression flows, and the share of flow components whose whole pixel
    (where the window's bilinear taps have a kink) does."""
    from ufm_torch.ops import launches
    from ufm_torch.training import refinement_classification_loss, synthetic_batch, ufm_total_loss

    p = model.config.refinement_range
    net = model.net
    wide = torch.float64 if model.config.compute_dtype == "float32" else torch.float32
    # one forward, two backward passes (the loss with fixed classes, then as it is)
    each = {k: n * (2 if k in (BWD_AT, ANY_BWD_AT, WINDOW_BWD_AT, GELU_BWD_AT, FUSED_BWD_AT) else 1)
            for k, n in (train_each or REFINE_TRAIN_EACH).items()}

    def grads(attention, window, step_label, fixed_flow):
        """The groups' gradients of one step on ``one`` with the classes of
        ``fixed_flow`` (None: the step's own), and of the loss as it is; and
        the step's own target classes and regression flow."""
        model.attention_impl, model.refinement_impl = attention, window
        try:
            before = launches.snapshot()
            net.zero_grad(set_to_none=True)
            out = net(one["img1"], one["img2"])
            own_flow = out["regression_flow"].detach()
            fixed = ufm_total_loss(out, one, weights={"refinement": 0.0})[0] + refinement_classification_loss(
                out["refinement_log_softmax"], own_flow if fixed_flow is None else fixed_flow, one["gt_flow"],
                one.get("valid"))
            fixed.backward(retain_graph=True)
            g_fixed = _group_grads(net)
            net.zero_grad(set_to_none=True)
            ufm_total_loss(out, one)[0].backward()
            torch.cuda.synchronize()
            launched = launches.since(before)
        finally:
            model.attention_impl = model.refinement_impl = None
        g_own = _group_grads(net)
        net.zero_grad(set_to_none=True)
        plain_at = (ATTENTION_AT if attention else ()) + ((WINDOW_AT, WINDOW_BWD_AT) if window else ())
        if attention is None and window is None:
            check(launched == each, f"{label}, {step_label}: launches {launched}, expected {each}")
        check(all(launched[i] == 0 for i in plain_at), f"{label}, {step_label}: launches {launched}")
        return g_fixed, g_own, _refine_classes(own_flow, one["gt_flow"], p), own_flow

    by_seed = {}
    for seed in REFINE_SELF_CHECK_SEEDS:
        one = synthetic_batch(1, *TRAIN_HW, seed=seed, device="cuda")
        if against_plain_step:
            with _wide_plain_attention(wide):
                r_fixed, r_own, c_ref, fixed_flow = grads("torch", "torch", "plain step, wide attention", None)
            k_fixed, k_own, c_kernel, k_flow = grads(None, None, "kernels", fixed_flow)
        else:
            k_fixed, k_own, c_kernel, fixed_flow = grads(None, None, "kernels", None)
        w_fixed, w_own, _, _ = grads(None, "torch", "plain window refinement", fixed_flow)
        row = {"vs_plain_window": _rel_l2(k_fixed, w_fixed), "vs_plain_window_own_classes": _rel_l2(k_own, w_own),
               "supervised_share": (c_kernel >= 0).float().mean().item()}
        if against_plain_step:
            p_fixed, p_own, c_plain, p_flow = grads("torch", "torch", "plain attention and window refinement", fixed_flow)
            check(set(k_fixed) == set(w_fixed) == set(p_fixed) == set(r_fixed), f"{label}: gradient groups differ")
            row.update(
                vs_plain=_rel_l2(k_fixed, p_fixed), vs_plain_own_classes=_rel_l2(k_own, p_own),
                vs_witness=_rel_l2(k_fixed, r_fixed), vs_witness_own_classes=_rel_l2(k_own, r_own),
                plain_vs_witness=_rel_l2(p_fixed, r_fixed), plain_vs_witness_own_classes=_rel_l2(p_own, r_own),
                class_flip_share={"kernel_vs_plain": (c_kernel != c_plain).float().mean().item(),
                                  "plain_vs_witness": (c_plain != c_ref).float().mean().item()},
                whole_pixel_flip_share=(torch.floor(k_flow) != torch.floor(p_flow)).float().mean().item())
            del p_fixed, p_own, r_fixed, r_own
        by_seed[seed] = row
        del k_fixed, k_own, w_fixed, w_own
    held = ("vs_plain_window", "vs_plain") if against_plain_step else ("vs_plain_window",)
    emit(label, batch=1, seeds=list(REFINE_SELF_CHECK_SEEDS), window_p=p, by_seed=by_seed,
         bound=bound, launches=each, held_with_fixed_classes=list(held),
         witness_attention=str(wide).replace("torch.", "") if against_plain_step else None,
         classes_fixed_by="the witness's regression flow" if against_plain_step else "the kernel step's regression flow")
    for seed, row in by_seed.items():
        for name in held:
            for k, r in row[name].items():
                check(r <= bound, f"{label}, seed {seed}, kernels {name.replace('_', ' ')} (fixed "
                      f"classes), group {k}: relative L2 {r:.3e} > {bound}")


def wide_refine_config():
    """UFM-Refine at full width with the widened window: P = 9 and a patch-MLP
    output (the window's feature width) of C = 12 (WIDE_WINDOW), nothing
    else changed."""
    from ufm_torch.models import ufm_refine_config

    p, c = WIDE_WINDOW
    head = dict(ufm_refine_config().classification_head_kwargs, output_dim=c)
    return ufm_refine_config(refinement_range=p, classification_head_kwargs=head)


def phase_wide_refine():
    """The widened UFM-Refine (wide_refine_config: the any-C / any-P window
    forward, window_refinement_fwd_any_kernel, and the window backward at
    C = 12, P = 9) end to end at TRAIN_HW: a batch-1 request through
    predict_correspondences_batched, eager and captured (phase_captured: 36
    attention, 36 fc1 + GELU and 1 window launches a request, the replay's
    kernels seen by the profiler); the batch-2 train steps of
    phase_model_train; the gradient check of phase_refine_train_self_check
    against the plain window refinement with fixed classes. No call of the
    plain attention or window refinement in the first two."""
    from ufm_torch.models import UniFlowMatchClassificationRefinement

    cfg = wide_refine_config()
    t0 = time.perf_counter()
    model = UniFlowMatchClassificationRefinement.from_config(cfg, seed=0)
    p, c = model.config.refinement_range, model.net.classification_head.output_dim
    check((p, c) == WIDE_WINDOW, f"wide refine: window P = {p}, C = {c}, expected {WIDE_WINDOW}")
    emit("wide_refine_model", seconds=time.perf_counter() - t0, params=sum(x.numel() for x in model.parameters()),
         window_p=p, window_c=c)
    pair = tuple(np.random.default_rng(5).integers(0, 256, (2, *TRAIN_HW, 3), dtype=np.uint8))
    with _plain_calls() as plain_calls:
        phase_captured(model, "ufm_refine_wide", pair, (1,), refine=True, window_kernel="window_refinement_fwd_any_kernel")
    check(plain_calls == {"attention": 0, "window": 0}, f"the widened UFM-Refine request called plain versions: {plain_calls}")
    del model
    _free_card_memory()
    train_model, _, _ = phase_model_train(config=cfg, label="wide_refine_train", path="ufm_refine_wide_train")
    phase_refine_train_self_check(train_model, label="wide_refine_train_self_check", against_plain_step=False)
    del train_model
    _free_card_memory()


def _world1_group():
    """A process group of one rank over NCCL on a free localhost port (the
    machine has one card); destroyed by the caller."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)


def _param_snapshot(net):
    """fp32 copies of every parameter on the host (kept off the card so the
    peak-memory readings stay comparable)."""
    return {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in net.named_parameters()}


def _stepped_values(net, optimizer):
    """(name, the whole fp32 tensor the optimizer steps): the master where the
    parameter has one (a bf16 parameter moves by whole bf16 spacings, its
    master by each update), else the parameter."""
    from ufm_torch.parallel.sharding import unshard

    masters = {id(p): m for _, _, pairs in optimizer.groups for p, m in pairs}
    for name, p in net.named_parameters():
        m = masters.get(id(p))
        yield name, unshard((p if m is None else m).detach())


def _group_deltas(named, initial):
    """Per optimizer group: the parameters' change from ``initial``, on the
    host, as one vector."""
    from ufm_torch.training.trainer import group_of

    out = {}
    for name, t in named:
        out.setdefault(group_of(name), []).append((t.float().cpu() - initial[name]).flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def _span_ms(net, optimizer, run):
    """Run ``run()`` with CUDA events around the net's forward and the
    optimizer's step; return the median ms of forward + loss, backward and
    optimizer over its steps after the first."""
    fwd_events, opt_events = [], []
    net.forward = _timed(net.forward, fwd_events)
    optimizer.step = _timed(optimizer.step, opt_events)
    try:
        run()
    finally:
        del net.forward, optimizer.step  # back to the unwrapped methods
    spans = {
        "forward_loss_ms": [s.elapsed_time(e) for s, e, _ in fwd_events],
        "backward_ms": [fe.elapsed_time(os_) for (_, fe, _), (os_, _, _) in zip(fwd_events, opt_events)],
        "optimizer_ms": [s.elapsed_time(e) for s, e, _ in opt_events],
    }
    return {k: statistics.median(v[1:]) for k, v in spans.items()}


def _free_card_memory():
    """Free what earlier phases left: FSDP-wrapped and captured models hold
    reference cycles, which only the cycle collector frees, and until then
    their tensors count in the next peak-memory reading."""
    gc.collect()
    torch.cuda.empty_cache()


def _train_steps(step, batch, n, label, each=BF16_TRAIN_EACH):
    """``n`` train steps on ``batch``: host seconds, metrics; each step's
    launches (``ufm_torch.ops.launches`` order) held to ``each``."""
    from ufm_torch.ops import launches as counters

    times, metrics = [], []
    for i in range(n):
        before = counters.snapshot()
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        launched = counters.since(before)
        check(launched == each, f"{label} step {i}: launches {launched}, expected {each}")
        vals = {k: v.item() for k, v in m.items()}
        check(all(np.isfinite(v) for v in vals.values()), f"{label} step {i}: non-finite metrics {vals}")
        metrics.append(vals)
    return times, metrics


def phase_sharded_train(cls=None, config=None, label="sharded_train", path="ufm_base_sharded_train",
                        each=BF16_TRAIN_EACH, with_fit=True):
    """make_sharded_train_step on a (1, 1, 1) mesh (FSDP2 over NCCL, one
    rank) against make_train_step from the same weights and batch, for a
    model (``cls`` on ``config``: UFM-Base by default), each step's launches
    held to ``each``, no call of the plain attention or window refinement;
    then (``with_fit``) fit(mesh=...) stopping after one step and resuming
    from its checkpoint. Returns the launches of the two by kernel."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import launches as counters
    from ufm_torch.parallel import make_mesh
    from ufm_torch.training import fit, make_optimizer, make_sharded_train_step, make_train_step, synthetic_batch

    def build():
        return (cls or UniFlowMatchConfidence).from_config(config or ufm_base_config(), seed=0)

    # fit's rate without warm-up (FIT_LR): the loss falls step by step
    opt_kwargs = dict(learning_rate=FIT_LR, warmup_steps=0, total_steps=TRAIN_TOTAL_STEPS)
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=1, device="cuda")

    model = build()
    initial = _param_snapshot(model.net)
    optimizer = make_optimizer(model.net, **opt_kwargs)
    step = make_train_step(model.net, optimizer)
    torch.cuda.reset_peak_memory_stats()
    ran = {}
    plain_spans = _span_ms(model.net, optimizer, lambda: ran.update(
        zip(("times", "metrics"), _train_steps(step, batch, SHARDED_STEPS, f"{label} unsharded", each))))
    plain_times, plain_metrics = ran["times"], ran["metrics"]
    plain_peak = torch.cuda.max_memory_allocated()
    plain_delta = _group_deltas(_stepped_values(model.net, optimizer), initial)
    del model, step, optimizer
    _free_card_memory()

    model = build()
    check(all(torch.equal(p.detach().float().cpu(), initial[n]) for n, p in model.net.named_parameters()),
          "two models from seed 0 differ: the sharded step cannot be held to the unsharded one")
    mesh = make_mesh(1)
    t = time.perf_counter()
    step, net, optimizer, place = make_sharded_train_step(model.net, mesh, **opt_kwargs)
    placed = place(batch)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    counters.reset()  # the sharded path's counts start here
    with _plain_calls() as plain_calls:
        spans = _span_ms(net, optimizer, lambda: ran.update(
            zip(("times", "metrics"), _train_steps(step, placed, SHARDED_STEPS, label, each))))
    times, metrics = ran["times"], ran["metrics"]
    peak = torch.cuda.max_memory_allocated()
    launched = counters.snapshot()
    record_steps(path, launched, each, SHARDED_STEPS)
    step_launches = launched
    delta = _group_deltas(_stepped_values(net, optimizer), initial)
    metric_rel = {k: abs(metrics[0][k] - v) / max(abs(v), 1e-12) for k, v in plain_metrics[0].items()}
    delta_rel = {k: ((delta[k] - d).norm() / d.norm()).item() for k, d in plain_delta.items()}
    losses = [m["total_loss"] for m in metrics]
    step_s, plain_s = statistics.median(times[1:]), statistics.median(plain_times[1:])
    emit(label, model=type(model).__name__, mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)), batch=TRAIN_BATCH,
         input_hw=list(TRAIN_HW), steps=SHARDED_STEPS, shard_s=shard_s, step_s=times, step_ms=step_s * 1e3,
         pairs_per_s=TRAIN_BATCH / step_s, max_memory_allocated=peak, spans_ms=spans, unsharded_spans_ms=plain_spans,
         unsharded_step_s=plain_times, unsharded_step_ms=plain_s * 1e3,
         unsharded_pairs_per_s=TRAIN_BATCH / plain_s, unsharded_max_memory_allocated=plain_peak,
         losses=losses, unsharded_losses=[m["total_loss"] for m in plain_metrics],
         step0_metric_rel=metric_rel, metric_bound=SHARDED_METRIC_REL, param_delta_rel_l2=delta_rel,
         launches=step_launches, launches_per_step=each, plain_calls=plain_calls)
    check(plain_calls == {"attention": 0, "window": 0}, f"{label} called plain versions: {plain_calls}")
    check(set(metric_rel) == set(metrics[0]), f"metric names differ: {sorted(metrics[0])} vs {sorted(metric_rel)}")
    for k, r in metric_rel.items():
        check(r <= SHARDED_METRIC_REL, f"{label} vs unsharded step 0: {k} relative difference {r:.3e} > {SHARDED_METRIC_REL}")
    for k, r in delta_rel.items():
        check(r <= TRAIN_GRAD_REL_L2_BOUND, f"{label} vs unsharded parameter change, group {k}: relative L2 {r:.3e}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall on the fixed batch: {losses}")
    del model, net, optimizer, step, placed, initial, plain_delta, delta
    _free_card_memory()
    if not with_fit:
        return step_launches, None

    # fit(mesh=...): 1 step and its checkpoint (the data runs out), then a
    # new sharded net resumes it for the 2nd
    ckpt = os.path.join(ARTIFACT_DIR, "sharded_fit")
    shutil.rmtree(ckpt, ignore_errors=True)
    counters.reset()  # the sharded fit's counts start here
    runs = []
    for n_batches in (1, 1):
        model = build()
        logs, seen = [], []
        t = time.perf_counter()
        out = fit(model.net, (batch for _ in range(n_batches)), num_steps=FIT_STEPS, learning_rate=FIT_LR, mesh=make_mesh(1),
                  checkpoint_dir=ckpt, warmup_steps=0, log_every=1, log_fn=logs.append,
                  on_metrics=lambda _, vals: seen.append(vals["total_loss"]))
        torch.cuda.synchronize()
        runs.append({"seconds": time.perf_counter() - t, "step": out["step"], "losses": seen, "log": logs})
        del model, out
        _free_card_memory()
    launched = counters.snapshot()
    fit_launches = launched
    record_steps(f"{path.removesuffix('_train')}_fit", launched, each, FIT_STEPS)
    last = os.path.join(ckpt, str(FIT_STEPS), "train_state.pt")
    ckpt_bytes = os.path.getsize(last)  # one step's file
    state = torch.load(last, map_location="cpu", weights_only=True, mmap=True)
    tensor_bytes = sum(t.numel() * t.element_size() for t in _tensors(state))
    emit("sharded_fit", runs=runs, checkpoint_bytes=ckpt_bytes, state_tensor_bytes=tensor_bytes, launches=fit_launches)
    del state
    check([r["step"] for r in runs] == [1, FIT_STEPS], f"fit(mesh=...) stopped at {[r['step'] for r in runs]}")
    check(any("resumed from step 1" in line for line in runs[1]["log"]), f"the second fit did not resume: {runs[1]['log']}")
    check(all(np.isfinite(v) for r in runs for v in r["losses"]), "fit(mesh=...): non-finite losses")
    check(launched == {k: FIT_STEPS * n for k, n in each.items()},
          f"fit(mesh=...) launches {launched} over {FIT_STEPS} steps")
    shutil.rmtree(ckpt, ignore_errors=True)
    return step_launches, fit_launches


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _normalized_pair(batch, hw, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((batch, *hw, 3), generator=g, device="cuda") for _ in range(2)]


def phase_data_parallel():
    """make_data_parallel_forward on a (1, 1, 1) mesh for UFM-Base and
    UFM-Refine at batch 2, against each network's own forward."""
    from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_base_config, ufm_refine_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.ops import window_refinement as wr
    from ufm_torch.parallel import make_data_parallel_forward, make_mesh

    img1, img2 = _normalized_pair(DATA_PARALLEL_BATCH, TRAIN_HW, seed=2)
    launches = {}
    for label, cls, cfg in (("ufm_base", UniFlowMatchConfidence, ufm_base_config()),
                            ("ufm_refine", UniFlowMatchClassificationRefinement, ufm_refine_config())):
        model = cls.from_config(cfg, seed=0)
        forward = make_data_parallel_forward(model, make_mesh(1))
        fa.LAUNCHES = wr.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
        t = time.perf_counter()
        got = forward(img1, img2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches[label] = {"flash_attention_fwd": fa.LAUNCHES, "window_refinement_fwd": wr.LAUNCHES}
        mlp_path(f"{label}_data_parallel", mlp_counts(ge, lg), GELU_PER_FORWARD)
        with torch.no_grad():
            want = model.net(img1, img2)
        torch.cuda.synchronize()
        diff = {k: ((got[k].float() - v.float()).abs().max() / v.float().abs().max().clamp(min=1e-12)).item()
                for k, v in want.items()}
        emit("data_parallel", model=label, batch=DATA_PARALLEL_BATCH, input_hw=list(TRAIN_HW), seconds=seconds,
             launches=launches[label], max_rel_diff=diff, bar=DATA_PARALLEL_BAR)
        check(set(got) == set(want), f"{label}: output names differ")
        check(all(_finite(v) for v in got.values()), f"{label}: non-finite data-parallel outputs")
        check(all(got[k].shape == v.shape for k, v in want.items()), f"{label}: output shapes differ")
        for k, d in diff.items():
            check(d <= DATA_PARALLEL_BAR, f"{label} data-parallel vs single forward: {k} differs by {d:.3e}")
        want_launches = {"flash_attention_fwd": LAUNCHES_PER_FORWARD, "window_refinement_fwd": int(label == "ufm_refine")}
        check(launches[label] == want_launches, f"{label} data-parallel forward launches {launches[label]}, expected {want_launches}")
        del model, forward, got, want
        _free_card_memory()
    return launches


def _set_remat(net, remat, policy):
    for stack in (net.encoder, net.info_sharing):
        stack.remat, stack.remat_policy = remat, policy


def phase_remat(cls=None, config=None, cases=REMAT_CASES, label="remat", path="ufm_base_remat"):
    """The batch-2 train step of a model (``cls`` on ``config``: UFM-Base by
    default) under train_remat with no policy and with each of ``cases``
    (the JAX package's policy names): step time, peak memory and the
    launches a step (attention forward and GELU as each case gives them; a
    UFM-Refine step one window forward and one window backward: the window
    refinement lies outside the rematerialised blocks), no call of the
    plain attention or window refinement; each policy's gradients against
    no remat's (no remat against itself: the run-to-run spread)."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import launches as counters
    from ufm_torch.training import make_optimizer, make_train_step, synthetic_batch, ufm_total_loss

    _free_card_memory()
    model = (cls or UniFlowMatchConfidence).from_config(config or ufm_base_config(), seed=0)
    net = model.net
    window = int(model.config.has_classification_head)
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    step = make_train_step(net, make_optimizer(net, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS))

    def each_of(fwd, gelu_fwd):
        return launch_counts(flash_attention_fwd=fwd, flash_attention_bwd=LAUNCHES_PER_FORWARD,
                             window_refinement_fwd=window, gelu_bf16_fwd=gelu_fwd,
                             linear_gelu_bf16_fwd=0 if gelu_fwd else GELU_PER_FORWARD, window_refinement_bwd=window,
                             gelu_bf16_bwd=GELU_PER_FORWARD if gelu_fwd else 0,
                             linear_gelu_bf16_bwd=0 if gelu_fwd else GELU_PER_FORWARD)

    rows = {label_: {"policy": policy, "train_remat": remat, "launches_per_step": each_of(fwd, gelu_fwd),
                     "window_forward_recomputed": False if window else None,
                     "step_s": [], "max_memory_allocated": [], "resident_before": []}
            for label_, remat, policy, fwd, gelu_fwd in cases}
    counters.reset()  # this path's counts start here
    # two rounds, the second in the reverse order: a case's numbers do not
    # depend on which case ran before it
    with _plain_calls() as plain_calls:
        for round_cases in (cases, cases[::-1]):
            for label_, remat, policy, fwd, gelu_fwd in round_cases:
                each = each_of(fwd, gelu_fwd)
                _set_remat(net, remat, policy)
                _train_steps(step, batch, 1, f"{label} {label_} warm-up", each)
                torch.cuda.reset_peak_memory_stats()
                rows[label_]["resident_before"].append(torch.cuda.memory_allocated())
                times, _ = _train_steps(step, batch, REMAT_TIMED_STEPS, f"{label} {label_}", each)
                rows[label_]["step_s"] += times
                rows[label_]["max_memory_allocated"].append(torch.cuda.max_memory_allocated())
    check(plain_calls == {"attention": 0, "window": 0}, f"{label} called plain versions: {plain_calls}")
    for row in rows.values():
        row["step_ms"] = statistics.median(row["step_s"]) * 1e3
    launched = counters.snapshot()
    steps = 2 * (1 + REMAT_TIMED_STEPS)  # each case's steps, over both rounds
    record_path(path, launched, steps * sum(GELU_PER_FORWARD for c in cases if not c[4]),
                two_op=steps * sum(c[4] for c in cases), backward=steps * sum(GELU_PER_FORWARD for c in cases if c[4]),
                fused_backward=steps * sum(GELU_PER_FORWARD for c in cases if not c[4]))
    launches = launched
    del step
    net.zero_grad(set_to_none=True)
    _free_card_memory()

    # gradients of each case at the same weights, against no remat's
    def grads():
        net.zero_grad(set_to_none=True)
        loss, _ = ufm_total_loss(net(batch["img1"], batch["img2"]), batch)
        loss.backward()
        torch.cuda.synchronize()
        return _group_grads(net)

    # no remat twice: the run-to-run spread (the window backward sums df by
    # atomics in a varying order), the floor of every policy's reading
    _set_remat(net, False, None)
    reference = grads()
    for label_, remat, policy, _, _ in cases:
        _set_remat(net, remat, policy)
        g = grads()
        rows[label_]["grad_rel_l2"] = {k: ((g[k] - r).norm() / r.norm()).item() for k, r in reference.items()}
        del g
    emit(label, model=type(model).__name__, batch=TRAIN_BATCH, input_hw=list(TRAIN_HW), cases=rows, launches=launches,
         plain_calls=plain_calls, bound=TRAIN_GRAD_REL_L2_BOUND)
    for label_, row in rows.items():
        for k, r in row.get("grad_rel_l2", {}).items():
            check(r <= TRAIN_GRAD_REL_L2_BOUND, f"{label} {label_} vs no remat, group {k}: gradient relative L2 {r:.3e}")
    del model, net, reference
    _free_card_memory()
    return launches


def phase_moge():
    """UFM-Base with the moge_conv head at batch 1, 420x560: finite, 36
    attention launches, within FLOW_REL_L2_BOUND of its plain-attention
    forward."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg

    model = UniFlowMatchConfidence.from_config(ufm_base_config(head_type="moge_conv", feature_head_kwargs=MOGE_HEAD), seed=0)
    img1, img2 = _normalized_pair(1, TRAIN_HW, seed=3)
    with torch.no_grad():
        model.net(img1, img2)  # warm-up
        fa.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.net(img1, img2)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches, mlps = fa.LAUNCHES, mlp_counts(ge, lg)
        model.attention_impl = "torch"
        plain = model.net(img1, img2)
        model.attention_impl = None
    flow, want = out["flow"].float(), plain["flow"].float()
    rel = ((flow - want).norm() / want.norm()).item()
    head = {n: list(p.shape) for n, p in model.net.head1.named_parameters() if n.endswith("weight")}
    emit("moge", batch=1, input_hw=list(TRAIN_HW), head=head, forward_s=seconds, launches=launches,
         flow_shape=list(flow.shape), flow_rel_l2_vs_plain=rel, bound=FLOW_REL_L2_BOUND)
    check(tuple(flow.shape) == (1, *TRAIN_HW, 2), f"moge flow shape {tuple(flow.shape)}")
    check(all(_finite(v) for v in out.values()), "moge: non-finite outputs")
    check(launches == LAUNCHES_PER_FORWARD, f"moge forward: {launches} attention launches, expected 36")
    mlp_path("ufm_base_moge", mlps, GELU_PER_FORWARD)
    check(rel <= FLOW_REL_L2_BOUND, f"moge kernel vs plain attention: flow relative L2 {rel:.3e}")
    del model, out, plain
    _free_card_memory()
    return launches


def _profile_requests(fn, reps: int = PROFILE_REQUESTS):
    """``reps`` requests back to back, each waited for as a caller waits for
    its answer, inside one ``torch.profiler`` window (CUDA activity only).
    Per request: the window's host-clock time, the device busy time (the
    union of the kernels' intervals; copies and memsets are not kernels) and
    the idle share of the window; and the launches of each kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / reps
    spans, counts = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.name.startswith(("Memcpy", "Memset")):
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        for name in KERNEL_NAMES:  # "gelu_bf16_fwd_kernel" is not counted inside "linear_gelu_bf16_fwd_kernel"
            if re.search(rf"(?<![A-Za-z_]){name}", evt.name):
                counts[name] = counts.get(name, 0) + 1
    check(bool(spans), "the profiler recorded no kernel")
    busy_us, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    busy_ms = busy_us / 1e3 / reps
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms}, counts


def phase_captured(model, label, pair, batches, refine, window_kernel="window_refinement_fwd_kernel"):
    """One model, eager (``capture_graphs = False``) and then captured, at
    each batch: one first call and three timed calls a mode; the captured
    mode's launches counted per call; one batch-1 request of each mode
    profiled (a UFM-Refine replay runs one ``window_kernel``); the modes'
    outputs compared (a model without the uncertainty head answers with no
    covisibility in either mode). The captured mode's launches are recorded
    as the path ``<label>_captured``. Returns the rows by batch."""
    from ufm_torch.models import base

    # no other thread runs here: capture in the strictest mode, where any
    # call unsafe during a capture (the window launch queries its device and
    # its occupancy) fails the capture
    with unittest.mock.patch.object(base, "_CAPTURE_ERROR_MODE", "global"):
        return _captured(model, label, pair, batches, refine, window_kernel)


def _captured(model, label, pair, batches, refine, window_kernel):
    from ufm_torch.models import base
    from ufm_torch.ops import launches as counters

    def request(b):
        src, tgt = pair
        if b > 1:
            src, tgt = np.stack([src] * b), np.stack([tgt] * b)
        return lambda: model.predict_correspondences_batched(source_image=src, target_image=tgt)

    def timed(fn):
        times = []
        for _ in range(4):
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return res, times

    per_call = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, window_refinement_fwd=int(refine),
                             linear_gelu_bf16_fwd=GELU_PER_FORWARD)
    torch.cuda.reset_peak_memory_stats()
    rows, launched = {}, launch_counts()
    for b in batches:
        fn = request(b)
        model.capture_graphs = False
        eager, eager_times = timed(fn)
        model.capture_graphs = True
        counters.reset()  # the captured path's counts start here
        captured_times, calls = [], []
        for _ in range(4):  # the first call warms up and captures
            before = counters.snapshot()
            t = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            captured_times.append(time.perf_counter() - t)
            calls.append(counters.since(before))
        launched = {k: n + counters.snapshot()[k] for k, n in launched.items()}
        check(all(c == per_call for c in calls), f"{label} b{b}: launches per call {calls}, expected {per_call} each")
        record_path(f"{label}_captured", counters.snapshot(), len(calls) * GELU_PER_FORWARD)

        f_c, f_e = res.flow.flow_output.float(), eager.flow.flow_output.float()
        flow_rel = ((f_c - f_e).norm() / f_e.norm()).item()
        covis_diff = 0.0 if res.covisibility is None else \
            (res.covisibility.mask - eager.covisibility.mask).abs().max().item()
        row = dict(
            batch=b, input_hw=list(pair[0].shape[:2]),
            eager_first_s=eager_times[0], eager_latency_s=statistics.median(eager_times[1:]),
            captured_first_s=captured_times[0], captured_latency_s=statistics.median(captured_times[1:]),
            launches_per_call=calls, flow_max_abs_diff=(f_c - f_e).abs().max().item(), flow_rel_l2=flow_rel,
            covisibility=res.covisibility is not None, covis_max_abs_diff=covis_diff,
            bitwise_equal=_outputs_equal(res, eager), bar=CAPTURED_BAR, capture_error_mode=base._CAPTURE_ERROR_MODE,
        )
        row["speedup"] = row["eager_latency_s"] / row["captured_latency_s"]
        check(tuple(f_c.shape) == (b, 2, *pair[0].shape[:2]) and _finite(f_c), f"{label} b{b}: flow {tuple(f_c.shape)}")
        check((res.covisibility is None) == (eager.covisibility is None), f"{label} b{b}: covisibility in one mode only")
        check(flow_rel <= CAPTURED_BAR, f"{label} b{b}: captured vs eager flow relative L2 {flow_rel:.3e} > {CAPTURED_BAR}")
        check(covis_diff <= CAPTURED_BAR, f"{label} b{b}: captured vs eager covisibility {covis_diff:.3e} > {CAPTURED_BAR}")

        if b == 1:  # the profiler's view of each mode (after the path's count was read)
            replay, replay_counts = _profile_requests(fn)
            model.capture_graphs = False
            eager_prof, _ = _profile_requests(fn)
            model.capture_graphs = True
            row.update(profiled_requests=PROFILE_REQUESTS, replay_profiled=replay, eager_profiled=eager_prof,
                       profiler_kernels_per_replay={k: v / PROFILE_REQUESTS for k, v in replay_counts.items()})
            want = {"flash_attention_fwd_kernel": per_call[FWD_AT], "linear_gelu_bf16_fwd_kernel": per_call[FUSED_AT],
                    **({window_kernel: 1} if refine else {})}
            want = {k: v * PROFILE_REQUESTS for k, v in want.items()}
            check(replay_counts == want,
                  f"{label}: the profiler saw {replay_counts} in {PROFILE_REQUESTS} replays, expected {want}")
        rows[f"b{b}"] = row
        emit("captured", model=label, **row)
    peak = torch.cuda.max_memory_allocated()
    launches = launched
    emit("captured_memory", model=label, programs=len(model._programs), max_memory_allocated=peak,
         memory_allocated=torch.cuda.memory_allocated(), launches=launches)
    return rows


def _first_row_mixing_module(model, src, tgt):
    """One eager run on a batch of n copies of one pair with a hook on every
    module of the network: the first module, in call order, whose input rows
    0 and n - 1 are equal and whose output rows are not (the encoder's batch
    is 2n: both are source rows). (name, type, dtype) or None."""
    found, last = [], len(src) - 1

    def hook(name):
        def f(mod, inp, out):
            x = inp[0] if inp and isinstance(inp[0], torch.Tensor) else None
            if found or x is None or not isinstance(out, torch.Tensor) or x.shape[0] != out.shape[0] or x.dim() < 2:
                return
            if out.shape[0] in (last + 1, 2 * last + 2) and torch.equal(x[0], x[last]) \
                    and not torch.equal(out[0], out[last]):
                found.append((name, type(mod).__name__, str(out.dtype).replace("torch.", "")))
        return f

    handles = [mod.register_forward_hook(hook(n)) for n, mod in model.net.named_modules() if n]
    model.capture_graphs = False
    try:
        model.predict_correspondences_batched(src, tgt)
    finally:
        model.capture_graphs = True
        for h in handles:
            h.remove()
    return found[0] if found else None


def phase_batch_rows(model):
    """Does a flagship pair's answer depend on its batch? The pair at each
    slot of a lane-width batch (SERVE_MAX_BATCH, captured) among two sets of
    other pairs, with cuDNN's TF32 on (the default) and off. Its neighbours
    must not move it at any slot (bitwise). With TF32 off every slot must
    give the same bits, and no module may make equal input rows unequal;
    with TF32 on a slot may move it within SLOT_BAR, and the first module to
    do so must be an fp32 convolution (the heads'). The batch's latency in
    each mode is the price of slot-invariant answers."""
    n = SERVE_MAX_BATCH
    rng = np.random.default_rng(7)
    pairs = rng.integers(0, 256, (2 * n - 1, 2, *SERVE_HW, 3), dtype=np.uint8)  # pairs[0] is the probe
    neighbour_sets = (list(range(1, n)), list(range(n, 2 * n - 1)))

    def at(slot, neighbours):
        idx = neighbours[:slot] + [0] + neighbours[slot:]
        res = model.predict_correspondences_batched(pairs[idx, 0], pairs[idx, 1])
        return res.flow.flow_output[slot].float(), res.covisibility.mask[slot].float()

    modes = {}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            got = [[at(slot, nb) for nb in neighbour_sets] for slot in range(n)]
            times = []
            for _ in range(4):  # the program exists: each call is a replay
                t = time.perf_counter()
                at(0, neighbour_sets[0])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            copies = np.stack([pairs[0, 0]] * n), np.stack([pairs[0, 1]] * n)
            f0, c0 = got[0][0]
            epe = [(got[slot][0][0] - f0).norm(dim=0) for slot in range(n)]
            modes["tf32_on" if tf32 else "tf32_off"] = dict(
                neighbours_bitwise=all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in got),
                slots_bitwise=all(torch.equal(got[slot][0][0], f0) and torch.equal(got[slot][0][1], c0)
                                  for slot in range(n)),
                slot_flow_rel_l2=[((got[slot][0][0] - f0).norm() / f0.norm()).item() for slot in range(n)],
                slot_covis_max_abs_diff=[(got[slot][0][1] - c0).abs().max().item() for slot in range(n)],
                slot_epe_px_mean=[e.mean().item() for e in epe], slot_epe_px_max=[e.max().item() for e in epe],
                first_row_mixing_module=_first_row_mixing_module(model, *copies),
                batch_latency_s=statistics.median(times[1:]),
            )
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    emit("batch_rows", input_hw=list(SERVE_HW), batch=n, slot_bar=SLOT_BAR, **modes)
    on, off = modes["tf32_on"], modes["tf32_off"]
    for name, m in modes.items():
        check(m["neighbours_bitwise"], f"batch_rows {name}: a pair's answer moved with its neighbours")
        check(max(m["slot_flow_rel_l2"]) <= SLOT_BAR and max(m["slot_covis_max_abs_diff"]) <= SLOT_BAR,
              f"batch_rows {name}: the slot moved a pair's answer past {SLOT_BAR}: {m['slot_flow_rel_l2']}")
    check(off["slots_bitwise"] and off["first_row_mixing_module"] is None,
          f"batch_rows: with TF32 off a slot still moves the answer (first module {off['first_row_mixing_module']})")
    mixer = on["first_row_mixing_module"]
    check(on["slots_bitwise"] or (mixer is not None and mixer[1:] == ("Conv2d", "float32")),
          f"batch_rows: the slot's effect starts at {mixer}, not at an fp32 convolution")


def _http(port, path, body=None, content_type="application/x-npz"):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": content_type} if body is not None else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def _artifact_server(path, log):
    """``ufm_torch.cli.main(["serve", "--artifact", path, ...])`` as a user
    starts it, asked for lanes of SERVE_ARTIFACT_ASKED_BATCH, in a thread of
    this process (so that its launches are counted here), its output in
    ``log``. Returns the server it started once it serves, and the thread."""
    import threading

    from ufm_torch import cli
    from ufm_torch.runtime import server as server_mod

    started = []

    class Recorded(server_mod.UFMServer):
        def start(self):
            started.append(self)
            super().start()

    argv = ["serve", "--artifact", path, "--port", str(_free_port()), "--max-batch", str(SERVE_ARTIFACT_ASKED_BATCH)]
    with unittest.mock.patch.object(server_mod, "UFMServer", Recorded), contextlib.redirect_stdout(log):
        thread = threading.Thread(target=cli.main, args=(argv,), name="ufm-serve-artifact", daemon=True)
        thread.start()
        t = time.perf_counter()
        while "Serving" not in log.getvalue():
            check(thread.is_alive(), f"serve --artifact exited:\n{log.getvalue()}")
            check(time.perf_counter() - t < 300, "serve --artifact: not serving within 300 s")
            time.sleep(0.2)
    return started[0], thread


def phase_serve(model, label="serve", path="ufm_base_served", artifact=None):
    """The HTTP daemon at the lane width SERVE_MAX_BATCH: ``UFMServer`` on
    ``model`` or, given an ``artifact`` exported at that batch, ``ufm serve
    --artifact`` (``_artifact_server``: asked for another width, pinned to
    the artifact's). A warm-up request (the lane's capture), then
    SERVE_CLIENTS threads sending SERVE_REQUESTS npz requests each over
    loopback. Each lane batch's launches are counted (36 attention and 36
    fused fc1 + GELU launches, and 1 window launch for UFM-Refine; no call
    of a plain version), and the profiler sees the lane program's kernels
    once a replay. The slot each pair ran in is recorded, and every
    response is held to a direct predict of the live ``model`` on that pair
    among other neighbours (a batch of copies of it) at the same slot within
    CAPTURED_BAR (a crossed, stale or mixed row fails it), and at slot 0
    within SLOT_BAR (``batch_rows``). For a live model, the batch-size
    dependence: the first SERVE_MAX_BATCH pairs' responses against the pair
    alone at batch 1, in px (the end-point difference's mean, 99th
    percentile and max, the max held within BATCH_DRIFT_BUDGET_PX)."""
    import concurrent.futures
    import hashlib
    import io

    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import UFMServer

    refine = model.config.has_classification_head
    per_batch = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, window_refinement_fwd=int(refine),
                              linear_gelu_bf16_fwd=GELU_PER_FORWARD)
    rng = np.random.default_rng(0)
    n = SERVE_CLIENTS * SERVE_REQUESTS
    pairs = rng.integers(0, 256, (n + 1, 2, *SERVE_HW, 3), dtype=np.uint8)  # the last: the warm-up's

    def body(i):
        buf = io.BytesIO()
        np.savez(buf, source=pairs[i, 0], target=pairs[i, 1])
        return buf.getvalue()

    bodies = [body(i) for i in range(n + 1)]
    log = io.StringIO()
    if artifact is None:
        server, thread = UFMServer(model, port=0, max_batch=SERVE_MAX_BATCH, max_delay_ms=SERVE_MAX_DELAY_MS), None
        server.start()
    else:
        server, thread = _artifact_server(artifact, log)
    lane_batches = []  # (source, target) of each batch the lane ran
    predict_batch = server._predict_batch

    def recording(src, tgt):
        lane_batches.append((src.copy(), tgt.copy()))
        return predict_batch(src, tgt)

    server._predict_batch = recording
    try:
        health = json.loads(_http(server.port, "/healthz"))
        t = time.perf_counter()
        _http(server.port, "/v1/predict", bodies[n])  # warm-up: the lane's first batch captures its program
        warm_s = time.perf_counter() - t
        counters.reset()  # the served path's counts start here
        served, latency = [None] * n, [0.0] * n

        def client(k):
            for i in range(k * SERVE_REQUESTS, (k + 1) * SERVE_REQUESTS):
                t0 = time.perf_counter()
                raw = _http(server.port, "/v1/predict", bodies[i])
                latency[i] = time.perf_counter() - t0
                with np.load(io.BytesIO(raw)) as z:
                    served[i] = {k_: z[k_] for k_ in z.files}

        with _plain_calls() as plain_calls:
            t = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                for f in [pool.submit(client, k) for k in range(SERVE_CLIENTS)]:
                    f.result()
            wall = time.perf_counter() - t
        launched = counters.snapshot()
        stats = json.loads(_http(server.port, "/stats"))
        copies0 = np.stack([pairs[0, 0]] * SERVE_MAX_BATCH), np.stack([pairs[0, 1]] * SERVE_MAX_BATCH)
        _, replay_counts = _profile_requests(lambda: server.model.predict_correspondences_batched(*copies0))
    finally:
        server.close()
        if thread is not None:
            thread.join(timeout=60)
    (lane,) = stats.values()
    batches_timed = lane["batches"] - 1  # the warm-up request was a batch of its own

    def digest(src, tgt):
        return hashlib.sha1(src.tobytes() + tgt.tobytes()).hexdigest()

    slot_of = {}  # pair -> the slot it ran in (a pad repeats the pair before it)
    for src, tgt in lane_batches:
        for r in range(len(src)):
            slot_of.setdefault(digest(src[r], tgt[r]), r)
    slots = [slot_of[digest(pairs[i, 0], pairs[i, 1])] for i in range(n)]

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    same_slot = {"flow_rel_l2": 0.0, "covis_max_abs_diff": 0.0}
    slot0 = {"flow_rel_l2": 0.0, "covis_max_abs_diff": 0.0}
    batch1_rel, batch1_epe, batch1_abs = 0.0, [], 0.0
    bitwise = True
    for i in range(n):
        got, r = served[i], slots[i]
        check(got["flow"].shape == (2, *SERVE_HW) and np.isfinite(got["flow"]).all(), f"{label}: response {i}")
        copies = model.predict_correspondences_batched(np.stack([pairs[i, 0]] * SERVE_MAX_BATCH),
                                                       np.stack([pairs[i, 1]] * SERVE_MAX_BATCH))
        flow, covis = copies.flow.flow_output.float().cpu().numpy(), copies.covisibility.mask.cpu().numpy()
        bitwise &= np.array_equal(got["flow"], flow[r]) and np.array_equal(got["covisibility"], covis[r])
        for worst, k in ((same_slot, r), (slot0, 0)):
            worst["flow_rel_l2"] = max(worst["flow_rel_l2"], rel(got["flow"], flow[k]))
            worst["covis_max_abs_diff"] = max(worst["covis_max_abs_diff"],
                                              float(np.abs(got["covisibility"] - covis[k]).max()))
        if artifact is None and i < SERVE_MAX_BATCH:  # the pair alone: batch 1, another program, other GEMM shapes
            alone = model.predict_correspondences_batched(pairs[i, 0], pairs[i, 1]).flow.flow_output[0]
            alone = alone.float().cpu().numpy()
            batch1_rel = max(batch1_rel, rel(got["flow"], alone))
            batch1_abs = max(batch1_abs, float(np.abs(got["flow"] - alone).max()))
            batch1_epe.append(np.linalg.norm(got["flow"] - alone, axis=0).ravel())
    lat = np.array(latency)
    if artifact is None:
        epe = np.concatenate(batch1_epe)
        fields = dict(flow_rel_l2_vs_batch1_first_pairs=batch1_rel, batch_drift_px={
            "pairs": SERVE_MAX_BATCH, "from_batch": SERVE_MAX_BATCH, "to_batch": 1, "epe_mean": float(epe.mean()),
            "epe_p99": float(np.percentile(epe, 99)), "epe_max": float(epe.max()), "abs_diff_max": batch1_abs,
            "budget": BATCH_DRIFT_BUDGET_PX})
    else:
        fields = dict(artifact_batch=server.model.exported.batch, asked_max_batch=SERVE_ARTIFACT_ASKED_BATCH,
                      cli_said=log.getvalue().strip().splitlines())
    want_counts = {"flash_attention_fwd_kernel": LAUNCHES_PER_FORWARD, "linear_gelu_bf16_fwd_kernel": GELU_PER_FORWARD,
                   **({"window_refinement_fwd_kernel": 1} if refine else {})}
    want_counts = {k: v * PROFILE_REQUESTS for k, v in want_counts.items()}
    emit(label, model=type(model).__name__, artifact=artifact is not None, requests=n, clients=SERVE_CLIENTS,
         max_batch=SERVE_MAX_BATCH, max_delay_ms=SERVE_MAX_DELAY_MS, input_hw=list(SERVE_HW), warm_up_s=warm_s,
         wall_s=wall, pairs_per_s=n / wall, latency_p50_s=float(np.percentile(lat, 50)),
         latency_p99_s=float(np.percentile(lat, 99)), mean_batch_size=lane["mean_batch_size"], batcher=lane,
         healthz_backend=health["backend"], healthz=health, launches=launched,
         launches_per_batch=per_batch, batches_counted=batches_timed, plain_calls=plain_calls,
         profiler_kernels_per_replay={k: v / PROFILE_REQUESTS for k, v in replay_counts.items()},
         responses_by_slot=[slots.count(k) for k in range(SERVE_MAX_BATCH)],
         vs_copies_same_slot=same_slot, bitwise_equal=bool(bitwise), bar=CAPTURED_BAR,
         vs_copies_slot0=slot0, slot_bar=SLOT_BAR, **fields)
    check(health["backend"] == "cuda", f"{label}: /healthz backend {health['backend']}")
    check(lane["dispatched"] == n + 1 and len(lane_batches) == lane["batches"],
          f"{label}: the batcher dispatched {lane['dispatched']} of {n + 1} requests in {lane['batches']} batches")
    check(all(len(src) == SERVE_MAX_BATCH for src, _ in lane_batches),
          f"{label}: lane batches of {sorted({len(src) for src, _ in lane_batches})}, expected {SERVE_MAX_BATCH}")
    if artifact is not None:
        check(f"using --max-batch {SERVE_MAX_BATCH} (requested {SERVE_ARTIFACT_ASKED_BATCH})" in log.getvalue(),
              f"{label}: --max-batch was not pinned to the artifact's batch:\n{log.getvalue()}")
    check(plain_calls == {"attention": 0, "window": 0}, f"{label} called plain versions: {plain_calls}")
    check(launched == {k: batches_timed * n for k, n in per_batch.items()},
          f"{label}: launches {launched} for {batches_timed} batches, expected {per_batch} a batch")
    record_path(path, launched, GELU_PER_FORWARD * batches_timed)
    check(replay_counts == want_counts,
          f"{label}: the profiler saw {replay_counts} in {PROFILE_REQUESTS} replays, expected {want_counts}")
    check(same_slot["flow_rel_l2"] <= CAPTURED_BAR and same_slot["covis_max_abs_diff"] <= CAPTURED_BAR,
          f"{label}: a response differs from the direct predict of its pair at its slot: {same_slot}")
    check(slot0["flow_rel_l2"] <= SLOT_BAR and slot0["covis_max_abs_diff"] <= SLOT_BAR,
          f"{label}: a response differs from the direct predict of its pair at slot 0: {slot0}")
    if artifact is None:
        drift = fields["batch_drift_px"]
        check(drift["epe_max"] <= BATCH_DRIFT_BUDGET_PX,
              f"{label}: a pair at batch {SERVE_MAX_BATCH} and alone at batch 1 differ by {drift['epe_max']:.4f} px "
              f"(end-point difference, max), budget {BATCH_DRIFT_BUDGET_PX} px")


def phase_stream(model, label="stream", path="ufm_base_streamed"):
    """``stream_predict`` on the card into a model's lane-width program:
    STREAM_PAIRS pairs in batches of SERVE_MAX_BATCH (the last padded), through
    pinned copies on the copy stream and the one-deep pipeline. Outputs come
    in order, cut back to the valid pairs, each batch bitwise the direct
    predict of the same stacked (padded) batch; each batch's launches
    counted, no call of a plain version. For UFM-Refine also
    ``stream_predict_staged`` with the network's ``backbone`` as stage 1 and
    its ``refine_tail`` as stage 2 (the JAX package's two-program refine
    inference, eager; the intermediates stay on the card) on normalized
    pairs at the model resolution, each output within CAPTURED_BAR of the
    one-program forward of the same batch (path ``<path>_staged``)."""
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import stream_predict

    refine = model.config.has_classification_head
    per_batch = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, window_refinement_fwd=int(refine),
                              linear_gelu_bf16_fwd=GELU_PER_FORWARD)
    b = SERVE_MAX_BATCH
    pairs = np.random.default_rng(3).integers(0, 256, (STREAM_PAIRS, 2, *SERVE_HW, 3), dtype=np.uint8)
    batches = [list(range(k, min(k + b, STREAM_PAIRS))) for k in range(0, STREAM_PAIRS, b)]
    batches = [idx + [idx[-1]] * (b - len(idx)) for idx in batches]
    model.predict_correspondences_batched(pairs[batches[0], 0], pairs[batches[0], 1])  # the lane's program exists
    torch.cuda.synchronize()
    counters.reset()  # the streamed path's counts start here
    with _plain_calls() as plain_calls:
        t = time.perf_counter()
        outs = [(o.flow.flow_output, o.covisibility.mask)
                for o in stream_predict(model.predict_correspondences_batched, ((p[0], p[1]) for p in pairs),
                                        batch_size=b, device="cuda")]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launched = counters.snapshot()
    sizes = [len(f) for f, _ in outs]
    bitwise = True
    for (f, c), idx in zip(outs, batches):
        d = model.predict_correspondences_batched(pairs[idx, 0], pairs[idx, 1])
        bitwise &= (f.is_cuda and torch.equal(f, d.flow.flow_output[:len(f)])
                    and torch.equal(c, d.covisibility.mask[:len(f)]))
    staged = _stream_staged(model, f"{path}_staged") if refine else {}
    emit(label, model=type(model).__name__, pairs=STREAM_PAIRS, batch=b, input_hw=list(SERVE_HW), wall_s=wall,
         pairs_per_s=STREAM_PAIRS / wall, batch_sizes=sizes, bitwise_equal=bool(bitwise),
         launches=launched, plain_calls=plain_calls, **staged)
    check(sizes == [b] * (len(batches) - 1) + [STREAM_PAIRS - b * (len(batches) - 1)],
          f"{label}: batch sizes {sizes}")
    check(bitwise, f"{label}: a streamed batch differs from the direct predict of the same batch")
    check(plain_calls == {"attention": 0, "window": 0}, f"{label} called plain versions: {plain_calls}")
    check(launched == {k: len(batches) * n for k, n in per_batch.items()}, f"{label}: launches {launched}")
    record_path(path, launched, GELU_PER_FORWARD * len(batches))


def _stream_staged(model, path):
    """``stream_predict_staged`` of UFM-Refine's two stages (phase_stream):
    returns the fields phase_stream reports as ``staged``."""
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import stream_predict_staged

    net, b = model.net, SERVE_MAX_BATCH
    per_batch = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, window_refinement_fwd=1,
                              linear_gelu_bf16_fwd=GELU_PER_FORWARD)

    @torch.inference_mode()
    def stage1(img1, img2):
        out = net.backbone(img1, img2)
        return img1, img2, out["flow"], out["cls_in_0"], out["cls_in_1"]

    stage2 = torch.inference_mode()(net.refine_tail)
    w, h = model.inference_resolution[0]
    images = np.random.default_rng(4).standard_normal((STREAM_PAIRS, 2, h, w, 3), dtype=np.float32)
    batches = [list(range(k, min(k + b, STREAM_PAIRS))) for k in range(0, STREAM_PAIRS, b)]
    batches = [idx + [idx[-1]] * (b - len(idx)) for idx in batches]
    stacked = [tuple(torch.from_numpy(images[idx, i]).cuda() for i in (0, 1)) for idx in batches]
    stage2(*stage1(*stacked[0]))  # warm-up
    torch.cuda.synchronize()
    counters.reset()  # the staged path's counts start here
    with _plain_calls() as plain_calls:
        t = time.perf_counter()
        outs = list(stream_predict_staged(stage1, stage2, ((p[0], p[1]) for p in images), batch_size=b, device="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launched = counters.snapshot()
    keys = ("flow", "regression_flow", "refinement_residual", "refinement_log_softmax")
    diff, bitwise = {k: 0.0 for k in keys}, True
    for out, (x, y), idx in zip(outs, stacked, batches):
        with torch.inference_mode():
            want = net(x, y)
        valid = len(set(idx))
        for k in keys:
            check(out[k].is_cuda and out[k].shape[0] == valid, f"staged stream: {k} {tuple(out[k].shape)}")
            diff[k] = max(diff[k], (out[k] - want[k][:valid]).abs().max().item())
            bitwise &= torch.equal(out[k], want[k][:valid])
    check(plain_calls == {"attention": 0, "window": 0}, f"staged stream called plain versions: {plain_calls}")
    check(launched == {k: len(batches) * n for k, n in per_batch.items()}, f"staged stream: launches {launched}")
    check(max(diff.values()) <= CAPTURED_BAR, f"staged stream vs the one-program forward: {diff}")
    record_path(path, launched, GELU_PER_FORWARD * len(batches))
    return {"staged": {"input_hw": [h, w], "wall_s": wall, "pairs_per_s": STREAM_PAIRS / wall,
                       "max_abs_diff_vs_one_program": diff, "bar": CAPTURED_BAR, "bitwise_equal": bool(bitwise),
                       "launches": launched, "plain_calls": plain_calls}}


def _raw_diff(got, want) -> dict:
    """Flow relative L2, covisibility max abs difference and bitwise
    equality of two raw output dicts of the network."""
    f_g, f_w = got["flow"].float(), want["flow"].float()
    covis = (got["covis_mask"] - want["covis_mask"]).abs().max().item() if "covis_mask" in want else 0.0
    return {"flow_rel_l2": ((f_g - f_w).norm() / f_w.norm()).item(), "covis_max_abs_diff": covis,
            "bitwise_equal": set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)}


def _artifact_inputs(model, seed, batch=1):
    w, h = model.inference_resolution[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(batch, h, w, 3, generator=gen, device="cuda") for _ in range(2))


def phase_export(model):
    """The flagship UFM-Base exported on the card at batch 1 (parameters
    stored in fp32, then in bf16) and loaded back: its raw outputs against
    the live network's on the same inputs, 36 attention launches a call by
    the counters and by the profiler; the bf16-stored artifact against the
    fp32 one. Returns (the fp32 artifact's path, its loaded program, the
    launches of this phase)."""
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.runtime import export_model, load_exported

    paths = {d: os.path.join(ARTIFACT_DIR, f"ufm_base_{d}.ufmt") for d in ("fp32", "bf16")}
    seconds, manifests, loaded = {}, {}, {}
    for d, path in paths.items():
        t = time.perf_counter()
        manifests[d] = export_model(model, path, params_dtype=None if d == "fp32" else "bfloat16")
        seconds[f"export_{d}_s"] = time.perf_counter() - t
        t = time.perf_counter()
        loaded[d] = load_exported(path)
        torch.cuda.synchronize()
        seconds[f"load_{d}_s"] = time.perf_counter() - t
    x, y = _artifact_inputs(model, seed=11)
    art = loaded["fp32"]
    with torch.inference_mode():
        want = model.network_apply(x, y)
        fa.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
        got = art(x, y)
        torch.cuda.synchronize()
        per_call, fused_per_call = fa.LAUNCHES, lg.LAUNCHES
        half = loaded["bf16"](x, y)
        torch.cuda.synchronize()
        launches, mlps = fa.LAUNCHES, mlp_counts(ge, lg)
        _, counts = _profile_requests(lambda: art(x, y))
    diff = _raw_diff(got, want)
    drift = {k: ((half[k].float() - got[k].float()).abs().max() / got[k].float().abs().max().clamp_min(1e-6)).item()
             for k in got}
    emit("export", model="ufm_base", batch=1, input_hw=list(x.shape[1:3]), **seconds,
         program_bytes={d: m["program_bytes"] for d, m in manifests.items()},
         param_bytes=manifests["fp32"]["param_bytes"],
         stored_param_bytes={d: m["stored_param_bytes"] for d, m in manifests.items()},
         file_bytes={d: os.path.getsize(p) for d, p in paths.items()}, ops=manifests["fp32"]["ops"],
         launches_per_call=per_call, linear_gelu_launches_per_call=fused_per_call,
         profiler_kernels_per_call={k: v / PROFILE_REQUESTS for k, v in counts.items()},
         **diff, bar=ARTIFACT_BAR, bf16_relative_drift=drift, bf16_bound=ARTIFACT_BF16_DRIFT)
    check(per_call == LAUNCHES_PER_FORWARD, f"export: {per_call} attention launches in one artifact call")
    # the fp32- and the bf16-stored artifact
    mlp_path("ufm_base_artifact", mlps, 2 * GELU_PER_FORWARD)
    check(counts == {"flash_attention_fwd_kernel": LAUNCHES_PER_FORWARD * PROFILE_REQUESTS,
                     "linear_gelu_bf16_fwd_kernel": GELU_PER_FORWARD * PROFILE_REQUESTS},
          f"export: the profiler saw {counts} in {PROFILE_REQUESTS} artifact calls")
    check(diff["flow_rel_l2"] <= ARTIFACT_BAR and diff["covis_max_abs_diff"] <= ARTIFACT_BAR,
          f"export: the artifact differs from the live network: {diff}")
    check(max(drift.values()) < ARTIFACT_BF16_DRIFT, f"export: bf16-stored parameters drift {drift}")
    check(manifests["fp32"]["program_bytes"] < manifests["fp32"]["param_bytes"] / 10,
          "export: the program file holds the weights")
    del loaded["bf16"], half
    return paths["fp32"], art, launches


def phase_export_cpu():
    """The flagship UFM-Base built and exported on the CPU (full depth and
    widths), loaded onto the card (the program moved by
    ``move_to_device_pass``): it must launch the kernels, and answer as the
    same weights do in the live model on the card. Returns its launches."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.runtime import export_model, load_exported

    path = os.path.join(ARTIFACT_DIR, "ufm_base_cpu.ufmt")
    t = time.perf_counter()
    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0, device="cpu")
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    manifest = export_model(model, path)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    art = load_exported(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    model.net.to("cuda")
    x, y = _artifact_inputs(model, seed=12)
    with torch.inference_mode():
        fa.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
        got = art(x, y)
        torch.cuda.synchronize()
        launches, mlps = fa.LAUNCHES, mlp_counts(ge, lg)
        want = model.network_apply(x, y)
    diff = _raw_diff(got, want)
    emit("export_cpu", model="ufm_base", traced_on=manifest["devices"], loaded_on=str(art.device), depth_cut=None,
         build_cpu_s=build_s, export_s=export_s, load_s=load_s, program_bytes=manifest["program_bytes"],
         launches_per_call=launches, **diff, bar=ARTIFACT_CPU_BAR)
    check(manifest["devices"] == ["cpu"] and art.device.type == "cuda", "export_cpu: not traced on the CPU and run on the card")
    check(launches == LAUNCHES_PER_FORWARD, f"export_cpu: {launches} attention launches in one call")
    mlp_path("ufm_base_artifact_cpu_export", mlps, GELU_PER_FORWARD)
    check(diff["flow_rel_l2"] <= ARTIFACT_CPU_BAR, f"export_cpu: the moved program differs from the card model: {diff}")
    return launches


def phase_artifact_predict(model, art, pair):
    """``ArtifactUFM.predict_correspondences_batched`` (the artifact in the
    predict API, captured) against the live model's on a 480x640 pair: a
    first call (the capture) and three timed calls each; launches per replay.
    Returns the artifact's launches."""
    from ufm_torch.models import base
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import gelu as ge
    from ufm_torch.ops import linear_gelu as lg
    from ufm_torch.runtime.export import ArtifactUFM

    art_model = ArtifactUFM(art)

    def timed(m):
        times, calls = [], []
        for _ in range(4):
            before = (fa.LAUNCHES, ge.LAUNCHES, lg.LAUNCHES)
            t = time.perf_counter()
            res = m.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            calls.append((fa.LAUNCHES - before[0], ge.LAUNCHES - before[1], lg.LAUNCHES - before[2]))
        return res, times, calls

    with unittest.mock.patch.object(base, "_CAPTURE_ERROR_MODE", "global"):
        fa.LAUNCHES = ge.LAUNCHES = ge.BWD_LAUNCHES = lg.LAUNCHES = lg.BWD_LAUNCHES = 0  # this path's counts start here
        got, art_times, art_calls = timed(art_model)
        launches, mlps = fa.LAUNCHES, mlp_counts(ge, lg)
        want, live_times, _ = timed(model)
    f_g, f_w = got.flow.flow_output.float(), want.flow.flow_output.float()
    rel = ((f_g - f_w).norm() / f_w.norm()).item()
    covis = (got.covisibility.mask - want.covisibility.mask).abs().max().item()
    emit("artifact_predict", input_hw=list(pair[0].shape[:2]), batch=1, launches_per_call=art_calls,
         artifact_first_s=art_times[0], artifact_latency_s=statistics.median(art_times[1:]),
         live_latency_s=statistics.median(live_times[1:]), programs=len(art_model._programs),
         flow_rel_l2=rel, covis_max_abs_diff=covis, bitwise_equal=_outputs_equal(got, want), bar=ARTIFACT_BAR)
    check(all(c == (LAUNCHES_PER_FORWARD, 0, GELU_PER_FORWARD) for c in art_calls),
          f"artifact_predict: attention / GELU / fused fc1 + GELU launches per call {art_calls}")
    mlp_path("ufm_base_artifact_captured", mlps, len(art_calls) * GELU_PER_FORWARD)
    check(rel <= ARTIFACT_BAR and covis <= ARTIFACT_BAR, f"artifact_predict: {rel:.3e} / {covis:.3e} from the live model")
    return art_model, launches


def phase_artifact_model(model, label="artifact_refine", path="ufm_refine_artifact"):
    """A model (UFM-Refine, UniFlowMatch) exported on the card at batch 1
    and loaded: raw outputs against the live network's (the same kernels and
    ops: held within ARTIFACT_BAR, bitwise reported), 36 attention launches a
    call and for UFM-Refine 1 window launch."""
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import export_model, load_exported

    refine = model.config.has_classification_head
    file = os.path.join(ARTIFACT_DIR, f"{path}.ufmt")
    t = time.perf_counter()
    manifest = export_model(model, file)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    art = load_exported(file)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    x, y = _artifact_inputs(model, seed=13)
    with torch.inference_mode():
        want = model.network_apply(x, y)
        counters.reset()  # this path's counts start here
        got = art(x, y)
        torch.cuda.synchronize()
    launched = counters.snapshot()
    record_path(path, launched, GELU_PER_FORWARD)
    diff = _raw_diff(got, want)
    fields = {}
    if refine:
        fields = dict(refined_flow_max_abs_diff_px=(got["flow"] - want["flow"]).abs().max().item(),
                      refined_bound_px=REFINED_FLOW_MAX_ABS)
    emit(label, model=type(model).__name__, export_s=export_s, load_s=load_s, program_bytes=manifest["program_bytes"],
         param_bytes=manifest["param_bytes"], ops=manifest["ops"], staged=manifest["staged"],
         launches_per_call=launched, outputs=sorted(got), **diff, bar=ARTIFACT_BAR, **fields)
    per_call = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, window_refinement_fwd=int(refine),
                             linear_gelu_bf16_fwd=GELU_PER_FORWARD)
    check(launched == per_call, f"{label}: launches {launched} in one call, expected {per_call}")
    check(diff["flow_rel_l2"] <= ARTIFACT_BAR and diff["covis_max_abs_diff"] <= ARTIFACT_BAR,
          f"{label}: the artifact differs from the live network: {diff}")
    if refine:
        check(fields["refined_flow_max_abs_diff_px"] <= REFINED_FLOW_MAX_ABS,
              f"{label}: refined flow {fields['refined_flow_max_abs_diff_px']:.3e} px from the live model")
    return diff


def phase_artifact_batch4():
    """``ufm export --model M --random-init --batch 4`` as a user runs it
    (``ufm_torch.cli.main`` in this process) for UFM-Base and UFM-Refine:
    each artifact loaded by ``load_artifact_model``; its raw outputs at
    batch 4 bitwise the live network's (the same seed's weights) on the
    same inputs, 36 attention and 36 fused fc1 + GELU launches a call (and
    1 window launch for UFM-Refine); then served through ``ufm serve
    --artifact`` (phase_serve: the lane width pinned to the artifact's 4)
    under SERVE_CLIENTS clients, each response held to the live model at
    its slot."""
    import io

    from ufm_torch import cli
    from ufm_torch.models import (UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_base_config,
                                  ufm_refine_config)
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import load_artifact_model

    b = SERVE_MAX_BATCH
    for m, cls, cfg in (("base", UniFlowMatchConfidence, ufm_base_config()),
                        ("refine", UniFlowMatchClassificationRefinement, ufm_refine_config())):
        file = os.path.join(ARTIFACT_DIR, f"ufm_{m}_b{b}.ufmt")
        log = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                cli.main(["export", file, "--model", m, "--random-init", "--batch", str(b)])
        except SystemExit as e:
            check(False, f"ufm export exited {e.code}:\n{log.getvalue()}")
        export_s = time.perf_counter() - t
        _free_card_memory()
        t = time.perf_counter()
        art = load_artifact_model(file)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        live = cls.from_config(cfg, seed=0)
        x, y = _artifact_inputs(live, seed=14, batch=b)
        with torch.inference_mode():
            want = live.network_apply(x, y)
            counters.reset()  # this path's counts start here
            got = art.exported(x, y)
            torch.cuda.synchronize()
        launched = counters.snapshot()
        path = f"ufm_{m}_artifact_b{b}"
        record_path(path, launched, GELU_PER_FORWARD)
        diff = _raw_diff(got, want)
        per_call = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, window_refinement_fwd=int(m == "refine"),
                                 linear_gelu_bf16_fwd=GELU_PER_FORWARD)
        emit("artifact_batch4", model=type(live).__name__, cli_said=log.getvalue().strip().splitlines(),
             batch=art.exported.batch, input_hw=list(x.shape[1:3]), export_s=export_s, load_s=load_s,
             file_bytes=os.path.getsize(file), launches_per_call=launched, **diff)
        check(art.exported.batch == b and art.manifest["model_class"] == type(live).__name__,
              f"artifact_batch4: {art.manifest['model_class']} at batch {art.exported.batch}")
        check(launched == per_call, f"artifact_batch4 {m}: launches {launched} in one call, expected {per_call}")
        check(diff["bitwise_equal"], f"artifact_batch4 {m}: the artifact differs from the live network: {diff}")
        del art, got, want
        _free_card_memory()
        phase_serve(live, label="artifact_batch4_serve", path=f"{path}_served", artifact=file)
        del live
        _free_card_memory()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_serve_artifact(path, art_model, pair):
    """``python -m ufm_torch.cli serve --artifact`` in its own process
    (asked for lanes of 4: pinned to the artifact's batch 1): ``/healthz``
    must report the card, and one npz request must match ``ArtifactUFM``'s
    answer for the pair (its slot is 0) in this process."""
    import io

    port = _free_port()
    cmd = [sys.executable, "-m", "ufm_torch.cli", "serve", "--artifact", path, "--port", str(port), "--max-batch", "4"]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        health = None
        while health is None:
            if proc.poll() is not None:
                raise RuntimeError(f"chip_smoke check failed: serve --artifact exited {proc.returncode}:\n{proc.stdout.read()}")
            check(time.perf_counter() - t < 300, "serve_artifact: no /healthz within 300 s")
            try:
                health = json.loads(_http(port, "/healthz"))
            except OSError:
                time.sleep(0.5)
        ready_s = time.perf_counter() - t
        buf = io.BytesIO()
        np.savez(buf, source=pair[0], target=pair[1])
        t = time.perf_counter()
        with np.load(io.BytesIO(_http(port, "/v1/predict", buf.getvalue()))) as z:
            served = {k: z[k] for k in z.files}
        first_request_s = time.perf_counter() - t
    finally:
        proc.terminate()
        try:
            log, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    direct = art_model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    flow, covis = direct.flow.flow_output[0].float().cpu().numpy(), direct.covisibility.mask[0].cpu().numpy()
    rel = float(np.linalg.norm(served["flow"] - flow) / np.linalg.norm(flow))
    covis_diff = float(np.abs(served["covisibility"] - covis).max())
    pinned = "using --max-batch 1 (requested 4)" in log
    emit("serve_artifact", ready_s=ready_s, first_request_s=first_request_s, healthz=health, max_batch_pinned=pinned,
         flow_rel_l2=rel, covis_max_abs_diff=covis_diff,
         bitwise_equal=bool(np.array_equal(served["flow"], flow) and np.array_equal(served["covisibility"], covis)),
         bar=CAPTURED_BAR, launches="in the server's process: not counted here")
    check(health["backend"] == "cuda", f"serve_artifact: /healthz backend {health['backend']}")
    check(pinned, f"serve_artifact: --max-batch was not pinned to the artifact's batch:\n{log}")
    check(rel <= CAPTURED_BAR and covis_diff <= CAPTURED_BAR, f"serve_artifact: {rel:.3e} / {covis_diff:.3e} from ArtifactUFM")


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8, written by the port's own
    codec (``ufm_torch.utils.image_io``: zlib alone, no image library)."""
    from ufm_torch.utils import image_io

    image_io.write_png(path, rgb)


def _loader_library_links_no_image_library() -> dict:
    """The loader's build: no ``-l`` flag in the host build, and no libjpeg /
    libpng / zlib among the built library's NEEDED names."""
    from ufm_torch.ops import _build

    lib = _build.load_host_library("ufm_loader")
    with open(lib._name, "rb") as f:
        binary = f.read()
    needed = [name for name in ("libjpeg.so", "libpng", "libz.so") if name.encode() in binary]
    flags = [f for f in _build.CXX_FLAGS if f.startswith("-l")]
    check(not flags and not needed, f"loader: link flags {flags}, image libraries in the library: {needed}")
    return {"link_flags": flags, "image_libraries_needed": needed, "library": os.path.basename(lib._name)}


def _decode_one(loader, path):
    loader.submit(0, path)
    polled = loader.poll(timeout_s=30.0)
    check(polled is not None, f"loader: {path} timed out")
    return polled[1]


def _jpeg_cases_bitwise() -> dict:
    """Every committed JPEG case through the loader (libjpeg's JCS_RGB
    decode) and ``read_rgb`` (cv2's), held bitwise to the committed
    decodes; a case the JAX package's loader refused (CMYK) refused too."""
    from ufm_torch.runtime.loader import NativeImageLoader
    from ufm_torch.utils.image_io import read_rgb

    with np.load(os.path.join(JPEG_CASES, "decodes.npz")) as z:
        stored = {k: z[k] for k in z.files}
    names = sorted(k[len("cv2/"):] for k in stored if k.startswith("cv2/"))
    mismatched = []
    for name in names:
        path = os.path.join(JPEG_CASES, name)
        if not np.array_equal(read_rgb(path), stored[f"cv2/{name}"]):
            mismatched.append(f"read_rgb {name}")
        want = stored.get(f"libjpeg/{name}")
        hw = want.shape[:2] if want is not None else stored[f"cv2/{name}"].shape[:2]
        with NativeImageLoader(hw, num_threads=1) as loader:
            got = _decode_one(loader, path)
        if (got is None) != (want is None) or (got is not None and not np.array_equal(got, want)):
            mismatched.append(f"loader {name}")
    check(not mismatched and len(names) == 16, f"loader: {len(names)} cases, not bitwise: {mismatched}")
    return {"cases": len(names), "refused_as_libjpeg": sorted(set(names) - {k[len("libjpeg/"):] for k in stored})}


def _jpeg_decode_rates(folder=JPEG_PAIR) -> dict:
    """The 1080x1920 pair in ``folder`` (JPEG_PAIR, or JPEG_PAIR_ARITH) at its
    size: SHA-256 of each decode against the committed Huffman pair's; one
    frame on one thread (median of JPEG_DECODE_REPS submit-to-poll times, the
    frame's copy out included); frames/s at each of JPEG_THREADS
    (JPEG_FRAMES_PER_COUNT frames, both files in turn)."""
    import hashlib

    from ufm_torch.runtime.loader import NativeImageLoader

    with open(os.path.join(JPEG_PAIR, "sha256.json")) as f:
        hashes = json.load(f)
    paths = [os.path.join(folder, n) for n in JPEG_PAIR_FILES]
    hw = tuple(hashes[JPEG_PAIR_FILES[0]]["shape"][:2])
    with NativeImageLoader(hw, num_threads=1) as loader:
        digests = {n: hashlib.sha256(_decode_one(loader, p).tobytes()).hexdigest() for n, p in zip(JPEG_PAIR_FILES, paths)}
        times = []
        for _ in range(JPEG_DECODE_REPS):
            t = time.perf_counter()
            _decode_one(loader, paths[0])
            times.append(time.perf_counter() - t)
    rates = {}
    for threads in JPEG_THREADS:
        with NativeImageLoader(hw, num_threads=threads) as loader:
            t = time.perf_counter()
            for i in range(JPEG_FRAMES_PER_COUNT):
                loader.submit(i, paths[i % 2])
            for _ in range(JPEG_FRAMES_PER_COUNT):
                polled = loader.poll(timeout_s=30.0)
                check(polled is not None and polled[1] is not None, f"loader: a frame failed at {threads} threads")
            rates[threads] = JPEG_FRAMES_PER_COUNT / (time.perf_counter() - t)
    check(all(digests[n] == hashes[n]["sha256"] for n in JPEG_PAIR_FILES),
          f"loader: the 1080x1920 pair in {folder} decodes to {digests}, libjpeg's are {hashes}")
    return {"pair_sha256_match": True, "pair_bytes": [os.path.getsize(p) for p in paths],
            "decode_ms_1_thread": float(np.median(times)) * 1e3, "decode_ms_all": [t * 1e3 for t in times],
            "frames_per_s_by_threads": rates}


def _jpeg_stream(model, folder=JPEG_PAIR, path_name="ufm_base_loader_streamed"):
    """JPEG_STREAM_PAIRS pairs of the committed 1080x1920 files in ``folder``
    through ``iter_decoded_pairs`` (resized to SERVE_HW in the loader, 4
    threads) into ``stream_predict`` at lanes of SERVE_MAX_BATCH: 36 attention
    and 36 fused fc1 + GELU launches a batch, no plain call, each output
    bitwise the stream of the same decoded frames from memory. Returns the
    summary and the streamed (flow, covisibility) of each batch."""
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import iter_decoded_pairs, stream_predict

    paths = [tuple(os.path.join(folder, n) for n in JPEG_PAIR_FILES)] * JPEG_STREAM_PAIRS
    b = SERVE_MAX_BATCH
    frames = list(iter_decoded_pairs(paths[:1], SERVE_HW, num_threads=4)) * JPEG_STREAM_PAIRS
    model.predict_correspondences_batched(np.stack([frames[0][0]] * b), np.stack([frames[0][1]] * b))  # the lane's program
    torch.cuda.synchronize()
    counters.reset()  # the streamed path's counts start here
    with _plain_calls() as plain_calls:
        t = time.perf_counter()
        from_files = [(o.flow.flow_output, o.covisibility.mask)
                      for o in stream_predict(model.predict_correspondences_batched,
                                              iter_decoded_pairs(paths, SERVE_HW, num_threads=4), batch_size=b,
                                              device="cuda")]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launched = counters.snapshot()
    t = time.perf_counter()
    from_memory = [(o.flow.flow_output, o.covisibility.mask)
                   for o in stream_predict(model.predict_correspondences_batched, iter(frames), batch_size=b,
                                           device="cuda")]
    torch.cuda.synchronize()
    memory_wall = time.perf_counter() - t
    batches = -(-JPEG_STREAM_PAIRS // b)
    bitwise = len(from_files) == len(from_memory) == batches and all(
        torch.equal(f, g) and torch.equal(c, d) for (f, c), (g, d) in zip(from_files, from_memory))
    per_batch = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, linear_gelu_bf16_fwd=GELU_PER_FORWARD)
    check(bitwise, f"loader: streamed outputs from the JPEG files in {folder} differ from the stream of the same "
                   "frames from memory")
    check(plain_calls == {"attention": 0, "window": 0}, f"loader stream called plain versions: {plain_calls}")
    check(launched == {k: batches * n for k, n in per_batch.items()}, f"loader stream: launches {launched}")
    record_path(path_name, launched, GELU_PER_FORWARD * batches)
    return {"stream_pairs": JPEG_STREAM_PAIRS, "stream_input": "1080x1920 JPEG files resized to 480x640 by the loader",
            "streamed_pairs_per_s_from_jpeg": JPEG_STREAM_PAIRS / wall,
            "streamed_pairs_per_s_from_memory": JPEG_STREAM_PAIRS / memory_wall,
            "stream_bitwise_from_memory": bool(bitwise), "stream_launches": launched,
            "stream_plain_calls": plain_calls}, from_files


def _jpeg_stage_split() -> dict:
    """Where a 1080x1920 frame's decode goes, by the decoder's own clock
    (``ufm_image_decode_stages``, the loader's target, one thread): ms of
    headers and entropy decoding, the IDCT (with block smoothing in a cut
    frame), upsampling and colour conversion; the median of JPEG_CUT_REPS,
    for frame 0 of each pair and frame 1 of each cut at its committed offset."""
    import ctypes

    from ufm_torch.ops import _build

    lib = _build.load_host_library("ufm_loader")
    lib.ufm_image_decode_stages.restype = ctypes.c_int
    lib.ufm_image_decode_stages.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double)]
    with open(os.path.join(JPEG_PAIR_ARITH, "cut.json")) as f:
        cuts = json.load(f)
    frames = {}
    for key, folder in (("frame0.jpg", JPEG_PAIR), ("frame0_arith.jpg", JPEG_PAIR_ARITH)):
        with open(os.path.join(folder, "frame0.jpg"), "rb") as f:
            frames[key] = f.read()
    for key, entry in cuts.items():
        with open(os.path.join(JPEG_PAIR if key == "frame1.jpg" else JPEG_PAIR_ARITH, "frame1.jpg"), "rb") as f:
            frames[key.replace("frame1", "frame1_cut")] = f.read(entry["bytes"])
    split = {}
    for key, data in frames.items():
        runs = []
        for _ in range(JPEG_CUT_REPS):
            seconds = (ctypes.c_double * 3)()
            check(lib.ufm_image_decode_stages(data, len(data), seconds) == 0, f"loader: {key} refused")
            runs.append([t * 1e3 for t in seconds])
        split[key] = dict(zip(("entropy_ms", "idct_ms", "upsample_color_ms"), np.median(runs, axis=0).tolist()))
    return split


def _jpeg_cut_frames() -> dict:
    """Frame 1 of the Huffman and the arithmetic pair cut inside its AC scans
    (JPEG_PAIR_ARITH/cut.json): the loader's decode, block-smoothed, against
    libjpeg's committed SHA-256, and its decode ms (the median of
    JPEG_CUT_REPS)."""
    import hashlib

    from ufm_torch.runtime.loader import NativeImageLoader

    with open(os.path.join(JPEG_PAIR_ARITH, "cut.json")) as f:
        cuts = json.load(f)
    out = {}
    with NativeImageLoader((1080, 1920), num_threads=1) as loader:
        for key, entry in sorted(cuts.items()):
            with open(os.path.join(JPEG_PAIR if key == "frame1.jpg" else JPEG_PAIR_ARITH, "frame1.jpg"), "rb") as f:
                data = f.read(entry["bytes"])
            path = os.path.join(ARTIFACT_DIR, f"cut_{key}")
            with open(path, "wb") as f:
                f.write(data)
            digest = hashlib.sha256(_decode_one(loader, path).tobytes()).hexdigest()
            times = []
            for _ in range(JPEG_CUT_REPS):
                t = time.perf_counter()
                _decode_one(loader, path)
                times.append(time.perf_counter() - t)
            out[key] = {"bytes": entry["bytes"], "sha256_match": digest == entry["sha256"],
                        "decode_ms": float(np.median(times)) * 1e3}
    check(sorted(out) == ["frame1.jpg", "frame1_arith.jpg"] and all(v["sha256_match"] for v in out.values()),
          f"loader: cut frames {out} against libjpeg's smoothed SHA-256s")
    return out


def phase_loader(model):
    """The native image loader where this script runs, built from the repository
    alone (no image library linked): PNG pairs written by this script and
    the committed smooth JPEG decoded by ``NativeImageLoader`` (PNG frames
    exact, the JPEG bitwise its committed decode); the committed JPEG cases
    bitwise; the 1080x1920 JPEG pair's decodes against libjpeg's SHA-256,
    its decode ms and frames/s by thread count; JPEG files streamed into
    ``stream_predict`` on ``model`` (UFM-Base), bitwise the stream from
    memory (path ``ufm_base_loader_streamed``); the same for the arithmetic
    pair (``ufm_base_loader_streamed_arith``: the outputs bitwise the
    Huffman stream's); frame 1 of each pair cut inside its AC scans against
    libjpeg's block-smoothed SHA-256; the decoder's stage split."""
    from ufm_torch.runtime.loader import NativeImageLoader, iter_decoded_pairs

    build = _loader_library_links_no_image_library()
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (LOADER_PAIRS, 2, *LOADER_HW, 3), dtype=np.uint8)
    paths = []
    for i, pair in enumerate(frames):
        paths.append(tuple(os.path.join(ARTIFACT_DIR, f"pair{i}_{j}.png") for j in (0, 1)))
        for p, img in zip(paths[-1], pair):
            write_png(p, img)
    t = time.perf_counter()
    decoded = list(iter_decoded_pairs(paths, LOADER_HW, num_threads=4))
    decode_s = time.perf_counter() - t
    exact = all(np.array_equal(a, frames[i, 0]) and np.array_equal(b, frames[i, 1]) for i, (a, b) in enumerate(decoded))
    with np.load(LOADER_JPEG + ".npz") as z:
        source, committed = z["source"], z["decoded"]
    with NativeImageLoader(source.shape[:2], num_threads=1) as loader:
        jpeg = _decode_one(loader, LOADER_JPEG + ".jpg")
    jpeg_err = float(np.abs(jpeg.astype(int) - source.astype(int)).mean())
    cases = _jpeg_cases_bitwise()
    rates = _jpeg_decode_rates()
    stream, huffman_out = _jpeg_stream(model)
    arith = _jpeg_decode_rates(JPEG_PAIR_ARITH)
    arith_stream, arith_out = _jpeg_stream(model, JPEG_PAIR_ARITH, "ufm_base_loader_streamed_arith")
    arith_bitwise = len(arith_out) == len(huffman_out) and all(
        torch.equal(f, g) and torch.equal(c, d) for (f, c), (g, d) in zip(arith_out, huffman_out))
    del huffman_out, arith_out
    arith.update(arith_stream, stream_bitwise_huffman_stream=bool(arith_bitwise))
    arith["pair_sha256_match_huffman_pair"] = arith.pop("pair_sha256_match")
    cut = _jpeg_cut_frames()
    stages = _jpeg_stage_split()
    emit("loader", ran=True, build=build, png_pairs=LOADER_PAIRS, png_hw=list(LOADER_HW), png_frames_exact=exact,
         png_frames_per_s=2 * LOADER_PAIRS / decode_s, jpeg_mean_abs_err=jpeg_err, jpeg_bar=LOADER_JPEG_MEAN_ABS,
         smooth_jpeg_bitwise=bool(np.array_equal(jpeg, committed)), jpeg_cases=cases, **rates, **stream, arith=arith,
         cut_frames=cut, decode_stages_ms=stages)
    check(arith_bitwise, "loader: the stream from the arithmetic files differs from the Huffman files' stream")
    check(exact, "loader: a decoded PNG frame differs from the array written")
    check(jpeg_err < LOADER_JPEG_MEAN_ABS, f"loader: the JPEG decodes {jpeg_err:.2f} from its source")
    check(np.array_equal(jpeg, committed), "loader: the smooth JPEG differs from its committed decode")


class _TF32:
    """Set cuDNN's and the matmuls' TF32 flags inside a with block, and put
    back what they were."""

    def __init__(self, allow: bool):
        self.allow = allow

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = self.allow

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


# the packages `ufm infer` must not need: made unimportable while it runs,
# whether or not this machine has them
ENTRY_BLOCKED_IMPORTS = ("cv2", "msgpack", "safetensors", "PIL")


@contextlib.contextmanager
def _blocked_imports(names):
    """Make ``import name`` raise ImportError inside the with block (a None
    entry in sys.modules), and put back what sys.modules held."""
    saved = {n: sys.modules[n] for n in names if n in sys.modules}
    sys.modules.update(dict.fromkeys(names))
    try:
        yield
    finally:
        for n in names:
            if n in saved:
                sys.modules[n] = saved[n]
            else:
                sys.modules.pop(n, None)


def _max_diffs(got: dict, want: dict) -> dict:
    return {k: float(np.abs(got[k].float().cpu().numpy() - want[k]).max()) for k in want}


def phase_fp32_anchor():
    """The repository's two tiny fp32 anchors (UFM-Base, and UFM-Refine on
    the window kernel; head dims 32 and 24: the mma attention forward)
    built from tests/golden/torch_port_fp32_anchor.npz (no JAX here), their
    inputs drawn from seeded_inputs()'s numpy generator: every output within
    FP32_ANCHOR_ATOL of the CPU goldens with TF32 off (held); the gap to the
    goldens the JAX package made on a TPU, and with TF32 on (reported).
    Returns the path's launches {kernel: n}."""
    from ufm_torch.checkpoint import load_jax_params
    from ufm_torch.models import UFMArchConfig, UFMNet
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.ops import window_refinement as wr

    golden_dir = os.path.join(HERE, "tests", "golden")
    with np.load(os.path.join(golden_dir, "torch_port_fp32_anchor.npz")) as z:
        files = {k: z[k] for k in z.files}
    params = {k[len("params/"):]: v for k, v in files.items() if k.startswith("params/")}
    rng = np.random.default_rng(FP32_ANCHOR_SEED)
    i1, i2 = (torch.from_numpy(rng.standard_normal(FP32_ANCHOR_SHAPE).astype(np.float32)).cuda() for _ in range(2))
    fa.LAUNCHES = fa.ANY_LAUNCHES = wr.LAUNCHES = 0  # this path's counts start here
    for name in FP32_ANCHORS:
        cfg = json.loads(str(files[f"config/{name}"]))
        with torch.device("cuda"):
            net = UFMNet(UFMArchConfig.from_dict(cfg))
        refine = net.cfg.has_classification_head
        load_jax_params(net, {k: v for k, v in params.items() if refine or not k.startswith("classification")})
        net.refinement_impl = None  # the window kernel (the config's "pallas")
        outs, launched = {}, {}
        for tf32 in (False, True):
            before = (fa.LAUNCHES, fa.ANY_LAUNCHES, wr.LAUNCHES)
            with _TF32(tf32), torch.inference_mode():
                outs[tf32] = net(i1, i2)
            torch.cuda.synchronize()
            launched[tf32] = (fa.LAUNCHES - before[0], fa.ANY_LAUNCHES - before[1], wr.LAUNCHES - before[2])
        layers = cfg["encoder_kwargs"]["depth"] + cfg["info_sharing_kwargs"]["depth"]
        with np.load(os.path.join(golden_dir, f"{name}.npz")) as z:
            cpu = {k: z[k] for k in z.files}
        with np.load(os.path.join(golden_dir, f"{name}_tpu.npz")) as z:
            tpu = {k: z[k] for k in z.files}
        diffs = _max_diffs(outs[False], cpu)
        emit("fp32_anchor", model=name, bar=FP32_ANCHOR_ATOL, max_abs_diff_cpu_golden=diffs,
             max_abs_diff_tpu_golden=_max_diffs(outs[False], tpu),
             max_abs_diff_cpu_golden_tf32_on=_max_diffs(outs[True], cpu),
             launches={"flash_attention_fwd": launched[False][0], "flash_attention_fwd_any": launched[False][1],
                       "window_refinement_fwd": launched[False][2]})
        for tf32 in (False, True):
            check(launched[tf32] == (0, layers, int(refine)),
                  f"fp32 anchor {name}: {launched[tf32]} wgmma / mma / window launches, "
                  f"expected (0, {layers}, {int(refine)})")
        for k, d in diffs.items():
            check(d <= FP32_ANCHOR_ATOL, f"fp32 anchor {name}: {k} differs from the CPU golden by {d:.3e}")
    return {"flash_attention_fwd_any": fa.ANY_LAUNCHES, "window_refinement_fwd": wr.LAUNCHES}


def phase_fp32_path(cls=None, config=None, label="fp32_path", path="ufm_base_fp32"):
    """A model at full width with compute_dtype="float32" (``cls`` on
    ``config``: UFM-Base by default), 480x640 batch 1, through
    predict_correspondences_batched, eagerly and captured: host clock,
    device busy and idle share of a profiled window, peak memory; 36 mma
    attention launches a forward and none of the wgmma kernel (nor of the
    bf16 MLP kernels), 1 window launch for UFM-Refine, no call of a plain
    version; flow against the same model on the plain route (plain
    attention, and the plain window refinement for UFM-Refine) within
    FP32_FLOW_BAR_PX with TF32 off (with cuDNN's TF32 on, the default, the
    heads round their inputs to TF32, which turns the two routes' last-bit
    differences into ~1e-3 relative ones: held within
    FP32_FLOW_BAR_TF32_ON_PX). For UFM-Refine also the refinement's residual
    and log_softmax with the window kernel against the plain window
    refinement on the same inputs (the attention kernels' backbone), TF32
    off, within WINDOW_RESIDUAL_ATOL / WINDOW_LOG_SOFTMAX_ATOL. The modes'
    launches are recorded as ``path`` and ``<path>_captured``."""
    from ufm_torch.models import UniFlowMatchConfidence, base, ufm_base_config
    from ufm_torch.ops import launches as counters

    model = (cls or UniFlowMatchConfidence).from_config(config or ufm_base_config(compute_dtype="float32"), seed=0)
    refine = model.config.has_classification_head
    check(model.config.compute_dtype == "float32", f"{label}: compute dtype {model.config.compute_dtype}")
    src, tgt = np.random.default_rng(0).integers(0, 256, (2, *SERVE_HW, 3), dtype=np.uint8)
    per_call = launch_counts(window_refinement_fwd=int(refine), flash_attention_fwd_any=ANY_PER_FORWARD)

    def request():
        return model.predict_correspondences_batched(source_image=src, target_image=tgt)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, results = {}, {}
    for mode in ("eager", "captured"):
        model.capture_graphs = mode == "captured"
        counters.reset()  # this path's counts start here
        times, calls = [], []
        with unittest.mock.patch.object(base, "_CAPTURE_ERROR_MODE", "global"), _plain_calls() as plain_calls:
            for _ in range(4):  # one first call (the captured mode's warm-up and capture), three timed
                before = counters.snapshot()
                t = time.perf_counter()
                res = request()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
                calls.append(counters.since(before))
            record_path(path if mode == "eager" else f"{path}_captured", counters.snapshot(), 0)
            check(all(c == per_call for c in calls), f"{label} {mode}: launches per call {calls}, expected {per_call}")
            check(plain_calls == {"attention": 0, "window": 0}, f"{label} {mode} called plain versions: {plain_calls}")
            profiled, counts = _profile_requests(request)
        want = {"flash_attention_fwd_any_kernel": ANY_PER_FORWARD * PROFILE_REQUESTS,
                **({"window_refinement_fwd_kernel": PROFILE_REQUESTS} if refine else {})}
        check(counts == want, f"{label} {mode}: the profiler saw {counts} in {PROFILE_REQUESTS} requests, expected {want}")
        flow = res.flow.flow_output
        check(tuple(flow.shape) == (1, 2, *SERVE_HW) and _finite(flow), f"{label} {mode}: flow {tuple(flow.shape)}")
        results[mode] = res
        rows[mode] = dict(first_s=times[0], latency_s=statistics.median(times[1:]), launches_per_call=calls,
                          profiled=profiled)
    peak = torch.cuda.max_memory_allocated()
    model.capture_graphs = False
    flows = {}
    for tf32 in (False, True):
        with _TF32(tf32):
            for impl in (None, "torch"):
                model.attention_impl = impl
                if refine:
                    model.refinement_impl = impl
                before = counters.snapshot()
                flows[tf32, impl] = request().flow.flow_output.float()
                torch.cuda.synchronize()
                launched = counters.since(before)
                check(launched == (launch_counts() if impl else per_call),
                      f"{label} TF32 {tf32} route {impl}: launches {launched}")
    model.attention_impl = None
    fields = {}
    if refine:
        model.refinement_impl = None
        fields = _window_vs_plain(model, src, tgt)
    diff_px = (flows[False, None] - flows[False, "torch"]).abs().max().item()
    diff_on_px = (flows[True, None] - flows[True, "torch"]).abs().max().item()
    f_k, f_c = (r.flow.flow_output.float() for r in (results["eager"], results["captured"]))
    captured_diff_px = (f_c - f_k).abs().max().item()
    emit(label, model=type(model).__name__, compute_dtype=model.config.compute_dtype, input_hw=list(SERVE_HW), batch=1,
         max_memory_allocated=peak, flow_max_abs_diff_px_vs_plain_tf32_off=diff_px, bar_px=FP32_FLOW_BAR_PX,
         flow_max_abs_diff_px_vs_plain_tf32_on=diff_on_px, bar_tf32_on_px=FP32_FLOW_BAR_TF32_ON_PX,
         flow_max_abs_diff_px_captured_vs_eager=captured_diff_px, flow_abs_max_px=f_k.abs().max().item(),
         **fields, **rows)
    check(diff_px <= FP32_FLOW_BAR_PX, f"{label}: flow {diff_px:.3e} px from the plain route")
    check(diff_on_px <= FP32_FLOW_BAR_TF32_ON_PX, f"{label}, TF32 on: flow {diff_on_px:.3e} px from the plain route")
    check(captured_diff_px <= FP32_FLOW_BAR_PX, f"{label}: captured flow {captured_diff_px:.3e} px from eager")
    if refine:
        check(fields["residual_max_abs_err"] <= WINDOW_RESIDUAL_ATOL and
              fields["log_softmax_max_abs_err"] <= WINDOW_LOG_SOFTMAX_ATOL,
              f"{label}: the window kernel vs the plain window refinement: {fields}")
    del model, results, flows
    _free_card_memory()


def _window_vs_plain(model, src, tgt):
    """An eager request of a UFM-Refine model with the window kernel and
    with the plain window refinement, TF32 off: the refinement's residual
    and log_softmax (read through a wrapper of ``net.refine_tail``) and
    whether the regression flows the windows sit at are the same."""
    refine_tail, refined = model.net.refine_tail, []

    def recording(*args, **kwargs):
        refined.append(refine_tail(*args, **kwargs))
        return refined[-1]

    model.net.refine_tail = recording
    try:
        with _TF32(False):
            for impl in (None, "torch"):
                model.refinement_impl = impl
                model.predict_correspondences_batched(source_image=src, target_image=tgt)
    finally:
        model.refinement_impl = None
        del model.net.refine_tail  # back to the method
    kernel, plain = refined
    return {"residual_max_abs_err": (kernel["refinement_residual"] - plain["refinement_residual"]).abs().max().item(),
            "residual_atol": WINDOW_RESIDUAL_ATOL, "log_softmax_atol": WINDOW_LOG_SOFTMAX_ATOL,
            "log_softmax_max_abs_err":
                (kernel["refinement_log_softmax"] - plain["refinement_log_softmax"]).abs().max().item(),
            "same_regression_flow": torch.equal(kernel["regression_flow"], plain["regression_flow"])}


def phase_entry():
    """`ufm infer` as a user calls it (``ufm_torch.cli.main`` in this
    process) on the bundled parallax pair (written and read by the port's
    PNG codec) with the trained tiny checkpoint (``params.msgpack``, decoded
    by the port), with ENTRY_BLOCKED_IMPORTS unimportable while it runs
    (whether cv2 and msgpack are installed here is reported); the panels it
    writes decoded by the port's reader; its flow (recorded from the
    predict call) against the port's CPU run of the same checkpoint on the
    same pair, with TF32 off (held within ENTRY_FLOW_BAR_PX) and on, the
    default (held within ENTRY_FLOW_BAR_TF32_ON_PX). Returns the path's
    mma launches."""
    import importlib.util
    import io

    from ufm_torch import cli
    from ufm_torch.models import UniFlowMatchConfidence
    from ufm_torch.models.base import UniFlowMatchModelsBase
    from ufm_torch.ops import flash_attention as fa
    from ufm_torch.utils.example_pairs import ensure_bundled_pairs
    from ufm_torch.utils.image_io import read_png, read_rgb

    importable = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "msgpack")}
    pairs = ensure_bundled_pairs(os.path.join(ARTIFACT_DIR, "pairs"))
    src_path, tgt_path = (os.path.join(pairs, f"parallax_{i}.png") for i in (0, 1))
    predict = UniFlowMatchModelsBase.predict_correspondences_batched
    flows = []

    def recording(self, *args, **kwargs):
        res = predict(self, *args, **kwargs)
        flows.append(res.flow.flow_output[0].float().cpu())
        return res

    runs = {}
    fa.LAUNCHES = fa.ANY_LAUNCHES = 0  # this path's counts start here
    for tf32 in (False, True):
        out_dir = os.path.join(ARTIFACT_DIR, f"infer_tf32_{'on' if tf32 else 'off'}")
        log = io.StringIO()
        before = fa.ANY_LAUNCHES
        t = time.perf_counter()
        try:
            with _TF32(tf32), contextlib.redirect_stdout(log), _blocked_imports(ENTRY_BLOCKED_IMPORTS), \
                    unittest.mock.patch.object(UniFlowMatchModelsBase, "predict_correspondences_batched", recording):
                cli.main(["infer", src_path, tgt_path, "--checkpoint", TINY_REAL, "-o", out_dir])
        except SystemExit as e:
            check(False, f"ufm infer exited {e.code}:\n{log.getvalue()}")
        seconds = time.perf_counter() - t
        panels = {name: read_png(os.path.join(out_dir, name)) for name in cli.OUTPUT_FILES}
        runs[tf32] = dict(seconds=seconds, launches=fa.ANY_LAUNCHES - before, flow=flows[-1],
                          panels={n: [list(p.shape), str(p.dtype)] for n, p in panels.items()},
                          said=log.getvalue().strip().splitlines())
        check(all(p.shape == (540, 720, 3) and p.dtype == np.uint8 for p in panels.values()),
              f"ufm infer panels: {runs[tf32]['panels']}")
    cpu_model = UniFlowMatchConfidence.from_pretrained(TINY_REAL, device="cpu")
    cpu_flow = cpu_model.predict_correspondences_batched(source_image=read_rgb(src_path),
                                                         target_image=read_rgb(tgt_path)).flow.flow_output[0]
    layers = cpu_model.config.encoder_kwargs["depth"] + cpu_model.config.info_sharing_kwargs["depth"]
    diffs = {tf32: (runs[tf32]["flow"] - cpu_flow).abs().max().item() for tf32 in runs}
    emit("entry", command="ufm_torch.cli.main(['infer', parallax_0.png, parallax_1.png, '--checkpoint', "
         "'examples/checkpoints/tiny_real224', '-o', DIR])", importable=importable,
         imports_blocked_during_infer=list(ENTRY_BLOCKED_IMPORTS),
         flow_max_abs_diff_px_vs_cpu_tf32_off=diffs[False], flow_max_abs_diff_px_vs_cpu_tf32_on=diffs[True],
         bar_px=ENTRY_FLOW_BAR_PX, bar_tf32_on_px=ENTRY_FLOW_BAR_TF32_ON_PX, cpu_flow_abs_max_px=cpu_flow.abs().max().item(),
         **{f"tf32_{'on' if k else 'off'}": {n: v for n, v in r.items() if n != "flow"} for k, r in runs.items()})
    for tf32, r in runs.items():
        check(r["launches"] == layers, f"ufm infer: {r['launches']} mma attention launches, expected {layers}")
    check(diffs[False] <= ENTRY_FLOW_BAR_PX, f"ufm infer: flow {diffs[False]:.3e} px from the CPU run")
    check(diffs[True] <= ENTRY_FLOW_BAR_TF32_ON_PX, f"ufm infer, TF32 on: flow {diffs[True]:.3e} px from the CPU run")
    return fa.ANY_LAUNCHES


def phase_jpeg_entry():
    """UFM-Base from JPEG files through the entry points, with
    ENTRY_BLOCKED_IMPORTS (cv2, PIL, ...) unimportable: ``ufm infer`` on the
    committed 1080x1920 pair with seeded random weights (``--random-init``)
    in this process, its inputs bitwise ``read_rgb``'s arrays and its flow
    (recorded from the predict call) bitwise a direct predict of a model
    built the same way on them; then a JSON request carrying the JPEG bytes
    to a ``UFMServer`` at lanes of SERVE_MAX_BATCH on that model, answered
    bitwise as the lane program's slot 0 (a batch of copies of the pair).
    ``ufm infer`` on the arithmetic pair the same way, its flow bitwise the
    Huffman pair's; a JSON request whose source is frame 0 cut to 90% of its
    bytes answered 400 naming its key (cv2.imdecode's None). A lossless JPEG
    (SOF3: predictor 5, restart intervals) read by ``read_rgb`` and
    ``decode_rgb`` bitwise its encoded samples, then sent as both images of a
    JSON request, answered bitwise as the lane program's slot 0 on those
    samples. Each path: 36 attention and 36 fused fc1 + GELU launches a
    forward, no plain call (paths ``ufm_infer_jpeg``, ``ufm_infer_jpeg_arith``,
    ``ufm_base_jpeg_served``, ``ufm_base_jpeg_lossless_served``)."""
    import base64
    import io
    import urllib.error

    from ufm_torch import cli
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.models.base import UniFlowMatchModelsBase
    from ufm_torch.ops import launches as counters
    from ufm_torch.runtime import UFMServer
    from ufm_torch.utils.image_io import decode_rgb, read_png, read_rgb

    src_path, tgt_path = (os.path.join(JPEG_PAIR, n) for n in JPEG_PAIR_FILES)
    lossless_path = os.path.join(JPEG_LOSSLESS, "lossless_p5_rst.jpg")
    with open(lossless_path, "rb") as f:
        lossless = f.read()
    with np.load(os.path.join(JPEG_LOSSLESS, "samples.npz")) as z:
        lossless_samples = z["rgb"]
    out_dir = os.path.join(ARTIFACT_DIR, "infer_jpeg")
    predict = UniFlowMatchModelsBase.predict_correspondences_batched
    calls = []

    def recording(self, *args, **kwargs):
        res = predict(self, *args, **kwargs)
        calls.append((kwargs["source_image"].copy(), kwargs["target_image"].copy(), res.flow.flow_output.clone(),
                      res.covisibility.mask.clone()))
        return res

    log = io.StringIO()
    per_forward = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, linear_gelu_bf16_fwd=GELU_PER_FORWARD)

    def infer(src, tgt, out):  # seconds, launches, plain calls of one ``ufm infer``
        counters.reset()  # the infer path's counts start here
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log), _plain_calls() as plain, \
                    unittest.mock.patch.object(UniFlowMatchModelsBase, "predict_correspondences_batched", recording):
                cli.main(["infer", src, tgt, "--random-init", "-o", out])
        except SystemExit as e:
            check(False, f"ufm infer exited {e.code}:\n{log.getvalue()}")
        torch.cuda.synchronize()
        return time.perf_counter() - t, counters.snapshot(), plain

    with _blocked_imports(ENTRY_BLOCKED_IMPORTS):
        infer_s, infer_launched, infer_plain = infer(src_path, tgt_path, out_dir)
        panels = {name: list(read_png(os.path.join(out_dir, name)).shape) for name in cli.OUTPUT_FILES}
        src, tgt = read_rgb(src_path), read_rgb(tgt_path)
        model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)
        direct = model.predict_correspondences_batched(source_image=src, target_image=tgt)
        check(len(calls) == 1, f"ufm infer made {len(calls)} predict calls")
        got_src, got_tgt, infer_flow, _ = calls[0]
        inputs_bitwise = np.array_equal(got_src, src) and np.array_equal(got_tgt, tgt)
        infer_bitwise = torch.equal(infer_flow, direct.flow.flow_output)
        infer_diff = (infer_flow.float() - direct.flow.flow_output.float()).abs().max().item()
        arith_s, arith_launched, arith_plain = infer(*(os.path.join(JPEG_PAIR_ARITH, n) for n in JPEG_PAIR_FILES),
                                                     out_dir + "_arith")
        check(len(calls) == 2, f"ufm infer on the arithmetic pair made {len(calls) - 1} predict calls")
        arith_bitwise = torch.equal(calls[1][2], infer_flow) and torch.equal(calls[1][3], calls[0][3])

        body = json.dumps({key: base64.b64encode(open(path, "rb").read()).decode()
                           for key, path in (("source_png_b64", src_path), ("target_png_b64", tgt_path))}).encode()
        server = UFMServer(model, port=0, max_batch=SERVE_MAX_BATCH, max_delay_ms=SERVE_MAX_DELAY_MS)
        server.start()
        try:
            t = time.perf_counter()
            _http(server.port, "/v1/predict", body, "application/json")  # the lane's first batch captures its program
            warm_s = time.perf_counter() - t
            counters.reset()  # the served path's counts start here
            with _plain_calls() as served_plain:
                t = time.perf_counter()
                raw = _http(server.port, "/v1/predict", body, "application/json")
                served_s = time.perf_counter() - t
            served_launched = counters.snapshot()
            with open(src_path, "rb") as f:
                whole = f.read()
            cut_body = json.dumps({"source_png_b64": base64.b64encode(whole[:len(whole) * 9 // 10]).decode(),
                                   "target_png_b64": json.loads(body)["target_png_b64"]}).encode()
            cut_status, cut_error = 200, ""
            try:
                _http(server.port, "/v1/predict", cut_body, "application/json")
            except urllib.error.HTTPError as e:
                cut_status, cut_error = e.code, json.loads(e.read())["error"]
            # the lossless file: both decoders, then a request (its lane's first batch captures)
            lossless_read_bitwise = np.array_equal(read_rgb(lossless_path), lossless_samples)
            lossless_decode_bitwise = np.array_equal(decode_rgb(lossless, name="lossless.jpg"), lossless_samples)
            lossless_body = json.dumps({key: base64.b64encode(lossless).decode()
                                        for key in ("source_png_b64", "target_png_b64")}).encode()
            _http(server.port, "/v1/predict", lossless_body, "application/json")
            counters.reset()  # the lossless request's counts start here
            with _plain_calls() as lossless_plain:
                lossless_raw = _http(server.port, "/v1/predict", lossless_body, "application/json")
            lossless_launched = counters.snapshot()
        finally:
            server.close()
    with np.load(io.BytesIO(raw)) as z:
        served = {k: z[k] for k in z.files}
    copies = model.predict_correspondences_batched(np.stack([src] * SERVE_MAX_BATCH), np.stack([tgt] * SERVE_MAX_BATCH))
    served_bitwise = (np.array_equal(served["flow"], copies.flow.flow_output[0].float().cpu().numpy())
                      and np.array_equal(served["covisibility"], copies.covisibility.mask[0].cpu().numpy()))
    with np.load(io.BytesIO(lossless_raw)) as z:
        lossless_served = {k: z[k] for k in z.files}
    lossless_copies = model.predict_correspondences_batched(np.stack([lossless_samples] * SERVE_MAX_BATCH),
                                                            np.stack([lossless_samples] * SERVE_MAX_BATCH))
    lossless_flow = lossless_served["flow"]
    lossless_served_bitwise = (
        np.array_equal(lossless_flow, lossless_copies.flow.flow_output[0].float().cpu().numpy())
        and np.array_equal(lossless_served["covisibility"], lossless_copies.covisibility.mask[0].cpu().numpy()))
    emit("jpeg_entry", files=list(JPEG_PAIR_FILES), input_hw=list(src.shape[:2]),
         imports_blocked=list(ENTRY_BLOCKED_IMPORTS), infer_command="ufm_torch.cli.main(['infer', frame0.jpg, "
         "frame1.jpg, '--random-init', '-o', DIR])", infer_s=infer_s, infer_panels=panels,
         infer_inputs_bitwise_read_rgb=bool(inputs_bitwise), infer_flow_bitwise_direct=bool(infer_bitwise),
         infer_flow_max_abs_diff_px=infer_diff, infer_launches=infer_launched,
         infer_plain_calls=infer_plain, served_warm_up_s=warm_s, served_request_s=served_s,
         served_bitwise_lane_slot0=bool(served_bitwise), served_launches=served_launched,
         served_plain_calls=served_plain, arith_files=[os.path.relpath(JPEG_PAIR_ARITH, HERE)], arith_infer_s=arith_s,
         arith_infer_flow_bitwise_huffman=bool(arith_bitwise),
         arith_infer_launches=arith_launched, arith_infer_plain_calls=arith_plain,
         cut_request_bytes=len(whole) * 9 // 10, cut_request_status=cut_status, cut_request_error=cut_error,
         lossless_file=os.path.relpath(lossless_path, HERE), lossless_bytes=len(lossless),
         lossless_hw=list(lossless_samples.shape[:2]), lossless_read_rgb_bitwise_samples=bool(lossless_read_bitwise),
         lossless_decode_rgb_bitwise_samples=bool(lossless_decode_bitwise),
         lossless_served_bitwise_lane_slot0=bool(lossless_served_bitwise),
         lossless_flow_shape=list(lossless_flow.shape), lossless_flow_finite=bool(np.isfinite(lossless_flow).all()),
         lossless_launches=lossless_launched, lossless_plain_calls=lossless_plain)
    check(all(shape == [*src.shape[:2], 3] for shape in panels.values()), f"ufm infer panels: {panels}")
    check(inputs_bitwise, "ufm infer: its input arrays differ from read_rgb's")
    check(infer_bitwise, f"ufm infer: flow {infer_diff:.3e} px from the direct predict")
    check(served_bitwise, "jpeg served: the response differs from the lane program's answer at slot 0")
    check(arith_bitwise, "ufm infer: the arithmetic pair's flow differs from the Huffman pair's")
    check(cut_status == 400 and "source_png_b64" in cut_error and "EOI" in cut_error,
          f"jpeg served: a cut JPEG answered {cut_status} {cut_error!r}")
    check(lossless_read_bitwise and lossless_decode_bitwise,
          f"lossless JPEG: read_rgb {lossless_read_bitwise}, decode_rgb {lossless_decode_bitwise} bitwise its samples")
    check(lossless_served_bitwise and np.isfinite(lossless_flow).all(),
          f"lossless JPEG served: flow {list(lossless_flow.shape)} differs from the lane program's answer at slot 0")
    for label, plain, launched in (("ufm infer", infer_plain, infer_launched),
                                   ("jpeg served", served_plain, served_launched),
                                   ("ufm infer arith", arith_plain, arith_launched),
                                   ("lossless jpeg served", lossless_plain, lossless_launched)):
        check(plain == {"attention": 0, "window": 0}, f"{label} called plain versions: {plain}")
        check(launched == per_forward, f"{label}: launches {launched}, expected {per_forward}")
    record_path("ufm_infer_jpeg", infer_launched, GELU_PER_FORWARD)
    record_path("ufm_infer_jpeg_arith", arith_launched, GELU_PER_FORWARD)
    record_path("ufm_base_jpeg_served", served_launched, GELU_PER_FORWARD)
    record_path("ufm_base_jpeg_lossless_served", lossless_launched, GELU_PER_FORWARD)
    del model
    _free_card_memory()


def _model_hw(config):
    """(H, W) of a config's first inference resolution ((W, H) pairs, or one)."""
    res = config.inference_resolution
    w, h = res if isinstance(res[0], int) else res[0]
    return int(h), int(w)


def _step_grads(model, batch):
    """Each optimizer group's gradient of one forward + loss + backward of
    ``model.net`` on ``batch``, as one vector a group."""
    from ufm_torch.training import ufm_total_loss

    net = model.net
    net.zero_grad(set_to_none=True)
    loss, _ = ufm_total_loss(net(batch["img1"], batch["img2"]), batch)
    loss.backward()
    torch.cuda.synchronize()
    grads = _group_grads(net)
    net.zero_grad(set_to_none=True)
    return grads


def _rel_l2(got, want):
    return {k: ((got[k] - want[k]).norm() / want[k].norm()).item() for k in want}


def _kernel_vs_plain_grads(model, batch, label, launches_each, bound, **fields):
    """Each optimizer group's gradient of one forward + loss + backward on
    ``batch`` through the kernels (their launches held to ``launches_each``,
    by kernel name) and on plain attention (no attention launch):
    the relative L2, emitted as phase ``label`` (with the plain pass's peak
    memory and ``fields``), then each held within ``bound``."""
    from ufm_torch.ops import launches

    before = launches.snapshot()
    g_kernel = _step_grads(model, batch)
    kernel_launched = launches.since(before)
    check(kernel_launched == launches_each,
          f"{label} kernel gradient: launches {kernel_launched}, expected {launches_each}")
    model.attention_impl = "torch"
    before = launches.snapshot()
    torch.cuda.reset_peak_memory_stats()
    g_plain = _step_grads(model, batch)
    plain_peak = torch.cuda.max_memory_allocated()
    launched = launches.since(before)
    check(all(launched[i] == 0 for i in ATTENTION_AT), f"{label}: the plain-attention gradient launched {launched}")
    model.attention_impl = None
    check(set(g_plain) == set(g_kernel), f"{label}: gradient groups differ: {sorted(g_kernel)} vs {sorted(g_plain)}")
    rel = _rel_l2(g_kernel, g_plain)
    emit(label, batch=int(batch["img1"].shape[0]), grad_rel_l2=rel, bound=bound,
         plain_max_memory_allocated=plain_peak, launches=kernel_launched, **fields)
    for k, r in rel.items():
        check(r <= bound, f"{label} kernel vs plain gradient, group {k}: relative L2 {r:.3e} > {bound}")


def phase_fp32_train():
    """UFM-Base in fp32 (``ufm_base_config(compute_dtype="float32")``: no
    fp32 masters, no bf16 MLP kernels) at TRAIN_BATCH, TRAIN_HW, through
    make_train_step for TRAIN_STEPS, then fit for FIT_STEPS (the bf16 train
    phase's schedule): each step 36 mma forward launches and 36 mma
    backward calls and none of the wgmma attention, GELU or fused fc1 + GELU
    kernels; finite metrics, a falling loss; the spans (forward + loss,
    backward, optimizer), step ms, pairs/s and peak memory. Then at batch 1,
    TF32 off, each group's gradient against plain attention within
    FP32_TRAIN_GRAD_REL_L2_BOUND. Returns the path's mma launches."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_base_config
    from ufm_torch.ops import launches as counters
    from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch

    t0 = time.perf_counter()
    model = UniFlowMatchConfidence.from_config(ufm_base_config(compute_dtype="float32"), seed=0)
    net = model.net
    batch = synthetic_batch(TRAIN_BATCH, *TRAIN_HW, seed=0, device="cuda")
    optimizer = make_optimizer(net, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL_STEPS)
    step = make_train_step(net, optimizer)
    check(all(p.dtype == torch.float32 for p in net.parameters()), "the fp32 model holds non-fp32 parameters")
    check(not optimizer.masters(), f"the fp32 model's optimizer keeps {len(optimizer.masters())} masters")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    each = launch_counts(flash_attention_fwd_any=ANY_PER_FORWARD, flash_attention_bwd_any=ANY_BWD_PER_STEP)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()  # the fp32 training path's counts start here
    losses, times = [], []

    def run():
        for i in range(TRAIN_STEPS):
            before = counters.snapshot()
            t = time.perf_counter()
            metrics = step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launched = counters.since(before)
            check(launched == each, f"fp32 train step {i}: launches {launched}, expected {each}")
            vals = {k: v.item() for k, v in metrics.items()}
            check(all(np.isfinite(v) for v in vals.values()), f"fp32 train step {i}: non-finite metrics {vals}")
            losses.append(vals["total_loss"])
            emit("fp32_train_step", step=i, seconds=times[-1], **vals)

    spans = _span_ms(net, optimizer, run)
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(times[1:])
    fit_losses = []
    before = counters.snapshot()
    out = fit(net, (batch for _ in range(FIT_STEPS)), num_steps=FIT_STEPS, learning_rate=FIT_LR,
              warmup_steps=0, log_every=1, log_fn=lambda line: None,
              on_metrics=lambda _, vals: fit_losses.append(vals["total_loss"]))
    torch.cuda.synchronize()
    fit_launched = counters.since(before)
    check(out["step"] == FIT_STEPS and len(fit_losses) == FIT_STEPS, f"fp32 fit ran {out['step']} steps")
    check(all(np.isfinite(v) for v in fit_losses), f"fp32 fit: non-finite losses {fit_losses}")
    check(fit_launched == {k: FIT_STEPS * n for k, n in each.items()},
          f"fp32 fit: launches {fit_launched} over {FIT_STEPS} steps")
    trajectory = losses + fit_losses
    check(trajectory[-1] < trajectory[0], f"fp32: the loss did not fall on the fixed batch: {trajectory}")
    snap = counters.snapshot()
    launches = {"train": (snap[ANY_FWD_AT], snap[ANY_BWD_AT])}
    del out, step, optimizer
    _free_card_memory()

    one = {k: v[:1] for k, v in batch.items()}
    counters.reset()
    with _TF32(False):
        _kernel_vs_plain_grads(model, one, "fp32_train_self_check", each, FP32_TRAIN_GRAD_REL_L2_BOUND, tf32=False)
    snap = counters.snapshot()
    launches["self_check"] = (snap[ANY_FWD_AT], snap[ANY_BWD_AT])
    emit("fp32_train", model="ufm_base", compute_dtype=model.config.compute_dtype, batch=TRAIN_BATCH,
         input_hw=list(TRAIN_HW), setup_s=setup_s, learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
         fit_learning_rate=FIT_LR, steps=TRAIN_STEPS + FIT_STEPS, launches_per_step=each,
         first_step_s=times[0], step_ms=step_s * 1e3, pairs_per_s=TRAIN_BATCH / step_s, spans_ms=spans,
         max_memory_allocated=peak, loss_trajectory=trajectory)
    del model, batch, one
    _free_card_memory()
    return launches


def phase_fine_tune():
    """Fine-tuning the trained tiny checkpoint (fp32, D = 32 / 24):
    ``from_pretrained`` on the card and on the CPU, then ``fit`` for
    FINE_TUNE_STEPS on one seeded batch at the checkpoint's resolution, TF32
    off: each card step 4 mma forward launches and 4 backward calls and
    none of the wgmma kernels, each step's loss within FINE_TUNE_LOSS_REL of
    the CPU run's. Then the tiny config in bf16 (D = 32 / 24: the mma
    kernels in bf16) takes one train step on the card: its gradients within
    TRAIN_GRAD_REL_L2_BOUND of plain attention a group at a time, its fused
    fc1 + GELU and GELU gradient kernels launched once an MLP a pass.
    Returns the paths' mma launches."""
    from ufm_torch.models import UniFlowMatchConfidence, ufm_tiny_config
    from ufm_torch.ops import launches as counters
    from ufm_torch.training import fit, make_optimizer, make_train_step, synthetic_batch

    runs = {}
    batch = None
    with _TF32(False):
        for where in ("cpu", "cuda"):
            model = UniFlowMatchConfidence.from_pretrained(TINY_REAL, device=where)
            layers = model.config.encoder_kwargs["depth"] + model.config.info_sharing_kwargs["depth"]
            if batch is None:
                batch = synthetic_batch(FINE_TUNE_BATCH, *_model_hw(model.config), seed=0, device="cpu")
            losses, counts = [], []
            counters.reset()

            def on_metrics(_, vals, losses=losses, counts=counts):
                losses.append(vals["total_loss"])
                counts.append(counters.snapshot())

            t = time.perf_counter()
            out = fit(model.net, (batch for _ in range(FINE_TUNE_STEPS)), num_steps=FINE_TUNE_STEPS,
                      learning_rate=FINE_TUNE_LR, warmup_steps=0, log_every=1, log_fn=lambda line: None,
                      on_metrics=on_metrics)
            seconds = time.perf_counter() - t
            check(out["step"] == FINE_TUNE_STEPS and len(losses) == FINE_TUNE_STEPS, f"fine-tune on {where}: {out['step']}")
            per_step = [{k: n - p[k] for k, n in c.items()} for c, p in zip(counts, [launch_counts()] + counts[:-1])]
            runs[where] = dict(seconds=seconds, losses=losses, launches_per_step=per_step)
            del model, out
    want = launch_counts(flash_attention_fwd_any=layers, flash_attention_bwd_any=layers)
    check(all(c == want for c in runs["cuda"]["launches_per_step"]),
          f"fine-tune on the card: launches per step {runs['cuda']['launches_per_step']}, expected {want}")
    check(not any(any(c.values()) for c in runs["cpu"]["launches_per_step"]), "fine-tune on the CPU launched a kernel")
    rel = [abs(c - p) / abs(p) for c, p in zip(runs["cuda"]["losses"], runs["cpu"]["losses"])]
    launches = {"fine_tune": sum(c[ANY_FWD_AT] for c in runs["cuda"]["launches_per_step"]),
                "fine_tune_bwd": sum(c[ANY_BWD_AT] for c in runs["cuda"]["launches_per_step"])}
    emit("fine_tune", checkpoint="examples/checkpoints/tiny_real224", batch=FINE_TUNE_BATCH,
         input_hw=[int(x) for x in batch["img1"].shape[1:3]], steps=FINE_TUNE_STEPS, learning_rate=FINE_TUNE_LR,
         tf32=False, loss_rel_diff=rel, bar=FINE_TUNE_LOSS_REL, **runs)
    for i, r in enumerate(rel):
        check(np.isfinite(r) and r <= FINE_TUNE_LOSS_REL, f"fine-tune step {i}: loss {r:.3e} from the CPU run's, relative")

    # the tiny config in bf16: one train step through the mma kernels in bf16
    model = UniFlowMatchConfidence.from_config(ufm_tiny_config(compute_dtype="bfloat16"), seed=0)
    layers = model.config.encoder_kwargs["depth"] + model.config.info_sharing_kwargs["depth"]
    h, w = _model_hw(model.config)
    bf16_batch = synthetic_batch(FINE_TUNE_BATCH, h, w, seed=1, device="cuda")
    counters.reset()
    each = launch_counts(linear_gelu_bf16_fwd=layers, flash_attention_fwd_any=layers, flash_attention_bwd_any=layers,
                         linear_gelu_bf16_bwd=layers)
    _kernel_vs_plain_grads(model, bf16_batch, "tiny_bf16_self_check", each, TRAIN_GRAD_REL_L2_BOUND)
    optimizer = make_optimizer(model.net, learning_rate=1e-4, warmup_steps=0, total_steps=10)
    before = counters.snapshot()
    metrics = {k: v.item() for k, v in make_train_step(model.net, optimizer)(bf16_batch).items()}
    torch.cuda.synchronize()
    launched = counters.since(before)
    check(launched == each, f"tiny bf16 train step: launches {launched}, expected {each}")
    check(all(np.isfinite(v) for v in metrics.values()), f"tiny bf16 train step: non-finite metrics {metrics}")
    counts = counters.snapshot()
    # the kernel and the plain gradients, then the step
    mlp_path("ufm_tiny_bf16_train", counts, 3 * layers, fused_backward=3 * layers)
    launches["tiny_bf16_train"], launches["tiny_bf16_train_bwd"] = counts[ANY_FWD_AT], counts[ANY_BWD_AT]
    emit("tiny_bf16_train", compute_dtype="bfloat16", head_dims=[
        model.config.encoder_kwargs["embed_dim"] // model.config.encoder_kwargs["num_heads"],
        model.config.info_sharing_kwargs["dim"] // model.config.info_sharing_kwargs["num_heads"]],
        batch=FINE_TUNE_BATCH, input_hw=[h, w], metrics=metrics, launches_per_step=each)
    del model, optimizer
    _free_card_memory()
    return launches


def phase_uniflowmatch():
    """UniFlowMatch, the variant without the uncertainty head
    (``ufm_base_config(has_uncertainty_head=False)``: the flow head alone),
    at full width: a batch-1 request at SERVE_HW eagerly (36 attention and
    36 fused fc1 + GELU launches) and captured (phase_captured), no
    covisibility, covariance or keypoint confidence in its answer, its flow
    held to plain attention within FLOW_REL_L2_BOUND; a batch-1 artifact
    (phase_artifact_model); training at TRAIN_BATCH on TRAIN_HW
    (phase_model_train: BF16_TRAIN_EACH launches a step, its metrics
    FLOW_ONLY_METRICS, finite, the loss falling over make_train_step's
    steps), its gradients at batch 1 held to plain attention at
    TRAIN_GRAD_REL_L2_BOUND. No call of a plain version on the kernel
    paths."""
    from ufm_torch.models import UniFlowMatch, ufm_base_config
    from ufm_torch.ops import launches as counters

    cfg = ufm_base_config(has_uncertainty_head=False)
    t0 = time.perf_counter()
    model = UniFlowMatch.from_config(cfg, seed=0)
    check(not hasattr(model.net, "uncertainty_head"), "UniFlowMatch built an uncertainty head")
    build_s = time.perf_counter() - t0
    pair = tuple(np.random.default_rng(9).integers(0, 256, (2, *SERVE_HW, 3), dtype=np.uint8))
    per_call = launch_counts(flash_attention_fwd=LAUNCHES_PER_FORWARD, linear_gelu_bf16_fwd=GELU_PER_FORWARD)
    with _plain_calls() as plain_calls:
        rows = phase_captured(model, "uniflowmatch", pair, (1,), refine=False)
        model.capture_graphs = False
        counters.reset()  # the eager request's counts start here
        res = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
        torch.cuda.synchronize()
        eager = counters.snapshot()
    record_path("uniflowmatch", eager, GELU_PER_FORWARD)
    model.attention_impl = "torch"
    plain = model.predict_correspondences_batched(source_image=pair[0], target_image=pair[1])
    model.attention_impl, model.capture_graphs = None, True
    f_k, f_p = res.flow.flow_output.float(), plain.flow.flow_output.float()
    rel = ((f_k - f_p).norm() / f_p.norm()).item()
    empty = {"covisibility": res.covisibility, "keypoint_confidence": res.keypoint_confidence,
             "flow_covariance": res.flow.flow_covariance}
    emit("uniflowmatch", config="ufm_base_config(has_uncertainty_head=False)", build_s=build_s,
         params=sum(p.numel() for p in model.parameters()), input_hw=list(SERVE_HW), batch=1,
         request_ms_captured=rows["b1"]["captured_latency_s"] * 1e3, request_ms_eager=rows["b1"]["eager_latency_s"] * 1e3,
         launches_eager=eager, plain_calls=plain_calls,
         absent_outputs=[k for k, v in empty.items() if v is None], flow_rel_l2_vs_plain_attention=rel,
         bound=FLOW_REL_L2_BOUND)
    check(plain_calls == {"attention": 0, "window": 0}, f"uniflowmatch requests called plain versions: {plain_calls}")
    check(eager == per_call, f"uniflowmatch eager request: launches {eager}, expected {per_call}")
    check(all(v is None for v in empty.values()), f"uniflowmatch answered {[k for k, v in empty.items() if v is not None]}")
    check(tuple(f_k.shape) == (1, 2, *SERVE_HW) and _finite(f_k), f"uniflowmatch flow {tuple(f_k.shape)}")
    check(rel <= FLOW_REL_L2_BOUND, f"uniflowmatch kernel vs plain attention: flow relative L2 {rel:.3e}")
    phase_artifact_model(model, label="uniflowmatch_artifact", path="uniflowmatch_artifact")
    del model, res, plain
    _free_card_memory()
    # its one loss term, the flow's, moves by ~0.1% in these 6 steps at the
    # warm-up's rates: fit's fresh AdamW took it 0.17% up in its first step
    # (NVIDIA H100 80GB HBM3, 700 W), so the fall is held over make_train_step's
    train_model, batch, _ = phase_model_train(UniFlowMatch, cfg, label="uniflowmatch_train", path="uniflowmatch_train",
                                              each=BF16_TRAIN_EACH, metric_names=FLOW_ONLY_METRICS,
                                              falls_through_fit=False)
    one = {k: v[:1] for k, v in batch.items()}
    counters.reset()
    _kernel_vs_plain_grads(train_model, one, "uniflowmatch_train_self_check", BF16_TRAIN_EACH, TRAIN_GRAD_REL_L2_BOUND)
    # the kernel pass and the plain-attention pass each run the 36 MLPs forward and backward
    record_path("uniflowmatch_train_self_check", counters.snapshot(), 2 * GELU_PER_FORWARD,
                fused_backward=2 * GELU_PER_FORWARD)
    del train_model, batch, one
    _free_card_memory()


def phase_refine_fp32():
    """UFM-Refine in fp32 (``ufm_refine_config(compute_dtype="float32")``:
    the mma attention pair beside the window pair): a batch-1 request at
    SERVE_HW eager and captured (phase_fp32_path: 36 mma forward and 1
    window launch a request, none of the wgmma or bf16 MLP kernels, the
    flow within FP32_FLOW_BAR_PX of the plain route with TF32 off, the
    refinement within the window bars); training at TRAIN_BATCH on TRAIN_HW
    (phase_model_train: REFINE_FP32_TRAIN_EACH launches a step); the
    gradients at batch 1 of the seeded model, TF32 off, held to the plain
    window refinement's and to the plain step's with the target classes
    fixed (phase_refine_train_self_check, its witness the plain step with
    fp64 attention) at FP32_TRAIN_GRAD_REL_L2_BOUND."""
    from ufm_torch.models import UniFlowMatchClassificationRefinement, ufm_refine_config
    from ufm_torch.ops import launches as counters

    cfg = ufm_refine_config(compute_dtype="float32")
    phase_fp32_path(UniFlowMatchClassificationRefinement, cfg, label="refine_fp32", path="ufm_refine_fp32")
    trained, _, _ = phase_model_train(config=cfg, label="refine_fp32_train", path="ufm_refine_fp32_train",
                                      each=REFINE_FP32_TRAIN_EACH)
    del trained
    _free_card_memory()
    # the seeded weights, which every run reproduces bitwise: the trained
    # ones differ in the last bits from run to run (the window backward sums
    # df by atomics), and at batch 1 the fp32 gradient is as far from the
    # fp64 witness's as ~1e-3 relative, so a reading on them moves past the
    # bar with no change of the kernels (NVIDIA H100 80GB HBM3, 700 W: 1.566e-3
    # in one run, 4.2e-4 in the next, PERF.md)
    model = UniFlowMatchClassificationRefinement.from_config(cfg, seed=0)
    counters.reset()
    with _TF32(False):
        phase_refine_train_self_check(model, label="refine_fp32_train_self_check", train_each=REFINE_FP32_TRAIN_EACH,
                                      bound=FP32_TRAIN_GRAD_REL_L2_BOUND)
    record_path("ufm_refine_fp32_train_self_check", counters.snapshot(), 0)
    del model
    _free_card_memory()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this check needs a GPU", file=sys.stderr)
        return 1
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    try:
        return run_phases(phase_device())
    finally:
        shutil.rmtree(ARTIFACT_DIR, ignore_errors=True)


def run_phases(smi: str) -> int:
    phase_build()
    rows = phase_kernel()
    any_rows = phase_any_kernel()
    bwd_rows = phase_bwd_kernel()
    any_bwd_rows = phase_any_bwd_kernel()
    window_rows, window_host_us = phase_window_kernel()
    window_bwd_rows = phase_window_bwd_kernel()
    gelu_rows, gelu_host_us, gelu_err = phase_gelu()
    lg_rows, lg_host_us, lg_err = phase_linear_gelu()
    linear_swiglu = phase_linear_swiglu()
    gelu_bwd_rows, gelu_bwd_host_us, gelu_bwd_err = phase_gelu_backward()
    lg_train_rows = phase_linear_gelu_train()
    lg_bwd_rows, lg_bwd_host_us, lg_bwd_err = phase_linear_gelu_backward()
    golden_launches = phase_bf16_golden()
    anchor_launches = phase_fp32_anchor()
    model, pair, kernel_res, launches = phase_main_path()
    phase_self_check(model, pair, kernel_res)
    phase_fused_mlp_model(model)
    phase_checkpoint(model, pair)
    tiled_launches = phase_tiled(model)
    phase_eval(model)
    phase_tf32(model, pair)
    art_path, art, export_launches = phase_export(model)
    art_model, artifact_launches = phase_artifact_predict(model, art, pair)
    phase_serve_artifact(art_path, art_model, pair)
    phase_loader(model)
    del model, kernel_res, art, art_model
    torch.cuda.empty_cache()
    cpu_export_launches = phase_export_cpu()
    torch.cuda.empty_cache()
    from ufm_torch.models import UniFlowMatchClassificationRefinement, UniFlowMatchConfidence, ufm_base_config, ufm_refine_config

    model = UniFlowMatchConfidence.from_config(ufm_base_config(), seed=0)  # no program yet
    phase_captured(model, "ufm_base", pair, CAPTURED_BASE_BATCHES, refine=False)
    phase_batch_rows(model)
    phase_serve(model)
    phase_stream(model)
    del model
    torch.cuda.empty_cache()
    refine_model, refine_pair, refine_res, refine_launches = phase_refine_path()
    phase_captured(refine_model, "ufm_refine", refine_pair, (1,), refine=True)
    phase_refine_self_check(refine_model, refine_pair, refine_res)
    phase_artifact_model(refine_model)
    phase_serve(refine_model, label="refine_serve", path="ufm_refine_served")
    phase_stream(refine_model, label="refine_stream", path="ufm_refine_streamed")
    tiled_refine_launches = phase_tiled_refine(refine_model)
    del refine_model, refine_res
    _free_card_memory()
    phase_artifact_batch4()
    phase_uniflowmatch()
    phase_fp32_path()
    entry_launches = phase_entry()
    phase_jpeg_entry()
    train_model, train_batch, train_launches = phase_train()
    phase_train_self_check(train_model, train_batch)
    del train_model, train_batch
    _free_card_memory()
    refine_train_model, _, _ = phase_model_train()
    phase_refine_train_self_check(refine_train_model)
    del refine_train_model
    _free_card_memory()
    phase_wide_refine()
    import torch.distributed as dist

    _world1_group()
    try:
        phase_sharded_train()
        phase_sharded_train(UniFlowMatchClassificationRefinement, ufm_refine_config(), label="refine_sharded",
                            path="ufm_refine_sharded_train", each=REFINE_TRAIN_EACH, with_fit=False)
        dp_launches = phase_data_parallel()
    finally:
        dist.destroy_process_group()
    phase_remat()
    phase_remat(UniFlowMatchClassificationRefinement, ufm_refine_config(), cases=REFINE_REMAT_CASES,
                label="refine_remat", path="ufm_refine_remat")
    moge_launches = phase_moge()
    from ufm_torch.ops import flash_attention as fa

    # every bf16 D = 64 training path since phase_model_train reset the counts
    emit("bf16_training_paths", mma_backward_launches=fa.ANY_BWD_LAUNCHES)
    check(fa.ANY_BWD_LAUNCHES == 0, f"the bf16 D = 64 training paths made {fa.ANY_BWD_LAUNCHES} mma backward calls")
    fp32_train_launches = phase_fp32_train()
    phase_refine_fp32()
    fine_tune_launches = phase_fine_tune()

    # one batch-1 forward's attention: each number sums its 36 calls
    fwd = [rows[n] for n, _, calls in ATTN_SHAPES for _ in range(calls)]
    # one batch-2 train step's attention backward: each number sums its 36 calls
    bwd = [bwd_rows[n] for n, _, calls in ATTN_BWD_SHAPES for _ in range(calls)]
    attention = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ufm_tpu/ops/flash_attention.py:558",
        "launches": launches + tiled_launches + refine_launches["flash_attention_fwd"]
        + train_launches["flash_attention_fwd"] + golden_launches["flash_attention_fwd"]
        + export_launches + cpu_export_launches + artifact_launches
        + dp_launches["ufm_base"]["flash_attention_fwd"] + dp_launches["ufm_refine"]["flash_attention_fwd"]
        + moge_launches + tiled_refine_launches["flash_attention_fwd"],
        "launches_by_path": {"ufm_base": launches, "ufm_base_tiled": tiled_launches,
                             "ufm_refine": refine_launches["flash_attention_fwd"],
                             "ufm_base_train": train_launches["flash_attention_fwd"],
                             "bf16_golden": golden_launches["flash_attention_fwd"],
                             "ufm_base_artifact": export_launches,
                             "ufm_base_artifact_cpu_export": cpu_export_launches,
                             "ufm_base_artifact_captured": artifact_launches,
                             "ufm_base_data_parallel": dp_launches["ufm_base"]["flash_attention_fwd"],
                             "ufm_refine_data_parallel": dp_launches["ufm_refine"]["flash_attention_fwd"],
                             "ufm_base_moge": moge_launches,
                             "ufm_refine_tiled": tiled_refine_launches["flash_attention_fwd"]},
        "op": "ufm_torch::flash_attention_fwd",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": sum(r["ms"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] for r in fwd),
        "bound_ms": sum(r["bound_ms"] for r in fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in fwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in fwd),
        "per_forward": "times sum the 24 encoder and 12 info-sharing calls of one batch-1 forward",
        "tiled_forward": {k: sum(rows[n][k] for n, _, calls in TILED_ATTN_SHAPES for _ in range(calls))
                          for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "tiled_per_forward": "times sum the 36 calls of one forward of 16 tiles",
        "ms_by_case": {n: r["ms"] for n, r in rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in rows.items()},
        "library_ms_by_case": {n: r["library_ms"] for n, r in rows.items()},
        "train_step_ms_without_lse": sum(r["fwd_ms"] for r in bwd),
        "train_step_ms_with_lse": sum(r["fwd_with_lse_ms"] for r in bwd),
        "host_us_per_launch": bwd_rows["ragged"]["host_us_per_launch"]["fwd"],
    }
    backward = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/flash_attention_bwd.cu",
        "replaces": "ufm_tpu/ops/flash_attention.py:452",
        "launches": train_launches["flash_attention_bwd"],
        "launches_by_path": {"ufm_base_train": train_launches["flash_attention_bwd"]},
        "op": "ufm_torch::flash_attention_bwd",
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
        "ms": sum(r["ms"] for r in bwd),
        "plain_ms": sum(r["plain_ms"] for r in bwd),
        "bound_ms": sum(r["bound_ms"] for r in bwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in bwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in bwd),
        "per_step": "times sum the 24 encoder and 12 info-sharing calls of one batch-2 train step; "
                    "a launch is one backward call (two CUDA kernels: delta, then one grid of dK/dV and dQ blocks)",
        "library": "backward of scaled_dot_product_attention, torch.autograd.grad on the same (B, H, S, D) views",
        "bitwise_repeatable": all(r["bitwise_repeatable"] for r in bwd_rows.values()),
        "host_us_per_launch": bwd_rows["ragged"]["host_us_per_launch"]["bwd"],
    }
    flagship = window_rows["flagship"]
    window = {
        "name": "window_refinement_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/window_refinement_fwd.cu",
        "replaces": "ufm_tpu/ops/window_dots.py:280",
        "replaces_also": "ufm_tpu/ops/window_dots.py:238",
        "launches": refine_launches["window_refinement_fwd"] + golden_launches["window_refinement_fwd"]
        + dp_launches["ufm_refine"]["window_refinement_fwd"] + tiled_refine_launches["window_refinement_fwd"],
        "launches_by_path": {"ufm_refine": refine_launches["window_refinement_fwd"],
                             "ufm_refine_data_parallel": dp_launches["ufm_refine"]["window_refinement_fwd"],
                             "bf16_golden": golden_launches["window_refinement_fwd"],
                             "ufm_refine_tiled": tiled_refine_launches["window_refinement_fwd"]},
        "op": "ufm_torch::window_refinement",
        "max_abs_err": max(max(r["residual_max_abs_err"], r["log_softmax_max_abs_err"]) for r in window_rows.values()),
        "ms": flagship["ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": None,
        "per_forward": "the one call of a batch-1 UFM-Refine forward, (1, 420, 560, 16), P = 5",
        "library_none": "no single PyTorch call computes this function",
        "ms_by_case": {n: r["ms"] for n, r in window_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in window_rows.items()},
        "staged_tile_share_by_case": {n: r["staged_tile_share"] for n, r in window_rows.items()},
        "any_kernel_ms_on_fixed_shapes": {n: r["any_kernel_ms"] for n, r in window_rows.items() if "any_kernel_ms" in r},
        "host_us_per_launch": window_host_us,
    }
    train_case = window_bwd_rows["train"]
    window_bwd = {
        "name": "window_refinement_bwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/window_refinement_bwd.cu",
        "replaces": "ufm_tpu/ops/refinement.py:242",
        "replaces_note": "_fused_refinement_pallas_bwd, the XLA VJP of _fused_refinement_xla (:257) that the JAX "
                         "package runs as its Pallas window kernel's backward (no pallas_call)",
        "launches": 0,
        "launches_by_path": {},
        "op": "ufm_torch::window_refinement_bwd",
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in window_bwd_rows.values()),
        "ms": train_case["ms"],
        "plain_ms": train_case["plain_ms"],
        "bound_ms": train_case["bound_ms"],
        "bound_by": train_case["bound_by"],
        "library_ms": None,
        "parent_route_ms": train_case["parent_route_ms"],
        "per_step": "the one call of a batch-2 UFM-Refine train step, (2, 420, 560, 16), P = 5; a launch is one "
                    "call (three CUDA kernels: the direct and the staged kernel, each with per-tile dbias partials "
                    "of its tiles, then their sum)",
        "library_none": "no single PyTorch call computes this function",
        "parent_route": "autograd over the plain forward (the parent's backward of ufm_torch::window_refinement)",
        "max_abs_err_by_case": {n: r["max_abs_err"] for n, r in window_bwd_rows.items()},
        "tol_by_case": {n: r["tol"] for n, r in window_bwd_rows.items()},
        "bitwise_repeatable_dq_dflow_dbias": all(r["bitwise_repeatable"]["dq"] and r["bitwise_repeatable"]["dflow"]
                                                 and r["bitwise_repeatable"]["dbias"] for r in window_bwd_rows.values()),
        "df_run_to_run_max_abs_diff_by_case": {n: r["df_run_to_run_max_abs_diff"] for n, r in window_bwd_rows.items()},
        "ms_by_case": {n: r["ms"] for n, r in window_bwd_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in window_bwd_rows.items()},
        "staged_tile_share_by_case": {n: r["staged_tile_share"] for n, r in window_bwd_rows.items()},
        "plain_ms_by_case": {n: r["plain_ms"] for n, r in window_bwd_rows.items()},
        "parent_route_ms_by_case": {n: r["parent_route_ms"] for n, r in window_bwd_rows.items()},
    }
    # one batch-1 forward's GELU: each number sums its 36 calls
    gelu_fwd = [gelu_rows[n] for n, _, calls in GELU_SHAPES for _ in range(calls)]
    gelu = {
        "name": "gelu_bf16_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/gelu_bf16_fwd.cu",
        "replaces": "ufm_tpu/ops/gelu.py:106",
        "replaces_note": "fast_exact_gelu is XLA code (one fused elementwise pass on the TPU), not a pallas_call",
        "launches": sum(GELU_LAUNCHES.values()),
        "launches_by_path": dict(GELU_LAUNCHES),
        "op": "ufm_torch::gelu_bf16",
        "max_abs_err": gelu_err,
        "ms": sum(r["ms"] for r in gelu_fwd),
        "plain_ms": sum(r["plain_ms"] for r in gelu_fwd),
        "bound_ms": sum(r["bound_ms"] for r in gelu_fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in gelu_fwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in gelu_fwd),
        "per_forward": "times sum the 24 encoder and 12 info-sharing MLPs of one batch-1 forward",
        "library": "F.gelu(x, approximate='none') on the same bf16 tensor (rounds once: not the JAX package's bits)",
        "replaced_chain_ms": sum(r["chain_ms"] for r in gelu_fwd),
        "ms_by_case": {n: r["ms"] for n, r in gelu_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in gelu_rows.items()},
        "library_ms_by_case": {n: r["library_ms"] for n, r in gelu_rows.items()},
        "host_us_per_launch": gelu_host_us,
        "main_path_note": "every path outside activation checkpointing takes the fused fc1 + GELU kernel; the "
                          "launches here are the forwards under remat (fc1, then this kernel) and their recomputes",
    }
    # one batch-2 train step's GELU gradient: each number sums its 36 calls
    gelu_bwd_step = [gelu_bwd_rows[n] for n, _, calls in GELU_BWD_SHAPES for _ in range(calls)]
    gelu_backward = {
        "name": "gelu_bf16_bwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/gelu_bf16_bwd.cu",
        "replaces": "ufm_tpu/ops/gelu.py:106",
        "replaces_note": "jax.vjp of fast_exact_gelu: XLA's transposed chain (one fused elementwise pass on the TPU), "
                         "no pallas_call and no custom_vjp",
        "launches": sum(GELU_BWD_LAUNCHES.values()),
        "launches_by_path": dict(GELU_BWD_LAUNCHES),
        "op": "ufm_torch::gelu_bf16_bwd",
        "max_abs_err": gelu_bwd_err,
        "ms": sum(r["ms"] for r in gelu_bwd_step),
        "plain_ms": sum(r["plain_ms"] for r in gelu_bwd_step),
        "bound_ms": sum(r["bound_ms"] for r in gelu_bwd_step),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in gelu_bwd_step) else "bytes",
        "library_ms": sum(r["library_ms"] for r in gelu_bwd_step),
        "per_step": "times sum the 24 encoder and 12 info-sharing MLPs of one batch-2 train step",
        "library": "aten.gelu_backward(g, h, approximate='none') on the same tensors (the exact derivative rounded "
                   "once: not the JAX package's bits)",
        "ms_by_case": {n: r["ms"] for n, r in gelu_bwd_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in gelu_bwd_rows.items()},
        "library_ms_by_case": {n: r["library_ms"] for n, r in gelu_bwd_rows.items()},
        "host_us_per_launch": gelu_bwd_host_us,
    }
    # one batch-1 forward's fc1 + GELU: each number sums its 36 calls
    lg_fwd = [lg_rows[n] for n, _, calls in LINEAR_GELU_SHAPES for _ in range(calls)]
    linear_gelu = {
        "name": "linear_gelu_bf16_fwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/linear_gelu_bf16_fwd.cu",
        "replaces": "ufm_tpu/ops/gelu.py:106",
        "replaces_also": "ufm_tpu/nn/layers.py:50",
        "replaces_note": "fast_exact_gelu of fc1's output (XLA code, no pallas_call): the pair fc1 -> GELU of "
                         "every backbone MLP as one kernel",
        "launches": sum(FUSED_LAUNCHES.values()),
        "launches_by_path": dict(FUSED_LAUNCHES),
        "op": "ufm_torch::linear_gelu_bf16",
        "max_abs_err": lg_err,
        "ms": sum(r["ms"] for r in lg_fwd),
        "plain_ms": sum(r["plain_ms"] for r in lg_fwd),
        "bound_ms": sum(r["bound_ms"] for r in lg_fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in lg_fwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in lg_fwd),
        "parent_pair_ms": sum(r["parent_pair_ms"] for r in lg_fwd),
        "linear_only_ms": sum(r["linear_only_ms"] for r in lg_fwd),
        "serial_ms": sum(r["serial_ms"] for r in lg_fwd),
        "cooperative_ms": sum(r["cooperative_ms"] for r in lg_fwd),
        "per_forward": "times sum the 24 encoder and 12 info-sharing MLPs of one batch-1 forward",
        "library": "F.gelu(F.linear(x, w, b), approximate='none'): no single PyTorch call computes fc1 + the exact "
                   "GELU (cuBLASLt's GELU epilogue is the tanh form)",
        "parent_pair": "F.linear + ufm_torch::gelu_bf16, the two kernels this one replaces on the parent's main path",
        "tiled_forward": {k: sum(lg_rows[n][k] for n, _, calls in LINEAR_GELU_TILED_SHAPES for _ in range(calls))
                          for k in ("ms", "parent_pair_ms", "linear_only_ms", "library_ms", "bound_ms")},
        "ms_by_case": {n: r["ms"] for n, r in lg_rows.items() if "ms" in r},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in lg_rows.items() if "ms" in r},
        "host_us_per_launch": lg_host_us,
        "train_step": {k: sum(r["calls_per_step"] * r[k] for r in lg_train_rows.values())
                       for k in ("ms", "with_preact_ms", "fused_forward_backward_ms", "two_op_forward_backward_ms")},
        "train_step_note": "the 36 MLPs of one batch-2 train step: the inference launch, the training launch "
                           "(y and h), and the fused op's forward + backward beside the two-op route's",
    }
    # one batch-2 train step's fc2 input gradient + GELU gradient: each number sums its 36 calls
    lg_bwd_step = [lg_bwd_rows[n] for n, _, calls in LINEAR_GELU_TRAIN_SHAPES for _ in range(calls)]
    linear_gelu_backward = {
        "name": "linear_gelu_bf16_bwd",
        "route": "cuda",
        "source": "ufm_torch/csrc/linear_gelu_bf16_bwd.cu",
        "replaces": "ufm_tpu/ops/gelu.py:106",
        "replaces_also": "ufm_tpu/nn/layers.py:39",
        "replaces_note": "jax.vjp of fast_exact_gelu inside Mlp's backward (XLA code, no pallas_call), with fc2's "
                         "input-gradient product (a bf16 nn.Dense transpose) before it: the pair as one kernel",
        "launches": sum(FUSED_BWD_LAUNCHES.values()),
        "launches_by_path": dict(FUSED_BWD_LAUNCHES),
        "op": "ufm_torch::linear_gelu_bf16_bwd",
        "max_abs_err": lg_bwd_err,
        "ms": sum(r["ms"] for r in lg_bwd_step),
        "plain_ms": sum(r["plain_ms"] for r in lg_bwd_step),
        "bound_ms": sum(r["bound_ms"] for r in lg_bwd_step),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in lg_bwd_step) else "bytes",
        "library_ms": None,
        "library_none": "no single PyTorch call computes a product followed by the GELU's gradient",
        "library_pair_ms": sum(r["library_pair_ms"] for r in lg_bwd_step),
        "library_pair": "g.mm(w2) then aten.gelu_backward(dy, h, approximate='none') (cuBLAS, then the exact "
                        "derivative rounded once: not the JAX package's bits)",
        "parent_pair_ms": sum(r["parent_pair_ms"] for r in lg_bwd_step),
        "parent_pair": "g.mm(w2) then ufm_torch::gelu_bf16_bwd, the two kernels this one replaces on the parent's "
                       "main path",
        "cublas_mm_ms": sum(r["cublas_mm_ms"] for r in lg_bwd_step),
        "issue_floor_ms": sum(r["issue_floor_ms"] for r in lg_bwd_step),
        "serial_ms": sum(r["serial_ms"] for r in lg_bwd_step),
        "rr3_ms": sum(r["rr3_ms"] for r in lg_bwd_step),
        "per_step": "times sum the 24 encoder and 12 info-sharing MLPs of one batch-2 train step",
        "ms_by_case": {n: r["ms"] for n, r in lg_bwd_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in lg_bwd_rows.items()},
        "parent_pair_ms_by_case": {n: r["parent_pair_ms"] for n, r in lg_bwd_rows.items()},
        "host_us_per_launch": lg_bwd_host_us,
    }
    # one batch-1 forward of UFM-Base in fp32: each number sums its 36 calls
    any_fwd = [any_rows[n] for n, *_, calls in ANY_ATTN_CASES for _ in range(calls)]
    any_by_path = {"fp32_anchor": anchor_launches["flash_attention_fwd_any"], "ufm_infer_tiny_real224": entry_launches,
                   "ufm_base_fp32_train": fp32_train_launches["train"][0],
                   "ufm_base_fp32_train_self_check": fp32_train_launches["self_check"][0],
                   "tiny_real224_fine_tune": fine_tune_launches["fine_tune"],
                   "ufm_tiny_bf16_train": fine_tune_launches["tiny_bf16_train"]}
    attention_any = {
        "name": "flash_attention_fwd_any",
        "route": "cuda",
        "source": "ufm_torch/csrc/flash_attention_fwd_any.cu",
        "replaces": "ufm_tpu/ops/flash_attention.py:558",
        "replaces_note": "the rest of the TPU kernel's domain: fp32 and fp16 at any head dim and bf16 at D != 64 "
                         "(bf16 at D = 64 keeps flash_attention_fwd)",
        "launches": sum(any_by_path.values()),
        "launches_by_path": any_by_path,
        "op": "ufm_torch::flash_attention_fwd",
        "max_abs_err": max(r["max_abs_err"] for r in any_rows.values()),
        "ms": sum(r["ms"] for r in any_fwd),
        "plain_ms": sum(r["plain_ms"] for r in any_fwd),
        "bound_ms": sum(r["bound_ms"] for r in any_fwd),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in any_fwd) else "bytes",
        "library_ms": sum(r["library_ms"] for r in any_fwd),
        "fma_bound_ms": sum(r["fma_bound_ms"] for r in any_fwd),
        "per_forward": "times sum the 24 encoder and 12 info-sharing calls of one batch-1 forward of UFM-Base "
                       "in fp32; the bound is fp32 work at 3xTF32 on the tensor cores, 165 TFLOP/s (bf16 and fp16 "
                       "cases: the 989 TFLOP/s tensor-core peak); fma_bound_ms at fp32 FMA's 67 TFLOP/s",
        "library": "scaled_dot_product_attention on the same (B, H, S, D) views",
        "ms_by_case": {n: r["ms"] for n, r in any_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in any_rows.items()},
        "share_of_fma_bound_by_case": {n: r["share_of_fma_bound"] for n, r in any_rows.items()},
        "library_ms_by_case": {n: r["library_ms"] for n, r in any_rows.items()},
        "max_abs_err_by_case": {n: r["max_abs_err"] for n, r in any_rows.items()},
    }
    # one batch-2 train step of UFM-Base in fp32: each number sums its 36 calls
    any_bwd_step = [any_bwd_rows[n] for n, *_, calls in ANY_BWD_CASES for _ in range(calls)]
    any_bwd_by_path = {"ufm_base_fp32_train": fp32_train_launches["train"][1],
                       "ufm_base_fp32_train_self_check": fp32_train_launches["self_check"][1],
                       "tiny_real224_fine_tune": fine_tune_launches["fine_tune_bwd"],
                       "ufm_tiny_bf16_train": fine_tune_launches["tiny_bf16_train_bwd"]}
    backward_any = {
        "name": "flash_attention_bwd_any",
        "route": "cuda",
        "source": "ufm_torch/csrc/flash_attention_bwd_any.cu",
        "replaces": "ufm_tpu/ops/flash_attention.py:452",
        "replaces_note": "the rest of the TPU backward's domain: fp32 and fp16 at any head dim and bf16 at D != 64 "
                         "(bf16 at D = 64 keeps flash_attention_bwd)",
        "launches": sum(any_bwd_by_path.values()),
        "launches_by_path": any_bwd_by_path,
        "op": "ufm_torch::flash_attention_bwd",
        "max_abs_err": max(r["max_abs_err"] for r in any_bwd_rows.values()),
        "ms": sum(r["ms"] for r in any_bwd_step),
        "plain_ms": sum(r["plain_ms"] for r in any_bwd_step),
        "bound_ms": sum(r["bound_ms"] for r in any_bwd_step),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in any_bwd_step) else "bytes",
        "library_ms": sum(r["library_ms"] for r in any_bwd_step),
        "per_step": "times sum the 24 encoder and 12 info-sharing calls of one batch-2 train step of UFM-Base in "
                    "fp32; a launch is one backward call (two CUDA kernels: delta, then one grid of dK/dV and dQ "
                    "blocks); the bound is fp32 work at 3xTF32 on the tensor cores, 165 TFLOP/s (bf16 and fp16 "
                    "cases: the 989 TFLOP/s tensor-core peak); fma_bound_ms at fp32 FMA's 67 TFLOP/s",
        "fma_bound_ms": sum(r["fma_bound_ms"] for r in any_bwd_step),
        "library": "backward of scaled_dot_product_attention, torch.autograd.grad on the same (B, H, S, D) views",
        "bitwise_repeatable": all(r["bitwise_repeatable"] for r in any_bwd_rows.values()),
        "ms_by_case": {n: r["ms"] for n, r in any_bwd_rows.items()},
        "share_of_bound_by_case": {n: r["share_of_bound"] for n, r in any_bwd_rows.items()},
        "share_of_fma_bound_by_case": {n: r["share_of_fma_bound"] for n, r in any_bwd_rows.items()},
        "library_ms_by_case": {n: r["library_ms"] for n, r in any_bwd_rows.items()},
        "max_abs_err_by_case": {n: r["max_abs_err"] for n, r in any_bwd_rows.items()},
    }
    print(smi)
    kernels = [with_recorded_paths(k) for k in (attention, backward, window, window_bwd, gelu, linear_gelu,
                                                attention_any, backward_any, gelu_backward, linear_gelu_backward,
                                                linear_swiglu)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

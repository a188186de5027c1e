#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves, trains, checkpoints and
evaluates on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Setup: print the card's name and power limit, build the port's CUDA
   kernels from ``ops/csrc`` (one ``nvcc`` per source, all at once), load the
   PAMAP2 train split (chunk 512, stride 128, instance normalisation) from
   ``data/pamap2`` onto the card.
2. Kernels: each of the twenty-two kernels against its plain PyTorch twin on the
   card, at the shapes the main paths give it, including edge cases:
   packed attention forward (B=64, T=512, H=4, d=64; d 16/32/128 at T=72
   and 512 on the edge lengths) and backward (B=32: the real batch's lengths
   and 0, 1, 37, 64, 65, 511, T; padded T=72);
   the fused head (M=4, P=12, H=256, C=25, B=64; edge masks; B=5), twice
   bit for bit, each call timed alone with the card kept ahead of the host,
   L2-warm and L2-cold (a 128 MB write between calls); the projection and FFW
   residual-LayerNorm kernels and the feed-forward (``fused_mlp``) pair,
   forward and backward, at N = 32*512 rows with masks at keep 0.8, without
   masks and at keep 0, and at an N that is not a multiple of the 32-row
   tile; the dropout-mask generator, every byte equal to its plain version,
   at the layer's three shapes and purposes, keep 0.8 / 1 / 0 and a size that
   is not a multiple of 4, one mask a launch and the layer's three in one
   launch (``dropout_keep_masks``), its ``[N, 256]`` and ``[N, 2048]``
   shapes and the three-mask launch also timed each call alone (L2-warm and
   L2-cold) beside ``torch.rand < keep``; its SASS (``cuobjdump``) read for
   instructions per Philox call, and its bound the larger of the integer
   bound worked from them and the bytes bound. Backward checks
   compare every output by its max abs error relative to its largest
   magnitude. Times with CUDA events:
   kernel, plain twin, the bound, and, where one PyTorch call computes the
   same function, that call. The twenty-one kernels whose products run as
   3xTF32 on the tensor cores (``packed_attention_fwd``,
   ``packed_attention_bwd``, ``flash_fwd_single``, ``flash_fwd_tiled``,
   ``flash_bwd_fused``, ``flash_bwd_dkv``, ``flash_bwd_dq``,
   ``fused_hybrid_head``, ``ffw_ln_fwd``, ``ffw_ln_bwd``, ``proj_ln_fwd``,
   ``proj_ln_bwd``, ``fused_mlp_fwd``, ``fused_mlp_bwd``, ``lstm_train_fwd``,
   ``lstm_train_bwd``, ``gru_train_fwd``, ``gru_train_bwd``,
   ``grouped_lstm_forward``, ``grouped_lstm_fused``, ``grouped_gru_fused``)
   carry both bounds, a third of the TF32 peak (the unit they run on) and the
   CUDA cores' f32 peak, with their share of the first; ``nvcc -Xptxas -v``'s registers,
   shared memory and spills for them are printed at setup. The two
   residual-LN kernels of each direction and the ``fused_mlp`` backward run
   twice on the same inputs, bit for bit; ``proj_ln_fwd`` is timed L2-warm and
   L2-cold as the head is; the hidden of both FFW residual-LN directions and of
   both ``fused_mlp`` directions is one body's bits on the same inputs, and
   both FFW backwards are held to their twins on the forward kernel's ReLU
   branches, each branch that differs from the twin's own lying within
   rounding of zero.
3. Serve: ``MultimodalFusionModel.from_config(config/base.yaml)`` with seeded
   random weights at full width, ``serving.make_serving_fn`` on batch-64
   requests of real windows (all modalities; one modality missing; short
   lengths). The launch counters must show every encoder's attention and the
   head going through the kernels; the logits must be finite and agree with
   the same weights on the plain path (kernels off). Then p50 latency and
   windows/s over repeated requests, and device time by kernel family
   (torch.profiler) with the device's busy share, the head's own printed.
4. Train: ``train.Trainer`` on the unmodified ``config/base.yaml`` (so
   ``training.dropout_rng: auto``: masks from the generator kernel) at full
   width takes 8 micro-steps (2 AdamW updates at accumulation 4) on batch-32
   real train windows with every augmentation on. Every loss must be finite;
   the counters must read 4 launches per micro-step for the attention
   forward and backward and the four LayerNorm kernels, 4 for the mask
   generator (a layer's three masks in one launch), and none for the head;
   a second run from the same seed must give the same losses bit for bit.
   With ``training.dropout_rng=xla`` one micro-step on the kernel path is
   held against the plain path from the same weights, batch and generator
   seed (loss and every parameter gradient), and the step is timed beside
   the default one. Then the same at
   ``model.fused_mlp=true model.fused_mlp_ln=false``: 4 micro-steps must
   launch the ``fused_mlp`` pair 4 times each and the LayerNorm kernels
   never, and one micro-step is held against the plain path; that route's
   step time and device time by kernel family.
5. Fit: ``Trainer.fit`` on the real train/val/test splits for 2 epochs at the
   default config (checkpoints and ``results.json`` in a temporary
   directory): finite history, top-k and ``last`` checkpoints on disk, the
   mask generator launched 4 times per micro-step.
6. Eval: the ``last`` checkpoint reloaded from its directory alone must give
   the in-memory model's test logits bit for bit; ``evaluate_checkpoint`` on
   the best checkpoint (missing-modality sweep, MC dropout, temperature
   scaling) must write the three JSON files with the reference's keys and
   finite metrics; ``measure_inference_latency`` over a list of test batch
   tuples with one malformed entry skips exactly that entry, with the
   reference's warning, and times every other one.
   Bundle: for the flagship at chunk 512, LSTM512 and ``late`` fusion, a
   serving bundle (``serving.export_serving_bundle``) written to a temporary
   directory and loaded back (``load_serving_bundle``, no model code) serves
   the batch-64 requests of real windows: logits bit-identical to
   ``make_serving_fn``'s; at run time, through the loaded graph, 4 packed
   attention forwards and 1 head, 1 fused LSTM recurrence and 1 head, and 4
   packed attention forwards and no head a request; the graph's ``msfa::``
   op nodes printed; the bundle's p50 beside ``make_serving_fn``'s.
   Stream: one epoch of ``Trainer.fit`` at chunk 512 with
   ``dataset.streaming=true`` against one resident epoch from the same seed:
   history and every weight bit for bit, the same launches, the train split
   never put on the card whole; both epochs' seconds and peak memory; the
   loader's host-to-device copies on its side stream over 12 streamed
   micro-steps (torch.profiler's trace): ms per step, and the share that
   overlaps kernels on the compute stream.
   The five ``flash_self_attention`` kernels at the long windows' shapes
   (single-key-block forward at T = 1024 and 2048, B*H = 128; tiled forward
   at T = 4096, B*H = 256; fused backward at T = 1024 and at T = 512, B*H =
   512; the split dk/dv and dq kernels at T = 2048), on the real batches'
   lengths, on the edge lengths and on a padded T = 1100; the split pair at
   d 16/32/128 on the edge lengths; the fused backward and each split kernel
   twice on the same inputs, bit for bit; the two forwards against each other
   at T = 2048, and the split dk/dv against the fused backward's at T = 1024
   and 2048, bit for bit (one body each), with the split dq's difference from
   the fused dq printed; both routes timed at T = 1024 and 2048, kernels
   alone and through ``flash_self_attention`` (forward and backward, the
   backward route pinned by ``fused_bwd_max``), SDPA (forward, or backward)
   beside every shape a flash row reports.
   The three grouped-recurrence kernels (``ops/rnn.py``) at T = 512 and 1024,
   G = 4, B = 64, H = 256, D = 17: a real batch's lengths, the edge lengths 0,
   1, 37, T - 1, T, no lengths, and a B and a T that are not multiples of 8;
   timed beside their plain loops and cuDNN (``nn.LSTM`` / ``nn.GRU``). All
   three run their cluster body there: its route, CTAs and rows a
   cluster, threads, shared memory, the clusters that fit on the card at
   once, the clusters a launch runs and its waves are printed for both
   tilings (16 and 32 rows a cluster) at B 32 and 64, and the serving batch
   must run in one wave; each case launches them twice, bit for bit; both
   tilings are held to the plain versions and timed at B 32 and 64, and
   their rows carry both bounds and µs per step.
   The four recurrence training kernels (forward with residuals, reverse-time
   backward; LSTM and GRU) at T = 512 and 1024, G = 4, B = 32, H = 256: a
   real batch's lengths, the edge lengths, no lengths, and B = 13 / T = 509;
   the forward within 1e-4 abs of its twin in every output, the backward
   within 1e-4 of its largest magnitude on the twin's residuals, both exactly
   zero past each length; each kernel (both cells run their cluster body at
   H = 256: the route, the CTAs and rows per cluster, threads, shared memory,
   the clusters that fit on the card and the waves of a launch are printed
   for each cell) launched twice on every case, bit for bit; timed beside
   their plain loops and cuDNN (forward in training mode, backward alone,
   and both), µs per step beside the bounds (on 3xTF32 and on the CUDA
   cores), with the x_proj copy and the dW_hh product the wrapper adds timed
   apart.
7. Long: for ``dataset.chunk_size`` 1024 and 2048, real windows of that
   size; ``Trainer`` at batch 32 takes 8 micro-steps (launch counts: 4 per
   micro-step of the single-key-block forward and of the fused backward, or
   of each split backward kernel at 2048; none of the packed kernels), the
   same seed twice bit for bit, one micro-step at ``dropout_rng=xla`` against
   the plain path, step times and device time by family; batch-64 requests
   served at 1024, 2048 and 4096 (the tiled forward) against the plain path;
   one ``evaluate_model`` pass at 1024.
8. Grouped: ``model.grouped_transformer=true`` at chunk 512: served (one
   forward launch per request for the whole group) against the plain path
   and against the ungrouped model carrying the same weights unstacked; 8
   training micro-steps (1 forward, 1 fused backward, 1 mask launch each),
   twice bit for bit, one against the plain path; one epoch of ``fit`` whose
   checkpoint is rebuilt from its directory alone.
9. Rnn: the LSTM parity model (every encoder ``encoder_type=lstm
   num_layers=1``: one ``GroupedRNNEncoder``, G = 4) at chunk 512 and 1024 and
   the GRU model at 512: three batch-64 requests each (all modalities; one
   missing; short lengths) with exactly one fused recurrence launch and one
   head launch per request, against the same weights at
   ``model.pallas_rnn=false`` with the plain head; p50 latency and device time
   by family; one ``evaluate_model`` pass; the grouped model against the
   ungrouped one on the weights unstacked; the precomputed-projection kernel's
   path (the encoder's own x_proj product, ``grouped_lstm_forward``, the
   projection, LayerNorms and the head kernel) against the served logits; then
   ``Trainer`` at base.yaml's ``pallas_rnn: auto`` for LSTM512 (8 micro-steps)
   and GRU512 (4): exactly one training forward and one training backward
   launch per micro-step and none of any other kernel, the same seed twice
   bit for bit, one micro-step against ``model.pallas_rnn=false`` on the same
   weights and seed, p50 and device time by family, and the plain loop's p50
   beside it (no kernel launched); LSTM1024's micro-step p50 and device time
   by family; one epoch of ``Trainer.fit`` for LSTM512, its ``last``
   checkpoint reloaded from its
   directory, and ``evaluate_checkpoint`` on it, whose MC-dropout pass
   launches the training forward kernel.
10. C5: ``config/base.yaml`` at ``model.hidden_dim`` 192 and 640, widths the
   kernels are not built for: the route each kernel family takes there is
   printed (attention at head_dim 48 padded to 64 and at 160 plain; both
   residual-LN halves at 192 on the kernels at 256, the LayerNorm over 192,
   and plain at 640; the head kernel at both, K in slabs at 640); batch-64 requests
   served against the plain path and 4 training micro-steps (one against
   the plain path, the same seed twice bit for bit), each with exactly the
   launches those routes name.
11. Fusion: ``early_fusion``, ``late_fusion`` and ``uncertainty_fusion`` of
   ``config/fusion_strategies.yaml`` over base.yaml (seed 42, real chunk-512
   windows): batch-64 requests served against the plain path (4 attention
   forwards and no head kernel a request: these heads are plain layers) and
   timed over 20 calls; one training micro-step against the plain path, 8
   counted micro-steps (the default route's launches: 4 of each attention
   and residual-LN kernel, 4 mask launches), the same seed twice bit for
   bit, p50 and device time by family; a checkpoint rebuilt from its
   directory gives the test logits bit for bit. On the uncertainty preset,
   ``mc_dropout_uncertainty_fusion`` on one batch (weights sum to 1 on every
   row, zero off its modalities; the same seed twice bit for bit).
12. CNN: every stream's encoder ``encoder_type=cnn`` (two convolutions, masked
   BatchNorm), the hybrid head: served against the plain head (1 head
   kernel and no attention a request), trained as [fusion] is (no kernel
   launched); the BatchNorm buffers move with training, are left as they
   were by an MC-dropout call, and come back from a checkpoint with
   bit-identical test logits.
13. bf16: ``mixed_precision=true`` over base.yaml (the flagship in bf16; rows
   1, 2 and 12-15 through their bf16-operand entries). In [kernels] the six
   entries against their twins at the main path's shapes (B 64, T 512
   served; N = 32*512 rows trained; the packed pair also on the edge
   lengths and at d 16/32/128, and against the f32 entries on f32 copies of
   the same inputs), twice bit for bit, timed beside the twin, the f32 entry
   and, for the packed pair, SDPA in bf16. Then batch-64 requests served
   against the bf16 plain path (4 bf16 packed forwards and 1 head a request,
   no f32 attention entry); one micro-step against the plain path and one
   at dropout 0 against the same weights on the CPU (the twins); 8 counted
   micro-steps (4 of each bf16 entry and 4 mask launches each), the same
   seed twice bit for bit; ``Trainer.fit`` for 2 epochs, the ``last``
   checkpoint reloaded to bit-identical test logits, ``evaluate_checkpoint``
   (missing-modality sweep, calibration, MC dropout on the bf16 training
   forward); p50 and device time of a request and a micro-step beside the
   f32 path's of the same run.
   The feed-forward pair's bf16 entries (rows 10b-11b) in [kernels] against
   their twins (N = 32*512; keep 0.8, no mask, keep 0, a ragged N), the
   forward's hidden the backward's, twice bit for bit, timed beside the twin
   and the f32 entries on f32 copies; in [bf16] the route
   ``fused_mlp=true fused_mlp_ln=false``: one micro-step against the plain
   path, 8 counted micro-steps (4 launches of each entry a micro-step) twice
   bit for bit, p50 and device time by family; and the grouped transformer
   in bf16 served and trained against its plain path (the flash kernels on
   f32 copies of bf16 q, k, v), its launches counted, twice bit for bit.
   Rows 1b, 2b, 11b and 13b and the bf16 hidden of rows 10b-12b run on
   ``wgmma`` (``wgmma_bf16.cuh``, ``wgmma_attention_bwd.cuh``,
   ``wgmma_ffw.cuh``); each bf16 row in the kernels line names its design.
   The bf16 forward is held to the f32 entry at f32's limit, the bf16
   backward's dqkv to one bf16 step of the f32 entry's in all but 1e-3 of
   its entries (a bf16 and an f32 cotangent), its f32 sums before the
   rounding printed; SDPA's bf16 backward is timed 7 times with the key mask
   and 7 with every key valid and no mask, its backend named from its
   kernels, beside row 2b at both.
14. MoE: ``model.moe_experts=4 model.moe_top_k=2 model.moe_capacity_factor=1.25``
   over base.yaml: batch-64 requests (4 packed attention forwards and 1 head
   a request) against the plain path token by token: routing flips printed
   with their top-k margins, failing on a flip whose margin is above 1e-5,
   the windows and tokens routed alike at the f32 limits; one micro-step
   against the plain path, 8 counted micro-steps (4 of rows 1, 2, 14, 15 and
   4 mask launches each, none of rows 10-13), the same seed twice bit for
   bit, p50 and device time by family; one epoch of ``fit``, the checkpoint
   reloaded to bit-identical test logits, ``evaluate_checkpoint`` on it.
   Remat: ``training.remat=true`` at chunk 512: one micro-step's loss and
   every gradient and 4 micro-steps' losses bit for bit against the run
   without it, each forward kernel launched twice, the peak memory of both;
   at chunk 4096 (batch 32): one micro-step with and without remat and
   their peak memory, and one on 4 windows against the plain path.
15. Parallel: the layouts on ``torch.distributed``. One world of 4
   processes on the one card (``chip_smoke.py --parallel-child``, joined
   through ``parallel.coordinator_address``; gloo over CUDA tensors, printed
   and asserted for every leg), the flagship at full width (base.yaml, chunk
   512, hidden 256, FFW 2048, seed-42 weights) on real PAMAP2 windows at a
   global batch of 32, the reference's multichip dry run leg by leg: (a) dcn 2
   x data 2 with ZeRO; (b) data 2 x model 2 with sequence parallelism and
   ZeRO; (c) (b) with ``model.moe_experts=4 model.moe_top_k=2``; (d) data 2 x
   pipe 2, 2 microbatches, every transformer encoder at ``num_layers: 2``
   (the leg's one cut). Each leg: 8 micro-steps at dropout 0 with the
   augmentations off against one process on the card from the same weights
   at the start of each accumulation window (loss within 1e-5 relative; the
   gathered gradient the optimizer sees at each of the 2 updates within
   1e-5 norm-wise and each leaf within 1e-4 of its largest entry, floored at
   1e-3 of all); 4 micro-steps at the config's dropout twice, bit for bit on
   every rank; the launches of every rank per micro-step (b: the
   ``fused_mlp`` pair on the F = 1024 shards 4 times, ``ffw_ln`` never; d:
   the layer kernels once per layer per microbatch on the stage that owns
   the layer) and its p50 (four processes on one card: no speed of a
   4-card layout). Then one epoch of ``Trainer.fit`` on (b)'s layout with
   the train split cut to 4 batches (val and test to 64 windows): rank 0
   alone writes, and its ``last`` checkpoint loads into one process bit for
   bit; then a 1-rank world through ``Trainer`` on NCCL (its init, an
   all-reduce, all-gather, broadcast and barrier).
16. Print the kernel table as one JSON line (each row's ``parallel_launches``
   by leg), then the result line ``{"ok": true, "device": {...}}`` last.

The script imports torch and the port only; it needs no network.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_torch"
TPU_PKG = "multimodal_sensor_fusion_with_attention_rajeevatla_tpu"  # a label of the "replaces" paths; never imported
BATCH = 64
TRAIN_STEPS = 8  # micro-steps on the main path: 2 updates at accumulation 4
FUSED_MLP_STEPS = 4  # micro-steps at fused_mlp=true, fused_mlp_ln=false
FIT_EPOCHS = 2
# peaks of one H100 SXM (NVIDIA data sheet): CUDA-core FP32, dense TF32 on
# the tensor cores, HBM3. A kernel that takes each f32 product as three TF32
# products (3xTF32: the packed and both flash forwards, the packed, the fused
# and the split attention backwards, the fused head, both residual-LN pairs,
# the feed-forward pair, both training pairs and the three serving
# recurrences on their cluster bodies) is
# bounded by a third of the TF32 rate for the same f32 operation count
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12
# the kernels whose products run as 3xTF32 on the tensor cores
# (table row -> fragments of its kernels' names, for the ptxas report; each
# FFW pair's directions share its hidden kernel)
TENSOR_CORE_KERNELS = {"flash_fwd_single": ("flash_fwd_single_kernel",),
                       "flash_fwd_tiled": ("flash_fwd_tiled_kernel",),
                       "packed_attention_bwd": ("bwd_kernel", "bwd_prep_kernel",
                                                "bwd_dkv_wg_kernel", "bwd_dq_wg_kernel"),
                       "packed_attention_fwd": ("packed_attention_fwd_kernel",
                                                "packed_attention_fwd_wg_kernel"),
                       "flash_bwd_fused": ("flash_bwd_fused_kernel",),
                       "flash_bwd_dkv": ("flash_dkv_kernel",),
                       "flash_bwd_dq": ("flash_dq_kernel",),
                       "fused_hybrid_head": ("fusion_head",),
                       "ffw_ln_fwd": ("ffw_ln_hidden_kernel", "ffw_ln_hidden_wg_kernel",
                                      "ffw_ln_fwd_kernel", "ffw_ln_fwd_wg_kernel"),
                       "ffw_ln_bwd": ("ffw_ln_bwd",),
                       "proj_ln_fwd": ("proj_ln_fwd",),
                       "proj_ln_bwd": ("proj_ln_bwd",),
                       "fused_mlp_fwd": ("fused_mlp_hidden_kernel", "fused_mlp_hidden_wg_kernel",
                                         "fused_mlp_fwd_kernel", "fused_mlp_fwd_wg_kernel"),
                       "fused_mlp_bwd": ("fused_mlp_bwd",),
                       "lstm_train_fwd": ("lstm_train_fwd_cluster_kernel",),
                       "lstm_train_bwd": ("lstm_train_bwd_cluster_kernel",),
                       "gru_train_fwd": ("gru_train_fwd_cluster_kernel",),
                       "gru_train_bwd": ("gru_train_bwd_cluster_kernel",),
                       "grouped_lstm_forward": ("grouped_lstm_forward_cluster_kernel",),
                       "grouped_lstm_fused": ("grouped_lstm_fused_cluster_kernel",),
                       "grouped_gru_fused": ("grouped_gru_fused_cluster_kernel",)}
# stated tolerances: f32 on both sides; the kernels sum in another order
# (online softmax across 64-key tiles, per-thread dot products)
ATTN_TOL = 1e-4
HEAD_TOL = 1e-4
LOGIT_TOL = 1e-3  # four encoders and the head stacked: errors add up
# the recurrences' final state: f32 on both sides, up to 1,024 dependent steps
# whose products sum in another order; the gates squash what each step adds
RNN_TOL = 1e-4
# the served logits through grouped_lstm_forward on the encoder's own x_proj
# against those through grouped_lstm_fused: one function, two kernels
RNN_ROUTE_TOL = 1e-4
# backward kernels and the LayerNorm kernels: max abs error relative to the
# output's largest magnitude. f32 on both sides; the weight gradients are
# sums over 16,384 rows taken in split row blocks, not in the twin's order
GRAD_TOL = 1e-4
# one training micro-step, kernel path against plain path, each gradient's
# max abs error relative to its largest magnitude: the two forwards round
# differently, and a hidden unit whose pre-activation lands on the other
# side of zero moves one row's whole contribution in or out of dW1 (the
# ReLU's derivative is a step), so isolated entries differ by ~1e-3
TRAIN_TOL = 1e-2
# ... and the gradient as a whole, ||kernel - plain|| / ||plain||
TRAIN_NORM_TOL = 1e-3
# bf16 (mixed_precision): the six bf16-operand entries of rows 1, 2 and 12-15
# and their bound, by the kind of each product's operands. Two bf16 operands:
# the bf16 tensor-core peak. One bf16 and one f32 operand: two TF32 passes
# (the bf16 side is exact in TF32 and has no low part), half the TF32 rate.
# Two f32 operands: 3xTF32, a third of it
PEAK_BF16_FLOPS = 989e12
PEAK_2XTF32_FLOPS = PEAK_TF32_FLOPS / 2
BF16_KERNELS = ("packed_attention_fwd_bf16", "packed_attention_bwd_bf16", "proj_ln_fwd_bf16",
                "proj_ln_bwd_bf16", "ffw_ln_fwd_bf16", "ffw_ln_bwd_bf16", "fused_mlp_fwd_bf16",
                "fused_mlp_bwd_bf16")
BF16_PAIR = ("fused_mlp_fwd_bf16", "fused_mlp_bwd_bf16")  # rows 10b-11b: the pair's route
# a bf16 entry against its twin, max abs error over the largest magnitude: an
# output rounded to bf16 (2^-8 of unit roundoff) can round the other way where
# the kernel's f32 sum and the twin's straddle a rounding boundary: one bf16
# ulp, at most 2^-7 of the largest magnitude, plus the f32 sums' own order
BF16_TOL = 1e-2
# the packed backward's bf16 entry (row 2b) against the f32 entry on f32
# copies: each dqkv entry within one bf16 step of the f32 entry's sums
# rounded, the step taken at no less than attention.BWD_STEP_FLOOR of the
# largest magnitude of the call's dq, dk or dv (attention.bf16_steps_from: a
# sum that cancels to far below its terms, as a row with one valid key does,
# lies many steps of its own value from another f32-accurate order's, the
# f32 entry's own included; the f64 backward witnesses it), and at most
# BWD_GATE_SHARE of the entries off it by half a step or more. The scheme
# with one bf16 term an f32 operand reads 0.16-0.26 of the entries off,
# 143-5,280 steps (tests/test_torch_port_bf16.py)
BWD_GATE_SHARE = 1e-3
# served logits, bf16 kernel path against the bf16 plain path, norm-wise: the
# two round at other points (the kernels take the attention in f32 on bf16
# q, k, v and keep the FFW products in f32; the plain path rounds scores,
# weights and products to bf16), as the reference's two paths do: their gap
# is bf16's own, a few units of its 2^-8 roundoff through four encoders and
# the head
BF16_LOGIT_TOL = 2e-2
# one bf16 micro-step, kernel path against plain path: loss relative; the
# whole gradient norm-wise (bf16's rounding points differ between the paths
# and the backward carries every difference through its rounded products:
# gradients that rest on cancelling sums, the gates', differ most)
BF16_PLAIN_LOSS_TOL = 1e-3
BF16_PLAIN_GRAD_TOL = 0.2
# ... and each gradient's max abs error over its largest magnitude, floored
# as the f32 path floors it: a leaf that had lost a term or its sign would
# read 1 or more; the paths' other rounding points move the gates' biases,
# whose gradients rest on sums that cancel over the batch, most (0.284 in
# the first runs on an H100)
BF16_PLAIN_LEAF_TOL = 0.5
# one bf16 micro-step at dropout 0, the card's kernels against the same model
# on the CPU (the twins, the function the CPU tests hold to the JAX package):
# the loss relative; the whole gradient's difference norm-wise at most
# BF16_CPU_GAP_SHARE of bf16's own effect, the same reading of the CPU's f32
# model against its bf16 one on the same weights and windows. That f32 model
# is the control the gate must refuse: a card that left out the reference's
# bf16 roundings would read about as far from the CPU as it does. One
# function, its sums in another order: once one bf16 rounding breaks the
# other way the two sides' later roundings part, and the gradients differ by
# bf16 noise, a third of bf16's own effect on an H100 (2.03e-2 against
# 6.12e-2 norm-wise)
BF16_CPU_LOSS_TOL = 1e-3
BF16_CPU_GAP_SHARE = 0.5
# ... and each gradient's max abs error over its largest magnitude, floored
# (bf16_step_vs_cpu): a leaf that had lost a term or its sign would read 1
# or more. The fusion head's projections, fed by four encoders' bf16 noise
# on 4 windows, read as far from the CPU as the f32 control does (0.215 on
# an H100), so this gate catches a wrong gradient, not a left-out rounding:
# the whole-gradient gate above and the card test of the FFW entries'
# rounding points (tests/test_torch_port_cuda.py) hold those
BF16_CPU_LEAF_TOL = 0.5
BF16_CPU_ROWS = 4  # windows of the card-vs-CPU micro-step


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SLEEP_CYCLES = 2_000_000  # ~1 ms of the card's clock: more than a call takes to enqueue
FLUSH_FLOATS = 32 << 20  # 128 MB: a write of it evicts the 50 MB L2


def device_ms(fn, iters: int = 20, flush=None) -> float:
    """Device ms of one ``fn()`` call, the median over ``iters`` calls each
    timed alone: CUDA events around the call, the card held busy
    (``torch.cuda._sleep``) while the host enqueues it, so neither the host's
    launch overhead nor a gap before the call is timed. With ``flush`` (a
    buffer of at least 64 MB), a write of it before each call evicts the
    call's inputs from the L2 (cold); without it the previous call left them
    there (warm)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[len(times) // 2]


def warm_cold(torch, row, call, label):
    """``row["ms"]`` L2-warm and ``row["ms_cold"]`` L2-cold by ``device_ms``,
    and ``row["ms_back_to_back"]`` by ``time_ms`` (launches queued back to
    back: the host's own time per call where it exceeds the card's)."""
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    row["ms"] = device_ms(call)
    row["ms_cold"] = device_ms(call, flush=flush)
    row["ms_back_to_back"] = time_ms(call)
    del flush
    print(f"  {label} ms={row['ms']:.4f} L2-warm, {row['ms_cold']:.4f} L2-cold (each call "
          f"alone), {row['ms_back_to_back']:.4f} back to back", flush=True)


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(ms, "operations" or "bytes"): the larger of flops over the peak of the
    unit the kernel runs on and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_core_bounds(row, flops, nbytes, suffix=""):
    """Both bounds of a 3xTF32 kernel's row at one shape: ``bound_ms`` on the
    unit it runs on (a third of the TF32 tensor-core peak) and
    ``bound_ms_f32`` on the CUDA cores, and the share of the first."""
    b3, by = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
    b32, _ = bound(flops, nbytes)
    row[f"bound_ms{suffix}"], row[f"bound_ms_f32{suffix}"] = b3, b32
    row[f"bound_share{suffix}"] = b3 / row[f"ms{suffix}"]
    if not suffix:
        row["bound_by"], row["unit"] = by, "3xTF32 tensor cores"
    return (f"bound_ms={b3:.4f} on 3xTF32 (f32 CUDA cores {b32:.4f}), "
            f"share {100 * b3 / row[f'ms{suffix}']:.1f}%")


def _source_name(mangled: str) -> str:
    """A kernel's own name in its mangled symbol: the last source name of
    the (nested) name, before template arguments and parameters."""
    names, i = [], 3 if mangled.startswith("_ZN") else 2
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        names.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    return names[-1] if names else mangled


def ptxas_report(build):
    """Start ``nvcc -Xptxas -v`` on the tensor-core kernels' sources beside
    the build; the returned function waits and prints registers, shared
    memory and spills."""
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ptxas_")
    sources = ("flash_attention", "packed_attention_bwd", "packed_attention",
               "flash_attention_bwd", "ffw_ln", "proj_ln", "ffw", "fusion_head", "rnn_train",
               "rnn")
    procs = [subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp.name}/{name}.so",
         str(build.CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name in sources]

    def finish():
        seen = set()  # rnn.cu also compiles rnn_cluster.cuh's training kernels
        for proc in procs:
            output, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v failed:\n{output}")
            kernel = None
            for line in output.splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1]
                    kernel = next((_source_name(name) for ks in TENSOR_CORE_KERNELS.values()
                                   for k in ks if k in name), None)
                    dim = name.split("ILi")[1].split("E")[0] if kernel and "ILi" in name else ""
                    if "bfloat16" in name:  # a bf16 entry's instantiation
                        dim = f"{dim},bf16" if dim else "bf16"
                    if (kernel, dim) in seen:
                        kernel = None
                    seen.add((kernel, dim))
                elif kernel and ("spill" in line or "registers" in line):
                    print(f"  ptxas {kernel}{f'<{dim}>' if dim else ''}: {line.strip()}",
                          flush=True)
        tmp.cleanup()
        # dynamic shared memory, which ptxas does not see, of the newest entries
        for lib, symbol, names in (
                ("ffw_ln", "msfa_ffw_ln_smem_bytes",
                 ("hidden", "fwd", "bwd_ln", "bwd_dpre", "bwd_dx", "bwd_dw")),
                ("proj_ln", "msfa_proj_ln_bwd_smem_bytes", ("bwd_ln", "bwd_da", "bwd_dw")),
                ("ffw_ln", "msfa_ffw_ln_bf16_smem_bytes",
                 ("bf16 hidden", "bf16 fwd", "bf16 bwd_ln", "bf16 bwd_dpre", "bf16 bwd_dx",
                  "bf16 bwd_dw")),
                ("proj_ln", "msfa_proj_ln_bf16_bwd_smem_bytes",
                 ("bf16 bwd_ln", "bf16 bwd_da", "bf16 bwd_dw")),
                ("fused_mlp", "msfa_ffw_smem_bytes",
                 ("hidden", "fwd", "bwd_dpre", "bwd_dx", "bwd_dw")),
                ("fused_mlp", "msfa_ffw_bf16_smem_bytes",
                 ("bf16 hidden", "bf16 fwd", "bf16 bwd_dpre", "bf16 bwd_dx", "bf16 bwd_dw"))):
            sizes = (ctypes.c_int * len(names))()
            if getattr(build.library("ffw" if lib == "fused_mlp" else lib), symbol)(256, sizes):
                raise RuntimeError(f"{symbol} failed")
            print(f"  shared memory per block, {lib}_*_kernel at D=256: " + ", ".join(
                f"{n} {b} bytes" for n, b in zip(names, sizes)), flush=True)
        print(f"  shared memory per block, flash_fwd_single_kernel and flash_fwd_tiled_kernel at "
              f"d=64: {build.library('flash_attention').msfa_flash_fwd_smem_bytes(64)} bytes",
              flush=True)
    return finish


def check_attention(torch, attn, real_lengths):
    """Kernel vs plain twin at the serving shape; returns the table row."""
    g = torch.Generator().manual_seed(1)
    batch, seq, heads, hd = BATCH, 512, 4, 64
    scale = hd**-0.5
    qkv = torch.randn(batch, seq, 3 * heads * hd, generator=g).cuda()
    edge = torch.randint(1, seq + 1, (batch,), generator=g, dtype=torch.int32)
    edge[:8] = torch.tensor([0, seq, 37, 1, 64, 65, 511, 8], dtype=torch.int32)
    err = 0.0
    cases = [(qkv, edge.cuda()), (qkv, real_lengths)]
    # padded T (not a multiple of the 64-row tile) with a length past the valid keys
    qkv72 = torch.randn(3, 72, 3 * heads * hd, generator=g).cuda()
    cases.append((qkv72, torch.tensor([0, 70, 72], dtype=torch.int32).cuda()))
    for d in (16, 32, 128):  # every head dim the kernel takes, on the edge lengths, T = 72 and 512
        for t_len in (72, 512):
            lens = torch.tensor([0, 1, 37, 64, 65, t_len - 1, t_len, t_len // 2],
                                dtype=torch.int32).cuda()
            cases.append((torch.randn(8, t_len, 3 * heads * d, generator=g).cuda(), lens))
    for x, lens in cases:
        d = x.shape[-1] // (3 * heads)
        out, lse = attn.packed_attention_fwd(x, lens, heads, d**-0.5)
        torch.cuda.synchronize()
        ref_out, ref_lse = attn.packed_attention_reference(x, lens, heads, d**-0.5)
        e_out = (out - ref_out).abs().max().item()
        valid = ref_lse > attn.NEG_INF / 2
        if not torch.equal(valid, lse > attn.NEG_INF / 2):
            raise AssertionError("packed attention: rows without keys differ from the twin")
        e_lse = (lse[valid] - ref_lse[valid]).abs().max().item()
        zero_rows = (lens == 0).nonzero().flatten().tolist()
        if any(out[b].abs().max().item() != 0.0 for b in zero_rows):
            raise AssertionError("packed attention: a length-0 row is not exactly zero")
        print(f"  packed_attention T={x.shape[1]} d={d} max_abs_err out={e_out:.3e} "
              f"lse={e_lse:.3e} (tol {ATTN_TOL})", flush=True)
        err = max(err, e_out, e_lse)
    if err > ATTN_TOL:
        raise AssertionError(f"packed attention disagrees with its twin: {err} > {ATTN_TOL}")
    first = attn.packed_attention_fwd(qkv, real_lengths, heads, scale)
    second = attn.packed_attention_fwd(qkv, real_lengths, heads, scale)
    torch.cuda.synchronize()
    if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
        raise AssertionError("packed attention: two runs on the same inputs differ")
    print(f"  packed_attention_fwd: two runs equal bit for bit; output digest "
          f"{_digest(list(first))}", flush=True)
    del first, second

    uniform_ms = time_ms(lambda: attn.packed_attention_fwd(qkv, cases[0][1], heads, scale))
    print(f"  packed_attention ms={uniform_ms:.4f} on the uniform random lengths above", flush=True)
    # the table's times are on the real request's lengths (what serving gives it)
    lens = real_lengths
    ms = time_ms(lambda: attn.packed_attention_fwd(qkv, lens, heads, scale))
    plain_ms = time_ms(lambda: attn.packed_attention_reference(qkv, lens, heads, scale))
    view = qkv.view(batch, seq, 3, heads, hd)
    q, k, v = (view[:, :, i].transpose(1, 2) for i in range(3))
    key_mask = (torch.arange(seq, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=key_mask))
    keys = float(lens.clamp(0, seq).sum().item())
    flops = 4.0 * heads * hd * seq * keys  # QK^T and PV over the valid keys
    nbytes = 4.0 * (qkv.numel() + batch + batch * seq * heads * hd + batch * seq * heads)
    row = {
        "name": "packed_attention_fwd", "route": "cuda",
        "source": f"{PKG}/ops/csrc/packed_attention.cu",
        "replaces": f"{TPU_PKG}/ops/pallas_attention.py:793",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
    }
    note = tensor_core_bounds(row, flops, nbytes)
    print(f"  packed_attention ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
          f"{note} ({row['bound_by']}; {keys:.0f} valid keys, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return row


def check_head(torch, fusion, ordered_pairs, head_inputs):
    """Kernel vs plain twin on the serving head's own inputs plus edge masks."""
    projected, mask, params = head_inputs
    num_mod, batch, hidden = projected.shape
    pairs = ordered_pairs(range(num_mod))
    args = (params.pair_params, params.gate_kernels, params.gate_biases,
            params.w1, params.b1, params.w2, params.b2, pairs)
    edge = mask.clone()
    edge[0] = 0.0  # uniform fallback
    edge[1] = torch.tensor([0.0, 0.0, 0.0, 1.0])  # one modality
    edge[2] = torch.tensor([1.0, 0.0, 1.0, 0.0])
    err = 0.0
    for m in (mask, edge):
        out = fusion.fused_hybrid_head(projected, m, *args)
        torch.cuda.synchronize()
        ref = fusion.fused_hybrid_head_reference(projected, m, *args)
        e = (out - ref).abs().max().item()
        print(f"  fused_hybrid_head max_abs_err={e:.3e} (tol {HEAD_TOL})", flush=True)
        err = max(err, e)
    # a batch that is not a multiple of the kernels' 64-row or 4-row tiles
    out = fusion.fused_hybrid_head(projected[:, :5].contiguous(), edge[:5].contiguous(), *args)
    ref = fusion.fused_hybrid_head_reference(projected[:, :5], edge[:5], *args)
    err = max(err, (out - ref).abs().max().item())
    if err > HEAD_TOL:
        raise AssertionError(f"fused head disagrees with its twin: {err} > {HEAD_TOL}")
    # every sum in a fixed order, no atomics
    first = fusion.fused_hybrid_head(projected, edge, *args)
    second = fusion.fused_hybrid_head(projected, edge, *args)
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        raise AssertionError("fused head: two runs on the same inputs differ")
    print(f"  fused_hybrid_head: two runs equal bit for bit; output digest {_digest([first])}",
          flush=True)

    def call():
        return fusion.fused_hybrid_head(projected, mask, *args)

    row = {
        "name": "fused_hybrid_head", "route": "cuda",
        "source": f"{PKG}/ops/csrc/fusion_head.cu",
        "replaces": f"{TPU_PKG}/ops/pallas_fusion.py:37",
        "max_abs_err": err, "library_ms": None,
    }
    warm_cold(torch, row, call, "fused_hybrid_head")
    plain_ms = time_ms(lambda: fusion.fused_hybrid_head_reference(projected, mask, *args))
    row["plain_ms"] = plain_ms
    num_pairs, num_classes = len(pairs), params.w2.shape[1]
    flops = 2.0 * batch * (2 * num_pairs * hidden * hidden + num_mod * hidden
                           + hidden * hidden + hidden * num_classes)
    weights = (2 * num_pairs * hidden * (hidden + 1) + num_mod * (hidden + 1)
               + hidden * (hidden + 1) + (hidden + 1) * num_classes)
    nbytes = 4.0 * (projected.numel() + mask.numel() + weights + batch * num_classes)
    note = tensor_core_bounds(row, flops, nbytes)
    cold = tensor_core_bounds(row, flops, nbytes, suffix="_cold")
    print(f"  fused_hybrid_head ms={row['ms']:.4f} plain_ms={plain_ms:.4f} {note}; L2-cold "
          f"{cold} ({row['bound_by']}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)",
          flush=True)
    row["ms_by_kernel"] = kernel_times(torch, call, 10)
    # each kernel's span in the profile; the head's dependent launches overlap,
    # so the spans add up to more than a call
    print("  fused_hybrid_head by kernel (back to back, overlapping spans): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in row["ms_by_kernel"].items()), flush=True)
    return row


def rel_err(got, want) -> float:
    """Max abs error relative to the reference's largest magnitude (exact
    zeros on both sides count as 0)."""
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / scale if scale > 0 else diff


def check_attention_bwd(torch, attn, real_lengths):
    """Backward kernel vs its twin at the training shape; returns the row."""
    g = torch.Generator().manual_seed(2)
    batch, seq, heads, hd = len(real_lengths), 512, 4, 64
    scale = hd**-0.5
    qkv = torch.randn(batch, seq, 3 * heads * hd, generator=g).cuda()
    dout = torch.randn(batch, seq, heads * hd, generator=g).cuda()
    edge = real_lengths.clone().cpu()
    edge[:8] = torch.tensor([0, 1, 37, 64, 65, 511, seq, 8], dtype=torch.int32)
    qkv72 = torch.randn(3, 72, 3 * heads * hd, generator=g).cuda()
    dout72 = torch.randn(3, 72, heads * hd, generator=g).cuda()
    cases = [("real lengths", qkv, dout, real_lengths), ("edge lengths", qkv, dout, edge.cuda()),
             ("T=72", qkv72, dout72, torch.tensor([0, 70, 72], dtype=torch.int32).cuda())]
    for d in (16, 32, 128):  # every head dim the kernel takes, on the edge lengths
        cases.append((f"d={d} edge lengths",
                      torch.randn(8, seq, 3 * heads * d, generator=g).cuda(),
                      torch.randn(8, seq, heads * d, generator=g).cuda(), edge[:8].cuda()))
    err = 0.0
    for name, x, do, lens in cases:
        d = x.shape[-1] // (3 * heads)
        out, lse = attn.packed_attention_reference(x, lens, heads, d**-0.5)
        got = attn.packed_attention_bwd(x, lens, out, lse, do, heads, d**-0.5)
        torch.cuda.synchronize()
        want = attn.packed_attention_bwd_reference(x, lens, out, lse, do, heads, d**-0.5)
        e = rel_err(got, want)
        feat = heads * d
        for b, n in enumerate(lens.tolist()):
            if n == 0 and got[b].abs().max().item() != 0.0:
                raise AssertionError("packed attention bwd: a length-0 row has a gradient")
            if n < x.shape[1] and got[b, n:, feat:].abs().max().item() != 0.0:
                raise AssertionError("packed attention bwd: keys past the length have dk/dv")
        print(f"  packed_attention_bwd {name}: rel err dqkv={e:.3e} (tol {GRAD_TOL})", flush=True)
        err = max(err, e)
    if err > GRAD_TOL:
        raise AssertionError(f"packed attention bwd disagrees with its twin: {err} > {GRAD_TOL}")

    lens = real_lengths
    out, lse = attn.packed_attention_fwd(qkv, lens, heads, scale)
    ms = time_ms(lambda: attn.packed_attention_bwd(qkv, lens, out, lse, dout, heads, scale))
    plain_ms = time_ms(
        lambda: attn.packed_attention_bwd_reference(qkv, lens, out, lse, dout, heads, scale))
    # yardstick: SDPA's backward with the same key mask (timed only)
    view = qkv.view(batch, seq, 3, heads, hd)
    q, k, v = (view[:, :, i].transpose(1, 2).detach().requires_grad_() for i in range(3))
    key_mask = (torch.arange(seq, device="cuda")[None, :] < lens[:, None].long())[:, None, None, :]
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    d_sdpa = dout.view(batch, seq, heads, hd).transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(sdpa_out, (q, k, v), d_sdpa,
                                                     retain_graph=True))
    keys = float(lens.clamp(0, seq).sum().item())
    flops = 10.0 * heads * hd * seq * keys  # the TPU kernel's five products
    nbytes = 4.0 * (2 * qkv.numel() + 2 * dout.numel() + lse.numel() + batch)
    row = {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": f"{PKG}/ops/csrc/packed_attention_bwd.cu",
        "replaces": f"{TPU_PKG}/ops/pallas_attention.py:845",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
    }
    note = tensor_core_bounds(row, flops, nbytes)
    print(f"  packed_attention_bwd ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_bwd_ms={library_ms:.4f} "
          f"{note} ({row['bound_by']}; {keys:.0f} valid keys, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)", flush=True)
    return row


def _ln_case(torch, n, d, f, keep, seed):
    """Random inputs of one LayerNorm-kernel case on the card."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).cuda()

    masks = (None, None)
    if keep is not None:
        masks = tuple((torch.rand(n, width, generator=g) < keep).to(torch.uint8).cuda()
                      for width in (f, d))
    return w, masks


def _forward_branches(torch, family, x, w1, b1, mask, inv_keep, hd):
    """The twin's pre = x W1 + b1 and the ReLU branches the kernel's forward
    took (``hd > 0`` where the mask keeps the unit) -> (pre, live, branches
    that differ from the twin's own). The kernel rounds pre otherwise than the
    twin's f32 product, so each branch that differs must lie within (D + 64)
    2^-23 |x_n| |W1[:, f]| of zero in the twin's pre (a bound on the gap
    between two f32-accurate sums)."""
    pre = x @ w1 + b1
    kept = torch.full_like(pre, inv_keep != 0.0, dtype=torch.bool)
    if mask is not None:
        kept &= mask.bool()
    live = torch.where(kept, hd > 0, pre > 0)
    off = live != (pre > 0)
    band = (x.shape[1] + 64) * 2.0**-23 * x.norm(dim=1)[:, None] * w1.norm(dim=0)[None, :]
    if torch.any(off & (pre.abs() >= band)):
        raise AssertionError(f"{family}: a hidden unit's ReLU branch differs from the twin's "
                             "outside rounding of zero")
    return pre, live, int(off.sum().item())


def _ffw_ln_bwd_check(torch, mlp, args, dout, inv_keep, d_valid=None):
    """``ffw_ln_bwd`` against its twin on the forward kernel's ReLU branches
    -> (rel err, branches that differ from the twin's own, rel err against
    the twin on its own branches). Both directions launch one hidden kernel,
    so the kernel's backward takes the branch of the kernel's forward; the
    gradients must match the twin's taken on the kernel's branches. With
    ``d_valid``, the LayerNorm over its first columns."""
    x, w1, b1, w2, b2, gamma, beta, fmask, rmask = args
    _out, fwd_hd = mlp._ffw_ln_fwd_launch(*args, inv_keep, 1e-6, d_valid)
    grads, bwd_hd = mlp._ffw_ln_bwd_launch(*args, dout, inv_keep, 1e-6, d_valid)
    torch.cuda.synchronize()
    if not torch.equal(fwd_hd, bwd_hd):
        raise AssertionError("ffw_ln: the forward's hidden and the backward's differ")
    del fwd_hd
    pre, live, flips = _forward_branches(torch, "ffw_ln", x, w1, b1, fmask, inv_keep, bwd_hd)
    del bwd_hd
    on_branch = max(rel_err(g, w) for g, w in zip(grads, mlp._ffw_ln_bwd_plain(
        x, w1, pre, live, w2, b2, gamma, fmask, rmask, dout, inv_keep, 1e-6, d_valid)))
    own = max(rel_err(g, w) for g, w in zip(grads, mlp.ffw_ln_bwd_reference(
        *args, dout, inv_keep, 1e-6, d_valid)))
    if d_valid is not None and not torch.all(grads[0][:, d_valid:] == 0):
        raise AssertionError("ffw_ln_bwd: dx past the valid columns")
    return on_branch, flips, own


def _digest(tensors) -> str:
    """sha256 prefix of the tensors' bytes, in order: equal digests, equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()[:16]


def check_ln_kernels(torch, mlp, rows):
    """The projection and FFW residual-LN kernels, forward and backward, vs
    their twins; returns four table rows."""
    d, f = 256, 2048
    out_rows = {}
    specs = {
        "proj_ln": (mlp.proj_ln_fwd, mlp.proj_ln_bwd, mlp.proj_ln_fwd_reference,
                    mlp.proj_ln_bwd_reference, 921, 945, "proj_ln.cu"),
        "ffw_ln": (mlp.ffw_ln_fwd, mlp.ffw_ln_bwd, mlp.ffw_ln_fwd_reference,
                   mlp.ffw_ln_bwd_reference, 573, 611, "ffw_ln.cu"),
    }
    for family, (fwd, bwd, fwd_ref, bwd_ref, fwd_line, bwd_line, src) in specs.items():
        errs = [0.0, 0.0]
        timed = None
        for n, keep in ((rows, 0.8), (rows, None), (rows, 0.0), (rows - 25, 0.8)):
            w, (fmask, rmask) = _ln_case(torch, n, d, f, keep, seed=n + int(10 * (keep or 1)))
            x = w(n, d)
            if family == "proj_ln":
                args = (x, w(n, d), w(d, d, s=d**-0.5), w(d, s=0.1), 1 + w(d, s=0.1),
                        w(d, s=0.1), rmask)
            else:
                args = (x, w(d, f, s=d**-0.5), w(f, s=0.1), w(f, d, s=f**-0.5), w(d, s=0.1),
                        1 + w(d, s=0.1), w(d, s=0.1), fmask, rmask)
            inv_keep = mlp._inv_keep(1.0 if keep is None else keep)
            dout = w(n, d)
            out = fwd(*args, inv_keep, 1e-6)
            torch.cuda.synchronize()
            e_fwd = rel_err(out, fwd_ref(*args, inv_keep, 1e-6))
            if family == "ffw_ln":
                e_bwd, flips, own = _ffw_ln_bwd_check(torch, mlp, args, dout, inv_keep)
                note = (f" (forward's hidden = backward's bit for bit; {flips} ReLU branches "
                        f"off the twin's, within rounding of zero; on the twin's own branches "
                        f"{own:.3e})")
            else:
                grads = bwd(*args, dout, inv_keep, 1e-6)
                torch.cuda.synchronize()
                e_bwd = max(rel_err(got, want)
                            for got, want in zip(grads, bwd_ref(*args, dout, inv_keep, 1e-6)))
                note = ""
            print(f"  {family} N={n} keep={keep}: rel err fwd={e_fwd:.3e} bwd={e_bwd:.3e} "
                  f"(tol {GRAD_TOL}){note}", flush=True)
            errs = [max(errs[0], e_fwd), max(errs[1], e_bwd)]
            if timed is None:
                timed = (args, dout, inv_keep)
        if max(errs) > GRAD_TOL:
            raise AssertionError(f"{family} kernels disagree with their twins: {errs} > {GRAD_TOL}")
        args, dout, inv_keep = timed  # keep 0.8 at N = rows, as in training
        # every sum over rows in a fixed order, no atomics
        first, second = bwd(*args, dout, inv_keep, 1e-6), bwd(*args, dout, inv_keep, 1e-6)
        out, again = fwd(*args, inv_keep, 1e-6), fwd(*args, inv_keep, 1e-6)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{family}_bwd: two runs on the same inputs differ")
        if not torch.equal(out, again):
            raise AssertionError(f"{family}_fwd: two runs on the same inputs differ")
        print(f"  {family}_fwd and {family}_bwd N={rows} keep=0.8: two runs of each equal bit "
              f"for bit; output digests fwd {_digest([out])} bwd {_digest(first)}", flush=True)
        del first, second, out, again
        n = rows
        if family == "proj_ln":  # rows of f32 moved: x, a, out | x, a, dout, dx, da
            weights, masks, work, f32_rows, ops = d * d + 3 * d, n * d, d * d, (3, 5), (2, 6)
        else:  # x, out | x, dout, dx
            weights, masks, work, f32_rows, ops = 2 * d * f + f + 3 * d, n * (d + f), d * f, \
                (2, 3), (4, 12)
        cost = {  # operations, bytes (weights read once; the backward writes their grads)
            "fwd": (ops[0] * n * work, 4.0 * (f32_rows[0] * n * d + weights) + masks),
            "bwd": (ops[1] * n * work, 4.0 * (f32_rows[1] * n * d + 2 * weights) + masks),
        }
        for kind, fn, ref, line in (("fwd", fwd, fwd_ref, fwd_line), ("bwd", bwd, bwd_ref, bwd_line)):
            call = (lambda fn=fn: fn(*args, inv_keep, 1e-6)) if kind == "fwd" else \
                (lambda fn=fn: fn(*args, dout, inv_keep, 1e-6))
            call_ref = (lambda: ref(*args, inv_keep, 1e-6)) if kind == "fwd" else \
                (lambda: ref(*args, dout, inv_keep, 1e-6))
            flops, nbytes = cost[kind]
            name = f"{family}_{kind}"
            row = {
                "name": name, "route": "cuda", "source": f"{PKG}/ops/csrc/{src}",
                "replaces": f"{TPU_PKG}/ops/pallas_mlp.py:{line}",
                "max_abs_err": errs[0 if kind == "fwd" else 1],
                "plain_ms": time_ms(call_ref, iters=10), "library_ms": None,
            }
            if name == "proj_ln_fwd":  # short enough for the host to lag back to back
                warm_cold(torch, row, call, name)
            else:
                row["ms"] = time_ms(call, iters=10)
            if name in TENSOR_CORE_KERNELS:
                bounds = tensor_core_bounds(row, flops, nbytes)
                if "ms_cold" in row:
                    bounds += "; L2-cold " + tensor_core_bounds(row, flops, nbytes, "_cold")
            else:
                row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
                bounds = f"bound_ms={row['bound_ms']:.4f}"
            print(f"  {name} ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} {bounds} "
                  f"({row['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)",
                  flush=True)
            out_rows[name] = row
            if name in TENSOR_CORE_KERNELS:  # its chain of kernels, one by one
                row["ms_by_kernel"] = kernel_times(torch, call, 5)
                print(f"  {name} by kernel: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in row["ms_by_kernel"].items()), flush=True)
    return [out_rows[k] for k in ("proj_ln_fwd", "proj_ln_bwd", "ffw_ln_fwd", "ffw_ln_bwd")]


def _fused_mlp_bwd_check(torch, mlp, args, dout, inv_keep):
    """``fused_mlp_bwd`` against its twin on the forward kernel's ReLU
    branches, as ``_ffw_ln_bwd_check`` -> (rel err, branches that differ from
    the twin's own, rel err against the twin on its own branches, the
    hidden)."""
    x, w1, b1, w2, _b2, mask = args
    _out, fwd_hd = mlp._fused_mlp_fwd_launch(*args, inv_keep)
    grads, bwd_hd = mlp._fused_mlp_bwd_launch(x, w1, b1, w2, mask, dout, inv_keep)
    torch.cuda.synchronize()
    if not torch.equal(fwd_hd, bwd_hd):
        raise AssertionError("fused_mlp: the forward's hidden and the backward's differ")
    del fwd_hd
    pre, live, flips = _forward_branches(torch, "fused_mlp", x, w1, b1, mask, inv_keep, bwd_hd)
    on_branch = max(rel_err(g, w) for g, w in zip(grads, mlp._fused_mlp_bwd_plain(
        x, w1, pre, live, w2, mask, dout, inv_keep)))
    own = max(rel_err(g, w) for g, w in zip(grads, mlp.fused_mlp_bwd_reference(
        x, w1, b1, w2, mask, dout, inv_keep)))
    return on_branch, flips, own, bwd_hd


def check_fused_mlp(torch, mlp, rows):
    """The feed-forward kernel pair vs its twins (the backward on the forward
    kernel's ReLU branches), its hidden against the FFW residual-LN kernels'
    and its backward twice; returns two table rows."""
    d, f = 256, 2048
    errs = [0.0, 0.0]
    timed = None
    for n, keep in ((rows, 0.8), (rows, None), (rows, 0.0), (rows - 25, 0.8)):
        w, (mask, rmask) = _ln_case(torch, n, d, f, keep, seed=7 + n + int(10 * (keep or 1)))
        x, w1, b1, w2, b2 = (w(n, d), w(d, f, s=d**-0.5), w(f, s=0.1), w(f, d, s=f**-0.5),
                             w(d, s=0.1))
        args = (x, w1, b1, w2, b2, mask)
        inv_keep = mlp._inv_keep(1.0 if keep is None else keep)
        dout = w(n, d)
        out = mlp.fused_mlp_fwd(*args, inv_keep)
        torch.cuda.synchronize()
        e_fwd = rel_err(out, mlp.fused_mlp_fwd_reference(*args, inv_keep))
        if keep == 0.0 and not torch.equal(out, b2.expand_as(out)):
            raise AssertionError("fused_mlp: keep 0 does not give an exactly zero hidden")
        e_bwd, flips, own, hd = _fused_mlp_bwd_check(torch, mlp, args, dout, inv_keep)
        note = ""
        if timed is None:  # one hidden body in all four launches
            _out, ln_hd = mlp._ffw_ln_fwd_launch(x, w1, b1, w2, b2, 1 + w(d, s=0.1), w(d, s=0.1),
                                                 mask, rmask, inv_keep, 1e-6)
            torch.cuda.synchronize()
            if not torch.equal(hd, ln_hd):
                raise AssertionError("fused_mlp's hidden and ffw_ln's differ")
            note = "; = ffw_ln_fwd's hidden bit for bit"
            del ln_hd
            timed = (args, dout, inv_keep)
        del hd
        print(f"  fused_mlp N={n} keep={keep}: rel err fwd={e_fwd:.3e} bwd={e_bwd:.3e} "
              f"(tol {GRAD_TOL}) (forward's hidden = backward's bit for bit{note}; {flips} ReLU "
              f"branches off the twin's, within rounding of zero; on the twin's own branches "
              f"{own:.3e})", flush=True)
        errs = [max(errs[0], e_fwd), max(errs[1], e_bwd)]
    if max(errs) > GRAD_TOL:
        raise AssertionError(f"fused_mlp kernels disagree with their twins: {errs} > {GRAD_TOL}")
    args, dout, inv_keep = timed  # keep 0.8 at N = rows, as in training
    x, w1, b1, w2, b2, mask = args
    first = mlp.fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep)
    second = mlp.fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("fused_mlp_bwd: two runs on the same inputs differ")
    print(f"  fused_mlp_bwd N={rows} keep=0.8: two runs equal bit for bit; output digests fwd "
          f"{_digest([mlp.fused_mlp_fwd(*args, inv_keep)])} bwd {_digest(first)}", flush=True)
    del first, second
    n = rows
    weights = 2 * d * f + f + d
    calls = {  # kernel, twin, operations, bytes (x, out | x, dout, dx; weights and their grads)
        "fwd": (lambda: mlp.fused_mlp_fwd(*args, inv_keep),
                lambda: mlp.fused_mlp_fwd_reference(*args, inv_keep),
                4.0 * n * d * f, 4.0 * (2 * n * d + weights) + n * f, 195),
        "bwd": (lambda: mlp.fused_mlp_bwd(x, w1, b1, w2, mask, dout, inv_keep),
                lambda: mlp.fused_mlp_bwd_reference(x, w1, b1, w2, mask, dout, inv_keep),
                10.0 * n * d * f, 4.0 * (3 * n * d + 2 * weights) + n * f, 232),
    }
    out_rows = []
    for kind, (call, call_ref, flops, nbytes, line) in calls.items():
        ms = time_ms(call, iters=10)
        plain_ms = time_ms(call_ref, iters=10)
        row = {
            "name": f"fused_mlp_{kind}", "route": "cuda", "source": f"{PKG}/ops/csrc/ffw.cu",
            "replaces": f"{TPU_PKG}/ops/pallas_mlp.py:{line}",
            "max_abs_err": errs[0 if kind == "fwd" else 1], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
        }
        note = tensor_core_bounds(row, flops, nbytes)
        print(f"  fused_mlp_{kind} ms={ms:.4f} plain_ms={plain_ms:.4f} {note} "
              f"({row['bound_by']}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)", flush=True)
        row["ms_by_kernel"] = kernel_times(torch, call, 5)
        print(f"  fused_mlp_{kind} by kernel: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in row["ms_by_kernel"].items()), flush=True)
        out_rows.append(row)
    return out_rows


# the function's integer work a Philox4x32-10 call (ops/csrc/dropout_mask.cu),
# counter words c2 = c3 = 0: 10 rounds of two 32x32->64-bit products, less
# the first round's product of c2 = 0, and of two XORs; then four compares
# with the threshold
PHILOX_WIDE_PRODUCTS = 2 * 10 - 1
PHILOX_ALU_OPS = 2 * 10 + 4
# integer throughput of one SM of an H100 (CUDA C++ Programming Guide, compute
# capability 9.0): 64 32-bit results a clock on the integer multiply (IMAD)
# pipe, a 32x32->64-bit product two of them; 64 on the ALU pipe (logic,
# compare)
INT_LANES_PER_SM = 64


def mask_int_bound(calls: float, sms: int, clock_hz: float) -> float:
    """ms the card needs for ``calls`` Philox calls: the busier of the IMAD
    pipe (two 32-bit results a wide product) and the ALU pipe, over ``sms``
    SMs at ``clock_hz``."""
    lanes = max(2 * PHILOX_WIDE_PRODUCTS, PHILOX_ALU_OPS)
    return calls * lanes / (sms * INT_LANES_PER_SM * clock_hz) * 1e3


def sass_opcodes(build, library: Path, kernel: str) -> dict:
    """Opcode counts (with their modifiers, most first) of ``kernel``'s SASS
    in the shared library at ``library`` (``cuobjdump -sass``, beside
    ``nvcc``): a diagnostic printed beside a bound, not a bound."""
    import collections
    import re

    tool = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                         check=True).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", out)[1:]
                 if kernel in f.split("\n", 1)[0]), None)
    if body is None:
        raise RuntimeError(f"{kernel} not found in the SASS of {library}")
    return dict(collections.Counter(re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", body)).most_common())


def hgmma_counts(build, source: str, kernels) -> dict:
    """HGMMA instructions (Hopper's wgmma) in the SASS (``cuobjdump -sass``)
    of each kernel of ``source``'s library whose name holds one of
    ``kernels``, by the kernel's name and template arguments; raises where
    one has none."""
    import re

    tool = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(build._target(source))], capture_output=True,
                         text=True, check=True).stdout
    counts = {}
    for body in re.split(r"\n\s*Function : ", out)[1:]:
        name = body.split("\n", 1)[0].strip()
        if any(k in name for k in kernels):
            args = name.split("ILi", 1)[1].split("EE")[0] if "ILi" in name else ""
            counts[f"{_source_name(name)}<{args}>"] = len(re.findall(r"\bHGMMA\b", body))
    if not counts or not all(counts.values()):
        raise AssertionError(f"{source}: a wgmma kernel without HGMMA in its SASS: {counts}")
    return counts


def check_dropout_mask(torch, mlp, rows):
    """The mask generator vs its plain version, byte for byte, one mask a
    launch and a layer's three in one launch; the integer bound worked from
    the Philox calls the masks need beside the bytes bound, the kernel's SASS
    opcodes beside them; returns the table row (timed at the hidden mask's
    shape, the largest of a layer, and the layer's three masks in one
    launch)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build

    d, f, keep = 256, 2048, 0.8
    seed = torch.tensor([20240229, -77], dtype=torch.int32, device="cuda")
    cases = [(rows, d, keep, mlp.RNG_P_ATT), (rows, f, keep, mlp.RNG_P_HIDDEN),
             (rows, d, keep, mlp.RNG_P_RES), (rows, d, 1.0, mlp.RNG_P_RES),
             (rows, d, 0.0, mlp.RNG_P_ATT), (1021, 7, keep, mlp.RNG_P_HIDDEN)]
    mismatches = 0
    masks = {}
    for n, width, kp, purpose in cases:
        got = mlp.dropout_keep_mask(seed, n, width, kp, purpose)
        torch.cuda.synchronize()
        want = mlp.dropout_keep_mask_reference(seed, n, width, kp, purpose)
        differ = int((got != want).sum().item())
        rate = got.float().mean().item()
        sigma = (kp * (1 - kp) / got.numel()) ** 0.5
        print(f"  dropout_keep_mask [{n}, {width}] keep={kp} purpose={purpose}: "
              f"{differ} bytes differ from the plain version, keep rate {rate:.6f}", flush=True)
        mismatches += differ
        if got.dtype != torch.uint8 or abs(rate - kp) > 4 * sigma:
            raise AssertionError(f"dropout_keep_mask: keep rate {rate} is off {kp} by more "
                                 f"than 4 sigma ({sigma:.2e})")
        masks[(n, width, kp, purpose)] = got
    # a layer's three masks in one launch: the same bytes as one launch each
    layer = ((d, mlp.RNG_P_ATT), (f, mlp.RNG_P_HIDDEN), (d, mlp.RNG_P_RES))
    ragged = ((7, mlp.RNG_P_HIDDEN), (7, mlp.RNG_P_RES), (3, mlp.RNG_P_ATT))
    for n, specs, kp in ((rows, layer, keep), (rows, layer, 1.0), (rows, layer, 0.0),
                         (1021, ragged, keep)):
        before = mlp.dropout_keep_mask.launches
        got = mlp.dropout_keep_masks(seed, n, specs, kp)
        torch.cuda.synchronize()
        launches = mlp.dropout_keep_mask.launches - before
        differ = sum(int((m != mlp.dropout_keep_mask_reference(seed, n, c, kp, p)).sum().item())
                     for m, (c, p) in zip(got, specs))
        print(f"  dropout_keep_masks [{n}, {'/'.join(str(c) for c, _ in specs)}] keep={kp}: "
              f"{launches} launch, {differ} bytes differ from the plain version", flush=True)
        mismatches += differ
        if launches != 1:
            raise AssertionError(f"dropout_keep_masks: {launches} launches for one layer")
    if mismatches:
        raise AssertionError(f"dropout_keep_mask: {mismatches} bytes differ from the plain version")
    att, res = masks[cases[0]], masks[cases[2]]
    other_seed = mlp.dropout_keep_mask(seed + 1, rows, d, keep, mlp.RNG_P_ATT)
    again = mlp.dropout_keep_mask(seed.clone(), rows, d, keep, mlp.RNG_P_ATT)
    if torch.equal(att, res) or torch.equal(att, other_seed) or not torch.equal(att, again):
        raise AssertionError("dropout_keep_mask: masks must differ by purpose and seed and "
                             "repeat for the same seed")

    # the integer bound, worked from the function: elements / 4 Philox calls
    # at the card's integer rate and maximum SM clock
    info = (ctypes.c_int * 3)()
    if _build.library("dropout_mask").msfa_dropout_mask_info(info):
        raise RuntimeError("msfa_dropout_mask_info failed")
    threads, calls_per_iter, resident = info[0], info[1], info[2]
    opcodes = sass_opcodes(_build, _build._target("dropout_mask"), "dropout_mask_kernel")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"  integer work a Philox call: {PHILOX_WIDE_PRODUCTS} wide products "
          f"({2 * PHILOX_WIDE_PRODUCTS} IMAD-pipe results), {PHILOX_ALU_OPS} ALU operations; "
          f"{sms} SMs at {clock_mhz:.0f} MHz (clocks.max.sm), {INT_LANES_PER_SM} lanes a clock "
          f"per pipe and SM; the kernel: {threads} threads a block, {resident} blocks resident, "
          f"{calls_per_iter} Philox calls a pass of its loop; its SASS (diagnostic, "
          f"{sum(opcodes.values())} instructions): {list(opcodes.items())[:12]}", flush=True)

    def bounds(elements, label):
        """(bound ms, by, bytes bound ms, integer bound ms) of ``elements``
        mask bytes: the mask and the seed moved; elements / 4 Philox calls."""
        b_bytes, _ = bound(0.0, float(elements + 8))
        b_int = mask_int_bound(elements / 4, sms, clock_mhz * 1e6)
        print(f"  {label}: bound_ms={max(b_bytes, b_int):.4f} (integer operations "
              f"{b_int:.4f}: {elements / 4 / 1e6:.2f} M Philox calls; bytes {b_bytes:.4f}: "
              f"{elements / 1e6:.2f} MB)", flush=True)
        return (max(b_bytes, b_int), "operations" if b_int >= b_bytes else "bytes", b_bytes,
                b_int)

    # each shape's call alone, L2-warm and L2-cold, and back to back (at the
    # residual and attention masks' shape the host sets the back-to-back
    # pace), beside the plain version and the library call
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    timed = {}
    for width in (f, d):
        row = timed[width] = {}
        warm_cold(torch, row, lambda: mlp.dropout_keep_mask(seed, rows, width, keep,
                                                            mlp.RNG_P_HIDDEN),
                  f"dropout_keep_mask [{rows}, {width}]")

        def lib_call():
            return (torch.rand((rows, width), device="cuda") < keep).to(torch.uint8)

        row["plain_ms"] = time_ms(lambda: mlp.dropout_keep_mask_reference(
            seed, rows, width, keep, mlp.RNG_P_HIDDEN), iters=5)
        row["library_ms"], row["library_ms_cold"] = device_ms(lib_call), device_ms(lib_call,
                                                                                    flush=flush)
        row["library_ms_back_to_back"] = time_ms(lib_call)
        row["bound_ms"], row["bound_by"], row["bound_ms_bytes"], row["bound_ms_int"] = bounds(
            rows * width, f"[{rows}, {width}]")
        print(f"  [{rows}, {width}] plain_ms={row['plain_ms']:.4f}; torch.rand < keep "
              f"{row['library_ms']:.4f} L2-warm, {row['library_ms_cold']:.4f} L2-cold (each call "
              f"alone), {row['library_ms_back_to_back']:.4f} back to back", flush=True)
    # a layer's three masks: one launch, against one launch a mask and three
    # library calls; back to back and each call alone
    trio = {}
    warm_cold(torch, trio, lambda: mlp.dropout_keep_masks(seed, rows, layer, keep),
              f"dropout_keep_masks [{rows}, {d}/{f}/{d}] (one launch)")

    def one_each():
        return [mlp.dropout_keep_mask(seed, rows, c, keep, p) for c, p in layer]

    def lib_each():
        return [(torch.rand((rows, c), device="cuda") < keep).to(torch.uint8) for c, _ in layer]

    trio["one_each_ms"], trio["one_each_ms_alone"] = time_ms(one_each), device_ms(one_each)
    trio["library_ms"], trio["library_ms_alone"] = time_ms(lib_each), device_ms(lib_each)
    del flush
    trio_bound = bounds(rows * (2 * d + f), f"the layer's three masks, [{rows}, {d}/{f}/{d}]")
    wide, narrow = timed[f], timed[d]
    print(f"  one launch a mask: {trio['one_each_ms']:.4f} ms back to back, "
          f"{trio['one_each_ms_alone']:.4f} alone; torch.rand < keep x3 "
          f"{trio['library_ms']:.4f} back to back, {trio['library_ms_alone']:.4f} alone; the "
          f"three-mask launch alone is {trio['ms'] / wide['ms']:.3f}x the wide mask alone",
          flush=True)
    # the row: the wide mask, `ms` back to back (as every other row's `ms`)
    # and `ms_alone` its call alone
    return {
        "name": "dropout_keep_mask", "route": "cuda",
        "source": f"{PKG}/ops/csrc/dropout_mask.cu",
        "replaces": f"{TPU_PKG}/ops/pallas_mlp.py:168",
        "max_abs_err": float(mismatches), "ms": wide["ms_back_to_back"],
        "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": wide["library_ms_back_to_back"], "bound_ms_bytes": wide["bound_ms_bytes"],
        "bound_ms_int": wide["bound_ms_int"],
        "bound_share": wide["bound_ms"] / wide["ms_back_to_back"],
        "ms_alone": wide["ms"], "ms_alone_cold": wide["ms_cold"],
        "bound_share_alone": wide["bound_ms"] / wide["ms"],
        "library_ms_alone": wide["library_ms"], "library_ms_alone_cold": wide["library_ms_cold"],
        "int_work": {"wide_products_a_call": PHILOX_WIDE_PRODUCTS,
                     "alu_ops_a_call": PHILOX_ALU_OPS, "sms": sms, "clock_mhz": clock_mhz,
                     "resident_blocks": resident, "sass_opcodes": opcodes},
        f"n{d}": {"shape": [rows, d], "ms_alone": narrow["ms"], "ms_alone_cold": narrow["ms_cold"],
                  "ms_back_to_back": narrow["ms_back_to_back"], "plain_ms": narrow["plain_ms"],
                  "library_ms": narrow["library_ms"], "library_ms_cold": narrow["library_ms_cold"],
                  "library_ms_back_to_back": narrow["library_ms_back_to_back"],
                  "bound_ms": narrow["bound_ms"], "bound_ms_bytes": narrow["bound_ms_bytes"],
                  "bound_ms_int": narrow["bound_ms_int"]},
        "layer": {"shape": [rows, [d, f, d]], "ms": trio["ms_back_to_back"],
                  "ms_alone": trio["ms"], "ms_alone_cold": trio["ms_cold"],
                  "one_launch_a_mask_ms": trio["one_each_ms"],
                  "one_launch_a_mask_ms_alone": trio["one_each_ms_alone"],
                  "library_ms": trio["library_ms"], "library_ms_alone": trio["library_ms_alone"],
                  "bound_ms": trio_bound[0], "bound_ms_bytes": trio_bound[2],
                  "bound_ms_int": trio_bound[3]},
    }


HEADS, HEAD_DIM = 4, 64  # the flagship's attention shape


def _flash_inputs(torch, batch, seq, seed):
    """q, k, v, dout ``[B*H, T, d]`` on the card."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(batch * HEADS, seq, HEAD_DIM, generator=g).cuda() for _ in range(4)]


def _edge_lengths(torch, lengths, seq):
    edge = lengths.clone().cpu()
    edge[:8] = torch.tensor([0, 1, 37, 64, 65, seq - 1, seq, 8], dtype=torch.int32)
    return edge.cuda()


def _plain_forward(torch, attn, q, k, v, lengths, scale, slice_batch=8):
    """The plain forward over slices of the batch: at T = 4096 its scores are
    17 GB for the whole batch of 64."""
    outs, lses = [], []
    for b0 in range(0, len(lengths), slice_batch):
        rows = slice(b0 * HEADS, (b0 + slice_batch) * HEADS)
        o, l = attn.flash_attention_reference(
            q[rows], k[rows], v[rows], lengths[b0:b0 + slice_batch], HEADS, scale)
        outs.append(o)
        lses.append(l)
    return torch.cat(outs), torch.cat(lses)


def _flash_work(torch, lengths, seq, products, tensors):
    """(flops, bytes, note) of a kernel that does ``products`` products over
    the valid keys and moves ``tensors`` [B*H, T, d] arrays plus lse/delta."""
    keys = float(lengths.clamp(0, seq).sum().item())
    rows = len(lengths) * HEADS
    flops = 2.0 * products * HEADS * HEAD_DIM * seq * keys
    nbytes = 4.0 * (tensors * rows * seq * HEAD_DIM + 2 * rows * seq + len(lengths))
    return flops, nbytes, f"{keys:.0f} valid keys, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB"


def _sdpa(torch, q, k, v, lengths, seq, grad=False):
    """The library yardstick: SDPA with the same key mask, on [B, H, T, d]."""
    batch = len(lengths)
    shape = (batch, HEADS, seq, HEAD_DIM)
    key_mask = (torch.arange(seq, device="cuda")[None, :] < lengths[:, None].long())[:, None, None, :]
    leaves = [t.view(shape).detach().requires_grad_(grad) for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return leaves, (lambda: sdpa(*leaves, attn_mask=key_mask))


def check_flash_kernels(torch, attn, real_lengths):
    """The five flash_self_attention kernels vs their plain versions at the
    long windows' shapes; ``real_lengths[T]`` are a real batch's lengths at
    chunk T. Returns the five table rows."""
    scale = HEAD_DIM**-0.5
    fwd = {"single": attn.flash_fwd_single, "tiled": attn.flash_fwd_tiled}
    errs = dict.fromkeys(("single", "tiled", "fused", "dkv", "dq"), 0.0)

    def forward_case(label, which, q, k, v, lens):
        out, lse = fwd[which](q, k, v, lens, HEADS, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = _plain_forward(torch, attn, q, k, v, lens, scale)
        valid = ref_lse > attn.NEG_INF / 2
        if not torch.equal(valid, lse > attn.NEG_INF / 2):
            raise AssertionError(f"flash_fwd_{which} {label}: rows without keys differ")
        e_out = (out - ref_out).abs().max().item()
        e_lse = (lse[valid] - ref_lse[valid]).abs().max().item()
        for b in (lens == 0).nonzero().flatten().tolist():
            if out[b * HEADS:(b + 1) * HEADS].abs().max().item() != 0.0:
                raise AssertionError(f"flash_fwd_{which} {label}: a length-0 row is not zero")
        print(f"  flash_fwd_{which} {label}: max_abs_err out={e_out:.3e} lse={e_lse:.3e} "
              f"(tol {ATTN_TOL})", flush=True)
        errs[which] = max(errs[which], e_out, e_lse)
        return out, lse

    def backward_case(label, route, q, k, v, dout, lens):
        out, lse = attn.flash_attention_reference(q, k, v, lens, HEADS, scale)
        delta = attn.flash_delta(out, dout)
        args = (q, k, v, lens, HEADS, lse, delta, dout, scale)
        if route == "fused":
            got = dict(zip(("dq", "dk", "dv"), attn.flash_bwd_fused(*args)))
        else:
            dk, dv = attn.flash_bwd_dkv(*args)
            got = {"dq": attn.flash_bwd_dq(*args), "dk": dk, "dv": dv}
        torch.cuda.synchronize()
        want = dict(zip(("dq", "dk", "dv"), attn.flash_attention_bwd_reference(
            q, k, v, lens, HEADS, out, lse, dout, scale)))
        e = {name: rel_err(got[name], want[name]) for name in got}
        for b, n in enumerate(lens.tolist()):
            rows = slice(b * HEADS, (b + 1) * HEADS)
            if n == 0 and any(g[rows].abs().max().item() != 0.0 for g in got.values()):
                raise AssertionError(f"flash backward ({route}) {label}: length 0 has a gradient")
            if n < q.shape[1] and max(got["dk"][rows, n:].abs().max().item(),
                                      got["dv"][rows, n:].abs().max().item()) != 0.0:
                raise AssertionError(f"flash backward ({route}) {label}: keys past the length "
                                     "have dk/dv")
        print(f"  flash backward ({route}) {label}: rel err dq={e['dq']:.3e} dk={e['dk']:.3e} "
              f"dv={e['dv']:.3e} (tol {GRAD_TOL})", flush=True)
        if route == "fused":
            errs["fused"] = max(errs["fused"], *e.values())
        else:
            errs["dkv"] = max(errs["dkv"], e["dk"], e["dv"])
            errs["dq"] = max(errs["dq"], e["dq"])

    data = {}
    for seq, batch in ((1024, 32), (2048, 32), (4096, 64), (512, 128)):
        data[seq] = (*_flash_inputs(torch, batch, seq, seed=seq),
                     real_lengths[seq][:batch].contiguous())
    pad = (*_flash_inputs(torch, 3, 1100, seed=11),
           torch.tensor([0, 1100, 777], dtype=torch.int32).cuda())

    # forwards: rows 3 and 4
    for seq in (1024, 2048, 512):
        q, k, v, _dout, lens = data[seq]
        forward_case(f"T={seq} B*H={q.shape[0]} real lengths", "single", q, k, v, lens)
        forward_case(f"T={seq} B*H={q.shape[0]} edge lengths", "single", q, k, v,
                     _edge_lengths(torch, lens, seq))
    g = torch.Generator().manual_seed(16)
    for d in (16, 32, 128):  # every head dim the single-key-block kernel takes
        q, k, v = (torch.randn(8 * HEADS, 300, d, generator=g).cuda() for _ in range(3))
        lens = torch.tensor([0, 1, 37, 64, 65, 299, 300, 150], dtype=torch.int32).cuda()
        out, lse = attn.flash_fwd_single(q, k, v, lens, HEADS, d**-0.5)
        torch.cuda.synchronize()
        ref_out, ref_lse = attn.flash_attention_reference(q, k, v, lens, HEADS, d**-0.5)
        valid = ref_lse > attn.NEG_INF / 2
        e = max((out - ref_out).abs().max().item(), (lse[valid] - ref_lse[valid]).abs().max().item())
        if out[:HEADS].abs().max().item() != 0.0 or not torch.equal(valid, lse > attn.NEG_INF / 2):
            raise AssertionError(f"flash_fwd_single d={d}: rows without keys differ")
        print(f"  flash_fwd_single d={d} T=300 edge lengths: max_abs_err {e:.3e} (tol {ATTN_TOL})",
              flush=True)
        errs["single"] = max(errs["single"], e)
    q, k, v, _dout, lens = data[4096]
    forward_case("T=4096 real lengths", "tiled", q, k, v, lens)
    forward_case("T=4096 edge lengths", "tiled", q, k, v, _edge_lengths(torch, lens, 4096))
    for which in ("single", "tiled"):
        forward_case("padded T=1100", which, *pad[:3], pad[4])
    q, k, v, _dout, lens = data[2048]
    single = forward_case("T=2048 edge (vs tiled)", "single", q, k, v,
                          _edge_lengths(torch, lens, 2048))
    tiled = forward_case("T=2048 edge (vs single)", "tiled", q, k, v,
                         _edge_lengths(torch, lens, 2048))
    e_routes = max((single[0] - tiled[0]).abs().max().item(),
                   (single[1] - tiled[1]).abs().max().item())
    same_bits = torch.equal(single[0], tiled[0]) and torch.equal(single[1], tiled[1])
    print(f"  single-key-block vs tiled forward on the same inputs at T=2048: max abs diff "
          f"{e_routes:.3e} (tol {ATTN_TOL}), bit for bit: {same_bits}", flush=True)
    if max(errs["single"], errs["tiled"], e_routes) > ATTN_TOL:
        raise AssertionError(f"flash forward kernels disagree: {errs}, routes {e_routes}")
    if not same_bits:  # one body, two entries
        raise AssertionError("flash forward kernels differ in bits on the same inputs")

    # backwards: rows 5, 6, 7
    for seq, route in ((1024, "fused"), (512, "fused"), (2048, "split")):
        q, k, v, dout, lens = data[seq]
        backward_case(f"T={seq} B*H={q.shape[0]} real lengths", route, q, k, v, dout, lens)
        backward_case(f"T={seq} B*H={q.shape[0]} edge lengths", route, q, k, v, dout,
                      _edge_lengths(torch, lens, seq))
    for route in ("fused", "split"):
        backward_case("padded T=1100", route, *pad)
    g = torch.Generator().manual_seed(17)
    for d in (16, 32, 128):  # every head dim the split pair takes
        q, k, v, dout = (torch.randn(8 * HEADS, 300, d, generator=g).cuda() for _ in range(4))
        lens = torch.tensor([0, 1, 37, 64, 65, 299, 300, 150], dtype=torch.int32).cuda()
        out, lse = attn.flash_attention_reference(q, k, v, lens, HEADS, d**-0.5)
        args = (q, k, v, lens, HEADS, lse, attn.flash_delta(out, dout), dout, d**-0.5)
        dk, dv = attn.flash_bwd_dkv(*args)
        got = {"dq": attn.flash_bwd_dq(*args), "dk": dk, "dv": dv}
        torch.cuda.synchronize()
        want = dict(zip(("dq", "dk", "dv"), attn.flash_bwd_fused_reference(*args)))
        e = {name: rel_err(got[name], want[name]) for name in got}
        for b, n in enumerate(lens.tolist()):
            rows = slice(b * HEADS, (b + 1) * HEADS)
            if n == 0 and any(t[rows].abs().max().item() != 0.0 for t in got.values()):
                raise AssertionError(f"flash backward (split) d={d}: length 0 has a gradient")
            if n < 300 and max(dk[rows, n:].abs().max().item(),
                               dv[rows, n:].abs().max().item()) != 0.0:
                raise AssertionError(f"flash backward (split) d={d}: keys past the length have "
                                     "dk/dv")
        print(f"  flash backward (split) d={d} T=300 edge lengths: rel err dq={e['dq']:.3e} "
              f"dk={e['dk']:.3e} dv={e['dv']:.3e} (tol {GRAD_TOL})", flush=True)
        errs["dkv"] = max(errs["dkv"], e["dk"], e["dv"])
        errs["dq"] = max(errs["dq"], e["dq"])
    # no atomics: each backward kernel twice on the same inputs, bit for bit;
    # the split dk/dv is the fused body without its dq: the fused dk, dv bits
    for seq in (1024, 2048):
        q, k, v, dout, lens = data[seq]
        lens = _edge_lengths(torch, lens, seq)
        out, lse = attn.flash_fwd_single(q, k, v, lens, HEADS, scale)
        args = (q, k, v, lens, HEADS, lse, attn.flash_delta(out, dout), dout, scale)
        runs = {"fused": (attn.flash_bwd_fused(*args), attn.flash_bwd_fused(*args)),
                "dkv": (attn.flash_bwd_dkv(*args), attn.flash_bwd_dkv(*args)),
                "dq": ((attn.flash_bwd_dq(*args),), (attn.flash_bwd_dq(*args),))}
        torch.cuda.synchronize()
        for name, (first, second) in runs.items():
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"flash backward ({name}) T={seq}: two runs differ")
        fused_dq, fused_dk, fused_dv = runs["fused"][0]
        split_dk, split_dv = runs["dkv"][0]
        if not (torch.equal(split_dk, fused_dk) and torch.equal(split_dv, fused_dv)):
            raise AssertionError(f"flash_bwd_dkv T={seq}: dk/dv differ from the fused kernel's "
                                 "in bits")
        dq_diff = (runs["dq"][0][0] - fused_dq).abs().max().item()
        print(f"  flash backward T={seq} edge lengths: fused, dkv and dq each twice, bit for "
              f"bit; split dk, dv = fused dk, dv bit for bit; split dq vs fused dq max abs diff "
              f"{dq_diff:.3e} (rel {dq_diff / fused_dq.abs().max().item():.3e})", flush=True)
        del runs, args, fused_dq, fused_dk, fused_dv, split_dk, split_dv
    if max(errs["fused"], errs["dkv"], errs["dq"]) > GRAD_TOL:
        raise AssertionError(f"flash backward kernels disagree with their plain versions: {errs}")

    # times: each kernel at its main path's shape, and both routes at 1024 and 2048
    def time_forward(which, seq):
        q, k, v, _dout, lens = data[seq]
        return time_ms(lambda: fwd[which](q, k, v, lens, HEADS, scale), iters=10)

    def backward_args(seq):
        q, k, v, dout, lens = data[seq]
        out, lse = attn.flash_fwd_tiled(q, k, v, lens, HEADS, scale)
        return (q, k, v, lens, HEADS, lse, attn.flash_delta(out, dout), dout, scale)

    def route_ms(seq, route):
        """Forward and backward through ``flash_self_attention`` at the
        default blocks, the backward route pinned by ``fused_bwd_max``; the
        launch counters must show that route alone."""
        q, k, v, dout, lens = data[seq]
        shape = (len(lens), HEADS, seq, HEAD_DIM)
        leaves = [t.view(shape).detach().requires_grad_() for t in (q, k, v)]
        pin = seq if route == "fused" else 0
        if attn.flash_routes(seq, fused_bwd_max=pin)[1] != route:
            raise AssertionError(f"fused_bwd_max={pin} does not pin the {route} route at T={seq}")

        def step():
            out = attn.flash_self_attention(*leaves, lens, fused_bwd_max=pin)
            torch.autograd.grad(out, leaves, dout.view(shape))

        counters = (attn.flash_bwd_fused, attn.flash_bwd_dkv, attn.flash_bwd_dq)
        before = [fn.launches for fn in counters]
        ms = time_ms(step, iters=5)
        moved = [fn.launches - b for fn, b in zip(counters, before)]
        if moved != ([8, 0, 0] if route == "fused" else [0, 8, 8]):
            raise AssertionError(f"flash_self_attention {route} route at T={seq}: launches {moved}")
        return ms

    other = {}
    for seq in (1024, 2048):
        args = backward_args(seq)
        other[seq] = {
            "single": time_forward("single", seq), "tiled": time_forward("tiled", seq),
            "fused": time_ms(lambda: attn.flash_bwd_fused(*args), iters=5),
            "dkv": time_ms(lambda: attn.flash_bwd_dkv(*args), iters=5),
            "dq": time_ms(lambda: attn.flash_bwd_dq(*args), iters=5),
            "delta": time_ms(lambda: attn.flash_delta(args[-2], args[-2]), iters=10),
        }
        t = other[seq]
        t["route_fused"], t["route_split"] = (route_ms(seq, "fused"), route_ms(seq, "split"))
        print(f"  routes at T={seq}, B*H=128, real lengths: forward single {t['single']:.4f} ms, "
              f"tiled {t['tiled']:.4f} ms; backward fused {t['fused']:.4f} ms, split "
              f"{t['dkv'] + t['dq']:.4f} ms (dkv {t['dkv']:.4f} + dq {t['dq']:.4f}); delta "
              f"{t['delta']:.4f} ms; flash_self_attention forward + backward, backward route "
              f"pinned: fused {t['route_fused']:.4f} ms, split {t['route_split']:.4f} ms",
              flush=True)
    args512 = backward_args(512)
    fused512 = time_ms(lambda: attn.flash_bwd_fused(*args512), iters=5)
    single512 = time_forward("single", 512)
    print(f"  grouped shape T=512, B*H=512: forward single {single512:.4f} ms, backward fused "
          f"{fused512:.4f} ms", flush=True)
    del args512

    def sdpa_ms(seq, wrt=None):
        """SDPA's time on the inputs at T = seq: forward, or its backward with
        respect to ``wrt`` ("qkv", "kv" or "q")."""
        q, k, v, dout, lens = data[seq]
        leaves, call = _sdpa(torch, q, k, v, lens, seq, grad=wrt is not None)
        if wrt is None:
            return time_ms(call, iters=10)
        out = call()
        grads = {"qkv": leaves, "kv": leaves[1:], "q": leaves[:1]}[wrt]
        return time_ms(lambda: torch.autograd.grad(out, grads, dout.view(out.shape),
                                                   retain_graph=True), iters=5)

    rows = []
    specs = (  # name, kernel key, T, products, tensors moved, TPU kernel line, source, library
        ("flash_fwd_single", "single", 1024, 2, 4, 159, "flash_attention.cu", "fwd"),
        ("flash_fwd_tiled", "tiled", 4096, 2, 4, 89, "flash_attention.cu", "fwd"),
        ("flash_bwd_fused", "fused", 1024, 5, 7, 444, "flash_attention_bwd.cu", "qkv"),
        ("flash_bwd_dkv", "dkv", 2048, 4, 6, 316, "flash_attention_bwd.cu", "kv"),
        ("flash_bwd_dq", "dq", 2048, 3, 5, 386, "flash_attention_bwd.cu", "q"),
    )
    for name, key, seq, products, tensors, line, src, lib in specs:
        q, k, v, dout, lens = data[seq]
        ms = other[seq][key] if seq in other else time_forward(key, seq)
        library_ms = sdpa_ms(seq, None if lib == "fwd" else lib)
        if lib == "fwd":
            plain_ms = time_ms(lambda: _plain_forward(torch, attn, q, k, v, lens, scale), iters=3)
        else:
            out, lse = attn.flash_fwd_tiled(q, k, v, lens, HEADS, scale)
            delta = attn.flash_delta(out, dout)
            ref = {"qkv": lambda: attn.flash_attention_bwd_reference(
                       q, k, v, lens, HEADS, out, lse, dout, scale),
                   "kv": lambda: attn.flash_dkv_reference(
                       q, k, v, lens, HEADS, lse, delta, dout, scale),
                   "q": lambda: attn.flash_dq_reference(
                       q, k, v, lens, HEADS, lse, delta, dout, scale)}[lib]
            plain_ms = time_ms(ref, iters=3)
        flops, nbytes, note = _flash_work(torch, lens, seq, products, tensors)
        row = {
            "name": name, "route": "cuda", "source": f"{PKG}/ops/csrc/{src}",
            "replaces": f"{TPU_PKG}/ops/pallas_attention.py:{line}",
            "max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "shape": [q.shape[0], seq, HEAD_DIM],
        }
        if name in TENSOR_CORE_KERNELS:
            bounds = tensor_core_bounds(row, flops, nbytes)
        else:
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
            bounds = f"bound_ms={row['bound_ms']:.4f}"
        print(f"  {name} T={seq} B*H={q.shape[0]}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"sdpa_ms={library_ms:.4f} {bounds} ({row['bound_by']}; {note})", flush=True)
        rows.append(row)
    # the other shapes each row reports, with SDPA timed beside every one
    single, tiled, fused = rows[0], rows[1], rows[2]
    single["ms_t2048"], single["library_ms_t2048"] = other[2048]["single"], sdpa_ms(2048)
    single["ms_t512_bh512"], single["library_ms_t512_bh512"] = single512, sdpa_ms(512)
    for suffix, seq in (("_t2048", 2048), ("_t512_bh512", 512)):
        flops, nbytes, _ = _flash_work(torch, data[seq][4], seq, 2, 4)
        print(f"  flash_fwd_single T={seq} B*H={data[seq][0].shape[0]}: ms={single['ms' + suffix]:.4f} "
              f"sdpa_ms={single['library_ms' + suffix]:.4f} "
              f"{tensor_core_bounds(single, flops, nbytes, suffix)}", flush=True)
    tiled["ms_t1024"], tiled["library_ms_t1024"] = other[1024]["tiled"], rows[0]["library_ms"]
    tiled["ms_t2048"], tiled["library_ms_t2048"] = other[2048]["tiled"], single["library_ms_t2048"]
    for suffix, seq in (("_t1024", 1024), ("_t2048", 2048)):
        flops, nbytes, _ = _flash_work(torch, data[seq][4], seq, 2, 4)
        print(f"  flash_fwd_tiled T={seq} B*H={data[seq][0].shape[0]}: ms={tiled['ms' + suffix]:.4f} "
              f"sdpa_ms={tiled['library_ms' + suffix]:.4f} "
              f"{tensor_core_bounds(tiled, flops, nbytes, suffix)}", flush=True)
    fused["ms_t512_bh512"], fused["library_ms_t512_bh512"] = fused512, sdpa_ms(512, "qkv")
    fused["ms_t2048"], fused["library_ms_t2048"] = other[2048]["fused"], sdpa_ms(2048, "qkv")
    for suffix, seq in (("_t512_bh512", 512), ("_t2048", 2048)):
        flops, nbytes, _ = _flash_work(torch, data[seq][4], seq, 5, 7)
        print(f"  flash_bwd_fused T={seq} B*H={data[seq][0].shape[0]}: ms={fused['ms' + suffix]:.4f} "
              f"sdpa_ms={fused['library_ms' + suffix]:.4f} "
              f"{tensor_core_bounds(fused, flops, nbytes, suffix)}", flush=True)
    fused["routes_fwd_bwd_ms"] = {
        f"t{seq}": {"fused": other[seq]["route_fused"], "split": other[seq]["route_split"]}
        for seq in (1024, 2048)}
    for row, key, products, tensors, wrt in ((rows[3], "dkv", 4, 6, "kv"),
                                             (rows[4], "dq", 3, 5, "q")):
        row["ms_t1024"], row["library_ms_t1024"] = other[1024][key], sdpa_ms(1024, wrt)
        flops, nbytes, _ = _flash_work(torch, data[1024][4], 1024, products, tensors)
        print(f"  {row['name']} T=1024 B*H={data[1024][0].shape[0]}: ms={row['ms_t1024']:.4f} "
              f"sdpa_ms={row['library_ms_t1024']:.4f} "
              f"{tensor_core_bounds(row, flops, nbytes, '_t1024')}", flush=True)
    print(f"  SDPA beside the other shapes: forward T=1024 {rows[0]['library_ms']:.4f}, "
          f"T=2048 {single['library_ms_t2048']:.4f}, [512, 512, 64] "
          f"{single['library_ms_t512_bh512']:.4f} ms; backward [512, 512, 64] "
          f"{fused['library_ms_t512_bh512']:.4f}, T=2048 {fused['library_ms_t2048']:.4f} ms",
          flush=True)
    return rows


RNN_G, RNN_H, RNN_D = 4, 256, 17  # the parity model's group: 4 modalities, hidden 256, D_max 17


# rows 16-18: the serving cluster body at H 256 (row 16 over the precomputed x_proj)
CLUSTER_SERVING = ("grouped_lstm_forward", "grouped_lstm_fused", "grouped_gru_fused")


def rnn_cluster_geometry(rnn):
    """Print the serving cluster body's launch for rows 16-18 at the
    evaluation (32) and serving (64) batch; fail unless they take the
    cluster body and the serving batch runs in one wave. Returns the info
    by (kernel, batch)."""
    out = {}
    for name in CLUSTER_SERVING:
        cell = name.split("_")[1]
        proj = name == "grouped_lstm_forward"
        route = rnn.grouped_lstm_forward_route(RNN_H) if proj else \
            rnn.grouped_fused_route(RNN_H, RNN_D)
        if route != "cluster":
            raise AssertionError(f"{name} must run its cluster body at H {RNN_H}, D {RNN_D}")
        for batch in (32, BATCH):
            info = rnn.grouped_lstm_forward_cluster_info(RNN_H, batch, RNN_G) if proj else \
                rnn.grouped_fused_cluster_info(cell, RNN_H, RNN_D, batch, RNN_G)
            picked = info[f"rows{info['rows']}"]
            tilings = "; ".join(
                f"{rows} rows: {t['threads']} threads, {t['smem_bytes']} bytes of shared "
                f"memory, {t['active_clusters']} active clusters, {t['clusters_per_launch']} "
                f"clusters per launch, {t['waves']} waves"
                for rows, t in ((r, info[f"rows{r}"]) for r in rnn.CLUSTER_ROWS))
            print(f"  {name} at H={RNN_H} D={RNN_D} G={RNN_G} B={batch}: route {route}, "
                  f"{info['ctas_per_cluster']} CTAs a cluster, {info['rows']} rows a cluster "
                  f"picked ({picked['clusters_per_launch']} clusters, {picked['waves']} wave(s)); "
                  f"{tilings}", flush=True)
            if picked["waves"] != 1:
                raise AssertionError(f"{name} at B {batch}: {picked['waves']} waves of clusters")
            out[(name, batch)] = info
    return out


def check_rnn_kernels(torch, rnn, real_lengths):
    """The three grouped-recurrence kernels vs their plain versions at the
    parity model's shapes; ``real_lengths[T]`` are a real batch-64's lengths
    at chunk T. All three (their cluster body) also launch twice on every
    case, bit for bit, and run both tilings (16 and 32 rows a cluster) at
    B 32 and 64, each held to its plain version and timed. Returns the three
    table rows."""
    g = torch.Generator().manual_seed(5)
    scale = RNN_H**-0.5

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).cuda()

    weights = {}
    for gates in (4, 3):
        weights[gates] = (u(RNN_G, RNN_D, gates * RNN_H), u(RNN_G, RNN_H, gates * RNN_H),
                          u(RNN_G, gates * RNN_H), u(RNN_G, gates * RNN_H))
    geometry = rnn_cluster_geometry(rnn)

    def calls(name, x, lens, **kw):
        """(kernel call, plain call) of one kernel on x [T, G, B, D]."""
        w_ih, w_hh, b_ih, b_hh = weights[3 if name == "grouped_gru_fused" else 4]
        if name == "grouped_lstm_forward":
            x_proj = (torch.einsum("tgbd,gdh->tgbh", x, w_ih) + b_ih[None, :, None, :]).contiguous()
            args = (x_proj, w_hh, b_hh, lens)
        elif name == "grouped_lstm_fused":
            args = (x, w_ih, w_hh, b_ih + b_hh, lens)
        else:
            args = (x, w_ih, w_hh, b_ih, b_hh, lens)
        kernel, plain = getattr(rnn, name), getattr(rnn, name + "_plain")
        return (lambda: kernel(*args, **kw)), (lambda: plain(*args))

    names = ("grouped_lstm_forward", "grouped_lstm_fused", "grouped_gru_fused")
    errs = dict.fromkeys(names, 0.0)
    timed, tilings = {}, {}
    for seq in (512, 1024):
        x = torch.randn(seq, RNN_G, BATCH, RNN_D, generator=g).cuda()
        real = real_lengths[seq]
        edge = real.clone().cpu()
        edge[:6] = torch.tensor([0, 1, 37, seq - 1, seq, 8], dtype=torch.int32)
        cases = [("real lengths", x, real), ("edge lengths", x, edge.cuda()), ("no lengths", x, None)]
        if seq == 512:  # a B and a T that are not multiples of 8
            cases.append(("B=13 T=509", x[:509, :, :13].contiguous(), edge[:13].cuda()))
        for label, xc, lens in cases:
            for name in names:
                kernel, plain = calls(name, xc, lens)
                got = kernel()
                again = kernel()
                torch.cuda.synchronize()
                want = plain()
                e = (got - want).abs().max().item()
                if lens is not None:
                    for b in (lens == 0).nonzero().flatten().tolist():
                        if got[:, b].abs().max().item() != 0.0:
                            raise AssertionError(f"{name} {label}: a length-0 row is not zero")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} {label}: a second launch gave other bits")
                print(f"  {name} T={xc.shape[0]} B={xc.shape[2]} {label}: max_abs_err {e:.3e} "
                      f"(tol {RNN_TOL}); repeats bit for bit", flush=True)
                errs[name] = max(errs[name], e)
        # rows 16-18 at both tilings, the evaluation and the serving batch
        for name in CLUSTER_SERVING:
            for batch in (32, BATCH):
                xb = x[:, :, :batch].contiguous()
                for rows in rnn.CLUSTER_ROWS:
                    kernel, plain = calls(name, xb, real[:batch], cluster_rows=rows)
                    got = kernel()
                    torch.cuda.synchronize()
                    e = (got - plain()).abs().max().item()
                    errs[name] = max(errs[name], e)
                    ms = time_ms(kernel, iters=5, warmup=2)
                    tilings[(name, seq, batch, rows)] = ms
                    info = geometry[(name, batch)][f"rows{rows}"]
                    print(f"  {name} T={seq} B={batch} at {rows} rows a cluster "
                          f"({info['clusters_per_launch']} clusters, {info['waves']} wave(s)): "
                          f"max_abs_err {e:.3e}, ms={ms:.4f} ({ms / seq * 1e3:.3f} us per step)",
                          flush=True)
        if max(errs.values()) > RNN_TOL:
            raise AssertionError(f"recurrence kernels disagree with their plain versions: {errs}")

        # times on the real batch's lengths; cuDNN through one module per group
        # carrying the same weights, run over the full T for every row (its
        # packed path refuses a length of 0, so lengths are not handled)
        steps = float(real.clamp(0, seq).sum().item())
        for name in names:
            gates = 3 if name == "grouped_gru_fused" else 4
            w_ih, w_hh, b_ih, b_hh = weights[gates]
            kernel, plain = calls(name, x, real)
            ms = time_ms(kernel, iters=5, warmup=2)
            plain_ms = time_ms(plain, iters=2, warmup=1)
            modules = []
            for k in range(RNN_G):
                mod = (torch.nn.GRU if gates == 3 else torch.nn.LSTM)(RNN_D, RNN_H).cuda()
                with torch.no_grad():
                    mod.weight_ih_l0.copy_(w_ih[k].t())
                    mod.weight_hh_l0.copy_(w_hh[k].t())
                    mod.bias_ih_l0.copy_(b_ih[k])
                    mod.bias_hh_l0.copy_(b_hh[k])
                mod.flatten_parameters()
                modules.append(mod)
            inputs = [x[:, k].contiguous() for k in range(RNN_G)]

            @torch.inference_mode()
            def library():
                return [m(xi)[1] for m, xi in zip(modules, inputs)]

            library_ms = time_ms(library, iters=5, warmup=2)
            state = torch.stack([(h[0] if gates == 4 else h)[0] for h in library()])
            full = real >= seq  # rows cuDNN ran to their true end
            e_lib = (state[:, full] - kernel()[:, full]).abs().max().item()
            in_cols = RNN_D if name != "grouped_lstm_forward" else 0
            flops = 2.0 * RNN_G * RNN_H * gates * (RNN_H + in_cols) * steps
            in_floats = RNN_G * (RNN_D if in_cols else gates * RNN_H) * steps
            w_floats = RNN_G * gates * RNN_H * (RNN_H + in_cols + (2 if gates == 3 else 1))
            nbytes = 4.0 * (in_floats + w_floats + BATCH + RNN_G * BATCH * RNN_H)
            bound_ms, bound_by = bound(flops, nbytes)
            if name in CLUSTER_SERVING:  # 3xTF32: their bound first, the CUDA cores' beside it
                b3, _ = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
                bounds = (f"bound_ms={b3:.4f} on 3xTF32, share {100 * b3 / ms:.1f}% (f32 CUDA "
                          f"cores {bound_ms:.4f}; {bound_by})")
            else:
                b3, bounds = None, f"bound_ms={bound_ms:.4f} ({bound_by})"
            print(f"  {name} T={seq}: ms={ms:.4f} ({ms / seq * 1e3:.3f} us per step) "
                  f"plain_ms={plain_ms:.4f} cudnn_ms={library_ms:.4f} (4 nn.{'GRU' if gates == 3 else 'LSTM'} "
                  f"calls over the full T, lengths not handled; max abs diff from the kernel on the "
                  f"{int(full.sum())} full-length rows {e_lib:.3e}) {bounds}; "
                  f"{steps:.0f} valid steps, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB",
                  flush=True)
            timed[(name, seq)] = (ms, plain_ms, library_ms, bound_ms, bound_by, b3)
        del x
    rows = []
    for name, line in zip(names, (34, 86, 281)):
        ms, plain_ms, library_ms, bound_ms, bound_by, b3 = timed[(name, 512)]
        row = {
            "name": name, "route": "cuda", "source": f"{PKG}/ops/csrc/rnn.cu",
            "replaces": f"{TPU_PKG}/ops/pallas_rnn.py:{line}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": [512, RNN_G, BATCH, RNN_D, RNN_H],
            **{f"{key}_t1024": value for key, value in zip(
                ("ms", "plain_ms", "library_ms", "bound_ms"), timed[(name, 1024)])},
        }
        if b3 is not None:  # rows 16-18: the 3xTF32 bound, the CUDA cores' beside it
            row["body"] = f"{PKG}/ops/csrc/rnn_cluster_fused.cuh"
            row["bound_ms_f32"], row["bound_ms_f32_t1024"] = bound_ms, timed[(name, 1024)][3]
            row["bound_ms"], row["bound_ms_t1024"] = b3, timed[(name, 1024)][5]
            row["bound_share"] = b3 / ms
            row["unit"] = "3xTF32 tensor cores"
            row["us_per_step"] = ms / 512 * 1e3
            row["cluster"] = geometry[(name, BATCH)]
            row["cluster_b32"] = geometry[(name, 32)]
            row["tilings_ms"] = {f"t{seq}_b{batch}_rows{r}": v
                                 for (n, seq, batch, r), v in tilings.items() if n == name}
        rows.append(row)
    return rows


RNN_TRAIN_B = 32  # the recurrent family's train batch


LIB_REPEATS = 5  # readings of each cuDNN training yardstick


def _cudnn_train(torch, cell, x, weights):
    """The library yardstick of the training pair: four ``nn.LSTM`` /
    ``nn.GRU`` modules (one per group) carrying the same weights, over raw
    ``x [T, G, B, D]`` for the full T (cuDNN's packed path refuses a length
    of 0, so lengths are not handled; it also does the input projection).
    Returns ``(forward ms, forward + backward ms, backward alone ms)``, each
    the median of ``LIB_REPEATS`` readings, and their ``(min, max)``: the
    yardstick's spread within the run; timed only, never called by the port."""
    w_ih, w_hh, b_ih, b_hh = weights
    modules = []
    for k in range(RNN_G):
        mod = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(RNN_D, RNN_H).cuda()
        with torch.no_grad():
            mod.weight_ih_l0.copy_(w_ih[k].t())
            mod.weight_hh_l0.copy_(w_hh[k].t())
            mod.bias_ih_l0.copy_(b_ih[k])
            mod.bias_hh_l0.copy_(b_hh[k])
        mod.flatten_parameters()
        modules.append(mod)
    inputs = [x[:, k].contiguous() for k in range(RNN_G)]
    params = [p for m in modules for p in m.parameters()]

    def forward():
        out = [m(xi)[1] for m, xi in zip(modules, inputs)]
        return [h[0] if cell == "lstm" else h for h in out]

    grads = [torch.ones_like(h) for h in forward()]

    def forward_backward():
        torch.autograd.grad(forward(), params, grads)

    def readings(fn):
        got = sorted(time_ms(fn, iters=5, warmup=2 if i == 0 else 0) for i in range(LIB_REPEATS))
        return got[len(got) // 2], (got[0], got[-1])

    fwd_ms = readings(forward)
    fwd_bwd_ms = readings(forward_backward)
    states = forward()
    bwd_ms = readings(lambda: torch.autograd.grad(states, params, grads, retain_graph=True))
    return (fwd_ms[0], fwd_bwd_ms[0], bwd_ms[0]), (fwd_ms[1], fwd_bwd_ms[1], bwd_ms[1])


def check_rnn_train_kernels(torch, rnn, real_lengths):
    """The four recurrence training kernels vs their plain versions at the
    LSTM / GRU models' training shapes (G 4, B 32, H 256); ``real_lengths[T]``
    are a real batch-32's lengths at chunk T. The backward kernels take the
    twin's residuals, so both sides get the same inputs; each LSTM kernel is
    launched twice on every case and must repeat its bits (its cluster body
    sums its partials in a fixed order). Returns the four table rows."""
    g = torch.Generator().manual_seed(6)
    scale = RNN_H**-0.5

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * scale).cuda()

    route = rnn.rnn_train_route(RNN_H)
    if route != "cluster":
        raise AssertionError("the training kernels of both cells must run their cluster body at "
                             f"H {RNN_H}, not {route}")
    info = {}
    for cell in ("lstm", "gru"):
        info[cell] = rnn.rnn_train_cluster_info(cell, RNN_H, RNN_TRAIN_B, RNN_G)
        c = info[cell]
        waves = [-(-c["clusters_per_launch"] // c[f"active_clusters_{d}"]) for d in ("fwd", "bwd")]
        print(f"  {cell}_train_fwd / {cell}_train_bwd at H={RNN_H} B={RNN_TRAIN_B} G={RNN_G}: "
              f"route {route}, {c['ctas_per_cluster']} CTAs and {c['tile_rows']} rows a cluster, "
              f"{c['threads']} threads, {c['smem_fwd_bytes']} / {c['smem_bwd_bytes']} bytes of "
              f"shared memory, {c['active_clusters_fwd']} / {c['active_clusters_bwd']} active "
              f"clusters, {c['clusters_per_launch']} clusters per launch, {waves[0]} / {waves[1]} "
              f"wave(s) (forward / backward)", flush=True)
    pairs = {"lstm": ("lstm_train_fwd", "lstm_train_bwd"), "gru": ("gru_train_fwd", "gru_train_bwd")}
    errs = {name: 0.0 for pair in pairs.values() for name in pair}
    timed = {}
    for seq in (512, 1024):
        real = real_lengths[seq]
        edge = real.clone().cpu()
        edge[:6] = torch.tensor([0, 1, 37, seq - 1, seq, 8], dtype=torch.int32)
        for cell, (fwd_name, bwd_name) in pairs.items():
            gates = 4 if cell == "lstm" else 3
            fwd, bwd = getattr(rnn, fwd_name), getattr(rnn, bwd_name)
            fwd_plain, bwd_plain = getattr(rnn, fwd_name + "_plain"), getattr(rnn, bwd_name + "_plain")
            x_proj = torch.randn(seq, RNN_G, RNN_TRAIN_B, gates * RNN_H, generator=g).cuda()
            w_hh, b_hh = u(RNN_G, RNN_H, gates * RNN_H), u(RNN_G, gates * RNN_H)
            dh = torch.randn(RNN_G, RNN_TRAIN_B, RNN_H, generator=g).cuda()
            cases = [("real lengths", x_proj, real, dh), ("edge lengths", x_proj, edge.cuda(), dh),
                     ("no lengths", x_proj, None, dh)]
            if seq == 512:  # a B and a T that are not multiples of 8
                cases.append(("B=13 T=509", x_proj[:509, :, :13].contiguous(), edge[:13].cuda(),
                              dh[:, :13].contiguous()))
            for label, xp, lens, dhc in cases:
                got = fwd(xp, w_hh, b_hh, lens)
                torch.cuda.synchronize()
                want = fwd_plain(xp, w_hh, b_hh, lens)
                e_fwd = max((a - b).abs().max().item() for a, b in zip(got, want))
                dx = bwd(*want[1:], w_hh, lens, dhc)
                torch.cuda.synchronize()
                e_bwd = rel_err(dx, bwd_plain(*want[1:], w_hh, lens, dhc))
                if lens is not None:  # residuals and cotangent exactly zero past each length
                    past = torch.arange(xp.shape[0], device="cuda")[:, None] >= lens[None, :]
                    for t in (*got[1:], dx):
                        if (t.permute(0, 2, 1, 3)[past] != 0).any().item():
                            raise AssertionError(f"{cell} {label}: nonzero past a row's length")
                    if (got[0][:, lens == 0] != 0).any().item():
                        raise AssertionError(f"{fwd_name} {label}: a length-0 row is not zero")
                # the same inputs again: the same bits
                same_fwd = all(torch.equal(a, b) for a, b in zip(got, fwd(xp, w_hh, b_hh, lens)))
                same_bwd = torch.equal(dx, bwd(*want[1:], w_hh, lens, dhc))
                if not (same_fwd and same_bwd):
                    raise AssertionError(f"{cell} {label}: a second launch gave other bits "
                                         f"(forward {same_fwd}, backward {same_bwd})")
                print(f"  {fwd_name} T={xp.shape[0]} B={xp.shape[2]} {label}: max_abs_err {e_fwd:.3e} "
                      f"(tol {RNN_TOL}); {bwd_name}: rel err {e_bwd:.3e} (tol {GRAD_TOL}); both "
                      f"repeat bit for bit", flush=True)
                errs[fwd_name] = max(errs[fwd_name], e_fwd)
                errs[bwd_name] = max(errs[bwd_name], e_bwd)
            if errs[fwd_name] > RNN_TOL or errs[bwd_name] > GRAD_TOL:
                raise AssertionError(f"recurrence training kernels disagree with their twins: {errs}")

            # times on the real lengths
            steps = float(real.clamp(0, seq).sum().item())
            res = fwd_plain(x_proj, w_hh, b_hh, real)[1:]
            fwd_ms = time_ms(lambda: fwd(x_proj, w_hh, b_hh, real), iters=5, warmup=2)
            bwd_ms = time_ms(lambda: bwd(*res, w_hh, real, dh), iters=5, warmup=2)
            fwd_plain_ms = time_ms(lambda: fwd_plain(x_proj, w_hh, b_hh, real), iters=2, warmup=1)
            bwd_plain_ms = time_ms(lambda: bwd_plain(*res, w_hh, real, dh), iters=2, warmup=1)
            x = torch.randn(seq, RNN_G, RNN_TRAIN_B, RNN_D, generator=g).cuda()
            weights = (u(RNN_G, RNN_D, gates * RNN_H), w_hh, u(RNN_G, gates * RNN_H), b_hh)
            (lib_fwd, lib_fwd_bwd, lib_bwd), lib_spread = _cudnn_train(torch, cell, x, weights)
            # what the Function does around the kernels: the x_proj copy from
            # the projection's [G, B, T, cols] layout, and dW_hh as one product
            src = x_proj.permute(1, 2, 0, 3).contiguous()
            copy_ms = time_ms(lambda: src.permute(2, 0, 1, 3).contiguous(), iters=5, warmup=2)
            dz = bwd(*res, w_hh, real, dh)
            dw_ms = time_ms(lambda: torch.einsum("tgbh,tgbk->ghk", res[1], dz), iters=5, warmup=2)
            del src, x
            # each kernel's own work on this run's lengths: the recurrent
            # product at every valid row-step; every input read once and every
            # output written once, at the valid steps
            flops = 2.0 * RNN_G * RNN_H * gates * RNN_H * steps
            w_floats = RNN_G * gates * RNN_H * (RNN_H + 1)
            # forward: x_proj in; gates, h_{t-1}, c_{t-1} / hn out
            fwd_bytes = 4.0 * (RNN_G * steps * (gates * RNN_H * 2 + 2 * RNN_H) + w_floats
                               + RNN_TRAIN_B + RNN_G * RNN_TRAIN_B * RNN_H)
            # backward: gates and c_{t-1} (LSTM) or gates, h_{t-1}, hn (GRU) in; dz out
            res_cols = gates * RNN_H + (RNN_H if cell == "lstm" else 2 * RNN_H)
            bwd_bytes = 4.0 * (RNN_G * steps * (res_cols + gates * RNN_H) + w_floats
                               + RNN_TRAIN_B + RNN_G * RNN_TRAIN_B * RNN_H)
            tag = "GRU" if cell == "gru" else "LSTM"
            for name, ms, plain_ms, lib, spread, nbytes in (
                    (fwd_name, fwd_ms, fwd_plain_ms, lib_fwd, lib_spread[0], fwd_bytes),
                    (bwd_name, bwd_ms, bwd_plain_ms, lib_bwd, lib_spread[2], bwd_bytes)):
                # both pairs run 3xTF32 on the tensor cores: both bounds
                bound_ms, bound_by = bound(flops, nbytes)
                bound_tc = bound(flops, nbytes, PEAK_3XTF32_FLOPS)
                bounds = (f"bound_ms={bound_tc[0]:.4f} on 3xTF32 ({bound_tc[1]}), share "
                          f"{100 * bound_tc[0] / ms:.1f}%; f32 CUDA cores {bound_ms:.4f} ({bound_by})")
                print(f"  {name} T={seq} B={RNN_TRAIN_B}: ms={ms:.4f} ({ms / seq * 1e3:.3f} us per "
                      f"step) plain_ms={plain_ms:.4f} cudnn_ms={lib:.4f} (median of {LIB_REPEATS}, "
                      f"{spread[0]:.4f}-{spread[1]:.4f}; 4 nn.{tag} calls over the full T, "
                      f"{'forward in training mode' if name == fwd_name else 'backward alone'};"
                      f" forward + backward {lib_fwd_bwd:.4f}, {lib_spread[1][0]:.4f}-"
                      f"{lib_spread[1][1]:.4f}) {bounds}; {steps:.0f} valid steps, "
                      f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB", flush=True)
                timed[(name, seq)] = (ms, plain_ms, lib, bound_ms, bound_by, lib_fwd_bwd, bound_tc,
                                      spread)
            print(f"  {tag} T={seq} around the kernels: x_proj copy {copy_ms:.4f} ms "
                  f"({x_proj.numel() * 4 / 1e6:.0f} MB), dW_hh product {dw_ms:.4f} ms", flush=True)
            timed[(cell, seq)] = (copy_ms, dw_ms)
            del x_proj, res, dz
            torch.cuda.empty_cache()
    rows = []
    for name, line in zip(("lstm_train_fwd", "lstm_train_bwd", "gru_train_fwd", "gru_train_bwd"),
                          (34, 90, 343, 399)):
        ms, plain_ms, lib, bound_ms, bound_by, lib_fwd_bwd, bound_tc, spread = timed[(name, 512)]
        cell = name.split("_")[0]
        row = {
            "name": name, "route": "cuda", "source": f"{PKG}/ops/csrc/rnn_train.cu",
            "replaces": f"{TPU_PKG}/ops/pallas_rnn_train.py:{line}",
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib, "library_ms_spread": list(spread),
            "library_fwd_bwd_ms": lib_fwd_bwd,
            "shape": [512, RNN_G, RNN_TRAIN_B, RNN_H],
            "x_proj_copy_ms": timed[(cell, 512)][0], "dw_hh_ms": timed[(cell, 512)][1],
            **{f"{key}_t1024": value for key, value in zip(
                ("ms", "plain_ms", "library_ms", "bound_ms"), timed[(name, 1024)])},
        }
        # on the tensor cores: their bound first, the CUDA cores' beside it
        row["body"] = f"{PKG}/ops/csrc/rnn_cluster.cuh"
        row["bound_ms_f32"], row["bound_ms_f32_t1024"] = bound_ms, timed[(name, 1024)][3]
        row["bound_ms"], row["bound_by"] = bound_tc
        row["bound_ms_t1024"] = timed[(name, 1024)][6][0]
        row["bound_share"] = bound_tc[0] / ms
        row["unit"] = "3xTF32 tensor cores"
        row["us_per_step"] = ms / 512 * 1e3
        row["cluster"] = info[cell]
        rows.append(row)
    return rows


FAMILIES = (  # profiler kernel-name fragments -> family, first match wins
    ("packed_attention_fwd", ("packed_attention_fwd",)),
    ("flash_fwd_single", ("flash_fwd_single",)),
    ("flash_fwd_tiled", ("flash_fwd_tiled",)),
    ("flash_bwd_fused", ("flash_bwd_fused",)),
    ("flash_bwd_split", ("flash_dkv_kernel", "flash_dq_kernel")),
    ("flash_delta", ("flash_delta",)),
    ("packed_attention_bwd", ("::bwd_kernel<", "::dq_reduce_kernel", "::delta_kernel<",
                              "::bwd_prep_kernel<", "::bwd_dkv_wg_kernel<",
                              "::bwd_dq_wg_kernel<")),
    # flash_bwd_fused above also takes flash_bwd_fused_dq_reduce, its ordered dq sum
    ("proj_ln_fwd", ("proj_ln_fwd",)),
    ("proj_ln_bwd", ("proj_ln_bwd",)),
    ("ffw_ln_hidden", ("ffw_ln_hidden",)),  # launched by ffw_ln_fwd and ffw_ln_bwd
    ("ffw_ln_fwd", ("ffw_ln_fwd",)),
    ("ffw_ln_bwd", ("ffw_ln_bwd",)),
    ("fused_mlp_hidden", ("fused_mlp_hidden",)),  # launched by fused_mlp_fwd and fused_mlp_bwd
    ("fused_mlp_fwd", ("fused_mlp_fwd",)),
    ("fused_mlp_bwd", ("fused_mlp_bwd",)),
    ("dropout_keep_mask", ("dropout_mask_kernel",)),
    ("fusion_head", ("fusion_head",)),
    ("rnn_train_fwd", ("lstm_train_fwd", "gru_train_fwd")),
    ("rnn_train_bwd", ("lstm_train_bwd", "gru_train_bwd")),
    ("grouped_lstm", ("grouped_lstm",)),
    ("grouped_gru", ("grouped_gru",)),
    ("gemm", ("gemm", "cutlass", "sm90_xmma", "nvjet")),
    ("copy", ("direct_copy",)),
    ("fill", ("fillfunctor",)),
)


def kernel_times(torch, call, iters: int) -> dict:
    """Device ms per call of each kernel that ``call`` launches
    (torch.profiler's CUDA activity), by the kernel's own name. A trace
    that holds no device event at all (CUPTI now and then hands back an
    empty one) is taken again, three tries in all, the later ones with the
    CPU activity beside the CUDA one as ``profile`` traces; after that the
    empty result is returned and the caller decides."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    call()
    torch.cuda.synchronize()
    times = {}
    for attempt in range(3):
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if attempt else [])
        with torch_profile(activities=activities) as prof:
            for _ in range(iters):
                call()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                name = name.split("<")[0].split("::")[-1].split()[-1]
                times[name] = times.get(name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
        if times:
            break
        print(f"  kernel_times: trace {attempt + 1} of 3 held no device event",
              file=sys.stderr, flush=True)
        time.sleep(1.0)
    return dict(sorted(times.items(), key=lambda kv: -kv[1]))


def profile(torch, run, iters: int, unit: str) -> dict:
    """Device time by kernel family over ``iters`` calls of ``run(n)``
    (torch.profiler's CUDA activity), and the device's busy share of the
    wall time; returns the families' ms per call of ``run`` with the device
    total (``device``) and the busy share (``busy``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run(3)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(iters)
        wall_us = (time.perf_counter() - t) * 1e6
    families = {name: 0.0 for name, _ in FAMILIES}
    families["other"] = 0.0
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        key = next((name for name, keys in FAMILIES if any(k in low for k in keys)), "other")
        families[key] += us
    busy = sum(families.values())
    print(f"  profile over {iters} {unit}s: device busy {busy / wall_us:.3f} of wall "
          f"({busy / iters / 1e3:.3f} ms device time per {unit})", flush=True)
    for key, us in families.items():
        if us:
            print(f"    {key:21s} {us / iters / 1e3:8.4f} ms/{unit}  {us / busy:.3f} of device time",
                  flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    top kernel {us / iters / 1e3:8.4f} ms/{unit}  {name[:110]}", flush=True)
    return {**{k: us / iters / 1e3 for k, us in families.items() if us},
            "device": busy / iters / 1e3, "busy": busy / wall_us}


def profile_micro_steps(torch, step, split, idx, iters: int) -> dict:
    """``profile`` over ``iters`` training micro-steps of ``step`` on the
    batches ``idx`` in turn."""

    def run(n):
        for i in range(n):
            step(split, idx[i % len(idx)])
        torch.cuda.synchronize()

    return profile(torch, run, iters, "micro-step")


def load_cfg(overrides):
    """base.yaml + ``overrides``; with a ``preset=<name>`` among them, that
    preset of config/fusion_strategies.yaml over base.yaml."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    overrides = list(overrides)
    presets = any(o.startswith("preset=") for o in overrides)
    return load_config(REPO / "config" / ("fusion_strategies.yaml" if presets else "base.yaml"),
                       overrides)


def _trainer(torch, overrides, weights=None):
    """A Trainer on base.yaml + ``overrides`` (``load_cfg``) with seeded
    weights (or ``weights``), its optimizer built for the real epoch length."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.trainer import Trainer

    cfg = load_cfg(overrides)
    model = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
    if weights is not None:
        model.load_state_dict(weights)
    return Trainer(cfg, model=model, device="cuda")


PLAIN = ["model.flash_attention=false", "model.fused_mlp=false", "model.fused_mlp_ln=false"]


def micro_step_vs_plain(torch, split, idx0, overrides, label, plain_overrides=PLAIN, bf16=False):
    """One micro-step at ``dropout_rng=xla`` on the kernel path against the
    plain path (``plain_overrides``): same weights, batch and generator seed,
    so the same masks. With ``bf16`` (a mixed_precision config) the gates are
    the loss and the whole gradient norm-wise at the bf16 limits, the two
    paths rounding at other points; each gradient's errors are printed."""
    trainer = _trainer(torch, [*overrides, "training.dropout_rng=xla"])
    plain = _trainer(torch, [*overrides, "training.dropout_rng=xla", *plain_overrides],
                     weights=trainer.model.state_dict())
    results = []
    for tr in (trainer, plain):
        tr.generator.manual_seed(tr.seed + 1)
        feats, labels, lengths = split.gather(idx0)
        feats, lengths, mask = tr.augment(feats, lengths, len(split.modalities))
        weight = torch.ones(labels.shape, device="cuda")
        results.append(tr.loss_and_grads(feats, labels, mask, lengths, weight))
    torch.cuda.synchronize()
    (loss_k, _acc_k, grads_k), (loss_p, _acc_p, grads_p) = results
    e_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    names = [n for n, _ in trainer.model.named_parameters()]
    # each gradient's error relative to its largest magnitude, floored at
    # 1e-3 of the model's largest gradient: the key-projection biases get
    # gradients that are zero up to rounding (a bias on every key shifts all
    # of a query's scores alike), so their own scale is noise
    floor = 1e-3 * max(g.abs().max().item() for g in grads_p)
    e_grads = {n: (a - b).abs().max().item() / max(b.abs().max().item(), floor)
               for n, a, b in zip(names, grads_k, grads_p)}
    e_norms = {n: ((a - b).norm() / max(b.norm().item(), floor)).item()
               for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(e_grads, key=e_grads.get)
    worst_norm = max(e_norms, key=e_norms.get)
    leaf_tol = BF16_PLAIN_LEAF_TOL if bf16 else TRAIN_TOL
    print(f"  {label}: one micro-step kernel vs plain path: loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel err {e_loss:.3e}), {len(names)} gradients, worst max-abs "
          f"rel err {e_grads[worst]:.3e} at {worst} (tol {leaf_tol}), worst norm rel err "
          f"{e_norms[worst_norm]:.3e} at {worst_norm}"
          + ("" if bf16 else f" (tol {TRAIN_NORM_TOL})"), flush=True)
    for n in sorted(e_grads, key=e_grads.get)[-3:]:
        print(f"    {n}: max-abs rel {e_grads[n]:.3e}, norm rel {e_norms[n]:.3e}", flush=True)
    if bf16:
        whole = (torch.cat([(a - b).flatten() for a, b in zip(grads_k, grads_p)]).norm()
                 / torch.cat([b.flatten() for b in grads_p]).norm()).item()
        print(f"  {label}: the whole gradient norm-wise {whole:.3e} (tol {BF16_PLAIN_GRAD_TOL}), "
              f"loss rel err {e_loss:.3e} (tol {BF16_PLAIN_LOSS_TOL})", flush=True)
        if e_loss > BF16_PLAIN_LOSS_TOL or whole > BF16_PLAIN_GRAD_TOL \
                or e_grads[worst] > BF16_PLAIN_LEAF_TOL:
            raise AssertionError(f"{label}: kernel path disagrees with the plain path")
    elif e_loss > TRAIN_NORM_TOL or e_grads[worst] > TRAIN_TOL \
            or e_norms[worst_norm] > TRAIN_NORM_TOL:
        raise AssertionError(f"{label}: kernel path disagrees with the plain path")
    for p in trainer.model.parameters():
        p.grad = None
    return trainer  # its weights are untouched: no optimizer step was taken


def counted_steps(torch, kernels, trainer, split, idx, steps):
    """``steps`` micro-steps with the launch counters set to 0 just before
    and read just after -> ``(losses, launches)``."""
    trainer.init_state(steps_per_epoch=len(idx))
    step = trainer.make_train_step_fn()
    for fn in kernels.values():
        fn.launches = 0
    losses = [step(split, idx[i % len(idx)])[0] for i in range(steps)]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    losses = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if trainer.optimizer.count != steps // trainer.accum:
        raise AssertionError(f"{trainer.optimizer.count} optimizer updates, "
                             f"want {steps // trainer.accum}")
    return step, losses, launches


def step_p50(torch, step, split, idx, batch, label, smi, iters=20):
    lat = []
    for i in range(iters):
        t = time.perf_counter()
        step(split, idx[i % len(idx)])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    lat = sorted(lat[iters // 5:])
    p50 = lat[len(lat) // 2]
    print(f"  train micro-step batch {batch}, {label}: p50 {p50 * 1e3:.3f} ms, {batch / p50:.1f} "
          f"train windows/s on {smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return p50


def train_phase(torch, kernels, split, train_idx, smi):
    """Trainer on the unmodified base.yaml at full width: the main path's
    micro-steps with their launch counts and a bit-identical rerun, one
    micro-step against the plain path, the fused_mlp-without-LN route, step
    times and device time by kernel family. Returns the default path's
    counts, the fused_mlp route's and the default step's p50 and device
    time."""
    idx = [torch.from_numpy(row).long() for row in train_idx]
    batch = len(idx[0])
    per_step = len(split.modalities)  # one layer per encoder, every encoder runs
    torch.cuda.reset_peak_memory_stats()  # the kernel checks above held more
    ln_kernels = ("proj_ln_fwd", "proj_ln_bwd", "ffw_ln_fwd", "ffw_ln_bwd")

    # dropout_rng=xla: kernel path vs plain path on the same masks, then its step time
    xla = micro_step_vs_plain(torch, split, idx[0], [], "default kernels, dropout_rng=xla")
    print(f"  {len(idx)} batches of {batch} per epoch; accumulation "
          f"{xla.config.training.gradient_accumulation}; augmentation jitter "
          f"{xla.temporal_jitter}, noise {xla.gaussian_noise}, modality dropout "
          f"{xla.modality_dropout}; dropout {xla.config.model.dropout}", flush=True)
    xla_step, _losses, _launches = counted_steps(torch, kernels, xla, split, idx, 4)
    step_p50(torch, xla_step, split, idx, batch, "dropout_rng=xla", smi)
    del xla, xla_step

    # the main path: base.yaml as it is (dropout_rng: auto -> the mask kernel)
    trainer = _trainer(torch, [])
    if str(trainer.config.training.dropout_rng) != "auto":
        raise AssertionError("config/base.yaml no longer has training.dropout_rng: auto")
    step, losses, launches = counted_steps(torch, kernels, trainer, split, idx, TRAIN_STEPS)
    want = dict.fromkeys(kernels, 0)
    for name in ("packed_attention_fwd", "packed_attention_bwd", *ln_kernels):
        want[name] = TRAIN_STEPS * per_step
    want["dropout_keep_mask"] = TRAIN_STEPS * per_step  # a layer's three masks: one launch
    print(f"  default config: {TRAIN_STEPS} micro-steps, {trainer.optimizer.count} updates; "
          f"losses {[round(v, 5) for v in losses]}", flush=True)
    print(f"  launches: {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"training launch counts {launches} != {want}")
    _step2, losses2, _launches2 = counted_steps(
        torch, kernels, _trainer(torch, []), split, idx, TRAIN_STEPS)
    print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
    if losses2 != losses:
        raise AssertionError(f"the same seed gave other losses: {losses} then {losses2}")
    times = {"train_p50": step_p50(torch, step, split, idx, batch,
                                   "dropout_rng=auto (mask kernel)", smi),
             "train_device": profile_micro_steps(torch, step, split, idx, 8)["device"]}
    del trainer, step

    # fused_mlp without the combined LayerNorm kernel: the feed-forward pair
    route = ["model.fused_mlp=true", "model.fused_mlp_ln=false"]
    micro_step_vs_plain(torch, split, idx[0], route, "fused_mlp=true fused_mlp_ln=false")
    mlp_trainer = _trainer(torch, route)
    mlp_step, mlp_losses, mlp_launches = counted_steps(
        torch, kernels, mlp_trainer, split, idx, FUSED_MLP_STEPS)
    want = dict.fromkeys(kernels, 0)
    for name in ("packed_attention_fwd", "packed_attention_bwd", "fused_mlp_fwd", "fused_mlp_bwd"):
        want[name] = FUSED_MLP_STEPS * per_step
    want["dropout_keep_mask"] = FUSED_MLP_STEPS * per_step
    print(f"  fused_mlp route: {FUSED_MLP_STEPS} micro-steps; losses "
          f"{[round(v, 5) for v in mlp_losses]}", flush=True)
    print(f"  launches: {mlp_launches} (want {want})", flush=True)
    if mlp_launches != want:
        raise AssertionError(f"fused_mlp route launch counts {mlp_launches} != {want}")
    step_p50(torch, mlp_step, split, idx, batch, "fused_mlp=true fused_mlp_ln=false", smi)
    profile_micro_steps(torch, mlp_step, split, idx, 8)
    return launches, mlp_launches, times


LN_KERNELS = ("proj_ln_fwd", "proj_ln_bwd", "ffw_ln_fwd", "ffw_ln_bwd")
LONG_STEPS = 8
LONG_CHUNKS = (1024, 2048, 4096)  # 4096 is served only (the tiled forward)


def load_split(torch, modalities, chunk, stride, name="train"):
    """Real PAMAP2 windows of ``chunk`` steps at ``stride``, instance-normalised,
    on the card."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        MultimodalDataset, apply_instance_normalization,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit

    windows = MultimodalDataset(REPO / "data" / "pamap2", modalities, name, chunk_size=chunk,
                                window_stride=stride).windows
    apply_instance_normalization(windows)
    return DeviceSplit.from_windows(windows, device="cuda")


def index_batches(torch, split, batch, seed):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        padded_index_matrix,
    )

    matrix, _ = padded_index_matrix(split.num_windows, batch, shuffle=True, seed=seed)
    return [torch.from_numpy(row).long() for row in matrix]


def serve_vs_plain(torch, kernels, overrides, split, idx, label, smi, want, compare_rows=None,
                   timed=12, bf16=False):
    """Serve batch-64 requests of ``split`` at base.yaml + ``overrides``
    (``load_cfg``) with counted launches, hold the logits against the plain
    path (on the first ``compare_rows`` rows of the batch when the plain
    scores of the whole batch do not fit; with ``bf16``, norm-wise at
    BF16_LOGIT_TOL), then time repeated requests. Returns the launches of
    the counted request, the model and the p50."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn

    cfg = load_cfg(overrides)
    model = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
    plain = MultimodalFusionModel.from_config(
        load_cfg([*overrides, "model.flash_attention=false"]), device="cuda")
    plain.load_state_dict(model.state_dict())
    serve = make_serving_fn(model, device="cuda")
    feats, _labels, lengths = split.gather(idx[0])
    short = lengths.clone()
    short[:3] = torch.tensor([0, 37, 1], dtype=torch.int32, device="cuda")
    for fn in kernels.values():
        fn.launches = 0
    got = serve(feats, None, short)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"  {label}: launches of one request {launches}", flush=True)
    if launches != {**dict.fromkeys(kernels, 0), **want}:
        raise AssertionError(f"{label}: serving launch counts {launches} != {want}")
    rows = slice(0, compare_rows or BATCH)
    with torch.inference_mode():
        ref = plain({m: x[rows] for m, x in feats.items()}, None, short[rows])
    torch.cuda.synchronize()
    if got.shape != (BATCH, model.num_classes) or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad logits {tuple(got.shape)}")
    e = (got[rows] - ref).abs().max().item()
    if bf16:
        e_norm = ((got[rows] - ref).norm() / ref.norm()).item()
        print(f"  {label}: logits {tuple(got.shape)} finite, vs the bf16 plain path norm-wise "
              f"{e_norm:.3e} (tol {BF16_LOGIT_TOL}), max_abs_err {e:.3e} on {ref.shape[0]} "
              f"rows", flush=True)
        if e_norm > BF16_LOGIT_TOL:
            raise AssertionError(f"{label}: served logits disagree with the plain path: {e_norm}")
    else:
        print(f"  {label}: logits {tuple(got.shape)} finite, max_abs_err vs plain path {e:.3e} on "
              f"{ref.shape[0]} rows (tol {LOGIT_TOL})", flush=True)
        if e > LOGIT_TOL:
            raise AssertionError(f"{label}: served logits disagree with the plain path: {e}")
    del plain, ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(timed):
        feats, _labels, lengths = split.gather(idx[i % len(idx)])
        t = time.perf_counter()
        serve(feats, None, lengths)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    lat = sorted(lat[2:])
    p50 = lat[len(lat) // 2]
    print(f"  {label}: serve batch {BATCH} p50 {p50 * 1e3:.3f} ms, {BATCH / p50:.1f} windows/s on "
          f"{smi}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, model, p50


def train_route(torch, kernels, overrides, split, idx, label, smi, want_per_step, steps=LONG_STEPS,
                profile_steps=4):
    """One micro-step against the plain path, ``steps`` counted micro-steps,
    the same seed again bit for bit, the step's p50 and device time by
    family. Returns the counted launches and the trainer of the counted
    steps."""
    micro_step_vs_plain(torch, split, idx[0], overrides, label)
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(torch, overrides)
    step, losses, launches = counted_steps(torch, kernels, trainer, split, idx, steps)
    want = {**dict.fromkeys(kernels, 0), **{k: v * steps for k, v in want_per_step.items()}}
    print(f"  {label}: {steps} micro-steps, {trainer.optimizer.count} updates; losses "
          f"{[round(v, 5) for v in losses]}", flush=True)
    print(f"  launches: {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"{label}: training launch counts {launches} != {want}")
    _step2, losses2, _launches2 = counted_steps(
        torch, kernels, _trainer(torch, overrides), split, idx, steps)
    print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
    if losses2 != losses:
        raise AssertionError(f"{label}: the same seed gave other losses: {losses} then {losses2}")
    del _step2
    step_p50(torch, step, split, idx, len(idx[0]), label, smi, iters=10)
    profile_micro_steps(torch, step, split, idx, profile_steps)
    return launches, trainer


def long_phase(torch, kernels, modalities, stride, seed, smi):
    """The flagship at chunk 1024 / 2048 (train, serve, one evaluation pass)
    and 4096 (serve). Returns launches by path and each chunk's train batch
    lengths."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import evaluate_model

    print("[long]", flush=True)
    out = {}
    for chunk in LONG_CHUNKS:
        override = [f"dataset.chunk_size={chunk}"]
        t = time.perf_counter()
        split = load_split(torch, modalities, chunk, stride)
        print(f"  chunk {chunk}: {split.num_windows} train windows at stride {stride} on the card "
              f"in {time.perf_counter() - t:.1f} s; {int((split.lengths < chunk).sum())} shorter "
              f"than the chunk", flush=True)
        if chunk <= 2048:
            backward = {"flash_bwd_fused": 4} if chunk <= 1024 else \
                {"flash_bwd_dkv": 4, "flash_bwd_dq": 4}
            want = {"flash_fwd_single": 4, **backward, **dict.fromkeys(LN_KERNELS, 4),
                    "dropout_keep_mask": 4}
            out[f"train{chunk}"] = train_route(
                torch, kernels, override, split, index_batches(torch, split, 32, seed),
                f"L{chunk}", smi, want)[0]
        forward = "flash_fwd_single" if chunk <= 2048 else "flash_fwd_tiled"
        torch.cuda.reset_peak_memory_stats()
        out[f"serve{chunk}"], model, _p50 = serve_vs_plain(
            torch, kernels, override, split, index_batches(torch, split, BATCH, seed),
            f"L{chunk}", smi, {forward: 4, "fused_hybrid_head": 1},
            compare_rows=8 if chunk > 2048 else None, timed=12 if chunk <= 2048 else 6)
        if chunk == 1024:
            test = load_split(torch, modalities, chunk, chunk, "test")
            for fn in kernels.values():
                fn.launches = 0
            metrics = evaluate_model(model, test, batch_size=32)
            out["eval1024"] = {name: fn.launches for name, fn in kernels.items()}
            print(f"  L1024 evaluate_model on {metrics['num_samples']} test windows (random "
                  f"weights): accuracy {metrics['accuracy']:.4f}, loss {metrics['loss']:.4f}; "
                  f"launches {out['eval1024']}", flush=True)
            if not math.isfinite(metrics["loss"]) or out["eval1024"]["flash_fwd_single"] <= 0 \
                    or out["eval1024"]["packed_attention_fwd"] != 0:
                raise AssertionError("L1024 evaluation is not finite or missed the flash forward")
        del model, split
        torch.cuda.empty_cache()
    return out


def grouped_phase(torch, kernels, split, batches, train_idx, default_serve_p50, smi, workdir):
    """model.grouped_transformer=true at chunk 512: serve, train, fit one
    epoch, reload; and the grouped model against the ungrouped model on the
    same weights unstacked."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
        ungroup_state_dict,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import dataset_kwargs
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        load_checkpoint,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    print("[grouped]", flush=True)
    route = ["model.grouped_transformer=true"]
    idx64 = [torch.from_numpy(row).long() for row in batches]
    launches = {}
    launches["serve"], model, p50 = serve_vs_plain(
        torch, kernels, route, split, idx64, "G512", smi,
        {"flash_fwd_single": 1, "fused_hybrid_head": 1})
    print(f"  G512 serve p50 {p50 * 1e3:.3f} ms beside the ungrouped default's "
          f"{default_serve_p50 * 1e3:.3f} ms in this run", flush=True)
    # the same function as four encoders carrying the same weights unstacked
    cfg = load_config(REPO / "config" / "base.yaml")
    ungrouped = MultimodalFusionModel.from_config(cfg, device="cuda")
    dims = {m: int(cfg.model.encoders[m].input_dim) for m in model.grouped_tf_names}
    ungrouped.load_state_dict(ungroup_state_dict(model.state_dict(), model.grouped_tf_names, dims))
    feats, _labels, lengths = split.gather(idx64[1])
    with torch.inference_mode():
        e = (model(feats, None, lengths) - ungrouped(feats, None, lengths)).abs().max().item()
    print(f"  grouped model vs the ungrouped model on the same weights unstacked: logits "
          f"max_abs_err {e:.3e} (tol {LOGIT_TOL})", flush=True)
    if e > LOGIT_TOL:
        raise AssertionError(f"the grouped model is not the ungrouped model's function: {e}")
    del ungrouped, model

    idx = [torch.from_numpy(row).long() for row in train_idx]
    launches["train"] = train_route(
        torch, kernels, route, split, idx, "G512", smi,
        {"flash_fwd_single": 1, "flash_bwd_fused": 1, "dropout_keep_mask": 1})[0]

    # one epoch of fit, and the checkpoint's bundled config rebuilds the grouped model
    trainer = _trainer(torch, [
        *route, "training.max_epochs=1", f"dataset.data_dir={REPO / 'data' / 'pamap2'}",
        f"dataset.chunk_cache_dir={workdir / 'chunk_cache'}"])
    train_w, val_w, test_w = create_datasets(**dataset_kwargs(trainer.config))
    results = trainer.fit(train_w, val_w, test_w, save_dir=workdir / "grouped_run",
                          log_fn=lambda msg: print(f"  {msg}", flush=True))
    last = workdir / "grouped_run" / "checkpoints" / "last"
    weights, ckpt_cfg, meta = load_checkpoint(last)
    reloaded = MultimodalFusionModel.from_config(ckpt_cfg, device="cuda")
    reloaded.load_state_dict(weights)
    test_data = DeviceSplit.from_windows(test_w, device="cuda")
    same = torch.equal(torch.from_numpy(trainer.evaluate_logits(test_data)),
                       torch.from_numpy(trainer.evaluate_logits(test_data, model=reloaded)))
    wall = results["train_wall_seconds"]
    print(f"  G512 fit: 1 epoch in {wall:.2f} s, {train_w.num_windows / wall:.1f} train windows/s "
          f"on {smi}; test acc {results['test_acc']:.4f}; checkpoint 'last' (epoch "
          f"{meta['epoch']}) rebuilt as a grouped model from its directory: "
          f"{bool(reloaded.grouped_tf_names)}, test logits bit-identical: {same}", flush=True)
    if not same or not reloaded.grouped_tf_names or not _all_finite(results["history"]):
        raise AssertionError("the grouped checkpoint does not reload to the model it saved")
    return launches


# C5: model widths the kernels are not built for -> (the launches of one
# served request, of one training micro-step) on the routes their widths
# name. 192: head_dim 48 padded to 64, both residual-LN halves at d_model 256
# (192 padded, the LayerNorm over 192), the head's H 192; 640: the head at H
# 640 (K in slabs of 576), head_dim 160 and d_model 640 above the
# attention's and the layer kernels' widest (plain, with the mask generator)
C5_WIDTHS = {
    192: ({"packed_attention_fwd": 4, "fused_hybrid_head": 1},
          {"packed_attention_fwd": 4, "packed_attention_bwd": 4, "proj_ln_fwd": 4,
           "proj_ln_bwd": 4, "ffw_ln_fwd": 4, "ffw_ln_bwd": 4, "dropout_keep_mask": 4}),
    640: ({"fused_hybrid_head": 1}, {"dropout_keep_mask": 4}),
}
C5_STEPS = 4  # one optimizer update at accumulation 4


C5_LN = (16384, 256, 192, 2048)  # rows, built width, model width, d_ff: hidden 192's micro-step
C5_HEAD = (4, 64, 640, 25)  # M, B, H, C: hidden 640's served head, K in two slabs


def check_c5_kernels(torch):
    """The kernels the [c5] paths run at widths they are not built for,
    against their plain versions on the same inputs: both residual-LN pairs
    at d_model 192 on the width-256 kernels (inputs zero past 192, the
    LayerNorm over 192, nothing written past it), N 16,384, keep 0.8; the head
    at H 640 (K in slabs of 576), batch 64, twice bit for bit."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion, mlp

    n, d, dv, f = C5_LN
    w, (fmask, rmask) = _ln_case(torch, n, d, f, 0.8, seed=dv)
    cut = (torch.arange(d) < dv).float().cuda()

    def v(*shape, s=1.0):  # zero past dv along every axis of width d
        t = w(*shape, s=s)
        for axis, size in enumerate(shape):
            if size == d:
                t = t * cut.reshape([-1 if i == axis else 1 for i in range(len(shape))])
        return t.contiguous()

    x, dout = v(n, d), v(n, d)
    gamma, beta = ((1 + w(d, s=0.1)) * cut).contiguous(), v(d, s=0.1)
    inv_keep = mlp._inv_keep(0.8)
    proj = (x, v(n, d), v(d, d, s=dv**-0.5), v(d, s=0.1), gamma, beta, rmask)
    out = mlp.proj_ln_fwd(*proj, inv_keep, 1e-6, d_valid=dv)
    grads = mlp.proj_ln_bwd(*proj, dout, inv_keep, 1e-6, d_valid=dv)
    torch.cuda.synchronize()
    errs = {"proj_ln_fwd": rel_err(out, mlp.proj_ln_fwd_reference(*proj, inv_keep, 1e-6, dv)),
            "proj_ln_bwd": max(rel_err(g, r) for g, r in zip(
                grads, mlp.proj_ln_bwd_reference(*proj, dout, inv_keep, 1e-6, dv)))}
    past = [out[:, dv:], grads[0][:, dv:]]
    ffw = (x, v(d, f, s=dv**-0.5), w(f, s=0.1), v(f, d, s=f**-0.5), v(d, s=0.1), gamma, beta,
           fmask, rmask)
    out = mlp.ffw_ln_fwd(*ffw, inv_keep, 1e-6, d_valid=dv)
    torch.cuda.synchronize()
    errs["ffw_ln_fwd"] = rel_err(out, mlp.ffw_ln_fwd_reference(*ffw, inv_keep, 1e-6, dv))
    errs["ffw_ln_bwd"], flips, _own = _ffw_ln_bwd_check(torch, mlp, ffw, dout, inv_keep, dv)
    past.append(out[:, dv:])
    print(f"  residual-LN kernels at d_model {dv} on width {d}, N={n} keep=0.8: rel err "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f" (tol {GRAD_TOL}; {flips} ReLU branches off the twin's, within rounding of zero); "
          f"zero past column {dv}: {all(bool(torch.all(t == 0)) for t in past)}", flush=True)
    if max(errs.values()) > GRAD_TOL or not all(bool(torch.all(t == 0)) for t in past):
        raise AssertionError(f"residual-LN kernels at a padded width: {errs}")
    num_mod, batch, hidden, classes = C5_HEAD
    g = torch.Generator().manual_seed(hidden)

    def h(*shape, s=0.06):
        return (torch.randn(*shape, generator=g) * s).cuda()

    pairs = [(q, k) for q in range(num_mod) for k in range(num_mod) if q != k]
    projected = torch.relu(h(num_mod, batch, hidden, s=1.0))
    mask = (torch.rand(batch, num_mod, generator=g) > 0.4).float().cuda()
    mask[0] = 0.0
    args = ({"value_kernel": h(len(pairs), hidden, hidden), "value_bias": h(len(pairs), hidden),
             "out_kernel": h(len(pairs), hidden, hidden), "out_bias": h(len(pairs), hidden)},
            h(num_mod, hidden), h(num_mod), h(hidden, hidden), h(hidden), h(hidden, classes),
            h(classes), pairs)
    first = fusion.fused_hybrid_head(projected, mask, *args)
    second = fusion.fused_hybrid_head(projected, mask, *args)
    torch.cuda.synchronize()
    err = (first - fusion.fused_hybrid_head_reference(projected, mask, *args)).abs().max().item()
    print(f"  fused_hybrid_head at H {hidden} (K in slabs), B={batch}: max_abs_err={err:.3e} "
          f"(tol {HEAD_TOL}); two runs equal bit for bit: {torch.equal(first, second)}",
          flush=True)
    if err > HEAD_TOL or not torch.equal(first, second):
        raise AssertionError(f"fused head at H {hidden}: {err} > {HEAD_TOL} or not repeated")


def c5_phase(torch, kernels, split, batches, train_idx, smi):
    """base.yaml at ``model.hidden_dim`` 192 and 640 on the card: the route
    each kernel family takes at those widths (printed), batch-64 requests
    served against the plain path and 4 training micro-steps (one against
    the plain path, the same seed twice bit for bit), each with the launch
    counts its routes name. Returns the launches by path."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as attn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import mlp

    print("[c5]", flush=True)
    check_c5_kernels(torch)
    idx64 = [torch.from_numpy(row).long() for row in batches]
    idx32 = [torch.from_numpy(row).long() for row in train_idx]
    out = {}
    for hidden, (serve_want, step_want) in C5_WIDTHS.items():
        label = f"hidden_dim={hidden}"
        head_dim = hidden // 4  # base.yaml's 4 heads
        print(f"  {label}: attention at head_dim {head_dim}: {attn.attention_route(head_dim)} "
              f"(kernel head_dim {attn.kernel_head_dim(head_dim)}); residual-LN halves and "
              f"fused_mlp at d_model {hidden}: {mlp.mlp_route(hidden)} (kernel width "
              f"{mlp.kernel_width(hidden)}, LayerNorm over {hidden}, d_ff "
              f"{mlp.ffw_width(2048)}); head at H {hidden}: kernel", flush=True)
        overrides = [f"model.hidden_dim={hidden}"]
        out[f"serve{hidden}"], model, _p50 = serve_vs_plain(
            torch, kernels, overrides, split, idx64, label, smi, serve_want, timed=6)
        del model
        out[f"train{hidden}"] = train_route(
            torch, kernels, overrides, split, idx32, label, smi,
            step_want, steps=C5_STEPS, profile_steps=2)[0]
        torch.cuda.empty_cache()
    return out


# the presets of config/fusion_strategies.yaml whose heads are not hybrid: the
# heads run as the model's own nn.Linear layers, so a request launches the
# encoders' attention and no head kernel, and a micro-step the default
# route's encoder kernels
FUSION_PRESETS = ("early_fusion", "late_fusion", "uncertainty_fusion")
FUSION_SERVE_CALLS = 20
FUSION_STEPS = 8
ENCODER_KERNELS = ("packed_attention_fwd", "packed_attention_bwd", *LN_KERNELS,
                   "dropout_keep_mask")  # one launch each per encoder layer a micro-step
# every PAMAP2 stream on the CNN encoder, the hybrid head: the head kernel and
# no attention a request, no kernel a micro-step
CNN_STREAMS = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")


def serve_profile(torch, model, split, idx, label):
    """Device time by kernel family of ``model``'s served batch-64 requests
    (``profile``) and the head kernel's share of it."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn

    serve = make_serving_fn(model, device="cuda")

    def run_requests(n):
        for i in range(n):
            feats, _labels, lengths = split.gather(idx[i % len(idx)])
            serve(feats, None, lengths)
        torch.cuda.synchronize()

    print(f"  {label}: served requests", flush=True)
    return profile(torch, run_requests, 10, "request")


def checkpoint_round_trip(torch, trainer, test, workdir: Path, label):
    """The trainer's model saved as a checkpoint, rebuilt from its directory
    alone: its weights and buffers equal, and its logits on the test split
    bit-identical to the in-memory model's."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        CheckpointManager, load_checkpoint,
    )

    saved = CheckpointManager(workdir / label, config=trainer.config, save_top_k=1).save(
        trainer.model.state_dict(), epoch=0, score=1.0)
    weights, cfg, _meta = load_checkpoint(saved)
    reloaded = MultimodalFusionModel.from_config(cfg, device="cuda")
    reloaded.load_state_dict(weights)
    state = trainer.model.state_dict()
    tensors = all(torch.equal(v, reloaded.state_dict()[k]) for k, v in state.items())
    same = torch.equal(torch.from_numpy(trainer.evaluate_logits(test)),
                       torch.from_numpy(trainer.evaluate_logits(test, model=reloaded)))
    print(f"  {label}: checkpoint rebuilt from its directory ({cfg.model.fusion_type} head, "
          f"{len(state)} tensors, {sum(1 for k in state if 'running_' in k)} BatchNorm "
          f"buffers) equal: {tensors}; logits on {test.num_windows} test windows bit-identical: "
          f"{same}", flush=True)
    if not (tensors and same):
        raise AssertionError(f"{label}: the checkpoint does not reload to the model it saved")


def fusion_phase(torch, kernels, split, batches, train_idx, test, smi, workdir: Path):
    """early_fusion, late_fusion and uncertainty_fusion of
    config/fusion_strategies.yaml over base.yaml: served (4 attention
    forwards, no head kernel a request) against the plain path, trained
    (one micro-step against the plain path, 8 counted micro-steps, the same
    seed twice bit for bit), a checkpoint reloaded; MC-dropout uncertainty
    fusion on the uncertainty preset. Returns the launches by path."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.uncertainty import (
        mc_dropout_uncertainty_fusion,
    )

    print("[fusion]", flush=True)
    idx64 = [torch.from_numpy(row).long() for row in batches]
    idx32 = [torch.from_numpy(row).long() for row in train_idx]
    per_step = len(split.modalities)
    out = {}
    for preset in FUSION_PRESETS:
        overrides = [f"preset={preset}"]
        out[f"serve_{preset}"], model, _p50 = serve_vs_plain(
            torch, kernels, overrides, split, idx64, preset, smi,
            {"packed_attention_fwd": per_step}, timed=FUSION_SERVE_CALLS)
        serve_profile(torch, model, split, idx64, preset)
        del model
        out[f"train_{preset}"], trainer = train_route(
            torch, kernels, overrides, split, idx32, preset, smi,
            dict.fromkeys(ENCODER_KERNELS, per_step), steps=FUSION_STEPS)
        checkpoint_round_trip(torch, trainer, test, workdir, preset)
        if preset == "uncertainty_fusion":
            feats, _labels, lengths = split.gather(idx64[0])
            mask = torch.ones((BATCH, per_step), device="cuda")
            mask[:8, 1] = 0.0
            mask[8:12] = 0.0
            mask[8:12, 3] = 1.0
            num = int(trainer.config.uncertainty.num_mc_samples)
            for fn in kernels.values():
                fn.launches = 0
            logits, weights = mc_dropout_uncertainty_fusion(
                trainer.model, feats, mask, lengths, num_samples=num, seed=int(trainer.seed))
            torch.cuda.synchronize()
            out["mc_uncertainty_fusion"] = {name: fn.launches for name, fn in kernels.items()}
            again = mc_dropout_uncertainty_fusion(
                trainer.model, feats, mask, lengths, num_samples=num, seed=int(trainer.seed))
            sums = weights.sum(dim=1)
            e = (sums - 1.0).abs().max().item()
            repeat = torch.equal(logits, again[0]) and torch.equal(weights, again[1])
            print(f"  mc_dropout_uncertainty_fusion: {num} samples of batch {BATCH}, logits "
                  f"{tuple(logits.shape)} finite: {bool(torch.isfinite(logits).all())}; weights "
                  f"sum to 1 on every row within {e:.2e}, zero off each row's modalities: "
                  f"{bool(torch.all(weights[mask == 0] == 0))}; same seed bit for bit: {repeat}; "
                  f"launches {out['mc_uncertainty_fusion']}", flush=True)
            # each sample: a train-mode forward of the four encoders (attention,
            # residual-LN forwards, one mask launch a layer), no head kernel
            want = {**dict.fromkeys(kernels, 0), **dict.fromkeys(
                ("packed_attention_fwd", "ffw_ln_fwd", "proj_ln_fwd", "dropout_keep_mask"),
                num * per_step)}
            if not torch.isfinite(logits).all() or e > 1e-5 or not repeat \
                    or not torch.all(weights[mask == 0] == 0) \
                    or out["mc_uncertainty_fusion"] != want:
                raise AssertionError("mc_dropout_uncertainty_fusion: weights, repeat or launches "
                                     f"(want {want})")
        del trainer
        torch.cuda.empty_cache()
    return out


CNN_CPU_TOL = 1e-5  # f32 both sides, the sums in another order; TF32 convolutions miss it


def cnn_vs_cpu(torch, model, overrides, split, idx, rows=8):
    """The CNN encoders' embeddings of ``rows`` real windows (two cut short)
    on the card against the same weights on the CPU, in eval mode: each
    stream's largest error over its largest magnitude within CNN_CPU_TOL.
    The same with TF32 convolutions allowed is printed beside it."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.device import pin_float32

    cpu = MultimodalFusionModel.from_config(load_cfg(overrides), device="cpu")
    cpu.load_state_dict(model.state_dict())
    feats, _labels, lengths = split.gather(idx[0])
    feats = {m: x[:rows] for m, x in feats.items()}
    lengths = lengths[:rows].clone()
    lengths[:2] = torch.tensor([37, 1], dtype=lengths.dtype, device=lengths.device)
    model.eval()
    with torch.inference_mode():
        want = cpu.eval().encode({m: x.cpu() for m, x in feats.items()}, lengths.cpu())

        def err():
            got = model.encode(feats, lengths)
            return max((got[m].cpu() - w).abs().max().item() / w.abs().max().item()
                       for m, w in want.items())

        e_f32 = err()
        torch.backends.cudnn.allow_tf32 = True
        try:
            e_tf32 = err()
        finally:
            pin_float32()
    print(f"  cnn: encoders on the card vs the CPU on {rows} windows: max rel err {e_f32:.3e} "
          f"(tol {CNN_CPU_TOL}); with TF32 convolutions {e_tf32:.3e}", flush=True)
    if not e_f32 < CNN_CPU_TOL:
        raise AssertionError(f"cnn: the card's CNN encoders disagree with the CPU: {e_f32}")


def cnn_phase(torch, kernels, split, batches, train_idx, test, smi, workdir: Path):
    """Every PAMAP2 stream on the CNN encoder (two convolutions, masked
    BatchNorm), the hybrid head: built with TF32 turned on first (resolving
    the card must pin full f32), served (the head kernel, no attention)
    against the plain head, its encoders against the CPU (``cnn_vs_cpu``),
    trained (no kernel) against the plain path and twice bit for bit; the
    BatchNorm buffers move with training, stay as they were through MC
    dropout, and come back from a checkpoint. Returns the launches by path."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.uncertainty import (
        MCDropoutUncertainty,
    )

    print("[cnn]", flush=True)
    overrides = [f"model.encoders.{m}.encoder_type=cnn" for m in CNN_STREAMS]
    idx64 = [torch.from_numpy(row).long() for row in batches]
    idx32 = [torch.from_numpy(row).long() for row in train_idx]
    out = {}
    # TF32 and cuDNN's free choice of algorithm on: building the model
    # resolves the card, which must pin full float32 and deterministic cuDNN
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    out["serve"], model, _p50 = serve_vs_plain(
        torch, kernels, overrides, split, idx64, "cnn", smi, {"fused_hybrid_head": 1},
        timed=FUSION_SERVE_CALLS)
    pinned = not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32) \
        and torch.backends.cudnn.deterministic
    print(f"  cnn: from_config on the card pinned TF32 off and cuDNN deterministic: {pinned}",
          flush=True)
    if not pinned:
        raise AssertionError("cnn: resolving the card did not pin full float32")
    cnn_vs_cpu(torch, model, overrides, split, idx64)
    fresh = {k: v.clone() for k, v in model.named_buffers()}
    serve_profile(torch, model, split, idx64, "cnn")
    del model
    out["train"], trainer = train_route(
        torch, kernels, overrides, split, idx32, "cnn", smi, {}, steps=FUSION_STEPS)
    trained = {k: v.clone() for k, v in trainer.model.named_buffers()}
    moved = sum(not torch.equal(v, fresh[k]) for k, v in trained.items())
    feats, _labels, lengths = split.gather(idx64[1])
    MCDropoutUncertainty(trainer.model, num_samples=4, seed=1)(feats, None, lengths)
    torch.cuda.synchronize()
    kept = all(torch.equal(v, trained[k]) for k, v in trainer.model.named_buffers())
    print(f"  cnn: {len(trained)} BatchNorm buffers, {moved} moved by {FUSION_STEPS} training "
          f"micro-steps; unchanged by an MC-dropout call: {kept}", flush=True)
    if moved != len(trained) or not kept:
        raise AssertionError("cnn: the BatchNorm buffers did not move with training, or MC "
                             "dropout wrote them")
    checkpoint_round_trip(torch, trainer, test, workdir, "cnn")
    del trainer
    torch.cuda.empty_cache()
    return out


RNN_TRAIN_STEPS = 8


def rnn_overrides(modalities, cell, chunk=512):
    """base.yaml as the reference's LSTM parity model: every modality's
    encoder ``encoder_type=<cell> num_layers=1`` (they group into one
    ``GroupedRNNEncoder``), at ``dataset.chunk_size=<chunk>``."""
    out = [f"dataset.chunk_size={chunk}"]
    for m in modalities:
        out += [f"model.encoders.{m}.encoder_type={cell}", f"model.encoders.{m}.num_layers=1"]
    return out


def rnn_serve(torch, kernels, cell, chunk, split, idx, smi, timed=12):
    """Serve three batch-64 requests of the ``cell`` model at ``chunk`` with
    exact launch counts, against the same weights at ``model.pallas_rnn=false``
    with the plain head; then p50 and device time by family. Returns the
    launches of the first request, the model and the first request."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    label = f"{cell.upper()}{chunk}"
    modalities = list(split.modalities)
    overrides = rnn_overrides(modalities, cell, chunk)
    cfg = load_config(REPO / "config" / "base.yaml", overrides)
    model = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
    enc = model.grouped_rnn_encoder
    if model.grouped_rnn_names != tuple(modalities) or not enc.use_pallas or enc.cell_type != cell:
        raise AssertionError(f"{label}: the model did not group its encoders onto the kernels")
    plain = MultimodalFusionModel.from_config(
        load_config(REPO / "config" / "base.yaml", [*overrides, "model.pallas_rnn=false"]),
        device="cuda")
    plain.load_state_dict(model.state_dict())
    serve = make_serving_fn(model, device="cuda")

    @torch.inference_mode()
    def serve_plain(feats, mask, lengths):
        encoded = plain.encode(feats, lengths)
        for m in modalities:
            encoded.setdefault(m, torch.zeros((BATCH, plain.output_dim), device="cuda"))
        return plain.fuse(encoded, mask)

    # the first request also carries the split's short windows
    short = (split.lengths < chunk).nonzero().flatten()[:8].cpu()
    feats0, _l, lengths0 = split.gather(torch.cat([short, idx[0][: BATCH - len(short)]]))
    feats1, _l, lengths1 = split.gather(idx[1])
    missing = modalities[-1]  # the narrow member: zero-filled at its own width
    mask1 = torch.ones((BATCH, len(modalities)), device="cuda")
    mask1[:, -1] = 0.0
    feats2, _l, _len = split.gather(idx[2])
    lengths2 = torch.randint(1, 160, (BATCH,), generator=torch.Generator().manual_seed(7),
                             dtype=torch.int32)
    lengths2[:3] = torch.tensor([0, 37, 1], dtype=torch.int32)
    requests = [
        ("all modalities", feats0, None, lengths0),
        (f"{missing} missing", {m: x for m, x in feats1.items() if m != missing}, mask1, lengths1),
        ("short lengths", feats2, None, lengths2.cuda()),
    ]
    fused = "grouped_lstm_fused" if cell == "lstm" else "grouped_gru_fused"
    want = {**dict.fromkeys(kernels, 0), fused: 1, "fused_hybrid_head": 1}
    first = None
    for name, feats, mask, lengths in requests:
        for fn in kernels.values():
            fn.launches = 0
        got = serve(feats, mask, lengths)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in kernels.items()}
        first = first or launches
        if launches != want:
            raise AssertionError(f"{label} '{name}': launches {launches} != {want}")
        ref = serve_plain(feats, mask, lengths)
        torch.cuda.synchronize()
        if {k: fn.launches for k, fn in kernels.items()} != launches:
            raise AssertionError(f"{label}: the plain path launched a kernel")
        if got.shape != (BATCH, model.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"{label} '{name}': bad logits {tuple(got.shape)}")
        e = (got - ref).abs().max().item()
        print(f"  {label} request '{name}': 1 {fused} + 1 head launch, logits {tuple(got.shape)} "
              f"finite, max_abs_err vs plain path {e:.3e} (tol {LOGIT_TOL})", flush=True)
        if e > LOGIT_TOL:
            raise AssertionError(f"{label} '{name}': served logits disagree with the plain path: {e}")
    del plain
    torch.cuda.empty_cache()
    lat = []
    for i in range(timed):
        feats, _labels, lengths = split.gather(idx[i % len(idx)])
        t = time.perf_counter()
        serve(feats, None, lengths)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    lat = sorted(lat[2:])
    p50 = lat[len(lat) // 2]
    print(f"  {label}: serve batch {BATCH} p50 {p50 * 1e3:.3f} ms, {BATCH / p50:.1f} windows/s on "
          f"{smi}", flush=True)

    def run_requests(n):
        for i in range(n):
            feats, _labels, lengths = split.gather(idx[i % len(idx)])
            serve(feats, None, lengths)
        torch.cuda.synchronize()

    profile(torch, run_requests, 6, "request")
    return first, model, serve, requests[0]


def rnn_phase(torch, kernels, split, modalities, stride, seed, smi, workdir: Path):
    """The recurrent model family on the card: served and evaluated through
    the inference recurrence kernels, trained, fitted and MC-dropout evaluated
    through the training kernels. Returns launches by path."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.convert import (
        ungroup_state_dict,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import evaluate_model
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.grouped import (
        grouped_dense, stack_group_features,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion, rnn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    print("[rnn]", flush=True)
    out = {}
    splits = {512: split}
    for cell, chunk in (("lstm", 512), ("lstm", 1024), ("gru", 512)):
        label = f"{cell.upper()}{chunk}"
        if chunk not in splits:
            splits[chunk] = load_split(torch, modalities, chunk, stride)
        data = splits[chunk]
        idx = index_batches(torch, data, BATCH, seed)
        out[f"serve_{cell}{chunk}"], model, serve, request = rnn_serve(
            torch, kernels, cell, chunk, data, idx, smi)
        _name, feats, _mask, lengths = request

        if cell == "lstm":
            # the precomputed-projection kernel's path: the encoder's own x_proj
            # product, grouped_lstm_forward, projection, LayerNorms, head kernel
            enc = model.grouped_rnn_encoder
            params = fusion.hybrid_head_params(model.fusion_model)
            for fn in kernels.values():
                fn.launches = 0
            with torch.inference_mode():
                stacked = stack_group_features(feats, modalities)
                x_proj = grouped_dense(stacked, enc.weight_ih_l0, enc.bias_ih_l0) \
                    .permute(2, 0, 1, 3).contiguous()  # [T, G, B, 4H]
                final = rnn.grouped_lstm_forward(
                    x_proj, enc.weight_hh_l0.detach(), enc.bias_hh_l0.detach(),
                    lengths.to(torch.int32))
                embedded = grouped_dense(final, enc.proj_kernel, enc.proj_bias)
                encoded = {m: model.layer_norms[m](embedded[i]) for i, m in enumerate(modalities)}
                mask = torch.ones((BATCH, len(modalities)), device="cuda")
                routed = fusion.hybrid_fused_inference(params, encoded, mask, modalities)
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in kernels.items()}
            want = {**dict.fromkeys(kernels, 0), "grouped_lstm_forward": 1, "fused_hybrid_head": 1}
            e = (routed - serve(feats, None, lengths)).abs().max().item()
            with torch.inference_mode():  # a second launch on the same inputs
                again = torch.equal(final, rnn.grouped_lstm_forward(
                    x_proj, enc.weight_hh_l0.detach(), enc.bias_hh_l0.detach(),
                    lengths.to(torch.int32)))
            print(f"  {label}: x_proj ({x_proj.numel() * 4 / 1e6:.0f} MB) -> grouped_lstm_forward "
                  f"(route {rnn.grouped_lstm_forward_route(enc.hidden_dim)}) -> projection, "
                  f"LayerNorms, head kernel: logits max_abs_err vs the served ones (x_proj read "
                  f"vs x W_ih computed in the kernel) {e:.3e} (tol {RNN_ROUTE_TOL}); a second "
                  f"launch bit for bit: {again}; launches {launches}", flush=True)
            if launches != want or e > RNN_ROUTE_TOL or not again:
                raise AssertionError(f"{label}: the grouped_lstm_forward path is off: {e}, "
                                     f"{launches}, repeats: {again}")
            out[f"forward_{cell}{chunk}"] = launches
            del x_proj, stacked

        if chunk == 512:
            # the same function as four encoders carrying the same weights unstacked
            cfg = load_config(REPO / "config" / "base.yaml",
                              [*rnn_overrides(modalities, cell), "model.grouped_encoders=false"])
            ungrouped = MultimodalFusionModel.from_config(cfg, device="cuda")
            dims = {m: int(cfg.model.encoders[m].input_dim) for m in modalities}
            ungrouped.load_state_dict(ungroup_state_dict(
                model.state_dict(), (), dims, rnn_names=model.grouped_rnn_names))
            with torch.inference_mode():
                e = (model(feats, None, lengths)
                     - ungrouped(feats, None, lengths)).abs().max().item()
            print(f"  {label}: grouped model vs the ungrouped model on the same weights unstacked: "
                  f"logits max_abs_err {e:.3e} (tol {LOGIT_TOL})", flush=True)
            if e > LOGIT_TOL or ungrouped.grouped_rnn_names:
                raise AssertionError(f"{label}: the grouped model is not the ungrouped model's "
                                     f"function: {e}")
            del ungrouped

        if (cell, chunk) == ("lstm", 512):
            test = load_split(torch, modalities, chunk, chunk, "test")
            for fn in kernels.values():
                fn.launches = 0
            t = time.perf_counter()
            metrics = evaluate_model(model, test, batch_size=32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            out["eval_lstm512"] = {k: fn.launches for k, fn in kernels.items()}
            print(f"  {label} evaluate_model on {metrics['num_samples']} test windows (random "
                  f"weights) in {wall * 1e3:.1f} ms: accuracy {metrics['accuracy']:.4f}, loss "
                  f"{metrics['loss']:.4f}; launches {out['eval_lstm512']}", flush=True)
            others = {k: v for k, v in out["eval_lstm512"].items() if k != "grouped_lstm_fused"}
            if not math.isfinite(metrics["loss"]) or out["eval_lstm512"]["grouped_lstm_fused"] <= 0 \
                    or any(others.values()):
                raise AssertionError("LSTM512 evaluation is not finite or left the recurrence kernel")
            del test
        del model, serve
        torch.cuda.empty_cache()

    # the family's training route: base.yaml's pallas_rnn: auto trains through
    # the training kernels; the plain loop (pallas_rnn=false) is the yardstick
    idx32 = index_batches(torch, split, RNN_TRAIN_B, seed)
    for cell, steps in (("lstm", RNN_TRAIN_STEPS), ("gru", RNN_TRAIN_STEPS // 2)):
        label = f"{cell.upper()}512"
        overrides = rnn_overrides(modalities, cell)
        micro_step_vs_plain(torch, split, idx32[0], overrides,
                            f"{label} training kernels vs model.pallas_rnn=false",
                            plain_overrides=["model.pallas_rnn=false"])
        torch.cuda.reset_peak_memory_stats()
        trainer = _trainer(torch, overrides)
        if not trainer.model.grouped_rnn_encoder.use_pallas:
            raise AssertionError(f"{label}: base.yaml's pallas_rnn no longer turns the kernels on")
        step, losses, launches = counted_steps(torch, kernels, trainer, split, idx32, steps)
        want = {**dict.fromkeys(kernels, 0), f"{cell}_train_fwd": steps, f"{cell}_train_bwd": steps}
        print(f"  {label}: {steps} micro-steps, {trainer.optimizer.count} updates; losses "
              f"{[round(v, 5) for v in losses]}; launches {launches} (want {want})", flush=True)
        if launches != want:
            raise AssertionError(f"{label}: training launch counts {launches} != {want}")
        _step2, losses2, _launches2 = counted_steps(
            torch, kernels, _trainer(torch, overrides), split, idx32, steps)
        print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
        if losses2 != losses:
            raise AssertionError(f"{label}: the same seed gave other losses: {losses} then {losses2}")
        del _step2
        step_p50(torch, step, split, idx32, RNN_TRAIN_B, label + " (training kernels)", smi,
                 iters=10)
        profile_micro_steps(torch, step, split, idx32, 4)
        out[f"train_{cell}512"] = launches
        del trainer, step

        plain = _trainer(torch, [*overrides, "model.pallas_rnn=false"])
        plain_step, _losses, plain_launches = counted_steps(torch, kernels, plain, split, idx32, 2)
        if any(plain_launches.values()):
            raise AssertionError(f"{label}: the plain training route launched a kernel")
        step_p50(torch, plain_step, split, idx32, RNN_TRAIN_B,
                 label + " model.pallas_rnn=false (the plain loop)", smi, iters=4)
        del plain, plain_step

    data = splits[1024]
    idx1024 = index_batches(torch, data, RNN_TRAIN_B, seed)
    trainer = _trainer(torch, rnn_overrides(modalities, "lstm", 1024))
    step, losses, launches = counted_steps(torch, kernels, trainer, data, idx1024, 4)
    want = {**dict.fromkeys(kernels, 0), "lstm_train_fwd": 4, "lstm_train_bwd": 4}
    print(f"  LSTM1024: 4 micro-steps; losses {[round(v, 5) for v in losses]}; launches "
          f"{launches}", flush=True)
    if launches != want:
        raise AssertionError(f"LSTM1024: training launch counts {launches} != {want}")
    step_p50(torch, step, data, idx1024, RNN_TRAIN_B, "LSTM1024 (training kernels)", smi, iters=8)
    profile_micro_steps(torch, step, data, idx1024, 4)
    out["train_lstm1024"] = launches
    del trainer, step, data, splits
    torch.cuda.empty_cache()
    out.update(rnn_fit_phase(torch, kernels, modalities, smi, workdir))
    return out


def rnn_fit_phase(torch, kernels, modalities, smi, workdir: Path):
    """One epoch of ``Trainer.fit`` for LSTM512 through the training kernels,
    the ``last`` checkpoint reloaded from its directory, and
    ``evaluate_checkpoint`` on it, whose MC-dropout pass runs training-mode
    forwards through the training forward kernel."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import (
        dataset_kwargs, evaluate_checkpoint,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        load_checkpoint,
    )

    trainer = _trainer(torch, [
        *rnn_overrides(modalities, "lstm"), "training.max_epochs=1",
        f"dataset.data_dir={REPO / 'data' / 'pamap2'}",
        f"dataset.chunk_cache_dir={workdir / 'chunk_cache'}"])
    train_w, val_w, test_w = create_datasets(**dataset_kwargs(trainer.config))
    steps = math.ceil(train_w.num_windows / trainer.batch_size)
    for fn in kernels.values():
        fn.launches = 0
    results = trainer.fit(train_w, val_w, test_w, save_dir=workdir / "lstm_run",
                          log_fn=lambda msg: print(f"  {msg}", flush=True))
    torch.cuda.synchronize()
    fit_launches = {name: fn.launches for name, fn in kernels.items()}
    wall = results["train_wall_seconds"]
    print(f"  LSTM512 fit: 1 epoch ({steps} micro-steps) in {wall:.2f} s, "
          f"{train_w.num_windows / wall:.1f} train windows/s on {smi}; test acc "
          f"{results['test_acc']:.4f}; launches {fit_launches}", flush=True)
    if fit_launches["lstm_train_fwd"] != steps or fit_launches["lstm_train_bwd"] != steps \
            or fit_launches["grouped_lstm_fused"] <= 0 or not _all_finite(results["history"]):
        raise AssertionError(f"LSTM512 fit did not train and evaluate through the kernels: "
                             f"{fit_launches}")

    last = workdir / "lstm_run" / "checkpoints" / "last"
    weights, ckpt_cfg, meta = load_checkpoint(last)
    reloaded = MultimodalFusionModel.from_config(ckpt_cfg, device="cuda")
    reloaded.load_state_dict(weights)
    test_data = DeviceSplit.from_windows(test_w, device="cuda")
    same = torch.equal(torch.from_numpy(trainer.evaluate_logits(test_data)),
                       torch.from_numpy(trainer.evaluate_logits(test_data, model=reloaded)))
    print(f"  LSTM512 checkpoint 'last' (epoch {meta['epoch']}) reloaded from its directory: "
          f"grouped onto the kernels {bool(reloaded.grouped_rnn_encoder.use_pallas)}, test "
          f"logits bit-identical: {same}", flush=True)
    if not same or not reloaded.grouped_rnn_encoder.use_pallas:
        raise AssertionError("the LSTM checkpoint does not reload to the model it saved")
    del reloaded, trainer
    for fn in kernels.values():
        fn.launches = 0
    out_dir = workdir / "lstm_experiments"
    evaluate_checkpoint(str(last), output_dir=str(out_dir), analysis_dir=str(workdir / "analysis"),
                        device="cuda", plots=False)
    torch.cuda.synchronize()
    eval_launches = {name: fn.launches for name, fn in kernels.items()}
    unc = json.loads((out_dir / "uncertainty.json").read_text())
    print(f"  LSTM512 evaluate_checkpoint: MC dropout over {unc['mc_dropout']['num_windows']} "
          f"windows x {unc['mc_dropout']['num_samples']}, mean variance "
          f"{unc['mc_dropout']['mean_uncertainty']:.6f}; launches {eval_launches}", flush=True)
    if eval_launches["lstm_train_fwd"] <= 0 or eval_launches["lstm_train_bwd"] != 0 \
            or eval_launches["grouped_lstm_fused"] <= 0 or not _all_finite(unc):
        raise AssertionError(f"LSTM512 evaluation missed the kernels: {eval_launches}")
    return {"fit_lstm512": fit_launches, "eval_ckpt_lstm512": eval_launches}


RESULT_KEYS = {"best_model_path", "best_val_loss", "config", "test_acc", "history",
               "train_wall_seconds"}
EVAL_KEYS = {"dataset", "fusion_type", "test_accuracy", "test_f1_macro", "test_loss", "ece", "mce",
             "nll", "inference_ms_mean", "inference_ms_std", "inference_ms_amortized",
             "per_class_accuracy", "num_test_windows"}
UNCERTAINTY_KEYS = {"dataset", "fusion_type", "ece", "mce", "nll", "num_bins", "mc_dropout",
                    "temperature", "ece_after_temperature_scaling",
                    "nll_after_temperature_scaling"}
MISSING_KEYS = {"full_modalities", "single_modalities", "all_combinations", "modality_importance"}


def _all_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def fit_and_eval_phase(torch, kernels, smi, workdir: Path, bf16=False):
    """``Trainer.fit`` for FIT_EPOCHS epochs at the default config on the real
    splits, then the checkpoints reloaded and evaluated. With ``bf16``, the
    same at ``mixed_precision=true``: the bf16 entries launched where the
    f32 ones were, and no f32 attention or residual-LN entry."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import (
        dataset_kwargs, evaluate_checkpoint,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        load_checkpoint,
    )

    tag, sfx = ("[bf16] ", "_bf16") if bf16 else ("", "")
    print(f"{tag}[fit]", flush=True)
    # the default config; only where files live and how long it trains differ
    trainer = _trainer(torch, [
        f"training.max_epochs={FIT_EPOCHS}", f"dataset.data_dir={REPO / 'data' / 'pamap2'}",
        f"dataset.chunk_cache_dir={workdir / 'chunk_cache'}",
        *(["mixed_precision=true"] if bf16 else [])])
    cfg = trainer.config
    train_w, val_w, test_w = create_datasets(**dataset_kwargs(cfg))
    batch = trainer.batch_size
    steps = FIT_EPOCHS * math.ceil(train_w.num_windows / batch)
    print(f"  {train_w.num_windows} train / {val_w.num_windows} val / {test_w.num_windows} test "
          f"windows; {steps} micro-steps in {FIT_EPOCHS} epochs; dropout_rng "
          f"{cfg.training.dropout_rng}", flush=True)
    for fn in kernels.values():
        fn.launches = 0
    results = trainer.fit(train_w, val_w, test_w, save_dir=workdir / "run",
                          log_fn=lambda msg: print(f"  {msg}", flush=True))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"  launches: {launches}", flush=True)
    on_disk = json.loads((workdir / "run" / "results.json").read_text())
    if set(on_disk) != RESULT_KEYS or set(results) != RESULT_KEYS:
        raise AssertionError(f"results.json keys {sorted(on_disk)} != {sorted(RESULT_KEYS)}")
    history = results["history"]
    if len(history) != FIT_EPOCHS or not _all_finite(history) \
            or not math.isfinite(results["best_val_loss"]):
        raise AssertionError(f"fit history is not {FIT_EPOCHS} finite epochs: {history}")
    per_step = 4  # encoders, one layer each
    want = {"dropout_keep_mask": per_step * steps, f"packed_attention_bwd{sfx}": per_step * steps,
            **{f"{name}{sfx}": per_step * steps for name in LN_KERNELS},
            "fused_hybrid_head": 0, "fused_mlp_fwd": 0, "fused_mlp_bwd": 0}
    if bf16:  # none of the f32 entries of the same rows
        want.update(dict.fromkeys(("packed_attention_fwd", "packed_attention_bwd", *LN_KERNELS), 0))
    got = {name: launches[name] for name in want}
    if got != want or launches[f"packed_attention_fwd{sfx}"] <= per_step * steps:
        raise AssertionError(f"fit launch counts {launches} != {want} (+ eval attention)")
    best = Path(results["best_model_path"])
    last = workdir / "run" / "checkpoints" / "last"
    for path in (best / "variables.pt", best / "meta.json", last / "variables.pt",
                 last / "meta.json", last / "train_state.pt"):
        if not path.is_file():
            raise AssertionError(f"checkpoint file missing: {path}")
    wall = results["train_wall_seconds"]
    print(f"  {FIT_EPOCHS} epochs in {wall:.2f} s: {wall / FIT_EPOCHS:.2f} s per epoch (train, "
          f"val, checkpoint), {FIT_EPOCHS * train_w.num_windows / wall:.1f} train windows/s on "
          f"{smi}; best {best.name}, test acc {results['test_acc']:.4f}", flush=True)

    print(f"{tag}[eval]", flush=True)
    # `last` holds the weights the trainer ends with: reloaded from the
    # directory alone they must give the in-memory model's logits exactly
    test_data = DeviceSplit.from_windows(test_w, device="cuda")
    weights, ckpt_cfg, meta = load_checkpoint(last)
    reloaded = MultimodalFusionModel.from_config(ckpt_cfg, device="cuda")
    reloaded.load_state_dict(weights)
    same = torch.equal(torch.from_numpy(trainer.evaluate_logits(test_data)),
                       torch.from_numpy(trainer.evaluate_logits(test_data, model=reloaded)))
    print(f"  checkpoint 'last' (epoch {meta['epoch']}) reloaded from its directory: test logits "
          f"bit-identical to the in-memory model: {same}", flush=True)
    if not same:
        raise AssertionError("a reloaded checkpoint gives other logits than the model it saved")
    del reloaded
    for fn in kernels.values():
        fn.launches = 0
    out_dir = workdir / "experiments"
    standard = evaluate_checkpoint(
        str(best), output_dir=str(out_dir), analysis_dir=str(workdir / "analysis"),
        missing_modality_test=True, device="cuda", plots=False)
    torch.cuda.synchronize()
    eval_launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"  launches: {eval_launches}", flush=True)
    files = {name: json.loads((out_dir / f"{name}.json").read_text())
             for name in ("evaluation_results", "uncertainty", "missing_modality")}
    for name, keys in (("evaluation_results", EVAL_KEYS), ("uncertainty", UNCERTAINTY_KEYS),
                       ("missing_modality", MISSING_KEYS)):
        if set(files[name]) != keys:
            raise AssertionError(f"{name}.json keys {sorted(files[name])} != {sorted(keys)}")
        if not _all_finite(files[name]):
            raise AssertionError(f"{name}.json holds a non-finite number")
    if len(files["missing_modality"]["all_combinations"]) != 15:
        raise AssertionError("the missing-modality sweep does not cover 15 subsets")
    if standard["test_accuracy"] != results["test_acc"]:
        raise AssertionError(f"evaluation accuracy {standard['test_accuracy']} != fit's test_acc "
                             f"{results['test_acc']} on the same checkpoint")
    if eval_launches["dropout_keep_mask"] <= 0 or eval_launches[f"packed_attention_fwd{sfx}"] <= 0:
        raise AssertionError("evaluation did not go through the attention and mask kernels")
    if bf16 and any(eval_launches[n] for n in ("packed_attention_fwd", *LN_KERNELS)):
        raise AssertionError("the bf16 evaluation launched an f32 entry")
    unc = files["uncertainty"]
    print(f"  test acc {standard['test_accuracy']:.4f}, macro-F1 {standard['test_f1_macro']:.4f}, "
          f"ECE {standard['ece']:.4f}, NLL {standard['nll']:.4f}; T {unc['temperature']:.3f}; "
          f"MC-dropout mean variance {unc['mc_dropout']['mean_uncertainty']:.6f}", flush=True)
    print(f"  latency per sample {standard['inference_ms_mean']:.4f} ms (std "
          f"{standard['inference_ms_std']:.4f}), amortised "
          f"{standard['inference_ms_amortized']:.4f} ms at batch {batch} on {smi}", flush=True)
    if not bf16:
        latency_sweep(torch, trainer.model, test_data, batch)
    return launches, eval_launches


SWEEP_BATCHES = 4  # well-formed batches of the [eval] latency sweep, beside one malformed


def latency_sweep(torch, model, test_data, batch):
    """``evaluate.measure_inference_latency`` over a list of batch tuples
    (the loose-iterable route, ``_latency_over_batches``) of which one entry
    is malformed: exactly that entry is skipped with the reference's
    warning, and every other one is timed (two clock readings each)."""
    import contextlib
    import io

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch import evaluate

    sweep = []
    for i in range(SWEEP_BATCHES):
        idx = (torch.arange(batch) + i * batch) % test_data.num_windows
        feats, labels, lengths = test_data.gather(idx.cuda())
        sweep.append((feats, labels, torch.ones((batch, len(feats)), device="cuda"), lengths))
    sweep.insert(2, ("not-a-mapping",))

    class Clock:  # counts the sweep's clock readings
        calls = 0

        @staticmethod
        def perf_counter():
            Clock.calls += 1
            return time.perf_counter()

    real, evaluate.time = evaluate.time, Clock
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            mean, std = evaluate.measure_inference_latency(model, sweep, max_batches=len(sweep),
                                                           warmup=2)
    finally:
        evaluate.time = real
    warnings = [line.strip() for line in printed.getvalue().splitlines()]
    timed = Clock.calls // 2
    print(f"  latency sweep over {len(sweep)} loose batches: {timed} timed, warnings {warnings}; "
          f"{mean:.4f} ms per sample (std {std:.4f})", flush=True)
    if warnings != ["Warning: Unable to parse batch for latency measurement, skipping."] \
            or timed != SWEEP_BATCHES or not mean > 0:
        raise AssertionError("the latency sweep did not skip exactly the malformed batch")


BUNDLE_TIMED = 20  # requests timed on each of make_serving_fn and the bundle, in turns
BUNDLE_REQUESTS = 3  # requests held bit for bit, with the launches counted


def bundle_phase(torch, kernels, modalities, batches, smi, workdir: Path):
    """For the flagship at chunk 512, LSTM512 and late fusion: a serving
    bundle exported to ``workdir`` and loaded back in this process
    (``serving.load_serving_bundle``, onto the card), served the batch-64
    requests of real windows: logits bit-identical to ``make_serving_fn``'s,
    the kernels counted at run time through the loaded graph, its ``msfa::``
    op nodes printed, the p50 and host enqueue time of both timed in turns,
    the bundle's host time split by part (``bundle_host_parts``). Returns the
    launches of one request by model."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import (
        export_serving_bundle, load_serving_bundle, make_serving_fn,
    )

    print("[bundle]", flush=True)
    cases = (  # label, overrides of base.yaml, launches of one request
        ("flagship", [], {"packed_attention_fwd": 4, "fused_hybrid_head": 1}),
        ("lstm512", rnn_overrides(modalities, "lstm"),
         {"grouped_lstm_fused": 1, "fused_hybrid_head": 1}),
        ("late", ["model.fusion_type=late"], {"packed_attention_fwd": 4}),
    )
    out = {}
    for label, overrides, per_request in cases:
        cfg = load_cfg(overrides)
        model = MultimodalFusionModel.from_config(
            cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
        serve = make_serving_fn(model, device="cuda")
        dims = {m: int(cfg.model.encoders[m].input_dim) for m in modalities}
        t = time.perf_counter()
        export_serving_bundle(model, workdir / label, BATCH, int(cfg.dataset.chunk_size), dims,
                              device="cuda")
        t_export = time.perf_counter() - t
        t = time.perf_counter()
        fn, meta = load_serving_bundle(workdir / label, device="cuda")
        t_load = time.perf_counter() - t
        requests = [(feats, lengths) for feats, _labels, lengths in batches[:BUNDLE_REQUESTS]]
        want = [serve(feats, None, lengths) for feats, lengths in requests]
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        got = [fn(feats, None, lengths) for feats, lengths in requests]
        torch.cuda.synchronize()
        launches = {name: k.launches for name, k in kernels.items() if k.launches}
        expect = {name: n * len(requests) for name, n in per_request.items()}
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        worst = max((a - b).abs().max().item() for a, b in zip(got, want))
        print(f"  {label}: exported in {t_export:.1f} s, loaded in {t_load:.1f} s; graph's msfa "
              f"ops {meta['ops']}; {len(requests)} requests through the loaded bundle launched "
              f"{launches} (want {expect}); logits bit-identical to make_serving_fn: {same} "
              f"(max abs diff {worst:.3e})", flush=True)
        if launches != expect:
            raise AssertionError(f"{label}: bundle launch counts {launches} != {expect}")
        if set(meta["ops"]) != set(per_request):
            raise AssertionError(f"{label}: the graph's ops {meta['ops']} are not {per_request}")
        if not same or not all(torch.isfinite(a).all() for a in got):
            raise AssertionError(f"{label}: the bundle's logits differ from make_serving_fn's")
        lat = {"make_serving_fn": [], "bundle": []}
        enq = {"make_serving_fn": [], "bundle": []}  # host time until the call returns
        for i in range(BUNDLE_TIMED + 3):
            feats, _labels, lengths = batches[i % len(batches)]
            for name, call in (("make_serving_fn", serve), ("bundle", fn)):
                t = time.perf_counter()
                call(feats, None, lengths)
                returned = time.perf_counter()
                torch.cuda.synchronize()
                lat[name].append(time.perf_counter() - t)
                enq[name].append(returned - t)
        p50 = {name: sorted(v[3:])[BUNDLE_TIMED // 2] * 1e3 for name, v in lat.items()}
        p50_enq = {name: sorted(v[3:])[BUNDLE_TIMED // 2] * 1e3 for name, v in enq.items()}
        print(f"  {label}: serve batch {BATCH} p50 bundle {p50['bundle']:.3f} ms, make_serving_fn "
              f"{p50['make_serving_fn']:.3f} ms; host enqueue p50 bundle {p50_enq['bundle']:.3f} "
              f"ms, make_serving_fn {p50_enq['make_serving_fn']:.3f} ms ({BUNDLE_TIMED} requests "
              f"each, in turns) on {smi}", flush=True)
        bundle_host_parts(torch, fn, serve, batches[0])
        for name, call in (("make_serving_fn", serve), ("bundle", fn)):
            def run(n, call=call):
                for i in range(n):
                    feats, _labels, lengths = batches[i % len(batches)]
                    call(feats, None, lengths)
                torch.cuda.synchronize()

            print(f"  {label}, {name}:", flush=True)
            profile(torch, run, 10, "request")
        out[label] = {name: launches.get(name, 0) // len(requests) for name in kernels}
        del model, serve, fn
        torch.cuda.empty_cache()
    return out


BUNDLE_PARTS_TIMED = 40  # rounds of the bundle's host parts, each part timed in turn


def bundle_host_parts(torch, fn, serve, request):
    """Where the loaded bundle's extra host time goes, on one request: the
    p50 host ms until each part returns, all parts timed in turns (``fn``;
    its module ``fn.graph`` called on ``fn``'s inputs; the module's
    pre-hooks, which check its 100-odd inputs against the exported
    signature; the pytree flattening of its inputs; ``make_serving_fn``),
    the differences (``fn``'s input coercion, the graph's own body), and the
    aten ops each path dispatches (a ``TorchDispatchMode`` count)."""
    import torch.fx._pytree as fx_pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_name = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket)
            self.by_name[name] = self.by_name.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    feats, _labels, lengths = request
    graph = fn.graph
    hooks = graph._forward_pre_hooks
    with_kwargs = graph._forward_pre_hooks_with_kwargs
    with torch.inference_mode():
        mask = torch.ones((lengths.shape[0], len(feats)), dtype=torch.float32, device="cuda")
        args = (fn.params, feats, mask, lengths)
        parts = {
            "fn": lambda: fn(feats, None, lengths),
            "graph module": lambda: graph(*args),
            "pre-hooks": lambda: [h(graph, args, {}) if k in with_kwargs else h(graph, args)
                                  for k, h in hooks.items()],
            "flatten": lambda: fx_pytree.tree_flatten_spec((list(args), {}), graph._in_spec),
            "make_serving_fn": lambda: serve(feats, None, lengths),
        }
        times = {name: [] for name in parts}
        for i in range(BUNDLE_PARTS_TIMED + 3):
            for name, call in parts.items():
                t = time.perf_counter()
                call()
                times[name].append(time.perf_counter() - t)
                torch.cuda.synchronize()
        counts = {}
        for name in ("make_serving_fn", "fn"):
            ops = Ops()
            with ops:
                parts[name]()
            counts[name] = ops.by_name
        torch.cuda.synchronize()
    ms = {name: sorted(v[3:])[BUNDLE_PARTS_TIMED // 2] * 1e3 for name, v in times.items()}
    ms["fn wrapper"] = ms["fn"] - ms["graph module"]  # its defaults and coercion
    ms["graph body"] = ms["graph module"] - ms["pre-hooks"] - ms["flatten"]
    extra = {k: v - counts["make_serving_fn"].get(k, 0) for k, v in counts["fn"].items()
             if v != counts["make_serving_fn"].get(k, 0)}
    print(f"    bundle host p50 ms by part ({BUNDLE_PARTS_TIMED} rounds, in turns): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; aten ops dispatched a request: bundle {sum(counts['fn'].values())}, "
          f"make_serving_fn {sum(counts['make_serving_fn'].values())}, the bundle's extra "
          f"{extra}", flush=True)


STREAM_PROFILE_STEPS = 12  # streamed micro-steps traced for the copy stream's overlap


def _copy_overlap(trace_path: Path) -> dict:
    """From a chrome trace of streamed micro-steps: the host-to-device copies
    on streams that run no kernel (the loader's side stream), their device
    ms, and the share of it during which a kernel ran on another stream."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream")) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    kernel_streams = {stream for _s, _e, stream in kernels}
    copies = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream")) for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
              and e["args"].get("stream") not in kernel_streams]
    spans = sorted((s, e) for s, e, _stream in kernels)
    merged = []
    for s, e in spans:  # union of the kernels' intervals
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    copy_us = sum(e - s for s, e, _ in copies)
    overlap_us = sum(max(0.0, min(e, me) - max(s, ms)) for s, e, _ in copies for ms, me in merged)
    return {"copies": len(copies), "copy_ms": copy_us / 1e3,
            "overlap": overlap_us / copy_us if copy_us else 0.0,
            "streams": sorted({stream for _s, _e, stream in copies})}


def stream_phase(torch, kernels, smi, workdir: Path):
    """One epoch of ``fit`` at chunk 512 with ``dataset.streaming=true``
    against one resident epoch from the same seed: losses and every weight
    bit for bit, the launches equal, the train split never put on the card
    whole; each epoch's seconds and peak memory; then the side stream's
    host-to-device copies over streamed micro-steps (torch.profiler): ms per
    step and the share that overlaps the step's kernels."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import dataset_kwargs

    print("[stream]", flush=True)
    common = ["training.max_epochs=1", f"dataset.data_dir={REPO / 'data' / 'pamap2'}",
              f"dataset.chunk_cache_dir={workdir / 'chunk_cache'}"]
    train_w, val_w, _test_w = create_datasets(**dataset_kwargs(load_cfg(common)))
    real = DeviceSplit.from_windows
    runs = {}
    for streaming in ("false", "true"):
        put = []
        DeviceSplit.from_windows = classmethod(
            lambda cls, w, device=None: put.append(w.num_windows) or real(w, device))
        try:
            trainer = _trainer(torch, [*common, f"dataset.streaming={streaming}"])
            live = []  # device memory in use as each micro-step starts

            def update(*args, live=live, inner=trainer._update):
                live.append(torch.cuda.memory_allocated())
                return inner(*args)

            trainer._update = update
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.values():
                k.launches = 0
            results = trainer.fit(train_w, val_w, None, save_dir=workdir / f"run_{streaming}",
                                  log_fn=lambda msg: print(f"  streaming={streaming}: {msg}",
                                                           flush=True))
            torch.cuda.synchronize()
        finally:
            DeviceSplit.from_windows = real
        del trainer._update
        runs[streaming] = {
            "history": results["history"], "put": put,
            "state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
            "seconds": results["train_wall_seconds"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "live_gib": (min(live) / 2**30, max(live) / 2**30),
            "launches": {name: k.launches for name, k in kernels.items() if k.launches}}
        if streaming == "false":  # the streamed run's memory is its own
            del trainer
            torch.cuda.empty_cache()
    resident, streamed = runs["false"], runs["true"]
    state_r, state_s = resident["state"], streamed["state"]
    weights = all(torch.equal(state_s[k], v) for k, v in state_r.items())
    history = streamed["history"] == resident["history"]
    whole = train_w.num_windows in streamed["put"]
    for name in ("false", "true"):
        run = runs[name]
        print(f"  streaming={name}: epoch {run['seconds']:.2f} s (train, val, checkpoint), peak "
              f"memory {run['peak_gib']:.3f} GiB, in use as a micro-step starts "
              f"{run['live_gib'][0]:.3f}-{run['live_gib'][1]:.3f} GiB, splits put on the card "
              f"whole {run['put']}, launches {run['launches']} on {smi}", flush=True)
    print(f"  streamed epoch against resident: history bit-identical {history}, every weight "
          f"bit-identical {weights} ({len(state_r)} tensors); train split ({train_w.num_windows} "
          f"windows) put on the card whole by the streamed run: {whole}", flush=True)
    if not (history and weights) or whole or streamed["launches"] != resident["launches"]:
        raise AssertionError("the streamed epoch is not the resident epoch bit for bit")

    # the host's share of a streamed step: BatchLoader's numpy batches alone,
    # then the same batches pinned and copied by the loader (the card fenced)
    for label, batches in (("BatchLoader (host numpy)", trainer.stream_batches(train_w, 1).loader),
                           ("StreamingDeviceLoader", trainer.stream_batches(train_w, 1))):
        t = time.perf_counter()
        n = sum(1 for _ in batches)
        torch.cuda.synchronize()
        print(f"  {label}: {(time.perf_counter() - t) / n * 1e3:.3f} ms a batch over one "
              f"epoch ({n} batches)", flush=True)
    step = trainer.make_stream_step_fn()
    batches = iter(trainer.stream_batches(train_w, 1))
    for _ in range(3):  # warm
        step(*next(batches))
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(STREAM_PROFILE_STEPS):
            step(*next(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    trace = workdir / "stream_trace.json"
    prof.export_chrome_trace(str(trace))
    copies = _copy_overlap(trace)
    print(f"  {STREAM_PROFILE_STEPS} streamed micro-steps in {wall * 1e3:.1f} ms: "
          f"{copies['copies']} host-to-device copies on stream(s) {copies['streams']}, "
          f"{copies['copy_ms'] / STREAM_PROFILE_STEPS:.4f} ms of copy per step, "
          f"{copies['overlap']:.3f} of it while a kernel runs on another stream", flush=True)
    if not copies["copies"]:
        raise AssertionError("the trace shows no host-to-device copy on a side stream")
    return {"epoch_s": {k: v["seconds"] for k, v in runs.items()},
            "peak_gib": {k: v["peak_gib"] for k, v in runs.items()}, **copies}


def _bf16_bound(flops, nbytes):
    """(ms, "operations" or "bytes") of a bf16 entry. ``flops`` counts its
    products by operand kind: (bf16 x bf16, f32 x bf16, f32 x f32), each at
    its own rate, against its bytes."""
    peaks = (PEAK_BF16_FLOPS, PEAK_2XTF32_FLOPS, PEAK_3XTF32_FLOPS)
    t_ops = sum(n / peak for n, peak in zip(flops, peaks)) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# each bf16 entry's design, for the kernels line
BF16_DESIGN = {
    "packed_attention_fwd_bf16": "wgmma m64n64k16 bf16 (wgmma_bf16.cuh): S = Q K^T from "
                                 "swizzled shared memory, P split into three bf16 register "
                                 "terms for P.V, two warpgroups a block",
    "packed_attention_bwd_bf16": "wgmma m64n64k16 bf16 (wgmma_attention_bwd.cuh): dout split "
                                 "into bf16 planes with delta (one plane for a bf16 cotangent), "
                                 "dk, dv on one warpgroup of 64 keys a block, P and dS in three "
                                 "bf16 register terms; dq a pass of its own, S and dP again, no "
                                 "partials in device memory",
    "proj_ln_fwd_bf16": "row 14's 3xTF32-template body, one TF32 pass",
    "proj_ln_bwd_bf16": "row 15's 3xTF32-template body, one TF32 pass",
    "ffw_ln_fwd_bf16": "two launches on wgmma m64n64k16 bf16 (wgmma_ffw.cuh): the hidden, then "
                       "y = hd W2 on 128 whole rows (row 13b's LN product, one body) with the "
                       "residual and the LayerNorm as its epilogue",
    "ffw_ln_bwd_bf16": "six launches on wgmma m64n64k16 bf16 (wgmma_ffw.cuh): the hidden, LN "
                       "backward, dpre, dx, split weight gradients, ordered sums",
    "fused_mlp_fwd_bf16": "two launches on wgmma m64n64k16 bf16 (wgmma_ffw.cuh): the hidden, "
                          "then out = hd W2 + b2 on 128 whole rows (row 12b's y product) in "
                          "16-byte stores",
    "fused_mlp_bwd_bf16": "row 13b's wgmma bodies (wgmma_ffw.cuh) without its LN product: the "
                          "hidden, dpre on dout, dx with no dr, split weight gradients, ordered "
                          "sums",
}


def _bf16_row(name, source, line, err, ms, plain_ms, f32_ms, library_ms, flops, nbytes, **extra):
    bound_ms, bound_by = _bf16_bound(flops, nbytes)
    row = {"name": name, "route": "cuda", "source": f"{PKG}/ops/csrc/{source}",
           "design": BF16_DESIGN[name], "replaces": f"{TPU_PKG}/ops/{line}",
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "f32_ms": f32_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
           "unit": "bf16 tensor-core products (one TF32 pass for two bf16 operands, two "
                   "for an f32 and a bf16 one, three for two f32 ones)",
           "gflop_by_operands": {"bf16 x bf16": flops[0] / 1e9, "f32 x bf16": flops[1] / 1e9,
                                 "f32 x f32": flops[2] / 1e9}, **extra}
    lib = "none" if library_ms is None else f"{library_ms:.4f}"
    print(f"  {name} ms={ms:.4f} plain_ms={plain_ms:.4f} f32 entry ms={f32_ms:.4f} "
          f"library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by}; GFLOP bf16 x bf16 "
          f"{flops[0] / 1e9:.2f}, f32 x bf16 {flops[1] / 1e9:.2f}, f32 x f32 "
          f"{flops[2] / 1e9:.2f}; {nbytes / 1e6:.1f} MB), share {100 * bound_ms / ms:.1f}%"
          + "".join(f" ({k}={v:.4f}, share {100 * v / ms:.1f}%)" for k, v in extra.items()
                    if k.startswith("bound_ms_")), flush=True)
    return row


def bf16_forward_parts(torch, row, hd, w2, b2):
    """Rows 10b and 12b, two launches each: their parts' device ms (the
    hidden, then the hd W2 product with its epilogue) from
    ``row["ms_by_kernel"]``; the product's own bound; and, a yardstick for
    the product part alone, cuBLAS's bf16 ``torch.addmm(b2, hd, W2)`` at the
    same shape, its sums in f32 (``pin_float32``: the card is resolved
    before [kernels]). No one call computes either whole function."""
    parts = row["ms_by_kernel"]
    hidden = [v for k, v in parts.items() if k.endswith("_hidden_wg_kernel")]
    product = [v for k, v in parts.items() if k.endswith("_fwd_wg_kernel")]
    if len(hidden) != 1 or len(product) != 1:
        raise AssertionError(f"{row['name']}: not one wgmma hidden and one wgmma product "
                             f"kernel: {parts}")
    (n, f), d = hd.shape, w2.shape[1]
    b2b = b2.to(torch.bfloat16)
    row["ms_hidden"], row["ms_product"] = hidden[0], product[0]
    row["product_addmm_ms"] = time_ms(lambda: torch.addmm(b2b, hd, w2), iters=10)
    row["product_bound_ms"] = _bf16_bound((2.0 * n * f * d, 0.0, 0.0),
                                          2.0 * (n * f + f * d + n * d))[0]
    print(f"  {row['name']} parts: hidden {hidden[0]:.4f} ms, hd W2 product "
          f"{product[0]:.4f} ms (bound {row['product_bound_ms']:.4f}, share "
          f"{100 * row['product_bound_ms'] / product[0]:.1f}%); cuBLAS bf16 torch.addmm(b2, hd, "
          f"W2) {row['product_addmm_ms']:.4f} ms (the product part's yardstick)", flush=True)


def ffw_ln_one_y(torch, mlp, n, d=256, f=2048, keep=0.8):
    """The FFW residual-LN forward and its backward normalise one y (one
    product body from one hidden kernel's hd), f32 and bf16 entries: with
    gamma 1, beta 0 and a cotangent whose column c holds a single 1 at row
    n_c, dgamma[c] is exactly the backward's xhat[n_c, c], and the
    forward's out[n_c, c] must equal it (the bf16 entry's rounded to bf16:
    the rounding hides a last bit of y there). Raises otherwise."""
    for dtype in (torch.float32, torch.bfloat16):
        w, (fmask, rmask) = _ln_case(torch, n, d, f, keep, seed=n + 61)
        args = (w(n, d).to(dtype), w(d, f, s=d**-0.5).to(dtype), w(f, s=0.1),
                w(f, d, s=f**-0.5).to(dtype), w(d, s=0.1), torch.ones(d, device="cuda"),
                torch.zeros(d, device="cuda"), fmask, rmask)
        cols = torch.arange(d, device="cuda")
        rows = (7 + 3 * cols) % n
        dout = torch.zeros(n, d, device="cuda", dtype=dtype)
        dout[rows, cols] = 1.0
        bf16 = dtype == torch.bfloat16
        fwd = mlp.ffw_ln_fwd_bf16 if bf16 else mlp.ffw_ln_fwd
        bwd = mlp.ffw_ln_bwd_bf16 if bf16 else mlp.ffw_ln_bwd
        inv_keep = mlp._inv_keep(keep)
        out = fwd(*args, inv_keep, 1e-6)
        dgamma = bwd(*args, dout, inv_keep, 1e-6)[5]
        torch.cuda.synchronize()
        off = (out[rows, cols] != dgamma.to(dtype)).sum().item()
        print(f"  ffw_ln {'bf16' if bf16 else 'f32'} N={n}: the forward's out at (n_c, c) and "
              f"the backward's dgamma (its xhat there), gamma 1, beta 0: {off} of {d} differ",
              flush=True)
        if off:
            raise AssertionError(f"ffw_ln {dtype}: the forward and the backward normalise "
                                 f"different y")


def _sdpa_backend(names) -> str:
    """The SDPA backend that ran, from its kernels' names."""
    text = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient")):
        if key in text:
            return backend
    return "math"


def sdpa_bwd_reading(torch, q, k, v, dout, mask, readings: int = 7):
    """SDPA's bf16 backward (``autograd.grad`` w.r.t. q, k, v) with ``mask``
    or none: the median of ``readings`` timings, all of them, the backend
    named by its kernels, and those kernels."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, attn_mask=mask)

    def grad():
        return torch.autograd.grad(out, leaves, dout, retain_graph=True)

    times = sorted(time_ms(grad) for _ in range(readings))
    kernels = list(kernel_times(torch, grad, 3))
    return times[len(times) // 2], times, _sdpa_backend(kernels), kernels


def f64_witness(torch, attn, x, lens, out, lse, dout, heads, scale, got, f_sums):
    """The step floor's witness: the most bf16 steps that the f32 entry's
    sums and the bf16 entry's dqkv lie from the f64 backward on the same
    inputs, at each entry's own magnitude on the rows with one valid key
    (their dq and dk cancel: dS is rounding noise) and on the other rows,
    and under the floor over the call (max steps, share off); printed and
    returned."""
    f64 = attn.packed_attention_bwd_reference(x, lens, out, lse, dout, heads, scale,
                                              dtype=torch.float64)
    one = (lens == 1).cpu()
    res = {}
    for label, t in (("f32 entry", f_sums.to(torch.bfloat16)), ("bf16 entry", got)):
        own = attn.bf16_steps_from(t, f64, floor=0.0).cpu()
        floored = attn.bf16_steps_from(t, f64)
        # steps from an exact zero are infinite: "inf" in the kernels line
        res[label] = {k: (v if math.isfinite(v) else "inf") for k, v in (
            ("own_steps_one_key_rows", own[one].max().item()),
            ("own_steps_other_rows", own[~one].max().item()),
            ("floored_steps", floored.max().item()),
            ("floored_share_off", (floored >= 0.5).float().mean().item()))}
    print("  f64 witness (bf16 steps from the f64 backward; at the entry's own magnitude on "
          "the one-key rows | the other rows; under the floor: max, share off): " + "; ".join(
              f"{k} {v['own_steps_one_key_rows']} | {v['own_steps_other_rows']}; "
              f"{v['floored_steps']}, {v['floored_share_off']}" for k, v in res.items()),
          flush=True)
    return res


def check_bf16_attention(torch, attn, serve_lengths, train_lengths):
    """The packed pair's bf16 entries against their twins and against the f32
    entries on f32 copies of the same inputs (one function: the forward
    within f32's limits, the backward's dqkv within one bf16 step of the f32
    entry's in all but BWD_GATE_SHARE of the entries); returns two rows."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(19)
    heads, hd, seq = 4, 64, 512

    def qkv_of(batch, t_len, d):
        return torch.randn(batch, t_len, 3 * heads * d, generator=g).to(bf).cuda()

    serve_qkv = qkv_of(BATCH, seq, hd)
    cases = [("serve lengths", serve_qkv, serve_lengths, True)]
    edge = torch.tensor([0, 1, 37, 64, 65, 511, seq, 8], dtype=torch.int32).cuda()
    cases.append(("edge lengths", qkv_of(8, seq, hd), edge, True))
    # an f32 cotangent: all three of its bf16 planes
    cases.append(("edge lengths, f32 cotangent", qkv_of(8, seq, hd), edge, False))
    for d in (16, 32, 128):  # every head dim, padded T = 72 on the tile edges
        cases.append((f"d={d} T=72", qkv_of(7, 72, d),
                      torch.tensor([0, 1, 37, 64, 65, 71, 72], dtype=torch.int32).cuda(), True))
    err_f, err_b, err_f32, gate, err_sums = 0.0, 0.0, 0.0, [0.0, 0.0], 0.0
    witness = {}
    for name, x, lens, bf16_cotangent in cases:
        d = x.shape[-1] // (3 * heads)
        scale = d**-0.5
        out, lse = attn.packed_attention_fwd_bf16(x, lens, heads, scale)
        ref_out, ref_lse = attn.packed_attention_bf16_reference(x, lens, heads, scale)
        f_out, f_lse = attn.packed_attention_fwd(x.float(), lens, heads, scale)
        torch.cuda.synchronize()
        valid = ref_lse > attn.NEG_INF / 2
        e = max((out - ref_out).abs().max().item(), (lse[valid] - ref_lse[valid]).abs().max().item())
        e_f32 = max((out - f_out).abs().max().item(), (lse - f_lse).abs().max().item())
        dout = torch.randn(out.shape, generator=g)
        dout = (dout.to(bf).float() if bf16_cotangent else dout).cuda()
        got = attn.packed_attention_bwd_bf16(x, lens, ref_out, ref_lse, dout, heads, scale)
        want = attn.packed_attention_bwd_bf16_reference(x, lens, ref_out, ref_lse, dout, heads,
                                                        scale)
        f_sums = attn.packed_attention_bwd(x.float(), lens, ref_out, ref_lse, dout, heads,
                                           scale)
        sums = attn.packed_attention_bwd_bf16_sums(x, lens, ref_out, ref_lse, dout, heads, scale)
        torch.cuda.synchronize()
        e_b = rel_err(got.float(), want.float())
        e_bf32 = rel_err(got.float(), f_sums)
        steps_all = attn.bf16_steps_from(got, f_sums)
        steps, share = steps_all.max().item(), (steps_all >= 0.5).float().mean().item()
        if name.startswith("edge lengths"):
            witness[name] = f64_witness(torch, attn, x, lens, ref_out, ref_lse, dout, heads,
                                        scale, got, f_sums)
        e_sums = rel_err(sums, f_sums)
        if not torch.equal(sums.to(bf), got):
            raise AssertionError("packed_attention_bwd_bf16: its rounded sums are not its output")
        print(f"  packed_attention bf16 {name}: fwd max_abs_err {e:.3e} vs twin, {e_f32:.3e} "
              f"vs the f32 entry on f32 copies (tol {ATTN_TOL}); bwd rel err {e_b:.3e} vs "
              f"twin, {e_bf32:.3e} vs the f32 entry (tol {BF16_TOL}); vs the f32 entry's sums "
              f"rounded: {steps:.3g} bf16 steps at most, {share:.3e} of the entries off (gate 1 "
              f"step, {BWD_GATE_SHARE}); its f32 sums before rounding: rel err {e_sums:.3e}",
              flush=True)
        err_f, err_f32, err_b = max(err_f, e), max(err_f32, e_f32), max(err_b, e_b, e_bf32)
        gate, err_sums = [max(gate[0], steps), max(gate[1], share)], max(err_sums, e_sums)
    if max(err_f, err_f32) > ATTN_TOL or err_b > BF16_TOL:
        raise AssertionError(f"packed attention bf16 entries: {err_f}, {err_f32} > {ATTN_TOL} "
                             f"or {err_b} > {BF16_TOL}")
    if gate[0] > 1 or gate[1] > BWD_GATE_SHARE:
        raise AssertionError(f"packed_attention_bwd_bf16 vs the f32 entry: {gate[0]} bf16 steps, "
                             f"{gate[1]} of the entries off (gate 1, {BWD_GATE_SHARE})")
    print(f"  packed_attention bf16 forward (wgmma, P in three bf16 terms) vs the f32 entry on "
          f"f32 copies: max_abs_err {err_f32:.3e} (tol {ATTN_TOL}); backward (wgmma, three bf16 "
          f"terms an f32 operand) vs the f32 entry: {gate[0]:.3g} bf16 steps at most, "
          f"{gate[1]:.3e} of the entries off at most (gate 1, {BWD_GATE_SHARE}); its f32 sums "
          f"before rounding within {err_sums:.3e}", flush=True)
    # twice on one input, bit for bit
    x, lens = serve_qkv, serve_lengths
    a, b = (attn.packed_attention_fwd_bf16(x, lens, heads, hd**-0.5) for _ in range(2))
    tq = qkv_of(len(train_lengths), seq, hd)
    t_out, t_lse = attn.packed_attention_bf16_reference(tq, train_lengths, heads, hd**-0.5)
    t_dout = torch.randn(t_out.shape, generator=g).to(bf).float().cuda()
    c, d_ = (attn.packed_attention_bwd_bf16(tq, train_lengths, t_out, t_lse, t_dout, heads,
                                            hd**-0.5) for _ in range(2))
    torch.cuda.synchronize()
    if not (torch.equal(a[0], b[0]) and torch.equal(c, d_)):
        raise AssertionError("packed attention bf16 entries: two runs differ")
    print(f"  packed_attention bf16 entries: two runs of each equal bit for bit; digests fwd "
          f"{_digest([a[0], a[1]])} bwd {_digest([c])}", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for kind, x, lens in (("fwd", serve_qkv, serve_lengths), ("bwd", tq, train_lengths)):
        batch = x.shape[0]
        scale = hd**-0.5
        view = x.view(batch, seq, 3, heads, hd)
        q, k, v = (view[:, :, i].transpose(1, 2) for i in range(3))
        key_mask = (torch.arange(seq, device="cuda")[None, :] < lens[:, None].long())[
            :, None, None, :]
        keys = float(lens.clamp(0, seq).sum().item())
        # one product over the valid keys. Forward: Q.K^T bf16 x bf16, and P.V
        # as the two bf16 x bf16 terms of P that meet f32's 1e-5 limit (the
        # kernel runs three); bound_ms_2xtf32_pv counts P.V as f32 x bf16, the
        # old body's two TF32 passes. Backward: K.Q^T bf16 x bf16; V.dO^T, dS.K
        # and dS^T.Q f32 x bf16; P^T.dO f32 x f32 (dO is the f32 cotangent)
        unit = 2.0 * heads * hd * seq * keys
        xf = x.float()
        if kind == "fwd":
            ms = time_ms(lambda: attn.packed_attention_fwd_bf16(x, lens, heads, scale))
            plain_ms = time_ms(lambda: attn.packed_attention_bf16_reference(x, lens, heads, scale))
            f32_ms = time_ms(lambda: attn.packed_attention_fwd(xf, lens, heads, scale))
            library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=key_mask))
            nbytes = 2.0 * x.numel() + 4.0 * (batch * seq * heads * hd + batch * seq * heads
                                              + batch)
            rows.append(_bf16_row("packed_attention_fwd_bf16", "packed_attention.cu",
                                  "pallas_attention.py:793", err_f, ms, plain_ms, f32_ms,
                                  library_ms, (3 * unit, 0.0, 0.0), nbytes, body=f"{PKG}/ops/"
                                  "csrc/wgmma_bf16.cuh", max_abs_err_vs_f32=err_f32,
                                  bound_ms_2xtf32_pv=_bf16_bound((unit, unit, 0.0), nbytes)[0]))
        else:
            ms = time_ms(lambda: attn.packed_attention_bwd_bf16(x, lens, t_out, t_lse, t_dout,
                                                                heads, scale))
            plain_ms = time_ms(lambda: attn.packed_attention_bwd_bf16_reference(
                x, lens, t_out, t_lse, t_dout, heads, scale))
            f32_ms = time_ms(lambda: attn.packed_attention_bwd(xf, lens, t_out, t_lse, t_dout,
                                                               heads, scale))
            do = t_dout.to(bf).view(batch, seq, heads, hd).transpose(1, 2)
            library_ms, readings, backend, names = sdpa_bwd_reading(torch, q, k, v, do, key_mask)
            # every key valid: 2b, and SDPA with no mask
            full = torch.full_like(lens, seq)
            f_out, f_lse = attn.packed_attention_bf16_reference(x, full, heads, scale)
            ms_full = time_ms(lambda: attn.packed_attention_bwd_bf16(x, full, f_out, f_lse,
                                                                     t_dout, heads, scale))
            full_ms, full_readings, full_backend, full_names = sdpa_bwd_reading(
                torch, q, k, v, do, None)
            print(f"  SDPA bf16 backward with the key mask: median {library_ms:.4f} ms of "
                  f"{', '.join(f'{t:.4f}' for t in readings)} on the {backend} backend "
                  f"({', '.join(n[:40] for n in names[:3])}); every key valid, no mask: "
                  f"{full_ms:.4f} ms ({', '.join(f'{t:.4f}' for t in full_readings)}) on "
                  f"{full_backend} ({', '.join(n[:40] for n in full_names[:3])}), 2b there "
                  f"{ms_full:.4f} ms", flush=True)
            # the bf16 products a tile pair that the function needs: S once,
            # dP over dout's planes, P^T dO over the term pairs, dS^T Q and
            # dS K over three terms each (11 with a bf16 cotangent, one
            # plane; 16 with an f32 one); the design's dq pass computes S
            # and dP again (13, 20), bound_ms_design
            planes = 1 if torch.equal(t_dout, t_dout.to(bf).float()) else 3
            products = 1 + planes + (3 if planes == 1 else 6) + 3 + 3
            design_products = products + 1 + planes
            # each input read once, dqkv written once
            nbytes = 2.0 * 2 * x.numel() + 4.0 * (2 * t_out.numel() + t_lse.numel() + batch)
            # + dout's planes written once and read by both passes, delta likewise
            design_bytes = nbytes + 3 * (2.0 * planes * t_out.numel() + 4.0 * t_lse.numel())
            row = _bf16_row("packed_attention_bwd_bf16", "packed_attention_bwd.cu",
                            "pallas_attention.py:845", err_b, ms, plain_ms, f32_ms, library_ms,
                            (products * unit, 0.0, 0.0), nbytes,
                            body=f"{PKG}/ops/csrc/wgmma_attention_bwd.cuh",
                            products_a_tile_pair=products,
                            design_products_a_tile_pair=design_products, dout_planes=planes,
                            bf16_steps_vs_f32=gate[0], share_off_f32=gate[1],
                            f64_witness=witness,
                            sums_rel_err_vs_f32=err_sums,
                            bound_ms_design=_bf16_bound((design_products * unit, 0.0, 0.0),
                                                        design_bytes)[0],
                            bound_ms_tf32_passes=_bf16_bound((unit, 3 * unit, unit), nbytes)[0],
                            library_backend=backend, library_ms_readings=readings,
                            ms_every_key_valid=ms_full, library_ms_every_key_valid=full_ms,
                            library_backend_every_key_valid=full_backend)
            row["ms_by_kernel"] = kernel_times(torch, lambda: attn.packed_attention_bwd_bf16(
                x, lens, t_out, t_lse, t_dout, heads, scale), 5)
            print("  packed_attention_bwd_bf16 by kernel: " + ", ".join(
                f"{k_} {v_:.4f} ms" for k_, v_ in row["ms_by_kernel"].items()), flush=True)
            from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build

            row["hgmma"] = hgmma_counts(_build, "packed_attention_bwd",
                                        ("bwd_dkv_wg_kernel", "bwd_dq_wg_kernel"))
            print("  HGMMA in the SASS of packed_attention_bwd.cu's wgmma kernels: " + ", ".join(
                f"{k_} {v_}" for k_, v_ in row["hgmma"].items()), flush=True)
            rows.append(row)
    return rows


def check_bf16_ln(torch, mlp, rows_n):
    """Both residual-LN pairs' bf16 entries against their twins (the FFW
    backward on the forward kernel's ReLU branches, as in f32), twice bit for
    bit, timed beside the f32 entries on f32 copies; returns four rows."""
    bf = torch.bfloat16
    d, f = 256, 2048
    out_rows = {}
    for family, line_f, line_b in (("proj_ln", 921, 945), ("ffw_ln", 573, 611)):
        errs = [0.0, 0.0]
        timed = None
        for n, keep in ((rows_n, 0.8), (rows_n, None), (rows_n, 0.0), (rows_n - 25, 0.8)):
            w, (fmask, rmask) = _ln_case(torch, n, d, f, keep, seed=n + int(10 * (keep or 1)) + 3)
            x = w(n, d).to(bf)
            if family == "proj_ln":
                args = (x, w(n, d).to(bf), w(d, d, s=d**-0.5).to(bf), w(d, s=0.1),
                        1 + w(d, s=0.1), w(d, s=0.1), rmask)
            else:
                args = (x, w(d, f, s=d**-0.5).to(bf), w(f, s=0.1), w(f, d, s=f**-0.5).to(bf),
                        w(d, s=0.1), 1 + w(d, s=0.1), w(d, s=0.1), fmask, rmask)
            inv_keep = mlp._inv_keep(1.0 if keep is None else keep)
            dout = w(n, d).to(bf)
            fwd = getattr(mlp, f"{family}_fwd_bf16")
            out = fwd(*args, inv_keep, 1e-6)
            torch.cuda.synchronize()
            e_fwd = rel_err(out.float(), getattr(mlp, f"{family}_fwd_bf16_reference")(
                *args, inv_keep, 1e-6).float())
            if family == "ffw_ln":
                _o, fwd_hd = mlp._ffw_ln_fwd_launch(*args, inv_keep, 1e-6)
                grads, bwd_hd = mlp._ffw_ln_bwd_launch(*args, dout, inv_keep, 1e-6)
                torch.cuda.synchronize()
                if not torch.equal(fwd_hd, bwd_hd):
                    raise AssertionError("ffw_ln bf16: the forward's hidden and the backward's "
                                         "differ")
                xf, w1f = x.float(), args[1].float()
                pre, live, flips = _forward_branches(torch, "ffw_ln bf16", xf, w1f, args[2],
                                                     fmask, inv_keep, bwd_hd.float())
                want = mlp._ffw_ln_bwd_bf16_plain(xf, w1f, pre, live, args[3].float(), args[4],
                                                  args[5], fmask, rmask, dout.float(), inv_keep,
                                                  1e-6)
                own = max(rel_err(a.float(), b.float()) for a, b in zip(
                    grads, mlp.ffw_ln_bwd_bf16_reference(*args, dout, inv_keep, 1e-6)))
                note = (f" (forward's hidden = backward's bit for bit; {flips} ReLU branches off "
                        f"the twin's, within rounding of zero; on the twin's own {own:.3e})")
            else:
                grads = mlp.proj_ln_bwd_bf16(*args, dout, inv_keep, 1e-6)
                want = mlp.proj_ln_bwd_bf16_reference(*args, dout, inv_keep, 1e-6)
                note = ""
            torch.cuda.synchronize()
            e_bwd = max(rel_err(a.float(), b.float()) for a, b in zip(grads, want))
            print(f"  {family} bf16 N={n} keep={keep}: rel err fwd={e_fwd:.3e} bwd={e_bwd:.3e} "
                  f"(tol {BF16_TOL}){note}", flush=True)
            errs = [max(errs[0], e_fwd), max(errs[1], e_bwd)]
            if timed is None:
                timed = (args, dout, inv_keep)
        if max(errs) > BF16_TOL:
            raise AssertionError(f"{family} bf16 entries disagree with their twins: {errs}")
        args, dout, inv_keep = timed
        fwd, bwd = getattr(mlp, f"{family}_fwd_bf16"), getattr(mlp, f"{family}_bwd_bf16")
        first, second = bwd(*args, dout, inv_keep, 1e-6), bwd(*args, dout, inv_keep, 1e-6)
        out, again = fwd(*args, inv_keep, 1e-6), fwd(*args, inv_keep, 1e-6)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(first, second)) and torch.equal(out, again)):
            raise AssertionError(f"{family} bf16 entries: two runs on the same inputs differ")
        print(f"  {family}_fwd_bf16 and {family}_bwd_bf16 N={rows_n} keep=0.8: two runs of each "
              f"equal bit for bit; digests fwd {_digest([out])} bwd {_digest(first)}", flush=True)
        del first, second, out, again
        f32_args = tuple(a.float() if a is not None and a.dtype == bf else a for a in args)
        n = rows_n
        if family == "proj_ln":  # x, a, out | x, a, dout, dx, da: bf16; masks u8; weights
            work, ops, acts = d * d, (2, 6), (3, 5)
            wbytes, masks = 2.0 * d * d + 4.0 * 3 * d, n * d
        else:  # x, out | x, dout, dx
            work, ops, acts = d * f, (4, 12), (2, 3)
            wbytes, masks = 2.0 * 2 * d * f + 4.0 * (f + 3 * d), n * (d + f)
        for kind, line in (("fwd", line_f), ("bwd", line_b)):
            name = f"{family}_{kind}_bf16"
            if kind == "fwd":
                call = lambda: fwd(*args, inv_keep, 1e-6)  # noqa: E731
                call_ref = lambda: getattr(mlp, f"{family}_fwd_bf16_reference")(  # noqa: E731
                    *args, inv_keep, 1e-6)
                call_f32 = lambda: getattr(mlp, f"{family}_fwd")(  # noqa: E731
                    *f32_args, inv_keep, 1e-6)
            else:
                call = lambda: bwd(*args, dout, inv_keep, 1e-6)  # noqa: E731
                call_ref = lambda: getattr(mlp, f"{family}_bwd_bf16_reference")(  # noqa: E731
                    *args, dout, inv_keep, 1e-6)
                call_f32 = lambda: getattr(mlp, f"{family}_bwd")(  # noqa: E731
                    *f32_args, dout.float(), inv_keep, 1e-6)
            k = 0 if kind == "fwd" else 1
            nbytes = 2.0 * acts[k] * n * d + wbytes * (1 + k) + masks
            extra = {}
            if name == "proj_ln_fwd_bf16":  # short: each call alone, L2-warm and L2-cold
                warm_cold(torch, extra, call, name)
                ms = extra.pop("ms")
            else:
                ms = time_ms(call, iters=10)
            out_rows[name] = _bf16_row(
                name, f"{family}.cu", f"pallas_mlp.py:{line}", errs[k], ms,
                time_ms(call_ref, iters=10), time_ms(call_f32, iters=10), None,
                (ops[k] * n * work, 0.0, 0.0), nbytes, **extra)
            out_rows[name]["ms_by_kernel"] = kernel_times(torch, call, 5)
            print(f"  {name} by kernel: " + ", ".join(
                f"{k_} {v:.4f} ms" for k_, v in out_rows[name]["ms_by_kernel"].items()),
                flush=True)
            if name == "ffw_ln_fwd_bf16":
                hd = mlp._ffw_ln_fwd_launch(*args, inv_keep, 1e-6)[1]
                bf16_forward_parts(torch, out_rows[name], hd, args[3], args[4])
                del hd
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build

    out_rows["ffw_ln_fwd_bf16"]["hgmma"] = hgmma_counts(_build, "ffw_ln", ("_wg_kernel",))
    print("  HGMMA in the SASS of ffw_ln.cu's wgmma kernels: " + ", ".join(
        f"{k_} {v}" for k_, v in out_rows["ffw_ln_fwd_bf16"]["hgmma"].items()), flush=True)
    ffw_ln_one_y(torch, mlp, rows_n)
    return [out_rows[k] for k in BF16_KERNELS[2:6]]


def check_bf16_fused_mlp(torch, mlp, rows_n):
    """Rows 10b-11b: the feed-forward pair's bf16 entries against their twins
    (the backward on the forward kernel's ReLU branches), the forward's
    hidden the backward's, twice bit for bit, timed beside the twin and the
    f32 entries on f32 copies; returns two rows."""
    bf = torch.bfloat16
    d, f = 256, 2048
    errs = [0.0, 0.0]
    timed = None
    for n, keep in ((rows_n, 0.8), (rows_n, None), (rows_n, 0.0), (rows_n - 25, 0.8)):
        w, (mask, _rmask) = _ln_case(torch, n, d, f, keep, seed=n + int(10 * (keep or 1)) + 11)
        args = (w(n, d).to(bf), w(d, f, s=d**-0.5).to(bf), w(f, s=0.1),
                w(f, d, s=f**-0.5).to(bf), w(d, s=0.1), mask)
        x, w1, b1, w2, b2, _m = args
        inv_keep = mlp._inv_keep(1.0 if keep is None else keep)
        dout = w(n, d).to(bf)
        out, fwd_hd = mlp._fused_mlp_fwd_launch(*args, inv_keep)
        grads, bwd_hd = mlp._fused_mlp_bwd_launch(x, w1, b1, w2, mask, dout, inv_keep)
        torch.cuda.synchronize()
        if not torch.equal(fwd_hd, bwd_hd):
            raise AssertionError("fused_mlp bf16: the forward's hidden and the backward's differ")
        e_fwd = rel_err(out.float(), mlp.fused_mlp_fwd_bf16_reference(*args, inv_keep).float())
        if keep == 0.0 and not torch.equal(out.float(), b2.to(bf).float().expand_as(out)):
            raise AssertionError("fused_mlp bf16: keep 0 does not give an exactly zero hidden")
        xf, w1f = x.float(), w1.float()
        pre, live, flips = _forward_branches(torch, "fused_mlp bf16", xf, w1f, b1, mask,
                                             inv_keep, bwd_hd.float())
        want = mlp._fused_mlp_bwd_bf16_plain(xf, w1f, pre, live, w2.float(), mask, dout.float(),
                                             inv_keep)
        e_bwd = max(rel_err(a.float(), b.float()) for a, b in zip(grads, want))
        own = max(rel_err(a.float(), b.float()) for a, b in zip(
            grads, mlp.fused_mlp_bwd_bf16_reference(x, w1, b1, w2, mask, dout, inv_keep)))
        print(f"  fused_mlp bf16 N={n} keep={keep}: rel err fwd={e_fwd:.3e} bwd={e_bwd:.3e} "
              f"(tol {BF16_TOL}) (forward's hidden = backward's bit for bit; {flips} ReLU "
              f"branches off the twin's, within rounding of zero; on the twin's own {own:.3e})",
              flush=True)
        errs = [max(errs[0], e_fwd), max(errs[1], e_bwd)]
        if timed is None:
            timed = (args, dout, inv_keep)
        del out, fwd_hd, grads, bwd_hd, pre, live, want
    if max(errs) > BF16_TOL:
        raise AssertionError(f"fused_mlp bf16 entries disagree with their twins: {errs}")
    args, dout, inv_keep = timed
    x, w1, b1, w2, b2, mask = args
    fwd, bwd = mlp.fused_mlp_fwd_bf16, mlp.fused_mlp_bwd_bf16
    first, second = bwd(x, w1, b1, w2, mask, dout, inv_keep), bwd(x, w1, b1, w2, mask, dout,
                                                                  inv_keep)
    out, again = fwd(*args, inv_keep), fwd(*args, inv_keep)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(first, second)) and torch.equal(out, again)):
        raise AssertionError("fused_mlp bf16 entries: two runs on the same inputs differ")
    print(f"  fused_mlp_fwd_bf16 and fused_mlp_bwd_bf16 N={rows_n} keep=0.8: two runs of each "
          f"equal bit for bit; digests fwd {_digest([out])} bwd {_digest(first)}", flush=True)
    del first, second, out, again
    f32_args = tuple(a.float() if a is not None and a.dtype == bf else a for a in args)
    n = rows_n
    wbytes = 2.0 * 2 * d * f + 4.0 * (f + d)  # bf16 W1, W2; f32 b1, b2
    calls = {  # kernel, twin, f32 entry, line, operations, bytes
        "fwd": (lambda: fwd(*args, inv_keep),
                lambda: mlp.fused_mlp_fwd_bf16_reference(*args, inv_keep),
                lambda: mlp.fused_mlp_fwd(*f32_args, inv_keep),
                341, 4.0 * n * d * f, 2.0 * 2 * n * d + wbytes + n * f),  # x, out | mask
        "bwd": (lambda: bwd(x, w1, b1, w2, mask, dout, inv_keep),
                lambda: mlp.fused_mlp_bwd_bf16_reference(x, w1, b1, w2, mask, dout, inv_keep),
                lambda: mlp.fused_mlp_bwd(f32_args[0], f32_args[1], b1, f32_args[3], mask,
                                          dout.float(), inv_keep),
                402, 10.0 * n * d * f, 2.0 * 3 * n * d + 2 * wbytes + n * f),  # x, dout, dx
    }
    out_rows = []
    for kind, (call, call_ref, call_f32, line, flops, nbytes) in calls.items():
        name = f"fused_mlp_{kind}_bf16"
        row = _bf16_row(name, "ffw.cu", f"pallas_mlp.py:{line}", errs[0 if kind == "fwd" else 1],
                        time_ms(call, iters=10), time_ms(call_ref, iters=10),
                        time_ms(call_f32, iters=10), None, (flops, 0.0, 0.0), nbytes,
                        kernel=f"{TPU_PKG}/ops/pallas_mlp.py:{195 if kind == 'fwd' else 232}")
        row["ms_by_kernel"] = kernel_times(torch, call, 5)
        print(f"  {name} by kernel: " + ", ".join(
            f"{k_} {v:.4f} ms" for k_, v in row["ms_by_kernel"].items()), flush=True)
        if kind == "fwd":
            bf16_forward_parts(torch, row, mlp._fused_mlp_fwd_launch(*args, inv_keep)[1], w2, b2)
        out_rows.append(row)
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build

    out_rows[1]["hgmma"] = hgmma_counts(_build, "ffw", ("_wg_kernel",))
    print("  HGMMA in the SASS of ffw.cu's wgmma kernels: " + ", ".join(
        f"{k_} {v}" for k_, v in out_rows[1]["hgmma"].items()), flush=True)
    return out_rows


def bf16_step_vs_cpu(torch, split, idx0):
    """One micro-step of the bf16 model at dropout 0 on BF16_CPU_ROWS real
    windows: the card's kernels against the same weights on the CPU (the
    twins), loss and every gradient, beside the CPU's f32 model: bf16's own
    effect, the control that the whole-gradient gate, a share of it, must
    refuse."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops.metrics import (
        cross_entropy_loss,
    )

    cfg = load_cfg(["mixed_precision=true", "model.dropout=0"])
    card = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    cpu = MultimodalFusionModel.from_config(cfg, device="cpu")
    cpu32 = MultimodalFusionModel.from_config(load_cfg(["model.dropout=0"]), device="cpu")
    cpu.load_state_dict(state)
    cpu32.load_state_dict(state)
    feats, labels, lengths = split.gather(idx0[:BF16_CPU_ROWS])
    smoothing = float(cfg.training.get("label_smoothing", 0.0) or 0.0)
    results = []
    for model, dev in ((card, "cuda"), (cpu, "cpu"), (cpu32, "cpu")):
        logits = model({m: x.to(dev) for m, x in feats.items()}, None, lengths.to(dev),
                       train=True, generator=torch.Generator(device=dev).manual_seed(0))
        loss = cross_entropy_loss(logits, labels.to(dev), smoothing)
        loss.backward()
        results.append((loss.item(), torch.cat([p.grad.cpu().flatten()
                                                for p in model.parameters()])))
    torch.cuda.synchronize()
    (loss_k, grad_k), (loss_c, grad_c), (loss_32, grad_32) = results
    e_loss = abs(loss_k - loss_c) / abs(loss_c)
    names = [n for n, _ in card.named_parameters()]
    sizes = [p.numel() for p in card.parameters()]
    # each gradient's max abs error over its largest magnitude, floored at
    # 1e-2 of the model's largest gradient as the CPU tests against the JAX
    # package floor it in bf16: the key biases' gradients are zero up to
    # rounding, and bf16's rounding is 2^16 times f32's
    floor = 1e-2 * grad_c.abs().max().item()

    def readings(grad):
        whole = ((grad - grad_c).norm() / grad_c.norm()).item()
        leaves = {n: (a - b).abs().max().item() / max(b.abs().max().item(), floor)
                  for n, a, b in zip(names, grad.split(sizes), grad_c.split(sizes))}
        return whole, leaves

    (diff, leaves_k), (gap, leaves_32) = readings(grad_k), readings(grad_32)
    worst_k = max(leaves_k, key=leaves_k.get)
    worst_32 = max(leaves_32, key=leaves_32.get)
    limit_whole = BF16_CPU_GAP_SHARE * gap
    print(f"  bf16 micro-step at dropout 0 on {BF16_CPU_ROWS} windows, card kernels vs the CPU "
          f"(twins): loss {loss_k:.6f} vs {loss_c:.6f} (rel err {e_loss:.3e}, tol "
          f"{BF16_CPU_LOSS_TOL}; f32 {loss_32:.6f}); the whole gradient norm-wise {diff:.3e} "
          f"(tol {limit_whole:.3e}, {BF16_CPU_GAP_SHARE} of the f32 control's {gap:.3e}); worst "
          f"gradient {worst_k} max-abs rel {leaves_k[worst_k]:.3e} (tol {BF16_CPU_LEAF_TOL}; "
          f"the f32 control's worst {worst_32} {leaves_32[worst_32]:.3e})", flush=True)
    for n in sorted(leaves_k, key=leaves_k.get)[-3:]:
        print(f"    {n}: card {leaves_k[n]:.3e}, f32 control {leaves_32[n]:.3e}", flush=True)
    print(f"  the CPU's f32 model as a card that left out bf16's roundings: refused by the "
          f"whole-gradient gate {gap > limit_whole}", flush=True)
    if e_loss > BF16_CPU_LOSS_TOL or diff > limit_whole or leaves_k[worst_k] > BF16_CPU_LEAF_TOL:
        raise AssertionError("bf16 micro-step: the card disagrees with the CPU")
    if not gap > limit_whole:
        raise AssertionError("bf16 micro-step: the gate does not refuse the f32 control")


def bf16_phase(torch, kernels, split, batches, train_idx, smi, workdir: Path, f32_times):
    """config/base.yaml at mixed_precision=true (the bf16 entries of rows 1,
    2 and 12-15): served against the bf16 plain path (4 bf16 packed forwards
    and 1 head a request, no f32 attention entry), trained (one micro-step
    against the plain path and one against the CPU, 8 counted micro-steps,
    the same seed twice bit for bit); the same at ``fused_mlp_ln=false``
    (rows 10b-11b, 4 launches each a micro-step); the grouped transformer in
    bf16 served and trained against its plain path; fit for FIT_EPOCHS
    epochs, the checkpoint reloaded bit for bit and evaluated; every time
    beside the f32 path's of this run (``f32_times``). Returns the launches
    by path."""
    print("[bf16]", flush=True)
    overrides = ["mixed_precision=true"]
    idx64 = [torch.from_numpy(row).long() for row in batches]
    idx32 = [torch.from_numpy(row).long() for row in train_idx]
    per_step = len(split.modalities)
    out = {}
    out["serve"], model, p50 = serve_vs_plain(
        torch, kernels, overrides, split, idx64, "bf16", smi,
        {"packed_attention_fwd_bf16": per_step, "fused_hybrid_head": 1}, timed=20, bf16=True)
    served = serve_profile(torch, model, split, idx64, "bf16")
    print(f"  bf16 request: p50 {p50 * 1e3:.3f} ms, {served['device']:.4f} ms device time; f32 "
          f"in this run: p50 {f32_times['serve_p50'] * 1e3:.3f} ms, "
          f"{f32_times['serve_device']:.4f} ms on {smi}", flush=True)
    del model
    micro_step_vs_plain(torch, split, idx32[0], overrides, "bf16", bf16=True)
    bf16_step_vs_cpu(torch, split, idx32[0])
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(torch, overrides)
    step, losses, launches = counted_steps(torch, kernels, trainer, split, idx32, TRAIN_STEPS)
    want = {**dict.fromkeys(kernels, 0), "dropout_keep_mask": TRAIN_STEPS * per_step,
            **{f"{k}_bf16": TRAIN_STEPS * per_step for k in ENCODER_KERNELS
               if k != "dropout_keep_mask"}}
    print(f"  bf16: {TRAIN_STEPS} micro-steps, {trainer.optimizer.count} updates; losses "
          f"{[round(v, 5) for v in losses]}", flush=True)
    print(f"  launches: {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"bf16 training launch counts {launches} != {want}")
    out["train"] = launches
    _step2, losses2, _l2 = counted_steps(torch, kernels, _trainer(torch, overrides), split, idx32,
                                         TRAIN_STEPS)
    print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
    if losses2 != losses:
        raise AssertionError(f"bf16: the same seed gave other losses: {losses} then {losses2}")
    del _step2
    p50 = step_p50(torch, step, split, idx32, len(idx32[0]), "bf16", smi)
    device = profile_micro_steps(torch, step, split, idx32, 8)["device"]
    print(f"  bf16 micro-step: p50 {p50 * 1e3:.3f} ms, {device:.4f} ms device time; f32 in this "
          f"run: p50 {f32_times['train_p50'] * 1e3:.3f} ms, {f32_times['train_device']:.4f} ms "
          f"on {smi}", flush=True)
    del trainer, step
    torch.cuda.empty_cache()

    # the feed-forward pair's route (rows 10b-11b) in bf16
    pair = ["mixed_precision=true", "model.fused_mlp=true", "model.fused_mlp_ln=false"]
    micro_step_vs_plain(torch, split, idx32[0], pair, "bf16 fused_mlp pair", bf16=True)
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(torch, pair)
    step, losses, launches = counted_steps(torch, kernels, trainer, split, idx32, TRAIN_STEPS)
    want = {**dict.fromkeys(kernels, 0), "dropout_keep_mask": TRAIN_STEPS * per_step,
            **{k: TRAIN_STEPS * per_step for k in ("packed_attention_fwd_bf16",
                                                   "packed_attention_bwd_bf16", *BF16_PAIR)}}
    print(f"  bf16 fused_mlp pair: {TRAIN_STEPS} micro-steps; losses "
          f"{[round(v, 5) for v in losses]}", flush=True)
    print(f"  launches: {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"bf16 pair route launch counts {launches} != {want}")
    out["pair"] = launches
    _step2, losses2, _l2 = counted_steps(torch, kernels, _trainer(torch, pair), split, idx32,
                                         TRAIN_STEPS)
    print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
    if losses2 != losses:
        raise AssertionError(f"bf16 pair: the same seed gave other losses: {losses} then {losses2}")
    del _step2
    step_p50(torch, step, split, idx32, len(idx32[0]), "bf16 fused_mlp pair", smi)
    profile_micro_steps(torch, step, split, idx32, 8)
    del trainer, step
    torch.cuda.empty_cache()

    # the grouped transformer in bf16: flash kernels on f32 copies of bf16 q, k, v
    grouped = ["mixed_precision=true", "model.grouped_transformer=true"]
    out["grouped_serve"], model, p50 = serve_vs_plain(
        torch, kernels, grouped, split, idx64, "bf16 G512", smi,
        {"flash_fwd_single": 1, "fused_hybrid_head": 1}, bf16=True)
    if model.grouped_tf_encoder.dtype != torch.bfloat16:
        raise AssertionError("the grouped transformer does not run in bf16")
    del model
    micro_step_vs_plain(torch, split, idx32[0], grouped, "bf16 G512", bf16=True)
    trainer = _trainer(torch, grouped)
    _step, losses, launches = counted_steps(torch, kernels, trainer, split, idx32, TRAIN_STEPS)
    want = {**dict.fromkeys(kernels, 0),
            **{k: TRAIN_STEPS for k in ("flash_fwd_single", "flash_bwd_fused",
                                        "dropout_keep_mask")}}
    print(f"  bf16 G512: {TRAIN_STEPS} micro-steps; losses {[round(v, 5) for v in losses]}; "
          f"launches {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"bf16 G512 training launch counts {launches} != {want}")
    out["grouped_train"] = launches
    _step2, losses2, _l2 = counted_steps(torch, kernels, _trainer(torch, grouped), split, idx32,
                                         TRAIN_STEPS)
    print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
    if losses2 != losses:
        raise AssertionError(f"bf16 G512: the same seed gave other losses: {losses} then "
                             f"{losses2}")
    del trainer, _step, _step2
    torch.cuda.empty_cache()
    out["fit"], out["eval"] = fit_and_eval_phase(torch, kernels, smi, workdir, bf16=True)
    return out


MOE = ["model.moe_experts=4", "model.moe_top_k=2", "model.moe_capacity_factor=1.25"]
MOE_STEPS = 8
# a routing choice whose top-k margin is below this may flip between the
# kernel and the plain path: their attention outputs differ by f32 rounding
# (~1e-6), and so do the router's logits
MOE_FLIP_MARGIN = 1e-5
MOE_TOKEN_TOL = 1e-3  # an unflipped token's MoE output, kernel path against plain path


def _record_routes(model):
    """Wrap every MoE layer's ``route`` of ``model`` to keep its last
    ``(probs, expert, keep)``; returns the list they are appended to, in
    call order."""
    seen = []
    for module in model.modules():
        if module.__class__.__name__ == "MoEFeedForward":
            def route(tokens, valid, _route=module.route):
                out = _route(tokens, valid)
                seen.append((out[0].detach(), out[2], out[4]))
                return out
            module.route = route
    return seen


def routing_flips(torch, got, want, k):
    """(token, layer) pairs whose chosen experts or kept slots differ between
    two runs' recorded routes -> (count, the largest top-k margin among them
    in ``want``'s probabilities, a mask per layer of the unflipped tokens)."""
    flips, worst, same = 0, 0.0, []
    for (p_a, e_a, keep_a), (p_b, e_b, keep_b) in zip(got, want):
        differ = (e_a != e_b).any(-1) | (keep_a != keep_b).any(-1)
        top = torch.sort(p_b, -1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        if differ.any():
            flips += int(differ.sum())
            worst = max(worst, margin[differ].max().item())
            print(f"    routing flips: {int(differ.sum())} tokens, top-k margins "
                  f"{[f'{m:.2e}' for m in margin[differ][:8].tolist()]}", flush=True)
        same.append(~differ)
    return flips, worst, same


def moe_phase(torch, kernels, split, batches, train_idx, test, smi, workdir: Path):
    """model.moe_experts=4 (top 2, capacity factor 1.25) over base.yaml at
    full width: served token by token against the plain path (routing flips
    printed with their margins), trained (one micro-step against the plain
    path, 8 counted micro-steps, the same seed twice bit for bit), the
    micro-step's device time by family, one epoch of ``fit``, the checkpoint
    reloaded bit for bit and ``evaluate_checkpoint`` on it. Returns the
    launches by path."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import (
        dataset_kwargs, evaluate_checkpoint,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn

    print("[moe]", flush=True)
    out = {}
    per_step = len(split.modalities)
    idx64 = [torch.from_numpy(row).long() for row in batches]
    idx32 = [torch.from_numpy(row).long() for row in train_idx]
    cfg = load_cfg(MOE)
    model = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed)))
    plain = MultimodalFusionModel.from_config(load_cfg([*MOE, *PLAIN]), device="cuda")
    plain.load_state_dict(model.state_dict())
    moe = model.encoders[split.modalities[0]].layers[0].moe
    serve = make_serving_fn(model, device="cuda")
    feats, _labels, lengths = split.gather(idx64[0])
    short = lengths.clone()
    short[:3] = torch.tensor([0, 37, 1], dtype=torch.int32, device="cuda")
    routes_k, routes_p = _record_routes(model), _record_routes(plain)
    for fn in kernels.values():
        fn.launches = 0
    got = serve(feats, None, short)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = {**dict.fromkeys(kernels, 0), "packed_attention_fwd": per_step, "fused_hybrid_head": 1}
    print(f"  MoE512: {moe.num_experts} experts, top {moe.top_k}, capacity "
          f"{_moe_capacity(moe, BATCH * int(cfg.dataset.chunk_size))} of a batch-{BATCH} "
          f"request; launches of one request {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"MoE512: serving launch counts {launches} != {want}")
    out["serve"] = launches
    with torch.inference_mode():
        ref = plain(feats, None, short)
    torch.cuda.synchronize()
    if got.shape != (BATCH, model.num_classes) or not torch.isfinite(got).all():
        raise AssertionError(f"MoE512: bad logits {tuple(got.shape)}")
    flips, worst, same = routing_flips(torch, routes_k, routes_p, moe.top_k)
    # windows with no flipped token in any layer: their logits, kernel against plain
    rows = torch.stack([s.reshape(BATCH, -1).all(1) for s in same]).all(0)
    e_logits = (got[rows] - ref[rows]).abs().max().item() if rows.any() else 0.0
    print(f"  MoE512 served: {flips} routing flips (largest top-k margin among them "
          f"{worst:.3e}, tol {MOE_FLIP_MARGIN}); logits of the {int(rows.sum())} windows with no "
          f"flip max_abs_err {e_logits:.3e} (tol {LOGIT_TOL})", flush=True)
    if worst > MOE_FLIP_MARGIN or e_logits > LOGIT_TOL:
        raise AssertionError("MoE512: the kernel path's serving disagrees with the plain path")
    del routes_k[:], routes_p[:]
    # token by token: each layer's MoE output on the tokens routed alike
    outs = {}
    for name, m in (("kernel", model), ("plain", plain)):
        layer = m.encoders[split.modalities[0]].layers[0]
        hook = layer.moe.register_forward_hook(
            lambda _m, _i, o, name=name: outs.__setitem__(name, o[0].detach()))
        with torch.inference_mode():
            m(feats, None, short)
        hook.remove()
    _f, _w, same = routing_flips(torch, routes_k[:1], routes_p[:1], moe.top_k)
    e_tok = (outs["kernel"] - outs["plain"]).reshape(-1, outs["plain"].shape[-1])[
        same[0]].abs().max().item()
    print(f"  MoE512 first layer, token by token on the unflipped tokens: max_abs_err "
          f"{e_tok:.3e} (tol {MOE_TOKEN_TOL})", flush=True)
    if e_tok > MOE_TOKEN_TOL:
        raise AssertionError(f"MoE512: unflipped tokens' outputs differ by {e_tok}")
    del model, plain, serve, outs
    torch.cuda.empty_cache()

    # one micro-step against the plain path on the same masks, then the counted steps
    trainer = _trainer(torch, [*MOE, "training.dropout_rng=xla"])
    plain_tr = _trainer(torch, [*MOE, "training.dropout_rng=xla", *PLAIN],
                        weights=trainer.model.state_dict())
    routes = [_record_routes(trainer.model), _record_routes(plain_tr.model)]
    results = []
    for tr in (trainer, plain_tr):
        tr.generator.manual_seed(tr.seed + 1)
        feats, labels, lengths = split.gather(idx32[0])
        feats, lengths, mask = tr.augment(feats, lengths, len(split.modalities))
        results.append(tr.loss_and_grads(feats, labels, mask, lengths,
                                         torch.ones(labels.shape, device="cuda")))
    torch.cuda.synchronize()
    (loss_k, _a, grads_k), (loss_p, _b, grads_p) = results
    flips, worst, _same = routing_flips(torch, *routes, moe.top_k)
    e_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    floor = 1e-3 * max(g.abs().max().item() for g in grads_p)
    names = [n for n, _ in trainer.model.named_parameters()]
    e_grads = {n: (a - b).abs().max().item() / max(b.abs().max().item(), floor)
               for n, a, b in zip(names, grads_k, grads_p)}
    whole = (torch.cat([(a - b).flatten() for a, b in zip(grads_k, grads_p)]).norm()
             / torch.cat([b.flatten() for b in grads_p]).norm()).item()
    w_name = max(e_grads, key=e_grads.get)
    print(f"  MoE512: one micro-step kernel vs plain path: loss {loss_k.item():.6f} vs "
          f"{loss_p.item():.6f} (rel err {e_loss:.3e}), {flips} routing flips (largest margin "
          f"{worst:.3e}); the whole gradient norm-wise {whole:.3e} (tol {TRAIN_NORM_TOL}); worst "
          f"gradient {w_name} max-abs rel {e_grads[w_name]:.3e} (tol {TRAIN_TOL} without a flip)",
          flush=True)
    if e_loss > TRAIN_NORM_TOL or whole > TRAIN_NORM_TOL or worst > MOE_FLIP_MARGIN \
            or (not flips and e_grads[w_name] > TRAIN_TOL):
        raise AssertionError("MoE512: the kernel path's micro-step disagrees with the plain path")
    del trainer, plain_tr, results, grads_k, grads_p, routes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = _trainer(torch, MOE)
    step, losses, launches = counted_steps(torch, kernels, trainer, split, idx32, MOE_STEPS)
    want = {**dict.fromkeys(kernels, 0),
            **{k: MOE_STEPS * per_step for k in ("packed_attention_fwd", "packed_attention_bwd",
                                                 "proj_ln_fwd", "proj_ln_bwd",
                                                 "dropout_keep_mask")}}
    print(f"  MoE512: {MOE_STEPS} micro-steps, {trainer.optimizer.count} updates; losses (with "
          f"{trainer.moe_aux_weight} x the aux losses) {[round(v, 5) for v in losses]}",
          flush=True)
    print(f"  launches: {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"MoE512 training launch counts {launches} != {want}")
    out["train"] = launches
    _s2, losses2, _l2 = counted_steps(torch, kernels, _trainer(torch, MOE), split, idx32,
                                      MOE_STEPS)
    print(f"  same seed again: losses bit-identical: {losses2 == losses}", flush=True)
    if losses2 != losses:
        raise AssertionError(f"MoE512: the same seed gave other losses: {losses} then {losses2}")
    del _s2
    step_p50(torch, step, split, idx32, len(idx32[0]), "MoE512", smi, iters=10)
    profile_micro_steps(torch, step, split, idx32, 4)
    del trainer, step
    torch.cuda.empty_cache()

    # one epoch of fit, the checkpoint reloaded, and evaluate_checkpoint on it
    trainer = _trainer(torch, [
        *MOE, "training.max_epochs=1", f"dataset.data_dir={REPO / 'data' / 'pamap2'}",
        f"dataset.chunk_cache_dir={workdir / 'chunk_cache'}"])
    train_w, val_w, test_w = create_datasets(**dataset_kwargs(trainer.config))
    for fn in kernels.values():
        fn.launches = 0
    results = trainer.fit(train_w, val_w, test_w, save_dir=workdir / "moe_run",
                          log_fn=lambda msg: print(f"  {msg}", flush=True))
    torch.cuda.synchronize()
    out["fit"] = {name: fn.launches for name, fn in kernels.items()}
    wall = results["train_wall_seconds"]
    print(f"  MoE512 fit: 1 epoch in {wall:.2f} s, {train_w.num_windows / wall:.1f} train "
          f"windows/s on {smi}; test acc {results['test_acc']:.4f}; launches {out['fit']}",
          flush=True)
    if not _all_finite(results["history"]) or out["fit"]["packed_attention_bwd"] <= 0:
        raise AssertionError("MoE512 fit did not train through the kernels to finite losses")
    checkpoint_round_trip(torch, trainer, test, workdir, "MoE512")
    best = Path(results["best_model_path"])
    for fn in kernels.values():
        fn.launches = 0
    standard = evaluate_checkpoint(
        str(best), output_dir=str(workdir / "moe_eval"), analysis_dir=str(workdir / "moe_ana"),
        missing_modality_test=True, device="cuda", plots=False)
    torch.cuda.synchronize()
    out["eval"] = {name: fn.launches for name, fn in kernels.items()}
    files = {name: json.loads((workdir / "moe_eval" / f"{name}.json").read_text())
             for name in ("evaluation_results", "uncertainty", "missing_modality")}
    if not all(_all_finite(f) for f in files.values()) \
            or standard["test_accuracy"] != results["test_acc"] \
            or out["eval"]["dropout_keep_mask"] <= 0:
        raise AssertionError("MoE512: evaluate_checkpoint disagrees with fit or is not finite")
    print(f"  MoE512 evaluate_checkpoint: test acc {standard['test_accuracy']:.4f}, ECE "
          f"{standard['ece']:.4f}, MC-dropout mean variance "
          f"{files['uncertainty']['mc_dropout']['mean_uncertainty']:.6f}; launches {out['eval']}",
          flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def _moe_capacity(moe, tokens):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.moe import moe_capacity

    return moe_capacity(tokens, moe.num_experts, moe.top_k, moe.capacity_factor)


REMAT_STEPS = 4
REMAT_4096_ROWS = 4  # windows of the chunk-4096 micro-step held to the plain path


def remat_phase(torch, kernels, split, train_idx, modalities, stride, seed, smi):
    """training.remat at chunk 512: one micro-step's loss and every gradient,
    and REMAT_STEPS counted micro-steps' losses, bit for bit against the same
    steps without it, each forward kernel launched twice; peak memory of
    both. At chunk 4096 (batch 32, which no earlier phase trains): one
    micro-step with remat, its peak memory beside the run without it, and
    one on REMAT_4096_ROWS windows against the plain path. Returns the
    launches by path."""
    print("[remat]", flush=True)
    out = {}
    idx32 = [torch.from_numpy(row).long() for row in train_idx]
    per_step = len(modalities)
    runs = {}
    for remat in ("false", "true"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = _trainer(torch, [f"training.remat={remat}"])
        trainer.generator.manual_seed(trainer.seed + 1)
        feats, labels, lengths = split.gather(idx32[0])
        feats, lengths, mask = trainer.augment(feats, lengths, per_step)
        for fn in kernels.values():
            fn.launches = 0
        loss, _acc, grads = trainer.loss_and_grads(feats, labels, mask, lengths,
                                                   torch.ones(labels.shape, device="cuda"))
        torch.cuda.synchronize()
        one = {name: fn.launches for name, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        grads = [g.clone() for g in grads]
        del trainer
        _step, losses, launches = counted_steps(torch, kernels, _trainer(
            torch, [f"training.remat={remat}"]), split, idx32, REMAT_STEPS)
        runs[remat] = (loss, grads, one, peak, losses, launches)
        print(f"  chunk 512 remat={remat}: one micro-step's peak memory {peak / 2**30:.3f} GiB on "
              f"{smi}; launches {one}", flush=True)
        del _step
    (loss_a, grads_a, one_a, peak_a, losses_a, l_a), (loss_b, grads_b, one_b, peak_b, losses_b,
                                                       l_b) = runs["false"], runs["true"]
    same = torch.equal(loss_a, loss_b) and all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    doubled = {k: (2 * v if k.endswith("_fwd") or k == "dropout_keep_mask" else v)
               for k, v in one_a.items()}
    print(f"  chunk 512: remat's loss and {len(grads_a)} gradients bit-identical: {same}; "
          f"{REMAT_STEPS} micro-steps' losses bit-identical: {losses_a == losses_b}; forward "
          f"kernels launched twice: {one_b == doubled} (want {doubled}); peak memory "
          f"{peak_b / 2**30:.3f} GiB with remat, {peak_a / 2**30:.3f} without", flush=True)
    if not same or losses_a != losses_b or one_b != doubled \
            or l_b != {k: (2 * v if k.endswith("_fwd") or k == "dropout_keep_mask" else v)
                       for k, v in l_a.items()}:
        raise AssertionError("remat at chunk 512 is not the run without it bit for bit")
    out["train"] = l_b
    del runs, grads_a, grads_b
    torch.cuda.empty_cache()

    # chunk 4096, batch 32: the tiled flash forward and the split backward
    long = load_split(torch, modalities, 4096, stride)
    idx = index_batches(torch, long, 32, seed)
    route = ["dataset.chunk_size=4096"]
    peaks = {}
    for remat in ("false", "true"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = _trainer(torch, [*route, f"training.remat={remat}"])
        for fn in kernels.values():
            fn.launches = 0
        t = time.perf_counter()
        _s, losses, launches = counted_steps(torch, kernels, trainer, long, idx, 1)
        wall = time.perf_counter() - t
        peaks[remat] = torch.cuda.max_memory_allocated()
        print(f"  chunk 4096 batch 32 remat={remat}: one micro-step, loss {losses[0]:.5f}, "
              f"{wall * 1e3:.1f} ms with its first launches, peak memory "
              f"{peaks[remat] / 2**30:.3f} GiB on {smi}; launches {launches}", flush=True)
        out[f"train4096_remat_{remat}"] = launches
        del trainer, _s
    torch.cuda.empty_cache()
    small = [i[:REMAT_4096_ROWS] for i in idx]
    micro_step_vs_plain(torch, long, small[0], [*route, "training.remat=true"],
                        f"chunk 4096 remat, {REMAT_4096_ROWS} windows")
    del long
    torch.cuda.empty_cache()
    return out


# ---- [parallel]: the layouts on torch.distributed, 4 ranks on the one card ------------

PARALLEL_WORLD = 4
PARALLEL_JOIN = 900  # seconds a world of children may take before it is killed
PARALLEL_STEPS = 8  # micro-steps a leg: 2 updates at accumulation 4
PARALLEL_REPEAT_STEPS = 4  # micro-steps of each determinism run
PARALLEL_FIT_BATCHES = 4  # global batches of the [parallel] fit's cut train split
PARALLEL_FIT_WINDOWS = 64  # windows of its cut val and test splits
PARALLEL_NAMES = ("imu_hand", "imu_chest", "imu_ankle", "heart_rate")
PARALLEL_LEGS = {  # the reference's multichip dry run, leg by leg
    "a": ["parallel.dcn_slices=2", "parallel.zero_optimizer=true"],
    "b": ["parallel.model_parallel=2", "parallel.sequence_parallel=true",
          "parallel.zero_optimizer=true"],
    "c": ["parallel.model_parallel=2", "parallel.sequence_parallel=true",
          "parallel.zero_optimizer=true", "model.moe_experts=4", "model.moe_top_k=2"],
    # the pipeline needs num_layers divisible by its 2 stages: the leg's one cut
    "d": ["parallel.pipeline_parallel=2", "parallel.microbatches=2"]
    + [f"model.encoders.{m}.num_layers=2" for m in PARALLEL_NAMES],
}
# parity runs: no random draw (dropout and the augmentations off), so that a
# world and one process compute the same function on the same global batches
PARALLEL_QUIET = ["model.dropout=0.0", "training.augmentation.temporal_jitter=0.0",
                  "training.augmentation.gaussian_noise=0.0",
                  "training.augmentation.modality_dropout=0.0"]
# f32 on both sides; the world sums the batch in pieces and its collectives
# add in another order
PARALLEL_LOSS_TOL = 1e-5  # relative
PARALLEL_GRAD_TOL = 1e-5  # the whole gradient, norm-wise
PARALLEL_LEAF_TOL = 1e-4  # each leaf's max abs error over its largest, floored at 1e-3 of all
# the kernels a layout's micro-step launches (table row -> wrapper name)
PARALLEL_ROWS = ("packed_attention_fwd", "packed_attention_bwd", "fused_mlp_fwd", "fused_mlp_bwd",
                 "ffw_ln_fwd", "ffw_ln_bwd", "proj_ln_fwd", "proj_ln_bwd", "dropout_keep_mask",
                 "fused_hybrid_head")


def _parallel_want(leg: str) -> dict:
    """Launches per rank per parity micro-step (dropout 0: no mask launch).
    Legs (a)-(c): each of the 4 encoders' one layer; (d): each stage's one
    layer of each encoder once per microbatch (2)."""
    want = dict.fromkeys(PARALLEL_ROWS, 0)
    layer = ["packed_attention_fwd", "packed_attention_bwd", "proj_ln_fwd", "proj_ln_bwd"]
    if leg == "a":
        layer += ["ffw_ln_fwd", "ffw_ln_bwd"]
    if leg == "b":  # the F-slices of the tensor-parallel pair; ffw_ln cannot take a partial sum
        layer += ["fused_mlp_fwd", "fused_mlp_bwd"]
    if leg == "d":
        layer += ["ffw_ln_fwd", "ffw_ln_bwd"]
    for name in layer:
        want[name] = 4 * (2 if leg == "d" else 1)
    return want


def _parallel_counters():
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as attn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion, mlp

    return {name: getattr(attn if name.startswith("packed") else
                          fusion if name == "fused_hybrid_head" else mlp, name)
            for name in PARALLEL_ROWS}


def _parallel_split(torch, path: Path, name: str):
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import WindowedSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit

    import numpy as np

    data = dict(np.load(path / f"{name}.npz"))
    windows = WindowedSplit(
        features={m: data[f"x_{m}"] for m in PARALLEL_NAMES}, labels=data["labels"],
        lengths=data["lengths"], modalities=list(PARALLEL_NAMES))
    return windows, DeviceSplit.from_windows(windows, device="cuda")


def _record_updates(trainer, grads, weights):
    """Keep, at each update, the gradient the optimizer is about to apply
    (gathered whole on a mesh), then the whole weights it gave."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel.mesh import (
        gather_full,
    )

    opt = trainer.optimizer
    names = [k for k, _ in trainer.model.named_parameters()]
    apply = opt.apply

    def recording():
        grads.append({k: (a if trainer.mesh is None else gather_full(
            a, trainer.specs[k][1], trainer.mesh)).detach().cpu().clone()
            for k, a in zip(names, opt.acc)})
        apply()
        weights.append({k: v.detach().cpu().clone() for k, v in trainer.state_dict().items()})

    opt.apply = recording


def parallel_leg(torch, overrides, split, steps, model=None, windows=None, counters=None):
    """``steps`` micro-steps of a Trainer at base.yaml + ``overrides`` on the
    global batches of ``split`` (32 windows each, in order) -> (losses,
    gradient at each update, weights each accumulation window started from,
    seconds of each micro-step, launches). ``windows``: weights to start each
    window from (the world's), so that both sides' gradients are taken at
    the same weights (a gradient that is zero up to rounding, the key
    biases', moves Adam's update by up to the learning rate either way)."""
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.trainer import Trainer

    trainer = Trainer(load_cfg(overrides), model=model, device="cuda")
    trainer.init_state(steps_per_epoch=2)
    grads = []
    weights = [{k: v.detach().cpu().clone() for k, v in trainer.state_dict().items()}]
    _record_updates(trainer, grads, weights)
    step = trainer.make_train_step_fn()
    batch = trainer.batch_size
    if counters:
        for fn in counters.values():
            fn.launches = 0
    losses, seconds = [], []
    for i in range(steps):
        if windows is not None and i % trainer.accum == 0:
            trainer.load_state_dict(windows[i // trainer.accum])
        idx = torch.arange(batch) + batch * i
        t = time.perf_counter()
        losses.append(step(split, idx)[0])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
    launches = {k: fn.launches for k, fn in counters.items()} if counters else None
    return torch.stack(losses).tolist(), grads, weights[:-1], seconds, launches, trainer


PARALLEL_PROFILED_STEPS = 2  # micro-steps of each leg's breakdown window
COMM_OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "send", "recv")


def comm_breakdown(torch, trainer, split) -> dict:
    """PARALLEL_PROFILED_STEPS more micro-steps of ``trainer`` with every
    collective of ``parallel.comm`` timed on the host, the card synchronised
    before and after each (so a collective's time is its own and the
    kernels queued before it count as compute), and the device time
    (kernels and copies, torch.profiler's CUDA events) -> ms per micro-step:
    ``wall``, ``device`` and each op's ms and calls. The synchronisation slows the window: it splits a
    micro-step, it is not its p50."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel import comm

    steps = PARALLEL_PROFILED_STEPS
    spent = {name: [0.0, 0] for name in COMM_OPS}
    originals = {name: getattr(comm, name) for name in COMM_OPS}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name][0] += time.perf_counter() - t
            spent[name][1] += 1
            return out
        return run

    step = trainer.make_train_step_fn()
    batch = trainer.batch_size
    for name, fn in originals.items():
        setattr(comm, name, timed(name, fn))
    try:
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for i in range(steps):
                step(split, torch.arange(batch) + batch * i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        for name, fn in originals.items():
            setattr(comm, name, fn)
    device = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA) / 1e3
    out = {"wall": wall * 1e3 / steps, "device": device / steps}
    out.update({name: (ms * 1e3 / steps, calls / steps) for name, (ms, calls) in spent.items()
                if calls})
    return out


def parallel_child(rank: int, world: int, port: int, workdir: Path) -> int:
    """One rank of a [parallel] world (``chip_smoke.py --parallel-child``):
    joins through ``parallel.coordinator_address``, runs every leg and the
    fit, saves what the parent checks."""
    import torch

    sys.path.insert(0, str(REPO))
    import torch.distributed as dist

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.parallel import comm

    coord = [f"parallel.coordinator_address=localhost:{port}",
             f"parallel.num_processes={world}", f"parallel.process_id={rank}",
             f"parallel.num_devices={world}"]
    counters = _parallel_counters()
    out = {"rank": rank}
    if world == 1:  # NCCL's own init and collectives through a Trainer
        _, split = _parallel_split(torch, workdir, "parity")
        losses, *_rest, trainer = parallel_leg(torch, coord, split, 2)
        backend = comm.group_backend()
        x = torch.arange(4.0, device="cuda")
        dist.all_reduce(x)
        pieces = [torch.empty_like(x)]
        dist.all_gather(pieces, x)
        dist.broadcast(x, 0)
        dist.barrier()
        torch.cuda.synchronize()
        out.update(backend=backend, losses=losses, collectives=pieces[0].tolist())
        torch.save(out, workdir / "nccl.pt")
        dist.destroy_process_group()
        return 0
    _, split = _parallel_split(torch, workdir, "parity")
    for leg, extra in PARALLEL_LEGS.items():
        losses, grads, weights, seconds, launches, trainer = parallel_leg(
            torch, PARALLEL_QUIET + coord + extra, split, PARALLEL_STEPS, counters=counters)
        breakdown = comm_breakdown(torch, trainer, split)
        repeat = [parallel_leg(torch, coord + extra, split, PARALLEL_REPEAT_STEPS,
                               counters=counters)[0] for _ in range(2)]
        shard = {k: tuple(v.shape) for k, v in trainer.model.named_parameters()
                 if k.endswith("layers.0.linear1.weight") or k.endswith("layers.0.moe.moe_w1")
                 or k.endswith("pipe_layers.linear1.kernel")}
        out[leg] = {"losses": losses, "seconds": seconds, "launches": launches,
                    "repeat": repeat, "breakdown": breakdown, "shards": shard, "coords": trainer.mesh.coords(),
                    "mesh": dict(trainer.mesh.shape), "backend": comm.group_backend()}
        if rank == 0:
            out[leg].update(grads=grads, weights=weights)
        del trainer
        torch.cuda.empty_cache()
    # one epoch of fit on leg (b)'s layout, the train split cut to a few batches
    fit_train, _ = _parallel_split(torch, workdir, "fit_train")
    fit_val, _ = _parallel_split(torch, workdir, "fit_val")
    fit_test, _ = _parallel_split(torch, workdir, "fit_test")
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.trainer import Trainer

    trainer = Trainer(load_cfg(coord + PARALLEL_LEGS["b"] + ["training.max_epochs=1"]),
                      device="cuda")
    writes = []  # files this rank writes during the fit
    save, write_text = torch.save, Path.write_text

    def counted_save(obj, f, *a, **k):
        writes.append(str(f))
        return save(obj, f, *a, **k)

    def counted_write(path, *a, **k):
        writes.append(str(path))
        return write_text(path, *a, **k)

    torch.save, Path.write_text = counted_save, counted_write
    try:
        results = trainer.fit(fit_train, fit_val, fit_test, save_dir=workdir / "fit",
                              log_fn=lambda msg: print(f"  {msg}", flush=True))
    finally:
        torch.save, Path.write_text = save, write_text
    out["fit"] = {"writes": writes, "best_val_loss": results["best_val_loss"],
                  "history": results["history"], "test_acc": results["test_acc"]}
    state = trainer.state_dict()  # gathered: every rank takes part
    if rank == 0:
        out["fit"]["state"] = {k: v.detach().cpu().clone() for k, v in state.items()}
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _spawn_world(world: int, workdir: Path, label: str):
    """``world`` children of this script, one rank each, joined within
    PARALLEL_JOIN seconds or killed; a failed or late child fails the phase."""
    port = _free_port()
    logs = [open(workdir / f"{label}{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--parallel-child",
                               str(r), str(world), str(port), str(workdir)],
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=str(REPO))
             for r in range(world)]
    deadline = time.monotonic() + PARALLEL_JOIN
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
        for p in late:
            p.wait()
        for f in logs:
            f.close()
    for r, proc in enumerate(procs):
        text = (workdir / f"{label}{r}.log").read_text()
        print("\n".join(f"  [{label} rank {r}] {line}" for line in text.splitlines()[-6:]
                        if "Warning" not in line), flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"[parallel] {label} rank {r} failed or overran "
                                 f"{PARALLEL_JOIN} s (rc {proc.returncode}):\n{text[-3000:]}")


def _grads_close(got, want, what):
    """Norm-wise and each leaf's error (PARALLEL_GRAD_TOL, PARALLEL_LEAF_TOL)."""
    keys = sorted(want)
    if sorted(got) != keys:
        raise AssertionError(f"{what}: the world's gradient has other leaves")
    top = max(want[k].abs().max().item() for k in keys)
    diff = math.sqrt(sum(((got[k] - want[k]) ** 2).sum().item() for k in keys))
    norm = math.sqrt(sum((want[k] ** 2).sum().item() for k in keys))
    leaf = {k: (got[k] - want[k]).abs().max().item() / max(want[k].abs().max().item(), 1e-3 * top)
            for k in keys}
    worst = max(leaf, key=leaf.get)
    print(f"    {what}: gradient norm-wise {diff / norm:.3e} (tol {PARALLEL_GRAD_TOL}), worst "
          f"leaf {leaf[worst]:.3e} at {worst} (tol {PARALLEL_LEAF_TOL})", flush=True)
    if diff > PARALLEL_GRAD_TOL * norm or leaf[worst] > PARALLEL_LEAF_TOL:
        raise AssertionError(f"{what}: the world's gradient disagrees with one process")


def parallel_phase(torch, smi, workdir: Path) -> dict:
    """The layouts on torch.distributed: one world of 4 processes on the one
    card (gloo over CUDA tensors), legs (a)-(d) of the reference's multichip
    dry run at full width on real windows against one process on the card,
    the launches of each rank, determinism, a fit on leg (b)'s layout and its
    checkpoint reloaded in this process, then a 1-rank NCCL world through a
    Trainer. Returns the launches per rank per micro-step of each leg."""
    import numpy as np

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        create_datasets, padded_index_matrix,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.evaluate import dataset_kwargs
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.train.checkpoint import (
        load_checkpoint,
    )

    print("[parallel]", flush=True)
    cfg = load_cfg([f"dataset.data_dir={REPO / 'data' / 'pamap2'}",
                    f"dataset.chunk_cache_dir={workdir / 'chunk_cache'}"])
    batch = int(cfg.dataset.batch_size)
    train_w, val_w, test_w = create_datasets(**dataset_kwargs(cfg))
    order, _ = padded_index_matrix(train_w.num_windows, batch, shuffle=True, seed=int(cfg.seed))
    order = order.reshape(-1)

    def cut(windows, idx, name):
        np.savez(workdir / f"{name}.npz", labels=windows.labels[idx], lengths=windows.lengths[idx],
                 **{f"x_{m}": windows.features[m][idx] for m in PARALLEL_NAMES})

    cut(train_w, order[:PARALLEL_STEPS * batch], "parity")
    cut(train_w, order[:PARALLEL_FIT_BATCHES * batch], "fit_train")
    cut(val_w, np.arange(PARALLEL_FIT_WINDOWS), "fit_val")
    cut(test_w, np.arange(PARALLEL_FIT_WINDOWS), "fit_test")
    print(f"  {PARALLEL_WORLD} processes on one card, global batch {batch}, chunk "
          f"{cfg.dataset.chunk_size}, hidden {cfg.model.hidden_dim}, FFW 2048; parity runs at "
          f"dropout 0 with the augmentations off; the fit's cut: {PARALLEL_FIT_BATCHES} train "
          f"batches, {PARALLEL_FIT_WINDOWS} val and {PARALLEL_FIT_WINDOWS} test windows", flush=True)
    t = time.perf_counter()
    _spawn_world(PARALLEL_WORLD, workdir, "world")
    print(f"  world of {PARALLEL_WORLD} done in {time.perf_counter() - t:.1f} s", flush=True)
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False)
             for r in range(PARALLEL_WORLD)]
    _, split = _parallel_split(torch, workdir, "parity")
    counters = _parallel_counters()
    per_step = {}
    for leg, extra in PARALLEL_LEGS.items():
        got = ranks[0][leg]
        backends = {r[leg]["backend"] for r in ranks}
        print(f"  leg ({leg}) {' '.join(extra)}: mesh {got['mesh']}, backend {backends}, "
              f"shards {got['shards']}", flush=True)
        if backends != {"gloo"}:
            raise AssertionError(f"leg ({leg}): 4 ranks on one card must use gloo, got {backends}")
        model_keys = [k for k in extra if not k.startswith("parallel.")]
        pipe = [k for k in extra if k.startswith("parallel.pipeline")]
        model = MultimodalFusionModel.from_config(
            load_cfg(PARALLEL_QUIET + model_keys + pipe), device="cuda",
            generator=torch.Generator().manual_seed(int(cfg.seed)))
        for k, v in model.state_dict().items():
            if not torch.equal(v.cpu(), got["weights"][0][k]):
                raise AssertionError(f"leg ({leg}): the world built other weights at {k}")
        losses, grads, *_ = parallel_leg(torch, PARALLEL_QUIET + model_keys, split,
                                         PARALLEL_STEPS, model=model, windows=got["weights"])
        e_loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses))
        print(f"    losses {['%.6f' % v for v in got['losses']]}, worst rel err vs one process "
              f"{e_loss:.3e} (tol {PARALLEL_LOSS_TOL})", flush=True)
        if e_loss > PARALLEL_LOSS_TOL or len(got["grads"]) != 2:
            raise AssertionError(f"leg ({leg}): the world's losses disagree with one process")
        for i, (g, w) in enumerate(zip(got["grads"], grads)):
            _grads_close(g, w, f"leg ({leg}) update {i}")
        for r in ranks:
            if r[leg]["repeat"][0] != r[leg]["repeat"][1]:
                raise AssertionError(f"leg ({leg}) rank {r['rank']}: the same seed twice gave "
                                     f"other losses {r[leg]['repeat']}")
        print(f"    at the config's dropout and augmentations: {PARALLEL_REPEAT_STEPS} "
              f"micro-steps twice, bit for bit on every rank: "
              f"{['%.6f' % v for v in ranks[0][leg]['repeat'][0]]}", flush=True)
        want = _parallel_want(leg)
        for r in ranks:
            counts = {k: v / PARALLEL_STEPS for k, v in r[leg]["launches"].items()}
            if counts != {k: float(v) for k, v in want.items()}:
                raise AssertionError(f"leg ({leg}) rank {r['rank']}: launches per micro-step "
                                     f"{counts}, want {want}")
        per_step[leg] = {k: v / PARALLEL_STEPS for k, v in ranks[0][leg]["launches"].items()}
        p50 = [sorted(r[leg]["seconds"][2:])[len(r[leg]["seconds"][2:]) // 2] * 1e3
               for r in ranks]
        print(f"    launches per rank per micro-step {per_step[leg]} (every rank as want); "
              f"micro-step p50 by rank {['%.1f ms' % v for v in p50]} on {smi}: 4 processes "
              f"sharing one card, no speed of a 4-card layout", flush=True)
        for r in ranks:
            b = r[leg]["breakdown"]
            ops = ", ".join(f"{k} {v[0]:.1f} ms / {v[1]:g} calls" for k, v in b.items()
                            if k in COMM_OPS)
            print(f"    rank {r['rank']} breakdown ({PARALLEL_PROFILED_STEPS} micro-steps, the "
                  f"card synchronised around each collective), ms a micro-step: wall "
                  f"{b['wall']:.1f}, device (kernels and copies) {b['device']:.1f}, collectives "
                  f"{sum(v[0] for k, v in b.items() if k in COMM_OPS):.1f} ({ops})", flush=True)
        del model
        torch.cuda.empty_cache()
    # the fit: rank 0 alone wrote, and its checkpoint loads into one process
    fit = [r["fit"] for r in ranks]
    for r in fit[1:]:
        if r["writes"]:
            raise AssertionError(f"a rank other than 0 wrote {r['writes']}")
        if r["best_val_loss"] != fit[0]["best_val_loss"]:
            raise AssertionError("the ranks' fit results differ")
    run = workdir / "fit"
    results = json.loads((run / "results.json").read_text())
    weights, ckpt_cfg, _meta = load_checkpoint(run / "checkpoints" / "last")
    one = MultimodalFusionModel.from_config(ckpt_cfg, device="cuda")
    one.load_state_dict(weights)
    for k, v in one.state_dict().items():
        if not torch.equal(v.cpu(), fit[0]["state"][k]):
            raise AssertionError(f"the reloaded checkpoint differs from the world's weights at {k}")
    print(f"  fit on leg (b)'s layout: 1 epoch, history {fit[0]['history']}, test_acc "
          f"{fit[0]['test_acc']:.4f}; rank 0 wrote {len(fit[0]['writes'])} files "
          f"(results.json: {results['best_model_path'] != ''}), ranks 1-3 none; the last "
          f"checkpoint loaded into one process bit for bit", flush=True)
    t = time.perf_counter()
    _spawn_world(1, workdir, "nccl")
    nccl = torch.load(workdir / "nccl.pt", weights_only=False)
    print(f"  a 1-rank world through Trainer: backend {nccl['backend']}, 2 micro-steps "
          f"{['%.6f' % v for v in nccl['losses']]}, all_reduce / all_gather / broadcast / "
          f"barrier {nccl['collectives']} in {time.perf_counter() - t:.1f} s", flush=True)
    if nccl["backend"] != "nccl" or nccl["collectives"] != [0.0, 1.0, 2.0, 3.0]:
        raise AssertionError(f"the 1-rank world did not run on NCCL: {nccl}")
    return per_step


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check runs on the card only",
              file=sys.stderr)
        return 2
    if not (REPO / PKG / "serving.py").is_file():
        print(f"chip_smoke: {PKG} not found beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 plain twins
    torch.backends.cudnn.allow_tf32 = False

    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.dataset import (
        MultimodalDataset, apply_instance_normalization, padded_index_matrix,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.data.device import DeviceSplit
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.attention import (
        ordered_pairs,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.models.module import (
        MultimodalFusionModel,
    )
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import _build
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import attention as attn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.ops import fusion, mlp, rnn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.serving import make_serving_fn
    from multimodal_sensor_fusion_with_attention_rajeevatla_torch.utils.config import load_config

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    # ---- 1. setup: kernels and data --------------------------------------
    t = time.perf_counter()
    ptxas = ptxas_report(_build)
    _build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    ptxas()
    cfg = load_config(REPO / "config" / "base.yaml")
    modalities = list(cfg.dataset.modalities)
    t = time.perf_counter()
    windows = MultimodalDataset(
        REPO / "data" / "pamap2", modalities, "train",
        chunk_size=int(cfg.dataset.chunk_size),
        window_stride=int(cfg.dataset.window_stride),
    ).windows
    apply_instance_normalization(windows)
    split = DeviceSplit.from_windows(windows, device="cuda")
    print(f"[setup] {split.num_windows} train windows on the card in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    idx_matrix, _ = padded_index_matrix(split.num_windows, BATCH, shuffle=True, seed=int(cfg.seed))
    batches = [split.gather(torch.from_numpy(row)) for row in idx_matrix]
    # the first request also carries the split's short windows
    short = torch.from_numpy((windows.lengths < int(cfg.dataset.chunk_size)).nonzero()[0][:8])
    first_idx = torch.cat([short, torch.from_numpy(idx_matrix[0][: BATCH - len(short)])])
    batches[0] = split.gather(first_idx)

    # ---- model --------------------------------------------------------------
    model = MultimodalFusionModel.from_config(
        cfg, device="cuda", generator=torch.Generator().manual_seed(int(cfg.seed))
    )
    plain_cfg = load_config(REPO / "config" / "base.yaml", ["model.flash_attention=false"])
    plain_model = MultimodalFusionModel.from_config(plain_cfg, device="cuda")
    plain_model.load_state_dict(model.state_dict())
    serve = make_serving_fn(model, device="cuda")

    @torch.inference_mode()
    def serve_plain(feats, mask, lengths):
        """The serving contract on the plain path: a missing modality is a
        zero embedding, the head is the model's own (kernels off)."""
        encoded = plain_model.encode(feats, lengths)
        for m in modalities:
            encoded.setdefault(m, torch.zeros((BATCH, plain_model.output_dim), device="cuda"))
        return plain_model.fuse(encoded, mask)

    # ---- 2. kernels vs their plain twins ------------------------------------
    print("[kernels]", flush=True)
    feats0, _labels0, lengths0 = batches[0]
    rows = [check_attention(torch, attn, lengths0)]
    with torch.inference_mode():
        params = fusion.hybrid_head_params(model.fusion_model)
        encoded = model.encode(feats0, lengths0)
        mask0 = torch.ones((BATCH, len(modalities)), device="cuda")
        projected = torch.stack([
            torch.relu(torch.nn.functional.linear(encoded[m], *params.proj[m])) for m in modalities
        ]).contiguous()
    rows.append(check_head(torch, fusion, ordered_pairs, (projected, mask0, params)))
    train_batch = int(cfg.dataset.batch_size)
    train_idx, _ = padded_index_matrix(split.num_windows, train_batch, shuffle=True,
                                       seed=int(cfg.seed))
    train_lengths = split.lengths.index_select(0, torch.from_numpy(train_idx[0]).long().cuda())
    rows.insert(1, check_attention_bwd(torch, attn, train_lengths))
    train_rows = train_batch * int(cfg.dataset.chunk_size)
    rows += check_ln_kernels(torch, mlp, train_rows)
    rows += check_bf16_attention(torch, attn, lengths0, train_lengths)
    rows += check_bf16_ln(torch, mlp, train_rows)
    torch.cuda.empty_cache()
    rows += check_fused_mlp(torch, mlp, train_rows)
    rows += check_bf16_fused_mlp(torch, mlp, train_rows)
    torch.cuda.empty_cache()
    rows.append(check_dropout_mask(torch, mlp, train_rows))
    stride = int(cfg.dataset.window_stride)
    real_lengths = {512: train_lengths.repeat(len(modalities))}  # the group's folded batch
    for chunk in LONG_CHUNKS:
        lengths = load_split(torch, modalities, chunk, stride).lengths
        pick = torch.from_numpy(padded_index_matrix(
            len(lengths), BATCH, shuffle=True, seed=int(cfg.seed))[0][0]).long().cuda()
        real_lengths[chunk] = lengths.index_select(0, pick)
    rows += check_flash_kernels(torch, attn, real_lengths)
    torch.cuda.empty_cache()
    rows += check_rnn_kernels(torch, rnn, {512: lengths0, 1024: real_lengths[1024]})
    torch.cuda.empty_cache()
    rows += check_rnn_train_kernels(
        torch, rnn, {512: train_lengths, 1024: real_lengths[1024][:RNN_TRAIN_B]})
    torch.cuda.empty_cache()
    kernels = {  # table row name -> wrapper with its launch counter
        "packed_attention_fwd": attn.packed_attention_fwd,
        "packed_attention_bwd": attn.packed_attention_bwd,
        "fused_hybrid_head": fusion.fused_hybrid_head,
        "proj_ln_fwd": mlp.proj_ln_fwd, "proj_ln_bwd": mlp.proj_ln_bwd,
        "ffw_ln_fwd": mlp.ffw_ln_fwd, "ffw_ln_bwd": mlp.ffw_ln_bwd,
        "fused_mlp_fwd": mlp.fused_mlp_fwd, "fused_mlp_bwd": mlp.fused_mlp_bwd,
        "dropout_keep_mask": mlp.dropout_keep_mask,
        "flash_fwd_single": attn.flash_fwd_single, "flash_fwd_tiled": attn.flash_fwd_tiled,
        "flash_bwd_fused": attn.flash_bwd_fused, "flash_bwd_dkv": attn.flash_bwd_dkv,
        "flash_bwd_dq": attn.flash_bwd_dq,
        "grouped_lstm_forward": rnn.grouped_lstm_forward,
        "grouped_lstm_fused": rnn.grouped_lstm_fused,
        "grouped_gru_fused": rnn.grouped_gru_fused,
        "lstm_train_fwd": rnn.lstm_train_fwd, "lstm_train_bwd": rnn.lstm_train_bwd,
        "gru_train_fwd": rnn.gru_train_fwd, "gru_train_bwd": rnn.gru_train_bwd,
        **{name: getattr(attn if name.startswith("packed") else mlp, name)
           for name in BF16_KERNELS},
    }

    # ---- 3. serve: the main path ----------------------------------------------
    print("[serve]", flush=True)
    missing = modalities[1]
    feats1, _, lengths1 = batches[1]
    mask1 = torch.ones((BATCH, len(modalities)), device="cuda")
    mask1[:, 1] = 0.0
    feats2, _, _ = batches[2]
    g = torch.Generator().manual_seed(7)
    lengths2 = torch.randint(1, 160, (BATCH,), generator=g, dtype=torch.int32)
    lengths2[:3] = torch.tensor([0, 37, 1], dtype=torch.int32)
    requests = [
        ("all modalities", feats0, None, lengths0),
        (f"{missing} missing", {m: x for m, x in feats1.items() if m != missing}, mask1, lengths1),
        ("short lengths", feats2, None, lengths2.cuda()),
    ]
    for fn in kernels.values():
        fn.launches = 0
    logits = []
    for _name, feats, mask, lengths in requests:
        logits.append(serve(feats, mask, lengths))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    want = dict.fromkeys(kernels, 0)
    want["packed_attention_fwd"] = sum(len(feats) for _n, feats, _m, _l in requests)
    want["fused_hybrid_head"] = len(requests)
    print(f"  launches: {launches} (want {want})", flush=True)
    if launches != want:
        raise AssertionError(f"serving launch counts {launches} != {want}")
    worst = 0.0
    for (name, feats, mask, lengths), got in zip(requests, logits):
        ref = serve_plain(feats, mask, lengths)
        torch.cuda.synchronize()
        if got.shape != (BATCH, model.num_classes) or not torch.isfinite(got).all():
            raise AssertionError(f"request '{name}': bad logits {tuple(got.shape)}")
        e = (got - ref).abs().max().item()
        print(f"  request '{name}': logits {tuple(got.shape)} finite, max_abs_err vs plain "
              f"path {e:.3e} (tol {LOGIT_TOL})", flush=True)
        worst = max(worst, e)
    if worst > LOGIT_TOL:
        raise AssertionError(f"served logits disagree with the plain path: {worst} > {LOGIT_TOL}")
    if {name: fn.launches for name, fn in kernels.items()} != launches:
        raise AssertionError("the plain path launched a kernel")
    serve_launches = launches

    lat = []
    for i in range(40):
        feats, _, lengths = batches[i % len(batches)]
        t = time.perf_counter()
        serve(feats, None, lengths)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    lat = sorted(lat[5:])
    p50 = lat[len(lat) // 2]
    print(f"  serve batch {BATCH}: p50 latency {p50 * 1e3:.3f} ms, "
          f"{BATCH / p50:.1f} windows/s on {smi}", flush=True)

    def run_requests(n):
        for i in range(n):
            feats, _, lengths = batches[i % len(batches)]
            serve(feats, None, lengths)
        torch.cuda.synchronize()

    served = profile(torch, run_requests, 10, "request")
    print(f"  the head in a served chunk-512 request: {served.get('fusion_head', 0.0):.4f} ms "
          f"of {served['device']:.4f} ms device time, share "
          f"{served.get('fusion_head', 0.0) / served['device']:.4f}", flush=True)

    # ---- 4. train: the second main path --------------------------------------
    print("[train]", flush=True)
    train_launches, mlp_launches, f32_times = train_phase(torch, kernels, split, train_idx, smi)
    f32_times.update(serve_p50=p50, serve_device=served["device"])

    # ---- 5./6. fit, checkpoint, evaluate --------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fit_launches, eval_launches = fit_and_eval_phase(torch, kernels, smi, Path(tmp))

    # ---- 6b./6c. the serving bundle, and streamed training batches --------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        bundle_launches = bundle_phase(torch, kernels, modalities, batches, smi, Path(tmp))
        stream_phase(torch, kernels, smi, Path(tmp))

    # ---- 7. the long windows --------------------------------------------------
    del model, plain_model, serve
    torch.cuda.empty_cache()
    long_launches = long_phase(torch, kernels, modalities, stride, int(cfg.seed), smi)

    # ---- 8. the grouped encoder -----------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        grouped_launches = grouped_phase(torch, kernels, split, idx_matrix, train_idx, p50, smi,
                                         Path(tmp))

    # ---- 9. the recurrent model family ----------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rnn_launches = rnn_phase(torch, kernels, split, modalities, stride, int(cfg.seed), smi,
                                 Path(tmp))
    # ---- 10. model widths the kernels are not built for (C5) -------------------
    c5_launches = c5_phase(torch, kernels, split, idx_matrix, train_idx, smi)
    # ---- 11./12. the other fusion heads, and the CNN encoder ---------------------
    test = load_split(torch, modalities, int(cfg.dataset.chunk_size),
                      int(cfg.dataset.chunk_size), "test")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        fusion_launches = fusion_phase(torch, kernels, split, idx_matrix, train_idx, test, smi,
                                       Path(tmp))
        cnn_launches = cnn_phase(torch, kernels, split, idx_matrix, train_idx, test, smi,
                                 Path(tmp))
    # ---- 13. bf16: mixed_precision through the bf16 entries ----------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        bf16_launches = bf16_phase(torch, kernels, split, idx_matrix, train_idx, smi, Path(tmp),
                                   f32_times)
    # ---- 14. the MoE feed-forward, and training.remat -----------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        moe_launches = moe_phase(torch, kernels, split, idx_matrix, train_idx, test, smi,
                                 Path(tmp))
    remat_launches = remat_phase(torch, kernels, split, train_idx, modalities, stride,
                                 int(cfg.seed), smi)
    # ---- 15. the parallel layouts: a world of 4 processes on the card -----------------
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        parallel_launches = parallel_phase(torch, smi, Path(tmp))
    rnn_paths = {  # the path each recurrence kernel runs on
        "grouped_lstm_forward": rnn_launches["forward_lstm512"],
        "grouped_lstm_fused": rnn_launches["serve_lstm512"],
        "grouped_gru_fused": rnn_launches["serve_gru512"],
        "lstm_train_fwd": rnn_launches["train_lstm512"],
        "lstm_train_bwd": rnn_launches["train_lstm512"],
        "gru_train_fwd": rnn_launches["train_gru512"],
        "gru_train_bwd": rnn_launches["train_gru512"],
    }
    flash_paths = {  # the path each flash kernel was ported for
        "flash_fwd_single": long_launches["train1024"], "flash_fwd_tiled": long_launches["serve4096"],
        "flash_bwd_fused": long_launches["train1024"], "flash_bwd_dkv": long_launches["train2048"],
        "flash_bwd_dq": long_launches["train2048"],
    }

    for row in rows:
        # each kernel's launches on the path it was ported for: the eval
        # kernels on the serve path, the training kernels on the default
        # train path, the feed-forward pair on its own route
        name = row["name"]
        if name in ("packed_attention_fwd", "fused_hybrid_head"):
            path = serve_launches
        elif name in BF16_PAIR:
            path = bf16_launches["pair"]
        elif name in BF16_KERNELS:
            path = bf16_launches["serve" if name == "packed_attention_fwd_bf16" else "train"]
        elif name in ("fused_mlp_fwd", "fused_mlp_bwd"):
            path = mlp_launches
        elif name in flash_paths:
            path = flash_paths[name]
            row["serve_launches"] = {c: long_launches[f"serve{c}"][name] for c in LONG_CHUNKS}
            row["grouped_launches"] = {k: v[name] for k, v in grouped_launches.items()}
        elif name in rnn_paths:
            path = rnn_paths[name]
            row["rnn_launches"] = {k: v[name] for k, v in rnn_launches.items()}
        else:
            path = train_launches
        row["launches"] = path[name]
        row["train_launches"] = train_launches[name]
        row["fit_launches"] = fit_launches[name]
        row["eval_launches"] = eval_launches[name]
        row["c5_launches"] = {k: v[name] for k, v in c5_launches.items()}
        row["fusion_launches"] = {k: v[name] for k, v in fusion_launches.items()}
        row["cnn_launches"] = {k: v[name] for k, v in cnn_launches.items()}
        row["bf16_launches"] = {k: v[name] for k, v in bf16_launches.items()}
        row["moe_launches"] = {k: v[name] for k, v in moe_launches.items()}
        row["remat_launches"] = {k: v[name] for k, v in remat_launches.items()}
        row["bundle_launches"] = {k: v[name] for k, v in bundle_launches.items()}
        # per rank per micro-step of each [parallel] leg
        row["parallel_launches"] = {k: v.get(name, 0.0) for k, v in parallel_launches.items()}
        if row["launches"] <= 0:
            raise AssertionError(f"kernel {name} was not launched on its main path")
    print(f"[done] {time.perf_counter() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-child":
        sys.exit(parallel_child(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                                Path(sys.argv[5])))
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``repro_torch``) on one card.

Drives the port's two serving paths, smollm-135m at full width, restored
N-to-M, and recurrentgemma-9b at full width and full depth, then its
training path: smollm-135m trained on the card, killed, and resumed from
its N-to-M checkpoint; then the paper's own finite-element path at full
size and the post-processing sweep of the training run's checkpoint; the
restart across process counts; the MoE family, granite-moe-3b-a800m
served at full width (8 of 32 layers) and trained at 2 layers; the rest
of the dense
family, qwen3-4b and qwen2-vl-7b served through the flash kernel at head
dim 128 and gemma2-2b served past its 4,096-token window; and the
recurrent families' training, recurrentgemma-9b at 3 layers through the
scan's gradient and xlstm-350m served and restarted at 8 of 24 layers and
trained at full width; and the last two families: whisper-base
(encoder-decoder) served and restarted at 2 + 2 of its 6 + 6 layers and
trained at full size, kimi-k2 served at one full-width layer
and trained under Adafactor; the quickstart example; and serving on a
mesh, a sharded KV cache served by 4 CPU processes and restored on the
card; and tensor-parallel training, smollm-135m's heads, MLP and vocab
split over 3 processes that share the card, recurrentgemma-9b's and
whisper-base's over 4.

  device   the card's name and power limit (nvidia-smi);
  build    the hand-written kernels, compiled from this checkout's sources;
  kernels  each kernel against its plain PyTorch version on the card, at the
           main paths' shapes, with its time, bound, plain and library times;
           the attention backward kernel against its plain version (from
           the forward kernel's log-sum-exp, held to attention_lse_ref's),
           its repeat bits, time, bound, plain and SDPA-backward times;
           and the scan's gradient (``lru_scan_vjp``: kernel forward, the
           kernel's reverse mode backward) against autograd through the
           plain version, the reverse mode against ``lru_scan_bwd_ref``,
           with the backward's time and bound, in deterministic mode (the
           train path's) and in default mode, and the kernel's bits over
           repeated launches in both modes and directions, each launch held
           to the plain version;
  ckpt     a seeded full-width smollm-135m state on the card, saved as N=4
           ranks through the N-to-M engine (ckpt_pack packs each rank's
           chunks), restored N-to-M onto this one card, checked bit for bit;
  serve    continuous batching from the restored parameters (prefill through
           the flash-attention kernel), token for token against sequential
           greedy decoding;
  hybrid_serve        recurrentgemma-9b (seeded weights on the card) through
           the launcher's ``serve_batch``: one batched prefill (every RG-LRU
           layer through the rglru_scan kernel), lockstep greedy decode;
  hybrid_state        that prefill's serving state (recurrent and conv
           states, ring-buffer K/V, length) saved as N=4 ranks and restored
           4-to-1 onto the card bit for bit; decoding from the restored state
           gives the same tokens;
  hybrid_consistency  decode-step logits against one prefill of the prompt
           plus the tokens generated so far;
  train    smollm-135m at full width, TRAIN_LAYERS of its 30 layers (B 4,
           S 2048), trained through the TorchTrainer in
           deterministic mode, its attention on the flash kernels under
           autograd, forward and backward (dq, dk, dv first checked against
           autograd through the plain blocked path): run A takes 6 steps
           straight;
           run B saves every 2 steps through the async checkpointer
           (ckpt_pack packs each save) and is preempted at step 5; run C, a
           fresh trainer, restores the last committed step and runs to 6.
           C must end in A's state bit for bit.
  fem      a P4 function on tri_mesh_fast(512, 512) (1.57 M entities, 4.2 M
           DoFs) kept on the card, saved from N=8 simulated ranks at 3 time
           indices through the async facade (``save_mesh``,
           ``save_function``), loaded on M=1 (onto the card) and M=3; every
           loaded DoF equal to the field at its node point, bit for bit;
  postprocess  the committed steps of runs B and C swept on one rank
           (``sweep_steps``), only the embedding table and the final norm
           loaded onto the card, each equal to the train phase's own bit for
           bit, the store reading no other array's datasets;
  elastic  smollm-135m at full width (depth cut to 1 layer) trained sharded
           over torch.distributed processes and restarted on other process
           counts: N = 4 CPU processes (gloo, mesh (2, 2)) save steps 2 and
           4 through rank 0's async writer, which a fault store kills 4 ops
           into step 4's save (every process must raise); M = 1 on the card
           (NCCL, mesh (1, 1)) restores step 2, bit-equal to what the 4
           processes held, trains to 4 through the flash kernel and saves
           step 4 through ckpt_pack; M = 2 CPU processes (mesh (1, 2))
           restore step 4, bit-equal to the card's state.
  moe_serve  granite-moe-3b-a800m at full width, 8 of its 32 layers (40
           experts padded to 48, top-8; seeded weights on the card) through
           the launcher's step builders on a (1, 1) mesh, so every MoE layer
           runs the expert-parallel ``moe_ffn_ep`` (its calls are counted):
           B 4, prompt 512, 32 decode steps; one MoE layer against the
           dense oracle at capacity
           factor E, the logits with kernel attention against naive
           attention, and a second prefill bit-equal to the first;
  moe_state  that prefill's KV cache saved as N=4 ranks and restored 4-to-1
           onto the card bit for bit; 8 decode steps from it give the
           served tokens;
  moe_train  granite at full width, depth cut to 2 layers, B 4, S 1024,
           through the sharded step on a (1, 1) NCCL mesh in deterministic
           mode with the flash kernel under autograd and ``moe_ffn_ep`` in
           every layer (counted): 4 steps (finite falling loss, positive
           aux), then steps 1-2 again from one seed, bit-equal to the first
           run's in every array and loss.
  dense_serve  qwen3-4b, then qwen2-vl-7b (its embeddings input: embeds
           and M-RoPE positions), at full width and depth (seeded weights
           on the card) through the launcher's ``serve_batch``: B 4,
           prompt 512, 32 decode steps, one ``flash_attention`` launch per
           layer of the prefill (hd 128; qwen2-vl's group of 7); the logits
           with kernel attention against naive attention within the
           model's LOGITS_RTOL (the blocked path's distance, the bf16
           floor, read beside it), a second prefill bit-equal to the
           first, and the unembedding's device time beside a decode
           step's;
  vlm_state  qwen2-vl's KV cache after a B 2, prompt-512 prefill into 520
           slots saved as N=4 ranks and restored 4-to-1 onto the card bit
           for bit; 8 decode steps from it give the original's tokens;
  window_serve  gemma2-2b at full width and depth: B 1, a prompt of 4,608
           (past its local layers' window of 4,096), 16 decode steps; its
           alternating layers take the blocked plain path (no
           ``flash_attention`` launch, as the reference dispatches); the
           logits against naive attention, the first decode step's logits
           against one prefill of 4,609 tokens, in bf16 and for the same
           weights in f32, where the step with the window dropped must
           fail; then the port of ``examples/serve_batched.py`` on the
           card.
  hybrid_train  recurrentgemma-9b at full width, depth cut to 3 layers (one
           (lru, lru, local) group, 1.71 G parameters), B 4, S 2048, remat,
           deterministic mode: 4 steps (finite falling loss), then steps 1-2
           again from the seed, bit-equal in every array; 3 ``rglru_scan``
           launches a recurrent layer a step (forward, remat's recompute,
           backward), counted and pinned.
  xlstm_serve  xlstm-350m at full width, 8 of its 24 layers, through the
           launcher's
           ``serve_batch``: B 4, prompt 512, 32 decode steps; a repeated
           prefill bit-equal; decode steps against longer prefills in bf16,
           and in f32 for the same weights; the sLSTM loop's share of a
           prefill.
  xlstm_state  its serving state after a B 2, prompt-512 prefill (34 MB)
           saved as N=4 ranks, restored 4-to-1 onto the card bit for bit;
           8 decode steps from it and from the live state, logits
           bit-equal.
  xlstm_train  xlstm-350m at full width, B 4, S 512: 4 steps and steps 1-2
           again bit-equal; then runs A, B and C as in ``train`` at 2 layers
           (one mLSTM/sLSTM pair at full width), C bit-exact with A.
  whisper_serve  whisper-base at full width, 2 + 2 of its 6 + 6 layers
           (seeded bf16 weights), through
           the launcher's ``serve_batch``: B 4, 1,500 encoder frames, a
           prompt of 32 tokens, 32 decode steps; every attention on the
           blocked plain path (as the reference), so no kernel launches; a
           repeated prefill bit-equal; decode steps against longer
           prefills in bf16 and in f32; a prefill of frames alone (BOS).
  whisper_state  its cache (k, v, the cross K/V at 1,500 frames, length)
           saved as N=4 ranks, restored 4-to-1 onto the card bit for bit;
           8 decode steps from it give the served tokens.
  whisper_train  whisper-base at full size at its published contexts
           (decoder 448, encoder 1,500 frames, seeded), B 4, remat: 4 steps
           and steps 1-2 again bit-equal; then runs A, B and C as in
           ``train``, C bit-exact with A.
  kimi_serve  kimi-k2 at full width, depth cut to 1 of 61 layers (384
           experts top-8, 19.4 G parameters), the flash kernel at hd 128
           and G 8 and ``moe_ffn_ep`` (counted): B 4, prompt 512, 32 decode
           steps; the flash forward at its heads against attention_ref
           beside SDPA; the logits against naive attention; the EP layer
           against the dense oracle; a repeated prefill bit-equal; its KV
           cache 4-to-1, bit for bit, and 8 decode steps from it.
  kimi_train  one full-width layer with the experts cut to 64, Adafactor,
           B 4, S 1,024, remat: 4 steps and steps 1-2 again bit-equal, the
           state's slots those of its specs; then runs A, B and C of an
           Adafactor state at the smoke config, C bit-exact with A.
  quickstart  the port of ``examples/quickstart.py`` on the card: two
           tensors saved from 4 ranks (ckpt_pack) and loaded on 3 with
           another partition, bit for bit on the card.
  serve_mesh  serving on a mesh: smollm-135m at full width, depth cut to
           2 layers; 4 CPU processes (gloo, mesh (2, 2)) prefill B 4
           prompts of 64 and decode 16 steps through the sharded step
           builders, the KV cache's sequence dim split over the model axis
           (the sequence-parallel decode attention), and save the cache as
           one checkpoint rank per process; the card (NCCL, mesh (1, 1))
           restores it 4-to-1 bit for bit, decodes 8 more steps through the
           mesh builders, each step's logits bit-equal to the one-device
           step's from the same cache, prefills through the mesh builder
           (flash_attention, counted) bit-equal to the one-device prefill,
           and re-saves the cache as one rank (ckpt_pack); then the serve
           launcher on the card in the environment ``torchrun
           --nproc-per-node 1`` gives it (a (1, 1) NCCL mesh).
  tp_train  tensor-parallel training: smollm-135m at full width, 1
           layer, B 4, S 2048, bf16, remat, deterministic mode, on a (1,
           3) mesh of 3 processes that share the card (gloo, which takes
           the card's tensors): each process computes on its own kv head
           and 3 query heads (the flash forward and backward kernels,
           counted per process), its third of the MLP and of the vocab; 3
           steps held to the one-process card steps within CARD_RTOL; a
           second run bit-equal; no parameter gathered over the model
           axis (only activation bytes on its group); the TP state saved
           through ckpt_pack and restored 3 -> 1 on the card bit for bit.
           Then three legs on a (1, 4) mesh, each on a line of its own:
           recurrentgemma-9b at full width and 3 layers (B 1, S 512;
           each process's RG-LRU block on 1,024 of the 4,096 channels,
           its rglru_scan launches counted, forward and reverse),
           whisper-base at full width and 2 + 2 of its 6 + 6 layers (B 4,
           S 448) and xlstm-350m at full width and 2 layers, one
           mLSTM/sLSTM pair (B 1, S 512; each process with 512 of the
           mLSTM's 2,048 inner columns, 1,024 of the sLSTM's 4,096 gate
           columns, 256 of w_out's 1,024 rows and 12,576 vocab rows; both
           cells run whole on every process), one spawn for the three: served in bf16 (a prefill and 8 decode
           steps on local heads, channels and columns, within the model's
           LOGITS_RTOL of one process's, the same greedy tokens), 3 TP
           steps in f32 within CARD_RTOL_F32 of the one-process steps,
           repeated bit-equal, and the smoke config's sharded state saved
           through ckpt_pack and restored 4 -> 1 bit for bit.

Each path runs with the launch counts set to 0 just before it and read just
after; a kernel of a path that never launched fails the run (the fem,
postprocess, xlstm_serve and whisper_serve paths and whisper_train's
repeated steps run no kernel: their counts are reported).  Every phase
prints one JSON line, with its seconds; a failing phase raises and the
script exits non-zero.
Before the last line come the {"kernels": [...]} line (``launches`` summed
over the paths that run the kernel), the card's name and power limit and
then the script's own total seconds; the last line is {"ok": true,
"device": {...}}.  Needs one CUDA card (80 GB:
kimi-k2's one layer is 38.8 GB in bf16, seeded through a 22.5 GB f32
draw; each model is freed before the next is seeded) and the repository
around it; imports nothing of JAX.

    python3 chip_smoke.py [--kernels-only]

``--kernels-only`` stops after the kernel checks (and prints neither of
the last two lines).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# |kernel - plain| <= ATOL + RTOL * |plain| for the attention kernel: P is
# rounded to bf16 for the PV tensor-core product (the plain version keeps it
# in f32) and the output is rounded to bf16 (1 ulp = 2^-8 relative) — the
# repo's own Pallas-vs-oracle bf16 tolerance
ATTN_ATOL = ATTN_RTOL = 2e-2
# the attention backward kernel against attention_bwd_ref (f32) on the same
# (q, k, v, o, lse, dO): max |kernel - plain| <= ATTN_BWD_TOL * max |plain|
# for each of dq, dk and dv.  P and dS are rounded to bf16 for the
# tensor-core products and the gradients to bf16 (2^-8 relative), so an
# element lands within about 1e-2 of its array's scale; the plain dq of a
# [B, 2048] causal row is small (sums of 2,048 signed terms), so an
# elementwise relative bound would hold it to its rounding noise
ATTN_BWD_TOL = 2e-2
# the forward's log-sum-exp (natural log) against attention_lse_ref's:
# |kernel - plain| <= LSE_TOL (1 + |plain|); the two sum the same f32
# products of the same bf16 inputs in another order, exp2 approximate
LSE_TOL = 1e-3
# |kernel-path prefill logits - naive-path logits| <= LOGITS_RTOL[arch] *
# max |naive logits| in check_model_logits, per model.  Any two bf16
# attention paths drift apart through the layers to the model's own bf16
# floor (tools/logits_error.py: the kernel's one-layer error equals the
# blocked path's, and the kernel on the first quarter of the layers
# already gives the whole distance).  Measured on an H100, kernel / blocked
# path against naive: smollm 0.0052 / 0.0047, granite 0.0058 / 0.0048,
# qwen3-4b 0.0211 / 0.0221, qwen2-vl-7b 0.0543 / 0.0494 (each bf16 path
# 0.046-0.049 from the same weights in f32), gemma2-2b (its dispatch is the
# blocked path) 0.0143, kimi-k2 at 1 layer 0.0030 / 0.0032; each limit is
# 1.5-2x the larger reading
LOGITS_RTOL = {"smollm-135m": 0.01, "granite-moe-3b-a800m": 0.01,
               "qwen3-4b": 0.035, "qwen2-vl-7b": 0.08, "gemma2-2b": 0.025,
               "kimi-k2-1t-a32b": 0.006}
# |kernel - plain| <= SCAN_ATOL + SCAN_RTOL * |plain| for the RG-LRU scan:
# tests/test_kernels.py's f32 tolerance of the Pallas kernel against its
# oracle (the kernel runs the sequential FMA chain, the plain version a
# doubling scan: the same sums in another order)
SCAN_ATOL = SCAN_RTOL = 1e-5

# forward launches of rglru_scan at the train shape compared bit for bit,
# with and without deterministic mode
SCAN_REPEATS = 10

# rounds of ckpt_pack's timing, each the kernel then index_select
PACK_ROUNDS = 5

# MB that time_ms writes to flush L2 before each timed call.  512 MB takes
# about 0.16 ms at the HBM rate, longer than the host takes to issue one
# small kernel (0.03-0.08 ms through a Python wrapper on the H100), so the
# events around the call time the device.  A 128 MB flush (0.04 ms) can
# end before the issue does, and then the host's time leaks into the
# reading; small kernels are also timed with it, for comparison with
# readings made that way.
FLUSH_MB = 512
SHORT_FLUSH_MB = 128

SEED = 0
NRANKS = 4
SLOTS = 4
# (prompt length, max_new) of the served requests
REQUESTS = [(16, 8), (512, 32), (77, 16), (200, 24), (33, 12), (384, 32),
            (128, 20), (250, 8)]
# the hybrid path: batch, prompt length and lockstep decode steps; the
# decode steps whose logits are held against a longer prefill
HYBRID_B, HYBRID_P, HYBRID_G = 4, 512, 32
CONSISTENCY_STEPS = (1, 16, 32)
# |decode logits - prefill logits| <= CONSISTENCY_RTOL * max |prefill
# logits|: the two paths round bf16 activations at different places over 38
# layers (the products run at other shapes, attention is decode_attention
# against flash_attention_xla).  Measured on an H100 at 0.020-0.031 of the
# largest logit for these inputs; the bound leaves 1.6x of that
CONSISTENCY_RTOL = 0.05
# the hybrid train path: recurrentgemma-9b at full width, depth cut from 38
# to 3 layers (one (lru, lru, local) group, 1.71 G parameters: full depth's
# AdamW state is 94 GB), B 4, S 2048 (its local window), remat on,
# deterministic mode, AdamW under warmup_cosine(3e-3, warmup 2, total 4);
# steps 1-2 run again from one seed and must agree bit for bit
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_B, HYBRID_TRAIN_S = 3, 4, 2048
HYBRID_TRAIN_STEPS, HYBRID_REPEAT_STEPS = 4, 2

# the train phase: SmolLM's published context of 2,048 tokens at batch 4
# (8,192 tokens a step), AdamW under warmup_cosine(3e-3, warmup 2, total 6),
# at TRAIN_LAYERS of the 30 layers (a 0.35 GB state; at 30, 1.35 GB, whose
# restore through the general load path took 111-131 s of the script's
# 1,000 s aim: 4 layers made room for adafactor_mesh, 2 for tp_train's
# recurrentgemma and whisper legs)
TRAIN_B, TRAIN_S = 4, 2048
TRAIN_LAYERS = 2
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 6, 2, 5
TRAIN_LR, TRAIN_WARMUP = 3e-3, 2
# |vjp grad - plain grad| <= VJP_ATOL + VJP_RTOL * |plain grad|: the
# Function's gradients (the backward kernel) against autograd through the
# blocked bf16 path on the same (q, k, v, dO); the bound is the attention
# kernel's bf16 tolerance
VJP_ATOL = VJP_RTOL = 2e-2

# the fem phase: a P4 Lagrange function on tri_mesh_fast(512, 512) (1.57 M
# entities, 4.2 M DoFs, the share of 4 of the paper's 8,192 processes),
# saved from 8 simulated ranks at 3 time indices, loaded on 1 and on 3
FEM_NX = FEM_NY = 512
FEM_DEGREE = 4
FEM_SAVE_RANKS = 8
FEM_LOAD_RANKS = (1, 3)
FEM_TIMES = 3
# the postprocess phase sweeps these arrays of the train phase's run B;
# run A's state after this step is the reference for that step
SWEEP_ARRAYS = ("params/embed", "params/final_norm")
SWEEP_CHECK_A = 2
# the elastic phase: smollm-135m at full width with its depth cut to 1
# layer (31.9 M parameters, 28.3 M of them the embedding; 2 layers until
# tp_train's recurrentgemma and whisper legs needed the time), B 4, S 256,
# AdamW under warmup_cosine(3e-3, warmup 2, total 4), a save every 2 steps.
# The meshes of its three legs, the store ops rank 0's writer completes
# before the fault store kills it, and how long a collective waits for a
# peer (rank 0 alone runs a restore's engine, tens of seconds, while the
# others wait)
ELASTIC_LAYERS, ELASTIC_B, ELASTIC_S, ELASTIC_STEPS = 1, 4, 256, 4
ELASTIC_MESH_N, ELASTIC_MESH_CARD, ELASTIC_MESH_M = (2, 2), (1, 1), (1, 2)
ELASTIC_KILL_AFTER_OPS = 4
ELASTIC_PG_TIMEOUT = 900
# the MoE path: granite-moe-3b-a800m at full width and depth (40 experts
# padded to 48, top-8) served through the launcher's step builders at B 4,
# prompt 512, 32 decode steps; its KV cache saved as 4 ranks and restored
# on this card, then MOE_STATE_DECODE decode steps from it; one MoE layer
# checked against the dense oracle at capacity factor E on MOE_LAYER_B x
# MOE_LAYER_S tokens (the oracle's one-hot dispatch is [B, S, E, C])
MOE_B, MOE_P, MOE_G = 4, 512, 32
# granite served at MOE_SERVE_LAYERS of its 32 layers (its
# cache's 4 -> 1 restore took 32-35 s of the script at 32 on one H100; tp_train's
# recurrentgemma and whisper legs needed the time)
MOE_SERVE_LAYERS = 8
MOE_STATE_DECODE = 8
MOE_LAYER_B, MOE_LAYER_S = 4, 128
# |EP - dense oracle| <= MOE_RTOL * max |dense| for that layer in bf16: the
# oracle sums a token's weighted expert outputs in one product over (E, C),
# the EP path gathers them and sums over top_k; the bf16 tolerance
MOE_RTOL = 2e-2
# the MoE train path: granite at full width with its depth cut from 32 to 2
# layers, B 4, S 1024, AdamW under warmup_cosine(3e-3, warmup 2, total 4),
# deterministic mode, through the sharded step on a (1, 1) NCCL mesh; steps
# 1-2 run again from one seed and must agree with the first run bit for bit
MOE_TRAIN_LAYERS, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS = 2, 4, 1024, 4
MOE_REPEAT_STEPS = 2
# the dense family: qwen3-4b and qwen2-vl-7b (its embeddings input) at full
# width and depth served through the launcher's serve_batch at B 4, prompt
# 512, DENSE_G decode steps
DENSE_ARCHS = ("qwen3_4b", "qwen2_vl_7b")
DENSE_B, DENSE_P, DENSE_G = 4, 512, 32
# gemma2-2b past its 4,096-token window: B 1, a prompt of 4,608, WINDOW_G
# decode steps; the first step's logits held to one prefill of P + 1
# within WINDOW_RTOL of the logits' scale (bf16's 2e-2), same argmax
WINDOW_B, WINDOW_P, WINDOW_G = 1, 4608, 16
WINDOW_RTOL = 2e-2
# the same step for the same weights in f32 within WINDOW_F32_RTOL, and
# the step with the local layers' window dropped outside it: measured on an
# H100 at 2.8e-6 and 1.9e-2 (in bf16 0.0141 and 0.0317, too close to hold
# a window fault by)
WINDOW_F32_RTOL = 1e-4
# qwen2-vl-7b's KV cache after a B 2, prompt-512 prefill into 520 slots,
# saved as 4 ranks and restored on this card; VLM_STATE_DECODE decode steps
# from the restored cache and from the original
VLM_STATE_B, VLM_STATE_P, VLM_STATE_LEN, VLM_STATE_DECODE = 2, 512, 520, 8
# xlstm-350m at full size served through the launcher's serve_batch at B 4,
# prompt 512, XLSTM_G decode steps; decode step g against one prefill of
# the prompt and g tokens within XLSTM_RTOL of the logits' scale, same
# argmax.  In bf16 the two paths round activations at other places over
# 24 layers (the chunkwise mLSTM against its one-step form, products at
# other shapes): measured on an H100 at 0.038-0.040 of the largest logit
# (an initial 2e-2 did not hold), so the limit is 2x that; the same step
# for the same weights in f32 is held within XLSTM_F32_RTOL
XLSTM_B, XLSTM_P, XLSTM_G = 4, 512, 32
# served (and its state restarted) at XLSTM_SERVE_LAYERS of its 24 layers
# (four mLSTM/sLSTM pairs; tp_train's new legs needed the time)
XLSTM_SERVE_LAYERS = 8
XLSTM_RTOL = 0.08
XLSTM_F32_RTOL = 1e-4
# its O(1) serving state after a B 2, prompt-512 prefill (101 MB, 12 mLSTM
# matrix memories of [2, 4, 512, 512] f32) saved as 4 ranks, restored on
# this card; XLSTM_STATE_DECODE decode steps from each, logits bit-equal
XLSTM_STATE_B, XLSTM_STATE_DECODE = 2, 8
# trained at full width (353.8 M parameters at 24 layers, a 3.54 GB AdamW
# state; XLSTM_TRAIN_LAYERS of them here), B 4,
# S 512, deterministic mode: XLSTM_TRAIN_STEPS steps and steps 1-2 again
# bit-equal; then the kill and resume at XLSTM_RESUME_LAYERS (one
# mLSTM/sLSTM pair at full width, a 0.767 GB state: the general restore
# path reads 0.011-0.018 GiB/s, so the full state would take minutes)
XLSTM_TRAIN_B, XLSTM_TRAIN_S = 4, 512
XLSTM_TRAIN_STEPS, XLSTM_REPEAT_STEPS = 4, 2
XLSTM_RESUME_LAYERS = 2
# the repeated steps at full width run XLSTM_TRAIN_LAYERS of the 24 layers
# (one mLSTM/sLSTM pair; at 24 they took some 100 s of the script's
# 1,000 s aim, which adafactor_mesh needed)
XLSTM_TRAIN_LAYERS = 2
# whisper-base at full size (83.2 M parameters, seeded bf16): B 4, a
# decoder prompt of 32 tokens over 1,500 encoder frames (the config's
# encoder_seq, 30 s of audio), 32 decode steps through the launcher's
# serve_batch; decode step g against one prefill of the prompt and g
# tokens within WHISPER_RTOL of the logits' scale, same argmax (bf16: the
# two paths round at other places over 6 decoder layers; the hybrid's
# 0.05), and in f32 for the same weights within WHISPER_F32_RTOL
WHISPER_B, WHISPER_P, WHISPER_G = 4, 32, 32
# served (and its cache restarted) at WHISPER_SERVE_LAYERS encoder and
# decoder layers of its 6 + 6 (the cache's 4 -> 1 restore took
# 17 s at 6 + 6 on one H100; tp_train's whisper leg serves all 6 + 6)
WHISPER_SERVE_LAYERS = 2
WHISPER_RTOL = 0.05
WHISPER_F32_RTOL = 1e-4
# its serving cache (k, v at P + G slots, the cross K/V at 1,500 frames,
# length) saved as 4 ranks, restored on this card; WHISPER_STATE_DECODE
# decode steps from it
WHISPER_STATE_DECODE = 8
# trained at full size at its published contexts (decoder 448 tokens,
# encoder 1,500 frames), B 4, AdamW, remat: 4 steps and steps 1-2 again
# bit-equal; then runs A, B and C as in ``train`` at WHISPER_RESUME_LAYERS
# (encoder and decoder layers; None: the full 6 + 6)
WHISPER_TRAIN_B, WHISPER_TRAIN_S = 4, 448
WHISPER_TRAIN_STEPS, WHISPER_REPEAT_STEPS = 4, 2
WHISPER_RESUME_LAYERS = 1
# kimi-k2 at full width with its depth cut from 61 layers to 1 (384
# experts top-8, d_ff_expert 2,048, 64 heads over 8 kv heads at hd 128,
# untied vocabulary 163,840: 19.4 G parameters, 38.8 GB of seeded bf16),
# attention through the flash kernel, every MoE layer ``moe_ffn_ep``:
# B 4, prompt 512, 32 decode steps; the EP layer against the dense oracle
# on KIMI_LAYER_B x KIMI_LAYER_S tokens (the oracle's expert buffers at
# capacity factor E are [E, B, S * top_k, D]); its KV cache 4 -> 1 and
# KIMI_STATE_DECODE decode steps from it
KIMI_SERVE_LAYERS = 1
KIMI_B, KIMI_P, KIMI_G = 4, 512, 32
KIMI_LAYER_B, KIMI_LAYER_S = 1, 32
KIMI_STATE_DECODE = 8
# trained with Adafactor at 1 layer of full width with the experts cut
# from 384 to KIMI_TRAIN_EXPERTS (top-8 and every width kept: 384 experts'
# parameters and gradients alone are 67.6 GB), B 4, S 1,024, remat: 4
# steps and steps 1-2 again bit-equal; the kill and resume of an Adafactor
# state at kimi-k2's smoke config (the cut state, about 10.6 GB, would
# take some 15 minutes on the general restore path)
KIMI_TRAIN_EXPERTS = 64
KIMI_TRAIN_B, KIMI_TRAIN_S = 4, 1024
KIMI_TRAIN_STEPS, KIMI_REPEAT_STEPS = 4, 2
# Adafactor's step is relative, lr x RMS(p) (the reference's ``scale``),
# and its first steps move each row of a matrix nearly as one, so the
# logits move with the width: at d_model 7,168 base 0.005 (larger rates
# overshoot within 4 steps), at the smoke config's 64 base 0.1 (smaller
# ones do not move its loss past the batches' noise in 6 steps)
KIMI_TRAIN_LR, KIMI_RESUME_LR = 0.005, 0.1
KIMI_RESUME_B, KIMI_RESUME_S = 4, 64
# serving on a mesh: smollm-135m at full width (d_model 576, 9 heads over
# 3 kv heads) with its depth cut to 2 of 30 layers; 4 CPU processes (gloo,
# mesh (2, 2)) prefill B 4 prompts of 64 tokens and decode 16 steps with
# the KV cache's sequence dim split over the model axis, then save it as
# one checkpoint rank per process; the card (one NCCL process, mesh (1,
# 1)) restores it and decodes SERVE_MESH_CARD_G more steps, so the cache
# holds P + G + SERVE_MESH_CARD_G positions
SERVE_MESH_LAYERS, SERVE_MESH_B, SERVE_MESH_P, SERVE_MESH_G = 2, 4, 64, 16
SERVE_MESH_N, SERVE_MESH_CARD = (2, 2), (1, 1)
SERVE_MESH_CARD_G = 8
SERVE_MESH_TIMEOUT = 600
# tensor-parallel training on a mesh of processes that share the card:
# smollm-135m at full width, 1 of its 30 layers (2 until the
# recurrentgemma and whisper legs below needed the time), B 4, S 2048,
# bf16, remat,
# deterministic mode, on a (1, 3) mesh (each process holds one kv head and
# its 3 query heads, 512 of the MLP's 1,536 columns and 16,384 of the
# vocab); TP_STEPS steps, held to the one-process card steps from the same
# seed within tests/test_torch_mesh_train.py's bf16 tolerances
# (tests/helpers/torch_tp_workers.py's CARD_RTOL)
TP_MESH, TP_LAYERS, TP_B, TP_S, TP_STEPS = (1, 3), 1, 4, 2048, 3
TP_TIMEOUT = 600
# the same phase's legs for the recurrent hybrid and the encoder-decoder,
# on a (1, 4) mesh (16 heads and an RG-LRU width of 4,096 do not split 3
# ways): recurrentgemma-9b at full width, 3 of its 38 layers (one (lru,
# lru, local) group), each process with 4 of the 16 query heads (one kv
# head, whole), 1,024 of the 4,096 RG-LRU channels (its scan runs on
# [B, S, 1,024]), a quarter of the MLP and 64,000 vocab rows; B 1, S 512
# (the model axis's bytes, counted on meta by launch/dryrun.py::count_step:
# 196 MB a step per process, some 0.6 s at gloo's measured rate); and
# whisper-base at full width, 2 + 2 of its 6 + 6 layers since the xLSTM
# leg needed the time (6 + 6 until then), B 4, S 448 over 1,500 frames,
# each process with 2 of the 8 heads and kv heads and a quarter of the
# MLP.  The legs share one spawn.  Each: TP_STEPS steps
# in f32 held to the one-process f32 steps within CARD_RTOL_F32 (in bf16
# the two runs' roundings alone reach CARD_RTOL's limits at full width),
# repeated bit-equal; a bf16 prefill of its P tokens (inside the hybrid's
# 2,048 window) and TP_FAMILY_G decode steps on local heads and channels,
# within the model's LOGITS_RTOL of one process's with the same greedy
# tokens; the smoke config's sharded state restored 4 -> 1 (the full
# state's general load would take minutes)
# xlstm-350m joins them at full width and 2 of 24 layers (one mLSTM/sLSTM
# pair), B 1, S 512: each process holds 512 of the 2,048 inner columns,
# 1,024 of the 4,096 gate columns, 256 of w_out's 1,024 rows and 12,576 of
# the 50,304 vocab rows; q, k, v and the gates are summed whole and each
# cell (the chunkwise mLSTM, the sLSTM time loop) runs whole on every
# process, as the rule table keeps the heads and the state whole
TP_FAMILY_MESH, TP_FAMILY_G = (1, 4), 8
TP_FAMILY = {"recurrentgemma_9b": {"layers": 3, "B": 1, "S": 512, "P": 512},
             "whisper_base": {"layers": 2, "B": 4, "S": 448, "P": 32},
             "xlstm_350m": {"layers": 2, "B": 1, "S": 512, "P": 512}}
# the TP decode's logits against one process's: the limits this script
# holds these models' bf16 logits to already (decode against prefill)
LOGITS_RTOL.update({"recurrentgemma-9b": CONSISTENCY_RTOL,
                    "whisper-base": WHISPER_RTOL,
                    "xlstm-350m": XLSTM_RTOL})
# Adafactor on a sharded mesh: kimi_train's model (kimi-k2 at full width,
# 1 layer, KIMI_TRAIN_EXPERTS experts top-8, EP, bf16, remat) on a (1, 4)
# mesh of processes that share the card over gloo (each with 16 query and
# 2 kv heads, 16 experts and 40,960 vocab rows); each process builds its
# box of the seeded state, serves B 4 prompts of ADA_P tokens and ADA_G
# decode steps on its local heads (fed the one-process run's tokens), and
# trains ADA_STEPS steps under kimi_train's schedule, held to kimi_train's
# own first ADA_STEPS steps within CARD_RTOL; steps 1..ADA_REPEAT again
# bit-equal; the smoke config's sharded Adafactor state saved by the 4
# processes restores 4 -> 1 on the card bit-equal
ADA_MESH, ADA_STEPS, ADA_REPEAT = (1, 4), 3, 2
ADA_P, ADA_G = 512, 8
ADA_TIMEOUT = 600
# Adafactor's steps at kimi_train's rate move most bf16 weights by about
# one spacing of their value over 3 steps (the median element of every
# matrix moves 1), so the two runs' last-bit differences decide which way
# each rounds: a parameter's update is held over the elements that move at
# least ADA_MIN_CHANGE_ULPS spacings, where a flipped rounding is at most
# an eighth of the change (the whole update's 2-norm is reported beside)
ADA_MIN_CHANGE_ULPS = 8


def tp_heads(cfg) -> tuple[int, int, int]:
    """(Hq, Hkv, hd) of one ``tp_train`` process's attention: smollm's 9
    query and 3 kv heads over the model axis of TP_MESH."""
    m = TP_MESH[1]
    return cfg.num_heads // m, cfg.num_kv_heads // m, cfg.head_dim_


def tp_scan_shape() -> tuple[int, int, int]:
    """[B, S, W / m] of one ``tp_train`` recurrentgemma process's scans:
    its step's and its prefill's (S and P are equal), on its share of the
    RG-LRU width over the model axis of TP_FAMILY_MESH."""
    from repro_torch.configs import get_config

    leg = TP_FAMILY["recurrentgemma_9b"]
    assert leg["S"] == leg["P"]
    return (leg["B"], leg["S"],
            get_config("recurrentgemma_9b").lru_width // TP_FAMILY_MESH[1])


def ada_heads() -> tuple[int, int, int]:
    """(Hq, Hkv, hd) of one ``adafactor_mesh`` process's attention:
    kimi-k2's 64 query and 8 kv heads over the model axis of ADA_MESH."""
    from repro_torch.configs import get_config

    kimi, m = get_config("kimi_k2_1t_a32b"), ADA_MESH[1]
    return kimi.num_heads // m, kimi.num_kv_heads // m, kimi.head_dim_


#: the script's start on the host clock: each phase's line carries its
#: ``at_seconds`` since then
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_seconds": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3,
            flush_mb: int = FLUSH_MB) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each (a cold caller) by writing
    ``flush_mb`` MB."""
    flush = torch.empty(flush_mb << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def host_ms(fn, iters: int = 100, rounds: int = 5) -> dict:
    """Per-call times in ms of ``fn`` called ``iters`` times back to back,
    L2 warm, in ``rounds`` loops (median and least over the loops):
    ``enqueue_ms``, the host's wall time to issue one call (the calls are
    asynchronous, so the card does not hold the host back), and
    ``back_to_back_ms``, the card's span of a loop over ``iters``: the
    larger of the host's issue time and the device's run time, which is
    what a caller launching ``fn`` in a loop gets."""
    fn()
    enqueue, span = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue.append((time.perf_counter() - t0) * 1e3 / iters)
        b.record()
        torch.cuda.synchronize()
        span.append(a.elapsed_time(b) / iters)
    return {"enqueue_ms": float(np.median(enqueue)),
            "enqueue_min_ms": min(enqueue),
            "back_to_back_ms": float(np.median(span)),
            "back_to_back_min_ms": min(span)}


def _counter():
    """(zero, read, launches): ``zero()`` sets every kernel's launch count
    to 0, ``read()`` returns the counts and adds them to ``launches``."""
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops

    launches = {"ckpt_pack": 0, "flash_attention": 0, "rglru_scan": 0,
                "flash_attention_bwd": 0}

    def zero():
        pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
        attn_ops.bwd_launches = 0

    def read():
        got = {"ckpt_pack": pack_ops.launches,
               "flash_attention": attn_ops.launches,
               "rglru_scan": scan_ops.launches,
               "flash_attention_bwd": attn_ops.bwd_launches}
        for k, n in got.items():
            launches[k] += n
        return got

    return zero, read, launches


# ------------------------------------------------------------------ device
def phase_device() -> str:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return line


# ------------------------------------------------------------------- build
def phase_build() -> None:
    from repro_torch.kernels import build

    res = build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "arning" in ln]
             for name, log in res["ptxas"].items()}
    # warpgroup MMA compiled in: HGMMA instructions in the flash library
    sass = subprocess.run(
        [str(Path(build.nvcc()).parent / "cuobjdump"), "-sass",
         str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=120).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    emit({"phase": "build", "seconds": res["seconds"], "built": res["built"],
          "ptxas": ptxas, "flash_attention_hgmma": hgmma})
    if not hgmma:
        raise AssertionError("no HGMMA instruction in the flash_attention "
                             "library: wgmma was not compiled in")


# ----------------------------------------------------------------- kernels
def _pairs(Sq: int, Sk: int, q_offset: int, causal: bool, window: int) -> int:
    """Query-key pairs the mask keeps (the attention's real work)."""
    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_ckpt_pack(params, layout, ownership) -> dict:
    from repro_torch.core.torch_io import chunk_major
    from repro_torch.kernels.ckpt_pack.ops import pack_chunks
    from repro_torch.kernels.ckpt_pack.ref import ckpt_pack_ref

    worst, checks = 0, 0

    def compare(src, idx):
        nonlocal worst, checks
        got = pack_chunks(src, idx)
        want = ckpt_pack_ref(src, torch.as_tensor(idx))
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"ckpt_pack differs from its plain version "
                                 f"at src {tuple(src.shape)} {src.dtype}")
        worst = max(worst, int((got.view(torch.uint8).int()
                                - want.view(torch.uint8).int()).abs().max())
                    if got.numel() else 0)
        checks += 1

    # the issue's cases: w_gate's and embed's chunk-major views, repeated
    # and -1 indices, in bf16, f32 and int32
    rng = np.random.default_rng(SEED)
    for name in ("w_gate", "embed"):
        spec = layout.spec(name)
        for dtype in (torch.bfloat16, torch.float32, torch.int32):
            src = chunk_major(params[name].to(dtype), spec.chunk_shape)
            n = src.shape[0]
            idx = np.concatenate([rng.integers(-1, n, size=n // 4),
                                  [n - 1, n - 1, -1, 0]]).astype(np.int32)
            compare(src, idx)
    # every pack call of the main path: each rank's owned chunks of each
    # array, as the byte view the save packs
    calls = []
    for rank_own in ownership:
        for name, ords in rank_own.items():
            src = chunk_major(params[name],
                              layout.spec(name).chunk_shape).view(torch.uint8)
            compare(src, ords)
            calls.append((src.shape[1] * src.shape[2] * len(ords), name, src,
                          ords))
    # time the largest call of the main path: kernel and index_select in
    # turns over PACK_ROUNDS rounds, to see their spread beside their gap,
    # with each flush
    nbytes, name, src, ords = max(calls, key=lambda c: c[0])
    idx_dev = torch.as_tensor(ords, dtype=torch.int32, device="cuda")
    idx_long = idx_dev.long()
    times = {(who, mb): [] for who in ("kernel", "library")
             for mb in (FLUSH_MB, SHORT_FLUSH_MB)}
    for _ in range(PACK_ROUNDS):
        for mb in (FLUSH_MB, SHORT_FLUSH_MB):
            times["kernel", mb].append(
                time_ms(lambda: pack_chunks(src, idx_dev), flush_mb=mb))
            times["library", mb].append(time_ms(
                lambda: torch.index_select(src, 0, idx_long), flush_mb=mb))
    plain_ms = time_ms(lambda: ckpt_pack_ref(src, idx_dev))
    kernel, library = times["kernel", FLUSH_MB], times["library", FLUSH_MB]

    def spread(xs):
        return {"min": min(xs), "median": float(np.median(xs)),
                "max": max(xs), "rounds": xs}

    def rounds(mb):
        ks, ls = times["kernel", mb], times["library", mb]
        return {"flush_mb": mb, "kernel_ms": spread(ks),
                "index_select_ms": spread(ls),
                "kernel_over_index_select": spread(
                    [a / b for a, b in zip(ks, ls)])}
    return {"name": "ckpt_pack", "route": "cuda",
            "source": "repro_torch/kernels/ckpt_pack/kernel.cu",
            "replaces": "src/repro/kernels/ckpt_pack/kernel.py:40",
            "max_abs_err": float(worst), "ms": float(np.median(kernel)),
            "plain_ms": plain_ms,
            "bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": float(np.median(library)),
            "rounds": rounds(FLUSH_MB),
            "rounds_short_flush": rounds(SHORT_FLUSH_MB),
            "checks": checks, "timed_at": {
                "array": name, "src": list(src.shape), "chunks": len(ords),
                "bytes_moved": 2 * nbytes}}


def _sdpa(q, k, v, backend, ruler=time_ms):
    """The library yardstick: ``ruler`` (``time_ms`` or ``host_ms``) of one
    SDPA call on the same [B, S, H, hd] tensors (GQA by ``enable_gqa``),
    pinned to ``backend``; None if the backend refuses the shape."""
    from torch.nn.attention import sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with sdpa_kernel(backend):
        try:
            return ruler(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        except RuntimeError:
            return None


def check_flash_attention(cfg) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(B, Sq, Sk, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
            hd=cfg.head_dim_):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        return rnd(B, Sq, Hq, hd), rnd(B, Sk, Hkv, hd), rnd(B, Sk, Hkv, hd)

    # the hd 128 case: B 4, S 2048, 16 query and 8 kv heads
    HD128 = (4, 2048, 16, 8, 128)
    # granite-moe-3b-a800m's heads (24 query, 8 kv, hd 64) at its serving
    # prefill (B 4, S 512) and its train step (B 4, S 1024)
    GRANITE = [(MOE_B, MOE_P, 24, 8, 64), (MOE_TRAIN_B, MOE_TRAIN_S, 24, 8, 64)]
    # qwen3-4b's and qwen2-vl-7b's heads (hd 128; qwen2-vl's odd group, 28
    # query heads over 4 kv heads) at their serving prefill (B 4, S 512),
    # and qwen2-vl's at the vlm_state prefill (B 2, S 512)
    DENSE = [(DENSE_B, DENSE_P, c.num_heads, c.num_kv_heads, c.head_dim_)
             for c in map(get_config, DENSE_ARCHS)]
    vl = get_config("qwen2_vl_7b")
    VLM = [(VLM_STATE_B, VLM_STATE_P, vl.num_heads, vl.num_kv_heads,
            vl.head_dim_)]
    cases = [
        # B, Sq, Sk, q_offset, window, softcap, (Hq, Hkv, hd)
        (4, 2048, 2048, 0, 0, 0.0, ()),    # the slice's prefill shape
        (4, 1000, 1000, 0, 0, 0.0, ()),    # ragged edges
        (2, 300, 1324, 1024, 0, 0.0, ()),  # q_offset continuation
        (1, 700, 700, 0, 256, 0.0, ()),    # sliding window
        (1, 333, 333, 0, 0, 50.0, ()),     # logit softcap
        (ELASTIC_B, ELASTIC_S, ELASTIC_S, 0, 0, 0.0, ()),  # the elastic step
        (TP_B, TP_S, TP_S, 0, 0, 0.0, tp_heads(cfg)),  # a tp_train process
        # an adafactor_mesh process: its train step and its prefill
        (KIMI_TRAIN_B, KIMI_TRAIN_S, KIMI_TRAIN_S, 0, 0, 0.0, ada_heads()),
        (KIMI_TRAIN_B, ADA_P, ADA_P, 0, 0, 0.0, ada_heads()),
        (HD128[0], HD128[1], HD128[1], 0, 0, 0.0, HD128[2:]),
    ] + [(B, S, S, 0, 0, 0.0, h) for B, S, *h in GRANITE + DENSE + VLM] + [
        (1, P, P, 0, 0, 0.0, ()) for P in sorted({p for p, _ in REQUESTS})]
    worst, results = 0.0, []
    for B, Sq, Sk, qoff, win, cap, heads in cases:
        q, k, v = qkv(B, Sq, Sk, *heads)
        got = flash_attention(q, k, v, causal=True, window=win, softcap=cap,
                              q_offset=qoff).float()
        want = attention_ref(q, k, v, causal=True, window=win, softcap=cap,
                             q_offset=qoff).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bad = int((err > ATTN_ATOL + ATTN_RTOL * want.abs()).sum())
        worst = max(worst, float(err.max()))
        results.append({"shape": [B, Sq, Sk], "heads": list(q.shape[2:3])
                        + list(k.shape[2:]), "q_offset": qoff,
                        "window": win, "softcap": cap,
                        "max_abs_err": float(err.max()), "outside_tol": bad})
        if bad or not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention outside tolerance: "
                                 f"{results[-1]}")
        del q, k, v, got, want, err

    def timed(B, S, Hq, Hkv, hd, plain=False):
        """Kernel, SDPA and (optionally) plain times at one causal shape,
        with the bound of its work."""
        from torch.nn.attention import SDPBackend

        q, k, v = qkv(B, S, S, Hq, Hkv, hd)
        backends = {b.name: b for b in (SDPBackend.FLASH_ATTENTION,
                                        SDPBackend.CUDNN_ATTENTION)}
        sdpa = {name: _sdpa(q, k, v, b) for name, b in backends.items()}
        fastest = min((b for b in sdpa if sdpa[b] is not None),
                      key=sdpa.get)
        ops = 4 * B * Hq * hd * _pairs(S, S, 0, True, 0)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3

        def kernel():
            return flash_attention(q, k, v, causal=True)

        line = {"shape": [B, S, S, Hq, Hkv, hd], "ms": time_ms(kernel),
                "ms_short_flush": time_ms(kernel, flush_mb=SHORT_FLUSH_MB),
                "host": host_ms(kernel),
                "library_ms": sdpa[fastest], "library": f"SDPA ({fastest})",
                "sdpa_ms_by_backend": sdpa,
                "library_host": _sdpa(q, k, v, backends[fastest], host_ms),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": ops}
        line["tflops"] = ops / line["ms"] * 1e-9
        if plain:
            line["plain_ms"] = time_ms(
                lambda: attention_ref(q, k, v, causal=True), iters=5)
        return line

    # the slice's prefill shape, the main path's longest prompt (one
    # request's prefill) and the hd 128 case
    main = timed(4, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                 plain=True)
    P = max(p for p, _ in REQUESTS)
    longest = timed(1, P, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
    hd128 = timed(*HD128)
    granite = [timed(*shape) for shape in GRANITE]
    dense = dict(zip(DENSE_ARCHS, (timed(*shape) for shape in DENSE)))
    return {"name": "flash_attention", "route": "cuda",
            "source": "repro_torch/kernels/flash_attention/kernel.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:96",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed_at": main, "at_longest_prompt": longest, "hd128": hd128,
            "granite": granite, "dense": dense,
            "tolerance": {"atol": ATTN_ATOL, "rtol": ATTN_RTOL},
            "cases": results}


def _sdpa_bwd(q, k, v, do, backend):
    """(ms, how): ``time_ms`` of SDPA's backward alone (autograd through
    one causal forward kept by ``retain_graph``), pinned to ``backend``, on
    contiguous [B, H, S, hd] copies of the same tensors; ``how`` is
    ``enable_gqa``, or ``expanded`` where the backend refuses GQA and k and
    v are repeated G times (their gradients then summed by autograd);
    (None, None) if the backend refuses both."""
    from torch.nn.attention import sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt, dot = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    G = q.shape[2] // k.shape[2]
    for how in ("enable_gqa", "expanded"):
        ins = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        try:
            with sdpa_kernel(backend):
                if how == "enable_gqa":
                    out = sdpa(*ins, is_causal=True, enable_gqa=True)
                else:
                    out = sdpa(ins[0], ins[1].repeat_interleave(G, 1),
                               ins[2].repeat_interleave(G, 1), is_causal=True)
                return time_ms(lambda: torch.autograd.grad(
                    out, ins, dot, retain_graph=True)), how
        except RuntimeError:
            continue
    return None, None


def check_flash_attention_bwd(cfg) -> dict:
    """The attention backward kernel (``flash_attention_bwd``, from the
    forward kernel's o and log-sum-exp) against ``attention_bwd_ref`` on
    the same tensors, at smollm's train step, one ``tp_train`` process's
    heads (3 query over 1 kv), granite's, qwen3-4b's heads
    (hd 128), a ragged case with window, softcap and q_offset, and
    kimi_train's (hd 128, 64 query heads over 8); the
    forward's log-sum-exp against ``attention_lse_ref``'s; two launches
    bit-equal; its time beside its bound, the plain version's and SDPA's
    backward's, the forward's time with and without the log-sum-exp, and,
    printed per timed shape, each pass's blocks and the schedule taken."""
    from torch.nn.attention import SDPBackend

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                          attention_lse_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    qwen = get_config("qwen3_4b")
    kimi = get_config("kimi_k2_1t_a32b")
    cases = [
        # B, Sq, Sk, Hq, Hkv, hd, q_offset, window, softcap
        (TRAIN_B, TRAIN_S, TRAIN_S, cfg.num_heads, cfg.num_kv_heads,
         cfg.head_dim_, 0, 0, 0.0),                      # smollm's step
        (TP_B, TP_S, TP_S, *tp_heads(cfg), 0, 0, 0.0),  # a tp_train process
        (MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_S, 24, 8, 64, 0, 0, 0.0),
        (1, 512, 512, qwen.num_heads, qwen.num_kv_heads, qwen.head_dim_,
         0, 0, 0.0),                                     # hd 128
        (2, 333, 433, 9, 3, 64, 100, 256, 50.0),         # ragged, all three
        (KIMI_TRAIN_B, KIMI_TRAIN_S, KIMI_TRAIN_S, kimi.num_heads,
         kimi.num_kv_heads, kimi.head_dim_, 0, 0, 0.0),  # kimi_train, G 8
        (KIMI_TRAIN_B, KIMI_TRAIN_S, KIMI_TRAIN_S, *ada_heads(), 0, 0,
         0.0),                                 # an adafactor_mesh process
    ]
    results, worst = [], 0.0
    for B, Sq, Sk, Hq, Hkv, hd, qoff, win, cap in cases:
        kw = dict(causal=True, window=win, softcap=cap, q_offset=qoff)
        q, k, v, do = (rnd(B, Sq, Hq, hd), rnd(B, Sk, Hkv, hd),
                       rnd(B, Sk, Hkv, hd), rnd(B, Sq, Hq, hd))
        o, lse = attn_ops.flash_attention_fwd_lse(q, k, v, **kw)
        got = attn_ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        lse_nat = lse / attn_ops.LOG2E
        want = attention_bwd_ref(*(t.float() for t in (q, k, v, o)),
                                 lse_nat, do.float(), **kw)
        lse_ref = attention_lse_ref(q, k, v, **kw)[1]
        torch.cuda.synchronize()
        line = {"shape": [B, Sq, Sk, Hq, Hkv, hd], "q_offset": qoff,
                "window": win, "softcap": cap,
                "lse_max_abs_err": float((lse_nat - lse_ref).abs().max()),
                "lse_outside_tol": int(((lse_nat - lse_ref).abs()
                                        > LSE_TOL * (1 + lse_ref.abs()))
                                       .sum())}
        bad = line["lse_outside_tol"]
        for name, x, y in zip(("dq", "dk", "dv"), got, want):
            err = float((x.float() - y).abs().max())
            scale = float(y.abs().max())
            line[name] = {"max_abs_err": err, "max_abs": scale}
            worst = max(worst, err)
            bad += err > ATTN_BWD_TOL * scale or not bool(
                torch.isfinite(x).all())
        results.append(line)
        if bad:
            raise AssertionError(f"flash_attention_bwd outside tolerance: "
                                 f"{line}")
        del q, k, v, do, o, lse, got, want, lse_ref

    def timed(B, S, Hq, Hkv, hd, plain=False):
        q, k, v, do = (rnd(B, S, Hq, hd), rnd(B, S, Hkv, hd),
                       rnd(B, S, Hkv, hd), rnd(B, S, Hq, hd))
        o, lse = attn_ops.flash_attention_fwd_lse(q, k, v)
        runs = [attn_ops.flash_attention_bwd(q, k, v, o, lse, do)
                for _ in range(2)]
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(*runs))
        del runs
        sdpa = {b.name: _sdpa_bwd(q, k, v, do, b)
                for b in (SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION)}
        fastest = min((b for b in sdpa if sdpa[b][0] is not None),
                      key=lambda b: sdpa[b][0], default=None)
        # five products of 2 * hd operations a pair and head
        ops = 10 * B * Hq * hd * _pairs(S, S, 0, True, 0)
        # read q, k, v, o, dO and lse; write dq, dk and dv
        nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        line = {"shape": [B, S, S, Hq, Hkv, hd],
                "ms": time_ms(lambda: attn_ops.flash_attention_bwd(
                    q, k, v, o, lse, do)),
                "two_launches_bit_equal": repeat,
                "forward_ms": time_ms(lambda: attn_ops.flash_attention(
                    q, k, v)),
                "forward_lse_ms": time_ms(
                    lambda: attn_ops.flash_attention_fwd_lse(q, k, v)),
                "library_ms": sdpa[fastest][0] if fastest else None,
                "library": (f"SDPA backward ({fastest}, {sdpa[fastest][1]})"
                            if fastest else None),
                "sdpa_bwd_ms_by_backend": sdpa,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": ops, "bytes_moved": nbytes}
        line["tflops"] = ops / line["ms"] * 1e-9
        # the kernel's schedule at this shape: each pass's blocks (one an
        # SM at a time) in waves of this card's SMs, its heaviest block and
        # the mean work of an SM in items
        plan = attn_ops.bwd_plan(B, S, S, Hq, Hkv, hd)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        line["schedule"] = {
            "dq_pass": {"blocks": plan["dq_blocks"],
                        "waves": plan["dq_blocks"] / sms,
                        "heaviest_items": plan["dq_heaviest"],
                        "mean_items_per_sm": plan["dq_items"] / sms},
            "dkdv_pass": {"blocks": plan["dkdv_blocks"],
                          "waves": plan["dkdv_blocks"] / sms,
                          "heaviest_items": plan["dkdv_heaviest"],
                          "mean_items_per_sm": plan["dkdv_items"] / sms,
                          "chunk_bound_items": plan["chunk"],
                          "split_key_blocks": plan["split_key_blocks"],
                          "of_key_blocks": plan["key_blocks"]},
            "sum_pass": {"blocks": plan["sum_blocks"]}, "sms": sms,
            "plan_sms": plan["sms"]}
        emit({"phase": "kernels", "kernel": "flash_attention_bwd",
              "shape": line["shape"], "ms": line["ms"],
              "schedule": line["schedule"]})
        if plain:
            line["plain_ms"] = time_ms(lambda: attention_bwd_ref(
                q, k, v, o, lse / attn_ops.LOG2E, do), iters=3)
        if not repeat:
            raise AssertionError(f"flash_attention_bwd: two launches differ "
                                 f"at {line['shape']}")
        return line

    main = timed(TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads,
                 cfg.head_dim_, plain=True)
    granite = timed(MOE_TRAIN_B, MOE_TRAIN_S, 24, 8, 64)
    hd128 = timed(1, 512, qwen.num_heads, qwen.num_kv_heads, qwen.head_dim_)
    kimi_heads = timed(KIMI_TRAIN_B, KIMI_TRAIN_S, kimi.num_heads,
                       kimi.num_kv_heads, kimi.head_dim_)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "repro_torch/kernels/flash_attention/kernel.cu",
            "replaces": "src/repro/kernels/flash_attention/ops.py:63 "
                        "(_fa_bwd: jax.vjp of the XLA path, no Pallas "
                        "kernel)",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed_at": main, "granite": granite, "hd128": hd128,
            "kimi": kimi_heads,
            "tolerance": {"of_scale": ATTN_BWD_TOL, "lse": LSE_TOL},
            "cases": results}


def check_rglru_scan(W: int) -> dict:
    from repro_torch.kernels.rglru_scan.ops import lru_scan
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def uni(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def model_gates(B, S, W):
        # the model's own range: a = exp(-8 softplus(lam) r), b scaled by
        # sqrt(1 - a^2) (models/rglru.py::_lru_gates)
        lam = rnd(W)
        a = torch.exp(-8.0 * torch.logaddexp(lam, torch.zeros_like(lam))
                      * uni(B, S, W))
        return a, torch.sqrt(1.0 - a * a) * rnd(B, S, W)

    def test_gates(B, S, W):
        # tests/test_kernels.py's range, where error accumulates most
        return 0.8 + 0.199 * uni(B, S, W), rnd(B, S, W)

    # the kernel's chunk is 64 steps and its W tile 64 columns; W % 4 != 0
    # or an unaligned base stages by cp.async, the rest by TMA
    cases = [
        # B, S, W, h0, gates, unaligned base
        (HYBRID_B, HYBRID_P, W, True, model_gates, False),  # path's prefill
        (1, 2048, W, True, model_gates, False),
        (1, 1000, W, False, model_gates, False),      # ragged S, h0 = None
        (2, 300, 1000, True, model_gates, False),     # ragged W
        (HYBRID_B, HYBRID_P, W, True, test_gates, False),
        (1, 2048, W, True, test_gates, False),
        (2, 1, W, True, model_gates, False),          # S = 1
        (2, 64, W, True, test_gates, False),          # S = one chunk
        (2, 65, W, True, test_gates, False),          # S = one chunk + 1
        (1, 4096, W, True, test_gates, False),        # 64 chunks, look-back
        # one tp_train process's channels: its train step and its prefill
        (*tp_scan_shape(), True, model_gates, False),
        (*tp_scan_shape(), True, test_gates, False),
        (2, 130, 100, True, test_gates, False),       # W % 64 != 0 (TMA)
        (2, 200, 65, True, test_gates, False),        # W % 4 != 0 (cp.async)
        (3, 200, W, False, model_gates, False),       # h0 = None, 4 chunks
        (2, 300, W, True, model_gates, True),         # unaligned (cp.async)
    ]
    worst, results = 0.0, []

    def compare(a, b, h0, h, h_last):
        want, want_last = rglru_scan_ref(a, b, h0)
        torch.cuda.synchronize()
        bad = sum(int(((got - ref).abs()
                       > SCAN_ATOL + SCAN_RTOL * ref.abs()).sum())
                  for got, ref in ((h, want), (h_last, want_last)))
        if not torch.equal(h_last, h[:, -1]):
            bad += 1
        return bad, float((h - want).abs().max()), float(want.abs().max())

    def unaligned(t):
        return torch.empty(t.numel() + 1, device="cuda")[1:].view_as(t) \
            .copy_(t)

    for B, S, Wc, with_h0, gates, shifted in cases:
        a, b = gates(B, S, Wc)
        h0 = rnd(B, Wc) if with_h0 else None
        h, h_last = (lru_scan(unaligned(a), unaligned(b), h0) if shifted
                     else lru_scan(a, b, h0))
        bad, err, top = compare(a, b, h0, h, h_last)
        worst = max(worst, err)
        results.append({"shape": [B, S, Wc], "h0": with_h0,
                        "gates": gates.__name__, "unaligned": shifted,
                        "max_abs_err": err, "max_abs_h": top,
                        "outside_tol": bad})
        if bad or not torch.isfinite(h).all():
            raise AssertionError(f"rglru_scan outside tolerance: "
                                 f"{results[-1]}")
    # calls back to back on one stream reuse the look-back scratch: each
    # must find its ticket counter and look-back words fresh
    ins = [(*test_gates(B, S, Wc), rnd(B, Wc)) for B, S, Wc in
           [(HYBRID_B, HYBRID_P, W)] * 2 + [(1, 2048, W), (2, 65, 100),
                                             (HYBRID_B, HYBRID_P, W)]]
    outs = [lru_scan(a, b, h0) for a, b, h0 in ins]
    back_to_back = [compare(*i, *o)[0] for i, o in zip(ins, outs)]
    if any(back_to_back):
        raise AssertionError(f"rglru_scan back to back outside tolerance: "
                             f"{back_to_back}")
    del ins, outs

    def timed(B, S):
        a, b = model_gates(B, S, W)
        h0 = rnd(B, W)
        h = torch.empty_like(a)
        # read a, b and h0; write h and h_last
        nbytes = 4 * (3 * B * S * W + 2 * B * W)
        return {"shape": [B, S, W], "h0": True, "bytes_moved": nbytes,
                "ms": time_ms(lambda: lru_scan(a, b, h0)),
                "plain_ms": time_ms(lambda: rglru_scan_ref(a, b, h0),
                                    iters=5),
                # the same bytes at the card's achievable rate: not the same
                # function, so not library_ms
                "ruler_add_ms": time_ms(lambda: torch.add(a, b, out=h)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    # the hybrid path's prefill shape, and one long prompt at B 1
    main, long_prompt = timed(HYBRID_B, HYBRID_P), timed(1, 2048)
    return {"name": "rglru_scan", "route": "cuda",
            "source": "repro_torch/kernels/rglru_scan/kernel.cu",
            "replaces": "src/repro/kernels/rglru_scan/kernel.py:51",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_note": "no single PyTorch call computes a first-order "
                            "linear recurrence",
            "timed_at": main, "at_b1_s2048": long_prompt,
            "tolerance": {"atol": SCAN_ATOL, "rtol": SCAN_RTOL},
            "back_to_back_calls": len(back_to_back), "cases": results}


def check_rglru_scan_vjp(W: int) -> dict:
    """The scan's gradient, ``lru_scan_vjp`` (kernel forward, kernel
    backward: the reverse mode, one launch), against autograd through the
    plain version on the same card tensors and upstream gradients, at the
    hybrid train path's shape (with h0) and a ragged one, in deterministic
    mode (the train path's: chained carries) and in default mode (the
    decoupled look-back); the reverse mode alone against
    ``lru_scan_bwd_ref`` at the same shapes in both modes; the kernel's
    bits over repeated launches in both modes and both directions, each
    launch held to the plain version; the backward's times."""
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan.ref import (lru_scan_bwd_ref,
                                                     rglru_scan_ref)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def inputs(B, S, Wc, with_h0):
        # the model's gate range (models/rglru.py::_lru_gates)
        lam = rnd(Wc)
        a = torch.exp(-8.0 * torch.logaddexp(lam, torch.zeros_like(lam))
                      * torch.rand((B, S, Wc), generator=gen, device="cuda"))
        b = torch.sqrt(1.0 - a * a) * rnd(B, S, Wc)
        return a, b, rnd(B, Wc) if with_h0 else None, rnd(B, S, Wc), \
            rnd(B, Wc)

    def graph(fn, a, b, h0, g, g_last):
        ins = [t.clone().requires_grad_(True) for t in (a, b, h0)
               if t is not None]
        h, h_last = fn(ins[0], ins[1], ins[2] if h0 is not None else None)
        return lambda: torch.autograd.grad((h, h_last), ins, (g, g_last),
                                           retain_graph=True)

    def outside(got, want):
        """Elements outside SCAN_ATOL + SCAN_RTOL |want|, or not finite."""
        err = (got - want).abs()
        return int((err > SCAN_ATOL + SCAN_RTOL * want.abs()).sum()) \
            + int((~torch.isfinite(got)).sum()), float(err.max())

    # the hybrid train path's shape, a ragged one, and one tp_train
    # process's channels
    shapes = ((HYBRID_TRAIN_B, HYBRID_TRAIN_S, W, True), (2, 300, 1000, False),
              (*tp_scan_shape(), True))
    inputs_of = {shape: inputs(*shape) for shape in shapes}
    was = torch.are_deterministic_algorithms_enabled()
    cases, reverse_cases, worst, repeats = [], [], 0.0, {}
    try:
        for mode in (True, False):
            torch.use_deterministic_algorithms(mode)
            for shape in shapes:
                x = inputs_of[shape]
                scan_ops.launches = 0
                got = graph(scan_ops.lru_scan_vjp, *x)()
                torch.cuda.synchronize()
                launched = scan_ops.launches
                want = graph(rglru_scan_ref, *x)()
                line = {"deterministic": mode, "shape": list(shape[:3]),
                        "h0": shape[3], "launches": launched}
                for name, u, v in zip(("da", "db", "dh0"), got, want):
                    bad, err = outside(u, v)
                    line[name] = {"max_abs_err": err,
                                  "max_abs": float(v.abs().max()),
                                  "outside_tol": bad}
                    worst = max(worst, err)
                cases.append(line)
                if launched != 2 or any(line[n]["outside_tol"] for n in
                                        ("da", "db", "dh0") if n in line):
                    raise AssertionError(f"rglru_scan's gradient outside "
                                         f"tolerance or not two launches: "
                                         f"{line}")
                del got, want
                # the reverse mode alone, on the plain forward's h
                a, b, h0, g, g_last = x
                h = rglru_scan_ref(a, b, h0)[0]
                got = scan_ops.lru_scan_bwd(a, h, h0, g, g_last)
                want = lru_scan_bwd_ref(a, h, h0, g, g_last)
                torch.cuda.synchronize()
                line = {"deterministic": mode, "shape": list(shape[:3]),
                        "h0": shape[3]}
                for name, u, v in zip(("da", "db", "dh0"), got, want):
                    if v is None:
                        continue
                    bad, err = outside(u, v)
                    line[name] = {"max_abs_err": err,
                                  "max_abs": float(v.abs().max()),
                                  "outside_tol": bad}
                    worst = max(worst, err)
                reverse_cases.append(line)
                if any(line[n]["outside_tol"] for n in ("da", "db", "dh0")
                       if n in line):
                    raise AssertionError(f"rglru_scan's reverse mode outside "
                                         f"tolerance: {line}")
                del got, want, h
        # the train shape: in each mode, SCAN_REPEATS forward launches,
        # each held to the plain version; in deterministic mode (chained
        # carries) all bit-equal, and how often the decoupled look-back's
        # differ; then the times
        a, b, h0, g, g_last = inputs_of[shapes[0]]
        want = rglru_scan_ref(a, b, h0)[0]
        want_db = lru_scan_bwd_ref(a, want, h0, g, g_last)[1]
        reverse_repeats = {}
        for mode in (False, True):
            torch.use_deterministic_algorithms(mode)
            runs = [scan_ops.lru_scan(a, b, h0)[0]
                    for _ in range(SCAN_REPEATS)]
            bad = [outside(h, want)[0] for h in runs]
            if any(bad):
                raise AssertionError(f"rglru_scan's repeated launches "
                                     f"(deterministic {mode}) outside "
                                     f"tolerance: {bad}")
            repeats[mode] = sum(not torch.equal(h, runs[0])
                                for h in runs[1:])
            del runs
            runs = [scan_ops.lru_scan_bwd(a, want, h0, g, g_last)[1]
                    for _ in range(SCAN_REPEATS)]
            bad = [outside(db, want_db)[0] for db in runs]
            if any(bad):
                raise AssertionError(f"rglru_scan's repeated reverse "
                                     f"launches (deterministic {mode}) "
                                     f"outside tolerance: {bad}")
            reverse_repeats[mode] = sum(not torch.equal(db, runs[0])
                                        for db in runs[1:])
            del runs
        if reverse_repeats[True]:
            raise AssertionError(f"rglru_scan's reverse mode in "
                                 f"deterministic mode does not repeat: "
                                 f"{reverse_repeats[True]} of "
                                 f"{SCAN_REPEATS - 1} launches differ")
        del want_db
        backward = graph(scan_ops.lru_scan_vjp, a, b, h0, g, g_last)
        runs = [backward() for _ in range(2)]
        if repeats[True] or not all(torch.equal(u, v)
                                    for u, v in zip(*runs)):
            raise AssertionError(f"rglru_scan in deterministic mode does not "
                                 f"repeat: {repeats[True]} of "
                                 f"{SCAN_REPEATS - 1} forward launches "
                                 f"differ, or the two backward runs do")
        del runs

        def reverse():
            return scan_ops.lru_scan_bwd(a, want, h0, g, g_last)

        chained_ms = time_ms(lambda: scan_ops.lru_scan(a, b, h0))
        bwd_ms = time_ms(backward)
        reverse_ms = time_ms(reverse)
        torch.use_deterministic_algorithms(False)
        forward_ms = time_ms(lambda: scan_ops.lru_scan(a, b, h0))
        decoupled_bwd_ms = time_ms(backward)
        decoupled_reverse_ms = time_ms(reverse)
    finally:
        torch.use_deterministic_algorithms(was)
    del backward
    plain = graph(rglru_scan_ref, a, b, h0, g, g_last)
    plain_ms = time_ms(plain, iters=5)
    del plain
    B, S = HYBRID_TRAIN_B, HYBRID_TRAIN_S
    # read a, h, g, g_last and h0; write da, db and dh0
    nbytes = 4 * (5 * B * S * W + 3 * B * W)
    return {"shape": [B, S, W], "h0": True, "max_abs_err": worst,
            "tolerance": {"atol": SCAN_ATOL, "rtol": SCAN_RTOL},
            "cases": cases, "reverse_cases": reverse_cases,
            "repeats": SCAN_REPEATS,
            "reverse_launches_differing_default": reverse_repeats[False],
            "reverse_launches_differing_deterministic": reverse_repeats[True],
            "reverse_ms": reverse_ms,
            "reverse_ms_default_mode": decoupled_reverse_ms,
            "repeated_launches_within_tol": True,
            "forward_launches_differing_default": repeats[False],
            "forward_launches_differing_deterministic": repeats[True],
            "backward_runs_bit_equal_deterministic": True,
            "forward_ms": forward_ms, "forward_ms_deterministic": chained_ms,
            "forward_bound_ms": 4 * (3 * B * S * W + 2 * B * W)
            / HBM_BYTES_PER_S * 1e3,
            "ms": bwd_ms, "ms_default_mode": decoupled_bwd_ms,
            "plain_ms": plain_ms, "bytes_moved": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# -------------------------------------------------------------- main path
def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes and equal bytes."""
    return a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def save_restore(state, target, store_dir: str, nranks: int, device):
    """Save the tensors ``state`` as ``nranks`` ranks through the N-to-M
    engine and restore them onto ``device`` into ``target``'s names, shapes
    and dtypes (meta tensors); checked bit for bit and by ``verify_step``.
    Returns the measurements and the restored tensors."""
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import (TensorCheckpoint,
                                              balanced_chunk_partition)
    from repro_torch.core.torch_io import layout_from_torch, load_torch, save_torch

    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    ck = TensorCheckpoint(DatasetStore(store_dir, "w"))
    layout = layout_from_torch(state)
    ck.save_layout(layout)
    ownership = balanced_chunk_partition(layout, nranks)
    _sync(device)
    t0 = time.perf_counter()
    save_torch(ck, state, step=0, ownership=ownership)
    t_save = time.perf_counter() - t0

    ck_r = TensorCheckpoint(DatasetStore(store_dir, "r"))
    t0 = time.perf_counter()
    restored = load_torch(ck_r, target, step=0, device=device)
    _sync(device)
    t_load = time.perf_counter() - t0
    mismatched = [n for n in state if not _same_bits(restored[n], state[n])]
    if mismatched:
        raise AssertionError(f"restore is not bit-exact for {mismatched}")
    if not ck_r.verify_step(Comm(1), 0):
        raise AssertionError("verify_step failed on the saved store")
    gib = nbytes / 2**30
    return {"bytes": nbytes, "save_ranks": nranks, "load_ranks": 1,
            "save_seconds": t_save, "load_seconds": t_load,
            "save_gib_per_s": gib / t_save, "load_gib_per_s": gib / t_load,
            "bit_exact": True, "verify_step": True,
            "ownership_chunks": [int(sum(len(o) for o in r.values()))
                                 for r in ownership]}, restored


def phase_ckpt(api, params, store_dir: str, nranks: int, device):
    """Save ``params`` as ``nranks`` ranks, restore onto one device."""
    line, restored = save_restore(params, api.abstract_params(), store_dir,
                                  nranks, device)
    return {"phase": "ckpt", "params": sum(t.numel() for t in params.values()),
            **line}, restored


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sequential_greedy(api, params, prompt, max_new, max_seq, rows):
    """One request alone: a B=1 prefill, then greedy decode steps in a
    ``rows``-slot batch with the request in slot 0 and the others idle — the
    engine's batch shape, so each step's products have the engine's shapes."""
    dev = params["embed"].device
    logits, one = api.prefill(
        params, {"tokens": torch.from_numpy(prompt[None, :]).to(dev)}, max_seq)
    shape = (one["k"].shape[0], rows) + tuple(one["k"].shape[2:])
    cache = {key: torch.zeros(shape, dtype=one[key].dtype, device=dev)
             for key in ("k", "v")}
    for key in ("k", "v"):
        cache[key][:, 0] = one[key][:, 0]
    cache["length"] = torch.zeros(rows, dtype=torch.int32, device=dev)
    cache["length"][0] = len(prompt)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(max_new - 1):
        tok = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
        tok[0, 0] = out[-1]
        logits, cache = api.decode_step(
            params, cache, {"token": tok, "pos": cache["length"].clone()})
        out.append(int(torch.argmax(logits[0])))
    return out


def phase_serve(api, params, requests, slots: int, device) -> tuple[dict, dict]:
    """Serve ``requests`` with continuous batching; returns the phase line
    and the generated tokens."""
    from repro_torch.serve import TorchServeEngine

    spent = {"prefill": 0.0, "decode": 0.0, "prefill_calls": 0,
             "decode_calls": 0}

    def timed(kind, fn):
        def call(*a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(device)
            spent[kind] += time.perf_counter() - t0
            spent[kind + "_calls"] += 1
            return out
        return call

    timed_api = dataclasses.replace(
        api, prefill=timed("prefill", api.prefill),
        decode_step=timed("decode", api.decode_step))
    max_seq = max(len(p) + n for _, p, n in requests) + 1
    engine = TorchServeEngine(timed_api, params, slots=slots, max_seq=max_seq)
    for rid, prompt, max_new in requests:
        engine.submit(rid, prompt, max_new)
    t0 = time.perf_counter()
    results = engine.run()
    _sync(device)
    wall = time.perf_counter() - t0
    prompt_tokens = sum(len(p) for _, p, _ in requests)
    generated = sum(len(v) for v in results.values())
    line = {"phase": "serve", "requests": len(requests), "slots": slots,
            "max_seq": max_seq, "prompt_tokens": prompt_tokens,
            "generated_tokens": generated, "seconds": wall,
            "prefill_seconds": spent["prefill"],
            "decode_seconds": spent["decode"],
            "decode_steps": spent["decode_calls"],
            "prefill_tokens_per_s": prompt_tokens / spent["prefill"],
            "decode_tokens_per_s": (generated - len(requests)) / spent["decode"]}
    return line, results


def make_requests(vocab: int, spec=REQUESTS):
    rng = np.random.default_rng(SEED)
    return [(rid, rng.integers(0, vocab, size=p).astype(np.int32), n)
            for rid, (p, n) in enumerate(spec)]


def check_served(api, params, requests, results, slots: int) -> dict:
    max_seq = max(len(p) + n for _, p, n in requests) + 1
    if set(results) != {rid for rid, _, _ in requests}:
        raise AssertionError(f"served {sorted(results)}")
    for rid, prompt, max_new in requests:
        want = sequential_greedy(api, params, prompt, max_new, max_seq, slots)
        if results[rid] != want:
            raise AssertionError(f"request {rid}: engine {results[rid]} != "
                                 f"sequential greedy {want}")
    return {"token_for_token": True}


def check_model_logits(api, params, batch=None) -> dict:
    """The full model's prefill logits through the kernel (or the path the
    model's dispatch takes) vs the plain naive attention on the card, all
    through the serving step builder (an MoE model's layers then run
    ``moe_ffn_ep``): finite, same shape, within LOGITS_RTOL[arch] of the
    naive logits' scale.  The blocked plain path's distance from naive
    attention, the bf16 floor of the same model, is read beside it.
    ``batch`` is the prefill batch on the card; by default 2 seeded
    prompts of 96 tokens."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import batch_dims
    from repro_torch.models.api import build_model
    from repro_torch.train.step import make_prefill_step

    if batch is None:
        rng = np.random.default_rng(SEED + 1)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, api.cfg.vocab, size=(2, 96)).astype(np.int32)).cuda()}
    B, S = batch_dims(batch)
    shape = ShapeConfig("logits", S, B, "prefill")

    def logits(impl):
        other = build_model(dataclasses.replace(api.cfg, attention_impl=impl))
        return make_prefill_step(other, shape)(params, batch)[0]

    got, _ = make_prefill_step(api, shape)(params, batch)
    want, blocked = logits("naive"), logits("xla_flash")
    if got.shape != (B, api.cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"prefill logits {tuple(got.shape)} not finite")
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    line = {"logits_max_abs_diff_vs_naive": diff, "max_abs_logit": scale,
            "logits_rel_vs_naive": diff / scale,
            "blocked_rel_vs_naive": float((blocked - want).abs().max())
            / scale, "logits_rtol": LOGITS_RTOL[api.cfg.arch],
            "same_argmax": bool((got.argmax(-1) == want.argmax(-1)).all())}
    if diff > LOGITS_RTOL[api.cfg.arch] * scale:
        raise AssertionError(f"kernel-path logits differ from the naive "
                             f"path: {line}")
    return line


# -------------------------------------------------------------- hybrid path
def phase_hybrid_serve(api, params, tokens, device) -> tuple[dict, dict]:
    """One batched prefill and HYBRID_G lockstep decode steps through the
    launcher's ``serve_batch``.  Returns the phase line and what the later
    phases need: the generated tokens, a clone of the prefill's cache and
    row 0's logits at the CONSISTENCY_STEPS."""
    from repro_torch.launch.serve import serve_batch

    kept = {"step_logits": {}}

    def on_prefill(logits, cache):
        kept["cache"] = {k: v.clone() for k, v in cache.items()}

    def on_step(i, logits):
        if i in CONSISTENCY_STEPS:
            kept["step_logits"][i] = logits[0].float().clone()

    B, P = tokens.shape
    torch.cuda.reset_peak_memory_stats()
    out, timings = serve_batch(api, params, {"tokens": tokens}, HYBRID_G,
                               device, on_prefill=on_prefill, on_step=on_step)
    if out.shape != (B, HYBRID_G + 1) or not (
            (out >= 0) & (out < api.cfg.vocab)).all():
        raise AssertionError(f"served tokens {out.shape} out of range")
    if not all(torch.isfinite(t).all() for t in kept["step_logits"].values()):
        raise AssertionError("decode logits are not finite")
    kept["tokens"] = out
    t_pre, t_dec = timings["prefill_seconds"], timings["decode_seconds"]
    line = {"phase": "hybrid_serve", "arch": api.cfg.arch,
            "params": sum(t.numel() for t in params.values()),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in params.values()),
            "layers": api.cfg.num_layers, "batch": B, "prompt_len": P,
            "decode_steps": HYBRID_G, "prefill_seconds": t_pre,
            "prefill_tokens_per_s": B * P / t_pre,
            "decode_seconds": t_dec,
            "decode_tokens_per_s": B * HYBRID_G / t_dec,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "sample_tokens": out[0, :8].tolist()}
    return line, kept


def phase_hybrid_state(api, params, kept, store_dir: str, nranks: int,
                       device) -> dict:
    """The prefill's cache saved as ``nranks`` ranks, restored onto this
    card, checked bit for bit; decoding from it must give the same tokens."""
    from repro_torch.launch.serve import decode_steps

    cache, out = kept["cache"], kept["tokens"]
    line, restored = save_restore(
        cache, api.abstract_cache(out.shape[0], HYBRID_P + HYBRID_G),
        store_dir, nranks, device)
    first = torch.from_numpy(out[:, :1].copy()).to(device)
    with torch.inference_mode():
        toks = decode_steps(api, params, restored, first, HYBRID_P, HYBRID_G,
                            device)
    if not np.array_equal(torch.cat(toks, dim=1).cpu().numpy(), out):
        raise AssertionError("decoding from the restored state gave other "
                             "tokens than the original state")
    return {"phase": "hybrid_state",
            "arrays": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in cache.items()},
            **line, "continued_tokens_identical": True}


def decode_vs_prefill(api, params, tokens, kept, rtol: float,
                      extra=None) -> dict:
    """Row 0: the logits of decode step g (``kept["step_logits"][g]``, for
    g in CONSISTENCY_STEPS) against one prefill of the prompt plus the
    first g generated tokens (and row 0's other inputs ``extra``, e.g. an
    encoder's frames), within ``rtol`` of the largest prefill logit and
    with the same argmax.  ``failed`` lists the cases outside."""
    out = kept["tokens"]
    dev = params["embed"].device
    results = []
    for g in CONSISTENCY_STEPS:
        seq = torch.cat([tokens[0], torch.from_numpy(out[0, :g]).to(dev)])
        with torch.inference_mode():
            want, _ = api.prefill(params, {"tokens": seq[None],
                                           **(extra or {})})
        want = want[0].float()
        got = kept["step_logits"][g]
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        top2 = torch.topk(want, 2).values
        results.append({"step": g, "max_abs_diff": diff,
                        "max_abs_logit": scale, "rel": diff / scale,
                        "same_argmax": int(got.argmax()) == int(want.argmax()),
                        "prefill_top2_gap": float(top2[0] - top2[1])})
    return {"rtol": rtol, "cases": results,
            "failed": [r for r in results
                       if not r["same_argmax"] or r["rel"] > rtol]}


# ------------------------------------------------------------ train path
def check_flash_vjp(cfg, device) -> list[dict]:
    """dq, dk, dv of the kernel's autograd Function (the forward and
    backward kernels) against autograd through the plain blocked
    ``flash_attention_xla`` on the same upstream gradient, at the train
    path's shape, at one ``tp_train`` process's heads (3 query over 1 kv)
    and at one ``adafactor_mesh`` process's (16 query over 2 kv, hd 128);
    and against autograd through the plain f32 attention (reported, not
    held: bf16 against f32)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import flash_attention_xla

    gen = torch.Generator(device=device).manual_seed(SEED)
    blocks = dict(block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    lines = []
    for B, S, Hq, Hkv, hd in [
            (TRAIN_B, TRAIN_S, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_),
            (TP_B, TP_S, *tp_heads(cfg)),
            (KIMI_TRAIN_B, KIMI_TRAIN_S, *ada_heads())]:
        shapes = [(B, S, Hq, hd)] + [(B, S, Hkv, hd)] * 2
        q, k, v, g = (torch.randn(s, generator=gen, device=device)
                      .to(torch.bfloat16) for s in shapes + shapes[:1])

        def grads(fn, dtype=torch.bfloat16):
            ts = [t.to(dtype).requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(fn(*ts), ts, g.to(dtype))

        got = grads(lambda a, b, c: flash_attention_vjp(
            a, b, c, True, 0, 0.0, cfg.attn_block_q, cfg.attn_block_k, 0))
        want = grads(lambda a, b, c: flash_attention_xla(
            a, b, c, causal=True, **blocks))
        exact = grads(lambda a, b, c: attention_ref(a, b, c, causal=True),
                      torch.float32)
        torch.cuda.synchronize()
        line = {"shape": [B, S, Hq, Hkv, hd], "blocks": blocks,
                "tolerance": {"atol": VJP_ATOL, "rtol": VJP_RTOL}}
        for name, a, b, c in zip(("dq", "dk", "dv"), got, want, exact):
            a, b = a.float(), b.float()
            err = (a - b).abs()
            line[name] = {
                "max_abs_err": float(err.max()),
                "outside_tol": int((err > VJP_ATOL + VJP_RTOL * b.abs())
                                   .sum()),
                "bit_equal": bool(torch.equal(a, b)),
                "max_abs_err_vs_f32": float((a - c).abs().max()),
                "max_abs_f32": float(c.abs().max())}
            if line[name]["outside_tol"] or not torch.isfinite(a).all():
                raise AssertionError(f"flash_attention_vjp {name} outside "
                                     f"tolerance: {line}")
        lines.append(line)
        del q, k, v, g, got, want, exact
    return lines


def kill_and_resume(api, B: int, S: int, store_dirs, device,
                    per_step: dict | None = None, keep=(), opt=None,
                    data=None, lr: float = TRAIN_LR) -> tuple:
    """Runs A, B and C (see the module docstring) of ``api`` at batch B and
    sequence S through the TorchTrainer in deterministic mode, under
    ``opt`` (AdamW by default, under warmup_cosine(``lr``)) on the batches
    of ``data`` (``SyntheticLM`` by default), with the
    launch counts at 0 just before each run and read just after: each
    kernel named in ``per_step`` must have launched that many times a step
    run, and ckpt_pack on every save.  Run C must end in A's state and
    losses bit for bit.  The arrays named in ``keep`` are cloned after step
    SWEEP_CHECK_A of run A, at the step C restores and at C's end.
    Returns the line and those clones by step."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.train import (AdamW, SimulatedPreemption, SyntheticLM,
                                   TorchTrainer, TrainerConfig,
                                   init_train_state, make_train_step,
                                   warmup_cosine)

    use_deterministic_algorithms()
    per_step = per_step or {}
    opt = opt or AdamW()
    step = make_train_step(
        api, opt, functools.partial(warmup_cosine, base_lr=lr,
                                    warmup=TRAIN_WARMUP, total=TRAIN_STEPS),
        ShapeConfig("train", S, B, "train"))
    step_seconds, step_fn = [], step.fn
    kept, capture_a = {}, False

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        if capture_a and int(out[0]["step"]) == SWEEP_CHECK_A:
            kept[SWEEP_CHECK_A] = {n: out[0][n].clone() for n in keep}
        return out

    step = dataclasses.replace(step, fn=timed_step)
    data = data or SyntheticLM(api.cfg.vocab, S, B, seed=SEED)

    def trainer(store_dir, ckpt_every):
        return TorchTrainer(
            step, data, TrainerConfig(store_dir, ckpt_every=ckpt_every,
                                      log_every=1), device=device,
            init_state_fn=lambda: init_train_state(
                api, opt, torch.Generator(device=device).manual_seed(SEED)))

    zero, read, launches = _counter()

    def counted(run, steps_run, saves):
        """``run()`` with the counts at 0 just before and read just after;
        each kernel in ``per_step`` must have launched that many times a
        step run, ckpt_pack on every save."""
        zero()
        per_save = []
        out = run(per_save)
        got = read()
        for k, n in per_step.items():
            if got[k] != n * steps_run:
                raise AssertionError(f"{k} launched {got[k]} times in "
                                     f"{steps_run} steps, not "
                                     f"{n * steps_run}")
        if len(per_save) != saves or not all(per_save):
            raise AssertionError(f"ckpt_pack launches per save {per_save}, "
                                 f"expected {saves} saves, each above 0")
        return out, got, per_save

    def counting_saves(t, per_save):
        save = t._save

        def wrapped(state, i):
            before = pack_ops.launches
            save(state, i)
            per_save.append(pack_ops.launches - before)
        t._save = wrapped
        return t

    # ---- A: TRAIN_STEPS straight, no checkpoint
    torch.cuda.reset_peak_memory_stats()
    ta = trainer(store_dirs[0], 0)
    capture_a = True
    ra, a_counts, _ = counted(lambda ps: ta.run(TRAIN_STEPS), TRAIN_STEPS, 0)
    capture_a = False
    peak = torch.cuda.max_memory_allocated()
    a_times = list(step_seconds)
    losses = [h["loss"] for h in ta.history]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"run A's loss is not finite and falling: "
                             f"{losses}")

    # ---- B: saves every TRAIN_CKPT_EVERY steps, preempted at TRAIN_FAIL_AT
    tb = trainer(store_dirs[1], TRAIN_CKPT_EVERY)

    def run_b(per_save):
        counting_saves(tb, per_save)
        try:
            tb.run(TRAIN_STEPS, fail_at=TRAIN_FAIL_AT)
        except SimulatedPreemption:
            return None
        raise AssertionError("run B was not preempted")

    committed = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    _, b_counts, b_saves = counted(run_b, TRAIN_FAIL_AT,
                                   TRAIN_FAIL_AT // TRAIN_CKPT_EVERY)
    writes = {j["label"]: j["seconds"] for j in tb._async.job_log}

    # ---- C: a fresh trainer restores the last committed step, runs to the end
    tc = trainer(store_dirs[1], TRAIN_CKPT_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, start = tc.restore_latest()
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    if start != committed:
        raise AssertionError(f"restored step {start}, not {committed}")
    kept[start] = {n: state[n].clone() for n in keep}
    rc, c_counts, c_saves = counted(
        lambda ps: counting_saves(tc, ps).run(TRAIN_STEPS, start_state=state,
                                              start_step=start),
        TRAIN_STEPS - start,
        TRAIN_STEPS // TRAIN_CKPT_EVERY - start // TRAIN_CKPT_EVERY)
    differ = [k for k in ra["state"]
              if not _same_bits(ra["state"][k], rc["state"][k])]
    if differ:
        raise AssertionError(f"the resumed run's state differs from the "
                             f"straight run's in {differ}")
    kept[TRAIN_STEPS] = {n: rc["state"][n].clone() for n in keep}
    resumed = {h["step"]: h["loss"] for h in tc.history}
    straight = {h["step"]: h["loss"] for h in ta.history}
    if any(resumed[s] != straight[s] for s in resumed):
        raise AssertionError(f"resumed losses {resumed} != straight "
                             f"{straight}")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in ra["state"].values())
    median = float(np.median(a_times[1:]))
    cfg = api.cfg
    return {"arch": cfg.arch, "layers": cfg.num_layers,
            "optimizer": opt.name,
            "params": sum(t.numel() for k, t in ra["state"].items()
                          if k.startswith("params/")),
            "state_bytes": state_bytes, "batch": B, "seq": S,
            "attention_impl": cfg.attention_impl, "remat": cfg.remat,
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "losses": losses, "step_seconds_a": a_times,
            "step_ms_median_2_to_6": median * 1e3,
            "tokens_per_s": B * S / median,
            "peak_memory_allocated": peak,
            "saves": [{**s, "ckpt_pack_launches": n,
                       "write_seconds": writes.get(f"state/s{s['step']}")}
                      for s, n in zip(tb.save_log, b_saves)],
            "restored_step": start, "restore_seconds": t_restore,
            "restore_gib_per_s": state_bytes / 2**30 / t_restore,
            "resumed_losses": resumed, "bit_exact_with_straight_run": True,
            "launches": {"a": a_counts, "b": b_counts, "c": c_counts,
                         "c_ckpt_pack_per_save": c_saves,
                         "per_step": per_step},
            "total_launches": launches}, kept


def phase_train(cfg, device, store_dirs) -> tuple[dict, dict]:
    """smollm's A, B and C (``kill_and_resume``) at TRAIN_B, TRAIN_S after
    the attention kernel's gradient check; the attention forward kernel
    must launch twice a layer a step (remat re-runs each layer's forward),
    the backward kernel once.  Returns the
    line and the arrays the postprocess phase sweeps, by step."""
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.models.api import build_model

    use_deterministic_algorithms()
    api = build_model(cfg)
    vjp = check_flash_vjp(cfg, device)
    line, kept = kill_and_resume(
        api, TRAIN_B, TRAIN_S, store_dirs, device,
        per_step={"flash_attention": 2 * cfg.num_layers,
                  "flash_attention_bwd": cfg.num_layers}, keep=SWEEP_ARRAYS)
    return {"phase": "train", **line, "vjp_check": vjp}, kept


def fem_field(t: int):
    """The host field saved at time index ``t``: the FE benchmark's
    sin(3x)(2 + cos 5y) + xy at t = 0, tilted by t(x - y) after."""
    def field(p):
        x, y = p[:, 0], p[:, 1]
        return np.sin(3 * x) * (2 + np.cos(5 * y)) + x * y + t * (x - y)
    return field


def phase_fem(device, store_dir: str) -> dict:
    """The paper's own path at full size: a P4 function on a 512 x 512
    triangle mesh, its DoF vectors on the card, saved N-to-M from 8
    simulated ranks at 3 time indices through the async facade, loaded on
    M = 1 (onto the card) and on M = 3; every loaded DoF is checked bit for
    bit against the field at its reconstructed node point (the paper's
    §6.1 criterion)."""
    from repro_torch.core.async_io import AsyncCheckpointer
    from repro_torch.core.comm import Comm
    from repro_torch.core.store import DatasetStore
    from repro_torch.fem import (Element, FEMCheckpoint, FunctionSpace,
                                 distribute, interpolate, node_points,
                                 tri_mesh_fast)
    from repro_torch.fem.torch_fem import (functions_from_device,
                                           functions_to_device)

    N = FEM_SAVE_RANKS
    mesh = tri_mesh_fast(FEM_NX, FEM_NY)
    t0 = time.perf_counter()
    plexes, _, _ = distribute(mesh, N, method="contiguous", seed=0)
    t_dist = time.perf_counter() - t0
    spaces = [FunctionSpace(lp, Element("P", FEM_DEGREE, "triangle"))
              for lp in plexes]
    dofs = sum(sp.ndof_owned for sp in spaces)
    # the simulation's DoF vectors live on the card, one per time index
    h2d, d2h, on_card = [], [], []
    for t in range(FEM_TIMES):
        funcs = [interpolate(sp, fem_field(t)) for sp in spaces]
        _sync(device)
        t0 = time.perf_counter()
        on_card.append(functions_to_device(funcs, device))
        _sync(device)
        h2d.append(time.perf_counter() - t0)
    del funcs

    store = DatasetStore(store_dir, "w")
    ac = AsyncCheckpointer(FEMCheckpoint(store), Comm(N))
    t_all = time.perf_counter()
    ac.save_mesh("m", plexes)
    t_save_mesh = time.perf_counter() - t_all
    t_save_fn = []
    for t, values in enumerate(on_card):
        t0 = time.perf_counter()
        host = functions_from_device(spaces, values)
        d2h.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ac.save_function("m", "u", host, time_index=t)
        t_save_fn.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ac.wait()
    t_wait = time.perf_counter() - t0
    t_all = time.perf_counter() - t_all
    writer = {j["label"]: j["seconds"] for j in ac.job_log}
    write_calls, n_datasets = store.stats.write_calls, len(store.datasets())
    del on_card, host

    loads = []
    for M in FEM_LOAD_RANKS:
        ck = FEMCheckpoint(DatasetStore(store_dir, "r"))
        if ck.steps("m", "u") != list(range(FEM_TIMES)):
            raise AssertionError(f"committed time indices "
                                 f"{ck.steps('m', 'u')}")
        comm = Comm(M)
        t0 = time.perf_counter()
        loaded = ck.load_mesh("m", comm, partition="contiguous")
        t_mesh = time.perf_counter() - t0
        if loaded.E != mesh.num_entities:
            raise AssertionError(f"M={M}: loaded {loaded.E} entities, not "
                                 f"{mesh.num_entities}")
        row = {"load_ranks": M, "load_mesh_s": t_mesh, "load_fn_s": [],
               "h2d_s": [], "dofs_checked": 0}
        for t in range(FEM_TIMES):
            t0 = time.perf_counter()
            lspaces, lfuncs = ck.load_function(loaded, "u", comm,
                                               time_index=t)
            row["load_fn_s"].append(time.perf_counter() - t0)
            if sum(sp.ndof_owned for sp in lspaces) != dofs:
                raise AssertionError(f"M={M} t={t}: owned DoFs differ")
            wants = [fem_field(t)(node_points(sp)) for sp in lspaces]
            if M == 1:
                # the result goes to the card and is checked there
                _sync(device)
                t0 = time.perf_counter()
                got = functions_to_device(lfuncs, device)
                _sync(device)
                row["h2d_s"].append(time.perf_counter() - t0)
                ok = all(_same_bits(g, torch.from_numpy(w).to(device))
                         for g, w in zip(got, wants))
                del got
            else:
                ok = all(np.array_equal(f.values.view(np.int64),
                                        w.view(np.int64))
                         for f, w in zip(lfuncs, wants))
            if not ok:
                raise AssertionError(f"M={M} t={t}: a loaded DoF differs "
                                     f"from the field at its node")
            row["dofs_checked"] += sum(f.values.size for f in lfuncs)
        row["read_calls"] = ck.store.stats.read_calls
        row["dofs_per_s"] = [dofs / s for s in row["load_fn_s"]]
        loads.append(row)
        ck.store.close()
    store.close()
    return {"phase": "fem", "mesh": f"tri_mesh_fast({FEM_NX}, {FEM_NY})",
            "element": f"P{FEM_DEGREE} triangle", "entities":
            mesh.num_entities, "dofs": dofs, "save_ranks": N,
            "time_indices": FEM_TIMES, "distribute_s": t_dist,
            "h2d_s": h2d, "d2h_s": d2h, "save_mesh_s": t_save_mesh,
            "save_fn_s": t_save_fn, "wait_s": t_wait,
            "save_wall_s": t_all, "writer_s": writer,
            "arena_blocked_s": ac.arena.stats.blocked_seconds,
            "save_dofs_per_s": dofs * FEM_TIMES / t_all,
            "write_calls": write_calls, "datasets": n_datasets,
            "loads": loads, "bit_exact": True}


def phase_postprocess(store_dir: str, kept: dict, device) -> dict:
    """Save big, post-process small: sweep every committed step of the
    train phase's store (runs B and C: smollm-135m's train state at steps
    2, 4 and 6) on one rank, loading only ``SWEEP_ARRAYS`` onto the
    card; each swept array must equal the train phase's own, bit for bit,
    and the store must read no more than those arrays' datasets."""
    from repro_torch.core.store import DatasetStore, np_dtype
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import sweep_to_device

    def nbytes(spec):
        return int(np.prod(spec.shape)) * np_dtype(spec.dtype).itemsize

    ck = TensorCheckpoint(DatasetStore(store_dir, "r"))
    steps, layout = ck.steps(), ck.layout()
    if sorted(kept) != steps:
        raise AssertionError(f"committed steps {steps}, kept {sorted(kept)}")
    st = ck.store
    stored = 0                  # the swept arrays' datasets, every step
    for s in steps:
        for logical, phys in st.step_datasets(s).items():
            if any(logical.startswith(f"{n}/e") for n in SWEEP_ARRAYS):
                stored += (st.rows(phys) * st.dtype(phys).itemsize
                           * int(np.prod(st.row_shape(phys), initial=1)))
    array_bytes = sum(nbytes(layout.spec(n)) for n in SWEEP_ARRAYS)
    state_bytes = sum(nbytes(spec) for spec in layout.arrays)
    read0 = st.stats.bytes_read
    it = sweep_to_device(ck, SWEEP_ARRAYS, device)
    per_step = []
    while True:
        _sync(device)
        t0 = time.perf_counter()
        try:
            step, arrays = next(it)
        except StopIteration:
            break
        _sync(device)
        dt = time.perf_counter() - t0
        differ = [n for n in SWEEP_ARRAYS
                  if arrays[n].device.type != device.type
                  or not _same_bits(arrays[n], kept[step][n])]
        if differ:
            raise AssertionError(f"step {step}: swept {differ} differ from "
                                 f"the train phase's")
        per_step.append({"step": step, "seconds": dt,
                         "gib_per_s": array_bytes / 2**30 / dt})
    bytes_read = st.stats.bytes_read - read0
    if [r["step"] for r in per_step] != steps:
        raise AssertionError(f"swept {[r['step'] for r in per_step]}, "
                             f"committed {steps}")
    if bytes_read > stored:
        raise AssertionError(f"the sweep read {bytes_read} bytes, more than "
                             f"the swept arrays' {stored}: it touched "
                             f"another array's datasets")
    st.close()
    return {"phase": "postprocess", "arrays": list(SWEEP_ARRAYS),
            "layout_arrays": len(layout.names), "steps": per_step,
            "array_bytes_per_step": array_bytes,
            "state_bytes_per_step": state_bytes,
            "stored_bytes_of_swept_arrays": stored,
            "bytes_read": bytes_read, "read_calls": st.stats.read_calls,
            "bit_exact": True}


def phase_elastic(cfg, scratch: Path) -> tuple[dict, dict]:
    """The three legs (see the module docstring).  Legs 1 and 3 run in new
    CPU processes; leg 2 runs here, on the card, with the launch counts at
    0 just before it and read just after.  Returns the phase line and leg
    2's launches."""
    from repro_torch.core.store import DatasetStore, np_dtype
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.elastic import Phase, run_phase, run_phases
    from repro_torch.train.step import train_state_specs

    # the port's fault store, which the test suite uses too
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from helpers.torch_faultstore import FaultStore

    ecfg = dataclasses.replace(cfg, num_layers=ELASTIC_LAYERS)
    specs = train_state_specs(build_model(ecfg), AdamW())
    state_bytes = sum(int(np.prod(s.shape)) * np_dtype(s.dtype).itemsize
                      for s in specs.values())
    params = sum(int(np.prod(s.shape)) for n, s in specs.items()
                 if n.startswith("params/"))
    ckpt = tempfile.mkdtemp(prefix="elastic_", dir=scratch)
    keep2, keep4 = str(scratch / "elastic_step2.pt"), str(
        scratch / "elastic_step4.pt")
    common = dict(arch="smollm_135m", smoke=False, num_layers=ELASTIC_LAYERS,
                  attention_impl=cfg.attention_impl, seq=ELASTIC_S,
                  batch=ELASTIC_B, ckpt_every=2, base_lr=TRAIN_LR,
                  warmup=TRAIN_WARMUP, total=ELASTIC_STEPS)
    gib = state_bytes / 2**30

    def committed():
        st = DatasetStore(ckpt, "r")
        try:
            return TensorCheckpoint(st).steps()
        finally:
            st.close()

    def store_bytes():
        return sum(p.stat().st_size for p in Path(ckpt).rglob("*")
                   if p.is_file())

    def spawn(nprocs, phases):
        t0 = time.time()
        per_rank = run_processes(run_phases, nprocs, (phases,),
                                 timeout=ELASTIC_PG_TIMEOUT,
                                 pg_timeout=ELASTIC_PG_TIMEOUT)
        return per_rank, per_rank[0][0]["entered_at"] - t0

    legs = []
    # ---- leg 1: N = 4 CPU processes, fresh from seed 0, steps 0 -> 2 saving
    # 2 (rank 0 keeps the whole state), then 2 -> 4 with the writer killed
    t0 = time.perf_counter()
    n_runs, spawn_n = spawn(4, [
        Phase(ELASTIC_MESH_N, 2, ckpt, 0, keep=keep2, **common),
        Phase(ELASTIC_MESH_N, ELASTIC_STEPS, ckpt, 2, carry_on=True,
              store_factory=functools.partial(
                  FaultStore, kill_after_ops=ELASTIC_KILL_AFTER_OPS),
              expect_crash=True, **common)])
    first, crashed = n_runs[0]
    raised = [r[1].get("crash") for r in n_runs]
    if not all(raised) or committed() != [2]:
        raise AssertionError(f"the writer's death must raise on every "
                             f"process and leave step 2 committed: raised "
                             f"{raised}, committed {committed()}")
    legs.append({"leg": "N", "processes": 4, "device": "cpu",
                 "mesh": list(ELASTIC_MESH_N), "spawn_seconds": spawn_n,
                 "init_seconds": first["restore_seconds"],
                 "step_seconds": first["step_seconds"],
                 "losses": [h["loss"] for h in first["history"]
                            + crashed["history"]],
                 "saves": first["save_log"], "raised_on_every_process": raised,
                 "committed_after": committed(), "store_bytes": store_bytes(),
                 "seconds": time.perf_counter() - t0})

    # ---- leg 2: M = 1 on the card, counts at 0 just before, read just after
    t0 = time.perf_counter()
    pack_ops.launches = attn_ops.launches = attn_ops.bwd_launches = 0
    init_distributed("cuda", rank=0, world_size=1,
                     timeout=ELASTIC_PG_TIMEOUT)
    try:
        card = run_phase(Phase(ELASTIC_MESH_CARD, ELASTIC_STEPS, ckpt, 2,
                               from_step=2, verify=keep2, keep=keep4,
                               device="cuda", **common))
    finally:
        torch.distributed.destroy_process_group()
    launches = {"flash_attention": attn_ops.launches,
                "flash_attention_bwd": attn_ops.bwd_launches,
                "ckpt_pack": pack_ops.launches}
    per_step = (2 if ecfg.remat else 1) * ecfg.num_layers
    steps_run = ELASTIC_STEPS - 2
    if launches["flash_attention"] != per_step * steps_run or \
            launches["flash_attention_bwd"] != ecfg.num_layers * steps_run \
            or not launches["ckpt_pack"]:
        raise AssertionError(f"the card's leg launched {launches}: expected "
                             f"{per_step * steps_run} flash_attention and "
                             f"{ecfg.num_layers * steps_run} backward "
                             f"launches and ckpt_pack on its save")
    if committed() != [2, ELASTIC_STEPS] or not card["losses_finite"]:
        raise AssertionError(f"committed {committed()}, losses "
                             f"{card['history']}")
    legs.append({"leg": "card", "processes": 1, "device": "cuda",
                 "mesh": list(ELASTIC_MESH_CARD), "restored_step": 2,
                 "restore_seconds": card["restore_seconds"],
                 "restore_gib_per_s": gib / card["restore_seconds"],
                 "bit_equal_arrays": card["bit_equal_arrays"],
                 "step_ms": [t * 1e3 for t in card["step_seconds"]],
                 "losses": [h["loss"] for h in card["history"]],
                 "saves": card["save_log"], "launches": launches,
                 "committed_after": committed(), "store_bytes": store_bytes(),
                 "seconds": time.perf_counter() - t0})

    # ---- leg 3: M = 2 CPU processes restore the card's step 4
    t0 = time.perf_counter()
    m_runs, spawn_m = spawn(2, [Phase(ELASTIC_MESH_M, ELASTIC_STEPS, ckpt,
                                      ELASTIC_STEPS, from_step=ELASTIC_STEPS,
                                      verify=keep4, **common)])
    restore_m = max(r[0]["restore_seconds"] for r in m_runs)
    if any(r[0]["bit_equal_arrays"] != len(specs) for r in m_runs):
        raise AssertionError("the 2 processes' restore is not bit-equal")
    legs.append({"leg": "M", "processes": 2, "device": "cpu",
                 "mesh": list(ELASTIC_MESH_M), "spawn_seconds": spawn_m,
                 "restored_step": ELASTIC_STEPS, "restore_seconds": restore_m,
                 "restore_gib_per_s": gib / restore_m,
                 "bit_equal_arrays": len(specs),
                 "seconds": time.perf_counter() - t0})
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"phase": "elastic", "arch": cfg.arch, "layers": ELASTIC_LAYERS,
            "params": params, "state_bytes": state_bytes,
            "arrays": len(specs), "batch": ELASTIC_B, "seq": ELASTIC_S,
            "N": 4, "M": [1, 2], "legs": legs,
            "bit_exact_restores": True}, launches


# ------------------------------------------------- batched serving phases
def phase_serve_batch(name, api, params, batch, gen: int, device,
                      on_step=None) -> tuple[dict, dict]:
    """One batched prefill of ``batch`` and ``gen`` lockstep decode steps
    through the launcher's ``serve_batch``.  Returns the phase line and the
    prefill's logits and cache (clones) and the served tokens."""
    from repro_torch.launch.serve import batch_dims, serve_batch

    kept = {}

    def on_prefill(logits, cache):
        kept["cache"] = {k: v.clone() for k, v in cache.items()}
        kept["logits"] = logits.clone()

    B, P = batch_dims(batch)
    torch.cuda.reset_peak_memory_stats()
    out, timings = serve_batch(api, params, batch, gen, device,
                               on_prefill=on_prefill, on_step=on_step)
    if out.shape != (B, gen + 1) or not (
            (out >= 0) & (out < api.cfg.vocab)).all():
        raise AssertionError(f"served tokens {out.shape} out of range")
    if not torch.isfinite(kept["logits"]).all():
        raise AssertionError("prefill logits are not finite")
    kept["tokens"] = out
    t_pre, t_dec = timings["prefill_seconds"], timings["decode_seconds"]
    line = {"phase": name, "arch": api.cfg.arch,
            "params": sum(t.numel() for t in params.values()),
            "param_bytes": sum(t.numel() * t.element_size()
                               for t in params.values()),
            "layers": api.cfg.num_layers,
            "heads": [api.cfg.num_heads, api.cfg.num_kv_heads,
                      api.cfg.head_dim_],
            "input": sorted(batch), "batch": B, "prompt_len": P,
            "decode_steps": gen, "prefill_seconds": t_pre,
            "prefill_tokens_per_s": B * P / t_pre,
            "decode_seconds": t_dec,
            "decode_tokens_per_s": B * gen / t_dec,
            "decode_step_ms": t_dec / gen * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "sample_tokens": out[0, :8].tolist()}
    return line, kept


def check_repeated_prefill(api, params, batch, kept, cache_len) -> dict:
    """A second prefill of the same batch, bit-equal to the served one."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import batch_dims
    from repro_torch.train.step import make_prefill_step

    B, P = batch_dims(batch)
    again, cache = make_prefill_step(
        api, ShapeConfig("serve", P, B, "prefill"),
        cache_len=cache_len)(params, batch)
    if not (_same_bits(again, kept["logits"]) and all(
            _same_bits(cache[k], kept["cache"][k]) for k in cache)):
        raise AssertionError("a second prefill of the same prompts differs "
                             "from the first")
    return {"repeated_prefill_bit_equal": True}


# ----------------------------------------------------------------- MoE path
def real_params(cfg, params) -> int:
    """Parameters less the phantom experts' (their router columns and
    expert weights, which nothing routes to)."""
    E, real = cfg.moe.num_experts_padded, cfg.moe.num_experts
    return sum(t.numel() // E * real
               if name.startswith("we_") or name == "router" else t.numel()
               for name, t in params.items())


def check_moe_layer(cfg, params, device, B: int = MOE_LAYER_B,
                    S: int = MOE_LAYER_S) -> dict:
    """Layer 0's MoE FFN at the model's width on the card: ``moe_ffn_ep``
    (a model axis of 1) against the dense one-hot oracle at capacity
    factor E, where nothing drops, on B x S seeded activations."""
    from repro_torch.models import moe
    from repro_torch.train.step import ONE_DEVICE

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    x = torch.randn((B, S, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    w = [params[k][0] for k in ("router", "we_gate", "we_up", "we_down")]
    kw = dict(top_k=cfg.moe.top_k, num_real=cfg.moe.num_experts,
              capacity_factor=float(cfg.moe.num_experts_padded))
    y_ep, aux_ep = moe.moe_ffn_ep(x, *w, mesh=ONE_DEVICE, **kw)
    y_dn, aux_dn = moe.moe_ffn(x, *w, **kw)
    torch.cuda.synchronize()
    diff = float((y_ep.float() - y_dn.float()).abs().max())
    scale = float(y_dn.float().abs().max())
    line = {"tokens": B * S, "rtol": MOE_RTOL,
            "max_abs_diff": diff, "max_abs_dense": scale,
            "aux_ep": float(aux_ep), "aux_dense": float(aux_dn)}
    if not torch.isfinite(y_ep).all() or diff > MOE_RTOL * scale:
        raise AssertionError(f"moe_ffn_ep against the dense oracle: {line}")
    return line


def phase_moe_serve(api, params, tokens, device) -> tuple[dict, dict]:
    """One batched prefill and MOE_G lockstep decode steps through the
    launcher's ``serve_batch`` (the step builders on a (1, 1) mesh, so every
    MoE layer runs ``moe_ffn_ep``).  Returns the phase line and the
    prefill's logits and cache and the served tokens."""
    line, kept = phase_serve_batch("moe_serve", api, params,
                                   {"tokens": tokens}, MOE_G, device)
    line.update({"real_params": real_params(api.cfg, params),
                 "experts": [api.cfg.moe.num_experts,
                             api.cfg.moe.num_experts_padded],
                 "top_k": api.cfg.moe.top_k})
    return line, kept


def check_moe_serve(api, params, tokens, kept, device) -> dict:
    """The checks of ``moe_serve`` that run after its launches are read:
    the MoE layer against the dense oracle, the logits with kernel
    attention against naive attention, and a second prefill bit-equal to
    the first."""
    with torch.inference_mode():
        layer = check_moe_layer(api.cfg, params, device)
        logits = check_model_logits(api, params)
        again = check_repeated_prefill(api, params, {"tokens": tokens}, kept,
                                       MOE_P + MOE_G)
    return {"ep_vs_dense_layer": layer, **logits, **again}


def phase_moe_state(api, params, kept, store_dir: str, nranks: int,
                    device) -> dict:
    """The prefill's KV cache saved as ``nranks`` ranks, restored onto this
    card bit for bit; MOE_STATE_DECODE decode steps from it must give the
    tokens the server gave."""
    from repro_torch.launch.serve import decode_steps

    cache, out = kept["cache"], kept["tokens"]
    line, restored = save_restore(
        cache, api.abstract_cache(out.shape[0], MOE_P + MOE_G), store_dir,
        nranks, device)
    first = torch.from_numpy(out[:, :1].copy()).to(device)
    with torch.inference_mode():
        toks = decode_steps(api, params, restored, first, MOE_P,
                            MOE_STATE_DECODE, device)
    if not np.array_equal(torch.cat(toks, dim=1).cpu().numpy(),
                          out[:, :MOE_STATE_DECODE + 1]):
        raise AssertionError("decoding from the restored cache gave other "
                             "tokens than the server")
    return {"phase": "moe_state",
            "arrays": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in cache.items()},
            **line, "decode_steps_from_restored": MOE_STATE_DECODE,
            "continued_tokens_identical": True}


def phase_moe_train(cfg, device) -> dict:
    """Granite at full width, depth cut to MOE_TRAIN_LAYERS, trained
    through the sharded step on a (1, 1) NCCL mesh (``repeat_train``):
    MOE_TRAIN_STEPS steps, then steps 1..MOE_REPEAT_STEPS again from the
    same seed, bit-equal; the aux loss finite and positive.  The launch
    counts are set to 0 by the caller just before and read just after."""
    from repro_torch.launch.mesh import init_distributed, make_debug_mesh
    from repro_torch.models.api import build_model

    api = build_model(cfg)
    init_distributed("cuda", rank=0, world_size=1)
    try:
        line = repeat_train(api, MOE_TRAIN_B, MOE_TRAIN_S, MOE_TRAIN_STEPS,
                            MOE_REPEAT_STEPS, device,
                            mesh=make_debug_mesh(1, 1, device_type="cuda"))
    finally:
        torch.distributed.destroy_process_group()
    aux = line["metrics"]["aux"]
    if not all(np.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"the aux loss is not finite and positive: "
                             f"{aux}")
    return {"phase": "moe_train", **line, "mesh": [1, 1],
            "attention_impl": cfg.attention_impl}


def moe_paths(device, store_dir: str) -> dict:
    """The three MoE phases, each path with the launch counts at 0 just
    before it and read just after.  Returns the launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import moe
    from repro_torch.models.api import build_model

    # as the serving launcher does: prefill attention through the kernel
    full = get_config("granite_moe_3b_a800m")
    cfg = dataclasses.replace(full, attention_impl="pallas",
                              num_layers=MOE_SERVE_LAYERS)
    api = build_model(cfg)
    zero, read, launches = _counter()

    with torch.inference_mode():
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=device).manual_seed(SEED))
        tokens = prompt_batch(cfg, MOE_B, MOE_P, device)["tokens"]
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        # ---- moe_serve: counts at 0 just before, read just after
        zero()
        moe.calls = 0
        serve, kept = phase_moe_serve(api, params, tokens, device)
        serve["kernel_launches"] = read()
        serve["moe_ffn_ep_calls"] = moe.calls
        if serve["kernel_launches"]["flash_attention"] != cfg.num_layers:
            raise AssertionError(f"flash_attention launched "
                                 f"{serve['kernel_launches']} in one "
                                 f"prefill of {cfg.num_layers} layers")
        if moe.calls != cfg.num_layers * (1 + MOE_G):
            raise AssertionError(f"moe_ffn_ep ran {moe.calls} times in a "
                                 f"prefill and {MOE_G} decode steps of "
                                 f"{cfg.num_layers} layers")
        serve["init_seconds"] = t_init
        serve["layers_cut_from"] = full.num_layers
        serve.update(check_moe_serve(api, params, tokens, kept, device))
        serve["phase_seconds"] = time.perf_counter() - t0
        emit(serve)
        # ---- moe_state: counts at 0 just before, read just after
        t0 = time.perf_counter()
        zero()
        state = phase_moe_state(api, params, kept, store_dir, NRANKS, device)
        state["kernel_launches"] = read()
        if not state["kernel_launches"]["ckpt_pack"]:
            raise AssertionError("ckpt_pack never launched in the MoE "
                                 "cache's save")
        state["phase_seconds"] = time.perf_counter() - t0
        emit(state)
        del params, kept, tokens
        torch.cuda.empty_cache()

    # ---- moe_train, outside inference mode (autograd needs it)
    t0 = time.perf_counter()
    tcfg = dataclasses.replace(cfg, num_layers=MOE_TRAIN_LAYERS)
    zero()
    moe.calls = 0
    train = phase_moe_train(tcfg, device)
    train["layers_cut_from"] = full.num_layers
    train["kernel_launches"] = read()
    train["moe_ffn_ep_calls"] = moe.calls
    # a remat span runs its layers again in the backward pass
    per_step = (2 if tcfg.remat else 1) * tcfg.num_layers
    bwd = train["kernel_launches"]["flash_attention_bwd"]
    for what, n, each in (
            ("flash_attention", train["kernel_launches"]["flash_attention"],
             per_step), ("moe_ffn_ep", moe.calls, per_step),
            ("flash_attention_bwd", bwd, tcfg.num_layers)):
        if n != each * train["steps_run"]:
            raise AssertionError(f"{what} ran {n} times in "
                                 f"{train['steps_run']} steps, not "
                                 f"{each} a step")
    train["phase_seconds"] = time.perf_counter() - t0
    emit(train)
    torch.cuda.empty_cache()
    return launches

# --------------------------------------------------------- dense family
def logits_ms(api, params, B: int) -> float:
    """Device ms of the unembedding of B decode rows (``_logits``: the bf16
    copy of the [V, D] table, its f32 copy and the product), the part of a
    decode step that grows with the vocabulary."""
    from repro_torch.models.transformer import _logits

    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.randn((B, 1, api.cfg.d_model), generator=gen, device=dev
                    ).to(getattr(torch, api.cfg.dtype))
    return time_ms(lambda: _logits(params, api.cfg, x), iters=10)


def phase_vlm_state(api, params, store_dir: str, nranks: int,
                    device) -> dict:
    """qwen2-vl's KV cache after a VLM_STATE_B x VLM_STATE_P prefill of its
    embeddings batch into VLM_STATE_LEN slots, saved as ``nranks`` ranks
    and restored onto this card bit for bit; VLM_STATE_DECODE decode steps
    from the restored cache give the tokens of the same steps from the
    original."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import decode_steps, prompt_batch
    from repro_torch.train.step import make_prefill_step

    B, P, G = VLM_STATE_B, VLM_STATE_P, VLM_STATE_DECODE
    batch = prompt_batch(api.cfg, B, P, device, seed=SEED + 4)
    logits, cache = make_prefill_step(
        api, ShapeConfig("serve", P, B, "prefill"),
        cache_len=VLM_STATE_LEN)(params, batch)
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    line, restored = save_restore(
        cache, api.abstract_cache(B, VLM_STATE_LEN), store_dir, nranks,
        device)
    runs = [torch.cat(decode_steps(api, params, c, first, P, G, device),
                      dim=1).cpu().numpy() for c in (restored, cache)]
    if not np.array_equal(*runs):
        raise AssertionError(f"decoding from the restored cache gave "
                             f"{runs[0].tolist()}, from the original "
                             f"{runs[1].tolist()}")
    return {"phase": "vlm_state", "arch": api.cfg.arch,
            "input": sorted(batch), "batch": B, "prompt_len": P,
            "arrays": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in cache.items()},
            **line, "decode_steps_from_restored": G,
            "continued_tokens_identical": True,
            "sample_tokens": runs[0][0].tolist()}


def phase_window_serve(api, params, tokens, device) -> tuple[dict, dict]:
    """The prompt ``tokens`` [B, P] served through ``serve_batch`` for
    WINDOW_G decode steps; the kept prefill output also holds the first
    decode step's logits (row 0)."""
    first_step = {}

    def on_step(i, logits):
        if i == 1:
            first_step["logits"] = logits[0].clone()

    serve, kept = phase_serve_batch("window_serve", api, params,
                                    {"tokens": tokens}, WINDOW_G, device,
                                    on_step=on_step)
    kept["first_step_logits"] = first_step["logits"]
    return serve, kept


def window_readings(api, params, tokens, first, cache, first_step_logits
                    ) -> dict:
    """Past the window: the first decode step's logits (row 0; the step fed
    ``first`` [B, 1] at position P from the prefill's ``cache``) against
    the last-token logits of one prefill of the prompt and that token
    (P + 1 tokens), relative to the prefill logits' scale; and, as a
    control, the same decode step from ``cache`` with the local layers'
    window dropped (``local_window=0``), the fault the check exists to
    catch.  Uses up ``cache``."""
    from repro_torch.models.api import build_model
    from repro_torch.train.step import make_decode_step

    B, P = tokens.shape
    want, _ = api.prefill(params, {"tokens": torch.cat([tokens, first], 1)})
    no_window = build_model(dataclasses.replace(api.cfg, local_window=0))
    fault, _ = make_decode_step(no_window)(params, cache, {
        "token": first, "pos": torch.full((B,), P, dtype=torch.int32,
                                          device=tokens.device)})
    want, got = want[0].float(), first_step_logits.float()
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    top2 = torch.topk(want, 2).values
    return {"dtype": api.cfg.dtype, "prefill_len": P + 1,
            "max_abs_diff": diff, "max_abs_logit": scale, "rel": diff / scale,
            "same_argmax": int(got.argmax()) == int(want.argmax()),
            "prefill_top2_gap": float(top2[0] - top2[1]),
            "no_window_rel": float((fault[0].float() - want).abs().max())
            / scale}


def window_f32_readings(api, params, tokens) -> dict:
    """``window_readings`` for the same weights in f32 (prefill of the
    prompt, its greedy token decoded at position P), where rounding sits
    far below what dropping the window moves."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import build_model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    B, P = tokens.shape
    api32 = build_model(dataclasses.replace(api.cfg, dtype="float32"))
    p32 = {k: v.float() for k, v in params.items()}
    logits, cache = make_prefill_step(
        api32, ShapeConfig("serve", P, B, "prefill"),
        cache_len=P + 1)(p32, {"tokens": tokens})
    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    got, _ = make_decode_step(api32)(
        p32, {k: v.clone() for k, v in cache.items()},
        {"token": first, "pos": torch.full((B,), P, dtype=torch.int32,
                                           device=tokens.device)})
    return window_readings(api32, p32, tokens, first, cache, got[0])


def check_window_consistency(api, params, tokens, kept) -> dict:
    """gemma2 past its window.  bf16, as served: the first decode step
    within WINDOW_RTOL of one prefill of P + 1, same argmax.  f32, the same
    weights: within WINDOW_F32_RTOL, while the window-dropped control falls
    outside it (in bf16 the control reads only about twice the sound
    step's rounding, so the f32 leg is the one that holds the window)."""
    first = torch.from_numpy(kept["tokens"][:, :1].copy()).to(tokens.device)
    line = {"bf16": window_readings(api, params, tokens, first,
                                    kept["cache"], kept["first_step_logits"]),
            "f32": window_f32_readings(api, params, tokens),
            "rtol": WINDOW_RTOL, "f32_rtol": WINDOW_F32_RTOL}
    bf16, f32 = line["bf16"], line["f32"]
    if not bf16["same_argmax"] or bf16["rel"] > WINDOW_RTOL:
        raise AssertionError(f"decode past the window disagrees with one "
                             f"prefill: {line}")
    if not f32["same_argmax"] or f32["rel"] > WINDOW_F32_RTOL:
        raise AssertionError(f"decode past the window disagrees with one "
                             f"prefill in f32: {line}")
    if f32["no_window_rel"] <= WINDOW_F32_RTOL:
        raise AssertionError(f"decoding with the window dropped passes the "
                             f"f32 window check: {line}")
    return line


def dense_paths(device, store_dir: str) -> dict:
    """The dense family's phases, each path with the launch counts at 0
    just before it and read just after: ``dense_serve`` (qwen3-4b, then
    qwen2-vl-7b from its embeddings batch), ``vlm_state`` (qwen2-vl's cache
    4 -> 1) and ``window_serve`` (gemma2-2b past its window, then the
    port's ``serve_batched`` example).  Each model is freed before the
    next is seeded.  Returns the launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_batched
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.api import build_model

    zero, read, launches = _counter()

    def seeded(arch):
        # as the serving launcher does: prefill attention through the
        # kernel where the reference's dispatch takes it
        cfg = dataclasses.replace(get_config(arch), attention_impl="pallas")
        api = build_model(cfg)
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        return api, params, time.perf_counter() - t0

    with torch.inference_mode():
        for arch in DENSE_ARCHS:
            t0 = time.perf_counter()
            api, params, t_init = seeded(arch)
            batch = prompt_batch(api.cfg, DENSE_B, DENSE_P, device)
            # ---- dense_serve: counts at 0 just before, read just after
            zero()
            serve, kept = phase_serve_batch("dense_serve", api, params,
                                            batch, DENSE_G, device)
            serve["kernel_launches"] = read()
            if serve["kernel_launches"]["flash_attention"] != \
                    api.cfg.num_layers:
                raise AssertionError(f"flash_attention launched "
                                     f"{serve['kernel_launches']} in one "
                                     f"prefill of {api.cfg.num_layers} "
                                     f"layers")
            serve["init_seconds"] = t_init
            serve["logits_ms"] = logits_ms(api, params, DENSE_B)
            serve["logits_share_of_decode_step"] = (
                serve["logits_ms"] / serve["decode_step_ms"])
            serve.update(check_model_logits(
                api, params, prompt_batch(api.cfg, 2, 96, device,
                                          seed=SEED + 1)))
            serve.update(check_repeated_prefill(api, params, batch, kept,
                                                DENSE_P + DENSE_G))
            serve["phase_seconds"] = time.perf_counter() - t0
            emit(serve)
            del kept, batch
            if api.cfg.input_mode == "embeds":
                # ---- vlm_state: counts at 0 just before, read just after
                t0 = time.perf_counter()
                zero()
                state = phase_vlm_state(api, params, store_dir, NRANKS,
                                        device)
                state["kernel_launches"] = read()
                if not state["kernel_launches"]["ckpt_pack"]:
                    raise AssertionError("ckpt_pack never launched in the "
                                         "VLM cache's save")
                state["phase_seconds"] = time.perf_counter() - t0
                emit(state)
            del params
            torch.cuda.empty_cache()

        # ---- window_serve: counts at 0 just before, read just after
        t0 = time.perf_counter()
        api, params, t_init = seeded("gemma2_2b")
        tokens = prompt_batch(api.cfg, WINDOW_B, WINDOW_P, device)["tokens"]
        zero()
        serve, kept = phase_window_serve(api, params, tokens, device)
        serve["kernel_launches"] = read()
        if serve["kernel_launches"]["flash_attention"]:
            raise AssertionError(f"gemma2's alternating layers reached the "
                                 f"flash kernel: {serve['kernel_launches']}")
        serve.update({"init_seconds": t_init,
                      "window": api.cfg.local_window,
                      "layer_kinds": sorted(set(api.cfg.layer_kinds()))})
        serve["logits_ms"] = logits_ms(api, params, WINDOW_B)
        serve["logits_share_of_decode_step"] = (
            serve["logits_ms"] / serve["decode_step_ms"])
        serve.update(check_model_logits(api, params, {"tokens": tokens}))
        serve["decode_vs_prefill"] = check_window_consistency(
            api, params, tokens, kept)
        del params, kept
        torch.cuda.empty_cache()
        # the port of examples/serve_batched.py on the card (gemma2 smoke)
        t1 = time.perf_counter()
        zero()
        example = serve_batched.main(["--device", str(device)])
        serve["serve_batched_example"] = {
            "seconds": time.perf_counter() - t1,
            "tokens": list(example.shape), "kernel_launches": read()}
        serve["phase_seconds"] = time.perf_counter() - t0
        emit(serve)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ recurrent training
def repeat_train(api, B: int, S: int, steps: int, repeat: int, device,
                 mesh=None, opt=None, data=None,
                 report_state: bool = False, lr: float = TRAIN_LR,
                 hold: int = 0) -> dict:
    """``steps`` steps of ``make_train_step`` (sharded over ``mesh`` when one
    is given) under ``opt`` (AdamW by default) in deterministic mode from
    the seeded state (finite, falling loss) on the batches of ``data``
    (``SyntheticLM`` by default), the state after step ``repeat`` kept on
    the host, under warmup_cosine(``lr``, warmup TRAIN_WARMUP); then steps
    1..``repeat`` again from the same seed, bit-equal
    to it in every array and every loss.  ``report_state`` adds each
    array's shape and dtype.  ``hold`` > 0 adds ``"held"``: the state
    after step ``hold``, on the host.  The launch counts are set to 0 by
    the caller just before and read just after."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.device import use_deterministic_algorithms
    from repro_torch.distrib.rules import local_box
    from repro_torch.train import (AdamW, SyntheticLM, init_train_state,
                                   make_train_step, warmup_cosine)
    from repro_torch.train.step import shard_state

    use_deterministic_algorithms()
    opt = opt or AdamW()
    step = make_train_step(api, opt, functools.partial(
        warmup_cosine, base_lr=lr, warmup=TRAIN_WARMUP, total=steps),
        ShapeConfig("train", S, B, "train"), mesh=mesh)
    data = data or SyntheticLM(api.cfg.vocab, S, B, seed=SEED)

    def local(state):
        return state if mesh is None else {k: t.to_local()
                                           for k, t in state.items()}

    def batch(i):
        def mine(k, v):     # this process's block of the batch array
            return v if mesh is None else np.ascontiguousarray(v[local_box(
                v.shape, mesh, step.batch_shardings[k]).slices()])
        return {k: torch.from_numpy(mine(k, v)).to(device)
                for k, v in data.batch(i).items()}

    held = []

    def run(n):
        state = init_train_state(
            api, opt, torch.Generator(device=device).manual_seed(SEED))
        if mesh is not None:
            state = shard_state(state, mesh, step.state_shardings)
        history, seconds, kept = [], [], None
        for i in range(n):
            inputs = batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, inputs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            history.append({k: float(v) for k, v in m.items()})
            if i + 1 == repeat:
                kept = {k: t.cpu() for k, t in local(state).items()}
            if i + 1 == hold and not held:
                held.append({k: t.cpu() for k, t in local(state).items()})
        return local(state), history, seconds, kept

    torch.cuda.reset_peak_memory_stats()
    state, history, seconds, kept = run(steps)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for k, t in state.items()
                   if k.startswith("params/"))
    state_bytes = sum(t.numel() * t.element_size() for t in state.values())
    del state
    again, again_history, _, _ = run(repeat)
    differ = [k for k in kept if not _same_bits(kept[k], again[k].cpu())]
    n_arrays = len(kept)
    del again
    losses = [h["loss"] for h in history]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the loss is not finite and falling: {losses}")
    if differ or [h["loss"] for h in again_history] != losses[:repeat]:
        raise AssertionError(f"two runs of steps 1-{repeat} from one seed "
                             f"differ in {differ or 'their losses'}")
    median = float(np.median(seconds[1:]))
    shapes = {k: [list(t.shape), str(t.dtype).removeprefix("torch.")]
              for k, t in kept.items()} if report_state else None
    return {"arch": api.cfg.arch, "layers": api.cfg.num_layers,
            "params": n_params, "state_bytes": state_bytes, "batch": B,
            "seq": S, "remat": api.cfg.remat, "optimizer": opt.name,
            "deterministic": torch.are_deterministic_algorithms_enabled(),
            "losses": losses,
            "metrics": {k: [h[k] for h in history] for k in history[0]
                        if k != "loss"},
            "step_ms": [t * 1e3 for t in seconds],
            "step_ms_median_2_on": median * 1e3,
            "tokens_per_s": B * S / median, "peak_memory_allocated": peak,
            "repeat_steps": repeat, "repeat_bit_equal_arrays": n_arrays,
            "steps_run": steps + repeat,
            **({"state_arrays": shapes} if report_state else {}),
            **({"held": held[0]} if hold else {})}


def slstm_share(api, params, batch) -> dict:
    """One more prefill of ``batch`` with each sLSTM block's time taken
    alone (a synchronise either side): the time loop's share of the
    prefill."""
    from repro_torch.models import xlstm

    inner, spent = xlstm._slstm_block, [0.0]

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    xlstm._slstm_block = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            api.prefill(params, batch)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        xlstm._slstm_block = inner
    return {"prefill_seconds_timed": total, "slstm_seconds": spent[0],
            "slstm_share_of_prefill": spent[0] / total}


def f32_decode_reading(api, params, batch, rtol: float) -> dict:
    """Row 0 of ``batch`` (its ``tokens`` [1, P] and any other inputs, such
    as an encoder's frames): the first decode step after a prefill of the
    prompt against one prefill of the prompt and that token, for the same
    weights in f32 (an f32 model: whisper's encoder casts its frames to
    the model's dtype), within ``rtol`` of the logits' scale and with the
    same argmax; and the bf16 floor: the bf16 prefill of P + 1 against the
    f32 one."""
    from repro_torch.models.api import build_model

    api32 = build_model(dataclasses.replace(api.cfg, dtype="float32"))
    f32 = {k: v.float() for k, v in params.items()}
    row = {k: v[:1] for k, v in batch.items()}
    tokens = row["tokens"]
    P = tokens.shape[1]
    first, cache = api32.prefill(f32, row, P + 1)
    token = torch.argmax(first, -1).to(torch.int32)[:, None]
    got, _ = api32.decode_step(f32, cache, {"token": token, "pos": torch.full(
        (1,), P, dtype=torch.int32, device=tokens.device)})
    longer = {**row, "tokens": torch.cat([tokens, token], dim=1)}
    want, _ = api32.prefill(f32, longer)
    bf16, _ = api.prefill(params, longer)
    scale = float(want.abs().max())
    line = {"rtol": rtol,
            "rel": float((got - want).abs().max()) / scale,
            "same_argmax": bool((got.argmax(-1) == want.argmax(-1)).all()),
            "bf16_prefill_rel_vs_f32": float((bf16.float() - want).abs()
                                             .max()) / scale}
    if line["rel"] > rtol or not line["same_argmax"]:
        raise AssertionError(f"{api.cfg.arch} decode disagrees with prefill "
                             f"in f32: {line}")
    return line


def recurrent_paths(device, store_dirs) -> dict:
    """The recurrent families' phases, each path with the launch counts at
    0 just before it and read just after: ``hybrid_train``
    (recurrentgemma-9b at 3 layers), ``xlstm_serve``, ``xlstm_state`` and
    ``xlstm_train`` (xlstm-350m).  Returns the launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import decode_steps, prompt_batch
    from repro_torch.models.api import build_model

    zero, read, launches = _counter()

    # ---- hybrid_train: counts at 0 just before, read just after
    t0 = time.perf_counter()
    cfg = get_config("recurrentgemma_9b")
    api = build_model(dataclasses.replace(cfg,
                                          num_layers=HYBRID_TRAIN_LAYERS))
    zero()
    train = {"phase": "hybrid_train", **repeat_train(
        api, HYBRID_TRAIN_B, HYBRID_TRAIN_S, HYBRID_TRAIN_STEPS,
        HYBRID_REPEAT_STEPS, device)}
    train["layers_cut_from"] = cfg.num_layers
    train["kernel_launches"] = read()
    # each RG-LRU layer a step: the forward, remat's recompute, backward
    n_lru = sum(k == "lru" for k in api.cfg.layer_kinds())
    per_step = (3 if api.cfg.remat else 2) * n_lru
    train["rglru_scan_per_step"] = per_step
    if train["kernel_launches"]["rglru_scan"] != per_step * train["steps_run"]:
        raise AssertionError(f"rglru_scan launched "
                             f"{train['kernel_launches']['rglru_scan']} "
                             f"times in {train['steps_run']} steps, not "
                             f"{per_step} a step")
    train["phase_seconds"] = time.perf_counter() - t0
    emit(train)
    del api
    torch.cuda.empty_cache()

    # ---- xlstm_serve: counts at 0 just before, read just after
    full = get_config("xlstm_350m")
    cfg = dataclasses.replace(full, num_layers=XLSTM_SERVE_LAYERS)
    api = build_model(cfg)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        batch = prompt_batch(cfg, XLSTM_B, XLSTM_P, device)
        step_logits = {}

        def on_step(i, logits):
            if i in CONSISTENCY_STEPS:
                step_logits[i] = logits[0].float().clone()

        zero()
        serve, kept = phase_serve_batch("xlstm_serve", api, params, batch,
                                        XLSTM_G, device, on_step=on_step)
        serve["kernel_launches"] = read()
        kept["step_logits"] = step_logits
        serve["init_seconds"] = t_init
        serve["state_bytes"] = sum(t.numel() * t.element_size()
                                   for t in kept["cache"].values())
        serve.update(check_repeated_prefill(api, params, batch, kept,
                                            XLSTM_P + XLSTM_G))
        serve.update(slstm_share(api, params, batch))
        serve["decode_vs_prefill"] = decode_vs_prefill(
            api, params, batch["tokens"], kept, XLSTM_RTOL)
        serve["decode_vs_prefill_f32"] = f32_decode_reading(
            api, params, batch, XLSTM_F32_RTOL)
        serve["phase_seconds"] = time.perf_counter() - t0
        emit(serve)
        if serve["decode_vs_prefill"]["failed"]:
            raise AssertionError(f"xlstm decode disagrees with prefill: "
                                 f"{serve['decode_vs_prefill']['failed']}")
        del kept, batch

        # ---- xlstm_state: counts at 0 just before, read just after
        t0 = time.perf_counter()
        tokens = prompt_batch(cfg, XLSTM_STATE_B, XLSTM_P, device)["tokens"]
        zero()
        first, live = api.prefill(params, {"tokens": tokens})
        line, restored = save_restore(
            live, api.abstract_cache(XLSTM_STATE_B, XLSTM_P),
            store_dirs[0], NRANKS, device)
        token = torch.argmax(first, -1).to(torch.int32)[:, None]
        runs = []
        for cache in (live, restored):
            logits = []
            toks = decode_steps(api, params, cache, token, XLSTM_P,
                                XLSTM_STATE_DECODE, device,
                                on_step=lambda i, x: logits.append(x))
            runs.append((torch.cat(toks, 1), logits))
        state = {"phase": "xlstm_state",
                 "arrays": {k: [list(v.shape),
                                str(v.dtype).removeprefix("torch.")]
                            for k, v in live.items()},
                 **line, "kernel_launches": read(),
                 "decode_steps_from_restored": XLSTM_STATE_DECODE}
        if not (torch.equal(runs[0][0], runs[1][0]) and all(
                _same_bits(a, b) for a, b in zip(runs[0][1], runs[1][1]))):
            raise AssertionError("decoding from the restored state differs "
                                 "from decoding from the live one")
        state["continued_logits_bit_equal"] = True
        if not state["kernel_launches"]["ckpt_pack"]:
            raise AssertionError("ckpt_pack never launched in the xlstm "
                                 "state's save")
        state["phase_seconds"] = time.perf_counter() - t0
        emit(state)
        del params, live, restored, runs
        torch.cuda.empty_cache()

    # ---- xlstm_train: full size, steps repeated; then the kill and resume
    # at XLSTM_RESUME_LAYERS; counts at 0 just before, read just after
    t0 = time.perf_counter()
    zero()
    train = {"phase": "xlstm_train", **repeat_train(
        build_model(dataclasses.replace(cfg, num_layers=XLSTM_TRAIN_LAYERS)),
        XLSTM_TRAIN_B, XLSTM_TRAIN_S, XLSTM_TRAIN_STEPS,
        XLSTM_REPEAT_STEPS, device)}
    train["kernel_launches"] = read()
    train["layers_cut_from"] = full.num_layers
    torch.cuda.empty_cache()
    # A, B and C count each run's launches themselves (ckpt_pack on every
    # save)
    t1 = time.perf_counter()
    small = build_model(dataclasses.replace(cfg,
                                            num_layers=XLSTM_RESUME_LAYERS))
    train["resume"], _ = kill_and_resume(small, XLSTM_TRAIN_B, XLSTM_TRAIN_S,
                                         store_dirs[1:], device)
    for k, n in train["resume"]["total_launches"].items():
        launches[k] += n
    train["resume"]["layers_cut_from"] = full.num_layers
    train["resume"]["phase_seconds"] = time.perf_counter() - t1
    train["phase_seconds"] = time.perf_counter() - t0
    emit(train)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------- whisper, kimi-k2 and quickstart
def frames_data(cfg, S: int, B: int):
    """An encoder-decoder's train data: ``SyntheticLM``'s batches plus
    ``enc_frames`` [B, Se, D] drawn from (SEED, step), normal with scale
    0.5 as ``make_token_batch`` draws them (the trainer alone feeds zero
    frames, as the reference's does, which leave the encoder without a
    gradient)."""
    from repro_torch.train import SyntheticLM

    class FramesLM(SyntheticLM):
        def batch(self, step: int) -> dict:
            out = super().batch(step)
            out["enc_frames"] = np.random.default_rng([SEED, step]).normal(
                size=(self.global_batch, cfg.encoder_seq, cfg.d_model),
                scale=0.5).astype(np.float32)
            return out

    return FramesLM(cfg.vocab, S, B, seed=SEED)


def restart_cache(api, params, kept, store_dir: str, P: int, steps: int,
                  device) -> dict:
    """The served prefill's cache (``kept["cache"]``) saved as NRANKS ranks
    and restored onto this card bit for bit (``save_restore``); ``steps``
    decode steps from the restored cache must give the served tokens."""
    from repro_torch.launch.serve import decode_steps

    cache, out = kept["cache"], kept["tokens"]
    line, restored = save_restore(
        cache, api.abstract_cache(out.shape[0], cache["k"].shape[2]),
        store_dir, NRANKS, device)
    first = torch.from_numpy(out[:, :1].copy()).to(device)
    with torch.inference_mode():
        toks = decode_steps(api, params, restored, first, P, steps, device)
    if not np.array_equal(torch.cat(toks, dim=1).cpu().numpy(),
                          out[:, :steps + 1]):
        raise AssertionError("decoding from the restored cache gave other "
                             "tokens than the server")
    return {"arrays": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                       for k, v in cache.items()},
            **line, "decode_steps_from_restored": steps,
            "continued_tokens_identical": True}


def whisper_bos_primed(api, params, frames) -> dict:
    """A prefill of frames alone primes the decoder with a zero BOS
    column: finite [B, V] logits and a cache of length 1."""
    logits, cache = api.prefill(params, {"enc_frames": frames})
    B = frames.shape[0]
    if (logits.shape != (B, api.cfg.vocab) or not torch.isfinite(logits)
            .all() or int(cache["length"]) != 1):
        raise AssertionError(f"BOS-primed prefill: logits "
                             f"{tuple(logits.shape)}, length "
                             f"{int(cache['length'])}")
    return {"batch": B, "length": 1, "finite": True,
            "cache": {k: list(v.shape) for k, v in cache.items()}}


def check_flash_at(B: int, S: int, Hq: int, Hkv: int, hd: int) -> dict:
    """The flash forward kernel at one causal shape against
    ``attention_ref`` (within ATTN_ATOL + ATTN_RTOL |plain|), its device
    time beside SDPA's (cuDNN and FlashAttention-2; deterministic mode,
    which the train phases leave on, is off while SDPA is timed: cuDNN's
    attention refuses it) and its bound."""
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for shape in
               ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    got = flash_attention(q, k, v, causal=True).float()
    want = attention_ref(q, k, v, causal=True).float()
    err = (got - want).abs()
    bad = int((err > ATTN_ATOL + ATTN_RTOL * want.abs()).sum())
    ops = 4 * B * Hq * hd * _pairs(S, S, 0, True, 0)
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        sdpa = {b.name: _sdpa(q, k, v, b) for b in (
            SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION)}
    finally:
        torch.use_deterministic_algorithms(deterministic)
    line = {"shape": [B, S, S, Hq, Hkv, hd], "max_abs_err": float(err.max()),
            "outside_tol": bad,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
            "sdpa_ms_by_backend": sdpa,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention outside tolerance at kimi's "
                             f"heads: {line}")
    return line


def whisper_paths(device, store_dirs) -> dict:
    """whisper-base's phases, each path with the launch counts at 0 just
    before it and read just after: ``whisper_serve``, ``whisper_state``
    (its cache 4 -> 1) and ``whisper_train`` (repeated steps at full size,
    then the kill and resume).  Its attention is the blocked plain path,
    as in the reference, so only ckpt_pack launches (in the saves).
    Returns the launches per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models.api import build_model

    zero, read, launches = _counter()
    # as the serving launcher sets it; the family ignores attention_impl
    cfg = dataclasses.replace(get_config("whisper_base"),
                              attention_impl="pallas")
    api = build_model(cfg)
    sapi = build_model(dataclasses.replace(
        cfg, num_layers=WHISPER_SERVE_LAYERS,
        encoder_layers=WHISPER_SERVE_LAYERS))
    with torch.inference_mode():
        # ---- whisper_serve: counts at 0 just before, read just after
        t0 = time.perf_counter()
        params = sapi.init(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        batch = prompt_batch(cfg, WHISPER_B, WHISPER_P, device)
        step_logits = {}

        def on_step(i, logits):
            if i in CONSISTENCY_STEPS:
                step_logits[i] = logits[0].float().clone()

        zero()
        serve, kept = phase_serve_batch("whisper_serve", sapi, params,
                                        batch, WHISPER_G, device,
                                        on_step=on_step)
        serve["kernel_launches"] = read()
        kept["step_logits"] = step_logits
        serve.update({"init_seconds": t_init,
                      "encoder_layers": sapi.cfg.encoder_layers,
                      "layers_cut_from": cfg.num_layers,
                      "enc_frames": list(batch["enc_frames"].shape)})
        serve.update(check_repeated_prefill(sapi, params, batch, kept,
                                            WHISPER_P + WHISPER_G))
        serve["decode_vs_prefill"] = decode_vs_prefill(
            sapi, params, batch["tokens"], kept, WHISPER_RTOL,
            extra={"enc_frames": batch["enc_frames"][:1]})
        serve["decode_vs_prefill_f32"] = f32_decode_reading(
            sapi, params, batch, WHISPER_F32_RTOL)
        serve["bos_primed"] = whisper_bos_primed(sapi, params,
                                                 batch["enc_frames"])
        serve["phase_seconds"] = time.perf_counter() - t0
        emit(serve)
        if serve["decode_vs_prefill"]["failed"]:
            raise AssertionError(f"whisper decode disagrees with prefill: "
                                 f"{serve['decode_vs_prefill']['failed']}")

        # ---- whisper_state: counts at 0 just before, read just after
        t0 = time.perf_counter()
        zero()
        state = {"phase": "whisper_state", **restart_cache(
            sapi, params, kept, store_dirs[0], WHISPER_P,
            WHISPER_STATE_DECODE, device)}
        state["kernel_launches"] = read()
        state["cross_kv_bytes"] = sum(kept["cache"][k].numel() * 2
                                      for k in ("xk", "xv"))
        if not state["kernel_launches"]["ckpt_pack"]:
            raise AssertionError("ckpt_pack never launched in whisper's "
                                 "cache save")
        state["phase_seconds"] = time.perf_counter() - t0
        emit(state)
        del params, kept, batch
        torch.cuda.empty_cache()

    # ---- whisper_train: full size, steps repeated; then the kill and
    # resume; counts at 0 just before, read just after
    t0 = time.perf_counter()
    zero()
    train = {"phase": "whisper_train", **repeat_train(
        api, WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS,
        WHISPER_REPEAT_STEPS, device,
        data=frames_data(cfg, WHISPER_TRAIN_S, WHISPER_TRAIN_B))}
    train["encoder_frames"] = cfg.encoder_seq
    train["kernel_launches"] = read()
    torch.cuda.empty_cache()
    # A, B and C count each run's launches themselves (ckpt_pack on every
    # save)
    t1 = time.perf_counter()
    rcfg = cfg if WHISPER_RESUME_LAYERS is None else dataclasses.replace(
        cfg, encoder_layers=WHISPER_RESUME_LAYERS,
        num_layers=WHISPER_RESUME_LAYERS)
    train["resume"], _ = kill_and_resume(
        build_model(rcfg), WHISPER_TRAIN_B, WHISPER_TRAIN_S, store_dirs[1:],
        device, data=frames_data(rcfg, WHISPER_TRAIN_S, WHISPER_TRAIN_B))
    for k, n in train["resume"]["total_launches"].items():
        launches[k] += n
    train["resume"]["encoder_layers"] = rcfg.encoder_layers
    train["resume"]["phase_seconds"] = time.perf_counter() - t1
    train["phase_seconds"] = time.perf_counter() - t0
    emit(train)
    torch.cuda.empty_cache()
    return launches


def kimi_paths(device, store_dirs) -> dict:
    """kimi-k2's phases, each path with the launch counts at 0 just before
    it and read just after: ``kimi_serve`` (one layer at full width, its KV
    cache 4 -> 1) and ``kimi_train`` (Adafactor: the experts cut to
    KIMI_TRAIN_EXPERTS, steps repeated; then the kill and resume at the
    smoke config).  Returns the launches per kernel, and what
    ``adafactor_mesh`` holds its steps to: the state after ADA_STEPS steps
    (on the host), those steps' metrics and ms."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import moe
    from repro_torch.models.api import build_model
    from repro_torch.train import Adafactor, train_state_specs

    zero, read, launches = _counter()
    full = get_config("kimi_k2_1t_a32b")
    # as the serving launcher does: prefill attention through the kernel
    cfg = dataclasses.replace(full, num_layers=KIMI_SERVE_LAYERS,
                              attention_impl="pallas")
    api = build_model(cfg)
    with torch.inference_mode():
        # ---- kimi_serve: counts at 0 just before, read just after
        t0 = time.perf_counter()
        params = api.init(torch.Generator(device=device).manual_seed(SEED))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        batch = prompt_batch(cfg, KIMI_B, KIMI_P, device)
        zero()
        moe.calls = 0
        serve, kept = phase_serve_batch("kimi_serve", api, params, batch,
                                        KIMI_G, device)
        serve["kernel_launches"] = read()
        serve["moe_ffn_ep_calls"] = moe.calls
        if serve["kernel_launches"]["flash_attention"] != cfg.num_layers:
            raise AssertionError(f"flash_attention launched "
                                 f"{serve['kernel_launches']} in one "
                                 f"prefill of {cfg.num_layers} layers")
        if moe.calls != cfg.num_layers * (1 + KIMI_G):
            raise AssertionError(f"moe_ffn_ep ran {moe.calls} times in a "
                                 f"prefill and {KIMI_G} decode steps of "
                                 f"{cfg.num_layers} layers")
        serve.update({"init_seconds": t_init,
                      "layers_cut_from": full.num_layers,
                      "experts": [cfg.moe.num_experts,
                                  cfg.moe.num_experts_padded],
                      "top_k": cfg.moe.top_k})
        serve["flash_at_kimi_heads"] = check_flash_at(
            KIMI_B, KIMI_P, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
        serve.update(check_model_logits(
            api, params, prompt_batch(cfg, 2, 96, device, seed=SEED + 1)))
        serve["ep_vs_dense_layer"] = check_moe_layer(
            cfg, params, device, KIMI_LAYER_B, KIMI_LAYER_S)
        serve.update(check_repeated_prefill(api, params, batch, kept,
                                            KIMI_P + KIMI_G))
        # the KV cache 4 -> 1: counts at 0 just before, read just after
        t1 = time.perf_counter()
        zero()
        restart = restart_cache(api, params, kept, store_dirs[0], KIMI_P,
                                KIMI_STATE_DECODE, device)
        restart["kernel_launches"] = read()
        if not restart["kernel_launches"]["ckpt_pack"]:
            raise AssertionError("ckpt_pack never launched in kimi's cache "
                                 "save")
        restart["phase_seconds"] = time.perf_counter() - t1
        serve["cache_restart"] = restart
        serve["phase_seconds"] = time.perf_counter() - t0
        emit(serve)
        del params, kept, batch
        torch.cuda.empty_cache()

    # ---- kimi_train: Adafactor, steps repeated; counts at 0 just before,
    # read just after
    t0 = time.perf_counter()
    tcfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, num_experts=KIMI_TRAIN_EXPERTS))
    tapi = build_model(tcfg)
    zero()
    moe.calls = 0
    train = {"phase": "kimi_train", **repeat_train(
        tapi, KIMI_TRAIN_B, KIMI_TRAIN_S, KIMI_TRAIN_STEPS,
        KIMI_REPEAT_STEPS, device, opt=Adafactor(), report_state=True,
        lr=KIMI_TRAIN_LR, hold=ADA_STEPS)}
    history = [{"loss": train["losses"][i],
                **{k: v[i] for k, v in train["metrics"].items()}}
               for i in range(ADA_STEPS)]
    one = (train.pop("held"), history, train["step_ms"][:ADA_STEPS])
    train["kernel_launches"] = read()
    train["moe_ffn_ep_calls"] = moe.calls
    train.update({"layers_cut_from": full.num_layers,
                  "experts_cut_from": full.moe.num_experts,
                  "experts": tcfg.moe.num_experts, "top_k": tcfg.moe.top_k})
    # the reference's slot names and shapes (the CPU tests hold the port's
    # specs to the reference's): vr/ and vc/ for a factored parameter, v/
    # for the rest
    specs = train_state_specs(tapi, Adafactor())
    got = train.pop("state_arrays")
    want = {k: [list(s.shape), s.dtype] for k, s in specs.items()}
    if got != want:
        raise AssertionError(f"the Adafactor state's arrays differ from its "
                             f"specs: {sorted(set(got) ^ set(want))}")
    train["state_slots"] = {p: sum(k.startswith(f"opt/{p}/") for k in got)
                            for p in ("vr", "vc", "v")}
    # a remat span runs its layer again in the backward pass
    per_step = (2 if tcfg.remat else 1) * tcfg.num_layers
    for what, n, each in (
            ("flash_attention", train["kernel_launches"]["flash_attention"],
             per_step), ("moe_ffn_ep", moe.calls, per_step),
            ("flash_attention_bwd",
             train["kernel_launches"]["flash_attention_bwd"],
             tcfg.num_layers)):
        if n != each * train["steps_run"]:
            raise AssertionError(f"{what} ran {n} times in "
                                 f"{train['steps_run']} steps, not {each} "
                                 f"a step")
    torch.cuda.empty_cache()
    # A, B and C of an Adafactor state at the smoke config (they count
    # their own launches)
    t1 = time.perf_counter()
    train["resume"], _ = kill_and_resume(
        build_model(get_smoke_config("kimi_k2_1t_a32b")), KIMI_RESUME_B,
        KIMI_RESUME_S, store_dirs[1:], device, opt=Adafactor(),
        lr=KIMI_RESUME_LR)
    for k, n in train["resume"]["total_launches"].items():
        launches[k] += n
    train["resume"]["phase_seconds"] = time.perf_counter() - t1
    train["phase_seconds"] = time.perf_counter() - t0
    emit(train)
    torch.cuda.empty_cache()
    return launches, one


def quickstart_path(device) -> dict:
    """The port of ``examples/quickstart.py`` on the card, with the launch
    counts at 0 just before it and read just after: its first save packs
    each of the 4 ranks' chunks through ckpt_pack (one launch a rank and
    array); the next three steps commit the same host blocks, as the
    reference's script does."""
    import contextlib
    import io

    from repro_torch.examples import quickstart

    zero, read, launches = _counter()
    t0 = time.perf_counter()
    zero()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        store = quickstart.main(["--device", str(device)])
    line = {"phase": "quickstart", "kernel_launches": read(),
            "lines": out.getvalue().splitlines()}
    shutil.rmtree(store, ignore_errors=True)
    if not line["kernel_launches"]["ckpt_pack"]:
        raise AssertionError("ckpt_pack never launched in the quickstart")
    line["phase_seconds"] = time.perf_counter() - t0
    emit(line)
    return launches


def serve_mesh_path(device, scratch: Path) -> dict:
    """The ``serve_mesh`` phase: the CPU leg (4 spawned processes serve on
    (2, 2) and save the sharded cache), the card leg (restored 4 -> 1 on a
    (1, 1) NCCL mesh, every array bit-equal; SERVE_MESH_CARD_G decode steps
    through the mesh builders, each step's logits bit-equal to the
    one-device step's from the same restored cache; a prefill through the
    mesh builder, bit-equal to the one-device prefill, its flash kernel
    launches counted; the decoded cache saved as one rank through
    ckpt_pack and read back bit for bit), then the serve launcher on the
    card in the environment torchrun gives a world of one.  The counts are
    at 0 just before the card leg and read just after its path (the
    one-device prefill it is held to comes after the reading)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import (layout_from_torch, load_torch,
                                           save_torch)
    from repro_torch.distrib.rules import rules_for
    from repro_torch.launch.mesh import (free_port, init_distributed,
                                         make_debug_mesh)
    from repro_torch.launch.serve import greedy, shard_params
    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model
    from repro_torch.train.step import make_decode_step, make_prefill_step

    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from helpers.torch_serve_mesh_workers import (full_width_config,
                                                  serve_and_save)

    B, P, G, G2 = (SERVE_MESH_B, SERVE_MESH_P, SERVE_MESH_G,
                   SERVE_MESH_CARD_G)
    cache_len, step = P + G + G2, 1
    t_phase = time.perf_counter()
    stores = [tempfile.mkdtemp(prefix="serve_mesh_", dir=scratch)
              for _ in range(2)]
    keep = str(scratch / "serve_mesh_cache.pt")
    legs = []
    try:
        # ---- the CPU leg: 4 processes on (2, 2)
        t0 = time.perf_counter()
        cpu = run_processes(serve_and_save, 4, (
            "smollm_135m", SERVE_MESH_LAYERS, SERVE_MESH_N, B, P, G,
            cache_len, stores[0], step, keep, SEED),
            timeout=SERVE_MESH_TIMEOUT, pg_timeout=SERVE_MESH_TIMEOUT)
        kept = torch.load(keep)
        legs.append({"leg": "N", "processes": 4, "device": "cpu",
                     "mesh": list(SERVE_MESH_N),
                     "prefill_seconds": max(r["prefill_seconds"] for r in cpu),
                     "decode_seconds": max(r["decode_seconds"] for r in cpu),
                     "save_seconds": max(r["save_seconds"] for r in cpu),
                     "placements": cpu[0]["placements"],
                     "local_shapes": cpu[0]["local_shapes"],
                     "seconds": time.perf_counter() - t0})

        # ---- the card leg: one NCCL process on (1, 1)
        t0 = time.perf_counter()
        cfg = full_width_config("smollm_135m", SERVE_MESH_LAYERS)
        api, rules = build_model(cfg), rules_for(cfg.arch)
        zero, read, launches = _counter()
        zero()
        init_distributed("cuda", rank=0, world_size=1,
                         timeout=SERVE_MESH_TIMEOUT)
        try:
            mesh = make_debug_mesh(*SERVE_MESH_CARD, device_type="cuda")
            with torch.inference_mode():
                params = {k: v.to(device) for k, v in api.init(
                    torch.Generator().manual_seed(SEED)).items()}
                sharded = shard_params(api, params, mesh, rules)
                shape = ShapeConfig("serve", P, B, "prefill")
                prefill = make_prefill_step(api, shape, cache_len, mesh=mesh,
                                            rules=rules)
                t1 = time.perf_counter()
                ck = TensorCheckpoint(DatasetStore(stores[0], "r"))
                cache = load_torch(ck, api.abstract_cache(B, cache_len), step,
                                   device="cuda", mesh=mesh,
                                   shardings=prefill.cache_shardings)
                ck.store.close()
                restore_s = time.perf_counter() - t1
                equal = [k for k, v in kept["cache"].items()
                         if _same_bits(cache[k].to_local(), v.to(device))]
                if len(equal) != len(kept["cache"]):
                    raise AssertionError(f"the 4 -> 1 restore: only {equal} "
                                         f"bit-equal")
                plain = {k: v.to_local().clone() for k, v in cache.items()}
                decode, one = (make_decode_step(api, mesh=mesh, rules=rules),
                               make_decode_step(api))
                tok = kept["tokens"][:, -1:].to(device)
                same, toks = 0, []
                for i in range(G2):
                    batch = {"token": tok, "pos": torch.full(
                        (B,), P + G + i, dtype=torch.int32, device=device)}
                    logits, cache = decode(sharded, cache, batch)
                    want, plain = one(params, plain, batch)
                    same += _same_bits(logits.to_local(), want)
                    tok = greedy(want)
                    toks.append(tok)
                if same != G2 or not all(
                        _same_bits(cache[k].to_local(), v)
                        for k, v in plain.items()):
                    raise AssertionError(f"the (1, 1) mesh decode: {same} of "
                                         f"{G2} steps bit-equal to one device")
                prompts = {k: v.to(device) for k, v in kept["prompts"].items()}
                got, _ = prefill(sharded, prompts)
                # the decoded cache back to a store as one rank (ckpt_pack),
                # read back bit for bit
                ck = TensorCheckpoint(DatasetStore(stores[1], "w"))
                ck.save_layout(layout_from_torch(cache))
                save_torch(ck, cache, step)
                back = load_torch(ck, api.abstract_cache(B, cache_len), step,
                                  device="cuda")
                ck.store.close()
                got_launches = read()
                if not all(_same_bits(back[k], v.to_local())
                           for k, v in cache.items()):
                    raise AssertionError("the card's re-save did not read "
                                         "back bit for bit")
                # the one-device prefill it is held to (launches not counted)
                want, _ = make_prefill_step(api, shape, cache_len)(params,
                                                                   prompts)
                if not _same_bits(got.to_local(), want):
                    raise AssertionError("the (1, 1) mesh prefill differs from "
                                         "the one-device prefill")
        finally:
            torch.distributed.destroy_process_group()
        if got_launches["flash_attention"] != SERVE_MESH_LAYERS or \
                not got_launches["ckpt_pack"]:
            raise AssertionError(f"the card leg launched {got_launches}: "
                                 f"expected {SERVE_MESH_LAYERS} flash "
                                 f"launches (its prefill) and ckpt_pack")
        legs.append({"leg": "card", "processes": 1, "device": "cuda",
                     "mesh": list(SERVE_MESH_CARD), "restored_step": step,
                     "restore_seconds": restore_s,
                     "bit_equal_arrays": len(equal),
                     "decode_steps_bit_equal_to_one_device": same,
                     "prefill_bit_equal_to_one_device": True,
                     "tokens": torch.cat(toks, 1).cpu().tolist(),
                     "launches": got_launches,
                     "seconds": time.perf_counter() - t0})

        # ---- the launcher: a world of one as torchrun starts it (its
        # environment, without torchrun's own process), on the card
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "smollm-135m"], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT), WORLD_SIZE="1",
                     RANK="0", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(free_port())),
            capture_output=True, text=True, timeout=SERVE_MESH_TIMEOUT)
        if res.returncode != 0:
            raise AssertionError(f"the serve launcher under torchrun: "
                                 f"{res.stderr[-3000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        if line.get("device") != torch.cuda.get_device_name(0):
            raise AssertionError(f"the launcher's line: {line}")
        legs.append({"leg": "launcher", "command": "WORLD_SIZE=1 RANK=0 "
                     "MASTER_ADDR=localhost python -m "
                     "repro_torch.launch.serve --arch smollm-135m",
                     "line": line,
                     "seconds": time.perf_counter() - t0})
    finally:
        for d in stores:
            shutil.rmtree(d, ignore_errors=True)
        Path(keep).unlink(missing_ok=True)
    emit({"phase": "serve_mesh", "arch": cfg.arch,
          "layers": SERVE_MESH_LAYERS, "batch": B, "prompt": P,
          "decode_steps": [G, G2], "cache_len": cache_len,
          "cache_bytes": sum(v.numel() * v.element_size()
                             for v in kept["cache"].values()),
          "legs": legs, "bit_exact_restore": True,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def tp_train_path(device, scratch: Path) -> dict:
    """The ``tp_train`` phase: TP_MESH's processes share the card
    (``card_tp_train``: run A with each process's launch counts at 0 just
    before it and read just after, its state saved through ckpt_pack, run
    B bit-equal); then this process restores A's state 3 -> 1 on the card,
    every process's shards bit-equal, and runs the one-process steps from
    the same seed, which A's metrics, slots and updates must match within
    CARD_RTOL.  Then the legs of TP_FAMILY on TP_FAMILY_MESH
    (``helpers.torch_tp_family_workers.family_legs``: recurrentgemma-9b,
    whisper-base and xlstm-350m served, trained and restarted with their
    compute split over the model axis), each on a line of its own with the
    same fields.  Returns the launches
    of the TP runs (summed over their processes) and of the restores."""
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import load_torch
    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model
    from repro_torch.train import AdamW, init_train_state

    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from helpers.torch_tp_family_workers import family_legs
    from helpers.torch_tp_workers import (card_config, card_errors,
                                          card_one_process, card_tp_train,
                                          load_kept)

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    store = tempfile.mkdtemp(prefix="tp_store_", dir=scratch)
    kept_dir = tempfile.mkdtemp(prefix="tp_kept_", dir=scratch)
    n = TP_MESH[0] * TP_MESH[1]
    try:
        t0 = time.perf_counter()
        ranks = run_processes(card_tp_train, n, (
            TP_MESH, TP_LAYERS, TP_B, TP_S, TP_STEPS, SEED, store, kept_dir,
            TRAIN_LR), timeout=TP_TIMEOUT, pg_timeout=TP_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        launches = {k: sum(r["launches"][k] for r in ranks)
                    for k in ranks[0]["launches"]}
        for r in ranks:
            if not (r["launches"]["flash_attention"]
                    and r["launches"]["flash_attention_bwd"]
                    and r["launches"]["ckpt_pack"]):
                raise AssertionError(f"rank {r['rank']} of the TP run "
                                     f"launched {r['launches']}")
            if r["model_bytes"]["parameter"] or \
                    not r["model_bytes"]["activation"]:
                raise AssertionError(f"rank {r['rank']} sent "
                                     f"{r['model_bytes']} over the model axis")
            if r["repeat_differs"] or not r["repeat_metrics_equal"]:
                raise AssertionError(f"rank {r['rank']}: the second TP run "
                                     f"differs in {r['repeat_differs']}")
            if r["metrics"] != ranks[0]["metrics"]:
                raise AssertionError("the TP processes' metrics differ")
        kept = load_kept(kept_dir, n)

        # ---- the restore 3 -> 1 on the card, one process
        cfg = card_config(TP_LAYERS)
        api = build_model(cfg)
        zero, read, restore_launches = _counter()
        t0 = time.perf_counter()
        zero()
        ck = TensorCheckpoint(DatasetStore(store, "r"))
        target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in init_train_state(
                      api, AdamW(), torch.Generator().manual_seed(SEED)
                  ).items()}
        restored = load_torch(ck, target, TP_STEPS, device="cuda")
        ck.store.close()
        read()
        restore_s = time.perf_counter() - t0
        differ = sorted({k for r in kept for k, t in r["local"].items()
                         if not _same_bits(
                             restored[k][r["boxes"][k]].cpu(), t)})
        if differ:
            raise AssertionError(f"the 3 -> 1 restore differs in {differ}")

        # ---- the one-process steps on the card, from the same seed
        t0 = time.perf_counter()
        one = card_one_process(TP_LAYERS, TP_B, TP_S, TP_STEPS, SEED,
                               TRAIN_LR)
        one_s = time.perf_counter() - t0
        ratios = card_errors(ranks[0]["metrics"], kept, one)
        worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
        if worst[0][1] > 1.0:
            raise AssertionError(f"TP against the one-process steps, "
                                 f"error / tolerance: {worst}")
    finally:
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(kept_dir, ignore_errors=True)
    launches["ckpt_pack"] += restore_launches["ckpt_pack"]
    launches.setdefault("rglru_scan", 0)
    emit({"phase": "tp_train", "arch": cfg.arch, "layers": TP_LAYERS,
          "batch": TP_B, "seq": TP_S, "mesh": list(TP_MESH),
          "processes": n, "backend": "gloo", "deterministic": True,
          "local_params": ranks[0]["local_params"],
          "local_shapes": ranks[0]["local_shapes"],
          "losses": [m["loss"] for m in ranks[0]["metrics"]],
          "one_process_losses": [h["loss"] for h in one[2]],
          "worst_error_over_tolerance": worst,
          "step_ms": [[t * 1e3 for t in r["step_seconds"]] for r in ranks],
          "one_process_step_ms": one[3],
          # run B: the exchanges timed with the card synchronised around
          # each, and its steps' ms under those synchronisations
          "exchange_ms_per_step": [r["exchange_seconds"] * 1e3 / TP_STEPS
                                   for r in ranks],
          "timed_step_ms": [[t * 1e3 for t in r["timed_step_seconds"]]
                            for r in ranks],
          "model_axis_bytes_per_process": [r["model_bytes"] for r in ranks],
          "launches_per_process": [r["launches"] for r in ranks],
          "repeat_bit_equal": True, "restore_3_to_1_bit_equal": True,
          "save_seconds": max(r["save_seconds"] for r in ranks),
          "restore_seconds": restore_s, "spawn_seconds": spawn_s,
          "one_process_seconds": one_s,
          "phase_seconds": time.perf_counter() - t_phase})
    del kept, one, restored
    torch.cuda.empty_cache()
    # ---- the recurrent hybrid's, the encoder-decoder's and xLSTM's legs,
    # one spawn of TP_FAMILY_MESH's processes for the three
    records, got, failed = family_legs(
        TP_FAMILY_MESH, TP_FAMILY, TP_STEPS, SEED, TRAIN_LR, TP_FAMILY_G,
        str(scratch), {a: LOGITS_RTOL[get_config(a).arch] for a in TP_FAMILY},
        TP_TIMEOUT)
    for k, v in got.items():
        launches[k] += v
    torch.cuda.empty_cache()
    for record in records:
        emit({"phase": "tp_train", **record,
              "phase_seconds": time.perf_counter() - t_phase})
    if failed:
        raise AssertionError(f"tp_train's family legs: {failed}")
    return launches


def adafactor_mesh_path(device, scratch: Path, one) -> dict:
    """The ``adafactor_mesh`` phase.  First the one-process serving from
    the seeded parameters of kimi_train's model (``card_one_process``).
    Then ADA_MESH's processes share the card (``card_adafactor_mesh``):
    each process's launch counts at 0 just before its serving and its
    training and read just after; its decode fed the one-process run's
    tokens, whose greedy choices and logits it must give; its steps held
    to kimi_train's (``one``) within CARD_RTOL; steps 1..ADA_REPEAT again
    bit-equal; the smoke config's sharded Adafactor state saved through
    ckpt_pack.  Then this process restores that state 4 -> 1 on the card,
    every process's shards bit-equal.  ``one``: ``kimi_paths``'s state
    after ADA_STEPS steps, metrics and ms (its initial parameters are drawn
    again here from the seed).  Returns the launches of the processes
    (summed) and of the restore."""
    from repro_torch.core.store import DatasetStore
    from repro_torch.core.tensor_ckpt import TensorCheckpoint
    from repro_torch.core.torch_io import load_torch
    from repro_torch.launch.spawn import run_processes
    from repro_torch.models.api import build_model
    from repro_torch.train import Adafactor, init_train_state

    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from helpers import torch_adafactor_workers as W
    from helpers.torch_tp_workers import card_errors

    t_phase = time.perf_counter()
    cfg = W.card_config(1, KIMI_TRAIN_EXPERTS)
    # ---- the one-process serving the mesh's must give
    t0 = time.perf_counter()
    one_logits, tokens = W.card_one_process(cfg, KIMI_TRAIN_B, ADA_P, ADA_G,
                                            SEED)
    one_serve_s = time.perf_counter() - t0
    store = tempfile.mkdtemp(prefix="ada_store_", dir=scratch)
    kept_dir = tempfile.mkdtemp(prefix="ada_kept_", dir=scratch)
    n = ADA_MESH[0] * ADA_MESH[1]
    try:
        t0 = time.perf_counter()
        ranks = run_processes(W.card_adafactor_mesh, n, (
            ADA_MESH, cfg, KIMI_TRAIN_B, KIMI_TRAIN_S,
            ADA_STEPS, ADA_REPEAT, SEED, KIMI_TRAIN_LR, TRAIN_WARMUP,
            KIMI_TRAIN_STEPS, tokens, ADA_P, store, kept_dir),
            timeout=ADA_TIMEOUT, pg_timeout=ADA_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        layers = cfg.num_layers
        for r in ranks:
            got = r["launches"]
            # a remat span runs its layer again in the backward pass
            if (r["prefill_flash_launches"] != layers
                    or got["flash_attention"] != 2 * layers * ADA_STEPS
                    or got["flash_attention_bwd"] != layers * ADA_STEPS
                    or got["moe_ffn_ep"] != 2 * layers * ADA_STEPS
                    or not got["ckpt_pack"]):
                raise AssertionError(f"rank {r['rank']} of adafactor_mesh "
                                     f"launched {got}, prefill "
                                     f"{r['prefill_flash_launches']}")
            for what in ("model_bytes", "serve_model_bytes"):
                if r[what]["parameter"] or not r[what]["activation"]:
                    raise AssertionError(f"rank {r['rank']} sent "
                                         f"{r[what]} over the model axis")
            if r["repeat_differs"] or not r["repeat_metrics_equal"]:
                raise AssertionError(f"rank {r['rank']}: steps 1-"
                                     f"{ADA_REPEAT} again differ in "
                                     f"{r['repeat_differs']}")
            if r["metrics"] != ranks[0]["metrics"]:
                raise AssertionError("the processes' metrics differ")
        kept = W.load_kept(kept_dir, n)
        init = {f"params/{k}": t for k, t in build_model(cfg).init(
            torch.Generator(device="cuda").manual_seed(SEED)).items()}
        ratios = card_errors(ranks[0]["metrics"], kept, (init, *one),
                             device="cuda",
                             min_change_ulps=ADA_MIN_CHANGE_ULPS)
        worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
        del kept, init
        torch.cuda.empty_cache()
        if worst[0][1] > 1.0:
            raise AssertionError(f"the sharded Adafactor steps against "
                                 f"kimi_train's, error / tolerance: {worst}")
        agree = W.logit_agreement(ranks[0]["logits"], one_logits, tokens)
        limit = LOGITS_RTOL["kimi-k2-1t-a32b"]
        if agree["logits_err_over_scale"] > limit or agree["argmax_flips"]:
            raise AssertionError(f"the local-head decode against the "
                                 f"one-process decode: {agree}, limit "
                                 f"{limit}")

        # ---- the smoke config's sharded Adafactor state 4 -> 1 on the card
        zero, read, restore_launches = _counter()
        small = build_model(W.config(*W.SAVED))
        t0 = time.perf_counter()
        zero()
        ck = TensorCheckpoint(DatasetStore(store, "r"))
        target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in init_train_state(
                      small, Adafactor(), torch.Generator().manual_seed(SEED)
                  ).items()}
        restored = load_torch(ck, target, 2, device="cuda")
        ck.store.close()
        read()
        restore_s = time.perf_counter() - t0
        smoke = W.load_kept(kept_dir, n, "smoke")
        differ = sorted({k for r in smoke for k, t in r["local"].items()
                         if not _same_bits(
                             restored[k][r["boxes"][k]].cpu(), t)})
        if differ:
            raise AssertionError(f"the 4 -> 1 restore differs in {differ}")
    finally:
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(kept_dir, ignore_errors=True)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("flash_attention", "flash_attention_bwd",
                          "ckpt_pack")}
    launches["flash_attention"] += sum(r["prefill_flash_launches"]
                                       for r in ranks)
    launches["ckpt_pack"] += restore_launches["ckpt_pack"]
    emit({"phase": "adafactor_mesh", "arch": "kimi-k2-1t-a32b",
          "layers": 1, "experts": KIMI_TRAIN_EXPERTS, "batch": KIMI_TRAIN_B,
          "seq": KIMI_TRAIN_S, "mesh": list(ADA_MESH), "processes": n,
          "backend": "gloo", "optimizer": "adafactor", "deterministic": True,
          "local_params": ranks[0]["local_params"],
          "local_shapes": ranks[0]["local_shapes"],
          "losses": [m["loss"] for m in ranks[0]["metrics"]],
          "one_process_losses": [h["loss"] for h in one[1]],
          "worst_error_over_tolerance": worst,
          "min_change_ulps": ADA_MIN_CHANGE_ULPS,
          "step_ms": [[t * 1e3 for t in r["step_seconds"]] for r in ranks],
          "one_process_step_ms": one[2],
          "exchange_ms_per_step": [r["exchange_seconds"] * 1e3 / ADA_REPEAT
                                   for r in ranks],
          "timed_step_ms": [[t * 1e3 for t in r["timed_step_seconds"]]
                            for r in ranks],
          "model_axis_bytes_per_process": [r["model_bytes"] for r in ranks],
          "serve_model_axis_bytes_per_process": [r["serve_model_bytes"]
                                                 for r in ranks],
          "peak_memory_allocated_per_process": [r["peak_memory_allocated"]
                                                for r in ranks],
          "decode": {"prompt": ADA_P, "steps": ADA_G,
                     "decode_ms": ranks[0]["decode_ms"], **agree,
                     "limit": LOGITS_RTOL["kimi-k2-1t-a32b"]},
          "launches_per_process": [r["launches"] for r in ranks],
          "repeat_bit_equal": True, "restore_4_to_1_bit_equal": True,
          "init_seconds": max(r["init_seconds"] for r in ranks),
          "smoke_save_seconds": max(r["smoke_save_seconds"] for r in ranks),
          "restore_seconds": restore_s, "spawn_seconds": spawn_s,
          "one_process_serve_seconds": one_serve_s,
          "phase_seconds": time.perf_counter() - t_phase})
    return launches


def main(argv=None) -> int:
    t_start = time.perf_counter()
    argv = sys.argv[1:] if argv is None else argv
    if not (ROOT / "repro_torch" / "__init__.py").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    # before the first cuBLAS call: the train phase runs in deterministic
    # mode, which needs cuBLAS's fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import get_config
    from repro_torch.core.tensor_ckpt import balanced_chunk_partition
    from repro_torch.core.torch_io import layout_from_torch
    from repro_torch.models.api import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    cfg = dataclasses.replace(get_config("smollm_135m"),
                              attention_impl="pallas")
    api = build_model(cfg)
    # as the launcher does; the RG-LRU family ignores attention_impl
    hcfg = dataclasses.replace(get_config("recurrentgemma_9b"),
                               attention_impl="pallas")
    hapi = build_model(hcfg)
    device = torch.device("cuda")
    scratch = ROOT / "build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="store_", dir=scratch)
    hybrid_store = tempfile.mkdtemp(prefix="store_", dir=scratch)
    train_stores = [tempfile.mkdtemp(prefix="train_", dir=scratch)
                    for _ in range(2)]
    fem_store = tempfile.mkdtemp(prefix="fem_", dir=scratch)
    moe_store = tempfile.mkdtemp(prefix="moe_", dir=scratch)
    vlm_store = tempfile.mkdtemp(prefix="vlm_", dir=scratch)
    recurrent_stores = [tempfile.mkdtemp(prefix="xlstm_", dir=scratch)
                        for _ in range(3)]
    whisper_stores = [tempfile.mkdtemp(prefix="whisper_", dir=scratch)
                      for _ in range(3)]
    kimi_stores = [tempfile.mkdtemp(prefix="kimi_", dir=scratch)
                   for _ in range(3)]
    try:
        with torch.inference_mode():
            params = api.init(torch.Generator(device=device).manual_seed(SEED))
            layout = layout_from_torch(params)
            ownership = balanced_chunk_partition(layout, NRANKS)
            # ---- each kernel against its plain version, with its times
            kernels = [check_ckpt_pack(params, layout, ownership),
                       check_flash_attention(cfg),
                       check_rglru_scan(hcfg.lru_width)]
        # autograd through the scan (outside inference mode)
        kernels[2]["backward"] = check_rglru_scan_vjp(hcfg.lru_width)
        kernels.append(check_flash_attention_bwd(cfg))
        for entry in kernels:
            emit({"phase": "kernels", **entry})
        if "--kernels-only" in argv:
            return 0
        dense, hybrid, train = earlier_paths(
            api, cfg, hapi, hcfg, params, layout, ownership, device,
            store_dir, hybrid_store, train_stores, fem_store)
        del params, layout, ownership
        torch.cuda.empty_cache()
        # ---- the elastic path: its card leg with the counts at 0 just
        # before it and read just after
        t0 = time.perf_counter()
        elastic, elastic_launches = phase_elastic(cfg, scratch)
        elastic["phase_seconds"] = time.perf_counter() - t0
        emit(elastic)
        torch.cuda.empty_cache()
        # ---- the MoE paths: granite-moe-3b-a800m served, its cache
        # restarted 4 -> 1, and trained at 2 layers
        moe_launches = moe_paths(device, moe_store)
        # ---- the rest of the dense family: qwen3-4b and qwen2-vl-7b
        # served (qwen2-vl's cache restarted 4 -> 1), gemma2-2b past its
        # window
        family_launches = dense_paths(device, vlm_store)
        # ---- the recurrent families train: recurrentgemma-9b at 3 layers;
        # xlstm-350m served, its state restarted 4 -> 1, and trained
        recurrent_launches = recurrent_paths(device, recurrent_stores)
        # ---- the last two families and the quickstart: whisper-base
        # served, its cache restarted 4 -> 1, trained; kimi-k2 served at
        # one full-width layer and trained under Adafactor
        whisper_launches = whisper_paths(device, whisper_stores)
        kimi_launches, kimi_one = kimi_paths(device, kimi_stores)
        last_launches = [whisper_launches, kimi_launches,
                         quickstart_path(device),
                         # ---- serving on a mesh: smollm's sharded cache
                         # 4 CPU processes -> the card, and the launcher
                         serve_mesh_path(device, scratch),
                         # ---- tensor-parallel training: 3 processes
                         # share the card
                         tp_train_path(device, scratch),
                         # ---- Adafactor on a sharded mesh and the decode
                         # on local heads: 4 processes share the card
                         adafactor_mesh_path(device, scratch, kimi_one)]
        del kimi_one
    finally:
        for d in ([store_dir, hybrid_store, fem_store, moe_store, vlm_store]
                  + train_stores + recurrent_stores + whisper_stores
                  + kimi_stores):
            shutil.rmtree(d, ignore_errors=True)
    launches = {"ckpt_pack": dense["ckpt_pack"] + hybrid["ckpt_pack"]
                + train["total_launches"]["ckpt_pack"]
                + elastic_launches["ckpt_pack"] + moe_launches["ckpt_pack"]
                + family_launches["ckpt_pack"]
                + recurrent_launches["ckpt_pack"],
                "flash_attention": dense["flash_attention"]
                + train["total_launches"]["flash_attention"]
                + elastic_launches["flash_attention"]
                + moe_launches["flash_attention"]
                + family_launches["flash_attention"]
                + recurrent_launches["flash_attention"],
                "rglru_scan": hybrid["rglru_scan"]
                + train["total_launches"]["rglru_scan"]
                + family_launches["rglru_scan"]
                + recurrent_launches["rglru_scan"],
                # the train paths: smollm's, the elastic card leg, granite's
                "flash_attention_bwd":
                train["total_launches"]["flash_attention_bwd"]
                + elastic_launches["flash_attention_bwd"]
                + moe_launches["flash_attention_bwd"]}
    for paths in last_launches:
        for k, n in paths.items():
            launches[k] += n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: e[k] for k in keys}
                      for e in ({**e, "launches": launches[e["name"]]}
                                for e in kernels)]})
    print(smi, flush=True)
    emit({"total_seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def earlier_paths(api, cfg, hapi, hcfg, params, layout, ownership, device,
                  store_dir, hybrid_store, train_stores, fem_store):
    """The smollm serving path, the hybrid path, training, the FE path and
    the post-processing sweep, each with the launch counts at 0 just before
    it and read just after.  Returns the serving, hybrid and train
    launches."""
    from repro_torch.kernels.ckpt_pack import ops as pack_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.launch.serve import prompt_batch

    with torch.inference_mode():
        # ---- the smollm path: counts at 0 just before, read just after
        pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
        attn_ops.bwd_launches = 0
        ckpt, restored = phase_ckpt(api, params, store_dir, NRANKS, device)
        requests = make_requests(cfg.vocab)
        serve, results = phase_serve(api, restored, requests, SLOTS, device)
        dense = {"ckpt_pack": pack_ops.launches,
                 "flash_attention": attn_ops.launches}
        ckpt["ckpt_pack_launches"] = dense["ckpt_pack"]
        emit(ckpt)
        serve["flash_attention_launches"] = dense["flash_attention"]
        serve.update(check_served(api, restored, requests, results, SLOTS))
        serve.update(check_model_logits(api, restored))
        emit(serve)
        if not all(dense.values()):
            raise AssertionError(f"a kernel of the smollm path never "
                                 f"launched: {dense}")
        del params, restored, layout, ownership
        torch.cuda.empty_cache()

        # ---- the hybrid path: counts at 0 just before, read just after
        hparams = hapi.init(
            torch.Generator(device=device).manual_seed(SEED))
        tokens = prompt_batch(hcfg, HYBRID_B, HYBRID_P, device)["tokens"]
        pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
        attn_ops.bwd_launches = 0
        hserve, kept = phase_hybrid_serve(hapi, hparams, tokens, device)
        # one launch per RG-LRU layer of the one prefill
        n_lru = sum(k == "lru" for k in hcfg.layer_kinds())
        hserve["rglru_scan_launches"] = scan_ops.launches
        emit(hserve)
        if scan_ops.launches != n_lru:
            raise AssertionError(f"rglru_scan launched {scan_ops.launches}"
                                 f" times in one prefill, not {n_lru}")
        hstate = phase_hybrid_state(hapi, hparams, kept, hybrid_store,
                                    NRANKS, device)
        hybrid = {"rglru_scan": scan_ops.launches,
                  "ckpt_pack": pack_ops.launches}
        hstate["ckpt_pack_launches"] = hybrid["ckpt_pack"]
        emit(hstate)
        if not all(hybrid.values()):
            raise AssertionError(f"a kernel of the hybrid path never "
                                 f"launched: {hybrid}")
        line = decode_vs_prefill(hapi, hparams, tokens, kept,
                                 CONSISTENCY_RTOL)
        emit({"phase": "hybrid_consistency", **line})
        if line["failed"]:
            raise AssertionError(f"decode disagrees with prefill: "
                                 f"{line['failed']}")
        del hparams, kept, tokens
        torch.cuda.empty_cache()

    # ---- the train path, outside inference mode (autograd needs it)
    train, kept = phase_train(dataclasses.replace(
        cfg, remat=True, num_layers=TRAIN_LAYERS),
                              device, train_stores)
    emit(train)

    # ---- the FE path and the post-processing sweep: no kernel of the
    # port runs on them (the engine's gathers are host code); the counts
    # are set to 0 just before each and read just after all the same
    for run in (lambda: phase_fem(device, fem_store),
                lambda: phase_postprocess(train_stores[1], kept,
                                          device)):
        pack_ops.launches = attn_ops.launches = scan_ops.launches = 0
        attn_ops.bwd_launches = 0
        t0 = time.perf_counter()
        line = run()
        line["phase_seconds"] = time.perf_counter() - t0
        line["kernel_launches"] = {"ckpt_pack": pack_ops.launches,
                                   "flash_attention": attn_ops.launches,
                                   "rglru_scan": scan_ops.launches}
        emit(line)
    return dense, hybrid, train


if __name__ == "__main__":
    sys.exit(main())

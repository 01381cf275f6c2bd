#!/usr/bin/env python3
"""Drive the PyTorch port's batch-embedding (also W8A8, --quant8, and a
VideoMAE at ViT-H widths, heads of 80), serving, MIM-pretraining,
V-JEPA2-pretraining (both presets: the TPU-native heads and the
reference heads, whose predictor has heads of 32; both pretrainings also
with the encoder at ViT-H widths) and fine-tuning paths,
the training data path (the native CT loader, the device cache, uint8
shipping) with the HF checkpoint round trip, the opt-in int8 p v
attention and attention-glue paths, LoRA fine-tuning, the 8-bit AdamW and
the encoder zoo (SigLIP-base and so400m, whose heads are 72 wide,
Merlin's I3D ResNet-152), once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against OTHER   # OTHER: e.g. the parent commit
                                            # unpacked by `git archive`

With --against, phases 1 and 2 run, then `phase_against`: the other
checkout's kernel library is built too and bound by its own `_build`, the
kernels this tree did not change (K1, K3, K4, K7 and K8 at head widths
32, 64 and 128 and their NARROW instantiations, which store a narrower
head, the MLP forward and backward kernels K2,
K6, K5a, K9 and K5b and the glue K10a and K10b) are compared with it by
SASS and, through their wrappers (K3, K7 and K8 with each side's
quantisation kernel), bit for bit; the quantisation, flash, MLP, SwiGLU
and glue kernels (K1, K4, K3 and K7 at heads of 80 and 72 too: this
tree's d-80 tiles against the other's d-128 ones, K3 and K7 on the codes
each side's tiles read), legs A's, B's and G's models and
the MIM step (as
shipped and with the glue) and both V-JEPA steps (the _tpu preset, and the
reference heads under their recommended impls) are timed with either
library in turns, in one process, then the int8 ViT-H encode (leg T's
model, 32 layers) and the ViT-H V-JEPA step (32 layers), and the
DINOv2-giant step parity runs with either library at three seeds; the
last line is the JSON of the mean times and the parity readings.

Phases of the run without arguments, each of which fails the run
(non-zero exit, no result line) on any error:
  1. device: a CUDA device is present; print its name and power limit;
  2. build: compile the hand-written kernels from `smb_vision_tpu_torch/csrc`,
     print the ptxas report, and count the bf16 and int8 wgmma (HGMMA,
     IGMMA) and TMA (UTMALDG) instructions of K1, K3, K4, K7, K8 (each at
     head width 32, 64 and 128, K1, K4, K3 and K7 also on their tiles of
     80 columns, and in their instantiations that store a narrower head),
     the nine GEMM instantiations of K2, K6,
     K5a, K9, K5b, K10a and K10b and the W8A8 product (bf16 and f32 out) in
     the SASS (cuobjdump, where the toolkit has it):
     none of one that a kernel should have fails the run (K3 and K7 need
     all three, K8 IGMMA and UTMALDG), and so does any mma.sync
     instruction (IMMA, HMMA) anywhere in the library;
  3. kernels: every kernel of the embedding path against its plain PyTorch
     version at the main-path and a ragged shape, with its time beside the
     plain one (K1 and K4 also with their achieved TFLOP/s, share of bound
     and factor against SDPA, and K1 with its exp2 floor, which at head
     width 64 is as long as its tensor floor; K3 beside K1 on the same
     inputs, with that floor, through its wrapper and alone, and its
     quantisation's time); then the int8 quantisation kernel (R6) against
     `quantize_per_head` bit for bit, in both layouts, at leg B's q (batch
     4), the V-JEPA encoder's and predictor's shapes, a ragged N, an
     all-zero head and the strided views of a fused projection, timed at
     the embed shape beside the plain pass; then W8A8's two kernels bit
     for bit against their plain versions: the row quantisation of x (K
     768), h (K 3,072), an f32 weight and ragged rows, the product at
     ViT-Base's fc1, fc2, q/k/v stacked and o on the embed rows and two
     ragged shapes (bf16 and f32 out), timed at x and fc1 beside their
     plain versions, `torch._int_mm` with the dequantisation (library_ms)
     and the bf16 `F.linear`; then the
     training kernels (K4, K5a, K5b) at the MIM encoder's and decoder's
     shapes and a ragged one; then the V-JEPA shapes: the int8-score
     backward K7 at the encoder's, the predictor's, the reference-head
     encoder's and two ragged shapes (timed beside its plain version and
     K4), K1 and K3 at head width 128 (K3 beside K1), and K5a, K5b, K6
     and K2 at the ViT-L MLP (K 1,024); then K1, K4 and K7 at head width
     32: the reference-head predictor's shape (9,216 tokens, 12 heads),
     ragged N 1,961 and 193, and Nq != Nk both ways for K4 and K7 with and
     without an lse2 cotangent, timed at the predictor's shape beside
     their plain versions, SDPA (K1, K4), the d-64 kernel on zero-padded
     inputs, the exp2 floor and the tensor floor, and K3 and K8 at d 32
     at the same three N, timed beside K1 d32; K2, K6 and K5a each also
     beside
     its cuBLAS chain (`mlp_chain`, their library_ms), K5b beside its own
     (`mlp_bwd_chain`), with its two products' times apart (profiler);
     then the SwiGLU half-block K9 at DINOv2-giant batch 2 and ragged
     batch 1 and at the DINOv2-base shape (timed beside its plain version
     and the bf16 chain `_swiglu_block_xla`, its library_ms, with its
     three passes' times apart; gradients through the recompute), and
     K1/K4 at DINOv2-giant's N 1,961 with 24 heads of 64; then the int8 p v
     attention K8 at N 20,480 and ragged N 1,961 (timed beside K3 on the
     same inputs, each through its wrapper and alone), and the attention
     glue K10a/K10b at the embed shape,
     the MIM encoder's and decoder's and a ragged one (timed beside their
     library chains, with K10a's LayerNorm pass and GEMM timed apart, and
     the glue's forward and backward in one block of the MIM step beside
     the plain path's); then the forward family past the instantiations'
     widths: K1 and K3 (on their tiles of 80 columns, K3 on codes of 96
     bytes) and K8 (on the d-128 ones) at head width 72 (SigLIP so400m:
     batch 32, 729
     tokens, 16 heads) and 80 (ViT-H: 20,480 tokens, 16 heads) against
     their plain versions and timed beside them (K1 beside SDPA and the
     exp2 floor), R6 writing the codes of heads of 80 at width 96 (K3's)
     and 128 (K8's) bit for bit, K2 and K6 at K 1,280 (F 5,120) beside
     their cuBLAS chain, and K9
     at K 2,048 beside its chain (a row that no path launches); then the
     training family past those widths: K4 and K7 (on their tiles of 80
     columns, K7 on codes of 96 bytes) at head width 72
     (batch 32, 729 tokens, 16 heads), 80 (K4 at the ViT-H MIM encoder's
     7,168 tokens, K7 at the V-JEPA2 ViT-H encoder's 9,216, 16 heads) and
     100 (padded to 104; a ragged shape with an lse2 cotangent) against
     their plain versions, K4 beside SDPA's backward, K7 beside K4 and its
     quantisation, and K5a and K5b at K 1,280 (M 7,168, F 5,120) and 1,408
     (M 9,216, F 6,144; ViT-g's widths, rows that no path launches)
     beside their plain versions and cuBLAS chains; each kept time with
     its bound and, where one exists, the library call's;
  3a. card tests: `CARD_TESTS` (tests/test_torch_d80.py: K1, K4, K3 and
     K7 on the d-80 tiles against their plain versions at the tiles'
     edges, the
     instantiation each width launches, the launches by width) under
     pytest in a process of its own;
  4. leg A: `run_inference` on 4 synthetic 512x512x320 CT volumes, bf16,
     attention and MLP impls at "auto" (kernels K1 and K2);
  5. leg B: the same with --attn_impl pallas_int8 and a config that pins
     mlp_impl "pallas_bwd" (kernels K3 and K6, and the quantisation of q
     and k before every K3);
  5a. leg G: the same with --attn_impl pallas_int8pv and a config with
     glue_impl "pallas" (K10a, K8, K10b, then K2 in every block: 24
     launches each; the quantisation 72, q, k and v), its embeddings'
     distance from leg A's beside leg B's;
  5q. leg Q: `run_inference --quant8` with leg A's config (W8A8: the row
     quantisation 144 launches, the product 96, K1 24; no fused MLP
     kernel), within 5e-2 of max of leg A's embeddings;
  5n. legs N, T and U: `run_inference` on the 4 volumes with a VideoMAE
     at ViT-H widths (hidden 1,280, 16 heads of 80, MLP 5,120; 8 of its
     32 layers, VIT_H_LEG_LAYERS) under "auto" (K1 at d 80, K2 at K
     1,280), --attn_impl
     pallas_int8 with mlp_impl pallas_bwd (K3 at d 80 on R6's codes of
     width 96, K6) and --attn_impl pallas_int8pv (K8, K2): each kernel
     once a layer and batch, the plain attention never; then the model's
     parity at 12 of its 32 layers in the three configurations, against
     the same model on their plain versions and against float32 (section
     2's forward rule), and its volumes/s at all 32 layers, batch 2;
  5x. legs X and Y: `run_mim` with a copy of configs/mim_base_512.json
     and `run_vjepa` with a copy of configs/vjepa_large_384_tpu.json
     (accumulation cut to 1), each with the encoder at ViT-H widths
     (1,280, 16 heads of 80, MLP 5,120) cut to VIT_H_LEG_LAYERS of 32
     layers, 2 steps on the volumes: K1 and K4 (X) or K7 and the
     teacher's K3 (Y) at d 80 and K5a and K5b at K 1,280 on every encoder
     layer, each kernel's launches as `expected_launches` gives them a
     step, the plain attention never;
  5b. leg S, the serving slice: `cli/serve.make_server` in the process
     with leg A's config and weights (seed 0), batch 2, a volume cache:
     /healthz (the card, grid [20, 32, 32], hidden 768); the 4 volumes as
     one JSON request, mean-pooled, within 1e-5 of leg A's token means
     (K1 and K2 12 launches a dispatched batch); ct_0's raw NIfTI bytes;
     the same request again from the cache; 6 concurrent mixed requests
     against the serial answers, each volume counted once; a second
     server with --input_dtype uint8 within 3e-2 of the float route; each
     answer's time split into preprocess, copy, encode and response;
  5c. leg W: `run_inference --sliding_window` on two 512x512x448 volumes
     (two 512^2 x 320 windows each, at depth 0 and 128; K1 and K2 24
     launches), each window within 1e-5 of one forward of its crop of
     `preprocess_volume_full`; then `run_inference --input_dtype uint8
     --cache_data_dir --cache_dtype uint8` on the 4 volumes within 3e-2 of
     leg A, and again with --resume false from the cache alone;
  5d. the native CT loader (the C++ library built at first use from
     csrc/ctloader.cpp; host code, on this machine's CPU): the 4 volumes
     at 1 and 8 threads, timed beside the python backend (resample on the
     card), within 1e-4 of it;
  6. whole model: kernels against the plain path on one volume, and leg
     G's model and the quant8 models (with K1, with K3) against the same
     impl names on their plain versions and against float32; then the
     reference-head V-JEPA2 model's forward (no masks) under pallas_int8
     and pallas_int8pv: K3 and K8 at d 32 in the predictor, 12 launches
     each, against their plain versions;
  7. throughput: encoder volumes/s at batch 4 for legs A, Q (quant8 with
     K1), B, quant8 with K3, and G, with the W8A8 kernels' share;
  8. training parity: one MIM step of the configs/mim_base_512.json model
     at full width on one volume, kernels against the plain path in bf16
     and a float32 plain run; then the same with glue_impl "pallas"
     against the same impl names on their plain versions (K10a and K10b
     32 launches each: 16 blocks, forward and remat recompute);
  9. leg C: `run_mim` with a copy of configs/mim_base_512.json (the
     encoder cut to LEG_C_LAYERS) on the 4
     volumes, 4 steps with checkpoints, then a resume to 6 (kernels K1, K4,
     K5a and K5b in training, K6 in eval); leg H: the same with
     --config_overrides glue_impl=pallas (and K10a, K10b);
  9a. leg J, the training data path: `run_mim` with the same preset on
     all 4 volumes, 8 steps (two epochs) with --input_dtype uint8
     --device_cache --cache_data_dir (uint8) --export_hf --profile_steps
     6-7, asking for the native backend ("auto" takes the python one on
     the card): the native backend, no host load in epoch 1 and 4 volumes of
     uint8 codes on the card, every batch decoded there to bfloat16 in the
     step, K1, K4, K5a and K5b, the trace and the HF export; then
     `run_inference` (K1 and K6) from model.safetensors and from
     hf_model.safetensors, the embeddings equal bit for bit;
 10. leg D: `run_vjepa` with a copy of configs/vjepa_large_384_tpu.json
     (gradient accumulation cut from 64 to 2, the encoder from 24 layers
     to LEG_V_LAYERS, as in legs K and I) on the 4 volumes at 384^2 x
     256, 2 steps with checkpoints and eval, then a resume to 4 (K1, K7,
     K5a and K5b in the student, K3 and K6 in the EMA teacher), with
     --export_hf; leg K: `run_vjepa` with leg D's config continued from
     leg D's hf_model.safetensors, --input_dtype uint8 --device_cache, 2
     steps: every student tensor loaded, the EMA teacher equal to the
     student at the start, K7, K3 and the quantisation kernel; leg I: the
     same with a copy of configs/vjepa_large_384.json (the reference heads;
     micro-batch cut from 16 to 1, accumulation from 4 to 2) under
     attn_impl pallas_i8bwd and teacher_attn_impl pallas_int8: K1 and K7 at
     head width 32 in every predictor layer, the plain attention never;
 10a. leg E: `run_classification` on the VideoMAE route (ViT-Base at
     224^2 x 160, mlp_impl pallas_bwd), a survival task with one tabular
     column and the two-tier learning rates: 4 steps, checkpoints, eval
     with the C-index, then a resume to 6;
 10b. leg F, the fine-tuning main path: the same on the DINOv2 route with
     DINOv2-giant at full width (depth cut to 8 layers), a classification
     task with accuracy and ROC-AUC (K1, K4, K9);
 11. training throughput: MIM steps/s, MFU and peak memory at batch 1 and 2,
     as shipped and with glue_impl "pallas";
 12. V-JEPA parity: one full-width step of the preset at batch 1 through
     the kernels, through their plain versions under the same impl names,
     and in float32; loss, gradient error and the EMA teacher's change;
 13. V-JEPA throughput: step ms, MFU and peak memory at batch 1 and 2;
 13c. training at ViT-H widths: one MIM step of the preset with the
     encoder at ViT-H widths and one V-JEPA2 step of the _tpu preset with
     facebook/vjepa2-vith-fpc64-256's encoder, each at 12 of 32 layers,
     through the kernels (K1 and K4 or K7 at d 80, K5a and K5b at K
     1,280, V-JEPA's teacher on K3 at d 80) against their plain versions
     and float32 (section 2's training rule), launches as the config
     gives them; then the steps at all 32 layers (MIM batch 1 and 2,
     V-JEPA batch 1): ms, MFU, peak memory, one profiled step each;
 13a. the same two phases for configs/vjepa_large_384.json: the parity
     step under pallas_i8bwd + pallas_int8 (K1 and K7 at d 32 in the
     predictor); steps (the encoder's depth cut from 24 to 4 layers,
     REF_LAYERS) under "auto" (K1 + K4 at d 32 and 64) and under
     those impls at the largest batch up to the preset's 16 that fits,
     then "auto" at batch 4 beside the parent's routing (the predictor's
     attention on the plain path);
 14. DINOv2 parity: one full-width DINOv2-giant fine-tune step at batch 2
     through the kernels, their plain versions and float32, at seeds 0, 1
     and 2; K9 launches 40 times a forward; at each seed the gradient rule
     holds, and over the seeds the mean loss gap to the plain versions is
     within 1e-2 and the kernels' mean loss distance from float32 within
     1.25 times theirs;
 15. fine-tune throughput: DINOv2-giant step ms, MFU, peak memory at
     batch 2 and 4, K9's share of a profiled step;
 10c. leg L: `run_classification --lora_enable --lora_rank 8 --optim
     adamw8bit` on leg E's config and spec, 4 steps, checkpoints, eval,
     resume to 6 (K1, K4, K5a, K5b in training, K6 in eval), beside a
     straight 6-step run: the three files, the frozen base unchanged, the
     resumed checkpoint equal to the straight one byte for byte (int8
     codes and scales), `run_inference` from model_merged.safetensors;
 10d. leg O: `run_vjepa` with configs/vjepa_large_384_tpu.json plus the
     two keys its _comment names ("optim": "adamw8bit",
     "grad_accum_dtype": "bfloat16"), accumulation cut to 2 and the
     encoder to 6 of 24 layers (LEG_O_LAYERS): a 4-step run stopped by a
     SIGTERM after step 2, resumed to 4, beside a straight 4-step run (the
     V-JEPA kernels; finite losses; the checkpoints equal byte for byte);
 10e. leg Z, the encoder zoo: `run_encoders --encoder siglip` on a seeded
     SigLIP-base-patch16-384 over 64 seeded PNGs at batch 32 (K1 and K2
     12 launches a batch; within 3e-2 of the plain path), images/s at
     batch 32; `run_encoders --encoder merlin` with a seeded I3D
     ResNet-152 on the 4 volumes (the "merlin" pipeline, 224^2 x 160,
     batch 2), uint8 pixels within 3e-2 of float, volumes/s at batch 2
     and peak memory; `serve --encoder merlin`, a 2-volume request within
     1e-5 of run_encoders' token means; leg M, `run_encoders --encoder
     siglip` on a seeded SigLIP so400m-patch14-384 over the same PNGs at
     batch 32: K1 at d 72 27 launches a batch, the MLP (F 4,304) and the
     MAP head plain, within 3e-2 of the plain path; the same tower under
     pallas_int8 and pallas_int8pv (K3, K8 at d 72, 27 launches each);
     images/s at batch 32;
 13b. the V-JEPA step at batch 2 also under the 8-bit AdamW; at batch 2
     the moments' bytes and the optimizer update's time and share of the
     step under either;
 16. LoRA parity: the first DINOv2-giant step of a LoRA run (rank 8,
     B = 0) at seeds 0, 1 and 2, and a step with B drawn at seeds 0 to 8,
     through the kernels, their plain versions and float32 (C1's rule:
     the mean loss gap within 1e-2; the adapters' gradient error within
     1.25 times the plain path's at each seed at B = 0, on the mean of the
     ratios with B drawn);
 17. LoRA throughput: DINOv2-giant, rank 8, 8-bit AdamW, batch 2 and 4
     (and AdamW at batch 2): step ms, peak memory and the adapter count
     beside the full fine-tune's.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRIPT_START = time.time()

# parity bounds: max|kernel - plain| / max|plain|, from the JAX package's own
# kernel tests (tests/test_attention.py, tests/test_mlp.py)
TOL_FLASH = 1e-2
TOL_INT8 = 1e-2
TOL_INT8_F32 = 2e-2
TOL_MLP = 8e-3
# whole-model bounds, one volume through 12 bf16 layers. Measured on the
# H100: the plain bf16 path and the kernel path each land 1.7-1.8e-2 (of
# max) from a float32 run of the same model, at different elements, so
# the two bf16 paths differ by up to about twice that; 2e-2 between them
# was exceeded by bf16 rounding alone. Hence 3e-2 between the two bf16
# paths, and the kernel path held against float32 directly: no more than
# 1.25x the plain bf16 path's own distance from it.
TOL_MODEL = 3e-2
TOL_MODEL_VS_F32 = 1.25

# training kernels: K4 is held to 2e-2 of max (as K1), K5a/K5b to 3e-2 of
# max, the JAX package's bound for its own pair (tests/test_mlp_bwd.py)
TOL_FLASH_BWD = 2e-2
TOL_MLP_TRAIN = 3e-2
# one MIM step at full width: the kernel path's loss within 1e-2 relative
# of the plain bf16 path's, and its global gradient error against a
# float32 run, ||g - g32|| / ||g32|| over all parameters, at most 1.25x the
# plain bf16 path's (the rule of the whole-model forward above)
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD_VS_F32 = 1.25
# K8 against float32 attention: the JAX package's own bound for the int8
# p v forward (tests/test_attention.py); K10a/K10b against their plain
# versions, which share their numerics (f32 accumulation, one rounding)
TOL_INT8PV_F32 = 3e-2
TOL_GLUE = 1e-2

MAIN_N = 20480          # 512/16 * 512/16 * 320/16 tokens
RAGGED_N = 1960         # 224/16 * 224/16 * 160/16 tokens
HEADS, HEAD_DIM, HIDDEN, FFN = 12, 64, 768, 3072
# MIM at mask 0.65 (configs/mim_base_512.json): the encoder sees 7,168 of
# the 20,480 tokens; the decoder is 384 wide with 6 heads of 64
ENC_N = 7168
DEC_HIDDEN, DEC_HEADS, DEC_FFN = 384, 6, 1536
MIM_PRESET = ROOT / "configs" / "mim_base_512.json"
# V-JEPA2 (configs/vjepa_large_384_tpu.json): 384^2 x 256 at patch and
# tubelet 16 is a (16, 24, 24) grid of 9,216 tokens; the ViT-L encoder has
# 8 heads of 128 and an MLP of 4,096, the predictor 3 heads of 128
VJEPA_PRESET = ROOT / "configs" / "vjepa_large_384_tpu.json"
VJ_N = 9216
VJ_HIDDEN, VJ_FFN = 1024, 4096
# configs/vjepa_large_384.json, the reference-head (checkpoint-compatible)
# preset: the same ViT-L at 16 heads of 64, the predictor 384 wide at 12
# heads of 32, micro-batch 16 x accumulation 4
VJEPA_REF_PRESET = ROOT / "configs" / "vjepa_large_384.json"
PRED_HEADS, PRED_LAYERS = 12, 12
# leg I: the preset's micro-batch 16 and accumulation 4 cut for a smoke run
# on 3 training volumes, as leg D's accumulation; the impls its _comment
# recommends
# legs D, K and I: the encoder's depth cut from the presets' 24 layers (the
# predictors keep theirs), to keep the script inside its time limit once
# the ViT-H and SigLIP so400m paths came (24 until then)
LEG_V_LAYERS = 6
LEG_I_CUTS = {"num_hidden_layers": LEG_V_LAYERS,
              "per_device_train_batch_size": 1,
              "gradient_accumulation_steps": 2}
LEG_I_IMPLS = {"attn_impl": "pallas_i8bwd",
               "teacher_attn_impl": "pallas_int8"}
LEG_D_ACCUM = 2         # the preset's 64 micro-batches, cut for a smoke run
LEG_O_LAYERS = 6        # leg O's encoder depth cut (24 in the preset; the
#                         predictor keeps its 12), to keep the script
#                         inside its time limit (12 until the W8A8 phases
#                         came)
# the depth cuts that keep the script inside its time limit once the ViT-H
# and SigLIP so400m paths came (full depth until then): the 2-rank phase's
# encoders (MIM 12 -> 4, the decoder keeps its 4; V-JEPA 24 -> 6, the
# predictor keeps its 12); the V-JEPA step parity's encoder (24 -> 12, the
# depth PERF.md section 2's rule is set at); the LoRA parity's DINOv2-giant
# (40 -> 8, leg F's cut), which the 2-rank phase's LoRA modes share. The
# throughput phases keep full depth.
LORA_PARITY_LAYERS = 8
TWO_RANK_LAYERS = {"mim": 4, "vjepa": LEG_V_LAYERS,
                   "lora": LORA_PARITY_LAYERS}
# legs C, H and P (leg P's reference is leg C): the MIM preset's encoder
# cut 12 -> 4 (the decoder keeps its 4), leg P's three launches and the CLI
# legs first in line to keep the script inside its time limit once the
# 2-rank phase held the PR 22 modes (12 until then)
LEG_C_LAYERS = 4
VJEPA_PARITY_LAYERS = 12
# legs D and I: the steps of the first run (a checkpoint every 2), then of
# the resumed one
LEG_V_STEPS = (2, 4)
# the EMA check: the teacher moves by (1 - momentum) times the student's
# update, up to f32 rounding of t*m + s*(1 - m); held within a factor of 2
TOL_EMA_RATIO = 2.0

SOURCES = {
    "flash_fwd": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                  "smb_vision_tpu/ops/attention.py:106"),
    "flash_fwd_i8": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                     "smb_vision_tpu/ops/attention.py:244"),
    "mlp_block_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                      "smb_vision_tpu/ops/mlp.py:214"),
    "mlp_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                "smb_vision_tpu/ops/mlp.py:109"),
    "flash_bwd": ("smb_vision_tpu_torch/csrc/flash_bwd.cu",
                  "smb_vision_tpu/ops/attention.py:436"),
    "mlp_train_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                      "smb_vision_tpu/ops/mlp.py:137"),
    "mlp_bwd": ("smb_vision_tpu_torch/csrc/mlp_bwd.cu",
                "smb_vision_tpu/ops/mlp.py:171"),
    "flash_bwd_i8": ("smb_vision_tpu_torch/csrc/flash_bwd.cu",
                     "smb_vision_tpu/ops/attention.py:549"),
    "swiglu_block_fwd": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                         "smb_vision_tpu/ops/mlp.py:256"),
    "flash_fwd_i8pv": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                       "smb_vision_tpu/ops/attention.py:244"),
    "qkv_ln_fwd": ("smb_vision_tpu_torch/csrc/attn_glue.cu",
                   "smb_vision_tpu/ops/attn_glue.py:98"),
    "out_res_fwd": ("smb_vision_tpu_torch/csrc/attn_glue.cu",
                    "smb_vision_tpu/ops/attn_glue.py:118"),
    # the head-width-32 instantiations of K1, K4 and K7 (the reference-head
    # V-JEPA2 predictor); their launches are their wrappers' counts at d 32
    "flash_fwd d32": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                      "smb_vision_tpu/ops/attention.py:106"),
    "flash_bwd d32": ("smb_vision_tpu_torch/csrc/flash_bwd.cu",
                      "smb_vision_tpu/ops/attention.py:436"),
    "flash_bwd_i8 d32": ("smb_vision_tpu_torch/csrc/flash_bwd.cu",
                         "smb_vision_tpu/ops/attention.py:549"),
    # R6, the per-(batch, head) int8 quantisation before K3, K7 and K8: the
    # JAX package computes it in XLA (`_fwd_i8`, `_quant_per_head`), no
    # pallas_call; its launches are leg B's (q and k of every layer)
    "quantize": ("smb_vision_tpu_torch/csrc/quant.cu",
                 "smb_vision_tpu/ops/attention.py:320"),
    # W8A8 (quant8): the per-row quantisation and the s8 x s8 -> s32
    # product with its dequantisation, which the JAX package leaves to XLA
    # (`w8a8_dot`, no pallas_call); their launches are leg Q's
    "quantize_rows": ("smb_vision_tpu_torch/csrc/quant.cu",
                      "smb_vision_tpu/ops/quant.py:47"),
    "w8a8_gemm": ("smb_vision_tpu_torch/csrc/w8a8.cu",
                  "smb_vision_tpu/ops/quant.py:56"),
    # K3 and K8 at head width 32; their launches are the reference-head
    # predictor's in `phase_d32_int8_path`
    "flash_fwd_i8 d32": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                         "smb_vision_tpu/ops/attention.py:244"),
    "flash_fwd_i8pv d32": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                           "smb_vision_tpu/ops/attention.py:244"),
    # the forward family past the instantiations' widths: K1 at head
    # widths 72 (SigLIP so400m, leg M) and 80 (the ViT-H VideoMAE, legs N,
    # T and U) on its tiles of 80 columns (the template of flash_fwd.cu
    # compiled in flash_fwd_d80.cu), K3 there on the same tiles (compiled
    # in flash_fwd_i8_d80.cu, codes of 96 bytes), K8 on the d-128
    # instantiation, R6 writing q8 and k8 at width 96 for K3's heads of 80,
    # and K2 and K6 at K 1,280 (ViT-H); their launches are those legs'
    "flash_fwd d72": ("smb_vision_tpu_torch/csrc/flash_fwd_d80.cu",
                      "smb_vision_tpu/ops/attention.py:106"),
    "flash_fwd d80": ("smb_vision_tpu_torch/csrc/flash_fwd_d80.cu",
                      "smb_vision_tpu/ops/attention.py:106"),
    "flash_fwd_i8 d72": ("smb_vision_tpu_torch/csrc/flash_fwd_i8_d80.cu",
                         "smb_vision_tpu/ops/attention.py:244"),
    "flash_fwd_i8 d80": ("smb_vision_tpu_torch/csrc/flash_fwd_i8_d80.cu",
                         "smb_vision_tpu/ops/attention.py:244"),
    "flash_fwd_i8pv d72": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                           "smb_vision_tpu/ops/attention.py:244"),
    "flash_fwd_i8pv d80": ("smb_vision_tpu_torch/csrc/flash_fwd.cu",
                           "smb_vision_tpu/ops/attention.py:244"),
    "quantize d80": ("smb_vision_tpu_torch/csrc/quant.cu",
                     "smb_vision_tpu/ops/attention.py:320"),
    "mlp_block_fwd K1280": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                            "smb_vision_tpu/ops/mlp.py:214"),
    "mlp_fwd K1280": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                      "smb_vision_tpu/ops/mlp.py:109"),
    # K9 at a K past 1,536 (K 2,048, at DINOv2-giant batch 2's rows): no
    # model of the repo has a SwiGLU MLP that wide, so no path launches it
    # and its launches stay 0; the row keeps its time, bound and chain
    "swiglu_block_fwd K2048": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                               "smb_vision_tpu/ops/mlp.py:256"),
    # the training family past the instantiations' widths: K4 and K7 at
    # head widths 72 (SigLIP so400m's shape; no path trains it) and 80 (K4
    # at the ViT-H MIM encoder, leg X; K7 at the V-JEPA2 ViT-H encoder, leg
    # Y), K4 on its tiles of 80 columns (flash_bwd.cu's template compiled
    # in flash_bwd_d80.cu), K7 on the same tiles (compiled in
    # flash_bwd_i8_d80.cu, codes of 96 bytes); K4 at d 100
    # (padded to 104, the d-128 tiles; a shape of no model), and K5a and
    # K5b at K 1,280 (ViT-H, legs X and Y) and 1,408 (ViT-g's widths,
    # which no model of the repo has: 0 launches)
    "flash_bwd d72": ("smb_vision_tpu_torch/csrc/flash_bwd_d80.cu",
                      "smb_vision_tpu/ops/attention.py:436"),
    "flash_bwd d80": ("smb_vision_tpu_torch/csrc/flash_bwd_d80.cu",
                      "smb_vision_tpu/ops/attention.py:436"),
    "flash_bwd d100": ("smb_vision_tpu_torch/csrc/flash_bwd.cu",
                       "smb_vision_tpu/ops/attention.py:436"),
    "flash_bwd_i8 d72": ("smb_vision_tpu_torch/csrc/flash_bwd_i8_d80.cu",
                         "smb_vision_tpu/ops/attention.py:549"),
    "flash_bwd_i8 d80": ("smb_vision_tpu_torch/csrc/flash_bwd_i8_d80.cu",
                         "smb_vision_tpu/ops/attention.py:549"),
    "mlp_train_fwd K1280": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                            "smb_vision_tpu/ops/mlp.py:137"),
    "mlp_bwd K1280": ("smb_vision_tpu_torch/csrc/mlp_bwd.cu",
                      "smb_vision_tpu/ops/mlp.py:171"),
    "mlp_train_fwd K1408": ("smb_vision_tpu_torch/csrc/mlp_fwd.cu",
                            "smb_vision_tpu/ops/mlp.py:137"),
    "mlp_bwd K1408": ("smb_vision_tpu_torch/csrc/mlp_bwd.cu",
                      "smb_vision_tpu/ops/mlp.py:171"),
}
D32_ROWS = {"flash_fwd d32": "flash_fwd", "flash_bwd d32": "flash_bwd",
            "flash_bwd_i8 d32": "flash_bwd_i8",
            "flash_fwd_i8 d32": "flash_fwd_i8",
            "flash_fwd_i8pv d32": "flash_fwd_i8pv"}
# the least time of a kernel's work on one H100 SXM at 700 W (NVIDIA's data
# sheet, dense): operations at the peak of their type, bytes (each input
# read once, each output written once) at the HBM rate; the larger bounds
PEAK_BF16, PEAK_INT8, HBM_BYTES = 989e12, 1979e12, 3.35e12
# readings of a kernel's time by CUDA events whose median is kept (cuda_ms)
KERNEL_REPEATS = 5
# SigLIP so400m-patch14-384 (google/siglip-so400m-patch14-384's config):
# 27 layers of 16 heads of 72, MLP 4,304, 384^2 at patch 14 = 729 tokens
SO400M = dict(image_size=384, patch_size=14, hidden_size=1152,
              num_hidden_layers=27, num_attention_heads=16,
              intermediate_size=4304)
SO400M_N = 729
# a VideoMAE at ViT-Huge widths (MCG-NJU/videomae-huge config.json: hidden
# 1,280, 32 layers, 16 heads of 80, MLP 5,120) on the CT geometry, 512^2 x
# 320 at 16^3 patches (MAIN_N tokens), 0.63 B parameters
VIT_H = dict(hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
             intermediate_size=5120)
VIT_H_HEADS, VIT_H_D, VIT_H_K, VIT_H_F = 16, 80, 1280, 5120
# the parity runs VIT_H_PARITY_LAYERS of the 32 layers (PERF.md section
# 2's forward rule is set at the ViT-Base model's 12); the rate runs all
# 32; the CLI legs (N, T, U through run_inference, X and Y through run_mim
# and run_vjepa) cut the encoder to VIT_H_LEG_LAYERS, as legs D, O and F
# cut theirs, for the script's time limit: the CLI's CPU initialisation
# of 0.63 B parameters takes most of a 32-layer leg's time
VIT_H_PARITY_LAYERS = 12
VIT_H_LEG_LAYERS = 8
# the three configurations of the ViT-H path: (leg, config mlp_impl, the
# CLI's --attn_impl, the attention kernel's wrapper, the MLP kernel's)
VIT_H_LEGS = (("N", "auto", "auto", "flash_fwd", "mlp_block_fwd"),
              ("T", "pallas_bwd", "pallas_int8", "flash_fwd_i8", "mlp_fwd"),
              ("U", "auto", "pallas_int8pv", "flash_fwd_i8pv",
               "mlp_block_fwd"))
# training at ViT-H widths: the MIM preset (configs/mim_base_512.json) with
# the encoder at MCG-NJU/videomae-huge's widths and the V-JEPA2 _tpu preset
# (configs/vjepa_large_384_tpu.json) with facebook/vjepa2-vith-fpc64-256's
# encoder (mlp_ratio 4: MLP 5,120); the decoder and the predictor as the
# presets have them. The parities run VIT_H_PARITY_LAYERS of the 32
# layers, the step times all 32, legs X (run_mim) and Y (run_vjepa)
# VIT_H_LEG_LAYERS
VIT_H_MIM = dict(hidden_size=1280, num_attention_heads=16,
                 intermediate_size=5120)
VIT_H_VJEPA = dict(hidden_size=1280, num_attention_heads=16)
LOG2E = 1.4426950408889634


def log(msg: str) -> None:
    # one write a line: leg P logs from a thread beside the 2-rank phase
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


def wrappers():
    from smb_vision_tpu_torch.ops.attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_i8,
        flash_attention_int8,
        flash_attention_int8pv,
        quantize_per_head_kernel,
    )
    from smb_vision_tpu_torch.ops.attn_glue import out_res_fused, qkv_ln_fused
    from smb_vision_tpu_torch.ops.mlp import (
        mlp_block_fused,
        mlp_bwd_fused,
        mlp_fused,
        mlp_train_fused,
        swiglu_block_fused,
    )
    from smb_vision_tpu_torch.ops.quant import (
        quantize_rows_kernel,
        w8a8_gemm_kernel,
    )

    return {"flash_fwd": flash_attention,
            "flash_fwd_i8": flash_attention_int8,
            "mlp_block_fwd": mlp_block_fused, "mlp_fwd": mlp_fused,
            "flash_bwd": flash_attention_bwd,
            "mlp_train_fwd": mlp_train_fused, "mlp_bwd": mlp_bwd_fused,
            "flash_bwd_i8": flash_attention_bwd_i8,
            "swiglu_block_fwd": swiglu_block_fused,
            "flash_fwd_i8pv": flash_attention_int8pv,
            "qkv_ln_fwd": qkv_ln_fused, "out_res_fwd": out_res_fused,
            "quantize": quantize_per_head_kernel,
            "quantize_rows": quantize_rows_kernel,
            "w8a8_gemm": w8a8_gemm_kernel}


def plain_qk(q, k, scale, kernel: str = "K3"):
    """q8, k8, sq, sk by the plain quantisation (`quantize_per_head`):
    the operands of K3's (or, kernel "K8", K8's) plain version on the
    card, at the code width that kernel reads."""
    from smb_vision_tpu_torch.ops import attention as A

    return A.quantize_qk(q, k, scale, A.quantize_per_head, kernel)


def reset_launches() -> dict:
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
        if hasattr(w, "launches_by_width"):
            w.launches_by_width = {}
    return ws


def d32_launches(ws: dict) -> dict:
    """{row of D32_ROWS: its wrapper's launches at head width 32}."""
    return {row: ws[name].launches_by_width.get(32, 0)
            for row, name in D32_ROWS.items()}


@contextlib.contextmanager
def plain_attention_calls():
    """Inside the block, count the calls of the plain attention
    (`xla_attention`) by head width: yields the {width: calls} dict."""
    from smb_vision_tpu_torch.ops import attention as A

    calls, plain = {}, A.xla_attention

    def counted(q, *args, **kw):
        calls[q.shape[-1]] = calls.get(q.shape[-1], 0) + 1
        return plain(q, *args, **kw)

    A.xla_attention = counted
    try:
        yield calls
    finally:
        A.xla_attention = plain


def cuda_ms(fn, iters: int = 5, warmup: int = 2, repeats: int = 1) -> float:
    """Mean time of fn() over iters calls on the device, by CUDA events,
    after warm-up; the median of `repeats` such readings. A reading of a
    few milliseconds takes in whole any host stall inside it (a garbage
    collection of this large process, a busy shared host): the median of
    KERNEL_REPEATS keeps one such reading from deciding a kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    readings = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        readings.append(start.elapsed_time(end) / iters)
    return statistics.median(readings)


def host_ms(fn, calls: int = 5) -> float:
    """The host's time to issue one call of fn (its launches enqueued,
    nothing waited for): the median over `calls` calls after a warm-up.
    Below the call's device time, the device sets the time of a run of
    calls; above it, the host does."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def tile_work(d: int, kernel: str) -> str:
    """The tensor work `kernel`'s instantiation does at head width d (a
    multiple of 8), as a multiple of the work of width d, and the tiles'
    width: the columns past d are zeros that the products still take."""
    from smb_vision_tpu_torch.ops import attention as A

    w = A._tile_width(d, kernel)
    return f"{w / d:.2f}x (d-{w} tiles)"


def set_bound(table: dict, name: str, shape: str, bf16_ops: float,
              nbytes: float, int8_ops: float = 0.0) -> None:
    """The kernel's bound at the shape its time was kept at: the larger of
    its operations over the peak of their type and its bytes over the HBM
    rate."""
    ops_ms = (bf16_ops / PEAK_BF16 + int8_ops / PEAK_INT8) * 1e3
    bytes_ms = nbytes / HBM_BYTES * 1e3
    rec = table[name]
    rec["bound_ms"] = max(ops_ms, bytes_ms)
    rec["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"bound {name:<16} {shape}: {rec['bound_ms']:.4f} ms by "
        f"{rec['bound_by']} ({(bf16_ops + int8_ops) / 1e9:.1f} GOP, "
        f"{nbytes / 1e6:.1f} MB); kernel {rec['ms']:.4f} ms")


def mlp_bytes(m: int, k: int, f: int, n_w: int = 2, ln: bool = False,
              extra_mf: int = 0) -> float:
    """Bytes of an MLP-family kernel: x read and y written (bf16, M x K),
    n_w bf16 weights of K x F, f32 biases (and LayerNorm params), and
    extra_mf more bf16 M x F tensors read or written."""
    return (2 * m * k * 2 + n_w * k * f * 2 + (n_w - 1) * f * 4 + k * 4
            + (2 * k * 4 if ln else 0) + extra_mf * m * f * 2)


def attn_bytes(b: int, n: int, h: int, d: int, tensors: int) -> float:
    """Bytes of `tensors` bf16 (B, N, H, D) tensors plus one f32 lse2."""
    return tensors * b * n * h * d * 2 + b * h * n * 4


def rate_line(table: dict, name: str, shape: str, flops: float,
              library: str = "SDPA's") -> None:
    """The kept time's achieved rate, its share of the bound and its factor
    against the library call's time."""
    rec = table[name]
    log(f"rate {name:<16} {shape}: {flops / rec['ms'] / 1e9:.1f} TFLOP/s, "
        f"{rec['bound_ms'] / rec['ms']:.1%} of bound, "
        f"{rec['ms'] / rec['library_ms']:.2f}x {library} time")


def mlp_chain(x, w1, b1, w2, b2, lnw=None, lnb=None, eps=1e-12,
              spill=False):
    """The library yardstick of K2, K6 and K5a: their function as a chain
    of PyTorch calls in bf16 (cuBLAS addmm with the bias, F.gelu, and for
    K2 F.layer_norm and the residual add); w1 (K, F), w2 (F, K). Timed
    beside the kernels; the port never calls it."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    a = x if lnw is None else F.layer_norm(
        x.float(), (x.shape[-1],), lnw, lnb, eps).to(bf)
    h = torch.addmm(b1.to(bf), a, w1)
    y = torch.addmm(b2.to(bf), F.gelu(h), w2)
    if lnw is not None:
        y = y + x
    return (y, h) if spill else y


def mlp_bwd_chain(h, g, w1, w2, act: str = "gelu"):
    """The library yardstick of K5b: its function as PyTorch calls in bf16,
    torch.mm for da = g w2^T and dx = dh w1^T (cuBLAS), F.gelu for a and
    aten.gelu_backward for dh (approximate "tanh" for gelu_new); w1 (K, F),
    w2 (F, K). Returns (dx, dh, a). Timed beside the kernel; the port never
    calls it."""
    import torch
    import torch.nn.functional as F

    approximate = "tanh" if act == "gelu_new" else "none"
    da = torch.mm(g, w2.t())
    dh = torch.ops.aten.gelu_backward(da, h, approximate=approximate)
    return (torch.mm(dh, w1.t()), dh,
            F.gelu(h, approximate=approximate))


def mlp_library(table: dict, name: str, shape: str, chain) -> None:
    """Time an MLP kernel's cuBLAS chain at the shape the table keeps, as
    the kernel's library_ms."""
    table[name]["library_ms"] = ms = cuda_ms(chain, iters=20,
                                             repeats=KERNEL_REPEATS)
    log(f"time {name:<14} {shape:<30} library cuBLAS chain {ms:.3f} ms "
        f"(CUDA events)")


def mlp_beside_chain(name: str, shape: str, kernel, plain, chain, m: int,
                     k: int, f: int, nbytes: float, products: int = 2) -> None:
    """An MLP kernel at a shape the table does not keep: its time beside
    its plain version's, its cuBLAS chain's and its bound (`products`
    matrix products of M x K x F)."""
    ms = cuda_ms(kernel, iters=20, repeats=KERNEL_REPEATS)
    plain_ms = cuda_ms(plain, iters=2)
    lib = cuda_ms(chain, iters=20, repeats=KERNEL_REPEATS)
    bound = max(2 * products * m * k * f / PEAK_BF16,
                nbytes / HBM_BYTES) * 1e3
    log(f"time {name:<14} {shape:<30} kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, cuBLAS chain {lib:.3f} ms ({ms / lib:.2f}x), "
        f"bound {bound:.4f} ms (CUDA events)")


def exp2_floor_ms(n: int, h: int) -> float:
    """The least time of the N^2*H exp2 of one flash forward or backward
    pass on the card's multi-function units: 16 a clock on each SM, at the
    card's highest SM clock."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n * n * h / (16 * sms * mhz * 1e6) * 1e3


def sdpa_ms(q, k, v, do=None) -> float:
    """The library call: F.scaled_dot_product_attention on the same
    inputs (forward), or its backward alone when do is given."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if do is None:
        return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                       repeats=KERNEL_REPEATS)
    qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2).contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True),
                   repeats=KERNEL_REPEATS)


def errors(out, ref):
    """(max|out - ref|, max|out - ref| / max|ref|); inf if out is not
    finite."""
    out, ref = out.float(), ref.float()
    if not bool(out.isfinite().all()):
        return math.inf, math.inf
    err = float((out - ref).abs().max())
    return err, err / float(ref.abs().max())


def phase_device() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


# the wgmma kernels by a part of their mangled names (K1 and K3 are the
# instantiations of flash_fwd_sm90_kernel<D, I8, NARROW>, "narrow" those
# that store a head narrower than D, as K8's of
# flash_fwd_i8pv_sm90_kernel<D, NARROW> and K4's and K7's of
# flash_bwd_sm90_kernel<D, NARROW> and flash_bwd_i8_sm90_kernel<D, NARROW>,
# which run both of their passes in one kernel each; K2, K6, K5a and K9
# are two products each, mlp_gemm_kernel<PHASE, EXTRA>, whose
# instantiations serve every K:
# phase 1 with the spill of h for K5a, phase 2 with the residual for K2
# and K9, phase 3 K9's gated phase 1, phase 4 (phase 2 with a TMA-loaded
# residual) all of K10b; K5b is mlp_bwd_gemm_kernel<PHASE>; K10a's GEMM is
# qkv_gemm_kernel),
# and the SASS instructions that show they run on Hopper's warpgroup MMA,
# bf16 (HGMMA) and int8 (IGMMA), fed by TMA (UTMALDG); a kernel without
# one of its instructions fails the build phase
SM90_KERNELS = {
    f"{k} d{d}{tag}": (name.format(d=d, n=n), ops) for d in (32, 64, 128)
    for n, tag in ((0, ""), (1, " narrow"))
    for k, name, ops in (
        ("K1", "flash_fwd_sm90_kernelILi{d}ELb0ELb{n}E",
         ("HGMMA", "UTMALDG")),
        ("K3", "flash_fwd_sm90_kernelILi{d}ELb1ELb{n}E",
         ("IGMMA", "HGMMA", "UTMALDG")),
        ("K8", "flash_fwd_i8pv_sm90_kernelILi{d}ELb{n}E",
         ("IGMMA", "UTMALDG")),
        ("K4", "flash_bwd_sm90_kernelILi{d}ELb{n}E", ("HGMMA", "UTMALDG")),
        ("K7", "flash_bwd_i8_sm90_kernelILi{d}ELb{n}E",
         ("IGMMA", "HGMMA", "UTMALDG")))}
# the tiles of 80 columns (heads of 72 and 80) of K1 and K4 and, on int8
# codes of 96 bytes, of K3 and K7
SM90_KERNELS.update({
    f"{k} d80{tag}": (name.format(n=n), ops)
    for n, tag in ((0, ""), (1, " narrow"))
    for k, name, ops in (
        ("K1", "flash_fwd_sm90_kernelILi80ELb0ELb{n}E", ("HGMMA", "UTMALDG")),
        ("K4", "flash_bwd_sm90_kernelILi80ELb{n}E", ("HGMMA", "UTMALDG")),
        ("K3", "flash_fwd_sm90_kernelILi80ELb1ELb{n}E",
         ("IGMMA", "HGMMA", "UTMALDG")),
        ("K7", "flash_bwd_i8_sm90_kernelILi80ELb{n}E",
         ("IGMMA", "HGMMA", "UTMALDG")))})
SM90_KERNELS.update({
    label: (f"mlp_gemm_kernelILi{phase}ELb{extra}E", ("HGMMA", "UTMALDG"))
    for label, phase, extra in (("K2/K6 phase 1", 1, 0),
                                ("K5a phase 1", 1, 1),
                                ("K6/K5a phase 2", 2, 0),
                                ("K2/K9 phase 2", 2, 1),
                                ("K9 phase 1", 3, 0), ("K10b", 4, 1))})
SM90_KERNELS.update({
    f"K5b phase {phase}": (f"mlp_bwd_gemm_kernelILi{phase}E",
                           ("HGMMA", "UTMALDG")) for phase in (1, 2)})
SM90_KERNELS["K10a GEMM"] = ("qkv_gemm_kernel", ("HGMMA", "UTMALDG"))
# the W8A8 product, w8a8_gemm_kernel<F32> (bf16 and f32 output)
SM90_KERNELS.update({
    f"W8A8 GEMM {out}": (f"w8a8_gemm_kernelILb{f32}E", ("IGMMA", "UTMALDG"))
    for out, f32 in (("bf16", 0), ("f32", 1))})
SM90_SASS = ("IGMMA", "HGMMA", "UTMALDG")
# the mma.sync tensor-core instructions (int8 and bf16), of which no kernel
# of the library may hold one: every product is on wgmma
MMA_SYNC_SASS = ("IMMA", "HMMA")


def sass_listing(lib: Path) -> dict:
    """{mangled kernel name: its SASS instructions, addresses and encodings
    dropped} of a built library, by cuobjdump where the toolkit has it
    (else {})."""
    from smb_vision_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log("cuobjdump not in the toolkit: SASS check skipped")
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name] = []
        elif name:
            ins = line.split("/*")[1].split("*/")[1] if "/*" in line else ""
            if ins.strip():
                funcs[name].append(ins.strip())
    return funcs


def count_ops(body: list, ops: tuple) -> dict:
    """{instruction: how many lines of the SASS body hold it}."""
    return {op: sum(ins.startswith(op) or f" {op}" in ins for ins in body)
            for op in ops}


def sass_counts(lib: Path) -> tuple:
    """({kernel: {instruction: count}} of the SM90_KERNELS in the built
    library, {function: count} of every function holding an mma.sync
    instruction); both empty without cuobjdump."""
    counts, mma_sync = {}, {}
    for fn, body in sass_listing(lib).items():
        label = next((k for k, (name, _) in SM90_KERNELS.items()
                      if name in fn), None)
        if label:
            counts[label] = count_ops(body, SM90_SASS)
        old = sum(count_ops(body, MMA_SYNC_SASS).values())
        if old:
            mma_sync[fn] = old
    return counts, mma_sync


def ptxas_report(name: str, build_dir=None) -> list:
    """The ptxas lines (registers, spills) of the kernels whose mangled
    names hold `name`, from the build log in build_dir (default: that of
    this tree's library)."""
    from smb_vision_tpu_torch.ops import _build

    lines, keep = [], False
    log_path = (build_dir or _build.build_dir()) / "build.log"
    for line in log_path.read_text().splitlines():
        if "entry function" in line:
            keep = name in line
        if keep and any(w in line for w in ("entry function", "registers",
                                            "spill")):
            lines.append(line.strip())
    return lines


def phase_build() -> None:
    from smb_vision_tpu_torch.data import build_native
    from smb_vision_tpu_torch.ops import _build

    # leg J holds the native loader to a build of this run, from the
    # checkout's source: an earlier run's or the tests' build goes first
    for old in build_native.BUILD_DIR.glob("ctloader-*"):
        shutil.rmtree(old)
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {path.parent.name}")
    for line in (path.parent / "build.log").read_text().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error", "C75")):
            log(f"  ptxas: {line.strip()}")
    counts, mma_sync = sass_counts(path)
    for label, (_, ops) in SM90_KERNELS.items() if counts else ():
        got = counts.get(label, dict.fromkeys(SM90_SASS, 0))
        log(f"  sass {label}: " + ", ".join(f"{op} {n}"
                                             for op, n in got.items()))
        if not all(got[op] for op in ops):
            raise AssertionError(f"{label}: no {ops} instructions in the "
                                 "build; the wgmma path is not what runs")
    if counts:
        log(f"  sass: mma.sync ({', '.join(MMA_SYNC_SASS)}) instructions in "
            f"the library: {sum(mma_sync.values())}")
        if mma_sync:
            raise AssertionError(f"mma.sync instructions left in {mma_sync}")


# the card tests the run holds the kernels to besides its own phases: the
# d-80 tiles of K1, K4, K3 and K7 against their plain versions at their
# edges, the instantiation each head width launches (by the profiler's
# kernel names) and the launches by width
CARD_TESTS = ("tests/test_torch_d80.py",)


def phase_card_tests() -> None:
    """CARD_TESTS under pytest in a process of its own (`-m cuda`, no
    conftest: tests/conftest.py imports JAX, which this machine need not
    have); a failure fails the run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", *CARD_TESTS], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    tail = proc.stdout.strip().splitlines()[-1:]
    log(f"card tests {' '.join(CARD_TESTS)}: {' '.join(tail)} "
        f"({time.perf_counter() - t0:.1f} s)")
    if proc.returncode != 0:
        raise AssertionError(f"card tests failed:\n{proc.stdout[-4000:]}"
                             f"{proc.stderr[-2000:]}")


def _attn_inputs(n: int, gen, dev):
    """q, k, v ~ N(0, 0.4^2), the distribution of the JAX package's own
    attention tests (tests/test_attention.py::_qkv), whose bounds these
    are."""
    import torch

    shape = (1, n, HEADS, HEAD_DIM)
    return [(torch.randn(shape, generator=gen, device=dev) * 0.4).to(
        torch.bfloat16) for _ in range(3)]


def _mlp_inputs(m: int, gen, dev, k: int = HIDDEN, f: int = FFN):
    """x and Linear-layout bf16 weights (passed as transposed views, as
    the model passes them)."""
    import torch

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    x = r(m, k).to(torch.bfloat16)
    lnw, lnb = 1.0 + r(k, s=0.1), r(k, s=0.1)
    w1 = r(f, k, s=k ** -0.5).to(torch.bfloat16)
    w2 = r(k, f, s=f ** -0.5).to(torch.bfloat16)
    b1, b2 = r(f, s=0.1), r(k, s=0.1)
    return x, lnw, lnb, w1.t(), b1, w2.t(), b2


def new_table() -> dict:
    """{name: record} of the JSON kernel table, one row of SOURCES each,
    its numbers not yet measured."""
    return {name: {"name": name, "route": "cuda", "source": src,
                   "replaces": rep, "launches": 0, "max_abs_err": 0.0,
                   "ms": None, "plain_ms": None, "bound_ms": None,
                   "bound_by": None, "library_ms": None}
            for name, (src, rep) in SOURCES.items()}


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main-path shape and a
    ragged one, and its time beside the plain version's at the main-path
    shape. Returns {name: record} for the JSON kernel table."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = new_table()

    def check(name, n, out, ref, tol, what="plain"):
        check_kernel(table, name, f"N={n} vs {what}", out, ref, tol,
                     record=what == "plain")

    def timed(name, kernel, plain, iters):
        time_kernel(table, name, f"main-path N={MAIN_N}", kernel, plain,
                    iters, True)

    scale = 1.0 / math.sqrt(HEAD_DIM)
    for n in (MAIN_N, RAGGED_N):
        q, k, v = _attn_inputs(n, gen, dev)
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
        check("flash_fwd", n, out, ref, TOL_FLASH)
        check("flash_fwd", n, lse, ref_lse, TOL_FLASH, "plain lse2")
        q8, k8, sq, sk = plain_qk(q, k, scale)
        out8 = A.flash_attention_int8(q, k, v)
        check("flash_fwd_i8", n, out8,
              A.int8_attention_plain(q8, k8, sq, sk, v), TOL_INT8)
        check("flash_fwd_i8", n, out8,
              A.xla_attention(q.float(), k.float(), v.float()),
              TOL_INT8_F32, "f32 softmax")
        if n == MAIN_N:
            timed("flash_fwd", lambda: A.flash_attention(q, k, v),
                  lambda: A.xla_attention(q, k, v), 8)
            timed("flash_fwd_i8", lambda: A.flash_attention_int8(q, k, v),
                  lambda: A.int8_attention_plain(
                      *plain_qk(q, k, scale), v), 8)
            table["flash_fwd"]["library_ms"] = sdpa_ms(q, k, v)
            log(f"time flash_fwd library F.scaled_dot_product_attention "
                f"N={n}: {table['flash_fwd']['library_ms']:.3f} ms")
            pv = 2 * n * n * HEAD_DIM * HEADS
            nb = attn_bytes(1, n, HEADS, HEAD_DIM, 4)
            set_bound(table, "flash_fwd", f"N={n}", 2 * pv, nb)
            set_bound(table, "flash_fwd_i8", f"N={n}", pv, nb, int8_ops=pv)
            rate_line(table, "flash_fwd", f"N={n}", 2 * pv)
            k3_beside_k1(f"N={n} H={HEADS} d={HEAD_DIM}", q, k, v)
            # at d 64 the exp2 floor is as long as the tensor floor, so K1
            # reaches the bound only if its exp2 runs under its GEMMs
            log(f"exp2 floor flash_fwd N={n}: "
                f"{exp2_floor_ms(n, HEADS):.3f} ms beside the tensor floor "
                f"{table['flash_fwd']['bound_ms']:.3f} ms")
        del q, k, v, out, ref, out8

        x, lnw, lnb, w1, b1, w2, b2 = _mlp_inputs(n, gen, dev)
        eps = 1e-12
        check("mlp_block_fwd", n,
              M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, eps=eps),
              M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, "gelu", eps),
              TOL_MLP)
        check("mlp_fwd", n, M.mlp_fused(x, w1, b1, w2, b2),
              M._mlp_xla(x, w1, b1, w2, b2, "gelu"), TOL_MLP)
        if n == MAIN_N:
            timed("mlp_block_fwd",
                  lambda: M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2,
                                            eps=eps),
                  lambda: M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2,
                                           "gelu", eps), 20)
            timed("mlp_fwd", lambda: M.mlp_fused(x, w1, b1, w2, b2),
                  lambda: M._mlp_xla(x, w1, b1, w2, b2, "gelu"), 20)
            mlp_library(table, "mlp_block_fwd", f"main-path N={n}",
                        lambda: mlp_chain(x, w1, b1, w2, b2, lnw, lnb, eps))
            mlp_library(table, "mlp_fwd", f"main-path N={n}",
                        lambda: mlp_chain(x, w1, b1, w2, b2))
            ops = 4 * n * HIDDEN * FFN
            set_bound(table, "mlp_block_fwd", f"M={n}", ops,
                      mlp_bytes(n, HIDDEN, FFN, ln=True))
            set_bound(table, "mlp_fwd", f"M={n}", ops,
                      mlp_bytes(n, HIDDEN, FFN))
            for name in ("mlp_block_fwd", "mlp_fwd"):
                rate_line(table, name, f"M={n}", ops, "the chain's")
    phase_quant_kernel(table, gen, dev)
    phase_w8a8_kernels(table, gen, dev)
    phase_train_kernels(table, gen, dev)
    phase_vjepa_kernels(table, gen, dev)
    phase_d32_kernels(table, gen, dev)
    phase_dinov2_kernels(table, gen, dev)
    phase_glue_kernels(table, gen, dev)
    phase_width_kernels(table, gen, dev)
    phase_train_width_kernels(table, gen, dev)
    return table


def phase_quant_kernel(table: dict, gen, dev) -> None:
    """The quantisation kernel (R6) against `quantize_per_head`, bit for
    bit (the int8 bytes and the f32 scales), in the input's layout and in
    K8's v layout (`quantize_v_kernel_layout` of the plain bytes): leg B's
    q at batch 4 (times scale*log2(e)), the V-JEPA encoder's and the
    reference-head predictor's shapes, a ragged N 1,961, a tensor with one
    all-zero head, and q, k, v as the strided views of a fused projection.
    Timed at the embed shape (q of batch 1) beside the plain pass, with its
    passes' device times by the profiler and its bytes bound (no library
    call computes it)."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A

    def r(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.4).to(
            torch.bfloat16)

    q_mult = LOG2E / math.sqrt(HEAD_DIM)
    zero = r(2, 193, 4, 64)
    zero[1, :, 2] = 0
    fused = r(2, RAGGED_N, 3, HEADS, HEAD_DIM).unbind(2)
    cases = {"embed batch 4 q": (r(4, MAIN_N, HEADS, HEAD_DIM), q_mult),
             "V-JEPA encoder": (r(1, VJ_N, 8, 128), 1.0),
             "predictor d32": (r(1, VJ_N, PRED_HEADS, 32),
                               LOG2E / math.sqrt(32)),
             "ragged N 1961": (r(1, 1961, HEADS, HEAD_DIM), 1.0),
             "one all-zero head": (zero, 1.0),
             **{f"fused {name}": (t, 1.0) for name, t in zip("qkv", fused)}}
    for label, (x, mult) in cases.items():
        want8, want_s = A.quantize_per_head(x, mult)
        x8, s = A.quantize_per_head_kernel(x, mult)
        vt, sv = A.quantize_per_head_kernel(x, mult, v_layout=True)
        same = {"bytes": torch.equal(x8, want8), "scales": torch.equal(
            s, want_s), "v layout": torch.equal(
                vt, A.quantize_v_kernel_layout(want8)),
            "v scales": torch.equal(sv, want_s)}
        log(f"quantize {label} {tuple(x.shape)} strides {x.stride()}: bit "
            f"for bit {same}")
        if not all(same.values()):
            raise AssertionError(f"quantize {label}: {same}")
        if label == "one all-zero head" and float(s[1, 2]) != 1.0:
            raise AssertionError("quantize: an all-zero head's scale is "
                                 f"{float(s[1, 2])}, not 1")
    # zero_scale (K7's do): the all-zero head reports 0, the rest as before
    want8, want_s = A.quantize_per_head(zero, 1.0, zero_scale=True)
    x8, s = A.quantize_per_head_kernel(zero, zero_scale=True)
    same = torch.equal(x8, want8) and torch.equal(s, want_s)
    log(f"quantize one all-zero head, zero_scale: bit for bit {same}, the "
        f"head's scale {float(s[1, 2])}")
    if not same or float(s[1, 2]) != 0.0:
        raise AssertionError(f"quantize zero_scale: bit for bit {same}, the "
                             f"all-zero head's scale {float(s[1, 2])}")
    del cases, x, want8, x8, vt, fused, zero
    q = r(1, MAIN_N, HEADS, HEAD_DIM)
    shape = f"embed q N={MAIN_N} H={HEADS} d={HEAD_DIM}"
    time_kernel(table, "quantize", shape,
                lambda: A.quantize_per_head_kernel(q, q_mult),
                lambda: A.quantize_per_head(q, q_mult), 20, True)
    for key, count, t in device_times(
            lambda: A.quantize_per_head_kernel(q, q_mult)):
        log(f"split quantize {shape}: {key[:60]} x{count} a call, "
            f"{t:.4f} ms each (profiler)")
    # what the function must move: one read of x (bf16), one write of x8
    # (int8) and of the (B, H) f32 scales; the kernel's second read of x
    # (its int8 pass) is a cost of its two-pass design, not of the function
    set_bound(table, "quantize", shape, 0.0,
              q.numel() * (2 + 1) + 4 * q.shape[0] * q.shape[2])


# W8A8 at ViT-Base's shapes on the embed rows (M 20,480): the row
# quantisation of x (LN(x), the attention's output: K 768) and of h (the
# GELU output: K 3,072); the products fc1, fc2, q/k/v stacked, o; and
# ragged ones (rows past a tile, K no multiple of 16, N no multiple of 8)
W8A8_GEMMS = {"fc1": (MAIN_N, HIDDEN, FFN), "fc2": (MAIN_N, FFN, HIDDEN),
              "qkv": (MAIN_N, HIDDEN, 3 * HIDDEN), "o": (MAIN_N, HIDDEN,
                                                         HIDDEN),
              "ragged": (1961, HIDDEN, HIDDEN), "ragged K": (193, 100, 44)}


def w8a8_library(x8, sx, w8, sw, bias):
    """The same function by one library product: `torch._int_mm` (cuBLASLt
    s8 x s8 -> s32) of x8 and w8 (K, N), then the dequantisation and the
    bias in plain torch (`w8a8_linear_plain`'s epilogue): the yardstick of
    `library_ms`."""
    import torch

    acc = torch._int_mm(x8, w8)
    y = (acc.float() * (sx[:, None] * sw[None, :])).to(torch.bfloat16)
    return y + bias.to(torch.bfloat16)


def phase_w8a8_kernels(table: dict, gen, dev) -> None:
    """The W8A8 kernels against their plain versions, bit for bit: the row
    quantisation of bf16 x (K 768) and h (K 3,072), of the f32 weights and
    of ragged rows (each with an all-zero row and a row of exact ties);
    the product at every shape of W8A8_GEMMS with a bias,
    on the codes the plain quantisation gives (bf16 out; f32 out at the
    ragged shapes). Timed at fc1 (the GEMM row) and x (the quantisation
    row) beside their plain versions, the product also beside
    `torch._int_mm` with the dequantisation (`w8a8_library`, its
    library_ms) and the bf16 `F.linear` at the same shape, and the other
    shapes logged."""
    import torch
    import torch.nn.functional as F

    from smb_vision_tpu_torch.ops import quant as Q

    def r(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    bf = torch.bfloat16
    for label, x in (("x", r(MAIN_N, HIDDEN, dtype=bf)),
                     ("h", r(MAIN_N, FFN, s=0.2, dtype=bf)),
                     ("w fc1 f32", r(FFN, HIDDEN, s=HIDDEN ** -0.5)),
                     ("ragged 1961 x 100", r(1961, 100, dtype=bf)),
                     ("ragged 193 x 13 f32", r(193, 13))):
        x[min(5, x.shape[0] - 1)] = 0
        # a row of scale 1 whose 0.5, 1.5 and -2.5 are exact ties
        x[min(7, x.shape[0] - 1)] = 0
        x[min(7, x.shape[0] - 1), :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])
        got8, got_s = Q.quantize_rows_kernel(x)
        want8, want_s = Q.quantize_rows_plain(x, Q.padded_k(x.shape[1]))
        same = torch.equal(got8, want8) and torch.equal(got_s, want_s)
        log(f"quantize_rows {label} {tuple(x.shape)} {x.dtype}: bit for bit "
            f"{same}")
        if not same:
            raise AssertionError(f"quantize_rows {label}: not bit for bit")
        if label in ("x", "h"):
            shape = f"{label} M={MAIN_N} K={x.shape[1]}"
            time_kernel(table, "quantize_rows", shape,
                        lambda: Q.quantize_rows_kernel(x),
                        lambda: Q.quantize_rows_plain(x), 20, label == "x")
            if label == "x":
                # one read of x (bf16), one write of the codes and scales
                set_bound(table, "quantize_rows", shape, 0.0,
                          x.numel() * 3 + 4 * x.shape[0])
    for label, (m, k, n) in W8A8_GEMMS.items():
        x = r(m, k, dtype=bf)
        w = r(n, k, s=k ** -0.5)
        bias = r(n, s=0.1)
        x8, sx = Q.quantize_rows_plain(x, Q.padded_k(k))
        w8, sw = Q.quantize_rows_plain(w, Q.padded_k(k))
        outs = [torch.bfloat16] + ([torch.float32] if "ragged" in label
                                   else [])
        for dt in outs:
            got = Q.w8a8_gemm_kernel(x8, sx, w8, sw, bias, dt)
            want = Q.w8a8_linear_plain(x8, sx, w8, sw, bias, dt)
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            log(f"w8a8_gemm {label} M={m} K={k} N={n} {dt}: bit for bit "
                f"{same}")
            if not same:
                raise AssertionError(f"w8a8_gemm {label} {dt}: "
                                     f"{errors(got, want)}")
        if "ragged" in label:
            continue
        shape = f"{label} M={m} K={k} N={n}"
        keep = label == "fc1"
        time_kernel(table, "w8a8_gemm", shape,
                    lambda: Q.w8a8_gemm_kernel(x8, sx, w8, sw, bias),
                    lambda: Q.w8a8_linear_plain(x8, sx, w8, sw, bias), 20,
                    keep)
        # cuBLASLt takes w8^T as the transposed view or, failing that, a
        # copy made here, outside the timing
        wt = w8.t()
        try:
            torch._int_mm(x8, wt)
        except RuntimeError as err:
            log(f"torch._int_mm refuses the transposed view ({err}); it "
                "gets a contiguous copy")
            wt = wt.contiguous()
        lib = cuda_ms(lambda: w8a8_library(x8, sx, wt, sw, bias), iters=10,
                      repeats=KERNEL_REPEATS)
        wb, bb = w.to(bf), bias.to(bf)
        lin = cuda_ms(lambda: F.linear(x, wb, bb), iters=10,
                      repeats=KERNEL_REPEATS)
        same = torch.equal(w8a8_library(x8, sx, wt, sw, bias),
                           Q.w8a8_linear_plain(x8, sx, w8, sw, bias))
        nbytes = m * k + n * k + 2 * m * n + 4 * (m + 2 * n)
        log(f"time w8a8_gemm library {shape}: torch._int_mm + dequant "
            f"{lib:.4f} ms (its result bit for bit the plain one: {same}); "
            f"bf16 F.linear {lin:.4f} ms; bound "
            f"{max(2 * m * k * n / PEAK_INT8, nbytes / HBM_BYTES) * 1e3:.4f} "
            f"ms (CUDA events)")
        if keep:
            table["w8a8_gemm"]["library_ms"] = lib
            set_bound(table, "w8a8_gemm", shape, 0.0, nbytes,
                      int8_ops=2 * m * k * n)
            kernel_split(f"w8a8_gemm {shape}",
                         lambda: Q.w8a8_gemm_kernel(x8, sx, w8, sw, bias))
        del x, w, x8, w8, got, want


def k3_beside_k1(shape: str, q, k, v) -> None:
    """K3 beside K1 on the same inputs, with the exp2 floor the two share:
    through its wrapper, and its kernel alone on the operands that the
    quantisation kernel (R6) gives the wrapper, beside that kernel's time
    and the plain quantisation's."""
    from smb_vision_tpu_torch.ops import attention as A

    scale = 1.0 / math.sqrt(q.shape[-1])
    ops = A.quantize_qk(q, k, scale)
    ms3, alone, ms1, quant, plain = (cuda_ms(
        fn, iters=8, repeats=KERNEL_REPEATS) for fn in (
            lambda: A.flash_attention_int8(q, k, v),
            lambda: A._launch_int8(*ops, v),
            lambda: A.flash_attention(q, k, v),
            lambda: A.quantize_qk(q, k, scale),
            lambda: plain_qk(q, k, scale)))
    log(f"time flash_fwd_i8   {shape}: wrapper {ms3:.3f} ms, kernel alone "
        f"{alone:.3f}; the quantisation of q and k: kernel {quant:.3f}, "
        f"plain {plain:.3f}; K1 on the same inputs {ms1:.3f} ms, exp2 floor "
        f"{exp2_floor_ms(q.shape[1], q.shape[2]):.3f} ms (CUDA events)")


def check_kernel(table: dict, name: str, what: str, out, ref, tol: float,
                 record: bool = True) -> None:
    """Hold a kernel's result against its plain version's: rel =
    max|d| / max|ref| <= tol; record keeps max|d| in the table."""
    import torch

    torch.cuda.synchronize()
    err, rel = errors(out, ref)
    log(f"{name:<14} {what:<30} max|d| {err:.3e}  rel {rel:.3e} "
        f"(bound {tol})")
    if not rel <= tol:
        raise AssertionError(f"{name} {what}: rel {rel} > {tol}")
    if record:
        table[name]["max_abs_err"] = max(table[name]["max_abs_err"], err)


def time_kernel(table: dict, name: str, shape: str, kernel, plain,
                iters: int, keep: bool) -> None:
    """The kernel's and its plain version's time by CUDA events; keep puts
    them in the table."""
    ms = cuda_ms(kernel, iters=iters, repeats=KERNEL_REPEATS)
    plain_ms = cuda_ms(plain, iters=2)
    log(f"time {name:<14} {shape:<30} kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms (CUDA events)")
    if keep:
        table[name]["ms"], table[name]["plain_ms"] = ms, plain_ms


def phase_train_kernels(table: dict, gen, dev) -> None:
    """K4 against its plain backward, K5a and K5b against theirs, at the
    MIM encoder's and decoder's shapes and a ragged one, and K5a, K5b and
    K6 at the V-JEPA encoder's MLP, on the same inputs; times at the MIM
    and V-JEPA shapes (the table keeps the MIM encoder's)."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    check = functools.partial(check_kernel, table)
    timed = functools.partial(time_kernel, table)
    scale = 1.0 / math.sqrt(HEAD_DIM)
    for n, h, label in ((ENC_N, HEADS, "encoder"), (MAIN_N, DEC_HEADS,
                                                    "decoder"),
                        (RAGGED_N, HEADS, "ragged")):
        q, k, v, do = [(torch.randn((1, n, h, HEAD_DIM), generator=gen,
                                    device=dev) * 0.4).to(torch.bfloat16)
                       for _ in range(4)]
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        got = A.flash_attention_bwd(q, k, v, out, lse, do)
        want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=scale)
        for what, a, b in zip(("dq", "dk", "dv"), got, want):
            check("flash_bwd", f"N={n} H={h} {what}", a, b, TOL_FLASH_BWD)
        del got, want
        if label != "ragged":
            timed("flash_bwd", f"{label} N={n} H={h}",
                  lambda: A.flash_attention_bwd(q, k, v, out, lse, do),
                  lambda: A.attention_bwd_plain(q, k, v, out, lse, do,
                                                scale=scale),
                  5, label == "encoder")
        if label == "encoder":
            table["flash_bwd"]["library_ms"] = sdpa_ms(q, k, v, do)
            log(f"time flash_bwd library scaled_dot_product_attention "
                f"backward N={n} H={h}: "
                f"{table['flash_bwd']['library_ms']:.3f} ms")
            set_bound(table, "flash_bwd", f"N={n} H={h}",
                      10 * n * n * HEAD_DIM * h,
                      attn_bytes(1, n, h, HEAD_DIM, 8))
            rate_line(table, "flash_bwd", f"N={n} H={h}",
                      10 * n * n * HEAD_DIM * h)
        del q, k, v, do, out, lse

    for m, kd, f, label in ((ENC_N, HIDDEN, FFN, "encoder"),
                            (MAIN_N, DEC_HIDDEN, DEC_FFN, "decoder"),
                            (RAGGED_N, HIDDEN, FFN, "ragged"),
                            (VJ_N, VJ_HIDDEN, VJ_FFN, "V-JEPA")):
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s

        x = r(m, kd).to(torch.bfloat16)
        w1 = r(f, kd, s=kd ** -0.5).to(torch.bfloat16).t()
        w2 = r(kd, f, s=f ** -0.5).to(torch.bfloat16).t()
        b1, b2 = r(f, s=0.1), r(kd, s=0.1)
        g = r(m, kd).to(torch.bfloat16)
        y, hh = M.mlp_train_fused(x, w1, b1, w2, b2)
        y_ref, h_ref = M._mlp_train_plain(x, w1, b1, w2, b2, "gelu")
        what = f"M={m} K={kd} F={f}"
        check("mlp_train_fwd", what + " y", y, y_ref, TOL_MLP_TRAIN)
        check("mlp_train_fwd", what + " h", hh, h_ref, TOL_MLP_TRAIN)
        got = M.mlp_bwd_fused(hh, g, w1, w2)
        want = M._mlp_bwd_plain(hh, g, w1, w2, "gelu")
        lib = mlp_bwd_chain(hh, g, w1, w2)
        for name, a, b, c in zip(("dx", "dh", "a"), got, want, lib):
            check("mlp_bwd", f"{what} {name}", a, b, TOL_MLP_TRAIN)
            check("mlp_bwd", f"{what} {name} vs chain", a, c, TOL_MLP_TRAIN,
                  record=False)
        del got, want, lib
        if label != "ragged":
            keep = label == "encoder"
            train = functools.partial(M.mlp_train_fused, x, w1, b1, w2, b2)
            plain = functools.partial(M._mlp_train_plain, x, w1, b1, w2, b2,
                                      "gelu")
            chain = functools.partial(mlp_chain, x, w1, b1, w2, b2,
                                      spill=True)
            if keep:
                timed("mlp_train_fwd", f"{label} {what}", train, plain, 20,
                      True)
                mlp_library(table, "mlp_train_fwd", f"{label} {what}", chain)
                set_bound(table, "mlp_train_fwd", what, 4 * m * kd * f,
                          mlp_bytes(m, kd, f, extra_mf=1))
                rate_line(table, "mlp_train_fwd", what, 4 * m * kd * f,
                          "the chain's")
            else:
                mlp_beside_chain("mlp_train_fwd", f"{label} {what}", train,
                                 plain, chain, m, kd, f,
                                 mlp_bytes(m, kd, f, extra_mf=1))
            bwd = functools.partial(M.mlp_bwd_fused, hh, g, w1, w2)
            bwd_plain = functools.partial(M._mlp_bwd_plain, hh, g, w1, w2,
                                          "gelu")
            bwd_chain = functools.partial(mlp_bwd_chain, hh, g, w1, w2)
            if keep:
                timed("mlp_bwd", f"{label} {what}", bwd, bwd_plain, 20, True)
                mlp_library(table, "mlp_bwd", f"{label} {what}", bwd_chain)
                set_bound(table, "mlp_bwd", what, 4 * m * kd * f,
                          mlp_bytes(m, kd, f, extra_mf=3))
                rate_line(table, "mlp_bwd", what, 4 * m * kd * f,
                          "the chain's")
            else:
                mlp_beside_chain("mlp_bwd", f"{label} {what}", bwd,
                                 bwd_plain, bwd_chain, m, kd, f,
                                 mlp_bytes(m, kd, f, extra_mf=3))
            kernel_split(f"mlp_bwd {what}", bwd)
        if label == "V-JEPA":   # the EMA teacher's MLP, and K2 at K 1,024
            check("mlp_fwd", what, M.mlp_fused(x, w1, b1, w2, b2),
                  M._mlp_xla(x, w1, b1, w2, b2, "gelu"), TOL_MLP)
            mlp_beside_chain("mlp_fwd", f"{label} {what}",
                             lambda: M.mlp_fused(x, w1, b1, w2, b2),
                             lambda: M._mlp_xla(x, w1, b1, w2, b2, "gelu"),
                             lambda: mlp_chain(x, w1, b1, w2, b2), m, kd, f,
                             mlp_bytes(m, kd, f))
            lnw, lnb = 1.0 + r(kd, s=0.1), r(kd, s=0.1)
            check("mlp_block_fwd", what,
                  M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, eps=1e-6),
                  M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, "gelu",
                                   1e-6), TOL_MLP)
            mlp_beside_chain(
                "mlp_block_fwd", f"{label} {what}",
                lambda: M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2,
                                          eps=1e-6),
                lambda: M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, "gelu",
                                         1e-6),
                lambda: mlp_chain(x, w1, b1, w2, b2, lnw, lnb, 1e-6), m, kd,
                f, mlp_bytes(m, kd, f, ln=True))


def phase_vjepa_kernels(table: dict, gen, dev) -> None:
    """K7 against its plain version at the V-JEPA shapes: the encoder (8
    heads of 128), the predictor (3 heads of 128), the reference-head
    encoder (16 heads of 64) and ragged N = 1,960 at d 64 and 128 (these
    two with an lse2 cotangent), timed beside its plain version and K4 on
    the same inputs (the table keeps the encoder's times). Then K1 and K3
    at the encoder's shape against theirs, with times."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A

    def qkv(n, h, d, count):
        return [(torch.randn((1, n, h, d), generator=gen, device=dev)
                 * 0.4).to(torch.bfloat16) for _ in range(count)]

    for n, h, d, label in ((VJ_N, 8, 128, "encoder"),
                           (VJ_N, 3, 128, "predictor"),
                           (VJ_N, 16, 64, "reference-head encoder"),
                           (RAGGED_N, 8, 64, "ragged"),
                           (RAGGED_N, 8, 128, "ragged")):
        q, k, v, do = qkv(n, h, d, 4)
        scale = 1.0 / math.sqrt(d)
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        g_lse = (torch.randn((1, h, n), generator=gen, device=dev)
                 if label == "ragged" else None)
        got = A.flash_attention_bwd_i8(q, k, v, out, lse, do, g_lse=g_lse)
        want = A.attention_bwd_i8_plain(q, k, v, out, lse, do, scale=scale,
                                        g_lse=g_lse)
        shape = f"N={n} H={h} d={d}" + (" g_lse" if label == "ragged"
                                         else "")
        for what, a, b in zip(("dq", "dk", "dv"), got, want):
            check_kernel(table, "flash_bwd_i8", f"{shape} {what}", a, b,
                         TOL_FLASH_BWD)
        del got, want
        if label != "ragged":
            ms = cuda_ms(lambda: A.flash_attention_bwd_i8(
                q, k, v, out, lse, do), repeats=KERNEL_REPEATS)
            plain_ms = cuda_ms(lambda: A.attention_bwd_i8_plain(
                q, k, v, out, lse, do, scale=scale), iters=2)
            k4_ms = cuda_ms(lambda: A.flash_attention_bwd(
                q, k, v, out, lse, do), repeats=KERNEL_REPEATS)
            k7_quant(f"{label} {shape}", q, k, v, do, out, lse, ms)
            log(f"time flash_bwd_i8   {label} {shape}: wrapper {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, K4 on the same inputs {k4_ms:.3f} "
                f"ms (CUDA events)")
            if label == "encoder":
                table["flash_bwd_i8"]["ms"] = ms
                table["flash_bwd_i8"]["plain_ms"] = plain_ms
                prod = 2 * n * n * d * h
                set_bound(table, "flash_bwd_i8", shape, 3 * prod,
                          attn_bytes(1, n, h, d, 8), int8_ops=2 * prod)
        del q, k, v, do, out, lse

    q, k, v = qkv(VJ_N, 8, 128, 3)
    scale = 1.0 / math.sqrt(128)
    shape = f"V-JEPA N={VJ_N} H=8 d=128"
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
    check_kernel(table, "flash_fwd", shape, out, ref, TOL_FLASH)
    check_kernel(table, "flash_fwd", shape + " lse2", lse, ref_lse,
                 TOL_FLASH, record=False)
    q8, k8, sq, sk = plain_qk(q, k, scale)
    check_kernel(table, "flash_fwd_i8", shape, A.flash_attention_int8(q, k, v),
                 A.int8_attention_plain(q8, k8, sq, sk, v), TOL_INT8)
    time_kernel(table, "flash_fwd", shape,
                lambda: A.flash_attention(q, k, v),
                lambda: A.xla_attention(q, k, v), 8, False)
    time_kernel(table, "flash_fwd_i8", shape,
                lambda: A.flash_attention_int8(q, k, v),
                lambda: A.int8_attention_plain(*plain_qk(q, k, scale), v), 8,
                False)
    k3_beside_k1(shape, q, k, v)


def k7_quant(shape: str, q, k, v, do, out, lse, wrapper_ms: float) -> None:
    """K7's kernel alone on the operands the quantisation kernel (R6) gives
    its wrapper, beside the wrapper's time and the quantisation's (kernel
    and plain) of q, k, v and do; and the wrapper's host issue time beside
    its device time, which says which of the two sets its time."""
    from smb_vision_tpu_torch.ops import attention as A

    scale = 1.0 / math.sqrt(q.shape[-1])
    w = A._code_width(q.shape[-1], "K7")
    ops = A._i8_operands(q, k, v, do, scale, width=w)
    alone, quant, plain = (cuda_ms(fn, repeats=KERNEL_REPEATS) for fn in (
        lambda: A._launch_bwd_i8(q, k, do, out, lse, ops, scale),
        lambda: A._i8_operands(q, k, v, do, scale, width=w),
        lambda: A._i8_operands(q, k, v, do, scale, A.quantize_per_head,
                               width=w)))
    log(f"time flash_bwd_i8   {shape}: wrapper {wrapper_ms:.3f} ms, kernel "
        f"alone {alone:.3f}; the quantisation of q, k, v, do: kernel "
        f"{quant:.3f}, plain {plain:.3f} (CUDA events)")
    wrapper = functools.partial(A.flash_attention_bwd_i8, q, k, v, out, lse,
                                do)
    device = sum(count * t for _, count, t in device_times(wrapper))
    log(f"time flash_bwd_i8   {shape}: wrapper's host issue "
        f"{host_ms(wrapper):.3f} ms a call, its device time {device:.3f} ms "
        f"a call (profiler)")


def padded_to_64(*ts):
    """Head width 32 zero-padded to 64: the yardstick that the d-64 kernels
    give without a d-32 instantiation (twice the tensor work and a copy of
    each operand). Timed beside the d-32 kernels; the port never runs
    it."""
    import torch.nn.functional as F

    return [F.pad(t, (0, 64 - t.shape[-1])) for t in ts]


def phase_d32_kernels(table: dict, gen, dev) -> None:
    """K1, K4, K7, K3 and K8 at head width 32 against their plain versions:
    the reference-head V-JEPA2 predictor's shape (9,216 tokens, 12 heads
    of 32), ragged N 1,961 and 193, and Nq != Nk both ways (K4 and K7 with
    and without an lse2 cotangent), at the d-64 bounds (K3 and K8 also
    against float32 attention). At the predictor's shape each is timed
    beside its plain version, K1, K4 and K7 also beside SDPA at d 32 (K1;
    K4: its backward), the d-64 kernel on the zero-padded inputs
    (`padded_to_64`), its exp2 floor and its tensor floor (the bound); K3
    and K8 beside K1 d32 and the exp2 floor."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A

    h, d = PRED_HEADS, 32
    scale = 1.0 / math.sqrt(d)

    def r(n):
        return (torch.randn((1, n, h, d), generator=gen, device=dev)
                * 0.4).to(torch.bfloat16)

    bwds = (("flash_bwd d32", A.flash_attention_bwd, A.attention_bwd_plain),
            ("flash_bwd_i8 d32", A.flash_attention_bwd_i8,
             A.attention_bwd_i8_plain))
    for nq, nk in ((VJ_N, VJ_N), (1961, 1961), (193, 193), (1961, 193),
                   (193, 1961)):
        q, do, k, v = r(nq), r(nq), r(nk), r(nk)
        shape = f"Nq={nq} Nk={nk} H={h} d={d}"
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
        check_kernel(table, "flash_fwd d32", shape, out, ref, TOL_FLASH)
        check_kernel(table, "flash_fwd d32", shape + " lse2", lse, ref_lse,
                     TOL_FLASH, record=False)
        cots = (None, torch.randn((1, h, nq), generator=gen, device=dev)) \
            if nq != nk else (None,)
        for g_lse in cots:
            tag = shape + ("" if g_lse is None else " g_lse")
            for name, kernel, plain in bwds:
                got = kernel(q, k, v, out, lse, do, g_lse=g_lse)
                want = plain(q, k, v, out, lse, do, scale=scale, g_lse=g_lse)
                for what, a, b in zip(("dq", "dk", "dv"), got, want):
                    check_kernel(table, name, f"{tag} {what}", a, b,
                                 TOL_FLASH_BWD)
                del got, want
        # K3 and K8 at d 32 against their plain versions on the plain
        # quantisation, and against float32 attention
        q8, k8, sq, sk = plain_qk(q, k, scale)
        v8, sv = A.quantize_per_head(v)
        ref32 = A.xla_attention(q.float(), k.float(), v.float())
        for name, fn, plain, f32_tol in (
                ("flash_fwd_i8 d32", A.flash_attention_int8,
                 lambda: A.int8_attention_plain(q8, k8, sq, sk, v),
                 TOL_INT8_F32),
                ("flash_fwd_i8pv d32", A.flash_attention_int8pv,
                 lambda: A.int8pv_attention_plain(q8, k8, sq, sk, v8, sv),
                 TOL_INT8PV_F32)):
            out8 = fn(q, k, v)
            check_kernel(table, name, shape, out8, plain(), TOL_INT8)
            check_kernel(table, name, shape + " vs f32", out8, ref32,
                         f32_tol, record=False)
        del q8, k8, v8, out8, ref32
        if nq == VJ_N:
            d32_times(table, q, k, v, do, out, lse)
        del q, k, v, do, out, lse, ref, ref_lse


def d32_times(table: dict, q, k, v, do, out, lse) -> None:
    """The d-32 rows' times at the predictor's shape (see
    `phase_d32_kernels`)."""
    from smb_vision_tpu_torch.ops import attention as A

    n, h, d = q.shape[1], q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    shape = f"predictor N={n} H={h} d={d}"
    qp, kp, vp, dop, outp = padded_to_64(q, k, v, do, out)
    ref = A.xla_attention(q, k, v)
    check_kernel(table, "flash_fwd d32", shape + " padded d64 yardstick",
                 A.flash_attention(qp, kp, vp, scale=scale)[..., :d], ref,
                 TOL_FLASH, record=False)
    exp2 = exp2_floor_ms(n, h)
    prod = 2 * n * n * d * h
    runs = {
        "flash_fwd d32": (lambda: A.flash_attention(q, k, v),
                          lambda: A.xla_attention(q, k, v),
                          lambda: A.flash_attention(qp, kp, vp, scale=scale),
                          lambda: A.flash_attention(
                              *padded_to_64(q, k, v), scale=scale)),
        "flash_bwd d32": (
            lambda: A.flash_attention_bwd(q, k, v, out, lse, do),
            lambda: A.attention_bwd_plain(q, k, v, out, lse, do,
                                          scale=scale),
            lambda: A.flash_attention_bwd(qp, kp, vp, outp, lse, dop,
                                          scale=scale),
            lambda: A.flash_attention_bwd(
                *padded_to_64(q, k, v, out), lse, *padded_to_64(do),
                scale=scale)),
        "flash_bwd_i8 d32": (
            lambda: A.flash_attention_bwd_i8(q, k, v, out, lse, do),
            lambda: A.attention_bwd_i8_plain(q, k, v, out, lse, do,
                                             scale=scale),
            lambda: A.flash_attention_bwd_i8(qp, kp, vp, outp, lse, dop,
                                             scale=scale),
            lambda: A.flash_attention_bwd_i8(
                *padded_to_64(q, k, v, out), lse, *padded_to_64(do),
                scale=scale)),
    }
    for name, (kernel, plain, pad, pad_copy) in runs.items():
        time_kernel(table, name, shape, kernel, plain, 10, True)
        pad_ms, pad_copy_ms = (cuda_ms(fn, iters=10,
                                       repeats=KERNEL_REPEATS)
                               for fn in (pad, pad_copy))
        log(f"time {name:<16} {shape}: d-64 kernel on zero-padded inputs "
            f"{pad_ms:.3f} ms, with the padding copies {pad_copy_ms:.3f} "
            f"ms; native d 32 {table[name]['ms']:.3f} ms "
            f"({pad_ms / table[name]['ms']:.2f}x) (CUDA events)")
    table["flash_fwd d32"]["library_ms"] = sdpa_ms(q, k, v)
    table["flash_bwd d32"]["library_ms"] = sdpa_ms(q, k, v, do)
    nb = attn_bytes(1, n, h, d, 4)
    set_bound(table, "flash_fwd d32", shape, 2 * prod, nb)
    set_bound(table, "flash_bwd d32", shape, 5 * prod,
              attn_bytes(1, n, h, d, 8))
    set_bound(table, "flash_bwd_i8 d32", shape, 3 * prod,
              attn_bytes(1, n, h, d, 8), int8_ops=2 * prod)
    rate_line(table, "flash_fwd d32", shape, 2 * prod)
    rate_line(table, "flash_bwd d32", shape, 5 * prod)
    k7_quant(f"d32 {shape}", q, k, v, do, out, lse,
             table["flash_bwd_i8 d32"]["ms"])
    # K3 and K8 at d 32 (through their wrappers, the quantisation kernel
    # included) beside K1 d32: the exp2 floor bounds all three
    for name, kernel, plain in (
            ("flash_fwd_i8 d32", lambda: A.flash_attention_int8(q, k, v),
             lambda: A.int8_attention_plain(*plain_qk(q, k, scale), v)),
            ("flash_fwd_i8pv d32", lambda: A.flash_attention_int8pv(q, k, v),
             lambda: A.int8pv_attention_plain(*plain_qk(q, k, scale),
                                              *A.quantize_per_head(v)))):
        time_kernel(table, name, shape, kernel, plain, 10, True)
        log(f"time {name} {shape}: {table[name]['ms']:.3f} ms beside K1 "
            f"d32 {table['flash_fwd d32']['ms']:.3f} ms and the exp2 floor "
            f"{exp2:.3f} ms")
    set_bound(table, "flash_fwd_i8 d32", shape, prod, nb, int8_ops=prod)
    set_bound(table, "flash_fwd_i8pv d32", shape, 0.0, nb,
              int8_ops=2 * prod)
    # at d 32 a score costs 4 d = 128 flops of the forward's tensor work
    # against one exp2, so the exp2 floor is about twice the tensor floor;
    # each backward pass recomputes p, two exp2 floors
    log(f"exp2 floor d32 {shape}: forward {exp2:.3f} ms beside its tensor "
        f"floor {table['flash_fwd d32']['bound_ms']:.3f} ms; backward (two "
        f"passes) {2 * exp2:.3f} ms beside K4's tensor floor "
        f"{table['flash_bwd d32']['bound_ms']:.3f} ms and K7's "
        f"{table['flash_bwd_i8 d32']['bound_ms']:.3f} ms")


def phase_d32_int8_path(table: dict) -> None:
    """K3 and K8 at head width 32 on a model's path: the reference-head
    V-JEPA2 model (configs/vjepa_large_384.json at full width: the ViT-L
    encoder at 16 heads of 64, cut to REF_LAYERS of its 24 layers, and the
    predictor, 12 layers of 12 heads of 32), its forward under inference
    on one seeded clip at 384^2 x 256 as a user calls it
    (`VJEPA2Model.forward` without masks: the predictor over every token),
    with attn_impl "pallas_int8" (K3) and then "pallas_int8pv" (K8), the
    counts set to 0 before each: the kernel must launch 12 times at d 32
    (the predictor's layers) and REF_LAYERS times at d 64 (the
    encoder's), the plain attention never; each predictor output within
    TOL_MODEL of the same model on the plain versions (`plain_kernels`).
    The d-32 rows' launches are these runs'."""
    import torch

    from smb_vision_tpu_torch.models.vjepa import VJEPA2Model

    dev = torch.device("cuda")
    cfg, _ = vjepa_ref_config(num_hidden_layers=REF_LAYERS)
    model = VJEPA2Model(cfg).init_weights(
        torch.Generator().manual_seed(0)).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(4)
    px = torch.rand((1, cfg.frames_per_clip, 1, cfg.crop_size,
                     cfg.crop_size), generator=gen, device=dev)
    for impl, name in (("pallas_int8", "flash_fwd_i8"),
                       ("pallas_int8pv", "flash_fwd_i8pv")):
        for mod in model.modules():
            if hasattr(mod, "attn_impl"):
                mod.attn_impl = impl
        ws = reset_launches()
        with torch.inference_mode(), plain_attention_calls() as calls:
            out = model(px)["predictor_output"].float()
        torch.cuda.synchronize()
        by_width = dict(ws[name].launches_by_width)
        with torch.inference_mode(), plain_kernels():
            ref = model(px)["predictor_output"].float()
        err, rel = errors(out, ref)
        log(f"reference-head V-JEPA2 forward, {impl}: {name} launches by "
            f"head width {by_width}, plain attention calls {calls}; "
            f"predictor output {tuple(out.shape)} vs the plain versions: "
            f"max|d| {err:.3e} rel {rel:.3e} (bound {TOL_MODEL})")
        if by_width != {32: cfg.pred_num_hidden_layers,
                        64: cfg.num_hidden_layers} or calls:
            raise AssertionError(f"{impl}: launches {by_width}, plain "
                                 f"attention {calls}")
        if not bool(out.isfinite().all()) or not rel <= TOL_MODEL:
            raise AssertionError(f"{impl}: predictor output rel {rel}")
        table[f"{name} d32"]["launches"] = by_width[32]
    del model


def phase_width_kernels(table: dict, gen, dev) -> None:
    """The forward family past the instantiations' widths. K1 (out and
    lse2), K3 and K8 at head width 72 at SigLIP so400m's shape (batch 32,
    729 tokens, 16 heads) and at head width 80 at the ViT-H VideoMAE's
    (MAIN_N tokens, 16 heads), each against its plain version on the same
    inputs and codes (K3 and K8 also against float32 attention) and timed
    beside it, K1 also beside SDPA and the exp2 floor, K3 also alone and
    beside K1 and its quantisation (`k3_beside_k1`); R6 writing q's codes
    at width 96 (K3's) and 128 (K8's) for heads of 80, bit for bit the
    plain padded codes, timed beside the plain pass; K2 and K6 at M MAIN_N, K
    1,280, F 5,120 against their plain versions, timed beside them and the
    cuBLAS chain `mlp_chain`. The rows keep these times and bounds; their
    launches are the legs'."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    for b, n, d in ((SIGLIP_BATCH, SO400M_N, 72), (1, MAIN_N, VIT_H_D)):
        h = VIT_H_HEADS
        q, k, v = [(torch.randn((b, n, h, d), generator=gen, device=dev)
                    * 0.4).to(torch.bfloat16) for _ in range(3)]
        shape = f"B={b} N={n} H={h} d={d}"
        scale = 1.0 / math.sqrt(d)
        r1, r3, r8 = (f"{name} d{d}" for name in (
            "flash_fwd", "flash_fwd_i8", "flash_fwd_i8pv"))
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        ref, ref_lse = A.xla_attention(q, k, v, with_lse=True)
        check_kernel(table, r1, shape, out, ref, TOL_FLASH)
        check_kernel(table, r1, shape + " lse2", lse, ref_lse, TOL_FLASH,
                     record=False)
        del out, lse, ref_lse
        v8, sv = A.quantize_per_head(v)
        ref32 = A.xla_attention(q.float(), k.float(), v.float())
        plain3 = functools.partial(A.int8_attention_plain,
                                   *plain_qk(q, k, scale), v)
        plain8 = functools.partial(A.int8pv_attention_plain,
                                   *plain_qk(q, k, scale, "K8"), v8, sv)
        for name, fn, plain, f32_tol in (
                (r3, A.flash_attention_int8, plain3, TOL_INT8_F32),
                (r8, A.flash_attention_int8pv, plain8, TOL_INT8PV_F32)):
            got = fn(q, k, v)
            check_kernel(table, name, shape, got, plain(), TOL_INT8)
            check_kernel(table, name, shape + " vs f32", got, ref32,
                         f32_tol, record=False)
            del got
        del ref32
        time_kernel(table, r1, shape, lambda: A.flash_attention(q, k, v),
                    lambda: A.xla_attention(q, k, v), 8, True)
        time_kernel(table, r3, shape, lambda: A.flash_attention_int8(q, k, v),
                    lambda: A.int8_attention_plain(*plain_qk(q, k, scale), v),
                    8, True)
        time_kernel(table, r8, shape,
                    lambda: A.flash_attention_int8pv(q, k, v),
                    lambda: A.int8pv_attention_plain(
                        *plain_qk(q, k, scale, "K8"),
                        *A.quantize_per_head(v)), 8, True)
        k3_beside_k1(shape, q, k, v)
        table[r1]["library_ms"] = sdpa_ms(q, k, v)
        log(f"time {r1} library F.scaled_dot_product_attention {shape}: "
            f"{table[r1]['library_ms']:.3f} ms")
        pv = 2 * b * h * n * n * d
        nb = attn_bytes(b, n, h, d, 4)
        set_bound(table, r1, shape, 2 * pv, nb)
        set_bound(table, r3, shape, pv, nb - b * h * n * 4, int8_ops=pv)
        set_bound(table, r8, shape, 0.0, nb - b * h * n * 4,
                  int8_ops=2 * pv)
        rate_line(table, r1, shape, 2 * pv)
        log(f"exp2 floor {r1} {shape}: {exp2_floor_ms(n, b * h):.3f} ms "
            f"beside the tensor floor {table[r1]['bound_ms']:.3f} ms; the "
            f"instantiations' tiles do {tile_work(d, 'K1')} (K1, K3), "
            f"{tile_work(d, 'K8')} (K8) the tensor work of width {d}")
        if d == VIT_H_D:
            quant_padded(table, q, scale * LOG2E)
        del q, k, v, v8, plain3, plain8
    torch.cuda.empty_cache()

    m, kd, f = MAIN_N, VIT_H_K, VIT_H_F
    x, lnw, lnb, w1, b1, w2, b2 = _mlp_inputs(m, gen, dev, k=kd, f=f)
    shape, eps = f"M={m} K={kd} F={f}", 1e-12
    kernels = {
        "mlp_block_fwd K1280": (
            lambda: M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, eps=eps),
            lambda: M._mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, "gelu",
                                     eps),
            lambda: mlp_chain(x, w1, b1, w2, b2, lnw, lnb, eps), True),
        "mlp_fwd K1280": (
            lambda: M.mlp_fused(x, w1, b1, w2, b2),
            lambda: M._mlp_xla(x, w1, b1, w2, b2, "gelu"),
            lambda: mlp_chain(x, w1, b1, w2, b2), False)}
    for name, (kernel, plain, chain, ln) in kernels.items():
        check_kernel(table, name, shape, kernel(), plain(), TOL_MLP)
        time_kernel(table, name, shape, kernel, plain, 20, True)
        mlp_library(table, name, shape, chain)
        set_bound(table, name, shape, 4 * m * kd * f,
                  mlp_bytes(m, kd, f, ln=ln))
        rate_line(table, name, shape, 4 * m * kd * f, "the chain's")
    del x, w1, w2


def quant_padded(table: dict, q, mult: float) -> None:
    """R6 at a head width below its instantiation's (the "quantize d80"
    row): q's codes at K3's code width (96), zeros past d, bit for bit the
    plain padded codes (`quantize_per_head` with width); at K8's (128) the
    same in the input's layout and in K8's (`quantize_v_kernel_layout`);
    timed at K3's width, whose launches the row keeps, beside the plain
    pass; its bound, one read of q and one write of the padded codes."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A

    b, n, h, d = q.shape
    w, w8 = A._code_width(d, "K3"), A._code_width(d, "K8")
    name, shape = "quantize d80", f"B={b} N={n} H={h} d={d} -> {w}"
    want8, want_s = A.quantize_per_head(q, mult, width=w)
    x8, s = A.quantize_per_head_kernel(q, mult, width=w)
    want128, _ = A.quantize_per_head(q, mult, width=w8)
    x128, s128 = A.quantize_per_head_kernel(q, mult, width=w8)
    vt, sv = A.quantize_per_head_kernel(q, mult, v_layout=True, width=w8)
    torch.cuda.synchronize()
    same = (torch.equal(x8, want8) and torch.equal(s, want_s)
            and torch.equal(x128, want128) and torch.equal(s128, want_s)
            and torch.equal(sv, want_s)
            and torch.equal(vt, A.quantize_v_kernel_layout(want128)))
    log(f"{name:<14} {shape}: codes and scales bit for bit the plain "
        f"padded pass in both layouts: {same}; zeros past d: "
        f"{not bool(x8[..., d:].any())}")
    if not same or bool(x8[..., d:].any()):
        raise AssertionError(f"{name}: the padded codes differ from the "
                             "plain pass")
    time_kernel(table, name, shape,
                lambda: A.quantize_per_head_kernel(q, mult, width=w),
                lambda: A.quantize_per_head(q, mult, width=w), 20, True)
    set_bound(table, name, shape, 0.0, b * n * h * (2 * d + w) + b * h * 4)


# K5a and K5b past K 1,024: (K, M, F) at ViT-H's MIM encoder and at the
# V-JEPA2 encoder's rows with ViT-g's widths
TRAIN_WIDTH_MLPS = ((VIT_H_K, ENC_N, VIT_H_F), (1408, VJ_N, 6144))


def phase_train_width_kernels(table: dict, gen, dev) -> None:
    """The training family past the instantiations' widths. K4 and K7 at
    head width 72 (SigLIP so400m's shape: batch 32, 729 tokens, 16 heads),
    80 (K4 at the ViT-H MIM encoder's 7,168 tokens, K7 at the V-JEPA2
    ViT-H encoder's 9,216, 16 heads) and 100 (padded to 104 by the
    wrapper; batch 2, ragged N 1,960, 4 heads, with an lse2 cotangent)
    against their plain versions (TOL_FLASH_BWD, their existing card
    check's), timed beside them, K4 beside SDPA's backward and K7 beside
    K4 on the same inputs with its quantisation's time; K5a (y and h) and
    K5b (dx, dh, a) at K 1,280 (M 7,168, F 5,120) and 1,408 (M 9,216, F
    6,144) against their plain versions (TOL_MLP_TRAIN), timed beside them
    and their cuBLAS chains. The rows keep these times and bounds; their
    launches are legs X's and Y's."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    # (row, batch, N, heads, d), each K4 / K7 row at its shape; K7 d100 is
    # held at the d-100 shape without a row of its own
    rows = (("flash_bwd d72", SIGLIP_BATCH, SO400M_N, 16, 72),
            ("flash_bwd_i8 d72", SIGLIP_BATCH, SO400M_N, 16, 72),
            ("flash_bwd d80", 1, ENC_N, VIT_H_HEADS, VIT_H_D),
            ("flash_bwd_i8 d80", 1, VJ_N, VIT_H_HEADS, VIT_H_D),
            ("flash_bwd d100", 2, RAGGED_N, 4, 100))
    for row, b, n, h, d in rows:
        q, k, v, do = [(torch.randn((b, n, h, d), generator=gen, device=dev)
                        * 0.4).to(torch.bfloat16) for _ in range(4)]
        g_lse = (torch.randn((b, h, n), generator=gen, device=dev) * 0.1
                 if d == 100 else None)
        scale = 1.0 / math.sqrt(d)
        shape = f"B={b} N={n} H={h} d={d}" + (" g_lse" if d == 100 else "")
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        pairs = ((A.flash_attention_bwd, A.attention_bwd_plain, row),)
        if d == 100:
            pairs += ((A.flash_attention_bwd_i8, A.attention_bwd_i8_plain,
                       "flash_bwd_i8 d100"),)
        elif "_i8" in row:
            pairs = ((A.flash_attention_bwd_i8, A.attention_bwd_i8_plain,
                      row),)
        for kernel, plain, name in pairs:
            got = kernel(q, k, v, out, lse, do, g_lse=g_lse)
            want = plain(q, k, v, out, lse, do, scale=scale, g_lse=g_lse)
            for what, a, c in zip(("dq", "dk", "dv"), got, want):
                if a.shape != q.shape:
                    raise AssertionError(f"{name}: {what} {tuple(a.shape)}")
                check_kernel(table, row, f"{name} {shape} {what}", a, c,
                             TOL_FLASH_BWD, record=name == row)
            del got, want
        kernel, plain, _ = pairs[0]
        time_kernel(table, row, shape,
                    lambda: kernel(q, k, v, out, lse, do),
                    lambda: plain(q, k, v, out, lse, do, scale=scale), 5,
                    True)
        prod = 2 * b * n * n * d * h
        nbytes = attn_bytes(b, n, h, d, 8)
        if kernel is A.flash_attention_bwd:
            table[row]["library_ms"] = sdpa_ms(q, k, v, do)
            log(f"time {row} library scaled_dot_product_attention "
                f"backward {shape}: {table[row]['library_ms']:.3f} ms")
            set_bound(table, row, shape, 5 * prod, nbytes)
            rate_line(table, row, shape, 5 * prod)
        else:
            k4_ms = cuda_ms(lambda: A.flash_attention_bwd(q, k, v, out, lse,
                                                          do),
                            repeats=KERNEL_REPEATS)
            log(f"time {row} {shape}: K4 on the same inputs {k4_ms:.3f} ms "
                f"(CUDA events)")
            k7_quant(shape, q, k, v, do, out, lse, table[row]["ms"])
            set_bound(table, row, shape, 3 * prod, nbytes,
                      int8_ops=2 * prod)
        log(f"rate {row} {shape}: the instantiation's tiles do "
            f"{tile_work(d, 'K7' if '_i8' in row else 'K4')} the tensor "
            f"work of width {d}")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()

    for kd, m, f in TRAIN_WIDTH_MLPS:
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s

        x, g = r(m, kd).to(torch.bfloat16), r(m, kd).to(torch.bfloat16)
        w1 = r(f, kd, s=kd ** -0.5).to(torch.bfloat16).t()
        w2 = r(kd, f, s=f ** -0.5).to(torch.bfloat16).t()
        b1, b2 = r(f, s=0.1), r(kd, s=0.1)
        shape = f"M={m} K={kd} F={f}"
        fwd, bwd = f"mlp_train_fwd K{kd}", f"mlp_bwd K{kd}"
        y, hh = M.mlp_train_fused(x, w1, b1, w2, b2)
        y_ref, h_ref = M._mlp_train_plain(x, w1, b1, w2, b2, "gelu")
        check_kernel(table, fwd, shape + " y", y, y_ref, TOL_MLP_TRAIN)
        check_kernel(table, fwd, shape + " h", hh, h_ref, TOL_MLP_TRAIN)
        got = M.mlp_bwd_fused(hh, g, w1, w2)
        want = M._mlp_bwd_plain(hh, g, w1, w2, "gelu")
        for what, a, c in zip(("dx", "dh", "a"), got, want):
            check_kernel(table, bwd, f"{shape} {what}", a, c, TOL_MLP_TRAIN)
        del y, y_ref, h_ref, got, want
        for name, kernel, plain, chain, extra in (
                (fwd, functools.partial(M.mlp_train_fused, x, w1, b1, w2,
                                        b2),
                 functools.partial(M._mlp_train_plain, x, w1, b1, w2, b2,
                                   "gelu"),
                 functools.partial(mlp_chain, x, w1, b1, w2, b2,
                                   spill=True), 1),
                (bwd, functools.partial(M.mlp_bwd_fused, hh, g, w1, w2),
                 functools.partial(M._mlp_bwd_plain, hh, g, w1, w2, "gelu"),
                 functools.partial(mlp_bwd_chain, hh, g, w1, w2), 3)):
            time_kernel(table, name, shape, kernel, plain, 20, True)
            mlp_library(table, name, shape, chain)
            set_bound(table, name, shape, 4 * m * kd * f,
                      mlp_bytes(m, kd, f, extra_mf=extra))
            rate_line(table, name, shape, 4 * m * kd * f, "the chain's")
        del x, g, w1, w2, hh
        torch.cuda.empty_cache()


VOL_SHAPE = (256, 256, 160)    # int16 HU at spacing (3, 3, 6) mm: the
VOL_SPACING = (3.0, 3.0, 6.0)  # smb-vision spacing (1.5, 1.5, 3) makes it
N_VOLUMES = 4                  # exactly 512 x 512 x 320


def write_volumes(root: Path) -> Path:
    """N_VOLUMES seeded synthetic CT volumes as uncompressed NIfTI."""
    import numpy as np

    from smb_vision_tpu_torch.data.nifti import save_nifti

    vols = root / "volumes"
    vols.mkdir(parents=True)
    rng = np.random.default_rng(0)
    affine = np.diag([*VOL_SPACING, 1.0])
    for i in range(N_VOLUMES):
        hu = rng.normal(-200.0, 400.0, VOL_SHAPE).clip(-1024, 3000)
        save_nifti(vols / f"ct_{i}.nii", hu.astype(np.int16), affine)
    return vols


def vit_base_config(root: Path, name: str, mlp_impl: str,
                    glue_impl: str = "auto") -> Path:
    """ViT-Base VideoMAE at 512^2 x 320, bf16 (the bench.py encoder)."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    cfg = VideoMAEConfig(image_size=512, num_frames=320, patch_size=16,
                         tubelet_size=16, hidden_size=HIDDEN,
                         num_hidden_layers=12, num_attention_heads=HEADS,
                         intermediate_size=FFN, dtype="bfloat16",
                         mlp_impl=mlp_impl, glue_impl=glue_impl)
    path = root / f"{name}.json"
    cfg.save_json(str(path))
    return path


def run_leg(root: Path, vols: Path, leg: str, cfg: Path, extra: list,
            kernels: tuple, table: dict, hidden: int = HIDDEN) -> Path:
    """One run_inference over the volumes; asserts the outputs (MAIN_N
    tokens of `hidden` a volume) and that the leg's kernels launched.
    Returns the output directory and the launch counts of the run."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_inference import main as run_inference

    out = root / f"emb_{leg}"
    ws = reset_launches()
    t0 = time.perf_counter()
    stats = run_inference([
        "--data_dir", str(vols), "--output_dir", str(out),
        "--config_path", str(cfg), "--batch_size", "2", "--device", "cuda",
        "--num_workers", "2", *extra])
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    log(f"leg {leg}: {stats} in {wall:.1f} s (decode + preprocess + "
        f"encode + write); launches {counts}")
    if stats != {"embedded": N_VOLUMES, "failed": 0, "skipped": 0}:
        raise AssertionError(f"leg {leg}: {stats}")
    npys = sorted(out.glob("*.npy"))
    if len(npys) != N_VOLUMES or not (out / "metadata.json").exists():
        raise AssertionError(f"leg {leg}: {len(npys)} npy files, "
                             f"metadata.json present: "
                             f"{(out / 'metadata.json').exists()}")
    for f in npys:
        emb = np.load(f)
        if emb.shape != (MAIN_N, hidden) or not np.isfinite(emb).all():
            raise AssertionError(f"{f.name}: shape {emb.shape}, finite "
                                 f"{bool(np.isfinite(emb).all())}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"leg {leg}: kernel {name} never launched")
        table[name]["launches"] = counts[name]
    return out, counts


def vit_h_config(root: Path, name: str, mlp_impl: str) -> Path:
    """The VideoMAE at ViT-H widths (VIT_H) at 512^2 x 320, bf16, as
    `vit_base_config` writes ViT-Base, the encoder cut to
    VIT_H_LEG_LAYERS."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    cfg = VideoMAEConfig(image_size=512, num_frames=320, patch_size=16,
                         tubelet_size=16, dtype="bfloat16",
                         mlp_impl=mlp_impl, **{
                             **VIT_H, "num_hidden_layers": VIT_H_LEG_LAYERS})
    path = root / f"{name}.json"
    cfg.save_json(str(path))
    return path


def width_launches(ws: dict, name: str, d: int) -> int:
    """The launches of wrapper `name` at head width d."""
    return ws[name].launches_by_width.get(d, 0)


def run_vit_h_legs(work: Path, vols: Path, table: dict) -> None:
    """Legs N, T and U: run_inference on the 4 volumes with the VideoMAE
    at ViT-H widths (VIT_H; the CLI initialises the weights from --seed 0
    on the host's CPU), batch 2, in
    the three configurations of VIT_H_LEGS: N "auto" (K1 at d 80, K2 at K
    1,280), T --attn_impl pallas_int8 with mlp_impl pallas_bwd (K3 at d 80
    on R6's codes at width 96, K6 at K 1,280), U --attn_impl
    pallas_int8pv (K8 at d 80, K2). Each kernel launches once a layer and
    batch (R6 twice, for q and k, under K3, three times under K8), the
    plain attention never; the rows of WIDTH_ROWS take these launches."""
    layers = VIT_H_LEG_LAYERS
    want = layers * N_VOLUMES // 2
    for leg, mlp_impl, attn, fn, mlp in VIT_H_LEGS:
        cfg = vit_h_config(work, f"leg_{leg.lower()}", mlp_impl)
        # no kernels named to run_leg: the ViT-Base rows keep legs A's, B's
        # and G's launches; the d-80 and K-1280 rows take these below
        with plain_attention_calls() as plain:
            out, counts = run_leg(work, vols, leg, cfg,
                                  ["--attn_impl", attn], (), table,
                                  VIT_H["hidden_size"])
        ws = wrappers()
        at80 = width_launches(ws, fn, VIT_H_D)
        quant = {"flash_fwd": 0, "flash_fwd_i8": 2, "flash_fwd_i8pv": 3}[fn]
        others = [n for n in ("flash_fwd", "flash_fwd_i8", "flash_fwd_i8pv",
                              "mlp_block_fwd", "mlp_fwd")
                  if n not in (fn, mlp) and counts[n]]
        log(f"leg {leg}: ViT-H widths, {layers} layers, attn "
            f"{attn}, mlp {mlp_impl}: {fn} at d {VIT_H_D} {at80}, {mlp} "
            f"{counts[mlp]}, quantisation {counts['quantize']} (want {want}, "
            f"{want}, {quant * want}); plain attention calls {plain}")
        if at80 != want or counts[mlp] != want or others or plain \
                or counts["quantize"] != quant * want:
            raise AssertionError(f"leg {leg}: launches {counts}, d 80 "
                                 f"{at80}, plain attention {plain}")
        table[f"{fn} d{VIT_H_D}"]["launches"] = at80
        table[f"{mlp} K{VIT_H_K}"]["launches"] = max(
            table[f"{mlp} K{VIT_H_K}"]["launches"], counts[mlp])
        if fn == "flash_fwd_i8":
            table["quantize d80"]["launches"] = counts["quantize"]
        shutil.rmtree(out)


def seeded_vit_h(dev, layers: int, **kw):
    """The VideoMAE at ViT-H widths on dev, bf16 unless kw says otherwise,
    in eval mode, with weights of seed 0 initialised on the card (a CPU
    initialisation of 0.63 B parameters takes most of a minute); the same
    seed gives the same weights at any depth's first layers."""
    import torch

    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    kw.setdefault("dtype", "bfloat16")
    cfg = VideoMAEConfig(image_size=512, num_frames=320, patch_size=16,
                         tubelet_size=16,
                         **{**VIT_H, "num_hidden_layers": layers}, **kw)
    with torch.device(dev):
        model = VideoMAEModel(cfg).to(dev)
    return model.init_weights(torch.Generator(device=dev).manual_seed(0)
                              ).eval()


def set_impls(model, attn_impl: str, mlp_impl: str) -> None:
    """Switch a built model's attention and MLP routes in place."""
    for mod in model.modules():
        if hasattr(mod, "attn_impl"):
            mod.attn_impl = attn_impl
        if hasattr(mod, "mlp_impl"):
            mod.mlp_impl = mlp_impl


def phase_vit_h(vols: Path, card: str) -> None:
    """The VideoMAE at ViT-H widths. Parity: one volume (ct_0,
    preprocessed as run_inference does) through VIT_H_PARITY_LAYERS layers
    in each configuration of VIT_H_LEGS, the kernels against the same
    model on their plain versions under the same impl names
    (`plain_kernels`), and against float32 (attn and mlp "xla"): PERF.md
    section 2's forward rule, TOL_MODEL of max and TOL_MODEL_VS_F32 times
    the plain path's distance from float32; each kernel launches once a
    layer. Then volumes/s at full depth (32 layers), batch 2, in each
    configuration: CUDA events over 3 seeded batches after one warm-up."""
    import torch

    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import CT_PIPELINES

    dev = torch.device("cuda")
    pipe = CT_PIPELINES["smb-vision"]
    pipe = type(pipe)(pipe.target_spacing, (512, 512, 320))
    ds = CTDataset(items=[{"image": str(sorted(vols.glob("*.nii"))[0])}],
                   pipeline=pipe, device=dev)
    px = torch.from_numpy(ds[0]["image"][None]).to(dev)
    layers = VIT_H_PARITY_LAYERS
    with torch.inference_mode():
        ref32 = seeded_vit_h(dev, layers, dtype="float32", attn_impl="xla",
                             mlp_impl="xla")(px)[0]
        model = seeded_vit_h(dev, layers)
        for leg, mlp_impl, attn, fn, mlp in VIT_H_LEGS:
            set_impls(model, attn, mlp_impl)
            ws = reset_launches()
            out = model(px)[0].float()
            torch.cuda.synchronize()
            counts = {n: ws[n].launches for n in (fn, mlp)}
            counts[f"{fn} d{VIT_H_D}"] = width_launches(ws, fn, VIT_H_D)
            with plain_kernels():
                ref = model(px)[0].float()
            _, rel = errors(out, ref)
            kern32, plain32 = errors(out, ref32)[1], errors(ref, ref32)[1]
            log(f"ViT-H widths, {layers} of 32 layers, attn {attn}, mlp "
                f"{mlp_impl} (leg {leg}'s): kernels vs their plain versions "
                f"rel {rel:.3e} (bound {TOL_MODEL}); vs float32: kernels "
                f"{kern32:.3e}, plain versions {plain32:.3e} (bound "
                f"{TOL_MODEL_VS_F32} x plain); launches {counts}")
            if any(c != layers for c in counts.values()):
                raise AssertionError(f"ViT-H {attn}: launches {counts}")
            if not rel <= TOL_MODEL or not kern32 <= TOL_MODEL_VS_F32 \
                    * plain32:
                raise AssertionError(f"ViT-H {attn}: rel {rel}, vs float32 "
                                     f"{kern32} against {plain32}")
            del out, ref
    del model, ref32, ds, px
    torch.cuda.empty_cache()

    batch, iters = 2, 3
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand((batch, 320, 1, 512, 512), generator=gen,
                          device=dev).to(torch.bfloat16)
               for _ in range(iters + 1)]
    model = seeded_vit_h(dev, VIT_H["num_hidden_layers"])
    for leg, mlp_impl, attn, fn, mlp in VIT_H_LEGS:
        set_impls(model, attn, mlp_impl)
        with torch.inference_mode():
            model(batches[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for x in batches[1:]:
                model(x)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / iters
        log(f"throughput ViT-H {attn} + {mlp_impl} (leg {leg}'s): "
            f"{batch * 1e3 / ms:.3f} volumes/s ({ms:.1f} ms a batch of "
            f"{batch}, 512x512x320, 32 layers of 16 x 80, encoder only, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB) on "
            f"{card}")
    del model, batches
    torch.cuda.empty_cache()


def phase_native_loader(vols: Path) -> None:
    """The preprocessing of the 4 volumes to 512^2 x 320, no cache on
    either side: the native C++ loader (`native_load_batch`, on this
    machine's CPU; its library built first, untimed) at 1 and 8 threads,
    against the python backend (decode on the host, resample and window
    on the card, the volume copied back), one volume after another as a
    loader without workers takes them. The two agree within 1e-4 (the JAX
    package's tolerance between its two backends). Then leg J's host load
    of one volume in its parts: the native decode (a transposed view),
    its uint8 codes, their npz (the volume cache's write, here to
    memory), and the copy to the card with the layout made there, equal
    to the host's layout bit for bit."""
    import io

    import numpy as np
    import torch

    from smb_vision_tpu_torch.data import native as native_mod
    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.data.quantization import quantize_volume

    t0 = time.perf_counter()
    native_mod._load_lib()
    log(f"native loader: library loaded (built if absent) in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(g++, from csrc/ctloader.cpp)")
    paths = [str(p) for p in sorted(vols.glob("*.nii"))]
    pipe = PreprocessConfig(CT_PIPELINES["smb-vision"].target_spacing,
                            (512, 512, 320))
    native = {}
    for threads in (1, 8):
        t0 = time.perf_counter()
        out, status = native_mod.native_load_batch(
            paths, target_size=pipe.target_size,
            target_spacing=pipe.target_spacing, num_threads=threads)
        native[threads] = time.perf_counter() - t0
        if status != [0] * len(paths):
            raise AssertionError(f"native loader statuses {status}")
    ds = CTDataset(items=[{"image": p} for p in paths], pipeline=pipe,
                   backend="python", device=torch.device("cuda"))
    ds[0]                                           # warm-up, not timed
    t0 = time.perf_counter()
    python = [ds[i]["image"] for i in range(len(paths))]
    torch.cuda.synchronize()
    py_s = time.perf_counter() - t0
    err = max(float(np.abs(n.transpose(2, 0, 1) - p[:, 0]).max())
              for n, p in zip(out, python))
    log(f"preprocessing, {len(paths)} volumes of 256x256x160 int16 to "
        f"512x512x320: native loader {native[1] * 1e3:.1f} ms at 1 thread, "
        f"{native[8] * 1e3:.1f} ms at 8 threads; python backend (resample on "
        f"the card) {py_s * 1e3:.1f} ms; max |native - python| {err:.3e} "
        f"(bound 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"native and python preprocessing differ by "
                             f"{err}")
    ms = {}
    t0 = time.perf_counter()
    view = native_mod.native_preprocess_volume(paths[0], pipe)
    ms["native decode, 1 thread"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q, scale, offset = quantize_volume(view)
    ms["uint8 codes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.savez(io.BytesIO(), q=q, scale=scale, offset=offset)
    ms["npz of the codes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = torch.as_tensor(q)[None].to("cuda").contiguous()
    torch.cuda.synchronize()
    ms["copy and layout on the card"] = time.perf_counter() - t0
    if not torch.equal(card[0].cpu(), torch.from_numpy(
            np.ascontiguousarray(q))):
        raise AssertionError("the layout made on the card differs from the "
                             "host's")
    log("leg J's host load of one volume, in its parts: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in ms.items()))


def seeded_vit_base(dev, state: dict, **kw):
    """ViT-Base VideoMAE at 512^2 x 320 (kw: config keys; bf16 unless
    given) on dev, in eval mode, with the weights of seed 0: initialised
    into `state` at the first call and loaded from it after, so the
    variants of a phase hold the same weights without initialising them
    again (the initialisation runs on the host's CPU, seconds a model)."""
    import torch

    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    kw.setdefault("dtype", "bfloat16")
    m = VideoMAEModel(VideoMAEConfig(
        image_size=512, num_frames=320, hidden_size=HIDDEN,
        num_hidden_layers=12, num_attention_heads=HEADS,
        intermediate_size=FFN, **kw))
    if state:
        m.load_state_dict(state)
    else:
        state.update(m.init_weights(
            torch.Generator().manual_seed(0)).state_dict())
    return m.to(dev).eval()


def phase_whole_model(vols: Path, emb_a: Path) -> None:
    """One volume through the model with the kernels and with the plain
    path (attn_impl = mlp_impl = "xla"), same weights; leg G's model and
    the quant8 models (with K1, with K3) against their kernels' plain
    versions under the same impl names (`plain_kernels`), each also held
    against float32 (PERF.md section 2's forward rule)."""
    import numpy as np
    import torch

    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import CT_PIPELINES

    dev = torch.device("cuda")
    pipe = CT_PIPELINES["smb-vision"]
    pipe = type(pipe)(pipe.target_spacing, (512, 512, 320))
    ds = CTDataset(items=[{"image": str(sorted(vols.glob("*.nii"))[0])}],
                   pipeline=pipe, device=dev)
    px = torch.from_numpy(ds[0]["image"][None]).to(dev)

    state = {}

    def model(**kw):
        return seeded_vit_base(dev, state, **kw)

    glue = dict(attn_impl="pallas_int8pv", glue_impl="pallas")
    with torch.inference_mode():
        ref = model(attn_impl="xla", mlp_impl="xla")(px)[0].float()
        out = model()(px)[0].float()
        # quant8 (W8A8) with K1 and with K3: kernels against their plain
        # versions under the same impl names, one fresh model each
        q8_runs = {}
        for label, impl in (("K1", "auto"), ("K3", "pallas_int8")):
            ws = reset_launches()
            q8 = model(quant8=True, attn_impl=impl)(px)[0].float()
            q8_runs[label] = (q8, {n: ws[n].launches for n in (
                "quantize_rows", "w8a8_gemm", "flash_fwd", "flash_fwd_i8")})
            with plain_kernels():
                q8_runs[label] += (model(quant8=True, attn_impl=impl)(
                    px)[0].float(),)
        out8 = model(attn_impl="pallas_int8", mlp_impl="pallas_bwd")(
            px)[0].float()
        ws = reset_launches()
        outg = model(**glue)(px)[0].float()
        counts = {n: ws[n].launches for n in LEG_G_KERNELS}
        quant = ws["quantize"].launches
        with plain_kernels():
            refg = model(**glue)(px)[0].float()
        # float32 model: how far each bf16 path is from the f32 result
        ref32 = model(dtype="float32")(px)[0]
    torch.cuda.synchronize()
    if any(c != 12 for c in counts.values()) or quant != 36:
        raise AssertionError(f"whole model with K8 + K10: launches {counts}, "
                             f"quantisation {quant}")
    errg, relg = errors(outg, refg)
    plaing32, kerng32 = errors(refg, ref32)[1], errors(outg, ref32)[1]
    log(f"whole model, K8 + K10a + K10b (+ K2) vs their plain versions under "
        f"the same impl names: max|d| {errg:.3e} rel {relg:.3e} (bound "
        f"{TOL_MODEL}); vs float32: kernels rel {kerng32:.3e}, plain "
        f"versions rel {plaing32:.3e} (bound {TOL_MODEL_VS_F32} x plain); "
        f"launches {counts}")
    if not relg <= TOL_MODEL:
        raise AssertionError(f"whole model K8 + K10 rel {relg} > {TOL_MODEL}")
    if not kerng32 <= TOL_MODEL_VS_F32 * plaing32:
        raise AssertionError(f"K8 + K10 are {kerng32} from float32, their "
                             f"plain versions {plaing32}")
    err, rel = errors(out, ref)
    err8, rel8 = errors(out8, ref)
    plain32, kern32 = errors(ref, ref32)[1], errors(out, ref32)[1]
    log(f"whole model vs float32 plain: bf16 plain rel {plain32:.3e}, bf16 "
        f"kernels rel {kern32:.3e} (bound {TOL_MODEL_VS_F32} x plain), int8 "
        f"kernels rel {errors(out8, ref32)[1]:.3e}")
    if not kern32 <= TOL_MODEL_VS_F32 * plain32:
        raise AssertionError(f"kernels are {kern32} from float32, the plain "
                             f"bf16 path {plain32}")
    cli = torch.from_numpy(np.load(emb_a / "ct_0.npy")).to(dev)
    _, cli_rel = errors(cli, out)
    log(f"whole model, 12 layers bf16, kernels (K1+K2) vs plain: max|d| "
        f"{err:.3e} rel {rel:.3e} (bound {TOL_MODEL}); int8 leg (K3+K6) "
        f"vs plain: max|d| {err8:.3e} rel {rel8:.3e}; CLI leg A (batch 2) "
        f"vs this model call (batch 1): rel {cli_rel:.3e}")
    if not rel <= TOL_MODEL:
        raise AssertionError(f"whole model rel {rel} > {TOL_MODEL}")
    if not cli_rel <= TOL_MODEL:
        raise AssertionError(f"CLI embedding differs from the model's: "
                             f"rel {cli_rel}")
    for label, (q8, counts, q8_plain) in q8_runs.items():
        attn = "flash_fwd" if label == "K1" else "flash_fwd_i8"
        want = {**w8a8_launches(12, 1), attn: 12}
        errq, relq = errors(q8, q8_plain)
        kern32, plain32 = errors(q8, ref32)[1], errors(q8_plain, ref32)[1]
        log(f"whole model, quant8 + {label} (W8A8 kernels) vs their plain "
            f"versions under the same impl names: max|d| {errq:.3e} rel "
            f"{relq:.3e} (bound {TOL_MODEL}); vs float32 (unquantised): "
            f"kernels rel {kern32:.3e}, plain versions rel {plain32:.3e} "
            f"(bound {TOL_MODEL_VS_F32} x plain); vs the bf16 kernels "
            f"(unquantised) rel {errors(q8, out)[1]:.3e}; launches {counts}")
        if any(counts[n] != c for n, c in want.items()):
            raise AssertionError(f"quant8 + {label}: launches {counts}, "
                                 f"want {want}")
        if not relq <= TOL_MODEL or not kern32 <= TOL_MODEL_VS_F32 * plain32:
            raise AssertionError(f"quant8 + {label}: rel {relq}, vs float32 "
                                 f"{kern32} against the plain {plain32}")


LEG_G_KERNELS = ("flash_fwd_i8pv", "qkv_ln_fwd", "out_res_fwd")


def run_leg_g(root: Path, vols: Path, emb_a: Path, emb_b: Path,
              table: dict) -> None:
    """Leg G, this slice's serving path: run_inference with the glue config
    (glue_impl "pallas") and --attn_impl pallas_int8pv on the volumes, 2
    batches of 2. Asserts K8, K10a and K10b launched 24 times each (2
    batches x 12 layers) and K1 and K3 never; prints how far its embeddings
    lie from leg A's (bf16), beside leg B's (int8 scores)."""
    import numpy as np

    out, counts = run_leg(root, vols, "G", vit_base_config(
        root, "leg_g", "auto", "pallas"), ["--attn_impl", "pallas_int8pv"],
        LEG_G_KERNELS, table)
    want = 2 * 12
    if any(counts[n] != want for n in LEG_G_KERNELS + ("mlp_block_fwd",)) \
            or counts["flash_fwd"] or counts["flash_fwd_i8"] \
            or counts["quantize"] != 3 * want:
        raise AssertionError(f"leg G: launches {counts}; want {want} each "
                             "of K8, K10a, K10b and K2, none of K1 and K3, "
                             f"{3 * want} of the quantisation (q, k, v)")

    def rel(a_dir, b_dir):
        """The worst volume's max|a - b| / max|b| and ||a - b|| / ||b||."""
        worst = [0.0, 0.0]
        for f in sorted(a_dir.glob("*.npy")):
            a, b = np.load(f), np.load(b_dir / f.name)
            d = a - b
            worst[0] = max(worst[0], float(np.abs(d).max() / np.abs(b).max()))
            worst[1] = max(worst[1], float(np.linalg.norm(d)
                                           / np.linalg.norm(b)))
        return "max rel {:.3e}, norm rel {:.3e}".format(*worst)

    log(f"leg G vs leg A (bf16) embeddings: {rel(out, emb_a)}; leg B (int8 "
        f"scores) vs leg A: {rel(emb_b, emb_a)} (worst of the {N_VOLUMES} "
        "volumes)")


LEG_Q_KERNELS = ("flash_fwd", "quantize_rows", "w8a8_gemm")
# leg Q against leg A: the JAX CLI's own bound between --quant8 and the
# float route on the same checkpoint (tests/test_cli_integration.py)
TOL_LEG_Q = 5e-2


def w8a8_launches(layers: int, forwards: int) -> dict:
    """The W8A8 kernels' launches in `forwards` forwards of a fresh quant8
    ViT of `layers` layers, from the code (models/layers.py): each layer
    and forward, 4 row quantisations (LN1(x) for q, k and v together, the
    attention's output, LN2(x), the GELU's output) and 4 products (q, k, v
    on their stacked codes, o, fc1, fc2); once a layer, at the first
    forward, the 4 weights' codes (`WeightCodes`, kept after)."""
    return {"quantize_rows": 4 * layers * (forwards + 1),
            "w8a8_gemm": 4 * layers * forwards}


def run_leg_q(root: Path, vols: Path, emb_a: Path, table: dict) -> None:
    """Leg Q, W8A8 inference: run_inference --quant8 with leg A's config
    on the volumes, 2 batches of 2: K1 24 launches, the W8A8 kernels
    `w8a8_launches(12, 2)`, the fused MLP kernels none (quant8 fuses no
    half-block); each volume's embeddings within TOL_LEG_Q of max of leg
    A's."""
    import numpy as np

    out, counts = run_leg(root, vols, "Q", root / "leg_a.json",
                          ["--quant8"], LEG_Q_KERNELS, table)
    want = {**w8a8_launches(12, N_VOLUMES // 2), "flash_fwd": 24,
            "mlp_block_fwd": 0, "mlp_fwd": 0}
    if any(counts[n] != c for n, c in want.items()):
        raise AssertionError(f"leg Q: launches {counts}; want {want}")
    worst = 0.0
    for f in sorted(out.glob("*.npy")):
        q, a = np.load(f), np.load(emb_a / f.name)
        worst = max(worst, float(np.abs(q - a).max() / np.abs(a).max()))
    log(f"leg Q (--quant8) vs leg A (bf16) embeddings: max rel {worst:.3e} "
        f"(bound {TOL_LEG_Q}, worst of the {N_VOLUMES} volumes)")
    if not worst <= TOL_LEG_Q:
        raise AssertionError(f"leg Q: {worst} from leg A")


# leg S checks the server's vectors against leg A's token means: the same
# weights, the same batches of 2, so they differ only by the order of the
# mean (on the card here, in numpy there) and the float32 cache round trip
TOL_SERVE = 1e-5
SERVE_KERNELS = ("flash_fwd", "mlp_block_fwd")


@contextlib.contextmanager
def serving(**kw):
    """A `smb_vision_tpu_torch.cli.serve` server with leg A's model on the
    card, on a free local port, answering from a thread; shut down and
    closed on exit."""
    import threading

    from smb_vision_tpu_torch.cli.serve import ServeArguments, make_server

    srv = make_server(ServeArguments(host="127.0.0.1", port=0,
                                     batch_size=2, device="cuda", seed=0,
                                     **kw))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def http_call(srv, method: str, path: str, body=None, raw: bytes = None):
    """-> (status, decoded JSON answer, wall seconds, time split) of one
    request. The split is the server's Server-Timing header (preprocess,
    copy, encode, serialize) and response_ms, the wall time less the
    first three: the answer's serialisation, its transfer and its JSON
    decode here ({} for an answer without the header)."""
    import http.client

    from smb_vision_tpu_torch.cli.serve import server_timing

    host, port = srv.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=600)
    t0 = time.perf_counter()
    if raw is not None:
        conn.request(method, path, body=raw,
                     headers={"Content-Type": "application/octet-stream"})
    else:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None)
    resp = conn.getresponse()
    out = json.loads(resp.read())
    wall = time.perf_counter() - t0
    conn.close()
    header = resp.getheader("Server-Timing")
    split = server_timing(header) if header else {}
    if split:
        split["response_ms"] = 1e3 * wall - sum(
            split[k] for k in ("preprocess_ms", "copy_ms", "encode_ms"))
    return resp.status, out, wall, split


def split_line(split: dict) -> str:
    """An /embed answer's time split (http_call) as one log phrase."""
    return ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())


def leg_s_diagnosis(srv, paths: list, cfg: Path, emb_a: Path) -> str:
    """Where leg S's vectors left leg A's: each volume's pixels from the
    server's preprocessing against run_inference's dataset, and the
    server's model on those pixels, in this thread and in a new one,
    against leg A's tokens (max|d| / max|ref|; 0 means bit for bit)."""
    import threading

    import numpy as np

    from smb_vision_tpu_torch.data.dataset import CTDataset
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        PreprocessConfig,
    )
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    svc = srv.service
    mcfg = VideoMAEConfig.from_json(str(cfg))
    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["smb-vision"].target_spacing,
        target_size=(mcfg.image_size, mcfg.image_size, mcfg.num_frames))
    ds = CTDataset(items=[{"image": p} for p in paths], pipeline=pipe,
                   device=svc.encoder.device)
    lines = [f"backends: server {svc.encoder.create_dataset([]).backend}, "
             f"run_inference {ds.backend}"]
    for i in range(0, len(paths), 2):
        px = svc._preprocess(paths[i:i + 2], cache=False)[0]
        ref_px = np.stack([ds[j]["image"] for j in range(i, i + 2)])
        toks = {}

        def fwd(key, px=px):
            toks[key] = svc.encoder.generate_embedding(px)
        fwd("this thread")
        th = threading.Thread(target=fwd, args=("a new thread",))
        th.start()
        th.join()
        for j in range(2):
            ref = np.load(emb_a / f"{Path(paths[i + j]).stem}.npy")
            d_px = float(np.abs(px[j] - ref_px[j]).max())
            d_tok = {k: float(np.abs(t[j] - ref).max() / np.abs(ref).max())
                     for k, t in toks.items()}
            lines.append(f"{Path(paths[i + j]).name}: pixels max|d| "
                         f"{d_px:.3e}, tokens vs leg A {d_tok}")
    return "; ".join(lines)


def run_leg_s(work: Path, vols: Path, cfg: Path, emb_a: Path) -> None:
    """Leg S, the serving slice: `cli/serve.make_server` with leg A's
    config and seed (its weights), batch 2, on the card, with a volume
    cache. /healthz; the 4 volumes as one JSON request (mean-pooled, 2
    dispatched batches: K1 and K2 12 launches each a batch) against leg A's
    token means; ct_0's raw NIfTI bytes; the same request from the cache;
    6 concurrent mixed requests against the serial answers; a second
    server with --input_dtype uint8 against the float route. Each answer's
    time split into preprocess, copy, encode and response is logged."""
    import concurrent.futures

    import numpy as np
    import torch

    t0 = time.perf_counter()
    paths = [str(p) for p in sorted(vols.glob("*.nii"))]
    cache = work / "serve_cache"
    with serving(config_path=str(cfg), cache_data_dir=str(cache)) as srv:
        log(f"leg S: server up (warm-up forward at batch 2 included) in "
            f"{time.perf_counter() - t0:.1f} s")
        status, health, _, _ = http_call(srv, "GET", "/healthz")
        if (status != 200 or health["device"] != torch.cuda.get_device_name(0)
                or health["grid"] != [20, 32, 32]
                or health["hidden_size"] != HIDDEN):
            raise AssertionError(f"leg S /healthz: {status} {health}")
        ws = reset_launches()
        status, cold, wall_cold, split_cold = http_call(
            srv, "POST", "/embed", {"images": paths})
        counts = {n: ws[n].launches for n in SERVE_KERNELS}
        if (status != 200 or cold["shape"] != [N_VOLUMES, HIDDEN]
                or "encode_ms" not in split_cold):
            raise AssertionError(f"leg S: {status} shape {cold.get('shape')}"
                                 f", split {split_cold}")
        batches = N_VOLUMES // 2
        if any(c != 12 * batches for c in counts.values()):
            raise AssertionError(f"leg S: launches {counts}; want "
                                 f"{12 * batches} each ({batches} batches)")
        vecs = np.asarray(cold["embeddings"], np.float32)
        worst = 0.0
        for i, path in enumerate(paths):
            ref = np.load(emb_a / f"{Path(path).stem}.npy").mean(axis=0)
            worst = max(worst, float(np.abs(vecs[i] - ref).max()
                                     / np.abs(ref).max()))
        log(f"leg S: 4 volumes in {wall_cold * 1e3:.1f} ms (cache miss: "
            f"{split_line(split_cold)}); vs leg A's token means max rel "
            f"{worst:.3e} (bound {TOL_SERVE}); launches {counts}")
        if not worst <= TOL_SERVE:
            raise AssertionError(f"leg S vectors {worst} from leg A's; "
                                 f"{leg_s_diagnosis(srv, paths, cfg, emb_a)}")

        status, raw, wall_raw, split = http_call(
            srv, "POST", "/embed?pool=mean", raw=Path(paths[0]).read_bytes())
        d_raw = float(np.abs(np.asarray(raw["embeddings"][0]) - vecs[0]).max()
                      / np.abs(vecs[0]).max())
        log(f"leg S: raw NIfTI bytes of ct_0 in {wall_raw * 1e3:.1f} ms "
            f"({split_line(split)}); vs the JSON route rel {d_raw:.3e}")
        if status != 200 or not d_raw <= TOL_SERVE:
            raise AssertionError(f"leg S raw bytes: {status}, rel {d_raw}")

        status, warm, wall_warm, split = http_call(srv, "POST", "/embed",
                                                   {"images": paths})
        d_warm = float(np.abs(np.asarray(warm["embeddings"]) - vecs).max()
                       / np.abs(vecs).max())
        n_cached = len(list(cache.glob("*.npy")))
        log(f"leg S: the same 4 volumes from the cache in "
            f"{wall_warm * 1e3:.1f} ms ({split_line(split)}) against "
            f"{wall_cold * 1e3:.1f} ms cold; {n_cached} entries; rel "
            f"{d_warm:.3e}")
        if status != 200 or n_cached != N_VOLUMES or not d_warm <= TOL_SERVE:
            raise AssertionError(f"leg S cache: {status}, {n_cached} "
                                 f"entries, rel {d_warm}")

        status, one, wall_one, split = http_call(srv, "POST", "/embed",
                                                 {"image": paths[1]})
        log(f"leg S: one volume from the cache in {wall_one * 1e3:.1f} ms "
            f"({split_line(split)})")

        served0 = http_call(srv, "GET", "/healthz")[1]["requests_served"]
        jobs = []
        for i in range(6):
            if i % 3 == 0:
                jobs.append(("POST", "/embed",
                             {"images": [paths[1], paths[0], paths[2]]}))
            elif i % 3 == 1:
                jobs.append(("POST", "/embed", {"image": paths[i % 2]}))
            else:
                jobs.append(("GET", "/healthz", None))
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
            results = list(ex.map(lambda j: http_call(srv, *j), jobs))
        wall_conc = time.perf_counter() - t1
        n_vols, worst = 0, 0.0
        for (_, path, body), (status, out, _, _) in zip(jobs, results):
            if status != 200:
                raise AssertionError(f"leg S concurrent {path}: {status} "
                                     f"{out}")
            if path == "/healthz":
                continue
            names = body.get("images") or [body["image"]]
            n_vols += len(names)
            for name, got in zip(names, out["embeddings"]):
                ref = vecs[paths.index(name)]
                worst = max(worst, float(np.abs(np.asarray(got) - ref).max()
                                         / np.abs(ref).max()))
        served = (http_call(srv, "GET", "/healthz")[1]["requests_served"]
                  - served0)
        log(f"leg S: 6 concurrent requests ({n_vols} volumes) in "
            f"{wall_conc * 1e3:.1f} ms; vs the serial answers max rel "
            f"{worst:.3e}; requests_served +{served}")
        if not worst <= TOL_SERVE or served != n_vols:
            raise AssertionError(f"leg S concurrent: rel {worst}, served "
                                 f"{served} of {n_vols}")

    with serving(config_path=str(cfg), input_dtype="uint8") as srv8:
        status, out8, wall8, split = http_call(srv8, "POST", "/embed",
                                               {"images": paths})
        if status != 200:
            raise AssertionError(f"leg S uint8: {status} {out8}")
        d8 = float(np.abs(np.asarray(out8["embeddings"]) - vecs).max()
                   / np.abs(vecs).max())
        log(f"leg S: uint8 server, 4 volumes in {wall8 * 1e3:.1f} ms "
            f"({split_line(split)}); vs the float route max rel {d8:.3e} "
            f"(bound {TOL_MODEL})")
        if not d8 <= TOL_MODEL:
            raise AssertionError(f"leg S uint8 vectors {d8} from float")
    log(f"leg S: done in {time.perf_counter() - t0:.1f} s")


SW_SHAPE = (256, 256, 224)     # int16 HU at (3, 3, 6) mm: 512 x 512 x 448,
SW_STARTS = ((0, 0, 0), (0, 0, 128))  # two 512^2 x 320 windows at 0.25


@contextlib.contextmanager
def no_nifti_decode():
    """Inside the block the port's dataset cannot decode a NIfTI file: a
    volume it needs must come from its cache."""
    from smb_vision_tpu_torch.data import dataset as D

    def refuse(path):
        raise AssertionError(f"{path} decoded despite the cache")

    decode, D.load_nifti = D.load_nifti, refuse
    try:
        yield
    finally:
        D.load_nifti = decode


def run_leg_w(work: Path, vols: Path, cfg: Path, emb_a: Path) -> None:
    """Leg W, sliding window: `run_inference --sliding_window` on two
    512 x 512 x 448 volumes (two windows each, one batch of 2: K1 and K2
    24 launches), each window against one forward of the model on its crop
    of `preprocess_volume_full`; then `run_inference --input_dtype uint8
    --cache_data_dir ... --cache_dtype uint8` on leg A's volumes against
    leg A, and again with --resume false from the cache alone."""
    import numpy as np
    import torch

    from smb_vision_tpu_torch.cli.run_inference import main as run_inference
    from smb_vision_tpu_torch.data.nifti import load_nifti, save_nifti
    from smb_vision_tpu_torch.data.preprocess import (
        CT_PIPELINES,
        preprocess_volume_full,
    )
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel

    big = work / "volumes_w"
    big.mkdir()
    rng = np.random.default_rng(1)
    for i in range(2):
        hu = rng.normal(-200.0, 400.0, SW_SHAPE).clip(-1024, 3000)
        save_nifti(big / f"cap_{i}.nii", hu.astype(np.int16),
                   np.diag([*VOL_SPACING, 1.0]))
    base = ["--config_path", str(cfg), "--batch_size", "2", "--device",
            "cuda", "--num_workers", "2"]
    out = work / "emb_w"
    ws = reset_launches()
    t0 = time.perf_counter()
    stats = run_inference(["--data_dir", str(big), "--output_dir", str(out),
                           "--sliding_window", "--sw_overlap", "0.25",
                           *base])
    wall = time.perf_counter() - t0
    counts = {n: ws[n].launches for n in SERVE_KERNELS}
    log(f"leg W: {stats} in {wall:.1f} s; launches {counts}")
    if stats != {"embedded": 2, "failed": 0, "skipped": 0} or any(
            c != 24 for c in counts.values()):
        raise AssertionError(f"leg W: {stats}, launches {counts} (want 24)")

    dev = torch.device("cuda")
    model = VideoMAEModel(VideoMAEConfig.from_json(str(cfg)))
    model = model.init_weights(torch.Generator().manual_seed(0)).to(dev)
    model.eval()
    worst = 0.0
    for f in sorted(big.glob("*.nii")):
        emb = np.load(out / f"{f.stem}.npy")
        if emb.shape != (2, MAIN_N, HIDDEN) or not np.isfinite(emb).all():
            raise AssertionError(f"leg W {f.name}: shape {emb.shape}")
        img = load_nifti(f)
        vol = preprocess_volume_full(img.data, img.affine,
                                     CT_PIPELINES["smb-vision"], device=dev)
        if vol.shape != (512, 512, 448):
            raise AssertionError(f"leg W {f.name}: volume {vol.shape}")
        vol = torch.from_numpy(vol).to(dev)
        for k, (_, _, z) in enumerate(SW_STARTS):
            px = vol[:, :, z:z + 320].permute(2, 0, 1)[None, :, None]
            with torch.inference_mode():
                ref = model(px)[0][0].float()
            got = torch.from_numpy(emb[k]).to(dev)
            worst = max(worst, errors(got, ref)[1])
    log(f"leg W: windows vs one forward of their crops max rel {worst:.3e} "
        f"(bound {TOL_SERVE})")
    if not worst <= TOL_SERVE:
        raise AssertionError(f"leg W windows {worst} from their crops")

    cache = work / "cache_u8"
    u8 = ["--data_dir", str(vols), "--input_dtype", "uint8",
          "--cache_data_dir", str(cache), "--cache_dtype", "uint8", *base]
    ws = reset_launches()
    t0 = time.perf_counter()
    stats = run_inference(u8 + ["--output_dir", str(work / "emb_u8")])
    wall_cold = time.perf_counter() - t0
    counts = {n: ws[n].launches for n in SERVE_KERNELS}
    with no_nifti_decode():
        t0 = time.perf_counter()
        again = run_inference(u8 + ["--output_dir", str(work / "emb_u8b"),
                                    "--resume", "false"])
        wall_warm = time.perf_counter() - t0
    worst, same = 0.0, True
    for f in sorted(emb_a.glob("*.npy")):
        a = np.load(work / "emb_u8" / f.name)
        worst = max(worst, float(np.abs(a - np.load(f)).max()
                                 / np.abs(np.load(f)).max()))
        same &= bool(np.array_equal(a, np.load(work / "emb_u8b" / f.name)))
    n_cached = len(list(cache.iterdir()))
    log(f"leg W: uint8 + uint8 cache {stats} in {wall_cold:.1f} s, again "
        f"from the cache {again} in {wall_warm:.1f} s ({n_cached}"
        f" entries); vs leg A max rel {worst:.3e} (bound {TOL_MODEL}); the "
        f"two runs equal: {same}; launches {counts}")
    want = {"embedded": N_VOLUMES, "failed": 0, "skipped": 0}
    if stats != want or again != want or not same or not worst <= TOL_MODEL \
            or any(c != 24 for c in counts.values()):
        raise AssertionError(f"leg W uint8: {stats}, {again}, rel {worst}, "
                             f"equal {same}, launches {counts}")


def phase_throughput(card: str, batch: int = 4, iters: int = 3) -> dict:
    """Encoder-only volumes/s at 512^2 x 320, batch 4, for the bf16,
    quant8 (W8A8 with K1), int8, quant8 + int8 (W8A8 with K3) and int8 p v
    + glue (leg G's) models, in that order: CUDA events over `iters`
    distinct seeded batches after one warm-up (which quantises the quant8
    models' weights), then one profiled forward each (the W8A8 kernels'
    share of the quant8 ones)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batches = [torch.rand((batch, 320, 1, 512, 512), generator=gen,
                          device=dev).to(torch.bfloat16)
               for _ in range(iters + 1)]
    legs = {"bf16": dict(), "quant8": dict(quant8=True),
            "int8": dict(attn_impl="pallas_int8", mlp_impl="pallas_bwd"),
            "quant8+int8": dict(quant8=True, attn_impl="pallas_int8"),
            "int8pv+glue": dict(attn_impl="pallas_int8pv",
                                glue_impl="pallas")}
    rates, state = {}, {}
    for leg, impls in legs.items():
        m = seeded_vit_base(dev, state, **impls)
        with torch.inference_mode():
            m(batches[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for px in batches[1:]:
                m(px)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / iters
        rates[leg] = batch * 1000.0 / ms
        log(f"throughput {leg}: {rates[leg]:.3f} volumes/s ({ms:.1f} ms per "
            f"batch of {batch}, 512x512x320 ViT-Base d64, encoder only, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB) "
            f"on {card}")
        with torch.inference_mode():
            profile_call(lambda: m(batches[0]),
                         f"{leg}: one batch-{batch} forward",
                         watch=("w8a8",) if "quant8" in leg else ())
        del m
    return rates


def device_times(fn, calls: int = 10, tries: int = 3) -> list:
    """[(kernel, launches a call, mean device ms a launch)] of the kernels
    that `calls` calls of fn launch, from the profiler. The profiler now
    and then records no device activity for a session, or loses some of
    a kernel's launches (a count that is no multiple of `calls`); it is
    then asked again, up to `tries` times in all, and if it still sees
    no whole session the one row is the whole call's mean time by CUDA
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out, lost = [], []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0:
                out.append((ev.key, ev.count // calls, us / ev.count / 1e3))
                if ev.count % calls:
                    lost.append(f"{ev.key[:40]} x{ev.count}")
        if out and not lost:
            return out
        log(f"device_times: the profiler saw "
            + (f"launches that are no multiple of {calls} calls ({lost})"
               if lost else "no device time")
            + f" (try {attempt + 1} of {tries})")
    return [("whole call (CUDA events; the profiler saw no device time)",
             1, cuda_ms(fn, iters=calls))]


def kernel_split(label: str, fn, calls: int = 10) -> None:
    """The mean device time of each kernel that `calls` calls of fn
    launch, from the profiler: the passes of a kernel that launches
    several apart."""
    for key, count, ms in device_times(fn, calls):
        log(f"split {label}: {key[:72]} x{count} a call, {ms:.4f} ms each "
            f"(profiler)")


def profile_call(fn, label: str, top: int = 8, watch: tuple = ()) -> None:
    """fn() once under torch.profiler: device busy and idle share of the
    wall time, the kernels that take the most device time and the
    optimizer step's range on the device; with watch, also the share and
    launches of the kernels whose names hold one of its strings."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, optim = [], []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        # a user annotation (Optimizer.step) spans kernels counted apart;
        # the optimizer's range on the device is read from it
        if getattr(ev, "is_user_annotation", False) or \
                ev.key.startswith("Optimizer."):
            if ev.key.startswith("Optimizer.step"):
                optim.append((getattr(ev, "device_time_total", getattr(
                    ev, "cuda_time_total", 0)) / 1e3, ev.key))
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"profile {label}: the profiler saw no device time")
        return
    log(f"profile {label}: {wall:.1f} ms wall (profiler on), device busy "
        f"{busy:.1f} ms = {100 * busy / wall:.1f}%, idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:top]:
        log(f"  {ms:9.2f} ms {100 * ms / busy:5.1f}% of busy  x{count:<4} "
            f"{key[:100]}")
    for ms, key in optim:
        log(f"  {key}: its range on the device {ms:.2f} ms = "
            f"{100 * ms / wall:.1f}% of the wall")
    if watch:
        hit = [r for r in rows if any(w in r[2] for w in watch)]
        ms = sum(r[0] for r in hit)
        log(f"  {' + '.join(watch)}: {ms:.2f} ms = {100 * ms / busy:.1f}% "
            f"of busy, {sum(r[1] for r in hit)} launches")


def preset_config(cli: str, path: Path, **kw):
    """The model of a shipped preset, built at full width as the CLI
    `smb_vision_tpu_torch.cli.<cli>` builds it; kw overrides config keys.
    Returns (config, the preset's keys)."""
    mod = importlib.import_module(f"smb_vision_tpu_torch.cli.{cli}")
    preset = json.loads(path.read_text())
    names = {f.name for f in dataclasses.fields(mod.ModelArguments)}
    cfg = mod.build_config(mod.ModelArguments(
        **{k: v for k, v in preset.items() if k in names}))
    cfg.update(kw)
    return cfg, preset


def mim_config(**kw):
    """configs/mim_base_512.json: ViT-Base VideoMAE at 512^2 x 320, decoder
    384 wide and 4 deep, bf16, mlp_impl pallas_bwd, remat."""
    return preset_config("run_mim", MIM_PRESET, **kw)


def vjepa_config(**kw):
    """configs/vjepa_large_384_tpu.json: V-JEPA2 ViT-L at 384^2 x 256, 8
    heads of 128, predictor 384 wide, 12 deep, 3 heads of 128; bf16,
    attn_impl pallas_i8bwd, mlp_impl pallas_bwd, remat."""
    return preset_config("run_vjepa", VJEPA_PRESET, **kw)


def vjepa_ref_config(**kw):
    """configs/vjepa_large_384.json: the same ViT-L at 16 heads of 64, the
    predictor at 12 heads of 32; bf16, attn_impl "auto" (the preset names
    none), mlp_impl pallas_bwd, remat."""
    return preset_config("run_vjepa", VJEPA_REF_PRESET, **kw)


def phase_train_parity(glue: bool = False, vit_h: bool = False) -> None:
    """One MIM step (forward + backward, no update) on one volume, the
    same seeded weights and mask, through the kernels (attn auto, mlp
    pallas_bwd, remat), through the plain path in bf16 and through the
    plain path in float32 (TF32 off). With glue, every block's attention
    half runs through K10a and K10b (glue_impl "pallas"), which must launch
    exactly twice a block (16 blocks, forward and remat recompute), and the
    bf16 reference is the same impl names on their plain versions
    (`plain_kernels`), which must launch nothing. With vit_h, the encoder
    at ViT-H widths (VIT_H_MIM), VIT_H_PARITY_LAYERS of its 32 layers: K1
    and K4 at d 80 and K5a and K5b at K 1,280, each kernel's launches as
    `expected_launches` gives them, and the plain attention never on the
    kernel path. The weights are drawn on the card from a CUDA generator
    of seed 0."""
    import torch

    from smb_vision_tpu_torch.models.videomae import VideoMAEForPreTraining
    from smb_vision_tpu_torch.ops.masking import mim_mask, num_masked_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    base = (dict(VIT_H_MIM, num_hidden_layers=VIT_H_PARITY_LAYERS)
            if vit_h else {})
    cfg0, preset = mim_config(**base)
    geo = dict(input_size=cfg0.image_size, depth=cfg0.num_frames,
               mask_patch_size=preset["mask_patch_size"],
               model_patch_size=cfg0.patch_size,
               mask_ratio=preset["mask_ratio"])
    nm = num_masked_tokens(**geo)
    if cfg0.seq_len - nm != ENC_N:
        raise AssertionError(f"the preset encodes {cfg0.seq_len - nm} "
                             f"tokens, not {ENC_N}")
    gen = torch.Generator(device=dev).manual_seed(2)
    px = torch.rand((1, cfg0.num_frames, 1, cfg0.image_size,
                     cfg0.image_size), generator=gen, device=dev)
    mask = mim_mask(torch.Generator().manual_seed(0), 1, **geo).to(dev)

    def step(**kw):
        cfg, _ = mim_config(**base, **kw)
        with torch.device(dev):     # built and initialised on the card
            model = VideoMAEForPreTraining(cfg).to(dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(0))
        model.train()
        loss = model(px, mask, nm)["loss"]
        loss.backward()
        grads = [p.grad for p in model.parameters()]
        if any(g is None for g in grads):
            raise AssertionError(f"{kw or 'kernel path'}: a parameter got "
                                 "no gradient")
        flat = torch.cat([g.float().flatten() for g in grads])
        del model, grads
        torch.cuda.empty_cache()
        return float(loss.detach()), flat

    kw = dict(glue_impl="pallas") if glue else {}
    ws = reset_launches()
    t0 = time.perf_counter()
    with plain_attention_calls() as plain:
        k_loss, k_grad = step(**kw)
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    for name in ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"training step: {name} never launched")
    if vit_h:
        check_vit_h_launches("ViT-H MIM step", ws, expected_launches(
            ONE_STEP["mim"], cfg0), cfg0.num_hidden_layers, "flash_bwd",
            plain)
    if glue:
        blocks = cfg0.num_hidden_layers + cfg0.decoder_num_hidden_layers
        if not counts["qkv_ln_fwd"] == counts["out_res_fwd"] == 2 * blocks:
            raise AssertionError(f"glue step: launches {counts}; K10a and "
                                 f"K10b must launch {2 * blocks} times")
        ws = reset_launches()
        with plain_kernels():
            p_loss, p_grad = step(**kw)
        if any(w.launches for w in ws.values()):
            raise AssertionError("the plain path launched a kernel")
    else:
        p_loss, p_grad = step(attn_impl="xla", mlp_impl="xla")
    f_loss, f_grad = step(attn_impl="xla", mlp_impl="xla", dtype="float32")
    norm = float(f_grad.norm())
    k_err = float((k_grad - f_grad).norm()) / norm
    p_err = float((p_grad - f_grad).norm()) / norm
    rel_loss = abs(k_loss - p_loss) / abs(p_loss)
    finite = bool(k_grad.isfinite().all())
    what = (" with the glue (K10a, K10b)" if glue else
            f" at ViT-H widths ({cfg0.num_hidden_layers} of 32 layers)"
            if vit_h else "")
    log(f"training parity{what}, one MIM step at full width: loss kernels "
        f"{k_loss:.6f}, plain bf16 {p_loss:.6f}, f32 {f_loss:.6f}; rel "
        f"{rel_loss:.3e} (bound {TOL_TRAIN_LOSS}); gradient error vs f32: "
        f"kernels {k_err:.3e}, plain bf16 {p_err:.3e} (bound "
        f"{TOL_TRAIN_GRAD_VS_F32} x plain); kernel step {wall:.1f} s with "
        f"the first calls; launches {counts}")
    if not (finite and math.isfinite(k_loss)):
        raise AssertionError("the kernel path's loss or gradient is not "
                             "finite")
    if not rel_loss <= TOL_TRAIN_LOSS:
        raise AssertionError(f"training loss rel {rel_loss}")
    if not k_err <= TOL_TRAIN_GRAD_VS_F32 * p_err:
        raise AssertionError(f"kernel gradients are {k_err} from float32, "
                             f"the plain bf16 path's {p_err}")


def run_leg_c(work: Path, vols: Path, table: dict, leg: str = "C",
              overrides: str = "") -> None:
    """run_mim on the volumes with a copy of configs/mim_base_512.json
    (the encoder cut to LEG_C_LAYERS): 4 steps, a checkpoint every 2,
    eval; then the same to 6 steps, which resumes at 4. Asserts the logs,
    the checkpoints, the export and that the training kernels and K6
    (eval) launched. Leg H passes
    --config_overrides glue_impl=pallas (overrides), and K10a and K10b
    must launch too."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_mim import main as run_mim
    from smb_vision_tpu_torch.train.trainer import Trainer

    spec = work / "mim_data.json"
    spec.write_text(json.dumps({"train": [
        {"image": str(p)} for p in sorted(vols.glob("*.nii"))]}))
    out = work / f"mim_out_{leg}"
    preset = json.loads(MIM_PRESET.read_text())
    if overrides:
        preset["config_overrides"] = overrides

    def run(steps):
        path = work / f"mim_{leg}_{steps}.json"
        path.write_text(json.dumps(dict(
            preset, json_path=str(spec), output_dir=str(out),
            num_hidden_layers=LEG_C_LAYERS, num_train_steps=steps,
            save_steps=2, logging_steps=1, do_eval=True)))
        t0 = time.perf_counter()
        res = run_mim([str(path)])
        return res, time.perf_counter() - t0

    ws = reset_launches()
    res4, wall4 = run(4)
    counts = {name: w.launches for name, w in ws.items()}
    # leg P's reference: the 4-step run's export and step records
    shutil.copy(out / "model.safetensors", work / f"leg_{leg}_model_4.st")
    first = [json.loads(line) for line in
             (out / "metrics.jsonl").read_text().splitlines()]
    res6, wall6 = run(6)
    log(f"leg {leg}{f' ({overrides})' if overrides else ''}: {res4} in "
        f"{wall4:.1f} s, resumed {res6} in {wall6:.1f} s (preprocess + "
        f"train + eval + save); launches of the first run {counts}")
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    for r in train:
        log(f"  step {r['step']}: loss {r['loss']:.6f}, "
            f"{r['step_time_ms']:.1f} ms, mfu {r.get('mfu')}")
    if [r["step"] for r in train] != [1, 2, 3, 4, 5, 6]:
        raise AssertionError(f"leg {leg} logged steps "
                             f"{[r['step'] for r in train]}")
    for r in train:
        if not (math.isfinite(r["loss"]) and r.get("mfu", 0) > 0):
            raise AssertionError(f"leg {leg} step record {r}")
    for res in (res4, res6):
        if not math.isfinite(res.get("eval_loss", math.nan)):
            raise AssertionError(f"leg {leg} eval: {res}")
    ckpts = Trainer.checkpoint_steps(out / "checkpoints")
    if ckpts != [2, 4, 6] or res6["train_steps"] != 6:
        raise AssertionError(f"leg {leg} checkpoints {ckpts}, result {res6}")
    from smb_vision_tpu_torch.models.convert import read_safetensors

    export = read_safetensors(out / "model.safetensors")
    if not (out / "config.json").exists() or not all(
            np.isfinite(v).all() for v in export.values()):
        raise AssertionError(f"leg {leg}: config.json or a finite "
                             "model.safetensors is missing")
    saved = json.loads((out / "config.json").read_text())
    log(f"leg {leg}: checkpoints {ckpts}, model.safetensors "
        f"{len(export)} tensors, config.json (glue_impl "
        f"{saved.get('glue_impl')!r})")
    kernels = ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd",
               "mlp_fwd") + (("qkv_ln_fwd", "out_res_fwd") if overrides
                             else ())
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"leg {leg}: kernel {name} never launched")
    if not overrides:
        for name in ("flash_bwd", "mlp_train_fwd", "mlp_bwd"):
            table[name]["launches"] = counts[name]
    return {"records": [r for r in first if "loss" in r], "wall": wall4,
            "export": work / f"leg_{leg}_model_4.st"}


# leg P: the launcher path at world 1 (NCCL), under fsdp, against leg C
LEG_P_POLICY = "fsdp"
TOL_LEG_P = 1e-3        # the repo's learning-equivalence bound, relative


def in_background(fn, *args):
    """Start fn(*args) on a thread; returns a join() that waits for it,
    raises what it raised and returns what it returned."""
    import threading

    box = {}

    def body():
        try:
            box["out"] = fn(*args)
        except BaseException as err:  # re-raised by join()
            box["err"] = err

    thread = threading.Thread(target=body, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box.get("out")

    return join


def torchrun_cmd(module: str, *argv: str, nproc: int = 1) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), "-m", module, *argv]


def child_pids(pid: int) -> list:
    """The direct children of a process (Linux /proc)."""
    out = []
    for task in Path(f"/proc/{pid}/task").glob("*"):
        try:
            out += [int(c) for c in (task / "children").read_text().split()]
        except OSError:
            pass
    return out


def launch(cmd: list, log_path: Path, env=None) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=open(log_path, "w"),
                            stderr=subprocess.STDOUT)


def stop(proc: subprocess.Popen) -> None:
    """Kill a started command that still runs, and its children (a
    launcher's ranks)."""
    if proc.poll() is None:
        for pid in child_pids(proc.pid):
            with contextlib.suppress(OSError):
                os.kill(pid, signal.SIGKILL)
        proc.kill()
        proc.wait()


def finish(proc: subprocess.Popen, log_path: Path, what: str,
           timeout: float = 600) -> None:
    """Wait for a started command; on a failure or a timeout stop it and
    raise with the end of its log."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop(proc)
        rc = "timeout"
    if rc != 0:
        raise AssertionError(f"{what}: exit {rc}\n"
                             + log_path.read_text()[-6000:])


def same_checkpoint(a: Path, b: Path) -> tuple:
    """(equal, files compared) of two sharded checkpoints: every shard
    file byte for byte and meta.pt's values; `.metadata` (which names the
    directory it was written to) left out."""
    import torch

    names = sorted(p.name for p in a.iterdir()
                   if p.name not in (".metadata", "meta.pt"))
    if names != sorted(p.name for p in b.iterdir()
                       if p.name not in (".metadata", "meta.pt")):
        return False, 0
    same = all((a / n).read_bytes() == (b / n).read_bytes() for n in names)
    meta = [torch.load(d / "meta.pt", weights_only=True) for d in (a, b)]
    return same and meta[0] == meta[1], len(names)


def run_leg_p(work: Path, leg_c: dict) -> dict:
    """Leg P, the launcher path: `python -m torch.distributed.run
    --standalone --nproc_per_node 1 -m smb_vision_tpu_torch.cli.run_mim`
    with leg C's preset (its encoder at LEG_C_LAYERS), volumes, seed and
    flags under --sharding_policy fsdp (NCCL, FSDP2 over a data axis of
    1): 4 straight steps, and at
    the same time, in a second directory, 4 steps stopped by a SIGTERM to
    the rank after step 2 and resumed. The straight run's losses against
    leg C's (1e-3 relative), its export against leg C's 4-step export
    (1e-3 of each tensor's max); the resumed run's checkpoint and export
    byte for byte the straight run's. The runs share the card with each
    other (and `main` runs the 2-rank phase beside them), so their step
    times are no speed. Returns the step records and the wall."""
    import numpy as np

    from smb_vision_tpu_torch.models.convert import read_safetensors

    preset = json.loads(MIM_PRESET.read_text())
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def config(name):
        path = work / f"leg_p_{name}.json"
        path.write_text(json.dumps(dict(
            preset, json_path=str(work / "mim_data.json"),
            output_dir=str(work / f"leg_p_{name}"),
            num_hidden_layers=LEG_C_LAYERS, num_train_steps=4,
            save_steps=2, logging_steps=1, do_eval=True,
            sharding_policy=LEG_P_POLICY)))
        return path

    cmd = functools.partial(torchrun_cmd, "smb_vision_tpu_torch.cli.run_mim")
    from smb_vision_tpu_torch.train.trainer import Trainer

    b = work / "leg_p_b"

    def logged_step() -> int:
        """The last step in the stopped run's metrics.jsonl (a line
        still being written is skipped)."""
        steps = [0]
        with contextlib.suppress(OSError):
            for line in (b / "metrics.jsonl").read_text().splitlines():
                with contextlib.suppress(ValueError):
                    steps.append(json.loads(line).get("step", 0))
        return max(steps)

    t0 = time.perf_counter()
    procs = []
    try:
        # the straight run and the stopped one at once: SIGTERM to the
        # stopped run's rank once its step 2 is logged
        straight = launch(cmd(str(config("a"))), work / "leg_p_a.log", env)
        procs.append(straight)
        proc = launch(cmd(str(config("b"))), work / "leg_p_b1.log", env)
        procs.append(proc)
        sent = None
        while proc.poll() is None and sent is None:
            time.sleep(0.2)
            if logged_step() >= 2:
                ranks = child_pids(proc.pid)
                for pid in ranks:
                    os.kill(pid, signal.SIGTERM)
                sent = ranks
        finish(proc, work / "leg_p_b1.log", "leg P, the stopped run")
        stopped = Trainer.checkpoint_steps(b / "checkpoints")
        if not sent or not stopped or stopped[-1] >= 4:
            raise AssertionError(f"leg P: SIGTERM to {sent}, checkpoints "
                                 f"{stopped}: the run did not stop early")
        proc = launch(cmd(str(config("b"))), work / "leg_p_b2.log", env)
        procs.append(proc)
        finish(proc, work / "leg_p_b2.log", "leg P, the resumed run")
        finish(straight, work / "leg_p_a.log", "leg P, the straight run")
    finally:
        for proc in procs:
            stop(proc)
    wall = time.perf_counter() - t0
    a = work / "leg_p_a"
    recs = [json.loads(x) for x in
            (a / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    ref = {r["step"]: r for r in leg_c["records"]}
    worst = 0.0
    for r in train:
        c = ref[r["step"]]
        rel = abs(r["loss"] - c["loss"]) / abs(c["loss"])
        worst = max(worst, rel)
        log(f"leg P step {r['step']}: loss {r['loss']:.6f} (leg C "
            f"{c['loss']:.6f}, rel {rel:.3e}), {r['step_time_ms']:.1f} ms "
            f"beside the other runs (leg C {c['step_time_ms']:.1f}), peak "
            f"{r.get('peak_memory_mib', math.nan):.0f} MiB (leg C "
            f"{c.get('peak_memory_mib', math.nan):.0f})")
    if [r["step"] for r in train] != [1, 2, 3, 4] or not worst <= TOL_LEG_P:
        raise AssertionError(f"leg P: steps {[r['step'] for r in train]}, "
                             f"worst loss rel {worst} (bound {TOL_LEG_P})")
    ours = read_safetensors(a / "model.safetensors")
    theirs = read_safetensors(leg_c["export"])
    if set(ours) != set(theirs):
        raise AssertionError("leg P: the export's names differ from leg C's")
    export_rel = max(float(np.abs(ours[k] - theirs[k]).max())
                     / max(float(np.abs(theirs[k]).max()), 1e-30)
                     for k in theirs)
    if not export_rel <= TOL_LEG_P:
        raise AssertionError(f"leg P: export rel {export_rel} from leg C's")
    same, n_files = same_checkpoint(a / "checkpoints" / "4",
                                    b / "checkpoints" / "4")
    same_export = ((a / "model.safetensors").read_bytes()
                   == (b / "model.safetensors").read_bytes())
    if not (same and same_export and n_files):
        raise AssertionError(f"leg P: the resumed run's checkpoint equal "
                             f"{same} ({n_files} shard files), export "
                             f"equal {same_export}")
    log(f"leg P ({LEG_P_POLICY}, world 1, NCCL, through "
        f"torch.distributed.run): worst step loss rel {worst:.3e} to leg C, "
        f"export rel {export_rel:.3e}; stopped by SIGTERM at step "
        f"{stopped[-1]}, resumed: checkpoint ({n_files} shard files) and "
        f"export byte for byte the straight run's; wall {wall:.1f} s for "
        f"the straight run beside the stopped and resumed ones (each with "
        f"torch.distributed.run's start, preprocessing, eval and saves); "
        f"leg C's 4 steps {leg_c['wall']:.1f} s in process")
    return {"records": train, "wall": wall}


# two ranks on the one card: the Trainer API on a gloo group the script
# makes (NCCL refuses two ranks of one device), CUDA tensors, the
# full-width MIM step of configs/mim_base_512.json at 2 volumes a step,
# under the data-axis and tensor-parallel policies, sequence parallelism
# (both variants; under "tp" and "fsdp+tp" too, the tokens and the split
# weights on one model axis) and the pipeline; the V-JEPA preset
# configs/vjepa_large_384_tpu.json (ViT-L, 9,216 tokens) under the ring,
# the pipeline and "gather" under "fsdp+tp"; and the LoRA fine-tune step
# of DINOv2-giant (rank 8, the default targets, the two-tier AdamW) under
# "fsdp" and "fsdp+tp". Each mode: (name, workload, policy, model axis,
# sp_variant or None, pipeline stages)
TWO_RANK_MODES = (("dp", "mim", "dp", 1, None, 1),
                  ("fsdp", "mim", "fsdp", 1, None, 1),
                  ("tp", "mim", "tp", 2, None, 1),
                  ("gather", "mim", "dp", 2, "gather", 1),
                  ("ring", "mim", "dp", 2, "ring", 1),
                  ("tp gather", "mim", "tp", 2, "gather", 1),
                  ("fsdp+tp ring", "mim", "fsdp+tp", 2, "ring", 1),
                  ("pipeline", "mim", "pipeline", 2, None, 2),
                  ("vjepa ring", "vjepa", "dp", 2, "ring", 1),
                  ("vjepa pipeline", "vjepa", "pipeline", 2, None, 2),
                  ("vjepa fsdp+tp gather", "vjepa", "fsdp+tp", 2, "gather",
                   1),
                  ("lora fsdp", "lora", "fsdp", 1, None, 1),
                  ("lora fsdp+tp", "lora", "fsdp+tp", 2, None, 1))
TWO_RANK_STEPS = 2
TWO_RANK_BATCH = 2      # volumes a step (the pipeline's 2 microbatches)
TWO_RANK_KERNELS = ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd",
                    "flash_bwd_i8", "flash_fwd_i8", "mlp_fwd", "quantize",
                    "swiglu_block_fwd")
TOL_TWO_RANKS = 1e-3    # relative, a step's loss against one rank
# a parameter's gradient norm a step against one process (`grad_gap`), set
# from sound runs on the H100, where the worst gaps read 4.7e-4 under MIM's
# modes, 8.1e-3 under V-JEPA's pipeline and 5.7e-2 under its ring (the
# ring's teacher runs K1 where one process runs K3, so its targets differ);
# a gradient wrong by a factor of 2 reads 0.5 or more above the floor.
# LoRA takes MIM's bound: its adapters see the same bf16 chain
TOL_TWO_RANK_GRADS = {"mim": 1e-2, "vjepa": 0.2, "lora": 1e-2}
GRAD_FLOOR = 1e-5       # of the whole gradient's norm, `grad_gap`


def grad_shares(opt, names: dict) -> dict:
    """Each parameter's squared gradient norm as the clip reads it (after
    the step's gradient sync), as this rank's share: the norm of its local
    piece, weighted as `ClippedAdamW.clip_` weighs it, so that the shares
    of all ranks sum to the whole gradient's."""
    import torch.distributed as dist

    from smb_vision_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size
    from smb_vision_tpu_torch.parallel.sharding import local, replication

    world = dist.get_world_size() if opt.mesh is not None else 1
    stages = axis_size(opt.mesh, MODEL_AXIS) if opt.mesh is not None else 1
    return {names[id(p)]: float(local(p.grad).float().norm()) ** 2
            * (stages if id(p) in opt.stage_ids else 1)
            / replication(p.grad, world)
            for p in opt.params if p.grad is not None}


def grad_norms(shares: list) -> list:
    """Each step's per-parameter gradient norms from the ranks' shares
    (`grad_shares`: one list of steps a rank)."""
    steps = []
    for per_rank in zip(*shares):
        total: dict = {}
        for share in per_rank:
            for name, sq in share.items():
                total[name] = total.get(name, 0.0) + sq
        steps.append({name: math.sqrt(sq) for name, sq in total.items()})
    return steps


def grad_gap(got: list, want: list) -> tuple:
    """The worst gap of a parameter's gradient norm over the steps, and
    that parameter: |got - want| over want plus GRAD_FLOOR of the whole
    gradient's norm. The floor keeps the attention key biases, whose exact
    gradient is 0 (softmax ignores a common shift of a row's scores) and
    whose norm is rounding at about 3e-8 of the whole, from reading as
    gaps of their own noise. Raises when the two hold other names."""
    worst, where = 0.0, None
    for g, w in zip(got, want):
        if set(g) != set(w):
            raise AssertionError(f"gradients of {sorted(set(g) ^ set(w))} "
                                 "on one side only")
        floor = GRAD_FLOOR * math.sqrt(sum(x * x for x in w.values()))
        for name, ref in w.items():
            gap = abs(g[name] - ref) / (ref + floor)
            if gap > worst:
                worst, where = gap, name
    return worst, where


def expected_launches(mode: tuple, cfg) -> dict:
    """Each kernel's launches a step on each rank, from the code: every
    block of a stack runs its attention (K1) and its MLP (K5a) forward
    twice under remat (the forward and the recompute) and their backward
    (K4 or K7, K5b) once; a ring attention runs its kernel on 2 blocks of
    keys, and the backward's kernels on the same 2; a pipeline stage runs
    its L/S layers on each of T = M + S - 1 ticks (the bubble's included)
    forward, again in the recompute, and backward. V-JEPA's forward-only
    teacher runs K3 (its q and k quantised by R6) and K6 a layer, K1 on
    each block in the ring (`attention_with_lse` takes K1 for the int8
    spelling); each K7 quantises its q, k, v and do (4 R6 launches). The
    LoRA step of DINOv2-giant runs K1 and its SwiGLU half-block (K9) twice
    a layer under remat and K4 once; K9's backward is its plain
    version's. The policy changes none of these: every rank gathers the
    split weights whole for the kernels."""
    name, family, _, _, variant, stages = mode
    blocks = 2 if variant == "ring" else 1
    ticks = TWO_RANK_BATCH + stages - 1 if stages > 1 else 1
    zero = dict.fromkeys(TWO_RANK_KERNELS, 0)
    if family == "lora":
        layers = cfg.num_hidden_layers
        return dict(zero, flash_fwd=2 * layers, flash_bwd=layers,
                    swiglu_block_fwd=2 * layers)
    if family == "mim":
        layers = cfg.num_hidden_layers + cfg.decoder_num_hidden_layers
        per = ticks * layers // stages
        return dict(zero, flash_fwd=2 * blocks * per,
                    flash_bwd=blocks * per, mlp_train_fwd=2 * per,
                    mlp_bwd=per)
    student = ticks * (cfg.num_hidden_layers
                       + cfg.pred_num_hidden_layers) // stages
    teacher = ticks * cfg.num_hidden_layers // stages
    k3 = 0 if variant == "ring" else teacher
    k7 = blocks * student
    return dict(zero, flash_fwd=2 * blocks * student
                + (blocks * teacher if variant == "ring" else 0),
                mlp_train_fwd=2 * student, mlp_bwd=student,
                flash_bwd_i8=k7, flash_fwd_i8=k3, mlp_fwd=teacher,
                quantize=2 * k3 + 4 * k7)


def two_rank_steps(mode: tuple) -> dict:
    """TWO_RANK_STEPS steps of `mode`'s workload at full width (the
    encoder's depth TWO_RANK_LAYERS), placed by
    the Trainer under its policy (one device without a process group),
    this rank on its rows of the same seeded global batches
    (TWO_RANK_BATCH volumes) and masks (and DropPath generator); the LoRA
    family on `dinov2_batch`es, its model, adapters and head from
    `init_fn(0)`. Returns the losses, step times, launches a step, the
    peak memory and each step's `grad_shares`."""
    import torch

    from smb_vision_tpu_torch.ops.masking import mim_mask, vjepa_target_mask
    from smb_vision_tpu_torch.parallel.collectives import share_rows
    from smb_vision_tpu_torch.parallel.mesh import create_mesh, use_mesh
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import (
        Trainer,
        TrainingArguments,
    )

    name, family, policy, model_parallel, variant, stages = mode
    dev = torch.device("cuda", 0)
    sp = {} if variant is None else {"sequence_parallel": True,
                                     "sp_variant": variant}
    mesh = create_mesh(model=model_parallel, device_type="cuda")
    if family == "lora":
        from smb_vision_tpu_torch.train.lora import (
            make_lora_classification_workload,
        )

        cfg = giant_config(num_hidden_layers=TWO_RANK_LAYERS[family],
                           problem_type="single_label_classification")
        _, init_fn, step_fn, _ = make_lora_classification_workload(
            cfg, task_type="classification", device=dev, rank=LORA_RANK,
            tx=functools.partial(make_optimizer, learning_rate=1e-4,
                                 total_steps=TWO_RANK_STEPS,
                                 vision_lr=VISION_LR, merger_lr=MERGER_LR))
        draw = None
    else:
        cfg, preset = (mim_config if family == "mim" else vjepa_config)(
            num_hidden_layers=TWO_RANK_LAYERS[family], **sp)
        tx = functools.partial(
            make_optimizer, learning_rate=preset.get("learning_rate", 5e-5),
            total_steps=TWO_RANK_STEPS)
    if family == "mim":
        from smb_vision_tpu_torch.train.mim import (
            make_mim_workload,
            make_pipelined_mim_workload,
        )

        kw = dict(mask_patch_size=preset["mask_patch_size"],
                  mask_ratio=preset["mask_ratio"], tx=tx, device=dev)
        geo = dict(input_size=cfg.image_size, depth=cfg.num_frames,
                   mask_patch_size=preset["mask_patch_size"],
                   model_patch_size=cfg.patch_size,
                   mask_ratio=preset["mask_ratio"])
        _, init_fn, step_fn, _ = (
            make_pipelined_mim_workload(cfg, mesh=mesh,
                                        num_microbatches=TWO_RANK_BATCH,
                                        **kw)
            if stages > 1 else make_mim_workload(cfg, **kw))

        def draw(step):
            return mim_mask(torch.Generator().manual_seed(100 + step),
                            TWO_RANK_BATCH, **geo)
        frames, size = cfg.num_frames, cfg.image_size
    elif family == "vjepa":
        from smb_vision_tpu_torch.train.vjepa import (
            make_pipelined_vjepa_workload,
            make_vjepa_workload,
        )

        kw = dict(tx=tx, teacher_attn_impl=preset["teacher_attn_impl"],
                  ema_momentum=preset["ema_momentum"], device=dev)
        _, init_fn, step_fn, _ = (
            make_pipelined_vjepa_workload(cfg, mesh=mesh,
                                          num_microbatches=TWO_RANK_BATCH,
                                          **kw)
            if stages > 1 else make_vjepa_workload(cfg, **kw))

        def draw(step):
            return vjepa_target_mask(
                torch.Generator().manual_seed(100 + step), TWO_RANK_BATCH,
                grid=cfg.grid)
        frames, size = cfg.frames_per_clip, cfg.crop_size
    state = init_fn(0)
    trainer = Trainer(args=TrainingArguments(
        output_dir=str(ROOT / "chip_smoke_work" / "two_ranks"
                       / name.replace(" ", "_")),
        device="cuda", sharding_policy=policy,
        model_parallel=model_parallel), state=state, step_fn=step_fn,
        train_loader=None, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    opt = state["optimizer"]
    names = {id(p): n for n, p in state["model"].named_parameters()}
    shares, clip = [], opt.clip_

    def recording_clip():
        shares.append(grad_shares(opt, names))
        clip()

    opt.clip_ = recording_clip
    ws = reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with use_mesh(trainer.mesh):
        for step in range(TWO_RANK_STEPS):
            if draw is None:
                batch = {k: share_rows(v) for k, v in dinov2_batch(
                    TWO_RANK_BATCH, 300 + step, dev).items()}
                kw = {}
            else:
                batch = {"pixel_values": share_rows(torch.rand(
                    (TWO_RANK_BATCH, frames, 1, size, size), generator=gen,
                    device=dev))}
                kw = {"mask": share_rows(draw(step)).to(dev)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step_fn(state, batch,
                        torch.Generator().manual_seed(200 + step), **kw)
            losses.append(float(m["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
            del batch
    out = {"losses": losses, "step_ms": times,
           "launches": {k: ws[k].launches // TWO_RANK_STEPS
                        for k in TWO_RANK_KERNELS},
           "expected": expected_launches(mode, cfg),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
           "grad_shares": shares}
    del state, trainer, step_fn, init_fn, opt, names, clip, recording_clip
    gc.collect()
    torch.cuda.empty_cache()
    return out


def two_rank_part(mode: tuple) -> int:
    """The pair of worker processes that runs a mode of the 2-rank phase:
    MIM's modes on one, V-JEPA's and LoRA's on the other, both at once."""
    return 0 if mode[1] == "mim" else 1


def two_rank_worker(rank: int, world: int, init: str, out: Path,
                    part: int) -> None:
    """One rank of the 2-rank phase: a gloo group through a file://
    rendezvous, then `two_rank_steps` of each mode of its part
    (`two_rank_part`) in turn."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        for mode in TWO_RANK_MODES:
            if two_rank_part(mode) != part:
                continue
            t0 = time.perf_counter()
            res = two_rank_steps(mode)
            res["seconds"] = time.perf_counter() - t0
            (out / f"{mode[0].replace(' ', '_')}_{rank}.json").write_text(
                json.dumps(res))
    finally:
        dist.destroy_process_group()


def check_zero_cotangent() -> None:
    """K4 and K7 on an all-zero cotangent (a pipeline's bubble ticks and
    the masked outputs of its other stages) return exact zeros, at the
    V-JEPA encoder's head layout on one row."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, 9216, 8, 128), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    zero = torch.zeros_like(out)
    for name, fn in (("K4", A.flash_attention_bwd),
                     ("K7", A.flash_attention_bwd_i8)):
        worst = max(float(t.abs().max()) for t in fn(q, k, v, out, lse,
                                                      zero))
        if worst != 0.0:
            raise AssertionError(f"{name} on an all-zero cotangent: "
                                 f"max |grad| {worst}, not 0")
    log("K4 and K7 on an all-zero cotangent: exact zeros")


def phase_two_ranks(work: Path, card: str) -> dict:
    """The full-width MIM step (the encoder cut to TWO_RANK_LAYERS["mim"]
    layers) on 2 ranks of the one card under dp, fsdp and tp
    (model_parallel 2), sequence parallel ("gather" and "ring", the
    tokens over a model axis of 2; "gather" under tp and "ring" under
    fsdp+tp, the split weights on the same axis) and pipelined (2 stages
    x 2 microbatches), the V-JEPA preset's step (its encoder cut to
    TWO_RANK_LAYERS["vjepa"]) under the ring, the pipeline and "gather"
    under fsdp+tp, and the LoRA step of DINOv2-giant (cut to
    TWO_RANK_LAYERS["lora"]) under fsdp (2 data ranks) and fsdp+tp (2
    model ranks), each
    against this process fed the global batch on one device (the two
    pairs of ranks, `two_rank_part`, and this process's references run
    at once: no step time here is a speed): each step's
    loss within 1e-3 relative; each parameter's
    gradient norm a step (the clip's, after the sync) within
    TOL_TWO_RANK_GRADS (`grad_gap`), which a gradient wrong by a factor (a
    missing or doubled model-axis sum, a stage's broadcast counted twice)
    misses, where AdamW's update would hide it; each kernel's launches
    a step equal on both ranks and to `expected_launches` (dp, fsdp, tp
    and gather: the one process's); the peak memory per rank logged
    beside dp's (V-JEPA: beside the one process's). The ranks share one
    card, so their step times are no speed."""
    out = work / "two_ranks"
    out.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = []
    try:
        for part in sorted({two_rank_part(m) for m in TWO_RANK_MODES}):
            for r in range(2):
                lp = out / f"rank_{part}_{r}.log"
                procs.append((launch(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--two-ranks-worker", str(r), "2",
                     str(out / f"rdv_{part}"), str(out), str(part)], lp,
                    env), lp))
        check_zero_cotangent()
        refs = {}
        for family in ("mim", "vjepa", "lora"):
            mode = (f"{family} one process", family, "dp", 1, None, 1)
            ref = refs[family] = two_rank_steps(mode)
            if ref["launches"] != ref["expected"]:
                raise AssertionError(f"{mode[0]}: launches "
                                     f"{ref['launches']}, expected "
                                     f"{ref['expected']}")
            log(f"2 ranks, {family} in one process on the global batch "
                f"({TWO_RANK_BATCH} volumes; the encoder "
                f"{TWO_RANK_LAYERS[family]} layers deep): losses "
                f"{ref['losses']}, step ms "
                f"{[round(t, 1) for t in ref['step_ms']]}, peak "
                f"{ref['peak_mib']:.0f} MiB, launches a step "
                f"{ref['launches']}")
        for proc, lp in procs:
            finish(proc, lp, "2-rank phase", timeout=900)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    summary = {"refs": refs}
    for mode in TWO_RANK_MODES:
        name, family = mode[0], mode[1]
        ref = refs[family]
        res = [json.loads((out / f"{name.replace(' ', '_')}_{r}.json")
                          .read_text()) for r in range(2)]
        rel = max(abs(a - b) / abs(b) for r in res
                  for a, b in zip(r["losses"], ref["losses"]))
        gap, where = grad_gap(grad_norms([r["grad_shares"] for r in res]),
                              grad_norms([ref["grad_shares"]]))
        want = res[0]["expected"]
        same = all(r["launches"] == want for r in res)
        if name == "dp":
            dp_peak = res[0]["peak_mib"]
        beside = dp_peak if family == "mim" else ref["peak_mib"]
        log(f"2 ranks on one card, {family} {name}: losses "
            f"{res[0]['losses']} (worst rel {rel:.3e} to one process, bound "
            f"{TOL_TWO_RANKS}); gradient norms a parameter, worst gap "
            f"{gap:.3e} ({where}, bound {TOL_TWO_RANK_GRADS[family]}); "
            f"launches a step per rank {res[0]['launches']}"
            f" equal on both ranks and to the count from the code {want}: "
            f"{same}; peak per rank {[round(r['peak_mib']) for r in res]} "
            f"MiB ({'dp' if family == 'mim' else 'one process'} "
            f"{beside:.0f}); step ms per rank "
            f"{[[round(t, 1) for t in r['step_ms']] for r in res]} (two "
            f"ranks share the card: no speed); {res[0]['seconds']:.1f} s "
            f"the mode")
        if not (rel <= TOL_TWO_RANKS and gap <= TOL_TWO_RANK_GRADS[family]
                and same):
            raise AssertionError(f"2-rank {name}: rel {rel}, gradient norm "
                                 f"gap {gap} ({where}), launches "
                                 f"{[r['launches'] for r in res]} against "
                                 f"{want}")
        summary[name] = res
    log(f"2-rank phase: {time.perf_counter() - t0:.1f} s on {card}")
    return summary


LEG_J_STEPS = 8         # two epochs of the 4 volumes at batch 1
LEG_J_PROFILE = "6-7"   # two steps of epoch 1, from the device cache
LEG_J_KERNELS = ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd")
VOXELS = 512 * 512 * 320


@contextlib.contextmanager
def native_backend():
    """Inside the block, a CTDataset given the "auto" backend (the CLIs
    give no other) takes the native one, where "auto" would take the
    python backend on a CUDA device."""
    from smb_vision_tpu_torch.data import dataset

    init = dataset.CTDataset.__init__

    def native_init(self, *args, backend="auto", **kw):
        init(self, *args, backend="native" if backend == "auto" else backend,
             **kw)

    dataset.CTDataset.__init__ = native_init
    try:
        yield
    finally:
        dataset.CTDataset.__init__ = init


@contextlib.contextmanager
def watch_data_path():
    """Inside the block, keep each DeviceCachedBatchLoader made and, for
    each uint8 decode of the Trainer's step, (the codes' dtype, their
    device, the decoded dtype). Yields (loaders, decodes)."""
    from smb_vision_tpu_torch.data import dataset, quantization

    loaders, decodes = [], []
    init = dataset.DeviceCachedBatchLoader.__init__
    decode = quantization.dequantize_batch

    def kept_init(self, *args, **kw):
        init(self, *args, **kw)
        loaders.append(self)

    def watched_decode(batch, *args, **kw):
        px = batch["pixel_values"]
        out = decode(batch, *args, **kw)
        decodes.append((px.dtype, px.device.type,
                        out["pixel_values"].dtype))
        return out

    dataset.DeviceCachedBatchLoader.__init__ = kept_init
    quantization.dequantize_batch = watched_decode
    try:
        yield loaders, decodes
    finally:
        dataset.DeviceCachedBatchLoader.__init__ = init
        quantization.dequantize_batch = decode


def run_leg_j(work: Path, vols: Path, table: dict) -> None:
    """Leg J, the MIM data path and the HF round trip at full width:
    run_mim with a copy of configs/mim_base_512.json on the 4 volumes
    (all 4 to train), LEG_J_STEPS steps at batch 1 with --input_dtype
    uint8 --device_cache --cache_data_dir (a uint8 cache) --export_hf
    --profile_steps LEG_J_PROFILE, the datasets asked for the native
    backend (`native_backend`: "auto" takes the python one on the card).
    Asserts: the dataset took the native backend (the C++ loader, on this
    machine's CPU), its library built in this run from the checkout's
    source (`phase_build` removed any earlier build); epoch 1 made no host load and
    the cache on the card holds 4 volumes of uint8 codes; every batch
    reached the step as uint8 codes on the card, decoded there to
    bfloat16; K1, K4, K5a and K5b launched; finite losses; the trace and
    hf_model.safetensors were written. Then run_inference on the 4 volumes
    with the saved config, from model.safetensors and from
    hf_model.safetensors (K1 and K6): the embeddings equal bit for bit."""
    import numpy as np
    import torch

    from smb_vision_tpu_torch.cli.run_inference import main as run_inference
    from smb_vision_tpu_torch.cli.run_mim import main as run_mim
    from smb_vision_tpu_torch.data import build_native

    spec = work / "mim_data.json"
    spec.write_text(json.dumps({"train": [
        {"image": str(p)} for p in sorted(vols.glob("*.nii"))]}))
    out, cache = work / "mim_out_J", work / "cache_j"
    preset = json.loads(MIM_PRESET.read_text())
    path = work / "mim_J.json"
    path.write_text(json.dumps(dict(
        preset, json_path=str(spec), output_dir=str(out),
        num_train_steps=LEG_J_STEPS, save_steps=LEG_J_STEPS,
        logging_steps=1, train_val_split=0.0, input_dtype="uint8",
        device_cache=True, cache_data_dir=str(cache), cache_dtype="uint8",
        export_hf=True, profile_steps=LEG_J_PROFILE)))
    ws = reset_launches()
    t0 = time.perf_counter()
    with native_backend(), watch_data_path() as (loaders, decodes):
        res = run_mim([str(path)])
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    log(f"leg J: {res} in {wall:.1f} s (native decode + uint8 cache + "
        f"train from the device cache + trace + both exports); launches "
        f"{counts}")
    (loader,) = loaders
    lib = build_native.library_path()
    if loader.ds.backend != "native" or not (
            lib.is_file() and lib.stat().st_mtime >= SCRIPT_START):
        raise AssertionError(f"leg J: backend {loader.ds.backend!r}, "
                             f"library {lib} built in this run: "
                             f"{lib.is_file()}")
    log(f"leg J: CTDataset backend native (the C++ loader on this "
        f"machine's CPU), library {lib.relative_to(ROOT)} built in this run "
        f"from csrc/ctloader.cpp")
    if loader.host_loads != {0: N_VOLUMES, 1: 0}:
        raise AssertionError(f"leg J: host loads by epoch "
                             f"{loader.host_loads}")
    cached = list(loader._dev.values())
    held = sum(e[0].numel() * e[0].element_size() for e in cached)
    if len(cached) != N_VOLUMES or held != N_VOLUMES * VOXELS or any(
            e[0].dtype != torch.uint8 or e[0].device.type != "cuda"
            for e in cached):
        raise AssertionError(f"leg J: device cache {len(cached)} volumes, "
                             f"{held} bytes")
    log(f"leg J: host loads by epoch {loader.host_loads}; the cache on the "
        f"card holds {len(cached)} volumes of uint8 codes, {held} bytes "
        f"({held / 1e6:.1f} MB)")
    if len(decodes) != LEG_J_STEPS or set(decodes) != {
            (torch.uint8, "cuda", torch.bfloat16)}:
        raise AssertionError(f"leg J: step decodes {decodes}")
    for name in LEG_J_KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"leg J: kernel {name} never launched")
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    if [r["step"] for r in train] != list(range(1, LEG_J_STEPS + 1)) or \
            not all(math.isfinite(r["loss"]) for r in train):
        raise AssertionError(f"leg J: step records {train}")
    times = [r["step_time_ms"] for r in train]
    half = LEG_J_STEPS // 2
    log(f"leg J: step ms {[round(t, 1) for t in times]}; epoch 0 (host "
        f"loads) mean {statistics.mean(times[:half]):.1f}, epoch 1 (device "
        f"cache; steps {LEG_J_PROFILE} under the profiler) mean "
        f"{statistics.mean(times[half:]):.1f}, its unprofiled steps "
        f"{times[half]:.1f} and {times[-1]:.1f}; losses "
        f"{[round(r['loss'], 6) for r in train]}")
    traces = list((out / "profile").glob("trace_*.json"))
    if not traces or not (out / "hf_model.safetensors").is_file():
        raise AssertionError(f"leg J: traces {traces}, hf_model.safetensors "
                             f"{(out / 'hf_model.safetensors').is_file()}")
    sizes = {f.name: f.stat().st_size for f in
             [*traces, out / "model.safetensors",
              out / "hf_model.safetensors"]}
    log(f"leg J: bytes written {sizes}")
    embs = {}
    for name in ("model.safetensors", "hf_model.safetensors"):
        emb = work / f"emb_J_{name.split('.')[0]}"
        ws = reset_launches()
        t0 = time.perf_counter()
        stats = run_inference([
            "--data_dir", str(vols), "--output_dir", str(emb),
            "--config_path", str(out / "config.json"),
            "--model_name_or_path", str(out / name), "--batch_size", "2",
            "--device", "cuda", "--num_workers", "2",
            "--cache_data_dir", str(cache), "--cache_dtype", "uint8"])
        counts = {n: w.launches for n, w in ws.items()}
        log(f"leg J: run_inference from {name}: {stats} in "
            f"{time.perf_counter() - t0:.1f} s; launches {counts}")
        if stats["embedded"] != N_VOLUMES or not (
                counts["flash_fwd"] > 0 and counts["mlp_fwd"] > 0):
            raise AssertionError(f"leg J inference from {name}: {stats}, "
                                 f"{counts}")
        embs[name] = {f.name: np.load(f) for f in sorted(emb.glob("*.npy"))}
    a, b = embs.values()
    if a.keys() != b.keys() or len(a) != N_VOLUMES or not all(
            np.array_equal(a[k], b[k]) and np.isfinite(a[k]).all()
            for k in a):
        raise AssertionError("leg J: the embeddings from model.safetensors "
                             "and hf_model.safetensors differ")
    log(f"leg J: the {len(a)} embeddings from model.safetensors and "
        f"hf_model.safetensors are equal bit for bit")
    shutil.rmtree(out)


def phase_train_throughput(card: str, iters: int = 3) -> None:
    """MIM steps of the preset at batch 1 and 2, as shipped and with
    glue_impl "pallas" (leg H's model): CUDA events over `iters` seeded
    steps after one warm-up, MFU against the card's dense bf16 peak, peak
    memory, and one step under the profiler; the workloads built and
    initialised on the card (`on_card_init`)."""
    import torch

    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import mim_flops_per_sample

    dev = torch.device("cuda")
    for glue, bs in ((False, 1), (True, 1), (False, 2), (True, 2)):
        cfg, preset = mim_config(**({"glue_impl": "pallas"} if glue else {}))
        flops = mim_flops_per_sample(cfg, preset["mask_ratio"])
        model, init_fn, step_fn, _ = on_card_init(functools.partial(
            make_mim_workload, cfg,
            mask_patch_size=preset["mask_patch_size"],
            mask_ratio=preset["mask_ratio"], tx=functools.partial(
                make_optimizer, learning_rate=preset["learning_rate"],
                total_steps=100, warmup_ratio=preset["warmup_ratio"],
                weight_decay=preset["weight_decay"]), device=dev), dev)
        state = init_fn(0)
        gen = torch.Generator(device=dev).manual_seed(3)
        pxs = [torch.rand((bs, cfg.num_frames, 1, cfg.image_size,
                           cfg.image_size), generator=gen, device=dev)
               for _ in range(iters + 1)]

        def step(i):
            return step_fn(state, {"pixel_values": pxs[i]},
                           step_generator(0, i))

        time_train_steps("MIM" + (" glue" if glue else ""), card, bs, flops,
                         step, iters, watch=GLUE_KERNELS if glue else ())
        del model, init_fn, step_fn, state, pxs, step
        torch.cuda.empty_cache()


def time_train_steps(label: str, card: str, bs: int, flops: float, step,
                     iters: int, watch: tuple = ()) -> tuple:
    """step(0) as warm-up, then CUDA events over step(1) .. step(iters):
    ms a step, MFU against the card's dense bf16 peak (analytic FLOPs a
    sample, no remat recompute) and peak memory; then step(0) once under
    the profiler. Returns (ms a step, peak GiB)."""
    import torch

    from smb_vision_tpu_torch.utils.profiling import device_peak_flops

    step(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(i)["loss"] for i in range(1, iters + 1)]
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(float(x)) for x in losses):
        raise AssertionError(f"{label} batch {bs}: losses {losses}")
    peak = device_peak_flops(torch.device("cuda"))
    mfu = flops * bs / (ms / 1e3) / peak if peak else None
    log(f"{label} train step batch {bs}: {ms:.1f} ms = {1e3 / ms:.3f} "
        f"steps/s, {bs * 1e3 / ms:.3f} volumes/s, MFU {mfu} "
        f"({flops / 1e12:.2f} TFLOP/sample analytic, no remat "
        f"recompute), peak {mem:.1f} GiB, on {card}")
    profile_call(lambda: step(0), f"{label} train step batch {bs}", top=10,
                 watch=watch)
    return ms, mem


def vjepa_workload(cfg, preset: dict, dev, teacher_attn_impl,
                   optim: str = "adamw"):
    """make_vjepa_workload with the preset's optimizer (no warm-up, so the
    first update moves the weights; AdamW or `optim`) and EMA momentum,
    built and initialised on the card (`on_card_init`)."""
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.vjepa import make_vjepa_workload

    make = functools.partial(
        make_vjepa_workload, cfg, tx=functools.partial(
            make_optimizer, learning_rate=preset["learning_rate"],
            total_steps=100, weight_decay=preset["weight_decay"],
            schedule=preset["lr_scheduler_type"], min_lr=preset["min_lr"],
            optim=optim),
        ema_momentum=preset["ema_momentum"],
        teacher_attn_impl=teacher_attn_impl, device=dev)
    return on_card_init(make, dev)


def on_card_init(make, dev):
    """make() (a make_*_workload bound to its arguments) with the model
    built on the card and init_fn's weights drawn there, from a CUDA
    generator of init_fn's seed (other weights than a CPU generator's):
    a CPU initialisation of ViT-H's 0.63 B parameters takes most of a
    minute. Returns the workload, its init_fn wrapped."""
    import torch

    with torch.device(dev):
        model, init_fn, *rest = make()

    def init(seed: int) -> dict:
        # only for the call: a model holding a closure over itself is a
        # reference cycle, freed by a garbage collection inside some
        # later timed step instead of when the phase drops it
        gen = torch.Generator(device=dev).manual_seed(seed)
        model.init_weights = lambda _: type(model).init_weights(model, gen)
        try:
            return init_fn(seed)
        finally:
            del model.init_weights

    return (model, init, *rest)


# one step of one process, by family (`expected_launches`' mode: no
# split, no ring, no pipeline)
ONE_STEP = {family: ("one step", family, "dp", 1, None, 1)
            for family in ("mim", "vjepa")}


def check_vit_h_launches(what: str, ws: dict, want: dict, layers: int,
                         bwd: str, plain: dict, steps: int = 1) -> dict:
    """A path at ViT-H widths launched each kernel as `expected_launches`
    (want, a step) gives, over `steps` steps: K1 at d 80 twice an encoder
    layer (forward and remat recompute), its backward `bwd` (K4 or K7) at
    d 80 and K5a and K5b at K 1,280 once (K5a twice) an encoder layer and
    step, V-JEPA's teacher K3 at d 80 once; the plain attention never
    (plain, `plain_attention_calls`). Returns the launches by width."""
    got = {name: ws[name].launches for name in want}
    want = {name: n * steps for name, n in want.items()}
    by_width = {f"flash_fwd d{VIT_H_D}": 2, f"{bwd} d{VIT_H_D}": 1,
                f"mlp_train_fwd K{VIT_H_K}": 2, f"mlp_bwd K{VIT_H_K}": 1}
    if bwd == "flash_bwd_i8":
        by_width[f"flash_fwd_i8 d{VIT_H_D}"] = 1
    for row, per in by_width.items():
        name, width = row.split()
        got[row] = ws[name].launches_by_width.get(int(width[1:]), 0)
        want[row] = per * layers * steps
    log(f"{what}: launches {got} (want {want}); plain attention calls "
        f"{plain}")
    if got != want or plain:
        raise AssertionError(f"{what}: launches {got}, want {want}; plain "
                             f"attention calls {plain}")
    return got


@contextlib.contextmanager
def plain_kernels():
    """Inside the block every kernel the parity phases reach (K1, K4, K7,
    K3, K8 with their quantisation, K2, K5a, K5b, K6, K9, K10a, K10b, the
    two W8A8 kernels) runs its plain PyTorch version
    on the card, under the same impl names: the reference of the step
    parity phases. This swaps module attributes for the phase only; the
    package has no such switch and never falls back."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import attn_glue as G
    from smb_vision_tpu_torch.ops import mlp as M
    from smb_vision_tpu_torch.ops import quant as Q

    def scale_of(q, scale):
        return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale

    swaps = {
        (A, "_flash_fwd"): lambda q, k, v, scale, with_lse: A.xla_attention(
            q, k, v, scale=scale, with_lse=with_lse),
        (A, "flash_attention_bwd_i8"):
            lambda q, k, v, out, lse, do, *, scale=None, g_lse=None:
            A.attention_bwd_i8_plain(q, k, v, out, lse, do,
                                     scale=scale_of(q, scale), g_lse=g_lse),
        (A, "flash_attention_int8"): lambda q, k, v, *, scale=None:
            A.int8_attention_plain(*plain_qk(q, k, scale_of(q, scale)), v),
        (M, "_mlp_fwd"): lambda x2, w1, b1, w2, b2, act: M._mlp_xla(
            x2.to(torch.bfloat16), w1, b1, w2, b2, act),
        (M, "mlp_train_fused"): lambda x2, w1, b1, w2, b2, *, act="gelu":
            M._mlp_train_plain(x2, w1, b1, w2, b2, act),
        (M, "mlp_bwd_fused"): lambda h, g2, w1, w2, *, act="gelu":
            M._mlp_bwd_plain(h, g2, w1, w2, act),
        (A, "flash_attention_bwd"):
            lambda q, k, v, out, lse, do, *, scale=None, g_lse=None:
            A.attention_bwd_plain(q, k, v, out, lse, do,
                                  scale=scale_of(q, scale), g_lse=g_lse),
        (M, "_swiglu_block_fwd"): M._swiglu_block_plain,
        (A, "flash_attention_int8pv"): lambda q, k, v, *, scale=None:
            A.int8pv_attention_plain(*plain_qk(q, k, scale_of(q, scale)),
                                     *A.quantize_per_head(v)),
        (M, "_mlp_block_fwd"): lambda x2, lnw, lnb, w1, b1, w2, b2, act, eps:
            M._mlp_block_xla(x2.to(torch.bfloat16), lnw, lnb, w1, b1, w2, b2,
                             act, eps),
        (G, "_qkv_fwd"): G._qkv_ln_plain,
        (G, "_out_fwd"): G._out_res_plain,
        (Q, "quantize_rows_kernel"): Q.quantize_rows_plain,
        (Q, "w8a8_gemm_kernel"): Q.w8a8_linear_plain,
    }
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


VJEPA_KERNELS = ("flash_fwd", "flash_bwd_i8", "mlp_train_fwd", "mlp_bwd",
                 "flash_fwd_i8", "mlp_fwd", "quantize")


def check_vjepa_launches(what: str, counts: dict) -> None:
    """The V-JEPA step's kernels launched, and K4 did not: the student's
    backward is K7."""
    missing = [n for n in VJEPA_KERNELS if counts[n] <= 0]
    if missing or counts["flash_bwd"]:
        raise AssertionError(f"{what}: launches {counts}")


def phase_vjepa_parity(ref: bool = False, vit_h: bool = False) -> None:
    """One V-JEPA step of the preset (forward, backward, AdamW update, EMA;
    the encoder cut to VJEPA_PARITY_LAYERS layers, the predictor whole)
    at batch 1 on one seeded volume and target mask, from the same seeded
    weights: through the kernels, through their plain versions under the
    same impl names (`plain_kernels`), and in float32 with the plain
    attention and MLP (TF32 off). Holds the loss and the gradient over
    all student parameters, and the EMA teacher's change against the
    student's update. ref: the reference-head preset under LEG_I_IMPLS,
    whose predictor must run K1 and K7 at d 32 in every layer. vit_h: the
    _tpu preset's encoder at ViT-H widths (VIT_H_VJEPA): K1, K7 and K3 at
    d 80, K5a and K5b at K 1,280, each kernel's launches as
    `expected_launches` gives them, the plain attention never on the
    kernel path. The workloads are built and initialised on the card
    (`on_card_init`)."""
    import torch

    from smb_vision_tpu_torch.ops.masking import vjepa_target_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    path = VJEPA_REF_PRESET if ref else VJEPA_PRESET
    impl = {"attn_impl": LEG_I_IMPLS["attn_impl"]} if ref else {}

    def config(**kw):
        return (vjepa_ref_config if ref else vjepa_config)(**{
            **impl, **(VIT_H_VJEPA if vit_h else {}),
            "num_hidden_layers": VJEPA_PARITY_LAYERS, **kw})

    cfg0, preset = config()
    teacher_impl = LEG_I_IMPLS["teacher_attn_impl"] if ref else preset[
        "teacher_attn_impl"]
    if cfg0.seq_len != VJ_N:
        raise AssertionError(f"the preset has {cfg0.seq_len} tokens")
    gen = torch.Generator(device=dev).manual_seed(4)
    px = torch.rand((1, cfg0.frames_per_clip, 1, cfg0.crop_size,
                     cfg0.crop_size), generator=gen, device=dev)
    mask = vjepa_target_mask(torch.Generator().manual_seed(0), 1,
                             grid=cfg0.grid)
    momentum = preset["ema_momentum"]

    def step(teacher_attn_impl, **kw):
        cfg, _ = config(**kw)
        _, init_fn, step_fn, _ = vjepa_workload(cfg, preset, dev,
                                                teacher_attn_impl)
        state = init_fn(0)
        model, teacher, opt = (state["model"], state["teacher"],
                               state["optimizer"])
        s0 = [p.detach().clone() for p in model.parameters()]
        t0 = [p.detach().clone() for p in teacher.parameters()]
        grads, clip = [], opt.clip_

        def snapshot():     # the raw gradient, before the global-norm clip
            if any(p.grad is None for p in opt.params):
                raise AssertionError(f"{kw or 'kernel path'}: a parameter "
                                     "got no gradient")
            grads.append(torch.cat([p.grad.float().flatten()
                                    for p in opt.params]))
            clip()

        opt.clip_ = snapshot
        loss = float(step_fn(state, {"pixel_values": px}, mask=mask)["loss"])
        del opt.clip_       # drops the snapshot's reference cycle
        ds = torch.cat([(p.detach() - a).flatten()
                        for p, a in zip(model.parameters(), s0)])
        dt = torch.cat([(p.detach() - a).flatten()
                        for p, a in zip(teacher.parameters(), t0)])
        ema = (float(dt.norm()) / float(ds.norm()), float(dt.abs().max()))
        del state, model, teacher, opt, s0, t0, ds, dt
        torch.cuda.empty_cache()
        return loss, grads[0], ema

    ws = reset_launches()
    t0 = time.perf_counter()
    with plain_attention_calls() as plain:
        k_loss, k_grad, (ratio, dt_max) = step(teacher_impl)
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    counts.update(d32_launches(ws))
    check_vjepa_launches("V-JEPA step", counts)
    if ref:
        check_d32_launches("V-JEPA step, reference heads", counts, plain, 1)
    if vit_h:
        check_vit_h_launches("ViT-H V-JEPA step", ws, expected_launches(
            ONE_STEP["vjepa"], cfg0), cfg0.num_hidden_layers,
            "flash_bwd_i8", plain)
    ws = reset_launches()
    with plain_kernels():
        p_loss, p_grad, _ = step(teacher_impl)
    if any(w.launches for w in ws.values()):
        raise AssertionError("the plain path launched a kernel")
    f_loss, f_grad, _ = step(None, attn_impl="xla", mlp_impl="xla",
                             dtype="float32")
    norm = float(f_grad.norm())
    k_err = float((k_grad - f_grad).norm()) / norm
    p_err = float((p_grad - f_grad).norm()) / norm
    rel_loss = abs(k_loss - p_loss) / abs(p_loss)
    log(f"V-JEPA parity, one step of {path.name} (the encoder "
        f"{cfg0.num_hidden_layers} layers deep"
        f"{', at ViT-H widths' if vit_h else ''}) at batch 1 "
        f"({int(mask.sum())} of {VJ_N} tokens are targets): loss kernels "
        f"{k_loss:.6f}, plain versions {p_loss:.6f}, f32 {f_loss:.6f}; rel "
        f"{rel_loss:.3e} (bound {TOL_TRAIN_LOSS}); gradient error vs f32 "
        f"over {k_grad.numel()} student parameters: kernels {k_err:.3e}, "
        f"plain versions {p_err:.3e} (bound {TOL_TRAIN_GRAD_VS_F32} x "
        f"plain); EMA: ||teacher change|| / ||student update|| {ratio:.4e} "
        f"(1 - momentum = {1 - momentum:.4e}), max|teacher change| "
        f"{dt_max:.3e}; kernel step {wall:.1f} s with the first calls; "
        f"launches {counts}")
    if not (bool(k_grad.isfinite().all()) and math.isfinite(k_loss)):
        raise AssertionError("the kernel path's loss or gradient is not "
                             "finite")
    if not rel_loss <= TOL_TRAIN_LOSS:
        raise AssertionError(f"V-JEPA loss rel {rel_loss}")
    if not k_err <= TOL_TRAIN_GRAD_VS_F32 * p_err:
        raise AssertionError(f"V-JEPA kernel gradients are {k_err} from "
                             f"float32, the plain versions' {p_err}")
    expected = 1.0 - momentum
    if not expected / TOL_EMA_RATIO <= ratio <= expected * TOL_EMA_RATIO:
        raise AssertionError(f"EMA: the teacher moved {ratio} of the "
                             f"student's update, not ~{expected}")


def run_vjepa_leg(work: Path, vols: Path, leg: str, preset_path: Path,
                  cuts: dict, impls: dict | None = None,
                  export_hf: bool = False) -> dict:
    """run_vjepa on the volumes (3 to train, 1 to evaluate) with a copy of
    the preset at preset_path, the keys of `cuts` cut (each logged with the
    preset's value), `impls` added, and one checkpoint kept (each holds the
    student, the teacher and the AdamW moments, ~5 GB at ViT-L): 2 steps, a
    checkpoint every 2, eval; then the same to 4 steps, which resumes at 2
    (LEG_V_STEPS).
    Asserts the logs, the checkpoints and the export (with export_hf also
    the HF layout's, `hf_model.safetensors`, which is kept with
    config.json; the rest of the output is deleted). Returns the launch
    counts of the first run, the d-32 rows' among them (`d32_launches`)."""
    import numpy as np
    import torch

    from smb_vision_tpu_torch.cli.run_vjepa import main as run_vjepa
    from smb_vision_tpu_torch.models.convert import read_safetensors
    from smb_vision_tpu_torch.train.trainer import Trainer

    nii = [{"image": str(p)} for p in sorted(vols.glob("*.nii"))]
    spec = work / f"vjepa_data_{leg}.json"
    spec.write_text(json.dumps({"train": nii[:3], "validation": nii[3:]}))
    out = work / f"vjepa_out_{leg}"
    preset = json.loads(preset_path.read_text())
    log(f"leg {leg}: {preset_path.name} with "
        + ", ".join(f"{k} cut from {preset[k]} to {v}"
                    for k, v in cuts.items())
        + f", save_total_limit 1{', ' if impls else ''}"
        + ", ".join(f"{k} {v}" for k, v in (impls or {}).items())
        + f", on {len(nii)} volumes resampled to {preset['image_size']}^2 x "
        f"{preset['depth']}")

    def run(steps):
        path = work / f"vjepa_{leg}_{steps}.json"
        path.write_text(json.dumps(dict(
            preset, **cuts, **(impls or {}), data_path=str(spec),
            output_dir=str(out), num_train_steps=steps, save_steps=2,
            save_total_limit=1, logging_steps=1, do_eval=True,
            num_workers=2, export_hf=export_hf)))
        t0 = time.perf_counter()
        res = run_vjepa([str(path)])
        return res, time.perf_counter() - t0

    first, last = LEG_V_STEPS
    ws = reset_launches()
    res1, wall1 = run(first)
    counts = {name: w.launches for name, w in ws.items()}
    counts.update(d32_launches(ws))
    ckpts1 = Trainer.checkpoint_steps(out / "checkpoints")
    res2, wall2 = run(last)
    log(f"leg {leg}: {res1} in {wall1:.1f} s, resumed {res2} in "
        f"{wall2:.1f} s (preprocess + train + eval + save); launches of the "
        f"first run {counts}")
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    for r in train:
        log(f"  step {r['step']}: loss {r['loss']:.6f}, "
            f"{r['step_time_ms']:.1f} ms, mfu {r.get('mfu')}")
    if [r["step"] for r in train] != list(range(1, last + 1)):
        raise AssertionError(f"leg {leg} logged steps "
                             f"{[r['step'] for r in train]}")
    for r in train:
        if not (math.isfinite(r["loss"]) and r.get("mfu", 0) > 0):
            raise AssertionError(f"leg {leg} step record {r}")
    for res in (res1, res2):
        if not math.isfinite(res.get("eval_loss", math.nan)):
            raise AssertionError(f"leg {leg} eval: {res}")
    ckpts = Trainer.checkpoint_steps(out / "checkpoints")
    if ckpts1 != [first] or ckpts != [last] or res2["train_steps"] != last:
        raise AssertionError(f"leg {leg} checkpoints {ckpts1} then {ckpts}, "
                             f"result {res2}")
    blob = torch.load(out / "checkpoints" / str(last) / "state.pt",
                      map_location="cpu", weights_only=True, mmap=True)
    if not {"model", "teacher", "optimizer"} <= set(blob):
        raise AssertionError(f"leg {leg} checkpoint holds {sorted(blob)}")
    del blob
    export = read_safetensors(out / "model.safetensors")
    if not (out / "config.json").exists() or not all(
            np.isfinite(v).all() for v in export.values()):
        raise AssertionError(f"leg {leg}: config.json or a finite "
                             "model.safetensors is missing")
    files = sorted(f"{p.relative_to(out)} ({p.stat().st_size / 2**20:.0f} "
                   f"MiB)" for p in out.rglob("*") if p.is_file())
    log(f"leg {leg}: checkpoints {ckpts1} then {ckpts} (with the EMA "
        f"teacher), model.safetensors {len(export)} tensors; files "
        f"{files}")
    if export_hf:
        hf = read_safetensors(out / "hf_model.safetensors")
        if not (any(k.startswith("predictor.layer.") for k in hf)
                and all(np.isfinite(v).all() for v in hf.values())):
            raise AssertionError(f"leg {leg}: hf_model.safetensors holds "
                                 f"{len(hf)} tensors, or a non-finite one")
        for f in out.iterdir():
            if f.name not in ("hf_model.safetensors", "config.json"):
                shutil.rmtree(f) if f.is_dir() else f.unlink()
    else:
        shutil.rmtree(out)
    return counts


def run_leg_d(work: Path, vols: Path, table: dict) -> None:
    """Leg D: `run_vjepa_leg` with configs/vjepa_large_384_tpu.json,
    accumulation cut to LEG_D_ACCUM and the encoder to LEG_V_LAYERS
    layers, and --export_hf (leg K starts from
    that export); the V-JEPA kernels launch, K4 not."""
    counts = run_vjepa_leg(work, vols, "D", VJEPA_PRESET,
                           {"num_hidden_layers": LEG_V_LAYERS,
                            "gradient_accumulation_steps": LEG_D_ACCUM},
                           export_hf=True)
    check_vjepa_launches("leg D", counts)
    table["flash_bwd_i8"]["launches"] = counts["flash_bwd_i8"]


def run_leg_k(work: Path, vols: Path, table: dict) -> None:
    """Leg K, continued V-JEPA pretraining from an HF-layout export:
    run_vjepa with leg D's config (accumulation LEG_D_ACCUM, the encoder
    at LEG_V_LAYERS layers),
    --model_name_or_path leg D's hf_model.safetensors, --input_dtype
    uint8 --device_cache, 2 steps. Asserts: every student tensor loaded
    and none of the student skipped; the EMA teacher starts equal to the
    loaded student; K7, K3 and the quantisation kernel launched; finite
    losses."""
    import torch

    from smb_vision_tpu_torch.cli.run_vjepa import main as run_vjepa
    from smb_vision_tpu_torch.models import convert
    from smb_vision_tpu_torch.train import trainer as trainer_mod

    hf = work / "vjepa_out_D" / "hf_model.safetensors"
    nii = [{"image": str(p)} for p in sorted(vols.glob("*.nii"))]
    spec = work / "vjepa_data_K.json"
    spec.write_text(json.dumps({"train": nii[:3], "validation": nii[3:]}))
    out = work / "vjepa_out_K"
    path = work / "vjepa_K.json"
    path.write_text(json.dumps(dict(
        json.loads(VJEPA_PRESET.read_text()),
        num_hidden_layers=LEG_V_LAYERS,
        gradient_accumulation_steps=LEG_D_ACCUM, data_path=str(spec),
        output_dir=str(out), num_train_steps=2, save_steps=2,
        save_total_limit=1, logging_steps=1, num_workers=2,
        model_name_or_path=str(hf), input_dtype="uint8",
        device_cache=True)))
    grafts, starts = [], []
    graft, init = convert.load_params_into, trainer_mod.Trainer.__init__

    def watched_graft(model, src, **kw):
        loaded, skipped = graft(model, src, **kw)
        grafts.append((set(model.state_dict()), set(loaded), skipped))
        return loaded, skipped

    def watched_init(self, *args, **kw):
        init(self, *args, **kw)
        student = self.state["model"].state_dict()
        teacher = self.state["teacher"].state_dict()
        starts.append(student.keys() == teacher.keys() and all(
            torch.equal(v, teacher[k]) for k, v in student.items()))

    ws = reset_launches()
    convert.load_params_into = watched_graft
    trainer_mod.Trainer.__init__ = watched_init
    t0 = time.perf_counter()
    try:
        res = run_vjepa([str(path)])
    finally:
        convert.load_params_into = graft
        trainer_mod.Trainer.__init__ = init
    wall = time.perf_counter() - t0
    counts = {name: w.launches for name, w in ws.items()}
    log(f"leg K: {res} in {wall:.1f} s (load the HF export + decode "
        f"and resample on the card + 2 steps from the device cache + checkpoint); launches "
        f"{counts}")
    (student, loaded, skipped), = grafts
    if loaded != student or skipped:
        raise AssertionError(f"leg K: loaded {len(loaded)} of the "
                             f"student's {len(student)} tensors; missing "
                             f"{sorted(student - loaded)[:5]}; checkpoint "
                             f"tensors unused {skipped[:5]}")
    if starts != [True]:
        raise AssertionError("leg K: the EMA teacher does not start equal "
                             "to the loaded student")
    log(f"leg K: {len(loaded)} of {len(student)} student tensors loaded "
        f"from {hf.name}, none skipped, none of the checkpoint unused; the "
        f"teacher starts equal to the student")
    for name in ("flash_bwd_i8", "flash_fwd_i8", "quantize"):
        if counts[name] <= 0:
            raise AssertionError(f"leg K: kernel {name} never launched")
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    if [r["step"] for r in train] != [1, 2] or not all(
            math.isfinite(r["loss"]) for r in train):
        raise AssertionError(f"leg K: step records {train}")
    log(f"leg K: losses {[r['loss'] for r in train]}, step ms "
        f"{[round(r['step_time_ms'], 1) for r in train]}")
    shutil.rmtree(out)


def check_d32_launches(what: str, counts: dict, plain: dict, micro: int,
                       bwd: str = "flash_bwd_i8 d32") -> None:
    """The reference-head predictor ran on the d-32 kernels in every
    layer: over `micro` micro-batches its backward kernel `bwd` (K7, or K4
    under "auto") launched PRED_LAYERS times each and the other not at all,
    K1 at d 32 at least twice as often (forward and remat recompute, and
    any eval) in whole multiples of PRED_LAYERS, and the plain attention
    never ran at d 32."""
    other = ({"flash_bwd d32", "flash_bwd_i8 d32"} - {bwd}).pop()
    fwd = counts["flash_fwd d32"]
    if (counts[bwd] != PRED_LAYERS * micro or counts[other]
            or fwd < 2 * counts[bwd] or fwd % PRED_LAYERS
            or plain.get(32, 0)):
        raise AssertionError(f"{what}: d-32 launches {counts} over {micro} "
                             f"micro-batches, plain attention calls by "
                             f"head width {plain}")


def run_leg_i(work: Path, vols: Path, table: dict) -> None:
    """Leg I: `run_vjepa_leg` with configs/vjepa_large_384.json (the
    reference heads: the predictor at 12 heads of 32) under the impls its
    `_comment` recommends (LEG_I_IMPLS), micro-batch and accumulation cut
    (LEG_I_CUTS). The V-JEPA kernels launch, K1 and K7 at d 32 in every
    predictor layer, and the plain attention never runs."""
    with plain_attention_calls() as plain:
        counts = run_vjepa_leg(work, vols, "I", VJEPA_REF_PRESET, LEG_I_CUTS,
                               LEG_I_IMPLS)
    check_vjepa_launches("leg I", counts)
    check_d32_launches("leg I", counts, plain, LEG_V_STEPS[0]
                       * LEG_I_CUTS["gradient_accumulation_steps"])
    log(f"leg I: plain attention calls {plain}; d-32 launches "
        f"{d32_launches(wrappers())} over both runs")
    for row in ("flash_fwd d32", "flash_bwd_i8 d32"):
        table[row]["launches"] = counts[row]


def phase_vjepa_throughput(card: str, iters: int = 3) -> None:
    """V-JEPA steps of the preset at batch 1 and 2 (no accumulation), and
    at batch 2 under the 8-bit AdamW: at batch 2 also the moments' bytes
    and the optimizer update's own time (CUDA events over its step() on
    the last step's gradients, and the host's time to issue it) and share
    of the step; the workloads built and initialised on the card
    (`on_card_init`)."""
    import torch

    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import vjepa_flops_per_sample

    dev = torch.device("cuda")
    cfg, preset = vjepa_config()
    flops = vjepa_flops_per_sample(cfg)
    for bs, optim in ((1, "adamw"), (2, "adamw"), (2, "adamw8bit")):
        _, init_fn, step_fn, _ = vjepa_workload(
            cfg, preset, dev, preset["teacher_attn_impl"], optim=optim)
        state = init_fn(0)
        gen = torch.Generator(device=dev).manual_seed(5)
        pxs = [torch.rand((bs, cfg.frames_per_clip, 1, cfg.crop_size,
                           cfg.crop_size), generator=gen, device=dev)
               for _ in range(iters + 1)]

        def step(i):
            return step_fn(state, {"pixel_values": pxs[i]},
                           step_generator(0, i))

        ms, mem = time_train_steps(f"V-JEPA {optim}", card, bs, flops, step,
                                   iters)
        if bs == 2:
            opt = state["optimizer"].opt
            opt_ms = cuda_ms(opt.step, iters=3, warmup=1)
            host = host_ms(opt.step, calls=3)
            moments = sum(t.numel() * t.element_size()
                          for s in opt.state.values()
                          for k, t in s.items() if k != "step")
            log(f"V-JEPA {optim} batch {bs}: step {ms:.1f} ms, peak "
                f"{mem:.2f} GiB; the moments {moments / 2**30:.3f} GiB; the "
                f"optimizer update {opt_ms:.1f} ms on the device's clock "
                f"({host:.1f} ms to issue) = {100 * opt_ms / ms:.1f}% of the "
                f"step, on {card}")
            del opt
        del init_fn, step_fn, state, pxs, step
        torch.cuda.empty_cache()


def phase_vit_h_train_steps(card: str, iters: int = 3) -> None:
    """The training steps at ViT-H widths, all 32 layers: the MIM preset's
    (VIT_H_MIM) at batch 1 and 2 and the V-JEPA2 _tpu preset's
    (VIT_H_VJEPA, no accumulation) at batch 1, through the kernels of the
    parity phases, the workloads built and initialised on the card
    (`on_card_init`): ms, MFU against the analytic FLOPs and peak memory,
    one step under the profiler (`time_train_steps`); the plain attention
    never runs."""
    import torch

    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import (
        mim_flops_per_sample,
        vjepa_flops_per_sample,
    )

    dev = torch.device("cuda")
    layers = VIT_H["num_hidden_layers"]
    cfg, preset = mim_config(**VIT_H_MIM, num_hidden_layers=layers)
    vcfg, vpreset = vjepa_config(**VIT_H_VJEPA, num_hidden_layers=layers)
    runs = (("ViT-H MIM", cfg, mim_flops_per_sample(
        cfg, preset["mask_ratio"]), (1, 2), lambda: on_card_init(
            functools.partial(
                make_mim_workload, cfg,
                mask_patch_size=preset["mask_patch_size"],
                mask_ratio=preset["mask_ratio"], tx=functools.partial(
                    make_optimizer, learning_rate=preset["learning_rate"],
                    total_steps=100, warmup_ratio=preset["warmup_ratio"],
                    weight_decay=preset["weight_decay"]), device=dev),
            dev)),
            ("ViT-H V-JEPA", vcfg, vjepa_flops_per_sample(vcfg), (1,),
             lambda: vjepa_workload(vcfg, vpreset, dev,
                                    vpreset["teacher_attn_impl"])))
    for label, c, flops, batches, make in runs:
        _, init_fn, step_fn, _ = make()
        state = init_fn(0)
        for bs in batches:
            gen = torch.Generator(device=dev).manual_seed(7)
            shape = ((c.num_frames, 1, c.image_size, c.image_size)
                     if label.endswith("MIM") else
                     (c.frames_per_clip, 1, c.crop_size, c.crop_size))
            pxs = [torch.rand((bs, *shape), generator=gen, device=dev)
                   for _ in range(iters + 1)]

            def step(i):
                return step_fn(state, {"pixel_values": pxs[i]},
                               step_generator(0, i))

            with plain_attention_calls() as plain:
                time_train_steps(f"{label} ({layers} layers)", card, bs,
                                 flops, step, iters)
            if plain:
                raise AssertionError(f"{label}: plain attention calls "
                                     f"{plain}")
            del pxs, step
        del init_fn, step_fn, state
        gc.collect()
        torch.cuda.empty_cache()


LEG_XY_STEPS = 2


def run_vit_h_train_legs(work: Path, vols: Path, table: dict) -> None:
    """Legs X and Y: run_mim with a copy of configs/mim_base_512.json at
    ViT-H widths (VIT_H_MIM) on the 4 volumes, and run_vjepa with a copy
    of configs/vjepa_large_384_tpu.json at ViT-H widths (VIT_H_VJEPA;
    accumulation cut to 1) on 3 of them, the encoders cut to
    VIT_H_LEG_LAYERS, LEG_XY_STEPS steps each, no eval: the step records'
    losses finite, the checkpoint and the export written; each kernel's
    launches those of `expected_launches` a step times the steps (leg X:
    K1 and K4 at d 80 and K5a and K5b at K 1,280 on every encoder layer;
    leg Y: K1, K7 and the teacher's K3 at d 80, K5a and K5b at K 1,280);
    the plain attention never. The d-80 and K-1280 rows of K4, K7, K5a
    and K5b take these launches."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_mim import main as run_mim
    from smb_vision_tpu_torch.cli.run_vjepa import main as run_vjepa
    from smb_vision_tpu_torch.models.convert import read_safetensors

    nii = [{"image": str(p)} for p in sorted(vols.glob("*.nii"))]
    cut = dict(num_hidden_layers=VIT_H_LEG_LAYERS)
    legs = (("X", run_mim, MIM_PRESET, VIT_H_MIM, {"train": nii}, "json_path",
             {}, "flash_bwd", mim_config(**VIT_H_MIM, **cut)[0]),
            ("Y", run_vjepa, VJEPA_PRESET, VIT_H_VJEPA,
             {"train": nii[:3], "validation": nii[3:]}, "data_path",
             {"gradient_accumulation_steps": 1}, "flash_bwd_i8",
             vjepa_config(**VIT_H_VJEPA, **cut)[0]))
    for leg, cli, preset_path, widths, data, key, cuts, bwd, cfg in legs:
        spec = work / f"vit_h_data_{leg}.json"
        spec.write_text(json.dumps(data))
        out = work / f"vit_h_out_{leg}"
        path = work / f"vit_h_{leg}.json"
        path.write_text(json.dumps(dict(
            json.loads(preset_path.read_text()), **widths, **cut, **cuts,
            **{key: str(spec)}, output_dir=str(out),
            num_train_steps=LEG_XY_STEPS, save_steps=LEG_XY_STEPS,
            save_total_limit=1, logging_steps=1, do_eval=False,
            num_workers=2)))
        ws = reset_launches()
        t0 = time.perf_counter()
        with plain_attention_calls() as plain:
            res = cli([str(path)])
        wall = time.perf_counter() - t0
        family = "mim" if cli is run_mim else "vjepa"
        got = check_vit_h_launches(
            f"leg {leg}", ws, expected_launches(ONE_STEP[family], cfg),
            VIT_H_LEG_LAYERS, bwd, plain, LEG_XY_STEPS)
        train = [json.loads(line) for line in
                 (out / "metrics.jsonl").read_text().splitlines()]
        train = [r for r in train if "loss" in r]
        log(f"leg {leg}: {cli.__module__.split('.')[-1]} at ViT-H widths, "
            f"encoder {VIT_H_LEG_LAYERS} of 32 layers: {res} in {wall:.1f} s "
            f"(preprocess + CPU init + train + save); losses "
            f"{[r['loss'] for r in train]}, step ms "
            f"{[round(r['step_time_ms'], 1) for r in train]}")
        if [r["step"] for r in train] != list(range(1, LEG_XY_STEPS + 1)) \
                or not all(math.isfinite(r["loss"]) for r in train):
            raise AssertionError(f"leg {leg}: step records {train}")
        export = read_safetensors(out / "model.safetensors")
        if not (out / "checkpoints" / str(LEG_XY_STEPS)).is_dir() or not all(
                np.isfinite(v).all() for v in export.values()):
            raise AssertionError(f"leg {leg}: no checkpoint at step "
                                 f"{LEG_XY_STEPS} or a non-finite export")
        for row in (f"{bwd} d{VIT_H_D}", f"mlp_train_fwd K{VIT_H_K}",
                    f"mlp_bwd K{VIT_H_K}"):
            table[row]["launches"] = max(table[row]["launches"], got[row])
        shutil.rmtree(out)


@contextlib.contextmanager
def parent_routing():
    """Inside the block "auto" routes attention as the parent commit did:
    K1 (and K4) at head widths 64 and 128, the plain attention at 32 (the
    reference-head predictor). A yardstick of this phase only."""
    from smb_vision_tpu_torch.ops import attention as A

    auto = A._auto_impl
    A._auto_impl = lambda q, bias: (
        "xla" if q.shape[-1] == 32 else auto(q, bias))
    try:
        yield
    finally:
        A._auto_impl = auto


# the reference-head V-JEPA step: the preset's micro-batch 16 if it fits the
# card, else the largest of these that does; and the batch at which the
# parent's routing (the predictor's attention on the plain path, ~6 GB a
# sample for one block's recompute) is timed beside the kernels
REF_BATCHES = (16, 8, 4, 2, 1)
REF_SAME_BATCH = 4
REF_AGAINST_BATCH = 2   # the reference-head step in `phase_against`
REF_LAYERS = 4          # the encoder depth cut of the reference-head
#                         throughput phase and of `phase_d32_int8_path`
#                         (24 in the preset; the predictor keeps its 12),
#                         to keep the script inside its time limit (6
#                         until the W8A8 phases came)


def vjepa_params(cfg) -> int:
    """Parameters of the V-JEPA2 model of cfg (student: encoder and
    predictor), counted on the meta device."""
    import torch

    from smb_vision_tpu_torch.models.vjepa import VJEPA2Model

    with torch.device("meta"):
        return sum(p.numel() for p in VJEPA2Model(cfg).parameters())


def phase_vjepa_ref_throughput(card: str, table: dict,
                               iters: int = 2) -> None:
    """V-JEPA steps of configs/vjepa_large_384.json (no accumulation; the
    encoder cut to REF_LAYERS layers): under
    "auto" (K1 + K4 at d 64 and d 32) and under LEG_I_IMPLS (K1 + K7, the
    teacher on K3) at the largest batch of REF_BATCHES that fits, then at
    REF_SAME_BATCH under "auto" and under `parent_routing`; step ms, MFU
    (`vjepa_flops_per_sample`, which with the parameter count is checked
    to be the _tpu preset's) and peak memory by `time_train_steps` (two
    timed steps a run: a step at batch 16 takes over 4 s), and
    each run's launches a step, which must show its routing (K4 at d 32's
    under "auto" are its row's launches); the workloads built and
    initialised on the card (`on_card_init`)."""
    import torch

    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import vjepa_flops_per_sample

    dev = torch.device("cuda")
    ref_cfg, preset = vjepa_ref_config(num_hidden_layers=REF_LAYERS)
    tpu_cfg, _ = vjepa_config(num_hidden_layers=REF_LAYERS)
    log(f"V-JEPA reference heads, throughput: the encoder's depth cut from "
        f"{vjepa_ref_config()[0].num_hidden_layers} to {REF_LAYERS} layers "
        f"(the predictor keeps {ref_cfg.pred_num_hidden_layers})")
    flops = vjepa_flops_per_sample(ref_cfg)
    got = {name: (vjepa_flops_per_sample(c), vjepa_params(c))
           for name, c in (("reference heads", ref_cfg),
                           ("_tpu preset", tpu_cfg))}
    log(f"V-JEPA reference heads: (TFLOP a sample, parameters) {got}")
    if len(set(got.values())) != 1:
        raise AssertionError(f"the _tpu preset's FLOPs or parameters "
                             f"differ from the reference heads': {got}")
    routes = {"auto": ({}, None, contextlib.nullcontext),
              "preset impls": ({"attn_impl": LEG_I_IMPLS["attn_impl"]},
                               LEG_I_IMPLS["teacher_attn_impl"],
                               contextlib.nullcontext),
              "parent routing": ({}, None, parent_routing)}

    def run(route: str, bs: int) -> bool:
        """Time `route` at batch bs; False if it does not fit the card."""
        kw, teacher, routing = routes[route]
        cfg, _ = vjepa_ref_config(num_hidden_layers=REF_LAYERS, **kw)
        _, init_fn, step_fn, _ = vjepa_workload(cfg, preset, dev, teacher)
        state = init_fn(0)

        def step(i):
            gen = torch.Generator(device=dev).manual_seed(60 + i)
            px = torch.rand((bs, cfg.frames_per_clip, 1, cfg.crop_size,
                             cfg.crop_size), generator=gen, device=dev)
            return step_fn(state, {"pixel_values": px},
                           step_generator(0, i))

        ws = reset_launches()
        fits = True
        try:
            with routing(), plain_attention_calls() as plain:
                time_train_steps(f"V-JEPA reference heads, {route},", card,
                                 bs, flops, step, iters)
        except torch.cuda.OutOfMemoryError:
            fits = False
        del state, init_fn, step_fn, step
        gc.collect()
        torch.cuda.empty_cache()
        if not fits:
            log(f"V-JEPA reference heads, {route}: batch {bs} does not fit "
                f"the card")
            return False
        steps = iters + 2   # time_train_steps: warm-up, iters, profiled
        counts = {name: w.launches // steps for name, w in ws.items()
                  if w.launches}
        d32 = {k: v // steps for k, v in d32_launches(ws).items()}
        plain = {k: v // steps for k, v in plain.items()}
        log(f"V-JEPA reference heads, {route}, batch {bs}: launches a step "
            f"{counts}, d 32 {d32}, plain attention calls by head width "
            f"{plain}")
        if route == "parent routing":
            if d32["flash_fwd d32"] or not plain.get(32):
                raise AssertionError(f"{route}: the predictor did not run "
                                     f"the plain attention")
        else:
            bwd = "flash_bwd d32" if route == "auto" else "flash_bwd_i8 d32"
            check_d32_launches(f"V-JEPA reference heads, {route}", d32,
                               plain, 1, bwd)
            if route == "auto":
                table["flash_bwd d32"]["launches"] = d32["flash_bwd d32"]
        return True

    for route in ("auto", "preset impls"):
        fitted = next(bs for bs in REF_BATCHES if run(route, bs))
        if fitted != REF_BATCHES[0]:
            log(f"V-JEPA reference heads, {route}: the preset's micro-batch "
                f"{REF_BATCHES[0]} does not fit; {fitted} is the largest "
                f"that does")
    for route in ("auto", "parent routing"):
        if not run(route, REF_SAME_BATCH):
            raise AssertionError(f"{route} at batch {REF_SAME_BATCH} does "
                                 f"not fit the card")



# DINOv2-giant: the published facebook/dinov2-giant config (ViT-g/14, Oquab
# et al. 2023: hidden 1536, 40 layers, 24 heads of 64, mlp_ratio 4,
# use_swiglu_ffn, layerscale 1.0, layer_norm_eps 1e-6, qkv_bias) in the
# repo's 3D form: Conv3d patch 16 over 1 channel at the dinov2 CT
# pipeline's 224^2 x 160, a (14, 14, 10) grid of 1,960 patches plus CLS.
# SwiGLU width (int(1536 * 4 * 2/3) + 7) // 8 * 8 = 4,096. bf16, K9 on
# mlp_impl "pallas", K1 (K4 under autograd) on attn "auto", remat.
GIANT = dict(image_size=224, depth=160, patch_size=16, num_channels=1,
             hidden_size=1536, num_hidden_layers=40, num_attention_heads=24,
             mlp_ratio=4, use_swiglu_ffn=True, layerscale_value=1.0,
             layer_norm_eps=1e-6, qkv_bias=True, drop_path_rate=0.0,
             dtype="bfloat16", attn_impl="auto", mlp_impl="pallas",
             gradient_checkpointing=True)
DINO_N = 1961           # 14 * 14 * 10 patches + CLS
# the seeds of the DINOv2-giant step parity that --against runs with
# either library: the loss gap of one step at random weights varies with
# the seed, so one seed cannot tell a kernel's bias from chance
DINO_PARITY_SEEDS = (0, 1, 2)
# K9's three passes in a profile: the LayerNorm rows, the gated product and
# the second product (K2's, which the DINOv2 model runs only for K9)
K9_KERNELS = ("ln_rows_any_kernel", "mlp_gemm_kernel<3, false>",
              "mlp_gemm_kernel<2, true>")
GIANT_HEADS, GIANT_K, GIANT_F = 24, 1536, 4096
LEG_F_LAYERS = 8        # leg F's depth cut: one checkpoint is ~2.8 GB
# the fine-tuning recipe's two tiers (SURVEY "fine-tune recipe")
VISION_LR, MERGER_LR = 1e-5, 3e-4


def giant_config(**kw):
    from smb_vision_tpu_torch.models.configs import Dinov2Config

    return Dinov2Config(**dict(GIANT, **kw))


def phase_dinov2_kernels(table: dict, gen, dev) -> None:
    """K9 against its plain version (the kernel's numerics) and the bf16
    cuBLAS chain `_swiglu_block_xla` at DINOv2-giant batch 2 (M 3,922),
    the DINOv2-base shape (M 20,480, K 768, F 2,048), the ragged batch 1
    (M 1,961) and K 2,048 (F 5,504, batch 2's rows: the row "swiglu_block_fwd
    K2048"), timed beside both (the chain is its library_ms); its
    gradients through the recompute at batch 2; the register and spill
    report of its gated product. Then K1 and K4 at N 1,961, 24 heads of
    64, batch 2, against theirs."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import mlp as M

    for line in ptxas_report(SM90_KERNELS["K9 phase 1"][0]):
        log(f"  K9 ptxas: {line}")

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    names = ("dx", "dlnw", "dlnb", "dw_in", "db_in", "dw_out", "db_out")
    # and one K past the DINOv2-giant width (K9 takes any multiple of 128
    # since the runtime-K LayerNorm pass), at giant batch 2's rows
    for m, k, f, label in ((2 * DINO_N, GIANT_K, GIANT_F, "giant batch 2"),
                           (MAIN_N, HIDDEN, 2048, "base shape"),
                           (DINO_N, GIANT_K, GIANT_F, "giant batch 1"),
                           (2 * DINO_N, 2048, 5504, "K past 1,536")):
        args = (r(m, k).to(torch.bfloat16), 1.0 + r(k, s=0.1), r(k, s=0.1),
                r(2 * f, k, s=k ** -0.5).to(torch.bfloat16).t(),
                r(2 * f, s=0.1), r(k, f, s=f ** -0.5).to(torch.bfloat16).t(),
                r(k, s=0.1))
        what = f"M={m} K={k} F={f}"
        row = f"swiglu_block_fwd K{k}" if k > GIANT_K else "swiglu_block_fwd"
        y = M.swiglu_block_fused(*args, eps=1e-6)
        check_kernel(table, row, what, y,
                     M._swiglu_block_plain(*args, 1e-6), TOL_MLP)
        check_kernel(table, row, what + " vs bf16 chain", y,
                     M._swiglu_block_xla(*args, 1e-6), TOL_MLP, record=False)
        kernel = functools.partial(M.swiglu_block_fused, *args, eps=1e-6)
        plain = functools.partial(M._swiglu_block_plain, *args, 1e-6)
        chain = functools.partial(M._swiglu_block_xla, *args, 1e-6)
        nbytes = mlp_bytes(m, k, f, n_w=3, ln=True)
        kernel_split(f"swiglu_block_fwd {what}", kernel)
        if label in ("giant batch 2", "K past 1,536"):
            time_kernel(table, row, f"{label} {what}", kernel, plain, 10,
                        True)
            mlp_library(table, row, f"{label} {what}", chain)
            set_bound(table, row, what, 6 * m * k * f, nbytes)
            rate_line(table, row, what, 6 * m * k * f, "the chain's")
        if label == "giant batch 2":
            g = r(m, k)

            def grads(impl):
                leaves = [t.detach().clone().requires_grad_() for t in args]
                (M.swiglu_block_forward(*leaves, eps=1e-6, impl=impl).float()
                 * g).sum().backward()
                return [t.grad for t in leaves]

            for name, a, b in zip(names, grads("pallas"), grads("xla")):
                check_kernel(table, "swiglu_block_fwd", f"{what} {name}", a,
                             b, TOL_MLP_TRAIN, record=False)
        elif label != "K past 1,536":
            mlp_beside_chain("swiglu_block_fwd", f"{label} {what}", kernel,
                             plain, chain, m, k, f, nbytes, products=3)
        del args, y

    scale = 1.0 / math.sqrt(HEAD_DIM)
    q, k, v, do = [(torch.randn((2, DINO_N, GIANT_HEADS, HEAD_DIM),
                                generator=gen, device=dev) * 0.4).to(
        torch.bfloat16) for _ in range(4)]
    shape = f"DINOv2-giant B=2 N={DINO_N} H={GIANT_HEADS}"
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    check_kernel(table, "flash_fwd", shape, out, A.xla_attention(q, k, v),
                 TOL_FLASH)
    got = A.flash_attention_bwd(q, k, v, out, lse, do)
    want = A.attention_bwd_plain(q, k, v, out, lse, do, scale=scale)
    for what, a, b in zip(("dq", "dk", "dv"), got, want):
        check_kernel(table, "flash_bwd", f"{shape} {what}", a, b,
                     TOL_FLASH_BWD)
    time_kernel(table, "flash_fwd", shape, lambda: A.flash_attention(q, k, v),
                lambda: A.xla_attention(q, k, v), 8, False)
    time_kernel(table, "flash_bwd", shape,
                lambda: A.flash_attention_bwd(q, k, v, out, lse, do),
                lambda: A.attention_bwd_plain(q, k, v, out, lse, do,
                                              scale=scale), 5, False)


# the glue kernels' shapes: the embed path, the MIM encoder and decoder,
# and a ragged one at the ViT-L width
GLUE_SHAPES = ((MAIN_N, HIDDEN, "embed"), (ENC_N, HIDDEN, "MIM encoder"),
               (MAIN_N, DEC_HIDDEN, "MIM decoder"),
               (2 * DINO_N, VJ_HIDDEN, "ragged"))
K8_RAGGED_N = 1961
# the glue kernels in a profile: K10a's LayerNorm pass and GEMM, and K10b
GLUE_KERNELS = ("qkv_ln_rows_kernel", "qkv_gemm_kernel",
                "mlp_gemm_kernel<4, true>")


def phase_glue_kernels(table: dict, gen, dev) -> None:
    """K8 against its plain version (the same quantised operands and 64-key
    sub-blocks) and float32 attention at N 20,480, 12 heads of 64, and at
    ragged N 1,961, timed beside K3 on the same inputs, each through its
    wrapper and alone (`k8_beside_k3`; no library call computes int8 p
    v). K10a and K10b against their plain versions (the
    kernels' numerics) at the embed shape, the MIM encoder's and decoder's
    and a ragged one, timed beside their plain versions and the library
    chain: F.layer_norm + one F.linear on the stacked (3K, K) weight for
    K10a, torch.addmm(res, y, Wo) + bo for K10b (two calls each), with
    each pass's device time (`split` lines: K10a's LayerNorm pass and
    GEMM apart) and their sum's TFLOP/s and share of bound at each shape.
    The table keeps the embed shape's times. Then the glue's forward and
    backward in one block of the MIM step at batch 2 beside the shipped
    path's (`glue_block_ms`)."""
    import torch
    import torch.nn.functional as F

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import attn_glue as G

    scale = 1.0 / math.sqrt(HEAD_DIM)
    for n in (MAIN_N, K8_RAGGED_N):
        q, k, v = _attn_inputs(n, gen, dev)
        q8, k8, sq, sk = plain_qk(q, k, scale)
        v8, sv = A.quantize_per_head(v)
        out = A.flash_attention_int8pv(q, k, v)
        check_kernel(table, "flash_fwd_i8pv", f"N={n}", out,
                     A.int8pv_attention_plain(q8, k8, sq, sk, v8, sv),
                     TOL_INT8)
        check_kernel(table, "flash_fwd_i8pv", f"N={n} vs f32 softmax", out,
                     A.xla_attention(q.float(), k.float(), v.float()),
                     TOL_INT8PV_F32, record=False)
        if n == MAIN_N:
            time_kernel(table, "flash_fwd_i8pv", f"main-path N={n}",
                        lambda: A.flash_attention_int8pv(q, k, v),
                        lambda: A.int8pv_attention_plain(
                            *plain_qk(q, k, scale),
                            *A.quantize_per_head(v)), 8, True)
            k8_beside_k3(f"N={n}", q, k, v)
            ops = 2 * n * n * HEAD_DIM * HEADS
            set_bound(table, "flash_fwd_i8pv", f"N={n}", 0.0,
                      4 * n * HEADS * HEAD_DIM * 2, int8_ops=2 * ops)
        del q, k, v, q8, k8, v8, out

    for name in (*GLUE_KERNELS[:2], SM90_KERNELS["K10b"][0]):
        for line in ptxas_report(name):
            log(f"  glue ptxas: {line}")

    def r(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s

    for m, kd, label in GLUE_SHAPES:
        x = r(m, kd).to(torch.bfloat16)
        lnw, lnb = 1.0 + r(kd, s=0.1), r(kd, s=0.1)
        lin = [r(kd, kd, s=kd ** -0.5).to(torch.bfloat16) for _ in range(4)]
        ws = [w.t() for w in lin]            # (in, out) views, as the Block
        bs = [r(kd, s=0.1) for _ in range(4)]
        qkv_args = (x, lnw, lnb, *ws[:3], *bs[:3])
        what = f"{label} M={m} K={kd}"
        got = G.qkv_ln_fused(*qkv_args, eps=1e-6)
        want = G._qkv_ln_plain(*qkv_args, 1e-6)
        for name, a, b in zip("qkv", got, want):
            check_kernel(table, "qkv_ln_fwd", f"{what} {name}", a, b,
                         TOL_GLUE)
        y = got[2]
        o = G.out_res_fused(x, y, ws[3], bs[3])
        check_kernel(table, "out_res_fwd", what, o,
                     G._out_res_plain(x, y, ws[3], bs[3]), TOL_GLUE)
        keep = label == "embed"
        qkv_fn = functools.partial(G.qkv_ln_fused, *qkv_args, eps=1e-6)
        out_fn = functools.partial(G.out_res_fused, x, y, ws[3], bs[3])
        time_kernel(table, "qkv_ln_fwd", what, qkv_fn,
                    lambda: G._qkv_ln_plain(*qkv_args, 1e-6), 20, keep)
        time_kernel(table, "out_res_fwd", what, out_fn,
                    lambda: G._out_res_plain(x, y, ws[3], bs[3]), 20, keep)
        w3 = torch.cat(lin[:3])
        b3 = torch.cat(bs[:3]).to(torch.bfloat16)
        lib_qkv = cuda_ms(lambda: F.linear(F.layer_norm(
            x, (kd,), lnw.to(torch.bfloat16), lnb.to(torch.bfloat16), 1e-6),
            w3, b3), iters=20, repeats=KERNEL_REPEATS)
        bo16 = bs[3].to(torch.bfloat16)
        lib_out = cuda_ms(lambda: torch.addmm(x, y, ws[3]).add_(bo16),
                          iters=20, repeats=KERNEL_REPEATS)
        log(f"time library chains {what}: F.layer_norm + F.linear(3K x K) "
            f"{lib_qkv:.3f} ms, torch.addmm + bias {lib_out:.3f} ms (two "
            f"calls each, CUDA events)")
        act = m * kd * 2
        work = {"qkv_ln_fwd": (2 * m * kd * 3 * kd,
                               4 * act + 3 * kd * kd * 2 + 5 * kd * 4),
                "out_res_fwd": (2 * m * kd * kd,
                                3 * act + kd * kd * 2 + kd * 4)}
        for name, fn, lib in (("qkv_ln_fwd", qkv_fn, lib_qkv),
                              ("out_res_fwd", out_fn, lib_out)):
            flops, nbytes = work[name]
            passes = device_times(fn)
            for key, count, ms in passes:
                log(f"split {name} {what}: {key[:60]} x{count} a call, "
                    f"{ms:.4f} ms each (profiler)")
            ms = sum(count * ms for _, count, ms in passes)
            bound = max(flops / PEAK_BF16, nbytes / HBM_BYTES) * 1e3
            log(f"rate {name:<16} {what}: device {ms:.4f} ms, "
                f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.2f} "
                f"TB/s, {bound / ms:.1%} of bound {bound:.4f} ms, "
                f"{ms / lib:.2f}x the chain's time (profiler)")
            if keep:
                table[name]["library_ms"] = lib
                set_bound(table, name, what, flops, nbytes)
        del x, y, got, want, o, qkv_args, qkv_fn, out_fn
    for m, kd, label in ((2 * ENC_N, HIDDEN, "MIM encoder"),
                         (2 * MAIN_N, DEC_HIDDEN, "MIM decoder")):
        glue_block_ms(f"{label} batch 2 M={m} K={kd}", m, kd, r)


def k8_beside_k3(shape: str, q, k, v) -> None:
    """K8 beside K3 on the same inputs: each through its wrapper and its
    kernel alone on the operands the quantisation kernel gives the
    wrapper, beside the quantisation's time (q, k and v in K8's layout),
    the exp2 floor the two share, and the device time of K8's kernel by
    the profiler."""
    from smb_vision_tpu_torch.ops import attention as A

    scale = 1.0 / math.sqrt(q.shape[-1])
    ops = A.quantize_qk(q, k, scale)
    vt8, sv = A.quantize_per_head_kernel(v, v_layout=True)
    ms = {"K8 wrapper": lambda: A.flash_attention_int8pv(q, k, v),
          "K8 kernel alone": lambda: A._launch_int8pv(*ops, vt8, sv),
          "K3 wrapper": lambda: A.flash_attention_int8(q, k, v),
          "K3 kernel alone": lambda: A._launch_int8(*ops, v),
          "quantisation of q, k, v": lambda: (
              A.quantize_qk(q, k, scale),
              A.quantize_per_head_kernel(v, v_layout=True))}
    got = {name: cuda_ms(fn, iters=8, repeats=KERNEL_REPEATS)
           for name, fn in ms.items()}
    log(f"time flash_fwd_i8pv {shape}: " + ", ".join(
        f"{name} {t:.3f} ms" for name, t in got.items())
        + f"; exp2 floor {exp2_floor_ms(q.shape[1], q.shape[2]):.3f} ms "
        f"(CUDA events)")
    for key, count, t in device_times(ms["K8 kernel alone"]):
        log(f"split flash_fwd_i8pv {shape}: {key[:60]} x{count} a call, "
            f"{t:.4f} ms each (profiler)")


def glue_block_ms(what: str, m: int, kd: int, r) -> None:
    """The attention glue of one block as the MIM step runs it, around a
    stand-in y for the attention's output, from f32 Linear weights cast to
    bf16 each call: through K10a/K10b as `Attention.glue_forward` calls
    them (whose backward recomputes the plain composition) and through the
    shipped path's ops (LayerNorm: F.layer_norm in f32; Linear: F.linear
    in bf16; the residual add). Logs each one's device time (profiler,
    the sum over its kernels) forward alone and forward + backward; under
    remat a step runs the forward twice and the backward once, so the
    glue's device time a block is 2 fwd + bwd."""
    import torch
    import torch.nn.functional as F

    from smb_vision_tpu_torch.ops import attn_glue as G

    bf = torch.bfloat16
    x, y = r(m, kd).to(bf), r(m, kd).to(bf)
    lnw, lnb = 1.0 + r(kd, s=0.1), r(kd, s=0.1)
    lins = [r(kd, kd, s=kd ** -0.5) for _ in range(4)]
    bs = [r(kd, s=0.1) for _ in range(4)]
    leaves = [x, y, lnw, lnb, *lins, *bs]
    for t in leaves:
        t.requires_grad_()
    gs = [r(m, kd).to(bf) for _ in range(4)]

    def glue():
        wq, wk, wv, wo = (w.to(bf).t() for w in lins)
        return (*G.qkv_ln_forward(x, lnw, lnb, wq, bs[0], wk, bs[1], wv,
                                  bs[2], eps=1e-6, impl="pallas"),
                G.attn_out_residual(x, y, wo, bs[3], impl="pallas"))

    def shipped():
        xn = F.layer_norm(x.float(), (kd,), lnw, lnb, 1e-6).to(bf)
        return (*(F.linear(xn, w.to(bf), b.to(bf))
                  for w, b in zip(lins[:3], bs[:3])),
                x + F.linear(y, lins[3].to(bf), bs[3].to(bf)))

    got = {}
    for name, fn in (("glue", glue), ("shipped", shipped)):
        fwd = sum(n * ms for _, n, ms in device_times(fn, 5))
        both = sum(n * ms for _, n, ms in device_times(
            lambda: torch.autograd.grad(fn(), leaves, gs), 5))
        got[name] = (fwd, both, 2 * fwd + both - fwd)
    log(f"glue block {what}: device ms forward {got['glue'][0]:.3f} "
        f"(shipped {got['shipped'][0]:.3f}), forward + backward "
        f"{got['glue'][1]:.3f} ({got['shipped'][1]:.3f}), a remat step's "
        f"{got['glue'][2]:.3f} ({got['shipped'][2]:.3f}) (profiler)")


def dinov2_batch(bs: int, seed: int, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    px = torch.rand((bs, 1, 224, 224, 160), generator=gen, device=dev)
    labels = torch.randint(0, 2, (bs,), generator=gen, device=dev)
    return {"pixel_values": px, "labels": labels.to(torch.int32)}


def dinov2_parity(seed: int = 0, libs: dict | None = None) -> dict:
    """One DINOv2-giant fine-tune step (forward and backward, remat, no
    update) at batch 2, a classification head of 2 labels, from the same
    weights and batch made from seed: through the kernels (with each
    kernel library of libs in turn, this package's wrappers calling it;
    with the library built when libs is None), through their plain
    versions under the same impl names (`plain_kernels`), and in float32
    with the plain attention and MLP (TF32 off). Checks K9's launches on
    each path: 40 a forward, so 80 with the remat recompute, and none on
    the plain path. Returns the plain versions' and float32's losses,
    the plain versions' gradient error against float32, and for each
    kernel path its loss, its loss's gap to the plain versions' (relative)
    and its gradient error against float32."""
    import torch

    from smb_vision_tpu_torch.models.dinov2 import (
        Dinov2ForImageClassification,
    )
    from smb_vision_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    batch = dinov2_batch(2, 6 + seed, dev)
    with torch.device(dev):
        init = Dinov2ForImageClassification(giant_config()).init_weights(
            torch.Generator(device=dev).manual_seed(seed)).state_dict()

    def step(**kw):
        with torch.device(dev):
            model = Dinov2ForImageClassification(giant_config(**kw))
        model.load_state_dict(init)
        model.train()
        loss = model(batch["pixel_values"], labels=batch["labels"])["loss"]
        loss.backward()
        # the mask token is used only with bool_masked_pos: no gradient
        named = [(n, p.grad) for n, p in model.named_parameters()
                 if n != "dinov2.mask_token"]
        if any(g is None for _, g in named):
            raise AssertionError(f"{kw or 'kernel path'}: no gradient for "
                                 f"{[n for n, g in named if g is None]}")
        flat = torch.cat([g.float().flatten() for _, g in named])
        n_params = sum(p.numel() for p in model.parameters())
        del model, named
        torch.cuda.empty_cache()
        return float(loss.detach()), flat, n_params

    layers = GIANT["num_hidden_layers"]
    kernels = {}
    built = _build.lib()
    try:
        for side, handle in (libs or {"kernels": built}).items():
            _build._lib = handle
            ws = reset_launches()
            t0 = time.perf_counter()
            loss, grad, n_params = step()
            kernels[side] = (loss, grad, time.perf_counter() - t0,
                             {name: w.launches for name, w in ws.items()})
    finally:
        _build._lib = built
    for side, (_, _, _, counts) in kernels.items():
        if counts["swiglu_block_fwd"] != 2 * layers or not (
                counts["flash_fwd"] > 0 and counts["flash_bwd"] > 0):
            raise AssertionError(f"DINOv2 step ({side}): launches {counts}; "
                                 f"K9 must launch {layers} a forward, twice "
                                 f"with remat")
    ws = reset_launches()
    with plain_kernels():
        p_loss, p_grad, _ = step()
    if any(w.launches for w in ws.values()):
        raise AssertionError(f"the plain path launched a kernel: "
                             f"{ {n: w.launches for n, w in ws.items()} }")
    f_loss, f_grad, _ = step(attn_impl="xla", mlp_impl="xla",
                             dtype="float32")
    norm = float(f_grad.norm())
    out = {"plain loss": p_loss, "f32 loss": f_loss,
           "plain grad err": float((p_grad - f_grad).norm()) / norm}
    for side, (loss, grad, wall, counts) in kernels.items():
        if not (bool(grad.isfinite().all()) and math.isfinite(loss)):
            raise AssertionError(f"the kernel path's ({side}) loss or "
                                 f"gradient is not finite")
        out[side] = {"loss": loss,
                     "rel loss": abs(loss - p_loss) / abs(p_loss),
                     "grad err": float((grad - f_grad).norm()) / norm}
        log(f"DINOv2-giant parity, seed {seed}, one fine-tune step at batch "
            f"2 ({n_params} parameters, N {DINO_N}): loss {side} {loss:.6f}, "
            f"plain versions {p_loss:.6f}, f32 {f_loss:.6f}; rel "
            f"{out[side]['rel loss']:.3e} (bound {TOL_TRAIN_LOSS}); "
            f"gradient error vs f32: {side} {out[side]['grad err']:.3e}, "
            f"plain versions {out['plain grad err']:.3e} (bound "
            f"{TOL_TRAIN_GRAD_VS_F32} x plain); kernel step {wall:.1f} s "
            f"with the first calls; launches {counts}")
    return out


def phase_dinov2_parity() -> None:
    """`dinov2_parity` through the kernels at every seed of
    DINO_PARITY_SEEDS, decided across the seeds. At each seed the
    gradient error against float32 is within TOL_TRAIN_GRAD_VS_F32 times
    the plain versions'. Over the seeds, the mean loss gap to the plain
    versions is within TOL_TRAIN_LOSS, and the kernels' mean loss distance
    from float32 within TOL_TRAIN_GRAD_VS_F32 times the plain versions'.
    One bf16 step at random weights is chaotic: at one seed either bf16
    path may land near float32 or 2e-2 from it by chance (the plain path
    is 3.9e-4 from it at seed 0, 1.7e-2 and 2.2e-2 at seeds 1 and 2), so
    one seed's gap can cross TOL_TRAIN_LOSS without a fault; a fault
    moves the kernels off float32 at every seed, and so their mean."""
    gaps, k_dist, p_dist, grads_ok = [], [], [], True
    for seed in DINO_PARITY_SEEDS:
        got = dinov2_parity(seed)
        k = got["kernels"]
        f32 = abs(got["f32 loss"])
        gaps.append(k["rel loss"])
        k_dist.append(abs(k["loss"] - got["f32 loss"]) / f32)
        p_dist.append(abs(got["plain loss"] - got["f32 loss"]) / f32)
        grad_ok = k["grad err"] <= (TOL_TRAIN_GRAD_VS_F32
                                    * got["plain grad err"])
        grads_ok &= grad_ok
        log(f"DINOv2-giant parity, seed {seed}: loss gap to the plain "
            f"versions {gaps[-1]:.3e}; loss distance from float32: kernels "
            f"{k_dist[-1]:.3e}, plain versions {p_dist[-1]:.3e}; gradient "
            f"error {k['grad err']:.3e}, plain {got['plain grad err']:.3e} "
            f"(bound {TOL_TRAIN_GRAD_VS_F32} x plain): "
            f"{'pass' if grad_ok else 'FAIL'}")
    n = len(DINO_PARITY_SEEDS)
    gap, kd, pd = sum(gaps) / n, sum(k_dist) / n, sum(p_dist) / n
    loss_ok = gap <= TOL_TRAIN_LOSS and kd <= TOL_TRAIN_GRAD_VS_F32 * pd
    log(f"DINOv2-giant parity verdict over seeds {DINO_PARITY_SEEDS}: mean "
        f"loss gap to the plain versions {gap:.3e} (bound {TOL_TRAIN_LOSS}); "
        f"mean loss distance from float32: kernels {kd:.3e}, plain versions "
        f"{pd:.3e} (bound {TOL_TRAIN_GRAD_VS_F32} x plain); gradient rule at "
        f"every seed: {grads_ok}: {'pass' if loss_ok and grads_ok else 'FAIL'}")
    if not (loss_ok and grads_ok):
        raise AssertionError("DINOv2 parity fails over the seeds")


def phase_finetune_throughput(card: str, iters: int = 3) -> dict:
    """DINOv2-giant fine-tune steps (two-tier AdamW update included) at
    batch 2 and 4: ms a step, MFU on the analytic count with SwiGLU's
    three products, peak memory, and one step under the profiler with
    K9's share. Returns {batch: (ms, peak GiB)}."""
    import torch

    from smb_vision_tpu_torch.train.classification import (
        make_classification_workload,
    )
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import (
        classification_flops_per_sample,
    )

    dev = torch.device("cuda")
    cfg = giant_config(problem_type="single_label_classification")
    flops = classification_flops_per_sample(cfg)
    rows = {}
    for bs in (2, 4):
        _, init_fn, step_fn, _ = make_classification_workload(
            cfg, task_type="classification", device=dev,
            tx=functools.partial(make_optimizer, learning_rate=1e-4,
                                 total_steps=100, vision_lr=VISION_LR,
                                 merger_lr=MERGER_LR))
        state = init_fn(0)
        batches = [dinov2_batch(bs, 10 + i, dev) for i in range(iters + 1)]

        def step(i):
            return step_fn(state, batches[i], step_generator(0, i))

        ws = reset_launches()
        step(0)
        log(f"DINOv2-giant batch {bs}: launches of one step "
            f"{ {n: w.launches for n, w in ws.items() if w.launches} }")
        rows[bs] = time_train_steps("DINOv2-giant fine-tune", card, bs,
                                    flops, step, iters, watch=K9_KERNELS)
        del init_fn, step_fn, state, batches, step
        torch.cuda.empty_cache()
    return rows


def write_labelled_spec(work: Path, vols: Path) -> Path:
    """The volumes as a fine-tuning spec: a label, a survival duration and
    event, and one tabular column (age); every volume in both splits."""
    items = [{"image": str(p), "label": i % 2, "os": float(3 + 5 * i),
              "os_event": float(i != 2), "age": 50.0 + 7 * i}
             for i, p in enumerate(sorted(vols.glob("*.nii")))]
    spec = work / "cls_data.json"
    spec.write_text(json.dumps({"train": items, "validation": items}))
    return spec


def run_finetune_leg(work: Path, spec: Path, leg: str, cfg_path: Path,
                     task: str, extra: dict, kernels: tuple,
                     metric_keys: tuple, after_first=None) -> dict:
    """run_classification with the config file cfg_path on the labelled
    volumes, the two-tier recipe: 4 steps, a checkpoint every 2, eval;
    then the same to 6 steps, which resumes at 4 (after_first() runs
    between the two). Asserts the logs, the checkpoints, the eval metrics,
    the export and that the kernels launched in the first run; returns
    that run's launch counts."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_classification import main as run_cls
    from smb_vision_tpu_torch.models.convert import read_safetensors
    from smb_vision_tpu_torch.train.trainer import Trainer

    out = work / f"leg_{leg}"

    def run(steps):
        path = work / f"leg_{leg}_{steps}.json"
        path.write_text(json.dumps(dict(
            train_data_path=str(spec), val_data_path=str(spec),
            output_dir=str(out), config_name_or_path=str(cfg_path),
            task_type=task, learning_rate=1e-4, vision_lr=VISION_LR,
            merger_lr=MERGER_LR, warmup_ratio=0.1,
            per_device_train_batch_size=2, per_device_eval_batch_size=3,
            num_train_steps=steps, save_steps=2, logging_steps=1,
            do_eval=True, num_workers=2, **extra)))
        t0 = time.perf_counter()
        res = run_cls([str(path)])
        return res, time.perf_counter() - t0

    ws = reset_launches()
    res4, wall4 = run(4)
    counts = {name: w.launches for name, w in ws.items()}
    if after_first is not None:
        after_first()
    res6, wall6 = run(6)
    log(f"leg {leg}: {res4} in {wall4:.1f} s, resumed {res6} in "
        f"{wall6:.1f} s (preprocess + train + eval + save); launches of the "
        f"first run {counts}")
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if "loss" in r]
    for r in train:
        log(f"  step {r['step']}: loss {r['loss']:.6f}, "
            f"{r['step_time_ms']:.1f} ms, mfu {r.get('mfu')}")
    if [r["step"] for r in train] != [1, 2, 3, 4, 5, 6]:
        raise AssertionError(f"leg {leg} logged steps "
                             f"{[r['step'] for r in train]}")
    for r in train:
        if not (math.isfinite(r["loss"]) and r.get("mfu", 0) > 0):
            raise AssertionError(f"leg {leg} step record {r}")
    for res in (res4, res6):
        vals = [res.get(k, math.nan) for k in ("eval_loss", *metric_keys)]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"leg {leg} eval: {res}")
    ckpts = Trainer.checkpoint_steps(out / "checkpoints")
    limit = extra.get("save_total_limit")
    want = [6] if limit == 1 else [2, 4, 6]
    if ckpts != want or res6["train_steps"] != 6:
        raise AssertionError(f"leg {leg} checkpoints {ckpts}, result {res6}")
    export = read_safetensors(out / "model.safetensors")
    if not (out / "config.json").exists() or not all(
            np.isfinite(v).all() for v in export.values()):
        raise AssertionError(f"leg {leg}: config.json or a finite "
                             "model.safetensors is missing")
    log(f"leg {leg}: checkpoints {ckpts}, model.safetensors {len(export)} "
        f"tensors, eval {dict((k, res6[k]) for k in metric_keys)}")
    for name in kernels:
        if counts[name] <= 0:
            raise AssertionError(f"leg {leg}: kernel {name} never launched")
    return counts


def run_leg_e(work: Path, spec: Path) -> None:
    """run_classification on the VideoMAE route: the ViT-Base encoder of
    configs/mim_base_512.json at 224^2 x 160, mlp_impl pallas_bwd, a
    survival task with one tabular column (kernels K1, K4, K5a, K5b in
    training, K6 in eval)."""
    from smb_vision_tpu_torch.models.configs import VideoMAEConfig

    preset = json.loads(MIM_PRESET.read_text())
    cfg = VideoMAEConfig(
        image_size=224, num_frames=160, patch_size=preset["patch_size"],
        tubelet_size=preset["patch_size"], num_channels=1,
        **{k: preset[k] for k in ("hidden_size", "num_hidden_layers",
                                  "num_attention_heads", "intermediate_size",
                                  "dtype", "mlp_impl",
                                  "gradient_checkpointing")})
    path = work / "leg_e_config.json"
    cfg.save_json(str(path))
    run_finetune_leg(work, spec, "E", path, "survival",
                     {"additional_feature_columns": ["age"]},
                     ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd",
                      "mlp_fwd"), ("eval_c_index",))


def run_leg_f(work: Path, spec: Path, table: dict) -> None:
    """run_classification on the DINOv2 route, the slice's main path: the
    DINOv2-giant config at full width, depth cut to LEG_F_LAYERS, one
    checkpoint kept, a classification task with accuracy and ROC-AUC
    (kernels K1, K4 and K9). Its launch counts go into the kernel table."""
    path = work / "leg_f_dinov2_giant.json"
    giant_config(num_hidden_layers=LEG_F_LAYERS).save_json(str(path))
    log(f"leg F: DINOv2-giant at full width, depth cut from "
        f"{GIANT['num_hidden_layers']} to {LEG_F_LAYERS} layers")
    counts = run_finetune_leg(
        work, spec, "F", path, "classification", {"save_total_limit": 1},
        ("flash_fwd", "flash_bwd", "swiglu_block_fwd"),
        ("eval_accuracy", "eval_roc_auc"))
    table["swiglu_block_fwd"]["launches"] = counts["swiglu_block_fwd"]


# ---------------------------------------------------------------------------
# LoRA, the 8-bit AdamW and the encoder zoo (PR 15's slice)
# ---------------------------------------------------------------------------

LORA_RANK = 8
LORA_B_STD = 2e-3       # B's draw in the LoRA parity's second step
# the seeds of the LoRA parity's step with B drawn: over seeds 0-2 alone
# its mean ratio read 1.342 (1.08, 1.64, 1.31), over 0-8 1.08, the
# kernels nearer float32 than the plain path at most of seeds 3-8
# (PERF.md §6, PR 15): one bf16 step's chaos needs more seeds to average
LORA_DRAWN_SEEDS = tuple(range(9))
LEG_L_KERNELS = ("flash_fwd", "flash_bwd", "mlp_train_fwd", "mlp_bwd",
                 "mlp_fwd")
SIGLIP_BATCH = 32
SIGLIP_IMAGES = 64      # two batches of 32 through run_encoders
SIGLIP_N = 576          # 384/16 squared
MERLIN_STAGES = (3, 8, 36, 3)     # ResNet-152
MERLIN_BATCH = 2
ZOO_KERNELS = ("flash_fwd", "mlp_block_fwd")


def ckpt_state(path: Path) -> dict:
    """A checkpoint's state.pt, its tensors memory-mapped."""
    import torch

    return torch.load(path / "state.pt", map_location="cpu",
                      weights_only=True, mmap=True)


def equal_checkpoints(what: str, a: dict, b: dict,
                      parts=("model", "teacher")) -> int:
    """Assert two checkpoints hold the same model (and teacher) tensors
    and the same optimizer moments, byte for byte; returns the number of
    tensors compared."""
    import torch

    n = 0
    for part in parts:
        if part not in a:
            continue
        if a[part].keys() != b[part].keys():
            raise AssertionError(f"{what}: {part} names differ")
        for k in a[part]:
            if not torch.equal(a[part][k], b[part][k]):
                raise AssertionError(f"{what}: {part} tensor {k} differs")
            n += 1
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    if sa.keys() != sb.keys() or not sa:
        raise AssertionError(f"{what}: optimizer states differ in keys")
    for i in sa:
        for k in sa[i]:
            if not torch.equal(sa[i][k], sb[i][k]):
                raise AssertionError(f"{what}: optimizer {i}.{k} differs")
            n += 1
    return n


@contextlib.contextmanager
def sigterm_at(step: int):
    """Inside the block the Trainer gets a SIGTERM as global step `step`
    (0-based) starts: it finishes that step, checkpoints it and stops."""
    import signal

    from smb_vision_tpu_torch.train import trainer as T

    inner = T.step_generator
    sent = []

    def gen(seed, s):
        if s == step and not sent:
            sent.append(s)
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(seed, s)

    T.step_generator = gen
    try:
        yield sent
    finally:
        T.step_generator = inner


def run_leg_l(work: Path, vols: Path, spec: Path) -> None:
    """Leg L, LoRA fine-tuning on the VideoMAE route: leg E's config and
    spec with --lora_enable --lora_rank 8 --optim adamw8bit (a constant
    rate after the warm-up step, so a run's length leaves its schedule
    alone): 4 steps, a checkpoint every 2, eval, then a resume to 6
    (`run_finetune_leg`: K1, K4, K5a and K5b in training, K6 in eval);
    beside it a straight 6-step run. Asserts the three files, the frozen
    base (model.safetensors the same bytes after 4 and 6 steps; only
    adapted kernels and the head differ in model_merged.safetensors), the
    resumed checkpoint equal to the straight one byte for byte (the int8
    codes and scales), and run_inference from model_merged.safetensors."""
    import numpy as np

    from smb_vision_tpu_torch.cli.run_classification import main as run_cls
    from smb_vision_tpu_torch.cli.run_inference import main as run_inference
    from smb_vision_tpu_torch.models.convert import read_safetensors

    cfg_path = work / "leg_e_config.json"
    extra = {"additional_feature_columns": ["age"], "lora_enable": True,
             "lora_rank": LORA_RANK, "optim": "adamw8bit",
             "lr_scheduler_type": "constant"}
    out = work / "leg_L"
    # the base after 4 steps, read before the resume rewrites the file
    base4 = {}

    def keep_base():
        base4.update(read_safetensors(out / "model.safetensors"))

    run_finetune_leg(work, spec, "L", cfg_path, "survival", extra,
                     LEG_L_KERNELS, ("eval_c_index",), after_first=keep_base)
    for name in ("lora.safetensors", "model_merged.safetensors"):
        if not (out / name).exists():
            raise AssertionError(f"leg L: no {name}")
    base = read_safetensors(out / "model.safetensors")
    merged = read_safetensors(out / "model_merged.safetensors")
    lora = read_safetensors(out / "lora.safetensors")
    if base.keys() != base4.keys() or any(
            not np.array_equal(base[k], base4[k]) for k in base):
        raise AssertionError("leg L: the frozen base changed between the "
                             "4-step and the 6-step run")
    moved = sorted(k for k in base if not np.array_equal(base[k], merged[k]))
    adapted = {k[len("adapters."):-len(".a")].replace("/", ".")
               for k in lora if k.startswith("adapters.") and k.endswith(".a")}
    if not moved or any(k not in adapted and "classifier" not in k
                        and "fc_norm" not in k for k in moved):
        raise AssertionError(f"leg L: tensors moved outside the adapters "
                             f"and the head: {moved[:8]}")
    n_adapter = sum(lora[k].size for k in lora if k.startswith("adapters."))
    straight = work / "leg_L_straight"
    path = work / "leg_L_straight.json"
    path.write_text(json.dumps(dict(
        train_data_path=str(spec), val_data_path=str(spec),
        output_dir=str(straight), config_name_or_path=str(cfg_path),
        task_type="survival", learning_rate=1e-4, vision_lr=VISION_LR,
        merger_lr=MERGER_LR, warmup_ratio=0.1,
        per_device_train_batch_size=2, per_device_eval_batch_size=3,
        num_train_steps=6, save_steps=2, logging_steps=1, do_eval=False,
        num_workers=2, **extra)))
    t0 = time.perf_counter()
    run_cls([str(path)])
    wall = time.perf_counter() - t0
    n = equal_checkpoints("leg L resume", ckpt_state(out / "checkpoints/6"),
                          ckpt_state(straight / "checkpoints/6"))
    shutil.rmtree(straight)
    emb = work / "emb_L"
    ws = reset_launches()
    stats = run_inference([
        "--data_dir", str(vols), "--output_dir",
        str(emb), "--config_path", str(cfg_path), "--model_name_or_path",
        str(out / "model_merged.safetensors"), "--batch_size", "2",
        "--device", "cuda", "--num_workers", "2"])
    icounts = {k: w.launches for k, w in ws.items() if w.launches}
    embs = [np.load(f) for f in sorted(emb.glob("*.npy"))]
    if stats != {"embedded": N_VOLUMES, "failed": 0, "skipped": 0} or \
            not all(np.isfinite(e).all() for e in embs):
        raise AssertionError(f"leg L: run_inference from the merged "
                             f"export: {stats}")
    log(f"leg L: LoRA rank {LORA_RANK}, {n_adapter} adapter parameters; "
        f"model.safetensors (the frozen base) equal after 4 and 6 steps; "
        f"{len(moved)} tensors merged or trained in model_merged."
        f"safetensors; the resumed checkpoint equals a straight 6-step "
        f"run's byte for byte ({n} tensors, int8 codes and scales "
        f"included; the straight run {wall:.1f} s); run_inference from "
        f"model_merged.safetensors {stats}, launches {icounts}")
    shutil.rmtree(out)
    shutil.rmtree(emb)


def lora_parity(seed: int, zero: bool = True) -> dict:
    """LoRA steps on DINOv2-giant (its depth cut to LORA_PARITY_LAYERS;
    forward and backward, remat, no update) at batch 2, rank 8 on the
    default targets, the same weights,
    adapters and batch through the kernels, through their plain versions
    under the same impl names and in float32: with `zero`, the first step
    of a run (the adapters as `init_lora` makes them, A drawn from the
    seed, B = 0); then, on the same model, B drawn from N(0, LORA_B_STD)
    (the same draw on every path), so that the merge changes every
    adapted weight and A gets a gradient. K9 launches once a layer a
    forward (twice with remat) and the plain path launches none; at B = 0 every A
    gets a zero gradient and every B a finite one. Returns the losses and
    the adapters' gradients' errors against float32 of each step ("B =
    0": B's; "B drawn": A's and B's)."""
    import torch

    from smb_vision_tpu_torch.models.dinov2 import (
        Dinov2ForImageClassification,
    )
    from smb_vision_tpu_torch.train import lora

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    batch = dinov2_batch(2, 6 + seed, dev)
    with torch.device(dev):
        init = Dinov2ForImageClassification(giant_config(
            num_hidden_layers=LORA_PARITY_LAYERS)).init_weights(
            torch.Generator(device=dev).manual_seed(seed)).state_dict()

    def step(**kw):
        with torch.device(dev):
            model = Dinov2ForImageClassification(giant_config(
                num_hidden_layers=LORA_PARITY_LAYERS, **kw))
        model.load_state_dict(init)
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        lora.init_lora(model, gen, rank=LORA_RANK)
        n_adapters = lora.lora_size(model)
        model.train()
        deltas = [d for _, (_, d) in sorted(lora.adapted(model).items())]
        first = None
        if zero:
            loss = model(batch["pixel_values"],
                         labels=batch["labels"])["loss"]
            loss.backward()
            if any(bool(d.a.grad.any()) for d in deltas):
                raise AssertionError(f"LoRA step {kw}: an A got a gradient "
                                     f"with B = 0")
            first = (float(loss.detach()), torch.cat(
                [d.b.grad.float().flatten() for d in deltas]))
            model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for d in deltas:
                d.b.normal_(0.0, LORA_B_STD, generator=gen)
        drawn = model(batch["pixel_values"], labels=batch["labels"])["loss"]
        drawn.backward()
        flat_ab = torch.cat([t.grad.float().flatten() for d in deltas
                             for t in (d.a, d.b)])
        # a parametrized module sits in reference cycles: collect it, so
        # the next path's memory starts clean
        del model, deltas
        gc.collect()
        torch.cuda.empty_cache()
        return first, (float(drawn.detach()), flat_ab), n_adapters

    ws = reset_launches()
    k_zero, drawn, n_adapters = step()
    counts = {name: w.launches for name, w in ws.items()}
    layers = LORA_PARITY_LAYERS
    if counts["swiglu_block_fwd"] != (4 if zero else 2) * layers or not (
            counts["flash_fwd"] > 0 and counts["flash_bwd"] > 0):
        raise AssertionError(f"LoRA steps: launches {counts}")
    ws = reset_launches()
    with plain_kernels():
        p_zero, p_drawn, _ = step()
    if any(w.launches for w in ws.values()):
        raise AssertionError("the plain LoRA path launched a kernel")
    f_zero, f_drawn, _ = step(attn_impl="xla", mlp_impl="xla",
                              dtype="float32")
    out = {}
    for what, (loss, grad), (p_loss, p_grad), (f_loss, f_grad) in (
            (("B = 0", k_zero, p_zero, f_zero),) if zero else ()) + (
            ("B drawn", drawn, p_drawn, f_drawn),):
        if not (bool(grad.isfinite().all()) and math.isfinite(loss)):
            raise AssertionError(f"the LoRA kernel path's loss or gradient "
                                 f"is not finite ({what})")
        norm = float(f_grad.norm())
        got = out[what] = {
            "loss": loss, "plain loss": p_loss, "f32 loss": f_loss,
            "rel loss": abs(loss - p_loss) / abs(p_loss),
            "grad err": float((grad - f_grad).norm()) / norm,
            "plain grad err": float((p_grad - f_grad).norm()) / norm}
        log(f"LoRA parity, seed {seed}, {what}: DINOv2-giant at "
            f"{LORA_PARITY_LAYERS} layers, rank "
            f"{LORA_RANK}, {n_adapters} adapter parameters, batch 2 (N "
            f"{DINO_N}): loss kernels {loss:.6f}, plain {p_loss:.6f}, f32 "
            f"{f_loss:.6f} (rel {got['rel loss']:.3e}); the adapters' "
            f"gradient error vs f32: kernels {got['grad err']:.3e}, plain "
            f"{got['plain grad err']:.3e} (ratio "
            f"{got['grad err'] / got['plain grad err']:.3f})")
    log(f"LoRA parity, seed {seed}: launches {counts}")
    return out


def phase_lora_parity() -> None:
    """`lora_parity` under C1's rule. At B = 0, the state every LoRA run
    starts from, at seeds 0, 1 and 2: the mean loss gap to the plain
    versions within TOL_TRAIN_LOSS, and at each seed B's gradient error
    against float32 within TOL_TRAIN_GRAD_VS_F32 times the plain
    versions'. With B drawn, at LORA_DRAWN_SEEDS: the mean loss gap
    within TOL_TRAIN_LOSS, and the mean over the seeds of the gradient
    errors' ratio (kernels to plain) within TOL_TRAIN_GRAD_VS_F32: one
    bf16 step at random weights is chaotic (C1), more so with every
    adapted weight changed, so the gradient rule is decided on the mean,
    as C1 decides the loss."""
    seeds = sorted(set(DINO_PARITY_SEEDS) | set(LORA_DRAWN_SEEDS))
    got = [lora_parity(seed, zero=seed in DINO_PARITY_SEEDS)
           for seed in seeds]
    ok = True
    for what in ("B = 0", "B drawn"):
        rows = [g[what] for g in got if what in g]
        seeds = DINO_PARITY_SEEDS if what == "B = 0" else LORA_DRAWN_SEEDS
        gap = sum(r["rel loss"] for r in rows) / len(rows)
        ratios = [r["grad err"] / r["plain grad err"] for r in rows]
        if what == "B = 0":
            grads_ok = max(ratios) <= TOL_TRAIN_GRAD_VS_F32
            rule = "at every seed"
        else:
            grads_ok = sum(ratios) / len(ratios) <= TOL_TRAIN_GRAD_VS_F32
            rule = f"on the mean {sum(ratios) / len(ratios):.3f}"
        ok &= gap <= TOL_TRAIN_LOSS and grads_ok
        log(f"LoRA parity verdict, {what}, over seeds {seeds}: "
            f"mean loss gap {gap:.3e} (bound {TOL_TRAIN_LOSS}); gradient "
            f"error ratios {[round(r, 3) for r in ratios]}, the rule "
            f"(bound {TOL_TRAIN_GRAD_VS_F32}) {rule}: {grads_ok}")
    log(f"LoRA parity: {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("LoRA parity fails over the seeds")


def phase_lora_throughput(card: str, full: dict, iters: int = 3) -> None:
    """DINOv2-giant fine-tune steps with LoRA rank 8 on the default
    targets and the 8-bit AdamW (two tiers) at batch 2 and 4, and with
    AdamW at batch 2 (the 8-bit update's cost apart), beside the full
    fine-tune rows of `phase_finetune_throughput` (`full`: {batch: (ms,
    peak GiB)}): ms a step, peak memory and the adapter count."""
    import torch

    from smb_vision_tpu_torch.train.lora import (
        lora_size,
        make_lora_classification_workload,
    )
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator
    from smb_vision_tpu_torch.utils.profiling import (
        classification_flops_per_sample,
    )

    dev = torch.device("cuda")
    cfg = giant_config(problem_type="single_label_classification")
    flops = classification_flops_per_sample(cfg)
    for bs, optim in ((2, "adamw8bit"), (4, "adamw8bit"), (2, "adamw")):
        # the models before this one (parametrized: in reference cycles)
        # leave the card before the peak is read
        gc.collect()
        torch.cuda.empty_cache()
        model, init_fn, step_fn, eval_fn = make_lora_classification_workload(
            cfg, task_type="classification", device=dev, rank=LORA_RANK,
            tx=functools.partial(make_optimizer, learning_rate=1e-4,
                                 total_steps=100, vision_lr=VISION_LR,
                                 merger_lr=MERGER_LR, optim=optim))
        state = init_fn(0)
        batches = [dinov2_batch(bs, 10 + i, dev) for i in range(iters + 1)]

        def step(i):
            return step_fn(state, batches[i], step_generator(0, i))

        ms, mem = time_train_steps(
            f"DINOv2-giant LoRA r{LORA_RANK} {optim}", card, bs, flops,
            step, iters, watch=K9_KERNELS)
        fms, fmem = full[bs]
        log(f"DINOv2-giant batch {bs}: LoRA {optim} ({lora_size(model)} "
            f"adapter parameters) {ms:.1f} ms, peak {mem:.2f} GiB; full "
            f"fine-tune {fms:.1f} ms, peak {fmem:.2f} GiB: "
            f"{fmem - mem:.2f} GiB less "
            f"(the gradients and AdamW moments of 1.1 B float32 "
            f"parameters are ~13 GiB)")
        del model, init_fn, step_fn, eval_fn, state, batches, step
        torch.cuda.empty_cache()


def run_leg_o(work: Path, vols: Path) -> None:
    """Leg O, the 8-bit optimizer on the V-JEPA preset's single-chip
    recipe: run_vjepa with configs/vjepa_large_384_tpu.json and the two
    keys its _comment names ("optim": "adamw8bit", "grad_accum_dtype":
    "bfloat16"), accumulation cut to LEG_D_ACCUM. A 4-step run stopped by
    a SIGTERM after step 2 (`sigterm_at`), then resumed to 4, beside a
    straight 4-step run: the V-JEPA kernels launch (check_vjepa_launches),
    the losses are finite and the resumed checkpoint (student, EMA
    teacher, int8 moments) equals the straight one byte for byte."""
    from smb_vision_tpu_torch.cli.run_vjepa import main as run_vjepa

    nii = [{"image": str(p)} for p in sorted(vols.glob("*.nii"))]
    spec = work / "vjepa_data_O.json"
    spec.write_text(json.dumps({"train": nii[:3], "validation": nii[3:]}))
    preset = json.loads(VJEPA_PRESET.read_text())
    keys = {"optim": "adamw8bit", "grad_accum_dtype": "bfloat16"}
    log(f"leg O: {VJEPA_PRESET.name} with {keys} (its _comment's single-"
        f"chip recipe), gradient_accumulation_steps cut from "
        f"{preset['gradient_accumulation_steps']} to {LEG_D_ACCUM}, the "
        f"encoder from {preset['num_hidden_layers']} to {LEG_O_LAYERS} "
        f"layers")
    overrides = ",".join(filter(None, (
        preset.get("config_overrides"),
        f"num_hidden_layers={LEG_O_LAYERS}")))

    def run(out, steps=4):
        path = work / f"vjepa_O_{out.name}.json"
        path.write_text(json.dumps(dict(
            preset, **keys, gradient_accumulation_steps=LEG_D_ACCUM,
            config_overrides=overrides,
            data_path=str(spec), output_dir=str(out), num_train_steps=steps,
            save_steps=2, save_total_limit=1, logging_steps=1,
            do_eval=False, num_workers=2)))
        t0 = time.perf_counter()
        res = run_vjepa([str(path)])
        return res, time.perf_counter() - t0

    out, straight = work / "leg_O", work / "leg_O_straight"
    ws = reset_launches()
    with sigterm_at(1) as sent:
        res1, wall1 = run(out)
    counts = {name: w.launches for name, w in ws.items()}
    if not sent or res1["train_steps"] != 2:
        raise AssertionError(f"leg O: the SIGTERM run stopped at {res1}")
    check_vjepa_launches("leg O", counts)
    res2, wall2 = run(out)
    res3, wall3 = run(straight)
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in recs if "loss" in r]
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"leg O losses {losses}")
    a, b = ckpt_state(out / "checkpoints/4"), ckpt_state(
        straight / "checkpoints/4")
    codes = [s["mu"] for s in a["optimizer"]["adamw"]["state"].values()]
    n = equal_checkpoints("leg O resume", a, b)
    int8_bytes = sum(c.numel() for c in codes) * 2
    log(f"leg O: stopped by SIGTERM at {res1['train_steps']} in {wall1:.1f} "
        f"s, resumed to {res2['train_steps']} in {wall2:.1f} s, straight "
        f"{res3['train_steps']} in {wall3:.1f} s; losses {losses}; the "
        f"resumed checkpoint equals the straight one byte for byte ({n} "
        f"tensors: student, teacher, int8 codes and scales); moments "
        f"{int8_bytes / 2**30:.3f} GiB of int8 codes; launches {counts}")
    for r in recs:
        if "loss" in r:
            log(f"  step {r['step']}: loss {r['loss']:.6f}, "
                f"{r['step_time_ms']:.1f} ms")
    del a, b
    shutil.rmtree(out)
    shutil.rmtree(straight)


def siglip_base(root: Path, seed: int = 0, name: str = "siglip_base",
                dev: str = "cpu", **widths) -> Path:
    """A seeded SigLIP-base-patch16-384 (the config's defaults; `widths`
    set others, as SO400M does) written as an HF checkpoint directory
    under `name`: config.json and model.safetensors (`export_hf_siglip`,
    `vision_model.*`); the weights initialised on `dev` (the card takes
    so400m's 0.43 B parameters in a moment, the host's CPU in tens of
    seconds)."""
    import torch

    from smb_vision_tpu_torch.models.configs import SiglipVisionConfig
    from smb_vision_tpu_torch.models.convert import (
        export_hf_siglip,
        write_safetensors,
    )
    from smb_vision_tpu_torch.models.siglip import SiglipVisionModel

    cfg = SiglipVisionConfig(**widths)
    with torch.device(dev):
        model = SiglipVisionModel(cfg).to(dev).init_weights(
            torch.Generator(device=dev).manual_seed(seed)).cpu()
    ckpt = root / name
    ckpt.mkdir()
    write_safetensors(ckpt / "model.safetensors",
                      export_hf_siglip(model.state_dict()))
    (ckpt / "config.json").write_text(json.dumps(
        {k: v for k, v in cfg.to_dict().items()
         if k not in ("dtype", "attn_impl", "mlp_impl", "glue_impl",
                      "gradient_checkpointing")}))
    return ckpt


def merlin_resnet152(root: Path, seed: int = 0) -> Path:
    """A seeded Merlin image tower, I3D ResNet-152 (stage sizes 3, 8, 36,
    3), as a torchvision-schema state dict under Merlin's
    `encode_image.i3_resnet.` (`export_torch_resnet3d`): lecun-normal
    convolutions, the BN statistics at identity and each bottleneck's last
    BN scaled to 0.2, which keeps 50 residual blocks of random weights in
    range."""
    import torch

    from smb_vision_tpu_torch.models.configs import ResNet3DConfig
    from smb_vision_tpu_torch.models.convert import (
        export_torch_resnet3d,
        write_safetensors,
    )
    from smb_vision_tpu_torch.models.resnet3d import ResNet3D

    cfg = ResNet3DConfig(stage_sizes=MERLIN_STAGES)
    model = ResNet3D(cfg).init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("cb3.bn.weight"):
                buf.fill_(0.2)
    sd = export_torch_resnet3d(model.state_dict(), cfg)
    path = root / "merlin_resnet152.safetensors"
    write_safetensors(path, {"encode_image.i3_resnet." + k: v
                             for k, v in sd.items()})
    return path


def encode_rate(label: str, card: str, encode, px, n_items: int,
                iters: int = 3) -> tuple:
    """encode(px[i]) over `iters` seeded batches after a warm-up, CUDA
    events: (ms a batch, items/s, peak GiB)."""
    import torch

    encode(px[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(1, iters + 1):
        encode(px[i])
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label}: {ms:.1f} ms a batch of {n_items} = "
        f"{n_items * 1e3 / ms:.2f} items/s, peak {mem:.2f} GiB, on {card}")
    return ms, n_items * 1e3 / ms, mem


def run_leg_z(work: Path, vols: Path, card: str, table: dict) -> None:
    """Leg Z, the encoder zoo on the card.
    1. SigLIP: `run_encoders --encoder siglip` on a seeded export of
       SigLIP-base-patch16-384 over SIGLIP_IMAGES seeded PNGs at batch 32:
       K1 and K2 launch 12 times a batch; every vector within TOL_MODEL
       of max of the same model on its plain path (`plain_kernels`); then
       images/s at batch 32 (`encode_rate`).
    2. Merlin: `run_encoders --encoder merlin` with a seeded I3D
       ResNet-152 on the 4 volumes through the "merlin" pipeline
       (224 x 224 x 160) at batch 2; the same volumes as uint8 codes
       decoded on the card within TOL_MODEL of the float vectors;
       volumes/s at batch 2 and the peak memory.
    3. Merlin serving: `serve --encoder merlin` in the process at batch 2,
       one 2-volume request, within TOL_SERVE of max of run_encoders'
       vectors (their token means)."""
    import numpy as np
    import pandas as pd
    import torch
    from PIL import Image

    from smb_vision_tpu_torch.cli.run_encoders import main as run_encoders
    from smb_vision_tpu_torch.data.image2d import Image2DDataset
    from smb_vision_tpu_torch.inference.encoders import (
        MerlinEncoder,
        SiglipEncoder,
    )

    dev = torch.device("cuda")
    # 1. SigLIP
    ckpt = siglip_base(work)
    rng = np.random.default_rng(7)
    items = []
    imgs = work / "xrays"
    imgs.mkdir()
    for i in range(SIGLIP_IMAGES):
        p = imgs / f"xr_{i:03d}.png"
        Image.fromarray(rng.integers(0, 255, (512, 448, 3), np.uint8)).save(p)
        items.append({"uid": f"xr_{i:03d}", "image_path": str(p)})
    manifest = work / "xrays.json"
    manifest.write_text(json.dumps({"images": items}))
    out = work / "emb_siglip"
    ws = reset_launches()
    t0 = time.perf_counter()
    stats = run_encoders(["--encoder", "siglip", "--checkpoint", str(ckpt),
                          "--input_json", str(manifest), "--output_dir",
                          str(out), "--batch_size", str(SIGLIP_BATCH),
                          "--num_workers", "4"])
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in ws.items() if w.launches}
    batches = SIGLIP_IMAGES // SIGLIP_BATCH
    if stats != {"embedded": SIGLIP_IMAGES, "failed": 0, "skipped": 0} or \
            any(counts.get(k, 0) != 12 * batches for k in ZOO_KERNELS):
        raise AssertionError(f"leg Z SigLIP: {stats}, launches {counts}")
    got = np.stack([np.asarray(pd.read_parquet(
        out / "model_id=siglip" / f"{it['uid']}.parquet").iloc[0][
        "embedding"]) for it in items])
    enc = SiglipEncoder(str(ckpt), device="cuda")
    enc.setup_model()
    ds = Image2DDataset(items, image_size=enc.image_size)
    px = np.stack([ds[i]["image"] for i in range(SIGLIP_IMAGES)])
    ws = reset_launches()
    with plain_kernels():
        ref = np.concatenate([
            enc.generate_embedding(px[i:i + SIGLIP_BATCH])
            for i in range(0, SIGLIP_IMAGES, SIGLIP_BATCH)])
    if any(w.launches for w in ws.values()):
        raise AssertionError("leg Z: the plain SigLIP path launched a "
                             "kernel")
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"leg Z SigLIP-base-patch16-384 ({enc.model.config.seq_len} "
        f"tokens, 12 x 64 heads, MLP 3,072): run_encoders {stats} in "
        f"{wall:.1f} s (PNG decode + resize + encode + parquet); launches "
        f"{counts}; vectors vs the plain path max|d|/max|ref| {err:.3e} "
        f"(bound {TOL_MODEL})")
    if not (err <= TOL_MODEL and np.isfinite(got).all()):
        raise AssertionError(f"leg Z SigLIP: {err}")
    gen = torch.Generator(device=dev).manual_seed(11)
    pxs = [torch.randn((SIGLIP_BATCH, 3, 384, 384), generator=gen,
                       device=dev) for _ in range(4)]
    encode_rate(f"SigLIP-base batch {SIGLIP_BATCH}", card, enc.encode, pxs,
                SIGLIP_BATCH)
    del enc, pxs
    torch.cuda.empty_cache()
    run_leg_m(work, items, manifest, card, table)

    # 2. Merlin
    mckpt = merlin_resnet152(work)
    vitems = [{"uid": p.stem, "image_path": str(p)}
              for p in sorted(vols.glob("*.nii"))]
    vman = work / "ct.json"
    vman.write_text(json.dumps({"images": vitems}))
    mout = work / "emb_merlin"
    ws = reset_launches()
    t0 = time.perf_counter()
    stats = run_encoders(["--encoder", "merlin", "--checkpoint", str(mckpt),
                          "--input_json", str(vman), "--output_dir",
                          str(mout), "--batch_size", str(MERLIN_BATCH),
                          "--num_workers", "2"])
    wall = time.perf_counter() - t0
    if stats != {"embedded": N_VOLUMES, "failed": 0, "skipped": 0}:
        raise AssertionError(f"leg Z Merlin: {stats}")
    rows = [pd.read_parquet(mout / "model_id=merlin"
                            / f"{it['uid']}.parquet").iloc[0]
            for it in vitems]
    shape = tuple(int(s) for s in rows[0]["embedding_shape"])
    toks = np.stack([np.asarray(r["embedding"]).reshape(shape)
                     for r in rows])
    enc = MerlinEncoder(checkpoint=str(mckpt), device="cuda")
    enc.setup_model()
    ds8 = enc.create_dataset(vitems, out_dtype="uint8")
    exs = [ds8[i] for i in range(N_VOLUMES)]
    q = np.stack([np.asarray(e["image"]) for e in exs])
    sc = np.asarray([e["image_scale"] for e in exs], np.float32)
    of = np.asarray([e["image_offset"] for e in exs], np.float32)
    tok8 = np.concatenate([
        enc.generate_embedding(q[i:i + MERLIN_BATCH],
                               scale=sc[i:i + MERLIN_BATCH],
                               offset=of[i:i + MERLIN_BATCH])
        for i in range(0, N_VOLUMES, MERLIN_BATCH)])
    err8 = float(np.abs(tok8 - toks).max() / np.abs(toks).max())
    log(f"leg Z Merlin I3D ResNet-152 (stages {MERLIN_STAGES}, hidden "
        f"{enc.config.hidden_size}): run_encoders {stats} in {wall:.1f} s; "
        f"tokens {shape} a volume, finite {bool(np.isfinite(toks).all())}, "
        f"max |x| {float(np.abs(toks).max()):.3e}; uint8 pixels vs float "
        f"max|d|/max|ref| {err8:.3e} (bound {TOL_MODEL})")
    if not (np.isfinite(toks).all() and err8 <= TOL_MODEL):
        raise AssertionError(f"leg Z Merlin: uint8 {err8}")
    gen = torch.Generator(device=dev).manual_seed(12)
    size = enc.pipeline().target_size
    pxs = [torch.rand((MERLIN_BATCH, 1, *size), generator=gen, device=dev)
           for _ in range(4)]
    encode_rate(f"Merlin ResNet-152 batch {MERLIN_BATCH}", card, enc.encode,
                pxs, MERLIN_BATCH)
    del enc, pxs
    torch.cuda.empty_cache()

    # 3. Merlin serving
    with serving(encoder="merlin", model_name_or_path=str(mckpt)) as srv:
        status, health, _, _ = http_call(srv, "GET", "/healthz")
        status2, ans, wall, split = http_call(srv, "POST", "/embed", {
            "images": [it["image_path"] for it in vitems[:2]]})
    want = toks[:2].mean(axis=1)
    got = np.asarray(ans["embeddings"])
    err = float(np.abs(got - want).max() / np.abs(want).max())
    log(f"leg Z serve --encoder merlin: /healthz {health}; a 2-volume "
        f"request {1e3 * wall:.1f} ms ({split_line(split)}); answer vs "
        f"run_encoders' token means max|d|/max|ref| {err:.3e} (bound "
        f"{TOL_SERVE})")
    if status != 200 or status2 != 200 or err > TOL_SERVE or \
            health.get("pixel_shape") != [1, *size]:
        raise AssertionError(f"leg Z serving: {status}, {status2}, {err}")
    shutil.rmtree(imgs)
    shutil.rmtree(out)
    shutil.rmtree(mout)


def run_leg_m(work: Path, items: list, manifest: Path, card: str,
              table: dict) -> None:
    """Leg M, SigLIP so400m-patch14-384 (SO400M: 27 layers of 16 heads of
    72, MLP 4,304, 729 tokens), seeded and exported as `siglip_base`
    exports SigLIP-base: `run_encoders --encoder siglip` over leg Z's
    SIGLIP_IMAGES PNGs at batch 32. K1 launches at d 72 27 times a batch;
    the MLP (F 4,304, no multiple of 32) and the MAP head run plain, as in
    the JAX package, so K2 and K6 never launch and the plain attention
    runs only in the head. Every vector within TOL_MODEL of max of the
    same model on `plain_kernels`. Then the same tower under "pallas_int8"
    (K3) and "pallas_int8pv" (K8) on one batch: 27 launches each at d 72,
    within TOL_MODEL of their plain versions. Then images/s at batch 32."""
    import numpy as np
    import pandas as pd
    import torch

    from smb_vision_tpu_torch.cli.run_encoders import main as run_encoders
    from smb_vision_tpu_torch.data.image2d import Image2DDataset
    from smb_vision_tpu_torch.inference.encoders import SiglipEncoder

    dev = torch.device("cuda")
    layers, d = SO400M["num_hidden_layers"], 72
    ckpt = siglip_base(work, name="siglip_so400m", dev="cuda", **SO400M)
    out = work / "emb_so400m"
    ws = reset_launches()
    t0 = time.perf_counter()
    with plain_attention_calls() as plain:
        stats = run_encoders(["--encoder", "siglip", "--checkpoint",
                              str(ckpt), "--input_json", str(manifest),
                              "--output_dir", str(out), "--batch_size",
                              str(SIGLIP_BATCH), "--num_workers", "4"])
    wall = time.perf_counter() - t0
    counts = {k: w.launches for k, w in ws.items() if w.launches}
    at72 = width_launches(ws, "flash_fwd", d)
    batches = SIGLIP_IMAGES // SIGLIP_BATCH
    log(f"leg M SigLIP so400m-patch14-384 ({SO400M_N} tokens, {layers} x 16 "
        f"heads of {d}, MLP 4,304): run_encoders {stats} in {wall:.1f} s; "
        f"launches {counts}, K1 at d {d} {at72}; plain attention calls by "
        f"head width {plain}")
    if stats != {"embedded": SIGLIP_IMAGES, "failed": 0, "skipped": 0} or \
            at72 != layers * batches or counts != {"flash_fwd": at72} or \
            plain.get(d, 0) != batches:
        raise AssertionError(f"leg M: {stats}, launches {counts}, plain "
                             f"attention {plain} (the MAP head's one a "
                             "batch)")
    table["flash_fwd d72"]["launches"] = at72
    got = np.stack([np.asarray(pd.read_parquet(
        out / "model_id=siglip" / f"{it['uid']}.parquet").iloc[0][
        "embedding"]) for it in items])
    enc = SiglipEncoder(str(ckpt), device="cuda")
    enc.setup_model()
    ds = Image2DDataset(items, image_size=enc.image_size)
    px = np.stack([ds[i]["image"] for i in range(SIGLIP_IMAGES)])
    with plain_kernels():
        ref = np.concatenate([
            enc.generate_embedding(px[i:i + SIGLIP_BATCH])
            for i in range(0, SIGLIP_IMAGES, SIGLIP_BATCH)])
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"leg M: vectors vs the plain path max|d|/max|ref| {err:.3e} (bound "
        f"{TOL_MODEL})")
    if not (err <= TOL_MODEL and np.isfinite(got).all()):
        raise AssertionError(f"leg M: {err}")
    batch = torch.from_numpy(px[:SIGLIP_BATCH]).to(dev)
    tower = enc.model
    for impl, name in (("pallas_int8", "flash_fwd_i8"),
                       ("pallas_int8pv", "flash_fwd_i8pv")):
        for mod in tower.encoder.modules():
            if hasattr(mod, "attn_impl"):
                mod.attn_impl = impl
        ws = reset_launches()
        with torch.inference_mode():
            vec = tower(batch)[1].float()
            torch.cuda.synchronize()
            n8 = width_launches(ws, name, d)
            with plain_kernels():
                vref = tower(batch)[1].float()
        _, rel = errors(vec, vref)
        log(f"leg M, the so400m tower under {impl}: {name} at d {d} {n8}; "
            f"pooled vectors vs the plain versions rel {rel:.3e} (bound "
            f"{TOL_MODEL})")
        if n8 != layers or not rel <= TOL_MODEL:
            raise AssertionError(f"leg M {impl}: launches {n8}, rel {rel}")
        table[f"{name} d{d}"]["launches"] = n8
    for mod in tower.encoder.modules():
        if hasattr(mod, "attn_impl"):
            mod.attn_impl = "auto"
    gen = torch.Generator(device=dev).manual_seed(13)
    pxs = [torch.randn((SIGLIP_BATCH, 3, 384, 384), generator=gen,
                       device=dev) for _ in range(4)]
    encode_rate(f"SigLIP so400m batch {SIGLIP_BATCH}", card, enc.encode, pxs,
                SIGLIP_BATCH)
    del enc, tower, pxs, batch
    torch.cuda.empty_cache()
    shutil.rmtree(out)
    shutil.rmtree(ckpt)


# the kernels that must match the other checkout's, compared by SASS: K1,
# K3, K4, K7 and K8 at d 32, 64 and 128, K1 and K4 on their d-80 tiles,
# and their NARROW instantiations
# (which store a narrower head) by a part of their mangled names (this
# tree's, the other's: the same since K1's, K4's and K7's kernels took the
# tail maps of the d-80 tiles as a last parameter, which the part leaves
# out),
# and every kernel of the MLP forward and backward and the glue sources
# (K2, K6, K5a, K9 and their LayerNorm pass, K5b, K10a and its row pass,
# K10b) by its whole name, but any kernel this tree adds there
# (NEW_KERNELS; none); the outputs are compared bit for bit and the times
# in turns
UNCHANGED = {f"{k} d{d}{tag}": (name.format(d=d, n=n),) * 2
             for d in (32, 64, 128)
             for n, tag in ((0, ""), (1, " narrow"))
             for k, name in (
                 ("K1", "flash_fwd_sm90_kernelILi{d}ELb0ELb{n}EE"),
                 ("K3", "flash_fwd_sm90_kernelILi{d}ELb1ELb{n}EE"),
                 ("K4", "flash_bwd_sm90_kernelILi{d}ELb{n}EE"),
                 ("K7", "flash_bwd_i8_sm90_kernelILi{d}ELb{n}EE"),
                 ("K8", "flash_fwd_i8pv_sm90_kernelILi{d}ELb{n}EE"))}
UNCHANGED.update({f"{k} d80{tag}": (name.format(n=n),) * 2
                  for n, tag in ((0, ""), (1, " narrow"))
                  for k, name in (
                      ("K1", "flash_fwd_sm90_kernelILi80ELb0ELb{n}EE"),
                      ("K4", "flash_bwd_sm90_kernelILi80ELb{n}EE"))})
UNCHANGED_SOURCES = ("mlp_fwd_cu", "mlp_bwd_cu", "attn_glue_cu")
NEW_KERNELS: tuple = ()


def _anon(name: str) -> str:
    """A mangled name without the hashes of its anonymous namespace, which
    differ between two checkouts of the same source."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}",
                  r"_GLOBAL__N__\1", name)


def compare_sass(sass: dict) -> None:
    """Log whether each UNCHANGED kernel has the same SASS on both sides."""
    for label, (this, other) in UNCHANGED.items():
        a, b = (next((body for fn, body in sass[side].items() if name in fn),
                     None) for side, name in (("this", this),
                                              ("other", other)))
        log(f"against: SASS {label}: " + (
            "missing" if a is None or b is None else
            "identical" if a == b else "differs"))
    this = {_anon(fn): body for fn, body in sass["this"].items()
            if any(src in fn for src in UNCHANGED_SOURCES)
            and not any(new in fn for new in NEW_KERNELS)}
    other = {_anon(fn): body for fn, body in sass["other"].items()}
    same = sorted(fn for fn, body in this.items() if other.get(fn) == body)
    log(f"against: SASS of the MLP forward and backward and the glue "
        f"kernels (K2, K6, K5a, K9, K5b, K10a, K10b"
        + "".join(f"; not {new}" for new in NEW_KERNELS)
        + f"): {len(same)} of {len(this)} functions identical"
        + "".join(f"; differs or missing: {fn}"
                  for fn in sorted(set(this) - set(same))))


def unchanged_outputs(dev) -> tuple:
    """The outputs of the kernels at the widths they took before the
    runtime widths, on seeded inputs, through their wrappers (K3, K7 and
    K8 with their quantisation): K1, K3 and K8 at d 64 and 128, K4 at the
    MIM encoder's shape and at the V-JEPA encoder's (d 128), K7 at the
    V-JEPA encoder's and the reference-head encoder's (d 64), K1, K4, K7,
    K3 and K8 at the reference-head predictor's (d 32), K2, K6 and K5a at
    the embed shape, K5b at the MIM encoder's, K2 and K6 at K 1,024 (the
    V-JEPA encoder's MLP), K9 at DINOv2-giant batch 1 (K 1,536), K10a
    and K10b at the embed shape, and, for the LayerNorm pass at each K
    the parent compiled it for, K2 at K 128, 256, 384 and 512 and K9 at
    K 768 and 1,024; then past the instantiations' widths, K1, K4 and K8
    at d 72 and 80 and K1, K4, K3, K7 and K8 at d 96 (where the d-80
    tiles of K3 and K7 change nothing)."""
    import torch

    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import attn_glue as G
    from smb_vision_tpu_torch.ops import mlp as M

    gen = torch.Generator(device=dev).manual_seed(11)

    def r(*shape, s=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    bf = torch.bfloat16
    outs = []
    for n, h, d in ((MAIN_N, HEADS, HEAD_DIM), (VJ_N, 8, 128)):
        q, k, v = (r(1, n, h, d, s=0.4, dtype=bf) for _ in range(3))
        outs += [*A.flash_attention(q, k, v, with_lse=True),
                 A.flash_attention_int8(q, k, v),
                 A.flash_attention_int8pv(q, k, v)]
    q, k, v, do = (r(1, ENC_N, HEADS, HEAD_DIM, s=0.4, dtype=bf)
                   for _ in range(4))
    outs += A.flash_attention_bwd(q, k, v, *A.flash_attention(
        q, k, v, with_lse=True), do)
    q, k, v, do = (r(1, VJ_N, 8, 128, s=0.4, dtype=bf) for _ in range(4))
    outs += A.flash_attention_bwd_i8(q, k, v, *A.flash_attention(
        q, k, v, with_lse=True), do)
    outs += A.flash_attention_bwd(q, k, v, *A.flash_attention(
        q, k, v, with_lse=True), do)
    q, k, v, do = (r(1, VJ_N, 16, 64, s=0.4, dtype=bf) for _ in range(4))
    outs += A.flash_attention_bwd_i8(q, k, v, *A.flash_attention(
        q, k, v, with_lse=True), do)
    q, k, v, do = (r(1, VJ_N, PRED_HEADS, 32, s=0.4, dtype=bf)
                   for _ in range(4))
    out, lse = A.flash_attention(q, k, v, with_lse=True)
    outs += [out, lse, *A.flash_attention_bwd(q, k, v, out, lse, do),
             *A.flash_attention_bwd_i8(q, k, v, out, lse, do),
             A.flash_attention_int8(q, k, v), A.flash_attention_int8pv(
                 q, k, v)]
    x = r(MAIN_N, HIDDEN, dtype=bf)
    lnw, lnb = 1.0 + r(HIDDEN, s=0.1), r(HIDDEN, s=0.1)
    w1 = r(FFN, HIDDEN, s=HIDDEN ** -0.5, dtype=bf).t()
    w2 = r(HIDDEN, FFN, s=FFN ** -0.5, dtype=bf).t()
    b1, b2 = r(FFN, s=0.1), r(HIDDEN, s=0.1)
    outs += [M.mlp_block_fused(x, lnw, lnb, w1, b1, w2, b2, eps=1e-6),
             M.mlp_fused(x, w1, b1, w2, b2),
             *M.mlp_train_fused(x, w1, b1, w2, b2)]
    _, h = M._mlp_train_plain(x[:ENC_N], w1, b1, w2, b2, "gelu")
    outs += M.mlp_bwd_fused(h, x[:ENC_N], w1, w2)
    kv, fv = VJ_HIDDEN, VJ_FFN
    xv = r(VJ_N, kv, dtype=bf)
    lnv = (1.0 + r(kv, s=0.1), r(kv, s=0.1))
    wv1 = r(fv, kv, s=kv ** -0.5, dtype=bf).t()
    wv2 = r(kv, fv, s=fv ** -0.5, dtype=bf).t()
    bv1, bv2 = r(fv, s=0.1), r(kv, s=0.1)
    outs += [M.mlp_block_fused(xv, *lnv, wv1, bv1, wv2, bv2, eps=1e-6),
             M.mlp_fused(xv, wv1, bv1, wv2, bv2)]
    k, f = GIANT_K, GIANT_F
    outs.append(M.swiglu_block_fused(
        r(DINO_N, k, dtype=bf), 1.0 + r(k, s=0.1), r(k, s=0.1),
        r(2 * f, k, s=k ** -0.5, dtype=bf).t(), r(2 * f, s=0.1),
        r(k, f, s=f ** -0.5, dtype=bf).t(), r(k, s=0.1), eps=1e-6))
    lin = [r(HIDDEN, HIDDEN, s=HIDDEN ** -0.5, dtype=bf).t()
           for _ in range(4)]
    bs = [r(HIDDEN, s=0.1) for _ in range(4)]
    outs += G.qkv_ln_fused(x, lnw, lnb, *lin[:3], *bs[:3])
    outs.append(G.out_res_fused(x, outs[-1], lin[3], bs[3]))
    for m, k, f in ((4096, 128, 512), (4096, 256, 1024), (4096, 384, 1536),
                    (4096, 512, 2048)):
        outs.append(M.mlp_block_fused(
            r(m, k, dtype=bf), 1.0 + r(k, s=0.1), r(k, s=0.1),
            r(f, k, s=k ** -0.5, dtype=bf).t(), r(f, s=0.1),
            r(k, f, s=f ** -0.5, dtype=bf).t(), r(k, s=0.1), eps=1e-6))
    for m, k, f in ((MAIN_N, HIDDEN, 2048), (VJ_N, VJ_HIDDEN, 2816)):
        outs.append(M.swiglu_block_fused(
            r(m, k, dtype=bf), 1.0 + r(k, s=0.1), r(k, s=0.1),
            r(2 * f, k, s=k ** -0.5, dtype=bf).t(), r(2 * f, s=0.1),
            r(k, f, s=f ** -0.5, dtype=bf).t(), r(k, s=0.1), eps=1e-6))
    for n, h, d in ((SO400M_N, 16, 72), (4096, 16, 80), (4096, 8, 96)):
        q, k, v, do = (r(2, n, h, d, s=0.4, dtype=bf) for _ in range(4))
        out, lse = A.flash_attention(q, k, v, with_lse=True)
        outs += [out, lse, *A.flash_attention_bwd(q, k, v, out, lse, do),
                 A.flash_attention_int8pv(q, k, v)]
        if d == 96:
            outs += [A.flash_attention_int8(q, k, v),
                     *A.flash_attention_bwd_i8(q, k, v, out, lse, do)]
    return outs


def other_routing(lib) -> dict:
    """{kernel: instantiation widths} of K3 and K7 in a kernel library that
    lacks their d-80 tiles (their entry points `smb_flash_fwd_i8_d80`,
    `smb_flash_bwd_i8_d80`): there they ran heads of 66 to 80 on the d-128
    tiles, on codes of 128 bytes. Set in `ops/attention.py` while that
    library runs, this package's wrappers quantise as its kernels read."""
    return {kernel: (32, 64, 128) for kernel, fn in (
        ("K3", "smb_flash_fwd_i8_d80"), ("K7", "smb_flash_bwd_i8_d80"))
        if not hasattr(lib, fn)}


def other_library(other: Path, path: Path):
    """The other checkout's kernel library at path, bound by that
    checkout's own `_build.bind` (its C interface, without the functions
    this tree adds)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "other_build", other / "smb_vision_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.bind(path)


def build_library(root: Path) -> Path:
    """Build the kernel library of the checkout at root with its own
    package, in a process of its own; returns the library's path."""
    out = subprocess.run(
        [sys.executable, "-c", "from smb_vision_tpu_torch.ops import _build; "
         "print(_build.build())"], cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(root)},
        timeout=900, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def peak_memory_mib() -> dict:
    """Peak device memory (MiB) of one forward of leg A's model at batch
    4 and of one MIM step of the preset at batch 1 and 2, each after a
    warm-up, with the smb_vision_tpu_torch that is first on the path."""
    import torch

    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel
    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def peak(fn) -> float:
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2 ** 20

    px = torch.rand((4, 320, 1, 512, 512), generator=gen,
                    device=dev).to(torch.bfloat16)
    model = VideoMAEModel(VideoMAEConfig(
        image_size=512, num_frames=320, hidden_size=HIDDEN,
        num_hidden_layers=12, num_attention_heads=HEADS,
        intermediate_size=FFN, dtype="bfloat16")).init_weights(
            torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.inference_mode():
        out = {"leg A model batch 4 MiB": peak(lambda: model(px))}
    del model, px
    torch.cuda.empty_cache()
    cfg, preset = mim_config()
    for bs in (1, 2):
        _, init_fn, step_fn, _ = make_mim_workload(
            cfg, mask_patch_size=preset["mask_patch_size"],
            mask_ratio=preset["mask_ratio"], tx=functools.partial(
                make_optimizer, learning_rate=preset["learning_rate"],
                total_steps=100, warmup_ratio=preset["warmup_ratio"],
                weight_decay=preset["weight_decay"]), device=dev)
        state = init_fn(0)
        px = torch.rand((bs, cfg.num_frames, 1, cfg.image_size,
                         cfg.image_size), generator=gen, device=dev)
        out[f"MIM step batch {bs} MiB"] = peak(lambda: step_fn(
            state, {"pixel_values": px}, step_generator(0, 1)))
        del init_fn, step_fn, state, px
        torch.cuda.empty_cache()
    return out


def peak_memory_of(root: Path) -> dict:
    """peak_memory_mib() for the checkout at root, with its own package
    and kernel library, in a process of its own."""
    code = ("import importlib.util, json; spec = importlib.util."
            f"spec_from_file_location('smoke', {str(Path(__file__))!r}); "
            "smoke = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(smoke); "
            "print(json.dumps(smoke.peak_memory_mib()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": str(root)},
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_against(other: Path, card: str, rounds: int = 2) -> dict:
    """This checkout's kernels against another checkout's (the parent
    commit unpacked by `git archive`), in one process: this package's
    wrappers call either library. The kernels that must match the other's
    (UNCHANGED: the flash kernels at d 32, 64 and 128, the MLP forward and
    backward K2, K6, K5a, K9 and K5b, and the glue K10a and K10b) are
    compared by SASS and by output, bit for bit;
    then, in turns (other, this, this, other a round), the flash kernels
    at their table shapes (K1, K4, K3 and K7 at heads of 80 and 72, this
    tree's d-80 tiles against the other's d-128 ones, each on the codes
    its side's tiles read, `other_routing`; K3 at d 64 and 128, K7
    at the V-JEPA encoder's and the reference head's), the MLP family (K2 and K6 at the embed
    shape, K6 at the V-JEPA teacher's K 1,024, K5a at the MIM encoder's,
    K5b at the MIM encoder's and decoder's and the V-JEPA encoder's), K9
    at DINOv2-giant batch 2 and 1, the glue kernels K10a and K10b at the
    embed shape, the MIM encoder's and decoder's, R6 on q and k at d 64,
    128 and 32, the device time of K2's and K9's LayerNorm pass at K 768,
    1,024 and 1,536, of R6's passes at d 64, 128 and 32 and of K10a and
    K10b at the MIM encoder's shape (from the profiler), legs A's, B's
    and G's
    models (bf16, int8 and int8 p v + glue encoders, batch 4), the MIM
    step of the preset at batch 1 and 2, as shipped and with glue_impl
    "pallas", and the V-JEPA step of its preset at batch 1 and 2 are
    timed, and after them, in turns again, the int8 ViT-H encode (leg T's
    model, 32 layers, batch 2) and the ViT-H V-JEPA step (32 layers, batch
    1; also its device time from the profiler); beside any run that a Python garbage collection of more than
    10 ms interrupted, the log gives the collections' host time. K10a's
    wrapper passes its workspace after the arguments of the parent's
    `smb_qkv_ln_fwd`, which takes none and runs without it. Then
    the DINOv2-giant step parity
    (`dinov2_parity`) with either library at each of DINO_PARITY_SEEDS,
    recorded and not held to its bound. Last, each checkout's peak device
    memory (`peak_memory_mib`) with its own package, in a process of its
    own. Returns the mean of each time per side, the parity readings and
    the peaks."""
    import torch

    from smb_vision_tpu_torch.models.configs import VideoMAEConfig
    from smb_vision_tpu_torch.models.videomae import VideoMAEModel
    from smb_vision_tpu_torch.ops import _build
    from smb_vision_tpu_torch.ops import attention as A
    from smb_vision_tpu_torch.ops import attn_glue as G
    from smb_vision_tpu_torch.ops import mlp as M
    from smb_vision_tpu_torch.train.mim import make_mim_workload
    from smb_vision_tpu_torch.train.optim import make_optimizer
    from smb_vision_tpu_torch.train.trainer import step_generator

    paths = {"other": build_library(other), "this": _build.build()}
    libs = {"other": other_library(other, paths["other"]),
            "this": _build.lib()}
    sass = {side: sass_listing(path) for side, path in paths.items()}
    if all(sass.values()):
        compare_sass(sass)
    dev = torch.device("cuda")

    routing = {"other": other_routing(libs["other"]),
               "this": {k: A._FLASH_HEAD_DIMS[k] for k in ("K3", "K7")}}

    def use(side):
        """This package's wrappers on `side`'s library (the parent's has
        the quantisation kernel too, with the same C interface), K3 and K7
        routed as that library's kernels read their codes."""
        _build._lib = libs[side]
        A._FLASH_HEAD_DIMS.update(routing["this"])
        A._FLASH_HEAD_DIMS.update(routing[side])
        return contextlib.nullcontext()

    outs = {}
    for side in libs:
        with use(side):
            outs[side] = unchanged_outputs(dev)
    same = [torch.equal(a, b) for a, b in zip(outs["other"],
                                              outs["this"])]
    log(f"against: outputs of K1, K3, K8, K4, K7 (d 32 too), K2 (K 128 "
        f"to 1,024), K6 (K 768 and 1,024), K5a, K5b, K9 (K 768, 1,024 and "
        f"1,536), K10a and K10b, K1, K4, K8 at d 72 and 80 and K3, K7 at d "
        f"96 through their wrappers bit for bit equal: "
        f"{all(same)} ({sum(same)} of {len(same)} tensors); K3 and K7 "
        f"routed on the other side as {routing['other'] or 'on this side'}")
    del outs

    def inputs(seed, shape):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [(torch.randn(shape, generator=gen, device=dev) * 0.4).to(
            torch.bfloat16) for _ in range(4)]

    emb = inputs(0, (1, MAIN_N, HEADS, HEAD_DIM))
    enc = inputs(1, (1, ENC_N, HEADS, HEAD_DIM))
    dec = inputs(1, (1, MAIN_N, DEC_HEADS, HEAD_DIM))
    vj = inputs(2, (1, VJ_N, 8, 128))
    ref = inputs(3, (1, VJ_N, 16, 64))
    pred = inputs(6, (1, VJ_N, PRED_HEADS, 32))
    fwd_lse = {name: A.flash_attention(*x[:3], with_lse=True)
               for name, x in (("enc", enc), ("dec", dec), ("vj", vj),
                               ("ref", ref), ("pred", pred))}

    gen = torch.Generator(device=dev).manual_seed(4)

    def mlp(m, kd, f):
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s

        bf = torch.bfloat16
        return (r(m, kd).to(bf), 1.0 + r(kd, s=0.1), r(kd, s=0.1),
                r(f, kd, s=kd ** -0.5).to(bf).t(), r(f, s=0.1),
                r(kd, f, s=f ** -0.5).to(bf).t(), r(kd, s=0.1))

    mx, mlnw, mlnb, mw1, mb1, mw2, mb2 = mlp(MAIN_N, HIDDEN, FFN)
    vx, vlnw, vlnb, vw1, vb1, vw2, vb2 = mlp(VJ_N, VJ_HIDDEN, VJ_FFN)
    _, vh = M._mlp_train_plain(vx, vw1, vb1, vw2, vb2, "gelu")
    ex, _, _, ew1, eb1, ew2, eb2 = mlp(ENC_N, HIDDEN, FFN)
    _, eh = M._mlp_train_plain(ex, ew1, eb1, ew2, eb2, "gelu")
    cx, _, _, cw1, cb1, cw2, cb2 = mlp(MAIN_N, DEC_HIDDEN, DEC_FFN)
    _, ch = M._mlp_train_plain(cx, cw1, cb1, cw2, cb2, "gelu")
    gx, glnw, glnb, gw1, gb1, gw2, gb2 = mlp(2 * DINO_N, GIANT_K, 2 * GIANT_F)
    gw2 = gw2[:GIANT_F]

    def glue(m, kd):
        """x, y, LN params, (in, out) views of Linear-layout bf16 weights
        (as the Block passes them) and f32 biases of K10a and K10b."""
        def r(*shape, s=1.0):
            return torch.randn(shape, generator=gen, device=dev) * s

        bf = torch.bfloat16
        return (r(m, kd).to(bf), r(m, kd).to(bf), 1.0 + r(kd, s=0.1),
                r(kd, s=0.1), [r(kd, kd, s=kd ** -0.5).to(bf).t()
                               for _ in range(4)],
                [r(kd, s=0.1) for _ in range(4)])

    glues = {label: glue(m, kd) for m, kd, label in GLUE_SHAPES[:3]}

    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [torch.rand((4, 320, 1, 512, 512), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(4)]
    models = {leg: VideoMAEModel(VideoMAEConfig(
        image_size=512, num_frames=320, hidden_size=HIDDEN,
        num_hidden_layers=12, num_attention_heads=HEADS,
        intermediate_size=FFN, dtype="bfloat16", **impls)).init_weights(
            torch.Generator().manual_seed(0)).to(dev).eval()
        for leg, impls in (("A", {}), ("B", dict(attn_impl="pallas_int8",
                                                 mlp_impl="pallas_bwd")),
                           ("G", dict(attn_impl="pallas_int8pv",
                                      glue_impl="pallas")))}
    mim = {}
    for bs, glue_step in ((1, False), (2, False), (1, True), (2, True)):
        cfg, preset = mim_config(
            **({"glue_impl": "pallas"} if glue_step else {}))
        _, init_fn, step_fn, _ = make_mim_workload(
            cfg, mask_patch_size=preset["mask_patch_size"],
            mask_ratio=preset["mask_ratio"], tx=functools.partial(
                make_optimizer, learning_rate=preset["learning_rate"],
                total_steps=100, warmup_ratio=preset["warmup_ratio"],
                weight_decay=preset["weight_decay"]), device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        mim[f"MIM{' glue' if glue_step else ''} step batch {bs}"] = (
            init_fn(0), step_fn,
            [torch.rand((bs, cfg.num_frames, 1, cfg.image_size,
                         cfg.image_size), generator=gen, device=dev)
             for _ in range(4)])
    vcfg, vpreset = vjepa_config()
    _, vinit, vstep, _ = vjepa_workload(vcfg, vpreset, dev,
                                        vpreset["teacher_attn_impl"])
    gen = torch.Generator(device=dev).manual_seed(5)
    vstate = vinit(0)   # one model: its init runs once; both batches train it
    vjepa = {bs: (vstate, vstep, [
        torch.rand((bs, vcfg.frames_per_clip, 1, vcfg.crop_size,
                    vcfg.crop_size), generator=gen, device=dev)
        for _ in range(4)]) for bs in (1, 2)}
    # the reference-head preset under the impls its _comment recommends
    # (K7 with the quantisation in the student, K3 in the teacher)
    rcfg, rpreset = vjepa_ref_config(attn_impl=LEG_I_IMPLS["attn_impl"])
    _, rinit, rstep, _ = vjepa_workload(rcfg, rpreset, dev,
                                        LEG_I_IMPLS["teacher_attn_impl"])
    vjepa_ref = (rinit(0), rstep, [
        torch.rand((REF_AGAINST_BATCH, rcfg.frames_per_clip, 1,
                    rcfg.crop_size, rcfg.crop_size), generator=gen,
                   device=dev) for _ in range(4)])

    def encode(leg):
        with torch.inference_mode():
            for px in batches[1:]:
                models[leg](px)

    def steps(state, step_fn, pxs):
        for i in range(1, 4):
            step_fn(state, {"pixel_values": pxs[i]}, step_generator(0, i))

    (q, k, v, _), (eq, ek, ev, edo), (dq_, dk_, dv_, ddo) = emb, enc, dec
    # K1 and K4 at heads of 80 and 72: this tree's d-80 tiles against the
    # other's d-128 ones (the C interface is the same; the dispatch by
    # width is the library's)
    vith = inputs(7, (1, MAIN_N, VIT_H_HEADS, VIT_H_D))
    vith_enc = inputs(8, (1, ENC_N, VIT_H_HEADS, VIT_H_D))
    so400m = inputs(9, (SIGLIP_BATCH, SO400M_N, 16, 72))
    vjh = inputs(10, (1, VJ_N, VIT_H_HEADS, VIT_H_D))
    fwd_lse.update({name: A.flash_attention(*x[:3], with_lse=True)
                    for name, x in (("vith_enc", vith_enc),
                                    ("so400m", so400m), ("vjh", vjh))})
    probes = {
        "K1 ViT-H d 80": lambda: A.flash_attention(*vith[:3]),
        "K1 so400m d 72": lambda: A.flash_attention(*so400m[:3]),
        "K4 ViT-H MIM encoder d 80": lambda: A.flash_attention_bwd(
            *vith_enc[:3], *fwd_lse["vith_enc"], vith_enc[3]),
        "K4 so400m d 72": lambda: A.flash_attention_bwd(
            *so400m[:3], *fwd_lse["so400m"], so400m[3]),
        "K3 ViT-H d 80": lambda: A.flash_attention_int8(*vith[:3]),
        "K3 so400m d 72": lambda: A.flash_attention_int8(*so400m[:3]),
        "K7 V-JEPA ViT-H d 80": lambda: A.flash_attention_bwd_i8(
            *vjh[:3], *fwd_lse["vjh"], vjh[3]),
        "K7 so400m d 72": lambda: A.flash_attention_bwd_i8(
            *so400m[:3], *fwd_lse["so400m"], so400m[3]),
        "K1 embed": lambda: A.flash_attention(q, k, v),
        "K1 V-JEPA d 128": lambda: A.flash_attention(*vj[:3]),
        "K1 predictor d 32": lambda: A.flash_attention(*pred[:3]),
        "K3 predictor d 32": lambda: A.flash_attention_int8(*pred[:3]),
        "K8 predictor d 32": lambda: A.flash_attention_int8pv(*pred[:3]),
        "K8 V-JEPA d 128": lambda: A.flash_attention_int8pv(*vj[:3]),
        "quantisation q, k embed": lambda: A.quantize_qk(q, k, 0.125),
        "quantisation q, k V-JEPA d 128": lambda: A.quantize_qk(
            *vj[:2], 128 ** -0.5),
        "quantisation q, k predictor d 32": lambda: A.quantize_qk(
            *pred[:2], 32 ** -0.5),
        "K3 embed d 64": lambda: A.flash_attention_int8(q, k, v),
        "K3 V-JEPA d 128": lambda: A.flash_attention_int8(*vj[:3]),
        "K8 embed": lambda: A.flash_attention_int8pv(q, k, v),
        "K4 MIM encoder": lambda: A.flash_attention_bwd(
            eq, ek, ev, *fwd_lse["enc"], edo),
        "K4 MIM decoder": lambda: A.flash_attention_bwd(
            dq_, dk_, dv_, *fwd_lse["dec"], ddo),
        "K7 V-JEPA encoder d 128": lambda: A.flash_attention_bwd_i8(
            *vj[:3], *fwd_lse["vj"], vj[3]),
        "K7 reference head d 64": lambda: A.flash_attention_bwd_i8(
            *ref[:3], *fwd_lse["ref"], ref[3]),
        "K7 predictor d 32": lambda: A.flash_attention_bwd_i8(
            *pred[:3], *fwd_lse["pred"], pred[3]),
        "K2 embed": lambda: M.mlp_block_fused(mx, mlnw, mlnb, mw1, mb1, mw2,
                                              mb2, eps=1e-12),
        "K6 embed": lambda: M.mlp_fused(mx, mw1, mb1, mw2, mb2),
        "K6 V-JEPA teacher K 1024": lambda: M.mlp_fused(vx, vw1, vb1, vw2,
                                                         vb2),
        "K2 V-JEPA K 1024": lambda: M.mlp_block_fused(
            vx, vlnw, vlnb, vw1, vb1, vw2, vb2, eps=1e-12),
        "K5a MIM encoder": lambda: M.mlp_train_fused(ex, ew1, eb1, ew2, eb2),
        "K5b MIM encoder": lambda: M.mlp_bwd_fused(eh, ex, ew1, ew2),
        "K5b MIM decoder": lambda: M.mlp_bwd_fused(ch, cx, cw1, cw2),
        "K5b V-JEPA encoder": lambda: M.mlp_bwd_fused(vh, vx, vw1, vw2),
        "K9 DINOv2-giant batch 2": lambda: M.swiglu_block_fused(
            gx, glnw, glnb, gw1, gb1, gw2, gb2, eps=1e-6),
        "K9 DINOv2-giant batch 1": lambda: M.swiglu_block_fused(
            gx[:DINO_N], glnw, glnb, gw1, gb1, gw2, gb2, eps=1e-6),
    }
    for label, (x, y, lnw, lnb, ws, bs) in glues.items():
        probes[f"K10a {label}"] = functools.partial(
            G.qkv_ln_fused, x, lnw, lnb, *ws[:3], *bs[:3], eps=1e-6)
        probes[f"K10b {label}"] = functools.partial(
            G.out_res_fused, x, y, ws[3], bs[3])
    # device time from the profiler: the LayerNorm pass of K2 and K9 at the
    # K the parent compiled it for, R6's passes on q and k, and the whole
    # of K10a and K10b at the MIM encoder's shape; R6's, K10a's and K10b's
    # CUDA-event times above are set by the host's issue rate as much as
    # by the device
    passes = {(name, "ln_rows", "LN pass"): probes[name] for name in (
        "K2 embed", "K2 V-JEPA K 1024", "K9 DINOv2-giant batch 1")}
    passes.update({(name, "quant_", "R6 passes"): probes[name]
                   for name in ("quantisation q, k embed",
                                "quantisation q, k V-JEPA d 128",
                                "quantisation q, k predictor d 32")})
    passes.update({(name, "", "device"): probes[name] for name in (
        "K10a MIM encoder", "K10b MIM encoder")})

    def pass_ms(fn, part, calls=20):
        """A call's device time in the kernels whose names hold part, from
        the profiler: each one's mean time a launch times its launches a
        call, rounded (a session now and then loses its first launch,
        which moves no mean)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
            if us > 0 and part in ev.key:
                total += round(ev.count / calls) * us / ev.count / 1e3
        return total

    times = {side: {} for side in libs}
    gc_ms = {side: {} for side in libs}
    pauses = []

    def gc_pause(phase, info):
        """The host time of each Python garbage collection (its start and
        end times, the start negated)."""
        pauses.append(time.perf_counter() * (-1 if phase == "start" else 1))

    def record(side, key, measure):
        pauses.clear()
        times[side].setdefault(key, []).append(measure())
        gc_ms[side].setdefault(key, []).append(sum(pauses) * 1e3)

    gc.callbacks.append(gc_pause)
    for r in range(rounds):
        for side in ("other", "this", "this", "other"):
            with use(side):
                for name, fn in probes.items():
                    record(side, name + " ms", lambda: cuda_ms(fn, iters=10))
                for (name, part, what), fn in passes.items():
                    record(side, f"{name} {what} ms (profiler)",
                           lambda: pass_ms(fn, part))
                for leg in models:
                    record(side, f"leg {leg} vol/s", lambda: 4 * 3 * 1e3
                           / cuda_ms(lambda: encode(leg), iters=1, warmup=1))
                for name, work in mim.items():
                    record(side, f"{name} ms", lambda: cuda_ms(
                        lambda: steps(*work), iters=1, warmup=1) / 3)
                for bs in (1, 2):
                    record(side, f"V-JEPA step batch {bs} ms",
                           lambda: cuda_ms(lambda: steps(*vjepa[bs]),
                                           iters=1, warmup=1) / 3)
                record(side, f"V-JEPA reference heads batch "
                       f"{REF_AGAINST_BATCH} ms", lambda: cuda_ms(
                           lambda: steps(*vjepa_ref), iters=1,
                           warmup=1) / 3)
    del models, mim, vjepa, vstate, vjepa_ref
    gc.collect()
    torch.cuda.empty_cache()
    # the paths that run K3 and K7 at d 80 at full depth: the int8 ViT-H
    # encode (leg T's model) and the ViT-H V-JEPA step (K7 in the student,
    # K3 in the teacher)
    layers = VIT_H["num_hidden_layers"]
    vit_h = seeded_vit_h(dev, layers)
    set_impls(vit_h, "pallas_int8", "pallas_bwd")
    gen = torch.Generator(device=dev).manual_seed(12)
    hx = [torch.rand((2, 320, 1, 512, 512), generator=gen, device=dev)
          .to(torch.bfloat16) for _ in range(4)]
    hcfg, hpreset = vjepa_config(**VIT_H_VJEPA, num_hidden_layers=layers)
    _, hinit, hstep, _ = vjepa_workload(hcfg, hpreset, dev,
                                        hpreset["teacher_attn_impl"])
    vjepa_h = (hinit(0), hstep, [
        torch.rand((1, hcfg.frames_per_clip, 1, hcfg.crop_size,
                    hcfg.crop_size), generator=gen, device=dev)
        for _ in range(4)])

    def encode_h():
        with torch.inference_mode():
            for px in hx[1:]:
                vit_h(px)

    for r in range(rounds):
        for side in ("other", "this", "this", "other"):
            with use(side):
                record(side, "int8 ViT-H encode batch 2 ms", lambda: cuda_ms(
                    encode_h, iters=1, warmup=1) / 3)
                record(side, "ViT-H V-JEPA step batch 1 ms", lambda: cuda_ms(
                    lambda: steps(*vjepa_h), iters=1, warmup=1) / 3)
                # its device time apart from the host's, which spreads
                # the step's wall at batch 1
                record(side, "ViT-H V-JEPA step batch 1 device ms "
                       "(profiler)", lambda: pass_ms(
                           lambda: steps(*vjepa_h), "", calls=1) / 3)
    gc.callbacks.remove(gc_pause)
    _build._lib = libs["this"]
    A._FLASH_HEAD_DIMS.update(routing["this"])
    means = {side: {k: sum(v) / len(v) for k, v in got.items()}
             for side, got in times.items()}
    for key in means["this"]:
        slow = {side: [round(x) for x in gc_ms[side][key]] for side in libs
                if max(gc_ms[side][key]) > 10}
        log(f"against {key:<26} other {means['other'][key]:9.3f}  this "
            f"{means['this'][key]:9.3f}  (runs: other "
            f"{[round(x, 3) for x in times['other'][key]]}, this "
            f"{[round(x, 3) for x in times['this'][key]]}"
            + (f"; garbage-collection ms in them: {slow}" if slow else "")
            + f") on {card}")
    del vit_h, hx, vjepa_h, hinit, hstep
    gc.collect()
    torch.cuda.empty_cache()
    for seed in DINO_PARITY_SEEDS:
        got = dinov2_parity(seed, libs)
        for side in libs:
            for key in ("rel loss", "grad err"):
                means[side][f"DINOv2 seed {seed} {key}"] = got[side][key]
            means[side][f"DINOv2 seed {seed} plain grad err"] = got[
                "plain grad err"]
    peaks = {"other": peak_memory_of(other), "this": peak_memory_of(ROOT)}
    for key, mib in peaks["this"].items():
        log(f"against peak {key:<24} other {peaks['other'][key]:9.0f}  this "
            f"{mib:9.0f} on {card}")
        means["other"]["peak " + key] = peaks["other"][key]
        means["this"]["peak " + key] = mib
    return means


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    try:
        import smb_vision_tpu_torch  # noqa: F401
    except ImportError as err:
        raise SystemExit(f"chip_smoke: no smb_vision_tpu_torch beside the "
                         f"script ({err}); run it from a checkout of the "
                         f"repository") from None

    if sys.argv[1:2] == ["--two-ranks-worker"]:
        # one rank of phase_two_ranks (the kernels are built)
        rank, world, init, out, part = sys.argv[2:7]
        two_rank_worker(int(rank), int(world), init, Path(out), int(part))
        return 0
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        """Log the run's wall time at the end of a phase."""
        log(f"elapsed: {phase} done at {time.perf_counter() - t0:.1f} s")

    card = phase_device()
    phase_build()
    if sys.argv[1:2] == ["--against"]:
        # python3 chip_smoke.py --against OTHER_CHECKOUT: phase_against only
        print(json.dumps({"against": str(sys.argv[2]), "means": phase_against(
            Path(sys.argv[2]).resolve(), card)}))
        return 0
    table = phase_kernels()
    phase_card_tests()
    done("kernels and card tests")
    work = ROOT / "chip_smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        vols = write_volumes(work)
        emb_a, _ = run_leg(work, vols, "A", vit_base_config(
            work, "leg_a", "auto"), [], ("flash_fwd", "mlp_block_fwd"), table)
        emb_b, counts = run_leg(work, vols, "B", vit_base_config(
            work, "leg_b", "pallas_bwd"), ["--attn_impl", "pallas_int8"],
            ("flash_fwd_i8", "mlp_fwd", "quantize"), table)
        if counts["quantize"] != 2 * counts["flash_fwd_i8"]:
            raise AssertionError(f"leg B: launches {counts}; the "
                                 "quantisation kernel must launch for q "
                                 "and k of every K3 call")
        run_leg_g(work, vols, emb_a, emb_b, table)
        run_leg_q(work, vols, emb_a, table)
        phase_whole_model(vols, emb_a)
        phase_d32_int8_path(table)
        done("legs A, B, G, Q, the whole model and the d-32 int8 path")
        run_vit_h_legs(work, vols, table)
        phase_vit_h(vols, card)
        done("legs N, T and U, the ViT-H parity and rate")
        run_vit_h_train_legs(work, vols, table)
        done("legs X and Y")
        run_leg_s(work, vols, work / "leg_a.json", emb_a)
        run_leg_w(work, vols, work / "leg_a.json", emb_a)
        done("legs S and W")
        phase_native_loader(vols)
        done("native loader")
        leg_c = run_leg_c(work, vols, table)
        run_leg_c(work, vols, table, leg="H", overrides="glue_impl=pallas")
        done("legs C and H")
        # leg P's launches wait mostly on the host: they run beside the
        # 2-rank phase, whose step times are no speed either
        leg_p = in_background(run_leg_p, work, leg_c)
        try:
            phase_two_ranks(work, card)
        finally:
            leg_p()
        done("leg P and 2 ranks on one card")
        run_leg_j(work, vols, table)
        done("leg J")
        run_leg_d(work, vols, table)
        done("leg D")
        run_leg_k(work, vols, table)
        done("leg K")
        run_leg_i(work, vols, table)
        done("legs D, K and I")
        spec = write_labelled_spec(work, vols)
        run_leg_e(work, spec)
        run_leg_f(work, spec, table)
        done("legs E and F")
        run_leg_l(work, vols, spec)
        done("leg L")
        run_leg_o(work, vols)
        done("leg O")
        run_leg_z(work, vols, card, table)
        done("leg Z")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_throughput(card)
    phase_train_parity()
    phase_train_parity(glue=True)
    phase_train_throughput(card)
    done("encode throughput, MIM parity and throughput")
    phase_vjepa_parity()
    phase_vjepa_throughput(card)
    phase_vjepa_parity(ref=True)
    done("V-JEPA parity and throughput, reference-head parity")
    phase_train_parity(vit_h=True)
    phase_vjepa_parity(vit_h=True)
    phase_vit_h_train_steps(card)
    done("ViT-H MIM and V-JEPA parities and steps")
    phase_vjepa_ref_throughput(card, table)
    done("reference-head throughput")
    phase_dinov2_parity()
    full = phase_finetune_throughput(card)
    done("DINOv2 parity and fine-tune throughput")
    phase_lora_parity()
    phase_lora_throughput(card, full)
    done("LoRA parity and throughput")
    log(card)
    print(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

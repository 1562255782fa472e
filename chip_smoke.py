#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: W8A8 and mixed-precision
SDXL-Turbo (512 px), W8A8 SDXL (1024 px) and SD1.5 (512 px) UNet steps
through the hand-written kernels, eager and captured in CUDA graphs, the
kernel benchmark, the serving path (prompts to images) at full
SDXL-Turbo and SD1.5 width, one CUDA graph a batch, and the port's CLIs
on the PTQ flow's files.

    python3 chip_smoke.py

Phases (none catches its own failure; any failure exits non-zero):

0. Build every CUDA kernel from ``mixdq_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once); the compiler's register / shared memory /
   spill report goes to ``chiprun_out/nvcc_build.txt``.
1. Each kernel against its plain PyTorch version at the main-path shapes,
   at B=1 and B=2 for the 1024 px kernels (the 512 and 1024 px shapes of
   ``geglu_qmatmul`` and ``gn_silu_quantize``; ``geglu_qmatmul``'s and
   ``geglu_out_qmatmul``'s labels carry their plans; ``qmatmul`` and
   ``qconv2d`` /
   ``qconv2d_s2``, whose labels carry their split-K plans: equal bit for
   bit, the int32 sums being exact in any split; int8 codes: max |diff| <= 1
   on < 1% of codes; floats rtol 1e-3 / atol 1e-2; flash attention, at
   the kernel's key blocks: max |diff| <= 2 bf16 ulps of the plain
   output's max |x| and |diff| / |plain| <= 1e-2; the fused act-quantize
   GEMMs ``qmatmul_fused`` / ``qmatmul_fused2``, on the same mainloop as
   ``qmatmul``: equal bit for bit too, at K % 128 != 0, M = 1, a bf16
   column slice of x, f32 output and K = 16384 as well),
   with the kernel's and the plain version's time, the card's bound for
   the same work and, where one PyTorch call computes the same function,
   its time (``torch._int_mm`` for ``qmatmul``, on w as stored and on a
   K-major copy, and the same on codes quantized beforehand for the
   fused GEMMs, the product alone, beside the act-quantize then
   ``qmatmul``; ``scaled_dot_product_attention`` for flash attention;
   ``torch.matmul`` on the weight dequantized beforehand for
   ``wq4_matmul`` / ``wq_matmul``, whose check is flash attention's).
   Then SD1.5's shapes (``sd15_kernel_cases``): the three flash kernels
   at heads of 40 / 80 / 160 (``SD15_ATTN``: T = 4096 / 1024 / 256 and a
   Tk = 77 cross site) with SDPA beside, and its new int8 GEMM, conv and
   LayerNorm shapes, each by its kernel's rule.
   Then each fused GEMM at M=1024 K=5120 N=1280 under torch.profiler:
   one device kernel per call; and one launch of an empty kernel, timed
   as the kernels are (the launch floor that ``ln_quantize`` nears).
   The cooperative ``sec_attention*`` kernels also print their stage
   split (LN, projection GEMM, attention, to_out GEMM:
   ``sec_attention.probe``'s stamps after each grid sync, means of
   ``SPLIT_ITERS`` flushed calls). ``qmatmul`` over a layer axis
   (``BANK_QMATMULS``, the banks' shapes) equals its plain version bit
   for bit.
   ``capture_report``: how the special launches capture into a CUDA
   graph (``gn_silu_quantize``'s edge types, programmatic or stream
   order, and its time in a graph; the cooperative kernels' node flags).
2. ``tiny-sdxl``, ``small-sd15`` (SD1.5's layout, flash at d = 40 under
   ``'auto'``) and ``small-sdxl`` (a small UNet whose attention sites
   take the whole-attention kernels), W8A8 steps in float32
   under ``attn_impl='einsum'`` and ``'auto'``: kernels on the GPU
   against the plain versions on the CPU
   (whole step: |d|/|ref| <= 1e-2, max |d| < 0.3, or for ``small-sd15``
   each resnet and spatial transformer at that tolerance on its GPU-step
   input (``held_modules``); under ``'auto'`` each attention module on
   its GPU-step input: rtol 1e-3 / atol 1e-2).
3. The main paths: SDXL-Turbo UNet at full width (random weights from a
   seed), calibrated on one request, deployed W8A8 once (int8_sec, fused
   QKV/KV, BoS-aware), answering a few requests at bf16 under
   ``attn_impl='auto'`` (the headline: whole-attention kernels) and
   ``'einsum'`` (the same deploy, the context's ``attn_impl`` swapped).
   Asserts each path's kernel launch counts (and logs one auto step's
   ``qmatmul`` / ``qconv2d`` calls by shape), finite outputs, and the
   SQNR of int8 against the bf16 FP UNet (>= 16 dB); prints the SQNR of
   auto against einsum and paired median step times. One-layer faults
   injected into the deploy show what the SQNR gate sees. Then the
   graphed cells (``graphed_step_ms``, here and in phases 6 and 7): bf16
   and each quantized path captured as a CUDA graph of one step, whose
   launches counted at capture must be the path's ``ctx_kernel_calls``
   and whose replay must equal the eager step bit for bit; paired median
   replay times, and a profiled window of replays (busy ms, idle share;
   the eager step's profile is phase 5's).
4. Every deploy entry at full width, teacher-forced on the input its
   layer sees in an FP step, against fake quantization computed from the
   quantizers' definition (>= 30 dB each), and every attention module,
   teacher-forced on its FP-step input, under ``'auto'`` against
   ``'einsum'`` on the same deploy (>= ``SITE_SQNR_DB``); the injected
   faults must fail these checks.
5. A per-kernel device-time breakdown of one step of each int8 path and
   of bf16 from torch.profiler (written to ``chiprun_out/``); every
   profiled step logs the device ms of the five ``sec_attention*``
   kernels, ``geglu_qmatmul``, the GroupNorm producer's three and the
   bf16 and int8 flash kernels (``PROFILE_KERNELS``).
6. The mixed-precision deploys of the same UNet from the repo's elected
   maps (``configs/mp/sdxl_turbo``: W5.04, A7.43, act-protect list), on
   the phase 3 requests: ``int8_sec`` under ``'auto'`` and the weight-only
   ``'dequant'`` and ``'pallas_dequant'`` (``wq4_matmul`` for every packed
   entry, ``wq_matmul`` for the int8 ones). Launch counts (``MP_CALLS``),
   the wq kernels' calls in one ``pallas_dequant`` step by (M, K, N),
   SQNR against bf16 (>= ``MP_SQNR_DB``), ``pallas_dequant`` against
   ``dequant`` (>= ``WONLY_SQNR_DB``), every deploy entry against fake
   quantization at its bits and every attention site auto against
   einsum, each failed by a planted fault (swapped nibble halves, an A4
   entry clipped at A8, zero points at the ``sec_attention`` sites the
   protect list makes); paired step medians with bf16 and W8A8 auto,
   resident weight bytes, peak memory over a step, and one profiled step
   per path (``chiprun_out/profile_mp_*.txt``).
7. SDXL at 1024 px (128x128 latent), full width and depth, built in
   place of SDXL-Turbo: the same deploy under ``'auto'`` (flash
   attention, ``sec_attention`` and ``sec_attention_q``) and
   ``'einsum'``, and the bf16 UNet under ``'auto'`` (flash attention);
   launch counts (one auto step's int8 GEMM calls by shape), SQNR
   against bf16 (>= 16 dB), bf16 auto against bf16
   einsum (>= ``FLASH_SQNR_DB``) and each bf16 flash site against the
   einsum chain (>= ``FLASH_SITE_SQNR_DB``), both failed by flash attention
   that drops the last 64 keys, every attention module auto against
   einsum with injected zero-point faults at ``sec_attention`` and
   ``sec_attention_q`` sites, paired step medians and one profiled step
   per path.
8. The kernel benchmark's path (``python -m
   mixdq_tpu_torch.scripts.kernel_bench``): its seven rows at its four
   SDXL shapes, ``KB_ITERS`` timed calls each, launch counts, and each
   int8 row's output against the PyTorch int8 row's (the phase 1 rule of
   the fused GEMMs); the only path of ``qmatmul_fused`` and
   ``qmatmul_fused2``.
9. The serving path at full SDXL-Turbo width
   (``phase_serving``): ``ServingEngine`` at B = 1 and 4, one Euler step,
   g = 0, for bf16, the W8A8 UNet with the bf16 VAE and with the int8 VAE
   decoder, each captured once as one CUDA graph a batch: launches at
   capture, graphed images against the eager run (bit for bit), finite
   and in [0, 1], SQNR gates (what the W8A8 UNet adds to the latents,
   the int8 VAE's images) failed by planted faults, ms per batch and
   images/s.
10. The PTQ flow through files at full SDXL-Turbo width
   (``phase_ptq_flow``), ``configs/sdxl_turbo.yaml`` as shipped but for
   its calibration data path (a temporary directory): the three CLIs'
   ``main()`` in turn (``gen_calib_data``, ``ptq`` with the channel
   splits, ``quant_txt2img --backend int8 --fuse_qkv``; its context then
   under ``attn_impl='auto'``, as phase 3's),
   then the checkpoint read back equal bit for bit (794 layers, the 9
   split layers with their twins), the deploy's 9 ``conv_split`` entries
   and its launches in one eager step and at graph capture (both
   ``ctx_kernel_calls``: phase 3's plus 9 ``qmatmul``), each split entry against fake quantization (>=
   ``LAYER_SQNR_DB``, failed by its twins' qparams swapped), what the
   UNet adds in the Euler step against bf16 (>= ``MIN_SQNR_DB``), and the
   bf16 pipeline's params written and read back (images equal bit for
   bit); seconds and GB/s of each step. Its files stay for phase 11.
11. Fake-quant mode and the rest of ``QuantCtx`` (``phase_fake``):
   ``quant_txt2img --backend fake`` on phase 10's files (SDXL-Turbo 512
   px, bf16, W8A8, BoS-aware): no kernel launched, the step against bf16
   (>= ``MIN_SQNR_DB``, failed by ``STEP_FAULT_LAYER``'s weight delta a
   64th of itself) and against the ``int8_sec`` deploy of the same
   qparams (logged), every attention / ff / resnet module of a float32
   copy fake against the W8A8 ``deploy_compute='int8'`` deploy (>=
   ``LAYER_SQNR_DB``, failed by ``FAKE_FAULT_LAYER``'s act delta doubled;
   in bf16, against it and int8_sec, logged); the q/k/v/softmax act
   quantizers (``QKV_QUANT_ENTRIES`` entries, none without the softmax
   spec; the step logged against W8A8 fake); the mixed fake step
   (``configs/mp/sdxl_turbo``: logged against bf16 and the int8_sec mixed
   deploy; each W >= 4 entry without its residual fake against the
   deploy, failed by ``MIXED_FAULT_LAYER``'s weight delta halved); ``attn_impl`` =
   ``EXPLICIT_IMPLS`` on the int8_sec deploy (launches, every site's
   kernel against its plain version by phase 1's rule, the kernel
   dropping ``FLASH_DROPPED_KEYS`` keys caught at a Tk = 77 and a Tq =
   256 site); ``deploy_compute='int8'`` (launches, step against bf16
   failed by ``STEP_FAULT_LAYER``'s scale negated, each entry without its
   residual against fake quantization with phase 4's fault); eager and graphed step ms of every path beside bf16 and
   int8_sec (the captures' launches = ``ctx_kernel_calls``, replays equal
   eager); then SDXL 1024 W8A8 fake under ``'auto'``
   (``FAKE_SDXL_CALLS``: 10 ``flash_attention``; step against bf16 with
   the same fault; each flash site against ``flash_attention_plain`` >=
   ``FLASH_SITE_SQNR_DB``, failed by dropped keys; eager and graphed ms
   beside bf16 and int8_sec).
12. This slice's paths on phase 10's files (``phase_search``): the int8
   CLI (``quant_txt2img --backend int8 --fuse_qkv``) precomputes the BoS
   rows: ``BOS_ENTRIES`` entries, each ``bos_out`` against ``emb0 @
   W_fp`` in f32 (rel ``BOS_REL``, failed by the dequantized weight), the
   step against bf16 (``MIN_SQNR_DB``, failed by conv_out's scale
   negated) and the fallback deploy (logged), resident bytes with and
   without ``bos_w``; the W8A8 auto step with each bank on and off
   (launches = ``ctx_kernel_calls``, outputs equal bit for bit, failed by
   a time_emb_proj scale halved) and with ``dequant_small_m=SMALL_M``
   (launches, against bf16), all graphed and paired; the search CLI
   ``--quick`` at ``SEARCH_TARGET`` (finite sweeps, candidates, the map
   written reloads equal, failed by one changed layer; ms a point); the
   ILP at full width on the repo's logs (the k = 1.0 candidate at 5.02
   solves ``final_config/weight/5.04.yaml``'s problem, ``ILP_REL_GAP``,
   its layer agreement logged; the act log's agreement logged); the
   elected map deployed ``int8_sec`` (against bf16 >=
   ``ELECTED_SQNR_DB``, failed by conv_out's scale negated; graphed,
   launches); ``quant_error --target weight`` (SQNR rising with the bits,
   failed by a delta 32 times too large) and ``--target arch``.
13. The evaluation half of the search and the root CLIs on phase 10's
   files (``phase_eval_clis``), each through its ``main(argv)``:
   ``evaluate --matrix w8_int8,w8_sec,w4_sec,mp_sec`` (4 prompts at
   batch 2; a random ViT-L/14 CLIP vision tower and Inception3 written
   as HF / torchvision state dicts and read by ``utils/torch_convert.py``;
   every report key in the JAX order and finite, each entry's launches
   its ``ctx_kernel_calls`` x 2, |FID(FP, FP)| within ``FID_SELF_REL`` of
   its scale, a planted fault's FID, ``conv_out``'s scale negated, above
   the sound entry's); ``serve_bench --steps 10 --batch_size 4`` (the
   JAX keys; both engines' launches at capture); ``memory_compare`` at B
   = 1 under ``int8_sec`` (static saving >= ``MEM_STATIC_SAVING``, failed
   by a deploy whose fp weights are not pruned) and ``dequant --pack_w4
   --w_bits 4``; ``batch_sweep --batches 1,2,4,8`` (graph launches, times
   logged); ``txt2img`` (PNGs read back equal to its images) and ``serve
   --backend int8`` (PNGs, launches at capture, ms a batch). Each gate
   has a planted fault that must fail it.
14. SD1.5 at 512 px, full width and depth (``phase_sd15``): W8A8 (launches
   ``SD15_CALLS``: 5 flash at d = 40), bf16 ``'auto'``, the mixed map of
   ``configs/mp/sd15`` and ``int8_flash`` "qk" / "qkv"; SQNR against bf16
   failed by conv_out's scale negated; flash sites against einsum failed
   by dropped keys; every W8A8 attention module against einsum with a
   zero-point fault at a flash site's to_out; int8 flash sites against
   bf16 flash failed by a doubled q scale; explicit ``attn_impl`` flash /
   int8_flash / int8qkv_flash at all 32 sites (d = 40 / 80 / 160)
   against the plain versions, failed by dropped keys; graphed bf16 /
   W8A8 / mixed steps equal eager, paired medians, profiled. Then the
   LCM 4-step serving loop (``sd15_serving``: CLIP-L, the SD1.5 VAE, one
   CUDA graph a batch at B = 1 and 4, bf16 and W8A8) and the PTQ flow
   on ``configs/sd15_lcm.yaml`` (``sd15_files``).
15. Reconstruction, QAT and the converters (``phase_recon``), each CLI
   through its ``main(argv)``: ``ptq --recon layer`` at SDXL-Turbo width
   on its own calibration data (``configs/sdxl_turbo.yaml`` cut to
   ``RECON_SAMPLES`` sample, unit normal from a seed: memory), its loss
   falling, seconds an iteration and peak memory logged, its qparams
   deployed W8A8 under ``'auto'`` (launches ``ctx_kernel_calls``, a
   graph replay equal to the eager step, SQNR against bf16 failed by
   conv_out's scale negated); ``reconstruct`` at W4 on one batch, whose
   fake step's SQNR against bf16 rises, and falls with the gradient's
   sign flipped (lr < 0); ``ptq --recon model --adaround`` and ``ptq
   --recon layer --adaround`` at SD1.5 width (``configs/sd15_lcm.yaml``
   cut likewise: SDXL-Turbo's alphas, their gradient, Adam's moments and
   the soft rounding's saved tensors exceed 80 GB), each
   ``alphas.msgpack`` read back bit for bit and each deploy's codes equal
   to the hard AdaRound fake-quant codes layer by layer; the model
   mode's W8A8 step logged against bf16 (5 steps take it from 23.7 to
   13.5 dB: PERF.md section 6, reconstruction), the layer mode's held
   as above;
   ``QAT_STEPS`` QAT steps of an f32 SD1.5 UNet on one batch
   (the loss finite and falling); the seed-0 SDXL-Turbo UNet written as a
   diffusers ``.safetensors`` file (bf16), ``convert_checkpoints --mode
   unet``, ``load_module_params`` into a UNet of another seed: every
   weight and the bf16 step equal bit for bit.
16. The last modules (``phase_mesh_comfy``, after phase 13, on phase
   10's files), SDXL-Turbo 512 px, B = 1, W8A8 ``int8_sec``: (a)
   ``ServingEngine(mesh=make_mesh(1))`` (an NCCL world of one on a
   ``HashStore``), graphed, against the unsharded engine: the same images
   and the same launches at capture, bit for bit, with the counts set to
   0 just before the mesh engine and read just after; (b) the ComfyUI
   nodes, Load(``sdxl-turbo``) -> Quantize(``int8``) -> Generate, equal
   to the pipeline's generation under ``deploy_unet_ctx`` at the same
   seed bit for bit (its launches one step's ``ctx_kernel_calls``), then
   OriginGen and Integral (both images, their MSE); (c) the deploy written
   to the ``runtime.tensorstore`` container and read back through a
   memory map: every field bit for bit, a graphed step on it equal to the
   in-memory one's, the write and read times logged; (d)
   ``sweep_sqnr_batched(mesh=make_mesh(1))`` equal to the sequential
   sweep value for value.

Stdout ends with the ``tpu_kernels`` table, the ``kernels`` line, the
card's name and power limit, and the ``ok`` line; every line but the
last also goes to ``chiprun_out/chip_smoke.log``.
"""

import collections
import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12    # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12     # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
N_REQUESTS = 4
TIMING_ROUNDS = 2
# replays of a CUDA graph timed back to back in each round of the graphed
# paired medians (phases 3, 6, 7, 9)
GRAPH_ITERS = 5
# calls of gn_silu_quantize in one graph (phase 1, capture_report)
CAPTURE_CALLS = 50
# phase 9, the serving path: batch sizes, the seed of the timed requests,
# timing rounds, the VAE layer of its planted fault, and the VAE's SQNR
# gate. The UNet gate reads what the UNet adds in the one Euler step (the
# latents minus the scaled noise both variants share; the whole image is
# mostly that noise), the quantity phase 3 gates, at phase 3's limit
# (MIN_SQNR_DB); its planted fault is the UNet calibrated on phase 3's
# example inputs, whose unit-normal text embeddings are far smaller than
# the towers'. Phase 3's time_embedding.linear_1 fault is only logged:
# cross-attention on the towers' embeddings outweighs the time embedding,
# so it moves the reading by about 2 dB. The VAE gate reads the int8
# VAE's images against the bf16 VAE's under the same UNet. Readings:
# PERF.md section 6, PR 14
SERVE_BATCHES = (1, 4)
SERVE_SEED = 7
SERVE_ROUNDS = 2
SERVE_VAE_FAULT = "decoder.up_blocks_3_resnets_0.conv_shortcut"
SERVE_VAE_DB = 25.0
# the VAE decoder's largest int8 GEMMs at 512 px, B = 4 (phase 9's largest
# batch), and its ragged ones: 3x3 convs (H, C, K, B) -- the 512x512
# level (M = 1,048,576 rows), conv_out (N = 3), conv_in (C = 4), the
# 64x64 level -- and qmatmul (M, K, N): the 1x1 shortcut 256 -> 128 at
# 512x512, the mid-block attention projections at 64x64
VAE_CONVS = ((512, 256, 128, 4), (512, 128, 3, 1), (64, 4, 512, 1),
             (64, 512, 512, 4))
VAE_QMATMULS = ((4 * 512 * 512, 256, 128), (4 * 64 * 64, 512, 512))
MIN_SQNR_DB = 16.0     # whole step, int8 vs bf16 (sound: about 20-23 dB)
LAYER_SQNR_DB = 30.0   # each deploy entry vs fake quantization
# one fault each: caught only per layer / by both gates
FAULT_LAYERS = ("mid_block.attentions.0.transformer_blocks.0.attn2.to_kv",
                "time_embedding.linear_1")
SITE_SQNR_DB = 25.0    # each attention module, auto vs einsum
SITE_DB_PER_BIT = 3.0  # lower for each bit of to_out's act codes below 8
# to_out entries whose act zero point the attention kernels see shifted
# by 8 codes (the to_out GEMM's bias0 keeps the sound one)
FAULT_SITES = (
    "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0",
    "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0")
OUT_DIR = "chiprun_out"
N_SDXL_REQUESTS = 2
# zero-point faults at SDXL 1024 sites: sec_attention (attn1 at 32x32,
# attn2 at 64x64) and sec_attention_q (attn2 at 32x32)
SDXL_FAULT_SITES = (
    "mid_block.attentions.0.transformer_blocks.0.attn1.to_out.0",
    "down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_out.0",
    "up_blocks.0.attentions.0.transformer_blocks.0.attn2.to_out.0")
# whole SDXL 1024 bf16 step, flash attention (auto, mha's 1024-key blocks)
# vs the einsum chain: sound 35.04-35.09 dB, every flash site dropping its
# last 64 keys 32.31-32.94 (H100 80GB HBM3, at 550 W and at 700 W)
FLASH_SQNR_DB = 34.0
# each bf16 flash site vs the einsum chain: sound 50.65-53.67 dB, one
# site dropping its last 64 keys 38.63
FLASH_SITE_SQNR_DB = 45.0
# whole SDXL-Turbo step, each out-fusion set against the default one (one
# deploy, the same integer sums; the whole-block kernels round the output
# once where the default route rounds to_out and the residual add apart,
# and one bf16 ulp flips act codes downstream): sound 22.79-24.42 dB, one
# attn1 dropping its residual -3.87-3.33 (H100 80GB HBM3, 700 W)
OUTFUSE_STEP_SQNR_DB = 15.0
# each attn1 / ff module teacher-forced under out-fusion against the same
# module on the default route: sound 41.86-45.77 dB, mid zero points
# shifted by 8 codes 12.58 (attn1) / 1.25 (ff)
OUTFUSE_SITE_SQNR_DB = 30.0
# the whole-block faults: an attn1 site and an ff site whose mid act
# quantizer (to_out's, ff.net.2's) sees its zero point shifted by 8 codes;
# for the whole step, one attn1 site that drops its residual
OUTFUSE_FAULT_SITES = (
    "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0",
    "mid_block.attentions.0.transformer_blocks.0.ff.net.2")
# each int8 flash site of the SDXL 1024 deploy against its bf16 flash site
# on the same input: sound qk 40.12-48.16, qkv 39.71-47.09 dB; the q scale
# doubled 12.94 / 12.50
INT8_FLASH_SITE_SQNR_DB = {"qk": 30.0, "qkv": 30.0}
# keys the planted flash fault drops at the end of every flash site
FLASH_DROPPED_KEYS = 64
# profiled calls of each fused act-quantize GEMM in phase 1
FUSED_PROFILE_CALLS = 5
# probed calls of each cooperative sec_attention* case in phase 1
SPLIT_ITERS = 10
# card cycles spun before each timed call in phase 1 (~0.5 ms at the
# H100's clocks), more than any wrapper's host time
HOST_COVER_CYCLES = 1_000_000
# the redesigned kernels whose device ms every profile logs, by their
# device kernels' names (the GroupNorm producer runs three)
PROFILE_KERNELS = {"sec_attention": "sec_attn_kernel<",
                   "sec_attention_q": "sec_q_kernel<",
                   "sec_attention_qkv": "sec_qkv_kernel<",
                   "sec_attention_q_out": "sec_q_out_kernel<",
                   "sec_attention_qkv_out": "sec_qkv_out_kernel<",
                   "geglu_qmatmul": "geglu_kernel<",
                   "ln_quantize": "ln_quant_",
                   "geglu_out_qmatmul": "geglu_out_kernel<",
                   "gn_partial": "gn_partial<",
                   "gn_finalize": "gn_finalize(",
                   "gn_apply": "gn_apply<",
                   "flash_attention": "flash_bf16_kernel<",
                   "int8_flash_attention": "int8_flash_kernel<",
                   "int8qkv_flash_attention": "int8qkv_flash_kernel<"}
# timed calls of each kernel benchmark row in phase 8
KB_ITERS = 5
_NONE = dict(qconv2d=0, qconv2d_s2=0, gn_silu_quantize=0, ln_quantize=0,
             geglu_qmatmul=0, qmatmul=0, sec_attention_qkv=0,
             sec_attention_q_out=0, flash_attention=0, sec_attention=0,
             sec_attention_q=0, wq4_matmul=0, wq_matmul=0,
             sec_attention_qkv_out=0, geglu_out_qmatmul=0,
             int8_flash_attention=0, int8qkv_flash_attention=0,
             qmatmul_fused=0, qmatmul_fused2=0)
# launches per SDXL-Turbo W8A8 step, B=1, under the default kernel options
# (out-fusion at attn2, LN folded, the time-embedding bank on: the 17
# time_emb_proj GEMMs as 3 launches over a layer axis, N = 320 / 640 /
# 1280)
TURBO_CALLS = dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                   ln_quantize=140, geglu_qmatmul=70, qmatmul=250,
                   sec_attention_qkv=70, sec_attention_q_out=70)
# ... under the other out-fusion sets: every site whole-block (LN folded or
# materialized at the block: 70 ln_quantize each for norm1, norm2, norm3),
# and none (attn2 on sec_attention_q, to_out and ff.net.2 on qmatmul)
ALL_SITES = frozenset({"attn1", "attn2", "ff"})
OUTFUSE_PATHS = {"all": dict(out_fuse=ALL_SITES),
                 "all_nofold": dict(out_fuse=ALL_SITES, ln_fold=False),
                 "none": dict(out_fuse=frozenset())}
_WHOLE = dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
              qmatmul=110, sec_attention_qkv_out=70, sec_attention_q_out=70,
              geglu_out_qmatmul=70)
OUTFUSE_CALLS = {
    "all": _WHOLE, "all_nofold": dict(_WHOLE, ln_quantize=210),
    "none": dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                 ln_quantize=210, geglu_qmatmul=70, qmatmul=320,
                 sec_attention_qkv=70, sec_attention_q=70)}
# launches per SDXL 1024 step, B=1: 70 transformer blocks, 10 at T=4096
# and 60 at T=1024, every norm materialized, the 60 to_q of the 32x32
# level inside sec_attention_q; int8_flash moves the 10 int8 flash sites
_SDXL_AUTO = dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                  ln_quantize=210, geglu_qmatmul=70, qmatmul=400,
                  sec_attention=70, sec_attention_q=60)
SDXL_CALLS = {
    "auto": dict(_SDXL_AUTO, flash_attention=10),
    "einsum": dict(_NONE, qconv2d=38, qconv2d_s2=2, gn_silu_quantize=46,
                   ln_quantize=210, geglu_qmatmul=70, qmatmul=460),
    "bf16": dict(_NONE, flash_attention=10),
    "int8_qk": dict(_SDXL_AUTO, int8_flash_attention=10),
    "int8_qkv": dict(_SDXL_AUTO, int8qkv_flash_attention=10),
}
# launches per mixed-precision SDXL-Turbo step (W5.04 / A7.43 +
# act-protect, B=1) under each deploy compute: int8_sec unfuses the 22 attn2
# sites whose to_k is protected or whose to_k and to_v differ in act bits
# (sec_attention there and at the protected to_q); the weight-only deploys
# run every packed dense entry on wq4_matmul, pallas_dequant every
# act-quantized W8 one on wq_matmul and its eight act-quantized 1x1 convs
# on qmatmul
MP_CALLS = {
    "int8_sec": dict(_NONE, qconv2d=37, qconv2d_s2=2, gn_silu_quantize=46,
                     ln_quantize=160, geglu_qmatmul=68, qmatmul=310,
                     sec_attention_qkv=70, sec_attention_q_out=48,
                     sec_attention=22),
    "dequant": dict(_NONE, wq4_matmul=376),
    "pallas_dequant": dict(_NONE, qmatmul=8, wq4_matmul=376, wq_matmul=365),
}
MP_DIR = os.path.join("configs", "mp", "sdxl_turbo")
# phase 10, the PTQ flow: the config as shipped, its split layers, and the
# prompts and seed of its serving gate and params check
PTQ_CONFIG = os.path.join("configs", "sdxl_turbo.yaml")
PTQ_SPLIT_LAYERS = 9
PTQ_LAYERS = 794
MP_PATHS = {"int8_sec": "sdxl-turbo mp auto",
            "dequant": "sdxl-turbo w-only dequant",
            "pallas_dequant": "sdxl-turbo w-only pallas_dequant"}
# each mixed path vs bf16 (random weights: 28 W2 and 6 A2 layers; the W8A8
# gate of 16 dB does not apply): sound 0.48-5.70 dB on an H100 80GB HBM3 at
# 700 W, an all-zero output reads 0 dB
MP_SQNR_DB = 0.25
# whole step, pallas_dequant vs dequant: one deploy, the scale rounded
# before (kernels) or after (plain product) the W8 products, and the 1x1
# convs act-quantized under pallas_dequant: sound 26.84-29.38 dB, swapped
# nibbles in time_embedding.linear_1 -0.65-4.04 dB (H100 80GB HBM3, 700 W)
WONLY_SQNR_DB = 20.0
# a packed W4 entry whose output feeds every resnet
MP_FAULT_PACKED = "time_embedding.linear_1"
# to_out entries of two sec_attention sites the protect list makes: attn2
# with its to_k protected (to_kv unfused) and with its to_q protected
MP_FAULT_SITES = (
    "mid_block.attentions.0.transformer_blocks.2.attn2.to_out.0",
    "mid_block.attentions.0.transformer_blocks.6.attn2.to_out.0")

# phase 11, fake-quant mode and the rest of QuantCtx. The module gate:
# each attention / ff / resnet module of a float32 copy of the UNet,
# teacher-forced on its FP-step input, fake quantization against the W8A8
# deploy under deploy_compute='int8' (einsum route: the same chain; its
# act-quantizers read the values fake mode's read) at LAYER_SQNR_DB. In
# bf16, fake mode rounds each dequantized value to 8 significant bits,
# about a code far from the zero point, and the int8_sec producers
# quantize f32 values that fake mode first rounds to bf16: sound ff and
# resnet modules then read 25.9-28.2 dB (H100 80GB HBM3, 700 W), logged
# only. The gate's planted fault doubles the act delta of one
# layer in the fake context: an ff.net.2, whose input (the GEGLU's
# heavy-tailed product) has the coarsest 8-bit codes of a module's layers
FAKE_FAULT_LAYER = "mid_block.attentions.0.transformer_blocks.0.ff.net.2"
# the whole steps' planted faults: in a fake step conv_in's weight delta a
# 64th of itself (its weights clipped to a 64th of their range), in a
# deploy the sign of conv_in's scale flipped (phase 3's fault there, half
# its channels at twice their scale, reads 16.84 dB on the towers'
# embeddings: not caught)
STEP_FAULT_LAYER = "conv_in"
# the mixed fake step's per-entry gate (W >= 4 entries, fake against the
# deploy) is failed by one W4 entry's weight delta halved in the fake
# context
MIXED_FAULT_LAYER = "time_embedding.linear_1"
# the q/k/v/softmax act quantizers of SDXL-Turbo: 70 transformer blocks,
# two attentions each, four quantizers each
QKV_QUANT_ENTRIES = 560
# the explicit attn_impl values and the kernel each runs at every site
EXPLICIT_IMPLS = ("flash", "int8_flash", "int8qkv_flash")
# launches per SDXL 1024 fake step under 'auto': the ten attn1 sites at
# T = 4096
FAKE_SDXL_CALLS = dict(_NONE, flash_attention=10)

# phase 12, this slice's paths on phase 10's files. BoS: the fused attn2
# to_kv entries of SDXL-Turbo, and the largest relative difference of
# bos_out against emb0 @ W_fp in f32 on the card (the same product: 0 as
# a rule; the dequantized weight's, the parent's fallback, ~1e-2)
BOS_ENTRIES = 70
BOS_REL = 1e-5
# the small-M hybrid's threshold: the 16x16 level's 256 tokens and the
# text's 77 run weight-only, the 32x32 level's 1024 int8
SMALL_M = 256
# the search's target bits (the repo's final_config/weight/5.04.yaml was
# elected at this target)
SEARCH_TARGET = 5.02
# HiGHS's default relative MIP gap (scipy.optimize.milp) is 1e-4: the
# solver may stop at any solution that close to the optimum, and where it
# stops depends on its version. The repo's 5.04.yaml is scipy 1.17's
# stop, scipy 1.18.1 (the card's) stops elsewhere (424 of 794 layers
# equal): two such solutions lie within twice the gap of each other, so
# the gate holds the objectives to that and each group's bits to the
# +-0.02 band, and logs the layer agreement
ILP_REL_GAP = 2e-4
# the elected map (the --quick search moves 16 layers off W8A8: content
# layers down to W2) against bf16; conv_out's scale negated reads about
# -5 dB
ELECTED_SQNR_DB = 3.0

# qmatmul over a layer axis (L, M, K, N) in phase 1
BANK_QMATMULS = ((5, 1, 1280, 640), (60, 77, 2048, 2560))

# phase 14, SD1.5 (``sd15``, 512 px, heads of 40 / 80 / 160): launches
# per W8A8 step under 'auto' (flash attention at the five attn1 sites of
# the 64x64 level, T = 4096, d = 40; no sec_attention*: d does not divide
# 128; 22 time_emb_proj GEMMs as 3 bank launches), and with int8 flash
SD15_CALLS = dict(_NONE, qconv2d=49, qconv2d_s2=3, gn_silu_quantize=45,
                  ln_quantize=48, geglu_qmatmul=16, qmatmul=147,
                  flash_attention=5)
SD15_INT8_CALLS = {
    "qk": dict(SD15_CALLS, flash_attention=0, int8_flash_attention=5),
    "qkv": dict(SD15_CALLS, flash_attention=0, int8qkv_flash_attention=5)}
N_SD15_REQUESTS = 2
# the key counts of the explicit attn_impl steps' dropped-keys fault: the
# text's 77 and the 16x16 level's self-attention (d = 160)
SD15_FAULT_TK = (77, 256)
SD15_MP_DIR = os.path.join("configs", "mp", "sd15")
SD15_CONFIG = os.path.join("configs", "sd15_lcm.yaml")
SD15_LAYERS = 282
# the LCM serving loop: 4 steps, g = 1 (no CFG batch), prompts and seed
SD15_STEPS = 4
SD15_SEED = 11

# phase 15: the reconstructions' Adam steps (``--recon_iters``, at the
# CLI's lr), the calibration samples of their runs (one seeded sample, cut
# from the configs' 32 prompts: memory, PERF.md section 6), the W4 gate's
# bits and lr (the JAX package's test_recon.py lr), the QAT steps and lr
# (Adam moves each of SD1.5's 0.86 G parameters by about lr a step: at
# 1e-6 one step lifts the loss 12x, at 1e-7 it wanders, at 3e-8 it falls
# 2-5 % in ten; H100 80GB HBM3, 700 W), and the family the converters
# round-trip
RECON_ITERS = 5
RECON_SAMPLES = 1
RECON_SEED = 5
RECON_W4_BITS = 4
RECON_W4_LR = 3e-3
QAT_STEPS = 10
QAT_LR = 3e-8
QAT_FAMILY = "sd15"
RECON_TURBO_CONFIG = PTQ_CONFIG
RECON_SD15_CONFIG = SD15_CONFIG
CONVERT_FAMILY = "sdxl-turbo"

# phase 13: evaluate's matrix, prompts and batch; its UNet calls per
# entry (2 batches of one step)
EVAL_MATRIX = ("w8_int8", "w8_sec", "w4_sec", "mp_sec")
EVAL_PROMPTS, EVAL_BATCH = 4, 2
EVAL_UNET_CALLS = 2
EVAL_SEED = 13
# the report's keys after an entry's fields (the JAX script's order)
EVAL_KEYS = ("n_prompts", "ssim_mean", "pixel_mse_mean",
             "latent_sqnr_db_mean", "clip_fid", "clip_cosine_mean",
             "inception_fid")
# |FID(FP, FP)| against the distance's scale tr C + tr C: four images in
# 2048 dimensions (rank 3) in f32, the square roots' clipped null
# eigenvalues leave about 1.5% of the scale (-0.93 of 63.27 on the card;
# the planted fault reads 5.8 times its scale)
FID_SELF_REL = 0.05
# memory_compare's W8A8 static saving: bf16 -> int8 codes halves the
# UNet's 2.57 B weights (5.14 GB -> 2.57 GB, plus f32 scales and biases,
# the time-embedding bank and the BoS rows: ~1.9x); the planted fault,
# the fp weights not pruned, reads ~0.67x
MEM_STATIC_SAVING = 1.7
SERVE_BENCH_KEYS = ("family", "steps", "batch_size", "deploy_compute",
                    "quantize_vae", "fp_imgs_per_sec", "int8_imgs_per_sec",
                    "speedup", "ssim_vs_fp", "fp_batch_ms",
                    "host_fingerprint_ms")
SERVE_BENCH_STEPS, SERVE_BENCH_BATCH = 10, 4
SWEEP_BATCHES = (1, 2, 4, 8)
# phase 16: the prompt and seeds of its generations, and the swept layers
# of its dp sweep (a spatial conv, a dense layer, a split conv)
MESH_SEED = 11
COMFY_SEED = 42
MESH_SWEEP_LAYERS = ("conv_in", "down_blocks.1.attentions.0."
                     "transformer_blocks.0.attn1.to_q",
                     "up_blocks.1.resnets.0.conv_shortcut")
SWEEP_KEYS = ("B", "bf16_ms", "int8_ms", "speedup", "ms_per_img",
              "host_fingerprint_ms")

# every function of the JAX package that reaches pl.pallas_call
TPU_KERNELS = [
    ("pallas_qconv.py:331 qconv2d_pallas", "qconv2d"),
    ("pallas_qconv.py:500 qconv2d_pallas_s2", "qconv2d_s2"),
    ("pallas_gn_quant.py:116 gn_silu_quantize", "gn_silu_quantize"),
    ("pallas_ln_quant.py:55 ln_quantize", "ln_quantize"),
    ("pallas_qmatmul.py:352 geglu_qmatmul", "geglu_qmatmul"),
    ("pallas_qmatmul.py:67 qmatmul", "qmatmul"),
    ("pallas_qmatmul.py:205 qmatmul_fused2", "qmatmul_fused2"),
    ("pallas_qmatmul.py:557 geglu_out_qmatmul", "geglu_out_qmatmul"),
    ("pallas_qmatmul.py:724 qmatmul_fused", "qmatmul_fused"),
    ("pallas_sec_attention.py:99 sec_attention", "sec_attention"),
    ("pallas_sec_attention.py:223 sec_attention_q", "sec_attention_q"),
    ("pallas_sec_attention.py:409 sec_attention_qkv", "sec_attention_qkv"),
    ("pallas_sec_attention.py:647 sec_attention_qkv_out",
     "sec_attention_qkv_out"),
    ("pallas_sec_attention.py:814 sec_attention_q_out",
     "sec_attention_q_out"),
    ("pallas_attention.py:83 flash_attention", "flash_attention"),
    ("pallas_attention.py:204 int8_flash_attention",
     "int8_flash_attention"),
    ("pallas_attention.py:303 int8qkv_flash_attention",
     "int8qkv_flash_attention"),
    ("pallas_wq_matmul.py:96 wq4_matmul", "wq4_matmul"),
    ("pallas_wq_matmul.py:164 wq_matmul", "wq_matmul"),
]
PORTED = {
    "qconv2d": ("mixdq_tpu_torch/csrc/qconv.cu",
                "mixdq_tpu/ops/pallas_qconv.py:437"),
    "qconv2d_s2": ("mixdq_tpu_torch/csrc/qconv.cu",
                   "mixdq_tpu/ops/pallas_qconv.py:500"),
    "gn_silu_quantize": ("mixdq_tpu_torch/csrc/gn_quant.cu",
                         "mixdq_tpu/ops/pallas_gn_quant.py:147"),
    "ln_quantize": ("mixdq_tpu_torch/csrc/ln_quant.cu",
                    "mixdq_tpu/ops/pallas_ln_quant.py:82"),
    "geglu_qmatmul": ("mixdq_tpu_torch/csrc/geglu_qmatmul.cu",
                      "mixdq_tpu/ops/pallas_qmatmul.py:438"),
    "qmatmul": ("mixdq_tpu_torch/csrc/qmatmul.cu",
                "mixdq_tpu/ops/pallas_qmatmul.py:109"),
    "sec_attention_qkv": ("mixdq_tpu_torch/csrc/sec_attention.cuh",
                          "mixdq_tpu/ops/pallas_sec_attention.py:460"),
    "sec_attention_q_out": ("mixdq_tpu_torch/csrc/sec_attention.cuh",
                            "mixdq_tpu/ops/pallas_sec_attention.py:927"),
    "sec_attention": ("mixdq_tpu_torch/csrc/sec_attention.cu",
                      "mixdq_tpu/ops/pallas_sec_attention.py:151"),
    "sec_attention_q": ("mixdq_tpu_torch/csrc/sec_attention.cuh",
                        "mixdq_tpu/ops/pallas_sec_attention.py:271"),
    "flash_attention": ("mixdq_tpu_torch/csrc/flash_attention.cu",
                        "mixdq_tpu/ops/pallas_attention.py:106"),
    "wq4_matmul": ("mixdq_tpu_torch/csrc/wq_matmul.cu",
                   "mixdq_tpu/ops/pallas_wq_matmul.py:133"),
    "wq_matmul": ("mixdq_tpu_torch/csrc/wq_matmul.cu",
                  "mixdq_tpu/ops/pallas_wq_matmul.py:208"),
    "sec_attention_qkv_out": ("mixdq_tpu_torch/csrc/sec_attention.cuh",
                              "mixdq_tpu/ops/pallas_sec_attention.py:757"),
    "geglu_out_qmatmul": ("mixdq_tpu_torch/csrc/geglu_qmatmul.cu",
                          "mixdq_tpu/ops/pallas_qmatmul.py:702"),
    "int8_flash_attention": ("mixdq_tpu_torch/csrc/int8_flash.cu",
                             "mixdq_tpu/ops/pallas_attention.py:228"),
    "int8qkv_flash_attention": ("mixdq_tpu_torch/csrc/int8_flash.cu",
                                "mixdq_tpu/ops/pallas_attention.py:330"),
    "qmatmul_fused": ("mixdq_tpu_torch/csrc/qmatmul_fused.cu",
                      "mixdq_tpu/ops/pallas_qmatmul.py:760"),
    "qmatmul_fused2": ("mixdq_tpu_torch/csrc/qmatmul_fused.cu",
                       "mixdq_tpu/ops/pallas_qmatmul.py:263"),
}

_FUSED_LIBRARY = ("torch._int_mm on the codes quantized before the timed "
                  "region: the int32 product without the quantize and the "
                  "epilogue, w row-major as stored (library_ms) and a "
                  "K-major copy (library_kmajor_ms); quantize_qmatmul_ms: "
                  "the act-quantize then the qmatmul kernel")
# what library_ms times, where a kernel has one
LIBRARY = {"qmatmul": "torch._int_mm on the same operands: the int32 "
                      "product without the epilogue, w row-major [K, N] as "
                      "the port stores it (library_ms) and a K-major copy "
                      "of w made before the timed region "
                      "(library_kmajor_ms), the layout cuBLASLt's int8 "
                      "path prefers",
           "flash_attention": "torch.nn.functional.scaled_dot_product_"
                              "attention on head-major views of the same "
                              "q/k/v (output [B, heads, T, d])",
           "wq4_matmul": "torch.matmul(x, w) on the weight dequantized to "
                         "bf16 before the timed region",
           "wq_matmul": "torch.matmul(x, w) on the weight dequantized to "
                        "bf16 before the timed region",
           "qmatmul_fused": _FUSED_LIBRARY,
           "qmatmul_fused2": _FUSED_LIBRARY,
           "gn_silu_quantize": "none (library_ms null): no single PyTorch "
                               "call computes GroupNorm with SiLU and the "
                               "act-quantize",
           "geglu_qmatmul": "none (library_ms null): no single PyTorch call "
                            "computes the int8 GEMM with the GEGLU gate and "
                            "the act-quantize",
           "qconv2d": "none (library_ms null): no single PyTorch call "
                      "computes an int8 convolution with the dequant "
                      "epilogue",
           "qconv2d_s2": "none (library_ms null): no single PyTorch call "
                         "computes an int8 convolution with the dequant "
                         "epilogue",
           "ln_quantize": "none (library_ms null): no single PyTorch call "
                          "computes LayerNorm with the act-quantize",
           "geglu_out_qmatmul": "none (library_ms null): no single PyTorch "
                                "call computes the int8 feed-forward (GEGLU, "
                                "act-quantize, int8 GEMM, residual)",
           "int8_flash_attention": "none (library_ms null): no single "
                                   "PyTorch call computes attention on int8 "
                                   "codes; flash_attention's "
                                   "scaled_dot_product_attention time is a "
                                   "bf16 comparison only",
           "int8qkv_flash_attention": "none (library_ms null): no single "
                                      "PyTorch call computes attention on "
                                      "int8 codes; flash_attention's "
                                      "scaled_dot_product_attention time is "
                                      "a bf16 comparison only"}
for _k in ("sec_attention", "sec_attention_q", "sec_attention_qkv",
           "sec_attention_qkv_out", "sec_attention_q_out"):
    LIBRARY[_k] = ("none (library_ms null): no single PyTorch call computes "
                   "the int8 projections with attention on their codes")


#: the open ``chiprun_out/chip_smoke.log`` (``main``): every line of
#: ``log`` also goes there, since the command's output keeps only its end
LOG_FILE = None
T_START = 0.0


def log(*a):
    print(*a, flush=True)
    if LOG_FILE is not None:
        print(*a, file=LOG_FILE, flush=True)


def elapsed():
    """`` [N s]``: the seconds since the script started, for a phase's
    closing line."""
    return f" [{time.time() - T_START:.1f}s]"


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations over the peak rate of their type; ``ops`` is a list of
    (count, peak) pairs, one per type."""
    tb, to = nbytes / HBM_BYTES_PER_S, sum(n / peak for n, peak in ops)
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def time_ms(torch, fn, iters, flush):
    """Mean device time of ``fn`` per call, each call timed alone by CUDA
    events after overwriting a 256 MB buffer (the L2 holds 50 MB), so
    weights come from device memory as in a UNet step. A spin of
    ``HOST_COVER_CYCLES`` on the card after the flush keeps it busy while
    the host enqueues the call, so that the events time the call's device
    work and not its wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(HOST_COVER_CYCLES)
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def codes_err(torch, got, want, what="codes"):
    diff = (got.int() - want.int()).abs()
    frac = (diff > 0).float().mean().item()
    err = diff.max().item()
    if err > 1 or frac >= 0.01:
        raise AssertionError(f"{what} differ: max {err}, fraction {frac}")
    return float(err)


def exact_err(torch, got, want):
    """The int8 GEMMs on the shared mainloop (``qmatmul``, ``qconv2d``,
    ``qmatmul_fused``, ``qmatmul_fused2``, the GEMM stages of the
    cooperative ``sec_attention*`` kernels) against their plain versions:
    equal bit for bit (exact int32 sums in any split and order, then the
    same f32 steps)."""
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"int8 GEMM differs: max "
                             f"{(got.float() - want.float()).abs().max()}")
    return 0.0


def float_err(torch, got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-3,
                               atol=1e-2)
    return (got.float() - want.float()).abs().max().item()


def fused_err(torch, got, want, code):
    """A fused act-quantize GEMM against another computation of the same
    function: rtol 1e-3 / atol 1e-2, but for under 1% of entries, each of
    those within one code's worth of its column (``code``: ``scale[n] *
    max |w[:, n]|``, [N] or a number). Both form the codes from the same
    bf16 values and sum them exactly, so they agree but where a code
    lands apart."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    tol = 1e-2 + 1e-3 * want.abs()
    frac = (d > tol).float().mean().item()
    if frac >= 0.01 or bool((d > tol + code).any()):
        raise AssertionError(f"fused GEMM outputs differ: max {d.max().item()}"
                             f", fraction {frac} beyond rtol 1e-3 / atol "
                             "1e-2")
    return d.max().item()


def kernel_cases(torch, dev):
    """(kernel, shape label, kernel call, plain call, compare, bytes,
    [(ops, peak) per type], library call or None[, K-major library call,
    act-quantize + qmatmul chain, GEMM-stage check]) at the main-path
    shapes; the first case of each kernel is its reported shape."""
    from mixdq_tpu_torch.ops import (attention, gn_quant, ln_quant, qconv,
                                     qmatmul, qops, sec_attention, wq_matmul)

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = []
    # the int8 GEMMs' plans (qmm_plan / qconv_plan) on this card go into
    # each label
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan_label(plan):
        return (f" plan {plan.bm}x{plan.bn} tiles x{plan.tiles}, "
                f"{plan.stages} stages, {plan.splits} split(s) of "
                f"{plan.split_k} k, {plan.blocks} blocks")

    # (kernel, stride, H, C, K, epilogue, B): the UNet's, then the VAE
    # decoder's (``VAE_CONVS``)
    convs = [("qconv2d", 1, 64, 320, 320, True, 1), ("qconv2d", 1, 16, 2560,
             1280, True, 1), ("qconv2d", 1, 64, 4, 320, False, 1),
             ("qconv2d", 1, 64, 320, 4, False, 1), ("qconv2d", 1, 32, 1920,
             640, True, 1), ("qconv2d_s2", 2, 64, 320, 320, False, 1),
             ("qconv2d_s2", 2, 32, 640, 640, False, 1),
             ("qconv2d", 1, 16, 1280, 1280, True, 1)] + [
             ("qconv2d", 1, H, C, K, False, B) for H, C, K, B in VAE_CONVS]
    for name, stride, H, C, K, epi, B in convs:
        x, w = codes(B, H, H, C), codes(3, 3, C, K)
        scale = (torch.rand(K, generator=g, device=dev) + 0.5) * 1e-4
        bias0 = -3.0 * w.int().sum((0, 1, 2)).float()
        P = H // stride
        kw = dict(bias=randn(K, dtype=bf16),
                  extra_bias=randn(B, K, dtype=bf16) if epi else None,
                  residual=randn(B, P, P, K, dtype=bf16) if epi else None)
        fn = qconv.qconv2d if stride == 1 else qconv.qconv2d_s2
        nbytes = B * (H * H * C + 2 * P * P * K * (2 if epi else 1)) \
            + 9 * C * K
        plan = qconv.qconv_plan(B, H, H, C, K, 3, 3, stride, (1, 1), sms)
        cases.append((
            name, f"{C}->{K} @{H}x{H}" + (f" B={B}" if B > 1 else "")
            + (" +temb+res" if epi else "") + plan_label(plan),
            lambda fn=fn, a=(x, w, scale, bias0), kw=kw: fn(*a, -3.0, **kw),
            lambda s=stride, a=(x, w, scale, bias0), kw=kw:
                qconv.qconv2d_plain(*a, -3.0, stride=s, **kw),
            exact_err, nbytes, [(2 * B * P * P * K * 9 * C, INT8_OPS_PER_S)],
            None))
    for shape, silu, eps in [((1, 64, 64, 320), True, 1e-5),
                             ((1, 32, 32, 640), False, 1e-6),
                             ((1, 16, 16, 2560), True, 1e-5),
                             ((1, 64, 64, 960), True, 1e-5),
                             ((1, 128, 128, 320), True, 1e-5)]:
        C = shape[-1]
        x = randn(*shape, dtype=bf16) * 2
        gam, bet = torch.rand(C, generator=g, device=dev) + 0.5, randn(C)
        args = (x, gam, bet, 30.0, -5.0, 32, eps, silu)
        n = x.numel()
        cases.append(("gn_silu_quantize",
                      f"{list(shape)} silu={silu}",
                      lambda a=args: gn_quant.gn_silu_quantize(*a),
                      lambda a=args: gn_quant.gn_silu_quantize_plain(*a),
                      codes_err, 3 * n, [(12 * n, F32_OPS_PER_S)], None))
    for shape in [(1, 1024, 640), (1, 256, 1280), (1, 4096, 640)]:
        C = shape[-1]
        x = randn(*shape, dtype=bf16) * 3
        args = (x, torch.rand(C, generator=g, device=dev) + 0.5, randn(C),
                20.0, 3.0)
        n = x.numel()
        cases.append(("ln_quantize", str(list(shape)),
                      lambda a=args: ln_quant.ln_quantize(*a),
                      lambda a=args: ln_quant.ln_quantize_plain(*a),
                      codes_err, 3 * n, [(8 * n, F32_OPS_PER_S)], None))
    # 512 px (16x16, 32x32), then 1024 px (32x32, 64x64)
    for M, K, H in [(256, 1280, 5120), (1024, 640, 2560), (1024, 1280, 5120),
                    (4096, 640, 2560)]:
        x, w = codes(M, K), codes(K, 2 * H)
        scale = (torch.rand(2 * H, generator=g, device=dev) + 0.5) * 2e-5
        bias0 = 5.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, 25.0, 4.0, randn(2 * H, dtype=bf16))
        cases.append(("geglu_qmatmul", f"M={M} K={K} 2H={2 * H}"
                      + plan_label(qmatmul.geglu_plan(M, K, H, sms)),
                      lambda a=args: qmatmul.geglu_qmatmul(*a),
                      lambda a=args: qmatmul.geglu_qmatmul_plain(*a),
                      codes_err, M * K + 2 * K * H + M * H,
                      [(4 * M * K * H, INT8_OPS_PER_S)], None))
    # qmatmul: ff.net.2 @32x32 first, time_emb_proj, to_kv, ff.net.2
    # @16x16, conv_shortcut @64x64, to_out / proj_in / proj_out @16x16 (the
    # headline step's most frequent shape), attn1 to_out @32x32; library:
    # torch._int_mm, the product alone (cuBLASLt refuses M <= 16), on w as
    # the port stores it (row-major [K, N]) and on a K-major copy made
    # beforehand
    for M, K, N in [(1024, 2560, 640), (1, 1280, 1280), (77, 2048, 2560),
                    (256, 5120, 1280), (4096, 960, 320), (256, 1280, 1280),
                    (1024, 640, 640)] + list(VAE_QMATMULS):
        x, w = codes(M, K), codes(K, N)
        wk = w.t().contiguous().t()  # [K, N], K-major
        scale = (torch.rand(N, generator=g, device=dev) + 0.5) * 1e-5
        bias0 = -9.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, randn(N, dtype=bf16))
        cases.append(("qmatmul", f"M={M} K={K} N={N}"
                      + plan_label(qmatmul.qmm_plan(M, K, N, sms)),
                      lambda a=args: qmatmul.qmatmul(*a),
                      lambda a=args: qmatmul.qmatmul_plain(*a),
                      exact_err, M * K + K * N + 10 * N + 2 * M * N,
                      [(2 * M * K * N, INT8_OPS_PER_S)],
                      (lambda x=x, w=w: torch._int_mm(x, w)) if M > 16
                      else None,
                      (lambda x=x, w=wk: torch._int_mm(x, w)) if M > 16
                      else None))
    # qmatmul over a layer axis at the banks' shapes: the time-embedding
    # bank's N = 640 group (5 of its 5 / 5 / 7 layers) and the cross-k/v
    # bank's 60 layers at the 16x16 level; equal to the plain version bit
    # for bit (which loops over the members). No single PyTorch call
    # computes a batched int8 product (library: null)
    for L, M, K, N in BANK_QMATMULS:
        x, w = codes(L, M, K), codes(L, K, N)
        scale = (torch.rand(L, N, generator=g, device=dev) + 0.5) * 1e-5
        bias0 = -9.0 * w.int().sum(1).float()
        args = (x, w, scale, bias0)
        cases.append(("qmatmul", f"layers L={L} M={M} K={K} N={N}"
                      + plan_label(qmatmul.layers_plan(L, M, K, N, sms)),
                      lambda a=args: qmatmul.qmatmul(*a),
                      lambda a=args: qmatmul.qmatmul_plain(*a),
                      exact_err, L * (M * K + K * N + 8 * N + 2 * M * N),
                      [(2 * L * M * K * N, INT8_OPS_PER_S)], None))
    # the fused act-quantize GEMMs at the kernel benchmark's shapes, ff.net.2
    # of SDXL 1024's 32x32 level first, the ragged one (scalar loads,
    # masked tails), K % 128 != 0, M = 1, a bf16 column slice of x (rows
    # unaligned, read in place), f32 output and K = 16384; both equal the
    # plain version bit for bit. Library: torch._int_mm on the codes
    # quantized beforehand (the product alone), w row-major as stored and a
    # K-major copy; chain: the act-quantize then the qmatmul kernel
    for name in ("qmatmul_fused", "qmatmul_fused2"):
        for M, K, N, xcol, odt in [
                (1024, 5120, 1280, 0, bf16), (4096, 640, 640, 0, bf16),
                (1024, 1280, 1280, 0, bf16), (1024, 1280, 5120, 0, bf16),
                (48, 300, 130, 0, bf16), (200, 1000, 384, 0, bf16),
                (1, 1280, 1280, 0, bf16), (256, 1280, 640, 3, bf16),
                (1024, 5120, 1280, 0, torch.float32),
                (64, 16384, 128, 0, bf16)]:
            x = randn(M, K + xcol, dtype=bf16)[:, xcol:]
            w = codes(K, N)
            wk = w.t().contiguous().t()  # [K, N], K-major
            scale = (torch.rand(N, generator=g, device=dev) + 0.5) * 1e-5
            bias0 = -3.0 * w.int().sum(0).float()
            args = (x, w, 10.0, -3.0, scale, bias0, odt)
            xq = qops.quantize_per_tensor(x, 10.0, -3.0)
            plan = qmatmul.qmm_plan(M, K, N, sms)
            grid = (f", grid {qmatmul.fused2_grid(plan, 1, sms)} at one "
                    "block an SM" if name == "qmatmul_fused2" else "")
            lib_ok = M > 16 and K % 8 == 0 and N % 8 == 0
            cases.append((
                name, f"M={M} K={K} N={N}"
                + (f" x[:, {xcol}:] slice" if xcol else "")
                + (" f32 out" if odt == torch.float32 else "")
                + plan_label(plan) + grid,
                lambda f=getattr(qmatmul, name), a=args: f(*a),
                lambda a=args: qmatmul.qmatmul_fused_plain(*a),
                exact_err,
                2 * M * K + K * N + 8 * N + odt.itemsize * M * N,
                [(2 * M * K * N, INT8_OPS_PER_S), (4 * M * K, F32_OPS_PER_S)],
                (lambda xq=xq, w=w: torch._int_mm(xq, w)) if lib_ok else None,
                (lambda xq=xq, w=wk: torch._int_mm(xq, w)) if lib_ok else None,
                lambda a=args: qmatmul.qmatmul(
                    qops.quantize_per_tensor(a[0], 10.0, -3.0), a[1], a[4],
                    a[5], out_dtype=a[6])))
    # attn1 / attn2 at the 32x32 (T=1024, C=640, 10 heads) and 16x16
    # (T=256, C=1280, 20 heads) levels, d=64, Tk=77
    for T, heads in [(1024, 10), (256, 20)]:
        C = heads * 64
        args, kw = qkv_case(torch, g, dev, 1, T, heads, 64)
        cases.append(("sec_attention_qkv", f"T={T} C={C} heads={heads}",
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv_plain(*a, **kw),
                      codes_err, 2 * T * C + 3 * C * C + 24 * C,
                      [(6 * T * C * C, INT8_OPS_PER_S),
                       (4 * T * T * C, BF16_OPS_PER_S)], None, None, None,
                      sec_gemms_exact(torch, "sec_attention_qkv", args, kw)))
    for T, heads, ln in [(1024, 10, True), (256, 20, True), (256, 20, False)]:
        C = heads * 64
        args, kw = q_out_case(torch, g, dev, 1, T, 77, heads, 64, C, bf16, ln)
        nbytes = (T * C * (2 if ln else 3) + 2 * C * C + 4 * 77 * C
                  + 2 * T * C + 30 * C)
        cases.append(("sec_attention_q_out",
                      f"Tq={T} C={C} heads={heads} "
                      + ("LN-folded" if ln else "pre-coded + residual"),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q_out(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q_out_plain(*a, **kw),
                      float_err, nbytes,
                      [(4 * T * C * C, INT8_OPS_PER_S),
                       (4 * T * 77 * C, BF16_OPS_PER_S),
                       (8 * T * C if ln else 0, F32_OPS_PER_S)], None, None,
                      None, sec_gemms_exact(torch, "sec_attention_q_out",
                                            args, kw)))
    # attn1 whole-block at the same levels: LN-folded (the main path) and
    # pre-coded + residual (ln_fold off)
    for T, heads, ln in [(1024, 10, True), (256, 20, True), (1024, 10, False),
                         (256, 20, False)]:
        C = heads * 64
        args, kw = qkv_out_case(torch, g, dev, 1, T, heads, 64, bf16, ln)
        cases.append(("sec_attention_qkv_out",
                      f"T={T} C={C} heads={heads} "
                      + ("LN-folded" if ln else "pre-coded + residual"),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv_out(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_qkv_out_plain(*a, **kw),
                      float_err,
                      T * C * (2 if ln else 3) + 4 * C * C + 2 * T * C
                      + 30 * C,
                      [(8 * T * C * C, INT8_OPS_PER_S),
                       (4 * T * T * C, BF16_OPS_PER_S),
                       (8 * T * C if ln else 0, F32_OPS_PER_S)], None, None,
                      None, sec_gemms_exact(torch, "sec_attention_qkv_out",
                                            args, kw)))
    # the whole feed-forward at both levels, LN-folded and pre-coded
    for M, C, ln in [(1024, 640, True), (256, 1280, True), (1024, 640, False),
                     (256, 1280, False)]:
        H = 4 * C
        args, kw = geglu_out_case(torch, g, dev, M, C, H, C, bf16, ln)
        plan = qmatmul.device_geglu_out_plan(dev, M, C, H, C)
        cases.append(("geglu_out_qmatmul",
                      f"M={M} K=C={C} H={H} "
                      + ("LN-folded" if ln else "pre-coded + residual")
                      + f" plan GEGLU{plan_label(plan.geglu)}; ff.net.2"
                      + plan_label(plan.net2) + f"; grid {plan.grid}",
                      lambda a=args, kw=kw: qmatmul.geglu_out_qmatmul(*a,
                                                                     **kw),
                      lambda a=args, kw=kw:
                          qmatmul.geglu_out_qmatmul_plain(*a, **kw),
                      float_err,
                      M * C * (2 if ln else 3) + 3 * C * H + 2 * M * C
                      + 12 * H + 20 * C,
                      [(4 * M * C * H + 2 * M * H * C, INT8_OPS_PER_S),
                       (8 * M * C if ln else 0, F32_OPS_PER_S)], None))
    # SDXL 1024: flash at attn1 of the 64x64 level (T=4096, 10 heads),
    # sec_attention at attn1 of the 32x32 level (T=1024, C=1280) and attn2
    # of the 64x64 level (Tq=4096, Tk=77, C=640), sec_attention_q at attn2
    # of the 32x32 level; each at B=1 and B=2
    for B in (1, 2):
        T, heads, d = 4096, 10, 64
        C = heads * d
        srcs, kw = attn_case(torch, g, dev, B, T, T, heads, d, bf16, False)

        def sdpa(y=srcs[0], shape=(B, T, 3, heads, d)):
            qkv = y.view(shape).permute(2, 0, 3, 1, 4)
            return torch.nn.functional.scaled_dot_product_attention(
                qkv[0], qkv[1], qkv[2], scale=shape[-1] ** -0.5)
        cases.append(("flash_attention", f"B={B} T={T} heads={heads} d={d}",
                      lambda a=srcs, kw=kw: attention.flash_attention(*a,
                                                                     **kw),
                      lambda a=srcs, kw=kw:
                          attention.flash_attention_plain(*a, **kw),
                      flash_err, 8 * B * T * C,
                      [(4 * B * T * T * C, BF16_OPS_PER_S)], sdpa))
    # int8 flash at the same sites: the kernels on the codes and scales
    # that the wrappers' quantize (plain PyTorch ops) makes
    for name in ("int8_flash_attention", "int8qkv_flash_attention"):
        for B in (1, 2):
            T, heads, d = 4096, 10, 64
            C = heads * d
            srcs, kw = attn_case(torch, g, dev, B, T, T, heads, d, bf16, False)
            qkv = name.startswith("int8qkv")
            qi, ki, vi, s_qk, sv = attention._int8_operands(
                *srcs, heads, d, 0, C, 2 * C, qkv)
            args = (qi, ki, vi if qkv else srcs[2], s_qk * d ** -0.5, sv)
            ckw = dict(heads=heads, head_dim=d, v_off=0 if qkv else 2 * C,
                       out_dtype=bf16)
            matmuls = ([(4 * B * T * T * C, INT8_OPS_PER_S)] if qkv else
                       [(2 * B * T * T * C, INT8_OPS_PER_S),
                        (2 * B * T * T * C, BF16_OPS_PER_S)])
            plan = attention.int8_flash_plan(d, qkv)
            tiles = B * heads * -(-T // plan.rows)
            cases.append((name, f"B={B} T={T} heads={heads} d={d} on codes"
                          f" plan {plan.rows}-row blocks, {plan.stages}x"
                          f"{plan.stage_keys}-key ring, {plan.blocks_per_sm}"
                          f"/SM, {tiles / (plan.blocks_per_sm * sms):.2f} "
                          "waves",
                          lambda a=args, kw=ckw:
                              attention.int8_flash_codes(*a, **kw),
                          lambda a=args, kw=ckw:
                              attention.int8_flash_codes_plain(*a, **kw),
                          flash_err, B * T * C * (5 if qkv else 6), matmuls,
                          None))
    for B in (1, 2):
        for Tq, Tk, heads, cross in [(1024, 1024, 20, False),
                                     (4096, 77, 10, True)]:
            C = heads * 64
            srcs, kw = attn_case(torch, g, dev, B, Tq, Tk, heads, 64, bf16,
                                 cross)
            args = (*srcs, 40.0, -3.0)
            nbytes = (2 * B * Tq * C + 4 * B * Tk * C + B * Tq * C if cross
                      else 6 * B * Tq * C + B * Tq * C)
            cases.append(("sec_attention",
                          f"B={B} Tq={Tq} Tk={Tk} C={C} heads={heads} "
                          + ("cross" if cross else "self"),
                          lambda a=args, kw=kw:
                              sec_attention.sec_attention(*a, **kw),
                          lambda a=args, kw=kw:
                              sec_attention.sec_attention_plain(*a, **kw),
                          codes_err, nbytes,
                          [(4 * B * Tq * Tk * C, BF16_OPS_PER_S)], None))
    for B in (1, 2):
        Tq, heads, C = 1024, 20, 1280
        args, kw = sec_q_case(torch, g, dev, B, Tq, 77, heads, 64, C, bf16)
        cases.append(("sec_attention_q",
                      f"B={B} Tq={Tq} Tk=77 C_in=C={C} heads={heads}",
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q(*a, **kw),
                      lambda a=args, kw=kw:
                          sec_attention.sec_attention_q_plain(*a, **kw),
                      codes_err,
                      2 * B * Tq * C + C * C + 8 * C + 4 * B * 77 * C,
                      [(2 * B * Tq * C * C, INT8_OPS_PER_S),
                       (4 * B * Tq * 77 * C, BF16_OPS_PER_S)], None, None,
                      None, sec_gemms_exact(torch, "sec_attention_q", args,
                                            kw)))
    # the weight-only step: ff.net.0.proj at 32x32, ff.net.2 at 16x16,
    # attn2 to_k/to_v at 16x16, time_emb_proj, a ragged N, and a K that is
    # no multiple of the split-K plan's ranges; library: torch.matmul on
    # the weight dequantized to bf16 beforehand. The label carries the
    # kernel's plan (wq_plan) on this card.
    for w4 in (True, False):
        for M, K, N in [(1024, 640, 5120), (256, 5120, 1280),
                        (77, 2048, 1280), (1, 1280, 1280), (77, 2048, 1000),
                        (77, 2056, 1280)]:
            plan = wq_matmul.wq_plan(M, K, N, w4, sms)
            x = randn(M, K, dtype=bf16)
            lim = 8 if w4 else 128
            w = torch.randint(-lim, lim, (K, N), generator=g, device=dev,
                              dtype=torch.int8)
            s = (torch.rand(N, generator=g, device=dev) + 0.5) / (
                lim * K ** 0.5)
            w_dq = wq_matmul.dequant_bf16(w, s)
            if w4:
                args, name = (x, wq_matmul.pack_w4_halves(w), s), "wq4_matmul"
                fn, plain = wq_matmul.wq4_matmul, wq_matmul.wq4_matmul_plain
            else:
                args, name = (x, w, s), "wq_matmul"
                fn, plain = wq_matmul.wq_matmul, wq_matmul.wq_matmul_plain
            cases.append((
                name, f"M={M} K={K} N={N} plan {plan.tm}x{plan.tn} tiles, "
                f"{plan.splits} split(s) of {plan.split_rows} rows",
                lambda f=fn, a=args: f(*a),
                lambda f=plain, a=args: f(*a), wq_err,
                2 * M * K + K * N // (2 if w4 else 1) + 4 * N + 2 * M * N,
                [(2 * M * K * N, BF16_OPS_PER_S), (K * N, F32_OPS_PER_S)],
                lambda x=x, w=w_dq: torch.matmul(x, w)))
    return cases + sd15_kernel_cases(torch, dev)


#: SD1.5's attention shapes (B, Tq, Tk, heads, d): its flash site under
#: ``'auto'`` (attn1 at 64x64), then the shapes of explicit
#: ``attn_impl='flash'`` at 32x32 and 16x16 (self) and 16x16 (cross)
SD15_ATTN = ((1, 4096, 4096, 8, 40), (1, 1024, 1024, 8, 80),
             (1, 256, 256, 8, 160), (1, 256, 77, 8, 160))


def sd15_kernel_cases(torch, dev):
    """Phase 1's cases at the shapes SD1.5 512 gives the kernels and SDXL
    never did: the three flash kernels at heads of 40 / 80 / 160
    (``SD15_ATTN``; library: ``scaled_dot_product_attention`` on the same
    q/k/v beside ``flash_attention``, the bf16 comparison of the int8
    ones at the same shape), and the int8 GEMM, conv
    and LayerNorm shapes of its UNet step (an 8x8 level, K = 320 and 768,
    1x1 ``proj_in`` / ``proj_out``). Case tuples as ``kernel_cases``."""
    from mixdq_tpu_torch.ops import attention, ln_quant, qconv, qmatmul

    g = torch.Generator(device=dev).manual_seed(19)
    bf16 = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = []
    for B, Tq, Tk, heads, d in SD15_ATTN:
        C, cross = heads * d, Tq != Tk
        srcs, kw = attn_case(torch, g, dev, B, Tq, Tk, heads, d, bf16, cross)
        offs = (kw["q_off"], kw["k_off"], kw["v_off"])
        label = (f"B={B} Tq={Tq} Tk={Tk} heads={heads} d={d} "
                 + ("cross" if cross else "self"))

        def sdpa(s=srcs, o=offs, shape=(B, heads, d)):
            def heads_major(t, off):
                return t[..., off:off + shape[1] * shape[2]].unflatten(
                    -1, shape[1:]).transpose(1, 2)
            return torch.nn.functional.scaled_dot_product_attention(
                heads_major(s[0], o[0]), heads_major(s[1], o[1]),
                heads_major(s[2], o[2]), scale=shape[2] ** -0.5)
        cases.append(("flash_attention", label,
                      lambda a=srcs, kw=kw: attention.flash_attention(*a,
                                                                     **kw),
                      lambda a=srcs, kw=kw:
                          attention.flash_attention_plain(*a, **kw),
                      flash_err, 4 * B * (Tq + Tk) * C,
                      [(4 * B * Tq * Tk * C, BF16_OPS_PER_S)], sdpa))
        for name in ("int8_flash_attention", "int8qkv_flash_attention"):
            qkv = name.startswith("int8qkv")
            qi, ki, vi, s_qk, sv = attention._int8_operands(
                *srcs, heads, d, *offs, qkv)
            args = (qi, ki, vi if qkv else srcs[2], s_qk * d ** -0.5, sv)
            ckw = dict(heads=heads, head_dim=d, v_off=0 if qkv else offs[2],
                       out_dtype=bf16)
            plan = attention.int8_flash_plan(d, qkv)
            tiles = B * heads * -(-Tq // plan.rows)
            cases.append((
                name, f"{label} on codes plan {plan.blocks_per_sm}/SM, "
                f"{tiles / (plan.blocks_per_sm * sms):.2f} waves",
                lambda a=args, kw=ckw: attention.int8_flash_codes(*a, **kw),
                lambda a=args, kw=ckw:
                    attention.int8_flash_codes_plain(*a, **kw),
                flash_err, B * (3 * Tq + (2 if qkv else 3) * Tk) * C,
                [(4 * B * Tq * Tk * C, INT8_OPS_PER_S)] if qkv else
                [(2 * B * Tq * Tk * C, INT8_OPS_PER_S),
                 (2 * B * Tq * Tk * C, BF16_OPS_PER_S)], None))
    # the 8x8 level's resnets (2560 -> 1280 with temb and residual, 1280
    # -> 1280) and the last downsampler (16x16 -> 8x8 at 1280)
    for name, stride, H, C, K, epi in [
            ("qconv2d", 1, 8, 2560, 1280, True),
            ("qconv2d", 1, 8, 1280, 1280, True),
            ("qconv2d_s2", 2, 16, 1280, 1280, False)]:
        x, w = codes(1, H, H, C), codes(3, 3, C, K)
        scale = (torch.rand(K, generator=g, device=dev) + 0.5) * 1e-4
        bias0 = -3.0 * w.int().sum((0, 1, 2)).float()
        P = H // stride
        kw = dict(bias=randn(K, dtype=bf16),
                  extra_bias=randn(1, K, dtype=bf16) if epi else None,
                  residual=randn(1, P, P, K, dtype=bf16) if epi else None)
        fn = qconv.qconv2d if stride == 1 else qconv.qconv2d_s2
        cases.append((
            name, f"{C}->{K} @{H}x{H}" + (" +temb+res" if epi else ""),
            lambda fn=fn, a=(x, w, scale, bias0), kw=kw: fn(*a, -3.0, **kw),
            lambda s=stride, a=(x, w, scale, bias0), kw=kw:
                qconv.qconv2d_plain(*a, -3.0, stride=s, **kw),
            exact_err, H * H * C + 2 * P * P * K * (2 if epi else 1)
            + 9 * C * K, [(2 * P * P * K * 9 * C, INT8_OPS_PER_S)], None))
    for shape in [(1, 4096, 320), (1, 64, 1280)]:
        C = shape[-1]
        x = randn(*shape, dtype=bf16) * 3
        args = (x, torch.rand(C, generator=g, device=dev) + 0.5, randn(C),
                20.0, 3.0)
        n = x.numel()
        cases.append(("ln_quantize", str(list(shape)),
                      lambda a=args: ln_quant.ln_quantize(*a),
                      lambda a=args: ln_quant.ln_quantize_plain(*a),
                      codes_err, 3 * n, [(8 * n, F32_OPS_PER_S)], None))
    for M, K, H in [(4096, 320, 1280), (64, 1280, 5120)]:
        x, w = codes(M, K), codes(K, 2 * H)
        scale = (torch.rand(2 * H, generator=g, device=dev) + 0.5) * 2e-5
        bias0 = 5.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, 25.0, 4.0, randn(2 * H, dtype=bf16))
        cases.append(("geglu_qmatmul", f"M={M} K={K} 2H={2 * H}",
                      lambda a=args: qmatmul.geglu_qmatmul(*a),
                      lambda a=args: qmatmul.geglu_qmatmul_plain(*a),
                      codes_err, M * K + 2 * K * H + M * H,
                      [(4 * M * K * H, INT8_OPS_PER_S)], None))
    # to_qkv, ff.net.2 and the 1x1 proj_in / proj_out at 64x64, to_kv on
    # the 768-wide text, to_qkv at 8x8
    for M, K, N in [(4096, 320, 960), (4096, 1280, 320), (4096, 320, 320),
                    (77, 768, 640), (64, 1280, 3840)]:
        x, w = codes(M, K), codes(K, N)
        scale = (torch.rand(N, generator=g, device=dev) + 0.5) * 1e-5
        bias0 = -9.0 * w.int().sum(0).float()
        args = (x, w, scale, bias0, randn(N, dtype=bf16))
        cases.append(("qmatmul", f"M={M} K={K} N={N}"
                      + f" {qmatmul.qmm_plan(M, K, N, sms).splits} split(s)",
                      lambda a=args: qmatmul.qmatmul(*a),
                      lambda a=args: qmatmul.qmatmul_plain(*a),
                      exact_err, M * K + K * N + 10 * N + 2 * M * N,
                      [(2 * M * K * N, INT8_OPS_PER_S)],
                      lambda x=x, w=w: torch._int_mm(x, w)))
    return cases


def wq_err(torch, got, want):
    """A weight-only GEMM against its plain version: max |diff| <= 2 bf16
    ulps of max |want| (the same bf16 products summed in f32 in other
    orders, then rounded to bf16) and |diff| / |want| <= 1e-2."""
    return flash_err(torch, got, want)


def flash_err(torch, got, want):
    """Flash attention's bf16 output against its plain version at the same
    key blocks: max |diff| <= 2 bf16 ulps of max |want| (the two sum in
    other orders, so an element or a rounded ``p`` may land one ulp
    apart) and |diff| / |want| <= 1e-2 (dropping the last 64 keys moves
    it by several per cent)."""
    got, want = got.float(), want.float()
    d = got - want
    err = d.abs().max().item()
    tol = 2 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    rel = (d.norm() / want.norm()).item()
    if not (err <= tol and rel <= 1e-2):
        raise AssertionError(f"max |diff| {err} (limit {tol}), |diff|/|ref| "
                             f"{rel} (limit 1e-2)")
    return err


def attn_case(torch, g, dev, B, Tq, Tk, heads, d, dtype, cross):
    """q/k/v sources of one attention site, about unit size: self, the
    fused to_qkv output ``[B, T, 3C]`` at 0/C/2C; cross, q ``[B, Tq, C]``
    and a fused to_kv output ``[B, Tk, 2C]`` at 0/C whose first (BoS) row
    is twice the others. Returns (sources, kwargs)."""
    C = heads * d

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5)
    if not cross:
        y = (randn(B, Tq, 3 * C) * 1.5).to(dtype)
        return (y, y, y), dict(kw, q_off=0, k_off=C, v_off=2 * C)
    y = randn(B, Tk, 2 * C)
    y[:, 0] *= 2
    y = y.to(dtype)
    return ((randn(B, Tq, C) * 1.5).to(dtype), y, y), dict(
        kw, q_off=0, k_off=0, v_off=C)


def sec_q_case(torch, g, dev, B, Tq, Tk, heads, d, C_in, dtype):
    """Inputs of ``sec_attention_q`` at one attn2 site: to_q codes, a to_q
    weight whose q comes out about unit size, and a fused to_kv output
    with a BoS-like first row; returns (args, kwargs)."""
    C = heads * d
    x = torch.randint(-128, 128, (B, Tq, C_in), generator=g, device=dev,
                      dtype=torch.int8)
    wq = torch.randint(-128, 128, (C_in, C), generator=g, device=dev,
                       dtype=torch.int8)
    sq = (torch.rand(C, generator=g, device=dev) + 0.5) / (3000.0
                                                            * C_in ** 0.5)
    y = torch.randn((B, Tk, 2 * C), generator=g, device=dev)
    y[:, 0] *= 2
    args = (x, wq, sq, 3.0 * wq.int().sum(0).float(), y.to(dtype),
            y.to(dtype), 40.0, -2.0)
    return args, dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0,
                      v_off=C)


def qkv_case(torch, g, dev, B, T, heads, d):
    """Inputs of ``sec_attention_qkv``: random codes, a fused QKV weight
    whose q/k/v come out about unit size (random codes sum to ~5500
    sqrt(C)), so the softmax is not one-hot; returns (args, kwargs)."""
    C = heads * d
    x = torch.randint(-128, 128, (B, T, C), generator=g, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (C, 3 * C), generator=g, device=dev,
                      dtype=torch.int8)
    scale = (torch.rand(3 * C, generator=g, device=dev) + 0.5) / (
        5500.0 * C ** 0.5)
    args = (x, w, scale, 4.0 * w.int().sum(0).float(), 200.0, -3.0)
    return args, dict(heads=heads, head_dim=d, scale=d ** -0.5)


def q_out_case(torch, g, dev, B, Tq, Tk, heads, d, C_in, dtype, ln):
    """Inputs of ``sec_attention_q_out`` at one attn2 site: the raw stream
    (LN-folded) or to_q codes + a residual, a fused to_kv output ``y``
    ``[B, Tk, 2C]`` with a BoS-like first row, weights and constants, at
    sizes where |out| < 2 (one bf16 ulp within the float tolerance);
    returns (args, kwargs)."""
    C = heads * d

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    wq, wout = codes(C_in, C), codes(C, C_in)
    sq = (rand(C) + 0.5) / (3000.0 * C_in ** 0.5)
    so = (rand(C_in) + 0.5) * 2e-6
    y = randn(B, Tk, 2 * C)
    y[:, 0] *= 8
    stream = (randn(B, Tq, C_in) * 0.25).to(dtype)
    if ln:
        x, residual = stream, None
        fold = (rand(C_in) + 0.5, randn(C_in) * 0.2, 25.0, 2.0,
                (-128.0, 127.0), 1e-5)
    else:
        x, residual, fold = codes(B, Tq, C_in), stream, None
    args = (x, wq, sq, 3.0 * wq.int().sum(0).float(), y.to(dtype),
            y.to(dtype), 100.0, -2.0, wout, so,
            -6.0 * wout.int().sum(0).float(), (randn(C_in) * 0.1).to(dtype),
            residual)
    kw = dict(heads=heads, head_dim=d, scale=d ** -0.5, k_off=0, v_off=C,
              out_dtype=dtype, ln=fold)
    return args, kw


def qkv_out_case(torch, g, dev, B, T, heads, d, dtype, ln):
    """Inputs of ``sec_attention_qkv_out`` at one attn1 site: the raw stream
    (LN-folded) or the to_qkv codes + a residual, ``qkv_case``'s fused QKV
    weight, a to_out weight and constants at sizes where |out| < 2;
    returns (args, kwargs)."""
    C = heads * d
    (codes, w, scale, bias0, _, _), kw = qkv_case(torch, g, dev, B, T, heads,
                                                  d)
    wout = torch.randint(-128, 128, (C, C), generator=g, device=dev,
                         dtype=torch.int8)
    so = (torch.rand(C, generator=g, device=dev) + 0.5) * 2e-6
    stream = (torch.randn((B, T, C), generator=g, device=dev) * 0.25).to(
        dtype)
    fold = None
    if ln:
        fold = (torch.rand(C, generator=g, device=dev) + 0.5,
                torch.randn(C, generator=g, device=dev) * 0.2, 25.0, 2.0,
                (-128.0, 127.0), 1e-5)
    args = (stream if ln else codes, w, scale, bias0, 200.0, -3.0, wout, so,
            -6.0 * wout.int().sum(0).float(),
            (torch.randn(C, generator=g, device=dev) * 0.1).to(dtype),
            None if ln else stream)
    return args, dict(kw, out_dtype=dtype, ln=fold)


def geglu_out_case(torch, g, dev, M, K, H, C, dtype, ln):
    """Inputs of ``geglu_out_qmatmul`` at one ff site: the raw stream [M, K]
    (LN-folded, K == C) or proj codes + a residual, weights whose gate
    input and output stay a few units, constants; returns (args,
    kwargs)."""
    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    w, w2 = codes(K, 2 * H), codes(H, C)
    stream = (torch.randn((M, C), generator=g, device=dev) * 0.25).to(dtype)
    fold = ((rand(K) + 0.5, torch.randn(K, generator=g, device=dev) * 0.2,
             25.0, 2.0, (-128.0, 127.0), 1e-5) if ln else None)
    args = (stream if ln else codes(M, K), w,
            (rand(2 * H) + 0.5) / (2500.0 * K ** 0.5),
            5.0 * w.int().sum(0).float(), 25.0, 4.0, w2,
            (rand(C) + 0.5) / (4e4 * H ** 0.5),
            -4.0 * w2.int().sum(0).float())
    kw = dict(bias=torch.randn(2 * H, generator=g, device=dev) * 0.3,
              out_bias=(torch.randn(C, generator=g, device=dev) * 0.1).to(
                  dtype),
              residual=None if ln else stream, out_dtype=dtype, ln=fold)
    return args, kw


def phase_kernels(torch, dev, flush):
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.configs import get_family

    per_step = {
        f"{f}{tag}": pipeline.expected_kernel_calls(get_family(f).unet, "auto",
                                                    **kw)
        for f, tag, kw in (("sdxl-turbo", "", {}), ("sdxl", "", {}),
                           ("sdxl-turbo", " all", OUTFUSE_PATHS["all"]),
                           ("sdxl", " qk", dict(int8_flash="qk")),
                           ("sdxl", " qkv", dict(int8_flash="qkv")),
                           ("sd15", "", {}),
                           ("sd15", " qk", dict(int8_flash="qk")),
                           ("sd15", " qkv", dict(int8_flash="qkv")))}
    report = {}
    for name, label, fn, plain, cmp, nbytes, ops, lib, *more in \
            kernel_cases(torch, dev):
        # qmatmul and the fused GEMMs: w K-major; the fused GEMMs: the
        # act-quantize then qmatmul; the cooperative sec_attention*
        # kernels: their GEMM stages bit for bit
        lib_kmajor, chain, gemms = (list(more) + [None] * 3)[:3]
        got = fn()
        want = plain()
        torch.cuda.synchronize()
        err = cmp(torch, got, want)
        k_ms = time_ms(torch, fn, 20, flush)
        p_ms = time_ms(torch, plain, 3, flush)
        l_ms, lk_ms, c_ms = (None if f is None else time_ms(torch, f, 20,
                                                            flush)
                             for f in (lib, lib_kmajor, chain))
        b_ms, b_by = bound(nbytes, ops)
        split = None if gemms is None else stage_split(torch, fn, flush,
                                                       gemms)
        log(f"kernel {name} [{label}]: max_abs_err={err} kernel_ms={k_ms:.4f}"
            f" plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by})"
            f" library_ms={'null' if l_ms is None else f'{l_ms:.4f}'}"
            + ("" if lk_ms is None else f" library_kmajor_ms={lk_ms:.4f}")
            + ("" if c_ms is None else f" quantize_qmatmul_ms={c_ms:.4f}")
            + f" launches/step {({p: c[name] for p, c in per_step.items()})}"
            + ("" if split is None else " stages_ms " + " ".join(
                f"{k}={v:.4f}" for k, v in split.items())))
        r = report.setdefault(name, {"max_abs_err": 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"].append(dict(shape=label, ms=k_ms, plain_ms=p_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=l_ms, library_kmajor_ms=lk_ms,
                                quantize_qmatmul_ms=c_ms, stages_ms=split))
    return report


def launch_floor_ms(torch, dev, flush):
    """Device ms of one launch of an empty kernel of one warp
    (``csrc/ln_quant.cu:empty_kernel``, built with the others), timed as
    phase 1 times a kernel: what a launch costs whatever its work."""
    from mixdq_tpu_torch.ops import _build

    lib = _build.load("ln_quant.cu")
    f = lib.mixdq_empty_launch
    f.argtypes, f.restype = [_build.P], _build.I
    stream = _build.stream(dev)
    return time_ms(torch, lambda: _build.check(lib, f(stream), "empty_kernel"),
                   20, flush)


def sec_gemms_exact(torch, name, args, kw):
    """A check of a cooperative ``sec_attention*`` call's GEMM stages on
    its probed record (``sec_attention.probe``): the projection workspace
    and the whole-block output against their plain products on the
    kernel's own codes (the LN codes it wrote, its to_out codes), equal
    bit for bit (exact int32 sums, the same f32 steps)."""
    from mixdq_tpu_torch.ops import sec_attention as sa

    fused = name in ("sec_attention_qkv", "sec_attention_qkv_out")
    q_dtype = torch.bfloat16 if fused else args[4].dtype

    def check(rec):
        exact_err(torch, rec["proj"],
                  sa._proj_plain(rec["codes"], *args[1:4], q_dtype))
        if rec["out"] is not None:
            wout, so, b0o, bo, residual = args[-5:]
            res = args[0] if kw.get("ln") is not None else residual
            exact_err(torch, rec["out"], sa._out_proj_plain(
                rec["o"], wout, so, b0o, bo, res, kw["out_dtype"]))
    return check


def stage_split(torch, fn, flush, check):
    """Device ms of each stage of a cooperative ``sec_attention*`` call
    (``sec_attention.probe``: block 0's global timer after each grid
    sync, one more sync closing the last stage), the mean of
    ``SPLIT_ITERS`` calls each after a flush; ``check`` (a
    ``sec_gemms_exact`` check) runs on each call's record."""
    from mixdq_tpu_torch.ops import sec_attention

    total = dict.fromkeys(sec_attention.STAGES, 0.0)
    for _ in range(SPLIT_ITERS):
        flush.zero_()
        with sec_attention.probe() as recs:
            fn()
        torch.cuda.synchronize()
        check(recs[0])
        for k, v in sec_attention.stage_ms(recs[0]).items():
            total[k] += v / SPLIT_ITERS
    return total


def graph_structure(torch, fn):
    """``fn`` captured into a CUDA graph kept for inspection, read through
    the CUDA runtime that torch loaded: (the cooperative flag of each
    kernel node, the type of each edge: 0 plain stream order, 1
    programmatic)."""
    import ctypes

    from mixdq_tpu_torch.pipelines.graphed import capture

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with capture(g):
        fn()
    raw = ctypes.c_void_p(g.raw_cuda_graph())
    with open("/proc/self/maps") as f:
        path = next(line.split()[-1] for line in f if "libcudart" in line)
    rt = ctypes.CDLL(path)

    def ok(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: CUDA error {err}")

    n = ctypes.c_size_t(0)
    ok(rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)), "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)), "cudaGraphGetNodes")
    coop = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cudaGraphNodeGetType")
        if kind.value == 0:  # cudaGraphNodeTypeKernel
            value = (ctypes.c_ubyte * 64)()  # cudaLaunchAttributeValue
            ok(rt.cudaGraphKernelNodeGetAttribute(
                ctypes.c_void_p(node), 2, value),  # ...AttributeCooperative
               "cudaGraphKernelNodeGetAttribute")
            coop.append(int.from_bytes(bytes(value[:4]), "little"))

    class EdgeData(ctypes.Structure):  # cudaGraphEdgeData
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    m = ctypes.c_size_t(0)
    ok(rt.cudaGraphGetEdges_v2(raw, None, None, None, ctypes.byref(m)),
       "cudaGraphGetEdges_v2")
    if m.value == 0:
        return coop, []
    src, dst = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)()
    data = (EdgeData * m.value)()
    ok(rt.cudaGraphGetEdges_v2(raw, src, dst, data, ctypes.byref(m)),
       "cudaGraphGetEdges_v2")
    return coop, [e.type for e in data]


def capture_report(torch, dev):
    """How the port's special launches capture into a CUDA graph:
    ``gn_silu_quantize``'s programmatic dependent launches (the edge
    types between its three kernel nodes, and its ms a call in a graph of
    ``CAPTURE_CALLS`` calls against as many eager calls) and the
    cooperative ``sec_attention_qkv`` and ``geglu_out_qmatmul`` (their
    kernel nodes' cooperative flag). Every capture replays bit for bit
    elsewhere (``graphed_step_ms``, the card tests)."""
    from mixdq_tpu_torch.ops import gn_quant, qmatmul
    from mixdq_tpu_torch.ops import sec_attention as sa
    from mixdq_tpu_torch.pipelines.graphed import capture

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1, 64, 64, 320), generator=g, device=dev).to(
        torch.bfloat16)
    gam = torch.rand(320, generator=g, device=dev) + 0.5
    bet = torch.randn(320, generator=g, device=dev)

    def gn():
        return gn_quant.gn_silu_quantize(x, gam, bet, 30.0, -5.0, 32, 1e-5,
                                         True)

    coop, edges = graph_structure(torch, gn)
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
        for _ in range(CAPTURE_CALLS):
            gn()
    graph.replay()
    in_graph = step_ms(torch, graph.replay) / CAPTURE_CALLS

    def eager():
        for _ in range(CAPTURE_CALLS):
            gn()

    eager()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_COVER_CYCLES)
    eager_ms = step_ms(torch, eager) / CAPTURE_CALLS
    log(f"capture: gn_silu_quantize [1,64,64,320]: {len(coop)} kernel nodes,"
        f" edge types {edges} (1: programmatic, 0: stream order); "
        f"{in_graph:.4f} ms a call in a graph of {CAPTURE_CALLS} calls, "
        f"{eager_ms:.4f} ms eager")
    args, kw = qkv_case(torch, g, dev, 1, 1024, 10, 64)
    coop_qkv, _ = graph_structure(torch, lambda: sa.sec_attention_qkv(*args,
                                                                       **kw))
    args, kw = geglu_out_case(torch, g, dev, 1024, 640, 2560, 640,
                              torch.bfloat16, True)
    coop_ff, _ = graph_structure(
        torch, lambda: qmatmul.geglu_out_qmatmul(*args, **kw))
    log(f"capture: cooperative flags of the kernel nodes: sec_attention_qkv "
        f"T=1024 C=640 {coop_qkv}, geglu_out_qmatmul M=1024 {coop_ff} "
        "(cudaLaunchCooperativeKernel as it is)")


def fused_one_kernel(torch, dev):
    """Each fused act-quantize GEMM at M=1024 K=5120 N=1280 (bf16 x, as
    the kernel benchmark gives it) under torch.profiler: exactly one
    device kernel per call, its own (no quantize, cast, reduce or memset
    kernel beside it)."""
    from torch.profiler import ProfilerActivity, profile

    from mixdq_tpu_torch.ops import qmatmul

    g = torch.Generator(device=dev).manual_seed(1)
    M, K, N = 1024, 5120, 1280
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    args = (x, w, 10.0, -3.0, torch.full((N,), 1e-5, device=dev),
            -3.0 * w.int().sum(0).float())
    for name in ("qmatmul_fused", "qmatmul_fused2"):
        fn = getattr(qmatmul, name)
        fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(FUSED_PROFILE_CALLS):
                fn(*args)
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and (getattr(e, "device_time_total", None)
                        or getattr(e, "cuda_time_total", 0))}
        log(f"profile {name} M={M} K={K} N={N}, {FUSED_PROFILE_CALLS} "
            f"calls: device kernels {kernels}")
        if (len(kernels) != 1
                or list(kernels.values()) != [FUSED_PROFILE_CALLS]
                or f"{name}_kernel" not in next(iter(kernels))):
            raise AssertionError(f"{name}: expected one {name}_kernel per "
                                 f"call, profiled {kernels}")


def to_device(qparams, dev):
    return {n: qp.replace(**{k: (None if v is None else v.to(dev))
                             for k, v in vars(qp).items()})
            for n, qp in qparams.items()}


def phase_tiny_parity(torch, dev):
    """Whole W8A8 step of ``tiny-sdxl`` and ``small-sdxl`` under each
    ``attn_impl``, and of ``small-sdxl`` with every site out-fused (LN
    folded and not): GPU kernels vs CPU plain versions."""
    import dataclasses

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.models import routing
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    f32 = torch.float32
    paths = [("einsum", dict(attn_impl="einsum")),
             ("auto", dict(attn_impl="auto"))]
    for label in ("tiny-sdxl", "small-sd15", "small-sdxl"):
        cpu_m = pipeline.build_unet(label, 0, f32, "cpu")
        gpu_m = pipeline.build_unet(label, 0, f32, dev)
        gpu_m.load_state_dict(cpu_m.state_dict())
        inp = pipeline.example_inputs(label, 1, 0, f32, "cpu")
        inp_gpu = tuple(x.to(dev) if torch.is_tensor(x) else
                        None if x is None else
                        {k: v.to(dev) for k, v in x.items()} for x in inp)
        qp = calibrate(cpu_m, [inp], pipeline.WQ, pipeline.AQ)
        ctrl = uniform_ctrl(list(quantizable_layers(cpu_m)))
        cpu_ctx = deploy_unet_ctx(cpu_m, qp, ctrl, pipeline.WQ, fuse_qkv=True)
        gpu_ctx = deploy_unet_ctx(gpu_m, to_device(qp, dev), ctrl,
                                  pipeline.WQ, fuse_qkv=True)
        if label == "small-sdxl":
            paths += [(f"auto outfuse {t}", dict(attn_impl="auto", **o))
                      for t, o in OUTFUSE_PATHS.items() if t != "none"]
        for impl, opts in paths:
            c_ctx = dataclasses.replace(cpu_ctx, **opts)
            g_ctx = dataclasses.replace(gpu_ctx, **opts)
            ref = pipeline.unet_step(cpu_m, inp, c_ctx)
            ops.reset_counts()
            got = pipeline.unet_step(gpu_m, inp_gpu, g_ctx).cpu()
            launches = ops.launch_counts()
            if launches != pipeline.ctx_kernel_calls(gpu_m.config, g_ctx):
                raise AssertionError(f"{label} {impl} launches {launches}")
            rel = ((got - ref).norm() / ref.norm()).item()
            mx = (got - ref).abs().max().item()
            log(f"{label} int8 step ({impl}) GPU vs CPU plain: rel={rel:.3e} "
                f"max={mx:.3e}; attention launches "
                f"{ {k: launches[k] for k in routing.KERNELS} }, "
                f"geglu_out_qmatmul {launches['geglu_out_qmatmul']}")
            if label == "small-sd15":
                # SD1.5's plain GroupNorm before each conv proj_in (as the
                # JAX package) sums in another order on each device; one
                # proj_in act code landing apart grows past the whole-step
                # tolerance, so each resnet and spatial transformer is held
                # alone, on its GPU-step input, at that tolerance
                held_modules(torch, gpu_m, cpu_m, inp_gpu, g_ctx, c_ctx,
                             f"{label} ({impl})")
            elif impl == "einsum" and not (math.isfinite(rel) and rel <= 1e-2
                                           and mx < 0.3):
                raise AssertionError(f"{label} parity ({impl}): rel {rel} "
                                     f"max {mx}")
            if impl == "einsum":
                continue
            # The attention kernels sum in another order than the CPU; one
            # act code that differs by one at one site can grow past the
            # whole-step tolerance in a small UNet. So each attention (and
            # out-fused feed-forward) module is held alone, on the input it
            # had in the GPU step.
            seen = record_attention_inputs(torch, gpu_m, inp_gpu, g_ctx,
                                           ff="outfuse" in impl)
            err = 0.0
            for name, (stream, ehs) in sorted(seen.items()):
                g = attention_site(torch, gpu_m, name, stream, ehs, g_ctx)
                c = attention_site(torch, cpu_m, name, stream.cpu(),
                                   None if ehs is None else ehs.cpu(), c_ctx)
                err = max(err, float_err(torch, g.cpu(), c))
            log(f"{label} ({impl}): {len(seen)} modules, each on its "
                f"GPU-step input, GPU vs CPU plain: max |d| {err:.3e}")


def held_modules(torch, gpu_m, cpu_m, inp_gpu, g_ctx, c_ctx, label):
    """Each resnet and spatial transformer of ``gpu_m``'s step under
    ``g_ctx`` on ``inp_gpu``, run again on the input it had there, on the
    GPU and (the plain versions) on the CPU under ``c_ctx``: |d|/|ref| <=
    1e-2 and max |d| < 0.3 each (the whole step's tolerance)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.attention import Transformer2DModel
    from mixdq_tpu_torch.models.resnet import ResnetBlock2D

    seen = {}

    def hook(mod, args, kwargs):
        seen[mod.qname] = (args[:2], kwargs.get("split", 0))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in gpu_m.modules()
               if isinstance(m, (ResnetBlock2D, Transformer2DModel))]
    try:
        pipeline.unet_step(gpu_m, inp_gpu, g_ctx)
    finally:
        for h in handles:
            h.remove()
    worst = (0.0, 0.0, "")
    with torch.inference_mode():
        for name, ((x, y), split) in sorted(seen.items()):
            kw = {} if split == 0 else dict(split=split)
            g = gpu_m.get_submodule(name)(x, y, g_ctx, **kw).cpu().float()
            c = cpu_m.get_submodule(name)(x.cpu(), y.cpu(), c_ctx,
                                          **kw).float()
            rel = ((g - c).norm() / c.norm()).item()
            mx = (g - c).abs().max().item()
            if not (math.isfinite(rel) and rel <= 1e-2 and mx < 0.3):
                raise AssertionError(f"{label}: module {name} GPU vs CPU "
                                     f"plain rel {rel} max {mx}")
            worst = max(worst, (rel, mx, name))
    log(f"{label}: {len(seen)} resnets and transformers, each on its "
        f"GPU-step input, GPU vs CPU plain: largest rel {worst[0]:.3e} "
        f"(max |d| {worst[1]:.3e}, {worst[2]})")


def sqnr_db(ref, got):
    ref, got = ref.float(), got.float()
    return 10 * math.log10((ref.pow(2).sum() / (ref - got).pow(2).sum()
                            ).item())


def fake_quant_layer(torch, m, x, kw, qp_w, qp_a, bos=False, w_bits=8,
                     a_bits=8):
    """What the deploy of layer ``m`` at ``w_bits`` / ``a_bits`` should
    give for its FP input ``x`` (call kwargs ``kw``), from the quantizers'
    definition in f32: the input as its dequantized ``a_bits`` act codes
    under ``qp_a`` (rounding ``x * (1 / delta)``, as the deploy does; the
    BoS token kept FP when ``bos``; the input itself for ``a_bits`` None,
    a weight-only layer), the weight as its dequantized codes under
    ``qp_w`` (2-bit deltas on the 4-bit code range, as the deploy stores
    them), then bias, ``extra_bias`` and ``residual``. Shares no code with
    the deploy path (fused scales, ``bias0``, packing, padded GEMMs,
    kernels). Returns (output, output without the residual)."""
    import torch.nn.functional as F

    from mixdq_tpu_torch.pipeline import WQ

    cb = WQ.candidate_bits
    xf = x.float()
    xq = xf
    if a_bits is not None:
        b = cb.index(a_bits)
        ad, az = qp_a.a_delta[b].float(), qp_a.a_zp[b].float()
        xq = ((xf * (1 / ad)).round() + az).clamp(0, 2 ** a_bits - 1).sub(
            az).mul(ad)
        if bos:
            xq[..., :1, :] = xf[..., :1, :]
    wd = qp_w.w_delta[cb.index(w_bits)].float()
    lim = 2 ** (max(w_bits, 4) - 1)
    w = (m.weight.float() / wd).round().clamp(-lim, lim - 1) * wd
    if w.ndim == 2:
        y = xq @ w
    else:
        y = F.conv2d(xq.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=m.strides, padding=m.padding).permute(0, 2, 3, 1)
    if m.bias is not None:
        y = y + m.bias.float()
    if kw.get("extra_bias") is not None:
        y = y + kw["extra_bias"].float()[:, None, None, :]
    if kw.get("residual") is None:
        return y, y
    return y + kw["residual"].float(), y


def record_layer_inputs(torch, unet, req):
    """{layer name: (input, call kwargs)} of every quantizable layer in
    one FP step."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import quantizable_layers

    seen = {}

    def hook(mod, args, kwargs):
        seen[mod.qname] = (args[0], kwargs)

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in quantizable_layers(unet).values()]
    try:
        pipeline.unet_step(unet, req)
    finally:
        for h in handles:
            h.remove()
    return seen


def layer_sqnrs(torch, unet, ctx, qparams, seen, names, bits=None):
    """SQNR in dB of each deploy entry in ``names``, run alone on the
    input its layer saw in the FP step, against ``fake_quant_layer`` at
    the layer's ``bits`` ({name: (w_bits, a_bits or None)}, default W8A8);
    the signal is the layer's own output (without a fused residual). Acts
    count as FP where the deploy's compute runs the entry weight-only. An
    entry with acts below 8 bits runs on that input doubled, so that its
    act clip takes effect. A fused QKV/KV entry runs as the attention runs
    it (anchor's codes, FP BoS row for cross-attention k/v); an
    ``ff.net.0.proj`` whose GEGLU kernel runs also runs it, whose codes
    must match the reference within one code."""
    import torch.nn.functional as F

    from mixdq_tpu_torch.models.attention import geglu_fusable
    from mixdq_tpu_torch.models.layers import (bos_row, deploy_linear,
                                               layer_compute)
    from mixdq_tpu_torch.pipeline import WQ
    from mixdq_tpu_torch.quant.state import quantizable_layers

    layers = quantizable_layers(unet)
    bits = bits or {}
    out = {}

    def act_bits(name, e):
        """The layer's act bits where ``ctx`` quantizes its acts, else
        None (weight-only)."""
        quantized = (not e.act_off and ctx.deploy_compute != "dequant"
                     if e.kind == "conv" else
                     layer_compute(ctx.deploy_compute, e) == "int8")
        return bits.get(name, (8, 8))[1] if quantized else None

    def stress(x, a_bits):
        return x * 2 if a_bits is not None and a_bits < 8 else x

    with torch.inference_mode():
        for name in names:
            e = ctx.deploy[name]
            prefix, _, leaf = name.rpartition(".")
            if leaf in ("to_qkv", "to_kv"):
                members = [f"{prefix}.{n}" for n in (
                    ("to_q", "to_k", "to_v") if leaf == "to_qkv"
                    else ("to_k", "to_v"))]
                a_bits = act_bits(members[0], e)
                x = stress(seen[members[0]][0], a_bits)
                bos = leaf == "to_kv" and ctx.bos_aware
                got = deploy_linear(x, e, layer_compute(ctx.deploy_compute, e),
                                    unet.dtype)
                if bos:
                    got = torch.cat([bos_row(x, e, unet.dtype),
                                     got[..., 1:, :]], -2)
                ref = torch.cat([fake_quant_layer(
                    torch, layers[n], x, {}, qparams[n], qparams[members[0]],
                    bos, bits.get(n, (8, 8))[0], a_bits)[0]
                    for n in members], -1)
                signal = ref
            else:
                m = layers[name]
                w_bits, a_bits = bits.get(name, (8, 8))[0], act_bits(name, e)
                x, kw = seen[name]
                x = stress(x, a_bits)
                got = m(x, ctx, **kw)
                # an unfused cross-attention k/v keeps its BoS row FP
                bos = (bool(kw.get("bos_aware")) and ctx.bos_aware
                       and a_bits is not None)
                ref, signal = fake_quant_layer(torch, m, x, kw, qparams[name],
                                               qparams[name], bos, w_bits,
                                               a_bits)
                consumer = name[:-len("0.proj")] + "2"
                if name.endswith(".ff.net.0.proj") and geglu_fusable(
                        ctx.deploy_compute, e, ctx.entry(consumer)):
                    c_bits = bits.get(consumer, (8, 8))[1]
                    b = WQ.candidate_bits.index(c_bits)
                    c_qp = qparams[consumer]
                    codes = m(x, ctx, geglu_out=ctx.entry(consumer))
                    h, g = ref.chunk(2, -1)
                    a = h * F.gelu(g, approximate=(
                        "tanh" if ctx.gelu == "tanh" else "none"))
                    want = ((a * (1 / c_qp.a_delta[b])).round()
                            + c_qp.a_zp[b]).clamp(0, 2 ** c_bits - 1) - (
                                2 ** (c_bits - 1))
                    codes_err(torch, codes, want, f"{name} GEGLU codes")
            err = (got.float() - ref).pow(2).sum().item()
            out[name] = (math.inf if err == 0 else 10 * math.log10(
                signal.pow(2).sum().item() / err))
    return out


def faulted_ctx(ctx, name):
    """``ctx`` with one fault in one layer: the second half of entry
    ``name``'s output channels (the value half of a fused ``to_kv``)
    dequantized with twice their scale, as if rebuilt against the wrong
    act params."""
    import dataclasses

    e = ctx.deploy[name]
    half = e.scale.shape[0] // 2
    scale = e.scale.clone()
    scale[half:] *= 2
    return dataclasses.replace(ctx, deploy={**ctx.deploy,
                                            name: e.replace(scale=scale)})


def nibble_swapped_ctx(ctx, name):
    """``ctx`` with the packed entry ``name``'s nibble halves swapped
    (rows k and k + K/2 of its weight exchanged)."""
    import dataclasses

    e = ctx.deploy[name]
    p = e.w_packed
    return dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: e.replace(w_packed=(p >> 4) | (p << 4))})


def a8_clip_ctx(ctx, name):
    """``ctx`` with the A4/A2 entry ``name``'s codes clipped at A8."""
    import dataclasses

    return dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: ctx.deploy[name].replace(a_bits=8)})


def resident_weight_bytes(unet, deploy):
    """(total, deploy) bytes of the weights a deploy keeps resident once
    the fp weights it replaces are pruned: every parameter the deploy does
    not replace, plus its entries' tensors (codes, packed codes, scales,
    ``bias0``, BoS weights or outputs)."""
    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()

    dep = sum(nbytes(getattr(e, f)) for e in deploy.values()
              for f in ("w_int", "w_packed", "scale", "bias0", "bos_w",
                        "bos_out"))
    fp = sum(nbytes(p) for n, p in unet.named_parameters()
             if not (n.endswith(".weight") and n[:-len(".weight")] in deploy))
    return fp + dep, dep


def step_peak_bytes(torch, unet, req, ctx):
    """``torch.cuda.max_memory_allocated`` over one step, and its rise
    above what was allocated before the step."""
    from mixdq_tpu_torch import pipeline

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    pipeline.unet_step(unet, req, ctx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return peak, peak - before


def phase_mixed(torch, unet, calib, requests, w8a8_ctx, qparams, seen,
                card):
    """The three mixed-precision SDXL-Turbo paths (W5.04 / A7.43 +
    act-protect, ``MP_CALLS``) on the phase 3 UNet and requests: launch
    counts (every packed entry on ``wq4_matmul``), SQNR against bf16
    (>= ``MP_SQNR_DB``), ``pallas_dequant`` against ``dequant`` (>=
    ``WONLY_SQNR_DB``, failed by one packed entry with its nibble halves
    swapped), every deploy entry against fake quantization at its bits
    (>= ``LAYER_SQNR_DB``, failed by the swapped nibbles and by an A4
    entry clipped at A8), every attention site of the mixed int8 deploy
    auto against einsum (>= ``SITE_SQNR_DB``, with zero-point faults at
    the ``sec_attention`` sites the protect list makes), paired step
    medians, resident weight bytes and peak memory, and one profiled step
    per path. Returns {path: launches}."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant import bitmaps
    from mixdq_tpu_torch.quant.deploy import layer_bits_from_ctrl
    from mixdq_tpu_torch.quant.state import (FP_CTX, apply_bitwidth_config,
                                             protect_layers,
                                             quantizable_layers,
                                             uniform_ctrl)

    wmap = bitmaps.load_bit_map(os.path.join(MP_DIR, "final_config",
                                             "weight", "5.04.yaml"))
    amap = bitmaps.load_bit_map(os.path.join(MP_DIR, "final_config", "act",
                                             "7.43.yaml"))
    protect = bitmaps.load_layer_list(os.path.join(MP_DIR,
                                                   "act_protect.yaml"))
    t0 = time.time()
    ctxs = {c: pipeline.quantize_mixed(unet, calib, wmap, amap, protect,
                                       deploy_compute=c) for c in MP_CALLS}
    torch.cuda.synchronize()
    log(f"sdxl-turbo mixed deploys (calibrate + deploy, x{len(ctxs)}): "
        f"{time.time() - t0:.1f}s, entries "
        f"{ {c: len(x.deploy) for c, x in ctxs.items()} }")
    ctrl = uniform_ctrl(list(quantizable_layers(unet)))
    ctrl = apply_bitwidth_config(ctrl, wmap, "weight")
    ctrl = apply_bitwidth_config(protect_layers(ctrl, protect), amap, "act")
    bits = layer_bits_from_ctrl(ctrl)
    labels = {c: MP_PATHS[c] for c in ctxs}
    for c, ctx in ctxs.items():
        if pipeline.expected_kernel_calls(
                unet.config, "auto", deploy=ctx.deploy,
                compute=c) != MP_CALLS[c]:
            raise AssertionError(f"{labels[c]}: the deploy's launch counts "
                                 "are not MP_CALLS")
    for ctx in ctxs.values():  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], ctx)
    outs, launches = {}, {}
    for c, ctx in ctxs.items():
        outs[c], launches[labels[c]] = run_path(torch, unet, requests, ctx,
                                                labels[c])
        packed = sum(e.w_packed is not None for e in ctx.deploy.values())
        if launches[labels[c]]["wq4_matmul"] != packed * len(requests):
            raise AssertionError(f"{labels[c]}: {packed} packed entries, "
                                 f"{launches[labels[c]]['wq4_matmul']} "
                                 "wq4_matmul launches")

    with wq_shape_counts() as counts:  # each shape's share of a step
        pipeline.unet_step(unet, requests[0], ctxs["pallas_dequant"])
    torch.cuda.synchronize()
    log(f"{labels['pallas_dequant']}: wq kernel calls in one step by "
        "(kernel, M, K, N): "
        + ", ".join(f"{k}={v}" for k, v in sorted(counts.items())))

    refs = [pipeline.unet_step(unet, r) for r in requests]
    sqnrs = {labels[c]: [] for c in ctxs}
    wonly = "pallas_dequant vs dequant"
    swapped = f"pallas_dequant, {MP_FAULT_PACKED} nibbles swapped, vs dequant"
    sqnrs.update({wonly: [], swapped: []})
    bad = nibble_swapped_ctx(ctxs["pallas_dequant"], MP_FAULT_PACKED)
    for i, (r, ref) in enumerate(zip(requests, refs)):
        for c in ctxs:
            x = outs[c][i]
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"{labels[c]}: bad output {x.shape}")
            sqnrs[labels[c]].append(sqnr_db(ref, x))
        sqnrs[wonly].append(sqnr_db(outs["dequant"][i],
                                    outs["pallas_dequant"][i]))
        sqnrs[swapped].append(sqnr_db(outs["dequant"][i],
                                      pipeline.unet_step(unet, r, bad)))
    for k, v in sqnrs.items():
        log(f"SQNR {k if 'vs' in k else k + ' vs bf16'} per request (dB): "
            f"{[round(x, 2) for x in v]}")
    if min(min(sqnrs[labels[c]]) for c in ctxs) < MP_SQNR_DB:
        raise AssertionError(f"mixed SQNR vs bf16 < {MP_SQNR_DB} dB")
    if min(sqnrs[wonly]) < WONLY_SQNR_DB:
        raise AssertionError(f"{wonly}: {sqnrs[wonly]} dB < {WONLY_SQNR_DB}")
    if max(sqnrs[swapped]) >= WONLY_SQNR_DB:
        raise AssertionError(f"the {WONLY_SQNR_DB} dB gate misses swapped "
                             f"nibbles: {sqnrs[swapped]}")

    # every entry against fake quantization at its bits, and the faults
    a4 = next(n for n, e in sorted(ctxs["int8_sec"].deploy.items())
              if e.kind == "linear" and e.a_bits == 4 and not e.act_off
              and not n.endswith(("to_qkv", "to_kv", ".ff.net.0.proj")))
    faults = {"pallas_dequant": (nibble_swapped_ctx, MP_FAULT_PACKED),
              "int8_sec": (a8_clip_ctx, a4)}
    for c, ctx in ctxs.items():
        names = [n for n, e in ctx.deploy.items() if e.kind != "fused_away"]
        s = layer_sqnrs(torch, unet, ctx, qparams, seen, names, bits)
        low = sorted(s.items(), key=lambda kv: kv[1])
        log(f"{labels[c]}: per-entry SQNR vs fake quantization over {len(s)}"
            f" entries (dB): min {low[0][1]:.2f} median "
            f"{statistics.median(s.values()):.2f}; lowest "
            f"{[(n, round(v, 2)) for n, v in low[:3]]}")
        for kind, test in (("weight-only", lambda e: e.act_off),
                           ("packed", lambda e: e.w_packed is not None),
                           ("A2/A4", lambda e: not e.act_off
                            and e.a_bits < 8)):
            v = [s[n] for n in names if test(ctx.deploy[n])]
            if v:
                log(f"  {kind} entries: {len(v)}, min {min(v):.2f} dB")
        if low[0][1] < LAYER_SQNR_DB:
            raise AssertionError(f"{labels[c]} entry {low[0][0]}: SQNR "
                                 f"{low[0][1]} dB < {LAYER_SQNR_DB}")
        if c in faults:
            fault, name = faults[c]
            f = layer_sqnrs(torch, unet, fault(ctx, name), qparams, seen,
                            [name], bits)[name]
            log(f"{labels[c]}: per-entry SQNR of {name} with its "
                f"{fault.__name__[:-4]} fault: {f:.2f} dB")
            if f >= LAYER_SQNR_DB:
                raise AssertionError(f"the per-entry check misses the fault "
                                     f"in {name}")
    kernels = phase_attention_sites(torch, unet, ctxs["int8_sec"],
                                    requests[0], MP_FAULT_SITES)
    log(f"{labels['int8_sec']} attention kernels: "
        f"{dict(collections.Counter(kernels.values()))}")

    paths = (("bf16", FP_CTX), ("w8a8_auto", w8a8_ctx),
             *((f"mp_{c}", ctxs[c]) for c in ctxs))
    paired_step_ms(torch, unet, requests, paths, card, "sdxl-turbo mixed")
    graphed_step_ms(torch, unet, requests[0],
                    (("bf16", FP_CTX), ("mp_int8_sec", ctxs["int8_sec"]),
                     ("mp_pallas_dequant", ctxs["pallas_dequant"])), card,
                    "sdxl-turbo mixed",
                    profiled=("mp_int8_sec", "mp_pallas_dequant"))
    for tag, ctx in paths:
        total, dep = resident_weight_bytes(
            unet, ctx.deploy if ctx.mode == "int8" else {})
        peak, rise = step_peak_bytes(torch, unet, requests[0], ctx)
        log(f"{tag}: resident weights {total / 2**20:.1f} MiB (deploy "
            f"entries {dep / 2**20:.1f} MiB); one step: "
            f"max_memory_allocated {peak / 2**20:.1f} MiB, "
            f"{rise / 2**20:.1f} MiB above the step's start")
    phase_profile(torch, unet, requests[0],
                  [(f"mp_{c}", ctxs[c]) for c in ctxs])
    return launches


@contextlib.contextmanager
def wq_shape_counts():
    """Within the block, counts the UNet's ``wq_matmul`` / ``wq4_matmul``
    calls by (M, K, N), yielded as a Counter of (kernel, M, K, N)."""
    from mixdq_tpu_torch.models import layers

    counts = collections.Counter()
    sound = {n: getattr(layers, n) for n in ("wq_matmul", "wq4_matmul")}

    def counted(name):
        def fn(x, w, *a, **kw):
            counts[(name, x.shape[0], x.shape[1], w.shape[1])] += 1
            return sound[name](x, w, *a, **kw)
        return fn

    for n in sound:
        setattr(layers, n, counted(n))
    try:
        yield counts
    finally:
        for n, f in sound.items():
            setattr(layers, n, f)


@contextlib.contextmanager
def igemm_shape_counts():
    """Within the block, counts the UNet's ``qmatmul`` calls by (M, K, N)
    (M ``'LxM'`` for a call over a layer axis: a bank) and its
    ``qconv2d`` / ``qconv2d_s2`` calls by (B, H, W, C, K), yielded as a
    Counter of (kernel, *shape)."""
    from mixdq_tpu_torch.models import layers
    from mixdq_tpu_torch.ops import qmatmul as qmm

    counts = collections.Counter()
    sound = [(qmm, "qmatmul"), (layers, "qconv2d"), (layers, "qconv2d_s2")]
    orig = [getattr(m, n) for m, n in sound]

    def counted(name, f):
        def fn(x, w, *a, **kw):
            if name == "qmatmul":
                shape = (x.shape[0] if x.ndim == 2 else
                         f"{x.shape[0]}x{x.shape[1]}", x.shape[-1],
                         w.shape[-1])
            else:
                shape = (*x.shape, w.shape[-1])
            counts[(name, *shape)] += 1
            return f(x, w, *a, **kw)
        return fn

    for (m, n), f in zip(sound, orig):
        setattr(m, n, counted(n, f))
    try:
        yield counts
    finally:
        for (m, n), f in zip(sound, orig):
            setattr(m, n, f)


def log_igemm_shapes(torch, unet, req, ctx, label):
    """One step of ``ctx`` with its int8 GEMM calls counted by shape;
    fails unless they sum to the launch table's counts."""
    from mixdq_tpu_torch import pipeline

    with igemm_shape_counts() as counts:
        pipeline.unet_step(unet, req, ctx)
    torch.cuda.synchronize()
    want = pipeline.ctx_kernel_calls(unet.config, ctx)
    for kernel in ("qmatmul", "qconv2d", "qconv2d_s2"):
        by = {k[1:]: v for k, v in sorted(counts.items(), key=lambda kv:
                                          -kv[1]) if k[0] == kernel}
        log(f"{label} step: {kernel} calls by shape "
            f"({'M, K, N' if kernel == 'qmatmul' else 'B, H, W, C, K'}): "
            f"{by}")
        if sum(by.values()) != want[kernel]:
            raise AssertionError(f"{label}: {sum(by.values())} {kernel} "
                                 f"calls, expected {want[kernel]}")


def step_ms(torch, fn):
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def run_path(torch, unet, requests, ctx, label):
    """One path (``ctx``: a deploy under its compute and kernel options, or
    FP; either ``attn_impl``) over ``requests`` with the launch counts set to 0 just
    before it and read just after; fails unless every kernel launched as
    often as the structure and the deploy imply, and every wrapper call
    launched its kernel."""
    from mixdq_tpu_torch import ops, pipeline

    ops.reset_counts()
    outs = [pipeline.unet_step(unet, r, ctx) for r in requests]
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    per_step = pipeline.ctx_kernel_calls(unet.config, ctx)
    want = {k: v * len(requests) for k, v in per_step.items()}
    log(f"{label} path launches over {len(requests)} requests: {launches}")
    if launches != want or ops.call_counts() != launches:
        raise AssertionError(f"{label} launch counts {launches}, calls "
                             f"{ops.call_counts()}, expected {want}")
    return outs, launches


def phase_main_path(torch, dev, card):
    """The SDXL-Turbo step under ``attn_impl='auto'`` (``quantize_w8a8``'s
    context, the headline) and ``'einsum'`` on the same deploy."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sdxl-turbo", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sdxl-turbo", 1, 0, bf16, dev)
    ctx = pipeline.quantize_w8a8(unet, calib)
    ectx = dataclasses.replace(ctx, attn_impl="einsum")
    torch.cuda.synchronize()
    log(f"sdxl-turbo build+calibrate+deploy: {time.time() - t0:.1f}s, "
        f"{len(ctx.deploy)} deploy entries")
    if pipeline.expected_kernel_calls(unet.config, "auto") != TURBO_CALLS:
        raise AssertionError("the structure's launch counts changed")
    requests = [pipeline.example_inputs("sdxl-turbo", 1, 100 + i, bf16, dev)
                for i in range(N_REQUESTS)]
    for c in (ctx, ectx):  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    torch.cuda.synchronize()
    outs, launches = run_path(torch, unet, requests, ctx, "sdxl-turbo auto")
    e_outs, e_launches = run_path(torch, unet, requests, ectx,
                                  "sdxl-turbo einsum")
    log_igemm_shapes(torch, unet, requests[0], ctx, "sdxl-turbo auto")

    refs = []
    sqnrs = {"auto": [], "einsum": [], "auto vs einsum": []}
    for r, q, e in zip(requests, outs, e_outs):
        ref = pipeline.unet_step(unet, r)
        for x in (q, e):
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"bad int8 output {x.shape}")
        refs.append(ref)
        sqnrs["auto"].append(sqnr_db(ref, q))
        sqnrs["einsum"].append(sqnr_db(ref, e))
        sqnrs["auto vs einsum"].append(sqnr_db(e, q))
    for k, v in sqnrs.items():
        log(f"SQNR {k if 'vs' in k else k + ' vs bf16'} per request (dB): "
            f"{[round(x, 2) for x in v]}")
    if min(sqnrs["auto"] + sqnrs["einsum"]) < MIN_SQNR_DB:
        raise AssertionError(f"SQNR {sqnrs} dB < {MIN_SQNR_DB}")
    for name in FAULT_LAYERS:
        bad = faulted_ctx(ctx, name)
        s = [sqnr_db(ref, pipeline.unet_step(unet, r, bad))
             for r, ref in zip(requests, refs)]
        log(f"SQNR with one fault in {name} (dB): {[round(x, 2) for x in s]}")
        if name == FAULT_LAYERS[-1] and max(s) >= MIN_SQNR_DB:
            raise AssertionError(f"the SQNR gate misses a fault in {name}")

    paired_step_ms(torch, unet, requests,
                   (("bf16", FP_CTX), ("auto", ctx), ("einsum", ectx)), card,
                   "sdxl-turbo")
    graphed = graphed_step_ms(torch, unet, requests[0],
                              (("bf16", FP_CTX), ("auto", ctx)), card,
                              "sdxl-turbo")
    return (unet, ctx, calib, requests, launches, e_launches, refs, outs,
            graphed)


def phase_layers(torch, unet, ctx, calib, req):
    """Every deploy entry of the full-width deploy, teacher-forced on the
    input its layer sees in an FP step, against ``fake_quant_layer``. A
    one-layer fault that the whole-model SQNR cannot tell from request to
    request spread shows here; each of ``FAULT_LAYERS`` proves it."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.calibrate import calibrate

    qparams = calibrate(unet, [calib], pipeline.WQ, pipeline.AQ)
    seen = record_layer_inputs(torch, unet, req)
    names = [n for n, e in ctx.deploy.items() if e.kind != "fused_away"]
    s = layer_sqnrs(torch, unet, ctx, qparams, seen, names)
    low = sorted(s.items(), key=lambda kv: kv[1])
    log(f"per-layer SQNR vs fake quantization over {len(s)} deploy entries "
        f"(dB): min {low[0][1]:.2f} median {statistics.median(s.values()):.2f}"
        f"; lowest {[(n, round(v, 2)) for n, v in low[:4]]}")
    if low[0][1] < LAYER_SQNR_DB:
        raise AssertionError(f"layer {low[0][0]}: SQNR {low[0][1]} dB < "
                             f"{LAYER_SQNR_DB}")
    for name in FAULT_LAYERS:
        f = layer_sqnrs(torch, unet, faulted_ctx(ctx, name), qparams, seen,
                        [name])[name]
        log(f"per-layer SQNR with one fault in {name}: {f:.2f} dB")
        if f >= LAYER_SQNR_DB:
            raise AssertionError(f"the per-layer check misses a fault in "
                                 f"{name}")
    return qparams, seen


def record_attention_inputs(torch, unet, req, ctx=None, ff=False):
    """{attention module name: (residual stream, encoder states)} of every
    attention module (and with ``ff`` every feed-forward, encoder states
    None) in one step under ``ctx`` (default: FP)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.attention import Attention, FeedForward

    seen = {}

    def hook(mod, args, kwargs):
        seen[mod.qname] = (kwargs["residual"],
                           args[1] if isinstance(mod, Attention) else None)

    kinds = (Attention, FeedForward) if ff else Attention
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in unet.modules() if isinstance(m, kinds)]
    try:
        pipeline.unet_step(unet, req, *([] if ctx is None else [ctx]))
    finally:
        for h in handles:
            h.remove()
    return seen


def attention_site(torch, unet, name, stream, ehs, ctx):
    """Attention (or feed-forward) module ``name`` run as its transformer
    block runs it (the block's pre-LayerNorm, deferred or materialized as
    ``ctx`` says, and the residual add) on ``stream``."""
    block, _, which = name.rpartition(".")
    blk = unet.get_submodule(block)
    if which == "attn1":
        norm, consumer = blk.norm1, (f"{block}.attn1.to_qkv"
                                     if ctx.fuse_qkv else None)
    elif which == "attn2":
        norm, consumer = blk.norm2, f"{block}.attn2.to_q"
    else:
        norm, consumer = blk.norm3, f"{block}.ff.net.0.proj"
    with torch.inference_mode():
        h, ln = blk._ln(stream, norm, consumer, ctx)
        if which == "ff":
            return blk.ff(h, ctx, residual=stream, ln=ln)
        return getattr(blk, which)(h, ehs, ctx, residual=stream, ln=ln)


def zp_faulted_ctx(ctx, name):
    """``ctx`` with entry ``name``'s act zero point shifted by 8 codes (its
    ``bias0`` keeps the sound one)."""
    import dataclasses

    e = ctx.deploy[name]
    return dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: e.replace(zp_shifted=e.zp_shifted + 8.0)})


def site_sqnrs(torch, unet, ctx, seen, names=None, ref_ctx=None,
               kernels=None):
    """SQNR in dB of each attention (or feed-forward) module's output
    delta under ``ctx`` against the same module under ``ref_ctx``
    (default: ``ctx`` with ``attn_impl='einsum'``), both teacher-forced on
    the FP-step input. ``kernels``: a dict that gets each module's kernel
    under ``ctx`` (an attention route or a feed-forward kernel; ``'einsum'``
    where none ran)."""
    import dataclasses

    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.models import routing

    ref_ctx = ref_ctx or dataclasses.replace(ctx, attn_impl="einsum")
    site_kernels = routing.KERNELS + ("geglu_out_qmatmul", "geglu_qmatmul")
    out = {}
    for name in names or sorted(seen):
        stream, ehs = seen[name]
        ops.reset_counts()
        got = attention_site(torch, unet, name, stream, ehs, ctx).float()
        if kernels is not None:
            calls = ops.call_counts()
            kernels[name] = next((k for k in site_kernels if calls[k]),
                                 routing.EINSUM)
        ref = attention_site(torch, unet, name, stream, ehs, ref_ctx).float()
        signal = (ref - stream.float()).pow(2).sum().item()
        err = (got - ref).pow(2).sum().item()
        out[name] = math.inf if err == 0 else 10 * math.log10(signal / err)
    return out


def site_gate(ctx, site):
    """The per-site SQNR limit: ``SITE_SQNR_DB`` where ``to_out`` takes
    8-bit act codes, ``SITE_DB_PER_BIT`` lower for each bit below 8 (one
    code apart between two kernels costs a step that doubles per bit
    dropped, at half the rate)."""
    e = ctx.entry(f"{site}.to_out.0")
    a_bits = 8 if e is None or e.act_off else e.a_bits
    return SITE_SQNR_DB - SITE_DB_PER_BIT * (8 - a_bits)


def phase_attention_sites(torch, unet, ctx, req, fault_sites=FAULT_SITES):
    """Every attention module, teacher-forced on its FP-step input, under
    ``ctx`` (``attn_impl='auto'``) against ``attn_impl='einsum'`` on the
    same deploy (>= ``site_gate``): a fault at one attention kernel's
    site, which the whole-step SQNR cannot see, shows here. Each of
    ``fault_sites`` (a to_out entry whose act zero point the kernel sees
    shifted by 8 codes) proves it. Returns {module: its attention kernel
    under ``ctx``}."""
    import dataclasses

    seen = record_attention_inputs(torch, unet, req)
    kernels = {}
    s = site_sqnrs(torch, unet, ctx, seen, kernels=kernels)
    low = sorted(s.items(), key=lambda kv: kv[1])
    log(f"attention sites auto vs einsum over {len(s)} modules (dB): min "
        f"{low[0][1]:.2f} median {statistics.median(s.values()):.2f}; "
        f"lowest {[(n, round(v, 2)) for n, v in low[:4]]}")
    for k in sorted(set(kernels.values())):
        v = [s[n] for n in s if kernels[n] == k]
        log(f"  {k} sites: {len(v)}, min {min(v):.2f} median "
            f"{statistics.median(v):.2f} dB")
    for gate in sorted({site_gate(ctx, n) for n in s}):
        v = [s[n] for n in s if site_gate(ctx, n) == gate]
        log(f"  sites with limit {gate:.1f} dB: {len(v)}, min {min(v):.2f}")
    bad = [(n, v) for n, v in low if v < site_gate(ctx, n)]
    if bad:
        raise AssertionError(f"sites below their SQNR limit: {bad}")
    einsum = dataclasses.replace(ctx, attn_impl="einsum")
    for name in fault_sites:
        site = name[:-len(".to_out.0")]
        f = site_sqnrs(torch, unet, zp_faulted_ctx(ctx, name), seen, [site],
                       ref_ctx=einsum)[site]
        log(f"attention site SQNR with the {name} zero point shifted by 8 "
            f"codes: {f:.2f} dB")
        if f >= site_gate(ctx, site):
            raise AssertionError(f"the site check misses a fault in {name}")
    return kernels


def phase_outfuse_sites(torch, unet, ctx, req,
                        fault_sites=OUTFUSE_FAULT_SITES):
    """Every attn1 and ff module, teacher-forced on its FP-step input,
    with every site out-fused (LN folded, then not) against the same
    module under ``ctx`` (the default route, same deploy): >=
    ``OUTFUSE_SITE_SQNR_DB``; each of ``fault_sites`` (a whole-block
    kernel's mid act quantizer, to_out's or ff.net.2's, with its zero
    point shifted by 8 codes) must fail. Returns {module: its kernel with
    every site out-fused}."""
    import dataclasses

    seen = record_attention_inputs(torch, unet, req, ff=True)
    names = sorted(n for n in seen if n.endswith((".attn1", ".ff")))
    kernels = {}
    for tag in ("all", "all_nofold"):
        octx = dataclasses.replace(ctx, **OUTFUSE_PATHS[tag])
        s = site_sqnrs(torch, unet, octx, seen, names, ref_ctx=ctx,
                       kernels=kernels)
        for kind in (".attn1", ".ff"):
            v = [x for n, x in s.items() if n.endswith(kind)]
            log(f"out-fusion {tag}: {len(v)} {kind[1:]} modules vs the "
                f"default route (dB): min {min(v):.2f} median "
                f"{statistics.median(v):.2f}")
        low = min(s.items(), key=lambda kv: kv[1])
        if low[1] < OUTFUSE_SITE_SQNR_DB:
            raise AssertionError(f"out-fusion {tag}: {low[0]} at {low[1]} dB "
                                 f"< {OUTFUSE_SITE_SQNR_DB}")
    octx = dataclasses.replace(ctx, **OUTFUSE_PATHS["all"])
    for name in fault_sites:
        site = name[:-len(".to_out.0" if name.endswith(".to_out.0")
                          else ".net.2")]
        f = site_sqnrs(torch, unet, zp_faulted_ctx(octx, name), seen, [site],
                       ref_ctx=ctx)[site]
        log(f"out-fusion site {site} with the {name} zero point shifted by "
            f"8 codes: {f:.2f} dB")
        if f >= OUTFUSE_SITE_SQNR_DB:
            raise AssertionError(f"the out-fusion site check misses a fault "
                                 f"in {name}")
    return kernels


@contextlib.contextmanager
def whole_block_drops_residual():
    """Within the block, the first ``sec_attention_qkv_out`` call returns
    its output without the residual (a whole-block kernel that drops its
    residual add at one site of a step)."""
    from mixdq_tpu_torch.models import attention as mod

    sound = mod.sec_attention_qkv_out
    calls = []

    def faulted(x, *args, **kw):
        out = sound(x, *args, **kw)
        calls.append(1)
        res = x if kw.get("ln") is not None else args[9]
        if len(calls) > 1 or res is None:
            return out
        return (out.float() - res.float()).to(out.dtype)

    mod.sec_attention_qkv_out = faulted
    try:
        yield
    finally:
        mod.sec_attention_qkv_out = sound


def phase_outfuse(torch, unet, ctx, requests, refs, outs, card):
    """The SDXL-Turbo deploy of phase 3 under the other out-fusion sets
    (``OUTFUSE_PATHS``: every site, LN folded and not; none) beside the
    default: launch counts (``OUTFUSE_CALLS``), SQNR against bf16 (>=
    ``MIN_SQNR_DB``), the whole step against the default route's ``outs``
    (>= ``OUTFUSE_STEP_SQNR_DB``, failed by an attn1 site that drops its
    residual), every attn1 / ff module against the default route, paired
    step medians and one profiled step of every site out-fused. Returns
    {path: launches}."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    ctxs = {tag: dataclasses.replace(ctx, **o)
            for tag, o in OUTFUSE_PATHS.items()}
    for tag, c in ctxs.items():
        if pipeline.ctx_kernel_calls(unet.config, c) != OUTFUSE_CALLS[tag]:
            raise AssertionError(f"out-fusion {tag}: the launch counts are "
                                 "not OUTFUSE_CALLS")
    for c in ctxs.values():  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    launches, sqnrs = {}, {}
    for tag, c in ctxs.items():
        label = f"sdxl-turbo outfuse {tag}"
        got, launches[label] = run_path(torch, unet, requests, c, label)
        for x in got:
            if x.shape != refs[0].shape or not torch.isfinite(x).all():
                raise AssertionError(f"{label}: bad output {x.shape}")
        sqnrs[f"{tag} vs bf16"] = [sqnr_db(r, x) for r, x in zip(refs, got)]
        sqnrs[f"{tag} vs default"] = [sqnr_db(o, x) for o, x in zip(outs, got)]
    bad = []
    for r in requests:
        with whole_block_drops_residual():
            bad.append(pipeline.unet_step(unet, r, ctxs["all"]))
    sqnrs["all, one attn1 dropping its residual, vs default"] = [
        sqnr_db(o, x) for o, x in zip(outs, bad)]
    for k, v in sqnrs.items():
        log(f"SQNR out-fusion {k} per request (dB): "
            f"{[round(x, 2) for x in v]}")
    if min(min(sqnrs[f"{t} vs bf16"]) for t in ctxs) < MIN_SQNR_DB:
        raise AssertionError(f"out-fusion SQNR vs bf16 < {MIN_SQNR_DB} dB")
    if min(min(sqnrs[f"{t} vs default"]) for t in ctxs) < \
            OUTFUSE_STEP_SQNR_DB:
        raise AssertionError(f"out-fusion vs default < {OUTFUSE_STEP_SQNR_DB}"
                             " dB")
    if max(sqnrs["all, one attn1 dropping its residual, vs default"]) >= \
            OUTFUSE_STEP_SQNR_DB:
        raise AssertionError("the out-fusion step gate misses a dropped "
                             "residual")
    kernels = phase_outfuse_sites(torch, unet, ctx, requests[0])
    log(f"out-fusion modules by kernel: "
        f"{dict(collections.Counter(kernels.values()))}")
    paired_step_ms(torch, unet, requests,
                   (("bf16", FP_CTX), ("default", ctx),
                    *((f"outfuse_{t}", c) for t, c in ctxs.items())), card,
                   "sdxl-turbo out-fusion")
    graphed_step_ms(torch, unet, requests[0],
                    (("bf16", FP_CTX), ("default", ctx),
                     ("outfuse_all", ctxs["all"])), card,
                    "sdxl-turbo out-fusion", profiled=("outfuse_all",))
    phase_profile(torch, unet, requests[0], [("outfuse_all", ctxs["all"])])
    return launches


@contextlib.contextmanager
def int8_flash_q_scale_doubled():
    """Within the block, the int8 flash attention of the UNet dequantizes
    its logits with twice the q scale."""
    from mixdq_tpu_torch.ops import attention as mod

    sound = mod._int8_operands

    def faulted(*args, **kw):
        qi, ki, v, s_qk, sv = sound(*args, **kw)
        return qi, ki, v, 2 * s_qk, sv

    mod._int8_operands = faulted
    try:
        yield
    finally:
        mod._int8_operands = sound


def phase_int8_flash_sites(torch, unet, ctx, req, label="sdxl"):
    """Each int8 flash site of the SDXL 1024 deploy under
    ``int8_flash`` 'qk' and 'qkv', teacher-forced on its FP-step input,
    against the bf16 flash site of ``ctx`` (same deploy) on the same
    input (>= ``INT8_FLASH_SITE_SQNR_DB``); with its q scale doubled, the
    first site must fail."""
    import dataclasses

    seen = record_attention_inputs(torch, unet, req)
    names = sorted(n for n, (x, ehs) in seen.items()
                   if ehs is None and x.shape[1] ** 2 >= 2 ** 22)
    for mode, gate in INT8_FLASH_SITE_SQNR_DB.items():
        c = dataclasses.replace(ctx, int8_flash=mode)
        kernels = {}
        s = site_sqnrs(torch, unet, c, seen, names, ref_ctx=ctx,
                       kernels=kernels)
        v = [s[n] for n in names]
        log(f"{label} int8 flash {mode}: {len(v)} sites "
            f"({dict(collections.Counter(kernels.values()))}) vs bf16 flash "
            f"(dB): min {min(v):.2f} median {statistics.median(v):.2f} "
            f"max {max(v):.2f}")
        if min(v) < gate:
            raise AssertionError(f"{label} int8 flash {mode} site SQNR "
                                 f"{min(v)} dB < {gate}")
        with int8_flash_q_scale_doubled():
            f = site_sqnrs(torch, unet, c, seen, names[:1],
                           ref_ctx=ctx)[names[0]]
        log(f"{label} int8 flash {mode} site {names[0]} with its q scale "
            f"doubled: {f:.2f} dB")
        if f >= gate:
            raise AssertionError(f"the int8 flash {mode} site check misses a "
                                 "doubled q scale")


def profile_call(torch, fn, tag, reps=1):
    """Device time by kernel over ``reps`` calls of ``fn`` back to back
    (warmed first), written to ``chiprun_out/profile_{tag}.txt``; returns
    (wall ms, device busy ms, rows of (ms, count, kernel)) of the whole
    window, rows empty where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(OUT_DIR, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = getattr(e, "cuda_time_total", 0)
        if dt and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dt / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(f"wall_ms {wall:.3f} device_busy_ms {busy:.3f}\n")
        for ms, n, key in rows:
            f.write(f"{ms:10.4f} ms {n:6d}  {key}\n")
    if not rows:
        log(f"profile {tag}: no device time recorded (not measured)")
    else:
        log(f"profile {tag}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
            f"(idle share {max(0.0, 1 - busy / wall):.3f})")
    return wall, busy, rows


def phase_profile(torch, unet, req, paths):
    """Device time by kernel over one step of each of ``paths`` ((tag,
    context) pairs), written to ``chiprun_out/profile_{tag}.txt``."""
    from mixdq_tpu_torch import pipeline

    for tag, c in paths:
        _, _, rows = profile_call(
            torch, lambda c=c: pipeline.unet_step(unet, req, c), tag)
        if not rows:
            continue
        for ms, n, key in rows[:8]:
            log(f"  {ms:9.4f} ms x{n:5d} {key[:90]}")
        sec = {name: [round(sum(r[0] for r in rows if pat in r[2]), 4),
                      sum(r[1] for r in rows if pat in r[2])]
               for name, pat in PROFILE_KERNELS.items()}
        log(f"profile {tag}: redesigned kernels' device ms, launches {sec}")


def graphed_step_ms(torch, unet, req, paths, card, label, profiled=None):
    """Each of ``paths`` ((tag, context) pairs) captured as a CUDA graph of
    one step on ``req`` (``pipelines.graphed.GraphedCall``): the launches
    counted during the capture must be the path's ``ctx_kernel_calls`` (or
    the FP step's), and a replay must equal the eager step bit for bit.
    Then paired medians: in each of ``TIMING_ROUNDS`` rounds the paths in
    turn, each over ``GRAPH_ITERS`` replays (CUDA events); and one profiled
    window of ``GRAPH_ITERS`` replays of each
    (``chiprun_out/profile_graph_*.txt``; one replay alone reads the
    profiler's own start-up as idle time), for the tags in ``profiled``
    (default: all). An eager step's profile is ``phase_profile``'s, made
    once a path. Returns {tag: median ms}."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall
    from mixdq_tpu_torch.utils.profiling import timeit

    sample, t, ehs, added = req
    graphs = {}
    for tag, c in paths:
        g = GraphedCall(lambda s, c=c: unet(s, t, ehs, added, ctx=c),
                        (sample,))
        want = pipeline.ctx_kernel_calls(unet.config, c)
        if g.launches != want:
            raise AssertionError(f"{label} graph {tag}: launches counted at "
                                 f"capture {g.launches}, expected {want}")
        eager = pipeline.unet_step(unet, req, c)
        got = g.replay()
        if not torch.equal(got, eager):
            raise AssertionError(
                f"{label} graph {tag}: replay differs from the eager step "
                f"({sqnr_db(eager, got):.2f} dB)")
        graphs[tag] = g
    log(f"{label} graphs: {sorted(graphs)} captured; launches at capture "
        "equal ctx_kernel_calls; each replay equals its eager step bit for "
        "bit")
    times = {tag: [] for tag in graphs}
    for _ in range(TIMING_ROUNDS):
        for tag, g in graphs.items():
            times[tag].append(timeit(g.replay, iters=GRAPH_ITERS, warmup=0))
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"{label} graphed step ms (median of {TIMING_ROUNDS} rounds of "
        f"{GRAPH_ITERS} replays, CUDA events, {card}): "
        + " ".join(f"{k}={v:.3f}" for k, v in med.items()) + " "
        + " ".join(f"bf16/{k}={med['bf16'] / v:.3f}" for k, v in med.items()
                   if k != "bf16"))
    name = label.replace(" ", "_")
    for tag, g in graphs.items():
        if profiled is not None and tag not in profiled:
            continue
        gw, gb, _ = profile_call(torch, g.replay, f"graph_{name}_{tag}",
                                 GRAPH_ITERS)
        log(f"{label} {tag}: graph replay wall {gw / GRAPH_ITERS:.3f} ms "
            f"busy {gb / GRAPH_ITERS:.3f} ms idle {max(0.0, 1 - gb / gw):.3f}"
            f" ({GRAPH_ITERS} replays profiled)")
    del graphs
    return med


def paired_step_ms(torch, unet, requests, paths, card, label):
    """Median step time of each of ``paths`` ((tag, context) pairs) over
    ``TIMING_ROUNDS`` rounds of ``requests``, the paths in turn for each
    request (CUDA events)."""
    from mixdq_tpu_torch import pipeline

    times = {tag: [] for tag, _ in paths}
    for _ in range(TIMING_ROUNDS):
        for r in requests:
            for tag, c in paths:
                times[tag].append(step_ms(
                    torch, lambda: pipeline.unet_step(unet, r, c)))
    med = {k: statistics.median(v) for k, v in times.items()}
    n = len(next(iter(times.values())))
    log(f"{label} step ms (median of {n} paired steps, CUDA events, {card}): "
        + " ".join(f"{k}={v:.3f}" for k, v in med.items()) + " "
        + " ".join(f"bf16/{k}={med['bf16'] / v:.3f}" for k, v in med.items()
                   if k != "bf16"))
    return med


@contextlib.contextmanager
def flash_drops_key_block():
    """Within the block, the UNet's flash attention drops the last
    ``FLASH_DROPPED_KEYS`` keys at every site (a kernel that skips one
    chunk of keys)."""
    from mixdq_tpu_torch.models import attention as mod

    sound = mod.flash_attention

    def faulted(q_src, k_src, v_src, **kw):
        n = k_src.shape[1] - FLASH_DROPPED_KEYS
        return sound(q_src, k_src[:, :n].contiguous(),
                     v_src[:, :n].contiguous(), **kw)

    mod.flash_attention = faulted
    try:
        yield
    finally:
        mod.flash_attention = sound


def phase_flash_sites(torch, unet, ctx, req, label="sdxl"):
    """Each flash attention site of the bf16 UNet under ``ctx``
    (``attn_impl='auto'``), teacher-forced on its FP-step input, against
    the einsum chain (>= ``FLASH_SITE_SQNR_DB``); with its last 64 keys
    dropped, the first site must fail that check. Returns the sites."""
    seen = record_attention_inputs(torch, unet, req)
    kernels = {}
    s = site_sqnrs(torch, unet, ctx, seen, kernels=kernels)
    sites = sorted(n for n, k in kernels.items() if k == "flash_attention")
    v = [s[n] for n in sites]
    log(f"{label} bf16 flash sites auto vs einsum: {len(v)}, min "
        f"{min(v):.2f} median {statistics.median(v):.2f} dB")
    if min(v) < FLASH_SITE_SQNR_DB:
        raise AssertionError(f"{label} bf16 flash site SQNR {min(v)} dB < "
                             f"{FLASH_SITE_SQNR_DB}")
    with flash_drops_key_block():
        f = site_sqnrs(torch, unet, ctx, seen, sites[:1])[sites[0]]
    log(f"{label} bf16 flash site {sites[0]} with its last "
        f"{FLASH_DROPPED_KEYS} keys dropped: {f:.2f} dB")
    if f >= FLASH_SITE_SQNR_DB:
        raise AssertionError("the site check misses dropped keys")
    return sites


def phase_sdxl(torch, dev, card):
    """SDXL at 1024 px: the W8A8 deploy under ``'auto'`` (bf16 and both
    int8 flash modes) and ``'einsum'`` and the bf16 UNet under ``'auto'``,
    each path's launches against the
    structure (and ``SDXL_CALLS``), SQNR against bf16, bf16 auto (flash
    attention) against bf16 einsum, whole and per flash site, with the
    last 64 keys dropped, which must fail both, every attention site auto
    against einsum with zero-point faults, each int8 flash site against
    the bf16 flash site (``phase_int8_flash_sites``), paired step medians
    and one profiled step per path. Returns
    ({path: launches per step}, {path: launches})."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sdxl", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sdxl", 1, 0, bf16, dev)
    ctx = pipeline.quantize_w8a8(unet, calib)
    paths = (("bf16", dataclasses.replace(FP_CTX, attn_impl="auto")),
             ("auto", ctx), ("einsum", dataclasses.replace(
                 ctx, attn_impl="einsum")),
             ("int8_qk", dataclasses.replace(ctx, int8_flash="qk")),
             ("int8_qkv", dataclasses.replace(ctx, int8_flash="qkv")))
    int8 = [tag for tag, _ in paths if tag != "bf16"]
    torch.cuda.synchronize()
    log(f"sdxl build+calibrate+deploy: {time.time() - t0:.1f}s, "
        f"{len(ctx.deploy)} deploy entries")
    for tag, c in paths:
        if pipeline.expected_kernel_calls(
                unet.config, c.attn_impl, mode=c.mode,
                int8_flash=c.int8_flash) != SDXL_CALLS[tag]:
            raise AssertionError(f"sdxl {tag}: the structure's launch "
                                 "counts changed")
    requests = [pipeline.example_inputs("sdxl", 1, 200 + i, bf16, dev)
                for i in range(N_SDXL_REQUESTS)]
    for _, c in paths:  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    outs, launches = {}, {}
    for tag, c in paths:
        outs[tag], launches[f"sdxl {tag}"] = run_path(
            torch, unet, requests, c, f"sdxl {tag}")
    log_igemm_shapes(torch, unet, requests[0], ctx, "sdxl auto")
    flash = "bf16 auto vs bf16 einsum"
    dropped = (f"bf16 auto, flash dropping its last {FLASH_DROPPED_KEYS} "
               "keys, vs bf16 einsum")
    sqnrs = {**{tag: [] for tag in int8}, flash: [], dropped: []}
    for i, r in enumerate(requests):
        ref = outs["bf16"][i]
        for tag in int8:
            x = outs[tag][i]
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"sdxl {tag}: bad output {x.shape}")
            sqnrs[tag].append(sqnr_db(ref, x))
        fp_einsum = pipeline.unet_step(unet, r)
        sqnrs[flash].append(sqnr_db(fp_einsum, ref))
        with flash_drops_key_block():
            sqnrs[dropped].append(sqnr_db(
                fp_einsum, pipeline.unet_step(unet, r, paths[0][1])))
    for k, v in sqnrs.items():
        log(f"sdxl SQNR {k if 'vs' in k else k + ' vs bf16 auto'} per "
            f"request (dB): {[round(x, 2) for x in v]}")
    if min(min(sqnrs[tag]) for tag in int8) < MIN_SQNR_DB:
        raise AssertionError(f"sdxl SQNR {sqnrs} dB < {MIN_SQNR_DB}")
    if min(sqnrs[flash]) < FLASH_SQNR_DB:
        raise AssertionError(f"sdxl {flash}: {sqnrs[flash]} dB < "
                             f"{FLASH_SQNR_DB}")
    if max(sqnrs[dropped]) >= FLASH_SQNR_DB:
        raise AssertionError(f"the {FLASH_SQNR_DB} dB gate on {flash} misses "
                             f"dropped keys: {sqnrs[dropped]} dB")
    paired_step_ms(torch, unet, requests, paths, card, "sdxl")
    graphed_step_ms(torch, unet, requests[0],
                    (("bf16", paths[0][1]), ("auto", ctx)), card, "sdxl")
    phase_attention_sites(torch, unet, ctx, requests[0], SDXL_FAULT_SITES)
    phase_flash_sites(torch, unet, paths[0][1], requests[0])
    phase_int8_flash_sites(torch, unet, ctx, requests[0])
    phase_profile(torch, unet, requests[0],
                  [(f"sdxl_{tag}", c) for tag, c in paths])
    return {p: {k: v // N_SDXL_REQUESTS for k, v in c.items()}
            for p, c in launches.items()}, launches


def phase_kernel_bench(torch, dev, card):
    """The kernel benchmark's path (``mixdq_tpu_torch.scripts.kernel_bench``,
    ``KB_ITERS`` timed calls of each row at each shape) with the launch
    counts set to 0 just before it and read just after; each int8 row's
    last output against the PyTorch int8 row's (``fused_err``, one code
    being ``W_SCALE`` times the largest weight code). Returns (launches,
    calls of each row at each shape)."""
    from mixdq_tpu_torch import ops
    from mixdq_tpu_torch.scripts import kernel_bench as kb

    ops.reset_counts()
    table = kb.bench(dev, KB_ITERS)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    calls = kb.WARMUP + KB_ITERS
    n = len(kb.SHAPES) * calls
    want = dict(_NONE, qmatmul=n, qmatmul_fused=n, qmatmul_fused2=n,
                wq_matmul=n, wq4_matmul=n)
    log(f"kernel_bench path launches over {calls} calls of each row at "
        f"{len(kb.SHAPES)} shapes: {launches}")
    if launches != want or ops.call_counts() != launches:
        raise AssertionError(f"kernel_bench launch counts {launches}, calls "
                             f"{ops.call_counts()}, expected {want}")
    for shape, rows in table:
        if len(rows) != 7:
            raise AssertionError(f"kernel_bench {shape}: {len(rows)} rows")
        out = {name: y for name, _, y in rows}
        ref = out["torch int8 (quant+int_gemm)"]
        for name in ("quantize + qmatmul", "fused-quant (qmatmul_fused)",
                     "fused-quant v2 (qmatmul_fused2)"):
            err = fused_err(torch, out[name], ref, kb.W_SCALE * 127)
            log(f"kernel_bench {shape} {name} vs torch int8: max |diff| "
                f"{err}")
    log(f"kernel_bench ({card}, median of {KB_ITERS} calls, CUDA events):")
    for line in kb.format_table(table):
        log(line)
    return launches, calls


def odd_channels_faulted_ctx(ctx, name):
    """``ctx`` with entry ``name``'s odd output channels dequantized with
    twice their scale. (A fault on a contiguous half of the channels,
    ``faulted_ctx``, scales whole GroupNorm groups, which the decoder's
    next GroupNorm undoes.)"""
    import dataclasses

    e = ctx.deploy[name]
    scale = e.scale.clone()
    scale[1::2] *= 2
    return dataclasses.replace(ctx, deploy={**ctx.deploy,
                                            name: e.replace(scale=scale)})


def unet_added(torch, eng, args):
    """What the UNet adds in the engine's Euler (or LCM) steps on ``args``
    (its ``inputs``): the sampled latents minus the initial latents (the
    noise, scaled for Euler), which every variant shares; f32."""
    with torch.inference_mode():
        x_t = (args[2] * eng.schedule.schedule.init_noise_sigma if eng.euler
               else args[2])
        return eng.denoise(*args).float() - x_t.float()


def phase_serving(torch, dev, card):
    """The serving path at full SDXL-Turbo width (``ServingEngine``: both
    CLIP towers, one Euler step, g = 0, the VAE decode to 512 px images),
    one captured CUDA graph a batch, at B = 1 and B = 4, for three
    variants: bf16; the W8A8 UNet (``quantize_w8a8``: ``int8_sec``,
    ``'auto'``, calibrated on the bf16 pipeline's UNet inputs for four
    other prompts) with the bf16 VAE; the same UNet with the int8 VAE decoder
    (``quantize_vae_decoder``, calibrated on the W8A8 pipeline's latents
    for four other prompts). For each engine, with the launch counts set
    to 0 just before it is built and read just after its requests: the
    launches counted at capture must be the UNet's ``ctx_kernel_calls``
    plus the decoder's ``decoder_kernel_calls`` (the warm-ups and the
    capture launch three times that); the images finite, in [0, 1], of
    the expected shape, equal to the eager ``run`` on the same noise bit
    for bit, the same for a repeated seed and not for another seed. SQNR
    gates (``MIN_SQNR_DB``, ``SERVE_VAE_DB``), each failed by a planted
    fault: what the W8A8 UNet adds to the latents (``unet_added``)
    against bf16's (the fault: the UNet calibrated on phase 3's example
    inputs), and the int8 VAE's images against the bf16 VAE's under the
    W8A8 UNet (one layer's odd channels at twice their scale); ms per
    batch and images/s from graph replays (CUDA events), the host's
    ``generate`` wall time and the eager ``run`` beside; one profiled
    replay and eager run at B = 1 per variant. Returns {path: launches}."""
    import copy

    import numpy as np

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.pipelines.serving import ServingEngine
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline
    from mixdq_tpu_torch.quant.state import FP_CTX
    from mixdq_tpu_torch.quant.vae_quant import (decoder_kernel_calls,
                                                 quantize_vae_decoder)
    from mixdq_tpu_torch.utils.profiling import timeit
    from mixdq_tpu_torch.utils.prompts import BUILTIN_PROMPTS

    bf16 = torch.bfloat16
    t0 = time.time()
    pipe = Text2ImgPipeline("sdxl-turbo", bf16, dev).init_weights(0)
    # calibrated on the UNet inputs of the bf16 pipeline's own trajectory
    # for four prompts the timed requests do not use (the reference's
    # calibration data), as its text embeddings come from the towers
    rec = pipe(BUILTIN_PROMPTS[-4:], seed=SERVE_SEED + 1,
               num_inference_steps=1, guidance_scale=0.0,
               capture_trajectory=True, decode=False)
    calib = (rec.trajectory[0], rec.timesteps[0], rec.text_emb,
             rec.added_conds)
    ctx = pipeline.quantize_w8a8(pipe.unet, calib)
    # the UNet gate's planted fault: phase 3's calibration data
    ex = pipeline.example_inputs("sdxl-turbo", 1, 0, bf16, dev)
    ctx_ex = pipeline.quantize_w8a8(pipe.unet, ex)
    log("serving: text embedding RMS, the towers' "
        f"{rec.text_emb.float().pow(2).mean().sqrt().item():.3f}, phase 3's "
        f"example inputs' {ex[2].float().pow(2).mean().sqrt().item():.3f}")
    del ex
    cal = ServingEngine(pipe, ctx, batch_size=4, steps=1, guidance_scale=0.0)
    latents = cal.denoise(*cal.inputs(BUILTIN_PROMPTS[-4:], SERVE_SEED + 1))
    vae_q, vctx = quantize_vae_decoder(pipe.vae, [latents])
    pipe_q = copy.copy(pipe)
    pipe_q.vae = vae_q
    torch.cuda.synchronize()
    log(f"serving: sdxl-turbo pipeline built, UNet deployed W8A8 "
        f"({len(ctx.deploy)} entries), VAE decoder int8 "
        f"({len(vctx.deploy)} entries) in {time.time() - t0:.1f}s")
    unet_calls = pipeline.ctx_kernel_calls(pipe.unet.config, ctx)
    vae_calls = decoder_kernel_calls(vctx)
    variants = {
        "bf16": (pipe, FP_CTX, FP_CTX, dict.fromkeys(unet_calls, 0)),
        "w8a8": (pipe, ctx, FP_CTX, unet_calls),
        "w8a8+int8 vae": (pipe_q, ctx, vctx,
                          {k: unet_calls[k] + vae_calls[k]
                           for k in unet_calls})}
    launches, report, gates = {}, {}, []
    for B in SERVE_BATCHES:
        prompts = BUILTIN_PROMPTS[:B]
        images, added = {}, {}
        for name, (p, c, vc, want) in variants.items():
            label = f"serving {name} B={B}"
            ops.reset_counts()
            t1 = time.time()
            eng = ServingEngine(p, c, batch_size=B, steps=1,
                                guidance_scale=0.0, vae_ctx=vc).compile()
            built = time.time() - t1
            img = eng.generate(prompts, seed=SERVE_SEED)
            again = eng.generate(prompts, seed=SERVE_SEED)
            other = eng.generate(prompts, seed=SERVE_SEED + 2)
            torch.cuda.synchronize()
            launches[label] = ops.launch_counts()
            if eng.launches != want:
                raise AssertionError(f"{label}: launches counted at capture "
                                     f"{eng.launches}, expected {want}")
            if launches[label] != {k: 3 * v for k, v in want.items()} or \
                    ops.call_counts() != launches[label]:
                raise AssertionError(f"{label}: launches {launches[label]} "
                                     "are not three runs' (two warm-ups "
                                     "and the capture)")
            if img.shape != (B, 512, 512, 3) or not np.isfinite(img).all() \
                    or img.min() < 0 or img.max() > 1:
                raise AssertionError(f"{label}: bad images {img.shape}")
            if not np.array_equal(img, again) or np.array_equal(img, other):
                raise AssertionError(f"{label}: a seed does not fix the "
                                     "images")
            args = eng.inputs(prompts, SERVE_SEED)
            eager = eng.run(*args).float().cpu().numpy()
            if not np.array_equal(img, eager):
                raise AssertionError(
                    f"{label}: graphed images differ from the eager run "
                    f"(max |d| {np.abs(img - eager).max()})")
            images[name] = torch.from_numpy(img)
            added[name] = unet_added(torch, eng, args)
            reps, gen_ms, eager_ms = [], [], []
            for _ in range(SERVE_ROUNDS):
                reps.append(timeit(eng._graph.replay, iters=GRAPH_ITERS,
                                   warmup=0))
                t1 = time.perf_counter()
                eng.generate(prompts, seed=SERVE_SEED)
                gen_ms.append((time.perf_counter() - t1) * 1e3)
                eager_ms.append(step_ms(torch, lambda: eng.run(*args)))
            ms = statistics.median(reps)
            report[label] = dict(
                ms_per_batch=ms, images_per_s=B * 1e3 / ms,
                generate_ms=statistics.median(gen_ms),
                eager_ms=statistics.median(eager_ms))
            log(f"{label}: compile (2 warm-ups + capture) {built:.1f}s; "
                f"graph {ms:.3f} ms a batch, {B * 1e3 / ms:.2f} images/s "
                f"(median of {SERVE_ROUNDS} rounds of {GRAPH_ITERS} "
                f"replays); generate() wall {report[label]['generate_ms']:.3f}"
                f" ms (tokenize, copy in, replay, images to the host); eager "
                f"run {report[label]['eager_ms']:.3f} ms; {card}")
            if B == 1:
                tag = "serving_" + name.replace(" ", "_").replace("+", "_")
                gw, gb, _ = profile_call(torch, eng._graph.replay,
                                         f"graph_{tag}", GRAPH_ITERS)
                ew, eb, _ = profile_call(torch, lambda: eng.run(*args),
                                         f"eager_{tag}")
                log(f"{label}: graph replay wall {gw / GRAPH_ITERS:.3f} ms "
                    f"busy {gb / GRAPH_ITERS:.3f} ms idle "
                    f"{max(0.0, 1 - gb / gw):.3f} ({GRAPH_ITERS} replays "
                    f"profiled) | eager run wall {ew:.3f} ms busy {eb:.3f} ms"
                    f" idle {max(0.0, 1 - eb / ew):.3f}")
            del eng
        # the UNet gate on what the UNet adds, the VAE gate on images;
        # planted faults run eagerly on the same inputs
        unet_fault = FAULT_LAYERS[-1]
        bad, bad_cal = (ServingEngine(pipe, c, batch_size=B, steps=1,
                                      guidance_scale=0.0)
                        for c in (faulted_ctx(ctx, unet_fault), ctx_ex))
        bad_vae = ServingEngine(pipe_q, ctx, batch_size=B, steps=1,
                                guidance_scale=0.0,
                                vae_ctx=odd_channels_faulted_ctx(
                                    vctx, SERVE_VAE_FAULT))
        with torch.inference_mode():
            bad_img = bad_vae.run(*args).float().cpu()
        sq = {"w8a8 unet": sqnr_db(added["bf16"], added["w8a8"]),
              "w8a8 unet, fault": sqnr_db(added["bf16"],
                                          unet_added(torch, bad_cal, args)),
              "w8a8 unet, layer fault": sqnr_db(added["bf16"],
                                                unet_added(torch, bad, args)),
              "w8a8 images": sqnr_db(images["bf16"], images["w8a8"]),
              "int8 vae images": sqnr_db(images["w8a8"],
                                         images["w8a8+int8 vae"]),
              "int8 vae images, fault": sqnr_db(images["w8a8"], bad_img)}
        log(f"serving B={B} SQNR (dB): what the W8A8 UNet adds to the "
            f"latents vs bf16 {sq['w8a8 unet']:.2f}, calibrated on phase "
            f"3's example inputs {sq['w8a8 unet, fault']:.2f} (gate "
            f"{MIN_SQNR_DB}), with half of {unet_fault}'s channels at "
            f"twice their scale {sq['w8a8 unet, layer fault']:.2f} (not "
            f"gated: phase 4's per-entry check); W8A8 images vs bf16 "
            f"{sq['w8a8 images']:.2f} (not gated); int8 VAE images vs bf16 "
            f"VAE {sq['int8 vae images']:.2f}, with "
            f"{SERVE_VAE_FAULT}'s odd channels at twice their scale "
            f"{sq['int8 vae images, fault']:.2f} (gate {SERVE_VAE_DB})")
        for what, gate in (("w8a8 unet", MIN_SQNR_DB),
                           ("int8 vae images", SERVE_VAE_DB)):
            if sq[what] < gate or sq[f"{what}, fault"] >= gate:
                gates.append(f"serving B={B}: {what} SQNR {sq[what]:.2f} "
                             f"dB, faulted {sq[f'{what}, fault']:.2f}, gate "
                             f"{gate}")
    log(json.dumps({"serving": report}))
    if gates:
        raise AssertionError("; ".join(gates))
    return launches


def split_fake_quant(torch, m, x, qp, split):
    """``fake_quant_layer`` of a channel-split 1x1 conv: each input half
    with its own qparams (the plain fields for ``[:split]``, the ``*0``
    twins for ``[split:]``), summed, then the bias."""
    import types

    from mixdq_tpu_torch.quant.state import LayerQParams

    y = 0
    halves = ((slice(None, split), qp),
              (slice(split, None), LayerQParams(
                  w_delta=qp.w0_delta, a_delta=qp.a0_delta,
                  a_zp=qp.a0_zp)))
    for sl, q in halves:
        half = types.SimpleNamespace(weight=m.weight[:, :, sl], bias=None,
                                     strides=m.strides, padding=m.padding)
        y = y + fake_quant_layer(torch, half, x[..., sl], {}, q, q)[0]
    return y + m.bias.float()


def qparams_bits_equal(a, b):
    """Whether two ``LayerQParams`` set the same fields to the same
    dtypes, shapes and bits."""
    for f, x in vars(a).items():
        y = getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and (x.dtype != y.dtype or x.shape != y.shape
                              or x.cpu().numpy().tobytes()
                              != y.cpu().numpy().tobytes()):
            return False
    return True


def twins_swapped(qparams, names):
    """``qparams`` with each of ``names``' halves given the other's
    qparams (``w*`` and ``a*`` against ``w0*`` and ``a0*``)."""
    out = dict(qparams)
    for n in names:
        q = qparams[n]
        out[n] = q.replace(w_delta=q.w0_delta, w_zp=q.w0_zp,
                           a_delta=q.a0_delta, a_zp=q.a0_zp,
                           w0_delta=q.w_delta, w0_zp=q.w_zp,
                           a0_delta=q.a_delta, a0_zp=q.a_zp)
    return out


def phase_ptq_flow(torch, dev, card, turbo_graphed, tmp):
    """The PTQ flow through files (``configs/sdxl_turbo.yaml``: 32
    prompts, batch 4, one step, 512 px, W8A8, BoS-aware), each CLI's
    ``main()`` on the card in turn, files in a temporary directory:
    ``gen_calib_data`` (npz keys and shapes), ``ptq`` (calibration with
    the channel splits, ``qparams.msgpack``), ``quant_txt2img`` (the
    checkpoint deployed ``int8_sec`` with fused QKV/KV, PNGs); its context
    is then put under ``attn_impl='auto'``, as phase 3's. Then: the file
    read back equal bit for bit to the qparams in memory; 9 ``conv_split``
    entries; ``ctx_kernel_calls`` of the deploy = phase 3's
    (``TURBO_CALLS``) + 9 ``qmatmul``, held in one eager step with the
    counts set to 0 (``run_path``) and at graph capture
    (``graphed_step_ms`` beside bf16; the replay equals the eager step);
    each split entry on its FP-step input against ``split_fake_quant``
    (>= ``LAYER_SQNR_DB``) and its twins swapped (< ``LAYER_SQNR_DB`` on
    at least one); what the UNet adds in the Euler step against bf16's
    (``unet_added``, >= ``MIN_SQNR_DB``: phase 9's gate); the bf16
    pipeline's params written (``save_params``) and read into a new
    pipeline (``load_params``): the same images bit for bit.
    ``turbo_graphed``: phase 3's graphed step ms, printed beside; ``tmp``:
    the directory of the files, which phase 11 reads after. Returns
    ({'ptq flow': the launches counted in the eager step}, the experiment
    directory, the calibration data's path)."""
    import dataclasses
    import shutil

    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.configs import get_family
    from mixdq_tpu_torch.models.unet import conv_shortcut_splits
    from mixdq_tpu_torch.pipelines.loader import (build_pipeline,
                                                  specs_from_config)
    from mixdq_tpu_torch.pipelines.serving import ServingEngine
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline
    from mixdq_tpu_torch.quant import checkpoint
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import (FP_CTX, quantizable_layers,
                                             uniform_ctrl)
    from mixdq_tpu_torch.scripts import gen_calib_data, ptq, quant_txt2img
    from mixdq_tpu_torch.utils.config import load_config, merge, save_config
    from mixdq_tpu_torch.utils.prompts import BUILTIN_PROMPTS

    cfg = merge(load_config(PTQ_CONFIG),
                {"calib_data": {"path": os.path.join(tmp, "calib.npz")}})
    cfg_path = os.path.join(tmp, "sdxl_turbo.yaml")
    save_config(cfg, cfg_path)
    if load_config(cfg_path) != cfg:
        raise AssertionError("the written config reads back otherwise")
    exp = os.path.join(tmp, "exp")
    cd = cfg.calib_data
    log(f"ptq flow: {PTQ_CONFIG} ({cfg.model.family}, "
        f"{cd.n_samples} prompts, batch {cd.batch_size}, {cd.n_steps} "
        f"step, {cfg.inference.height} px, W{cfg.quant.weight.n_bits}"
        f"A{cfg.quant.activation.n_bits}), files in {tmp}")

    gen = gen_calib_data.main(["--config", cfg_path])
    N, S, h = cd.n_samples, cd.n_steps, cfg.inference.height // 8
    shapes = {"xs": (S, N, h, h, 4), "ts": (S,),
              "outputs": (S, N, h, h, 4), "text_embs": (N, 77, 2048),
              "text_embeds": (N, 1280), "time_ids": (N, 6)}
    with np.load(cd.path) as f:
        got = {k: f[k].shape for k in f.files}
        finite = all(np.isfinite(f[k]).all() for k in f.files)
    if got != shapes or not finite:
        raise AssertionError(f"calib data {got} (finite {finite}), "
                             f"expected {shapes}")

    res = ptq.main(["--config", cfg_path, "--outdir", exp])
    qparams = res["qparams"]
    t0 = time.perf_counter()
    loaded = checkpoint.load_qparams(res["path"], device=dev)
    t_load = time.perf_counter() - t0
    split_names = sorted(n for n, q in loaded.items()
                         if q.w0_delta is not None)
    want_splits = sorted(conv_shortcut_splits(
        get_family(cfg.model.family).unet))
    bad = [n for n in qparams
           if n not in loaded or not qparams_bits_equal(qparams[n],
                                                        loaded[n])]
    twins = all(loaded[n].a0_delta is not None for n in split_names)
    if (set(loaded) != set(qparams) or bad or len(loaded) != PTQ_LAYERS
            or split_names != want_splits or not twins):
        raise AssertionError(
            f"qparams.msgpack: {len(loaded)} layers (in memory "
            f"{len(qparams)}), unequal {bad[:4]}, split layers "
            f"{split_names} (expected {want_splits}), twins {twins}")
    log(f"ptq flow: qparams.msgpack ({os.path.getsize(res['path'])} "
        f"bytes) reads back equal bit for bit: {len(loaded)} layers, "
        f"{len(split_names)} with split twins")

    out = quant_txt2img.main([
        "--base_path", exp, "--backend", "int8", "--fuse_qkv",
        "--n_images", "4", "--batch_size", "4",
        "--outdir", os.path.join(tmp, "images")])
    pipe_q, q_sec = out["pipe"], out["seconds"]
    ctx = dataclasses.replace(out["ctx"], attn_impl="auto")
    for path in out["paths"]:
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{path} is not a PNG")
    if len(out["paths"]) != 4:
        raise AssertionError(f"{len(out['paths'])} images, expected 4")
    cfg_unet = pipe_q.unet.config
    conv_split = sorted(n for n, e in ctx.deploy.items()
                        if e.kind == "conv_split")
    calls = pipeline.ctx_kernel_calls(cfg_unet, ctx)
    want = dict(TURBO_CALLS, qmatmul=TURBO_CALLS["qmatmul"]
                + PTQ_SPLIT_LAYERS)
    if conv_split != split_names or len(conv_split) != \
            PTQ_SPLIT_LAYERS or calls != want:
        raise AssertionError(f"split deploy: conv_split entries "
                             f"{conv_split}, launches {calls}, expected "
                             f"{want}")
    log(f"ptq flow: deploy of the loaded file: {len(ctx.deploy)} "
        f"entries, {len(conv_split)} conv_split; ctx_kernel_calls "
        f"qmatmul {calls['qmatmul']} a step (phase 3's deploy, no "
        f"splits: {TURBO_CALLS['qmatmul']})")

    # the bf16 pipeline of the same seed: FP reference and fp weights
    ref = build_pipeline(cfg, device=dev)
    with np.load(cd.path) as f:
        data = {k: f[k] for k in f.files}
    req = next(ptq.calib_batches_from_npz(data, 1, None, dev))
    _, launches = run_path(torch, ref.unet, [req], ctx,
                           "ptq flow split deploy")
    graphed = graphed_step_ms(torch, ref.unet, req,
                              (("bf16", FP_CTX), ("w8a8_splits", ctx)),
                              card, "ptq flow", profiled=("w8a8_splits",))
    log(f"ptq flow: graphed step ms, split deploy "
        f"{graphed['w8a8_splits']:.3f} against phase 3's deploy without "
        f"splits {turbo_graphed['auto']:.3f} (bf16 here "
        f"{graphed['bf16']:.3f}, phase 3 {turbo_graphed['bf16']:.3f}); "
        f"{card}")

    seen = record_layer_inputs(torch, ref.unet, req)
    wq, _, _ = specs_from_config(cfg)
    bad_ctx = deploy_unet_ctx(
        ref.unet, twins_swapped(loaded, split_names),
        uniform_ctrl(split_names), wq, bos_aware=False,
        splits=ref.splits)
    q_layers = quantizable_layers(pipe_q.unet)
    r_layers = quantizable_layers(ref.unet)
    sound, swapped = {}, {}
    with torch.inference_mode():
        for n in split_names:
            x, kw = seen[n]
            want_y = split_fake_quant(torch, r_layers[n], x, loaded[n],
                                      kw["split"])
            sig = want_y.pow(2).sum().item()
            for d, c, lay in ((sound, ctx, q_layers[n]),
                              (swapped, bad_ctx, r_layers[n])):
                err = (lay(x, c, **kw).float() - want_y).pow(2).sum()
                d[n] = 10 * math.log10(sig / err.item())
    log("ptq flow: each conv_split entry vs fake quantization (dB): "
        + ", ".join(f"{n} {sound[n]:.2f} / twins swapped "
                    f"{swapped[n]:.2f}" for n in split_names)
        + f" (gate {LAYER_SQNR_DB})")
    if min(sound.values()) < LAYER_SQNR_DB or \
            min(swapped.values()) >= LAYER_SQNR_DB:
        raise AssertionError(f"split entries {sound}, swapped {swapped}")

    prompts = BUILTIN_PROMPTS[:N_REQUESTS]
    engines = [ServingEngine(p, c, batch_size=len(prompts), steps=1,
                             guidance_scale=0.0)
               for p, c in ((ref, FP_CTX), (pipe_q, ctx))]
    args = engines[0].inputs(prompts, SERVE_SEED)
    added = [unet_added(torch, e, args) for e in engines]
    s = sqnr_db(added[0], added[1])
    log(f"ptq flow: what the W8A8 UNet (calibrated through the files, "
        f"with splits) adds in the Euler step vs bf16, B="
        f"{len(prompts)}: {s:.2f} dB (gate {MIN_SQNR_DB})")
    if s < MIN_SQNR_DB:
        raise AssertionError(f"ptq flow UNet SQNR {s:.2f} dB")
    del engines, pipe_q, out, seen

    params = os.path.join(tmp, "params.msgpack")
    free = shutil.disk_usage(tmp).free
    log(f"ptq flow: {free} bytes free in {tmp} before the params file")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_params(ref, params)
    t_save = time.perf_counter() - t0
    fd = os.open(params, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    t_sync = time.perf_counter() - t0
    size = os.path.getsize(params)
    fresh = Text2ImgPipeline("sdxl-turbo", ref.dtype, dev)
    t0 = time.perf_counter()
    checkpoint.load_params(fresh, params)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    imgs = [p(prompts, seed=SERVE_SEED, num_inference_steps=1,
              guidance_scale=0.0).images for p in (ref, fresh)]
    if imgs[0].shape != (len(prompts), 512, 512, 3) or \
            not np.isfinite(imgs[0]).all() or \
            not np.array_equal(imgs[0], imgs[1]):
        raise AssertionError("reloaded params give other images (max "
                             f"|d| {np.abs(imgs[0] - imgs[1]).max()})")
    log(f"ptq flow: params.msgpack {size} bytes: save_params "
        f"{t_save:.2f}s ({size / t_save / 1e9:.2f} GB/s into the page "
        f"cache), with fsync {t_sync:.2f}s ({size / t_sync / 1e9:.2f} "
        f"GB/s to the disk); load_params of the file just written "
        f"{t_read:.2f}s ({size / t_read / 1e9:.2f} GB/s, a warm page "
        "cache); the reloaded pipeline's images equal the original's "
        "bit for bit")
    sec = res["seconds"]
    log(f"ptq flow seconds: gen_calib_data {gen['seconds']:.2f}, "
        f"calibration ({len(loaded)} layers, "
        f"{N * S // cd.batch_size} batches) {sec['calibrate']:.2f}, "
        f"save_qparams + load_qparams {sec['save'] + t_load:.3f}, "
        f"deploy {q_sec['deploy']:.2f}; pipeline builds (random "
        f"weights) {sec['build']:.2f} (ptq), {q_sec['build']:.2f} "
        f"(quant_txt2img); {card}")
    os.remove(params)
    return {"ptq flow": launches}, exp, cd.path


@contextlib.contextmanager
def recorded_attention_kernels():
    """Within the block, every call of the UNet's attention kernels
    (``flash_attention``, ``int8_flash_attention``,
    ``int8qkv_flash_attention``) is appended to the yielded list as
    (kernel, sources, kwargs) and then runs."""
    from mixdq_tpu_torch.models import attention as mod

    names = ("flash_attention", "int8_flash_attention",
             "int8qkv_flash_attention")
    sound = {n: getattr(mod, n) for n in names}
    calls = []

    def recording(n):
        def fn(*srcs, **kw):
            calls.append((n, srcs, kw))
            return sound[n](*srcs, **kw)
        return fn

    for n in names:
        setattr(mod, n, recording(n))
    try:
        yield calls
    finally:
        for n, f in sound.items():
            setattr(mod, n, f)


def site_kernel_checks(torch, calls, drop=0):
    """Each recorded attention kernel call run again, its kernel against
    its plain version on the same sources by phase 1's rule
    (``flash_err``) and as SQNR; with ``drop`` the kernel reads all but
    the last ``drop`` keys. Returns [(kernel, 'Tq=.. Tk=..', error or
    the failure, dB)]."""
    from mixdq_tpu_torch.ops import attention

    out = []
    with torch.inference_mode():
        for n, srcs, kw in calls:
            q, k, v = srcs
            if drop:
                k, v = (k[:, :-drop].contiguous(), v[:, :-drop].contiguous())
            got = getattr(attention, n)(q, k, v, **kw)
            want = getattr(attention, n + "_plain")(*srcs, **kw)
            try:
                err = flash_err(torch, got, want)
            except AssertionError as e:
                err = e
            out.append((n, f"Tq={q.shape[1]} Tk={srcs[1].shape[1]}", err,
                        sqnr_db(want, got)))
    return out


def record_resnet_inputs(torch, unet, req):
    """{resnet block name: (x, temb, split)} of every ``ResnetBlock2D`` in
    one FP step."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.resnet import ResnetBlock2D

    seen = {}

    def hook(mod, args, kwargs):
        seen[mod.qname] = (args[0], args[1], kwargs.get("split", 0))

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in unet.modules() if isinstance(m, ResnetBlock2D)]
    try:
        pipeline.unet_step(unet, req)
    finally:
        for h in handles:
            h.remove()
    return seen


def resnet_sqnrs(torch, unet, ctx, seen, ref_ctx):
    """SQNR in dB of each resnet block under ``ctx`` against the block under
    ``ref_ctx``, teacher-forced on its FP-step input; the signal is what
    the block adds to its input (the whole output where the shortcut is a
    conv)."""
    out = {}
    with torch.inference_mode():
        for name, (x, temb, split) in sorted(seen.items()):
            blk = unet.get_submodule(name)
            got = blk(x, temb, ctx, split=split).float()
            ref = blk(x, temb, ref_ctx, split=split).float()
            base = x.float() if ref.shape == x.shape else 0
            err = (got - ref).pow(2).sum().item()
            out[name] = (math.inf if err == 0 else 10 * math.log10(
                (ref - base).pow(2).sum().item() / err))
    return out


def layer_inputs_without_residual(torch, unet, req):
    """``record_layer_inputs`` with each layer's ``residual`` dropped: the
    residual stream (max |x| ~128 at the 16x16 level on the towers'
    embeddings) rounds a bf16 output by more than a conv's own
    quantization error (conv2 entries read 20.5 dB against fake
    quantization with it, under int8_sec and pallas_dequant alike); no
    path quantizes it."""
    return {n: (x, {k: v for k, v in kw.items() if k != "residual"})
            for n, (x, kw) in record_layer_inputs(torch, unet, req).items()}


def scaled_delta(ctx, name, factor, field="a_delta"):
    """The fake context ``ctx`` with layer ``name``'s act deltas (or
    ``field``) times ``factor``, its zero points kept."""
    import dataclasses

    qp = ctx.qparams[name]
    return dataclasses.replace(ctx, qparams={
        **ctx.qparams, name: qp.replace(**{field: getattr(qp, field)
                                           * factor})})


def module_sqnrs(torch, unet, fake, deploy, req):
    """SQNR in dB of every attention, feed-forward and resnet module
    under ``deploy`` against the module under ``fake``, each teacher-
    forced on its FP-step input."""
    seen = record_attention_inputs(torch, unet, req, ff=True)
    s = site_sqnrs(torch, unet, deploy, seen, ref_ctx=fake)
    s.update(resnet_sqnrs(torch, unet, deploy,
                          record_resnet_inputs(torch, unet, req), fake))
    return s


def module_kind(name):
    return ("resnet" if "resnets" in name
            else name.rsplit(".", 1)[-1].rstrip("0123456789"))


def log_modules(label, s):
    low = sorted(s.items(), key=lambda kv: kv[1])
    by_kind = {k: round(min(v for n, v in s.items() if module_kind(n) == k),
                        2) for k in sorted({module_kind(n) for n in s})}
    log(f"{label}: {len(s)} modules (dB): min {low[0][1]:.2f} median "
        f"{statistics.median(s.values()):.2f}, min by kind {by_kind}; "
        f"lowest {[(n, round(v, 2)) for n, v in low[:3]]}")
    return low


def module_gate(torch, unet, fake, deploy, req, label):
    """Every attention, feed-forward and resnet module of ``unet`` (the
    float32 copy: bf16 fake mode rounds each dequantized value to 8
    significant bits, about a code's worth far from the zero point, which
    no deploy does), teacher-forced on its FP-step input: fake
    quantization against the deploy (>= ``LAYER_SQNR_DB``); with
    ``FAKE_FAULT_LAYER``'s act delta doubled in the fake context its
    feed-forward module must fail."""
    low = log_modules(f"{label}, fake vs the {deploy.deploy_compute} "
                      f"deploy (gate {LAYER_SQNR_DB})",
                      module_sqnrs(torch, unet, fake, deploy, req))
    if low[0][1] < LAYER_SQNR_DB:
        raise AssertionError(f"{label}: module {low[0][0]} {low[0][1]} dB "
                             f"< {LAYER_SQNR_DB}")
    site = FAKE_FAULT_LAYER[:FAKE_FAULT_LAYER.index(".ff.") + 3]
    seen = record_attention_inputs(torch, unet, req, ff=True)
    f = site_sqnrs(torch, unet, deploy, seen, [site],
                   ref_ctx=scaled_delta(fake, FAKE_FAULT_LAYER, 2.0))[site]
    log(f"{label}: module {site} with {FAKE_FAULT_LAYER}'s act delta "
        f"doubled in the fake context: {f:.2f} dB")
    if f >= LAYER_SQNR_DB:
        raise AssertionError(f"{label}: the module gate misses a doubled act "
                             "delta")


def step_gate(torch, unet, req, ref, ctx, label, fault_ctx):
    """One step of ``ctx`` against the bf16 step ``ref`` (>= ``MIN_SQNR_DB``)
    and of ``fault_ctx`` (< ``MIN_SQNR_DB``). Returns (output, dB)."""
    from mixdq_tpu_torch import pipeline

    out = pipeline.unet_step(unet, req, ctx)
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad output {out.shape}")
    s = sqnr_db(ref, out)
    f = sqnr_db(ref, pipeline.unet_step(unet, req, fault_ctx))
    log(f"{label} vs bf16: {s:.2f} dB; with its planted fault {f:.2f} dB "
        f"(gate {MIN_SQNR_DB})")
    if s < MIN_SQNR_DB or f >= MIN_SQNR_DB:
        raise AssertionError(f"{label}: {s:.2f} dB, fault {f:.2f} dB, gate "
                             f"{MIN_SQNR_DB}")
    return out, s


def explicit_sites(torch, unet, ctx, req, impl, fault_tk=(77, 256)):
    """The explicit ``attn_impl`` step of ``ctx``: every site's kernel
    (recorded) against its plain version on the same sources by phase 1's
    rule; the kernel reading all but the last ``FLASH_DROPPED_KEYS`` keys
    must fail at the first site of each key count in ``fault_tk`` (the
    cross-attention's 77 text tokens, SDXL-Turbo's 16x16 self-attention at
    Tq = Tk = 256). Returns the context."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models import routing

    c = dataclasses.replace(ctx, attn_impl=impl)
    with recorded_attention_kernels() as calls:
        pipeline.unet_step(unet, req, c)
    kernel = routing.EXPLICIT_ATTN[impl]
    sites = 2 * sum(1 for n, _ in unet.named_modules()
                    if n.endswith(".attn1"))
    if len(calls) != sites or {n for n, _, _ in calls} != {kernel}:
        raise AssertionError(f"{impl}: {len(calls)} kernel calls "
                             f"({ {n for n, _, _ in calls} }), expected "
                             f"{sites} of {kernel}")
    checks = site_kernel_checks(torch, calls)
    bad = [(sh, str(e)) for _, sh, e, _ in checks
           if isinstance(e, AssertionError)]
    shapes = collections.Counter(sh for _, sh, _, _ in checks)
    errs = [e for _, _, e, _ in checks if not isinstance(e, AssertionError)]
    log(f"{impl}: {len(checks)} sites ({dict(shapes)}) kernel vs plain: "
        f"max |diff| {max(errs, default=float('nan'))}, min "
        f"{min(d for *_, d in checks):.2f} dB, {len(bad)} off")
    if bad:
        raise AssertionError(f"{impl}: sites off their plain version: "
                             f"{bad[:3]}")
    picks = [next(i for i, (_, srcs, _) in enumerate(calls)
                  if srcs[1].shape[1] == T) for T in fault_tk]
    faulted = site_kernel_checks(torch, [calls[i] for i in picks],
                                 drop=FLASH_DROPPED_KEYS)
    log(f"{impl}: with the last {FLASH_DROPPED_KEYS} keys dropped: "
        + "; ".join(f"{sh} {d:.2f} dB, "
                    f"{'fails' if isinstance(e, AssertionError) else 'PASSES'}"
                    for _, sh, e, d in faulted))
    if not all(isinstance(e, AssertionError) for _, _, e, _ in faulted):
        raise AssertionError(f"{impl}: the site check misses dropped keys")
    return c


def phase_fake_turbo(torch, dev, card, exp, calib_path):
    """SDXL-Turbo 512 px at full width, random weights from seed 0, on
    phase 10's files (``exp``: its experiment directory, ``calib_path``:
    its calibration data): the W8A8 fake step through ``quant_txt2img
    --backend fake``, the q/k/v/softmax quantizers, mixed fake, the
    explicit attention kernels and ``deploy_compute='int8'`` (module
    docstring, phase 11). Returns {path: launches of one step}."""
    import dataclasses

    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.unet import UNet2DConditionModel
    from mixdq_tpu_torch.quant import bitmaps
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.core import QuantSpec
    from mixdq_tpu_torch.quant.deploy import (deploy_unet_ctx,
                                              layer_bits_from_ctrl,
                                              unpack_packed_entries)
    from mixdq_tpu_torch.quant.state import (FP_CTX, QuantCtx,
                                             quantizable_layers,
                                             uniform_ctrl)
    from mixdq_tpu_torch.scripts import ptq, quant_txt2img

    launches = {}
    # -- SDXL-Turbo 512 px, W8A8 fake through quant_txt2img --backend fake
    t0 = time.time()
    out = quant_txt2img.main([
        "--base_path", exp, "--n_images", "1", "--batch_size", "1",
        "--outdir", os.path.join(os.path.dirname(exp), "images_fake")])
    for path in out["paths"]:
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{path} is not a PNG")
    pipe, fake = out["pipe"], out["ctx"]
    unet = pipe.unet
    if fake.mode != "fake" or fake.qkv_quant or len(out["paths"]) != 1:
        raise AssertionError(f"quant_txt2img --backend fake: mode "
                             f"{fake.mode}, qkv_quant {fake.qkv_quant}")
    qparams, wq = fake.qparams, fake.wq
    with np.load(calib_path) as f:
        data = {k: f[k] for k in f.files}
    req = next(ptq.calib_batches_from_npz(data, 1, None, dev))
    sec = dataclasses.replace(deploy_unet_ctx(
        unet, qparams, fake.ctrl, wq, bos_aware=fake.bos_aware,
        fuse_qkv=True, splits=pipe.splits), attn_impl="auto")
    sec_e = dataclasses.replace(sec, attn_impl="einsum")
    ctx8 = deploy_unet_ctx(unet, qparams, fake.ctrl, wq,
                           bos_aware=fake.bos_aware, fuse_qkv=True,
                           splits=pipe.splits, deploy_compute="int8")
    torch.cuda.synchronize()
    log(f"phase 11: quant_txt2img --backend fake on phase 10's files "
        f"({out['seconds']['generate']:.2f}s for one image) and the deploys "
        f"of its qparams (int8_sec, int8): {time.time() - t0:.1f}s")
    for c in (fake, sec, ctx8):  # warm-up outside the counts
        pipeline.unet_step(unet, req, c)
    (y_fake,), launches["sdxl-turbo fake"] = run_path(
        torch, unet, [req], fake, "sdxl-turbo fake")
    if any(launches["sdxl-turbo fake"].values()):
        raise AssertionError("a 512 px fake step launched a kernel")
    ref = pipeline.unet_step(unet, req)
    y_sec = pipeline.unet_step(unet, req, sec)
    step_gate(torch, unet, req, ref, fake, "sdxl-turbo W8A8 fake",
              scaled_delta(fake, STEP_FAULT_LAYER, 1 / 64, "w_delta"))
    log(f"sdxl-turbo W8A8 fake vs the int8_sec deploy of the same qparams: "
        f"{sqnr_db(y_sec, y_fake):.2f} dB; int8_sec vs bf16 "
        f"{sqnr_db(ref, y_sec):.2f} dB")
    for d in (ctx8, sec_e):  # bf16: logged
        log_modules(f"sdxl-turbo W8A8 fake, bf16, vs the {d.deploy_compute} "
                    "deploy (logged)", module_sqnrs(torch, unet, fake, d, req))
    unet32 = UNet2DConditionModel(unet.config, torch.float32, dev).eval()
    unet32.load_state_dict(unet.state_dict())
    sample, t, ehs, added = req
    req32 = (sample.float(), t, ehs.float(),
             {k: v.float() for k, v in added.items()})
    module_gate(torch, unet32, fake, ctx8, req32,
                "sdxl-turbo W8A8 fake, float32 copy")
    del unet32, req32
    gc_cuda(torch)

    # -- the q/k/v/softmax act quantizers (einsum at every site)
    sm = QuantSpec(running_stat=True, always_zero=True)
    t0 = time.time()
    qp_sm = calibrate(unet, [req], pipeline.WQ, pipeline.AQ, softmax_aq=sm,
                      splits=pipe.splits)
    n_qact = sum(".act_quantizer_" in n for n in qp_sm)
    n_none = sum(".act_quantizer_" in n for n in calibrate(
        unet, [req], pipeline.WQ, pipeline.AQ, splits=pipe.splits))
    log(f"qkv_quant: calibration with the softmax spec {time.time() - t0:.1f}"
        f"s: {n_qact} act_quantizer_* entries (expected "
        f"{QKV_QUANT_ENTRIES}; without the spec, the planted fault: "
        f"{n_none})")
    if n_qact != QKV_QUANT_ENTRIES or n_none == QKV_QUANT_ENTRIES:
        raise AssertionError(f"qkv_quant: {n_qact} act quantizer entries")
    qkv = QuantCtx(mode="fake", qparams=qp_sm,
                   ctrl=uniform_ctrl(sorted(qp_sm)), bos_aware=True,
                   qkv_quant=True, softmax_aq=sm, attn_impl="auto")
    (y_qkv,), launches["sdxl-turbo fake qkv"] = run_path(
        torch, unet, [req], qkv, "sdxl-turbo fake qkv_quant")
    y_w8 = pipeline.unet_step(unet, req, dataclasses.replace(
        qkv, qkv_quant=False, softmax_aq=None))
    log(f"sdxl-turbo fake with q/k/v/softmax quantizers vs W8A8 fake "
        f"without them: {sqnr_db(y_w8, y_qkv):.2f} dB; vs bf16 "
        f"{sqnr_db(ref, y_qkv):.2f} dB")
    del qp_sm, qkv

    # -- mixed precision fake (configs/mp/sdxl_turbo + act-protect)
    wmap = bitmaps.load_bit_map(os.path.join(MP_DIR, "final_config",
                                             "weight", "5.04.yaml"))
    amap = bitmaps.load_bit_map(os.path.join(MP_DIR, "final_config", "act",
                                             "7.43.yaml"))
    protect = bitmaps.load_layer_list(os.path.join(MP_DIR,
                                                   "act_protect.yaml"))
    mctrl = pipeline.mixed_ctrl(unet, wmap, amap, protect)
    mfake = dataclasses.replace(fake, ctrl=mctrl)
    mdep = deploy_unet_ctx(unet, qparams, mctrl, wq, bos_aware=True,
                           fuse_qkv=True, pack_w4=True, splits=pipe.splits)
    mdep = dataclasses.replace(mdep, deploy=unpack_packed_entries(
        mdep.deploy), attn_impl="auto")
    y_m = pipeline.unet_step(unet, req, mfake)
    log(f"sdxl-turbo mixed fake (W5.04 / A7.43 + act-protect) vs bf16 "
        f"{sqnr_db(ref, y_m):.2f} dB, vs the int8_sec mixed deploy "
        f"{sqnr_db(pipeline.unet_step(unet, req, mdep), y_m):.2f} dB "
        "(logged: 28 W2 layers fake-clamp to [-2, 1], the deploy to "
        "[-8, 7])")
    bits = layer_bits_from_ctrl(mctrl)
    seen = layer_inputs_without_residual(torch, unet, req)
    layers = quantizable_layers(unet)
    names = [n for n, (wb, _) in sorted(bits.items()) if wb >= 4
             and mdep.deploy.get(n) is not None
             and mdep.deploy[n].kind != "fused_away"]
    bad_w = scaled_delta(mfake, MIXED_FAULT_LAYER, 0.5, "w_delta")
    if bits[MIXED_FAULT_LAYER][0] != 4:
        raise AssertionError(f"{MIXED_FAULT_LAYER} is not a W4 layer")

    def entry_db(name, f_ctx):
        x, kw = seen[name]
        with torch.inference_mode():
            want = layers[name](x, f_ctx, **kw).float()
            got = layers[name](x, mdep, **kw).float()
        err = (got - want).pow(2).sum().item()
        return math.inf if err == 0 else 10 * math.log10(
            want.pow(2).sum().item() / err)

    es = {n: entry_db(n, mfake) for n in names}
    low = sorted(es.items(), key=lambda kv: kv[1])
    f = entry_db(MIXED_FAULT_LAYER, bad_w)
    log(f"sdxl-turbo mixed: {len(es)} W>=4 entries (of {len(bits)} "
        f"quantized layers), fake vs the deploy, each on its FP-step input "
        f"(dB): min {low[0][1]:.2f} median "
        f"{statistics.median(es.values()):.2f}, lowest "
        f"{[(n, round(v, 2)) for n, v in low[:3]]}; {MIXED_FAULT_LAYER} with "
        f"its weight delta halved in the fake context {f:.2f} (gate "
        f"{LAYER_SQNR_DB})")
    if low[0][1] < LAYER_SQNR_DB or f >= LAYER_SQNR_DB:
        raise AssertionError(f"mixed entries {low[:3]}, fault {f}")
    del mdep, mfake, bad_w, seen

    # -- explicit attention kernels on the int8_sec deploy
    t0 = time.time()
    ectxs = {}
    for impl in EXPLICIT_IMPLS:
        c = explicit_sites(torch, unet, sec, req, impl)
        pipeline.unet_step(unet, req, c)
        (y,), launches[f"sdxl-turbo {impl}"] = run_path(
            torch, unet, [req], c, f"sdxl-turbo attn_impl={impl}")
        log(f"sdxl-turbo attn_impl={impl} vs bf16 {sqnr_db(ref, y):.2f} dB, "
            f"vs auto {sqnr_db(y_sec, y):.2f} dB")
        ectxs[impl] = c

    log(f"phase 11 explicit attn_impl checks: {time.time() - t0:.1f}s")

    # -- deploy_compute='int8'
    t0 = time.time()
    (y8,), launches["sdxl-turbo int8"] = run_path(
        torch, unet, [req], ctx8, "sdxl-turbo deploy_compute=int8")
    e = ctx8.deploy[STEP_FAULT_LAYER]
    step_gate(torch, unet, req, ref, ctx8, "sdxl-turbo deploy_compute=int8",
              dataclasses.replace(ctx8, deploy={
                  **ctx8.deploy, STEP_FAULT_LAYER: e.replace(
                      scale=-e.scale)}))
    log(f"sdxl-turbo deploy_compute=int8 vs int8_sec: "
        f"{sqnr_db(y_sec, y8):.2f} dB")
    seen = layer_inputs_without_residual(torch, unet, req)
    names = [n for n, e in ctx8.deploy.items()
             if e.kind not in ("fused_away", "conv_split")]
    s = layer_sqnrs(torch, unet, ctx8, qparams, seen, names)
    low = sorted(s.items(), key=lambda kv: kv[1])
    f = layer_sqnrs(torch, unet, faulted_ctx(ctx8, FAULT_LAYERS[0]), qparams,
                    seen, [FAULT_LAYERS[0]])[FAULT_LAYERS[0]]
    log(f"deploy_compute=int8: {len(s)} entries vs fake quantization (dB): "
        f"min {low[0][1]:.2f} median {statistics.median(s.values()):.2f}; "
        f"lowest {[(n, round(v, 2)) for n, v in low[:3]]}; "
        f"{FAULT_LAYERS[0]} with its fault {f:.2f} (gate {LAYER_SQNR_DB})")
    if low[0][1] < LAYER_SQNR_DB or f >= LAYER_SQNR_DB:
        raise AssertionError(f"int8 compute entries {low[:3]}, fault {f}")
    log(f"phase 11 deploy_compute=int8 checks: {time.time() - t0:.1f}s")
    del seen

    # -- timings: eager and graphed, beside bf16 and int8_sec
    paths = (("bf16", FP_CTX), ("int8_sec", sec), ("fake", fake),
             *((impl, c) for impl, c in ectxs.items()), ("int8", ctx8))
    t0 = time.time()
    paired_step_ms(torch, unet, [req], paths, card, "phase 11 sdxl-turbo")
    graphed_step_ms(torch, unet, req, paths, card, "phase 11 sdxl-turbo",
                    profiled=("fake",))
    log(f"phase 11 sdxl-turbo timings: {time.time() - t0:.1f}s")
    return launches


def phase_fake_sdxl(torch, dev, card):
    """SDXL 1024 px, W8A8 fake under ``'auto'`` (``fake_quant_ctx``):
    ``FAKE_SDXL_CALLS`` in one eager step and at capture, the step against
    bf16 (with ``STEP_FAULT_LAYER``'s fault), each flash site against
    ``flash_attention_plain`` (failed by dropped keys), eager and graphed
    step ms beside bf16 and the int8_sec deploy of the same qparams.
    Returns {path: launches of one step}."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import FP_CTX

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sdxl", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sdxl", 1, 0, bf16, dev)
    fake = pipeline.fake_quant_ctx(unet, calib)
    sec = dataclasses.replace(deploy_unet_ctx(
        unet, fake.qparams, fake.ctrl, pipeline.WQ, fuse_qkv=True),
        attn_impl="auto")
    fp = dataclasses.replace(FP_CTX, attn_impl="auto")
    torch.cuda.synchronize()
    log(f"sdxl 1024 build + fake_quant_ctx + deploy: {time.time() - t0:.1f}s")
    if pipeline.ctx_kernel_calls(unet.config, fake) != FAKE_SDXL_CALLS:
        raise AssertionError("sdxl fake: the structure's launch counts "
                             "changed")
    req = pipeline.example_inputs("sdxl", 1, 200, bf16, dev)
    pipeline.unet_step(unet, req, fake)
    (_,), launches = run_path(torch, unet, [req], fake, "sdxl fake auto")
    ref = pipeline.unet_step(unet, req, fp)
    step_gate(torch, unet, req, ref, fake, "sdxl W8A8 fake auto",
              scaled_delta(fake, STEP_FAULT_LAYER, 1 / 64, "w_delta"))
    with recorded_attention_kernels() as calls:
        pipeline.unet_step(unet, req, fake)
    checks = site_kernel_checks(torch, calls)
    v = [d for *_, d in checks]
    bad = [sh for _, sh, e, _ in checks if isinstance(e, AssertionError)]
    log(f"sdxl fake: {len(checks)} flash sites "
        f"({dict(collections.Counter(sh for _, sh, _, _ in checks))}) vs "
        f"flash_attention_plain (dB): min {min(v):.2f} median "
        f"{statistics.median(v):.2f} (gate {FLASH_SITE_SQNR_DB}; off "
        f"flash_err {bad})")
    if len(checks) != FAKE_SDXL_CALLS["flash_attention"] or \
            min(v) < FLASH_SITE_SQNR_DB or bad:
        raise AssertionError(f"sdxl fake flash sites {v}, {bad}")
    f = site_kernel_checks(torch, calls[:1], drop=FLASH_DROPPED_KEYS)[0][3]
    log(f"sdxl fake flash site with its last {FLASH_DROPPED_KEYS} keys "
        f"dropped: {f:.2f} dB")
    if f >= FLASH_SITE_SQNR_DB:
        raise AssertionError("the sdxl fake flash site check misses dropped "
                             "keys")
    del calls, checks
    paths = (("bf16", fp), ("int8_sec", sec), ("fake", fake))
    paired_step_ms(torch, unet, [req], paths, card, "phase 11 sdxl")
    graphed_step_ms(torch, unet, req, paths, card, "phase 11 sdxl",
                    profiled=("fake",))
    return {"sdxl fake": launches}


def phase_fake(torch, dev, card, exp, calib_path):
    """Phase 11: ``phase_fake_turbo`` on phase 10's files, then
    ``phase_fake_sdxl``. Returns {path: launches of one step}."""
    launches = phase_fake_turbo(torch, dev, card, exp, calib_path)
    gc_cuda(torch)
    launches.update(phase_fake_sdxl(torch, dev, card))
    gc_cuda(torch)
    return launches


def negated_scale_ctx(ctx, name):
    """``ctx`` with entry ``name``'s output scale negated."""
    import dataclasses

    e = ctx.deploy[name]
    return dataclasses.replace(ctx, deploy={**ctx.deploy,
                                            name: e.replace(scale=-e.scale)})


def sqnr_gate(label, s, fault, gate):
    """``s`` (dB) must reach ``gate`` and its planted fault's ``fault``
    must not."""
    log(f"{label}: {s:.2f} dB; with its planted fault {fault:.2f} dB "
        f"(gate {gate})")
    if not (math.isfinite(s) and s >= gate) or fault >= gate:
        raise AssertionError(f"{label}: {s:.2f} dB, fault {fault:.2f} dB, "
                             f"gate {gate}")


def phase_bos(torch, dev, card, exp, tmp):
    """Phase 12a: ``quant_txt2img --backend int8 --fuse_qkv`` (BoS-aware)
    on phase 10's files: every cross-attention k/v entry's ``bos_out``
    against ``emb0 @ W_fp`` in f32 on the card (the empty prompt's first
    text token, the unquantized weights of a pipeline of the same seed;
    rel ``BOS_REL``, failed by the dequantized weight, the parent's
    fallback); one step of the deploy against bf16 (``MIN_SQNR_DB``,
    failed by ``conv_out``'s scale negated) and against the fallback
    deploy (logged); resident bytes with ``bos_out`` and with ``bos_w``.
    Returns (the reference pipeline, its UNet's int8 context under
    'auto', a calibration request)."""
    import dataclasses

    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.loader import build_pipeline
    from mixdq_tpu_torch.quant.deploy import _bos_targets, attach_bos_weights
    from mixdq_tpu_torch.quant.state import quantizable_layers
    from mixdq_tpu_torch.scripts import ptq, quant_txt2img
    from mixdq_tpu_torch.utils.config import load_config

    t0 = time.time()
    out = quant_txt2img.main([
        "--base_path", exp, "--backend", "int8", "--fuse_qkv",
        "--n_images", "1", "--batch_size", "1",
        "--outdir", os.path.join(tmp, "images_bos")])
    pipe_q, ctx = out["pipe"], out["ctx"]
    cfg = load_config(os.path.join(exp, "config.yaml"))
    ref = build_pipeline(cfg, device=dev)
    emb0 = ref.encode_prompt(ref.tokens([""]))[0][0, 0].float()
    layers = quantizable_layers(ref.unet)
    rel, fault = 0.0, math.inf
    targets = list(_bos_targets(ctx.deploy))
    with torch.inference_mode():
        for name, e, members in targets:
            w = torch.cat([layers[m].weight.float() for m in members], 1)
            want = emb0[None] @ w
            if e.bos_out is None or e.bos_w is not None:
                raise AssertionError(f"{name}: bos_out {e.bos_out is None}, "
                                     f"bos_w kept {e.bos_w is not None}")
            den = want.abs().max().item()
            rel = max(rel, (e.bos_out - want).abs().max().item() / den)
            dq = emb0[None] @ (e.codes().float() * e.w_delta()[None, :])
            fault = min(fault, (dq - want).abs().max().item() / den)
    log(f"bos: {len(targets)} cross-attention k/v entries carry bos_out; "
        f"max rel diff against emb0 @ W_fp (f32, the card) {rel:.3e}; the "
        f"dequantized weight's (the fallback) min rel diff {fault:.3e} "
        f"(gate {BOS_REL})")
    if len(targets) != BOS_ENTRIES or rel > BOS_REL or fault <= BOS_REL:
        raise AssertionError(f"bos_out: {len(targets)} entries, rel {rel}, "
                             f"fallback {fault}")
    fallback = dataclasses.replace(ctx, deploy=attach_bos_weights(
        {n: e.replace(bos_out=None) for n, e in ctx.deploy.items()}))
    sizes = {tag: resident_weight_bytes(pipe_q.unet, c.deploy)
             for tag, c in (("bos_out", ctx), ("bos_w", fallback))}
    log("bos: resident weight bytes (total, deploy) with bos_out "
        f"{sizes['bos_out']}, with bos_w (the fallback) {sizes['bos_w']}: "
        f"{sizes['bos_w'][0] - sizes['bos_out'][0]} bytes fewer")
    with np.load(cfg.calib_data.path) as f:
        data = {k: f[k] for k in f.files}
    req = next(ptq.calib_batches_from_npz(data, 1, None, dev))
    auto, fb_auto = (dataclasses.replace(c, attn_impl="auto")
                     for c in (ctx, fallback))
    ys = {tag: pipeline.unet_step(pipe_q.unet, req, c) for tag, c in (
        ("bos_out", auto), ("fallback", fb_auto),
        ("fault", negated_scale_ctx(auto, "conv_out")))}
    y_fp = pipeline.unet_step(ref.unet, req)
    sqnr_gate("bos: the int8 CLI's deploy (bos_out, auto) vs bf16",
              sqnr_db(y_fp, ys["bos_out"]), sqnr_db(y_fp, ys["fault"]),
              MIN_SQNR_DB)
    fb_fp, fb_bos = (sqnr_db(y, ys["fallback"]) for y in (y_fp,
                                                           ys["bos_out"]))
    log(f"bos: the fallback deploy vs bf16 {fb_fp:.2f} dB, vs the bos_out "
        f"deploy {fb_bos:.2f} dB ({time.time() - t0:.1f}s; {card})")
    del out, pipe_q, fallback, fb_auto
    # the deploy runs on the reference UNet too (the CLI's is pruned)
    return ref, auto, req, y_fp


def phase_banks(torch, unet, ctx, req, y_fp, card):
    """Phase 12b: the W8A8 auto step with the time-embedding bank and the
    cross-k/v bank each on and off (launches = ``ctx_kernel_calls``, the
    outputs equal bit for bit, failed by one time_emb_proj scale halved
    in the bank's context) and ``dequant_small_m=SMALL_M`` (launches,
    against bf16 >= ``MIN_SQNR_DB``, failed by ``conv_out``'s scale
    negated); every path graphed, paired. Returns {path: launches}."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.deploy import bank_members
    from mixdq_tpu_torch.quant.state import FP_CTX

    paths = {"banks default": ctx,
             "banks off": dataclasses.replace(ctx, linear_bank=False),
             "cross_kv on": dataclasses.replace(ctx, cross_kv=True),
             "cross_kv only": dataclasses.replace(ctx, linear_bank=False,
                                                  cross_kv=True),
             f"small_m {SMALL_M}": dataclasses.replace(
                 ctx, dequant_small_m=SMALL_M)}
    for c in paths.values():  # warm-up outside the counts
        pipeline.unet_step(unet, req, c)
    outs, launches = {}, {}
    for tag, c in paths.items():
        (outs[tag],), launches[f"sdxl-turbo {tag}"] = run_path(
            torch, unet, [req], c, f"sdxl-turbo {tag}")
    temb = sorted(bank_members(ctx.deploy, ".time_emb_proj",
                               unet.config.time_embed_dim))
    name = temb[0]
    e = ctx.deploy[name]
    fault = dataclasses.replace(ctx, deploy={
        **ctx.deploy, name: e.replace(scale=e.scale * 0.5)})
    fault_eq = torch.equal(pipeline.unet_step(unet, req, fault),
                           outs["banks default"])
    equal = {tag: torch.equal(outs[tag], outs["banks default"])
             for tag in ("banks off", "cross_kv on", "cross_kv only")}
    log(f"banks: outputs equal to the default's bit for bit {equal}; "
        f"{name}'s scale halved: equal {fault_eq}")
    if not all(equal.values()) or fault_eq:
        raise AssertionError(f"banks: {equal}, fault equal {fault_eq}")
    sm = paths[f"small_m {SMALL_M}"]
    sqnr_gate(f"small_m {SMALL_M} vs bf16", sqnr_db(y_fp, outs[
        f"small_m {SMALL_M}"]), sqnr_db(y_fp, pipeline.unet_step(
            unet, req, negated_scale_ctx(sm, "conv_out"))), MIN_SQNR_DB)
    graphed_step_ms(torch, unet, req, [("bf16", FP_CTX)] + [
        (tag.replace(" ", "_"), c) for tag, c in paths.items()], card,
        "banks and small_m", profiled=())
    return launches


def phase_search_cli(torch, exp, tmp, card):
    """Phase 12c: ``mixed_precision_search --which weight --target_bits
    SEARCH_TARGET --quick`` (8 quality and 8 content layers) on phase
    10's files: finite sweeps, a candidate, the elected map reloaded
    equal to the winner (failed by one changed layer), the sensitivity
    file's groups; ms per point. Returns its result."""
    from mixdq_tpu_torch.quant.bitmaps import load_bit_map
    from mixdq_tpu_torch.scripts import mixed_precision_search
    from mixdq_tpu_torch.utils.config import loads

    art = os.path.join(tmp, "mp_artifacts")
    r = mixed_precision_search.main([
        "--base_path", exp, "--which", "weight", "--target_bits",
        str(SEARCH_TARGET), "--quick", "--artifacts_dir", art])
    sc, sq = r["sens_content"], r["sens_quality"]
    vals = [v for s in (sc, sq) for vs in s.values() for v in vs]
    if len(sc) != 8 or len(sq) != 8 or not all(map(math.isfinite, vals)):
        raise AssertionError(f"sweeps: {len(sc)} content, {len(sq)} "
                             f"quality, finite {all(map(math.isfinite, vals))}")
    if not r["candidates"] or r["winner"] is None:
        raise AssertionError("mixed_precision_search: no candidate")
    got = load_bit_map(r["paths"]["config"])
    bad = dict(got, **{next(iter(got)): 3})
    with open(r["paths"]["sensitivity"]) as f:
        sens = loads(f.read())
    if got != r["winner"] or bad == r["winner"] or \
            sens["content"] != sc or sens["quality"] != sq:
        raise AssertionError("the written map or sensitivities read back "
                             "otherwise")
    sec = r["seconds"]
    log(f"search: {r['points']} sweep points (8 quality x 2 bits, 8 content"
        f" x 3 bits); SQNR sweep {sec['sqnr_sweep']:.2f}s "
        f"({1e3 * sec['sqnr_sweep'] / (2 * len(sq)):.1f} ms a point, B=8), "
        f"SSIM sweep {sec['ssim_sweep']:.2f}s "
        f"({1e3 * sec['ssim_sweep'] / (3 * len(sc)):.1f} ms a point, two "
        f"512 px images, the FP images' generation included), ILP "
        f"{sec['ilp']:.2f}s, election {sec['elect']:.2f}s over "
        f"{len(r['candidates'])} candidates (pixel MSE {r['mses']}), elected "
        f"{r['index']}, {r['achieved']:.3f} bits; set-up {sec['setup']:.2f}s;"
        f" the map reloads equal to the winner, one changed layer does not;"
        f" {card}")
    log("search sensitivities: content " + json.dumps(sc) + " quality "
        + json.dumps(sq))
    return r


def phase_ilp(torch, unet, req):
    """Phase 12d: the ILP at full width on the repo's logs: the weight log
    at 5.02 with the layer sizes of the SDXL-Turbo UNet (its shapes):
    five candidates, the one at k = 1.0 a solution of the problem
    ``final_config/weight/5.04.yaml`` solves (``ilp_same_problem``; at
    5.50 it is not), its layer agreement logged; the act log at its own
    target and at 7.43 with the act-protect list and sizes from a
    captured forward (agreement logged)."""
    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.mixed_precision import ilp
    from mixdq_tpu_torch.mixed_precision.reference_data import (
        compare_configs, load_act_protect, load_final_config)
    from mixdq_tpu_torch.quant.state import capture_acts
    from mixdq_tpu_torch.utils.config import loads

    def log_of(which):
        with open(os.path.join(MP_DIR, "sensitivity_log",
                               f"sensitivity_{which}.yaml")) as f:
            return loads(f.read())

    sizes = {n: int(np.prod(s))
             for n, s in pipeline._layer_shapes(unet.config)}
    frac = ilp.tensor_size_fractions(sizes)
    w = log_of("weight")
    t0 = time.time()
    cands = {t: ilp.metric_decoupled_allocation(
        w["content"], w["quality"], frac, t) for t in (SEARCH_TARGET, 5.5)}
    dt = time.time() - t0
    ref = load_final_config(os.path.join(MP_DIR, "final_config", "weight",
                                         "5.04.yaml"))
    ks = (0.7, 0.8, 0.9, 1.0, 1.1)
    agree = [compare_configs(c, ref, frac)["agree"]
             for c in cands[SEARCH_TARGET]]
    # the fault: the candidate of another target against this problem
    same = {t: ilp_same_problem(w, frac, SEARCH_TARGET, cands[t][3], ref)
            for t in cands}
    log(f"ilp (scipy {scipy_version()}): weight log at {SEARCH_TARGET}: "
        f"{len(cands[SEARCH_TARGET])} candidates in {dt / 2:.2f}s, "
        f"agreement with 5.04.yaml by k {dict(zip(ks, agree))}; k = 1.0 "
        f"against 5.04.yaml, per group (objective rel diff, achieved bits, "
        f"group target): {same[SEARCH_TARGET]}; the k = 1.0 candidate at "
        f"5.5 against that problem: {same[5.5]}")
    ok = {t: all(d <= ILP_REL_GAP and abs(b - tb) <= 0.02 + 1e-9
                 for d, b, tb in same[t].values()) for t in same}
    if len(cands[SEARCH_TARGET]) != 5 or len(ref) != 794 or \
            not ok[SEARCH_TARGET] or ok[5.5]:
        raise AssertionError(f"ilp: the k = 1.0 candidate at 5.02 does not "
                             f"solve 5.04.yaml's problem: {same}")
    log(f"ilp: the k = 1.0 candidate at {SEARCH_TARGET} equals 5.04.yaml on "
        f"{sum(cands[SEARCH_TARGET][3][n] == ref[n] for n in ref)} of "
        f"{len(ref)} layers")
    a = log_of("act")
    protect = set(load_act_protect(os.path.join(MP_DIR, "act_protect.yaml")))
    cap = capture_acts(unet, req, names=sorted(sizes))
    asizes = {n: int(np.prod(cap[n].shape)) if n in cap else 1
              for n in sizes}
    del cap
    afrac = ilp.tensor_size_fractions(asizes)
    aref = load_final_config(os.path.join(MP_DIR, "final_config", "act",
                                          "7.43.yaml"))
    sc = {n: v for n, v in a["content"].items() if n not in protect}
    sq = {n: v for n, v in a["quality"].items() if n not in protect}
    for t in (a["meta"]["target_avg_bits"], 7.43):
        cs = ilp.metric_decoupled_allocation(sc, sq, afrac, t)
        log(f"ilp: act log at {t} ({len(protect)} protected, sizes of a "
            "captured forward): agreement with final_config/act/7.43.yaml by "
            "k " + json.dumps({k: round(compare_configs(c, aref, afrac)[
                "agree"], 4) for k, c in zip(ks, cs)})
            + " (logged only)")


def scipy_version():
    import scipy

    return scipy.__version__


def ilp_same_problem(log, frac, target, cand, ref):
    """{group: (relative objective difference of ``cand`` and ``ref``,
    ``cand``'s size-weighted bits, the group's budget at k = 1.0)} for the
    content and quality groups of the weight log at ``target``: two
    solutions of one MILP agree in objective to HiGHS's relative MIP gap
    (``ILP_REL_GAP``) and both meet the +-0.02 budget band."""
    from mixdq_tpu_torch.mixed_precision import ilp

    content, quality = log["content"], log["quality"]
    fc = sum(frac[n] for n in content) / sum(frac[n] for n in frac)
    tc, tq = ilp.split_budget(target, fc, 1.0)
    out = {}
    for g, sens, bits, tb in (("content", content, (2, 4, 8), tc),
                              ("quality", quality, (4, 8), tq)):
        def obj(m):
            return sum(sens[n][bits.index(m[n])] for n in sens)
        o_c, o_r = obj(cand), obj(ref)
        out[g] = (abs(o_c - o_r) / abs(o_r),
                  ilp.achieved_avg_bits({n: cand[n] for n in sens}, frac), tb)
    return out


def phase_elected(torch, unet, req, y_fp, winner, card):
    """Phase 12e: the elected weight map deployed by ``quantize_mixed``
    under ``int8_sec`` (calibrated on ``req``), one graphed step:
    launches = ``ctx_kernel_calls`` at capture, against bf16 >=
    ``ELECTED_SQNR_DB`` (failed by ``conv_out``'s scale negated).
    Returns {path: launches of one step}."""
    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.quant.state import FP_CTX

    ctx = pipeline.quantize_mixed(unet, req, winner, {}, [])
    pipeline.unet_step(unet, req, ctx)
    (y,), launches = run_path(torch, unet, [req], ctx, "sdxl-turbo elected")
    sqnr_gate("the elected map (int8_sec, auto) vs bf16", sqnr_db(y_fp, y),
              sqnr_db(y_fp, pipeline.unet_step(
                  unet, req, negated_scale_ctx(ctx, "conv_out"))),
              ELECTED_SQNR_DB)
    graphed_step_ms(torch, unet, req, [("bf16", FP_CTX), ("elected", ctx)],
                    card,
                    "elected map", profiled=())
    log("elected map launches a step: "
        + json.dumps({k: v for k, v in launches.items() if v}))
    ops.reset_counts()
    return {"sdxl-turbo elected": launches}


def phase_quant_error(unet, exp, dev):
    """Phase 12f: ``quant_error --target weight --limit 16`` (each layer's
    weight SQNR rising with its bits; the first layer's 8-bit weight
    delta 32 times too large breaks the rise) and ``--target arch`` (794
    lines)."""
    from mixdq_tpu_torch.analysis.quant_error import weight_error
    from mixdq_tpu_torch.pipeline import WQ
    from mixdq_tpu_torch.quant.checkpoint import load_qparams
    from mixdq_tpu_torch.scripts import quant_error

    w = quant_error.main(["--base_path", exp, "--target", "weight",
                          "--limit", "16"])
    a = quant_error.main(["--base_path", exp, "--target", "arch"])
    res = w["result"]

    def rising(r):
        return all(v["sqnr"][0] < v["sqnr"][1] < v["sqnr"][2]
                   for v in r.values())
    name = next(iter(res))
    qp = load_qparams(os.path.join(exp, "qparams.msgpack"), device=dev)
    wd = qp[name].w_delta.clone()
    wd[2] *= 32
    bad = weight_error(unet, {name: qp[name].replace(w_delta=wd)}, [name],
                       WQ)
    lines = a["result"].splitlines()
    log(f"quant_error: {w['path']} ({len(res)} layers; weight SQNR at "
        "2/4/8 bits " + json.dumps({n: [round(x, 2) for x in v["sqnr"]]
                                    for n, v in list(res.items())[:4]})
        + f" ...), {a['path']} ({len(lines)} lines)")
    if len(res) != 16 or not rising(res) or rising(bad) or \
            len(lines) != PTQ_LAYERS or not os.path.isfile(w["path"]):
        raise AssertionError("quant_error: weight SQNR not rising with the "
                             "bits, or the files are wrong")


def phase_search(torch, dev, card, exp, tmp):
    """Phase 12: this slice's paths at full SDXL-Turbo width on phase 10's
    files (``phase_bos``, ``phase_banks``, ``phase_search_cli``,
    ``phase_ilp``, ``phase_elected``, ``phase_quant_error``). Returns
    {path: launches of one step}."""
    t0 = time.time()
    ref, ctx, req, y_fp = phase_bos(torch, dev, card, exp, tmp)
    launches = phase_banks(torch, ref.unet, ctx, req, y_fp, card)
    log(f"phase 12: bos and banks {time.time() - t0:.1f}s")
    del ctx
    gc_cuda(torch)
    r = phase_search_cli(torch, exp, tmp, card)
    gc_cuda(torch)
    phase_ilp(torch, ref.unet, req)
    launches.update(phase_elected(torch, ref.unet, req, y_fp, r["winner"],
                                  card))
    phase_quant_error(ref.unet, exp, dev)
    return launches


def inception_state_dict(torch, seed):
    """A torchvision-named ``Inception3`` state dict at full width, random
    from ``seed``: every conv of ``InceptionV3Features`` as OIHW
    (He-scaled) with its BatchNorm's weight, bias, running statistics and
    ``num_batches_tracked``, plus the ``fc`` head and an ``AuxLogits``
    conv, which the reader skips."""
    from mixdq_tpu_torch.models.inception import InceptionV3Features

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in InceptionV3Features(device="meta").named_parameters():
        if not name.endswith(".conv.weight"):
            continue
        kh, kw, ci, co = p.shape
        pre = name[:-len(".conv.weight")]
        sd[pre + ".conv.weight"] = torch.randn(
            co, ci, kh, kw, generator=g) * (2.0 / (kh * kw * ci)) ** 0.5
        sd[pre + ".bn.weight"] = torch.rand(co, generator=g) + 0.5
        sd[pre + ".bn.bias"] = torch.randn(co, generator=g) * 0.1
        sd[pre + ".bn.running_mean"] = torch.randn(co, generator=g) * 0.1
        sd[pre + ".bn.running_var"] = torch.rand(co, generator=g) + 0.5
        sd[pre + ".bn.num_batches_tracked"] = torch.tensor(1)
    sd["fc.weight"] = torch.randn(1000, 2048, generator=g) * 0.01
    sd["fc.bias"] = torch.zeros(1000)
    sd["AuxLogits.conv0.conv.weight"] = torch.randn(128, 768, 1, 1,
                                                    generator=g) * 0.05
    return sd


def clip_vision_state_dict(torch, dev, seed):
    """An HF ``CLIPVisionModelWithProjection`` state dict of ViT-L/14
    (``CLIPVisionConfig()``: 24 layers of 1024, projection 768), random
    from ``seed`` (drawn on the card, returned on the CPU): dense and
    embedding weights N(0, 0.02), biases 0, norm scales 1."""
    from mixdq_tpu_torch.models.configs import CLIPVisionConfig

    cfg = CLIPVisionConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    c, i, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    n_pos = (cfg.image_size // p) ** 2 + 1

    def r(*shape):
        return (torch.randn(*shape, generator=g, device=dev) * 0.02).cpu()
    pre = "vision_model."
    sd = {pre + "embeddings.class_embedding": r(c),
          pre + "embeddings.patch_embedding.weight": r(c, 3, p, p),
          pre + "embeddings.position_embedding.weight": r(n_pos, c),
          pre + "embeddings.position_ids": torch.arange(n_pos)[None],
          "visual_projection.weight": r(cfg.projection_dim, c)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{pre}{ln}.weight"], sd[f"{pre}{ln}.bias"] = (torch.ones(c),
                                                          torch.zeros(c))
    for li in range(cfg.num_layers):
        lp = f"{pre}encoder.layers.{li}."
        for proj in ("q", "k", "v", "out"):
            sd[lp + f"self_attn.{proj}_proj.weight"] = r(c, c)
            sd[lp + f"self_attn.{proj}_proj.bias"] = torch.zeros(c)
        sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = (
            r(i, c), torch.zeros(i))
        sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = (
            r(c, i), torch.zeros(c))
        for ln in ("layer_norm1", "layer_norm2"):
            sd[lp + ln + ".weight"], sd[lp + ln + ".bias"] = (
                torch.ones(c), torch.zeros(c))
    return sd


def read_png(path):
    """An 8-bit RGB PNG of unfiltered scanlines (``utils/images.py``'s)
    as uint8 ``[H, W, 3]``."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat = 8, b""
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            w, h = struct.unpack(">II", data[pos + 8:pos + 16])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return rows[:, 1:].reshape(h, w, 3)


def fid_scale(feats):
    """tr C of ``[N, D]`` features: a FID's scale."""
    import numpy as np

    return float(np.trace(np.cov(np.asarray(feats, np.float64).T)))


def counted_since_reset(label, want):
    """The launch counts read now (set to 0 just before the CLI ran) must
    be ``want``: every launch of the run accounted for."""
    from mixdq_tpu_torch import ops

    got = ops.launch_counts()
    if got != want or ops.call_counts() != got:
        raise AssertionError(f"{label}: launches since the reset {got}, "
                             f"calls {ops.call_counts()}, expected {want}")


def times_calls(calls, n):
    """``calls`` (launches by kernel) ``n`` times over."""
    return {k: v * n for k, v in calls.items()}


def report_ok(report, name):
    """Every key of the JAX script's report, in its order, the numbers
    finite."""
    fields = ["backend", "deploy_compute", "fuse_qkv", "w_bits"] + (
        ["config_weight_mp", "config_act_mp", "act_protect"]
        if name == "mp_sec" else [])
    return list(report) == fields + list(EVAL_KEYS) and all(
        math.isfinite(report[k]) for k in EVAL_KEYS)


def phase_evaluate(torch, exp, tmp, card):
    """Phase 13a: ``evaluate --matrix w8_int8,w8_sec,w4_sec,mp_sec`` on
    phase 10's files (``configs/mp/sdxl_turbo`` for ``mp_sec``), 4
    prompts at batch 2, with a random ViT-L/14 CLIP vision tower and a
    random Inception3 written as public state dicts (HF and torchvision
    names) and read by ``utils/torch_convert.py``. Gates: every report's
    keys in the JAX order, finite (failed by a NaN planted in a copy);
    each entry's launches = its ``ctx_kernel_calls`` x 2 UNet calls
    (counted by ``evaluate`` around the entry's generation, each context
    read through a patched ``evaluate.matrix_ctx``; failed by the
    w8_int8 entry's counts against w8_sec's); |FID(FP, FP)| within
    ``FID_SELF_REL`` of its scale, and the FID of a planted fault (a
    second run of w8_sec with ``conv_out``'s scale negated) above the
    sound w8_sec's and outside that limit. Logs the reports and the
    seconds. Returns {path: launches of one UNet call}."""
    import numpy as np

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.models.configs import get_family
    from mixdq_tpu_torch.scripts import evaluate
    from mixdq_tpu_torch.utils.fid import fid_from_features

    t0 = time.time()
    paths = {"inception": os.path.join(tmp, "inception3.pt"),
             "clip": os.path.join(tmp, "clip_vit_l14.pt")}
    torch.save(inception_state_dict(torch, EVAL_SEED), paths["inception"])
    torch.save(clip_vision_state_dict(torch, torch.device("cuda"),
                                      EVAL_SEED + 1), paths["clip"])
    t_write = time.time() - t0
    log(f"evaluate: random towers written ({t_write:.1f}s): Inception3 "
        f"{os.path.getsize(paths['inception'])} bytes, CLIP ViT-L/14 "
        f"{os.path.getsize(paths['clip'])} bytes")
    cfg_unet = get_family("sdxl-turbo").unet
    expect = {}
    matrix_ctx = evaluate.matrix_ctx

    def record(name, *args):
        fields, ctx = matrix_ctx(name, *args)
        expect[name] = pipeline.ctx_kernel_calls(cfg_unet, ctx)
        return fields, ctx

    def faulted(name, *args):
        fields, ctx = matrix_ctx(name, *args)
        return fields, negated_scale_ctx(ctx, "conv_out")
    final = os.path.join(MP_DIR, "final_config")
    argv = ["--base_path", exp, "--n_prompts", str(EVAL_PROMPTS),
            "--batch_size", str(EVAL_BATCH),
            "--config_weight_mp", os.path.join(final, "weight", "5.04.yaml"),
            "--config_act_mp", os.path.join(final, "act", "7.43.yaml"),
            "--act_protect", os.path.join(MP_DIR, "act_protect.yaml"),
            "--clip_vision_ckpt", paths["clip"],
            "--inception_ckpt", paths["inception"]]
    ops.reset_counts()
    with patched(evaluate, "matrix_ctx", record):
        ev = evaluate.main(argv + ["--matrix", ",".join(EVAL_MATRIX)])
    counted_since_reset("evaluate", {
        k: sum(ev["entries"][n]["launches"][k] for n in EVAL_MATRIX)
        for k in ev["entries"][EVAL_MATRIX[0]]["launches"]})
    launches = {}
    for name in EVAL_MATRIX:
        report, res = ev["reports"][name], ev["entries"][name]
        want = times_calls(expect[name], EVAL_UNET_CALLS)
        log(f"evaluate {name}: " + json.dumps(report) + "; seconds "
            + json.dumps({k: round(v, 2) for k, v in res["seconds"].items()})
            + "; launches " + json.dumps(
                {k: v for k, v in res["launches"].items() if v}))
        if not report_ok(report, name) or res["launches"] != want:
            raise AssertionError(f"evaluate {name}: report {report}, "
                                 f"launches {res['launches']}, expected "
                                 f"{want}")
        launches[f"evaluate {name}"] = {
            k: v // EVAL_UNET_CALLS for k, v in res["launches"].items()}
    bad = dict(ev["reports"]["w8_sec"], inception_fid=math.nan)
    wrong = times_calls(expect["w8_int8"], EVAL_UNET_CALLS)
    if report_ok(bad, "w8_sec") or \
            ev["entries"]["w8_sec"]["launches"] == wrong:
        raise AssertionError("evaluate: the planted report or launch fault "
                             "passed its gate")
    sec = ev["seconds"]
    log("evaluate seconds: " + json.dumps(
        {k: round(v, 2) for k, v in sec.items()}))
    with patched(evaluate, "matrix_ctx", faulted):
        bad_ev = evaluate.main(argv + ["--matrix", "w8_sec"])
    fp = ev["fp"]["features"]["inception"]
    scale = 2 * fid_scale(fp)
    self_fid = fid_from_features(fp, fp)
    sound = ev["reports"]["w8_sec"]["inception_fid"]
    fault = bad_ev["reports"]["w8_sec"]["inception_fid"]
    fault_scale = fid_scale(fp) + fid_scale(
        bad_ev["entries"]["w8_sec"]["features"]["inception"])
    log(f"evaluate FID: FP vs FP {self_fid:.4f} (scale tr C + tr C "
        f"{scale:.4f}, limit {FID_SELF_REL} of it); w8_sec "
        f"{sound:.4f}; the planted fault (conv_out's scale negated) "
        f"{fault:.4f} (its scale {fault_scale:.4f}); clip_fid w8_sec "
        f"{ev['reports']['w8_sec']['clip_fid']:.6f}, the fault's "
        f"{bad_ev['reports']['w8_sec']['clip_fid']:.6f}; fp images equal "
        f"across the two runs "
        f"{np.array_equal(ev['fp']['images'], bad_ev['fp']['images'])}")
    if abs(self_fid) > FID_SELF_REL * scale or not fault > sound or \
            abs(fault) <= FID_SELF_REL * fault_scale:
        raise AssertionError(f"evaluate FID: self {self_fid} (scale "
                             f"{scale}), w8_sec {sound}, fault {fault}")
    log(f"phase 13a: evaluate ok ({time.time() - t0:.1f}s; {card})")
    return launches


def phase_serve_bench(torch, exp, card):
    """Phase 13b: ``serve_bench --steps 10 --batch_size 4`` on phase 10's
    files: the JSON line's keys (the JAX script's), each engine's
    launches at capture = its path's launches x 10 steps (bf16 einsum:
    none; the W8A8 ``int8_sec`` deploy: ``ctx_kernel_calls``; failed by
    the counts of the same deploy without the time-embedding bank); the
    counts set to 0 just before the CLI and read just after must be the
    warm-up calls' and captures' (``counted_since_reset``). Returns
    {path: launches of one UNet step}."""
    import dataclasses

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.models.configs import get_family
    from mixdq_tpu_torch.pipelines import graphed
    from mixdq_tpu_torch.scripts import serve_bench

    t0 = time.time()
    ops.reset_counts()
    out = serve_bench.main(["--base_path", exp, "--steps",
                            str(SERVE_BENCH_STEPS), "--batch_size",
                            str(SERVE_BENCH_BATCH), "--rounds", "2"])
    cfg_unet = get_family("sdxl-turbo").unet
    res, ctx = out["result"], out["ctx"]

    want_fp = times_calls(pipeline.expected_kernel_calls(
        cfg_unet, "einsum", mode="fp"), SERVE_BENCH_STEPS)
    want_q = times_calls(pipeline.ctx_kernel_calls(cfg_unet, ctx),
                         SERVE_BENCH_STEPS)
    wrong = times_calls(pipeline.ctx_kernel_calls(
        cfg_unet, dataclasses.replace(ctx, linear_bank=False)),
        SERVE_BENCH_STEPS)
    got_fp, got_q = (out["engines"][k].launches for k in ("fp", "int8"))
    log("serve_bench: " + json.dumps(res) + "; rounds (fp, int8 ms) "
        + json.dumps([[round(a, 1), round(b, 1)] for a, b in out["rounds"]])
        + "; int8 engine launches at capture "
        + json.dumps({k: v for k, v in got_q.items() if v}))
    # each engine's warm-up calls and capture launch; its replays count
    # nothing
    counted_since_reset("serve_bench", times_calls(
        want_q, graphed.WARMUP + 1))
    if tuple(res) != SERVE_BENCH_KEYS or got_fp != want_fp or \
            got_q != want_q or got_q == wrong:
        raise AssertionError(f"serve_bench: keys {list(res)}, launches fp "
                             f"{got_fp} (expected {want_fp}), int8 {got_q} "
                             f"(expected {want_q})")
    log(f"phase 13b: serve_bench ok ({time.time() - t0:.1f}s; ssim_vs_fp "
        f"{res['ssim_vs_fp']}; {card})")
    return {"serve_bench int8": {k: v // SERVE_BENCH_STEPS
                                 for k, v in got_q.items()}}


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` replaced by ``fn`` inside the block (a CLI's
    inspection point or planted fault)."""
    keep = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, keep)


def phase_memory_compare(torch, card):
    """Phase 13c: ``memory_compare --batch 1 --json`` under ``--compute
    int8_sec`` (gate: the static saving >= ``MEM_STATIC_SAVING``, failed
    by the deploy with its fp weights not pruned) and under ``--compute
    dequant --pack_w4 --w_bits 4`` (logged)."""
    from mixdq_tpu_torch.scripts import memory_compare

    t0 = time.time()
    w8 = memory_compare.main(["--batch", "1", "--compute", "int8_sec",
                              "--json"])
    w4 = memory_compare.main(["--batch", "1", "--compute", "dequant",
                              "--pack_w4", "--w_bits", "4", "--json"])
    # the planted fault: deploys that keep the fp weights they replace
    with patched(memory_compare, "prune_deployed_weights",
                 lambda model, deploy: None):
        bad, _, _ = memory_compare.unet_mem("sdxl-turbo", 1,
                                            quant="int8_sec")
    s0 = w8["bf16"][0]
    log("memory_compare (MB, static / dynamic / peak at B = 1): bf16 "
        + json.dumps([round(v, 1) for v in w8["bf16"]]) + f", {w8['config']} "
        + json.dumps([round(v, 1) for v in w8["quant"]]) + f", {w4['config']} "
        + json.dumps([round(v, 1) for v in w4["quant"]]) + " (its bf16 run "
        + json.dumps([round(v, 1) for v in w4["bf16"]]) + "); static saving "
        f"{w8['static_saving']:.3f}x / {w4['static_saving']:.3f}x, peak "
        f"saving {w8['peak_saving']:.3f}x / {w4['peak_saving']:.3f}x; the "
        f"planted fault (not pruned) static {bad:.1f} MB, saving "
        f"{s0 / bad:.3f}x (gate {MEM_STATIC_SAVING}x)")
    if w8["static_saving"] < MEM_STATIC_SAVING or \
            s0 / bad >= MEM_STATIC_SAVING:
        raise AssertionError(f"memory_compare: static saving "
                             f"{w8['static_saving']}, fault {s0 / bad}")
    log(f"phase 13c: memory_compare ok ({time.time() - t0:.1f}s; {card})")


def phase_batch_sweep(torch, card):
    """Phase 13d: ``batch_sweep --batches 1,2,4,8`` (2 rounds, 2 replays
    of 2 chained steps): one JSON line a B with the JAX keys, each graph's
    launches at capture = its path's launches x 2 (bf16 ``'auto'``: none
    at 512 px; the W8A8 ``int8_sec`` ``'auto'`` deploy:
    ``ctx_kernel_calls``), and the counts since the reset just before the
    CLI its graphs' warm-ups and captures. Times logged, not gated.
    Returns {path: launches of one step}."""
    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.models.configs import get_family
    from mixdq_tpu_torch.pipelines import graphed
    from mixdq_tpu_torch.scripts import batch_sweep

    t0 = time.time()
    inner = 2
    ops.reset_counts()
    out = batch_sweep.main(["--batches", ",".join(map(str, SWEEP_BATCHES)),
                            "--rounds", "2", "--iters", "2", "--inner",
                            str(inner)])
    cfg_unet = get_family("sdxl-turbo").unet
    want_q = times_calls(pipeline.ctx_kernel_calls(cfg_unet, out["ctx"]),
                         inner)
    want_fp = times_calls(pipeline.expected_kernel_calls(
        cfg_unet, "auto", mode="fp"), inner)
    # the calibration (FP) launches none; each graph its warm-up calls
    # and capture
    counted_since_reset("batch_sweep", times_calls(
        want_q, len(SWEEP_BATCHES) * (graphed.WARMUP + 1)))
    for row in out["rows"]:
        log("batch_sweep: " + json.dumps(row))
        g = out["graphs"][row["B"]]
        if tuple(row) != SWEEP_KEYS or g["int8"].launches != want_q or \
                g["bf16"].launches != want_fp:
            raise AssertionError(f"batch_sweep B={row['B']}: {row}, "
                                 f"launches {g['int8'].launches}, expected "
                                 f"{want_q}")
    log(f"phase 13d: batch_sweep ok ({time.time() - t0:.1f}s; {card})")
    return {"batch_sweep int8": {k: v // inner for k, v in want_q.items()}}


def phase_txt2img_serve(torch, exp, tmp, card):
    """Phase 13e: ``txt2img`` (2 images at batch 2 from phase 10's config)
    and ``serve --backend int8`` (2 batches of 2): the PNGs read back and
    counted, txt2img's equal to the images it generated, the serving
    engine's launches at capture = ``ctx_kernel_calls`` of its deploy
    (one step), and the counts since the reset just before ``serve`` its
    warm-ups' and capture's; per-batch ms logged. Returns {path: launches
    of one step}."""
    import numpy as np

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.models.configs import get_family
    from mixdq_tpu_torch.pipelines import graphed
    from mixdq_tpu_torch.scripts import serve, txt2img

    t0 = time.time()
    fp = txt2img.main(["--config", os.path.join(exp, "config.yaml"),
                       "--outdir", os.path.join(tmp, "fp_images"),
                       "--n_images", "2", "--batch_size", "2"])
    got = np.stack([read_png(p) for p in fp["paths"]])
    want = (np.concatenate(fp["images"]) * 255).astype(np.uint8)
    if len(fp["paths"]) != 2 or not np.array_equal(got, want):
        raise AssertionError(f"txt2img: {len(fp['paths'])} PNGs, equal "
                             f"{np.array_equal(got, want)}")
    del fp
    gc_cuda(torch)
    ops.reset_counts()
    srv = serve.main(["--base_path", exp, "--backend", "int8",
                      "--batch_size", "2", "--n_batches", "2",
                      "--outdir", os.path.join(tmp, "serve_out")])
    eng = srv["engine"]
    want_calls = pipeline.ctx_kernel_calls(get_family("sdxl-turbo").unet,
                                           eng.ctx)
    counted_since_reset("serve", times_calls(want_calls,
                                             graphed.WARMUP + 1))
    shapes = {read_png(p).shape for p in srv["paths"]}
    log(f"serve --backend int8: {len(srv['paths'])} PNGs {shapes}, "
        f"compiled (captured) in {srv['compile_s']:.2f}s, batch ms "
        + json.dumps([round(v, 2) for v in srv["batch_ms"]])
        + f" (B = 2, deploy_compute {eng.ctx.deploy_compute}, attention "
        f"{eng.ctx.attn_impl})")
    if len(srv["paths"]) != 4 or shapes != {(512, 512, 3)} or \
            eng.launches != want_calls:
        raise AssertionError(f"serve: {len(srv['paths'])} PNGs {shapes}, "
                             f"launches {eng.launches}, expected "
                             f"{want_calls}")
    log(f"phase 13e: txt2img and serve ok ({time.time() - t0:.1f}s; {card})")
    return {"serve int8": dict(eng.launches)}


def entry_fields(e, prefix=""):
    """``{field: value}`` of a deploy entry, its split halves'
    prefixed."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if dataclasses.is_dataclass(v):
            out.update(entry_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def deploys_equal(torch, a, b):
    """The (layer, field) pairs where two deploy dicts differ (tensors
    compared bit for bit, with their dtypes)."""
    bad = [(n, None) for n in set(a) ^ set(b)]
    for n in set(a) & set(b):
        fa, fb = entry_fields(a[n]), entry_fields(b[n])
        for f in set(fa) | set(fb):
            x, y = fa.get(f), fb.get(f)
            if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
                same = (isinstance(x, torch.Tensor)
                        and isinstance(y, torch.Tensor)
                        and x.dtype == y.dtype and torch.equal(x, y))
            else:
                same = x == y and type(x) is type(y)
            if not same:
                bad.append((n, f))
    return bad


def phase_mesh_comfy(torch, dev, card, exp, tmp):
    """Phase 16 (see the module's docstring) on phase 10's experiment
    directory ``exp``; the container file goes to ``tmp``. Returns
    {path: launches of one generation}."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.comfyui import nodes
    from mixdq_tpu_torch.mixed_precision import sensitivity
    from mixdq_tpu_torch.parallel.mesh import make_mesh
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall
    from mixdq_tpu_torch.pipelines.loader import build_pipeline
    from mixdq_tpu_torch.pipelines.serving import ServingEngine
    from mixdq_tpu_torch.quant import checkpoint
    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl
    from mixdq_tpu_torch.runtime import tensorstore
    from mixdq_tpu_torch.scripts.mixed_precision_search import calib_batch
    from mixdq_tpu_torch.utils.config import load_config
    from mixdq_tpu_torch.utils.profiling import timeit
    from mixdq_tpu_torch.utils.prompts import BUILTIN_PROMPTS

    t_phase = time.time()
    cfg = load_config(os.path.join(exp, "config.yaml"))
    qp_path = os.path.join(exp, "qparams.msgpack")
    prompts = [BUILTIN_PROMPTS[0]]
    pipe = build_pipeline(cfg, device=dev)
    qparams = checkpoint.load_qparams(qp_path, device=dev)
    names = sorted(quantizable_layers(pipe.unet))
    ctrl = uniform_ctrl(names, w_bits=8, a_bits=8)
    ctx = dataclasses.replace(deploy_unet_ctx(
        pipe.unet, qparams, ctrl, pipeline.WQ, fuse_qkv=True,
        splits=pipe.splits), attn_impl="auto")
    cfg_unet = pipe.unet.config
    want = pipeline.ctx_kernel_calls(cfg_unet, ctx)
    launches = {}

    # (a) the mesh engine against the unsharded engine
    t0 = time.time()
    ref = ServingEngine(pipe, ctx, batch_size=1, steps=1,
                        guidance_scale=0.0).compile()
    img_ref = ref.generate(prompts, seed=MESH_SEED)
    mesh = make_mesh(1)
    if dist.get_backend() != "nccl" or tuple(mesh.shape) != (1, 1):
        raise AssertionError(f"mesh {mesh}: backend {dist.get_backend()}")
    ops.reset_counts()
    eng = ServingEngine(pipe, ctx, batch_size=1, steps=1,
                        guidance_scale=0.0, mesh=mesh).compile()
    img = eng.generate(prompts, seed=MESH_SEED)
    torch.cuda.synchronize()
    counted_since_reset("mesh engine", times_calls(want, 3))
    launches["mesh engine B=1"] = dict(eng.launches)
    if eng.launches != want or ref.launches != want:
        raise AssertionError(f"mesh engine: launches at capture "
                             f"{eng.launches}, unsharded {ref.launches}, "
                             f"expected {want}")
    if img.shape != (1, 512, 512, 3) or not np.isfinite(img).all() or \
            img.min() < 0 or img.max() > 1:
        raise AssertionError(f"mesh engine: bad images {img.shape}")
    if not np.array_equal(img, img_ref):
        raise AssertionError(f"mesh engine: images differ from the "
                             f"unsharded engine's (max |d| "
                             f"{np.abs(img - img_ref).max()})")
    if eng.ctx.deploy is not ctx.deploy or eng.ctx.batch_group is not None:
        raise AssertionError("mesh engine at (1, 1): the deploy was "
                             "sharded or a batch group set")
    ms = {k: timeit(e._graph.replay, iters=GRAPH_ITERS, warmup=0)
          for k, e in (("unsharded", ref), ("mesh", eng))}
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    log(f"phase 16a: mesh engine ({dist.get_backend()} world of "
        f"{dist.get_world_size()}, mesh {shape}) equals the unsharded "
        f"engine bit for bit, launches at capture equal "
        f"({sum(want.values())} a generation); graph replay ms unsharded "
        f"{ms['unsharded']:.3f} mesh {ms['mesh']:.3f} "
        f"({GRAPH_ITERS} replays, CUDA events, {card}); "
        f"{time.time() - t0:.1f}s")
    del ref, eng

    # (c) the deploy through the tensorstore container
    t0 = time.time()
    path = os.path.join(tmp, "deploy_w8a8.mixdq")
    t1 = time.perf_counter()
    tensorstore.save_deploy_ckpt(ctx.deploy, path)
    t_write = time.perf_counter() - t1
    t1 = time.perf_counter()
    back = tensorstore.load_deploy_ckpt(path, device=dev)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t1
    bad = deploys_equal(torch, ctx.deploy, back)
    if bad:
        raise AssertionError(f"tensorstore: fields differ after the round "
                             f"trip: {bad[:5]}")
    with np.load(cfg.calib_data.path) as f:
        data = {k: f[k] for k in f.files}
    (sample, t, ehs, added), fp_out = calib_batch(data, 1, dev)
    bctx = dataclasses.replace(ctx, deploy=back)
    steps = {}
    for tag, c in (("memory", ctx), ("file", bctx)):
        g = GraphedCall(lambda s, c=c: pipe.unet(s, t, ehs, added, ctx=c),
                        (sample,))
        if g.launches != want:
            raise AssertionError(f"tensorstore {tag}: launches at capture "
                                 f"{g.launches}, expected {want}")
        steps[tag] = g.replay().clone()
        del g
    if not torch.equal(steps["memory"], steps["file"]):
        raise AssertionError(
            f"tensorstore: the loaded deploy's graphed step differs "
            f"({sqnr_db(steps['memory'], steps['file']):.2f} dB)")
    size = os.path.getsize(path)
    log(f"phase 16c: tensorstore round trip of the W8A8 deploy "
        f"({len(back)} entries, {size / 1e9:.3f} GB): every field bit for "
        f"bit, the graphed step equal; write {t_write:.2f}s "
        f"({size / t_write / 1e9:.2f} GB/s), read (memory map, then to the "
        f"card) {t_read:.2f}s ({size / t_read / 1e9:.2f} GB/s; the file "
        f"just written: a warm page cache); {card}; "
        f"{time.time() - t0:.1f}s")
    os.remove(path)
    del back, bctx, steps

    # (d) the dp sweep against the sequential sweep
    t0 = time.time()
    args = (pipe.unet, qparams, list(MESH_SWEEP_LAYERS), names,
            (sample, t, ehs, added), fp_out, pipeline.WQ, pipeline.AQ)
    seq = sensitivity.sweep_sqnr(*args, bits=(4, 8))
    par = sensitivity.sweep_sqnr_batched(*args, bits=(4, 8),
                                         mesh=make_mesh(1))
    if par != seq or not all(math.isfinite(v) for vs in seq.values()
                             for v in vs):
        raise AssertionError(f"dp sweep {par} != sequential {seq}")
    log(f"phase 16d: sweep_sqnr_batched over a dp mesh equals the "
        f"sequential sweep value for value: {json.dumps(seq)}; "
        f"{time.time() - t0:.1f}s")
    dist.destroy_process_group()
    del pipe, ctx, qparams, sample, ehs, added, fp_out, data
    gc_cuda(torch)

    # (b) the ComfyUI chain
    t0 = time.time()
    (state,) = nodes.MixdqTPULoadPipeline().load("sdxl-turbo", "",
                                                 "bfloat16")
    (q,) = nodes.MixdqTPUQuantize().quantize(state, qp_path, "int8", 8, 8)
    p = q["pipe"]
    qctx = q["ctx"]
    cwant = pipeline.ctx_kernel_calls(p.unet.config, qctx)
    ops.reset_counts()
    (gen,) = nodes.MixdqTPUGenerate().generate(q, prompts[0], 1,
                                                COMFY_SEED)
    torch.cuda.synchronize()
    counted_since_reset("comfyui generate", cwant)
    launches["comfyui generate"] = cwant
    rctx = deploy_unet_ctx(p.unet, checkpoint.load_qparams(qp_path,
                                                           device=dev),
                           uniform_ctrl(names, w_bits=8, a_bits=8),
                           pipeline.WQ, splits=p.splits)
    if qctx.deploy_compute != "int8_sec":
        raise AssertionError(f"comfyui Quantize: {qctx.deploy_compute}")
    want_img = p(prompts, seed=COMFY_SEED, num_inference_steps=1,
                 ctx=rctx).images
    if tuple(gen.shape) != (1, 512, 512, 3) or gen.dtype != torch.float32 \
            or not np.array_equal(gen.numpy(), want_img):
        raise AssertionError(f"comfyui Generate {tuple(gen.shape)} differs "
                             f"from the pipeline's W8A8 image")
    (fp,) = nodes.MixdqTPUOriginGen().generate(q, prompts[0], 1, COMFY_SEED)
    want_fp = p(prompts, seed=COMFY_SEED, num_inference_steps=1).images
    if not np.array_equal(fp.numpy(), want_fp):
        raise AssertionError("comfyui OriginGen differs from the "
                             "pipeline's bf16 image")
    both, report = nodes.MixdqTPUIntegral().generate(q, prompts[0], 1,
                                                     COMFY_SEED)
    mse = float(((gen - fp) ** 2).mean())
    if not (torch.equal(both[:1], fp) and torch.equal(both[1:], gen)) or \
            report != f"pixel MSE quant vs FP: {mse:.6f}":
        raise AssertionError(f"comfyui Integral: {tuple(both.shape)}, "
                             f"{report!r} (MSE {mse})")
    log(f"phase 16b: ComfyUI Load -> Quantize(int8) -> Generate equals the "
        f"pipeline's W8A8 generation bit for bit ({sum(cwant.values())} "
        f"launches: {json.dumps({k: v for k, v in cwant.items() if v})}); "
        f"OriginGen the bf16 one; Integral: {report}; "
        f"{time.time() - t0:.1f}s")
    del state, q, p, qctx, rctx
    log(f"phase 16: {time.time() - t_phase:.1f}s")
    return launches


def phase_eval_clis(torch, dev, card, exp, tmp):
    """Phase 13: the search's evaluation half and the root CLIs on phase
    10's files, each through its ``main(argv)`` (``phase_evaluate``,
    ``phase_serve_bench``, ``phase_memory_compare``,
    ``phase_batch_sweep``, ``phase_txt2img_serve``). Returns {path:
    launches of one UNet step}."""
    t0 = time.time()
    launches = phase_evaluate(torch, exp, tmp, card)
    gc_cuda(torch)
    launches.update(phase_serve_bench(torch, exp, card))
    gc_cuda(torch)
    phase_memory_compare(torch, card)
    gc_cuda(torch)
    launches.update(phase_batch_sweep(torch, card))
    gc_cuda(torch)
    launches.update(phase_txt2img_serve(torch, exp, tmp, card))
    gc_cuda(torch)
    log(f"phase 13: {time.time() - t0:.1f}s")
    return launches


def trajectory_calib(torch, rec):
    """One calibration batch of every step of a captured trajectory
    (``Text2ImgPipeline(..., capture_trajectory=True)``): the S steps' UNet
    inputs stacked along the batch, each with its timestep and the text
    embedding."""
    S, B = rec.trajectory.shape[:2]
    return (rec.trajectory.flatten(0, 1),
            rec.timesteps.repeat_interleave(B),
            rec.text_emb.repeat(S, 1, 1), None)


def sd15_serving(torch, dev, card):
    """The LCM 4-step loop at full SD1.5 width (``ServingEngine``: CLIP-L,
    4 steps, g = 1, no CFG batch, the SD1.5 VAE to 512 px images), one
    captured CUDA graph a batch at B = 1 and 4, bf16 and the W8A8 UNet
    (calibrated on every step of the bf16 pipeline's own trajectory for
    four other prompts). Per engine: the launches counted at capture
    equal the UNet's ``ctx_kernel_calls`` times 4 (three times that over
    the warm-ups and the capture), the images finite, in [0, 1], equal to
    the eager ``run`` bit for bit and fixed by the seed; what the W8A8
    UNet adds to the latents against bf16 >= ``MIN_SQNR_DB`` (phase 9's
    gate), failed by conv_out's scale negated; ms a batch and images/s
    from graph replays. Returns {path: launches}."""
    import numpy as np

    from mixdq_tpu_torch import ops, pipeline
    from mixdq_tpu_torch.pipelines.serving import ServingEngine
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline
    from mixdq_tpu_torch.quant.state import FP_CTX
    from mixdq_tpu_torch.utils.profiling import timeit
    from mixdq_tpu_torch.utils.prompts import BUILTIN_PROMPTS

    bf16, S = torch.bfloat16, SD15_STEPS
    t0 = time.time()
    pipe = Text2ImgPipeline("sd15", bf16, dev).init_weights(0)
    rec = pipe(BUILTIN_PROMPTS[-4:], seed=SD15_SEED + 1,
               num_inference_steps=S, guidance_scale=1.0,
               capture_trajectory=True, decode=False)
    ctx = pipeline.quantize_w8a8(pipe.unet, trajectory_calib(torch, rec))
    unet_calls = pipeline.ctx_kernel_calls(pipe.unet.config, ctx)
    torch.cuda.synchronize()
    log(f"sd15 serving: pipeline built, UNet deployed W8A8 on {S} steps x "
        f"4 prompts ({len(ctx.deploy)} entries) in {time.time() - t0:.1f}s")
    variants = {"bf16": (FP_CTX, dict.fromkeys(unet_calls, 0)),
                "w8a8": (ctx, {k: S * v for k, v in unet_calls.items()})}
    launches, report, gates = {}, {}, []
    for B in SERVE_BATCHES:
        prompts = BUILTIN_PROMPTS[:B]
        added = {}
        for name, (c, want) in variants.items():
            label = f"sd15 serving {name} B={B}"
            ops.reset_counts()
            eng = ServingEngine(pipe, c, batch_size=B, steps=S,
                                guidance_scale=1.0).compile()
            img = eng.generate(prompts, seed=SD15_SEED)
            again = eng.generate(prompts, seed=SD15_SEED)
            other = eng.generate(prompts, seed=SD15_SEED + 2)
            torch.cuda.synchronize()
            launches[label] = ops.launch_counts()
            if eng.launches != want or launches[label] != {
                    k: 3 * v for k, v in want.items()}:
                raise AssertionError(f"{label}: launches at capture "
                                     f"{eng.launches}, in all "
                                     f"{launches[label]}, expected {want}")
            if img.shape != (B, 512, 512, 3) or not np.isfinite(img).all() \
                    or img.min() < 0 or img.max() > 1:
                raise AssertionError(f"{label}: bad images {img.shape}")
            if not np.array_equal(img, again) or np.array_equal(img, other):
                raise AssertionError(f"{label}: a seed does not fix the "
                                     "images")
            args = eng.inputs(prompts, SD15_SEED)
            if len(args) != 4 or args[3].shape[0] != S:
                raise AssertionError(f"{label}: no LCM noise of {S} steps")
            eager = eng.run(*args).float().cpu().numpy()
            if not np.array_equal(img, eager):
                raise AssertionError(
                    f"{label}: graphed images differ from the eager run "
                    f"(max |d| {np.abs(img - eager).max()})")
            added[name] = unet_added(torch, eng, args)
            reps = [timeit(eng._graph.replay, iters=GRAPH_ITERS, warmup=0)
                    for _ in range(SERVE_ROUNDS)]
            eager_ms = step_ms(torch, lambda: eng.run(*args))
            ms = statistics.median(reps)
            report[label] = dict(ms_per_batch=ms, images_per_s=B * 1e3 / ms,
                                 eager_ms=eager_ms)
            log(f"{label}: graph {ms:.3f} ms a batch ({S} LCM steps, "
                f"decode), {B * 1e3 / ms:.2f} images/s (median of "
                f"{SERVE_ROUNDS} rounds of {GRAPH_ITERS} replays); eager run "
                f"{eager_ms:.3f} ms; {card}")
            if B == 1:
                gw, gb, _ = profile_call(torch, eng._graph.replay,
                                         f"graph_sd15_serving_{name}",
                                         GRAPH_ITERS)
                log(f"{label}: graph replay wall {gw / GRAPH_ITERS:.3f} ms "
                    f"busy {gb / GRAPH_ITERS:.3f} ms idle "
                    f"{max(0.0, 1 - gb / gw):.3f}")
            del eng
        bad = ServingEngine(pipe, negated_scale_ctx(ctx, "conv_out"),
                            batch_size=B, steps=S, guidance_scale=1.0)
        try:
            sqnr_gate(f"sd15 serving B={B}: what the W8A8 UNet adds to the "
                      "latents vs bf16 (fault: conv_out's scale negated)",
                      sqnr_db(added["bf16"], added["w8a8"]),
                      sqnr_db(added["bf16"], unet_added(torch, bad, args)),
                      MIN_SQNR_DB)
        except AssertionError as e:
            gates.append(str(e))
    log(json.dumps({"sd15 serving": report}))
    if gates:
        raise AssertionError("; ".join(gates))
    return launches


def sd15_files(torch, dev, tmp):
    """The PTQ flow through files on ``configs/sd15_lcm.yaml`` as shipped
    but for its calibration data path (32 prompts, batch 4, the 4 LCM
    steps, W8A8, BoS-aware), the CLIs' ``main()`` in turn:
    ``gen_calib_data`` (npz keys and shapes), ``ptq`` (channel splits),
    ``quant_txt2img --backend int8 --fuse_qkv`` (PNGs); the qparams file
    read back equal bit for bit to those in memory (``SD15_LAYERS``
    layers, the up blocks' conv_shortcuts with split twins), and one
    eager step of the CLI's deploy under ``'auto'`` launching its
    ``ctx_kernel_calls`` (``run_path``). Returns {path: launches}."""
    import dataclasses

    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.models.configs import get_family
    from mixdq_tpu_torch.models.unet import conv_shortcut_splits
    from mixdq_tpu_torch.quant import checkpoint
    from mixdq_tpu_torch.scripts import gen_calib_data, ptq, quant_txt2img
    from mixdq_tpu_torch.utils.config import load_config, merge, save_config

    t0 = time.time()
    cfg = merge(load_config(SD15_CONFIG),
                {"calib_data": {"path": os.path.join(tmp, "calib.npz")}})
    cfg_path = os.path.join(tmp, "sd15_lcm.yaml")
    save_config(cfg, cfg_path)
    exp, cd = os.path.join(tmp, "exp"), cfg.calib_data
    gen_calib_data.main(["--config", cfg_path])
    N, S, h = cd.n_samples, cd.n_steps, cfg.inference.height // 8
    unet_cfg = get_family(cfg.model.family).unet
    shapes = {"xs": (S, N, h, h, 4), "ts": (S,), "outputs": (S, N, h, h, 4),
              "text_embs": (N, 77, unet_cfg.cross_attention_dim)}
    with np.load(cd.path) as f:
        got = {k: f[k].shape for k in f.files}
        finite = all(np.isfinite(f[k]).all() for k in f.files)
    if got != shapes or not finite:
        raise AssertionError(f"sd15 calib data {got} (finite {finite}), "
                             f"expected {shapes}")
    t_gen = time.time() - t0
    res = ptq.main(["--config", cfg_path, "--outdir", exp])
    qparams = res["qparams"]
    loaded = checkpoint.load_qparams(res["path"], device=dev)
    splits = sorted(n for n, q in loaded.items() if q.w0_delta is not None)
    want_splits = sorted(conv_shortcut_splits(unet_cfg))
    bad = [n for n in qparams
           if n not in loaded or not qparams_bits_equal(qparams[n],
                                                        loaded[n])]
    if (set(loaded) != set(qparams) or bad or len(loaded) != SD15_LAYERS
            or splits != want_splits):
        raise AssertionError(f"sd15 qparams.msgpack: {len(loaded)} layers, "
                             f"unequal {bad[:4]}, splits {splits}")
    t_ptq = time.time() - t0 - t_gen
    out = quant_txt2img.main([
        "--base_path", exp, "--backend", "int8", "--fuse_qkv",
        "--n_images", "4", "--batch_size", "4",
        "--outdir", os.path.join(tmp, "images")])
    for path in out["paths"]:
        with open(path, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"{path} is not a PNG")
    if len(out["paths"]) != 4:
        raise AssertionError(f"{len(out['paths'])} images, expected 4")
    ctx = dataclasses.replace(out["ctx"], attn_impl="auto")
    req = pipeline.example_inputs("sd15", 1, 400, torch.bfloat16, dev)
    _, launches = run_path(torch, out["pipe"].unet, [req], ctx,
                           "sd15 ptq flow")
    log(f"sd15 ptq flow: {SD15_CONFIG} ({N} prompts, batch "
        f"{cd.batch_size}, {S} steps): gen_calib_data {t_gen:.1f}s, ptq "
        f"{t_ptq:.1f}s ({len(loaded)} layers read back equal bit for bit, "
        f"{len(splits)} split), quant_txt2img "
        f"{time.time() - t0 - t_gen - t_ptq:.1f}s ({len(out['ctx'].deploy)} "
        "entries, 4 PNGs)")
    return {"sd15 ptq flow": launches}


def phase_sd15(torch, dev, card):
    """SD1.5 at 512 px, full width and depth (random weights from seed 0):
    the W8A8 deploy (``quantize_w8a8``: ``int8_sec``, fused QKV/KV,
    BoS-aware) under ``'auto'``, the bf16 UNet under ``'auto'`` (flash
    attention at d = 40), the mixed deploy of ``configs/mp/sd15`` (W5.02,
    A7.70, act-protect list) and ``int8_flash`` 'qk' / 'qkv': each path's
    launches equal ``ctx_kernel_calls`` (``SD15_CALLS``,
    ``SD15_INT8_CALLS``); SQNR against bf16 (W8A8 and int8 flash >=
    ``MIN_SQNR_DB``, mixed >= ``MP_SQNR_DB``; failed by conv_out's scale
    negated); the five bf16 flash sites against einsum (>=
    ``FLASH_SITE_SQNR_DB``, failed by dropped keys); every W8A8 attention
    module against einsum (``site_gate``) and the dropped-keys fault at a
    flash site; the int8 flash sites against the bf16 flash sites (failed
    by a doubled q scale); explicit ``attn_impl`` flash / int8_flash /
    int8qkv_flash at all 32 sites (d = 40 / 80 / 160, Tk = 77 too), each
    kernel against its plain version (failed by dropped keys) and each
    site against einsum (logged); graphed bf16 / W8A8 / mixed steps
    (replays equal eager steps, paired medians, profiled); then the LCM
    serving loop (``sd15_serving``) and the PTQ flow through files
    (``sd15_files``). Returns ({path: launches per step}, {path:
    launches})."""
    import dataclasses

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant import bitmaps
    from mixdq_tpu_torch.quant.state import FP_CTX

    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet("sd15", seed=0, dtype=bf16, device=dev)
    calib = pipeline.example_inputs("sd15", 1, 0, bf16, dev)
    ctx = pipeline.quantize_w8a8(unet, calib)
    wmap = bitmaps.load_bit_map(os.path.join(SD15_MP_DIR, "final_config",
                                             "weight", "5.02.yaml"))
    amap = bitmaps.load_bit_map(os.path.join(SD15_MP_DIR, "final_config",
                                             "act", "7.70.yaml"))
    protect = bitmaps.load_layer_list(os.path.join(SD15_MP_DIR,
                                                   "act_protect.yaml"))
    mctx = pipeline.quantize_mixed(unet, calib, wmap, amap, protect)
    fp_auto = dataclasses.replace(FP_CTX, attn_impl="auto")
    paths = (("bf16", fp_auto), ("auto", ctx), ("mixed", mctx),
             ("int8_qk", dataclasses.replace(ctx, int8_flash="qk")),
             ("int8_qkv", dataclasses.replace(ctx, int8_flash="qkv")))
    torch.cuda.synchronize()
    log(f"sd15 build+calibrate+deploy (W8A8, mixed): "
        f"{time.time() - t0:.1f}s, {len(ctx.deploy)} / {len(mctx.deploy)} "
        "deploy entries")
    want = {"auto": SD15_CALLS, "int8_qk": SD15_INT8_CALLS["qk"],
            "int8_qkv": SD15_INT8_CALLS["qkv"],
            "bf16": dict(_NONE,
                         flash_attention=SD15_CALLS["flash_attention"])}
    for tag, c in paths:
        got = pipeline.ctx_kernel_calls(unet.config, c)
        if tag in want and got != want[tag]:
            raise AssertionError(f"sd15 {tag}: ctx_kernel_calls {got}, "
                                 f"expected {want[tag]}")
    requests = [pipeline.example_inputs("sd15", 1, 300 + i, bf16, dev)
                for i in range(N_SD15_REQUESTS)]
    for _, c in paths:  # warm-up outside the counts
        pipeline.unet_step(unet, requests[0], c)
    outs, launches = {}, {}
    for tag, c in paths:
        outs[tag], launches[f"sd15 {tag}"] = run_path(
            torch, unet, requests, c, f"sd15 {tag}")
    log_igemm_shapes(torch, unet, requests[0], ctx, "sd15 auto")
    refs = [pipeline.unet_step(unet, r) for r in requests]
    conv_out = {tag: negated_scale_ctx(c, "conv_out") for tag, c in paths
                if tag != "bf16"}
    for tag, gate in (("auto", MIN_SQNR_DB), ("int8_qk", MIN_SQNR_DB),
                      ("int8_qkv", MIN_SQNR_DB), ("mixed", MP_SQNR_DB)):
        for i, (r, ref) in enumerate(zip(requests, refs)):
            x = outs[tag][i]
            if x.shape != ref.shape or not torch.isfinite(x).all():
                raise AssertionError(f"sd15 {tag}: bad output {x.shape}")
            sqnr_gate(f"sd15 {tag} vs bf16, request {i}", sqnr_db(ref, x),
                      sqnr_db(ref, pipeline.unet_step(unet, r,
                                                      conv_out[tag])), gate)
    log(f"sd15 SQNR bf16 auto (flash) vs bf16 einsum per request (dB): "
        f"{[round(sqnr_db(ref, x), 2) for ref, x in zip(refs, outs['bf16'])]}")
    paired_step_ms(torch, unet, requests, paths, card, "sd15")
    graphed_step_ms(torch, unet, requests[0],
                    (("bf16", fp_auto), ("auto", ctx), ("mixed", mctx)), card,
                    "sd15")
    req = requests[0]
    sites = phase_flash_sites(torch, unet, fp_auto, req, label="sd15")
    if len(sites) != SD15_CALLS["flash_attention"]:
        raise AssertionError(f"sd15 flash sites {sites}")
    # every W8A8 attention module against einsum; the planted fault: the
    # first flash site's to_out zero point shifted by 8 codes
    kernels = phase_attention_sites(torch, unet, ctx, req,
                                    fault_sites=(f"{sites[0]}.to_out.0",))
    if sorted(n for n, k in kernels.items()
              if k == "flash_attention") != sites:
        raise AssertionError(f"sd15 W8A8 flash sites {kernels}")
    phase_int8_flash_sites(torch, unet, ctx, req, label="sd15")
    seen = record_attention_inputs(torch, unet, req)
    for impl in EXPLICIT_IMPLS:
        c = explicit_sites(torch, unet, ctx, req, impl,
                           fault_tk=SD15_FAULT_TK)
        by_d = collections.defaultdict(list)
        for n, x in site_sqnrs(torch, unet, c, seen).items():
            d = pipeline._site_shape(unet.config, n.rpartition(".")[0])[2]
            by_d[d].append(x)
        log(f"sd15 explicit {impl} sites vs einsum (dB): " + "; ".join(
            f"d={d}: {len(v)}, min {min(v):.2f} median "
            f"{statistics.median(v):.2f}" for d, v in sorted(by_d.items())))
    t1 = time.time()
    del unet, ctx, mctx, paths, outs, refs, conv_out, seen, c, calib, req, \
        requests
    gc_cuda(torch)
    launches.update(sd15_serving(torch, dev, card))
    t2 = time.time()
    tmp = tempfile.mkdtemp(prefix="sd15_flow_")
    try:
        launches.update(sd15_files(torch, dev, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"sd15 phase: steps {t1 - t0:.1f}s, serving {t2 - t1:.1f}s, files "
        f"{time.time() - t2:.1f}s")
    per_step = {p: {k: v // (1 if p == "sd15 ptq flow" else
                             N_SD15_REQUESTS) for k, v in c.items()}
                for p, c in launches.items() if "serving" not in p}
    return per_step, launches


def cut_config(torch, base, tmp, tag):
    """``base`` cut to ``RECON_SAMPLES`` samples of one timestep in batches
    of one, its calibration data written in ``tmp`` from seed
    ``RECON_SEED`` (``example_inputs``: unit normal latents and text
    embeddings, as phase 3 calibrates; ``gen_calib_data``'s prompts go
    through the hash tokenizer, whose ids change with the process: on
    them the SD1.5 W8A8 step after ``--recon model --adaround`` read 21.18
    dB in one call and 13.73 in the next); returns (config, path)."""
    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.utils.config import load_config, merge, save_config

    cfg = merge(load_config(base), {"calib_data": {
        "path": os.path.join(tmp, f"{tag}_calib.npz"),
        "n_samples": RECON_SAMPLES, "n_steps": 1, "batch_size": 1}})
    path = os.path.join(tmp, f"{tag}.yaml")
    save_config(cfg, path)
    x, _, ehs, added = pipeline.example_inputs(
        cfg.model.family, RECON_SAMPLES, RECON_SEED, torch.float32, "cpu")
    data = {"xs": x[None].numpy(), "ts": np.array([999.0], np.float32),
            "outputs": np.zeros_like(x[None].numpy()),
            "text_embs": ehs.numpy()}
    if added is not None:
        data.update({k: v.numpy() for k, v in added.items()})
    np.savez(cfg.calib_data.path, **data)
    return cfg, path


def recon_cli(torch, cfg, path, exp, *opts):
    """``ptq --recon ...`` on config ``path``, its losses falling; logs its
    seconds and peak device memory and returns ptq's result."""
    from mixdq_tpu_torch.scripts import ptq

    gc_cuda(torch)
    torch.cuda.reset_peak_memory_stats()
    res = ptq.main(["--config", path, "--outdir", exp,
                    "--recon_iters", str(RECON_ITERS), *opts])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    n = cfg.calib_data.n_samples * cfg.calib_data.n_steps
    log(f"recon {' '.join(opts)} ({cfg.model.family}, {n} calibration "
        f"batch(es) of 1): losses {[round(v, 6) for v in losses]}; "
        f"{res['seconds']['recon']:.2f}s for {RECON_ITERS} iterations "
        f"({res['seconds']['recon'] / RECON_ITERS:.3f} s each, the FP "
        f"targets included), calibration {res['seconds']['calibrate']:.2f}s;"
        f" peak max_memory_allocated {peak / 2**30:.2f} GiB")
    falling_losses(f"recon {' '.join(opts)}", losses, RECON_ITERS)
    return res


def falling_losses(label, losses, n):
    """``n`` finite losses, the last below the first."""
    if len(losses) != n or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")


def w8a8_ctx(pipe, qparams, wq, alphas=None):
    """The W8A8 deploy of ``qparams`` (``int8_sec``, fused QKV/KV,
    BoS-aware, the pipeline's channel splits, ``alphas`` folded) under
    ``'auto'``."""
    import dataclasses

    from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    names = list(quantizable_layers(pipe.unet))
    return dataclasses.replace(deploy_unet_ctx(
        pipe.unet, qparams, uniform_ctrl(names), wq, fuse_qkv=True,
        splits={k: v for k, v in pipe.splits.items() if k in names},
        alphas=alphas), attn_impl="auto")


def deployed_step(torch, pipe, qparams, wq, req, label, alphas=None):
    """``w8a8_ctx``'s step: one eager step with the counts set to 0
    (``run_path``), a CUDA graph whose launches at capture are
    ``ctx_kernel_calls`` and whose replay equals the eager step, and its
    SQNR against bf16 (``MIN_SQNR_DB``, failed by conv_out's scale
    negated); with ``alphas``, the same qparams' nearest rounding logged
    beside. Returns the eager step's launches."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall

    unet = pipe.unet
    ctx = w8a8_ctx(pipe, qparams, wq, alphas)
    with torch.no_grad():
        (y,), launches = run_path(torch, unet, [req], ctx, label)
        sample, t, ehs, added = req
        g = GraphedCall(lambda x: unet(x, t, ehs, added, ctx=ctx), (sample,))
        want = pipeline.ctx_kernel_calls(unet.config, ctx)
        if g.launches != want or not torch.equal(g(sample), y):
            raise AssertionError(f"{label}: graph launches {g.launches} "
                                 f"(expected {want}) or replay != eager")
        ref = pipeline.unet_step(unet, req)
        fault = pipeline.unet_step(unet, req,
                                   negated_scale_ctx(ctx, "conv_out"))
        if alphas is not None:
            plain = pipeline.unet_step(unet, req, w8a8_ctx(pipe, qparams, wq))
            log(f"{label}: the same qparams deployed without the alphas "
                f"(nearest rounding) vs bf16: {sqnr_db(ref, plain):.2f} dB "
                "(logged)")
    sqnr_gate(f"{label}: W8A8 auto step vs bf16 (graph replay equals the "
              "eager step, launches at capture = ctx_kernel_calls)",
              sqnr_db(ref, y), sqnr_db(ref, fault), MIN_SQNR_DB)
    return launches


def w4_gate(torch, pipe):
    """``reconstruct`` (mode 'model', ``RECON_ITERS`` steps at lr
    ``RECON_W4_LR``) at W4A8 on one request (``example_inputs``: unit
    normal text embeddings, no BoS outlier; the reconstruction's fake
    context is not BoS-aware, as the JAX package's is not): the fake
    step's SQNR against bf16 must rise, and fall with the learning rate
    negated (the gradient's sign flipped, the planted fault)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.core import QuantSpec
    from mixdq_tpu_torch.quant.recon import reconstruct
    from mixdq_tpu_torch.quant.state import (QuantCtx, quantizable_layers,
                                             uniform_ctrl)

    unet = pipe.unet
    req = pipeline.example_inputs(pipe.family.name, 1, 0, torch.bfloat16,
                                  pipe.device)
    wq = QuantSpec(n_bits=RECON_W4_BITS, sym=True, channel_wise=True,
                   round_mode="nearest_ste")
    aq = QuantSpec(running_stat=True)
    qp = calibrate(unet, [req], wq, aq)
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=RECON_W4_BITS)

    def fake_sqnr(q):
        ctx = QuantCtx(mode="fake", qparams=q, ctrl=ctrl, wq=wq, aq=aq)
        with torch.no_grad():
            return sqnr_db(ref, pipeline.unet_step(unet, req, ctx))

    with torch.no_grad():
        ref = pipeline.unet_step(unet, req)
    before = fake_sqnr(qp)
    out = {}
    # the fault: Adam ascends the loss (torch's Adam takes no lr < 0)
    ascent = functools.partial(torch.optim.Adam, maximize=True)
    for tag, adam in (("sound", torch.optim.Adam), ("lr < 0", ascent)):
        gc_cuda(torch)
        t0 = time.time()
        losses = []
        with patched(torch.optim, "Adam", adam):
            qp_r = reconstruct(unet, qp, [req], wq, aq, mode="model",
                               iters=RECON_ITERS, lr=RECON_W4_LR,
                               losses=losses)
        out[tag] = fake_sqnr(qp_r)
        log(f"recon W{RECON_W4_BITS}A8 gate ({tag}, {RECON_ITERS} steps, "
            f"{time.time() - t0:.1f}s): fake step vs bf16 {before:.3f} -> "
            f"{out[tag]:.3f} dB; losses "
            f"{[round(float(v), 6) for v in losses]}")
    if not out["sound"] > before or not out["lr < 0"] < before:
        raise AssertionError(f"W{RECON_W4_BITS} recon gate: before "
                             f"{before}, after {out}")


def adaround_codes(torch, pipe, qparams, alphas):
    """The per-layer W8 deploy with ``alphas`` folded: every entry's codes
    (a split conv's two halves) equal the hard AdaRound fake-quant codes
    of its weight. Returns the number of entries held."""
    from mixdq_tpu_torch.quant.core import fake_quant_adaround
    from mixdq_tpu_torch.quant.deploy import build_deploy_params
    from mixdq_tpu_torch.quant.state import quantizable_layers

    layers = quantizable_layers(pipe.unet)
    splits = {k: v for k, v in pipe.splits.items() if k in layers}
    deploy = build_deploy_params(pipe.unet, qparams,
                                 {n: (8, 8) for n in layers},
                                 splits=splits, alphas=alphas)
    bi = 2  # W8
    bad = []
    for n, e in deploy.items():
        w, qp, a = layers[n].weight.detach(), qparams[n], alphas[n]
        parts = [(e, w, a, qp.w_delta[bi])]
        if e.kind == "conv_split":
            s = e.split
            parts = [(e.part0, w[:, :, :s], a[:, :, :s], qp.w_delta[bi]),
                     (e.part1, w[:, :, s:], a[:, :, s:], qp.w0_delta[bi])]
        for part, wp, ap, d in parts:
            hard = fake_quant_adaround(wp, d, torch.zeros_like(d), 8, ap,
                                       sym=True, hard=True)
            if not torch.equal(torch.round(hard.float() / d).to(torch.int8),
                               part.w_int):
                bad.append(n)
    if bad or len(deploy) != len(layers):
        raise AssertionError(f"AdaRound deploy codes differ from the hard "
                             f"fake-quant codes: {bad[:4]} ({len(bad)}); "
                             f"{len(deploy)} of {len(layers)} entries")
    return len(deploy)


def qat_steps(torch, dev):
    """``QAT_STEPS`` steps of ``make_qat_train_step`` (W8A8, lr
    ``QAT_LR``) on an f32 ``QAT_FAMILY`` UNet and one request
    (``example_inputs``, as ``w4_gate``'s), the target its FP output:
    every loss finite and the last below the first. Returns (losses,
    seconds a step)."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.calibrate import calibrate
    from mixdq_tpu_torch.quant.core import QuantSpec
    from mixdq_tpu_torch.quant.qat import make_qat_train_step
    from mixdq_tpu_torch.quant.state import quantizable_layers, uniform_ctrl

    unet = pipeline.build_unet(QAT_FAMILY, seed=0, dtype=torch.float32,
                               device=dev)
    batch = pipeline.example_inputs(QAT_FAMILY, 1, 0, torch.float32, dev)
    wq = QuantSpec(sym=True, channel_wise=True, round_mode="nearest_ste")
    aq = QuantSpec(running_stat=True)
    qparams = calibrate(unet, [batch], wq, aq)
    with torch.no_grad():
        target = pipeline.unet_step(unet, batch)
    init, step = make_qat_train_step(
        unet, wq, aq, uniform_ctrl(list(quantizable_layers(unet))), QAT_LR)
    params = dict(unet.named_parameters())
    opt = init(params, qparams)
    losses = []
    # cuDNN's weight-gradient convolutions are nondeterministic: the
    # losses wandered ~2 % from call to call; deterministic ones give the
    # card one trajectory
    cudnn = torch.backends.cudnn
    keep = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        for _ in range(QAT_STEPS):
            params, qparams, opt, loss = step(params, qparams, opt, batch,
                                              target)
            losses.append(float(loss))
    finally:
        cudnn.deterministic, cudnn.benchmark = keep
    sec = (time.time() - t0) / QAT_STEPS
    log(f"QAT ({QAT_FAMILY} f32, W8A8, lr {QAT_LR}): losses "
        f"{[round(v, 7) for v in losses]}, {sec:.2f}s a step")
    falling_losses("QAT", losses, QAT_STEPS)
    return losses, sec


_ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float16": "F16",
              "torch.float32": "F32"}


def write_safetensors(torch, path, tensors):
    """``{name: CPU tensor}`` as a ``.safetensors`` file (the card has no
    ``safetensors`` package): the header's length, the JSON header, the
    bytes in order. Returns the file's size."""
    import struct

    header, off = {}, 0
    for n, t in tensors.items():
        nb = t.numel() * t.element_size()
        header[n] = {"dtype": _ST_DTYPES[str(t.dtype)],
                     "shape": list(t.shape), "data_offsets": [off, off + nb]}
        off += nb
    h = json.dumps(header, separators=(",", ":")).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)))
        f.write(h)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy())
    return 8 + len(h) + off


def hf_unet_state_dict(torch, unet):
    """The UNet's weights in diffusers' names and layouts (OIHW convs,
    ``[out, in]`` linears), on the host."""
    out = {}
    for n, p in unet.state_dict().items():
        p = p.detach()
        if p.ndim == 4:
            p = p.permute(3, 2, 0, 1)
        elif p.ndim == 2:
            p = p.T
        out[n] = p.contiguous().cpu()
    return out


def convert_round_trip(torch, dev, tmp):
    """The seed-0 ``CONVERT_FAMILY`` UNet (bf16) written as a diffusers
    ``.safetensors`` file, ``convert_checkpoints --mode unet``, then
    ``load_module_params`` into a UNet of seed 1: every weight equal bit
    for bit to seed 0's, and the bf16 step too."""
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant.checkpoint import load_module_params
    from mixdq_tpu_torch.scripts import convert_checkpoints

    unet = pipeline.build_unet(CONVERT_FAMILY, seed=0, dtype=torch.bfloat16,
                               device=dev)
    req = pipeline.example_inputs(CONVERT_FAMILY, 1, 0, torch.bfloat16, dev)
    st = os.path.join(tmp, "diffusion_pytorch_model.safetensors")
    mp = os.path.join(tmp, "unet.msgpack")
    t0 = time.time()
    size = write_safetensors(torch, st, hf_unet_state_dict(torch, unet))
    t1 = time.time()
    res = convert_checkpoints.main(["--mode", "unet", "--input", st,
                                    "--output", mp])
    n = res["n"]
    del res
    t2 = time.time()
    other = pipeline.build_unet(CONVERT_FAMILY, seed=1,
                                dtype=torch.bfloat16, device=dev)
    load_module_params(other, mp)
    torch.cuda.synchronize()
    t3 = time.time()
    want = unet.state_dict()
    bad = [k for k, v in other.state_dict().items()
           if not torch.equal(v, want[k])]
    with torch.no_grad():
        y0, y1 = (pipeline.unet_step(m, req) for m in (unet, other))
    if bad or len(want) != n or not torch.equal(y0, y1):
        raise AssertionError(f"converted UNet: {len(bad)} weights differ "
                             f"({bad[:3]}), {n} tensors of {len(want)}, "
                             f"step equal {torch.equal(y0, y1)}")
    log(f"converters: {CONVERT_FAMILY} UNet ({n} tensors) -> .safetensors "
        f"{size} bytes in {t1 - t0:.2f}s; convert_checkpoints --mode unet "
        f"-> {os.path.getsize(mp)} bytes in {t2 - t1:.2f}s; "
        f"load_module_params {t3 - t2:.2f}s; every weight and the bf16 "
        "step equal seed 0's bit for bit")
    os.remove(st)
    os.remove(mp)


def phase_recon(torch, dev, card):
    """Phase 15 (see the module docstring). Returns {path: launches}."""
    import numpy as np

    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.pipelines.loader import (build_pipeline,
                                                  specs_from_config)
    from mixdq_tpu_torch.quant.checkpoint import load_qparams
    from mixdq_tpu_torch.scripts import ptq
    from mixdq_tpu_torch.utils.msgpack import unpack

    launches, t0 = {}, time.time()
    tmp = tempfile.mkdtemp(prefix="recon_")
    try:
        # 15a: --recon layer at SDXL-Turbo width, deployed W8A8
        cfg, path = cut_config(torch, RECON_TURBO_CONFIG, tmp, "turbo")
        exp = os.path.join(tmp, "turbo_layer")
        res = recon_cli(torch, cfg, path, exp, "--recon", "layer")
        qparams = load_qparams(res["path"], device=dev)
        del res
        gc_cuda(torch)
        pipe = build_pipeline(cfg, device=dev)
        with np.load(cfg.calib_data.path) as f:
            data = {k: f[k] for k in f.files}
        req = next(ptq.calib_batches_from_npz(data, 1, None, dev))
        wq = specs_from_config(cfg)[0]
        launches[f"recon layer {cfg.model.family}"] = deployed_step(
            torch, pipe, qparams, wq, req, f"recon layer {cfg.model.family}")
        t_a = time.time()
        # 15b: the W4 gate on one request
        del qparams
        gc_cuda(torch)
        w4_gate(torch, pipe)
        del pipe
        gc_cuda(torch)
        t_b = time.time()
        # 15c: --recon model / layer --adaround at SD1.5 width
        cfg, path = cut_config(torch, RECON_SD15_CONFIG, tmp, "sd15")
        with np.load(cfg.calib_data.path) as f:
            data = {k: f[k] for k in f.files}
        req = next(ptq.calib_batches_from_npz(data, 1, None, dev))
        wq = specs_from_config(cfg)[0]
        for mode in ("model", "layer"):
            exp = os.path.join(tmp, f"sd15_{mode}_adaround")
            res = recon_cli(torch, cfg, path, exp, "--recon", mode,
                            "--adaround")
            alphas, qparams = res["alphas"], res["qparams"]
            del res
            with open(os.path.join(exp, "alphas.msgpack"), "rb") as f:
                back = unpack(bytearray(f.read()))
            if list(back) != sorted(alphas) or not all(
                    torch.equal(back[k], alphas[k].cpu()) for k in alphas):
                raise AssertionError("alphas.msgpack reads back otherwise")
            gc_cuda(torch)
            pipe = build_pipeline(cfg, device=dev)
            n = adaround_codes(torch, pipe, qparams, alphas)
            label = f"recon {mode} adaround {cfg.model.family}"
            log(f"{label}: alphas.msgpack ({len(back)} layers) reads back "
                f"bit for bit; the deploy's codes equal the hard fake-quant "
                f"codes in all {n} entries")
            del back
            if mode == "model":
                # logged: a step of Adam flips the near-half codes of
                # every layer toward the output's gradient at once, a
                # step of a code each that overshoots (PERF.md section 6,
                # reconstruction); layer mode's per-layer targets hold
                # the step
                with torch.no_grad():
                    ref = pipeline.unet_step(pipe.unet, req)
                    y, y0 = (pipeline.unet_step(pipe.unet, req, w8a8_ctx(
                        pipe, qparams, wq, a)) for a in (alphas, None))
                log(f"{label}: W8A8 auto step vs bf16 {sqnr_db(ref, y):.2f} "
                    f"dB, without the alphas {sqnr_db(ref, y0):.2f} dB "
                    "(logged)")
            else:
                launches[f"recon adaround {cfg.model.family}"] = \
                    deployed_step(torch, pipe, qparams, wq, req, label,
                                  alphas=alphas)
            del pipe, qparams, alphas
            gc_cuda(torch)
        t_c = time.time()
        # 15d: QAT
        qat_steps(torch, dev)
        gc_cuda(torch)
        t_d = time.time()
        # 15e: the converters at full width
        convert_round_trip(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc_cuda(torch)
    log(f"phase 15 seconds: recon layer + deploy {t_a - t0:.1f}, W4 gate "
        f"{t_b - t_a:.1f}, adaround + deploy {t_c - t_b:.1f}, QAT "
        f"{t_d - t_c:.1f}, converters {time.time() - t_d:.1f}; {card}")
    return launches


def gc_cuda(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def main():
    import dataclasses
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    global T_START
    T_START = time.time()
    from mixdq_tpu_torch.ops import _build
    from mixdq_tpu_torch.quant.state import FP_CTX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    global LOG_FILE
    LOG_FILE = open(os.path.join(OUT_DIR, "chip_smoke.log"), "w")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.build_all()
    t_build = time.time() - t0
    log(f"phase 0: built {len(_build.SOURCES)} kernel sources in "
        f"{t_build:.1f}s")
    with open(os.path.join(OUT_DIR, "nvcc_build.txt"), "w") as f:
        for src, text in _build.BUILD_LOGS.items():
            f.write(f"===== {src}\n{text}\n")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    report = phase_kernels(torch, dev, flush)
    log(f"launch floor: empty kernel {launch_floor_ms(torch, dev, flush):.4f}"
        " ms (one warp, timed as phase 1 times each kernel)")
    del flush
    fused_one_kernel(torch, dev)
    capture_report(torch, dev)
    log("phase 1: every kernel matches its plain version" + elapsed())
    phase_tiny_parity(torch, dev)
    log("phase 2: tiny-sdxl, small-sd15 and small-sdxl parity ok under both "
        "attn_impl values and small-sdxl out-fused" + elapsed())
    unet, ctx, calib, requests, launches, e_launches, refs, outs, \
        turbo_graphed = phase_main_path(torch, dev, card)
    req = requests[0]
    log("phase 3: main paths ok (auto, einsum)" + elapsed())
    totals = {"sdxl-turbo auto": launches, "sdxl-turbo einsum": e_launches}
    totals.update(phase_outfuse(torch, unet, ctx, requests, refs, outs, card))
    del refs, outs
    log("phase 3: out-fusion paths ok (all sites, all sites without LN "
        "fold, none)" + elapsed())
    qparams, seen = phase_layers(torch, unet, ctx, calib, req)
    log("phase 4: every deploy entry matches fake quantization" + elapsed())
    phase_attention_sites(torch, unet, ctx, req)
    log("phase 4: every attention site matches under auto and einsum"
        + elapsed())
    phase_profile(torch, unet, req, (
        ("auto", ctx), ("einsum", dataclasses.replace(ctx, attn_impl="einsum")),
        ("bf16", FP_CTX)))
    log("phase 5: profiles written" + elapsed())
    totals.update(phase_mixed(torch, unet, calib, requests, ctx, qparams,
                              seen, card))
    log("phase 6: mixed-precision paths ok (mp auto, w-only dequant, "
        "w-only pallas_dequant)" + elapsed())
    del unet, ctx, calib, req, requests, qparams, seen
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {p: {k: v // N_REQUESTS for k, v in c.items()}
                for p, c in totals.items()}
    sdxl_per_step, sdxl_totals = phase_sdxl(torch, dev, card)
    per_step.update(sdxl_per_step)
    totals.update(sdxl_totals)
    log("phase 7: sdxl 1024 paths ok (auto, int8 flash qk / qkv, einsum, "
        "bf16 auto)" + elapsed())
    # kernel_bench "per step": one call of each row at each shape
    totals["kernel_bench"], kb_calls = phase_kernel_bench(torch, dev, card)
    per_step["kernel_bench"] = {k: v // kb_calls
                                for k, v in totals["kernel_bench"].items()}
    log("phase 8: kernel_bench path ok (four shapes, seven rows)" + elapsed())
    gc.collect()
    torch.cuda.empty_cache()
    serving = phase_serving(torch, dev, card)
    totals.update(serving)
    # a serving path's "per step": one generation (the capture's launches)
    per_step.update({p: {k: v // 3 for k, v in c.items()}
                     for p, c in serving.items()})
    log("phase 9: serving path ok (bf16, W8A8, W8A8 + int8 VAE at B = "
        f"{', '.join(map(str, SERVE_BATCHES))}, one CUDA graph a batch)"
        + elapsed())
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ptq_flow_")
    try:
        ptq_launches, exp, calib_path = phase_ptq_flow(
            torch, dev, card, turbo_graphed, tmp)
        per_step.update(ptq_launches)
        log("phase 10: PTQ flow ok (gen_calib_data, ptq with splits, "
            "quant_txt2img; checkpoint and params round trips)" + elapsed())
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.time()
        fake_launches = phase_fake(torch, dev, card, exp, calib_path)
        log(f"phase 11: fake-quant mode ok ({time.time() - t0:.1f}s: W8A8, "
            "q/k/v/softmax and mixed fake at 512 px, attn_impl flash / "
            "int8_flash / int8qkv_flash, deploy_compute=int8, W8A8 fake at "
            "1024 px)" + elapsed())
        gc_cuda(torch)
        t0 = time.time()
        search_launches = phase_search(torch, dev, card, exp, tmp)
        log(f"phase 12: BoS outputs, banks, small-M, the search, the ILP, "
            f"the elected map and quant_error ok ({time.time() - t0:.1f}s)"
            + elapsed())
        gc_cuda(torch)
        eval_launches = phase_eval_clis(torch, dev, card, exp, tmp)
        log("phase 13: evaluate (FID, CLIP towers), serve_bench, "
            "memory_compare, batch_sweep, txt2img and serve ok"
            + elapsed())
        gc_cuda(torch)
        mesh_launches = phase_mesh_comfy(torch, dev, card, exp, tmp)
        log("phase 16: the mesh engine, the ComfyUI nodes, the tensorstore "
            "container and the dp sweep ok" + elapsed())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc_cuda(torch)
    t0 = time.time()
    sd15_per_step, sd15_totals = phase_sd15(torch, dev, card)
    per_step.update(sd15_per_step)
    totals.update(sd15_totals)
    log(f"phase 14: sd15 ok ({time.time() - t0:.1f}s: W8A8, bf16, mixed and "
        "int8 flash steps, flash at d = 40 / 80 / 160, the LCM serving loop "
        "at B = 1 and 4, the PTQ flow on configs/sd15_lcm.yaml)" + elapsed())
    gc_cuda(torch)
    t0 = time.time()
    recon_launches = phase_recon(torch, dev, card)
    per_step.update(recon_launches)
    totals.update(recon_launches)
    log(f"phase 15: reconstruction, QAT and the converters ok "
        f"({time.time() - t0:.1f}s)" + elapsed())
    per_step.update(fake_launches)
    totals.update(fake_launches)
    per_step.update(search_launches)
    totals.update(search_launches)
    per_step.update(eval_launches)
    totals.update(eval_launches)
    per_step.update(mesh_launches)
    totals.update(mesh_launches)

    log(json.dumps({"tpu_kernels": [
        {"tpu_kernel": f"mixdq_tpu/ops/{tk}",
         "status": f"ported: {k}" if k in PORTED else "still to port"}
        for tk, k in TPU_KERNELS], "ported": f"{len(PORTED)} of "
        f"{len(TPU_KERNELS)}"}))
    kernels = []
    for name, (src, replaces) in PORTED.items():
        r = report[name]
        first, extra = r["shapes"][0], {}
        if name in LIBRARY:
            extra["library"] = LIBRARY[name]
        for key in ("library_kmajor_ms", "quantize_qmatmul_ms", "stages_ms"):
            if first[key] is not None:
                extra[key] = first[key]
        # the main path a kernel runs on: the SDXL-Turbo headline, else the
        # weight-only pallas_dequant step, else SDXL 1024 under auto, else
        # the path of its kernel option, else the kernel benchmark
        main_path = next((p for p in ("sdxl-turbo auto",
                                      MP_PATHS["pallas_dequant"], "sdxl auto",
                                      "sdxl-turbo outfuse all",
                                      "sdxl int8_qk", "sdxl int8_qkv",
                                      "kernel_bench")
                          if totals[p][name]), None)
        serve = f"serving w8a8+int8 vae B={SERVE_BATCHES[-1]}"
        if main_path is None:
            raise AssertionError(f"{name} never launched on a main path")
        requests = (N_SDXL_REQUESTS if main_path.startswith("sdxl ")
                    else kb_calls if main_path == "kernel_bench"
                    else N_REQUESTS)
        kernels.append({
            **extra, "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": totals[main_path][name],
            "launches_path": main_path, "requests": requests,
            "launches_per_step": {p: c[name] for p, c in per_step.items()},
            "serving_launches": per_step[serve][name], "serving_path": serve,
            "max_abs_err": r["max_abs_err"], "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shape": first["shape"]})
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.time() - T_START:.1f}s in all (the build "
        f"{t_build:.1f}s)")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

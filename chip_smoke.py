"""Drive forge_tpu_torch's SD1.5, quantized Flux and SDXL txt2img paths, its SDXL
img2img-inpaint path with a LoRA and a ControlNet, its batched SDXL serving with an
IP-Adapter and a MultiDiffusion upscale, its SDXL hires fix and refiner, one
sampler of each group and the prompt surface on SDXL, its REST API on SDXL with
the tiled VAE, the extension hook layers on SDXL (FreeU, PAG, SAG, dynamic
thresholding, latent modifier, a hypernetwork, StyleAlign, ControlLLLite),
SD2.1-768-v, SD3-medium and Playground v2.5, the rest of the Flux
family (a bitsandbytes NF4 file with separate VAE and text-encoder files, fp8 storage and
Chroma), hook phases and deferred hooks on SDXL (Deep Shrink, Fooocus inpaint, a
T2I-Adapter, a Control-LoRA, ControlNet inpaint_only, the latent modifier's extra noise), and
the image-prompt family on SDXL (reference-only, FaceID, FaceID-Plus, InstantID, Revision,
PhotoMaker, and the REST API's always-on scripts), on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases; needs one CUDA device
    python3 chip_smoke.py --kernels    # phases 1-2 only (build + kernel checks), no result
    python3 chip_smoke.py --families   # phase 1, phase 2's rows for phase 13, phase 13; no result
    python3 chip_smoke.py --api        # phase 1, phase 2's VAE tile rows, phase 14; no result
    python3 chip_smoke.py --flux-family  # phase 1, phase 2's rows for phase 15, phase 15; no result
    python3 chip_smoke.py --extensions   # phase 1, phase 2's StyleAlign rows, phase 16; no result
    python3 chip_smoke.py --controls     # phase 1, phase 2's Deep Shrink rows, phase 17 at 20
                                         # steps; no result
    python3 chip_smoke.py --image-prompts  # phase 1, phase 2's joined-key flash rows, phase 18
                                           # at 20 steps; no result

Phases:
  1. device and build: `nvidia-smi` name and power limit, then the kernels
     compiled from forge_tpu_torch/csrc/*.cu, one nvcc (sm_90a) per file,
     all started together;
  2. each kernel against its plain PyTorch version on the card, in f32 and
     bf16, at the shapes the main paths give it, with both times and the
     bound (the least time the card could take): flash attention,
     GroupNorm+SiLU+conv3x3, and dequant-matmul for all five kinds at the
     Flux-dev shapes, each row with the body it took (the tensor-core body
     for bf16, the SIMT body for f32); at each bf16 flash shape of the main
     paths the SIMT body and
     torch.nn.functional.scaled_dot_product_attention (a yardstick only:
     the port never calls it) are timed beside it, at every bf16 conv shape
     the SIMT body and cuDNN's conv alone on the activated tensor (a
     yardstick, not the same function), and at linear1 and linear2 the bf16
     SIMT body of dequant-matmul; the SIMT body must be slower; where the
     plain flash would hold more than 2^30 f32 logits (the 2048² VAE's
     65536 tokens) it is held on the first and last 1024 query rows, in
     bf16 only;
  3. the SD1.5 slice at full width on random weights made on the card from
     a seed: load_engine, then three process_images requests (512², Euler a,
     20 steps, CFG 7, seeds 1, 2, 1) with the launch counts of each kernel
     (flash's and the conv's exact, all on the tensor-core body), then one
     request under torch.profiler (device time by kernel, busy share);
  4. one SD1.5 UNet forward through the kernels and through the plain versions;
  5. the quantized Flux-dev slice at full width (19 + 38 blocks, T5-XXL,
     CLIP-L, 16-channel VAE) on random weights made on the card from a seed:
     load_engine(unet_quant="nf4"), three requests (1024², Euler, "simple",
     4 steps, CFG 1, distilled CFG 3.5, seeds 1, 2, 1) with exact launch
     counts (every kernel's by body too), one request with the plain
     versions, one request under
     torch.profiler (device time by kernel, busy share), then
     load_engine(unet_quant="q4_0") and one request;
  6. kernels vs plain versions on one Flux double block, one single block
     (full width, 1024²-sized inputs) and one whole Flux forward, bf16;
  7. the SDXL base slice at full width (UNet 320ch, mult (1,2,4), depths
     (0,2,10), CLIP-L + OpenCLIP-bigG, 4-channel VAE) on random weights made
     on the card from a seed: load_engine, three requests (1024², DPM++ 2M,
     "karras", 30 steps, CFG 7, seeds 1, 2, 1) with latency, timings, peak
     memory and exact launch counts by body, one request under
     torch.profiler, then one UNet forward at (2,4,128,128) through the
     kernels and through the plain versions;
  8. config 3 on the same engine (bench.py's `config3`): a full-width SDXL
     ControlNet made on the card, a rank-16 LoRA over three blocks' attn1
     q/k/v written to logs/ by the port's safetensors writer, then three
     img2img-inpaint requests (1024² uniform-noise init image, the centre
     512² masked, "original" fill, blur 4, strength 0.6 of 20 DPM++ 2M
     Karras steps, CFG 7, "a castle <lora:bench:0.8>", ControlNet-canny at
     strength 1, seeds 1, 2, 1) with exact launch counts by body, the
     unmasked ring checked against the init image, one profiled request,
     the LoRA merge checked against base + 0.8·(α/r)·up·down, and the VAE
     encode at 1024² and a UNet + ControlNet forward at (2,4,128,128)
     through the kernels and the plain versions;
  9. config 5 on the same engine (bench.py's `config5`): CLIP-ViT-H/14 and
     an SDXL IP-Adapter made on the card, a seeded 1024² reference image
     encoded to IP tokens (weight 0.6), one warm request, then three
     requests (1024², batch 2, DPM++ 2M Karras, 20 steps, CFG 7, seeds 2,
     3, 4) through `serve_throughput` and the same three through
     `process_images`: exact launch counts by body, served images
     byte-identical to the sequential ones, images/s both ways and
     serve_speedup; weight 0 equal to no hooks and unequal to 0.6; one
     profiled request; then the MultiDiffusion 2× upscale of the first
     served image to 2048² (Euler, 8 steps at strength 0.35, 9 tiles of 96
     latent pixels, overlap 16; seeds 9, 10, 10) with exact launch counts,
     seed 10 twice byte-identical, one profiled upscale; then the UNet with
     the IP hooks at (4,4,128,128) and one 96² tile forward through the
     kernels and the plain versions;
 10. config 2 complete on the same engine (BASELINE configs[1], the webui's
     hires and refiner defaults): (a) the hires fix in latent mode, 1024²
     DPM++ 2M Karras 30 steps CFG 7, then "Latent" ×2 at denoising 0.7
     (hires steps 0 = 30: 22 model calls on 256² latents) and the 2048²
     decode, seeds 1, 2, 1, with exact launch counts by body, latency,
     timings and peak memory, then one profiled request; (b) a full-width
     SDXL refiner made on the card (384 channels, 44 transformer blocks,
     context 1280, adm 2560, CLIP-G 1280 × 32) taking over at switch 0.8,
     seed 1 twice (byte-identical) and one profiled; (c) the pixel mode
     through a full-width RRDBNet ×4 (RealESRGAN_x4plus's widths) written to
     logs/ by the port's safetensors writer: 192² tiles at overlap 8 over
     the 1024² image, Lanczos to 2048², the VAE encoder at 2048²; then a
     base UNet forward at (2,4,256,256) and a refiner forward at
     (2,4,128,128) through the kernels and the plain versions;
 11. the samplers on the same engine: 1024², CFG 7, 20 steps, SDXL's prompt,
     with "DPM++ 2M" Karras (the baseline, timed in the same phase), "DPM++
     SDE" Karras (second order, Brownian noise with two draws a step),
     "DPM2" Karras (second order, the penultimate σ discarded), "UniPC" and
     "DDIM CFG++" (the uncond pair, the scale × 1/12.5): for
     each, seeds 1, 1, 2 (seed 1 twice byte-identical, seed 2 another image)
     with latency, timings (`noise` with the Brownian tree's host time),
     peak memory and exact launch counts by body; the Brownian noise of one
     request timed alone; then one "DPM++ SDE" request under torch.profiler;
 12. the prompt surface on the same engine (1024², DPM++ 2M Karras, 20 steps,
     CFG 7): (a) "a photo of a [cat:dog:0.5] wearing forgeemb", forgeemb a
     dual textual-inversion embedding (2 vectors a tower, made from a seed
     and written to logs/), a style from a CSV written beside it, CFG
     rescale 0.7, twice (the second from the cond cache), its infotext
     parsed back; (b) "a cat AND a red hat :0.8" at UNet batch 3, seeds 1, 1,
     2, one profiled, one through the plain versions (the images' PSNR
     printed), a witness (AND and "a cat" at seeds 1-3, each through the
     kernels and the plain versions, their PSNRs printed side by side) and a
     batch-3 UNet forward against plain; (c) two
     regional prompts on the left and right halves (feather 8) at batch 4;
     (d) NGMS at s_min_uncond 1.0, twice: batch 2, then batch 1 from the split;
     each with latency, phases, peak memory, the UNet's batch shapes with
     their calls and exact launch counts by body;
 13. the other diffusion families, each made on the card at its published
     widths and driven with its model card's request: SD2.1-768-v (UNet
     320·(1,2,4,4), 64-wide heads, linear projections, context 1024;
     OpenCLIP ViT-H/14's text tower; v by its marker key) at 768², DPM++ 2M
     Karras, 20 steps, CFG 7; SD3-medium (24 joint blocks, hidden 1536, a
     192² positional grid; CLIP-L, CLIP-G, T5-XXL; the 16-channel VAE) at
     1024², Euler "simple", 28 steps, CFG 7, shift 3.0; Playground v2.5
     (SDXL's geometry, EDM at σ_data 0.5, the channel latent format) at
     1024², DPM++ 2M Karras, 50 steps, CFG 3. Each: the engine's widths
     checked, a warm request, seeds 1, 2, 1 (seed 1 twice byte-identical)
     with latency, phases, peak memory and exact launch counts by body, one
     profiled request, seed 1's whole request through the plain versions
     (its image ≥ 40 dB against the kernels' for SD3 and Playground; for
     SD2, which reads under, printed beside a witness: the plain versions
     from a starting noise moved by subseed strength 0.001), and the
     network's forward
     (CFG batch 2, the request's latent) and the VAE decode through the
     kernels and the plain versions. Phase 2 holds flash at SD3's ragged q(2,24,4250,64), SD2's
     q(2,5,9216,64) and the 768² VAE's q(1,1,9216,512), and the conv at
     SD2's fourteen (C, O, size) (twelve are config 5's tile rows) and the
     768² decoder's six.
 14. the REST API on the SDXL engine, run before phase 13 frees it
     (`--api`: on an engine of its own): forge_tpu_torch's server on
     127.0.0.1, port 0, on a thread, over a ModelManager holding the engine;
     GET samplers, options, sd-models and memory (its "cuda" within 1 GiB of
     torch.cuda.mem_get_info); bench.py's `config2` request (1024², DPM++ 2M
     Karras, 30 steps, CFG 7) as txt2img over HTTP at seeds 1, 2 (/progress
     polled every 0.1 s: it never falls and reaches 30 of 30, a live preview
     decodes through the port's PNG reader) and seed 1 four times in turns
     with the live previews on, off, off, on (their cost), exact launch
     counts, every seed-1 response identical and its PNG's pixels and
     "parameters" equal to process_images' image and infotext (both wall
     times, the PNG encode's ms; the host decode of that image as the
     port's filter-None PNG and as a client's upload filtered Average and
     Paeth); an interrupt posted once /progress shows
     step 10 (the response carries an image; the UNet's launches are the
     steps the state counted, plus one whole decode); under
     `vae_always_tiled` a txt2img (9 decode tiles) and an img2img at strength
     0.5 from the first image sent as that Average/Paeth upload (9 encode and
     9 decode tiles), exact launches;
     a 2048² latent decoded whole and tiled (25 tiles) from fresh peaks:
     both peaks and times, the tiled peak lower, the tiled decode ≥ 40 dB
     against its plain versions; a request under `sd_vae_decode_method`
     "TAESD" with synthetic taesdxl weights made on the card (no VAE kernel
     launched), and a 1024² TAESD decode timed beside the full VAE's. Phase
     2 holds the six (C, O, size) of a 512² tile's resnets that no other
     row holds.
 15. the Flux family as users download it, after phase 13: (a) phase 5's
     Flux-dev weights written under logs/ by the port's safetensors writer
     as a transformer-only bitsandbytes file (NF4, block 64, f32 absmax, no
     double quantization: flux1-dev-bnb-nf4-v2's layout), a bf16 VAE file
     and a bf16 text-encoder file (`text_encoders.*`), loaded through
     `load_engine(path, additional_modules=…)` (file sizes, write and load
     seconds, GiB allocated; the UNet holds no VAE or text-encoder subtree)
     and driven as phase 5 (seeds 1, 2, 1, exact launches by body); seed 1's
     image byte-identical to phase 5's `unet_quant="nf4"` image; the
     directory removed; (b) `unet_quant="fp8_e4m3"`: the 314 big weights
     float8_e4m3fn (about 12 GB below the bf16 tree), one request with exact
     launches (no dequant), its latency beside NF4's, one profiled, one
     whole forward against plain (≥ 40 dB); (c) Chroma at full width in bf16 (hidden 3072,
     24 heads, 19 + 38 blocks, the Approximator 5120 × 5, T5-XXL, the
     16-channel VAE): 1024², Euler "simple", 26 steps, CFG 4 with a negative
     prompt, a warm request, seeds 1, 2, 1 (seed 1 twice byte-identical;
     26 × 57 + 1 flash launches a request on the tensor-core body, 28 conv,
     0 dequant), one profiled, one forward at CFG batch 2 against plain
     (≥ 40 dB). Phase 2 holds flash at Chroma's q(2,24,4608,128).

 16. the extension hook layers on the SDXL engine, after phase 14 and before
     phase 13 frees it (`--extensions`: on an engine of its own): 1024²,
     DPM++ 2M Karras, 10 steps (bench config 2's 30 cut to fit the run's
     limit; the widths are not cut), CFG 7, batch 1: a witness request at
     seed 1; FreeU at the SDXL values its authors publish (b1 1.3, b2 1.4,
     s1 0.9, s2 0.2) at seeds 1, 2, 1 (seed 1 twice byte-identical); at seed
     1, PAG (scale 3), SAG (scale 0.75, blur σ 2), dynamic thresholding
     (mimic 7, percentile 1.0, the request at CFG 15), the latent modifier
     (reinhard tonemap 3, Gaussian sharpness 10), a hypernetwork made on the
     card (SDXL's 2048-wide context, layers 1, 2, 1, relu, LayerNorm,
     strength 1), StyleAlign (strength 1, batch 2) and ControlLLLite made on
     the card (cond_emb_dim 32, mlp_dim 64 on every transformer block's attn1
     q, k, v and attn2 q) with a canny hint: each image differs from the
     witness's, its launches exact by body, its latency and timings beside
     the witness's; the CFG'd model_fn call of step 5 (its σ, the
     request's own latent there, recorded by a post-CFG hook that launches
     nothing) with the witness's and each extension's hooks, and one UNet
     forward at (2,4,128,128) with the five block slots, through the kernels
     and the plain versions (≥ 40 dB; SAG's plain run takes the kernels'
     recorded q and k, so both apply one mask, and the run with its own
     mask and the mask tokens that flipped are printed). Phase 2 holds flash
     at StyleAlign's joined q(2,10,8192,64) and q(2,20,2048,64).
 17. hook phases and deferred hooks on the SDXL engine, after phase 16
     (`--controls`: on an engine of its own, at 20 steps): DPM++ 2M Karras,
     10 steps, CFG 7, seed 1, every weight made on the card from a seed.
     (a) Deep Shrink at 2048² (Kohya HRFix at Forge's defaults: block 3, ×2,
     bicubic down and up, after the skip, until 0.35 of the steps) twice,
     beside the same request without it: seed 1 twice byte-identical, each
     segment's flash launches counted by shape as they launch; (b) Fooocus
     inpaint on config 3's init image and mask at strength 1.0, with a patch
     of a uint8 diff for every UNet weight of two or more dimensions and a
     5→320 head (the dict passed to `attach`; the weights' build timed),
     beside the inpaint without it; (c) a T2I-Adapter "canny" unit (SDXL's
     layout: 768 channels in, (320, 640, 1280, 1280), two resblocks a stage,
     stage 2 downsampling), (d) a rank-128 Control-LoRA "canny" unit
     (assembled onto the live UNet, timed, held against base + up·down
     computed in f32 on the host within 2e-2) and (f) the latent modifier
     with gaussian extra noise, each on txt2img 1024² beside one witness,
     the units' canny on a 512² source; (e) ControlNet inpaint_only with a
     cldm of config 3's topology on config 3's inpaint request (strength
     0.6) beside it without the unit, every pixel 17 px past the mask the
     init's. Each request's image finite and unlike its witness's, its
     launches exact by body, its latency and peak memory printed; each
     path's CFG'd model_fn at one call (its σ, the request's own latent
     there; Deep Shrink one shrunk call and one not) through the kernels
     and the plain versions (≥ 40 dB). Phase 2's rows hold flash at Deep
     Shrink's four shapes and the fused conv at its sizes; `--controls`
     runs those rows alone.
 18. the image-prompt family on the SDXL engine, after phase 17
     (`--image-prompts`: on an engine of its own, at 20 steps): 1024², DPM++
     2M Karras, 4 steps, CFG 7, seed 1, every weight made on the card from a
     seed at its published shapes, each request beside a witness without
     it: reference_only, reference_adain and reference_adain+attn
     ControlNet units (weight 1.0, style fidelity 0.5) on a reference image;
     IP-Adapter FaceID SDXL (the MLP 512 → 1024 → 4 × 2048, a LayerNorm)
     and FaceID-Plus v2 (the same MLP and a face perceiver 2048 wide, 4
     layers, 32 heads, over CLIP-ViT-H/14) through `attach` with a face
     embedding; InstantID (a Resampler 1280 wide, 4 layers, 20 heads, 16
     queries, 512 → 2048) with config 3's cldm reading its tokens on a
     keypoint hint; Revision through a unit with CLIP-ViT-bigG/14 (1664, 48
     layers, projection 1280); PhotoMaker (a ViT-L/14 id encoder, the fuse
     at 2048) beside its own witness; and one API txt2img whose
     `alwayson_scripts` carry a reference_only unit and a FaceID adapter
     written to a file, its PNG's pixels and text equal to `process_images`'
     image and infotext. Each request's image finite and unlike its
     witness's, its launches exact by body, its latency and peak memory
     printed, its CFG'd model_fn at the middle call (reference-only's both
     passes) through the kernels and the plain versions (≥ 40 dB). Phase 2
     holds flash at reference-only's joined keys, q(1,10,4096,64) against
     8192 and q(1,20,1024,64) against 2048.

Each path's launch counts are set to 0 just before it is driven and read just
after. Any failed check raises, so the exit code is not 0 and no result line
is printed. The last two lines are the per-kernel JSON summary and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

F32_BOUND = 1e-4   # max |kernel − plain| / max |plain| in f32
BF16_BOUND = 2e-2  # the same in bf16: a bf16 ulp of max |plain| is 2^-8 to 2^-7 of it
PSNR_BOUND = 40.0  # kernels vs plain, bf16 (tests/test_golden_parity.py's bar)
# NVIDIA's data sheet, H100 SXM, dense: peak rate by operand type, and HBM bytes/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

FLASH_SHAPES = [  # (B, H, Lq, D), Lk, a shape of a main path
    ((2, 8, 4096, 40), 4096, True),     # UNet level-0 self-attention, CFG batch
    ((2, 8, 1024, 80), 1024, True),     # UNet level-1 self-attention
    ((1, 1, 4096, 512), 4096, True),    # VAE mid-block single head
    ((1, 2, 1000, 40), 700, False),     # ragged tails on both sides
    ((1, 24, 4608, 128), 4608, True),   # Flux joint attention at 1024²: 512 text + 4096 image tokens
    ((1, 1, 16384, 512), 16384, True),  # Flux and SDXL VAE mid-block at 1024²
    ((2, 10, 4096, 64), 4096, True),    # SDXL level-1 self-attention at 1024², CFG batch
    ((2, 20, 1024, 64), 1024, True),    # SDXL level-2 and middle-block self-attention
    # config 5: serving at batch 2 (CFG batch 4), and MultiDiffusion's 96² tiles (CFG batch 2)
    ((4, 10, 4096, 64), 4096, True),
    ((4, 20, 1024, 64), 1024, True),
    ((2, 10, 2304, 64), 2304, True),    # a tile's level 1: 48² tokens
    ((2, 20, 576, 64), 576, True),      # a tile's level 2: 24² tokens, 4.5 query tiles of 128
    ((2, 1, 16384, 512), 16384, True),  # the VAE mid-block decoding a served batch of 2 at 1024²
    ((1, 1, 65536, 512), 65536, True),  # the VAE mid-block at 2048² (encode and decode)
    # config 2: the hires pass's UNet at 2048² (256² latents), and the refiner's at 1024²
    ((2, 10, 16384, 64), 16384, True),  # hires level 1: 128² tokens
    ((2, 20, 4096, 64), 4096, True),    # hires level 2
    ((2, 12, 4096, 64), 4096, True),    # refiner level 1: 768 wide, 12 heads
    ((2, 24, 1024, 64), 1024, True),    # refiner level 2: 1536 wide, 24 heads (its middle: 256 tokens, plain)
    # the prompts phase: SDXL at UNet batch 3 (one AND branch) and 1 (the NGMS tail)
    ((3, 10, 4096, 64), 4096, True),
    ((3, 20, 1024, 64), 1024, True),
    ((1, 10, 4096, 64), 4096, True),
    ((1, 20, 1024, 64), 1024, True),
]
FAMILY_FLASH_SHAPES = [  # SD2.1-768-v, SD3-medium and Playground v2.5 (SDXL's shapes)
    ((2, 24, 4250, 64), 4250, True),    # SD3 joint attention: 77 + 77 text, 4096 image tokens
    ((2, 5, 9216, 64), 9216, True),     # SD2 level 0 at 768²: 96² tokens, 5 heads
    ((1, 1, 9216, 512), 9216, True),    # the VAE mid-block decoding 768²
]  # SD2's levels 1 and 2 (2304 and 576 tokens) are config 5's tile rows above
FLASH_SHAPES += FAMILY_FLASH_SHAPES
# phase 15: Chroma's joint attention at CFG batch 2 (the bnb and fp8 Flux paths take the
# (1,24,4608,128) and (1,1,16384,512) rows above)
FLUX_FAMILY_FLASH_SHAPES = [((1, 24, 4608, 128), 4608, True), ((2, 24, 4608, 128), 4608, True),
                            ((1, 1, 16384, 512), 16384, True)]
FLASH_SHAPES += FLUX_FAMILY_FLASH_SHAPES[1:2]
# phase 16: StyleAlign's shared self-attention at SDXL 1024², batch 2 with CFG: each CFG half's
# two images joined into one sequence (2 × 4096 and 2 × 1024 tokens), one launch of batch 2
EXTENSIONS_FLASH_SHAPES = [((2, 10, 8192, 64), 8192, True), ((2, 20, 2048, 64), 2048, True)]
FLASH_SHAPES += EXTENSIONS_FLASH_SHAPES
FLUX_FAMILY_CONV_SHAPES = [((1, 512, 128, 128), 512), ((1, 128, 1024, 1024), 128)]  # Flux's VAE
FLASH_SUMMARY_SHAPE = FLASH_SHAPES[0][0]  # the JSON line's flash row (the same shape since the first)
GN_CONV_SHAPES = [  # (B, C, H, W), O
    ((2, 320, 64, 64), 320),     # UNet level-0 resblock
    ((2, 960, 32, 32), 640),     # UNet output block after a skip concat
    ((2, 2560, 8, 8), 1280),     # UNet level-3 output block
    ((1, 512, 128, 128), 512),   # VAE decoder level 2
    ((1, 256, 512, 512), 128),   # VAE decoder level 0, first resnet
    ((2, 1280, 16, 16), 1280),   # UNet level 2
    ((1, 128, 1024, 1024), 128),  # Flux and SDXL VAE decoder level 0 at 1024²
    # SDXL's UNet at 1024² (128² latents), CFG batch: every (C, O, size) of its 34 ResBlock convs
    ((2, 320, 128, 128), 320),   # level 0
    ((2, 960, 128, 128), 320),   # level-0 output blocks after skip concats
    ((2, 640, 128, 128), 320),
    ((2, 320, 64, 64), 640),     # level 1, first input resblock
    ((2, 640, 64, 64), 640),
    ((2, 1920, 64, 64), 640),    # level-1 output blocks after skip concats
    ((2, 1280, 64, 64), 640),
    ((2, 960, 64, 64), 640),
    ((2, 640, 32, 32), 1280),    # level 2, first input resblock
    ((2, 1280, 32, 32), 1280),   # level 2 and the middle block
    ((2, 2560, 32, 32), 1280),   # level-2 output blocks after skip concats
    ((2, 1920, 32, 32), 1280),
    # the VAE encoder at 1024²: the two (C, O) pairs the decoder does not have
    ((1, 128, 512, 512), 256),   # level 1, first resnet
    ((1, 256, 256, 256), 512),   # level 2, first resnet
]
# config 5: the same twelve (C, O) pairs at serving's CFG batch 4 on 128², 64² and 32² latents,
# and on a MultiDiffusion 96² tile's 96², 48² and 24² at CFG batch 2
SDXL_CONV_PAIRS = [(320, 320, 0), (960, 320, 0), (640, 320, 0), (320, 640, 1), (640, 640, 1),
                   (1920, 640, 1), (1280, 640, 1), (960, 640, 1), (640, 1280, 2),
                   (1280, 1280, 2), (2560, 1280, 2), (1920, 1280, 2)]
GN_CONV_SHAPES += [((b, c, side >> level, side >> level), o) for b, side in ((4, 128), (2, 96))
                   for c, o, level in SDXL_CONV_PAIRS]
GN_CONV_SHAPES += [((1, 128, 2048, 2048), 128),  # the VAE at 2048²: encoder and decoder level 0
                   ((1, 256, 2048, 2048), 128)]  # decoder up.0's first resnet (2^30 elements in)
# config 2: the twelve pairs at CFG batch 2 on the hires pass's 256², 128² and 64² latents, and
# the refiner's fourteen (C, O, size) at CFG batch 2 on 128² latents
GN_CONV_SHAPES += [((2, c, 256 >> level, 256 >> level), o) for c, o, level in SDXL_CONV_PAIRS]
REFINER_CONV_SHAPES = [(384, 384, 128), (768, 384, 128), (1152, 384, 128), (384, 768, 64),
                       (768, 768, 64), (1152, 768, 64), (1536, 768, 64), (2304, 768, 64),
                       (768, 1536, 32), (1536, 1536, 32), (2304, 1536, 32), (3072, 1536, 32),
                       (1536, 1536, 16), (3072, 1536, 16)]
GN_CONV_SHAPES += [((2, c, side, side), o) for c, o, side in REFINER_CONV_SHAPES]
# the prompts phase: the twelve pairs at UNet batch 3 (AND) and 1 (the NGMS tail) on 128², 64², 32²
GN_CONV_SHAPES += [((b, c, 128 >> level, 128 >> level), o) for b in (3, 1)
                   for c, o, level in SDXL_CONV_PAIRS]
# SD2.1-768-v: every (C, O, size) of its UNet's 44 ResBlock convs on 96² latents at CFG batch
# 2 (twelve of them are config 5's 96²-tile rows, held once), and of the VAE decoder at 768²
SD2_CONV_SHAPES = [(320, 320, 96), (640, 320, 96), (960, 320, 96), (320, 640, 48),
                   (640, 640, 48), (960, 640, 48), (1280, 640, 48), (1920, 640, 48),
                   (640, 1280, 24), (1280, 1280, 24), (1920, 1280, 24), (2560, 1280, 24),
                   (1280, 1280, 12), (2560, 1280, 12)]
FAMILY_CONV_SHAPES = ([((2, c, side, side), o) for c, o, side in SD2_CONV_SHAPES]
                      + [((1, 512, 96, 96), 512), ((1, 512, 192, 192), 512),
                         ((1, 512, 384, 384), 256), ((1, 256, 384, 384), 256),
                         ((1, 256, 768, 768), 128), ((1, 128, 768, 768), 128)])
GN_CONV_SHAPES += [shape for shape in FAMILY_CONV_SHAPES if shape not in GN_CONV_SHAPES]
# phase 14's tiled VAE: a 512² decode tile (64² latent) and a 512² encode tile, the (C, O, size)
# of their resnets that no row above holds (the 512² decode is SD1.5's at batch 1)
TILE_FLASH_SHAPES = [((1, 1, 4096, 512), 4096, True)]  # the VAE mid-block on a tile, held above
TILE_CONV_SHAPES = [((1, 512, 64, 64), 512), ((1, 512, 256, 256), 256), ((1, 256, 256, 256), 256),
                    ((1, 128, 512, 512), 128), ((1, 128, 256, 256), 256), ((1, 256, 128, 128), 512)]
GN_CONV_SHAPES += [shape for shape in TILE_CONV_SHAPES if shape not in GN_CONV_SHAPES]
PLAIN_MAX_LOGITS = 1 << 30  # above this many logits a head, plain flash is checked on row slices
DEQUANT_SHAPES = [  # (M, N, K) of the Flux-dev linears at 1024²
    (4608, 21504, 3072),  # single block linear1
    (4608, 3072, 15360),  # single block linear2
    (1, 18432, 3072),     # double block adaLN modulation (M = 1)
    (4096, 64, 3072),     # final_layer.linear (N = 64: the reference's KeyError leaf)
    (4096, 3072, 64),     # img_in (K = 64)
    (1000, 9216, 3072),   # ragged M at the qkv width
]
DEQUANT_CASES = (  # (kind, block, (M, N, K)): every kind at every shape, and block 16
    [(kind, block, shape) for kind, block in (("q8_0", 32), ("nf4", 64), ("q4_0", 32),
                                              ("gq4", 32), ("gq8", 32))
     for shape in DEQUANT_SHAPES]
    + [(kind, 16, DEQUANT_SHAPES[-1]) for kind in ("gq4", "gq8")])  # the K-quant groups
EXPECTED_PER_REQUEST = {"flash_attention": 201, "gn_silu_conv3x3": 908}
FLUX_STEPS = 4
FLUX_PROMPT = "a photograph of an astronaut riding a horse on the moon, (detailed:1.2)"
SDXL_STEPS = 30
# a request: 70 self-attentions of L ≥ 512 a forward (level 1: 5 transformers × depth 2;
# level 2 and the middle: 6 × depth 10) and the VAE mid-block; 17 ResBlocks × 2 convs a
# forward and the VAE decoder's 14 resnets × 2; one forward a step (cond and uncond batched)
SDXL_PER_REQUEST = {"flash_attention": SDXL_STEPS * 70 + 1, "gn_silu_conv3x3": SDXL_STEPS * 34 + 28,
                    "dequant_matmul": 0}
# config 3: strength 0.6 of 20 steps keeps the last 14 σ, 13 model calls; each is the UNet
# (70 flash, 34 conv) and the ControlNet (34 flash: 2 × depth 2 + 3 × depth 10; 16 conv: 8
# ResBlocks), then one VAE encode (1 flash, 20 conv) and one decode (1, 28)
CONFIG3_STEPS, CONFIG3_STRENGTH = 20, 0.6
CONFIG3_CALLS = min(int(CONFIG3_STRENGTH * CONFIG3_STEPS), CONFIG3_STEPS - 1) + 1  # t_enc + 1
CONFIG3_PER_REQUEST = {"flash_attention": CONFIG3_CALLS * (70 + 34) + 1 + 1,
                       "gn_silu_conv3x3": CONFIG3_CALLS * (34 + 16) + 20 + 28, "dequant_matmul": 0}
CONFIG3_PROMPT = "a castle <lora:bench:0.8>"
# config 5 (bench.py's `config5`): served requests at batch 2 (CFG batch 4), 20 steps, each
# forward the UNet's 70 flash calls and 34 convs (the IP hooks' attentions have 4 keys: no
# kernel), then the decode of both images (1 flash, 28 conv)
CONFIG5_STEPS, CONFIG5_BATCH, CONFIG5_IP_WEIGHT = 20, 2, 0.6
CONFIG5_SEEDS = (2, 3, 4)
CONFIG5_PER_REQUEST = {"flash_attention": CONFIG5_STEPS * 70 + 1,
                       "gn_silu_conv3x3": CONFIG5_STEPS * 34 + 28, "dequant_matmul": 0}
# the MultiDiffusion upscale: strength 0.35 of 8 Euler steps keeps 3 model calls, each 9 tiles
# (a 256² latent in 96² tiles at overlap 16), then the 2048² encode (1 flash, 20 conv) and decode
UPSCALE_STEPS, UPSCALE_STRENGTH, UPSCALE_TILES = 8, 0.35, 9
UPSCALE_SEEDS = (9, 10, 10)
UPSCALE_CALLS = min(int(UPSCALE_STRENGTH * UPSCALE_STEPS), UPSCALE_STEPS - 1) + 1
UPSCALE_PER_REQUEST = {"flash_attention": UPSCALE_CALLS * UPSCALE_TILES * 70 + 2,
                       "gn_silu_conv3x3": UPSCALE_CALLS * UPSCALE_TILES * 34 + 20 + 28,
                       "dequant_matmul": 0}
LORA_BLOCKS = ("input_blocks_4_1", "input_blocks_5_1", "output_blocks_3_1")
# config 2 (tests/test_torch_refiner.py traces it on the meta device): (a) 30 base calls (70
# flash, 34 conv each), then the hires pass at strength 0.7 of 30 steps, t_enc = int(0.7·30) =
# 21: 22 calls on 256² latents (70, 34 each), then the 2048² decode (1, 28); (c) the pixel
# mode adds the 1024² decode (1, 28) and the 2048² encode (1, 20); (b) the refiner takes over
# at k = round(0.8·30) = 24: 24 base calls, 6 refiner calls (40 flash: 20 at 4096 and 20 at
# 1024 tokens; 44 convs: 22 ResBlocks), then the refiner's 1024² decode (1, 28)
CONFIG2_HR_STRENGTH, CONFIG2_SWITCH_AT = 0.7, 0.8
CONFIG2_HIRES_CALLS = min(int(CONFIG2_HR_STRENGTH * SDXL_STEPS), SDXL_STEPS - 1) + 1
CONFIG2_K = max(1, min(SDXL_STEPS - 1, round(CONFIG2_SWITCH_AT * SDXL_STEPS)))
CONFIG2_LATENT_PER_REQUEST = {
    "flash_attention": (SDXL_STEPS + CONFIG2_HIRES_CALLS) * 70 + 1,
    "gn_silu_conv3x3": (SDXL_STEPS + CONFIG2_HIRES_CALLS) * 34 + 28, "dequant_matmul": 0}
CONFIG2_PIXEL_PER_REQUEST = {
    "flash_attention": CONFIG2_LATENT_PER_REQUEST["flash_attention"] + 2,
    "gn_silu_conv3x3": CONFIG2_LATENT_PER_REQUEST["gn_silu_conv3x3"] + 28 + 20,
    "dequant_matmul": 0}
CONFIG2_REFINER_PER_REQUEST = {
    "flash_attention": CONFIG2_K * 70 + (SDXL_STEPS - CONFIG2_K) * 40 + 1,
    "gn_silu_conv3x3": CONFIG2_K * 34 + (SDXL_STEPS - CONFIG2_K) * 44 + 28, "dequant_matmul": 0}
CONFIG2_PROMPT = "a photograph of an astronaut riding a horse, (detailed:1.2)"
# the samplers phase (tests/test_torch_samplers_slice.py traces it): 20 steps, each model call
# the UNet at CFG batch 2 (70 flash, 34 conv), then the 1024² decode (1, 28). DPM++ 2M, the
# first-order multistep baseline, one call a step; the second-order samplers two a step but
# none at σ = 0: 2 · 19 + 1; UniPC one call, then one a step but the peeled last; DDIM CFG++
# one a step
SAMPLERS_STEPS = 20
SAMPLERS_PHASE = {"DPM++ 2M": ("karras", 20),
                  "DPM++ SDE": ("karras", 2 * 19 + 1), "DPM2": ("karras", 2 * 19 + 1),
                  "UniPC": ("automatic", 1 + 19), "DDIM CFG++": ("automatic", 20)}
# the prompts phase (tests/test_torch_prompts_mixed.py traces it): DPM++ 2M Karras, 20 steps,
# CFG 7, 1024², one model call a step whatever the UNet's batch (2 plain, 3 with one AND part,
# 4 with two regions; the NGMS tail 1), then the 1024² decode
PROMPTS_STEPS = 20
PROMPTS_PER_REQUEST = {"flash_attention": PROMPTS_STEPS * 70 + 1,
                       "gn_silu_conv3x3": PROMPTS_STEPS * 34 + 28, "dequant_matmul": 0}
PROMPTS_EDIT = "a photo of a [cat:dog:0.5] wearing forgeemb"  # forgeemb: a dual TI embedding
PROMPTS_STYLE = ("chip smoke", "{prompt}, dramatic lighting, film grain", "lowres")
PROMPTS_AND = "a cat AND a red hat :0.8"
PROMPTS_WITNESS_SEEDS = (1, 2, 3)  # AND and "a cat", each through the kernels and plain
PROMPTS_REGIONS = [dict(prompt="a red fox in the snow", area=(0.0, 0.0, 0.5, 1.0), feather=8),
                   dict(prompt="a snowy owl on a branch", area=(0.5, 0.0, 0.5, 1.0), feather=8)]
PROMPTS_NGMS = 1.0  # s_min_uncond: the 20 Karras σ fall below it from step 11 (σ 0.791)
# the other diffusion families, each at its published widths with its model card's request
# (tests/test_torch_sd2.py, test_torch_sd3.py and test_torch_playground.py trace them): model
# calls a request, and each call's flash and fused-conv launches; every request then decodes
# (one flash, 28 convs). SD2: 15 self-attentions of ≥ 512 tokens and 22 ResBlocks a call; SD3:
# 24 joint attentions and no ResBlock; Playground: SDXL's 70 and 34
FAMILIES = {
    "sd2": dict(synth="synth_sd2_checkpoint", family="sd20", size=768, sampler="DPM++ 2M",
                scheduler="karras", steps=20, cfg=7.0, calls=20, flash=15, conv=44,
                request_gate=False),
    "sd3": dict(synth="synth_sd3_checkpoint", family="sd3", size=1024, sampler="Euler",
                scheduler="simple", steps=28, cfg=7.0, calls=28, flash=24, conv=0,
                request_gate=True),
    "playground": dict(synth="synth_playground_checkpoint", family="playground", size=1024,
                       sampler="DPM++ 2M", scheduler="karras", steps=50, cfg=3.0, calls=50,
                       flash=70, conv=34, request_gate=True),
}
# `request_gate`: the whole request's image through the kernels is held ≥ PSNR_BOUND against
# the plain versions'. SD2's reads under it (36.66 dB on an H100 80GB HBM3, its forward 49.93
# dB): its gate is the forward, as the prompts phase's AND request's, and a witness measures how
# far a perturbation of the starting noise of a bf16 rounding's size moves the plain image
FAMILY_WITNESS_SUBSEED = dict(subseed=2, subseed_strength=0.001)
# phase 14, the REST API on the SDXL engine, bench.py's `config2` request over HTTP: each
# txt2img is SDXL's 2101 flash and 1048 conv launches; under `vae_always_tiled` the 1024²
# decode runs 9 tiles of 64² latent pixels (3 × 3 at stride 56 over 128²), each a 512² decode
# (1 flash, 28 conv); the img2img at strength 0.5 of 30 steps makes 16 model calls and encodes
# 9 tiles of 512² (1 flash, 20 conv each); the 2048² tiled decode runs 25 tiles; TAESD decodes
# through cuDNN's convs, no counted kernel
API_REQUEST = dict(prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
                   steps=SDXL_STEPS, width=1024, height=1024, cfg_scale=7.0,
                   sampler_name="DPM++ 2M", scheduler="karras")
API_TILES_1024, API_TILES_2048 = 9, 25
API_IMG2IMG_STRENGTH = 0.5
API_IMG2IMG_CALLS = min(int(API_IMG2IMG_STRENGTH * SDXL_STEPS), SDXL_STEPS - 1) + 1
API_TILED_PER_REQUEST = {"flash_attention": SDXL_STEPS * 70 + API_TILES_1024,
                         "gn_silu_conv3x3": SDXL_STEPS * 34 + API_TILES_1024 * 28,
                         "dequant_matmul": 0}
API_IMG2IMG_PER_REQUEST = {"flash_attention": API_IMG2IMG_CALLS * 70 + 2 * API_TILES_1024,
                           "gn_silu_conv3x3": API_IMG2IMG_CALLS * 34 + API_TILES_1024 * (20 + 28),
                           "dequant_matmul": 0}
API_TAESD_PER_REQUEST = {"flash_attention": SDXL_STEPS * 70, "gn_silu_conv3x3": SDXL_STEPS * 34,
                         "dequant_matmul": 0}
API_INTERRUPT_AT = 10  # POST /interrupt once /progress shows this step
FAMILY_PROMPT = "a photograph of an astronaut riding a horse, (detailed:1.2)"
# phase 15, the Flux family as users download it: (a) Flux-dev written as a bitsandbytes NF4
# transformer file (block 64, no double quantization: flux1-dev-bnb-nf4-v2's layout) beside a
# VAE file and a text-encoder file, driven as phase 5; (b) fp8-e4m3 weight storage; (c) Chroma
# (lodestones/Chroma: 1024², Euler "simple", 26 steps, CFG 4 with a negative prompt). A Chroma
# request: 26 model calls at CFG batch 2, each 19 + 38 joint attentions, then the decode
FLUX_FILES_DIR = "logs/chip_smoke_flux_files"
CHROMA_STEPS, CHROMA_CFG, CHROMA_NEGATIVE = 26, 4.0, "blurry, low quality"
CHROMA_PER_REQUEST = {"flash_attention": CHROMA_STEPS * (19 + 38) + 1, "gn_silu_conv3x3": 28,
                      "dequant_matmul": 0}
FP8_PER_REQUEST = {"flash_attention": FLUX_STEPS * (19 + 38) + 1, "gn_silu_conv3x3": 28,
                   "dequant_matmul": 0}
# phase 16, the extension hook layers on the SDXL engine (tests/test_torch_cfg_hooks.py and
# test_torch_block_patches.py hold them against the reference on the CPU): SDXL 1024², DPM++ 2M
# Karras, CFG 7, batch 1 (StyleAlign batch 2), 10 steps (bench config 2's 30 cut to fit the run's
# limit: at 20 the whole run took 1110.8 s of its 1200 on an H100 80GB HBM3 at 700 W; the widths
# are not cut). A plain request: 10 forwards at CFG batch 2 (70 flash, 34 conv each), then the
# decode (1, 28). FreeU, dynamic thresholding, the latent modifier, the hypernetwork (attn2's 77
# keys: plain) and ControlLLLite (plain convs and linears) add no launch; StyleAlign joins each
# CFG half's two images into one launch of batch 2 (70 a forward); PAG's perturbed pass adds a
# batch-1 forward a step with attn1 the identity (34 conv, no flash); SAG's degraded pass a whole
# batch-1 forward a step (70 flash, 34 conv)
EXT_STEPS = 10
EXT_SIZE = 1024
EXT_PLAIN = {"flash_attention": EXT_STEPS * 70 + 1, "gn_silu_conv3x3": EXT_STEPS * 34 + 28}
EXT_PER_REQUEST = {
    "witness": EXT_PLAIN, "FreeU": EXT_PLAIN, "dynamic thresholding": EXT_PLAIN,
    "latent modifier": EXT_PLAIN, "hypernetwork": EXT_PLAIN, "StyleAlign": EXT_PLAIN,
    "ControlLLLite": EXT_PLAIN,
    "PAG": {"flash_attention": EXT_STEPS * 70 + 1, "gn_silu_conv3x3": EXT_STEPS * 68 + 28},
    "SAG": {"flash_attention": EXT_STEPS * 140 + 1, "gn_silu_conv3x3": EXT_STEPS * 68 + 28},
}
EXT_PROMPT = "a photograph of an astronaut riding a horse, (detailed:1.2)"
FREEU_SDXL = dict(b1=1.3, b2=1.4, s1=0.9, s2=0.2)  # the SDXL values FreeU's authors publish
# ControlLLLite on every SDXL transformer block: (block path, depth, channels, blocks deep);
# level 1's 64² tokens take a depth-2 embedding (/16 of 1024), level 2's and the middle's 32²
# a depth-3 one (/32)
LLLITE_BLOCKS = ([(f"input_blocks_{i}_1", 2, 640, 2) for i in (4, 5)]
                 + [(f"input_blocks_{i}_1", 3, 1280, 10) for i in (7, 8)]
                 + [("middle_block_1", 3, 1280, 10)]
                 + [(f"output_blocks_{i}_1", 3, 1280, 10) for i in (0, 1, 2)]
                 + [(f"output_blocks_{i}_1", 2, 640, 2) for i in (3, 4, 5)])
LLLITE_CE, LLLITE_MLP = 32, 64  # cond_emb_dim, mlp_dim
# phase 17: hook phases and deferred hooks on the SDXL engine (DPM++ 2M Karras, CFG 7). Counts
# by call site: a forward 70 flash / 34 conv at any size (Deep Shrink moves the shapes, not the
# count), a ControlNet beside it (cldm or Control-LoRA) 34 / 16, a VAE encode 1 / 20, a decode
# 1 / 28; the T2I-Adapter's and the Fooocus head's convs are plain F.conv2d (no kernel)
CONTROLS_STEPS = 10  # 20 under --controls
CONTROLS_SHRINK = dict(block_number=3, downscale_factor=2.0, downscale_after_skip=True,
                       downscale_method="bicubic", upscale_method="bicubic", end_percent=0.35)
CONTROLS_SHRINK_SIZE = 2048  # twice SDXL's trained size
CONTROLS_INPAINT_STRENGTH = 0.6  # config 3's
CONTROLS_T2I_CHANNELS = (320, 640, 1280, 1280)  # SDXL adapters': two resblocks a stage
CONTROLS_LORA_RANK = 128  # control-lora-canny-rank128's
CONTROLS_EXTRA_NOISE = dict(tonemap_multiplier=3.0, tonemap_method="reinhard",
                            sharpness_multiplier=10.0, sharpness_method="gaussian",
                            extra_noise_type="gaussian", extra_noise_method="add",
                            extra_noise_multiplier=50.0, seed=17)
# Deep Shrink's flash calls a step by shape: shrunk after input block 3 (skip saved at 128²
# first), levels 1 and 2 run at 1024²'s 64² and 32², but output block 5 grows back to meet that
# 128² skip, so its two transformer blocks run at 16384 tokens; unshrunk, config 2 (a)'s shapes
CONTROLS_SHRUNK_SHAPES = {(2, 10, 4096, 64): 8, (2, 10, 16384, 64): 2, (2, 20, 1024, 64): 60}
CONTROLS_FULL_SHAPES = {(2, 10, 16384, 64): 10, (2, 20, 4096, 64): 60}
CONTROLS_FLASH_SHAPES = [((2, 10, 16384, 64), 16384, True), ((2, 20, 4096, 64), 4096, True),
                         ((2, 10, 4096, 64), 4096, True), ((2, 20, 1024, 64), 1024, True)]
CONTROLS_CONV_SHAPES = [((2, 320, 256, 256), 320), ((2, 960, 128, 128), 640),
                        ((2, 640, 64, 64), 640)]  # Deep Shrink's levels 0, 1 (grown back), 1


# phase 18: the image-prompt family on the SDXL engine (tests/test_torch_image_prompts*.py and
# test_torch_reference_only_slice.py hold it against the reference on the CPU;
# tests/test_torch_image_prompts_trace.py traces these counts on the meta device): 1024², DPM++
# 2M Karras, CFG 7, seed 1, 4 steps in the whole run (20 under --image-prompts). A forward is 70
# flash / 34 conv at any batch; reference-only's in-window step adds a batch-1 recording forward
# and runs each of its CFG forward's 70 self-attentions three times (the cond rows over the
# joined keys, q(1,·,L,64) against 2L, the uncond rows over their own and over the joined keys),
# and the reference image's VAE encode adds 1 / 20; InstantID's cldm (config 3's) 34 / 16 a call.
# FaceID's 4 and InstantID's 16 IP tokens, CLIP vision's 257 tokens and PhotoMaker's fuse are
# plain: no kernel
IMAGE_PROMPT_STEPS = 4  # 20 under --image-prompts
IMAGE_PROMPT_FLASH_SHAPES = [((1, 10, 4096, 64), 8192, True), ((1, 20, 1024, 64), 2048, True)]
FLASH_SHAPES += IMAGE_PROMPT_FLASH_SHAPES
PHOTOMAKER_PROMPT = "a photograph of a man img riding a horse, (detailed:1.2)"
IMAGE_PROMPT_REFERENCE = dict(weight=1.0, threshold_a=0.5)  # style fidelity 0.5 (cubed: 0.125)
IMAGE_PROMPT_FACE = dict(weight=0.8)
IMAGE_PROMPT_DIR = "logs/chip_smoke_image_prompts"


def image_prompt_counts(steps: int):
    """Phase 18's launches a request by label."""
    def count(flash, conv, encodes=0):
        return {"flash_attention": steps * flash + encodes + 1,
                "gn_silu_conv3x3": steps * conv + 20 * encodes + 28, "dequant_matmul": 0}

    plain, two_pass = count(70, 34), count(70 + 3 * 70, 2 * 34, encodes=1)
    return {"witness": plain, "FaceID": plain, "FaceID-Plus v2": plain, "Revision": plain,
            "PhotoMaker witness": plain, "PhotoMaker": plain, "InstantID": count(70 + 34, 34 + 16),
            "reference_only": two_pass, "reference_adain+attn": two_pass,
            "reference_adain": count(2 * 70, 2 * 34, encodes=1), "API": two_pass,
            "API twin": two_pass}


def controls_counts(steps: int):
    """Phase 17's launches a request by label, and Deep Shrink's shrunk steps."""
    shrunk = int(round(CONTROLS_SHRINK["end_percent"] * steps))  # _run_phased's k_end
    calls = min(int(CONTROLS_INPAINT_STRENGTH * steps), steps - 1) + 1  # config 3's t_enc + 1

    def count(forwards, cn_forwards=0, encodes=0):
        return {"flash_attention": 70 * forwards + 34 * cn_forwards + encodes + 1,
                "gn_silu_conv3x3": 34 * forwards + 16 * cn_forwards + 20 * encodes + 28,
                "dequant_matmul": 0}

    return shrunk, {
        "shrink witness": count(steps), "Deep Shrink": count(steps),
        "txt2img witness": count(steps), "T2I-Adapter": count(steps),
        "Control-LoRA": count(steps, steps), "latent modifier": count(steps),
        "inpaint witness": count(steps, encodes=1), "Fooocus inpaint": count(steps, encodes=2),
        "config 3 witness": count(calls, encodes=1),
        "inpaint_only": count(calls, calls, encodes=2)}


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, budget_ms: float = 300.0) -> float:
    """Mean device time of fn() by CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(3, budget_ms / max((time.perf_counter() - t0) * 1e3, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    """The least time the card could take for the work, in ms, and what sets
    it: the operations at the peak rate of `dtype`, or the bytes (each input
    read once, each output written once) at the HBM rate."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FLOPS[dtype], 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sdpa_ms(q, k, v):
    """torch's scaled_dot_product_attention on the same tensors, or None where
    it refuses them; timed as a yardstick, never called by the port."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(q, k, v)
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return time_ms(lambda: sdpa(q, k, v))


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """max |got − want|, and the same over max |want|: attention outputs of
    unit-normal inputs are averages far below 1, so no floor of 1."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output is finite")
    err = (got - want).abs().max().item()
    return err, err / want.abs().max().item()


def dequant_leaf(kind: str, block: int, n: int, k: int, gen: torch.Generator):
    from forge_tpu_torch.ops import quant

    w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
    if kind in ("gq4", "gq8"):
        return getattr(quant, f"quantize_{kind}")(w, block=block)
    return quant.quantize(w, kind)


def leaf_bytes(leaf) -> int:
    return sum(t.numel() * t.element_size() for t in (leaf.codes, leaf.scales, leaf.mins)
               if t is not None)


def phase_dequant(gen: torch.Generator, summary, cases=DEQUANT_CASES):
    from forge_tpu_torch.ops.dequant_matmul import (dequant_body, dequant_matmul,
                                                    dequant_matmul_plain)

    for kind, block, (m, n, k) in cases:
        leaf = dequant_leaf(kind, block, n, k, gen)
        for dtype, tol in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            body = dequant_body(m, dtype)
            before = dequant_matmul.launches_by_body[body]
            got = dequant_matmul(x, leaf)
            check(dequant_matmul.launches_by_body[body] == before + 1,
                  f"dequant_matmul {kind} {dtype} {(m, n, k)} ran the {body} body")
            err, rel = rel_err(got, dequant_matmul_plain(x, leaf))
            check(torch.equal(got, dequant_matmul(x, leaf)), "dequant_matmul rerun is bit-identical")
            ms = time_ms(lambda: dequant_matmul(x, leaf))
            plain_ms = time_ms(lambda: dequant_matmul_plain(x, leaf))
            # x read once, y written once (both in x's dtype), the leaf's codes, scales, mins
            bms, by = bound(2.0 * m * n * k, x.element_size() * (m * k + m * n) + leaf_bytes(leaf),
                            dtype)
            log(f"dequant {kind}/{block} {str(dtype)[6:]} {m}x{n}x{k} [{body}]: err {err:.3e} "
                f"rel {rel:.3e} (bound {tol:g}) | kernel {ms:.4f} ms "
                f"{2.0 * m * n * k / (ms * 1e9):.2f} TFLOP/s | plain {plain_ms:.4f} ms "
                f"| card bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f} % of it")
            check(rel <= tol, f"dequant_matmul {kind} {dtype} {(m, n, k)} within {tol}")
            if dtype == torch.bfloat16 and (m, n, k) in DEQUANT_SHAPES[:2]:
                # the earlier body at the largest products, in the same run
                simt = dequant_matmul(x, leaf, body="simt")
                simt_err, simt_rel = rel_err(simt, dequant_matmul_plain(x, leaf))
                simt_ms = time_ms(lambda: dequant_matmul(x, leaf, body="simt"))
                log(f"  same, simt body: err {simt_err:.3e} rel {simt_rel:.3e} | "
                    f"{simt_ms:.4f} ms {2.0 * m * n * k / (simt_ms * 1e9):.2f} TFLOP/s "
                    f"| {body} body {simt_ms / ms:.2f}x faster")
                check(simt_rel <= tol, f"dequant_matmul simt body {kind} {(m, n, k)} within {tol}")
                check(ms < simt_ms, f"{body} body faster than the simt body at {kind} {(m, n, k)}")
                if (kind, (m, n, k)) == ("nf4", DEQUANT_SHAPES[0]):
                    summary["dequant_matmul"] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": None, "ms_by_body": {body: ms, "simt": simt_ms}}
                del simt
            del x, got
        del leaf
    torch.cuda.empty_cache()


def phase_flash(gen: torch.Generator, summary, shapes=FLASH_SHAPES):
    from forge_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_plain,
                                                     flash_body)

    for dtype, tol in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for (b, h, lq, d), lk, main_path in shapes:
            # plain holds every logit in f32: past PLAIN_MAX_LOGITS it is held on the first and
            # the last 1024 query rows against all of K and V (rows are independent, so that is
            # exact), and the shape is run in bf16 only
            rows = (None if b * h * lq * lk <= PLAIN_MAX_LOGITS
                    else torch.cat([torch.arange(1024), torch.arange(lq - 1024, lq)]).cuda())
            if rows is not None and dtype == torch.float32:
                continue
            q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dtype)
            q_plain = q if rows is None else q[:, :, rows]
            body = flash_body(d, dtype)
            before = flash_attention.launches_by_body[body]
            got = flash_attention(q, k, v)
            check(flash_attention.launches_by_body[body] == before + 1,
                  f"flash_attention {dtype} {(b, h, lq, d)} ran the {body} body")
            want = flash_attention_plain(q_plain, k, v)
            err, rel = rel_err(got if rows is None else got[:, :, rows], want)
            check(torch.equal(got, flash_attention(q, k, v)), "flash_attention rerun is bit-identical")
            ms = time_ms(lambda: flash_attention(q, k, v))
            plain_ms = time_ms(lambda: flash_attention_plain(q_plain, k, v))
            bms, by = bound(4.0 * b * h * lq * lk * d,  # q, k, v read once, the output written once
                            2 * (q.numel() + k.numel()) * q.element_size(), dtype)
            log(f"flash_attention {str(dtype)[6:]:8s} q{(b, h, lq, d)} lk={lk} [{body}]: "
                f"max_abs_err={err:.3e} rel={rel:.3e} (bound {tol:g}"
                + ("" if rows is None else f"; plain on {len(rows)} of the {lq} query rows")
                + f") kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                + ("" if rows is None else f" ({len(rows)} rows)")
                + f" | card bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f} % of it")
            check(rel <= tol, f"flash_attention {dtype} {(b, h, lq, d)} within {tol}")
            if dtype == torch.bfloat16 and main_path:
                simt = flash_attention(q, k, v, body="simt")
                simt_err, simt_rel = rel_err(simt if rows is None else simt[:, :, rows], want)
                simt_ms = time_ms(lambda: flash_attention(q, k, v, body="simt"))
                lib_ms = sdpa_ms(q, k, v)
                log(f"  same, simt body: err {simt_err:.3e} rel {simt_rel:.3e} | {simt_ms:.4f} ms "
                    f"| {body} body {simt_ms / ms:.2f}x faster | SDPA "
                    + (f"{lib_ms:.4f} ms" if lib_ms is not None else "not measured"))
                check(simt_rel <= tol, f"flash_attention simt body {(b, h, lq, d)} within {tol}")
                check(ms < simt_ms, f"{body} body faster than the simt body at {(b, h, lq, d)}")
                if (b, h, lq, d) == FLASH_SUMMARY_SHAPE:
                    summary["flash_attention"] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": lib_ms,
                        "ms_by_body": {body: ms, "simt": simt_ms}}
                del simt
            del q, k, v, q_plain, got, want
    torch.cuda.empty_cache()


def phase_conv(gen: torch.Generator, summary, shapes=GN_CONV_SHAPES):
    import torch.nn.functional as F

    from forge_tpu_torch.ops.fused_gn_conv import conv_body, gn_silu_conv3x3, gn_silu_conv3x3_plain

    for dtype, tol in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for (b, c, hh, ww), o in shapes:
            x = torch.randn((b, c, hh, ww), generator=gen, device="cuda").to(dtype)
            a = 1.0 + 0.1 * torch.randn((b, c), generator=gen, device="cuda")
            s = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
            w = (torch.randn((o, c, 3, 3), generator=gen, device="cuda")
                 / math.sqrt(9 * c)).to(dtype)
            bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
            body = conv_body(c, o, dtype)
            # each body's weight in the layout it reads, as the loader stores it
            wk = w.contiguous(memory_format=torch.channels_last) if body == "wgmma" else w
            before = gn_silu_conv3x3.launches_by_body[body]
            got = gn_silu_conv3x3(x, a, s, wk, bias)
            check(gn_silu_conv3x3.launches_by_body[body] == before + 1,
                  f"gn_silu_conv3x3 {dtype} {(b, c, hh, ww)} ran the {body} body")
            want = gn_silu_conv3x3_plain(x, a, s, w, bias)
            err, rel = rel_err(got, want)
            check(torch.equal(got, gn_silu_conv3x3(x, a, s, wk, bias)),
                  "gn_silu_conv3x3 rerun is bit-identical")
            ms = time_ms(lambda: gn_silu_conv3x3(x, a, s, wk, bias))
            plain_ms = time_ms(lambda: gn_silu_conv3x3_plain(x, a, s, w, bias))
            bms, by = bound(2.0 * b * o * hh * ww * c * 9,
                            x.element_size() * (x.numel() + b * o * hh * ww + w.numel())
                            + 4 * (a.numel() + s.numel() + bias.numel()), dtype)
            log(f"gn_silu_conv3x3 {str(dtype)[6:]:8s} x{(b, c, hh, ww)}->{o} [{body}]: "
                f"max_abs_err={err:.3e} rel={rel:.3e} (bound {tol:g}) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms | card bound {bms:.4f} ms ({by}), "
                f"{100 * bms / ms:.1f} % of it")
            check(rel <= tol, f"gn_silu_conv3x3 {dtype} {(b, c, hh, ww)} within {tol}")
            if dtype == torch.bfloat16:
                simt = gn_silu_conv3x3(x, a, s, w, bias, body="simt")
                simt_err, simt_rel = rel_err(simt, want)
                simt_ms = time_ms(lambda: gn_silu_conv3x3(x, a, s, w, bias, body="simt"))
                h = (x.float() * a[:, :, None, None] + s[:, :, None, None])
                h = (h * torch.sigmoid(h)).to(dtype)
                bias_t = bias.to(dtype)
                cudnn_ms = time_ms(lambda: F.conv2d(h, w, bias_t, padding=1))
                log(f"  same, simt body: err {simt_err:.3e} rel {simt_rel:.3e} | {simt_ms:.4f} ms "
                    f"| {body} body {simt_ms / ms:.2f}x faster | cudnn conv alone "
                    f"{cudnn_ms:.4f} ms")
                check(simt_rel <= tol, f"gn_silu_conv3x3 simt body {(b, c, hh, ww)} within {tol}")
                check(ms < simt_ms, f"{body} body faster than the simt body at {(b, c, hh, ww)}")
                if ((b, c, hh, ww), o) == GN_CONV_SHAPES[0]:
                    summary["gn_silu_conv3x3"] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": by, "library_ms": None,
                        "ms_by_body": {body: ms, "simt": simt_ms}}
                del simt, h
            del x, w, wk, got, want
    torch.cuda.empty_cache()


def phase_kernels(gen: torch.Generator, rows: str = "all"):
    """Phase 2; with rows "families", "api", "flux_family", "extensions" or
    "controls" or "image_prompts", the flash and conv rows of the SD2, SD3
    and Playground paths, of phase 14's VAE tiles, of phase 15 (with its NF4
    dequant rows), of phase 16 (StyleAlign's two flash rows), of phase 17
    (Deep Shrink's four flash shapes and three conv shapes) or of phase 18
    (reference-only's two joined-key flash shapes) alone."""
    summary = {}
    if rows != "all":
        flash, conv = {"families": (FAMILY_FLASH_SHAPES, FAMILY_CONV_SHAPES),
                       "api": (TILE_FLASH_SHAPES, TILE_CONV_SHAPES),
                       "flux_family": (FLUX_FAMILY_FLASH_SHAPES, FLUX_FAMILY_CONV_SHAPES),
                       "extensions": (EXTENSIONS_FLASH_SHAPES, []),
                       "controls": (CONTROLS_FLASH_SHAPES, CONTROLS_CONV_SHAPES),
                       "image_prompts": (IMAGE_PROMPT_FLASH_SHAPES, [])}[rows]
        phase_flash(gen, summary, flash)
        phase_conv(gen, summary, conv)
        if rows == "flux_family":  # the NF4 rows at Flux-dev's largest products
            phase_dequant(gen, summary, [c for c in DEQUANT_CASES
                                         if c[0] == "nf4" and c[2] in DEQUANT_SHAPES[:2]])
        return summary
    phase_flash(gen, summary)
    phase_conv(gen, summary)
    phase_dequant(gen, summary)
    return summary


def counters():
    from forge_tpu_torch.ops.dequant_matmul import dequant_matmul
    from forge_tpu_torch.ops.flash_attention import flash_attention
    from forge_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3

    return {"flash_attention": flash_attention, "gn_silu_conv3x3": gn_silu_conv3x3,
            "dequant_matmul": dequant_matmul}


BY_BODY = ("flash_attention", "gn_silu_conv3x3", "dequant_matmul")  # kernels with two bodies


def zero_counts():
    for name, fn in counters().items():
        fn.launches = 0
        if name in BY_BODY:
            fn.launches_by_body.update(dict.fromkeys(fn.launches_by_body, 0))


def read_counts():
    """Launches by kernel, and each two-bodied kernel's by body as "name[body]"."""
    counts = {name: fn.launches for name, fn in counters().items()}
    for name in BY_BODY:
        for body, n in counters()[name].launches_by_body.items():
            counts[f"{name}[{body}]"] = n
    return counts


def phase_slice():
    from forge_tpu_torch.core.synth import DeviceFill, synth_sd15_checkpoint
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    t1 = time.perf_counter()
    engine = load_engine(synth_sd15_checkpoint(fill=DeviceFill("cuda", seed=0)), device="cuda")
    torch.cuda.synchronize()
    log(f"slice: SD1.5 weights made on the card + load_engine {time.perf_counter() - t1:.2f} s, "
        f"dtype {engine.compute_dtype}")
    check(engine.compute_dtype == torch.bfloat16, "bf16 compute on CUDA")

    zero_counts()
    images, latencies = [], []

    def request(seed):
        return Processing(prompt="a photograph of an astronaut riding a horse",
                          negative_prompt="blurry", seed=seed, steps=20, cfg_scale=7.0,
                          width=512, height=512, sampler_name="Euler a")

    for seed in (1, 2, 1):
        p = request(seed)
        t = time.perf_counter()
        res = process_images(engine, p)
        latencies.append(time.perf_counter() - t)
        img = res.images[0]
        check(img.shape == (512, 512, 3) and img.dtype == np.uint8, "512×512×3 uint8 image")
        images.append(img)
        log(f"request seed={seed}: latency {latencies[-1]:.4f} s, "
            f"{p.steps / latencies[-1]:.3f} steps/s, timings "
            + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
            + f", image mean {img.mean():.3f} std {img.std():.3f}")
    launches = read_counts()
    check(np.array_equal(images[0], images[2]), "seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "seeds 1 and 2 differ")
    for name, expect in EXPECTED_PER_REQUEST.items():
        n = launches[name]
        log(f"launches during the 3 requests: {name} {n} (expected {3 * expect}: "
            f"{'matches' if n == 3 * expect else 'DIFFERS'})")
        check(n > 0, f"{name} launched on the SD1.5 path")
    for name in ("flash_attention", "gn_silu_conv3x3"):
        n = 3 * EXPECTED_PER_REQUEST[name]
        log(f"launches during the 3 requests: {name}[wgmma] "
            f"{launches[name + '[wgmma]']}, [simt] {launches[name + '[simt]']}")
        check(launches[name] == launches[name + "[wgmma]"] == n and launches[name + "[simt]"] == 0,
              f"all {n} {name} launches of the SD1.5 requests on the tensor-core body")
    log("slice: seed 1 repeat byte-identical, NaN checks passed")
    profile_request("sd15 512²", lambda: process_images(engine, request(1)))
    return engine, launches


def phase_unet(engine, gen: torch.Generator):
    from forge_tpu_torch.ops import plain_versions

    x = torch.randn((2, 4, 64, 64), generator=gen, device=gen.device).to(engine.compute_dtype)
    t = torch.tensor([999.0, 400.0], device=gen.device)
    cond = engine.get_learned_conditioning(["a photograph of an astronaut riding a horse",
                                            "blurry"])["context"]
    apply = engine.unet_apply_fn()
    with torch.no_grad():
        fused = apply(engine.loaded.unet, x, t, cond)
        with plain_versions():
            plain = apply(engine.loaded.unet, x, t, cond)
    value = psnr(fused, plain)
    log(f"unet 64x64 B=2 bf16: kernels vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
    check(value >= PSNR_BOUND, f"UNet PSNR ≥ {PSNR_BOUND} dB")


def psnr(got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernels' output `got` against the plain versions' `want`; `got` must be finite."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "output finite")
    mse = ((got - want) ** 2).mean().item()
    return float("inf") if mse == 0 else 10 * math.log10(want.abs().max().item() ** 2 / mse)


def quant_leaves(tree) -> int:
    from forge_tpu_torch.ops.quant import QuantLeaf

    if isinstance(tree, QuantLeaf):
        return 1
    return sum(quant_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 0


def load_flux(unet_quant: str):
    from forge_tpu_torch.core.synth import DeviceFill, synth_flux_checkpoint
    from forge_tpu_torch.pipeline.engine import load_engine

    torch.cuda.synchronize()
    t = time.perf_counter()
    engine = load_engine(synth_flux_checkpoint(fill=DeviceFill("cuda", seed=0)), device="cuda",
                         unet_quant=unet_quant)
    torch.cuda.synchronize()
    n_quant = quant_leaves(engine.loaded.unet)
    log(f"flux {unet_quant}: Flux-dev + T5-XXL + CLIP-L + VAE made on the card and loaded in "
        f"{time.perf_counter() - t:.2f} s; {n_quant} quantized leaves; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(engine.compute_dtype == torch.bfloat16, "bf16 compute on CUDA")
    check(engine.flux_cfg.num_heads == 24 and len(engine.loaded.unet["double_blocks"]) == 19
          and len(engine.loaded.unet["single_blocks"]) == 38, "Flux-dev width and depth")
    return engine, n_quant


def flux_request(engine, seed: int, label: str, size: int = 1024):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(prompt=FLUX_PROMPT, seed=seed, steps=FLUX_STEPS, cfg_scale=1.0,
                   distilled_cfg_scale=3.5, width=size, height=size, sampler_name="Euler",
                   scheduler="simple")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (size, size, 3) and img.dtype == np.uint8, f"{size}²×3 uint8 image")
    log(f"flux request {label} seed={seed}: latency {latency:.4f} s, "
        f"{FLUX_STEPS / latency:.4f} steps/s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img, latency


def check_flux_counts(launches, n_quant: int, requests: int, what: str):
    """Per request: every quantized leaf once a forward, the joint attention of
    19 + 38 blocks a forward plus the VAE mid-block, and 28 VAE resnet convs.
    Of the leaves, the modulations (2 a double block, 1 a single block, the
    final layer's) and the time, vector and guidance embedders (6) have
    M = 1; every other leaf sees all 512 text, 4096 image or 4608 joint
    tokens. Each group counts on the body `dequant_body` gives its M."""
    from forge_tpu_torch.ops.dequant_matmul import BODY_CODES, dequant_body
    from forge_tpu_torch.ops.flash_attention import flash_body

    m1 = 2 * 19 + 38 + 1 + 6
    flash = requests * (FLUX_STEPS * (19 + 38) + 1)  # the joint attention (d 128), the VAE's (d 512)
    check(flash_body(128, torch.bfloat16) == flash_body(512, torch.bfloat16) == "wgmma",
          "Flux's flash calls take the tensor-core body")
    per_forward = dict.fromkeys(BODY_CODES, 0)
    per_forward[dequant_body(1, torch.bfloat16)] += m1
    per_forward[dequant_body(512, torch.bfloat16)] += n_quant - m1
    expect = {"dequant_matmul": requests * FLUX_STEPS * n_quant,
              **{f"dequant_matmul[{body}]": requests * FLUX_STEPS * n
                 for body, n in per_forward.items()},
              "flash_attention": flash, "flash_attention[wgmma]": flash,
              "flash_attention[simt]": 0,
              "gn_silu_conv3x3": requests * 28, "gn_silu_conv3x3[wgmma]": requests * 28,
              "gn_silu_conv3x3[simt]": 0}
    for name, want in expect.items():
        log(f"launches during {what}: {name} {launches[name]} (expected {want})")
        check(launches[name] == want, f"{name} launched exactly {want} times on the Flux path")


def phase_flux():
    from forge_tpu_torch.ops import plain_versions

    engine, n_quant = load_flux("nf4")
    check(n_quant == 10 * 19 + 3 * 38 + 10, "314 quantized leaves in the Flux-dev tree")
    zero_counts()
    runs = [flux_request(engine, seed, "nf4") for seed in (1, 2, 1)]
    images = [img for img, _ in runs]
    launches = read_counts()
    check_flux_counts(launches, n_quant, 3, "the 3 NF4 requests")
    check(np.array_equal(images[0], images[2]), "Flux seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "Flux seeds 1 and 2 differ")

    with plain_versions():
        plain_img, _ = flux_request(engine, 1, "nf4, plain versions")
    diff = np.abs(plain_img.astype(np.int16) - images[0].astype(np.int16))
    log(f"flux nf4 image, kernels vs plain versions: max |Δ| {diff.max()} of 255, "
        f"mean |Δ| {diff.mean():.4f}")
    profile_request("flux nf4 1024²", lambda: flux_request(engine, 1, "nf4, profiled"))
    phase_flux_blocks(engine)
    del engine
    torch.cuda.empty_cache()

    engine, n_quant = load_flux("q4_0")
    zero_counts()
    img, _ = flux_request(engine, 1, "q4_0")
    q4_launches = read_counts()
    check_flux_counts(q4_launches, n_quant, 1, "the Q4_0 request")
    check(float(img.std()) > 0, "Q4_0 image is not constant")
    del engine
    torch.cuda.empty_cache()
    # seed 1's NF4 image and latency: phase 15's bnb file must give the same bytes
    return {name: launches[name] + q4_launches[name] for name in launches}, runs[2]


def phase_flux_blocks(engine, size: int = 1024,
                      parts=("double block 0", "single block 0", "whole forward")):
    """Kernels vs plain versions on one double block, one single block and
    one whole forward (the `parts` named) at the engine's width, on
    size²-sized inputs."""
    from forge_tpu_torch.models import flux as flux_mod
    from forge_tpu_torch.ops import plain_versions

    dt, dev, cfg = engine.compute_dtype, engine.device, engine.flux_cfg
    gen = torch.Generator(device=dev).manual_seed(1)
    params = engine.loaded.unet
    hidden = params["img_in"]["weight"].shape[0]
    side = size // 16  # image tokens per side after the VAE's 8× and the 2×2 patches
    cond = engine.get_learned_conditioning([FLUX_PROMPT])
    l_txt = cond["context"].shape[1]
    img = torch.randn((1, side * side, hidden), generator=gen, device=dev).to(dt)
    txt = torch.randn((1, l_txt, hidden), generator=gen, device=dev).to(dt)
    vec = torch.randn((1, hidden), generator=gen, device=dev).to(dt)
    ids = flux_mod.position_ids(1, l_txt, side, side, dev)
    pe = flux_mod.embed_nd(ids, cfg.axes_dim, cfg.theta)
    x = torch.randn((1, 16, 2 * side, 2 * side), generator=gen, device=dev).to(dt)
    t = torch.tensor([1000.0 * 0.7], device=dev)
    g = torch.tensor([3.5], device=dev)
    runs = {
        "double block 0": lambda: flux_mod.double_block(params["double_blocks"]["0"], img, txt,
                                                        vec, pe, cfg),
        "single block 0": lambda: (flux_mod.single_block(params["single_blocks"]["0"],
                                                         torch.cat([txt, img], dim=1), vec, pe,
                                                         cfg),),
        "whole forward": lambda: (flux_mod.flux_apply(params, x, t, cond["context"], cond["y"],
                                                      guidance=g, cfg=cfg),),
    }
    with torch.no_grad():
        for name, fn in runs.items():
            if name not in parts:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with plain_versions():
                plain = fn()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            worst = min(psnr(a, b) for a, b in zip(fused, plain))
            log(f"flux {name}, {str(dt)[6:]}: kernels vs plain PSNR {worst:.2f} dB "
                f"(bound {PSNR_BOUND}); kernels {t1 - t0:.4f} s, plain {t2 - t1:.4f} s")
            check(worst >= PSNR_BOUND, f"Flux {name} PSNR ≥ {PSNR_BOUND} dB")


def check_counts(launches, per_request, requests: int, what: str):
    """Each kernel's launches exactly `requests` × its count a request, all on the tensor-core body."""
    for name, per in per_request.items():
        want = requests * per
        log(f"launches during {what}: {name} {launches[name]} (expected {want})")
        check(launches[name] == want, f"{name} launched exactly {want} times during {what}")
        if name in ("flash_attention", "gn_silu_conv3x3"):
            log(f"  {name}[wgmma] {launches[name + '[wgmma]']}, [simt] {launches[name + '[simt]']}")
            check(launches[name + "[wgmma]"] == want and launches[name + "[simt]"] == 0,
                  f"all {want} {name} launches during {what} on the tensor-core body")


def sdxl_request(engine, seed: int, label: str):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(prompt="a photograph of an astronaut riding a horse, (detailed:1.2)",
                   negative_prompt="blurry", seed=seed, steps=SDXL_STEPS, cfg_scale=7.0,
                   width=1024, height=1024, sampler_name="DPM++ 2M", scheduler="karras")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8, "1024²×3 uint8 image")
    log(f"sdxl request {label} seed={seed}: latency {latency:.4f} s, "
        f"{SDXL_STEPS / latency:.4f} steps/s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img


def load_sdxl():
    """The full-width SDXL base engine, its weights made on the card from seed 0."""
    from forge_tpu_torch.core.synth import DeviceFill, synth_sdxl_checkpoint
    from forge_tpu_torch.pipeline.engine import load_engine

    engine, _ = timed("sdxl: SDXL base weights made on the card + load_engine", lambda: load_engine(
        synth_sdxl_checkpoint(fill=DeviceFill("cuda", seed=0)), device="cuda"))
    return engine


def phase_sdxl(gen: torch.Generator):
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.ops import plain_versions

    engine = load_sdxl()
    unet, tes = engine.loaded.unet, engine.loaded.text_encoders
    blocks = sum(k.endswith("attn1.to_q.weight") for k in flatten(unet))
    ctx = unet["middle_block"]["1"]["transformer_blocks"]["0"]["attn2"]["to_k"]["weight"].shape[1]
    adm = unet["label_emb"]["0"]["0"]["weight"].shape[1]
    g_width = tes["clip_g"]["text_model"]["embeddings"]["token_embedding"]["weight"].shape[1]
    log(f"sdxl: SDXL base + CLIP-L + CLIP-G + VAE: family {engine.family}, {blocks} transformer blocks, "
        f"context {ctx}, adm {adm}, CLIP-G width {g_width} × {len(tes['clip_g']['text_model']['encoder']['layers'])} "
        f"layers; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(engine.family == "sdxl" and engine.compute_dtype == torch.bfloat16, "SDXL engine, bf16")
    check(blocks == 70 and ctx == 2048 and adm == 2816 and g_width == 1280
          and set(engine.text_engines) == {"clip_l", "clip_g"}, "SDXL base at full width")

    zero_counts()
    images = [sdxl_request(engine, seed, "") for seed in (1, 2, 1)]
    launches = read_counts()
    check(np.array_equal(images[0], images[2]), "SDXL seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "SDXL seeds 1 and 2 differ")
    check_counts(launches, SDXL_PER_REQUEST, 3, "the 3 SDXL requests")
    profile_request("sdxl 1024²", lambda: sdxl_request(engine, 1, "profiled"))

    x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
    ts = torch.tensor([999.0, 400.0], device="cuda")
    cond = engine.get_learned_conditioning(["a photograph of an astronaut riding a horse",
                                            "blurry"], 1024, 1024)
    apply = engine.unet_apply_fn()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = apply(unet, x, ts, cond["context"], y=cond["y"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with plain_versions():
            plain = apply(unet, x, ts, cond["context"], y=cond["y"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    value = psnr(fused, plain)
    log(f"sdxl unet 128x128 B=2 bf16: kernels vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND}); "
        f"kernels {t1 - t0:.4f} s, plain {t2 - t1:.4f} s")
    check(value >= PSNR_BOUND, f"SDXL UNet PSNR ≥ {PSNR_BOUND} dB")
    del x, fused, plain
    torch.cuda.empty_cache()
    return engine, launches


def bench_lora(lora_dir: str):
    """bench.py's config-3 LoRA: rank 16, alpha 16, over attn1 q/k/v of three
    640-wide transformer blocks, written by the port's safetensors writer.
    → {(block, proj): (up, down)}."""
    from forge_tpu_torch.core.save import save_safetensors

    rank, rng = 16, np.random.default_rng(0)
    sd, factors = {}, {}
    for blk in LORA_BLOCKS:
        for proj in ("to_q", "to_k", "to_v"):
            base = f"lora_unet_{blk}_transformer_blocks_0_attn1_{proj}"
            up = (rng.standard_normal((640, rank)) * 0.01).astype(np.float32)
            down = (rng.standard_normal((rank, 640)) * 0.01).astype(np.float32)
            sd.update({base + ".lora_up.weight": up, base + ".lora_down.weight": down,
                       base + ".alpha": np.asarray(rank, np.float32)})
            factors[(blk, proj)] = (up, down)
    os.makedirs(lora_dir, exist_ok=True)
    save_safetensors(sd, os.path.join(lora_dir, "bench.safetensors"))
    return factors, rng


def config3_request(engine, seed: int, label: str, init, mask, control):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(prompt=CONFIG3_PROMPT, seed=seed, steps=CONFIG3_STEPS, width=1024,
                   height=1024, cfg_scale=7.0, sampler_name="DPM++ 2M", scheduler="karras",
                   init_images=[init], denoising_strength=CONFIG3_STRENGTH, inpaint_mask=mask,
                   controlnets=[control])
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8, "1024²×3 uint8 image")
    log(f"config3 request {label} seed={seed}: latency {latency:.4f} s, "
        f"{CONFIG3_CALLS / latency:.4f} model calls/s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img


def phase_config3(engine, gen: torch.Generator):
    """bench.py config 3 on the SDXL engine: img2img + inpaint mask + LoRA +
    ControlNet-canny at 1024²."""
    from forge_tpu_torch.core.loader import load_controlnet
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd
    from forge_tpu_torch.models.controlnet import ControlNetState
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline.extra_networks import LoraRegistry, activate
    from forge_tpu_torch.preprocessors.cv import canny

    torch.cuda.synchronize()
    t = time.perf_counter()
    cn = load_controlnet(synth_controlnet_sd(fill=DeviceFill("cuda", seed=0)),
                         engine.compute_dtype, "cuda")
    torch.cuda.synchronize()
    conv = cn["input_blocks"]["1"]["0"]["in_layers"]["2"]["weight"]
    check(conv.is_contiguous(memory_format=torch.channels_last),
          "the ControlNet's fused conv weights are channels_last")
    log(f"config3: SDXL ControlNet made on the card and loaded in {time.perf_counter() - t:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    lora_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs", "chip_smoke_lora")
    factors, rng = bench_lora(lora_dir)
    engine.lora_registry = LoraRegistry([lora_dir])
    init = rng.uniform(0, 255, size=(1024, 1024, 3)).astype(np.uint8)
    t = time.perf_counter()
    edges = canny(init)
    hint = torch.from_numpy(np.repeat(edges[None, None], 3, axis=1)).cuda()
    log(f"config3: canny of the init image {time.perf_counter() - t:.2f} s on the host, "
        f"{edges.mean():.5f} of pixels on an edge")
    mask = np.zeros((1024, 1024), np.float32)
    mask[256:768, 256:768] = 1.0
    control = ControlNetState(params=cn, hint=hint, strength=1.0,
                              cfg=UNetConfig.for_family("sdxl"))

    unet = engine.loaded.unet
    base = {(blk, proj): lora_target(unet, blk, proj).clone() for blk, proj in factors}
    zero_counts()
    images = [config3_request(engine, seed, "", init, mask, control) for seed in (1, 2, 1)]
    launches = read_counts()
    check(np.array_equal(images[0], images[2]), "config3 seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "config3 seeds 1 and 2 differ")
    check_counts(launches, CONFIG3_PER_REQUEST, 3, "the 3 config3 requests")
    far = np.ones((1024, 1024), bool)  # the blur's support ends 4σ = 16 px past the square
    far[256 - 17:768 + 17, 256 - 17:768 + 17] = False
    for img in images:
        check(np.array_equal(img[far], init[far]), "every pixel 17 px past the mask is the init's")
        check(not np.array_equal(img[~far], init[~far]), "the masked square was repainted")
    log(f"config3: seed 1 repeat byte-identical; {int(far.sum())} unmasked ring pixels equal the "
        "init image's in all 3 images")
    profile_request("config3 1024²", lambda: config3_request(engine, 1, "profiled", init, mask,
                                                             control))

    # the LoRA: merged weights against base + 0.8·(α/r)·up·down, the engine's own unchanged
    _, patched, _ = activate(engine, [CONFIG3_PROMPT], registry=engine.lora_registry)
    worst = 0.0
    for (blk, proj), (up, down) in factors.items():
        w0 = base[(blk, proj)]
        check(torch.equal(lora_target(unet, blk, proj), w0), f"engine's {blk} {proj} unchanged")
        want = w0.float() + 0.8 * (16 / 16) * torch.from_numpy(up @ down).cuda()
        got = lora_target(patched, blk, proj)
        check(got.dtype == w0.dtype and not torch.equal(got, w0), f"{blk} {proj} merged")
        worst = max(worst, ((got.float() - want).abs().max() / want.abs().max()).item())
    log(f"config3 LoRA: 9 merged attn1 weights within {worst:.3e} of base + 0.8·up·down "
        f"(bound {2 ** -8:.3e}, bf16 rounding); the engine's weights unchanged")
    check(worst <= 2 ** -8, "merged LoRA weights within bf16 rounding")

    # kernels vs plain versions: the VAE encode at 1024², a UNet + ControlNet forward
    x = torch.from_numpy(init.astype(np.float32)[None].transpose(0, 3, 1, 2) / 127.5 - 1.0)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = engine.encode_first_stage(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with plain_versions():
            plain = engine.encode_first_stage(x)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    value = psnr(fused, plain)
    log(f"vae encode 1024² bf16: kernels vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND}); "
        f"kernels {t1 - t0:.4f} s, plain {t2 - t1:.4f} s")
    check(value >= PSNR_BOUND, f"VAE encode PSNR ≥ {PSNR_BOUND} dB")
    xl = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
    ts = torch.tensor([999.0, 400.0], device="cuda")
    cond = engine.get_learned_conditioning(["a castle", ""], 1024, 1024)
    apply = engine.unet_apply_fn(controlnets=[control])
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = apply(unet, xl, ts, cond["context"], y=cond["y"], t_host=999.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with plain_versions():
            plain = apply(unet, xl, ts, cond["context"], y=cond["y"], t_host=999.0)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    value = psnr(fused, plain)
    log(f"sdxl unet + controlnet 128x128 B=2 bf16: kernels vs plain PSNR {value:.2f} dB "
        f"(bound {PSNR_BOUND}); kernels {t1 - t0:.4f} s, plain {t2 - t1:.4f} s")
    check(value >= PSNR_BOUND, f"SDXL UNet + ControlNet PSNR ≥ {PSNR_BOUND} dB")
    del cn, control, fused, plain, patched
    torch.cuda.empty_cache()
    return launches


def lora_target(unet, blk: str, proj: str) -> torch.Tensor:
    """The weight `lora_unet_{blk}_transformer_blocks_0_attn1_{proj}` patches."""
    kind, _, i, j = blk.split("_")
    return unet[f"{kind}_blocks"][i][j]["transformer_blocks"]["0"]["attn1"][proj]["weight"]


def config5_request(seed: int, prompt: str, hooks):
    from forge_tpu_torch.pipeline.processing import Processing

    return Processing(prompt=prompt, seed=seed, steps=CONFIG5_STEPS, width=1024, height=1024,
                      cfg_scale=7.0, sampler_name="DPM++ 2M", scheduler="karras",
                      batch_size=CONFIG5_BATCH, unet_hooks=hooks)


def upscale_request(image: np.ndarray, seed: int):
    """bench.py's MultiDiffusion 2× upscale: the image ×2 by pixel repeat, img2img
    over the 2048² canvas denoised in 96-pixel latent tiles."""
    from forge_tpu_torch.pipeline.processing import Processing

    return Processing(prompt="detailed", seed=seed, steps=UPSCALE_STEPS, width=2048, height=2048,
                      cfg_scale=7.0, sampler_name="Euler",
                      init_images=[np.kron(image, np.ones((2, 2, 1))).astype(np.uint8)],
                      denoising_strength=UPSCALE_STRENGTH,
                      tiled_diffusion={"tile": 96, "overlap": 16})


def timed(label: str, run):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    log(f"{label}: {seconds:.4f} s")
    return out, seconds


def phase_config5(engine, gen: torch.Generator):
    """bench.py config 5 on the SDXL engine: batched serving with an SDXL
    IP-Adapter (CLIP-ViT-H/14 image encoder), then a MultiDiffusion 2×
    upscale to 2048²."""
    from forge_tpu_torch.core.loader import load_clip_vision, load_ip_adapter
    from forge_tpu_torch.core.synth import DeviceFill, synth_clip_vision_sd, synth_ip_adapter_sd
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline.ipadapter import build_ip_adapter_hooks, encode_image
    from forge_tpu_torch.pipeline.processing import process_images
    from forge_tpu_torch.runtime.serving import serve_throughput

    dt = engine.compute_dtype
    (cv, ip), _ = timed(
        "config5: CLIP-ViT-H/14 and the SDXL IP-Adapter made on the card and loaded",
        lambda: (load_clip_vision(synth_clip_vision_sd(fill=DeviceFill("cuda", seed=0)), dt, "cuda"),
                 load_ip_adapter(synth_ip_adapter_sd(fill=DeviceFill("cuda", seed=0)), dt, "cuda")))
    vm = cv["vision_model"]
    check(vm["embeddings"]["patch_embedding"]["weight"].shape == (1280, 3, 14, 14)
          and len(vm["encoder"]["layers"]) == 32 and len(ip["ip_adapter"]) == 70
          and cv["visual_projection"]["weight"].shape == (1024, 1280),
          "CLIP-ViT-H/14 (1280 × 32, projection 1024) and 70 IP layers")
    log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    reference = np.random.default_rng(5).integers(0, 256, size=(1024, 1024, 3), dtype=np.uint8)
    (tokens, uncond), _ = timed("config5: the 1024² reference image through ViT-H/14 and image_proj",
                                lambda: encode_image(ip, cv, reference))
    check(tuple(tokens.shape) == (1, 4, 2048) and bool(torch.isfinite(tokens).all())
          and bool(torch.isfinite(uncond).all()), "4 finite IP tokens of 2048")
    hooks = build_ip_adapter_hooks(ip, cv, reference, weight=CONFIG5_IP_WEIGHT,
                                   batch_size=CONFIG5_BATCH)

    def run_sequential(seeds, label, hooks=hooks):
        images = []
        for seed in seeds:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = process_images(engine, config5_request(seed, f"prompt {seed}", hooks))
            log(f"config5 {label} seed={seed}: latency {time.perf_counter() - t:.4f} s, timings "
                + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
                + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            images.append(res.images)
        return images

    run_sequential([1], "warm request")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    served = serve_throughput(engine, [config5_request(s, f"prompt {s}", hooks)
                                       for s in CONFIG5_SEEDS])
    served_launches = read_counts()
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts(served_launches, CONFIG5_PER_REQUEST, len(CONFIG5_SEEDS), "the served requests")
    for out in served["outputs"]:
        log("  served request timings " + json.dumps({k: round(v, 4) for k, v in
                                                     out["timings"].items()}))
    zero_counts()
    t = time.perf_counter()
    sequential = run_sequential(CONFIG5_SEEDS, "sequential")
    seq_wall = time.perf_counter() - t
    seq_launches = read_counts()
    check_counts(seq_launches, CONFIG5_PER_REQUEST, len(CONFIG5_SEEDS), "the sequential requests")
    for out, images in zip(served["outputs"], sequential):
        check(len(out["images"]) == len(images) == CONFIG5_BATCH, "2 images a request")
        for a, b in zip(out["images"], images):
            check(a.shape == (1024, 1024, 3) and a.dtype == np.uint8, "1024²×3 uint8 images")
            check(np.array_equal(a, b), "a served image is byte-identical to its sequential twin")
    check(not np.array_equal(sequential[0][0], sequential[1][0]), "config5 seeds 2 and 3 differ")
    n = served["n_images"]
    log(f"config5 serving: {n} images in {served['wall_s']:.4f} s, {served['images_per_s']:.4f} "
        f"images/s; sequential {n / seq_wall:.4f} images/s ({seq_wall:.4f} s); serve_speedup "
        f"{served['images_per_s'] * seq_wall / n:.4f}; peak {serve_peak:.2f} GiB; served images "
        "byte-identical to sequential")

    zero_hooks = build_ip_adapter_hooks(ip, cv, reference, weight=0.0, batch_size=CONFIG5_BATCH)
    (at_zero,), (no_hooks,) = (run_sequential(CONFIG5_SEEDS[:1], "IP weight 0", zero_hooks),
                               run_sequential(CONFIG5_SEEDS[:1], "no IP-Adapter", None))
    check(all(np.array_equal(a, b) for a, b in zip(at_zero, no_hooks)),
          "IP weight 0 gives the bytes of a request without hooks")
    check(not np.array_equal(at_zero[0], sequential[0][0]), "IP weight 0.6 changes the image")
    diff = np.abs(at_zero[0].astype(np.int16) - sequential[0][0].astype(np.int16))
    log(f"config5 IP-Adapter 0.6 vs 0: mean |Δ| {diff.mean():.3f} of 255; weight 0 equals no hooks")
    profile_request("config5 served 1024² ×2", lambda: process_images(
        engine, config5_request(CONFIG5_SEEDS[0], f"prompt {CONFIG5_SEEDS[0]}", hooks)))

    first = served["outputs"][0]["images"][0]
    zero_counts()
    upscaled = []
    for seed in UPSCALE_SEEDS:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = process_images(engine, upscale_request(first, seed))
        img = res.images[0]
        log(f"config5 upscale seed={seed}: latency {time.perf_counter() - t:.4f} s, timings "
            + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
            + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"image mean {img.mean():.3f} std {img.std():.3f}")
        check(img.shape == (2048, 2048, 3) and img.dtype == np.uint8, "2048²×3 uint8 image")
        upscaled.append(img)
    md_launches = read_counts()
    check_counts(md_launches, UPSCALE_PER_REQUEST, len(UPSCALE_SEEDS), "the upscales")
    check(np.array_equal(upscaled[1], upscaled[2]), "upscale seed 10 twice gives identical bytes")
    check(not np.array_equal(upscaled[0], upscaled[1]), "upscale seeds 9 and 10 differ")
    profile_request("config5 upscale 2048²", lambda: process_images(
        engine, upscale_request(first, UPSCALE_SEEDS[-1])))

    # kernels vs plain versions: the UNet with the IP hooks at the served CFG batch, a tile
    cond = engine.get_learned_conditioning(["prompt 2"] * 2 + [""] * 2, 1024, 1024)
    tile_cond = engine.get_learned_conditioning(["detailed", ""], 2048, 2048)
    for label, x, c, apply in (
            ("sdxl unet + IP hooks 128x128 B=4", (4, 4, 128, 128), cond,
             engine.unet_apply_fn(hooks=hooks)),
            ("sdxl unet, one 96x96 tile B=2", (2, 4, 96, 96), tile_cond, engine.unet_apply_fn())):
        xl = torch.randn(x, generator=gen, device="cuda").to(dt)
        ts = torch.tensor([999.0, 400.0] * (x[0] // 2), device="cuda")
        with torch.no_grad():
            fused, t1 = timed(f"{label}: kernels", lambda: apply(engine.loaded.unet, xl, ts,
                                                                  c["context"], y=c["y"]))
            with plain_versions():
                plain, t2 = timed(f"{label}: plain versions",
                                  lambda: apply(engine.loaded.unet, xl, ts, c["context"], y=c["y"]))
        value = psnr(fused, plain)
        log(f"{label} bf16: kernels vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(value >= PSNR_BOUND, f"{label} PSNR ≥ {PSNR_BOUND} dB")
        del xl, fused, plain
    del cv, ip, hooks, zero_hooks
    torch.cuda.empty_cache()
    return {name: served_launches[name] + seq_launches[name] + md_launches[name]
            for name in served_launches}


def config2_request(engine, seed: int, label: str, **fields):
    """BASELINE config 2's first pass (1024², DPM++ 2M Karras, 30 steps, CFG
    7) with `fields` (the hires fix, the refiner) → its image."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    refiner = fields.pop("refiner", None)
    p = Processing(prompt=CONFIG2_PROMPT, negative_prompt="blurry", seed=seed, steps=SDXL_STEPS,
                   cfg_scale=7.0, width=1024, height=1024, sampler_name="DPM++ 2M",
                   scheduler="karras", **fields)
    if refiner is not None:
        p._refiner_engine = refiner
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    side = 2048 if fields.get("enable_hr") else 1024
    check(img.shape == (side, side, 3) and img.dtype == np.uint8, f"{side}²×3 uint8 image")
    log(f"config2 {label} seed={seed}: latency {latency:.4f} s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img


def kernels_vs_plain(label: str, run):
    """run() through the kernels and through the plain versions → PSNR ≥ PSNR_BOUND."""
    from forge_tpu_torch.ops import plain_versions

    with torch.no_grad():
        fused, _ = timed(f"{label}: kernels", run)
        with plain_versions():
            plain, _ = timed(f"{label}: plain versions", run)
    value = psnr(fused, plain)
    log(f"{label} bf16: kernels vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
    check(value >= PSNR_BOUND, f"{label} PSNR ≥ {PSNR_BOUND} dB")


def phase_config2(engine, gen: torch.Generator):
    """BASELINE config 2 complete on the SDXL engine: (a) the hires fix in
    latent mode, (b) the SDXL refiner's two-pass switch, (c) the hires fix
    in pixel mode through a full-width ESRGAN."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill, synth_esrgan_sd, synth_sdxl_refiner_checkpoint
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry

    hires = dict(enable_hr=True, hr_scale=2.0, hr_upscaler="Latent",
                 hr_denoising_strength=CONFIG2_HR_STRENGTH, hr_second_pass_steps=0)
    zero_counts()
    images = [config2_request(engine, seed, "hires latent", **hires) for seed in (1, 2, 1)]
    latent_launches = read_counts()
    check(np.array_equal(images[0], images[2]), "config2 hires seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "config2 hires seeds 1 and 2 differ")
    check_counts(latent_launches, CONFIG2_LATENT_PER_REQUEST, 3, "the 3 hires requests")
    profile_request("config2 hires 2048²", lambda: config2_request(engine, 1, "hires, profiled",
                                                                    **hires))

    refiner, _ = timed("config2: the SDXL refiner made on the card and loaded", lambda: load_engine(
        synth_sdxl_refiner_checkpoint(fill=DeviceFill("cuda", seed=1)), device="cuda"))
    unet, tes = refiner.loaded.unet, refiner.loaded.text_encoders
    blocks = sum(k.endswith("attn1.to_q.weight") for k in flatten(unet))
    channels = unet["input_blocks"]["0"]["0"]["weight"].shape[0]
    ctx = unet["middle_block"]["1"]["transformer_blocks"]["0"]["attn2"]["to_k"]["weight"].shape[1]
    adm = unet["label_emb"]["0"]["0"]["weight"].shape[1]
    g = tes["clip_g"]["text_model"]
    g_width = g["embeddings"]["token_embedding"]["weight"].shape[1]
    log(f"  family {refiner.family}, {channels} channels, {blocks} transformer blocks, context "
        f"{ctx}, adm {adm}, CLIP-G {g_width} × {len(g['encoder']['layers'])}; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(refiner.family == "sdxl_refiner" and list(refiner.text_engines) == ["clip_g"]
          and (channels, blocks, ctx, adm, g_width, len(g["encoder"]["layers"]))
          == (384, 44, 1280, 2560, 1280, 32), "the SDXL refiner at full width")
    switch = dict(refiner_switch_at=CONFIG2_SWITCH_AT, refiner=refiner)
    zero_counts()
    refined = [config2_request(engine, 1, "refiner", **switch) for _ in range(2)]
    refiner_launches = read_counts()
    check(np.array_equal(refined[0], refined[1]), "config2 refiner seed 1 twice gives identical bytes")
    check_counts(refiner_launches, CONFIG2_REFINER_PER_REQUEST, 2, "the 2 refiner requests")
    profile_request("config2 refiner 1024²", lambda: config2_request(
        engine, 1, "refiner, profiled", **switch))

    esrgan_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs",
                              "chip_smoke_esrgan")
    os.makedirs(esrgan_dir, exist_ok=True)
    _, seconds = timed("config2: RealESRGAN_x4plus-width RRDBNet (23 RRDBs, 64 features, growth "
                       "32) written", lambda: save_safetensors(
                           synth_esrgan_sd(fill="random", seed=3),
                           os.path.join(esrgan_dir, "esrgan_x4_synth.safetensors")))
    engine.upscalers = UpscalerRegistry(model_dirs={"ESRGAN": esrgan_dir}, device="cuda")
    zero_counts()
    pixel = config2_request(engine, 1, "hires pixel (ESRGAN ×4, tiles 192/8)",
                               **dict(hires, hr_upscaler="esrgan_x4_synth"))
    pixel_launches = read_counts()
    engine.upscalers = None
    check_counts(pixel_launches, CONFIG2_PIXEL_PER_REQUEST, 1, "the pixel-mode request")
    check(not np.array_equal(pixel, images[0]), "the pixel mode's image is its own")

    # kernels vs plain versions: a hires UNet forward at 256², a refiner forward at 128²
    dt = engine.compute_dtype
    cond = engine.get_learned_conditioning([CONFIG2_PROMPT, "blurry"], 1024, 1024)
    rcond = refiner.get_learned_conditioning([CONFIG2_PROMPT, "blurry"], 1024, 1024)
    check(tuple(rcond["context"].shape) == (2, 77, 1280) and tuple(rcond["y"].shape) == (2, 2560),
          "the refiner's conditioning: context 1280, y 2560")
    ts = torch.tensor([999.0, 400.0], device="cuda")
    x = torch.randn((2, 4, 256, 256), generator=gen, device="cuda").to(dt)
    kernels_vs_plain("sdxl unet 256x256 B=2", lambda: engine.unet_apply_fn()(
        engine.loaded.unet, x, ts, cond["context"], y=cond["y"]))
    xr = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(dt)
    kernels_vs_plain("refiner unet 128x128 B=2", lambda: refiner.unet_apply_fn()(
        refiner.loaded.unet, xr, ts, rcond["context"], y=rcond["y"]))
    del refiner, x, xr
    torch.cuda.empty_cache()
    return {name: latent_launches[name] + refiner_launches[name] + pixel_launches[name]
            for name in latent_launches}


def samplers_request(engine, sampler: str, scheduler: str, seed: int, label: str):
    """One 1024² SDXL request with `sampler` → its image."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(prompt=CONFIG2_PROMPT, negative_prompt="blurry", seed=seed,
                   steps=SAMPLERS_STEPS, cfg_scale=7.0, width=1024, height=1024,
                   sampler_name=sampler, scheduler=scheduler)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8, "1024²×3 uint8 image")
    check(0 < img.std(), f"{sampler}: the image is not flat")
    log(f"samplers {sampler}{' ' + label if label else ''} seed={seed}: latency {latency:.4f} s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img


def phase_samplers(engine):
    """One sampler of each group on the SDXL engine (see the docstring's
    phase 11): seed 1 twice identical, seed 2 another, exact launch counts."""
    from forge_tpu_torch.pipeline.processing import get_sampler
    from forge_tpu_torch.sampling.brownian import brownian_step_noise
    from forge_tpu_torch.sampling.schedules import get_sigmas

    total = {}
    for sampler, (scheduler, calls) in SAMPLERS_PHASE.items():
        zero_counts()
        images = [samplers_request(engine, sampler, scheduler, seed, "")
                  for seed in (1, 1, 2)]
        launches = read_counts()
        check(np.array_equal(images[0], images[1]), f"{sampler} seed 1 twice gives identical bytes")
        check(not np.array_equal(images[0], images[2]), f"{sampler} seeds 1 and 2 differ")
        per_request = {"flash_attention": calls * 70 + 1, "gn_silu_conv3x3": calls * 34 + 28,
                       "dequant_matmul": 0}
        check_counts(launches, per_request, 3, f"the 3 {sampler} requests ({calls} model calls each)")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    info = get_sampler("DPM++ SDE")
    sigmas = get_sigmas("karras", SAMPLERS_STEPS, engine.predictor)
    t = time.perf_counter()
    brownian_step_noise(sigmas, (128, 128, 4), [1], draws=info.noise_draws)
    log(f"samplers: the Brownian noise of one DPM++ SDE request alone (host, {SAMPLERS_STEPS} "
        f"steps, {info.noise_draws} draws, 128×128×4): {time.perf_counter() - t:.4f} s")
    profile_request("samplers DPM++ SDE 1024²", lambda: samplers_request(
        engine, "DPM++ SDE", "karras", 1, "profiled"))
    return total


def image_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two uint8 images, in dB."""
    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def prompts_request(engine, label: str, seed: int = 1, prompt: str = PROMPTS_AND, **fields):
    """One 1024² DPM++ 2M Karras 20-step CFG-7 request with `fields` → (its
    image, its `Processed`); logs the latency, the phases, peak memory and
    the UNet's batch shapes with their calls."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(prompt=prompt, negative_prompt="blurry", seed=seed, steps=PROMPTS_STEPS,
                   cfg_scale=7.0, width=1024, height=1024, sampler_name="DPM++ 2M",
                   scheduler="karras", **fields)
    engine.unet_batches.clear()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8, "1024²×3 uint8 image")
    check(0 < img.std(), f"prompts {label}: the image is not flat")
    log(f"prompts {label} seed={seed}: latency {latency:.4f} s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, UNet batches "
        + ", ".join(f"{shape} × {n}" for shape, n in engine.unet_batches.items())
        + f", image mean {img.mean():.3f} std {img.std():.3f}")
    return img, res


def phase_prompts(engine, gen: torch.Generator):
    """The prompt surface on the SDXL engine (see the docstring's phase 12)."""
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.infotext import parse_generation_parameters
    from forge_tpu_torch.runtime import styles
    from forge_tpu_torch.runtime.options import opts

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "logs", "chip_smoke_prompts")
    emb_dir = os.path.join(work, "embeddings")
    os.makedirs(emb_dir, exist_ok=True)
    rng = np.random.default_rng(12)
    save_safetensors({"clip_l": (rng.standard_normal((2, 768)) * 0.02).astype(np.float32),
                      "clip_g": (rng.standard_normal((2, 1280)) * 0.02).astype(np.float32)},
                     os.path.join(emb_dir, "forgeemb.safetensors"))
    engine.embedding_db.load_dir(emb_dir)
    check(set(engine.embedding_db.embeddings) == {"forgeemb"}, "the dual embedding loads")
    for name, width in (("clip_l", 768), ("clip_g", 1280)):
        chunk = engine.text_engines[name].tokenize_batch([PROMPTS_EDIT])[0][0][0]
        check([v.shape for _, v in chunk.fixes] == [(2, width)],
              f"{name} splices the embedding's 2 × {width} vectors")
    csv_path = os.path.join(work, "styles.csv")
    with open(csv_path, "w", encoding="utf-8") as f:
        f.write("name,prompt,negative_prompt\n" + ",".join(f'"{v}"' for v in PROMPTS_STYLE) + "\n")
    saved_styles = styles.prompt_styles
    styles.prompt_styles = styles.StyleDatabase([csv_path])
    apply_fn = engine.unet_apply_fn
    engine.unet_batches = {}

    def recording_apply_fn(hooks=None, controlnets=None):
        fn = apply_fn(hooks=hooks, controlnets=controlnets)

        def apply(params, x, t, *args, **kwargs):
            shape = tuple(x.shape)
            engine.unet_batches[shape] = engine.unet_batches.get(shape, 0) + 1
            return fn(params, x, t, *args, **kwargs)

        return apply

    engine.unet_apply_fn = recording_apply_fn
    total = {}
    try:
        # (a) prompt editing, the embedding, a style and CFG rescale 0.7, twice: the cond cache
        encodes = []
        real_cond = engine.get_learned_conditioning
        engine.get_learned_conditioning = lambda *a, **k: encodes.append(a[0]) or real_cond(*a, **k)
        zero_counts()
        edit = dict(prompt=PROMPTS_EDIT, styles=[PROMPTS_STYLE[0]], cfg_rescale=0.7)
        first, res = prompts_request(engine, "(a) editing + TI + style + rescale", **edit)
        n_first = len(encodes)
        second, res2 = prompts_request(engine, "(a) again", **edit)
        launches = read_counts()
        del engine.get_learned_conditioning
        log(f"prompts (a): cond {res.timings['cond']:.4f} s, then {res2.timings['cond']:.4f} s "
            f"from the cache ({n_first} encodes, then {len(encodes) - n_first})")
        check(n_first == 3 and len(encodes) == n_first, "(a) three encodes, then a cache hit")
        check(np.array_equal(first, second), "(a) twice gives identical bytes")
        check(engine.unet_batches == {(2, 4, 128, 128): PROMPTS_STEPS}, "(a) 20 calls at batch 2")
        check_counts(launches, PROMPTS_PER_REQUEST, 2, "the 2 (a) requests")
        text = res.infotexts[0]
        log("prompts (a) infotext: " + json.dumps(text))
        d = parse_generation_parameters(text)
        styled = PROMPTS_STYLE[1].replace("{prompt}", PROMPTS_EDIT)
        check(d["Prompt"] == styled and d["Negative prompt"] == "blurry, " + PROMPTS_STYLE[2]
              and (d["Steps"], d["Sampler"], d["Schedule type"], d["CFG scale"], d["Seed"],
                   d["Size-1"], d["Size-2"]) == ("20", "DPM++ 2M", "Karras", "7.0", "1", "1024",
                                                 "1024") and text == res2.infotexts[0],
              "(a) the infotext parses back to the request")
        total = dict(launches)

        # (b) AND: seed 1 twice, seed 2; one request profiled; a batch-3 forward against plain
        zero_counts()
        images = [prompts_request(engine, "(b) AND", seed)[0] for seed in (1, 1, 2)]
        launches = read_counts()
        check(np.array_equal(images[0], images[1]), "(b) seed 1 twice gives identical bytes")
        check(not np.array_equal(images[0], images[2]), "(b) seeds 1 and 2 differ")
        check(engine.unet_batches == {(3, 4, 128, 128): PROMPTS_STEPS}, "(b) 20 calls at batch 3")
        check_counts(launches, PROMPTS_PER_REQUEST, 3, "the 3 (b) requests")
        total = {k: total[k] + launches[k] for k in total}
        profile_request("prompts (b) AND 1024²", lambda: prompts_request(engine, "(b) profiled"))
        with plain_versions():
            plain_img, _ = prompts_request(engine, "(b) plain versions")
        diff = np.abs(plain_img.astype(np.float64) - images[0].astype(np.float64))
        log(f"prompts (b) image, kernels vs plain versions after 20 steps: PSNR "
            f"{image_psnr(plain_img, images[0]):.2f} dB, "
            f"max |Δ| {diff.max():.0f} of 255, mean |Δ| {diff.mean():.4f} (not a gate: the "
            f"sampler carries each step's bf16 differences on; the forward below is held)")
        # the witness: the AND request and the plain prompt "a cat" at the same seeds, each
        # through the kernels and the plain versions. AND weighs the branches' differences
        # by cfg·1, cfg·0.8 and 1 − cfg·1.8 where a plain prompt weighs them by cfg and
        # 1 − cfg, so its images may read lower for the same kernels
        kern = {(PROMPTS_AND, 1): images[0], (PROMPTS_AND, 2): images[2]}
        plain = {(PROMPTS_AND, 1): plain_img}
        for prompt in (PROMPTS_AND, "a cat"):
            for seed in PROMPTS_WITNESS_SEEDS:
                if (prompt, seed) not in kern:
                    kern[prompt, seed] = prompts_request(engine, "(b) witness", seed, prompt)[0]
                if (prompt, seed) not in plain:
                    with plain_versions():
                        plain[prompt, seed] = prompts_request(
                            engine, "(b) witness plain versions", seed, prompt)[0]
        for seed in PROMPTS_WITNESS_SEEDS:
            db = [image_psnr(plain[q, seed], kern[q, seed]) for q in (PROMPTS_AND, "a cat")]
            log(f"prompts (b) witness seed={seed}: kernels vs plain versions, AND {db[0]:.2f} dB, "
                f"\"a cat\" {db[1]:.2f} dB, AND − plain prompt {db[0] - db[1]:+.2f} dB")
        cond = engine.get_learned_conditioning(["a cat", " a red hat", "blurry"], 1024, 1024)
        x = torch.randn((3, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
        ts = torch.full((3,), 700.0, device="cuda")
        kernels_vs_plain("sdxl unet AND batch 3 128x128", lambda: apply_fn()(
            engine.loaded.unet, x, ts, cond["context"], y=cond["y"]))
        del x

        # (c) two regions, the left and the right half
        zero_counts()
        prompts_request(engine, "(c) regional", prompt="a winter landscape",
                        regional_prompts=PROMPTS_REGIONS)
        launches = read_counts()
        check(engine.unet_batches == {(4, 4, 128, 128): PROMPTS_STEPS}, "(c) 20 calls at batch 4")
        check_counts(launches, PROMPTS_PER_REQUEST, 1, "the (c) request")
        total = {k: total[k] + launches[k] for k in total}

        # (d) NGMS: the uncond dropped below σ = PROMPTS_NGMS
        zero_counts()
        with opts.override({"s_min_uncond": PROMPTS_NGMS}):
            sigmas = proc.get_sigmas("karras", PROMPTS_STEPS, engine.predictor)
            k = proc._ngms_split(proc.Processing(cfg_scale=7.0),
                                 proc.Job(None, None, sigmas, None, {}, {}, None))
            log(f"prompts (d): s_min_uncond {PROMPTS_NGMS} splits the 20 Karras σ at step {k}")
            ngms = [prompts_request(engine, "(d) NGMS", prompt="a cat") for _ in range(2)]
        launches = read_counts()
        check(k is not None and engine.unet_batches == {(2, 4, 128, 128): k,
                                                        (1, 4, 128, 128): PROMPTS_STEPS - k},
              f"(d) {k} calls at batch 2, then {PROMPTS_STEPS - k} at batch 1")
        check(np.array_equal(ngms[0][0], ngms[1][0]), "(d) twice gives identical bytes")
        check(f"NGMS: {PROMPTS_NGMS}" in ngms[0][1].infotexts[0], "(d) the infotext records NGMS")
        check_counts(launches, PROMPTS_PER_REQUEST, 2, "the 2 (d) requests")
        total = {k: total[k] + launches[k] for k in total}
    finally:
        engine.unet_apply_fn = apply_fn
        styles.prompt_styles = saved_styles
    torch.cuda.empty_cache()
    return total


def family_request(engine, spec, seed: int, label: str, **fields):
    """One request of the family's model card with `fields` → its image; logs
    the latency, the phases and peak memory."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    size = spec["size"]
    p = Processing(prompt=FAMILY_PROMPT, negative_prompt="blurry", seed=seed,
                   steps=spec["steps"], cfg_scale=spec["cfg"], width=size, height=size,
                   sampler_name=spec["sampler"], scheduler=spec["scheduler"], **fields)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (size, size, 3) and img.dtype == np.uint8, f"{size}²×3 uint8 image")
    log(f"{spec['family']} request {label} seed={seed}: latency {latency:.4f} s, "
        f"{spec['steps'] / latency:.4f} steps/s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img


def check_family_engine(name: str, engine):
    """The engine's family, widths and objective are the published model's."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.sampling.prediction import PredictionEDM, PredictionFlow

    unet = engine.loaded.unet
    width = {n: t["text_model"]["embeddings"]["token_embedding"]["weight"].shape[1]
             for n, t in engine.loaded.text_encoders.items() if "text_model" in t}
    layers = {n: len(t["text_model"]["encoder"]["layers"])
              for n, t in engine.loaded.text_encoders.items() if "text_model" in t}
    if name == "sd3":
        blocks = len(unet["joint_blocks"])
        hidden = unet["x_embedder"]["proj"]["bias"].shape[0]
        t5 = engine.loaded.text_encoders["t5xxl"]["shared"]["weight"].shape
        log(f"  sd3: {blocks} joint blocks, hidden {hidden}, {engine.mmdit_cfg.num_heads} heads, "
            f"pos grid {engine.mmdit_cfg.pos_embed_max_size}², context {engine.loaded.context_dim}, "
            f"CLIP-L {width['clip_l']} × {layers['clip_l']}, CLIP-G {width['clip_g']} × "
            f"{layers['clip_g']}, T5 {tuple(t5)}, shift {engine.predictor.shift}")
        check((blocks, hidden, engine.mmdit_cfg.num_heads, engine.mmdit_cfg.pos_embed_max_size,
               engine.loaded.context_dim, width, layers, t5[1])
              == (24, 1536, 24, 192, 4096, {"clip_l": 768, "clip_g": 1280},
                  {"clip_l": 12, "clip_g": 32}, 4096)
              and isinstance(engine.predictor, PredictionFlow) and engine.predictor.shift == 3.0,
              "SD3-medium at full width")
        return
    blocks = sum(k.endswith("attn1.to_q.weight") for k in flatten(unet))
    ctx = unet["middle_block"]["1"]["transformer_blocks"]["0"]["attn2"]["to_k"]["weight"].shape[1]
    log(f"  {engine.family}: {blocks} transformer blocks, context {ctx}, text "
        + ", ".join(f"{n} {width[n]} × {layers[n]}" for n in width)
        + f", prediction {engine.loaded.prediction}, σ {engine.predictor.sigma_min:.4g}–"
        f"{engine.predictor.sigma_max:.4g}")
    if name == "sd2":
        check((blocks, ctx, width, layers, engine.loaded.prediction)
              == (16, 1024, {"clip_h": 1024}, {"clip_h": 24}, "v"), "SD2.1-768-v at full width")
    else:
        check((blocks, ctx, width, layers) == (70, 2048, {"clip_l": 768, "clip_g": 1280},
                                               {"clip_l": 12, "clip_g": 32})
              and isinstance(engine.predictor, PredictionEDM)
              and (engine.predictor.sigma_min, engine.predictor.sigma_max,
                   engine.predictor.sigma_data) == (0.002, 120.0, 0.5),
              "Playground v2.5 at full width, EDM")


def phase_family(name: str, gen: torch.Generator):
    """One diffusion family at its published widths (see the docstring's
    phase 13): a warm request, seeds 1, 2, 1 with exact launch counts, one
    profiled request, seed 1's request through the plain versions, and the
    network's forward and the VAE decode through the kernels and the plain
    versions."""
    from forge_tpu_torch.core import synth
    from forge_tpu_torch.core.synth import DeviceFill
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline.engine import load_engine

    spec = FAMILIES[name]
    engine, _ = timed(f"{name}: weights made on the card and loaded", lambda: load_engine(
        getattr(synth, spec["synth"])(fill=DeviceFill("cuda", seed=0)), device="cuda"))
    log(f"  {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(engine.family == spec["family"] and engine.compute_dtype == torch.bfloat16,
          f"{name} engine, bf16")
    check_family_engine(name, engine)
    family_request(engine, spec, 0, "warm")
    zero_counts()
    images = [family_request(engine, spec, seed, "") for seed in (1, 2, 1)]
    launches = read_counts()
    check(np.array_equal(images[0], images[2]), f"{name} seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), f"{name} seeds 1 and 2 differ")
    per_request = {"flash_attention": spec["calls"] * spec["flash"] + 1,
                   "gn_silu_conv3x3": spec["calls"] * spec["conv"] + 28, "dequant_matmul": 0}
    check_counts(launches, per_request, 3, f"the 3 {name} requests")
    profile_request(f"{name} {spec['size']}²", lambda: family_request(engine, spec, 1, "profiled"))
    with plain_versions():
        plain_img = family_request(engine, spec, 1, "plain versions")
    value = image_psnr(plain_img, images[0])
    diff = np.abs(plain_img.astype(np.float64) - images[0].astype(np.float64))
    log(f"{name} image, kernels vs plain versions after {spec['steps']} steps: PSNR {value:.2f} dB, "
        f"max |Δ| {diff.max():.0f} of 255, mean |Δ| {diff.mean():.4f}"
        + (f" (bound {PSNR_BOUND})" if spec["request_gate"] else
           " (not a gate: the forward below is held)"))
    if spec["request_gate"]:
        check(value >= PSNR_BOUND, f"{name} whole request kernels vs plain PSNR ≥ {PSNR_BOUND} dB")
    else:  # the witness: the plain versions against themselves from a perturbed start
        with plain_versions():
            moved = family_request(engine, spec, 1, "plain versions, witness",
                                   **FAMILY_WITNESS_SUBSEED)
        log(f"{name} witness: plain versions, seed 1 against seed 1 with subseed "
            f"{FAMILY_WITNESS_SUBSEED['subseed']} at strength "
            f"{FAMILY_WITNESS_SUBSEED['subseed_strength']}: PSNR {image_psnr(plain_img, moved):.2f} "
            f"dB (kernels vs plain {value:.2f} dB)")

    size, dt = spec["size"], engine.compute_dtype
    channels = engine.latent_format.latent_channels
    cond = engine.get_learned_conditioning([FAMILY_PROMPT, "blurry"], size, size)
    ts = torch.tensor([float(engine.predictor.timestep(np.float32(s)))
                       for s in (engine.predictor.sigma_max * 0.9, 1.0)], device="cuda")
    x = torch.randn((2, channels, size // 8, size // 8), generator=gen, device="cuda").to(dt)
    net = engine.unet_apply_fn()
    kernels_vs_plain(f"{name} {'mmdit' if name == 'sd3' else 'unet'} {size // 8}² B=2",
                     lambda: net(engine.loaded.unet, x, ts, **cond))
    z = torch.randn((1, channels, size // 8, size // 8), generator=gen, device="cuda")
    kernels_vs_plain(f"{name} vae decode {size}²", lambda: engine.decode_first_stage(z))
    del engine, x, z
    torch.cuda.empty_cache()
    return launches


def write_flux_files(directory: str):
    """Flux-dev from phase 5's `DeviceFill(seed=0)` weights as a Forge user
    downloads it: the transformer alone in the bitsandbytes layout (every
    weight `unet_quant="nf4"` quantizes as NF4 at block 64 with f32 absmax,
    the rest bf16), the VAE in bf16, and CLIP-L and T5-XXL in bf16 under
    `text_encoders.*` → the three paths."""
    from forge_tpu_torch.core.loader import _quantizes
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill, bnb_serialize, synth_flux_checkpoint

    os.makedirs(directory, exist_ok=True)
    sd = synth_flux_checkpoint(fill=DeviceFill("cuda", seed=0))
    prefix = "model.diffusion_model."
    unet, vae, tes = {}, {}, {}
    t = time.perf_counter()
    for key, value in sd.items():
        if key.startswith(prefix):
            key = key[len(prefix):]
            if _quantizes(key, value.shape):
                unet.update(bnb_serialize(key, value))  # on the card, 0.56 B a weight
            else:
                unet[key] = value.to(torch.bfloat16)
        else:
            (vae if key.startswith("first_stage_model.") else tes)[key] = value.to(torch.bfloat16)
    torch.cuda.synchronize()
    log(f"flux files: NF4 codes made on the card in {time.perf_counter() - t:.2f} s")
    paths = {}
    for name, part in (("flux1-dev-bnb-nf4.safetensors", unet), ("ae.safetensors", vae),
                       ("text_encoders.safetensors", tes)):
        path = os.path.join(directory, name)
        t = time.perf_counter()
        save_safetensors(part, path)
        log(f"  wrote {name}: {os.path.getsize(path) / 2**30:.3f} GiB in "
            f"{time.perf_counter() - t:.2f} s")
        paths[name] = path
        part.clear()
    return [paths[n] for n in ("flux1-dev-bnb-nf4.safetensors", "ae.safetensors",
                               "text_encoders.safetensors")]


def phase_flux_bnb(nf4_seed1):
    """Phase 15 (a): the files of `write_flux_files` loaded through
    `load_engine(path, additional_modules=…)` and driven as phase 5; seed 1's
    image byte-identical to phase 5's `unet_quant="nf4"` image."""
    import shutil

    from forge_tpu_torch.pipeline.engine import load_engine

    shutil.rmtree(FLUX_FILES_DIR, ignore_errors=True)
    try:
        (unet_path, vae_path, te_path), _ = timed("flux bnb: files written",
                                                  lambda: write_flux_files(FLUX_FILES_DIR))
        torch.cuda.empty_cache()
        engine, seconds = timed("flux bnb: load_engine(bnb file, additional_modules=VAE, text "
                                "encoders)", lambda: load_engine(
                                    unet_path, device="cuda",
                                    additional_modules={"vae": vae_path, "text_encoders": te_path}))
    finally:
        shutil.rmtree(FLUX_FILES_DIR, ignore_errors=True)
    n_quant = quant_leaves(engine.loaded.unet)
    log(f"  {n_quant} NF4 leaves, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
        f"unet subtrees {sorted(engine.loaded.unet)}")
    check(engine.family == "flux" and n_quant == 314, "the bnb file's 314 NF4 leaves")
    check(not {"first_stage_model", "text_encoders"} & set(engine.loaded.unet),
          "the bnb file's UNet holds no VAE or text-encoder subtree")
    check(set(engine.loaded.text_encoders) == {"clip_l", "t5xxl"}, "CLIP-L and T5 from their file")
    zero_counts()
    runs = [flux_request(engine, seed, "bnb nf4 file") for seed in (1, 2, 1)]
    launches = read_counts()
    check_flux_counts(launches, n_quant, 3, "the 3 bnb-file requests")
    images = [img for img, _ in runs]
    check(np.array_equal(images[0], images[2]), "bnb file seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "bnb file seeds 1 and 2 differ")
    log(f"flux bnb file seed 1 vs unet_quant=\"nf4\" seed 1: max |Δ| "
        f"{np.abs(images[0].astype(np.int16) - nf4_seed1[0].astype(np.int16)).max()}; latency "
        f"{runs[2][1]:.4f} s against {nf4_seed1[1]:.4f} s")
    check(np.array_equal(images[0], nf4_seed1[0]),
          "the bnb file's seed-1 image is byte-identical to unet_quant=\"nf4\"'s")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_flux_fp8(nf4_seed1):
    """Phase 15 (b): `unet_quant="fp8_e4m3"`: the big weights float8_e4m3fn,
    one request with exact launches, one profiled, one whole forward against
    plain."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.synth import DeviceFill, synth_flux_checkpoint
    from forge_tpu_torch.pipeline.engine import load_engine

    engine, _ = timed("flux fp8: Flux-dev made on the card, load_engine(unet_quant=\"fp8_e4m3\")",
                      lambda: load_engine(synth_flux_checkpoint(fill=DeviceFill("cuda", seed=0)),
                                          device="cuda", unet_quant="fp8_e4m3"))
    leaves = flatten(engine.loaded.unet)
    fp8 = {k: v for k, v in leaves.items() if v.dtype == torch.float8_e4m3fn}
    fp8_bytes = sum(v.numel() for v in fp8.values())
    allocated = torch.cuda.memory_allocated()
    log(f"  {len(fp8)} float8_e4m3fn weights ({fp8_bytes / 1e9:.3f} GB), the rest "
        f"{sorted({str(v.dtype)[6:] for k, v in leaves.items() if k not in fp8})}; "
        f"{allocated / 2**30:.2f} GiB allocated, the bf16 tree's "
        f"{(allocated + fp8_bytes) / 2**30:.2f} GiB ({fp8_bytes / 1e9:.2f} GB below)")
    check(len(fp8) == 314 and all(v.dim() == 2 for v in fp8.values()),
          "the 314 big Flux-dev weights stored float8_e4m3fn")
    check(fp8_bytes > 11.5e9, "fp8 storage about 12 GB below the bf16 tree")
    check(all(v.dtype == torch.bfloat16 for k, v in leaves.items() if k not in fp8),
          "the rest in bf16")
    zero_counts()
    img, latency = flux_request(engine, 1, "fp8_e4m3")
    launches = read_counts()
    check_counts(launches, FP8_PER_REQUEST, 1, "the fp8 request")
    check(float(img.std()) > 0, "fp8 image is not constant")
    log(f"flux fp8_e4m3 request latency {latency:.4f} s, NF4 {nf4_seed1[1]:.4f} s")
    profile_request("flux fp8_e4m3 1024²", lambda: flux_request(engine, 1, "fp8_e4m3, profiled"))
    phase_flux_blocks(engine, parts=("whole forward",))
    del engine
    torch.cuda.empty_cache()
    return launches


def chroma_request(engine, seed: int, label: str, size: int = 1024):
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(prompt=FLUX_PROMPT, negative_prompt=CHROMA_NEGATIVE, seed=seed,
                   steps=CHROMA_STEPS, cfg_scale=CHROMA_CFG, width=size, height=size,
                   sampler_name="Euler", scheduler="simple")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    img = res.images[0]
    check(img.shape == (size, size, 3) and img.dtype == np.uint8, f"{size}²×3 uint8 image")
    log(f"chroma request {label} seed={seed}: latency {latency:.4f} s, "
        f"{CHROMA_STEPS / latency:.4f} steps/s, timings "
        + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
        + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"image mean {img.mean():.3f} std {img.std():.3f}")
    return img


def phase_chroma(gen: torch.Generator):
    """Phase 15 (c): Chroma at full width in bf16: a warm request, seeds 1, 2,
    1 with exact launches, one profiled, one batch-2 forward against plain."""
    from forge_tpu_torch.core.synth import DeviceFill, synth_chroma_checkpoint
    from forge_tpu_torch.pipeline.engine import load_engine

    engine, _ = timed("chroma: weights made on the card and loaded", lambda: load_engine(
        synth_chroma_checkpoint(fill=DeviceFill("cuda", seed=0)), device="cuda"))
    unet = engine.loaded.unet
    approx = unet["distilled_guidance_layer"]
    t5 = engine.loaded.text_encoders["t5xxl"]
    widths = (engine.family, unet["img_in"]["weight"].shape[0], engine.flux_cfg.num_heads,
              len(unet["double_blocks"]), len(unet["single_blocks"]),
              tuple(approx["in_proj"]["weight"].shape), len(approx["layers"]),
              tuple(t5["shared"]["weight"].shape), len(t5["encoder"]["block"]),
              sorted(engine.text_engines), engine.latent_format.latent_channels,
              engine.flux_cfg.guidance_embed, engine.compute_dtype)
    log(f"  chroma: {widths}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    check(widths == ("chroma", 3072, 24, 19, 38, (5120, 64), 5, (32128, 4096), 24, ["t5xxl"], 16,
                     False, torch.bfloat16), "Chroma at full width, bf16")
    chroma_request(engine, 0, "warm")
    zero_counts()
    images = [chroma_request(engine, seed, "") for seed in (1, 2, 1)]
    launches = read_counts()
    check(np.array_equal(images[0], images[2]), "Chroma seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "Chroma seeds 1 and 2 differ")
    check_counts(launches, CHROMA_PER_REQUEST, 3, "the 3 Chroma requests")
    profile_request("chroma 1024²", lambda: chroma_request(engine, 1, "profiled"))
    cond = engine.get_learned_conditioning([FLUX_PROMPT, CHROMA_NEGATIVE], 1024, 1024)
    x = torch.randn((2, 16, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
    t = torch.tensor([1000.0 * 0.9, 1000.0 * 0.4], device="cuda")
    net = engine.unet_apply_fn()
    kernels_vs_plain("chroma forward 128² B=2", lambda: net(unet, x, t, **cond))
    del engine, x
    torch.cuda.empty_cache()
    return launches


def phase_flux_family(gen: torch.Generator, nf4_seed1=None):
    """Phase 15: (a) the bnb NF4 files, (b) fp8-e4m3 storage, (c) Chroma. Without
    phase 5's seed-1 NF4 image (`--flux-family`), one NF4 request makes it."""
    if nf4_seed1 is None:
        engine, _ = load_flux("nf4")
        flux_request(engine, 2, "nf4, warm")
        nf4_seed1 = flux_request(engine, 1, "nf4, for the bnb file's comparison")
        del engine
        torch.cuda.empty_cache()
    paths = {}
    for name, run in (("flux_bnb", lambda: phase_flux_bnb(nf4_seed1)),
                      ("flux_fp8", lambda: phase_flux_fp8(nf4_seed1)),
                      ("chroma", lambda: phase_chroma(gen))):
        t = time.perf_counter()
        paths[name] = run()
        log(f"{name} phase: {time.perf_counter() - t:.2f} s")
    return paths



def http(base: str, path: str, body=None):
    """GET (or POST `body` as JSON) → the answer's JSON; a status other than 200 raises."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def add_counts(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def paeth_average_png(image: np.ndarray) -> bytes:
    """uint8 [H,W,3] → an RGB PNG whose rows are filtered Average and Paeth in
    turn, the filters Pillow's adaptive choice gives a photograph's rows
    (the port's writer filters none), built by the PNG specification's
    section 9.2."""
    import struct
    import zlib

    h, w, bpp = image.shape
    x = image.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = 3 + np.arange(h) % 2
    pred = np.where(kinds[:, None] == 4, paeth, (a + b) >> 1)
    rows = np.concatenate([kinds[:, None], (x - pred) & 255], 1).astype(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def api_txt2img(base: str, label: str, seed: int, **fields):
    """One txt2img over HTTP → (answer, decoded pixels, PNG text, wall seconds)."""
    import base64

    from forge_tpu_torch.pipeline.images import decode_png

    t = time.perf_counter()
    answer = http(base, "/sdapi/v1/txt2img", dict(API_REQUEST, seed=seed, **fields))
    wall = time.perf_counter() - t
    pixels, text = decode_png(base64.b64decode(answer["images"][0]))
    check(pixels.shape == (1024, 1024, 3), f"API {label}: a 1024²×3 PNG")
    log(f"api {label} seed={seed}: wall {wall:.4f} s, image mean {pixels.mean():.3f} "
        f"std {pixels.std():.3f}")
    return answer, pixels, text, wall


def phase_api(engine, gen: torch.Generator):
    """The REST API on the SDXL engine (see the docstring's phase 14)."""
    import base64
    import threading

    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.core.synth import DeviceFill, synth_taesd_sd
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline.images import decode_png, encode_png
    from forge_tpu_torch.pipeline.processing import Processing, process_images
    from forge_tpu_torch.pipeline.taesd import register_taesd, taesd_decode, taesd_for_family
    from forge_tpu_torch.runtime.models import ModelManager
    from forge_tpu_torch.runtime.queue import work_queue

    total = {}
    manager = ModelManager(checkpoint_dirs=["logs/chip_smoke_api"], device="cuda")
    manager.set_engine(engine)
    server = create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        samplers = http(base, "/sdapi/v1/samplers")
        options = http(base, "/sdapi/v1/options")
        models = http(base, "/sdapi/v1/sd-models")
        memory = http(base, "/sdapi/v1/memory")
        free, total_bytes = torch.cuda.mem_get_info()
        log(f"api: {base}, {len(samplers)} samplers, {len(options)} options, {len(models)} "
            f"checkpoints listed; /memory cuda free {memory['cuda']['free'] / 2**30:.2f} GiB of "
            f"{memory['cuda']['total'] / 2**30:.2f} (mem_get_info {free / 2**30:.2f} of "
            f"{total_bytes / 2**30:.2f}), ram free {memory['ram']['free'] / 2**30:.2f} GiB")
        check(len(samplers) == 25 and options["live_previews_enable"] is True
              and abs(memory["cuda"]["free"] - free) <= 2**30
              and memory["cuda"]["total"] == total_bytes, "the listing routes")

        # txt2img: seeds 1, 2 (polled), 1, then 1 with the live previews off
        zero_counts()
        first, pixels, text, on_wall = api_txt2img(base, "previews on", 1)
        polls, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                polls.append(http(base, "/sdapi/v1/progress"))
                time.sleep(0.1)

        poller = threading.Thread(target=poll)
        poller.start()
        try:
            api_txt2img(base, "previews on, /progress polled every 0.1 s", 2)
        finally:
            stop.set()
            poller.join()
        after = http(base, "/sdapi/v1/progress")
        # seed 1 in turns, the live previews on, off, off, on: their cost is the difference
        previews_off = {"override_settings": {"live_previews_enable": False}}
        turns = [api_txt2img(base, f"previews {'off' if off else 'on'}", 1,
                             **(previews_off if off else {})) for off in (False, True, True, False)]
        launches = read_counts()
        add_counts(total, launches)
        check_counts(launches, SDXL_PER_REQUEST, 6, "the 6 API txt2img requests")
        check(all(turn[0]["images"] == first["images"] for turn in turns),
              "seed 1's responses identical, previews on and off")
        running = [(q["state"]["sampling_step"], q["progress"]) for q in polls if q["state"]["job"]]
        previews = [q["current_image"] for q in polls if q["state"]["job"] and q["current_image"]]
        check(len(running) >= 5 and all(b >= a for a, b in zip(running, running[1:])),
              "progress never falls while the request runs")
        check(after["state"]["sampling_step"] == SDXL_STEPS and after["progress"] == 1.0,
              f"progress reaches {SDXL_STEPS} of {SDXL_STEPS}")
        check(bool(previews), "a live preview while the request runs")
        preview, _ = decode_png(base64.b64decode(previews[-1]))
        check(preview.shape == (128, 128, 3), "the preview decodes (128²×3, Approx cheap)")
        log(f"api progress: {len(polls)} polls, {len(running)} while running, steps "
            f"{running[0][0]}…{running[-1][0]}, then {after['state']['sampling_step']} of "
            f"{after['state']['sampling_steps']}; {len(previews)} previews seen, last {preview.shape}")
        on_s, off_s = [turns[0][3], turns[3][3]], [turns[1][3], turns[2][3]]
        log(f"api live previews (Approx cheap, every 10 steps, a host sync each), seed 1 in turns: "
            f"on {on_s[0]:.4f} s, off {off_s[0]:.4f} s, off {off_s[1]:.4f} s, on {on_s[1]:.4f} s: "
            f"on − off {(sum(on_s) - sum(off_s)) / 2:+.4f} s a request (the first request, "
            f"{on_wall:.4f} s, is not in the turns)")

        torch.cuda.synchronize()
        t = time.perf_counter()
        res = process_images(engine, Processing(**API_REQUEST, seed=1))
        pi_wall = time.perf_counter() - t
        check(np.array_equal(res.images[0], pixels), "the API's PNG pixels = process_images' image")
        check(text == {"parameters": res.infotexts[0]}, "the PNG's parameters = the infotext")
        t = time.perf_counter()
        for _ in range(3):
            png = encode_png(res.images[0], {"parameters": res.infotexts[0]})
        png_ms = (time.perf_counter() - t) / 3 * 1e3
        t = time.perf_counter()
        b64 = base64.b64encode(png)
        b64_ms = (time.perf_counter() - t) * 1e3
        log(f"api vs library, seed 1: API wall {min(on_s):.4f} s (previews on), {min(off_s):.4f} s "
            f"(off); process_images {pi_wall:.4f} s (timings "
            + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
            + f"); PNG encode {png_ms:.2f} ms ({len(png) / 2**20:.2f} MiB), base64 {b64_ms:.2f} ms "
            f"({len(b64) / 2**20:.2f} MiB)")
        # a client's upload: the same pixels, rows filtered Average and Paeth
        upload = paeth_average_png(res.images[0])
        decode_ms = {}
        for name, data in (("filter None (the port's writer)", png), ("Average/Paeth", upload)):
            t = time.perf_counter()
            for _ in range(3):
                back, _ = decode_png(data)
            decode_ms[name] = (time.perf_counter() - t) / 3 * 1e3
            check(np.array_equal(back, res.images[0]), f"the 1024² {name} PNG decodes")
        log("api PNG decode of a 1024² RGB upload (host): " + ", ".join(
            f"{name} {ms:.2f} ms" for name, ms in decode_ms.items())
            + f" ({len(upload) / 2**20:.2f} MiB Average/Paeth)")

        # interrupt once /progress shows step ≥ API_INTERRUPT_AT
        zero_counts()
        answer = {}
        runner = threading.Thread(target=lambda: answer.update(
            http(base, "/sdapi/v1/txt2img", dict(API_REQUEST, seed=4))))
        runner.start()
        deadline, seen = time.perf_counter() + 120, None
        while time.perf_counter() < deadline and runner.is_alive():
            q = http(base, "/sdapi/v1/progress?skip_current_image=true")
            if q["state"]["job"] and q["state"]["sampling_step"] >= API_INTERRUPT_AT:
                seen = q["state"]["sampling_step"]
                http(base, "/sdapi/v1/interrupt", {})
                break
            time.sleep(0.02)
        runner.join()
        launches = read_counts()
        add_counts(total, launches)
        steps = http(base, "/sdapi/v1/progress?skip_current_image=true")["state"]
        k = steps["sampling_step"]
        check(seen is not None and steps["interrupted"] and API_INTERRUPT_AT <= k < SDXL_STEPS,
              f"the interrupt landed between step {API_INTERRUPT_AT} and {SDXL_STEPS}")
        pixels_int, _ = decode_png(base64.b64decode(answer["images"][0]))
        check(pixels_int.shape == (1024, 1024, 3), "the interrupted response carries an image")
        log(f"api interrupt: posted at step {seen}, the loop stopped after {k} of {SDXL_STEPS}")
        check_counts(launches, {"flash_attention": k * 70 + 1, "gn_silu_conv3x3": k * 34 + 28,
                                "dequant_matmul": 0}, 1,
                     f"the interrupted request ({k} steps, one whole decode)")

        # the tiled VAE: txt2img, then img2img from the first image (as the client's
        # Average/Paeth upload), under vae_always_tiled
        tiled_opts = {"override_settings": {"vae_always_tiled": True}}
        zero_counts()
        _, tiled_px, _, tiled_wall = api_txt2img(base, "vae_always_tiled", 1, **tiled_opts)
        launches = read_counts()
        add_counts(total, launches)
        check_counts(launches, API_TILED_PER_REQUEST, 1, "the tiled-VAE txt2img (9 decode tiles)")
        log(f"api tiled vs whole decode, seed 1: PSNR {image_psnr(tiled_px, pixels):.2f} dB "
            "(seams; printed, not a gate)")
        zero_counts()
        t = time.perf_counter()
        i2i = http(base, "/sdapi/v1/img2img", dict(
            API_REQUEST, seed=1, init_images=[base64.b64encode(upload).decode()],
            denoising_strength=API_IMG2IMG_STRENGTH, **tiled_opts))
        i2i_wall = time.perf_counter() - t
        launches = read_counts()
        add_counts(total, launches)
        i2i_px, _ = decode_png(base64.b64decode(i2i["images"][0]))
        check(i2i_px.shape == (1024, 1024, 3), "the tiled img2img's 1024² image")
        log(f"api img2img, strength {API_IMG2IMG_STRENGTH}, vae_always_tiled: wall {i2i_wall:.4f} s")
        check_counts(launches, API_IMG2IMG_PER_REQUEST, 1,
                     f"the tiled img2img ({API_IMG2IMG_CALLS} calls, 9 encode and 9 decode tiles)")

        # the 2048² decode, whole and tiled, each from a fresh peak
        lat = torch.randn((1, 4, 256, 256), generator=torch.Generator("cuda").manual_seed(1),
                          device="cuda")
        runs = {}
        for name, fn in (("whole", engine.decode_first_stage),
                         ("tiled", engine.decode_first_stage_tiled)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t = time.perf_counter()
            out = fn(lat)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated()
            launches = read_counts()
            t = time.perf_counter()
            fn(lat)
            torch.cuda.synchronize()
            runs[name] = (out, peak, peak - before, first_s, time.perf_counter() - t, launches)
            log(f"api 2048² decode {name}: peak {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} "
                f"over the {before / 2**30:.2f} GiB held), {first_s:.4f} s, again "
                f"{runs[name][4]:.4f} s; {launches['flash_attention']} flash, "
                f"{launches['gn_silu_conv3x3']} conv launches")
        add_counts(total, runs["tiled"][5])
        check_counts(runs["tiled"][5], {"flash_attention": API_TILES_2048,
                                        "gn_silu_conv3x3": API_TILES_2048 * 28,
                                        "dequant_matmul": 0}, 1, "the 2048² tiled decode (25 tiles)")
        check(runs["tiled"][1] < runs["whole"][1], "the tiled 2048² decode peaks lower")
        with plain_versions():
            plain = engine.decode_first_stage_tiled(lat)
        value = psnr(runs["tiled"][0], plain)
        log(f"api 2048² tiled decode, kernels vs plain: PSNR {value:.2f} dB (bound {PSNR_BOUND}); "
            f"tiled vs whole {psnr(runs['tiled'][0], runs['whole'][0]):.2f} dB (printed)")
        check(value >= PSNR_BOUND, f"the tiled 2048² decode ≥ {PSNR_BOUND} dB against plain")
        del runs, plain, lat

        # TAESD: synthetic taesdxl weights made on the card
        register_taesd("taesdxl", "decoder", synth_taesd_sd(fill=DeviceFill("cuda", seed=14)))
        zero_counts()
        _, taesd_px, _, taesd_wall = api_txt2img(
            base, "sd_vae_decode_method TAESD", 1,
            override_settings={"sd_vae_decode_method": "TAESD"})
        launches = read_counts()
        add_counts(total, launches)
        check_counts(launches, API_TAESD_PER_REQUEST, 1, "the TAESD request (no VAE kernel)")
        params = taesd_for_family("sdxl", device="cuda")
        z = torch.randn((1, 4, 128, 128), generator=gen, device="cuda")
        with torch.no_grad():
            taesd_ms = time_ms(lambda: taesd_decode(params, engine.latent_format.process_out(z)))
            full_ms = time_ms(lambda: engine.decode_first_stage(z))
        log(f"api TAESD: request wall {taesd_wall:.4f} s; a 1024² decode TAESD (f32, cuDNN) "
            f"{taesd_ms:.4f} ms, the full VAE (bf16, the kernels) {full_ms:.4f} ms")
    finally:
        server.shutdown()
        server.server_close()
        work_queue.stop()
        manager.close()  # its resolver would keep the SDXL engine alive past `del engine`
    return total



def ext_processing(seed: int = 1, attach=None, **fields):
    """A phase-16 request (EXT_SIZE², DPM++ 2M Karras, EXT_STEPS steps, CFG 7
    unless `fields` say otherwise) with `attach(p)` run on it."""
    from forge_tpu_torch.pipeline.processing import Processing

    p = Processing(**{**dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=seed,
                             steps=EXT_STEPS, cfg_scale=7.0, width=EXT_SIZE, height=EXT_SIZE,
                             sampler_name="DPM++ 2M", scheduler="karras"), **fields})
    if attach is not None:
        attach(p)
    return p


def ext_request(engine, label: str, seed: int = 1, attach=None, witness=None, **fields):
    """One phase-16 request, its launches exact by body → (its first image,
    the Processed, the latency, the launches, the sampler's latent at its
    call EXT_STEPS // 2, recorded by a post-CFG hook that returns x0 as it
    is and launches nothing)."""
    from forge_tpu_torch.pipeline.processing import process_images

    p = ext_processing(seed, attach, **fields)
    calls = []

    def record(x0, eps_cond, eps_uncond, x, sigma):
        calls.append(x.clone() if len(calls) == EXT_STEPS // 2 else None)
        return x0

    p.post_cfg_hooks = list(p.post_cfg_hooks or ()) + [record]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    launches = read_counts()
    for img in res.images:
        check(img.shape == (EXT_SIZE, EXT_SIZE, 3) and img.dtype == np.uint8 and img.std() > 0,
              f"extensions {label}: a {EXT_SIZE}²×3 uint8 image, not flat")
    img = res.images[0]
    line = (f"extensions {label} seed={seed} batch={p.batch_size}: latency {latency:.4f} s, "
            "timings " + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
            + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, image mean "
            f"{img.mean():.3f} std {img.std():.3f}")
    if witness is not None:
        w_img, w_res, w_latency = witness[:3]
        check(not np.array_equal(img, w_img), f"extensions {label}: the image differs from the "
                                              "witness's")
        line += (f" | witness latency {w_latency:.4f} s, timings "
                 + json.dumps({k: round(v, 4) for k, v in w_res.timings.items()})
                 + f", {latency / w_latency:.3f}x, PSNR vs the witness "
                 f"{image_psnr(img, w_img):.2f} dB")
    log(line)
    check_counts(launches, EXT_PER_REQUEST[label], 1, f"the {label} request")
    return img, res, latency, launches, calls[EXT_STEPS // 2]


def sag_vs_plain(what: str, p, fn, x, sigma: float):
    """SAG's model_fn through the kernels and the plain versions. Its mask
    thresholds the middle block's attention at its mean, so a token near the
    threshold flips on a bf16 difference upstream and moves x0 there by the
    blur: the plain run is held with the kernels' recorded q and k (the same
    mask) against the ≥ PSNR_BOUND gate, and the run with its own mask and
    the tokens that flipped are printed beside it."""
    from forge_tpu_torch.extensions.sag import attention_mask
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.ops.attention import attention

    replace = p.unet_hooks["attn1_replace"]
    record = replace[("middle", 0)]
    seen, mode = {}, {"plain": False, "frozen": False}

    def recorder(q, k, v, extra):
        seen["plain" if mode["plain"] else "kernels"] = (q, k, extra["n_heads"])
        if mode["frozen"]:  # SAG records the kernels' q and k; the attention is the plain run's
            record(*seen["kernels"][:2], v, extra)
            return attention(q, k, v, heads=extra["n_heads"])
        return record(q, k, v, extra)

    replace[("middle", 0)] = recorder
    with torch.no_grad():
        fused, _ = timed(f"{what}: kernels", lambda: fn(x, sigma))
        mode["plain"] = True
        with plain_versions():
            own, _ = timed(f"{what}: plain versions, their own mask", lambda: fn(x, sigma))
            mode["frozen"] = True
            plain, _ = timed(f"{what}: plain versions, the kernels' mask", lambda: fn(x, sigma))
    masks = [attention_mask(*seen[run], x.shape[0], tuple(x.shape[2:])) for run in
             ("kernels", "plain")]
    side = int(math.sqrt(seen["kernels"][0].shape[1]))
    flips = int((masks[0] != masks[1]).sum().item()) * side * side // masks[0][0, 0].numel()
    value = psnr(fused, plain)
    log(f"{what} bf16: kernels vs plain PSNR {value:.2f} dB with the kernels' mask (bound "
        f"{PSNR_BOUND}); {psnr(fused, own):.2f} dB with each run's own mask, "
        f"{flips} of {side * side} mask tokens flipped")
    check(value >= PSNR_BOUND, f"{what} PSNR ≥ {PSNR_BOUND} dB")


def synth_lllite_sd(gen: torch.Generator):
    """A ControlLLLite file's flat keys, made on the card: one module on each
    SDXL transformer block's attn1 to_q, to_k, to_v and attn2 to_q, cond_emb_dim
    32, mlp_dim 64 (the layout `split_lllite_modules` reads; torch layout)."""
    def w(*shape):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        return torch.randn(shape, generator=gen, device=gen.device) / math.sqrt(fan_in)

    ce, mlp, sd = LLLITE_CE, LLLITE_MLP, {}
    for blk, depth, width, n in LLLITE_BLOCKS:
        for i in range(n):
            for proj in ("attn1_to_q", "attn1_to_k", "attn1_to_v", "attn2_to_q"):
                pre = f"lllite_unet_{blk}_transformer_blocks_{i}_{proj}."
                mod = {"conditioning1.0.weight": w(ce // 2, 3, 4, 4),
                       "conditioning1.0.bias": w(ce // 2) * 0.1}
                if depth == 2:
                    mod.update({"conditioning1.2.weight": w(ce, ce // 2, 4, 4),
                                "conditioning1.2.bias": w(ce) * 0.1})
                else:
                    mod.update({"conditioning1.2.weight": w(ce // 2, ce // 2, 4, 4),
                                "conditioning1.2.bias": w(ce // 2) * 0.1,
                                "conditioning1.4.weight": w(ce, ce // 2, 2, 2),
                                "conditioning1.4.bias": w(ce) * 0.1})
                mod.update({"down.0.weight": w(mlp, width), "down.0.bias": w(mlp) * 0.1,
                            "mid.0.weight": w(mlp, mlp + ce), "mid.0.bias": w(mlp) * 0.1,
                            "up.0.weight": w(width, mlp) * 0.5, "up.0.bias": w(width) * 0.1})
                sd.update({pre + k: v for k, v in mod.items()})
    return sd


def synth_hypernetwork(gen: torch.Generator, width: int):
    """A hypernetwork's loaded dict, made on the card: one module pair for
    SDXL's 2048-wide context, layer structure 1, 2, 1 with a LayerNorm
    (linear.0, linear.1 the norm, linear.2), relu."""
    dev = gen.device

    def module():
        return {"linear.0.weight": torch.randn((2 * width, width), generator=gen, device=dev)
                / math.sqrt(width),
                "linear.0.bias": torch.zeros(2 * width, device=dev),
                "linear.1.weight": torch.ones(2 * width, device=dev),
                "linear.1.bias": torch.zeros(2 * width, device=dev),
                "linear.2.weight": torch.randn((width, 2 * width), generator=gen, device=dev)
                / math.sqrt(2 * width) * 0.5,
                "linear.2.bias": torch.zeros(width, device=dev)}

    return {width: [module(), module()], "activation_func": "relu",
            "layer_structure": [1, 2, 1], "is_layer_norm": True}


def phase_extensions(engine, gen: torch.Generator):
    """Phase 16: the CFG hook layer and the UNet's block patches with the
    eight extensions on the SDXL engine (see the docstring)."""
    from forge_tpu_torch.extensions import (controllllite, dynamic_thresholding, freeu,
                                            hypernetworks, latent_modifier, pag, sag, stylealign)
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.preprocessors.cv import canny

    t_phase = time.perf_counter()
    unet = engine.loaded.unet
    model_channels = unet["input_blocks"]["0"]["0"]["weight"].shape[0]  # 320
    context_dim = unet["middle_block"]["1"]["transformer_blocks"]["0"]["attn2"]["to_k"][
        "weight"].shape[1]  # 2048
    cond1 = engine.get_learned_conditioning([EXT_PROMPT], EXT_SIZE, EXT_SIZE)  # PAG's, SAG's
    hint_src = np.random.default_rng(16).uniform(0, 255, size=(EXT_SIZE, EXT_SIZE, 3))
    edges = canny(hint_src.astype(np.uint8))
    hint = np.repeat(edges[..., None], 3, axis=-1).astype(np.float32)
    hn_dict, _ = timed("extensions: a hypernetwork made on the card",
                       lambda: synth_hypernetwork(gen, context_dim))
    hn = hypernetworks.load_hypernetwork(hn_dict, name="chip-smoke-hn", device=engine.device)
    lllite_sd, _ = timed("extensions: ControlLLLite's modules made on the card",
                         lambda: synth_lllite_sd(gen))

    def attach_pag(p):
        p.post_cfg_hooks = [pag.build_pag_post_cfg(engine, cond1, 3.0)]

    def attach_sag(p):
        p.unet_hooks, post = sag.build_sag(engine, cond1, 0.75, 2.0)
        p.post_cfg_hooks = [post]

    attaches = {  # label → (attach, the request's own fields)
        "PAG": (attach_pag, {}),
        "SAG": (attach_sag, {}),
        "dynamic thresholding": (lambda p: dynamic_thresholding.attach(
            p, {"mimic_scale": 7.0, "threshold_percentile": 1.0}), dict(cfg_scale=15.0)),
        "latent modifier": (lambda p: latent_modifier.attach(
            p, {"tonemap_multiplier": 3.0, "tonemap_method": "reinhard",
                "sharpness_multiplier": 10.0, "sharpness_method": "gaussian"}), {}),
        "hypernetwork": (lambda p: hypernetworks.attach(p, hn, 1.0), {}),
        "StyleAlign": (lambda p: stylealign.attach(p, {"shared_attention": True,
                                                       "strength": 1.0}), dict(batch_size=2)),
        "ControlLLLite": (lambda p: controllllite.attach(
            p, {"model": "chip-smoke-lllite", "weight": 1.0}, sd=lllite_sd, cond_image=hint,
            device=engine.device), {}),
    }
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    witness = ext_request(engine, "witness")
    add(witness[3])
    x_mid = {"witness": witness[4]}  # each request's latent at the call of step EXT_STEPS // 2
    freeu_hooks = freeu.build_freeu_hooks(model_channels=model_channels, **FREEU_SDXL)
    runs = []
    for seed in (1, 2, 1):
        runs.append(ext_request(engine, "FreeU", seed,
                                lambda p: setattr(p, "unet_hooks", freeu_hooks),
                                witness=witness if seed == 1 else None))
        add(runs[-1][3])
    x_mid["FreeU"] = runs[0][4]
    check(np.array_equal(runs[0][0], runs[2][0]), "FreeU seed 1 twice gives identical bytes")
    check(not np.array_equal(runs[0][0], runs[1][0]), "FreeU seeds 1 and 2 differ")
    log(f"extensions FreeU: latency {runs[0][2]:.4f} / {runs[2][2]:.4f} s against the witness's "
        f"{witness[2]:.4f} s")
    for label, (attach, fields) in attaches.items():
        out = ext_request(engine, label, 1, attach, witness=witness, **fields)
        add(out[3])
        x_mid[label] = out[4]

    # the CFG'd model_fn call of the middle step (its σ, the request's own latent there) with
    # each extension's hooks, and the witness's, through the kernels and the plain versions
    sigmas = proc.get_sigmas("karras", EXT_STEPS, engine.predictor)
    mid = EXT_STEPS // 2
    for label, (attach, fields) in ([("witness", (None, {})),
                                     ("FreeU", (lambda p: setattr(p, "unet_hooks", freeu_hooks),
                                                {}))] + list(attaches.items())):
        p = ext_processing(1, attach, **fields)
        proc.setup(engine, p)
        fn = proc.cfg_model_fn(engine, proc.prepare(engine, p, 0, {}))
        what = f"extensions {label}: model_fn at step {mid}'s σ {sigmas[mid]:.4f}"
        if label == "SAG":
            sag_vs_plain(what, p, fn, x_mid[label], float(sigmas[mid]))
        else:
            kernels_vs_plain(what, lambda: fn(x_mid[label], float(sigmas[mid])))

    # one UNet forward with the five block slots (a scale, a shift, a swap of the skip's halves)
    def swap(s):
        c = s.shape[1] // 2
        return torch.cat([s[:, c:], s[:, :c]], dim=1)

    block_hooks = {
        "input_block_patch": (lambda h, bid: h * (1.0 + 0.02 * bid[1]),),
        "input_block_patch_after_skip": (lambda h, bid: h + 0.01,),
        "middle_block_patch": (lambda h, bid: h * 1.1 - 0.02,),
        "output_block_patch": (lambda h, skip, bid: (h * 0.95, swap(skip) * 0.5 + skip * 0.5),),
        "output_block_patch_after": (lambda h, bid: h - 0.01 * bid[1],),
    }
    side = EXT_SIZE // 8
    x = torch.randn((2, 4, side, side), generator=gen, device=gen.device).to(engine.compute_dtype)
    ts = torch.tensor([999.0, 400.0], device=engine.device)
    cond = engine.get_learned_conditioning([EXT_PROMPT, "blurry"], EXT_SIZE, EXT_SIZE)
    apply = engine.unet_apply_fn(hooks=block_hooks)
    kernels_vs_plain(f"extensions: sdxl unet {side}x{side} B=2 with the five block slots",
                     lambda: apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"]))
    del x
    torch.cuda.empty_cache()
    log(f"extensions phase 16: {time.perf_counter() - t_phase:.2f} s")
    return total


def controls_request(engine, label: str, per_request, steps: int, record_at=(), witness=None,
                     seed: int = 1, size: int = EXT_SIZE, attach=None, phase: str = "controls",
                     **fields):
    """One phase-17 or phase-18 request (size², DPM++ 2M Karras, `steps`
    steps, CFG 7 unless `fields` say otherwise, `attach(p)` run on it), its
    launches exact by body → (its first image, the Processed, the latency,
    the launches, {call: (the sampler's latent, σ) at that model call},
    recorded by a post-CFG hook that launches nothing, the request).
    `phase` begins its log lines."""
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    p = Processing(**{**dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=seed, steps=steps,
                             cfg_scale=7.0, width=size, height=size, sampler_name="DPM++ 2M",
                             scheduler="karras"), **fields})
    if attach is not None:
        attach(p)
    calls, kept = [0], {}

    def record(x0, eps_cond, eps_uncond, x, sigma):
        if calls[0] in record_at:
            kept[calls[0]] = (x.clone(), float(sigma))
        calls[0] += 1
        return x0

    p.post_cfg_hooks = [record]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = process_images(engine, p)
    latency = time.perf_counter() - t
    launches = read_counts()
    img = res.images[0]
    check(img.shape == (size, size, 3) and img.dtype == np.uint8 and img.std() > 0,
          f"{phase} {label}: a {size}²×3 uint8 image, not flat")
    line = (f"{phase} {label} seed={seed}: latency {latency:.4f} s, {calls[0]} model calls, "
            "timings " + json.dumps({k: round(v, 4) for k, v in res.timings.items()})
            + f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, image mean "
            f"{img.mean():.3f} std {img.std():.3f}")
    if witness is not None:
        w_img, _, w_latency = witness[:3]
        check(not np.array_equal(img, w_img), f"{phase} {label}: the image differs from the "
                                              "witness's")
        line += (f" | witness latency {w_latency:.4f} s, {latency / w_latency:.3f}x, PSNR vs "
                 f"the witness {image_psnr(img, w_img):.2f} dB")
    log(line)
    check_counts(launches, per_request, 1, f"the {label} request")
    return img, res, latency, launches, kept, p


def synth_fooocus_patch(unet, gen: torch.Generator):
    """A Fooocus patch made on the card: a [uint8 diff, min, max] group for
    every UNet weight of two or more dimensions (inpaint_v26's layout), the
    diff decoding to within ±0.002, and the 5→320 head."""
    from forge_tpu_torch.core.convert import flatten

    dev = gen.device
    lo, hi = torch.tensor(-0.002, device=dev), torch.tensor(0.002, device=dev)
    patch = {"diffusion_model." + key: [torch.randint(0, 256, tuple(w.shape), generator=gen,
                                                      device=dev, dtype=torch.uint8), lo, hi]
             for key, w in flatten(unet).items() if w.dim() >= 2}
    head = torch.randn((320, 5, 3, 3), generator=gen, device=dev) * 0.05
    return patch, head


def synth_t2i_xl_sd(gen: torch.Generator):
    """An SDXL T2I-Adapter made on the card: conv_in over the 16×
    pixel-unshuffled hint (3·16² = 768 channels), channels (320, 640, 1280,
    1280), two resblocks a stage (block1 3×3, block2 1×1, a 1×1 in_conv
    where the channels change), the stride-2 down_opt at stage 2 only."""
    dev, sd = gen.device, {}

    def conv(key, o, i, k):
        sd[key + ".weight"] = torch.randn((o, i, k, k), generator=gen, device=dev) / math.sqrt(
            i * k * k)
        sd[key + ".bias"] = torch.zeros(o, device=dev)

    conv("conv_in", CONTROLS_T2I_CHANNELS[0], 3 * 16 * 16, 3)
    prev = CONTROLS_T2I_CHANNELS[0]
    for stage, ch in enumerate(CONTROLS_T2I_CHANNELS):
        for j in range(2):
            idx = 2 * stage + j
            if j == 0 and stage == 2:
                conv(f"body.{idx}.down_opt.op", prev, prev, 3)
            if ch != prev:
                conv(f"body.{idx}.in_conv", ch, prev, 1)
            conv(f"body.{idx}.block1", ch, ch, 3)
            conv(f"body.{idx}.block2", ch, ch, 1)
            prev = ch
    return sd


def synth_control_lora_sd(unet, gen: torch.Generator):
    """A Control-LoRA made on the card in stabilityai/control-lora's layout:
    the marker, a cldm's hint block, zero convs and middle_block_out, and a
    rank-128 `.up`/`.down` pair on every trunk weight of two or more
    dimensions."""
    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd

    dev = gen.device
    cldm = synth_controlnet_sd(fill=DeviceFill(dev, seed=3))
    sd = {k: v.materialize() for k, v in cldm.items()
          if k.startswith(("zero_convs", "middle_block_out", "input_hint_block"))}
    sd["lora_controlnet"] = torch.zeros((), device=dev)
    for key, w in flatten(unet).items():
        if key.split(".")[0] not in ("input_blocks", "middle_block", "time_embed", "label_emb") \
                or w.dim() < 2:
            continue
        fan_in = int(np.prod(w.shape[1:]))
        rank = min(CONTROLS_LORA_RANK, w.shape[0], fan_in)
        base = key[:-len(".weight")]
        sd[base + ".up"] = torch.randn((w.shape[0], rank) + (1, 1) * (w.dim() == 4),
                                       generator=gen, device=dev) * (0.02 / math.sqrt(rank))
        sd[base + ".down"] = torch.randn((rank,) + tuple(w.shape[1:]), generator=gen,
                                         device=dev) * 0.25
    return sd


def phase_controls(engine, gen: torch.Generator, steps: int = CONTROLS_STEPS):
    """Phase 17: hook phases and deferred hooks on the SDXL engine, with Deep
    Shrink, Fooocus inpaint, a T2I-Adapter unit, a Control-LoRA unit,
    ControlNet inpaint_only and the latent modifier's extra noise (see the
    docstring)."""
    from collections import Counter

    from forge_tpu_torch.core.convert import flatten
    from forge_tpu_torch.core.patches import apply_patches
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd
    from forge_tpu_torch.extensions import controlnet as cn_ext
    from forge_tpu_torch.extensions import fooocus_inpaint, kohya_hrfix, latent_modifier
    from forge_tpu_torch.ops import attention as attention_mod
    from forge_tpu_torch.pipeline import processing as proc

    t_phase = time.perf_counter()
    shrunk, per_request = controls_counts(steps)
    mid, total = steps // 2, {}

    def add(out):
        for k, v in out[3].items():
            total[k] = total.get(k, 0) + v
        return out

    def request(label, **kw):
        return add(controls_request(engine, label, per_request[label], steps, **kw))

    def forward_vs_plain(label, out, call, hooks=None):
        """The CFG'd model_fn at `call` (its σ, the request's own latent
        there) through the kernels and the plain versions; `hooks` are the
        segment's when the request ran in hook phases."""
        p = out[5]
        q = proc._derive(p, post_cfg_hooks=None, hook_phases=None, deferred_hooks=None,
                         unet_hooks=p.unet_hooks if hooks is None else hooks)
        job = proc.prepare(engine, q, 0, {})
        fn = proc.cfg_model_fn(engine, job)
        x, sigma = out[4][call]
        kernels_vs_plain(f"controls {label}: model_fn at call {call}'s σ {sigma:.4f}",
                         lambda: fn(x, sigma))

    # (a) Deep Shrink at 2048²: the flash shapes of each segment, recorded as they launch
    shapes, segments = [], []
    flash, denoise = attention_mod.flash_attention, proc.denoise

    def recording_flash(q, *args, **kwargs):
        shapes.append(tuple(q.shape))
        return flash(q, *args, **kwargs)

    def segment_denoise(eng, job):
        start = len(shapes)
        out = denoise(eng, job)
        segments.append((len(job.sigmas) - 1, Counter(shapes[start:])))
        return out

    def attach_shrink(p):
        kohya_hrfix.attach(p, CONTROLS_SHRINK)

    attention_mod.flash_attention, proc.denoise = recording_flash, segment_denoise
    try:
        shrink_witness = request("shrink witness", size=CONTROLS_SHRINK_SIZE)
        check(segments == [(steps, Counter({k: v * steps for k, v in
                                            CONTROLS_FULL_SHAPES.items()}))],
              "the 2048² witness: every step at config 2 (a)'s shapes")
        runs = []
        for _ in range(2):
            segments.clear()
            runs.append(request("Deep Shrink", size=CONTROLS_SHRINK_SIZE, attach=attach_shrink,
                                witness=shrink_witness, record_at=(shrunk // 2, mid + 1)))
            want = [(shrunk, Counter({k: v * shrunk for k, v in CONTROLS_SHRUNK_SHAPES.items()})),
                    (steps - shrunk, Counter({k: v * (steps - shrunk)
                                              for k, v in CONTROLS_FULL_SHAPES.items()}))]
            log(f"controls Deep Shrink segments: {[(n, dict(c)) for n, c in segments]}")
            check(segments == want, f"Deep Shrink: {shrunk} shrunk steps at their shapes, then "
                                    f"{steps - shrunk} at config 2 (a)'s")
    finally:
        attention_mod.flash_attention, proc.denoise = flash, denoise
    check(np.array_equal(runs[0][0], runs[1][0]), "Deep Shrink seed 1 twice gives identical bytes")
    kohya = runs[0][5].hook_phases[0][1]
    forward_vs_plain("Deep Shrink, shrunk", runs[0], shrunk // 2,
                     hooks=proc._merge_hooks(runs[0][5].unet_hooks, kohya))
    forward_vs_plain("Deep Shrink, unshrunk", runs[0], mid + 1)
    del runs, shrink_witness

    # (b) Fooocus inpaint on config 3's init image and mask at strength 1.0
    rng = np.random.default_rng(0)  # config 3's init image (bench_lora's generator)
    init = rng.uniform(0, 255, size=(1024, 1024, 3)).astype(np.uint8)
    mask = np.zeros((1024, 1024), np.float32)
    mask[256:768, 256:768] = 1.0
    inpaint = dict(init_images=[init], inpaint_mask=mask, denoising_strength=1.0)
    (patch, head), _ = timed("controls: a Fooocus patch made on the card",
                             lambda: synth_fooocus_patch(engine.loaded.unet, gen))
    log(f"controls: the Fooocus patch holds {len(patch)} uint8 diffs, "
        f"{sum(v[0].numel() for v in patch.values()) / 1e9:.3f} G values")
    patches, _ = fooocus_inpaint.load_fooocus_patches(patch, 1.0, device=engine.device)
    timed("controls: the Fooocus weights built (a per-request copy, decoded tensor by tensor)",
          lambda: apply_patches(engine.loaded.unet, [(patches, 1.0)]))
    del patches
    witness = request("inpaint witness", record_at=(mid,), **inpaint)
    out = request("Fooocus inpaint", witness=witness, record_at=(mid,), attach=lambda p:
                  fooocus_inpaint.attach(p, {}, patch_sd=patch, head_weight=head), **inpaint)
    forward_vs_plain("Fooocus inpaint", out, mid)
    del patch, head, out, witness
    torch.cuda.empty_cache()

    # (c), (d), (f) on txt2img 1024² beside one witness; the units' canny source is a 512² image
    witness = request("txt2img witness")
    source = init[:512, :512]
    t2i_sd, _ = timed("controls: an SDXL T2I-Adapter made on the card",
                      lambda: synth_t2i_xl_sd(gen))
    unit = {"module": "canny", "model": t2i_sd, "image": source, "weight": 1.0}
    out = request("T2I-Adapter", witness=witness, record_at=(mid,),
                  attach=lambda p: cn_ext.attach_units(p, [unit]))
    forward_vs_plain("T2I-Adapter", out, mid)
    del t2i_sd, unit, out

    lora_sd, _ = timed("controls: a rank-128 Control-LoRA made on the card",
                       lambda: synth_control_lora_sd(engine.loaded.unet, gen))
    kind, raw, _, digest = cn_ext.load_control_model(lora_sd)
    check(kind == "control_lora", "the Control-LoRA is told apart by its keys")
    (tree, _), seconds = timed("controls: the Control-LoRA assembled onto the live UNet",
                               lambda: cn_ext.assemble_control_lora(engine, raw, digest))
    worst = 0.0
    base, got = flatten(engine.loaded.unet), flatten(tree)
    for key in ("input_blocks.1.0.in_layers.2.weight", "input_blocks.4.1.proj_in.weight",
                "input_blocks.7.1.transformer_blocks.3.attn1.to_q.weight",
                "middle_block.2.out_layers.3.weight", "label_emb.0.0.weight"):
        stem = key[:-len(".weight")]
        up, down = (lora_sd[stem + s].float().cpu().numpy() for s in (".up", ".down"))
        want = (base[key].float().cpu().numpy()
                + (up.reshape(up.shape[0], -1) @ down.reshape(down.shape[0], -1)
                   ).reshape(base[key].shape))
        err = np.abs(got[key].float().cpu().numpy() - want).max() / np.abs(want).max()
        worst = max(worst, float(err))
    log(f"controls Control-LoRA: assembled weights within {worst:.3e} of base + up·down "
        f"computed in f32 on the host (bound 2e-2), {len(got)} tensors, built in {seconds:.4f} s")
    check(worst <= 2e-2, "the Control-LoRA's assembled weights within bf16's 2e-2")
    check(got["input_blocks.1.0.in_layers.2.weight"].is_contiguous(
        memory_format=torch.channels_last), "an assembled fused-conv weight keeps channels_last")
    unit = {"module": "canny", "model": lora_sd, "image": source, "weight": 1.0}
    out = request("Control-LoRA", witness=witness, record_at=(mid,),
                  attach=lambda p: cn_ext.attach_units(p, [unit]))
    forward_vs_plain("Control-LoRA", out, mid)
    del lora_sd, raw, tree, base, got, unit, out
    engine.__dict__.pop("_control_lora_cache", None)
    torch.cuda.empty_cache()

    out = request("latent modifier", witness=witness, record_at=(mid,),
                  attach=lambda p: latent_modifier.attach(p, CONTROLS_EXTRA_NOISE))
    forward_vs_plain("latent modifier with extra noise", out, mid)
    del out, witness

    # (e) inpaint_only with a cldm of config 3's topology on config 3's inpaint request
    cldm, _ = timed("controls: an SDXL cldm made on the card",
                    lambda: synth_controlnet_sd(fill=DeviceFill("cuda", seed=0)))
    config3 = dict(init_images=[init], inpaint_mask=mask,
                   denoising_strength=CONTROLS_INPAINT_STRENGTH, prompt="a castle")
    calls = min(int(CONTROLS_INPAINT_STRENGTH * steps), steps - 1) + 1
    witness = request("config 3 witness", **config3)
    unit = {"module": "inpaint_only", "model": cldm, "image": init,
            "mask": (mask * 255).astype(np.uint8), "weight": 1.0}
    out = request("inpaint_only", witness=witness, record_at=(calls // 2,),
                  attach=lambda p: cn_ext.attach_units(p, [unit]), **config3)
    far = np.ones((1024, 1024), bool)  # the inpaint blur's support ends 16 px past the square
    far[256 - 17:768 + 17, 256 - 17:768 + 17] = False
    check(np.array_equal(out[0][far], init[far]), "inpaint_only: every pixel 17 px past the "
                                                  "mask is the init's")
    forward_vs_plain("inpaint_only", out, calls // 2)
    del cldm, unit, out, witness
    torch.cuda.empty_cache()
    log(f"controls phase 17 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def keypoint_hint(gen: torch.Generator, size: int = 1024) -> torch.Tensor:
    """InstantID's keypoint hint made from a seed: five face keypoints
    (eyes, nose, mouth corners) as discs of radius 12 in the colours its
    drawing uses, on black, [1, 3, size, size] in [0, 1] on the card."""
    dev = gen.device
    points = torch.rand((5, 2), generator=gen, device=dev) * (size / 2) + size / 4
    yy, xx = torch.meshgrid(torch.arange(size, device=dev), torch.arange(size, device=dev),
                            indexing="ij")
    colours = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [1.0, 1.0, 0], [1.0, 0, 1.0]],
                           device=dev)
    hint = torch.zeros((1, 3, size, size), device=dev)
    for (x, y), colour in zip(points, colours):
        disc = (xx - x) ** 2 + (yy - y) ** 2 <= 144
        hint[0] = torch.where(disc, colour[:, None, None], hint[0])
    return hint


def phase_image_prompts(engine, gen: torch.Generator, steps: int = IMAGE_PROMPT_STEPS,
                        size: int = EXT_SIZE):
    """Phase 18: the image-prompt family on the SDXL engine at size² (see the docstring)."""
    import base64
    import shutil
    import threading

    from forge_tpu_torch.api.server import _apply_alwayson_scripts, create_server
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import (DeviceFill, synth_clip_vision_sd, synth_controlnet_sd,
                                            synth_faceid_sd, synth_instantid_sd,
                                            synth_photomaker_sd)
    from forge_tpu_torch.extensions import controlnet as cn_ext
    from forge_tpu_torch.models.controlnet import ControlNetState
    from forge_tpu_torch.pipeline import ipadapter, photomaker
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.images import decode_png, encode_png
    from forge_tpu_torch.pipeline.revision import revise
    from forge_tpu_torch.runtime.models import ModelManager

    t_phase = time.perf_counter()
    per_request = image_prompt_counts(steps)
    mid, total = steps // 2, {}

    def request(label, **kw):
        out = controls_request(engine, label, per_request[label], steps, record_at=(mid,),
                               size=size, phase="image prompts", **kw)
        add_counts(total, out[3])
        return out

    def forward_vs_plain(label, out):
        """The CFG'd model_fn at the middle call (its σ, the request's own
        latent there) through the kernels and the plain versions; for
        reference-only both passes of that in-window step."""
        p = out[5]
        q = proc._derive(p, post_cfg_hooks=None, deferred_hooks=None)
        job = proc.prepare(engine, q, 0, {})
        if getattr(q, "_revision", None) is not None:  # the deferred hook's rewrite
            revise(q, job.cond, job.uncond)
        fn = proc.cfg_model_fn(engine, job)
        x, sigma = out[4][mid]
        passes = ", recording and CFG passes" if q.reference_state is not None else ""
        kernels_vs_plain(f"image prompts {label}: model_fn at call {mid}'s σ {sigma:.4f}{passes}",
                         lambda: fn(x, sigma))

    def made(label, make):
        out, _ = timed(f"image prompts: {label} made on the card", make)
        return out

    rng = np.random.default_rng(18)
    ref_image = rng.integers(0, 256, size=(size, size, 3), dtype=np.uint8)
    face_photo = rng.integers(0, 256, size=(512, 512, 3), dtype=np.uint8)
    face = torch.randn((512,), generator=gen, device=gen.device).cpu().numpy()

    witness = request("witness")
    forward_vs_plain("witness", witness)
    for module in ("reference_only", "reference_adain", "reference_adain+attn"):
        unit = {"module": module, "image": ref_image, **IMAGE_PROMPT_REFERENCE}
        out = request(module, witness=witness,
                      attach=lambda p, u=unit: cn_ext.attach_units(p, [u], engine.device))
        check(out[5].reference_state.use_attn == (module != "reference_adain"),
              f"{module}: its ReferenceState")
        forward_vs_plain(module, out)
        del out
    torch.cuda.empty_cache()

    fid_sd = made("IP-Adapter FaceID SDXL", lambda: {
        k: v.materialize().to(torch.bfloat16)
        for k, v in synth_faceid_sd(fill=DeviceFill("cuda", seed=181)).items()})
    out = request("FaceID", witness=witness, attach=lambda p: ipadapter.attach(
        p, {"adapter_path": fid_sd, "face_embeds": face, **IMAGE_PROMPT_FACE}, engine.device))
    forward_vs_plain("FaceID", out)
    plus_sd = made("FaceID-Plus v2 SDXL", lambda: synth_faceid_sd(
        plus=True, fill=DeviceFill("cuda", seed=182)))
    vit_h = made("CLIP-ViT-H/14", lambda: synth_clip_vision_sd(fill=DeviceFill("cuda", seed=183)))
    out = request("FaceID-Plus v2", witness=witness, attach=lambda p: ipadapter.attach(
        p, {"adapter_path": plus_sd, "face_embeds": face, "image": face_photo,
            "clip_vision_path": vit_h, "faceid_v2": True, "weight_v2": 1.0,
            **IMAGE_PROMPT_FACE}, engine.device))
    forward_vs_plain("FaceID-Plus v2", out)
    del plus_sd, vit_h, out

    iid = made("InstantID's adapter", lambda: ipadapter.load_ip_adapter(
        synth_instantid_sd(fill=DeviceFill("cuda", seed=184)), engine.device))
    kind, cldm, cldm_cfg, _ = made("InstantID's cldm (config 3's topology)", lambda:
                                   cn_ext.load_control_model(synth_controlnet_sd(
                                       fill=DeviceFill("cuda", seed=185)), engine.device))
    check(kind == "controlnet", "InstantID's ControlNet is a cldm")

    def attach_instantid(p):
        state = ControlNetState(params=cldm, hint=keypoint_hint(gen, size), cfg=cldm_cfg)
        p.unet_hooks, state = ipadapter.build_instantid(iid, face, controlnet_state=state)
        p.controlnets = [state]

    out = request("InstantID", witness=witness, attach=attach_instantid)
    check(tuple(out[5].controlnets[0].context_override.shape[:2]) == (2, 16),
          "InstantID: its ControlNet reads the [cond‖uncond] 16 face tokens")
    forward_vs_plain("InstantID", out)
    del iid, cldm, out
    torch.cuda.empty_cache()

    big_g = made("CLIP-ViT-bigG/14", lambda: {
        k: v.materialize().to(torch.bfloat16) for k, v in synth_clip_vision_sd(
            width=1664, layers=48, mlp=8192, projection=1280,
            fill=DeviceFill("cuda", seed=186)).items()})
    unit = {"module": "revision_clipvision", "image": face_photo, "weight": 1.0,
            "clip_vision_path": big_g}
    out = request("Revision", witness=witness,
                  attach=lambda p: cn_ext.attach_units(p, [unit], engine.device))
    forward_vs_plain("Revision", out)
    del big_g, unit, out
    torch.cuda.empty_cache()

    pm = made("PhotoMaker (ViT-L/14 id encoder, fuse at 2048)", lambda: photomaker.load_photomaker(
        synth_photomaker_sd(fill=DeviceFill("cuda", seed=187)), engine.device))
    transform = photomaker.build_cond_transform(engine, pm, PHOTOMAKER_PROMPT,
                                                id_images=[face_photo])
    pm_witness = request("PhotoMaker witness", prompt=PHOTOMAKER_PROMPT)
    out = request("PhotoMaker", witness=pm_witness, prompt=PHOTOMAKER_PROMPT,
                  attach=lambda p: setattr(p, "cond_transform", transform))
    forward_vs_plain("PhotoMaker", out)
    del pm, transform, pm_witness, out

    # one API txt2img with a reference_only unit and a FaceID adapter file, and its twin
    os.makedirs(IMAGE_PROMPT_DIR, exist_ok=True)
    path = os.path.join(IMAGE_PROMPT_DIR, "faceid_sdxl.safetensors")
    timed("image prompts: the FaceID adapter written (bf16)",
          lambda: save_safetensors(fid_sd, path))
    scripts = {"controlnet": {"args": [{"module": "reference_only", "image": base64.b64encode(
        encode_png(ref_image)).decode(), **IMAGE_PROMPT_REFERENCE}]},
               "IP-Adapter": {"args": [{"adapter_path": path, "face_embeds": face.tolist(),
                                        **IMAGE_PROMPT_FACE}]}}
    manager = ModelManager(checkpoint_dirs=[IMAGE_PROMPT_DIR], device=engine.device)
    manager.set_engine(engine)
    server = create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        answer = http(base, "/sdapi/v1/txt2img", dict(
            prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps, cfg_scale=7.0,
            width=size, height=size, sampler_name="DPM++ 2M", scheduler="karras",
            alwayson_scripts=scripts))
        wall = time.perf_counter() - t
        launches = read_counts()
        add_counts(total, launches)
        pixels, text = decode_png(base64.b64decode(answer["images"][0]))
        log(f"image prompts API reference_only + FaceID seed=1: wall {wall:.4f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, image mean {pixels.mean():.3f} "
            f"std {pixels.std():.3f}")
        check_counts(launches, per_request["API"], 1, "the API request")
        twin = request("API twin", attach=lambda p: _apply_alwayson_scripts(
            p, scripts, engine.device, engine.compute_dtype))
        check(np.array_equal(pixels, twin[0]), "the API's PNG pixels = process_images' image")
        check(text == {"parameters": twin[1].infotexts[0]}, "the PNG's parameters = the infotext")
        check("Reference: reference_only" in text["parameters"], "the infotext names the unit")
        log(f"image prompts API: wall {wall:.4f} s against process_images {twin[2]:.4f} s")
        forward_vs_plain("API twin", twin)
    finally:
        server.shutdown()
        server.server_close()
        manager.close()
        shutil.rmtree(IMAGE_PROMPT_DIR, ignore_errors=True)
    del fid_sd, witness
    torch.cuda.empty_cache()
    log(f"image prompts phase 18 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def profile_request(label: str, run):
    """One request, run(), under torch.profiler: device time by kernel, and
    the busy share (kernel time over the request's wall time). Only the
    card's activity is traced, and its events are summed straight from the
    raw trace: `key_averages()` builds an object a launch, and took 42–71 s
    over the 200,000–362,000 launches of one config-2 request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        wall = time.perf_counter() - t
    by_name = {}  # kernel name → [launches, µs]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e3
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    busy_us = sum(us for _, (_, us) in kernels)
    log(f"profile {label}: wall {wall:.4f} s, kernel time {busy_us / 1e6:.4f} s "
        f"({100 * busy_us / 1e6 / wall:.2f} % busy), {sum(n for _, (n, _) in kernels)} kernel "
        f"launches (the trace summed in {time.perf_counter() - t - wall:.1f} s)")
    for name, (n, us) in kernels[:10]:
        log(f"  {n:6d} × {name[:70]:70s} {us / 1e3:10.3f} ms {100 * us / busy_us:6.2f} %")
    groups = {  # every instance of a port kernel, then the library's kernels by kind
        "gn_silu_conv3x3*": ("gn_silu_conv3x3",), "flash_fwd*": ("flash_fwd",),
        "dequant_matmul*": ("dequant_matmul",),
        "matmuls (cuBLAS, cuDNN)": ("nvjet", "gemm", "cutlass", "cudnn", "xmma"),
        "layout and dtype copies": ("direct_copy",), "reductions": ("reduce_kernel",),
        "elementwise": ("elementwise",)}
    seen = set()
    for group, marks in groups.items():
        rows = [(name, n, us) for name, (n, us) in kernels
                if name not in seen and any(m in name for m in marks)]
        seen.update(name for name, _, _ in rows)
        us = sum(us for _, _, us in rows)
        log(f"  {group}: {sum(n for _, n, _ in rows)} launches, "
            f"{us / 1e3:.3f} ms, {100 * us / busy_us:.2f} %")


def ptxas_summary(build_log: str):
    """`-Xptxas=-v` output → "kernel<args>: registers, shared memory, spills" lines."""
    name, spills, notes = None, "?", {}
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = mangled
            for m in re.finditer(r"\d+", mangled):  # <length><identifier> of the kernel
                for i in range(len(m.group())):  # the length may follow other digits
                    ident = mangled[m.end():m.end() + int(m.group()[i:])]
                    if ident.endswith("_kernel") and mangled[m.end() + len(ident):].startswith("I"):
                        name = ident
            args = ["bf16" if "bfloat16" in mangled else "f32"] + re.findall(r"Li(\d+)E", mangled)
            name = f"{name}<{','.join(args)}>"
        elif "spill" in line:
            spills = "/".join(re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and name:
            regs = re.search(r"(\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            yield (f"{name}: {regs.group(1) if regs else '?'} registers, "
                   f"{smem.group(1) if smem else 0} B smem, spill stores/loads {spills}")
            name, spills = None, "?"
        elif "(C75" in line:  # wgmma notes (C7513: serialized; C7519: a fence injected)
            code = re.search(r"\(C75\d\d\)", line).group()
            func = line.split("function")[-1].strip(" '")
            text = line.split(code)[-1].split(" in function")[0].strip()
            notes.setdefault((code, func), [0, text])[0] += 1
        elif "error" in line.lower() or "warning" in line.lower():
            yield line.strip()[:200]
    for (code, func), (n, text) in notes.items():
        kernel = re.search(r"([a-z][a-z_]*_kernel)I", func)
        args = ",".join(re.findall(r"Li(\d+)E", func))
        yield f"{code} ×{n} in {kernel.group(1) if kernel else func[:80]}<{args}>: {text[:150]}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true", help="run phases 1-2 only")
    ap.add_argument("--families", action="store_true",
                    help="run phase 1, phase 2's SD2, SD3 and Playground rows and phase 13 only, "
                         "with no result")
    ap.add_argument("--api", action="store_true",
                    help="run phase 1, phase 2's VAE tile rows and phase 14 (the REST API on "
                         "SDXL) only, with no result")
    ap.add_argument("--flux-family", action="store_true",
                    help="run phase 1, phase 2's rows for phase 15 and phase 15 (bnb NF4 files, "
                         "fp8 storage, Chroma) only, with no result")
    ap.add_argument("--extensions", action="store_true",
                    help="run phase 1, phase 2's StyleAlign rows and phase 16 (the extension "
                         "hook layers on SDXL) only, with no result")
    ap.add_argument("--controls", action="store_true",
                    help="run phase 1, phase 2's Deep Shrink rows and phase 17 (hook phases and "
                         "deferred hooks on SDXL) at 20 steps only, with no result")
    ap.add_argument("--image-prompts", action="store_true",
                    help="run phase 1, phase 2's joined-key flash rows and phase 18 (the "
                         "image-prompt family on SDXL) at 20 steps only, with no result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    from forge_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_start = t = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"build: {time.perf_counter() - t:.2f} s (nvcc, one process per source, "
        f"{_build.build_seconds} s)")
    for line in ptxas_summary(_build.build_log):
        log("  ptxas:", line)
    smem = _build.library().forge_dequant_matmul_wgmma_smem
    log(f"  dequant_matmul_wgmma_kernel dynamic shared memory: {smem(128)} B at a 128-token "
        f"tile, {smem(256)} B at a 256-token tile")
    smem = _build.library().forge_flash_attention_wgmma_smem
    log("  flash_fwd_wgmma_kernel dynamic shared memory: "
        + ", ".join(f"{smem(d)} B at d = {d}" for d in (40, 128, 160, 512)))
    smem = _build.library().forge_gn_silu_conv3x3_wgmma_smem
    log("  gn_silu_conv3x3_wgmma_kernel dynamic shared memory: "
        + ", ".join(f"{smem(bn)} B at BN = {bn}" for bn in (64, 128, 160, 256)))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    from forge_tpu_torch.runtime.options import opts

    opts.set("save_write_params_txt", False)  # no params.txt written inside timed requests
    summary = phase_kernels(gen, "families" if args.families else "api" if args.api
                            else "flux_family" if args.flux_family
                            else "extensions" if args.extensions
                            else "controls" if args.controls
                            else "image_prompts" if args.image_prompts else "all")
    if args.kernels:
        log("kernels only: phases 1-2 passed")
        return
    if args.api:
        engine = load_sdxl()
        t = time.perf_counter()
        phase_api(engine, gen)
        log(f"api phase: {time.perf_counter() - t:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")
        log("api only: phases 1, 2 (the tile rows) and 14 passed")
        return
    if args.extensions:
        engine = load_sdxl()
        t = time.perf_counter()
        phase_extensions(engine, gen)
        log(f"extensions phase: {time.perf_counter() - t:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")
        log("extensions only: phases 1, 2 (the StyleAlign rows) and 16 passed")
        return
    if args.controls:
        engine = load_sdxl()
        t = time.perf_counter()
        phase_controls(engine, gen, steps=2 * CONTROLS_STEPS)
        log(f"controls phase: {time.perf_counter() - t:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")
        log("controls only: phases 1, 2 (the Deep Shrink rows) and 17 passed")
        return
    if args.image_prompts:
        engine = load_sdxl()
        t = time.perf_counter()
        phase_image_prompts(engine, gen, steps=5 * IMAGE_PROMPT_STEPS)
        log(f"image prompts phase: {time.perf_counter() - t:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")
        log("image prompts only: phases 1, 2 (the joined-key rows) and 18 passed")
        return
    if args.flux_family:
        t = time.perf_counter()
        phase_flux_family(gen)
        log(f"flux family phase: {time.perf_counter() - t:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")
        log("flux family only: phases 1, 2 (their rows) and 15 passed")
        return
    if args.families:
        for name in FAMILIES:
            t = time.perf_counter()
            phase_family(name, gen)
            log(f"{name} phase: {time.perf_counter() - t:.2f} s; script so far "
                f"{time.perf_counter() - t_start:.2f} s")
        log("families only: phases 1, 2 (their rows) and 13 passed")
        return
    t = time.perf_counter()
    engine, launches = phase_slice()
    phase_unet(engine, gen)
    del engine
    torch.cuda.empty_cache()
    log(f"SD1.5 phases: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    flux_launches, nf4_seed1 = phase_flux()
    log(f"Flux phases: {time.perf_counter() - t:.2f} s; script so far {time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    engine, sdxl_launches = phase_sdxl(gen)
    log(f"SDXL phase: {time.perf_counter() - t:.2f} s; script so far {time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    config3_launches = phase_config3(engine, gen)
    log(f"config3 phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    config5_launches = phase_config5(engine, gen)
    log(f"config5 phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    config2_launches = phase_config2(engine, gen)
    log(f"config2 phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    samplers_launches = phase_samplers(engine)
    log(f"samplers phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    prompts_launches = phase_prompts(engine, gen)
    log(f"prompts phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    api_launches = phase_api(engine, gen)  # phase 14, on the SDXL engine before phase 13 frees it
    log(f"api phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    ext_launches = phase_extensions(engine, gen)  # phase 16, on the same engine
    log(f"extensions phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    controls_launches = phase_controls(engine, gen)  # phase 17, on the same engine
    log(f"controls phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    image_prompt_launches = phase_image_prompts(engine, gen)  # phase 18, on the same engine
    del engine
    gc.collect()  # phase 14 leaves reference cycles that hold the engine until the collector runs
    torch.cuda.empty_cache()
    log(f"image prompts phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")
    paths = {"sd15": launches, "flux": flux_launches, "sdxl": sdxl_launches,
             "config3": config3_launches, "config5": config5_launches,
             "config2": config2_launches, "samplers": samplers_launches,
             "prompts": prompts_launches, "api": api_launches, "extensions": ext_launches,
             "controls": controls_launches, "image_prompts": image_prompt_launches}
    for name in FAMILIES:
        t = time.perf_counter()
        paths[name] = phase_family(name, gen)
        log(f"{name} phase: {time.perf_counter() - t:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")
    t = time.perf_counter()
    paths.update(phase_flux_family(gen, nf4_seed1))
    log(f"flux family phase: {time.perf_counter() - t:.2f} s; script so far "
        f"{time.perf_counter() - t_start:.2f} s")

    sources = {
        "flash_attention": ("forge_tpu_torch/csrc/flash_attention.cu",
                            "forge_tpu/ops/flash_attention.py:33"),
        "gn_silu_conv3x3": ("forge_tpu_torch/csrc/gn_silu_conv3x3.cu",
                            "forge_tpu/ops/fused_gn_conv.py:42"),
        "dequant_matmul": ("forge_tpu_torch/csrc/dequant_matmul.cu",
                           "forge_tpu/ops/dequant_matmul.py:109,131,167,190"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {path: p[name] for path, p in paths.items()},
                **summary[name]}
               for name, (src, rep) in sources.items()]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on a main path")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

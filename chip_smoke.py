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
PhotoMaker, and the REST API's always-on scripts), and the script surface on SDXL (the script
runner and its events, the X/Y/Z grid, the selectable scripts, soft inpainting and the img2img
options, the API's script routes), and the postprocessing path (the SwinIR, HAT, DAT and SCUNet
upscalers, CodeFormer and GFPGAN face restoration with restore_faces, the extras routes), and
the rest of the API surface on SDXL (ControlNetScript, saving images with their events and the
event log, the ControlNet, embedding, merge and web UI routes), and the ControlNet annotators
(MiDaS, Depth Anything V2, OpenPose, HED, PiDiNet, TEED, lineart, manga line, M-LSD, NormalBAE)
with a depth_anything_v2 unit on SDXL, and interrogation (the CLIP interrogator with BLIP,
DeepDanbooru, /sdapi/v1/interrogate), the remaining annotators (LeReS, ZoeDepth, Marigold,
UniFormer, the anime face, LaMa) with a depth_marigold unit on SDXL and the extras route's focal
crop, and OneFormer, DensePose and the Forge Spaces (Sapiens-1B normals, U²-Net background
removal, captions, the example) as child processes with a seg_ofade20k unit on SDXL, on one
NVIDIA GPU.

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
    python3 chip_smoke.py --scripts  # phase 1, phase 2's SDXL and outpainting rows, phase 19 at
                                     # 20 steps; no result
    python3 chip_smoke.py --annotators  # phase 1, phase 2's 1370-token flash row and SDXL
                                        # rows, phase 22 at 20 steps; no result
    python3 chip_smoke.py --surface  # phase 1, phase 2's SDXL rows, phase 21 at 20 steps
                                     # with the full-depth merge; no result
    python3 chip_smoke.py --extras   # phase 1, phase 2's SDXL and hires rows, phase 20 at 20
                                     # steps with (d); no result
    python3 chip_smoke.py --interrogate  # phase 1, phase 2's BLIP, Marigold and SDXL rows,
                                         # phase 23 at 20 steps; no result
    python3 chip_smoke.py --spaces   # phase 1, phase 2's Sapiens and SDXL rows, phase 24 at 20
                                     # steps with Sapiens-1B's 40 blocks; no result

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
     on the card from a seed: load_engine, two requests (1024², DPM++ 2M,
     "karras", 20 steps (bench.py's 30), CFG 7, seeds 1, 2) with latency, timings, peak
     memory and exact launch counts by body, seed 1 again under
     torch.profiler (byte-identical), then one UNet forward at (2,4,128,128) through the
     kernels and through the plain versions;
  8. config 3 on the same engine (bench.py's `config3`): a full-width SDXL
     ControlNet made on the card, a rank-16 LoRA over three blocks' attn1
     q/k/v written to logs/ by the port's safetensors writer, then two
     img2img-inpaint requests (1024² uniform-noise init image, the centre
     512² masked, "original" fill, blur 4, strength 0.6 of 20 DPM++ 2M
     Karras steps, CFG 7, "a castle <lora:bench:0.8>", ControlNet-canny at
     strength 1, seeds 1, 2) with exact launch counts by body, the
     unmasked ring checked against the init image, seed 1 again profiled
     (byte-identical),
     the LoRA merge checked against base + 0.8·(α/r)·up·down, and the VAE
     encode at 1024² and a UNet + ControlNet forward at (2,4,128,128)
     through the kernels and the plain versions;
  9. config 5 on the same engine (bench.py's `config5`): CLIP-ViT-H/14 and
     an SDXL IP-Adapter made on the card, a seeded 1024² reference image
     encoded to IP tokens (weight 0.6), one warm request, then two
     requests (1024², batch 2, DPM++ 2M Karras, 10 steps (bench.py's 20), CFG 7, seeds 2,
     3) through `serve_throughput` and the same two through
     `process_images`: exact launch counts by body, served images
     byte-identical to the sequential ones, images/s both ways and
     serve_speedup; weight 0 equal to no hooks and unequal to 0.6; one
     profiled request; then the MultiDiffusion 2× upscale of the first
     served image to 2048² (Euler, 8 steps at strength 0.35, 9 tiles of 96
     latent pixels, overlap 16; seeds 9, 10) with exact launch counts, seed
     10 again profiled (byte-identical); then the UNet with
     the IP hooks at (4,4,128,128) and one 96² tile forward through the
     kernels and the plain versions;
 10. config 2 complete on the same engine (BASELINE configs[1], the webui's
     hires and refiner defaults): (a) the hires fix in latent mode, 1024²
     DPM++ 2M Karras 20 steps CFG 7, then "Latent" ×2 at denoising 0.7
     (hires steps 0 = 30: 22 model calls on 256² latents) and the 2048²
     decode, seeds 1, 2, with exact launch counts by body, latency,
     timings and peak memory, then seed 1 again profiled (byte-identical);
     (b) a full-width
     SDXL refiner made on the card (384 channels, 44 transformer blocks,
     context 1280, adm 2560, CLIP-G 1280 × 32) taking over at switch 0.8,
     seed 1 twice (byte-identical) and one profiled; (c) the pixel mode
     through a full-width RRDBNet ×4 (RealESRGAN_x4plus's widths) written to
     logs/ by the port's safetensors writer: 192² tiles at overlap 8 over
     the 1024² image, Lanczos to 2048², the VAE encoder at 2048²; then a
     base UNet forward at (2,4,256,256) and a refiner forward at
     (2,4,128,128) through the kernels and the plain versions;
 11. the samplers on the same engine: 1024², CFG 7, 5 steps, SDXL's prompt,
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
     parsed back; (b) "a cat AND a red hat :0.8" at UNet batch 3, seeds 1,
     2, seed 1 again profiled (byte-identical), one through the plain
     versions (the images' PSNR printed), a witness (AND and "a cat" at seed
     1, each through the kernels and the plain versions, their PSNRs printed
     side by side) and a
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
     1024², Euler "simple", 14 steps (the model's 28), CFG 7, shift 3.0; Playground v2.5
     (SDXL's geometry, EDM at σ_data 0.5, the channel latent format) at
     1024², DPM++ 2M Karras, 20 steps (the model's 50), CFG 3. Each: the engine's widths
     checked, seeds 1, 2 (the first the warm-up) with latency, phases, peak
     memory and exact launch counts by body, seed 1 again profiled
     (byte-identical), seed 1's whole request through the plain versions
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
     Karras, 20 steps, CFG 7) as txt2img over HTTP at seeds 1, 2 (/progress
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
     16-channel VAE): 1024², Euler "simple", 10 steps (the model's 26), CFG 4 with a negative
     prompt, seeds 1, 2 (the first the warm-up; 26 × 57 + 1 flash launches a
     request on the tensor-core body, 28 conv, 0 dequant), seed 1 again
     profiled (byte-identical), one forward at CFG batch 2 against plain
     (≥ 40 dB). Phase 2 holds flash at Chroma's q(2,24,4608,128).

 16. the extension hook layers on the SDXL engine, after phase 14 and before
     phase 13 frees it (`--extensions`: on an engine of its own): 1024²,
     DPM++ 2M Karras, 4 steps (bench config 2's 30 cut to fit the run's
     limit; the widths are not cut; 20 under --extensions), CFG 7, batch 1: a
     witness request at
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
     the witness's; the CFG'd model_fn call of step 3 (its σ, the
     request's own latent there, recorded by a post-CFG hook that launches
     nothing) with the witness's and each extension's hooks, and one UNet
     forward at (2,4,128,128) with the five block slots, through the kernels
     and the plain versions (≥ 40 dB; SAG's plain run takes the kernels'
     recorded q and k, so both apply one mask, and the run with its own
     mask and the mask tokens that flipped are printed). Phase 2 holds flash
     at StyleAlign's joined q(2,10,8192,64) and q(2,20,2048,64).
 17. hook phases and deferred hooks on the SDXL engine, after phase 16
     (`--controls`: on an engine of its own, at 20 steps): DPM++ 2M Karras,
     4 steps, CFG 7, seed 1, every weight made on the card from a seed.
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
 19. the script surface on the SDXL engine, after phase 18 (`--scripts`: on
     an engine of its own, at 20 steps): 1024², DPM++ 2M Karras, 4 steps,
     CFG 7, seed 1. After a warm request, a Script recording every hook, with callbacks on the
     before_process and CFG events, beside its witness (each txt2img hook
     and event once; the image and infotext the witness's); the X/Y/Z grid
     (cfg_scale [5, 7] × a prompt S/R of two values); a prompt matrix of
     three parts (4 images and the grid); prompts from a two-line textbox
     with --seed and --steps; from the witness's image: loopback (2 loops
     at denoising 0.5), SD upscale ×2 by Lanczos in 1024² tiles with
     overlap 64 (9 tiles at 0.4), poor man's outpainting and Outpainting mk2
     (128 px: a 1280² canvas, the init kept inside the repainted band) and
     img2img alternative test (decode steps = steps; its uncombined batch-1
     applies, cond and uncond, at the middle call's σ against plain, ≥ 40 dB;
     their CFG 7 combination's PSNR printed); config 3's init image, mask and
     strength with soft inpainting, `img2img_extra_noise` 0.1 and colour
     correction beside the hard-mask witness (its soft-masked model_fn
     against plain, ≥ 40 dB; every pixel 17 px past the mask the init's);
     one API txt2img with script_name "Prompt matrix" and one
     /sdapi/v1/xyz-grid, their PNGs' pixels (and text) equal to the
     process_images twins above. Each run's launches exact by body, its
     latency against the witness's and its peak memory printed; a
     traceback the runner printed and passed over fails the phase. Phase 2
     holds flash at the 1280² canvas's 6400 and 1600 tokens and the VAE's
     25600, and the fused conv at every 1280² UNet and VAE size and the
     1024² VAE sizes no row held; `--scripts` runs the SDXL rows with them.
 20. the postprocessing path on the SDXL engine, after phase 19 (`--extras`:
     on an engine of its own, at 20 steps, with (d) and a 512² input to (a)):
     the networks at their published widths, made on the card from a seed
     (core/synth.py) and written under logs/chip_smoke_extras/ in their
     upstream key spaces, so the registry's discovery and sniffing and the
     restorers' loaders are what runs. (a) SwinIR-M real-SR ×4 (models/SwinIR),
     HAT SRx4 (models/HAT), DAT ×4 (models/DAT) and SCUNet color real PSNR at
     ×1 (models/ScuNET) through the registry on a seeded 256² image (512²:
     9 tiles at 192/8): uint8, a tile's output finite, a rerun byte-identical,
     bf16 against the same code at f32 on the card ≥ EXTRAS_UPSCALE_BAR dB,
     seconds and peak memory each; (b) CodeFormer v0.1.0 and GFPGANv1.4 on a
     seeded 1024² image (the full-frame box: 1024 → 512 → 1024), the same
     checks (≥ EXTRAS_RESTORE_BAR dB) and CodeFormer's share of codes equal
     to f32's; (c) an SDXL txt2img (1024², DPM++ 2M Karras, CFG 7, seed 1,
     4 steps) with restore_faces beside its witness: launches exact and the
     same as the witness's, the image equal to `FaceRestorer.restore` of the
     witness's byte for byte, the infotext's "Face restoration: CodeFormer",
     its latency against the witness's, a UNet forward against plain (≥ 40
     dB); (d) (`--extras` only) config 2 (c)'s hires pass to 2048² through
     SwinIR-M beside the same through the ESRGAN, exact launches and seconds
     each; (e) /sdapi/v1/extra-single-image (SwinIR-M ×2 after CodeFormer at
     visibility 1) and /sdapi/v1/extra-batch-images (two images, resize mode
     1 to 1000×700 with the crop), each PNG's pixels equal to the restorer's
     and the registry's result. None of it launches a kernel: (a), (b) and
     (e) are held at 0.
 21. the rest of the API surface on the SDXL engine, after phase 20
     (`--surface`: on an engine of its own, at 20 steps). SDXL 1024², DPM++ 2M
     Karras, CFG 7, seed 1, 4 steps. Saving is off in every other phase
     (`samples_save`, `grid_save` and `save_write_params_txt` are turned off
     at the start, and the event log writes into a temporary directory).
     (a) a canny unit on a full-width SDXL ControlNet made on the card, once
     through a ScriptRunner holding ControlNetScript with the unit in
     `p.controlnet_units` and once through the always-on script dispatch:
     the two images byte-equal, launches exact (the witness's plus the
     ControlNet's forward at each step), and a UNet + ControlNet forward
     against plain (≥ 40 dB); (b) the same request with `samples_save` and
     `save_write_params_txt` on, into a temporary directory: one PNG whose
     pixels equal the returned image and whose "parameters" equal the
     infotext, `before_image_saved` and `image_saved` once each, one row in
     log.csv, one `generation` line in the event log, params.txt, and the
     seconds the save adds; (c) the routes through the port's server on
     port 0: /controlnet/version, /module_list and /model_list;
     /sdapi/v1/create/embedding, then a txt2img whose prompt uses the
     embedding (launches exact); /merge-checkpoints of two synth SDXL
     checkpoints at 0.3 (a spot check of the merged tensors), the merged
     file loaded through /sdapi/v1/options (its seconds printed) and a
     txt2img on it with `save_images` true, whose PNG is written (launches
     exact); GET / answering the web UI. The merged checkpoints have SDXL's
     widths; the whole run cuts their UNet's transformer depths to (0, 1, 1)
     and 1 and CLIP-G to 2 layers, `--surface` keeps SDXL's.
 22. the ControlNet annotators on the SDXL engine, after phase 21
     (`--annotators`: on an engine of its own, at 20 steps). (a) each
     annotator at its published widths (MiDaS DPT-Large, Depth Anything V2
     ViT-L/14, OpenPose body, hand and face, HED, PiDiNet, TEED, the three
     lineart nets, manga line, M-LSD, NormalBAE), its weights made on the
     card from a seed and written under logs/chip_smoke_annotators/ in its
     upstream key space (removed at the end), read by its detector's own
     loader, on a seeded 512² image through the registry: the map finite,
     512²×3 uint8 levels in [0, 1], a rerun byte-identical, the map in the
     annotator's dtype against the same code at f32 ≥ 30 dB (bf16 against
     f32 printed for every one), its seconds on a synchronised rerun, its
     peak memory (runtime/profiling.py `MemoryMonitor`) and the card's busy
     share (`trace`, the card alone, on a third detect); the entries sharing those nets once each; OpenPose's hand
     and face nets on boxes from given keypoints; (b) Depth Anything V2's
     depth through the flash kernel against plain flash (≥ 40 dB), exactly
     24 flash launches a detect, and flash at q(1,16,1370,64) with every
     true score −32 and v = 1 against plain and the exact 1 (a tail key
     left unmasked would take nearly all the weight);
     (c) SDXL 1024², DPM++ 2M Karras, CFG 7, seed 1, 4 steps, with a
     depth_anything_v2 unit on a full-width SDXL ControlNet through
     ControlNetScript beside a witness: the hint equal to the registry's map
     at the request's size, launches exact (phase 21's ControlNet request
     and the annotator's 24 flash), a UNet + ControlNet forward against
     plain (≥ 40 dB), the latency against the witness's.
 23. interrogation and the remaining annotators on the SDXL engine, after
     phase 22 (`--interrogate`: on an engine of its own, at 20 steps). Each
     network at its published widths, its weights made on the card from a
     seed and written under logs/chip_smoke_interrogate/ in its upstream key
     space (removed at the end), with four seeded category files of 1,500
     terms, BLIP's seeded vocab.txt and DeepDanbooru's seeded tag names:
     (a) CLIP ViT-L/14, BLIP base and DeepDanbooru on a seeded 512² image:
     the caption ids, each category's top term and the tags above the
     threshold equal to the same code at f32, BLIP's ViT through the kernels
     against plain (≥ 40 dB) with exactly 12 flash launches, flash at
     q(1,12,577,64) with every true score −32 against plain and the exact 1,
     each call's seconds and busy share (one synchronised call, the card
     alone traced) and peak memory (BLIP's captions at 20 tokens in the
     whole run, the options' 48 under --interrogate), and
     /sdapi/v1/interrogate "clip" and "deepbooru" answering the library's
     caption and tags (launches exact); (b) LeReS, ZoeDepth, Marigold,
     UniFormer, the anime face and LaMa through the registry (LaMa's
     inpaint on a mask): uint8 levels, a rerun byte-identical, against f32
     ≥ 30 dB (the palettes equal), the rerun's seconds and busy share (the
     card alone traced) and peak, launches
     exact (Marigold's 20 DDIM steps), mediapipe_face's RuntimeError;
     (c) Marigold at 4 DDIM steps (20 under --interrogate): launches exact by
     body, a UNet forward against plain (≥ 40 dB), its depth against plain
     in dB; (d) SDXL 1024², DPM++ 2M Karras, CFG 7, seed 1, 4 steps, with a
     depth_marigold unit through ControlNetScript beside a witness: the hint
     equal to the registry's map, launches exact (the ControlNet request's
     and one Marigold detect), UNet + ControlNet against plain (≥ 40 dB),
     the latency against the witness's; (e) /sdapi/v1/extra-single-image
     with `focal_crop_enabled` on the image's central 256² to 350×200: the
     PNG equal to `focal_crop` of the registry's Lanczos upscale.
 24. OneFormer, DensePose and the Forge Spaces on the SDXL engine, after
     phase 23 (`--spaces`: on an engine of its own, at 20 steps). OneFormer
     Swin-L (ADE20K: 250 queries, 150 classes; COCO: 150, 133; detectron2
     pickles with the weights under `model`), DensePose R50-FPN DeepLab,
     U²-Net, Sapiens-1B (8 blocks in the whole run, 40 under --spaces; its
     bf16 export), BLIP base and DeepDanbooru, made on the card from a seed
     and written under logs/chip_smoke_spaces/ (removed at the end), on a
     seeded 512² image: (a) seg_ofade20k and seg_ofcoco and (b) both
     DensePose entries through the registry: uint8 levels, a rerun
     byte-identical, the map (and DensePose's boxes and labels) equal to the
     same code at f32, the rerun's seconds and busy share (the card alone
     traced) and peak, no kernel launched; (c) Sapiens-1B's forward at the
     Space's 1024×768 feed: exactly one flash launch a block, against plain
     (≥ 40 dB), seconds; its normal map with the U²-Net mask and the mask
     alone, each against f32 (≥ 30 dB); (d) the example, sapiens_normal,
     birefnet and florence_2 Spaces launched through /sdapi/v1/spaces/launch
     on the port's server (the four requests at once, four ports), each a
     child process on the card; one POST
     /process each (all four at once), equal to the app's own `process` in
     this process (the PNG's pixels, the greeting, the caption and tags;
     the f32 networks at f32 on both sides), the Sapiens Space's masked
     answer unlike its unmasked one (its child given the U²-Net weights),
     /sdapi/v1/spaces listing them running, then each terminated. The
     children's flash launches are not counted here; (e) SDXL
     1024², DPM++ 2M Karras, CFG 7, seed 1, 4 steps, with a seg_ofade20k
     unit through ControlNetScript beside a witness: the hint equal to the
     registry's map, launches exact (phase 21's ControlNet request: OneFormer
     launches no kernel), UNet + ControlNet against plain (≥ 40 dB), the
     latency against the witness's.

Each path's launch counts are set to 0 just before it is driven and read just
after. Any failed check raises, so the exit code is not 0 and no result line
is printed. Before the card's name and the last two lines, each phase's
seconds and the whole run's, one a line ("seconds <phase>: <s>"). The last
two lines are the per-kernel JSON summary and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
    # phase 22: Depth Anything V2's ViT-L/14 on a 518² feed, 37² + 1 tokens (a ragged tail of 26
    # rows and keys in a 64-wide tile, 90 in a 128-wide one)
    ((1, 16, 1370, 64), 1370, True),
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
SDXL_STEPS = 20  # bench.py's 30, cut for the whole run's time limit (PR 24)
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
# config 5 (bench.py's `config5`): served requests at batch 2 (CFG batch 4), CONFIG5_STEPS (10), each
# forward the UNet's 70 flash calls and 34 convs (the IP hooks' attentions have 4 keys: no
# kernel), then the decode of both images (1 flash, 28 conv)
CONFIG5_STEPS, CONFIG5_BATCH, CONFIG5_IP_WEIGHT = 10, 2, 0.6  # steps cut from 20 (PR 24)
CONFIG5_SEEDS = (2, 3)  # two requests show the warm time
CONFIG5_PER_REQUEST = {"flash_attention": CONFIG5_STEPS * 70 + 1,
                       "gn_silu_conv3x3": CONFIG5_STEPS * 34 + 28, "dequant_matmul": 0}
# the MultiDiffusion upscale: strength 0.35 of 8 Euler steps keeps 3 model calls, each 9 tiles
# (a 256² latent in 96² tiles at overlap 16), then the 2048² encode (1 flash, 20 conv) and decode
UPSCALE_STEPS, UPSCALE_STRENGTH, UPSCALE_TILES = 8, 0.35, 9
UPSCALE_SEEDS = (9, 10)  # seed 10 again under the profiler: byte-identical
UPSCALE_CALLS = min(int(UPSCALE_STRENGTH * UPSCALE_STEPS), UPSCALE_STEPS - 1) + 1
UPSCALE_PER_REQUEST = {"flash_attention": UPSCALE_CALLS * UPSCALE_TILES * 70 + 2,
                       "gn_silu_conv3x3": UPSCALE_CALLS * UPSCALE_TILES * 34 + 20 + 28,
                       "dequant_matmul": 0}
LORA_BLOCKS = ("input_blocks_4_1", "input_blocks_5_1", "output_blocks_3_1")
# config 2 (tests/test_torch_refiner.py traces it on the meta device): (a) 30 base calls (70
# flash, 34 conv each), then the hires pass at strength 0.7 of SDXL_STEPS (20), t_enc = int(0.7·20) =
# 14: 15 calls on 256² latents (70, 34 each), then the 2048² decode (1, 28); (c) the pixel
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
# the samplers phase (tests/test_torch_samplers_slice.py traces it at 20 steps): 5 steps (20
# until phase 19 took the whole run past 1080 s, then 10 until phase 20), each model call the UNet at CFG batch 2 (70
# flash, 34 conv), then the 1024² decode (1, 28). DPM++ 2M, the first-order multistep
# baseline, one call a step; the second-order samplers two a step but none at σ = 0:
# 2 · (steps − 1) + 1; UniPC one call, then one a step but the peeled last; DDIM CFG++ one a step
SAMPLERS_STEPS = 5  # cut from 20, then 10, for the whole run's time limit
SAMPLERS_PHASE = {"DPM++ 2M": ("karras", SAMPLERS_STEPS),
                  "DPM++ SDE": ("karras", 2 * (SAMPLERS_STEPS - 1) + 1),
                  "DPM2": ("karras", 2 * (SAMPLERS_STEPS - 1) + 1),
                  "UniPC": ("automatic", 1 + (SAMPLERS_STEPS - 1)),
                  "DDIM CFG++": ("automatic", SAMPLERS_STEPS)}
# the prompts phase (tests/test_torch_prompts_mixed.py traces it): DPM++ 2M Karras, 20 steps,
# CFG 7, 1024², one model call a step whatever the UNet's batch (2 plain, 3 with one AND part,
# 4 with two regions; the NGMS tail 1), then the 1024² decode
PROMPTS_STEPS = 20
PROMPTS_PER_REQUEST = {"flash_attention": PROMPTS_STEPS * 70 + 1,
                       "gn_silu_conv3x3": PROMPTS_STEPS * 34 + 28, "dequant_matmul": 0}
PROMPTS_EDIT = "a photo of a [cat:dog:0.5] wearing forgeemb"  # forgeemb: a dual TI embedding
PROMPTS_STYLE = ("chip smoke", "{prompt}, dramatic lighting, film grain", "lowres")
PROMPTS_AND = "a cat AND a red hat :0.8"
PROMPTS_WITNESS_SEEDS = (1,)  # AND and "a cat", each through the kernels and plain
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
    # SD3's 28 steps and Playground's 50 cut to 14 and 20 for the whole run's time limit (PR 24)
    "sd3": dict(synth="synth_sd3_checkpoint", family="sd3", size=1024, sampler="Euler",
                scheduler="simple", steps=14, cfg=7.0, calls=14, flash=24, conv=0,
                request_gate=True),
    "playground": dict(synth="synth_playground_checkpoint", family="playground", size=1024,
                       sampler="DPM++ 2M", scheduler="karras", steps=20, cfg=3.0, calls=20,
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
# (1 flash, 28 conv); the img2img at strength 0.5 of SDXL_STEPS makes int(0.5·steps) + 1 model calls and encodes
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
# (lodestones/Chroma: 1024², Euler "simple", CHROMA_STEPS, CFG 4 with a negative prompt). A Chroma
# request: 26 model calls at CFG batch 2, each 19 + 38 joint attentions, then the decode
FLUX_FILES_DIR = "logs/chip_smoke_flux_files"
CHROMA_STEPS, CHROMA_CFG, CHROMA_NEGATIVE = 10, 4.0, "blurry, low quality"  # 26, cut (PR 24)
CHROMA_PER_REQUEST = {"flash_attention": CHROMA_STEPS * (19 + 38) + 1, "gn_silu_conv3x3": 28,
                      "dequant_matmul": 0}
FP8_PER_REQUEST = {"flash_attention": FLUX_STEPS * (19 + 38) + 1, "gn_silu_conv3x3": 28,
                   "dequant_matmul": 0}
# phase 16, the extension hook layers on the SDXL engine (tests/test_torch_cfg_hooks.py and
# test_torch_block_patches.py hold them against the reference on the CPU): SDXL 1024², DPM++ 2M
# Karras, CFG 7, batch 1 (StyleAlign batch 2), 4 steps in the whole run, 20 under --extensions
# (bench config 2's 30 cut to fit the run's limit: at 20 the whole run took 1110.8 s of its 1200
# on an H100 80GB HBM3 at 700 W, at 10 with phase 19 added 1082.6 s, at 6 985.7 s; the widths
# are not cut). A plain request: EXT_STEPS forwards at CFG batch 2
# (70 flash, 34 conv each), then the decode (1, 28). FreeU, dynamic thresholding, the latent
# modifier, the hypernetwork (attn2's 77 keys: plain) and ControlLLLite (plain convs and
# linears) add no launch; StyleAlign joins each
# CFG half's two images into one launch of batch 2 (70 a forward); PAG's perturbed pass adds a
# batch-1 forward a step with attn1 the identity (34 conv, no flash); SAG's degraded pass a whole
# batch-1 forward a step (70 flash, 34 conv)
EXT_STEPS = 4  # the whole run; --extensions sets EXT_FLAG_STEPS
EXT_FLAG_STEPS = 20
EXT_SIZE = 1024


def ext_per_request(steps: int):
    """Phase 16's launches a request by label at `steps`."""
    plain = {"flash_attention": steps * 70 + 1, "gn_silu_conv3x3": steps * 34 + 28}
    return {"witness": plain, "FreeU": plain, "dynamic thresholding": plain,
            "latent modifier": plain, "hypernetwork": plain, "StyleAlign": plain,
            "ControlLLLite": plain,
            "PAG": {"flash_attention": steps * 70 + 1, "gn_silu_conv3x3": steps * 68 + 28},
            "SAG": {"flash_attention": steps * 140 + 1, "gn_silu_conv3x3": steps * 68 + 28}}


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
CONTROLS_STEPS = 4  # 20 under --controls
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

# phase 19: the script surface on the SDXL engine (tests/test_torch_scripts_*.py,
# test_torch_selectable_scripts*.py, test_torch_xyz_grid.py and test_torch_soft_inpainting.py hold
# it against the reference on the CPU; tests/test_torch_scripts_trace.py traces these counts on
# the meta device): 1024², DPM++ 2M Karras, CFG 7, seed 1, 4 steps in the whole run (20 under
# --scripts). A UNet forward is 70 flash / 34 conv at batch 1 or 2 and at 1280², a decode 1 / 28,
# an encode 1 / 20. The outpaintings grow the canvas to 1280²: phase 2 holds their flash at
# 6400 and 1600 tokens and the VAE's 25600, and every conv of the 1280² UNet and VAE, with the
# 1024² VAE convs no earlier row held
SCRIPTS_STEPS = 4  # 20 under --scripts
SCRIPTS_OUTPAINT = 128  # px on every side: a 1280² canvas
SCRIPTS_UPSCALE_OVERLAP = 64  # SD upscale's tiles are the request's size, 1024²: 3 × 3 on 2048²
SCRIPTS_STRENGTH = {"loopback": 0.5, "SD upscale": 0.4, "outpainting": 0.75}
SCRIPTS_MATRIX_PROMPT = "a photograph of an astronaut riding a horse|on the moon|at night"
SCRIPTS_ALT_PROMPT = "a photograph of an astronaut riding a zebra, (detailed:1.2)"
SCRIPTS_FLASH_SHAPES = [((2, 10, 6400, 64), 6400, True), ((2, 20, 1600, 64), 1600, True),
                        ((1, 1, 25600, 512), 25600, True)]
SCRIPTS_CONV_SHAPES = (
    [((2, c, 160 >> level, 160 >> level), o) for c, o, level in SDXL_CONV_PAIRS]
    + [((1, 512, 160, 160), 512), ((1, 512, 320, 320), 512), ((1, 512, 640, 640), 256),
       ((1, 256, 640, 640), 256), ((1, 256, 1280, 1280), 128), ((1, 128, 1280, 1280), 128),
       ((1, 128, 640, 640), 256), ((1, 256, 320, 320), 512),  # the VAE at 1280²
       ((1, 512, 256, 256), 512), ((1, 512, 512, 512), 256), ((1, 256, 512, 512), 256),
       ((1, 256, 1024, 1024), 128)])  # the VAE decoder at 1024²
# the rows --scripts runs: the SDXL rows phase 19's requests take, then its own
SCRIPTS_ROWS = ([((2, 10, 4096, 64), 4096, True), ((2, 20, 1024, 64), 1024, True),
                 ((1, 10, 4096, 64), 4096, True), ((1, 20, 1024, 64), 1024, True),
                 ((1, 1, 16384, 512), 16384, True)] + SCRIPTS_FLASH_SHAPES,
                [((b, c, 128 >> level, 128 >> level), o) for b in (2, 1)
                 for c, o, level in SDXL_CONV_PAIRS]
                + [((1, 512, 128, 128), 512), ((1, 128, 1024, 1024), 128), ((1, 128, 512, 512), 256),
                   ((1, 256, 256, 256), 512)] + SCRIPTS_CONV_SHAPES)
FLASH_SHAPES += SCRIPTS_FLASH_SHAPES
GN_CONV_SHAPES += [shape for shape in SCRIPTS_CONV_SHAPES if shape not in GN_CONV_SHAPES]

# phase 20: the postprocessing path (tests/test_torch_swinir.py, test_torch_upscalers_extra.py,
# test_torch_faces.py, test_torch_codeformer.py, test_torch_restore_slice.py and
# test_torch_extras_api.py hold it against the reference on the CPU;
# tests/test_torch_extras_trace.py traces its counts on the meta device). The four upscalers
# and two restorers at their published widths (core/synth.py), each written as a file in its
# upstream key space and found through the registry or the restorer's directory; their window
# attention and convs are plain torch, as the reference's are plain XLA: no kernel launches.
# The restored SDXL request is its witness's 4 (20 under --extras) model calls and decode.
EXTRAS_STEPS = 4  # 20 under --extras
EXTRAS_DIR = "logs/chip_smoke_extras"
EXTRAS_UPSCALERS = {  # file name: (directory kind, synth function, the registry's scale)
    "003_realSR_SwinIR-M_x4": ("SwinIR", "synth_swinir_sd", 4),
    "HAT_SRx4": ("HAT", "synth_hat_sd", 4),
    "DAT_x4": ("DAT", "synth_dat_sd", 4),
    "scunet_color_real_psnr": ("ScuNET", "synth_scunet_sd", 1),
}
# bf16 against the same code at f32 on the card, the bars PERF.md predicted before the first
# run (dB, on uint8 images)
EXTRAS_UPSCALE_BAR, EXTRAS_RESTORE_BAR = 25.0, 20.0
EXTRAS_CODE_AGREEMENT = 0.99  # CodeFormer's bf16 codes equal to f32's; below it: f32 codes
# (on an H100 80GB HBM3: bf16 throughout 96.48 % of the 256 codes, the transformer
# alone in f32 98.05 %, both under 99 %: FaceRestorer stores and runs the encoder, the
# codebook and the transformer in f32, the generator and the fuse blocks in bf16)
EXTRAS_ROWS = ([((2, 10, 4096, 64), 4096, True), ((2, 20, 1024, 64), 1024, True),
                ((1, 1, 16384, 512), 16384, True)],
               [((2, c, 128 >> level, 128 >> level), o) for c, o, level in SDXL_CONV_PAIRS]
               + [((1, 512, 128, 128), 512), ((1, 512, 256, 256), 512), ((1, 512, 512, 512), 256),
                  ((1, 256, 512, 512), 256), ((1, 256, 1024, 1024), 128),
                  ((1, 128, 1024, 1024), 128)])
# --extras adds config 2 (c)'s hires pass: its levels at 256² latents and the VAE at 2048²
EXTRAS_HIRES_ROWS = ([((2, 10, 16384, 64), 16384, True), ((2, 20, 4096, 64), 4096, True),
                      ((1, 1, 65536, 512), 65536, True)],
                     [((2, c, 256 >> level, 256 >> level), o) for c, o, level in SDXL_CONV_PAIRS]
                     + [((1, 128, 2048, 2048), 128), ((1, 256, 2048, 2048), 128),
                        ((1, 512, 1024, 1024), 256), ((1, 256, 1024, 1024), 256),
                        ((1, 128, 1024, 1024), 256), ((1, 512, 512, 512), 512),
                        ((1, 256, 512, 512), 512)])


# phase 21: the rest of the API surface on the SDXL engine (tests/test_torch_saving*.py,
# test_torch_controlnet_script.py, test_torch_event_log.py, test_torch_management*.py and
# test_torch_surface_api.py hold it against the reference on the CPU;
# tests/test_torch_surface_trace.py traces these counts on the meta device): 1024², DPM++ 2M
# Karras, CFG 7, seed 1, 4 steps in the whole run (20 under --surface). A ControlNet beside the
# UNet adds 34 flash / 16 conv a step (guidance 0 to 1); the merged checkpoint's UNet makes one
# flash launch a transformer block a forward (70 at SDXL's depths, 11 at the whole run's cut)
SURFACE_STEPS = 4  # 20 under --surface
SURFACE_DIR = "logs/chip_smoke_surface"
SURFACE_MERGE = 0.3  # the merge's multiplier: weighted sum a·0.7 + b·0.3
SURFACE_CUT = dict(transformer_depth=(0, 1, 1), middle_depth=1, clip_g_layers=2)
SURFACE_EMBEDDING = "chip-smoke-emb"


# phase 22, the ControlNet annotators: each at its published widths, its weights made on the card
# from a seed and written in its upstream key space under ANNOTATORS_DIR (~3.3 GB of f32 files),
# read by its detector's own loader, on a seeded 512² image through the registry; then Depth
# Anything V2 with the flash kernel against plain flash, and an SDXL request (1024², DPM++ 2M
# Karras, CFG 7, seed 1; 4 steps in the whole run, 20 under --annotators) with a depth_anything_v2
# unit through ControlNetScript beside phase 21's witness
ANNOTATORS_STEPS = 4  # 20 under --annotators
ANNOTATORS_DIR = "logs/chip_smoke_annotators"
ANNOTATOR_BAR = 30.0  # dB: an annotator's map in its dtype against the same code at f32
ANNOTATOR_FLASH = 24  # Depth Anything V2 ViT-L/14: one flash launch a block, at q(1,16,1370,64)
# entry: (the detector's module, its synth functions and files under ANNOTATORS_DIR)
ANNOTATORS = {
    "depth_midas": ("depth", [("synth_midas_sd", "midas/dpt_large-midas.safetensors")]),
    "depth_anything_v2": ("depth_anything", [
        ("synth_depth_anything_sd", "depth_anything_v2/depth_anything_v2_vitl.safetensors")]),
    "openpose_full": ("openpose", [
        ("synth_openpose_body_sd", "openpose/body_pose_model.safetensors"),
        ("synth_openpose_hand_sd", "openpose/hand_pose_model.safetensors"),
        ("synth_openpose_face_sd", "openpose/facenet.safetensors")]),
    "softedge_hed": ("hed", [("synth_hed_sd", "hed/ControlNetHED.safetensors")]),
    "softedge_pidinet": ("pidinet", [("synth_pidinet_sd", "pidinet/table5_pidinet.pth")]),
    "softedge_teed": ("teed", [("synth_teed_sd", "TEED/7_model.safetensors")]),
    "lineart_realistic": ("lineart", [("synth_lineart_sd", "lineart/sk_model.pth")]),
    "lineart_coarse": ("lineart", [("synth_lineart_sd", "lineart/sk_model2.pth")]),
    "lineart_anime": ("lineart", [("synth_lineart_anime_sd", "lineart_anime/netG.pth")]),
    "lineart_anime_denoise": ("manga_line", [("synth_manga_line_sd",
                                              "manga_line/erika.safetensors")]),
    "mlsd": ("mlsd", [("synth_mlsd_sd", "mlsd/mlsd_large_512_fp32.safetensors")]),
    "normalbae": ("normalbae", [("synth_normalbae_sd", "normalbae/scannet.safetensors")]),
}
# an entry's sliders where its defaults leave the random net's map empty: M-LSD at the least
# distance threshold (the slider's 0.01), so that segments are drawn
ANNOTATOR_ARGS = {"mlsd": (0.1, 0.01)}
# the entries that share one of the networks above: each run once (finite, in range)
ANNOTATOR_VARIANTS = ("openpose", "openpose_hand", "openpose_face", "openpose_faceonly",
                      "softedge_hedsafe", "scribble_hed", "softedge_pidisafe", "scribble_pidinet")
ANNOTATORS_ROWS = ([((1, 16, 1370, 64), 1370, True)] + EXTRAS_ROWS[0], EXTRAS_ROWS[1])


# phase 23, interrogation and the remaining annotators: CLIP ViT-L/14 (openai's layout), BLIP's
# base caption model and DeepDanbooru resnet_custom_v3 with seeded category files, vocabulary and
# tag names, and LeReS res101, ZoeD_M12_N, Marigold, UniFormer-S with UPerHead, the anime-face
# UNet and big-lama, each at its published widths, its weights made on the card from a seed and
# written under INTERROGATE_DIR in its upstream key space; /sdapi/v1/interrogate and the library
# calls on a seeded 512² image; each annotator through the registry; Marigold at its DDIM steps
# against plain; an SDXL request (1024², DPM++ 2M Karras, CFG 7, seed 1; 4 steps in the whole
# run, 20 under --interrogate) with a depth_marigold unit beside its witness; the extras route's
# focal crop
INTERROGATE_STEPS = 4  # 20 under --interrogate
INTERROGATE_DIR = "logs/chip_smoke_interrogate"
INTERROGATE_TERMS = 1500  # a category file's terms: interrogate_clip_dict_limit's default
# the whole run's BLIP captions (interrogate_clip_{min,max}_length), cut from the defaults' 48
# for the phase's time; --interrogate keeps the defaults
INTERROGATE_CAPTION = {"interrogate_clip_min_length": 12, "interrogate_clip_max_length": 20}
BLIP_FLASH = 12  # BLIP's ViT-B/16 at 384²: one flash launch a block, at q(1,12,577,64)
MARIGOLD_UNET = {"flash_attention": 10, "gn_silu_conv3x3": 44}  # a forward at batch 1 on 64²
MARIGOLD_VAE = {"flash_attention": 2, "gn_silu_conv3x3": 20 + 28}  # the 512² encode and decode
MARIGOLD_ENTRY_STEPS = 20  # the depth_marigold entry's DDIM steps (the reference's default)
# (synth function, its file under INTERROGATE_DIR, the file's dtype): Marigold as its published
# fp16 variant, the others in f32
INTERROGATE_FILES = [
    ("synth_clip_interrogator_sd", "interrogate/clip_vit_l_14.safetensors", torch.float32),
    ("synth_blip_sd", "BLIP/model_base_caption_capfilt_large.safetensors", torch.float32),
    ("synth_deepbooru_sd", "torch_deepdanbooru/model-resnet_custom_v3.pt", torch.float32),
    ("synth_leres_sd", "leres/res101.pth", torch.float32),
    ("synth_zoe_sd", "zoedepth/ZoeD_M12_N.safetensors", torch.float32),
    ("synth_marigold_sd", "marigold/marigold-v1-0.fp16.safetensors", torch.float16),
    ("synth_uniformer_sd", "uniformer/upernet_global_small.pth", torch.float32),
    ("synth_anime_face_sd", "anime_face_segment/UNet.pth", torch.float32),
    ("synth_lama_sd", "lama/ControlNetLama.pth", torch.float32),
]
# registry entry: (its module, the detector's class, its directory under INTERROGATE_DIR)
INTERROGATE_ANNOTATORS = {
    "depth_leres": ("leres", "LeresDetector", "leres"),
    "depth_zoe": ("zoe", "ZoeDetector", "zoedepth"),
    "depth_marigold": ("marigold", "MarigoldDetector", "marigold"),
    "seg_ufade20k": ("uniformer", "UniformerDetector", "uniformer"),
    "seg_anime_face": ("anime_face", "AnimeFaceSegmenter", "anime_face_segment"),
    "inpaint_only+lama": ("lama", "LamaDetector", "lama"),
}
SEGMENTERS = ("seg_ufade20k", "seg_anime_face")  # palettes: bf16 only where equal to f32's
INTERROGATE_FOCAL = dict(upscaling_resize_w=350, upscaling_resize_h=200)  # (e), from 256²
INTERROGATE_FLASH_SHAPES = [
    ((1, 12, 577, 64), 577, True),    # BLIP's ViT at 384²: 24² + 1 tokens, 65 keys in the last 128
    ((1, 5, 4096, 64), 4096, True),   # Marigold's SD2 UNet at 512²: level 0, batch 1
    ((1, 10, 1024, 64), 1024, True),  # level 1 (level 2's 256 tokens stay plain)
]
# Marigold's UNet at batch 1 on 64², 32², 16² and 8² (SD2's fourteen (C, O, size)), and its VAE
# at 512²: the shapes no row above holds
MARIGOLD_CONV_SHAPES = ([((1, c, side, side), o) for c, o, side in
                         [(320, 320, 64), (640, 320, 64), (960, 320, 64), (320, 640, 32),
                          (640, 640, 32), (960, 640, 32), (1280, 640, 32), (1920, 640, 32),
                          (640, 1280, 16), (1280, 1280, 16), (1920, 1280, 16), (2560, 1280, 16),
                          (1280, 1280, 8), (2560, 1280, 8)]]
                        + [((1, 128, 512, 512), 128), ((1, 128, 256, 256), 256),
                           ((1, 256, 256, 256), 256), ((1, 256, 128, 128), 512),
                           ((1, 512, 128, 128), 512), ((1, 512, 64, 64), 512),
                           ((1, 256, 512, 512), 128), ((1, 512, 256, 256), 256)])
INTERROGATE_CONV_SHAPES = [s for s in MARIGOLD_CONV_SHAPES if s not in GN_CONV_SHAPES]
FLASH_SHAPES += [s for s in INTERROGATE_FLASH_SHAPES if s not in FLASH_SHAPES]
GN_CONV_SHAPES += INTERROGATE_CONV_SHAPES
INTERROGATE_ROWS = (INTERROGATE_FLASH_SHAPES + EXTRAS_ROWS[0],
                    INTERROGATE_CONV_SHAPES + EXTRAS_ROWS[1])

# phase 24, OneFormer, DensePose and the Forge Spaces: OneFormer Swin-L (ADE20K and COCO),
# DensePose R50-FPN DeepLab, U²-Net, Sapiens-1B (8 blocks in the whole run, 40 under --spaces),
# BLIP base and DeepDanbooru made on the card from a seed and written under SPACES_DIR in their
# files' key spaces; each annotator through the registry on a seeded 512² image; Sapiens against
# plain flash; the four port Spaces as child processes through /sdapi/v1/spaces/launch; an SDXL
# request (1024², DPM++ 2M Karras, CFG 7, seed 1; 4 steps in the whole run, 20 under --spaces)
# with a seg_ofade20k unit beside its witness
SPACES_STEPS = 4  # 20 under --spaces
SPACES_DIR = "logs/chip_smoke_spaces"
SAPIENS_FLASH = 40  # Sapiens-1B's blocks: one flash launch a block at q(1,24,3072,64)
SAPIENS_CUT = 8  # its blocks in the whole run, for the time limit
SPACE_NAMES = ("forge_space_example", "forge_space_sapiens_normal", "forge_space_birefnet",
               "forge_space_florence_2")
# (synth function, its file under SPACES_DIR/models, its arguments, the file's dtype): OneFormer's
# as detectron2 pickles its weights (under `model`), Sapiens-1B as its published bf16 export
SPACES_FILES = [
    ("synth_oneformer_sd", "oneformer/250_16_swin_l_oneformer_ade20k_160k.pth", {},
     torch.float32),
    ("synth_oneformer_sd", "oneformer/150_16_swin_l_oneformer_coco_100ep.pth",
     dict(queries=150, classes=133), torch.float32),
    ("synth_densepose_sd", "densepose/densepose_rcnn_R_50_FPN_DL_s1x.safetensors", {},
     torch.float32),
    ("synth_u2net_sd", "u2net/u2net.safetensors", {}, torch.float32),
    ("synth_sapiens_sd", "sapiens/sapiens_1b_normal_render_people_bf16.safetensors", {},
     torch.bfloat16),
    ("synth_blip_sd", "BLIP/model_base_caption_capfilt_large.safetensors", {}, torch.float32),
    ("synth_deepbooru_sd", "torch_deepdanbooru/model-resnet_custom_v3.pt", {}, torch.float32),
]
ONEFORMER_ENTRIES = {"seg_ofade20k": "ade20k", "seg_ofcoco": "coco"}
DENSEPOSE_ENTRIES = {"densepose (pruple bg & purple torso)": "viridis",
                     "densepose_parula (black bg & blue torso)": "parula"}
SPACES_FLASH_SHAPES = [((1, 24, 3072, 64), 3072, True)]  # Sapiens-1B at the Space's 1024×768
FLASH_SHAPES += [s for s in SPACES_FLASH_SHAPES if s not in FLASH_SHAPES]
SPACES_ROWS = (SPACES_FLASH_SHAPES + EXTRAS_ROWS[0], EXTRAS_ROWS[1])


def spaces_counts(steps: int, sapiens_blocks: int = SAPIENS_CUT):
    """Phase 24's launches by label: a detect of OneFormer, DensePose or U²-Net (none), a
    Sapiens forward, a BLIP caption, the witness and the seg_ofade20k unit's request (phase
    21's ControlNet request: OneFormer launches no kernel)."""
    counts = surface_counts(steps)
    none = {"flash_attention": 0, "gn_silu_conv3x3": 0, "dequant_matmul": 0}
    return {"detect": none, "sapiens": dict(none, flash_attention=sapiens_blocks),
            "caption": dict(none, flash_attention=BLIP_FLASH), "witness": counts["witness"],
            "ControlNetScript": counts["ControlNetScript"]}


def marigold_counts(steps: int):
    """One Marigold detect's launches at `steps` DDIM steps."""
    return {name: MARIGOLD_UNET[name] * steps + MARIGOLD_VAE[name] for name in MARIGOLD_UNET}


def interrogate_counts(steps: int):
    """Phase 23's launches by label: (a) a BLIP caption, an API "clip" interrogation (its BLIP
    caption's ViT) and a "deepbooru" one; (d) the witness and the ControlNet request with one
    Marigold detect at the entry's 20 steps."""
    counts = surface_counts(steps)
    detect = marigold_counts(MARIGOLD_ENTRY_STEPS)
    cn = {k: v + detect.get(k, 0) for k, v in counts["ControlNetScript"].items()}
    none = {"flash_attention": 0, "gn_silu_conv3x3": 0, "dequant_matmul": 0}
    return {"caption": dict(none, flash_attention=BLIP_FLASH),
            "API clip": dict(none, flash_attention=BLIP_FLASH), "API deepbooru": none,
            "witness": counts["witness"], "ControlNetScript": cn}


def annotators_counts(steps: int):
    """Phase 22 (c)'s launches a request: the witness, and the ControlNet request with its
    annotator's 24 flash launches."""
    counts = surface_counts(steps)
    cn = dict(counts["ControlNetScript"])
    cn["flash_attention"] += ANNOTATOR_FLASH
    return {"witness": counts["witness"], "ControlNetScript": cn}


def surface_counts(steps: int, merged_blocks: int = 70):
    """Phase 21's launches a request by label; `merged_blocks` the merged
    UNet's transformer blocks."""
    def count(blocks=70, cn=0):
        return {"flash_attention": blocks * steps + 34 * cn * steps + 1,
                "gn_silu_conv3x3": 34 * steps + 16 * cn * steps + 28, "dequant_matmul": 0}

    return {"witness": count(), "ControlNetScript": count(cn=1), "alwayson": count(cn=1),
            "saving": count(cn=1), "embedding": count(), "merged": count(merged_blocks)}


def extras_counts(steps: int):
    """Phase 20's launches by label."""
    txt = {"flash_attention": 70 * steps + 1, "gn_silu_conv3x3": 34 * steps + 28,
           "dequant_matmul": 0}
    none = dict.fromkeys(txt, 0)
    return {"upscalers": none, "restorers": none, "restore witness": txt, "restore_faces": txt,
            "hires ESRGAN": dict(CONFIG2_PIXEL_PER_REQUEST),
            "hires SwinIR": dict(CONFIG2_PIXEL_PER_REQUEST), "API": none}


# the hooks the recording Script logs, and the events its callbacks log
SCRIPTS_HOOKS = ("setup", "before_process", "process", "before_process_batch", "process_batch",
                 "process_before_every_sampling", "after_extra_networks_activate",
                 "before_process_init_images", "before_hr", "post_sample", "on_mask_blend",
                 "postprocess_batch", "postprocess_batch_list", "postprocess_image",
                 "postprocess_image_after_composite", "postprocess")
SCRIPTS_EVENTS = ("before_process", "cfg_denoiser", "cfg_denoised", "cfg_after_cfg")


def scripts_counts(steps: int):
    """Phase 19's launches a run by label (a script's run is all its requests)."""
    def count(forwards, encodes=0, n=1):
        return {"flash_attention": n * (70 * forwards + encodes + 1),
                "gn_silu_conv3x3": n * (34 * forwards + 20 * encodes + 28), "dequant_matmul": 0}

    def calls(strength):  # an img2img request's model calls: t_enc + 1
        return min(int(strength * steps), steps - 1) + 1

    txt = count(steps)
    textbox = {k: v + count(max(steps // 2, 1))[k] for k, v in txt.items()}
    inpaint = count(calls(CONFIG3_STRENGTH), encodes=1)
    return {"script witness": txt, "recording script": txt, "X/Y/Z grid": count(steps, n=4),
            "prompt matrix": count(steps, n=4), "prompts from textbox": textbox,
            "loopback": count(calls(SCRIPTS_STRENGTH["loopback"]), encodes=1, n=2),
            "SD upscale": count(calls(SCRIPTS_STRENGTH["SD upscale"]), encodes=1, n=9),
            "poor man's outpainting": count(calls(SCRIPTS_STRENGTH["outpainting"]), encodes=2),
            "outpainting mk2": count(calls(SCRIPTS_STRENGTH["outpainting"]), encodes=1),
            "img2img alternative test": count(4 * steps, encodes=1),
            "inpaint witness": inpaint, "soft inpainting": inpaint,
            "API prompt matrix": count(steps, n=4), "API X/Y/Z grid": count(steps, n=4)}


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


def time_ms(fn, budget_ms: float = 30.0) -> float:
    """Mean device time of fn() by CUDA events, after a warm-up call that also
    sizes the window: 1 to 50 runs, as many as fit in `budget_ms` (300 ms, at
    least 3 runs and a second sizing call before, then 150 ms and 2 runs;
    30 ms now, for the whole run's time limit)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = int(min(50, max(1, budget_ms / max((time.perf_counter() - t0) * 1e3, 1e-3))))
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
    """Phase 2; with rows "families", "api", "flux_family", "extensions",
    "controls", "image_prompts" or "scripts", the flash and conv rows of the
    SD2, SD3 and Playground paths, of phase 14's VAE tiles, of phase 15 (with
    its NF4 dequant rows), of phase 16 (StyleAlign's two flash rows), of
    phase 17 (Deep Shrink's four flash shapes and three conv shapes), of
    phase 18 (reference-only's two joined-key flash shapes) or of phase 19
    (the SDXL rows its requests take, and its 1280² and VAE rows) alone."""
    summary = {}
    if rows != "all":
        flash, conv = {"families": (FAMILY_FLASH_SHAPES, FAMILY_CONV_SHAPES),
                       "api": (TILE_FLASH_SHAPES, TILE_CONV_SHAPES),
                       "flux_family": (FLUX_FAMILY_FLASH_SHAPES, FLUX_FAMILY_CONV_SHAPES),
                       "extensions": (EXTENSIONS_FLASH_SHAPES, []),
                       "controls": (CONTROLS_FLASH_SHAPES, CONTROLS_CONV_SHAPES),
                       "image_prompts": (IMAGE_PROMPT_FLASH_SHAPES, []),
                       "scripts": SCRIPTS_ROWS,
                       "extras": (EXTRAS_ROWS[0] + EXTRAS_HIRES_ROWS[0],
                                  EXTRAS_ROWS[1] + EXTRAS_HIRES_ROWS[1]),
                       "surface": EXTRAS_ROWS, "annotators": ANNOTATORS_ROWS,
                       "interrogate": INTERROGATE_ROWS, "spaces": SPACES_ROWS}[rows]
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
    images = [sdxl_request(engine, seed, "") for seed in (1, 2)]
    launches = read_counts()
    check(not np.array_equal(images[0], images[1]), "SDXL seeds 1 and 2 differ")
    check_counts(launches, SDXL_PER_REQUEST, 2, "the 2 SDXL requests")
    again = profile_request("sdxl 1024²", lambda: sdxl_request(engine, 1, "profiled"))
    check(np.array_equal(images[0], again), "SDXL seed 1 twice (the second profiled) gives "
          "identical bytes")

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
    images = [config3_request(engine, seed, "", init, mask, control) for seed in (1, 2)]
    launches = read_counts()
    check(not np.array_equal(images[0], images[1]), "config3 seeds 1 and 2 differ")
    check_counts(launches, CONFIG3_PER_REQUEST, 2, "the 2 config3 requests")
    far = np.ones((1024, 1024), bool)  # the blur's support ends 4σ = 16 px past the square
    far[256 - 17:768 + 17, 256 - 17:768 + 17] = False
    for img in images:
        check(np.array_equal(img[far], init[far]), "every pixel 17 px past the mask is the init's")
        check(not np.array_equal(img[~far], init[~far]), "the masked square was repainted")
    log(f"config3: {int(far.sum())} unmasked ring pixels equal the init image's in both images")
    again = profile_request("config3 1024²", lambda: config3_request(engine, 1, "profiled", init,
                                                                     mask, control))
    check(np.array_equal(images[0], again), "config3 seed 1 twice (the second profiled) gives "
          "identical bytes")

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
    check(not np.array_equal(upscaled[0], upscaled[1]), "upscale seeds 9 and 10 differ")
    again = profile_request("config5 upscale 2048²", lambda: process_images(
        engine, upscale_request(first, UPSCALE_SEEDS[-1])))
    check(np.array_equal(upscaled[1], again.images[0]),
          "upscale seed 10 twice (the second profiled) gives identical bytes")

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
    """BASELINE config 2's first pass (1024², DPM++ 2M Karras, SDXL_STEPS, CFG
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
    images = [config2_request(engine, seed, "hires latent", **hires) for seed in (1, 2)]
    latent_launches = read_counts()
    check(not np.array_equal(images[0], images[1]), "config2 hires seeds 1 and 2 differ")
    check_counts(latent_launches, CONFIG2_LATENT_PER_REQUEST, 2, "the 2 hires requests")
    again = profile_request("config2 hires 2048²", lambda: config2_request(
        engine, 1, "hires, profiled", **hires))
    check(np.array_equal(images[0], again), "config2 hires seed 1 twice (the second profiled) "
          "gives identical bytes")

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
        images = [prompts_request(engine, "(b) AND", seed)[0] for seed in (1, 2)]
        launches = read_counts()
        check(not np.array_equal(images[0], images[1]), "(b) seeds 1 and 2 differ")
        check(engine.unet_batches == {(3, 4, 128, 128): PROMPTS_STEPS}, "(b) 20 calls at batch 3")
        check_counts(launches, PROMPTS_PER_REQUEST, 2, "the 2 (b) requests")
        total = {k: total[k] + launches[k] for k in total}
        again, _ = profile_request("prompts (b) AND 1024²",
                                   lambda: prompts_request(engine, "(b) profiled"))
        check(np.array_equal(images[0], again), "(b) seed 1 twice (the second profiled) gives "
              "identical bytes")
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
        kern = {(PROMPTS_AND, 1): images[0], (PROMPTS_AND, 2): images[1]}
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
    phase 13): seeds 1 and 2 with exact launch counts (the first the warm-up), seed 1
    again profiled (byte-identical), seed 1's request through the plain versions, and the
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
    zero_counts()  # the seed-1 request is the warm-up, seed 2's shows the warm time
    images = [family_request(engine, spec, seed, "") for seed in (1, 2)]
    launches = read_counts()
    check(not np.array_equal(images[0], images[1]), f"{name} seeds 1 and 2 differ")
    per_request = {"flash_attention": spec["calls"] * spec["flash"] + 1,
                   "gn_silu_conv3x3": spec["calls"] * spec["conv"] + 28, "dequant_matmul": 0}
    check_counts(launches, per_request, 2, f"the 2 {name} requests")
    again = profile_request(f"{name} {spec['size']}²",
                            lambda: family_request(engine, spec, 1, "profiled"))
    check(np.array_equal(images[0], again), f"{name} seed 1 twice (the second profiled) gives "
          "identical bytes")
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
    """Phase 15 (c): Chroma at full width in bf16: seeds 1 and 2 with exact
    launches (the first the warm-up), seed 1 again profiled (byte-identical),
    one batch-2 forward against plain."""
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
    zero_counts()  # the seed-1 request is the warm-up
    images = [chroma_request(engine, seed, "") for seed in (1, 2)]
    launches = read_counts()
    check(not np.array_equal(images[0], images[1]), "Chroma seeds 1 and 2 differ")
    check_counts(launches, CHROMA_PER_REQUEST, 2, "the 2 Chroma requests")
    again = profile_request("chroma 1024²", lambda: chroma_request(engine, 1, "profiled"))
    check(np.array_equal(images[0], again), "Chroma seed 1 twice (the second profiled) gives "
          "identical bytes")
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
    check_counts(launches, ext_per_request(EXT_STEPS)[label], 1, f"the {label} request")
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


class _Tee(io.TextIOBase):
    """Writes through to a stream and keeps what was written."""

    def __init__(self, out):
        self.out, self.seen = out, []

    def write(self, text):
        self.seen.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def phase_scripts(engine, gen: torch.Generator, steps: int = SCRIPTS_STEPS, size: int = EXT_SIZE):
    """Phase 19: the script surface on the SDXL engine at size² (see the
    docstring). Everything printed while it runs is kept, and a traceback
    the script runner or the callback registry printed and passed over
    ("... failed:") fails the phase."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        total = _phase_scripts(engine, gen, steps, size)
    swallowed = [line for line in "".join(tee.seen).splitlines() if " failed:" in line]
    check(not swallowed, f"scripts: no traceback swallowed ({swallowed[:3]})")
    return total


def _phase_scripts(engine, gen: torch.Generator, steps: int, size: int):
    import base64
    import collections
    import threading

    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.extensions.soft_inpainting import attach as attach_soft
    from forge_tpu_torch.extensions.xyz_grid import Axis, run_xyz_grid
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline import selectable_scripts as sel
    from forge_tpu_torch.pipeline.images import decode_png
    from forge_tpu_torch.runtime import scripts as scripts_mod
    from forge_tpu_torch.runtime.models import ModelManager
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.runtime.options import opts
    from forge_tpu_torch.sampling import cfg as cfg_mod
    from forge_tpu_torch.sampling.schedules import get_sigmas

    t_phase = time.perf_counter()
    per_label, total = scripts_counts(steps), {}
    fields = dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps, cfg_scale=7.0,
                  width=size, height=size, sampler_name="DPM++ 2M", scheduler="karras")

    def request(**kw):
        return proc.Processing(**{**fields, **kw})

    def run(label, fn, witness_latency=None, requests=1):
        """fn() (a script's requests), its launches exact by body → (what it
        returned, its latency); its images uint8, three channels, not flat."""
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        latency = time.perf_counter() - t
        launches = read_counts()
        add_counts(total, launches)
        images = out.images if hasattr(out, "images") else out
        for img in images:
            check(img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3 and img.std() > 0,
                  f"scripts {label}: uint8 RGB images, not flat")
        line = (f"scripts {label}: latency {latency:.4f} s over {requests} request(s), "
                f"{len(images)} image(s) {sorted({im.shape[:2] for im in images})}, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, first image mean "
                f"{images[0].mean():.3f} std {images[0].std():.3f}")
        if witness_latency:
            line += (f" | {latency / requests:.4f} s a request, {latency / requests / witness_latency:.3f}x"
                     f" the witness's {witness_latency:.4f} s")
        log(line)
        check_counts(launches, per_label[label], 1, f"the {label} run")
        return out, latency

    # (a) a Script recording every hook, with callbacks on the events, beside its witness (after
    # a warm request: under --scripts the engine's first request pays the first text encode)
    timed("scripts: a warm request (not counted)",
          lambda: proc.process_images(engine, request(seed=2)))
    witness, w_latency = run("script witness", lambda: proc.process_images(engine, request()))
    log_hooks = []

    class Recording(scripts_mod.Script):
        name = "recording"

    for hook in SCRIPTS_HOOKS:
        setattr(Recording, hook, lambda self, p, *a, _h=hook, **k: log_hooks.append(_h))
    runner = scripts_mod.ScriptRunner()
    runner.register(Recording())
    for event in SCRIPTS_EVENTS:
        scripts_mod.on(event, lambda *a, _e=event: log_hooks.append("event " + _e))
    try:
        scripted, _ = run("recording script", lambda: proc.process_images(
            engine, request(scripts=runner)), w_latency)
    finally:
        scripts_mod.clear()
    once = ("setup", "before_process", "process", "after_extra_networks_activate",
            "before_process_batch", "process_batch", "process_before_every_sampling",
            "postprocess_batch", "postprocess_batch_list", "postprocess_image", "postprocess")
    check(collections.Counter(log_hooks) == collections.Counter(
        once + tuple("event " + e for e in SCRIPTS_EVENTS)),
        f"scripts: each txt2img hook and event once ({collections.Counter(log_hooks)})")
    check(np.array_equal(scripted.images[0], witness.images[0])
          and scripted.infotexts == witness.infotexts,
          "scripts: hooks returning None leave the image and infotext as the witness's")
    log(f"scripts: the recording script's hooks in order: {', '.join(log_hooks)}")

    # (b) the X/Y/Z grid: cfg_scale × a prompt S/R of two values
    x_axis, y_axis = Axis("cfg_scale", [5.0, 7.0]), Axis("prompt_sr", ["astronaut", "cat"],
                                                           search="astronaut")
    grids, _ = run("X/Y/Z grid", lambda: run_xyz_grid(engine, request(), x_axis, y_axis),
                   w_latency, 4)
    check(grids[0].shape == (2 * size, 2 * size, 3), "scripts: a 2 × 2 grid")

    # (c) a prompt matrix of three parts, (d) prompts from a two-line textbox
    matrix_args = [False, False, "positive", "comma", 0]
    matrix, _ = run("prompt matrix", lambda: sel.get_script("Prompt matrix").run(
        engine, request(prompt=SCRIPTS_MATRIX_PROMPT), *matrix_args), w_latency, 4)
    check(len(matrix.images) == 5 and matrix.images[0].shape == (2 * size, 2 * size, 3),
          "scripts: the matrix's grid and its 4 images")
    text = (f"{EXT_PROMPT} --seed 2 --steps {steps}\n"
            f"a photograph of a cat in a spacesuit --seed 3 --steps {max(steps // 2, 1)}")
    lines, _ = run("prompts from textbox", lambda: sel.get_script(
        "Prompts from file or textbox").run(engine, request(), prompt_txt=text), w_latency, 2)
    check(lines.seeds == [2, 3] and f"Steps: {max(steps // 2, 1)}," in lines.infotexts[1],
          "scripts: each line's --seed and --steps")

    # (e) loopback, (f) SD upscale, (g) the outpaintings, (h) img2img alternative test, each
    # from the witness's image
    init = witness.images[0]
    loop, _ = run("loopback", lambda: sel.get_script("Loopback").run(
        engine, request(init_images=[init], denoising_strength=SCRIPTS_STRENGTH["loopback"]),
        loops=2, final_denoising_strength=SCRIPTS_STRENGTH["loopback"]), w_latency, 2)
    check(loop.seeds == [1, 2], "scripts: loopback's seeds")
    up, _ = run("SD upscale", lambda: sel.get_script("SD upscale").run(
        engine, request(init_images=[init], denoising_strength=SCRIPTS_STRENGTH["SD upscale"]),
        None, SCRIPTS_UPSCALE_OVERLAP, "Lanczos", 2.0), w_latency, 9)
    check(up.images[0].shape == (2 * size, 2 * size, 3), "scripts: SD upscale ×2")
    side = size + 2 * SCRIPTS_OUTPAINT
    for label, name, kw in (("poor man's outpainting", "Poor man's outpainting",
                             dict(mask_blur=4, inpainting_fill="fill")),
                            ("outpainting mk2", "Outpainting mk2", dict(mask_blur=8))):
        out, _ = run(label, lambda: sel.get_script(name).run(
            engine, request(init_images=[init],
                            denoising_strength=SCRIPTS_STRENGTH["outpainting"]),
            pixels=SCRIPTS_OUTPAINT, **kw), w_latency)
        # the repainted band (2 × mask_blur, at least 8 px), then the blur's reach (4σ)
        pad = SCRIPTS_OUTPAINT + max(2 * kw["mask_blur"], 8) + 4 * kw["mask_blur"] + 1
        check(out.images[0].shape == (side, side, 3)
              and np.array_equal(out.images[0][pad:side - pad, pad:side - pad],
                                 init[pad - SCRIPTS_OUTPAINT:side - pad - SCRIPTS_OUTPAINT,
                                      pad - SCRIPTS_OUTPAINT:side - pad - SCRIPTS_OUTPAINT]),
              f"scripts: {label} {side}², the init image kept inside the band")
    alt, _ = run("img2img alternative test", lambda: sel.get_script(
        "img2img alternative test").run(
        engine, request(init_images=[init], prompt=SCRIPTS_ALT_PROMPT), None, True, EXT_PROMPT,
        "blurry", True, steps, 0.0), w_latency)
    check(alt.infotexts == [f"{SCRIPTS_ALT_PROMPT}\nimg2img alternative, decode steps {steps}"],
          "scripts: img2img alternative test's infotext")
    cond = engine.get_learned_conditioning([SCRIPTS_ALT_PROMPT], size, size)
    uncond = engine.get_learned_conditioning(["blurry"], size, size, is_negative=True)
    x01 = torch.from_numpy(np.ascontiguousarray(init[None].transpose(0, 3, 1, 2))).float()
    latent = engine.encode_first_stage(x01 / 127.5 - 1.0)
    sigma = float(get_sigmas("normal", steps, engine.predictor)[steps // 2])  # the middle call's
    x = latent + torch.randn(latent.shape, generator=gen, device=gen.device) * sigma
    # the test's new forward: one uncombined batch-1 apply of the UNet, for the cond and the
    # uncond apart (`_cfg_apply` combines two of them on the host by CFG 7, which scales the two
    # calls' rounding up; that combination's PSNR is printed beside them)
    apply = cfg_mod.make_apply_model(engine.unet_apply_fn(), engine.loaded.unet,
                                     engine.predictor, engine.compute_dtype)
    label = f"scripts img2img alternative test: the uncombined batch-1 apply at σ {sigma:.4f}"
    with torch.no_grad():
        fused = [apply(x, sigma, c) for c in (cond, uncond)]
        with plain_versions():
            plain = [apply(x, sigma, c) for c in (cond, uncond)]
    for which, got, want in zip(("cond", "uncond"), fused, plain):
        value = psnr(got, want)
        log(f"{label} ({which}) bf16: kernels vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(value >= PSNR_BOUND, f"{label} ({which}) PSNR ≥ {PSNR_BOUND} dB")
    log(f"{label}: its CFG 7 combination, kernels vs plain PSNR "
        f"{psnr(fused[1] + 7.0 * (fused[0] - fused[1]), plain[1] + 7.0 * (plain[0] - plain[1])):.2f}"
        " dB (printed, not a gate)")
    del latent, x, apply, fused, plain

    # (i) config 3's inpaint request with soft inpainting, extra noise and colour correction,
    # beside the hard-mask witness
    rng = np.random.default_rng(0)  # config 3's init image (bench_lora's generator) and mask
    c3_init = rng.uniform(0, 255, size=(size, size, 3)).astype(np.uint8)
    mask = np.zeros((size, size), np.float32)
    mask[size // 4:3 * size // 4, size // 4:3 * size // 4] = 1.0
    inpaint = dict(init_images=[c3_init], inpaint_mask=mask, denoising_strength=CONFIG3_STRENGTH)
    hard, h_latency = run("inpaint witness", lambda: proc.process_images(engine, request(**inpaint)))
    options = {"img2img_extra_noise": 0.1, "img2img_color_correction": True}

    def soft_request():
        p = request(**inpaint)
        attach_soft(p, {})
        return p

    with opts.override(options):
        soft, _ = run("soft inpainting", lambda: proc.process_images(engine, soft_request()),
                      h_latency)
        q = soft_request()
        proc.setup(engine, q)
        proc.plan(engine, q)
        job = proc.prepare(engine, q, 0, {})
    far = np.ones((size, size), bool)
    far[size // 4 - 17:3 * size // 4 + 17, size // 4 - 17:3 * size // 4 + 17] = False
    text = soft.infotexts[0]
    check("Soft inpainting: True" in text and "Extra noise: 0.1" in text,
          "scripts: the soft request's infotext names soft inpainting and the extra noise")
    check(not np.array_equal(soft.images[0], hard.images[0])
          and np.array_equal(soft.images[0][far], c3_init[far]),
          "scripts: soft inpainting unlike the witness, every pixel 17 px past the mask the init's")
    log(f"scripts soft inpainting: PSNR vs the hard-mask witness "
        f"{image_psnr(soft.images[0], hard.images[0]):.2f} dB")
    fn, sigma0 = proc.cfg_model_fn(engine, job), float(job.sigmas[0])
    kernels_vs_plain(f"scripts soft inpainting: the soft-masked model_fn at σ {sigma0:.4f}",
                     lambda: fn(job.x, sigma0))
    del job, fn, q

    # (j) the API: txt2img with script_name "Prompt matrix", and /sdapi/v1/xyz-grid, each
    # beside its process_images twin above
    manager = ModelManager(checkpoint_dirs=[], device=engine.device)
    manager.set_engine(engine)
    server = create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    texts = []

    def api(path, body):
        answer = http(base, path, body)
        decoded = [decode_png(base64.b64decode(b64)) for b64 in answer["images"]]
        texts.extend(text.get("parameters") for _, text in decoded)
        return [pixels for pixels, _ in decoded]

    try:
        got, _ = run("API prompt matrix", lambda: api("/sdapi/v1/txt2img", dict(
            fields, prompt=SCRIPTS_MATRIX_PROMPT, script_name="Prompt matrix",
            script_args=matrix_args)), w_latency, 4)
        check(len(got) == len(matrix.images)
              and all(np.array_equal(a, b) for a, b in zip(got, matrix.images))
              and texts == matrix.infotexts,
              "scripts: the API's prompt matrix PNGs = process_images' images and infotexts")
        got, _ = run("API X/Y/Z grid", lambda: api("/sdapi/v1/xyz-grid", dict(
            fields, x_axis={"field": "cfg_scale", "values": [5.0, 7.0]},
            y_axis={"field": "prompt_sr", "values": ["astronaut", "cat"],
                    "search": "astronaut"})), w_latency, 4)
        check(len(got) == 1 and np.array_equal(got[0], grids[0]),
              "scripts: the API's X/Y/Z grid = run_xyz_grid's")
    finally:
        server.shutdown()
        server.server_close()
        manager.close()
    del witness, scripted, grids, matrix, lines, loop, up, alt, hard, soft
    torch.cuda.empty_cache()
    log(f"scripts phase 19 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def phase_extras(engine, gen: torch.Generator, steps: int = EXTRAS_STEPS, full: bool = False):
    """Phase 20: the postprocessing path on the card (see the docstring): (a)
    SwinIR, HAT, DAT and SCUNet through the registry, (b) CodeFormer and
    GFPGAN, (c) an SDXL request with restore_faces beside its witness, (d)
    with `full` the hires fix through SwinIR beside ESRGAN, (e) the extras
    routes. 512² into the upscalers with `full`, else 256²."""
    import base64
    import threading

    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.core import synth
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill
    from forge_tpu_torch.models.codeformer import codeformer_apply
    from forge_tpu_torch.pipeline import images as images_mod
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline import upscalers as upscalers_mod
    from forge_tpu_torch.postprocessing import faces
    from forge_tpu_torch.postprocessing.gfpgan import GFPGAN, gfpgan_apply
    from forge_tpu_torch.runtime.models import ModelManager

    t_phase = time.perf_counter()
    per_label, total = extras_counts(steps), {}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), EXTRAS_DIR)
    dirs = {kind: os.path.join(work, kind) for kind, _, _ in EXTRAS_UPSCALERS.values()}
    rng = np.random.default_rng(20)

    def peak_gib(base: int) -> float:
        """The peak since the last reset, above `base` bytes (what was resident)."""
        return (torch.cuda.max_memory_allocated() - base) / 2**30

    def measured(label, fn):
        """fn() with its launches read and held to `label`'s count → (what it
        returned, its seconds, its peak GiB above what was resident)."""
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = read_counts()
        add_counts(total, launches)
        check_counts(launches, per_label[label], 1, f"extras {label}")
        return out, seconds, peak_gib(base)

    def write(name, kind, sd):
        os.makedirs(os.path.join(work, kind), exist_ok=True)
        path = os.path.join(work, kind, name + ".safetensors")
        save_safetensors(sd, path)
        return path

    # (a) the four upscalers from their files, bf16 against the same code at f32
    side = 512 if full else 256
    img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    archs = {}
    for i, (name, (kind, fn, _)) in enumerate(EXTRAS_UPSCALERS.items()):
        sd = getattr(synth, fn)(fill=DeviceFill("cuda", seed=20 + i))
        timed(f"extras (a) {name}: {sum(v.size for v in sd.values()) / 1e6:.2f} M values made "
              f"on the card and written", lambda: write(name, kind, sd))
        archs[name] = upscalers_mod.sniff_architecture(sd)
        del sd
    reg16 = upscalers_mod.UpscalerRegistry(model_dirs=dirs, device="cuda")
    reg32 = upscalers_mod.UpscalerRegistry(model_dirs=dirs, device="cuda", dtype=torch.float32)

    def upscalers():
        for name, (kind, fn, scale) in EXTRAS_UPSCALERS.items():
            arch = archs[name]
            apply_fn, model_scale = reg16._load_model(os.path.join(dirs[kind], name + ".safetensors"))
            check(model_scale == scale, f"extras {name}: {arch} at ×{scale}")
            tile = torch.from_numpy(img[:64, :64].astype(np.float32)[None].transpose(0, 3, 1, 2) / 255)
            check(bool(torch.isfinite(apply_fn(tile)).all()), f"extras {name}: finite output")
            up = reg16.get(name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = up.upscale(img, float(scale))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            peak = peak_gib(base)
            again = up.upscale(img, float(scale))
            ref = reg32.get(name).upscale(img, float(scale))
            value = image_psnr(out, ref)
            tiles, overlap = upscalers_mod.tile_options(kind)
            log(f"extras (a) {name} ({arch}, models/{kind}, tiles {tiles}/{overlap}): {side}² → "
                f"{out.shape[1]}×{out.shape[0]} in {seconds:.4f} s (bf16), peak +{peak:.2f} GiB; "
                f"bf16 vs f32 {value:.2f} dB (bar {EXTRAS_UPSCALE_BAR}); mean {out.mean():.3f} "
                f"std {out.std():.3f}")
            check(out.shape == (side * scale, side * scale, 3) and out.dtype == np.uint8,
                  f"extras {name}: uint8 at ×{scale}")
            check(np.array_equal(out, again), f"extras {name}: a rerun byte-identical")
            check(value >= EXTRAS_UPSCALE_BAR, f"extras {name}: bf16 vs f32 ≥ {EXTRAS_UPSCALE_BAR} dB")

    measured("upscalers", upscalers)
    del reg32
    torch.cuda.empty_cache()

    # (b) CodeFormer and GFPGAN on a 1024² image (the full-frame box: 1024 → 512 → 1024)
    face_img = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    for name, kind, fn in (("codeformer-v0.1.0", "Codeformer", "synth_codeformer_sd"),
                           ("GFPGANv1.4", "GFPGAN", "synth_gfpgan_sd")):
        sd = getattr(synth, fn)(fill=DeviceFill("cuda", seed=30))
        timed(f"extras (b) {name}: {sum(v.size for v in sd.values()) / 1e6:.2f} M values made on "
              f"the card and written", lambda: write(name, kind, sd))
        del sd
    restorers = {"CodeFormer": (faces.FaceRestorer(os.path.join(work, "Codeformer"), device="cuda"),
                                faces.FaceRestorer(os.path.join(work, "Codeformer"), device="cuda",
                                                   dtype=torch.float32)),
                 "GFPGAN": (GFPGAN(os.path.join(work, "GFPGAN"), device="cuda"),
                            GFPGAN(os.path.join(work, "GFPGAN"), device="cuda",
                                   dtype=torch.float32))}

    def restore_all():
        for name, (r16, r32) in restorers.items():
            r16.load()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = r16.restore(face_img, 0.5)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            peak = peak_gib(base)
            again, ref = r16.restore(face_img, 0.5), r32.restore(face_img, 0.5)
            value = image_psnr(out, ref)
            crop = images_mod.cv2_linear_resize(face_img, 512, 512)
            extra = ""
            if name == "CodeFormer":
                codes16, codes32 = [], []
                r16.restore_crop(crop, 0.5, codes16)
                r32.restore_crop(crop, 0.5, codes32)
                share = float((codes16[0] == codes32[0]).float().mean())
                low = []
                faces.FaceRestorer(os.path.join(work, "Codeformer"), device="cuda",
                                   code_dtype=torch.bfloat16).restore_crop(crop, 0.5, low)
                share16 = float((low[0] == codes32[0]).float().mean())
                extra = f"; codes equal to f32's {100 * share:.2f} % of {codes16[0].numel()}"
                log(f"extras (b) CodeFormer codes equal to the all-f32 run's: {share16:.4f} with "
                    f"the encoder and transformer in bf16, {share:.4f} with them in f32 (the "
                    f"restorer's default; the rule: f32 below {EXTRAS_CODE_AGREEMENT})")
                params = r16.load()
                leaf = params["quantize"]["embedding"]["weight"]
                x = torch.from_numpy(crop.astype(np.float32)).permute(2, 0, 1)[None] / 127.5 - 1
                with torch.no_grad():
                    y = codeformer_apply(params, x.to(leaf.device, leaf.dtype))
            else:
                params = r16.load()
                leaf = params["conv_body_first"]["weight"]
                x = torch.from_numpy(crop.astype(np.float32)).permute(2, 0, 1)[None] / 127.5 - 1
                with torch.no_grad():
                    y = gfpgan_apply(params, x.to(leaf.device, leaf.dtype))
            log(f"extras (b) {name}: 1024² in {seconds:.4f} s (bf16), peak +{peak:.2f} GiB; "
                f"bf16 vs f32 {value:.2f} dB (bar {EXTRAS_RESTORE_BAR}){extra}; changed "
                f"{np.abs(out.astype(np.int16) - face_img).mean():.2f} levels on average")
            check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (1, 3, 512, 512),
                  f"extras {name}: a finite 512² face")
            check(out.shape == face_img.shape and out.dtype == np.uint8, f"extras {name}: uint8")
            check(np.array_equal(out, again), f"extras {name}: a rerun byte-identical")
            check(value >= EXTRAS_RESTORE_BAR, f"extras {name}: bf16 vs f32 ≥ {EXTRAS_RESTORE_BAR} dB")

    measured("restorers", restore_all)
    cf16 = restorers["CodeFormer"][0]
    del restorers
    torch.cuda.empty_cache()

    # (c) an SDXL txt2img with restore_faces (CodeFormer) beside its witness
    fields = dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps, cfg_scale=7.0,
                  width=1024, height=1024, sampler_name="DPM++ 2M", scheduler="karras")
    saved_restorer, faces._restorer = faces._restorer, cf16
    if full:  # under --extras the engine's first request pays the first text encode
        timed("extras (c): a warm request (not counted)", lambda: proc.process_images(
            engine, proc.Processing(**dict(fields, seed=2))))
    try:
        witness, w_secs, w_peak = measured("restore witness", lambda: proc.process_images(
            engine, proc.Processing(**fields)))
        res, r_secs, r_peak = measured("restore_faces", lambda: proc.process_images(
            engine, proc.Processing(**fields, restore_faces=True)))
    finally:
        faces._restorer = saved_restorer
    want = cf16.restore(witness.images[0])
    log(f"extras (c) restore_faces: latency {r_secs:.4f} s, {r_secs / w_secs:.3f}x the witness's "
        f"{w_secs:.4f} s, peak +{r_peak:.2f} GiB (witness +{w_peak:.2f}); infotext: "
        + json.dumps(res.infotexts[0]))
    check(np.array_equal(res.images[0], want),
          "extras (c): the image = FaceRestorer.restore(the witness's image), byte for byte")
    check("Face restoration: CodeFormer" in res.infotexts[0]
          and "Face restoration" not in witness.infotexts[0], "extras (c): the infotext")
    cond = engine.get_learned_conditioning([EXT_PROMPT, "blurry"], 1024, 1024)
    x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
    ts = torch.tensor([999.0, 400.0], device="cuda")
    kernels_vs_plain("extras sdxl unet 128x128 B=2", lambda: engine.unet_apply_fn()(
        engine.loaded.unet, x, ts, cond["context"], y=cond["y"]))
    del x, witness, res

    # (d) config 2 (c)'s hires pass through SwinIR-M in place of ESRGAN (--extras only)
    if full:
        esrgan_dir = os.path.join(work, "ESRGAN")
        write("esrgan_x4_synth", "ESRGAN", synth.synth_esrgan_sd(fill="random", seed=3))
        hires = dict(enable_hr=True, hr_scale=2.0, hr_denoising_strength=CONFIG2_HR_STRENGTH,
                     hr_second_pass_steps=0)
        engine.upscalers = upscalers_mod.UpscalerRegistry(
            model_dirs={"ESRGAN": esrgan_dir, "SwinIR": dirs["SwinIR"]}, device="cuda")
        try:
            _, e_secs, e_peak = measured("hires ESRGAN", lambda: config2_request(
                engine, 1, "extras (d) hires pixel (ESRGAN ×4)",
                **dict(hires, hr_upscaler="esrgan_x4_synth")))
            _, s_secs, s_peak = measured("hires SwinIR", lambda: config2_request(
                engine, 1, "extras (d) hires pixel (SwinIR-M ×4)",
                **dict(hires, hr_upscaler="003_realSR_SwinIR-M_x4")))
        finally:
            engine.upscalers = None
        log(f"extras (d) hires to 2048²: SwinIR-M {s_secs:.4f} s (peak +{s_peak:.2f} GiB) beside "
            f"config 2 (c)'s ESRGAN {e_secs:.4f} s (peak +{e_peak:.2f} GiB)")

    # (e) the extras routes, their PNGs against the library calls
    saved_registry, upscalers_mod._DEFAULT_REGISTRY = upscalers_mod._DEFAULT_REGISTRY, reg16
    saved_restorer, faces._restorer = faces._restorer, cf16
    manager = ModelManager(checkpoint_dirs=[], device=engine.device)
    server = create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    swin = "003_realSR_SwinIR-M_x4"
    api_imgs = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(2)]

    def b64(im):
        return base64.b64encode(images_mod.encode_png(im)).decode()

    def pixels(answer):
        return [images_mod.decode_png(base64.b64decode(a))[0]
                for a in ([answer["image"]] if "image" in answer else answer["images"])]

    def api():
        single = pixels(http(base, "/sdapi/v1/extra-single-image", dict(
            image=b64(api_imgs[0]), upscaler_1=swin, upscaling_resize=2,
            codeformer_visibility=1.0)))
        batch = pixels(http(base, "/sdapi/v1/extra-batch-images", dict(
            imageList=[{"data": b64(im), "name": f"{i}.png"} for i, im in enumerate(api_imgs)],
            resize_mode=1, upscaling_resize_w=1000, upscaling_resize_h=700, upscaling_crop=True,
            upscaler_1=swin)))
        return single, batch

    try:
        (single, batch), a_secs, a_peak = measured("API", api)
    finally:
        server.shutdown()
        server.server_close()
        manager.close()
        upscalers_mod._DEFAULT_REGISTRY, faces._restorer = saved_registry, saved_restorer
    want_single = reg16.get(swin).upscale(cf16.restore(api_imgs[0], 0.5), 2.0)
    want_batch = []
    for im in api_imgs:
        up = reg16.get(swin).upscale(im, max(1000 / 256, 700 / 256))
        top, left = max(0, (up.shape[0] - 700) // 2), max(0, (up.shape[1] - 1000) // 2)
        want_batch.append(up[top:top + 700, left:left + 1000])
    log(f"extras (e) the API: /extra-single-image (SwinIR-M ×2 after CodeFormer at visibility 1) "
        f"{single[0].shape[1]}×{single[0].shape[0]}, /extra-batch-images (two, resize mode 1 to "
        f"1000×700, crop) in {a_secs:.4f} s together, peak +{a_peak:.2f} GiB")
    check(len(single) == 1 and np.array_equal(single[0], want_single),
          "extras (e): /extra-single-image's PNG = the restorer and the registry's result")
    check(len(batch) == 2 and all(np.array_equal(g, w) for g, w in zip(batch, want_batch)),
          "extras (e): /extra-batch-images' PNGs = the registry's results, centre-cropped")
    del reg16, cf16
    torch.cuda.empty_cache()
    log(f"extras phase 20 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def safetensors_tensor(path: str, key: str):
    """One tensor of a .safetensors file, read alone → (the numpy array, the
    file's sorted keys)."""
    import struct

    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        info = header[key]
        begin, end = info["data_offsets"]
        f.seek(8 + n + begin)
        raw = f.read(end - begin)
    dtype = {"F16": np.float16, "F32": np.float32}[info["dtype"]]
    keys = sorted(k for k in header if k != "__metadata__")
    return np.frombuffer(raw, dtype).reshape(info["shape"]), keys


def phase_surface(engine, gen: torch.Generator, steps: int = SURFACE_STEPS, full: bool = False):
    """Phase 21: the rest of the API surface on the card (see the docstring):
    (a) ControlNetScript against the always-on dispatch, (b) saving, (c) the
    routes. `full`: the merged checkpoints at SDXL's depths."""
    import base64
    import glob
    import shutil
    import tempfile
    import threading
    import urllib.request

    from forge_tpu_torch.api.server import CMD_FLAGS, _apply_alwayson_scripts, create_server
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd, synth_sdxl_checkpoint
    from forge_tpu_torch.extensions.controlnet import ControlNetScript, list_controlnet_models
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline import images as images_mod
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.preprocessors import preprocessor_names
    from forge_tpu_torch.runtime import logging as event_log
    from forge_tpu_torch.runtime import scripts as scripts_mod
    from forge_tpu_torch.runtime.models import ModelManager
    from forge_tpu_torch.runtime.options import opts

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), SURFACE_DIR)
    shutil.rmtree(work, ignore_errors=True)
    fields = dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps, cfg_scale=7.0,
                  width=1024, height=1024, sampler_name="DPM++ 2M", scheduler="karras")
    merged_blocks = 70 if full else 11
    per_label, total = surface_counts(steps, merged_blocks), {}

    def measured(label, fn):
        """fn() with its launches read and held to `label`'s count → (its
        result, its seconds)."""
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = read_counts()
        add_counts(total, launches)
        check_counts(launches, per_label[label], 1, f"surface {label}")
        return out, seconds

    def image_ok(res, label):
        img = res.images[0]
        check(len(res.images) == 1 and img.shape == (1024, 1024, 3) and img.dtype == np.uint8
              and img.std() > 0, f"surface {label}: one 1024²×3 uint8 image, not flat")
        return img

    # (a) a canny unit through ControlNetScript and through the always-on dispatch
    cldm, _ = timed("surface (a): a full-width SDXL ControlNet made on the card",
                    lambda: synth_controlnet_sd(fill=DeviceFill("cuda", seed=21)))
    source = np.random.default_rng(21).integers(0, 256, (1024, 1024, 3), dtype=np.uint8)
    unit = {"module": "canny", "model": cldm, "image": source, "weight": 1.0,
            "guidance_start": 0.0, "guidance_end": 1.0}
    witness, w_secs = measured("witness", lambda: proc.process_images(
        engine, proc.Processing(**fields)))
    runner = scripts_mod.ScriptRunner()
    runner.register(ControlNetScript(device=engine.device, dtype=engine.compute_dtype))
    p_script = proc.Processing(**fields, scripts=runner)
    p_script.controlnet_units = [unit]
    by_script, s_secs = measured("ControlNetScript", lambda: proc.process_images(engine, p_script))

    def alwayson():
        p = proc.Processing(**fields)
        _apply_alwayson_scripts(p, {"controlnet": {"args": [unit]}}, engine.device,
                                engine.compute_dtype)
        return proc.process_images(engine, p)

    by_api, a_secs = measured("alwayson", alwayson)
    img = image_ok(by_script, "(a) ControlNetScript")
    check(np.array_equal(img, image_ok(by_api, "(a) always-on")),
          "surface (a): ControlNetScript's image = the always-on dispatch's, byte for byte")
    check(not np.array_equal(img, image_ok(witness, "(a) witness")),
          "surface (a): the ControlNet moved the image")
    check(len(p_script.controlnets or []) == 1, "surface (a): the script attached one state")
    log(f"surface (a) ControlNetScript {s_secs:.4f} s, always-on {a_secs:.4f} s, witness "
        f"{w_secs:.4f} s ({s_secs / w_secs:.3f}x); PSNR vs the witness {image_psnr(img, witness.images[0]):.2f} dB")
    cond = engine.get_learned_conditioning([EXT_PROMPT, "blurry"], 1024, 1024)
    x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
    ts = torch.tensor([999.0, 400.0], device="cuda")
    apply = engine.unet_apply_fn(controlnets=p_script.controlnets)
    with torch.no_grad():
        fused = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"], t_host=999.0)
        with plain_versions():
            plain = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"], t_host=999.0)
    value = psnr(fused, plain)
    log(f"surface (a) sdxl unet + controlnet 128x128 B=2 bf16: kernels vs plain PSNR {value:.2f} dB "
        f"(bound {PSNR_BOUND})")
    check(value >= PSNR_BOUND, f"surface (a): UNet + ControlNet PSNR ≥ {PSNR_BOUND} dB")
    del x, fused, plain, p_script, by_script, cond

    # (b) the same request with saving on, into a temporary directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_saving_")
    events = []
    saved_log = event_log._PATH
    event_log.configure(os.path.join(tmp, "events.jsonl"))
    for name in ("before_image_saved", "image_saved"):
        scripts_mod.on(name, lambda path, image, text, _n=name: events.append((_n, path, text)))
    save_seconds = []
    save_image = proc.save_image

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        out = save_image(*args, **kwargs)
        save_seconds.append(time.perf_counter() - t)
        return out

    proc.save_image = timed_save
    cwd = os.getcwd()
    os.chdir(tmp)  # params.txt is written in the working directory
    try:
        with opts.override({"samples_save": True, "save_write_params_txt": True,
                            "outdir_txt2img_samples": os.path.join(tmp, "txt2img-images")}):
            saved_res, b_secs = measured("saving", alwayson)
    finally:
        os.chdir(cwd)
        proc.save_image = save_image
        for name in ("before_image_saved", "image_saved"):
            scripts_mod.clear(name)
        event_log.configure(saved_log)
    files = sorted(glob.glob(os.path.join(tmp, "txt2img-images", "**", "*.png"), recursive=True))
    text = saved_res.infotexts[0]
    check(len(files) == 1, f"surface (b): one PNG written ({len(files)})")
    with open(files[0], "rb") as f:
        pixels, chunks = images_mod.decode_png(f.read())
    check(np.array_equal(pixels, saved_res.images[0]), "surface (b): the file's pixels = the image")
    check(chunks.get("parameters") == text, "surface (b): the file's parameters = the infotext")
    check(np.array_equal(saved_res.images[0], img), "surface (b): the image = (a)'s, byte for byte")
    check([e[0] for e in events] == ["before_image_saved", "image_saved"]
          and all(e[1] == files[0] and e[2] == text for e in events),
          "surface (b): before_image_saved and image_saved fired once each with the file")
    import csv

    with open(os.path.join(os.path.dirname(files[0]), "log.csv"), encoding="utf8",
              newline="") as f:
        rows = list(csv.reader(f))
    check(len(rows) == 2 and rows[1][0] == os.path.basename(files[0])
          and rows[1][3] == text.replace("\n", " | "),
          "surface (b): log.csv holds its header and one row")
    with open(os.path.join(tmp, "events.jsonl"), encoding="utf8") as f:
        lines = [json.loads(line) for line in f]
    check([e["event"] for e in lines] == ["generation"] and lines[0]["steps"] == steps,
          "surface (b): one generation line in the event log")
    with open(os.path.join(tmp, "params.txt"), encoding="utf8") as f:
        check(f.read() == text, "surface (b): params.txt holds the infotext")
    log(f"surface (b) saving: {b_secs:.4f} s against the always-on request's {a_secs:.4f} s; "
        f"save_image {save_seconds[0]:.4f} s ({os.path.getsize(files[0]) / 2**20:.2f} MiB PNG); "
        f"the generation line: " + json.dumps({k: v for k, v in lines[0].items()
                                                if not k.startswith("t_")}))
    shutil.rmtree(tmp, ignore_errors=True)
    del cldm, unit, saved_res, by_api
    torch.cuda.empty_cache()

    # (c) the routes through the port's server on port 0
    ckpt_dir = os.path.join(work, "Stable-diffusion")
    os.makedirs(ckpt_dir, exist_ok=True)
    depth = {} if full else SURFACE_CUT
    for name, seed in (("sdxl-a", 5), ("sdxl-b", 6)):
        def write(_seed=seed, _name=name):
            sd = synth_sdxl_checkpoint(fill=DeviceFill("cuda", seed=_seed), **depth)
            save_safetensors({k: v.to(torch.float16) for k, v in sd.items()},
                             os.path.join(ckpt_dir, _name + ".safetensors"))
            return sum(v.size for v in sd.values())

        n, _ = timed(f"surface (c) {name}: a synth SDXL checkpoint "
                     f"({'SDXL depths' if full else 'depths cut'}) made on the card and written "
                     "in fp16", write)
    log(f"surface (c): each checkpoint {n / 1e9:.3f} B values, "
        f"{os.path.getsize(os.path.join(ckpt_dir, 'sdxl-a.safetensors')) / 2**30:.3f} GiB")
    manager = ModelManager(checkpoint_dirs=[ckpt_dir], device=engine.device)
    manager.set_engine(engine)
    server = create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    api_dir = tempfile.mkdtemp(prefix="chip_smoke_api_")
    checkpoint_option = opts.get("sd_model_checkpoint")
    emb_dir = os.path.join(work, "embeddings")
    CMD_FLAGS["embeddings_dir"] = emb_dir  # as webui.py --embeddings-dir sets it
    try:
        check(http(base, "/controlnet/version") == {"version": 2}, "surface (c): /controlnet/version")
        check(http(base, "/controlnet/module_list") == {"module_list": preprocessor_names()},
              "surface (c): /controlnet/module_list = preprocessor_names()")
        check(http(base, "/controlnet/model_list") == {"model_list": list_controlnet_models()},
              "surface (c): /controlnet/model_list = list_controlnet_models()")
        info = http(base, "/sdapi/v1/create/embedding", dict(
            name=SURFACE_EMBEDDING, num_vectors_per_token=2, init_text="astronaut",
            out_dir=emb_dir))["info"]
        emb_path = os.path.join(emb_dir, SURFACE_EMBEDDING + ".safetensors")
        check(info.endswith(emb_path) and os.path.exists(emb_path),
              "surface (c): /create/embedding wrote its file")
        engine.embedding_db.load_dir(emb_dir)
        prompt = f"a photograph of {SURFACE_EMBEDDING} riding a horse"
        ids = list(engine.text_engines["clip_l"].tokenizer.ids(prompt))
        check(any(engine.embedding_db.match(ids, i) for i in range(len(ids))),
              "surface (c): the prompt's tokens meet the embedding")

        def txt2img(**extra):
            answer = http(base, "/sdapi/v1/txt2img", dict(fields, **extra))
            return images_mod.decode_png(base64.b64decode(answer["images"][0]))[0], answer

        (emb_img, _), e_secs = measured("embedding", lambda: txt2img(prompt=prompt))
        log(f"surface (c) txt2img with the embedding: {e_secs:.4f} s")
        (merged, m_secs) = timed("surface (c) /merge-checkpoints (weighted sum at 0.3, host "
                                 "numpy, fp16 out)", lambda: http(
                                     base, "/sdapi/v1/merge-checkpoints",
                                     dict(primary="sdxl-a.safetensors",
                                          secondary="sdxl-b.safetensors",
                                          multiplier=SURFACE_MERGE, custom_name="merged")))
        check(os.path.exists(merged["path"]) and "merged.safetensors" in manager.checkpoints,
              "surface (c): the merged file written and listed")
        key = "model.diffusion_model.input_blocks.0.0.weight"
        (a, a_keys), (b, _), (m, m_keys) = (
            safetensors_tensor(os.path.join(ckpt_dir, f"{n}.safetensors"), key)
            for n in ("sdxl-a", "sdxl-b", "merged"))
        want = (a.astype(np.float32) * (1 - SURFACE_MERGE)
                + b.astype(np.float32) * SURFACE_MERGE).astype(np.float16)
        check(np.array_equal(m, want) and m_keys == a_keys,
              "surface (c): a merged tensor = fp16(a·0.7 + b·0.3), every key kept")
        blocks = sum(1 for k in m_keys if k.startswith("model.diffusion_model.")
                     and k.endswith(".attn1.to_q.weight"))
        check(blocks == merged_blocks, f"surface (c): the merged UNet has {merged_blocks} "
                                       f"transformer blocks ({blocks})")
        _, l_secs = timed("surface (c) the merged checkpoint loaded through /sdapi/v1/options",
                          lambda: http(base, "/sdapi/v1/options",
                                       {"sd_model_checkpoint": "merged.safetensors"}))
        check(manager.engine is not engine, "surface (c): the merged engine serves")
        (m_img, answer), r_secs = measured("merged", lambda: txt2img(
            save_images=True, override_settings={"samples_save": True,
                                                 "outdir_txt2img_samples": api_dir}))
        written = glob.glob(os.path.join(api_dir, "**", "*.png"), recursive=True)
        check(len(written) == 1, "surface (c): txt2img with save_images wrote one PNG")
        with open(written[0], "rb") as f:
            check(np.array_equal(images_mod.decode_png(f.read())[0], m_img),
                  "surface (c): the written PNG = the answered image")
        check(m_img.std() > 0 and not np.array_equal(m_img, emb_img),
              "surface (c): the merged engine's image")
        log(f"surface (c) the merged engine: load {l_secs:.4f} s, txt2img with save_images "
            f"{r_secs:.4f} s; merge {m_secs:.4f} s")
        req = urllib.request.Request(base + "/")
        with urllib.request.urlopen(req, timeout=60) as r:
            page = r.read()
            check(r.status == 200 and r.headers["Content-Type"].startswith("text/html")
                  and page.startswith(b"<!doctype html>"), "surface (c): GET / serves the web UI")
    finally:
        server.shutdown()
        server.server_close()
        manager.unload()
        manager.close()
        opts.set("sd_model_checkpoint", checkpoint_option)
        CMD_FLAGS.pop("embeddings_dir", None)
        shutil.rmtree(api_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"surface phase 21 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def write_annotator_files(work: str):
    """Every network of phase 22 at its published widths, made on the card from a seed and
    written under `work` in its upstream key space; the `.pth` names through torch.save, as
    their detectors read exactly those names → the bytes written."""
    from forge_tpu_torch.core import synth_annotators
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor

    total = 0
    for seed, (_, files) in enumerate(ANNOTATORS.values()):
        for fn, rel in files:
            path = os.path.join(work, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if os.path.exists(path):  # lineart's two generators share a function, not a file
                continue
            kw = {"n_residual": 3} if rel.endswith("sk_model2.pth") else {}
            sd = getattr(synth_annotators, fn)(fill=DeviceFill("cuda", seed=220 + seed), **kw)
            if rel.endswith(".pth"):
                torch.save({k: (v.materialize() if isinstance(v, LazyTensor) else
                                torch.as_tensor(v)).cpu() for k, v in sd.items()}, path)
            else:
                save_safetensors(sd, path)
            total += os.path.getsize(path)
    return total


def install_annotators(work: str, dtype=None, device="cuda"):
    """Detectors reading `work` in each annotator module's global, in `dtype`
    (each annotator's own where None) → the modules."""
    import importlib

    mods = {}
    for entry, (mod, files) in ANNOTATORS.items():
        m = importlib.import_module(f"forge_tpu_torch.preprocessors.{mod}")
        mods[mod] = m
        sub = os.path.join(work, os.path.dirname(files[0][1]))
        if mod == "lineart":
            kind = {"lineart_realistic": "realistic", "lineart_coarse": "coarse",
                    "lineart_anime": "anime"}[entry]
            m._DETECTORS[kind] = (m.LineartAnimeDetector(model_dir=sub, device=device, dtype=dtype)
                                  if kind == "anime" else
                                  m.LineartDetector(coarse=kind == "coarse", model_dir=sub,
                                                    device=device, dtype=dtype))
            continue
        cls = {"depth": "MidasDetector", "depth_anything": "DepthAnythingDetector",
               "openpose": "OpenposeDetector", "hed": "HedDetector", "pidinet": "PidiDetector",
               "teed": "TeedDetector", "manga_line": "MangaLineDetector", "mlsd": "MlsdDetector",
               "normalbae": "NormalBaeDetector"}[mod]
        m._DETECTOR = getattr(m, cls)(model_dir=sub, device=device, dtype=dtype)
    return mods


def map_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two maps in [0, 1] (inf where equal)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def phase_annotators(engine, gen: torch.Generator, steps: int = ANNOTATORS_STEPS,
                     full: bool = False):
    """Phase 22: the ControlNet annotators on the card (see the constants above):
    (a) each at its published widths through the registry, (b) Depth Anything V2's
    flash path against plain, (c) an SDXL request with a depth_anything_v2 unit.
    `full`: every annotator in bf16 against f32 too."""
    import shutil

    from forge_tpu_torch import preprocessors as registry
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd
    from forge_tpu_torch.extensions.controlnet import ControlNetScript
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.preprocessors.cv import bilinear_resize
    from forge_tpu_torch.runtime import profiling
    from forge_tpu_torch.runtime import scripts as scripts_mod

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), ANNOTATORS_DIR)
    shutil.rmtree(work, ignore_errors=True)
    saved, total = {}, {}
    try:
        nbytes, _ = timed("annotators: the networks made on the card and written",
                          lambda: write_annotator_files(work))
        log(f"annotators: {nbytes / 2**30:.3f} GiB of f32 files under {ANNOTATORS_DIR}")
        import importlib

        for mod in {m for m, _ in ANNOTATORS.values()}:
            m = importlib.import_module(f"forge_tpu_torch.preprocessors.{mod}")
            saved[m] = {k: getattr(m, k) for k in ("_DETECTOR", "_DETECTORS") if hasattr(m, k)}
            if hasattr(m, "_DETECTORS"):
                saved[m]["_DETECTORS"] = dict(m._DETECTORS)
        source = np.random.default_rng(22).integers(0, 256, (512, 512, 3), dtype=np.uint8)
        source = np.asarray(bilinear_resize(bilinear_resize(source, 64, 64), 512, 512), np.uint8)

        # (a) every annotator: f32 maps first, bf16 beside them (under --annotators), then each
        # in its own dtype: loaded, timed on a rerun under the trace and the memory monitor
        install_annotators(work, dtype=torch.float32)
        args = {name: ANNOTATOR_ARGS.get(name, (0, 0)) for name in ANNOTATORS}
        f32_maps = {name: registry.PREPROCESSORS[name](source, 512, *args[name])
                    for name in ANNOTATORS}
        bf16_db = {}
        if full:
            install_annotators(work, dtype=torch.bfloat16)
            bf16_db = {name: map_psnr(registry.PREPROCESSORS[name](source, 512, *args[name]),
                                      f32_maps[name]) for name in ANNOTATORS}
        mods = install_annotators(work)
        for name, (mod, _) in ANNOTATORS.items():
            entry = registry.PREPROCESSORS[name]
            check(entry.ported, f"annotators (a): {name} is ported")
            first = entry(source, 512, *args[name])  # loads the weights
            mon = profiling.MemoryMonitor(device="cuda")
            mon.start()
            torch.cuda.synchronize()
            t = time.perf_counter()
            again = entry(source, 512, *args[name])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            peak = mon.stop()["peak"]
            # the busy share from a third detect with only the card traced
            with profiling.trace(os.path.join(work, "traces"), name=name) as tr:
                third = entry(source, 512, *args[name])
            det = (mods[mod]._DETECTORS[name.split("_")[-1]] if mod == "lineart"
                   else mods[mod]._DETECTOR)
            dtype = (det.body if mod == "openpose" else det).placement()[1]
            db = map_psnr(again, f32_maps[name])
            levels = again * 255.0
            check(again.shape == (512, 512, 3) and again.dtype == np.float32
                  and np.isfinite(again).all() and again.min() >= 0 and again.max() <= 1
                  and np.array_equal(levels, np.rint(levels)),
                  f"annotators (a): {name}'s map is 512²×3, finite, uint8 levels in [0, 1]")
            check(np.array_equal(first, again) and np.array_equal(first, third),
                  f"annotators (a): {name} reruns byte-identical")
            check(db >= ANNOTATOR_BAR, f"annotators (a): {name} in {dtype} against f32 ≥ "
                                       f"{ANNOTATOR_BAR} dB ({db:.2f})")
            log(f"annotators (a) {name:22s} dtype {str(dtype)[6:]:8s} {secs:.4f} s, peak "
                f"{(peak - mon.baseline) / 2**20:.1f} MiB above the {mon.baseline / 2**30:.2f} GiB "
                f"held (the card's used memory at most {mon.used_peak / 2**30:.2f} GiB); traced "
                f"card only: {tr.wall_s:.4f} s, busy {100 * tr.busy:.2f} % ({tr.device_events} "
                f"device events, {tr.device_s * 1e3:.3f} ms); vs f32 {db:.2f} dB"
                + (f", bf16 vs f32 {bf16_db[name]:.2f} dB" if full else "")
                + f"; map mean {again.mean():.4f} std {again.std():.4f}")
            check(again.std() > 0, f"annotators (a): {name}'s map is not flat")
        for name in ANNOTATOR_VARIANTS:
            a, secs = timed(f"annotators (a) {name}",
                            lambda _n=name: registry.PREPROCESSORS[_n](source, 512, 0, 0))
            check(a.shape == (512, 512, 3) and np.isfinite(a).all() and a.min() >= 0
                  and a.max() <= 1, f"annotators (a): {name}'s map finite, in range")
        # the hand and face nets on boxes from given keypoints (the random body net's people
        # may hold no arm or face)
        op = mods["openpose"]._DETECTOR
        kps = [None] * 18
        kps[0], kps[14], kps[15], kps[16], kps[17] = (256.0, 120.0), (240.0, 104.0), \
            (272.0, 104.0), (224.0, 112.0), (288.0, 112.0)
        kps[2], kps[3], kps[4] = (200.0, 220.0), (170.0, 310.0), (150.0, 390.0)
        kps[5], kps[6], kps[7] = (312.0, 220.0), (342.0, 310.0), (362.0, 390.0)
        canvas = np.zeros_like(source)
        _, hs = timed("annotators (a) openpose hands on two given boxes",
                      lambda: op._detect_hands(source, kps, canvas))
        _, fs = timed("annotators (a) openpose face on a given box",
                      lambda: op._detect_face(source, kps, canvas))
        check(canvas.any(), "annotators (a): the hand and face nets drew")

        # (b) Depth Anything V2 with the flash kernel against plain flash
        da = mods["depth_anything"]._DETECTOR
        zero_counts()
        depth = da.predict(source)
        torch.cuda.synchronize()
        launches = read_counts()
        add_counts(total, launches)
        with plain_versions():
            plain = da.predict(source)
        value = psnr(depth, plain)
        log(f"annotators (b) depth_anything_v2 {str(da.placement()[1])[6:]}: flash launches "
            f"{launches['flash_attention']} (wgmma {launches['flash_attention[wgmma]']}, simt "
            f"{launches['flash_attention[simt]']}); depth {tuple(depth.shape)} kernels vs plain "
            f"PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(launches["flash_attention"] == ANNOTATOR_FLASH,
              f"annotators (b): exactly {ANNOTATOR_FLASH} flash launches a detect")
        check(value >= PSNR_BOUND, f"annotators (b): depth kernels vs plain ≥ {PSNR_BOUND} dB")
        # the masked tail: every true score is −32 (q = 2, k = −2, d 64, scale 1/8) and v is 1,
        # so the exact output is 1; a key past 1370 left unmasked would score 0 and take nearly
        # all the weight (e^32 each), pulling the output toward the padding's value. The wgmma
        # body (bf16, the detector's) tiles keys by 128 (38 padded keys in the last), the SIMT
        # body (f32 and bf16) by 16·TN
        for dtype, body, bound in ((torch.bfloat16, "wgmma", 2e-3), (torch.bfloat16, "simt", 2e-3),
                                   (torch.float32, "simt", 1e-4)):
            q = torch.full((1, 16, 1370, 64), 2.0, device="cuda", dtype=dtype)
            k = torch.full_like(q, -2.0)
            v = torch.ones_like(q)
            got = flash_attention(q, k, v, body=body).float()
            err = (got - flash_attention_plain(q, k, v).float()).abs().max().item()
            exact = (got - 1.0).abs().max().item()
            log(f"annotators (b) flash {body} {str(dtype)[6:]} q(1,16,1370,64), every score −32, v = 1: "
                f"max abs err vs plain {err:.3e}, vs the exact 1 {exact:.3e} (bound {bound:g}; "
                f"an unmasked tail key would leave under 1e-12 of the weight on the true keys)")
            check(max(err, exact) < bound,
                  f"annotators (b): flash's masked tail, {body} body at {dtype}")
        del depth, plain

        # (c) an SDXL request with a depth_anything_v2 unit through ControlNetScript
        cldm, _ = timed("annotators (c): a full-width SDXL ControlNet made on the card",
                        lambda: synth_controlnet_sd(fill=DeviceFill("cuda", seed=22)))
        image = np.asarray(bilinear_resize(source, 1024, 1024), np.uint8)
        unit = {"module": "depth_anything_v2", "model": cldm, "image": image, "weight": 1.0,
                "processor_res": 512}
        fields = dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps,
                      cfg_scale=7.0, width=1024, height=1024, sampler_name="DPM++ 2M",
                      scheduler="karras")
        per_label = annotators_counts(steps)

        def measured(label, fn):
            zero_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches = read_counts()
            add_counts(total, launches)
            check_counts(launches, per_label[label], 1, f"annotators {label}")
            return out, secs

        witness, w_secs = measured("witness", lambda: proc.process_images(
            engine, proc.Processing(**fields)))
        runner = scripts_mod.ScriptRunner()
        runner.register(ControlNetScript(device=engine.device, dtype=engine.compute_dtype))
        p = proc.Processing(**fields, scripts=runner)
        p.controlnet_units = [unit]
        res, s_secs = measured("ControlNetScript", lambda: proc.process_images(engine, p))
        img = res.images[0]
        check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8 and img.std() > 0
              and not np.array_equal(img, witness.images[0]),
              "annotators (c): one 1024² image, moved by the unit")
        fmap = registry.PREPROCESSORS["depth_anything_v2"](image, 512, 0, 0)
        want = np.clip(bilinear_resize(fmap, 1024, 1024), 0.0, 1.0)
        hint = p.controlnets[0].hint[0].float().cpu().numpy().transpose(1, 2, 0)
        check(np.array_equal(hint, want), "annotators (c): the hint = the registry's map at "
                                          "the request's size")
        log(f"annotators (c) depth_anything_v2 unit at {steps} steps: {s_secs:.4f} s against the "
            f"witness's {w_secs:.4f} s ({s_secs / w_secs:.3f}x); PSNR vs the witness "
            f"{image_psnr(img, witness.images[0]):.2f} dB")
        cond = engine.get_learned_conditioning([EXT_PROMPT, "blurry"], 1024, 1024)
        x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
        ts = torch.tensor([999.0, 400.0], device="cuda")
        apply = engine.unet_apply_fn(controlnets=p.controlnets)
        with torch.no_grad():
            fused = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"], t_host=999.0)
            with plain_versions():
                plain = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"],
                              t_host=999.0)
        value = psnr(fused, plain)
        log(f"annotators (c) sdxl unet + controlnet (depth hint) 128x128 B=2 bf16: kernels vs "
            f"plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(value >= PSNR_BOUND, f"annotators (c): UNet + ControlNet PSNR ≥ {PSNR_BOUND} dB")
        del cldm, unit, p, res, witness, x, fused, plain, cond
    finally:
        for m, globs in saved.items():
            for k, v in globs.items():
                setattr(m, k, v)
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"annotators phase 22 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def write_interrogate_files(work: str):
    """Every network of phase 23 at its published widths, made on the card from a seed and
    written under `work` in its upstream key space (the `.pt`/`.pth` files through torch.save,
    DeepDanbooru's with its tag names), the four category files, BLIP's vocab.txt → bytes."""
    from forge_tpu_torch.core import synth_annotators
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor

    total = 0
    for seed, (fn, rel, dtype) in enumerate(INTERROGATE_FILES):
        path = os.path.join(work, "models", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        sd = getattr(synth_annotators, fn)(fill=DeviceFill("cuda", seed=230 + seed))
        if rel.endswith((".pt", ".pth")):
            obj = {k: (v.materialize() if isinstance(v, LazyTensor) else torch.as_tensor(v)
                       ).to(dtype).cpu() for k, v in sd.items()}
            if fn == "synth_deepbooru_sd":
                obj["tags"] = synth_annotators.synth_deepbooru_tags()
            torch.save(obj, path)
        else:
            save_safetensors({k: v.to(dtype) if isinstance(v, LazyTensor) else v
                              for k, v in sd.items()}, path)
        total += os.path.getsize(path)
    for name, terms in synth_annotators.synth_interrogate_categories(INTERROGATE_TERMS).items():
        with open(os.path.join(work, "models", "interrogate", f"{name}.txt"), "w") as f:
            f.write("\n".join(terms) + "\n")
    with open(os.path.join(work, "models", "BLIP", "vocab.txt"), "w") as f:
        f.write("\n".join(synth_annotators.synth_wordpieces()) + "\n")
    return total


def cast_tree(tree, dtype):
    """A nested tree's floating leaves in `dtype` (on their device, their layout kept)."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}


# a network's weights and what rides with them, by the attribute names of its class
INTERROGATE_WEIGHTS = {"blip": ("params", "wp"), "clip": ("_params", "_tokenizer"),
                       "deepbooru": ("params", "tags")}


def install_interrogate(work: str, dtype=None, base=None):
    """Phase 23's interrogator, captioner, tagger and detectors reading `work`/models, in
    `dtype` (each network's own where None), in their modules' globals → {name: the object}.
    Where `base` (an f32 install) holds a network loaded, its weights are cast on the card
    instead of read again, or its object taken where the dtype is f32; Marigold is read
    again. The interrogator's categories are models/interrogate under the working directory."""
    import importlib

    from forge_tpu_torch.models import blip
    from forge_tpu_torch.postprocessing import deepbooru, interrogate

    kw = dict(device="cuda", dtype=dtype)
    models = os.path.join(work, "models")
    out = {"blip": blip.BlipCaptioner(model_dir=os.path.join(models, "BLIP"), **kw),
           "clip": interrogate.ClipInterrogator(model_dirs=(os.path.join(models, "interrogate"),),
                                                **kw),
           "deepbooru": deepbooru.DeepDanbooru(
               model_dir=os.path.join(models, "torch_deepdanbooru"), **kw)}
    mods = {}
    for entry, (mod, cls, sub) in INTERROGATE_ANNOTATORS.items():
        mods[entry] = importlib.import_module(f"forge_tpu_torch.preprocessors.{mod}")
        out[entry] = getattr(mods[entry], cls)(model_dir=os.path.join(models, sub), **kw)
    for name, obj in list(out.items()) if base is not None else ():
        weights, *extra = INTERROGATE_WEIGHTS.get(name, ("params",))
        loaded = getattr(base[name], weights)
        if loaded is None or name == "depth_marigold":
            continue
        target = obj.placement()[1]
        if target == base[name].placement()[1]:
            out[name] = base[name]
            continue
        setattr(obj, weights, cast_tree(loaded, target))
        for attr in extra:
            setattr(obj, attr, getattr(base[name], attr))
    blip._CAPTIONER, interrogate._INTERROGATOR, deepbooru._MODEL = (
        out["blip"], out["clip"], out["deepbooru"])
    for entry, m in mods.items():
        m._DETECTOR = out[entry]
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_interrogate(engine, gen: torch.Generator, steps: int = INTERROGATE_STEPS,
                      full: bool = False):
    """Phase 23: (a) interrogation (the library calls and /sdapi/v1/interrogate), (b) the six
    annotators through the registry and mediapipe_face's error, (c) Marigold at `steps` against
    plain, (d) an SDXL request with a depth_marigold unit, (e) the extras route's focal crop.
    `full`: every network that runs in f32 also timed in bf16 against f32."""
    import base64
    import importlib
    import threading

    from forge_tpu_torch import preprocessors as registry
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd
    from forge_tpu_torch.extensions.controlnet import ControlNetScript
    from forge_tpu_torch.models import blip as blip_mod
    from forge_tpu_torch.models.unet import UNetConfig, unet_apply
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from forge_tpu_torch.pipeline import images as images_mod
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.pipeline.upscalers import get_default_registry
    from forge_tpu_torch.postprocessing import deepbooru, interrogate
    from forge_tpu_torch.postprocessing.focal_crop import focal_crop
    from forge_tpu_torch.preprocessors.cv import bilinear_resize
    from forge_tpu_torch.runtime import profiling
    from forge_tpu_torch.runtime import scripts as scripts_mod
    from forge_tpu_torch.runtime.models import ModelManager
    from forge_tpu_torch.runtime.options import opts

    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), INTERROGATE_DIR)
    shutil.rmtree(work, ignore_errors=True)
    per_label, total = interrogate_counts(steps), {}
    mods = [blip_mod, interrogate, deepbooru] + [
        importlib.import_module(f"forge_tpu_torch.preprocessors.{m}")
        for m, _, _ in INTERROGATE_ANNOTATORS.values()]
    saved = {m: {k: getattr(m, k) for k in ("_CAPTIONER", "_INTERROGATOR", "_MODEL", "_DETECTOR")
                 if hasattr(m, k)} for m in mods}
    server = manager = None
    cwd = os.getcwd()
    lengths = {k: opts.get(k) for k in INTERROGATE_CAPTION}
    if not full:  # set, not overridden: the server's handler threads read them too
        for k, v in INTERROGATE_CAPTION.items():
            opts.set(k, v)
    max_length = max(int(opts.get(k)) for k in INTERROGATE_CAPTION)

    def measured(label, fn, counts=None, traced=False):
        """fn() synchronised: its seconds, its peak memory above the held and the launches it
        made, held to `counts` (a label of per_label, or a dict); `traced`: with the card
        alone traced (runtime/profiling.py), its seconds the trace's synchronised window,
        and its busy share as text in place of the seconds' neighbour → (out, s, peak[, busy])."""
        zero_counts()
        mon = profiling.MemoryMonitor(device="cuda")
        mon.start()
        with profiling.trace(logdir=None, enabled=traced) as tr:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        peak = mon.stop()["peak"] - mon.baseline
        launches = read_counts()
        add_counts(total, launches)
        want = per_label[counts] if isinstance(counts, str) else counts
        if want is not None:
            check_counts(launches, want, 1, f"interrogate {label}")
        if traced:
            return out, secs, peak, f"busy {100 * tr.busy:.2f} % ({tr.device_events} device events)"
        return out, secs, peak

    try:
        nbytes, _ = timed("interrogate: the networks made on the card and written",
                          lambda: write_interrogate_files(work))
        log(f"interrogate: {nbytes / 2**30:.3f} GiB of files under {INTERROGATE_DIR}")
        os.chdir(work)  # the interrogator reads its categories from models/interrogate
        source = np.random.default_rng(23).integers(0, 256, (512, 512, 3), dtype=np.uint8)
        source = np.asarray(bilinear_resize(bilinear_resize(source, 64, 64), 512, 512), np.uint8)
        mask = np.zeros((512, 512), np.float32)
        mask[128:384, 160:352] = 1.0

        # (a) interrogation: the same code at f32 first, then in each network's own dtype
        def discrete(nets):
            cap = nets["blip"]
            cap.load()
            x = (images_mod.bicubic_resize(source, 384, 384).astype(np.float32) / 255.0
                 - cap.MEAN) / cap.STD
            x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))
            prompt = np.asarray([blip_mod._BOS] + cap.wp.encode("a picture of"), np.int32)
            ids = blip_mod.blip_caption_ids(cap.params, x.to(*cap.placement()), prompt, max_length)
            emb = nets["clip"].image_embed(source)
            cats = interrogate.load_categories()
            tops = {name: nets["clip"].rank(emb, terms)[0] for name, terms in cats.items()}
            probs = nets["deepbooru"].probabilities(source)
            return ids, tops, probs

        nets32 = install_interrogate(work, torch.float32)
        f32 = discrete(nets32)
        log(f"interrogate (a) at f32 {time.perf_counter() - t_phase:.2f} s into the phase")
        bf16 = discrete(install_interrogate(work, torch.bfloat16, nets32)) if full else None
        nets = install_interrogate(work, base=nets32)
        del nets32
        own = discrete(nets)
        log(f"interrogate (a) in the own dtypes {time.perf_counter() - t_phase:.2f} s into the "
            f"phase")
        names = ("blip", "clip", "deepbooru")
        dtypes = {n: nets[n].placement()[1] for n in names}
        tags_f32 = set(np.flatnonzero(f32[2] >= 0.5))
        for label, got in (("own dtype", own),) + ((("bf16", bf16),) if full else ()):
            tags = set(np.flatnonzero(got[2] >= 0.5))
            log(f"interrogate (a) {label}: BLIP ids {'=' if np.array_equal(got[0], f32[0]) else '≠'}"
                f" f32's; top terms " + ", ".join(
                    f"{k} {'=' if got[1][k][0] == f32[1][k][0] else '≠'}" for k in f32[1])
                + f"; DeepDanbooru tags ≥ 0.5: {len(tags)} (f32 {len(tags_f32)}, "
                f"{len(tags ^ tags_f32)} differ), probabilities max abs err "
                f"{np.abs(got[2] - f32[2]).max():.3e}")
        log(f"interrogate (a) dtypes: " + ", ".join(f"{n} {str(d)[6:]}" for n, d in dtypes.items())
            + f"; the caption ids {f32[0][0].tolist()}")
        check(np.array_equal(own[0], f32[0]), "interrogate (a): BLIP's caption ids = f32's")
        check(all(own[1][k][0] == f32[1][k][0] for k in f32[1]),
              "interrogate (a): each category's top term = f32's")
        check(set(np.flatnonzero(own[2] >= 0.5)) == tags_f32,
              "interrogate (a): DeepDanbooru's tags above the threshold = f32's")

        cap, clip, db = nets["blip"], nets["clip"], nets["deepbooru"]
        x = (images_mod.bicubic_resize(source, 384, 384).astype(np.float32) / 255.0
             - cap.MEAN) / cap.STD
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(*cap.placement())
        with torch.no_grad():
            vit, _, _ = measured("BLIP ViT", lambda: blip_mod.vit_encode(
                cap.params["visual_encoder"], x), {"flash_attention": BLIP_FLASH}
                if dtypes["blip"] == torch.bfloat16 else None)
            launches = read_counts()
            with plain_versions():
                vit_plain = blip_mod.vit_encode(cap.params["visual_encoder"], x)
        value = psnr(vit, vit_plain)
        log(f"interrogate (a) BLIP ViT {tuple(vit.shape)} {str(dtypes['blip'])[6:]}: flash "
            f"{launches['flash_attention']} (wgmma {launches['flash_attention[wgmma]']}, simt "
            f"{launches['flash_attention[simt]']}), kernels vs plain PSNR {value:.2f} dB "
            f"(bound {PSNR_BOUND})")
        check(launches["flash_attention"] == BLIP_FLASH,
              f"interrogate (a): exactly {BLIP_FLASH} flash launches a BLIP ViT forward")
        check(value >= PSNR_BOUND, f"interrogate (a): BLIP's ViT kernels vs plain ≥ {PSNR_BOUND} dB")
        # the masked tail at 577 keys (65 in the wgmma body's last 128-key tile): every true
        # score −32 and v = 1, so the exact output is 1
        for dtype, body, bound_ in ((torch.bfloat16, "wgmma", 2e-3),
                                    (torch.bfloat16, "simt", 2e-3), (torch.float32, "simt", 1e-4)):
            q = torch.full((1, 12, 577, 64), 2.0, device="cuda", dtype=dtype)
            k = torch.full_like(q, -2.0)
            v = torch.ones_like(q)
            got = flash_attention(q, k, v, body=body).float()
            err = (got - flash_attention_plain(q, k, v).float()).abs().max().item()
            exact = (got - 1.0).abs().max().item()
            log(f"interrogate (a) flash {body} {str(dtype)[6:]} q(1,12,577,64), every score −32, "
                f"v = 1: max abs err vs plain {err:.3e}, vs the exact 1 {exact:.3e} "
                f"(bound {bound_:g})")
            check(max(err, exact) < bound_, f"interrogate (a): flash's masked tail at 577 keys, "
                                            f"{body} body at {dtype}")
        del vit, vit_plain, q, k, v, got

        log(f"interrogate (a) the ViT and tail checks {time.perf_counter() - t_phase:.2f} s into "
            f"the phase")
        caption, c_secs, c_peak, c_busy = measured(
            "caption", lambda: cap.caption(source, max_length=max_length), "caption", traced=True)
        # the category terms' text embeds were made (and cached) by the comparison above
        clip_caption, i_secs, i_peak, i_busy = measured(
            "library clip", lambda: clip.interrogate(source), "caption", traced=True)
        tag_kw = dict(threshold=float(opts.get("interrogate_deepbooru_score_threshold")),
                      alpha_sort=bool(opts.get("deepbooru_sort_alpha")),
                      use_spaces=bool(opts.get("deepbooru_use_spaces")),
                      use_escape=bool(opts.get("deepbooru_escape")),
                      filter_tags=str(opts.get("deepbooru_filter_tags")))
        tags, t_secs, t_peak, t_busy = measured(
            "library deepbooru", lambda: db.tag(source, **tag_kw), "API deepbooru", traced=True)
        check(clip_caption.startswith(caption), "interrogate (a): the BLIP caption leads")
        log(f"interrogate (a) BLIP caption ({max_length} tokens) {c_secs:.4f} s, peak +{c_peak / 2**30:.2f} GiB, "
            f"{c_busy}: {caption!r}")
        log(f"interrogate (a) CLIP interrogation ({INTERROGATE_TERMS} terms × 4 categories, "
            f"their text embeds cached) {i_secs:.4f} s, peak +{i_peak / 2**30:.2f} GiB, "
            f"{i_busy}: {clip_caption[len(caption):]!r}")
        log(f"interrogate (a) DeepDanbooru {t_secs:.4f} s, peak +{t_peak / 2**30:.2f} GiB, "
            f"{t_busy}: {tags.count(', ') + 1} tags")
        log(f"interrogate (a) the library calls {time.perf_counter() - t_phase:.2f} s into the "
            f"phase")
        manager = ModelManager(checkpoint_dirs=[], device=engine.device)
        server = create_server(manager, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        b64 = base64.b64encode(images_mod.encode_png(source)).decode()
        api_clip, a_secs, _ = measured("API clip", lambda: http(
            base, "/sdapi/v1/interrogate", {"image": b64, "model": "clip"}), "API clip")
        api_db, d_secs, _ = measured("API deepbooru", lambda: http(
            base, "/sdapi/v1/interrogate", {"image": b64, "model": "deepbooru"}), "API deepbooru")
        log(f"interrogate (a) /sdapi/v1/interrogate clip {a_secs:.4f} s, deepbooru {d_secs:.4f} s")
        check(api_clip == {"caption": clip_caption},
              "interrogate (a): /sdapi/v1/interrogate clip = the library's caption")
        check(api_db == {"caption": tags},
              "interrogate (a): /sdapi/v1/interrogate deepbooru = the library's tags")

        log(f"interrogate (a) done {time.perf_counter() - t_phase:.2f} s into the phase")

        # (b) the six annotators through the registry: f32 maps first, then each network's dtype
        def detect(name, nets_):
            if name == "inpaint_only+lama":  # the entry passes the image; the unit runs LaMa
                return nets_[name].inpaint(source, mask).astype(np.float32) / 255.0
            return registry.PREPROCESSORS[name](source, 512, 0, 0)

        nets32 = install_interrogate(work, torch.float32)
        maps32 = {name: detect(name, nets32) for name in INTERROGATE_ANNOTATORS}
        log(f"interrogate (b) at f32 {time.perf_counter() - t_phase:.2f} s into the phase")
        db16 = {}
        if full:
            nets16 = install_interrogate(work, torch.bfloat16, nets32)
            db16 = {name: map_psnr(detect(name, nets16), maps32[name])
                    for name in INTERROGATE_ANNOTATORS}
            del nets16
        nets = install_interrogate(work, base=nets32)
        del nets32
        for name in INTERROGATE_ANNOTATORS:
            check(registry.PREPROCESSORS[name].ported, f"interrogate (b): {name} is ported")
            first = detect(name, nets)  # loads the weights
            want = marigold_counts(MARIGOLD_ENTRY_STEPS) if name == "depth_marigold" else \
                {"flash_attention": 0, "gn_silu_conv3x3": 0, "dequant_matmul": 0}
            again, secs, peak, share = measured(name, lambda _n=name: detect(_n, nets), want,
                                                traced=True)
            dtype = nets[name].placement()[1]
            db = map_psnr(again, maps32[name])
            levels = again * 255.0
            check(again.shape == (512, 512, 3) and again.dtype == np.float32
                  and np.isfinite(again).all() and again.min() >= 0 and again.max() <= 1
                  and np.array_equal(levels, np.rint(levels)),
                  f"interrogate (b): {name}'s map is 512²×3, finite, uint8 levels in [0, 1]")
            check(np.array_equal(first, again), f"interrogate (b): {name} reruns byte-identical")
            if name in SEGMENTERS and dtype != torch.float32:
                check(np.array_equal(again, maps32[name]),
                      f"interrogate (b): {name}'s palette in {dtype} = f32's")
            check(db >= ANNOTATOR_BAR, f"interrogate (b): {name} in {dtype} against f32 ≥ "
                                       f"{ANNOTATOR_BAR} dB ({db:.2f})")
            check(again.std() > 0, f"interrogate (b): {name}'s map is not flat")
            log(f"interrogate (b) {name:18s} dtype {str(dtype)[6:]:8s} {secs:.4f} s, peak "
                f"+{peak / 2**20:.1f} MiB, the card alone traced, {share}; vs f32 {db:.2f} dB"
                + (f", bf16 vs f32 {db16[name]:.2f} dB" if full else "")
                + f"; map mean {again.mean():.4f} std {again.std():.4f}")
        try:
            registry.PREPROCESSORS["mediapipe_face"](source, 512, 1, 0.5)
            check(False, "interrogate (b): mediapipe_face raises")
        except RuntimeError as e:
            check("mediapipe" in str(e), "interrogate (b): mediapipe_face raises its RuntimeError")

        log(f"interrogate (b) done {time.perf_counter() - t_phase:.2f} s into the phase")

        # (c) Marigold at `steps` DDIM steps: launches by body, a UNet forward and the depth
        # through the kernels against plain
        det = nets["depth_marigold"]
        pipe = det.load()
        _, m_secs, m_peak = measured(f"Marigold at {steps} steps",
                                     lambda: det.detect(source, steps=steps), marigold_counts(steps))
        dtype = pipe.empty_embed.dtype
        with torch.no_grad():
            x = torch.randn((1, 8, 64, 64), generator=gen, device="cuda").to(dtype)
            ts = torch.tensor([501.0], device="cuda")
            cfg = UNetConfig(context_dim=pipe.empty_embed.shape[-1], head_dim=64)
            fused = unet_apply(pipe.unet, x, ts, pipe.empty_embed, cfg=cfg)
            with plain_versions():
                plain = unet_apply(pipe.unet, x, ts, pipe.empty_embed, cfg=cfg)
            rgb = torch.from_numpy(np.ascontiguousarray(
                source.astype(np.float32).transpose(2, 0, 1)[None]) / 127.5 - 1.0).cuda()
            noise = torch.randn((1, 4, 64, 64), generator=gen, device="cuda")
            depth = pipe.infer(rgb, noise, steps)
            with plain_versions():
                depth_plain = pipe.infer(rgb, noise, steps)
        value, d_value = psnr(fused, plain), psnr(depth, depth_plain)
        log(f"interrogate (c) Marigold {str(dtype)[6:]} at {steps} steps: {m_secs:.4f} s, peak "
            f"+{m_peak / 2**30:.2f} GiB; a UNet forward (1,8,64,64) kernels vs plain PSNR "
            f"{value:.2f} dB (bound {PSNR_BOUND}); the depth kernels vs plain {d_value:.2f} dB")
        check(value >= PSNR_BOUND, f"interrogate (c): Marigold's UNet kernels vs plain ≥ "
                                   f"{PSNR_BOUND} dB")
        del x, fused, plain, depth, depth_plain

        log(f"interrogate (c) done {time.perf_counter() - t_phase:.2f} s into the phase")

        # (d) an SDXL request with a depth_marigold unit through ControlNetScript
        cldm, _ = timed("interrogate (d): a full-width SDXL ControlNet made on the card",
                        lambda: synth_controlnet_sd(fill=DeviceFill("cuda", seed=23)))
        image = np.asarray(bilinear_resize(source, 1024, 1024), np.uint8)
        unit = {"module": "depth_marigold", "model": cldm, "image": image, "weight": 1.0,
                "processor_res": 512}
        fields = dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps,
                      cfg_scale=7.0, width=1024, height=1024, sampler_name="DPM++ 2M",
                      scheduler="karras")
        witness, w_secs, _ = measured("witness", lambda: proc.process_images(
            engine, proc.Processing(**fields)), "witness")
        runner = scripts_mod.ScriptRunner()
        runner.register(ControlNetScript(device=engine.device, dtype=engine.compute_dtype))
        p = proc.Processing(**fields, scripts=runner)
        p.controlnet_units = [unit]
        res, s_secs, _ = measured("ControlNetScript", lambda: proc.process_images(engine, p),
                                  "ControlNetScript")
        img = res.images[0]
        check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8 and img.std() > 0
              and not np.array_equal(img, witness.images[0]),
              "interrogate (d): one 1024² image, moved by the unit")
        fmap = registry.PREPROCESSORS["depth_marigold"](image, 512, 0, 0)
        want = np.clip(bilinear_resize(fmap, 1024, 1024), 0.0, 1.0)
        hint = p.controlnets[0].hint[0].float().cpu().numpy().transpose(1, 2, 0)
        check(np.array_equal(hint, want), "interrogate (d): the hint = the registry's map at the "
                                          "request's size")
        log(f"interrogate (d) depth_marigold unit at {steps} steps: {s_secs:.4f} s against the "
            f"witness's {w_secs:.4f} s ({s_secs / w_secs:.3f}x); PSNR vs the witness "
            f"{image_psnr(img, witness.images[0]):.2f} dB")
        cond = engine.get_learned_conditioning([EXT_PROMPT, "blurry"], 1024, 1024)
        x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
        ts = torch.tensor([999.0, 400.0], device="cuda")
        apply = engine.unet_apply_fn(controlnets=p.controlnets)
        with torch.no_grad():
            fused = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"], t_host=999.0)
            with plain_versions():
                plain = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"],
                              t_host=999.0)
        value = psnr(fused, plain)
        log(f"interrogate (d) sdxl unet + controlnet (Marigold hint) 128x128 B=2 bf16: kernels "
            f"vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(value >= PSNR_BOUND, f"interrogate (d): UNet + ControlNet PSNR ≥ {PSNR_BOUND} dB")
        del cldm, unit, p, res, witness, x, fused, plain, cond

        log(f"interrogate (d) done {time.perf_counter() - t_phase:.2f} s into the phase")

        # (e) /sdapi/v1/extra-single-image with focal_crop_enabled
        tw, th = INTERROGATE_FOCAL["upscaling_resize_w"], INTERROGATE_FOCAL["upscaling_resize_h"]
        quarter = np.ascontiguousarray(source[128:384, 128:384])
        answer = http(base, "/sdapi/v1/extra-single-image", dict(
            image=base64.b64encode(images_mod.encode_png(quarter)).decode(), upscaler_1="Lanczos",
            resize_mode=1, upscaling_crop=True, focal_crop_enabled=True, **INTERROGATE_FOCAL))
        got = images_mod.decode_png(base64.b64decode(answer["image"]))[0]
        up = get_default_registry(engine.device).get("Lanczos").upscale(quarter, max(tw, th) / 256)
        want = focal_crop(up, tw, th, 0.9, 0.15, 0.5)
        log(f"interrogate (e) /extra-single-image, Lanczos to {up.shape[1]}×{up.shape[0]}, focal "
            f"crop {tw}×{th}: {got.shape[1]}×{got.shape[0]}")
        check(got.shape == (th, tw, 3) and np.array_equal(got, want),
              "interrogate (e): the focal crop's PNG = the library's focal_crop of the upscale")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            manager.close()
        for m, globs in saved.items():
            for k, v in globs.items():
                setattr(m, k, v)
        for k, v in lengths.items():
            opts.set(k, v)
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"interrogate phase 23 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def write_spaces_files(work: str, sapiens_blocks: int):
    """Every network of phase 24 at its published widths (Sapiens-1B at `sapiens_blocks`
    blocks), made on the card from a seed and written under `work`/models in its file's key
    space, with BLIP's seeded vocab.txt and DeepDanbooru's seeded tag names → bytes."""
    from forge_tpu_torch.core import synth_annotators
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import DeviceFill, LazyTensor

    total = 0
    for seed, (fn, rel, kw, dtype) in enumerate(SPACES_FILES):
        path = os.path.join(work, "models", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if fn == "synth_sapiens_sd":
            kw = dict(kw, depth=sapiens_blocks)
        sd = getattr(synth_annotators, fn)(fill=DeviceFill("cuda", seed=240 + seed), **kw)
        if fn == "synth_oneformer_sd":
            # at the synth's scale every query attends near-uniformly and the map takes one
            # class: the decoder's attention ×8, the class embedding ×4 and the mask embedding's
            # last layer ×16 give it several on some seeds (CPU probes at 640²: ADE20K's 3
            # classes, COCO's 1)
            pred = "sem_seg_head.predictor."
            for key in sd:
                if key.startswith(pred) and key.endswith("in_proj_weight"):
                    sd[key] = synth_annotators.scaled(sd[key], 8.0)
            for key, gain in (("class_embed.weight", 4.0), ("mask_embed.layers.2.weight", 16.0)):
                sd[pred + key] = synth_annotators.scaled(sd[pred + key], gain)
        if rel.endswith((".pt", ".pth")):
            def tensor(v, _dtype=dtype):
                t = v.materialize() if isinstance(v, LazyTensor) else torch.as_tensor(v)
                return (t.to(_dtype) if t.is_floating_point() else t).cpu()

            obj = {k: tensor(v) for k, v in sd.items()}
            if fn == "synth_oneformer_sd":  # detectron2's checkpointer: the weights under `model`
                obj = {"model": obj, "iteration": 160000}
            if fn == "synth_deepbooru_sd":
                obj["tags"] = synth_annotators.synth_deepbooru_tags()
            torch.save(obj, path)
        else:
            save_safetensors({k: v.to(dtype) if isinstance(v, LazyTensor) else v
                              for k, v in sd.items()}, path)
        total += os.path.getsize(path)
    with open(os.path.join(work, "models", "BLIP", "vocab.txt"), "w") as f:
        f.write("\n".join(synth_annotators.synth_wordpieces()) + "\n")
    return total


def install_spaces(models: str, dtype=None, base=None):
    """Phase 24's OneFormer, DensePose, Sapiens and U²-Net objects reading `models`, in
    `dtype` (each network's own where None), the detectors in their modules' globals →
    {name: the object}. Where `base` (an f32 install) holds a network loaded, its weights are
    cast on the card instead of read again, or its object taken where the dtype is f32."""
    from forge_tpu_torch.models.sapiens import SapiensNormal
    from forge_tpu_torch.models.u2net import U2NetMatter
    from forge_tpu_torch.preprocessors import densepose, oneformer

    kw = dict(device="cuda", dtype=dtype)
    out = {kind: oneformer.OneformerDetector(kind, model_dir=os.path.join(models, "oneformer"),
                                             **kw) for kind in ONEFORMER_ENTRIES.values()}
    out["densepose"] = densepose.DensePoseDetector(model_dir=os.path.join(models, "densepose"),
                                                   **kw)
    out["sapiens"] = SapiensNormal(model_dir=os.path.join(models, "sapiens"),
                                   mask_model_dir=os.path.join(models, "u2net"), **kw)
    out["u2net"] = U2NetMatter(model_dir=os.path.join(models, "u2net"), **kw)
    for name, obj in list(out.items()) if base is not None else ():
        if base[name].params is None:
            continue
        if obj.placement()[1] == base[name].placement()[1]:
            out[name] = base[name]
        else:
            obj.params = cast_tree(base[name].params, obj.placement()[1])
    out["sapiens"]._matter = out["u2net"]
    oneformer._DETECTORS.update({kind: out[kind] for kind in ONEFORMER_ENTRIES.values()})
    densepose._DETECTOR = out["densepose"]
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_spaces(engine, gen: torch.Generator, steps: int = SPACES_STEPS, full: bool = False):
    """Phase 24: (a) seg_ofade20k and seg_ofcoco, (b) both DensePose entries, (c) Sapiens-1B
    against plain flash and the U²-Net mask, (d) the four port Spaces as child processes on the
    card through /sdapi/v1/spaces/launch, each /process against the same call in-process, (e)
    an SDXL request with a seg_ofade20k unit beside its witness. `full`: Sapiens at its 40
    blocks and every network also in bf16 against f32."""
    import argparse
    import base64
    import importlib
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from forge_tpu_torch import preprocessors as registry
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.core.synth import DeviceFill, synth_controlnet_sd
    from forge_tpu_torch.extensions.controlnet import ControlNetScript
    from forge_tpu_torch.models import sapiens as sapiens_mod
    from forge_tpu_torch.models.sapiens import SapiensNormal
    from forge_tpu_torch.models.u2net import U2NetMatter
    from forge_tpu_torch.ops import plain_versions
    from forge_tpu_torch.pipeline import images as images_mod
    from forge_tpu_torch.pipeline import processing as proc
    from forge_tpu_torch.preprocessors import densepose, oneformer
    from forge_tpu_torch.preprocessors.cv import bilinear_resize
    from forge_tpu_torch.runtime import profiling
    from forge_tpu_torch.runtime import scripts as scripts_mod
    from forge_tpu_torch.runtime.models import ModelManager

    t_phase = time.perf_counter()
    blocks = SAPIENS_FLASH if full else SAPIENS_CUT
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), SPACES_DIR)
    models = os.path.join(work, "models")
    shutil.rmtree(work, ignore_errors=True)
    per_label, total = spaces_counts(steps, blocks), {}
    saved = (dict(oneformer._DETECTORS), densepose._DETECTOR)
    env_keys = ("SAPIENS_MODEL_DIR", "U2NET_MODEL_DIR", "CAPTION_MODEL_ROOT")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    server = manager = None
    launched = []

    def since():
        return f"{time.perf_counter() - t_phase:.2f} s into the phase"

    def measured(label, fn, counts, traced=False):
        """fn() synchronised: (its output, seconds, peak memory above the held[, busy share]),
        its launches held to per_label[counts]."""
        zero_counts()
        mon = profiling.MemoryMonitor(device="cuda")
        mon.start()
        with profiling.trace(logdir=None, enabled=traced) as tr:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        peak = mon.stop()["peak"] - mon.baseline
        launches = read_counts()
        add_counts(total, launches)
        check_counts(launches, per_label[counts], 1, f"spaces {label}")
        if traced:
            return out, secs, peak, f"busy {100 * tr.busy:.2f} % ({tr.device_events} device events)"
        return out, secs, peak

    try:
        nbytes, _ = timed("spaces: the networks made on the card and written",
                          lambda: write_spaces_files(work, blocks))
        log(f"spaces: {nbytes / 2**30:.3f} GiB of files under {SPACES_DIR} (Sapiens-1B at "
            f"{blocks} blocks)")
        source = np.random.default_rng(24).integers(0, 256, (512, 512, 3), dtype=np.uint8)
        source = np.asarray(bilinear_resize(bilinear_resize(source, 64, 64), 512, 512), np.uint8)

        # (a) OneFormer and (b) DensePose through the registry: f32 first, then bf16 (full)
        # and each network's own dtype
        def run_all(nets):
            maps = {e: registry.PREPROCESSORS[e](source, 512, 0, 0)
                    for e in list(ONEFORMER_ENTRIES) + list(DENSEPOSE_ENTRIES)}
            return maps, nets["densepose"].detections(source)

        def same_detections(a, b):
            return len(a) == len(b) and all(x[0] == y[0] and np.array_equal(x[1], y[1])
                                            for x, y in zip(a, b))

        nets32 = install_spaces(models, torch.float32)
        maps32, dets32 = run_all(nets32)
        log(f"spaces (a, b) at f32 {since()}; DensePose {len(dets32)} boxes: "
            + ", ".join(str(b) for b, _ in dets32))
        if full:
            maps16, dets16 = run_all(install_spaces(models, torch.bfloat16, nets32))
            for e in maps32:
                log(f"spaces (a, b) bf16 {e}: map {'=' if np.array_equal(maps16[e], maps32[e]) else '≠'}"
                    f" f32's, {map_psnr(maps16[e], maps32[e]):.2f} dB, "
                    f"{100 * (maps16[e] != maps32[e]).any(-1).mean():.3f} % of the pixels differ")
            log(f"spaces (b) bf16 DensePose: {len(dets16)} boxes, boxes and labels "
                f"{'=' if same_detections(dets16, dets32) else '≠'} f32's")
        nets = install_spaces(models, base=nets32)
        del nets32
        for entry, kind in list(ONEFORMER_ENTRIES.items()) + list(DENSEPOSE_ENTRIES.items()):
            det = nets[kind] if kind in ONEFORMER_ENTRIES.values() else nets["densepose"]
            first = registry.PREPROCESSORS[entry](source, 512, 0, 0)
            again, secs, peak, share = measured(
                entry, lambda _e=entry: registry.PREPROCESSORS[_e](source, 512, 0, 0), "detect",
                traced=True)
            dtype = det.placement()[1]
            check(registry.PREPROCESSORS[entry].ported, f"spaces: {entry} is ported")
            check(again.shape == (512, 512, 3) and np.isfinite(again).all()
                  and np.array_equal(again * 255.0, np.rint(again * 255.0)),
                  f"spaces: {entry}'s map is 512²×3 uint8 levels")
            check(np.array_equal(first, again), f"spaces: {entry} reruns byte-identical")
            check(np.array_equal(again, maps32[entry]), f"spaces: {entry} in {dtype} = f32's map")
            colours = len(np.unique(again.reshape(-1, 3), axis=0))
            if entry in DENSEPOSE_ENTRIES:  # the background and the parts; a random OneFormer's
                # map may hold one class (printed)
                check(colours >= 2, f"spaces: {entry}'s map holds two colours or more")
            log(f"spaces ({'a' if kind in ONEFORMER_ENTRIES.values() else 'b'}) {entry:42s} "
                f"dtype {str(dtype)[6:]:8s} {secs:.4f} s, peak +{peak / 2**20:.1f} MiB, the card "
                f"alone traced, {share}; {colours} colours")
        check(same_detections(nets["densepose"].detections(source), dets32) and len(dets32) > 0,
              "spaces (b): DensePose's boxes and labels in its dtype = f32's")
        log(f"spaces (a, b) done {since()}")

        # (c) Sapiens-1B's forward against plain flash, its normals and the U²-Net mask
        sap, matter = nets["sapiens"], nets["u2net"]
        sap.load()
        feed = (images_mod.cv2_linear_resize(source, sapiens_mod.INPUT_W, sapiens_mod.INPUT_H)
                .astype(np.float32) / 255.0 - sapiens_mod.MEAN) / sapiens_mod.STD
        x = torch.from_numpy(np.ascontiguousarray(feed.transpose(2, 0, 1)[None])).to(
            *sap.placement())
        with torch.no_grad():
            sapiens_mod.sapiens_apply(sap.params, x)  # warm
            fused, f_secs, f_peak = measured("Sapiens forward", lambda: sapiens_mod.sapiens_apply(
                sap.params, x), "sapiens")
            launches = read_counts()
            with plain_versions():
                plain = sapiens_mod.sapiens_apply(sap.params, x)
        value = psnr(fused, plain)
        log(f"spaces (c) Sapiens-1B ({blocks} blocks) {str(sap.placement()[1])[6:]} forward "
            f"{tuple(fused.shape)}: {f_secs:.4f} s, peak +{f_peak / 2**30:.2f} GiB; flash "
            f"{launches['flash_attention']} (wgmma {launches['flash_attention[wgmma]']}); kernels "
            f"vs plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(launches["flash_attention"] == blocks,
              f"spaces (c): exactly {blocks} flash launches a Sapiens forward")
        check(value >= PSNR_BOUND, f"spaces (c): Sapiens kernels vs plain ≥ {PSNR_BOUND} dB")
        del fused, plain, x
        normals, n_secs, _ = measured("Sapiens normals", lambda: sap.normals(source), "sapiens")
        mask, m_secs, _ = measured("U²-Net mask", lambda: matter.mask(source), "detect")
        matter32 = U2NetMatter(os.path.join(models, "u2net"), device="cuda", dtype=torch.float32)
        sap32 = SapiensNormal(os.path.join(models, "sapiens"), device="cuda", dtype=torch.float32)
        sap32._matter = matter32
        normals32, mask32 = sap32.normals(source), matter32.mask(source)
        del sap32, matter32
        n_db, m_db = map_psnr(normals / 255.0, normals32 / 255.0), map_psnr(mask, mask32)
        log(f"spaces (c) the normal map (U²-Net mask on) {n_secs:.4f} s, "
            f"{str(sap.placement()[1])[6:]} vs f32 {n_db:.2f} dB; the U²-Net mask {m_secs:.4f} s, "
            f"{str(matter.placement()[1])[6:]} vs f32 {m_db:.2f} dB (bar {ANNOTATOR_BAR})")
        check(normals.shape == (512, 512, 3) and normals.dtype == np.uint8 and normals.std() > 0,
              "spaces (c): the normal map is 512²×3 uint8, not flat")
        check(n_db >= ANNOTATOR_BAR and m_db >= ANNOTATOR_BAR,
              f"spaces (c): Sapiens and U²-Net in their dtypes against f32 ≥ {ANNOTATOR_BAR} dB")
        log(f"spaces (c) done {since()}")

        # (d) the four port Spaces, each a child process on the card
        os.environ.update(SAPIENS_MODEL_DIR=os.path.join(models, "sapiens"),
                          U2NET_MODEL_DIR=os.path.join(models, "u2net"),
                          CAPTION_MODEL_ROOT=models)
        manager = ModelManager(checkpoint_dirs=[], device=engine.device)
        server = create_server(manager, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        png = base64.b64encode(images_mod.encode_png(source)).decode()
        bodies = {"forge_space_example": {"name": "chip smoke", "intensity": 3},
                  "forge_space_sapiens_normal": {"image": png, "mask": True},
                  "forge_space_birefnet": {"image": png, "flat": True, "bg": "#20c05a"},
                  "forge_space_florence_2": {"image": png, "tags": True}}
        def launch(name):  # the four at once, as four users' requests would come
            t = time.perf_counter()
            return http(base, "/sdapi/v1/spaces/launch", {"name": name})["url"], \
                time.perf_counter() - t

        launched.extend(SPACE_NAMES)
        with ThreadPoolExecutor(len(SPACE_NAMES)) as pool:
            started = dict(zip(SPACE_NAMES, pool.map(launch, SPACE_NAMES)))
        urls = {name: url for name, (url, _) in started.items()}
        for name, (url, secs) in started.items():
            log(f"spaces (d) {name} launched at {url} in {secs:.2f} s")
        check(len(set(urls.values())) == len(SPACE_NAMES), "spaces (d): four Spaces, four ports")
        listed = {s["name"]: s for s in http(base, "/sdapi/v1/spaces")["spaces"]}
        check(all(listed[n]["running"] and listed[n]["url"] == urls[n] for n in SPACE_NAMES),
              "spaces (d): /sdapi/v1/spaces lists the four running at their URLs")

        def post(name):
            t = time.perf_counter()
            answer = http(urls[name], "/process", bodies[name])
            return answer, time.perf_counter() - t

        with ThreadPoolExecutor(len(SPACE_NAMES)) as pool:
            answers = dict(zip(SPACE_NAMES, pool.map(post, SPACE_NAMES)))
        # the same calls in-process: each app's own process() on the state its setup makes (the
        # f32 networks at f32 on both sides: the forwards turn TF32 off in the child too)
        for name in SPACE_NAMES:
            app = importlib.import_module(
                f"forge_tpu_torch.spaces.{name[len('forge_space_'):]}")
            ns = argparse.Namespace(device=None, model_root=models, model_dir=os.path.join(
                models, "sapiens" if "sapiens" in name else "u2net"),
                mask_model_dir=os.environ["U2NET_MODEL_DIR"])
            state = app._setup(ns) if hasattr(app, "_setup") else None
            want = app.process(bodies[name], state)
            if name == "forge_space_sapiens_normal":
                bare = app.process(dict(bodies[name], mask=False), state)
                check(bare["image"] != want["image"],
                      "spaces (d): the Sapiens Space's masked answer differs from its unmasked one")
            got, secs = answers[name]
            if "image" in want:
                a = images_mod.decode_png(base64.b64decode(got["image"]))[0]
                b = images_mod.decode_png(base64.b64decode(want["image"]))[0]
                same = a.shape == b.shape and np.array_equal(a, b)
                diff = np.abs(a.astype(np.int32) - b) if a.shape == b.shape else np.asarray([-1])
                what = (f"{a.shape[1]}×{a.shape[0]}×{a.shape[2]} pixels, max diff {diff.max()}, "
                        f"{100 * (diff != 0).mean():.3f} % of the values differ")
            else:
                same = got == want
                what = ", ".join(f"{k} {'=' if got.get(k) == want.get(k) else '≠'}"
                                 for k in sorted(set(got) | set(want)))
                what += f"; {json.dumps(got)[:120]}"
            log(f"spaces (d) {name} POST /process {secs:.4f} s (the child's first, its load "
                f"included): {what}, {'=' if same else '≠'} the same call in-process")
            check(same, f"spaces (d): {name}'s /process = the same call in-process")
            del state
        check(set(answers["forge_space_florence_2"][0]) == {"caption", "tags"},
              "spaces (d): the caption Space answers a caption and tags")
        for name in SPACE_NAMES:
            http(base, "/sdapi/v1/spaces/terminate", {"name": name})
        launched.clear()
        listed = http(base, "/sdapi/v1/spaces")["spaces"]
        check(not any(s["running"] for s in listed), "spaces (d): every Space terminated")
        log(f"spaces (d) done {since()}")

        # (e) an SDXL request with a seg_ofade20k unit through ControlNetScript
        cldm, _ = timed("spaces (e): a full-width SDXL ControlNet made on the card",
                        lambda: synth_controlnet_sd(fill=DeviceFill("cuda", seed=24)))
        image = np.asarray(bilinear_resize(source, 1024, 1024), np.uint8)
        unit = {"module": "seg_ofade20k", "model": cldm, "image": image, "weight": 1.0,
                "processor_res": 512}
        fields = dict(prompt=EXT_PROMPT, negative_prompt="blurry", seed=1, steps=steps,
                      cfg_scale=7.0, width=1024, height=1024, sampler_name="DPM++ 2M",
                      scheduler="karras")
        witness, w_secs, _ = measured("witness", lambda: proc.process_images(
            engine, proc.Processing(**fields)), "witness")
        runner = scripts_mod.ScriptRunner()
        runner.register(ControlNetScript(device=engine.device, dtype=engine.compute_dtype))
        p = proc.Processing(**fields, scripts=runner)
        p.controlnet_units = [unit]
        res, s_secs, _ = measured("ControlNetScript", lambda: proc.process_images(engine, p),
                                  "ControlNetScript")
        img = res.images[0]
        check(img.shape == (1024, 1024, 3) and img.dtype == np.uint8 and img.std() > 0
              and not np.array_equal(img, witness.images[0]),
              "spaces (e): one 1024² image, moved by the unit")
        fmap = registry.PREPROCESSORS["seg_ofade20k"](image, 512, 0, 0)
        want = np.clip(bilinear_resize(fmap, 1024, 1024), 0.0, 1.0)
        hint = p.controlnets[0].hint[0].float().cpu().numpy().transpose(1, 2, 0)
        check(np.array_equal(hint, want), "spaces (e): the hint = the registry's map at the "
                                          "request's size")
        log(f"spaces (e) seg_ofade20k unit at {steps} steps: {s_secs:.4f} s against the "
            f"witness's {w_secs:.4f} s ({s_secs / w_secs:.3f}x); PSNR vs the witness "
            f"{image_psnr(img, witness.images[0]):.2f} dB")
        cond = engine.get_learned_conditioning([EXT_PROMPT, "blurry"], 1024, 1024)
        x = torch.randn((2, 4, 128, 128), generator=gen, device="cuda").to(engine.compute_dtype)
        ts = torch.tensor([999.0, 400.0], device="cuda")
        apply = engine.unet_apply_fn(controlnets=p.controlnets)
        with torch.no_grad():
            fused = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"], t_host=999.0)
            with plain_versions():
                plain = apply(engine.loaded.unet, x, ts, cond["context"], y=cond["y"],
                              t_host=999.0)
        value = psnr(fused, plain)
        log(f"spaces (e) sdxl unet + controlnet (OneFormer hint) 128x128 B=2 bf16: kernels vs "
            f"plain PSNR {value:.2f} dB (bound {PSNR_BOUND})")
        check(value >= PSNR_BOUND, f"spaces (e): UNet + ControlNet PSNR ≥ {PSNR_BOUND} dB")
        del cldm, unit, p, res, witness, x, fused, plain, cond
    finally:
        if server is not None:
            for name in launched:
                server.api.space_manager.terminate(name)
            server.api.space_manager.terminate_all()
            server.shutdown()
            server.server_close()
            manager.close()
        oneformer._DETECTORS.clear()
        oneformer._DETECTORS.update(saved[0])
        densepose._DETECTOR = saved[1]
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"spaces phase 24 at {steps} steps: {time.perf_counter() - t_phase:.2f} s")
    return total


def profile_request(label: str, run):
    """One request, run(), under runtime/profiling.py `trace` (the card
    alone traced) with no file written: device time by kernel, and the busy
    share (device time over the request's wall time). → run()'s result."""
    from forge_tpu_torch.runtime import profiling

    t = time.perf_counter()
    with profiling.trace(logdir=None) as tr:
        out = run()
    kernels = sorted(tr.kernels.items(), key=lambda kv: -kv[1][1])
    busy = tr.device_s
    log(f"profile {label}: wall {tr.wall_s:.4f} s, kernel time {tr.device_s:.4f} s "
        f"({100 * tr.busy:.2f} % busy), {tr.device_events} kernel launches (the profiler's "
        f"start, stop and sums {time.perf_counter() - t - tr.wall_s:.1f} s)")
    for name, (n, secs) in kernels[:10]:
        log(f"  {n:6d} × {name[:70]:70s} {secs * 1e3:10.3f} ms {100 * secs / busy:6.2f} %")
    groups = {  # every instance of a port kernel, then the library's kernels by kind
        "gn_silu_conv3x3*": ("gn_silu_conv3x3",), "flash_fwd*": ("flash_fwd",),
        "dequant_matmul*": ("dequant_matmul",),
        "matmuls (cuBLAS, cuDNN)": ("nvjet", "gemm", "cutlass", "cudnn", "xmma"),
        "layout and dtype copies": ("direct_copy",), "reductions": ("reduce_kernel",),
        "elementwise": ("elementwise",)}
    seen = set()
    for group, marks in groups.items():
        rows = [(name, n, secs) for name, (n, secs) in kernels
                if name not in seen and any(m in name for m in marks)]
        seen.update(name for name, _, _ in rows)
        secs = sum(secs for _, _, secs in rows)
        log(f"  {group}: {sum(n for _, n, _ in rows)} launches, "
            f"{secs * 1e3:.3f} ms, {100 * secs / busy:.2f} %")
    return out


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
    global EXT_STEPS
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
                         "hook layers on SDXL) at 20 steps only, with no result")
    ap.add_argument("--controls", action="store_true",
                    help="run phase 1, phase 2's Deep Shrink rows and phase 17 (hook phases and "
                         "deferred hooks on SDXL) at 20 steps only, with no result")
    ap.add_argument("--image-prompts", action="store_true",
                    help="run phase 1, phase 2's joined-key flash rows and phase 18 (the "
                         "image-prompt family on SDXL) at 20 steps only, with no result")
    ap.add_argument("--scripts", action="store_true",
                    help="run phase 1, phase 2's SDXL and outpainting rows and phase 19 (the "
                         "script surface on SDXL) at 20 steps only, with no result")
    ap.add_argument("--extras", action="store_true",
                    help="run phase 1, phase 2's SDXL and hires rows and phase 20 (the upscalers, "
                         "the face restorers, restore_faces, the hires fix through SwinIR and "
                         "the extras routes on SDXL) at 20 steps only, with no result")
    ap.add_argument("--annotators", action="store_true",
                    help="run phase 1, phase 2's Depth Anything and SDXL rows and phase 22 (the "
                         "ControlNet annotators, Depth Anything V2 against plain flash and a "
                         "depth_anything_v2 unit on SDXL) at 20 steps only, with no result")
    ap.add_argument("--interrogate", action="store_true",
                    help="run phase 1, phase 2's BLIP, Marigold and SDXL rows and phase 23 "
                         "(interrogation, the remaining annotators, Marigold against plain, a "
                         "depth_marigold unit on SDXL, the extras route's focal crop) at 20 "
                         "steps only, with no result")
    ap.add_argument("--spaces", action="store_true",
                    help="run phase 1, phase 2's Sapiens and SDXL rows and phase 24 (OneFormer, "
                         "DensePose, Sapiens-1B at its 40 blocks against plain, the U²-Net mask, "
                         "the four port Spaces as child processes and a seg_ofade20k unit on "
                         "SDXL) at 20 steps only, with no result")
    ap.add_argument("--surface", action="store_true",
                    help="run phase 1, phase 2's SDXL rows and phase 21 (ControlNetScript, saving, "
                         "the event log and the management and web UI routes on SDXL) at 20 steps "
                         "with the full-depth merge only, with no result")
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
    seconds = {}  # phase → its seconds, printed one a line at the end

    def done(name: str, t0: float):
        seconds[name] = time.perf_counter() - t0
        log(f"{name} phase: {seconds[name]:.2f} s; script so far "
            f"{time.perf_counter() - t_start:.2f} s")

    _build.build(verbose=True)
    _build.library()
    seconds["build"] = time.perf_counter() - t
    log(f"build: {seconds['build']:.2f} s (nvcc, one process per source, "
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

    from forge_tpu_torch.runtime import logging as event_log

    # no image, grid, log.csv or params.txt written by any phase but 21 (b), which writes into a
    # temporary directory; the event log's lines go to a temporary directory too
    for key in ("samples_save", "grid_save", "save_write_params_txt"):
        opts.set(key, False)
    events_dir = tempfile.mkdtemp(prefix="chip_smoke_events_")
    atexit.register(shutil.rmtree, events_dir, True)
    event_log.configure(os.path.join(events_dir, "events.jsonl"))
    t = time.perf_counter()
    summary = phase_kernels(gen, "families" if args.families else "api" if args.api
                            else "flux_family" if args.flux_family
                            else "extensions" if args.extensions
                            else "controls" if args.controls
                            else "image_prompts" if args.image_prompts
                            else "scripts" if args.scripts
                            else "extras" if args.extras
                            else "surface" if args.surface
                            else "annotators" if args.annotators
                            else "interrogate" if args.interrogate
                            else "spaces" if args.spaces else "all")
    done("kernels (phase 2)", t)
    if args.kernels:
        log("kernels only: phases 1-2 passed")
        return
    one_phase = {"api": ("api", lambda e: phase_api(e, gen), "phases 1, 2 (the tile rows) and 14"),
                 "extensions": ("extensions", lambda e: phase_extensions(e, gen),
                                "phases 1, 2 (the StyleAlign rows) and 16"),
                 "controls": ("controls", lambda e: phase_controls(e, gen, steps=20),
                              "phases 1, 2 (the Deep Shrink rows) and 17"),
                 "image_prompts": ("image prompts", lambda e: phase_image_prompts(
                     e, gen, steps=5 * IMAGE_PROMPT_STEPS), "phases 1, 2 (the joined-key rows) and 18"),
                 "scripts": ("scripts", lambda e: phase_scripts(e, gen, steps=5 * SCRIPTS_STEPS),
                             "phases 1, 2 (the SDXL and outpainting rows) and 19"),
                 "extras": ("extras", lambda e: phase_extras(e, gen, steps=5 * EXTRAS_STEPS,
                                                             full=True),
                            "phases 1, 2 (the SDXL and hires rows) and 20"),
                 "surface": ("surface", lambda e: phase_surface(e, gen, steps=5 * SURFACE_STEPS,
                                                               full=True),
                             "phases 1, 2 (the SDXL rows) and 21"),
                 "annotators": ("annotators", lambda e: phase_annotators(
                     e, gen, steps=5 * ANNOTATORS_STEPS, full=True),
                     "phases 1, 2 (the Depth Anything and SDXL rows) and 22"),
                 "interrogate": ("interrogate", lambda e: phase_interrogate(
                     e, gen, steps=5 * INTERROGATE_STEPS, full=True),
                     "phases 1, 2 (the BLIP, Marigold and SDXL rows) and 23"),
                 "spaces": ("spaces", lambda e: phase_spaces(e, gen, steps=5 * SPACES_STEPS,
                                                             full=True),
                            "phases 1, 2 (the Sapiens and SDXL rows) and 24")}
    for flag, (name, run, what) in one_phase.items():
        if getattr(args, flag):
            if flag == "extensions":
                EXT_STEPS = EXT_FLAG_STEPS
            engine = load_sdxl()
            t = time.perf_counter()
            run(engine)
            done(name, t)
            log(f"{name} only: {what} passed")
            return
    if args.flux_family:
        t = time.perf_counter()
        phase_flux_family(gen)
        done("flux family", t)
        log("flux family only: phases 1, 2 (their rows) and 15 passed")
        return
    if args.families:
        for name in FAMILIES:
            t = time.perf_counter()
            phase_family(name, gen)
            done(name, t)
        log("families only: phases 1, 2 (their rows) and 13 passed")
        return
    t = time.perf_counter()
    engine, launches = phase_slice()
    phase_unet(engine, gen)
    del engine
    torch.cuda.empty_cache()
    done("SD1.5", t)
    t = time.perf_counter()
    flux_launches, nf4_seed1 = phase_flux()
    done("Flux", t)
    t = time.perf_counter()
    engine, sdxl_launches = phase_sdxl(gen)
    done("SDXL", t)
    paths = {"sd15": launches, "flux": flux_launches, "sdxl": sdxl_launches}
    # on the SDXL engine; phase 14 before phase 13 frees it
    for name, key, run in (("config3", "config3", phase_config3),
                           ("config5", "config5", phase_config5),
                           ("config2", "config2", phase_config2),
                           ("samplers", "samplers", lambda e, g: phase_samplers(e)),
                           ("prompts", "prompts", phase_prompts), ("api", "api", phase_api),
                           ("extensions", "extensions", phase_extensions),
                           ("controls", "controls", phase_controls),
                           ("image prompts", "image_prompts", phase_image_prompts),
                           ("scripts", "scripts", phase_scripts),
                           ("extras", "extras", phase_extras),
                           ("surface", "surface", phase_surface),
                           ("annotators", "annotators", phase_annotators),
                           ("interrogate", "interrogate", phase_interrogate),
                           ("spaces", "spaces", phase_spaces)):
        t = time.perf_counter()
        paths[key] = run(engine, gen)
        done(name, t)
    del engine
    gc.collect()  # phase 14 leaves reference cycles that hold the engine until the collector runs
    torch.cuda.empty_cache()
    for name in FAMILIES:
        t = time.perf_counter()
        paths[name] = phase_family(name, gen)
        done(name, t)
    t = time.perf_counter()
    paths.update(phase_flux_family(gen, nf4_seed1))
    done("flux family", t)

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
    for name, value in seconds.items():
        log(f"seconds {name}: {value:.2f}")
    log(f"seconds whole run: {time.perf_counter() - t_start:.2f}")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

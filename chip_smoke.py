"""Drive forge_tpu_torch's SD1.5 txt2img path once on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases; needs one CUDA device
    python3 chip_smoke.py --kernels    # phases 1-2 only (build + kernel checks), no result

Phases:
  1. device and build: `nvidia-smi` name and power limit, then the kernels
     compiled from forge_tpu_torch/csrc/*.cu with nvcc (sm_90a);
  2. each kernel against its plain PyTorch version on the card, in f32 and
     bf16, at the shapes the main path gives it, with both times;
  3. the slice at full SD1.5 width on random weights made from a seed:
     load_engine, then three process_images requests (512², Euler a,
     20 steps, CFG 7, seeds 1, 2, 1) with the launch counts of each kernel;
  4. one UNet forward through the kernels and through the plain versions.

Any failed check raises, so the exit code is not 0 and no result line is
printed. The last two lines are the per-kernel JSON summary and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

F32_BOUND = 1e-4   # max |kernel − plain| / max(|plain|, 1) in f32
BF16_BOUND = 2e-2  # the same in bf16: a few bf16 ulps of the output scale
PSNR_BOUND = 40.0  # UNet kernels vs plain, bf16 (tests/test_golden_parity.py's bar)

FLASH_SHAPES = [  # (B, H, Lq, D), Lk
    ((2, 8, 4096, 40), 4096),   # UNet level-0 self-attention, CFG batch
    ((2, 8, 1024, 80), 1024),   # UNet level-1 self-attention
    ((1, 1, 4096, 512), 4096),  # VAE mid-block single head
    ((1, 2, 1000, 40), 700),    # ragged tails on both sides
]
GN_CONV_SHAPES = [  # (B, C, H, W), O
    ((2, 320, 64, 64), 320),     # UNet level-0 resblock
    ((2, 960, 32, 32), 640),     # UNet output block after a skip concat
    ((2, 2560, 8, 8), 1280),     # UNet level-3 output block
    ((1, 512, 128, 128), 512),   # VAE decoder level 2
    ((1, 256, 512, 512), 128),   # VAE decoder level 0, first resnet
]
EXPECTED_PER_REQUEST = {"flash_attention": 201, "gn_silu_conv3x3": 908}


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


def rel_err(got: torch.Tensor, want: torch.Tensor):
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output is finite")
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1.0)


def phase_kernels(gen: torch.Generator):
    from forge_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from forge_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3, gn_silu_conv3x3_plain

    summary = {}
    for dtype, bound in ((torch.float32, F32_BOUND), (torch.bfloat16, BF16_BOUND)):
        for (b, h, lq, d), lk in FLASH_SHAPES:
            q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((b, h, lk, d), generator=gen, device="cuda").to(dtype)
            err, rel = rel_err(flash_attention(q, k, v), flash_attention_plain(q, k, v))
            ms = time_ms(lambda: flash_attention(q, k, v))
            plain_ms = time_ms(lambda: flash_attention_plain(q, k, v))
            log(f"flash_attention {str(dtype)[6:]:8s} q{(b, h, lq, d)} lk={lk}: "
                f"max_abs_err={err:.3e} rel={rel:.3e} (bound {bound:g}) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            check(rel <= bound, f"flash_attention {dtype} {(b, h, lq, d)} within {bound}")
            if dtype == torch.bfloat16 and (b, h, lq, d) == FLASH_SHAPES[0][0]:
                summary["flash_attention"] = (err, ms, plain_ms)
            del q, k, v
        for (b, c, hh, ww), o in GN_CONV_SHAPES:
            x = torch.randn((b, c, hh, ww), generator=gen, device="cuda").to(dtype)
            a = 1.0 + 0.1 * torch.randn((b, c), generator=gen, device="cuda")
            s = 0.1 * torch.randn((b, c), generator=gen, device="cuda")
            w = (torch.randn((o, c, 3, 3), generator=gen, device="cuda")
                 / math.sqrt(9 * c)).to(dtype)
            bias = 0.1 * torch.randn(o, generator=gen, device="cuda")
            err, rel = rel_err(gn_silu_conv3x3(x, a, s, w, bias),
                               gn_silu_conv3x3_plain(x, a, s, w, bias))
            ms = time_ms(lambda: gn_silu_conv3x3(x, a, s, w, bias))
            plain_ms = time_ms(lambda: gn_silu_conv3x3_plain(x, a, s, w, bias))
            log(f"gn_silu_conv3x3 {str(dtype)[6:]:8s} x{(b, c, hh, ww)}->{o}: "
                f"max_abs_err={err:.3e} rel={rel:.3e} (bound {bound:g}) "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            check(rel <= bound, f"gn_silu_conv3x3 {dtype} {(b, c, hh, ww)} within {bound}")
            if dtype == torch.bfloat16 and (b, c, hh, ww) == GN_CONV_SHAPES[0][0]:
                summary["gn_silu_conv3x3"] = (err, ms, plain_ms)
            del x, w
    torch.cuda.empty_cache()
    return summary


def phase_slice():
    from forge_tpu_torch.core.synth import synth_sd15_checkpoint
    from forge_tpu_torch.ops.flash_attention import flash_attention
    from forge_tpu_torch.ops.fused_gn_conv import gn_silu_conv3x3
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.pipeline.processing import Processing, process_images

    t0 = time.perf_counter()
    sd = synth_sd15_checkpoint(fill="random", seed=0)
    t1 = time.perf_counter()
    engine = load_engine(sd, device="cuda")
    del sd
    torch.cuda.synchronize()
    log(f"slice: synthetic SD1.5 weights {t1 - t0:.2f} s, load_engine {time.perf_counter() - t1:.2f} s, "
        f"dtype {engine.compute_dtype}")
    check(engine.compute_dtype == torch.bfloat16, "bf16 compute on CUDA")

    counters = {"flash_attention": flash_attention, "gn_silu_conv3x3": gn_silu_conv3x3}
    for fn in counters.values():
        fn.launches = 0
    images, latencies = [], []
    for seed in (1, 2, 1):
        p = Processing(prompt="a photograph of an astronaut riding a horse",
                       negative_prompt="blurry", seed=seed, steps=20, cfg_scale=7.0,
                       width=512, height=512, sampler_name="Euler a")
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
    launches = {name: fn.launches for name, fn in counters.items()}
    check(np.array_equal(images[0], images[2]), "seed 1 twice gives identical bytes")
    check(not np.array_equal(images[0], images[1]), "seeds 1 and 2 differ")
    for name, n in launches.items():
        expect = 3 * EXPECTED_PER_REQUEST[name]
        log(f"launches during the 3 requests: {name} {n} (expected {expect}: "
            f"{'matches' if n == expect else 'DIFFERS'})")
        check(n > 0, f"{name} launched on the main path")
    log("slice: seed 1 repeat byte-identical, NaN checks passed")
    return engine, launches


def phase_unet(engine, gen: torch.Generator):
    from forge_tpu_torch.ops import plain_versions

    x = torch.randn((2, 4, 64, 64), generator=gen, device=gen.device).to(engine.compute_dtype)
    t = torch.tensor([999.0, 400.0], device=gen.device)
    cond = engine.get_learned_conditioning(["a photograph of an astronaut riding a horse",
                                            "blurry"])["context"]
    apply = engine.unet_apply_fn()
    with torch.no_grad():
        fused = apply(engine.loaded.unet, x, t, cond).float()
        with plain_versions():
            plain = apply(engine.loaded.unet, x, t, cond).float()
    check(bool(torch.isfinite(fused).all()), "UNet output finite")
    mse = ((fused - plain) ** 2).mean().item()
    peak = plain.abs().max().item()
    psnr = float("inf") if mse == 0 else 10 * math.log10(peak ** 2 / mse)
    log(f"unet 64x64 B=2 bf16: kernels vs plain PSNR {psnr:.2f} dB (bound {PSNR_BOUND})")
    check(psnr >= PSNR_BOUND, f"UNet PSNR ≥ {PSNR_BOUND} dB")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true", help="run phases 1-2 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        sys.exit(2)
    from forge_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"build: {time.perf_counter() - t:.2f} s (nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas:", line.strip())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = phase_kernels(gen)
    if args.kernels:
        log("kernels only: phases 1-2 passed")
        return
    engine, launches = phase_slice()
    phase_unet(engine, gen)

    sources = {
        "flash_attention": ("forge_tpu_torch/csrc/flash_attention.cu",
                            "forge_tpu/ops/flash_attention.py:33"),
        "gn_silu_conv3x3": ("forge_tpu_torch/csrc/gn_silu_conv3x3.cu",
                            "forge_tpu/ops/fused_gn_conv.py:42"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": summary[name][0],
                "ms": summary[name][1], "plain_ms": summary[name][2]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""forge_tpu_torch's server: the REST API on the CUDA card.

    python -m forge_tpu_torch.webui --ckpt model.safetensors --port 7860

The API-only path of the root `webui.py`: find the checkpoints, load one on
the card (or on the device `--device` names), start the work queue's thread
and serve `/sdapi/v1/*` (api/server.py) until the process is stopped, or until
`/sdapi/v1/server-stop` where `--api-server-stop` allows that route. A flag
this launcher does not read raises with its name.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="forge_tpu_torch: the Stable Diffusion API on CUDA",
                                 allow_abbrev=False)
    ap.add_argument("--listen", action="store_true", help="bind 0.0.0.0 instead of 127.0.0.1")
    ap.add_argument("--port", type=int, default=7860, help="0 takes a free port")
    ap.add_argument("--api-auth", default=None,
                    help='HTTP basic auth for the API: "user:pass[,user2:pass2]"')
    ap.add_argument("--cors-allow-origins", default=None,
                    help="comma-separated list of allowed CORS origins")
    ap.add_argument("--ckpt", default=None, help="checkpoint to load at startup")
    ap.add_argument("--ckpt-dir", default="models/Stable-diffusion")
    ap.add_argument("--lora-dir", default="models/Lora")
    ap.add_argument("--embeddings-dir", default="embeddings")
    ap.add_argument("--styles-file", default="styles.csv", help="prompt styles CSV")
    ap.add_argument("--config", default="config.json", help="the options' settings file")
    ap.add_argument("--api-server-stop", action="store_true",
                    help="let the API stop the server (/sdapi/v1/server-stop, server-kill)")
    ap.add_argument("--freeze-settings", action="store_true",
                    help="refuse option changes through the API")
    ap.add_argument("--disable-nan-check", action="store_true",
                    help="skip the NaN checks on latents and images")
    ap.add_argument("--vae-dtype", choices=["auto", "bfloat16", "float32"], default="auto",
                    help="the VAE's compute dtype")
    ap.add_argument("--device", default=None,
                    help="the device engines load on (default: the CUDA card; cpu on request)")
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"forge_tpu_torch.webui: flags not ported: {' '.join(unknown)}")
    return args


def main(argv=None):
    args = parse_args(argv)
    from .api.server import CMD_FLAGS, serve
    from .runtime import styles as styles_mod
    from .runtime.models import ModelManager
    from .runtime.options import opts
    from .runtime.queue import work_queue

    CMD_FLAGS.update(vars(args))
    opts.load(args.config)
    if args.disable_nan_check:
        opts.set("disable_nan_check", True)
    if args.vae_dtype != "auto":
        opts.set("vae_dtype", args.vae_dtype)
    if args.styles_file != "styles.csv":
        styles_mod.prompt_styles = styles_mod.StyleDatabase([args.styles_file])

    models = ModelManager(checkpoint_dirs=[args.ckpt_dir], embeddings_dir=args.embeddings_dir,
                          device=args.device, lora_dirs=[args.lora_dir])
    print(f"found {len(models.checkpoints)} checkpoints in {args.ckpt_dir}", flush=True)
    with models:  # the refiner/hires resolver is the manager's until the server ends
        if args.ckpt:
            print(f"loading {args.ckpt} ...", flush=True)
            work_queue.run_and_wait(models.load, args.ckpt)
            opts.set("sd_model_checkpoint", args.ckpt)
        elif models.checkpoints:
            opts.set("sd_model_checkpoint", next(iter(models.checkpoints)))
        serve(models, "0.0.0.0" if args.listen else "127.0.0.1", args.port,
              api_auth=args.api_auth)


if __name__ == "__main__":
    sys.exit(main())

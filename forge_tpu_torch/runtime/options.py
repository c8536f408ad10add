# Copied from forge_tpu/runtime/options.py (OptionInfo, Options get/set/override, save/load/dump_registry; the keys the port reads).
"""Runtime options registry with per-request overrides.

The port registers only the options it reads, with the reference's
defaults. Reading, setting or overriding any other key raises KeyError: an
option that is not ported is refused, never stored and ignored, and a
settings file (`load`) that holds one raises as well. `save` writes the
values set, `dump_registry` every key with its default, label, section and
value (the API's GET /sdapi/v1/options).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Any, Dict, Optional


class OptionInfo:
    def __init__(self, default: Any, label: str, section: str = "general",
                 choices: Optional[list] = None):
        self.default = default
        self.label = label
        self.section = section
        self.choices = choices


class Options:
    def __init__(self):
        self._registry: Dict[str, OptionInfo] = {}
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._overrides = threading.local()

    def add(self, key: str, info: OptionInfo):
        self._registry[key] = info

    def _check(self, key: str) -> None:
        if key not in self._registry:
            raise KeyError(f"option {key!r} is not ported to forge_tpu_torch "
                           f"(ported: {', '.join(self._registry)})")

    def get(self, key: str):
        self._check(key)
        for frame in reversed(getattr(self._overrides, "stack", ())):
            if key in frame:
                return frame[key]
        with self._lock:
            return self._values.get(key, self._registry[key].default)

    def set(self, key: str, value: Any):
        self._check(key)
        with self._lock:
            self._values[key] = value

    @contextlib.contextmanager
    def override(self, values: Dict[str, Any]):
        """Per-request scoped overrides (the reference's override_settings),
        seen by the calling thread only."""
        for key in values:
            self._check(key)
        if not hasattr(self._overrides, "stack"):
            self._overrides.stack = []
        self._overrides.stack.append(dict(values))
        try:
            yield
        finally:
            self._overrides.stack.pop()


    def save(self, path: str):
        with self._lock:
            data = dict(self._values)
        with open(path, "w") as f:
            json.dump(data, f, indent=2, default=str)

    def load(self, path: str):
        """The values of a settings file `save` wrote; a missing file loads
        nothing, and a key that is not ported raises KeyError."""
        if not os.path.exists(path):
            return
        with open(path) as f:
            data = json.load(f)
        for key in data:
            self._check(key)
        with self._lock:
            self._values.update(data)

    def dump_registry(self) -> Dict[str, Dict[str, Any]]:
        return {
            k: {"default": i.default, "label": i.label, "section": i.section,
                "value": self.get(k)}
            for k, i in self._registry.items()
        }


opts = Options()

_DEFAULTS = {
    "CLIP_stop_at_last_layers": OptionInfo(1, "Clip skip", "sd"),
    "vae_dtype": OptionInfo("auto", "VAE compute dtype (--no-half-vae sets float32)", "vae",
                            ["auto", "bfloat16", "float32"]),
    "initial_noise_multiplier": OptionInfo(1.0, "img2img noise multiplier", "img2img"),
    "img2img_extra_noise": OptionInfo(0.0, "img2img extra noise", "img2img"),
    "img2img_color_correction": OptionInfo(False, "Color-correct img2img to init image",
                                           "img2img"),
    "disable_nan_check": OptionInfo(False, "Skip NaN checks after UNet/VAE", "compat"),
    "eta_ddim": OptionInfo(0.0, "Eta for DDIM", "sampler"),
    "eta_ancestral": OptionInfo(1.0, "Eta for ancestral samplers", "sampler"),
    "s_churn": OptionInfo(0.0, "Sigma churn", "sampler"),
    "s_noise": OptionInfo(1.0, "Sigma noise", "sampler"),
    "eta_noise_seed_delta": OptionInfo(0, "ENSD", "sampler"),
    "beta_dist_alpha": OptionInfo(0.6, "Beta schedule alpha", "sampler"),
    "beta_dist_beta": OptionInfo(0.6, "Beta schedule beta", "sampler"),
    "emphasis": OptionInfo("Original", "Emphasis mode", "sd",
                           ["None", "Ignore", "Original", "No norm"]),
    "s_min_uncond": OptionInfo(0.0, "NGMS: skip uncond below sigma", "perf"),
    "save_write_params_txt": OptionInfo(True, "Write params.txt after generation", "saving"),
    # saving images and grids (pipeline/images.py `save_image`, process_images)
    "samples_save": OptionInfo(True, "Always save generated images", "saving"),
    "samples_format": OptionInfo("png", "Image format", "saving", ["png", "jpg", "webp"]),
    "samples_filename_pattern": OptionInfo("", "Images filename pattern", "saving"),
    "save_images_add_number": OptionInfo(True, "Add number to filename", "saving"),
    "grid_save": OptionInfo(True, "Always save grids", "saving"),
    "grid_only_if_multiple": OptionInfo(True, "Only save grid for multiple images", "saving"),
    "n_rows": OptionInfo(-1, "Grid row count (-1 auto)", "saving"),
    "save_write_log_csv": OptionInfo(True, "Write log.csv next to saved images", "saving"),
    "save_txt": OptionInfo(False, "Write .txt infotext next to image", "saving"),
    "enable_pnginfo": OptionInfo(True, "Write infotext into images", "infotext"),
    "outdir_samples": OptionInfo("", "Output dir for all images", "paths"),
    "outdir_txt2img_samples": OptionInfo("outputs/txt2img-images", "txt2img out dir", "paths"),
    "outdir_img2img_samples": OptionInfo("outputs/img2img-images", "img2img out dir", "paths"),
    "outdir_grids": OptionInfo("", "Output dir for grids", "paths"),
    "outdir_txt2img_grids": OptionInfo("outputs/txt2img-grids", "txt2img grid dir", "paths"),
    "outdir_img2img_grids": OptionInfo("outputs/img2img-grids", "img2img grid dir", "paths"),
    "save_to_dirs": OptionInfo(True, "Save to date subdirectories", "paths"),
    "directories_filename_pattern": OptionInfo("[date]", "Directory name pattern", "paths"),
    "directories_max_prompt_words": OptionInfo(8, "Max prompt words in [prompt_words]", "paths"),
    # the web UI's localization (GET /sdapi/v1/localization) and the extension list
    "localization": OptionInfo("None", "Localization", "ui"),
    "disabled_extensions": OptionInfo([], "Disabled extensions", "extensions"),
    "disable_all_extensions": OptionInfo("none", "Disable all extensions", "extensions",
                                         ["none", "extra", "all"]),
    "add_model_name_to_info": OptionInfo(True, "Model name in infotext", "infotext"),
    "add_model_hash_to_info": OptionInfo(True, "Model hash in infotext", "infotext"),
    "add_version_to_infotext": OptionInfo(True, "Version in infotext", "infotext"),
    "infotext_styles": OptionInfo("Apply if any", "Infotext style extraction", "infotext",
                                  ["Ignore", "Apply", "Discard", "Apply if any"]),
    "sd_model_checkpoint": OptionInfo(None, "Checkpoint", "sd"),
    "sd_vae_decode_method": OptionInfo("Full", "VAE decode method", "vae", ["Full", "TAESD"]),
    "vae_always_tiled": OptionInfo(False, "NeverOOM: always use tiled VAE decode/encode", "perf"),
    "live_previews_enable": OptionInfo(True, "Live previews", "live_previews"),
    "show_progress_every_n_steps": OptionInfo(10, "Live preview period (steps; -1 = off)",
                                              "live_previews"),
    "show_progress_type": OptionInfo("Approx cheap", "Live preview method", "live_previews",
                                     ["Full", "Approx NN", "Approx cheap", "TAESD"]),
    "ESRGAN_tile": OptionInfo(192, "ESRGAN tile size (0 = no tiling)", "upscaling"),
    "ESRGAN_tile_overlap": OptionInfo(8, "ESRGAN tile overlap", "upscaling"),
    "DAT_tile": OptionInfo(192, "DAT tile size", "upscaling"),
    "DAT_tile_overlap": OptionInfo(8, "DAT tile overlap", "upscaling"),
    "SWIN_tile": OptionInfo(192, "SwinIR tile size", "upscaling"),
    "SWIN_tile_overlap": OptionInfo(8, "SwinIR tile overlap", "upscaling"),
    "face_restoration": OptionInfo(False, "Restore faces on all images", "face"),
    "face_restoration_model": OptionInfo("CodeFormer", "Face restoration model", "face",
                                         ["CodeFormer", "GFPGAN"]),
    "code_former_weight": OptionInfo(0.5, "CodeFormer weight (0 = max effect)", "face"),
    # interrogation (postprocessing/interrogate.py, the /sdapi/v1/interrogate route)
    "interrogate_return_ranks": OptionInfo(False, "Include rank of tags", "interrogate"),
    "interrogate_clip_min_length": OptionInfo(24, "BLIP min length", "interrogate"),
    "interrogate_clip_max_length": OptionInfo(48, "BLIP max length", "interrogate"),
    "interrogate_clip_dict_limit": OptionInfo(1500, "CLIP dictionary limit", "interrogate"),
    "interrogate_clip_skip_categories": OptionInfo([], "CLIP skip categories", "interrogate"),
    "interrogate_deepbooru_score_threshold": OptionInfo(0.5, "deepbooru score threshold",
                                                        "interrogate"),
    "deepbooru_sort_alpha": OptionInfo(True, "deepbooru alphabetical sort", "interrogate"),
    "deepbooru_use_spaces": OptionInfo(True, "deepbooru spaces in tags", "interrogate"),
    "deepbooru_escape": OptionInfo(True, "deepbooru escape brackets", "interrogate"),
    "deepbooru_filter_tags": OptionInfo("", "deepbooru filtered tags", "interrogate"),
}
for _k, _v in _DEFAULTS.items():
    opts.add(_k, _v)

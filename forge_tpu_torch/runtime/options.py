# Copied from forge_tpu/runtime/options.py (OptionInfo, Options get/set/override; the keys the port reads).
"""Runtime options registry with per-request overrides.

The port registers only the options it reads, with the reference's
defaults. Reading, setting or overriding any other key raises KeyError: an
option that is not ported is refused, never stored and ignored.
Persistence (`save`, `load`) and the registry dump wait for the API.
"""

from __future__ import annotations

import contextlib
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


opts = Options()

_DEFAULTS = {
    "CLIP_stop_at_last_layers": OptionInfo(1, "Clip skip", "sd"),
    "vae_dtype": OptionInfo("auto", "VAE compute dtype (--no-half-vae sets float32)", "vae",
                            ["auto", "bfloat16", "float32"]),
    "initial_noise_multiplier": OptionInfo(1.0, "img2img noise multiplier", "img2img"),
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
    "add_model_name_to_info": OptionInfo(True, "Model name in infotext", "infotext"),
    "add_model_hash_to_info": OptionInfo(True, "Model hash in infotext", "infotext"),
    "add_version_to_infotext": OptionInfo(True, "Version in infotext", "infotext"),
    "infotext_styles": OptionInfo("Apply if any", "Infotext style extraction", "infotext",
                                  ["Ignore", "Apply", "Discard", "Apply if any"]),
}
for _k, _v in _DEFAULTS.items():
    opts.add(_k, _v)

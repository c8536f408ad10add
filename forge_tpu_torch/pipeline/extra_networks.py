"""Extra networks: `<lora:name:weight>` prompt tags → weight patches (port of forge_tpu/pipeline/extra_networks.py).

Parse and strip the tags from the prompts, resolve LoRA files from the
registry, and build patched UNet and text-encoder parameter trees for this
generation (copy on write, core/patches.py: the engine's weights are never
changed). The reference's option `extra_networks_default_multiplier` takes
its default, 1.0. Given the request, `activate` records the "Lora hashes"
infotext key: each file's first MiB through sha256, 10 hex digits.
"""

from __future__ import annotations

import glob
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..core.convert import flatten
from ..core.patches import apply_patches, match_lora
from ..core.state_dict import load_state_dict

_EN_RE = re.compile(r"<(\w+):([^>]+)>")
DEFAULT_MULTIPLIER = 1.0


class ExtraNetworkParams:
    def __init__(self, kind: str, items: List[str]):
        self.kind = kind
        self.items = items
        self.name = items[0] if items else ""
        self.te_multiplier = float(items[1]) if len(items) > 1 else DEFAULT_MULTIPLIER
        self.unet_multiplier = float(items[2]) if len(items) > 2 else self.te_multiplier


def parse_prompt(prompt: str) -> Tuple[str, List[ExtraNetworkParams]]:
    found: List[ExtraNetworkParams] = []

    def repl(m):
        found.append(ExtraNetworkParams(m.group(1), m.group(2).split(":")))
        return ""

    return _EN_RE.sub(repl, prompt), found


def parse_prompts(prompts: List[str]) -> Tuple[List[str], List[ExtraNetworkParams]]:
    """Strip the tags from every prompt; the network set comes from the first
    (networks are per generation, not per image, as in the reference)."""
    cleaned: List[str] = []
    first: List[ExtraNetworkParams] = []
    for i, p in enumerate(prompts):
        c, found = parse_prompt(p)
        cleaned.append(c)
        if i == 0:
            first = found
    return cleaned, first


def _short_file_hash(path: str, _cache: Dict[str, str] = {}) -> str:
    """10 hex digits of sha256 over the file's first MiB."""
    if path not in _cache:
        import hashlib

        h = hashlib.sha256()
        with open(path, "rb") as f:
            h.update(f.read(1 << 20))
        _cache[path] = h.hexdigest()[:10]
    return _cache[path]


class LoraRegistry:
    """LoRA file discovery and a state-dict LRU (reference networks.py:56)."""

    def __init__(self, dirs: Optional[List[str]] = None, cache_size: int = 8):
        self.dirs = dirs or ["models/Lora", "models/LyCORIS"]
        self._cache: Dict[str, Any] = {}
        self._cache_order: List[str] = []
        self._cache_size = cache_size
        self._lock = threading.RLock()
        self.refresh()

    def refresh(self):
        with self._lock:
            self.available: Dict[str, str] = {}
            for d in self.dirs:
                for p in sorted(glob.glob(os.path.join(d, "**/*.safetensors"), recursive=True)):
                    self.available[os.path.splitext(os.path.basename(p))[0]] = p

    def load(self, name: str):
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            path = self.available.get(name)
            if path is None:
                raise FileNotFoundError(f"LoRA {name!r} not found in {self.dirs}")
            sd = load_state_dict(path)
            self._cache[name] = sd
            self._cache_order.append(name)
            while len(self._cache_order) > self._cache_size:
                self._cache.pop(self._cache_order.pop(0), None)
            return sd


def activate(engine, prompts: List[str], registry: Optional[LoraRegistry] = None,
             p=None) -> Tuple[List[str], Any, Dict[str, Any]]:
    """→ (cleaned prompts, UNet params, {text engine name: patched params}).
    Without LoRA tags or a registry the UNet params are the engine's own.
    With the request `p`, its "Lora hashes" infotext key is recorded."""
    cleaned, networks = parse_prompts(prompts)
    loras = [n for n in networks if n.kind in ("lora", "lyco")]
    if not loras or registry is None:
        return cleaned, engine.loaded.unet, {}

    if p is not None:
        hashes = {n.name: _short_file_hash(registry.available[n.name]) for n in loras
                  if registry.available.get(n.name)}
        if hashes:
            p.extra_generation_params["Lora hashes"] = ", ".join(
                f"{k}: {v}" for k, v in hashes.items())

    unet_keys = flatten(engine.loaded.unet).keys()
    te_keys = {name: flatten(te.params).keys() for name, te in engine.text_engines.items()}
    unet_sets = []
    te_sets: Dict[str, list] = {name: [] for name in te_keys}
    for n in loras:
        matched, unmatched = match_lora(registry.load(n.name), unet_keys, te_keys_by_name=te_keys)
        if unmatched:
            print(f"lora {n.name}: {len(unmatched)} unmatched modules")
        unet_sets.append((matched["unet"], n.unet_multiplier))
        for te_name in te_keys:
            patches = matched.get(f"te:{te_name}", {})
            if patches:
                te_sets[te_name].append((patches, n.te_multiplier))

    patched_unet = apply_patches(engine.loaded.unet, unet_sets)
    patched_tes = {name: apply_patches(engine.text_engines[name].params, sets)
                   for name, sets in te_sets.items() if sets}
    return cleaned, patched_unet, patched_tes

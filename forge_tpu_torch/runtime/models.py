# Copied from forge_tpu/runtime/models.py (CheckpointInfo and ModelManager); engines load through the port's load_engine.
"""Checkpoint registry and the engine's lifecycle.

Scan the checkpoint directories, keep one live engine, and load again only
when the loading key (path, VAE, keyword arguments) changes; the refiner and
hires checkpoints a request names are resolved beside it
(`processing.ENGINE_RESOLVER`), at most two at a time. The manager installs
that resolver when it is made and `close()` (or leaving its `with` block)
puts back the one it replaced. Engines load on the CUDA card unless the
manager was given another device. `load(name, vae=path)` loads the
checkpoint with that VAE file in place of its own (core/loader.py
`additional_modules`).
"""

from __future__ import annotations

import glob
import hashlib
import os
import threading
from typing import Dict, List, Optional

from ..pipeline.engine import DiffusionEngine, load_engine
from ..pipeline.extra_networks import LoraRegistry

_EXTS = (".safetensors", ".ckpt", ".sft", ".pt")


class CheckpointInfo:
    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(path)
        self.title = self.name
        self._hash: Optional[str] = None

    def short_hash(self) -> str:
        """sha256 of the file's first MiB and its size, 10 hex digits."""
        if self._hash is None:
            h = hashlib.sha256()
            with open(self.path, "rb") as f:
                h.update(f.read(1 << 20))
                h.update(str(os.path.getsize(self.path)).encode())
            self._hash = h.hexdigest()[:10]
        return self._hash


class ModelManager:
    def __init__(self, checkpoint_dirs: Optional[List[str]] = None,
                 vae_dirs: Optional[List[str]] = None,
                 embeddings_dir: Optional[str] = None, device=None,
                 lora_dirs: Optional[List[str]] = None):
        self.checkpoint_dirs = checkpoint_dirs or ["models/Stable-diffusion"]
        self.vae_dirs = vae_dirs or ["models/VAE"]
        self.embeddings_dir = embeddings_dir
        self.device = device  # None: the CUDA card (load_engine's default)
        # the `<lora:name:weight>` tags of every engine loaded here resolve in lora_dirs
        self.lora_registry = LoraRegistry(lora_dirs) if lora_dirs else None
        self._lock = threading.RLock()
        self._engine: Optional[DiffusionEngine] = None
        self._loading_key: Optional[tuple] = None
        self._aux_engines: Dict[str, DiffusionEngine] = {}  # the refiner's and hires'
        self.checkpoints: Dict[str, CheckpointInfo] = {}
        self.refresh()
        from ..pipeline import processing

        self._replaced_resolver = processing.ENGINE_RESOLVER
        processing.ENGINE_RESOLVER = self.resolve_aux

    def close(self):
        """Put back the `processing.ENGINE_RESOLVER` this manager replaced
        (if it is still this manager's) and drop its engines."""
        from ..pipeline import processing

        if processing.ENGINE_RESOLVER == self.resolve_aux:
            processing.ENGINE_RESOLVER = self._replaced_resolver
        with self._lock:
            self._engine = None
            self._loading_key = None
            self._aux_engines.clear()

    def __enter__(self) -> "ModelManager":
        return self

    def __exit__(self, *exc):
        self.close()

    def _load(self, path: str, **kwargs) -> DiffusionEngine:
        eng = load_engine(path, device=self.device, embeddings_dir=self.embeddings_dir, **kwargs)
        eng.lora_registry = self.lora_registry
        return eng

    def resolve_aux(self, name: str) -> DiffusionEngine:
        """The engine for a refiner or hires checkpoint, kept beside the
        primary one (at most two)."""
        info = self.find(name)
        if info is None:
            raise FileNotFoundError(f"checkpoint {name!r} not found")
        with self._lock:
            if info.path in self._aux_engines:
                return self._aux_engines[info.path]
        eng = self._load(info.path)
        with self._lock:
            while len(self._aux_engines) >= 2:
                self._aux_engines.pop(next(iter(self._aux_engines)))
            self._aux_engines[info.path] = eng
        return eng

    def refresh(self):
        with self._lock:
            self.checkpoints = {}
            for d in self.checkpoint_dirs:
                for ext in _EXTS:
                    for p in sorted(glob.glob(os.path.join(d, f"**/*{ext}"), recursive=True)):
                        info = CheckpointInfo(p)
                        self.checkpoints[info.name] = info

    def list_vaes(self) -> List[str]:
        out = []
        for d in self.vae_dirs:
            for ext in _EXTS:
                out += sorted(glob.glob(os.path.join(d, f"**/*{ext}"), recursive=True))
        return out

    def find(self, name_or_path: str) -> Optional[CheckpointInfo]:
        if name_or_path in self.checkpoints:
            return self.checkpoints[name_or_path]
        for info in self.checkpoints.values():
            if name_or_path in (info.path, info.title) or info.name.startswith(name_or_path):
                return info
        if os.path.exists(name_or_path):
            return CheckpointInfo(name_or_path)
        return None

    @property
    def engine(self) -> Optional[DiffusionEngine]:
        return self._engine

    def set_engine(self, engine: DiffusionEngine):
        with self._lock:
            self._engine = engine
            self._loading_key = ("external",)

    def load(self, name_or_path: str, vae: Optional[str] = None, **kwargs) -> DiffusionEngine:
        """The engine of a checkpoint by name or path (load_engine's keyword
        arguments pass through), loaded again only when its key changes; `vae`,
        a VAE file, replaces the checkpoint's VAE."""
        info = self.find(name_or_path)
        if info is None:
            raise FileNotFoundError(f"checkpoint {name_or_path!r} not found")
        key = (info.path, vae, tuple(sorted(kwargs.items())))
        with self._lock:
            if key == self._loading_key and self._engine is not None:
                return self._engine
            self._engine = None  # the old engine's memory goes before the new one loads
            self._engine = self._load(info.path, additional_modules={"vae": vae} if vae else None,
                                      **kwargs)
            # the model's identity for the infotext
            self._engine.checkpoint_name = info.name
            self._engine.checkpoint_hash = info.short_hash()
            self._loading_key = key
            return self._engine

    def unload(self):
        with self._lock:
            self._engine = None
            self._loading_key = None

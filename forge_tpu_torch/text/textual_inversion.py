# Copied from forge_tpu/text/textual_inversion.py (the database, the loaders, create_embedding), on torch.
"""Textual-inversion embedding database.

Loads .safetensors / .pt / .bin embeddings in the webui `string_to_param`
format, the SDXL dual {clip_l, clip_g} format, `emb_params` and a single
tensor, and matches them against token streams by their tokenized trigger
name (the longest trigger first), so prompts splice learned vectors into the
CLIP input embedding sequence (text/engine.py). `.pt` files load through
`torch.load(weights_only=True)` (core/state_dict.py), which keeps the
webui format's nested `string_to_param` dict.

`vectors_for(which)` gives the vectors for a tower ("l" CLIP-L, "g"
CLIP-G): an embedding with no `clip_g` vectors falls back to its primary
ones on CLIP-G, as the reference's `find` does; the text engine then refuses
a width that is not its tower's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.state_dict import load_state_dict


class Embedding:
    def __init__(self, name: str, vectors: np.ndarray, vectors_g: Optional[np.ndarray] = None):
        self.name = name
        self.vectors = vectors  # [n_tokens, dim] for the primary (CLIP-L) encoder
        self.vectors_g = vectors_g  # SDXL's second encoder, if present

    def vectors_for(self, which: str) -> np.ndarray:
        return self.vectors_g if which == "g" and self.vectors_g is not None else self.vectors


def _extract(sd: dict) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    if "string_to_param" in sd:  # webui .pt format
        param = next(iter(sd["string_to_param"].values()))
        return np.asarray(param, dtype=np.float32), None
    if "clip_l" in sd or "clip_g" in sd:  # SDXL dual format
        l = np.asarray(sd["clip_l"], dtype=np.float32) if "clip_l" in sd else None
        g = np.asarray(sd["clip_g"], dtype=np.float32) if "clip_g" in sd else None
        return l, g
    if "emb_params" in sd:
        return np.asarray(sd["emb_params"], dtype=np.float32), None
    if len(sd) == 1:
        v = next(iter(sd.values()))
        if hasattr(v, "shape"):
            return np.asarray(v, dtype=np.float32), None
    return None, None


class EmbeddingDatabase:
    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.embeddings: Dict[str, Embedding] = {}
        self.by_first_id: Dict[int, List[Tuple[List[int], Embedding]]] = {}
        self.version = 0  # bumped on every change; part of the cond cache's key

    def register(self, name: str, vectors: np.ndarray, vectors_g=None):
        self.version += 1
        emb = Embedding(name, np.atleast_2d(vectors), vectors_g)
        self.embeddings[name] = emb
        ids = list(self.tokenizer.ids(name))
        if ids:
            self.by_first_id.setdefault(ids[0], []).append((ids, emb))
            self.by_first_id[ids[0]].sort(key=lambda e: -len(e[0]))  # longest trigger first

    def load_dir(self, path: str):
        if not os.path.isdir(path):
            return
        for fname in sorted(os.listdir(path)):
            stem, ext = os.path.splitext(fname)
            if ext.lower() not in (".safetensors", ".pt", ".bin"):
                continue
            try:
                sd = load_state_dict(os.path.join(path, fname))
                vec_l, vec_g = _extract(sd)
                if vec_l is not None or vec_g is not None:
                    self.register(stem, vec_l if vec_l is not None else vec_g, vec_g)
            except Exception:
                continue

    def match(self, tokens: List[int], offset: int):
        """The embedding whose trigger's token run starts at `offset` →
        (embedding, consumed tokens), or None."""
        for ids, emb in self.by_first_id.get(tokens[offset], ()):
            if tokens[offset:offset + len(ids)] == ids:
                return emb, len(ids)
        return None

    def find(self, tokens: List[int], offset: int, which: str = "l"):
        """The chunker's lookup: → (vectors, consumed tokens) or None."""
        hit = self.match(tokens, offset)
        if hit is None:
            return None
        emb, consumed = hit
        return emb.vectors_for(which), consumed


def create_embedding(engine, name: str, num_vectors: int = 1,
                     init_text: str = "*", overwrite: bool = False,
                     out_dir: str = "embeddings") -> str:
    """Create a textual-inversion embedding initialised from the token
    embeddings of `init_text` and save it in the `emb_params` safetensors
    format the loader reads back → the saved path. Only the rows of the
    init text's tokens leave the engine's device."""
    from ..core.save import save_safetensors

    safe = "".join(c for c in name if c.isalnum() or c in "._- ").strip()
    if not safe:
        raise ValueError(f"embedding name {name!r} has no legal characters")
    path = os.path.join(out_dir, safe + ".safetensors")
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists (pass overwrite)")

    te = None
    for cand in ("clip_l", "clip", "open_clip_h", "open_clip_g"):
        if cand in getattr(engine, "text_engines", {}):
            te = engine.text_engines[cand]
            break
    if te is None:
        te = next(iter(engine.text_engines.values()))
    table = _token_table(te.params)
    vec = np.zeros((max(int(num_vectors), 1), table.shape[1]), np.float32)
    if init_text:
        ids = list(te.tokenizer.ids(init_text))
        if ids:
            rows = torch.as_tensor(ids, dtype=torch.long, device=table.device)
            emb = table[rows].float().cpu().numpy()
            for i in range(vec.shape[0]):
                vec[i] = emb[i * len(ids) // vec.shape[0]]
    os.makedirs(out_dir, exist_ok=True)
    save_safetensors({"emb_params": vec}, path)
    return path


def _token_table(params):
    """The token-embedding weight of an HF-layout CLIP tree."""
    node = params
    for key in ("text_model", "embeddings", "token_embedding", "weight"):
        if isinstance(node, dict) and key in node:
            node = node[key]
    if hasattr(node, "shape") and len(getattr(node, "shape", ())) == 2:
        return node
    raise ValueError("text encoder has no token_embedding table")

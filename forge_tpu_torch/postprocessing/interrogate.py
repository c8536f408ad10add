"""The CLIP interrogator: image → a prompt-like caption from ranked category
terms (port of forge_tpu/postprocessing/interrogate.py).

The reference's InterrogateModels, its CLIP half (modules/interrogate.py:
48-200): the image through CLIP's vision tower (models/clipvision.py), the
candidate terms through its text tower (models/clip.py and
`clip_pooled_projection`), ranked by cosine similarity, and the top term of
each category joined as "medium, artist, movement, flavor, …". Where
models/BLIP holds a checkpoint and `vocab.txt`, the BLIP caption
(models/blip.py) leads.

The categories are `models/interrogate/*.txt` (artists.txt, flavors.txt,
mediums.txt, movements.txt: one term a line). The CLIP weights: the first
full CLIP checkpoint (both towers and both projections, the HF CLIPModel
keys of openai's ViT-L/14) under models/interrogate or
models/clip_interrogator. They live on the card unless `device` is given,
in `dtype` (DTYPE on the card, f32 on the CPU).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_CATEGORY_ORDER = ("mediums", "artists", "movements", "flavors")


# Copied from forge_tpu/postprocessing/interrogate.py (load_categories).
def load_categories(dirname: str = "models/interrogate") -> Dict[str, List[str]]:
    cats = {}
    for path in sorted(glob.glob(os.path.join(dirname, "*.txt"))):
        name = os.path.splitext(os.path.basename(path))[0]
        with open(path, encoding="utf8") as f:
            terms = [ln.strip() for ln in f if ln.strip()]
        if name == "artists":
            terms = [f"by {t}" for t in terms]
        if terms:
            cats[name] = terms
    return cats


class ClipInterrogator:
    DTYPE = torch.bfloat16  # each category's top term equal to f32's on an H100 (PERF.md §4)
    TEXT_BATCH = 256  # terms through the text tower at once

    def __init__(self, model_dirs=("models/interrogate", "models/clip_interrogator"),
                 params=None, tokenizer=None, device=None, dtype: Optional[torch.dtype] = None):
        self.model_dirs = model_dirs
        self._params = params
        self._tokenizer = tokenizer
        self.device = device
        self.dtype = dtype
        self._text_cache: Dict[str, np.ndarray] = {}

    def _find_checkpoint(self) -> Optional[str]:
        for d in self.model_dirs:
            for ext in ("*.safetensors", "*.pt", "*.ckpt", "*.bin"):
                hits = sorted(glob.glob(os.path.join(d, ext)))
                if hits:
                    return hits[0]
        return None

    @property
    def available(self) -> bool:
        return self._params is not None or self._find_checkpoint() is not None

    def placement(self):
        from ..core.device import placement

        return placement(self.device, self.dtype, self.DTYPE)

    def _load(self):
        if self._params is None:
            from ..core.convert import nest, tree_to
            from ..core.state_dict import load_state_dict

            path = self._find_checkpoint()
            if path is None:
                raise FileNotFoundError("no CLIP checkpoint for interrogation")
            self._params = tree_to(nest(load_state_dict(path)), *self.placement())
        if self._tokenizer is None:
            from ..text.tokenizer import default_tokenizer

            self._tokenizer = default_tokenizer()
        return self._params

    # -- embedding ----------------------------------------------------------------------

    @torch.no_grad()
    def image_embed(self, image: np.ndarray) -> np.ndarray:
        from ..models.clipvision import clip_vision_apply, preprocess

        params = self._load()
        leaf = params["visual_projection"]["weight"]
        projected, _, _ = clip_vision_apply(params, preprocess(image).to(leaf.device, leaf.dtype))
        v = projected.float().cpu().numpy()[0]
        return v / (np.linalg.norm(v) + 1e-8)

    @torch.no_grad()
    def text_embeds(self, texts: List[str]) -> np.ndarray:
        from ..models.clip import clip_pooled_projection, clip_text_apply

        params = self._load()
        device = params["text_projection"]["weight"].device
        missing = [t for t in dict.fromkeys(texts) if t not in self._text_cache]
        for start in range(0, len(missing), self.TEXT_BATCH):
            chunk = missing[start:start + self.TEXT_BATCH]
            ids = np.full((len(chunk), 77), 49407, np.int64)
            for i, t in enumerate(chunk):
                toks = [49406] + list(self._tokenizer.ids(t))[:75] + [49407]
                ids[i, :len(toks)] = toks
            _, _, pooled = clip_text_apply(params, torch.from_numpy(ids).to(device))
            proj = clip_pooled_projection(params, pooled).float().cpu().numpy()
            proj /= np.linalg.norm(proj, axis=-1, keepdims=True) + 1e-8
            for t, v in zip(chunk, proj):
                self._text_cache[t] = v
        return np.stack([self._text_cache[t] for t in texts])

    # Copied from forge_tpu/postprocessing/interrogate.py (rank, interrogate).
    def rank(self, image_embed: np.ndarray, texts: List[str],
             top_count: int = 1) -> List[Tuple[str, float]]:
        """Cosine ranking (reference interrogate.py:136-158 rank)."""
        if not texts:
            return []
        sims = self.text_embeds(texts) @ image_embed
        order = np.argsort(sims)[::-1][:top_count]
        # the reference scales the similarity ×100 into a percent-like confidence
        return [(texts[i], float(sims[i] * 100)) for i in order]

    def interrogate(self, image: np.ndarray,
                    categories: Optional[Dict[str, List[str]]] = None) -> str:
        """→ the caption (reference interrogate.py:160-200)."""
        from ..models.blip import get_blip
        from ..runtime.options import opts

        include_ranks = bool(opts.get("interrogate_return_ranks"))
        threshold = 0.0
        cats = categories if categories is not None else load_categories()
        emb = self.image_embed(image)
        parts: List[str] = []
        # the BLIP caption leads where the model is installed (reference interrogate.py:184)
        blip = get_blip(self.device)
        if blip.available:
            try:
                parts.append(blip.caption(
                    image, max_length=max(int(opts.get("interrogate_clip_max_length")),
                                          int(opts.get("interrogate_clip_min_length")))))
            except Exception as e:
                print(f"BLIP caption failed: {e}")
        dict_limit = int(opts.get("interrogate_clip_dict_limit"))
        skip = {x.strip() for x in
                str(opts.get("interrogate_clip_skip_categories") or "").split(",") if x.strip()}
        for name in _CATEGORY_ORDER:
            terms = cats.get(name)
            if not terms or name in skip:
                continue
            if dict_limit:
                terms = terms[:dict_limit]
            for term, score in self.rank(emb, terms):
                if score >= threshold:
                    parts.append(f"({term}:{score / 100:.3f})" if include_ranks else term)
        for name, terms in cats.items():
            if name not in _CATEGORY_ORDER and terms and name not in skip:
                if dict_limit:
                    terms = terms[:dict_limit]
                for term, score in self.rank(emb, terms):
                    parts.append(f"({term}:{score / 100:.3f})" if include_ranks else term)
        return ", ".join(parts) if parts else "<no categories installed>"


_INTERROGATOR: Optional[ClipInterrogator] = None


def get_interrogator(device=None) -> ClipInterrogator:
    global _INTERROGATOR
    if _INTERROGATOR is None:
        _INTERROGATOR = ClipInterrogator(device=device)
    return _INTERROGATOR

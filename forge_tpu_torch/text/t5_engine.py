"""T5 text engine for Flux and SD3: prompts → T5 features (port of forge_tpu/text/t5_engine.py).

Emphasis-weighted T5 encoding, one window per prompt (no 75-token chunks):
each emphasis segment is tokenized on its own, EOS (id 1) ends the prompt,
and the ids are padded with 0 to `max_length` (Flux 512, SD3 77). Pad keys are masked
except the first position. Emphasis mode "Original" scales each token's
features by its weight, then restores the mean of the whole batch.
"""

from __future__ import annotations

from typing import Any, List, Mapping

import numpy as np
import torch

from ..models.t5 import t5_apply
from .emphasis import parse_prompt_attention
from .t5_tokenizer import default_t5_tokenizer

EOS = 1
MAX_LENGTH = 512  # the reference pads every Flux prompt to this many tokens


class T5TextEngine:
    """The reference's emphasis mode keeps its default here: "Original"."""

    def __init__(self, params: Mapping[str, Any], max_length: int = MAX_LENGTH):
        self.params = params
        self.tokenizer = default_t5_tokenizer()
        self.max_length = max_length

    def tokenize(self, prompts: List[str]):
        """→ (ids [B, max_length] int64, multipliers [B, max_length] f32)."""
        ids_out = np.zeros((len(prompts), self.max_length), np.int64)  # pad id 0
        mults_out = np.ones((len(prompts), self.max_length), np.float32)
        for i, prompt in enumerate(prompts):
            ids: List[int] = []
            mults: List[float] = []
            for text, weight in parse_prompt_attention(prompt):
                if text == "BREAK" and weight == -1.0:
                    continue
                seg = self.tokenizer(text)
                ids += seg
                mults += [weight] * len(seg)
            ids = ids[: self.max_length - 1] + [EOS]
            mults = mults[: self.max_length - 1] + [1.0]
            ids_out[i, : len(ids)] = ids
            mults_out[i, : len(mults)] = mults
        return ids_out, mults_out

    @torch.no_grad()
    def __call__(self, prompts: List[str]) -> torch.Tensor:
        """→ z [B, max_length, D] (T5 has no pooled output)."""
        ids, mults = self.tokenize(prompts)
        dev = self.params["shared"]["weight"].device
        ids = torch.from_numpy(ids).to(dev)
        mults = torch.from_numpy(mults).to(dev)
        mask = ids != 0
        mask[:, 0] = True  # an empty prompt still attends to itself
        z = t5_apply(self.params, ids, attention_mask=mask)
        original_mean = z.mean()
        z = z * mults[..., None].to(z.dtype)
        new_mean = z.mean()
        return z * torch.where(new_mean == 0, torch.ones_like(new_mean), original_mean / new_mean)

"""Classic (CLIP) text engine: prompts → conditioning (port of forge_tpu/text/engine.py).

Emphasis parse → 75-token chunks → per-chunk CLIP encode with clip-skip (or,
for SDXL's and SD3's towers, a fixed hidden layer) → emphasis application →
chunk concat. Returns (cond [B, 77·n, D], pooled [B, Dp]); the pooled output is
always the true final layer's at EOT, projected for CLIP-G.

Textual inversion: with an `embedding_db` (text/textual_inversion.py) a
trigger word's tokens give way to its vectors for this tower
(`which_embedding`, "l" or "g"). Only the prompt's rows of the token table
are gathered, on the table's device, and the vectors written into them
there. An embedding whose width is not the tower's raises ValueError
naming both widths (the reference truncates a wider one and fails in numpy
on a narrower one). The emphasis mode is the `emphasis` option's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from ..models.clip import ClipConfig, clip_pooled_projection, clip_text_apply
from ..ops import nn
from ..runtime.options import opts
from .chunking import CHUNK_LEN, tokenize_line
from .emphasis import apply_emphasis


@dataclasses.dataclass
class TextEncoderOptions:
    """The reference's options this port sets; the comma backtrack (20)
    keeps its default."""
    clip_skip: int = 1
    # "last" (clip-skip aware) | "hidden": hidden state `layer_idx`, with the final
    # LayerNorm where `final_layer_norm` (SDXL and SD3: the penultimate layer, no LayerNorm)
    layer: str = "last"
    layer_idx: int = -2
    final_layer_norm: bool = False
    pooled_projection: bool = False  # CLIP-G text_projection
    which_embedding: str = "l"  # the textual-inversion slot: "l" (CLIP-L) or "g" (CLIP-G)


class ClassicTextEngine:
    def __init__(self, params: Mapping[str, Any], tokenizer,
                 options: Optional[TextEncoderOptions] = None,
                 cfg: Optional[ClipConfig] = None, embedding_db=None):
        self.params = params
        self.tokenizer = tokenizer
        self.opts = options or TextEncoderOptions()
        self.cfg = cfg
        self.embedding_db = embedding_db

    def _lookup(self):
        """The chunker's textual-inversion lookup for this tower, or None."""
        db = self.embedding_db
        if db is None:
            return None
        width = self.params["text_model"]["embeddings"]["token_embedding"]["weight"].shape[1]
        which = self.opts.which_embedding

        def lookup(tokens, offset):
            hit = db.match(tokens, offset)
            if hit is None:
                return None
            emb, consumed = hit
            vec = emb.vectors_for(which)
            if vec.shape[-1] != width:
                raise ValueError(f"embedding {emb.name!r} has {vec.shape[-1]}-wide vectors for "
                                 f"slot {which!r}; this text encoder is {width} wide")
            return vec, consumed

        return lookup

    def tokenize_batch(self, prompts: List[str]):
        lookup = self._lookup()
        all_chunks = []
        max_chunks = 1
        for prompt in prompts:
            chunks, _ = tokenize_line(prompt, self.tokenizer, embedding_lookup=lookup)
            all_chunks.append(chunks)
            max_chunks = max(max_chunks, len(chunks))
        return all_chunks, max_chunks

    def __call__(self, prompts: List[str], max_chunks: Optional[int] = None):
        """Encode prompts → (cond [B, 77·n, D], pooled [B, D]); `max_chunks`
        lets the caller give cond and uncond the same length."""
        all_chunks, natural_max = self.tokenize_batch(prompts)
        n_chunks = max(natural_max, max_chunks or 1)

        bos, eos = self.tokenizer.bos, self.tokenizer.eos
        tokens = np.full((len(prompts), n_chunks, CHUNK_LEN + 2), eos, dtype=np.int64)
        mults = np.ones((len(prompts), n_chunks, CHUNK_LEN + 2), dtype=np.float32)
        tokens[:, :, 0] = bos  # chunks past a prompt's end stay [bos, eos, eos, ...]
        fixes = []  # (row of the flat batch, offset, vectors)
        for b, chunks in enumerate(all_chunks):
            for ci, ch in enumerate(chunks):
                tokens[b, ci, 1:-1] = ch.tokens
                mults[b, ci, 1:-1] = ch.multipliers
                fixes += [(b * n_chunks + ci, off + 1, vec) for off, vec in ch.fixes]

        table = self.params["text_model"]["embeddings"]["token_embedding"]["weight"]
        flat_tokens = torch.from_numpy(tokens.reshape(-1, CHUNK_LEN + 2)).to(table.device)
        flat_mults = torch.from_numpy(mults.reshape(-1, CHUNK_LEN + 2)).to(table.device)
        z, pooled = self._encode(flat_tokens, flat_mults, fixes)
        b, n = tokens.shape[0], tokens.shape[1]
        z = z.reshape(b, n * (CHUNK_LEN + 2), -1)
        pooled = pooled.reshape(b, n, -1)[:, 0]  # pooled from the first chunk
        return z, pooled

    @torch.no_grad()
    def _encode(self, flat_tokens: torch.Tensor, flat_mults: torch.Tensor, fixes=()):
        params, o = self.params, self.opts
        input_embeds = None
        if fixes:  # the prompt's rows of the token table, the vectors written over them
            table = params["text_model"]["embeddings"]["token_embedding"]["weight"]
            input_embeds = torch.nn.functional.embedding(flat_tokens, table)
            seq = input_embeds.shape[1]
            for row, off, vec in fixes:
                k = min(vec.shape[0], seq - off)
                input_embeds[row, off:off + k] = torch.tensor(vec[:k]).to(input_embeds)
        final, hiddens, pooled = clip_text_apply(params, flat_tokens, cfg=self.cfg,
                                                 input_embeds=input_embeds)
        if o.layer == "hidden":
            z = hiddens[o.layer_idx]
            if o.final_layer_norm:
                z = nn.layer_norm(z, params["text_model"]["final_layer_norm"])
        elif o.clip_skip > 1:
            z = nn.layer_norm(hiddens[-o.clip_skip], params["text_model"]["final_layer_norm"])
        else:
            z = final
        if o.pooled_projection:  # pooled: the true final layer at EOT
            pooled = clip_pooled_projection(params, pooled)
        return apply_emphasis(z, flat_mults, opts.get("emphasis")), pooled

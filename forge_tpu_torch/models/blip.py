"""BLIP image captioner: a ViT-B/16 encoder and a BERT decoder with
cross-attention (port of forge_tpu/models/blip.py).

The reference interrogator's caption model (modules/interrogate.py:48-98;
salesforce BLIP's blip_decoder, vit.py VisionTransformer + med.py BertLMHead).
The weights keep the released checkpoint's keys, nested (`visual_encoder.*`,
`text_decoder.bert.*`, `text_decoder.cls.*`), in torch layout.

`vit_encode`'s attention goes through ops/attention.py: at 384² the
encoder sees 24² patches and the class token, 577 tokens, so each of its
12 blocks is one flash-attention launch on the card, q(1,12,577,64). The
decoder's attention carries the causal and pad mask and stays plain, as
the reference's does. Decoding is greedy (the reference's generate with
sample=False and one beam): each step runs the decoder over the whole
`max_length` token buffer, as the reference's `lax.scan` does, and takes
the argmax at the step's position; after [SEP] the buffer holds PAD.
The WordPiece vocabulary is `vocab.txt` beside the checkpoint (BERT's
bert-base-uncased list; the [DEC] token is id 30522, past its end).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nn
from ..ops.attention import attention

_BOS = 30522  # BLIP's [DEC] token, appended to the BERT vocabulary
_SEP = 102    # BERT's [SEP] ends the caption
_PAD = 0


# -- the ViT encoder (BLIP vit.py: pre-norm, joint qkv) ---------------------------------


def _vit_block(p: Mapping[str, Any], x: torch.Tensor, heads: int) -> torch.Tensor:
    h = nn.layer_norm(x, p["norm1"])
    q, k, v = nn.linear(h, p["attn"]["qkv"]).chunk(3, dim=-1)
    x = x + nn.linear(attention(q, k, v, heads=heads), p["attn"]["proj"])
    h = nn.layer_norm(x, p["norm2"])
    return x + nn.linear(F.gelu(nn.linear(h, p["mlp"]["fc1"])), p["mlp"]["fc2"])


def vit_encode(p: Mapping[str, Any], img: torch.Tensor, heads: int = 12) -> torch.Tensor:
    """img [B,3,H,W] (normalized) → visual tokens [B, 1+N, C]."""
    proj = p["patch_embed"]["proj"]
    x = nn.conv2d(img.to(proj["weight"].dtype), proj, stride=int(proj["weight"].shape[-1]))
    b, c = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p["cls_token"].reshape(1, 1, c).expand(b, 1, c).to(x.dtype), x], dim=1)
    x = x + p["pos_embed"].reshape(1, -1, c)[:, : x.shape[1]].to(x.dtype)
    for i in range(len(p["blocks"])):
        x = _vit_block(p["blocks"][str(i)], x, heads)
    return nn.layer_norm(x, p["norm"])


# -- the BERT decoder with cross-attention (BLIP med.py, is_decoder=True) -----------------


def _bert_attn(p: Mapping[str, Any], x: torch.Tensor, kv: torch.Tensor, heads: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    b, lq, c = x.shape
    d = c // heads

    def split(t):
        return t.reshape(b, -1, heads, d).transpose(1, 2)

    q = split(nn.linear(x, p["self"]["query"]))
    k = split(nn.linear(kv, p["self"]["key"]))
    v = split(nn.linear(kv, p["self"]["value"]))
    s = ((q * d ** -0.5) @ k.transpose(-1, -2)).float()
    if mask is not None:
        s = s + mask
    h = (torch.softmax(s, dim=-1).to(v.dtype) @ v).transpose(1, 2).reshape(b, lq, c)
    return nn.layer_norm(x + nn.linear(h, p["output"]["dense"]), p["output"]["LayerNorm"])


def bert_decode_logits(p: Mapping[str, Any], tokens: torch.Tensor, visual: torch.Tensor,
                       heads: int = 12) -> torch.Tensor:
    """tokens [B,L] int (PAD masked), visual [B,Lv,C] → logits [B,L,V] f32."""
    bert = p["bert"]
    emb = bert["embeddings"]
    table = emb["word_embeddings"]["weight"]
    l = tokens.shape[1]
    x = F.embedding(tokens, table) + emb["position_embeddings"]["weight"][:l][None]
    x = nn.layer_norm(x, emb["LayerNorm"])
    ar = torch.arange(l, device=tokens.device)
    causal = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9)[None, None]
    pad = torch.where(tokens > 0, 0.0, -1e9)[:, None, None, :]
    mask = (causal + pad).float()
    visual = visual.to(x.dtype)
    for i in range(len(bert["encoder"]["layer"])):
        lp = bert["encoder"]["layer"][str(i)]
        x = _bert_attn(lp["attention"], x, x, heads, mask)
        if "crossattention" in lp:
            x = _bert_attn(lp["crossattention"], x, visual, heads)
        h = nn.linear(F.gelu(nn.linear(x, lp["intermediate"]["dense"])), lp["output"]["dense"])
        x = nn.layer_norm(x + h, lp["output"]["LayerNorm"])
    cls = p["cls"]["predictions"]
    h = nn.layer_norm(F.gelu(nn.linear(x, cls["transform"]["dense"])),
                      cls["transform"]["LayerNorm"])
    logits = nn.linear(h, cls["decoder"]).float()
    # HF's BERT ties cls.predictions.bias to decoder.bias: added only where the decoder has none
    if "bias" not in cls["decoder"] and "bias" in cls and not isinstance(cls["bias"], Mapping):
        logits = logits + cls["bias"].float()
    return logits


@torch.no_grad()
def blip_caption_ids(params: Mapping[str, Any], img: torch.Tensor, prompt_ids: np.ndarray,
                     max_length: int = 30, heads: int = 12) -> np.ndarray:
    """Greedy caption token ids [B, max_length] (PAD after [SEP])."""
    visual = vit_encode(params["visual_encoder"], img, heads)
    b = img.shape[0]
    buf = np.full((b, max_length), _PAD, np.int64)
    buf[:, : len(prompt_ids)] = prompt_ids
    tokens = torch.from_numpy(buf).to(img.device)
    for i in range(len(prompt_ids), max_length):
        logits = bert_decode_logits(params["text_decoder"], tokens, visual, heads)
        nxt = logits[:, i - 1].argmax(dim=-1)
        emitted = (tokens == _SEP).any(dim=1)  # once [SEP] is out, PAD
        tokens[:, i] = torch.where(emitted, torch.zeros_like(nxt), nxt)
    return tokens.cpu().numpy().astype(np.int32)


# -- WordPiece ---------------------------------------------------------------------------

# Copied from forge_tpu/models/blip.py (WordPiece).
class WordPiece:
    def __init__(self, vocab_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.tokens = [ln.rstrip("\n") for ln in f]
        self.vocab = {t: i for i, t in enumerate(self.tokens)}

    def encode(self, text: str) -> List[int]:
        out = []
        for word in text.lower().split():
            chunk, start = [], 0
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    if piece in self.vocab:
                        cur = self.vocab[piece]
                        break
                    end -= 1
                if cur is None:
                    chunk = [self.vocab.get("[UNK]", 100)]
                    break
                chunk.append(cur)
                start = end
            out.extend(chunk)
        return out

    def decode(self, ids) -> str:
        words: List[str] = []
        for i in ids:
            i = int(i)
            if i in (_PAD, _SEP) or i >= len(self.tokens):
                continue
            t = self.tokens[i]
            if t.startswith("##") and words:
                words[-1] += t[2:]
            elif not (t.startswith("[") and t.endswith("]")):
                words.append(t)
        return " ".join(words)


class BlipCaptioner:
    """The loader and caption call (the reference's
    InterrogateModels.generate_caption): `model_base_caption*` (.pth, .pt or
    .safetensors) and `vocab.txt` under models/BLIP. The weights live on the
    card unless `device` is given, in `dtype` (DTYPE on the card, f32 on the
    CPU)."""

    MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
    STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    DTYPE = torch.bfloat16  # the caption ids equal to f32's on an H100 (PERF.md §4)

    def __init__(self, model_dir: str = "models/BLIP", device=None,
                 dtype: Optional[torch.dtype] = None):
        self.model_dir = model_dir
        self.device = device
        self.dtype = dtype
        self.params: Optional[Dict[str, Any]] = None
        self.wp: Optional[WordPiece] = None

    @property
    def available(self) -> bool:
        try:
            self.load()
            return self.params is not None and self.wp is not None
        except Exception:
            return False

    def placement(self):
        from ..core.device import placement

        return placement(self.device, self.dtype, self.DTYPE)

    def load(self):
        if self.params is not None or not os.path.isdir(self.model_dir):
            return
        vocab = os.path.join(self.model_dir, "vocab.txt")
        ckpts = [f for f in sorted(os.listdir(self.model_dir))
                 if f.endswith((".pth", ".pt", ".safetensors"))]
        if not ckpts or not os.path.exists(vocab):
            return
        from ..core.convert import nest, tree_to
        from ..core.state_dict import load_state_dict

        sd = load_state_dict(os.path.join(self.model_dir, ckpts[0]))
        sd = sd["model"] if isinstance(sd.get("model"), dict) else sd
        self.params = tree_to(nest(sd), *self.placement())
        self.wp = WordPiece(vocab)

    def caption(self, image: np.ndarray, prompt: str = "a picture of",
                max_length: int = 30) -> str:
        from ..pipeline.images import bicubic_resize

        self.load()
        if self.params is None or self.wp is None:
            raise RuntimeError(f"no BLIP checkpoint+vocab under {self.model_dir}")
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img * (255 if img.max() <= 1.5 else 1), 0, 255).astype(np.uint8)
        x = (bicubic_resize(img[..., :3], 384, 384).astype(np.float32) / 255.0
             - self.MEAN) / self.STD
        device, dtype = self.placement()
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(device, dtype)
        prompt_ids = np.asarray([_BOS] + self.wp.encode(prompt), np.int32)
        ids = blip_caption_ids(self.params, x, prompt_ids, max_length=max_length)
        return self.wp.decode(ids[0][len(prompt_ids):])


_CAPTIONER: Optional[BlipCaptioner] = None


def get_blip(device=None) -> BlipCaptioner:
    global _CAPTIONER
    if _CAPTIONER is None:
        _CAPTIONER = BlipCaptioner(device=device)
    return _CAPTIONER

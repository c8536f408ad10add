"""CLIP BPE tokenizer in pure Python (port of forge_tpu/text/tokenizer.py).

forge_tpu wraps transformers' CLIPTokenizer; the port depends on neither
transformers nor the `regex` package. This reproduces the slow HF tokenizer
as it runs without ftfy: BERT-style text cleanup (control characters dropped,
whitespace folded, CJK characters spaced, NFC, lower case), the CLIP
pre-tokenizer pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

matched by hand with `unicodedata` categories, the byte-to-unicode map, and
rank-ordered BPE merges over the bundled `vocab.json` / `merges.txt`.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

ASSETS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                          "assets", "clip_tokenizer")
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def find_tokenizer_dir() -> Optional[str]:
    for cand in (os.environ.get("FORGE_TPU_TOKENIZER_DIR", ""), ASSETS_DIR):
        if cand and all(os.path.exists(os.path.join(cand, f))
                        for f in ("vocab.json", "merges.txt")):
            return cand
    return None


def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte → printable unicode map (GPT-2 / CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_chinese(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """HF BasicTokenizer(strip_accents=False, do_split_on_punc=False), joined."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if ch in " \t\n\r" or cat == "Zs":
            out.append(" ")
        elif cat.startswith("C"):
            continue
        elif _is_chinese(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


def pre_tokenize(text: str) -> List[str]:
    """The CLIP pattern's matches, in order (alternatives tried left to right)."""
    out = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        low = text[i:i + 15].lower()
        special = next((s for s in _SPECIALS if low.startswith(s)), None)
        if special is not None:
            out.append(text[i:i + len(special)])
            i += len(special)
            continue
        contraction = next((c for c in _CONTRACTIONS if low.startswith(c)), None)
        if contraction is not None:
            out.append(text[i:i + len(contraction)])
            i += len(contraction)
            continue
        j = i + 1
        if _is_letter(ch):
            while j < n and _is_letter(text[j]):
                j += 1
        elif not _is_number(ch):
            while j < n and not (text[j].isspace() or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


class ClipTokenizer:
    """ids without special tokens, plus the special ids the chunking engine needs."""

    def __init__(self, vocab_file: Optional[str] = None, merges_file: Optional[str] = None):
        if vocab_file is None:
            d = find_tokenizer_dir()
            if d is None:
                raise FileNotFoundError(
                    "no CLIP tokenizer assets found; set FORGE_TPU_TOKENIZER_DIR "
                    "to a directory containing vocab.json + merges.txt")
            vocab_file = os.path.join(d, "vocab.json")
            merges_file = os.path.join(d, "merges.txt")
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1: 49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.comma = self.encoder[",</w>"]
        self.vocab_size = len(self.encoder)

    @functools.lru_cache(maxsize=65536)
    def bpe(self, token: str) -> Tuple[str, ...]:
        if token in _SPECIALS:
            return (token,)
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        return word

    @functools.lru_cache(maxsize=4096)
    def ids(self, text: str) -> tuple:
        unk = self.encoder["<|endoftext|>"]
        out = []
        for piece in pre_tokenize(basic_clean(text)):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            out.extend(self.encoder.get(t, unk) for t in self.bpe(mapped))
        return tuple(out)


@functools.lru_cache(maxsize=1)
def default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()

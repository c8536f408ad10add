"""Pure-Python T5 (SentencePiece Unigram) tokenizer over a `tokenizer.json`.

The machine with the card has no `transformers`, and forge_tpu builds
`T5TokenizerFast` (forge_tpu/text/t5_engine.py:31-45); this reads the same
`assets/t5_tokenizer/tokenizer.json` and gives the same ids, as the HF
`tokenizers` library computes them:

1. normalizer `Sequence`: `Precompiled` (SentencePiece's nmt_nfkc charsmap,
   a double-array trie of replacements, applied per grapheme cluster and
   then per character), `Strip` right, `Replace` of runs of two or more
   spaces by one "▁";
2. pre-tokenizer `Metaspace` (prepend scheme "always", split): spaces become
   "▁", a "▁" is prepended, and the text splits before every "▁";
3. model `Unigram`: per piece, the Viterbi path of highest total log
   probability; a character no piece covers is `<unk>` scored min − 10, and
   adjacent unknowns fuse into one `<unk>`.

Grapheme clusters are approximated as a base character followed by its
combining marks, variation selectors and zero-width-joiner sequences.
Added tokens (`<pad>`, `</s>`, `<extra_id_N>`) are not split out of the text.
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

ASSETS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "t5_tokenizer")
UNK_PENALTY = 10.0
SPACE = "▁"
ZWJ = "\u200d"


class _CharsMap:
    """SentencePiece's precompiled normalization map: a darts-clone double
    array over UTF-8 bytes whose leaf values index a blob of NUL-terminated
    replacement strings."""

    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{trie_size // 4}I", blob, 4)
        self.normalized = blob[4 + trie_size:]

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement for the shortest key that prefixes `chunk`, if any."""
        units = self.units
        pos = 0
        unit = units[pos]
        pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for c in chunk.encode("utf-8"):
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                start = units[pos] & ((1 << 31) - 1)
                end = self.normalized.index(b"\0", start)
                return self.normalized[start:end].decode("utf-8")
        return None


def _graphemes(text: str) -> List[str]:
    out: List[str] = []
    for ch in text:
        joins = out and (unicodedata.combining(ch) or ch == ZWJ
                         or 0xFE00 <= ord(ch) <= 0xFE0F or out[-1].endswith(ZWJ))
        if joins:
            out[-1] += ch
        else:
            out.append(ch)
    return out


class T5Tokenizer:
    def __init__(self, path: str = os.path.join(ASSETS_DIR, "tokenizer.json")):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model["type"] != "Unigram":
            raise ValueError(f"{path}: model {model['type']} is not Unigram")
        self.pieces: Dict[str, Tuple[int, float]] = {}
        for i, (piece, score) in enumerate(model["vocab"]):
            self.pieces.setdefault(piece, (i, float(score)))
        self.unk_id = model["unk_id"]
        self.unk_score = min(s for _, s in model["vocab"]) - UNK_PENALTY
        self.max_len = max(len(p) for p, _ in model["vocab"])
        self.charsmap: Optional[_CharsMap] = None
        self.rstrip = False
        self.replaces: List[Tuple[re.Pattern, str]] = []
        norms = spec.get("normalizer") or {"type": "Sequence", "normalizers": []}
        for n in norms["normalizers"] if norms["type"] == "Sequence" else [norms]:
            if n["type"] == "Precompiled":
                self.charsmap = _CharsMap(base64.b64decode(n["precompiled_charsmap"]))
            elif n["type"] == "Strip" and n["strip_right"] and not n["strip_left"]:
                self.rstrip = True
            elif n["type"] == "Replace":
                pat = n["pattern"]
                regex = pat["Regex"] if "Regex" in pat else re.escape(pat["String"])
                self.replaces.append((re.compile(regex), n["content"]))
            else:
                raise NotImplementedError(f"normalizer {n['type']} is not ported")
        pre = spec["pre_tokenizer"]
        if pre["type"] != "Metaspace" or pre.get("prepend_scheme", "always") != "always":
            raise NotImplementedError(f"pre-tokenizer {pre} is not ported")

    def normalize(self, text: str) -> str:
        if self.charsmap is not None:
            parts = []
            for g in _graphemes(text):
                norm = self.charsmap.transform(g) if len(g.encode("utf-8")) < 6 else None
                if norm is None:
                    norm = "".join(self.charsmap.transform(c) or c for c in g)
                parts.append(norm)
            text = "".join(parts)
        if self.rstrip:
            text = text.rstrip()
        for pattern, content in self.replaces:
            text = pattern.sub(content, text)
        return text

    def pre_tokenize(self, text: str) -> List[str]:
        if not text:
            return []
        text = text.replace(" ", SPACE)
        if not text.startswith(SPACE):
            text = SPACE + text
        return [w for w in re.split(f"(?={SPACE})", text) if w]

    def _viterbi(self, word: str) -> List[int]:
        n = len(word)
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)  # score, start, id
        best[0] = (0.0, 0, -1)
        for start in range(n):
            base = best[start][0]
            single = False
            for end in range(start + 1, min(n, start + self.max_len) + 1):
                hit = self.pieces.get(word[start:end])
                if hit is None:
                    continue
                score = base + hit[1]
                if best[end] is None or score > best[end][0]:
                    best[end] = (score, start, hit[0])
                single = single or end == start + 1
            if not single:
                score = base + self.unk_score
                if best[start + 1] is None or score > best[start + 1][0]:
                    best[start + 1] = (score, start, self.unk_id)
        ids: List[int] = []
        end = n
        while end > 0:
            _, start, tid = best[end]
            if not (tid == self.unk_id and ids and ids[-1] == self.unk_id):
                ids.append(tid)  # adjacent unknowns fuse into one
            end = start
        return ids[::-1]

    def encode(self, text: str) -> List[int]:
        """Text → ids, no special tokens (`add_special_tokens=False`)."""
        ids: List[int] = []
        for word in self.pre_tokenize(self.normalize(text)):
            ids.extend(self._viterbi(word))
        return ids

    def __call__(self, text: str) -> List[int]:
        return self.encode(text)


@functools.lru_cache(maxsize=1)
def default_t5_tokenizer() -> T5Tokenizer:
    """From $FORGE_TPU_T5_TOKENIZER (a directory, as forge_tpu reads it) or the bundled assets."""
    folder = os.environ.get("FORGE_TPU_T5_TOKENIZER") or ASSETS_DIR
    return T5Tokenizer(os.path.join(folder, "tokenizer.json"))

# Copied from forge_tpu/text/emphasis.py (the parser); apply_emphasis is rewritten in torch.
"""A1111 attention-emphasis syntax: `(boost)`, `[attenuate]`, `(text:1.5)`.

Behavioral re-implementation of the webui prompt-attention semantics
(reference backend/text_processing/parsing.py:23 + emphasis modes
emphasis.py:4-57): returns [(text, weight)] segments, then the engine applies
one of the emphasis modes to the encoded embeddings.

Semantics (as documented in the webui wiki):
  (abc)      → abc ×1.1            [abc]     → abc ÷1.1
  (abc:3.12) → abc ×3.12           \\( \\)   → literal parens
  nesting multiplies; BREAK splits token chunks (handled by chunking.py)
"""

from __future__ import annotations

import re
from typing import List, Tuple

_TOKEN_RE = re.compile(
    r"""
    \\\( | \\\) | \\\[ | \\\] | \\\\ | \\ |   # escapes
    \( | \[ |                                  # openers
    :\s*([+-]?[.\d]+)\s*\) |                   # :1.5) closer with weight
    \) | \] |                                  # closers
    [^\\()\[\]:]+ |                            # plain text
    :
    """,
    re.X,
)

_BREAK_RE = re.compile(r"\s*\bBREAK\b\s*")


def parse_prompt_attention(text: str) -> List[Tuple[str, float]]:
    res: List[List] = []
    round_stack: List[int] = []
    square_stack: List[int] = []

    def multiply_range(start: int, multiplier: float):
        for i in range(start, len(res)):
            res[i][1] *= multiplier

    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)

        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif weight is not None and round_stack:
            multiply_range(round_stack.pop(), float(weight))
        elif tok == ")" and round_stack:
            multiply_range(round_stack.pop(), 1.1)
        elif tok == "]" and square_stack:
            multiply_range(square_stack.pop(), 1 / 1.1)
        else:
            parts = _BREAK_RE.split(tok)
            for i, part in enumerate(parts):
                if i > 0:
                    res.append(["BREAK", -1.0])
                if part:
                    res.append([part, 1.0])

    # unbalanced openers behave as if closed at end
    for pos in round_stack:
        multiply_range(pos, 1.1)
    for pos in square_stack:
        multiply_range(pos, 1 / 1.1)

    if not res:
        res = [["", 1.0]]

    # merge adjacent equal-weight runs
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1] and res[i][0] != "BREAK" and res[i + 1][0] != "BREAK":
            res[i][0] += res[i + 1][0]
            del res[i + 1]
        else:
            i += 1

    return [(t, w) for t, w in res]


# ---------------------------------------------------------------------------
# emphasis application modes (reference emphasis.py:4-57); torch rewrite of
# forge_tpu/text/emphasis.py apply_emphasis


def apply_emphasis(z, multipliers, mode: str = "Original"):
    """z [B, L, D] embeddings, multipliers [B, L] per-token weights."""
    import torch

    if mode in ("None", "Ignore"):
        return z
    original_mean = z.mean()
    z = z * multipliers[..., None].to(z.dtype)
    if mode == "Original":
        new_mean = z.mean()
        # guard degenerate zero-mean embeddings (synthetic benches)
        ratio = torch.where(new_mean == 0, torch.ones_like(new_mean),
                            original_mean / new_mean)
        z = z * ratio
    return z

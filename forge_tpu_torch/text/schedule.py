# Copied from forge_tpu/text/schedule.py; numpy/stdlib only, so the port imports no JAX.
"""Prompt scheduling `[from:to:when]` / alternation `[a|b]` / AND composition.

Behavioral re-implementation of the reference's lark-based prompt scheduler
(modules/prompt_parser.py:28-137 grammar, :210-268 AND weights) with a
hand-written recursive-descent parser (no lark dependency at runtime).

Semantics:
  [to:N]        — text appears after step N
  [from::N]     — text disappears after step N
  [from:to:N]   — switch at step N (fraction of steps if N < 1)
  [a|b|c]       — alternate every step
  p1 AND p2:0.6 — composable-diffusion branches with weights
"""

from __future__ import annotations

import re
from typing import List, Tuple


class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s

    def boundaries(self, steps):
        return set()

    def at(self, step, steps):
        return self.s


class _Seq(_Node):
    def __init__(self, parts):
        self.parts = parts

    def boundaries(self, steps):
        out = set()
        for p in self.parts:
            out |= p.boundaries(steps)
        return out

    def at(self, step, steps):
        return "".join(p.at(step, steps) for p in self.parts)


class _Scheduled(_Node):
    def __init__(self, before: _Node, after: _Node, when: float):
        self.before, self.after, self.when = before, after, when

    def _step(self, steps):
        w = self.when
        boundary = w * steps if w < 1 else w
        return int(boundary)

    def boundaries(self, steps):
        return {self._step(steps)} | self.before.boundaries(steps) | self.after.boundaries(steps)

    def at(self, step, steps):
        node = self.after if step > self._step(steps) else self.before
        return node.at(step, steps)


class _Alternate(_Node):
    def __init__(self, options):
        self.options = options

    def boundaries(self, steps):
        out = set(range(1, steps))
        for o in self.options:
            out |= o.boundaries(steps)
        return out

    def at(self, step, steps):
        return self.options[(step - 1) % len(self.options)].at(step, steps)


def _parse(text: str, pos: int = 0, stop=()) -> Tuple[_Node, int]:
    parts: List[_Node] = []
    buf = []

    def flush():
        if buf:
            parts.append(_Text("".join(buf)))
            buf.clear()

    i = pos
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == "\\" and i + 1 < n:
            buf.append(text[i : i + 2])
            i += 2
            continue
        if ch in stop:
            break
        if ch == "[":
            flush()
            node, i = _parse_bracket(text, i + 1)
            parts.append(node)
            continue
        buf.append(ch)
        i += 1
    flush()
    return _Seq(parts), i


_NUM_RE = re.compile(r"\s*([+-]?[\d.]+)\s*$")


def _parse_bracket(text: str, pos: int) -> Tuple[_Node, int]:
    """Parse after '['. Returns node and index past the closing ']'."""
    segments: List[_Node] = []
    seps: List[str] = []
    i = pos
    while True:
        node, i = _parse(text, i, stop="]:|")
        segments.append(node)
        if i >= len(text):  # unterminated — treat literally
            seps.append("]")
            break
        sep = text[i]
        i += 1
        if sep == "]":
            break
        seps.append(sep)

    if "|" in seps:
        return _Alternate(segments), i

    if seps and all(s == ":" for s in seps):
        last = segments[-1]
        m = _NUM_RE.match(last.at(1, 1000000)) if isinstance(last, (_Text, _Seq)) else None
        if m:
            when = float(m.group(1))
            if len(segments) == 2:
                return _Scheduled(_Text(""), segments[0], when), i
            if len(segments) == 3:
                return _Scheduled(segments[0], segments[1], when), i

    # not a schedule — reconstruct literal text
    literal = "[" + ":".join(s.at(1, 1) for s in segments) + "]"
    return _Text(literal), i


def get_schedule(prompt: str, steps: int) -> List[Tuple[int, str]]:
    """→ [(end_step, prompt_text), ...] covering 1..steps (reference
    get_learned_conditioning_prompt_schedules behavior)."""
    tree, _ = _parse(prompt)
    bounds = sorted(b for b in tree.boundaries(steps) if 0 < b < steps)
    keypoints = bounds + [steps]
    out: List[Tuple[int, str]] = []
    prev_text = None
    for end in keypoints:
        text = tree.at(end, steps)
        if out and text == out[-1][1]:
            out[-1] = (end, text)
        else:
            out.append((end, text))
    return out


_AND_RE = re.compile(r"\bAND\b")
_WEIGHT_RE = re.compile(r"^(.*?)\s*:\s*([+-]?[\d.]+)\s*$", re.S)


def split_composable(prompt: str) -> List[Tuple[str, float]]:
    """AND-composition split with :weight suffixes (reference
    prompt_parser.py:210-268)."""
    out = []
    for part in _AND_RE.split(prompt):
        m = _WEIGHT_RE.match(part)
        if m:
            out.append((m.group(1).strip(), float(m.group(2))))
        else:
            out.append((part.strip(), 1.0))
    return out

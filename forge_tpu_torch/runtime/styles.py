# Copied from forge_tpu/runtime/styles.py; stdlib only, so the port imports no JAX.
"""Prompt styles: named prompt/negative-prompt snippets stored in styles.csv.

Behavioral twin of the reference's modules/styles.py (PromptStyle,
StyleDatabase, apply/extract round-trip). A style's prompt either contains a
``{prompt}`` placeholder (the user prompt is substituted in) or is appended
with ", ". ``extract_styles_from_prompt`` inverts the application so pasted
infotext can be re-expressed as prompt + style selections
(modules/styles.py:209 extract_styles_from_prompt, used by
infotext_utils.py:322).

Storage is CSV with columns name,prompt,negative_prompt
(modules/styles.py:130 load_from_csv — including the legacy "text" column
fallback and utf-8-sig signature the webui writes).
"""

from __future__ import annotations

import csv
import glob
import os
import shutil
from typing import Dict, List, NamedTuple, Optional, Tuple


class PromptStyle(NamedTuple):
    name: str
    prompt: str = ""
    negative_prompt: str = ""
    path: Optional[str] = None


def apply_styles_to_prompt(prompt: str, style_texts: List[str]) -> str:
    """modules/styles.py:17 — substitute {prompt} or append with ', '."""
    prompt = (prompt or "").strip()
    for text in style_texts:
        text = (text or "").strip()
        if "{prompt}" in text:
            prompt = text.replace("{prompt}", prompt)
        elif text:
            prompt = f"{prompt}, {text}" if prompt else text
    return prompt


def extract_style_text_from_prompt(style_text: str, prompt: str) -> Tuple[bool, str]:
    """Inverse of one application: if the style text (or its {prompt}
    bracketing) matches, strip it and return (True, bare_prompt)
    (modules/styles.py:33)."""
    stripped_prompt = (prompt or "").strip()
    stripped_style = (style_text or "").strip()
    if "{prompt}" in stripped_style:
        left, _, right = stripped_style.partition("{prompt}")
        if stripped_prompt.startswith(left) and stripped_prompt.endswith(right):
            end = len(stripped_prompt) - len(right)
            return True, stripped_prompt[len(left):end]
    elif stripped_prompt.endswith(stripped_style):
        bare = stripped_prompt[: len(stripped_prompt) - len(stripped_style)]
        if bare.endswith(", "):
            bare = bare[:-2]
        return True, bare
    return False, prompt


def extract_original_prompts(style: PromptStyle, prompt: str,
                             negative_prompt: str) -> Tuple[bool, str, str]:
    """Both halves must match for the style to be considered applied
    (modules/styles.py:61)."""
    if not style.prompt and not style.negative_prompt:
        return False, prompt, negative_prompt
    ok_pos, new_pos = extract_style_text_from_prompt(style.prompt, prompt)
    if not ok_pos:
        return False, prompt, negative_prompt
    ok_neg, new_neg = extract_style_text_from_prompt(style.negative_prompt,
                                                     negative_prompt)
    if not ok_neg:
        return False, prompt, negative_prompt
    return True, new_pos, new_neg


class StyleDatabase:
    """styles.csv registry; paths may contain glob wildcards
    (modules/styles.py:81). The first path is the default save target."""

    def __init__(self, paths: Optional[List[str]] = None):
        self.paths = list(paths or ["styles.csv"])
        self.default_path = self.paths[0]
        if any(c in os.path.basename(self.default_path) for c in "*?"):
            folder = os.path.dirname(self.default_path)
            matches = sorted(glob.glob(self.default_path))
            self.default_path = matches[0] if matches else os.path.join(
                folder, "styles.csv")
        self.styles: Dict[str, PromptStyle] = {}
        self._owned_paths = set()  # files that contributed >=1 style
        self.reload()

    def reload(self):
        self.styles.clear()
        self._owned_paths = set()
        files: List[str] = []
        for pattern in self.paths:
            if any(c in os.path.basename(pattern) for c in "*?"):
                files.extend(sorted(glob.glob(pattern)))
            else:
                files.append(pattern)
        seen = set()
        for path in files:
            if path in seen:
                continue
            seen.add(path)
            if os.path.isfile(path):
                self._load_csv(path)

    def _load_csv(self, path: str):
        try:
            with open(path, "r", encoding="utf-8-sig", newline="") as f:
                for row in csv.DictReader(f, skipinitialspace=True):
                    name = (row.get("name") or "").strip()
                    if not name or name.startswith("#"):
                        continue
                    prompt = row.get("prompt")
                    if prompt is None:
                        prompt = row.get("text", "")
                    self.styles[name] = PromptStyle(
                        name, prompt or "", row.get("negative_prompt") or "",
                        path)
                    self._owned_paths.add(path)
        except Exception as e:  # noqa: BLE001 — a bad csv must not kill startup
            print(f"error loading styles from {path}: {e}")

    def save(self, path: Optional[str] = None):
        """Write each style back to the file it came from (new styles go to
        the default path); keeps a .bak like the reference
        (modules/styles.py:184)."""
        by_path: Dict[str, List[PromptStyle]] = {}
        # every file that previously OWNED a style must be rewritten even if
        # it now owns none — otherwise deleting a file's last style leaves
        # the stale row on disk and it resurrects on reload
        for known in list(getattr(self, "_owned_paths", ())) + [path or self.default_path]:
            if known:
                by_path.setdefault(known, [])
        for style in self.styles.values():
            target = path or style.path or self.default_path
            by_path.setdefault(target, []).append(style)
        for target, styles in by_path.items():
            if os.path.exists(target):
                shutil.copy(target, target + ".bak")
            parent = os.path.dirname(target)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(target, "w", encoding="utf-8-sig", newline="") as f:
                w = csv.DictWriter(f, fieldnames=["name", "prompt",
                                                  "negative_prompt"])
                w.writeheader()
                for s in styles:
                    w.writerow({"name": s.name, "prompt": s.prompt,
                                "negative_prompt": s.negative_prompt})

    # -- application ---------------------------------------------------------

    def _texts(self, names: List[str], negative: bool) -> List[str]:
        out = []
        for n in names or []:
            s = self.styles.get(n)
            if s is not None:
                out.append(s.negative_prompt if negative else s.prompt)
        return out

    def apply_styles_to_prompt(self, prompt: str, names: List[str]) -> str:
        return apply_styles_to_prompt(prompt, self._texts(names, False))

    def apply_negative_styles_to_prompt(self, prompt: str,
                                        names: List[str]) -> str:
        return apply_styles_to_prompt(prompt, self._texts(names, True))

    def extract_styles_from_prompt(self, positive: str, negative: str
                                   ) -> Tuple[List[str], str, str]:
        """Greedily peel applied styles off a (positive, negative) pair;
        returns (style_names, bare_positive, bare_negative)
        (modules/styles.py:209)."""
        extracted: List[str] = []
        candidates = list(self.styles.values())
        while True:
            found = None
            for style in candidates:
                ok, new_pos, new_neg = extract_original_prompts(
                    style, positive, negative)
                if ok:
                    found = style
                    positive, negative = new_pos, new_neg
                    candidates.remove(style)
                    extracted.append(style.name)
                    break
            if found is None:
                break
        return list(reversed(extracted)), positive, negative


# process-wide database, (re)configured by webui.main() from --styles-file
prompt_styles = StyleDatabase()

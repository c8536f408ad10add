# Copied from forge_tpu/runtime/localization.py (list_localizations, load_localization); stdlib only.
"""UI localization: string-replacement dictionaries for the web UI.

Reference modules/localization.py: localizations/ holds <name>.json files
of {english_text: translated_text}; extensions contribute their own under
<ext>/localizations/; the selected dictionary ships to the browser, which
swaps visible strings. Same design here, served as JSON over
/sdapi/v1/localization (the SPA applies it on load).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


def list_localizations(dirs: Optional[List[str]] = None) -> Dict[str, List[str]]:
    """name → [json paths] over localizations/ + extensions/*/localizations/."""
    dirs = dirs or ["localizations"]
    ext_base = "extensions"
    if os.path.isdir(ext_base):
        dirs = dirs + [os.path.join(ext_base, d, "localizations")
                       for d in sorted(os.listdir(ext_base))]
    out: Dict[str, List[str]] = {}
    for d in dirs:
        if not os.path.isdir(d):
            continue
        for f in sorted(os.listdir(d)):
            name, ext = os.path.splitext(f)
            if ext.lower() == ".json":
                out.setdefault(name, []).append(os.path.join(d, f))
    return out


def load_localization(name: str) -> Dict[str, str]:
    """Merged replacement dict for one localization (later files win)."""
    data: Dict[str, str] = {}
    for path in list_localizations().get(name, []):
        try:
            with open(path, encoding="utf8") as fh:
                loaded = json.load(fh)
            if isinstance(loaded, dict):
                data.update({str(k): str(v) for k, v in loaded.items()})
        except (OSError, json.JSONDecodeError):
            pass
    return data

# Copied from forge_tpu/runtime/extensions.py (Extension, list_extensions, install_extension, check_extension_updates, update_extension, save_config_state, list_config_states); stdlib only.
"""Extension manager: discovery, metadata, ordering, enable/disable,
config-state snapshots.

Behavioral twin of modules/extensions.py:39-316 (Extension objects with
metadata.ini, git info, canonical names, dependency-aware load ordering) and
modules/config_states.py (snapshot/restore of the extension + options
state). Installation follows modules/ui_extensions.py:344
install_extension_from_url (git clone into extensions/, update via
fetch+reset — extensions.py:226 fetch_and_reset_hard) using subprocess git;
the HTTP surface for it is gated behind --enable-insecure-extension-access
(same flag as the reference) because it executes arbitrary fetched code.

Layout per extension:
    extensions/<name>/
        scripts/*.py          -- Script subclasses
        metadata.ini          -- optional: [Extension] Name=, Requires=
        install.py            -- intentionally NOT executed (no pip in env)

The port lists, installs and updates extensions and snapshots config
states (GET /sdapi/v1/extensions, POST /extensions/install and /update,
GET /config_states, POST /config_states/save); it loads no extension's
scripts at start (the reference's extensions are written against its JAX
package).
"""

from __future__ import annotations

import configparser
import dataclasses
import json
import os
import re
import subprocess
import time
from typing import Dict, List, Optional

BUILTIN_DIR = "extensions-builtin"
USER_DIR = "extensions"


@dataclasses.dataclass
class Extension:
    name: str
    path: str
    is_builtin: bool = False
    enabled: bool = True
    canonical_name: str = ""
    requires: List[str] = dataclasses.field(default_factory=list)
    commit_hash: str = ""
    branch: str = ""
    remote: str = ""
    version: str = ""

    @property
    def scripts_dir(self) -> str:
        return os.path.join(self.path, "scripts")

    def read_metadata(self) -> None:
        """metadata.ini (reference extensions.py:60-92 ExtensionMetadata)."""
        self.canonical_name = self.name.lower()
        ini = os.path.join(self.path, "metadata.ini")
        if not os.path.exists(ini):
            return
        cfg = configparser.ConfigParser()
        try:
            cfg.read(ini)
            self.canonical_name = cfg.get("Extension", "Name",
                                          fallback=self.name).lower()
            req = cfg.get("Extension", "Requires", fallback="")
            self.requires = [r.strip().lower() for r in req.split(",") if r.strip()]
        except Exception:
            pass

    def read_git_info(self) -> None:
        """Best-effort git identity (reference extensions.py:140-170)."""
        git_dir = os.path.join(self.path, ".git")
        if not os.path.isdir(git_dir):
            return

        def git(*args):
            try:
                return subprocess.run(["git", "-C", self.path, *args],
                                      capture_output=True, text=True,
                                      timeout=5).stdout.strip()
            except Exception:
                return ""

        self.commit_hash = git("rev-parse", "HEAD")
        self.branch = git("rev-parse", "--abbrev-ref", "HEAD")
        self.remote = git("remote", "get-url", "origin")
        self.version = self.commit_hash[:8]


def _disabled_set():
    from .options import opts

    return set(opts.get("disabled_extensions") or []), opts.get("disable_all_extensions")


def list_extensions(base_dirs: Optional[List[str]] = None) -> List[Extension]:
    """Discover + order extensions (reference extensions.py:180-260
    list_extensions with Requires-based topological ordering)."""
    dirs = base_dirs or [BUILTIN_DIR, USER_DIR]
    disabled, mode = _disabled_set()
    found: List[Extension] = []
    for base in dirs:
        if not os.path.isdir(base):
            continue
        builtin = base == BUILTIN_DIR
        for name in sorted(os.listdir(base)):
            path = os.path.join(base, name)
            if not os.path.isdir(path) or name.startswith("."):
                continue
            ext = Extension(name=name, path=path, is_builtin=builtin)
            ext.read_metadata()
            ext.read_git_info()
            if mode == "all" or (mode == "extra" and not builtin) \
                    or name in disabled or ext.canonical_name in disabled:
                ext.enabled = False
            found.append(ext)

    # topological-ish ordering: repeatedly emit extensions whose Requires are met
    by_name = {e.canonical_name: e for e in found}
    ordered: List[Extension] = []
    remaining = list(found)
    while remaining:
        progress = False
        for ext in list(remaining):
            if all(r in {o.canonical_name for o in ordered} or r not in by_name
                   for r in ext.requires):
                ordered.append(ext)
                remaining.remove(ext)
                progress = True
        if not progress:  # cycle — emit the rest in name order
            ordered.extend(remaining)
            break
    return ordered


# -- install / update (modules/ui_extensions.py) ------------------------------


def _git(cwd: str, *args: str, timeout: int = 120) -> str:
    r = subprocess.run(["git", "-C", cwd, *args], capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"git {' '.join(args)}: {r.stderr.strip()[:400]}")
    return r.stdout.strip()


def _dirname_from_url(url: str) -> str:
    tail = url.rstrip("/").split("/")[-1]
    return re.sub(r"\.git$", "", tail) or "extension"


def install_extension(url: str, dirname: str = "", branch: str = "",
                      base_dir: str = USER_DIR) -> Extension:
    """Clone an extension repo into extensions/ (reference
    ui_extensions.py:344 install_extension_from_url). Clones into a temp
    sibling then renames, so a failed clone never leaves a half extension."""
    url = (url or "").strip()
    if not url:
        raise ValueError("no URL specified")
    name = re.sub(r"[^\w.-]", "_", (dirname or _dirname_from_url(url)).strip())
    os.makedirs(base_dir, exist_ok=True)
    target = os.path.join(base_dir, name)
    if os.path.exists(target):
        raise FileExistsError(f"extension directory already exists: {target}")
    tmp = target + ".tmp-install"
    if os.path.isdir(tmp):
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    args = ["clone", "--depth", "1"]
    if branch:
        args += ["--branch", branch]
    _git(".", *args, url, tmp, timeout=300)
    os.rename(tmp, target)
    ext = Extension(name=name, path=target)
    ext.read_metadata()
    ext.read_git_info()
    return ext


def check_extension_updates(ext: Extension) -> str:
    """'latest' | 'new commits' | 'unknown' (reference extensions.py:201)."""
    if not os.path.isdir(os.path.join(ext.path, ".git")):
        return "unknown"
    try:
        _git(ext.path, "fetch", "--depth", "1", "origin", timeout=120)
        local = _git(ext.path, "rev-parse", "HEAD")
        remote = _git(ext.path, "rev-parse", "FETCH_HEAD")
        return "latest" if local == remote else "new commits"
    except Exception:
        return "unknown"


def update_extension(ext: Extension, commit: str = "") -> str:
    """fetch + hard-reset to origin (reference extensions.py:226
    fetch_and_reset_hard); returns the new HEAD hash."""
    _git(ext.path, "fetch", "origin", timeout=300)
    _git(ext.path, "reset", "--hard", commit or "FETCH_HEAD")
    ext.read_git_info()
    return ext.commit_hash


# -- config states (modules/config_states.py) --------------------------------


def save_config_state(name: str = "", dirname: str = "config_states") -> str:
    """Snapshot options + extension versions → timestamped JSON."""
    from .options import opts

    os.makedirs(dirname, exist_ok=True)
    created = int(time.time())
    state = {
        "name": name or "Config",
        "created_at": created,
        "settings": opts.dump_registry(),
        "extensions": [dataclasses.asdict(e) for e in list_extensions()],
    }
    # API-supplied name: strip anything path-like so the file always lands
    # inside dirname (no ../ traversal via POST /config_states/save)
    safe = re.sub(r"[^\w.-]", "_", os.path.basename(name or "config")) or "config"
    path = os.path.join(dirname, f"{created}_{safe}.json")
    assert os.path.dirname(os.path.abspath(path)) == os.path.abspath(dirname)
    with open(path, "w", encoding="utf8") as f:
        json.dump(state, f, indent=2, default=str)
    return path


def list_config_states(dirname: str = "config_states") -> List[Dict]:
    out = []
    if not os.path.isdir(dirname):
        return out
    for fname in sorted(os.listdir(dirname), reverse=True):
        if fname.endswith(".json"):
            try:
                with open(os.path.join(dirname, fname), encoding="utf8") as f:
                    st = json.load(f)
                st["filepath"] = os.path.join(dirname, fname)
                out.append(st)
            except Exception:
                continue
    return out

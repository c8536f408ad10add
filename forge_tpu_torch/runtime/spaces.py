# Copied from forge_tpu/runtime/spaces.py (find_free_port, ForgeSpace, SpaceManager); the bundled Spaces run as the port's own apps.
"""Forge Spaces: self-contained apps launched beside the main server.

Extension folders holding `space_meta.json` are discovered; each Space
runs in its own process on a free port, with its URL tracked, and is
terminated on request (the reference's modules_forge/forge_space.py;
"install", a HuggingFace download there, is a check that the app is
present). A Space's folder holds

  space_meta.json   {"title": …, "tag": …}
  forge_app.py      run as `python forge_app.py --host H --port P`, serving
                    HTTP on (H, P) until terminated.

The bundled folders' forge_app.py files are written against the JAX
package, so the port runs its own app for each of them:
`python -m forge_tpu_torch.spaces.<name> --host H --port P` (PORT_APPS),
the package's root put on the child's PYTHONPATH. A bundled Space with no
port app yet (UNPORTED_SPACES, the diffusion Spaces) raises
NotImplementedError naming its ROADMAP item; any other folder runs its
own forge_app.py, as the reference does, and a folder without one raises
the reference's RuntimeError. Each launch takes a port the OS picks (the
reference scans from 7870), so Spaces launched at once (the API's handler
threads) take different ports; a Space launched twice at once starts one
child, and both calls answer its URL.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

# the bundled Spaces the port runs, by folder → forge_tpu_torch/spaces/<module>.py
PORT_APPS = {"forge_space_example": "example", "forge_space_sapiens_normal": "sapiens_normal",
             "forge_space_birefnet": "birefnet", "forge_space_florence_2": "florence_2"}
# the bundled Spaces built on diffusion engines, not ported yet
UNPORTED_SPACES = ("forge_space_animagine_xl_31", "forge_space_geowizard", "forge_space_iclight",
                   "forge_space_idm_vton", "forge_space_illusion_diffusion",
                   "forge_space_photo_maker_v2")
_ROADMAP_SPACES = "ROADMAP.md queue 1 item 9: the Spaces on diffusion engines"
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_free_port(host: str = "127.0.0.1") -> int:
    """A port the OS picks, free when this returns."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


class ForgeSpace:
    def __init__(self, root_path: str, meta: Dict):
        self.root_path = root_path
        self.name = os.path.basename(root_path)
        self.title = meta.get("title") or self.name
        self.tag = meta.get("tag", "")
        self.meta = meta
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        self._lock = threading.RLock()  # one child a Space, whichever thread launches it

    @property
    def installed(self) -> bool:
        return os.path.exists(os.path.join(self.root_path, "forge_app.py"))

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def command(self, host: str, port: int) -> List[str]:
        """The child's command line: the port's app for a bundled Space, else the folder's own."""
        if self.name in UNPORTED_SPACES:
            raise NotImplementedError(f"the Space {self.name!r} is not ported to forge_tpu_torch "
                                      f"yet ({_ROADMAP_SPACES})")
        if not self.installed:
            raise RuntimeError(f"space {self.name!r} has no forge_app.py")
        if self.name in PORT_APPS:
            app = ["-m", f"forge_tpu_torch.spaces.{PORT_APPS[self.name]}"]
        else:  # absolute: the child's working directory is the folder itself
            app = [os.path.abspath(os.path.join(self.root_path, "forge_app.py"))]
        return [sys.executable] + app + ["--host", host, "--port", str(port)]

    def launch(self, host: str = "127.0.0.1", timeout: float = 60.0,
               env: Optional[Dict[str, str]] = None, args: Sequence[str] = ()) -> str:
        """Start the Space and wait until it accepts connections → its URL;
        `args` are added to its command line (a port app's `--device cpu`)."""
        with self._lock:
            if self.running:
                return self.url
            port = find_free_port(host)
            cmd = self.command(host, port) + list(args)
            if self.name in PORT_APPS:
                env = dict(os.environ if env is None else env)
                env["PYTHONPATH"] = os.pathsep.join(
                    [_PACKAGE_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                                       if p])
            self.proc = subprocess.Popen(cmd, cwd=self.root_path, env=env)
            self.url = f"http://{host}:{port}"
            deadline = time.time() + timeout
            while time.time() < deadline:
                if self.proc.poll() is not None:
                    code = self.proc.returncode
                    self.proc, self.url = None, None
                    raise RuntimeError(f"space {self.name!r} exited with {code}")
                try:
                    with socket.create_connection((host, port), timeout=0.5):
                        return self.url
                except OSError:
                    time.sleep(0.2)
            self.terminate()
            raise TimeoutError(f"space {self.name!r} did not open http://{host}:{port}")

    def terminate(self):
        with self._lock:
            if self.proc is not None and self.proc.poll() is None:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
            self.proc = None
            self.url = None

    def info(self) -> Dict:
        return {"name": self.name, "title": self.title, "tag": self.tag,
                "installed": self.installed, "running": self.running, "url": self.url}


class SpaceManager:
    """Discovery and lifecycle over extension directories."""

    def __init__(self, ext_dirs: Optional[List[str]] = None):
        self.spaces: Dict[str, ForgeSpace] = {}
        for d in ext_dirs or []:
            self.discover(d)

    def discover(self, ext_dir: str):
        if not os.path.isdir(ext_dir):
            return
        for name in sorted(os.listdir(ext_dir)):
            meta_path = os.path.join(ext_dir, name, "space_meta.json")
            if os.path.exists(meta_path):
                try:
                    with open(meta_path) as f:
                        meta = json.load(f)
                except Exception:
                    meta = {}
                self.spaces[name] = ForgeSpace(os.path.join(ext_dir, name), meta)

    def list(self) -> List[Dict]:
        return [s.info() for s in self.spaces.values()]

    def launch(self, name: str, host: str = "127.0.0.1", timeout: float = 60.0,
               env: Optional[Dict[str, str]] = None, args: Sequence[str] = ()) -> str:
        return self.spaces[name].launch(host, timeout=timeout, env=env, args=args)

    def terminate(self, name: str):
        self.spaces[name].terminate()

    def terminate_all(self):
        for s in self.spaces.values():
            s.terminate()

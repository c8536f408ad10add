"""Tiny ControlNet annotators for the port's tests, shared by the test files
of the networks, the registry's entries and the annotator slice.

Each network is a `core/synth_annotators.py` state dict at a small width,
in its released file's key space; `write_all` saves each under the file
name its detector looks for, in one models directory both packages read.
`install` puts a detector of each package, reading that directory, into
the packages' module globals (the port's on the CPU in f32), and puts the
previous ones back when its context ends.

cv2 runs with Intel IPP off in these tests: forge_tpu's annotators call
cv2, whose INTER_CUBIC on 1–4 channels takes IPP's kernel when IPP is on,
and the port rebuilds OpenCV's own code (preprocessors/cv2_np.py).
"""

import contextlib
import importlib
import os

import numpy as np

# name: (synth function, small-width arguments, its directory, its file)
TINY = {
    "depth_anything": ("synth_depth_anything_sd", dict(width=128, depth=12, features=16,
                                                       out_channels=(8, 16, 32, 32), grid=4),
                       "depth_anything_v2", "depth_anything_v2_vits.safetensors"),
    "midas": ("synth_midas_sd", dict(width=32, depth=2, features=8, out_channels=(8, 8, 16, 16),
                                     grid=4), "midas", "dpt_large-midas.safetensors"),
    "body": ("synth_openpose_body_sd", dict(scale=1 / 4), "openpose",
             "body_pose_model.safetensors"),
    "hand": ("synth_openpose_hand_sd", dict(scale=1 / 4), "openpose",
             "hand_pose_model.safetensors"),
    "face": ("synth_openpose_face_sd", dict(scale=1 / 4), "openpose", "facenet.safetensors"),
    "hed": ("synth_hed_sd", dict(widths=(4, 8, 8, 16, 16)), "hed", "ControlNetHED.safetensors"),
    "pidinet": ("synth_pidinet_sd", dict(inplane=4, dil=4), "pidinet", "table5_pidinet.pth"),
    "teed": ("synth_teed_sd", {}, "TEED", "7_model.safetensors"),
    "lineart": ("synth_lineart_sd", dict(n_residual=2, ngf=8), "lineart", "sk_model.pth"),
    "lineart_coarse": ("synth_lineart_sd", dict(n_residual=1, ngf=8, seed=35), "lineart",
                       "sk_model2.pth"),
    "lineart_anime": ("synth_lineart_anime_sd", dict(ngf=4), "lineart_anime", "netG.pth"),
    "manga_line": ("synth_manga_line_sd", dict(widths=(4, 4, 8, 8, 8, 4)), "manga_line",
                   "erika.safetensors"),
    "mlsd": ("synth_mlsd_sd", {}, "mlsd", "mlsd_large_512_fp32.safetensors"),
    "normalbae": ("synth_normalbae_sd", dict(width_mult=0.25, depth_mult=0.3,
                                             decoder_features=64), "normalbae",
                  "scannet.safetensors"),
}


def tiny_sd(name, seed=None):
    from forge_tpu_torch.core import synth_annotators

    fn, kw, _, _ = TINY[name]
    kw = dict(kw)
    if seed is not None:
        kw["seed"] = seed
    return getattr(synth_annotators, fn)(**kw)


def reference_tree(sd):
    """forge_tpu's nested tree of a flat OIHW state dict (its load path)."""
    import jax.numpy as jnp

    from forge_tpu.core.state_dict import transform_for_jax
    from forge_tpu.core.tree import nest

    return nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})


def port_tree(sd):
    import torch

    from forge_tpu_torch.core.convert import nest, tree_to

    return tree_to(nest(sd), "cpu", torch.float32)


def write_torch(sd, path):
    """A `.pth` zip checkpoint of numpy arrays."""
    import torch

    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def write_all(root):
    """Every tiny network under `root`/<its directory>/<its file> → root."""
    from forge_tpu_torch.core.save import save_safetensors

    for name in TINY:
        _, _, d, f = TINY[name]
        os.makedirs(os.path.join(root, d), exist_ok=True)
        path = os.path.join(root, d, f)
        sd = tiny_sd(name)
        if f.endswith(".pth"):
            write_torch(sd, path)
        else:
            save_safetensors(sd, path)
    return root


# module: (its detector's global, the detector's class, its directory under the models root)
_DETECTORS = {
    "depth": ("_DETECTOR", "MidasDetector", "midas"),
    "depth_anything": ("_DETECTOR", "DepthAnythingDetector", "depth_anything_v2"),
    "openpose": ("_DETECTOR", "OpenposeDetector", "openpose"),
    "hed": ("_DETECTOR", "HedDetector", "hed"),
    "pidinet": ("_DETECTOR", "PidiDetector", "pidinet"),
    "teed": ("_DETECTOR", "TeedDetector", "TEED"),
    "manga_line": ("_DETECTOR", "MangaLineDetector", "manga_line"),
    "mlsd": ("_DETECTOR", "MlsdDetector", "mlsd"),
    "normalbae": ("_DETECTOR", "NormalBaeDetector", "normalbae"),
}


@contextlib.contextmanager
def install(root):
    """Both packages' detectors reading `root`, on the CPU; cv2's IPP off."""
    import cv2

    saved, ipp = [], cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for pkg, kw in (("forge_tpu", {}), ("forge_tpu_torch", {"device": "cpu"})):
            for mod, (glob, cls, d) in _DETECTORS.items():
                m = importlib.import_module(f"{pkg}.preprocessors.{mod}")
                saved.append((m, glob, getattr(m, glob)))
                setattr(m, glob, getattr(m, cls)(model_dir=os.path.join(root, d), **kw))
            m = importlib.import_module(f"{pkg}.preprocessors.lineart")
            if pkg == "forge_tpu":
                for glob, obj in (("_REALISTIC", m.LineartDetector()),
                                  ("_COARSE", m.LineartDetector(coarse=True)),
                                  ("_ANIME", m.LineartAnimeDetector())):
                    obj.model_dir = os.path.join(root, "lineart_anime" if glob == "_ANIME"
                                                 else "lineart")
                    saved.append((m, glob, getattr(m, glob)))
                    setattr(m, glob, obj)
            else:
                saved.append((m, "_DETECTORS", m._DETECTORS))
                m._DETECTORS = {
                    "realistic": m.LineartDetector(model_dir=os.path.join(root, "lineart"), **kw),
                    "coarse": m.LineartDetector(coarse=True,
                                                model_dir=os.path.join(root, "lineart"), **kw),
                    "anime": m.LineartAnimeDetector(
                        model_dir=os.path.join(root, "lineart_anime"), **kw)}
        yield
    finally:
        for m, glob, value in reversed(saved):
            setattr(m, glob, value)
        cv2.ipp.setUseIPP(ipp)


def image(seed=0, h=96, w=128):
    """A smooth seeded uint8 RGB image with edges: blurred noise and a few shapes."""
    import cv2

    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), (0, 0), 4)
    img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)
    cv2.rectangle(img, (w // 5, h // 4), (w // 2, 3 * h // 4), (230, 40, 40), -1)
    cv2.circle(img, (3 * w // 4, h // 2), h // 5, (30, 200, 90), -1)
    cv2.line(img, (0, h - 1), (w - 1, 0), (250, 250, 250), 3)
    return img


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))

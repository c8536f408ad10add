# Copied from forge_tpu/postprocessing/__init__.py (the face restoration exports).
"""Postprocessing: face restoration (CodeFormer, GFPGAN), run on each
generated image under `restore_faces` and by the API's extras routes."""

from .faces import FaceRestorer, RestorerMissing, get_face_restorer, restore_faces_in_image  # noqa: F401

"""The mediapipe_face entry (port of forge_tpu/preprocessors/mediapipe_face.py).

The reference hands the whole annotator to Google's mediapipe package
(annotator/mediapipe_face/mediapipe_face_common.py: FaceMesh and its
drawing utilities); there is no checkpoint to port, the network lives in
that package. The reference raises a RuntimeError where mediapipe cannot be
imported, and it cannot be on the card's machine or beside the tests; the
port never imports it and raises that same error.
"""

from __future__ import annotations

import numpy as np


def mediapipe_face(img: np.ndarray, res: int, a: float, b: float) -> np.ndarray:
    raise RuntimeError("mediapipe_face needs the 'mediapipe' package (pip install "
                       "mediapipe); it is not bundled in this environment")

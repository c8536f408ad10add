"""Primitive ops, the attention and ResBlock front ends, and the CUDA kernels."""

_plain = False  # read by the front ends; set only through plain_versions()


class plain_versions:
    """Within `with plain_versions():` the attention and GroupNorm+SiLU+conv3x3
    front ends call the plain PyTorch versions instead of the kernels, so a
    whole model can be run both ways on the same inputs."""

    def __enter__(self):
        global _plain
        self._previous, _plain = _plain, True

    def __exit__(self, *exc):
        global _plain
        _plain = self._previous

"""The kernel build step forms the right nvcc command (nothing is compiled here)."""

import torch_threads  # noqa: F401  (one torch thread a test process)
import os

import pytest

pytest.importorskip("torch")

from forge_tpu_torch.ops import _build  # noqa: E402


def test_sources_are_the_two_kernels():
    """The SD1.5 slice's two kernels, and the Flux slice's dequant-matmul."""
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["dequant_matmul.cu", "flash_attention.cu", "gn_silu_conv3x3.cu"]


def test_every_source_has_its_own_library_and_entry_point():
    srcs = _build.sources()
    paths = [_build.library_path([src]) for src in srcs]
    assert len(set(paths)) == len(srcs)
    for name in _build.SIGNATURES:
        assert sum(name in open(src).read() for src in srcs) == 1, name


def test_nvcc_command_targets_sm_90a():
    srcs = _build.sources()
    cmd = _build.nvcc_command(srcs, "/tmp/out.so", nvcc="nvcc")
    assert cmd[0] == "nvcc"
    assert cmd[1:3] == ["-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-shared"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-o") + 1] == "/tmp/out.so"
    assert cmd[-len(srcs):] == srcs
    assert "-Xptxas=-v" in _build.nvcc_command(srcs, "x.so", verbose=True)


def test_library_name_follows_source_content(tmp_path):
    a = tmp_path / "k.cu"
    a.write_text("// one")
    first = _build.library_path([str(a)])
    a.write_text("// two")
    assert _build.library_path([str(a)]) != first
    assert os.path.dirname(first) == _build.BUILD_DIR


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A kernel includes csrc/*.cuh: a changed header must not load a stale library."""
    src = tmp_path / "k.cu"
    src.write_text('#include "hopper.cuh"')
    header = tmp_path / "hopper.cuh"
    header.write_text("// one")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    assert _build.headers() == [str(header)]
    first = _build.library_path([str(src)])
    header.write_text("// two")
    assert _build.library_path([str(src)]) != first


def test_build_dir_is_ignored_by_git():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "forge_tpu_torch/_build/" in f.read().split()

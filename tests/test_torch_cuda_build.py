"""The build rule of the port's CUDA libraries (ops/cuda_build.py), on
temporary files and with no nvcc: a library is stale when it is missing
or older than its source or any header the source includes from beside
it, directly or through another header."""

import os

import pytest

from wordpiece_tpu_torch.ops import commit_cuda, cuda_build, match_fast_cuda, text_features_cuda
from wordpiece_tpu_torch.ops import linear_match_cuda, word_kernel_cuda


def _write(path, text, mtime):
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    os.utime(path, (mtime, mtime))


@pytest.fixture
def tree(tmp_path):
    """k.cu includes a.cuh, which includes b.cuh; c.cuh is not included;
    the library is newer than all of them."""
    _write(tmp_path / "b.cuh", "#pragma once\n", 100)
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n#include <cstdint>\n', 100)
    _write(tmp_path / "c.cuh", "#pragma once\n", 100)
    _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n  #  include "a.cuh"\n', 100)
    _write(tmp_path / "libk.so", "", 200)
    return tmp_path


def test_local_includes_follow_headers(tree):
    got = cuda_build.local_includes(str(tree / "k.cu"))
    assert sorted(os.path.basename(p) for p in got) == ["a.cuh", "b.cuh"]


@pytest.mark.parametrize(
    "touched,stale",
    [(None, False), ("k.cu", True), ("a.cuh", True), ("b.cuh", True), ("c.cuh", False),
     ("missing", True)],
)
def test_is_stale(tree, touched, stale):
    lib = tree / "libk.so"
    if touched == "missing":
        os.remove(lib)
    elif touched is not None:
        os.utime(tree / touched, (300, 300))
    assert cuda_build.is_stale(str(tree / "k.cu"), str(lib)) is stale


@pytest.mark.parametrize("mod", [text_features_cuda, commit_cuda, match_fast_cuda,
                                 word_kernel_cuda, linear_match_cuda],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_source_and_header_is_in_csrc(mod):
    """Each wrapper's source exists, and every header it includes lies in
    csrc/ beside it."""
    assert os.path.exists(mod.SOURCE)
    for dep in cuda_build.local_includes(mod.SOURCE):
        assert os.path.dirname(dep) == os.path.normpath(cuda_build.CSRC_DIR)
    if mod in (text_features_cuda, commit_cuda):
        names = {os.path.basename(p) for p in cuda_build.local_includes(mod.SOURCE)}
        assert "scan.cuh" in names

"""The port's native loader rebuilds a stale library: one older than
wordpiece_host.cc or the Makefile is built again before it is loaded, and
a current one is loaded as it is.  Held on a stand-in directory in
tmp_path whose Makefile copies the source, never on the package's own
native/ directory, which other test processes load."""

import os

import pytest
import torch

from wordpiece_tpu_torch.runtime import loader

torch.set_num_threads(1)

MAKEFILE = "lib.so: src.cc Makefile\n\tcp src.cc $@.tmp && mv -f $@.tmp $@\n"
FAILING_MAKEFILE = "lib.so: src.cc Makefile\n\tfalse\n"


def _tree(tmp_path, makefile=MAKEFILE, lib=b"old build"):
    """tmp_path with src.cc, Makefile and (unless lib is None) lib.so,
    stamped at t = 1000 s and lib.so at t = 2000 s.  Returns (library,
    sources)."""
    (tmp_path / "src.cc").write_bytes(b"new source")
    (tmp_path / "Makefile").write_text(makefile)
    for name in ("src.cc", "Makefile"):
        os.utime(tmp_path / name, (1000, 1000))
    so = tmp_path / "lib.so"
    if lib is not None:
        so.write_bytes(lib)
        os.utime(so, (2000, 2000))
    return str(so), (str(tmp_path / "src.cc"), str(tmp_path / "Makefile"))


def test_the_loader_watches_the_ports_own_source_and_makefile():
    native = os.path.join(os.path.dirname(loader.__file__), "native")
    assert loader._SOURCES == (os.path.join(native, "wordpiece_host.cc"),
                               os.path.join(native, "Makefile"))
    assert os.path.dirname(loader._SO) == native


@pytest.mark.parametrize("newer", [None, "src.cc", "Makefile"])
def test_is_stale_when_a_source_is_newer(tmp_path, newer):
    so, sources = _tree(tmp_path)
    assert not loader.is_stale(so, sources)
    if newer is not None:
        os.utime(tmp_path / newer, (3000, 3000))
        assert loader.is_stale(so, sources)


def test_a_missing_library_is_stale(tmp_path):
    so, sources = _tree(tmp_path, lib=None)
    assert loader.is_stale(so, sources)


@pytest.mark.parametrize("newer", ["src.cc", "Makefile", "lib.so missing"])
def test_a_stale_library_is_rebuilt(tmp_path, newer):
    so, sources = _tree(tmp_path, lib=None if newer == "lib.so missing" else b"old build")
    if newer != "lib.so missing":
        os.utime(tmp_path / newer, (3000, 3000))
    assert loader.ensure_built(str(tmp_path), so, sources)
    assert open(so, "rb").read() == b"new source"
    assert not loader.is_stale(so, sources)
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_a_current_library_is_loaded_as_it_is(tmp_path):
    so, sources = _tree(tmp_path)
    assert loader.ensure_built(str(tmp_path), so, sources)
    assert open(so, "rb").read() == b"old build"
    assert os.path.getmtime(so) == 2000


def test_a_failed_build_keeps_the_older_library(tmp_path):
    so, sources = _tree(tmp_path, makefile=FAILING_MAKEFILE)
    os.utime(tmp_path / "src.cc", (3000, 3000))
    assert loader.ensure_built(str(tmp_path), so, sources)
    assert open(so, "rb").read() == b"old build"


def test_a_failed_build_without_a_library_reports_none(tmp_path):
    so, sources = _tree(tmp_path, makefile=FAILING_MAKEFILE, lib=None)
    assert not loader.ensure_built(str(tmp_path), so, sources)

"""Build of the native codec binary.

The repo ships ``csrc/radc.cpp``, never a binary.  The loader
(`radz/_native.py::ensure_built`) builds ``csrc/libradc.so`` at first
use and again whenever the sha256 the Makefile stamps into
``libradc.buildinfo`` differs from the source's.
"""

import hashlib
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parent.parent / "csrc"


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_libradc_builds_from_source(tmp_path):
    for name in ("radc.cpp", "Makefile"):
        shutil.copy(CSRC / name, tmp_path / name)
    subprocess.run(["make", "-C", str(tmp_path)], check=True,
                   capture_output=True, timeout=300)
    so = tmp_path / "libradc.so"
    assert so.exists() and so.stat().st_size > 10000
    info = (tmp_path / "libradc.buildinfo").read_text()
    src_hash = hashlib.sha256((CSRC / "radc.cpp").read_bytes()).hexdigest()
    assert src_hash in info
    # The fresh build must expose the same entry points the bindings use.
    import ctypes

    lib = ctypes.CDLL(str(so))
    for sym in ("radc_walk_records", "radc_walk_records_mt",
                "radc_format_triplets"):
        assert hasattr(lib, sym)


def _csrc_copy(tmp_path):
    for name in ("radc.cpp", "Makefile"):
        shutil.copy(CSRC / name, tmp_path / name)
    return tmp_path


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_build_triggered_by_source_hash(tmp_path):
    """A binary stamped with the source's hash is reused as it is; a
    stale stamp (even with a newer binary mtime) triggers a rebuild."""
    from alevin_fry_tpu.radz import _native

    d = _csrc_copy(tmp_path)
    so = _native.ensure_built(d)
    assert so == d / "libradc.so" and so.exists()
    built = so.stat().st_mtime_ns
    assert _native.ensure_built(d) == so
    assert so.stat().st_mtime_ns == built  # up to date: no rebuild
    info = d / "libradc.buildinfo"
    info.write_text(info.read_text().replace("source_sha256:", "source_sha256: 0"))
    assert _native.ensure_built(d) == so
    src_hash = hashlib.sha256((d / "radc.cpp").read_bytes()).hexdigest()
    assert _native._stamped_sha256(info) == src_hash


def test_failed_build_is_logged(tmp_path, caplog):
    """A source that does not compile gives no library and a logged
    compiler error, not a silent fallback."""
    from alevin_fry_tpu.radz import _native

    d = _csrc_copy(tmp_path)
    (d / "radc.cpp").write_text("this is not C++\n")
    with caplog.at_level("ERROR", logger="aft.native"):
        assert _native.ensure_built(d) is None
    assert "building the native codec failed" in caplog.text
    assert not (d / "libradc.so").exists()


def test_binary_is_ignored():
    """The checkout carries the source and Makefile; the build outputs
    are listed in .gitignore so they are never committed."""
    ignored = set((CSRC.parent / ".gitignore").read_text().split())
    assert {"csrc/libradc.so", "csrc/libradc.buildinfo"} <= ignored
    assert (CSRC / "radc.cpp").exists() and (CSRC / "Makefile").exists()

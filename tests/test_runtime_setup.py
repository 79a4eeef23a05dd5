"""Process set-up that does not depend on the device: the compile
cache's placement, the dense EM's memory budget, the WTA output mode,
and the chip smoke test's refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    from alevin_fry_tpu.utils import configure_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = configure_compile_cache()
        assert got == REPO / ".jax_cache"
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_obeys_environment(monkeypatch, tmp_path):
    import jax

    from alevin_fry_tpu.utils import configure_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert configure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_dense_em_cap_from_device_memory(monkeypatch):
    import jax

    from alevin_fry_tpu.ops import em

    class Dev:
        platform = "gpu"
        device_kind = "test card"

        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    monkeypatch.setattr(jax, "devices", lambda: [Dev({"bytes_limit": 8 << 30})])
    assert em.dense_em_cap_bytes() == 3 << 30
    monkeypatch.setattr(jax, "devices", lambda: [Dev(None)])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        em.dense_em_cap_bytes()


def test_dense_em_cap_on_cpu_uses_host_memory():
    from alevin_fry_tpu.ops import em

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert em.dense_em_cap_bytes() == host * 3 // 8


def test_wta_output_mode_auto_is_fuse(monkeypatch):
    from alevin_fry_tpu.ops.crlike_device import _wta_output_mode

    monkeypatch.delenv("AFT_WTA_COMPACT", raising=False)
    assert _wta_output_mode() == "fuse"
    for mode in ("fuse", "1", "0"):
        monkeypatch.setenv("AFT_WTA_COMPACT", mode)
        assert _wta_output_mode() == mode


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
        text=True, env=env, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stdout

import os
import sys

import pytest

# CPU by default with a virtual 8-device mesh, so sharding tests run
# anywhere; the GPU-marked tests run on a card with JAX_PLATFORMS=cuda
# (or in-process from chip_smoke.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` need an NVIDIA card and skip without one."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")

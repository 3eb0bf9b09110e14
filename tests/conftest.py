import os
import subprocess
import sys

# Force the CPU backend with a virtual 8-device mesh for all tests: multi-
# device sharding is validated without accelerator hardware (SURVEY.md §4).
# Backends are cleared and re-pinned to CPU in case anything initialized
# another platform first — tests must not depend on (or spend) device time.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.extend.backend as _jeb  # noqa: E402

_jeb.clear_backends()
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "oracle")
REFERENCE = "/root/reference"


def oracle_bin(name: str) -> str:
    """Path to an oracle binary, building the oracle tools on demand."""
    path = os.path.join(ORACLE, "bin", name)
    if not os.path.exists(path):
        subprocess.run(["sh", os.path.join(ORACLE, "build.sh")], check=True,
                       capture_output=True)
    return path


@pytest.fixture(scope="session")
def harness():
    if not os.path.isdir(REFERENCE):
        pytest.skip("reference tree not available")
    return oracle_bin("harness")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run on the "
        "card by chip_smoke.py)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend (the kernels' card-only checks run "
                    "in chip_smoke.py)")


@pytest.fixture(scope="session", autouse=True)
def _assert_cpu_backend():
    """Tests run on the virtual CPU mesh, never on device time."""
    import jax

    assert jax.default_backend() == "cpu", jax.devices()
    assert len(jax.devices()) == 8

"""Process-level JAX set-up shared by every entry point.

Two rules hold for the CLI, the distributed runner, `bench.py` and
`chip_smoke.py` alike:

  * the persistent compilation cache lives where
    `JAX_COMPILATION_CACHE_DIR` says, or else in one fixed directory of
    the checkout (a moving path never hits the cache);
  * the device engine runs on the platform `JAX_PLATFORMS` names, and
    with that variable unset it runs on a GPU or not at all: a machine
    without one is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  With JAX_COMPILATION_CACHE_DIR set, JAX reads
    the variable itself and nothing is set here."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_device_platform() -> str:
    """Platform of the device engine.  Without JAX_PLATFORMS the engine
    needs a GPU; exits naming the missing device when JAX finds none."""
    import jax

    platform = jax.default_backend()
    if not os.environ.get("JAX_PLATFORMS") and platform != "gpu":
        sys.exit(f"fasim: no GPU found (JAX backend is {platform!r}); set "
                 "JAX_PLATFORMS to run the device engine on another "
                 "platform, or use --tpu-engine numpy")
    return platform

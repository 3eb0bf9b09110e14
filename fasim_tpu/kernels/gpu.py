"""CUDA kernels of the scan and window passes, called through `jax.ffi`.

`sw_dp.cu` holds one DP core for both passes (design notes there; the
NumPy mirror of its decomposition is `gpu_model.py`).  This module builds
it with `nvcc` into `<repo>/build/` on first use, registers the two FFI
targets for the CUDA platform, and wraps them as jitted steps with the
same contract as `xla.colmax_xla` / `xla.window_pass_xla`.

Build by hand with `python -m fasim_tpu.kernels.gpu`.  A failed build or
registration raises: an engine on a GPU never falls back to XLA.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

LANES = 32  # lanes of a warp: one query strip each
MAX_STRIP = 32  # rows a lane keeps in registers

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sw_dp.cu")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build")
LIB = os.path.join(BUILD_DIR, "libfasim_sw_dp.so")
PTXAS_LOG = os.path.join(BUILD_DIR, "sw_dp.ptxas.txt")

_lock = threading.Lock()
_registered = False


def plan(rows: int, lanes: int = LANES) -> tuple[int, int]:
    """(strip rows per lane, passes) covering `rows` query rows: the
    fewest passes of at most `lanes * MAX_STRIP` rows, then the smallest
    strip (a multiple of 4) that covers the rows in that many passes."""
    n_pass = max(1, -(-rows // (lanes * MAX_STRIP)))
    rs = -(-rows // (lanes * n_pass))
    return max(4, -(-rs // 4) * 4), n_pass


def use_kernels(device) -> bool:
    """The engines run the CUDA kernels on a GPU and XLA elsewhere."""
    return device.platform == "gpu"


def nvcc() -> str:
    """Path of the CUDA compiler (PATH first, then the toolkit's default
    location); raises when there is none."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA scan kernels cannot be built")


def build() -> str:
    """Compile sw_dp.cu into BUILD_DIR if the library is missing or older
    than its source; returns the library path."""
    if os.path.exists(LIB) and os.path.getmtime(LIB) >= os.path.getmtime(
            _SRC):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.tmp{os.getpid()}"
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "--resource-usage", "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    with open(PTXAS_LOG, "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(tmp, LIB)
    return LIB


def register() -> None:
    """Build (if stale) and register the FFI targets, once per process."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build())
        for name, sym in (("fasim_colmax", lib.FasimColmax),
                          ("fasim_window", lib.FasimWindow)):
            jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(sym),
                                        platform="CUDA")
        _registered = True


@functools.partial(jax.jit, static_argnames=("m16",))
def colmax_cuda(codes: jax.Array, matq: jax.Array, *, m16: int) -> jax.Array:
    """Contract of xla.colmax_xla: codes uint8/int32[S, T, N], matq
    int32[C, Mp]; exact int32[S, T, N] column maxima over rows < m16."""
    with jax.named_scope("colmax"):
        S, T, N = codes.shape
        rs, n_pass = plan(m16)
        P = S * T
        bnd = (P, N, 4) if n_pass > 1 else (1, 4)
        out, _ = jax.ffi.ffi_call(
            "fasim_colmax",
            (jax.ShapeDtypeStruct((P, N), jnp.int32),
             jax.ShapeDtypeStruct(bnd, jnp.int32)))(
                codes.reshape(P, N).astype(jnp.uint8), matq,
                m16=np.int32(m16), rs=np.int32(rs), n_pass=np.int32(n_pass))
        return out.reshape(S, T, N)


def window_profile(qp: np.ndarray, n_codes: int = 6) -> np.ndarray:
    """[n_codes, Mp] profile of the window pass from its (q, hi, lo)
    query rows: prof[c, i] = hi[i] if c == q[i] else lo[i].  Codes at or
    above n_codes - 1 never equal a query code, so they all read the
    last row (lo); the kernel clamps codes to it."""
    c = np.arange(n_codes)[:, None]
    return np.where(c == qp[0][None, :], qp[1][None, :],
                    qp[2][None, :]).astype(np.int32)


def window_rows(m: int) -> int:
    """Query rows the window pass computes: every mreals bound (m plus at
    most 15 phantom rows of the 16-lane byte pass) lies within."""
    return m + 15


@functools.partial(jax.jit, static_argnames=("m", "rev"))
def window_pass_cuda(codes, offs, terms, rlens, mreals, prof, *, m: int,
                     rev: bool = False):
    """Contract of xla.window_pass_xla with the profile of
    window_profile(qp); requires m <= mreals <= window_rows(m)."""
    with jax.named_scope("window_rev" if rev else "window_fwd"):
        R, W = codes.shape
        rows = window_rows(m)
        rs, n_pass = plan(rows)
        bnd = (R, W, 4) if n_pass > 1 else (1, 4)
        out, _ = jax.ffi.ffi_call(
            "fasim_window",
            (jax.ShapeDtypeStruct((R, 3), jnp.int32),
             jax.ShapeDtypeStruct(bnd, jnp.int32)))(
                codes.astype(jnp.uint8), offs, terms, rlens, mreals, prof,
                m=np.int32(m), rows=np.int32(rows), rs=np.int32(rs),
                n_pass=np.int32(n_pass))
        return out


if __name__ == "__main__":
    print(build())

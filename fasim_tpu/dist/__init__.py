"""Mesh setup and sharded execution of the segment-batched scan step.

The reference is single-threaded (SURVEY.md §2.b); parallelism here is the
framework's own design:

  * ``seg``  — data-parallel axis over 5 kb DNA segments (the primary
    axis: segments are independent by construction of the overlapping
    segmentation, fastsim.h:71-90);
  * ``rule`` — "expert"-style axis over the 48 pairing-rule transforms of
    each segment (embarrassingly parallel).

The production single-process multi-card path does not use a mesh at all:
batches round-robin across per-device engines (scan/batched.py) because
the work is embarrassingly parallel and needs no collectives.  The mesh
step here is the collective-free sharded expression of the same scan for
pjit-style deployments; the tests run it on a virtual CPU mesh.

The device-side step is pure XLA (kernels/xla.py) so it partitions with
sharding annotations alone — no hand-written collectives are needed until
the trailing host gather of candidate hits, which is a bounded-size
``process_allgather`` in the multi-host runner.

Determinism: the scan step is batched elementwise over (seg, rule), so its
results are independent of mesh shape and shard placement; hit lists are
merged on host in (record, segment, transform) order regardless of which
device produced them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import BYTE_SAT
from ..kernels.xla import colmax_xla

AXES = ("seg", "rule")


def make_mesh(n_seg: int = 0, n_rule: int = 1, devices=None) -> Mesh:
    """Build a (seg, rule) mesh.  n_seg=0 uses all remaining devices."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_seg == 0:
        n_seg = max(1, len(devices) // n_rule)
    n = n_seg * n_rule
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(n_seg, n_rule)
    return Mesh(arr, AXES)


def byte_break(colmax: jax.Array) -> jax.Array:
    """Device-side equivalent of kernels.common.apply_byte_break
    (sswNew.cpp:384-386): zero from the first column max >= 251 on."""
    n = colmax.shape[-1]
    sat = colmax >= BYTE_SAT
    first = jnp.where(sat.any(axis=-1), jnp.argmax(sat, axis=-1), n)
    pos = jnp.arange(n, dtype=jnp.int32)
    return jnp.where(pos < first[..., None], colmax, 0)


def scan_step(codes_thresh: jax.Array, codes_ssw: jax.Array,
              matq_thresh: jax.Array, matq_ssw: jax.Array,
              *, m16: int) -> tuple[jax.Array, jax.Array]:
    """Device-side scan step for a batch of (segment, transform) pairs.

    codes_*: int32[S, T, N];  matq_*: int32[C+1, Mp].
    Returns (thresh int32[S, T], colmax int32[S, T, N] after byte break).
    The host derives min_score = int(0.8 * thresh) and runs peak
    extraction / candidate realignment on the colmax rows.
    """
    thresh_cm = colmax_xla(codes_thresh, matq_thresh, m16=m16)
    scan_cm = colmax_xla(codes_ssw, matq_ssw, m16=m16)
    return thresh_cm.max(axis=-1), byte_break(scan_cm)


def sharded_scan_step(mesh: Mesh, m16: int):
    """jit scan_step over the mesh: segments sharded on ``seg``,
    transforms on ``rule``, the query profile replicated (the DP carries
    the whole query per shard — cheapest layout: no collective ever
    runs)."""
    codes_s = NamedSharding(mesh, P("seg", "rule", None))
    matq_s = NamedSharding(mesh, P(None, None))
    out_s = (NamedSharding(mesh, P("seg", "rule")),
             NamedSharding(mesh, P("seg", "rule", None)))
    return jax.jit(
        functools.partial(scan_step, m16=m16),
        in_shardings=(codes_s, codes_s, matq_s, matq_s),
        out_shardings=out_s)

"""Scan engine of the device path, and the plain XLA form of its passes.

`XlaScanEngine` builds transform codes and query profiles on the host
and runs the two hot Smith-Waterman passes on one device: the scan
pass (exact per-column maxima over the query, `colmax`) and the
candidate-window pass (`window_pass`).  On a GPU both run as the CUDA
kernels of `gpu.py`; everywhere else, and as the reference those
kernels are held to, they run as the plain XLA programs below:
`lax.scan` over reference columns, with `lax.associative_scan` for the
vertical-gap prefix max.

The math mirrors `batch_np.numpy_engine` (see `ref.py` for the exactness
argument vs the reference SSE2 kernels, stats.h:495-734 and
sswNew.cpp:255-464): affine-gap SW, gap open 16 / extend 4, per-column
maxima over the query axis including the striped byte kernel's phantom
rows (< m16), byte-break applied as a post-op.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GAP_EXTEND, GAP_OPEN
from ..rules import SSW_ENC, SSW_MAT, THRESH_ENC, THRESH_MAT
from . import gpu
from .common import PURE, PURE_OR_PAD, apply_byte_break, pack_candidates_np

_NEG = -(2 ** 30)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.partial(jax.jit, static_argnames=("m16",))
def colmax_xla(codes: jax.Array, matq: jax.Array, *, m16: int) -> jax.Array:
    """codes: int32[S, T, N] (pad rows score 0); matq: int32[C, Mp]
    query profile.  Returns exact int32[S, T, N] column maxima."""
    with jax.named_scope("colmax"):
        S, T, N = codes.shape
        Mp = matq.shape[1]
        go = jnp.int32(GAP_OPEN)
        ge = jnp.int32(GAP_EXTEND)
        idx = jnp.arange(Mp, dtype=jnp.int32)
        fbias = idx * ge
        foff = go + (idx - 1) * ge
        real_row = idx < m16

        def step(carry, code_col):
            H, E = carry  # (S, T, Mp)
            s_col = matq[code_col]  # (S, T, Mp)
            E = jnp.maximum(E - ge, H - go)
            diag = jnp.pad(H[..., :-1], ((0, 0), (0, 0), (1, 0)))
            tmp = jnp.maximum(jnp.maximum(diag + s_col, E), 0)
            run = jax.lax.associative_scan(jnp.maximum, tmp + fbias, axis=-1)
            F = jnp.pad(run[..., :-1], ((0, 0), (0, 0), (1, 0)),
                        constant_values=_NEG) - foff
            H = jnp.maximum(tmp, F)
            cm = jnp.max(jnp.where(real_row, H, 0), axis=-1)  # (S, T)
            return (H, E), cm

        init = (jnp.zeros((S, T, Mp), jnp.int32),
                jnp.zeros((S, T, Mp), jnp.int32))
        _, cms = jax.lax.scan(step, init, jnp.moveaxis(codes, -1, 0))
        return jnp.moveaxis(cms, 0, -1)


def _row_bucket(r: int) -> int:
    """Window-pass row count padded to a power of two (>= 64), so a run
    compiles a handful of window shapes instead of one per batch."""
    return max(64, 1 << (r - 1).bit_length())


class XlaScanEngine:
    """numpy_engine-contract engine on one device: the CUDA kernels of
    gpu.py on a GPU, the plain XLA passes of this module elsewhere."""

    def __init__(self, rna: np.ndarray, device=None):
        self.device = jax.devices()[0] if device is None else device
        self._put = functools.partial(jax.device_put, device=self.device)
        # implementation of the scan and the window pass: "cuda" or "xla"
        impl = "cuda" if gpu.use_kernels(self.device) else "xla"
        self.scan_impl = self.window_impl = impl
        if impl == "cuda":
            gpu.register()
        self.n_batches = 0  # scan batches run on this device
        self._count_lock = threading.Lock()
        m = len(rna)
        self.m16 = _round_up(m, 16)
        mp = self.m16

        def make_matq(enc, mat):
            q = enc[rna]
            mq = np.zeros((mat.shape[1] + 1, mp), np.int32)
            mq[:-1, :m] = mat[q].T  # phantom rows and the pad code score 0
            return self._put(mq)

        self.matq_ssw = make_matq(SSW_ENC, SSW_MAT)
        self.matq_thresh = make_matq(THRESH_ENC, THRESH_MAT)
        self.query_pure = bool(PURE[rna].all())
        self._scan_luts = None

    def setup_scans(self, scans: list[dict]) -> None:
        """Compose each scan's rule LUT with the SSW and threshold
        encoders: byte -> code tables uint8[T, 256] per alphabet."""
        from .. import rules

        t = len(scans)
        lut_s = np.empty((t, 256), np.uint8)
        lut_t = np.empty((t, 256), np.uint8)
        is_tr = np.zeros(t, bool)
        for k, sc in enumerate(scans):
            rl = rules.transfer_lut(sc["strand"], sc["para"], sc["rule"])
            lut_s[k] = SSW_ENC[rl].astype(np.uint8)
            lut_t[k] = THRESH_ENC[rl].astype(np.uint8)
            is_tr[k] = sc["xform"] == "tr"
        self._scan_luts = (lut_s, lut_t, is_tr)

    def transform_codes(self, segs: np.ndarray, lengths: np.ndarray,
                        which: str) -> np.ndarray:
        """Codes uint8[S, T, N] of every transform of a segment batch
        uint8[S, N] (real lengths int32[S]) in the "ssw" or "thresh"
        alphabet; reversing transforms reverse within the real length."""
        lut_s, lut_t, is_tr = self._scan_luts
        S, N = segs.shape
        pos = np.arange(N)
        ridx = np.where(pos[None, :] < lengths[:, None],
                        lengths[:, None] - 1 - pos[None, :], pos[None, :])
        seg_rev = np.take_along_axis(segs, ridx, axis=1)
        sel = np.where(is_tr[None, :, None], seg_rev[:, None, :],
                       segs[:, None, :]).astype(np.int64)
        lut = lut_s if which == "ssw" else lut_t
        return np.take_along_axis(lut[None, :, :], sel, axis=2)

    def scan_segments(self, segs: np.ndarray, lengths: np.ndarray):
        """Scan pass of a segment batch uint8[S, N] (real lengths int32[S]):
        runs the exact pass over every transform and returns (thresh
        int32[S, T], colmax uint8[S, T, N] clamped at 255)."""
        cm = self.colmax_batch(self.transform_codes(segs, lengths, "ssw"),
                               "ssw")
        if self.query_pure and bool(PURE_OR_PAD[segs].all()):
            # fused threshold: for pure-ACGT input the two engines run the
            # identical DP (common.PURE), so the exact threshold is the
            # scan pass's int32 column-max reduced over columns
            thresh = cm.max(axis=-1).astype(np.int32)
        else:
            thresh = self.max_batch(
                self.transform_codes(segs, lengths, "thresh"), "thresh")
        return thresh, np.minimum(cm, 255).astype(np.uint8)

    def colmax_batch(self, codes: np.ndarray, which: str) -> np.ndarray:
        """Exact int32[S, T, N] column maxima of codes int[S, T, N] in the
        "ssw" or "thresh" alphabet."""
        matq = self.matq_ssw if which == "ssw" else self.matq_thresh
        if self.scan_impl == "cuda":
            out = gpu.colmax_cuda(self._put(np.asarray(codes, np.uint8)),
                                  matq, m16=self.m16)
        else:
            out = colmax_xla(self._put(np.asarray(codes, np.int32)), matq,
                             m16=self.m16)
        return np.asarray(jax.device_get(out))

    def max_batch(self, codes: np.ndarray, which: str) -> np.ndarray:
        """Exact global SW max int32[S, T] (every column max is exact, so
        no byte -> word escalation is needed)."""
        return self.colmax_batch(codes, which).max(axis=-1).astype(np.int32)

    def __call__(self, rna: np.ndarray, seq2_list: list[np.ndarray]
                 ) -> tuple[np.ndarray, np.ndarray]:
        seq2 = np.stack(seq2_list)
        thresh_cm = self.colmax_batch(
            THRESH_ENC[seq2].astype(np.int32)[None], "thresh")[0]
        scan_cm = self.colmax_batch(
            SSW_ENC[seq2].astype(np.int32)[None], "ssw")[0]
        thresh = thresh_cm.max(axis=1).astype(np.int32)
        return thresh, apply_byte_break(scan_cm)

    # -- candidate-window passes (device equivalent of the per-candidate
    #    forward/reverse striped passes, sswNew.cpp:1446-1547) --------------

    def setup_windows(self, rna: np.ndarray) -> None:
        """Precompute the (q, hi, lo) query rows for the window passes:
        forward uses the query as-is, reverse uses the reversed query (a
        reverse pass on query prefix [0..e] is the same DP on the reversed
        full query with the leading M-1-e rows' profile zeroed — zero-
        profile rows above the real block are inert, H stays 0).  The
        CUDA pass reads them as a code x row profile."""
        self.m = len(rna)
        self.qwin = {False: _window_qp(rna), True: _window_qp(rna[::-1])}
        self.qwin_dev = {rev: self._put(qp) for rev, qp in self.qwin.items()}
        self.wprof_dev = {rev: self._put(gpu.window_profile(qp))
                          for rev, qp in self.qwin.items()}

    PACK_K = 384

    def scan_segments_packed(self, segs: np.ndarray, lengths: np.ndarray):
        """scan_segments plus the host-packed candidate columns:
        (thresh, colmax, pos, val, cnt), see common.pack_candidates_np."""
        with self._count_lock:
            self.n_batches += 1
        thresh, cm = self.scan_segments(segs, lengths)
        pos, val, cnt = pack_candidates_np(thresh, cm, lengths, self.PACK_K)
        return thresh, cm, pos, val, cnt

    def window_pass_specs(self, segs: np.ndarray, lengths: np.ndarray,
                          spec: dict, rev: bool) -> np.ndarray:
        """Production window-pass entry: window codes built from the
        segment batch + composed LUTs, then the exact pass."""
        if len(spec["seg_idx"]) == 0:
            return np.zeros((0, 3), np.int32)
        lut_s, _, is_tr = self._scan_luts
        codes = build_window_codes(segs, lengths, lut_s, is_tr, spec)
        return np.asarray(self.window_pass(
            codes, spec["offs"], spec["terms"], spec["rlens"],
            spec["mreals"], rev))

    def window_pass(self, codes: np.ndarray, offs: np.ndarray,
                    terms: np.ndarray, rlens: np.ndarray,
                    mreals: np.ndarray, rev: bool):
        """Batched window pass.  codes uint8[R, W] (SSW alphabet, pad
        anything); offs/terms/rlens/mreals int32[R].  Returns a device
        array int32[R, 3] = (best, end_col, end_row); see window_pass_xla
        for semantics.  Asynchronous — caller np.asarray()s the result."""
        R, W = codes.shape
        rb = _row_bucket(R)
        m16 = _round_up(self.m, 16)

        def rows(a, fill, dtype=np.int32):
            out = np.full((rb,) + a.shape[1:], fill, dtype)
            out[:R] = a
            return self._put(out)

        # pad rows have rlens 0: they never update and are sliced off
        args = (rows(codes, 4, np.uint8), rows(offs, 0), rows(terms, -1),
                rows(rlens, 0), rows(mreals, m16))
        if self.window_impl == "cuda":
            mreals = np.asarray(mreals)
            if R and not ((mreals >= self.m).all() and (
                    mreals <= gpu.window_rows(self.m)).all()):
                raise ValueError("window pass: mreals outside "
                                 "[m, m + 15]")
            out = gpu.window_pass_cuda(*args, self.wprof_dev[rev], m=self.m,
                                       rev=rev)
        else:
            out = window_pass_xla(*args, self.qwin_dev[rev], m=self.m,
                                  rev=rev)
        return out[:R]


def build_window_codes(segs: np.ndarray, lengths: np.ndarray,
                       lut_s: np.ndarray, is_tr: np.ndarray,
                       spec: dict, W: int = 256) -> np.ndarray:
    """Window codes uint8[rows, W] of a spec batch: row r reads W bytes
    of segment seg_idx[r] (its reversed copy for reversing transforms)
    from base[r] in direction dirn[r], maps them through its scan's LUT,
    and pads past rlens[r] with code 4."""
    S, N = segs.shape
    pos = np.arange(N)
    ridx = np.where(pos[None, :] < lengths[:, None],
                    lengths[:, None] - 1 - pos[None, :], pos[None, :])
    segs_rev = np.take_along_axis(segs, ridx, axis=1)
    both = np.stack([segs, segs_rev]).reshape(-1)
    li = np.arange(W, dtype=np.int64)[None, :]
    p = np.clip(spec["base"][:, None] + spec["dirn"][:, None] * li, 0,
                N - 1)
    segsel = np.where(is_tr[spec["scan_idx"]], 1, 0).astype(np.int64)
    byte = both[(segsel[:, None] * S
                 + spec["seg_idx"][:, None].astype(np.int64)) * N + p]
    code = lut_s[spec["scan_idx"][:, None], byte.astype(np.int64)]
    return np.where(li < spec["rlens"][:, None], code, 4).astype(np.uint8)


def _window_qp(rna: np.ndarray) -> np.ndarray:
    """(q, hi, lo) int32[3, Mp] rows for the window pass (SSW alphabet):
    s(code, row) = hi if code == q else lo; rows >= len(rna) are
    zero-profile (the striped kernels' phantom rows)."""
    m = len(rna)
    mp = _round_up(m + 63, 128)  # >= 15 phantom rows after m for any lanes
    q = SSW_ENC[rna].astype(np.int32)
    qp = np.zeros((3, mp), np.int32)
    qp[0, :m] = q
    qp[0, m:] = -1
    qp[1, :m] = np.where(q < 4, 5, -4)
    qp[2, :m] = -4
    return qp


@functools.partial(jax.jit, static_argnames=("m", "rev"))
def window_pass_xla(codes, offs, terms, rlens, mreals, qp, *, m: int,
                    rev: bool = False):
    """Exact emulation of one striped end-finding pass per row
    (sw_sse2_byte/word, sswNew.cpp:476-1069; golden model
    kernels/align.py:_sw_end_pass) vectorized over R candidate windows.

    Per row: affine SW of the (shared) query against that row's window
    codes, returning
      best    — running max of the column maxima,
      end_col — scan index of the last strict improvement (-1 if none),
      end_row — lowest query row attaining the max in that column (the
                striped kernel's min-scan), kernel-space index,
    with the reverse pass's terminate semantics: after the update, if a
    column's max (phantom rows included) equals `terms[r]`, the row stops
    updating (the reference breaks out of the loop, sswNew.cpp:617).

    offs[r]: first real query row (rows below are zero-profile — used to
    run reversed-prefix queries against the shared reversed-query rows).
    rlens[r]: real window length (pad columns beyond never update).
    mreals[r]: exclusive row bound of the column max = m + phantom rows
    ((-Mr) % lanes of the emulated pass, lanes 16 byte / 8 word) — the
    phantom rows' diagonal carry is part of the terminate-equality
    semantics and must be modeled exactly.

    rev only names the step (window_fwd / window_rev) for traces.
    """
    with jax.named_scope("window_rev" if rev else "window_fwd"):
        R, W = codes.shape
        Mp = qp.shape[1]
        go = jnp.int32(GAP_OPEN)
        ge = jnp.int32(GAP_EXTEND)
        idx = jnp.arange(Mp, dtype=jnp.int32)
        q = qp[0][None, :]
        hi = qp[1][None, :]
        lo = qp[2][None, :]
        smask = idx[None, :] >= offs[:, None]  # zero profile below the offset
        cmask = idx[None, :] < mreals[:, None]  # column max incl. phantom rows
        rmask = (idx[None, :] < m) & smask  # end_row over real rows only
        fbias = idx * ge
        foff = go + (idx - 1) * ge
        big = jnp.int32(1 << 30)

        def step(carry, xk):
            code_col, k = xk  # (R,), ()
            H, E, best, ecol, erow, act = carry
            code = code_col[:, None]
            s = jnp.where(smask & (code == q), hi, jnp.where(smask, lo, 0))
            E = jnp.maximum(E - ge, H - go)
            diag = jnp.pad(H[:, :-1], ((0, 0), (1, 0)))
            tmp = jnp.maximum(jnp.maximum(diag + s, E), 0)
            run = jax.lax.associative_scan(jnp.maximum, tmp + fbias, axis=-1)
            F = jnp.pad(run[:, :-1], ((0, 0), (1, 0)), constant_values=_NEG) \
                - foff
            H = jnp.maximum(tmp, F)
            cm = jnp.max(jnp.where(cmask, H, 0), axis=-1)  # (R,)
            rm = jnp.min(jnp.where(rmask & (H == cm[:, None]), idx, big),
                         axis=-1)
            in_range = k < rlens
            upd = act & (cm > best) & in_range
            best = jnp.where(upd, cm, best)
            ecol = jnp.where(upd, k, ecol)
            erow = jnp.where(upd, rm, erow)
            act = act & ~((cm == terms) & in_range)
            return (H, E, best, ecol, erow, act), None

        init = (jnp.zeros((R, Mp), jnp.int32), jnp.zeros((R, Mp), jnp.int32),
                jnp.zeros(R, jnp.int32), jnp.full(R, -1, jnp.int32),
                jnp.full(R, m - 1, jnp.int32), jnp.ones(R, jnp.bool_))
        cols = jnp.moveaxis(codes.astype(jnp.int32), -1, 0)  # (W, R)
        ks = jnp.arange(W, dtype=jnp.int32)
        (_, _, best, ecol, erow, _), _ = jax.lax.scan(step, init, (cols, ks))
        return jnp.stack([best, ecol, erow], axis=-1)

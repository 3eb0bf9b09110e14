"""NumPy mirror of the CUDA kernels' decomposition (sw_dp.cu).

The CUDA kernels have no interpret mode, so their arithmetic is tested
here, on the CPU, through a model that follows them step for step: the
32 lanes of a warp as an array axis, each lane's strip of RS query rows,
the wavefront in which lane l is on column t - l at step t, the
`__shfl_up_sync` hand-over as a shift along the lane axis, the passes
over queries longer than 32 * RS rows with their boundary rows, and the
merge of column maxima down the lanes and across passes.  The tests hold
it to `xla.colmax_xla`, `xla.window_pass_xla` and the NumPy goldens.

One model call runs a batch of DP problems at once (the warps of the
grid) on an extra leading axis.
"""

from __future__ import annotations

import numpy as np

from ..config import GAP_EXTEND, GAP_OPEN
from .gpu import LANES, plan, window_rows

_NEG = -(1 << 30)
_BIG = 1 << 30


def _shfl_up(x: np.ndarray) -> np.ndarray:
    """__shfl_up_sync(v, 1) over the lane axis (last axis): lane l gets
    lane l - 1's value, lane 0 keeps its own."""
    out = x.copy()
    out[:, 1:] = x[:, :-1]
    return out


def _strip_profile(prof: np.ndarray, row0: int, rs: int, lanes: int):
    """Rows [row0, row0 + lanes * rs) of a [C, Mp] profile as
    [C, lanes, rs] (row = row0 + lane * rs + k); rows past Mp score 0,
    as stage_profile writes them."""
    C, mp = prof.shape
    rows = row0 + np.arange(lanes)[:, None] * rs + np.arange(rs)[None, :]
    return np.where(rows < mp, prof[:, np.minimum(rows, mp - 1)], 0), rows


def colmax_model(codes: np.ndarray, matq: np.ndarray, m16: int,
                 lanes: int = LANES, rs: int | None = None) -> np.ndarray:
    """colmax_kernel: codes int[P, N], matq int32[C, Mp] -> int32[P, N]
    column maxima over rows < m16.  rs overrides the strip plan (to force
    several passes at a small m)."""
    P, N = codes.shape
    C = matq.shape[0]
    if rs is None:
        rs, n_pass = plan(m16, lanes)
    else:
        n_pass = -(-m16 // (lanes * rs))
    code = np.minimum(codes.astype(np.int64), C - 1)
    lane = np.arange(lanes)
    bnd = np.zeros((P, N, 3), np.int64)  # (H, F carry, column max)
    out = np.zeros((P, N), np.int64)
    for p in range(n_pass):
        prof, rows = _strip_profile(matq.astype(np.int64), p * lanes * rs,
                                    rs, lanes)
        h = np.zeros((P, lanes, rs), np.int64)
        e = np.zeros((P, lanes, rs), np.int64)
        h_bot = np.zeros((P, lanes), np.int64)
        f_out = np.full((P, lanes), _NEG, np.int64)
        cm_out = np.zeros((P, lanes), np.int64)
        diag = np.zeros((P, lanes), np.int64)
        for step in range(N + lanes - 1):
            j = step - lane
            act = (j >= 0) & (j < N)
            jc = np.clip(j, 0, N - 1)
            h_up, f_up, cm_up = (_shfl_up(h_bot), _shfl_up(f_out),
                                 _shfl_up(cm_out))
            if act[0]:
                if p == 0:
                    h_up[:, 0], f_up[:, 0], cm_up[:, 0] = 0, _NEG, 0
                else:
                    h_up[:, 0], f_up[:, 0], cm_up[:, 0] = bnd[:, j[0]].T
            s = prof[code[:, jc], lane[None, :]]  # (P, lanes, rs)
            f = f_up
            d = diag
            cm = np.zeros((P, lanes), np.int64)
            hn_all = np.empty_like(h)
            for k in range(rs):
                hold = h[..., k]
                ek = np.maximum(e[..., k] - GAP_EXTEND, hold - GAP_OPEN)
                t = np.maximum(np.maximum(d + s[..., k], ek), 0)
                hn = np.maximum(t, f)
                f = np.maximum(f - GAP_EXTEND, t - GAP_OPEN)
                e[..., k] = np.where(act, ek, e[..., k])
                hn_all[..., k] = hn
                cm = np.where(rows[None, :, k] < m16, np.maximum(cm, hn), cm)
                d = hold
            h = np.where(act[None, :, None], hn_all, h)
            diag = np.where(act, h_up, diag)
            h_bot = h[..., rs - 1]
            f_out = np.where(act, f, f_out)
            cm_out = np.where(act, np.maximum(cm_up, cm), cm_out)
            if act[-1]:
                jl = j[-1]
                if p == n_pass - 1:
                    out[:, jl] = cm_out[:, -1]
                else:
                    bnd[:, jl] = np.stack(
                        [h_bot[:, -1], f_out[:, -1], cm_out[:, -1]], -1)
    return out.astype(np.int32)


def window_model(codes: np.ndarray, offs: np.ndarray, terms: np.ndarray,
                 rlens: np.ndarray, mreals: np.ndarray, prof: np.ndarray,
                 m: int, lanes: int = LANES,
                 rs: int | None = None) -> np.ndarray:
    """window_kernel: codes int[R, W], per-row int32[R] offs/terms/
    rlens/mreals, prof int32[C, Mp] (gpu.window_profile) -> int32[R, 3]
    (best, end_col, end_row).  Rows share one step loop here, so a row
    whose rlens is shorter than the longest simply stops updating, as its
    warp would stop."""
    R, W = codes.shape
    C = prof.shape[0]
    rows_needed = window_rows(m)
    if rs is None:
        rs, n_pass = plan(rows_needed, lanes)
    else:
        n_pass = -(-rows_needed // (lanes * rs))
    code = np.minimum(codes.astype(np.int64), C - 1)
    rl = np.clip(rlens.astype(np.int64), 0, W)
    off = offs.astype(np.int64)[:, None, None]
    mreal = mreals.astype(np.int64)[:, None, None]
    lane = np.arange(lanes)
    bnd = np.zeros((R, W, 4), np.int64)  # (H, F carry, max, its row)
    best = np.zeros(R, np.int64)
    ecol = np.full(R, -1, np.int64)
    erow = np.full(R, m - 1, np.int64)
    act_row = np.ones(R, bool)
    for p in range(n_pass):
        prof_s, rows = _strip_profile(prof.astype(np.int64), p * lanes * rs,
                                      rs, lanes)
        h = np.zeros((R, lanes, rs), np.int64)
        e = np.zeros((R, lanes, rs), np.int64)
        h_bot = np.zeros((R, lanes), np.int64)
        f_out = np.full((R, lanes), _NEG, np.int64)
        cm_out = np.zeros((R, lanes), np.int64)
        rm_out = np.full((R, lanes), _BIG, np.int64)
        diag = np.zeros((R, lanes), np.int64)
        for step in range(int(rl.max(initial=0)) + lanes - 1):
            j = step - lane  # (lanes,)
            act = (j[None, :] >= 0) & (j[None, :] < rl[:, None])  # (R, lanes)
            jc = np.clip(j, 0, W - 1)
            h_up, f_up, cm_up, rm_up = (_shfl_up(h_bot), _shfl_up(f_out),
                                        _shfl_up(cm_out), _shfl_up(rm_out))
            if p == 0:
                h_up[:, 0], f_up[:, 0], cm_up[:, 0], rm_up[:, 0] = \
                    0, _NEG, 0, _BIG
            elif 0 <= j[0] < W:
                h_up[:, 0], f_up[:, 0], cm_up[:, 0], rm_up[:, 0] = \
                    bnd[:, j[0]].T
            s_all = prof_s[code[:, jc], lane[None, :]]  # (R, lanes, rs)
            s_all = np.where(rows[None] >= off, s_all, 0)
            f = f_up
            d = diag
            cm = np.zeros((R, lanes), np.int64)
            srow = np.full((R, lanes), _BIG, np.int64)
            hn_all = np.empty_like(h)
            for k in range(rs):
                row = rows[None, :, k]
                hold = h[..., k]
                ek = np.maximum(e[..., k] - GAP_EXTEND, hold - GAP_OPEN)
                t = np.maximum(np.maximum(d + s_all[..., k], ek), 0)
                hn = np.maximum(t, f)
                f = np.maximum(f - GAP_EXTEND, t - GAP_OPEN)
                e[..., k] = np.where(act, ek, e[..., k])
                hn_all[..., k] = hn
                in_c = row < mreal[..., 0]
                rm_ok = (row >= off[..., 0]) & (row < m)
                gt = in_c & (hn > cm)
                eq = in_c & ~gt & (hn == cm) & (srow == _BIG) & rm_ok
                srow = np.where(gt, np.where(rm_ok, row, _BIG),
                                np.where(eq, row, srow))
                cm = np.where(gt, hn, cm)
                d = hold
            h = np.where(act[..., None], hn_all, h)
            diag = np.where(act, h_up, diag)
            h_bot = h[..., rs - 1]
            f_out = np.where(act, f, f_out)
            take = cm > cm_up
            new_cm = np.where(take, cm, cm_up)
            new_rm = np.where(take, srow,
                              np.where((cm == cm_up) & (rm_up == _BIG),
                                       srow, rm_up))
            cm_out = np.where(act, new_cm, cm_out)
            rm_out = np.where(act, new_rm, rm_out)
            a = act[:, -1]
            jl = j[-1]
            if p == n_pass - 1:
                c, r_ = cm_out[:, -1], rm_out[:, -1]
                upd = a & act_row & (c > best)
                best = np.where(upd, c, best)
                ecol = np.where(upd, jl, ecol)
                erow = np.where(upd, r_, erow)
                act_row &= ~(a & (c == terms))
            elif 0 <= jl < W:
                sel = np.flatnonzero(a)
                bnd[sel, jl] = np.stack([h_bot[sel, -1], f_out[sel, -1],
                                         cm_out[sel, -1], rm_out[sel, -1]],
                                        -1)
    return np.stack([best, ecol, erow], -1).astype(np.int32)

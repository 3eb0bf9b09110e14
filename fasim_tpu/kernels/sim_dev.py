"""Device (XLA) forward pass of the SIM exact engine (-F path).

Computes the full-matrix forward scan of sim.h:511-567 — per cell the
(score, start_i, start_j) triple with the ORDER tie-break (prefer the
lexicographically larger (score, start_i, start_j), sim.h:487-498) — as
a column-stepped lax.scan over the reference axis with the query on
lanes, batched over transform pairs.  The host keeps the K=50 node
list, the diff traceback and the rectangle recomputation
(native/sim_exact.cpp); it replays add_node over the device-emitted
qualifying cells (score > min_score, the reference's 10x-vs-raw
threshold quirk, sim.h:562) in scan order via native.sim_scan_replay.

Exactness notes:

  * the start point packs as t = si * (N + 2) + sj, which is monotone
    in the lex order (si, sj); the packed compare (score, t) therefore
    reproduces ORDER exactly.  Requires (M + 1) * (N + 2) < 2^31 —
    checked by the caller (host fallback otherwise).
  * the vertical-gap prefix feeds on C_pre = max_lex(diag/restart, F)
    (no D term): any D-derived source contribution is STRICTLY value-
    dominated through the extra gap-open (Q > 0), so it can never be
    the lex argmax — the prefix over C_pre yields the reference's D
    (value AND start).  The same strict domination makes take_max
    order-insensitive here (it is a total-order max).
  * row-0 boundary: the diagonal for query row 1 is (0, start (0, j-1))
    from the CC/RR/EE init (sim.h:517-523); gap-channel inits are
    <= -Q-R < 0 and can never win a cell (restart floors at 0), so
    -inf fills are equivalent.

Why the full-matrix fetch cannot be compacted: the add_node threshold
quirk makes the qualifying stream ~18% of the matrix (up to ~4M cells
per H19-sized pair, counted on the CPU), and the node list it feeds
evicts the lowest-score node UNCONDITIONALLY when full (sim.h:99-148 —
even for a lower-scoring new start) while integrating a per-node
bounding box over every same-start cell (the recompute region input,
sim.h:892-1141).  The final list is a sequential fold over the full
stream — no top-K / per-start device reduction reproduces it, so
~32 MB/pair of payload crosses to the host.  This path is therefore
opt-in (--tpu-sim-device true / FASIM_SIM_DEVICE=1); the default -F
path fans the 48 transform pairs out over host cores (scan/batched.py
_sim_pool).

Reference: /root/reference/sim.h:511-567 (forward scan).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_Q = 120  # gap open, 10x units (sim.h:470-475 with LongTarget's args)
_R = 40   # gap extend
_NEG = -(2 ** 29)

# char -> ACGT code (0-3), 4 = everything else (V rows are zero there)
_SIM_ENC = np.full(256, 4, np.int32)
for _i, _c in enumerate(b"ACGT"):
    _SIM_ENC[_c] = _i


def _lex_max(s1, t1, s2, t2):
    """Elementwise lexicographic max on (score, packed start)."""
    take2 = (s2 > s1) | ((s2 == s1) & (t2 > t1))
    return jnp.where(take2, s2, s1), jnp.where(take2, t2, t1)


@functools.partial(jax.jit, static_argnames=("mp",))
def _sim_forward(q, refs, *, mp: int):
    """q: int32[Mp] query codes (pad 9); refs: int32[T, N] ref codes
    (pad 9).  Returns (cs, ct) int32[T, N, Mp]: final cell (score,
    packed start) per (pair, ref column, query row)."""
    with jax.named_scope("sim_forward"):
        return _sim_forward_body(q, refs, mp)


def _sim_forward_body(q, refs, mp: int):
    T, N = refs.shape
    lane = jnp.arange(mp, dtype=jnp.int32)[None, :]     # (1, Mp) = i-1
    qlt4 = q[None, :] < 4
    rowbase = (lane + 1) * (N + 2)                      # start (i, 0)
    bias = lane * _R
    neg = jnp.int32(_NEG)
    # masked-lex-prefix shift masks (static)
    steps = []
    k = 1
    while k < mp:
        steps.append((k, lane >= k))
        k *= 2

    cs0 = jnp.zeros((T, mp), jnp.int32)
    ct0 = jnp.broadcast_to(rowbase, (T, mp))
    fs0 = jnp.full((T, mp), -_Q, jnp.int32)
    ft0 = jnp.broadcast_to(rowbase, (T, mp))

    def col(carry, x):
        cs, ct, fs, ft = carry
        code, j1 = x                                    # code (T,), j1 1-based
        codec = code[:, None]
        eq = codec == q[None, :]
        s = jnp.where(eq & qlt4, jnp.int32(50),
                      jnp.where(qlt4 & (codec < 4), jnp.int32(-40), 0))
        # F: horizontal gap, carried per lane
        fs2, ft2 = _lex_max(fs - _R, ft, cs - (_Q + _R), ct)
        # diagonal from the previous column's state, row-0 boundary
        diag_s = jnp.where(lane >= 1, jnp.roll(cs, 1, axis=1), 0)
        diag_t = jnp.where(lane >= 1, jnp.roll(ct, 1, axis=1), j1 - 1)
        base_s = diag_s + s
        restart = base_s <= 0
        pre_s = jnp.where(restart, 0, base_s)
        pre_t = jnp.where(restart, rowbase + j1, diag_t)
        pre_s, pre_t = _lex_max(pre_s, pre_t, fs2, ft2)
        # D: vertical gap via masked lex prefix over biased C_pre
        bs = pre_s + bias
        bt = pre_t
        for k, mask in steps:
            rs = jnp.where(mask, jnp.roll(bs, k, axis=1), neg)
            rt = jnp.where(mask, jnp.roll(bt, k, axis=1), 0)
            bs, bt = _lex_max(bs, bt, rs, rt)
        ds = jnp.where(lane >= 1, jnp.roll(bs, 1, axis=1), neg) \
            - (_Q + bias)
        dt = jnp.where(lane >= 1, jnp.roll(bt, 1, axis=1), 0)
        ncs, nct = _lex_max(pre_s, pre_t, ds, dt)
        return (ncs, nct, fs2, ft2), (ncs, nct)

    j1s = jnp.arange(1, N + 1, dtype=jnp.int32)
    _, (css, cts) = jax.lax.scan(col, (cs0, ct0, fs0, ft0),
                                 (refs.T, j1s))
    return css.transpose(1, 0, 2), cts.transpose(1, 0, 2)


def sim_forward_cells(rna: np.ndarray, refs_u8: list[np.ndarray],
                      min_scores: list[int], device=None):
    """Forward-scan one query against T transformed refs on the device;
    returns per pair the qualifying-cell stream int32[n, 5] =
    (c, ci, cj, i, j) in scan order (i-major), ready for
    native.sim_scan_replay.  Caller guarantees (M+1)*(N+2) < 2^31."""
    m = len(rna)
    n = len(refs_u8[0])
    mp = (m + 7) // 8 * 8
    q = np.full(mp, 9, np.int32)
    q[:m] = _SIM_ENC[rna]
    refs = np.stack([_SIM_ENC[r] for r in refs_u8]).astype(np.int32)
    put = jnp.asarray if device is None else \
        functools.partial(jax.device_put, device=device)
    cs, ct = _sim_forward(put(q), put(refs), mp=mp)
    cs = np.asarray(cs)[:, :, :m]  # (T, N, m)
    ct = np.asarray(ct)[:, :, :m]
    outs = []
    for t in range(len(refs_u8)):
        jj, ii = np.nonzero(cs[t] > int(min_scores[t]))
        c = cs[t][jj, ii]
        st = ct[t][jj, ii]
        ci = st // (n + 2)
        cj = st - ci * (n + 2)
        cells = np.column_stack([c, ci, cj, ii + 1, jj + 1]) \
            .astype(np.int32)
        # scan order is i-major (query rows outer, sim.h:528)
        order = np.lexsort((cells[:, 4], cells[:, 3]))
        outs.append(np.ascontiguousarray(cells[order]))
    return outs

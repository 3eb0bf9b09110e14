"""Backend-neutral helpers shared by the scan engines.

Byte-purity tables for the fused threshold pass, the byte-kernel break
post-op and the host candidate packer.  Nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

from ..config import BYTE_SAT

# Bytes for which the threshold and scan engines provably agree, making
# the fused single-pass threshold valid.  All 48 rule codes substitute
# uppercase A/T/G/C into {A,T,G,C} (rules.h:6-53 — no rule maps a real
# base to N), so for such segments every (query char, transformed char)
# score is identical in the two matrices (match 5 / mismatch -4), the two
# DPs are the same DP, and the threshold pass can be read off the scan
# pass's int32 column maxima ("fused" mode) instead of running a second
# full pass.  Any other segment byte disables fusion for the batch:
# lowercase/unknown bytes become 'N' under transferString (rules.h:
# 308-311) and N scores -4 (scan) vs -1 (threshold); the batch pad byte 0
# also becomes 'N' but pads provably never raise a maximum in either
# engine, so it is allowed.  On the *query* side no rule LUT applies —
# both encoders map lowercase like uppercase — so acgt is pure there,
# while U (U~T in the threshold engine vs U~A in SSW) and N are not
# (SURVEY.md "Threshold/scan engine mismatch").
PURE = np.zeros(256, np.bool_)  # query bytes
for _b in b"ACGTacgt":
    PURE[_b] = True
PURE_OR_PAD = np.zeros(256, np.bool_)  # segment bytes
for _b in b"ACGT":
    PURE_OR_PAD[_b] = True
PURE_OR_PAD[0] = True  # batch pad byte


def apply_byte_break(colmax: np.ndarray) -> np.ndarray:
    """Post-op equivalent of the byte kernel's break-at-saturation
    (sswNew.cpp:384-386): zero the first column whose max reaches 251 and
    everything after it.  Works on [..., N]."""
    sat = colmax >= BYTE_SAT
    # first saturated column per row (N if none)
    first = np.where(sat.any(axis=-1), sat.argmax(axis=-1), colmax.shape[-1])
    pos = np.arange(colmax.shape[-1])
    return np.where(pos < first[..., None], colmax, 0).astype(np.int32)


def pack_candidates_np(thresh: np.ndarray, cm_u8: np.ndarray,
                       lengths: np.ndarray, k: int):
    """Compact each (segment, transform) colmax row to its first k
    above-threshold columns: byte-break, min_score = trunc(0.8 * thresh)
    computed exactly as 4t//5, then (position, value) pairs in column
    order plus the full count (count > k flags an overflow row that the
    candidate stage re-reads in full).  Returns (pos int16[S, T, k],
    val uint8[S, T, k], cnt int32[S, T])."""
    S, T, N = cm_u8.shape
    pos = np.zeros((S, T, k), np.int16)
    val = np.zeros((S, T, k), np.uint8)
    cnt = np.zeros((S, T), np.int32)
    for s in range(S):
        for t in range(T):
            row = cm_u8[s, t].astype(np.int32)
            satj = np.flatnonzero(row >= BYTE_SAT)
            stop = int(satj[0]) if len(satj) else N
            stop = min(stop, int(lengths[s]))
            ms = 4 * int(thresh[s, t]) // 5
            cand = np.flatnonzero(row[:stop] > ms)
            cnt[s, t] = len(cand)
            take = cand[:k]
            pos[s, t, :len(take)] = take
            val[s, t, :len(take)] = row[take]
    return pos, val, cnt

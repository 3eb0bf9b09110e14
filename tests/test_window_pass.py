"""Device window-pass vs the oracle-verified golden striped-pass model.

The golden model is kernels.align._sw_end_pass (differential-tested
against the instrumented reference in tests/test_kernels_ref.py); the
device pass must reproduce (best, end_col, end_row) for both the forward
(no terminate) and reverse (terminate + lanes-dependent phantom rows)
configurations, and the full align chain built on the device pass must
reproduce align_window_py bit-for-bit.
"""

import numpy as np
import pytest

from fasim_tpu import rules
from fasim_tpu.config import BYTE_SAT, GAP_EXTEND, GAP_OPEN
from fasim_tpu.kernels import align as kalign
from fasim_tpu.kernels.xla import XlaScanEngine, _window_qp, window_pass_xla


def _rand_codes(rng, n):
    return rng.integers(0, 5, n).astype(np.int32)  # SSW alphabet incl. N


def _ru(x, m):
    return (x + m - 1) // m * m


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def test_forward_pass_lane_independent(rng):
    """Forward outputs are identical for byte (16) and word (8) phantom
    layouts — the argument that lets the device pass skip escalation."""
    for m, w in [(37, 50), (64, 33), (201, 197)]:
        q = _rand_codes(rng, m)
        ref = _rand_codes(rng, w)
        b16 = kalign._sw_end_pass(q, ref, GAP_OPEN, GAP_EXTEND,
                                  rules.SSW_MAT, 16, False, None)
        b8 = kalign._sw_end_pass(q, ref, GAP_OPEN, GAP_EXTEND,
                                 rules.SSW_MAT, 8, False, None)
        assert b16 == b8


def test_window_pass_forward(rng):
    m = 173
    rna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)]
    eng = XlaScanEngine(rna)
    eng.setup_windows(rna)
    R, W = 24, 64
    codes = np.empty((R, W), np.uint8)
    rlens = rng.integers(5, W + 1, R).astype(np.int32)
    for r in range(R):
        codes[r] = 4
        codes[r, :rlens[r]] = _rand_codes(rng, rlens[r])
    offs = np.zeros(R, np.int32)
    terms = np.full(R, -1, np.int32)
    mreals = np.full(R, _ru(m, 16), np.int32)
    out = np.asarray(eng.window_pass(codes, offs, terms, rlens, mreals,
                                     rev=False))
    q_idx = rules.SSW_ENC[rna]
    for r in range(R):
        best, ecol, erow, _ = kalign._sw_end_pass(
            q_idx, codes[r, :rlens[r]].astype(np.int64), GAP_OPEN,
            GAP_EXTEND, rules.SSW_MAT, 16, False, None)
        assert (int(out[r, 0]), int(out[r, 1])) == (best, ecol), r
        if best > 0:
            assert int(out[r, 2]) == erow, r


def test_window_pass_reverse_terminate(rng):
    """Reverse pass: offset rows, terminate break, per-row phantom bound."""
    m = 97
    rna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)]
    eng = XlaScanEngine(rna)
    eng.setup_windows(rna)
    q_idx = rules.SSW_ENC[rna]
    cases = []
    for _ in range(24):
        w = int(rng.integers(8, 80))
        ref = _rand_codes(rng, w)
        # forward align to get a realistic (end_read, end_ref, best)
        best, ecol, erow, _ = kalign._sw_end_pass(
            q_idx, ref, GAP_OPEN, GAP_EXTEND, rules.SSW_MAT, 16, False,
            None)
        if best == 0:
            continue
        cases.append((ref, best, ecol, erow))
    assert cases
    R = len(cases)
    W = 80
    codes = np.full((R, W), 4, np.uint8)
    offs = np.empty(R, np.int32)
    terms = np.empty(R, np.int32)
    rlens = np.empty(R, np.int32)
    mreals = np.empty(R, np.int32)
    for lanes in (16, 8):
        for r, (ref, best, ecol, erow) in enumerate(cases):
            rev_ref = ref[ecol::-1]
            rlens[r] = len(rev_ref)
            codes[r, :len(rev_ref)] = rev_ref
            offs[r] = m - 1 - erow
            terms[r] = best
            mr = erow + 1  # reverse-query length
            mreals[r] = m + (-mr) % lanes
        out = np.asarray(eng.window_pass(codes, offs, terms, rlens, mreals,
                                         rev=True))
        for r, (ref, best, ecol, erow) in enumerate(cases):
            rev_q = q_idx[erow::-1]
            rb, rc, rr, _ = kalign._sw_end_pass(
                rev_q, ref[ecol::-1].astype(np.int64), GAP_OPEN, GAP_EXTEND,
                rules.SSW_MAT, lanes, False, best)
            assert int(out[r, 0]) == rb, (lanes, r)
            assert int(out[r, 1]) == rc, (lanes, r)
            assert int(out[r, 2]) - int(offs[r]) == rr, (lanes, r)


def test_window_pass_specs_parity(rng):
    """Production specs interface == the direct codes interface on a
    realistic mixed fwd/rev spec batch, and == the golden striped pass
    row by row (window codes built from the segment batch + LUTs)."""
    from fasim_tpu.kernels.xla import build_window_codes

    m = 131
    rna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, m)]
    scans = rules.scan_list(0, 0)
    xla = XlaScanEngine(rna)
    xla.setup_scans(scans)
    xla.setup_windows(rna)
    S, N = 4, 640
    segs = np.zeros((S, N), np.uint8)
    lens = np.array([640, 503, 640, 77], np.int32)
    for i in range(S):
        segs[i, :lens[i]] = np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, lens[i])]
    R = 37
    spec = {
        "seg_idx": rng.integers(0, S, R).astype(np.int32),
        "scan_idx": rng.integers(0, len(scans), R).astype(np.int32),
        "dirn": np.where(rng.random(R) < 0.5, 1, -1).astype(np.int32),
        "rlens": rng.integers(4, 120, R).astype(np.int32),
        "offs": np.zeros(R, np.int32),
        "terms": np.full(R, -1, np.int32),
        "mreals": np.full(R, _ru(m, 16), np.int32),
    }
    # keep window reads inside the segment
    base = np.empty(R, np.int32)
    for r in range(R):
        n = lens[spec["seg_idx"][r]]
        w = min(int(spec["rlens"][r]), int(n))
        spec["rlens"][r] = w
        if spec["dirn"][r] == 1:
            base[r] = rng.integers(0, n - w + 1)
        else:
            base[r] = rng.integers(w - 1, n)
    spec["base"] = base
    lut_s, _, is_tr = xla._scan_luts
    codes = build_window_codes(segs, lens, lut_s, is_tr, spec)
    q_idx = rules.SSW_ENC[rna]
    a = np.asarray(xla.window_pass_specs(segs, lens, spec, rev=False))
    c = np.asarray(xla.window_pass(codes, spec["offs"], spec["terms"],
                                   spec["rlens"], spec["mreals"], rev=False))
    np.testing.assert_array_equal(a, c)
    for r in range(R):
        best, ecol, erow, _ = kalign._sw_end_pass(
            q_idx, codes[r, :spec["rlens"][r]].astype(np.int64), GAP_OPEN,
            GAP_EXTEND, rules.SSW_MAT, 16, False, None)
        assert (int(a[r, 0]), int(a[r, 1])) == (best, ecol), r
        if best > 0:
            assert int(a[r, 2]) == erow, r


def test_pack_candidates_parity(rng):
    """Host candidate packing: packed peaks == full-colmax peaks (native),
    with byte-saturated and overflowing rows, and the counts/positions
    follow the threshold and byte-break rules."""
    from fasim_tpu import native
    from fasim_tpu.kernels.common import pack_candidates_np

    S, T, N, K = 3, 6, 512, 16
    cm = rng.integers(0, 120, (S, T, N)).astype(np.uint8)
    cm[0, 0, 100:120] = 252  # byte-saturated run
    cm[1, 2, :] = 90  # overflow row (cnt >> K)
    thresh = rng.integers(50, 140, (S, T)).astype(np.int32)
    lengths = np.array([512, 400, 333], np.int32)
    hp, hv, hc = pack_candidates_np(thresh, cm, lengths, K)
    # byte break: nothing at or after the first saturated column
    assert (hp[0, 0][:min(hc[0, 0], K)] < 100).all()
    assert hc[1, 2] > K
    for s in range(S):
        for t in range(T):
            ms = 4 * int(thresh[s, t]) // 5
            k = min(int(hc[s, t]), K)
            assert (hv[s, t, :k].astype(np.int32) > ms).all()
            np.testing.assert_array_equal(hv[s, t, :k],
                                          cm[s, t, hp[s, t, :k]])
    for s in range(S):
        full = native.segment_peaks(cm[s], N, thresh[s], int(lengths[s]))
        if (hc[s] > K).any():
            continue  # overflow rows go through the full path in prod
        packed = native.segment_peaks_packed(hp[s], hv[s], hc[s])
        np.testing.assert_array_equal(full, packed)


def test_align_chain_matches_align_window_py(rng):
    """Full chain (device fwd + device rev + host banded) == golden."""
    from fasim_tpu.scan.candidates import align_via_window_pass

    m = 151
    rna = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, m)]
    eng = XlaScanEngine(rna)
    eng.setup_windows(rna)
    q_idx = rules.SSW_ENC[rna]
    n_checked = 0
    for _ in range(40):
        w = int(rng.integers(10, 120))
        # mix random and planted-homology windows
        if rng.random() < 0.5:
            ref = _rand_codes(rng, w)
        else:
            lo = int(rng.integers(0, m - 5))
            piece = q_idx[lo:lo + min(w, m - lo)].copy()
            muts = rng.random(len(piece)) < 0.15
            piece[muts] = rng.integers(0, 5, muts.sum())
            ref = np.concatenate([piece, _rand_codes(rng, w)])[:w]
        golden = kalign.align_window_py(q_idx, ref, rules.SSW_MAT)
        got = align_via_window_pass(eng, q_idx, ref.astype(np.uint8),
                                    rules.SSW_MAT)
        assert got.sw_score == golden.sw_score
        if golden.sw_score:
            assert (got.ref_begin, got.ref_end, got.query_begin,
                    got.query_end) == (golden.ref_begin, golden.ref_end,
                                       golden.query_begin, golden.query_end)
            assert got.cigar == golden.cigar
            n_checked += 1
    assert n_checked >= 10

"""Device engine vs NumPy golden engine.

The engine runs its plain XLA passes on the CPU backend here; on a GPU
the same engine runs the CUDA kernels, whose decomposition is tested in
test_gpu_kernels.py and whose exact parity at real widths is checked on
the card by chip_smoke.py.
"""

import numpy as np
import pytest

from fasim_tpu import rules
from fasim_tpu.kernels.batch_np import numpy_engine
from fasim_tpu.kernels.common import PURE_OR_PAD, apply_byte_break
from fasim_tpu.kernels.xla import XlaScanEngine

BASES = np.frombuffer(b"ACGT", np.uint8)


def _random_seq(rng, n):
    return BASES[rng.integers(0, 4, n)]


@pytest.mark.parametrize("m,n", [(130, 256), (97, 300)])
def test_xla_engine_matches_numpy(m, n):
    rng = np.random.default_rng(7)
    rna = _random_seq(rng, m)
    seg = _random_seq(rng, n)
    scans = rules.scan_list(0, 0)[:8]
    s2l = [rules.make_scan_strings(seg, s)[0] for s in scans]
    thresh_np, colmax_np = numpy_engine(rna, s2l)
    eng = XlaScanEngine(rna)
    thresh_t, colmax_t = eng(rna, s2l)
    np.testing.assert_array_equal(thresh_np, thresh_t)
    np.testing.assert_array_equal(colmax_np, colmax_t)


def test_xla_engine_byte_break_regime():
    """Long poly-purine run drives scores past 251: the break column and
    zeroed tail must match the reference byte-kernel semantics."""
    rng = np.random.default_rng(3)
    rna = np.frombuffer(b"GA" * 100, np.uint8).copy()
    seg = np.concatenate([_random_seq(rng, 50),
                          np.frombuffer(b"GA" * 120, np.uint8),
                          _random_seq(rng, 60)])
    scans = [s for s in rules.scan_list(0, 0) if s["para"] == -1][:4]
    s2l = [rules.make_scan_strings(seg, s)[0] for s in scans]
    thresh_np, colmax_np = numpy_engine(rna, s2l)
    eng = XlaScanEngine(rna)
    thresh_t, colmax_t = eng(rna, s2l)
    np.testing.assert_array_equal(thresh_np, thresh_t)
    np.testing.assert_array_equal(colmax_np, colmax_t)


def test_xla_engine_ragged_padding():
    """Padded (shorter) segments inside a batch must not perturb results."""
    rng = np.random.default_rng(11)
    rna = _random_seq(rng, 64)
    segs = [_random_seq(rng, 200), _random_seq(rng, 140)]
    scans = rules.scan_list(0, 0)[:4]
    eng = XlaScanEngine(rna)
    # batch the two segments with right-padding using the pad code
    n = 200
    batch = []
    for seg in segs:
        s2l = [rules.make_scan_strings(seg, s)[0] for s in scans]
        codes = rules.SSW_ENC[np.stack(s2l)].astype(np.int32)
        pad = np.full((len(scans), n - codes.shape[1]),
                      rules.SSW_MAT.shape[0], np.int32)
        batch.append(np.concatenate([codes, pad], axis=1))
    out = eng.colmax_batch(np.stack(batch), "ssw")
    for k, seg in enumerate(segs):
        s2l = [rules.make_scan_strings(seg, s)[0] for s in scans]
        _, colmax_np = numpy_engine(rna, s2l)
        # numpy engine applies the byte break; compare post-op outputs
        got = apply_byte_break(out[k][:, :len(seg)])
        np.testing.assert_array_equal(colmax_np, got)


def _scan_segments_reference(eng, segs, lengths):
    """XlaScanEngine.scan_segments with fusion forced off (runs the real
    threshold-alphabet pass) — the semantics fused mode must reproduce."""
    pure = eng.query_pure
    try:
        eng.query_pure = False
        return eng.scan_segments(segs, lengths)
    finally:
        eng.query_pure = pure


def _seg_batch(segs, n):
    batch = np.zeros((len(segs), n), np.uint8)
    lengths = np.zeros(len(segs), np.int32)
    for i, s in enumerate(segs):
        batch[i, :len(s)] = s
        lengths[i] = len(s)
    return batch, lengths


def test_fused_threshold_matches_two_pass():
    """Pure-ACGT input: the fused single-pass threshold must equal the
    dedicated threshold-alphabet pass exactly (incl. a segment long/hot
    enough to cross BYTE_SAT in some transform)."""
    rng = np.random.default_rng(5)
    rna = np.frombuffer(b"GA" * 80, np.uint8).copy()
    segs = [np.concatenate([_random_seq(rng, 100),
                            np.frombuffer(b"GA" * 90, np.uint8),
                            _random_seq(rng, 80)]),
            _random_seq(rng, 256)]
    eng = XlaScanEngine(rna)
    eng.setup_scans(rules.scan_list(0, 0))
    assert eng.query_pure
    batch, lengths = _seg_batch(segs, 384)
    thresh_f, cm_f = eng.scan_segments(batch, lengths)
    thresh_2, cm_2 = _scan_segments_reference(eng, batch, lengths)
    np.testing.assert_array_equal(thresh_f, thresh_2)
    np.testing.assert_array_equal(cm_f, cm_2)


def test_fused_disabled_on_impure_input():
    """'N' in a segment (or U in the query) must fall back to the real
    threshold pass — the engines score those bytes differently."""
    rng = np.random.default_rng(9)
    rna = _random_seq(rng, 60)
    seg = _random_seq(rng, 200)
    seg[50:60] = ord("N")
    eng = XlaScanEngine(rna)
    eng.setup_scans(rules.scan_list(0, 0)[:6])
    batch, lengths = _seg_batch([seg], 256)
    thresh, cm = eng.scan_segments(batch, lengths)
    thresh_2, cm_2 = _scan_segments_reference(eng, batch, lengths)
    np.testing.assert_array_equal(thresh, thresh_2)
    np.testing.assert_array_equal(cm, cm_2)
    # U-query: engines disagree (U~T vs U~A) so fusion must be off
    rna_u = rna.copy()
    rna_u[0] = ord("U")
    eng_u = XlaScanEngine(rna_u)
    assert not eng_u.query_pure
    # lowercase segment bytes become 'N' under the rule LUTs and the
    # engines score N differently (-4 vs -1): must also fall back
    seg_lc = seg.copy()
    seg_lc[50:60] = ord("a")
    batch_lc, lengths_lc = _seg_batch([seg_lc], 256)
    thresh_lc, cm_lc = eng.scan_segments(batch_lc, lengths_lc)
    thresh_lc2, cm_lc2 = _scan_segments_reference(eng, batch_lc, lengths_lc)
    np.testing.assert_array_equal(thresh_lc, thresh_lc2)
    np.testing.assert_array_equal(cm_lc, cm_lc2)
    assert not PURE_OR_PAD[seg_lc].all()


def test_apply_byte_break():
    cm = np.array([[1, 5, 251, 7, 300], [1, 2, 3, 4, 5]])
    out = apply_byte_break(cm)
    np.testing.assert_array_equal(out, [[1, 5, 0, 0, 0], [1, 2, 3, 4, 5]])

"""CUDA kernels of the scan and window passes, tested where CUDA cannot run.

The kernels (kernels/sw_dp.cu) have no interpret mode.  Their arithmetic
is held to the plain reference through the NumPy model of their
decomposition (kernels/gpu_model.py: lane strips, wavefront steps, warp
passes, boundary rows, merged column maxima), and the Python around them
(strip plan, padding, row buckets, choice of kernel) runs here as it
runs on the card.  The exact comparison of the kernels themselves with
the reference at real widths needs the card: the `gpu`-marked tests
below skip here, and chip_smoke.py runs the same checks on the GPU.
"""

import types

import numpy as np
import pytest

from fasim_tpu import rules
from fasim_tpu.config import GAP_EXTEND, GAP_OPEN
from fasim_tpu.kernels import align as kalign
from fasim_tpu.kernels import gpu, gpu_model
from fasim_tpu.kernels.batch_np import _batched_colmax_and_max
from fasim_tpu.kernels.xla import XlaScanEngine, colmax_xla, window_pass_xla

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _ru(x, m):
    return (x + m - 1) // m * m


def _colmax_case(case):
    """(rna, codes int32[S, T, N], rs) of one decomposition regime."""
    rng = np.random.default_rng(len(case))
    if case == "byte_break":
        # a long planted match drives scores past 251 (byte-break regime)
        rna = np.frombuffer(b"GA" * 100, np.uint8).copy()
        segs = [np.concatenate([ACGT[rng.integers(0, 4, 40)],
                                np.frombuffer(b"GA" * k, np.uint8),
                                ACGT[rng.integers(0, 4, 250 - 2 * k)]])
                for k in (110, 30, 60)]
        return rna, rules.SSW_ENC[np.stack(segs)].astype(np.int32)[None], None
    m, n, rs = {"single_pass": (120, 96, None),
                "ragged": (77, 53, None),
                "multi_pass": (300, 70, 4)}[case]
    rna = ACGT[rng.integers(0, 4, m)]
    codes = rng.integers(0, 5, (2, 3, n)).astype(np.int32)  # both alphabets
    codes[0, 0, 10:40] = rules.SSW_ENC[rna[20:50]]  # planted homology
    return rna, codes, rs


@pytest.mark.parametrize("case", ["single_pass", "ragged", "multi_pass",
                                  "byte_break"])
def test_colmax_model_matches_reference(case):
    """Model == colmax_xla in both alphabets, == the NumPy golden DP."""
    rna, codes, rs = _colmax_case(case)
    eng = XlaScanEngine(rna)
    S, T, N = codes.shape
    if rs is not None:
        assert -(-eng.m16 // (gpu.LANES * rs)) >= 2  # really multi-pass
    for mat, matq in ((rules.SSW_MAT, eng.matq_ssw),
                      (rules.THRESH_MAT, eng.matq_thresh)):
        want = np.asarray(colmax_xla(codes, matq, m16=eng.m16))
        got = gpu_model.colmax_model(codes.reshape(S * T, N),
                                     np.asarray(matq), eng.m16, rs=rs)
        np.testing.assert_array_equal(got.reshape(S, T, N), want)
        enc = rules.SSW_ENC if mat is rules.SSW_MAT else rules.THRESH_ENC
        _, golden = _batched_colmax_and_max(enc[rna], codes[0], mat, 16,
                                            False)
        np.testing.assert_array_equal(got[:T], golden)
    if case == "byte_break":
        assert got.max() >= 251


def _window_batch(rng, m, R, W, rev):
    """Window pass inputs in the shape the candidate stage sends: forward
    rows (offset 0, no terminate) or reverse rows (reversed query prefix
    offset, terminate at the forward best, per-row phantom bound)."""
    codes = np.full((R, W), 4, np.uint8)
    rlens = rng.integers(0, W + 1, R).astype(np.int32)
    for r in range(R):
        codes[r, :rlens[r]] = rng.integers(0, 5, rlens[r])
    if not rev:
        return (codes, np.zeros(R, np.int32), np.full(R, -1, np.int32),
                rlens, np.full(R, _ru(m, 16), np.int32))
    offs = rng.integers(0, m, R).astype(np.int32)
    terms = np.where(rng.random(R) < 0.3, -1,
                     rng.integers(5, 40, R)).astype(np.int32)
    lanes = np.where(rng.random(R) < 0.5, 16, 8)
    mreals = (m + (-(m - offs)) % lanes).astype(np.int32)
    return codes, offs, terms, rlens, mreals


@pytest.mark.parametrize("rev", [False, True])
def test_window_model_matches_reference(rev):
    """Model == window_pass_xla (offs/terms/mreals), single and multi-pass
    strips, and == the golden striped pass on forward rows."""
    rng = np.random.default_rng(3 + rev)
    m = 150
    rna = ACGT[rng.integers(0, 4, m)]
    eng = XlaScanEngine(rna)
    eng.setup_windows(rna)
    args = _window_batch(rng, m, 17, 72, rev)
    want = np.asarray(window_pass_xla(*args, eng.qwin[rev], m=m))
    prof = gpu.window_profile(eng.qwin[rev])
    for rs in (None, 4):  # the real plan (one pass) and three passes
        got = gpu_model.window_model(*args, prof, m, rs=rs)
        np.testing.assert_array_equal(got, want)
    if not rev:
        q_idx = rules.SSW_ENC[rna]
        codes, rlens = args[0], args[3]
        for r in range(len(codes)):
            best, ecol, erow, _ = kalign._sw_end_pass(
                q_idx, codes[r, :rlens[r]].astype(np.int64), GAP_OPEN,
                GAP_EXTEND, rules.SSW_MAT, 16, False, None)
            assert (got[r, 0], got[r, 1]) == (best, ecol)
            if best > 0:
                assert got[r, 2] == erow


def test_strip_plan_covers_rows():
    """Every query length gets strips of 4..32 rows (a multiple of 4)
    in the fewest warp passes that cover it."""
    for rows in list(range(1, 2100, 7)) + [1584, 22768, 22782]:
        rs, n_pass = gpu.plan(rows)
        assert 4 <= rs <= gpu.MAX_STRIP and rs % 4 == 0
        assert rs * gpu.LANES * n_pass >= rows
        assert n_pass == -(-rows // (gpu.LANES * gpu.MAX_STRIP))
    assert gpu.plan(1584) == (28, 2)  # MEG3: two passes of 896 rows


def test_padding_never_changes_results():
    """Rows padded up to the strip multiple and columns padded with the
    pad code (scoring 0) leave every real column maximum unchanged."""
    rng = np.random.default_rng(5)
    rna = ACGT[rng.integers(0, 4, 90)]
    eng = XlaScanEngine(rna)
    matq = np.asarray(eng.matq_ssw)
    codes = rng.integers(0, 5, (4, 61)).astype(np.int32)
    base = gpu_model.colmax_model(codes, matq, eng.m16)
    pad_code = matq.shape[0] - 1
    wide = np.concatenate([codes, np.full((4, 67), pad_code, np.int32)], 1)
    padded_rows = np.pad(matq, ((0, 0), (0, 64)))  # zero-profile rows
    for rs in (4, 8, 12):
        got = gpu_model.colmax_model(wide, padded_rows, eng.m16, rs=rs)
        np.testing.assert_array_equal(got[:, :61], base)


def test_kernel_choice_by_platform():
    """XLA passes on the CPU, the CUDA FFI targets on a GPU."""
    import jax

    cpu = jax.devices("cpu")[0]
    assert not gpu.use_kernels(cpu)
    assert gpu.use_kernels(types.SimpleNamespace(platform="gpu"))
    rna = ACGT[:40]
    eng = XlaScanEngine(rna, device=cpu)
    assert (eng.scan_impl, eng.window_impl) == ("xla", "xla")


def test_window_rows_bucketed_without_changing_results():
    """The engine pads window rows to a power-of-two bucket (few compiled
    shapes); the padded rows are inert and sliced off."""
    rng = np.random.default_rng(9)
    m = 64
    rna = ACGT[rng.integers(0, 4, m)]
    eng = XlaScanEngine(rna)
    eng.setup_windows(rna)
    for R in (1, 21, 64, 65):
        args = _window_batch(rng, m, R, 40, True)
        got = eng.window_pass(*args, rev=True)
        assert got.shape == (R, 3)
        want = window_pass_xla(*args, eng.qwin[True], m=m)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
def test_colmax_kernel_exact_on_gpu(gpu_device):
    import chip_smoke

    chip_smoke.check_colmax(gpu_device, "MEG3.fa", n_segs=4)


@pytest.mark.gpu
def test_window_kernel_exact_on_gpu(gpu_device):
    import chip_smoke

    chip_smoke.check_window(gpu_device, "MEG3.fa", n_rows=256)

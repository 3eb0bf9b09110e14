// Native candidate-window aligner: exact emulation of the reference's
// ssw_align (sswNew.cpp:1446-1547) used by fastSIM on each candidate peak.
//
// Semantics (mirrors kernels/align.py, which is oracle-verified):
//   * forward pass  -> (score, ref_end, query_end): int32 affine-gap SW
//     with the striped byte kernel's phantom-row padding (query rounded up
//     to a multiple of 16 rows whose profile is all zero, sswNew.cpp:195);
//     escalates to the 8-lane word shape when the running max reaches 251;
//   * ref_end is the column of the last strict improvement; query_end is
//     the smallest query row attaining the max in that column;
//   * reverse pass on the reversed prefix rectangle stops at the first
//     column whose max equals the forward score (`terminate`), and the
//     final score is min(forward, reverse) (fork quirk, sswNew.cpp:1518);
//   * banded_sw (sswNew.cpp:1071-1259) recomputes the sub-rectangle in a
//     band doubled until max >= score, with diagonal-preferred/F-over-E
//     tie-breaking, the trailing 1M emission, and traceback-error -> score 0
//     (ssw_cpp.cpp:627-633).
//
// This stage runs on host per candidate (<=50 per segment x transform);
// the heavy whole-segment passes run on the device (kernels/xla.py).
//
// Build: g++ -O2 -fPIC -shared ssw_align.cpp -o _ssw_align.so

#include "align_core.h"

extern "C" {

// Align query vs ref window.  out_meta = [sw_score, ref_begin, ref_end,
// query_begin, query_end].  Returns cigar op count (>= 0), 0-with-score-0
// for no/failed alignment, or -2 if cig_cap is too small.
long lt_ssw_align(const int32_t* query_idx, long M, const int32_t* ref_idx,
                  long N, const int32_t* mat, long mat_dim, long go, long ge,
                  int32_t* out_meta, int32_t* cig_len, char* cig_op,
                  long cig_cap) {
    return fasim::ssw_align_core(query_idx, M, ref_idx, N, mat, mat_dim, go,
                                 ge, out_meta, cig_len, cig_op, cig_cap);
}

}  // extern "C"

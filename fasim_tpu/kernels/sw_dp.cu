// Hopper kernels for the two hot Smith-Waterman passes, called from JAX
// through its foreign function interface (kernels/gpu.py builds and
// registers them).
//
// Both passes run the same exact int32 affine-gap DP (gap open 16,
// extend 4) as kernels/xla.py:
//
//   E[i] = max(E[i] - 4, Hprev[i] - 16)            (same row, last column)
//   t[i] = max(Hprev[i-1] + s(code, i), E[i], 0)
//   H[i] = max(t[i], F[i])
//   F[i+1] = max(F[i] - 4, t[i] - 16)              (vertical gap carry)
//
// The XLA version resolves F with a prefix max over the whole query per
// column; here F is a running max down the query instead, so no prefix
// scan exists and no DP state leaves registers.
//
// Decomposition (mirrored step for step by kernels/gpu_model.py, which
// the CPU tests check against the plain reference):
//
//   * one warp per DP problem: a (segment, transform) pair for the scan
//     pass, a candidate window for the window pass;
//   * lane l owns a strip of RS consecutive query rows; its H and E live
//     in registers for the whole pass;
//   * DNA columns stream through the warp as a wavefront: at step t lane
//     l works on column t - l, and receives from lane l - 1 (via
//     __shfl_up_sync) the H of the row above its strip, the F carry
//     entering its strip and the partial column maximum over the rows
//     above it;
//   * a query longer than 32 * RS rows runs in several passes; the last
//     lane of pass p writes (H, F carry, partial max) of its bottom row
//     per column into a boundary buffer that lane 0 of pass p + 1 reads;
//   * lane 31 of the last pass owns the finished column maximum.
//
// The query profile is staged per pass in shared memory, interleaved as
// [code][k][lane] so that the 32 lanes of a warp read 32 consecutive
// words whatever codes they are on.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;  // DP problems per block
constexpr int kGapOpen = 16;
constexpr int kGapExtend = 4;
constexpr int kNeg = -(1 << 30);
constexpr int kBig = 1 << 30;  // "no row" marker of the window pass
constexpr unsigned kFull = 0xffffffffu;

// Stage rows [row0, row0 + 32 * RS) of a [n_codes, mp] profile into
// shared memory as prof[c][k][lane] (row = row0 + lane * RS + k).
template <int RS>
__device__ void stage_profile(int* prof, const int* __restrict__ src,
                              int n_codes, int mp, int row0) {
  for (int i = threadIdx.x; i < n_codes * RS * kLanes; i += blockDim.x) {
    const int c = i / (RS * kLanes);
    const int r = i - c * RS * kLanes;
    const int k = r / kLanes;
    const int l = r - k * kLanes;
    const int row = row0 + l * RS + k;
    prof[i] = row < mp ? src[(size_t)c * mp + row] : 0;
  }
}

// One column of the DP over a lane's strip.  diag: H of the row above
// the strip in the previous column; f: F carry entering the strip (left
// holding the carry out of it).  Returns the strip's column maximum over
// rows < row_hi (0 when none).
template <int RS>
__device__ __forceinline__ int colmax_strip(int (&h)[RS], int (&e)[RS],
                                            const int* pl, int diag, int& f,
                                            int row0, int row_hi) {
  int cm = 0;
#pragma unroll
  for (int k = 0; k < RS; ++k) {
    const int hold = h[k];
    const int ek = __viaddmax_s32(hold, -kGapOpen, e[k] - kGapExtend);
    const int t = __viaddmax_s32_relu(diag, pl[k * kLanes], ek);
    const int hn = max(t, f);
    f = __viaddmax_s32(f, -kGapExtend, t - kGapOpen);
    e[k] = ek;
    h[k] = hn;
    diag = hold;
    if (row0 + k < row_hi) cm = max(cm, hn);
  }
  return cm;
}

// Window-pass variant: rows below `off` score 0, the column maximum runs
// over rows < mreal, and srow tracks the lowest row in [off, m) holding
// that maximum (kBig when none).
template <int RS>
__device__ __forceinline__ int window_strip(int (&h)[RS], int (&e)[RS],
                                            const int* pl, int diag, int& f,
                                            int row0, int off, int mreal,
                                            int m, int& srow) {
  int cm = 0;
  srow = kBig;
#pragma unroll
  for (int k = 0; k < RS; ++k) {
    const int row = row0 + k;
    const int hold = h[k];
    const int s = row >= off ? pl[k * kLanes] : 0;
    const int ek = __viaddmax_s32(hold, -kGapOpen, e[k] - kGapExtend);
    const int t = __viaddmax_s32_relu(diag, s, ek);
    const int hn = max(t, f);
    f = __viaddmax_s32(f, -kGapExtend, t - kGapOpen);
    e[k] = ek;
    h[k] = hn;
    diag = hold;
    if (row < mreal) {
      const bool rm_ok = row >= off && row < m;
      if (hn > cm) {
        cm = hn;
        srow = rm_ok ? row : kBig;
      } else if (hn == cm && srow == kBig && rm_ok) {
        srow = row;
      }
    }
  }
  return cm;
}

// Scan pass: exact int32 column maxima over query rows < m16 of every
// (segment, transform) pair.  codes uint8[P, N]; matq int32[C, Mp];
// out int32[P, N]; bnd int4[P, N] boundary rows between passes.
template <int RS>
__global__ void __launch_bounds__(kLanes* kWarps)
    colmax_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ matq, int* __restrict__ out,
                  int4* __restrict__ bnd, int n_pairs, int n, int n_codes,
                  int mp, int m16, int n_pass) {
  extern __shared__ int prof[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int pair = blockIdx.x * kWarps + (threadIdx.x / kLanes);
  const bool live = pair < n_pairs;
  const uint8_t* cp = codes + (size_t)pair * n;
  int* op = out + (size_t)pair * n;
  int4* bp = bnd + (size_t)pair * n;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * kLanes * RS;
    __syncthreads();  // previous pass done with prof; bnd writes visible
    stage_profile<RS>(prof, matq, n_codes, mp, row0);
    __syncthreads();
    if (!live) continue;
    const int my_row0 = row0 + lane * RS;
    const bool last = pass == n_pass - 1;
    int h[RS], e[RS];
#pragma unroll
    for (int k = 0; k < RS; ++k) h[k] = e[k] = 0;
    int h_bot = 0, f_out = kNeg, cm_out = 0, diag = 0;
    for (int step = 0; step < n + kLanes - 1; ++step) {
      const int j = step - lane;
      int h_up = __shfl_up_sync(kFull, h_bot, 1);
      int f_up = __shfl_up_sync(kFull, f_out, 1);
      int cm_up = __shfl_up_sync(kFull, cm_out, 1);
      if (j < 0 || j >= n) continue;
      if (lane == 0) {
        if (pass == 0) {
          h_up = 0;
          f_up = kNeg;
          cm_up = 0;
        } else {
          const int4 b = bp[j];
          h_up = b.x;
          f_up = b.y;
          cm_up = b.z;
        }
      }
      const int code = min((int)cp[j], n_codes - 1);
      int f = f_up;
      const int cm = colmax_strip<RS>(h, e, prof + code * RS * kLanes + lane,
                                      diag, f, my_row0, m16);
      diag = h_up;
      h_bot = h[RS - 1];
      f_out = f;
      cm_out = max(cm_up, cm);
      if (lane == kLanes - 1) {
        if (last) {
          op[j] = cm_out;
        } else {
          bp[j] = make_int4(h_bot, f_out, cm_out, 0);
        }
      }
    }
  }
}

// Window pass: per candidate window r, the striped end-finding pass of
// kernels/xla.py:window_pass_xla — (best, end_col, end_row) with the
// terminate-on-equality rule.  codes uint8[R, W]; prof int32[C, Mp]
// (prof[c, i] = score of code c against query row i); out int32[R, 3];
// bnd int4[R, W] boundary rows (H, F carry, column max, its row).
template <int RS>
__global__ void __launch_bounds__(kLanes* kWarps)
    window_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ offs, const int* __restrict__ terms,
                  const int* __restrict__ rlens,
                  const int* __restrict__ mreals,
                  const int* __restrict__ qprof, int* __restrict__ out,
                  int4* __restrict__ bnd, int n_rows, int w, int n_codes,
                  int mp, int m, int n_pass) {
  extern __shared__ int prof[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int r = blockIdx.x * kWarps + (threadIdx.x / kLanes);
  const bool live = r < n_rows;
  const int rl = live ? min(max(rlens[r], 0), w) : 0;
  const int off = live ? offs[r] : 0;
  const int mreal = live ? mreals[r] : 0;
  const int term = live ? terms[r] : 0;
  const uint8_t* cp = codes + (size_t)r * w;
  int4* bp = bnd + (size_t)r * w;
  int best = 0, ecol = -1, erow = m - 1;
  bool act = true;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * kLanes * RS;
    __syncthreads();
    stage_profile<RS>(prof, qprof, n_codes, mp, row0);
    __syncthreads();
    if (!live) continue;
    const int my_row0 = row0 + lane * RS;
    const bool last = pass == n_pass - 1;
    int h[RS], e[RS];
#pragma unroll
    for (int k = 0; k < RS; ++k) h[k] = e[k] = 0;
    int h_bot = 0, f_out = kNeg, cm_out = 0, rm_out = kBig, diag = 0;
    for (int step = 0; step < rl + kLanes - 1; ++step) {
      const int j = step - lane;
      int h_up = __shfl_up_sync(kFull, h_bot, 1);
      int f_up = __shfl_up_sync(kFull, f_out, 1);
      int cm_up = __shfl_up_sync(kFull, cm_out, 1);
      int rm_up = __shfl_up_sync(kFull, rm_out, 1);
      if (j < 0 || j >= rl) continue;
      if (lane == 0) {
        if (pass == 0) {
          h_up = 0;
          f_up = kNeg;
          cm_up = 0;
          rm_up = kBig;
        } else {
          const int4 b = bp[j];
          h_up = b.x;
          f_up = b.y;
          cm_up = b.z;
          rm_up = b.w;
        }
      }
      const int code = min((int)cp[j], n_codes - 1);
      int f = f_up;
      int srow;
      const int cm = window_strip<RS>(h, e, prof + code * RS * kLanes + lane,
                                      diag, f, my_row0, off, mreal, m, srow);
      diag = h_up;
      h_bot = h[RS - 1];
      f_out = f;
      // merge (max, lowest row attaining it) with the rows above
      if (cm > cm_up) {
        cm_out = cm;
        rm_out = srow;
      } else {
        cm_out = cm_up;
        rm_out = (cm == cm_up && rm_up == kBig) ? srow : rm_up;
      }
      if (lane == kLanes - 1) {
        if (last) {
          if (act && cm_out > best) {
            best = cm_out;
            ecol = j;
            erow = rm_out;
          }
          if (cm_out == term) act = false;
        } else {
          bp[j] = make_int4(h_bot, f_out, cm_out, rm_out);
        }
      }
    }
  }
  if (live && lane == kLanes - 1) {
    out[(size_t)r * 3 + 0] = best;
    out[(size_t)r * 3 + 1] = ecol;
    out[(size_t)r * 3 + 2] = erow;
  }
}

template <template <int> class Launch, typename... Args>
bool dispatch_rs(int rs, Args... args) {
  switch (rs) {
    case 4: Launch<4>::run(args...); return true;
    case 8: Launch<8>::run(args...); return true;
    case 12: Launch<12>::run(args...); return true;
    case 16: Launch<16>::run(args...); return true;
    case 20: Launch<20>::run(args...); return true;
    case 24: Launch<24>::run(args...); return true;
    case 28: Launch<28>::run(args...); return true;
    case 32: Launch<32>::run(args...); return true;
    default: return false;
  }
}

template <int RS>
struct LaunchColmax {
  static void run(cudaStream_t stream, size_t smem, const uint8_t* codes,
                  const int* matq, int* out, int4* bnd, int n_pairs, int n,
                  int n_codes, int mp, int m16, int n_pass) {
    const int grid = (n_pairs + kWarps - 1) / kWarps;
    colmax_kernel<RS><<<grid, kLanes * kWarps, smem, stream>>>(
        codes, matq, out, bnd, n_pairs, n, n_codes, mp, m16, n_pass);
  }
};

template <int RS>
struct LaunchWindow {
  static void run(cudaStream_t stream, size_t smem, const uint8_t* codes,
                  const int* offs, const int* terms, const int* rlens,
                  const int* mreals, const int* qprof, int* out, int4* bnd,
                  int n_rows, int w, int n_codes, int mp, int m, int n_pass) {
    const int grid = (n_rows + kWarps - 1) / kWarps;
    window_kernel<RS><<<grid, kLanes * kWarps, smem, stream>>>(
        codes, offs, terms, rlens, mreals, qprof, out, bnd, n_rows, w,
        n_codes, mp, m, n_pass);
  }
};

ffi::Error check_plan(int rs, int n_pass, int rows, size_t smem) {
  if (rs <= 0 || rs > 32 || rs % 4 != 0 || n_pass <= 0 ||
      (int64_t)rs * kLanes * n_pass < rows) {
    return ffi::Error::InvalidArgument("fasim: bad strip plan");
  }
  if (smem > 48 * 1024) {
    return ffi::Error::InvalidArgument("fasim: profile exceeds shared memory");
  }
  return ffi::Error::Success();
}

ffi::Error launched() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("fasim kernel launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error ColmaxImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> codes,
                      ffi::Buffer<ffi::S32> matq,
                      ffi::ResultBuffer<ffi::S32> out,
                      ffi::ResultBuffer<ffi::S32> bnd, int32_t m16,
                      int32_t rs, int32_t n_pass) {
  const auto cd = codes.dimensions();
  const auto md = matq.dimensions();
  if (cd.size() != 2 || md.size() != 2) {
    return ffi::Error::InvalidArgument("fasim_colmax: codes[P, N], matq[C, Mp]");
  }
  const int64_t n_pairs = cd[0], n = cd[1], n_codes = md[0], mp = md[1];
  const size_t smem = (size_t)n_codes * rs * kLanes * sizeof(int);
  ffi::Error err = check_plan(rs, n_pass, m16, smem);
  if (!err.success()) return err;
  if (n_pass > 1 && bnd->element_count() < (size_t)(n_pairs * n * 4)) {
    return ffi::Error::InvalidArgument("fasim_colmax: boundary too small");
  }
  if (n_pairs == 0 || n == 0) return ffi::Error::Success();
  dispatch_rs<LaunchColmax>(
      rs, stream, smem, codes.typed_data(), matq.typed_data(),
      out->typed_data(), reinterpret_cast<int4*>(bnd->typed_data()),
      (int)n_pairs, (int)n, (int)n_codes, (int)mp, (int)m16, (int)n_pass);
  return launched();
}

ffi::Error WindowImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> codes,
                      ffi::Buffer<ffi::S32> offs, ffi::Buffer<ffi::S32> terms,
                      ffi::Buffer<ffi::S32> rlens,
                      ffi::Buffer<ffi::S32> mreals,
                      ffi::Buffer<ffi::S32> qprof,
                      ffi::ResultBuffer<ffi::S32> out,
                      ffi::ResultBuffer<ffi::S32> bnd, int32_t m, int32_t rows,
                      int32_t rs, int32_t n_pass) {
  const auto cd = codes.dimensions();
  const auto qd = qprof.dimensions();
  if (cd.size() != 2 || qd.size() != 2) {
    return ffi::Error::InvalidArgument("fasim_window: codes[R, W], prof[C, Mp]");
  }
  const int64_t n_rows = cd[0], w = cd[1], n_codes = qd[0], mp = qd[1];
  const size_t smem = (size_t)n_codes * rs * kLanes * sizeof(int);
  ffi::Error err = check_plan(rs, n_pass, rows, smem);
  if (!err.success()) return err;
  if (n_pass > 1 && bnd->element_count() < (size_t)(n_rows * w * 4)) {
    return ffi::Error::InvalidArgument("fasim_window: boundary too small");
  }
  if (n_rows == 0) return ffi::Error::Success();
  dispatch_rs<LaunchWindow>(
      rs, stream, smem, codes.typed_data(), offs.typed_data(),
      terms.typed_data(), rlens.typed_data(), mreals.typed_data(),
      qprof.typed_data(), out->typed_data(),
      reinterpret_cast<int4*>(bnd->typed_data()), (int)n_rows, (int)w,
      (int)n_codes, (int)mp, (int)m, (int)n_pass);
  return launched();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FasimColmax, ColmaxImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("m16")
                                  .Attr<int32_t>("rs")
                                  .Attr<int32_t>("n_pass"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(FasimWindow, WindowImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("m")
                                  .Attr<int32_t>("rows")
                                  .Attr<int32_t>("rs")
                                  .Attr<int32_t>("n_pass"));

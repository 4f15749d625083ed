// K11c rsf_ritz_select: the Rayleigh-Ritz filter of one sigma band of the
// randomized spectral frontend, per cut i of a chunk.  Two kernels, both in
// place:
//
//   shift:   before the band's r x r eigh, the column-valid pass
//            (_col_valid: |U[:, c]|^2 > 0.25) and the sentinel shift
//            T[c, c] += big for every invalid column c (on T itself);
//   select:  after it, per Ritz column c with value lam_c
//              res_c  = |C V[:, c] - lam_c V[:, c]|     (over the block rows)
//              sig2_c = lam_c (1 - lam_c)
//              keep_c = sig2_c >= lo2 and res_c < res_tol and lam_c < 2
//                       and sig2_c < hi_ext               (hi_ext = inf: none)
//            and writes lam_c or the sentinel, and zeroes V's dropped
//            columns over the block rows (V itself becomes V * keep).
//
// Replaces temfpy_tpu/ops/spectral.py:_rsf_chunk_impl :214-221 (_col_valid
// :144-146 and the _BIG shift) and :224-234 (the residual and keep rule).
// Sums run over the block rows: the operands are exact zeros outside them
// (rsf_tsprod's "mul" writes V so), and the kernels read nothing there.
//
// What bounds it on the H100: bytes (U, or V and CV, over the block rows
// read once; the dropped columns' block rows written once: ~3 operations
// per 8-byte word).  The parent copied V into a fresh tensor over all L
// rows (about 4x the bytes the function needs at the main path's mean
// block of ~256 of 1024 rows), worked on a copy of T, and kept one or a
// few 256-byte loads a warp in flight in 64 blocks.  The design: grid
// (column groups of 16, cuts), 128 blocks at r = 64, m = 32; a block's 128
// threads stage 64 block rows of its 16 columns a stage through a cp.async
// ring (8-byte copies, 3 stages in flight ahead of the chains), and thread
// (p, c) runs partial p of column c over the staged rows lo + p, lo + p +
// 8, ...  The eight partials and their order (each in ascending rows,
// added 0 .. 7 through shared memory) are the parent's, so every column's
// sum, keep flag and lam_out keep the parent's bits.  The dropped columns'
// block rows are zeroed by the thread that read them.  No allocation, no
// host sync.

#include "common.cuh"

namespace {

constexpr int kCols = 16;                  // columns a block
constexpr int kParts = 8;                  // row-residue partials a column
constexpr int kThreads = kCols * kParts;   // thread (p, c): p = tid / kCols
constexpr int kRows = 64;                  // block rows a stage (8 of each partial)
constexpr int kStages = 4;                 // stages of the cp.async ring

template <bool SELECT>
struct RStage {
    double x[kRows][kCols];                  // U or V
    double y[SELECT ? kRows : 1][kCols];     // C V
};

// Partial p of column cl of the block's columns (the operands X, Y at the
// block's first column; ncol of its columns real): fma(d, d, .) over the
// block rows l = lo + p, lo + p + 8, ... < hi in ascending order, d = Y[l,
// c] - lc X[l, c] (select) or X[l, c] (shift).  The block's 128 threads
// stage kRows rows of its 16 columns a stage (8-byte cp.async, rows past
// hi read as zero), kStages - 1 stages ahead of the chains.  Every thread
// of the block calls it.
template <bool SELECT>
__device__ __forceinline__ double partial_sum(RStage<SELECT>* st, const double* X,
                                              const double* Y, double lc, int lo, int hi,
                                              int ncol, int r) {
    const int tid = threadIdx.x, p = tid / kCols, cl = tid % kCols;
    auto load = [&](int buf, int kt) {
        for (int e = tid; e < kRows * kCols; e += kThreads) {
            const int row = lo + kt * kRows + e / kCols, col = e % kCols;
            const bool in = row < hi && col < ncol;
            const long long at = in ? (long long)row * r + col : 0;
            cp_async8(&st[buf].x[e / kCols][col], X + at, in ? 8 : 0);
            if (SELECT) cp_async8(&st[buf].y[e / kCols][col], Y + at, in ? 8 : 0);
        }
    };
    double part = 0.0;
    int kt = 0;  // the stage compute() consumes (in order)
    cp_async_pipeline<kStages>((hi - lo + kRows - 1) / kRows, load, [&](int buf) {
#pragma unroll
        for (int t = 0; t < kRows / kParts; ++t) {
            const int sr = kParts * t + p;
            if (lo + kt * kRows + sr < hi) {
                const double x = st[buf].x[sr][cl];
                const double d = SELECT ? st[buf].y[sr][cl] - lc * x : x;
                part = fma(d, d, part);
            }
        }
        ++kt;
    });
    return part;
}

// The column's total in the parent's order (0.0 + partial 0 + ... + 7), in
// the threads of partial 0.
__device__ __forceinline__ double column_total(double part, int p, int c,
                                               double (*red)[kCols]) {
    red[p][c] = part;
    __syncthreads();
    double tot = 0.0;
    if (p == 0)
        for (int k = 0; k < kParts; ++k) tot += red[k][c];
    return tot;
}

__global__ void __launch_bounds__(kThreads)
    rsf_ritz_shift_kernel(const double* __restrict__ U, double* __restrict__ T,
                          const int* __restrict__ sizes, double big, int L, int r, int right) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ double red[kParts][kCols];
    const int i = blockIdx.y, c0 = blockIdx.x * kCols;
    const int p = threadIdx.x / kCols, cl = threadIdx.x % kCols, c = c0 + cl;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const double part =
        partial_sum<false>(reinterpret_cast<RStage<false>*>(smem_raw),
                           U + (long long)i * L * r + c0, nullptr, 0.0, lo, hi, r - c0, r);
    const double tot = column_total(part, p, cl, red);
    if (p == 0 && c < r && !(tot > 0.25)) T[((long long)i * r + c) * r + c] += big;
}

__global__ void __launch_bounds__(kThreads)
    rsf_ritz_select_kernel(double* V, const double* __restrict__ CV,
                           const double* __restrict__ lam, const int* __restrict__ sizes,
                           double* __restrict__ lam_out, double lo2, double hi_ext,
                           double res_tol, double sentinel, int L, int r, int right) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ double red[kParts][kCols];
    __shared__ int keep_s[kCols];
    const int i = blockIdx.y, c0 = blockIdx.x * kCols;
    const int p = threadIdx.x / kCols, cl = threadIdx.x % kCols, c = c0 + cl;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const long long base = (long long)i * L * r + c0;
    const double lc = c < r ? lam[(long long)i * r + c] : 0.0;
    const double part = partial_sum<true>(reinterpret_cast<RStage<true>*>(smem_raw), V + base,
                                          CV + base, lc, lo, hi, r - c0, r);
    const double tot = column_total(part, p, cl, red);
    if (p == 0) {
        int keep = 1;
        if (c < r) {
            const double res = sqrt(tot);
            const double sig2 = lc * (1.0 - lc);
            keep = sig2 >= lo2 && res < res_tol && lc < 2.0 && sig2 < hi_ext;
            lam_out[(long long)i * r + c] = keep ? lc : sentinel;
        }
        keep_s[cl] = keep;
    }
    __syncthreads();
    if (c < r && !keep_s[cl])  // a dropped column: its block rows (the thread's partial) to 0
        for (int l = lo + p; l < hi; l += kParts) V[base + (long long)l * r + cl] = 0.0;
}

}  // namespace

extern "C" int tf_rsf_ritz_shift(const double* U, double* T, const int* sizes, double big, int m,
                                 int L, int r, int right, void* stream) {
    if (m == 0 || r == 0) return (int)cudaSuccess;
    return (int)launch_dynamic_smem<rsf_ritz_shift_kernel>(
        dim3((r + kCols - 1) / kCols, m), kThreads, (int)(kStages * sizeof(RStage<false>)),
        (cudaStream_t)stream, U, T, sizes, big, L, r, right);
}

// V is read and its dropped columns zeroed in place (block rows only).
extern "C" int tf_rsf_ritz_select(double* V, const double* CV, const double* lam,
                                  const int* sizes, double* lam_out, double lo2, double hi_ext,
                                  double res_tol, double sentinel, int m, int L, int r,
                                  int right, void* stream) {
    if (m == 0 || r == 0) return (int)cudaSuccess;
    return (int)launch_dynamic_smem<rsf_ritz_select_kernel>(
        dim3((r + kCols - 1) / kCols, m), kThreads, (int)(kStages * sizeof(RStage<true>)),
        (cudaStream_t)stream, V, CV, lam, sizes, lam_out, lo2, hi_ext, res_tol, sentinel, L, r,
        right);
}

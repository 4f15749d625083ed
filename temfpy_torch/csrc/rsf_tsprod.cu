// K11b rsf_tsprod: the batched tall-skinny products of the randomized
// spectral frontend, per cut i of a chunk, over the rows of its block
// (the leading s_i rows for side L, the trailing s_i for side R: every
// operand of these products is zero outside them).  Two kernels:
//
//   gram:     G_i = A_i^T B_i                       (A_i: L x p, B_i: L x q)
//             with ncol[i] given, columns >= ncol[i] of A and B read as zero
//             and G_i[c, c] += 1 for c >= ncol[i]
//   combine:  mode 0  Y_i = Z_i - A_i S_i           (S_i: p x q)
//             mode 1  Y_i = A_i S_i
//             mode 2  Y_i = A_i S_i diag(d_i),  d = e > f^2 ? 1/sqrt(e) : 0
//             rows outside the block: Z_i (mode 0) or 0
//
// Replaces, in temfpy_tpu/ops/spectral.py:_rsf_chunk_impl, the einsums of
// _corth's Gram (:138) and its Y Q diag(inv) (:139-141, the eigenvalue
// filter folded into mode 2), the deflation's U^T Z and Z - U (U^T Z)
// (:199-203), T = U^T C U (:216), V = U Wv (:223) and CholeskyQR2's Gram
// with its identity pad (:252-254).  Dropped lanes stay exact zero columns:
// mode 2 writes 0 * sum for e <= f^2, and zero columns of A or S contribute
// exact zeros to every sum.
//
// What bounds it on the H100: bytes for the r-wide products (2 s p q
// operations against 8 s (p + q) bytes: 32 a byte at p = q = 64, near the
// card's 20 at FP64 peak, but on a few blocks each), operations for the
// filled sketch's rf x rf Gram.  The design: one 64 x 64 output tile per
// block with common.cuh:tile_accumulate; the gram reduces over the block
// rows inside one block in a fixed order (deterministic, no atomics; A read
// depth-major, so its loads coalesce along p), and the combine reads A
// row-major.  Gram tiles past ncol write zeros and the pad's ones without
// reading anything; combine tiles outside the block rows copy Z or write
// zeros.  No allocation, no host sync: the kernels run on the caller's
// stream.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kTileThreads)
    rsf_gram_kernel(const double* __restrict__ A, const double* __restrict__ B,
                    const int* __restrict__ sizes, const int* __restrict__ ncol,
                    double* __restrict__ G, int L, int p, int q, int right) {
    __shared__ TileSmem s;
    const int i = blockIdx.z;
    const int a0 = blockIdx.y * kTile;
    const int b0 = blockIdx.x * kTile;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const int nc = ncol ? ncol[i] : max(p, q);
    const int a_rows = min(kTile, min(p, nc) - a0);
    const int b_cols = min(kTile, min(q, nc) - b0);

    double acc[4][4];
    tile_zero(acc);
    if (a_rows > 0 && b_cols > 0 && lo < hi)
        tile_accumulate<true>(acc, A + (long long)i * L * p + a0, p, a_rows,
                              B + (long long)i * L * q + b0, q, b_cols, lo, hi, s);
    double* g = G + (long long)i * p * q;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int a = a0 + ty + 16 * r;
        if (a >= p) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int b = b0 + tx + 16 * j;
            if (b >= q) continue;
            const double pad = (ncol && a == b && a >= nc) ? 1.0 : 0.0;
            g[(long long)a * q + b] = acc[r][j] + pad;
        }
    }
}

__global__ void __launch_bounds__(kTileThreads)
    rsf_combine_kernel(const double* __restrict__ A, const double* __restrict__ S,
                       const double* __restrict__ Z, const double* __restrict__ e,
                       const int* __restrict__ sizes, double* __restrict__ out, double floor2,
                       int L, int p, int q, int right, int mode) {
    __shared__ TileSmem s;
    const int i = blockIdx.z;
    const int l0 = blockIdx.y * kTile;
    const int c0 = blockIdx.x * kTile;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const bool live = l0 < hi && l0 + kTile > lo && p > 0;

    double acc[4][4];
    tile_zero(acc);
    if (live)
        tile_accumulate<false>(acc, A + ((long long)i * L + l0) * p, p, min(kTile, L - l0),
                               S + (long long)i * p * q + c0, q, min(kTile, q - c0), 0, p, s);
    const long long base = (long long)i * L * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c >= q) continue;
        double d = 1.0;
        if (mode == 2) {
            const double ev = e[(long long)i * q + c];
            d = ev > floor2 ? 1.0 / sqrt(ev) : 0.0;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int l = l0 + ty + 16 * r;
            if (l >= L) continue;
            const long long at = base + (long long)l * q + c;
            const bool in = l >= lo && l < hi;
            double v;
            if (mode == 0)
                v = in ? Z[at] - acc[r][j] : Z[at];
            else
                v = in ? acc[r][j] * d : 0.0;
            out[at] = v;
        }
    }
}

}  // namespace

extern "C" int tf_rsf_gram(const double* A, const double* B, const int* sizes, const int* ncol,
                           double* G, int m, int L, int p, int q, int right, void* stream) {
    if (m == 0 || p == 0 || q == 0) return (int)cudaSuccess;
    dim3 grid((q + kTile - 1) / kTile, (p + kTile - 1) / kTile, m);
    rsf_gram_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(A, B, sizes, ncol, G, L, p,
                                                                     q, right);
    return (int)cudaGetLastError();
}

extern "C" int tf_rsf_combine(const double* A, const double* S, const double* Z, const double* e,
                              const int* sizes, double* out, double floor, int m, int L, int p,
                              int q, int right, int mode, void* stream) {
    if (m == 0 || L == 0 || q == 0) return (int)cudaSuccess;
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    dim3 grid((q + kTile - 1) / kTile, (L + kTile - 1) / kTile, m);
    rsf_combine_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(
        A, S, Z, e, sizes, out, floor * floor, L, p, q, right, mode);
    return (int)cudaGetLastError();
}

// K11a rsf_apply: the masked operator products of the randomized spectral
// frontend, per cut i of a chunk
//   out_i = M_out (C (M_in X_i)),
// with C the (L x L) correlation matrix and X_i an (L x n) column block.
//
// Replaces the closures capp, mtapp and mapp of
// temfpy_tpu/ops/spectral.py:_rsf_chunk_impl (:182-195) and the filled
// sketch's capp (:250).  The masks are row ranges derived from the cut's
// block size s_i and the side (block = the leading s rows for side L, the
// trailing s rows for side R; complement = the other rows), never a float
// mask array:
//   mode 0 capp  (C_LL V):    in = block,      out = block
//   mode 1 mtapp (C_LR^T V):  in = block,      out = complement
//   mode 2 mapp  (C_LR W):    in = complement, out = block
// X may be one (L x n) block shared by every cut (x_shared: the random
// sketches), and ncol[i], where given, zeroes input columns >= ncol[i] (the
// filled sketch's n_f columns).
//
// What bounds it on the H100: float64 operations at the sweep's large
// blocks.  A capp on s rows does 2 s^2 n operations against ~8 (s + L) n
// bytes of X and out (32 operations a byte at s = 512, n = 64, above the
// card's 20 at FP64 peak), mapp/mtapp 2 s (L - s) n; small blocks are bound
// by the bytes of their zero-filled outputs.  The design: one 64 x 64
// output tile per block (common.cuh:tile_accumulate, 256 threads holding
// 4 x 4 sums each, depth 16 through shared memory).  The depth loop runs
// over the input range only, so tiles of C outside the masked rows and
// columns are never read; output tiles outside M_out, or past the live
// columns, skip the product and write exact zeros.  CUDA-core FP64; no
// tensor cores (DMMA), no TMA.  No allocation, no host sync: the kernel
// runs on the caller's stream.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(kTileThreads)
    rsf_apply_kernel(const double* __restrict__ C, const double* __restrict__ X, int x_shared,
                     const int* __restrict__ sizes, const int* __restrict__ ncol,
                     double* __restrict__ out, int L, int n, int right, int mode) {
    __shared__ TileSmem s;
    const int i = blockIdx.z;
    const int a0 = blockIdx.y * kTile;
    const int c0 = blockIdx.x * kTile;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

    int blo, bhi;
    rsf_block_rows(L, sizes[i], right, &blo, &bhi);
    // complement rows: [0, blo) for side R, [bhi, L) for side L
    const int clo = right ? 0 : bhi, chi = right ? blo : L;
    const int in_lo = mode == 2 ? clo : blo, in_hi = mode == 2 ? chi : bhi;
    const int out_lo = mode == 1 ? clo : blo, out_hi = mode == 1 ? chi : bhi;
    const int nc = ncol ? min(ncol[i], n) : n;
    const int b_cols = min(kTile, nc - c0);
    const bool live = a0 < out_hi && a0 + kTile > out_lo && in_lo < in_hi && b_cols > 0;

    double acc[4][4];
    tile_zero(acc);
    if (live) {
        const double* Xi = X + (x_shared ? 0LL : (long long)i * L * n);
        tile_accumulate<false>(acc, C + (long long)a0 * L, L, min(kTile, L - a0), Xi + c0, n,
                               b_cols, in_lo, in_hi, s);
    }
    double* o = out + (long long)i * L * n;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int l = a0 + ty + 16 * r;
        if (l >= L) continue;
        const bool keep = l >= out_lo && l < out_hi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx + 16 * j;
            if (c < n) o[(long long)l * n + c] = keep ? acc[r][j] : 0.0;
        }
    }
}

}  // namespace

extern "C" int tf_rsf_apply(const double* C, const double* X, int x_shared, const int* sizes,
                            const int* ncol, double* out, int m, int L, int n, int right,
                            int mode, void* stream) {
    if (m == 0 || L == 0 || n == 0) return (int)cudaSuccess;
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    dim3 grid((n + kTile - 1) / kTile, (L + kTile - 1) / kTile, m);
    rsf_apply_kernel<<<grid, kTileThreads, 0, (cudaStream_t)stream>>>(C, X, x_shared, sizes, ncol,
                                                                      out, L, n, right, mode);
    return (int)cudaGetLastError();
}

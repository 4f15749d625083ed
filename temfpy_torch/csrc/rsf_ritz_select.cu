// K11c rsf_ritz_select: the Rayleigh-Ritz filter of one sigma band of the
// randomized spectral frontend, per cut i of a chunk.  Two kernels:
//
//   shift:   before the band's r x r eigh, the column-valid pass
//            (_col_valid: |U[:, c]|^2 > 0.25) and the sentinel shift
//            T[c, c] += big for every invalid column c (in place on T);
//   select:  after it, per Ritz column c with value lam_c
//              res_c  = |C V[:, c] - lam_c V[:, c]|     (over the block rows)
//              sig2_c = lam_c (1 - lam_c)
//              keep_c = sig2_c >= lo2 and res_c < res_tol and lam_c < 2
//                       and sig2_c < hi_ext               (hi_ext = inf: none)
//            and writes V[:, c] * keep_c and lam_c or the sentinel.
//
// Replaces temfpy_tpu/ops/spectral.py:_rsf_chunk_impl :214-221 (_col_valid
// :144-146 and the _BIG shift) and :224-234 (the residual and keep rule).
// Sums run over the block rows (the operands are zero outside them).
//
// What bounds it on the H100: bytes (U, or V and CV, read once; V * keep
// written once: ~3 operations per 8-byte word).  The design: grid (column
// groups of 32, cuts); a block's 8 warps stride over the block rows with one
// lane per column, so every warp load is 256 contiguous bytes; the 8 partial
// sums per column are added in a fixed order through shared memory
// (deterministic), and the keep flag is shared with the whole block for
// the masked copy.  No allocation, no host sync.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ double column_sum(double part, int w, int lane, double (*red)[32]) {
    red[w][lane] = part;
    __syncthreads();
    double tot = 0.0;
    for (int k = 0; k < kWarps; ++k) tot += red[k][lane];
    return tot;
}

__global__ void __launch_bounds__(kWarps * 32)
    rsf_ritz_shift_kernel(const double* __restrict__ U, double* __restrict__ T,
                          const int* __restrict__ sizes, double big, int L, int r, int right) {
    __shared__ double red[kWarps][32];
    const int i = blockIdx.y;
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int c = blockIdx.x * 32 + lane;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const double* Ui = U + (long long)i * L * r;
    double part = 0.0;
    if (c < r)
        for (int l = lo + w; l < hi; l += kWarps) {
            const double v = Ui[(long long)l * r + c];
            part = fma(v, v, part);
        }
    const double tot = column_sum(part, w, lane, red);
    if (w == 0 && c < r && !(tot > 0.25)) T[((long long)i * r + c) * r + c] += big;
}

__global__ void __launch_bounds__(kWarps * 32)
    rsf_ritz_select_kernel(const double* __restrict__ V, const double* __restrict__ CV,
                           const double* __restrict__ lam, const int* __restrict__ sizes,
                           double* __restrict__ Vk, double* __restrict__ lam_out, double lo2,
                           double hi_ext, double res_tol, double sentinel, int L, int r,
                           int right) {
    __shared__ double red[kWarps][32];
    __shared__ int keep_s[32];
    const int i = blockIdx.y;
    const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
    const int c = blockIdx.x * 32 + lane;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const long long base = (long long)i * L * r;
    const double lc = c < r ? lam[(long long)i * r + c] : 0.0;
    double part = 0.0;
    if (c < r)
        for (int l = lo + w; l < hi; l += kWarps) {
            const long long at = base + (long long)l * r + c;
            const double d = CV[at] - lc * V[at];
            part = fma(d, d, part);
        }
    const double tot = column_sum(part, w, lane, red);
    if (w == 0) {
        int keep = 0;
        if (c < r) {
            const double res = sqrt(tot);
            const double sig2 = lc * (1.0 - lc);
            keep = sig2 >= lo2 && res < res_tol && lc < 2.0 && sig2 < hi_ext;
            lam_out[(long long)i * r + c] = keep ? lc : sentinel;
        }
        keep_s[lane] = keep;
    }
    __syncthreads();
    if (c < r) {
        const bool keep = keep_s[lane];
        for (int l = w; l < L; l += kWarps) {
            const long long at = base + (long long)l * r + c;
            Vk[at] = keep ? V[at] : 0.0;
        }
    }
}

}  // namespace

extern "C" int tf_rsf_ritz_shift(const double* U, double* T, const int* sizes, double big, int m,
                                 int L, int r, int right, void* stream) {
    if (m == 0 || r == 0) return (int)cudaSuccess;
    dim3 grid((r + 31) / 32, m);
    rsf_ritz_shift_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(U, T, sizes, big, L, r,
                                                                          right);
    return (int)cudaGetLastError();
}

extern "C" int tf_rsf_ritz_select(const double* V, const double* CV, const double* lam,
                                  const int* sizes, double* Vk, double* lam_out, double lo2,
                                  double hi_ext, double res_tol, double sentinel, int m, int L,
                                  int r, int right, void* stream) {
    if (m == 0 || r == 0) return (int)cudaSuccess;
    dim3 grid((r + 31) / 32, m);
    rsf_ritz_select_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        V, CV, lam, sizes, Vk, lam_out, lo2, hi_ext, res_tol, sentinel, L, r, right);
    return (int)cudaGetLastError();
}

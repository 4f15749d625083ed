// K5 det_rows: determinants of index-row submatrices of identity-extended
// matrices, paired or all-pairs.
//
// Replaces temfpy_tpu/ops/linalg.py:_det_pairs_impl (batched_det_pairs),
// _det_gather_impl (batched_det_gather) and the rank-update cross-check
// _det_check_impl, built there on gather_submatrices and lu_det.
//
// For matrix g and determinant q:
//   paired (cross = 0):  rows idx_b[g, q], cols idx_k[g, q]       -> out[g, q]
//   all pairs (cross=1): rows idx_b[g, i], cols idx_k[g, j]       -> out[g, i, j]
//   A[s, t] = M_aug[row[s], col[t]]  (w x w),  out = det(A) * scale[g]
// where M_aug = diag(M[g], I) is never formed: an index >= m is a sentinel of
// the identity extension (common.cuh:identity_ext), so an all-sentinel row
// pair gives 1.
//
// What bounds it on the H100: float64 arithmetic of many tiny LUs (w^3/3
// multiply-adds per determinant, w <= 64) and the latency of the gathers
// from M and the index rows.  The design is det_fill's (K1): one thread per
// determinant, the w x w matrix in thread-private memory (registers for
// w <= 8, local memory cached in L1 above), the LU of common.cuh
// (lu_det_private, the pivot rule of the JAX package), M read from global
// memory (a few KB per matrix, cached), no shared memory and no
// synchronisation.  The width is a template bound (4, 8, 16, 32, 64).  No
// allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

template <typename T, int W>
__global__ void det_rows_kernel(const T* __restrict__ M, const T* __restrict__ scale,
                                const int* __restrict__ idx_b, const int* __restrict__ idx_k,
                                T* __restrict__ out, int m, int w, int nb, int nk, int cross) {
    const int g = blockIdx.y;
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long n = cross ? (long long)nb * nk : nb;
    if (q >= n) return;
    const long long i = cross ? q / nk : q;
    const long long j = cross ? q % nk : q;
    const int* rb = idx_b + ((long long)g * nb + i) * w;
    const int* ck = idx_k + ((long long)g * nk + j) * w;
    const T* Mg = M + (long long)g * m * m;

    T A[W * W];
    int ci[W];
    for (int t = 0; t < w; ++t) ci[t] = ck[t];
    for (int s = 0; s < w; ++s) {
        const int a = rb[s];
        for (int t = 0; t < w; ++t) A[s * W + t] = identity_ext(Mg, m, a, ci[t]);
    }
    out[(long long)g * n + q] = lu_det_private<T, W>(A, w) * scale[g];
}

template <typename T, int W>
int launch(const void* M, const void* scale, const int* idx_b, const int* idx_k, void* out,
           int G, int m, int w, int nb, int nk, int cross, cudaStream_t stream) {
    const int threads = 128;
    const long long n = cross ? (long long)nb * nk : nb;
    dim3 grid((unsigned)((n + threads - 1) / threads), G);
    det_rows_kernel<T, W><<<grid, threads, 0, stream>>>((const T*)M, (const T*)scale, idx_b,
                                                        idx_k, (T*)out, m, w, nb, nk, cross);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* M, const void* scale, const int* idx_b, const int* idx_k, void* out,
             int G, int m, int w, int nb, int nk, int cross, cudaStream_t stream) {
#define TF_LAUNCH(WW) return launch<T, WW>(M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross, stream)
    if (w <= 4) TF_LAUNCH(4);
    if (w <= 8) TF_LAUNCH(8);
    if (w <= 16) TF_LAUNCH(16);
    if (w <= 32) TF_LAUNCH(32);
    if (w <= 64) TF_LAUNCH(64);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tf_det_rows(int dtype, const void* M, const void* scale, const int* idx_b,
                           const int* idx_k, void* out, int G, int m, int w, int nb, int nk,
                           int cross, void* stream) {
    if (G == 0 || nb == 0 || (cross && nk == 0)) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == TF_F64) return dispatch<double>(M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross, s);
    if (dtype == TF_C128) return dispatch<c128>(M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross, s);
    return (int)cudaErrorInvalidValue;
}

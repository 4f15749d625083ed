// K7' pf_gather: all-pairs Pfaffians of index-row principal submatrices.
//
// Replaces temfpy_tpu/ops/pfaffian.py:_pf_gather_impl (batched_pfaffian_gather),
// built there on symplectic_pad and the Parlett-Reid batch _pfaffian_batch.
//
// For bra row i and ket row j:
//   ix  = [ket_idx[j, :kk], bra_idx[i, :kb]]          (k = kk + kb, even)
//   out[i, j] = Pf(N_aug[ix, ix])
// where N_aug = N + J + ... + J (J = [[0, 1], [-1, 0]] on the index pairs
// (m, m+1), (m+2, m+3), ...; temfpy_tpu/ops/pfaffian.py:symplectic_pad) is
// never formed: an entry with both indices >= m is +1 or -1 on a J block and
// 0 elsewhere, a mixed entry is 0.  Unlike pf_fill (K3), whose planner puts
// the sentinels in one contiguous tail and eliminates only the leading
// block, this takes index rows as callers give them, so the whole k x k
// matrix is eliminated, as the JAX kernel does.
//
// What bounds it on the H100: the arithmetic of about k^3 / 6 entry updates
// per pair (k <= 32) and the latency of each pair's chain of k / 2 pivot
// steps.  The design is K3's: one warp per pair, the matrix in the warp's
// slice of shared memory, the warp Parlett-Reid of common.cuh
// (warp_parlett_reid: the JAX pivot rule, first maximal row), N read from
// global memory (cached).  The width is a template bound (8, 16, 32); float64
// and complex128.  No allocation, no host sync: the kernel runs on the
// caller's stream.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // pairs per block

template <typename T>
__device__ __forceinline__ T j_ext(const T* N, int m, int a, int b) {
    if (a < m && b < m) return N[(long long)a * m + b];
    if (a < m || b < m) return Num<T>::zero();
    const int da = a - m, db = b - m;
    if (!(da & 1) && db == da + 1) return Num<T>::one();
    if ((da & 1) && db == da - 1) return -Num<T>::one();
    return Num<T>::zero();
}

template <typename T, int W>
__global__ void pf_gather_kernel(const T* __restrict__ N, const int* __restrict__ bra_idx,
                                 const int* __restrict__ ket_idx, T* __restrict__ out, int m,
                                 int nb, int nk, int kb, int kk) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    T* A = reinterpret_cast<T*>(smem_raw) + warp * W * W;
    T* u = reinterpret_cast<T*>(smem_raw) + kWarps * W * W + warp * W;
    int* ix = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw) + kWarps * (W * W + W)) +
              warp * W;

    const long long q = (long long)blockIdx.x * kWarps + warp;
    if (q >= (long long)nb * nk) return;  // whole warp: no block-wide barrier follows
    const int i = (int)(q / nk), j = (int)(q % nk);
    const int k = kk + kb;
    for (int s = lane; s < k; s += 32)
        ix[s] = s < kk ? ket_idx[(long long)j * kk + s] : bra_idx[(long long)i * kb + s - kk];
    __syncwarp();
    for (int e = lane; e < k * k; e += 32) A[(e / k) * W + e % k] = j_ext(N, m, ix[e / k], ix[e % k]);
    __syncwarp();
    const T pf = warp_parlett_reid<T, W>(A, u, k, lane);
    if (lane == 0) out[q] = pf;
}

template <typename T, int W>
int launch(const void* N, const int* bra_idx, const int* ket_idx, void* out, int m, int nb,
           int nk, int kb, int kk, cudaStream_t stream) {
    const size_t smem = (size_t)kWarps * ((W * W + W) * sizeof(T) + W * sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(pf_gather_kernel<T, W>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)nb * nk;
    pf_gather_kernel<T, W><<<(unsigned)((n + kWarps - 1) / kWarps), 32 * kWarps, smem, stream>>>(
        (const T*)N, bra_idx, ket_idx, (T*)out, m, nb, nk, kb, kk);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* N, const int* bra_idx, const int* ket_idx, void* out, int m, int nb,
             int nk, int kb, int kk, cudaStream_t stream) {
#define TF_LAUNCH(WW) return launch<T, WW>(N, bra_idx, ket_idx, out, m, nb, nk, kb, kk, stream)
    const int k = kb + kk;
    if (k <= 8) TF_LAUNCH(8);
    if (k <= 16) TF_LAUNCH(16);
    if (k <= 32) TF_LAUNCH(32);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tf_pf_gather(int dtype, const void* N, const int* bra_idx, const int* ket_idx,
                            void* out, int m, int nb, int nk, int kb, int kk, void* stream) {
    if (nb == 0 || nk == 0) return (int)cudaSuccess;
    if ((kb + kk) & 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == TF_F64) return dispatch<double>(N, bra_idx, ket_idx, out, m, nb, nk, kb, kk, s);
    if (dtype == TF_C128) return dispatch<c128>(N, bra_idx, ket_idx, out, m, nb, nk, kb, kk, s);
    return (int)cudaErrorInvalidValue;
}

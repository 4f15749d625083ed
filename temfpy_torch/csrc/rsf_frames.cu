// K11d rsf_frames: the bookkeeping and the frame assembly of the
// randomized spectral frontend, per cut i of a chunk.  Two kernels:
//
//   stats (after the last band): over the n = N_BANDS * r Ritz lanes
//          lam[i, :] (the sentinel marks dropped lanes; valid = lam < 2)
//            k      = #valid,  lam_sum = sum of the valid lam
//            nf_f   = rint(tr_i - lam_sum),  n_f = max(nf_f, 0)
//            tr_res = |tr_i - lam_sum - nf_f|
//          and order[i, t] = the lane of ascending-lambda rank t (the key is
//          lam, or the sentinel for a dropped lane; ties go to the lower lane
//          index, as a stable argsort).
//   place (after CholeskyQR2): the (L x Wb) frame, Wb = kb + rf,
//            slab[i, :, t]     = U_all[i, :, order[i, t]]  for t < min(k, kb)
//            slab[i, :, k + f] = Yf[i, :, f]               for f < min(n_f, rf),
//                                                          k + f < Wb
//          every other slot 0; and the per-cut float64 row
//            packed[i] = [lam sorted (kb) | 1 - lam sorted (kb) | k | n_f | tr_res]
//          with the sentinel past the valid lanes, and tr_res = inf where the
//          CholeskyQR2 factorisations report info[i] != 0 (a filled Gram that
//          is not positive definite leaves a partial factor, so the filled
//          basis is not orthonormal and the host reroutes the cut).
//
// Replaces temfpy_tpu/ops/spectral.py:_rsf_chunk_impl :236-242 (the sweep's
// counts and trace check) and :262-299 (the stable argsort ranks, the
// one-hot f32-split placement `place` and the packed host buffer, which
// here stays float64).
//
// What bounds it on the H100: bytes (the slab is written once, each source
// column read once).  The design: stats runs one block per cut with the n
// keys in shared memory and counts each lane's rank directly (n^2 = 65536
// compares at n = 256: no sort network), and one thread adds lam_sum in lane
// order (deterministic); place runs one thread per slab entry, a gather by
// the rank table, so consecutive threads write consecutive columns of a
// row.  No allocation, no host sync.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rsf_frames_stats_kernel(const double* __restrict__ lam, const double* __restrict__ tr,
                            int* __restrict__ k_out, int* __restrict__ nf_out,
                            double* __restrict__ tr_res, int* __restrict__ order, double sentinel,
                            int n) {
    extern __shared__ double key[];
    const int i = blockIdx.x;
    const double* li = lam + (long long)i * n;
    for (int j = threadIdx.x; j < n; j += kThreads) key[j] = li[j] < 2.0 ? li[j] : sentinel;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
        const double kj = key[j];
        int rank = 0;
        for (int t = 0; t < n; ++t) rank += (key[t] < kj) || (key[t] == kj && t < j);
        order[(long long)i * n + rank] = j;
    }
    if (threadIdx.x == 0) {
        int k = 0;
        double sum = 0.0;
        for (int j = 0; j < n; ++j)
            if (li[j] < 2.0) {
                ++k;
                sum += li[j];
            }
        const double nf_f = rint(tr[i] - sum);
        k_out[i] = k;
        nf_out[i] = (int)fmax(nf_f, 0.0);
        tr_res[i] = fabs(tr[i] - sum - nf_f);
    }
}

__global__ void __launch_bounds__(kThreads)
    rsf_frames_place_kernel(const double* __restrict__ U_all, const double* __restrict__ Yf,
                            const double* __restrict__ lam, const int* __restrict__ k_in,
                            const int* __restrict__ nf_in, const double* __restrict__ tr_res,
                            const int* __restrict__ info, const int* __restrict__ order,
                            double* __restrict__ slab,
                            double* __restrict__ packed, double sentinel, int L, int n, int rf,
                            int kb, int Wb) {
    const int i = blockIdx.z, l = blockIdx.y;
    const int c = blockIdx.x * kThreads + threadIdx.x;
    const int k = k_in[i], nf = nf_in[i];
    const int* oi = order + (long long)i * n;
    if (c < Wb) {
        double v = 0.0;
        if (c < k && c < kb)
            v = U_all[((long long)i * L + l) * n + oi[c]];
        else if (c >= k && c - k < min(nf, rf))
            v = Yf[((long long)i * L + l) * rf + (c - k)];
        slab[((long long)i * L + l) * Wb + c] = v;
    }
    if (l == 0 && blockIdx.x == 0) {
        double* row = packed + (long long)i * (2 * kb + 3);
        for (int t = threadIdx.x; t < kb; t += kThreads) {
            const double lt = t < n ? lam[(long long)i * n + oi[t]] : sentinel;
            const bool valid = lt < 2.0;
            row[t] = valid ? lt : sentinel;
            row[kb + t] = valid ? 1.0 - lt : sentinel;
        }
        if (threadIdx.x == 0) {
            row[2 * kb] = k;
            row[2 * kb + 1] = nf;
            row[2 * kb + 2] = info[i] != 0 ? (double)INFINITY : tr_res[i];
        }
    }
}

}  // namespace

extern "C" int tf_rsf_frames_stats(const double* lam, const double* tr, int* k, int* nf,
                                   double* tr_res, int* order, double sentinel, int m, int n,
                                   void* stream) {
    if (m == 0) return (int)cudaSuccess;
    rsf_frames_stats_kernel<<<m, kThreads, n * sizeof(double), (cudaStream_t)stream>>>(
        lam, tr, k, nf, tr_res, order, sentinel, n);
    return (int)cudaGetLastError();
}

extern "C" int tf_rsf_frames_place(const double* U_all, const double* Yf, const double* lam,
                                   const int* k, const int* nf, const double* tr_res,
                                   const int* info, const int* order, double* slab,
                                   double* packed,
                                   double sentinel, int m, int L, int n, int rf, int kb, int Wb,
                                   void* stream) {
    if (m == 0 || L == 0) return (int)cudaSuccess;
    dim3 grid((Wb + kThreads - 1) / kThreads, L, m);
    rsf_frames_place_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        U_all, Yf, lam, k, nf, tr_res, info, order, slab, packed, sentinel, L, n, rf, kb, Wb);
    return (int)cudaGetLastError();
}

// K1 det_fill: the fused determinant fill of one width bucket of the
// Slater -> MPS tensor fill.
//
// Replaces temfpy_tpu/slater.py:_det_fill_packed_impl (with its grouped
// forms _det_fill_packed_group / _det_fill_fused_group and the plan-buffer
// split _split_packed_flat), which is built on ops/linalg.py:
// block_diag_identity_pad, gather_submatrices and lu_det.
//
// Per (bra, ket) pair p of site g:
//   r = pr[g, p], c = pc[g, p]
//   A[s, t] = M_aug[occ_b[g, r, s], occ_k[g, c, t]]   (w x w)
//   T[g, tab0[..], tab1[..], tab2[..]] = det(A) * det_always[g]
// where M_aug = diag(M[g], I_w) is never formed: an index >= m is a
// sentinel of the identity extension, so such an entry is 1 if the bra and
// ket indices are equal and 0 otherwise.  Each table is indexed by r or by c
// according to bit i of `sel` (the JAX `spec`: "rc", "rrc", "crr").  Padded
// pairs carry all-sentinel rows and land in the trash row T[g, D0] that the
// wrapper slices off.
//
// What bounds it on the H100: f64 arithmetic of many tiny LUs (w^3/3 FMAs
// per pair, w <= 64) and the latency of the scattered gathers from M and
// the index tables.  The design: one thread per pair, the w x w matrix in
// thread-private memory (registers for w <= 8, local memory cached in L1
// above), M read straight from global memory (it is a few KB per site and
// stays in L1/L2), no shared memory and no synchronisation, so blocks run
// fully independently.  The width is a template bound (4, 8, 16, 32, 64)
// so small buckets get small private arrays.  No allocation, no sync: the
// kernel runs on the caller's stream.

#include "common.cuh"

namespace {

template <typename T, int W>
__global__ void det_fill_kernel(const T* __restrict__ M, const T* __restrict__ det_always,
                                const int* __restrict__ occ_b, const int* __restrict__ occ_k,
                                const int* __restrict__ pr, const int* __restrict__ pc,
                                const int* __restrict__ tab0, const int* __restrict__ tab1,
                                const int* __restrict__ tab2, T* __restrict__ out, int m, int w,
                                int R_b, int K_b, int P_b, int n0, int n1, int n2, int sel,
                                int D0p1, int D1, int D2) {
    const int g = blockIdx.y;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P_b) return;
    const int r = pr[(long long)g * P_b + p];
    const int c = pc[(long long)g * P_b + p];
    const int* rb = occ_b + ((long long)g * R_b + r) * w;
    const int* ck = occ_k + ((long long)g * K_b + c) * w;
    const T* Mg = M + (long long)g * m * m;

    T A[W * W];
    int ci[W];
    for (int t = 0; t < w; ++t) ci[t] = ck[t];
    for (int s = 0; s < w; ++s) {
        const int a = rb[s];
        for (int t = 0; t < w; ++t) {
            const int b = ci[t];
            T v;
            if (a < m && b < m)
                v = Mg[(long long)a * m + b];
            else
                v = (a == b) ? Num<T>::one() : Num<T>::zero();
            A[s * W + t] = v;
        }
    }

    // LU with partial pivoting; first maximal |A[i, k]| wins, as in
    // temfpy_tpu/ops/linalg.py:_lu_det_body
    T det = Num<T>::one();
    for (int k = 0; k < w; ++k) {
        int piv_row = k;
        double best = Num<T>::mag(A[k * W + k]);
        for (int i = k + 1; i < w; ++i) {
            const double v = Num<T>::mag(A[i * W + k]);
            if (v > best) {
                best = v;
                piv_row = i;
            }
        }
        if (piv_row != k) {
            for (int j = k; j < w; ++j) {
                const T tmp = A[k * W + j];
                A[k * W + j] = A[piv_row * W + j];
                A[piv_row * W + j] = tmp;
            }
            det = -det;
        }
        const T piv = A[k * W + k];
        det = det * piv;
        const T safe = Num<T>::is_zero(piv) ? Num<T>::one() : piv;
        for (int i = k + 1; i < w; ++i) {
            const T f = A[i * W + k] / safe;
            for (int j = k + 1; j < w; ++j) A[i * W + j] = A[i * W + j] - f * A[k * W + j];
        }
    }
    det = det * det_always[g];

    const int i0 = (sel & 1) ? c : r;
    const int i1 = (sel & 2) ? c : r;
    const int i2 = (sel & 4) ? c : r;
    const int c0 = tab0[(long long)g * n0 + i0];
    const int c1 = tab1[(long long)g * n1 + i1];
    const int c2 = n2 ? tab2[(long long)g * n2 + i2] : 0;
    out[(((long long)g * D0p1 + c0) * D1 + c1) * D2 + c2] = det;
}

template <typename T, int W>
void launch(const void* M, const void* det_always, const int* occ_b, const int* occ_k,
            const int* pr, const int* pc, const int* tab0, const int* tab1, const int* tab2,
            void* out, int G, int m, int w, int R_b, int K_b, int P_b, int n0, int n1, int n2,
            int sel, int D0p1, int D1, int D2, cudaStream_t stream) {
    const int threads = 128;
    dim3 grid((P_b + threads - 1) / threads, G);
    det_fill_kernel<T, W><<<grid, threads, 0, stream>>>(
        (const T*)M, (const T*)det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, (T*)out, m,
        w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2);
}

template <typename T>
int dispatch(const void* M, const void* det_always, const int* occ_b, const int* occ_k,
             const int* pr, const int* pc, const int* tab0, const int* tab1, const int* tab2,
             void* out, int G, int m, int w, int R_b, int K_b, int P_b, int n0, int n1, int n2,
             int sel, int D0p1, int D1, int D2, cudaStream_t stream) {
#define TF_LAUNCH(WW)                                                                        \
    launch<T, WW>(M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, out, G, m, w, R_b, \
                  K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2, stream)
    if (w <= 4)
        TF_LAUNCH(4);
    else if (w <= 8)
        TF_LAUNCH(8);
    else if (w <= 16)
        TF_LAUNCH(16);
    else if (w <= 32)
        TF_LAUNCH(32);
    else if (w <= 64)
        TF_LAUNCH(64);
    else
        return (int)cudaErrorInvalidValue;
#undef TF_LAUNCH
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_det_fill(int dtype, const void* M, const void* det_always, const int* occ_b,
                           const int* occ_k, const int* pr, const int* pc, const int* tab0,
                           const int* tab1, const int* tab2, void* out, int G, int m, int w,
                           int R_b, int K_b, int P_b, int n0, int n1, int n2, int sel, int D0p1,
                           int D1, int D2, void* stream) {
    if (G == 0 || P_b == 0) return (int)cudaSuccess;
    if (dtype == TF_F64)
        return dispatch<double>(M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, out, G, m,
                                w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
                                (cudaStream_t)stream);
    if (dtype == TF_C128)
        return dispatch<c128>(M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, out, G, m,
                              w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
                              (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

// K4 bdg_overlap: the grouped Bogoliubov overlap of the BdG/Pfaffian -> MPS
// tensor fill.
//
// Replaces temfpy_tpu/pfaffian.py:_assemble_N_complex and, in native
// complex128, temfpy_tpu/ops/splitc.py:pf_overlap_kernel /
// _pf_overlap_kernel_half (with _nambu_full; the split (re, im) planes are
// not carried over).
//
// One thread block per site g.  The inputs are the annihilator halves
// V1h, V2h (2nb x nb) of the vacuum-padded bra and ket Nambu mode matrices;
// with site-interleaved rows the creator column of mode j is the conjugate
// of annihilator column j with even and odd rows swapped, so for
// Vr = V1^H V2:
//   U*[i, j]          = Vr[nb+i, nb+j] = sum_r V1h[r, i] conj(V2h[r, j])
//   P[a, t]           = Vr[j1[a], nb+t] = sum_r conj(V1h[r, j1[a]]) conj(V2h[r^1, t])
//   Q[t, b]           = Vr[nb+t, j2[b]] = sum_r V1h[r^1, t] V2h[r, j2[b]]
// Gauss-Jordan with partial pivoting on [U* | I] (the elimination of
// temfpy_tpu/ops/linalg.py:gauss_solve_det, first maximal pivot, a zero
// pivot leaves its row unscaled) gives det U* and Ui = U*^-1, then
//   BB = Ui[j2, :] Q,  BA = Ui[j2, j1],  AA = P Ui[:, j1]
//   N = [[ (BB - BB^T)/2, BA ], [ -BA^T, (AA - AA^T)/2 ]]     (k2+k1 square)
//   norm = |det U*|^(1/2), NaN if |det U*| < thresh[g] or not finite.
// The JAX kernel takes the determinant of U = Vr[:nb, :nb]; here U* is the
// entrywise conjugate of U (the creator halves are conjugates), so
// |det U*| = |det U| and one elimination serves the inverse and the norm.
// thresh[g] = max(min_SV^x, 1e-300) with the site's true half size x.
//
// What bounds it on the H100: a serial chain of nb pivot steps per site,
// each a pivot search plus block-wide synchronisations (the arithmetic,
// about 2 nb^3 complex multiply-adds per site, is small); one block per
// site, about 128 sites per conversion, so the card's SMs each run about one
// site.  The design: U* with its identity, P and Q live in shared memory
// (180 KB at nb = 64, k1 + k2 = 48), the products are formed in the
// kernel's own loops straight from the frames in global memory, the pivot
// search is one thread's loop (nb <= 64), and each elimination step is
// spread over the block, columns k.. only (the columns left of k are
// already reduced).  No allocation, no host sync: the kernel runs on the
// caller's stream.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ c128 conjc(c128 x) { return c128{x.re, -x.im}; }

__global__ void bdg_overlap_kernel(const c128* __restrict__ V1h, const c128* __restrict__ V2h,
                                   const int* __restrict__ j1, const int* __restrict__ j2,
                                   const double* __restrict__ thresh, int nb, int k1, int k2,
                                   c128* __restrict__ N_out, double* __restrict__ norm_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int w2 = 2 * nb;                           // row stride of [U* | I]
    c128* Wm = reinterpret_cast<c128*>(smem_raw);   // nb x 2nb
    c128* P = Wm + nb * w2;                          // k1 x nb
    c128* Q = P + k1 * nb;                           // nb x k2
    c128* fac = Q + nb * k2;                         // nb
    c128* det_s = fac + nb;                          // 1
    __shared__ int s_piv;

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const c128* A1 = V1h + (long long)g * w2 * nb;
    const c128* A2 = V2h + (long long)g * w2 * nb;
    const int* J1 = j1 + (long long)g * k1;
    const int* J2 = j2 + (long long)g * k2;

    // ---- the three blocks of Vr = V1^H V2 that the products read
    for (int e = tid; e < nb * nb; e += nt) {
        const int i = e / nb, j = e % nb;
        c128 acc = Num<c128>::zero();
        for (int r = 0; r < w2; ++r) acc = acc + A1[r * nb + i] * conjc(A2[r * nb + j]);
        Wm[i * w2 + j] = acc;
        Wm[i * w2 + nb + j] = (i == j) ? Num<c128>::one() : Num<c128>::zero();
    }
    for (int e = tid; e < k1 * nb; e += nt) {
        const int a = e / nb, t = e % nb;
        const int ja = J1[a];
        c128 acc = Num<c128>::zero();
        for (int r = 0; r < w2; ++r) acc = acc + conjc(A1[r * nb + ja]) * conjc(A2[(r ^ 1) * nb + t]);
        P[a * nb + t] = acc;
    }
    for (int e = tid; e < nb * k2; e += nt) {
        const int t = e / k2, b = e % k2;
        const int jb = J2[b];
        c128 acc = Num<c128>::zero();
        for (int r = 0; r < w2; ++r) acc = acc + A1[(r ^ 1) * nb + t] * A2[r * nb + jb];
        Q[t * k2 + b] = acc;
    }
    if (tid == 0) *det_s = Num<c128>::one();
    __syncthreads();

    // ---- Gauss-Jordan with partial pivoting on [U* | I]
    for (int k = 0; k < nb; ++k) {
        if (tid == 0) {
            int p = k;
            double best = Num<c128>::mag(Wm[k * w2 + k]);
            for (int i = k + 1; i < nb; ++i) {
                const double v = Num<c128>::mag(Wm[i * w2 + k]);
                if (v > best) {
                    best = v;
                    p = i;
                }
            }
            s_piv = p;
        }
        __syncthreads();
        const int p = s_piv;
        if (p != k) {
            for (int j = k + tid; j < w2; j += nt) {
                const c128 tmp = Wm[k * w2 + j];
                Wm[k * w2 + j] = Wm[p * w2 + j];
                Wm[p * w2 + j] = tmp;
            }
        }
        __syncthreads();
        const c128 piv = Wm[k * w2 + k];
        const c128 safe = Num<c128>::is_zero(piv) ? Num<c128>::one() : piv;
        if (tid == 0) *det_s = ((p != k) ? -(*det_s) : *det_s) * piv;
        for (int i = tid; i < nb; i += nt) fac[i] = (i == k) ? Num<c128>::zero() : Wm[i * w2 + k];
        __syncthreads();
        for (int j = k + tid; j < w2; j += nt) Wm[k * w2 + j] = Wm[k * w2 + j] / safe;
        __syncthreads();
        const int span = w2 - k;
        for (int e = tid; e < nb * span; e += nt) {
            const int i = e / span, j = k + e % span;
            if (i != k) Wm[i * w2 + j] = Wm[i * w2 + j] - fac[i] * Wm[k * w2 + j];
        }
        __syncthreads();
    }

    // ---- N assembly; Ui[i, j] = Wm[i, nb + j]
    const c128* Ui = Wm + nb;
    const int m = k1 + k2;
    c128* Ng = N_out + (long long)g * m * m;
    for (int e = tid; e < m * m; e += nt) {
        const int a = e / m, b = e % m;
        c128 v;
        if (a < k2 && b < k2) {
            const int ja = J2[a], jb = J2[b];
            c128 ab = Num<c128>::zero(), ba = Num<c128>::zero();
            for (int t = 0; t < nb; ++t) {
                ab = ab + Ui[ja * w2 + t] * Q[t * k2 + b];
                ba = ba + Ui[jb * w2 + t] * Q[t * k2 + a];
            }
            v = (ab - ba) * 0.5;
        } else if (a < k2) {
            v = Ui[J2[a] * w2 + J1[b - k2]];
        } else if (b < k2) {
            v = -Ui[J2[b] * w2 + J1[a - k2]];
        } else {
            const int a1 = a - k2, b1 = b - k2;
            const int ja = J1[a1], jb = J1[b1];
            c128 ab = Num<c128>::zero(), ba = Num<c128>::zero();
            for (int t = 0; t < nb; ++t) {
                ab = ab + P[a1 * nb + t] * Ui[t * w2 + jb];
                ba = ba + P[b1 * nb + t] * Ui[t * w2 + ja];
            }
            v = (ab - ba) * 0.5;
        }
        Ng[e] = v;
    }
    if (tid == 0) {
        const double absdet = Num<c128>::mag(*det_s);
        const bool bad = !isfinite(absdet) || absdet < thresh[g];
        norm_out[g] = bad ? nan("") : sqrt(absdet);
    }
}

// ---------------------------------------------------------------------------
// Global-memory variant, for half sizes whose [U* | I] does not fit in shared
// memory (nb > 64: BdG chains of L > 128 at the centre, or an off-centre
// ortho_center).  Same function, same elimination and pivot rule; [U* | I],
// P and Q live in a per-site workspace in global memory
// (2 nb^2 + (k1 + k2) nb entries, 0.6 MB at nb = 128).
//
// What bounds it: the serial chain of nb pivot steps, each a block-wide
// argmax and a rank-one update of nb x (2nb - k) entries through L2.  The
// design: one block of 512 threads per site, the pivot search as a
// block-wide argmax (first maximal row), the scaled pivot row and the column
// factors of each step cached in shared memory, columns left of the pivot
// (already reduced) not updated, as in the kernel above.

constexpr int kThreadsG = 512;

__global__ void __launch_bounds__(kThreadsG)
    bdg_overlap_gmem_kernel(const c128* __restrict__ V1h, const c128* __restrict__ V2h,
                            const int* __restrict__ j1, const int* __restrict__ j2,
                            const double* __restrict__ thresh, int nb, int k1, int k2,
                            c128* work, c128* __restrict__ N_out,
                            double* __restrict__ norm_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int w2 = 2 * nb;
    c128* fac = reinterpret_cast<c128*>(smem_raw);  // nb
    c128* prow = fac + nb;                            // 2nb
    __shared__ c128 det_s;

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const c128* A1 = V1h + (long long)g * w2 * nb;
    const c128* A2 = V2h + (long long)g * w2 * nb;
    const int* J1 = j1 + (long long)g * k1;
    const int* J2 = j2 + (long long)g * k2;
    c128* Wm = work + (long long)g * ((long long)nb * w2 + (long long)(k1 + k2) * nb);
    c128* P = Wm + (long long)nb * w2;  // k1 x nb
    c128* Q = P + (long long)k1 * nb;   // nb x k2

    // ---- the three blocks of Vr = V1^H V2 that the products read
    for (int e = tid; e < nb * nb; e += nt) {
        const int i = e / nb, j = e % nb;
        c128 acc = Num<c128>::zero();
        for (int r = 0; r < w2; ++r) acc = acc + A1[r * nb + i] * conjc(A2[r * nb + j]);
        Wm[(long long)i * w2 + j] = acc;
        Wm[(long long)i * w2 + nb + j] = (i == j) ? Num<c128>::one() : Num<c128>::zero();
    }
    for (int e = tid; e < k1 * nb; e += nt) {
        const int a = e / nb, t = e % nb;
        const int ja = J1[a];
        c128 acc = Num<c128>::zero();
        for (int r = 0; r < w2; ++r) acc = acc + conjc(A1[r * nb + ja]) * conjc(A2[(r ^ 1) * nb + t]);
        P[(long long)a * nb + t] = acc;
    }
    for (int e = tid; e < nb * k2; e += nt) {
        const int t = e / k2, b = e % k2;
        const int jb = J2[b];
        c128 acc = Num<c128>::zero();
        for (int r = 0; r < w2; ++r) acc = acc + A1[(r ^ 1) * nb + t] * A2[r * nb + jb];
        Q[(long long)t * k2 + b] = acc;
    }
    if (tid == 0) det_s = Num<c128>::one();
    __syncthreads();

    // ---- Gauss-Jordan with partial pivoting on [U* | I]
    for (int k = 0; k < nb; ++k) {
        double best = -1.0;
        int bi = 0x7fffffff;
        for (int i = k + tid; i < nb; i += nt) {
            const double v = Num<c128>::mag(Wm[(long long)i * w2 + k]);
            if (v > best) {
                best = v;
                bi = i;
            }
        }
        const int p = block_argmax_first(best, bi);
        if (p != k) {
            for (int j = k + tid; j < w2; j += nt) {
                const c128 tmp = Wm[(long long)k * w2 + j];
                Wm[(long long)k * w2 + j] = Wm[(long long)p * w2 + j];
                Wm[(long long)p * w2 + j] = tmp;
            }
        }
        __syncthreads();
        const c128 piv = Wm[(long long)k * w2 + k];
        const c128 safe = Num<c128>::is_zero(piv) ? Num<c128>::one() : piv;
        if (tid == 0) det_s = ((p != k) ? -det_s : det_s) * piv;
        for (int i = tid; i < nb; i += nt)
            fac[i] = (i == k) ? Num<c128>::zero() : Wm[(long long)i * w2 + k];
        for (int j = k + tid; j < w2; j += nt) prow[j] = Wm[(long long)k * w2 + j] / safe;
        __syncthreads();
        for (int j = k + tid; j < w2; j += nt) Wm[(long long)k * w2 + j] = prow[j];
        const int span = w2 - k;
        for (int e = tid; e < nb * span; e += nt) {
            const int i = e / span, j = k + e % span;
            if (i != k) Wm[(long long)i * w2 + j] = Wm[(long long)i * w2 + j] - fac[i] * prow[j];
        }
        __syncthreads();
    }

    // ---- N assembly; Ui[i, j] = Wm[i, nb + j]
    const c128* Ui = Wm + nb;
    const int m = k1 + k2;
    c128* Ng = N_out + (long long)g * m * m;
    for (int e = tid; e < m * m; e += nt) {
        const int a = e / m, b = e % m;
        c128 v;
        if (a < k2 && b < k2) {
            const int ja = J2[a], jb = J2[b];
            c128 ab = Num<c128>::zero(), ba = Num<c128>::zero();
            for (int t = 0; t < nb; ++t) {
                ab = ab + Ui[(long long)ja * w2 + t] * Q[(long long)t * k2 + b];
                ba = ba + Ui[(long long)jb * w2 + t] * Q[(long long)t * k2 + a];
            }
            v = (ab - ba) * 0.5;
        } else if (a < k2) {
            v = Ui[(long long)J2[a] * w2 + J1[b - k2]];
        } else if (b < k2) {
            v = -Ui[(long long)J2[b] * w2 + J1[a - k2]];
        } else {
            const int a1 = a - k2, b1 = b - k2;
            const int ja = J1[a1], jb = J1[b1];
            c128 ab = Num<c128>::zero(), ba = Num<c128>::zero();
            for (int t = 0; t < nb; ++t) {
                ab = ab + P[(long long)a1 * nb + t] * Ui[(long long)t * w2 + jb];
                ba = ba + P[(long long)b1 * nb + t] * Ui[(long long)t * w2 + ja];
            }
            v = (ab - ba) * 0.5;
        }
        Ng[e] = v;
    }
    if (tid == 0) {
        const double absdet = Num<c128>::mag(det_s);
        const bool bad = !isfinite(absdet) || absdet < thresh[g];
        norm_out[g] = bad ? nan("") : sqrt(absdet);
    }
}

}  // namespace

// `work` holds G x (2 nb^2 + (k1 + k2) nb) complex128 entries, allocated by the caller.
extern "C" int tf_bdg_overlap_gmem(const void* V1h, const void* V2h, const int* j1,
                                   const int* j2, const double* thresh, int G, int nb, int k1,
                                   int k2, void* work, void* N_out, double* norm_out,
                                   void* stream) {
    if (G == 0) return (int)cudaSuccess;
    const size_t smem = (size_t)3 * nb * sizeof(c128);
    cudaError_t err = cudaFuncSetAttribute(bdg_overlap_gmem_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    bdg_overlap_gmem_kernel<<<G, kThreadsG, smem, (cudaStream_t)stream>>>(
        (const c128*)V1h, (const c128*)V2h, j1, j2, thresh, nb, k1, k2, (c128*)work,
        (c128*)N_out, norm_out);
    return (int)cudaGetLastError();
}

extern "C" int tf_bdg_overlap(const void* V1h, const void* V2h, const int* j1, const int* j2,
                              const double* thresh, int G, int nb, int k1, int k2, void* N_out,
                              double* norm_out, void* stream) {
    if (G == 0) return (int)cudaSuccess;
    const size_t smem = ((size_t)2 * nb * nb + (size_t)(k1 + k2) * nb + nb + 1) * sizeof(c128);
    cudaError_t err = cudaFuncSetAttribute(bdg_overlap_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    bdg_overlap_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
        (const c128*)V1h, (const c128*)V2h, j1, j2, thresh, nb, k1, k2, (c128*)N_out, norm_out);
    return (int)cudaGetLastError();
}

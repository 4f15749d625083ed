// K2 site_overlap_schur: the per-site orbital overlap and Schur complement
// of the Slater -> MPS tensor fill.
//
// Replaces temfpy_tpu/slater.py:_site_overlap_impl (grouped as
// _site_overlap_group), which calls ops/linalg.py:gauss_solve_det
// (_gauss_solve_det_implicit on accelerators).
//
// One thread block per site g.  Column i of the bra orbital matrix vb
// (L x mb) is described by (col, kind, row, sign): kind 0 is frame column
// `col` of frames_b[g], kind 1 the one-hot vector at `row`, kind 2 zero; the
// column is multiplied by `sign`.  Likewise vk from frames_k[g].  Then
//   O = vb^H vk                                   (mb x mb)
//   left mode:  A = O[:kb, :kb], B = O[:kb, kb:], C = O[kb:, :kb], D = O[kb:, kb:]
//   right mode: A = O[-kb:, -kb:], B = O[-kb:, :-kb], C = O[:-kb, -kb:], D = O[:-kb, :-kb]
//   det_out[g] = det A,  S_out[g] = D - C A^{-1} B     (sb x sb, sb = mb - kb)
// Right mode is left mode on O with rows and columns rotated by sb, so the
// kernel stores O rotated by `off` (0 for left, sb for right) and runs one
// code path.  A^{-1}B comes from Gauss-Jordan with partial pivoting on
// [A | B], the elimination of temfpy_tpu/ops/linalg.py:gauss_solve_det.
//
// What bounds it on the H100: little arithmetic (L mb^2 FMAs for O, kb^2 mb
// for the elimination, per site) but a serial chain of kb pivot steps, each
// a reduction plus a block-wide synchronisation; and the frame reads, whose
// columns are strided in memory.  The design: O lives in shared memory
// (mb^2 entries), one block per site so the sites of a group run in
// parallel on different SMs, the pivot search by one thread (kb <= a few
// dozen), each elimination step spread over the block.  No allocation, no
// sync with the host: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void site_overlap_schur_kernel(const T* __restrict__ frames_b,
                                          const T* __restrict__ frames_k, int L, int Wb, int Wk,
                                          const int* __restrict__ colb,
                                          const int* __restrict__ kindb,
                                          const int* __restrict__ rowb,
                                          const double* __restrict__ signb,
                                          const int* __restrict__ colk,
                                          const int* __restrict__ kindk,
                                          const int* __restrict__ rowk,
                                          const double* __restrict__ signk, int mb, int kb,
                                          int off, T* __restrict__ det_out,
                                          T* __restrict__ S_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* O = reinterpret_cast<T*>(smem_raw);  // mb x mb, rotated by `off`
    T* fac = O + mb * mb;                   // column-k factors of one step
    T* det_s = fac + mb;                    // running determinant
    __shared__ int s_piv;

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const T* Fb = frames_b + (long long)g * L * Wb;
    const T* Fk = frames_k + (long long)g * L * Wk;
    const long long d0 = (long long)g * mb;
    colb += d0;
    kindb += d0;
    rowb += d0;
    signb += d0;
    colk += d0;
    kindk += d0;
    rowk += d0;
    signk += d0;

    // ---- O = vb^H vk, stored rotated: O_s[a][b] = O[(a+off)%mb][(b+off)%mb]
    for (int e = tid; e < mb * mb; e += nt) {
        const int a = e / mb, b = e % mb;
        const int i = (a + off) % mb, j = (b + off) % mb;
        const int ki = kindb[i], kj = kindk[j];
        T acc = Num<T>::zero();
        if (ki == 2 || kj == 2) {
            // zero column
        } else if (ki == 1 && kj == 1) {
            acc = (rowb[i] == rowk[j]) ? Num<T>::one() : Num<T>::zero();
        } else if (ki == 1) {
            acc = Fk[(long long)rowb[i] * Wk + colk[j]];
        } else if (kj == 1) {
            acc = Num<T>::conj(Fb[(long long)rowk[j] * Wb + colb[i]]);
        } else {
            const int ci = colb[i], cj = colk[j];
            for (int r = 0; r < L; ++r)
                acc = acc + Num<T>::conj(Fb[(long long)r * Wb + ci]) * Fk[(long long)r * Wk + cj];
        }
        O[a * mb + b] = acc * (signb[i] * signk[j]);
    }
    if (tid == 0) *det_s = Num<T>::one();
    __syncthreads();

    // ---- Gauss-Jordan with partial pivoting on rows 0..kb-1 of [A | B]
    for (int k = 0; k < kb; ++k) {
        if (tid == 0) {
            int p = k;
            double best = Num<T>::mag(O[k * mb + k]);
            for (int i = k + 1; i < kb; ++i) {
                const double v = Num<T>::mag(O[i * mb + k]);
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
            for (int j = tid; j < mb; j += nt) {
                const T tmp = O[k * mb + j];
                O[k * mb + j] = O[p * mb + j];
                O[p * mb + j] = tmp;
            }
        }
        __syncthreads();
        const T piv = O[k * mb + k];
        const T safe = Num<T>::is_zero(piv) ? Num<T>::one() : piv;
        if (tid == 0) *det_s = ((p != k) ? -(*det_s) : *det_s) * piv;
        for (int i = tid; i < kb; i += nt) fac[i] = (i == k) ? Num<T>::zero() : O[i * mb + k];
        __syncthreads();
        for (int j = tid; j < mb; j += nt) O[k * mb + j] = O[k * mb + j] / safe;
        __syncthreads();
        for (int e = tid; e < kb * mb; e += nt) {
            const int i = e / mb, j = e % mb;
            if (i != k) O[i * mb + j] = O[i * mb + j] - fac[i] * O[k * mb + j];
        }
        __syncthreads();
    }

    // ---- Schur complement S = D - C (A^{-1} B)
    const int sb = mb - kb;
    T* Sg = S_out + (long long)g * sb * sb;
    for (int e = tid; e < sb * sb; e += nt) {
        const int i = e / sb, j = e % sb;
        T acc = O[(kb + i) * mb + kb + j];
        for (int t = 0; t < kb; ++t) acc = acc - O[(kb + i) * mb + t] * O[t * mb + kb + j];
        Sg[e] = acc;
    }
    if (tid == 0) det_out[g] = *det_s;
}

// ---------------------------------------------------------------------------
// Global-memory variant, for overlap widths whose mb x mb matrix does not fit
// in shared memory (mb > 169 in float64, mb > 120 in complex128; bench
// config 1 at L = 1024 reaches mb = 288).  Same function, same elimination
// order and pivot rule (first maximal |a|); O lives in a G x mb x mb
// workspace in global memory (52 MB at mb = 320, G = 64 in float64, mostly
// L2-resident).
//
// What bounds it: the serial chain of kb pivot steps, each a block-wide
// argmax and a rank-one update of kb x (mb - k) entries in global memory,
// about kb^2 mb / 2 multiply-adds of traffic through L2 per site.  The
// design: one block of 512 threads per site; O formed by a tiled product
// (32 x 32 tiles of O, 16 frame rows per step in shared memory, so each frame
// column is read mb / 32 times instead of mb times); the pivot row and the
// column factors of each step cached in shared memory; columns left of the
// pivot, already reduced and never read again, are not updated.

constexpr int kThreadsG = 512;
constexpr int kTile = 32;  // O tile edge
constexpr int kRows = 16;  // frame rows per step

template <typename T>
__device__ __forceinline__ T orbital(const T* F, int W, int r, int kind, int col, int row) {
    if (kind == 0) return F[(long long)r * W + col];
    if (kind == 1) return (r == row) ? Num<T>::one() : Num<T>::zero();
    return Num<T>::zero();
}

template <typename T>
__global__ void __launch_bounds__(kThreadsG)
    site_overlap_schur_gmem_kernel(const T* __restrict__ frames_b, const T* __restrict__ frames_k,
                                   int L, int Wb, int Wk, const int* __restrict__ colb,
                                   const int* __restrict__ kindb, const int* __restrict__ rowb,
                                   const double* __restrict__ signb,
                                   const int* __restrict__ colk, const int* __restrict__ kindk,
                                   const int* __restrict__ rowk, const double* __restrict__ signk,
                                   int mb, int kb, int off, T* work, T* __restrict__ det_out,
                                   T* __restrict__ S_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* fac = reinterpret_cast<T*>(smem_raw);  // kb: column-k factors of one step
    T* prow = fac + kb;                       // mb: the scaled pivot row
    __shared__ T tb[kRows][kTile];
    __shared__ T tk[kRows][kTile];
    __shared__ int s_kind[2][kTile], s_col[2][kTile], s_row[2][kTile];
    __shared__ double s_sign[2][kTile];
    __shared__ T det_s;

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const T* Fb = frames_b + (long long)g * L * Wb;
    const T* Fk = frames_k + (long long)g * L * Wk;
    T* O = work + (long long)g * mb * mb;  // rotated by `off`, as in the kernel above
    const long long d0 = (long long)g * mb;

    // ---- O = vb^H vk by 32 x 32 tiles of (rotated) O
    const int ty = tid / kTile, tx = tid % kTile;  // 16 x 32 threads, rows ty and ty + 16
    for (int a0 = 0; a0 < mb; a0 += kTile) {
        for (int b0 = 0; b0 < mb; b0 += kTile) {
            if (tid < 2 * kTile) {
                const int s = tid / kTile, t = tid % kTile;
                const int a = (s == 0 ? a0 : b0) + t;
                const int i = (a + off) % mb;
                const bool in = a < mb;
                s_kind[s][t] = in ? (s == 0 ? kindb : kindk)[d0 + i] : 2;
                s_col[s][t] = in ? (s == 0 ? colb : colk)[d0 + i] : 0;
                s_row[s][t] = in ? (s == 0 ? rowb : rowk)[d0 + i] : 0;
                s_sign[s][t] = in ? (s == 0 ? signb : signk)[d0 + i] : 0.0;
            }
            __syncthreads();
            T acc0 = Num<T>::zero(), acc1 = Num<T>::zero();
            for (int r0 = 0; r0 < L; r0 += kRows) {
                {
                    const int rr = tid / kTile, t = tid % kTile, r = r0 + rr;
                    tb[rr][t] = (r < L) ? Num<T>::conj(orbital(Fb, Wb, r, s_kind[0][t],
                                                               s_col[0][t], s_row[0][t]))
                                        : Num<T>::zero();
                    tk[rr][t] = (r < L) ? orbital(Fk, Wk, r, s_kind[1][t], s_col[1][t],
                                                  s_row[1][t])
                                        : Num<T>::zero();
                }
                __syncthreads();
#pragma unroll
                for (int rr = 0; rr < kRows; ++rr) {
                    const T kv = tk[rr][tx];
                    acc0 = acc0 + tb[rr][ty] * kv;
                    acc1 = acc1 + tb[rr][ty + 16] * kv;
                }
                __syncthreads();
            }
            const int b = b0 + tx;
            if (b < mb) {
                if (a0 + ty < mb)
                    O[(long long)(a0 + ty) * mb + b] = acc0 * (s_sign[0][ty] * s_sign[1][tx]);
                if (a0 + ty + 16 < mb)
                    O[(long long)(a0 + ty + 16) * mb + b] =
                        acc1 * (s_sign[0][ty + 16] * s_sign[1][tx]);
            }
            __syncthreads();
        }
    }
    if (tid == 0) det_s = Num<T>::one();
    __syncthreads();

    // ---- Gauss-Jordan with partial pivoting on rows 0..kb-1 of [A | B]
    for (int k = 0; k < kb; ++k) {
        double best = -1.0;
        int bi = 0x7fffffff;
        for (int i = k + tid; i < kb; i += nt) {
            const double v = Num<T>::mag(O[(long long)i * mb + k]);
            if (v > best) {
                best = v;
                bi = i;
            }
        }
        const int p = block_argmax_first(best, bi);
        if (p != k) {
            for (int j = k + tid; j < mb; j += nt) {
                const T tmp = O[(long long)k * mb + j];
                O[(long long)k * mb + j] = O[(long long)p * mb + j];
                O[(long long)p * mb + j] = tmp;
            }
        }
        __syncthreads();
        const T piv = O[(long long)k * mb + k];
        const T safe = Num<T>::is_zero(piv) ? Num<T>::one() : piv;
        if (tid == 0) det_s = ((p != k) ? -det_s : det_s) * piv;
        for (int i = tid; i < kb; i += nt)
            fac[i] = (i == k) ? Num<T>::zero() : O[(long long)i * mb + k];
        for (int j = k + tid; j < mb; j += nt) prow[j] = O[(long long)k * mb + j] / safe;
        __syncthreads();
        for (int j = k + tid; j < mb; j += nt) O[(long long)k * mb + j] = prow[j];
        const int span = mb - k;
        for (int e = tid; e < kb * span; e += nt) {
            const int i = e / span, j = k + e % span;
            if (i != k) O[(long long)i * mb + j] = O[(long long)i * mb + j] - fac[i] * prow[j];
        }
        __syncthreads();
    }

    // ---- Schur complement S = D - C (A^{-1} B)
    const int sb = mb - kb;
    T* Sg = S_out + (long long)g * sb * sb;
    for (int e = tid; e < sb * sb; e += nt) {
        const int i = e / sb, j = e % sb;
        const T* Orow = O + (long long)(kb + i) * mb;
        T acc = Orow[kb + j];
        for (int t = 0; t < kb; ++t) acc = acc - Orow[t] * O[(long long)t * mb + kb + j];
        Sg[e] = acc;
    }
    if (tid == 0) det_out[g] = det_s;
}

template <typename T>
int launch_gmem(const void* frames_b, const void* frames_k, int G, int L, int Wb, int Wk,
                const int* colb, const int* kindb, const int* rowb, const double* signb,
                const int* colk, const int* kindk, const int* rowk, const double* signk, int mb,
                int kb, int off, void* work, void* det_out, void* S_out, cudaStream_t stream) {
    const size_t smem = ((size_t)kb + mb) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(site_overlap_schur_gmem_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    site_overlap_schur_gmem_kernel<T><<<G, kThreadsG, smem, stream>>>(
        (const T*)frames_b, (const T*)frames_k, L, Wb, Wk, colb, kindb, rowb, signb, colk,
        kindk, rowk, signk, mb, kb, off, (T*)work, (T*)det_out, (T*)S_out);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* frames_b, const void* frames_k, int G, int L, int Wb, int Wk,
           const int* colb, const int* kindb, const int* rowb, const double* signb,
           const int* colk, const int* kindk, const int* rowk, const double* signk, int mb,
           int kb, int off, void* det_out, void* S_out, cudaStream_t stream) {
    const size_t smem = ((size_t)mb * mb + mb + 1) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(site_overlap_schur_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    site_overlap_schur_kernel<T><<<G, kThreads, smem, stream>>>(
        (const T*)frames_b, (const T*)frames_k, L, Wb, Wk, colb, kindb, rowb, signb, colk,
        kindk, rowk, signk, mb, kb, off, (T*)det_out, (T*)S_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_site_overlap_schur(int dtype, const void* frames_b, const void* frames_k,
                                     int G, int L, int Wb, int Wk, const int* colb,
                                     const int* kindb, const int* rowb, const double* signb,
                                     const int* colk, const int* kindk, const int* rowk,
                                     const double* signk, int mb, int kb, int right_mode,
                                     void* det_out, void* S_out, void* stream) {
    if (G == 0) return (int)cudaSuccess;
    const int off = right_mode ? mb - kb : 0;
    if (dtype == TF_F64)
        return launch<double>(frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb, colk,
                              kindk, rowk, signk, mb, kb, off, det_out, S_out,
                              (cudaStream_t)stream);
    if (dtype == TF_C128)
        return launch<c128>(frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb, colk,
                            kindk, rowk, signk, mb, kb, off, det_out, S_out,
                            (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

// `work` is a G x mb x mb buffer of the frames' dtype, allocated by the caller.
extern "C" int tf_site_overlap_schur_gmem(int dtype, const void* frames_b, const void* frames_k,
                                          int G, int L, int Wb, int Wk, const int* colb,
                                          const int* kindb, const int* rowb,
                                          const double* signb, const int* colk,
                                          const int* kindk, const int* rowk,
                                          const double* signk, int mb, int kb, int right_mode,
                                          void* work, void* det_out, void* S_out, void* stream) {
    if (G == 0) return (int)cudaSuccess;
    const int off = right_mode ? mb - kb : 0;
    if (dtype == TF_F64)
        return launch_gmem<double>(frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb,
                                   colk, kindk, rowk, signk, mb, kb, off, work, det_out, S_out,
                                   (cudaStream_t)stream);
    if (dtype == TF_C128)
        return launch_gmem<c128>(frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb,
                                 colk, kindk, rowk, signk, mb, kb, off, work, det_out, S_out,
                                 (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

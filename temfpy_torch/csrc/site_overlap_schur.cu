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

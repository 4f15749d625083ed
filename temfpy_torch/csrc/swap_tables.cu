// K6a swap_tables: the base factorization and gather tables of the
// rank-update (swap) determinant fill, one (site, class) entry per block.
//
// Replaces temfpy_tpu/ops/linalg.py:det_swap_tables (with its group vmap
// det_swap_tables_group, and its uses of gather_submatrices and
// gauss_solve_det).
//
// For entry e, with M_aug = diag(M[e], I_w) (never formed: an index >= m is
// a sentinel of the identity extension, common.cuh:identity_ext), the base
// positions r0 = r0[e], c0 = c0[e] (w each) and m_aug = m + w:
//   A   = M_aug[r0, c0]                       (w x w, shared memory)
//   D0  = det(A),  G = A^-1                   (Gauss-Jordan on [A | I])
//   P   = M_aug[:, c0] G                      (m_aug x w)
//   T2  = G M_aug[r0, :]                      (w x m_aug)
//   T3  = P M_aug[r0, :]                      (m_aug x m_aug)
//   gmax = max |G|,  tmax = max(|P|, |T2|, |T3|)   (the class pre-screen)
// Gauss-Jordan pivots on the first row of maximal |A[i, k]| (i >= k), the
// rule of temfpy_tpu/ops/linalg.py:gauss_solve_det, through the block-wide
// common.cuh:block_argmax_first; a zero pivot gives det 0 and leaves its row
// unscaled, as there.
//
// What bounds it on the H100: nothing much at the main path's sizes (w <= 64,
// m_aug <= ~100): the w serial pivot steps of the elimination, each a block
// barrier or three, and the three small products, about 2 m_aug w^2 +
// 2 w^2 m_aug + 2 m_aug^2 w operations per entry.  The design: [A | I] and
// the pivot row and column in shared memory (64 KB for w = 64 in float64,
// 128 KB in complex128); the products read G from shared memory and M_aug,
// and for T3 the block's own P, from global memory (cached in L1); each
// output entry is one thread's dot product.  One block per entry, so a
// group of entries is one launch.  No allocation, no host sync: the kernel
// runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void swap_tables_kernel(const T* __restrict__ M, const int* __restrict__ r0,
                                   const int* __restrict__ c0, T* __restrict__ D0,
                                   T* __restrict__ Gout, T* __restrict__ Pout,
                                   T* __restrict__ T2out, T* __restrict__ T3out,
                                   double* __restrict__ gmax, double* __restrict__ tmax, int m,
                                   int w) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.x;
    const int tid = threadIdx.x;
    const int w2 = 2 * w;
    const int ma = m + w;
    T* AB = reinterpret_cast<T*>(smem_raw);  // w x 2w
    T* rowbuf = AB + w * w2;                 // 2w
    T* fac = rowbuf + w2;                    // w
    double* red = reinterpret_cast<double*>(fac + w);  // kThreads
    int* rs = reinterpret_cast<int*>(red + kThreads);  // w
    int* cs = rs + w;                                  // w

    const T* Me = M + (long long)e * m * m;
    for (int s = tid; s < w; s += kThreads) {
        rs[s] = r0[(long long)e * w + s];
        cs[s] = c0[(long long)e * w + s];
    }
    __syncthreads();
    for (int q = tid; q < w * w2; q += kThreads) {
        const int s = q / w2, t = q % w2;
        AB[q] = t < w ? identity_ext(Me, m, rs[s], cs[t])
                      : ((t - w == s) ? Num<T>::one() : Num<T>::zero());
    }
    __syncthreads();

    // Gauss-Jordan with partial pivoting on [A | I]
    T det = Num<T>::one();
    for (int k = 0; k < w; ++k) {
        const int i = k + tid;
        const double v = (tid < w - k) ? Num<T>::mag(AB[i * w2 + k]) : -1.0;
        const int p = block_argmax_first(v, i);
        if (p != k) {
            for (int j = tid; j < w2; j += kThreads) {
                const T tmp = AB[k * w2 + j];
                AB[k * w2 + j] = AB[p * w2 + j];
                AB[p * w2 + j] = tmp;
            }
            det = -det;
        }
        __syncthreads();
        const T piv = AB[k * w2 + k];
        det = det * piv;
        const T safe = Num<T>::is_zero(piv) ? Num<T>::one() : piv;
        for (int j = tid; j < w2; j += kThreads) rowbuf[j] = AB[k * w2 + j] / safe;
        for (int r = tid; r < w; r += kThreads) fac[r] = (r == k) ? Num<T>::zero() : AB[r * w2 + k];
        __syncthreads();
        for (int q = tid; q < w * w2; q += kThreads) {
            const int r = q / w2, j = q % w2;
            AB[q] = (r == k) ? rowbuf[j] : AB[q] - fac[r] * rowbuf[j];
        }
        __syncthreads();
    }

    // G, max|G| and D0
    T* Ge = Gout + (long long)e * w * w;
    double mx = 0.0;
    for (int q = tid; q < w * w; q += kThreads) {
        const T g = AB[(q / w) * w2 + w + q % w];
        Ge[q] = g;
        mx = fmax(mx, Num<T>::mag(g));
    }
    red[tid] = mx;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
        if (tid < h) red[tid] = fmax(red[tid], red[tid + h]);
        __syncthreads();
    }
    if (tid == 0) {
        gmax[e] = red[0];
        D0[e] = det;
    }

    // P = M_aug[:, c0] G   (m_aug x w)
    T* Pe = Pout + (long long)e * ma * w;
    mx = 0.0;
    for (int q = tid; q < ma * w; q += kThreads) {
        const int i = q / w, t = q % w;
        T acc = Num<T>::zero();
        for (int s = 0; s < w; ++s) acc = acc + identity_ext(Me, m, i, cs[s]) * AB[s * w2 + w + t];
        Pe[q] = acc;
        mx = fmax(mx, Num<T>::mag(acc));
    }
    // T2 = G M_aug[r0, :]   (w x m_aug)
    T* T2e = T2out + (long long)e * w * ma;
    for (int q = tid; q < w * ma; q += kThreads) {
        const int s = q / ma, j = q % ma;
        T acc = Num<T>::zero();
        for (int u = 0; u < w; ++u) acc = acc + AB[s * w2 + w + u] * identity_ext(Me, m, rs[u], j);
        T2e[q] = acc;
        mx = fmax(mx, Num<T>::mag(acc));
    }
    __syncthreads();  // the block's P writes are visible to all its threads
    // T3 = P M_aug[r0, :]   (m_aug x m_aug)
    T* T3e = T3out + (long long)e * ma * ma;
    for (long long q = tid; q < (long long)ma * ma; q += kThreads) {
        const int i = (int)(q / ma), j = (int)(q % ma);
        T acc = Num<T>::zero();
        for (int u = 0; u < w; ++u) acc = acc + Pe[i * w + u] * identity_ext(Me, m, rs[u], j);
        T3e[q] = acc;
        mx = fmax(mx, Num<T>::mag(acc));
    }
    red[tid] = mx;
    __syncthreads();
    for (int h = kThreads / 2; h > 0; h >>= 1) {
        if (tid < h) red[tid] = fmax(red[tid], red[tid + h]);
        __syncthreads();
    }
    if (tid == 0) tmax[e] = red[0];
}

template <typename T>
int launch(const void* M, const int* r0, const int* c0, void* D0, void* G, void* P, void* T2,
           void* T3, double* gmax, double* tmax, int E, int m, int w, cudaStream_t stream) {
    const size_t smem = (size_t)(2 * w * w + 3 * w) * sizeof(T) + kThreads * sizeof(double) +
                        2 * w * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(swap_tables_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    swap_tables_kernel<T><<<E, kThreads, smem, stream>>>(
        (const T*)M, r0, c0, (T*)D0, (T*)G, (T*)P, (T*)T2, (T*)T3, gmax, tmax, m, w);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_swap_tables(int dtype, const void* M, const int* r0, const int* c0, void* D0,
                              void* G, void* P, void* T2, void* T3, double* gmax,
                              double* tmax, int E, int m, int w, void* stream) {
    if (E == 0) return (int)cudaSuccess;
    if (w < 1 || w > 64) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == TF_F64) return launch<double>(M, r0, c0, D0, G, P, T2, T3, gmax, tmax, E, m, w, s);
    if (dtype == TF_C128) return launch<c128>(M, r0, c0, D0, G, P, T2, T3, gmax, tmax, E, m, w, s);
    return (int)cudaErrorInvalidValue;
}

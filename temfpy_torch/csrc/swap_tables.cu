// K6a swap_tables: the base factorization and gather tables of the
// rank-update (swap) determinant fill.
//
// Replaces temfpy_tpu/ops/linalg.py:det_swap_tables (with its group vmap
// det_swap_tables_group, and its uses of gather_submatrices and
// gauss_solve_det).
//
// For entry e, with M_aug = diag(M[e], I_w) (never formed: an index >= m is
// a sentinel of the identity extension, common.cuh:identity_ext), the base
// positions r0 = r0[e], c0 = c0[e] (w each) and m_aug = m + w:
//   A   = M_aug[r0, c0]                       (w x w)
//   D0  = det(A),  G = A^-1                   (Gauss-Jordan)
//   P   = M_aug[:, c0] G                      (m_aug x w)
//   T2  = G M_aug[r0, :]                      (w x m_aug)
//   T3  = P M_aug[r0, :]                      (m_aug x m_aug)
//   gmax = max |G|,  tmax = max(|P|, |T2|, |T3|)   (the class pre-screen;
//   NaN entries do not count)
// Gauss-Jordan pivots on the first row of maximal |A[i, k]| (i >= k), the
// rule of temfpy_tpu/ops/linalg.py:gauss_solve_det; a zero pivot gives det 0
// and leaves its row unscaled, as there.
//
// What bounds it on the H100: latency.  The arithmetic is tiny (about 2 w^3
// + 4 m_aug w^2 + 2 m_aug^2 w operations an entry, w <= 24 and m_aug <= 56
// on bench config 1) and the rank-update fill launches it per (m, w) group
// of a few entries.  The first design gave each entry one 256-thread block,
// so a launch cost one entry's serial chain: w Gauss-Jordan steps of about
// five block barriers each over [A | I] in shared memory, then P, T2 and T3
// as one thread's dot product per output through the branchy identity_ext
// from global memory, T3 reading P back after a barrier; and a launch of E
// entries filled E of the 132 SMs.
//
// The design: two launches on the caller's stream, no allocation, no sync
// with the host.
// (1) swap_inverse_kernel: A's rows in registers at constant indices, one
//     row a lane on a segment of W lanes (W = 8, 16, 32, the first that
//     holds w; the rest identity padding), several entries to a block; the
//     elimination is common.cuh:segment_gauss_jordan, the in-place
//     inversion of K4's (the identity half never stored), which divides the
//     pivot row one column a lane.  A w in (32, 64] takes
//     swap_inverse_wide_kernel: a warp per entry, A in shared memory (row
//     stride 65), rows swapped in place, each lane eliminating two rows.
//     Either writes G, D0, gmax and zeroes tmax.
// (2) swap_products_kernel: (tile, entry) blocks, so that a launch of a few
//     entries spreads over the card.  A T3 block owns 16 rows x 32 columns:
//     it gathers M_aug[rows, c0], G and M_aug[r0, columns] into shared
//     memory (the identity extension resolved at the gather), forms the 16
//     rows of P from them (the first column tile writes them), then its
//     T3 tile from those P rows; a T2 block owns 16 rows x 32 columns of
//     T2.  Each folds the largest |entry| it wrote into tmax by an integer
//     atomic max on the bits (non-negative doubles order as their bits).
// Every output entry is the first design's ascending multiply-add chain
// over the base index, and the Gauss-Jordan step its row / pivot, then a -
// fac * row, so the outputs keep the first design's bits in float64 (nvcc
// fuses a complex product's multiplies and adds otherwise in the new loops:
// complex128 differs in the last bits).  What still bounds it: the w serial
// steps of one entry's elimination on a single warp, about 1.3 us a step on
// an H100 (the pivot's shuffle arg-max, the shared-memory round trips of
// the pivot row and its division), and the products' two dependent global
// round trips (index rows, then M) a block.

#include "common.cuh"

namespace {

constexpr int kInvThreads = 128;  // threads of a register-tier inverse block
constexpr int kWideW = 64;        // widest base
constexpr int kWideLd = kWideW + 1;
constexpr int kTR = 16;           // rows of a product tile
constexpr int kTC = 32;           // columns of a product tile
constexpr int kProdThreads = 256;

// The largest v over segments of ``width`` lanes, in each of their lanes.
__device__ __forceinline__ double warp_max(double v, int width) {
    for (int d = width / 2; d > 0; d >>= 1) v = fmax(v, __shfl_xor_sync(kFullMask, v, d, width));
    return v;
}

// Entries e of a block: segment g = threadIdx.x / W, lane sl holds row sl.
template <typename T, int W>
__global__ void __launch_bounds__(kInvThreads)
    swap_inverse_kernel(const T* __restrict__ M, const int* __restrict__ r0,
                        const int* __restrict__ c0, T* __restrict__ D0, T* __restrict__ Gout,
                        double* __restrict__ gmax, double* __restrict__ tmax, int E, int m,
                        int w) {
    __shared__ T s_row[kInvThreads], s_pk[kInvThreads];  // W entries a segment
    __shared__ int s_orig[kInvThreads];
    const int g = threadIdx.x / W, sl = threadIdx.x % W;
    const int e = blockIdx.x * (kInvThreads / W) + g;
    const bool valid = e < E;
    const long long ee = valid ? e : E - 1;  // a copy of the last entry joins the shuffles
    const T* Me = M + ee * m * m;
    const T one = Num<T>::one(), zero = Num<T>::zero();
    const int r = sl < w ? r0[ee * w + sl] : 0;
    const int c = sl < w ? c0[ee * w + sl] : 0;
    T A[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int cj = seg_shfl<W>(c, j);
        A[j] = (sl < w && j < w) ? identity_ext(Me, m, r, cj) : (sl == j ? one : zero);
    }
    int pos = sl;
    const int* orig = s_orig + g * W;
    const T det =
        segment_gauss_jordan<T, W>(A, pos, w, s_row + g * W, s_pk + g * W, s_orig + g * W);
    double mx = 0.0;
    if (valid && sl < w) {
        T* Gr = Gout + ee * w * w + (long long)pos * w;
#pragma unroll
        for (int j = 0; j < W; ++j) {
            if (j >= w) break;
            Gr[orig[j]] = A[j];
            mx = fmax(mx, Num<T>::mag(A[j]));
        }
    }
    mx = warp_max(mx, W);
    if (valid && sl == 0) {
        D0[e] = det;
        gmax[e] = mx;
        tmax[e] = 0.0;
    }
}

// One warp an entry, 32 < w <= 64: A (w x w, row stride kWideLd), the
// scaled pivot row and the rows' original indices in shared memory.
template <typename T>
__global__ void __launch_bounds__(32)
    swap_inverse_wide_kernel(const T* __restrict__ M, const int* __restrict__ r0,
                             const int* __restrict__ c0, T* __restrict__ D0,
                             T* __restrict__ Gout, double* __restrict__ gmax,
                             double* __restrict__ tmax, int m, int w) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* A = reinterpret_cast<T*>(smem_raw);  // kWideW x kWideLd
    T* pk = A + kWideW * kWideLd;           // kWideW
    int* cs = reinterpret_cast<int*>(pk + kWideW);
    int* origrow = cs + kWideW;
    int* pivorig = origrow + kWideW;
    const int e = blockIdx.x, lane = threadIdx.x;
    const T* Me = M + (long long)e * m * m;
    const T one = Num<T>::one(), zero = Num<T>::zero();
    for (int t = lane; t < w; t += 32) {
        cs[t] = c0[(long long)e * w + t];
        origrow[t] = t;
    }
    __syncwarp();
    for (int i = lane; i < w; i += 32) {
        const int ri = r0[(long long)e * w + i];
        for (int j = 0; j < w; ++j) A[i * kWideLd + j] = identity_ext(Me, m, ri, cs[j]);
    }
    __syncwarp();
    T det = one;
    for (int k = 0; k < w; ++k) {
        double bv = -1.0;
        int p = 0x7fffffff;
        for (int i = k + lane; i < w; i += 32) {
            const double v = pivot_mag(A[i * kWideLd + k]);
            if (v > bv || (v == bv && i < p)) {
                bv = v;
                p = i;
            }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            const double v2 = __shfl_xor_sync(kFullMask, bv, d);
            const int p2 = __shfl_xor_sync(kFullMask, p, d);
            if (v2 > bv || (v2 == bv && p2 < p)) {
                bv = v2;
                p = p2;
            }
        }
        if (lane == 0) {
            const int o = origrow[p];
            pivorig[k] = o;
            origrow[p] = origrow[k];
            origrow[k] = o;
        }
        if (p != k) {
            for (int j = lane; j < w; j += 32) {
                const T tmp = A[k * kWideLd + j];
                A[k * kWideLd + j] = A[p * kWideLd + j];
                A[p * kWideLd + j] = tmp;
            }
            det = -det;
        }
        __syncwarp();
        const T piv = A[k * kWideLd + k];
        det = det * piv;
        const T safe = Num<T>::is_zero(piv) ? one : piv;
        for (int j = lane; j < w; j += 32) pk[j] = j == k ? one / safe : A[k * kWideLd + j] / safe;
        __syncwarp();
        for (int i = lane; i < w; i += 32) {
            T* ri = A + i * kWideLd;
            if (i == k) {
                for (int j = 0; j < w; ++j) ri[j] = pk[j];
            } else {
                const T f = ri[k];
                for (int j = 0; j < w; ++j) ri[j] = (j == k ? zero : ri[j]) - f * pk[j];
            }
        }
        __syncwarp();
    }
    double mx = 0.0;
    T* Ge = Gout + (long long)e * w * w;
    for (int i = lane; i < w; i += 32)
        for (int j = 0; j < w; ++j) {
            const T v = A[i * kWideLd + j];
            Ge[i * w + pivorig[j]] = v;
            mx = fmax(mx, Num<T>::mag(v));
        }
    mx = warp_max(mx, 32);
    if (lane == 0) {
        D0[e] = det;
        gmax[e] = mx;
        tmax[e] = 0.0;
    }
}

template <typename T>
__host__ __device__ constexpr int products_smem(int w) {
    return (int)sizeof(T) * (2 * kTR * w + w * w + w * kTC) + 2 * w * (int)sizeof(int);
}

__device__ __forceinline__ void fold_max(double* tmax, double mx) {
    __shared__ double s_mx[kProdThreads / 32];
    mx = warp_max(mx, 32);
    if ((threadIdx.x & 31) == 0) s_mx[threadIdx.x >> 5] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < kProdThreads / 32; ++i) mx = fmax(mx, s_mx[i]);
        if (mx > 0.0)
            atomicMax(reinterpret_cast<unsigned long long*>(tmax),
                      (unsigned long long)__double_as_longlong(mx));
    }
}

// Block (e, x): entry e = blockIdx.x (the grid's long axis), tile x =
// blockIdx.y: T3 tiles (row band, column tile) of n_row3 x n_col, then T2
// tiles of n_row2 x n_col.
template <typename T>
__global__ void __launch_bounds__(kProdThreads)
    swap_products_kernel(const T* __restrict__ M, const int* __restrict__ r0,
                         const int* __restrict__ c0, const T* __restrict__ Gin,
                         T* __restrict__ Pout, T* __restrict__ T2out, T* __restrict__ T3out,
                         double* __restrict__ tmax, int m, int w, int n_row3, int n_col) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int e = blockIdx.x, ma = m + w;
    int x = blockIdx.y;
    const bool t3 = x < n_row3 * n_col;
    if (!t3) x -= n_row3 * n_col;
    const int i0 = (x / n_col) * kTR, j0 = (x % n_col) * kTC;
    const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;  // 8 rows of 32 lanes
    constexpr int kRowStep = kProdThreads / 32;
    T* Mr = reinterpret_cast<T*>(smem_raw);  // w x kTC: M_aug[r0, j0 ..]
    T* Bs = Mr + w * kTC;                    // kTR x w: M_aug[i0 .., c0] (T3) or G[i0 .., :] (T2)
    T* Gs = Bs + kTR * w;                    // w x w (T3)
    T* Pb = Gs + w * w;                      // kTR x w: P[i0 .., :] (T3)
    int* rs = reinterpret_cast<int*>(Pb + kTR * w);
    int* cs = rs + w;
    const T* Me = M + (long long)e * m * m;
    const T* Ge = Gin + (long long)e * w * w;
    const T zero = Num<T>::zero();
    for (int t = tid; t < w; t += kProdThreads) {
        rs[t] = r0[(long long)e * w + t];
        cs[t] = c0[(long long)e * w + t];
    }
    __syncthreads();
    for (int u = row; u < w; u += kRowStep)
        Mr[u * kTC + lane] = j0 + lane < ma ? identity_ext(Me, m, rs[u], j0 + lane) : zero;
    if (t3) {
        for (int r = row; r < kTR; r += kRowStep)
            for (int s = lane; s < w; s += 32)
                Bs[r * w + s] = i0 + r < ma ? identity_ext(Me, m, i0 + r, cs[s]) : zero;
        for (int s = row; s < w; s += kRowStep)
            for (int t = lane; t < w; t += 32) Gs[s * w + t] = Ge[s * w + t];
    } else {
        for (int r = row; r < kTR; r += kRowStep)
            for (int u = lane; u < w; u += 32)
                Bs[r * w + u] = i0 + r < w ? Ge[(i0 + r) * w + u] : zero;
    }
    __syncthreads();
    double mx = 0.0;
    if (t3) {
        // P[i0 + r, t] = sum_s M_aug[i0 + r, c0[s]] G[s, t]
        T* Pe = Pout + (long long)e * ma * w;
        for (int r = row; r < kTR; r += kRowStep)
            for (int t = lane; t < w; t += 32) {
                T acc = zero;
#pragma unroll 4
                for (int s = 0; s < w; ++s) acc = acc + Bs[r * w + s] * Gs[s * w + t];
                Pb[r * w + t] = acc;
                if (j0 == 0 && i0 + r < ma) {
                    Pe[(long long)(i0 + r) * w + t] = acc;
                    mx = fmax(mx, Num<T>::mag(acc));
                }
            }
        __syncthreads();
        // T3[i0 + r, j0 + c] = sum_u P[i0 + r, u] M_aug[r0[u], j0 + c]
        T* T3e = T3out + (long long)e * ma * ma;
        for (int r = row; r < kTR; r += kRowStep) {
            if (i0 + r >= ma || j0 + lane >= ma) continue;
            T acc = zero;
#pragma unroll 4
            for (int u = 0; u < w; ++u) acc = acc + Pb[r * w + u] * Mr[u * kTC + lane];
            T3e[(long long)(i0 + r) * ma + j0 + lane] = acc;
            mx = fmax(mx, Num<T>::mag(acc));
        }
    } else {
        // T2[i0 + r, j0 + c] = sum_u G[i0 + r, u] M_aug[r0[u], j0 + c]
        T* T2e = T2out + (long long)e * w * ma;
        for (int r = row; r < kTR; r += kRowStep) {
            if (i0 + r >= w || j0 + lane >= ma) continue;
            T acc = zero;
#pragma unroll 4
            for (int u = 0; u < w; ++u) acc = acc + Bs[r * w + u] * Mr[u * kTC + lane];
            T2e[(long long)(i0 + r) * ma + j0 + lane] = acc;
            mx = fmax(mx, Num<T>::mag(acc));
        }
    }
    fold_max(tmax + e, mx);
}

template <typename T, int W>
void launch_inverse(const void* M, const int* r0, const int* c0, void* D0, void* G, double* gmax,
                    double* tmax, int E, int m, int w, cudaStream_t stream) {
    constexpr int per_block = kInvThreads / W;
    swap_inverse_kernel<T, W><<<(E + per_block - 1) / per_block, kInvThreads, 0, stream>>>(
        (const T*)M, r0, c0, (T*)D0, (T*)G, gmax, tmax, E, m, w);
}

template <typename T>
int launch(const void* M, const int* r0, const int* c0, void* D0, void* G, void* P, void* T2,
           void* T3, double* gmax, double* tmax, int E, int m, int w, cudaStream_t stream) {
    if (w <= 8) {
        launch_inverse<T, 8>(M, r0, c0, D0, G, gmax, tmax, E, m, w, stream);
    } else if (w <= 16) {
        launch_inverse<T, 16>(M, r0, c0, D0, G, gmax, tmax, E, m, w, stream);
    } else if (w <= 32) {
        launch_inverse<T, 32>(M, r0, c0, D0, G, gmax, tmax, E, m, w, stream);
    } else {
        const int smem = (int)sizeof(T) * kWideW * (kWideLd + 1) + 3 * kWideW * (int)sizeof(int);
        const cudaError_t err = launch_dynamic_smem<swap_inverse_wide_kernel<T>>(
            dim3(E), 32, smem, stream, (const T*)M, r0, c0, (T*)D0, (T*)G, gmax, tmax, m, w);
        if (err != cudaSuccess) return (int)err;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = allow_dynamic_smem<swap_products_kernel<T>>(products_smem<T>(kWideW));
    if (err != cudaSuccess) return (int)err;
    const int ma = m + w;
    const int n_col = (ma + kTC - 1) / kTC;
    const int n_row3 = (ma + kTR - 1) / kTR, n_row2 = (w + kTR - 1) / kTR;
    swap_products_kernel<T><<<dim3(E, (n_row3 + n_row2) * n_col), kProdThreads,
                              products_smem<T>(w), stream>>>(
        (const T*)M, r0, c0, (const T*)G, (T*)P, (T*)T2, (T*)T3, tmax, m, w, n_row3, n_col);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_swap_tables(int dtype, const void* M, const int* r0, const int* c0, void* D0,
                              void* G, void* P, void* T2, void* T3, double* gmax,
                              double* tmax, int E, int m, int w, void* stream) {
    if (E == 0) return (int)cudaSuccess;
    if (w < 1 || w > kWideW) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == TF_F64) return launch<double>(M, r0, c0, D0, G, P, T2, T3, gmax, tmax, E, m, w, s);
    if (dtype == TF_C128) return launch<c128>(M, r0, c0, D0, G, P, T2, T3, gmax, tmax, E, m, w, s);
    return (int)cudaErrorInvalidValue;
}

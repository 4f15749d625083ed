// Scalar helpers shared by the temfpy_torch kernels: one template
// parameter T is either double or c128 (complex double laid out as
// torch.complex128: real then imaginary part).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct __align__(16) c128 {
    double re, im;
};

__host__ __device__ __forceinline__ c128 operator+(c128 a, c128 b) {
    return c128{a.re + b.re, a.im + b.im};
}
__host__ __device__ __forceinline__ c128 operator-(c128 a, c128 b) {
    return c128{a.re - b.re, a.im - b.im};
}
__host__ __device__ __forceinline__ c128 operator-(c128 a) {
    return c128{-a.re, -a.im};
}
__host__ __device__ __forceinline__ c128 operator*(c128 a, c128 b) {
    return c128{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__host__ __device__ __forceinline__ c128 operator*(c128 a, double s) {
    return c128{a.re * s, a.im * s};
}
__host__ __device__ __forceinline__ c128 operator/(c128 a, c128 b) {
    // Smith's algorithm: no overflow for large |b|
    if (fabs(b.re) >= fabs(b.im)) {
        double r = b.im / b.re, d = b.re + b.im * r;
        return c128{(a.re + a.im * r) / d, (a.im - a.re * r) / d};
    }
    double r = b.re / b.im, d = b.re * r + b.im;
    return c128{(a.re * r + a.im) / d, (a.im * r - a.re) / d};
}

template <typename T>
struct Num;

template <>
struct Num<double> {
    __host__ __device__ static double zero() { return 0.0; }
    __host__ __device__ static double one() { return 1.0; }
    __host__ __device__ static double conj(double x) { return x; }
    __host__ __device__ static double mag(double x) { return fabs(x); }
    __host__ __device__ static bool is_zero(double x) { return x == 0.0; }
};

template <>
struct Num<c128> {
    __host__ __device__ static c128 zero() { return c128{0.0, 0.0}; }
    __host__ __device__ static c128 one() { return c128{1.0, 0.0}; }
    __host__ __device__ static c128 conj(c128 x) { return c128{x.re, -x.im}; }
    __host__ __device__ static double mag(c128 x) { return hypot(x.re, x.im); }
    __host__ __device__ static bool is_zero(c128 x) { return x.re == 0.0 && x.im == 0.0; }
};

// dtype codes passed from Python
enum { TF_F64 = 0, TF_C128 = 1 };

// Block-wide pivot choice: every thread offers (v, i) (v < 0 for none); the
// largest v wins and ties go to the smallest i, so a pivot search whose
// threads scan rows in increasing order picks the FIRST maximal row, the
// rule of temfpy_tpu/ops/linalg.py.  Needs blockDim.x a multiple of 32 and
// at most 1024; all threads must call it.  Returns the winning i.
__device__ __forceinline__ int block_argmax_first(double v, int i) {
    __shared__ double s_v[32];
    __shared__ int s_i[32];
    __shared__ int s_win;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int d = 16; d > 0; d >>= 1) {
        const double v2 = __shfl_down_sync(0xffffffffu, v, d);
        const int i2 = __shfl_down_sync(0xffffffffu, i, d);
        if (v2 > v || (v2 == v && i2 < i)) {
            v = v2;
            i = i2;
        }
    }
    if (lane == 0) {
        s_v[warp] = v;
        s_i[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double bv = s_v[0];
        int bi = s_i[0];
        for (int w = 1; w < (int)(blockDim.x / 32); ++w)
            if (s_v[w] > bv || (s_v[w] == bv && s_i[w] < bi)) {
                bv = s_v[w];
                bi = s_i[w];
            }
        s_win = bi;
    }
    __syncthreads();
    return s_win;
}

// Determinant of the w x w matrix A (row stride W, w <= W) held by ONE
// thread, by LU with partial pivoting: the first row of maximal |A[i, k]|
// (i >= k) is the pivot, as in temfpy_tpu/ops/linalg.py:_lu_det_body; a
// zero pivot makes the determinant 0 without dividing by it.  A is
// overwritten.  Used by det_fill, det_rows and swap_fill.
template <typename T, int W>
__device__ __forceinline__ T lu_det_private(T* A, int w) {
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
    return det;
}

// Pfaffian of the tot x tot skew-symmetric matrix A (row stride W, tot even,
// tot <= W <= 32) in shared memory, computed by ONE warp (all 32 lanes call
// it; u is a W-entry shared scratch row): Parlett-Reid with partial
// pivoting, as temfpy_tpu/ops/pfaffian.py:_pfaffian_single.  At step k (even)
// the largest |A[j, k]|, j > k (first on ties), is swapped into row and
// column k+1 (sign flip), the Pfaffian is multiplied by A[k, k+1], and the
// trailing block takes the rank-2 skew update
//   A[i, j] += u[i] A[j, k+1] - A[i, k+1] u[j],  u = A[k, :] / A[k, k+1].
// A zero pivot makes the Pfaffian 0.  A is overwritten; every lane returns
// the same value.  Used by pf_fill and pf_gather.
template <typename T, int W>
__device__ __forceinline__ T warp_parlett_reid(T* A, T* u, int tot, int lane) {
    constexpr unsigned full = 0xffffffffu;
    T pf = Num<T>::one();
    for (int k = 0; k < tot; k += 2) {
        const int j = k + 1 + lane;
        double best = (j < tot) ? Num<T>::mag(A[j * W + k]) : -1.0;
        int bj = j;
        for (int off = 16; off > 0; off >>= 1) {
            const double v2 = __shfl_down_sync(full, best, off);
            const int j2 = __shfl_down_sync(full, bj, off);
            if (v2 > best || (v2 == best && j2 < bj)) {
                best = v2;
                bj = j2;
            }
        }
        const int kp = __shfl_sync(full, bj, 0);
        if (kp != k + 1) {
            for (int t = lane; t < tot; t += 32) {
                const T tmp = A[(k + 1) * W + t];
                A[(k + 1) * W + t] = A[kp * W + t];
                A[kp * W + t] = tmp;
            }
            __syncwarp();
            for (int t = lane; t < tot; t += 32) {
                const T tmp = A[t * W + k + 1];
                A[t * W + k + 1] = A[t * W + kp];
                A[t * W + kp] = tmp;
            }
            __syncwarp();
            pf = -pf;
        }
        const T akk1 = A[k * W + k + 1];
        pf = pf * akk1;
        if (Num<T>::is_zero(akk1)) break;  // the same value in every lane
        const int n = tot - k - 2;
        for (int i = k + 2 + lane; i < tot; i += 32) u[i] = A[k * W + i] / akk1;
        __syncwarp();
        for (int e = lane; e < n * n; e += 32) {
            const int i = k + 2 + e / n, jj = k + 2 + e % n;
            A[i * W + jj] = A[i * W + jj] + (u[i] * A[jj * W + k + 1] - A[i * W + k + 1] * u[jj]);
        }
        __syncwarp();
    }
    return pf;
}

// Entry (a, b) of M_aug = diag(M, I) for an m x m row-major M: indices >= m
// are sentinels of the identity extension, never formed.
template <typename T>
__device__ __forceinline__ T identity_ext(const T* M, int m, int a, int b) {
    if (a < m && b < m) return M[(long long)a * m + b];
    return (a == b) ? Num<T>::one() : Num<T>::zero();
}

// ---- the randomized spectral frontend (rsf_*.cu) ----

// Rows [lo, hi) of cut i's block: the leading s rows (side L) or the
// trailing s rows (side R) of an L-row operand; the complement is the rest.
__device__ __forceinline__ void rsf_block_rows(int L, int s, int right, int* lo, int* hi) {
    *lo = right ? L - s : 0;
    *hi = right ? L : s;
}

// A 64 x 64 float64 output tile of a product, 256 threads as 16 x 16:
// thread (ty, tx) = (tid / 16, tid % 16) keeps the sums of tile rows
// ty + 16 i and tile columns tx + 16 j (i, j < 4) in acc.  The depth k runs
// over [k_begin, k_end) in steps of 16 through shared memory.  A holds the
// tile's rows, row-major (element (r, k) at A[r * lda + k]) or depth-major
// (at A[k * lda + r]); B is depth-major (element (k, c) at B[k * ldb + c]).
// Rows r >= a_rows and columns c >= b_cols read as zero.  Every thread of
// the block calls it (it synchronises); CUDA-core FMAs, no tensor cores.
constexpr int kTile = 64;
constexpr int kTileDepth = 16;
constexpr int kTileThreads = 256;

struct TileSmem {
    double A[kTile][kTileDepth + 1];
    double B[kTileDepth][kTile];
};

template <bool A_DEPTH_MAJOR>
__device__ __forceinline__ void tile_accumulate(double (&acc)[4][4], const double* __restrict__ A,
                                                long long lda, int a_rows,
                                                const double* __restrict__ B, long long ldb,
                                                int b_cols, int k_begin, int k_end,
                                                TileSmem& s) {
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    for (int k0 = k_begin; k0 < k_end; k0 += kTileDepth) {
        for (int e = tid; e < kTile * kTileDepth; e += kTileThreads) {
            // consecutive threads read consecutive addresses of A
            const int r = A_DEPTH_MAJOR ? e % kTile : e / kTileDepth;
            const int kk = A_DEPTH_MAJOR ? e / kTile : e % kTileDepth;
            const int k = k0 + kk;
            double v = 0.0;
            if (k < k_end && r < a_rows)
                v = A_DEPTH_MAJOR ? A[(long long)k * lda + r] : A[(long long)r * lda + k];
            s.A[r][kk] = v;
        }
        for (int e = tid; e < kTileDepth * kTile; e += kTileThreads) {
            const int kk = e / kTile, c = e % kTile, k = k0 + kk;
            s.B[kk][c] = (k < k_end && c < b_cols) ? B[(long long)k * ldb + c] : 0.0;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTileDepth; ++kk) {
            double a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = s.A[ty + 16 * i][kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = s.B[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void tile_zero(double (&acc)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
}

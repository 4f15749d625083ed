// Scalar helpers shared by the temfpy_torch kernels: one template
// parameter T is either double or c128 (complex double laid out as
// torch.complex128: real then imaginary part).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

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

// ---- register-resident small LUs, inverses and Pfaffians (det_fill.cu,
// swap_fill.cu, det_rows.cu, swap_tables.cu, pf_fill.cu, pf_gather.cu) ----

constexpr unsigned kFullMask = 0xffffffffu;

// Lanes of the segment that holds one W x W matrix in registers (kernels.
// det_fill_geometry, swap_fill_geometry, det_rows_geometry and
// pf_fill_geometry mirror it): each lane holds
// W / lanes rows, at most 64 float64 values (128 registers).  float64: one
// thread up to W = 8, 8 lanes at 16, 32 at 32; complex128 halves the rows a
// lane holds.
template <typename T, int W>
__host__ __device__ constexpr int segment_lanes() {
    if (std::is_same<T, double>::value) return W <= 8 ? 1 : (W == 16 ? 8 : 32);
    return W <= 4 ? 1 : (W == 8 ? 2 : (W == 16 ? 8 : 32));
}

// __shfl_sync within segments of S lanes (S = 1: the value itself).
template <int S>
__device__ __forceinline__ int seg_shfl(int v, int src) {
    if constexpr (S == 1) return v;
    return __shfl_sync(kFullMask, v, src, S);
}
template <int S>
__device__ __forceinline__ double seg_shfl(double v, int src) {
    if constexpr (S == 1) return v;
    return __shfl_sync(kFullMask, v, src, S);
}
template <int S>
__device__ __forceinline__ c128 seg_shfl(c128 v, int src) {
    if constexpr (S == 1) return v;
    return c128{__shfl_sync(kFullMask, v.re, src, S), __shfl_sync(kFullMask, v.im, src, S)};
}

template <typename T>
__device__ __forceinline__ double pivot_mag(T a) {
    const double v = Num<T>::mag(a);
    return v == v ? v : -0.5;  // NaN: loses to any number, beats "no candidate"
}

// Determinant of the W x W matrix A held in registers by a segment of S
// lanes (the lanes of ``segmask`` in their warp, segment ``seg``): a lane
// holds rows pos[q] = sl + S q in A[q] (sl: its lane in the segment; the
// caller sets pos, which the LU overwrites).  LU with partial pivoting, the rule of
// temfpy_tpu/ops/linalg.py:_lu_det_body: the pivot of step k is the first
// (in logical order) maximal |A[i, k]|, i >= k, found by a segmented
// shuffle arg-max; rows never move (each keeps its logical position, which
// a pivot swap exchanges), the pivot row is selected and broadcast by
// shuffles, and the elimination is A[i, j] -= (A[i, k] / pivot) A[k, j],
// the arithmetic of a physical-swap LU operation for operation; a zero
// pivot gives det 0 without a division.  Every register index is a
// constant.  Only the first ``steps`` steps run (the same number in every
// lane of the warp): rows and columns past them must be identity padding,
// whose steps would multiply by exact ones.  Every lane of the warp calls
// it (segments in lockstep); A is overwritten; every lane of a segment
// returns the determinant.
template <typename T, int W, int S>
__device__ __forceinline__ T segment_lu_det(T (&A)[W / S][W], int (&pos)[W / S], int seg,
                                            unsigned segmask, int steps = W) {
    constexpr int ROWS = W / S;
    const T one = Num<T>::one();
    T det = one;
#pragma unroll
    for (int k = 0; k < W; ++k) {
        if (k >= steps) break;
        // pivot: the first (in logical order) maximal |A[i, k]|, i >= k
        double bv = -1.0;
        int bp = 0x7fffffff;
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            const double v = pivot_mag(A[q][k]);
            if (pos[q] >= k && (v > bv || (v == bv && pos[q] < bp))) {
                bv = v;
                bp = pos[q];
            }
        }
#pragma unroll
        for (int d = S / 2; d > 0; d >>= 1) {
            const double v2 = __shfl_xor_sync(kFullMask, bv, d, S);
            const int p2 = __shfl_xor_sync(kFullMask, bp, d, S);
            if (v2 > bv || (v2 == bv && p2 < bp)) {
                bv = v2;
                bp = p2;
            }
        }
        int mine = -1;
#pragma unroll
        for (int q = 0; q < ROWS; ++q)
            if (pos[q] == bp) mine = q;
        int src = 0, h = mine;  // the pivot's lane, and its row there
        if constexpr (S > 1) {
            src = __ffs(__ballot_sync(kFullMask, mine >= 0) & segmask) - 1 - seg * S;
            h = ROWS > 1 ? seg_shfl<S>(mine, src) : 0;
        }
        T hk = A[0][k];
#pragma unroll
        for (int q = 1; q < ROWS; ++q)
            if (h == q) hk = A[q][k];
        const T piv = seg_shfl<S>(hk, src);
        if (bp != k) det = -det;
        det = det * piv;
        const T safe = Num<T>::is_zero(piv) ? one : piv;
        T f[ROWS];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            pos[q] = pos[q] == k ? bp : (pos[q] == bp ? k : pos[q]);
            f[q] = A[q][k] / safe;
        }
#pragma unroll
        for (int j = k + 1; j < W; ++j) {
            T hj = A[0][j];
#pragma unroll
            for (int q = 1; q < ROWS; ++q)
                if (h == q) hj = A[q][j];
            const T pj = seg_shfl<S>(hj, src);
#pragma unroll
            for (int q = 0; q < ROWS; ++q)
                if (pos[q] > k) A[q][j] = A[q][j] - f[q] * pj;
        }
    }
    return det;
}

// a[i] for a runtime i < N, with constant register indices
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
    T v = a[0];
#pragma unroll
    for (int q = 1; q < N; ++q)
        if (i == q) v = a[q];
    return v;
}

// a[i] for a runtime i < N (N a power of two), with constant register
// indices, by a tree of selects: log2(N) selects deep, not N - 1.
template <int N, typename T>
__device__ __forceinline__ T pick_tree(const T (&a)[N], int i) {
    static_assert((N & (N - 1)) == 0, "N a power of two");
    T v[N];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = a[q];
#pragma unroll
    for (int s = 1; s < N; s <<= 1)
#pragma unroll
        for (int q = 0; q + s < N; q += 2 * s) v[q] = (i & s) ? v[q + s] : v[q];
    return v[0];
}

// Determinant and inverse, in place, of the W x W matrix A held one row a
// lane by a segment of W lanes (W <= 32 a power of two; segment lane / W of
// its warp): lane sl holds row sl (its original index) in A, at logical
// position pos (sl at the start; the caller sets it).  Gauss-Jordan with
// partial pivoting, the rule and arithmetic of
// temfpy_tpu/ops/linalg.py:gauss_solve_det: the pivot of step k is the first
// (in logical order) maximal |A[i, k]|, i >= k, found by a segmented shuffle
// arg-max; the pivot row, published in the segment's shared ``rowbuf`` (W
// entries), is divided by the pivot one column a lane into ``pk`` (W
// entries; a zero pivot divides by 1 and gives det 0), and every other row
// takes a - fac * pk[j].  Rows never move: a pivot swap exchanges two
// logical positions.  It is the in-place inversion of cluster_gauss_jordan's
// INVERT mode carried to a segment: the identity half of [A | I] is never
// stored; at step k the dead column k takes the inverse's column of the
// pivot row's original index, orig[k] (the pivot lane, kept in the
// segment's shared ``orig``, W entries), with the operations [A | I] would
// give it (1 / pivot in the pivot row, 0 - fac (1 / pivot) in the others),
// so on return A^{-1}[pos, orig[j]] = A[j].  Only the first ``steps`` rows
// and columns take part (the same in every lane of the warp): the rest must
// be identity padding, which no step reads.  The padding columns keep pk =
// 0, so every step updates all W columns without a branch (a branch a
// column kept the loads of pk from running ahead), and the padding stays
// exact.  The step loop is not unrolled (column k is picked by pick_tree):
// one copy of the step's code.  Every lane of the warp calls it; every lane
// returns det A.
template <typename T, int W>
__device__ __forceinline__ T segment_gauss_jordan(T (&A)[W], int& pos, int steps, T* rowbuf,
                                                  T* pk, int* orig) {
    static_assert(W <= 32, "one row a lane");
    const int lane = threadIdx.x & 31, sl = lane % W, seg = lane / W;
    const unsigned segmask = W == 32 ? kFullMask : (((1u << W) - 1u) << (seg * W));
    const T one = Num<T>::one(), zero = Num<T>::zero();
    pk[sl] = zero;
    __syncwarp();
    T det = one;
#pragma unroll 1
    for (int k = 0; k < steps; ++k) {
        const T fac = pick_tree(A, k);
        const bool cand = pos >= k && pos < steps;
        double bv = cand ? pivot_mag(fac) : -1.0;
        int bp = cand ? pos : 0x7fffffff;
#pragma unroll
        for (int d = W / 2; d > 0; d >>= 1) {
            const double v2 = __shfl_xor_sync(kFullMask, bv, d, W);
            const int p2 = __shfl_xor_sync(kFullMask, bp, d, W);
            if (v2 > bv || (v2 == bv && p2 < bp)) {
                bv = v2;
                bp = p2;
            }
        }
        const int src = __ffs(__ballot_sync(kFullMask, pos == bp) & segmask) - 1 - seg * W;
        const T piv = seg_shfl<W>(fac, src);
        det = ((bp != k) ? -det : det) * piv;
        const T safe = Num<T>::is_zero(piv) ? one : piv;
        const bool is_piv = sl == src;
        if (is_piv) {
            orig[k] = src;
#pragma unroll
            for (int j = 0; j < W; ++j) rowbuf[j] = A[j];
        }
        __syncwarp();
        if (sl < steps) pk[sl] = sl == k ? one / safe : rowbuf[sl] / safe;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < W; ++j) {
            const T pj = pk[j];
            A[j] = is_piv ? pj : (j == k ? zero : A[j]) - fac * pj;
        }
        pos = pos == k ? bp : (pos == bp ? k : pos);
    }
    __syncwarp();  // orig is complete
    return det;
}

// Pfaffian of the W x W skew-symmetric matrix A (W even) held in registers
// by a segment of S lanes, laid out as in segment_lu_det: lane sl of the
// segment holds in A[q] the row whose logical position is pos[q] (sl + S q
// at the start; the caller sets pos).  Parlett-Reid with partial pivoting,
// the rule of temfpy_tpu/ops/pfaffian.py:_pfaffian_single: at step k (even)
// the first (in logical order) maximal |A[j, k]|, j > k, found by a
// segmented shuffle arg-max, is swapped into row and column k+1 (sign
// flip), the Pfaffian is multiplied by A[k, k+1], and the trailing block
// takes the rank-2 skew update
//   A[i, j] += u[i] A[j, k+1] - A[i, k+1] u[j],  u[i] = A[k, i] / A[k, k+1],
// in the products and sums of warp_parlett_reid.  Rows never move: a pivot
// swap exchanges two logical positions, and the column half of the swap is
// a select over constant indices inside each lane's rows.  Each lane keeps
// ``holder``: for each logical row j, the slot S q + sl that holds it, so
// the column entries the update needs come from their rows' lanes by
// shuffles: A[j, k+1] as stored, and u[j] = -A[j, k] / A[k, k+1] (skew
// symmetry: row k itself is never read), divided once, by the lane that
// holds row j.  A zero pivot makes the Pfaffian 0 (later steps divide by 1
// and leave it so).  Only the first ``steps`` rows, columns and steps take
// part (even, the same in every lane of the warp): the rest must be J =
// [[0, 1], [-1, 0]] blocks, which no step reads (a real column's pivot is a
// real row, and a J step's is its J partner) and whose own steps would
// multiply by exact ones.  Every lane of the warp calls it; A is
// overwritten; every lane of a segment returns the Pfaffian.
template <typename T, int W, int S>
__device__ __forceinline__ T segment_parlett_reid(T (&A)[W / S][W], int (&pos)[W / S],
                                                  int steps) {
    constexpr int ROWS = W / S;
    const T one = Num<T>::one();
    int holder[W];
#pragma unroll
    for (int j = 0; j < W; ++j) holder[j] = j;
    T pf = one;
    bool zero = false;
#pragma unroll
    for (int k = 0; k < W; k += 2) {
        if (k >= steps) break;
        // pivot: the first (in logical order) maximal |A[j, k]|, j > k
        double bv = -1.0;
        int bp = 0x7fffffff;
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            const double v = pivot_mag(A[q][k]);
            if (S * q < steps && pos[q] > k && (v > bv || (v == bv && pos[q] < bp))) {
                bv = v;
                bp = pos[q];
            }
        }
#pragma unroll
        for (int d = S / 2; d > 0; d >>= 1) {
            const double v2 = __shfl_xor_sync(kFullMask, bv, d, S);
            const int p2 = __shfl_xor_sync(kFullMask, bp, d, S);
            if (v2 > bv || (v2 == bv && p2 < bp)) {
                bv = v2;
                bp = p2;
            }
        }
        const int kp = bp;
        if (kp != k + 1) {  // the same in every lane of the segment; kp < steps
            int hk1 = holder[k + 1], hkp = hk1;
#pragma unroll
            for (int j = k + 2; j < W; ++j)
                if (j < steps && j == kp) hkp = holder[j];
#pragma unroll
            for (int j = k + 2; j < W; ++j)
                if (j < steps && j == kp) holder[j] = hk1;
            holder[k + 1] = hkp;
#pragma unroll
            for (int q = 0; q < ROWS; ++q) {
                if (S * q >= steps) break;
                pos[q] = pos[q] == k + 1 ? kp : (pos[q] == kp ? k + 1 : pos[q]);
                const T a1 = A[q][k + 1];
                T ap = a1;
#pragma unroll
                for (int j = k + 2; j < W; ++j)
                    if (j < steps && j == kp) ap = A[q][j];
#pragma unroll
                for (int j = k + 2; j < W; ++j)
                    if (j < steps && j == kp) A[q][j] = a1;
                A[q][k + 1] = ap;
            }
            if (!zero) pf = -pf;
        }
        // A[k, k+1] from the lane that holds row k
        T row_k[ROWS];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) row_k[q] = A[q][k + 1];
        const int hk = holder[k];
        const T akk1 = seg_shfl<S>(pick(row_k, hk / S), hk % S);
        if (!zero) pf = pf * akk1;
        zero = zero || Num<T>::is_zero(akk1);
        const T safe = Num<T>::is_zero(akk1) ? one : akk1;
        T u[ROWS], c[ROWS];  // u[i] and A[i, k+1] of the lane's rows
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            c[q] = A[q][k + 1];
            u[q] = S * q < steps ? -A[q][k] / safe : c[q];  // rows past steps: never read
        }
#pragma unroll
        for (int j = k + 2; j < W; ++j) {
            if (j >= steps) break;
            const int hj = holder[j];
            const T uj = seg_shfl<S>(pick(u, hj / S), hj % S);
            const T cj = seg_shfl<S>(pick(c, hj / S), hj % S);
#pragma unroll
            for (int q = 0; q < ROWS; ++q)
                if (S * q < steps && pos[q] > k + 1) A[q][j] = A[q][j] + (u[q] * cj - c[q] * uj);
        }
    }
    return pf;
}

// Determinant of the W x W matrix A (row stride LD) in shared memory,
// computed by ONE warp (all 32 lanes call it): LU with partial pivoting, the
// first maximal |A[i, k]|, i >= k, as the pivot (the rule of
// temfpy_tpu/ops/linalg.py:_lu_det_body, by a warp shuffle arg-max), the
// pivot row swapped into place, and each lane eliminating rows k+1+lane,
// k+33+lane, ...: A[i, j] -= (A[i, k] / pivot) A[k, j], segment_lu_det's
// arithmetic; a zero pivot gives det 0 without a division.  Only the first
// ``steps`` steps run (identity padding past them).  A is overwritten;
// every lane returns the determinant.  The wide (W = 64) paths of det_fill
// and det_rows, whose matrix would take a warp's whole register file.
template <typename T, int W, int LD>
__device__ __forceinline__ T warp_lu_det(T* A, int lane, int steps = W) {
    const T one = Num<T>::one();
    T det = one;
    for (int k = 0; k < steps; ++k) {
        double bv = -1.0;
        int bp = 0x7fffffff;
        for (int i = k + lane; i < W; i += 32) {
            const double v = pivot_mag(A[i * LD + k]);
            if (v > bv || (v == bv && i < bp)) {
                bv = v;
                bp = i;
            }
        }
        for (int d = 16; d > 0; d >>= 1) {
            const double v2 = __shfl_xor_sync(kFullMask, bv, d);
            const int p2 = __shfl_xor_sync(kFullMask, bp, d);
            if (v2 > bv || (v2 == bv && p2 < bp)) {
                bv = v2;
                bp = p2;
            }
        }
        if (bp != k) {
            for (int j = k + lane; j < W; j += 32) {
                const T tmp = A[k * LD + j];
                A[k * LD + j] = A[bp * LD + j];
                A[bp * LD + j] = tmp;
            }
            det = -det;
            __syncwarp();
        }
        const T piv = A[k * LD + k];
        det = det * piv;
        const T safe = Num<T>::is_zero(piv) ? one : piv;
        for (int i = k + 1 + lane; i < W; i += 32) {
            const T f = A[i * LD + k] / safe;
            for (int j = k + 1; j < W; ++j) A[i * LD + j] = A[i * LD + j] - f * A[k * LD + j];
        }
        __syncwarp();
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
// the same value.  Used by pf_fill's pairs of 16 < tot <= 32 (narrower
// pairs keep their rows in registers: segment_parlett_reid).
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

// ---- Gauss-Jordan with the rows in registers over a thread-block cluster
// (site_overlap_schur.cu: K2's [A | B]; bdg_overlap.cu: K4's [U* | I]) ----

constexpr int kGJThreads = 512;
constexpr int kGJWarps = kGJThreads / 32;
constexpr int kNone = 0x7fffffff;

// Rows a warp holds (row w + 16 a of its block, a < RA) when a lane holds
// columns l + 32 b (b < CB): at most 36 float64 values a thread, so that
// the 128 registers of a 512-thread block hold them with the loop's own
// (kernels.schur_layout mirrors it).
template <typename T, int CB>
__host__ __device__ constexpr int gj_rows_per_warp() {
    return std::is_same<T, double>::value
               ? (CB <= 2 ? 8 : CB <= 4 ? 6 : CB <= 9 ? 4 : CB <= 12 ? 3 : 2)
               : (CB <= 2 ? 4 : CB <= 4 ? 3 : CB <= 9 ? 2 : 1);
}

struct Cand {
    double v;  // |pivot candidate|; -1 for none, -0.5 for NaN (loses to any number)
    int pos;   // logical row
    int who;   // (block rank << 16) | local row
};

__device__ __forceinline__ void cand_take(Cand& b, double v, int pos, int who) {
    if (v > b.v || (v == b.v && pos < b.pos)) b = Cand{v, pos, who};
}

// Butterfly arg-max over the warp: every lane ends with the best.
__device__ __forceinline__ void warp_cand(Cand& b) {
    for (int d = 16; d > 0; d >>= 1)
        cand_take(b, __shfl_xor_sync(0xffffffffu, b.v, d),
                  __shfl_xor_sync(0xffffffffu, b.pos, d),
                  __shfl_xor_sync(0xffffffffu, b.who, d));
}

__device__ __forceinline__ double shfl_val(double v, int src) {
    return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ c128 shfl_val(c128 v, int src) {
    return c128{__shfl_sync(0xffffffffu, v.re, src), __shfl_sync(0xffffffffu, v.im, src)};
}

// Gauss-Jordan with partial pivoting on the kb rows of a kb x mb matrix
// [A | B] held in registers by a cluster of 512-thread blocks (a cluster of
// one: a plain block): block q's warp w holds its rows w + 16 a (a < RA) in
// R[a], a lane the columns l + 32 b (b < CB) of each; posr[a] is the row's
// logical position (kNone: no row there).  A step: each warp's candidate
// for column k (from the lane holding it), the block's best by a block
// barrier, whose warp publishes that row in shared memory (cand_row, 2 mb
// entries by step parity) before the cluster barrier, so that one barrier a
// step serves the whole cluster; every block then reads the winner's
// published row (local or distributed shared memory), scales it into pk
// (mb entries) and updates its own rows.  Rows never move: a pivot swap
// exchanges two logical positions.  The pivot is the first maximal |a| of
// column k in logical order; a zero pivot leaves its row unscaled; the
// arithmetic is temfpy_tpu/ops/linalg.py:gauss_solve_det's with physical
// swaps, operation for operation.  On return the columns past k of each
// row hold A^{-1} B at the row's logical position (column k <= kb - 1 of
// step k is left as it was); every thread returns det A.
//
// INVERT (mb = kb = n, no B): the in-place inversion of A, the elimination
// of [A | I] with the identity half never stored: at step k the dead
// column k takes the inverse's column of the pivot row's original index
// (its identity column, exact zeros but the pivot row's 1 until that
// step), whose block-local row id (block rank << 16 | local row) goes to
// piv_who[k] in each block's shared memory.  Its entries get the
// operations [A | I] would give them (1 / pivot for the pivot row, 0 - a_k
// (1 / pivot) for the others), so A^{-1}[posr, orig(piv_who[j])] = R[., j]
// on return.  Every thread of every block of the cluster calls it.
template <typename T, int CB, int RA, bool INVERT = false>
__device__ __forceinline__ T cluster_gauss_jordan(T (&R)[RA][CB], int (&posr)[RA], int kb,
                                                  int mb, T* cand_row, T* pk,
                                                  int* piv_who = nullptr) {
    namespace cg = cooperative_groups;
    __shared__ Cand s_red[2][kGJWarps];  // each warp's candidate, by parity
    __shared__ Cand s_slot[2];           // the block's candidate, read by the cluster
    cg::cluster_group cluster = cg::this_cluster();
    const int nc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const T one = Num<T>::one(), zero = Num<T>::zero();
    const Cand none{-1.0, kNone, 0};
    T det = one;  // the same in every thread
#pragma unroll
    for (int bk = 0; bk < CB; ++bk) {  // columns 32 bk .. 32 bk + 31: lane kk holds column k
        for (int kk = 0; kk < 32; ++kk) {
            const int k = 32 * bk + kk;
            if (k >= kb) break;  // uniform
            const int par = k & 1;
            Cand best = none;  // column k of this warp's rows at or past step k
            if (lane == kk)
#pragma unroll
                for (int a = 0; a < RA; ++a)
                    if (posr[a] != kNone && posr[a] >= k)
                        cand_take(best, pivot_mag(R[a][bk]), posr[a],
                                  (q << 16) | (warp + kGJWarps * a));
            warp_cand(best);
            if (lane == 0) s_red[par][warp] = best;
            __syncthreads();
            Cand mine = lane < kGJWarps ? s_red[par][lane] : none;
            warp_cand(mine);  // the block's best, in every lane of every warp
            const int li = mine.who & 0xffff;
            if (mine.pos != kNone && warp == li % kGJWarps) {  // publish it (columns k on)
                const int ab = li / kGJWarps;
#pragma unroll
                for (int b = INVERT ? 0 : bk; b < CB; ++b) {
                    T v = R[0][b];
#pragma unroll
                    for (int a = 1; a < RA; ++a)
                        if (a == ab) v = R[a][b];
                    const int j = lane + 32 * b;
                    if ((INVERT || j >= k) && j < mb) cand_row[par * mb + j] = v;
                }
            }
            Cand win = mine;
            if (nc > 1) {
                if (tid == 0) s_slot[par] = mine;
                cluster.sync();  // every block's candidate and row are out
                win = lane < nc ? *cluster.map_shared_rank(&s_slot[par], lane) : none;
                warp_cand(win);
            } else {
                __syncthreads();
            }
            const int qo = win.who >> 16, lo = win.who & 0xffff, p = win.pos;
            if (INVERT && tid == 0) piv_who[k] = win.who;
            const T* prem =
                (qo == q ? cand_row : cluster.map_shared_rank(cand_row, qo)) + par * mb;
            const T piv = prem[k];
            const T safe = Num<T>::is_zero(piv) ? one : piv;
            for (int j = (INVERT ? 0 : k + 1) + tid; j < mb; j += kGJThreads)
                pk[j] = (INVERT && j == k) ? one / safe : prem[j] / safe;
            det = ((p != k) ? -det : det) * piv;
            __syncthreads();
            // every other row: A[i, j] -= A[i, k] pk[j] for j > k; the pivot
            // row becomes pk (column k is never read again; INVERT: it takes
            // the new inverse column, every column updated)
            T fac[RA];
#pragma unroll
            for (int a = 0; a < RA; ++a) {
                fac[a] = shfl_val(R[a][bk], kk);
                posr[a] = posr[a] == k ? p : (posr[a] == p ? k : posr[a]);
            }
            const int pivot_a = (qo == q && warp == lo % kGJWarps) ? lo / kGJWarps : -1;
#pragma unroll
            for (int b = INVERT ? 0 : bk; b < CB; ++b) {
                const int j = lane + 32 * b;
                if (INVERT ? j < mb : (j > k && j < mb)) {
                    const T pj = pk[j];
                    const bool col_k = INVERT && j == k;
#pragma unroll
                    for (int a = 0; a < RA; ++a)
                        R[a][b] = a == pivot_a ? pj : (col_k ? zero : R[a][b]) - fac[a] * pj;
                }
            }
        }
    }
    return det;
}

// The same elimination with [A | B] (kb x mb, row stride mb) left in global
// memory at O, one 512-thread block, for a matrix no cluster holds in
// registers: the pivot (the first maximal |a| of column k over rows
// k..kb-1) is swapped into row k, scaled in place and read from there by
// the rank-one update of every other row, a warp a row, through L2.  On
// return rows 0..kb-1 hold A^{-1} B in their columns kb on; every thread
// returns det A.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T gmem_gauss_jordan(T* O, int kb, int mb) {
    __shared__ Cand s_red[kGJWarps];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const T one = Num<T>::one();
    const Cand none{-1.0, kNone, 0};
    T det = one;  // the same in every thread
    for (int k = 0; k < kb; ++k) {
        Cand best = none;
        for (int i = k + tid; i < kb; i += kGJThreads)
            cand_take(best, pivot_mag(O[(long long)i * mb + k]), i, 0);
        warp_cand(best);
        if (lane == 0) s_red[warp] = best;
        __syncthreads();
        Cand win = lane < kGJWarps ? s_red[lane] : none;
        warp_cand(win);
        const int p = win.pos;
        T* rk = O + (long long)k * mb;
        T* rp = O + (long long)p * mb;
        const T piv = rp[k];
        const T safe = Num<T>::is_zero(piv) ? one : piv;
        det = ((p != k) ? -det : det) * piv;
        __syncthreads();  // column k and the pivot are read
        for (int j = k + tid; j < mb; j += kGJThreads) {  // swap rows k and p, scale row k
            const T a = rp[j], b = rk[j];
            rk[j] = j > k ? a / safe : a;
            if (p != k) rp[j] = b;
        }
        __syncthreads();  // the pivot row is in place
        for (int i = warp; i < kb; i += kGJWarps) {
            if (i == k) continue;
            T* ri = O + (long long)i * mb;
            const T f = ri[k];
            for (int j = k + 1 + lane; j < mb; j += 32) ri[j] = ri[j] - f * rk[j];
        }
        __syncthreads();  // the step is done
    }
    return det;
}

// ---- the randomized spectral frontend (rsf_*.cu) ----

// Rows [lo, hi) of cut i's block: the leading s rows (side L) or the
// trailing s rows (side R) of an L-row operand; the complement is the rest.
__device__ __forceinline__ void rsf_block_rows(int L, int s, int right, int* lo, int* hi) {
    *lo = right ? L - s : 0;
    *hi = right ? L : s;
}

// ---- FP64 tensor cores and asynchronous copies (rsf_apply.cu, rsf_tsprod.cu,
// fw_frame_slab.cu; cp.async also swap_fill.cu) ----

// D += A B for one 16 x 8 x 8 float64 tile on the tensor cores (mma.sync
// DMMA; wgmma takes no float64).  Lane = 4 g + t holds (PTX ISA, "Matrix
// Fragments for mma.m16n8k8" with .f64): a = {A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4]}, b = {B[t][g], B[t + 4][g]}, d = {D[g][2 t],
// D[g][2 t + 1], D[g + 8][2 t], D[g + 8][2 t + 1]}.  Every lane of the warp
// calls it.  The m16n8k* shapes are new with sm_90; the older m8n8k4 does a
// quarter of the work an instruction and does not reach the card's
// float64 peak.
__device__ __forceinline__ void dmma_16x8x8(double& d0, double& d1, double& d2, double& d3,
                                            const double (&a)[4], const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// Asynchronous global -> shared copies of 16 or 8 bytes; of the source
// only ``src_bytes`` are read, the rest of the destination is zeroed (0:
// nothing is read, ``src`` must still be a valid address).
__device__ __forceinline__ void cp_async16(double* dst, const double* src, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(double* dst, const double* src, int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's (16 MI) x (8 NI) share of a product tile, as MI x NI DMMA tiles
// of 16 x 8: acc[r][ni][j] holds row m0 + 8 r + g, column n0 + 8 ni + 2 t + j
// (r < 2 MI: 16-row tile r / 2, its upper or lower half).  One depth stage
// of ``depth`` (a multiple of 8) from shared memory, in ascending depth, so
// every sum is one chain of fused multiply-adds in depth order: B is
// depth-major (element (k, n) at sB[k * ldb + n]); A is depth-major too
// (A_DEPTH_MAJOR: (m, k) at sA[k * lda + m]) or row-major ((m, k) at
// sA[m * lda + k]).  A leading dimension of 4 mod 16 doubles keeps the
// fragment loads free of bank conflicts.
template <bool A_DEPTH_MAJOR, int MI = 2, int NI = 4>
__device__ __forceinline__ void warp_dmma_stage(double (&acc)[2 * MI][NI][2], const double* sA,
                                                int lda, const double* sB, int ldb, int m0,
                                                int n0, int depth) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    auto at = [&](int m, int k) { return A_DEPTH_MAJOR ? sA[k * lda + m] : sA[m * lda + k]; };
    for (int k = 0; k < depth; k += 8) {
        double a[MI][4], b[NI][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
            const int m = m0 + 16 * mi + g;
            a[mi][0] = at(m, k + t);
            a[mi][1] = at(m + 8, k + t);
            a[mi][2] = at(m, k + t + 4);
            a[mi][3] = at(m + 8, k + t + 4);
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
            b[ni][0] = sB[(k + t) * ldb + n0 + 8 * ni + g];
            b[ni][1] = sB[(k + t + 4) * ldb + n0 + 8 * ni + g];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
                dmma_16x8x8(acc[2 * mi][ni][0], acc[2 * mi][ni][1], acc[2 * mi + 1][ni][0],
                            acc[2 * mi + 1][ni][1], a[mi], b[ni]);
    }
}

// Stages a ROWS x COLS tile of a float64 matrix into shared memory
// (element (r, c) at dst[r * SLD + c]) with cp.async.  Row row0 + r starts
// at ``row_ptr(row0 + r)``, or is not read where that is null; of its
// columns col0 + c, those below col_end are read, except that a chunk lying
// wholly below col_begin is not: a chunk straddling col_begin reads both
// its entries, so the caller discards the product terms below col_begin or
// stages zeros for them on the other operand (rsf_apply).  What is not read
// is zeroed.  VEC = 2 copies 16 bytes (every row start, col0 and the
// leading dimension even and 16-byte aligned; a pair whose second column is
// past col_end copies 8 and zeroes 8), VEC = 1 copies 8.  ``base`` is any
// valid address (the source operand of a copy that reads nothing).  Every
// thread of the block calls it; ``nthreads`` threads share the work.
template <int ROWS, int COLS, int SLD, int VEC, typename RowPtr>
__device__ __forceinline__ void stage_tile(double* dst, RowPtr row_ptr, const double* base,
                                           int row0, int col0, int col_begin, int col_end,
                                           int nthreads) {
    constexpr int kChunks = ROWS * COLS / VEC;
    for (int e = threadIdx.x; e < kChunks; e += nthreads) {
        const int r = e / (COLS / VEC), c = (e % (COLS / VEC)) * VEC;
        const int col = col0 + c;
        const double* row = row_ptr(row0 + r);
        const int n = (row != nullptr && col + VEC > col_begin) ? max(0, min(VEC, col_end - col))
                                                                : 0;
        const double* from = n > 0 ? row + col : base;
        if (VEC == 2)
            cp_async16(dst + r * SLD + c, from, 8 * n);
        else
            cp_async8(dst + r * SLD + c, from, 8 * n);
    }
}

// The cp.async ring over nk depth stages in STAGES shared-memory buffers:
// load(buffer, kt) issues the copies of stage kt, compute(buffer) consumes
// a stage that has landed; stage kt + STAGES - 1 loads while stage kt
// computes.  Every thread of the block calls it (it synchronises).
template <int STAGES, typename Load, typename Compute>
__device__ __forceinline__ void cp_async_pipeline(int nk, Load load, Compute compute) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nk) load(st, st);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage kt is visible; every warp is done with stage kt - 1
        const int next = kt + STAGES - 1;
        if (next < nk) load(next % STAGES, next);
        cp_async_commit();
        compute(kt % STAGES);
    }
    cp_async_wait<0>();
}

__host__ __forceinline__ bool aligned16(const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Allows kernel K ``most`` bytes of dynamic shared memory (above 48 KB K
// must be allowed it first), once per device: the attribute call costs
// microseconds, which a small launch would pay every time.  A kernel whose
// launches differ in size is allowed its largest.
template <auto K>
cudaError_t allow_dynamic_smem(int most) {
    static std::atomic<unsigned long long> allowed{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (!(allowed.load() & bit)) {
        err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
        if (err != cudaSuccess) return err;
        allowed.fetch_or(bit);
    }
    return cudaSuccess;
}

// Launches kernel K with ``smem`` bytes of dynamic shared memory, allowed
// by allow_dynamic_smem at the first launch.
template <auto K, typename... Args>
cudaError_t launch_dynamic_smem(dim3 grid, int threads, int smem, cudaStream_t stream,
                                Args... args) {
    const cudaError_t err = allow_dynamic_smem<K>(smem);
    if (err != cudaSuccess) return err;
    K<<<grid, threads, smem, stream>>>(args...);
    return cudaGetLastError();
}

// K5 det_rows: determinants of index-row submatrices of identity-extended
// matrices, paired or all-pairs.
//
// Replaces temfpy_tpu/ops/linalg.py:_det_pairs_impl (batched_det_pairs),
// _det_gather_impl (batched_det_gather) and the rank-update cross-check
// _det_check_impl, built there on gather_submatrices and lu_det.
//
// For matrix g and determinant q:
//   paired (cross = 0):  rows idx_b[g, q], cols idx_k[g, q]       -> out[g, q]
//   all pairs (cross=1): rows idx_b[g, i], cols idx_k[g, j]       -> out[g, i, j]
//   A[s, t] = M_aug[row[s], col[t]]  (w x w),  out = det(A) * scale[g]
// where M_aug = diag(M[g], I) is never formed: an index >= m is a sentinel of
// the identity extension (common.cuh:identity_ext), so an all-sentinel row
// pair gives 1.
//
// What bounds it on the H100: the latency of each determinant's chain of w
// dependent LU steps (w^3/3 multiply-adds, w <= 64), and the gathers from M
// and the index rows.  The main path's launches are small: the rank-update
// probe (slater.py) checks 32 pairs of each of G units, a few thousand
// determinants a launch.  The first design gave each determinant one thread
// with its w x w matrix in thread-private arrays (local memory above w = 8)
// and a serial LU, in 128-thread blocks of one matrix each, so a probe
// block had 32 live threads and a launch lasted one thread's w^3/3-long
// chain (~42 us).
//
// The design: det_fill's (K1).
// - A segment of lanes per determinant holds the matrix in registers
//   (common.cuh:segment_lanes: float64 one thread up to W = 8, 8 lanes at
//   16, 32 at 32; complex128 halves a lane's rows), padded to the template
//   width W (4, 8, 16, 32) with identity rows and columns, so every
//   register index is a constant; the LU is common.cuh:segment_lu_det,
//   which stops after w steps (the pad's steps would multiply by exact
//   ones).  Its pivot rule and arithmetic are the first design's operation
//   for operation.
// - The rows are gathered through identity_ext straight into registers;
//   each lane reads W / lanes entries of the two index rows and the column
//   indices reach the segment by shuffles.
// - A block takes `dets_per_block` determinants (whole rounds of its
//   segments, kernels.det_rows_geometry).  Paired, they run over the flat
//   (matrix, determinant) range, so a probe launch of G units x 32 pairs
//   fills its blocks and spreads over the SMs (64-thread blocks while the
//   launch would not give every SM a 256-thread one).  All pairs, a block
//   takes determinants of one matrix, and its ket index rows are staged in
//   shared memory once where they fit and the block reads each of them at
//   least once (`stage`).
// - W = 64: a warp per determinant with the matrix in shared memory and
//   det_fill's wide LU (common.cuh:warp_lu_det); no main-path width is
//   that large.
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kRowsThreads = 256;  // most threads of a block (64 for small launches)
constexpr int kWideThreads = 64;   // W = 64: two warps, one determinant each

// The determinants a block takes: [*begin, *end) of the flat range, paired
// over (matrix, determinant), all pairs over matrix blockIdx.y's nb x nk.
__device__ __forceinline__ void block_range(long long total, int dets_per_block,
                                            long long* begin, long long* end) {
    *begin = (long long)blockIdx.x * dets_per_block;
    *end = min(total, *begin + dets_per_block);
}

// Matrix, bra row and ket row of determinant d of the range.
__device__ __forceinline__ void det_coords(long long d, int nb, int nk, int cross, int* g,
                                           long long* i, long long* j) {
    if (cross) {
        *g = blockIdx.y;
        *i = d / nk;
        *j = d % nk;
    } else {
        *g = (int)(d / nb);
        *i = *j = d % nb;
    }
}

template <typename T, int W>
__global__ void __launch_bounds__(kRowsThreads)
    det_rows_kernel(const T* __restrict__ M, const T* __restrict__ scale,
                    const int* __restrict__ idx_b, const int* __restrict__ idx_k,
                    T* __restrict__ out, int G, int m, int w, int nb, int nk, int cross,
                    int dets_per_block, int stage) {
    constexpr int S = segment_lanes<T, W>();  // lanes per determinant
    constexpr int ROWS = W / S;               // rows per lane: lane s holds rows s + S q
    constexpr int PER_WARP = 32 / S;          // determinants per warp
    extern __shared__ __align__(16) int s_ket[];

    const long long total = cross ? (long long)nb * nk : (long long)G * nb;
    long long begin, end;
    block_range(total, dets_per_block, &begin, &end);
    if (stage) {  // all pairs: the matrix's ket index rows, once per block
        const int* src = idx_k + (long long)blockIdx.y * nk * w;
        for (int e = threadIdx.x; e < nk * w; e += blockDim.x) s_ket[e] = src[e];
        __syncthreads();
    }
    const int lane = threadIdx.x & 31, seg = lane / S, sl = lane % S;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const unsigned segmask = S == 32 ? kFullMask : ((1u << S) - 1u) << (seg * S);
    const T one = Num<T>::one(), zero = Num<T>::zero();

    // the loop is uniform over a warp; segments past `end` compute a copy of
    // the last determinant (every lane must join the shuffles) and write
    // nothing
    for (long long d0 = begin + warp * PER_WARP; d0 < end; d0 += nwarps * PER_WARP) {
        const long long d = d0 + seg;
        const bool valid = d < end;
        int g;
        long long i, j;
        det_coords(valid ? d : end - 1, nb, nk, cross, &g, &i, &j);
        const int* rb = idx_b + ((long long)g * nb + i) * w;
        const int* ck = stage ? s_ket + j * w : idx_k + ((long long)g * nk + j) * w;
        const T* Mg = M + (long long)g * m * m;
        int arow[ROWS], bcol[ROWS], pos[ROWS];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            const int t = sl + S * q;
            arow[q] = t < w ? rb[t] : -1;  // -1: an identity row or column of the padding
            bcol[q] = t < w ? ck[t] : -1;
            pos[q] = t;
        }
        T A[ROWS][W];
#pragma unroll
        for (int t = 0; t < W; ++t) {
            const int b = seg_shfl<S>(bcol[t / S], t % S);
#pragma unroll
            for (int q = 0; q < ROWS; ++q) {
                const int a = arow[q];
                A[q][t] = (a < 0 || b < 0) ? ((sl + S * q == t) ? one : zero)
                                           : identity_ext(Mg, m, a, b);
            }
        }
        const T det = segment_lu_det<T, W, S>(A, pos, seg, segmask, w);
        if (valid && sl == 0)
            out[cross ? (long long)g * nb * nk + d : d] = det * scale[g];
    }
}

// W = 64: a warp per determinant, the 64 x 64 matrix in shared memory.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    det_rows_wide_kernel(const T* __restrict__ M, const T* __restrict__ scale,
                         const int* __restrict__ idx_b, const int* __restrict__ idx_k,
                         T* __restrict__ out, int G, int m, int w, int nb, int nk, int cross,
                         int dets_per_block) {
    constexpr int W = 64, LD = W + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T* A = reinterpret_cast<T*>(smem_raw) + warp * W * LD;
    const long long total = cross ? (long long)nb * nk : (long long)G * nb;
    long long begin, end;
    block_range(total, dets_per_block, &begin, &end);
    const T one = Num<T>::one(), zero = Num<T>::zero();
    for (long long d = begin + warp; d < end; d += kWideThreads / 32) {
        int g;
        long long i, j;
        det_coords(d, nb, nk, cross, &g, &i, &j);
        const int* rb = idx_b + ((long long)g * nb + i) * w;
        const int* ck = idx_k + ((long long)g * nk + j) * w;
        const T* Mg = M + (long long)g * m * m;
        for (int t = lane; t < W; t += 32) {
            const int b = t < w ? ck[t] : -1;
            for (int s = 0; s < W; ++s) {
                const int a = s < w ? rb[s] : -1;
                A[s * LD + t] = (a < 0 || b < 0) ? ((s == t) ? one : zero)
                                                 : identity_ext(Mg, m, a, b);
            }
        }
        __syncwarp();
        const T det = warp_lu_det<T, W, LD>(A, lane, w);
        if (lane == 0) out[cross ? (long long)g * nb * nk + d : d] = det * scale[g];
        __syncwarp();
    }
}

template <typename T, int W>
int launch(const void* M, const void* scale, const int* idx_b, const int* idx_k, void* out,
           int G, int m, int w, int nb, int nk, int cross, int dets_per_block, int threads,
           int stage, cudaStream_t stream) {
    const long long total = cross ? (long long)nb * nk : (long long)G * nb;
    dim3 grid((unsigned)((total + dets_per_block - 1) / dets_per_block), cross ? G : 1);
    if constexpr (W == 64) {
        if (threads != kWideThreads || stage) return (int)cudaErrorInvalidValue;
        return (int)launch_dynamic_smem<det_rows_wide_kernel<T>>(
            grid, kWideThreads, (int)(kWideThreads / 32 * W * (W + 1) * sizeof(T)), stream,
            (const T*)M, (const T*)scale, idx_b, idx_k, (T*)out, G, m, w, nb, nk, cross,
            dets_per_block);
    } else {
        constexpr int S = segment_lanes<T, W>();
        if (threads % 32 || threads > kRowsThreads || dets_per_block % (threads / S) ||
            (stage && !cross))
            return (int)cudaErrorInvalidValue;
        const size_t smem = stage ? (size_t)nk * w * sizeof(int) : 0;
        det_rows_kernel<T, W><<<grid, threads, smem, stream>>>(
            (const T*)M, (const T*)scale, idx_b, idx_k, (T*)out, G, m, w, nb, nk, cross,
            dets_per_block, stage);
        return (int)cudaGetLastError();
    }
}

template <typename T>
int dispatch(const void* M, const void* scale, const int* idx_b, const int* idx_k, void* out,
             int G, int m, int w, int nb, int nk, int cross, int dets_per_block, int threads,
             int stage, cudaStream_t stream) {
#define TF_LAUNCH(WW)                                                                          \
    return launch<T, WW>(M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross, dets_per_block, \
                         threads, stage, stream)
    if (w <= 4) TF_LAUNCH(4);
    if (w <= 8) TF_LAUNCH(8);
    if (w <= 16) TF_LAUNCH(16);
    if (w <= 32) TF_LAUNCH(32);
    if (w <= 64) TF_LAUNCH(64);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// `dets_per_block`, `threads` and `stage` from kernels.det_rows_geometry:
// the grid is (ceil(total / dets_per_block), cross ? G : 1) blocks of
// `threads` (64 at W = 64), total = G nb (paired) or nb nk (all pairs, per
// matrix); `stage` (all pairs only) stages each matrix's ket index rows,
// nk w ints, in shared memory.
extern "C" int tf_det_rows(int dtype, const void* M, const void* scale, const int* idx_b,
                           const int* idx_k, void* out, int G, int m, int w, int nb, int nk,
                           int cross, int dets_per_block, int threads, int stage,
                           void* stream) {
    if (G == 0 || nb == 0 || (cross && nk == 0)) return (int)cudaSuccess;
    if (dets_per_block <= 0 || w < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == TF_F64)
        return dispatch<double>(M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross,
                                dets_per_block, threads, stage, s);
    if (dtype == TF_C128)
        return dispatch<c128>(M, scale, idx_b, idx_k, out, G, m, w, nb, nk, cross,
                              dets_per_block, threads, stage, s);
    return (int)cudaErrorInvalidValue;
}

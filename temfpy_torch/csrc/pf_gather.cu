// K7' pf_gather: all-pairs Pfaffians of index-row principal submatrices.
//
// Replaces temfpy_tpu/ops/pfaffian.py:_pf_gather_impl (batched_pfaffian_gather),
// built there on symplectic_pad and the Parlett-Reid batch _pfaffian_batch.
//
// For bra row i and ket row j:
//   ix  = [ket_idx[j, :kk], bra_idx[i, :kb]]          (k = kk + kb, even)
//   out[i, j] = Pf(N_aug[ix, ix])
// where N_aug = N + J + ... + J (J = [[0, 1], [-1, 0]] on the index pairs
// (m, m+1), (m+2, m+3), ...; temfpy_tpu/ops/pfaffian.py:symplectic_pad) is
// never formed: an entry with both indices >= m is +1 or -1 on a J block and
// 0 elsewhere, a mixed entry is 0.  Unlike pf_fill (K3), whose planner puts
// the sentinels in one contiguous tail and eliminates only the leading
// block, this takes index rows as callers give them, so the whole k x k
// matrix is eliminated, sentinels included, as the JAX kernel does.
//
// What bounds it on the H100: the arithmetic of about k^3 / 6 entry updates
// per pair (k <= 32) on the FP64 pipes (a rank-2 update is no product for
// the DMMA tensor cores), and the latency of each pair's chain of k / 2
// pivot steps.  The first design was K3's first: one warp per pair, 4 pairs
// a block, the k x k matrix in the warp's slice of shared memory, each step
// a shuffle arg-max, two swap passes and an n^2 / 32 update loop with `/`
// and `%` index arithmetic; at k <= 16 at least half of each warp idled,
// and the matrix was assembled entry by entry through a branchy gather.
//
// The design: k is the same for every pair of a launch, so a launch runs
// one tier, chosen from k (no sort):
// - k <= 16: the tier of width TW (4, 8, 16: the first that holds k) on
//   lane segments of pf_gather_lanes<T, TW>() lanes (a lane holds TW / S
//   rows, 32 float64 values from TW = 8 on), lane s rows s + S q in
//   registers at constant indices, eliminated by
//   common.cuh:segment_parlett_reid (K3's), registers capped for four
//   blocks an SM.  A narrower k is padded with trailing J blocks, the exact
//   factor 1 of pf_fill.cu's header (the padding is a decoupled block;
//   segment_parlett_reid stops after k steps and never reads it); sentinels
//   inside ix stay ordinary rows.  Each lane gathers its own rows, walking
//   N's row ix[t] along the columns (one lane per row, the row's segments
//   through L1).
// - 16 < k <= 32: a warp per pair holds its rows in shared memory, one row
//   a lane (row stride 33: no bank conflicts across lanes), and
//   warp_row_parlett_reid eliminates it: the arg-max by a butterfly, the
//   swaps one column and one row a lane, u and the column k + 1 staged once
//   a step, and each lane updating its own row, four entries a group with
//   every load before the stores, with no index arithmetic.  Two warps a
//   block (36 KB in complex128).  In registers (32 lanes, one row a lane)
//   this tier measured slower in both types on an H100: complex128 at 255
//   registers (6.08 against 3.53 ms on phase 3e's k = 32 call), float64
//   0.617 against 0.413 ms (phase 3d's k = 32).
// Pairs are taken in order q = i nk + j, so the segments of a warp and the
// warps of a block share the bra row i, and its N[bra_i, bra_i] entries,
// through L1.  The products and sums are the first design's: the same
// u = A[k, :] / A[k, k+1] (in the register tiers -A[:, k] / A[k, k+1], its
// skew twin) and the same rank-2 update.  What still bounds it: the k = 32
// tier's row updates through shared memory (about ten wavefronts an entry
// update of a warp) and each step's latency with 12 warps an SM.  float64
// and complex128.  No allocation, no host sync: the kernel runs on the
// caller's stream.

#include "common.cuh"

namespace {

constexpr int kSegThreads = 128;  // threads of a register-tier block
constexpr int kRowWarps = 2;      // warps (pairs) of a shared-memory block
constexpr int kRowLd = 33;        // row stride of the shared-memory matrix

// Lanes of the segment that holds one pair of width <= TW (4, 8, 16): each
// lane holds TW / S rows, 32 float64 values (16 complex) from TW = 8 on.
template <typename T, int TW>
__host__ __device__ constexpr int pf_gather_lanes() {
    static_assert(TW == 4 || TW == 8 || TW == 16, "a register tier");
    if (std::is_same<T, double>::value) return TW == 4 ? 1 : (TW == 8 ? 2 : 8);
    return TW == 4 ? 1 : (TW == 8 ? 4 : 16);
}

// Entry (e, b) of N_aug for index values e, b (>= m: a J-block sentinel).
template <typename T>
__device__ __forceinline__ T n_aug(const T* __restrict__ N, int m, int e, int b) {
    if (e < m && b < m) return N[(long long)e * m + b];
    if (e < m || b < m) return Num<T>::zero();
    const int de = e - m, db = b - m;
    if ((de ^ 1) != db) return Num<T>::zero();
    return (de & 1) ? -Num<T>::one() : Num<T>::one();
}

// Index slot t of pair (i, j): the ket row first, then the bra row.
__device__ __forceinline__ int pair_index(const int* __restrict__ bra_idx,
                                          const int* __restrict__ ket_idx, int i, int j, int kb,
                                          int kk, int t) {
    return t < kk ? ket_idx[(long long)j * kk + t] : bra_idx[(long long)i * kb + t - kk];
}

// The register tier: segment seg of a warp takes pair q = warp * (32 / S) +
// seg.  Segments past the last pair compute a copy of it (every lane joins
// the shuffles) and write nothing.  Registers are capped for four blocks an
// SM (16 warps to hide each step's latency; complex128 at TW = 16 needed
// 136 without the cap, and ran 1.13x slower at three blocks).
template <typename T, int TW>
__global__ void __launch_bounds__(kSegThreads, 4)
    pf_gather_seg_kernel(const T* __restrict__ N, const int* __restrict__ bra_idx,
                         const int* __restrict__ ket_idx, T* __restrict__ out, int m, int nk,
                         long long n, int kb, int kk) {
    constexpr int S = pf_gather_lanes<T, TW>();
    constexpr int ROWS = TW / S;
    constexpr int PER_WARP = 32 / S;
    const int lane = threadIdx.x & 31, seg = lane / S, sl = lane % S;
    const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const long long q = warp * PER_WARP + seg;
    const bool valid = q < n;
    const long long qq = valid ? q : n - 1;
    const int i = (int)(qq / nk), j = (int)(qq % nk);
    const int k = kk + kb;
    int ix[ROWS], pos[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int t = sl + S * r;
        ix[r] = t < k ? pair_index(bra_idx, ket_idx, i, j, kb, kk, t) : -1;  // -1: J padding
        pos[r] = t;
    }
    // Rows past k are the J padding.  No step reads their columns past k or
    // picks one of them as a pivot: their k real columns hold NaN, which
    // pivot_mag ranks below every real row (a tie goes to the first row, a
    // real one), as the first design, with no padding, would pivot.
    const T nan_t = Num<T>::one() * nan("");
    T A[ROWS][TW];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int t = 0; t < TW; ++t) A[r][t] = Num<T>::zero();
#pragma unroll
    for (int t = 0; t < TW; ++t) {
        if (t >= k) break;
        const int b = seg_shfl<S>(ix[t / S], t % S);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            if (S * r >= k) break;
            A[r][t] = ix[r] >= 0 ? n_aug(N, m, ix[r], b) : nan_t;
        }
    }
    const T pf = segment_parlett_reid<T, TW, S>(A, pos, k);
    if (valid && sl == 0) out[q] = pf;
}

// Pfaffian of the tot x tot skew-symmetric matrix A (tot even, <= 32) held
// in shared memory one row a lane (row t at A + t * kRowLd), by ONE warp:
// Parlett-Reid with partial pivoting, the products and sums of
// common.cuh:warp_parlett_reid.  At step k (even) the first maximal
// |A[j, k]|, j > k (a butterfly over the lanes j), is swapped into row and
// column k+1 (sign flip: lane t swaps column t of the two rows, then the two
// columns of its own row), the Pfaffian is multiplied by A[k, k+1], u[t] =
// A[k, t] / A[k, k+1] and c[t] = A[t, k+1] are staged (lane t each), and
// lane i >= k+2 takes its row's rank-2 skew update
//   A[i, j] += u[i] A[j, k+1] - A[i, k+1] u[j],   j >= k+2.
// A zero pivot makes the Pfaffian 0.  A is overwritten; every lane returns
// the same value.
template <typename T>
__device__ __forceinline__ T warp_row_parlett_reid(T* A, T* u, T* c, int tot, int lane) {
    T pf = Num<T>::one();
    T* row = A + lane * kRowLd;
    for (int k = 0; k < tot; k += 2) {
        double bv = (lane > k && lane < tot) ? pivot_mag(row[k]) : -1.0;
        int bj = lane;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            const double v2 = __shfl_xor_sync(kFullMask, bv, d);
            const int j2 = __shfl_xor_sync(kFullMask, bj, d);
            if (v2 > bv || (v2 == bv && j2 < bj)) {
                bv = v2;
                bj = j2;
            }
        }
        const int kp = bj;  // the same in every lane
        if (kp != k + 1) {
            if (lane < tot) {
                T* a = A + (k + 1) * kRowLd + lane;
                T* b = A + kp * kRowLd + lane;
                const T tmp = *a;
                *a = *b;
                *b = tmp;
            }
            __syncwarp();
            if (lane < tot) {
                const T tmp = row[k + 1];
                row[k + 1] = row[kp];
                row[kp] = tmp;
            }
            __syncwarp();
            pf = -pf;
        }
        const T akk1 = A[k * kRowLd + k + 1];
        pf = pf * akk1;
        if (Num<T>::is_zero(akk1)) break;  // the same value in every lane
        const bool live = lane >= k + 2 && lane < tot;
        if (live) {
            u[lane] = A[k * kRowLd + lane] / akk1;
            c[lane] = row[k + 1];
        }
        __syncwarp();
        if (live) {
            // four entries at a time, every load before the stores: the
            // loads of a group do not wait on the stores of the last
            const T ui = u[lane], ci = c[lane];
            int j = k + 2;
            for (; j + 4 <= tot; j += 4) {
                T a[4], cj[4], uj[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    a[t] = row[j + t];
                    cj[t] = c[j + t];
                    uj[t] = u[j + t];
                }
#pragma unroll
                for (int t = 0; t < 4; ++t) row[j + t] = a[t] + (ui * cj[t] - ci * uj[t]);
            }
            for (; j < tot; ++j) row[j] = row[j] + (ui * c[j] - ci * u[j]);
        }
        __syncwarp();
    }
    return pf;
}

// The shared-memory tier (16 < k <= 32): warp w of the block takes pair
// blockIdx.x * kRowWarps + w, lane t row t of its matrix.
template <typename T>
__global__ void __launch_bounds__(32 * kRowWarps)
    pf_gather_row_kernel(const T* __restrict__ N, const int* __restrict__ bra_idx,
                         const int* __restrict__ ket_idx, T* __restrict__ out, int m, int nk,
                         long long n, int kb, int kk) {
    __shared__ T s_A[kRowWarps][32 * kRowLd];
    __shared__ T s_u[kRowWarps][32], s_c[kRowWarps][32];
    __shared__ int s_ix[kRowWarps][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long q = (long long)blockIdx.x * kRowWarps + warp;
    if (q >= n) return;  // the whole warp: no block-wide barrier follows
    const int i = (int)(q / nk), j = (int)(q % nk);
    const int k = kk + kb;
    int* ix = s_ix[warp];
    if (lane < k) ix[lane] = pair_index(bra_idx, ket_idx, i, j, kb, kk, lane);
    __syncwarp();
    T* A = s_A[warp];
    if (lane < k) {
        const int e = ix[lane];
        for (int t = 0; t < k; ++t) A[lane * kRowLd + t] = n_aug(N, m, e, ix[t]);
    }
    __syncwarp();
    const T pf = warp_row_parlett_reid<T>(A, s_u[warp], s_c[warp], k, lane);
    if (lane == 0) out[q] = pf;
}

template <typename T, int TW>
int launch_seg(const void* N, const int* bra_idx, const int* ket_idx, void* out, int m, int nk,
               long long n, int kb, int kk, cudaStream_t stream) {
    constexpr long long per_block = kSegThreads / 32 * (32 / pf_gather_lanes<T, TW>());
    pf_gather_seg_kernel<T, TW><<<(unsigned)((n + per_block - 1) / per_block), kSegThreads, 0,
                                  stream>>>((const T*)N, bra_idx, ket_idx, (T*)out, m, nk, n,
                                            kb, kk);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* N, const int* bra_idx, const int* ket_idx, void* out, int m, int nb,
             int nk, int kb, int kk, cudaStream_t stream) {
    const long long n = (long long)nb * nk;
    const int k = kb + kk;
    if (k <= 4) return launch_seg<T, 4>(N, bra_idx, ket_idx, out, m, nk, n, kb, kk, stream);
    if (k <= 8) return launch_seg<T, 8>(N, bra_idx, ket_idx, out, m, nk, n, kb, kk, stream);
    if (k <= 16) return launch_seg<T, 16>(N, bra_idx, ket_idx, out, m, nk, n, kb, kk, stream);
    if (k > 32) return (int)cudaErrorInvalidValue;
    pf_gather_row_kernel<T><<<(unsigned)((n + kRowWarps - 1) / kRowWarps), 32 * kRowWarps, 0,
                              stream>>>((const T*)N, bra_idx, ket_idx, (T*)out, m, nk, n, kb,
                                        kk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_pf_gather(int dtype, const void* N, const int* bra_idx, const int* ket_idx,
                            void* out, int m, int nb, int nk, int kb, int kk, void* stream) {
    if (nb == 0 || nk == 0) return (int)cudaSuccess;
    if ((kb + kk) & 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == TF_F64) return dispatch<double>(N, bra_idx, ket_idx, out, m, nb, nk, kb, kk, s);
    if (dtype == TF_C128) return dispatch<c128>(N, bra_idx, ket_idx, out, m, nb, nk, kb, kk, s);
    return (int)cudaErrorInvalidValue;
}

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
//   out[slot[g], tab0[..], tab1[..], tab2[..]] = det(A) * det_always[g]
// where M_aug = diag(M[g], I_w) is never formed: an index >= m is a
// sentinel of the identity extension, so such an entry is 1 if the bra and
// ket indices are equal and 0 otherwise.  Each table is indexed by r or by c
// according to bit i of `sel` (the JAX `spec`: "rc", "rrc", "crr").  `out` is
// the caller's zeroed buffer of bucketed site tensors, each with a trash row
// out[., D0] that padded pairs (all-sentinel rows) land in; the fills of one
// site write disjoint entries, so several sites of a group, or several
// groups, may share a slot.  The wrapper slices the trash row off.
//
// What bounds it on the H100: float64 arithmetic of many tiny LUs (2 c^3 / 3
// operations for a pair of c occupied orbitals, c <= 64; at bench config 1,
// L = 1024, 6.4e10 operations in a conversion, ~1 ms at the FP64 peak) and
// the movement of the pair ids and one value a pair (~0.45 ms).  The
// parent design held each pair's w x w matrix in one thread with runtime
// trip counts and indices: nvcc put the whole matrix in local memory at
// every width (-Xptxas -v: a W^2 x 8 + 4W byte stack frame, PERF.md), each
// step of the LU streamed it through L1/L2, and every entry was gathered
// from M in global memory: ~15 ns a pair, 1.4 s for the conversion's 528
// launches.
//
// The design: a segment of S lanes per pair holds the W x W matrix in
// registers, lane s rows s + S q (common.cuh:segment_lanes: in float64 one thread per
// pair up to W = 8, then 8 lanes of two rows at W = 16 and 32 lanes of one
// at W = 32; complex128 halves the rows a lane holds).  Every loop over
// rows, columns and LU steps is unrolled to the template width W (4, 8,
// 16, 32), so every register index is a constant.  A pair narrower than W
// is padded with identity rows and columns (the determinant is unchanged,
// and so is every rounding: the padded entries add exact zeros and
// multiply by exact ones).  Rows never move: each lane keeps the logical
// position of its rows, the pivot search is a segmented shuffle arg-max
// over rows at or past step k (the first maximal |A[i, k]| in logical
// order wins, as in temfpy_tpu/ops/linalg.py:_lu_det_body), the pivot
// row is selected and broadcast by shuffles, and the elimination is
// A[i, j] -= (A[i, k] / pivot) A[k, j], the parent's arithmetic operation
// for operation (a zero pivot gives det 0 without a division); the LU is
// common.cuh:segment_lu_det, which swap_fill shares.  W = 64 is
// a warp per pair with the matrix in shared memory (64 x 64 values would
// fill a warp's registers) and the parent's row swaps; no main-path
// bucket is that wide.  The site's M (m x m, padded to stride m + 1) is
// staged in shared memory once per block where it fits in 48 KB (m <= 77
// in float64), and a block loops over `pairs_per_block` pairs of one site
// (kernels.det_fill_geometry), so every gather reads shared memory; each
// segment reads its pair's two occupation rows as coalesced loads.  The
// occupation tables are not staged: a site's tables (up to thousands of
// rows) do not fit beside M, and each row is read once.  What bounds the
// design now is its instruction count: per step and lane a shuffle arg-max, a
// select of the pivot row among the lane's rows and its broadcast, one
// division per row.  No allocation, no sync: the kernel runs on the
// caller's stream.

#include "common.cuh"

namespace {

constexpr int kFillThreads = 256;
constexpr int kWideThreads = 64;  // W = 64: two warps, one pair each
constexpr int kStageBytes = 48 * 1024;

template <typename T>
__device__ __forceinline__ void scatter(const int* tab0, const int* tab1, const int* tab2,
                                        const int* slot, T* out, int g, int r, int c, int n0,
                                        int n1, int n2, int sel, int D0p1, int D1, int D2,
                                        T v) {
    const int c0 = tab0[(long long)g * n0 + ((sel & 1) ? c : r)];
    const int c1 = tab1[(long long)g * n1 + ((sel & 2) ? c : r)];
    const int c2 = n2 ? tab2[(long long)g * n2 + ((sel & 4) ? c : r)] : 0;
    out[(((long long)slot[g] * D0p1 + c0) * D1 + c1) * D2 + c2] = v;
}

// W <= 32: a segment of S lanes per pair, the matrix in registers.
template <typename T, int W>
__global__ void __launch_bounds__(kFillThreads)
    det_fill_kernel(const T* __restrict__ M, const T* __restrict__ det_always,
                    const int* __restrict__ occ_b, const int* __restrict__ occ_k,
                    const int* __restrict__ pr, const int* __restrict__ pc,
                    const int* __restrict__ tab0, const int* __restrict__ tab1,
                    const int* __restrict__ tab2, const int* __restrict__ slot,
                    T* __restrict__ out, int m, int w, int R_b, int K_b, int P_b, int n0, int n1,
                    int n2, int sel, int D0p1, int D1, int D2, int pairs_per_block,
                    int stage_m) {
    constexpr int S = segment_lanes<T, W>();  // lanes per pair
    constexpr int ROWS = W / S;            // rows per lane: lane s holds rows s + S q
    constexpr int PER_WARP = 32 / S;       // pairs per warp
    extern __shared__ __align__(16) unsigned char smem_raw[];

    const int g = blockIdx.y;
    const T* Mp = M + (long long)g * m * m;
    int ld = m;
    if (stage_m) {
        T* sM = reinterpret_cast<T*>(smem_raw);
        for (int e = threadIdx.x; e < m * m; e += blockDim.x)
            sM[(e / m) * (m + 1) + e % m] = Mp[e];
        __syncthreads();
        Mp = sM;
        ld = m + 1;
    }
    const int lane = threadIdx.x & 31, seg = lane / S, sl = lane % S;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const unsigned segmask = S == 32 ? kFullMask : ((1u << S) - 1u) << (seg * S);
    const int p_end = min(P_b, (blockIdx.x + 1) * pairs_per_block);
    const T da = det_always[g];
    const T one = Num<T>::one(), zero = Num<T>::zero();

    // the loop is uniform over a warp; segments past p_end compute a copy
    // of the last pair (every lane must join the shuffles) and write nothing
    for (int p0 = blockIdx.x * pairs_per_block + warp * PER_WARP; p0 < p_end;
         p0 += nwarps * PER_WARP) {
        const int p = p0 + seg;
        const bool valid = p < p_end;
        const long long gp = (long long)g * P_b + (valid ? p : p_end - 1);
        const int r = pr[gp], c = pc[gp];
        const int* rb = occ_b + ((long long)g * R_b + r) * w;
        const int* ck = occ_k + ((long long)g * K_b + c) * w;
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
                T v;
                if (a < 0 || b < 0)
                    v = (sl + S * q == t) ? one : zero;
                else if (a < m && b < m)
                    v = Mp[a * ld + b];
                else
                    v = (a == b) ? one : zero;
                A[q][t] = v;
            }
        }

        const T det = segment_lu_det<T, W, S>(A, pos, seg, segmask);
        if (valid && sl == 0)
            scatter(tab0, tab1, tab2, slot, out, g, r, c, n0, n1, n2, sel, D0p1, D1, D2,
                    det * da);
    }
}

// W = 64: a warp per pair, the 64 x 64 matrix in shared memory (it would
// take a warp's whole register file); the LU with physical row swaps, the
// rows spread over the lanes (common.cuh:warp_lu_det, shared with det_rows).
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    det_fill_wide_kernel(const T* __restrict__ M, const T* __restrict__ det_always,
                         const int* __restrict__ occ_b, const int* __restrict__ occ_k,
                         const int* __restrict__ pr, const int* __restrict__ pc,
                         const int* __restrict__ tab0, const int* __restrict__ tab1,
                         const int* __restrict__ tab2, const int* __restrict__ slot,
                         T* __restrict__ out, int m, int w, int R_b, int K_b, int P_b, int n0,
                         int n1, int n2, int sel, int D0p1, int D1, int D2,
                         int pairs_per_block) {
    constexpr int W = 64, LD = W + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T* A = reinterpret_cast<T*>(smem_raw) + warp * W * LD;
    const int g = blockIdx.y;
    const T* Mg = M + (long long)g * m * m;
    const int p_end = min(P_b, (blockIdx.x + 1) * pairs_per_block);
    const T da = det_always[g];
    const T one = Num<T>::one(), zero = Num<T>::zero();
    for (int p = blockIdx.x * pairs_per_block + warp; p < p_end; p += kWideThreads / 32) {
        const long long gp = (long long)g * P_b + p;
        const int r = pr[gp], c = pc[gp];
        const int* rb = occ_b + ((long long)g * R_b + r) * w;
        const int* ck = occ_k + ((long long)g * K_b + c) * w;
        for (int t = lane; t < W; t += 32) {
            const int b = t < w ? ck[t] : -1;
            for (int s = 0; s < W; ++s) {
                const int a = s < w ? rb[s] : -1;
                A[s * LD + t] = (a < 0 || b < 0) ? ((s == t) ? one : zero)
                                                 : identity_ext(Mg, m, a, b);
            }
        }
        __syncwarp();
        const T det = warp_lu_det<T, W, LD>(A, lane);
        if (lane == 0)
            scatter(tab0, tab1, tab2, slot, out, g, r, c, n0, n1, n2, sel, D0p1, D1, D2,
                    det * da);
        __syncwarp();
    }
}

template <typename T, int W>
int launch(const void* M, const void* det_always, const int* occ_b, const int* occ_k,
           const int* pr, const int* pc, const int* tab0, const int* tab1, const int* tab2,
           const int* slot, void* out, int G, int m, int w, int R_b, int K_b, int P_b, int n0,
           int n1, int n2, int sel, int D0p1, int D1, int D2, int pairs_per_block,
           cudaStream_t stream) {
    dim3 grid((P_b + pairs_per_block - 1) / pairs_per_block, G);
    if constexpr (W == 64) {
        return (int)launch_dynamic_smem<det_fill_wide_kernel<T>>(
            grid, kWideThreads, (int)(kWideThreads / 32 * W * (W + 1) * sizeof(T)), stream,
            (const T*)M, (const T*)det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, slot,
            (T*)out, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2, pairs_per_block);
    } else {
        const size_t staged = (size_t)m * (m + 1) * sizeof(T);
        const int stage_m = staged <= kStageBytes;
        det_fill_kernel<T, W><<<grid, kFillThreads, stage_m ? staged : 0, stream>>>(
            (const T*)M, (const T*)det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, slot,
            (T*)out, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2, pairs_per_block,
            stage_m);
        return (int)cudaGetLastError();
    }
}

template <typename T>
int dispatch(const void* M, const void* det_always, const int* occ_b, const int* occ_k,
             const int* pr, const int* pc, const int* tab0, const int* tab1, const int* tab2,
             const int* slot, void* out, int G, int m, int w, int R_b, int K_b, int P_b, int n0,
             int n1, int n2, int sel, int D0p1, int D1, int D2, int pairs_per_block,
             cudaStream_t stream) {
#define TF_LAUNCH(WW)                                                                        \
    return launch<T, WW>(M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, slot, out, \
                         G, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,            \
                         pairs_per_block, stream)
    if (w <= 4) TF_LAUNCH(4);
    if (w <= 8) TF_LAUNCH(8);
    if (w <= 16) TF_LAUNCH(16);
    if (w <= 32) TF_LAUNCH(32);
    if (w <= 64) TF_LAUNCH(64);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// `pairs_per_block`: the pairs of one site each block takes
// (kernels.det_fill_geometry); the grid is (ceil(P_b / pairs_per_block), G)
// blocks of 256 threads (64 at W = 64).
extern "C" int tf_det_fill(int dtype, const void* M, const void* det_always, const int* occ_b,
                           const int* occ_k, const int* pr, const int* pc, const int* tab0,
                           const int* tab1, const int* tab2, const int* slot, void* out, int G,
                           int m, int w, int R_b, int K_b, int P_b, int n0, int n1, int n2,
                           int sel, int D0p1, int D1, int D2, int pairs_per_block,
                           void* stream) {
    if (G == 0 || P_b == 0) return (int)cudaSuccess;
    if (pairs_per_block <= 0) return (int)cudaErrorInvalidValue;
    if (dtype == TF_F64)
        return dispatch<double>(M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, slot, out,
                                G, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
                                pairs_per_block, (cudaStream_t)stream);
    if (dtype == TF_C128)
        return dispatch<c128>(M, det_always, occ_b, occ_k, pr, pc, tab0, tab1, tab2, slot, out,
                              G, m, w, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
                              pairs_per_block, (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

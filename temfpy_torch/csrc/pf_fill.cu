// K3 pf_fill: the pair-Pfaffian fill of the BdG/Pfaffian -> MPS tensor fill.
//
// Replaces temfpy_tpu/ops/pfaffian.py:_pf_pairs_impl / batched_pfaffian_pairs
// (with _derive_pair_indices, symplectic_pad and the Parlett-Reid bodies
// _pfaffian_single / _pfaffian_batch_last), and the "* norm" and scatter of
// temfpy_tpu/pfaffian.py:1241-1375 (scatter_padded).
//
// Per (bra, ket) pair p of site g:
//   r = pr[g, p], c = pc[g, p], nk = cnt_k[g, c], nb = cnt_b[g, r]
//   ix = [pos_k[g, c, :nk], pos_b[g, r, :nb], m, m+1, ...]   (width w)
//   T[g, tab0[..], tab1[..], tab2[..]] = norm[g] * Pf(N_aug[g][ix, ix])
// where N_aug = N + J + ... + J (J = [[0, 1], [-1, 0]]) is never formed.
// Parity-matching pairs have an even tot = nk + nb, so the sentinels form a
// tail of whole J blocks: Pf(A + J + ... + J) = Pf(A) exactly, and with
// partial pivoting no J row is ever picked for a real column (its entries
// there are 0, and a real column with no nonzero gives Pf = 0 at once).  So
// the J tail contributes its exact factor 1: its steps pivot on exact ones
// and update with exact zeros.  Each table is indexed by r or by c
// according to bit i of `sel` ("rc", "rrc", "crr" as for det_fill).  Pad
// pairs (count-0 rows, tot = 0) give 1 and land in the trash row T[g, D0],
// which the wrapper slices off.
//
// Parlett-Reid with partial pivoting, as _pfaffian_single: at step k (even)
// the largest |A[j, k]|, j > k (first on ties), is swapped into row and
// column k+1 (sign flip), the Pfaffian is multiplied by A[k, k+1], and the
// trailing block takes the rank-2 skew update
//   A[i, j] += u[i] A[j, k+1] - A[i, k+1] u[j],  u = A[k, :] / A[k, k+1].
// A zero pivot makes the Pfaffian 0.
//
// What bounds it on the H100: complex128 arithmetic, about tot^3 / 6 entry
// updates of two complex multiply-adds per pair (tot <= 32, <= 16 on the
// main path), and the latency of each pair's serial chain of tot / 2 pivot
// steps.  The first design gave each pair a warp, 4 pairs to a block, with
// the tot x tot matrix in shared memory and common.cuh:warp_parlett_reid:
// per step a 5-round shuffle arg-max, two swap passes and an n^2 / 32
// update loop with `/` and `%` index arithmetic, __syncwarp between the
// phases; at tot <= 16 at least half of each warp idled in every update.
//
// The design: det_fill's (K1) register layout, with a Parlett-Reid of its
// own, in tiers of width.
// - A pair of tot <= TW (a tier: 4, 8, 16) is held by a segment of S
//   lanes (pf_lanes: a thread at 4, 4 lanes at 8, one row a lane at 16),
//   lane s rows s + S q of the TW x TW matrix in registers, every register
//   index a constant; a narrower pair is padded with J blocks (the exact
//   factor 1 of the tail above).  The elimination is
//   common.cuh:segment_parlett_reid: rows keep their logical positions (a
//   pivot exchanges two, and the column half of the swap is a select over
//   constant indices), the pivot search a segmented shuffle arg-max, and
//   the update's column entries A[j, k+1] and u[j] shuffled from the lane
//   that holds row j (each u divided once, by that lane; u[j] = -A[j, k] /
//   A[k, k+1] by skew symmetry), in the first design's products and sums.
// - Pairs of 16 < tot <= 32 (the tier of 32, in launches of template width
//   32 only) keep the first design: a warp per pair, the matrix in shared
//   memory (kWideBytes a warp), common.cuh:warp_parlett_reid, the same
//   values.  In registers this tier spilled at 255 registers and held the
//   whole width-32 kernel, narrow pairs included, to one block an SM; a
//   step's chain there (hypot, shuffles, a complex division, the swap's
//   selects) is long, and a few warps an SM did not hide it (seeded w = 32
//   at 0.19x the first design's speed on an H100).
// - Pairs of one site differ in width (bench config 5's width-16 launches
//   hold mostly tot = 4-8), and a warp's segments run in lockstep: a warp
//   takes its pairs in chunks of 32, sorts each chunk by tot (a counting
//   sort in ballots: no shared memory, no block-wide barrier), and runs the
//   sorted pairs tier by tier, so its rows, columns and steps stop at about
//   each pair's own tot (a narrower pair's J steps multiply by exact ones),
//   on the tier's own segments.  Without the sort and the tiers, every
//   warp ran its template's full width at its widest register layout, and
//   the kernel lost to the first design at tot > 8.
// - The site's N (m x m, padded to stride m + 1) is staged in shared memory
//   once per block where it fits in 48 KB (m <= 54), the block's pairs
//   would gather at least as many entries and the template width is at
//   most 16 (at 32 the wide tier's matrices take the shared memory)
//   (`stage`); a block of 128 threads (64 while a launch would not give
//   every SM a block) takes `pairs_per_block` pairs of one site
//   (kernels.pf_fill_geometry).
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kPfThreads = 128;  // most threads of a block (64 for small launches)
constexpr int kStageBytes = 48 * 1024;
// a warp's matrix, u and index row in the tier of 32 (kernels.PF_WIDE_BYTES)
constexpr int kWideBytes = (32 * 32 + 32) * sizeof(c128) + 32 * sizeof(int);

struct PfArgs {
    const c128* N;
    const double* norm;
    const int *pos_b, *pos_k, *cnt_b, *cnt_k, *pr, *pc, *tab0, *tab1, *tab2;
    c128* out;
    int m, wt, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2, pairs_per_block, stage;
};

// Lanes of a pair's segment in the tier of width TW (pairs with tot <= TW,
// TW <= 16): one row a lane at 16, two at 8, the whole 4 x 4 matrix in a
// thread.
template <int TW>
__host__ __device__ constexpr int pf_lanes() {
    return TW == 4 ? 1 : (TW == 8 ? 4 : 16);
}

// What lane l of a warp holds of pair l of its chunk: ids, ket count, width
// (tot, 0 for a poisoned pair, W + 1 past the chunk), and src: lane t holds
// the lane whose pair has rank t in the chunk sorted by width.
struct Chunk {
    int r, c, nk, key, poison, src;
};

// T[g, tab0[..], tab1[..], tab2[..]] = norm[g] * pf for pair (r, c) of site g.
__device__ __forceinline__ void pf_store(const PfArgs& a, int g, int r, int c, c128 pf) {
    const int c0 = a.tab0[(long long)g * a.n0 + ((a.sel & 1) ? c : r)];
    const int c1 = a.tab1[(long long)g * a.n1 + ((a.sel & 2) ? c : r)];
    const int c2 = a.n2 ? a.tab2[(long long)g * a.n2 + ((a.sel & 4) ? c : r)] : 0;
    a.out[(((long long)g * a.D0p1 + c0) * a.D1 + c1) * a.D2 + c2] = pf * a.norm[g];
}

// The pairs of ranks [lo, hi) of a warp's sorted chunk, all of tot <= TW,
// on segments of pf_lanes<TW>() lanes: gather, Parlett-Reid, scatter.
// Segments past hi compute a copy of the last pair (every lane must join
// the shuffles) and write nothing.
template <int TW>
__device__ __forceinline__ void pf_tier(const PfArgs& a, const c128* Np, int ld, int g,
                                        const Chunk& ch, int lo, int hi) {
    constexpr int S = pf_lanes<TW>();
    constexpr int ROWS = TW / S;      // rows per lane: lane s holds rows s + S q
    constexpr int PER_WARP = 32 / S;  // pairs per warp
    const int lane = threadIdx.x & 31, seg = lane / S, sl = lane % S;
    const c128 one = Num<c128>::one(), zero = Num<c128>::zero();
    const c128 minus_one = c128{-1.0, 0.0};
    // entries past a pair group's steps are never read; set once
    c128 A[ROWS][TW];
#pragma unroll
    for (int q = 0; q < ROWS; ++q)
#pragma unroll
        for (int t = 0; t < TW; ++t) A[q][t] = zero;
    for (int i0 = lo; i0 < hi; i0 += PER_WARP) {
        const int slot = i0 + seg;
        const bool valid = slot < hi;
        const int src = __shfl_sync(kFullMask, ch.src, valid ? slot : hi - 1);
        const int r = __shfl_sync(kFullMask, ch.r, src);
        const int c = __shfl_sync(kFullMask, ch.c, src);
        const int nk = __shfl_sync(kFullMask, ch.nk, src);
        const int real = __shfl_sync(kFullMask, ch.key, src);
        const int poison = __shfl_sync(kFullMask, ch.poison, src);
        const int steps = __reduce_max_sync(kFullMask, real);
        const int* rowb = a.pos_b + ((long long)g * a.R_b + r) * a.wt;
        const int* rowk = a.pos_k + ((long long)g * a.K_b + c) * a.wt;
        int ix[ROWS], pos[ROWS];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            const int t = sl + S * q;
            ix[q] = t < real ? (t < nk ? rowk[t] : rowb[t - nk]) : -1;  // -1: J padding
            pos[q] = t;
        }
#pragma unroll
        for (int t = 0; t < TW; ++t) {
            if (t >= steps) break;
            const int b = seg_shfl<S>(ix[t / S], t % S);
#pragma unroll
            for (int q = 0; q < ROWS; ++q) {
                if (S * q >= steps) break;
                const int e = ix[q], i = sl + S * q;
                c128 v = zero;
                if (e >= 0 && b >= 0)
                    v = Np[e * ld + b];
                else if (e < 0 && b < 0 && (i ^ 1) == t)  // J: +1 above, -1 below
                    v = (i & 1) ? minus_one : one;
                A[q][t] = v;
            }
        }
        c128 pf = segment_parlett_reid<c128, TW, S>(A, pos, steps);
        if (poison) pf = c128{nan(""), nan("")};
        if (valid && sl == 0) pf_store(a, g, r, c, pf);
    }
}

// The pairs of ranks [lo, hi) of a warp's sorted chunk with 16 < tot <= 32,
// one at a time on the whole warp: the tot x tot matrix gathered into the
// warp's shared-memory matrix A (row stride 32), then warp_parlett_reid.
__device__ __forceinline__ void pf_tier_wide(const PfArgs& a, const c128* Np, int ld, int g,
                                             const Chunk& ch, int lo, int hi, c128* A, c128* u,
                                             int* ix) {
    const int lane = threadIdx.x & 31;
    for (int i = lo; i < hi; ++i) {
        const int src = __shfl_sync(kFullMask, ch.src, i);
        const int r = __shfl_sync(kFullMask, ch.r, src);
        const int c = __shfl_sync(kFullMask, ch.c, src);
        const int nk = __shfl_sync(kFullMask, ch.nk, src);
        const int tot = __shfl_sync(kFullMask, ch.key, src);
        const int* rowb = a.pos_b + ((long long)g * a.R_b + r) * a.wt;
        const int* rowk = a.pos_k + ((long long)g * a.K_b + c) * a.wt;
        __syncwarp();  // the previous pair is done with A, u and ix
        if (lane < tot) ix[lane] = lane < nk ? rowk[lane] : rowb[lane - nk];
        __syncwarp();
        for (int e = lane; e < tot * tot; e += 32) {
            const int s = e / tot, t = e % tot;
            A[s * 32 + t] = Np[(long long)ix[s] * ld + ix[t]];
        }
        __syncwarp();
        const c128 pf = warp_parlett_reid<c128, 32>(A, u, tot, lane);
        if (lane == 0) pf_store(a, g, r, c, pf);
    }
}

// Registers are capped for four blocks an SM (128 a thread, a few spilled
// bytes in the tiers of 8 and 16): 16 warps hide more of each step's
// latency, and the main path's pairs are mostly in the tier of 8.  At W =
// 32 the wide tier's shared memory (kWideBytes a warp, first in the
// block's shared memory) holds an SM to three blocks.
template <int W>
__global__ void __launch_bounds__(kPfThreads, 4) pf_fill_kernel(PfArgs a) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int g = blockIdx.y;
    const c128* Np = a.N + (long long)g * a.m * a.m;
    int ld = a.m;
    const int wide_bytes = W == 32 ? (blockDim.x >> 5) * kWideBytes : 0;
    if (a.stage) {
        c128* sN = reinterpret_cast<c128*>(smem_raw + wide_bytes);
        for (int e = threadIdx.x; e < a.m * a.m; e += blockDim.x)
            sN[(e / a.m) * (a.m + 1) + e % a.m] = Np[e];
        __syncthreads();
        Np = sN;
        ld = a.m + 1;
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int p_end = min(a.P_b, (blockIdx.x + 1) * a.pairs_per_block);

    // each warp takes chunks of 32 consecutive pairs of the block's range
    for (int c0 = blockIdx.x * a.pairs_per_block + warp * 32; c0 < p_end; c0 += nwarps * 32) {
        const int n_c = min(32, p_end - c0);
        Chunk ch{0, 0, 0, W + 1, 0, 0};
        if (lane < n_c) {
            const long long gp = (long long)g * a.P_b + c0 + lane;
            ch.r = a.pr[gp];
            ch.c = a.pc[gp];
            ch.nk = a.cnt_k[(long long)g * a.K_b + ch.c];
            const int nb = a.cnt_b[(long long)g * a.R_b + ch.r];
            const int tot = ch.nk + nb;
            // not a pair this kernel was planned for: its entry is poisoned
            // and its segment runs the J padding alone
            ch.poison = tot > W || ch.nk > a.wt || nb > a.wt || (tot & 1);
            ch.key = ch.poison ? 0 : tot;
        }
        // a counting sort of the chunk by width, in ballots (the order of
        // the pairs changes no value)
        int rank = 0;
#pragma unroll
        for (int v = 0; v <= W + 1; ++v) {
            const unsigned mv = __ballot_sync(kFullMask, ch.key == v);
            rank += v < ch.key ? __popc(mv) : (v == ch.key ? __popc(mv & ((1u << lane) - 1u)) : 0);
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) {
            const unsigned mt = __ballot_sync(kFullMask, rank == t);
            if (lane == t) ch.src = __ffs(mt) - 1;
        }
        // the sorted chunk in tiers of width 4, 8, 16, then the wide tier
        const int n4 = W > 4 ? __popc(__ballot_sync(kFullMask, ch.key <= 4)) : n_c;
        pf_tier<4>(a, Np, ld, g, ch, 0, n4);
        if constexpr (W >= 8) {
            const int n8 = W > 8 ? __popc(__ballot_sync(kFullMask, ch.key <= 8)) : n_c;
            pf_tier<8>(a, Np, ld, g, ch, n4, n8);
            if constexpr (W >= 16) {
                const int n16 = W > 16 ? __popc(__ballot_sync(kFullMask, ch.key <= 16)) : n_c;
                pf_tier<16>(a, Np, ld, g, ch, n8, n16);
                if constexpr (W >= 32) {
                    c128* A = reinterpret_cast<c128*>(smem_raw + warp * kWideBytes);
                    pf_tier_wide(a, Np, ld, g, ch, n16, n_c, A, A + 32 * 32,
                                 reinterpret_cast<int*>(A + 32 * 32 + 32));
                }
            }
        }
    }
}

}  // namespace

// `pairs_per_block` (a multiple of `threads`: 32 pairs a warp at a time),
// `threads` and `stage` from kernels.pf_fill_geometry: the grid is
// (ceil(P_b / pairs_per_block), G) blocks of `threads`; `stage` stages the
// site's N in shared memory, after the wide tier's matrices at width > 16.
extern "C" int tf_pf_fill(const void* N, const double* norm, const int* pos_b, const int* pos_k,
                          const int* cnt_b, const int* cnt_k, const int* pr, const int* pc,
                          const int* tab0, const int* tab1, const int* tab2, void* out, int G,
                          int m, int width, int wt, int R_b, int K_b, int P_b, int n0, int n1,
                          int n2, int sel, int D0p1, int D1, int D2, int pairs_per_block,
                          int threads, int stage, void* stream) {
    if (G == 0 || P_b == 0) return (int)cudaSuccess;
    const size_t staged = stage ? (size_t)m * (m + 1) * sizeof(c128) : 0;
    const size_t smem = staged + (width > 16 ? (size_t)(threads / 32) * kWideBytes : 0);
    if (pairs_per_block <= 0 || threads % 32 || threads > kPfThreads ||
        pairs_per_block % threads || staged > kStageBytes)
        return (int)cudaErrorInvalidValue;
    const PfArgs a{(const c128*)N, norm, pos_b, pos_k, cnt_b, cnt_k, pr, pc, tab0, tab1, tab2,
                   (c128*)out, m, wt, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2,
                   pairs_per_block, stage};
    const dim3 grid((P_b + pairs_per_block - 1) / pairs_per_block, G);
    cudaStream_t s = (cudaStream_t)stream;
    if (width <= 4)
        pf_fill_kernel<4><<<grid, threads, smem, s>>>(a);
    else if (width <= 8)
        pf_fill_kernel<8><<<grid, threads, smem, s>>>(a);
    else if (width <= 16)
        pf_fill_kernel<16><<<grid, threads, smem, s>>>(a);
    else if (width <= 32) {
        const cudaError_t err = cudaFuncSetAttribute(
            pf_fill_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        pf_fill_kernel<32><<<grid, threads, smem, s>>>(a);
    } else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

// K6b swap_fill: the rank-update (swap) determinant fill of one swap bucket
// of a class, for a group of U such units.
//
// Replaces temfpy_tpu/slater.py:_swap_fill_packed_impl (and its group vmap
// _swap_fill_packed_group), temfpy_tpu/ops/linalg.py:_det_swaps_body,
// _det_swaps_vals_impl and the swap half of _swap_probe_impl.
//
// Per pair p of unit u (s = s_b swaps on each side, a = b = s):
//   r = pr[u, p], c = pc[u, p]
//   rin/rout/rpos = Rin/Rout/Rpos[u, r, :s],  cin/cout/cpos = Cin/...[u, c, :s]
//   K    = I_a + P[rin, rpos] - P[rout, rpos]                      (a x a)
//   Gcr  = G[cpos, rpos]                                            (b x a)
//   D12  = M[rin, cin] - M[rout, cin] - M[rin, cout] + M[rout, cout] (a x b)
//   X    = T2[cpos, cin] - T2[cpos, cout] + Gcr D12                 (b x b)
//   Z    = T3[rin, cin] - T3[rout, cin] - T3[rin, cout] + T3[rout, cout]
//          + (K - I) D12                                            (a x b)
//   S    = [[K, Z], [Gcr, I_b + X]]                                 (2s x 2s)
//   val  = det(S) * D0[u] * sgr[u, r] * sgc[u, c] * det_always[u]
// with the class tables D0, G, P, T2, T3 of swap_tables (K6a) and M_aug =
// diag(M[u], I_w) never formed (common.cuh:identity_ext).  Self-swaps (rin =
// rout) pad a row to s swaps and leave a unit row in [K | Z], so det(S) is
// unchanged.  Scatter mode: val goes to out[slot[u], tab0[..], tab1[..],
// tab2[..]] (each table indexed by r or c by bit i of `sel`, the JAX `spec`:
// "rc", "rrc", "crr"), in the caller's zeroed buffer of bucketed site
// tensors, where the direct fill of the same site writes its own, disjoint
// entries; pad pairs land in the slot's trash row D0p1 - 1, which the
// wrapper slices off.  Values mode: out[u, p] = val (the checked-subset
// probe).
//
// What bounds it on the H100: the latency of small dependent steps.  A
// pair's work is the (2s)^3/3 LU and ~4 s^3 assembly operations after ~10
// s^2 gathers from the unit's tables (a few KB to ~80 KB per class); a
// launch holds 32 (the probe) to ~500,000 pairs.  The first design held S
// in one thread with runtime trip counts, so nvcc put S, D12 and the six
// index rows in local memory (-Xptxas -v, PERF.md), every LU step streamed
// them through L1, and every gather went to global memory: ~15 us a launch
// over a conversion's 1563 launches.
//
// This design (det_fill's, common.cuh:segment_lu_det):
// - S in registers.  A segment of lanes per pair (common.cuh:
//   segment_lanes: one thread up to a bordered width SB2 = 8 in float64,
//   8 lanes of two rows at 16; complex128 halves a lane's rows) holds S
//   padded to the template width SB2 (2, 4, 8, 16) as four SB x SB blocks
//   [[K, Z], [Gcr, I + X]], SB = SB2 / 2, each real s x s in its leading
//   corner and identity rows and columns elsewhere.  So every register
//   index is a constant, and the determinant and its every rounding are
//   those of the 2s x 2s matrix: the same permutation of rows and columns,
//   pad pivots that are exact ones, pad entries that add exact zeros.
// - The LU of det_fill: rows keep their logical positions, the pivot is
//   the first maximal |S[i, k]| in logical order by a segmented shuffle
//   arg-max (the rule of temfpy_tpu/ops/linalg.py:_lu_det_body), a zero
//   pivot gives det 0 with no division, the elimination the first design's
//   operation for operation.  The index rows rin/rout/rpos/cin/cout/cpos
//   sit in registers.
// - The assembly keeps the first design's arithmetic: the same association
//   of the four-term differences, x = x + Gcr D12 and z = z + (K - I) D12
//   in ascending l, formed a column of D12 at a time.
// - The unit's tables are staged in shared memory once per block, by
//   cp.async with every copy in flight, where the block's pairs would
//   gather at least as many entries as the table holds and they fit in 48
//   KB (kernels.swap_fill_geometry); a block loops over `pairs_per_block`
//   pairs of one unit, with 32 to 256 threads by its pairs.  The others
//   are read from global memory (L1/L2).  (Staged with plain loads, a
//   one-warp block of the probe waited on ~90 loads in turn: slower than
//   the first design.)
// On the H100 a conversion's launches take ~11 us each, against ~15 us
// before (PERF.md, section 6): most hold a few thousand pairs, so the chain of
// dependent steps (index rows, gathers, the LU) sets their time, and the
// wrapper's host work sets a small launch's time end to end.
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kSwapThreads = 256;
constexpr int kTables = 5;  // M, G, P, T2, T3: bit t of `stage` stages table t

// a[i] for a runtime i < N with constant register indices
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int i) {
    int v = a[0];
#pragma unroll
    for (int k = 1; k < N; ++k)
        if (i == k) v = a[k];
    return v;
}

// entries of the unit's tables M, G, P, T2, T3
__host__ __device__ inline void table_sizes(int m, int w, long long (&len)[kTables]) {
    const long long ma = m + w;
    len[0] = (long long)m * m;
    len[1] = (long long)w * w;
    len[2] = ma * w;
    len[3] = w * ma;
    len[4] = ma * ma;
}

template <typename T, int SB2>
__global__ void __launch_bounds__(kSwapThreads) swap_fill_kernel(
    const T* __restrict__ M, const T* __restrict__ det_always, const T* __restrict__ D0,
    const T* __restrict__ G, const T* __restrict__ P, const T* __restrict__ T2,
    const T* __restrict__ T3, const int* __restrict__ Rin, const int* __restrict__ Rout,
    const int* __restrict__ Rpos, const double* __restrict__ sgr, const int* __restrict__ Cin,
    const int* __restrict__ Cout, const int* __restrict__ Cpos, const double* __restrict__ sgc,
    const int* __restrict__ pr, const int* __restrict__ pc, const int* __restrict__ tab0,
    const int* __restrict__ tab1, const int* __restrict__ tab2, const int* __restrict__ slot,
    T* __restrict__ out, int m, int w, int R_b, int K_b, int Wr, int Wc, int P_b, int s, int n0,
    int n1, int n2, int sel, int D0p1, int D1, int D2, int scatter, int pairs_per_block,
    int stage) {
    constexpr int SB = SB2 / 2;
    constexpr int S = segment_lanes<T, SB2>();  // lanes per pair
    constexpr int ROWS = SB2 / S;               // rows per lane: lane sl holds rows sl + S q
    constexpr int PER_WARP = 32 / S;            // pairs per warp
    extern __shared__ __align__(16) unsigned char smem_raw[];

    const int u = blockIdx.y;
    const int ma = m + w;
    long long len[kTables];
    table_sizes(m, w, len);
    // the staged tables are copied with cp.async, every copy in flight at
    // once (a block of one warp stages up to ~190 entries a lane)
    const T* tab[kTables] = {M, G, P, T2, T3};
    T* staged = reinterpret_cast<T*>(smem_raw);
#pragma unroll
    for (int t = 0; t < kTables; ++t) {
        tab[t] += u * len[t];
        if (stage >> t & 1) {
            const double* from = reinterpret_cast<const double*>(tab[t]);
            double* to = reinterpret_cast<double*>(staged);
            const long long words = len[t] * (long long)(sizeof(T) / 8);
            for (long long e = threadIdx.x; e < words; e += blockDim.x)
                cp_async8(to + e, from + e, 8);
            tab[t] = staged;
            staged += len[t];
        }
    }
    if (stage) {
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
    }
    const T *Mu = tab[0], *Gu = tab[1], *Pu = tab[2], *T2u = tab[3], *T3u = tab[4];

    const int lane = threadIdx.x & 31, seg = lane / S, sl = lane % S;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const unsigned segmask = S == 32 ? kFullMask : ((1u << S) - 1u) << (seg * S);
    const int p_end = min(P_b, (blockIdx.x + 1) * pairs_per_block);
    const T one = Num<T>::one(), zero = Num<T>::zero();
    const T d0 = D0[u], da = det_always[u];

    // the loop is uniform over a warp; segments past p_end compute a copy
    // of the last pair (every lane must join the shuffles) and write nothing
    for (int p0 = blockIdx.x * pairs_per_block + warp * PER_WARP; p0 < p_end;
         p0 += nwarps * PER_WARP) {
        const int p = p0 + seg;
        const bool valid = p < p_end;
        const long long up = (long long)u * P_b + (valid ? p : p_end - 1);
        const int r = pr[up], c = pc[up];
        const long long ro = ((long long)u * R_b + r) * Wr, co = ((long long)u * K_b + c) * Wc;
        int rin[SB], rout[SB], rpos[SB], cin[SB], cout[SB], cpos[SB];
#pragma unroll
        for (int i = 0; i < SB; ++i) {
            const bool in = i < s;
            rin[i] = in ? Rin[ro + i] : 0;
            rout[i] = in ? Rout[ro + i] : 0;
            rpos[i] = in ? Rpos[ro + i] : 0;
            cin[i] = in ? Cin[co + i] : 0;
            cout[i] = in ? Cout[co + i] : 0;
            cpos[i] = in ? Cpos[co + i] : 0;
        }
        const double sign = sgr[(long long)u * R_b + r] * sgc[(long long)u * K_b + c];

        // left blocks: K (rows t < SB) and Gcr (rows SB + i); a pad row is a
        // row of the identity
        T A[ROWS][SB2];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) {
            const int t = sl + S * q;
            const bool top = t < SB;
            const int i = top ? t : t - SB;
            const int ri = pick(rin, i), rt = pick(rout, i), cp = pick(cpos, i);
#pragma unroll
            for (int j = 0; j < SB; ++j) {
                T v = (t == j) ? one : zero;
                if (i < s)
                    v = j >= s ? zero
                        : top  ? ((i == j ? one : zero) + Pu[ri * w + rpos[j]]) -
                                    Pu[rt * w + rpos[j]]
                               : Gu[cp * w + rpos[j]];
                A[q][j] = v;
            }
        }
        // right blocks, a column j of D12 at a time: Z (top) and I + X
#pragma unroll
        for (int j = 0; j < SB; ++j) {
            T d[SB];
#pragma unroll
            for (int l = 0; l < SB; ++l)
                d[l] = (l < s && j < s) ? ((identity_ext(Mu, m, rin[l], cin[j]) -
                                            identity_ext(Mu, m, rout[l], cin[j])) -
                                           identity_ext(Mu, m, rin[l], cout[j])) +
                                              identity_ext(Mu, m, rout[l], cout[j])
                                        : zero;
#pragma unroll
            for (int q = 0; q < ROWS; ++q) {
                const int t = sl + S * q;
                const bool top = t < SB;
                const int i = top ? t : t - SB;
                T v = (t == SB + j) ? one : zero;
                if (i < s) {
                    v = zero;
                    if (j < s) {
                        T acc = zero;
#pragma unroll
                        for (int l = 0; l < SB; ++l)
                            if (l < s)
                                acc = top ? acc + (A[q][l] - (i == l ? one : zero)) * d[l]
                                          : acc + A[q][l] * d[l];
                        if (top) {
                            const int ri = pick(rin, i), rt = pick(rout, i);
                            v = (((T3u[(long long)ri * ma + cin[j]] -
                                   T3u[(long long)rt * ma + cin[j]]) -
                                  T3u[(long long)ri * ma + cout[j]]) +
                                 T3u[(long long)rt * ma + cout[j]]) + acc;
                        } else {
                            const int cp = pick(cpos, i);
                            const T X = (T2u[(long long)cp * ma + cin[j]] -
                                         T2u[(long long)cp * ma + cout[j]]) + acc;
                            v = (i == j ? one : zero) + X;
                        }
                    }
                }
                A[q][SB + j] = v;
            }
        }

        int pos[ROWS];
#pragma unroll
        for (int q = 0; q < ROWS; ++q) pos[q] = sl + S * q;
        const T val = segment_lu_det<T, SB2, S>(A, pos, seg, segmask) * d0 * sign * da;
        if (!valid || sl != 0) continue;
        if (!scatter) {
            out[(long long)u * P_b + p] = val;
            continue;
        }
        const int c0 = tab0[(long long)u * n0 + ((sel & 1) ? c : r)];
        const int c1 = tab1[(long long)u * n1 + ((sel & 2) ? c : r)];
        const int c2 = n2 ? tab2[(long long)u * n2 + ((sel & 4) ? c : r)] : 0;
        out[(((long long)slot[u] * D0p1 + c0) * D1 + c1) * D2 + c2] = val;
    }
}

template <typename T, int SB2>
int launch(const void* const* ptrs, const int* tabs[4], void* out, int U, int m, int w, int R_b,
           int K_b, int Wr, int Wc, int P_b, int s, int n0, int n1, int n2, int sel, int D0p1,
           int D1, int D2, int scatter, int pairs_per_block, int threads, int stage,
           cudaStream_t stream) {
    long long len[kTables], smem = 0;
    table_sizes(m, w, len);
    for (int t = 0; t < kTables; ++t)
        if (stage >> t & 1) smem += len[t] * (long long)sizeof(T);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    dim3 grid((P_b + pairs_per_block - 1) / pairs_per_block, U);
    swap_fill_kernel<T, SB2><<<grid, threads, (size_t)smem, stream>>>(
        (const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2], (const T*)ptrs[3],
        (const T*)ptrs[4], (const T*)ptrs[5], (const T*)ptrs[6], (const int*)ptrs[7],
        (const int*)ptrs[8], (const int*)ptrs[9], (const double*)ptrs[10], (const int*)ptrs[11],
        (const int*)ptrs[12], (const int*)ptrs[13], (const double*)ptrs[14],
        (const int*)ptrs[15], (const int*)ptrs[16], tabs[0], tabs[1], tabs[2], tabs[3], (T*)out,
        m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2, sel, D0p1, D1, D2, scatter, pairs_per_block,
        stage);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* const* ptrs, const int* tabs[4], void* out, int U, int m, int w,
             int R_b, int K_b, int Wr, int Wc, int P_b, int s, int n0, int n1, int n2, int sel,
             int D0p1, int D1, int D2, int scatter, int pairs_per_block, int threads, int stage,
             cudaStream_t stream) {
#define TF_LAUNCH(SS)                                                                       \
    return launch<T, SS>(ptrs, tabs, out, U, m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2, sel, \
                         D0p1, D1, D2, scatter, pairs_per_block, threads, stage, stream)
    if (s <= 1) TF_LAUNCH(2);
    if (s <= 2) TF_LAUNCH(4);
    if (s <= 4) TF_LAUNCH(8);
    if (s <= 8) TF_LAUNCH(16);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// `pairs_per_block`, `threads` and `stage` (bit t: table t of M, G, P, T2,
// T3 staged in shared memory): kernels.swap_fill_geometry; the grid is
// (ceil(P_b / pairs_per_block), U) blocks of `threads` (32 to 256, a
// multiple of 32).
extern "C" int tf_swap_fill(int dtype, const void* M, const void* det_always, const void* D0,
                            const void* G, const void* P, const void* T2, const void* T3,
                            const int* Rin, const int* Rout, const int* Rpos, const double* sgr,
                            const int* Cin, const int* Cout, const int* Cpos, const double* sgc,
                            const int* pr, const int* pc, const int* tab0, const int* tab1,
                            const int* tab2, const int* slot, void* out, int U, int m, int w,
                            int R_b, int K_b, int Wr, int Wc, int P_b, int s, int n0, int n1,
                            int n2, int sel, int D0p1, int D1, int D2, int scatter,
                            int pairs_per_block, int threads, int stage, void* stream) {
    if (U == 0 || P_b == 0) return (int)cudaSuccess;
    if (s < 1 || s > 8 || s > Wr || s > Wc || pairs_per_block <= 0 || threads < 32 ||
        threads > kSwapThreads || threads % 32 != 0 || stage < 0 || stage >= 1 << kTables)
        return (int)cudaErrorInvalidValue;
    const void* ptrs[17] = {M,   det_always, D0,   G,    P,    T2,  T3,  Rin, Rout,
                            Rpos, sgr,       Cin,  Cout, Cpos, sgc, pr,  pc};
    const int* tabs[4] = {tab0, tab1, tab2, slot};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == TF_F64)
        return dispatch<double>(ptrs, tabs, out, U, m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2,
                                sel, D0p1, D1, D2, scatter, pairs_per_block, threads, stage, st);
    if (dtype == TF_C128)
        return dispatch<c128>(ptrs, tabs, out, U, m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2,
                              sel, D0p1, D1, D2, scatter, pairs_per_block, threads, stage, st);
    return (int)cudaErrorInvalidValue;
}

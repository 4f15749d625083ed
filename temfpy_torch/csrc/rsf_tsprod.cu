// K11b rsf_tsprod: the batched tall-skinny products of the randomized
// spectral frontend, per cut i of a chunk, over the rows of its block
// (the leading s_i rows for side L, the trailing s_i for side R: every
// operand of these products is zero outside them).  Two functions:
//
//   gram:     G_i = A_i^T B_i                       (A_i: L x p, B_i: L x q)
//             with ncol[i] given, columns >= ncol[i] of A and B read as zero
//             and G_i[c, c] += 1 for c >= ncol[i]
//   combine:  mode 0  Y_i = Z_i - A_i S_i           (S_i: p x q)
//             mode 1  Y_i = A_i S_i
//             mode 2  Y_i = A_i S_i diag(d_i),  d = e > f^2 ? 1/sqrt(e) : 0
//             rows outside the block: Z_i (mode 0) or 0
//
// Replaces, in temfpy_tpu/ops/spectral.py:_rsf_chunk_impl, the einsums of
// _corth's Gram (:138) and its Y Q diag(inv) (:139-141, the eigenvalue
// filter folded into mode 2), the deflation's U^T Z and Z - U (U^T Z)
// (:199-203), T = U^T C U (:216), V = U Wv (:223) and CholeskyQR2's Gram
// with its identity pad (:252-254).  Dropped lanes stay exact zero columns:
// mode 2 writes 0 * sum for e <= f^2, and zero columns of A or S contribute
// exact zeros to every sum.
//
// What bounds it on the H100: bytes for the r-wide products (2 s p q
// operations against 8 s (p + q) bytes: 8 operations a byte at p = q = 64,
// below the card's 20 at FP64 peak), operations for the filled sketch's
// rf x rf Gram (2 s rf^2 per cut).  The first design (one 64 x 64 tile per
// block, CUDA-core FMAs, synchronous loads) gave an r-wide Gram of a chunk
// 32 blocks on 132 SMs.  On the same yardstick as torch.bmm (chip_smoke's
// cuda_ms) its 294 calls of phase 9's held chunks took 20.63 ms against
// torch.bmm's 17.30 ms and a 4.73 ms bound (PERF.md, section 6).
//
// This design:
// - Fill the card without reordering a sum.  A Gram with few 64 x 64 tiles
//   (the r-wide ones: 32 a chunk) takes 32 x 32 tiles, four a cut, 32 block
//   rows a stage; the rf-wide ones keep 64 x 64 tiles (kernels.
//   rsf_gram_tile picks).  Every output is one chain of fused multiply-adds
//   over the block rows in ascending order, as the first design and
//   cuBLAS sum it.  A split of the rows over several blocks with a second
//   pass over the partial Grams (tried, PERF.md) rounds differently by
//   ~1e-14, and the randomized frontend, whose self-check is that
//   sensitive on the cuts it rejects, then rerouted 776 of phase 9's 1024
//   cuts (780 disordered) instead of the first design's 786 (785).
// - FP64 tensor cores: 2 x 2 warps, each (T / 2) x (T / 2) of mma.sync
//   m16n8k8 DMMA tiles (common.cuh:warp_dmma_stage).
// - Asynchronous staging: a ring of three stages filled by cp.async
//   (16-byte copies where p, q and the operands allow, else 8-byte ones;
//   common.cuh:cp_async_pipeline), so the next stage loads while DMMA runs
//   on this one.  Rows outside the block and columns past ncol are not
//   read; tiles past ncol write zeros and the pad's ones.
// - Combine: 64 x 64 tiles over the depth p, the same DMMA and ring; tiles
//   wholly outside the block read nothing and copy Z or write zeros; every
//   store and Z load is 16 bytes wide where q allows.
// No allocation, no host sync: the kernels run on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 2 x 2 warps
constexpr int kStages = 3;

// The gram kernel's T x T output tile: depth (block rows) per stage, leading
// dimension of a staged tile (4 mod 16 doubles: no bank conflicts), shared
// memory of the ring.
template <int T>
struct GramTile {
    static constexpr int depth = T == 32 ? 32 : 16;
    static constexpr int ld = T + 4;
    static constexpr int stage = 2 * depth * ld;
    static constexpr int smem = kStages * stage * 8;
};

template <int T, int VEC>
__global__ void __launch_bounds__(kThreads)
    rsf_gram_kernel(const double* __restrict__ A, const double* __restrict__ B,
                    const int* __restrict__ sizes, const int* __restrict__ ncol,
                    double* __restrict__ G, int L, int p, int q, int right) {
    using Tile = GramTile<T>;
    constexpr int MI = T / 32, NI = T / 16;
    extern __shared__ __align__(16) double smem[];
    const int i = blockIdx.z;
    const int a0 = blockIdx.y * T, b0 = blockIdx.x * T;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * (T / 2), wn = (warp & 1) * (T / 2);
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const int nc = ncol ? max(ncol[i], 0) : max(p, q);
    const int pe = min(p, nc), qe = min(q, nc);

    double acc[2 * MI][NI][2] = {};
    if (lo < hi && a0 < pe && b0 < qe) {
        const double* Ai = A + (long long)i * L * p;
        const double* Bi = B + (long long)i * L * q;
        auto rows_a = [&](int l) { return l < hi ? Ai + (long long)l * p : nullptr; };
        auto rows_b = [&](int l) { return l < hi ? Bi + (long long)l * q : nullptr; };
        cp_async_pipeline<kStages>(
            (hi - lo + Tile::depth - 1) / Tile::depth,
            [&](int st, int kt) {
                double* s = smem + st * Tile::stage;
                const int r0 = lo + kt * Tile::depth;
                stage_tile<Tile::depth, T, Tile::ld, VEC>(s, rows_a, A, r0, a0, 0, pe, kThreads);
                stage_tile<Tile::depth, T, Tile::ld, VEC>(s + Tile::depth * Tile::ld, rows_b, B,
                                                          r0, b0, 0, qe, kThreads);
            },
            [&](int st) {
                const double* s = smem + st * Tile::stage;
                warp_dmma_stage<true, MI, NI>(acc, s, Tile::ld, s + Tile::depth * Tile::ld,
                                              Tile::ld, wm, wn, Tile::depth);
            });
    }
    double* o = G + (long long)i * p * q;
#pragma unroll
    for (int r = 0; r < 2 * MI; ++r) {
        const int a = a0 + wm + 8 * r + g;
        if (a >= p) continue;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int b = b0 + wn + 8 * ni + 2 * t + jj;
                if (b >= q) continue;
                const double pad = (ncol && a == b && a >= nc) ? 1.0 : 0.0;
                o[(long long)a * q + b] = acc[r][ni][jj] + pad;
            }
    }
}

constexpr int kT = 64;        // the combine's output tile edge
constexpr int kK = 16;        // its depth per stage
constexpr int kLd = kT + 4;   // its depth-major S tile rows
constexpr int kLdA = kK + 4;  // its row-major A tile rows
constexpr int kCombStage = kT * kLdA + kK * kLd;
constexpr int kCombSmem = kStages * kCombStage * 8;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    rsf_combine_kernel(const double* __restrict__ A, const double* __restrict__ S,
                       const double* __restrict__ Z, const double* __restrict__ e,
                       const int* __restrict__ sizes, double* __restrict__ out, double floor2,
                       int L, int p, int q, int right, int mode) {
    extern __shared__ __align__(16) double smem[];
    const int i = blockIdx.z;
    const int l0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    int lo, hi;
    rsf_block_rows(L, sizes[i], right, &lo, &hi);
    const bool live = l0 < hi && l0 + kT > lo && p > 0;

    double acc[4][4][2] = {};
    if (live) {
        const double* Ai = A + (long long)i * L * p;
        const double* Si = S + (long long)i * p * q;
        auto rows_a = [&](int l) {
            return (l >= lo && l < hi) ? Ai + (long long)l * p : nullptr;
        };
        auto rows_s = [&](int k) { return k < p ? Si + (long long)k * q : nullptr; };
        cp_async_pipeline<kStages>(
            (p + kK - 1) / kK,
            [&](int st, int kt) {
                double* s = smem + st * kCombStage;
                stage_tile<kT, kK, kLdA, VEC>(s, rows_a, A, l0, kt * kK, 0, p, kThreads);
                stage_tile<kK, kT, kLd, VEC>(s + kT * kLdA, rows_s, S, kt * kK, c0, 0, q,
                                             kThreads);
            },
            [&](int st) {
                const double* s = smem + st * kCombStage;
                warp_dmma_stage<false>(acc, s, kLdA, s + kT * kLdA, kLd, wm, wn, kK);
            });
    }
    const long long base = (long long)i * L * q;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int l = l0 + wm + 8 * mi + g;
        if (l >= L) continue;
        const bool in = l >= lo && l < hi;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int c = c0 + wn + 8 * ni + 2 * t;
            if (c >= q) continue;
            const long long at = base + (long long)l * q + c;
            double z[2] = {0.0, 0.0}, v[2];
            if (mode == 0) {
                if (VEC == 2) {
                    const double2 zz = *reinterpret_cast<const double2*>(Z + at);
                    z[0] = zz.x;
                    z[1] = zz.y;
                } else {
                    z[0] = Z[at];
                    if (c + 1 < q) z[1] = Z[at + 1];
                }
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                double d = 1.0;
                if (mode == 2 && c + jj < q) {
                    const double ev = e[(long long)i * q + c + jj];
                    d = ev > floor2 ? 1.0 / sqrt(ev) : 0.0;
                }
                if (mode == 0)
                    v[jj] = in ? z[jj] - acc[mi][ni][jj] : z[jj];
                else
                    v[jj] = in ? acc[mi][ni][jj] * d : 0.0;
            }
            if (VEC == 2) {
                *reinterpret_cast<double2*>(out + at) = make_double2(v[0], v[1]);
            } else {
                out[at] = v[0];
                if (c + 1 < q) out[at + 1] = v[1];
            }
        }
    }
}

// One 16 x 8 x 8 DMMA product D = A B (A 16 x 8, B 8 x 8, row-major) by one
// warp: the fragment layout of common.cuh:dmma_16x8x8, held by the tests.
__global__ void dmma_probe_kernel(const double* __restrict__ A, const double* __restrict__ B,
                                  double* __restrict__ D) {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    const double a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                         A[(g + 8) * 8 + t + 4]};
    const double b[2] = {B[t * 8 + g], B[(t + 4) * 8 + g]};
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    dmma_16x8x8(d[0], d[1], d[2], d[3], a, b);
    D[g * 8 + 2 * t] = d[0];
    D[g * 8 + 2 * t + 1] = d[1];
    D[(g + 8) * 8 + 2 * t] = d[2];
    D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

template <int T>
cudaError_t launch_gram(bool vec, cudaStream_t st, const double* A, const double* B,
                        const int* sizes, const int* ncol, double* G, int m, int L, int p, int q,
                        int right) {
    const dim3 grid((q + T - 1) / T, (p + T - 1) / T, m);
    constexpr int smem = GramTile<T>::smem;
    return vec ? launch_dynamic_smem<rsf_gram_kernel<T, 2>>(grid, kThreads, smem, st, A, B,
                                                            sizes, ncol, G, L, p, q, right)
               : launch_dynamic_smem<rsf_gram_kernel<T, 1>>(grid, kThreads, smem, st, A, B,
                                                            sizes, ncol, G, L, p, q, right);
}

}  // namespace

extern "C" int tf_rsf_gram(const double* A, const double* B, const int* sizes, const int* ncol,
                           double* G, int m, int L, int p, int q, int right, int tile,
                           void* stream) {
    if (m == 0 || p == 0 || q == 0) return (int)cudaSuccess;
    if (tile != 32 && tile != 64) return (int)cudaErrorInvalidValue;
    const bool vec = p % 2 == 0 && q % 2 == 0 && aligned16(A) && aligned16(B);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(tile == 32
                     ? launch_gram<32>(vec, st, A, B, sizes, ncol, G, m, L, p, q, right)
                     : launch_gram<64>(vec, st, A, B, sizes, ncol, G, m, L, p, q, right));
}

extern "C" int tf_rsf_combine(const double* A, const double* S, const double* Z, const double* e,
                              const int* sizes, double* out, double floor, int m, int L, int p,
                              int q, int right, int mode, void* stream) {
    if (m == 0 || L == 0 || q == 0) return (int)cudaSuccess;
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    const dim3 grid((q + kT - 1) / kT, (L + kT - 1) / kT, m);
    const bool vec = p % 2 == 0 && q % 2 == 0 && aligned16(A) && aligned16(S) && aligned16(Z) &&
                     aligned16(out);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(vec ? launch_dynamic_smem<rsf_combine_kernel<2>>(
                           grid, kThreads, kCombSmem, st, A, S, Z, e, sizes, out, floor * floor,
                           L, p, q, right, mode)
                     : launch_dynamic_smem<rsf_combine_kernel<1>>(
                           grid, kThreads, kCombSmem, st, A, S, Z, e, sizes, out, floor * floor,
                           L, p, q, right, mode));
}

extern "C" int tf_dmma_probe(const double* A, const double* B, double* D, void* stream) {
    dmma_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(A, B, D);
    return (int)cudaGetLastError();
}

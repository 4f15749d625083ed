// K11a rsf_apply: the masked operator products of the randomized spectral
// frontend, per cut i of a chunk
//   out_i = M_out (C (M_in X_i)),
// with C the (L x L) correlation matrix and X_i an (L x n) column block.
//
// Replaces the closures capp, mtapp and mapp of
// temfpy_tpu/ops/spectral.py:_rsf_chunk_impl (:182-195) and the filled
// sketch's capp (:250).  The masks are row ranges derived from the cut's
// block size s_i and the side (block = the leading s rows for side L, the
// trailing s rows for side R; complement = the other rows), never a float
// mask array:
//   mode 0 capp  (C_LL V):    in = block,      out = block
//   mode 1 mtapp (C_LR^T V):  in = block,      out = complement
//   mode 2 mapp  (C_LR W):    in = complement, out = block
// X may be one (L x n) block shared by every cut (x_shared: the random
// sketches), and ncol[i], where given, zeroes input columns >= ncol[i] (the
// filled sketch's n_f columns).
//
// What bounds it on the H100: float64 operations.  At the main path's
// shapes (L = 1024, chunks of m = 32 cuts, n = 64 sketch columns, n = 512
// for the filled sketch) a capp on s rows does 2 s^2 n operations against
// ~8 (s + L) n bytes of X and out (32 operations a byte at s = 512, n = 64,
// above the card's 20 at the FP64 peak), mapp and mtapp 2 s (L - s) n;
// small blocks are bound by the bytes of their zero-filled outputs.  The
// first design (one 64 x 64 tile a block, 4 x 4 CUDA-core FMA sums a
// thread, synchronous 16-deep staging behind two barriers) ran at ~8
// TFLOP/s, an eighth of the DMMA peak the bound counts (PERF.md).
//
// This design:
// - FP64 tensor cores.  A block of 2 x 2 warps computes a 64 x 64 output
//   tile, each warp 32 x 32 as 2 x 4 mma.sync m16n8k8 DMMA tiles
//   (common.cuh:warp_dmma_stage, C row-major as A, X depth-major as B).
//   64 x 64 because a chunk's live tiles then number ~8 a cut at the
//   central blocks (256 at n = 64, 2048 at n = 512): two or more a SM
//   without shrinking a warp's tile, whose fragment loads already take
//   half the shared-memory bandwidth the DMMAs need.
// - Asynchronous staging: a ring of three 16-deep stages filled by
//   cp.async (16-byte copies where L, n and the operands allow, else 8;
//   common.cuh:stage_tile, cp_async_pipeline), 56.8 KB (146 registers a
//   thread hold a SM to three blocks), so the next stage loads while DMMA
//   runs on this one.
// - Each output keeps the first design's sum: one chain of fused
//   multiply-adds over the input range in ascending order from 0, never
//   split over blocks or warps (the frontend's self-check turns a 1e-14
//   change into other reroute decisions; PERF.md, section 6).  The depth loop
//   covers only [in_lo, in_hi), from in_lo rounded down to even so that
//   16-byte copies stay aligned: X rows outside the range are not read and
//   stage as exact zeros, so the entries of C a straddling 16-byte chunk
//   brings in (C[a, in_lo - 1]) add exact zero products, which leave every
//   sum unchanged.  Rows of C outside M_out are not read either.
// - Output tiles outside M_out, or past the live columns (ncol), do no
//   product and write exact zeros (16-byte stores).
// - The tail: block x is the cut, block z the row tile counted from the
//   cut's first output tile, so a launch dispatches row tile z of every cut
//   before z + 1 and each cut's live tiles before its zero tiles; cuts run
//   deepest first where a chunk's depths rise with the cut index
//   (consecutive cuts: sizes are monotone).
// On the H100 this runs phase 9's held chunks ~1.6-1.8x faster than the
// first design at ~20 % of the DMMA bound (PERF.md, section 6): each warp's
// sixteen fragment loads from shared memory per eight DMMAs, and a chunk's
// ~2 live tiles a SM, leave the tensor cores waiting.
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 2 x 2 warps, 32 x 32 outputs each
constexpr int kStages = 3;
constexpr int kT = 64;         // output tile edge (rows of C, columns of X)
constexpr int kK = 16;         // depth per stage
constexpr int kLdA = kK + 4;   // row-major C tile rows (4 mod 16: no bank conflicts)
constexpr int kLdB = kT + 4;   // depth-major X tile rows
constexpr int kStage = kT * kLdA + kK * kLdB;
constexpr int kSmem = kStages * kStage * 8;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    rsf_apply_kernel(const double* __restrict__ C, const double* __restrict__ X, int x_shared,
                     const int* __restrict__ sizes, const int* __restrict__ ncol,
                     double* __restrict__ out, int m, int L, int n, int right, int mode) {
    extern __shared__ __align__(16) double smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    auto depth_of = [&](int s) { return mode == 2 ? L - s : s; };
    const bool rising = depth_of(sizes[m - 1]) > depth_of(sizes[0]);
    const int i = rising ? m - 1 - (int)blockIdx.x : (int)blockIdx.x;

    int blo, bhi;
    rsf_block_rows(L, sizes[i], right, &blo, &bhi);
    // complement rows: [0, blo) for side R, [bhi, L) for side L
    const int clo = right ? 0 : bhi, chi = right ? blo : L;
    const int in_lo = mode == 2 ? clo : blo, in_hi = mode == 2 ? chi : bhi;
    const int out_lo = mode == 1 ? clo : blo, out_hi = mode == 1 ? chi : bhi;
    const int nc = ncol ? min(ncol[i], n) : n;
    const int row_tiles = (L + kT - 1) / kT;
    const int a0 = ((min(out_lo, L - 1) / kT + (int)blockIdx.z) % row_tiles) * kT;
    const int c0 = blockIdx.y * kT;
    const bool live = a0 < out_hi && a0 + kT > out_lo && in_lo < in_hi && c0 < nc;

    double acc[4][4][2] = {};
    if (live) {
        const double* Xi = X + (x_shared ? 0LL : (long long)i * L * n);
        auto rows_c = [&](int a) {
            return (a >= out_lo && a < out_hi) ? C + (long long)a * L : nullptr;
        };
        auto rows_x = [&](int k) {
            return (k >= in_lo && k < in_hi) ? Xi + (long long)k * n : nullptr;
        };
        const int k0 = VEC == 2 ? in_lo & ~1 : in_lo;
        cp_async_pipeline<kStages>(
            (in_hi - k0 + kK - 1) / kK,
            [&](int st, int kt) {
                double* s = smem + st * kStage;
                const int k = k0 + kt * kK;
                stage_tile<kT, kK, kLdA, VEC>(s, rows_c, C, a0, k, in_lo, in_hi, kThreads);
                stage_tile<kK, kT, kLdB, VEC>(s + kT * kLdA, rows_x, C, k, c0, 0, nc, kThreads);
            },
            [&](int st) {
                const double* s = smem + st * kStage;
                warp_dmma_stage<false>(acc, s, kLdA, s + kT * kLdA, kLdB, wm, wn, kK);
            });
    }
    double* o = out + (long long)i * L * n;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int l = a0 + wm + 8 * r + g;
        if (l >= L) continue;
        const bool keep = live && l >= out_lo && l < out_hi;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int c = c0 + wn + 8 * ni + 2 * t;
            if (c >= n) continue;
            const double v0 = keep ? acc[r][ni][0] : 0.0, v1 = keep ? acc[r][ni][1] : 0.0;
            double* at = o + (long long)l * n + c;
            if (VEC == 2) {
                *reinterpret_cast<double2*>(at) = make_double2(v0, v1);
            } else {
                at[0] = v0;
                if (c + 1 < n) at[1] = v1;
            }
        }
    }
}

}  // namespace

extern "C" int tf_rsf_apply(const double* C, const double* X, int x_shared, const int* sizes,
                            const int* ncol, double* out, int m, int L, int n, int right,
                            int mode, void* stream) {
    if (m == 0 || L == 0 || n == 0) return (int)cudaSuccess;
    if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
    // grid: (cut, column tile, row tile counted from the cut's first output tile)
    const dim3 grid(m, (n + kT - 1) / kT, (L + kT - 1) / kT);
    const bool vec = L % 2 == 0 && n % 2 == 0 && aligned16(C) && aligned16(X) && aligned16(out);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(vec ? launch_dynamic_smem<rsf_apply_kernel<2>>(grid, kThreads, kSmem, st, C, X,
                                                                x_shared, sizes, ncol, out, m,
                                                                L, n, right, mode)
                     : launch_dynamic_smem<rsf_apply_kernel<1>>(grid, kThreads, kSmem, st, C, X,
                                                                x_shared, sizes, ncol, out, m,
                                                                L, n, right, mode));
}

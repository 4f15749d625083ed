// K9 fw_frame_slab: per-cut eigenvector frames of the Fishman-White
// frontend, materialised from the resident mode matrix.
//
// Replaces temfpy_tpu/ops/fw.py:_fw_frame_slab.
//
// Inputs: VT (L x L) float64, row j = mode j (V transposed once per sweep, so
// a mode's column of V is a contiguous row here); per cut b of the slab, the
// int32 row flat[b] = [Xidx (kb) | Fidx (fb) | colmap (Wb) | xs | kf | m] and
// the Gram coefficients Cmat[b] (kb x keb), of which only the leading kf
// rows (the cut's real crossing modes) and m columns (its real Gram
// columns) are read.  Output frame b (L x Wb):
//   mask(l)  = l < xs            (side L)   or   l >= L - xs   (side R)
//   ent[l, e] = mask(l) * sum_{k < kf} VT[Xidx[k], l] * Cmat[b, k, e]   e < m
//   one[l, f] = mask(l) * (Fidx[f] >= 0 ? VT[Fidx[f], l] : 0)       f < fb
//   out[b, l, c] = [ent | 0 | one | 0][l, colmap[c]]   (Gram columns m..keb-1
//                                                       and keb + fb -> 0)
//
// What bounds it on the H100: bytes.  A slab at L = 1024 writes its
// (64, 1024, 512) frames, 268 MB (80 us at 3.35 TB/s); the real product,
// 2 xs kf m per cut, is smaller.  The first design (one 64 x 64 tile per
// block, CUDA-core FMAs, 16-deep synchronous loads, the k-loop run to the
// slab's padded kb, Cmat read through colmap one double at a time) took
// 3.32 ms on phase 7's 10 slabs against torch.bmm's 2.13 ms and a 0.441 ms
// bound, both timed alike by chip_smoke's cuda_ms (PERF.md, section 6).
//
// This design:
// - Only the real work: the k-loop stops at the cut's kf and the product's
//   columns at its m (the host packs both, ops/fw.py:fw_frames).  Tiles
//   whose rows are all masked or whose columns hold no real Gram column
//   skip the product.
// - FP64 tensor cores: a 128 (l) x 64 (c) output tile per block, 4 x 2
//   warps of 32 x 32, each 2 x 4 mma.sync m16n8k8 DMMA tiles
//   (common.cuh:warp_dmma_stage).
// - Asynchronous staging: a ring of three 16-deep stages filled by
//   cp.async (common.cuh:cp_async_pipeline): the gathered VT rows (row
//   Xidx[k] is contiguous in l, 16-byte copies, block rows only) and the
//   Cmat rows.  Where colmap maps each Gram column of the tile onto itself
//   (the packing's order, ops/fw.py) Cmat rows are read contiguously with
//   16-byte copies; otherwise column by column through colmap.
// - Stores: every output element written once from the accumulators, 16
//   bytes a thread where Wb allows (a warp covers 8 rows x 64 bytes, whole
//   32-byte sectors); one-sided columns gathered from VT, pad columns and
//   masked rows exact zeros.
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int TL = 128;  // rows (l) per tile
constexpr int TC = 64;   // output columns (c) per tile
constexpr int TK = 16;   // depth (k) per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;  // 4 (l) x 2 (c) warps of 32 x 32
constexpr int kLdA = TL + 4;   // 4 mod 16 doubles: no bank conflicts
constexpr int kLdB = TC + 4;
constexpr int kStage = TK * kLdA + TK * kLdB;
constexpr int kSmem = kStages * kStage * 8;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    fw_frame_slab_kernel(const double* __restrict__ VT, const int* __restrict__ flat,
                         const double* __restrict__ Cmat, double* __restrict__ out, int L,
                         int kb, int keb, int fb, int Wb, int right) {
    extern __shared__ __align__(16) double smem[];
    __shared__ int s_src[TC];

    const int b = blockIdx.z;
    const int l0 = blockIdx.y * TL, c0 = blockIdx.x * TC;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wl = (warp >> 1) * 32, wc = (warp & 1) * 32;
    const int* fl = flat + (long long)b * (kb + fb + Wb + 3);
    const int* Xidx = fl;
    const int* Fidx = fl + kb;
    const int* colmap = fl + kb + fb;
    const int xs = fl[kb + fb + Wb];
    const int kf = min(max(fl[kb + fb + Wb + 1], 0), kb);
    const int mg = min(max(fl[kb + fb + Wb + 2], 0), keb);
    const int lo = right ? L - xs : 0;  // kept rows: lo <= l < hi
    const int hi = right ? L : xs;
    const double* Cb = Cmat + (long long)b * kb * keb;
    double* ob = out + (long long)b * L * Wb;

    if (tid < TC) s_src[tid] = (c0 + tid < Wb) ? colmap[c0 + tid] : keb + fb;
    __syncthreads();
    const int s_me = tid < TC ? s_src[tid] : -1;
    const bool gram_me = s_me >= 0 && s_me < mg;
    const bool any_gram = __syncthreads_or(gram_me);
    const bool in_place = __syncthreads_and(!gram_me || s_me == c0 + tid);
    const bool live = any_gram && kf > 0 && l0 < hi && l0 + TL > lo;

    double acc[4][4][2] = {};
    if (live) {
        auto rows_v = [&](int k) { return k < kf ? VT + (long long)Xidx[k] * L : nullptr; };
        auto rows_c = [&](int k) { return k < kf ? Cb + (long long)k * keb : nullptr; };
        cp_async_pipeline<kStages>(
            (kf + TK - 1) / TK,
            [&](int st, int kt) {
                double* sA = smem + st * kStage;
                double* sB = sA + TK * kLdA;
                stage_tile<TK, TL, kLdA, VEC>(sA, rows_v, VT, kt * TK, l0, lo, hi, kThreads);
                if (in_place) {
                    stage_tile<TK, TC, kLdB, VEC>(sB, rows_c, Cmat, kt * TK, c0, 0, mg,
                                                  kThreads);
                } else {
                    for (int e = tid; e < TK * TC; e += kThreads) {
                        const int kk = e / TC, cc = e % TC, k = kt * TK + kk, s = s_src[cc];
                        const bool ok = k < kf && s >= 0 && s < mg;
                        cp_async8(sB + kk * kLdB + cc, ok ? Cb + (long long)k * keb + s : Cmat,
                                  ok ? 8 : 0);
                    }
                }
            },
            [&](int st) {
                const double* sA = smem + st * kStage;
                warp_dmma_stage<true>(acc, sA, kLdA, sA + TK * kLdA, kLdB, wl, wc, TK);
            });
    }

#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
        const int l = l0 + wl + 8 * mi + g;
        if (l >= L) continue;
        const bool keep = l >= lo && l < hi;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int cc = wc + 8 * ni + 2 * t, c = c0 + cc;
            if (c >= Wb) continue;
            double v[2] = {0.0, 0.0};
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int s = s_src[cc + jj];
                if (!keep) continue;
                if (s >= 0 && s < mg) {
                    v[jj] = acc[mi][ni][jj];
                } else if (s >= keb && s < keb + fb) {
                    const int f = Fidx[s - keb];
                    if (f >= 0) v[jj] = VT[(long long)f * L + l];
                }
            }
            double* o = ob + (long long)l * Wb + c;
            if (VEC == 2) {
                *reinterpret_cast<double2*>(o) = make_double2(v[0], v[1]);
            } else {
                o[0] = v[0];
                if (c + 1 < Wb) o[1] = v[1];
            }
        }
    }
}

}  // namespace

extern "C" int tf_fw_frame_slab(const double* VT, const int* flat, const double* Cmat,
                                double* out, int B, int L, int kb, int keb, int fb, int Wb,
                                int right, void* stream) {
    if (B == 0 || L == 0 || Wb == 0) return (int)cudaSuccess;
    const dim3 grid((Wb + TC - 1) / TC, (L + TL - 1) / TL, B);
    const bool vec = L % 2 == 0 && keb % 2 == 0 && Wb % 2 == 0 && aligned16(VT) &&
                     aligned16(Cmat) && aligned16(out);
    const cudaStream_t st = (cudaStream_t)stream;
    return (int)(vec ? launch_dynamic_smem<fw_frame_slab_kernel<2>>(
                           grid, kThreads, kSmem, st, VT, flat, Cmat, out, L, kb, keb, fb, Wb,
                           right)
                     : launch_dynamic_smem<fw_frame_slab_kernel<1>>(
                           grid, kThreads, kSmem, st, VT, flat, Cmat, out, L, kb, keb, fb, Wb,
                           right));
}

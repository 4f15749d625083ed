// K9 fw_frame_slab: per-cut eigenvector frames of the Fishman-White
// frontend, materialised from the resident mode matrix.
//
// Replaces temfpy_tpu/ops/fw.py:_fw_frame_slab.
//
// Inputs: VT (L x L) float64, row j = mode j (V transposed once per sweep, so
// a mode's column of V is a contiguous row here); per cut b of the slab, the
// int32 row flat[b] = [Xidx (kb) | Fidx (fb) | colmap (Wb) | xs] and the Gram
// coefficients Cmat[b] (kb x keb).  Output frame b (L x Wb):
//   mask(l)  = l < xs            (side L)   or   l >= L - xs   (side R)
//   ent[l, e] = mask(l) * sum_k VT[Xidx[k], l] * Cmat[b, k, e]      e < keb
//   one[l, f] = mask(l) * (Fidx[f] >= 0 ? VT[Fidx[f], l] : 0)       f < fb
//   out[b, l, c] = [ent | one | 0][l, colmap[c]]    (colmap = keb + fb -> 0)
// Pad entries of Xidx are 0 with zero Cmat rows, so they add nothing.
//
// What bounds it on the H100: float64 arithmetic.  One slab at L = 1024
// with kb = 1024 and keb = 512 is 2 * 64 * 1024 * 1024 * 512 = 6.9e10
// operations against a 268 MB output (about 1 ms at FP64 peak, 0.08 ms of
// HBM).  The design: a tiled gathered product, one 64 x 64 (l, c) output
// tile per block with 16 x 16 threads holding 4 x 4 sums each; per k-step of
// 16, the gathered V rows (contiguous in l, so the loads coalesce) and the
// colmap-gathered Cmat columns sit in shared memory.  Output columns are
// addressed through colmap, so the product writes each frame column in
// place and the one-sided and pad columns are plain gathers in the epilogue.
// Tiles whose rows are all masked, or whose columns hold no Gram column,
// skip the product.  CUDA-core FP64; no tensor cores, no TMA.  No
// allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int TL = 64;  // rows (l) per tile
constexpr int TC = 64;  // output columns (c) per tile
constexpr int TK = 16;  // depth (k) per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fw_frame_slab_kernel(const double* __restrict__ VT, const int* __restrict__ flat,
                         const double* __restrict__ Cmat, double* __restrict__ out, int L,
                         int kb, int keb, int fb, int Wb, int right) {
    __shared__ double As[TK][TL];
    __shared__ double Bs[TK][TC];
    __shared__ int s_src[TC];

    const int b = blockIdx.z;
    const int l0 = blockIdx.y * TL;
    const int c0 = blockIdx.x * TC;
    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int* fl = flat + (long long)b * (kb + fb + Wb + 1);
    const int* Xidx = fl;
    const int* Fidx = fl + kb;
    const int* colmap = fl + kb + fb;
    const int xs = fl[kb + fb + Wb];
    const int lo = right ? L - xs : 0;  // kept rows: lo <= l < hi
    const int hi = right ? L : xs;
    const double* Cb = Cmat + (long long)b * kb * keb;
    double* ob = out + (long long)b * L * Wb;

    if (tid < TC) s_src[tid] = (c0 + tid < Wb) ? colmap[c0 + tid] : keb + fb;
    __syncthreads();
    const bool rows_live = (l0 + TL > lo) && (l0 < hi);
    const int gram = (tid < TC) && (s_src[tid] < keb);
    const bool any_gram = __syncthreads_or(gram) && rows_live;

    double acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;

    if (any_gram) {
        for (int k0 = 0; k0 < kb; k0 += TK) {
            for (int e = tid; e < TK * TL; e += kThreads) {
                const int kk = e / TL, ll = e % TL;
                const int k = k0 + kk, l = l0 + ll;
                As[kk][ll] = (k < kb && l < L) ? VT[(long long)Xidx[k] * L + l] : 0.0;
            }
            for (int e = tid; e < TK * TC; e += kThreads) {
                const int kk = e / TC, cc = e % TC;
                const int k = k0 + kk, s = s_src[cc];
                Bs[kk][cc] = (k < kb && s < keb) ? Cb[(long long)k * keb + s] : 0.0;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TK; ++kk) {
                double a[4], bv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], bv[j], acc[i][j]);
            }
            __syncthreads();
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        if (l >= L) continue;
        const bool keep = (l >= lo) && (l < hi);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int cc = tx + 16 * j;
            const int c = c0 + cc;
            if (c >= Wb) continue;
            const int s = s_src[cc];
            double v = 0.0;
            if (keep) {
                if (s < keb) {
                    v = acc[i][j];
                } else if (s < keb + fb) {
                    const int f = Fidx[s - keb];
                    if (f >= 0) v = VT[(long long)f * L + l];
                }
            }
            ob[(long long)l * Wb + c] = v;
        }
    }
}

}  // namespace

extern "C" int tf_fw_frame_slab(const double* VT, const int* flat, const double* Cmat,
                                double* out, int B, int L, int kb, int keb, int fb, int Wb,
                                int right, void* stream) {
    if (B == 0 || L == 0 || Wb == 0) return (int)cudaSuccess;
    dim3 grid((Wb + TC - 1) / TC, (L + TL - 1) / TL, B);
    fw_frame_slab_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(VT, flat, Cmat, out, L, kb,
                                                                      keb, fb, Wb, right);
    return (int)cudaGetLastError();
}

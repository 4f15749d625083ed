// K2 site_overlap_schur: the per-site orbital overlap and Schur complement
// of the Slater -> MPS tensor fill.
//
// Replaces temfpy_tpu/slater.py:_site_overlap_impl (grouped as
// _site_overlap_group), which calls ops/linalg.py:gauss_solve_det
// (_gauss_solve_det_implicit on accelerators).
//
// Per site g, column i of the bra orbital matrix vb (L x mb) is described by
// (col, kind, row, sign): kind 0 is frame column `col` of frames_b[g], kind 1
// the one-hot vector at `row`, kind 2 zero; the column is multiplied by
// `sign`.  Likewise vk from frames_k[g].  Then
//   O = vb^H vk                                   (mb x mb)
//   left mode:  A = O[:kb, :kb], B = O[:kb, kb:], C = O[kb:, :kb], D = O[kb:, kb:]
//   right mode: A = O[-kb:, -kb:], B = O[-kb:, :-kb], C = O[:-kb, -kb:], D = O[:-kb, :-kb]
//   det_out[g] = det A,  S_out[g] = D - C A^{-1} B     (sb x sb, sb = mb - kb)
// Right mode is left mode on O with rows and columns rotated by sb, so O is
// stored rotated by `off` (0 for left, sb for right) and one code path runs.
// A^{-1} B comes from Gauss-Jordan with partial pivoting on [A | B], the
// elimination of temfpy_tpu/ops/linalg.py:gauss_solve_det.
//
// What bounds it on the H100: the overlap's L mb^2 multiply-adds a site
// (85 M at L = 1024, mb = 288) and the elimination's kb^2 mb (19 M at kb =
// 256), 7.7e10 operations in bench config 1's L = 1024 conversion, ~1.2 ms
// at the FP64 tensor-core peak; and the elimination's serial chain of kb
// pivot steps.  The parent design gave each site one block (a group of
// ~60 sites filled under half of the card's 132 SMs), formed O on CUDA
// cores (whole L-long dot products per thread, or 32 x 32 tiles with
// synchronous 16-row steps), searched pivots with one thread, and ran the
// rank-one updates of sites wider than shared memory (mb > 169) through
// L2: 462 ms for the conversion's 70 launches.
//
// The design: two launches.  (1) site_overlap_kernel forms O on a grid of
// (64 x 64 tile of O, site) blocks, hundreds per group: float64 on the
// FP64 tensor cores (mma.sync m16n8k8, common.cuh:dmma_16x8x8) fed from a
// cp.async ring of 16-row stages (6 deep; 3 in complex128, which runs the
// same tiles on CUDA cores), eight warps a block; a one-hot or zero column
// is staged as its values, so it costs no branch in the product, and each
// thread finds its staged column's source once; the signs and the
// rotation are applied in the epilogue; each entry is one chain of fused
// multiply-adds in ascending frame row, as in the parent.  O goes to the
// caller's G x mb x mb workspace.  (2) site_schur_kernel factors [A | B]
// and forms S, one thread-block cluster per site: the cluster's nc blocks
// (kernels.schur_layout, up to 8) each hold a slice of the rows in
// registers (a warp a few rows, a lane a few columns of each), because a
// rank-one update through shared memory (four accesses an entry) set the
// time of a step.  Rows never move: each keeps its logical position, a
// step's pivot is an arg-max over the block's warps, then over the
// cluster's blocks through distributed shared memory (the first maximal
// |a| in logical order wins, as in the parent), every block reads the
// winner's published row and scales it, and updates its own rows: one
// cluster barrier a step, the elimination of the parent operation for
// operation.  Then S = D - C X is a DMMA tile product whose accumulators
// start at D (each entry the parent's chain D - C[i, 0] X[0, j] - ...),
// split over the cluster's warps (CUDA cores for complex128).  An always
// block that no cluster of 8 holds in registers (mb > 512, or kb past 8
// blocks' rows: kb > 256 in float64 at mb 385-512; in complex128 kb > 256
// at mb 257-288, kb > 128 at mb 289-512) takes site_schur_gmem_kernel
// instead, the same elimination with [A | B] in the workspace, one block a
// site: slower, on no site of the main path, but every width runs.  The
// two public wrappers launch the same kernels: site_overlap_schur_gmem
// forces a cluster of at least two blocks.  No allocation, no sync with
// the host: the kernels run on the caller's stream.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// ---- (1) the overlap O = vb^H vk ----

constexpr int kOT = 64;           // O tile edge
constexpr int kOD = 16;           // frame rows per stage
constexpr int kOLd = kOT + 4;     // 4 mod 16 doubles: conflict-free DMMA fragment loads
constexpr int kOThreads = 256;    // eight warps, each 16 x 32 of the tile

// Stages of the cp.async ring (104 KB either way).
template <typename T>
__host__ __device__ constexpr int overlap_stages() {
    return std::is_same<T, double>::value ? 6 : 3;
}

template <typename T>
struct OStage {
    T a[kOD][kOLd];  // bra rows r0 + kk, tile rows t: depth-major
    T b[kOD][kOLd];
};

__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
    cp_async8(dst, src, 8);
}
__device__ __forceinline__ void cp_async_elem(c128* dst, const c128* src) {
    cp_async16(reinterpret_cast<double*>(dst), reinterpret_cast<const double*>(src), 16);
}

// A block walks all L frame rows of its tile in ascending order, so each
// entry of O is one chain of fused multiply-adds, as in the parent: the
// extended-precision holds of ill-conditioned sites depend on it (a split
// of the rows over blocks, summed after, failed one).  Thread tid stages
// tile column tid % 64 of both sides at rows tid / 64 + 4 m of each stage,
// its column's source found once.
template <typename T>
__global__ void __launch_bounds__(kOThreads)
    site_overlap_kernel(const T* __restrict__ frames_b, const T* __restrict__ frames_k, int L,
                        int Wb, int Wk, const int* __restrict__ colb,
                        const int* __restrict__ kindb, const int* __restrict__ rowb,
                        const double* __restrict__ signb, const int* __restrict__ colk,
                        const int* __restrict__ kindk, const int* __restrict__ rowk,
                        const double* __restrict__ signk, int mb, int off, int tiles,
                        T* __restrict__ work) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    OStage<T>* st = reinterpret_cast<OStage<T>*>(smem_raw);
    __shared__ double s_sign[2][kOT];

    const int g = blockIdx.y;
    const int a0 = (blockIdx.x / tiles) * kOT, b0 = (blockIdx.x % tiles) * kOT;
    const long long d0 = (long long)g * mb;
    const int tid = threadIdx.x, t = tid % kOT, kk0 = tid / kOT;
    // this thread's column of each side: kind (2 past mb), source column
    // (kind 0), one-hot row (kind 1)
    int kind[2], row[2];
    const T* src[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int a = (s ? b0 : a0) + t;
        const bool in = a < mb;
        const long long i = d0 + (in ? (a + off) % mb : 0);
        kind[s] = in ? (s ? kindk : kindb)[i] : 2;
        row[s] = in ? (s ? rowk : rowb)[i] : 0;
        src[s] = (s ? frames_k + (long long)g * L * Wk : frames_b + (long long)g * L * Wb) +
                 (in ? (s ? colk : colb)[i] : 0);
        if (kk0 == 0) s_sign[s][t] = in ? (s ? signk : signb)[i] : 0.0;
    }
    __syncthreads();

    const T one = Num<T>::one(), zero = Num<T>::zero();
    auto load = [&](int buf, int kt) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int ld = s ? Wk : Wb;
#pragma unroll
            for (int m = 0; m < kOD / 4; ++m) {
                const int kk = kk0 + 4 * m, r = kt * kOD + kk;
                T* dst = s ? &st[buf].b[kk][t] : &st[buf].a[kk][t];
                if (kind[s] == 0 && r < L)
                    cp_async_elem(dst, src[s] + (long long)r * ld);
                else
                    *dst = (kind[s] == 1 && r == row[s]) ? one : zero;
            }
        }
    };
    const int nk = (L + kOD - 1) / kOD;
    T* O = work + (long long)g * mb * mb;
    const int lane = tid & 31, warp = tid >> 5;
    if constexpr (std::is_same<T, double>::value) {
        const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
        double acc[2][4][2] = {};
        cp_async_pipeline<overlap_stages<T>()>(nk, load, [&](int buf) {
            warp_dmma_stage<true, 1, 4>(acc, &st[buf].a[0][0], kOLd, &st[buf].b[0][0], kOLd, wm,
                                        wn, kOD);
        });
        const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int ta = wm + 8 * r + gq, tb = wn + 8 * ni + 2 * tq + j;
                    if (a0 + ta < mb && b0 + tb < mb)
                        O[(long long)(a0 + ta) * mb + b0 + tb] =
                            acc[r][ni][j] * (s_sign[0][ta] * s_sign[1][tb]);
                }
    } else {
        // complex128 on CUDA cores: thread (ty, tx) keeps tile rows ty + 16 i
        // and columns tx + 16 j
        const int ty = tid / 16, tx = tid % 16;
        T acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = zero;
        cp_async_pipeline<overlap_stages<T>()>(nk, load, [&](int buf) {
#pragma unroll 4
            for (int kk = 0; kk < kOD; ++kk) {
                T a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = Num<T>::conj(st[buf].a[kk][ty + 16 * i]);
#pragma unroll
                for (int j = 0; j < 4; ++j) b[j] = st[buf].b[kk][tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + a[i] * b[j];
            }
        });
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int ta = ty + 16 * i, tb = tx + 16 * j;
                if (a0 + ta < mb && b0 + tb < mb)
                    O[(long long)(a0 + ta) * mb + b0 + tb] =
                        acc[i][j] * (s_sign[0][ta] * s_sign[1][tb]);
            }
    }
}

// ---- (2) Gauss-Jordan on [A | B] and S = D - C X, one cluster per site ----

// S = D - C X from site g's workspace O (X in rows 0..kb-1, columns kb on;
// C and D in rows kb on) into Sg, by warps w0, w0 + nw, ... of the caller's
// nw: float64 as 16 x 8 DMMA tiles, complex128 one entry a thread (CUDA
// cores); either way each entry is the chain D - C[i, 0] X[0, j] - ...
template <typename T>
__device__ __forceinline__ void schur_product(const T* O, int mb, int kb, T* __restrict__ Sg,
                                              int w0, int nw) {
    const int sb = mb - kb, lane = threadIdx.x & 31;
    const T* C = O + (long long)kb * mb;       // C[i, t] = C[i mb + t]
    const T* D = C + kb;                       // D[i, j] = D[i mb + j]
    const T* X = O + kb;                       // X[t, j] = X[t mb + j]
    if constexpr (std::is_same<T, double>::value) {
        // 16 x 8 DMMA tiles of S over the workers' warps; the accumulators
        // start at D and take -C X in ascending t
        const int gq = lane >> 2, tq = lane & 3, tn = (sb + 7) / 8;
        auto at = [&](const double* base, int i, int j, int ni, int nj) {
            return (i < ni && j < nj) ? base[(long long)i * mb + j] : 0.0;
        };
        for (int tile = w0; tile < ((sb + 15) / 16) * tn; tile += nw) {
            const int r0 = (tile / tn) * 16 + gq, c0 = (tile % tn) * 8;
            double d0 = at(D, r0, c0 + 2 * tq, sb, sb), d1 = at(D, r0, c0 + 2 * tq + 1, sb, sb);
            double d2 = at(D, r0 + 8, c0 + 2 * tq, sb, sb);
            double d3 = at(D, r0 + 8, c0 + 2 * tq + 1, sb, sb);
            for (int t0 = 0; t0 < kb; t0 += 8) {
                const double a[4] = {-at(C, r0, t0 + tq, sb, kb), -at(C, r0 + 8, t0 + tq, sb, kb),
                                     -at(C, r0, t0 + tq + 4, sb, kb),
                                     -at(C, r0 + 8, t0 + tq + 4, sb, kb)};
                const double b[2] = {at(X, t0 + tq, c0 + gq, kb, sb),
                                     at(X, t0 + tq + 4, c0 + gq, kb, sb)};
                dmma_16x8x8(d0, d1, d2, d3, a, b);
            }
            const double d[4] = {d0, d1, d2, d3};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = r0 + 8 * (e >> 1), j = c0 + 2 * tq + (e & 1);
                if (i < sb && j < sb) Sg[(long long)i * sb + j] = d[e];
            }
        }
    } else {
        for (int e = 32 * w0 + lane; e < sb * sb; e += 32 * nw) {
            const int i = e / sb, j = e % sb;
            T acc = D[(long long)i * mb + j];
            for (int t = 0; t < kb; ++t)
                acc = acc - C[(long long)i * mb + t] * X[(long long)t * mb + j];
            Sg[e] = acc;
        }
    }
}

// The block's rows of [A | B] live in registers: row w + 16 a of the block
// with warp w, its columns l + 32 b with lane l; common.cuh's
// cluster_gauss_jordan (shared with K4) eliminates them, one cluster barrier
// a step.
template <typename T, int CB>
__global__ void __launch_bounds__(kGJThreads)
    site_schur_kernel(T* __restrict__ work, int mb, int kb, int rpc, T* __restrict__ det_out,
                      T* __restrict__ S_out) {
    constexpr int RA = gj_rows_per_warp<T, CB>();
    cg::cluster_group cluster = cg::this_cluster();
    const int nc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
    const int g = blockIdx.x / nc;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* cand_row = reinterpret_cast<T*>(smem_raw);  // 2 x mb: the block's best row, by parity
    T* pk = cand_row + 2 * mb;                      // the scaled pivot row of a step

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = q * rpc, nrows = max(0, min(kb, row0 + rpc) - row0);
    T* O = work + (long long)g * mb * mb;  // rotated by `off`, from site_overlap_kernel
    const T zero = Num<T>::zero();

    // this thread's part of the block's rows
    T R[RA][CB];
    int posr[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int i = warp + kGJWarps * a;
        posr[a] = i < nrows ? row0 + i : kNone;  // kNone: no row here
#pragma unroll
        for (int b = 0; b < CB; ++b) {
            const int j = lane + 32 * b;
            R[a][b] = (i < nrows && j < mb) ? O[(long long)(row0 + i) * mb + j] : zero;
        }
    }
    const T det = cluster_gauss_jordan<T, CB, RA>(R, posr, kb, mb, cand_row, pk);
    // X = A^{-1} B into the workspace's rows 0..kb-1 by logical position
#pragma unroll
    for (int a = 0; a < RA; ++a)
        if (posr[a] != kNone)
#pragma unroll
            for (int b = 0; b < CB; ++b) {
                const int j = lane + 32 * b;
                if (j >= kb && j < mb) O[(long long)posr[a] * mb + j] = R[a][b];
            }
    if (nc == 1) {
        __syncthreads();  // X is complete
    } else {
        __threadfence();
        cluster.sync();  // X is complete; no block reads another's shared memory past here
    }

    const int sb = mb - kb;
    schur_product(O, mb, kb, S_out + (long long)g * sb * sb, q * kGJWarps + warp, nc * kGJWarps);
    if (q == 0 && tid == 0) det_out[g] = det;
}

// The global-memory elimination, for an always block that no cluster holds
// in registers (kernels.schur_layout gives nc = 0: mb > 512, or more than
// 8 blocks' rows): one block per site, [A | B] left in the workspace
// (common.cuh:gmem_gauss_jordan, the same steps and arithmetic, shared with
// K4); then S = D - C X over the block's warps.
template <typename T>
__global__ void __launch_bounds__(kGJThreads)
    site_schur_gmem_kernel(T* __restrict__ work, int mb, int kb, T* __restrict__ det_out,
                           T* __restrict__ S_out) {
    const int g = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
    T* O = work + (long long)g * mb * mb;
    const T det = gmem_gauss_jordan(O, kb, mb);
    schur_product(O, mb, kb, S_out + (long long)g * (mb - kb) * (mb - kb), warp, kGJWarps);
    if (tid == 0) det_out[g] = det;
}

template <typename T>
int launch(const void* frames_b, const void* frames_k, int G, int L, int Wb, int Wk,
           const int* colb, const int* kindb, const int* rowb, const double* signb,
           const int* colk, const int* kindk, const int* rowk, const double* signk, int mb,
           int kb, int off, int nc, int rpc, int smem, void* work, void* det_out, void* S_out,
           cudaStream_t stream) {
    if (mb > 0) {
        const int tiles = (mb + kOT - 1) / kOT;
        cudaError_t err = launch_dynamic_smem<site_overlap_kernel<T>>(
            dim3(tiles * tiles, G), kOThreads, (int)(overlap_stages<T>() * sizeof(OStage<T>)),
            stream, (const T*)frames_b, (const T*)frames_k, L, Wb, Wk, colb, kindb, rowb, signb,
            colk, kindk, rowk, signk, mb, off, tiles, (T*)work);
        if (err != cudaSuccess) return (int)err;
    }
    if (nc == 0) {
        site_schur_gmem_kernel<T><<<G, kGJThreads, 0, stream>>>((T*)work, mb, kb, (T*)det_out,
                                                                (T*)S_out);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G * nc);
    cfg.blockDim = dim3(kGJThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
#define TF_SCHUR(CB)                                                                      \
    if (mb <= 32 * CB) {                                                                  \
        if (rpc > kGJWarps * gj_rows_per_warp<T, CB>()) return (int)cudaErrorInvalidValue; \
        const cudaError_t e = cudaLaunchKernelEx(&cfg, site_schur_kernel<T, CB>, (T*)work, \
                                                 mb, kb, rpc, (T*)det_out, (T*)S_out);     \
        return (int)(e != cudaSuccess ? e : cudaGetLastError());                          \
    }
    TF_SCHUR(2)
    TF_SCHUR(4)
    TF_SCHUR(9)
    TF_SCHUR(12)
    TF_SCHUR(16)
#undef TF_SCHUR
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// `work` is a G x mb x mb buffer of the frames' dtype, allocated by the
// caller; nc (1..8), rpc and smem are the cluster size, rows per block and
// dynamic shared bytes of the Schur kernel (kernels.schur_layout); nc = 0
// takes the global-memory elimination (rpc and smem unused).
extern "C" int tf_site_overlap_schur(int dtype, const void* frames_b, const void* frames_k,
                                     int G, int L, int Wb, int Wk, const int* colb,
                                     const int* kindb, const int* rowb, const double* signb,
                                     const int* colk, const int* kindk, const int* rowk,
                                     const double* signk, int mb, int kb, int right_mode,
                                     int nc, int rpc, int smem, void* work, void* det_out,
                                     void* S_out, void* stream) {
    if (G == 0) return (int)cudaSuccess;
    if (nc < 0 || nc > 8 || (nc > 0 && (rpc < 0 || (long long)rpc * nc < kb)) ||
        smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    const int off = right_mode ? mb - kb : 0;
    if (dtype == TF_F64)
        return launch<double>(frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb, colk,
                              kindk, rowk, signk, mb, kb, off, nc, rpc, smem, work, det_out,
                              S_out, (cudaStream_t)stream);
    if (dtype == TF_C128)
        return launch<c128>(frames_b, frames_k, G, L, Wb, Wk, colb, kindb, rowb, signb, colk,
                            kindk, rowk, signk, mb, kb, off, nc, rpc, smem, work, det_out, S_out,
                            (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}

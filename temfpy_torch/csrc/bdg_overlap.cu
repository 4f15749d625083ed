// K4 bdg_overlap: the grouped Bogoliubov overlap of the BdG/Pfaffian -> MPS
// tensor fill.
//
// Replaces temfpy_tpu/pfaffian.py:_assemble_N_complex and, in native
// complex128, temfpy_tpu/ops/splitc.py:pf_overlap_kernel /
// _pf_overlap_kernel_half (with _nambu_full; the split (re, im) planes are
// not carried over).
//
// The inputs are the annihilator halves V1h, V2h (2nb x nb) of the
// vacuum-padded bra and ket Nambu mode matrices of each site g; with
// site-interleaved rows the creator column of mode j is the conjugate of
// annihilator column j with even and odd rows swapped, so for Vr = V1^H V2:
//   U*[i, j]          = Vr[nb+i, nb+j] = sum_r V1h[r, i] conj(V2h[r, j])
//   P[a, t]           = Vr[j1[a], nb+t] = sum_r conj(V1h[r, j1[a]]) conj(V2h[r^1, t])
//   Q[t, b]           = Vr[nb+t, j2[b]] = sum_r V1h[r^1, t] V2h[r, j2[b]]
// Gauss-Jordan with partial pivoting on [U* | I] (the elimination of
// temfpy_tpu/ops/linalg.py:gauss_solve_det, first maximal pivot, a zero
// pivot leaves its row unscaled) gives det U* and Ui = U*^-1, then
//   BB = Ui[j2, :] Q,  BA = Ui[j2, j1],  AA = P Ui[:, j1]
//   N = [[ (BB - BB^T)/2, BA ], [ -BA^T, (AA - AA^T)/2 ]]     (k2+k1 square)
//   norm = |det U*|^(1/2), NaN if |det U*| < thresh[g] or not finite.
// The JAX kernel takes the determinant of U = Vr[:nb, :nb]; here U* is the
// entrywise conjugate of U (the creator halves are conjugates), so
// |det U*| = |det U| and one elimination serves the inverse and the norm.
// thresh[g] = max(min_SV^x, 1e-300) with the site's true half size x.
//
// What bounds it on the H100: a serial chain of nb pivot steps per site
// (the arithmetic, ~2 nb^3 complex multiply-adds a site, is small: bench
// config 5's groups need 0.005 ms at the FP64 peak).  The parent design gave
// each site one block (a launch of ~10 sites filled ~10 of the 132 SMs),
// formed the products as whole 2nb-long dot products per thread straight
// from global memory, searched each step's pivot in one thread and ran
// four block barriers a step through shared memory (180 KB at nb = 64:
// one block an SM), and computed each off-diagonal entry of AA and BB
// twice: ~0.44 ms a launch.
//
// The design: two launches on the caller's stream, no allocation, no sync
// with the host.  (1) bdg_products_kernel forms U* (beside its identity:
// [U* | I], nb x 2nb), P and Q into the caller's per-site workspace on a
// grid of (16 x 16 tile, site) blocks, tens per site, each staging 16 frame
// rows a stage through a cp.async ring; each entry is one ascending chain
// in r in the parent's expression (nvcc may still fuse a complex product's
// multiplies and adds otherwise than in the parent's loop: the last bit of
// an entry can differ).
// (2) bdg_eliminate_kernel inverts U* with its rows in registers, one
// thread-block cluster per site (kernels.bdg_overlap_layout, the layout of
// K2's Schur kernel at width nb: one block up to nb = 64, bench config 5's
// widest bucket): common.cuh's cluster_gauss_jordan, shared with K2, in its
// in-place mode: the elimination of [U* | I] with the identity half never
// stored (each step's dead column takes the inverse's new column, which
// gets the operations [U* | I] would give it), so a lane holds nb columns,
// not 2nb; rows keep their logical positions, the pivot is a shuffle
// arg-max over the warps and then over the cluster's blocks, one cluster
// barrier a step.  Ui goes back to the workspace's right half, and the
// block's (cluster's) warps form X_A = P Ui[:, j1] and X_B = Ui[j2, :] Q
// once each (each entry the parent's ascending chain in t, eight loads
// ahead), then N with the antisymmetrisation (X[a, b] - X[b, a]) / 2 in
// the epilogue: the parent's (ab - ba) * 0.5 from the same two chains.  A
// half size that no cluster of 8 holds in registers (nb > 256) takes
// bdg_eliminate_gmem_kernel instead: one block a site, common.cuh's
// gmem_gauss_jordan on [U* | I] in the workspace (the same steps and
// arithmetic), then the same assembly.  What still bounds it: the nb
// serial steps, ~2.5 us each in one block on an H100 (three block
// barriers, two shuffle arg-maxes, the candidates' hypot and a complex
// division a step); one barrier a step, every warp publishing its
// candidate row, measured slower (more shared-memory traffic a step).

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

// ---- (1) the three blocks of Vr that the assembly reads ----

constexpr int kPT = 16;          // tile edge of U*, P and Q
constexpr int kPD = 16;          // frame rows per stage
constexpr int kPStages = 4;      // stages of the cp.async ring (32 KB)
constexpr int kPThreads = kPT * kPT;

struct PStage {
    c128 l[kPD][kPT];  // V1h rows r0 + kk, the tile's left columns
    c128 r[kPD][kPT];  // V2h rows r0 + kk, the tile's right columns
};

// Per-site workspace: [U* | I] (nb x 2nb), P (k1 x nb), Q (nb x k2), X_A
// (k1 x k1), X_B (k2 x k2); kernels.bdg_overlap_workspace mirrors it.
__host__ __device__ __forceinline__ long long ws_entries(int nb, int k1, int k2) {
    return 2LL * nb * nb + (long long)(k1 + k2) * nb + (long long)k1 * k1 + (long long)k2 * k2;
}

// Block x of site g: tiles of U* (tu x tu), then P (tp x tu), then Q
// (tu x tq).  Thread (ty, tx) keeps entry (a0 + ty, b0 + tx); it stages
// stage row ty, tile column tx of both sides.
__global__ void __launch_bounds__(kPThreads)
    bdg_products_kernel(const c128* __restrict__ V1h, const c128* __restrict__ V2h,
                        const int* __restrict__ j1, const int* __restrict__ j2, int nb, int k1,
                        int k2, int tu, int tp, int tq, c128* __restrict__ work) {
    __shared__ PStage st[kPStages];
    const int g = blockIdx.y;
    int x = blockIdx.x, kind, a0, b0, nrow, ncol;
    if (x < tu * tu) {
        kind = 0, a0 = (x / tu) * kPT, b0 = (x % tu) * kPT, nrow = nb, ncol = nb;
    } else if ((x -= tu * tu) < tp * tu) {
        kind = 1, a0 = (x / tu) * kPT, b0 = (x % tu) * kPT, nrow = k1, ncol = nb;
    } else {
        x -= tp * tu;
        kind = 2, a0 = (x / tq) * kPT, b0 = (x % tq) * kPT, nrow = nb, ncol = k2;
    }
    const int w2 = 2 * nb;
    const c128* A1 = V1h + (long long)g * w2 * nb;
    const c128* A2 = V2h + (long long)g * w2 * nb;
    const int tid = threadIdx.x, ty = tid / kPT, tx = tid % kPT;
    // this thread's staged columns: V1h column of tile row a0 + tx (j1 for
    // P), V2h column of tile column b0 + tx (j2 for Q); -1 past the edge
    const int cl = a0 + tx < nrow ? (kind == 1 ? j1[(long long)g * k1 + a0 + tx] : a0 + tx) : -1;
    const int cr = b0 + tx < ncol ? (kind == 2 ? j2[(long long)g * k2 + b0 + tx] : b0 + tx) : -1;

    auto load = [&](int buf, int kt) {
        const int r = kt * kPD + ty;
        const bool in = r < w2;
        cp_async16(reinterpret_cast<double*>(&st[buf].l[ty][tx]),
                   reinterpret_cast<const double*>(in && cl >= 0 ? A1 + (long long)r * nb + cl
                                                                 : A1),
                   in && cl >= 0 ? 16 : 0);
        cp_async16(reinterpret_cast<double*>(&st[buf].r[ty][tx]),
                   reinterpret_cast<const double*>(in && cr >= 0 ? A2 + (long long)r * nb + cr
                                                                 : A2),
                   in && cr >= 0 ? 16 : 0);
    };
    c128 acc = Num<c128>::zero();
    const int sl = kind == 2 ? 1 : 0, sr = kind == 1 ? 1 : 0;  // r^1 on that side
    cp_async_pipeline<kPStages>((w2 + kPD - 1) / kPD, load, [&](int buf) {
#pragma unroll
        for (int kk = 0; kk < kPD; ++kk) {
            const c128 a = st[buf].l[kk ^ sl][ty], b = st[buf].r[kk ^ sr][tx];
            if (kind == 0)
                acc = acc + a * Num<c128>::conj(b);
            else if (kind == 1)
                acc = acc + Num<c128>::conj(a) * Num<c128>::conj(b);
            else
                acc = acc + a * b;
        }
    });
    const int a = a0 + ty, b = b0 + tx;
    if (a >= nrow || b >= ncol) return;
    c128* W = work + (long long)g * ws_entries(nb, k1, k2);
    if (kind == 0) {
        W[(long long)a * w2 + b] = acc;
        W[(long long)a * w2 + nb + b] = a == b ? Num<c128>::one() : Num<c128>::zero();
    } else if (kind == 1) {
        W[(long long)nb * w2 + (long long)a * nb + b] = acc;
    } else {
        W[(long long)nb * w2 + (long long)k1 * nb + (long long)a * k2 + b] = acc;
    }
}

// ---- (2) the elimination and the assembly ----

// X_A and X_B of site g from its workspace, by the caller's warps w0, w0 +
// nw, ...: X_A[a, b] = sum_t P[a, t] Ui[t, j1[b]], X_B[a, b] = sum_t
// Ui[j2[a], t] Q[t, b], each one chain in ascending t (Ui[i, j] at W[i 2nb
// + nb + j]).
__device__ __forceinline__ void bdg_products_x(c128* W, const int* J1, const int* J2, int nb,
                                               int k1, int k2, int w0, int nw) {
    const int w2 = 2 * nb;
    const c128* Ui = W + nb;
    const c128* P = W + (long long)nb * w2;
    const c128* Q = P + (long long)k1 * nb;
    c128* XA = W + (long long)nb * w2 + (long long)(k1 + k2) * nb;
    c128* XB = XA + (long long)k1 * k1;
    const int lane = threadIdx.x & 31;
    for (int e = 32 * w0 + lane; e < k1 * k1 + k2 * k2; e += 32 * nw) {
        c128 acc = Num<c128>::zero();
        if (e < k1 * k1) {
            const int a = e / k1, jb = J1[e % k1];
#pragma unroll 8
            for (int t = 0; t < nb; ++t)
                acc = acc + P[(long long)a * nb + t] * Ui[(long long)t * w2 + jb];
            XA[e] = acc;
        } else {
            const int f = e - k1 * k1, ja = J2[f / k2], b = f % k2;
#pragma unroll 8
            for (int t = 0; t < nb; ++t)
                acc = acc + Ui[(long long)ja * w2 + t] * Q[(long long)t * k2 + b];
            XB[f] = acc;
        }
    }
}

// N of site g (k2 + k1 square) from X_A, X_B and Ui, by the caller's warps.
__device__ __forceinline__ void bdg_assemble_n(const c128* W, const int* J1, const int* J2,
                                               int nb, int k1, int k2, c128* __restrict__ Ng,
                                               int w0, int nw) {
    const int w2 = 2 * nb, m = k1 + k2;
    const c128* Ui = W + nb;
    const c128* XA = W + (long long)nb * w2 + (long long)(k1 + k2) * nb;
    const c128* XB = XA + (long long)k1 * k1;
    const int lane = threadIdx.x & 31;
    for (int e = 32 * w0 + lane; e < m * m; e += 32 * nw) {
        const int a = e / m, b = e % m;
        c128 v;
        if (a < k2 && b < k2) {
            v = (XB[a * k2 + b] - XB[b * k2 + a]) * 0.5;
        } else if (a < k2) {
            v = Ui[(long long)J2[a] * w2 + J1[b - k2]];
        } else if (b < k2) {
            v = -Ui[(long long)J2[b] * w2 + J1[a - k2]];
        } else {
            const int a1 = a - k2, b1 = b - k2;
            v = (XA[a1 * k1 + b1] - XA[b1 * k1 + a1]) * 0.5;
        }
        Ng[e] = v;
    }
}

__device__ __forceinline__ void bdg_norm(c128 det, const double* thresh, int g,
                                         double* norm_out) {
    const double absdet = Num<c128>::mag(det);
    const bool bad = !isfinite(absdet) || absdet < thresh[g];
    norm_out[g] = bad ? nan("") : sqrt(absdet);
}

// One cluster of nc blocks per site: block q holds rows q rpc .. of U*
// (nb columns: the in-place inversion, the identity half never stored) in
// registers, row w + 16 a of the block with warp w, columns l + 32 b with
// lane l.
template <int CB>
__global__ void __launch_bounds__(kGJThreads)
    bdg_eliminate_kernel(c128* __restrict__ work, const int* __restrict__ j1,
                         const int* __restrict__ j2, const double* __restrict__ thresh, int nb,
                         int k1, int k2, int rpc, c128* __restrict__ N_out,
                         double* __restrict__ norm_out) {
    constexpr int RA = gj_rows_per_warp<c128, CB>();
    cg::cluster_group cluster = cg::this_cluster();
    const int nc = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
    const int g = blockIdx.x / nc, w2 = 2 * nb;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    c128* cand_row = reinterpret_cast<c128*>(smem_raw);  // 2 x nb, by step parity
    c128* pk = cand_row + 2 * nb;                         // the scaled pivot row
    int* piv_who = reinterpret_cast<int*>(pk + nb);       // each step's pivot row

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = q * rpc, nrows = max(0, min(nb, row0 + rpc) - row0);
    c128* W = work + (long long)g * ws_entries(nb, k1, k2);
    const c128 zero = Num<c128>::zero();
    c128 R[RA][CB];
    int posr[RA];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
        const int i = warp + kGJWarps * a;
        posr[a] = i < nrows ? row0 + i : kNone;
#pragma unroll
        for (int b = 0; b < CB; ++b) {
            const int j = lane + 32 * b;
            R[a][b] = (i < nrows && j < nb) ? W[(long long)(row0 + i) * w2 + j] : zero;
        }
    }
    const c128 det =
        cluster_gauss_jordan<c128, CB, RA, true>(R, posr, nb, nb, cand_row, pk, piv_who);
    // Ui into the right half of [U* | I]: row posr, column the original row
    // index of the step's pivot
#pragma unroll
    for (int a = 0; a < RA; ++a)
        if (posr[a] != kNone)
#pragma unroll
            for (int b = 0; b < CB; ++b) {
                const int j = lane + 32 * b;
                if (j < nb) {
                    const int who = piv_who[j], orig = (who >> 16) * rpc + (who & 0xffff);
                    W[(long long)posr[a] * w2 + nb + orig] = R[a][b];
                }
            }
    const int* J1 = j1 + (long long)g * k1;
    const int* J2 = j2 + (long long)g * k2;
    auto sync = [&]() {
        if (nc == 1) {
            __syncthreads();
        } else {
            __threadfence();
            cluster.sync();
        }
    };
    sync();  // Ui is complete; no block reads another's shared memory past here
    bdg_products_x(W, J1, J2, nb, k1, k2, q * kGJWarps + warp, nc * kGJWarps);
    sync();  // X_A and X_B are complete
    bdg_assemble_n(W, J1, J2, nb, k1, k2, N_out + (long long)g * (k1 + k2) * (k1 + k2),
                   q * kGJWarps + warp, nc * kGJWarps);
    if (q == 0 && tid == 0) bdg_norm(det, thresh, g, norm_out);
}

// A half size no cluster holds: one block a site, [U* | I] in the workspace
// (the products kernel wrote its identity half).
__global__ void __launch_bounds__(kGJThreads)
    bdg_eliminate_gmem_kernel(c128* __restrict__ work, const int* __restrict__ j1,
                              const int* __restrict__ j2, const double* __restrict__ thresh,
                              int nb, int k1, int k2, c128* __restrict__ N_out,
                              double* __restrict__ norm_out) {
    const int g = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
    c128* W = work + (long long)g * ws_entries(nb, k1, k2);
    const c128 det = gmem_gauss_jordan(W, nb, 2 * nb);
    const int* J1 = j1 + (long long)g * k1;
    const int* J2 = j2 + (long long)g * k2;
    __syncthreads();  // Ui is in place
    bdg_products_x(W, J1, J2, nb, k1, k2, warp, kGJWarps);
    __syncthreads();  // X_A and X_B are complete
    bdg_assemble_n(W, J1, J2, nb, k1, k2, N_out + (long long)g * (k1 + k2) * (k1 + k2), warp,
                   kGJWarps);
    if (tid == 0) bdg_norm(det, thresh, g, norm_out);
}

}  // namespace

// `work` holds G x (2 nb^2 + (k1 + k2) nb + k1^2 + k2^2) complex128 entries,
// allocated by the caller; nc (1..8), rpc and smem are the cluster size,
// rows per block and dynamic shared bytes of the elimination
// (kernels.bdg_overlap_layout); nc = 0 takes the global-memory elimination
// (rpc and smem unused).
extern "C" int tf_bdg_overlap(const void* V1h, const void* V2h, const int* j1, const int* j2,
                              const double* thresh, int G, int nb, int k1, int k2, int nc,
                              int rpc, int smem, void* work, void* N_out, double* norm_out,
                              void* stream) {
    if (G == 0) return (int)cudaSuccess;
    if (nb < 1 || k1 < 0 || k2 < 0 || nc < 0 || nc > 8 ||
        (nc > 0 && (rpc < 0 || (long long)rpc * nc < nb)) || smem > 48 * 1024)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int tu = (nb + kPT - 1) / kPT, tp = (k1 + kPT - 1) / kPT, tq = (k2 + kPT - 1) / kPT;
    bdg_products_kernel<<<dim3(tu * tu + tp * tu + tu * tq, G), kPThreads, 0, st>>>(
        (const c128*)V1h, (const c128*)V2h, j1, j2, nb, k1, k2, tu, tp, tq, (c128*)work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (nc == 0) {
        bdg_eliminate_gmem_kernel<<<G, kGJThreads, 0, st>>>((c128*)work, j1, j2, thresh, nb, k1,
                                                             k2, (c128*)N_out, norm_out);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G * nc);
    cfg.blockDim = dim3(kGJThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
#define TF_BDG(CB)                                                                          \
    if (nb <= 32 * CB) {                                                                    \
        if (rpc > kGJWarps * gj_rows_per_warp<c128, CB>()) return (int)cudaErrorInvalidValue; \
        const cudaError_t e =                                                               \
            cudaLaunchKernelEx(&cfg, bdg_eliminate_kernel<CB>, (c128*)work, j1, j2, thresh, \
                               nb, k1, k2, rpc, (c128*)N_out, norm_out);                   \
        return (int)(e != cudaSuccess ? e : cudaGetLastError());                            \
    }
    TF_BDG(2)
    TF_BDG(4)
    TF_BDG(9)
#undef TF_BDG
    return (int)cudaErrorInvalidValue;
}

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
// the elimination runs on the tot x tot leading block only and the J tail
// contributes its exact factor 1.  Each table is indexed by r or by c
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
// updates of two complex multiply-adds per pair (tot <= 32), and the latency
// of each pair's serial chain of tot / 2 pivot steps.  A w x w complex matrix
// held by one thread spills to local memory (the det_fill kernel loses most
// of its gain that way at w = 32).  The design: one warp per pair, the
// matrix in the warp's slice of shared memory (w x w c128, 4 KB at w = 16),
// the elimination in common.cuh:warp_parlett_reid (the pivot search as a
// warp argmax over shuffles, each step's row/column swap and trailing
// update spread over the 32 lanes, __syncwarp between phases), no
// block-wide synchronisation; N is read from global memory
// (a few KB per site, cached).  The width is a template bound (8, 16, 32).
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // pairs per block

template <int W>
__global__ void pf_fill_kernel(const c128* __restrict__ N, const double* __restrict__ norm,
                               const int* __restrict__ pos_b, const int* __restrict__ pos_k,
                               const int* __restrict__ cnt_b, const int* __restrict__ cnt_k,
                               const int* __restrict__ pr, const int* __restrict__ pc,
                               const int* __restrict__ tab0, const int* __restrict__ tab1,
                               const int* __restrict__ tab2, c128* __restrict__ out, int m,
                               int wt, int R_b, int K_b, int P_b, int n0, int n1, int n2,
                               int sel, int D0p1, int D1, int D2) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    c128* A = reinterpret_cast<c128*>(smem_raw) + warp * W * W;
    c128* u = reinterpret_cast<c128*>(smem_raw) + kWarps * W * W + warp * W;
    int* ix = reinterpret_cast<int*>(reinterpret_cast<c128*>(smem_raw) + kWarps * (W * W + W)) +
              warp * W;

    const int g = blockIdx.y;
    const long long p = (long long)blockIdx.x * kWarps + warp;
    if (p >= P_b) return;  // whole warp: no block-wide barrier follows
    const int r = pr[(long long)g * P_b + p];
    const int c = pc[(long long)g * P_b + p];
    const int nk = cnt_k[(long long)g * K_b + c];
    const int nb = cnt_b[(long long)g * R_b + r];
    const int tot = nk + nb;
    const int* rowb = pos_b + ((long long)g * R_b + r) * wt;
    const int* rowk = pos_k + ((long long)g * K_b + c) * wt;
    const c128* Ng = N + (long long)g * m * m;

    c128 pf = Num<c128>::one();
    if (tot > W || nk > wt || nb > wt || (tot & 1)) {
        // not a pair this kernel was planned for: poison the entry
        pf = c128{nan(""), nan("")};
    } else {
        for (int s = lane; s < tot; s += 32) ix[s] = s < nk ? rowk[s] : rowb[s - nk];
        __syncwarp();
        for (int e = lane; e < tot * tot; e += 32) {
            const int s = e / tot, t = e % tot;
            A[s * W + t] = Ng[(long long)ix[s] * m + ix[t]];
        }
        __syncwarp();
        pf = warp_parlett_reid<c128, W>(A, u, tot, lane);
    }
    if (lane == 0) {
        const int i0 = (sel & 1) ? c : r;
        const int i1 = (sel & 2) ? c : r;
        const int i2 = (sel & 4) ? c : r;
        const int c0 = tab0[(long long)g * n0 + i0];
        const int c1 = tab1[(long long)g * n1 + i1];
        const int c2 = n2 ? tab2[(long long)g * n2 + i2] : 0;
        out[(((long long)g * D0p1 + c0) * D1 + c1) * D2 + c2] = pf * norm[g];
    }
}

template <int W>
int launch(const void* N, const double* norm, const int* pos_b, const int* pos_k,
           const int* cnt_b, const int* cnt_k, const int* pr, const int* pc, const int* tab0,
           const int* tab1, const int* tab2, void* out, int G, int m, int wt, int R_b, int K_b,
           int P_b, int n0, int n1, int n2, int sel, int D0p1, int D1, int D2,
           cudaStream_t stream) {
    const size_t smem = (size_t)kWarps * ((W * W + W) * sizeof(c128) + W * sizeof(int));
    cudaError_t err = cudaFuncSetAttribute(pf_fill_kernel<W>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((P_b + kWarps - 1) / kWarps, G);
    pf_fill_kernel<W><<<grid, 32 * kWarps, smem, stream>>>(
        (const c128*)N, norm, pos_b, pos_k, cnt_b, cnt_k, pr, pc, tab0, tab1, tab2, (c128*)out,
        m, wt, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_pf_fill(const void* N, const double* norm, const int* pos_b, const int* pos_k,
                          const int* cnt_b, const int* cnt_k, const int* pr, const int* pc,
                          const int* tab0, const int* tab1, const int* tab2, void* out, int G,
                          int m, int width, int wt, int R_b, int K_b, int P_b, int n0, int n1,
                          int n2, int sel, int D0p1, int D1, int D2, void* stream) {
    if (G == 0 || P_b == 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
#define TF_LAUNCH(WW)                                                                          \
    return launch<WW>(N, norm, pos_b, pos_k, cnt_b, cnt_k, pr, pc, tab0, tab1, tab2, out, G, m, \
                      wt, R_b, K_b, P_b, n0, n1, n2, sel, D0p1, D1, D2, s)
    if (width <= 8) TF_LAUNCH(8);
    if (width <= 16) TF_LAUNCH(16);
    if (width <= 32) TF_LAUNCH(32);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

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
// What bounds it on the H100: float64 arithmetic of the (2s)^3/3 LU and the
// ~4 s^3 assembly products per pair, and the latency of its ~10 s^2 gathers
// from the tables (a few KB to ~80 KB per class, cached in L1/L2).  The
// design is det_fill's: one thread per pair, S in thread-private memory
// (registers for s <= 2, local memory cached in L1 above), the LU of
// common.cuh (lu_det_private: the JAX pivot rule), no shared memory and no
// synchronisation.  The bordered width is a template bound (2, 4, 8, 16).
// No allocation, no host sync: the kernel runs on the caller's stream.

#include "common.cuh"

namespace {

template <typename T, int SB2>
__global__ void swap_fill_kernel(
    const T* __restrict__ M, const T* __restrict__ det_always, const T* __restrict__ D0,
    const T* __restrict__ G, const T* __restrict__ P, const T* __restrict__ T2,
    const T* __restrict__ T3, const int* __restrict__ Rin, const int* __restrict__ Rout,
    const int* __restrict__ Rpos, const double* __restrict__ sgr, const int* __restrict__ Cin,
    const int* __restrict__ Cout, const int* __restrict__ Cpos, const double* __restrict__ sgc,
    const int* __restrict__ pr, const int* __restrict__ pc, const int* __restrict__ tab0,
    const int* __restrict__ tab1, const int* __restrict__ tab2, const int* __restrict__ slot,
    T* __restrict__ out, int m, int w, int R_b, int K_b, int Wr, int Wc, int P_b, int s, int n0,
    int n1, int n2, int sel, int D0p1, int D1, int D2, int scatter) {
    constexpr int SB = SB2 / 2;
    const int u = blockIdx.y;
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P_b) return;
    const int ma = m + w;
    const int r = pr[(long long)u * P_b + p];
    const int c = pc[(long long)u * P_b + p];
    const T* Mu = M + (long long)u * m * m;
    const T* Gu = G + (long long)u * w * w;
    const T* Pu = P + (long long)u * ma * w;
    const T* T2u = T2 + (long long)u * w * ma;
    const T* T3u = T3 + (long long)u * ma * ma;

    int rin[SB], rout[SB], rpos[SB], cin[SB], cout[SB], cpos[SB];
    for (int i = 0; i < s; ++i) {
        const long long ro = ((long long)u * R_b + r) * Wr + i;
        const long long co = ((long long)u * K_b + c) * Wc + i;
        rin[i] = Rin[ro];
        rout[i] = Rout[ro];
        rpos[i] = Rpos[ro];
        cin[i] = Cin[co];
        cout[i] = Cout[co];
        cpos[i] = Cpos[co];
    }
    const double sign = sgr[(long long)u * R_b + r] * sgc[(long long)u * K_b + c];

    const T one = Num<T>::one(), zero = Num<T>::zero();
    T S[SB2 * SB2];
    T D12[SB * SB];
    for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) {
            // K (top left) and Gcr (bottom left)
            S[i * SB2 + j] =
                ((i == j ? one : zero) + Pu[rin[i] * w + rpos[j]]) - Pu[rout[i] * w + rpos[j]];
            S[(s + i) * SB2 + j] = Gu[cpos[i] * w + rpos[j]];
            D12[i * SB + j] = ((identity_ext(Mu, m, rin[i], cin[j]) -
                                identity_ext(Mu, m, rout[i], cin[j])) -
                               identity_ext(Mu, m, rin[i], cout[j])) +
                              identity_ext(Mu, m, rout[i], cout[j]);
        }
    for (int i = 0; i < s; ++i)
        for (int j = 0; j < s; ++j) {
            T x = Num<T>::zero(), z = Num<T>::zero();
            for (int l = 0; l < s; ++l) {
                x = x + S[(s + i) * SB2 + l] * D12[l * SB + j];
                z = z + (S[i * SB2 + l] - (i == l ? one : zero)) * D12[l * SB + j];
            }
            const T X = (T2u[(long long)cpos[i] * ma + cin[j]] -
                         T2u[(long long)cpos[i] * ma + cout[j]]) + x;
            const T Z = (((T3u[(long long)rin[i] * ma + cin[j]] -
                           T3u[(long long)rout[i] * ma + cin[j]]) -
                          T3u[(long long)rin[i] * ma + cout[j]]) +
                         T3u[(long long)rout[i] * ma + cout[j]]) + z;
            S[i * SB2 + s + j] = Z;
            S[(s + i) * SB2 + s + j] = (i == j ? one : zero) + X;
        }
    const T val = lu_det_private<T, SB2>(S, 2 * s) * D0[u] * sign * det_always[u];

    if (!scatter) {
        out[(long long)u * P_b + p] = val;
        return;
    }
    const int i0 = (sel & 1) ? c : r;
    const int i1 = (sel & 2) ? c : r;
    const int i2 = (sel & 4) ? c : r;
    const int c0 = tab0[(long long)u * n0 + i0];
    const int c1 = tab1[(long long)u * n1 + i1];
    const int c2 = n2 ? tab2[(long long)u * n2 + i2] : 0;
    out[(((long long)slot[u] * D0p1 + c0) * D1 + c1) * D2 + c2] = val;
}

template <typename T, int SB2>
int launch(const void* const* ptrs, const int* tabs[4], void* out, int U, int m, int w, int R_b,
           int K_b, int Wr, int Wc, int P_b, int s, int n0, int n1, int n2, int sel, int D0p1,
           int D1, int D2, int scatter, cudaStream_t stream) {
    const int threads = 128;
    dim3 grid((P_b + threads - 1) / threads, U);
    swap_fill_kernel<T, SB2><<<grid, threads, 0, stream>>>(
        (const T*)ptrs[0], (const T*)ptrs[1], (const T*)ptrs[2], (const T*)ptrs[3],
        (const T*)ptrs[4], (const T*)ptrs[5], (const T*)ptrs[6], (const int*)ptrs[7],
        (const int*)ptrs[8], (const int*)ptrs[9], (const double*)ptrs[10], (const int*)ptrs[11],
        (const int*)ptrs[12], (const int*)ptrs[13], (const double*)ptrs[14],
        (const int*)ptrs[15], (const int*)ptrs[16], tabs[0], tabs[1], tabs[2], tabs[3], (T*)out,
        m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2, sel, D0p1, D1, D2, scatter);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* const* ptrs, const int* tabs[4], void* out, int U, int m, int w,
             int R_b, int K_b, int Wr, int Wc, int P_b, int s, int n0, int n1, int n2, int sel,
             int D0p1, int D1, int D2, int scatter, cudaStream_t stream) {
#define TF_LAUNCH(SS)                                                                       \
    return launch<T, SS>(ptrs, tabs, out, U, m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2, sel, \
                         D0p1, D1, D2, scatter, stream)
    if (s <= 1) TF_LAUNCH(2);
    if (s <= 2) TF_LAUNCH(4);
    if (s <= 4) TF_LAUNCH(8);
    if (s <= 8) TF_LAUNCH(16);
#undef TF_LAUNCH
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tf_swap_fill(int dtype, const void* M, const void* det_always, const void* D0,
                            const void* G, const void* P, const void* T2, const void* T3,
                            const int* Rin, const int* Rout, const int* Rpos, const double* sgr,
                            const int* Cin, const int* Cout, const int* Cpos, const double* sgc,
                            const int* pr, const int* pc, const int* tab0, const int* tab1,
                            const int* tab2, const int* slot, void* out, int U, int m, int w,
                            int R_b, int K_b, int Wr, int Wc, int P_b, int s, int n0, int n1,
                            int n2, int sel, int D0p1, int D1, int D2, int scatter,
                            void* stream) {
    if (U == 0 || P_b == 0) return (int)cudaSuccess;
    if (s < 1 || s > 8 || s > Wr || s > Wc) return (int)cudaErrorInvalidValue;
    const void* ptrs[17] = {M,   det_always, D0,   G,    P,    T2,  T3,  Rin, Rout,
                            Rpos, sgr,       Cin,  Cout, Cpos, sgc, pr,  pc};
    const int* tabs[4] = {tab0, tab1, tab2, slot};
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == TF_F64)
        return dispatch<double>(ptrs, tabs, out, U, m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2,
                                sel, D0p1, D1, D2, scatter, st);
    if (dtype == TF_C128)
        return dispatch<c128>(ptrs, tabs, out, U, m, w, R_b, K_b, Wr, Wc, P_b, s, n0, n1, n2,
                              sel, D0p1, D1, D2, scatter, st);
    return (int)cudaErrorInvalidValue;
}

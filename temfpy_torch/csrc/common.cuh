// Scalar helpers shared by the temfpy_torch kernels: one template
// parameter T is either double or c128 (complex double laid out as
// torch.complex128: real then imaginary part).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct __align__(16) c128 {
    double re, im;
};

__host__ __device__ __forceinline__ c128 operator+(c128 a, c128 b) {
    return c128{a.re + b.re, a.im + b.im};
}
__host__ __device__ __forceinline__ c128 operator-(c128 a, c128 b) {
    return c128{a.re - b.re, a.im - b.im};
}
__host__ __device__ __forceinline__ c128 operator-(c128 a) {
    return c128{-a.re, -a.im};
}
__host__ __device__ __forceinline__ c128 operator*(c128 a, c128 b) {
    return c128{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__host__ __device__ __forceinline__ c128 operator*(c128 a, double s) {
    return c128{a.re * s, a.im * s};
}
__host__ __device__ __forceinline__ c128 operator/(c128 a, c128 b) {
    // Smith's algorithm: no overflow for large |b|
    if (fabs(b.re) >= fabs(b.im)) {
        double r = b.im / b.re, d = b.re + b.im * r;
        return c128{(a.re + a.im * r) / d, (a.im - a.re * r) / d};
    }
    double r = b.re / b.im, d = b.re * r + b.im;
    return c128{(a.re * r + a.im) / d, (a.im * r - a.re) / d};
}

template <typename T>
struct Num;

template <>
struct Num<double> {
    __host__ __device__ static double zero() { return 0.0; }
    __host__ __device__ static double one() { return 1.0; }
    __host__ __device__ static double conj(double x) { return x; }
    __host__ __device__ static double mag(double x) { return fabs(x); }
    __host__ __device__ static bool is_zero(double x) { return x == 0.0; }
};

template <>
struct Num<c128> {
    __host__ __device__ static c128 zero() { return c128{0.0, 0.0}; }
    __host__ __device__ static c128 one() { return c128{1.0, 0.0}; }
    __host__ __device__ static c128 conj(c128 x) { return c128{x.re, -x.im}; }
    __host__ __device__ static double mag(c128 x) { return hypot(x.re, x.im); }
    __host__ __device__ static bool is_zero(c128 x) { return x.re == 0.0 && x.im == 0.0; }
};

// dtype codes passed from Python
enum { TF_F64 = 0, TF_C128 = 1 };

// Block-wide pivot choice: every thread offers (v, i) (v < 0 for none); the
// largest v wins and ties go to the smallest i, so a pivot search whose
// threads scan rows in increasing order picks the FIRST maximal row, the
// rule of temfpy_tpu/ops/linalg.py.  Needs blockDim.x a multiple of 32 and
// at most 1024; all threads must call it.  Returns the winning i.
__device__ __forceinline__ int block_argmax_first(double v, int i) {
    __shared__ double s_v[32];
    __shared__ int s_i[32];
    __shared__ int s_win;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (int d = 16; d > 0; d >>= 1) {
        const double v2 = __shfl_down_sync(0xffffffffu, v, d);
        const int i2 = __shfl_down_sync(0xffffffffu, i, d);
        if (v2 > v || (v2 == v && i2 < i)) {
            v = v2;
            i = i2;
        }
    }
    if (lane == 0) {
        s_v[warp] = v;
        s_i[warp] = i;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double bv = s_v[0];
        int bi = s_i[0];
        for (int w = 1; w < (int)(blockDim.x / 32); ++w)
            if (s_v[w] > bv || (s_v[w] == bv && s_i[w] < bi)) {
                bv = s_v[w];
                bi = s_i[w];
            }
        s_win = bi;
    }
    __syncthreads();
    return s_win;
}

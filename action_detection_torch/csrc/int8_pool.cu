// K2: int8 max pool and K3: int8 average pool, NHWC.
//
// Replace: action_detection_tpu/models/backbones/bn_inception_int8.py,
//   _max_pool_i8 (reduce_window max, -128 init and padding; Caffe-ceil
//   right/bottom padding or a symmetric pad) and
//   _avg_pool_i8_include_pad (s32 window sum, padded cells counted as 0,
//   then clip(round(f32(sum) / k^2), -128, 127) with round half to even);
//   and action_detection_tpu/models/backbones/inception_v3_int8.py,
//   _ForwardOps.max_pool (the same max, VALID: no padding) and
//   _ForwardOps.avg_pool_same (K3's exclude_pad mode: the sum divided by
//   the window's in-image cell count, 9, 6 or 4 for 3x3 SAME; counts
//   _same_pool_counts).
// XLA lowers them on the TPU; torch has no int8 pools on CUDA.
//
// What bounds them on the card: a 3x3 window reads 9 bytes per output
// byte, nearly all from L1/L2, so they are memory- and latency-bound and
// small next to the convs around them. One thread per output element
// (consecutive threads on consecutive channels, so every load and store of
// a warp is one contiguous run) keeps them simple; fusing them into K1's
// input staging is left for later work. K3 divides with __fdiv_rn and
// rounds with rintf, as the JAX package does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct PoolShape {
  int N, H, W, C, Ho, Wo, k, stride, pad_lo;
  int exclude_pad;  // K3: divide by the in-image cell count, not k * k
};

__global__ void __launch_bounds__(kThreads)
int8_max_pool_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                     PoolShape s) {
  const long long total = (long long)s.N * s.Ho * s.Wo * s.C;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % s.C);
    long long t = idx / s.C;
    const int ox = (int)(t % s.Wo);
    t /= s.Wo;
    const int oy = (int)(t % s.Ho);
    const long long n = t / s.Ho;
    int m = -128;
    for (int ky = 0; ky < s.k; ++ky) {
      const int iy = oy * s.stride - s.pad_lo + ky;
      if (iy < 0 || iy >= s.H) continue;
      for (int kx = 0; kx < s.k; ++kx) {
        const int ix = ox * s.stride - s.pad_lo + kx;
        if (ix < 0 || ix >= s.W) continue;
        const int v = x[((n * s.H + iy) * s.W + ix) * s.C + c];
        m = v > m ? v : m;
      }
    }
    out[idx] = (int8_t)m;
  }
}

__global__ void __launch_bounds__(kThreads)
int8_avg_pool_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                     PoolShape s) {
  const long long total = (long long)s.N * s.Ho * s.Wo * s.C;
  const float area = (float)(s.k * s.k);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(idx % s.C);
    long long t = idx / s.C;
    const int ox = (int)(t % s.Wo);
    t /= s.Wo;
    const int oy = (int)(t % s.Ho);
    const long long n = t / s.Ho;
    int sum = 0, cells = 0;
    for (int ky = 0; ky < s.k; ++ky) {
      const int iy = oy * s.stride - s.pad_lo + ky;
      if (iy < 0 || iy >= s.H) continue;
      for (int kx = 0; kx < s.k; ++kx) {
        const int ix = ox * s.stride - s.pad_lo + kx;
        if (ix < 0 || ix >= s.W) continue;
        sum += x[((n * s.H + iy) * s.W + ix) * s.C + c];
        ++cells;
      }
    }
    const float div = s.exclude_pad ? (float)cells : area;
    float v = rintf(__fdiv_rn(__int2float_rn(sum), div));
    v = fminf(fmaxf(v, -128.0f), 127.0f);
    out[idx] = (int8_t)(int)v;
  }
}

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // grid-stride beyond a few waves
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

// x: (N, H, W, C) int8 contiguous; out: (N, Ho, Wo, C) int8. Windows start
// at o * stride - pad_lo; cells outside the input are padding (-128 for the
// max, 0 for the sum, and not counted in the average's divisor when
// exclude_pad). Return the launch's cudaError_t.
extern "C" int adt_int8_max_pool(const void* x, void* out, int N, int H,
                                 int W, int C, int Ho, int Wo, int k,
                                 int stride, int pad_lo, void* stream) {
  PoolShape s{N, H, W, C, Ho, Wo, k, stride, pad_lo, 0};
  const long long total = (long long)N * Ho * Wo * C;
  int8_max_pool_kernel<<<grid_for(total), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), s);
  return (int)cudaGetLastError();
}

extern "C" int adt_int8_avg_pool(const void* x, void* out, int N, int H,
                                 int W, int C, int Ho, int Wo, int k,
                                 int stride, int pad_lo, int exclude_pad,
                                 void* stream) {
  PoolShape s{N, H, W, C, Ho, Wo, k, stride, pad_lo, exclude_pad};
  const long long total = (long long)N * Ho * Wo * C;
  int8_avg_pool_kernel<<<grid_for(total), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), s);
  return (int)cudaGetLastError();
}

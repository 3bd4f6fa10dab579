// A1: the max-pool backward, NHWC, float32 or bfloat16.
//
// Replaces: action_detection_tpu/ops/pool_bwd_pallas.py,
//   max_pool_bwd_pallas (the Pallas kernel _pool_bwd_kernel), which the JAX
//   package reaches through ops/pooling.py:max_pool_2d for strided float
//   pools. Semantics are XLA SelectAndScatter's: dy of each window routes to
//   the FIRST position of the window (row-major) whose value equals the
//   window max; padding never matches. Contributions that land on one input
//   position are summed in float32 and rounded once to the storage dtype.
//
// What bounds it on the card: dx is written once and x, y and dy are read
// from L1/L2 several times (a 3x3 stride-2 window covers an input position
// from at most 2x2 windows, each of which rescans its 9 cells to find its
// first match), so it is memory- and latency-bound. The Pallas kernel needs
// a residue-class (space-to-depth) layout because Mosaic has no strided
// vector access; on the GPU a plain gather does: one thread per INPUT
// element (consecutive threads on consecutive channels, so a warp's loads
// and stores are contiguous runs) visits the windows that cover it, in a
// fixed order, and keeps a float32 sum. No atomics, so the result is
// deterministic, and no scratch buffer. A thread skips a window at once
// when its own value differs from the window max, so the rescan runs only
// for the (rare) positions that hold a max. The index math is what costs:
// 64-bit division is a long instruction sequence and made the first
// version of this kernel slower than torch's own backward. So the element
// index is split into (n, h, w, c) with 32-bit div/mod whenever the
// tensors allow it, and when C % 4 == 0 (every BNInception pool) a thread
// takes 4 channels with one 16-byte (float) or 8-byte (bf16) access per
// tensor, which divides the index work and the memory transactions by 4.
// Each channel still sums its windows in the same order, so both paths
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct BwdShape {
  int N, H, W, C, Ho, Wo, kh, kw, sh, sw, pad_top, pad_left;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 consecutive channels in one access
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&r.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 r;
  *reinterpret_cast<__nv_bfloat162*>(&r.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&r.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = r;
}

// Is (h, w) the first cell of window (iy0, ix0), row-major, whose value
// equals the window max m? xc points at this channel of image n. The scan
// stops at (h, w) at the latest, since x[h, w] == m there.
template <typename T, typename I>
__device__ __forceinline__ bool first_match(const T* xc, float m, int h,
                                            int w, int iy0, int ix0,
                                            const BwdShape& s) {
  for (int ky = 0; ky < s.kh; ++ky) {
    const int iy = iy0 + ky;
    if (iy < 0 || iy >= s.H) continue;
    for (int kx = 0; kx < s.kw; ++kx) {
      const int ix = ix0 + kx;
      if (ix < 0 || ix >= s.W) continue;
      if (iy == h && ix == w) return true;
      if (to_f32(xc[((I)iy * (I)s.W + ix) * (I)s.C]) == m) return false;
    }
  }
  return false;
}

// The output windows (oy0..oy1, ox0..ox1) that cover input (h, w):
// oy*sh - pad_top <= h <= oy*sh - pad_top + kh - 1.
struct Cover {
  int oy0, oy1, ox0, ox1;
};
__device__ __forceinline__ Cover covering(int h, int w, const BwdShape& s) {
  const int hp = h + s.pad_top, wp = w + s.pad_left;
  return {hp >= s.kh ? (hp - s.kh) / s.sh + 1 : 0, min(hp / s.sh, s.Ho - 1),
          wp >= s.kw ? (wp - s.kw) / s.sw + 1 : 0, min(wp / s.sw, s.Wo - 1)};
}

// One thread per input element. I: 32-bit when the tensors have fewer
// than 2^31 elements, else 64-bit.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, T* __restrict__ dx, BwdShape s,
                    I total) {
  const I C = s.C, W = s.W, H = s.H;
  for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (I)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    I t = idx / C;
    const int w = (int)(t % W);
    t /= W;
    const int h = (int)(t % H);
    const I n = t / H;
    const float xv = to_f32(x[idx]);
    const Cover cv = covering(h, w, s);
    const T* xc = x + n * H * W * C + c;
    float acc = 0.0f;
    for (int oy = cv.oy0; oy <= cv.oy1; ++oy) {
      for (int ox = cv.ox0; ox <= cv.ox1; ++ox) {
        const I o = ((n * (I)s.Ho + oy) * (I)s.Wo + ox) * C + c;
        const float m = to_f32(y[o]);
        if (xv == m && first_match<T, I>(xc, m, h, w, oy * s.sh - s.pad_top,
                                         ox * s.sw - s.pad_left, s)) {
          acc += to_f32(dy[o]);
        }
      }
    }
    dx[idx] = from_f32<T>(acc);
  }
}

// One thread per 4 channels of one input pixel (C % 4 == 0, aligned).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd_vec4_kernel(const T* __restrict__ x, const T* __restrict__ y,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         BwdShape s, I total4) {
  const I C = s.C, C4 = s.C / 4, W = s.W, H = s.H;
  for (I q = (I)blockIdx.x * blockDim.x + threadIdx.x; q < total4;
       q += (I)gridDim.x * blockDim.x) {
    const int c = (int)(q % C4) * 4;
    I t = q / C4;
    const int w = (int)(t % W);
    t /= W;
    const int h = (int)(t % H);
    const I n = t / H;
    float xv[4];
    load4(x + q * 4, xv);
    const Cover cv = covering(h, w, s);
    const T* xc = x + n * H * W * C + c;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int oy = cv.oy0; oy <= cv.oy1; ++oy) {
      for (int ox = cv.ox0; ox <= cv.ox1; ++ox) {
        const I o = ((n * (I)s.Ho + oy) * (I)s.Wo + ox) * C + c;
        float m[4];
        load4(y + o, m);
        if (xv[0] != m[0] && xv[1] != m[1] && xv[2] != m[2] &&
            xv[3] != m[3]) {
          continue;
        }
        float d[4];
        load4(dy + o, d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (xv[j] == m[j] &&
              first_match<T, I>(xc + j, m[j], h, w, oy * s.sh - s.pad_top,
                                ox * s.sw - s.pad_left, s)) {
            acc[j] += d[j];
          }
        }
      }
    }
    store4(dx + q * 4, acc);
  }
}

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // grid-stride beyond a few waves
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename T>
void launch(const void* x, const void* y, const void* dy, void* dx,
            const BwdShape& s, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const long long total = (long long)s.N * s.H * s.W * s.C;
  const long long out_total = (long long)s.N * s.Ho * s.Wo * s.C;
  const bool narrow = total < (1LL << 31) && out_total < (1LL << 31);
  const uintptr_t bytes = 4 * sizeof(T);
  const bool vec = s.C % 4 == 0 &&
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)dy | (uintptr_t)dx) % bytes
          == 0;
  if (vec && narrow) {
    max_pool_bwd_vec4_kernel<T, unsigned>
        <<<grid_for(total / 4), kThreads, 0, st>>>(xp, yp, dyp, dxp, s,
                                                   (unsigned)(total / 4));
  } else if (vec) {
    max_pool_bwd_vec4_kernel<T, long long>
        <<<grid_for(total / 4), kThreads, 0, st>>>(xp, yp, dyp, dxp, s,
                                                   total / 4);
  } else if (narrow) {
    max_pool_bwd_kernel<T, unsigned><<<grid_for(total), kThreads, 0, st>>>(
        xp, yp, dyp, dxp, s, (unsigned)total);
  } else {
    max_pool_bwd_kernel<T, long long><<<grid_for(total), kThreads, 0, st>>>(
        xp, yp, dyp, dxp, s, total);
  }
}

}  // namespace

// x, dx: (N, H, W, C); y, dy: (N, Ho, Wo, C); all contiguous, one dtype
// (bf16 when is_bf16, else float32). Window (oy, ox) starts at
// (oy * sh - pad_top, ox * sw - pad_left). Return the launch's cudaError_t.
extern "C" int adt_max_pool_bwd(const void* x, const void* y, const void* dy,
                                void* dx, int N, int H, int W, int C, int Ho,
                                int Wo, int kh, int kw, int sh, int sw,
                                int pad_top, int pad_left, int is_bf16,
                                void* stream) {
  BwdShape s{N, H, W, C, Ho, Wo, kh, kw, sh, sw, pad_top, pad_left};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(x, y, dy, dx, s, st);
  } else {
    launch<float>(x, y, dy, dx, s, st);
  }
  return (int)cudaGetLastError();
}

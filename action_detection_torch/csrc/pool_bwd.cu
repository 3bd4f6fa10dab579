// A1: the max-pool backward, NHWC, float32 or bfloat16.
//
// Replaces: action_detection_tpu/ops/pool_bwd_pallas.py:max_pool_bwd_pallas
//   (the Pallas kernel _pool_bwd_kernel), which the JAX package reaches
//   through ops/pooling.py:max_pool_2d for strided float pools. Semantics
//   are XLA SelectAndScatter's: dy of each window routes to the window's
//   FIRST cell, row-major, whose value equals the window max y. A padding
//   cell never matches: it is excluded by index, never by value. Each input
//   cell sums its contributions in float32 from 0.0f, in ascending (oy, ox)
//   order of the windows that cover it, and rounds once to the storage
//   dtype. No atomics: two runs give the same bits.
//
// What bounds it on this card: bytes. A backward has to read x, y and dy
// and write dx, |x| + |y| + |dy| + |dx|: 9.25 GB at the training step's
// stem pool 1, (1152,112,112,64) float32, or 2.76 ms at 3.35 TB/s, against a
// few compares and adds per element. So every byte should cross HBM once,
// and the rest happens in shared memory:
// - A block owns a tile of input cells of one image (tile_h rows x tile_w
//   columns x a slab of channels) and every window that covers them,
//   including a halo of windows on the low side. blockIdx is (tile, slab,
//   image), the tile fastest, so the halo that a neighbouring block reads
//   too comes from L2. Images go in gridDim.z, up to 65,535 per launch.
// - Stage: x of the tile's windows, and y and dy of the windows, go into
//   shared memory with 16-byte cp.async copies (4 float or 8 bfloat16
//   channels each). Only cells inside the image are copied.
// - Phase 1: a thread takes (window, channel vector), scans the window's
//   cells in shared memory and writes each channel's first-match offset
//   ky*kw + kx (255: none) as one byte into shared memory. A window's first
//   match is computed once, not once per input that holds the max.
// - Phase 2: a thread takes (owned cell, channel vector), walks the windows
//   that cover the cell in (oy, ox) order (row and column tables made once
//   per block), adds dy wherever the window's offset is the cell's own, and
//   stores dx with one 16-byte store. x is not read again.
// The tile arithmetic is kernels/pool_bwd.py:pool_bwd_plan, which passes its
// integers here (struct Plan). Divisions happen once per block; a thread
// walks its cells and windows by adding and subtracting, never by splitting
// a flat index with div/mod. Channel counts that are not a multiple of the
// vector, or tensors that are not 16-byte aligned, run the same kernel with
// one channel per access and plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

// kernels/pool_bwd.py:PLAN_FIELDS, in the same order
struct Plan {
  int N, H, W, C, Ho, Wo, kh, kw, sh, sw, pad_top, pad_left;
  int is_bf16, vec;            // vec: channels per access (16 bytes, or 1)
  int slab, slabs;             // channels per block, slabs per image
  int tile_h, tile_w;          // owned input rows / columns per tile
  int tiles_h, tiles_w;
  int win_h, win_w;            // most windows a tile resolves, per axis
  int xs_h, xs_w;              // most x rows / columns a tile stages
  int block_x, block_y;        // threads: channel vectors x cell lanes
  int smem, y_off, dy_off, fm_off, cov_off;   // bytes
};

constexpr int kThreads = 256;
constexpr int kNoMatch = 255;
constexpr int kMaxImagesPerLaunch = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC channels of one cell as float32: one 16-byte access, or VEC == 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        v[j] = __uint_as_float(w[j]);
      } else {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(p[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_f32(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (sizeof(T) == 4) {
        w[j] = __float_as_uint(v[j]);
      } else {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&b);
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) from_f32(p + j, v[j]);
  }
}

// Global -> shared: a 16-byte cp.async, or plain copies for VEC == 1.
template <typename T, int VEC>
__device__ __forceinline__ void stage(T* s, const T* g) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(__cvta_generic_to_global(g))
                 : "memory");
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = g[j];
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// VEC first-match offsets, one byte each
template <int VEC>
__device__ __forceinline__ void store_offsets(unsigned char* p,
                                              const int (&o)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = static_cast<unsigned char>(o[0]);
  } else {
    uint32_t w[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      w[i] = o[4 * i] | (o[4 * i + 1] << 8) | (o[4 * i + 2] << 16) |
             (o[4 * i + 3] << 24);
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }
}

template <int VEC>
__device__ __forceinline__ void load_offsets(const unsigned char* p,
                                             int (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = p[0];
  } else {
    uint32_t w[VEC / 4];
    if constexpr (VEC == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      w[0] = r.x;
      w[1] = r.y;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = (w[j >> 2] >> ((j & 3) * 8)) & 0xff;
  }
}

// A flat index start, start + step, ... over a row-major range with nb
// columns, walked as (a, b) by subtraction. nb <= 0: an empty walk.
struct Walk {
  int a, b;
  __device__ Walk(int start, int nb) : a(0), b(start) {
    if (nb <= 0) {
      a = INT_MAX;
    } else {
      wrap(nb);
    }
  }
  __device__ void next(int step, int nb) {
    b += step;
    wrap(nb);
  }
  __device__ void wrap(int nb) {
    while (b >= nb) {
      b -= nb;
      ++a;
    }
  }
};

// The first window that covers input index lo: max(0, ceil((lo+pad-k+1)/s))
__device__ __forceinline__ int first_window(int lo, int pad, int k, int s) {
  const int num = lo + pad - k + 1;
  return num <= 0 ? 0 : (num + s - 1) / s;
}

// (first, last) of the tile's nw windows (window w starts at shared index
// w*s) that cover shared index l; first > last when none does.
__device__ __forceinline__ int2 cover(int l, int nw, int s, int k) {
  int first = nw, last = -1;
  for (int w = 0; w < nw; ++w) {
    const int d = l - w * s;
    if (d >= 0 && d < k) {
      first = min(first, w);
      last = w;
    }
  }
  return make_int2(first, last);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
max_pool_bwd_tiled(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ dy, T* __restrict__ dx, const Plan p,
                   int n0) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ys = reinterpret_cast<T*>(smem + p.y_off);
  T* dys = reinterpret_cast<T*>(smem + p.dy_off);
  unsigned char* fms = smem + p.fm_off;
  int2* row_cover = reinterpret_cast<int2*>(smem + p.cov_off);
  int2* col_cover = row_cover + p.tile_h;

  // The block: its owned cells [r0, r1) x [c0, c1), its windows
  // [oy0, oy0 + nwy) x [ox0, ox0 + nwx), whose first cell sits at shared
  // (0, 0) = image (xr, xc), and its channels [ch0, ch0 + nv * VEC).
  const int ty = blockIdx.x / p.tiles_w, tx = blockIdx.x - ty * p.tiles_w;
  const int r0 = ty * p.tile_h, r1 = min(r0 + p.tile_h, p.H);
  const int c0 = tx * p.tile_w, c1 = min(c0 + p.tile_w, p.W);
  const int oy0 = first_window(r0, p.pad_top, p.kh, p.sh);
  const int ox0 = first_window(c0, p.pad_left, p.kw, p.sw);
  const int nwy =
      max(min(p.Ho - 1, (r1 - 1 + p.pad_top) / p.sh) - oy0 + 1, 0);
  const int nwx =
      max(min(p.Wo - 1, (c1 - 1 + p.pad_left) / p.sw) - ox0 + 1, 0);
  const int xr = oy0 * p.sh - p.pad_top, xc = ox0 * p.sw - p.pad_left;
  const int ch0 = blockIdx.y * p.slab;
  const int nv = min(p.slab, p.C - ch0) / VEC;
  const long long img = static_cast<long long>(n0) + blockIdx.z;
  const T* xn = x + img * p.H * p.W * p.C + ch0;
  const T* yn = y + img * p.Ho * p.Wo * p.C + ch0;
  const T* dyn = dy + img * p.Ho * p.Wo * p.C + ch0;
  T* dxn = dx + img * p.H * p.W * p.C + ch0;

  const int v = threadIdx.x, lane = threadIdx.y, lanes = blockDim.y;
  const int cv = v * VEC;   // this thread's channels within the slab

  // Stage x of every in-image cell of the windows, and y, dy of the windows
  if (v < nv && nwy > 0) {
    const int sy0 = max(xr, 0), sy1 = min(xr + (nwy - 1) * p.sh + p.kh, p.H);
    const int sx0 = max(xc, 0), sx1 = min(xc + (nwx - 1) * p.sw + p.kw, p.W);
    for (Walk it(lane, sx1 - sx0); it.a < sy1 - sy0; it.next(lanes, sx1 - sx0)) {
      const int iy = sy0 + it.a, ix = sx0 + it.b;
      stage<T, VEC>(xs + ((iy - xr) * p.xs_w + ix - xc) * p.slab + cv,
                    xn + (iy * p.W + ix) * p.C + cv);
    }
    for (Walk it(lane, nwx); it.a < nwy; it.next(lanes, nwx)) {
      const int g = ((oy0 + it.a) * p.Wo + ox0 + it.b) * p.C + cv;
      const int s = (it.a * p.win_w + it.b) * p.slab + cv;
      stage<T, VEC>(ys + s, yn + g);
      stage<T, VEC>(dys + s, dyn + g);
    }
  }
  // the cover tables need no memory: make them while the copies fly
  const int tid = lane * blockDim.x + v, nthreads = blockDim.x * lanes;
  for (int i = tid; i < r1 - r0; i += nthreads) {
    row_cover[i] = cover(r0 + i - xr, nwy, p.sh, p.kh);
  }
  for (int i = tid; i < c1 - c0; i += nthreads) {
    col_cover[i] = cover(c0 + i - xc, nwx, p.sw, p.kw);
  }
  stage_wait();
  __syncthreads();

  // Phase 1: each window's first-match offset per channel. The scan runs
  // backwards, so the match written last is the first in row-major order;
  // cells outside the image are skipped by index.
  if (v < nv) {
    for (Walk it(lane, nwx); it.a < nwy; it.next(lanes, nwx)) {
      const int top = xr + it.a * p.sh, left = xc + it.b * p.sw;
      const int ky0 = max(0, -top), ky1 = min(p.kh, p.H - top);
      const int kx0 = max(0, -left), kx1 = min(p.kw, p.W - left);
      const int w = (it.a * p.win_w + it.b) * p.slab + cv;
      float m[VEC];
      load_f32<T, VEC>(ys + w, m);
      int off[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) off[j] = kNoMatch;
      for (int ky = ky1 - 1; ky >= ky0; --ky) {
        const T* row =
            xs + ((it.a * p.sh + ky) * p.xs_w + it.b * p.sw) * p.slab + cv;
        for (int kx = kx1 - 1; kx >= kx0; --kx) {
          float xv[VEC];
          load_f32<T, VEC>(row + kx * p.slab, xv);
          const int o = ky * p.kw + kx;
#pragma unroll
          for (int j = 0; j < VEC; ++j) off[j] = xv[j] == m[j] ? o : off[j];
        }
      }
      store_offsets<VEC>(fms + w, off);
    }
  }
  __syncthreads();

  // Phase 2: each owned cell gathers dy from the windows whose first match
  // it is, in (oy, ox) order, in float32 from 0.0f.
  if (v < nv) {
    for (Walk it(lane, c1 - c0); it.a < r1 - r0; it.next(lanes, c1 - c0)) {
      const int2 rc = row_cover[it.a], cc = col_cover[it.b];
      const int ly = r0 + it.a - xr, lx = c0 + it.b - xc;
      float acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
      for (int wy = rc.x; wy <= rc.y; ++wy) {
        const int orow = (ly - wy * p.sh) * p.kw + lx;
        for (int wx = cc.x; wx <= cc.y; ++wx) {
          const int o = orow - wx * p.sw;
          const int w = (wy * p.win_w + wx) * p.slab + cv;
          int off[VEC];
          load_offsets<VEC>(fms + w, off);
          float d[VEC];
          load_f32<T, VEC>(dys + w, d);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += off[j] == o ? d[j] : 0.0f;
        }
      }
      store_f32<T, VEC>(dxn + ((r0 + it.a) * p.W + c0 + it.b) * p.C + cv,
                        acc);
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* y, const void* dy, void* dx,
           const Plan& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      max_pool_bwd_tiled<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(p.block_x, p.block_y);
  for (int n0 = 0; n0 < p.N; n0 += kMaxImagesPerLaunch) {
    const int images = p.N - n0 < kMaxImagesPerLaunch ? p.N - n0
                                                      : kMaxImagesPerLaunch;
    const dim3 grid(p.tiles_h * p.tiles_w, p.slabs, images);
    max_pool_bwd_tiled<T, VEC><<<grid, block, p.smem, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<const T*>(dy), static_cast<T*>(dx), p, n0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// x, dx: (N, H, W, C); y, dy: (N, Ho, Wo, C); all contiguous, one dtype.
// plan: the nplan integers of kernels/pool_bwd.py:pool_bwd_plan. Returns
// the launch's cudaError_t.
extern "C" int adt_max_pool_bwd(const void* x, const void* y, const void* dy,
                                void* dx, const int* plan, int nplan,
                                void* stream) {
  Plan p;
  if (nplan != static_cast<int>(sizeof(Plan) / sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(&p, plan, sizeof p);
  if (p.block_x * p.block_y > kThreads) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (p.is_bf16) {
    if (p.vec == 8) return launch<__nv_bfloat16, 8>(x, y, dy, dx, p, st);
    if (p.vec == 1) return launch<__nv_bfloat16, 1>(x, y, dy, dx, p, st);
  } else {
    if (p.vec == 4) return launch<float, 4>(x, y, dy, dx, p, st);
    if (p.vec == 1) return launch<float, 1>(x, y, dy, dx, p, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

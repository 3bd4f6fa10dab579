// K1: int8 NHWC convolution, s8 x s8 -> s32, with a fused epilogue.
//
// Replaces: action_detection_tpu/models/backbones/bn_inception_int8.py,
//   _conv_i8_e2e (the int8-e2e runtime conv; XLA lowers it on the TPU) and
//   _conv_int8 (the dynamic-scale calibration conv), and
//   action_detection_tpu/models/backbones/inception_v3_int8.py,
//   _ForwardOps._conv_layer (the same epilogue on 1x7/7x1/1x3/3x1/5x5
//   kernels, each axis padded on its own: pad_h rows above and below,
//   pad_w columns left and right).
//
// Epilogues (chosen by out_bf16):
//   int8 (runtime):    clip(rint(max(y * scale[o] + bias[o], 0)), 0, 127)
//   bf16 (calibration): bf16(max(y * scale[o] + bias[o], 0))
// with y the s32 sum. Rounding follows the JAX package exactly: y converts
// to f32 round-to-nearest, the multiply and the add round separately
// (__fmul_rn / __fadd_rn, so no FMA contraction), rintf rounds half to even
// like jnp.round.
//
// What bounds it on the card: the slice's trunk convs (N=640 crops at
// 28/14/7 spatial, 1x1 and 3x3, C_in 64..1056, C_out 32..736) are
// arithmetic-heavy (K = kh*kw*C_in up to 9*1056 s8 MACs per output), so the
// bound is integer MAC throughput, then shared-memory traffic. This first kernel
// is an implicit GEMM (rows = output pixels, cols = output channels,
// depth = kh*kw*C_in) on __dp4a: a 64x64 output tile per 256-thread block,
// 4x4 outputs per thread, the depth staged through shared memory 8 words
// (32 int8 channels) at a time. Each 32-bit word holds 4 consecutive input
// channels of one tap, which is why C_in % 4 == 0 is required (the wrapper
// checks). Tensor-core int8 MMA (mma.sync / wgmma) and TMA staging are left
// for later work.
//
// The input may be a channel slice of a wider NHWC tensor (the fused
// branch-entry conv's split outputs): x_pix_stride is the element distance
// between neighbouring pixels, a multiple of 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;       // output pixels per block
constexpr int kBN = 64;       // output channels per block
constexpr int kBKW = 8;       // depth words (4 int8 channels each) per stage
constexpr int kPad = 4;       // smem row padding: conflict-free stores, 16 B aligned rows
constexpr int kThreads = 256;

struct ConvShape {
  int N, H, W, C, x_pix_stride;
  int O, KH, KW, stride, pad_h, pad_w;
  int Ho, Wo;
};

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out,
                 ConvShape s) {
  __shared__ __align__(16) int As[kBKW][kBM + kPad];
  __shared__ __align__(16) int Bs[kBKW][kBN + kPad];

  const int tid = threadIdx.x;
  const long long M = (long long)s.N * s.Ho * s.Wo;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int o0 = blockIdx.y * kBN;
  const int C4 = s.C >> 2;
  const int K4 = s.KH * s.KW * C4;
  const long long pix_words = s.x_pix_stride >> 2;
  const int* __restrict__ x32 = reinterpret_cast<const int*>(x);
  const int* __restrict__ w32 = reinterpret_cast<const int*>(w);

  // staging assignment: depth word lw, tile rows lr and lr + 32
  const int lw = tid & 7;
  const int lr = tid >> 3;
  long long a_base[2];
  int a_iy0[2], a_ix0[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + lr + 32 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int ox = (int)(mm % s.Wo);
    const long long t = mm / s.Wo;
    const int oy = (int)(t % s.Ho);
    const long long n = t / s.Ho;
    a_base[i] = n * s.H;
    a_iy0[i] = oy * s.stride - s.pad_h;
    a_ix0[i] = ox * s.stride - s.pad_w;
  }

  const int tx = tid & 15;  // 4 output channels each
  const int ty = tid >> 4;  // 4 output pixels each
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K4; k0 += kBKW) {
    const int kw_idx = k0 + lw;
    const bool k_ok = kw_idx < K4;
    int ky = 0, kx = 0, c4 = 0;
    if (k_ok) {
      c4 = kw_idx % C4;
      const int tap = kw_idx / C4;
      ky = tap / s.KW;
      kx = tap % s.KW;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int v = 0;
      const int iy = a_iy0[i] + ky;
      const int ix = a_ix0[i] + kx;
      if (k_ok && a_ok[i] && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W) {
        const long long pix = (a_base[i] + iy) * s.W + ix;
        v = __ldg(x32 + pix * pix_words + c4);
      }
      As[lw][lr + 32 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = o0 + lr + 32 * i;
      int v = 0;
      if (k_ok && o < s.O) v = __ldg(w32 + (long long)o * K4 + kw_idx);
      Bs[lw][lr + 32 * i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBKW; ++k) {
      const int4 a = *reinterpret_cast<const int4*>(&As[k][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&Bs[k][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o >= s.O) continue;
      float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[o]),
                          bias[o]);
      v = fmaxf(v, 0.0f);
      if (kBf16Out) {
        reinterpret_cast<__nv_bfloat16*>(out)[m * s.O + o] =
            __float2bfloat16_rn(v);
      } else {
        v = fminf(rintf(v), 127.0f);
        reinterpret_cast<int8_t*>(out)[m * s.O + o] = (int8_t)(int)v;
      }
    }
  }
}

}  // namespace

// x: (N, H, W, C) int8 NHWC, pixels x_pix_stride elements apart, 4-byte
// aligned; w: (O, KH, KW, C) int8 contiguous; scale, bias: (O,) f32;
// zero padding pad_h / pad_w on both sides of each axis; out: (N, Ho, Wo, O)
// int8, or bf16 when out_bf16. Returns the launch's cudaError_t.
extern "C" int adt_int8_conv(const void* x, const void* w, const float* scale,
                             const float* bias, void* out, int N, int H,
                             int W, int C, int x_pix_stride, int O, int KH,
                             int KW, int stride, int pad_h, int pad_w, int Ho,
                             int Wo, int out_bf16, void* stream) {
  ConvShape s{N, H, W, C, x_pix_stride, O, KH, KW, stride, pad_h, pad_w,
              Ho, Wo};
  const long long M = (long long)N * Ho * Wo;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((O + kBN - 1) / kBN));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16) {
    int8_conv_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
        bias, out, s);
  } else {
    int8_conv_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
        bias, out, s);
  }
  return (int)cudaGetLastError();
}

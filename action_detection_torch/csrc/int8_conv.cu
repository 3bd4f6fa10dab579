// K1: int8 NHWC convolution, s8 x s8 -> s32 on Hopper's int8 tensor cores,
// with a fused epilogue.
//
// Replaces: action_detection_tpu/models/backbones/bn_inception_int8.py,
//   _conv_i8_e2e (the int8-e2e runtime conv; XLA lowers it on the TPU) and
//   _conv_int8 (the dynamic-scale calibration conv), and
//   action_detection_tpu/models/backbones/inception_v3_int8.py,
//   _ForwardOps._conv_layer (the same epilogue on 1x7/7x1/1x3/3x1/5x5
//   kernels, each axis padded on its own: pad_h rows above and below,
//   pad_w columns left and right).
//
// Epilogues (template flag kBf16Out):
//   int8 (runtime):     clip(rint(max(y * scale[o] + bias[o], 0)), 0, 127)
//   bf16 (calibration): bf16(max(y * scale[o] + bias[o], 0))
// with y the s32 sum. Rounding follows the JAX package exactly: y converts
// to f32 round-to-nearest, the multiply and the add round separately
// (__fmul_rn / __fadd_rn, so no FMA contraction), rintf rounds half to even
// like jnp.round. The calibration conv's inputs are signed ([-127, 127]);
// nothing here assumes post-ReLU inputs.
//
// What bounds it on the card: the trunk convs (640 crops at 35/28/17/14/8/7
// spatial, K = kh*kw*C up to 9*1056) do up to 184 GMAC each, so the bound
// is the int8 tensor cores (1,979 TOPS dense), except the 1x1 entry convs
// at 7x7-8x8, which sit near the HBM bound. The design:
// * an implicit GEMM: rows = output pixels (M = N*Ho*Wo), columns = output
//   channels, depth = (ky, kx, c), the weight layout's order, so both
//   operands are K-major, the only layout wgmma takes for 8-bit types;
// * wgmma.mma_async m64nNk32 s32.s8.s8 with both operands in shared memory
//   under the 128-byte swizzle; a block is a 128-row tile (two warpgroups
//   of m64) by N = 32, 64 or 128 columns (the wrapper's int8_conv_plan
//   picks N per shape); columns past O are zero-filled and never stored;
// * a ring of kStages stages of 128 depth bytes, filled by 16-byte cp.async
//   copies: an A chunk is 16 channels of one tap of one pixel, its address
//   the row's (n, oy, ox), computed once per block, plus the chunk's
//   (ky, kx, c), in 32-bit offsets from the image's base. A tap in the
//   padding, a row past M and depth past K are zero-fill copies (src-size
//   0), so padding costs no branch in the math loop and every pad form
//   (1x7, 7x1, 5x5, VALID s2) takes the same path. Copies for stage k+2 are
//   in flight while stage k is multiplied, and one wgmma group stays in
//   flight across the barrier. A shallow conv (a 1x1 of 128-256 channels)
//   allocates only the ring slots its depth uses, so more of its blocks
//   share an SM;
// * the epilogue loads each column's scale and bias once per tile, stages
//   the tile in shared memory and stores it with 16-byte writes.
// The kernel needs C % 16 == 0 (a 16-byte chunk never straddles taps), a
// pixel stride % 16 == 0 and 16-byte aligned x and w; the wrapper checks.
//
// The input may be a channel slice of a wider NHWC tensor (the fused
// branch-entry conv's split outputs): x_pix_stride is the element distance
// between neighbouring pixels. So may the output (an Inception module's
// buffer, which each branch's last conv fills at its channel offset, so the
// module needs no concat): out_pix_stride is its pixel distance. The output
// columns may also go to two places: columns below split to out, the rest
// to out2 (pixels out2_pix_stride apart): the fused entry conv's 1x1 branch
// into the module's buffer and its reduce heads apart. Where both pixel
// strides are 16-byte multiples (the wrapper makes sure of it for a slice,
// as for the split: split * esize % 16 == 0, and the 16-byte alignment),
// rows go out in 16-byte writes, a slice's last partial chunk byte by byte;
// else (a contiguous output of O * esize % 16 != 0) element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels per block: 2 warpgroups x 64
constexpr int kBK = 128;        // depth bytes per stage: one swizzled row
constexpr int kChunks = kBK / 16;
constexpr int kStages = 4;
constexpr int kThreads = 256;

struct ConvShape {
  int N, H, W, C, x_pix_stride;
  int O, KH, KW, stride, pad_h, pad_w;
  int Ho, Wo;
  int out_pix_stride, out2_pix_stride, split;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy into shared memory; src_bytes 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the copies a thread made become visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused in this mode. Stepping
// the start address by 32 bytes moves one k32 step along the row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D(64 x N, s32) += A(64 x 32, s8, K-major) * B(N x 32, s8, K-major)^T;
// thread t of the warpgroup holds d[i] at row 16 * (t / 32) + (t % 32) / 4
// + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (t % 4) + i % 2.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ float requant(int y, float m, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(y), m), b), 0.0f);
}

template <int BN, bool kBf16Out>
__global__ void __launch_bounds__(kThreads, 1)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out,
                 void* __restrict__ out2, ConvShape s) {
  constexpr int kAStage = kBM * kBK;
  constexpr int kStage = kAStage + BN * kBK;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is a function of address bits 4-9: align the ring to 1024
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int M = s.N * s.Ho * s.Wo;
  const int m0 = blockIdx.y * kBM;
  const int o0 = blockIdx.x * BN;
  const int K = s.KH * s.KW * s.C;
  const int K16 = K >> 4;
  const int C16 = s.C >> 4;
  const int nk = (K + kBK - 1) / kBK;

  // staging: this thread copies depth chunk j of tile rows r0 + 32 i; all
  // those rows share r0 % 8, hence one swizzled chunk position
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t row_off = r0 * kBK + ((j ^ (r0 & 7)) << 4);
  const int8_t* a_img[4];
  int a_iy0[4], a_ix0[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + r0 + 32 * i;
    if (m < M) {
      const int ox = m % s.Wo;
      const int t = m / s.Wo;
      const int oy = t % s.Ho;
      a_img[i] = x + (long long)(t / s.Ho) * s.H * s.W * s.x_pix_stride;
      a_iy0[i] = oy * s.stride - s.pad_h;
      a_ix0[i] = ox * s.stride - s.pad_w;
    } else {  // a row past M: every tap lies outside the image
      a_img[i] = x;
      a_iy0[i] = -0x40000000;
      a_ix0[i] = 0;
    }
  }

  auto load_stage = [&](int kt, int slot) {
    const int q = kt * kChunks + j;  // this thread's chunk of the depth
    const bool kq = q < K16;
    const int tap = q / C16;
    const int cg = q - tap * C16;
    const int ky = tap / s.KW;
    const int kx = tap - ky * s.KW;
    const uint32_t sa = base + slot * kStage + row_off;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iy = a_iy0[i] + ky;
      const int ix = a_ix0[i] + kx;
      const bool ok = kq && (unsigned)iy < (unsigned)s.H &&
                      (unsigned)ix < (unsigned)s.W;
      const int8_t* src =
          ok ? a_img[i] + (iy * s.W + ix) * s.x_pix_stride + cg * 16 : x;
      cp_async16(sa + 32 * kBK * i, src, ok ? 16 : 0);
    }
    const uint32_t sb = sa + kAStage;
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int o = o0 + r0 + 32 * i;
      const bool ok = kq && o < s.O;
      const int8_t* src = ok ? w + o * K + q * 16 : w;
      cp_async16(sb + 32 * kBK * i, src, ok ? 16 : 0);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int wg = tid >> 7;  // this warpgroup's tile rows: 64 wg .. 64 wg + 63

#pragma unroll
  for (int st = 0; st < kStages - 2; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 3>();  // this thread's copies of stage kt landed
    fence_proxy_async();
    // every thread's copies of stage kt landed, and every warpgroup has
    // retired its wgmma of stage kt - 2, whose slot the next copies fill
    __syncthreads();
    const int nxt = kt + kStages - 2;
    if (nxt < nk) load_stage(nxt, nxt % kStages);
    cp_async_commit();
    const uint32_t sa = base + (kt % kStages) * kStage + wg * 64 * kBK;
    const uint32_t sb = base + (kt % kStages) * kStage + kAStage;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      Wgmma<BN>::mma(acc, sw128_desc(sa + 32 * kk), sw128_desc(sb + 32 * kk));
    wgmma_commit();
    wgmma_wait<1>();  // the group of stage kt - 1 retired
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the output tile now

  constexpr int kEsize = kBf16Out ? 2 : 1;
  constexpr int kRowBytes = BN * kEsize;
  constexpr int kPitch = kRowBytes + 16;  // 16-byte rows, spread banks
  uint8_t* tile = smem_raw + (base - raw);
  const int lane = tid & 31;
  const int row_a = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb) {
    const int col = nb * 8 + (lane & 3) * 2;
    const int o = o0 + col;
    const float sc0 = o < s.O ? __ldg(scale + o) : 0.0f;
    const float sc1 = o + 1 < s.O ? __ldg(scale + o + 1) : 0.0f;
    const float bi0 = o < s.O ? __ldg(bias + o) : 0.0f;
    const float bi1 = o + 1 < s.O ? __ldg(bias + o + 1) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = requant(acc[nb * 4 + 2 * h], sc0, bi0);
      const float v1 = requant(acc[nb * 4 + 2 * h + 1], sc1, bi1);
      uint8_t* dst = tile + (row_a + 8 * h) * kPitch + col * kEsize;
      if (kBf16Out) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        const int q0 = (int)fminf(rintf(v0), 127.0f);
        const int q1 = (int)fminf(rintf(v1), 127.0f);
        *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(q0 | (q1 << 8));
      }
    }
  }
  __syncthreads();

  const int rows = min(kBM, M - m0);
  const int cols = min(BN, s.O - o0);
  const long long pitch = (long long)s.out_pix_stride * kEsize;
  const long long pitch2 = (long long)s.out2_pix_stride * kEsize;
  if (pitch % 16 == 0 && pitch2 % 16 == 0) {  // 16-byte aligned rows
    // thread tid stores 16-byte chunk c = tid % kCPR of rows tid / kCPR,
    // + kRowStep, ...: its destination (out below split, else out2), pitch
    // and chunk width are the same for all its rows
    constexpr int kCPR = kRowBytes / 16;
    constexpr int kRowStep = kThreads / kCPR;
    static_assert(kThreads % kCPR == 0, "a thread keeps its chunk column");
    const int c = tid % kCPR;
    const int left = cols * kEsize - c * 16;  // row bytes from chunk c on
    if (left > 0) {
      const int o = o0 + c * (16 / kEsize);
      const bool first = o < s.split;
      const long long p = first ? pitch : pitch2;
      uint8_t* d = first ? static_cast<uint8_t*>(out) + (long long)o * kEsize
                         : static_cast<uint8_t*>(out2) +
                               (long long)(o - s.split) * kEsize;
      d += m0 * p;
      const uint8_t* t = tile + c * 16;
      for (int r = tid / kCPR; r < rows; r += kRowStep) {
        if (left >= 16)
          *reinterpret_cast<int4*>(d + r * p) =
              *reinterpret_cast<const int4*>(t + r * kPitch);
        else  // a channel slice's last, partial chunk
          for (int b = 0; b < left; ++b) d[r * p + b] = t[r * kPitch + b];
      }
    }
  } else {  // one contiguous output (the wrapper gives a slice or a split
            // only 16-byte-multiple pixel strides)
    uint8_t* obase = static_cast<uint8_t*>(out) + m0 * pitch +
                     (long long)o0 * kEsize;
    for (int idx = tid; idx < kBM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      if (r < rows && c < cols) {
        if (kBf16Out)
          *reinterpret_cast<uint16_t*>(obase + r * pitch + 2 * c) =
              *reinterpret_cast<const uint16_t*>(tile + r * kPitch + 2 * c);
        else
          obase[r * pitch + c] = tile[r * kPitch + c];
      }
    }
  }
}

template <int BN, bool kBf16Out>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* bias, void* out, void* out2,
                   const ConvShape& s, cudaStream_t st) {
  // the ring slots a depth of nk stages uses (a shallow 1x1 conv uses one
  // or two, and more of its blocks then fit on an SM), at least the output
  // tile, + 1024 for the alignment
  const int nk = (s.KH * s.KW * s.C + kBK - 1) / kBK;
  const int ring = (nk < kStages ? nk : kStages) * (kBM + BN) * kBK;
  const int tile = kBM * (BN * (kBf16Out ? 2 : 1) + 16);
  const int smem = (ring > tile ? ring : tile) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      int8_conv_kernel<BN, kBf16Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int M = s.N * s.Ho * s.Wo;
  // column tiles fastest: the blocks of one row tile run together and
  // share their A rows in L2
  const dim3 grid((unsigned)((s.O + BN - 1) / BN),
                  (unsigned)((M + kBM - 1) / kBM));
  int8_conv_kernel<BN, kBf16Out><<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale,
      bias, out, out2, s);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, C) int8 NHWC, pixels x_pix_stride elements apart, 16-byte
// aligned, C % 16 == 0; w: (O, KH, KW, C) int8 contiguous, 16-byte aligned;
// scale, bias: (O,) f32; zero padding pad_h / pad_w on both sides of each
// axis; the output (N, Ho, Wo, O), int8, or bf16 when out_bf16: columns
// [0, split) to out, [split, O) to out2, pixels out_pix_stride and
// out2_pix_stride elements apart (a contiguous output: out2 = out, both
// strides O, split O); bn: the column tile, 32, 64 or 128. N * Ho * Wo <
// 2**31 and its row tiles fit gridDim.y. Returns the launch's cudaError_t.
extern "C" int adt_int8_conv(const void* x, const void* w, const float* scale,
                             const float* bias, void* out, void* out2, int N,
                             int H, int W, int C, int x_pix_stride, int O,
                             int KH, int KW, int stride, int pad_h, int pad_w,
                             int Ho, int Wo, int out_pix_stride,
                             int out2_pix_stride, int split, int bn,
                             int out_bf16, void* stream) {
  const ConvShape s{N, H, W, C, x_pix_stride, O, KH, KW, stride, pad_h, pad_w,
                    Ho, Wo, out_pix_stride, out2_pix_stride, split};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  void* o2 = out2;
  switch (bn * 2 + (out_bf16 ? 1 : 0)) {
    case 64: return (int)launch<32, false>(x, w, scale, bias, out, o2, s, st);
    case 65: return (int)launch<32, true>(x, w, scale, bias, out, o2, s, st);
    case 128: return (int)launch<64, false>(x, w, scale, bias, out, o2, s, st);
    case 129: return (int)launch<64, true>(x, w, scale, bias, out, o2, s, st);
    case 256: return (int)launch<128, false>(x, w, scale, bias, out, o2, s, st);
    case 257: return (int)launch<128, true>(x, w, scale, bias, out, o2, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// XLA lowers them on the TPU; torch's CUDA max_pool2d takes no int8
// (chip_smoke.py prints its error).
//
// What bounds them on the card: HBM. A pool reads each input byte and
// writes each output byte once at best (K3 at InceptionV3's 5d: 451.6 MB a
// 640-crop step, 0.135 ms at 3.35 TB/s; K2 at BNInception's 3c: 200.7 MB,
// 0.060 ms). Both are one tiled pass on the same frame, so that the bytes
// and not the instructions set their time:
// * a block owns a tile of tile_h x tile_w output cells of one image and a
//   slab of 16-byte channel chunks; it stages the input cells the tile's
//   3x3 windows cover, ((tile_h - 1) * stride + 3) x ((tile_w - 1) *
//   stride + 3) of them, in shared memory with 16-byte cp.async copies, so
//   each input byte crosses HBM about once; its indices come from blockIdx
//   and threadIdx in 32-bit, with no per-element division. The tile comes
//   from kernels/int8.py:int8_pool_plan, one plan for both kernels; at
//   stride 2 its tiles are 2 output rows high: many short-lived blocks
//   overlap one block's loads with another's maxima better than fewer
//   long ones (8-row tiles took K2 1.1-1.4x longer on the card);
// * a thread owns one output column of the tile and one 16-channel chunk:
//   it reduces each staged row's three cells under its window once, then
//   slides down the column combining three row results (at stride 2,
//   staged row 2 oy + 2 serves output rows oy and oy + 1), and writes 16
//   bytes.
//
// K2 (3x3, stride 1 or 2, windows from o * stride - pad): its maxima are
// byte-wise signed __vmaxs4 on 32-bit words (sm_90a emulates it in six
// integer instructions for four channels, no byte loop).
// A cell outside the image is staged as 0x80 bytes (-128, the reduce init,
// never above a value) by a plain shared store: a zero-fill copy would
// stage 0, which beats every negative value.
//
// K3 (3x3 s1 p1; cells outside the image are zero-fill copies):
// * it unpacks each chunk into two 16-bit lanes a word with every byte
//   offset by +128 (x ^ 0x80, so a zero-filled cell counts as 0), and sums
//   rows then columns: exact integer sums in any order, so the result is
//   bit-exact;
// * the divisor is 9, or (rows in image) x (columns in image) from the
//   cell's position in exclude_pad mode: nothing is loaded for it. A value
//   is rintf(__fdiv_rn(f32(sum), divisor)), clipped, as the JAX package
//   rounds; where the divisor is 9 (every cell of the include-pad mode,
//   the interior of the exclude-pad one) the same bits come from an exact
//   integer form (average9), which halves the instructions per output.
// Both need C % 16 == 0 and 16-byte aligned tensors; the wrappers check.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

// byte-wise signed max of three 16-byte chunks
__device__ __forceinline__ int4 max3(const int4 a, const int4 b,
                                     const int4 c) {
  return make_int4(
      (int)__vmaxs4(__vmaxs4((unsigned)a.x, (unsigned)b.x), (unsigned)c.x),
      (int)__vmaxs4(__vmaxs4((unsigned)a.y, (unsigned)b.y), (unsigned)c.y),
      (int)__vmaxs4(__vmaxs4((unsigned)a.z, (unsigned)b.z), (unsigned)c.z),
      (int)__vmaxs4(__vmaxs4((unsigned)a.w, (unsigned)b.w), (unsigned)c.w));
}

// 3x3 max pool at stride S, windows from o * S - pad; block (slab, tile_w),
// grid (tiles, slabs, N)
template <int S>
__global__ void __launch_bounds__(kThreads)
int8_max_pool3_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                      int H, int W, int C, int Ho, int Wo, int out_pix_stride,
                      int pad, int tile_h, int tile_w, int tiles_w) {
  extern __shared__ int4 cells[];  // rows x cols x slab staged input cells
  const int slab = blockDim.x;
  const int c = threadIdx.x;
  const int tx = threadIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * tile_h;
  const int ox0 = (blockIdx.x % tiles_w) * tile_w;
  const int cbyte = (blockIdx.y * slab + c) * 16;
  const int8_t* img = x + (long long)blockIdx.z * H * W * C + cbyte;
  // the input rows and columns under this tile's windows
  const int rows = (min(tile_h, Ho - oy0) - 1) * S + 3;
  const int cols = (min(tile_w, Wo - ox0) - 1) * S + 3;
  const int iy0 = oy0 * S - pad;
  const int ix0 = ox0 * S - pad;
  const int neg = (int)0x80808080u;

  for (int r = 0; r < rows; ++r) {
    const int iy = iy0 + r;
    const bool row_in = (unsigned)iy < (unsigned)H;
    for (int col = tx; col < cols; col += tile_w) {
      const int ix = ix0 + col;
      int4* dst = &cells[(r * cols + col) * slab + c];
      if (row_in && (unsigned)ix < (unsigned)W)
        cp_async16(dst, img + (iy * W + ix) * C, 16);
      else
        *dst = make_int4(neg, neg, neg, neg);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
  __syncthreads();

  const int ox = ox0 + tx;
  if (ox >= Wo) return;
  int8_t* dst =
      out + ((long long)blockIdx.z * Ho * Wo + ox) * out_pix_stride + cbyte;
  int4 up2 = make_int4(neg, neg, neg, neg);  // row maxima of the two
  int4 up1 = up2;                            // staged rows above
  for (int r = 0; r < rows; ++r) {
    const int4* p = &cells[(r * cols + S * tx) * slab + c];
    const int4 row = max3(p[0], p[slab], p[2 * slab]);
    if (r >= 2 && (r - 2) % S == 0) {
      const int oy = oy0 + (r - 2) / S;
      *reinterpret_cast<int4*>(dst + oy * Wo * out_pix_stride) =
          max3(up2, up1, row);
    }
    up2 = up1;
    up1 = row;
  }
}

// adds a 16-channel chunk to eight words of two 16-bit lanes, each byte
// offset by +128: word 2k holds channels 4k and 4k+2, word 2k+1 channels
// 4k+1 and 4k+3 (a lane sums at most 9 x 255)
__device__ __forceinline__ void add_chunk(const int4 v, uint32_t (&sum)[8]) {
  const uint32_t words[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                             (uint32_t)v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u = words[k] ^ 0x80808080u;
    sum[2 * k] += u & 0x00FF00FFu;
    sum[2 * k + 1] += (u >> 8) & 0x00FF00FFu;
  }
}

// a 9-cell window's average from its lane (the sum s plus 9 x 128):
// rint(s / 9) half to even is floor((2 lane + 9) / 18) - 128 (9 is odd: no
// ties), and floor(t / 18) = (t * 3641) >> 16 for t < 4608; as a byte,
// - 128 is ^ 0x80. Equal to average(lane, 9.0f) for every lane 0..2295
// (tests/test_torch_port_int8_tiles.py enumerates them).
__device__ __forceinline__ uint32_t average9(uint32_t lane) {
  return ((((2u * lane + 9u) * 3641u) >> 16) ^ 0x80u) & 0xFFu;
}

// one channel's window sum (a 16-bit lane, 9 offsets of 128 removed) ->
// its int8 average, as one byte: the JAX package's f32 division
__device__ __forceinline__ uint32_t average(uint32_t lane, float div) {
  const int sum = (int)lane - 9 * 128;
  const float v = rintf(__fdiv_rn(__int2float_rn(sum), div));
  return (uint32_t)(int)fminf(fmaxf(v, -128.0f), 127.0f) & 0xFFu;
}

// three rows' lane sums of a chunk -> its 16 averaged bytes (word k: the
// channels 4k .. 4k+3)
template <typename Avg>
__device__ __forceinline__ void pack_chunk(const uint32_t (&r0)[8],
                                           const uint32_t (&r1)[8],
                                           const uint32_t (&r2)[8],
                                           uint32_t (&packed)[4], Avg avg) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t ev = r0[2 * k] + r1[2 * k] + r2[2 * k];
    const uint32_t od = r0[2 * k + 1] + r1[2 * k + 1] + r2[2 * k + 1];
    packed[k] = avg(ev & 0xFFFFu) | avg(od & 0xFFFFu) << 8 |
                avg(ev >> 16) << 16 | avg(od >> 16) << 24;
  }
}

// 3x3 s1 p1 average pool; block (slab, tile_w), grid (tiles, slabs, N)
__global__ void __launch_bounds__(kThreads)
int8_avg_pool3_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                      int H, int W, int C, int tile_h, int tile_w,
                      int tiles_w, int exclude_pad) {
  extern __shared__ int4 halo[];  // (tile_h + 2) x (tile_w + 2) x slab
  const int slab = blockDim.x;
  const int c = threadIdx.x;
  const int tx = threadIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * tile_h;
  const int ox0 = (blockIdx.x % tiles_w) * tile_w;
  const int cbyte = (blockIdx.y * slab + c) * 16;
  const long long img = (long long)blockIdx.z * H * W * C;
  const int hw = tile_w + 2;
  const int hh = min(tile_h, H - oy0) + 2;  // halo rows of this tile

  for (int cell = tx; cell < hh * hw; cell += tile_w) {
    const int hy = cell / hw;
    const int iy = oy0 - 1 + hy;
    const int ix = ox0 - 1 + cell - hy * hw;
    const bool ok = (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
    cp_async16(&halo[cell * slab + c],
               ok ? x + img + (iy * W + ix) * C + cbyte : x, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
  __syncthreads();

  const int ox = ox0 + tx;
  if (ox >= W) return;
  const int cols = exclude_pad ? 3 - (ox == 0) - (ox == W - 1) : 3;
  uint32_t up2[8], up1[8];  // row sums of the two halo rows above
  for (int hy = 0; hy < hh; ++hy) {
    uint32_t row[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      add_chunk(halo[(hy * hw + tx + dx) * slab + c], row);
    if (hy >= 2) {
      const int oy = oy0 + hy - 2;
      const int rows = exclude_pad ? 3 - (oy == 0) - (oy == H - 1) : 3;
      const float div = (float)(rows * cols);
      uint32_t packed[4];
      if (rows * cols == 9)
        pack_chunk(up2, up1, row, packed,
                   [](uint32_t lane) { return average9(lane); });
      else
        pack_chunk(up2, up1, row, packed,
                   [div](uint32_t lane) { return average(lane, div); });
      *reinterpret_cast<int4*>(out + img + (oy * W + ox) * C + cbyte) =
          make_int4((int)packed[0], (int)packed[1], (int)packed[2],
                    (int)packed[3]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      up2[k] = up1[k];
      up1[k] = row[k];
    }
  }
}

}  // namespace

// x: (N, H, W, C) int8 contiguous, 16-byte aligned, C % 16 == 0; out:
// (N, Ho, Wo, C), pixels out_pix_stride bytes apart (a multiple of 16: out
// may be a channel slice of an Inception module's buffer), 16-byte aligned.
// A 3x3 max pool at stride 1 or 2 whose windows start at
// o * stride - pad; cells outside the input are -128 (never the max). The
// tile (tile_h x tile_w output cells, slab 16-byte chunks dividing C / 16,
// slab * tile_w <= 256 threads, the staged cells within 48 KB) comes from
// kernels/int8.py:int8_pool_plan. Returns the launch's cudaError_t.
extern "C" int adt_int8_max_pool(const void* x, void* out, int N, int H,
                                 int W, int C, int Ho, int Wo,
                                 int out_pix_stride, int stride, int pad,
                                 int tile_h, int tile_w, int slab,
                                 void* stream) {
  const int tiles_w = (Wo + tile_w - 1) / tile_w;
  const int tiles = ((Ho + tile_h - 1) / tile_h) * tiles_w;
  const dim3 grid((unsigned)tiles, (unsigned)(C / 16 / slab), (unsigned)N);
  const dim3 block((unsigned)slab, (unsigned)tile_w);
  const size_t smem = (size_t)((tile_h - 1) * stride + 3) *
                      ((tile_w - 1) * stride + 3) * slab * 16;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  if (stride == 1)
    int8_max_pool3_kernel<1><<<grid, block, smem, s>>>(
        xi, o, H, W, C, Ho, Wo, out_pix_stride, pad, tile_h, tile_w, tiles_w);
  else if (stride == 2)
    int8_max_pool3_kernel<2><<<grid, block, smem, s>>>(
        xi, o, H, W, C, Ho, Wo, out_pix_stride, pad, tile_h, tile_w, tiles_w);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x, out: (N, H, W, C) int8 contiguous, 16-byte aligned, C % 16 == 0; a
// 3x3 s1 p1 average pool, divided by 9 or, when exclude_pad, by the
// window's in-image cell count. The tile (tile_h x tile_w cells, slab
// 16-byte chunks, slab dividing C / 16, slab * tile_w <= 256 threads, the
// halo tile within 48 KB) comes from kernels/int8.py:int8_pool_plan.
// Returns the launch's cudaError_t.
extern "C" int adt_int8_avg_pool(const void* x, void* out, int N, int H,
                                 int W, int C, int tile_h, int tile_w,
                                 int slab, int exclude_pad, void* stream) {
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int tiles = ((H + tile_h - 1) / tile_h) * tiles_w;
  const dim3 grid((unsigned)tiles, (unsigned)(C / 16 / slab), (unsigned)N);
  const dim3 block((unsigned)slab, (unsigned)tile_w);
  const size_t smem = (size_t)(tile_h + 2) * (tile_w + 2) * slab * 16;
  int8_avg_pool3_kernel<<<grid, block, smem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), H, W, C,
      tile_h, tile_w, tiles_w, exclude_pad);
  return (int)cudaGetLastError();
}

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
// What bounds them on the card: HBM. A pool reads each input byte and
// writes each output byte once at best (K3 at InceptionV3's 5d: 451.6 MB a
// 640-crop step, 0.135 ms at 3.35 TB/s). K2 keeps its first form, one
// thread per output byte (consecutive threads on consecutive channels);
// it reads each byte through L1/L2 up to nine times and recovers its
// indices with 64-bit divisions, so it is instruction-bound.
//
// K3 is a tiled pass for the only geometry the trunks use, 3x3 s1 p1:
// * a block owns a tile of tile_h x tile_w output cells of one image and a
//   slab of 16-byte channel chunks; it stages the tile and its one-cell
//   halo in shared memory with 16-byte cp.async copies (cells outside the
//   image are zero-fill copies), so each input byte crosses HBM about once;
//   its indices come from blockIdx and threadIdx in 32-bit, with no
//   per-element division;
// * a thread owns one output column of the tile and one 16-channel chunk:
//   it unpacks each chunk into two 16-bit lanes a word with every byte
//   offset by +128 (x ^ 0x80, so a zero-filled cell counts as 0), sums
//   three cells of a row, then slides down the column summing three row
//   sums: exact integer sums in any order, so the result is bit-exact;
// * the divisor is 9, or (rows in image) x (columns in image) from the
//   cell's position in exclude_pad mode: nothing is loaded for it. A value
//   is rintf(__fdiv_rn(f32(sum), divisor)), clipped, as the JAX package
//   rounds; where the divisor is 9 (every cell of the include-pad mode,
//   the interior of the exclude-pad one) the same bits come from an exact
//   integer form (average9), which halves the instructions per output;
//   each thread writes 16 bytes.
// It needs C % 16 == 0 and 16-byte aligned tensors; the wrapper checks
// and plans the tile (kernels/int8.py:int8_avg_pool_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct PoolShape {
  int N, H, W, C, Ho, Wo, k, stride, pad_lo;
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

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // grid-stride beyond a few waves
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
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

// x: (N, H, W, C) int8 contiguous; out: (N, Ho, Wo, C) int8. Windows start
// at o * stride - pad_lo; cells outside the input are padding (-128, never
// the max). Returns the launch's cudaError_t.
extern "C" int adt_int8_max_pool(const void* x, void* out, int N, int H,
                                 int W, int C, int Ho, int Wo, int k,
                                 int stride, int pad_lo, void* stream) {
  PoolShape s{N, H, W, C, Ho, Wo, k, stride, pad_lo};
  const long long total = (long long)N * Ho * Wo * C;
  int8_max_pool_kernel<<<grid_for(total), kThreads, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), s);
  return (int)cudaGetLastError();
}

// x, out: (N, H, W, C) int8 contiguous, 16-byte aligned, C % 16 == 0; a
// 3x3 s1 p1 average pool, divided by 9 or, when exclude_pad, by the
// window's in-image cell count. The tile (tile_h x tile_w cells, slab
// 16-byte chunks, slab dividing C / 16, slab * tile_w <= 256 threads, the
// halo tile within 48 KB) comes from kernels/int8.py:int8_avg_pool_plan.
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

// K1 conv3x3_mid: one 'same' 3x3 64->64 conv + bias + optional
// LeakyReLU, NHWC, f32 accumulation, one rounding to the activation dtype.
//
// Replaces: virnet_tpu/ops/pallas_conv.py:conv3x3_mid_pair (:627; Pallas
// bodies _mid_kernel_halo :181 and _mid_kernel :172) and, as L launches
// in a row, conv3x3_mid_stack_pair (:297; _mid_stack_kernel :231).  No
// pixel-pair layout: that existed to fill the TPU's 128 lanes.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32
// CUDA cores, 3.35 TB/s): 73.7 kFLOP per output pixel against 256 B (bf16)
// or 512 B (f32) read and written per pixel.  At 1x321x481 that is 11.4
// GFLOP against 39.5 MB in bf16, 0.0115 ms of operations and 0.0118 ms of
// bytes, so the bf16 kernel sits at the ridge; in f32 the operations
// bound it (0.170 ms against 0.024 ms of bytes).
//
// The first version ran one thread per pixel on the CUDA cores in both
// dtypes, restaged all 73.7 KB of weights for every 16x16 tile element by
// element, and loaded the halo tile with plain loads, nothing overlapping
// the math.  This design:
//  - persistent grid: as many blocks as fit on the card walk the output
//    tiles (tile_async.cuh:TileGrid), and each loads the weights into
//    shared memory once, not once per tile;
//  - the halo tile arrives by 16-byte cp.async with zero fill (the 'same'
//    padding at no cost), double-buffered: the next tile's copy is in
//    flight while this tile's math runs;
//  - bf16: an implicit GEMM on the tensor cores, M = 16 pixels of one
//    tile row, N = 64 output channels, K = 9 taps x 64 input channels.  A
//    fragments by ldmatrix from the shifted halo tile for each tap, B by
//    ldmatrix.trans from the HWIO weights, mma.sync m16n8k16 with f32
//    sums.  Every pixel row in shared memory is padded to 9 16-byte units
//    (odd), so ldmatrix reads conflict-free.  The epilogue adds the bias,
//    applies LeakyReLU in f32, rounds once, and stages the warp's 32
//    pixels in shared memory so that they leave as 16-byte stores, 512
//    contiguous bytes per warp instruction;
//  - f32: exact f32 on the CUDA cores (no TF32).  Each thread keeps a
//    register tile of 4 pixels x 8 output channels, so a 16-byte shared
//    load of weights feeds 16 FMAs and one of inputs 32.
#include "common.cuh"
#include "tile_async.cuh"

namespace {

constexpr int C = 64;

// ---- bf16: 16x16 output tiles, 8 warps, two tile rows per warp ----------
namespace b16 {
constexpr int TH = 16, TW = 16, HH = TH + 2, HW = TW + 2, HPX = HH * HW;
constexpr int THREADS = 256;
constexpr int ROW = odd_units(C * 2) * 8;   // elements per padded row: 72
constexpr size_t W_BYTES = 9 * C * ROW * 2;
constexpr size_t X_BYTES = HPX * ROW * 2;
constexpr size_t STAGE_BYTES = (THREADS / 32) * 32 * ROW * 2;
constexpr size_t SMEM = W_BYTES + 2 * X_BYTES + STAGE_BYTES + C * 4;
}  // namespace b16

__device__ __forceinline__ void load_halo_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* x, const TileGrid& tg, int t) {
  using namespace b16;
  int n, y0, x0;
  tg.at(t, n, y0, x0);
  for (int i = threadIdx.x; i < HPX * 8; i += THREADS) {
    const int p = i >> 3, u = i & 7;
    const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
    const bool in = gy >= 0 && gy < tg.H && gx >= 0 && gx < tg.W;
    const __nv_bfloat16* src =
        in ? x + ((size_t)(n * tg.H + gy) * tg.W + gx) * C + u * 8 : x;
    cp_async16(dst + p * ROW + u * 8, src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(b16::THREADS)
conv3x3_mid_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ b,
                        __nv_bfloat16* __restrict__ y, TileGrid tg,
                        float slope, int has_slope) {
  using namespace b16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sx = sw + 9 * C * ROW;   // two halo buffers
  __nv_bfloat16* stage_all = sx + 2 * HPX * ROW;
  float* sb =
      reinterpret_cast<float*>(stage_all + (THREADS / 32) * 32 * ROW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  __nv_bfloat16* stage = stage_all + warp * 32 * ROW;

  // weights, HWIO rows (tap, ci) of 64 co, once per block
  for (int i = threadIdx.x; i < 9 * C * 8; i += THREADS)
    cp_async16(sw + (i >> 3) * ROW + (i & 7) * 8, w + i * 8, 16);
  if (threadIdx.x < C) sb[threadIdx.x] = tof(b[threadIdx.x]);
  if (blockIdx.x < tg.count) load_halo_bf16(sx, x, tg, blockIdx.x);
  cp_async_commit();

  int it = 0;
  for (int t = blockIdx.x; t < tg.count; t += gridDim.x, ++it) {
    if (t + gridDim.x < tg.count)
      load_halo_bf16(sx + ((it + 1) & 1) * HPX * ROW, x, tg,
                     t + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* src = sx + (it & 1) * HPX * ROW;

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mi][nt][i] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      // A: lane l addresses pixel l % 16 of the row, unit l / 16 of the k16
      const __nv_bfloat16* a0 =
          src + ((2 * warp + dy) * HW + (lane & 15) + dx) * ROW +
          (lane >> 4) * 8;
      // B: lane l addresses matrix l / 8 = (k half, n tile of the pair)
      const __nv_bfloat16* b0 =
          sw + (tap * C + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
          (lane >> 4) * 8;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t af[2][4];
        ldsm_x4(af[0], a0 + kb * 16);
        ldsm_x4(af[1], a0 + HW * ROW + kb * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          ldsm_x4_t(bf, b0 + kb * 16 * ROW + np * 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc[mi][2 * np], af[mi], bf);
            mma_16816(acc[mi][2 * np + 1], af[mi], bf + 2);
          }
        }
      }
    }

    // epilogue: bias, LeakyReLU in f32, one rounding, staged per warp
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = nt * 8 + 2 * tig;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v0 = acc[mi][nt][2 * r] + sb[co];
          float v1 = acc[mi][nt][2 * r + 1] + sb[co + 1];
          if (has_slope) {
            v0 = lrelu(v0, slope);
            v1 = lrelu(v1, slope);
          }
          *reinterpret_cast<uint32_t*>(
              stage + (mi * 16 + g + 8 * r) * ROW + co) = pack_bf16(v0, v1);
        }
      }
    __syncwarp();
    int n, y0, x0;
    tg.at(t, n, y0, x0);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = k * 32 + lane, q = i >> 3, u = i & 7;
      const int oy = y0 + 2 * warp + (q >> 4), ox = x0 + (q & 15);
      if (oy < tg.H && ox < tg.W)
        *reinterpret_cast<uint4*>(
            y + ((size_t)(n * tg.H + oy) * tg.W + ox) * C + u * 8) =
            *reinterpret_cast<const uint4*>(stage + q * ROW + u * 8);
    }
    __syncthreads();  // this buffer is the target of the next copy
  }
}

// ---- f32: 8x8 output tiles, 128 threads of 4 pixels x 8 channels -------
namespace f32 {
constexpr int TH = 8, TW = 8, HH = TH + 2, HW = TW + 2, HPX = HH * HW;
constexpr int THREADS = 128;
constexpr int ROW = odd_units(C * 4) * 4;   // floats per padded row: 68
constexpr size_t W_BYTES = 9 * C * C * 4;
constexpr size_t X_BYTES = HPX * ROW * 4;
constexpr size_t SMEM = W_BYTES + 2 * X_BYTES + C * 4;
}  // namespace f32

__device__ __forceinline__ void load_halo_f32(float* dst, const float* x,
                                              const TileGrid& tg, int t) {
  using namespace f32;
  int n, y0, x0;
  tg.at(t, n, y0, x0);
  for (int i = threadIdx.x; i < HPX * 16; i += THREADS) {
    const int p = i >> 4, u = i & 15;
    const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
    const bool in = gy >= 0 && gy < tg.H && gx >= 0 && gx < tg.W;
    const float* src =
        in ? x + ((size_t)(n * tg.H + gy) * tg.W + gx) * C + u * 4 : x;
    cp_async16(dst + p * ROW + u * 4, src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void fma4(float* acc, float xv, float4 wv) {
  acc[0] = fmaf(xv, wv.x, acc[0]);
  acc[1] = fmaf(xv, wv.y, acc[1]);
  acc[2] = fmaf(xv, wv.z, acc[2]);
  acc[3] = fmaf(xv, wv.w, acc[3]);
}

__global__ void __launch_bounds__(f32::THREADS)
conv3x3_mid_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ b, float* __restrict__ y,
                       TileGrid tg, float slope, int has_slope) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sw = reinterpret_cast<float*>(smem_raw);  // HWIO, [tap][ci][co]
  float* sx = sw + 9 * C * C;   // two halo buffers
  float* sb = sx + 2 * HPX * ROW;
  // thread: channels {4cg..4cg+3} and {32+4cg..}, pixels (r, c0..c0+3)
  const int cg = threadIdx.x & 7, pg = threadIdx.x >> 3;
  const int r = pg >> 1, c0 = (pg & 1) * 4;

  for (int i = threadIdx.x; i < 9 * C * C / 4; i += THREADS)
    cp_async16(sw + i * 4, w + i * 4, 16);
  if (threadIdx.x < C) sb[threadIdx.x] = b[threadIdx.x];
  if (blockIdx.x < tg.count) load_halo_f32(sx, x, tg, blockIdx.x);
  cp_async_commit();

  int it = 0;
  for (int t = blockIdx.x; t < tg.count; t += gridDim.x, ++it) {
    if (t + gridDim.x < tg.count)
      load_halo_f32(sx + ((it + 1) & 1) * HPX * ROW, x, tg, t + gridDim.x);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* src = sx + (it & 1) * HPX * ROW;

    float acc[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[k][o] = 0.f;

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const float* xp = src + ((r + tap / 3) * HW + c0 + tap % 3) * ROW;
      const float* wp = sw + tap * C * C + cg * 4;
#pragma unroll 2
      for (int u = 0; u < C / 4; ++u) {
        float4 xv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          xv[k] = *reinterpret_cast<const float4*>(xp + k * ROW + u * 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* wr = wp + (u * 4 + j) * C;
          const float4 lo = *reinterpret_cast<const float4*>(wr);
          const float4 hi = *reinterpret_cast<const float4*>(wr + 32);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float xs = j == 0 ? xv[k].x : j == 1 ? xv[k].y
                           : j == 2 ? xv[k].z : xv[k].w;
            fma4(acc[k], xs, lo);
            fma4(acc[k] + 4, xs, hi);
          }
        }
      }
    }

    int n, y0, x0;
    tg.at(t, n, y0, x0);
    const int oy = y0 + r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ox = x0 + c0 + k;
      if (oy >= tg.H || ox >= tg.W) continue;
      float* yp = y + ((size_t)(n * tg.H + oy) * tg.W + ox) * C + cg * 4;
      float v[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        v[o] = acc[k][o] + sb[cg * 4 + (o & 3) + (o >> 2) * 32];
        if (has_slope) v[o] = lrelu(v[o], slope);
      }
      *reinterpret_cast<float4*>(yp) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(yp + 32) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();  // this buffer is the target of the next copy
  }
}

template <typename T, typename K>
int launch(K kern, int threads, size_t smem, int TH, int TW, const void* x,
           const void* w, const void* b, void* y, int N, int H, int W,
           float slope, int has_slope, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TileGrid tg(N, H, W, TH, TW);
  const int blocks = persistent_blocks(kern, threads, smem, tg.count);
  if (blocks <= 0) {
    err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  kern<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), tg, slope, has_slope);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, H, W, 64); w: HWIO (3, 3, 64, 64); b: (64,); all of dtype.
// x, w and y 16-byte aligned.
extern "C" int vt_conv3x3_mid(const void* x, const void* w, const void* b,
                              void* y, int N, int H, int W, int dtype,
                              float slope, int has_slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (dtype == VT_F32)
    return launch<float>(conv3x3_mid_f32_kernel, f32::THREADS, f32::SMEM,
                         f32::TH, f32::TW, x, w, b, y, N, H, W, slope,
                         has_slope, s);
  if (dtype == VT_BF16)
    return launch<__nv_bfloat16>(conv3x3_mid_bf16_kernel, b16::THREADS,
                                 b16::SMEM, b16::TH, b16::TW, x, w, b, y, N,
                                 H, W, slope, has_slope, s);
  return cudaErrorInvalidValue;
}

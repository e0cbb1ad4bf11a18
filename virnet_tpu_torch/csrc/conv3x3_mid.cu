// K1 conv3x3_mid: one 'same' 3x3 64->64 conv + bias + optional
// LeakyReLU, NHWC, f32 accumulation, one rounding to the activation dtype.
//
// Replaces: virnet_tpu/ops/pallas_conv.py:conv3x3_mid_pair (:627; Pallas
// bodies _mid_kernel_halo :181 and _mid_kernel :172) and, as L launches
// in a row, conv3x3_mid_stack_pair (:297; _mid_stack_kernel :231).  No
// pixel-pair layout: that existed to fill the TPU's 128 lanes.
//
// Bound on an H100: 73.7 kFLOP per pixel against 256 B (bf16) moved per
// pixel, ~290 FLOP/B, so at the tensor cores' rate it sits near the
// ridge; this kernel runs on the f32 CUDA cores, which makes it
// compute-bound.  Design: a block owns a 16x16 output tile, one thread
// per pixel holding all 64 output sums in registers.  Shared memory
// limits the tile: 64x64 f32 weights alone take 147 KB, so the input
// channels go in chunks of 16 (an 18x18x16 halo tile plus 9x16x64
// weights, 57.6 KB in f32).  Weight reads are warp-wide broadcasts, four
// FMAs per 16-byte shared load.  Tensor cores (wgmma) and a fused L-conv
// stack are later work.
#include "common.cuh"

namespace {

constexpr int C = 64;
constexpr int TILE = 16;
constexpr int CHUNK = 16;
constexpr int HALO = TILE + 2;
constexpr int THREADS = TILE * TILE;

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (HALO * HALO * CHUNK + 9 * CHUNK * C);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_mid_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ y, int H,
                   int W, float slope, int has_slope) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);  // [HALO][HALO][CHUNK]
  T* sw = sx + HALO * HALO * CHUNK;        // [9][CHUNK][C]
  const int n = blockIdx.z;
  const int ty0 = blockIdx.y * TILE, tx0 = blockIdx.x * TILE;
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int gy = ty0 + ly, gx = tx0 + lx;

  float acc[C];
#pragma unroll
  for (int o = 0; o < C; ++o) acc[o] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    __syncthreads();
    for (int i = threadIdx.x; i < HALO * HALO * CHUNK; i += THREADS) {
      const int ci = i % CHUNK, p = i / CHUNK;
      const int yy = ty0 + p / HALO - 1, xx = tx0 + p % HALO - 1;
      const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
      sx[i] = in ? x[((size_t)(n * H + yy) * W + xx) * C + c0 + ci]
                 : fromf<T>(0.f);
    }
    for (int i = threadIdx.x; i < 9 * CHUNK * C; i += THREADS) {
      const int co = i % C, r = i / C;
      sw[i] = w[((r / CHUNK) * C + c0 + r % CHUNK) * C + co];
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const T* xp = sx + ((ly + tap / 3) * HALO + lx + tap % 3) * CHUNK;
      const T* wp = sw + tap * CHUNK * C;
#pragma unroll 1
      for (int ci = 0; ci < CHUNK; ci += 4) {
        float xv[4];
        load4(xp + ci, xv);
#pragma unroll
        for (int k = 0; k < 4; ++k) fma_row<C>(acc, xv[k], wp + (ci + k) * C);
      }
    }
  }
  if (gy < H && gx < W) {
    T* yp = y + ((size_t)(n * H + gy) * W + gx) * C;
#pragma unroll
    for (int o = 0; o < C; ++o) {
      float v = acc[o] + tof(b[o]);
      if (has_slope) v = lrelu(v, slope);
      yp[o] = fromf<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int N,
           int H, int W, float slope, int has_slope, cudaStream_t stream) {
  auto kern = conv3x3_mid_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
  kern<<<grid, THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), H, W, slope, has_slope);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, H, W, 64); w: HWIO (3, 3, 64, 64); b: (64,); all of dtype.
extern "C" int vt_conv3x3_mid(const void* x, const void* w, const void* b,
                              void* y, int N, int H, int W, int dtype,
                              float slope, int has_slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32) return launch<float>(x, w, b, y, N, H, W, slope,
                                            has_slope, s);
  if (dtype == VT_BF16) return launch<__nv_bfloat16>(x, w, b, y, N, H, W,
                                                     slope, has_slope, s);
  return cudaErrorInvalidValue;
}

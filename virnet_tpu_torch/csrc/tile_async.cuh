// Device helpers for tiled 3x3 convolutions on Hopper: asynchronous
// global->shared copies with zero fill (cp.async), ldmatrix, bf16
// mma.sync, division by a multiply, and a persistent walk over output
// tiles.  Shared by K1 (conv3x3_mid.cu), K3 and K8 in bf16
// (dncnn_head.cu), K4 (tail_residual.cu), the SNet level kernels of K2
// and fp32 K3 and K8 (snet_levels.cu) and the blur kernels K5-K7
// (blur.cu).
//
// Layout convention: a halo tile in shared memory is (TH+2) x (TW+2)
// pixels, each pixel a row of `stride` 16-byte units whose count is ODD.
// ldmatrix and 16-byte loads read eight consecutive pixels at one unit
// offset; with an odd unit stride those eight fall on eight different
// 16-byte bank groups, so no access conflicts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the smallest odd number of 16-byte units that holds `bytes`
__host__ __device__ constexpr int odd_units(int bytes) {
  return ((bytes + 15) / 16) | 1;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `src_bytes` (0..16) from global to shared and zero the rest of the
// 16 bytes; src is 16-byte aligned (any valid address when src_bytes is 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// the same for 8 bytes; src is 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// the same for 4 bytes; src is 4-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8 (16-byte aligned)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulation.
// Lane (g, t) = (lane / 4, lane % 4) holds D rows g and g + 8, columns
// 2t and 2t + 1: c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// n / d and n % d by a multiply: with m = ceil(2^32 / d), __umulhi(n, m)
// is floor(n / d) for 0 <= n < 2^21 and 2 <= d < 2^11 (the error n (m d -
// 2^32) / 2^32 stays under 1); d = 1 (m = 2^32 does not fit) is n itself.
// A division by a value known only at run time costs some 20
// instructions, and the index math of the staging copies and epilogues
// runs one per pixel.
struct FastDiv {
  int d;
  unsigned m;
  __device__ explicit FastDiv(int d_)
      : d(d_), m(d_ > 1 ? 0xFFFFFFFFu / d_ + 1 : 0u) {}
  __device__ int div(int n) const {
    return m ? (int)__umulhi((unsigned)n, m) : n;
  }
  __device__ int mod(int n) const { return n - div(n) * d; }
};

// Output tiles of TH x TW pixels over N images of H x W, numbered image by
// image, row of tiles by row of tiles; a persistent block takes tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...
struct TileGrid {
  int H, W, TH, TW, tiles_x, per_image, count;
  __host__ __device__ TileGrid(int N, int H_, int W_, int TH_, int TW_)
      : H(H_), W(W_), TH(TH_), TW(TW_), tiles_x((W_ + TW_ - 1) / TW_),
        per_image(tiles_x * ((H_ + TH_ - 1) / TH_)), count(N * per_image) {}
  // image, first row and first column of tile t
  __device__ void at(int t, int& n, int& y0, int& x0) const {
    n = t / per_image;
    const int r = t % per_image;
    y0 = (r / tiles_x) * TH;
    x0 = (r % tiles_x) * TW;
  }
};

// Blocks for a persistent launch: as many as fit on the card at once,
// and no more than there are tiles.  Returns 0 on a CUDA error.  What fits
// is asked once per (kernel, device, block size, shared memory) and kept:
// the occupancy query costs more host time than a small kernel runs.
template <typename K>
int persistent_blocks(K kern, int threads, size_t smem, int tiles) {
  struct Fit {
    const void* kern;
    int dev, threads;
    size_t smem;
    int fit;
  };
  static Fit known[32];
  static int n_known = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const void* key = reinterpret_cast<const void*>(kern);
  int fit = 0;
  for (int i = 0; i < n_known && fit == 0; ++i)
    if (known[i].kern == key && known[i].dev == dev &&
        known[i].threads == threads && known[i].smem == smem)
      fit = known[i].fit;
  if (fit == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem) != cudaSuccess)
      return 0;
    fit = sms * (per_sm > 0 ? per_sm : 1);
    if (n_known < 32) known[n_known++] = Fit{key, dev, threads, smem, fit};
  }
  return tiles < fit ? tiles : fit;
}

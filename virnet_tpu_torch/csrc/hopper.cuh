// Hopper device helpers shared by the wgmma kernels, K9 (conv_w8a8.cu) and
// K11 (resblock_conv.cu): shared-memory matrix descriptors and the
// wgmma fences, mbarriers, tensor and bulk copies (TMA), and
// cuTensorMapEncodeTiled looked up at run time (no link against libcuda).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_async.cuh"

// the shared-memory matrix descriptor of a K-major operand without
// swizzle: 8-row core matrices of 16-byte rows; `lbo` bytes between the
// two 16-byte halves of a 32-byte K step, `sbo` between 8-row blocks
__device__ __forceinline__ uint64_t mat_desc(const void* p, int lbo,
                                             int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most P of this warpgroup's committed batches run
template <int P> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(P) : "memory");
}
// writes of the generic proxy (st.shared, cp.async) seen by wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accesses of r across an async wgmma
__device__ __forceinline__ void pin(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}
// one arrival that also expects `bytes` of the tensor copy
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// the box at (c, x, y, n) of NHWC x by the tensor copy engine, zeros
// outside the tensor; the box's extent is the map's
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c, int x, int y, int n,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(c), "r"(x), "r"(y), "r"(n), "r"(smem_addr(bar))
      : "memory");
}
// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// by the bulk copy engine
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of bf16 NHWC x (Nb, H, W, C) read in boxes of (bc
// channels, bw pixels, bh rows, 1 image), zeros outside the tensor.
// Returns 0, or the error of a refused map.
inline int nhwc_bf16_map(CUtensorMap* map, const void* x, int Nb, int H,
                         int W, int C, int bc, int bw, int bh) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)Nb};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return 0;
}

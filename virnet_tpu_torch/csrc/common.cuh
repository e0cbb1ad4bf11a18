// Shared device helpers for the virnet_tpu_torch kernels.
//
// Activations and weights come in one dtype T (float or __nv_bfloat16);
// every conv accumulates in f32 and rounds once to T, as the Pallas
// kernels of virnet_tpu/ops/pallas_conv.py do.  bf16 goes through the
// intrinsics only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with ops/fused_conv.py
#define VT_F32 0
#define VT_BF16 1

__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T fromf(float v);
template <> __device__ __forceinline__ float fromf<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
fromf<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch .to()
}

// round f32 to T and back: the one rounding per conv
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return tof(fromf<T>(v));
}

__device__ __forceinline__ float lrelu(float y, float slope) {
  return y >= 0.f ? y : slope * y;
}

// four consecutive values of T (16 B for float, 8 B for bf16) as f32;
// p must be aligned to 4 elements
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  uint2 q = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&q.x);
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&q.y);
  float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  v[0] = fa.x; v[1] = fa.y; v[2] = fb.x; v[3] = fb.y;
}

// acc[0..NO) += xv * w[0..NO), w in shared memory (a broadcast read: all
// threads of a warp walk the same weights)
template <int NO, typename T>
__device__ __forceinline__ void fma_row(float acc[NO], float xv,
                                        const T* w) {
#pragma unroll
  for (int o = 0; o < NO; o += 4) {
    float wv[4];
    load4(w + o, wv);
    acc[o] = fmaf(xv, wv[0], acc[o]);
    acc[o + 1] = fmaf(xv, wv[1], acc[o + 1]);
    acc[o + 2] = fmaf(xv, wv[2], acc[o + 2]);
    acc[o + 3] = fmaf(xv, wv[3], acc[o + 3]);
  }
}

// block-cooperative copy of n elements of T into shared memory
template <typename T>
__device__ __forceinline__ void copy_to_smem(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// K4 conv3x3_tail_residual: RNet's tail, a 'same' 3x3 conv C->3 plus
// bias, rounded to the feature dtype, then + x_in in f32, emitted in f32
// (x_in's dtype; under bf16 compute the restored image stays f32).
//
// Replaces: virnet_tpu/ops/pallas_conv.py:conv3x3_tail_residual (:841;
// Pallas body _tail_res_kernel :793).  Unlike the TPU kernel it takes the
// feature map at its padded size (Hp, Wp) and x_in at the image size
// (h, w), and writes only [0, h) x [0, w): one kernel covers both the
// pad-free case (virnet_tpu/models/attresunet.py:189-203) and the padded
// case (:204-215, :228), where the tap at row h reads the padded row
// exactly as the reference's conv-then-slice does.
//
// Bound on an H100: 5.2 kFLOP per pixel against ~216 B per pixel (bf16
// features read once, x_in read and the output written in f32), ~24
// FLOP/B: memory bound.  Design: a block owns a 16x16 pixel tile, one
// thread per pixel; the 9 taps re-read neighbouring pixels' features,
// which the tile keeps in L1, so device memory sees each feature about
// once.  Weights (9 x C x 3) sit in shared memory and are broadcast.
#include "common.cuh"

namespace {

constexpr int CO = 3;
constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int MAX_C = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const T* __restrict__ feats, const float* __restrict__ xin,
            const T* __restrict__ w, const T* __restrict__ b,
            float* __restrict__ out, int Hp, int Wp, int h, int w_img,
            int C) {
  __shared__ float sw[9 * MAX_C * CO];
  __shared__ float sb[CO];
  for (int i = threadIdx.x; i < 9 * C * CO; i += THREADS) sw[i] = tof(w[i]);
  if (threadIdx.x < CO) sb[threadIdx.x] = tof(b[threadIdx.x]);
  __syncthreads();

  const int n = blockIdx.z;
  const int gy = blockIdx.y * TILE + threadIdx.x / TILE;
  const int gx = blockIdx.x * TILE + threadIdx.x % TILE;
  if (gy >= h || gx >= w_img) return;

  float acc[CO] = {0.f, 0.f, 0.f};
  const T* fn = feats + (size_t)n * Hp * Wp * C;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int yy = gy + tap / 3 - 1, xx = gx + tap % 3 - 1;
    if (yy < 0 || yy >= Hp || xx < 0 || xx >= Wp) continue;
    const T* fp = fn + ((size_t)yy * Wp + xx) * C;
    const float* wp = sw + tap * C * CO;
#pragma unroll 4
    for (int ci = 0; ci < C; ci += 4) {
      float fv[4];
      load4(fp + ci, fv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < CO; ++c)
          acc[c] = fmaf(fv[k], wp[(ci + k) * CO + c], acc[c]);
    }
  }
  const size_t o = ((size_t)(n * h + gy) * w_img + gx) * CO;
#pragma unroll
  for (int c = 0; c < CO; ++c)
    out[o + c] = round_to<T>(acc[c] + sb[c]) + xin[o + c];
}

template <typename T>
int launch(const void* feats, const void* xin, const void* w, const void* b,
           void* out, int N, int Hp, int Wp, int h, int w_img, int C,
           cudaStream_t stream) {
  dim3 grid((w_img + TILE - 1) / TILE, (h + TILE - 1) / TILE, N);
  tail_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(xin),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<float*>(out), Hp, Wp, h, w_img, C);
  return cudaGetLastError();
}

}  // namespace

// feats (N,Hp,Wp,C) dtype; xin (N,h,w,3) f32; w HWIO (3,3,C,3) dtype;
// b (3,) dtype; out (N,h,w,3) f32.  h <= Hp, w <= Wp, C % 4 == 0.
extern "C" int vt_tail_residual(const void* feats, const void* xin,
                                const void* w, const void* b, void* out,
                                int N, int Hp, int Wp, int h, int w_img,
                                int C, int dtype, void* stream) {
  if (C % 4 != 0 || C > MAX_C || h > Hp || w_img > Wp)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32)
    return launch<float>(feats, xin, w, b, out, N, Hp, Wp, h, w_img, C, s);
  if (dtype == VT_BF16)
    return launch<__nv_bfloat16>(feats, xin, w, b, out, N, Hp, Wp, h, w_img,
                                 C, s);
  return cudaErrorInvalidValue;
}

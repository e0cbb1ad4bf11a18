// K9 conv_w8a8: the 'same' convolution of int8 NHWC activations by int8
// weights on the s8 tensor cores, int32 sums, dequantized in the epilogue:
// y[o] = round_T((float(acc[o]) * sw[o]) + bias[o]), each of the multiply
// and the add rounded on its own (no FMA contraction), as the JAX package
// takes them, then one rounding to the output dtype T (bf16 in serving,
// f32 for the checks).  Kernel sizes 3x3 and 1x1, zero padding k / 2.
//
// Replaces: no Pallas kernel.  virnet_tpu/ops/qconv.py:conv_w8a8 (:44)
// leaves its int8 product to XLA (lax.conv_general_dilated with
// preferred_element_type=int32); the port's int8 serving mode exists to
// use the card's integer tensor cores, so the product is written by hand.
// The quantization of activations and weights stays plain PyTorch
// (ops/qconv.py), as the JAX package leaves it to XLA.
//
// Bound on an H100 SXM (1,979 TOPS dense int8, 3.35 TB/s): 2 k^2 Ci Co
// operations per output pixel against Ci bytes read and 2 Co (bf16)
// written.  At RNet's 96-channel 3x3 on 32x256^2 that is 348 GOP, 0.176
// ms of operations, against 604 MB, 0.180 ms of bytes: the convolution
// sits at the ridge, and the quantize passes around it (several f32
// passes over the activations) cost more than it does.
//
// Design (K1's implicit GEMM, tile_async.cuh, with s8 fragments):
//  - a block computes 8 x 16 output pixels x 64 output channels; warp w
//    takes tile row w, M = 16 pixels, N = 64 (eight n8 tiles);
//  - the input channels come 32 at a time (one k32 step of
//    mma.sync.m16n8k32.s8): the (8 + k - 1) x (16 + k - 1) halo tile of
//    those 32 channels and the block's weights for them arrive by 16-byte
//    cp.async with zero fill (the 'same' padding, and output channels past
//    the last, at no cost), double-buffered over the 32-channel chunks;
//  - activation and weight rows are padded to three 16-byte units in
//    shared memory (odd), so ldmatrix reads eight rows conflict-free; A
//    fragments by ldmatrix from the halo tile shifted per tap, B by
//    ldmatrix from weights laid out (tap, co, ci), each output channel's
//    input channels contiguous (the col operand);
//  - the wrapper pads Ci to a multiple of 32 and the weights' Co to a
//    multiple of 8 with zeros, which is exact in int8;
//  - one tile per block, no persistent walk, the epilogue's stores not
//    staged: a right, simple kernel first.  wgmma s8, TMA and fusing the
//    activation quantize into the previous layer's epilogue are later
//    work (ROADMAP.md, Queue 2).
#include <limits.h>

#include "common.cuh"
#include "tile_async.cuh"

namespace {

constexpr int TH = 8, TW = 16;   // output tile: 8 rows x 16 pixels
constexpr int THREADS = 256;     // 8 warps, one tile row each
constexpr int KC = 32;           // input channels per stage: one k32 step
constexpr int ROWB = odd_units(KC) * 16;   // bytes per smem row: 48
constexpr int CO_B = 64;         // output channels per block

template <int KS> struct Geo {
  static constexpr int HH = TH + KS - 1, HW = TW + KS - 1, HPX = HH * HW;
  static constexpr int X_BYTES = HPX * ROWB;
  static constexpr int W_BYTES = KS * KS * CO_B * ROWB;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr size_t SMEM = 2 * (size_t)STAGE;
};

// D = A(16x32 s8, row) * B(32x8 s8, col) + D, s32 sums.  Lane (g, t) =
// (lane / 4, lane % 4) holds D rows g and g + 8, columns 2t and 2t + 1:
// c = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// stage the halo tile and the block's weights of input channels
// [32c, 32c + 32) into `dst`
template <int KS>
__device__ __forceinline__ void load_stage(
    unsigned char* dst, const int8_t* x, const int8_t* w, int n, int y0,
    int x0, int co0, int c, int H, int W, int Cip, int Cop) {
  using G = Geo<KS>;
  constexpr int P = KS / 2;
  for (int i = threadIdx.x; i < G::HPX * 2; i += THREADS) {
    const int p = i >> 1, u = i & 1;
    const int gy = y0 - P + p / G::HW, gx = x0 - P + p % G::HW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int8_t* src =
        in ? x + ((size_t)(n * H + gy) * W + gx) * Cip + c * KC + u * 16
           : x;
    cp_async16(dst + p * ROWB + u * 16, src, in ? 16 : 0);
  }
  unsigned char* sw = dst + G::X_BYTES;
  for (int i = threadIdx.x; i < KS * KS * CO_B * 2; i += THREADS) {
    const int row = i >> 1, u = i & 1;
    const int tap = row / CO_B, co = co0 + row % CO_B;
    const bool in = co < Cop;
    const int8_t* src =
        in ? w + (size_t)(tap * Cop + co) * Cip + c * KC + u * 16 : w;
    cp_async16(sw + row * ROWB + u * 16, src, in ? 16 : 0);
  }
}

template <int KS, typename T>
__global__ void __launch_bounds__(THREADS)
conv_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ sw,
                 const float* __restrict__ bias, T* __restrict__ y, int H,
                 int W, int Cip, int Co, int Cop, int tiles_x,
                 int tiles_per_image) {
  using G = Geo<KS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n = blockIdx.x / tiles_per_image;
  const int r = blockIdx.x % tiles_per_image;
  const int y0 = (r / tiles_x) * TH, x0 = (r % tiles_x) * TW;
  const int co0 = blockIdx.y * CO_B;
  const int chunks = Cip / KC;

  int acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0;

  load_stage<KS>(smem, x, w, n, y0, x0, co0, 0, H, W, Cip, Cop);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks)
      load_stage<KS>(smem + ((c + 1) & 1) * G::STAGE, x, w, n, y0, x0, co0,
                     c + 1, H, W, Cip, Cop);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* sx = smem + (c & 1) * G::STAGE;
    const unsigned char* swt = sx + G::X_BYTES;
#pragma unroll
    for (int tap = 0; tap < KS * KS; ++tap) {
      const int dy = tap / KS, dx = tap % KS;
      // A: lane l addresses pixel l % 16 of the row, bytes 16 (l / 16)
      uint32_t af[4];
      ldsm_x4(af, sx + ((warp + dy) * G::HW + dx + (lane & 15)) * ROWB +
                      (lane >> 4) * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B: lane l addresses output channel 8 (l / 16) + l % 8 of the
        // pair of n tiles, bytes 16 ((l / 8) % 2)
        uint32_t bf[4];
        ldsm_x4(bf, swt + (tap * CO_B + np * 16 + (lane >> 4) * 8 +
                           (lane & 7)) * ROWB +
                          ((lane >> 3) & 1) * 16);
        mma_s8(acc[2 * np], af, bf);
        mma_s8(acc[2 * np + 1], af, bf + 2);
      }
    }
    __syncthreads();  // this buffer is the target of the next copy
  }

  const int oy = y0 + warp;
  if (oy >= H) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = co0 + nt * 8 + 2 * t4 + j;
      if (o >= Co) continue;
      const float s = sw[o];
      const float b = bias ? bias[o] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ox = x0 + g + 8 * h;
        if (ox >= W) continue;
        float v = __fmul_rn(__int2float_rn(acc[nt][2 * h + j]), s);
        if (bias) v = __fadd_rn(v, b);
        y[((size_t)(n * H + oy) * W + ox) * Co + o] = fromf<T>(v);
      }
    }
  }
}

template <int KS, typename T>
int launch(const void* x, const void* w, const void* sw, const void* bias,
           void* y, int N, int H, int W, int Cip, int Co, int Cop,
           cudaStream_t stream) {
  auto kern = conv_w8a8_kernel<KS, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Geo<KS>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long tiles = (long long)N * tiles_x * tiles_y;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (Cop + CO_B - 1) / CO_B);
  kern<<<grid, THREADS, Geo<KS>::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<T*>(y), H, W, Cip, Co, Cop, tiles_x, tiles_x * tiles_y);
  return cudaGetLastError();
}

}  // namespace

// x: int8 (N, H, W, Cip); w: int8 (ks * ks, Cop, Cip); sw, bias: float
// (Co,), bias may be null; y: (N, H, W, Co) of out_dtype (VT_F32 or
// VT_BF16).  Cip a multiple of 32, Cop a multiple of 8 with Co <= Cop;
// x and w 16-byte aligned.
extern "C" int vt_conv_w8a8(const void* x, const void* w, const void* sw,
                            const void* bias, void* y, int N, int H, int W,
                            int Cip, int Co, int Cop, int ks, int out_dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || Cip < KC || Cip % KC || Co < 1 ||
      Cop < Co || Cop % 8)
    return cudaErrorInvalidValue;
  if (ks == 3 && out_dtype == VT_F32)
    return launch<3, float>(x, w, sw, bias, y, N, H, W, Cip, Co, Cop, s);
  if (ks == 3 && out_dtype == VT_BF16)
    return launch<3, __nv_bfloat16>(x, w, sw, bias, y, N, H, W, Cip, Co,
                                    Cop, s);
  if (ks == 1 && out_dtype == VT_F32)
    return launch<1, float>(x, w, sw, bias, y, N, H, W, Cip, Co, Cop, s);
  if (ks == 1 && out_dtype == VT_BF16)
    return launch<1, __nv_bfloat16>(x, w, sw, bias, y, N, H, W, Cip, Co,
                                    Cop, s);
  return cudaErrorInvalidValue;
}

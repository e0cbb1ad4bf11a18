// SNet level kernels: K2 dncnn_fused (both dtypes) and K3 dncnn_head_fused
// in fp32 as a chain of launches, one per level, with each 64-channel level
// map in device memory between them:
//
//   snet_conv1        3->64 + bias + lrelu                  (this file)
//   L x K1            64->64 + bias + lrelu                 (conv3x3_mid.cu)
//   snet_last         64->co + bias, and for K3 the sigma
//                     epilogue and RNet's head conv          (this file)
//
// Replaces: virnet_tpu/ops/pallas_conv.py:dncnn_pair_fused (:474; body
// _dncnn_kernel :369) and, in fp32, dncnn_head_fused (:1289; halo
// pallas_call :1512, carry :1459) and its mode 'slabzero', the probe K8
// (_dncnn_head_kernel_slabzero :1183, pallas_call :1412).  K3 and K8 in
// bf16 are the same chain under dncnn_head.cu's entry points: the bodies
// of snet_conv1 and snet_last (snet_levels.cuh) and a wgmma mid kernel.
//
// K8 runs the chain on a view of the input cut into slabs of r rows (N * H
// / r images of r rows): the level maps and K1 see slab edges as image
// edges, and snet_conv1 and snet_last, given XS = H / r, read x one row up
// with zeros in row -1 of every input image (row 0 of every XS-th slab).
// Nothing is recomputed in either mode.
//
// Function: conv1 3->64 + LeakyReLU, L mids 64->64 + LeakyReLU, conv_last
// 64->co, zero 'same' padding at every level with exact image borders,
// f32 sums and one rounding to the activation dtype T per conv.  K3 also:
// logits rounded to T, sigma = exp(clip(logits, lmin, lmax)) and
// sqrt(sigma) in f32 (as the JAX kernel rounds them), sigma emitted in T,
// sqrt(sigma) rounded to T and zero outside the image, head = conv(x,
// wh[:, :, :3]) + conv(sqrt(sigma), wh[:, :, 3:]) + bh with no
// concatenation built.  Any N, H, W >= 1; co in 1..3; CF a multiple of 16
// up to 256.
//
// Why a chain and not one fused launch.  A fused SNet recomputes a halo of
// L+1 or L+2 pixels around every tile at every level (1.4-1.6x at a 24x24
// tile) and keeps two 64-channel level buffers per block, which in f32 do
// not fit in L2 over a persistent grid.  A level map between two launches
// costs one write and one read of 64 channels per pixel, 0.012 ms a level
// at 1x321x481 in bf16 and 0.32 ms at 32x256^2 in f32, less than the halo
// recompute, and lets the mids run on K1, which beats F.conv2d in both
// dtypes.
//
// Bounds on an H100 SXM (67 TFLOP/s f32 CUDA cores, 3.35 TB/s):
//  - snet_conv1: 3456 FLOP per pixel against 6 + 128 B (bf16) or 12 + 256 B
//    (f32) read and written: memory bound.  A block stages an 18x18 x tile
//    (the next tile's x is loaded into registers under this tile's sums)
//    and the 1,728 weights in shared memory as f32.  Shared memory
//    delivers 128 bytes a clock to the registers, broadcasts included, so
//    one pixel per thread reading every weight for every pixel held the
//    FMA units to a quarter of their rate; instead a thread keeps a
//    register block of 8 pixels x 8 channels (Block8): each weight read
//    serves 8 pixels, and one row of 10 inputs the three horizontal taps.
//    The 64 channels of a pixel leave as 16-byte stores of 8 lanes side by
//    side (128 contiguous bytes per instruction in f32).
//  - snet_last, logits: 1152 co FLOP per pixel against 128 or 256 B read:
//    memory bound.  The 64-channel level of a 16x16 tile and its 1-pixel
//    ring arrives by 16-byte cp.async in chunks of 64 bytes per pixel,
//    double buffered, so that the next chunk (of this tile or the next)
//    is in flight while this one's sums run; pixel rows of 5 16-byte units
//    (odd: conflict-free).  One thread per output pixel.
//  - snet_last, sigma + head: the tile's level with a 2-pixel ring; conv_last
//    at margin 1 (18x18, two pixels for some threads, which share each
//    weight read), the sigma epilogue, then [x | sqrt(sigma)] as an f32
//    (3+co) x 18x18 plane in shared memory, and the head conv in passes of
//    32 channels, a register block of 8 pixels x 4 channels per thread,
//    the head weights (all CF columns, loaded once per block) in shared
//    memory; bias in f32, one rounding.  In f32 everything stays exact on
//    the CUDA cores (no TF32).
// Both kernels are persistent: as many blocks as fit walk the tiles, and
// each loads its weights once.  Their device bodies live in
// snet_levels.cuh, which dncnn_head.cu shares.
#include "snet_levels.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
snet_conv1_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ y, TileGrid tg,
                  int xs, float slope) {
  conv1_body<T>(x, w, b, y, tg, xs, slope);
}

template <typename T, int CO, bool HEAD>
__global__ void __launch_bounds__(THREADS, 2)
snet_last_kernel(LastArgs a, TileGrid tg) {
  last_body<T, CO, HEAD>(a, tg);
}

template <typename T, int CO, bool HEAD>
int last(const LastArgs& a, cudaStream_t stream) {
  return launch_last(snet_last_kernel<T, CO, HEAD>, last_smem<CO, HEAD>(a.CF),
                     a, stream);
}

template <typename T, bool HEAD>
int last_co(const LastArgs& a, int CO, cudaStream_t stream) {
  switch (CO) {
    case 1: return last<T, 1, HEAD>(a, stream);
    case 2: return last<T, 2, HEAD>(a, stream);
    case 3: return last<T, 3, HEAD>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// snet_conv1: x (N,H,W,3), w HWIO (3,3,3,64), b (64) -> y (N,H,W,64)
// = lrelu(conv(x, w) + b), all of dtype; y 16-byte aligned.  With xs > 0
// (K8: N slabs, xs of them per input image) x is read one row up.
extern "C" int vt_snet_conv1(const void* x, const void* w, const void* b,
                             void* y, int N, int H, int W, int xs, int dtype,
                             float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || xs < 0 || (xs > 0 && N % xs != 0))
    return cudaErrorInvalidValue;
  if (dtype == VT_F32)
    return launch_conv1<float>(snet_conv1_kernel<float>, x, w, b, y, N, H, W,
                               xs, slope, s);
  if (dtype == VT_BF16)
    return launch_conv1<__nv_bfloat16>(snet_conv1_kernel<__nv_bfloat16>, x,
                                       w, b, y, N, H, W, xs, slope, s);
  return cudaErrorInvalidValue;
}

// snet_last: lev (N,H,W,64), the last level; wl HWIO (3,3,64,CO), bl (CO).
// head = 0: out0 = logits (N,H,W,CO); x, wh, bh, out1 unused.
// head = 1 (fp32 only; bf16 is vt_dncnn_head_last): x (N,H,W,3), wh HWIO
// (3,3,3+CO,CF), bh (CF); out0 = head (N,H,W,CF), out1 = sigma
// (N,H,W,CO).  All of dtype; lev and out0 16-byte aligned.  With xs > 0
// (K8, head = 1) x is read one row up, as in vt_snet_conv1.
extern "C" int vt_snet_last(const void* lev, const void* x, const void* wl,
                            const void* bl, const void* wh, const void* bh,
                            void* out0, void* out1, int N, int H, int W,
                            int CO, int CF, int head, int xs, int dtype,
                            float lmin, float lmax, void* stream) {
  if (last_args_bad(N, H, W, CO, CF, head, xs))
    return cudaErrorInvalidValue;
  const LastArgs a{lev, x, wl, bl, wh, bh, out0, out1,
                   N, H, W, head ? CF : 0, xs, lmin, lmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32)
    return head ? last_co<float, true>(a, CO, s)
                : last_co<float, false>(a, CO, s);
  if (dtype == VT_BF16 && !head)
    return last_co<__nv_bfloat16, false>(a, CO, s);
  return cudaErrorInvalidValue;
}

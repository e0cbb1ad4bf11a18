// K11 resblock_conv: one 'same' 3x3 convolution of an unconditioned RNet
// AttResBlock (models/attresunet.py) in bf16, with the block's elementwise
// passes inside: y = conv3x3(x, W) in f32 sums over bf16 NHWC x and bf16
// weights, then one rounding to bf16, in one of two modes:
//   first   y = lrelu(conv(lrelu(x), W1) + b1): LeakyReLU(0.2) of each
//           input value (rounded to bf16, as F.leaky_relu on bf16 does)
//           before the product, the bias and LeakyReLU again in f32 after
//           it; the output is what conv2 consumes;
//   second  out = x + conv(y, W2) + b2: the bias, then the block's input x
//           (its residual, read as bf16) added in f32 after the product.
// One block is two launches and no PyTorch pass.  ops/resblock.py holds
// the plain version (resblock_conv_plain), the weights' layout and the
// split of the output channels.
//
// Replaces: no Pallas kernel.  The JAX package runs RNet's body convs
// through lax.conv_general_dilated (virnet_tpu/models/common.py:conv) and
// XLA fuses the bias, LeakyReLU and residual passes into them; PyTorch's
// cuDNN route cannot (it adds the bias in a pass of its own, and has no
// fused LeakyReLU), so around each block's two convolutions it made some
// eleven activation-sized reads and writes.  This kernel makes none.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): 2 * 9 * Ci *
// Co operations a pixel against 2 Ci bytes read and 2 Co written (and 2
// Co of residual in `second`).  The body convs of the 32 x 256^2 flagship
// batch: 32x256^2x96 is 348 GFLOP, 0.352 ms of operations against 0.81 (first)
// or 1.21 GB (second), 0.24 or 0.36 ms of bytes; 32x128^2x192 348 GFLOP,
// 0.352 ms against 0.12-0.18 ms; 32x64^2x288 196 GFLOP, 0.198 ms.  Bound
// by operations: the design keeps the tensor cores fed.
//
// Design (wgmma bf16, one block of two warpgroups per SM):
//  - implicit GEMM: the pixel tile is M (32 rows x 8 pixels; each
//    warpgroup takes 16 rows as two M = 64 blocks of 8 rows x 8 pixels),
//    a split of N of the output channels is N (64-112, from ops/resblock
//    .plan: RNet's 96 one split, 160 = 2 x 80, 192 = 2 x 96, 224 = 2 x
//    112, 288 = 3 x 96), K the 9 taps x the input channels;
//  - a persistent grid of at most one block per SM; block b takes split b
//    % splits and every (gridDim / splits)-th tile, so the splits of a
//    tile run side by side and neighbouring tiles' halos meet in L2;
//  - a step is one (tile, chunk of 16 input channels): its halo (34 x 10
//    pixels, zeros outside the tensor: the 'same' padding) arrives as two
//    tensor copies of 8 channels, each pixel a 16-byte row, the layout
//    wgmma reads without swizzle, and the chunk's weights of the split (9
//    taps x 16 x N, laid out on the host as the B operand) as one bulk
//    copy, onto the stage's mbarrier, in a ring of 4 stages, 3 steps
//    ahead across tiles (bf16 weights do not stay resident: 9 x 96 x 288
//    x 2 B is 498 KB);
//  - each warpgroup issues a step's 9 taps x 2 M blocks of m64nNk16
//    asynchronously, A and B read straight from shared memory, and keeps
//    them in flight while the block prepares the next step; in `first` the
//    next step's halo gets its LeakyReLU in place in shared memory then
//    (each value serves 9 taps, and lrelu(0) = 0 keeps the zero fill);
//  - the epilogue adds the bias (and in `second` the residual, loaded into
//    registers while the tile's last products run), stages each warp's 16
//    pixels x N outputs in shared memory and stores them as 16-byte writes.
// What sets the pace (variants timed on an H100 SXM, 700 W): the products
// themselves, whose A and B (5 KB an m64n96k16) both come from shared
// memory: waiting for each step's products before the next (no overlap
// across steps) costs only 7-10% more, a ring of 3 stages the same as 4.
// At 32 x 256^2 x 96 the epilogue takes ~15% of the time (both
// warpgroups stop for it) and `first`'s in-place LeakyReLU ~6%.
#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tile_async.cuh"

namespace {

constexpr int THREADS = 256;     // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int TH = 32, TW = 8;   // output tile; warpgroup g takes 16 rows
constexpr int HH = TH + 2, HW = TW + 2, HPX = HH * HW;
constexpr int KC = 16;           // input channels a step: one k16
constexpr int STAGES = 4;
// one 8-channel half of a staged halo: HPX rows of 16 bytes, padded to
// the 128 bytes a tensor copy's destination is aligned to
constexpr int HALF = (HPX * 16 + 127) / 128 * 128;
constexpr int HALO_TX = 2 * HPX * 16;   // bytes the two tensor copies bring
constexpr size_t SMEM_MAX = 232448;     // what a block may have on an H100
constexpr float SLOPE = 0.2f;           // the blocks' LeakyReLU

enum Mode { FIRST = 0, SECOND = 1 };

// bytes of a split's weights for one chunk: 9 taps x 2 halves x N rows of
// 16 bytes
__host__ __device__ constexpr int w_bytes(int n) { return 9 * 2 * n * 16; }
__host__ __device__ constexpr int stage_bytes(int n) {
  return 2 * HALF + w_bytes(n);
}
// bytes of one staged output row (N bf16 values), an odd number of
// 16-byte units so that the eight pixels of a store fall on eight bank
// groups
__host__ __device__ constexpr int orow_bytes(int n) {
  return odd_units(n * 2) * 16;
}
// byte offsets of the regions past the ring: output staging, bias, barriers
__host__ __device__ constexpr size_t out_at(int n) {
  return (size_t)STAGES * stage_bytes(n);
}
__host__ __device__ constexpr size_t bias_at(int n) {
  return out_at(n) + (size_t)WARPS * 16 * orow_bytes(n);
}
__host__ __device__ constexpr size_t bars_at(int n) {
  return bias_at(n) + (size_t)n * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return bars_at(n) + STAGES * sizeof(uint64_t);
}

// D (64 x N f32, in registers) = A (64 x 16 bf16) * B (16 x N bf16) [+ D],
// A and B K-major in shared memory; warp w of the warpgroup holds rows 16w
// + g and 16w + g + 8 (g = lane / 4) of each n8 block j at d[4j .. 4j + 3]:
// {(g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1)}
// with t = lane % 4.
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<80> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39}, "
        "%40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<112> {
  static __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55}, "
        "%56, %57, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


// LeakyReLU of two bf16 values packed in a word, each rounded to bf16
// from its f32 product, as F.leaky_relu computes on bf16
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t w) {
  float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  lo = lo > 0.f ? lo : lo * SLOPE;
  hi = hi > 0.f ? hi : hi * SLOPE;
  return pack_bf16(lo, hi);
}

// `first`: LeakyReLU in place over a staged halo (both halves)
__device__ __forceinline__ void lrelu_halo(unsigned char* halo) {
  for (int i = threadIdx.x; i < 2 * HPX; i += THREADS) {
    const int h = i >= HPX;
    uint4* p = reinterpret_cast<uint4*>(halo + h * HALF + (i - h * HPX) * 16);
    uint4 u = *p;
    u.x = lrelu_bf16x2(u.x);
    u.y = lrelu_bf16x2(u.y);
    u.z = lrelu_bf16x2(u.z);
    u.w = lrelu_bf16x2(u.w);
    *p = u;
  }
}

template <int MODE, int N>
__global__ void __launch_bounds__(THREADS, 1)
resblock_conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ bias,
                          const __nv_bfloat16* __restrict__ res,
                          __nv_bfloat16* __restrict__ y, int Nb, int H,
                          int W, int Ci, int Co, int splits) {
  constexpr int NR = N / 2;       // accumulators a thread, per M block
  constexpr int ORow = orow_bytes(N);
  extern __shared__ __align__(128) unsigned char smem[];
  float* biasf = reinterpret_cast<float*>(smem + bias_at(N));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + bars_at(N));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x % splits, co0 = split * N;
  const int first = blockIdx.x / splits, stride = gridDim.x / splits;
  const int chunks = Ci / KC;
  const TileGrid tg(Nb, H, W, TH, TW);
  const int items = first < tg.count ? (tg.count - 1 - first) / stride + 1
                                     : 0;
  const int steps = items * chunks;   // (tile, chunk) pairs of the block
  if (steps == 0) return;

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int o = threadIdx.x; o < N; o += THREADS)
    biasf[o] = co0 + o < Co ? __bfloat162float(bias[co0 + o]) : 0.f;
  __syncthreads();   // the barriers are initialized, the bias staged

  // step st's halo and weights into stage st % STAGES (thread 0)
  auto issue = [&](int st) {
    const int k = st % STAGES, c = st % chunks;
    int n, y0, x0;
    tg.at(first + st / chunks * stride, n, y0, x0);
    unsigned char* s = smem + (size_t)k * stage_bytes(N);
    mbar_expect(bars + k, HALO_TX + w_bytes(N));
    tma_box(s, &xmap, c * KC, x0 - 1, y0 - 1, n, bars + k);
    tma_box(s + HALF, &xmap, c * KC + 8, x0 - 1, y0 - 1, n, bars + k);
    bulk_copy(s + 2 * HALF,
              reinterpret_cast<const unsigned char*>(w) +
                  ((size_t)split * chunks + c) * w_bytes(N),
              w_bytes(N), bars + k);
  };
  auto landed = [&](int st) {
    mbar_wait(bars + st % STAGES, (st / STAGES) & 1);
  };
  if (threadIdx.x == 0)
    for (int st = 0; st < STAGES - 1 && st < steps; ++st) issue(st);
  if constexpr (MODE == FIRST) {
    landed(0);
    lrelu_halo(smem);
    fence_async_smem();
  }

  float acc[2][NR];
  uint32_t rr[2][MODE == SECOND ? N / 4 : 1];   // the residual, bf16 pairs
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[m][i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int c = s % chunks;
    unsigned char* st = smem + (size_t)(s % STAGES) * stage_bytes(N);
    if constexpr (MODE == FIRST)
      __syncthreads();   // every thread's LeakyReLU of this stage is done
    else
      landed(s);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t db = mat_desc(st + 2 * HALF + tap * 2 * N * 16, N * 16,
                                   128);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // M block m: tile rows 16 wg + 8 m ... + 7, one core matrix each
        const int p0 = (16 * wg + 8 * m + dy) * HW + dx;
        const uint64_t da = mat_desc(st + p0 * 16, HALF, HW * 16);
        Wgmma<N>::mma(acc[m], da, db, c > 0 || tap > 0);
      }
    }
    wgmma_commit();
    int n, y0, x0;
    tg.at(first + s / chunks * stride, n, y0, x0);
    if constexpr (MODE == SECOND) {
      // the tile's residual while its last products run: this thread's
      // pairs (pixel g + 8h of its warp's rows, channels 8j + 2t, + 1)
      if (c == chunks - 1) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int oy = y0 + 16 * wg + 8 * m + 2 * wq + h, ox = x0 + g;
            const bool in = oy < H && ox < W;
            const uint32_t* r = reinterpret_cast<const uint32_t*>(
                res + ((size_t)(n * H + (in ? oy : 0)) * W + (in ? ox : 0)) *
                          Co + co0 + 2 * t4);
#pragma unroll
            for (int j = 0; j < N / 8; ++j)
              rr[m][2 * j + h] = in && co0 + 8 * j < Co ? __ldg(r + 4 * j)
                                                        : 0u;
          }
      }
    }
    // step s - 1's products are done in both warpgroups: its stage, the
    // one step s + STAGES - 1 takes, is free
    wgmma_wait<1>();
    __syncthreads();
    if (threadIdx.x == 0 && s + STAGES - 1 < steps) issue(s + STAGES - 1);
    if constexpr (MODE == FIRST) {
      if (s + 1 < steps) {
        landed(s + 1);
        lrelu_halo(smem + (size_t)((s + 1) % STAGES) * stage_bytes(N));
        fence_async_smem();
      }
    }
    if (c == chunks - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < NR; ++i) pin(acc[m][i]);
      // epilogue: bias (and LeakyReLU or the residual) into this warp's
      // staging rows (16 pixels: 2 tile rows x 8), then 16-byte stores of
      // each pixel's N channels
      unsigned char* ow = smem + out_at(N) + (size_t)warp * 16 * ORow;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int ol = j * 8 + 2 * t4;
          const float b0 = biasf[ol], b1 = biasf[ol + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[m][4 * j + 2 * h] + b0;
            float v1 = acc[m][4 * j + 2 * h + 1] + b1;
            if constexpr (MODE == FIRST) {
              v0 = lrelu(v0, SLOPE);
              v1 = lrelu(v1, SLOPE);
            } else {
              const uint32_t r = rr[m][2 * j + h];
              v0 += __uint_as_float(r << 16);
              v1 += __uint_as_float(r & 0xffff0000u);
            }
            *reinterpret_cast<uint32_t*>(ow + (g + 8 * h) * ORow + ol * 2) =
                pack_bf16(v0, v1);
          }
        }
        __syncwarp();
        // staged pixel px: tile row 16 wg + 8 m + 2 wq + px / 8, column
        // px % 8
        const int oy0 = y0 + 16 * wg + 8 * m + 2 * wq;
        constexpr int UNITS = N / 8;   // 16-byte units a pixel
        for (int i = lane; i < 16 * UNITS; i += 32) {
          const int px = i / UNITS, u = i % UNITS;
          const int oy = oy0 + px / 8, ox = x0 + px % 8;
          if (oy < H && ox < W && co0 + u * 8 < Co)
            *reinterpret_cast<uint4*>(
                y + ((size_t)(n * H + oy) * W + ox) * Co + co0 + u * 8) =
                *reinterpret_cast<const uint4*>(ow + px * ORow + u * 16);
        }
        __syncwarp();   // the staging rows are free again
      }
    }
  }
  // the last step's products were waited for in its epilogue; said again
  // here, so that ptxas need not add a wait of its own on the way out
  wgmma_wait<0>();
}

template <int MODE, int N>
int launch_n(const CUtensorMap& map, const void* w, const void* bias,
             const void* res, void* y, int Nb, int H, int W, int Ci, int Co,
             int splits, cudaStream_t stream) {
  auto kern = resblock_conv_bf16_kernel<MODE, N>;
  constexpr size_t smem = smem_bytes(N);
  static_assert(smem <= SMEM_MAX, "a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TileGrid tg(Nb, H, W, TH, TW);
  const long long work = (long long)tg.count * splits;
  if (work > INT_MAX) return cudaErrorInvalidValue;
  int blocks = persistent_blocks(kern, THREADS, smem, (int)work);
  if (blocks == 0) return cudaErrorInvalidValue;
  blocks = blocks < splits ? splits : blocks - blocks % splits;
  kern<<<blocks, THREADS, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(y), Nb, H, W, Ci, Co, splits);
  return cudaGetLastError();
}

template <int MODE>
int launch(const CUtensorMap& map, const void* w, const void* bias,
           const void* res, void* y, int Nb, int H, int W, int Ci, int Co,
           int n, int splits, cudaStream_t s) {
  switch (n) {
    case 112:
      return launch_n<MODE, 112>(map, w, bias, res, y, Nb, H, W, Ci, Co,
                                 splits, s);
    case 96:
      return launch_n<MODE, 96>(map, w, bias, res, y, Nb, H, W, Ci, Co,
                                splits, s);
    case 80:
      return launch_n<MODE, 80>(map, w, bias, res, y, Nb, H, W, Ci, Co,
                                splits, s);
    case 64:
      return launch_n<MODE, 64>(map, w, bias, res, y, Nb, H, W, Ci, Co,
                                splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// K11.  x: bf16 (Nb, H, W, Ci), 16-byte aligned; w: bf16 (splits, Ci /
// 16, 9, 2, n, 8), the B operand of each (split, chunk) contiguous
// (ops/resblock.kernel_weights), 16-byte aligned; bias: bf16 (Co,); res:
// bf16 (Nb, H, W, Co) in mode 1 (`second`), ignored in mode 0 (`first`);
// y: bf16 (Nb, H, W, Co), 16-byte aligned.  Ci and Co multiples of 16, n
// one of 64, 80, 96, 112 and splits the number of n-wide splits that
// cover Co.
extern "C" int vt_resblock_conv(const void* x, const void* w,
                                const void* bias, const void* res, void* y,
                                int Nb, int H, int W, int Ci, int Co,
                                int mode, int n, int splits, void* stream) {
  if (Nb < 1 || H < 1 || W < 1 || Ci < 16 || Co < 16 || Ci % KC ||
      Co % 16 || splits < 1 || (long long)(splits - 1) * n >= Co ||
      (long long)splits * n < Co || (mode != FIRST && mode != SECOND) ||
      (mode == SECOND && res == nullptr) ||
      (long long)Nb * H * W > INT_MAX ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(res) % 4)
    return cudaErrorInvalidValue;
  const CUtensorMap* map = nullptr;
  const int bad = cached_nhwc_bf16_map(&map, x, Nb, H, W, Ci, 8, HW, HH);
  if (bad != 0) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == FIRST
             ? launch<FIRST>(*map, w, bias, res, y, Nb, H, W, Ci, Co, n,
                             splits, s)
             : launch<SECOND>(*map, w, bias, res, y, Nb, H, W, Ci, Co, n,
                              splits, s);
}

// K3 dncnn_head_fused and the probe K8 dncnn_head_slabzero in bf16: SNet
// (DnCNN) + sigma epilogue + RNet's head conv as a chain of launches, one
// per level, with each 64-channel level map in device memory between them:
//
//   dncnn_head_conv1   3->64 + bias + lrelu     (snet_conv1's body)
//   L x dncnn_head_mid 64->64 + bias + lrelu    (wgmma, this file)
//   dncnn_head_last    64->co + bias, the sigma epilogue and RNet's head
//                      conv on [x | sqrt(sigma)] (snet_last's body, sigma +
//                      head mode)
//
// Every launch is a kernel of this file, named dncnn_head_*: conv1 and the
// last level run the device bodies of snet_levels.cuh, which
// snet_levels.cu's snet_conv1 and snet_last kernels run for K2 (both
// dtypes) and for K3 and K8 in fp32, under entry points of their own.
//
// Replaces: virnet_tpu/ops/pallas_conv.py:dncnn_head_fused (:1289) in its
// three modes: 'halo' (_dncnn_head_kernel :925, pallas_call :1512) and
// 'carry' (_dncnn_head_kernel_carry :1055, pallas_call :1459), which on
// the card are one function; and 'slabzero' (_dncnn_head_kernel_slabzero
// :1183, pallas_call :1412), the probe K8: the same chain on a view of the
// input cut into slabs of r rows (N * H / r images of r rows), the level
// maps and the mid kernel seeing slab edges as image edges, conv1 and the
// last level given XS = H / r reading x one row up with zeros in row -1 of
// every input image.  Slab t then reads image rows [t*r - 1, t*r + r - 1)
// and writes rows [t*r, t*r + r): the JAX probe's output, wrong near slab
// edges and shifted down one row on purpose.
//
// Function: conv1 3->64 + LeakyReLU, L mids 64->64 + LeakyReLU, conv_last
// 64->co, zero 'same' padding at every level with exact image borders, f32
// sums and one rounding to bf16 per conv; logits rounded to bf16, sigma =
// exp(clip(logits, lmin, lmax)) and sqrt(sigma) in f32, sigma emitted in
// bf16, sqrt(sigma) rounded to bf16 and zero outside the image; head =
// conv(x, wh[:, :, :3]) + conv(sqrt(sigma), wh[:, :, 3:]) + bh (the
// concatenation never exists).  Any N, H, W >= 1, any L >= 1, co in 1..3,
// CF a multiple of 16 up to 256.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): 2 * 9 * (3 *
// 64 + L * 64 * 64 + 64 * co + (3 + co) * CF) operations a pixel, 460
// kFLOP at the real preset (L = 6, co = 3, CF = 96), against ~200 B of
// input and output: compute bound, 5.67 ms for a 4032 x 3024 photo and
// 0.49 ms at 32 x 256^2 (syn, L = 3).  The chain moves each level map
// through device memory once each way (256 B a pixel a level), which a
// fused kernel would not; a mid level alone is 73.7 kFLOP against 256 B a
// pixel, 288 FLOP a byte, at the card's ridge (295): 0.91 ms of
// operations and 0.93 ms of bytes at 12.19 MP.
//
// Why level by level, and not the fused halo design this file held
// before.  A fused SNet computes each tile's levels in block-private
// buffers and recomputes a margin of up to L + 2 pixels at every level: at
// 24 x 24 tiles and L = 6 the first mid level computes 38 x 38 pixels for
// 24 x 24 outputs, 1.4-2.5x a level and 1.9x over the six.  Its two level
// buffers grow to ~410 KB a block, ~54 MB over 132 persistent blocks, more
// than the 50 MB L2 (296 KB and 39 MB at L = 3), so the deeper preset also
// spills: both presets ran at 12.5-13% of the bound.  A level map between
// launches costs one write and one read of 128 B a pixel, ~0.93 ms a
// level at 12 MP, less than the recompute, and frees each level to take
// the layout and the instructions its shape wants: the mids run on wgmma
// with the whole weight set resident, which the fused kernel's mma.sync
// mids, sharing shared memory with four other stages, could not.
//
// The mid kernel (dncnn_head_mid_kernel): an implicit GEMM with the roles
// of K11 (resblock_conv.cu) swapped, M = the 64 output channels, N = 256
// pixels, K = 16 input channels x 9 taps a step:
//  - a persistent grid of one block of two warpgroups per SM walks output
//    tiles of 32 rows x 16 columns; warpgroup g takes columns 8g .. 8g + 7
//    of all 32 rows, N = 256 (an N of 256 reads 51 operations per
//    shared-memory byte, against K11's m64n96 at 38);
//  - a step is one (tile, chunk of 16 input channels): its halo (34 x 18
//    pixels, zeros outside the tensor: the 'same' padding) arrives as two
//    tensor copies of 8 channels, each pixel a 16-byte row (the layout
//    wgmma reads without swizzle), onto the stage's mbarrier, in a ring of
//    4 stages, 3 steps ahead across tiles; B of tap (dy, dx) is the halo
//    at that offset, 32 core matrices a halo row apart;
//  - the level's 9 x 64 x 64 weights (73.7 KB) stay resident: each block
//    lays them out once as the A operands ([tap][chunk][half][co][8 ci],
//    K-major), transposing 8 x 8 blocks in registers as it reads the HWIO
//    weights, while the first halos arrive;
//  - each warpgroup issues a step's 9 m64n256k16 asynchronously and keeps
//    them in flight while the block prepares the next step;
//  - the epilogue adds the bias and takes LeakyReLU in f32, rounds once,
//    transposes to pixel-major rows through stmatrix.trans into shared
//    memory (rows of 144 bytes: conflict-free), and stores each pixel's
//    128 bytes as 16-byte writes.
#include <limits.h>

#include "hopper.cuh"
#include "snet_levels.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- conv1 and the last level: snet_levels.cuh's bodies ------------------

__global__ void __launch_bounds__(THREADS, 2)
dncnn_head_conv1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const bf16* __restrict__ b, bf16* __restrict__ y,
                        TileGrid tg, int xs, float slope) {
  conv1_body<bf16>(x, w, b, y, tg, xs, slope);
}

template <int CO>
__global__ void __launch_bounds__(THREADS, 2)
dncnn_head_last_kernel(LastArgs a, TileGrid tg) {
  last_body<bf16, CO, true>(a, tg);
}

// ---- the mid levels: 64->64 + bias + lrelu on wgmma ----------------------

constexpr int MTH = 32, MTW = 16;   // output tile; warpgroup g: columns 8g..
constexpr int MHH = MTH + 2, MHW = MTW + 2, MHPX = MHH * MHW;   // its halo
constexpr int KC = 16;              // input channels a step: one k16
constexpr int CHUNKS = NF / KC;
constexpr int STAGES = 4;
// one 8-channel half of a staged halo: MHPX rows of 16 bytes, padded to
// the 128 bytes a tensor copy's destination is aligned to
constexpr int HALF = (MHPX * 16 + 127) / 128 * 128;
constexpr int STAGE = 2 * HALF;
constexpr int HALO_TX = 2 * MHPX * 16;   // bytes the two tensor copies bring
// the A operand of one (tap, chunk): 2 halves x 64 rows of 16 bytes
constexpr int A_BYTES = 2 * NF * 16;
constexpr int OROW = odd_units(NF * 2) * 16;   // a staged output pixel
constexpr int WG_PX = MTH * 8;                 // a warpgroup's pixels: N
constexpr size_t W_AT = (size_t)STAGES * STAGE;
constexpr size_t OUT_AT = W_AT + (size_t)9 * CHUNKS * A_BYTES;
constexpr size_t BARS_AT = OUT_AT + (size_t)2 * WG_PX * OROW;
constexpr size_t MID_SMEM = BARS_AT + STAGES * sizeof(uint64_t);
static_assert(MID_SMEM <= 232448, "one block's shared memory on an H100");

// D (64 x 256 f32, in registers) = A (64 x 16 bf16) * B (16 x 256 bf16)
// [+ D], A and B K-major in shared memory without swizzle; warp w of the
// warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4) of each n8
// block j at d[4j .. 4j + 3]: {(g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j +
// 2t), (g + 8, 8j + 2t + 1)} with t = lane % 4.
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// four 8x8 b16 matrices from the mma fragment layout, each stored
// transposed: lane l gives the address of row l % 8 of matrix l / 8, which
// receives column l % 8 of the fragment's matrix
__device__ __forceinline__ void stsm_x4_t(void* p, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(smem_addr(p)),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// the level's HWIO weights (3, 3, 64, 64) into shared memory as the A
// operands: element (tap, ci, co) at byte ((tap * CHUNKS + ci / 16) * 2 +
// ci / 8 % 2) * 1024 + co * 16 + ci % 8 * 2.  A thread reads an 8 x 8
// block (8 input rows of 8 output channels, 16 bytes each) and writes it
// transposed, 8 channels of an output row as one 16-byte store.
__device__ __forceinline__ void fill_a(unsigned char* sa,
                                       const bf16* __restrict__ w) {
  for (int u = threadIdx.x; u < 9 * 8 * 8; u += THREADS) {
    const int tap = u >> 6, cg = (u >> 3) & 7, og = u & 7;
    uint32_t v[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          w + ((size_t)(tap * NF + cg * 8 + r) * NF + og * 8)));
      v[r][0] = q.x;
      v[r][1] = q.y;
      v[r][2] = q.z;
      v[r][3] = q.w;
    }
    unsigned char* dst = sa + (size_t)(tap * 8 + cg) * 1024 + og * 8 * 16;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned sel = j & 1 ? 0x7632u : 0x5410u;
      uint4 o;
      o.x = __byte_perm(v[0][j >> 1], v[1][j >> 1], sel);
      o.y = __byte_perm(v[2][j >> 1], v[3][j >> 1], sel);
      o.z = __byte_perm(v[4][j >> 1], v[5][j >> 1], sel);
      o.w = __byte_perm(v[6][j >> 1], v[7][j >> 1], sel);
      *reinterpret_cast<uint4*>(dst + j * 16) = o;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
dncnn_head_mid_kernel(const __grid_constant__ CUtensorMap xmap,
                      const bf16* __restrict__ w,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      int Nb, int H, int W, float slope) {
  extern __shared__ __align__(128) unsigned char mid_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(mid_smem + BARS_AT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2;
  const TileGrid tg(Nb, H, W, MTH, MTW);
  const int items = blockIdx.x < tg.count
                        ? (tg.count - 1 - blockIdx.x) / gridDim.x + 1
                        : 0;
  const int steps = items * CHUNKS;   // (tile, chunk) pairs of the block
  if (steps == 0) return;

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers are initialized

  // step st's halo into stage st % STAGES (thread 0)
  auto issue = [&](int st) {
    const int k = st % STAGES, c = st % CHUNKS;
    int n, y0, x0;
    tg.at(blockIdx.x + st / CHUNKS * gridDim.x, n, y0, x0);
    unsigned char* s = mid_smem + (size_t)k * STAGE;
    mbar_expect(bars + k, HALO_TX);
    tma_box(s, &xmap, c * KC, x0 - 1, y0 - 1, n, bars + k);
    tma_box(s + HALF, &xmap, c * KC + 8, x0 - 1, y0 - 1, n, bars + k);
  };
  if (threadIdx.x == 0)
    for (int st = 0; st < STAGES - 1 && st < steps; ++st) issue(st);
  fill_a(mid_smem + W_AT, w);
  // this thread's output channels, 16 wq + g and + 8
  const float b_lo = __bfloat162float(bias[16 * wq + g]);
  const float b_hi = __bfloat162float(bias[16 * wq + g + 8]);
  fence_async_smem();   // the A operands, written by threads, seen by wgmma
  __syncthreads();

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  unsigned char* ow = mid_smem + OUT_AT + (size_t)wg * WG_PX * OROW;

  for (int s = 0; s < steps; ++s) {
    const int c = s % CHUNKS;
    unsigned char* st = mid_smem + (size_t)(s % STAGES) * STAGE;
    mbar_wait(bars + s % STAGES, (s / STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t da =
          mat_desc(mid_smem + W_AT + (size_t)(tap * CHUNKS + c) * A_BYTES,
                   NF * 16, 128);
      const uint64_t db =
          mat_desc(st + (dy * MHW + 8 * wg + dx) * 16, HALF, MHW * 16);
      wgmma_m64n256(acc, da, db, c > 0 || tap > 0);
    }
    wgmma_commit();
    // step s - 1's products are done in both warpgroups: its stage, the
    // one step s + STAGES - 1 takes, is free
    wgmma_wait<1>();
    __syncthreads();
    if (threadIdx.x == 0 && s + STAGES - 1 < steps) issue(s + STAGES - 1);
    if (c == CHUNKS - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 128; ++i) pin(acc[i]);
      // epilogue: bias and LeakyReLU in f32, one rounding; tile rows 2j2
      // and 2j2 + 1 of this warp's 16 channels as four 8 x 8 matrices
      // stored transposed, pixel-major, into the warpgroup's rows
      const int mi = lane >> 3;   // the matrix this lane addresses
      unsigned char* sp = ow + ((mi >> 1) * 8 + (lane & 7)) * OROW +
                          (16 * wq + (mi & 1) * 8) * 2;
#pragma unroll
      for (int j2 = 0; j2 < MTH / 2; ++j2) {
        uint32_t r[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* d = acc + 4 * (2 * j2 + h);
          r[2 * h] = pack_bf16(lrelu(d[0] + b_lo, slope),
                               lrelu(d[1] + b_lo, slope));
          r[2 * h + 1] = pack_bf16(lrelu(d[2] + b_hi, slope),
                                   lrelu(d[3] + b_hi, slope));
        }
        stsm_x4_t(sp + j2 * 16 * OROW, r);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      // staged pixel p: tile row p / 8, column 8 wg + p % 8; 8 lanes a
      // pixel's 128 bytes
      int n, y0, x0;
      tg.at(blockIdx.x + s / CHUNKS * gridDim.x, n, y0, x0);
      const int t = threadIdx.x & 127;
#pragma unroll 4
      for (int k = 0; k < WG_PX * 8 / 128; ++k) {
        const int i = k * 128 + t, p = i >> 3, u = i & 7;
        const int oy = y0 + (p >> 3), ox = x0 + 8 * wg + (p & 7);
        if (oy < H && ox < W)
          *reinterpret_cast<uint4*>(
              y + ((size_t)(n * H + oy) * W + ox) * NF + u * 8) =
              *reinterpret_cast<const uint4*>(ow + p * OROW + u * 16);
      }
      // the staging rows are written again only after the next step's
      // __syncthreads
    }
  }
  // the last step's products were waited for in its epilogue; said again
  // here, so that ptxas need not add a wait of its own on the way out
  wgmma_wait<0>();
}

template <int CO>
int last(const LastArgs& a, cudaStream_t stream) {
  return launch_last(dncnn_head_last_kernel<CO>, last_smem<CO, true>(a.CF),
                     a, stream);
}

}  // namespace

// conv1: x (N,H,W,3), w HWIO (3,3,3,64), b (64) -> y (N,H,W,64) =
// lrelu(conv(x, w) + b), all bf16; y 16-byte aligned.  With xs > 0 (K8: N
// slabs, xs of them per input image) x is read one row up.
extern "C" int vt_dncnn_head_conv1(const void* x, const void* w,
                                   const void* b, void* y, int N, int H,
                                   int W, int xs, float slope, void* stream) {
  if (N < 1 || H < 1 || W < 1 || xs < 0 || (xs > 0 && N % xs != 0))
    return cudaErrorInvalidValue;
  return launch_conv1<bf16>(dncnn_head_conv1_kernel, x, w, b, y, N, H, W, xs,
                            slope, static_cast<cudaStream_t>(stream));
}

// one mid level: x (N,H,W,64), w HWIO (3,3,64,64), b (64) -> y (N,H,W,64)
// = lrelu(conv(x, w) + b), all bf16; x, w and y 16-byte aligned, y not x.
extern "C" int vt_dncnn_head_mid(const void* x, const void* w, const void* b,
                                 void* y, int N, int H, int W, float slope,
                                 void* stream) {
  if (N < 1 || H < 1 || W < 1 || (long long)N * H * W > INT_MAX ||
      x == y || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  const CUtensorMap* map = nullptr;
  const int bad = cached_nhwc_bf16_map(&map, x, N, H, W, NF, 8, MHW, MHH);
  if (bad != 0) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      dncnn_head_mid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MID_SMEM);
  if (err != cudaSuccess) return err;
  const TileGrid tg(N, H, W, MTH, MTW);
  const int blocks =
      persistent_blocks(dncnn_head_mid_kernel, THREADS, MID_SMEM, tg.count);
  if (blocks <= 0) return error_or(cudaErrorInvalidConfiguration);
  dncnn_head_mid_kernel<<<blocks, THREADS, MID_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      *map, static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), N, H, W, slope);
  return cudaGetLastError();
}

// the last level: lev (N,H,W,64); wl HWIO (3,3,64,CO), bl (CO); x
// (N,H,W,3), wh HWIO (3,3,3+CO,CF), bh (CF) -> head (N,H,W,CF), sigma
// (N,H,W,CO).  All bf16; lev and head 16-byte aligned.  With xs > 0 (K8)
// x is read one row up, as in vt_dncnn_head_conv1.
extern "C" int vt_dncnn_head_last(const void* lev, const void* x,
                                  const void* wl, const void* bl,
                                  const void* wh, const void* bh, void* head,
                                  void* sigma, int N, int H, int W, int CO,
                                  int CF, int xs, float lmin, float lmax,
                                  void* stream) {
  if (last_args_bad(N, H, W, CO, CF, 1, xs)) return cudaErrorInvalidValue;
  const LastArgs a{lev, x, wl, bl, wh, bh, head, sigma,
                   N, H, W, CF, xs, lmin, lmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (CO) {
    case 1: return last<1>(a, s);
    case 2: return last<2>(a, s);
    case 3: return last<3>(a, s);
  }
  return cudaErrorInvalidValue;
}

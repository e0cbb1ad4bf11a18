// K9 conv_w8a8 and K10 absmax_nhwc: the int8 (W8A8) convolution of the
// int8 serving mode, with the activation quantize inside the kernels.
//
// K10 absmax_nhwc: the per-channel max |x| over (N, H, W) of an NHWC
// float or bf16 tensor, as float (C,), in one read of x.  A max is exact
// and does not depend on order, so any grid gives x.abs().amax((0, 1, 2))
// bit for bit (a NaN anywhere in a channel gives NaN, as amax does).
//
// K9 conv_w8a8: the 'same' convolution of bf16 NHWC activations x by int8
// weights, each activation quantized in the kernel with its channel's
// scale sx[c]: q = clamp(rint(x / sx[c]), -127, 127), rint(x / sx[c]) that
// of the IEEE quotient, half to even, as torch.round; int32 sums on the s8
// tensor cores, dequantized in the epilogue: y[o] = round_T((float(acc[o])
// * sw[o]) + bias[o]), each of the multiply and the add rounded on its own
// (no FMA contraction), as the JAX package takes them, then one rounding to
// the output dtype T.  The same bits as ops/qconv.quantize_symmetric
// followed by conv_s8_plain.  Kernel sizes 3x3 and 1x1, zero padding k / 2.
//
// Replaces: no Pallas kernel.  virnet_tpu/ops/qconv.py:conv_w8a8 (:44)
// leaves its quantize and its int8 product to XLA (lax.conv_general_
// dilated with preferred_element_type=int32); the port's int8 serving mode
// exists to use the card's integer tensor cores, so the product and the
// activation quantize around it are written by hand.  The fold of the
// scales into the weights and the weights' quantize (a small tensor per
// conv) stay PyTorch (ops/qconv.py).
//
// Bound on an H100 SXM (1,979 TOPS dense int8, 3.35 TB/s): K10 reads x
// once (bytes).  K9 does 2 k^2 Ci Co operations per output pixel against
// Ci input values read (bf16: 2 Ci bytes) and Co written (bf16: 2 Co).  At
// RNet's 96-wide 3x3 on 32x256^2 that is 348 GOP, 0.176 ms of operations,
// against 403 MB in and 403 MB out, 0.240 ms of bytes: bound by bytes; at
// 192 and 288 channels by operations.
//
// Design of K9 (wgmma s8, one warpgroup-pair block per SM):
//  - a persistent grid of at most one block per SM; the output channels
//    split into `splits` blocks of N (32-96, a width wgmma takes), the last
//    of them 32 wide where 32 are left (224 = 3 x 64 + 32: no padded
//    n-tiles at RNet's widths), chosen on the host for the least work with
//    padding and halo counted; a block
//    keeps its split's int8 weights for all Ci resident in shared memory
//    for its whole life (9 x N x Ci bytes, 83 KB at 96 x 96), loaded once,
//    and walks the pixel tiles of its split;
//  - a tile is 32 rows x 8 pixels; each of the two warpgroups takes 16 rows
//    as two M = 64 blocks of 8 rows x 8 pixels, so that a tap's 64 rows of
//    A are 8 core matrices (a tile row each) at one stride of the halo
//    tile and wgmma reads A and B straight from shared memory (K-major,
//    no swizzle: 16-byte rows, the two 16-byte halves of a 32-channel
//    chunk at a fixed distance);
//  - a step is one (tile, chunk of 32 input channels): the bf16 halo of the
//    chunk arrives by one tensor copy (TMA, zeros outside the tensor: the
//    'same' padding and the channels past Ci) two steps ahead, across
//    tiles too, onto an mbarrier; each warpgroup issues the chunk's 9 x 2
//    wgmma asynchronously and keeps them in flight while the block
//    quantizes the next chunk's halo into the other int8 stage (one IEEE
//    quotient only where a multiply by the reciprocal could round
//    otherwise); a tile's last step waits for its products before the
//    epilogue;
//  - the epilogue stages each warp's 16 pixels x N outputs in shared memory
//    and stores them as 16-byte writes, a pixel's N channels contiguous.
// What sets the pace: the quantize, some eight ALU instructions a value on
// 8 warps, takes longer than the products it hides behind, and the splits
// of Co > 96 each quantize the tile's halo again.
#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "tile_async.cuh"

namespace {

constexpr int THREADS = 256;     // two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int TH = 32, TW = 8;   // output tile; warpgroup g takes 16 rows
constexpr int KC = 32;           // input channels per chunk: one k32 step
constexpr size_t SMEM_MAX = 232448;   // what a block may have on an H100
constexpr int WIDTHS[] = {96, 80, 64, 48, 32};   // the N a block may take

template <int KS> struct Halo {
  static constexpr int HH = TH + KS - 1, HW = TW + KS - 1, HPX = HH * HW;
};

// bytes of one staged output row (N values of T), an odd number of 16-byte
// units so that the eight pixels of a store fall on eight bank groups
template <typename T>
__host__ __device__ constexpr int orow_bytes(int n) {
  return odd_units(n * (int)sizeof(T)) * 16;
}

// byte offsets of the shared-memory regions of a block
struct Smem {
  size_t r, q, o, s, b, total;   // weights at 0
};

template <int KS, typename Tout>
__host__ __device__ Smem smem_layout(int n, int cip) {
  constexpr int HPX = Halo<KS>::HPX;
  Smem m;
  m.r = (size_t)KS * KS * n * cip;                   // resident weights
  m.q = m.r + 2 * (size_t)HPX * KC * 2;              // bf16 halo, 2 stages
  m.o = m.q + 2 * (size_t)HPX * KC;                  // int8 halo, 2 stages
  m.s = m.o + (size_t)WARPS * 16 * orow_bytes<Tout>(n);   // outputs
  m.b = m.s + 2 * (size_t)cip * sizeof(float);       // sx and 1 / sx
  m.total = m.b + 2 * sizeof(uint64_t);              // the stages' barriers
  return m;
}

// D (64 x N s32, in registers) = A (64 x 32 s8) * B (32 x N s8) [+ D], A
// and B K-major in shared memory; warp w of the warpgroup holds rows 16w +
// g and 16w + g + 8 (g = lane / 4) of each n8 block j at d[4j .. 4j + 3]:
// {(g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1)}
// with t = lane % 4.
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<48> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<80> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39}, "
        "%40, %41, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<96> {
  static __device__ __forceinline__ void mma(int* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

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
// the box (32 channels, HW, HH, 1) at (c, x, y, n) of NHWC x by the
// tensor copy engine, zeros outside the tensor
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

// eight consecutive floats from shared memory
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  load4(p, v);
  load4(p + 4, v + 4);
}

// Stage the bf16 halo tile of input channels [32c, 32c + 32) of the tile
// at (n, y0, x0) into `dst` (HPX rows of 32 values) by plain loads, zeros
// past the image and past Ci: the path of the widths whose rows are no
// 16-byte multiple (a tensor copy takes the others)
template <int KS>
__device__ __forceinline__ void load_halo(__nv_bfloat16* dst,
                                          const __nv_bfloat16* x, int n,
                                          int y0, int x0, int c, int H,
                                          int W, int Ci) {
  using G = Halo<KS>;
  constexpr int P = KS / 2;
  for (int i = threadIdx.x; i < G::HPX * KC; i += THREADS) {
    const int p = i / KC, ch = c * KC + i % KC;
    const int gy = y0 - P + p / G::HW, gx = x0 - P + p % G::HW;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Ci;
    dst[i] = in ? x[((size_t)(n * H + gy) * W + gx) * Ci + ch]
                : __float2bfloat16(0.f);
  }
}

// four int8 values, the low bytes of q[0..3], in one word
__device__ __forceinline__ uint32_t pack4(const int q[4]) {
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                     __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// Quantize halo pixel p of the staged chunk `raw` into the int8 tile `q`:
// its eight channels 8g ... 8g + 7, stored at half g / 2 of the pixel's
// 16-byte rows ([half][pixel][16 bytes], the layout wgmma reads).  `r`
// holds 1 / sx of those channels (IEEE), `sc` sx.
//
// Each value is q = clamp(rint(v / s), -127, 127), with v / s the IEEE
// quotient and rint half to even.  y = v * (1 / s), both rounded, is
// within 2^-16 of the exact quotient wherever |y| < 128 (two roundings of
// relative 2^-24), and the IEEE quotient within 2^-18 of it, so rint(y) is
// rint(v / s) unless y lies within 2^-15 of a half-integer, and needs no
// clamp where |y| < 127.25.  rint(y) is taken as (y + 1.5 * 2^23) - 1.5 *
// 2^23 (half to even in the add), whose low byte is q's.  Where one of the
// eight values misses either bound (about one in 8000 near a
// half-integer; NaN, infinity), all eight take the quotient itself.
__device__ __forceinline__ void quantize_px(unsigned char* q,
                                            const __nv_bfloat16* raw,
                                            const float r[8],
                                            const float* sc, int p, int g,
                                            int hpx) {
  constexpr float MAGIC = 12582912.f;   // 1.5 * 2^23
  const uint4 u = *reinterpret_cast<const uint4*>(raw + p * KC + g * 8);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float v[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {   // bf16 -> f32 is a shift
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
  int qi[8];
  bool exact = true;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float y = __fmul_rn(v[e], r[e]);
    const float t = __fadd_rn(y, MAGIC);
    exact &= fabsf(__fsub_rn(__fsub_rn(t, MAGIC), y)) < 0.5f - 0x1p-14f &&
             fabsf(y) < 127.25f;
    qi[e] = __float_as_int(t);   // q in the low byte
  }
  if (!exact) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qi[e] = (int)fminf(fmaxf(rintf(__fdiv_rn(v[e], sc[e])), -127.f),
                         127.f);
  }
  uint2 packed;
  packed.x = pack4(qi);
  packed.y = pack4(qi + 4);
  *reinterpret_cast<uint2*>(q + ((g >> 1) * hpx + p) * 16 + (g & 1) * 8) =
      packed;
}

// Quantize the staged halo of chunk c: thread t takes the eight channels
// 8 (t % 4) ... of pixels t / 4, t / 4 + 64, ...
template <int HPX>
__device__ __forceinline__ void quantize_halo(unsigned char* q,
                                              const __nv_bfloat16* raw,
                                              const float* scales,
                                              const float* recips, int c) {
  const int g = threadIdx.x & 3;
  float r[8];
  load8(recips + c * KC + g * 8, r);
  const float* sc = scales + c * KC + g * 8;
#pragma unroll 2
  for (int p = threadIdx.x >> 2; p < HPX; p += THREADS / 4)
    quantize_px(q, raw, r, sc, p, g, HPX);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One block's walk over the pixel tiles of its split: output channels co0
// ... co0 + N - 1 (those past Co computed as zeros), in the shared-memory
// layout L, which a wider split's blocks may share.
template <int KS, int N, typename Tout>
__device__ __forceinline__ void conv_q8_block(
    const CUtensorMap& xmap, const __nv_bfloat16* __restrict__ x,
    const float* __restrict__ sx, const int8_t* __restrict__ w,
    const float* __restrict__ sw, const float* __restrict__ bias,
    Tout* __restrict__ y, int Nb, int H, int W, int Ci, int Co, int splits,
    int tma, int vec_out, const Smem& L, int co0) {
  using G = Halo<KS>;
  using bf = __nv_bfloat16;
  constexpr int KK = KS * KS;
  constexpr int P = KS / 2;
  constexpr int NR = N / 2;           // accumulators a thread, per M block
  constexpr int STAGE_BYTES = G::HPX * KC * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int cip = (Ci + KC - 1) / KC * KC, chunks = cip / KC;
  unsigned char* ws = smem;
  bf* raw = reinterpret_cast<bf*>(smem + L.r);
  unsigned char* qt = smem + L.q;
  float* scales = reinterpret_cast<float*>(smem + L.s);
  float* recips = scales + cip;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.b);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wq = warp & 3;   // warpgroup, warp in it
  const int g = lane >> 2, t4 = lane & 3;
  const int first = blockIdx.x / splits, stride = gridDim.x / splits;
  const TileGrid tg(Nb, H, W, TH, TW);
  const int items = first < tg.count ? (tg.count - 1 - first) / stride + 1
                                     : 0;
  const int steps = items * chunks;   // (tile, chunk) pairs of the block
  if (steps == 0) return;

  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < cip; c += THREADS) {
    const float v = c < Ci ? sx[c] : 1.f;
    scales[c] = v;
    recips[c] = __frcp_rn(v);
  }
  // this split's weights for good: per (chunk, tap), the two 16-byte
  // halves of the 32 channels, each N rows of 16 bytes; rows past Co read
  // as zeros
  const int rows = chunks * KK * N;
  for (int i = threadIdx.x; i < rows * 2; i += THREADS) {
    const int r = i >> 1, u = i & 1;
    const int ct = r / N, ol = r % N, o = co0 + ol;
    const bool in = o < Co;
    const int8_t* src = in ? w + ((size_t)ct * Co + o) * KC + u * 16 : w;
    cp_async16(ws + ((size_t)ct * 2 + u) * N * 16 + ol * 16, src,
               in ? 16 : 0);
  }
  cp_async_commit();
  __syncthreads();   // the barriers are initialized
  // step st's bf16 halo into stage st % 2: one tensor copy (zeros past
  // the image and past Ci), else plain loads
  auto stage = [&](int st) {
    int n, y0, x0;
    tg.at(first + st / chunks * stride, n, y0, x0);
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_expect(bars + (st & 1), STAGE_BYTES);
        tma_box(raw + (st & 1) * G::HPX * KC, &xmap, st % chunks * KC,
                x0 - P, y0 - P, n, bars + (st & 1));
      }
    } else {
      load_halo<KS>(raw + (st & 1) * G::HPX * KC, x, n, y0, x0,
                    st % chunks, H, W, Ci);
    }
  };
  // step st's halo is in its stage (the plain loads: after a barrier)
  auto landed = [&](int st) {
    if (tma) mbar_wait(bars + (st & 1), (st >> 1) & 1);
  };
  stage(0);
  if (steps > 1) stage(1);
  cp_async_wait<0>();
  __syncthreads();   // the weights (and plain-loaded halo) have landed
  landed(0);
  quantize_halo<G::HPX>(qt, raw, scales, recips, 0);
  fence_async_smem();

  int acc[2][NR];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NR; ++i) acc[m][i] = 0;

  for (int s = 0; s < steps; ++s) {
    const int c = s % chunks;
    // step s's int8 tile is whole and seen by the async proxy, and every
    // thread is done with the halo stage that step s + 2 refills
    __syncthreads();
    if (s + 2 < steps) stage(s + 2);

    const unsigned char* qs = qt + (s & 1) * G::HPX * KC;
    const unsigned char* wc = ws + (size_t)c * KK * N * KC;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < KK; ++tap) {
      const int dy = tap / KS, dx = tap % KS;
      const uint64_t db = mat_desc(wc + tap * N * KC, N * 16, 128);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // M block m: tile rows 16 wg + 8 m ... + 7, one core matrix each
        const int p0 = (16 * wg + 8 * m + dy) * G::HW + dx;
        const uint64_t da = mat_desc(qs + p0 * 16, G::HPX * 16, G::HW * 16);
        Wgmma<N>::mma(acc[m], da, db, c > 0 || tap > 0);
      }
    }
    wgmma_commit();
    // step s - 1's products are done in both warpgroups: its int8 stage,
    // the one step s + 1 takes, is free
    wgmma_wait<1>();
    __syncthreads();
    // the next step's quantize while step s's products run
    if (s + 1 < steps) {
      landed(s + 1);
      quantize_halo<G::HPX>(qt + ((s + 1) & 1) * G::HPX * KC,
                            raw + ((s + 1) & 1) * G::HPX * KC, scales,
                            recips, (s + 1) % chunks);
      fence_async_smem();
    }
    if (c == chunks - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < NR; ++i) pin(acc[m][i]);
      // epilogue: dequantize into this warp's staging rows (16 pixels: 2
      // tile rows x 8), then 16-byte stores of each pixel's N channels
      int n, y0, x0;
      tg.at(first + s / chunks * stride, n, y0, x0);
      const int orow = orow_bytes<Tout>(N);
      unsigned char* ow = smem + L.o + (size_t)warp * 16 * orow;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int ol = j * 8 + 2 * t4, o = co0 + ol;
          const float s0 = o < Co ? sw[o] : 0.f;
          const float s1 = o + 1 < Co ? sw[o + 1] : 0.f;
          const float b0 = bias && o < Co ? bias[o] : 0.f;
          const float b1 = bias && o + 1 < Co ? bias[o + 1] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = __fmul_rn(__int2float_rn(acc[m][4 * j + 2 * h]), s0);
            float v1 =
                __fmul_rn(__int2float_rn(acc[m][4 * j + 2 * h + 1]), s1);
            if (bias) {
              v0 = __fadd_rn(v0, b0);
              v1 = __fadd_rn(v1, b1);
            }
            store_pair(reinterpret_cast<Tout*>(ow + (g + 8 * h) * orow) + ol,
                       v0, v1);
          }
        }
        __syncwarp();
        // staged pixel px: tile row 16 wg + 8 m + 2 wq + px / 8, column
        // px % 8
        const int oy0 = y0 + 16 * wg + 8 * m + 2 * wq;
        if (vec_out) {
          constexpr int VO = 16 / sizeof(Tout);   // values a store
          constexpr int UNITS = N / VO;
          for (int i = lane; i < 16 * UNITS; i += 32) {
            const int px = i / UNITS, u = i % UNITS;
            const int oy = oy0 + px / 8, ox = x0 + px % 8;
            if (oy < H && ox < W && co0 + u * VO < Co)
              *reinterpret_cast<uint4*>(
                  y + ((size_t)(n * H + oy) * W + ox) * Co + co0 + u * VO) =
                  *reinterpret_cast<const uint4*>(ow + px * orow + u * 16);
          }
        } else {
          for (int i = lane; i < 16 * N; i += 32) {
            const int px = i / N, ol = i % N;
            const int oy = oy0 + px / 8, ox = x0 + px % 8;
            if (oy < H && ox < W && co0 + ol < Co)
              y[((size_t)(n * H + oy) * W + ox) * Co + co0 + ol] =
                  reinterpret_cast<const Tout*>(ow + px * orow)[ol];
          }
        }
        __syncwarp();   // the staging rows are free again
      }
    }
  }
}

// Split s of `splits` takes output channels sN ... sN + N - 1, the last
// split NT of them (N, or 32 where that is what is left of Co), all in
// the layout of N.
template <int KS, int N, int NT, typename Tout>
__global__ void __launch_bounds__(THREADS, 1)
conv_q8_kernel(const __grid_constant__ CUtensorMap xmap,
               const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ sx, const int8_t* __restrict__ w,
               const float* __restrict__ sw, const float* __restrict__ bias,
               Tout* __restrict__ y, int Nb, int H, int W, int Ci, int Co,
               int splits, int tma, int vec_out) {
  const Smem L = smem_layout<KS, Tout>(N, (Ci + KC - 1) / KC * KC);
  const int split = blockIdx.x % splits;
  if constexpr (NT != N) {
    if (split == splits - 1) {
      conv_q8_block<KS, NT, Tout>(xmap, x, sx, w, sw, bias, y, Nb, H, W, Ci,
                                  Co, splits, tma, vec_out, L, split * N);
      return;
    }
  }
  conv_q8_block<KS, N, Tout>(xmap, x, sx, w, sw, bias, y, Nb, H, W, Ci, Co,
                             splits, tma, vec_out, L, split * N);
}

// The split of Co: blocks of N from WIDTHS, splits = ceil(Co / N), the
// last one `tail` wide (32 where no more than 32 channels are left for
// it, else N), the block inside shared memory.  Least channels computed
// plus 32 a split (the products with their padding, and a halo load and
// quantize a split), then least padding, then splits of one width.  Up
// to 96 channels that is one block of the least N that holds them; at
// RNet's wider convs, splits with no padded n-tiles.  Returns 0 when
// none fits.
template <int KS, typename Tout>
int plan(int Ci, int Co, int& width, int& tail, int& splits, size_t& smem) {
  const int cip = (Ci + KC - 1) / KC * KC;
  long best = -1, best_pad = 0;
  for (int n : WIDTHS) {
    const int s = (Co + n - 1) / n;
    const size_t bytes = smem_layout<KS, Tout>(n, cip).total;
    if (bytes > SMEM_MAX) continue;
    const int t = s > 1 && Co - (s - 1) * n <= 32 ? 32 : n;
    const long done = (long)(s - 1) * n + t;
    const long cost = done + 32L * s, pad = done - Co;
    if (best < 0 || cost < best ||
        (cost == best &&
         (pad < best_pad || (pad == best_pad && t == n && tail != width)))) {
      best = cost;
      best_pad = pad;
      width = n;
      tail = t;
      splits = s;
      smem = bytes;
    }
  }
  return best >= 0;
}

// cuTensorMapEncodeTiled, looked up at run time (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

template <int KS, int N, int NT, typename Tout>
int launch_n(const void* x, const void* sx, const void* w, const void* sw,
             const void* bias, void* y, int Nb, int H, int W, int Ci, int Co,
             int splits, size_t smem, cudaStream_t stream) {
  using G = Halo<KS>;
  auto kern = conv_q8_kernel<KS, N, NT, Tout>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TileGrid tg(Nb, H, W, TH, TW);
  const long long work = (long long)tg.count * splits;
  if ((long long)Nb * H * W > INT_MAX || work > INT_MAX)
    return cudaErrorInvalidValue;
  int blocks = persistent_blocks(kern, THREADS, smem, (int)work);
  if (blocks == 0) return cudaErrorInvalidValue;
  blocks = blocks < splits ? splits : blocks - blocks % splits;
  // the halo by tensor copies where the rows are 16-byte multiples
  CUtensorMap map{};
  int tma = 0;
  if (Ci % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)Ci, (cuuint64_t)W,
                                (cuuint64_t)H, (cuuint64_t)Nb};
    const cuuint64_t strides[3] = {(cuuint64_t)Ci * 2,
                                   (cuuint64_t)W * Ci * 2,
                                   (cuuint64_t)H * W * Ci * 2};
    const cuuint32_t box[4] = {KC, G::HW, G::HH, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    tma = 1;
  }
  const bool vec_out = (Co * sizeof(Tout)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  kern<<<blocks, THREADS, smem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(sx), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<Tout*>(y), Nb, H, W, Ci, Co, splits, tma, vec_out);
  return cudaGetLastError();
}

template <int KS, typename Tout>
int launch(const void* x, const void* sx, const void* w, const void* sw,
           const void* bias, void* y, int Nb, int H, int W, int Ci, int Co,
           cudaStream_t s) {
  int n = 0, tail = 0, splits = 0;
  size_t smem = 0;
  if (!plan<KS, Tout>(Ci, Co, n, tail, splits, smem))
    return cudaErrorInvalidValue;
#define VT_Q8_LAUNCH(N, NT)                                                 \
  launch_n<KS, N, NT, Tout>(x, sx, w, sw, bias, y, Nb, H, W, Ci, Co, splits, \
                            smem, s)
  switch (n) {
    case 96:
      return tail == 32 ? VT_Q8_LAUNCH(96, 32) : VT_Q8_LAUNCH(96, 96);
    case 80:
      return tail == 32 ? VT_Q8_LAUNCH(80, 32) : VT_Q8_LAUNCH(80, 80);
    case 64:
      return tail == 32 ? VT_Q8_LAUNCH(64, 32) : VT_Q8_LAUNCH(64, 64);
    case 48:
      return tail == 32 ? VT_Q8_LAUNCH(48, 32) : VT_Q8_LAUNCH(48, 48);
    default:
      return VT_Q8_LAUNCH(32, 32);
  }
#undef VT_Q8_LAUNCH
}

// ---------------------------------------------------------------------------
// K10
// ---------------------------------------------------------------------------

constexpr int AM_THREADS = 256;
constexpr int AM_UNROLL = 4;

// the larger of m and |v|, NaN sticky (amax propagates NaN)
__device__ __forceinline__ float absmax_step(float m, float v) {
  const float a = fabsf(v);
  return (a > m || a != a) ? a : m;
}

// Thread t of a block takes 16-byte unit t % V of the rows t / V,
// t / V + rows_per_pass, ... of the block's share, where V = C / VEC
// units make a row; the block's maxima meet in shared memory and leave by
// one atomicMax a channel on the float's bits (all >= +0, so the bits
// order as the values; a NaN from fabsf is positive and above them).
template <typename T>
__global__ void __launch_bounds__(AM_THREADS)
absmax_vec_kernel(const T* __restrict__ x, float* __restrict__ out,
                  long long M, int C) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[AM_THREADS * VEC];
  const int V = C / VEC, rpp = AM_THREADS / V;
  const int col = threadIdx.x % V, sub = threadIdx.x / V;
  float m[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) m[e] = 0.f;
  if (sub < rpp) {
    const long long step = (long long)gridDim.x * rpp;
    long long r = (long long)blockIdx.x * rpp + sub;
    for (; r + (AM_UNROLL - 1) * step < M; r += AM_UNROLL * step) {
      uint4 u[AM_UNROLL];
#pragma unroll
      for (int k = 0; k < AM_UNROLL; ++k)
        u[k] = *reinterpret_cast<const uint4*>(x + (r + k * step) * C +
                                               col * VEC);
#pragma unroll
      for (int k = 0; k < AM_UNROLL; ++k) {
        const T* v = reinterpret_cast<const T*>(&u[k]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) m[e] = absmax_step(m[e], tof(v[e]));
      }
    }
    for (; r < M; r += step) {
      const uint4 u = *reinterpret_cast<const uint4*>(x + r * C + col * VEC);
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m[e] = absmax_step(m[e], tof(v[e]));
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[sub * C + col * VEC + e] = m[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += AM_THREADS) {
    float v = 0.f;
    for (int s = 0; s < rpp; ++s) v = absmax_step(v, red[s * C + c]);
    atomicMax(reinterpret_cast<int*>(out) + c, __float_as_int(v));
  }
}

// any C, any alignment: thread t takes channels t, t + 256, ... of the
// block's rows
template <typename T>
__global__ void __launch_bounds__(AM_THREADS)
absmax_any_kernel(const T* __restrict__ x, float* __restrict__ out,
                  long long M, int C) {
  for (int c = threadIdx.x; c < C; c += AM_THREADS) {
    float m = 0.f;
    for (long long r = blockIdx.x; r < M; r += gridDim.x)
      m = absmax_step(m, tof(x[r * C + c]));
    atomicMax(reinterpret_cast<int*>(out) + c, __float_as_int(m));
  }
}

template <typename T>
int absmax_launch(const void* x, void* out, long long M, int C,
                  cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)C * sizeof(float),
                                    stream);
  if (err != cudaSuccess) return err;
  constexpr int VEC = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  if (C % VEC == 0 && C / VEC <= AM_THREADS &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const long long rpp = AM_THREADS / (C / VEC);
    const long long want = (M + rpp * AM_UNROLL - 1) / (rpp * AM_UNROLL);
    const int blocks = (int)(want < 4LL * sms ? (want > 0 ? want : 1)
                                              : 4LL * sms);
    absmax_vec_kernel<T><<<blocks, AM_THREADS, 0, stream>>>(xt, o, M, C);
  } else {
    const int blocks = (int)(M < 4LL * sms ? (M > 0 ? M : 1) : 4LL * sms);
    absmax_any_kernel<T><<<blocks, AM_THREADS, 0, stream>>>(xt, o, M, C);
  }
  return cudaGetLastError();
}

}  // namespace

// K10: out (C,) float = max over the M rows of |x| for x (M, C) of
// dtype (VT_F32 or VT_BF16), row-major; out is written whole.
extern "C" int vt_absmax_nhwc(const void* x, void* out, long long M, int C,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || C < 1) return cudaErrorInvalidValue;
  if (dtype == VT_F32) return absmax_launch<float>(x, out, M, C, s);
  if (dtype == VT_BF16)
    return absmax_launch<__nv_bfloat16>(x, out, M, C, s);
  return cudaErrorInvalidValue;
}

// The split K9 takes for (ks, Ci, Co, output dtype): out[0] = the output
// channels a block, out[1] = splits, out[2] = the last split's channels,
// out[3] = shared-memory bytes a block.  Returns 0, or an error when no
// split fits.
extern "C" int vt_conv_w8a8_plan(int ks, int Ci, int Co, int out_dtype,
                                 int* out) {
  int n = 0, tail = 0, sp = 0, ok = 0;
  size_t smem = 0;
  if (Ci < 1 || Co < 1 || (ks != 1 && ks != 3) ||
      (out_dtype != VT_F32 && out_dtype != VT_BF16))
    return cudaErrorInvalidValue;
  const bool f32 = out_dtype == VT_F32;
  if (ks == 3)
    ok = f32 ? plan<3, float>(Ci, Co, n, tail, sp, smem)
             : plan<3, __nv_bfloat16>(Ci, Co, n, tail, sp, smem);
  else
    ok = f32 ? plan<1, float>(Ci, Co, n, tail, sp, smem)
             : plan<1, __nv_bfloat16>(Ci, Co, n, tail, sp, smem);
  out[0] = n;
  out[1] = sp;
  out[2] = tail;
  out[3] = (int)smem;
  return ok ? 0 : cudaErrorInvalidValue;
}

// K9.  x: bf16 (N, H, W, Ci); sx: float (Ci,); w: int8 (Cip / 32, ks * ks,
// Co, 32) with Cip = Ci rounded up to 32 (zeros past Ci), each output
// channel's 32 input channels of a chunk contiguous; sw, bias: float
// (Co,), bias may be null; y: (N, H, W, Co) of out_dtype.  w 16-byte
// aligned.
extern "C" int vt_conv_w8a8(const void* x, const void* sx, const void* w,
                            const void* sw, const void* bias, void* y, int N,
                            int H, int W, int Ci, int Co, int ks,
                            int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1)
    return cudaErrorInvalidValue;
  const bool f32 = out_dtype == VT_F32;
  if (!f32 && out_dtype != VT_BF16) return cudaErrorInvalidValue;
  if (ks == 3)
    return f32 ? launch<3, float>(x, sx, w, sw, bias, y, N, H, W, Ci, Co, s)
               : launch<3, __nv_bfloat16>(x, sx, w, sw, bias, y, N, H, W, Ci,
                                          Co, s);
  if (ks == 1)
    return f32 ? launch<1, float>(x, sx, w, sw, bias, y, N, H, W, Ci, Co, s)
               : launch<1, __nv_bfloat16>(x, sx, w, sw, bias, y, N, H, W, Ci,
                                          Co, s);
  return cudaErrorInvalidValue;
}

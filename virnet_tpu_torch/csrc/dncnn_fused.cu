// K2 dncnn_fused, K3 dncnn_head_fused and K8 dncnn_head_slabzero: the whole
// SNet (DnCNN) in one launch, and for K3 and K8 also the sigma epilogue and
// RNet's head conv.
//
// Replaces:
//   K2 -> virnet_tpu/ops/pallas_conv.py:dncnn_pair_fused (:474; Pallas
//         body _dncnn_kernel :369);
//   K3 -> virnet_tpu/ops/pallas_conv.py:dncnn_head_fused modes 'halo'
//         (_dncnn_head_kernel :925) and 'carry' (_dncnn_head_kernel_carry
//         :1055).  The carry mode sweeps row tiles in order and carries a
//         boundary row per level from one grid step to the next; Hopper
//         blocks run in no order, so both modes become this one halo
//         kernel;
//   K8 -> virnet_tpu/ops/pallas_conv.py:dncnn_head_fused mode 'slabzero'
//         (_dncnn_head_kernel_slabzero :1183, pallas_call :1412), a speed
//         probe: K3's arithmetic with every r-row slab of the image an
//         image of its own, so that nothing is recomputed.  Slab t reads
//         image rows [t*r - 1, t*r + r - 1) (row -1 is zeros, as the Pallas
//         caller's padded view has it) and writes output rows [t*r,
//         t*r + r): wrong within L+2 rows of every slab edge and shifted
//         down one row against the true prologue, on purpose.
//
// Function (K2): conv1 3->64 + lrelu, L mids 64->64 + lrelu, conv_last
// 64->co, zero 'same' padding at every level, f32 accumulation and one
// rounding to the activation dtype per conv.  Any H and W, odd included:
// no pixel pairs, so nothing to pad and re-mask.
// K3 adds: logits rounded to the activation dtype, sigma =
// exp(clip(logits, lmin, lmax)) and sqrt(sigma) in f32, sigma emitted in
// the activation dtype, sqrt(sigma) rounded and ZERO outside the image,
// then head = conv(x, wh[:, :, :3]) + conv(sqrt(sigma), wh[:, :, 3:]) + bh
// (the concat never exists).
//
// Bound on an H100: ~233 kFLOP per pixel (denoising-syn, bf16) against
// ~200 B per pixel of input and output, far above the ridge: compute
// bound.  Design: a block owns a 32x32 output tile and recomputes its
// halo (L+1 rows for K2, L+2 for K3, one more for the head's logits), so
// no full-size 64-channel map ever reaches device memory.  The working
// set, two (32+2*halo)^2 x 64 buffers (903 KB in f32 at L=3), does not
// fit in 227 KB of shared memory at a useful tile, so the two buffers
// are a block-private scratch in device memory, still in one launch;
// shared memory holds one level's weights (147 KB for 64x64 in f32).
// The grid is persistent (as many blocks as fit on
// the SMs, each walking tiles), which bounds the scratch.  In bf16 the
// 64->64 mids, ~95% of the operations, run on the tensor cores
// (mma.sync m16n8k16, f32 accumulation; mid_level_mma); everything else,
// and everything in f32 (which must stay exact f32, no TF32), runs one
// thread per pixel with all output sums in registers on the f32 CUDA
// cores, weight reads being warp-wide broadcasts.  wgmma/TMA,
// shared-memory level buffers and a smaller halo are later work.
//
// K8 runs the same device code on another rectangle (struct Region): a
// block owns one whole slab, r rows x W columns, at every level, with no
// margin, so no pixel of any level is computed twice in either direction.
// Its two level buffers are (r+2) x (W+2) x 64 with a ring of zeros that
// the block writes once and no level touches; sqrt(sigma), which K3 keeps
// in shared memory, is a third (r+2) x (W+2) x co plane of that scratch
// (already rounded to T, so nothing is lost).  K3 time - K8 time at r = 32
// is what K3's recomputed halo costs on this card.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NF = 64;     // DnCNN filters
constexpr int CI = 3;      // image channels
constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int HC = 16;     // head output channels per register block
constexpr int MAX_BIAS = 256;
// bf16 mids run on the tensor cores with the weights transposed to
// [co][tap*64 + ci]; the row stride is padded by 8 so that the eight
// output channels a warp reads at once fall in different banks
constexpr int WT_STRIDE = 9 * NF + 8;
constexpr int SW_ELEMS = NF * WT_STRIDE;  // >= 9*NF*NF, the f32 layout

// which of the three kernels an instantiation is
constexpr int K2_SNET = 0, K3_HEAD = 1, K8_SLAB = 2;

struct Args {
  const void *x, *w1, *b1, *wm, *bm, *wl, *bl, *wh, *bh;
  void *out0, *out1, *scratch;
  int N, H, W, L, CO, CF, rows;  // rows: K8's slab height
  float slope, lmin, lmax;
};

// The rectangle one block works on, and where its levels lie in the two
// scratch buffers.  K2/K3: a TILE x TILE tile of the image whose levels
// shrink from margin halo(L) to 0.  K8: one slab, margin 0 at every level.
struct Region {
  int th, tw;    // the output rectangle: rows, columns
  int org;       // buffer coordinates of its pixel (0, 0)
  int S;         // buffer row stride in pixels
  int H, W;      // bounds of the zero padding: the image, or K8's slab
  int ty0, tx0;  // origin of the rectangle inside those bounds
  int xrow0;     // image row that row 0 of the bounds reads (K8: t*r - 1)
  int orow0;     // output row that row 0 of the bounds writes (K8: t*r)
};

template <typename T, int MODE>
size_t smem_bytes() {
  return sizeof(T) * SW_ELEMS + sizeof(float) * MAX_BIAS +
         (MODE == K3_HEAD ? sizeof(float) * (TILE + 2) * (TILE + 2) * 3 : 0);
}

__host__ __device__ inline int halo(int L, bool head) {
  return head ? L + 2 : L + 1;
}

// K8's scratch per block: two (rows+2) x (W+2) x 64 level buffers and the
// sqrt(sigma) plane, rounded up to 8 elements so that every block's
// buffers stay 16-byte aligned
__host__ __device__ inline long long slab_scratch_elems(int rows, int W,
                                                        int CO) {
  const long long px = (long long)(rows + 2) * (W + 2);
  return (px * (2 * NF + CO) + 7) / 8 * 8;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16 bf16, row) * B(16x8 bf16, col) + D, f32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One bf16 mid level (3x3 64->64 + bias + lrelu) on the tensor cores as an
// implicit GEMM: M = the pixels of the level's margin-m region, 16 per
// warp step; N = 64 output channels (8 mma tiles of 8); K = 9 taps x 64
// input channels.  A fragments are read straight from the block's
// scratch buffer (two bf16 channels per 32-bit load), B from the
// transposed weights in shared memory.  Out-of-bounds pixels store zeros.
__device__ void mid_level_mma(const __nv_bfloat16* src, __nv_bfloat16* dst,
                              const __nv_bfloat16* swt, const float* sb,
                              int m, const Region& rg, float slope) {
  const int S = rg.S, RW = rg.tw + 2 * m, npix = (rg.th + 2 * m) * RW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  for (int mt = warp; mt * 16 < npix; mt += THREADS / 32) {
    size_t base[2];
    bool valid[2], in[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = mt * 16 + g + 8 * r;
      valid[r] = p < npix;
      const int pp = valid[r] ? p : 0;
      const int ly = pp / RW - m, lx = pp % RW - m;
      const int gy = rg.ty0 + ly, gx = rg.tx0 + lx;
      in[r] = gy >= 0 && gy < rg.H && gx >= 0 && gx < rg.W;
      base[r] = ((size_t)(ly + rg.org) * S + lx + rg.org) * NF;
    }
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const long off = ((long)(tap / 3 - 1) * S + (tap % 3 - 1)) * NF;
      const __nv_bfloat16* s0 = src + base[0] + off + tig * 2;
      const __nv_bfloat16* s1 = src + base[1] + off + tig * 2;
      const __nv_bfloat16* wb = swt + g * WT_STRIDE + tap * NF + tig * 2;
#pragma unroll
      for (int c0 = 0; c0 < NF; c0 += 16) {
        const uint32_t af[4] = {ld32(s0 + c0), ld32(s1 + c0),
                                ld32(s0 + c0 + 8), ld32(s1 + c0 + 8)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const __nv_bfloat16* w = wb + nt * 8 * WT_STRIDE + c0;
          const uint32_t bf[2] = {ld32(w), ld32(w + 8)};
          mma_bf16(acc[nt], af, bf);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!valid[r]) continue;
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + base[r]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = nt * 8 + tig * 2;
        float v0 = 0.f, v1 = 0.f;
        if (in[r]) {
          v0 = lrelu(acc[nt][2 * r] + sb[co], slope);
          v1 = lrelu(acc[nt][2 * r + 1] + sb[co + 1], slope);
        }
        d[co / 2] = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) dncnn_kernel(Args a) {
  constexpr bool HEAD = MODE != K2_SNET, SLAB = MODE == K8_SLAB;
  // sqrt(sigma) for the head conv: f32 in shared memory (K3), or T in the
  // block's scratch (K8; the values are rounded to T either way)
  using E = std::conditional_t<SLAB, T, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  float* sb = reinterpret_cast<float*>(smem_raw + sizeof(T) * SW_ELEMS);
  float* sext = sb + MAX_BIAS;  // [(TILE+2)^2][CO], K3 only

  const T* x = static_cast<const T*>(a.x);
  const int H = a.H, W = a.W, L = a.L, CO = a.CO;
  const int Hh = halo(L, HEAD);
  Region rg;
  rg.th = SLAB ? a.rows : TILE;
  rg.tw = SLAB ? W : TILE;
  rg.org = SLAB ? 1 : Hh;
  rg.S = rg.tw + 2 * rg.org;
  rg.H = SLAB ? a.rows : H;
  rg.W = W;
  rg.ty0 = rg.tx0 = rg.xrow0 = rg.orow0 = 0;
  const int S = rg.S, org = rg.org;
  const int ES = rg.tw + 2;  // row stride of the sqrt(sigma) plane
  const size_t level = (size_t)(rg.th + 2 * org) * S * NF;
  const size_t per_block =
      SLAB ? (size_t)slab_scratch_elems(a.rows, W, CO) : 2 * level;
  T* buf0 = static_cast<T*>(a.scratch) + (size_t)blockIdx.x * per_block;
  T* buf1 = buf0 + level;
  E* ext0 = SLAB ? reinterpret_cast<E*>(buf1 + level)
                 : reinterpret_cast<E*>(sext);
  const int ntx = SLAB ? 1 : (W + TILE - 1) / TILE;
  const int nty = SLAB ? H / a.rows : (H + TILE - 1) / TILE;
  const int ntiles = a.N * nty * ntx;

  if (SLAB) {
    // the ring of zeros around the slab, in both level buffers and in the
    // sqrt(sigma) plane: written once, no level stores outside the slab
    const int PW = rg.tw + 2, PH = rg.th + 2;
    for (int i = threadIdx.x; i < PH * PW; i += THREADS) {
      const int y = i / PW, xx = i % PW;
      if (y != 0 && y != PH - 1 && xx != 0 && xx != PW - 1) continue;
      for (int o = 0; o < NF; ++o) {
        buf0[(size_t)i * NF + o] = fromf<T>(0.f);
        buf1[(size_t)i * NF + o] = fromf<T>(0.f);
      }
      for (int c = 0; c < CO; ++c) ext0[(size_t)i * CO + c] = fromf<E>(0.f);
    }
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile / (nty * ntx), rr = tile % (nty * ntx);
    if (SLAB) {
      rg.xrow0 = rr * a.rows - 1;
      rg.orow0 = rr * a.rows;
    } else {
      rg.ty0 = (rr / ntx) * TILE;
      rg.tx0 = (rr % ntx) * TILE;
    }
    const int ty0 = rg.ty0, tx0 = rg.tx0;
    const T* xn = x + (size_t)n * H * W * CI;
    const size_t orow = (size_t)n * H + rg.orow0;  // output row of bounds row 0

    // ---- conv1 3->64 + lrelu on the first level's region -> buf0
    __syncthreads();
    copy_to_smem(sw, static_cast<const T*>(a.w1), 9 * CI * NF);
    for (int i = threadIdx.x; i < NF; i += THREADS)
      sb[i] = tof(static_cast<const T*>(a.b1)[i]);
    __syncthreads();
    {
      const int m = SLAB ? 0 : Hh;
      const int RW = rg.tw + 2 * m, RH = rg.th + 2 * m;
      for (int p = threadIdx.x; p < RH * RW; p += THREADS) {
        const int ly = p / RW - m, lx = p % RW - m;
        const int gy = ty0 + ly, gx = tx0 + lx;
        T* dst = buf0 + ((size_t)(ly + org) * S + lx + org) * NF;
        if (gy < 0 || gy >= rg.H || gx < 0 || gx >= rg.W) {
          for (int o = 0; o < NF; ++o) dst[o] = fromf<T>(0.f);
          continue;
        }
        float acc[NF];
#pragma unroll
        for (int o = 0; o < NF; ++o) acc[o] = 0.f;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int yy = gy + tap / 3 - 1, xx = gx + tap % 3 - 1;
          if (yy < 0 || yy >= rg.H || xx < 0 || xx >= rg.W) continue;
          if (SLAB && yy + rg.xrow0 < 0) continue;  // the zero row above row 0
          const T* xp = xn + ((size_t)(yy + rg.xrow0) * W + xx) * CI;
#pragma unroll
          for (int ci = 0; ci < CI; ++ci)
            fma_row<NF>(acc, tof(xp[ci]), sw + (tap * CI + ci) * NF);
        }
#pragma unroll
        for (int o = 0; o < NF; ++o)
          dst[o] = fromf<T>(lrelu(acc[o] + sb[o], a.slope));
      }
    }

    // ---- L mids 64->64 + lrelu, ping-pong between buf0 and buf1
    for (int lev = 1; lev <= L; ++lev) {
      const T* wm = static_cast<const T*>(a.wm) + (size_t)(lev - 1) * 9 * NF * NF;
      __syncthreads();
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        for (int i = threadIdx.x; i < 9 * NF * NF; i += THREADS)
          sw[(i % NF) * WT_STRIDE + i / NF] = wm[i];  // HWIO -> [co][k]
      } else {
        copy_to_smem(sw, wm, 9 * NF * NF);
      }
      for (int i = threadIdx.x; i < NF; i += THREADS)
        sb[i] = tof(static_cast<const T*>(a.bm)[(lev - 1) * NF + i]);
      __syncthreads();
      const T* src = (lev - 1) % 2 ? buf1 : buf0;
      T* dstb = lev % 2 ? buf1 : buf0;
      const int m = SLAB ? 0 : Hh - lev;
      const int RW = rg.tw + 2 * m, RH = rg.th + 2 * m;
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        mid_level_mma(src, dstb, sw, sb, m, rg, a.slope);
        continue;
      }
      for (int p = threadIdx.x; p < RH * RW; p += THREADS) {
        const int ly = p / RW - m, lx = p % RW - m;
        const int gy = ty0 + ly, gx = tx0 + lx;
        T* dst = dstb + ((size_t)(ly + org) * S + lx + org) * NF;
        if (gy < 0 || gy >= rg.H || gx < 0 || gx >= rg.W) {
          for (int o = 0; o < NF; ++o) dst[o] = fromf<T>(0.f);
          continue;
        }
        float acc[NF];
#pragma unroll
        for (int o = 0; o < NF; ++o) acc[o] = 0.f;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const T* xp = src + ((size_t)(ly + tap / 3 - 1 + org) * S + lx +
                               tap % 3 - 1 + org) * NF;
          const T* wp = sw + tap * NF * NF;
#pragma unroll 1
          for (int ci = 0; ci < NF; ci += 4) {
            float xv[4];
            load4(xp + ci, xv);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              fma_row<NF>(acc, xv[k], wp + (ci + k) * NF);
          }
        }
#pragma unroll
        for (int o = 0; o < NF; ++o)
          dst[o] = fromf<T>(lrelu(acc[o] + sb[o], a.slope));
      }
    }

    // ---- conv_last 64->co (K2: the tile; K3: the tile and a 1-pixel
    //      ring, which the head conv reads; K8: the slab, whose ring is
    //      zeros already)
    __syncthreads();
    copy_to_smem(sw, static_cast<const T*>(a.wl), 9 * NF * CO);
    for (int i = threadIdx.x; i < CO; i += THREADS)
      sb[i] = tof(static_cast<const T*>(a.bl)[i]);
    __syncthreads();
    {
      const T* src = L % 2 ? buf1 : buf0;
      const int m = MODE == K3_HEAD ? 1 : 0;
      const int RW = rg.tw + 2 * m, RH = rg.th + 2 * m;
      for (int p = threadIdx.x; p < RH * RW; p += THREADS) {
        const int ly = p / RW - m, lx = p % RW - m;
        const int gy = ty0 + ly, gx = tx0 + lx;
        const bool in = gy >= 0 && gy < rg.H && gx >= 0 && gx < rg.W;
        E* ext = ext0 + ((size_t)(ly + 1) * ES + lx + 1) * CO;
        if (!in) {
          if (HEAD)
            for (int c = 0; c < CO; ++c) ext[c] = fromf<E>(0.f);
          continue;
        }
        float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const T* xp = src + ((size_t)(ly + tap / 3 - 1 + org) * S + lx +
                               tap % 3 - 1 + org) * NF;
          const T* wp = sw + tap * NF * CO;
#pragma unroll 1
          for (int ci = 0; ci < NF; ci += 4) {
            float xv[4];
            load4(xp + ci, xv);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              for (int c = 0; c < CO; ++c)
                acc[c] = fmaf(xv[k], tof(wp[(ci + k) * CO + c]), acc[c]);
          }
        }
        const size_t o = ((orow + gy) * W + gx) * CO;
        for (int c = 0; c < CO; ++c) {
          const float logit = acc[c] + sb[c];
          if (!HEAD) {
            static_cast<T*>(a.out0)[o + c] = fromf<T>(logit);
          } else {
            const float lg = round_to<T>(logit);
            const float sig = expf(fminf(fmaxf(lg, a.lmin), a.lmax));
            if (ly >= 0 && ly < rg.th && lx >= 0 && lx < rg.tw)
              static_cast<T*>(a.out1)[o + c] = fromf<T>(sig);
            ext[c] = fromf<E>(round_to<T>(sqrtf(sig)));
          }
        }
      }
    }

    // ---- K3, K8: head conv on [x | sqrt(sigma)] over the tile / slab
    if (HEAD) {
      const int CC = CI + CO, CF = a.CF;
      __syncthreads();
      copy_to_smem(sw, static_cast<const T*>(a.wh), 9 * CC * CF);
      for (int i = threadIdx.x; i < CF; i += THREADS)
        sb[i] = tof(static_cast<const T*>(a.bh)[i]);
      __syncthreads();
      for (int p = threadIdx.x; p < rg.th * rg.tw; p += THREADS) {
        const int ly = p / rg.tw, lx = p % rg.tw;
        const int gy = ty0 + ly, gx = tx0 + lx;
        if (gy >= rg.H || gx >= rg.W) continue;
        T* hp = static_cast<T*>(a.out0) + ((orow + gy) * W + gx) * CF;
#pragma unroll 1
        for (int c0 = 0; c0 < CF; c0 += HC) {
          float acc[HC];
#pragma unroll
          for (int o = 0; o < HC; ++o) acc[o] = 0.f;
#pragma unroll 1
          for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            const int yy = gy + dy - 1, xx = gx + dx - 1;
            const T* wp = sw + tap * CC * CF + c0;
            if (yy >= 0 && yy < rg.H && xx >= 0 && xx < rg.W &&
                !(SLAB && yy + rg.xrow0 < 0)) {
              const T* xp = xn + ((size_t)(yy + rg.xrow0) * W + xx) * CI;
#pragma unroll
              for (int ci = 0; ci < CI; ++ci)
                fma_row<HC>(acc, tof(xp[ci]), wp + ci * CF);
            }
            const E* ep = ext0 + ((size_t)(ly + dy) * ES + lx + dx) * CO;
            for (int c = 0; c < CO; ++c)
              fma_row<HC>(acc, tof(ep[c]), wp + (CI + c) * CF);
          }
#pragma unroll
          for (int o = 0; o < HC; ++o) hp[c0 + o] = fromf<T>(acc[o] + sb[c0 + o]);
        }
      }
    }
  }
}

template <typename T, int MODE>
cudaError_t prepare() {
  return cudaFuncSetAttribute(dncnn_kernel<T, MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T, MODE>());
}

template <typename T, int MODE>
int grid_size(int ntiles, int* grid) {
  cudaError_t err = prepare<T, MODE>();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dncnn_kernel<T, MODE>, THREADS, smem_bytes<T, MODE>());
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int full = sms * per_sm;
  *grid = ntiles < full ? ntiles : full;
  return cudaSuccess;
}

template <typename T, int MODE>
int launch(const Args& a, int grid, cudaStream_t stream) {
  cudaError_t err = prepare<T, MODE>();
  if (err != cudaSuccess) return err;
  dncnn_kernel<T, MODE><<<grid, THREADS, smem_bytes<T, MODE>(), stream>>>(a);
  return cudaGetLastError();
}

int n_tiles(int N, int H, int W) {
  return N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
}

bool widths_ok(int CO, int CF, bool head) {
  return CO >= 1 && CO <= 3 &&
         (!head || (CF % HC == 0 && CF <= MAX_BIAS &&
                    9 * (CI + CO) * CF <= 9 * NF * NF));
}

}  // namespace

// Persistent grid for (dtype, head) at this image size: the wrapper sizes
// the block-private scratch from it, grid * scratch_elems(L, head).  K3 in
// bf16 is dncnn_head.cu's, so (bf16, head) is refused.
extern "C" int vt_dncnn_grid(int dtype, int head, int N, int H, int W,
                             int* grid) {
  const int nt = n_tiles(N, H, W);
  if (dtype == VT_F32)
    return head ? grid_size<float, K3_HEAD>(nt, grid)
                : grid_size<float, K2_SNET>(nt, grid);
  if (dtype == VT_BF16 && !head)
    return grid_size<__nv_bfloat16, K2_SNET>(nt, grid);
  return cudaErrorInvalidValue;
}

// Scratch elements one block needs: two (TILE + 2*halo)^2 x 64 buffers.
extern "C" long long vt_dncnn_scratch_elems(int L, int head) {
  const long long s = TILE + 2 * halo(L, head != 0);
  return 2 * s * s * NF;
}

// x (N,H,W,3); w1 HWIO (3,3,3,64), b1 (64); wm (L,3,3,64,64), bm (L,64);
// wl (3,3,64,CO), bl (CO); K3 only: wh (3,3,3+CO,CF), bh (CF).
// K2 (head=0): out0 = logits (N,H,W,CO).  K3 (head=1): out0 = head
// (N,H,W,CF), out1 = sigma (N,H,W,CO).  All tensors of dtype.
extern "C" int vt_dncnn_fused(const void* x, const void* w1, const void* b1,
                              const void* wm, const void* bm, const void* wl,
                              const void* bl, const void* wh, const void* bh,
                              void* out0, void* out1, void* scratch,
                              int grid, int N, int H, int W, int L, int CO,
                              int CF, int dtype, int head, float slope,
                              float lmin, float lmax, void* stream) {
  if (!widths_ok(CO, CF, head != 0)) return cudaErrorInvalidValue;
  Args a{x, w1, b1, wm, bm, wl, bl, wh, bh, out0, out1, scratch,
         N, H, W, L, CO, CF, 0, slope, lmin, lmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32)
    return head ? launch<float, K3_HEAD>(a, grid, s)
                : launch<float, K2_SNET>(a, grid, s);
  if (dtype == VT_BF16 && !head)  // K3 bf16: dncnn_head.cu
    return launch<__nv_bfloat16, K2_SNET>(a, grid, s);
  return cudaErrorInvalidValue;
}

// K8's persistent grid: one block per slab up to what the SMs hold.
extern "C" int vt_dncnn_slab_grid(int dtype, int N, int H, int rows,
                                  int* grid) {
  if (rows < 1 || H % rows != 0) return cudaErrorInvalidValue;
  const int nt = N * (H / rows);
  if (dtype == VT_F32) return grid_size<float, K8_SLAB>(nt, grid);
  if (dtype == VT_BF16) return grid_size<__nv_bfloat16, K8_SLAB>(nt, grid);
  return cudaErrorInvalidValue;
}

// Scratch elements one K8 block needs (see slab_scratch_elems).
extern "C" long long vt_dncnn_slab_scratch_elems(int rows, int W, int CO) {
  return slab_scratch_elems(rows, W, CO);
}

// K8: the arguments of K3 and the slab height `rows`, which divides H.
// out0 = head (N,H,W,CF), out1 = sigma (N,H,W,CO), each r-row slab computed
// as an image of its own from x rows [t*rows - 1, t*rows + rows - 1).
extern "C" int vt_dncnn_head_slabzero(
    const void* x, const void* w1, const void* b1, const void* wm,
    const void* bm, const void* wl, const void* bl, const void* wh,
    const void* bh, void* out0, void* out1, void* scratch, int grid, int N,
    int H, int W, int L, int CO, int CF, int rows, int dtype, float slope,
    float lmin, float lmax, void* stream) {
  if (!widths_ok(CO, CF, true) || rows < 1 || H % rows != 0)
    return cudaErrorInvalidValue;
  Args a{x, w1, b1, wm, bm, wl, bl, wh, bh, out0, out1, scratch,
         N, H, W, L, CO, CF, rows, slope, lmin, lmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32) return launch<float, K8_SLAB>(a, grid, s);
  if (dtype == VT_BF16) return launch<__nv_bfloat16, K8_SLAB>(a, grid, s);
  return cudaErrorInvalidValue;
}

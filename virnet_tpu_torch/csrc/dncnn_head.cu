// K3 dncnn_head_fused in bf16 and the probe K8 dncnn_head_slabzero in
// bf16: SNet (DnCNN) + sigma epilogue + RNet's head conv in one launch,
// redesigned for Hopper.  (K2 in both dtypes and K3 and K8 in fp32 are the
// level chain of snet_levels.cu with K1 for the mids.)
//
// Replaces: virnet_tpu/ops/pallas_conv.py:dncnn_head_fused (:1289) modes
// 'halo' (_dncnn_head_kernel :925, pallas_call :1512) and 'carry'
// (_dncnn_head_kernel_carry :1055, pallas_call :1459).  Hopper blocks run
// in no order, so both modes become one halo kernel.  Also mode
// 'slabzero' (_dncnn_head_kernel_slabzero :1183, pallas_call :1412): the
// same kernel on a view of the input cut into slabs of r rows (N * H / r
// images of r rows), x read one row up, row -1 of each input image zero
// (XS below).  Slab t then reads image rows [t*r - 1, t*r + r - 1) and
// writes rows [t*r, t*r + r): the JAX probe's output, wrong near slab
// edges and shifted down one row on purpose.
//
// Function: conv1 3->64 + lrelu, L mids 64->64 + lrelu, conv_last 64->co,
// zero 'same' padding at every level with exact image borders, f32
// accumulation and one rounding to bf16 per conv; logits rounded to bf16,
// sigma = exp(clip(logits, lmin, lmax)) and sqrt(sigma) in f32, sigma
// emitted in bf16, sqrt(sigma) rounded to bf16 and ZERO outside the image;
// head = conv(x, wh[:, :, :3]) + conv(sqrt(sigma), wh[:, :, 3:]) + bh (the
// concatenation never exists).  Any N, H, W >= 1, any L >= 1, co in 1..3,
// CF a multiple of 16 up to 256.
//
// Bound on an H100 SXM: ~233 kFLOP per pixel (denoising-syn) against ~200
// B of input and output per pixel: compute bound (0.49 ms at 32x256^2).
//
// What held PR 1's fused kernel back: its mid levels read every A
// fragment by 32-bit loads straight from the block's level buffers in
// device memory, each pixel nine times, from a scratch larger than the
// 50 MB L2; conv1, conv_last and the head ran on the f32 CUDA cores; the
// weights were transposed element by element for every tile and level.
// This design:
//  - a persistent block walks TH x TILE output tiles (TileGrid), TILE = 24
//    columns and TH rows (K3: 24; K8: min(r, 32), so that a tile spans
//    its slab's rows up to r = 32), and recomputes a halo of up to L + 2
//    pixels.  Each level's region is the tile with its margin, clipped to
//    the image (for K8 the slab): nothing outside is computed, and the
//    copies of the next level read zeros there (cp.async zero fill).  So
//    K8 at r <= 32 recomputes only the column halo (1.25x at r = 32, L =
//    3, against K3's 1.57x at 24 x 24).  The two level buffers per block
//    hold (TH + 2(L+2)) x (TILE + 2(L+2)) pixels; the parts touched at 24
//    x 24 (K3) or 32 x 24 clipped to a 32-row slab (K8) are 296 KB at L =
//    3, so 132 blocks keep 39 MB in L2;
//  - every conv is an implicit GEMM on the tensor cores, mma.sync m16n8k16
//    with f32 sums, M = 16 pixels; a warp takes two m-tiles at a time and
//    both share each B fragment;
//  - the mids (K1's pattern, conv3x3_mid.cu; N = 64, K = 9 x 64): a
//    level's output region is cut into rectangles of at most 256 pixels and
//    32 columns; each rectangle's input, (rh+2) x (cw+2) pixels, is staged
//    in shared memory by 16-byte cp.async, double buffered (the next
//    rectangle's copy under this one's math), pixel rows padded to 9
//    16-byte units (odd: ldmatrix conflict-free).  A by ldmatrix from the
//    staged pixels (any 16 pixels of the rectangle: every lane gives its
//    own row address), B by ldmatrix.trans straight from the HWIO weights,
//    which arrive by cp.async once per level and tile.  Bias, lrelu, one
//    rounding, staged per warp and written back as 16-byte stores;
//  - conv1 (N = 64, K = 27 taps x channels padded to 32): A gathered from
//    the x pixels of the whole region, staged once per tile in shared
//    memory 4 channels apart;
//  - conv1 and the mids start their sums at the bias; their epilogue
//    (LeakyReLU, staging, stores) cost about as much as the mids' mma loop
//    until the index math lost its run-time divisions (FastDiv);
//  - conv_last (N = 8 of which co are used, K = 9 x 64): the mids' staging
//    and A; the sigma epilogue in f32 as before; sqrt(sigma) goes to a
//    shared (TH+2) x (TILE+2) plane beside x;
//  - head (N = CF in passes of 64, K = 9 (3 + co) padded to 16s): A
//    gathered from that plane, B by ldmatrix.trans from [k][CF] weights;
//    bias in f32, one rounding, staged and written as 16-byte stores.
#include "common.cuh"
#include "tile_async.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NF = 64;     // DnCNN filters
constexpr int CI = 3;      // image channels
constexpr int TILE = 24;   // tile columns
constexpr int MAX_TH = 32; // tile rows, at most
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int ROW = odd_units(NF * 2) * 8;  // elements per staged pixel: 72
constexpr int RECT_PX = 256;  // output pixels of one rectangle, at most
constexpr int RECT_W = 32;    // and columns
// input pixels of one rectangle, (rh + 2) * (cw + 2): Cut keeps every
// rectangle within it; a full region of TILE + 2 or more columns (cw in
// [17, 32]) reaches it at cw = 32, rh = 8
constexpr int IN_PX = 340;
constexpr int XC = 4;         // channel stride of conv1's staged x pixels
constexpr int EC = 6;         // channel stride of the head's [x | sqrt(sigma)]
constexpr int MAX_CF = 256;
constexpr int ES = TILE + 2;  // row of the head's input plane, in pixels

constexpr size_t W_BYTES = (size_t)9 * NF * ROW * 2;
constexpr size_t IN_BYTES = (size_t)IN_PX * ROW * 2;
constexpr size_t STAGE_BYTES = (size_t)WARPS * 32 * ROW * 2;
constexpr size_t SMEM = W_BYTES + 2 * IN_BYTES + STAGE_BYTES +
                        4 * MAX_CF + (size_t)(MAX_TH + 2) * ES * EC * 2;
static_assert(SMEM <= 232448, "one block's shared memory on an H100");

struct Args {
  const bf16 *x, *w1, *b1, *wm, *bm, *wl, *bl, *wh, *bh;
  bf16 *head, *sigma, *scratch;
  int N, H, W, L, CO, CF;
  int TH;  // tile rows
  int XS;  // 0, or (K8) slabs per input image: x is read one row up
  float slope, lmin, lmax;
};

// the tile a block works on, and its level buffers' geometry: pixel (ly,
// lx) of the tile (ly in [-Hh, TH + Hh), lx in [-Hh, TILE + Hh)) is
// buffer pixel (ly + Hh) * S + lx + Hh.  x of tile row `zr` reads zero
// (K8: row 0 of the first slab of an input image, whose row above is
// outside that image).
struct Tile {
  int n, ty0, tx0, H, W, Hh, S, TH, zr;
  __device__ bool in_image(int ly, int lx) const {
    const int gy = ty0 + ly, gx = tx0 + lx;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
};

// a level's output region, the tile with margin m clipped to the image:
// tile rows [y0, y0 + h) and columns [x0, x0 + w)
struct Region {
  int y0, x0, h, w;
  __device__ Region(const Tile& tl, int m)
      : y0(max(-m, -tl.ty0)), x0(max(-m, -tl.tx0)),
        h(min(tl.TH + m, tl.H - tl.ty0) - max(-m, -tl.ty0)),
        w(min(TILE + m, tl.W - tl.tx0) - max(-m, -tl.tx0)) {}
};

// a region cut into rectangles of at most RECT_PX pixels and RECT_W
// columns, near-equal, each with an input of at most IN_PX pixels
struct Cut {
  int cw, rh, nc, nr;
  __device__ Cut(int rows, int cols) {
    nc = (cols + RECT_W - 1) / RECT_W;
    cw = (cols + nc - 1) / nc;
    const int rmax = min(RECT_PX / cw, IN_PX / (cw + 2) - 2);
    nr = (rows + rmax - 1) / rmax;
    rh = (rows + nr - 1) / nr;
  }
  // tile rows [ry0, ry0 + h) and columns [rx0, rx0 + w) of rectangle r of
  // region rg
  __device__ void at(int r, const Region& rg, int& ry0, int& rx0, int& h,
                     int& w) const {
    const int i = r / nc, j = r - i * nc;
    ry0 = i * rh;
    rx0 = j * cw;
    h = min(rh, rg.h - ry0);
    w = min(cw, rg.w - rx0);
    ry0 += rg.y0;
    rx0 += rg.x0;
  }
};

// what a warp's two m-tiles cover: m-tiles mt0 and mt0 + WARPS of a
// rectangle of npx pixels, cw columns, at tile pixel (ry0, rx0)
struct MTiles {
  int mt0, npx;
  FastDiv cw;
  int ry0, rx0;
  // pixel q (0..31: m-tile q / 16, row q % 16) as an index into the
  // rectangle, npx when past its end
  __device__ int pixel(int q) const {
    const int p = (mt0 + (q >> 4) * WARPS) * 16 + (q & 15);
    return p < npx ? p : npx;
  }
};

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return lo | (uint32_t)hi << 16;
}

__device__ __forceinline__ uint16_t bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}

// channel c of x at tile pixel (ly, lx), zero outside the image; with XS
// (K8) the image is a slab of the input and x is read one row up
__device__ __forceinline__ uint16_t x_at(const Args& a, const Tile& tl,
                                         int ly, int lx, int c) {
  if (!tl.in_image(ly, lx) || ly == tl.zr) return 0;
  const size_t row = (size_t)tl.n * a.H + tl.ty0 + ly - (a.XS > 0);
  return bits(a.x[(row * a.W + tl.tx0 + lx) * CI + c]);
}

// st(i, ld(i)) for i < n over the block, ld(i) the 16 bits of one bf16
// read from device memory.  Each thread issues eight loads before any
// store, so that their latencies overlap: a loop that stores to shared
// memory after each load waits out every load in turn.
template <typename Ld, typename St>
__device__ __forceinline__ void fill(int n, Ld&& ld, St&& st) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * THREADS) {
    uint16_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS;
      v[j] = i < n ? ld(i) : (uint16_t)0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n) st(i, v[j]);
    }
  }
}

// the A fragment rows of a lane: rows g and g + 8 of each m-tile, as
// offsets into staged pixels `stride` elements apart, iw to a row, where
// the rectangle's input pixel (0, 0) is staged pixel (row0, col0) (a row
// past the rectangle reads its pixel 0)
__device__ __forceinline__ void lane_rows(const MTiles& mt, int iw, int row0,
                                          int col0, int stride,
                                          int off[2][2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int p = mt.pixel(mi * 16 + g + 8 * r);
      if (p >= mt.npx) p = 0;
      off[mi][r] =
          ((row0 + mt.cw.div(p)) * iw + col0 + mt.cw.mod(p)) * stride;
    }
}

// zero the sums of a warp's two m-tiles x NT n-tiles
template <int NT>
__device__ __forceinline__ void zero(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nt][i] = 0.f;
}

// issue the copies of one rectangle's input: tile rows [ry0 - 1, ry0 + rh
// + 1) and columns [rx0 - 1, rx0 + cw + 1), which the level before wrote
// where they lie in the image (its region is one pixel wider, clipped to
// the image); pixels outside the image arrive as zeros (zero fill)
__device__ __forceinline__ void load_rect(bf16* dst, const bf16* src,
                                          const Tile& tl, int ry0, int rx0,
                                          int rh, int cw) {
  const int iw = cw + 2, npx = (rh + 2) * iw;
  const FastDiv fiw(iw);
  for (int i = threadIdx.x; i < npx * 8; i += THREADS) {
    const int p = i >> 3, u = i & 7, py = fiw.div(p);
    const int ly = ry0 - 1 + py, lx = rx0 - 1 + p - py * iw;
    const bool in = tl.in_image(ly, lx);
    cp_async16(dst + p * ROW + u * 8,
               in ? src + ((size_t)(ly + tl.Hh) * tl.S + lx + tl.Hh) * NF +
                        u * 8
                  : src,
               in ? 16 : 0);
  }
}

// ldmatrix row addresses of a lane for the A fragments of a warp's two
// m-tiles over a rectangle staged by load_rect: pixel lane % 16 of each
// m-tile (pixel 0 past the rectangle's end), 16-byte unit lane / 16
__device__ __forceinline__ void a_rows(const MTiles& mt, int a[2]) {
  const int lane = threadIdx.x & 31, iw = mt.cw.d + 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    int p = mt.pixel(mi * 16 + (lane & 15));
    if (p >= mt.npx) p = 0;
    a[mi] = (mt.cw.div(p) * iw + mt.cw.mod(p)) * ROW + (lane >> 4) * 8;
  }
}

// start a warp's 64-channel sums (conv1, the mids) at the bias: the lane's
// channels are nt * 8 + 2 tig and that + 1
__device__ __forceinline__ void bias_init(float (&acc)[2][8][4],
                                          const float* sb) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(sb + nt * 8 + 2 * tig);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      acc[mi][nt][0] = acc[mi][nt][2] = b.x;
      acc[mi][nt][1] = acc[mi][nt][3] = b.y;
    }
  }
}

// 64-channel outputs of a warp's two m-tiles (conv1, the mids), their sums
// started at the bias: lrelu in f32, one rounding (regions are clipped to
// the image, so every pixel lies in it); staged, then 16-byte stores into
// the level buffer, a whole pixel per 8 lanes
__device__ void emit64(const float (&acc)[2][8][4], const MTiles& mt,
                       const Tile& tl, float slope, bf16* stage, bf16* dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = mi * 16 + g + 8 * r;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int co = nt * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(stage + q * ROW + co) =
            pack_bf16(lrelu(acc[mi][nt][2 * r], slope),
                      lrelu(acc[mi][nt][2 * r + 1], slope));
      }
    }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = k * 32 + lane, q = i >> 3, u = i & 7, p = mt.pixel(q);
    if (p < mt.npx) {
      const int py = mt.cw.div(p);
      const int by = tl.Hh + mt.ry0 + py;
      const int bx = tl.Hh + mt.rx0 + p - py * mt.cw.d;
      *reinterpret_cast<uint4*>(dst + ((size_t)by * tl.S + bx) * NF +
                                u * 8) =
          *reinterpret_cast<const uint4*>(stage + q * ROW + u * 8);
    }
  }
  __syncwarp();
}

// one rectangle of a mid level: 3x3 64->64 + bias + lrelu, N = 64, K = 9
// taps x 64 channels; A by ldmatrix from the staged rectangle, B by
// ldmatrix.trans from the HWIO weights ([tap * 64 + ci][co], rows of ROW)
__device__ void mid_rect(const bf16* sx, bf16* dst, const bf16* sw,
                         const float* sb, bf16* stage, const Tile& tl,
                         int ry0, int rx0, int rh, int cw, float slope) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npx = rh * cw, nmt = (npx + 15) / 16, iw = cw + 2;
  for (int mt0 = warp; mt0 < nmt; mt0 += 2 * WARPS) {
    const MTiles mt{mt0, npx, FastDiv(cw), ry0, rx0};
    int abase[2];
    a_rows(mt, abase);
    float acc[2][8][4];
    bias_init(acc, sb);
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = ((tap / 3) * iw + tap % 3) * ROW;
      const bf16* a0 = sx + abase[0] + shift;
      const bf16* a1 = sx + abase[1] + shift;
      // B: lane l addresses matrix l / 8 = (k half, n tile of the pair)
      const bf16* b0 = sw + (tap * NF + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                ROW + (lane >> 4) * 8;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        uint32_t af[2][4];
        ldsm_x4(af[0], a0 + kb * 16);
        ldsm_x4(af[1], a1 + kb * 16);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, b0 + kb * 16 * ROW + np * 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_16816(acc[mi][2 * np], af[mi], bfr);
            mma_16816(acc[mi][2 * np + 1], af[mi], bfr + 2);
          }
        }
      }
    }
    emit64(acc, mt, tl, slope, stage, dst);
  }
}

// compute(staged input, ry0, rx0, rh, cw) over the rectangles of the
// margin-m region (tile coordinates), each rectangle's input (from src) in
// flight while the one before is computed; copies the caller issued
// before are waited for with the first rectangle's.  Ends with the block
// in step.
template <typename F>
__device__ void level_rects(const bf16* src, bf16* sx, const Tile& tl, int m,
                            F&& compute) {
  const Region rg(tl, m);
  const Cut cut(rg.h, rg.w);
  const int nrect = cut.nr * cut.nc;
  int ry0, rx0, rh, cw;
  cut.at(0, rg, ry0, rx0, rh, cw);
  load_rect(sx, src, tl, ry0, rx0, rh, cw);
  cp_async_commit();
  for (int r = 0; r < nrect; ++r) {
    if (r + 1 < nrect) {
      cut.at(r + 1, rg, ry0, rx0, rh, cw);
      load_rect(sx + ((r + 1) & 1) * IN_PX * ROW, src, tl, ry0, rx0, rh, cw);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    cut.at(r, rg, ry0, rx0, rh, cw);
    compute(sx + (r & 1) * IN_PX * ROW, ry0, rx0, rh, cw);
    __syncthreads();  // this input buffer is the target of the next copy
  }
}

// one mid level, src (margin m + 1) -> dst (margin m)
__device__ void mid_level(const bf16* src, bf16* dst, const bf16* wm,
                          const bf16* bm, bf16* sw, bf16* sx, float* sb,
                          bf16* stage, const Tile& tl, int m, float slope) {
  __syncthreads();  // sw, sx and sb are free; src is complete
  for (int i = threadIdx.x; i < 9 * NF * 8; i += THREADS)
    cp_async16(sw + (i >> 3) * ROW + (i & 7) * 8, wm + i * 8, 16);
  if (threadIdx.x < NF) sb[threadIdx.x] = tof(bm[threadIdx.x]);
  level_rects(src, sx, tl, m,
              [&](const bf16* sxr, int ry0, int rx0, int rh, int cw) {
                mid_rect(sxr, dst, sw, sb, stage, tl, ry0, rx0, rh, cw,
                         slope);
              });
}

// conv1 3->64 + lrelu over the margin-Hh region -> dst: N = 64, K = 27
// (tap, channel) padded to 32, rectangle by rectangle.  The x pixels the
// rectangles read are staged once, XC channels apart with zeros outside
// the image (the whole region's at any usual depth; in chunks of
// rectangles when it does not fit), and A is gathered from them; B by
// ldmatrix.trans from [k][64] weights whose rows 27..31 are zero.
__device__ void conv1_level(const Args& a, const Tile& tl, bf16* dst,
                            bf16* sw, bf16* sx, float* sb, bf16* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tig = lane & 3;
  __syncthreads();  // sw, sx and sb are free
  fill(
      32 * NF,
      [&](int i) -> uint16_t { return i < 9 * CI * NF ? bits(a.w1[i]) : 0; },
      [&](int i, uint16_t v) {
        sw[(i / NF) * ROW + i % NF] = __ushort_as_bfloat16(v);
      });
  if (threadIdx.x < NF) sb[threadIdx.x] = tof(a.b1[threadIdx.x]);
  uint16_t* xs = reinterpret_cast<uint16_t*>(sx);
  const Region rg(tl, tl.Hh);
  const Cut cut(rg.h, rg.w);
  // a chunk: nb rows of rectangles x gc columns of them
  constexpr int CAP = (int)(2 * IN_BYTES / (XC * 2));  // staged pixels
  int nb = (CAP / (rg.w + 2) - 2) / cut.rh, gc = cut.nc;
  if (nb < 1) {
    nb = 1;
    gc = (CAP / (cut.rh + 2) - 2) / cut.cw;
  }
  for (int bi0 = 0; bi0 < cut.nr; bi0 += nb)
    for (int cj0 = 0; cj0 < cut.nc; cj0 += gc) {
      const int bi1 = min(cut.nr, bi0 + nb), cj1 = min(cut.nc, cj0 + gc);
      // the chunk's first output pixel, in tile coordinates
      const int by0 = rg.y0 + bi0 * cut.rh, bx0 = rg.x0 + cj0 * cut.cw;
      const int ih = min(rg.h, bi1 * cut.rh) - bi0 * cut.rh + 2;
      const int iw = min(rg.w, cj1 * cut.cw) - cj0 * cut.cw + 2;
      __syncthreads();  // the chunk before is done with xs
      const FastDiv fiw(iw);
      fill(
          ih * iw * XC,
          [&](int i) -> uint16_t {
            const int p = i / XC, c = i % XC, py = fiw.div(p);
            return c < CI ? x_at(a, tl, by0 - 1 + py, bx0 - 1 + p - py * iw,
                                 c)
                          : 0;
          },
          [&](int i, uint16_t v) { xs[i] = v; });
      __syncthreads();
      // the lane's k columns: kb * 16 + 8j + 2 tig + e, as offsets into a
      // staged pixel's neighbourhood (-1: a zero column past K = 27)
      int koff[2][2][2];
#pragma unroll
      for (int kb = 0; kb < 2; ++kb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kb * 16 + 8 * j + 2 * tig + e, tap = k / CI;
            koff[kb][j][e] =
                k < 9 * CI ? ((tap / 3) * iw + tap % 3) * XC + k % CI : -1;
          }
      for (int bi = bi0; bi < bi1; ++bi)
        for (int cj = cj0; cj < cj1; ++cj) {
          int ry0, rx0, rh, cw;
          cut.at(bi * cut.nc + cj, rg, ry0, rx0, rh, cw);
          const int npx = rh * cw, nmt = (npx + 15) / 16;
          for (int mt0 = warp; mt0 < nmt; mt0 += 2 * WARPS) {
            const MTiles mt{mt0, npx, FastDiv(cw), ry0, rx0};
            int off[2][2];
            lane_rows(mt, iw, ry0 - by0, rx0 - bx0, XC, off);
            float acc[2][8][4];
            bias_init(acc, sb);
#pragma unroll
            for (int kb = 0; kb < 2; ++kb) {
              uint32_t af[2][4];
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int i = 0; i < 4; ++i) {  // (row g | g + 8, k | k + 8)
                  const int rr = i & 1, j = i >> 1;
                  const int k0 = koff[kb][j][0], k1 = koff[kb][j][1];
                  af[mi][i] = pack_raw(k0 < 0 ? 0 : xs[off[mi][rr] + k0],
                                       k1 < 0 ? 0 : xs[off[mi][rr] + k1]);
                }
              const bf16* b0 =
                  sw + (kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ROW +
                  (lane >> 4) * 8;
#pragma unroll
              for (int np = 0; np < 4; ++np) {
                uint32_t bfr[4];
                ldsm_x4_t(bfr, b0 + np * 16);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                  mma_16816(acc[mi][2 * np], af[mi], bfr);
                  mma_16816(acc[mi][2 * np + 1], af[mi], bfr + 2);
                }
              }
            }
            emit64(acc, mt, tl, a.slope, stage, dst);
          }
        }
    }
}

// conv_last 64->co over the tile and a 1-pixel ring (the head reads the
// ring): N = 8 of which co are used, K = 9 x 64; the mids' staging and A,
// B by ldmatrix.trans from [tap * 64 + ci][8] weights.  Epilogue in f32:
// logits rounded, sigma = exp(clip) out for the tile's pixels, rounded
// sqrt(sigma) into the head's plane xe (zeroed first: outside the image
// it stays zero).
__device__ void last_level(const Args& a, const Tile& tl, const bf16* src,
                           bf16* sw, bf16* sx, float* sb, uint16_t* xe) {
  const int CO = a.CO;
  __syncthreads();  // sw, sx, sb and xe are free
  fill(
      9 * NF * 8,
      [&](int i) -> uint16_t {
        return (i & 7) < CO ? bits(a.wl[(i >> 3) * CO + (i & 7)]) : 0;
      },
      [&](int i, uint16_t v) { sw[i] = __ushort_as_bfloat16(v); });
  if (threadIdx.x < CO) sb[threadIdx.x] = tof(a.bl[threadIdx.x]);
  // the head's plane, (TH + 2) x ES pixels: x in channels 0..2, zero
  // outside the image, and zeros in the sqrt(sigma) channels
  fill(
      (tl.TH + 2) * ES * EC,
      [&](int i) -> uint16_t {
        const int p = i / EC, c = i - p * EC, py = p / ES;
        return c < CI ? x_at(a, tl, py - 1, p - py * ES - 1, c) : 0;
      },
      [&](int i, uint16_t v) { xe[i] = v; });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  level_rects(src, sx, tl, 1, [&](const bf16* sxr, int ry0, int rx0, int rh,
                                  int cw) {
    const int npx = rh * cw, nmt = (npx + 15) / 16, iw = cw + 2;
    for (int mt0 = warp; mt0 < nmt; mt0 += 2 * WARPS) {
      const MTiles mt{mt0, npx, FastDiv(cw), ry0, rx0};
      int abase[2];
      a_rows(mt, abase);
      float acc[2][1][4];
      zero(acc);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = ((tap / 3) * iw + tap % 3) * ROW;
        // B: lane l addresses k row 8 (l / 8) + l % 8 of a 32-row block
        const bf16* b0 = sw + (tap * NF + lane) * 8;
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, b0 + kp * 32 * 8);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kb = 2 * kp + h;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              uint32_t af[4];
              ldsm_x4(af, sxr + abase[mi] + shift + kb * 16);
              mma_16816(acc[mi][0], af, bfr + 2 * h);
            }
          }
        }
      }
      if (2 * tig < CO) {  // lanes holding outputs 0..co-1
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = mt.pixel(mi * 16 + g + 8 * r);
          if (p >= npx) continue;
          const int ly = ry0 + mt.cw.div(p);
          const int lx = rx0 + mt.cw.mod(p);
          const bool own = ly >= 0 && ly < tl.TH && lx >= 0 && lx < TILE;
          uint16_t* ep = xe + ((ly + 1) * ES + lx + 1) * EC + CI;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * tig + e;
            if (c >= CO) continue;
            const float lg = round_to<bf16>(acc[mi][0][2 * r + e] + sb[c]);
            const float sig = expf(fminf(fmaxf(lg, a.lmin), a.lmax));
            if (own)
              a.sigma[(((size_t)tl.n * a.H + tl.ty0 + ly) * a.W + tl.tx0 +
                       lx) * CO + c] = __float2bfloat16(sig);
            ep[c] = __bfloat16_as_ushort(__float2bfloat16(sqrtf(sig)));
          }
        }
      }
      __syncwarp();  // in step again before the next m-tiles' mma
    }
  });
}

// head conv on [x | sqrt(sigma)] over the tile: N = CF in passes of 64,
// K = 9 (3 + co) (tap, channel) padded to a multiple of 16.  A is gathered
// from the plane xe, B by ldmatrix.trans from [k][CF] weights (rows padded
// to an odd number of 16-byte units, zero past K); bias in f32, one
// rounding, staged, out as 16-byte stores.  One m-tile per warp at a time.
__device__ void head_level(const Args& a, const Tile& tl, bf16* sw,
                           float* sb, const uint16_t* xe, bf16* stage) {
  const int CC = CI + a.CO, K = 9 * CC, nkb = (K + 15) / 16, CF = a.CF;
  const int CFP = odd_units(CF * 2) * 8;
  __syncthreads();  // xe is complete; sw and sb are free
  const FastDiv fcf(CF);
  fill(
      nkb * 16 * CF,
      [&](int i) -> uint16_t { return i < K * CF ? bits(a.wh[i]) : 0; },
      [&](int i, uint16_t v) {
        const int k = fcf.div(i);
        sw[k * CFP + i - k * CF] = __ushort_as_bfloat16(v);
      });
  for (int i = threadIdx.x; i < CF; i += THREADS) sb[i] = tof(a.bh[i]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  int koff[4][2][2];  // as in conv1_level, into xe
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = kb * 16 + 8 * j + 2 * tig + e, tap = k / CC;
        koff[kb][j][e] =
            k < K ? ((tap / 3) * ES + tap % 3) * EC + k % CC : -1;
      }
  const int tpx = tl.TH * TILE;  // the tile's pixels
  for (int mt = warp; mt < (tpx + 15) / 16; mt += WARPS) {
    int off[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int p = mt * 16 + g + 8 * r;
      if (p >= tpx) p = 0;  // past the tile: read pixel 0, store nothing
      off[r] = ((p / TILE) * ES + p % TILE) * EC;
    }
    uint32_t af[4][4];
#pragma unroll
    for (int kb = 0; kb < 4; ++kb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i & 1, j = i >> 1;
        const int k0 = koff[kb][j][0], k1 = koff[kb][j][1];
        af[kb][i] = pack_raw(k0 < 0 ? 0 : xe[off[rr] + k0],
                             k1 < 0 ? 0 : xe[off[rr] + k1]);
      }
#pragma unroll 1
    for (int c0 = 0; c0 < CF; c0 += 64) {
      const int nnt = min(8, (CF - c0) / 8);  // even: CF % 16 == 0
      float acc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb >= nkb) break;
        const bf16* b0 = sw + (kb * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                  CFP + c0 + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (2 * np >= nnt) break;
          uint32_t bfr[4];
          ldsm_x4_t(bfr, b0 + np * 16);
          mma_16816(acc[2 * np], af[kb], bfr);
          mma_16816(acc[2 * np + 1], af[kb], bfr + 2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= nnt) break;
        const int co = nt * 8 + 2 * tig;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(stage + (g + 8 * r) * ROW + co) =
              pack_bf16(acc[nt][2 * r] + sb[c0 + co],
                        acc[nt][2 * r + 1] + sb[c0 + co + 1]);
      }
      __syncwarp();
      for (int i = lane; i < 16 * nnt; i += 32) {
        const int q = i / nnt, u = i % nnt, p = mt * 16 + q;
        const int gy = tl.ty0 + p / TILE, gx = tl.tx0 + p % TILE;
        if (p < tpx && gy < a.H && gx < a.W)
          *reinterpret_cast<uint4*>(
              a.head + (((size_t)tl.n * a.H + gy) * a.W + gx) * CF + c0 +
              u * 8) = *reinterpret_cast<const uint4*>(stage + q * ROW +
                                                       u * 8);
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(THREADS) dncnn_head_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sw = reinterpret_cast<bf16*>(smem_raw);
  bf16* sx = reinterpret_cast<bf16*>(smem_raw + W_BYTES);
  bf16* stage = reinterpret_cast<bf16*>(smem_raw + W_BYTES + 2 * IN_BYTES) +
                (threadIdx.x >> 5) * 32 * ROW;
  float* sb = reinterpret_cast<float*>(smem_raw + W_BYTES + 2 * IN_BYTES +
                                       STAGE_BYTES);
  uint16_t* xe = reinterpret_cast<uint16_t*>(sb + MAX_CF);

  Tile tl;
  tl.H = a.H;
  tl.W = a.W;
  tl.TH = a.TH;
  tl.Hh = a.L + 2;
  tl.S = TILE + 2 * tl.Hh;
  const size_t level = (size_t)(a.TH + 2 * tl.Hh) * tl.S * NF;
  bf16* buf0 = a.scratch + (size_t)blockIdx.x * 2 * level;
  bf16* buf1 = buf0 + level;
  const TileGrid tg(a.N, a.H, a.W, a.TH, TILE);

  for (int t = blockIdx.x; t < tg.count; t += gridDim.x) {
    tg.at(t, tl.n, tl.ty0, tl.tx0);
    // K8: row 0 of an input image's first slab reads the zero row above
    tl.zr = a.XS > 0 && tl.n % a.XS == 0 ? -tl.ty0 : -(1 << 30);
    conv1_level(a, tl, buf0, sw, sx, sb, stage);
    for (int lev = 1; lev <= a.L; ++lev)
      mid_level(lev % 2 ? buf0 : buf1, lev % 2 ? buf1 : buf0,
                a.wm + (size_t)(lev - 1) * 9 * NF * NF,
                a.bm + (size_t)(lev - 1) * NF, sw, sx, sb, stage, tl,
                tl.Hh - lev, a.slope);
    last_level(a, tl, a.L % 2 ? buf1 : buf0, sw, sx, sb, xe);
    head_level(a, tl, sw, sb, xe, stage);
  }
}

cudaError_t prepare() {
  return cudaFuncSetAttribute(dncnn_head_bf16_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
}

}  // namespace

// Persistent grid at this image size and tile height TH (bf16 only): the
// wrapper sizes the block-private scratch from it, grid *
// vt_dncnn_head_scratch_elems(L, TH).
extern "C" int vt_dncnn_head_grid(int dtype, int N, int H, int W, int TH,
                                  int* grid) {
  if (dtype != VT_BF16 || N < 1 || H < 1 || W < 1 || TH < 1 || TH > MAX_TH)
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  const TileGrid tg(N, H, W, TH, TILE);
  const int blocks =
      persistent_blocks(dncnn_head_bf16_kernel, THREADS, SMEM, tg.count);
  if (blocks <= 0) {
    err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  *grid = blocks;
  return cudaSuccess;
}

// Scratch elements one block needs: two (TH + 2 (L + 2)) x (TILE + 2 (L +
// 2)) x 64 buffers.
extern "C" long long vt_dncnn_head_scratch_elems(int L, int TH) {
  const long long hh = L + 2;
  return 2 * (TH + 2 * hh) * (TILE + 2 * hh) * NF;
}

// x (N,H,W,3); w1 HWIO (3,3,3,64), b1 (64); wm (L,3,3,64,64), bm (L,64);
// wl (3,3,64,CO), bl (CO); wh (3,3,3+CO,CF), bh (CF).  head = out0
// (N,H,W,CF), sigma = out1 (N,H,W,CO).  All bf16; wm and out0 16-byte
// aligned.  Tiles of TH (1..32) x 24 pixels: K3 takes TH = 24 and XS = 0.
// K8 passes the slab view, N * H / r images of r rows, with TH = min(r,
// 32) and XS = H / r: x is then read one row up, with zeros in row -1 of
// every input image (the first row of every XS-th slab).
extern "C" int vt_dncnn_head(const void* x, const void* w1, const void* b1,
                             const void* wm, const void* bm, const void* wl,
                             const void* bl, const void* wh, const void* bh,
                             void* out0, void* out1, void* scratch, int grid,
                             int N, int H, int W, int L, int CO, int CF,
                             int TH, int XS, int dtype, float slope,
                             float lmin, float lmax, void* stream) {
  if (dtype != VT_BF16 || grid < 1 || N < 1 || H < 1 || W < 1 || L < 1 ||
      CO < 1 || CO > 3 || CF < 0 || CF % 16 != 0 || CF > MAX_CF || TH < 1 ||
      TH > MAX_TH || XS < 0 || (XS > 0 && N % XS != 0))
    return cudaErrorInvalidValue;
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  Args a{static_cast<const bf16*>(x),  static_cast<const bf16*>(w1),
         static_cast<const bf16*>(b1), static_cast<const bf16*>(wm),
         static_cast<const bf16*>(bm), static_cast<const bf16*>(wl),
         static_cast<const bf16*>(bl), static_cast<const bf16*>(wh),
         static_cast<const bf16*>(bh), static_cast<bf16*>(out0),
         static_cast<bf16*>(out1),     static_cast<bf16*>(scratch),
         N, H, W, L, CO, CF, TH, XS, slope, lmin, lmax};
  dncnn_head_bf16_kernel<<<grid, THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

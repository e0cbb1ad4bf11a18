// K5 blur_valid, K6 blur_dx, K7 blur_dw: the per-sample k x k blur of the
// SISR degradation model, forward and both gradients.  Every batch element
// is correlated with its own (k, k) kernel; all tensors are NHWC f32, all
// sums f32 FMA on the CUDA cores (no TF32, no tensor cores: the blur is
// exact in f32 on the TPU side too, Precision.HIGHEST).
//
// Replaces virnet_tpu/ops/pallas_blur.py:
//   K5  _blur_pallas_valid (:307, body _stencil_kernel :46) and
//       _blur_mxu_valid (:118, body _mxu_kernel :100)
//   K6  _blur_mxu_dx (:237, body _mxu_dx_kernel :210) and the
//       flip-and-revalid fallback of _dx_blur (:271-282)
//   K7  _blur_mxu_dw (:180, body _mxu_dw_kernel :160) and
//       _blur_pallas_dw (:374, body _dw_kernel :355)
// The TPU's split into a banded-matmul kernel and a static stencil, the
// int8 band masks and the 768-row tiling exist to fit VMEM and the MXU;
// here each function is one direct kernel.
//
// A row of an NHWC image is W*C contiguous floats, and the tap (dy, dx)
// reads the same row layout shifted by dy rows and dx*C floats, so the
// kernels work on "flat columns" X = x*C + c.  K5, K6 and K7 take any C
// >= 1: a block takes a group of up to 8 channels.
//
// Bound on an H100: k*k FMAs per output float against 8 bytes moved per
// output float; at k = 21 that is 110 FLOP/B, operations bound on the f32
// CUDA cores (67 TFLOP/s).  Exact f32: FMA on the CUDA cores, no TF32.
// (On the tensor cores each sample's taps would have to become a banded
// matrix, as the TPU's _blur_mxu_valid builds, and three TF32 passes would
// be needed to keep f32 accuracy: nothing over the f32 cores at k = 21.)
//
// Design of K5/K6 (one device function, blur_tiles):
//  - a block takes a group of up to 8 channels (images, C = 3: one group),
//    one warp per channel.  A warp's 32 lanes are `by` bands of `lx` lanes
//    (1 x 32, 2 x 16 or 4 x 8, picked per launch: the tile width 3 lx that
//    pads an output row least), and lane x of band b owns pixels 3x ..
//    3x+2 of its channel in rows bR .. bR+R-1 of the tile: 3R outputs, 3
//    flat columns CG apart (CG the group's channels), whose windows
//    overlap.  A tile is by R rows x 3 lx pixels x CG channels: K5's 192
//    pixel rows take one band of 32 lanes, K6's 212-pixel rows four bands
//    of 8 (24 x 24 tiles pad 212 to 216 where 96-pixel tiles padded it to
//    288);
//  - for each tap column dx a thread loads one new window column of R +
//    k - 1 inputs (the other two it kept, a ring of three) and the k taps
//    of that column (float4 broadcasts of a transposed copy), then does
//    3 R k FMAs: 378 per 32 shared-memory loads at R = 6, k = 21, against
//    3.4 FMAs per load in the first design, whose one column per thread
//    read every input once per dx and every tap once per dx and row.  A
//    new column is loaded as soon as the column it replaces has had its
//    last sum, under the other two columns' sums;
//  - the lanes of a band read columns 3 CG floats apart: for odd CG
//    (images: 9 floats) they hit different banks, and a shared row of sw
//    floats is padded so that R sw is an odd multiple of lx: band b starts
//    b lx banks (times an odd number) on, and all 32 lanes of a load hit
//    32 different banks (even CG costs 2-8 bank cycles a load);
//  - the tile and the sample's taps arrive by cp.async (16-byte copies
//    where source and destination are aligned, 4-byte ones with zero fill
//    elsewhere, index math by multiplies: FastDiv), in 25-47 KB of shared
//    memory at C = 3: several blocks share an SM, and while one fills its
//    strip the others compute; in K5's strips of two tiles the second
//    tile's rows arrive under the first one's FMAs.  The blocks are
//    persistent (as many as fit, walking the strips).  A double-buffered
//    tile halves the blocks per SM; so did prefetching the next tap
//    column into more registers, and both read slower;
//  - images (C = 3) get a build per band width whose shared row is a
//    constant, so that each column load is one instruction with an
//    immediate offset; any other C takes the any-C build;
//  - the bounds checks are in the tile load and the stores: nothing is
//    padded in device memory.
//  What bounds it now: the FFMA stream itself, 90% of the loop's
//  instructions, issues below the card's FFMA rate.
// k is a template parameter so that the windows live in registers; the
// sizes built are 3, 5, 7, 15 and 21 (ops/blur.py SUPPORTED_K), any other
// is refused.  K6 is the same device code with the taps flipped and the
// tile loaded at an offset of k-1 with zeros outside the cotangent.
//
// Design of K7 (blur_dw_kernel), K5's register block with the roles
// swapped: each of the k*k taps of a sample sums H*W*C products, so a
// thread owns taps and slides over positions.
//  - a work item is (sample, dy group, group of up to 8 channels, strip of
//    8 cotangent rows, range of 96 pixels); its cotangent tile and its
//    input tile (8 + A - 1 rows from the group's first dy, 96 + 3 NW - 1
//    pixels) sit in shared memory;
//  - warp w of a block's NW owns a tap block of A dy x 3 dx (dx 3w ..
//    3w + 2; k = 21: A = 7, 7 warps, no tap padded; k = 15: A = 5; k <= 7:
//    A = k, and k = 5, 7 pad their dx to 6, 9), lane l the pixels 3l ..
//    3l + 2 of the range in all 8 rows.  Per pixel and channel a lane
//    loads one new window column of 8 + A - 1 inputs (the other two it
//    kept: a ring of three, as K5's) and 8 cotangent values, and does 8 A
//    3 FMAs on them: 168 per 22 shared-memory loads at k = 21, against 64
//    per 23 in the first design (a thread per 8 dy of one dx);
//  - the lanes' runs of 3 pixels are 3 CG floats apart: for odd CG
//    (images: 9) the 32 lanes of a load hit 32 banks; for even CG a float
//    of skew after every 3 pixels makes it 3 CG + 1 (a run is as wide as
//    a dx block, so each column's skew is known at compile time);
//  - the blocks are persistent, as many as fit (3 an SM at k = 21, C =
//    3), and each takes a contiguous range of items; the next item's
//    tiles arrive by cp.async (16-byte copies where a tile row is one
//    aligned run, else 4-byte ones, index math by FastDiv) into a second
//    stage under this one's FMAs;
//  - the sums are fixed in order, with no atomics: a lane sums its items
//    in order while they share a key (sample, dy group); then the warp
//    sums its lanes by a butterfly (every lane the same bits) into slot
//    key + block of a scratch buffer (unique: keys and blocks grow
//    together), and a second small kernel, blur_dw_reduce, sums a tap's
//    slots in ascending block, so item, order.  The grid, and with it the
//    bits, is what the card's occupancy gives: a second run on the card
//    gives the same.
#include <cuda_runtime.h>

#include "tile_async.cuh"

namespace {

constexpr int MAX_SMEM = 227 * 1024;
// images (C = 3) take builds whose shared rows are constants; false in the
// copy that chip_smoke.py times as the any-C build
constexpr bool IMAGE_BUILDS = true;

// ---------------------------------------------------------------------------
// K5 / K6
// ---------------------------------------------------------------------------

// output rows per lane, and tiles one block takes one above the other (a
// strip), sharing their k - 1 rows of halo: K5's and K6's, each what read
// fastest at the SISR training shape (16 x 192^2 x 3, k = 21; K6's
// outputs are 212^2).  K5's strips of 2 x 6 rows are 512, one round of
// the 528 blocks that fit the card, and the second tile's rows arrive
// under the first one's FMAs
constexpr int R = 6;
constexpr int S_VALID = 2;
constexpr int S_DX = 1;
static_assert(S_VALID <= 2 && S_DX <= 2, "the waits for a strip's tiles");
static_assert(R % 4 == 2, "R sw an odd multiple of 8 or 16 for sw % 4 == 0");
constexpr int P = 3;       // pixels per lane, side by side in a row
constexpr int MAX_CG = 8;  // channels of a block: one warp each

// taps of one sample in shared memory, transposed: column dx at
// tap_stride(K) * dx, padded to whole float4s
__host__ __device__ constexpr int tap_stride(int K) { return (K + 3) / 4 * 4; }

// floats of a shared row of the input tile, (P lx + K - 1) CG rounded up
// to 16-byte rows; with several bands (lx < 32) then padded until R sw =
// lx mod 2 lx, so that band b's rows start b lx banks (times an odd
// number) on.  R = 2 mod 4 makes that four steps of 4 at most
__host__ __device__ constexpr int shared_row(int K, int CG, int lx) {
  int sw = ((P * lx + K - 1) * CG + 3) / 4 * 4;
  while (lx < 32 && R * sw % (2 * lx) != lx) sw += 4;
  return sw;
}

// The shapes of a launch.  out[n, y, x, c] = sum_{dy,dx} tap[dy, dx] *
// in'[n, y + dy, x + dx, c], where in' is `in` shifted by `off` rows and
// columns and zero outside [0, Hin) x [0, Win), and tap = taps[n],
// flipped in both axes for K6.  off = 0: VALID correlation (K5).  off =
// K-1 with the flip: the full correlation of the cotangent with the
// flipped kernel (K6).  A block's unit of work is a strip: S tiles of th
// rows x px pixels x CG channels, one above the other.
struct BlurShape {
  int N, Hin, Win, Hout, Wout, C, off;
  int S, lx, by;  // tiles per strip; lanes of a band and bands (lx by = 32)
  int CG;         // channels of a group: min(C, MAX_CG)
  int px, th;     // pixels (P lx) and rows (by R) of a tile
  int sw;         // floats of a shared row of the input tile
  int tiles_x, per_group, per_image, count;
};

template <int K>
BlurShape blur_shape(int N, int Hin, int Win, int Hout, int Wout, int C,
                     bool full) {
  BlurShape s{N, Hin, Win, Hout, Wout, C, full ? K - 1 : 0};
  s.S = full ? S_DX : S_VALID;
  // the band width that pads an output row least, the widest of equals
  s.lx = 32;
  for (int lx = 16, best = (Wout + 95) / 96 * 96; lx >= 8; lx /= 2) {
    const int padded = (Wout + P * lx - 1) / (P * lx) * (P * lx);
    if (padded < best) best = padded, s.lx = lx;
  }
  s.by = 32 / s.lx;
  s.CG = C < MAX_CG ? C : MAX_CG;
  s.px = P * s.lx;
  s.th = s.by * R;
  s.sw = shared_row(K, s.CG, s.lx);
  s.tiles_x = (Wout + s.px - 1) / s.px;
  s.per_group = s.tiles_x * ((Hout + s.S * s.th - 1) / (s.S * s.th));
  s.per_image = (C + MAX_CG - 1) / MAX_CG * s.per_group;
  s.count = N * s.per_image;
  return s;
}

template <int K>
size_t smem_bytes(const BlurShape& s) {
  return sizeof(float) *
         (K * tap_stride(K) + (size_t)(s.S * s.th + K - 1) * s.sw);
}

// sample, first channel, first output row and pixel of strip t
struct Strip {
  int n, c0, y0, x0;
};

__device__ __forceinline__ Strip strip_at(const BlurShape& s, int t) {
  Strip p;
  p.n = t / s.per_image;
  int r = t - p.n * s.per_image;
  const int g = r / s.per_group;
  r -= g * s.per_group;
  const int ty = r / s.tiles_x;
  p.c0 = g * MAX_CG;
  p.y0 = ty * s.S * s.th;
  p.x0 = (r - ty * s.tiles_x) * s.px;
  return p;
}

// issue the copies of sample n's taps into `buf`, transposed (and flipped
// for K6)
template <int K, bool FLIP>
__device__ __forceinline__ void copy_taps(float* buf, const float* taps,
                                          int n) {
  constexpr int TS = tap_stride(K);
  const float* tn = taps + (size_t)n * K * K;
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) {
    const int dy = i / K, dx = i - dy * K;  // K is a constant
    cp_async4(buf + dx * TS + dy, tn + (FLIP ? K * K - 1 - i : i), 4);
  }
}

// issue the copies of rows [r0, r1) of strip p's input tile (S th + K - 1
// rows of sw floats at `tile`: pixels x0 - off ... of channels c0 .. c0 +
// CG - 1), zero outside the input.  With one channel group a tile row is
// one run of floats in device memory, copied 16 bytes at a time where
// source and destination are aligned; with several, float by float.
__device__ __forceinline__ void copy_rows(float* tile, const float* in,
                                          const BlurShape& s, const Strip& p,
                                          int r0, int r1) {
  const int WC = s.Win * s.C, gy0 = p.y0 - s.off, gp0 = p.x0 - s.off;
  const float* inn = in + (size_t)p.n * s.Hin * WC;
  const int nq = s.sw / 4;
  const FastDiv fq(nq);
  if (s.CG == s.C) {
    const int gx0 = gp0 * s.C;
    for (int i = threadIdx.x + r0 * nq; i < r1 * nq; i += blockDim.x) {
      const int r = fq.div(i), q = i - r * nq;
      const int gy = gy0 + r, gx = gx0 + 4 * q;
      float* dst = tile + r * s.sw + 4 * q;
      const bool row_in = gy >= 0 && gy < s.Hin;
      const float* src = inn + (size_t)(row_in ? gy : 0) * WC;
      if (row_in && gx >= 0 && gx + 4 <= WC &&
          ((reinterpret_cast<uintptr_t>(src + gx) & 15) == 0)) {
        cp_async16(dst, src + gx, 16);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in_e = row_in && gx + e >= 0 && gx + e < WC;
        cp_async4(dst + e, in_e ? src + gx + e : inn, in_e ? 4 : 0);
      }
    }
    return;
  }
  const FastDiv fc(s.CG);
  for (int i = threadIdx.x + r0 * nq; i < r1 * nq; i += blockDim.x) {
    const int r = fq.div(i), q = i - r * nq;
    const int gy = gy0 + r;
    float* dst = tile + r * s.sw + 4 * q;
    const bool row_in = gy >= 0 && gy < s.Hin;
    const float* src = inn + (size_t)(row_in ? gy : 0) * WC;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = 4 * q + e, px = fc.div(f);
      const int gx = gp0 + px, c = p.c0 + f - px * s.CG;
      const bool in_e = row_in && gx >= 0 && gx < s.Win && c < s.C;
      cp_async4(dst + e, in_e ? src + (size_t)gx * s.C + c : inn,
                in_e ? 4 : 0);
    }
  }
}

// acc[r][j] += t[dy] * v[r + dy]: one tap column over one window column
template <int K>
__device__ __forceinline__ void tap_column(float (&acc)[R][P], int j,
                                           const float (&t)[tap_stride(K)],
                                           const float (&v)[R + K - 1]) {
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][j] = fmaf(t[dy], v[r + dy], acc[r][j]);
}

template <int K>
__device__ __forceinline__ void load_column(float (&v)[R + K - 1],
                                            const float* col, int sw) {
#pragma unroll
  for (int i = 0; i < R + K - 1; ++i) v[i] = col[i * sw];
}

template <int K>
__device__ __forceinline__ void load_taps(float (&t)[tap_stride(K)],
                                          const float* col) {
#pragma unroll
  for (int i = 0; i < tap_stride(K); i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(col + i);
    t[i] = q.x;
    t[i + 1] = q.y;
    t[i + 2] = q.z;
    t[i + 3] = q.w;
  }
}

// The strips of this block, one after the other.  Warp w takes channel
// c0 + w of the strip's group; lane x of band b owns pixels P x .. P x +
// P - 1 in rows b R .. b R + R - 1 of each tile: flat columns CG apart in
// the shared tile, whose windows overlap, so that one window column of R
// + K - 1 inputs serves P outputs at three tap columns.  LX3 > 0: the
// build for C = 3 (images) and bands of LX3 lanes, whose shared row is a
// constant, so that each column load is one instruction with an immediate
// offset (a row known only at run time costs K5 and K6 7-9% at the
// training shape: chip_smoke.py's any_c_ms); LX3 = 0: any C and band
// width.
template <int K, bool FLIP, int LX3>
__device__ __forceinline__ void blur_tiles(const float* __restrict__ in,
                                           const float* __restrict__ taps,
                                           float* __restrict__ out,
                                           const BlurShape& s) {
  extern __shared__ float sm[];  // 16-byte aligned: the dynamic base
  constexpr int W = R + K - 1, TS = tap_stride(K);
  constexpr int SW3 = LX3 ? shared_row(K, 3, LX3) : 0;
  const int C = LX3 ? 3 : s.C, CG = LX3 ? 3 : s.CG, lx = LX3 ? LX3 : s.lx;
  const int sw = LX3 ? SW3 : s.sw, S = s.S;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int b = l / lx, x = l - b * lx;
  const int col0 = b * R * sw + P * x * CG + w;

  for (int t = blockIdx.x; t < s.count; t += gridDim.x) {
    __syncthreads();  // the strip before is done with shared memory
    const Strip p = strip_at(s, t);
    // the taps and the first tile's rows, then each further tile's rows,
    // each a group of copies of its own
    copy_taps<K, FLIP>(sm, taps, p.n);
    copy_rows(sm + K * TS, in, s, p, 0, s.th + K - 1);
    cp_async_commit();
    for (int st = 1; st < S; ++st) {
      copy_rows(sm + K * TS, in, s, p, st * s.th + K - 1,
                (st + 1) * s.th + K - 1);
      cp_async_commit();
    }
    const int c = p.c0 + w, x0 = p.x0 + P * x;
#pragma unroll 1
    for (int st = 0; st < S; ++st) {
      if (st + 1 < S)
        cp_async_wait<1>();  // S <= 2: this tile's rows, not the next one's
      else
        cp_async_wait<0>();
      __syncthreads();
      const float* tile = sm + K * TS + st * s.th * sw + col0;
      const int y0 = p.y0 + st * s.th + b * R;
      if (c >= C || x0 >= s.Wout || y0 >= s.Hout) continue;
      float acc[R][P];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < P; ++j) acc[r][j] = 0.f;
      // window columns dx, dx + 1, dx + 2 (in units of CG) in a ring of
      // three; step dx sums tap column dx over them (output j over column
      // dx + j), and loads column dx + 3 into the ring's slot of column dx
      // as soon as its last sum is issued, under the other two columns' sums
      float c0[W], c1[W], c2[W], tp[TS];
      load_column<K>(c0, tile, sw);
      load_column<K>(c1, tile + CG, sw);
      load_column<K>(c2, tile + 2 * CG, sw);
      auto step = [&](int dx, float(&a)[W], const float(&d1)[W],
                      const float(&d2)[W]) {
        load_taps<K>(tp, sm + dx * TS);
        tap_column<K>(acc, 0, tp, a);
        if (dx + 3 < K + P - 1) load_column<K>(a, tile + (dx + 3) * CG, sw);
        tap_column<K>(acc, 1, tp, d1);
        tap_column<K>(acc, 2, tp, d2);
      };
#pragma unroll 1
      for (int dx = 0; dx < K; dx += 3) {
        step(dx, c0, c1, c2);
        if (dx + 1 < K) step(dx + 1, c1, c2, c0);
        if (dx + 2 < K) step(dx + 2, c2, c0, c1);
      }
      // one 64-bit address per tile, offsets from it in 32 bits: the
      // blocks of one round all store at once, and per-store address
      // chains held up K5 by a tenth of its time
      float* o = out + (((size_t)p.n * s.Hout + y0) * s.Wout + x0) * C + c;
      const int ow = s.Wout * C;  // floats of an output row
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (y0 + r >= s.Hout) break;
#pragma unroll
        for (int j = 0; j < P; ++j)
          if (x0 + j < s.Wout) o[r * ow + j * C] = acc[r][j];
      }
    }
  }
}

// one entry per function, so that a profile tells K5 from K6; blocks of
// 32 CG threads (96 for images)
template <int K, int LX3>
__global__ void __launch_bounds__(32 * (LX3 ? 3 : MAX_CG))
blur_valid_kernel(const float* __restrict__ xp,
                  const float* __restrict__ taps, float* __restrict__ out,
                  BlurShape s) {
  blur_tiles<K, false, LX3>(xp, taps, out, s);
}

template <int K, int LX3>
__global__ void __launch_bounds__(32 * (LX3 ? 3 : MAX_CG))
blur_dx_kernel(const float* __restrict__ g, const float* __restrict__ taps,
               float* __restrict__ dxp, BlurShape s) {
  blur_tiles<K, true, LX3>(g, taps, dxp, s);
}

// full = false: K5, `in` is the padded input; full = true: K6, `in` is the
// cotangent and `out` the padded-size gradient.  Images (C = 3) get the
// build for their band width.
template <int K>
int launch_blur(bool full, const float* in, const float* taps, float* out,
                int N, int Hin, int Win, int Hout, int Wout, int C,
                cudaStream_t stream) {
  const BlurShape s = blur_shape<K>(N, Hin, Win, Hout, Wout, C, full);
  const size_t smem = smem_bytes<K>(s);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  using Kern = void (*)(const float*, const float*, float*, BlurShape);
  const Kern kernels[8] = {
      blur_valid_kernel<K, 0>,  blur_valid_kernel<K, 32>,
      blur_valid_kernel<K, 16>, blur_valid_kernel<K, 8>,
      blur_dx_kernel<K, 0>,     blur_dx_kernel<K, 32>,
      blur_dx_kernel<K, 16>,    blur_dx_kernel<K, 8>};
  const int v = (full ? 4 : 0) + (!IMAGE_BUILDS || C != 3 ? 0
                                  : s.lx == 32             ? 1
                                  : s.lx == 16             ? 2
                                                           : 3);
  const Kern kernel = kernels[v];
  // the cap on dynamic shared memory, raised once per kernel and device
  // (a host call that costs microseconds)
  static int raised[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (raised[v] != dev) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    raised[v] = dev;
  }
  const int threads = 32 * s.CG;
  const int blocks = persistent_blocks(kernel, threads, smem, s.count);
  if (blocks <= 0) {
    e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorInvalidConfiguration;
  }
  kernel<<<blocks, threads, smem, stream>>>(in, taps, out, s);
  return cudaGetLastError();
}

int dispatch_blur(int k, bool full, const float* in, const float* taps,
                  float* out, int N, int Hin, int Win, int Hout, int Wout,
                  int C, cudaStream_t stream) {
#define VT_BLUR_CASE(K)                                                     \
  case K:                                                                   \
    return launch_blur<K>(full, in, taps, out, N, Hin, Win, Hout, Wout, C, \
                          stream);
  switch (k) {
    VT_BLUR_CASE(3) VT_BLUR_CASE(5) VT_BLUR_CASE(7) VT_BLUR_CASE(15)
    VT_BLUR_CASE(21)
    default:
      return cudaErrorInvalidValue;
  }
#undef VT_BLUR_CASE
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int DW_R = 8;       // cotangent rows of a tile, all in each lane
constexpr int DW_B = 3;       // dx taps of a tap block
constexpr int DW_L = 3;       // pixels of a lane's run (= DW_B: see dw_lane)
constexpr int DW_PX = 32 * DW_L;  // pixels of a tile: one run per lane
constexpr int DW_MAX_CG = 8;  // channels of a group

// dy taps of a tap block: all K up to 7, else a third (15: 5, 21: 7); a
// block's warps take the dx blocks of 3 (K = 5 and 7 pad theirs to 6, 9)
__host__ __device__ constexpr int dw_a(int K) { return K <= 7 ? K : K / 3; }
__host__ __device__ constexpr int dw_warps(int K) {
  return (K + DW_B - 1) / DW_B;
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }
// pixels of the input tile; floats of a shared row of the input tile and
// of the cotangent tile, with `sk` floats of skew after every run of
// DW_L pixels (1 where CG is even: see dw_lane)
__host__ __device__ constexpr int dw_xpix(int K) {
  return DW_PX + DW_B * dw_warps(K) - 1;
}
__host__ __device__ constexpr int dw_xw(int K, int CG, int sk) {
  return round4(dw_xpix(K) * CG + (dw_xpix(K) - 1) / DW_L * sk);
}
__host__ __device__ constexpr int dw_gw(int CG, int sk) {
  return round4(DW_PX * CG + (DW_PX - 1) / DW_L * sk);
}

// The shapes of a launch.  A work item is (sample n, dy group, channel
// group, strip of DW_R cotangent rows, range of DW_PX pixels), numbered in
// that order; a key is (n, dy group), whose items are consecutive.
struct DwShape {
  int N, H, W, C;
  int CG, ngc, sk;       // channels of a group, groups, skew
  int xw, gw;            // floats of a shared row (input, cotangent)
  int strips, ranges;    // tiles down and across a sample
  int per_key, count;    // items of a key, items
  int grid;              // persistent blocks
};

// the block that takes item t: block b takes [b count / grid, (b + 1)
// count / grid)
__host__ __device__ inline int dw_block_of(const DwShape& s, long long t) {
  return (int)(((t + 1) * s.grid - 1) / s.count);
}

// acc[a][b] += g[r] * x[r + a][b] over the DW_L pixels of a lane's run in
// one channel: a ring of DW_B window columns of DW_R + A - 1 inputs (the
// pixels m, m + 1, m + 2 of the run), one new column and DW_R cotangent
// values loaded a pixel, DW_R A DW_B FMAs on them.  xs: the lane's first
// window column in the input tile, gs: its first cotangent value.
template <int K, int C3>
__device__ __forceinline__ void dw_lane(float (&acc)[dw_a(K)][DW_B],
                                        const float* xs, const float* gs,
                                        int CG, int sk, int xw, int gw) {
  constexpr int A = dw_a(K), V = DW_R + A - 1;
  float col[DW_B][V], gv[DW_R];
  // pixel m of the run: m CG floats on, and a skew after each DW_L pixels
  auto load_col = [&](float(&v)[V], int m) {
    const float* p = xs + m * CG + m / DW_L * sk;
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i * xw];
  };
#pragma unroll
  for (int m = 0; m < DW_B - 1; ++m) load_col(col[m], m);
#pragma unroll
  for (int j = 0; j < DW_L; ++j) {
    load_col(col[(j + DW_B - 1) % DW_B], j + DW_B - 1);
#pragma unroll
    for (int r = 0; r < DW_R; ++r) gv[r] = gs[r * gw + j * CG];
#pragma unroll
    for (int r = 0; r < DW_R; ++r)
#pragma unroll
      for (int b = 0; b < DW_B; ++b)
#pragma unroll
        for (int a = 0; a < A; ++a)
          acc[a][b] = fmaf(gv[r], col[(j + b) % DW_B][r + a], acc[a][b]);
  }
}

// rows [0, rows) of a tile whose row r is `len` floats of device memory at
// src + r * stride, zero past row `nrows` and past float `lim` of a row,
// into dst + r * dw (16-byte rows): 16-byte copies where aligned
__device__ __forceinline__ void dw_copy_flat(float* dst, int dw,
                                             const float* src, size_t stride,
                                             int rows, int nrows, int len,
                                             int lim) {
  const int nq = (len + 3) / 4;
  const FastDiv fq(nq);
  for (int i = threadIdx.x; i < rows * nq; i += blockDim.x) {
    const int r = fq.div(i), f = 4 * (i - r * nq);
    float* d = dst + r * dw + f;
    const bool row_in = r < nrows;
    const float* s = src + (row_in ? r : 0) * stride;
    if (row_in && f + 4 <= lim &&
        (reinterpret_cast<uintptr_t>(s + f) & 15) == 0) {
      cp_async16(d, s + f, 16);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in_e = row_in && f + e < lim;
      cp_async4(d + e, in_e ? s + f + e : src, in_e ? 4 : 0);
    }
  }
}

// the same tile float by float, for a channel group of a wider image or
// a skewed row: row r, pixel p, channel c of the group from pixel (y0 + r,
// x0 + p), channel c0 + c of an image of h x w x C at `src`, zero outside
__device__ __forceinline__ void dw_copy_group(float* dst, int dw,
                                              const float* src, int h, int w,
                                              int C, int y0, int x0, int c0,
                                              int rows, int pix, int CG,
                                              int sk) {
  const int len = pix * CG;
  const FastDiv fl(len), fc(CG);
  for (int i = threadIdx.x; i < rows * len; i += blockDim.x) {
    const int r = fl.div(i), q = i - r * len, p = fc.div(q);
    const int y = y0 + r, x = x0 + p, c = c0 + q - p * CG;
    const bool in = y < h && x < w && c < C;
    cp_async4(dst + r * dw + q + p / DW_L * sk,
              in ? src + ((size_t)y * w + x) * C + c : src, in ? 4 : 0);
  }
}

// issue the copies of item t: the cotangent tile (DW_R rows x DW_PX pixels
// x CG channels) and its input tile (DW_R + A - 1 rows from the dy group's
// first row x dw_xpix(K) pixels x CG channels) into the stage at `buf`
template <int K, int C3>
__device__ __forceinline__ void dw_stage(float* buf, const float* xp,
                                         const float* g, const DwShape& s,
                                         int t, int xw, int gw) {
  constexpr int A = dw_a(K), XR = DW_R + A - 1, XPIX = dw_xpix(K);
  const int C = C3 ? 3 : s.C, CG = C3 ? 3 : s.CG, sk = C3 ? 0 : s.sk;
  const int u = t / s.per_key, n = u / (K / A), grp = u - n * (K / A);
  int r = t - u * s.per_key;
  const int per_cg = s.strips * s.ranges, cg = r / per_cg;
  r -= cg * per_cg;
  const int sy = r / s.ranges;
  const int y0 = sy * DW_R, x0 = (r - sy * s.ranges) * DW_PX, c0 = cg * CG;
  const int Hp = s.H + K - 1, Wp = s.W + K - 1, xy0 = y0 + grp * A;
  const float* xn = xp + (size_t)n * Hp * Wp * C;
  const float* gn = g + (size_t)n * s.H * s.W * C;
  float* gbuf = buf + XR * xw;
  if (CG == C && sk == 0) {  // whole pixels: a tile row is one run
    dw_copy_flat(buf, xw, xn + ((size_t)xy0 * Wp + x0) * C, (size_t)Wp * C,
                 XR, Hp - xy0, XPIX * C, (Wp - x0) * C);
    dw_copy_flat(gbuf, gw, gn + ((size_t)y0 * s.W + x0) * C,
                 (size_t)s.W * C, DW_R, s.H - y0, DW_PX * C, (s.W - x0) * C);
  } else {
    dw_copy_group(buf, xw, xn, Hp, Wp, C, xy0, x0, c0, XR, XPIX, CG, sk);
    dw_copy_group(gbuf, gw, gn, s.H, s.W, C, y0, x0, c0, DW_R, DW_PX, CG,
                  sk);
  }
}

// The persistent blocks: block b walks its items in order, the next item's
// tiles arriving (cp.async) into the other stage under this one's FMAs.
// Warp w owns the taps dx in [3 w, 3 w + 3) of the item's dy group; lane l
// the pixels 3 l .. 3 l + 2 of the tile in all DW_R rows and the group's
// channels.  Its sums run on over the items of one key; when the key
// changes (or the block's items end) the warp sums its lanes (a butterfly:
// a fixed order, every lane the same bits) into slot key + b of `part`.
// C3 = 3: the build for C = 3 (images), whose shared rows are constants.
template <int K, int C3>
__global__ void __launch_bounds__(32 * dw_warps(K), C3 ? 3 : 1)
blur_dw_kernel(const float* __restrict__ xp, const float* __restrict__ g,
               float* __restrict__ part, DwShape s) {
  extern __shared__ float sm[];  // 16-byte aligned: the dynamic base
  constexpr int A = dw_a(K), XR = DW_R + A - 1;
  const int CG = C3 ? 3 : s.CG, sk = C3 ? 0 : s.sk;
  const int xw = C3 ? dw_xw(K, 3, 0) : s.xw, gw = C3 ? dw_gw(3, 0) : s.gw;
  const int stage = XR * xw + DW_R * gw;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int run = DW_L * CG + sk;  // floats from one run to the next
  const int lo = (int)((long long)blockIdx.x * s.count / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * s.count / gridDim.x);

  float acc[A][DW_B];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int b = 0; b < DW_B; ++b) acc[a][b] = 0.f;

  dw_stage<K, C3>(sm, xp, g, s, lo, xw, gw);
  cp_async_commit();
#pragma unroll 1
  for (int t = lo; t < hi; ++t) {
    float* buf = sm + ((t - lo) & 1) * stage;
    if (t + 1 < hi) {
      dw_stage<K, C3>(sm + ((t + 1 - lo) & 1) * stage, xp, g, s, t + 1, xw,
                      gw);
      cp_async_commit();
      cp_async_wait<1>();  // this item's tiles, not the next one's
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = buf + (l + w) * run;
    const float* gs = buf + XR * xw + l * run;
#pragma unroll 1
    for (int c = 0; c < CG; ++c)
      dw_lane<K, C3>(acc, xs + c, gs + c, CG, sk, xw, gw);
    const int u = t / s.per_key;
    if (t + 1 == hi || (t + 1) / s.per_key != u) {
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int b = 0; b < DW_B; ++b) {
          float v = acc[a][b];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
          const int dx = DW_B * w + b;
          if (l == 0 && dx < K)
            part[((size_t)(u + blockIdx.x) * A + a) * K + dx] = v;
          acc[a][b] = 0.f;
        }
    }
    __syncthreads();  // every warp is done with this stage
  }
}

// out[n, dy, dx] = sum over the blocks that took items of key (n, dy / A),
// ascending (so ascending item order), of their slots
__global__ void blur_dw_reduce(const float* __restrict__ part,
                               float* __restrict__ out, DwShape s, int K,
                               int A) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.N * K * K) return;
  const int n = i / (K * K), tap = i - n * K * K, dy = tap / K;
  const int u = n * (K / A) + dy / A;
  const int b0 = dw_block_of(s, (long long)u * s.per_key);
  const int b1 = dw_block_of(s, (long long)(u + 1) * s.per_key - 1);
  const float* p = part + (size_t)(dy % A) * K + (tap - dy * K);
  float sum = 0.f;
  for (int b = b0; b <= b1; ++b) sum += p[(size_t)(u + b) * A * K];
  out[i] = sum;
}

struct DwPlan {
  DwShape s;
  void (*kern)(const float*, const float*, float*, DwShape);
  int threads, A, slots;
  size_t smem;
};

// the shapes, build and persistent grid of a launch: cudaErrorInvalidValue
// for shapes K7 does not take
template <int K>
int dw_plan_k(int N, int H, int W, int C, DwPlan* p) {
  constexpr int A = dw_a(K), XR = DW_R + A - 1;
  DwShape& s = p->s;
  s.N = N, s.H = H, s.W = W, s.C = C;
  s.ngc = (C + DW_MAX_CG - 1) / DW_MAX_CG;
  s.CG = (C + s.ngc - 1) / s.ngc;
  s.sk = s.CG % 2 == 0 ? 1 : 0;
  s.xw = dw_xw(K, s.CG, s.sk);
  s.gw = dw_gw(s.CG, s.sk);
  s.strips = (H + DW_R - 1) / DW_R;
  s.ranges = (W + DW_PX - 1) / DW_PX;
  const long long per_key = (long long)s.ngc * s.strips * s.ranges;
  const long long count = (long long)N * (K / A) * per_key;
  if (count > 0x7fffffff) return cudaErrorInvalidValue;
  s.per_key = (int)per_key;
  s.count = (int)count;
  p->smem = 2 * sizeof(float) * ((size_t)XR * s.xw + DW_R * s.gw);
  if (p->smem > MAX_SMEM) return cudaErrorInvalidValue;
  const bool c3 = IMAGE_BUILDS && C == 3;
  p->kern = c3 ? blur_dw_kernel<K, 3> : blur_dw_kernel<K, 0>;
  p->threads = 32 * dw_warps(K);
  p->A = A;
  // the cap on dynamic shared memory, raised once per build and device
  static int raised[2] = {-1, -1};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (raised[c3] != dev) {
    e = cudaFuncSetAttribute(
        p->kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
    raised[c3] = dev;
  }
  s.grid = persistent_blocks(p->kern, p->threads, p->smem, s.count);
  if (s.grid <= 0) {
    e = cudaGetLastError();
    return e != cudaSuccess ? e : cudaErrorInvalidConfiguration;
  }
  // slot key + b for each (key, block that took items of it): unique, as
  // both grow together
  p->slots = N * (K / A) + s.grid - 1;
  return cudaSuccess;
}

int dw_plan(int N, int H, int W, int C, int k, DwPlan* p) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1)
    return cudaErrorInvalidValue;
  switch (k) {
    case 3: return dw_plan_k<3>(N, H, W, C, p);
    case 5: return dw_plan_k<5>(N, H, W, C, p);
    case 7: return dw_plan_k<7>(N, H, W, C, p);
    case 15: return dw_plan_k<15>(N, H, W, C, p);
    case 21: return dw_plan_k<21>(N, H, W, C, p);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// xp (N, H+k-1, W+k-1, C) f32, kernels (N, k, k) f32 -> out (N, H, W, C)
extern "C" int vt_blur_valid(const void* xp, const void* kernels, void* out,
                             int N, int H, int W, int C, int k,
                             void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1)
    return cudaErrorInvalidValue;
  return dispatch_blur(k, false, static_cast<const float*>(xp),
                       static_cast<const float*>(kernels),
                       static_cast<float*>(out), N, H + k - 1, W + k - 1, H,
                       W, C,
                       static_cast<cudaStream_t>(stream));
}

// g (N, H, W, C) f32, kernels (N, k, k) f32 -> dxp (N, H+k-1, W+k-1, C):
// dxp[n, p, q, c] = sum_{dy,dx} kernels[n, dy, dx] * g[n, p-dy, q-dx, c]
extern "C" int vt_blur_dx(const void* g, const void* kernels, void* dxp,
                          int N, int H, int W, int C, int k, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1)
    return cudaErrorInvalidValue;
  return dispatch_blur(k, true, static_cast<const float*>(g),
                       static_cast<const float*>(kernels),
                       static_cast<float*>(dxp), N, H, W, H + k - 1,
                       W + k - 1, C,
                       static_cast<cudaStream_t>(stream));
}

// floats of scratch K7 needs for these shapes (0: shapes not supported)
extern "C" long long vt_blur_dw_scratch_elems(int N, int H, int W, int C,
                                              int k) {
  DwPlan p;
  if (dw_plan(N, H, W, C, k, &p) != cudaSuccess) return 0;
  return (long long)p.slots * p.A * k;
}

// xp (N, H+k-1, W+k-1, C) f32, g (N, H, W, C) f32 -> dw (N, k, k) f32
extern "C" int vt_blur_dw(const void* xp, const void* g, void* scratch,
                          void* dw, int N, int H, int W, int C, int k,
                          void* stream) {
  DwPlan p;
  int e = dw_plan(N, H, W, C, k, &p);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.kern<<<p.s.grid, p.threads, p.smem, st>>>(
      static_cast<const float*>(xp), static_cast<const float*>(g),
      static_cast<float*>(scratch), p.s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int total = N * k * k;
  blur_dw_reduce<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(dw), p.s, k,
      p.A);
  return cudaGetLastError();
}

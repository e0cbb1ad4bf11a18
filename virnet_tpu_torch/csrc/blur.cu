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
// kernels work on "flat columns" X = x*C + c.  K5 and K6 take any C >= 1;
// K7 any C whose chunk fits shared memory (up to 45 at k = 21).
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
// K7 reduces H*W*C products into each of k*k taps per sample.  A block
// owns a 32-row x 64-flat-column chunk of the cotangent (and its halo
// tile of the input) in shared memory.  A thread owns one dx, a group of
// 8 consecutive dy and one of LW column lanes; per column it holds 8 rows
// of the cotangent in registers and slides them along the input column,
// 64 FMAs per 23 shared-memory reads.  The result is deterministic: a
// thread sums its columns (ascending, stride LW) and rows (ascending) in
// order, the LW lanes of a tap are summed in ascending order by one
// thread into a per-chunk partial in a scratch buffer, and a second small
// kernel sums the chunks of a sample in ascending (row-major) order.  No
// atomics anywhere.
#include <cuda_runtime.h>

#include "tile_async.cuh"

namespace {

constexpr int MAX_SMEM = 227 * 1024;

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
  const int v = (full ? 4 : 0) +
                (C != 3 ? 0 : s.lx == 32 ? 1 : s.lx == 16 ? 2 : 3);
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

constexpr int DW_D = 8;         // taps (consecutive dy) per thread
constexpr int DW_R = 8;         // cotangent rows held in registers
constexpr int DW_TH = 32;       // cotangent rows per chunk
constexpr int DW_TX = 64;       // cotangent flat columns per chunk

// part[n, chunk, dy, dx] = sum over the chunk's (y, X) of
//   g[n, y, X] * xp[n, y + dy, X + dx*C]
__global__ void blur_dw_partial(const float* __restrict__ xp,
                                const float* __restrict__ g,
                                float* __restrict__ part, int H, int WC,
                                int Hp, int WCp, int C, int k, int ng,
                                int LW) {
  extern __shared__ float sm[];
  const int SW = DW_TX + (k - 1) * C;
  const int SH = DW_TH + ng * DW_D - 1;
  float* sg = sm;                        // DW_TH x DW_TX
  float* sx = sg + DW_TH * DW_TX;        // SH x SW
  float* sred = sx + SH * SW;            // (ng*k*LW) x DW_D

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * DW_TH, X0 = blockIdx.x * DW_TX;
  const int tid = threadIdx.x, nthr = blockDim.x;

  const float* gn = g + (size_t)n * H * WC;
  for (int idx = tid; idx < DW_TH * DW_TX; idx += nthr) {
    const int gy = y0 + idx / DW_TX, gx = X0 + idx % DW_TX;
    sg[idx] = (gy < H && gx < WC) ? gn[(size_t)gy * WC + gx] : 0.f;
  }
  const float* xn = xp + (size_t)n * Hp * WCp;
  for (int idx = tid; idx < SH * SW; idx += nthr) {
    const int r = idx / SW, j = idx - r * SW;
    const int gy = y0 + r, gx = X0 + j;
    sx[idx] = (gy < Hp && gx < WCp) ? xn[(size_t)gy * WCp + gx] : 0.f;
  }
  __syncthreads();

  const int active = ng * k * LW;
  if (tid < active) {
    const int l = tid % LW, t = tid / LW;
    const int dx = t % k, grp = t / k;
    float acc[DW_D];
#pragma unroll
    for (int j = 0; j < DW_D; ++j) acc[j] = 0.f;
    for (int X = l; X < DW_TX; X += LW) {
#pragma unroll 1
      for (int yc = 0; yc < DW_TH; yc += DW_R) {
        float gr[DW_R];
#pragma unroll
        for (int r = 0; r < DW_R; ++r) gr[r] = sg[(yc + r) * DW_TX + X];
        const float* xc = sx + (grp * DW_D + yc) * SW + X + dx * C;
#pragma unroll
        for (int yy = 0; yy < DW_R + DW_D - 1; ++yy) {
          const float v = xc[yy * SW];
#pragma unroll
          for (int j = 0; j < DW_D; ++j) {
            const int r = yy - j;        // cotangent row paired with tap j
            if (r >= 0 && r < DW_R) acc[j] = fmaf(gr[r], v, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DW_D; ++j) sred[tid * DW_D + j] = acc[j];
  }
  __syncthreads();

  const int chunk = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_chunks = gridDim.x * gridDim.y;
  float* pn = part + ((size_t)n * n_chunks + chunk) * k * k;
  for (int tap = tid; tap < k * k; tap += nthr) {
    const int dy = tap / k, dx = tap % k;
    const int base = ((dy / DW_D) * k + dx) * LW * DW_D + dy % DW_D;
    float sum = 0.f;
    for (int l = 0; l < LW; ++l) sum += sred[base + l * DW_D];
    pn[tap] = sum;
  }
}

// out[n, tap] = sum over chunks (ascending) of part[n, chunk, tap]
__global__ void blur_dw_reduce(const float* __restrict__ part,
                               float* __restrict__ out, int n_chunks, int kk,
                               int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int n = i / kk, tap = i - n * kk;
  const float* p = part + (size_t)n * n_chunks * kk + tap;
  float sum = 0.f;
  for (int c = 0; c < n_chunks; ++c) sum += p[(size_t)c * kk];
  out[i] = sum;
}

struct DwPlan {
  int ng, LW, threads, chunks_x, chunks_y;
  size_t smem;
};

bool dw_plan(int H, int W, int C, int k, DwPlan* p) {
  if (k < 1 || k > 25 || k % 2 == 0 || H < 1 || W < 1 || C < 1) return false;
  p->ng = (k + DW_D - 1) / DW_D;
  int lw = 256 / (p->ng * k);
  p->LW = lw < 1 ? 1 : (lw > 32 ? 32 : lw);
  const int active = p->ng * k * p->LW;
  p->threads = (active + 31) / 32 * 32;
  p->chunks_x = (W * C + DW_TX - 1) / DW_TX;
  p->chunks_y = (H + DW_TH - 1) / DW_TH;
  const size_t SW = DW_TX + (size_t)(k - 1) * C;
  const size_t SH = DW_TH + p->ng * DW_D - 1;
  p->smem = sizeof(float) * (DW_TH * DW_TX + SH * SW + (size_t)active * DW_D);
  return p->smem <= MAX_SMEM && p->chunks_y <= 65535;
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
  if (!dw_plan(H, W, C, k, &p)) return 0;
  return (long long)N * p.chunks_x * p.chunks_y * k * k;
}

// xp (N, H+k-1, W+k-1, C) f32, g (N, H, W, C) f32 -> dw (N, k, k) f32
extern "C" int vt_blur_dw(const void* xp, const void* g, void* scratch,
                          void* dw, int N, int H, int W, int C, int k,
                          void* stream) {
  DwPlan p;
  if (N < 1 || N > 65535 || !dw_plan(H, W, C, k, &p))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blur_dw_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(p.chunks_x, p.chunks_y, N);
  blur_dw_partial<<<grid, p.threads, p.smem, s>>>(
      static_cast<const float*>(xp), static_cast<const float*>(g),
      static_cast<float*>(scratch), H, W * C, H + k - 1, (W + k - 1) * C, C,
      k, p.ng, p.LW);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int total = N * k * k;
  blur_dw_reduce<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<float*>(dw),
      p.chunks_x * p.chunks_y, k * k, total);
  return cudaGetLastError();
}

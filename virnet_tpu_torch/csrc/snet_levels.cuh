// The device bodies of the SNet's first and last levels, and their
// launches, shared by two sets of entry points: snet_levels.cu's
// snet_conv1 and snet_last kernels (K2 in both dtypes, K3 and K8 in fp32)
// and dncnn_head.cu's dncnn_head_conv1 and dncnn_head_last kernels (K3 and
// K8 in bf16).  Each kernel is a __global__ of its own around the same
// body, so that a trace names the kernel after its route.  The design and
// bounds of both bodies are in snet_levels.cu's note.
#pragma once

#include "common.cuh"
#include "tile_async.cuh"

namespace {

constexpr int NF = 64;       // DnCNN filters
constexpr int CI = 3;        // image channels
constexpr int THREADS = 256;
constexpr int TS = 16;       // output tile side
constexpr int MAX_CF = 256;

static_assert(TS * TS == THREADS, "a pixel or a Block8 slot per thread");

// ---- shared pieces --------------------------------------------------------

// dst[i] = src[i] as f32 for i < n over the block.  Each thread issues
// eight loads before any store, so that their latencies overlap.
template <typename T>
__device__ __forceinline__ void fill_f32(float* dst, const T* src, int n) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 8 * THREADS) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS;
      v[j] = i < n ? tof(src[i]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n) dst[i] = v[j];
    }
  }
}

// A thread's register block in a 16x16 tile: 8 pixels of one row (columns
// c0 .. c0 + 7 of row r) x 4 or 8 output channels, channel group cg = the
// lane's low three bits.  Shared memory delivers 128 bytes a clock to the
// registers, a warp-wide broadcast of 16 bytes included, so one pixel per
// thread with the weights read for every pixel left the FMA units waiting
// 4x; a block of 8 pixels reuses each weight read 8 times, and a row of
// 10 inputs serves the three horizontal taps.
struct Block8 {
  int cg, r, c0;
  __device__ Block8()
      : cg(threadIdx.x & 7), r(threadIdx.x >> 4),
        c0(((threadIdx.x >> 3) & 1) * 8) {}
};

__device__ __forceinline__ void fma4(float* acc, float xv, float4 w) {
  acc[0] = fmaf(xv, w.x, acc[0]);
  acc[1] = fmaf(xv, w.y, acc[1]);
  acc[2] = fmaf(xv, w.z, acc[2]);
  acc[3] = fmaf(xv, w.w, acc[3]);
}

// four f32 values rounded to T, stored at p (16 bytes for f32, 8 for bf16)
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// ---- the first level: conv1 3->64 + bias + lrelu ---------------------------

constexpr int XS = TS + 2;                   // side of the staged x tile
constexpr int XN = (CI * XS * XS + THREADS - 1) / THREADS;  // per thread

// x at pixel (gy, gx) of image n of the grid, channel c, zero outside the
// image; with xs > 0 (K8) the images are slabs of the input and x is read
// one row up, zero in row -1 of every input image
template <typename T>
__device__ __forceinline__ float x_at(const T* x, const TileGrid& tg, int xs,
                                      int n, int gy, int gx, int c) {
  const bool in = gy >= 0 && gy < tg.H && gx >= 0 && gx < tg.W &&
                  !(xs > 0 && gy == 0 && n % xs == 0);
  const long long row = (long long)n * tg.H + gy - (xs > 0);
  return in ? tof(x[(row * tg.W + gx) * CI + c]) : 0.f;
}

// The x tile of tile t (with its ring, zeros outside the image), as
// thread-owned values: element k of this thread is x tile entry
// threadIdx.x + k THREADS, pixel-major (p, c), so that the loads read x
// in order.
template <typename T>
__device__ __forceinline__ void fetch_x(float (&xr)[XN], const T* x,
                                        const TileGrid& tg, int xs, int t) {
  int n, y0, x0;
  tg.at(t, n, y0, x0);
#pragma unroll
  for (int k = 0; k < XN; ++k) {
    const int i = threadIdx.x + k * THREADS, p = i / CI, c = i - p * CI;
    xr[k] = i < CI * XS * XS
                ? x_at(x, tg, xs, n, y0 - 1 + p / XS, x0 - 1 + p % XS, c)
                : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void conv1_body(const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           const T* __restrict__ b,
                                           T* __restrict__ y,
                                           const TileGrid& tg, int xs,
                                           float slope) {
  __shared__ __align__(16) float sw[9 * CI * NF];  // HWIO: [tap][ci][co]
  __shared__ __align__(16) float sb[NF];
  __shared__ float sx[2][CI][XS * XS];             // two x tiles, planar
  fill_f32(sw, w, 9 * CI * NF);
  if (threadIdx.x < NF) sb[threadIdx.x] = tof(b[threadIdx.x]);
  const Block8 bk;
  float xr[XN];
  if (blockIdx.x < tg.count) fetch_x(xr, x, tg, xs, blockIdx.x);

  int it = 0;
  for (int t = blockIdx.x; t < tg.count; t += gridDim.x, ++it) {
    float(*s)[XS * XS] = sx[it & 1];
#pragma unroll
    for (int k = 0; k < XN; ++k) {
      const int i = threadIdx.x + k * THREADS, p = i / CI;
      if (i < CI * XS * XS) s[i - p * CI][p] = xr[k];
    }
    __syncthreads();  // the tile is staged (and, the first time, sw, sb)
    if (t + gridDim.x < tg.count) fetch_x(xr, x, tg, xs, t + gridDim.x);

    // channels cg*4 .. +3 (lo) and 32 + cg*4 .. +3 (hi), started at the bias
    float acc[8][8];
    const float4 blo = *reinterpret_cast<const float4*>(sb + bk.cg * 4);
    const float4 bhi = *reinterpret_cast<const float4*>(sb + 32 + bk.cg * 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] = blo.x; acc[j][1] = blo.y; acc[j][2] = blo.z;
      acc[j][3] = blo.w; acc[j][4] = bhi.x; acc[j][5] = bhi.y;
      acc[j][6] = bhi.z; acc[j][7] = bhi.w;
    }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int c = 0; c < CI; ++c) {
        float xrow[10];
#pragma unroll
        for (int j = 0; j < 10; ++j)
          xrow[j] = s[c][(bk.r + dy) * XS + bk.c0 + j];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = sw + ((dy * 3 + dx) * CI + c) * NF + bk.cg * 4;
          const float4 lo = *reinterpret_cast<const float4*>(wr);
          const float4 hi = *reinterpret_cast<const float4*>(wr + 32);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            fma4(acc[j], xrow[j + dx], lo);
            fma4(acc[j] + 4, xrow[j + dx], hi);
          }
        }
      }

    int n, y0, x0;
    tg.at(t, n, y0, x0);
    const int oy = y0 + bk.r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ox = x0 + bk.c0 + j;
      if (oy >= tg.H || ox >= tg.W) continue;
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[j][o] = lrelu(acc[j][o], slope);
      T* yp = y + ((size_t)(n * tg.H + oy) * tg.W + ox) * NF + bk.cg * 4;
      store4(yp, acc[j]);
      store4(yp + 32, acc[j] + 4);
    }
  }
}

// ---- the last level: conv_last, and the sigma epilogue + head conv --------

constexpr int UNITS = 4;             // 16-byte units of a chunk per pixel
constexpr int ROW_U = UNITS | 1;     // staged pixel: 5 units (odd)

// one 16-byte unit of a staged pixel as f32: 4 floats or 8 bf16
__device__ __forceinline__ void load_unit(const float* p, float (&v)[4]) {
  load4(p, v);
}
__device__ __forceinline__ void load_unit(const __nv_bfloat16* p,
                                          float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

struct LastArgs {
  const void *lev, *x, *wl, *bl, *wh, *bh;
  void *out0, *out1;  // logits, or head and sigma
  int N, H, W, CF;
  int xs;  // 0, or (K8) slabs per input image: x is read one row up
  float lmin, lmax;
};

// shared memory of the last level's body <T, CO, HEAD> at head width CF
// (bytes): two chunk buffers, conv_last's weights and bias; with HEAD the
// head's weights and bias and the [x | sqrt(sigma)] plane
template <int CO, bool HEAD>
size_t last_smem(int CF) {
  const size_t side = TS + 2 * (HEAD ? 1 : 0) + 2;  // of the staged level
  size_t s = 2 * side * side * ROW_U * 16 +
             sizeof(float) * (9 * NF * CO + 4);
  if (HEAD) {
    const int RS = TS + 2;
    s += sizeof(float) * ((size_t)9 * (CI + CO) * CF + CF +
                          (size_t)(CI + CO) * RS * RS);
  }
  return s;
}

template <typename T, int CO, bool HEAD>
__device__ __forceinline__ void last_body(const LastArgs& a,
                                          const TileGrid& tg) {
  constexpr int M = HEAD ? 1 : 0;    // margin of conv_last's region
  constexpr int RS = TS + 2 * M;     // its side
  constexpr int RPX = RS * RS;
  constexpr int SS = RS + 2;         // side of the staged level
  constexpr int SPX = SS * SS;
  constexpr int VE = 16 / sizeof(T);             // values per 16 bytes
  constexpr int NCH = NF / (UNITS * VE);         // chunks per pixel
  constexpr int ROWE = ROW_U * VE;               // staged pixel, elements
  constexpr int NP = (RPX + THREADS - 1) / THREADS;  // pixels per thread
  constexpr int CC = CI + CO, K = 9 * CC;        // head conv's inputs
  const int CF = a.CF;
  const T* lev = static_cast<const T*>(a.lev);

  extern __shared__ __align__(16) unsigned char last_smem_raw[];
  T* chunk = reinterpret_cast<T*>(last_smem_raw);
  float* swl = reinterpret_cast<float*>(chunk + 2 * SPX * ROWE);
  float* sbl = swl + 9 * NF * CO;
  float* swh = sbl + 4;                // HEAD: [k][CF], k = tap * CC + c
  float* sbh = swh + K * CF;
  float* plane = sbh + CF;             // HEAD: [c][RPX]

  fill_f32(swl, static_cast<const T*>(a.wl), 9 * NF * CO);
  if (threadIdx.x < CO)
    sbl[threadIdx.x] = tof(static_cast<const T*>(a.bl)[threadIdx.x]);
  if (HEAD) {
    fill_f32(swh, static_cast<const T*>(a.wh), K * CF);
    fill_f32(sbh, static_cast<const T*>(a.bh), CF);
  }

  // chunk s of this block: tile blockIdx.x + (s / NCH) gridDim.x, channels
  // [(s % NCH) UNITS VE, + UNITS VE); the staged rectangle's pixel (0, 0)
  // is image pixel (y0 - M - 1, x0 - M - 1), zeros outside the image
  const int my_tiles =
      blockIdx.x < tg.count ? (tg.count - blockIdx.x + gridDim.x - 1) /
                                  gridDim.x
                            : 0;
  const int steps = my_tiles * NCH;
  auto issue = [&](int s) {
    int n, y0, x0;
    tg.at(blockIdx.x + (s / NCH) * gridDim.x, n, y0, x0);
    const int c0 = (s % NCH) * UNITS * VE;
    T* dst = chunk + (s & 1) * SPX * ROWE;
    for (int i = threadIdx.x; i < SPX * UNITS; i += THREADS) {
      const int p = i / UNITS, u = i % UNITS;
      const int gy = y0 - M - 1 + p / SS, gx = x0 - M - 1 + p % SS;
      const bool in = gy >= 0 && gy < tg.H && gx >= 0 && gx < tg.W;
      const T* src =
          in ? lev + ((size_t)(n * tg.H + gy) * tg.W + gx) * NF + c0 + u * VE
             : lev;
      cp_async16(dst + p * ROWE + u * VE, src, in ? 16 : 0);
    }
  };

  // this thread's pixels of conv_last's region: threadIdx.x + j THREADS
  int rp[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) rp[j] = threadIdx.x + j * THREADS;
  float acc[NP][CO];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[j][c] = 0.f;

  if (steps > 0) issue(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* src = chunk + (s & 1) * SPX * ROWE;
    const int c0 = (s % NCH) * UNITS * VE;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        // weights of channels c0 + u VE .. + VE, all CO outputs
        float wv[VE * CO];
        const float4* wp = reinterpret_cast<const float4*>(
            swl + (tap * NF + c0 + u * VE) * CO);
#pragma unroll
        for (int q = 0; q < VE * CO / 4; ++q) {
          const float4 v = wp[q];
          wv[4 * q] = v.x; wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z; wv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (rp[j] >= RPX) continue;
          const int ry = rp[j] / RS, rx = rp[j] % RS;
          float xv[VE];
          load_unit(src + ((ry + dy) * SS + rx + dx) * ROWE + u * VE, xv);
#pragma unroll
          for (int e = 0; e < VE; ++e)
#pragma unroll
            for (int c = 0; c < CO; ++c)
              acc[j][c] = fmaf(xv[e], wv[e * CO + c], acc[j][c]);
        }
      }
    }
    if (s % NCH == NCH - 1) {
      int n, y0, x0;
      tg.at(blockIdx.x + (s / NCH) * gridDim.x, n, y0, x0);
      if (!HEAD) {
        const int oy = y0 + rp[0] / RS, ox = x0 + rp[0] % RS;
        if (oy < tg.H && ox < tg.W) {
          T* o = static_cast<T*>(a.out0) +
                 ((size_t)(n * tg.H + oy) * tg.W + ox) * CO;
#pragma unroll
          for (int c = 0; c < CO; ++c) o[c] = fromf<T>(acc[0][c] + sbl[c]);
        }
      } else {
        // the sigma epilogue over the region (the tile and a 1-pixel
        // ring), then [x | sqrt(sigma)] into the plane, zero outside
        const T* x = static_cast<const T*>(a.x);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          if (rp[j] >= RPX) continue;
          const int ly = rp[j] / RS - 1, lx = rp[j] % RS - 1;
          const int gy = y0 + ly, gx = x0 + lx;
          const bool in = gy >= 0 && gy < tg.H && gx >= 0 && gx < tg.W;
          const bool own = in && ly >= 0 && ly < TS && lx >= 0 && lx < TS;
          const size_t pix = (size_t)gy * tg.W + gx;
#pragma unroll
          for (int c = 0; c < CI; ++c)
            plane[c * RPX + rp[j]] = x_at(x, tg, a.xs, n, gy, gx, c);
#pragma unroll
          for (int c = 0; c < CO; ++c) {
            float e = 0.f;
            if (in) {
              const float lg = round_to<T>(acc[j][c] + sbl[c]);
              const float sig = expf(fminf(fmaxf(lg, a.lmin), a.lmax));
              if (own)
                static_cast<T*>(a.out1)[((size_t)n * tg.H * tg.W + pix) * CO +
                                        c] = fromf<T>(sig);
              e = round_to<T>(sqrtf(sig));
            }
            plane[(CI + c) * RPX + rp[j]] = e;
          }
        }
        __syncthreads();
        // the head conv in passes of 32 channels: per thread 8 pixels x
        // 4 channels (Block8), a row of 10 plane values serving the three
        // horizontal taps; lanes past CF in the last pass idle
        const Block8 bk;
        const int oy = y0 + bk.r;
#pragma unroll 1
        for (int f0 = 0; f0 < CF; f0 += 32) {
          const int f = f0 + bk.cg * 4;
          if (f >= CF) continue;
          float h[8][4];
          const float4 bv = *reinterpret_cast<const float4*>(sbh + f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            h[j][0] = bv.x; h[j][1] = bv.y; h[j][2] = bv.z; h[j][3] = bv.w;
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int c = 0; c < CC; ++c) {
              float xrow[10];
#pragma unroll
              for (int j = 0; j < 10; ++j)
                xrow[j] = plane[c * RPX + (bk.r + dy) * RS + bk.c0 + j];
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const float4 wv = *reinterpret_cast<const float4*>(
                    swh + ((dy * 3 + dx) * CC + c) * CF + f);
#pragma unroll
                for (int j = 0; j < 8; ++j) fma4(h[j], xrow[j + dx], wv);
              }
            }
          T* hrow = static_cast<T*>(a.out0) +
                    ((size_t)(n * tg.H + oy) * tg.W + x0 + bk.c0) * CF + f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (oy < tg.H && x0 + bk.c0 + j < tg.W) store4(hrow + j * CF, h[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[j][c] = 0.f;
    }
    __syncthreads();  // this chunk buffer (and the plane) is free
  }
}

// ---- launches --------------------------------------------------------------

int error_or(cudaError_t fallback) {
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : fallback;
}

// a conv1 kernel (x, w, b, y, tg, xs, slope) of activation type T,
// persistent over 16x16 tiles
template <typename T, typename K>
int launch_conv1(K kern, const void* x, const void* w, const void* b, void* y,
                 int N, int H, int W, int xs, float slope,
                 cudaStream_t stream) {
  const TileGrid tg(N, H, W, TS, TS);
  const int blocks = persistent_blocks(kern, THREADS, 0, tg.count);
  if (blocks <= 0) return error_or(cudaErrorInvalidConfiguration);
  kern<<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), tg, xs, slope);
  return cudaGetLastError();
}

// a last-level kernel (a, tg) with `smem` bytes of dynamic shared memory,
// persistent over 16x16 tiles
template <typename K>
int launch_last(K kern, size_t smem, const LastArgs& a, cudaStream_t stream) {
  const TileGrid tg(a.N, a.H, a.W, TS, TS);
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return error_or(cudaErrorInvalidConfiguration);
  const int blocks = persistent_blocks(kern, THREADS, smem, tg.count);
  if (blocks <= 0) return error_or(cudaErrorInvalidConfiguration);
  kern<<<blocks, THREADS, smem, stream>>>(a, tg);
  return cudaGetLastError();
}

// the arguments of the last level are those of vt_snet_last and
// vt_dncnn_head_last: refuse what neither takes
bool last_args_bad(int N, int H, int W, int CO, int CF, int head, int xs) {
  return N < 1 || H < 1 || W < 1 || CO < 1 || CO > 3 ||
         (head && (CF < 16 || CF % 16 != 0 || CF > MAX_CF)) || xs < 0 ||
         (xs > 0 && N % xs != 0);
}

}  // namespace

// K2 dncnn_fused and K3 dncnn_head_fused: the whole SNet (DnCNN) in one
// launch, and with HEAD=true also the sigma epilogue and RNet's head conv.
//
// Replaces:
//   K2 -> virnet_tpu/ops/pallas_conv.py:dncnn_pair_fused (:474; Pallas
//         body _dncnn_kernel :369);
//   K3 -> virnet_tpu/ops/pallas_conv.py:dncnn_head_fused modes 'halo'
//         (_dncnn_head_kernel :925) and 'carry' (_dncnn_head_kernel_carry
//         :1055).  The carry mode sweeps row tiles in order and carries a
//         boundary row per level from one grid step to the next; Hopper
//         blocks run in no order, so both modes become this one halo
//         kernel.
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

struct Args {
  const void *x, *w1, *b1, *wm, *bm, *wl, *bl, *wh, *bh;
  void *out0, *out1, *scratch;
  int N, H, W, L, CO, CF;
  float slope, lmin, lmax;
};

template <typename T, bool HEAD>
size_t smem_bytes() {
  return sizeof(T) * SW_ELEMS + sizeof(float) * MAX_BIAS +
         (HEAD ? sizeof(float) * (TILE + 2) * (TILE + 2) * 3 : 0);
}

__host__ __device__ inline int halo(int L, bool head) {
  return head ? L + 2 : L + 1;
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
// transposed weights in shared memory.  Out-of-image pixels store zeros.
__device__ void mid_level_mma(const __nv_bfloat16* src, __nv_bfloat16* dst,
                              const __nv_bfloat16* swt, const float* sb,
                              int m, int Hh, int S, int ty0, int tx0, int H,
                              int W, float slope) {
  const int R = TILE + 2 * m, npix = R * R;
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
      const int ly = pp / R - m, lx = pp % R - m;
      const int gy = ty0 + ly, gx = tx0 + lx;
      in[r] = gy >= 0 && gy < H && gx >= 0 && gx < W;
      base[r] = ((size_t)(ly + Hh) * S + lx + Hh) * NF;
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

template <typename T, bool HEAD>
__global__ void __launch_bounds__(THREADS) dncnn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  float* sb = reinterpret_cast<float*>(smem_raw + sizeof(T) * SW_ELEMS);
  float* sext = sb + MAX_BIAS;  // [(TILE+2)^2][CO], K3 only

  const T* x = static_cast<const T*>(a.x);
  const int H = a.H, W = a.W, L = a.L, CO = a.CO;
  const int Hh = halo(L, HEAD);
  const int S = TILE + 2 * Hh;
  T* buf0 = static_cast<T*>(a.scratch) + (size_t)blockIdx.x * 2 * S * S * NF;
  T* buf1 = buf0 + (size_t)S * S * NF;
  const int ntx = (W + TILE - 1) / TILE, nty = (H + TILE - 1) / TILE;
  const int ntiles = a.N * nty * ntx;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile / (nty * ntx), rr = tile % (nty * ntx);
    const int ty0 = (rr / ntx) * TILE, tx0 = (rr % ntx) * TILE;
    const T* xn = x + (size_t)n * H * W * CI;

    // ---- conv1 3->64 + lrelu on the margin-Hh region -> buf0
    __syncthreads();
    copy_to_smem(sw, static_cast<const T*>(a.w1), 9 * CI * NF);
    for (int i = threadIdx.x; i < NF; i += THREADS)
      sb[i] = tof(static_cast<const T*>(a.b1)[i]);
    __syncthreads();
    {
      const int R = TILE + 2 * Hh;
      for (int p = threadIdx.x; p < R * R; p += THREADS) {
        const int ly = p / R - Hh, lx = p % R - Hh;
        const int gy = ty0 + ly, gx = tx0 + lx;
        T* dst = buf0 + ((size_t)(ly + Hh) * S + lx + Hh) * NF;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
          for (int o = 0; o < NF; ++o) dst[o] = fromf<T>(0.f);
          continue;
        }
        float acc[NF];
#pragma unroll
        for (int o = 0; o < NF; ++o) acc[o] = 0.f;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int yy = gy + tap / 3 - 1, xx = gx + tap % 3 - 1;
          if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
          const T* xp = xn + ((size_t)yy * W + xx) * CI;
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
      const int m = Hh - lev, R = TILE + 2 * m;
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        mid_level_mma(src, dstb, sw, sb, m, Hh, S, ty0, tx0, H, W, a.slope);
        continue;
      }
      for (int p = threadIdx.x; p < R * R; p += THREADS) {
        const int ly = p / R - m, lx = p % R - m;
        const int gy = ty0 + ly, gx = tx0 + lx;
        T* dst = dstb + ((size_t)(ly + Hh) * S + lx + Hh) * NF;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
          for (int o = 0; o < NF; ++o) dst[o] = fromf<T>(0.f);
          continue;
        }
        float acc[NF];
#pragma unroll
        for (int o = 0; o < NF; ++o) acc[o] = 0.f;
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const T* xp = src + ((size_t)(ly + tap / 3 - 1 + Hh) * S + lx +
                               tap % 3 - 1 + Hh) * NF;
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
    //      ring, which the head conv reads)
    __syncthreads();
    copy_to_smem(sw, static_cast<const T*>(a.wl), 9 * NF * CO);
    for (int i = threadIdx.x; i < CO; i += THREADS)
      sb[i] = tof(static_cast<const T*>(a.bl)[i]);
    __syncthreads();
    {
      const T* src = L % 2 ? buf1 : buf0;
      const int m = HEAD ? 1 : 0, R = TILE + 2 * m;
      for (int p = threadIdx.x; p < R * R; p += THREADS) {
        const int ly = p / R - m, lx = p % R - m;
        const int gy = ty0 + ly, gx = tx0 + lx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        float* ext = sext + ((ly + 1) * (TILE + 2) + lx + 1) * CO;
        if (!in) {
          if (HEAD)
            for (int c = 0; c < CO; ++c) ext[c] = 0.f;
          continue;
        }
        float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const T* xp = src + ((size_t)(ly + tap / 3 - 1 + Hh) * S + lx +
                               tap % 3 - 1 + Hh) * NF;
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
        const size_t o = ((size_t)(n * H + gy) * W + gx) * CO;
        for (int c = 0; c < CO; ++c) {
          const float logit = acc[c] + sb[c];
          if (!HEAD) {
            static_cast<T*>(a.out0)[o + c] = fromf<T>(logit);
          } else {
            const float lg = round_to<T>(logit);
            const float sig = expf(fminf(fmaxf(lg, a.lmin), a.lmax));
            if (ly >= 0 && ly < TILE && lx >= 0 && lx < TILE)
              static_cast<T*>(a.out1)[o + c] = fromf<T>(sig);
            ext[c] = round_to<T>(sqrtf(sig));
          }
        }
      }
    }

    // ---- K3: head conv on [x | sqrt(sigma)] over the tile
    if (HEAD) {
      const int CC = CI + CO, CF = a.CF;
      __syncthreads();
      copy_to_smem(sw, static_cast<const T*>(a.wh), 9 * CC * CF);
      for (int i = threadIdx.x; i < CF; i += THREADS)
        sb[i] = tof(static_cast<const T*>(a.bh)[i]);
      __syncthreads();
      for (int p = threadIdx.x; p < TILE * TILE; p += THREADS) {
        const int ly = p / TILE, lx = p % TILE;
        const int gy = ty0 + ly, gx = tx0 + lx;
        if (gy >= H || gx >= W) continue;
        T* hp = static_cast<T*>(a.out0) + ((size_t)(n * H + gy) * W + gx) * CF;
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
            if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
              const T* xp = xn + ((size_t)yy * W + xx) * CI;
#pragma unroll
              for (int ci = 0; ci < CI; ++ci)
                fma_row<HC>(acc, tof(xp[ci]), wp + ci * CF);
            }
            const float* ep = sext + ((ly + dy) * (TILE + 2) + lx + dx) * CO;
            for (int c = 0; c < CO; ++c)
              fma_row<HC>(acc, ep[c], wp + (CI + c) * CF);
          }
#pragma unroll
          for (int o = 0; o < HC; ++o) hp[c0 + o] = fromf<T>(acc[o] + sb[c0 + o]);
        }
      }
    }
  }
}

template <typename T, bool HEAD>
cudaError_t prepare() {
  return cudaFuncSetAttribute(dncnn_kernel<T, HEAD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T, HEAD>());
}

template <typename T, bool HEAD>
int grid_size(int ntiles, int* grid) {
  cudaError_t err = prepare<T, HEAD>();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dncnn_kernel<T, HEAD>, THREADS, smem_bytes<T, HEAD>());
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int full = sms * per_sm;
  *grid = ntiles < full ? ntiles : full;
  return cudaSuccess;
}

template <typename T, bool HEAD>
int launch(const Args& a, int grid, cudaStream_t stream) {
  cudaError_t err = prepare<T, HEAD>();
  if (err != cudaSuccess) return err;
  dncnn_kernel<T, HEAD><<<grid, THREADS, smem_bytes<T, HEAD>(), stream>>>(a);
  return cudaGetLastError();
}

int n_tiles(int N, int H, int W) {
  return N * ((H + TILE - 1) / TILE) * ((W + TILE - 1) / TILE);
}

}  // namespace

// Persistent grid for (dtype, head) at this image size: the wrapper sizes
// the block-private scratch from it, grid * scratch_elems(L, head).
extern "C" int vt_dncnn_grid(int dtype, int head, int N, int H, int W,
                             int* grid) {
  const int nt = n_tiles(N, H, W);
  if (dtype == VT_F32)
    return head ? grid_size<float, true>(nt, grid)
                : grid_size<float, false>(nt, grid);
  if (dtype == VT_BF16)
    return head ? grid_size<__nv_bfloat16, true>(nt, grid)
                : grid_size<__nv_bfloat16, false>(nt, grid);
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
  if (CO < 1 || CO > 3 || (head && (CF % HC != 0 || CF > MAX_BIAS ||
                                    9 * (CI + CO) * CF > 9 * NF * NF)))
    return cudaErrorInvalidValue;
  Args a{x, w1, b1, wm, bm, wl, bl, wh, bh, out0, out1, scratch,
         N, H, W, L, CO, CF, slope, lmin, lmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32)
    return head ? launch<float, true>(a, grid, s)
                : launch<float, false>(a, grid, s);
  if (dtype == VT_BF16)
    return head ? launch<__nv_bfloat16, true>(a, grid, s)
                : launch<__nv_bfloat16, false>(a, grid, s);
  return cudaErrorInvalidValue;
}

// K8 dncnn_head_slabzero, the speed probe: the whole SNet (DnCNN), the
// sigma epilogue and RNet's head conv in one launch, with every r-row slab
// of the image computed as an image of its own.  This file holds the probe
// only: K2 and K3 in fp32 are the level chain of snet_levels.cu, K3 in
// bf16 is dncnn_head.cu.
//
// Replaces: virnet_tpu/ops/pallas_conv.py:dncnn_head_fused mode 'slabzero'
// (_dncnn_head_kernel_slabzero :1183, pallas_call :1412).  Slab t reads
// image rows [t*r - 1, t*r + r - 1) (row -1 is zeros, as the Pallas
// caller's padded view has it) and writes output rows [t*r, t*r + r):
// wrong within L+2 rows of every slab edge and shifted down one row
// against the true prologue, on purpose.  It computes K3's function far
// from slab edges, with nothing recomputed, so it measures what K3's
// function costs without a halo.
//
// Function: conv1 3->64 + lrelu, L mids 64->64 + lrelu, conv_last 64->co,
// zero 'same' padding at every level (at slab borders too), f32
// accumulation and one rounding to the activation dtype per conv; logits
// rounded to the activation dtype, sigma = exp(clip(logits, lmin, lmax))
// and sqrt(sigma) in f32, sigma emitted in the activation dtype,
// sqrt(sigma) rounded and ZERO outside the slab, then head = conv(x,
// wh[:, :, :3]) + conv(sqrt(sigma), wh[:, :, 3:]) + bh (the concat never
// exists).
//
// Bound on an H100: ~233 kFLOP per pixel (denoising-syn, bf16) against
// ~200 B per pixel of input and output, far above the ridge: compute
// bound.  Design (PR 1's fused SNet): a block owns one whole slab, r rows
// x W columns, at every level, with no margin (struct Region).  Its two
// level buffers are (r+2) x (W+2) x 64 with a ring of zeros that the
// block writes once and no level touches, in a block-private scratch in
// device memory; sqrt(sigma) is a third (r+2) x (W+2) x co plane of that
// scratch (already rounded to T, so nothing is lost).  Shared memory
// holds one level's weights (147 KB for 64x64 in f32).  The grid is
// persistent (as many blocks as fit on the SMs, each walking slabs),
// which bounds the scratch.  In bf16 the 64->64 mids, ~95% of the
// operations, run on the tensor cores (mma.sync m16n8k16, f32
// accumulation; mid_level_mma) with A fragments read straight from the
// scratch; everything else, and everything in f32, runs one thread per
// pixel with all output sums in registers on the f32 CUDA cores, weight
// reads being warp-wide broadcasts.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NF = 64;     // DnCNN filters
constexpr int CI = 3;      // image channels
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
  int N, H, W, L, CO, CF, rows;  // rows: the slab height
  float slope, lmin, lmax;
};

// The rectangle one block works on, and where its levels lie in the two
// scratch buffers: one slab, margin 0 at every level.
struct Region {
  int th, tw;    // the output rectangle: rows, columns
  int org;       // buffer coordinates of its pixel (0, 0)
  int S;         // buffer row stride in pixels
  int H, W;      // bounds of the zero padding: the slab
  int ty0, tx0;  // origin of the rectangle inside those bounds
  int xrow0;     // image row that row 0 of the bounds reads (t*r - 1)
  int orow0;     // output row that row 0 of the bounds writes (t*r)
};

template <typename T>
size_t smem_bytes() {
  return sizeof(T) * SW_ELEMS + sizeof(float) * MAX_BIAS;
}

// the scratch per block: two (rows+2) x (W+2) x 64 level buffers and the
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

template <typename T>
__global__ void __launch_bounds__(THREADS) slabzero_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  float* sb = reinterpret_cast<float*>(smem_raw + sizeof(T) * SW_ELEMS);

  const T* x = static_cast<const T*>(a.x);
  const int H = a.H, W = a.W, L = a.L, CO = a.CO;
  Region rg;
  rg.th = a.rows;
  rg.tw = W;
  rg.org = 1;
  rg.S = rg.tw + 2 * rg.org;
  rg.H = a.rows;
  rg.W = W;
  rg.ty0 = rg.tx0 = rg.xrow0 = rg.orow0 = 0;
  const int S = rg.S, org = rg.org;
  const int ES = rg.tw + 2;  // row stride of the sqrt(sigma) plane
  const size_t level = (size_t)(rg.th + 2 * org) * S * NF;
  const size_t per_block = (size_t)slab_scratch_elems(a.rows, W, CO);
  T* buf0 = static_cast<T*>(a.scratch) + (size_t)blockIdx.x * per_block;
  T* buf1 = buf0 + level;
  T* ext0 = buf1 + level;
  const int nty = H / a.rows;
  const int ntiles = a.N * nty;

  {
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
      for (int c = 0; c < CO; ++c) ext0[(size_t)i * CO + c] = fromf<T>(0.f);
    }
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile / nty, rr = tile % nty;
    rg.xrow0 = rr * a.rows - 1;
    rg.orow0 = rr * a.rows;
    const int ty0 = rg.ty0, tx0 = rg.tx0;
    const T* xn = x + (size_t)n * H * W * CI;
    const size_t orow = (size_t)n * H + rg.orow0;  // output row of bounds row 0

    // ---- conv1 3->64 + lrelu on the slab -> buf0
    __syncthreads();
    copy_to_smem(sw, static_cast<const T*>(a.w1), 9 * CI * NF);
    for (int i = threadIdx.x; i < NF; i += THREADS)
      sb[i] = tof(static_cast<const T*>(a.b1)[i]);
    __syncthreads();
    {
      const int RW = rg.tw, RH = rg.th;
      for (int p = threadIdx.x; p < RH * RW; p += THREADS) {
        const int ly = p / RW, lx = p % RW;
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
          if (yy + rg.xrow0 < 0) continue;  // the zero row above row 0
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
      const int RW = rg.tw, RH = rg.th;
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        mid_level_mma(src, dstb, sw, sb, 0, rg, a.slope);
        continue;
      }
      for (int p = threadIdx.x; p < RH * RW; p += THREADS) {
        const int ly = p / RW, lx = p % RW;
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

    // ---- conv_last 64->co on the slab (its ring is zeros already), the
    //      sigma epilogue and sqrt(sigma) into the plane
    __syncthreads();
    copy_to_smem(sw, static_cast<const T*>(a.wl), 9 * NF * CO);
    for (int i = threadIdx.x; i < CO; i += THREADS)
      sb[i] = tof(static_cast<const T*>(a.bl)[i]);
    __syncthreads();
    {
      const T* src = L % 2 ? buf1 : buf0;
      const int RW = rg.tw, RH = rg.th;
      for (int p = threadIdx.x; p < RH * RW; p += THREADS) {
        const int ly = p / RW, lx = p % RW;
        const int gy = ty0 + ly, gx = tx0 + lx;
        const bool in = gy >= 0 && gy < rg.H && gx >= 0 && gx < rg.W;
        T* ext = ext0 + ((size_t)(ly + 1) * ES + lx + 1) * CO;
        if (!in) {
          for (int c = 0; c < CO; ++c) ext[c] = fromf<T>(0.f);
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
          const float lg = round_to<T>(acc[c] + sb[c]);
          const float sig = expf(fminf(fmaxf(lg, a.lmin), a.lmax));
          if (ly >= 0 && ly < rg.th && lx >= 0 && lx < rg.tw)
            static_cast<T*>(a.out1)[o + c] = fromf<T>(sig);
          ext[c] = fromf<T>(round_to<T>(sqrtf(sig)));
        }
      }
    }

    // ---- head conv on [x | sqrt(sigma)] over the slab
    {
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
                !(yy + rg.xrow0 < 0)) {
              const T* xp = xn + ((size_t)(yy + rg.xrow0) * W + xx) * CI;
#pragma unroll
              for (int ci = 0; ci < CI; ++ci)
                fma_row<HC>(acc, tof(xp[ci]), wp + ci * CF);
            }
            const T* ep = ext0 + ((size_t)(ly + dy) * ES + lx + dx) * CO;
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

template <typename T>
cudaError_t prepare() {
  return cudaFuncSetAttribute(slabzero_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<T>());
}

template <typename T>
int grid_size(int ntiles, int* grid) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slabzero_kernel<T>, THREADS, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int full = sms * per_sm;
  *grid = ntiles < full ? ntiles : full;
  return cudaSuccess;
}

template <typename T>
int launch(const Args& a, int grid, cudaStream_t stream) {
  cudaError_t err = prepare<T>();
  if (err != cudaSuccess) return err;
  slabzero_kernel<T><<<grid, THREADS, smem_bytes<T>(), stream>>>(a);
  return cudaGetLastError();
}

bool widths_ok(int CO, int CF) {
  return CO >= 1 && CO <= 3 && CF % HC == 0 && CF <= MAX_BIAS &&
         9 * (CI + CO) * CF <= 9 * NF * NF;
}

}  // namespace

// The persistent grid: one block per slab up to what the SMs hold.
extern "C" int vt_dncnn_slab_grid(int dtype, int N, int H, int rows,
                                  int* grid) {
  if (rows < 1 || H % rows != 0) return cudaErrorInvalidValue;
  const int nt = N * (H / rows);
  if (dtype == VT_F32) return grid_size<float>(nt, grid);
  if (dtype == VT_BF16) return grid_size<__nv_bfloat16>(nt, grid);
  return cudaErrorInvalidValue;
}

// Scratch elements one block needs (see slab_scratch_elems).
extern "C" long long vt_dncnn_slab_scratch_elems(int rows, int W, int CO) {
  return slab_scratch_elems(rows, W, CO);
}

// x (N,H,W,3); w1 HWIO (3,3,3,64), b1 (64); wm (L,3,3,64,64), bm (L,64);
// wl (3,3,64,CO), bl (CO); wh (3,3,3+CO,CF), bh (CF); the slab height
// `rows` divides H.  out0 = head (N,H,W,CF), out1 = sigma (N,H,W,CO), each
// r-row slab computed as an image of its own from x rows [t*rows - 1,
// t*rows + rows - 1).  All tensors of dtype.
extern "C" int vt_dncnn_head_slabzero(
    const void* x, const void* w1, const void* b1, const void* wm,
    const void* bm, const void* wl, const void* bl, const void* wh,
    const void* bh, void* out0, void* out1, void* scratch, int grid, int N,
    int H, int W, int L, int CO, int CF, int rows, int dtype, float slope,
    float lmin, float lmax, void* stream) {
  if (!widths_ok(CO, CF) || rows < 1 || H % rows != 0)
    return cudaErrorInvalidValue;
  Args a{x, w1, b1, wm, bm, wl, bl, wh, bh, out0, out1, scratch,
         N, H, W, L, CO, CF, rows, slope, lmin, lmax};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32) return launch<float>(a, grid, s);
  if (dtype == VT_BF16) return launch<__nv_bfloat16>(a, grid, s);
  return cudaErrorInvalidValue;
}

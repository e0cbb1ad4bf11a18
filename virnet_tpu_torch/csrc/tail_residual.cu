// K4 conv3x3_tail_residual: RNet's tail, a 'same' 3x3 conv C->3 plus
// bias, rounded to the feature dtype, then + x_in in f32, emitted in f32
// (x_in's dtype; under bf16 compute the restored image stays f32).
//
// Replaces: virnet_tpu/ops/pallas_conv.py:conv3x3_tail_residual (:841;
// Pallas body _tail_res_kernel :793).  Unlike the TPU kernel it takes the
// feature map at its padded size (Hp, Wp) and x_in at the image size
// (h, w), and writes only [0, h) x [0, w): one kernel covers both the
// pad-free case (virnet_tpu/models/attresunet.py:189-203) and the padded
// case (:204-215, :228), where the tap at row h reads the padded row
// exactly as the reference's conv-then-slice does.
//
// Bound on an H100 SXM (3.35 TB/s): one read of the (N, Hp, Wp, C)
// features, one of x_in and one write of the output.  At the flagship
// shape, 32x256^2 with C = 96, that is 453 MB in bf16 (0.135 ms) and 856
// MB in f32 (0.255 ms), against 10.9 GFLOP: memory bound in both.
//
// The first version ran one thread per pixel: each warp-wide 8-byte load
// touched 32 pixels 192 B apart (uncoalesced), each of the 9 taps re-read
// its neighbours through L1, every FMA read one scalar weight from shared
// memory, and each pixel's 12-byte output left on its own; it read ~190
// GB/s.  This design:
//  - persistent grid over 16x16 output tiles, each warp owning 2 (bf16,
//    8 warps) or 4 (f32, 4 warps) tile rows;
//  - each tile streams through shared memory in 64-byte channel chunks
//    (32 bf16 or 16 f32 channels of its 18x18 halo), double-buffered:
//    cp.async brings the next chunk, in 16-byte units (8-byte where C * 2
//    B is no multiple of 16) coalesced along each pixel's channels, while
//    the math runs on this one; a tile's last chunk also brings its x_in.
//    Out-of-map pixels and channels past C are zero-filled by the copy
//    itself.  Chunking keeps the buffers at 58 KB whatever C, so three
//    blocks share an SM.  A tile reads 324 pixels for 256 outputs, 1.27x
//    the one-read bytes, from L2: the neighbouring tiles run at the same
//    time, so device memory sees little more than one read;
//  - bf16: tensor cores, mma.sync m16n8k16 with A = 16 pixels x 16
//    channels by ldmatrix from the tile (pixel rows padded to 5 16-byte
//    units, odd: conflict-free), B = 16 channels x 8 outputs of which 3
//    are used, pre-arranged in fragment order in shared memory (one 8-byte
//    load per lane).  A warp loads each of its 4 halo rows once per tap
//    column and feeds both of its output rows from it;
//  - f32: exact f32 on the CUDA cores; two lanes per pixel column split
//    the channels and meet by one shuffle, each lane 4 pixels (one 16-byte
//    weight load feeds 12 FMAs); weights padded to 4 outputs;
//  - epilogue: + bias, one rounding to the feature dtype, staged in shared
//    memory; each warp then adds x_in and writes its tile rows as 16-byte
//    stores (scalar when a row is not 16-byte aligned), coalesced.
#include "common.cuh"
#include "tile_async.cuh"

namespace {

constexpr int CO = 3;
constexpr int TH = 16, TW = 16, HH = TH + 2, HW = TW + 2;
constexpr int CHUNK_B = 64;                  // channel bytes per stage
constexpr int ROWB = odd_units(CHUNK_B) * 16;  // 80 B per pixel row
constexpr int STAGES = 2;

// tile rows per warp: bf16 2 (8 warps), f32 4 (4 warps)
template <typename T> __host__ __device__ constexpr int rows_per_warp() {
  return sizeof(T) == 2 ? 2 : 4;
}
template <typename T> __host__ __device__ constexpr int threads() {
  return TH / rows_per_warp<T>() * 32;
}
constexpr size_t X_BYTES = HH * HW * ROWB;
constexpr size_t XIN_BYTES = TH * TW * CO * 4;
constexpr size_t STAGE_BYTES = X_BYTES + XIN_BYTES;
constexpr int MAX_C = 256;

// what one launch needs to know of C, the same on host and device
struct Geom {
  int Hp, Wp, C;
  int nch;    // 64-byte channel chunks per pixel
  int cb;     // bytes per copy: 16, or 8 when C * esz is no multiple of 16
  int cbytes; // C * esz
  int kb;     // bf16: 16-channel blocks of K, 2 per chunk
  size_t w_bytes, smem;
};

Geom make_geom(int Hp, int Wp, int C, int esz) {
  Geom g;
  g.Hp = Hp; g.Wp = Wp; g.C = C;
  g.cbytes = C * esz;
  g.nch = (g.cbytes + CHUNK_B - 1) / CHUNK_B;
  g.cb = g.cbytes % 16 == 0 ? 16 : 8;
  g.kb = 2 * g.nch;
  g.w_bytes = esz == 2 ? (size_t)9 * g.kb * 32 * 8 : (size_t)9 * C * 16;
  g.smem = STAGES * STAGE_BYTES + g.w_bytes + XIN_BYTES + 16;
  return g;
}

// issue the copies of chunk k of tile t (and, for its last chunk, of the
// tile's x_in) into one stage of the ring
template <int THREADS, typename T>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const T* __restrict__ f,
                                           const float* __restrict__ xin,
                                           const Geom& gm, const TileGrid& tg,
                                           int t, int k) {
  int n, y0, x0;
  tg.at(t, n, y0, x0);
  const int shift = gm.cb == 16 ? 2 : 3;        // copies per pixel: 4 or 8
  const int real = min(CHUNK_B, gm.cbytes - k * CHUNK_B) / gm.cb;
  for (int i = threadIdx.x; i < (HH * HW) << shift; i += THREADS) {
    const int p = i >> shift, u = i & ((1 << shift) - 1);
    const int gy = y0 - 1 + p / HW, gx = x0 - 1 + p % HW;
    const bool in = u < real && gy >= 0 && gy < gm.Hp && gx >= 0 &&
                    gx < gm.Wp;
    const char* src =
        in ? reinterpret_cast<const char*>(
                 f + ((size_t)(n * gm.Hp + gy) * gm.Wp + gx) * gm.C) +
                 k * CHUNK_B + u * gm.cb
           : reinterpret_cast<const char*>(f);
    unsigned char* d = st + p * ROWB + u * gm.cb;
    if (gm.cb == 16)
      cp_async16(d, src, in ? 16 : 0);
    else
      cp_async8(d, src, in ? 8 : 0);
  }
  if (k != gm.nch - 1) return;
  float* sxin = reinterpret_cast<float*>(st + X_BYTES);
  for (int i = threadIdx.x; i < TH * TW * CO; i += THREADS) {
    const int r = i / (TW * CO), e = i % (TW * CO);
    const int oy = y0 + r, ox = x0 + e / CO;
    const bool in = oy < tg.H && ox < tg.W;
    const float* src =
        in ? xin + ((size_t)(n * tg.H + oy) * tg.W + ox) * CO + e % CO : xin;
    cp_async4(sxin + i, src, in ? 4 : 0);
  }
}

// conv results (staged, rounded to T) + x_in (staged) of one tile row ->
// out, as 16-byte stores where the row allows
__device__ __forceinline__ void emit_row(const float* srow, const float* xrow,
                                         float* __restrict__ out,
                                         const TileGrid& tg, int n, int oy,
                                         int x0, int lane) {
  if (oy >= tg.H) return;
  const int nv = min(TW, tg.W - x0);
  const size_t base = ((size_t)(n * tg.H + oy) * tg.W + x0) * CO;
  if (nv == TW && base % 4 == 0) {
    if (lane < TW * CO / 4) {
      const float4 s = reinterpret_cast<const float4*>(srow)[lane];
      const float4 x = reinterpret_cast<const float4*>(xrow)[lane];
      reinterpret_cast<float4*>(out + base)[lane] =
          make_float4(s.x + x.x, s.y + x.y, s.z + x.z, s.w + x.w);
    }
    return;
  }
  for (int i = lane; i < nv * CO; i += 32) out[base + i] = srow[i] + xrow[i];
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

template <typename T>
__global__ void __launch_bounds__(threads<T>())
tail_kernel(const T* __restrict__ feats, const float* __restrict__ xin,
            const T* __restrict__ w, const T* __restrict__ b,
            float* __restrict__ out, Geom gm, TileGrid tg) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int R = rows_per_warp<T>(), THREADS = threads<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  unsigned char* swraw = smem_raw + STAGES * STAGE_BYTES;
  float* sout = reinterpret_cast<float*>(swraw + gm.w_bytes);
  float* sb = sout + TH * TW * CO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = gm.C, KB = gm.kb;

  if constexpr (BF16) {
    // B fragments: entry (tap, kb, lane) holds W[tap][kb*16 + 2t (+1)][g]
    // and the same 8 channels on; zero for outputs >= 3 and channels >= C
    uint2* swb = reinterpret_cast<uint2*>(swraw);
    for (int i = threadIdx.x; i < 9 * KB * 32; i += THREADS) {
      const int l = i & 31, tk = i >> 5, tap = tk / KB;
      const int co = l >> 2, k0 = (tk - tap * KB) * 16 + 2 * (l & 3);
      uint32_t v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = k0 + 8 * h;
        const float lo =
            co < CO && ci < C ? tof(w[(tap * C + ci) * CO + co]) : 0.f;
        const float hi =
            co < CO && ci + 1 < C ? tof(w[(tap * C + ci + 1) * CO + co]) : 0.f;
        v[h] = pack_bf16(lo, hi);  // exact: both are bf16 values
      }
      swb[i] = make_uint2(v[0], v[1]);
    }
  } else {
    float4* sw = reinterpret_cast<float4*>(swraw);
    for (int i = threadIdx.x; i < 9 * C; i += THREADS)
      sw[i] = make_float4(tof(w[i * CO]), tof(w[i * CO + 1]),
                          tof(w[i * CO + 2]), 0.f);
  }
  if (threadIdx.x < CO) sb[threadIdx.x] = tof(b[threadIdx.x]);

  // this block's work: its tiles, chunk by chunk
  const int mine = blockIdx.x < tg.count
                       ? (tg.count - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int items = mine * gm.nch;
  auto load = [&](int s) {
    load_stage<THREADS>(ring + (s % STAGES) * STAGE_BYTES, feats, xin, gm,
                        tg, blockIdx.x + (s / gm.nch) * gridDim.x,
                        s % gm.nch);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < items) load(s);
    cp_async_commit();
  }

  // bf16: acc[(row * 3 + dy) * 4 + i], the mma layout for output row
  // `row` of the warp and tap row dy; f32: acc[row * 3 + co] (lane:
  // column lane % 16, channel-group parity lane / 16)
  float acc[12 * R];
  const int row0 = R * warp;   // the warp's first tile row
#pragma unroll
  for (int i = 0; i < 12 * R; ++i) acc[i] = 0.f;

  for (int s = 0; s < items; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1 is free to refill
    if (s + STAGES - 1 < items) load(s + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (s % STAGES) * STAGE_BYTES;
    const int k = s % gm.nch;

    if constexpr (BF16) {
      // each of the warp's R + 2 halo rows is loaded once per tap column
      // and feeds both output rows
      const uint2* swb = reinterpret_cast<const uint2*>(swraw);
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        uint32_t bw[9][2];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint2 v = swb[(tap * KB + 2 * k + kb) * 32 + lane];
          bw[tap][0] = v.x;
          bw[tap][1] = v.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int hr = 0; hr < R + 2; ++hr) {
            uint32_t a[4];
            ldsm_x4(a, xs + ((row0 + hr) * HW + (lane & 15) + dx) *
                                (ROWB / 2) +
                            (lane >> 4) * 8 + kb * 16);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const int dy = hr - r;
              if (dy >= 0 && dy < 3)
                mma_16816(acc + (r * 3 + dy) * 4, a, bw[dy * 3 + dx]);
            }
          }
      }
    } else {
      // one 16-byte weight load feeds the R pixels of the lane's column
      const float4* sw = reinterpret_cast<const float4*>(swraw);
      const float* xs = reinterpret_cast<const float*>(st);
      const int col = lane & 15, half = lane >> 4;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) {
          const int u = half + 2 * uu, ci0 = k * 16 + 4 * u;
          if (ci0 >= C) continue;
          float4 xr[R + 2];
#pragma unroll
          for (int hr = 0; hr < R + 2; ++hr)
            xr[hr] = *reinterpret_cast<const float4*>(
                xs + ((row0 + hr) * HW + col + dx) * (ROWB / 4) + u * 4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              const float4 wv = sw[(dy * 3 + dx) * C + ci0 + j];
#pragma unroll
              for (int r = 0; r < R; ++r) {
                const float xv = comp(xr[r + dy], j);
                acc[r * 3] = fmaf(xv, wv.x, acc[r * 3]);
                acc[r * 3 + 1] = fmaf(xv, wv.y, acc[r * 3 + 1]);
                acc[r * 3 + 2] = fmaf(xv, wv.z, acc[r * 3 + 2]);
              }
            }
        }
    }
    if (k != gm.nch - 1) continue;

    // the tile's last chunk: + bias, one rounding, + x_in, out
    float* srow = sout + row0 * TW * CO;   // the warp's R rows
    if constexpr (BF16) {
      const int g = lane >> 2, tig = lane & 3;
      if (tig < 2) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int co = 2 * tig + j, i = 2 * rr + j;
              if (co < CO)
                srow[(r * TW + g + 8 * rr) * CO + co] = round_to<T>(
                    acc[r * 12 + i] + acc[r * 12 + 4 + i] +
                    acc[r * 12 + 8 + i] + sb[co]);
            }
      }
    } else {
      const int col = lane & 15;
#pragma unroll
      for (int i = 0; i < R * CO; ++i) {
        const float v = acc[i] + __shfl_xor_sync(0xffffffffu, acc[i], 16);
        if (lane < 16) srow[((i / CO) * TW + col) * CO + i % CO] =
            v + sb[i % CO];
      }
    }
#pragma unroll
    for (int i = 0; i < 12 * R; ++i) acc[i] = 0.f;
    __syncwarp();
    int n, y0, x0;
    tg.at(blockIdx.x + (s / gm.nch) * gridDim.x, n, y0, x0);
    const float* sxin = reinterpret_cast<const float*>(st + X_BYTES);
#pragma unroll
    for (int r = 0; r < R; ++r)
      emit_row(srow + r * TW * CO, sxin + (row0 + r) * TW * CO, out, tg, n,
               y0 + row0 + r, x0, lane);
    __syncwarp();
  }
}

template <typename T>
int launch(int esz, const void* feats, const void* xin, const void* w,
           const void* b, void* out, int N, int Hp, int Wp, int h,
           int w_img, int C, cudaStream_t stream) {
  auto kern = tail_kernel<T>;
  const Geom gm = make_geom(Hp, Wp, C, esz);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gm.smem);
  if (err != cudaSuccess) return err;
  const TileGrid tg(N, h, w_img, TH, TW);
  const int blocks = persistent_blocks(kern, threads<T>(), gm.smem,
                                       tg.count);
  if (blocks <= 0) {
    err = cudaGetLastError();
    return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
  }
  kern<<<blocks, threads<T>(), gm.smem, stream>>>(
      static_cast<const T*>(feats), static_cast<const float*>(xin),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<float*>(out), gm, tg);
  return cudaGetLastError();
}

}  // namespace

// feats (N,Hp,Wp,C) dtype; xin (N,h,w,3) f32; w HWIO (3,3,C,3) dtype;
// b (3,) dtype; out (N,h,w,3) f32.  1 <= h <= Hp, 1 <= w <= Wp,
// C % 4 == 0, C <= 256; feats and out 16-byte aligned, xin 4-byte.
extern "C" int vt_tail_residual(const void* feats, const void* xin,
                                const void* w, const void* b, void* out,
                                int N, int Hp, int Wp, int h, int w_img,
                                int C, int dtype, void* stream) {
  if (C < 4 || C % 4 != 0 || C > MAX_C || N < 1 || h < 1 || w_img < 1 ||
      h > Hp || w_img > Wp)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VT_F32)
    return launch<float>(4, feats, xin, w, b, out, N, Hp, Wp, h, w_img, C,
                         s);
  if (dtype == VT_BF16)
    return launch<__nv_bfloat16>(2, feats, xin, w, b, out, N, Hp, Wp, h,
                                 w_img, C, s);
  return cudaErrorInvalidValue;
}

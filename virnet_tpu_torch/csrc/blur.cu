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
// kernels work on "flat columns" X = x*C + c and never look at C again:
// any C >= 1 is the same code.
//
// Bound on an H100: k*k FMAs per output float against 8 bytes moved per
// output float; at k = 21 that is 110 FLOP/B, operations bound on the f32
// CUDA cores.  Design of K5/K6: a block owns a 16-row x 128-flat-column
// output tile and keeps the sample's taps and the (16+k-1) x (128+(k-1)C)
// input halo tile in shared memory.  A thread owns one flat column and 8
// rows; for each dx it loads the 8+k-1 inputs of its column once into
// registers and slides the k taps of that tap column over them, so one
// shared-memory read feeds ~3.4 FMAs at k = 21.  k is a template
// parameter so that the window lives in registers; the sizes built are
// 3, 5, 7, 15 and 21 (ops/blur.py SUPPORTED_K), any other is refused.  K6 is
// the same device code with the taps flipped and the tile loaded at an
// offset of k-1 with zeros outside the cotangent: the bounds check is in
// the tile load, nothing is padded in device memory.
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

namespace {

constexpr int MAX_SMEM = 227 * 1024;

// ---------------------------------------------------------------------------
// K5 / K6
// ---------------------------------------------------------------------------

constexpr int R = 8;            // output rows per thread
constexpr int TXF = 128;        // flat columns per block (one per thread.x)
constexpr int TYT = 2;          // thread rows per block
constexpr int TH = R * TYT;     // output rows per block
constexpr int THREADS = TXF * TYT;

// out[n, y, X] = sum_{dy,dx} tap[dy, dx] * in'[n, y + dy, X + dx*C], where
// in' is `in` shifted by `off` rows and off*C flat columns and zero outside
// [0, Hin) x [0, WCin), and tap = taps[n] (flipped in both axes if `flip`).
// off = 0: VALID correlation (K5).  off = K-1 with flip: the full
// correlation of the cotangent with the flipped kernel (K6).
template <int K>
__device__ __forceinline__ void
blur_tile(const float* __restrict__ in, const float* __restrict__ taps,
          float* __restrict__ out, int Hin, int WCin, int Hout, int WCout,
          int C, int off, int flip) {
  extern __shared__ float sm[];
  const int SW = TXF + (K - 1) * C;          // shared tile row width
  float* st = sm;                            // K*K taps
  float* s = sm + K * K;                     // (TH+K-1) x SW tile

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, X0 = blockIdx.x * TXF;
  const int tid = threadIdx.y * TXF + threadIdx.x;

  for (int i = tid; i < K * K; i += THREADS)
    st[i] = taps[(size_t)n * K * K + (flip ? K * K - 1 - i : i)];
  const float* inn = in + (size_t)n * Hin * WCin;
  for (int idx = tid; idx < (TH + K - 1) * SW; idx += THREADS) {
    const int r = idx / SW, j = idx - r * SW;
    const int gy = y0 + r - off, gx = X0 + j - off * C;
    s[idx] = (gy >= 0 && gy < Hin && gx >= 0 && gx < WCin)
                 ? inn[(size_t)gy * WCin + gx] : 0.f;
  }
  __syncthreads();

  const int X = X0 + threadIdx.x;
  if (X >= WCout) return;
  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  const float* sp = s + (threadIdx.y * R) * SW + threadIdx.x;
#pragma unroll 1
  for (int dx = 0; dx < K; ++dx) {
    float v[R + K - 1];
#pragma unroll
    for (int r = 0; r < R + K - 1; ++r) v[r] = sp[r * SW + dx * C];
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const float t = st[dy * K + dx];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j] = fmaf(t, v[j + dy], acc[j]);
    }
  }
  float* on = out + (size_t)n * Hout * WCout;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int y = y0 + threadIdx.y * R + j;
    if (y < Hout) on[(size_t)y * WCout + X] = acc[j];
  }
}

// one entry per function, so that a profile tells K5 from K6
template <int K>
__global__ void __launch_bounds__(THREADS)
blur_valid_kernel(const float* __restrict__ xp,
                  const float* __restrict__ taps, float* __restrict__ out,
                  int Hp, int WCp, int H, int WC, int C) {
  blur_tile<K>(xp, taps, out, Hp, WCp, H, WC, C, 0, 0);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
blur_dx_kernel(const float* __restrict__ g, const float* __restrict__ taps,
               float* __restrict__ dxp, int H, int WC, int Hp, int WCp,
               int C) {
  blur_tile<K>(g, taps, dxp, H, WC, Hp, WCp, C, K - 1, 1);
}

// full = false: K5, `in` is the padded input; full = true: K6, `in` is the
// cotangent and `out` the padded-size gradient
template <int K>
int launch_blur(bool full, const float* in, const float* taps, float* out,
                int N, int Hin, int WCin, int Hout, int WCout, int C,
                cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (K * K + (size_t)(TH + K - 1) * (TXF + (K - 1) * C));
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  void (*kernel)(const float*, const float*, float*, int, int, int, int,
                 int) = blur_valid_kernel<K>;
  if (full) kernel = blur_dx_kernel<K>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((WCout + TXF - 1) / TXF, (Hout + TH - 1) / TH, N);
  dim3 block(TXF, TYT);
  kernel<<<grid, block, smem, stream>>>(in, taps, out, Hin, WCin, Hout, WCout,
                                        C);
  return cudaGetLastError();
}

int dispatch_blur(int k, bool full, const float* in, const float* taps,
                  float* out, int N, int Hin, int WCin, int Hout, int WCout,
                  int C, cudaStream_t stream) {
#define VT_BLUR_CASE(K)                                                      \
  case K:                                                                    \
    return launch_blur<K>(full, in, taps, out, N, Hin, WCin, Hout, WCout, C, \
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
                       static_cast<float*>(out), N, H + k - 1,
                       (W + k - 1) * C, H, W * C, C,
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
                       static_cast<float*>(dxp), N, H, W * C, H + k - 1,
                       (W + k - 1) * C, C,
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

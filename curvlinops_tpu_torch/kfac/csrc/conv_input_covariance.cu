// KFAC input covariance of a 2-D convolution with implicit im2col, for Hopper.
//
// Replaces the Pallas TPU kernel `conv_input_covariance` of
// curvlinops_tpu/kfac/pallas_kernels.py. It computes
//
//     cov[i, j] = sum_r P[r, i] * P[r, j],   r over B * Ho * Wo output positions,
//
// where P[r, f] is the im2col patch of an NHWC input: feature f maps to the
// kernel offset (ki, kj) and channel c in (KH, KW, C) channel-minor order and
// reads pixel (ho*sh - ph + ki, wo*sw - pw + kj), zero outside the image. With
// a bias pad p, the virtual feature d-1 equals p on every row, so the same loop
// yields p * colsum in the last row and column and p^2 * B * S in the corner.
// The [B*S, d] patch matrix is never written to device memory.
//
// What bounds it on this card: arithmetic. About B*S*d^2/2 FMAs (with the
// symmetry) against B*H*W*C input reads; a ResNet-18 layer1 conv at B = 512
// is 5.4 G FMAs for 8 MB of input, far above the H100's ratio of FMAs to bytes.
// This first version runs on the fp32 CUDA cores (67 TFLOP/s peak, not the
// tensor cores) and is bound by shared-memory bandwidth: each thread reads two
// float4 from shared memory per 16 FMAs.
//
// Design (the TPU kernel's sequential grid with a VMEM-resident [d, d]
// accumulator does not carry over: CTAs run in parallel and in no order):
//   * one CTA per 64x64 tile of the upper triangle of cov (tile row <= tile
//     column); the lower triangle is mirrored at the end;
//   * the B*Ho*Wo reduction is split over blockIdx.z into a [splits, d, d] fp32
//     workspace, so that layers with few tiles (d = 576 has 45) still fill the
//     132 SMs;
//   * each CTA gathers its two 16-row patch slabs straight from x into shared
//     memory and accumulates a 4x4 sub-tile per thread in fp32 registers;
//   * a second kernel sums the splits in a fixed order (no atomics, so the
//     result is deterministic), mirrors the lower triangle and casts to the
//     output type.
// Tensor cores (mma/wgmma in TF32 or bf16) and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;     // output tile edge
constexpr int BK = 16;       // rows of the patch matrix per shared-memory slab
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

struct Geometry {
  int B, H, W, C, KW, SH, SW, PH, PW, Ho, Wo;
  int d_in;       // KH * KW * C
  int d;          // d_in (+1 with a bias pad)
  int has_bias;
  float bias_pad;
  int64_t R;      // B * Ho * Wo
  int64_t rows_per_split;
  int tiles;      // ceil(d / TILE)
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// A feature's source: kind 0 = input pixel (ki, kj, c), 1 = bias pad, 2 = zero.
struct Feature {
  int kind, ki, kj, c;
};

__device__ __forceinline__ Feature decode(int f, const Geometry& g) {
  Feature out{2, 0, 0, 0};
  if (f < g.d_in) {
    const int kk = f / g.C;
    out.kind = 0;
    out.c = f - kk * g.C;
    out.ki = kk / g.KW;
    out.kj = kk - out.ki * g.KW;
  } else if (g.has_bias && f == g.d_in) {
    out.kind = 1;
  }
  return out;
}

template <typename T>
__device__ __forceinline__ float patch(const T* __restrict__ x, const Geometry& g,
                                       const Feature& ft, int b, int hbase, int wbase) {
  if (ft.kind == 1) return g.bias_pad;
  if (ft.kind == 2) return 0.0f;
  const int h = hbase + ft.ki;
  const int w = wbase + ft.kj;
  if (h < 0 || h >= g.H || w < 0 || w >= g.W) return 0.0f;
  return to_float(x[((static_cast<int64_t>(b) * g.H + h) * g.W + w) * g.C + ft.c]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cov_tiles_kernel(const T* __restrict__ x, float* __restrict__ ws, const Geometry g) {
  // blockIdx.x enumerates the upper-triangle tiles row by row
  int t = blockIdx.x, bi = 0;
  while (t >= g.tiles - bi) {
    t -= g.tiles - bi;
    ++bi;
  }
  const int bj = bi + t;
  const int i0 = bi * TILE, j0 = bj * TILE;

  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * g.rows_per_split;
  const int64_t r_end = min(r_begin + g.rows_per_split, g.R);

  __shared__ __align__(16) float As[BK][TILE];
  __shared__ __align__(16) float Bs[BK][TILE];

  const int tid = threadIdx.x;
  const int lc = tid & (TILE - 1);  // slab column this thread loads
  const int lr = tid >> 6;          // first slab row this thread loads (0..3)
  const Feature fa = decode(i0 + lc, g);
  const Feature fb = decode(j0 + lc, g);
  const int tx = tid & 15, ty = tid >> 4;
  const int S = g.Ho * g.Wo;

  float acc[4][4] = {};

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BK) {
#pragma unroll
    for (int q = 0; q < BK / 4; ++q) {
      const int kr = lr + 4 * q;
      const int64_t r = r0 + kr;
      float va = 0.0f, vb = 0.0f;
      if (r < r_end) {
        const int b = static_cast<int>(r / S);
        const int s = static_cast<int>(r - static_cast<int64_t>(b) * S);
        const int ho = s / g.Wo;
        const int wo = s - ho * g.Wo;
        const int hbase = ho * g.SH - g.PH;
        const int wbase = wo * g.SW - g.PW;
        va = patch(x, g, fa, b, hbase, wbase);
        vb = patch(x, g, fb, b, hbase, wbase);
      }
      As[kr][lc] = va;
      Bs[kr][lc] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

  float* out = ws + static_cast<int64_t>(blockIdx.z) * g.d * g.d;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + ty * 4 + ii;
    if (i >= g.d) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + tx * 4 + jj;
      if (j < g.d) out[static_cast<int64_t>(i) * g.d + j] = acc[ii][jj];
    }
  }
}

// Sum the splits in order, mirror the lower triangle, cast to the output type.
template <typename TO>
__global__ void reduce_mirror_kernel(const float* __restrict__ ws, TO* __restrict__ out,
                                     int d, int splits) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t dd = static_cast<int64_t>(d) * d;
  if (idx >= dd) return;
  int i = static_cast<int>(idx / d);
  int j = static_cast<int>(idx - static_cast<int64_t>(i) * d);
  if (i / TILE > j / TILE) {  // below the computed tiles: read the transpose
    const int tmp = i;
    i = j;
    j = tmp;
  }
  const int64_t src = static_cast<int64_t>(i) * d + j;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += ws[k * dd + src];
  store(out + idx, s);
}

template <typename T>
int launch(const void* x, void* ws, void* out, const Geometry& g, int splits,
           cudaStream_t stream) {
  const unsigned n_tiles = static_cast<unsigned>(g.tiles) * (g.tiles + 1) / 2;
  cov_tiles_kernel<T><<<dim3(n_tiles, 1, splits), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t dd = static_cast<int64_t>(g.d) * g.d;
  const unsigned blocks = static_cast<unsigned>((dd + 255) / 256);
  reduce_mirror_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), g.d, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous NHWC input; ws: [splits, d, d] fp32 scratch; out: [d, d] in x's
// type. Returns the CUDA error code of the launches (0 on success).
extern "C" int conv_input_covariance(const void* x, void* ws, void* out, int is_bf16,
                                     int B, int H, int W, int C, int KH, int KW, int SH,
                                     int SW, int PH, int PW, int Ho, int Wo, int has_bias,
                                     float bias_pad, int splits, int64_t rows_per_split,
                                     void* stream) {
  Geometry g;
  g.B = B; g.H = H; g.W = W; g.C = C; g.KW = KW; g.SH = SH; g.SW = SW;
  g.PH = PH; g.PW = PW; g.Ho = Ho; g.Wo = Wo;
  g.d_in = KH * KW * C;
  g.has_bias = has_bias;
  g.d = g.d_in + (has_bias ? 1 : 0);
  g.bias_pad = bias_pad;
  g.R = static_cast<int64_t>(B) * Ho * Wo;
  g.rows_per_split = rows_per_split;
  g.tiles = (g.d + TILE - 1) / TILE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, ws, out, g, splits, s)
                 : launch<float>(x, ws, out, g, splits, s);
}

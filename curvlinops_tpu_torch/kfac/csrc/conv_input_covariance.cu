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
// What bounds it on this card: arithmetic. About B*S*d^2 flops (with the
// symmetry) against B*H*W*C input reads; a ResNet-18 layer1 conv at B = 512
// is 11 GFLOP for 8 MB of input, far above the H100's ratio of flops to
// bytes. So the products run on the TF32 tensor cores with the 3xTF32 split
// of ../../csrc/tf32_mma.cuh (mma.sync m16n8k8; bfloat16 inputs are exact in
// TF32 and skip their lo products), and each element is split once per CTA.
//
// Design (the TPU kernel's sequential grid with a VMEM-resident [d, d]
// accumulator does not carry over: CTAs run in parallel and in no order):
//   * one CTA of 4 warps per 64x64 tile of the upper triangle of cov (tile
//     row <= tile column); each warp owns a 32x32 quarter. The lower
//     triangle is mirrored at the end. Three CTAs fit an SM (shared memory).
//     (128x128 tiles of 8 warps, half the gather and split per product, ran
//     slower on the card: one CTA per SM, and more work past d);
//   * the B*Ho*Wo reduction is split over blockIdx.z into a [splits, d, d] fp32
//     workspace, so that layers with few tiles (d = 576 has 45) still fill the
//     132 SMs: the wrapper takes as many splits as fit one wave of three CTAs
//     per SM;
//   * the CTA walks its rows in slabs of 32. Since C % 8 == 0, a 16-byte chunk
//     of a patch row (4 float32 or 8 bfloat16 features) never straddles a
//     kernel offset: it is one contiguous run of NHWC input, or zero in the
//     padding. So each thread gathers its chunks of the next slab (the
//     tile's i columns and, off the diagonal, its j columns of P) with
//     16-byte loads into registers while the current slab is multiplied;
//     rows are decoded with multiply-shift divisions (no integer divide);
//   * the thread then splits each gathered element once into hi and lo
//     words (the bias-pad column and the features past d_in are written
//     here, not gathered) in the other of two shared stages: one
//     __syncthreads per slab. Every warp loads its fragments from there: A
//     is the slab read transposed (A[m][k] = slab[k][m]), B the slab as it
//     is. A stage row is 64 words plus 8, so both fragment loads (row t,
//     column g, for lane 4 g + t) hit 32 different banks. (hi and lo side
//     by side, one 8-byte load for both, cost more: the tensor core takes a
//     fragment's hi words in consecutive registers, and the compiler moved
//     them there one by one);
//   * the tensor core's float32 sums truncate, and a CTA's rows run to
//     thousands (hundreds of k-steps). So each slab's 4 k-steps are one
//     short tensor-core sum per output fragment, added to a float32
//     accumulator with a rounded add;
//   * a second kernel sums the splits in a fixed order (no atomics, so the
//     result is deterministic), mirrors the lower triangle through shared
//     memory (coalesced reads and writes) and casts to the output type.

#include "../../csrc/tf32_mma.cuh"

namespace {

constexpr int TILE = 64;     // output tile edge
constexpr int BK = 32;       // rows of the patch matrix per slab: one short tensor-core sum
constexpr int WM = 32, WN = 32;  // a warp's part of the tile: WM rows, WN columns
constexpr int MI = WM / 16, NI = WN / 8, NF = MI * NI;  // its m16n8 fragments
constexpr int THREADS = 32 * (TILE / WM) * (TILE / WN);

constexpr int LW = TILE + 8; // row stride (words) of the split tiles: 8 banks per row

// n / d for 0 <= n < 2^31 by a multiply and a shift: the divisor's
// (magic, shift) from fast_divisor on the host (Granlund and Montgomery,
// 1994: magic = ceil(2^(31 + l) / d), l = ceil(log2 d), shift = 31 + l).
struct FastDiv {
  uint32_t magic, shift;
};

inline FastDiv fast_divisor(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t p = 1ull << (31 + l);
  return {static_cast<uint32_t>((p + d - 1) / d), 31 + l};
}

__device__ __forceinline__ int fast_div(int n, FastDiv d) {
  return static_cast<int>((static_cast<uint64_t>(n) * d.magic) >> d.shift);
}

struct Geometry {
  int B, H, W, C, KW, SH, SW, PH, PW, Ho, Wo;
  int d_in;       // KH * KW * C
  int d;          // d_in (+1 with a bias pad)
  int has_bias;
  float bias_pad;
  int R;          // B * Ho * Wo (< 2^31)
  int rows_per_split;
  int tiles;      // ceil(d / TILE)
  FastDiv by_S, by_Wo, by_C, by_KW;  // S = Ho * Wo
};

// Where a thread's 16-byte chunk of patch features comes from: kernel offset
// (ki, kj) and first channel c, or nothing (features from d_in on).
struct Chunk {
  int ki, kj, c;
  bool input;
};

__device__ __forceinline__ Chunk decode(int f0, const Geometry& g) {
  Chunk out{0, 0, 0, f0 < g.d_in};
  if (out.input) {
    const int kk = fast_div(f0, g.by_C);
    out.c = f0 - kk * g.C;
    out.ki = fast_div(kk, g.by_KW);
    out.kj = kk - out.ki * g.KW;
  }
  return out;
}

template <typename T> constexpr size_t tiles_smem() {
  // hi (and, for float32, lo) words: [2 stages][2 slabs][BK][LW] each
  return sizeof(uint32_t) * (sizeof(T) == 2 ? 1 : 2) * 2 * 2 * BK * LW;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cov_tiles_kernel(const T* __restrict__ x, float* __restrict__ ws, const Geometry g) {
  constexpr bool EXACT = sizeof(T) == 2;  // bfloat16 inputs are exact in TF32
  constexpr int EPC = 16 / (int)sizeof(T), CPR = TILE / EPC, RS = THREADS / CPR, NR = BK / RS;
  // blockIdx.x enumerates the upper-triangle tiles row by row
  int tile = blockIdx.x, bi = 0;
  while (tile >= g.tiles - bi) {
    tile -= g.tiles - bi;
    ++bi;
  }
  const int bj = bi + tile;
  const int i0 = bi * TILE, j0 = bj * TILE;
  const bool diag = bi == bj;  // a diagonal tile multiplies one slab by itself

  const int r_begin = blockIdx.z * g.rows_per_split;
  const int r_end = min(r_begin + g.rows_per_split, g.R);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* hi = reinterpret_cast<uint32_t*>(smem_raw);  // [2 stages][2 slabs][BK][LW]
  uint32_t* lo = hi + 2 * 2 * BK * LW;                   // the same, float32 only

  // a thread gathers one chunk column of both slabs, rows rr0 + RS i
  const int cc = threadIdx.x % CPR, rr0 = threadIdx.x / CPR;
  const Chunk src[2] = {decode(i0 + cc * EPC, g), decode(j0 + cc * EPC, g)};
  const int f0[2] = {i0 + cc * EPC, j0 + cc * EPC};

  // the gather into registers: 16-byte loads, zero in the padding and past
  // the split; the bias-pad column and the features past d_in are written
  // at the split
  uint4 raw[2][NR];
  auto gather = [&](int r0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int r = r0 + rr0 + i * RS;
      const int b = fast_div(r, g.by_S), s = r - b * g.Ho * g.Wo;
      const int ho = fast_div(s, g.by_Wo);
      const int hbase = ho * g.SH - g.PH, wbase = (s - ho * g.Wo) * g.SW - g.PW;
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int h = hbase + src[sl].ki, w = wbase + src[sl].kj;
        const bool in = src[sl].input && r < r_end && h >= 0 && h < g.H && w >= 0 && w < g.W &&
                        (sl == 0 || !diag);
        raw[sl][i] = in ? *reinterpret_cast<const uint4*>(
                              x + (((b * g.H + h) * g.W + w) * g.C + src[sl].c))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  // the split: every gathered element once, into the stage's hi/lo tiles
  auto split_slabs = [&](int r0, int st) {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (sl == 1 && diag) break;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int rr = rr0 + i * RS;
        float v[EPC];
        if (src[sl].input) {
          chunk_to_floats<T, EPC>(v, raw[sl][i]);
        } else {  // the bias-pad column on the rows of the split, zero past d
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            v[e] = g.has_bias && r0 + rr < r_end && f0[sl] + e == g.d_in ? g.bias_pad : 0.f;
        }
        const int at = ((st * 2 + sl) * BK + rr) * LW + cc * EPC;
        split_store<EXACT, EPC>(hi + at, lo + at, v);
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int wm = warp / (TILE / WN) * WM, wn = warp % (TILE / WN) * WN;  // the warp's part

  gather(r_begin);
  split_slabs(r_begin, 0);
  __syncthreads();
  float acc[NF][4] = {};  // fragment NI mi + ni: rows wm + 16 mi, columns wn + 8 ni
  int st = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += BK, st ^= 1) {
    const bool more = r0 + BK < r_end;
    if (more) gather(r0 + BK);  // in flight during the products below
    const int a_at = st * 2 * BK * LW, b_at = a_at + (diag ? 0 : BK * LW);
    float part[NF][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      FragA fa[MI];
      FragB fb[NI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {  // A[m][k] = slab[k][m]: rows m, columns k
        const int at = a_at + (k0 + t) * LW + wm + 16 * mi + gq;
        const int off[4] = {0, 8, 4 * LW, 4 * LW + 8};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fa[mi].hi[e] = hi[at + off[e]];
          fa[mi].lo[e] = EXACT ? 0u : lo[at + off[e]];
        }
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {  // B[k][n] = slab[k][n]
        const int at = b_at + (k0 + t) * LW + wn + 8 * ni + gq;
        fb[ni].hi[0] = hi[at];
        fb[ni].hi[1] = hi[at + 4 * LW];
        fb[ni].lo[0] = EXACT ? 0u : lo[at];
        fb[ni].lo[1] = EXACT ? 0u : lo[at + 4 * LW];
      }
      FragA a[NF];
      FragB b[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        a[f] = fa[f / NI];
        b[f] = fb[f % NI];
      }
      mma3<EXACT, EXACT, NF>(part, a, b);
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) add_to(acc[f], part[f]);
    // the next slab into the other stage, whose readers finished before the
    // last barrier
    if (more) split_slabs(r0 + BK, st ^ 1);
    __syncthreads();
  }

  float* out = ws + static_cast<int64_t>(blockIdx.z) * g.d * g.d;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wm + 16 * (f / NI) + gq + 8 * (e / 2);
      const int j = j0 + wn + 8 * (f % NI) + 2 * t + e % 2;
      if (i < g.d && j < g.d) out[static_cast<int64_t>(i) * g.d + j] = acc[f][e];
    }
}

// Sum the splits in order, mirror the lower triangle, cast to the output type.
// One CTA of 32 x 8 threads per 32x32 block of out (inside one TILE block,
// so it is above the computed tiles or below them as a whole). A block below
// reads its mirror image row by row, as it lies in ws, and writes it
// transposed through shared memory: both sides coalesced.
constexpr int RB = 32;  // edge of a reduce block

template <typename TO>
__global__ void __launch_bounds__(RB * 8)
reduce_mirror_kernel(const float* __restrict__ ws, TO* __restrict__ out, int d, int splits) {
  __shared__ float block[RB][RB + 1];
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int i0 = blockIdx.y * RB, j0 = blockIdx.x * RB;
  const bool below = i0 / TILE > j0 / TILE;
  const int r0 = below ? j0 : i0, c0 = below ? i0 : j0;  // the block read from ws
  for (int r = threadIdx.y; r < RB; r += 8) {
    const int row = r0 + r, col = c0 + threadIdx.x;
    float s = 0.0f;
    if (row < d && col < d)
      for (int k = 0; k < splits; ++k) s += ws[k * dd + static_cast<int64_t>(row) * d + col];
    block[r][threadIdx.x] = s;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < RB; r += 8) {
    const int i = i0 + r, j = j0 + threadIdx.x;
    if (i < d && j < d)
      out[static_cast<int64_t>(i) * d + j] =
          from_f<TO>(below ? block[threadIdx.x][r] : block[r][threadIdx.x]);
  }
}

template <typename T>
int launch(const void* x, void* ws, void* out, const Geometry& g, int splits,
           cudaStream_t stream) {
  const unsigned n_tiles = static_cast<unsigned>(g.tiles) * (g.tiles + 1) / 2;
  constexpr size_t smem = tiles_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(cov_tiles_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cov_tiles_kernel<T><<<dim3(n_tiles, 1, splits), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws), g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((g.d + RB - 1) / RB);
  reduce_mirror_kernel<T><<<dim3(blocks, blocks), dim3(RB, 8), 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), g.d, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous NHWC input, 16-byte aligned, C % 8 == 0, fewer than 2^31
// elements (so B * Ho * Wo < 2^31);
// ws: [splits, d, d] fp32 scratch; out: [d, d] in x's type; rows_per_split a
// multiple of 32.
// Returns the CUDA error code of the launches (0 on success).
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
  g.R = B * Ho * Wo;
  g.rows_per_split = static_cast<int>(rows_per_split);
  g.tiles = (g.d + TILE - 1) / TILE;
  g.by_S = fast_divisor(Ho * Wo);
  g.by_Wo = fast_divisor(Wo);
  g.by_C = fast_divisor(C);
  g.by_KW = fast_divisor(KW);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, ws, out, g, splits, s)
                 : launch<float>(x, ws, out, g, splits, s);
}

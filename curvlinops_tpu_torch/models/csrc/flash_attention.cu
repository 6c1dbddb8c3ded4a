// Causal flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of JAX's stock flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py, JAX 0.9.0), which
// curvlinops_tpu/models/gpt.py:65 calls for attention_impl="flash":
//
//   flash_fwd_kernel     <- _flash_attention_impl    (pallas_call at :758)
//   flash_bwd_dkv_kernel <- _flash_attention_bwd_dkv (pallas_call at :1121)
//   flash_bwd_dq_kernel  <- _flash_attention_bwd_dq  (pallas_call at :1456)
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B*H, T, HD] row-major (the JAX
// layout [B, H, T, hd], contiguous), float32 or bfloat16; the logsumexp
// lse = log sum_j exp(sm_scale * q_i . k_j) and di = sum(o * dO, -1) are
// [B*H, T] float32. All arithmetic is float32. Any T: the ragged tile is
// zero-filled on load and masked (the TPU kernel's T % 128 == 0 block
// limit does not carry over). HD is 16, 32, 64 or 128.
//
// What bounds them: operations. The causal forward does 2*B*H*T^2*HD
// flops (QK^T and PV over the lower triangle) on 4*B*H*T*HD elements; at
// GPT-2 small (B=4, H=12, T=1024, HD=64) that is 6.4 GFLOP against 50 MB,
// about 128 flops per byte. The backward does 2.5x the forward's products
// (3.5x as the two kernels below split them). So every [T, T] score tile
// stays out of device memory and each loaded tile is reused across a whole
// 64-row block. Common to all three kernels:
//
//   - grid (B*H, 64-row tiles): blockIdx.x is the (b, h) slice, blockIdx.y
//     the tile. Causal tiles above the diagonal are skipped, and the
//     longest rows of work are launched first (blockIdx.y 0 gets the last
//     query tile in the forward and dq kernels, the first key tile in dkv)
//     to shorten the tail;
//   - no atomics: dkv owns a key tile and loops over query tiles, dq owns
//     a query tile and loops over key tiles, so every output element is
//     summed by one thread in a fixed order (the results are deterministic).
//
// Forward, on the fp32 CUDA cores (H100: 67 TFLOP/s): one CTA of 256
// threads per tile; each thread computes 4x4 of the 64x64 score tile from
// shared-memory tiles of row stride HD + 1 floats (rows ty + 16*i, columns
// tx + 16*j, ty = tid / 16, tx = tid % 16); row reductions stay inside a
// half-warp; P goes through shared memory once for P V. Its loads are not
// pipelined.
//
// Backward (dkv, dq), on the tensor cores. At 3.5 T^2 HD flops per head a
// float32-accurate product is what bounds them, so:
//
//   - mma.sync m16n8k8 TF32 with float32 accumulators. TF32 keeps 10
//     mantissa bits, too few for the 1e-4 float32 gate, so each float32
//     operand is split a = hi + lo (hi rounded to TF32 in two integer
//     instructions; the tensor core reads lo's top 10 mantissa bits) and
//     a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi ("3xTF32": 495 / 3
//     = 165 TFLOP/s of float32-accurate work against the CUDA cores' 67).
//     bfloat16 inputs are exact in TF32 (8 mantissa bits), so their lo
//     products are skipped; P and dS are split on both routes. wgmma
//     (warpgroup, 64-row) products are later work: mma.sync keeps the
//     fragment code per warp;
//   - the tensor core's float32 sums truncate; over the T / 8 steps of a
//     long sum that drifts by 1e-5 relative. So every sum the tensor core
//     takes is short: the first products (S, dP) per 8-column k-step, the
//     second (P^T dO, dS^T q, dS k) per streamed tile, each then added to
//     a float32 accumulator with a rounded add. The float32 results then
//     agree with the plain version to about 1e-6 (chip_smoke.py);
//   - 4 warps (128 threads) per CTA, each owning 16 rows of the CTA's
//     64-row tile (keys in dkv, queries in dq) and the full width of the
//     streamed tile (32 queries in dkv, 16 at HD = 128 to fit the dk and dv
//     accumulators in registers; 32 keys in dq). The first products'
//     accumulators are reused in registers as the A operand of the second
//     products: an accumulator's columns 2t, 2t + 1 are taken as the
//     contraction index t, t + 4 and the B operand's rows are read in the
//     same permuted order, so P and dS never touch shared memory. The
//     independent mma chains of a step are issued interleaved;
//   - the streamed tiles (q, dO, lse, di in dkv; k, v in dq) go through a
//     two-stage ring of 16-byte cp.async loads: the next tile lands while
//     the current one is computed, one __syncthreads per tile. Shared
//     tiles keep the input dtype with a row stride of HD plus one 16-byte
//     chunk, 4 banks per row, so the fragment loads (row g, column t; or
//     row 2t, column g, for lane 4 g + t) hit 32 different banks;
//   - 64-row tiles owned: at B=4, H=12, T=1024 that is 768 CTAs over 132
//     SMs. Streamed tiles of 32 rows keep a float32 CTA at HD = 64 to 70 KB
//     of shared memory; dkv's registers (255) allow two CTAs per SM, dq's
//     (128) three. The masks are evaluated only on tiles that cross the
//     diagonal or the end of the sequence.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 64;    // query rows per tile
constexpr int BN = 64;    // key rows per tile (BM == BN: a tile is on the diagonal or not)
constexpr int NT = 256;   // threads per forward CTA
constexpr int LDP = BN + 16;  // row stride of the probability tiles (no bank conflicts between half-warps)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + 64) of one [T, HD] slice into shared memory as float,
// row stride HD + 1, zero past T.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int seq) {
  for (int idx = threadIdx.x; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD, g = row0 + r;
    dst[r * (HD + 1) + d] = g < seq ? to_f(src[(size_t)g * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------------------
// forward: o = softmax(sm_scale * q k^T, causal) v and the logsumexp
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int seq, int causal, float scale_log2) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BM][LD]
  float* Ks = Qs + BM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;    // [BN][LD]
  float* Ps = Vs + BN * LD;    // [BM][LDP]

  const int n_tiles = (seq + BM - 1) / BM;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest rows first
  const int q0 = qt * BM;
  const size_t base = (size_t)blockIdx.x * seq * HD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<T, HD>(Qs, q + base, q0, seq);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(Ks, k + base, k0, seq);
    load_tile<T, HD>(Vs, v + base, k0, seq);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // online softmax in base 2; key 0 is visible to every row, so after the
    // first tile every row maximum is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool masked = col >= seq || (causal && col > row);
        s[i][j] = masked ? -CUDART_INF_F : s[i][j] * scale_log2;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4], w[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) w[cc] = Vs[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[i][cc] = fmaf(p[i], w[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[base + (size_t)row * HD + tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[(size_t)blockIdx.x * seq + row] = (m[i] + log2f(l[i])) * LN2;
  }
}

// ------------------------------------------------------------------------
// backward: tensor-core building blocks
// ------------------------------------------------------------------------
constexpr int BWD_NT = 128;  // threads per backward CTA: 4 warps of 16 rows each

// Row stride (elements) of a shared-memory tile: HD plus one 16-byte chunk.
// Rows stay 16-byte aligned for cp.async, and a row is 4 banks (mod 32) past
// the one before, so the fragment loads below (lane (g, t) reads row g,
// column t, or row 2t, column g) hit 32 different banks.
template <typename T, int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + 16 / (int)sizeof(T);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of one [seq, HD] slice into a shared tile of row
// stride tile_ld, in 16-byte cp.async chunks; rows past seq are zero-filled
// (source size 0).
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src, int row0,
                                                int seq) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = HD / EPC, LD = tile_ld<T, HD>();
  constexpr int RS = BWD_NT / CPR;  // rows per pass of the CTA; a thread keeps its column
  const int r = threadIdx.x / CPR, col = (threadIdx.x % CPR) * EPC;
  const T* from = src + (size_t)(row0 + r) * HD + col;
#pragma unroll
  for (int i = 0; i < (ROWS + RS - 1) / RS; ++i) {
    if (ROWS % RS == 0 || r + i * RS < ROWS) {
      const bool in = row0 + r + i * RS < seq;
      cp_async16(dst + (r + i * RS) * LD + col, in ? from + (size_t)i * RS * HD : src, in ? 16 : 0);
    }
  }
}

// 3xTF32: x = hi + lo with hi = tf32(x) (round to nearest) and lo = x - hi,
// of which the tensor core reads the TF32 bits (it ignores the low 13), and
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi keeps float32 accuracy on the TF32
// tensor cores. An EXACT operand (a bfloat16 value: 8 mantissa bits, TF32
// has 10) is its own hi and has lo = 0, so its lo product is skipped.
struct FragA { uint32_t hi[4], lo[4]; };  // m16n8k8 A: 16 rows x 8 (k)
struct FragB { uint32_t hi[2], lo[2]; };  // m16n8k8 B: 8 (k) x 8 columns

// Round to TF32, to nearest with ties away from zero, in two integer
// instructions: cvt.rna.tf32.f32 rounds the same way but sm_90 runs it as a
// longer sequence that also handles NaN and infinity (the operands here are
// finite).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = to_tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// d += a b on the tensor cores, TF32 inputs, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[i] += a[i] b[i] for i < N to float32 accuracy, the small products
// first, summed in the tensor core. The N chains are independent and are
// issued product by product across them, so that each mma's latency hides
// behind the others' (a warp issues in order). The tensor core's float32
// sums truncate instead of rounding, so a long chain of them drifts (1e-5
// relative over T = 1024): the callers keep the chains short and add each
// short sum into their accumulators with a rounded float32 add (add_to).
template <bool A_EXACT, bool B_EXACT, int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const FragA (&a)[N], const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (!A_EXACT) mma_tf32(d[i], a[i].lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (!B_EXACT) mma_tf32(d[i], a[i].hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(d[i], a[i].hi, b[i].hi);
}

__device__ __forceinline__ void add_to(float (&d)[4], const float (&p)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// The first products of one k-step: d[j] += a b[j] for the N column blocks
// j, each as one short sum (three products in the tensor core, then add_to).
template <bool EXACT, int N>
__device__ __forceinline__ void mma3_add_row(float (&d)[N][4], const FragA& a,
                                             const FragB (&b)[N]) {
  FragA as[N];
  float p[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    as[j] = a;
#pragma unroll
    for (int i = 0; i < 4; ++i) p[j][i] = 0.f;
  }
  mma3<EXACT, EXACT, N>(p, as, b);
#pragma unroll
  for (int j = 0; j < N; ++j) add_to(d[j], p[j]);
}

// Fragments from row-major shared tiles of row stride ld; lane = 4 g + t.
// A: rows r0 + g (+ 8), contraction columns c0 + t (+ 4).
template <bool EXACT, typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* s, int ld, int r0, int c0, int g, int t) {
  const T* p = s + (r0 + g) * ld + c0 + t;
  split<EXACT>(to_f(p[0]), f.hi[0], f.lo[0]);
  split<EXACT>(to_f(p[8 * ld]), f.hi[1], f.lo[1]);
  split<EXACT>(to_f(p[4]), f.hi[2], f.lo[2]);
  split<EXACT>(to_f(p[8 * ld + 4]), f.hi[3], f.lo[3]);
}

// B = X^T: B column n is tile row r0 + n (n = g), contraction columns c0 + t (+ 4).
template <bool EXACT, typename T>
__device__ __forceinline__ void load_bt(FragB& f, const T* s, int ld, int r0, int c0, int g,
                                        int t) {
  const T* p = s + (r0 + g) * ld + c0 + t;
  split<EXACT>(to_f(p[0]), f.hi[0], f.lo[0]);
  split<EXACT>(to_f(p[4]), f.hi[1], f.lo[1]);
}

// B = X with the contraction over tile rows r0 .. r0 + 7 taken in the order
// of acc_to_a (k = t <-> row r0 + 2t, k = t + 4 <-> row r0 + 2t + 1);
// B column n is tile column c0 + n (n = g).
template <bool EXACT, typename T>
__device__ __forceinline__ void load_b_perm(FragB& f, const T* s, int ld, int r0, int c0, int g,
                                            int t) {
  const T* p = s + (r0 + 2 * t) * ld + c0 + g;
  split<EXACT>(to_f(p[0]), f.hi[0], f.lo[0]);
  split<EXACT>(to_f(p[ld]), f.hi[1], f.lo[1]);
}

// An m16n8 accumulator (lane (g, t) holds rows g, g + 8 at columns 2t, 2t + 1)
// reused in registers as the A operand of the next product: its 8 columns
// become the contraction index in the order 0, 2, 4, 6, 1, 3, 5, 7, which
// load_b_perm applies to B's rows. No shuffle and no shared memory.
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split<false>(c[0], f.hi[0], f.lo[0]);  // row g,     column 2t
  split<false>(c[2], f.hi[1], f.lo[1]);  // row g + 8, column 2t
  split<false>(c[1], f.hi[2], f.lo[2]);  // row g,     column 2t + 1
  split<false>(c[3], f.hi[3], f.lo[3]);  // row g + 8, column 2t + 1
}

// Rows of the streamed tile: queries in dkv (16 at HD = 128, where the dk and
// dv accumulators take more registers), keys in dq.
template <int HD> __host__ __device__ constexpr int dkv_q_rows() { return HD <= 64 ? 32 : 16; }
constexpr int DQ_KT = 32;

// ------------------------------------------------------------------------
// backward, dk and dv: one CTA per 64-key tile, looping over the query
// tiles from the diagonal on; warp w owns keys 16 w .. 16 w + 15.
//   P^T = exp(sm_scale k q^T - lse), dv = P^T dO,
//   dS^T = P^T * (v dO^T - di), dk = sm_scale dS^T q
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(BWD_NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, int seq, int causal, float scale) {
  constexpr bool EXACT = sizeof(T) == 2;  // bfloat16 inputs are exact in TF32
  constexpr int LD = tile_ld<T, HD>(), QT = dkv_q_rows<HD>(), NQ = QT / 8, NC = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BN][LD]
  T* Vs = Ks + BN * LD;                    // [BN][LD]
  T* Qs = Vs + BN * LD;                    // [2][QT][LD], two stages
  T* dOs = Qs + 2 * QT * LD;               // [2][QT][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * QT * LD);  // [2][QT]
  float* di_s = lse_s + 2 * QT;                                 // [2][QT]

  const int kt = blockIdx.y;  // key tile 0 sees every query tile: longest first
  const int k0 = kt * BN;
  const size_t base = (size_t)blockIdx.x * seq * HD;
  const size_t row_base = (size_t)blockIdx.x * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kr = warp * 16;  // the warp's first key row in the tile
  const float scale_log2 = scale * LOG2E;
  const int n_qt = (seq + QT - 1) / QT;
  const int qt_first = causal ? k0 / QT : 0;

  auto load_stage = [&](int qt, int st) {
    load_tile_async<T, HD, QT>(Qs + st * QT * LD, q + base, qt * QT, seq);
    load_tile_async<T, HD, QT>(dOs + st * QT * LD, dout + base, qt * QT, seq);
    if (threadIdx.x < 2 * QT) {
      const int r = threadIdx.x % QT, row = qt * QT + r;
      const bool is_lse = threadIdx.x < QT, in = row < seq;
      cp_async4((is_lse ? lse_s : di_s) + st * QT + r,
                (is_lse ? lse : di) + row_base + (in ? row : 0), in ? 4 : 0);
    }
  };

  load_tile_async<T, HD, BN>(Ks, k + base, k0, seq);
  load_tile_async<T, HD, BN>(Vs, v + base, k0, seq);
  load_stage(qt_first, 0);
  cp_async_commit();

  float acc_k[NC][4] = {}, acc_v[NC][4] = {};
  for (int qt = qt_first; qt < n_qt; ++qt) {
    const int st = (qt - qt_first) & 1, q0 = qt * QT;
    cp_async_wait_all();
    __syncthreads();  // this stage has landed; every warp is done with the other one
    if (qt + 1 < n_qt) load_stage(qt + 1, st ^ 1);  // overlaps the products below
    cp_async_commit();
    const T* Qt = Qs + st * QT * LD;
    const T* dOt = dOs + st * QT * LD;
    const float* lse_t = lse_s + st * QT;
    const float* di_t = di_s + st * QT;

    // S^T = k q^T and dP^T = v dO^T: rows the warp's 16 keys, columns QT queries
    float s[NQ][4] = {}, dp[NQ][4] = {};
#pragma unroll
    for (int c0 = 0; c0 < HD; c0 += 8) {
      FragA ka, va;
      load_a<EXACT>(ka, Ks, LD, kr, c0, g, t);
      load_a<EXACT>(va, Vs, LD, kr, c0, g, t);
      FragB qb[NQ], gb[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        load_bt<EXACT>(qb[j], Qt, LD, 8 * j, c0, g, t);
        load_bt<EXACT>(gb[j], dOt, LD, 8 * j, c0, g, t);
      }
      mma3_add_row<EXACT, NQ>(s, ka, qb);
      mma3_add_row<EXACT, NQ>(dp, va, gb);
    }

    // P^T and dS^T in place; masks only on tiles that cross the diagonal or seq
    const bool edge = q0 + QT > seq || k0 + BN > seq || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kr + g + 8 * (e / 2), r = 8 * j + 2 * t + e % 2, row = q0 + r;
        const bool masked = edge && (row >= seq || key >= seq || (causal && key > row));
        const float p = masked ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lse_t[r] * LOG2E));
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - di_t[r]);
      }

    // dv += P^T dO, dk += dS^T q: P^T and dS^T stay in registers as A; the
    // tile's sum is taken in the tensor core and added once
    FragA pa[NQ], da[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      acc_to_a(pa[j], s[j]);
      acc_to_a(da[j], dp[j]);
    }
#pragma unroll
    for (int c = 0; c < NC; c += 2) {  // four chains: dv and dk at columns c, c + 1
      float tt[4][4] = {};
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const FragA a[4] = {pa[j], pa[j], da[j], da[j]};
        FragB b[4];
        load_b_perm<EXACT>(b[0], dOt, LD, 8 * j, 8 * c, g, t);
        load_b_perm<EXACT>(b[1], dOt, LD, 8 * j, 8 * c + 8, g, t);
        load_b_perm<EXACT>(b[2], Qt, LD, 8 * j, 8 * c, g, t);
        load_b_perm<EXACT>(b[3], Qt, LD, 8 * j, 8 * c + 8, g, t);
        mma3<false, EXACT, 4>(tt, a, b);
      }
      add_to(acc_v[c], tt[0]);
      add_to(acc_v[c + 1], tt[1]);
      add_to(acc_k[c], tt[2]);
      add_to(acc_k[c + 1], tt[3]);
    }
  }

#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + kr + g + 8 * (e / 2);
      if (key >= seq) continue;
      const size_t at = base + (size_t)key * HD + 8 * c + 2 * t + e % 2;
      dk[at] = from_f<T>(acc_k[c][e] * scale);
      dv[at] = from_f<T>(acc_v[c][e]);
    }
}

// ------------------------------------------------------------------------
// backward, dq: one CTA per 64-query tile, looping over the key tiles up to
// the diagonal; warp w owns queries 16 w .. 16 w + 15.
//   P = exp(sm_scale q k^T - lse), dS = P * (dO v^T - di), dq = sm_scale dS k
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(BWD_NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dq, int seq, int causal, float scale) {
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr int LD = tile_ld<T, HD>(), KT = DQ_KT, NK = KT / 8, NC = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BM][LD]
  T* dOs = Qs + BM * LD;                   // [BM][LD]
  T* Ks = dOs + BM * LD;                   // [2][KT][LD], two stages
  T* Vs = Ks + 2 * KT * LD;                // [2][KT][LD]

  const int n_tiles = (seq + BM - 1) / BM;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest rows first
  const int q0 = qt * BM;
  const size_t base = (size_t)blockIdx.x * seq * HD;
  const size_t row_base = (size_t)blockIdx.x * seq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qr = warp * 16;  // the warp's first query row in the tile
  const float scale_log2 = scale * LOG2E;

  load_tile_async<T, HD, BM>(Qs, q + base, q0, seq);
  load_tile_async<T, HD, BM>(dOs, dout + base, q0, seq);
  load_tile_async<T, HD, KT>(Ks, k + base, 0, seq);
  load_tile_async<T, HD, KT>(Vs, v + base, 0, seq);
  cp_async_commit();
  float lse2[2], dii[2];  // rows qr + g and qr + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qr + g + 8 * h;
    lse2[h] = row < seq ? lse[row_base + row] * LOG2E : 0.f;
    dii[h] = row < seq ? di[row_base + row] : 0.f;
  }

  float acc[NC][4] = {};
  const int n_kt = ((causal ? min(seq, q0 + BM) : seq) + KT - 1) / KT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * KT;
    cp_async_wait_all();
    __syncthreads();  // this stage has landed; every warp is done with the other one
    if (kt + 1 < n_kt) {  // overlaps the products below
      load_tile_async<T, HD, KT>(Ks + (st ^ 1) * KT * LD, k + base, k0 + KT, seq);
      load_tile_async<T, HD, KT>(Vs + (st ^ 1) * KT * LD, v + base, k0 + KT, seq);
    }
    cp_async_commit();
    const T* Kt = Ks + st * KT * LD;
    const T* Vt = Vs + st * KT * LD;

    // S = q k^T and dP = dO v^T: rows the warp's 16 queries, columns KT keys
    float s[NK][4] = {}, dp[NK][4] = {};
#pragma unroll
    for (int c0 = 0; c0 < HD; c0 += 8) {
      FragA qa, ga;
      load_a<EXACT>(qa, Qs, LD, qr, c0, g, t);
      load_a<EXACT>(ga, dOs, LD, qr, c0, g, t);
      FragB kb[NK], vb[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        load_bt<EXACT>(kb[j], Kt, LD, 8 * j, c0, g, t);
        load_bt<EXACT>(vb[j], Vt, LD, 8 * j, c0, g, t);
      }
      mma3_add_row<EXACT, NK>(s, qa, kb);
      mma3_add_row<EXACT, NK>(dp, ga, vb);
    }

    const bool edge = q0 + BM > seq || k0 + KT > seq || (causal && k0 + KT - 1 > q0);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + qr + g + 8 * (e / 2), col = k0 + 8 * j + 2 * t + e % 2;
        const bool masked = edge && (row >= seq || col >= seq || (causal && col > row));
        const float p = masked ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lse2[e / 2]));
        dp[j][e] = p * (dp[j][e] - dii[e / 2]);
      }

    // dq += dS k: dS stays in registers as A; the tile's sum is taken in
    // the tensor core and added once
    FragA da[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) acc_to_a(da[j], dp[j]);
    constexpr int CW = NC % 4 == 0 ? 4 : 2;  // chains: dq at columns c .. c + CW - 1
#pragma unroll
    for (int c = 0; c < NC; c += CW) {
      float tt[CW][4] = {};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragA a[CW];
        FragB b[CW];
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          a[i] = da[j];
          load_b_perm<EXACT>(b[i], Kt, LD, 8 * j, 8 * (c + i), g, t);
        }
        mma3<false, EXACT, CW>(tt, a, b);
      }
#pragma unroll
      for (int i = 0; i < CW; ++i) add_to(acc[c + i], tt[i]);
    }
  }

#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + qr + g + 8 * (e / 2);
      if (row < seq)
        dq[base + (size_t)row * HD + 8 * c + 2 * t + e % 2] = from_f<T>(acc[c][e] * scale);
    }
}

template <int HD> constexpr size_t fwd_smem() { return sizeof(float) * (3 * BN * (HD + 1) + BM * LDP); }
template <typename T, int HD> constexpr size_t dkv_smem() {
  return sizeof(T) * (2 * BN + 4 * dkv_q_rows<HD>()) * tile_ld<T, HD>() +
         sizeof(float) * 4 * dkv_q_rows<HD>();
}
template <typename T, int HD> constexpr size_t dq_smem() {
  return sizeof(T) * (2 * BM + 4 * DQ_KT) * tile_ld<T, HD>();
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, size_t smem, int bh, int seq, cudaStream_t stream,
           Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + BM - 1) / BM);  // x: b*h (no 65535 limit), y: 64-row tile
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int seq,
        int causal, float sm_scale, cudaStream_t stream) {
  return launch(flash_fwd_kernel<T, HD>, NT, fwd_smem<HD>(), bh, seq, stream, (const T*)q,
                (const T*)k, (const T*)v, (T*)o, lse, seq, causal, sm_scale * LOG2E);
}

template <typename T, int HD>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* di, void* dk, void* dv, int bh, int seq, int causal, float sm_scale,
        cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, HD>, BWD_NT, dkv_smem<T, HD>(), bh, seq, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dk, (T*)dv,
                seq, causal, sm_scale);
}

template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* di, void* dq_, int bh, int seq, int causal, float sm_scale,
       cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, HD>, BWD_NT, dq_smem<T, HD>(), bh, seq, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dq_, seq,
                causal, sm_scale);
}

// Instantiate F<T, HD> for the supported (dtype, head dim) pairs.
#define FLASH_DISPATCH(F, ...)                                           \
  switch (hd * 2 + is_bf16) {                                            \
    case 32: return F<float, 16>(__VA_ARGS__);                           \
    case 33: return F<__nv_bfloat16, 16>(__VA_ARGS__);                   \
    case 64: return F<float, 32>(__VA_ARGS__);                           \
    case 65: return F<__nv_bfloat16, 32>(__VA_ARGS__);                   \
    case 128: return F<float, 64>(__VA_ARGS__);                          \
    case 129: return F<__nv_bfloat16, 64>(__VA_ARGS__);                  \
    case 256: return F<float, 128>(__VA_ARGS__);                         \
    case 257: return F<__nv_bfloat16, 128>(__VA_ARGS__);                 \
    default: return (int)cudaErrorInvalidValue;                          \
  }

}  // namespace

// Plain C interface (ctypes). Each returns the launch's CUDA error code, 0
// on success; nothing synchronises.
extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        int is_bf16, int bh, int seq, int hd, int causal, float sm_scale,
                        void* stream) {
  FLASH_DISPATCH(fwd, q, k, v, o, lse, bh, seq, causal, sm_scale, (cudaStream_t)stream)
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* di, void* dk, void* dv,
                            int is_bf16, int bh, int seq, int hd, int causal, float sm_scale,
                            void* stream) {
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, di, dk, dv, bh, seq, causal, sm_scale,
                 (cudaStream_t)stream)
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* di, void* dq_, int is_bf16, int bh,
                           int seq, int hd, int causal, float sm_scale, void* stream) {
  FLASH_DISPATCH(dq, q, k, v, dout, lse, di, dq_, bh, seq, causal, sm_scale,
                 (cudaStream_t)stream)
}

}  // extern "C"

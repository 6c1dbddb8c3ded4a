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
// 64-row block. All three kernels run their products on the tensor cores:
//
//   - mma.sync m16n8k8 TF32 with float32 accumulators and the 3xTF32 split
//     of ../../csrc/tf32_mma.cuh: TF32 keeps 10 mantissa bits, too few for
//     the 1e-4 float32 gate, so each float32 operand is split a = hi + lo
//     and a b is summed as a_lo b_hi + a_hi b_lo + a_hi b_hi. bfloat16
//     inputs are exact in TF32, so their lo products are skipped; P and dS
//     are split on both routes. wgmma (warpgroup, 64-row) products are later
//     work: mma.sync keeps the fragment code per warp;
//   - the tensor core's float32 sums truncate; over the T / 8 steps of a
//     long sum that drifts by 1e-5 relative. So every sum the tensor core
//     takes is short: the first products per 8-column k-step (dP, S in the
//     backward) or per 4 of them (S in the forward), the second (P v, P^T dO,
//     dS^T q, dS k) per streamed tile, each then added to a float32
//     accumulator with a rounded add. The float32 results then agree with the
//     plain version to about 1e-6 (chip_smoke.py);
//   - grid (B*H, 64-row tiles): blockIdx.x is the (b, h) slice, blockIdx.y
//     the tile. Causal tiles above the diagonal are skipped, and the
//     longest rows of work are launched first (blockIdx.y 0 gets the last
//     query tile in the forward and dq kernels, the first key tile in dkv)
//     to shorten the tail. At B=4, H=12, T=1024 that is 768 CTAs over 132
//     SMs;
//   - 4 warps (128 threads) per CTA, each owning 16 rows of the CTA's
//     64-row tile (queries in the forward and dq, keys in dkv) and the full
//     width of the streamed tile. The first products' accumulators are
//     reused in registers as the A operand of the second products: an
//     accumulator's columns 2t, 2t + 1 are taken as the contraction index
//     t, t + 4 and the B operand's rows are read in the same permuted order,
//     so P and dS never touch shared memory. The independent mma chains of a
//     step are issued interleaved;
//   - the next streamed tile is loaded in 16-byte chunks while the current
//     one is computed. Shared tiles have a row stride of HD plus one 16-byte
//     chunk, 4 banks per row, so the fragment loads (row g, column t; or row
//     2t, column g, for lane 4 g + t) hit 32 different banks. The masks are
//     evaluated only on tiles that cross the diagonal or the end of the
//     sequence;
//   - no atomics: dkv owns a key tile and loops over query tiles, the
//     forward and dq own a query tile and loop over key tiles, so every
//     output element is summed by one thread in a fixed order (the results
//     are deterministic).
//
// Forward: the longest rows first, a 64-query tile per CTA, key tiles of 32
// rows (16 at HD = 128) from 0 to the diagonal. Each element is split once:
// q into register fragments held for the whole key loop (at HD = 128 they
// would not fit beside the o accumulator, so q's hi and lo words stay in
// shared memory there), each streamed k and v tile by the whole CTA into hi
// and lo word tiles in shared memory (not by each of the 4 warps that read
// it, which left the backward kernels bound by issue), and P in registers.
// The next k and v tile waits in registers while the current one is
// multiplied and is then split into the other of two stages: one
// __syncthreads per tile. The online softmax runs on the accumulator
// fragments: a row lives in the 4 lanes of a quad, so its max and sum take
// two shuffles. A float32 CTA at HD = 64 takes 68 KB of shared memory.
// (Placing each element's hi and lo side by side, for one 8-byte load,
// was slower: the tensor core takes a fragment's hi words in consecutive
// registers, and the compiler moved them there one by one.)
//
// Backward (dkv, dq): the streamed tiles (q, dO, lse, di in dkv; k, v in dq)
// are 32 rows (dkv: 16 at HD = 128 to fit the dk and dv accumulators in
// registers), arrive through a two-stage ring of cp.async loads, and are
// split per warp as the fragments are loaded, one __syncthreads per tile. A
// float32 CTA at HD = 64 takes 70 KB of shared memory; dkv's registers (255)
// allow two CTAs per SM, dq's (128) three.

#include <math_constants.h>

#include "../../csrc/tf32_mma.cuh"

namespace {

constexpr int BM = 64;   // rows of an owned tile (queries in fwd and dq, keys in dkv)
constexpr int BN = 64;   // BM == BN: a tile is on the diagonal or not
constexpr int NT = 128;  // threads per CTA: 4 warps of 16 rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 16 bytes from global to shared memory, asynchronously; src_bytes 0 writes
// zeros and reads nothing.
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

// Row stride (elements) of a shared-memory tile: HD plus one 16-byte chunk.
// Rows stay 16-byte aligned for cp.async, and a row is 4 banks (mod 32) past
// the one before, so the fragment loads below (lane (g, t) reads row g,
// column t, or row 2t, column g) hit 32 different banks.
template <typename T, int HD> __host__ __device__ constexpr int tile_ld() {
  return HD + 16 / (int)sizeof(T);
}

// Rows [row0, row0 + ROWS) of one [seq, HD] slice into a shared tile of row
// stride tile_ld, in 16-byte cp.async chunks; rows past seq are zero-filled
// (source size 0).
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src, int row0,
                                                int seq) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = HD / EPC, LD = tile_ld<T, HD>();
  constexpr int RS = NT / CPR;  // rows per pass of the CTA; a thread keeps its column
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
// pre-split tiles: the hi and the lo words of each element in two word
// tiles of row stride HD + 4 (rows 16-byte aligned, 4 banks apart, so the
// loads below hit 32 different banks)
// ------------------------------------------------------------------------
template <int HD> __host__ __device__ constexpr int word_ld() { return HD + 4; }

// Rows [0, ROWS) of a row-major [*, HD] tile of T (row stride src_ld
// elements, 16-byte chunks) split by the whole CTA into hi and lo word
// tiles; rows from `valid` on are zero. lo is not written when EXACT.
template <bool EXACT, typename T, int HD, int ROWS>
__device__ __forceinline__ void split_tile(uint32_t* hi, uint32_t* lo, const T* src, int src_ld,
                                           int valid) {
  constexpr int EPC = 16 / (int)sizeof(T), CPR = HD / EPC, LW = word_ld<HD>();
#pragma unroll
  for (int i = 0; i < (ROWS * CPR + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if ((ROWS * CPR) % NT == 0 || idx < ROWS * CPR) {
      const int r = idx / CPR, c = (idx % CPR) * EPC;
      float x[EPC];
      if (r < valid) {
        chunk_to_floats<T, EPC>(x, *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + c));
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) x[e] = 0.f;
      }
      split_store<EXACT, EPC>(hi + r * LW + c, lo + r * LW + c, x);
    }
  }
}

// The fragment loaders above, from pre-split word tiles (lo not read when
// EXACT).
template <bool EXACT>
__device__ __forceinline__ void load_a_pre(FragA& f, const uint32_t* hi, const uint32_t* lo,
                                           int ld, int r0, int c0, int g, int t) {
  const int at = (r0 + g) * ld + c0 + t;
  const int off[4] = {0, 8 * ld, 4, 8 * ld + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = hi[at + off[i]];
    f.lo[i] = EXACT ? 0u : lo[at + off[i]];
  }
}

template <bool EXACT>
__device__ __forceinline__ void load_bt_pre(FragB& f, const uint32_t* hi, const uint32_t* lo,
                                            int ld, int r0, int c0, int g, int t) {
  const int at = (r0 + g) * ld + c0 + t;
  f.hi[0] = hi[at];
  f.hi[1] = hi[at + 4];
  f.lo[0] = EXACT ? 0u : lo[at];
  f.lo[1] = EXACT ? 0u : lo[at + 4];
}

template <bool EXACT>
__device__ __forceinline__ void load_b_perm_pre(FragB& f, const uint32_t* hi, const uint32_t* lo,
                                                int ld, int r0, int c0, int g, int t) {
  const int at = (r0 + 2 * t) * ld + c0 + g;
  f.hi[0] = hi[at];
  f.hi[1] = hi[at + ld];
  f.lo[0] = EXACT ? 0u : lo[at];
  f.lo[1] = EXACT ? 0u : lo[at + ld];
}

// Keys per streamed tile of the forward; q stays in registers up to HD = 64.
template <int HD> __host__ __device__ constexpr int fwd_k_rows() { return HD <= 64 ? 32 : 16; }
template <int HD> __host__ __device__ constexpr bool fwd_q_in_regs() { return HD <= 64; }
constexpr int FWD_SK = 4;  // k-steps (8 columns of HD each) per short tensor-core sum of S

// ------------------------------------------------------------------------
// forward: o = softmax(sm_scale * q k^T, causal) v and the logsumexp; one
// CTA per 64-query tile, looping over the key tiles up to the diagonal;
// warp w owns queries 16 w .. 16 w + 15.
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int seq, int causal, float scale_log2) {
  constexpr bool EXACT = sizeof(T) == 2;  // bfloat16 inputs are exact in TF32
  constexpr bool QREG = fwd_q_in_regs<HD>();
  constexpr int LW = word_ld<HD>(), KT = fwd_k_rows<HD>(), NK = KT / 8, NC = HD / 8;
  constexpr int SK = FWD_SK < NC ? FWD_SK : NC;
  constexpr int EPC = 16 / (int)sizeof(T), CPR = HD / EPC, NR = (KT * CPR + NT - 1) / NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // word tiles: k and v hi and lo in two stages, then q's hi and lo (HD = 128)
  constexpr int TW = KT * LW, NLO = EXACT ? 0 : 1;
  uint32_t* Khi = reinterpret_cast<uint32_t*>(smem_raw);  // [2][KT][LW]
  uint32_t* Vhi = Khi + 2 * TW;                           // [2][KT][LW]
  uint32_t* Klo = Vhi + 2 * TW;                           // [2][KT][LW], float32 only
  uint32_t* Vlo = Klo + NLO * 2 * TW;                     // [2][KT][LW], float32 only
  uint32_t* Qhi = Vlo + NLO * 2 * TW;                     // [BM][LW]
  uint32_t* Qlo = Qhi + BM * LW;                          // [BM][LW], float32 only

  const int n_tiles = (seq + BM - 1) / BM;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest rows first
  const int q0 = qt * BM;
  const size_t base = (size_t)blockIdx.x * seq * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int qr = warp * 16;  // the warp's first query row in the tile
  const int n_kt = ((causal ? min(seq, q0 + BM) : seq) + KT - 1) / KT;

  // the next k and v tiles in registers (16-byte loads, zero past seq),
  // split into a stage of the word tiles after the current tile's products
  uint4 k_next[NR], v_next[NR];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * NT, row = k0 + idx / CPR, c = (idx % CPR) * EPC;
      const bool in = ((KT * CPR) % NT == 0 || idx < KT * CPR) && row < seq;
      const size_t at = base + (size_t)row * HD + c;
      k_next[i] = in ? *reinterpret_cast<const uint4*>(k + at) : make_uint4(0u, 0u, 0u, 0u);
      v_next[i] = in ? *reinterpret_cast<const uint4*>(v + at) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&](int st) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int idx = threadIdx.x + i * NT, r = idx / CPR, c = (idx % CPR) * EPC;
      if ((KT * CPR) % NT == 0 || idx < KT * CPR) {
        const int at = st * TW + r * LW + c;
        float x[EPC];
        chunk_to_floats<T, EPC>(x, k_next[i]);
        split_store<EXACT, EPC>(Khi + at, Klo + at, x);
        chunk_to_floats<T, EPC>(x, v_next[i]);
        split_store<EXACT, EPC>(Vhi + at, Vlo + at, x);
      }
    }
  };

  fetch(0);
  store(0);
  // q, split once: each lane's fragments (rows qr + g (+ 8), columns
  // c0 + t (+ 4)) in registers, or the CTA's tile in shared memory
  FragA qa[QREG ? NC : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int s = 0; s < NC; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + qr + g + 8 * (i & 1), col = 8 * s + t + 4 * (i >> 1);
        const float x = row < seq ? to_f(q[base + (size_t)row * HD + col]) : 0.f;
        split<EXACT>(x, qa[s].hi[i], qa[s].lo[i]);
      }
  } else {
    split_tile<EXACT, T, HD, BM>(Qhi, Qlo, q + base + (size_t)q0 * HD, HD, seq - q0);
  }
  __syncthreads();

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // rows qr + g, qr + g + 8
  float acc[NC][4] = {};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * KT;
    const bool more = kt + 1 < n_kt;
    if (more) fetch(k0 + KT);  // in flight during the products below
    const int at = st * TW;  // this stage's tiles

    // S = q k^T: rows the warp's 16 queries, columns KT keys; a short
    // tensor-core sum per SK k-steps, added in float32
    float s[NK][4] = {};
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += SK) {
      float p[NK][4] = {};
#pragma unroll
      for (int c = c0; c < c0 + SK; ++c) {
        FragA a[NK];
        if constexpr (QREG) a[0] = qa[c];
        else load_a_pre<EXACT>(a[0], Qhi, Qlo, LW, qr, 8 * c, g, t);
        FragB kb[NK];
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          a[j] = a[0];
          load_bt_pre<EXACT>(kb[j], Khi + at, Klo + at, LW, 8 * j, 8 * c, g, t);
        }
        mma3<EXACT, EXACT, NK>(p, a, kb);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) add_to(s[j], p[j]);
    }

    // online softmax in base 2 on the fragments: lane (g, t) holds rows
    // g (e < 2) and g + 8 (e >= 2) at columns 8 j + 2 t + e % 2, so a row's
    // max and sum are over the quad's 4 lanes
    const bool edge = k0 + KT > seq || (causal && k0 + KT - 1 > q0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + qr + g + 8 * h;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e % 2;
          const bool masked = edge && (col >= seq || (causal && col > row));
          s[j][e] = masked ? -CUDART_INF_F : s[j][e] * scale_log2;
          mx = fmaxf(mx, s[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // a row with no visible key yet keeps p = 0 and l = 0 (no inf - inf)
      const float m_sub = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = exp2f(m[h] - m_sub);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_sub);
          rs += s[j][e];
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[h] = l[h] * alpha + rs;
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[c][2 * h] *= alpha;
        acc[c][2 * h + 1] *= alpha;
      }
    }

    // o += P v: P stays in registers as A; the tile's sum is taken in the
    // tensor core and added once
    FragA pa[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) acc_to_a(pa[j], s[j]);
    constexpr int CW = NC % 4 == 0 ? 4 : 2;  // chains: o at columns c .. c + CW - 1
#pragma unroll
    for (int c = 0; c < NC; c += CW) {
      float tt[CW][4] = {};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        FragA a[CW];
        FragB b[CW];
#pragma unroll
        for (int i = 0; i < CW; ++i) {
          a[i] = pa[j];
          load_b_perm_pre<EXACT>(b[i], Vhi + at, Vlo + at, LW, 8 * j, 8 * (c + i), g, t);
        }
        mma3<false, EXACT, CW>(tt, a, b);
      }
#pragma unroll
      for (int i = 0; i < CW; ++i) add_to(acc[c + i], tt[i]);
    }
    // the next tile into the other stage, whose readers finished before the
    // last barrier
    if (more) store(st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + qr + g + 8 * h;
    if (row >= seq) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        o[base + (size_t)row * HD + 8 * c + 2 * t + e] = from_f<T>(acc[c][2 * h + e] * inv);
    if (t == 0) lse[(size_t)blockIdx.x * seq + row] = (m[h] + log2f(l[h])) * LN2;
  }
}

// ------------------------------------------------------------------------
// backward, dk and dv: one CTA per 64-key tile, looping over the query
// tiles from the diagonal on; warp w owns keys 16 w .. 16 w + 15.
//   P^T = exp(sm_scale k q^T - lse), dv = P^T dO,
//   dS^T = P^T * (v dO^T - di), dk = sm_scale dS^T q
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
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
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
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


template <typename T, int HD> constexpr size_t fwd_smem() {
  constexpr int tiles = (sizeof(T) == 2 ? 1 : 2) * (4 * fwd_k_rows<HD>() + (fwd_q_in_regs<HD>() ? 0 : BM));
  return sizeof(uint32_t) * tiles * word_ld<HD>();
}
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
  return launch(flash_fwd_kernel<T, HD>, NT, fwd_smem<T, HD>(), bh, seq, stream, (const T*)q,
                (const T*)k, (const T*)v, (T*)o, lse, seq, causal, sm_scale * LOG2E);
}

template <typename T, int HD>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* di, void* dk, void* dv, int bh, int seq, int causal, float sm_scale,
        cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, HD>, NT, dkv_smem<T, HD>(), bh, seq, stream,
                (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dk, (T*)dv,
                seq, causal, sm_scale);
}

template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* di, void* dq_, int bh, int seq, int causal, float sm_scale,
       cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, HD>, NT, dq_smem<T, HD>(), bh, seq, stream,
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

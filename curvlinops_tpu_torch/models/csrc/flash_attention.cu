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
// about 128 flops per byte, far above the H100's fp32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flops per byte). The backward does 2.5x the forward's
// products. So the design keeps every [T, T] score tile out of device
// memory and reuses each loaded tile across a whole 64-row block:
//
//   - one CTA of 256 threads per (b*h, 64-row tile). Scores of a 64x64 tile
//     are computed in registers, 4x4 per thread (rows ty + 16*i, columns
//     tx + 16*j, ty = tid / 16, tx = tid % 16), from shared-memory tiles
//     stored row-major with a row stride of HD + 1 floats, so that the 16
//     lanes reading 16 different rows at one column hit 16 banks;
//   - row reductions (max, sum) stay inside the 16 lanes of a half-warp
//     (__shfl_xor_sync with offsets 8, 4, 2, 1);
//   - the probabilities go through shared memory once for the second
//     product (P V, P^T dO, dS K, dS^T Q);
//   - grid (B*H, tiles): blockIdx.x is the (b, h) slice, blockIdx.y the
//     tile. Causal tiles above the diagonal are skipped, and the longest
//     rows of work are launched first (blockIdx.y 0 gets the last query
//     tile in the forward and dq kernels, the first key tile in dkv) to
//     shorten the tail;
//   - no atomics: dkv owns a key tile and loops over query tiles, dq owns
//     a query tile and loops over key tiles, so every output element is
//     summed by one thread in a fixed order (the results are deterministic).
//
// The products run on the fp32 CUDA cores, not the tensor cores, and the
// loads are not pipelined (no cp.async/TMA); wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 64;    // query rows per tile
constexpr int BN = 64;    // key rows per tile (BM == BN: a tile is on the diagonal or not)
constexpr int NT = 256;   // threads per CTA
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
// backward, dk and dv: one CTA per key tile, looping over the query tiles
// from the diagonal on.
//   P^T = exp(sm_scale k q^T - lse), dv = P^T dO,
//   dS^T = P^T * (v dO^T - di), dk = sm_scale dS^T q
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, int seq, int causal, float scale) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BN][LD]
  float* Vs = Ks + BN * LD;     // [BN][LD]
  float* Qs = Vs + BN * LD;     // [BM][LD]
  float* dOs = Qs + BM * LD;    // [BM][LD]
  float* Pt = dOs + BM * LD;    // [BN][LDP]
  float* dSt = Pt + BN * LDP;   // [BN][LDP]
  float* lse_s = dSt + BN * LDP;  // [BM], base 2
  float* di_s = lse_s + BM;       // [BM]

  const int n_tiles = (seq + BM - 1) / BM;
  const int kt = blockIdx.y;  // key tile 0 sees every query tile: longest first
  const int k0 = kt * BN;
  const size_t base = (size_t)blockIdx.x * seq * HD;
  const size_t row_base = (size_t)blockIdx.x * seq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float scale_log2 = scale * LOG2E;

  load_tile<T, HD>(Ks, k + base, k0, seq);
  load_tile<T, HD>(Vs, v + base, k0, seq);
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_tile<T, HD>(Qs, q + base, q0, seq);
    load_tile<T, HD>(dOs, dout + base, q0, seq);
    if (threadIdx.x < BM) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < seq ? lse[row_base + row] * LOG2E : 0.f;
      di_s[threadIdx.x] = row < seq ? di[row_base + row] : 0.f;
    }
    __syncthreads();

    // rows: keys ty + 16 i; columns: queries tx + 16 j
    float st[4][4] = {}, dpt[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kk[4], vv[4], qq[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qq[j] = Qs[(tx + 16 * j) * LD + d];
        gg[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kk[i], qq[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], gg[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        const bool masked = row >= seq || key >= seq || (causal && key > row);
        const float p = masked ? 0.f : exp2f(st[i][j] * scale_log2 - lse_s[r]);
        Pt[(ty + 16 * i) * LDP + r] = p;
        dSt[(ty + 16 * i) * LDP + r] = p * (dpt[i][j] - di_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BM; ++r) {
      float p[4], ds[4], g[NC], x[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Pt[(ty + 16 * i) * LDP + r];
        ds[i] = dSt[(ty + 16 * i) * LDP + r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        g[c] = dOs[r * LD + tx + 16 * c];
        x[c] = Qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[i][c] = fmaf(p[i], g[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds[i], x[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t at = base + (size_t)key * HD + tx + 16 * c;
      dk[at] = from_f<T>(acc_k[i][c] * scale);
      dv[at] = from_f<T>(acc_v[i][c]);
    }
  }
}

// ------------------------------------------------------------------------
// backward, dq: one CTA per query tile, looping over the key tiles up to
// the diagonal.
//   P = exp(sm_scale q k^T - lse), dS = P * (dO v^T - di), dq = sm_scale dS k
// ------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dq, int seq, int causal, float scale) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BM][LD]
  float* dOs = Qs + BM * LD;    // [BM][LD]
  float* Ks = dOs + BM * LD;    // [BN][LD]
  float* Vs = Ks + BN * LD;     // [BN][LD]
  float* dSs = Vs + BN * LD;    // [BM][LDP]

  const int n_tiles = (seq + BM - 1) / BM;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest rows first
  const int q0 = qt * BM;
  const size_t base = (size_t)blockIdx.x * seq * HD;
  const size_t row_base = (size_t)blockIdx.x * seq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float scale_log2 = scale * LOG2E;

  load_tile<T, HD>(Qs, q + base, q0, seq);
  load_tile<T, HD>(dOs, dout + base, q0, seq);
  float lse2[4], dii[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse2[i] = row < seq ? lse[row_base + row] * LOG2E : 0.f;
    dii[i] = row < seq ? di[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, HD>(Ks, k + base, k0, seq);
    load_tile<T, HD>(Vs, v + base, k0, seq);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        g[i] = dOs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * LD + d];
        w[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool masked = row >= seq || col >= seq || (causal && col > row);
        const float p = masked ? 0.f : exp2f(s[i][j] * scale_log2 - lse2[i]);
        dSs[(ty + 16 * i) * LDP + tx + 16 * j] = p * (dp[i][j] - dii[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float ds[4], x[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) x[cc] = Ks[c * LD + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) acc[i][cc] = fmaf(ds[i], x[cc], acc[i][cc]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[base + (size_t)row * HD + tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <int HD> constexpr size_t fwd_smem() { return sizeof(float) * (3 * BN * (HD + 1) + BM * LDP); }
template <int HD> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * BN * (HD + 1) + 2 * BN * LDP + 2 * BM);
}
template <int HD> constexpr size_t dq_smem() { return sizeof(float) * (4 * BN * (HD + 1) + BM * LDP); }

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int bh, int seq, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (seq + BM - 1) / BM);  // x: b*h (no 65535 limit), y: tile
  kernel<<<grid, NT, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int seq,
        int causal, float sm_scale, cudaStream_t stream) {
  return launch(flash_fwd_kernel<T, HD>, fwd_smem<HD>(), bh, seq, stream, (const T*)q,
                (const T*)k, (const T*)v, (T*)o, lse, seq, causal, sm_scale * LOG2E);
}

template <typename T, int HD>
int dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
        const float* di, void* dk, void* dv, int bh, int seq, int causal, float sm_scale,
        cudaStream_t stream) {
  return launch(flash_bwd_dkv_kernel<T, HD>, dkv_smem<HD>(), bh, seq, stream, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dk, (T*)dv, seq,
                causal, sm_scale);
}

template <typename T, int HD>
int dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
       const float* di, void* dq_, int bh, int seq, int causal, float sm_scale,
       cudaStream_t stream) {
  return launch(flash_bwd_dq_kernel<T, HD>, dq_smem<HD>(), bh, seq, stream, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, lse, di, (T*)dq_, seq, causal,
                sm_scale);
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

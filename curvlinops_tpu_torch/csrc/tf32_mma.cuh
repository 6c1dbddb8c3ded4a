// Building blocks shared by the port's Hopper kernels (sm_90a): dtype
// conversion and float32-accurate products on the TF32 tensor cores
// (mma.sync m16n8k8 with the 3xTF32 split).
//
// 3xTF32: x = hi + lo with hi = tf32(x) (round to nearest) and lo = x - hi,
// of which the tensor core reads the TF32 bits (it ignores the low 13), and
// a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi keeps float32 accuracy on the TF32
// tensor cores (495 / 3 = 165 TFLOP/s of float32-accurate work against the
// CUDA cores' 67). An EXACT operand (a bfloat16 value: 8 mantissa bits, TF32
// has 10) is its own hi and has lo = 0, so its lo product is skipped.
//
// The tensor core's float32 sums truncate instead of rounding, so a long
// chain of them drifts (1e-5 relative over a few hundred steps): callers keep
// every tensor-core sum short and add each short sum into their float32
// accumulators with a rounded add (add_to).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
// behind the others' (a warp issues in order).
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

// EPC (16 / sizeof(T)) elements of one 16-byte chunk, split into hi and lo
// words and stored at hi[0 .. EPC) and lo[0 .. EPC) (16-byte aligned); lo
// is not written for an EXACT chunk.
template <bool EXACT, int EPC>
__device__ __forceinline__ void split_store(uint32_t* hi, uint32_t* lo, const float (&x)[EPC]) {
#pragma unroll
  for (int e = 0; e < EPC; e += 4) {
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split<EXACT>(x[e + i], h[i], l[i]);
    *reinterpret_cast<uint4*>(hi + e) = make_uint4(h[0], h[1], h[2], h[3]);
    if (!EXACT) *reinterpret_cast<uint4*>(lo + e) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// One 16-byte chunk of T (float32 or bfloat16) as EPC floats.
template <typename T, int EPC>
__device__ __forceinline__ void chunk_to_floats(float (&x)[EPC], const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else {  // a bfloat16 is the top half of a float32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Eigendecomposition of small symmetric matrices (n <= 96), on the device.
//
// Replaces no TPU kernel. It exists so that LOBPCG's small eigenproblems (the
// [3k, 3k] Rayleigh-Ritz matrix and the [k, k] SVQB Gram matrices of
// curvlinops_tpu_torch/solvers/eigsh.py) can run inside a captured CUDA graph:
// torch.linalg.eigh checks its convergence on the host and so cannot be
// captured. It computes, for each matrix of a batch, the eigenvalues in
// descending order and the matching eigenvectors as columns, reading the
// lower triangle as torch.linalg.eigh does.
//
// What bounds it on this card: latency. A 96 x 96 matrix is 74 KB of float64;
// one block holds it and its eigenvectors in shared memory, and the work
// (a few sweeps of n - 1 rounds of n / 2 rotations, each touching two rows
// and two columns) is a few tens of MFLOP at most, spread over n - 1 rounds
// with three barriers each. So the design keeps everything in one block,
// on chip, with no device-memory traffic between rounds:
//   * one thread block of 256 threads per matrix; A and V live in shared
//     memory (dynamic, up to 2 * 96 * 96 * 8 bytes);
//   * cyclic Jacobi in the round-robin ("tournament") order: each round
//     pairs every index once, so its n / 2 rotations are disjoint and run
//     together: one thread computes each rotation (the symmetric 2 x 2
//     Schur decomposition of Golub & Van Loan, Algorithm 8.4.1), then the
//     block applies all of them to the rows, then to the columns of A and V,
//     and sets the zeroed pair entries to exactly 0;
//   * before each sweep the block sums the off-diagonal squares and stops
//     once they fall to eps^2 times the squared Frobenius norm (a uniform
//     branch), or after max_sweeps sweeps;
//   * the eigenvalues (A's diagonal) are sorted descending by ranks, ties
//     broken by index, and written with their columns of V.
// An odd n pairs one index a round with a virtual one, whose rotation is
// the identity.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 96;

template <typename T>
__device__ T block_sum(T x, T* scratch) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by an earlier sum
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  T total = 0;
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

template <typename T>
__device__ T sq(T x) {
  return x * x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
small_eigh_kernel(const T* __restrict__ A_in, T* __restrict__ w_out, T* __restrict__ V_out,
                  int* __restrict__ sweeps_out, int n, int max_sweeps, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* A = reinterpret_cast<T*>(smem_raw);  // [n][n], row-major
  T* V = A + n * n;                       // [n][n]
  T* rot_c = V + n * n;                   // [kMaxN / 2] per pair of the round
  T* rot_s = rot_c + kMaxN / 2;
  T* scratch = rot_s + kMaxN / 2;         // [kThreads / 32]
  int* pair_p = reinterpret_cast<int*>(scratch + kThreads / 32);
  int* pair_q = pair_p + kMaxN / 2;

  const int tid = threadIdx.x;
  const int nn = n * n;
  const T* Ab = A_in + static_cast<size_t>(blockIdx.x) * nn;
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    A[idx] = i >= j ? Ab[idx] : Ab[j * n + i];  // the lower triangle, mirrored
    V[idx] = i == j ? T(1) : T(0);
  }
  __syncthreads();

  T local = 0;
  for (int idx = tid; idx < nn; idx += kThreads) local += sq(A[idx]);
  const T norm2 = block_sum(local, scratch);

  const int N = n + (n & 1);  // even: an odd n gets a virtual index n
  const int half = N / 2;
  int sweep = 0;
  for (; sweep < max_sweeps; ++sweep) {
    local = 0;
    for (int idx = tid; idx < nn; idx += kThreads) {
      if (idx / n != idx % n) local += sq(A[idx]);
    }
    const T off2 = block_sum(local, scratch);
    if (!(off2 > sq(eps) * norm2)) break;  // uniform across the block; NaN stops too

    for (int round = 0; round < N - 1; ++round) {
      if (tid < half) {
        // round-robin pairing: index N - 1 is fixed, the others rotate
        int a = tid == 0 ? N - 1 : (round + tid) % (N - 1);
        int b = tid == 0 ? round : (round - tid + N - 1) % (N - 1);
        const int p = min(a, b), q = max(a, b);
        T c = 1, s = 0;
        if (q < n) {
          const T apq = A[p * n + q];
          if (apq != T(0)) {
            const T tau = (A[q * n + q] - A[p * n + p]) / (2 * apq);
            const T t = tau >= 0 ? T(1) / (tau + sqrt(T(1) + tau * tau))
                                 : T(-1) / (-tau + sqrt(T(1) + tau * tau));
            c = T(1) / sqrt(T(1) + t * t);
            s = t * c;
          }
        }
        pair_p[tid] = p;
        pair_q[tid] = q;
        rot_c[tid] = c;
        rot_s[tid] = s;
      }
      __syncthreads();
      // rows: A <- J^T A
      for (int idx = tid; idx < half * n; idx += kThreads) {
        const int m = idx / n, j = idx % n;
        const int p = pair_p[m], q = pair_q[m];
        if (q < n) {
          const T c = rot_c[m], s = rot_s[m];
          const T ap = A[p * n + j], aq = A[q * n + j];
          A[p * n + j] = c * ap - s * aq;
          A[q * n + j] = s * ap + c * aq;
        }
      }
      __syncthreads();
      // columns: A <- A J, V <- V J; the rotated pair's entries are zero
      for (int idx = tid; idx < half * n; idx += kThreads) {
        const int m = idx / n, i = idx % n;
        const int p = pair_p[m], q = pair_q[m];
        if (q < n) {
          const T c = rot_c[m], s = rot_s[m];
          const T ap = A[i * n + p], aq = A[i * n + q];
          A[i * n + p] = i == q ? T(0) : c * ap - s * aq;
          A[i * n + q] = i == p ? T(0) : s * ap + c * aq;
          const T vp = V[i * n + p], vq = V[i * n + q];
          V[i * n + p] = c * vp - s * vq;
          V[i * n + q] = s * vp + c * vq;
        }
      }
      __syncthreads();
    }
  }

  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweep;

  // sort descending by rank (ties by index) and write out
  T* w_b = w_out + static_cast<size_t>(blockIdx.x) * n;
  T* V_b = V_out + static_cast<size_t>(blockIdx.x) * nn;
  for (int i = tid; i < n; i += kThreads) {
    const T wi = A[i * n + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T wj = A[j * n + j];
      rank += (wj > wi) || (wj == wi && j < i);
    }
    w_b[rank] = wi;
    for (int r = 0; r < n; ++r) V_b[r * n + rank] = V[r * n + i];
  }
}

template <typename T>
size_t smem_bytes(int n) {
  return sizeof(T) * (2 * n * n + kMaxN + kThreads / 32) + sizeof(int) * kMaxN;
}

template <typename T>
int launch(const void* A, void* w, void* V, int* sweeps, int batch, int n, int max_sweeps, T eps,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(n);
  cudaError_t err = cudaFuncSetAttribute(small_eigh_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  small_eigh_kernel<T><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V), sweeps, n, max_sweeps,
      eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (ctypes): A is [batch, n, n] contiguous, w [batch, n] and
// V [batch, n, n] are written, and each matrix's sweep count to sweeps
// [batch] unless it is null. Returns the launch's CUDA error code, 0 on
// success; nothing synchronises.
extern "C" {

int small_eigh_f32(const void* A, void* w, void* V, void* sweeps, int batch, int n,
                   int max_sweeps, float eps, void* stream) {
  return launch<float>(A, w, V, static_cast<int*>(sweeps), batch, n, max_sweeps, eps,
                       static_cast<cudaStream_t>(stream));
}

int small_eigh_f64(const void* A, void* w, void* V, void* sweeps, int batch, int n,
                   int max_sweeps, double eps, void* stream) {
  return launch<double>(A, w, V, static_cast<int*>(sweeps), batch, n, max_sweeps, eps,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Eigendecomposition of small symmetric matrices (n <= 512), on the device.
//
// Replaces no TPU kernel. It exists so that LOBPCG's small eigenproblems (the
// [3k, 3k] Rayleigh-Ritz matrix and the [k, k] SVQB Gram matrices of
// curvlinops_tpu_torch/solvers/eigsh.py) can run inside a captured CUDA graph:
// torch.linalg.eigh checks its convergence on the host and so cannot be
// captured. It computes, for each matrix of a batch, the eigenvalues in
// descending order and the matching eigenvectors as columns, reading the
// lower triangle as torch.linalg.eigh does.
//
// What bounds it on this card: latency. The work (a few sweeps of n - 1
// rounds of n / 2 rotations, each touching two rows and two columns of A and
// two rows of V^T) is at most a few GFLOP at n = 512, spread over n - 1
// rounds with two barriers each, so the design keeps each matrix in one
// block and close to it:
//   * every rotation is computed and applied in float64, and V^T is kept in
//     float64; A is stored in the input's type. Kept in float32, V^T drifts
//     from orthonormal by about 1.5 n^1.5 eps (||V^T V - I|| = 3.6e-4 at
//     n = 161), since each entry takes sweeps x n rotations, each rounded;
//   * one thread block per matrix. Two routes, chosen by the caller:
//     - shared: A and V^T in shared memory (n^2 elements of each plus
//       scratch within the 227 KB a block may opt into), 256 threads;
//     - global: A and V^T in device-memory workspaces the caller allocates
//       ([batch, n, n] each; at n = 512 in float64 4 MB a matrix, resident in
//       the 50 MB L2), 1024 threads, the rotations' scratch in shared memory.
//     The shared route's lower latency wins while a round is small, the
//     global route's threads once it is large: on an H100 they cross
//     between n = 44 and 48 (float32) and 48 and 56 (float64), and the
//     caller switches at 44 (solvers/small_eigh.py, SHARED_MAX_N);
//   * cyclic Jacobi in the round-robin ("tournament") order: each round
//     pairs every index once, so its n / 2 rotations are disjoint and run
//     together: one thread computes each rotation (the symmetric 2 x 2
//     Schur decomposition of Golub & Van Loan, Algorithm 8.4.1), then the
//     block applies all of them at once, one thread per 2 x 2 block of A
//     (rows p1, q1 of one rotation, columns p2, q2 of another): first the
//     rows' rotation, then the columns', each entry rounded to A's type
//     once; a rotation's own 2 x 2 block gets exact zeros off its
//     diagonal. V^T's
//     rows p, q turn with the same rotations. Neighbouring threads take
//     neighbouring column pairs, whose indices run consecutively in this
//     order, so a warp reads few lines (global) or few banks (shared);
//   * before each sweep the block sums the off-diagonal squares and stops
//     once they fall to eps^2 times the squared Frobenius norm (a uniform
//     branch), or after max_sweeps sweeps;
//   * the eigenvalues (A's diagonal) are ranked descending, ties broken by
//     index, and written with their rows of V^T as columns.
// An odd n pairs one index a round with a virtual one, whose rotation is
// the identity.

#include <cuda_runtime.h>

namespace {

constexpr int kSharedThreads = 256;
constexpr int kGlobalThreads = 1024;
constexpr int kMaxN = 512;
constexpr int kMaxPairs = kMaxN / 2;
constexpr int kSharedBytes = 232448;  // the opt-in limit of one block on sm_90
using U = double;                     // the rotations' and V^T's type

template <int kThreads>
__device__ U block_sum(U x, U* scratch) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read by an earlier sum
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  U total = 0;
  for (int w = 0; w < kThreads / 32; ++w) total += scratch[w];
  return total;
}

__device__ U sq(U x) { return x * x; }

// Shared memory: the round's rotations and the sums' partials (float64),
// then on the shared route V^T (float64) and A (the input's type), then the
// pairs and the ranks (int), so each part is aligned to its type.
template <int kThreads>
constexpr size_t scratch_bytes() {
  return sizeof(U) * (2 * kMaxPairs + kThreads / 32) + sizeof(int) * (2 * kMaxPairs + kMaxN);
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kGlobalThreads)
small_eigh_kernel(const T* __restrict__ A_in, T* __restrict__ w_out, T* __restrict__ V_out,
                  T* __restrict__ work_a, U* __restrict__ work_v, int* __restrict__ sweeps_out,
                  int n, int max_sweeps, U eps) {
  constexpr int kThreads = kShared ? kSharedThreads : kGlobalThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = n * n;
  U* rot_c = reinterpret_cast<U*>(smem_raw);
  U* rot_s = rot_c + kMaxPairs;
  U* scratch = rot_s + kMaxPairs;  // [kThreads / 32]
  U* Vt;  // [n][n], row i the i-th eigenvector
  T* A;   // [n][n], row-major
  int* pair_p;
  if constexpr (kShared) {
    Vt = scratch + kThreads / 32;
    A = reinterpret_cast<T*>(Vt + nn);
    pair_p = reinterpret_cast<int*>(A + nn);
  } else {
    Vt = work_v + static_cast<size_t>(blockIdx.x) * nn;
    A = work_a + static_cast<size_t>(blockIdx.x) * nn;
    pair_p = reinterpret_cast<int*>(scratch + kThreads / 32);
  }
  int* pair_q = pair_p + kMaxPairs;
  int* rank_of = pair_q + kMaxPairs;  // [n]

  const int tid = threadIdx.x;
  const T* Ab = A_in + static_cast<size_t>(blockIdx.x) * nn;
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    A[idx] = i >= j ? Ab[idx] : Ab[j * n + i];  // the lower triangle, mirrored
    Vt[idx] = i == j ? U(1) : U(0);
  }
  __syncthreads();

  U local = 0;
  for (int idx = tid; idx < nn; idx += kThreads) local += sq(U(A[idx]));
  const U norm2 = block_sum<kThreads>(local, scratch);

  const int N = n + (n & 1);  // even: an odd n gets a virtual index n
  const int half = N / 2;
  int sweep = 0;
  for (; sweep < max_sweeps; ++sweep) {
    local = 0;
    for (int idx = tid; idx < nn; idx += kThreads) {
      if (idx / n != idx % n) local += sq(U(A[idx]));
    }
    const U off2 = block_sum<kThreads>(local, scratch);
    if (!(off2 > sq(eps) * norm2)) break;  // uniform across the block; NaN stops too

    for (int round = 0; round < N - 1; ++round) {
      for (int m = tid; m < half; m += kThreads) {
        // round-robin pairing: index N - 1 is fixed, the others rotate
        const int a = m == 0 ? N - 1 : (round + m) % (N - 1);
        const int b = m == 0 ? round : (round - m + N - 1) % (N - 1);
        const int p = min(a, b), q = max(a, b);
        U c = 1, s = 0;
        if (q < n) {
          const U apq = A[p * n + q];
          if (apq != U(0)) {
            const U tau = (U(A[q * n + q]) - U(A[p * n + p])) / (2 * apq);
            const U t = tau >= 0 ? U(1) / (tau + sqrt(U(1) + tau * tau))
                                 : U(-1) / (-tau + sqrt(U(1) + tau * tau));
            c = U(1) / sqrt(U(1) + t * t);
            s = t * c;
          }
        }
        pair_p[m] = p;
        pair_q[m] = q;
        rot_c[m] = c;
        rot_s[m] = s;
      }
      __syncthreads();
      // A <- J^T A J, one 2 x 2 block (rows of rotation m1, columns of m2)
      // a thread; a virtual index (q == n) has no row or column
      for (int idx = tid; idx < half * half; idx += kThreads) {
        const int m1 = idx / half, m2 = idx % half;
        const int p1 = pair_p[m1], q1 = pair_q[m1], p2 = pair_p[m2], q2 = pair_q[m2];
        const bool row_q = q1 < n, col_q = q2 < n;
        const U c1 = rot_c[m1], s1 = rot_s[m1], c2 = rot_c[m2], s2 = rot_s[m2];
        const U x_pp = A[p1 * n + p2];
        const U x_pq = col_q ? U(A[p1 * n + q2]) : U(0);
        const U x_qp = row_q ? U(A[q1 * n + p2]) : U(0);
        const U x_qq = row_q && col_q ? U(A[q1 * n + q2]) : U(0);
        // rows: J^T; a pair without a rotation (c = 1, s = 0) keeps its values
        const U r_pp = c1 * x_pp - s1 * x_qp, r_qp = s1 * x_pp + c1 * x_qp;
        const U r_pq = c1 * x_pq - s1 * x_qq, r_qq = s1 * x_pq + c1 * x_qq;
        // columns: J; the rotated pair's own entries are zero
        const bool own = m1 == m2;
        A[p1 * n + p2] = T(c2 * r_pp - s2 * r_pq);
        if (col_q) A[p1 * n + q2] = own ? T(0) : T(s2 * r_pp + c2 * r_pq);
        if (row_q) A[q1 * n + p2] = own ? T(0) : T(c2 * r_qp - s2 * r_qq);
        if (row_q && col_q) A[q1 * n + q2] = T(s2 * r_qp + c2 * r_qq);
      }
      // V^T <- J^T V^T: rows p, q of each rotation
      for (int idx = tid; idx < half * n; idx += kThreads) {
        const int m = idx / n, j = idx % n;
        const int p = pair_p[m], q = pair_q[m];
        if (q < n) {
          const U c = rot_c[m], s = rot_s[m];
          const U vp = Vt[p * n + j], vq = Vt[q * n + j];
          Vt[p * n + j] = c * vp - s * vq;
          Vt[q * n + j] = s * vp + c * vq;
        }
      }
      __syncthreads();
    }
  }

  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweep;

  // rank descending (ties by index), then write w and V's columns
  T* w_b = w_out + static_cast<size_t>(blockIdx.x) * n;
  T* V_b = V_out + static_cast<size_t>(blockIdx.x) * nn;
  for (int i = tid; i < n; i += kThreads) {
    const T wi = A[i * n + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const T wj = A[j * n + j];
      rank += (wj > wi) || (wj == wi && j < i);
    }
    rank_of[i] = rank;
    w_b[rank] = wi;
  }
  __syncthreads();
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, r = idx % n;
    V_b[r * n + rank_of[i]] = T(Vt[idx]);
  }
}

template <typename T, bool kShared>
size_t smem_bytes(int n) {
  return scratch_bytes<kShared ? kSharedThreads : kGlobalThreads>() +
         (kShared ? (sizeof(U) + sizeof(T)) * static_cast<size_t>(n) * n : 0);
}

template <typename T, bool kShared>
int launch_route(const void* A, void* w, void* V, void* work_a, void* work_v, int* sweeps,
                 int batch, int n, int max_sweeps, U eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, kShared>(n);
  if (smem > kSharedBytes || (!kShared && (work_a == nullptr || work_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(small_eigh_kernel<T, kShared>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  small_eigh_kernel<T, kShared>
      <<<batch, kShared ? kSharedThreads : kGlobalThreads, smem, stream>>>(
          static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V),
          static_cast<T*>(work_a), static_cast<U*>(work_v), sweeps, n, max_sweeps, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, void* w, void* V, void* work_a, void* work_v, void* sweeps, int batch,
           int n, int max_sweeps, double eps, int global_route, void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<int*>(sweeps);
  auto* st = static_cast<cudaStream_t>(stream);
  return global_route ? launch_route<T, false>(A, w, V, work_a, work_v, s, batch, n, max_sweeps,
                                               eps, st)
                      : launch_route<T, true>(A, w, V, work_a, work_v, s, batch, n, max_sweeps,
                                              eps, st);
}

}  // namespace

// Plain C interface (ctypes): A is [batch, n, n] contiguous, w [batch, n] and
// V [batch, n, n] are written, and each matrix's sweep count to sweeps
// [batch] unless it is null; eps is the input type's. global_route 0 keeps A
// and V^T in shared memory (an error where they do not fit); 1 keeps them in
// work_a ([batch, n, n] of the input's type) and work_v ([batch, n, n]
// float64), which the caller allocates (null on the shared route). Returns
// the launch's CUDA error code, 0 on success; nothing synchronises.
extern "C" {

int small_eigh_f32(const void* A, void* w, void* V, void* work_a, void* work_v, void* sweeps,
                   int batch, int n, int max_sweeps, double eps, int global_route, void* stream) {
  return launch<float>(A, w, V, work_a, work_v, sweeps, batch, n, max_sweeps, eps, global_route,
                       stream);
}

int small_eigh_f64(const void* A, void* w, void* V, void* work_a, void* work_v, void* sweeps,
                   int batch, int n, int max_sweeps, double eps, int global_route, void* stream) {
  return launch<double>(A, w, V, work_a, work_v, sweeps, batch, n, max_sweeps, eps, global_route,
                        stream);
}

}  // extern "C"

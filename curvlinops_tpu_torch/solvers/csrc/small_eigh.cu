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
// What bounds it on this card: latency. Jacobi's work (a few sweeps of about
// 12 n^3 flops on the cluster route) is a few GFLOP at n = 512, but every
// index must meet every other once a sweep, one partner a round: a sweep is a
// chain of about n dependent rounds, each ending in a barrier. The design
// keeps each round small and close (a [32, 32] sub-matrix in one block's
// shared memory) and spreads the rest of the work over as many SMs as a
// thread-block cluster holds:
//   * every rotation is computed and applied in float64, and V^T is kept in
//     float64 (so is A on the cluster route). Kept in float32, V^T drifts
//     from orthonormal by about 1.5 n^1.5 eps (||V^T V - I|| = 3.6e-4 at
//     n = 161), since each entry takes sweeps x n rotations, each rounded;
//   * a rotation costs two reciprocal square roots in a row and no
//     division: with d = a_qq - a_pp, r^2 = d^2 + 4 a_pq^2, u = |d| + r^2
//     rsqrt(r^2) and g = rsqrt(u^2 + 4 a_pq^2), c = u g and
//     s = sign(d) 2 a_pq g (the symmetric 2 x 2 Schur decomposition of
//     Golub & Van Loan, Algorithm 8.4.1, with t = s / c);
//   * two routes, chosen by the caller (solvers/small_eigh.py, at the
//     crossovers measured on an H100):
//     - shared (n <= 16, and 33-38, where the cluster route pads n to 64):
//       one block of 256 threads, A and V^T in shared memory; cyclic
//       Jacobi in the round-robin ("tournament") order, each round's n / 2
//       disjoint rotations computed by one thread each, then applied by
//       the block, one thread per 2 x 2 block of A (rows of one rotation,
//       columns of another), two barriers a round;
//     - cluster: blocked two-sided Jacobi. n is padded to N = 32 m with
//       zero rows and columns (their rotations are the identity, so they
//       never mix with the real indices), and the N indices form 2m blocks
//       of 16. A sweep is 2m - 1 super-rounds; each pairs the blocks in the
//       round-robin order, and pair k goes to CTA k of a cluster of m CTAs
//       (up to 16, one matrix a cluster, launched with cudaLaunchKernelEx;
//       A and V^T in a float64 device-memory workspace the caller
//       allocates, resident in L2):
//         phase A: the CTA rotates its pair's [32, 32] sub-matrix S in
//           shared memory, accumulating Q^T ([32, 32], float64), and writes
//           S back. The first super-round of a sweep runs every pair of the
//           32 indices (31 rounds), the others only the 16 x 16 pairs across
//           the two blocks (16 rounds): the pairs within a block had theirs.
//           A round is 16 disjoint rotations: one 2 x 2 block of S and of
//           Q^T a thread, each lane computing its column pair's rotation
//           and taking its row pair's by a warp shuffle; S and Q^T are
//           double-buffered, so a round ends in one barrier;
//         cluster barrier;
//         phase B: the rest of A and V^T as [32, 32] products on the FP64
//           tensor cores (mma.sync m8n8k4), a warp a job: the off-diagonal
//           tile (k, j) of A becomes Q_k^T A[P_k, P_j] Q_j (written with its
//           transpose, so A stays symmetric), Q_j read from CTA j's shared
//           memory (distributed shared memory); V^T's rows P_k become
//           Q_k^T V^T[P_k, :], 32 columns a job;
//         cluster barrier.
//       Each rotation is a true Jacobi rotation of A (the rest of its rows
//       and columns only wait for the products), so a sweep is a cyclic
//       Jacobi sweep in a blocked order that rotates every index pair at
//       least once: n - 1 rounds, as the scalar order's, but each in one
//       block's shared memory;
//   * the sweeps stop once the off-diagonal squares fall to eps^2 times the
//     squared Frobenius norm (a NaN stops them too), or after max_sweeps
//     sweeps. The shared route sums them before each sweep; the cluster
//     route sums the squares it writes in a sweep's last super-round (it
//     rewrites all of A), each CTA its share, then across the cluster
//     through distributed shared memory in rank order, so every CTA takes
//     the same branch;
//   * the eigenvalues (A's diagonal) are ranked descending, ties broken by
//     index (a NaN ranks first), and written with their rows of V^T as
//     columns.
// An odd n on the shared route pairs one index a round with a virtual one,
// whose rotation is the identity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 512;
using U = double;  // the rotations' and V^T's type

// ---- helpers ------------------------------------------------------------ //

__device__ U sq(U x) { return x * x; }

// (c, s) of the Jacobi rotation annihilating a_pq (identity where it is 0):
// two reciprocal square roots in a row, no division
__device__ void rotation(U app, U aqq, U apq, U& c, U& s) {
  c = 1;
  s = 0;
  if (apq != U(0)) {
    const U d = aqq - app, a2 = 4 * apq * apq;
    const U r2 = d * d + a2;
    if (r2 > U(0)) {  // 0 only where a_pq^2 underflows and d = 0
      const U u = fabs(d) + r2 * rsqrt(r2);
      const U g = rsqrt(u * u + a2);
      c = u * g;
      s = (d >= 0 ? 2 * apq : -2 * apq) * g;
    }
  }
}

// round-robin pairing of N (even) items: item N - 1 is fixed, the others
// rotate; pair k of round r (r < N - 1, k < N / 2) is (p, q), p < q
__device__ __forceinline__ void rr_pair(int r, int k, int N, int& p, int& q) {
  int a = r + k, b = r - k + N - 1;  // modulo N - 1: each below 2 (N - 1)
  a -= a >= N - 1 ? N - 1 : 0;
  b -= b >= N - 1 ? N - 1 : 0;
  if (k == 0) a = N - 1, b = r;
  p = min(a, b);
  q = max(a, b);
}

// does eigenvalue (wj, j) rank before (wi, i)? descending, NaN first, ties by index
__device__ __forceinline__ bool ranks_before(U wj, int j, U wi, int i) {
  const bool nj = isnan(wj), ni = isnan(wi);
  if (nj != ni) return nj;
  if (nj) return j < i;
  return wj > wi || (wj == wi && j < i);
}

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

// ---- shared route: A and V^T of one matrix in one block ------------------ //

constexpr int kSharedThreads = 256;
constexpr int kSharedBytes = 232448;  // the opt-in limit of one block on sm_90

// Shared memory: the round's rotations and the sums' partials (float64),
// V^T (float64), A (the input's type), then the pairs and the ranks (int),
// so each part is aligned to its type.
__host__ __device__ constexpr size_t shared_scratch_bytes(int n) {
  return sizeof(U) * (2 * (n / 2 + 1) + kSharedThreads / 32) + sizeof(int) * (2 * (n / 2 + 1) + n);
}

template <typename T>
__global__ void __launch_bounds__(kSharedThreads)
shared_eigh_kernel(const T* __restrict__ A_in, T* __restrict__ w_out, T* __restrict__ V_out,
                   int* __restrict__ sweeps_out, int n, int max_sweeps, U eps) {
  constexpr int kThreads = kSharedThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = n * n, pairs = n / 2 + 1;
  U* rot_c = reinterpret_cast<U*>(smem_raw);
  U* rot_s = rot_c + pairs;
  U* scratch = rot_s + pairs;  // [kThreads / 32]
  U* Vt = scratch + kThreads / 32;  // [n][n], row i the i-th eigenvector
  T* A = reinterpret_cast<T*>(Vt + nn);  // [n][n], row-major
  int* pair_p = reinterpret_cast<int*>(A + nn);
  int* pair_q = pair_p + pairs;
  int* rank_of = pair_q + pairs;  // [n]

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
        int p, q;
        rr_pair(round, m, N, p, q);
        U c = 1, s = 0;
        if (q < n) rotation(U(A[p * n + p]), U(A[q * n + q]), U(A[p * n + q]), c, s);
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
    const U wi = A[i * n + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += ranks_before(U(A[j * n + j]), j, wi, i);
    rank_of[i] = rank;
    w_b[rank] = T(wi);
  }
  __syncthreads();
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / n, r = idx % n;
    V_b[r * n + rank_of[i]] = T(Vt[idx]);
  }
}

// ---- cluster route: blocked Jacobi, one matrix across a cluster ---------- //

constexpr int kB = 16;                // an index block
constexpr int kP = 2 * kB;            // a pair's indices: a warp's lanes
constexpr int kThreads = kP * kP / 4; // one 2 x 2 block of a pair's sub-matrix a thread: 256
constexpr int kWarps = kThreads / 32;
constexpr int kLd = kP + 1;           // padded row stride of S
// row stride of Q^T and of the warps' tiles: the tensor cores' fragment
// reads (8 rows x 4 columns, or 4 x 8) and the tiles' 16-byte writes each
// take the fewest shared-memory wavefronts
constexpr int kLq = kP + 4;
constexpr int kMaxCtas = kMaxN / kP;  // 16
constexpr int kPortableCtas = 8;
// shared memory (float64): S twice, Q^T twice, then per warp two [32, 36]
// tiles (a product's operand and result; a partner's Q^T), then the block
// sums' partials and the two values each CTA publishes to the cluster
constexpr int kTile = kP * kLq;
constexpr size_t kClusterBytes =
    sizeof(U) * (2 * kP * kLd + 2 * kTile + kWarps * 2 * kTile + kWarps + 2);

// global index of a pair's local index l: blocks bx, by of kB indices each
__device__ __forceinline__ int gidx(int bx, int by, int l) {
  return l < kB ? bx * kB + l : by * kB + (l - kB);
}

// D += A B on the FP64 tensor cores: an [8, 4] by [4, 8] product; lane
// (g, t) = (lane / 4, lane % 4) holds A[g][t], B[t][g] and D[g][2t .. 2t + 1]
__device__ __forceinline__ void dmma(U& d0, U& d1, U a, U b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

// acc = L R for [32, 32] operands in shared memory (row stride kLq), a warp:
// R is stored as it is, or (kRT) as its transpose; acc[I][J] is the [8, 8]
// tile (I, J) in the tensor cores' layout
template <bool kRT>
__device__ __forceinline__ void warp_mm(const U* __restrict__ L, const U* __restrict__ R,
                                        U (&acc)[4][4][2], int g, int t) {
#pragma unroll
  for (int I = 0; I < 4; ++I)
#pragma unroll
    for (int J = 0; J < 4; ++J) acc[I][J][0] = acc[I][J][1] = 0;
#pragma unroll
  for (int k4 = 0; k4 < kP / 4; ++k4) {
    U a[4], b[4];
#pragma unroll
    for (int I = 0; I < 4; ++I) a[I] = L[(8 * I + g) * kLq + 4 * k4 + t];
#pragma unroll
    for (int J = 0; J < 4; ++J)
      b[J] = kRT ? R[(8 * J + g) * kLq + 4 * k4 + t] : R[(4 * k4 + t) * kLq + 8 * J + g];
#pragma unroll
    for (int I = 0; I < 4; ++I)
#pragma unroll
      for (int J = 0; J < 4; ++J) dmma(acc[I][J][0], acc[I][J][1], a[I], b[J]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
cluster_eigh_kernel(const T* __restrict__ A_in, T* __restrict__ w_out, T* __restrict__ V_out,
                    U* __restrict__ work, int* __restrict__ sweeps_out, int n, int max_sweeps,
                    U eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int m = static_cast<int>(cluster.num_blocks());  // pairs of blocks, one a CTA
  const int rank = static_cast<int>(cluster.block_rank());
  const int N = m * kP, NB = 2 * m;
  const size_t mat = blockIdx.y;
  U* A = work + mat * 2 * N * N;  // [N][N], row-major, float64
  U* Vt = A + static_cast<size_t>(N) * N;  // [N][N], row i the i-th eigenvector
  extern __shared__ __align__(16) unsigned char smem_raw[];
  U* sbuf = reinterpret_cast<U*>(smem_raw);  // S: 2 x [kP][kLd]
  U* qbuf = sbuf + 2 * kP * kLd;             // Q^T: 2 x [kP][kLq]
  U* wbuf = qbuf + 2 * kTile;                // per warp: two [kP][kLq] tiles
  U* scratch = wbuf + kWarps * 2 * kTile;    // [kWarps]
  U* red = scratch + kWarps;                  // [2]: read by the whole cluster
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // the tensor cores' lane coordinates

  // A (the lower triangle, mirrored, zero-padded) and V^T = I, this CTA's
  // rows; the squares of A's entries and of its off-diagonal ones
  const T* Ab = A_in + mat * n * n;
  U off_l = 0, all_l = 0;
  for (int i = rank; i < N; i += m) {
    for (int j = tid; j < N; j += kThreads) {
      const U x = i < n && j < n ? U(i >= j ? Ab[i * n + j] : Ab[j * n + i]) : U(0);
      __stcg(A + static_cast<size_t>(i) * N + j, x);
      __stcg(Vt + static_cast<size_t>(i) * N + j, i == j ? U(1) : U(0));
      all_l += x * x;
      off_l += i == j ? U(0) : x * x;
    }
  }
  U part = block_sum<kThreads>(off_l, scratch);
  const U all_c = block_sum<kThreads>(all_l, scratch);
  if (tid == 0) {
    red[0] = part;
    red[1] = all_c;
  }
  cluster.sync();
  U off2 = 0, norm2 = 0;
  for (int r = 0; r < m; ++r) {  // in rank order: the same sums in every CTA
    const U* rr = cluster.map_shared_rank(red, r);
    off2 += rr[0];
    norm2 += rr[1];
  }

  // a pair's sub-matrix: all kP indices (m == 1: only the first n, or n + 1)
  const int Ni = m == 1 ? n + (n & 1) : kP;
  const int m1 = tid / (kP / 2), m2 = tid % (kP / 2);
  // the off-diagonal tiles (rank, j) this CTA updates: j = rank + d, d = 1 ..
  // (m - 1) / 2, and d = m / 2 for an even m on the lower half of the ranks
  const int ntiles = (m - 1) / 2 + (m % 2 == 0 && rank < m / 2 ? 1 : 0);
  const int njobs = ntiles + m;  // then V^T's m column chunks of kP
  U* Yb = wbuf + warp * 2 * kTile;  // a product's operand, then its result
  U* Qr = Yb + kTile;               // a partner's Q^T, then a result's transpose

  int sweep = 0;
  for (;; ++sweep) {
    if (sweep >= max_sweeps || !(off2 > sq(eps) * norm2)) break;  // uniform; NaN stops too
    for (int R = 0; R < NB - 1; ++R) {
      const bool last = R == NB - 2;  // its writes give the sweep's off-diagonal squares
      int bx, by;
      rr_pair(R, rank, NB, bx, by);
      // ---- phase A: a Jacobi sweep of S = A[P, P], accumulating Q^T ----- //
      // The first super-round of a sweep rotates every pair of the kP
      // indices (Ni - 1 rounds); the later ones only the pairs across the
      // two blocks (kB rounds): the pairs within a block had theirs in the
      // first.
      const bool full = R == 0;
      const int rounds = full ? Ni - 1 : kB;
#pragma unroll
      for (int idx = tid; idx < kP * kP; idx += kThreads) {
        const int r = idx / kP, c = idx % kP;
        const U x = __ldcg(A + static_cast<size_t>(gidx(bx, by, r)) * N + gidx(bx, by, c));
        sbuf[r * kLd + c] = sbuf[kP * kLd + r * kLd + c] = x;
        qbuf[r * kLq + c] = qbuf[kTile + r * kLq + c] = r == c ? U(1) : U(0);
      }
      __syncthreads();
      U *Sc = sbuf, *Sn = sbuf + kP * kLd, *Qc = qbuf, *Qn = qbuf + kTile;
      const bool active = full ? m1 < Ni / 2 && m2 < Ni / 2 : true;
      for (int r = 0; r < rounds; ++r) {
        // lane l of every warp computes the rotation of pair l mod 16 (the
        // thread's column pair m2); the row pair m1's comes from lane m1
        int p1, q1, p2, q2;
        if (full) {
          rr_pair(r, m1, Ni, p1, q1);
          rr_pair(r, m2, Ni, p2, q2);
        } else {  // block x's index i against block y's (i + r) mod kB
          p1 = m1, q1 = kB + ((m1 + r) & (kB - 1));
          p2 = m2, q2 = kB + ((m2 + r) & (kB - 1));
        }
        U c2 = 1, s2 = 0;
        if (!full || m2 < Ni / 2)
          rotation(Sc[p2 * kLd + p2], Sc[q2 * kLd + q2], Sc[p2 * kLd + q2], c2, s2);
        const U c1 = __shfl_sync(0xffffffffu, c2, m1);
        const U s1 = __shfl_sync(0xffffffffu, s2, m1);
        if (active) {
          const U x_pp = Sc[p1 * kLd + p2], x_pq = Sc[p1 * kLd + q2];
          const U x_qp = Sc[q1 * kLd + p2], x_qq = Sc[q1 * kLd + q2];
          const U r_pp = c1 * x_pp - s1 * x_qp, r_qp = s1 * x_pp + c1 * x_qp;
          const U r_pq = c1 * x_pq - s1 * x_qq, r_qq = s1 * x_pq + c1 * x_qq;
          const bool own = m1 == m2;
          Sn[p1 * kLd + p2] = c2 * r_pp - s2 * r_pq;
          Sn[p1 * kLd + q2] = own ? U(0) : s2 * r_pp + c2 * r_pq;
          Sn[q1 * kLd + p2] = own ? U(0) : c2 * r_qp - s2 * r_qq;
          Sn[q1 * kLd + q2] = s2 * r_qp + c2 * r_qq;
          // Q^T <- J1^T Q^T: rows p1, q1 at columns p2, q2
          const U v_pp = Qc[p1 * kLq + p2], v_pq = Qc[p1 * kLq + q2];
          const U v_qp = Qc[q1 * kLq + p2], v_qq = Qc[q1 * kLq + q2];
          Qn[p1 * kLq + p2] = c1 * v_pp - s1 * v_qp;
          Qn[q1 * kLq + p2] = s1 * v_pp + c1 * v_qp;
          Qn[p1 * kLq + q2] = c1 * v_pq - s1 * v_qq;
          Qn[q1 * kLq + q2] = s1 * v_pq + c1 * v_qq;
        }
        __syncthreads();
        U* tmp = Sc;
        Sc = Sn;
        Sn = tmp;
        tmp = Qc;
        Qc = Qn;
        Qn = tmp;
      }
      // the CTA's Q^T (the same buffer in every CTA: all ran `rounds` rounds)
      const U* Qk = Qc;
      off_l = 0;
#pragma unroll
      for (int idx = tid; idx < kP * kP; idx += kThreads) {  // the diagonal tile
        const int r = idx / kP, c = idx % kP;
        const U x = Sc[r * kLd + c];
        __stcg(A + static_cast<size_t>(gidx(bx, by, r)) * N + gidx(bx, by, c), x);
        off_l += r == c ? U(0) : x * x;
      }
      cluster.sync();  // every Q^T and diagonal tile is written

      // ---- phase B: the other tiles of A and V^T's rows, a warp a job, ---- //
      // ---- as [32, 32] products on the tensor cores                    ---- //
      const int gr = gidx(bx, by, lane);
      for (int job = warp; job < njobs; job += kWarps) {
        U acc[4][4][2];
        if (job < ntiles) {  // tile (rank, j): T = Q_k^T A[P_k, P_j] Q_j
          const int j = (rank + 1 + job) % m;
          int jx, jy;
          rr_pair(R, j, NB, jx, jy);
          const int gc = gidx(jx, jy, lane);
#pragma unroll
          for (int r = 0; r < kP; ++r)  // X, a row at a time: lane = column
            Yb[r * kLq + lane] = __ldcg(A + static_cast<size_t>(gidx(bx, by, r)) * N + gc);
          const double2* Qj = reinterpret_cast<const double2*>(cluster.map_shared_rank(Qk, j));
#pragma unroll
          for (int idx = lane; idx < kP * kP / 2; idx += 32) {  // all in flight at once
            const int o = (idx / (kP / 2)) * (kLq / 2) + idx % (kP / 2);
            reinterpret_cast<double2*>(Qr)[o] = Qj[o];
          }
          __syncwarp();
          warp_mm<false>(Qk, Yb, acc, g, t);  // Y = Q_k^T X
          __syncwarp();
#pragma unroll
          for (int I = 0; I < 4; ++I)
#pragma unroll
            for (int J = 0; J < 4; ++J)
              *reinterpret_cast<double2*>(Yb + (8 * I + g) * kLq + 8 * J + 2 * t) =
                  make_double2(acc[I][J][0], acc[I][J][1]);
          __syncwarp();
          warp_mm<true>(Yb, Qr, acc, g, t);  // T = Y Q_j (Qr holds Q_j^T)
          __syncwarp();
#pragma unroll
          for (int I = 0; I < 4; ++I) {  // T into Yb, T^T into Qr
#pragma unroll
            for (int J = 0; J < 4; ++J) {
              const U t0 = acc[I][J][0], t1 = acc[I][J][1];
              *reinterpret_cast<double2*>(Yb + (8 * I + g) * kLq + 8 * J + 2 * t) =
                  make_double2(t0, t1);
              Qr[(8 * J + 2 * t) * kLq + 8 * I + g] = t0;
              Qr[(8 * J + 2 * t + 1) * kLq + 8 * I + g] = t1;
              off_l += 2 * (t0 * t0 + t1 * t1);
            }
          }
          __syncwarp();
#pragma unroll
          for (int i = 0; i < kP; ++i) {  // A[P_k, P_j] = T and A[P_j, P_k] = T^T, by rows
            __stcg(A + static_cast<size_t>(gidx(bx, by, i)) * N + gc, Yb[i * kLq + lane]);
            __stcg(A + static_cast<size_t>(gidx(jx, jy, i)) * N + gr, Qr[i * kLq + lane]);
          }
          __syncwarp();
        } else {  // V^T's rows P_k, columns c0 .. c0 + kP: Q_k^T V^T[P_k, cols]
          const int c0 = (job - ntiles) * kP;
#pragma unroll
          for (int r = 0; r < kP; ++r)
            Yb[r * kLq + lane] = __ldcg(Vt + static_cast<size_t>(gidx(bx, by, r)) * N + c0 + lane);
          __syncwarp();
          warp_mm<false>(Qk, Yb, acc, g, t);
#pragma unroll
          for (int I = 0; I < 4; ++I)
#pragma unroll
            for (int J = 0; J < 4; ++J)
              __stcg(reinterpret_cast<double2*>(
                         Vt + static_cast<size_t>(gidx(bx, by, 8 * I + g)) * N + c0 + 8 * J + 2 * t),
                     make_double2(acc[I][J][0], acc[I][J][1]));
          __syncwarp();
        }
      }
      if (last) {  // this CTA's share of the off-diagonal squares, published
        part = block_sum<kThreads>(off_l, scratch);
        if (tid == 0) red[0] = part;
      }
      cluster.sync();  // the super-round's A and V^T are written
    }
    off2 = 0;
    for (int r = 0; r < m; ++r) off2 += cluster.map_shared_rank(red, r)[0];
  }

  if (sweeps_out != nullptr && rank == 0 && tid == 0) sweeps_out[mat] = sweep;

  // the eigenvalues: A's diagonal (padded indices stay 0 and never mix with
  // the first n); rank descending, then write w and V's columns, a warp an index
  U* diag = wbuf;
  __syncthreads();  // the warps' tiles are free
  for (int j = tid; j < n; j += kThreads) diag[j] = __ldcg(A + static_cast<size_t>(j) * N + j);
  __syncthreads();
  T* w_b = w_out + mat * n;
  T* V_b = V_out + mat * n * n;
  for (int i = rank + m * warp; i < n; i += m * kWarps) {
    const U wi = diag[i];
    int before = 0;
    for (int j = lane; j < n; j += 32) before += ranks_before(diag[j], j, wi, i);
    for (int off = 16; off > 0; off >>= 1) before += __shfl_xor_sync(0xffffffffu, before, off);
    if (lane == 0) w_b[before] = T(wi);
    for (int r = lane; r < n; r += 32)
      V_b[static_cast<size_t>(r) * n + before] = T(__ldcg(Vt + static_cast<size_t>(i) * N + r));
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- launches -------------------------------------------------------------- //

template <typename T>
int launch_shared(const void* A, void* w, void* V, int* sweeps, int batch, int n, int max_sweeps,
                  U eps, cudaStream_t stream) {
  const size_t smem = shared_scratch_bytes(n) + (sizeof(U) + sizeof(T)) * static_cast<size_t>(n) * n;
  if (smem > kSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(shared_eigh_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  shared_eigh_kernel<T><<<batch, kSharedThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V), sweeps, n, max_sweeps,
      eps);
  return static_cast<int>(cudaGetLastError());
}

// CTAs a matrix on the cluster route: ceil(n / 32)
constexpr int cluster_ctas(int n) { return (n + kP - 1) / kP; }

template <typename T>
int launch_cluster(const void* A, void* w, void* V, void* work, int* sweeps, int batch, int n,
                   int max_sweeps, U eps, cudaStream_t stream) {
  if (work == nullptr || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int m = cluster_ctas(n);
  auto kernel = cluster_eigh_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kClusterBytes));
  if (err == cudaSuccess && m > kPortableCtas)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kClusterBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = m;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster the card cannot place is an error, never a silent fallback
  // (asked once a size: the answer depends only on the card and the kernel)
  static int placeable[kMaxCtas + 1] = {};
  if (placeable[m] == 0) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    placeable[m] = clusters > 0 ? 1 : -1;
  }
  if (placeable[m] < 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(A), static_cast<T*>(w),
                           static_cast<T*>(V), static_cast<U*>(work), sweeps, n, max_sweeps, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* A, void* w, void* V, void* work, void* sweeps, int batch, int n,
           int max_sweeps, double eps, int cluster_route, void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto* s = static_cast<int*>(sweeps);
  auto* st = static_cast<cudaStream_t>(stream);
  return cluster_route ? launch_cluster<T>(A, w, V, work, s, batch, n, max_sweeps, eps, st)
                       : launch_shared<T>(A, w, V, s, batch, n, max_sweeps, eps, st);
}

}  // namespace

// Plain C interface (ctypes): A is [batch, n, n] contiguous, w [batch, n] and
// V [batch, n, n] are written, and each matrix's sweep count to sweeps
// [batch] unless it is null; eps is the input type's. cluster_route 0 keeps A
// and V^T in one block's shared memory (an error where they do not fit; work
// is null); 1 launches a cluster of ceil(n / 32) CTAs a matrix on the
// workspace work ([batch, 2, N, N] float64, N = 32 ceil(n / 32)), which the
// caller allocates. Returns the launch's CUDA error code, 0 on success (an
// error where the card cannot place the cluster); nothing synchronises.
extern "C" {

int small_eigh_f32(const void* A, void* w, void* V, void* work, void* sweeps, int batch, int n,
                   int max_sweeps, double eps, int cluster_route, void* stream) {
  return launch<float>(A, w, V, work, sweeps, batch, n, max_sweeps, eps, cluster_route, stream);
}

int small_eigh_f64(const void* A, void* w, void* V, void* work, void* sweeps, int batch, int n,
                   int max_sweeps, double eps, int cluster_route, void* stream) {
  return launch<double>(A, w, V, work, sweeps, batch, n, max_sweeps, eps, cluster_route, stream);
}

}  // extern "C"

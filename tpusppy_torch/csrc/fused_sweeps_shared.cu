// Fused shared-A ADMM sweep block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel tpusppy/solvers/pallas_kernels.py
// `_shared_sweeps_kernel` / `fused_sweeps_shared` (at precision "highest").
// It runs one `n_sweeps` block of the shared-A engine's sweep
// (tpusppy_torch/solvers/shared_admm.py `_core`), where every scenario
// shares ONE constraint matrix A (m, n) and ONE x-update system K (n, n)
// with its explicit inverse, and scenario s scales the whole penalty
// profile by gamma_s:
//
//   rhs = g sigma x - q + A'(g rho_a z - y) + (g rho_x zx - yx)
//   xt  = K^-1 (rhs / g), then passes xt += K^-1 ((rhs - (g K xt + dq2 xt))/g)
//         (n_refine passes, plus n_extra when the batch-global flag `has`
//          = any(dq2 != 0) is set; it is read on the device)
//   x   = alpha xt + (1-alpha) x,            Ax = alpha A xt + (1-alpha) Ax
//   z   = clip(alpha A xt + (1-alpha) z + y/(g rho_a), cl, cu),  y += ...
//   zx  = clip(alpha xt + (1-alpha) zx + yx/(g rho_x), lb, ub),  yx += ...
//
// Bound at the main-path shape (uc_lite defaults: S=1000, m=242, n=132,
// n_sweeps=4, n_refine=2, n_extra=2 with has=1).  A sweep is
// 2(2mn + n^2 (1 + 2 n_refine + 2 n_extra)) = 441 kflop per scenario,
// 1.77 GFLOP per call: 26 us at 67 TFLOP/s, the card's peak in f32 (CUDA
// cores) and in f64 (tensor cores; this kernel's CUDA-core FMAs reach half
// of it).  The
// call moves ~13 MB in f32 (each input read once, each output written
// once): 4 us at 3.35 TB/s.  The call is bound by operations.
//
// Why the TPU design does not carry over: it holds A, K^-1 and K in VMEM,
// (mn + 2n^2) * 4 B = 267 KB at this shape, more than the 227 KB of shared
// memory a Hopper block may use.  So here nothing needs the matrices to
// fit: one thread block owns a tile of SB scenarios (SB = 8 when it fits;
// the ragged last tile is masked) and reads A and A' straight from device
// memory, where every block reads the same bytes and finds them in the
// 50 MB L2 after the first.  K^-1, then K, is copied into shared memory
// when it still fits beside the tile's buffers (both in f32 at the
// main-path shape, K^-1 alone in f64), else it streams like A.  The tile's
// buffers are its contraction operands (rhs, the K^-1 input w, x-tilde:
// three n-vectors per scenario, and one chunk of the A' input), stored
// index-major with the SB scenario values of an index side by side, so
// that every (SB, k) @ (k, j) contraction (A'v, K^-1 w, K xt, and A xt
// against the transposed copy At) gives each thread one output column j
// and all SB scenarios: one coalesced matrix load feeds SB FMAs, and the
// SB operand values come in one vector load that the warp broadcasts.
// When the columns leave threads idle, the k range is split among thread
// groups whose partial sums are added in a fixed order.
// The state vectors stay in the output buffers in device memory (the tile
// reads and writes them once per sweep), so no shape limit comes from m.
// What bounds it in practice: each block re-reads A and A' every sweep, so
// L2 traffic is their bytes times S/SB tiles, and every contraction ends in
// a block-wide barrier.  Larger tiles over thread-block clusters and
// tensor-core MMA are the known next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps_shared.so fused_sweeps_shared.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Threads per block; cuda_kernels._SHARED_THREADS mirrors it.
constexpr int kThreads = 512;
// Shared memory one block may use on Hopper (cuda_kernels.SMEM_LIMIT).
constexpr size_t kSmemLimit = 232448;

// min(max(v, lo), hi) with NaN propagating like torch.clamp.
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  T r = (v < lo) ? lo : v;
  return (r > hi) ? hi : r;
}

// One value per scenario of the tile, kept in registers.
template <typename T, int SB>
struct Tile {
  T v[SB];
};

// The SB values at p (shared memory, aligned to SB elements), in 16-byte
// loads where the tile allows.
template <typename T, int SB>
__device__ __forceinline__ Tile<T, SB> load_tile(const T* p) {
  Tile<T, SB> t;
  if constexpr (std::is_same_v<T, float> && SB % 4 == 0) {
#pragma unroll
    for (int c = 0; c < SB / 4; ++c) {
      const float4 a = reinterpret_cast<const float4*>(p)[c];
      t.v[4 * c] = a.x;
      t.v[4 * c + 1] = a.y;
      t.v[4 * c + 2] = a.z;
      t.v[4 * c + 3] = a.w;
    }
  } else if constexpr (std::is_same_v<T, double> && SB % 2 == 0) {
#pragma unroll
    for (int c = 0; c < SB / 2; ++c) {
      const double2 a = reinterpret_cast<const double2*>(p)[c];
      t.v[2 * c] = a.x;
      t.v[2 * c + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int s = 0; s < SB; ++s) t.v[s] = p[s];
  }
  return t;
}

// Terms summed into one partial sum before it joins the running total.
constexpr int kSumBlock = 32;

// sum_{k0 <= k < k1} in[k * SB + s] * M[k * ncol + col] for each s: part of
// one output column of an (SB, kd) @ (kd, ncol) product.  Consecutive
// threads take consecutive columns, so each matrix load is coalesced (or
// conflict-free when M sits in shared memory, kShared) and feeds SB FMAs,
// and the operand loads are warp-wide broadcasts.  The sum runs in blocks
// of kSumBlock terms: no rounding chain is longer than kSumBlock plus the
// number of blocks, so a wide n (thousands of terms, one thread each) keeps
// the f32 accuracy of a narrow one.
template <typename T, int SB, bool kShared>
__device__ __forceinline__ Tile<T, SB> column_dot(const T* in, const T* M,
                                                  int k0, int k1, int ncol,
                                                  int col) {
  Tile<T, SB> acc;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = T(0);
  const T* mcol = M + col;
  for (int kb = k0; kb < k1; kb += kSumBlock) {
    const int ke = k1 - kb < kSumBlock ? k1 : kb + kSumBlock;
    Tile<T, SB> blk;
#pragma unroll
    for (int s = 0; s < SB; ++s) blk.v[s] = T(0);
#pragma unroll 4
    for (int k = kb; k < ke; ++k) {
      const long long at = static_cast<long long>(k) * ncol;
      const T mk = kShared ? mcol[at] : __ldg(mcol + at);
      const Tile<T, SB> v = load_tile<T, SB>(in + k * SB);
#pragma unroll
      for (int s = 0; s < SB; ++s) blk.v[s] += v.v[s] * mk;
    }
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[s] += blk.v[s];
  }
  return acc;
}

// out = in @ M for the tile, in (SB, kd) and M (kd, O) row-major; then
// epi(o, acc) for every output column o, with acc the column's SB scenario
// values.  When O leaves threads over, the reduction over k is split among
// G groups of threads whose partial sums meet in `part` (G * O * SB values)
// and are added in group order.  Ends with a barrier; every thread of the
// block must call it.
template <typename T, int SB, bool kShared, typename Epi>
__device__ __forceinline__ void contract(const T* in, const T* M, int kd,
                                         int O, T* part, Epi epi) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = (O + 31) / 32 * 32;
  const int G = W >= nt ? 1 : nt / W;
  if (G == 1) {
    for (int o = tid; o < O; o += nt) {
      epi(o, column_dot<T, SB, kShared>(in, M, 0, kd, O, o));
    }
    __syncthreads();
    return;
  }
  const int g = tid / W, o = tid - g * W;
  if (g < G && o < O) {
    const Tile<T, SB> acc = column_dot<T, SB, kShared>(
        in, M, kd * g / G, kd * (g + 1) / G, O, o);
    T* dst = part + (static_cast<long long>(g) * O + o) * SB;
#pragma unroll
    for (int s = 0; s < SB; ++s) dst[s] = acc.v[s];
  }
  __syncthreads();
  if (tid < O) {
    Tile<T, SB> acc = load_tile<T, SB>(part + tid * SB);
    for (int h = 1; h < G; ++h) {
      const Tile<T, SB> v = load_tile<T, SB>(
          part + (static_cast<long long>(h) * O + tid) * SB);
#pragma unroll
      for (int s = 0; s < SB; ++s) acc.v[s] += v.v[s];
    }
    epi(tid, acc);
  }
  __syncthreads();
}

template <typename T, int SB>
__global__ void __launch_bounds__(kThreads, 1) fused_sweeps_shared_kernel(
    const T* __restrict__ q, const T* __restrict__ A,
    const T* __restrict__ At, const T* __restrict__ Kinv,
    const T* __restrict__ K, const T* __restrict__ cl,
    const T* __restrict__ cu, const T* __restrict__ lb,
    const T* __restrict__ ub, const T* __restrict__ rho_a,
    const T* __restrict__ rho_x, const T* __restrict__ dq2,
    const T* __restrict__ has, const T* __restrict__ gamma,
    const T* __restrict__ x_in, const T* __restrict__ z_in,
    const T* __restrict__ zx_in, const T* __restrict__ y_in,
    const T* __restrict__ yx_in, const T* __restrict__ Ax_in,
    T* __restrict__ x, T* __restrict__ z, T* __restrict__ zx,
    T* __restrict__ y, T* __restrict__ yx, T* __restrict__ Ax, int S, int m,
    int n, int chunk, int resident, int n_sweeps, int n_refine,
    int n_extra, T sigma, T alpha, T beta) {
  using V = Tile<T, SB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);  // (SB) the tile's gammas
  T* srhs = gs + SB;         // (n, SB) rhs, first the A'v partial sums
  T* sw = srhs + n * SB;     // (n, SB) the K^-1 input: rhs/g, then r/g
  T* sxt = sw + n * SB;      // (n, SB) x-tilde
  T* sv = sxt + n * SB;      // (chunk, SB) a chunk of v = g rho_a z - y
  T* part = sv + chunk * SB; // (kThreads, SB) split-k partial sums
  T* sKinv = part + kThreads * SB;                  // (n, n) if resident & 1
  T* sK = sKinv + ((resident & 1) ? n * n : 0);     // (n, n) if resident & 2

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long s0 = static_cast<long long>(blockIdx.x) * SB;
  const int ns = static_cast<int>(S - s0 < SB ? S - s0 : SB);
  const long long on = s0 * n;
  const long long om = s0 * m;

  // the tile's state moves into the outputs, which carry it across sweeps;
  // K^-1 and K move into shared memory where they fit (unrolled, so each
  // thread keeps several loads in flight)
#pragma unroll 4
  for (int e = tid; e < ns * n; e += nt) {
    x[on + e] = x_in[on + e];
    zx[on + e] = zx_in[on + e];
    yx[on + e] = yx_in[on + e];
  }
#pragma unroll 4
  for (int e = tid; e < ns * m; e += nt) {
    z[om + e] = z_in[om + e];
    y[om + e] = y_in[om + e];
    Ax[om + e] = Ax_in[om + e];
  }
  if (resident & 1) {
#pragma unroll 8
    for (int e = tid; e < n * n; e += nt) sKinv[e] = __ldg(Kinv + e);
  }
  if (resident & 2) {
#pragma unroll 8
    for (int e = tid; e < n * n; e += nt) sK[e] = __ldg(K + e);
  }
  if (tid < SB) gs[tid] = tid < ns ? gamma[s0 + tid] : T(1);
  const int n_pass = n_refine + (has[0] > T(0) ? n_extra : 0);
  __syncthreads();

  auto apply_kinv = [&](const T* in, auto epi) {
    if (resident & 1) {
      contract<T, SB, true>(in, sKinv, n, n, part, epi);
    } else {
      contract<T, SB, false>(in, Kinv, n, n, part, epi);
    }
  };
  auto apply_k = [&](const T* in, auto epi) {
    if (resident & 2) {
      contract<T, SB, true>(in, sK, n, n, part, epi);
    } else {
      contract<T, SB, false>(in, K, n, n, part, epi);
    }
  };

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    // rhs partial sums: A'v over row chunks of v = g rho_a z - y
    for (int e = tid; e < n * SB; e += nt) srhs[e] = T(0);
    for (int i0 = 0; i0 < m; i0 += chunk) {
      const int cn = m - i0 < chunk ? m - i0 : chunk;
      __syncthreads();
      for (int e = tid; e < SB * cn; e += nt) {
        const int s = e / cn, ii = e - s * cn;
        T v = T(0);
        if (s < ns) {
          const long long r = om + static_cast<long long>(s) * m + i0 + ii;
          v = gs[s] * rho_a[i0 + ii] * z[r] - y[r];
        }
        sv[ii * SB + s] = v;
      }
      __syncthreads();
      contract<T, SB, false>(sv, A + static_cast<long long>(i0) * n, cn, n,
                             part, [&](int j, const V& acc) {
#pragma unroll
                               for (int s = 0; s < SB; ++s)
                                 srhs[j * SB + s] += acc.v[s];
                             });
    }
    __syncthreads();
    // rhs = ((g sigma x - q) + A'v) + (g rho_x zx - yx); w = rhs / g
    for (int e = tid; e < SB * n; e += nt) {
      const int s = e / n, j = e - s * n;
      T rhs = T(0), w = T(0);
      if (s < ns) {
        const long long r = on + static_cast<long long>(s) * n + j;
        const T g = gs[s];
        rhs = ((g * sigma) * x[r] - q[r] + srhs[j * SB + s]) +
              ((g * rho_x[j]) * zx[r] - yx[r]);
        w = rhs / g;
      }
      srhs[j * SB + s] = rhs;
      sw[j * SB + s] = w;
    }
    __syncthreads();
    // xt = K^-1 w
    apply_kinv(sw, [&](int j, const V& acc) {
#pragma unroll
      for (int s = 0; s < SB; ++s) sxt[j * SB + s] = acc.v[s];
    });
    // refinement against the exact per-scenario system g K + diag(dq2)
    for (int pass = 0; pass < n_pass; ++pass) {
      apply_k(sxt, [&](int j, const V& acc) {
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const T d =
              s < ns ? dq2[on + static_cast<long long>(s) * n + j] : T(0);
          const T xt = sxt[j * SB + s];
          sw[j * SB + s] =
              (srhs[j * SB + s] - (gs[s] * acc.v[s] + d * xt)) / gs[s];
        }
      });
      apply_kinv(sw, [&](int j, const V& acc) {
#pragma unroll
        for (int s = 0; s < SB; ++s) sxt[j * SB + s] += acc.v[s];
      });
    }
    // x, zx, yx updates; nothing below writes x-tilde
    for (int e = tid; e < ns * n; e += nt) {
      const int s = e / n, j = e - s * n;
      const long long r = on + e;
      const T rx = gs[s] * rho_x[j];
      const T xt = alpha * sxt[j * SB + s];
      const T zxa = xt + beta * zx[r];
      const T zxn = clip(zxa + yx[r] / rx, lb[r], ub[r]);
      yx[r] = yx[r] + rx * (zxa - zxn);
      zx[r] = zxn;
      x[r] = xt + beta * x[r];
    }
    // Axt = xt A' (At is A transposed), and each row's z, y, Ax update
    contract<T, SB, false>(sxt, At, n, m, part, [&](int i, const V& acc) {
      const T ra0 = rho_a[i];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        if (s < ns) {
          const long long r = om + static_cast<long long>(s) * m + i;
          const T ra = gs[s] * ra0;
          const T axt = alpha * acc.v[s];
          const T za = axt + beta * z[r];
          const T zn = clip(za + y[r] / ra, cl[r], cu[r]);
          y[r] = y[r] + ra * (za - zn);
          z[r] = zn;
          Ax[r] = axt + beta * Ax[r];
        }
      }
    });
  }
}

template <typename T, int SB>
int launch_tile(void* const* in, void* const* out, int S, int m, int n,
                int chunk, int n_sweeps, int n_refine, int n_extra,
                double sigma, double alpha, void* stream) {
  // cuda_kernels.shared_smem_bytes mirrors this: the tile's buffers, then
  // K^-1 and, after it, K, each where it still fits
  size_t smem =
      sizeof(T) * SB * (1 + 3 * static_cast<size_t>(n) + chunk + kThreads);
  const size_t mat = sizeof(T) * static_cast<size_t>(n) * n;
  int resident = 0;
  if (smem + mat <= kSmemLimit) {
    resident |= 1;
    smem += mat;
    if (smem + mat <= kSmemLimit) {
      resident |= 2;
      smem += mat;
    }
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_sweeps_shared_kernel<T, SB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto o = [&](int k) { return static_cast<T*>(out[k]); };
  const int grid = (S + SB - 1) / SB;
  fused_sweeps_shared_kernel<T, SB>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8), c(9), c(10),
          c(11), c(12), c(13), c(14), c(15), c(16), c(17), c(18), c(19),
          o(0), o(1), o(2), o(3), o(4), o(5), S, m, n, chunk, resident,
          n_sweeps, n_refine, n_extra, static_cast<T>(sigma), static_cast<T>(alpha),
          static_cast<T>(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* const* in, void* const* out, int S, int m, int n, int sb,
           int chunk, int n_sweeps, int n_refine, int n_extra, double sigma,
           double alpha, void* stream) {
  if (S < 1 || n < 1 || m < 0 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cuda_kernels.SHARED_TILES mirrors these cases
  switch (sb) {
    case 8:
      return launch_tile<T, 8>(in, out, S, m, n, chunk, n_sweeps, n_refine,
                               n_extra, sigma, alpha, stream);
    case 4:
      return launch_tile<T, 4>(in, out, S, m, n, chunk, n_sweeps, n_refine,
                               n_extra, sigma, alpha, stream);
    case 2:
      return launch_tile<T, 2>(in, out, S, m, n, chunk, n_sweeps, n_refine,
                               n_extra, sigma, alpha, stream);
    case 1:
      return launch_tile<T, 1>(in, out, S, m, n, chunk, n_sweeps, n_refine,
                               n_extra, sigma, alpha, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// in:  q, A, At, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma,
//      x, z, zx, y, yx, Ax   (At: A transposed, (n, m) row-major)
// out: x, z, zx, y, yx, Ax
// Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_shared_f32(void* const* in, void* const* out, int S,
                                    int m, int n, int sb, int chunk,
                                    int n_sweeps, int n_refine, int n_extra,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<float>(in, out, S, m, n, sb, chunk, n_sweeps, n_refine,
                       n_extra, sigma, alpha, stream);
}

int tpusppy_fused_sweeps_shared_f64(void* const* in, void* const* out, int S,
                                    int m, int n, int sb, int chunk,
                                    int n_sweeps, int n_refine, int n_extra,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<double>(in, out, S, m, n, sb, chunk, n_sweeps, n_refine,
                        n_extra, sigma, alpha, stream);
}

}  // extern "C"

// Fused shared-A ADMM sweep block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel tpusppy/solvers/pallas_kernels.py
// `_shared_sweeps_kernel` / `fused_sweeps_shared`, at each of its
// precisions ("highest", and the lowered modes of the streamed mode).
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
// cores) and in f64 (tensor cores).  The call moves ~13 MB in f32 (each
// input read once, each output written once): 4 us at 3.35 TB/s.  The call
// is bound by operations.
//
// Two modes (cuda_kernels.shared_mode picks; the wrapper counts launches
// by mode in cuda_kernels.shared_modes).  Where the matrices fit one CTA
// (C = 1) the resident mode runs: it loads them once a CTA, not once a
// tile.  Where they need C >= 2 CTAs the resident mode gives a tile C
// SMs, the streamed mode one, so the resident mode runs where every tile
// has a cluster at once (tpusppy_fused_sweeps_shared_clusters_* reads how
// many the card holds) and the streamed mode wherever tiles would queue
// for a cluster: at uc_lite's shape on an H100 the resident mode up to
// S = 528 (f32) and 176 (f64), the streamed mode on the main path's
// S = 1000.
//
// Cluster-resident: the shared matrices, (mn + 2n^2) *
// itemsize = 267 KB in f32 at this shape, do not fit one block's 227 KB of
// shared memory, but they fit a thread-block cluster's.  A cluster of C
// CTAs (C = 2 in f32 and 5 in f64 at this shape: the smallest C whose
// slices fit beside the tile's buffers) holds them whole: CTA r keeps
// columns [j0, j1) of A, K^-1 and K, packed by the wrapper once for each
// new set of matrices and brought in with one bulk asynchronous copy
// (cp.async.bulk on an mbarrier) per call, not once per tile.  Clusters
// are persistent and walk the tiles of 8 scenarios.  Each product (A'v, every K^-1 and K apply)
// gives the CTA its slice of the output columns, whose epilogue applies
// the elementwise update and writes the slice into every CTA's operand
// buffer through distributed shared memory; one cluster barrier follows.
// A xt is summed over the CTA's own columns for every row, and the partial
// sums are reduce-scattered, each CTA adding its rows' in rank order (no
// atomics; runs are deterministic).  The tile's state stays in shared
// memory for the whole call: each CTA reads its slice (x, zx, yx of its
// columns, z, y, Ax of its rows, with their bounds) once and writes it
// once.  f32 products run on FFMA (exact f32, as the reference's
// "highest"): in the column products (A'v, K^-1 w, K xt) the warps split k
// into contiguous shares and a lane holds three output columns by the 8
// scenarios (one conflict-free matrix-row read and one broadcast operand
// read feed 24 multiply-adds), the warps' sums meeting in shared memory in
// warp order; in A xt a thread holds a pair of rows over a strided share
// of k, its lanes' sums meeting by butterfly shuffles.  Sums run in blocks
// of 32 terms.  f64 products run on the tensor cores (mma.sync m16n8k16
// .f64): output columns on m16, the tile's 8 scenarios on n8, k on k16,
// slices padded to 16 columns; warps left over split the k16 steps.
//
// Streamed (more tiles than clusters, and shapes whose slices do not fit
// even across 8 CTAs): one thread block owns a tile of SB scenarios and reads A and A' from device
// memory and L2, K^-1 and K from shared memory where they fit; every
// (SB, k) @ (k, j) contraction gives each thread one output column for
// all SB scenarios, with the k range split among thread groups whose
// partial sums are added in a fixed order.  The state vectors stay in the
// output buffers in device memory, so no shape limit comes from m.
//
// The mixed-precision modes (PREC 1 "default", 2 "high"; the TPU kernel's
// `_pdot` on `_prep_mat`'s splits, pallas_kernels.py:233-308) run in the
// streamed mode (cuda_kernels.shared_mode sends them there): the A', K^-1
// and A xt products take their matrix as its bf16 parts M1 (and M2), made
// once per set of matrices by the wrapper (cuda_kernels.shared_lowered)
// and read through L2 (K^-1's parts from shared memory where they fit),
// and their operand as its bf16 parts u1 (and u2), split once where the
// operand is written; "default" sums u1 M1, "high" (bf16x3) u1 M1 + u1 M2
// + u2 M1, every bf16 product exact and the sums in the working type.  The
// K defect stays exact.  The products run on CUDA cores (a tensor-core
// path is later work), so "default" costs what "highest" does and "high"
// three products a product.
//
// What was measured (scripts/port_shared_ablation.py, chip_smoke.py,
// PERF.md; H100 SXM at 700 W): in the streamed mode at uc_lite's shape the
// products themselves take most of the call (the K^-1 and K applies 0.13
// of 0.22 ms in f32).  In the resident mode each product is a phase with
// a fixed cost beside its arithmetic (the cluster barrier, the warps'
// partial sums, the hand-off), ~0.12 ms a round of tiles in f32 and f64:
// at S = 128 (16 tiles, one round) it takes 0.128 ms in f32 and 0.126 in
// f64 against the streamed mode's 0.222 and 0.322; at S = 1000 the 125
// tiles take two rounds of the 66 clusters of 2 (f32) and six of the 22
// clusters of 5 (f64), 0.249 and 0.703 ms against 0.225 and 0.326.  With
// C = 1 (m = 50, n = 22) the resident mode is faster at every S measured.
//
// The stop flag: the solve loop runs its sweep blocks as CUDA-graph
// replays (tpusppy_torch/solvers/device_loop.py) and keeps its exit vote in
// a device int that stays set once set.  Every CTA of either mode reads it
// first and returns where it is set, before any mbarrier, bulk copy or
// cluster barrier; an earlier kernel of the stream wrote it, so every CTA
// of a cluster reads the same value and none waits on a partner that has
// left.  A block past the loop's exit costs one launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps_shared.so fused_sweeps_shared.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

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

// A bf16 matrix entry as f32: from shared memory (kShared) or through the
// read-only cache.
template <bool kShared>
__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  if constexpr (kShared) {
    return __bfloat162float(*p);
  } else {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
}

// The mixed-precision column_dot (pallas_kernels._pdot): the operand comes
// as its bf16 parts u1 (in1) and, with kHigh, u2 (in2), held in T, and M as
// its bf16 parts M1, M2; "default" sums u1 M1, "high" (bf16x3) u1 M1 + u1 M2
// + u2 M1, the low-low product dropped.  Every product of two bf16 values
// is exact in f32 and f64, and the sums run in T (the TPU kernel's
// preferred_element_type=dt), u1 M1 and the two cross products in separate
// sums added at the end, as the reference adds its three products.
template <typename T, int SB, bool kShared, bool kHigh>
__device__ __forceinline__ Tile<T, SB> column_dot_lo(
    const T* in1, const T* in2, const __nv_bfloat16* M1,
    const __nv_bfloat16* M2, int k0, int k1, int ncol, int col) {
  Tile<T, SB> acc, lo;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = lo.v[s] = T(0);
  for (int kb = k0; kb < k1; kb += kSumBlock) {
    const int ke = k1 - kb < kSumBlock ? k1 : kb + kSumBlock;
    Tile<T, SB> blk, blo;
#pragma unroll
    for (int s = 0; s < SB; ++s) blk.v[s] = blo.v[s] = T(0);
#pragma unroll 4
    for (int k = kb; k < ke; ++k) {
      const long long at = static_cast<long long>(k) * ncol + col;
      const T m1 = static_cast<T>(bf16_at<kShared>(M1 + at));
      const Tile<T, SB> v1 = load_tile<T, SB>(in1 + k * SB);
#pragma unroll
      for (int s = 0; s < SB; ++s) blk.v[s] += v1.v[s] * m1;
      if constexpr (kHigh) {
        const T m2 = static_cast<T>(bf16_at<kShared>(M2 + at));
        const Tile<T, SB> v2 = load_tile<T, SB>(in2 + k * SB);
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          blo.v[s] += v1.v[s] * m2;
          blo.v[s] += v2.v[s] * m1;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      acc.v[s] += blk.v[s];
      lo.v[s] += blo.v[s];
    }
  }
  if constexpr (kHigh) {
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[s] += lo.v[s];
  }
  return acc;
}

// v's bf16 parts (through f32, round to nearest even), held in T: u1 =
// bf16(f32(v)), u2 = bf16(f32(v) - u1) (the subtraction is exact in f32).
template <typename T>
__device__ __forceinline__ void split_bf16(T v, T& u1, T& u2) {
  const float f = static_cast<float>(v);
  const float h = __bfloat162float(__float2bfloat16_rn(f));
  u1 = static_cast<T>(h);
  u2 = static_cast<T>(__bfloat162float(__float2bfloat16_rn(f - h)));
}

// out = in @ M for the tile, in (SB, kd) and M (kd, O) row-major, with
// col(k0, k1, o) the sum over k0 <= k < k1 of output column o's SB values;
// then epi(o, acc) for every output column o, with acc the column's SB
// scenario values.  When O leaves threads over, the reduction over k is
// split among G groups of threads whose partial sums meet in `part` (G * O
// * SB values) and are added in group order.  Ends with a barrier; every
// thread of the block must call it.
template <typename T, int SB, typename Col, typename Epi>
__device__ __forceinline__ void contract_cols(int kd, int O, T* part, Col col,
                                              Epi epi) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = (O + 31) / 32 * 32;
  const int G = W >= nt ? 1 : nt / W;
  if (G == 1) {
    for (int o = tid; o < O; o += nt) epi(o, col(0, kd, o));
    __syncthreads();
    return;
  }
  const int g = tid / W, o = tid - g * W;
  if (g < G && o < O) {
    const Tile<T, SB> acc = col(kd * g / G, kd * (g + 1) / G, o);
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

// The exact product: in @ M with M in the working type.
template <typename T, int SB, bool kShared, typename Epi>
__device__ __forceinline__ void contract(const T* in, const T* M, int kd,
                                         int O, T* part, Epi epi) {
  contract_cols<T, SB>(kd, O, part, [&](int k0, int k1, int o) {
    return column_dot<T, SB, kShared>(in, M, k0, k1, O, o);
  }, epi);
}

// The mixed-precision product: (in1, in2) @ (M1, M2), column_dot_lo's.
template <typename T, int SB, bool kShared, bool kHigh, typename Epi>
__device__ __forceinline__ void contract_lo(const T* in1, const T* in2,
                                            const __nv_bfloat16* M1,
                                            const __nv_bfloat16* M2, int kd,
                                            int O, T* part, Epi epi) {
  contract_cols<T, SB>(kd, O, part, [&](int k0, int k1, int o) {
    return column_dot_lo<T, SB, kShared, kHigh>(in1, in2, M1, M2, k0, k1, O,
                                                o);
  }, epi);
}

// PREC: 0 exact ("highest"), 1 "default" (one bf16 product), 2 "high"
// (bf16x3).  At PREC > 0 `mats` is the wrapper's bf16 operand
// (cuda_kernels.shared_lowered): part p at mats + p (2 m n + n n), holding
// A (m, n), A' (n, m) and K^-1 (n, n); at PREC 0 it is A' in T.
template <typename T, int SB, int PREC>
__global__ void __launch_bounds__(kThreads, 1) fused_sweeps_shared_kernel(
    const T* __restrict__ q, const T* __restrict__ A,
    const void* __restrict__ mats, const T* __restrict__ Kinv,
    const T* __restrict__ K, const T* __restrict__ cl,
    const T* __restrict__ cu, const T* __restrict__ lb,
    const T* __restrict__ ub, const T* __restrict__ rho_a,
    const T* __restrict__ rho_x, const T* __restrict__ dq2,
    const T* __restrict__ has, const T* __restrict__ gamma,
    const T* __restrict__ x_in, const T* __restrict__ z_in,
    const T* __restrict__ zx_in, const T* __restrict__ y_in,
    const T* __restrict__ yx_in, const T* __restrict__ Ax_in,
    T* __restrict__ x, T* __restrict__ z, T* __restrict__ zx,
    T* __restrict__ y, T* __restrict__ yx, T* __restrict__ Ax,
    const int* __restrict__ stop, int S, int m, int n, int chunk,
    int resident, int n_sweeps, int n_refine, int n_extra, T sigma, T alpha,
    T beta) {
  if (*stop) return;  // the solve loop's stop flag (see the top)
  using V = Tile<T, SB>;
  constexpr bool kLow = PREC > 0, kHigh = PREC == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);  // (SB) the tile's gammas
  T* srhs = gs + SB;         // (n, SB) rhs, first the A'v partial sums
  T* sw = srhs + n * SB;     // (n, SB) the K^-1 input: rhs/g, then r/g
                             // (its bf16 part u1 in the mixed modes)
  T* sxt = sw + n * SB;      // (n, SB) x-tilde
  T* sv = sxt + n * SB;      // (chunk, SB) a chunk of v = g rho_a z - y
                             // (its part u1 in the mixed modes)
  T* part = sv + chunk * SB; // (kThreads, SB) split-k partial sums
  // the mixed modes: the operands' second parts u2, then K where it fits,
  // then K^-1's bf16 parts where they fit; the exact mode: K^-1, then K
  T* sw2 = part + kThreads * SB;              // (n, SB) u2 of the K^-1 or
                                              // A xt operand
  T* sv2 = sw2 + (kLow ? n * SB : 0);         // (chunk, SB) u2 of v
  T* sKinv = part + kThreads * SB;            // (n, n) if resident & 1
  T* sK = sKinv + ((resident & 1) ? n * n : 0);  // (n, n) if resident & 2
  const __nv_bfloat16* sKi1 = nullptr;
  const __nv_bfloat16* sKi2 = nullptr;
  if constexpr (kLow) {
    sK = sv2 + chunk * SB;
    __nv_bfloat16* kp = reinterpret_cast<__nv_bfloat16*>(
        sK + ((resident & 2) ? n * n : 0));
    sKi1 = kp;
    sKi2 = kp + static_cast<long long>(n) * n;
  }
  const long long mn = static_cast<long long>(m) * n;
  const long long per_part = 2 * mn + static_cast<long long>(n) * n;
  const __nv_bfloat16* lo = static_cast<const __nv_bfloat16*>(mats);
  const __nv_bfloat16* A1 = lo;
  const __nv_bfloat16* At1 = lo + mn;
  const __nv_bfloat16* Ki1 = lo + 2 * mn;
  const __nv_bfloat16* A2 = A1 + per_part;
  const __nv_bfloat16* At2 = At1 + per_part;
  const __nv_bfloat16* Ki2 = Ki1 + per_part;
  const T* At = static_cast<const T*>(mats);

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
    if constexpr (kLow) {
      __nv_bfloat16* d1 = const_cast<__nv_bfloat16*>(sKi1);
      __nv_bfloat16* d2 = const_cast<__nv_bfloat16*>(sKi2);
#pragma unroll 8
      for (int e = tid; e < n * n; e += nt) {
        d1[e] = Ki1[e];
        if (kHigh) d2[e] = Ki2[e];
      }
    } else {
#pragma unroll 8
      for (int e = tid; e < n * n; e += nt) sKinv[e] = __ldg(Kinv + e);
    }
  }
  if (resident & 2) {
#pragma unroll 8
    for (int e = tid; e < n * n; e += nt) sK[e] = __ldg(K + e);
  }
  if (tid < SB) gs[tid] = tid < ns ? gamma[s0 + tid] : T(1);
  const int n_pass = n_refine + (has[0] > T(0) ? n_extra : 0);
  __syncthreads();

  // xt (= or +=) K^-1 w: the mixed modes read w's parts (sw, sw2)
  auto apply_kinv = [&](auto epi) {
    if constexpr (kLow) {
      if (resident & 1) {
        contract_lo<T, SB, true, kHigh>(sw, sw2, sKi1, sKi2, n, n, part, epi);
      } else {
        contract_lo<T, SB, false, kHigh>(sw, sw2, Ki1, Ki2, n, n, part, epi);
      }
    } else if (resident & 1) {
      contract<T, SB, true>(sw, sKinv, n, n, part, epi);
    } else {
      contract<T, SB, false>(sw, Kinv, n, n, part, epi);
    }
  };
  auto apply_k = [&](const T* in, auto epi) {
    if (resident & 2) {
      contract<T, SB, true>(in, sK, n, n, part, epi);
    } else {
      contract<T, SB, false>(in, K, n, n, part, epi);
    }
  };
  // the K^-1 operand w at slot d: itself, or its bf16 parts
  auto put_w = [&](int d, T w) {
    if constexpr (kLow) {
      split_bf16(w, sw[d], sw2[d]);
    } else {
      sw[d] = w;
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
        if constexpr (kLow) {
          split_bf16(v, sv[ii * SB + s], sv2[ii * SB + s]);
        } else {
          sv[ii * SB + s] = v;
        }
      }
      __syncthreads();
      auto add = [&](int j, const V& acc) {
#pragma unroll
        for (int s = 0; s < SB; ++s) srhs[j * SB + s] += acc.v[s];
      };
      if constexpr (kLow) {
        const long long off = static_cast<long long>(i0) * n;
        contract_lo<T, SB, false, kHigh>(sv, sv2, A1 + off, A2 + off, cn, n,
                                         part, add);
      } else {
        contract<T, SB, false>(sv, A + static_cast<long long>(i0) * n, cn, n,
                               part, add);
      }
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
      put_w(j * SB + s, w);
    }
    __syncthreads();
    // xt = K^-1 w
    apply_kinv([&](int j, const V& acc) {
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
          put_w(j * SB + s,
                (srhs[j * SB + s] - (gs[s] * acc.v[s] + d * xt)) / gs[s]);
        }
      });
      apply_kinv([&](int j, const V& acc) {
#pragma unroll
        for (int s = 0; s < SB; ++s) sxt[j * SB + s] += acc.v[s];
      });
    }
    // x, zx, yx updates; nothing below writes x-tilde (the mixed modes put
    // its bf16 parts, the A xt operand, in sw and sw2)
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
    auto row_update = [&](int i, const V& acc) {
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
    };
    if constexpr (kLow) {
      for (int e = tid; e < n * SB; e += nt) split_bf16(sxt[e], sw[e], sw2[e]);
      __syncthreads();
      contract_lo<T, SB, false, kHigh>(sw, sw2, At1, At2, n, m, part,
                                       row_update);
    } else {
      contract<T, SB, false>(sxt, At, n, m, part, row_update);
    }
  }
}

template <typename T, int SB, int PREC>
int launch_tile(void* const* in, void* const* out, const int* stop, int S,
                int m, int n, int chunk, int n_sweeps, int n_refine,
                int n_extra, double sigma, double alpha, void* stream) {
  // cuda_kernels.shared_smem_bytes mirrors this: the tile's buffers, then
  // K^-1 and, after it, K, each where it still fits; the mixed modes keep
  // the operands' second parts (one more n-vector, a second chunk) and
  // K^-1 as its bf16 parts
  size_t smem, kin;
  if (PREC > 0) {
    smem = sizeof(T) * SB *
           (1 + 4 * static_cast<size_t>(n) + 2 * static_cast<size_t>(chunk) +
            kThreads);
    kin = 2 * (PREC == 2 ? 2 : 1) * static_cast<size_t>(n) * n;
  } else {
    smem = sizeof(T) * SB * (1 + 3 * static_cast<size_t>(n) + chunk + kThreads);
    kin = sizeof(T) * static_cast<size_t>(n) * n;
  }
  const size_t mat = sizeof(T) * static_cast<size_t>(n) * n;
  int resident = 0;
  if (smem + kin <= kSmemLimit) {
    resident |= 1;
    smem += kin;
    if (smem + mat <= kSmemLimit) {
      resident |= 2;
      smem += mat;
    }
  }
  // raised once to the largest size asked, so that a launch captured into
  // a CUDA graph after a first (warm-up) launch makes no attribute call
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_sweeps_shared_kernel<T, SB, PREC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto o = [&](int k) { return static_cast<T*>(out[k]); };
  const int grid = (S + SB - 1) / SB;
  fused_sweeps_shared_kernel<T, SB, PREC>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          c(0), c(1), in[2], c(3), c(4), c(5), c(6), c(7), c(8), c(9), c(10),
          c(11), c(12), c(13), c(14), c(15), c(16), c(17), c(18), c(19),
          o(0), o(1), o(2), o(3), o(4), o(5), stop, S, m, n, chunk, resident,
          n_sweeps, n_refine, n_extra, static_cast<T>(sigma), static_cast<T>(alpha),
          static_cast<T>(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PREC>
int launch_prec(void* const* in, void* const* out, const int* stop, int S,
                int m, int n, int sb, int chunk, int n_sweeps, int n_refine,
                int n_extra, double sigma, double alpha, void* stream) {
  // cuda_kernels.SHARED_TILES mirrors these cases; the lowered modes are
  // built for tiles of 8, 4 and 2 (cuda_kernels._streamed_layout asks no
  // smaller tile of them)
  switch (sb) {
    case 8:
      return launch_tile<T, 8, PREC>(in, out, stop, S, m, n, chunk, n_sweeps,
                                     n_refine, n_extra, sigma, alpha, stream);
    case 4:
      return launch_tile<T, 4, PREC>(in, out, stop, S, m, n, chunk, n_sweeps,
                                     n_refine, n_extra, sigma, alpha, stream);
    case 2:
      return launch_tile<T, 2, PREC>(in, out, stop, S, m, n, chunk, n_sweeps,
                                     n_refine, n_extra, sigma, alpha, stream);
    default:
      break;
  }
  if constexpr (PREC == 0) {
    if (sb == 1) {
      return launch_tile<T, 1, 0>(in, out, stop, S, m, n, chunk, n_sweeps,
                                  n_refine, n_extra, sigma, alpha, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(void* const* in, void* const* out, const int* stop, int S, int m,
           int n, int sb, int chunk, int n_sweeps, int n_refine, int n_extra,
           int prec, double sigma, double alpha, void* stream) {
  if (S < 1 || n < 1 || m < 0 || chunk < 1 || stop == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (prec) {
    case 0:
      return launch_prec<T, 0>(in, out, stop, S, m, n, sb, chunk, n_sweeps,
                               n_refine, n_extra, sigma, alpha, stream);
    case 1:
      return launch_prec<T, 1>(in, out, stop, S, m, n, sb, chunk, n_sweeps,
                               n_refine, n_extra, sigma, alpha, stream);
    case 2:
      return launch_prec<T, 2>(in, out, stop, S, m, n, sb, chunk, n_sweeps,
                               n_refine, n_extra, sigma, alpha, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the cluster-resident mode ---------------------------------------------

// Threads per CTA of the resident mode (cuda_kernels._RESIDENT_THREADS):
// eight warps (ten measured no faster).
constexpr int kResThreads = 256;
// Scenarios per tile of the resident mode (cuda_kernels.RESIDENT_TILE): the
// n8 side of the f64 tensor-core tile.
constexpr int kResTile = 8;

// Outputs a lane of an f32 product holds (for all the tile's scenarios): a
// warp covers 32 * kColsPerLane outputs a pass.
constexpr int kColsPerLane = 3;

// Columns of n a CTA's slice is cut in: 16 in f64 (the m16 side of the
// tensor-core tile), 2 in f32 (a thread's column pair).
template <typename T>
__host__ __device__ constexpr int col_unit() {
  return std::is_same_v<T, double> ? 16 : 2;
}

__host__ __device__ constexpr long long r16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// Byte offsets of the resident mode's shared buffers (each 16-byte
// aligned); cuda_kernels.shared_layout mirrors this.  ld: the columns of
// a CTA's slice (padded); km, kn: the rows of its A and K slices (padded
// to 16 in f64); mcm: the most rows of m a CTA owns.
struct ResLayout {
  long long bar, gam, mats, v, w, xt, rhs, part, cols, col_stride, rows,
      row_stride, total;
  __host__ __device__ ResLayout(long long ld, long long km, long long kn,
                                long long mcm, long long isz,
                                long long split) {
    const long long sb = kResTile;
    long long o = 0;
    bar = o;  // the mbarrier of the matrices' copy
    o += 16;
    gam = o;
    o += r16(sb * isz);
    mats = o;  // A (km, ld), K^-1 (kn, ld), K (kn, ld): this CTA's columns
    o += r16((km + 2 * kn) * ld * isz);
    v = o;  // (km, SB) g rho_a z - y, every row
    o += r16(km * sb * isz);
    w = o;  // (kn, SB) the K^-1 input, every column
    o += r16(kn * sb * isz);
    xt = o;  // (kn + ld, SB) x-tilde, every column (zero rows past n)
    o += r16((kn + ld) * sb * isz);
    rhs = o;  // (ld, SB) this CTA's columns
    o += r16(ld * sb * isz);
    part = o;  // (km, SB) A xt over this CTA's columns, every row; the
               // column products' per-warp partial sums (split values)
    o += r16((km * sb > split ? km * sb : split) * isz);
    cols = o;  // x, zx, yx, q, lb, ub, dq2 of this CTA's columns
    col_stride = r16(ld * sb * isz);
    o += 7 * col_stride;
    rows = o;  // z, y, Ax, cl, cu of this CTA's rows
    row_stride = r16(mcm * sb * isz);
    o += 5 * row_stride;
    total = o;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the mbarrier's phase; a copy that never lands ends the launch
// with an error after ~2^30 tries, not a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 30)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// d += A B on the f64 tensor cores for one warp (m16n8k16): with
// g = lane / 4 and q = lane % 4, A (16 x 16) a[v] at row g + 8 (v % 2),
// column q + 4 (v / 2); B (16 x 8) b[v] at row q + 4 v, column g; d
// (16 x 8) d[v] at row g + 8 (v / 2), column 2 q + v % 2.
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A xt over this CTA's columns for every row: out(i, s) = sum_{k < kd}
// M[i * ld + k] * in[k * SB + s] for i < O, then epi(i, s, out).  f32 on
// FFMA: a thread takes a pair of rows for all SB scenarios (16 sums in
// registers) over every ks-th k, in blocks of kSumBlock terms (no rounding
// chain grows with the k range); the ks threads of a pair are adjacent
// lanes, whose sums meet by butterfly shuffles, the same order in every
// run, and share the epilogue.  ks, a power of two, is as large as the
// block's threads allow.  (Warps splitting k, as in the column products,
// measured slower here: 242 rows in three passes.)
template <int SB, typename Epi>
__device__ __forceinline__ void product_rows(const float* in, const float* M,
                                             int ld, int O, int kd, float*,
                                             Epi epi) {
  const int so = ld, sk = 1;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int np = (O + 1) / 2;
  int ks = 1;
  while (ks < 32 && np * ks * 2 <= nt) ks *= 2;
  const int units = np * ks;
  for (int base = tid & ~31; base < units; base += nt) {
    const int u = base + lane;
    const bool live = u < units;
    const int kg = u & (ks - 1), p = u / ks;
    const int o0 = 2 * p, o1 = 2 * p + 1 < O ? 2 * p + 1 : 2 * p;
    float acc[2][SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) acc[0][s] = acc[1][s] = 0.f;
    if (live) {
      const float* m0 = M + static_cast<long long>(o0) * so;
      const float* m1 = M + static_cast<long long>(o1) * so;
      for (int kb = kg; kb < kd; kb += ks * kSumBlock) {
        const int ke = kd - kb < ks * kSumBlock ? kd : kb + ks * kSumBlock;
        float b0[SB], b1[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) b0[s] = b1[s] = 0.f;
#pragma unroll 4
        for (int k = kb; k < ke; k += ks) {
          const float a0 = m0[static_cast<long long>(k) * sk];
          const float a1 = m1[static_cast<long long>(k) * sk];
          const Tile<float, SB> v = load_tile<float, SB>(in + k * SB);
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            b0[s] += v.v[s] * a0;
            b1[s] += v.v[s] * a1;
          }
        }
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          acc[0][s] += b0[s];
          acc[1][s] += b1[s];
        }
      }
    }
    for (int off = ks >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        acc[0][s] += __shfl_xor_sync(0xffffffffu, acc[0][s], off);
        acc[1][s] += __shfl_xor_sync(0xffffffffu, acc[1][s], off);
      }
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < 2 * SB; ++e) {
        const int o = e < SB ? 2 * p : 2 * p + 1;
        if ((e & (ks - 1)) == kg && o < O) {
          epi(o, e % SB, acc[e / SB][e % SB]);
        }
      }
    }
  }
}

// The same in f64 on the tensor cores (mma m16n8k16): a warp takes 16 rows
// (the m16 side) for the tile's 8 scenarios (n8) over every k (k16 steps);
// kd is a multiple of 16, and M and `in` hold zeros past the real rows and
// columns.  No partial sums: `part` is unused.
template <int SB, typename Epi>
__device__ __forceinline__ void product_rows(const double* in,
                                             const double* M, int ld, int O,
                                             int kd, double*, Epi epi) {
  const int so = ld, sk = 1;
  static_assert(SB == 8, "the n8 side of the tile holds 8 scenarios");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int ntile = (O + 15) / 16;
  for (int t = warp; t < ntile; t += nw) {
    const int o0 = 16 * t;
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    const double* mr0 = M + static_cast<long long>(o0 + g8) * so;
    const double* mr1 = M + static_cast<long long>(o0 + g8 + 8) * so;
    for (int kb = 0; kb < kd; kb += 16) {
      double a[8], b[4];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const long long k = kb + tq + 4 * (v >> 1);
        a[v] = ((v & 1) ? mr1 : mr0)[k * sk];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = in[(kb + tq + 4 * v) * SB + g8];
      dmma(d, a, b);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int o = o0 + g8 + 8 * (v >> 1);
      if (o < O) epi(o, 2 * tq + (v & 1), d[v]);
    }
  }
}

// Barrier of every thread of every CTA of the cluster, ordering their
// shared-memory writes before the reads that follow (barrier.cluster with
// release/acquire; every thread reaches it converged).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Values of the column products' per-warp partial sums (the `part` buffer,
// which they share with A xt's partial sums); cuda_kernels mirrors it.
template <typename T>
__host__ __device__ constexpr long long split_values(int warps) {
  return std::is_same_v<T, double>
             ? static_cast<long long>(warps) * 16 * kResTile
             : static_cast<long long>(warps) * 32 * kColsPerLane * kResTile;
}

// out(o, s) = sum_{k < kd} in[k * SB + s] * M[k * ld + o] for o < O, then
// epi(o, s, out) once for each: the products whose outputs are this CTA's
// columns (A'v, K^-1 w, K xt).  f32 on FFMA: the warps split the k range
// into contiguous shares, and within a warp lane l holds columns l, l + 32,
// l + 64 for all SB scenarios, so a k step is one conflict-free matrix row
// read and one broadcast operand read for 24 multiply-adds; each warp's
// sums (in blocks of kSumBlock terms) go to `part`, and after a barrier
// each output adds the warps' sums in warp order.  epi(o, s, out) returns
// the value the product hands on, and put(o, s0, v) stores the 16 bytes
// of scenarios s0.. of output o (in every CTA's operand buffer).
template <int SB, typename Epi, typename Put>
__device__ __forceinline__ void product_cols(const float* in, const float* M,
                                             int ld, int O, int kd,
                                             float* part, Epi epi, Put put) {
  constexpr int CPL = kColsPerLane, NW = kResThreads / 32;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = kd * warp / NW, k1 = kd * (warp + 1) / NW;
  for (int base = 0; base < O; base += 32 * CPL) {
    float acc[CPL][SB];
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc[c][s] = 0.f;
    int col[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int o = base + 32 * c + lane;
      col[c] = o < O ? o : O - 1;
    }
    for (int kb = k0; kb < k1; kb += kSumBlock) {
      const int ke = k1 - kb < kSumBlock ? k1 : kb + kSumBlock;
      float blk[CPL][SB];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int s = 0; s < SB; ++s) blk[c][s] = 0.f;
#pragma unroll 4
      for (int k = kb; k < ke; ++k) {
        const float* row = M + static_cast<long long>(k) * ld;
        float a[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) a[c] = row[col[c]];
        const Tile<float, SB> v = load_tile<float, SB>(in + k * SB);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int s = 0; s < SB; ++s) blk[c][s] += v.v[s] * a[c];
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int s = 0; s < SB; ++s) acc[c][s] += blk[c][s];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      float* dst = part + ((warp * CPL + c) * 32 + lane) * SB;
#pragma unroll
      for (int s = 0; s < SB; s += 4) {
        *reinterpret_cast<float4*>(dst + s) =
            make_float4(acc[c][s], acc[c][s + 1], acc[c][s + 2],
                        acc[c][s + 3]);
      }
    }
    __syncthreads();
    const int width = O - base < 32 * CPL ? O - base : 32 * CPL;
    for (int e = tid; e < width * SB / 4; e += nt) {
      const int q = e / (SB / 4), s0 = 4 * (e - q * (SB / 4));  // q = 32 c + lane
      float4 p[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        p[w] = *reinterpret_cast<const float4*>(
            part + ((w * CPL) * 32 + q) * SB + s0);
      }
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        v.x += p[w].x;
        v.y += p[w].y;
        v.z += p[w].z;
        v.w += p[w].w;
      }
      put(base + q, s0,
          make_float4(epi(base + q, s0, v.x), epi(base + q, s0 + 1, v.y),
                      epi(base + q, s0 + 2, v.z), epi(base + q, s0 + 3, v.w)));
    }
    if (base + 32 * CPL < O) __syncthreads();  // `part` is reused
  }
}

// The same in f64 on the tensor cores (mma m16n8k16): 16 output columns
// (m16) by the tile's 8 scenarios (n8) a warp tile; when the column tiles
// leave warps over, the warps split the k16 steps into G groups whose
// sums meet in `part` in group order.  kd is a multiple of 16, and M and
// `in` hold zeros past the real rows and columns.
template <int SB, typename Epi, typename Put>
__device__ __forceinline__ void product_cols(const double* in,
                                             const double* M, int ld, int O,
                                             int kd, double* part, Epi epi,
                                             Put put) {
  static_assert(SB == 8, "the n8 side of the tile holds 8 scenarios");
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int ntile = (O + 15) / 16, nks = kd / 16;
  // d = this warp's share (k16 steps ks0..ks1) of column tile t
  auto tile = [&](int t, int ks0, int ks1, double (&d)[4]) {
    const double* mt = M + 16 * t + g8;
    for (int ks = ks0; ks < ks1; ++ks) {
      const int kb = 16 * ks;
      double a[8], b[4];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        a[v] = mt[static_cast<long long>(kb + tq + 4 * (v >> 1)) * ld +
                  8 * (v & 1)];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) b[v] = in[(kb + tq + 4 * v) * SB + g8];
      dmma(d, a, b);
    }
  };
  if (ntile == 0) return;
  if (ntile >= nw) {
    for (int t = warp; t < ntile; t += nw) {
      double d[4] = {0.0, 0.0, 0.0, 0.0};
      tile(t, 0, nks, d);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * t + g8 + 8 * h;
        if (o < O) {
          put(o, 2 * tq, make_double2(epi(o, 2 * tq, d[2 * h]),
                                      epi(o, 2 * tq + 1, d[2 * h + 1])));
        }
      }
    }
    return;
  }
  const int G = nw / ntile;
  const int t = warp % ntile, gi = warp / ntile;
  if (gi < G) {
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    tile(t, nks * gi / G, nks * (gi + 1) / G, d);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      part[((gi * ntile + t) * 16 + g8 + 8 * (v >> 1)) * SB + 2 * tq +
           (v & 1)] = d[v];
    }
  }
  __syncthreads();
  for (int e = tid; e < O * SB / 2; e += nt) {
    const int o = e / (SB / 2), s0 = 2 * (e - o * (SB / 2));
    double2 v = make_double2(0.0, 0.0);
    for (int g = 0; g < G; ++g) {
      const double2 p = *reinterpret_cast<const double2*>(
          part + ((g * ntile) * 16 + o) * SB + s0);
      v.x += p.x;
      v.y += p.y;
    }
    put(o, s0, make_double2(epi(o, s0, v.x), epi(o, s0 + 1, v.y)));
  }
}

// One ADMM sweep block with the shared matrices resident across a cluster
// of C CTAs.  CTA `rank` holds columns [j0, j1) of A, K^-1 and K (one bulk
// copy a call) and owns those columns' x, zx, yx and rows [i0, i1)'s z, y,
// Ax of the tile.  Each product gives the CTA's slice of its output, which
// goes to every CTA's operand buffer through distributed shared memory,
// followed by one cluster barrier; A xt is summed over the CTA's columns
// for every row and the partial sums are reduce-scattered in rank order.
// Clusters are persistent and walk the scenario tiles.
template <typename T>
__global__ void __launch_bounds__(kResThreads, 1) fused_sweeps_shared_resident(
    const T* __restrict__ q, const T* __restrict__ packed,
    const T* __restrict__ cl, const T* __restrict__ cu,
    const T* __restrict__ lb, const T* __restrict__ ub,
    const T* __restrict__ rho_a, const T* __restrict__ rho_x,
    const T* __restrict__ dq2, const T* __restrict__ has,
    const T* __restrict__ gamma, const T* __restrict__ x_in,
    const T* __restrict__ z_in, const T* __restrict__ zx_in,
    const T* __restrict__ y_in, const T* __restrict__ yx_in,
    const T* __restrict__ Ax_in, T* __restrict__ x, T* __restrict__ z,
    T* __restrict__ zx, T* __restrict__ y, T* __restrict__ yx,
    T* __restrict__ Ax, const int* __restrict__ stop, int S, int m, int n,
    int C, int ld, int km, int kn, int n_sweeps, int n_refine, int n_extra,
    T sigma, T alpha, T beta) {
  // the stop flag (see the top): every CTA of the cluster reads the same
  // value and leaves before the cluster's first barrier
  if (*stop) return;
  constexpr int SB = kResTile;
  constexpr int U = col_unit<T>();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mcm = (m + C - 1) / C;
  const ResLayout L(ld, km, kn, mcm, sizeof(T),
                    split_values<T>(kResThreads / 32));
  auto at = [&](long long off) { return reinterpret_cast<T*>(smem_raw + off); };
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + L.bar);
  T* gs = at(L.gam);
  const T* sA = at(L.mats);
  const T* sKi = sA + static_cast<long long>(km) * ld;
  const T* sK = sKi + static_cast<long long>(kn) * ld;
  T* sv = at(L.v);
  T* sw = at(L.w);
  T* sxt = at(L.xt);
  T* srhs = at(L.rhs);
  // the column products' per-warp partial sums, and on them A xt's
  // partial sums (A xt itself needs none)
  T* ssplit = at(L.part);
  T* spart = ssplit;
  const long long cst = L.col_stride / sizeof(T);
  const long long rst = L.row_stride / sizeof(T);
  T* sx = at(L.cols);
  T* szx = sx + cst;
  T* syx = szx + cst;
  T* sq = syx + cst;
  T* slb = sq + cst;
  T* sub = slb + cst;
  T* sdq = sub + cst;
  T* sz = at(L.rows);
  T* sy = sz + rst;
  T* sAx = sy + rst;
  T* scl = sAx + rst;
  T* scu = scl + rst;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  const int NU = (n + U - 1) / U;
  const int j0 = U * (rank * NU / C);
  const int j1e = U * ((rank + 1) * NU / C);
  const int nc = (j1e < n ? j1e : n) - j0;
  const int i0 = static_cast<int>(static_cast<long long>(rank) * m / C);
  const int mc = static_cast<int>(static_cast<long long>(rank + 1) * m / C) - i0;

  // this CTA's slices of A, K^-1 and K: one bulk copy a call
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (tid == 0) {
    const uint32_t bytes = static_cast<uint32_t>(L.v - L.mats);
    const T* src = packed + static_cast<long long>(rank) * (bytes / sizeof(T));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_addr(bar)),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(sA)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
  // the operand buffers' rows past m and n stay zero (the f64 products
  // run over 16-row steps)
  for (long long e = tid; e < (L.rhs - L.v) / static_cast<long long>(sizeof(T));
       e += nt) {
    sv[e] = T(0);
  }
  mbar_wait(bar, 0);
  cluster_sync();  // every CTA's buffers are zeroed before any exchange

  // rows [r0, r0 + nr) of `buf` (SB values each), which this CTA has just
  // written, to the same rows of every other CTA's `buf`: 16 bytes a
  // thread a store, all threads at once
  auto push = [&](T* buf, int r0, int nr) {
    using V = std::conditional_t<std::is_same_v<T, double>, double2, float4>;
    constexpr int kPer = 16 / sizeof(T);
    __syncthreads();
    const int nvec = nr * SB / kPer;
    const V* src = reinterpret_cast<const V*>(buf + r0 * SB);
    for (int e = tid; e < nvec * (C - 1); e += nt) {
      const int g = e / nvec, i = e - g * nvec;
      V* dst = reinterpret_cast<V*>(
          cluster.map_shared_rank(buf + r0 * SB, g < rank ? g : g + 1));
      dst[i] = src[i];
    }
  };
  auto x_update = [=](int j, int s, T xt) {
    const int d = j * SB + s;
    const T rx = gs[s] * rho_x[j0 + j];
    const T xa = alpha * xt;
    const T zxa = xa + beta * szx[d];
    const T zxn = clip(zxa + syx[d] / rx, slb[d], sub[d]);
    syx[d] = syx[d] + rx * (zxa - zxn);
    szx[d] = zxn;
    sx[d] = xa + beta * sx[d];
  };
  // 16 bytes of a column product's output (scenarios s0.. of this CTA's
  // column o) into `buf` of every CTA of the cluster
  using V16 = std::conditional_t<std::is_same_v<T, double>, double2, float4>;
  auto to_all = [=](T* buf) {
    return [=](int o, int s0, V16 val) {
      T* p = buf + (j0 + o) * SB + s0;
      for (int r = 0; r < C; ++r) {
        *reinterpret_cast<V16*>(cluster.map_shared_rank(p, r)) = val;
      }
    };
  };
  // xt (= or +=) K^-1 w for this CTA's columns; the last apply of a sweep
  // also updates x, zx, yx
  auto apply_kinv = [&](bool first, bool last) {
    product_cols<SB>(sw, sKi, ld, nc, kn, ssplit, [=](int j, int s, T acc) {
      const T xt = first ? acc : sxt[(j0 + j) * SB + s] + acc;
      if (last) x_update(j, s, xt);
      return xt;
    }, to_all(sxt));
  };
  // w = (rhs - (g K xt + dq2 xt)) / g for this CTA's columns
  auto apply_k = [&]() {
    product_cols<SB>(sxt, sK, ld, nc, kn, ssplit, [=](int j, int s, T acc) {
      const int d = j * SB + s;
      return (srhs[d] - (gs[s] * acc + sdq[d] * sxt[(j0 + j) * SB + s])) /
             gs[s];
    }, to_all(sw));
  };

  const int n_pass = n_refine + (has[0] > T(0) ? n_extra : 0);
  const int ntiles = (S + SB - 1) / SB;
  for (int tile = cid; tile < ntiles; tile += ncl) {
    const long long s0 = static_cast<long long>(tile) * SB;
    const int ns = static_cast<int>(S - s0 < SB ? S - s0 : SB);
    if (tid < SB) gs[tid] = tid < ns ? gamma[s0 + tid] : T(1);
    // the tile's state and bounds of this CTA's columns and rows, index-
    // major (the SB values of an index side by side); ragged slots zero
    for (int e = tid; e < SB * ld; e += nt) {
      const int s = e / ld, j = e - s * ld, d = j * SB + s;
      const bool live = s < ns && j < nc;
      const long long r = (s0 + s) * n + j0 + j;
      sx[d] = live ? x_in[r] : T(0);
      szx[d] = live ? zx_in[r] : T(0);
      syx[d] = live ? yx_in[r] : T(0);
      sq[d] = live ? q[r] : T(0);
      slb[d] = live ? lb[r] : T(0);
      sub[d] = live ? ub[r] : T(0);
      sdq[d] = live ? dq2[r] : T(0);
    }
    for (int e = tid; e < SB * mcm; e += nt) {
      const int s = e / mcm, i = e - s * mcm, d = i * SB + s;
      const bool live = s < ns && i < mc;
      const long long r = (s0 + s) * m + i0 + i;
      sz[d] = live ? z_in[r] : T(0);
      sy[d] = live ? y_in[r] : T(0);
      sAx[d] = live ? Ax_in[r] : T(0);
      scl[d] = live ? cl[r] : T(0);
      scu[d] = live ? cu[r] : T(0);
    }
    __syncthreads();
    // v = g rho_a z - y of this CTA's rows, to every CTA
    for (int d = tid; d < mc * SB; d += nt) {
      const int i = d / SB, s = d - i * SB;
      sv[(i0 + i) * SB + s] = gs[s] * rho_a[i0 + i] * sz[d] - sy[d];
    }
    push(sv, i0, mc);
    cluster_sync();
    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      // rhs: A'v for this CTA's columns
      product_cols<SB>(sv, sA, ld, nc, km, ssplit, [=](int j, int s, T acc) {
        const int d = j * SB + s;
        const T g = gs[s];
        const T rhs = ((g * sigma) * sx[d] - sq[d] + acc) +
                      ((g * rho_x[j0 + j]) * szx[d] - syx[d]);
        srhs[d] = rhs;
        return rhs / g;
      }, to_all(sw));
      cluster_sync();
      apply_kinv(true, n_pass == 0);
      cluster_sync();
      // refinement against the exact per-scenario system g K + diag(dq2)
      for (int pass = 0; pass < n_pass; ++pass) {
        apply_k();
        cluster_sync();
        apply_kinv(false, pass == n_pass - 1);
        cluster_sync();
      }
      // A xt over this CTA's columns, for every row
      product_rows<SB>(sxt + static_cast<long long>(j0) * SB, sA, ld, m, ld,
                       ssplit,
                       [=](int i, int s, T acc) { spart[i * SB + s] = acc; });
      cluster_sync();
      // the partial sums of this CTA's rows, added in rank order; then their
      // z, y, Ax and the next sweep's v
      for (int d = tid; d < mc * SB; d += nt) {
        const int i = d / SB, s = d - i * SB;
        const int e = (i0 + i) * SB + s;
        T a = T(0);
        for (int r = 0; r < C; ++r) a += *cluster.map_shared_rank(spart + e, r);
        const T ra = gs[s] * rho_a[i0 + i];
        const T axt = alpha * a;
        const T za = axt + beta * sz[d];
        const T zn = clip(za + sy[d] / ra, scl[d], scu[d]);
        sy[d] = sy[d] + ra * (za - zn);
        sz[d] = zn;
        sAx[d] = axt + beta * sAx[d];
        sv[e] = ra * sz[d] - sy[d];
      }
      if (sweep + 1 < n_sweeps) push(sv, i0, mc);
      cluster_sync();
    }
    // the tile's state out; each slot is read by the thread that loaded it
    for (int e = tid; e < SB * ld; e += nt) {
      const int s = e / ld, j = e - s * ld, d = j * SB + s;
      if (s < ns && j < nc) {
        const long long r = (s0 + s) * n + j0 + j;
        x[r] = sx[d];
        zx[r] = szx[d];
        yx[r] = syx[d];
      }
    }
    for (int e = tid; e < SB * mcm; e += nt) {
      const int s = e / mcm, i = e - s * mcm, d = i * SB + s;
      if (s < ns && i < mc) {
        const long long r = (s0 + s) * m + i0 + i;
        z[r] = sz[d];
        y[r] = sy[d];
        Ax[r] = sAx[d];
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still read its buffers
}

// Clusters the card can hold at once for this launch, cached per shape.
template <typename T>
int active_clusters(int C, size_t smem, int* out) {
  static int last_C = -1, last_n = 0;
  static size_t last_smem = 0;
  if (C == last_C && smem == last_smem) {
    *out = last_n;
    return 0;
  }
  auto kern = fused_sweeps_shared_resident<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * 132);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  last_C = C;
  last_smem = smem;
  last_n = n;
  *out = n;
  return 0;
}

// Shared memory of one CTA of the resident mode, or 0 for a shape it does
// not take.
template <typename T>
size_t resident_smem(int m, int n, int C, int ld, int km, int kn) {
  if (n < 1 || m < 0 || C < 1 || C > 8 || ld < 1 || km < m || kn < n ||
      ld % col_unit<T>() != 0) {
    return 0;
  }
  const ResLayout L(ld, km, kn, (m + C - 1) / C, sizeof(T),
                    split_values<T>(kResThreads / 32));
  return L.total > static_cast<long long>(kSmemLimit)
             ? 0 : static_cast<size_t>(L.total);
}

template <typename T>
int resident_clusters(int m, int n, int C, int ld, int km, int kn, int* out) {
  const size_t smem = resident_smem<T>(m, n, C, ld, km, kn);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return active_clusters<T>(C, smem, out);
}

template <typename T>
int launch_resident(void* const* in, void* const* out, const int* stop, int S,
                    int m, int n, int C, int ld, int km, int kn, int n_sweeps,
                    int n_refine, int n_extra, double sigma, double alpha,
                    void* stream) {
  const size_t smem = resident_smem<T>(m, n, C, ld, km, kn);
  if (S < 1 || smem == 0 || stop == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int active = 0;
  int err = active_clusters<T>(C, smem, &active);
  if (err != 0) return err;
  const int ntiles = (S + kResTile - 1) / kResTile;
  const int ncl = ntiles < active ? ntiles : active;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * ncl);
  cfg.blockDim = dim3(kResThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto o = [&](int k) { return static_cast<T*>(out[k]); };
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_sweeps_shared_resident<T>, c(0), c(1), c(2), c(3), c(4),
      c(5), c(6), c(7), c(8), c(9), c(10), c(11), c(12), c(13), c(14), c(15),
      c(16), o(0), o(1), o(2), o(3), o(4), o(5), stop, S, m, n, C, ld, km,
      kn,
      n_sweeps, n_refine, n_extra, static_cast<T>(sigma), static_cast<T>(alpha),
      static_cast<T>(1.0 - alpha));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Streamed mode.
// in:  q, A, At, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma,
//      x, z, zx, y, yx, Ax   (At: A transposed, (n, m) row-major; at prec
//      1 or 2 the wrapper's bf16 operand in its place,
//      cuda_kernels.shared_lowered)
// out: x, z, zx, y, yx, Ax
// stop: a device int, the solve loop's stop flag; where it is set every
// block returns at once and the outputs are left unwritten.
// prec: 0 exact, 1 "default" (bf16), 2 "high" (bf16x3).
// Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_shared_f32(void* const* in, void* const* out,
                                    const int* stop, int S, int m, int n,
                                    int sb, int chunk, int n_sweeps,
                                    int n_refine, int n_extra, int prec,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<float>(in, out, stop, S, m, n, sb, chunk, n_sweeps, n_refine,
                       n_extra, prec, sigma, alpha, stream);
}

int tpusppy_fused_sweeps_shared_f64(void* const* in, void* const* out,
                                    const int* stop, int S, int m, int n,
                                    int sb, int chunk, int n_sweeps,
                                    int n_refine, int n_extra, int prec,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<double>(in, out, stop, S, m, n, sb, chunk, n_sweeps,
                        n_refine, n_extra, prec, sigma, alpha, stream);
}

// Cluster-resident mode.
// in:  q, packed, cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma,
//      x, z, zx, y, yx, Ax   (packed: each CTA's column slices of A, K^-1
//      and K, cuda_kernels.shared_pack)
// out: x, z, zx, y, yx, Ax
// stop: the stop flag, as in the streamed mode
int tpusppy_fused_sweeps_shared_res_f32(void* const* in, void* const* out,
                                        const int* stop, int S, int m, int n,
                                        int C, int ld, int km, int kn,
                                        int n_sweeps, int n_refine,
                                        int n_extra, double sigma,
                                        double alpha, void* stream) {
  return launch_resident<float>(in, out, stop, S, m, n, C, ld, km, kn,
                                n_sweeps, n_refine, n_extra, sigma, alpha,
                                stream);
}

int tpusppy_fused_sweeps_shared_res_f64(void* const* in, void* const* out,
                                        const int* stop, int S, int m, int n,
                                        int C, int ld, int km, int kn,
                                        int n_sweeps, int n_refine,
                                        int n_extra, double sigma,
                                        double alpha, void* stream) {
  return launch_resident<double>(in, out, stop, S, m, n, C, ld, km, kn,
                                 n_sweeps, n_refine, n_extra, sigma, alpha,
                                 stream);
}

// Clusters of the resident mode the card holds at once at this shape
// (cudaOccupancyMaxActiveClusters), into *out; the wrapper picks the mode
// from it.  Returns a cudaError_t (0 on success).
int tpusppy_fused_sweeps_shared_clusters_f32(int m, int n, int C, int ld,
                                             int km, int kn, int* out) {
  return resident_clusters<float>(m, n, C, ld, km, kn, out);
}

int tpusppy_fused_sweeps_shared_clusters_f64(int m, int n, int C, int ld,
                                             int km, int kn, int* out) {
  return resident_clusters<double>(m, n, C, ld, km, kn, out);
}

}  // extern "C"

// Fused sparse shared-A ADMM sweep block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel tpusppy/solvers/pallas_kernels.py
// `_sparse_sweeps_kernel` / `fused_sweeps_sparse` (at precision "highest").
// It runs one `n_sweeps` block of the shared-A engine's sweep
// (tpusppy_torch/solvers/shared_admm.py `_core`) on a sparse shared A held
// in padded-ELL form (rows: rowcols/rowvals (m, kr); columns:
// colrows/colvals (n, kc); padding slots are column 0 with value 0; the
// kernel reads them slot-major, transposed once by the caller), one
// dense (n, n) K^-1 (the explicit inverse, or the densified block/Woodbury
// operator of the structured-KKT engine), and per-scenario gamma scaling:
//
//   rhs = g sigma x - q + A'(g rho_a z - y) + (g rho_x zx - yx)
//   xt  = K^-1 (rhs / g), then passes xt += K^-1 ((rhs - (g Kx + dq2 xt))/g)
//         with the matrix-free Kx = diagK xt + A'(rho_a (A xt))
//         (n_refine passes, plus n_extra when the batch-global flag `has`
//          = any(dq2 != 0) is set; it is read on the device)
//   x   = alpha xt + (1-alpha) x,            Ax = alpha A xt + (1-alpha) Ax
//   z   = clip(alpha A xt + (1-alpha) z + y/(g rho_a), cl, cu),  y += ...
//   zx  = clip(alpha xt + (1-alpha) zx + yx/(g rho_x), lb, ub),  yx += ...
//
// Bound at the main-path shape (the full-width UC, models/uc.py at 30
// generators x 24 hours: S=1000, m=4626, n=2928, 18,937 non-zeros, kr=61,
// kc=10; n_sweeps=4, n_refine=1, n_extra=2 with has=1).  Each sweep applies
// K^-1 four times, 2 S n^2 = 17.1 GFLOP each, against about 0.3 GFLOP for
// all the sparse products, so a call is 274 GFLOP: 4.1 ms at 67 TFLOP/s,
// the card's f32 peak outside the tensor cores (and its f64 tensor-core
// peak).  It moves ~0.2 GB (each input read once, each output written
// once): 0.07 ms at 3.35 TB/s.  The call is bound by operations.
//
// Why the TPU design does not carry over: it holds K^-1 (34.3 MB in f32 at
// this shape) and the ELL arrays in VMEM.  A Hopper block has 227 KB of
// shared memory, and one scenario's state alone (8n + 6m values, 205 KB in
// f32) nearly fills it.  So, as fused_sweeps_shared.cu does with its dense
// A, nothing needs to fit: one thread block owns a tile of SB scenarios
// (SB = 8 when it fits; the ragged last tile is masked) and streams K^-1
// and the ELL arrays from device memory, where every block reads the same
// bytes and finds them in the 50 MB L2 (K^-1 in f32 fits; in f64, 68.6 MB,
// it does not).  Shared memory holds the tile's two contraction operands
// per scenario, the K^-1 input w and x-tilde, index-major with the SB
// scenario values of an index side by side.  The K^-1 apply gives each
// thread CW adjacent output columns (4 in f32, 2 in f64: one 16-byte load)
// for all SB scenarios, so one coalesced K^-1 load feeds CW * SB FMAs, and
// each thread keeps 8 such loads in flight (the apply is limited by the
// loads in flight over the L2 latency); the ELL products give each thread
// one row (A v) or one column (A'v) for all SB scenarios, so one
// index/value load feeds SB FMAs whose operands come in vector loads.  The rhs and the tile's m-vector
// (the A'-input v = g rho_a z - y, then rho_a A xt) live in a per-tile
// device-memory scratch the wrapper allocates, laid out the same way; the
// state vectors stay in the output buffers (read and written once per
// sweep).  What bounds it in practice: each block re-reads all of K^-1 for
// every apply, so L2 traffic is 34 MB times S/SB tiles per apply, and every
// phase ends in a block-wide barrier.  Tiles split over thread-block
// clusters (several blocks sharing one scenario tile's columns) and
// tensor-core MMA are the known next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps_sparse.so fused_sweeps_sparse.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

// Threads per block; cuda_kernels._SPARSE_THREADS mirrors it.
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

// The SB values at p (shared or device memory, aligned to SB elements), in
// 16-byte loads where the tile allows.
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

// K^-1 loads each thread keeps in flight (the k loop's unroll depth): the
// apply streams K^-1 from L2, and its rate is the loads in flight over the
// L2 latency.  With 8, and CW = 4 (f32) or 2 (f64) columns a thread, one
// call at uc-1000's shape takes less than half the time it took with one
// column and 4 loads (chip_smoke.py on an H100 SXM at 700 W; PERF.md);
// 16 loads reach the 128-register cap.
constexpr int kUnroll = 8;
// Widest K^-1 vector load, in values: 16 bytes.
template <typename T>
constexpr int kMaxCW = 16 / sizeof(T);

// CW consecutive values of one K^-1 row, in one vector load.
template <typename T, int CW>
struct Vec;
template <typename T>
struct Vec<T, 1> {
  using type = T;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};

template <typename T, int CW>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         T (&out)[CW]) {
  if constexpr (CW == 1) {
    out[0] = __ldg(p);
  } else {
    const typename Vec<T, CW>::type v =
        __ldg(reinterpret_cast<const typename Vec<T, CW>::type*>(p));
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int w = 0; w < CW; ++w) out[w] = e[w];
  }
}

// One thread's CW output columns, SB scenarios each.
template <typename T, int SB, int CW>
struct Cols {
  T v[CW][SB];
};

// sum_{k0 <= k < k1} in[k * SB + s] * M[k * ncol + col0 + w] for each s
// and w < CW: part of CW consecutive output columns of an (SB, kd) @ (kd,
// ncol) product with M in device memory.  Consecutive threads take
// consecutive column groups, so each matrix load is a coalesced vector load
// that feeds CW * SB FMAs, and the operand loads (shared memory) are
// warp-wide broadcasts.  The sum runs in blocks of kSumBlock terms, so no
// rounding chain is longer than kSumBlock plus the number of blocks
// (n = 2928 terms keep the f32 accuracy of a narrow sum).
template <typename T, int SB, int CW>
__device__ __forceinline__ Cols<T, SB, CW> column_dot(
    const T* in, const T* __restrict__ M, int k0, int k1, int ncol,
    int col0) {
  Cols<T, SB, CW> acc;
#pragma unroll
  for (int w = 0; w < CW; ++w)
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[w][s] = T(0);
  const T* mcol = M + col0;
  for (int kb = k0; kb < k1; kb += kSumBlock) {
    const int ke = k1 - kb < kSumBlock ? k1 : kb + kSumBlock;
    Cols<T, SB, CW> blk;
#pragma unroll
    for (int w = 0; w < CW; ++w)
#pragma unroll
      for (int s = 0; s < SB; ++s) blk.v[w][s] = T(0);
#pragma unroll kUnroll
    for (int k = kb; k < ke; ++k) {
      T mk[CW];
      load_row<T, CW>(mcol + static_cast<long long>(k) * ncol, mk);
      const Tile<T, SB> v = load_tile<T, SB>(in + k * SB);
#pragma unroll
      for (int w = 0; w < CW; ++w)
#pragma unroll
        for (int s = 0; s < SB; ++s) blk.v[w][s] += v.v[s] * mk[w];
    }
#pragma unroll
    for (int w = 0; w < CW; ++w)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc.v[w][s] += blk.v[w][s];
  }
  return acc;
}

// out = in @ M for the tile, in (SB, kd) in shared memory and M (kd, O)
// row-major in device memory, O a multiple of CW; then epi(o, acc) for
// every output column o, with acc the column's SB scenario values.  When
// the columns leave threads over (O < nt), the reduction over k is split
// among G groups of threads, each taking the O / CW column groups, whose
// partial sums meet in `part` (G * O * SB values, at most nt * SB since
// G <= nt / O) and are added in group order.  Ends with a barrier; every
// thread of the block must call it.
template <typename T, int SB, int CW, typename Epi>
__device__ __forceinline__ void contract(const T* in, const T* M, int kd,
                                         int O, T* part, Epi epi) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int groups = O / CW;
  const int W = (groups + 31) / 32 * 32;
  const int Wc = (O + 31) / 32 * 32;
  const int G = Wc >= nt ? 1 : nt / Wc;
  if (G == 1) {
    for (int c = tid; c < groups; c += nt) {
      const Cols<T, SB, CW> acc = column_dot<T, SB, CW>(in, M, 0, kd, O,
                                                        c * CW);
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        Tile<T, SB> t;
#pragma unroll
        for (int s = 0; s < SB; ++s) t.v[s] = acc.v[w][s];
        epi(c * CW + w, t);
      }
    }
    __syncthreads();
    return;
  }
  const int g = tid / W, c = tid - g * W;
  if (g < G && c < groups) {
    const Cols<T, SB, CW> acc = column_dot<T, SB, CW>(
        in, M, kd * g / G, kd * (g + 1) / G, O, c * CW);
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      T* dst = part + (static_cast<long long>(g) * O + c * CW + w) * SB;
#pragma unroll
      for (int s = 0; s < SB; ++s) dst[s] = acc.v[w][s];
    }
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

// One ELL row (or column) r against a tile operand `in` (index-major, SB
// values an index): sum_k vals[k, r] * in[idx[k, r] * SB + s] for each s,
// the slots summed in order as pallas_kernels._ell_mv sums them.  The ELL
// arrays come slot-major, (k, rows), so consecutive threads (consecutive
// r) read consecutive indices and values.  Padding slots (index 0, value
// 0) add zeros.
template <typename T, int SB>
__device__ __forceinline__ Tile<T, SB> ell_dot(const int* __restrict__ idx,
                                               const T* __restrict__ vals,
                                               int k, int rows, int r,
                                               const T* in) {
  Tile<T, SB> acc;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = T(0);
  for (int j = 0; j < k; ++j) {
    const long long at = static_cast<long long>(j) * rows + r;
    const int c = __ldg(idx + at);
    const T a = __ldg(vals + at);
    const Tile<T, SB> v =
        load_tile<T, SB>(in + static_cast<long long>(c) * SB);
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[s] += v.v[s] * a;
  }
  return acc;
}

template <typename T, int SB, int CW>
__global__ void __launch_bounds__(kThreads, 1) fused_sweeps_sparse_kernel(
    const T* __restrict__ q, const int* __restrict__ rowcols,
    const T* __restrict__ rowvals, const int* __restrict__ colrows,
    const T* __restrict__ colvals, const T* __restrict__ Kinv,
    const T* __restrict__ diagK, const T* __restrict__ cl,
    const T* __restrict__ cu, const T* __restrict__ lb,
    const T* __restrict__ ub, const T* __restrict__ rho_a,
    const T* __restrict__ rho_x, const T* __restrict__ dq2,
    const T* __restrict__ has, const T* __restrict__ gamma,
    const T* __restrict__ x_in, const T* __restrict__ z_in,
    const T* __restrict__ zx_in, const T* __restrict__ y_in,
    const T* __restrict__ yx_in, const T* __restrict__ Ax_in,
    T* __restrict__ x, T* __restrict__ z, T* __restrict__ zx,
    T* __restrict__ y, T* __restrict__ yx, T* __restrict__ Ax,
    T* __restrict__ rhs_scratch, T* __restrict__ v_scratch, int S, int m,
    int n, int kr, int kc, int n_sweeps, int n_refine, int n_extra, T sigma,
    T alpha, T beta) {
  using V = Tile<T, SB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);  // (SB) the tile's gammas
  T* sw = gs + SB;            // (n, SB) the K^-1 input: rhs/g, then r/g
  T* sxt = sw + n * SB;       // (n, SB) x-tilde
  T* part = sxt + n * SB;     // (kThreads, SB) split-k partial sums

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long s0 = static_cast<long long>(blockIdx.x) * SB;
  const int ns = static_cast<int>(S - s0 < SB ? S - s0 : SB);
  const long long on = s0 * n;
  const long long om = s0 * m;
  // this tile's scratch: the rhs (n, SB) and an m-vector (m, SB)
  T* srhs = rhs_scratch + static_cast<long long>(blockIdx.x) * n * SB;
  T* sv = v_scratch + static_cast<long long>(blockIdx.x) * m * SB;

  // the tile's state moves into the outputs, which carry it across sweeps
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
  if (tid < SB) gs[tid] = tid < ns ? gamma[s0 + tid] : T(1);
  const int n_pass = n_refine + (has[0] > T(0) ? n_extra : 0);
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    // v = g rho_a z - y, the A' input (zero for the masked scenarios)
    for (int e = tid; e < SB * m; e += nt) {
      const int s = e / m, i = e - s * m;
      T v = T(0);
      if (s < ns) {
        const long long r = om + static_cast<long long>(s) * m + i;
        v = gs[s] * rho_a[i] * z[r] - y[r];
      }
      sv[static_cast<long long>(i) * SB + s] = v;
    }
    __syncthreads();
    // rhs = ((g sigma x - q) + A'v) + (g rho_x zx - yx); w = rhs / g
    for (int j = tid; j < n; j += nt) {
      const V atv = ell_dot<T, SB>(colrows, colvals, kc, n, j, sv);
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        T rhs = T(0), w = T(0);
        if (s < ns) {
          const long long r = on + static_cast<long long>(s) * n + j;
          const T g = gs[s];
          rhs = ((g * sigma) * x[r] - q[r] + atv.v[s]) +
                ((g * rho_x[j]) * zx[r] - yx[r]);
          w = rhs / g;
        }
        srhs[static_cast<long long>(j) * SB + s] = rhs;
        sw[j * SB + s] = w;
      }
    }
    __syncthreads();
    // xt = K^-1 w
    contract<T, SB, CW>(sw, Kinv, n, n, part, [&](int j, const V& acc) {
#pragma unroll
      for (int s = 0; s < SB; ++s) sxt[j * SB + s] = acc.v[s];
    });
    // refinement against the exact per-scenario system g K + diag(dq2),
    // K applied matrix-free through the ELL arrays
    for (int pass = 0; pass < n_pass; ++pass) {
      // t = rho_a (A xt), into the m-vector scratch
      for (int i = tid; i < m; i += nt) {
        const V axt = ell_dot<T, SB>(rowcols, rowvals, kr, m, i, sxt);
        const T ra = rho_a[i];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          sv[static_cast<long long>(i) * SB + s] = axt.v[s] * ra;
        }
      }
      __syncthreads();
      // w = (rhs - (g (diagK xt + A't) + dq2 xt)) / g
      for (int j = tid; j < n; j += nt) {
        const V att = ell_dot<T, SB>(colrows, colvals, kc, n, j, sv);
        const T dk = diagK[j];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          T w = T(0);
          if (s < ns) {
            const T d = dq2[on + static_cast<long long>(s) * n + j];
            const T xt = sxt[j * SB + s];
            const T kx = xt * dk + att.v[s];
            const T g = gs[s];
            w = (srhs[static_cast<long long>(j) * SB + s] -
                 (g * kx + d * xt)) / g;
          }
          sw[j * SB + s] = w;
        }
      }
      __syncthreads();
      contract<T, SB, CW>(sw, Kinv, n, n, part, [&](int j, const V& acc) {
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
    // Axt = A xt by ELL rows, and each row's z, y, Ax update
    for (int i = tid; i < m; i += nt) {
      const V axt = ell_dot<T, SB>(rowcols, rowvals, kr, m, i, sxt);
      const T ra0 = rho_a[i];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        if (s < ns) {
          const long long r = om + static_cast<long long>(s) * m + i;
          const T ra = gs[s] * ra0;
          const T a = alpha * axt.v[s];
          const T za = a + beta * z[r];
          const T zn = clip(za + y[r] / ra, cl[r], cu[r]);
          y[r] = y[r] + ra * (za - zn);
          z[r] = zn;
          Ax[r] = a + beta * Ax[r];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int SB, int CW>
int launch_tile(void* const* in, void* const* out, int S, int m, int n,
                int kr, int kc, int n_sweeps, int n_refine, int n_extra,
                double sigma, double alpha, void* stream) {
  // cuda_kernels.sparse_smem_bytes mirrors this
  const size_t smem =
      sizeof(T) * SB * (1 + 2 * static_cast<size_t>(n) + kThreads);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_sweeps_sparse_kernel<T, SB, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto ci = [&](int k) { return static_cast<const int*>(in[k]); };
  auto o = [&](int k) { return static_cast<T*>(out[k]); };
  const int grid = (S + SB - 1) / SB;
  fused_sweeps_sparse_kernel<T, SB, CW>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          c(0), ci(1), c(2), ci(3), c(4), c(5), c(6), c(7), c(8), c(9),
          c(10), c(11), c(12), c(13), c(14), c(15), c(16), c(17), c(18),
          c(19), c(20), c(21), o(0), o(1), o(2), o(3), o(4), o(5), o(6),
          o(7), S, m, n, kr, kc, n_sweeps, n_refine, n_extra,
          static_cast<T>(sigma), static_cast<T>(alpha),
          static_cast<T>(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

// K^-1 columns per thread: the widest vector load (up to kMaxCW values)
// whose width divides n, so that every row of K^-1 starts aligned.
template <typename T, int SB, int CWmax>
int launch_cols(void* const* in, void* const* out, int S, int m, int n,
                int kr, int kc, int n_sweeps, int n_refine, int n_extra,
                double sigma, double alpha, void* stream) {
  if constexpr (CWmax > 1) {
    if (n % CWmax == 0) {
      return launch_tile<T, SB, CWmax>(in, out, S, m, n, kr, kc, n_sweeps,
                                       n_refine, n_extra, sigma, alpha,
                                       stream);
    }
    return launch_cols<T, SB, CWmax / 2>(in, out, S, m, n, kr, kc,
                                         n_sweeps, n_refine, n_extra, sigma,
                                         alpha, stream);
  } else {
    return launch_tile<T, SB, 1>(in, out, S, m, n, kr, kc, n_sweeps,
                                 n_refine, n_extra, sigma, alpha, stream);
  }
}

template <typename T>
int launch(void* const* in, void* const* out, int S, int m, int n, int kr,
           int kc, int sb, int n_sweeps, int n_refine, int n_extra,
           double sigma, double alpha, void* stream) {
  if (S < 1 || n < 1 || m < 0 || kr < 1 || kc < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int CW = kMaxCW<T>;
  // cuda_kernels.SPARSE_TILES mirrors these cases
  switch (sb) {
    case 8:
      return launch_cols<T, 8, CW>(in, out, S, m, n, kr, kc, n_sweeps,
                                   n_refine, n_extra, sigma, alpha, stream);
    case 4:
      return launch_cols<T, 4, CW>(in, out, S, m, n, kr, kc, n_sweeps,
                                   n_refine, n_extra, sigma, alpha, stream);
    case 2:
      return launch_cols<T, 2, CW>(in, out, S, m, n, kr, kc, n_sweeps,
                                   n_refine, n_extra, sigma, alpha, stream);
    case 1:
      return launch_cols<T, 1, CW>(in, out, S, m, n, kr, kc, n_sweeps,
                                   n_refine, n_extra, sigma, alpha, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// in:  q, rowcols, rowvals, colrows, colvals, Kinv, diagK, cl, cu, lb, ub,
//      rho_a, rho_x, dq2, has, gamma, x, z, zx, y, yx, Ax
//      (the ELL arrays slot-major: rowcols/rowvals (kr, m), colrows/colvals
//       (kc, n); rowcols, colrows int32; the rest T)
// out: x, z, zx, y, yx, Ax, then the scratch rhs (tiles * n * sb) and
//      m-vector (tiles * m * sb)
// Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_sparse_f32(void* const* in, void* const* out, int S,
                                    int m, int n, int kr, int kc, int sb,
                                    int n_sweeps, int n_refine, int n_extra,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<float>(in, out, S, m, n, kr, kc, sb, n_sweeps, n_refine,
                       n_extra, sigma, alpha, stream);
}

int tpusppy_fused_sweeps_sparse_f64(void* const* in, void* const* out, int S,
                                    int m, int n, int kr, int kc, int sb,
                                    int n_sweeps, int n_refine, int n_extra,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<double>(in, out, S, m, n, kr, kc, sb, n_sweeps, n_refine,
                        n_extra, sigma, alpha, stream);
}

}  // extern "C"

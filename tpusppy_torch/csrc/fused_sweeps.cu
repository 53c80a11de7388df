// Fused ADMM sweep block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel tpusppy/solvers/pallas_kernels.py
// `_sweeps_kernel` / `fused_sweeps`.  Per scenario it runs `n_sweeps` relaxed
// OSQP sweeps of the dense per-scenario ADMM engine
// (tpusppy_torch/solvers/admm.py `_admm_core`):
//
//   rhs = sigma x - q + A'(rho_a z - y) + rho_x zx - yx
//   xt  = K^-1 rhs, then n_refine passes xt += K^-1 (rhs - K xt)
//   x   = alpha xt + (1-alpha) x,            Ax = alpha A xt + (1-alpha) Ax
//   z   = clip(alpha A xt + (1-alpha) z + y/rho_a, cl, cu),   y += rho_a(...)
//   zx  = clip(alpha xt + (1-alpha) zx + yx/rho_x, lb, ub),   yx += rho_x(...)
//
// Layout: the solver's natural row-major (S, m, n) / (S, n, n) / (S, n)
// tensors, scenarios leading.  The TPU kernel put scenarios on the 128-lane
// axis and needed every operand transposed once per rho setting; here one
// thread block owns one scenario, so no transposes exist.
//
// Bound at the main-path shape (farmer crops_multiplier=4: S=1000, m=28,
// n=44, n_sweeps=4, n_refine=2).  Each sweep is 4mn + 2n^2(1 + 2 n_refine)
// = 24.3 kflop per scenario, 97 MFLOP per call at S=1000.  The call must read
// A, K^-1 and K once: (mn + 2n^2) * itemsize = 20.4 MB in f32 and 40.8 MB in
// f64, plus ~3 MB (f32) of vectors.  At 3.35 TB/s that is ~7 us (f32) or
// ~13 us (f64), far above the ~1.5 us (67 TFLOP/s, the card's peak in f32
// on CUDA cores and in f64 on tensor cores) the arithmetic needs: the call
// is bound by memory (by L2 when the matrices are still resident from the
// previous call).
//
// What the design does about that bound: every matrix byte crosses HBM once
// per call (one coalesced load into shared memory), all n_sweeps sweeps then
// run out of shared memory, and the state vectors are written back once.
// Shared-memory rows are padded to an odd stride so threads walking matrix
// rows hit distinct banks.  Threads map to the output index of each matvec.
// One scenario per block leaves most SMs latency-bound at small n (only
// max(m, n) rounded up to a warp of threads per block); packing several
// scenarios per block, warp-level matvecs and asynchronous copies are the
// known next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps.so fused_sweeps.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cuda_runtime.h>

namespace {

// min(max(v, lo), hi) with NaN propagating like torch.clamp (fmin/fmax
// would drop the NaN).
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  T r = (v < lo) ? lo : v;
  return (r > hi) ? hi : r;
}

// Shared-memory elements per block; cuda_kernels.smem_bytes mirrors this.
inline size_t smem_elems(int m, int n) {
  const size_t ld = static_cast<size_t>(n | 1);
  return static_cast<size_t>(m) * ld + 2 * static_cast<size_t>(n) * ld +
         10 * static_cast<size_t>(n) + 8 * static_cast<size_t>(m);
}

template <typename T>
__global__ void fused_sweeps_kernel(
    const T* __restrict__ q, const T* __restrict__ A,
    const T* __restrict__ Kinv, const T* __restrict__ K,
    const T* __restrict__ cl, const T* __restrict__ cu,
    const T* __restrict__ lb, const T* __restrict__ ub,
    const T* __restrict__ rho_a, const T* __restrict__ rho_x,
    const T* __restrict__ x_in, const T* __restrict__ z_in,
    const T* __restrict__ zx_in, const T* __restrict__ y_in,
    const T* __restrict__ yx_in, const T* __restrict__ Ax_in,
    T* __restrict__ x_out, T* __restrict__ z_out, T* __restrict__ zx_out,
    T* __restrict__ y_out, T* __restrict__ yx_out, T* __restrict__ Ax_out,
    int m, int n, int n_sweeps, int n_refine, T sigma, T alpha, T beta) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ld = n | 1;
  T* sA = sm;                  // (m, ld)
  T* sKinv = sA + m * ld;      // (n, ld)
  T* sK = sKinv + n * ld;      // (n, ld)
  T* sq = sK + n * ld;         // ten n-vectors
  T* slb = sq + n;
  T* sub = slb + n;
  T* srx = sub + n;
  T* sx = srx + n;
  T* szx = sx + n;
  T* syx = szx + n;
  T* srhs = syx + n;
  T* sxt = srhs + n;
  T* sr = sxt + n;
  T* scl = sr + n;             // eight m-vectors
  T* scu = scl + m;
  T* sra = scu + m;
  T* sz = sra + m;
  T* sy = sz + m;
  T* sAx = sy + m;
  T* sv = sAx + m;
  T* sAxt = sv + m;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long s = blockIdx.x;
  const long long on = s * n;
  const long long om = s * m;

  // one coalesced pass over this scenario's contiguous matrices
  const T* gA = A + s * static_cast<long long>(m) * n;
  for (int e = tid; e < m * n; e += nt) sA[(e / n) * ld + e % n] = gA[e];
  const T* gKi = Kinv + s * static_cast<long long>(n) * n;
  const T* gK = K + s * static_cast<long long>(n) * n;
  for (int e = tid; e < n * n; e += nt) {
    const int r = e / n, c = e % n;
    sKinv[r * ld + c] = gKi[e];
    sK[r * ld + c] = gK[e];
  }
  for (int j = tid; j < n; j += nt) {
    sq[j] = q[on + j];
    slb[j] = lb[on + j];
    sub[j] = ub[on + j];
    srx[j] = rho_x[on + j];
    sx[j] = x_in[on + j];
    szx[j] = zx_in[on + j];
    syx[j] = yx_in[on + j];
  }
  for (int i = tid; i < m; i += nt) {
    scl[i] = cl[om + i];
    scu[i] = cu[om + i];
    sra[i] = rho_a[om + i];
    sz[i] = z_in[om + i];
    sy[i] = y_in[om + i];
    sAx[i] = Ax_in[om + i];
  }
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int i = tid; i < m; i += nt) sv[i] = sra[i] * sz[i] - sy[i];
    __syncthreads();
    // rhs = sigma x - q + A'v + (rho_x zx - yx)
    for (int j = tid; j < n; j += nt) {
      T acc = T(0);
      for (int i = 0; i < m; ++i) acc += sA[i * ld + j] * sv[i];
      srhs[j] = ((sigma * sx[j] - sq[j]) + acc) + (srx[j] * szx[j] - syx[j]);
    }
    __syncthreads();
    // xt = K^-1 rhs, then refinement against the exact K
    for (int j = tid; j < n; j += nt) {
      const T* row = sKinv + j * ld;
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += row[k] * srhs[k];
      sxt[j] = acc;
    }
    __syncthreads();
    for (int pass = 0; pass < n_refine; ++pass) {
      for (int j = tid; j < n; j += nt) {
        const T* row = sK + j * ld;
        T acc = T(0);
        for (int k = 0; k < n; ++k) acc += row[k] * sxt[k];
        sr[j] = srhs[j] - acc;
      }
      __syncthreads();
      for (int j = tid; j < n; j += nt) {
        const T* row = sKinv + j * ld;
        T acc = T(0);
        for (int k = 0; k < n; ++k) acc += row[k] * sr[k];
        sxt[j] += acc;
      }
      __syncthreads();
    }
    for (int i = tid; i < m; i += nt) {
      const T* row = sA + i * ld;
      T acc = T(0);
      for (int j = 0; j < n; ++j) acc += row[j] * sxt[j];
      sAxt[i] = acc;
    }
    __syncthreads();
    // relaxed primal/dual updates: each thread owns its indices
    for (int j = tid; j < n; j += nt) {
      const T xt = sxt[j];
      const T zx_old = szx[j];
      const T zx_new =
          clip(alpha * xt + beta * zx_old + syx[j] / srx[j], slb[j], sub[j]);
      syx[j] = syx[j] + srx[j] * (alpha * xt + beta * zx_old - zx_new);
      szx[j] = zx_new;
      sx[j] = alpha * xt + beta * sx[j];
    }
    for (int i = tid; i < m; i += nt) {
      const T axt = sAxt[i];
      const T z_old = sz[i];
      const T z_new =
          clip(alpha * axt + beta * z_old + sy[i] / sra[i], scl[i], scu[i]);
      sy[i] = sy[i] + sra[i] * (alpha * axt + beta * z_old - z_new);
      sz[i] = z_new;
      sAx[i] = alpha * axt + beta * sAx[i];
    }
    __syncthreads();
  }

  for (int j = tid; j < n; j += nt) {
    x_out[on + j] = sx[j];
    zx_out[on + j] = szx[j];
    yx_out[on + j] = syx[j];
  }
  for (int i = tid; i < m; i += nt) {
    z_out[om + i] = sz[i];
    y_out[om + i] = sy[i];
    Ax_out[om + i] = sAx[i];
  }
}

template <typename T>
int launch(void* const* in, void* const* out, int S, int m, int n,
           int n_sweeps, int n_refine, double sigma, double alpha,
           void* stream) {
  const size_t smem = sizeof(T) * smem_elems(m, n);
  const int widest = m > n ? m : n;
  int threads = ((widest + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_sweeps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto o = [&](int k) { return static_cast<T*>(out[k]); };
  fused_sweeps_kernel<T><<<S, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      c(0), c(1), c(2), c(3), c(4), c(5), c(6), c(7), c(8), c(9), c(10),
      c(11), c(12), c(13), c(14), c(15), o(0), o(1), o(2), o(3), o(4), o(5),
      m, n, n_sweeps, n_refine, static_cast<T>(sigma), static_cast<T>(alpha),
      static_cast<T>(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in:  q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax
// out: x, z, zx, y, yx, Ax
// Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_f32(void* const* in, void* const* out, int S, int m,
                             int n, int n_sweeps, int n_refine, double sigma,
                             double alpha, void* stream) {
  return launch<float>(in, out, S, m, n, n_sweeps, n_refine, sigma, alpha,
                       stream);
}

int tpusppy_fused_sweeps_f64(void* const* in, void* const* out, int S, int m,
                             int n, int n_sweeps, int n_refine, double sigma,
                             double alpha, void* stream) {
  return launch<double>(in, out, S, m, n, n_sweeps, n_refine, sigma, alpha,
                        stream);
}

}  // extern "C"

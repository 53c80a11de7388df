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
// axis and needed every operand transposed once per rho setting; here a
// thread block takes one scenario at a time, so no transposes exist.
//
// Bound at the main-path shape (farmer crops_multiplier=4: S=1000, m=28,
// n=44, n_sweeps=4, n_refine=2).  Each sweep is 4mn + 2n^2(1 + 2 n_refine)
// = 24.3 kflop per scenario, 97 MFLOP per call at S=1000.  The call must read
// A, K^-1 and K once: (mn + 2n^2) * itemsize = 20.4 MB in f32 and 40.8 MB in
// f64, plus ~3 MB (f32) of vectors.  At 3.35 TB/s that is ~7 us (f32) or
// ~13 us (f64), far above the ~1.5 us (67 TFLOP/s, the card's peak in f32
// on CUDA cores and in f64 on tensor cores) the arithmetic needs: the call
// is bound by memory.
//
// Two modes (cuda_kernels.dense_layout picks; the wrapper counts launches by
// mode in cuda_kernels.dense_modes):
//
// Resident (two of one scenario's matrices and vectors fit a block's
// shared memory): persistent blocks, each walking its scenarios, a
// scenario's arrays brought in by bulk asynchronous copies (cp.async.bulk,
// completion on an mbarrier).  The copy engine needs 16-byte-aligned
// sources and sizes, and a scenario's rows start anywhere: each array is
// copied as the 16-byte-aligned span that holds it, into its own slot, and
// read from where its first element landed (rows keep their natural
// stride).  A block holds two buffers, the next scenario's copy in flight
// while one sweeps, where the second buffer keeps more than half the
// blocks an SM; else one, and the SM's blocks overlap each other's copies:
// at farmer's shape one buffer fits 9 blocks an SM in f32 (4 in f64)
// against 4 (2) with two, and every scenario is in flight at once.  A
// thread takes one output row (or column, for A'v) of each product, with
// 16-byte reads of 16-byte rows (farmer's) and otherwise a start rotated
// by row so a warp's reads fall in distinct banks; the elementwise updates
// ride in the epilogue of the product that produces their input (x, zx, yx
// in the last K^-1 apply, z, y, Ax and the next v in A xt): 3 + 2 n_refine
// barriers a sweep.
//
// Streamed (one scenario does not fit): one block an SM walks its
// scenarios and every product streams its matrix through two 32 KB stage
// buffers, in flat panels of consecutive elements that the same span
// copies bring in (the copy of the next panel is in flight while one is
// used, across products and scenarios).  Row products give each row's
// segment in the panel to a warp; A'v adds each panel's rows into the
// columns' sums.  The state lives in the output buffers in device memory;
// the work vectors in shared memory where they fit, else in device-memory
// scratch.  No limit comes from m or n.
//
// What was measured (scripts/port_shared_ablation.py, PERF.md, H100 SXM at
// 700 W): the design this replaces (one 64-thread block a scenario, every
// scenario at once) spent 0.023 of 0.036 ms in f32 on its sweeps, 44-long
// dependent chains.  A product's cost here is its chain of dependent
// shared-memory reads, not its arithmetic, so the design shortens the
// chain (16-byte reads, two sums) and keeps as many scenarios in flight an
// SM as fit; the ablation's two_buffers variant times the double-buffered
// alternative.  The sweeps still take most of the call; the copies hide
// behind them (PERF.md).
//
// The stop flag: the solve loop runs its sweep blocks as CUDA-graph
// replays (tpusppy_torch/solvers/device_loop.py) and keeps its exit vote in
// a device int that stays set once set.  Every block reads it first and
// returns where it is set, before any barrier or copy, so a block past the
// loop's exit costs one launch; the graph's commit then keeps the old state.
//
// The mixed-precision mode (prec 1, the TPU kernel's "default" branch,
// pallas_kernels.py:90-112): A and K^-1 arrive in bf16 (made once per set
// of matrices by the wrapper, cuda_kernels.dense_operand) and stay bf16 in
// shared memory and the stage panels, an entry widened to the working
// type as it is read; the vector operand of each A', K^-1 and A product is
// rounded to bf16 (through f32, round to nearest even, also in f64 runs)
// once, into the work vector the product reads (v, r), and the products
// and sums run in the working type; K stays in the working type and the
// defect rhs - K xt is exact.  The bytes a scenario moves fall from
// (mn + 2n^2) to (mn + n^2) * 2 + n^2 * itemsize (0.65x at farmer's shape
// in f32), and the resident mode's buffers shrink with them.  The TPU
// kernel's "high" is its exact path (the per-scenario products have no
// MXU passes to save), so this kernel has no "high" of its own.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps.so fused_sweeps.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// Threads per block (cuda_kernels._DENSE_THREADS).
constexpr int kThreads = 256;
// Shared memory one block may use on Hopper (cuda_kernels.SMEM_LIMIT).
constexpr long long kSmemLimit = 232448;
// Terms summed into one partial sum before it joins the running total.
constexpr int kSumBlock = 32;
// Bytes of one stage buffer's panel in the streamed mode, and the slack a
// span copy needs beside it (cuda_kernels._STAGE_BYTES).
constexpr long long kStageBytes = 32768;
// The arrays of one scenario in a resident buffer, in slot order: A, K^-1,
// K, then q, lb, ub, rho_x, x, zx, yx (n each), then cl, cu, rho_a, z, y,
// Ax (m each).
constexpr int kArrays = 16;

// min(max(v, lo), hi) with NaN propagating like torch.clamp (fmin/fmax
// would drop the NaN).
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  T r = (v < lo) ? lo : v;
  return (r > hi) ? hi : r;
}

__host__ __device__ constexpr long long r16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// Elements of array a of a scenario.
__host__ __device__ inline long long array_len(int a, int m, int n) {
  if (a == 0) return static_cast<long long>(m) * n;
  if (a < 3) return static_cast<long long>(n) * n;
  return a < 10 ? n : m;
}

// Bytes of one entry of array a: A and K^-1 (a < 2) are bf16 in the
// mixed-precision mode (msz 2), everything else the working type.
__host__ __device__ inline int elem_bytes(int a, int isz, int msz) {
  return a < 2 ? msz : isz;
}

// Bytes of array a's slot: its span may start up to 15 bytes before it.
__host__ __device__ inline long long slot_bytes(int a, int m, int n, int isz,
                                                int msz) {
  return r16(array_len(a, m, n) * elem_bytes(a, isz, msz)) + 16;
}

// Byte offsets of the resident mode's shared memory (cuda_kernels.
// dense_layout mirrors it): two mbarriers, the slots' offsets (kArrays
// ints), the work vectors rhs, xt, r (n each) and v (m), then two scenario
// buffers of kArrays slots.
struct ResLayout {
  long long work, buf, buf_bytes, total;
  __host__ __device__ ResLayout(int m, int n, int isz, int msz) {
    work = 16 + 4 * kArrays;
    buf = work + 3 * r16(static_cast<long long>(n) * isz) +
          r16(static_cast<long long>(m) * isz);
    buf_bytes = 0;
    for (int a = 0; a < kArrays; ++a) {
      buf_bytes += slot_bytes(a, m, n, isz, msz);
    }
    total = buf + 2 * buf_bytes;  // with two buffers
  }
};

// The streamed mode's: two mbarriers, two stage buffers, then the work
// vectors rhs, xt, r, t (n each) and v (m) where they fit (vec_smem).
struct StreamLayout {
  long long stage, stage_bytes, work, work_bytes, total;
  bool vec_smem;
  __host__ __device__ StreamLayout(int m, int n, int isz) {
    stage = 16;
    stage_bytes = kStageBytes + 32;
    work = stage + 2 * stage_bytes;
    work_bytes = 4 * r16(static_cast<long long>(n) * isz) +
                 r16(static_cast<long long>(m) * isz);
    vec_smem = work + work_bytes <= kSmemLimit;
    total = vec_smem ? work + work_bytes : work;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits for the phase; a copy that never lands ends the launch with an
// error after ~2^30 tries, not a hang.
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

// Where element 0 of src lands in a slot its span copy fills.
template <typename T>
__device__ __forceinline__ T* landed(T* slot, const T* src) {
  return slot + (reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T);
}

// One bulk copy of the 16-byte-aligned span holding src[0, count) into
// dst (16-byte aligned), its bytes announced on bar first.  The span never
// reaches past the 16-byte chunk of src's last element, so it stays inside
// the allocation.
template <typename T>
__device__ __forceinline__ void span_copy(T* dst, const T* src,
                                          long long count, uint64_t* bar) {
  if (count <= 0) return;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(src + count) + 15) & ~uintptr_t(15);
  const uint32_t bytes = static_cast<uint32_t>(hi - lo);
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(lo), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A matrix entry as the working type: bf16 entries (the mixed-precision
// mode's A and K^-1) widened exactly, others as they are.
template <typename T>
__device__ __forceinline__ T widen(T v) {
  return v;
}
template <typename T>
__device__ __forceinline__ T widen(__nv_bfloat16 v) {
  return static_cast<T>(__bfloat162float(v));
}

// v rounded to bf16 through f32 (round to nearest even), kept in T: the
// TPU kernel's rnd(), and pallas_kernels' cast chain.
template <typename T>
__device__ __forceinline__ T rnd(T v) {
  return static_cast<T>(
      __bfloat162float(__float2bfloat16_rn(static_cast<float>(v))));
}

// out(o) = sum_{k < kd} M[o * ld + k] * in[k] for o < O (M row-major),
// then epi(o, out): a thread an output row, for all rows the block's
// threads take in turn.  Thread o starts its walk along the row at
// k = (o * d) mod kd, with d = 1 for an even ld and 2 for an odd one, so
// that the threads of a warp read banks ld + d apart, an odd stride, and no
// two collide (the rows keep the natural stride the bulk copy gives them);
// its terms go to two sums (alternate terms) that meet at the end.  The
// resident mode takes only shapes whose rows are short (a scenario's
// matrices fit shared memory twice), so the chains stay short.  M may hold
// bf16 entries (MT), widened to T as they are read.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// Four consecutive values of `in` (16-byte aligned) as T.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&o)[4]) {
  if constexpr (std::is_same_v<T, float>) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = a.z;
    o[3] = a.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
}

template <typename T, typename MT, typename Epi>
__device__ __forceinline__ void rows_dot(const MT* M, int ld, const T* in,
                                         int O, int kd, Epi epi) {
  const int d = (ld & 1) ? 2 : 1;
  if constexpr (std::is_same_v<T, MT>) {
    using V = typename Vec16<T>::type;
    constexpr int W = 16 / sizeof(T);
    // 16-byte rows (the usual case: farmer's n=44 in f32 and f64): a
    // thread reads its row and the broadcast `in` 16 bytes at a time
    const bool vec = ld % W == 0 &&
                     ((reinterpret_cast<uintptr_t>(M) |
                       reinterpret_cast<uintptr_t>(in)) & 15) == 0;
    if (vec) {
      for (int o = threadIdx.x; o < O; o += blockDim.x) {
        const T* row = M + static_cast<long long>(o) * ld;
        T s0 = T(0), s1 = T(0);
        const V* rv = reinterpret_cast<const V*>(row);
        const V* iv = reinterpret_cast<const V*>(in);
        const int kv = kd / W;
#pragma unroll 4
        for (int t = 0; t < kv; ++t) {
          const V a = rv[t], b = iv[t];
          if constexpr (W == 4) {
            s0 += a.x * b.x;
            s1 += a.y * b.y;
            s0 += a.z * b.z;
            s1 += a.w * b.w;
          } else {
            s0 += a.x * b.x;
            s1 += a.y * b.y;
          }
        }
        for (int k = kv * W; k < kd; ++k) s0 += row[k] * in[k];
        epi(o, s0 + s1);
      }
      return;
    }
  } else {
    // bf16 rows whose length is a multiple of 4 (farmer's n=44): a thread
    // reads four entries (8 bytes) and four values of `in` at a time
    const bool vec = ld % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(M) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(in) & 15) == 0;
    if (vec) {
      for (int o = threadIdx.x; o < O; o += blockDim.x) {
        const MT* row = M + static_cast<long long>(o) * ld;
        T s0 = T(0), s1 = T(0);
        const uint2* rv = reinterpret_cast<const uint2*>(row);
        const int kv = kd / 4;
#pragma unroll 4
        for (int t = 0; t < kv; ++t) {
          const uint2 raw = rv[t];
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
          const float2 b = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
          T iv[4];
          load4<T>(in + 4 * t, iv);
          s0 += static_cast<T>(a.x) * iv[0];
          s1 += static_cast<T>(a.y) * iv[1];
          s0 += static_cast<T>(b.x) * iv[2];
          s1 += static_cast<T>(b.y) * iv[3];
        }
        for (int k = kv * 4; k < kd; ++k) s0 += widen<T>(row[k]) * in[k];
        epi(o, s0 + s1);
      }
      return;
    }
  }
  for (int o = threadIdx.x; o < O; o += blockDim.x) {
    const MT* row = M + static_cast<long long>(o) * ld;
    T s0 = T(0), s1 = T(0);
    const int r0 = kd > 0 ? (o * d) % kd : 0;
    int k = r0;
#pragma unroll 2
    for (; k + 1 < kd; k += 2) {
      s0 += widen<T>(row[k]) * in[k];
      s1 += widen<T>(row[k + 1]) * in[k + 1];
    }
    if (k < kd) s0 += widen<T>(row[k]) * in[k];
    for (k = 0; k + 1 < r0; k += 2) {
      s0 += widen<T>(row[k]) * in[k];
      s1 += widen<T>(row[k + 1]) * in[k + 1];
    }
    if (k < r0) s0 += widen<T>(row[k]) * in[k];
    epi(o, s0 + s1);
  }
}

// out(j) = sum_{i < kd} M[i * ld + j] * in[i] for j < O: a thread an output
// column; a warp reads consecutive words of a row, and `in` is a broadcast.
template <typename T, typename MT, typename Epi>
__device__ __forceinline__ void cols_dot(const MT* M, int ld, const T* in,
                                         int O, int kd, Epi epi) {
  for (int j = threadIdx.x; j < O; j += blockDim.x) {
    const MT* col = M + j;
    T s0 = T(0), s1 = T(0);
    int i = 0;
#pragma unroll 2
    for (; i + 1 < kd; i += 2) {
      s0 += widen<T>(col[static_cast<long long>(i) * ld]) * in[i];
      s1 += widen<T>(col[static_cast<long long>(i + 1) * ld]) * in[i + 1];
    }
    if (i < kd) s0 += widen<T>(col[static_cast<long long>(i) * ld]) * in[i];
    epi(j, s0 + s1);
  }
}

// The inputs of one sweep block, as the launcher passes them.
struct In {
  const void* a[kArrays];  // per scenario: A, K^-1, K, q, lb, ub, rho_x, x,
                           // zx, yx, cl, cu, rho_a, z, y, Ax (slot order);
                           // A and K^-1 bf16 in the mixed-precision mode
};

template <typename T>
struct Out {
  T* x;
  T* z;
  T* zx;
  T* y;
  T* yx;
  T* Ax;
};

// Scenario s's array a, as U (MT for A and K^-1, T for the rest).
template <typename U>
__device__ __forceinline__ const U* scen(const In& in, int a, long long s,
                                         int m, int n) {
  return static_cast<const U*>(in.a[a]) + s * array_len(a, m, n);
}

template <typename T, typename MT>
__global__ void __launch_bounds__(kThreads) fused_sweeps_resident(
    In in, Out<T> out, const int* __restrict__ stop, int S, int m, int n,
    int n_sweeps, int n_refine, int nbuf, T sigma, T alpha, T beta) {
  // the solve loop's stop flag: a stopped block returns before it touches
  // shared memory or a barrier, and leaves the outputs unwritten
  if (*stop) return;
  constexpr bool kLow = !std::is_same_v<T, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ResLayout L(m, n, sizeof(T), sizeof(MT));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  T* rhs = reinterpret_cast<T*>(smem_raw + L.work);
  T* xt = rhs + r16(static_cast<long long>(n) * sizeof(T)) / sizeof(T);
  T* r = xt + r16(static_cast<long long>(n) * sizeof(T)) / sizeof(T);
  T* v = r + r16(static_cast<long long>(n) * sizeof(T)) / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  // the mixed-precision mode rounds each product's vector operand to bf16
  // once, where the work vector is written (v, r); the rhs and x-tilde stay
  // exact and their rounded copies go to r
  auto op = [](T t) { return kLow ? rnd(t) : t; };

  // each array's slot in a buffer, computed once
  int* slot_off = reinterpret_cast<int*>(smem_raw + 16);
  if (threadIdx.x == 0) {
    int off = 0;
    for (int a = 0; a < kArrays; ++a) {
      slot_off[a] = off;
      off += static_cast<int>(slot_bytes(a, m, n, sizeof(T), sizeof(MT)));
    }
  }
  __syncthreads();
  auto slot = [&](int b, int a) {
    return smem_raw + L.buf + b * L.buf_bytes + slot_off[a];
  };
  // thread 0 asks for the block's k-th scenario in buffer k % nbuf
  auto issue_scenario = [&](int k) {
    const long long s = blockIdx.x + static_cast<long long>(k) * gridDim.x;
    if (s >= S) return;
    const int b = k % nbuf;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int a = 0; a < kArrays; ++a) {
      if (a < 2) {
        span_copy(reinterpret_cast<MT*>(slot(b, a)), scen<MT>(in, a, s, m, n),
                  array_len(a, m, n), bars + b);
      } else {
        span_copy(reinterpret_cast<T*>(slot(b, a)), scen<T>(in, a, s, m, n),
                  array_len(a, m, n), bars + b);
      }
    }
    mbar_arrive(bars + b);
  };
  auto wait_scenario = [&](int k) {
    mbar_wait(bars + k % nbuf, static_cast<uint32_t>((k / nbuf) & 1));
  };

  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < nbuf; ++k) issue_scenario(k);
  }
  for (int k = 0;; ++k) {
    const long long s = blockIdx.x + static_cast<long long>(k) * gridDim.x;
    if (s >= S) break;
    const int b = k % nbuf;
    auto at = [&](int a) {
      return landed(reinterpret_cast<T*>(slot(b, a)), scen<T>(in, a, s, m, n));
    };
    auto atm = [&](int a) {
      return landed(reinterpret_cast<MT*>(slot(b, a)),
                    scen<MT>(in, a, s, m, n));
    };
    const MT *A = atm(0), *Ki = atm(1);
    const T *K = at(2), *q = at(3), *lb = at(4), *ub = at(5), *rx = at(6),
            *cl = at(10), *cu = at(11), *ra = at(12);
    T *x = at(7), *zx = at(8), *yx = at(9), *z = at(13), *y = at(14),
      *Ax = at(15);
    wait_scenario(k);

    auto x_update = [=](int j, T t) {
      const T xa = alpha * t;
      const T zxa = xa + beta * zx[j];
      const T zxn = clip(zxa + yx[j] / rx[j], lb[j], ub[j]);
      yx[j] = yx[j] + rx[j] * (zxa - zxn);
      zx[j] = zxn;
      x[j] = xa + beta * x[j];
    };
    for (int i = tid; i < m; i += nt) v[i] = op(ra[i] * z[i] - y[i]);
    __syncthreads();
    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      // rhs = sigma x - q + A'v + (rho_x zx - yx)
      cols_dot(A, n, v, n, m, [=](int j, T acc) {
        const T rh = ((sigma * x[j] - q[j]) + acc) + (rx[j] * zx[j] - yx[j]);
        rhs[j] = rh;
        if (kLow) r[j] = rnd(rh);
      });
      __syncthreads();
      // xt = K^-1 rhs, then refinement against the exact K; the last apply
      // also updates x, zx, yx
      rows_dot(Ki, n, kLow ? r : rhs, n, n, [=](int j, T acc) {
        xt[j] = acc;
        if (n_refine == 0) x_update(j, acc);
      });
      __syncthreads();
      for (int pass = 0; pass < n_refine; ++pass) {
        rows_dot(K, n, xt, n, n,
                 [=](int j, T acc) { r[j] = op(rhs[j] - acc); });
        __syncthreads();
        rows_dot(Ki, n, r, n, n, [=](int j, T acc) {
          const T t = xt[j] + acc;
          xt[j] = t;
          if (pass == n_refine - 1) x_update(j, t);
        });
        __syncthreads();
      }
      const T* xin = xt;
      if constexpr (kLow) {
        for (int j = tid; j < n; j += nt) r[j] = rnd(xt[j]);
        __syncthreads();
        xin = r;
      }
      // Axt = A xt, each row's z, y, Ax update, and the next sweep's v
      rows_dot(A, n, xin, m, n, [=](int i, T acc) {
        const T axt = alpha * acc;
        const T za = axt + beta * z[i];
        const T zn = clip(za + y[i] / ra[i], cl[i], cu[i]);
        y[i] = y[i] + ra[i] * (za - zn);
        z[i] = zn;
        Ax[i] = axt + beta * Ax[i];
        v[i] = op(ra[i] * zn - y[i]);
      });
      __syncthreads();
    }
    for (int j = tid; j < n; j += nt) {
      out.x[s * n + j] = x[j];
      out.zx[s * n + j] = zx[j];
      out.yx[s * n + j] = yx[j];
    }
    for (int i = tid; i < m; i += nt) {
      out.z[s * m + i] = z[i];
      out.y[s * m + i] = y[i];
      out.Ax[s * m + i] = Ax[i];
    }
    __syncthreads();  // buffer b is read; the copy engine may refill it
    if (tid == 0) issue_scenario(k + nbuf);
  }
}

// Streamed mode: matrix passes of a sweep, in order.
enum Pass { kAcols = 0, kKinv = 1, kK = 2, kArows = 3 };

// One panel of the streamed mode's item sequence: elements [e0, e1) of
// scenario s's matrix `mat` (0 A, 1 K^-1, 2 K).
struct Item {
  long long s;
  int mat;
  long long e0, e1;
};

template <typename T, typename MT>
__global__ void __launch_bounds__(kThreads, 1) fused_sweeps_streamed(
    In in, Out<T> out, T* __restrict__ scratch, const int* __restrict__ stop,
    int S, int m, int n, int n_sweeps, int n_refine, T sigma, T alpha,
    T beta) {
  if (*stop) return;  // the stop flag, as in fused_sweeps_resident
  constexpr bool kLow = !std::is_same_v<T, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StreamLayout L(m, n, sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  unsigned char* stage[2] = {smem_raw + L.stage,
                             smem_raw + L.stage + L.stage_bytes};
  const long long nv = r16(static_cast<long long>(n) * sizeof(T)) / sizeof(T);
  const long long mv = r16(static_cast<long long>(m) * sizeof(T)) / sizeof(T);
  T* rhs = L.vec_smem ? reinterpret_cast<T*>(smem_raw + L.work)
                      : scratch + blockIdx.x * (4 * nv + mv);
  T* xt = rhs + nv;
  T* r = xt + nv;
  T* t = r + nv;
  T* v = t + nv;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  // a panel holds kStageBytes of the working type's entries (fewer bytes
  // of bf16 entries)
  const long long PE = kStageBytes / static_cast<long long>(sizeof(T));
  const long long LA = static_cast<long long>(m) * n;
  const long long LK = static_cast<long long>(n) * n;
  const long long NA = (LA + PE - 1) / PE, NK = (LK + PE - 1) / PE;
  const long long per_sweep = 2 * NA + (1 + 2LL * n_refine) * NK;
  const long long per_scen = n_sweeps * per_sweep;
  const long long my_scens =
      blockIdx.x < S ? (S - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long total = my_scens * per_scen;
  auto op = [](T u) { return kLow ? rnd(u) : u; };

  auto item = [&](long long it) {
    Item d;
    d.s = blockIdx.x + (it / per_scen) * gridDim.x;
    long long w = (it % per_scen) % per_sweep;
    long long c;
    if (w < NA) {
      d.mat = 0;
      c = w;
    } else if ((w -= NA) < NK) {
      d.mat = 1;
      c = w;
    } else if ((w -= NK) < 2LL * n_refine * NK) {
      d.mat = (w / NK) % 2 == 0 ? 2 : 1;
      c = w % NK;
    } else {
      d.mat = 0;
      c = w - 2LL * n_refine * NK;
    }
    const long long len = d.mat == 0 ? LA : LK;
    d.e0 = c * PE;
    d.e1 = d.e0 + PE < len ? d.e0 + PE : len;
    return d;
  };
  // where element e0 of the item's matrix panel sits in its stage buffer
  auto panel = [&](const Item& d, long long it) -> const void* {
    if (d.mat == 2) {
      return landed(reinterpret_cast<T*>(stage[it & 1]),
                    scen<T>(in, 2, d.s, m, n) + d.e0);
    }
    return landed(reinterpret_cast<MT*>(stage[it & 1]),
                  scen<MT>(in, d.mat, d.s, m, n) + d.e0);
  };
  auto issue = [&](long long it) {
    const Item d = item(it);
    uint64_t* bar = bars + (it & 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (d.mat == 2) {
      span_copy(reinterpret_cast<T*>(stage[it & 1]),
                scen<T>(in, 2, d.s, m, n) + d.e0, d.e1 - d.e0, bar);
    } else {
      span_copy(reinterpret_cast<MT*>(stage[it & 1]),
                scen<MT>(in, d.mat, d.s, m, n) + d.e0, d.e1 - d.e0, bar);
    }
    mbar_arrive(bar);
  };

  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && total > 0) issue(0);
  long long it = 0;
  // The panels of one matrix pass, each consumed by f(panel, e0, e1) while
  // the next is in flight.
  auto stream_pass = [&](long long npanels, auto f) {
    for (long long c = 0; c < npanels; ++c, ++it) {
      if (tid == 0 && it + 1 < total) issue(it + 1);
      mbar_wait(bars + (it & 1), static_cast<uint32_t>((it >> 1) & 1));
      const Item d = item(it);
      f(panel(d, it), d.e0, d.e1);
      __syncthreads();  // the stage buffer is free
    }
  };
  // out[o] += sum_k M[o][k] in[k] over the panel's part of each row (row
  // length kd): a warp a row segment, its lanes' sums meeting by shuffles.
  auto rows_panel = [&](auto* pan, long long e0, long long e1, int kd,
                        const T* vin, T* vout) {
    const long long o0 = e0 / kd, o1 = (e1 - 1) / kd;
    for (long long o = o0 + warp; o <= o1; o += nw) {
      const long long a = o * kd > e0 ? o * kd : e0;
      const long long b = (o + 1) * kd < e1 ? (o + 1) * kd : e1;
      T acc = T(0);
      for (long long kb = a + lane; kb < b; kb += 32 * kSumBlock) {
        const long long ke = b - kb < 32 * kSumBlock ? b : kb + 32 * kSumBlock;
        T blk = T(0);
        for (long long e = kb; e < ke; e += 32) {
          blk += widen<T>(pan[e - e0]) * vin[e - o * kd];
        }
        acc += blk;
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) vout[o] += acc;
    }
  };
  auto as_m = [](const void* p) { return static_cast<const MT*>(p); };
  auto as_t = [](const void* p) { return static_cast<const T*>(p); };

  for (long long k = 0; k < my_scens; ++k) {
    const long long s = blockIdx.x + k * gridDim.x;
    const long long on = s * n, om = s * m;
    const T* q = scen<T>(in, 3, s, m, n);
    const T* lb = scen<T>(in, 4, s, m, n);
    const T* ub = scen<T>(in, 5, s, m, n);
    const T* rx = scen<T>(in, 6, s, m, n);
    const T* cl = scen<T>(in, 10, s, m, n);
    const T* cu = scen<T>(in, 11, s, m, n);
    const T* ra = scen<T>(in, 12, s, m, n);
    T *x = out.x + on, *zx = out.zx + on, *yx = out.yx + on;
    T *z = out.z + om, *y = out.y + om, *Ax = out.Ax + om;
    // the state moves into the outputs, which carry it across sweeps
    for (int j = tid; j < n; j += nt) {
      x[j] = scen<T>(in, 7, s, m, n)[j];
      zx[j] = scen<T>(in, 8, s, m, n)[j];
      yx[j] = scen<T>(in, 9, s, m, n)[j];
    }
    for (int i = tid; i < m; i += nt) {
      z[i] = scen<T>(in, 13, s, m, n)[i];
      y[i] = scen<T>(in, 14, s, m, n)[i];
      Ax[i] = scen<T>(in, 15, s, m, n)[i];
    }
    __syncthreads();
    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      for (int i = tid; i < m; i += nt) v[i] = op(ra[i] * z[i] - y[i]);
      for (int j = tid; j < n; j += nt) rhs[j] = T(0);
      __syncthreads();
      // A'v: each panel's rows added into the columns' sums
      stream_pass(NA, [=](const void* p, long long e0, long long e1) {
        const MT* pan = as_m(p);
        const long long i0 = e0 / n, i1 = (e1 - 1) / n;
        for (int j = tid; j < n; j += nt) {
          T acc = T(0);
          for (long long i = i0; i <= i1; ++i) {
            const long long e = i * n + j;
            if (e >= e0 && e < e1) acc += widen<T>(pan[e - e0]) * v[i];
          }
          rhs[j] += acc;
        }
      });
      for (int j = tid; j < n; j += nt) {
        rhs[j] = ((sigma * x[j] - q[j]) + rhs[j]) + (rx[j] * zx[j] - yx[j]);
        // the rounded rhs, the K^-1 operand, in r (free until the defect)
        if (kLow) r[j] = rnd(rhs[j]);
        xt[j] = T(0);
      }
      __syncthreads();
      stream_pass(NK, [=](const void* p, long long e0, long long e1) {
        rows_panel(as_m(p), e0, e1, n, kLow ? r : rhs, xt);
      });
      for (int pass = 0; pass < n_refine; ++pass) {
        for (int j = tid; j < n; j += nt) t[j] = T(0);
        __syncthreads();
        stream_pass(NK, [=](const void* p, long long e0, long long e1) {
          rows_panel(as_t(p), e0, e1, n, xt, t);
        });
        for (int j = tid; j < n; j += nt) {
          r[j] = op(rhs[j] - t[j]);
          t[j] = T(0);
        }
        __syncthreads();
        stream_pass(NK, [=](const void* p, long long e0, long long e1) {
          rows_panel(as_m(p), e0, e1, n, r, t);
        });
        for (int j = tid; j < n; j += nt) xt[j] += t[j];
        __syncthreads();
      }
      // the A xt operand: x-tilde, rounded into r in the mixed mode
      for (int j = tid; j < n; j += nt) {
        if (kLow) r[j] = rnd(xt[j]);
      }
      for (int i = tid; i < m; i += nt) v[i] = T(0);
      __syncthreads();
      stream_pass(NA, [=](const void* p, long long e0, long long e1) {
        rows_panel(as_m(p), e0, e1, n, kLow ? r : xt, v);
      });
      // relaxed primal/dual updates: each thread owns its indices
      for (int j = tid; j < n; j += nt) {
        const T xa = alpha * xt[j];
        const T zxa = xa + beta * zx[j];
        const T zxn = clip(zxa + yx[j] / rx[j], lb[j], ub[j]);
        yx[j] = yx[j] + rx[j] * (zxa - zxn);
        zx[j] = zxn;
        x[j] = xa + beta * x[j];
      }
      for (int i = tid; i < m; i += nt) {
        const T axt = alpha * v[i];
        const T za = axt + beta * z[i];
        const T zn = clip(za + y[i] / ra[i], cl[i], cu[i]);
        y[i] = y[i] + ra[i] * (za - zn);
        z[i] = zn;
        Ax[i] = axt + beta * Ax[i];
      }
      __syncthreads();
    }
  }
}

// Blocks of `kern` an SM can hold with `threads` and `smem` bytes, cached
// per kernel and shape.
template <typename K>
int blocks_per_sm(K kern, int threads, long long smem, int* out) {
  static const void* seen_fn[8];
  static long long seen[8][3];
  static int nseen = 0;
  const void* fn = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < nseen; ++i) {
    if (seen_fn[i] == fn && seen[i][0] == smem && seen[i][1] == threads) {
      *out = static_cast<int>(seen[i][2]);
      return 0;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, threads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int i = nseen < 8 ? nseen++ : 7;
  seen_fn[i] = fn;
  seen[i][0] = smem;
  seen[i][1] = threads;
  seen[i][2] = nb;
  *out = nb;
  return 0;
}

template <typename T, typename MT>
int launch_mat(void* const* inp, void* const* outp, const int* stop, int S,
               int m, int n, int n_sweeps, int n_refine, int mode, int nsm,
               double sigma, double alpha, void* stream) {
  In in;
  // the wrapper's order: q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z,
  // zx, y, yx, Ax; slot order: A, K^-1, K, q, lb, ub, rho_x, x, zx, yx, cl,
  // cu, rho_a, z, y, Ax
  const int order[kArrays] = {1, 2, 3, 0, 6, 7, 9, 10, 12, 14, 4, 5, 8, 11,
                              13, 15};
  for (int a = 0; a < kArrays; ++a) in.a[a] = inp[order[a]];
  Out<T> out{static_cast<T*>(outp[0]), static_cast<T*>(outp[1]),
             static_cast<T*>(outp[2]), static_cast<T*>(outp[3]),
             static_cast<T*>(outp[4]), static_cast<T*>(outp[5])};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T sg = static_cast<T>(sigma), al = static_cast<T>(alpha),
          be = static_cast<T>(1.0 - alpha);
  int nb = 0, err = 0;
  if (mode == 0) {
    const ResLayout L(m, n, sizeof(T), sizeof(MT));
    if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
    // a thread an output row or column
    const int widest = m > n ? m : n;
    int threads = (widest + 31) / 32 * 32;
    threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
    // Two buffers a block (the next scenario's copy in flight while one
    // sweeps) where blocks walk several scenarios and the second buffer
    // keeps more than half the blocks an SM; else one, and the blocks an
    // SM overlap each other's copies (measured faster at farmer's shape,
    // where one buffer fits twice as many blocks).
    const long long one = L.buf + L.buf_bytes;
    err = blocks_per_sm(fused_sweeps_resident<T, MT>, threads, one, &nb);
    if (err != 0) return err;
    int nbuf = 1;
    long long smem = one;
    if (S > static_cast<long long>(nsm) * nb) {
      int nb2 = 0;
      err = blocks_per_sm(fused_sweeps_resident<T, MT>, threads, L.total,
                          &nb2);
      if (err != 0) return err;
      if (2 * nb2 > nb) {
        nbuf = 2;
        smem = L.total;
        nb = nb2;
      }
    }
    const long long want = static_cast<long long>(nsm) * nb;
    const int grid = static_cast<int>(S < want ? S : want);
    fused_sweeps_resident<T, MT><<<grid, threads, smem, st>>>(
        in, out, stop, S, m, n, n_sweeps, n_refine, nbuf, sg, al, be);
  } else {
    const StreamLayout L(m, n, sizeof(T));
    err = blocks_per_sm(fused_sweeps_streamed<T, MT>, kThreads, L.total, &nb);
    if (err != 0) return err;
    const int grid = S < nsm ? S : nsm;
    fused_sweeps_streamed<T, MT><<<grid, kThreads, L.total, st>>>(
        in, out, static_cast<T*>(outp[6]), stop, S, m, n, n_sweeps,
        n_refine, sg, al, be);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* const* inp, void* const* outp, const int* stop, int S,
           int m, int n, int n_sweeps, int n_refine, int mode, int nsm,
           int prec, double sigma, double alpha, void* stream) {
  if (S < 1 || n < 1 || m < 0 || nsm < 1 || mode < 0 || mode > 1 ||
      prec < 0 || prec > 1 || stop == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (prec == 1) {
    return launch_mat<T, __nv_bfloat16>(inp, outp, stop, S, m, n, n_sweeps,
                                        n_refine, mode, nsm, sigma, alpha,
                                        stream);
  }
  return launch_mat<T, T>(inp, outp, stop, S, m, n, n_sweeps, n_refine, mode,
                          nsm, sigma, alpha, stream);
}

}  // namespace

extern "C" {

// in:  q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax
//      (prec 1: A and Kinv bf16, the rest the working type)
// out: x, z, zx, y, yx, Ax, then (streamed mode) the work-vector scratch,
//      min(S, nsm) * (4 n + m) values padded to 16 bytes per vector, unless
//      they fit shared memory
// stop: a device int, the solve loop's stop flag; where it is set every
// block returns at once and the outputs are left unwritten.
// mode: 0 resident, 1 streamed (cuda_kernels.dense_layout); nsm: the
// card's SM count; prec: 0 exact, 1 the mixed-precision mode ("default").
// Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_f32(void* const* in, void* const* out,
                             const int* stop, int S, int m, int n,
                             int n_sweeps, int n_refine, int mode, int nsm,
                             int prec, double sigma, double alpha,
                             void* stream) {
  return launch<float>(in, out, stop, S, m, n, n_sweeps, n_refine, mode, nsm,
                       prec, sigma, alpha, stream);
}

int tpusppy_fused_sweeps_f64(void* const* in, void* const* out,
                             const int* stop, int S, int m, int n,
                             int n_sweeps, int n_refine, int mode, int nsm,
                             int prec, double sigma, double alpha,
                             void* stream) {
  return launch<double>(in, out, stop, S, m, n, n_sweeps, n_refine, mode,
                        nsm, prec, sigma, alpha, stream);
}

}  // extern "C"

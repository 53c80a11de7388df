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
// block (or a cluster of blocks) takes one scenario at a time, so no
// transposes exist.
//
// Bound.  Each sweep is 4mn + 2n^2(1 + 2 n_refine) flops a scenario; the
// call must read A, K^-1 and K once, (mn + 2n^2) * itemsize a scenario.  At
// every shape the main paths run (farmer S=1000 m=28 n=44: 97 MFLOP and
// 20.4 MB in f32; the bundled buckets; sizes; sslp) the bytes over 3.35
// TB/s take far longer than the flops over 67 TFLOP/s (the card's f32 CUDA
// core and f64 tensor core peak): the call is bound by memory.  Each
// product is a matrix-vector product with one right-hand side a scenario,
// so tensor cores do not help: an mma tile would be 1/8 (f64) to 1/16 used
// and the operands would still come from shared memory at the same rate.
// The design's gains come from shared memory, clusters and asynchronous
// copies: a matrix entry is read from device memory once a call where the
// card can hold it, and every SM works whatever S is.
//
// Three modes (cuda_kernels.dense_layout picks; the wrapper counts launches
// by mode in cuda_kernels.dense_modes):
//
// Resident (one scenario's 16 arrays fit one block's shared memory):
// persistent blocks, each walking its scenarios, a scenario's arrays
// brought in by bulk asynchronous copies (cp.async.bulk, completion on an
// mbarrier).  The copy engine needs 16-byte-aligned sources and sizes, and
// a scenario's rows start anywhere: each array is copied as the
// 16-byte-aligned span that holds it, into its own slot, and read from
// where its first element landed (rows keep their natural stride).  A
// block holds two buffers, the next scenario's copy in flight while one
// sweeps, where two fit and the second buffer keeps more than half the
// blocks an SM; else one, and the SM's blocks overlap each other's copies:
// at farmer's shape one buffer fits 9 blocks an SM in f32 (4 in f64)
// against 4 (2) with two, and every scenario is in flight at once.  Where
// only one buffer fits (bundled farmer's (84, 108) in f32, 135 KB) the
// block runs with one.  A thread takes one output row (or column, for
// A'v), with 16-byte reads of 16-byte rows (farmer's) and otherwise a
// start rotated by row so a warp's reads fall in distinct banks; the
// elementwise updates ride in the epilogue of the product that produces
// their input (x, zx, yx in the last K^-1 apply, z, y, Ax and the next v in
// A xt): 3 + 2 n_refine barriers a sweep.  Bound by its shared-memory
// reads (a product's chain of dependent reads) and, with one buffer, by
// the copy that waits for the buffer.
//
// Cluster (a scenario does not fit one block, but its arrays cut into C
// row blocks fit C CTAs, C in {2, 4, 8, 16}, the least that fits; where S C
// would leave SMs idle, as at sizes' S=3, a larger C, up to what the card's
// cluster occupancy allows): a thread-block cluster takes a scenario, CTA
// c holding A's rows [c m / C, (c+1) m / C) and K^-1's and K's rows
// [c n / C, (c+1) n / C), brought in once a scenario by bulk copies (the
// next scenario's in flight where a second buffer fits).  Each product
// computes the CTA's own rows, a group of lanes a row (8 lanes reading 16
// bytes each, so that a quarter-warp's reads are one row's 128 contiguous
// bytes and never collide, two rows a thread at once; 32 down to 1 lanes of
// 4- or 8-byte reads where the rows are not 16-byte aligned), the group's
// sums meeting by shuffles, and its epilogue writes the rows' results into
// every CTA's copy of the vector through distributed shared memory (a lane
// a destination CTA), then the cluster meets a barrier.cluster before the
// next product reads it.  A'v runs as partial
// column sums over the CTA's A rows, which each CTA then reduces over the
// cluster for its own slice of columns (the K rows it owns) by reading
// its peers' partial sums.  The elementwise updates run in the epilogues
// as in the resident mode, each CTA on its own rows: 3 + 2 n_refine
// cluster barriers a sweep.  Bound by latency, not bytes: the cluster
// barriers and the remote stores before them take 35-41% of a call at
// bundled farmer's f64 bucket and at sizes (made block barriers and local
// stores), the K^-1 products most of the rest, and the card places one
// CTA a cluster an SM whatever the shared memory (66 clusters of 2, 30 of
// 4, 15 of 8, 7 of 16 on an H100 SXM), so a scenario's 4 sweeps take
// 43-63 us whatever C, and the least C that fits keeps the most scenarios
// in flight (scripts/port_dense_ablation.py --clusters, PERF.md §6).
//
// Streamed (a scenario fits no cluster: sslp's (60, 520) in f64, 4.6 MB):
// the cluster mode at the largest cluster the card places (16 on an H100
// SXM, where the occupancy query shows it; else 8), with each CTA holding
// as many of its K^-1 rows as fit (at sslp in f64 all of them: a 16-CTA
// cluster holds 3.6 MB), then of its A rows, then of its K rows (15 of 33
// at sslp), and reading the rest again at every pass that needs them.
// The K^-1 and K rows not held are read by the products straight from
// device memory (L2), 16-byte loads of every lane group in flight at once
// with nothing staged: measured twice as fast as staging them through a
// ring of bulk copies, where ns - 1 copies in flight bound the rate and
// the ring cannot fetch during the K^-1 products before a K pass (sslp in
// f64: 1.898 ms through the ring, 0.886 read directly, plain 1.289;
// PERF.md §6).  A's rows not held pass through a ring of three to six
// stages instead (A'v reads A down its columns, which staged panels serve
// and direct reads do not): a stage holds the whole rows that fit 16 KB,
// thread 0 keeps ns - 1 bulk copies in flight ahead of the one the warps
// read, each stage with a `full` mbarrier (the copy's bytes) and an
// `empty` one (each warp arrives when done with it), and thread 0 writes
// each panel's descriptor beside its stage and waits on the `empty` of
// the stage it refills, a panel behind, so no block-wide barrier stands
// between panels; a row longer than 16 KB comes as segments, which the
// block's threads share and meet over once at the row's end; the ring
// runs on across passes and scenarios, and where every A row is held
// there is none.  Its yardstick beside the bound is the re-stream floor:
// the bytes a launch reads again (the rows not held, every pass) over 3.35
// TB/s (cuda_kernels.dense_matrix_reads).  No limit comes from m or n:
// where the full-length work vectors and the CTA's rows of the state do
// not fit beside the ring, they live in device-memory scratch (one copy a
// cluster, which the cluster barrier orders as it does shared memory), and
// the state in the output buffers.
//
// The stop flag: the solve loop runs its sweep blocks as CUDA-graph
// replays (tpusppy_torch/solvers/device_loop.py) and keeps its exit vote in
// a device int that stays set once set.  Every block reads it first and
// returns where it is set, before any barrier or copy; an earlier kernel
// of the stream wrote it, so every CTA of a cluster reads the same value
// and takes the same exit, and none waits on a partner that has left.  A
// cluster's CTAs meet a last barrier.cluster before they exit, so none
// leaves while a peer may still read its shared memory.  A block past the
// loop's exit costs one launch; the graph's commit then keeps the old
// state.
//
// The mixed-precision mode (prec 1, the TPU kernel's "default" branch,
// pallas_kernels.py:90-112): A and K^-1 arrive in bf16 (made once per set
// of matrices by the wrapper, cuda_kernels.dense_operand) and stay bf16 in
// shared memory and the stage panels, an entry widened to the working
// type as it is read; the vector operand of each A', K^-1 and A product is
// rounded to bf16 (through f32, round to nearest even, also in f64 runs)
// once, into the work vector the product reads (v, r; in the cluster
// modes w and u, written rounded by the epilogue that makes them), and the
// products and sums run in the working type; K stays in the working type
// and the defect rhs - K xt is exact.  The bytes a scenario moves fall
// from (mn + 2n^2) to (mn + n^2) * 2 + n^2 * itemsize (0.65x at farmer's
// shape in f32), and every mode's buffers shrink with them.  The TPU
// kernel's "high" is its exact path (the per-scenario products have no MXU
// passes to save), so this kernel has no "high" of its own.
//
// What was measured (chip_smoke.py phase `kernels`, PERF.md §6, H100 SXM at
// 700 W): the resident mode's design (PR 5) spent most of a call on its
// sweeps' chains of dependent shared-memory reads, not on arithmetic, so
// it shortens the chain and keeps as many scenarios in flight an SM as
// fit (scripts/port_shared_ablation.py's two_buffers variant times the
// double-buffered alternative).  The one-block streamed mode the cluster
// modes replace ran 48-63x its bound at the bucket shapes: one block an SM
// and one scenario at a time, every matrix re-read every sweep through two
// 32 KB panels with a block barrier after each.  Where one buffer fits one
// block but two do not, the resident mode with one buffer and a cluster
// of 2 both take the shape; the picker takes the resident mode there,
// measured 1.3-4.0x faster at bundled farmer's and netdes' f32 buckets and
// at farmer's crops_multiplier=12 (the cluster pays its barriers; one
// block holds the whole scenario), except where the scenarios are too few
// to fill an eighth of the SMs (sizes' S=3: a cluster of 16, 1.5x faster
// than 3 resident blocks) (chip_smoke.py phase `kernels`, which times
// both; scripts/port_dense_modes.py --alternatives).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps.so fused_sweeps.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// Threads per block (cuda_kernels._DENSE_THREADS).
constexpr int kThreads = 256;
// Shared memory one block may use on Hopper (cuda_kernels.SMEM_LIMIT).
constexpr long long kSmemLimit = 232448;
// Bytes of one stage of the streamed mode's ring, and the slack a span
// copy needs beside it (cuda_kernels._STAGE_BYTES).
constexpr long long kStageBytes = 16384;
// Largest cluster of the cluster modes (cuda_kernels.MAX_DENSE_CLUSTER);
// past 8 it needs the card's non-portable cluster sizes.
constexpr int kMaxCluster = 16;
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals (and the bytes
// announced on it).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
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
// matrices fit one block's shared memory), so the chains stay short.  M may hold
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

// Byte offsets of one CTA's shared memory in the cluster modes
// (cuda_kernels._cluster_offsets mirrors it): the mbarriers (two for the
// held buffers, then `full` and `empty` for each of the ns stages) and the
// stages' panel descriptors (32 bytes each), then where they fit
// (vec_smem) the full-length work vectors w, xt, the partial sums of A'v
// and, in the mixed-precision mode, u (n each) and the CTA's own rows of
// rhs, x, zx, yx, q, lb, ub, rho_x (nk each) and of z, y, Ax, cl, cu,
// rho_a, v (mk each), then nbuf buffers of the held rows (A's hA, K^-1's
// hKi, K's hK, each in a slot 16 bytes past its rounded size), then the ns
// stages, each sp bytes of panel and 32 of slack for its span.  nk and mk
// are the most rows of K and of A a CTA owns; a CTA holds min(its rows, h)
// of each matrix.
struct ClusterLayout {
  long long vec, own, held, stage, total, slotA, slotKi, slotK, buf_bytes,
      stage_bytes;
  int nk, mk;
  __host__ __device__ ClusterLayout(int m, int n, int isz, int msz, int C,
                                    int hA, int hKi, int hK, int nbuf, int ns,
                                    int sp, bool vec_smem) {
    nk = (n + C - 1) / C;
    mk = (m + C - 1) / C;
    vec = r16(8LL * (2 + 2 * ns) + 32LL * ns);
    const int nvec = msz < isz ? 4 : 3;  // u only in the mixed mode
    own = vec + (vec_smem ? nvec * r16(static_cast<long long>(n) * isz) : 0);
    held = own + (vec_smem ? 8 * r16(static_cast<long long>(nk) * isz) +
                                 7 * r16(static_cast<long long>(mk) * isz)
                           : 0);
    slotA = hA > 0 ? r16(static_cast<long long>(hA) * n * msz) + 16 : 0;
    slotKi = hKi > 0 ? r16(static_cast<long long>(hKi) * n * msz) + 16 : 0;
    slotK = hK > 0 ? r16(static_cast<long long>(hK) * n * isz) + 16 : 0;
    buf_bytes = slotA + slotKi + slotK;
    stage = held + nbuf * buf_bytes;
    stage_bytes = r16(sp) + 32;
    total = stage + ns * stage_bytes;
  }
};

// Barrier of every thread of every CTA of the cluster, ordering their
// shared- and device-memory writes before the reads that follow
// (barrier.cluster with release/acquire; every thread reaches it
// converged).
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The sum of v over the g lanes of an aligned group of g (a power of two
// up to 32) lanes, on every lane of the group.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// The lanes of the calling lane's aligned group of g lanes.
__device__ __forceinline__ unsigned group_mask(int g) {
  const unsigned ones = g == 32 ? 0xffffffffu : (1u << g) - 1u;
  return ones << ((threadIdx.x & 31) & ~(g - 1));
}

// Lanes a row of the cluster modes' products (a power of two up to 32):
// the most with which the block's threads hold all nr rows at once, so
// every thread works and a row's chain of reads is n / g long; but at
// least enough that the groups of a warp, reading rows `stride` bytes
// apart, fall in distinct banks: where the stride is a multiple of 64
// bytes (sslp's n=520 in f64) groups of 32 bytes would all meet in two
// windows of the 128-byte bank line.  Entries of `esz` bytes.
__device__ __forceinline__ int row_lanes(int nr, long long stride, int esz) {
  int g = 32;
  while (g > 1 && nr * g > static_cast<int>(blockDim.x)) g >>= 1;
  long long low = stride & -stride;  // the stride's largest power of two
  if (low == 0 || low > 128) low = 128;
  const int need = static_cast<int>(low) / esz;
  return g < need ? (need < 32 ? need : 32) : g;
}

// R rows of group_rows' block at once: rows r0 + gi + q per (q < R) of
// the thread's group, each in two sums, the operand read once for all R.
template <int R, typename T, typename MM, typename Epi>
__device__ __forceinline__ void rows_round(const MM* M, long long ld, int nr,
                                           int r0, int per, int gi, int l,
                                           int g, const T* in, int kd,
                                           Epi epi) {
  const MM* row[R];
  T s0[R], s1[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = r0 + gi + q * per;
    row[q] = M + (r < nr ? r : nr - 1) * ld;
    s0[q] = T(0);
    s1[q] = T(0);
  }
  int k = l;
#pragma unroll 2
  for (; k + g < kd; k += 2 * g) {
    const T a = in[k], b = in[k + g];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      s0[q] += widen<T>(row[q][k]) * a;
      s1[q] += widen<T>(row[q][k + g]) * b;
    }
  }
  if (k < kd) {
    const T a = in[k];
#pragma unroll
    for (int q = 0; q < R; ++q) s0[q] += widen<T>(row[q][k]) * a;
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const T acc = group_sum(s0[q] + s1[q], g);
    const int r = r0 + gi + q * per;
    if (r < nr) epi(r, acc, l, g);
  }
}

// rows_round with 16-byte reads: lane l of the group reads vectors l, l + g,
// ... of the row and of `in` (g a multiple of 8: a quarter-warp's eight
// 16-byte reads are one group's 128 contiguous bytes, so no two collide
// whatever the row stride).  M, `in` and the row stride 16-byte aligned,
// the working type throughout.
template <int R, typename T, typename Epi>
__device__ __forceinline__ void rows_round_vec(const T* M, long long ld,
                                               int nr, int r0, int per,
                                               int gi, int l, int g,
                                               const T* in, int kd,
                                               Epi epi) {
  using V = typename Vec16<T>::type;
  constexpr int W = 16 / sizeof(T);
  const int kv = kd / W;
  const V* iv = reinterpret_cast<const V*>(in);
  const V* row[R];
  bool ok[R];
  T s0[R], s1[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = r0 + gi + q * per;
    ok[q] = r < nr;
    row[q] = reinterpret_cast<const V*>(M + (ok[q] ? r : 0) * ld);
    s0[q] = T(0);
    s1[q] = T(0);
  }
#pragma unroll 4
  for (int t = l; t < kv; t += g) {
    const V b = iv[t];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (ok[q]) {
        const V a = row[q][t];
        if constexpr (W == 2) {
          s0[q] += a.x * b.x;
          s1[q] += a.y * b.y;
        } else {
          s0[q] += a.x * b.x;
          s1[q] += a.y * b.y;
          s0[q] += a.z * b.z;
          s1[q] += a.w * b.w;
        }
      }
    }
  }
  for (int k = kv * W + l; k < kd; k += g) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (ok[q]) s0[q] += M[(r0 + gi + q * per) * ld + k] * in[k];
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const T acc = group_sum(s0[q] + s1[q], g);
    if (ok[q]) epi(r0 + gi + q * per, acc, l, g);
  }
}

// acc(r) = sum_{k < kd} M[r * ld + k] * in[k] for the rows r < nr of a
// row-major block: g = row_lanes(nr, ld, sizeof(MM)) lanes a row
// (consecutive lanes of one warp), lane l of the group taking k = l, l + g,
// ... (a group reads consecutive words), each thread up to four rows at
// once (their reads in flight together, the operand read once for them),
// the group's sums meeting by shuffles.  epi(r, acc, l, g) then runs on
// every lane of the row's group with the same acc.  Every lane of a warp
// runs the same rounds, so the shuffles see the whole warp.  M may hold
// bf16 entries (MM), widened to T as they are read.
template <typename T, typename MM, typename Epi>
__device__ __forceinline__ void group_rows(const MM* M, long long ld, int nr,
                                           const T* in, int kd, Epi epi) {
  if (nr <= 0) return;
  if constexpr (std::is_same_v<T, MM>) {
    // 16-byte reads where the rows and `in` allow them, 8 lanes a row, two
    // rows a thread at once
    const bool vec = ((ld * static_cast<long long>(sizeof(T))) & 15) == 0 &&
                     ((reinterpret_cast<uintptr_t>(M) |
                       reinterpret_cast<uintptr_t>(in)) & 15) == 0;
    if (vec) {
      const int g = 8;  // measured best at every shape of the paths
      const int l = threadIdx.x & (g - 1), gi = threadIdx.x / g;
      const int per = blockDim.x / g;
      for (int r0 = 0; r0 < nr; r0 += 2 * per) {
        if (nr - r0 > per) {
          rows_round_vec<2>(M, ld, nr, r0, per, gi, l, g, in, kd, epi);
        } else {
          rows_round_vec<1>(M, ld, nr, r0, per, gi, l, g, in, kd, epi);
        }
      }
      return;
    }
  }
  const int g = row_lanes(nr, ld * static_cast<long long>(sizeof(MM)),
                          static_cast<int>(sizeof(MM)));
  const int l = threadIdx.x & (g - 1), gi = threadIdx.x / g;
  const int per = blockDim.x / g;
  for (int r0 = 0; r0 < nr; r0 += 4 * per) {
    const int rounds = (nr - r0 + per - 1) / per;
    if (rounds >= 4) {
      rows_round<4>(M, ld, nr, r0, per, gi, l, g, in, kd, epi);
    } else if (rounds == 3) {
      rows_round<3>(M, ld, nr, r0, per, gi, l, g, in, kd, epi);
    } else if (rounds == 2) {
      rows_round<2>(M, ld, nr, r0, per, gi, l, g, in, kd, epi);
    } else {
      rows_round<1>(M, ld, nr, r0, per, gi, l, g, in, kd, epi);
    }
  }
}

// One panel of the streamed mode's ring: the CTA's A rows [r0, r0 + nr)
// (counted from its first A row), columns [c0, c0 + nc), of scenario s.
// Whole rows (nc == n), or one segment of one row.  32 bytes: the producer
// writes it beside the stage it fills.
struct Panel {
  long long s;
  int r0, nr, c0, nc, pad[2];
};

template <typename T, typename MT>
__global__ void __launch_bounds__(kThreads, 1) fused_sweeps_cluster(
    In in, Out<T> out, T* __restrict__ scratch, const int* __restrict__ stop,
    int S, int m, int n, int n_sweeps, int n_refine, int C, int hA, int hKi,
    int hK, int nbuf, int ns, int sp, int vec_smem, T sigma, T alpha,
    T beta) {
  // the solve loop's stop flag: every CTA of the cluster reads the same
  // value and returns before any barrier, copy or peer access
  if (*stop) return;
  constexpr bool kLow = !std::is_same_v<T, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const bool vs = vec_smem != 0;
  const ClusterLayout L(m, n, sizeof(T), sizeof(MT), C, hA, hKi, hK, nbuf,
                        ns, sp, vs);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int nw = nt >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / C, ncl = gridDim.x / C;
  // this CTA's rows: A's [a0, a0 + ra), K^-1's and K's [k0, k0 + rk)
  const int a0 = static_cast<int>(static_cast<long long>(rank) * m / C);
  const int ra =
      static_cast<int>(static_cast<long long>(rank + 1) * m / C) - a0;
  const int k0 = static_cast<int>(static_cast<long long>(rank) * n / C);
  const int rk =
      static_cast<int>(static_cast<long long>(rank + 1) * n / C) - k0;
  const int hAc = ra < hA ? ra : hA, hKic = rk < hKi ? rk : hKi;
  const int hKc = rk < hK ? rk : hK;
  const bool any_held = hAc + hKic + hKc > 0;
  auto op = [](T t) { return kLow ? rnd(t) : t; };

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* full = bars + 2;
  uint64_t* empty = full + ns;
  Panel* desc = reinterpret_cast<Panel*>(empty + ns);

  // the work vectors: w (the K^-1 operand: rhs, then each defect), xt,
  // the A'v partial sums and u (rounded xt, the mixed mode's A operand;
  // xt itself in the exact mode), full length; the CTA's own rows of rhs
  // and v
  const long long nvE = r16(static_cast<long long>(n) * sizeof(T)) /
                        static_cast<long long>(sizeof(T));
  const long long nkE = r16(static_cast<long long>(L.nk) * sizeof(T)) /
                        static_cast<long long>(sizeof(T));
  const long long mkE = r16(static_cast<long long>(L.mk) * sizeof(T)) /
                        static_cast<long long>(sizeof(T));
  const long long E = 4 * nvE + nkE + mkE;  // a CTA's scratch, device mode
  T *w, *xt, *u, *part, *rhs, *v;
  T* slots = nullptr;  // the own rows of the state, vec_smem
  if (vs) {
    w = reinterpret_cast<T*>(smem_raw + L.vec);
    xt = w + nvE;
    part = xt + nvE;
    u = kLow ? part + nvE : xt;
    slots = reinterpret_cast<T*>(smem_raw + L.own);
    rhs = slots;
    v = slots + 8 * nkE + 6 * mkE;
  } else {
    // one copy of w, xt and u a cluster (its rank 0's region), partial
    // sums, rhs and v a CTA
    T* cbase = scratch + static_cast<long long>(cid) * C * E;
    w = cbase;
    xt = w + nvE;
    u = kLow ? xt + nvE : xt;
    part = cbase + rank * E + 3 * nvE;
    rhs = part + nvE;
    v = rhs + nkE;
  }
  auto peer_part = [&](int r) -> const T* {
    return vs ? cluster.map_shared_rank(part, r)
              : scratch + (static_cast<long long>(cid) * C + r) * E + 3 * nvE;
  };
  // entry j of every CTA's copy of buf, from the g lanes of a group that
  // all hold val (lane l of the group writes the copies of ranks l, l + g,
  // ...; one copy a cluster in device memory)
  auto put = [&](T* buf, int j, T val, int l, int g) {
    if (vs) {
      for (int r = l; r < C; r += g) cluster.map_shared_rank(buf, r)[j] = val;
    } else if (l == 0) {
      buf[j] = val;
    }
  };

  // held rows: buffer b's slots
  auto held = [&](int b) { return smem_raw + L.held + b * L.buf_bytes; };
  auto held_src = [&](int a, long long s) {
    const long long row = a == 0 ? a0 : k0;
    return static_cast<const unsigned char*>(in.a[a]) +
           (s * array_len(a, m, n) + row * n) * elem_bytes(a, sizeof(T),
                                                           sizeof(MT));
  };
  // thread 0 asks for the cluster's k-th scenario's held rows in buffer
  // k % nbuf
  auto issue_held = [&](long long k) {
    const long long s = cid + k * ncl;
    if (s >= S || !any_held) return;
    const int b = static_cast<int>(k % nbuf);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    span_copy(reinterpret_cast<MT*>(held(b)),
              reinterpret_cast<const MT*>(held_src(0, s)),
              static_cast<long long>(hAc) * n, bars + b);
    span_copy(reinterpret_cast<MT*>(held(b) + L.slotA),
              reinterpret_cast<const MT*>(held_src(1, s)),
              static_cast<long long>(hKic) * n, bars + b);
    span_copy(reinterpret_cast<T*>(held(b) + L.slotA + L.slotKi),
              reinterpret_cast<const T*>(held_src(2, s)),
              static_cast<long long>(hKc) * n, bars + b);
    mbar_arrive(bars + b);
  };

  // A's streamed rows, panel by panel, in the order the sweeps read them:
  // two passes a sweep (A'v, then A xt).  A panel is P rows (the stage's sp
  // bytes of entries over n), or, for rows longer than a stage, `segs`
  // segments a row.  The streamed rows of K^-1 and K need no ring: the
  // products read them straight from device memory.
  const int SE = sp / static_cast<int>(sizeof(MT));
  const int sa = ra - hAc;  // A's streamed rows
  const int NA = sa <= 0 ? 0
                         : (n <= SE ? (sa + SE / n - 1) / (SE / n)
                                    : sa * ((n + SE - 1) / SE));
  const long long my_scens = cid < S ? (S - 1 - cid) / ncl + 1 : 0;
  const long long total = ns > 0 ? my_scens * n_sweeps * 2LL * NA : 0;
  // thread 0's cursor over the panels it issues: scenario, pass of the
  // scenario, panel within the pass; the stage it fills next
  long long pk = 0, issued = 0;
  int pp = 0, pc = 0, pst = 0;
  uint32_t pph = 0;  // the phase of stage pst's round
  auto a_src = [&](const Panel& d) {
    return static_cast<const MT*>(in.a[0]) +
           (d.s * m + a0 + d.r0) * static_cast<long long>(n) + d.c0;
  };
  auto issue_next = [&]() {
    if (pc == NA) {  // past a pass
      pc = 0;
      if (++pp == 2 * n_sweeps) {
        pp = 0;
        ++pk;
      }
    }
    Panel d;
    d.s = cid + pk * ncl;
    if (n <= SE) {
      const int P = SE / n;
      d.r0 = hAc + pc * P;
      d.nr = sa - pc * P < P ? sa - pc * P : P;
      d.c0 = 0;
      d.nc = n;
    } else {
      const int segs = (n + SE - 1) / SE;
      d.r0 = hAc + pc / segs;
      d.nr = 1;
      d.c0 = (pc % segs) * SE;
      d.nc = n - d.c0 < SE ? n - d.c0 : SE;
    }
    d.pad[0] = d.pad[1] = 0;
    desc[pst] = d;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    span_copy(reinterpret_cast<MT*>(smem_raw + L.stage + pst * L.stage_bytes),
              a_src(d), static_cast<long long>(d.nr - 1) * n + d.nc,
              full + pst);
    mbar_arrive(full + pst);
    ++pc;
    ++issued;
    if (++pst == ns) {
      pst = 0;
      pph ^= 1u;
    }
  };

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    for (int q = 0; q < ns; ++q) {
      mbar_init(full + q, 1);
      mbar_init(empty + q, nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < nbuf; ++k) issue_held(k);
    while (issued + 1 < ns && issued < total) issue_next();
  }
  // every thread's place in the panel sequence: the stage it reads next
  // and that stage's phase
  int cst = 0;
  uint32_t cph = 0;
  // The next np panels: thread 0 first issues the panel ns - 1 ahead into
  // the stage the previous panel used (once every warp has left it), then
  // every warp waits for this panel's bytes, runs f on it and marks the
  // stage free.
  auto stream = [&](int np, auto f) {
    for (int c = 0; c < np; ++c) {
      if (tid == 0 && issued < total) {
        if (issued >= ns) mbar_wait(empty + pst, pph ^ 1u);
        issue_next();
      }
      __syncwarp();
      mbar_wait(full + cst, cph);
      const Panel d = desc[cst];
      f(d, landed(reinterpret_cast<MT*>(smem_raw + L.stage +
                                         cst * L.stage_bytes),
                  a_src(d)));
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + cst);
      if (++cst == ns) {
        cst = 0;
        cph ^= 1u;
      }
    }
  };
  // out(row) for the CTA's rows of K^-1 or K: the h held ones from Mh, the
  // rest read straight from device memory, from Mg (the CTA's first row
  // there) on: every thread's 16-byte loads in flight at once, none staged
  // (measured twice as fast as the ring at sslp's n=520 in f64, PERF.md
  // §6); epi(row, acc, l, g) on the row's lane group
  auto direct_product = [&](auto Mh, int h, const unsigned char* Mg,
                            const T* vin, auto epi) {
    using MM = std::remove_const_t<std::remove_pointer_t<decltype(Mh)>>;
    group_rows<T>(Mh, n, h, vin, n, epi);
    group_rows<T>(reinterpret_cast<const MM*>(Mg) +
                      static_cast<long long>(h) * n,
                  n, rk - h, vin, n,
                  [&](int r, T acc, int l, int g) { epi(h + r, acc, l, g); });
  };
  // out(row) for the CTA's rows of A: the held ones from Ah, the rest
  // through the ring (A'v reads A down its columns, which the ring's
  // staged panels serve and direct reads do not); epi as above
  auto a_product = [&](const MT* Ah, const T* vin, auto epi) {
    group_rows<T>(Ah, n, hAc, vin, n, epi);
    T seg = T(0);  // a long row's sum, carried across its segments
    stream(NA, [&](const Panel& d, const MT* pan) {
      if (d.nc == n) {
        group_rows<T>(pan, n, d.nr, vin, n,
                      [&](int r, T acc, int l, int g) {
                        epi(d.r0 + r, acc, l, g);
                      });
      } else {
        // a segment: every thread a share of it, the block's sums meeting
        // in one warp's lanes (warp 0 carries the row's sum)
        for (int k = tid; k < d.nc; k += nt) {
          seg += widen<T>(pan[k]) * vin[d.c0 + k];
        }
        if (d.c0 + d.nc == n) {
          T acc = group_sum(seg, 32);
          seg = T(0);
          T* red = part;  // free between A'v's reduction and the next A'v
          __syncthreads();
          if (lane == 0) red[tid >> 5] = acc;
          __syncthreads();
          acc = T(0);
          for (int q = 0; q < nw; ++q) acc += red[q];
          __syncthreads();
          if (tid < 32) epi(d.r0, acc, lane, 32);
        }
      }
    });
  };

  for (long long k = 0; k < my_scens; ++k) {
    const long long s = cid + k * ncl;
    const int b = static_cast<int>(k % nbuf);
    const MT* Ah = landed(reinterpret_cast<MT*>(held(b)),
                          reinterpret_cast<const MT*>(held_src(0, s)));
    const MT* Kih = landed(reinterpret_cast<MT*>(held(b) + L.slotA),
                           reinterpret_cast<const MT*>(held_src(1, s)));
    const T* Kh = landed(reinterpret_cast<T*>(held(b) + L.slotA + L.slotKi),
                         reinterpret_cast<const T*>(held_src(2, s)));
    // the state of the CTA's rows: in shared memory (copied in here and
    // out at the end), else in the outputs
    const long long on = s * n + k0, om = s * m + a0;
    auto inp = [&](int a, long long o) {
      return static_cast<const T*>(in.a[a]) + o;
    };
    T *x, *zx, *yx, *z, *y, *Ax;
    const T *q, *lb, *ub, *rx, *cl, *cu, *rav;
    if (vs) {
      T* o = slots + nkE;
      x = o;
      zx = x + nkE;
      yx = zx + nkE;
      T* qs = yx + nkE;
      T* lbs = qs + nkE;
      T* ubs = lbs + nkE;
      T* rxs = ubs + nkE;
      z = rxs + nkE;
      y = z + mkE;
      Ax = y + mkE;
      T* cls = Ax + mkE;
      T* cus = cls + mkE;
      T* ras = cus + mkE;
      for (int j = tid; j < rk; j += nt) {
        qs[j] = inp(3, on)[j];
        lbs[j] = inp(4, on)[j];
        ubs[j] = inp(5, on)[j];
        rxs[j] = inp(6, on)[j];
        x[j] = inp(7, on)[j];
        zx[j] = inp(8, on)[j];
        yx[j] = inp(9, on)[j];
      }
      for (int i = tid; i < ra; i += nt) {
        cls[i] = inp(10, om)[i];
        cus[i] = inp(11, om)[i];
        ras[i] = inp(12, om)[i];
        z[i] = inp(13, om)[i];
        y[i] = inp(14, om)[i];
        Ax[i] = inp(15, om)[i];
      }
      q = qs, lb = lbs, ub = ubs, rx = rxs, cl = cls, cu = cus, rav = ras;
    } else {
      x = out.x + on, zx = out.zx + on, yx = out.yx + on;
      z = out.z + om, y = out.y + om, Ax = out.Ax + om;
      q = inp(3, on), lb = inp(4, on), ub = inp(5, on), rx = inp(6, on);
      cl = inp(10, om), cu = inp(11, om), rav = inp(12, om);
      for (int j = tid; j < rk; j += nt) {
        x[j] = inp(7, on)[j];
        zx[j] = inp(8, on)[j];
        yx[j] = inp(9, on)[j];
      }
      for (int i = tid; i < ra; i += nt) {
        z[i] = inp(13, om)[i];
        y[i] = inp(14, om)[i];
        Ax[i] = inp(15, om)[i];
      }
    }
    for (int i = tid; i < ra; i += nt) v[i] = op(rav[i] * z[i] - y[i]);
    if (any_held) {
      mbar_wait(bars + b, static_cast<uint32_t>((k / nbuf) & 1));
    }
    __syncthreads();

    // x, zx, yx of the CTA's row j (one thread)
    auto x_update = [&](int j, T t) {
      const T xa = alpha * t;
      const T zxa = xa + beta * zx[j];
      const T zxn = clip(zxa + yx[j] / rx[j], lb[j], ub[j]);
      yx[j] = yx[j] + rx[j] * (zxa - zxn);
      zx[j] = zxn;
      x[j] = xa + beta * x[j];
    };
    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      // A'v: this CTA's rows' sums for every column (thread j its columns,
      // the held rows then the streamed panels in order)
      for (int j = tid; j < n; j += nt) {
        T s0 = T(0), s1 = T(0);
        int i = 0;
        for (; i + 1 < hAc; i += 2) {
          s0 += widen<T>(Ah[static_cast<long long>(i) * n + j]) * v[i];
          s1 += widen<T>(Ah[static_cast<long long>(i + 1) * n + j]) * v[i + 1];
        }
        if (i < hAc) s0 += widen<T>(Ah[static_cast<long long>(i) * n + j]) * v[i];
        part[j] = s0 + s1;
      }
      stream(NA, [&](const Panel& d, const MT* pan) {
        for (int j = tid; j < d.nc; j += nt) {
          T acc = T(0);
          for (int i = 0; i < d.nr; ++i) {
            acc += widen<T>(pan[static_cast<long long>(i) * n + j]) *
                   v[d.r0 + i];
          }
          part[d.c0 + j] += acc;
        }
      });
      cluster_sync();
      // rhs of the CTA's rows from the cluster's partial sums, C lanes a
      // row (lane r reads rank r's), and its K^-1 operand to every CTA
      for (int e0 = 0; e0 < rk * C; e0 += nt) {
        const int e = e0 + tid, j = e / C, r = e % C;
        T acc = j < rk ? peer_part(r)[k0 + j] : T(0);
        acc = group_sum(acc, C);
        if (j < rk) {
          const T rh = ((sigma * x[j] - q[j]) + acc) + (rx[j] * zx[j] - yx[j]);
          if (r == 0) rhs[j] = rh;
          put(w, k0 + j, op(rh), r, C);
        }
      }
      cluster_sync();
      // xt = K^-1 rhs; the last apply also updates x, zx, yx
      direct_product(Kih, hKic, held_src(1, s), w,
                     [&](int j, T acc, int l, int g) {
        put(xt, k0 + j, acc, l, g);
        if (n_refine == 0) {
          if (l == 0) x_update(j, acc);
          if (kLow) put(u, k0 + j, rnd(acc), l, g);
        }
      });
      cluster_sync();
      for (int pass = 0; pass < n_refine; ++pass) {
        direct_product(Kh, hKc, held_src(2, s), xt,
                       [&](int j, T acc, int l, int g) {
          put(w, k0 + j, op(rhs[j] - acc), l, g);
        });
        cluster_sync();
        direct_product(Kih, hKic, held_src(1, s), w,
                       [&](int j, T acc, int l, int g) {
          const T t = xt[k0 + j] + acc;
          __syncwarp(group_mask(g));  // the group has read xt[k0 + j]
          put(xt, k0 + j, t, l, g);
          if (pass == n_refine - 1) {
            if (l == 0) x_update(j, t);
            if (kLow) put(u, k0 + j, rnd(t), l, g);
          }
        });
        cluster_sync();
      }
      // A xt, each row's z, y, Ax update, and the next sweep's v
      a_product(Ah, kLow ? u : xt, [&](int i, T acc, int l, int) {
        if (l == 0) {
          const T axt = alpha * acc;
          const T za = axt + beta * z[i];
          const T zn = clip(za + y[i] / rav[i], cl[i], cu[i]);
          y[i] = y[i] + rav[i] * (za - zn);
          z[i] = zn;
          Ax[i] = axt + beta * Ax[i];
          v[i] = op(rav[i] * zn - y[i]);
        }
      });
      __syncthreads();  // v is whole before the next A'v reads it
    }
    if (vs) {
      for (int j = tid; j < rk; j += nt) {
        out.x[on + j] = x[j];
        out.zx[on + j] = zx[j];
        out.yx[on + j] = yx[j];
      }
      for (int i = tid; i < ra; i += nt) {
        out.z[om + i] = z[i];
        out.y[om + i] = y[i];
        out.Ax[om + i] = Ax[i];
      }
    }
    __syncthreads();  // buffer b is read; the copy engine may refill it
    if (tid == 0) issue_held(k + nbuf);
  }
  cluster_sync();  // no CTA leaves while a peer may still read its memory
}

// Blocks of `kern` an SM of the current device can hold with `threads` and
// `smem` bytes, cached per device, kernel and shape (the shared-memory
// attribute is the device's own, so it is set on each device the first
// time that device asks).
template <typename K>
int blocks_per_sm(K kern, int threads, long long smem, int* out) {
  static std::mutex mu;
  static const void* seen_fn[16];
  static long long seen[16][4];
  static int nseen = 0;
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = reinterpret_cast<const void*>(kern);
  for (int i = 0; i < nseen; ++i) {
    if (seen_fn[i] == fn && seen[i][0] == dev && seen[i][1] == smem &&
        seen[i][2] == threads) {
      *out = static_cast<int>(seen[i][3]);
      return 0;
    }
  }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return static_cast<int>(err);
  int nb = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, threads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int i = nseen < 16 ? nseen++ : 15;
  seen_fn[i] = fn;
  seen[i][0] = dev;
  seen[i][1] = smem;
  seen[i][2] = threads;
  seen[i][3] = nb;
  *out = nb;
  return 0;
}

template <typename T, typename MT>
int launch_resident(void* const* inp, void* const* outp, const int* stop,
                    int S, int m, int n, int n_sweeps, int n_refine, int nsm,
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
  const ResLayout L(m, n, sizeof(T), sizeof(MT));
  // a thread an output row or column
  const int widest = m > n ? m : n;
  int threads = (widest + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  // Two buffers a block (the next scenario's copy in flight while one
  // sweeps) where they fit, blocks walk several scenarios and the second
  // buffer keeps more than half the blocks an SM; else one, and the blocks
  // an SM overlap each other's copies (measured faster at farmer's shape,
  // where one buffer fits twice as many blocks).
  const long long one = L.buf + L.buf_bytes;
  if (one > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  err = blocks_per_sm(fused_sweeps_resident<T, MT>, threads, one, &nb);
  if (err != 0) return err;
  int nbuf = 1;
  long long smem = one;
  if (S > static_cast<long long>(nsm) * nb && L.total <= kSmemLimit) {
    int nb2 = 0;
    err = blocks_per_sm(fused_sweeps_resident<T, MT>, threads, L.total, &nb2);
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
  return static_cast<int>(cudaGetLastError());
}

// Clusters of C CTAs with `smem` bytes each the current device holds at
// once for the cluster kernel (cudaOccupancyMaxActiveClusters over a grid of
// C CTAs an SM), cached per device, C and smem.  The kernel's attributes are
// the device's own, so they are set on each device the first time it asks.
template <typename T, typename MT>
int cluster_occupancy(int C, long long smem, int* out) {
  static std::mutex mu;
  static long long seen[32][4];
  static int nseen = 0;
  static int with_attrs[32];
  static int nattrs = 0;
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < nseen; ++i) {
    if (seen[i][0] == dev && seen[i][1] == C && seen[i][2] == smem) {
      *out = static_cast<int>(seen[i][3]);
      return 0;
    }
  }
  auto kern = fused_sweeps_cluster<T, MT>;
  bool attrs = false;
  for (int i = 0; i < nattrs; ++i) attrs = attrs || with_attrs[i] == dev;
  if (!attrs) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err != cudaSuccess) return static_cast<int>(err);
    // clusters past 8 CTAs are the card's non-portable sizes
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nattrs < 32) with_attrs[nattrs++] = dev;
  }
  int nsm = 0;
  err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * nsm);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int i = nseen < 32 ? nseen++ : 31;
  seen[i][0] = dev;
  seen[i][1] = C;
  seen[i][2] = smem;
  seen[i][3] = n;
  *out = n;
  return 0;
}

template <typename T, typename MT>
int launch_cluster(void* const* inp, void* const* outp, const int* stop,
                   int S, int m, int n, int n_sweeps, int n_refine, int C,
                   int hA, int hKi, int hK, int nbuf, int ns, int sp,
                   int vec_smem, int max_clusters, double sigma,
                   double alpha, void* stream) {
  const int nk = (n + C - 1) / C, mk = (m + C - 1) / C;
  const bool a_streamed = hA < mk;  // only A's streamed rows use the ring
  // a stage's payload: whole rows of the working type, or (rows longer
  // than kStageBytes) segments of kStageBytes, which keep each thread's
  // columns of A'v its own
  const long long row = static_cast<long long>(n) * sizeof(T);
  const bool sp_ok = row <= kStageBytes
                         ? sp % row == 0 && sp >= row && sp <= kStageBytes
                         : sp == kStageBytes;
  if (C < 2 || C > kMaxCluster || (C & (C - 1)) != 0 || nbuf < 1 ||
      nbuf > 2 || ns < 0 || ns > 8 || (a_streamed && ns < 3) || hA < 0 ||
      hA > mk || hKi < 0 || hKi > nk || hK < 0 || hK > nk || !sp_ok ||
      (vec_smem == 0 && max_clusters < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClusterLayout L(m, n, sizeof(T), sizeof(MT), C, hA, hKi, hK, nbuf, ns,
                        sp, vec_smem != 0);
  if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  In in;
  const int order[kArrays] = {1, 2, 3, 0, 6, 7, 9, 10, 12, 14, 4, 5, 8, 11,
                              13, 15};
  for (int a = 0; a < kArrays; ++a) in.a[a] = inp[order[a]];
  Out<T> out{static_cast<T*>(outp[0]), static_cast<T*>(outp[1]),
             static_cast<T*>(outp[2]), static_cast<T*>(outp[3]),
             static_cast<T*>(outp[4]), static_cast<T*>(outp[5])};
  int active = 0;
  int err = cluster_occupancy<T, MT>(C, L.total, &active);
  if (err != 0) return err;
  // a cluster the card cannot place is an error, not another mode
  if (active < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int ncl = S < active ? S : active;
  if (vec_smem == 0 && max_clusters < ncl) ncl = max_clusters;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * ncl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(L.total);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, fused_sweeps_cluster<T, MT>, in, out, static_cast<T*>(outp[6]),
      stop, S, m, n, n_sweeps, n_refine, C, hA, hKi, hK, nbuf, ns, sp,
      vec_smem, static_cast<T>(sigma), static_cast<T>(alpha),
      static_cast<T>(1.0 - alpha));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int S, int m, int n, int prec, const int* stop) {
  return S < 1 || n < 1 || m < 0 || prec < 0 || prec > 1 || stop == nullptr;
}

}  // namespace

extern "C" {

// Resident mode.
// in:  q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax
//      (prec 1: A and Kinv bf16, the rest the working type)
// out: x, z, zx, y, yx, Ax
// stop: a device int, the solve loop's stop flag; where it is set every
// block returns at once and the outputs are left unwritten.
// nsm: the card's SM count; prec: 0 exact, 1 the mixed-precision mode
// ("default").  Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_f32(void* const* in, void* const* out,
                             const int* stop, int S, int m, int n,
                             int n_sweeps, int n_refine, int nsm, int prec,
                             double sigma, double alpha, void* stream) {
  if (bad_args(S, m, n, prec, stop) || nsm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return prec == 1 ? launch_resident<float, __nv_bfloat16>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, nsm,
                         sigma, alpha, stream)
                   : launch_resident<float, float>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, nsm,
                         sigma, alpha, stream);
}

int tpusppy_fused_sweeps_f64(void* const* in, void* const* out,
                             const int* stop, int S, int m, int n,
                             int n_sweeps, int n_refine, int nsm, int prec,
                             double sigma, double alpha, void* stream) {
  if (bad_args(S, m, n, prec, stop) || nsm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return prec == 1 ? launch_resident<double, __nv_bfloat16>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, nsm,
                         sigma, alpha, stream)
                   : launch_resident<double, double>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, nsm,
                         sigma, alpha, stream);
}

// Cluster and streamed modes (cuda_kernels.dense_layout).
// in, stop, prec: as in the resident mode
// out: x, z, zx, y, yx, Ax, then the work vectors' device-memory scratch
//      where vec_smem is 0 (max_clusters clusters of C CTAs, each
//      4 n + nk + mk values padded to 16 bytes per vector; the launch
//      takes at most max_clusters clusters), else unused
// C: CTAs a cluster (2, 4, 8, 16); hA, hKi, hK: the most rows of A, K^-1
// and K a CTA holds in shared memory (the rest stream through ns stages of
// sp bytes: whole rows of the working type, or kStageBytes); nbuf: held
// buffers a CTA (2: the next scenario's copy in flight).
// A cluster the card cannot place is an error.
int tpusppy_fused_sweeps_cluster_f32(void* const* in, void* const* out,
                                     const int* stop, int S, int m, int n,
                                     int n_sweeps, int n_refine, int prec,
                                     int C, int hA, int hKi, int hK,
                                     int nbuf, int ns, int sp, int vec_smem,
                                     int max_clusters, double sigma,
                                     double alpha, void* stream) {
  if (bad_args(S, m, n, prec, stop)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return prec == 1 ? launch_cluster<float, __nv_bfloat16>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, C, hA,
                         hKi, hK, nbuf, ns, sp, vec_smem, max_clusters,
                         sigma, alpha, stream)
                   : launch_cluster<float, float>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, C, hA,
                         hKi, hK, nbuf, ns, sp, vec_smem, max_clusters,
                         sigma, alpha, stream);
}

int tpusppy_fused_sweeps_cluster_f64(void* const* in, void* const* out,
                                     const int* stop, int S, int m, int n,
                                     int n_sweeps, int n_refine, int prec,
                                     int C, int hA, int hKi, int hK,
                                     int nbuf, int ns, int sp, int vec_smem,
                                     int max_clusters, double sigma,
                                     double alpha, void* stream) {
  if (bad_args(S, m, n, prec, stop)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return prec == 1 ? launch_cluster<double, __nv_bfloat16>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, C, hA,
                         hKi, hK, nbuf, ns, sp, vec_smem, max_clusters,
                         sigma, alpha, stream)
                   : launch_cluster<double, double>(
                         in, out, stop, S, m, n, n_sweeps, n_refine, C, hA,
                         hKi, hK, nbuf, ns, sp, vec_smem, max_clusters,
                         sigma, alpha, stream);
}

// Clusters of C CTAs with `smem` bytes each the card holds at once for the
// cluster kernel at prec, into *out (0 where it cannot place one); the
// wrapper takes clusters of 16 only where this shows the card holds them.
// Returns a cudaError_t (0 on success).
int tpusppy_fused_sweeps_clusters_f32(int prec, int C, int smem, int* out) {
  if (prec == 1) return cluster_occupancy<float, __nv_bfloat16>(C, smem, out);
  return cluster_occupancy<float, float>(C, smem, out);
}

int tpusppy_fused_sweeps_clusters_f64(int prec, int C, int smem, int* out) {
  if (prec == 1) return cluster_occupancy<double, __nv_bfloat16>(C, smem, out);
  return cluster_occupancy<double, double>(C, smem, out);
}

}  // extern "C"

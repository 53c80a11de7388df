// Fused sparse shared-A ADMM sweep block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel tpusppy/solvers/pallas_kernels.py
// `_sparse_sweeps_kernel` / `fused_sweeps_sparse`, at each of its
// precisions ("highest", and the lowered modes below).
// It runs one `n_sweeps` block of the shared-A engine's sweep
// (tpusppy_torch/solvers/shared_admm.py `_core`) on a sparse shared A held
// in padded-ELL form (rows: rowcols/rowvals (m, kr); columns:
// colrows/colvals (n, kc); padding slots are column 0 with value 0; the
// kernel reads them slot-major, transposed once by the caller), a K^-1
// operand, and per-scenario gamma scaling:
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
// Two modes, by the K^-1 operand (cuda_kernels.fused_sweeps_sparse picks):
//
// Dense: one (n, n) K^-1, the explicit inverse of a SparseA without
// block structure (or of a dense A whose factors carry no K).  One thread
// block owns a tile of SB scenarios (SB = 8 when it fits; the ragged last
// tile is masked) and streams K^-1 from device memory and L2: each thread
// takes CW adjacent output columns (4 in f32, 2 in f64: one 16-byte load)
// for all SB scenarios, 8 loads in flight.  Shared memory holds the K^-1
// input w and x-tilde, index-major with the SB scenario values of an index
// side by side.  At the full-width UC's shape this reads the 34.3 MB f32
// K^-1 from L2 for every apply in every tile, so L2 bandwidth sets its pace.
//
// Structured: the block/Woodbury operator of the structured-KKT engine
// (structured_kkt.KernelWoodbury), K^-1 w = t - B^-1 A_w' C^-1 A_w t with
// t = B^-1 w, B block-diagonal over the variable components and A_w the r
// wide coupling rows.  The layout puts the variables in block order
// (positions) and stores each component's inverse at its real size (rows
// and columns padded to 16, zero-filled) with C^-1 (r x r) after them,
// every stored matrix cut into row panels.  The K^-1 input lives in a
// per-tile device-memory scratch, by position, so each block's slice is
// contiguous.  One apply:
//   t = B^-1 w   in place, block by block: a block's slice of the scratch
//                sits in shared memory (two buffers: the next block's slice
//                is loaded into registers while the current one multiplies)
//                and its panels arrive through a double-buffered pipeline
//                of Hopper bulk asynchronous copies (cp.async.bulk into
//                shared memory, completion on an mbarrier; a panel is
//                requested while the one before it is consumed, across the
//                phases and the applies, since the sequence of panels is
//                the same in every apply); one-variable components are a
//                diagonal scale;
//   u = A_w t    over the wide rows' index/value lists;
//   v = C^-1 u   C^-1 in row panels through the same pipeline;
//   w' = A_w' v  by position, from its wide-row lists, into a second
//                scratch, then B^-1 w' in place as for t;
//   y = t - B^-1 w'  scattered to x-tilde by variable (= or +=).
// Block products: f32 on FFMA (exact f32, as the reference's "highest"),
// one output column a thread and the panel's rows split over thread
// groups; f64 on the f64 tensor cores (mma.sync m16n8k16 .f64, exact IEEE
// f64 FMA), 16 output columns by 8 scenario slots a warp tile (SB = 4 fills
// half of them).  The rows of A split as the structure does: the narrow
// rows (at most kn non-zeros) read a copy of their first kn ELL slots,
// and each wide row is summed by one warp over its own list (the list the
// Woodbury step uses), in A xt for the defect and for Ax.
//
// Bound at the main-path shape (the full-width UC, models/uc.py at 30
// generators x 24 hours: S=1000, m=4626, n=2928, 18,937 non-zeros, kr=61,
// kc=10; structure: 30 components of 96 variables, 48 of 1, r=184 wide
// rows with 3,432 non-zeros; n_sweeps=4, n_refine=1, n_extra=2 with has=1,
// so 16 applies).  Dense mode: 16 dense applies of 2 S n^2 = 17.1 GFLOP,
// 275.6 GFLOP a call, 4.1 ms at 67 TFLOP/s (the card's f32 peak outside
// the tensor cores, and its f64 tensor-core peak).  Structured mode: an
// apply is 2 * 30 * 96^2 + 184^2 + 2 * 3,432 + 96 = 594 K multiply-adds a
// scenario, 14.4 times fewer, and the call with its ELL products about
// 20 GFLOP: 0.3 ms.  The bytes (each input read once, each output written
// once) are ~0.27 GB: 0.08 ms at 3.35 TB/s.  Both modes are bound by
// operations; chip_smoke.py computes and prints the bounds from the run's
// inputs.  What holds the structured mode back from its bound (variants
// of this source timed on an H100 SXM at 700 W, PERF.md): about 40% of a
// call is the ELL products and state updates around the applies, bound by
// the latency of their device-memory reads with one 16-warp block an SM;
// in the applies, the blocks are small (96 x 96 x SB), so each costs two
// block-wide barriers and its slice traffic beside a few hundred
// multiply-adds a thread.
//
// The mixed-precision modes (PREC 1 "default", 2 "high"; the TPU kernel's
// lowered K^-1 applies, pallas_kernels.py:469-474): only the K^-1 applies
// are lowered, the ELL products, A xt and the matrix-free defect stay
// exact.  Each product of the apply takes its operand as its bf16 parts
// (u1 = bf16(f32(u)), u2 = bf16(f32(u) - u1)) and its matrix as its parts
// (M1, M2), "default" summing u1 M1 and "high" (bf16x3) u1 M1 + u1 M2 +
// u2 M1, every bf16 product exact and the sums in the working type.  Dense
// mode: K^-1 arrives as its bf16 parts (cuda_kernels.sparse_operand), the
// K^-1 input's parts in two shared vectors.  Structured mode: the stored
// blocks and C^-1 arrive as bf16 entries or bf16 pairs (both parts of an
// entry side by side, so one bulk copy brings a panel's two parts;
// structured_kkt.lowered_layout), staged through the same pipeline at 2 or
// 4 bytes an entry; a block's input slice lands in shared memory as its
// two parts; the one-variable inverses and the wide rows' values of the
// Woodbury products come as their parts, and their operands split as they
// are read.  The final t - B^-1 w' stays exact.  The sums run in the
// working type, as pallas_kernels._pdot's do and as the plain version's
// do (cuda_kernels._kernel_dot); the reference's XLA path (kinv_apply at
// the mode) sums each lowered product in f32, the same thing in f32.
//
// The stop flag: the solve loop runs its sweep blocks as CUDA-graph
// replays (tpusppy_torch/solvers/device_loop.py) and keeps its exit vote in
// a device int that stays set once set.  Every block of either mode reads
// it first and returns where it is set, before any mbarrier or bulk copy,
// so a block past the loop's exit costs one launch, not a full call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_sweeps_sparse.so fused_sweeps_sparse.cu
// Bound to PyTorch with ctypes (tpusppy_torch/solvers/cuda_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
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

// Elements a thread takes at a time in the elementwise loops.
constexpr int kBatch = 4;

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

// CW consecutive bf16 entries of one row (2 CW bytes, aligned), as f32.
template <int CW>
__device__ __forceinline__ void load_row_bf16(const __nv_bfloat16* p,
                                              float (&out)[CW]) {
  if constexpr (CW == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else if constexpr (CW == 2) {
    const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    out[0] = a.x;
    out[1] = a.y;
  } else {
    out[0] = __bfloat162float(__ushort_as_bfloat16(
        __ldg(reinterpret_cast<const unsigned short*>(p))));
  }
}

// The mixed-precision column_dot of the dense mode: the operand as its
// bf16 parts u1 (in1) and, with kHigh, u2 (in2), held in T; K^-1 as its
// bf16 parts M1, M2 (n, n) each; "default" sums u1 M1, "high" u1 M1 +
// u1 M2 + u2 M1 (the two cross products in a sum of their own, added at
// the end).  Every product is exact; the sums run in T.
template <typename T, int SB, int CW, bool kHigh>
__device__ __forceinline__ Cols<T, SB, CW> column_dot_lo(
    const T* in1, const T* in2, const __nv_bfloat16* __restrict__ M1,
    const __nv_bfloat16* __restrict__ M2, int k0, int k1, int ncol,
    int col0) {
  Cols<T, SB, CW> acc, lo;
#pragma unroll
  for (int w = 0; w < CW; ++w)
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[w][s] = lo.v[w][s] = T(0);
  for (int kb = k0; kb < k1; kb += kSumBlock) {
    const int ke = k1 - kb < kSumBlock ? k1 : kb + kSumBlock;
    Cols<T, SB, CW> blk, blo;
#pragma unroll
    for (int w = 0; w < CW; ++w)
#pragma unroll
      for (int s = 0; s < SB; ++s) blk.v[w][s] = blo.v[w][s] = T(0);
#pragma unroll 4
    for (int k = kb; k < ke; ++k) {
      const long long at = static_cast<long long>(k) * ncol + col0;
      float m1[CW];
      load_row_bf16<CW>(M1 + at, m1);
      const Tile<T, SB> v1 = load_tile<T, SB>(in1 + k * SB);
#pragma unroll
      for (int w = 0; w < CW; ++w)
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          blk.v[w][s] += v1.v[s] * static_cast<T>(m1[w]);
        }
      if constexpr (kHigh) {
        float m2[CW];
        load_row_bf16<CW>(M2 + at, m2);
        const Tile<T, SB> v2 = load_tile<T, SB>(in2 + k * SB);
#pragma unroll
        for (int w = 0; w < CW; ++w)
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            blo.v[w][s] += v1.v[s] * static_cast<T>(m2[w]);
            blo.v[w][s] += v2.v[s] * static_cast<T>(m1[w]);
          }
      }
    }
#pragma unroll
    for (int w = 0; w < CW; ++w)
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        acc.v[w][s] += blk.v[w][s];
        lo.v[w][s] += blo.v[w][s];
      }
  }
  if constexpr (kHigh) {
#pragma unroll
    for (int w = 0; w < CW; ++w)
#pragma unroll
      for (int s = 0; s < SB; ++s) acc.v[w][s] += lo.v[w][s];
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

// out = in @ M for the tile, in (SB, kd) in shared memory and M (kd, O)
// row-major in device memory, O a multiple of CW, with col(k0, k1, c0) the
// sums over k0 <= k < k1 of the CW columns from c0; then epi(o, acc) for
// every output column o, with acc the column's SB scenario values.  When
// the columns leave threads over (O < nt), the reduction over k is split
// among G groups of threads, each taking the O / CW column groups, whose
// partial sums meet in `part` (G * O * SB values, at most nt * SB since
// G <= nt / O) and are added in group order.  Ends with a barrier; every
// thread of the block must call it.
template <typename T, int SB, int CW, typename Col, typename Epi>
__device__ __forceinline__ void contract(int kd, int O, T* part, Col col,
                                         Epi epi) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int groups = O / CW;
  const int W = (groups + 31) / 32 * 32;
  const int Wc = (O + 31) / 32 * 32;
  const int G = Wc >= nt ? 1 : nt / Wc;
  if (G == 1) {
    for (int c = tid; c < groups; c += nt) {
      const Cols<T, SB, CW> acc = col(0, kd, c * CW);
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
    const Cols<T, SB, CW> acc = col(kd * g / G, kd * (g + 1) / G, c * CW);
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
// values an index): sum_j vals[j, r] * in[idx[j, r] * SB + s] over the
// slots jb <= j < k, for each s, the slots summed in order as
// pallas_kernels._ell_mv sums them.  The ELL
// arrays come slot-major, (k, rows), so consecutive threads (consecutive
// r) read consecutive indices and values.  Padding slots (index 0, value
// 0) add zeros.  The slots go in chunks of kChunk: a chunk's index and
// value loads, then its operand loads, are all in flight together (the
// operand often sits in device memory, so a slot at a time would wait two
// round trips for each), with the indices of two chunks loaded ahead;
// the sum still runs slot by slot.
template <typename T, int SB>
constexpr int kChunk = 128 / (SB * static_cast<int>(sizeof(T))) > 8 ? 8
    : (128 / (SB * static_cast<int>(sizeof(T))) < 1
           ? 1 : 128 / (SB * static_cast<int>(sizeof(T))));

template <typename T, int SB>
__device__ __forceinline__ Tile<T, SB> ell_dot(const int* __restrict__ idx,
                                               const T* __restrict__ vals,
                                               int jb, int k, int rows, int r,
                                               const T* in) {
  constexpr int U = kChunk<T, SB>;
  constexpr int I = 2 * U;  // indices loaded ahead of their operands
  Tile<T, SB> acc;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = T(0);
  for (int j1 = jb; j1 < k; j1 += I) {
    int c[I];
    T a[I];
#pragma unroll
    for (int u = 0; u < I; ++u) {
      const long long at = static_cast<long long>(j1 + u) * rows + r;
      const bool on = j1 + u < k;
      c[u] = on ? __ldg(idx + at) : 0;
      a[u] = on ? __ldg(vals + at) : T(0);
    }
#pragma unroll
    for (int g = 0; g < I; g += U) {
      if (j1 + g < k) {
        Tile<T, SB> v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          v[u] = load_tile<T, SB>(in + static_cast<long long>(c[g + u]) * SB);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j1 + g + u < k) {
#pragma unroll
            for (int s = 0; s < SB; ++s) acc.v[s] += v[u].v[s] * a[g + u];
          }
        }
      }
    }
  }
  return acc;
}

// The lowered ell_dot of the Woodbury products: the operand split into its
// bf16 parts as it is read, the values as their parts (a1 from vals1, a2
// from vals2, both (k, rows) slot-major and held in T); "default" sums
// a1 u1, "high" a1 u1 + a1 u2 + a2 u1, slot by slot, the cross products in
// a sum of their own added at the end.
template <typename T, int SB, bool kHigh>
__device__ __forceinline__ Tile<T, SB> ell_dot_lo(const int* __restrict__ idx,
                                                  const T* __restrict__ vals1,
                                                  const T* __restrict__ vals2,
                                                  int jb, int k, int rows,
                                                  int r, const T* in) {
  Tile<T, SB> acc, lo;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = lo.v[s] = T(0);
  for (int j = jb; j < k; ++j) {
    const long long at = static_cast<long long>(j) * rows + r;
    const T a1 = __ldg(vals1 + at);
    const T a2 = kHigh ? __ldg(vals2 + at) : T(0);
    const Tile<T, SB> v = load_tile<T, SB>(
        in + static_cast<long long>(__ldg(idx + at)) * SB);
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      T u1, u2;
      split_bf16(v.v[s], u1, u2);
      acc.v[s] += a1 * u1;
      if (kHigh) {
        lo.v[s] += a1 * u2;
        lo.v[s] += a2 * u1;
      }
    }
  }
  if constexpr (kHigh) {
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[s] += lo.v[s];
  }
  return acc;
}

// u * d at the mode: exact at PREC 0; else u's parts against d's (d1, and
// d2 at "high"), as one lowered one-by-one product.
template <typename T, int PREC>
__device__ __forceinline__ T scale_lo(T u, T d1, T d2) {
  if constexpr (PREC == 0) {
    return u * d1;
  } else {
    T u1, u2;
    split_bf16(u, u1, u2);
    T out = u1 * d1;
    if constexpr (PREC == 2) out += u1 * d2 + u2 * d1;
    return out;
  }
}

// ---- the structured (block/Woodbury) mode ----------------------------------

// The structured operand (structured_kkt.KernelWoodbury and its
// WoodburyPattern) and the tile scratch it needs; unused in the dense mode.
// At a lowered mode `mats` holds bf16 entries (PREC 1) or bf16 pairs
// (PREC 2), and dinv, wvals_lo and wtvals their P bf16 parts in T, part 2
// after part 1 (P = PREC); wvals (A xt's wide rows) stays exact.
template <typename T>
struct Wb {
  const void* mats;      // the blocks, then C^-1, each (ld, ld) row-major
  const int* pos;        // (n) each variable's position
  const int* order;      // (n) the variable at each position
  const int* items;      // (nitems, 3) panels: block, first row, rows
  const int* binfo;      // (nb + 1, 4) offset, size, ld, first position
  const T* dinv;         // (n - pd) one-variable components' inverses
  const int* wcols;      // (kw, r) the wide rows' columns (variables)
  const T* wvals;        // (kw, r) their values
  const int* wpos;       // (kw, r) their columns as positions
  const int* wtrows;     // (kwc, n) per position, the wide rows holding it
  const T* wtvals;       // (kwc, n) their values
  const int* ncols;      // (kn, m) narrow rows' first slots; -1: a wide row
  const T* nvals;        // (kn, m) their values
  const int* wrows;      // (r) the wide rows' ids
  const T* wvals_lo;     // (kw, r) the values of A_w t (exact: wvals)
  T* sw;                 // scratch: each tile's K^-1 input (n, SB)
  T* sw2;                // scratch: each tile's second (n, SB) vector
  int r, kn, kw, kwc, nb, nitems, pd, stage_bytes, bmax;
};

// Values a 16-byte-aligned region of e values takes.
template <typename T>
__host__ __device__ constexpr long long pad16(long long e) {
  return (e * static_cast<long long>(sizeof(T)) + 15) / 16 * 16 /
         static_cast<long long>(sizeof(T));
}

__host__ __device__ constexpr long long r16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// A stored entry of the structured operand at each mode: the working type,
// a bf16 entry, or a bf16 pair (its two parts).
template <typename T, int PREC>
struct Entry {
  using type = std::conditional_t<
      PREC == 0, T,
      std::conditional_t<PREC == 1, __nv_bfloat16, __nv_bfloat162>>;
};

// An entry's parts as T (the second zero below "high").
template <typename T>
__device__ __forceinline__ void parts(T e, T& m1, T& m2) {
  m1 = e;
  m2 = T(0);
}
template <typename T>
__device__ __forceinline__ void parts(__nv_bfloat16 e, T& m1, T& m2) {
  m1 = static_cast<T>(__bfloat162float(e));
  m2 = T(0);
}
template <typename T>
__device__ __forceinline__ void parts(__nv_bfloat162 e, T& m1, T& m2) {
  const float2 f = __bfloat1622float2(e);
  m1 = static_cast<T>(f.x);
  m2 = static_cast<T>(f.y);
}

// f64 tensor-core tiles of 16 columns one warp may own (ld <= 512).
constexpr int kTilesPerWarp = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits for the phase; a copy that never lands (an item requested out of
// order) ends the launch with an error after ~2^30 tries, not a hang.
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

// The double-buffered panel pipeline: item `it` (counted over the whole
// call) sits in stage[it & 1] once full[it & 1] completes its phase
// (it >> 1) & 1.  One apply walks L = nitems + P items: the P block panels,
// the C^-1 panels, the P block panels again.
struct Pipe {
  uint64_t* full;
  unsigned char* stage[2];
  long long it;
  long long total;
  int L;
};

template <typename T>
__device__ __forceinline__ int pipe_row(const Wb<T>& wb, const Pipe& pp,
                                        long long it) {
  const int j = static_cast<int>(it % pp.L);
  return j < wb.nitems ? j : j - wb.nitems;
}

// Thread 0 requests item `it`: one bulk copy of the panel's rows (entries
// of type E) into its stage buffer, which every thread has finished
// reading (a barrier lies between the last read and this call).
template <typename T, typename E>
__device__ __forceinline__ void pipe_issue(const Wb<T>& wb, Pipe& pp,
                                           long long it) {
  const int row = pipe_row(wb, pp, it);
  const int b = __ldg(wb.items + 3 * row);
  const int row0 = __ldg(wb.items + 3 * row + 1);
  const int rows = __ldg(wb.items + 3 * row + 2);
  const int off = __ldg(wb.binfo + 4 * b);
  const int ld = __ldg(wb.binfo + 4 * b + 2);
  const uint32_t bytes = static_cast<uint32_t>(rows) * ld * sizeof(E);
  uint64_t* bar = pp.full + (it & 1);
  const E* src = static_cast<const E*>(wb.mats) + off +
                 static_cast<long long>(row0) * ld;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(pp.stage[it & 1])),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
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

// Thread groups splitting the rows of a block product with ld columns:
// f32 gives each thread one column, f64 each warp 16-column tiles.
template <typename T>
__device__ __forceinline__ int product_groups(int ld, int nt) {
  if constexpr (std::is_same_v<T, double>) {
    const int nw = nt / 32, ntile = ld / 16;
    return ntile >= nw ? 1 : nw / ntile;
  } else {
    return nt / ld;
  }
}

// One stored matrix b (a block, or C^-1 when b == nb) against the tile:
// out[t][s] = sum_k in[k * SB + s] * M[k][t] over its staged panels, then
// epi(t, s, out) for t < size.  `in` (shared memory) holds ld rows, zero
// past the real size.  The sum over k runs in the group's share of each
// panel's rows, panel by panel, and the groups' partial sums meet in `part`
// in group order.  pre() runs before the first panel and commit() after the
// last product (the next block's loads go out in pre(), into registers, and
// land in shared memory in commit(), so their latency hides behind the
// products).  Every thread of the block calls it; it begins with a
// barrier, and the caller puts one between the epilogue's writes and
// their readers.  At a lowered PREC `in` holds the input's bf16 part u1
// and `in2` its part u2 (read at "high"), and the staged entries are bf16
// (pairs at "high"): the products u1 M1 (+ u1 M2 + u2 M1), the cross
// products in sums of their own.
template <typename T, int SB, int PREC, typename Pre, typename Commit,
          typename Epi>
__device__ void run_block(const Wb<T>& wb, Pipe& pp, int b, const T* in,
                          const T* in2, T* part, Pre pre, Commit commit,
                          Epi epi) {
  using E = typename Entry<T, PREC>::type;
  constexpr bool kHigh = PREC == 2;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int size = __ldg(wb.binfo + 4 * b + 1);
  const int ld = __ldg(wb.binfo + 4 * b + 2);
  const int G = product_groups<T>(ld, nt);
  __syncthreads();  // `in` is complete
  pre();
  if constexpr (std::is_same_v<T, double>) {
    const int lane = tid & 31, warp = tid >> 5, nw = nt / 32;
    const int g8 = lane >> 2, tq = lane & 3;
    const int ntile = ld / 16;
    const int gi = G > 1 ? warp / ntile : 0;
    // this warp's 16-column tiles: warp % ntile when groups split the rows,
    // else warp, warp + nw (at most kTilesPerWarp)
    const int t0 = G > 1 ? warp % ntile : warp;
    const int ntw = G > 1 ? 1 : (ntile - warp + nw - 1) / nw;
    double d[kTilesPerWarp][4], dl[kTilesPerWarp][4];
#pragma unroll
    for (int c = 0; c < kTilesPerWarp; ++c)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[c][v] = dl[c][v] = 0.0;
    for (int row0 = 0; row0 < ld;) {
      const int rows = __ldg(wb.items + 3 * pipe_row(wb, pp, pp.it) + 2);
      if (tid == 0 && pp.it + 1 < pp.total) {
        pipe_issue<T, E>(wb, pp, pp.it + 1);
      }
      mbar_wait(pp.full + (pp.it & 1), static_cast<uint32_t>((pp.it >> 1) & 1));
      const E* st = reinterpret_cast<const E*>(pp.stage[pp.it & 1]);
      if (gi < G) {
        const int nks = rows / 16;
        const int ks1 = nks * (gi + 1) / G;
        for (int ks = nks * gi / G; ks < ks1; ++ks) {
          // A[t][k] = M[k][t] (16 columns x 16 rows), B[k][s] = in[k][s]
          const int kb = 16 * ks + tq;
          double b[4], b2[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int at = (row0 + kb + 4 * v) * SB + g8;
            b[v] = g8 < SB ? in[at] : 0.0;
            b2[v] = kHigh && g8 < SB ? in2[at] : 0.0;
          }
#pragma unroll
          for (int c = 0; c < kTilesPerWarp; ++c) {
            if (c < ntw) {
              const int col = (t0 + c * nw) * 16 + g8;
              double a[8], a2[8];
#pragma unroll
              for (int v = 0; v < 8; ++v) {
                parts(st[(kb + 4 * (v >> 1)) * ld + col + 8 * (v & 1)], a[v],
                      a2[v]);
              }
              dmma(d[c], a, b);
              if constexpr (kHigh) {
                dmma(dl[c], a2, b);
                dmma(dl[c], a, b2);
              }
            }
          }
        }
      }
      row0 += rows;
      if (row0 >= ld && gi < G) {
#pragma unroll
        for (int c = 0; c < kTilesPerWarp; ++c) {
          if (c < ntw) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int t = (t0 + c * nw) * 16 + g8 + 8 * (v >> 1);
              const int s = 2 * tq + (v & 1);
              if (s < SB) part[(gi * ld + t) * SB + s] = d[c][v] + dl[c][v];
            }
          }
        }
      }
      if (row0 >= ld) commit();
      __syncthreads();  // the stage buffer is free; `part` is complete
      ++pp.it;
    }
  } else {
    const int gi = tid / ld, t = tid - gi * ld;
    T acc[SB], lo[SB];
#pragma unroll
    for (int s = 0; s < SB; ++s) acc[s] = lo[s] = T(0);
    for (int row0 = 0; row0 < ld;) {
      const int rows = __ldg(wb.items + 3 * pipe_row(wb, pp, pp.it) + 2);
      if (tid == 0 && pp.it + 1 < pp.total) {
        pipe_issue<T, E>(wb, pp, pp.it + 1);
      }
      mbar_wait(pp.full + (pp.it & 1), static_cast<uint32_t>((pp.it >> 1) & 1));
      const E* st = reinterpret_cast<const E*>(pp.stage[pp.it & 1]);
      if (gi < G) {
        const int k1 = rows * (gi + 1) / G;
        for (int k = rows * gi / G; k < k1; ++k) {
          T mk, mk2;
          parts(st[k * ld + t], mk, mk2);
          const Tile<T, SB> v = load_tile<T, SB>(in + (row0 + k) * SB);
#pragma unroll
          for (int s = 0; s < SB; ++s) acc[s] += v.v[s] * mk;
          if constexpr (kHigh) {
            const Tile<T, SB> v2 = load_tile<T, SB>(in2 + (row0 + k) * SB);
#pragma unroll
            for (int s = 0; s < SB; ++s) {
              lo[s] += v.v[s] * mk2;
              lo[s] += v2.v[s] * mk;
            }
          }
        }
      }
      row0 += rows;
      if (row0 >= ld && gi < G) {
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          part[(gi * ld + t) * SB + s] = kHigh ? acc[s] + lo[s] : acc[s];
        }
      }
      if (row0 >= ld) commit();
      __syncthreads();  // the stage buffer is free; `part` is complete
      ++pp.it;
    }
  }
  for (int e = tid; e < size * SB; e += nt) {
    const int t = e / SB, s = e - t * SB;
    T v = part[t * SB + s];
    for (int h = 1; h < G; ++h) v += part[(h * ld + t) * SB + s];
    epi(t, s, v);
  }
}

// A block's slice of a tile vector in device memory (positions p0 ..
// p0 + size, SB values each, zero to ld), one register a value: element e
// of the slice goes to thread e % nt, its e / nt-th value (ld <= nt, so SB
// values a thread suffice).
template <typename T, int SB>
struct Slice {
  T v[SB];
};

template <typename T, int SB>
__device__ __forceinline__ Slice<T, SB> load_slice(const T* src, int p0,
                                                   int size) {
  Slice<T, SB> sl;
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int i = 0; i < SB; ++i) {
    const int e = tid + i * nt;
    sl.v[i] = e < size * SB ? src[static_cast<long long>(p0) * SB + e] : T(0);
  }
  return sl;
}

// The slice into shared memory: as it is (PREC 0), or as its bf16 parts,
// u1 to dst and u2 to dst2 (the block product's operand at a lowered
// mode).
template <typename T, int SB, int PREC>
__device__ __forceinline__ void store_slice(T* dst, T* dst2,
                                            const Slice<T, SB>& sl, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int i = 0; i < SB; ++i) {
    const int e = tid + i * nt;
    if (e < ld * SB) {
      if constexpr (PREC == 0) {
        dst[e] = sl.v[i];
      } else {
        split_bf16(sl.v[i], dst[e], dst2[e]);
      }
    }
  }
}

// buf = B^-1 buf over the dense blocks, in place, for the tile's vector
// `buf` in device memory (by position): each block's slice goes through
// shared memory (gb, two bmax-row buffers, by block parity; gb2 its
// second parts at a lowered mode), the next block's slice on its way while
// the current one multiplies.  Ends before the barrier that makes the last
// block's writes visible.
template <typename T, int SB, int PREC>
__device__ void block_pass(const Wb<T>& wb, Pipe& pp, T* buf, T* gb, T* gb2,
                           T* part) {
  if (wb.nb == 0) return;
  const long long gbs = pad16<T>(static_cast<long long>(wb.bmax) * SB);
  store_slice<T, SB, PREC>(gb, gb2,
                           load_slice<T, SB>(buf, __ldg(wb.binfo + 3),
                                             __ldg(wb.binfo + 1)),
                           __ldg(wb.binfo + 2));
  for (int b = 0; b < wb.nb; ++b) {
    const int p0 = __ldg(wb.binfo + 4 * b + 3);
    const bool more = b + 1 < wb.nb;
    const int* nx = wb.binfo + 4 * (b + 1);
    Slice<T, SB> next;
    run_block<T, SB, PREC>(
        wb, pp, b, gb + (b & 1) * gbs, gb2 + (b & 1) * gbs, part,
        [&] {
          if (more) next = load_slice<T, SB>(buf, __ldg(nx + 3), __ldg(nx + 1));
        },
        [&] {
          if (more) {
            store_slice<T, SB, PREC>(gb + ((b + 1) & 1) * gbs,
                                     gb2 + ((b + 1) & 1) * gbs, next,
                                     __ldg(nx + 2));
          }
        },
        [&](int t, int s, T v) {
          buf[(static_cast<long long>(p0) + t) * SB + s] = v;
        });
  }
}

// y = K^-1 w for the tile through the block/Woodbury operator.  w is the
// tile's scratch sw (by position), which ends holding t = B^-1 w; sw2, a
// second such scratch, takes w' = A_w' C^-1 A_w t and then B^-1 w'; y =
// t - B^-1 w' goes to x-tilde (by variable), assigned or added.  Every
// thread calls it; it ends with a barrier.  At a lowered PREC each
// product's operand is split into its bf16 parts (gb2 and su2 hold the
// second parts of a block's and of C^-1's input) and the one-variable
// inverses and the wide rows' values come as parts; t - B^-1 w' is exact.
template <typename T, int SB, int PREC>
__device__ void wb_apply(const Wb<T>& wb, Pipe& pp, T* sw, T* sw2, T* sxt,
                         T* gb, T* gb2, T* su, T* su2, T* sv, T* part, int n,
                         bool add) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  using V = Tile<T, SB>;
  constexpr bool kHigh = PREC == 2;
  const int nd = n - wb.pd;
  // t = B^-1 w: the one-variable components scale in place, then the blocks
  for (int e = tid; e < nd * SB; e += nt) {
    const int i = e / SB;
    T& w = sw[static_cast<long long>(wb.pd) * SB + e];
    w = scale_lo<T, PREC>(w, __ldg(wb.dinv + i),
                          kHigh ? __ldg(wb.dinv + nd + i) : T(0));
  }
  block_pass<T, SB, PREC>(wb, pp, sw, gb, gb2, part);
  __syncthreads();
  // u = A_w t over the wide rows' lists, each row's slots split among H
  // threads whose partial sums meet in `part` in order (zero past r)
  const int ldc = __ldg(wb.binfo + 4 * wb.nb + 2);
  const int H = wb.r > 0 && nt / wb.r > 1 ? nt / wb.r : 1;
  const long long nwv = static_cast<long long>(wb.kw) * wb.r;
  for (int e = tid; e < H * wb.r; e += nt) {
    const int h = e / wb.r, q = e - h * wb.r;
    V u;
    if constexpr (PREC == 0) {
      u = ell_dot<T, SB>(wb.wpos, wb.wvals_lo, wb.kw * h / H,
                         wb.kw * (h + 1) / H, wb.r, q, sw);
    } else {
      u = ell_dot_lo<T, SB, kHigh>(wb.wpos, wb.wvals_lo, wb.wvals_lo + nwv,
                                   wb.kw * h / H, wb.kw * (h + 1) / H, wb.r,
                                   q, sw);
    }
#pragma unroll
    for (int s = 0; s < SB; ++s) part[e * SB + s] = u.v[s];
  }
  __syncthreads();
  for (int e = tid; e < ldc * SB; e += nt) {
    const int q = e / SB;
    T u = T(0);
    if (q < wb.r) {
      for (int h = 0; h < H; ++h) u += part[h * wb.r * SB + e];
    }
    if constexpr (PREC == 0) {
      su[e] = u;
    } else {
      split_bf16(u, su[e], su2[e]);
    }
  }
  // v = C^-1 u
  run_block<T, SB, PREC>(wb, pp, wb.nb, su, su2, part, [] {}, [] {},
                         [&](int t, int s, T v) { sv[t * SB + s] = v; });
  __syncthreads();
  // w' = A_w' v by position (the one-variable components' B^-1 w' too)
  const long long nwt = static_cast<long long>(wb.kwc) * n;
  for (int p = tid; p < n; p += nt) {
    V wq;
    if constexpr (PREC == 0) {
      wq = ell_dot<T, SB>(wb.wtrows, wb.wtvals, 0, wb.kwc, n, p, sv);
    } else {
      wq = ell_dot_lo<T, SB, kHigh>(wb.wtrows, wb.wtvals, wb.wtvals + nwt, 0,
                                    wb.kwc, n, p, sv);
    }
    if (p >= wb.pd) {
      const T d1 = __ldg(wb.dinv + p - wb.pd);
      const T d2 = kHigh ? __ldg(wb.dinv + nd + p - wb.pd) : T(0);
#pragma unroll
      for (int s = 0; s < SB; ++s) wq.v[s] = scale_lo<T, PREC>(wq.v[s], d1, d2);
    }
#pragma unroll
    for (int s = 0; s < SB; ++s) sw2[static_cast<long long>(p) * SB + s] = wq.v[s];
  }
  __syncthreads();
  block_pass<T, SB, PREC>(wb, pp, sw2, gb, gb2, part);
  __syncthreads();
  // y = t - B^-1 w', to x-tilde by variable
  for (int e = tid; e < n * SB; e += nt) {
    const int p = e / SB, s = e - p * SB;
    const long long j = __ldg(wb.order + p);
    const T y = sw[e] - sw2[e];
    sxt[j * SB + s] = add ? sxt[j * SB + s] + y : y;
  }
  __syncthreads();
}

// Narrow row i of A against a tile operand in shared memory, over its
// first kn slots (wb.ncols/nvals, slot-major), summed slot by slot; all
// its index and value loads are in flight together.  False for a wide
// row (slot 0 holds -1), which wide_dot takes.
template <typename T, int SB>
__device__ __forceinline__ bool narrow_dot(const Wb<T>& wb, int m, int i,
                                           const T* in, Tile<T, SB>& acc) {
  constexpr int U = 8;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = T(0);
  for (int j0 = 0; j0 < wb.kn; j0 += U) {
    int c[U];
    T a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long at = static_cast<long long>(j0 + u) * m + i;
      const bool on = j0 + u < wb.kn;
      c[u] = on ? __ldg(wb.ncols + at) : 0;
      a[u] = on ? __ldg(wb.nvals + at) : T(0);
    }
    if (c[0] < 0) return false;
    // the operands (shared memory) four at a time, to keep registers free
#pragma unroll
    for (int g = 0; g < U; g += 4) {
      Tile<T, SB> v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = load_tile<T, SB>(in + static_cast<long long>(c[g + u]) * SB);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + g + u < wb.kn) {
#pragma unroll
          for (int s = 0; s < SB; ++s) acc.v[s] += v[u].v[s] * a[g + u];
        }
      }
    }
  }
  return true;
}

// Wide row q (of wb.wrows) against a tile operand in shared memory, by one
// warp: lane l sums the slots l, l + 32, ..., and the lanes' sums meet by
// butterfly shuffles, so every lane holds the row's SB values.  All 32
// lanes of the warp call it.
template <typename T, int SB>
__device__ __forceinline__ Tile<T, SB> wide_dot(const Wb<T>& wb, int q,
                                                const T* in) {
  const int lane = threadIdx.x & 31;
  Tile<T, SB> acc;
#pragma unroll
  for (int s = 0; s < SB; ++s) acc.v[s] = T(0);
  for (int j = lane; j < wb.kw; j += 32) {
    const long long at = static_cast<long long>(j) * wb.r + q;
    const T a = __ldg(wb.wvals + at);
    const Tile<T, SB> v = load_tile<T, SB>(
        in + static_cast<long long>(__ldg(wb.wcols + at)) * SB);
#pragma unroll
    for (int s = 0; s < SB; ++s) acc.v[s] += v.v[s] * a;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < SB; ++s) {
      acc.v[s] += __shfl_xor_sync(0xffffffffu, acc.v[s], off);
    }
  }
  return acc;
}

// The SB values of a tile's value for scenario s (a register select, not
// an indexed load).
template <typename T, int SB>
__device__ __forceinline__ T pick(const Tile<T, SB>& t, int s) {
  T v = t.v[0];
#pragma unroll
  for (int k = 1; k < SB; ++k) v = s == k ? t.v[k] : v;
  return v;
}

// f(i, axt) for every row i of A against x-tilde: the dense mode takes
// every row over all kr ELL slots, a thread a row; the structured mode
// takes the narrow rows that way over their kn slots and each wide row by
// one warp, where lane s < SB handles scenario s (fs(i, s, value)).
template <typename T, int SB, bool WB, typename F, typename Fs>
__device__ __forceinline__ void rows_of_A(const int* __restrict__ rowcols,
                                          const T* __restrict__ rowvals,
                                          int kr, int m, const Wb<T>& wb,
                                          const T* sxt, F f, Fs fs) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (WB) {
    for (int i = tid; i < m; i += nt) {
      Tile<T, SB> axt;
      if (narrow_dot<T, SB>(wb, m, i, sxt, axt)) f(i, axt);
    }
    const int lane = tid & 31;
    for (int q = tid >> 5; q < wb.r; q += nt >> 5) {
      const Tile<T, SB> axt = wide_dot<T, SB>(wb, q, sxt);
      if (lane < SB) fs(__ldg(wb.wrows + q), lane, pick<T, SB>(axt, lane));
    }
  } else {
    for (int i = tid; i < m; i += nt) {
      f(i, ell_dot<T, SB>(rowcols, rowvals, 0, kr, m, i, sxt));
    }
  }
}

template <typename T, int SB, int CW, bool WB, int PREC>
__global__ void __launch_bounds__(kThreads, 1) fused_sweeps_sparse_kernel(
    const T* __restrict__ q, const int* __restrict__ rowcols,
    const T* __restrict__ rowvals, const int* __restrict__ colrows,
    const T* __restrict__ colvals, const void* __restrict__ Kinv,
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
    T* __restrict__ rhs_scratch, T* __restrict__ v_scratch, Wb<T> wb,
    const int* __restrict__ stop, int S, int m, int n, int kr, int kc,
    int n_sweeps, int n_refine, int n_extra, T sigma, T alpha, T beta) {
  if (*stop) return;  // the solve loop's stop flag (see the top)
  using V = Tile<T, SB>;
  constexpr bool kLow = PREC > 0, kHigh = PREC == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  // dense: gammas, the K^-1 input w, x-tilde, split-k partial sums (and
  // w's second bf16 part at a lowered mode); structured: two mbarriers,
  // gammas, x-tilde, two stage buffers, the block products' partial sums,
  // two buffers of a block's input, u and v (and at a lowered mode the
  // second bf16 parts of the two input buffers and of u); each region
  // 16-byte aligned; cuda_kernels.sparse_smem_bytes mirrors both
  T *gs, *sw = nullptr, *sw2 = nullptr, *sxt, *part;
  T *gb = nullptr, *gb2 = nullptr, *su = nullptr, *su2 = nullptr;
  T *sv2 = nullptr;
  Pipe pp{};
  if constexpr (WB) {
    const long long bv = pad16<T>(static_cast<long long>(wb.bmax) * SB);
    pp.full = reinterpret_cast<uint64_t*>(smem_raw);
    gs = reinterpret_cast<T*>(smem_raw + 16);
    sxt = gs + pad16<T>(SB);
    pp.stage[0] = reinterpret_cast<unsigned char*>(
        sxt + pad16<T>(static_cast<long long>(n) * SB));
    pp.stage[1] = pp.stage[0] + r16(wb.stage_bytes);
    part = reinterpret_cast<T*>(pp.stage[1] + r16(wb.stage_bytes));
    gb = part + pad16<T>(static_cast<long long>(
                    nt > wb.bmax ? nt : wb.bmax) * SB);
    su = gb + 2 * bv;
    sv2 = su + bv;
    gb2 = sv2 + bv;
    su2 = gb2 + 2 * bv;
  } else {
    gs = reinterpret_cast<T*>(smem_raw);
    sw = gs + SB;
    sxt = sw + n * SB;
    part = sxt + n * SB;
    sw2 = part + kThreads * SB;
  }

  const long long s0 = static_cast<long long>(blockIdx.x) * SB;
  const int ns = static_cast<int>(S - s0 < SB ? S - s0 : SB);
  const long long on = s0 * n;
  const long long om = s0 * m;
  // this tile's scratch: the rhs (n, SB) and an m-vector (m, SB); in the
  // structured mode also the K^-1 input (n, SB), by position
  T* srhs = rhs_scratch + static_cast<long long>(blockIdx.x) * n * SB;
  T* sv = v_scratch + static_cast<long long>(blockIdx.x) * m * SB;
  T *swg = nullptr, *swg2 = nullptr;
  if constexpr (WB) {
    swg = wb.sw + static_cast<long long>(blockIdx.x) * n * SB;
    swg2 = wb.sw2 + static_cast<long long>(blockIdx.x) * n * SB;
  }

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
  if constexpr (WB) {
    // one apply walks the block panels, C^-1's, the block panels again
    int P = 0;
    while (P < wb.nitems && __ldg(wb.items + 3 * P) < wb.nb) ++P;
    pp.L = wb.nitems + P;
    pp.total = static_cast<long long>(n_sweeps) * (1 + n_pass) * pp.L;
    if (tid == 0) {
      mbar_init(pp.full);
      mbar_init(pp.full + 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0 && pp.total > 0) {
      pipe_issue<T, typename Entry<T, PREC>::type>(wb, pp, 0);
    }
  }
  __syncthreads();

  // the K^-1 input w of index j, scenario s: by position in the structured
  // mode's scratch (its products split it as they read it), or in shared
  // memory, as its bf16 parts at a lowered mode
  auto put_w = [&](int j, int s, T w) {
    if constexpr (WB) {
      swg[static_cast<long long>(__ldg(wb.pos + j)) * SB + s] = w;
    } else if constexpr (kLow) {
      split_bf16(w, sw[j * SB + s], sw2[j * SB + s]);
    } else {
      sw[j * SB + s] = w;
    }
  };
  // xt = K^-1 w (add: xt += K^-1 w); ends with a barrier
  auto apply = [&](bool add) {
    auto epi = [&](int j, const V& acc) {
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        sxt[j * SB + s] = add ? sxt[j * SB + s] + acc.v[s] : acc.v[s];
      }
    };
    if constexpr (WB) {
      wb_apply<T, SB, PREC>(wb, pp, swg, swg2, sxt, gb, gb2, su, su2, sv2,
                            part, n, add);
    } else if constexpr (kLow) {
      const __nv_bfloat16* K1 = static_cast<const __nv_bfloat16*>(Kinv);
      const __nv_bfloat16* K2 = K1 + static_cast<long long>(n) * n;
      contract<T, SB, CW>(n, n, part, [&](int k0, int k1, int c0) {
        return column_dot_lo<T, SB, CW, kHigh>(sw, sw2, K1, K2, k0, k1, n,
                                               c0);
      }, epi);
    } else {
      const T* K0 = static_cast<const T*>(Kinv);
      contract<T, SB, CW>(n, n, part, [&](int k0, int k1, int c0) {
        return column_dot<T, SB, CW>(sw, K0, k0, k1, n, c0);
      }, epi);
    }
  };

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    // v = g rho_a z - y, the A' input (zero for the masked scenarios),
    // kBatch elements a thread at a time
    for (int e0 = tid; e0 < SB * m; e0 += kBatch * nt) {
      T zv[kBatch], yv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * nt;
        const int s = e / m;
        zv[u] = yv[u] = T(0);
        if (e < SB * m && s < ns) {
          const long long r = om + e;
          zv[u] = z[r];
          yv[u] = y[r];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * nt;
        if (e < SB * m) {
          const int s = e / m, i = e - s * m;
          sv[static_cast<long long>(i) * SB + s] =
              s < ns ? gs[s] * rho_a[i] * zv[u] - yv[u] : T(0);
        }
      }
    }
    __syncthreads();
    // rhs = ((g sigma x - q) + A'v) + (g rho_x zx - yx); w = rhs / g
    for (int j = tid; j < n; j += nt) {
      const V atv = ell_dot<T, SB>(colrows, colvals, 0, kc, n, j, sv);
      // the column's state, all loads before the first store
      T xs[SB], qs[SB], zxs[SB], yxs[SB];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        const long long r = on + static_cast<long long>(s) * n + j;
        const bool in = s < ns;
        xs[s] = in ? x[r] : T(0);
        qs[s] = in ? q[r] : T(0);
        zxs[s] = in ? zx[r] : T(0);
        yxs[s] = in ? yx[r] : T(0);
      }
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        T rhs = T(0), w = T(0);
        if (s < ns) {
          const T g = gs[s];
          rhs = ((g * sigma) * xs[s] - qs[s] + atv.v[s]) +
                ((g * rho_x[j]) * zxs[s] - yxs[s]);
          w = rhs / g;
        }
        srhs[static_cast<long long>(j) * SB + s] = rhs;
        put_w(j, s, w);
      }
    }
    __syncthreads();
    // xt = K^-1 w
    apply(false);
    // refinement against the exact per-scenario system g K + diag(dq2),
    // K applied matrix-free through the ELL arrays
    for (int pass = 0; pass < n_pass; ++pass) {
      // t = rho_a (A xt), into the m-vector scratch
      rows_of_A<T, SB, WB>(
          rowcols, rowvals, kr, m, wb, sxt,
          [&](int i, const V& axt) {
            const T ra = rho_a[i];
#pragma unroll
            for (int s = 0; s < SB; ++s) {
              sv[static_cast<long long>(i) * SB + s] = axt.v[s] * ra;
            }
          },
          [&](int i, int s, T axt) {
            sv[static_cast<long long>(i) * SB + s] = axt * rho_a[i];
          });
      __syncthreads();
      // w = (rhs - (g (diagK xt + A't) + dq2 xt)) / g
      for (int j = tid; j < n; j += nt) {
        const V att = ell_dot<T, SB>(colrows, colvals, 0, kc, n, j, sv);
        T ds[SB], rs[SB];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          const bool in = s < ns;
          ds[s] = in ? dq2[on + static_cast<long long>(s) * n + j] : T(0);
          rs[s] = in ? srhs[static_cast<long long>(j) * SB + s] : T(0);
        }
        const T dk = diagK[j];
#pragma unroll
        for (int s = 0; s < SB; ++s) {
          T w = T(0);
          if (s < ns) {
            const T xt = sxt[j * SB + s];
            const T kx = xt * dk + att.v[s];
            const T g = gs[s];
            w = (rs[s] - (g * kx + ds[s] * xt)) / g;
          }
          put_w(j, s, w);
        }
      }
      __syncthreads();
      apply(true);
    }
    // x, zx, yx updates, kBatch elements a thread at a time so that
    // their loads are in flight together; nothing below writes x-tilde
    for (int e0 = tid; e0 < ns * n; e0 += kBatch * nt) {
      T xv[kBatch], zxv[kBatch], yxv[kBatch], lbv[kBatch], ubv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * nt;
        if (e < ns * n) {
          const long long r = on + e;
          xv[u] = x[r];
          zxv[u] = zx[r];
          yxv[u] = yx[r];
          lbv[u] = lb[r];
          ubv[u] = ub[r];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * nt;
        if (e < ns * n) {
          const int s = e / n, j = e - s * n;
          const long long r = on + e;
          const T rx = gs[s] * rho_x[j];
          const T xt = alpha * sxt[j * SB + s];
          const T zxa = xt + beta * zxv[u];
          const T zxn = clip(zxa + yxv[u] / rx, lbv[u], ubv[u]);
          yx[r] = yxv[u] + rx * (zxa - zxn);
          zx[r] = zxn;
          x[r] = xt + beta * xv[u];
        }
      }
    }
    // Axt = A xt by rows, and each row's z, y, Ax update
    auto row_update = [&](int i, int s, T axt, T zr, T yr, T clr, T cur,
                          T axr) {
      const long long r = om + static_cast<long long>(s) * m + i;
      const T ra = gs[s] * rho_a[i];
      const T a = alpha * axt;
      const T za = a + beta * zr;
      const T zn = clip(za + yr / ra, clr, cur);
      y[r] = yr + ra * (za - zn);
      z[r] = zn;
      Ax[r] = a + beta * axr;
    };
    rows_of_A<T, SB, WB>(
        rowcols, rowvals, kr, m, wb, sxt,
        [&](int i, const V& axt) {
          // every scenario's state loads before the first store, so they
          // are in flight together
          T zs[SB], ys[SB], cls[SB], cus[SB], axs[SB];
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            const long long r = om + static_cast<long long>(s) * m + i;
            const bool on = s < ns;
            zs[s] = on ? z[r] : T(0);
            ys[s] = on ? y[r] : T(0);
            cls[s] = on ? cl[r] : T(0);
            cus[s] = on ? cu[r] : T(0);
            axs[s] = on ? Ax[r] : T(0);
          }
#pragma unroll
          for (int s = 0; s < SB; ++s) {
            if (s < ns) {
              row_update(i, s, axt.v[s], zs[s], ys[s], cls[s], cus[s],
                         axs[s]);
            }
          }
        },
        [&](int i, int s, T axt) {
          if (s < ns) {
            const long long r = om + static_cast<long long>(s) * m + i;
            row_update(i, s, axt, z[r], y[r], cl[r], cu[r], Ax[r]);
          }
        });
    __syncthreads();
  }
}

// Shared memory of one block: cuda_kernels.sparse_smem_bytes mirrors both.
template <typename T, int SB, bool WB, int PREC>
size_t smem_bytes(int n, const Wb<T>& wb) {
  if constexpr (WB) {
    const long long nt = kThreads;
    const long long e = pad16<T>(SB) + pad16<T>(static_cast<long long>(n) * SB) +
                        pad16<T>((nt > wb.bmax ? nt : wb.bmax) * SB) +
                        (PREC > 0 ? 7 : 4) *
                            pad16<T>(static_cast<long long>(wb.bmax) * SB);
    return 16 + sizeof(T) * static_cast<size_t>(e) +
           2 * static_cast<size_t>(r16(wb.stage_bytes));
  } else {
    return sizeof(T) * SB *
           (1 + (PREC > 0 ? 3 : 2) * static_cast<size_t>(n) + kThreads);
  }
}

template <typename T, int SB, int CW, bool WB, int PREC>
int launch_tile(void* const* in, void* const* out, Wb<T> wb, const int* stop,
                int S, int m, int n, int kr, int kc, int n_sweeps,
                int n_refine, int n_extra, double sigma, double alpha,
                void* stream) {
  const size_t smem = smem_bytes<T, SB, WB, PREC>(n, wb);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // raised once to the largest size asked, so that a launch captured into
  // a CUDA graph after a first (warm-up) launch makes no attribute call
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_sweeps_sparse_kernel<T, SB, CW, WB, PREC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto ci = [&](int k) { return static_cast<const int*>(in[k]); };
  auto o = [&](int k) { return static_cast<T*>(out[k]); };
  const int grid = (S + SB - 1) / SB;
  fused_sweeps_sparse_kernel<T, SB, CW, WB, PREC>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          c(0), ci(1), c(2), ci(3), c(4), in[5], c(6), c(7), c(8), c(9),
          c(10), c(11), c(12), c(13), c(14), c(15), c(16), c(17), c(18),
          c(19), c(20), c(21), o(0), o(1), o(2), o(3), o(4), o(5), o(6),
          o(7), wb, stop, S, m, n, kr, kc, n_sweeps, n_refine, n_extra,
          static_cast<T>(sigma), static_cast<T>(alpha),
          static_cast<T>(1.0 - alpha));
  return static_cast<int>(cudaGetLastError());
}

// Dense mode: K^-1 columns per thread, the widest vector load (up to
// kMaxCW values) whose width divides n, so that every row of K^-1 starts
// aligned.  The lowered modes take one column a thread (no main path runs
// them, and one width keeps their build and registers small).
template <typename T, int SB, int CWmax, int PREC>
int launch_cols(void* const* in, void* const* out, const int* stop, int S,
                int m, int n, int kr, int kc, int n_sweeps, int n_refine,
                int n_extra, double sigma, double alpha, void* stream) {
  if constexpr (PREC > 0 && CWmax > 1) {
    return launch_cols<T, SB, 1, PREC>(in, out, stop, S, m, n, kr, kc,
                                       n_sweeps, n_refine, n_extra, sigma,
                                       alpha, stream);
  } else {
    if constexpr (CWmax > 1) {
      if (n % CWmax != 0) {
        return launch_cols<T, SB, CWmax / 2, PREC>(in, out, stop, S, m, n,
                                                   kr, kc, n_sweeps,
                                                   n_refine, n_extra, sigma,
                                                   alpha, stream);
      }
    }
    return launch_tile<T, SB, CWmax, false, PREC>(
        in, out, Wb<T>{}, stop, S, m, n, kr, kc, n_sweeps, n_refine,
        n_extra, sigma, alpha, stream);
  }
}

template <typename T, int SB, int PREC>
int launch_mode(void* const* in, void* const* out, const Wb<T>* wb,
                const int* stop, int S, int m, int n, int kr, int kc,
                int n_sweeps, int n_refine, int n_extra, double sigma,
                double alpha, void* stream) {
  if (wb == nullptr) {
    return launch_cols<T, SB, kMaxCW<T>, PREC>(in, out, stop, S, m, n, kr,
                                               kc, n_sweeps, n_refine,
                                               n_extra, sigma, alpha, stream);
  }
  return launch_tile<T, SB, 1, true, PREC>(in, out, *wb, stop, S, m, n, kr,
                                           kc, n_sweeps, n_refine, n_extra,
                                           sigma, alpha, stream);
}

template <typename T, int SB>
int launch_lowered(void* const* in, void* const* out, const Wb<T>* wb,
                   const int* stop, int S, int m, int n, int kr, int kc,
                   int n_sweeps, int n_refine, int n_extra, int prec,
                   double sigma, double alpha, void* stream) {
  switch (prec) {
    case 1:
      return launch_mode<T, SB, 1>(in, out, wb, stop, S, m, n, kr, kc,
                                   n_sweeps, n_refine, n_extra, sigma, alpha,
                                   stream);
    case 2:
      return launch_mode<T, SB, 2>(in, out, wb, stop, S, m, n, kr, kc,
                                   n_sweeps, n_refine, n_extra, sigma, alpha,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The lowered modes are built for tiles of 8, 4 and 2 scenarios
// (cuda_kernels.usable_sparse asks no smaller tile of them).
template <typename T, int SB>
int launch_sb(void* const* in, void* const* out, const Wb<T>* wb,
              const int* stop, int S, int m, int n, int kr, int kc,
              int n_sweeps, int n_refine, int n_extra, int prec, double sigma,
              double alpha, void* stream) {
  if (prec == 0) {
    return launch_mode<T, SB, 0>(in, out, wb, stop, S, m, n, kr, kc,
                                 n_sweeps, n_refine, n_extra, sigma, alpha,
                                 stream);
  }
  if constexpr (SB < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch_lowered<T, SB>(in, out, wb, stop, S, m, n, kr, kc,
                                 n_sweeps, n_refine, n_extra, prec, sigma,
                                 alpha, stream);
  }
}

template <typename T>
int launch(void* const* in, void* const* out, const Wb<T>* wb,
           const int* stop, int S, int m, int n, int kr, int kc, int sb,
           int n_sweeps, int n_refine, int n_extra, int prec, double sigma,
           double alpha, void* stream) {
  if (S < 1 || n < 1 || m < 0 || kr < 1 || kc < 1 || stop == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the dense mode's lowered K^-1 rows are read 2 CW bytes at a time
  if (wb == nullptr && prec > 0 &&
      reinterpret_cast<uintptr_t>(in[5]) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // cuda_kernels.SPARSE_TILES mirrors these cases
  switch (sb) {
    case 8:
      return launch_sb<T, 8>(in, out, wb, stop, S, m, n, kr, kc, n_sweeps,
                             n_refine, n_extra, prec, sigma, alpha, stream);
    case 4:
      return launch_sb<T, 4>(in, out, wb, stop, S, m, n, kr, kc, n_sweeps,
                             n_refine, n_extra, prec, sigma, alpha, stream);
    case 2:
      return launch_sb<T, 2>(in, out, wb, stop, S, m, n, kr, kc, n_sweeps,
                             n_refine, n_extra, prec, sigma, alpha, stream);
    case 1:
      return launch_sb<T, 1>(in, out, wb, stop, S, m, n, kr, kc, n_sweeps,
                             n_refine, n_extra, prec, sigma, alpha, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The structured operand from the launch's pointers (in[22..35], the
// scratch out[8], out[9]) and sizes; checks what the kernel relies on.
template <typename T>
int launch_wb(void* const* in, void* const* out, const int* stop, int S,
              int m, int n, int kr, int kc, int sb, int n_sweeps,
              int n_refine, int n_extra, int prec, double sigma,
              double alpha, int r, int kn, int kw, int kwc, int nb,
              int nitems, int pd, int stage_bytes, int bmax, void* stream) {
  if (r < 0 || kn < 1 || kw < 1 || kwc < 1 || nb < 0 || nitems < 1 ||
      pd < 0 || pd > n || stage_bytes < 1 || bmax < 16 || bmax > kThreads ||
      bmax % 16 != 0 || stage_bytes >= (1 << 20) ||
      reinterpret_cast<uintptr_t>(in[5]) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto c = [&](int k) { return static_cast<const T*>(in[k]); };
  auto ci = [&](int k) { return static_cast<const int*>(in[k]); };
  const Wb<T> wb{in[5],  ci(22), ci(23), ci(24), ci(25), c(26), ci(27),
                 c(28),  ci(29), ci(30), c(31),  ci(32), c(33), ci(34),
                 c(35),  static_cast<T*>(out[8]), static_cast<T*>(out[9]),
                 r, kn, kw, kwc, nb, nitems, pd, stage_bytes, bmax};
  return launch<T>(in, out, &wb, stop, S, m, n, kr, kc, sb, n_sweeps,
                   n_refine, n_extra, prec, sigma, alpha, stream);
}

}  // namespace

extern "C" {

// Dense mode.
// in:  q, rowcols, rowvals, colrows, colvals, Kinv, diagK, cl, cu, lb, ub,
//      rho_a, rho_x, dq2, has, gamma, x, z, zx, y, yx, Ax
//      (the ELL arrays slot-major: rowcols/rowvals (kr, m), colrows/colvals
//       (kc, n); rowcols, colrows int32; Kinv at prec 1 or 2 its bf16
//       parts (prec, n, n), 16-byte aligned; the rest T)
// out: x, z, zx, y, yx, Ax, then the scratch rhs (tiles * n * sb) and
//      m-vector (tiles * m * sb)
// stop: a device int, the solve loop's stop flag; where it is set every
// block returns at once and the outputs are left unwritten.
// prec: 0 exact, 1 "default" (bf16), 2 "high" (bf16x3) K^-1 applies.
// Returns the cudaError_t of the launch (0 on success).
int tpusppy_fused_sweeps_sparse_f32(void* const* in, void* const* out,
                                    const int* stop, int S, int m, int n,
                                    int kr, int kc, int sb, int n_sweeps,
                                    int n_refine, int n_extra, int prec,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<float>(in, out, nullptr, stop, S, m, n, kr, kc, sb,
                       n_sweeps, n_refine, n_extra, prec, sigma, alpha,
                       stream);
}

int tpusppy_fused_sweeps_sparse_f64(void* const* in, void* const* out,
                                    const int* stop, int S, int m, int n,
                                    int kr, int kc, int sb, int n_sweeps,
                                    int n_refine, int n_extra, int prec,
                                    double sigma, double alpha,
                                    void* stream) {
  return launch<double>(in, out, nullptr, stop, S, m, n, kr, kc, sb,
                        n_sweeps, n_refine, n_extra, prec, sigma, alpha,
                        stream);
}

// Structured mode: in as the dense mode with the flat blocks and C^-1
// (`mats`, 16-byte aligned: T entries, or at prec 1 bf16 entries and at
// prec 2 bf16 pairs) in place of Kinv, then pos, order, items, binfo,
// dinv, wcols, wvals, wpos, wtrows, wtvals, ncols, nvals, wrows, wvals_lo
// (int32 index arrays, T values; structured_kkt.KernelWoodbury; at prec 1
// or 2 dinv, wtvals and wvals_lo are their prec bf16 parts, wvals_lo the
// values of A_w t, wvals those of A xt's wide rows); out as the dense
// mode, then two scratch n-vectors (tiles * n * sb each): the K^-1 input,
// and the Woodbury correction.  stage_bytes: the largest panel's bytes.
int tpusppy_fused_sweeps_sparse_wb_f32(
    void* const* in, void* const* out, const int* stop, int S, int m, int n,
    int kr, int kc, int sb, int n_sweeps, int n_refine, int n_extra,
    int prec, double sigma, double alpha, int r, int kn, int kw, int kwc,
    int nb, int nitems, int pd, int stage_bytes, int bmax, void* stream) {
  return launch_wb<float>(in, out, stop, S, m, n, kr, kc, sb, n_sweeps,
                          n_refine, n_extra, prec, sigma, alpha, r, kn, kw,
                          kwc, nb, nitems, pd, stage_bytes, bmax, stream);
}

int tpusppy_fused_sweeps_sparse_wb_f64(
    void* const* in, void* const* out, const int* stop, int S, int m, int n,
    int kr, int kc, int sb, int n_sweeps, int n_refine, int n_extra,
    int prec, double sigma, double alpha, int r, int kn, int kw, int kwc,
    int nb, int nitems, int pd, int stage_bytes, int bmax, void* stream) {
  return launch_wb<double>(in, out, stop, S, m, n, kr, kc, sb, n_sweeps,
                           n_refine, n_extra, prec, sigma, alpha, r, kn, kw,
                           kwc, nb, nitems, pd, stage_bytes, bmax, stream);
}

}  // extern "C"

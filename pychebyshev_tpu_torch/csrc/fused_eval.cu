// Fused batched barycentric evaluation of a dense Chebyshev tensor on
// Hopper's tensor cores, in f32 (3xTF32) and in f64 (DMMA): one kernel
// body, templated on the scalar type.
//
// Replaces three Pallas TPU kernels:
// - K1, pychebyshev_tpu/ops/pallas_eval.py::_build_kernel (one-level
//   f32 variant): the float instance, entry fused_eval_f32.
// - K2, pychebyshev_tpu/ops/pallas_eval.py::_build_stream_kernel (the
//   two-level f32 variant for grids whose one-tile VMEM working set does
//   not fit: 15^5..19^5, 9^6): the same float instance.  K2's sequential
//   middle-dim grid axis becomes the in-block loop over contraction
//   stages below, so only the rows of a block's points have to fit in
//   shared memory (ops/fused_eval.py::supports_fused).
// - K3, pychebyshev_tpu/ops/pallas_dd.py::_build_kernel (near-f64 "dd"
//   evaluation through bf16 digit planes): the double instance, entry
//   fused_eval_f64.  The TPU kernel builds f64 accuracy out of bf16
//   digit-plane GEMMs because TPU v5e has no f64; Hopper's tensor cores
//   multiply f64 natively, so the same function (within the dd
//   contract's 1e-10 of true f64, in fact to f64 rounding) is computed
//   with f64 products and f64 accumulation.
//
// What it computes, per point x (d >= 3 dims, split at s by
// ops/eval.py::_split_index into left dims [0, s), the middle dim s and
// the right-prime dims (s, d)):
//   rows_k  = (w / (x_k - nodes)) / sum(...)    one-hot at an exact node
//   w_left  = rows_0 (x) ... (x) rows_{s-1}      Khatri-Rao, (n_left,)
//   A[k]    = rows_s[j] * (rows_{s+1} (x) ... (x) rows_{d-1})[r],
//             k = j * n_rp + r                   (n_mid * n_rp,)
//   out     = sum_l w_left[l] * sum_k A[k] * T3[k][l]
// T3 is the (derivative-applied) value tensor re-laid out as
// [n_mid * n_rp][n_left] and zero-padded to [k_pad][ld] (k_pad a
// multiple of kBK, ld of kBN) by the Python wrapper (ops/fused_eval.py).
//
// What bounds it on an H100 SXM: the contraction, 2 * prod(shape) FLOP
// per point (322 KFLOP at 11^5) against a tensor that stays in the
// 50 MB L2, so at N = 2^20 it is bound by operations, not bytes.
// - f64 (K3) runs on the f64 tensor cores, `mma.sync` m16n8k8 f64
//   (DMMA), 67 TFLOP/s: 5.0 ms at 11^5 (the f64 SIMT pipes, 34 TFLOP/s,
//   would give 9.9 ms).  Hopper has no f64 `wgmma`.
// - f32 (K1, K2) runs on the TF32 tensor cores, `mma.sync` m16n8k8 tf32,
//   495 TFLOP/s, in three passes: each operand x splits into
//   big = tf32(x) and small = tf32(x - big) (`cvt.rna`), and the product
//   is small*big + big*small + big*big with f32 accumulation, which keeps
//   f32 accuracy where one TF32 pass keeps about three decimal digits.
//   Bound: 3 * 2 * prod(shape) FLOP per point at 495 TFLOP/s, 2.0 ms at
//   11^5 (the f32 SIMT pipes, 67 TFLOP/s, would give 5.0 ms).  The
//   tensor cores' f32 accumulation does not round to nearest, so each
//   tile's three MMAs of a k8 step sum from zero and are added to the
//   running sum in IEEE f32.
//
// The design keeps every per-point intermediate on chip, so device
// memory sees only the points in and one value out per point:
// - A block owns kBM = 128 points and walks the n_left columns in tiles
//   of kBN = 128, each tile over the whole contraction depth in stages of
//   kBK = 16.  Eight warps, 2 x 4, each own a 64 x 32 accumulator tile in
//   registers (64 values a thread).  The f64 instance takes 239
//   registers a thread, so one block runs per SM; the f32 instance is
//   held to 128, so two do, and one block's SIMT work overlaps the
//   other's MMAs.  One value per point is written once, with no atomics,
//   so results repeat run to run.
// - The rows of the block's points stay in shared memory.  A is formed
//   stage by stage from them (no per-point right-prime factor is stored,
//   so 19^5 fits at 128 points); f32 stores A as its tf32 big and small
//   planes.  A is double-buffered: the next stage's A is formed after
//   this stage's MMAs are issued, while they run.
// - A's column k = j * n_rp + r reads the middle dim's row at j and the
//   right-prime dims' rows at the digits of r.  The digits' row lanes are
//   worked out once per block into a table of 16-bit lanes per r, and
//   each thread steps its (j, r) by kBK per stage; with the T copies
//   moving a base offset, the stage loop does no integer division.
//   (Dividing in the loop cost more instructions per stage than the MMAs
//   did.)
// - T tiles stream from L2 into a ring of kStages = 3 shared-memory
//   stages with 16-byte cp.async, so the loads of stage q+2 overlap the
//   MMAs of stage q; one barrier per stage.  Row pads make the fragment
//   loads free of bank conflicts.
// - The stage sequence runs across column tiles without draining.  After
//   a tile's last stage each thread weights its accumulator columns by
//   w_left (built from the rows); each row's sum is reduced across the
//   fragment's lanes with shuffles and added to its column warp's partial
//   sum in shared memory, and the four column warps' sums are added in a
//   fixed order at the end.
//
// Exact nodes follow the reference semantics (ops/eval.py): a coordinate
// within 1e-14 of a node takes the one-hot row at the first such node.
// Ragged N: rows of points past n_points are zero and nothing is stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_eval.so fused_eval.cu
// The plain C entry points below are bound with ctypes
// (ops/fused_eval.py for f32, ops/fused_dd.py for f64).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 16;
// Keep these in step with ops/fused_eval.py (_BLOCK_POINTS, _COL_TILE,
// _DEPTH, _STAGES, _WARPS_N, _PAD, _A_PLANES, _smem_bytes).
constexpr int kBM = 128;       // points per block
constexpr int kBN = 128;       // left-index columns per tile
constexpr int kBK = 16;        // contraction steps per stage
constexpr int kStages = 3;     // T-tile ring depth
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWarpM = kBM / kWarpsM;   // 64 rows per warp
constexpr int kWarpN = kBN / kWarpsN;   // 32 columns per warp
constexpr int kMTiles = kWarpM / 16;    // m16 tiles per warp
constexpr int kNTiles = kWarpN / 8;     // n8 tiles per warp
constexpr int kALanes = kThreads / kBK;  // threads per depth index of A
constexpr int kAPoints = kBM / kALanes;  // points per thread of A
constexpr int kMaxSmemBytes = 232448;
constexpr double kNodeTol = 1e-14;
static_assert(kBM == kBN, "A and T stages share one row stride");
static_assert(kThreads % kBK == 0 && kBM % kALanes == 0, "A mapping");
static_assert(kBK % 8 == 0, "a stage is whole m16n8k8 steps");

// Per-type plan.  kPad: row pad in values, so that the fragment loads
// (lane (g, q) reads row q, column g) hit 32 distinct banks.  A's f32
// planes hold tf32(a) and tf32(a - tf32(a)).  kMinBlocks: blocks per SM
// the registers are cut for: the f64 accumulators alone take 128
// registers a thread, so one; the f32 instance fits 128 registers, so
// two, and one block's SIMT work overlaps the other's MMAs.
template <typename T> struct Plan;
template <> struct Plan<float> {
  static constexpr int kPad = 8;
  static constexpr int kAPlanes = 2;
  static constexpr int kMinBlocks = 2;
};
template <> struct Plan<double> {
  static constexpr int kPad = 4;
  static constexpr int kAPlanes = 1;
  static constexpr int kMinBlocks = 1;
};
template <typename T> constexpr int kStride = kBN + Plan<T>::kPad;
template <typename T> using Acc = T[kMTiles][kNTiles][4];

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// D = A * B + D on one m16n8k8 tile; fragments as in the PTX ISA:
// lane (g, q) = (lane / 4, lane % 4) holds a = A[g][q], A[g+8][q],
// A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g]; c = C[g][2q],
// C[g][2q+1], C[g+8][2q], C[g+8][2q+1].
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// D = A * B (C = 0).
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4],
                                    double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// A[k][b] into its stage buffer: f64 as is, f32 as tf32 big and small.
__device__ __forceinline__ void store_a(double* a, int i, double v) {
  a[i] = v;
}
__device__ __forceinline__ void store_a(float* a, int i, float v) {
  const uint32_t big = tf32(v);
  a[i] = __uint_as_float(big);
  a[i + kBK * kStride<float>] =
      __uint_as_float(tf32(v - __uint_as_float(big)));
}

// Eight contraction steps of a warp's 64 x 32 tile.  `a` points at the
// warp's first row of the A stage ([kBK][S], k-major) at the first of the
// eight steps, `t` at its first column of the T stage ([kBK][S]).
//
// f64: straight into the accumulators.
__device__ __forceinline__ void mma_k8(Acc<double>& acc, const double* a,
                                       const double* t, int g, int q) {
  constexpr int S = kStride<double>;
  double b[kNTiles][2];
#pragma unroll
  for (int ni = 0; ni < kNTiles; ++ni) {
    const double* p = t + q * S + ni * 8 + g;
    b[ni][0] = p[0];
    b[ni][1] = p[4 * S];
  }
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    const double* p = a + q * S + mi * 16 + g;
    const double af[4] = {p[0], p[8], p[4 * S], p[4 * S + 8]};
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) mma(acc[mi][ni], af, b[ni][0], b[ni][1]);
  }
}

// f32 in three TF32 passes (A arrives split, T is split here).  Each
// tile's three MMAs of a k8 step sum from zero, and the sum is added to
// the accumulator in IEEE f32: the tensor cores' own f32 accumulation
// does not round to nearest, so a sum carried through thousands of MMAs
// drifts (on a random 19^5 tensor, a 6,859-deep contraction, to 3.9e-5
// of scale from the plain version, near the 5e-5 ceiling).
__device__ __forceinline__ void mma_k8(Acc<float>& acc, const float* a,
                                       const float* t, int g, int q) {
  constexpr int S = kStride<float>;
  constexpr int kPlane = kBK * S;
  uint32_t bb[kNTiles][2], bs[kNTiles][2];
#pragma unroll
  for (int ni = 0; ni < kNTiles; ++ni) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float x = t[(q + 4 * h) * S + ni * 8 + g];
      bb[ni][h] = tf32(x);
      bs[ni][h] = tf32(x - __uint_as_float(bb[ni][h]));
    }
  }
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
    const float* p = a + q * S + mi * 16 + g;
    const uint32_t ab[4] = {
        __float_as_uint(p[0]), __float_as_uint(p[8]),
        __float_as_uint(p[4 * S]), __float_as_uint(p[4 * S + 8])};
    const uint32_t as[4] = {
        __float_as_uint(p[kPlane]), __float_as_uint(p[kPlane + 8]),
        __float_as_uint(p[kPlane + 4 * S]),
        __float_as_uint(p[kPlane + 4 * S + 8])};
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) {
      float sum[4];
      mma0(sum, as, bb[ni][0], bb[ni][1]);
      mma(sum, ab, bs[ni][0], bs[ni][1]);
      mma(sum, ab, bb[ni][0], bb[ni][1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sum[e];
    }
  }
}

struct Geometry {
  int d;        // number of dims
  int s;        // split: left dims [0, s), middle dim s, right-prime (s, d)
  int w;        // sum of the shape: width of a point's packed rows
  int n_left;   // prod(shape[0:s])
  int n_rp;     // prod(shape[s+1:d]), 1 when there is no right-prime dim
  int k;        // contraction depth: shape[s] * n_rp
  int k_pad;    // k rounded up to kBK: T3's rows
  int ld;       // n_left rounded up to kBN: T3's row length
  int shape[kMaxDims];
  int off[kMaxDims];     // lane offset of each dim in the packed rows
  int stride[kMaxDims];  // C-order stride of each dim inside its group
};

template <typename T>
__global__ void __launch_bounds__(kThreads, Plan<T>::kMinBlocks)
fused_eval_kernel(const T* __restrict__ points,
                  const T* __restrict__ nodes,
                  const T* __restrict__ weights,
                  const T* __restrict__ t3,
                  T* __restrict__ out, int n_points, Geometry g) {
  constexpr int S = kStride<T>;
  constexpr int kTStage = kBK * S;
  constexpr int kABuf = Plan<T>::kAPlanes * kBK * S;
  extern __shared__ double2 smem16[];  // 16-byte aligned
  T* ring = reinterpret_cast<T*>(smem16);  // [kStages][kBK][S]
  T* abuf = ring + kStages * kTStage;      // [2][planes][kBK][S]
  T* red = abuf + 2 * kABuf;               // [kWarpsN][kBM]
  T* rows = red + kWarpsN * kBM;           // [kBM][w]

  const int tid = threadIdx.x;
  const int n_k = g.k_pad / kBK;             // stages per column tile
  const int n_q = n_k * (g.ld / kBN);        // stages in all
  const int n_mid = g.shape[g.s];
  const int n_rp_lanes = g.d - g.s - 1;      // right-prime dims
  // [n_rp][n_rp_lanes] right-prime row lanes after the rows.
  unsigned short* lane_tab =
      reinterpret_cast<unsigned short*>(rows + kBM * g.w);

  // T copies: this thread's kChunks 16-byte chunks of a stage sit at
  // fixed places in the tile, so each stage only moves the base: down
  // kBK rows, or at a column tile's end to the next tile's first row.
  // One commit group per stage (empty past the last, so the group count
  // stays uniform).
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowChunks = kBN / kVec;
  constexpr int kChunks = kBK * kRowChunks / kThreads;
  static_assert(kBK * kRowChunks % kThreads == 0, "whole chunks");
  int src = 0;   // the next stage to copy: its first element in t3
  int src_ks = 0;
  auto copy_stage = [&](int q) {  // stage q, into ring slot q % kStages
    if (q < n_q) {
      T* dst = ring + (q % kStages) * kTStage;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / kRowChunks;
        const int col = c % kRowChunks * kVec;
        cp_async16(dst + r * S + col, t3 + (src + r * g.ld + col));
      }
      src += kBK * g.ld;
      if (++src_ks == n_k) {
        src_ks = 0;
        src += kBN - g.k_pad * g.ld;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) copy_stage(q);

  // Normalized barycentric rows, one (point, dim) per task.
  for (int task = tid; task < kBM * g.d; task += kThreads) {
    const int b = task / g.d;
    const int dim = task - b * g.d;
    const int o = g.off[dim];
    const int n = g.shape[dim];
    T* row = rows + b * g.w + o;
    const long long p = static_cast<long long>(blockIdx.x) * kBM + b;
    if (p >= n_points) {  // ragged last tile: zero rows, no output
      for (int i = 0; i < n; ++i) row[i] = T(0);
      continue;
    }
    const T x = points[p * g.d + dim];
    int hit = -1;
    for (int i = 0; i < n; ++i) {
      if (hit < 0 && abs_t(x - nodes[o + i]) < T(kNodeTol)) hit = i;
    }
    if (hit >= 0) {
      for (int i = 0; i < n; ++i) row[i] = (i == hit) ? T(1) : T(0);
      continue;
    }
    T sum = T(0);
    for (int i = 0; i < n; ++i) {
      const T v = weights[o + i] / (x - nodes[o + i]);
      row[i] = v;
      sum += v;
    }
    for (int i = 0; i < n; ++i) row[i] = row[i] / sum;
  }
  // The right-prime lanes of the rows that A's column k = j * n_rp + r
  // reads, for each r, worked out once per block so that the stage loop
  // does no integer division.
  for (int r0 = tid; r0 < g.n_rp; r0 += kThreads) {
    unsigned short* lane = lane_tab + r0 * n_rp_lanes;
    int r = r0;
    for (int m = g.s + 1; m < g.d; ++m) {
      const int digit = r / g.stride[m];
      r -= digit * g.stride[m];
      lane[m - g.s - 1] = static_cast<unsigned short>(g.off[m] + digit);
    }
  }
  for (int i = tid; i < kWarpsN * kBM; i += kThreads) red[i] = T(0);
  __syncthreads();

  // A for the stage at depth ks * kBK into buffer `buf`: this thread's
  // column k = a_j * n_rp + a_r (stepped kBK on per call, from a_k at
  // each column tile's first stage), its points a_b + i * kALanes,
  // multiplied in the plain version's order:
  // (1 * rows_{s+1} * ... * rows_{d-1}) * rows_s; zero past k.
  const int a_k = tid / kALanes;
  const int a_b = tid % kALanes;
  const int a_row = a_b * g.w;   // this thread's first point's row
  const int a_step = kALanes * g.w;
  int a_j = 0, a_r = 0;
  auto form_a = [&](int ks, int buf) {
    if (ks == 0) {
      a_j = a_k / g.n_rp;
      a_r = a_k - a_j * g.n_rp;
    }
    T a[kAPoints];
    if (a_j < n_mid) {
#pragma unroll
      for (int i = 0; i < kAPoints; ++i) a[i] = T(1);
      const unsigned short* lane = lane_tab + a_r * n_rp_lanes;
      for (int m = 0; m < n_rp_lanes; ++m) {
        const T* col = rows + a_row + lane[m];
#pragma unroll
        for (int i = 0; i < kAPoints; ++i) a[i] *= col[i * a_step];
      }
      const T* mid = rows + a_row + g.off[g.s] + a_j;
#pragma unroll
      for (int i = 0; i < kAPoints; ++i) a[i] = mid[i * a_step] * a[i];
    } else {
#pragma unroll
      for (int i = 0; i < kAPoints; ++i) a[i] = T(0);
    }
    T* dst = abuf + buf * kABuf + a_k * S;
#pragma unroll
    for (int i = 0; i < kAPoints; ++i) store_a(dst, a_b + i * kALanes, a[i]);
    for (a_r += kBK; a_r >= g.n_rp; a_r -= g.n_rp) ++a_j;
  };

  const int warp = tid / 32;
  const int wm = warp / kWarpsN;  // warp row: points wm * 64 ..
  const int wn = warp % kWarpsN;  // warp column: columns wn * 32 ..
  const int g8 = (tid % 32) / 4;
  const int q4 = tid % 4;
  Acc<T> acc = {};

  // Stage q: its T tile and A were made ready ahead of it; the next
  // stage's A is formed after its MMAs are issued, while they run.
  form_a(0, 0);
  for (int q = 0, ks = 0; q < n_q; ++q) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage q
    __syncthreads();  // everyone's copies and A(q); stage q-1 consumed
    copy_stage(q + kStages - 1);
    const T* a_q = abuf + (q & 1) * kABuf + wm * kWarpM;
    const T* t_q = ring + (q % kStages) * kTStage + wn * kWarpN;
#pragma unroll 1
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      mma_k8(acc, a_q + k8 * S, t_q + k8 * S, g8, q4);
    }
    if (q + 1 < n_q) form_a(ks + 1 == n_k ? 0 : ks + 1, (q + 1) & 1);
    if (++ks != n_k) continue;
    ks = 0;
    const int ct = q / n_k;

    // Column tile ct done: weight its columns by w_left, in the plain
    // version's order (1 * rows_0 * ... * rows_{s-1}), sum each row over
    // the fragment's four column lanes, and add it to the column warp's
    // partial sum of that row in shared memory.
    T part[kMTiles][2] = {};  // rows wm*64 + mi*16 + g8 + 8h
#pragma unroll
    for (int ni = 0; ni < kNTiles; ++ni) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int l = ct * kBN + wn * kWarpN + ni * 8 + 2 * q4 + c;
        if (l < g.n_left) {
          T wl[kMTiles][2];
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi) wl[mi][0] = wl[mi][1] = T(1);
          int rem = l;
          for (int m = 0; m < g.s; ++m) {
            const int digit = rem / g.stride[m];
            rem -= digit * g.stride[m];
            const T* col = rows + g.off[m] + digit;
#pragma unroll
            for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                wl[mi][h] *= col[(wm * kWarpM + mi * 16 + g8 + 8 * h) * g.w];
              }
            }
          }
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              part[mi][h] += wl[mi][h] * acc[mi][ni][2 * h + c];
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        T v = part[mi][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q4 == 0) red[wn * kBM + wm * kWarpM + mi * 16 + g8 + 8 * h] += v;
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int ni = 0; ni < kNTiles; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = T(0);
      }
    }
  }
  cp_async_wait<0>();

  // Sum each row over the four column warps, in a fixed order.
  __syncthreads();
  const long long p = static_cast<long long>(blockIdx.x) * kBM + tid;
  if (tid < kBM && p < n_points) {
    T v = red[tid];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) v += red[w * kBM + tid];
    out[p] = v;
  }
}

// Validate the geometry, set the shared-memory limit and launch on
// `stream`.  Returns a cudaError_t (0 on success).
template <typename T>
int launch(const void* points, const void* nodes, const void* weights,
           const void* t3, void* out, int n_points, int d, const void* shape,
           int s, void* stream) {
  if (d < 3 || d > kMaxDims || s < 1 || s >= d || n_points < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* dims = static_cast<const int*>(shape);
  Geometry g;
  g.d = d;
  g.s = s;
  g.w = 0;
  for (int k = 0; k < d; ++k) {
    if (dims[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
    g.shape[k] = dims[k];
    g.off[k] = g.w;
    g.w += dims[k];
  }
  for (int k = d; k < kMaxDims; ++k) {
    g.shape[k] = 1;
    g.off[k] = 0;
    g.stride[k] = 1;
  }
  int stride = 1;  // right-prime group, C order
  for (int k = d - 1; k > s; --k) {
    g.stride[k] = stride;
    stride *= dims[k];
  }
  g.n_rp = stride;
  g.stride[s] = 1;
  stride = 1;      // left group, C order
  for (int k = s - 1; k >= 0; --k) {
    g.stride[k] = stride;
    stride *= dims[k];
  }
  g.n_left = stride;
  g.k = dims[s] * g.n_rp;
  g.k_pad = (g.k + kBK - 1) / kBK * kBK;
  g.ld = (g.n_left + kBN - 1) / kBN * kBN;
  // The stage loop addresses t3 with 32-bit offsets.
  if (static_cast<long long>(g.k_pad) * g.ld >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  // Stages, partial sums and rows in T, then the 16-bit lane table (the
  // cap keeps w, and so every lane, under 2^16).
  const long long smem =
      static_cast<long long>(sizeof(T)) *
          ((kStages + 2 * Plan<T>::kAPlanes) * kBK * kStride<T> +
           kWarpsN * kBM + static_cast<long long>(kBM) * g.w) +
      2LL * g.n_rp * (d - s - 1);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return static_cast<int>(cudaSuccess);

  cudaError_t err = cudaFuncSetAttribute(
      fused_eval_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_points + kBM - 1) / kBM;
  fused_eval_kernel<T><<<blocks, kThreads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<const T*>(nodes),
      static_cast<const T*>(weights), static_cast<const T*>(t3),
      static_cast<T*>(out), n_points, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  `shape` is a host array of d ints; `s` the split
// index; `t3` the padded [k_pad][ld] pack of ops/fused_eval.py::_pack.
// Returns a cudaError_t (0 on success); the launch is checked with
// cudaGetLastError, and nothing is synchronized.
int fused_eval_f32(const void* points, const void* nodes,
                   const void* weights, const void* t3, void* out,
                   int n_points, int d, const void* shape, int s,
                   void* stream) {
  return launch<float>(points, nodes, weights, t3, out, n_points, d, shape,
                       s, stream);
}

// The same for f64 operands.
int fused_eval_f64(const void* points, const void* nodes,
                   const void* weights, const void* t3, void* out,
                   int n_points, int d, const void* shape, int s,
                   void* stream) {
  return launch<double>(points, nodes, weights, t3, out, n_points, d, shape,
                        s, stream);
}

const char* fused_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

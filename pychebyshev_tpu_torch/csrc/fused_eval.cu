// Fused batched barycentric evaluation of a dense Chebyshev tensor on
// Hopper's tensor cores: in f32 (3xTF32) by a warp-specialised `wgmma`
// kernel, and in f64 (DMMA) by an `mma.sync` kernel.  The two share the
// rows' build and nothing of the contraction: Hopper has no f64 `wgmma`.
//
// Replaces three Pallas TPU kernels:
// - K1, pychebyshev_tpu/ops/pallas_eval.py::_build_kernel (one-level
//   f32 variant): fused_eval_kernel_wgmma, entry fused_eval_f32.
// - K2, pychebyshev_tpu/ops/pallas_eval.py::_build_stream_kernel (the
//   two-level f32 variant for grids whose one-tile VMEM working set does
//   not fit: 15^5..19^5, 9^6): the same f32 kernel.  K2's sequential
//   middle-dim grid axis becomes the in-block loop over contraction
//   stages below, so only the rows of a block's points have to fit in
//   shared memory (ops/fused_eval.py::supports_fused).
// - K3, pychebyshev_tpu/ops/pallas_dd.py::_build_kernel (near-f64 "dd"
//   evaluation through bf16 digit planes): fused_eval_kernel<double>,
//   entry fused_eval_f64.  The TPU kernel builds f64 accuracy out of
//   bf16 digit-plane GEMMs because TPU v5e has no f64; Hopper's tensor
//   cores multiply f64 natively, so the same function (within the dd
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
// [n_mid * n_rp][n_left] and zero-padded by the Python wrapper
// (ops/fused_eval.py::_pack): for f64 as [k_pad][ld], for f32 as the
// f32 kernel's stage images of T3's two TF32 planes (below).
//
// What bounds it on an H100 SXM: the contraction, 2 * prod(shape) FLOP
// per point (322 KFLOP at 11^5) against a tensor that stays in the
// 50 MB L2, so at N = 2^20 it is bound by operations, not device-memory
// bytes.
// - f64 (K3) runs on the f64 tensor cores, `mma.sync` m16n8k8 f64
//   (DMMA), 67 TFLOP/s: 5.0 ms at 11^5 (the f64 SIMT pipes, 34 TFLOP/s,
//   would give 9.9 ms).
// - f32 (K1, K2) runs on the TF32 tensor cores at 495 TFLOP/s in three
//   passes: each operand x splits into big = tf32(x) (`cvt.rna`) and
//   small = x - big (exact in f32; the tensor cores read its top 19
//   bits: rounding A's small part as well cost 1 % and moved no
//   deviation), and the product is small*big + big*small + big*big, which
//   keeps f32 accuracy where one TF32 pass keeps about three decimal
//   digits.  Bound: 3 * 2 * prod(shape) FLOP per point, 2.05 ms at 11^5
//   (2.19 ms on the padded 1,344 x 128 tiles).  Only `wgmma` reaches
//   that rate (`mma.sync` m16n8k8 reached 27 % of it).
//
// The f32 kernel (fused_eval_kernel_wgmma<C, L>), per block of 64 * C
// points (C = 2 consumer warpgroups where shared memory allows, else 1;
// L = 2 for two right-prime dims, else any count):
// - T's planes are split once, at pack time.  Each stage of the
//   contraction is 32 deep (one 128-byte row of f32) and 128 columns
//   wide; the pack holds, stage after stage, the big plane's and the
//   small plane's [128 columns][32 k] tiles, K-major with the 128-byte
//   swizzle applied (column n's 16-byte chunk c sits at c ^ (n % 8)):
//   exactly the shared-memory image `wgmma` reads.  So a stage's T is
//   one 32 KB `cp.async.bulk` copy into a ring of 2 or 3 stages, whose
//   completion lands on the stage's "full" mbarrier.
// - One producer warpgroup forms A (a thread a point; with one consumer,
//   two threads a point, each 16 of a stage's 32 k), written as 16-byte
//   stores of A's big and small values into the stage's swizzled A
//   planes; after a proxy fence each warp arrives on "full" once.  A's
//   k order is r-major (k = r * n_mid + j, the pack's rows likewise), so
//   A = rows_s[j] * the product of the right-prime rows at r: one
//   shared-memory load and one multiply a value, the product formed
//   once every n_mid values (for two right-prime dims stepped like an
//   odometer over their digits, else through a 16-bit lane table per r,
//   worked out once a block).  The TF32 split is two integer operations
//   and a subtraction.
// - Each consumer warpgroup owns 64 points x 128 columns and issues, a
//   stage, 4 k8 steps x 3 passes of `wgmma` m64n128k8 TF32 from the
//   ring; when they have finished, each of its warps arrives once on the
//   stage's "empty" mbarrier.  The producer runs up to the ring's depth
//   ahead.  The block's 384 threads start at 168 registers, and
//   setmaxnreg gives a consumer thread 224 (two 64-value accumulators)
//   and a producer thread 56.
// - The tensor cores' f32 accumulation does not round to nearest, so a
//   sum carried through thousands of products drifts (on a random 19^5
//   tensor, a 6,859-deep contraction carried whole read 3.9e-5 of scale
//   from the plain version, near the 5e-5 ceiling; 5.3e-5 in this
//   kernel).  So the products are summed on the tensor cores over one
//   stage, 32 deep, and each stage's sum is added to the running
//   accumulator in IEEE f32: 1.4e-6 there.  Chunks of four stages, one
//   stage's products kept in flight while the next stage's issue, read
//   2.1e-6, were 1-3 % faster at 11^5 and 14 % slower at 19^5, whose
//   two ring stages then come back to the producer later.
// - A column tile done, each consumer thread weights its accumulator
//   columns by w_left (from the rows), sums its two rows across the
//   four lanes that hold them, and keeps the sum in registers; after
//   the last tile it stores one value a point, with no atomics, in a
//   fixed order, so results repeat run to run.
// - What bounds it now (chip_breakdown.py at 11^5): the products alone
//   take ~3.3 ms, A formation with the copies ~4.2 ms, the copies alone
//   ~2.0 ms, and together ~5.0 ms: shared memory is the contended
//   resource.  Per stage the products read 144 KB of operands (SS
//   `wgmma`: A 2 KB and T 4 KB each), T's copy and A's stores write
//   32 KB each, and the producers read ~16 KB: ~1,790 cycles at 128
//   bytes a cycle, against the tensor cores' 1,536.  Taking A from the
//   consumers' registers (RS `wgmma`) cuts that to ~1,150, but the
//   consumers then form A between their products: every arrangement
//   tried (per-stage waits, two consumers in turns, two A buffers with
//   the running sums in shared memory) ran 5.1-5.9 ms.
// - L2 traffic: T's two planes, 1,344 x 128 x 8 bytes = 1.38 MB at
//   11^5, stream into every block once per 128 points: 11.3 GB at 2^20
//   points, 2.3 TB/s at a 5.0 ms kernel (the planes stay in L2; the
//   copies alone run at 5.6 TB/s).  The 64-point plan moves twice that
//   per point.
//
// The f64 kernel (fused_eval_kernel<double>): a block owns kBM = 128
// points and walks the n_left columns in tiles of kBN = 128, each tile
// over the whole contraction depth in stages of kBK = 16.  Eight warps,
// 2 x 4, each own a 64 x 32 accumulator tile in registers; 239
// registers a thread, one block per SM.  T tiles stream from L2 into a
// ring of kStages = 3 shared-memory stages with 16-byte cp.async, A is
// formed stage by stage into a double buffer while the MMAs run; after
// a tile's last stage each thread weights its columns by w_left, reduces
// across the fragment's lanes with shuffles into its column warp's
// partial sums in shared memory, and the four column warps' sums are
// added in a fixed order at the end.
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
constexpr int kMaxSmemBytes = 232448;
constexpr double kNodeTol = 1e-14;

struct Geometry {
  int d;        // number of dims
  int s;        // split: left dims [0, s), middle dim s, right-prime (s, d)
  int w;        // sum of the shape: width of a point's packed rows
  int ws;       // row stride of the f32 kernel's rows: w made odd
  int n_left;   // prod(shape[0:s])
  int n_rp;     // prod(shape[s+1:d]), 1 when there is no right-prime dim
  int k;        // contraction depth: shape[s] * n_rp
  int k_pad;    // k rounded up to the stage depth: T3's rows
  int ld;       // n_left rounded up to the column tile: T3's row length
  int shape[kMaxDims];
  int off[kMaxDims];     // lane offset of each dim in the packed rows
  int stride[kMaxDims];  // C-order stride of each dim inside its group
};

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }

// Normalized barycentric rows of the block's bm points, [bm][stride],
// one (point, dim) per task, and the table of the right-prime dims' row
// lanes for each of the n_rp right-prime indices r, worked out once per
// block so that the stage loops do no integer division.
template <typename T>
__device__ __forceinline__ void build_rows(
    T* rows, int stride, unsigned short* lane_tab, int bm,
    const T* __restrict__ points, const T* __restrict__ nodes,
    const T* __restrict__ weights, int n_points, const Geometry& g) {
  for (int task = threadIdx.x; task < bm * g.d; task += blockDim.x) {
    const int b = task / g.d;
    const int dim = task - b * g.d;
    const int o = g.off[dim];
    const int n = g.shape[dim];
    T* row = rows + b * stride + o;
    const long long p = static_cast<long long>(blockIdx.x) * bm + b;
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
  const int n_rp_lanes = g.d - g.s - 1;
  for (int r0 = threadIdx.x; r0 < g.n_rp; r0 += blockDim.x) {
    unsigned short* lane = lane_tab + r0 * n_rp_lanes;
    int r = r0;
    for (int m = g.s + 1; m < g.d; ++m) {
      const int digit = r / g.stride[m];
      r -= digit * g.stride[m];
      lane[m - g.s - 1] = static_cast<unsigned short>(g.off[m] + digit);
    }
  }
}

// ---------------------------------------------------------------------
// f64: mma.sync m16n8k8 f64 (K3).
// Keep these in step with ops/fused_eval.py (_BLOCK_POINTS, _COL_TILE,
// _DEPTH, _STAGES, _WARPS_N, _PAD, _smem_bytes).
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
static_assert(kBM == kBN, "A and T stages share one row stride");
static_assert(kThreads % kBK == 0 && kBM % kALanes == 0, "A mapping");
static_assert(kBK % 8 == 0, "a stage is whole m16n8k8 steps");

// Per-type plan.  kPad: row pad in values, so that the fragment loads
// (lane (g, q) reads row q, column g) hit 32 distinct banks.
// kMinBlocks: blocks per SM the registers are cut for: the f64
// accumulators alone take 128 registers a thread, so one.
template <typename T> struct Plan;
template <> struct Plan<double> {
  static constexpr int kPad = 4;
  static constexpr int kAPlanes = 1;
  static constexpr int kMinBlocks = 1;
};
template <typename T> constexpr int kStride = kBN + Plan<T>::kPad;
template <typename T> using Acc = T[kMTiles][kNTiles][4];

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

// D = A * B + D on one m16n8k8 tile; fragments as in the PTX ISA:
// lane (g, q) = (lane / 4, lane % 4) holds a = A[g][q], A[g+8][q],
// A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g]; c = C[g][2q],
// C[g][2q+1], C[g+8][2q], C[g+8][2q+1].
__device__ __forceinline__ void mma(double (&c)[4], const double (&a)[4],
                                    double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// A[k][b] into its stage buffer.
__device__ __forceinline__ void store_a(double* a, int i, double v) {
  a[i] = v;
}

// Eight contraction steps of a warp's 64 x 32 tile, straight into the
// accumulators.  `a` points at the warp's first row of the A stage
// ([kBK][S], k-major) at the first of the eight steps, `t` at its first
// column of the T stage ([kBK][S]).
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

  build_rows(rows, g.w, lane_tab, kBM, points, nodes, weights, n_points, g);
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

// ---------------------------------------------------------------------
// f32: warp-specialised 3xTF32 wgmma (K1, K2).
// Keep these in step with ops/fused_eval.py (_WG_DEPTH, _COL_TILE,
// _wg_smem_bytes, _split_planes); the plan is _wg_plan's.
constexpr int kWgBN = 128;    // columns per tile: wgmma's N
constexpr int kWgBK = 32;     // contraction steps per stage: 128 bytes
constexpr int kWgTileBytes = kWgBN * kWgBK * 4;   // one T plane, 16 KB
constexpr int kWgRowBytes = kWgBK * 4;            // a point's A row

// kC consumer warpgroups (64 points each) after one producer warpgroup,
// which forms A with 128 / (64 kC) threads a point.  With two consumers
// the block's 384 threads start at 168 registers, and setmaxnreg moves
// them to 56 a producer thread and 224 a consumer thread.  (Two producer
// warpgroups formed A faster, but at 512 threads the consumers' two
// 64-value accumulators spilled.)
template <int kC> struct WgPlan {
  static constexpr int kBM = 64 * kC;                 // points a block
  static constexpr int kThreads = 128 * (1 + kC);
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 56;
  static constexpr int kConsumerRegs =
      (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kC) / 8 * 8;
  static constexpr int kAPlaneBytes = kBM * kWgRowBytes;
  static constexpr int kStageBytes = 2 * kWgTileBytes + 2 * kAPlaneBytes;
};

// Shared memory of a plan: 1 KB to align the ring to the 128-byte
// swizzle's 1,024-byte atoms, the ring, each stage's two mbarriers, the
// rows and the lane table.
long long wg_smem_bytes(const Geometry& g, int consumers, int stages) {
  const long long bm = 64LL * consumers;
  const long long stage = 2LL * kWgTileBytes + 2 * bm * kWgRowBytes;
  return 1024 + stages * (stage + 16) + 4 * bm * g.ws +
         2LL * g.n_rp * (g.d - g.s - 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of `bar` with this parity to complete.  A wait
// that sees no progress for 2^34 cycles (about 9 s) traps, so a broken
// protocol ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > (1LL << 34)) {
      __trap();
    }
  }
}
// One bulk copy global -> shared, completing on `bar`'s transaction
// count.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Order this thread's shared-memory stores before the async proxy's
// (wgmma's) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 does, in two integer operations on the bits
// (a carry into the exponent gives the next power of two).  cvt.rna's
// extra test for infinities and NaN is left out: A's values are
// products of normalized rows, finite and far from the largest float.
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// wgmma descriptor of a K-major operand tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms 1,024 bytes apart (SBO); the leading
// offset is unused in this layout.  A k8 step inside the row adds 32
// bytes (2 in the >> 4 units) to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending)
               : "memory");
}
// Keep the compiler from moving the accumulators across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 128, f32) = A * B + (scale_d ? D : 0), A and B TF32 from
// shared memory.  Lane (g, q) of warp w holds D[16w + g + 8h][8i + 2q + e]
// at d[4i + 2h + e].
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int kC, int kL>
__global__ void __launch_bounds__(WgPlan<kC>::kThreads, 1)
fused_eval_kernel_wgmma(const float* __restrict__ points,
                        const float* __restrict__ nodes,
                        const float* __restrict__ weights,
                        const float* __restrict__ pack,
                        float* __restrict__ out, int n_points, Geometry g,
                        int n_stages) {
  using P = WgPlan<kC>;
  constexpr int kBMw = P::kBM;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + n_stages *
                                               P::kStageBytes);
  uint64_t* empty = full + n_stages;
  float* rows = reinterpret_cast<float*>(empty + n_stages);  // [kBMw][ws]
  unsigned short* lane_tab =
      reinterpret_cast<unsigned short*>(rows + kBMw * g.ws);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int n_kt = g.k_pad / kWgBK;          // stages per column tile
  const int n_ct = g.ld / kWgBN;             // column tiles
  const int n_q = n_kt * n_ct;               // stages in all
  constexpr uint32_t kCopyBytes = 2 * kWgTileBytes;

  // Barriers, then the first stages' T copies, which land while the
  // rows are built.
  if (tid == 0) {
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(&full[i], 4 + 1);        // the producer's warps + tx
      mbar_init(&empty[i], 4 * kC);      // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < n_stages && q < n_q; ++q) {
      mbar_arrive_expect_tx(&full[q], kCopyBytes);
      bulk_copy(ring + q * P::kStageBytes,
                pack + static_cast<size_t>(q) * (kCopyBytes / 4),
                kCopyBytes, &full[q]);
    }
  }
  build_rows(rows, g.ws, lane_tab, kBMw, points, nodes, weights, n_points,
             g);
  __syncthreads();

  if (tid < 128) {
    // Producer: T copies and A formation.
    if constexpr (kC == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(P::kProducerRegs));
    }
    constexpr int kTPP = 128 / kBMw;       // threads a point: 1 or 2
    constexpr int kVals = kWgBK / kTPP;    // A values a thread a stage
    const int p = tid % kBMw;
    const int part = tid / kBMw;
    const float* prow = rows + p * g.ws;
    const float* mid = prow + g.off[g.s];
    const int n_mid = g.shape[g.s];
    const int n_lanes = g.d - g.s - 1;
    const int swz = p & 7;
    // The product of the right-prime rows at r, in the plain version's
    // order (1 * rows_{s+1} * ... * rows_{d-1}); 0 past the last r, the
    // padding.  kL = 2: the two rows at the digits (ra, rb) of r.
    auto rp_weight = [&](int rr) {
      float w = rr < g.n_rp ? 1.0f : 0.0f;
      const unsigned short* lane = lane_tab + min(rr, g.n_rp - 1) * n_lanes;
      for (int m = 0; m < n_lanes; ++m) w *= prow[lane[m]];
      return w;
    };
    const float* row_a = prow + g.off[g.s + 1 < g.d ? g.s + 1 : 0];
    const float* row_b = prow + g.off[g.s + 2 < g.d ? g.s + 2 : 0];
    const int na = g.shape[g.s + 1 < g.d ? g.s + 1 : 0];
    const int nb = g.shape[g.s + 2 < g.d ? g.s + 2 : 0];
    int ra = 0, rb = 0;     // kL = 2: the digits of r + 1
    auto rp2 = [&]() {
      return ra < na ? row_a[min(ra, na - 1)] * row_b[rb] : 0.0f;
    };
    int slot = 0;
    uint32_t phase = 0;
    int j = 0, r = 0;       // this thread's next k = r * n_mid + j
    float w = 0.0f, wn = 0.0f;  // the products at r and r + 1
    auto step = [&]() {     // r -> r + 1
      ++r;
      w = wn;
      if constexpr (kL == 2) {
        if (++rb == nb) {
          rb = 0;
          ++ra;
        }
        wn = rp2();
      } else {
        wn = rp_weight(r + 1);
      }
    };
    for (int q = 0, kt = 0; q < n_q; ++q) {
      mbar_wait(&empty[slot], phase ^ 1);
      unsigned char* st = ring + slot * P::kStageBytes;
      if (tid == 0 && q >= n_stages) {
        mbar_arrive_expect_tx(&full[slot], kCopyBytes);
        bulk_copy(st, pack + static_cast<size_t>(q) * (kCopyBytes / 4),
                  kCopyBytes, &full[slot]);
      }
      if (kt == 0) {
        r = part * kVals / n_mid;
        j = part * kVals - r * n_mid;
        if constexpr (kL == 2) {
          ra = r / nb;
          rb = r - ra * nb;
          w = rp2();
          if (++rb == nb) {
            rb = 0;
            ++ra;
          }
          wn = rp2();
        } else {
          w = rp_weight(r);
          wn = rp_weight(r + 1);
        }
      }
      // A = rows_s[j] * (the product at r): one load and one multiply a
      // value, the product formed once every n_mid values.
      float4* big = reinterpret_cast<float4*>(st + 2 * kWgTileBytes) + p * 8;
      float4* small = reinterpret_cast<float4*>(
          st + 2 * kWgTileBytes + P::kAPlaneBytes) + p * 8;
#pragma unroll 2
      for (int c4 = 0; c4 < kVals / 4; ++c4) {
        float v[4];
        if (n_mid >= 4) {   // at most one step of r in four values
          const int left = n_mid - j;   // values before the step
          const float* here = mid + j;
          const float* next = here - n_mid;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool now = e < left;
            v[e] = *((now ? here : next) + e) * (now ? w : wn);
          }
          j += 4;
          if (j >= n_mid) {
            j -= n_mid;
            step();
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[e] = mid[j] * w;
            if (++j == n_mid) {
              j = 0;
              step();
            }
          }
        }
        float4 b, s;
        b.x = tf32_big(v[0]);
        b.y = tf32_big(v[1]);
        b.z = tf32_big(v[2]);
        b.w = tf32_big(v[3]);
        s.x = v[0] - b.x;
        s.y = v[1] - b.y;
        s.z = v[2] - b.z;
        s.w = v[3] - b.w;
        const int chunk = (part * (kVals / 4) + c4) ^ swz;
        big[chunk] = b;
        small[chunk] = s;
      }
      if (kTPP == 2) {   // skip the other thread's half of the stage
        for (j += kWgBK - kVals; j >= n_mid; j -= n_mid) step();
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[slot]);
      if (++kt == n_kt) kt = 0;
      if (++slot == n_stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  } else {
    // Consumer warpgroup c: points 64c .. 64c + 63, all 128 columns.
    if constexpr (kC == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(P::kConsumerRegs));
    }
    const int c = tid / 128 - 1;
    const int w4 = (tid / 32) % 4;
    const int g8 = (tid % 32) / 4;
    const int q4 = tid % 4;
    const int p0 = 64 * c + 16 * w4 + g8;    // this thread's two points
    const float* row0 = rows + p0 * g.ws;
    const float* row1 = row0 + 8 * g.ws;
    float acc[64], run[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = run[i] = 0.0f;
    float total0 = 0.0f, total1 = 0.0f;
    const uint32_t ring_addr = smem_u32(ring);
    const uint32_t a_off = 2 * kWgTileBytes + c * 64 * kWgRowBytes;
    int slot = 0;
    uint32_t phase = 0;
    for (int ct = 0; ct < n_ct; ++ct) {
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&full[slot], phase);
        const uint32_t st = ring_addr + slot * P::kStageBytes;
        const uint64_t tb = sw128_desc(st);
        const uint64_t ts = sw128_desc(st + kWgTileBytes);
        const uint64_t ab = sw128_desc(st + a_off);
        const uint64_t as = sw128_desc(st + a_off + P::kAPlaneBytes);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_tf32(acc, as + 2 * kk, tb + 2 * kk, kk != 0);
          wgmma_tf32(acc, ab + 2 * kk, ts + 2 * kk, 1);
          wgmma_tf32(acc, ab + 2 * kk, tb + 2 * kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(&empty[slot]);
        if (++slot == n_stages) {
          slot = 0;
          phase ^= 1;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) run[i] += acc[i];
      }

      // Column tile ct done: weight its columns by w_left, in the plain
      // version's order (1 * rows_0 * ... * rows_{s-1}), and sum each of
      // the two rows over the four lanes that hold its columns.
      float part0 = 0.0f, part1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int l = ct * kWgBN + 8 * i + 2 * q4 + e;
          if (l < g.n_left) {
            float w0 = 1.0f, w1 = 1.0f;
            int rem = l;
            for (int m = 0; m < g.s; ++m) {
              const int digit = rem / g.stride[m];
              rem -= digit * g.stride[m];
              w0 *= row0[g.off[m] + digit];
              w1 *= row1[g.off[m] + digit];
            }
            part0 += w0 * run[4 * i + e];
            part1 += w1 * run[4 * i + 2 + e];
          }
        }
      }
      part0 += __shfl_xor_sync(0xffffffffu, part0, 1);
      part0 += __shfl_xor_sync(0xffffffffu, part0, 2);
      part1 += __shfl_xor_sync(0xffffffffu, part1, 1);
      part1 += __shfl_xor_sync(0xffffffffu, part1, 2);
      total0 += part0;
      total1 += part1;
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = 0.0f;
    }
    const long long p = static_cast<long long>(blockIdx.x) * kBMw + p0;
    if (q4 == 0 && p < n_points) out[p] = total0;
    if (q4 == 0 && p + 8 < n_points) out[p + 8] = total1;
  }
}

// The geometry of `shape` split at `s`, with T3 padded to `depth` rows
// and `cols` columns.  Returns a cudaError_t (0 on success).
int make_geometry(Geometry& g, int d, const void* shape, int s, int depth,
                  int cols) {
  if (d < 3 || d > kMaxDims || s < 1 || s >= d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* dims = static_cast<const int*>(shape);
  g.d = d;
  g.s = s;
  g.w = 0;
  for (int k = 0; k < d; ++k) {
    if (dims[k] < 1) return static_cast<int>(cudaErrorInvalidValue);
    g.shape[k] = dims[k];
    g.off[k] = g.w;
    g.w += dims[k];
  }
  g.ws = g.w | 1;
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
  g.k_pad = (g.k + depth - 1) / depth * depth;
  g.ld = (g.n_left + cols - 1) / cols * cols;
  // The f64 stage loop addresses t3 with 32-bit offsets; the f32 pack
  // (addressed in 64 bits) keeps the same cap on its depth x width.
  const long long k16 = (g.k + kBK - 1) / kBK * kBK;
  if (k16 * g.ld >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Validate the geometry, set the shared-memory limit and launch the
// f64 kernel on `stream`.  Returns a cudaError_t (0 on success).
int launch_f64(const void* points, const void* nodes, const void* weights,
               const void* t3, void* out, int n_points, int d,
               const void* shape, int s, void* stream) {
  using T = double;
  Geometry g;
  const int err0 = make_geometry(g, d, shape, s, kBK, kBN);
  if (err0 != 0 || n_points < 0) {
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

template <int kC, int kL>
int launch_wgmma(const Geometry& g, int stages, long long smem,
                 const void* points, const void* nodes, const void* weights,
                 const void* pack, void* out, int n_points, void* stream) {
  auto kernel = fused_eval_kernel_wgmma<kC, kL>;
  if constexpr (kC == 2) {
    // setmaxnreg moves registers between the warpgroups of a block: the
    // consumers' increase waits for the producer's release, which only
    // balances if the block starts with kLaunchRegs a thread.
    static const int regs = [&] {
      cudaFuncAttributes attr;
      return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess
                 ? attr.numRegs : -1;
    }();
    if (regs != WgPlan<kC>::kLaunchRegs) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_points + WgPlan<kC>::kBM - 1) / WgPlan<kC>::kBM;
  kernel<<<blocks, WgPlan<kC>::kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(nodes),
      static_cast<const float*>(weights), static_cast<const float*>(pack),
      static_cast<float*>(out), n_points, g, stages);
  return static_cast<int>(cudaGetLastError());
}

// Check the f32 plan (consumer warpgroups, ring stages) that the
// wrapper chose from the shape, then launch it on `stream`.
int launch_f32(const void* points, const void* nodes, const void* weights,
               const void* pack, void* out, int n_points, int d,
               const void* shape, int s, int consumers, int stages,
               void* stream) {
  Geometry g;
  const int err0 = make_geometry(g, d, shape, s, kWgBK, kWgBN);
  if (err0 != 0 || n_points < 0 || consumers < 1 || consumers > 2 ||
      stages < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = wg_smem_bytes(g, consumers, stages);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return static_cast<int>(cudaSuccess);
  // Two right-prime dims (11^5, 15^5 to 19^5, 9^6) take the kernel that
  // steps their product like an odometer; any other count the lane
  // table's product.
  const bool two = d - s - 1 == 2;
  if (consumers == 1) {
    return launch_wgmma<1, -1>(g, stages, smem, points, nodes, weights,
                               pack, out, n_points, stream);
  }
  return two ? launch_wgmma<2, 2>(g, stages, smem, points, nodes, weights,
                                  pack, out, n_points, stream)
             : launch_wgmma<2, -1>(g, stages, smem, points, nodes, weights,
                                   pack, out, n_points, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`.  `shape` is a host array of d ints; `s` the split
// index; `pack` the f32 stage images of ops/fused_eval.py::_pack;
// `consumers` and `stages` the plan of ops/fused_eval.py::_wg_plan.
// Returns a cudaError_t (0 on success); the launch is checked with
// cudaGetLastError, and nothing is synchronized.
int fused_eval_f32(const void* points, const void* nodes,
                   const void* weights, const void* pack, void* out,
                   int n_points, int d, const void* shape, int s,
                   int consumers, int stages, void* stream) {
  return launch_f32(points, nodes, weights, pack, out, n_points, d, shape,
                    s, consumers, stages, stream);
}

// The same for f64 operands; `t3` the padded [k_pad][ld] f64 pack.
int fused_eval_f64(const void* points, const void* nodes,
                   const void* weights, const void* t3, void* out,
                   int n_points, int d, const void* shape, int s,
                   void* stream) {
  return launch_f64(points, nodes, weights, t3, out, n_points, d, shape,
                    s, stream);
}

const char* fused_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused batched barycentric evaluation of a dense Chebyshev tensor, in
// f32 and in f64: one kernel body, templated on the scalar type.
//
// Replaces three Pallas TPU kernels:
// - K1, pychebyshev_tpu/ops/pallas_eval.py::_build_kernel (one-level
//   f32 variant): the float instantiation, entry fused_eval_f32.
// - K2, pychebyshev_tpu/ops/pallas_eval.py::_build_stream_kernel (the
//   two-level f32 variant for grids whose one-tile VMEM working set does
//   not fit: 15^5..19^5, 9^6): the same float instantiation.  K2's
//   sequential middle-dim grid axis becomes the in-block loop over k0
//   below, which walks the whole (middle x right-prime) contraction depth
//   in shared-memory stages, so only the rows and the right-prime factor
//   have to fit in shared memory (ops/fused_eval.py::supports_fused).
// - K3, pychebyshev_tpu/ops/pallas_dd.py::_build_kernel (near-f64 "dd"
//   evaluation through bf16 digit planes): the double instantiation,
//   entry fused_eval_f64.  The TPU kernel builds f64 accuracy out of
//   bf16 digit-plane GEMMs because TPU v5e has no f64; Hopper has IEEE
//   f64 FMA, so the same function (within the dd contract's 1e-10 of true
//   f64, in fact to f64 rounding) is computed natively.  It is a template
//   instance rather than a file of its own because the f64 tile differs
//   only in its points per block: 32 instead of 64, so that 11^5 and
//   every K2 grid fit the 227 KB of shared memory at 8 bytes a value.
//
// All three are written for Hopper rather than carried over block by
// block: no bf16 splits, no 0/1 selection dots, no 128-lane padding, no
// digit planes.  All arithmetic is IEEE FMA in the instance's type with
// accumulation in that type (no TF32).
//
// What it computes, per point x (d >= 3 dims, split at s by
// ops/eval.py::_split_index into left dims [0, s), the middle dim s and
// the right-prime dims (s, d)):
//   rows_k  = (w / (x_k - nodes)) / sum(...)    one-hot at an exact node
//   w_left  = rows_0 (x) ... (x) rows_{s-1}      Khatri-Rao, (n_left,)
//   w_rp    = rows_{s+1} (x) ... (x) rows_{d-1}  Khatri-Rao, (n_rp,)
//   out     = sum_l w_left[l] * sum_{j,r} rows_s[j] * w_rp[r] * T3[j][r][l]
// T3 is the (derivative-applied) value tensor re-laid out as
// [n_mid][n_rp][n_left] by the Python wrapper (ops/fused_eval.py).
//
// What bounds it on an H100: at 11^5 the contraction is
// 2 * 11^5 = 322 KFLOP of FMA per point against a 644 KB (f32) or
// 1.3 MB (f64) tensor that stays resident in the 50 MB L2, so at
// N = 2^20 the kernel is compute-bound: 337.8 GFLOP against 25 MB (f32)
// or 50 MB (f64) of points in and values out.  f32 runs on the SIMT f32
// pipes (67 TFLOP/s peak on the SXM part: 5.0 ms); f64 on the SIMT f64
// pipes (34 TFLOP/s: 9.9 ms; the f64 tensor cores' 67 TFLOP/s would
// give 5.0 ms).  The design keeps every per-point intermediate (rows,
// Khatri-Rao factors, the partial products) in shared memory and
// registers, so device memory sees only the points in and one value out
// per point.  One block owns kPoints points (64 f32, 32 f64); 4*kPoints
// threads each hold a 4-point x 8-column register tile of the
// (kPoints x n_left) product, fed from shared-memory stages of 16
// contraction steps.  Moving the contraction onto the tensor cores
// (wgmma with a 3xTF32 split for f32, DMMA or an int8 Ozaki digit scheme
// for f64) is the next step, not done here.
//
// Exact nodes follow the reference semantics (ops/eval.py): a coordinate
// within 1e-14 of a node takes the one-hot row at the first such node.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_eval.so fused_eval.cu
// The plain C entry points below are bound with ctypes
// (ops/fused_eval.py for f32, ops/fused_dd.py for f64).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 16;
// Keep these in step with ops/fused_eval.py::_smem_bytes.  Points per
// block are a template argument: 64 for f32, 32 for f64; a block has
// 4 * kPoints threads, (kPoints / 4) x 16, each owning 4 points x 8
// columns.
constexpr int kColTile = 128;   // left-index columns per pass
constexpr int kDepth = 16;      // contraction steps per shared stage
constexpr int kMaxSmemBytes = 232448;
constexpr double kNodeTol = 1e-14;

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// Four consecutive values from shared memory in 16-byte loads.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

struct Geometry {
  int d;        // number of dims
  int s;        // split: left dims [0, s), middle dim s, right-prime (s, d)
  int w;        // sum of the shape: width of a point's packed rows
  int n_left;   // prod(shape[0:s])
  int n_rp;     // prod(shape[s+1:d]), 1 when there is no right-prime dim
  int k;        // contraction depth: shape[s] * n_rp
  int shape[kMaxDims];
  int off[kMaxDims];     // lane offset of each dim in the packed rows
  int stride[kMaxDims];  // C-order stride of each dim inside its group
};

template <typename T, int kPoints>
__global__ void __launch_bounds__(4 * kPoints)
fused_eval_kernel(const T* __restrict__ points,
                  const T* __restrict__ nodes,
                  const T* __restrict__ weights,
                  const T* __restrict__ t3,
                  T* __restrict__ out, int n_points, Geometry g) {
  constexpr int kThreads = 4 * kPoints;
  extern __shared__ double2 smem16[];  // 16-byte aligned
  T* rows = reinterpret_cast<T*>(smem16);  // [kPoints][w]
  T* wrp = rows + kPoints * g.w;           // [kPoints][n_rp]
  T* a_tile = wrp + kPoints * g.n_rp;      // [kDepth][kPoints]
  T* t_tile = a_tile + kDepth * kPoints;   // [kDepth][kColTile]

  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kPoints;

  // Stage 1: normalized barycentric rows, one (point, dim) per task.
  for (int task = tid; task < kPoints * g.d; task += kThreads) {
    const int b = task / g.d;
    const int dim = task - b * g.d;
    const int o = g.off[dim];
    const int n = g.shape[dim];
    T* row = rows + b * g.w + o;
    const long long p = first + b;
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
  __syncthreads();

  // Stage 2: right-prime Khatri-Rao factor, dims multiplied in order.
  for (int task = tid; task < kPoints * g.n_rp; task += kThreads) {
    const int b = task / g.n_rp;
    const int r = task - b * g.n_rp;
    const T* row = rows + b * g.w;
    T prod = T(1);
    for (int k = g.s + 1; k < g.d; ++k) {
      prod *= row[g.off[k] + (r / g.stride[k]) % g.shape[k]];
    }
    wrp[task] = prod;
  }

  // Stage 3: acc[b][l] = sum_{j,r} c_j[b] * w_rp[b][r] * T3[j][r][l],
  // then out[b] = sum_l w_left[b][l] * acc[b][l].
  const int ty = tid / 16;  // points 4*ty .. 4*ty+3
  const int tx = tid % 16;  // columns 4*tx .. +3 and 64+4*tx .. +3
  const int mid_off = g.off[g.s];
  T part[4] = {T(0), T(0), T(0), T(0)};

  for (int lt = 0; lt < g.n_left; lt += kColTile) {
    T acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = T(0);
    }

    for (int k0 = 0; k0 < g.k; k0 += kDepth) {
      __syncthreads();  // rows/wrp written; previous stage consumed
      for (int e = tid; e < kDepth * kPoints; e += kThreads) {
        const int kk = e / kPoints;
        const int b = e - kk * kPoints;
        const int k = k0 + kk;
        T a = T(0);
        if (k < g.k) {
          const int j = k / g.n_rp;
          const int r = k - j * g.n_rp;
          a = rows[b * g.w + mid_off + j] * wrp[b * g.n_rp + r];
        }
        a_tile[e] = a;
      }
      for (int e = tid; e < kDepth * kColTile; e += kThreads) {
        const int kk = e / kColTile;
        const int l = lt + (e - kk * kColTile);
        const int k = k0 + kk;
        t_tile[e] = (k < g.k && l < g.n_left)
                        ? t3[static_cast<long long>(k) * g.n_left + l]
                        : T(0);
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        T av[4];
        T tv[8];
        load4(a_tile + kk * kPoints + ty * 4, av);
        load4(t_tile + kk * kColTile + tx * 4, tv);
        load4(t_tile + kk * kColTile + 64 + tx * 4, tv + 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fma_t(av[i], tv[c], acc[i][c]);
        }
      }
    }

    // Epilogue: weight this column tile by the left Khatri-Rao factor.
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int l = lt + (c < 4 ? tx * 4 + c : 64 + tx * 4 + (c - 4));
      if (l >= g.n_left) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T* row = rows + (ty * 4 + i) * g.w;
        T wl = T(1);
        for (int k = 0; k < g.s; ++k) {
          wl *= row[g.off[k] + (l / g.stride[k]) % g.shape[k]];
        }
        part[i] = fma_t(wl, acc[i][c], part[i]);
      }
    }
  }

  // The 16 threads of one ty hold the column partials of the same points.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T v = part[i];
    for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    const long long p = first + ty * 4 + i;
    if (tx == 0 && p < n_points) out[p] = v;
  }
}

// Validate the geometry, set the shared-memory limit and launch on
// `stream`.  Returns a cudaError_t (0 on success).
template <typename T, int kPoints>
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

  const long long smem =
      static_cast<long long>(sizeof(T)) *
      (static_cast<long long>(kPoints) * (g.w + g.n_rp) +
       kDepth * (kPoints + kColTile));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return static_cast<int>(cudaSuccess);

  cudaError_t err = cudaFuncSetAttribute(
      fused_eval_kernel<T, kPoints>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_points + kPoints - 1) / kPoints;
  fused_eval_kernel<T, kPoints><<<blocks, 4 * kPoints,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(points), static_cast<const T*>(nodes),
      static_cast<const T*>(weights), static_cast<const T*>(t3),
      static_cast<T*>(out), n_points, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  `shape` is a host array of d ints; `s` the split
// index.  Returns a cudaError_t (0 on success); the launch is checked
// with cudaGetLastError, and nothing is synchronized.
int fused_eval_f32(const void* points, const void* nodes,
                   const void* weights, const void* t3, void* out,
                   int n_points, int d, const void* shape, int s,
                   void* stream) {
  return launch<float, 64>(points, nodes, weights, t3, out, n_points, d,
                           shape, s, stream);
}

// The same for f64 operands (32 points per block).
int fused_eval_f64(const void* points, const void* nodes,
                   const void* weights, const void* t3, void* out,
                   int n_points, int d, const void* shape, int s,
                   void* stream) {
  return launch<double, 32>(points, nodes, weights, t3, out, n_points, d,
                            shape, s, stream);
}

const char* fused_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Fused f32 batched barycentric evaluation of a dense Chebyshev tensor.
//
// Replaces the Pallas TPU kernel K1,
// pychebyshev_tpu/ops/pallas_eval.py::_build_kernel (one-level variant).
// It computes the same function, written for Hopper rather than carried
// over block by block: no bf16 splits, no 0/1 selection dots, no
// 128-lane padding.  All arithmetic is IEEE f32 FMA with f32
// accumulation (no TF32).
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
// 2 * 11^5 = 322 KFLOP of f32 FMA per point against a 644 KB tensor that
// stays resident in the 50 MB L2, so the kernel is compute-bound on the
// SIMT f32 pipes (67 TFLOP/s peak on the SXM part).  The design keeps
// every per-point intermediate (rows, Khatri-Rao factors, the partial
// products) in shared memory and registers, so device memory sees only
// the points in and one float out per point.  One block owns 64 points;
// 256 threads each hold a 4-point x 8-column register tile of the
// (64 x n_left) product, fed from shared-memory stages of 16 contraction
// steps.  Moving the contraction onto the tensor cores (wgmma with a
// 3xTF32 split to hold f32 accuracy) is the next step, not done here.
//
// Exact nodes follow the reference semantics (ops/eval.py): a coordinate
// within 1e-14 of a node takes the one-hot row at the first such node.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_eval.so fused_eval.cu
// The plain C entry points below are bound with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 16;
// Keep these four in step with ops/fused_eval.py::_smem_bytes.
constexpr int kPoints = 64;     // points per block
constexpr int kColTile = 128;   // left-index columns per pass
constexpr int kDepth = 16;      // contraction steps per shared stage
constexpr int kThreads = 256;   // 16 x 16: 4 points x 8 columns each
constexpr int kMaxSmemBytes = 232448;
constexpr float kNodeTol = 1e-14f;

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

__global__ void __launch_bounds__(kThreads)
fused_eval_kernel(const float* __restrict__ points,
                  const float* __restrict__ nodes,
                  const float* __restrict__ weights,
                  const float* __restrict__ t3,
                  float* __restrict__ out, int n_points, Geometry g) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);  // [kPoints][w]
  float* wrp = rows + kPoints * g.w;              // [kPoints][n_rp]
  float* a_tile = wrp + kPoints * g.n_rp;         // [kDepth][kPoints]
  float* t_tile = a_tile + kDepth * kPoints;      // [kDepth][kColTile]

  const int tid = threadIdx.x;
  const long long first = static_cast<long long>(blockIdx.x) * kPoints;

  // Stage 1: normalized barycentric rows, one (point, dim) per task.
  for (int task = tid; task < kPoints * g.d; task += kThreads) {
    const int b = task / g.d;
    const int dim = task - b * g.d;
    const int o = g.off[dim];
    const int n = g.shape[dim];
    float* row = rows + b * g.w + o;
    const long long p = first + b;
    if (p >= n_points) {  // ragged last tile: zero rows, no output
      for (int i = 0; i < n; ++i) row[i] = 0.f;
      continue;
    }
    const float x = points[p * g.d + dim];
    int hit = -1;
    for (int i = 0; i < n; ++i) {
      if (hit < 0 && fabsf(x - nodes[o + i]) < kNodeTol) hit = i;
    }
    if (hit >= 0) {
      for (int i = 0; i < n; ++i) row[i] = (i == hit) ? 1.f : 0.f;
      continue;
    }
    float sum = 0.f;
    for (int i = 0; i < n; ++i) {
      const float v = weights[o + i] / (x - nodes[o + i]);
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
    const float* row = rows + b * g.w;
    float prod = 1.f;
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
  float part[4] = {0.f, 0.f, 0.f, 0.f};

  for (int lt = 0; lt < g.n_left; lt += kColTile) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    }

    for (int k0 = 0; k0 < g.k; k0 += kDepth) {
      __syncthreads();  // rows/wrp written; previous stage consumed
      for (int e = tid; e < kDepth * kPoints; e += kThreads) {
        const int kk = e / kPoints;
        const int b = e - kk * kPoints;
        const int k = k0 + kk;
        float a = 0.f;
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
                        : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(a_tile + kk * kPoints + ty * 4);
        const float4 t0 =
            *reinterpret_cast<const float4*>(t_tile + kk * kColTile + tx * 4);
        const float4 t1 = *reinterpret_cast<const float4*>(
            t_tile + kk * kColTile + 64 + tx * 4);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float tv[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], tv[c], acc[i][c]);
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
        const float* row = rows + (ty * 4 + i) * g.w;
        float wl = 1.f;
        for (int k = 0; k < g.s; ++k) {
          wl *= row[g.off[k] + (l / g.stride[k]) % g.shape[k]];
        }
        part[i] = fmaf(wl, acc[i][c], part[i]);
      }
    }
  }

  // The 16 threads of one ty hold the column partials of the same points.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float v = part[i];
    for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    const long long p = first + ty * 4 + i;
    if (tx == 0 && p < n_points) out[p] = v;
  }
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
      static_cast<long long>(sizeof(float)) *
      (static_cast<long long>(kPoints) * (g.w + g.n_rp) +
       kDepth * (kPoints + kColTile));
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return static_cast<int>(cudaSuccess);

  cudaError_t err = cudaFuncSetAttribute(
      fused_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_points + kPoints - 1) / kPoints;
  fused_eval_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(nodes),
      static_cast<const float*>(weights), static_cast<const float*>(t3),
      static_cast<float*>(out), n_points, g);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

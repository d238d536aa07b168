// Fused batched evaluation of a tensor train (TT) of Chebyshev
// coefficient cores on Hopper's tensor cores, in f32 (3xTF32).
//
// Replaces no Pallas kernel.  The JAX package runs the TT chain in XLA
// (pychebyshev_tpu/ops/tt_eval.py), and the port first ran it as plain
// PyTorch (ops/tt_eval.py): per core a GEMM, a product and a sum, and a
// stack of the Chebyshev rows, about 160 launches for five cores, each
// stage writing and reading an (N, n * r) intermediate in device memory.
// That chain is bound by those intermediates' bytes, not by its FLOP.
// This kernel was added to keep every intermediate on chip: device
// memory sees the points in, one value out per point, and the cores,
// read once a block.
//
// What it computes, per point x, for d cores G_s of shape
// (r_s, n_s, r_{s+1}) with r_0 = r_d = 1 and [lo_s, hi_s] the domain:
//   u_s           = 2 (x_s - lo_s) * inv_s - 1,  inv_s = 1 / (hi_s - lo_s)
//   Q_s[j]        = T_j(u_s), by the three-term recurrence
//   row_0         = [1]
//   row_{s+1}[c]  = sum_{j, i} row_s[i] * Q_s[j] * G_s[i, j, c]
//   out           = row_d[0]
// Each stage is a GEMM with M = points, K = n_s * r8_s (k = j * r8_s + i,
// r8 the rank rounded up to 8) and N = r8_{s+1}, whose A operand is the
// Khatri-Rao row A[p, k] = row_s[p, i] * Q_s[p, j], formed in registers
// as it is loaded.  Padding rows and columns are zero, so they add exact
// zeros.
//
// What bounds it on an H100 SXM: the contraction, 2 * sum_s r_s n_s
// r_{s+1} FLOP a point (46,882 for the 11^5 Black-Scholes train of ranks
// 1, 11, 25, 54, 9, 1), against 24 bytes of points and result a point,
// so operations, not bytes.  It runs on the TF32 tensor cores,
// `mma.sync` m16n8k8, in three passes as K1 (csrc/fused_eval.cu) does:
// each operand x splits into big = tf32(x) and small = tf32(x - big)
// (`cvt.rna`), the product is small*big + big*small + big*big, each k8
// step's three MMAs sum from zero and are added to the running sum in
// IEEE f32.  Bound: 3 x 2 x the padded K x N products a point at 495
// TFLOP/s.
//
// The design:
// - Every warp carries its own 32 points (two m16 tiles) through all d
//   stages; no barrier after the cores are staged.  Blocks are
//   persistent, one per SM, and walk tiles of 8 x 32 points, so the
//   cores are staged once a block.
// - The running row never leaves registers.  A stage's output columns
//   are permuted within each 8-column tile (physical column c holds
//   logical column (c >> 1) + 4 (c & 1)), so a lane's accumulator
//   fragment of stage s (columns 2q, 2q+1 of rows g, g+8) holds exactly
//   the entries (q, q + 4 of rows g, g+8) that its A fragment of stage
//   s+1 reads: the next stage's A is the accumulators times Q, with no
//   shuffle and no shared memory.  The accumulators and the row are
//   indexed at compile time (ranks up to 64, eight tiles of 8, with
//   warp-uniform guards), so both stay in registers.
// - Each stage is compiled for its count of right-rank tiles (1 to 8),
//   so a k8 step's MMA chains for all its tiles sit in one basic block
//   and overlap; the tensor cores' MMA rate is then what bounds it.
// - A rank tile that holds one real row or column is 7/8 padding as an
//   MMA step (ranks 1, 9, 25 of the Black-Scholes train: 209 of its 594
//   tile steps): such a tile's terms are summed in f32 FMAs instead,
//   from the same values and the same pack.  A one-column tile of the
//   right rank (r % 8 == 1) is summed by each lane over its rows and
//   joined across the four lanes of a row with shuffles; a one-row
//   tile of the left rank adds its row to the columns each lane holds.
// - Q_s[j] advances by the recurrence as the stage's j loop does, two
//   values a point in registers, in the plain version's order
//   (2u * T_{j-1} - T_{j-2}, two roundings, no FMA).
// - All cores sit in shared memory as one f32 plane in the order the B
//   fragments are read (each lane's two values side by side, one
//   conflict-free 8-byte load a lane), split into big and small as they
//   are loaded.  At the Black-Scholes train's ranks that plane is
//   38,016 floats (152 KB); ops/fused_tt.py::supports_fused_tt refuses a
//   train whose plane does not fit 227 KB.
//
// Ragged N: points past n_points read x = lo and store nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libfused_tt.so fused_tt.cu
// The plain C entry point below is bound with ctypes (ops/fused_tt.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Keep these in step with ops/fused_tt.py (_MAX_CORES, _TILE,
// _MAX_RANK, _FRAG, _MAX_SMEM_BYTES, _MAX_POINTS, _plan).
constexpr int kMaxCores = 16;
constexpr int kTile = 8;                 // ranks pad to multiples of 8
constexpr int kMaxTiles = 8;             // ranks up to 64
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;               // m16 tiles a warp
constexpr int kWarpPoints = 16 * kMTiles;
constexpr int kFrag = 2 * 32;            // floats of one k8 x n8 B fragment
constexpr int kMaxSmemBytes = 232448;

struct Geometry {
  int d;                 // cores
  int n[kMaxCores];      // nodes of each core
  int tl[kMaxCores];     // 8-wide tiles of each core's left rank
  int tr[kMaxCores];     // ... and of its right rank
  int off[kMaxCores];    // the core's first float in the pack
  int tail[kMaxCores];   // 1 where the right rank's last tile has one column
  int ltail[kMaxCores];  // 1 where the left rank's last tile has one row
  int floats;            // floats in the pack, a multiple of kFrag
};

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

using Frags = float[kMTiles][kMaxTiles][4];

__device__ __forceinline__ int lane_q() { return threadIdx.x % 4; }

// One stage of a warp's 32 points, with TR tiles of right rank known at
// compile time, so that the MMA chains of a k8 step's TR x kMTiles tiles
// sit in one basic block and overlap.  The k8 steps run tile t of the
// left rank outer, the node j inner.  `row` holds the stage's input
// (the previous stage's accumulators), `acc` gets its output; `b`
// points at this lane's first fragment value of the core, `u` at the
// lane's scaled coordinates.
template <int TR, bool kTail>
__device__ __forceinline__ void stage(const Frags& row, Frags& acc,
                                      const float2* b, int tl, int ltail,
                                      int n, const float (&u)[kMTiles][2]) {
  // With kTail the last tile holds one column (logical 8 (TR - 1),
  // physical column 0): an n8 MMA tile would be 7/8 padding, so lane
  // (g, q) sums that column's terms of its two rows in f32 FMAs instead,
  // from the same A values and the same pack (the fragment of lane q
  // holds G[8t + q, j, c] and G[8t + q + 4, j, c]), and the four q lanes'
  // sums are joined at the end.
  constexpr int kMmaTiles = TR - (kTail ? 1 : 0);
  float tail[kMTiles][2] = {};
#pragma unroll
  for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][t][e] = 0.0f;
    }
  }
  const int j_step = tl * TR * 32;   // float2s from (j, t) to (j + 1, t)
#pragma unroll
  for (int t = 0; t < kMaxTiles; ++t) {
    if (t >= tl - ltail) break;
    // Q = T_j by 2u T_{j-1} - T_{j-2}, started from T_0 = 1 and
    // T_{-1} = T_1 = u, which gives T_1 = 2u - u = u exactly.
    float q_cur[kMTiles][2], q_prev[kMTiles][2];
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        q_cur[mi][h] = 1.0f;
        q_prev[mi][h] = u[mi][h];
      }
    }
    const float2* bt = b + t * TR * 32;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      // A fragments of this (j, t) k8 step: row times Q, split.
      uint32_t ab[kMTiles][4], as[kMTiles][4];
      // The tail column's fragment values of lane q (`bt` is offset by
      // this lane).
      const float2 vt = kTail ? bt[(TR - 1) * 32 - threadIdx.x % 32 + lane_q()]
                              : float2{};
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        // __fmul_rn: no FMA may fold the product into the split.
        const float a[4] = {__fmul_rn(row[mi][t][0], q_cur[mi][0]),
                            __fmul_rn(row[mi][t][2], q_cur[mi][1]),
                            __fmul_rn(row[mi][t][1], q_cur[mi][0]),
                            __fmul_rn(row[mi][t][3], q_cur[mi][1])};
        if (kTail) {
          tail[mi][0] = fmaf(a[2], vt.y, fmaf(a[0], vt.x, tail[mi][0]));
          tail[mi][1] = fmaf(a[3], vt.y, fmaf(a[1], vt.x, tail[mi][1]));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kMmaTiles > 0) {
            ab[mi][e] = tf32(a[e]);
            as[mi][e] = tf32(a[e] - __uint_as_float(ab[mi][e]));
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kMmaTiles; ++nt) {
        const float2 v = bt[nt * 32];
        const uint32_t bb0 = tf32(v.x);
        const uint32_t bb1 = tf32(v.y);
        const uint32_t bs0 = tf32(v.x - __uint_as_float(bb0));
        const uint32_t bs1 = tf32(v.y - __uint_as_float(bb1));
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
          float sum[4];
          mma0(sum, as[mi], bb0, bb1);
          mma(sum, ab[mi], bs0, bs1);
          mma(sum, ab[mi], bb0, bb1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nt][e] += sum[e];
        }
      }
      bt += j_step;
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float next = __fsub_rn(
              __fmul_rn(2.0f * u[mi][h], q_cur[mi][h]), q_prev[mi][h]);
          q_prev[mi][h] = q_cur[mi][h];
          q_cur[mi][h] = next;
        }
      }
    }
  }
  if (ltail) {
    // The left rank's last tile t holds one row, i = 8t (lane q = 0,
    // slots 0 and 2): a k8 MMA step would be 7/8 padding, so each lane
    // adds that row's terms to the columns it holds, 2q and 2q + 1 of
    // each tile, in f32 FMAs.  The row's value comes from lane (g, 0);
    // the pack's fragment lanes (2q, 0) and (2q + 1, 0) hold the
    // columns' values G[8t, j, c] (their first value).
    const int t = tl - 1;
    const int q = lane_q();
    float r0[kMTiles][2], q_cur[kMTiles][2], q_prev[kMTiles][2];
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = 0.0f;
#pragma unroll
        for (int tt = 0; tt < kMaxTiles; ++tt) {
          if (tt == t) v = row[mi][tt][2 * h];
        }
        r0[mi][h] = __shfl_sync(0xffffffffu, v, threadIdx.x % 32 - q);
        q_cur[mi][h] = 1.0f;
        q_prev[mi][h] = u[mi][h];
      }
    }
    const float2* bt = b - threadIdx.x % 32 + t * TR * 32;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      float a[kMTiles][2];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[mi][h] = __fmul_rn(r0[mi][h], q_cur[mi][h]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kMmaTiles; ++nt) {
        const float c0 = bt[nt * 32 + 8 * q].x;
        const float c1 = bt[nt * 32 + 8 * q + 4].x;
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[mi][nt][2 * h] = fmaf(a[mi][h], c0, acc[mi][nt][2 * h]);
            acc[mi][nt][2 * h + 1] =
                fmaf(a[mi][h], c1, acc[mi][nt][2 * h + 1]);
          }
        }
      }
      if (kTail && q == 0) {
        const float c = bt[(TR - 1) * 32].x;
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            tail[mi][h] = fmaf(a[mi][h], c, tail[mi][h]);
          }
        }
      }
      bt += j_step;
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float next = __fsub_rn(
              __fmul_rn(2.0f * u[mi][h], q_cur[mi][h]), q_prev[mi][h]);
          q_prev[mi][h] = q_cur[mi][h];
          q_cur[mi][h] = next;
        }
      }
    }
  }
  if (kTail) {
    // Join the q lanes' sums; lane q = 0 holds the column for points g
    // and g + 8 in slots 0 and 2 of the last tile, as an MMA would.
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = tail[mi][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (lane_q() == 0) acc[mi][TR - 1][2 * h] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_tt_kernel(const float* __restrict__ points,
                const float* __restrict__ lo,
                const float* __restrict__ inv,
                const float* __restrict__ pack,
                float* __restrict__ out, int n_points, Geometry g) {
  extern __shared__ float4 smem4[];  // the pack, 16-byte aligned
  {
    const float4* src = reinterpret_cast<const float4*>(pack);
    for (int i = threadIdx.x; i < g.floats / 4; i += kThreads) {
      smem4[i] = src[i];
    }
  }
  __syncthreads();
  const float* cores = reinterpret_cast<const float*>(smem4);

  const int lane = threadIdx.x % 32;
  const int g8 = lane / 4;
  const int q4 = lane % 4;
  const int n_tiles = (n_points + kWarpPoints - 1) / kWarpPoints;
  for (int tile = blockIdx.x * kWarps + threadIdx.x / 32; tile < n_tiles;
       tile += gridDim.x * kWarps) {
    const int base = tile * kWarpPoints;
    // row[mi][t][e]: this lane's entries of the running row, in the
    // accumulator layout (e = 0, 1: point g, logical columns 8t + q,
    // 8t + q + 4; e = 2, 3: the same of point g + 8).  row_0 = e_0.
    Frags row, acc;
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
      for (int t = 0; t < kMaxTiles; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) row[mi][t][e] = 0.0f;
      }
      if (q4 == 0) row[mi][0][0] = row[mi][0][2] = 1.0f;
    }

    for (int s = 0; s < g.d; ++s) {
      // This lane's points, mi * 16 + g8 + 8h, scaled.
      const float lo_s = lo[s];
      const float inv_s = inv[s];
      float u[kMTiles][2];
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = base + mi * 16 + g8 + 8 * h;
          const float x = p < n_points
              ? points[static_cast<long long>(p) * g.d + s] : lo_s;
          u[mi][h] = __fsub_rn(
              __fmul_rn(__fmul_rn(2.0f, __fsub_rn(x, lo_s)), inv_s), 1.0f);
        }
      }
      const float2* b = reinterpret_cast<const float2*>(cores + g.off[s])
                        + lane;
      const int tl = g.tl[s], lt = g.ltail[s], n = g.n[s];
      switch (2 * g.tr[s] + g.tail[s]) {
        case 2: stage<1, false>(row, acc, b, tl, lt, n, u); break;
        case 3: stage<1, true>(row, acc, b, tl, lt, n, u); break;
        case 4: stage<2, false>(row, acc, b, tl, lt, n, u); break;
        case 5: stage<2, true>(row, acc, b, tl, lt, n, u); break;
        case 6: stage<3, false>(row, acc, b, tl, lt, n, u); break;
        case 7: stage<3, true>(row, acc, b, tl, lt, n, u); break;
        case 8: stage<4, false>(row, acc, b, tl, lt, n, u); break;
        case 9: stage<4, true>(row, acc, b, tl, lt, n, u); break;
        case 10: stage<5, false>(row, acc, b, tl, lt, n, u); break;
        case 11: stage<5, true>(row, acc, b, tl, lt, n, u); break;
        case 12: stage<6, false>(row, acc, b, tl, lt, n, u); break;
        case 13: stage<6, true>(row, acc, b, tl, lt, n, u); break;
        case 14: stage<7, false>(row, acc, b, tl, lt, n, u); break;
        case 15: stage<7, true>(row, acc, b, tl, lt, n, u); break;
        case 16: stage<8, false>(row, acc, b, tl, lt, n, u); break;
        default: stage<8, true>(row, acc, b, tl, lt, n, u); break;
      }
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
#pragma unroll
        for (int t = 0; t < kMaxTiles; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) row[mi][t][e] = acc[mi][t][e];
        }
      }
    }

    // row_d's one logical column 0 is physical column 0: lane q = 0
    // holds it for points g and g + 8.
    if (q4 == 0) {
#pragma unroll
      for (int mi = 0; mi < kMTiles; ++mi) {
        const int p = base + mi * 16 + g8;
        if (p < n_points) out[p] = row[mi][0][0];
        if (p + 8 < n_points) out[p + 8] = row[mi][0][2];
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Launch on `stream`.  `shapes` is a host array of d (r_l, n, r_r)
// triples; `pack` the f32 plane of ops/fused_tt.py::_pack, laid out by
// the same plan; `lo` and `inv` d floats on the device.  Returns a
// cudaError_t (0 on success); the launch is checked with
// cudaGetLastError, and nothing is synchronized.
int fused_tt_f32(const void* points, const void* lo, const void* inv,
                 const void* pack, void* out, int n_points, int d,
                 const void* shapes, void* stream) {
  if (d < 2 || d > kMaxCores || n_points < 0 ||
      n_points > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* sh = static_cast<const int*>(shapes);
  Geometry g;
  g.d = d;
  g.floats = 0;
  for (int s = 0; s < kMaxCores; ++s) {
    g.n[s] = g.tl[s] = g.tr[s] = g.off[s] = g.tail[s] = g.ltail[s] = 0;
  }
  for (int s = 0; s < d; ++s) {
    const int r_l = sh[3 * s], n = sh[3 * s + 1], r_r = sh[3 * s + 2];
    const bool chained = s == 0 ? r_l == 1 : r_l == sh[3 * s - 1];
    if (!chained || n < 1 || r_l < 1 || r_r < 1 ||
        r_l > kTile * kMaxTiles || r_r > kTile * kMaxTiles ||
        (s == d - 1 && r_r != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    g.n[s] = n;
    g.tl[s] = ceil_div(r_l, kTile);
    g.tr[s] = ceil_div(r_r, kTile);
    g.off[s] = g.floats;
    g.tail[s] = r_r % kTile == 1;
    g.ltail[s] = r_l % kTile == 1;
    g.floats += n * g.tl[s] * g.tr[s] * kFrag;
  }
  const long long smem = 4LL * g.floats;
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return static_cast<int>(cudaSuccess);

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fused_tt_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = ceil_div(ceil_div(n_points, kWarpPoints), kWarps);
  if (blocks > sms) blocks = sms;
  fused_tt_kernel<<<blocks, kThreads, static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(lo),
      static_cast<const float*>(inv), static_cast<const float*>(pack),
      static_cast<float*>(out), n_points, g);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_tt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

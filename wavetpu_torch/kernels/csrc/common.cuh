// Pieces shared by the kernel sources of wavetpu_torch/kernels/csrc: the
// dtype codes of the C interface, storage <-> compute conversions, index
// wrapping, and the cone kernels' tile geometry, plane indexing, publish,
// Laplacian and error-row protocol (K9 in sharded.cu; K10 through
// plane.cuh, whose pipelines of K3/K8 and K4/K11/K12 share the Laplacian).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with stencil_cuda.py.
enum { WT_F32 = 0, WT_F64 = 1, WT_BF16 = 2, WT_NONE = -1 };

namespace {

template <typename T>
struct Conv;

template <>
struct Conv<float> {
  using F = float;
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Conv<double> {
  using F = double;
  static __device__ __forceinline__ double to(double x) { return x; }
  static __device__ __forceinline__ double from(double x) { return x; }
};

template <>
struct Conv<__nv_bfloat16> {
  using F = float;
  static __device__ __forceinline__ float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

// The x plane of a cone kernel's onion plane xu = x1 - k + x.  The onion
// spans [-k, n + k) and k <= n (k divides n), so one add or subtract wraps
// it, where `wrap`'s division would cost every substep.
__device__ __forceinline__ int wrap_near(int xu, int n) {
  return xu < 0 ? xu + n : (xu >= n ? xu - n : xu);
}

// ---------------------------------------------------------------------------
// The cone kernels (K9 in sharded.cu, K10 in kstep_xy.cu).
//
// A tile of tx (x) * ty (y) * tz (z) output cells loads its cone,
// (tx+2k)(ty+2k)(tz+2k) cells, with one thread per (y, z) column, which
// keeps the column's fields in registers (the x neighbours are the
// thread's own registers).  Each substep publishes u to shared memory for
// the y/z neighbours (double-buffered, one barrier per substep), then
// updates the column inside a cone that shrinks one cell per side per
// substep.  At most kMaxTx output planes per tile in x, and kConeThreads
// columns (stencil_cuda._KSTEP_MAX_TX and _CONE_THREADS).
constexpr int kMaxTx = 8;
constexpr int kConeThreads = 640;

// One thread's column of a cone tile.
struct Cone {
  int ex, ey, ez, cols;  // cone extents; cols = ey * ez columns
  int tid, ly, lz;       // this thread's column (the block is padded to
  bool live;             // whole warps: live = a column, not padding)
  int x1;                // the tile's first output plane
  bool interior;         // off the stored y=0 / z=0 Dirichlet planes
  bool central;          // its cells are this tile's outputs
  int64_t nn, row;       // the x-plane stride; the column's (y, z) offset
};

__device__ __forceinline__ Cone cone_of_thread(int k, int tx, int ty, int tz,
                                               int n) {
  Cone c;
  c.ex = tx + 2 * k;
  c.ey = ty + 2 * k;
  c.ez = tz + 2 * k;
  c.cols = c.ey * c.ez;
  c.tid = threadIdx.x;
  c.live = c.tid < c.cols;
  c.lz = c.live ? c.tid % c.ez : 0;
  c.ly = c.live ? c.tid / c.ez : 0;
  c.x1 = blockIdx.z * tx;
  const int y1 = blockIdx.y * ty, z1 = blockIdx.x * tz;
  const int gy = wrap(y1 - k + c.ly, n), gz = wrap(z1 - k + c.lz, n);
  c.interior = gy != 0 && gz != 0;
  c.nn = (int64_t)n * n;
  c.row = (int64_t)gy * n + gz;
  c.central = c.live && c.ly >= k && c.ly < k + ty && c.lz >= k &&
              c.lz < k + tz && y1 + c.ly - k < n && z1 + c.lz - k < n;
  return c;
}

// The global index of the column's cone plane x, unwrapped x1 - k + x
// (the onion spans [-k, n + k)).  A kernel loads all its fields of a plane
// together, at one index: loading them field by field keeps every plane's
// index live at once and costs registers.
template <int K>
__device__ __forceinline__ int64_t cone_index(const Cone& c, int x, int n) {
  return (int64_t)wrap_near(c.x1 - K + x, n) * c.nn + c.row;
}

// The global index of a central column's output plane x1 + p.
__device__ __forceinline__ int64_t out_index(const Cone& c, int p) {
  return (int64_t)(c.x1 + p) * c.nn + c.row;
}

// Publish the column's u to this substep's shared buffer [ex][cols].
template <int kEx>
__device__ __forceinline__ void publish_column(float* pl,
                                               const float (&u)[kEx],
                                               const Cone& c) {
  if (!c.live) return;
#pragma unroll
  for (int x = 0; x < kEx; ++x)
    if (x < c.ex) pl[x * c.cols + c.tid] = u[x];
}

// The Laplacian of cone cell x (register U[x] = u, its shared index i =
// x * cols + tid) in the Pallas summation order
// (stencil_pallas._slab_laplacian), `left` = U[x-1] before this substep.
__device__ __forceinline__ float cone_laplacian(float left, float right,
                                                float u, const float* pl,
                                                int i, int ez, float ix,
                                                float iy, float iz) {
  float lap = (left + right - 2.0f * u) * ix;
  lap = lap + (pl[i - ez] + pl[i + ez] - 2.0f * u) * iy;
  lap = lap + (pl[i - 1] + pl[i + 1] - 2.0f * u) * iz;
  return lap;
}

// Error rows of the cone kernels.  Per substep s the kernel emits the
// per-x-plane error maxes of the central cells' new u,
//   dmax[s-1, x] = max_{y,z} |u - sxct[s-1, x] * syz[y, z]|
//   rmax[s-1, x] = max_{y,z} |u - sxct[s-1, x] * syz[y, z]| * rsyz[y, z]
// combined with max on the bits of a non-negative float (unsigned order =
// float order, and a NaN - bits above +inf - wins, as jnp.max propagates
// it; fmaxf would drop it): a warp reduction, an atomicMax per warp into
// the shared emax[s & 1], and after the next barrier an atomicMax per tile
// into the global rows, zeroed by the caller.
using RowMax = unsigned[2][2][kMaxTx];  // [substep parity][abs|rel][x]

__device__ __forceinline__ void rows_clear(RowMax& emax, const Cone& c) {
  if (c.tid < 2 * 2 * kMaxTx) (&emax[0][0][0])[c.tid] = 0u;
}

// Reduce substep s's errors of the central cells into emax[s & 1].
template <int K, int kEx>
__device__ __forceinline__ void rows_reduce(RowMax& emax,
                                            const float (&u)[kEx],
                                            const float* __restrict__ sxct,
                                            int s, int n, const Cone& c,
                                            int tx, float syz_c,
                                            float rsyz_c) {
  // Warps without a central column skip the reduction (warp-uniform).
  if (!__any_sync(0xffffffffu, c.central)) return;
#pragma unroll
  for (int p = 0; p < kMaxTx; ++p) {
    if (p >= tx) break;  // uniform across the block
    unsigned db = 0u, rb = 0u;
    if (c.central) {
      const float diff =
          fabsf(u[K + p] - sxct[(int64_t)(s - 1) * n + c.x1 + p] * syz_c);
      db = __float_as_uint(diff);
      rb = __float_as_uint(fabsf(diff * rsyz_c));
    }
    db = __reduce_max_sync(0xffffffffu, db);
    rb = __reduce_max_sync(0xffffffffu, rb);
    if ((c.tid & 31) == 0) {
      atomicMax(&emax[s & 1][0][p], db);
      atomicMax(&emax[s & 1][1][p], rb);
    }
  }
}

// Flush substep s's maxes into row s-1 of dmax / rmax and clear them for
// substep s+2.  Call after a barrier that every warp passed after its
// rows_reduce of substep s.
__device__ __forceinline__ void rows_flush(RowMax& emax,
                                           unsigned* __restrict__ dmax,
                                           unsigned* __restrict__ rmax,
                                           int s, int n, const Cone& c,
                                           int tx) {
  if (c.tid < 2 * kMaxTx && (c.tid % kMaxTx) < tx) {
    const int which = c.tid / kMaxTx, p = c.tid % kMaxTx;
    unsigned* rows = which ? rmax : dmax;
    atomicMax(&rows[(int64_t)(s - 1) * n + c.x1 + p], emax[s & 1][which][p]);
    emax[s & 1][which][p] = 0u;
  }
}

}  // namespace

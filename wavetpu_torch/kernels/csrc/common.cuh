// Pieces shared by the kernel sources of wavetpu_torch/kernels/csrc: the
// dtype codes of the C interface, storage <-> compute conversions, index
// wrapping, and the column of a halo face with the Laplacian in the Pallas
// summation order that both k-step pipelines (kstep_pipe.cu: K3, K8-K10;
// comp_sharded.cu: K4, K11, K12) build on through plane.cuh.

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

// ---------------------------------------------------------------------------
// One thread's column of a halo face.  A pipeline block owns a (ty x tz)
// y/z output face of an x segment and holds its (ty+2k)(tz+2k) halo face,
// one thread per (y, z) column; the face its stage s computes shrinks by s
// cells per side (a cone in x and time).  csrc/plane.cuh `plane_cone`
// fills it.
struct Cone {
  int ex, ey, ez, cols;  // cone extents; cols = ey * ez columns
  int tid, ly, lz;       // this thread's column (the block is padded to
  bool live;             // whole warps: live = a column, not padding)
  int x1;                // the tile's first output plane
  bool interior;         // off the stored y=0 / z=0 Dirichlet planes
  bool central;          // its cells are this tile's outputs
  int64_t nn, row;       // the x-plane stride; the column's (y, z) offset
};

// The Laplacian of a column's cell u in the Pallas summation order
// (stencil_pallas._slab_laplacian): `left` and `right` are its x
// neighbours (the thread's own registers), `pl` the plane its stage
// published to shared memory, i = the column's index in it.
__device__ __forceinline__ float cone_laplacian(float left, float right,
                                                float u, const float* pl,
                                                int i, int ez, float ix,
                                                float iy, float iz) {
  float lap = (left + right - 2.0f * u) * ix;
  lap = lap + (pl[i - ez] + pl[i + ez] - 2.0f * u) * iy;
  lap = lap + (pl[i - 1] + pl[i + 1] - 2.0f * u) * iz;
  return lap;
}

}  // namespace

// The geometry of the k-step pipelines on a block whose planes may be
// extended in y (kstep_pipe.cu: K3, K8, K9, K10; comp_sharded.cu: K4, K11,
// K12), and the x chain they read the block's x neighbours through:
// csrc/common.cuh's `Cone` over a (py, n) plane with a y offset.
//
// y geometry.  A block holds `ny` output rows of the global y range
// [y0, y0 + ny) and its planes hold `py` rows:
//   * py == ny: the whole y extent (ny = n, y0 = 0); the cone's rows wrap
//     around the plane as the single-device kernels' do (K3, K4, K8, K9,
//     K11);
//   * py == ny + 2k: the y-extended block of a y-sharded mesh, k ghost rows
//     of the y neighbours on each side of the ny central rows (K10, K12).
//     No cone row of a central output needs a wrap there: a central row's
//     cone reaches k rows out, inside the extension.  A cone row past the
//     extension (the tile overhangs ny) lies more than k rows from every
//     central row, so what it holds never reaches an output; it reads the
//     plane's last row, any valid cell serves.
// The Dirichlet mask tests the wrapped global row, (y0 + row) mod n != 0
// (wavetpu's `gy % n_global`), so the global y = 0 plane is re-zeroed also
// where it sits inside a ghost strip.

#pragma once

#include "common.cuh"

namespace {

// One thread's column of a cone tile over (py, n) planes: the `Cone` the
// shared helpers take (nn and row index the input planes), plus where the
// column's row lies in an output plane of ny rows.
struct PlaneCone {
  Cone c;
  int64_t onn;   // output plane stride, ny * n
  int64_t orow;  // the column's (y, z) offset in an output or carry plane
  bool orow_ok;  // its row is an output row (a central row of the block)
};

// `xs` is the block's x segment (block z, or its segment within a lane in
// the pipelines' lane mode).
__device__ __forceinline__ PlaneCone plane_cone(int k, int tx, int ty, int tz,
                                                int n, int py, int ny, int y0,
                                                int xs) {
  PlaneCone p;
  Cone& c = p.c;
  c.ex = tx + 2 * k;
  c.ey = ty + 2 * k;
  c.ez = tz + 2 * k;
  c.cols = c.ey * c.ez;
  c.tid = threadIdx.x;
  c.live = c.tid < c.cols;
  c.lz = c.live ? c.tid % c.ez : 0;
  c.ly = c.live ? c.tid / c.ez : 0;
  c.x1 = xs * tx;
  const int y1 = blockIdx.y * ty, z1 = blockIdx.x * tz;
  const int yo = y1 - k + c.ly;  // the column's row among the output rows
  const int gz = wrap(z1 - k + c.lz, n);
  const bool ext = py != ny;
  const int pr = ext ? min(yo + k, py - 1) : wrap(yo, py);  // input row
  const int oy = ext ? yo : pr;
  c.interior = wrap(y0 + yo, n) != 0 && gz != 0;
  c.nn = (int64_t)py * n;
  c.row = (int64_t)pr * n + gz;
  c.central = c.live && c.ly >= k && c.ly < k + ty && c.lz >= k &&
              c.lz < k + tz && yo < ny && z1 + c.lz - k < n;
  p.onn = (int64_t)ny * n;
  p.orow = (int64_t)oy * n + gz;
  p.orow_ok = oy >= 0 && oy < ny;
  return p;
}

// A field's x chain: the lo ghost window (k planes) | the block's d planes
// | the hi ghost window (k planes), three arrays of (., py, n) planes.
template <typename T>
struct Chain {
  const T* lo;
  const T* blk;
  const T* hi;
};

// Where chain plane xu (-k <= xu < d + k) of a column at plane offset
// `row` lies: 0 the lo window, 1 the block, 2 the hi window; `g` is the
// cell's index in that array.  Fields of one chain layout share it.
// (kstep_pipe.cu's `pad_chain_pos` adds K9's pad: a block of n_real <= d
// real planes, zero past its hi window.)
__device__ __forceinline__ int chain_pos(int xu, int k, int d, int64_t nn,
                                         int64_t row, int64_t& g) {
  if (xu < 0) {
    g = (int64_t)(xu + k) * nn + row;
    return 0;
  }
  if (xu < d) {
    g = (int64_t)xu * nn + row;
    return 1;
  }
  g = (int64_t)(xu - d) * nn + row;
  return 2;
}

}  // namespace

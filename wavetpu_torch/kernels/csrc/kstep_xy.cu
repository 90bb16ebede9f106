// K10: k leapfrog substeps of one block of an (MX, MY, 1) mesh - the
// hand-written Hopper (sm_90a) counterpart of wavetpu's
// `_kstep_sharded_xy_kernel` (fused_kstep_sharded_xy,
// wavetpu/kernels/stencil_pallas.py).
//
// The caller hands in the block extended in y by k ghost rows per side
// (py = ny + 2k rows of the y neighbours' planes) and (k, py, n) x ghost
// windows cut from the x neighbours' y-extended blocks, which carry the
// corner cells.  Each field's x chain is lo window | block | hi window
// (csrc/plane.cuh `Chain`), read in place.  Outputs are the central
// (d, ny, n) rows; the error rows (k, d) are the maxes over this shard's y
// range (the caller takes the max across the y shards).  The Dirichlet
// mask tests the wrapped global row (csrc/plane.cuh).
//
// Each substep is op for op K3's (csrc/kstep_pipe.cu, itself K1's update):
//   new = mask((2u + coeff*lap(u)) - u_prev), a bf16 state rounded to bf16
// and back, so the y-sharded k-fused solve equals the single-device one
// bit for bit.  A field (f32) has its own chain of the same layout, its
// cells in place of coeff.
//
// Bound: bytes.  Per launch the extended u_prev and u and their windows
// read once and the central two layers written once: ~16.5 B per output
// cell for f32 at the main path's mesh-2,2,1 block (+4 with a field), plus
// the rows.  Design: K9's (the cone tile of common.cuh, the column in
// registers, y/z through shared memory) over the extended plane.
//
// Built by wavetpu_torch/kernels/build.py with --fmad=false.  The entry
// point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().  Wrapper, plain PyTorch
// version and launch counter: stencil_cuda.fused_kstep_sharded_xy.

#include "plane.cuh"

namespace {

template <int K, int TX, typename T>
__global__ void __launch_bounds__(kConeThreads)
kstep_xy_kernel(Chain<T> prev, Chain<T> cur, T* __restrict__ prev_out,
                T* __restrict__ out, Chain<float> c2,
                const float* __restrict__ syz, const float* __restrict__ rsyz,
                const float* __restrict__ sxct, unsigned* __restrict__ dmax,
                unsigned* __restrict__ rmax, int d, int n, int py, int ny,
                int y0, int tx_arg, int ty, int tz, float coeff, float ix,
                float iy, float iz) {
  constexpr int kEx = (TX > 0 ? TX : kMaxTx) + 2 * K;  // register column
  const int tx = TX > 0 ? TX : tx_arg;
  extern __shared__ float plane[];  // [2][ex][ey * ez]
  __shared__ RowMax emax;
  const PlaneCone pc = plane_cone(K, tx, ty, tz, n, py, ny, y0);
  const Cone& cn = pc.c;
  const bool errors = dmax != nullptr;
  float syz_c = 0.0f, rsyz_c = 0.0f;
  if (errors && cn.central) {
    syz_c = syz[pc.orow];
    rsyz_c = rsyz[pc.orow];
  }
  rows_clear(emax, cn);

  float P[kEx], U[kEx];
#pragma unroll
  for (int x = 0; x < kEx; ++x) {
    P[x] = U[x] = 0.0f;
    if (cn.live && x < cn.ex) {
      int64_t g;  // u_prev and u share the chain layout: one index
      const int w = chain_pos(cn.x1 - K + x, K, d, cn.nn, cn.row, g);
      P[x] = chain_read(prev, w, g);
      U[x] = chain_read(cur, w, g);
    }
  }

#pragma unroll
  for (int s = 1; s <= K; ++s) {
    float* pl = plane + (s & 1) * cn.ex * cn.cols;
    publish_column(pl, U, cn);
    __syncthreads();
    if (errors && s > 1) rows_flush(emax, dmax, rmax, s - 1, d, cn, tx);
    if (cn.live && cn.ly >= s && cn.ly < cn.ey - s && cn.lz >= s &&
        cn.lz < cn.ez - s) {
      float left = U[s - 1];
#pragma unroll
      for (int x = 1; x < kEx - 1; ++x) {
        if (x >= s && x < cn.ex - s) {
          const float c = U[x];
          const float lap = cone_laplacian(left, U[x + 1], c, pl,
                                           x * cn.cols + cn.tid, cn.ez, ix,
                                           iy, iz);
          const float co =
              c2.blk ? chain_value(c2, cn.x1 - K + x, K, d, cn) : coeff;
          float o = 2.0f * c + co * lap;
          o = o - P[x];
          o = cn.interior ? o : 0.0f;
          o = Conv<T>::to(Conv<T>::from(o));  // the 1-step path's store
          P[x] = c;
          left = c;
          U[x] = o;
        }
      }
    }
    if (errors) rows_reduce<K>(emax, U, sxct, s, d, cn, tx, syz_c, rsyz_c);
  }
  if (errors) {
    __syncthreads();
    rows_flush(emax, dmax, rmax, K, d, cn, tx);
  }
  if (!cn.central) return;
#pragma unroll
  for (int p = 0; p < kMaxTx; ++p) {
    if (p < tx) {
      const int64_t g = (int64_t)(cn.x1 + p) * pc.onn + pc.orow;
      prev_out[g] = Conv<T>::from(P[K + p]);
      out[g] = Conv<T>::from(U[K + p]);
    }
  }
}

struct Args {
  const void *uprev, *u, *plo, *phi, *clo, *chi;
  void *prev_out, *out;
  const void *c2, *c2lo, *c2hi, *syz, *rsyz, *sxct;
  void *dmax, *rmax;
  int d, n, py, ny, y0, tx, ty, tz;
  float coeff, ix, iy, iz;
};

template <int K, int TX, typename T>
int launch_xy(const Args& a, cudaStream_t stream) {
  auto kern = kstep_xy_kernel<K, TX, T>;
  const int cols = (a.ty + 2 * K) * (a.tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > kConeThreads) return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * (a.tx + 2 * K) * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + a.tz - 1) / a.tz, (a.ny + a.ty - 1) / a.ty,
                  a.d / a.tx);
  const Chain<T> prev{static_cast<const T*>(a.plo),
                      static_cast<const T*>(a.uprev),
                      static_cast<const T*>(a.phi)};
  const Chain<T> cur{static_cast<const T*>(a.clo), static_cast<const T*>(a.u),
                     static_cast<const T*>(a.chi)};
  const Chain<float> c2{static_cast<const float*>(a.c2lo),
                        static_cast<const float*>(a.c2),
                        static_cast<const float*>(a.c2hi)};
  kern<<<grid, threads, shmem, stream>>>(
      prev, cur, static_cast<T*>(a.prev_out), static_cast<T*>(a.out), c2,
      static_cast<const float*>(a.syz), static_cast<const float*>(a.rsyz),
      static_cast<const float*>(a.sxct), static_cast<unsigned*>(a.dmax),
      static_cast<unsigned*>(a.rmax), a.d, a.n, a.py, a.ny, a.y0, a.tx, a.ty,
      a.tz, a.coeff, a.ix, a.iy, a.iz);
  return (int)cudaGetLastError();
}

// The tile depth fixed at compile time when it is kMaxTx (the usual case),
// read at run time otherwise (as K3 and K8).
template <int K>
int launch_xy_dtype(int dtype, const Args& a, cudaStream_t st) {
  if (dtype == WT_F32)
    return a.tx == kMaxTx ? launch_xy<K, kMaxTx, float>(a, st)
                          : launch_xy<K, 0, float>(a, st);
  if (dtype == WT_BF16)
    return a.tx == kMaxTx ? launch_xy<K, kMaxTx, __nv_bfloat16>(a, st)
                          : launch_xy<K, 0, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K10.  State f32 or bf16: the y-extended block (d, py, n) with py = ny +
// 2k, its (k, py, n) x windows, and the central (d, ny, n) outputs; y0 is
// the global y of the block's first central row.  c2 is the f32 extended
// field block with (k, py, n) f32 windows, or null.  dmax/rmax are (k, d)
// uint32 rows zeroed by the caller, or null (then syz, rsyz - the central
// (ny, n) oracle planes - and sxct (k, d) are not read).  1 <= k <= 8; tx
// <= 8 divides d.
int wt_kstep_xy(const void* uprev, const void* u, const void* plo,
                const void* phi, const void* clo, const void* chi,
                void* prev_out, void* out, const void* c2, const void* c2lo,
                const void* c2hi, const void* syz, const void* rsyz,
                const void* sxct, void* dmax, void* rmax, int d, int n,
                int py, int ny, int y0, int k, int tx, int ty, int tz,
                int dtype, double coeff, double ix, double iy, double iz,
                void* stream) {
  if (tx < 1 || tx > kMaxTx || d % tx || k < 1 || k > 8 || ny < 1 ||
      py != ny + 2 * k || y0 < 0 || y0 >= n || ty < 1 || tz < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{uprev, u, plo, phi, clo, chi, prev_out, out,
               c2, c2lo, c2hi, syz, rsyz, sxct, dmax, rmax,
               d, n, py, ny, y0, tx, ty, tz,
               (float)coeff, (float)ix, (float)iy, (float)iz};
#define WT_K(KK) \
  case KK:       \
    return launch_xy_dtype<KK>(dtype, a, st)
  switch (k) {
    WT_K(1);
    WT_K(2);
    WT_K(3);
    WT_K(4);
    WT_K(5);
    WT_K(6);
    WT_K(7);
    WT_K(8);
  }
#undef WT_K
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// K3: k temporally fused leapfrog substeps, the hand-written Hopper (sm_90a)
// counterpart of stencil_pallas._kstep_kernel (entry point fused_kstep),
// with its field operand (K3f: `has_field`, _field_onion / _substep_coeff).
//
// Built by wavetpu_torch/kernels/build.py beside stencil.cu (one nvcc per
// source, started together), with --fmad=false: every multiply and add is
// rounded on its own, in the order of the plain version
// (stencil_cuda.fused_kstep_plain) and of K1.
//
// Each substep is op for op K1's update (csrc/stencil.cu, step_kernel with
// (alpha, beta) = (2, 1)):
//   new = mask((2u + coeff*lap(u)) - u_prev)
// with lap = ((xm + xp - 2u)*ix + (ym + yp - 2u)*iy) + (zm + zp - 2u)*iz
// (1*u_prev is exact, so K1's `- beta*u_prev` is the same bits), and with
// a field the cell's c2tau2 in place of coeff (K5's update).  A bf16 state
// rounds every substep to bf16 (round to nearest even) and back, as the
// 1-step path stores every layer, so a k-fused solve equals the 1-step
// solve bit for bit.  Per substep s the kernel also emits the per-x-plane
// error maxes of the layer it made, with K4's error-row protocol
// (csrc/common.cuh: rows_reduce / rows_flush).
//
// Bound: bytes.  Per launch u_prev and u are read once and
// (u_{n+k-1}, u_{n+k}) written once: 16 B/cell for f32, 8 for bf16, plus 4
// for an f32 field.  Design: K4's cone (csrc/common.cuh), the column's
// u_prev and u in registers.  The field is read through the cache at each
// substep (a run-time pointer, so one instantiation serves both).  Unlike
// K4 there is no carry slab: every cell's substeps are a function of the
// inputs alone, so the result does not depend on the tile.

#include "common.cuh"

namespace {

template <int K, int TX, typename T>
__global__ void __launch_bounds__(kConeThreads)
kstep_kernel(const T* __restrict__ uprev, const T* __restrict__ u,
             T* __restrict__ prev_out, T* __restrict__ out,
             const float* __restrict__ c2, const float* __restrict__ syz,
             const float* __restrict__ rsyz, const float* __restrict__ sxct,
             unsigned* __restrict__ dmax, unsigned* __restrict__ rmax, int n,
             int tx_arg, int ty, int tz, float coeff, float ix, float iy,
             float iz) {
  constexpr int kEx = (TX > 0 ? TX : kMaxTx) + 2 * K;  // register column
  const int tx = TX > 0 ? TX : tx_arg;
  extern __shared__ float plane[];  // [2][ex][ey * ez]
  __shared__ RowMax emax;
  const Cone cn = cone_of_thread(K, tx, ty, tz, n);
  const bool errors = dmax != nullptr;
  float syz_c = 0.0f, rsyz_c = 0.0f;
  if (errors && cn.central) {
    syz_c = syz[cn.row];
    rsyz_c = rsyz[cn.row];
  }
  rows_clear(emax, cn);

  float P[kEx], U[kEx];
#pragma unroll
  for (int x = 0; x < kEx; ++x) {
    P[x] = U[x] = 0.0f;
    if (cn.live && x < cn.ex) {
      const int64_t g = cone_index<K>(cn, x, n);
      P[x] = Conv<T>::to(uprev[g]);
      U[x] = Conv<T>::to(u[g]);
    }
  }

#pragma unroll
  for (int s = 1; s <= K; ++s) {
    float* pl = plane + (s & 1) * cn.ex * cn.cols;
    publish_column(pl, U, cn);
    __syncthreads();
    if (errors && s > 1) rows_flush(emax, dmax, rmax, s - 1, n, cn, tx);
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
          const float co = c2 ? c2[cone_index<K>(cn, x, n)] : coeff;
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
    if (errors) rows_reduce<K>(emax, U, sxct, s, n, cn, tx, syz_c, rsyz_c);
  }
  if (errors) {
    __syncthreads();
    rows_flush(emax, dmax, rmax, K, n, cn, tx);
  }
  if (!cn.central) return;
#pragma unroll
  for (int p = 0; p < kMaxTx; ++p) {
    if (p < tx) {
      const int64_t g = out_index(cn, p);
      prev_out[g] = Conv<T>::from(P[K + p]);
      out[g] = Conv<T>::from(U[K + p]);
    }
  }
}

template <int K, int TX, typename T>
int launch(const void* uprev, const void* u, void* prev_out, void* out,
           const void* c2, const void* syz, const void* rsyz,
           const void* sxct, void* dmax, void* rmax, int n, int tx, int ty,
           int tz, float coeff, float ix, float iy, float iz,
           cudaStream_t stream) {
  auto kern = kstep_kernel<K, TX, T>;
  const int cols = (ty + 2 * K) * (tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > kConeThreads) return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * (tx + 2 * K) * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + tz - 1) / tz, (n + ty - 1) / ty, n / tx);
  kern<<<grid, threads, shmem, stream>>>(
      static_cast<const T*>(uprev), static_cast<const T*>(u),
      static_cast<T*>(prev_out), static_cast<T*>(out),
      static_cast<const float*>(c2), static_cast<const float*>(syz),
      static_cast<const float*>(rsyz), static_cast<const float*>(sxct),
      static_cast<unsigned*>(dmax), static_cast<unsigned*>(rmax), n, tx, ty,
      tz, coeff, ix, iy, iz);
  return (int)cudaGetLastError();
}

// The tile depth fixed at compile time when it is kMaxTx (N divisible by
// 8, the main path), read at run time otherwise.  As for K4, the fixed
// depth doubles the instantiations but is the faster one;
// kernels/tile_ab.py times the two against each other (PERF.md).
template <int K, typename T>
int launch_tx(const void* uprev, const void* u, void* prev_out, void* out,
              const void* c2, const void* syz, const void* rsyz,
              const void* sxct, void* dmax, void* rmax, int n, int tx, int ty,
              int tz, float coeff, float ix, float iy, float iz,
              cudaStream_t st) {
  return tx == kMaxTx
             ? launch<K, kMaxTx, T>(uprev, u, prev_out, out, c2, syz, rsyz,
                                    sxct, dmax, rmax, n, tx, ty, tz, coeff,
                                    ix, iy, iz, st)
             : launch<K, 0, T>(uprev, u, prev_out, out, c2, syz, rsyz, sxct,
                               dmax, rmax, n, tx, ty, tz, coeff, ix, iy, iz,
                               st);
}

template <int K>
int launch_dtype(int dtype, const void* uprev, const void* u, void* prev_out,
                 void* out, const void* c2, const void* syz, const void* rsyz,
                 const void* sxct, void* dmax, void* rmax, int n, int tx,
                 int ty, int tz, float coeff, float ix, float iy, float iz,
                 cudaStream_t st) {
  if (dtype == WT_F32)
    return launch_tx<K, float>(uprev, u, prev_out, out, c2, syz, rsyz, sxct,
                               dmax, rmax, n, tx, ty, tz, coeff, ix, iy, iz,
                               st);
  if (dtype == WT_BF16)
    return launch_tx<K, __nv_bfloat16>(uprev, u, prev_out, out, c2, syz,
                                       rsyz, sxct, dmax, rmax, n, tx, ty, tz,
                                       coeff, ix, iy, iz, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// State f32 or bf16 (WT_F32 / WT_BF16) for uprev, u and both outputs; c2 is
// the f32 (n, n, n) field or null; dmax/rmax are (k, n) uint32 rows zeroed
// by the caller, or null (then syz, rsyz and sxct are not read).
// 2 <= k <= 8 divides n; tx <= 8 divides n.
int wt_kstep(const void* uprev, const void* u, void* prev_out, void* out,
             const void* c2, const void* syz, const void* rsyz,
             const void* sxct, void* dmax, void* rmax, int n, int k, int tx,
             int ty, int tz, int dtype, double coeff, double ix, double iy,
             double iz, void* stream) {
  if (tx < 1 || tx > kMaxTx || n % tx || k < 2 || n % k || ty < 1 ||
      tz < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c = (float)coeff, fx = (float)ix, fy = (float)iy,
              fz = (float)iz;
#define WT_K(KK)                                                             \
  case KK:                                                                   \
    return launch_dtype<KK>(dtype, uprev, u, prev_out, out, c2, syz, rsyz,   \
                            sxct, dmax, rmax, n, tx, ty, tz, c, fx, fy, fz,  \
                            st)
  switch (k) {
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

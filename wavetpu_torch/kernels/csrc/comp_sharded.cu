// K11 and K12: k compensated (velocity-form) substeps of one shard block of
// the distributed flagship - the hand-written Hopper (sm_90a) counterparts
// of wavetpu's Pallas kernels (wavetpu/kernels/stencil_pallas.py):
//
//   K11  kstep_comp_chain_kernel, py == ny  <- _kstep_comp_sharded_kernel
//                                              (fused_kstep_comp_sharded)
//   K12  kstep_comp_chain_kernel, py == ny + 2k
//                                           <- _kstep_comp_sharded_xy_kernel
//                                              (fused_kstep_comp_sharded_xy)
//
// One kernel with a run-time y mode (csrc/plane.cuh): K11 takes the x-sharded
// block (d, n, n) with whole y rows that wrap; K12 the y-extended block of an
// (MX, MY, 1) mesh (d, ny + 2k, n) with central outputs and the wrapped
// global-row mask.  u and v reach their x neighbours through the chain lo
// window | block | hi window (k-plane windows of the x neighbours' blocks,
// for K12 cut from their y-extended blocks), read in place.
//
// Each substep is op for op K4's (csrc/stencil.cu, `_kstep_comp_kernel`):
//   d = mask(coeff*lap(u)); v' = v + d; Kahan two-sum u' = u + v' through
//   the carry (y = v' - C; t = u + y; C = (t - u) - y).
// The carry rides slab-only as in K4: zero outside the block_x slab in x
// and, for K12, outside the central rows in y (wavetpu's zero-seeded carry
// halos).  For one block_x K11 runs K4's op sequence, so an x-sharded
// flagship equals the single-device one; K12's zero y-ghost carry differs
// from K4's (it is not bitwise equal to the single-device flagship, within
// the scheme's 1e-6 tolerance).  Storage modes as K4: f32 u; (v, carry)
// f32/bf16, f32/f32, f32/none, bf16/none.  A field (f32) has its own chain,
// its cells in place of coeff (K11f / K12f).
//
// Bound: bytes.  Per launch u, v and their windows read once, the carry
// read once, u, v and the carry written once: ~20 B per output cell at f32
// u/v with a bf16 carry (+4 with a field, +0.5 per extra row of K12's
// extension).  Design: K4's cone tile, the column's u, v and carry in
// registers.
//
// Built by wavetpu_torch/kernels/build.py with --fmad=false, beside the
// other sources (its 64 instantiations build in parallel with K4's).  The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().  Wrappers, plain PyTorch
// versions and launch counters: stencil_cuda.fused_kstep_comp_sharded and
// fused_kstep_comp_sharded_xy.

#include "plane.cuh"

namespace {

// A k=1 tile (the bootstrap and the tail) is held to two blocks per SM, as
// K4's.
template <int K, int TX, typename VT, typename CT, bool HAS_CARRY>
__global__ void __launch_bounds__(kConeThreads, K == 1 ? 2 : 1)
kstep_comp_chain_kernel(Chain<float> u, Chain<VT> v,
                        const CT* __restrict__ carry,
                        float* __restrict__ u_out, VT* __restrict__ v_out,
                        CT* __restrict__ carry_out, Chain<float> c2,
                        const float* __restrict__ syz,
                        const float* __restrict__ rsyz,
                        const float* __restrict__ sxct,
                        unsigned* __restrict__ dmax,
                        unsigned* __restrict__ rmax, int d, int n, int py,
                        int ny, int y0, int bx, int tx_arg, int ty, int tz,
                        float coeff, float ix, float iy, float iz) {
  constexpr int kEx = (TX > 0 ? TX : kMaxTx) + 2 * K;  // register column
  const int tx = TX > 0 ? TX : tx_arg;
  extern __shared__ float plane[];  // [2][ex][ey * ez]
  __shared__ RowMax emax;
  const PlaneCone pc = plane_cone(K, tx, ty, tz, n, py, ny, y0);
  const Cone& cn = pc.c;
  const int xb0 = (cn.x1 / bx) * bx;  // the block_x slab this tile lies in
  const bool errors = dmax != nullptr;
  float syz_c = 0.0f, rsyz_c = 0.0f;
  if (errors && cn.central) {
    syz_c = syz[pc.orow];
    rsyz_c = rsyz[pc.orow];
  }
  rows_clear(emax, cn);

  float U[kEx], V[kEx], C[kEx];
#pragma unroll
  for (int x = 0; x < kEx; ++x) {
    U[x] = V[x] = C[x] = 0.0f;
    if (cn.live && x < cn.ex) {
      const int xu = cn.x1 - K + x;
      int64_t g;
      // u and v share the chain layout: one index for both.
      const int w = chain_pos(xu, K, d, cn.nn, cn.row, g);
      U[x] = chain_read(u, w, g);
      V[x] = chain_read(v, w, g);
      if (HAS_CARRY && pc.orow_ok && xu >= xb0 && xu < xb0 + bx)
        C[x] = Conv<CT>::to(carry[(int64_t)xu * pc.onn + pc.orow]);
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
          const float dd = cn.interior ? co * lap : 0.0f;
          const float vn = V[x] + dd;
          const float yy = HAS_CARRY ? vn - C[x] : vn;
          const float t = c + yy;
          if (HAS_CARRY) C[x] = (t - c) - yy;
          V[x] = vn;
          left = c;
          U[x] = t;
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
      u_out[g] = U[K + p];
      v_out[g] = Conv<VT>::from(V[K + p]);
      if (HAS_CARRY) carry_out[g] = Conv<CT>::from(C[K + p]);
    }
  }
}

struct Args {
  const void *u, *ulo, *uhi, *v, *vlo, *vhi, *carry;
  void *u_out, *v_out, *carry_out;
  const void *c2, *c2lo, *c2hi, *syz, *rsyz, *sxct;
  void *dmax, *rmax;
  int d, n, py, ny, y0, bx, tx, ty, tz;
  float coeff, ix, iy, iz;
};

template <int K, int TX, typename VT, typename CT, bool HAS_CARRY>
int launch_comp(const Args& a, cudaStream_t stream) {
  auto kern = kstep_comp_chain_kernel<K, TX, VT, CT, HAS_CARRY>;
  const int cols = (a.ty + 2 * K) * (a.tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > kConeThreads) return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * (a.tx + 2 * K) * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + a.tz - 1) / a.tz, (a.ny + a.ty - 1) / a.ty,
                  a.d / a.tx);
  const Chain<float> u{static_cast<const float*>(a.ulo),
                       static_cast<const float*>(a.u),
                       static_cast<const float*>(a.uhi)};
  const Chain<VT> v{static_cast<const VT*>(a.vlo),
                    static_cast<const VT*>(a.v),
                    static_cast<const VT*>(a.vhi)};
  const Chain<float> c2{static_cast<const float*>(a.c2lo),
                        static_cast<const float*>(a.c2),
                        static_cast<const float*>(a.c2hi)};
  kern<<<grid, threads, shmem, stream>>>(
      u, v, static_cast<const CT*>(a.carry), static_cast<float*>(a.u_out),
      static_cast<VT*>(a.v_out), static_cast<CT*>(a.carry_out), c2,
      static_cast<const float*>(a.syz), static_cast<const float*>(a.rsyz),
      static_cast<const float*>(a.sxct), static_cast<unsigned*>(a.dmax),
      static_cast<unsigned*>(a.rmax), a.d, a.n, a.py, a.ny, a.y0, a.bx, a.tx,
      a.ty, a.tz, a.coeff, a.ix, a.iy, a.iz);
  return (int)cudaGetLastError();
}

// K4's storage modes, each with the tile depth fixed at compile time when
// it is kMaxTx and read at run time otherwise.
template <int K>
int launch_comp_mode(int v_dtype, int carry_dtype, const Args& a,
                     cudaStream_t st) {
#define WT_COMP(VT, CT, HC)                                         \
  return a.tx == kMaxTx ? launch_comp<K, kMaxTx, VT, CT, HC>(a, st) \
                        : launch_comp<K, 0, VT, CT, HC>(a, st)
  if (v_dtype == WT_F32 && carry_dtype == WT_BF16)
    WT_COMP(float, __nv_bfloat16, true);
  if (v_dtype == WT_F32 && carry_dtype == WT_F32) WT_COMP(float, float, true);
  if (v_dtype == WT_F32 && carry_dtype == WT_NONE)
    WT_COMP(float, float, false);
  if (v_dtype == WT_BF16 && carry_dtype == WT_NONE)
    WT_COMP(__nv_bfloat16, float, false);
#undef WT_COMP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K11 (py == ny == n, y0 = 0) and K12 (py == ny + 2k, 0 <= y0 < n).  u f32
// and v (f32 or bf16): the block (d, py, n) and its (k, py, n) x windows;
// the carry (null, or f32/bf16 with an f32 v) and every output are the
// central (d, ny, n) rows.  c2 is the f32 (d, py, n) field block with
// (k, py, n) f32 windows, or null.  dmax/rmax are (k, d) uint32 rows zeroed
// by the caller, or null (then syz, rsyz - the central (ny, n) oracle
// planes - and sxct (k, d) are not read).  1 <= k <= 8; tx <= 8 divides
// bx, bx divides d.
int wt_kstep_comp_chain(const void* u, const void* ulo, const void* uhi,
                        const void* v, const void* vlo, const void* vhi,
                        const void* carry, void* u_out, void* v_out,
                        void* carry_out, const void* c2, const void* c2lo,
                        const void* c2hi, const void* syz, const void* rsyz,
                        const void* sxct, void* dmax, void* rmax, int d,
                        int n, int py, int ny, int y0, int k, int bx, int tx,
                        int ty, int tz, int v_dtype, int carry_dtype,
                        double coeff, double ix, double iy, double iz,
                        void* stream) {
  const bool whole = py == ny && ny == n && y0 == 0;
  const bool ext = py == ny + 2 * k && y0 >= 0 && y0 < n;
  if (tx < 1 || tx > kMaxTx || bx % tx || d % bx || k < 1 || k > 8 ||
      ny < 1 || !(whole || ext) || ty < 1 || tz < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{u, ulo, uhi, v, vlo, vhi, carry,
               u_out, v_out, carry_out,
               c2, c2lo, c2hi, syz, rsyz, sxct,
               dmax, rmax,
               d, n, py, ny, y0, bx, tx, ty, tz,
               (float)coeff, (float)ix, (float)iy, (float)iz};
#define WT_K(KK) \
  case KK:       \
    return launch_comp_mode<KK>(v_dtype, carry_dtype, a, st)
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

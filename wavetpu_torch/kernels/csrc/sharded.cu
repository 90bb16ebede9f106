// The sharded kernels: hand-written Hopper (sm_90a) counterparts of the
// Pallas kernels that wavetpu's multi-shard solvers launch on every shard
// (wavetpu/kernels/stencil_pallas.py):
//
//   K6  sharded_step_kernel     <- _sharded_kernel (sharded_fused_step)
//   K7  sharded_comp_kernel     <- _sharded_comp_kernel
//                                  (sharded_compensated_step)
//
// (The k-step kernels of a shard block - K8, K9 and K10 - are
// csrc/kstep_pipe.cu's pipeline; K11 and K12 are csrc/comp_sharded.cu's.)
// Built by wavetpu_torch/kernels/build.py beside the other sources (one
// nvcc per source, started together), with --fmad=false: each kernel is op
// for op the single-device kernel it extends (K6 = K1/K5, K7 = K2), so a
// sharded solve equals the single-device solve bit for bit.  Wrappers,
// plain PyTorch versions and launch counters:
// wavetpu_torch/kernels/stencil_cuda.py.
//
// Layout: one shard's block, z contiguous.  K6's lane mode (the sharded
// ensemble's batch axis, wavetpu's vmap inside ensemble/sharded.py's
// shard_map) takes `lanes` blocks side by side, (lanes, bx, by, bz), and
// each ghost as (lanes, face) - one copy per face for every lane
// (comm/halo.collect_ghosts with lanes); block z is lane * bx + x, and a
// lane's cells run the solo kernel's op sequence (constant speed only; a
// compile-time mode, so the solo kernels carry none of it).  Every entry
// point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// K6 / K7: the 1-step kernels on a shard block (bx, by, bz).
//
// On an axis whose mesh dim is > 1 the face neighbours of the block's edge
// planes come from ghost planes received from the neighbour shard (the
// pointers of `Halo`, shaped (1, by, bz), (bx, 1, bz), (bx, by, 1)); a
// null ghost means the mesh dim is 1 and the block wraps onto itself (the
// global neighbour: periodic x, the stored zero Dirichlet plane in y/z).
// On an unevenly sharded axis the caller has written the last shard's hi
// ghost into its first pad plane (comm/halo.py absorb_hi_ghosts), so the
// +1 neighbour of the last real plane is read from the block.
//
// The store is masked by global index (`in_domain`, the Pallas kernel's
// _global_mask): y and z index != 0 always, and index < N on each axis
// that carries pad planes.
//
// Bound: bytes, as K1/K2: 12 B/cell for K6 f32 (u and u_prev read, out
// written; 16 with a field), 24 for K7 f32.  Design: K1's, one thread per
// cell in a 32 (z) x 8 (y) block per x plane; the ghost planes are read in
// place of the wrapped neighbour at the block faces only.

template <typename T>
struct Halo {
  const T* xlo;
  const T* xhi;
  const T* ylo;
  const T* yhi;
  const T* zlo;
  const T* zhi;
};

// The block's extent, its global offset, the global N and the axes that
// carry pad planes.
struct Geom {
  int bx, by, bz;
  int ox, oy, oz;
  int n;
  int padx, pady, padz;
};

__device__ __forceinline__ bool in_domain(const Geom& g, int x, int y,
                                          int z) {
  const int gx = g.ox + x, gy = g.oy + y, gz = g.oz + z;
  return gy != 0 && gz != 0 && (!g.padx || gx < g.n) &&
         (!g.pady || gy < g.n) && (!g.padz || gz < g.n);
}

// The Laplacian of cell (x, y, z) (flat index e) in the Pallas summation
// order, K1's: ((xm + xp - 2c)*ix + (ym + yp - 2c)*iy) + (zm + zp - 2c)*iz.
template <typename T, typename F>
__device__ __forceinline__ F ghost_laplacian(const T* __restrict__ u,
                                             const Halo<T>& h, const Geom& g,
                                             int x, int y, int z, int64_t e,
                                             F c, F ix, F iy, F iz) {
  const int64_t pl = (int64_t)g.by * g.bz;
  const int64_t yz = (int64_t)y * g.bz + z;  // index in an x ghost
  const int64_t xz = (int64_t)x * g.bz + z;  // in a y ghost
  const int64_t xy = (int64_t)x * g.by + y;  // in a z ghost
  const T xm = x > 0 ? u[e - pl] : h.xlo ? h.xlo[yz] : u[e + (g.bx - 1) * pl];
  const T xp = x < g.bx - 1 ? u[e + pl]
               : h.xhi     ? h.xhi[yz]
                           : u[e - (g.bx - 1) * pl];
  const T ym = y > 0 ? u[e - g.bz]
               : h.ylo ? h.ylo[xz]
                       : u[e + (int64_t)(g.by - 1) * g.bz];
  const T yp = y < g.by - 1 ? u[e + g.bz]
               : h.yhi     ? h.yhi[xz]
                           : u[e - (int64_t)(g.by - 1) * g.bz];
  const T zm = z > 0 ? u[e - 1] : h.zlo ? h.zlo[xy] : u[e + g.bz - 1];
  const T zp = z < g.bz - 1 ? u[e + 1] : h.zhi ? h.zhi[xy] : u[e - g.bz + 1];
  F lap = (Conv<T>::to(xm) + Conv<T>::to(xp) - F(2) * c) * ix;
  lap = lap + (Conv<T>::to(ym) + Conv<T>::to(yp) - F(2) * c) * iy;
  lap = lap + (Conv<T>::to(zm) + Conv<T>::to(zp) - F(2) * c) * iz;
  return lap;
}

constexpr int kRowThreads = 32, kColThreads = 8;  // 1-step block: (z, y)

// K6: out = alpha*u + coeff*lap(u) - beta*u_prev (beta term only if
// use_beta), or with FIELD the block's field cell in place of coeff and
// (alpha, beta) = (2, 1): K1's and K5's body, masked by in_domain.
template <typename T, bool FIELD, bool LANES>
__global__ void sharded_step_kernel(const T* __restrict__ uprev,
                                    const T* __restrict__ u,
                                    T* __restrict__ out,
                                    const typename Conv<T>::F* __restrict__ c2,
                                    Halo<T> h, Geom g,
                                    typename Conv<T>::F alpha,
                                    typename Conv<T>::F beta,
                                    typename Conv<T>::F coeff,
                                    typename Conv<T>::F ix,
                                    typename Conv<T>::F iy,
                                    typename Conv<T>::F iz, int use_beta) {
  using F = typename Conv<T>::F;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  int x = blockIdx.z;
  if (z >= g.bz || y >= g.by) return;
  if (LANES) {  // block z = lane * bx + x; offsets into the lane's block
    const int lane = blockIdx.z / g.bx;
    x = blockIdx.z - lane * g.bx;
    const int64_t blk = (int64_t)lane * g.bx * g.by * g.bz;
    uprev += blk;
    u += blk;
    out += blk;
    const int64_t fx = (int64_t)lane * g.by * g.bz,
                  fy = (int64_t)lane * g.bx * g.bz,
                  fz = (int64_t)lane * g.bx * g.by;
    if (h.xlo) h.xlo += fx, h.xhi += fx;
    if (h.ylo) h.ylo += fy, h.yhi += fy;
    if (h.zlo) h.zlo += fz, h.zhi += fz;
  }
  const int64_t e = ((int64_t)x * g.by + y) * g.bz + z;
  const F c = Conv<T>::to(u[e]);
  const F lap = ghost_laplacian<T, F>(u, h, g, x, y, z, e, c, ix, iy, iz);
  F o = alpha * c + (FIELD ? c2[e] : coeff) * lap;
  if (use_beta) o = o - beta * Conv<T>::to(uprev[e]);
  out[e] = Conv<T>::from(in_domain(g, x, y, z) ? o : F(0));
}

// K7: K2's Kahan update on a shard block; d and the stored u are masked
// (the block's pad plane may hold an absorbed ghost).
template <typename T>
__global__ void sharded_comp_kernel(const T* __restrict__ u,
                                    const T* __restrict__ v,
                                    const T* __restrict__ carry,
                                    T* __restrict__ u_out,
                                    T* __restrict__ v_out,
                                    T* __restrict__ carry_out, Halo<T> h,
                                    Geom g, T coeff, T ix, T iy, T iz) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= g.bz || y >= g.by) return;
  const int64_t e = ((int64_t)x * g.by + y) * g.bz + z;
  const T c = u[e];
  const T lap = ghost_laplacian<T, T>(u, h, g, x, y, z, e, c, ix, iy, iz);
  const bool in = in_domain(g, x, y, z);
  const T d = in ? coeff * lap : T(0);
  const T vn = v[e] + d;
  const T yy = vn - carry[e];
  const T t = c + yy;
  u_out[e] = in ? t : T(0);
  v_out[e] = vn;
  carry_out[e] = (t - c) - yy;
}

dim3 grid_block(const Geom& g, int lanes) {
  return dim3((g.bz + kRowThreads - 1) / kRowThreads,
              (g.by + kColThreads - 1) / kColThreads, g.bx * lanes);
}

template <typename T>
Halo<T> halo_of(const void* xlo, const void* xhi, const void* ylo,
                const void* yhi, const void* zlo, const void* zhi) {
  return Halo<T>{static_cast<const T*>(xlo), static_cast<const T*>(xhi),
                 static_cast<const T*>(ylo), static_cast<const T*>(yhi),
                 static_cast<const T*>(zlo), static_cast<const T*>(zhi)};
}

}  // namespace

extern "C" {

// K6 with a null c2; with c2 (the block's field in the compute dtype: f64
// for an f64 state, else f32) the variable-speed body, launched with
// (alpha, beta) = (2, 1).  Ghost pointers are null on axes whose mesh dim
// is 1; pad flags are 1 on axes that carry pad planes.  `lanes` > 1 is
// the lane mode (constant speed: c2 null): `lanes` blocks and ghosts side
// by side, in instantiations of their own.
int wt_sharded_step(const void* uprev, const void* u, void* out,
                    const void* c2, const void* xlo, const void* xhi,
                    const void* ylo, const void* yhi, const void* zlo,
                    const void* zhi, int bx, int by, int bz, int ox, int oy,
                    int oz, int n, int padx, int pady, int padz, int dtype,
                    double alpha, double beta, double coeff, double ix,
                    double iy, double iz, int use_beta, int lanes,
                    void* stream) {
  if (bx < 1 || by < 1 || bz < 1 || lanes < 1 ||
      (int64_t)bx * lanes > 65535 || (lanes > 1 && c2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{bx, by, bz, ox, oy, oz, n, padx, pady, padz};
  const dim3 grid = grid_block(g, lanes), block(kRowThreads, kColThreads);
#define WT_STEP_L(T, F, FIELD, LANES)                                        \
  sharded_step_kernel<T, FIELD, LANES><<<grid, block, 0, st>>>(              \
      static_cast<const T*>(uprev), static_cast<const T*>(u),                \
      static_cast<T*>(out), static_cast<const F*>(c2),                       \
      halo_of<T>(xlo, xhi, ylo, yhi, zlo, zhi), g, (F)alpha, (F)beta,        \
      (F)coeff, (F)ix, (F)iy, (F)iz, use_beta)
#define WT_STEP(T, F)                                                        \
  if (lanes > 1)                                                             \
    WT_STEP_L(T, F, false, true);                                            \
  else if (c2)                                                               \
    WT_STEP_L(T, F, true, false);                                            \
  else                                                                       \
    WT_STEP_L(T, F, false, false)
  switch (dtype) {
    case WT_F32:
      WT_STEP(float, float);
      break;
    case WT_F64:
      WT_STEP(double, double);
      break;
    case WT_BF16:
      WT_STEP(__nv_bfloat16, float);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WT_STEP
#undef WT_STEP_L
  return (int)cudaGetLastError();
}

// K7: f32 or f64 u, v and carry of one dtype; ghosts and pads as K6.
int wt_sharded_comp_step(const void* u, const void* v, const void* carry,
                         void* u_out, void* v_out, void* carry_out,
                         const void* xlo, const void* xhi, const void* ylo,
                         const void* yhi, const void* zlo, const void* zhi,
                         int bx, int by, int bz, int ox, int oy, int oz,
                         int n, int padx, int pady, int padz, int dtype,
                         double coeff, double ix, double iy, double iz,
                         void* stream) {
  if (bx < 1 || by < 1 || bz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{bx, by, bz, ox, oy, oz, n, padx, pady, padz};
  const dim3 grid = grid_block(g, 1), block(kRowThreads, kColThreads);
#define WT_COMP(T)                                                           \
  sharded_comp_kernel<T><<<grid, block, 0, st>>>(                            \
      static_cast<const T*>(u), static_cast<const T*>(v),                    \
      static_cast<const T*>(carry), static_cast<T*>(u_out),                  \
      static_cast<T*>(v_out), static_cast<T*>(carry_out),                    \
      halo_of<T>(xlo, xhi, ylo, yhi, zlo, zhi), g, (T)coeff, (T)ix, (T)iy,   \
      (T)iz)
  switch (dtype) {
    case WT_F32:
      WT_COMP(float);
      break;
    case WT_F64:
      WT_COMP(double);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WT_COMP
  return (int)cudaGetLastError();
}

}  // extern "C"

// The sharded kernels: hand-written Hopper (sm_90a) counterparts of the
// Pallas kernels that wavetpu's multi-shard solvers launch on every shard
// (wavetpu/kernels/stencil_pallas.py):
//
//   K6  sharded_step_kernel     <- _sharded_kernel (sharded_fused_step)
//   K7  sharded_comp_kernel     <- _sharded_comp_kernel
//                                  (sharded_compensated_step)
//   K9  kstep_chain_kernel      <- _kstep_padded_kernel (fused_kstep_padded)
//
// (K8, _kstep_sharded_kernel, is csrc/kstep_pipe.cu's pipeline.)  Built by
// wavetpu_torch/kernels/build.py beside the other sources (one nvcc per
// source, started together), with --fmad=false: each kernel is op for op
// the single-device kernel it extends (K6 = K1/K5, K7 = K2, K9 = K3), so a
// sharded solve equals the single-device solve bit for bit.  Wrappers, plain PyTorch versions and launch counters:
// wavetpu_torch/kernels/stencil_cuda.py.
//
// Layout: one shard's block, z contiguous.  Every entry point launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

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
template <typename T, bool FIELD>
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
  const int x = blockIdx.z;
  if (z >= g.bz || y >= g.by) return;
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

dim3 grid_block(const Geom& g) {
  return dim3((g.bz + kRowThreads - 1) / kRowThreads,
              (g.by + kColThreads - 1) / kColThreads, g.bx);
}

// ---------------------------------------------------------------------------
// K9: k leapfrog substeps of an uneven (pad-and-mask) x-sharded block
// (D, N, N), y and z whole.  The x neighbours of the block come from
// k-plane ghost windows: each field's x "chain" is
//   lo ghost (k planes) | block planes [0, n_real) | hi ghost (k planes) | 0
// so the x-neighbour chain of every real plane is gap-free and nothing
// wraps.  K9 passes the shard's real-plane count: its planes past n_real
// are pad, whose outputs and error rows are stored as zero - the chain is
// the TPU kernel's extended array [lo | D planes with hi spliced at n_real
// | junk] read in place, so no extended copy is assembled.  (With n_real =
// D this is K8, which csrc/kstep_pipe.cu's pipeline runs instead.)  A field
// (f32) has its own chain of the same layout (its ghosts exchanged once per
// solve by the caller).
//
// Each substep is op for op K3's (csrc/kstep_pipe.cu, itself K1's update):
//   new = mask((2u + coeff*lap(u)) - u_prev), a bf16 state rounded to bf16
// and back, so a sharded k-fused solve equals the single-device one bit
// for bit.  Error rows (k, D) per substep and x plane with the cone
// kernels' protocol (csrc/common.cuh rows_reduce / rows_flush), restricted
// to real planes.
//
// Bound: bytes.  Per launch u_prev and u read once and the block's two
// last layers written once, 16 B/cell for f32 (20 with a field), plus the
// 4k ghost planes.  Design: a cone tile (common.cuh `Cone`, the column in
// registers, y/z through shared memory), with the chain lookup in place of
// an x wrap.

// Where chain plane xu of a column lies: 0 lo ghost, 1 block, 2 hi ghost,
// 3 past the hi ghost (zero); `g` is the cell's index in that array.
__device__ __forceinline__ int chain_at(int xu, int k, int n_real, int64_t nn,
                                        int64_t row, int64_t& g) {
  if (xu < 0) {
    g = (int64_t)(xu + k) * nn + row;
    return 0;
  }
  if (xu < n_real) {
    g = (int64_t)xu * nn + row;
    return 1;
  }
  g = (int64_t)(xu - n_real) * nn + row;
  return xu < n_real + k ? 2 : 3;
}

template <typename T>
__device__ __forceinline__ float chain_read(const T* __restrict__ lo,
                                            const T* __restrict__ blk,
                                            const T* __restrict__ hi,
                                            int where, int64_t g) {
  if (where == 3) return 0.0f;
  const T* src = where == 0 ? lo : (where == 1 ? blk : hi);
  return Conv<T>::to(src[g]);
}

template <int K, int TX, typename T>
__global__ void __launch_bounds__(kConeThreads)
kstep_chain_kernel(const T* __restrict__ uprev, const T* __restrict__ u,
                   const T* __restrict__ plo, const T* __restrict__ phi,
                   const T* __restrict__ clo, const T* __restrict__ chi,
                   T* __restrict__ prev_out, T* __restrict__ out,
                   const float* __restrict__ c2,
                   const float* __restrict__ c2lo,
                   const float* __restrict__ c2hi,
                   const float* __restrict__ syz,
                   const float* __restrict__ rsyz,
                   const float* __restrict__ sxct,
                   unsigned* __restrict__ dmax, unsigned* __restrict__ rmax,
                   int d, int n, int n_real, int tx_arg, int ty, int tz,
                   float coeff, float ix, float iy, float iz) {
  constexpr int kEx = (TX > 0 ? TX : kMaxTx) + 2 * K;  // register column
  const int tx = TX > 0 ? TX : tx_arg;
  extern __shared__ float plane[];  // [2][ex][ey * ez]
  __shared__ RowMax emax;
  const Cone cn = cone_of_thread(K, tx, ty, tz, n);
  // The tile's real output planes: stores and rows past them are zero.
  const int tx_real = min(tx, max(n_real - cn.x1, 0));
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
      int64_t g;
      const int w = chain_at(cn.x1 - K + x, K, n_real, cn.nn, cn.row, g);
      P[x] = chain_read(plo, uprev, phi, w, g);
      U[x] = chain_read(clo, u, chi, w, g);
    }
  }

#pragma unroll
  for (int s = 1; s <= K; ++s) {
    float* pl = plane + (s & 1) * cn.ex * cn.cols;
    publish_column(pl, U, cn);
    __syncthreads();
    if (errors && s > 1)
      rows_flush(emax, dmax, rmax, s - 1, d, cn, tx_real);
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
          float co = coeff;
          if (c2) {
            int64_t g;
            const int w =
                chain_at(cn.x1 - K + x, K, n_real, cn.nn, cn.row, g);
            co = chain_read(c2lo, c2, c2hi, w, g);
          }
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
    if (errors)
      rows_reduce<K>(emax, U, sxct, s, d, cn, tx_real, syz_c, rsyz_c);
  }
  if (errors) {
    __syncthreads();
    rows_flush(emax, dmax, rmax, K, d, cn, tx_real);
  }
  if (!cn.central) return;
#pragma unroll
  for (int p = 0; p < kMaxTx; ++p) {
    if (p < tx) {
      const int64_t g = out_index(cn, p);
      const bool real = p < tx_real;
      prev_out[g] = Conv<T>::from(real ? P[K + p] : 0.0f);
      out[g] = Conv<T>::from(real ? U[K + p] : 0.0f);
    }
  }
}

template <int K, int TX, typename T>
int launch_chain(const void* uprev, const void* u, const void* plo,
                 const void* phi, const void* clo, const void* chi,
                 void* prev_out, void* out, const void* c2, const void* c2lo,
                 const void* c2hi, const void* syz, const void* rsyz,
                 const void* sxct, void* dmax, void* rmax, int d, int n,
                 int n_real, int tx, int ty, int tz, float coeff, float ix,
                 float iy, float iz, cudaStream_t stream) {
  auto kern = kstep_chain_kernel<K, TX, T>;
  const int cols = (ty + 2 * K) * (tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > kConeThreads) return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * (tx + 2 * K) * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + tz - 1) / tz, (n + ty - 1) / ty, d / tx);
  kern<<<grid, threads, shmem, stream>>>(
      static_cast<const T*>(uprev), static_cast<const T*>(u),
      static_cast<const T*>(plo), static_cast<const T*>(phi),
      static_cast<const T*>(clo), static_cast<const T*>(chi),
      static_cast<T*>(prev_out), static_cast<T*>(out),
      static_cast<const float*>(c2), static_cast<const float*>(c2lo),
      static_cast<const float*>(c2hi), static_cast<const float*>(syz),
      static_cast<const float*>(rsyz), static_cast<const float*>(sxct),
      static_cast<unsigned*>(dmax), static_cast<unsigned*>(rmax), d, n,
      n_real, tx, ty, tz, coeff, ix, iy, iz);
  return (int)cudaGetLastError();
}

// The tile depth fixed at compile time when it is kMaxTx, read at run time
// otherwise.
template <int K, typename T>
int launch_chain_tx(const void* uprev, const void* u, const void* plo,
                    const void* phi, const void* clo, const void* chi,
                    void* prev_out, void* out, const void* c2,
                    const void* c2lo, const void* c2hi, const void* syz,
                    const void* rsyz, const void* sxct, void* dmax,
                    void* rmax, int d, int n, int n_real, int tx, int ty,
                    int tz, float coeff, float ix, float iy, float iz,
                    cudaStream_t st) {
  return tx == kMaxTx
             ? launch_chain<K, kMaxTx, T>(uprev, u, plo, phi, clo, chi,
                                          prev_out, out, c2, c2lo, c2hi, syz,
                                          rsyz, sxct, dmax, rmax, d, n,
                                          n_real, tx, ty, tz, coeff, ix, iy,
                                          iz, st)
             : launch_chain<K, 0, T>(uprev, u, plo, phi, clo, chi, prev_out,
                                     out, c2, c2lo, c2hi, syz, rsyz, sxct,
                                     dmax, rmax, d, n, n_real, tx, ty, tz,
                                     coeff, ix, iy, iz, st);
}

template <int K>
int launch_chain_dtype(int dtype, const void* uprev, const void* u,
                       const void* plo, const void* phi, const void* clo,
                       const void* chi, void* prev_out, void* out,
                       const void* c2, const void* c2lo, const void* c2hi,
                       const void* syz, const void* rsyz, const void* sxct,
                       void* dmax, void* rmax, int d, int n, int n_real,
                       int tx, int ty, int tz, float coeff, float ix,
                       float iy, float iz, cudaStream_t st) {
  if (dtype == WT_F32)
    return launch_chain_tx<K, float>(uprev, u, plo, phi, clo, chi, prev_out,
                                     out, c2, c2lo, c2hi, syz, rsyz, sxct,
                                     dmax, rmax, d, n, n_real, tx, ty, tz,
                                     coeff, ix, iy, iz, st);
  if (dtype == WT_BF16)
    return launch_chain_tx<K, __nv_bfloat16>(
        uprev, u, plo, phi, clo, chi, prev_out, out, c2, c2lo, c2hi, syz,
        rsyz, sxct, dmax, rmax, d, n, n_real, tx, ty, tz, coeff, ix, iy, iz,
        st);
  return (int)cudaErrorInvalidValue;
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
// is 1; pad flags are 1 on axes that carry pad planes.
int wt_sharded_step(const void* uprev, const void* u, void* out,
                    const void* c2, const void* xlo, const void* xhi,
                    const void* ylo, const void* yhi, const void* zlo,
                    const void* zhi, int bx, int by, int bz, int ox, int oy,
                    int oz, int n, int padx, int pady, int padz, int dtype,
                    double alpha, double beta, double coeff, double ix,
                    double iy, double iz, int use_beta, void* stream) {
  if (bx < 1 || by < 1 || bz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{bx, by, bz, ox, oy, oz, n, padx, pady, padz};
  const dim3 grid = grid_block(g), block(kRowThreads, kColThreads);
#define WT_STEP(T, F)                                                        \
  {                                                                          \
    const Halo<T> h = halo_of<T>(xlo, xhi, ylo, yhi, zlo, zhi);              \
    if (c2)                                                                  \
      sharded_step_kernel<T, true><<<grid, block, 0, st>>>(                  \
          static_cast<const T*>(uprev), static_cast<const T*>(u),            \
          static_cast<T*>(out), static_cast<const F*>(c2), h, g, (F)alpha,   \
          (F)beta, (F)coeff, (F)ix, (F)iy, (F)iz, use_beta);                 \
    else                                                                     \
      sharded_step_kernel<T, false><<<grid, block, 0, st>>>(                 \
          static_cast<const T*>(uprev), static_cast<const T*>(u),            \
          static_cast<T*>(out), nullptr, h, g, (F)alpha, (F)beta, (F)coeff,  \
          (F)ix, (F)iy, (F)iz, use_beta);                                    \
  }
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
  const dim3 grid = grid_block(g), block(kRowThreads, kColThreads);
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

// K9 (n_real <= d; stencil_cuda launches K8 on kstep_pipe.cu's pipeline).
// State f32 or bf16 for the block (d, n, n), its (k, n, n) ghost windows
// and both outputs; c2 is the f32 (d, n, n) field block with (k, n, n) f32
// ghosts, or null; dmax/rmax are (k, d) uint32 rows zeroed by the caller,
// or null (then syz, rsyz and sxct are not read).  1 <= k <= 8; tx <= 8 divides d; 1 <= n_real <= d.
int wt_kstep_chain(const void* uprev, const void* u, const void* plo,
                   const void* phi, const void* clo, const void* chi,
                   void* prev_out, void* out, const void* c2,
                   const void* c2lo, const void* c2hi, const void* syz,
                   const void* rsyz, const void* sxct, void* dmax,
                   void* rmax, int d, int n, int n_real, int k, int tx,
                   int ty, int tz, int dtype, double coeff, double ix,
                   double iy, double iz, void* stream) {
  if (tx < 1 || tx > kMaxTx || d % tx || k < 1 || k > 8 || n_real < 1 ||
      n_real > d || ty < 1 || tz < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c = (float)coeff, fx = (float)ix, fy = (float)iy,
              fz = (float)iz;
#define WT_K(KK)                                                             \
  case KK:                                                                   \
    return launch_chain_dtype<KK>(dtype, uprev, u, plo, phi, clo, chi,       \
                                  prev_out, out, c2, c2lo, c2hi, syz, rsyz,  \
                                  sxct, dmax, rmax, d, n, n_real, tx, ty,    \
                                  tz, c, fx, fy, fz, st)
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

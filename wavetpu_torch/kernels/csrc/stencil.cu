// Hand-written Hopper (sm_90a) kernels for the wave-equation stencil: the
// CUDA counterparts of the Pallas kernels in wavetpu/kernels/stencil_pallas.py.
//
// Built by wavetpu_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
//        -Xcompiler -fPIC
// into a library with a plain C interface, loaded with ctypes
// (wavetpu_torch/kernels/stencil_cuda.py holds the wrappers, the plain
// PyTorch version of each kernel and the launch counters).  --fmad=false
// keeps every multiply and add separately rounded, so each kernel repeats
// its plain version's arithmetic bit for bit.
//
// Layout: the fundamental (N, N, N) domain, z contiguous.  x wraps
// (periodic); y/z wrap onto the stored zero Dirichlet plane, and the
// y=0 / z=0 planes of every update are masked to zero.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch (too many threads, too much shared memory) raises in Python.

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

// One cell of the 1-step kernels: its flat index, its six wrapped
// neighbours, and whether it lies on a stored Dirichlet plane.  The
// kernels run a (z, y) thread block per x plane, so no index is divided.
struct Cell {
  int64_t c, xm, xp, ym, yp, zm, zp;
  bool interior;
};

__device__ __forceinline__ bool cell_of_thread(int n, Cell& e) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;
  if (z >= n || y >= n) return false;
  const int64_t nn = (int64_t)n * n;
  const int64_t pl = (int64_t)x * nn, row = (int64_t)y * n;
  e.c = pl + row + z;
  e.xm = (int64_t)(x == 0 ? n - 1 : x - 1) * nn + row + z;
  e.xp = (int64_t)(x == n - 1 ? 0 : x + 1) * nn + row + z;
  e.ym = pl + (int64_t)(y == 0 ? n - 1 : y - 1) * n + z;
  e.yp = pl + (int64_t)(y == n - 1 ? 0 : y + 1) * n + z;
  e.zm = pl + row + (z == 0 ? n - 1 : z - 1);
  e.zp = pl + row + (z == n - 1 ? 0 : z + 1);
  e.interior = y != 0 && z != 0;
  return true;
}

// Pallas summation order (stencil_pallas._slab_laplacian):
// ((xlo + xhi - 2c) * ix + (ylo + yhi - 2c) * iy) + (zlo + zhi - 2c) * iz.
template <typename T, typename F>
__device__ __forceinline__ F laplacian(const T* __restrict__ u, const Cell& e,
                                       F c, F ix, F iy, F iz) {
  F lap = (Conv<T>::to(u[e.xm]) + Conv<T>::to(u[e.xp]) - F(2) * c) * ix;
  lap = lap + (Conv<T>::to(u[e.ym]) + Conv<T>::to(u[e.yp]) - F(2) * c) * iy;
  lap = lap + (Conv<T>::to(u[e.zm]) + Conv<T>::to(u[e.zp]) - F(2) * c) * iz;
  return lap;
}

constexpr int kRowThreads = 32, kColThreads = 8;  // 1-step block: (z, y)

dim3 grid_1step(int n) {
  return dim3((n + kRowThreads - 1) / kRowThreads,
              (n + kColThreads - 1) / kColThreads, n);
}

// ---------------------------------------------------------------------------
// K1: the 1-step stencil.
// Replaces stencil_pallas._step_kernel (through _fused_step; the entry
// points leapfrog_step / taylor_half_step / make_step_fn):
//   out = alpha*u + coeff*lap(u) - beta*u_prev   (beta term only if beta!=0)
// with the y=0 / z=0 planes masked.  (2, 1, a2tau2) is leapfrog,
// (1, 0, a2tau2/2) the Taylor half-step.
// Bound: bytes.  12 B/cell for f32 (u and u_prev read once, out written
// once); the 7-point re-reads of u are served by L1/L2.  Design: one
// thread per cell, a 32 (z) x 8 (y) block per x plane, so every load and
// the store coalesce along z and no index is divided.
template <typename T>
__global__ void step_kernel(const T* __restrict__ uprev,
                            const T* __restrict__ u, T* __restrict__ out,
                            int n, typename Conv<T>::F alpha,
                            typename Conv<T>::F beta,
                            typename Conv<T>::F coeff,
                            typename Conv<T>::F ix, typename Conv<T>::F iy,
                            typename Conv<T>::F iz, int use_beta) {
  using F = typename Conv<T>::F;
  Cell e;
  if (!cell_of_thread(n, e)) return;
  const F c = Conv<T>::to(u[e.c]);
  const F lap = laplacian<T, F>(u, e, c, ix, iy, iz);
  F o = alpha * c + coeff * lap;
  if (use_beta) o = o - beta * Conv<T>::to(uprev[e.c]);
  out[e.c] = Conv<T>::from(e.interior ? o : F(0));
}

// ---------------------------------------------------------------------------
// K2: the 1-step compensated (Kahan) step.
// Replaces stencil_pallas._comp_step_kernel (entry point compensated_step):
//   d = mask(coeff*lap(u)); v' = v + d;
//   y = v' - carry; t = u + y; carry' = (t - u) - y;   u' = t.
// The Dirichlet mask applies to d only.
// Bound: bytes.  24 B/cell for f32 (u, v, carry read; u', v', carry'
// written).  Design: as K1.
template <typename T>
__global__ void comp_step_kernel(const T* __restrict__ u,
                                 const T* __restrict__ v,
                                 const T* __restrict__ carry,
                                 T* __restrict__ u_out, T* __restrict__ v_out,
                                 T* __restrict__ carry_out, int n, T coeff,
                                 T ix, T iy, T iz) {
  Cell e;
  if (!cell_of_thread(n, e)) return;
  const T c = u[e.c];
  const T lap = laplacian<T, T>(u, e, c, ix, iy, iz);
  const T d = e.interior ? coeff * lap : T(0);
  const T vn = v[e.c] + d;
  const T yy = vn - carry[e.c];
  const T t = c + yy;
  u_out[e.c] = t;
  v_out[e.c] = vn;
  carry_out[e.c] = (t - c) - yy;
}

// ---------------------------------------------------------------------------
// K4: k fused velocity-form (compensated) substeps.
// Replaces stencil_pallas._kstep_comp_kernel (entry point fused_kstep_comp).
// Each substep is K2's update in f32: v' = v + mask(coeff*lap(u)),
// y = v' - carry, t = u + y, carry' = (t - u) - y (carry-less: y = v').
// u and v ride a cone that shrinks one cell per side per substep; the
// carry's x-halo planes start at ZERO (they lie outside the block_x-aligned
// slab the TPU kernel holds) while its y/z halo cells are loaded from
// memory (the TPU kernel holds whole y/z planes), so for the same block_x
// the result is the TPU kernel's.  Per substep s the kernel also emits the
// per-x-plane error maxes of the central cells,
//   dmax[s-1, x] = max_{y,z} |t - sxct[s-1, x] * syz[y, z]|
//   rmax[s-1, x] = max_{y,z} |t - sxct[s-1, x] * syz[y, z]| * rsyz[y, z]
// combined with max on the bits of a non-negative float (unsigned order =
// float order, and a NaN - bits above +inf - wins, as jnp.max propagates
// it; fmaxf would drop it): a warp reduction, a shared atomicMax per warp,
// a global atomicMax per tile.
// Bound: bytes.  Per launch u and v are read and written once and the
// carry read and written once (20 B/cell for f32 u/v + bf16 carry) however
// many substeps run.  Design: a tile of tx (x) * ty (y) * tz (z) output
// cells; its cone, (tx+2k)(ty+2k)(tz+2k) cells, has one thread per (y, z)
// column, which keeps the column's u, v and carry in registers (the x
// neighbours are the thread's own registers).  Each substep publishes u to
// shared memory for the y/z neighbours (double-buffered, one barrier per
// substep), then updates the column inside the shrinking cone.  The
// redundant cone work is the price of keeping intermediate layers out of
// device memory; streaming x through a pipeline would remove it.
constexpr int kMaxTx = 8;
constexpr int kConeThreads = 640;  // stencil_cuda._K4_MAX_THREADS

// TX is the tile depth when known at compile time (kMaxTx, the usual case:
// every predicate on the column length folds away), 0 for a run-time tx.
// The fixed-depth instantiation doubles the build but is the faster one;
// kernels/tile_ab.py times the two against each other (PERF.md).
template <int K, int TX, typename VT, typename CT, bool HAS_CARRY>
__global__ void __launch_bounds__(kConeThreads)
kstep_comp_kernel(const float* __restrict__ u, const VT* __restrict__ v,
                  const CT* __restrict__ carry, float* __restrict__ u_out,
                  VT* __restrict__ v_out, CT* __restrict__ carry_out,
                  const float* __restrict__ syz,
                  const float* __restrict__ rsyz,
                  const float* __restrict__ sxct,
                  unsigned* __restrict__ dmax, unsigned* __restrict__ rmax,
                  int n, int bx, int tx_arg, int ty, int tz, float coeff,
                  float ix, float iy, float iz) {
  constexpr int kEx = (TX > 0 ? TX : kMaxTx) + 2 * K;  // register column
  const int tx = TX > 0 ? TX : tx_arg;
  extern __shared__ float plane[];      // [2][ex][ey * ez]
  __shared__ unsigned emax[2][2][kMaxTx];  // [substep parity][abs|rel][x]
  const int ex = tx + 2 * K, ey = ty + 2 * K, ez = tz + 2 * K;
  const int cols = ey * ez;
  const int tid = threadIdx.x;
  const bool live = tid < cols;        // the block is padded to whole warps
  const int lz = live ? tid % ez : 0;
  const int ly = live ? tid / ez : 0;
  const int x1 = blockIdx.z * tx, y1 = blockIdx.y * ty, z1 = blockIdx.x * tz;
  const int xb0 = (x1 / bx) * bx;  // the block_x slab this tile lies in
  const int gy = wrap(y1 - K + ly, n), gz = wrap(z1 - K + lz, n);
  const bool interior = gy != 0 && gz != 0;
  const int64_t nn = (int64_t)n * n;
  const int64_t row = (int64_t)gy * n + gz;
  // Central column: its cells are this tile's outputs.
  const bool central = live && ly >= K && ly < K + ty && lz >= K &&
                       lz < K + tz && y1 + ly - K < n && z1 + lz - K < n;
  const bool errors = dmax != nullptr;
  float syz_c = 0.0f, rsyz_c = 0.0f;
  if (errors && central) {
    syz_c = syz[row];
    rsyz_c = rsyz[row];
  }
  if (tid < 2 * 2 * kMaxTx) (&emax[0][0][0])[tid] = 0u;

  float U[kEx], V[kEx], C[kEx];
#pragma unroll
  for (int x = 0; x < kEx; ++x) {
    U[x] = V[x] = C[x] = 0.0f;
    if (live && x < ex) {
      const int xu = x1 - K + x;  // unwrapped x
      const int64_t g = (int64_t)wrap(xu, n) * nn + row;
      U[x] = u[g];
      V[x] = Conv<VT>::to(v[g]);
      if (HAS_CARRY && xu >= xb0 && xu < xb0 + bx) C[x] = Conv<CT>::to(carry[g]);
    }
  }

#pragma unroll
  for (int s = 1; s <= K; ++s) {
    float* pl = plane + (s & 1) * ex * cols;
    if (live) {
#pragma unroll
      for (int x = 0; x < kEx; ++x)
        if (x < ex) pl[x * cols + tid] = U[x];
    }
    __syncthreads();
    if (errors && s > 1 && tid < 2 * kMaxTx && (tid % kMaxTx) < tx) {
      // Flush substep s-1's per-plane maxes (all its warps passed the
      // barrier above) and clear them for substep s+1.
      const int which = tid / kMaxTx, p = tid % kMaxTx;
      unsigned* rows = which ? rmax : dmax;
      atomicMax(&rows[(int64_t)(s - 2) * n + x1 + p],
                emax[(s - 1) & 1][which][p]);
      emax[(s - 1) & 1][which][p] = 0u;
    }
    if (live && ly >= s && ly < ey - s && lz >= s && lz < ez - s) {
      float left = U[s - 1];
#pragma unroll
      for (int x = 1; x < kEx - 1; ++x) {
        if (x >= s && x < ex - s) {
          const float c = U[x];
          const int i = x * cols + tid;
          float lap = (left + U[x + 1] - 2.0f * c) * ix;
          lap = lap + (pl[i - ez] + pl[i + ez] - 2.0f * c) * iy;
          lap = lap + (pl[i - 1] + pl[i + 1] - 2.0f * c) * iz;
          const float d = interior ? coeff * lap : 0.0f;
          const float vn = V[x] + d;
          const float yy = HAS_CARRY ? vn - C[x] : vn;
          const float t = c + yy;
          if (HAS_CARRY) C[x] = (t - c) - yy;
          V[x] = vn;
          left = c;
          U[x] = t;
        }
      }
    }
    // Warps without a central column skip the reduction (warp-uniform).
    if (errors && __any_sync(0xffffffffu, central)) {
#pragma unroll
      for (int p = 0; p < kMaxTx; ++p) {
        if (p >= tx) break;  // uniform across the block
        unsigned db = 0u, rb = 0u;
        if (central) {
          const float diff = fabsf(
              U[K + p] - sxct[(int64_t)(s - 1) * n + x1 + p] * syz_c);
          db = __float_as_uint(diff);
          rb = __float_as_uint(fabsf(diff * rsyz_c));
        }
        db = __reduce_max_sync(0xffffffffu, db);
        rb = __reduce_max_sync(0xffffffffu, rb);
        if ((tid & 31) == 0) {
          atomicMax(&emax[s & 1][0][p], db);
          atomicMax(&emax[s & 1][1][p], rb);
        }
      }
    }
  }
  if (errors) {
    __syncthreads();
    if (tid < 2 * kMaxTx && (tid % kMaxTx) < tx) {
      const int which = tid / kMaxTx, p = tid % kMaxTx;
      unsigned* rows = which ? rmax : dmax;
      atomicMax(&rows[(int64_t)(K - 1) * n + x1 + p], emax[K & 1][which][p]);
    }
  }
  if (!central) return;
#pragma unroll
  for (int p = 0; p < kMaxTx; ++p) {
    if (p < tx) {
      const int64_t g = (int64_t)(x1 + p) * nn + row;
      u_out[g] = U[K + p];
      v_out[g] = Conv<VT>::from(V[K + p]);
      if (HAS_CARRY) carry_out[g] = Conv<CT>::from(C[K + p]);
    }
  }
}

template <int K, int TX, typename VT, typename CT, bool HAS_CARRY>
int launch_kstep(const void* u, const void* v, const void* carry,
                 void* u_out, void* v_out, void* carry_out, const void* syz,
                 const void* rsyz, const void* sxct, void* dmax, void* rmax,
                 int n, int bx, int tx, int ty, int tz, float coeff,
                 float ix, float iy, float iz, cudaStream_t stream) {
  auto kern = kstep_comp_kernel<K, TX, VT, CT, HAS_CARRY>;
  const int cols = (ty + 2 * K) * (tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > kConeThreads) return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * (tx + 2 * K) * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + tz - 1) / tz, (n + ty - 1) / ty, n / tx);
  kern<<<grid, threads, shmem, stream>>>(
      static_cast<const float*>(u), static_cast<const VT*>(v),
      static_cast<const CT*>(carry), static_cast<float*>(u_out),
      static_cast<VT*>(v_out), static_cast<CT*>(carry_out),
      static_cast<const float*>(syz), static_cast<const float*>(rsyz),
      static_cast<const float*>(sxct), static_cast<unsigned*>(dmax),
      static_cast<unsigned*>(rmax), n, bx, tx, ty, tz, coeff, ix, iy, iz);
  return (int)cudaGetLastError();
}

// Storage modes of K4 (the flagship's): f32 v with a bf16 or f32 carry, or
// no carry with an f32 or bf16 v.
template <int K>
int launch_kstep_mode(int v_dtype, int carry_dtype, const void* u,
                      const void* v, const void* carry, void* u_out,
                      void* v_out, void* carry_out, const void* syz,
                      const void* rsyz, const void* sxct, void* dmax,
                      void* rmax, int n, int bx, int tx, int ty, int tz,
                      float coeff, float ix, float iy, float iz,
                      cudaStream_t st) {
#define WT_KSTEP(VT, CT, HC)                                                 \
  return tx == kMaxTx                                                        \
             ? launch_kstep<K, kMaxTx, VT, CT, HC>(                          \
                   u, v, carry, u_out, v_out, carry_out, syz, rsyz, sxct,    \
                   dmax, rmax, n, bx, tx, ty, tz, coeff, ix, iy, iz, st)     \
             : launch_kstep<K, 0, VT, CT, HC>(                               \
                   u, v, carry, u_out, v_out, carry_out, syz, rsyz, sxct,    \
                   dmax, rmax, n, bx, tx, ty, tz, coeff, ix, iy, iz, st)
  if (v_dtype == WT_F32 && carry_dtype == WT_BF16)
    WT_KSTEP(float, __nv_bfloat16, true);
  if (v_dtype == WT_F32 && carry_dtype == WT_F32) WT_KSTEP(float, float, true);
  if (v_dtype == WT_F32 && carry_dtype == WT_NONE)
    WT_KSTEP(float, float, false);
  if (v_dtype == WT_BF16 && carry_dtype == WT_NONE)
    WT_KSTEP(__nv_bfloat16, float, false);
#undef WT_KSTEP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int wt_step(const void* uprev, const void* u, void* out, int n, int dtype,
            double alpha, double beta, double coeff, double ix, double iy,
            double iz, int use_beta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_1step(n), block(kRowThreads, kColThreads);
  switch (dtype) {
    case WT_F32:
      step_kernel<float><<<grid, block, 0, st>>>(
          static_cast<const float*>(uprev), static_cast<const float*>(u),
          static_cast<float*>(out), n, (float)alpha, (float)beta,
          (float)coeff, (float)ix, (float)iy, (float)iz, use_beta);
      break;
    case WT_F64:
      step_kernel<double><<<grid, block, 0, st>>>(
          static_cast<const double*>(uprev), static_cast<const double*>(u),
          static_cast<double*>(out), n, alpha, beta, coeff, ix, iy, iz,
          use_beta);
      break;
    case WT_BF16:
      step_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
          static_cast<const __nv_bfloat16*>(uprev),
          static_cast<const __nv_bfloat16*>(u),
          static_cast<__nv_bfloat16*>(out), n, (float)alpha, (float)beta,
          (float)coeff, (float)ix, (float)iy, (float)iz, use_beta);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int wt_comp_step(const void* u, const void* v, const void* carry,
                 void* u_out, void* v_out, void* carry_out, int n, int dtype,
                 double coeff, double ix, double iy, double iz,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_1step(n), block(kRowThreads, kColThreads);
  switch (dtype) {
    case WT_F32:
      comp_step_kernel<float><<<grid, block, 0, st>>>(
          static_cast<const float*>(u), static_cast<const float*>(v),
          static_cast<const float*>(carry), static_cast<float*>(u_out),
          static_cast<float*>(v_out), static_cast<float*>(carry_out), n,
          (float)coeff, (float)ix, (float)iy, (float)iz);
      break;
    case WT_F64:
      comp_step_kernel<double><<<grid, block, 0, st>>>(
          static_cast<const double*>(u), static_cast<const double*>(v),
          static_cast<const double*>(carry), static_cast<double*>(u_out),
          static_cast<double*>(v_out), static_cast<double*>(carry_out), n,
          coeff, ix, iy, iz);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// u f32; (v, carry) f32/bf16, f32/f32, f32/none or bf16/none (WT_NONE and
// null pointers for no carry).  dmax/rmax are (k, n) uint32 rows zeroed by
// the caller, or null.  1 <= k <= 8; tx <= 8 divides bx, bx divides n.
int wt_kstep_comp(const void* u, const void* v, const void* carry,
                  void* u_out, void* v_out, void* carry_out, const void* syz,
                  const void* rsyz, const void* sxct, void* dmax, void* rmax,
                  int n, int k, int bx, int tx, int ty, int tz, int v_dtype,
                  int carry_dtype, double coeff, double ix, double iy,
                  double iz, void* stream) {
  if (tx < 1 || tx > kMaxTx || bx % tx || n % bx || ty < 1 || tz < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c = (float)coeff, fx = (float)ix, fy = (float)iy,
              fz = (float)iz;
#define WT_K(KK)                                                             \
  case KK:                                                                   \
    return launch_kstep_mode<KK>(v_dtype, carry_dtype, u, v, carry, u_out,   \
                                 v_out, carry_out, syz, rsyz, sxct, dmax,    \
                                 rmax, n, bx, tx, ty, tz, c, fx, fy, fz, st)
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

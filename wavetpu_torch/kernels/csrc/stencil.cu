// Hand-written Hopper (sm_90a) kernels for the wave-equation stencil: the
// CUDA counterparts of the Pallas kernels in wavetpu/kernels/stencil_pallas.py.
// This file holds K1 and K5 (1-step) and K2 (1-step compensated); K3 (the
// k-step) runs kstep_pipe.cu's pipeline and K4 (the compensated k-step)
// comp_sharded.cu's, each over the whole domain.
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
// Lane mode (the ensemble's batch axis, wavetpu's `jax.vmap` over these
// kernels in ensemble/batched.py): `lanes` states of (N, N, N) side by side,
// (lanes, N, N, N) contiguous, each lane's field beside it for K5.  Block z
// is lane * N + x, so a lane's cells run the solo kernel's op sequence on
// that lane's planes: each lane equals the solo launch on it bit for bit.
// The lane mode is a compile-time parameter (the solo kernels carry none
// of it); lanes * N must fit the grid's z extent (65535).  Every 1-step
// kernel is held to 32 registers (`__launch_bounds__`: eight 256-thread
// blocks per SM).  An in-thread loop over the lanes instead took 52-80
// registers and ran at 0.57x the speed of the solo launches
// (chip_smoke.py phase 9, NVIDIA H100 80GB HBM3, 700 W).
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch (too many threads, too much shared memory) raises in Python.

#include "common.cuh"

namespace {

// One cell of the 1-step kernels: its flat index, its six wrapped
// neighbours, and whether it lies on a stored Dirichlet plane.  The
// kernels run a (z, y) thread block per x plane, so no index is divided.
struct Cell {
  int64_t c, xm, xp, ym, yp, zm, zp;
  bool interior;
};

// The lane of a block and its x plane: block z is lane * n + x in the lane
// mode (LANES), x in the solo kernels.  Returns the lane's offset into a
// (lanes, n, n, n) batch.  `magic` = ceil(2^32 / n) (`lane_magic`) turns
// the division by n into a multiply-high, exact for block z < 2^16 and
// 2 <= n < 2^16.  With an integer division in every thread K1's lane
// mode ran at 0.816x of eight solo launches, with the multiply-high at
// 0.903x (chip_smoke.py phase 9, N=512, NVIDIA H100 80GB HBM3, 700 W).
template <bool LANES>
__device__ __forceinline__ int64_t lane_plane(int n, unsigned magic, int& x) {
  if (!LANES) {
    x = blockIdx.z;
    return 0;
  }
  const int lane = __umulhi(blockIdx.z, magic);
  x = blockIdx.z - lane * n;
  return (int64_t)lane * n * n * n;
}

__device__ __forceinline__ bool cell_of_thread(int n, int x, Cell& e) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
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

// Blocks of one SM at 32 registers a thread.
constexpr int kStepBlocksPerSM = 8;

dim3 grid_1step(int n, int lanes) {
  return dim3((n + kRowThreads - 1) / kRowThreads,
              (n + kColThreads - 1) / kColThreads, n * lanes);
}

bool lanes_fit(int n, int lanes) {
  return lanes == 1 || (lanes > 1 && n >= 2 && (int64_t)n * lanes <= 65535);
}

unsigned lane_magic(int n, int lanes) {
  return lanes > 1 ? (unsigned)((((uint64_t)1 << 32) + n - 1) / n) : 0u;
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
//
// K5 (FIELD): the variable-speed step, replacing
// stencil_pallas._var_step_kernel (through _fused_step(c2tau2_field=) /
// make_step_fn(c2tau2_field=)):
//   out = (2u + c2tau2[cell]*lap(u)) - u_prev
// the same body with the field's cell in place of coeff, launched with
// (alpha, beta) = (2, 1): 1*u_prev is exact, so it is K1's arithmetic, and
// the k-fused var-c substep (K3's field operand) repeats it.  Bound: bytes,
// 16 B/cell for f32 (the field is one more read).
template <typename T, bool FIELD, bool LANES>
__global__ void __launch_bounds__(kRowThreads * kColThreads, kStepBlocksPerSM)
step_kernel(const T* __restrict__ uprev, const T* __restrict__ u,
            T* __restrict__ out, const typename Conv<T>::F* __restrict__ c2,
            int n, typename Conv<T>::F alpha, typename Conv<T>::F beta,
            typename Conv<T>::F coeff, typename Conv<T>::F ix,
            typename Conv<T>::F iy, typename Conv<T>::F iz, int use_beta,
            unsigned magic) {
  using F = typename Conv<T>::F;
  int x;
  const int64_t lo = lane_plane<LANES>(n, magic, x);
  Cell e;
  if (!cell_of_thread(n, x, e)) return;
  uprev += lo;
  u += lo;
  out += lo;
  if (FIELD) c2 += lo;
  const F c = Conv<T>::to(u[e.c]);
  const F lap = laplacian<T, F>(u, e, c, ix, iy, iz);
  F o = alpha * c + (FIELD ? c2[e.c] : coeff) * lap;
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
template <typename T, bool LANES>
__global__ void __launch_bounds__(kRowThreads * kColThreads, kStepBlocksPerSM)
comp_step_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 const T* __restrict__ carry, T* __restrict__ u_out,
                 T* __restrict__ v_out, T* __restrict__ carry_out, int n,
                 T coeff, T ix, T iy, T iz, unsigned magic) {
  int x;
  const int64_t lo = lane_plane<LANES>(n, magic, x);
  Cell e;
  if (!cell_of_thread(n, x, e)) return;
  u += lo;
  v += lo;
  carry += lo;
  u_out += lo;
  v_out += lo;
  carry_out += lo;
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

}  // namespace

extern "C" {

const char* wt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// K1 with a null c2; K5 with the (n, n, n) field c2 in the compute dtype
// (f64 for an f64 state, else f32) and (alpha, beta) = (2, 1).  `lanes`
// states (and fields) of (n, n, n) side by side; 1 is the solo launch.
int wt_step(const void* uprev, const void* u, void* out, const void* c2,
            int n, int dtype, double alpha, double beta, double coeff,
            double ix, double iy, double iz, int use_beta, int lanes,
            void* stream) {
  if (!lanes_fit(n, lanes)) return (int)cudaErrorInvalidValue;
  const unsigned magic = lane_magic(n, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_1step(n, lanes), block(kRowThreads, kColThreads);
#define WT_STEP_L(T, F, FIELD, LANES)                                        \
  step_kernel<T, FIELD, LANES><<<grid, block, 0, st>>>(                      \
      static_cast<const T*>(uprev), static_cast<const T*>(u),                \
      static_cast<T*>(out), static_cast<const F*>(c2), n, (F)alpha,          \
      (F)beta, (F)coeff, (F)ix, (F)iy, (F)iz, use_beta, magic)
#define WT_STEP(T, F)                                                        \
  if (c2 && lanes > 1)                                                       \
    WT_STEP_L(T, F, true, true);                                             \
  else if (c2)                                                               \
    WT_STEP_L(T, F, true, false);                                            \
  else if (lanes > 1)                                                        \
    WT_STEP_L(T, F, false, true);                                            \
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

int wt_comp_step(const void* u, const void* v, const void* carry,
                 void* u_out, void* v_out, void* carry_out, int n, int dtype,
                 double coeff, double ix, double iy, double iz, int lanes,
                 void* stream) {
  if (!lanes_fit(n, lanes)) return (int)cudaErrorInvalidValue;
  const unsigned magic = lane_magic(n, lanes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_1step(n, lanes), block(kRowThreads, kColThreads);
#define WT_COMP(T, LANES)                                                    \
  comp_step_kernel<T, LANES><<<grid, block, 0, st>>>(                        \
      static_cast<const T*>(u), static_cast<const T*>(v),                    \
      static_cast<const T*>(carry), static_cast<T*>(u_out),                  \
      static_cast<T*>(v_out), static_cast<T*>(carry_out), n, (T)coeff,       \
      (T)ix, (T)iy, (T)iz, magic)
  switch (dtype) {
    case WT_F32:
      if (lanes > 1)
        WT_COMP(float, true);
      else
        WT_COMP(float, false);
      break;
    case WT_F64:
      if (lanes > 1)
        WT_COMP(double, true);
      else
        WT_COMP(double, false);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WT_COMP
  return (int)cudaGetLastError();
}

}  // extern "C"

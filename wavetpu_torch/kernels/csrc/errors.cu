// The per-layer error pass of the 1-step marches: the L-inf absolute and
// relative error of a layer against the separable closed form, in one
// read of the layer.
//
// Replaces no Pallas kernel: wavetpu takes these maxima in one XLA-fused
// pass (wavetpu/solver/leapfrog.py `_error_fn` -> verify/oracle.py
// `layer_errors`).  The port ran that pass as about eight full-field
// PyTorch passes a layer (the analytic product, sub, abs, abs, div,
// nan_to_num, two amax, two slot copies), four times K1's device time on
// the default path; this kernel is their fusion
// (stencil_cuda.layer_errors, counter `layer_errors`; its plain version
// oracle.separable_layer_errors is that composition).
//
// For every cell (i, j, k) of a strided (nx, ny, nz) view u (z contiguous)
// and the 1-D factors fx, fy, fz of the view's planes, rows and columns:
//   f = ((fx[i] * fy[j]) * fz[k]) * ct
//   d = |u - f|,   r = d / |f|   (0/0 and any NaN in r -> 0; inf kept)
// and the maxima of d and r, in the compute dtype (f32 for bf16 state):
// the plain version's multiply order, each product separately rounded
// (--fmad=false), IEEE division.  A NaN in u reaches the abs maximum and
// not the relative one, as amax and nan_to_num(nan=0) have it.
//
// Bound: bytes.  4 B a cell for f32 state (u read once; the factors are
// three rows of nz floats), 2 B for bf16, 8 for f64; about 6 flops a cell
// against the card's ~20 flops a byte.  Design:
// - one warp a row (i, j), rows strided over a grid sized to fill the
//   card (the occupancy API's blocks per SM x SMs), so a block's launch
//   and its epilogue are paid once per ~30 rows, not per row;
// - fx[i]*fy[j] is formed once per row in a register; fz is read through
//   the read-only path (one row, held in L1 by every warp of the SM);
// - each lane loads kUnroll = 8 cells, 32 apart, before it uses any: a
//   warp has eight coalesced 128-byte loads in flight (the interior rows
//   start at z = 1, so no row is 16-byte aligned; scalar loads need no
//   peeling, and the sector each misaligned load shares with the next is
//   served by L2).  At N=512 f32 four loads a lane took 0.2020 ms, eight
//   0.1904 ms against the bound's 0.1593 (NVIDIA H100 80GB HBM3, 700 W);
//   an exact division taken only where an approximate quotient could pass
//   the lane's maximum saved another 1.3% there (but 20% on bf16 state)
//   and was left out: the main path's bits would rest on the
//   approximation's error bound;
// - the maxima are kept as the bits of the non-negative values: an
//   unsigned compare orders them, and fabs gives a positive NaN, whose
//   bits lie above +inf's, so NaN wins as amax's NaN does.  Max is order
//   free: the result is the plain version's, whatever the order of the
//   blocks;
// - a warp shuffle, a block maximum in shared memory, then one atomicMax
//   per block and value on the bits of the output slot.  The slots must
//   hold 0 (+0.0) before the launch: the solvers' error vectors are
//   allocated zeroed and each layer's slot is written once; the wrapper
//   zeroes a fresh pair where the caller gives none.
//
// Built as the other sources (kernels/build.py: nvcc -O3 --fmad=false,
// sm_90a, a plain C interface loaded with ctypes); the entry point
// launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // eight warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // loads in flight per lane

template <typename F>
struct Bits;

template <>
struct Bits<float> {
  using U = unsigned int;
  static __device__ __forceinline__ U of(float x) { return __float_as_uint(x); }
  static __device__ __forceinline__ float mag(float x) { return fabsf(x); }
};

template <>
struct Bits<double> {
  using U = unsigned long long;
  static __device__ __forceinline__ U of(double x) {
    return (U)__double_as_longlong(x);
  }
  static __device__ __forceinline__ double mag(double x) { return fabs(x); }
};

template <typename U>
__device__ __forceinline__ U umax(U a, U b) {
  return a > b ? a : b;
}

template <typename U>
__device__ __forceinline__ U warp_max(U v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = umax(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_errors_kernel(const T* __restrict__ u, int nx, int ny, int nz,
                    int64_t stride_x, int64_t stride_y,
                    const typename Conv<T>::F* __restrict__ fx,
                    const typename Conv<T>::F* __restrict__ fy,
                    const typename Conv<T>::F* __restrict__ fz,
                    const typename Conv<T>::F* __restrict__ ct_at,
                    typename Conv<T>::F* abs_out,
                    typename Conv<T>::F* rel_out) {
  using F = typename Conv<T>::F;
  using B = Bits<F>;
  using U = typename B::U;
  const F ct = __ldg(ct_at);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t rows = (int64_t)nx * ny;
  const int64_t step = (int64_t)gridDim.x * kWarps;
  U dmax = 0, rmax = 0;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < rows;
       row += step) {
    const int i = (int)(row / ny), j = (int)(row - (int64_t)i * ny);
    const F sxy = __ldg(fx + i) * __ldg(fy + j);
    const T* ur = u + i * stride_x + j * stride_y;
    for (int k0 = lane; k0 < nz; k0 += 32 * kUnroll) {
      T v[kUnroll];
      F z[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int k = k0 + 32 * q;
        if (k < nz) {
          v[q] = ur[k];
          z[q] = __ldg(fz + k);
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (k0 + 32 * q < nz) {
          const F f = (sxy * z[q]) * ct;
          const F d = B::mag(Conv<T>::to(v[q]) - f);
          F r = d / B::mag(f);
          if (r != r) r = F(0);
          dmax = umax(dmax, B::of(d));
          rmax = umax(rmax, B::of(r));
        }
      }
    }
  }
  __shared__ U sd[kWarps], sr[kWarps];
  dmax = warp_max(dmax);
  rmax = warp_max(rmax);
  if (lane == 0) {
    sd[warp] = dmax;
    sr[warp] = rmax;
  }
  __syncthreads();
  if (warp == 0) {
    dmax = lane < kWarps ? sd[lane] : U(0);
    rmax = lane < kWarps ? sr[lane] : U(0);
    dmax = warp_max(dmax);
    rmax = warp_max(rmax);
    if (lane == 0) {
      atomicMax(reinterpret_cast<U*>(abs_out), dmax);
      atomicMax(reinterpret_cast<U*>(rel_out), rmax);
    }
  }
}

// Blocks of one launch: as many as the card holds at once (the occupancy
// API's blocks per SM, once per instantiation, times the SMs of the
// current device), or one per kWarps rows if fewer.
template <typename T>
cudaError_t grid_for(int64_t rows, int* grid) {
  static int per_sm = 0;
  cudaError_t e = cudaSuccess;
  if (per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_errors_kernel<T>, kThreads, 0);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t need = (rows + kWarps - 1) / kWarps;
  const int64_t full = (int64_t)per_sm * sms;
  *grid = (int)(need < full ? need : full);
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" {

// The maxima of one layer's errors into abs_out / rel_out (each one value
// of the compute dtype, holding 0): u a (nx, ny, nz) view with strides
// (stride_x, stride_y, 1) in elements, fx / fy / fz its factors (nx, ny
// and nz values of the compute dtype), ct_at the time factor on the
// device.  dtype: WT_F32 (f32 state and compute), WT_BF16 (bf16 state,
// f32 compute), WT_F64.
int wt_layer_errors(const void* u, int nx, int ny, int nz, int64_t stride_x,
                    int64_t stride_y, const void* fx, const void* fy,
                    const void* fz, const void* ct_at, void* abs_out,
                    void* rel_out, int dtype, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = (int64_t)nx * ny;
#define WT_ERRORS(T, F)                                                      \
  {                                                                          \
    int grid = 0;                                                            \
    const cudaError_t e = grid_for<T>(rows, &grid);                          \
    if (e != cudaSuccess) return (int)e;                                     \
    layer_errors_kernel<T><<<grid, kThreads, 0, st>>>(                       \
        static_cast<const T*>(u), nx, ny, nz, stride_x, stride_y,            \
        static_cast<const F*>(fx), static_cast<const F*>(fy),                \
        static_cast<const F*>(fz), static_cast<const F*>(ct_at),             \
        static_cast<F*>(abs_out), static_cast<F*>(rel_out));                 \
  }
  switch (dtype) {
    case WT_F32:
      WT_ERRORS(float, float);
      break;
    case WT_F64:
      WT_ERRORS(double, double);
      break;
    case WT_BF16:
      WT_ERRORS(__nv_bfloat16, float);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WT_ERRORS
  return (int)cudaGetLastError();
}

}  // extern "C"

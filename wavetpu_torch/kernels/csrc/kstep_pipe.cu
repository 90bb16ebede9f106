// K3, K8, K9 and K10: k standard leapfrog substeps of the whole state or
// of one shard block - the hand-written Hopper (sm_90a) counterparts of
// wavetpu's Pallas kernels (wavetpu/kernels/stencil_pallas.py):
//
//   K3   kstep_pipe_kernel, d == n, windows = the state's own wrap planes
//                                          <- _kstep_kernel (fused_kstep),
//                                             field: _field_onion
//   K8   kstep_pipe_kernel, d == n / MX    <- _kstep_sharded_kernel
//                                             (fused_kstep_sharded),
//                                             field: _sharded_field_onion
//   K9   kstep_pipe_kernel, n_real <= d    <- _kstep_padded_kernel
//                                             (fused_kstep_padded),
//                                             field: ext_c2
//   K10  kstep_pipe_kernel, py == ny + 2k  <- _kstep_sharded_xy_kernel
//                                             (fused_kstep_sharded_xy),
//                                             field: _sharded_field_onion
//
// u_prev and u (and a field) reach their x neighbours through the chain
// lo window | block[:n_real] | hi window | zero, read in place
// (`pad_chain_pos`): K8's windows are the x neighbour shards' k-plane
// ghost windows, K3's the state's own last and first k planes (views, no
// copy), so K3 is K8 over the whole state.  K9, the pad-and-mask block of
// an uneven x split, owns n_real real planes: its hi window follows plane
// n_real - 1, the chain is zero past it, and its outputs and error rows
// are zero at the pad planes (the TPU kernel's extended array [lo | block
// with hi spliced at n_real | junk], with no extended copy); K3, K8 and
// K10 pass n_real = d.  The y mode is read at run time (csrc/plane.cuh
// `plane_cone`, as comp_sharded.cu's): whole y rows that wrap (K3, K8,
// K9), or K10's block extended by k ghost rows per y side (py == ny + 2k)
// with central outputs and the wrapped global-row mask.
//
// Each substep is op for op K1's update (csrc/stencil.cu, step_kernel with
// (alpha, beta) = (2, 1)):
//   o = 2u + coeff*lap(u); o = o - u_prev; o = mask(o)
// with lap = ((xm + xp - 2u)*ix + (ym + yp - 2u)*iy) + (zm + zp - 2u)*iz
// (plane.cuh `cone_laplacian`; 1*u_prev is exact, so K1's `- beta*u_prev`
// is the same bits), and with a field the cell's c2tau2 in place of coeff
// (K5's update).  A bf16 state rounds every substep to bf16 (round to
// nearest even) and back, as the 1-step path stores every layer.  Built
// with --fmad=false, so a k-fused solve equals the 1-step solve bit for bit
// and the kernel equals its plain version (stencil_cuda.fused_kstep_plain,
// _kstep_chain_plain) bit for bit.  Every cell's substeps are a function of
// the inputs alone (no carry), so no slab enters and the result does not
// depend on the tile.
//
// Bound: bytes.  Per launch u_prev and u (and their windows) read once and
// (u_{n+k-1}, u_{n+k}) written once: 16 B per output cell for f32, 8 for
// bf16, plus 4 for an f32 field (K10: plus the 2k extension rows read).
//
// Design: the standard-scheme counterpart of comp_sharded.cu's x-streaming
// pipeline (K4, K11, K12).  A block owns a (ty x tz) y/z output face and an
// x segment of L planes, and walks x through the segment's L + 2k chain
// planes, one plane per step, as a wavefront of k stages: at step t stage 0
// takes chain plane t (the incoming u_prev, u and field cells), and stage s
// (1..k) makes plane t - s from stage s-1's planes t-s-1, t-s and t-s+1
// (t-s+1 made in this very step: the stages run in order inside the step).
// One thread per (y, z) column of the (ty+2k)(tz+2k) halo face:
//   * u's x neighbours are the thread's own registers - per stage the last
//     three planes it made (`W`, slot = step mod 3).  Beside them ride
//     u_prev of the stage's current plane (`P`, where K4 carries v) and its
//     field cell (`F`), two slots each (step mod 2).  Stage s takes
//     c = W[s-1] as its u and P[s-1] as its u_prev, and hands (new, c)
//     forward as stage s+1's (u, u_prev): no carry, no slab.  Registers
//     scale with k, not with the segment: L is only the loop's trip count.
//   * The y/z neighbours come from shared memory: each stage publishes its
//     plane into its own two-slot ring [k][2][cols], read one step later,
//     so one barrier per step orders everything.  A stage computes only the
//     columns inside a face that shrinks by one cell per side per stage.
//   * The chain is resolved once per incoming plane, and the field is read
//     once as its plane enters, not at every substep.
//   * Loads: each thread loads the next plane's cells of its own column one
//     step ahead into registers, kept as stored (a bf16 cell is widened
//     only when stage 0 takes it).
// Against the cone kernels it replaces (K3's, K8's, K9's and K10's before:
// a tile of at most 8 x planes, the column's u_prev and u for all 8 + 2k
// planes in registers, a 640-thread block; the field looked up through the
// chain per cell and substep), at k=4, L=128 (the default at N=512,
// stencil_cuda.kstep_pipe_tile) and a 24x24 face: x loads 1.06x the output
// planes instead of 2x, the y/z halo 1.78x instead of 2.5x, and the
// substeps' work ~1.3x instead of ~2.2x.
// Longer segments also shorten the pipeline's fill and drain (2k of the
// L + 2k steps run fewer than k stages).
//
// Error rows per (substep, x plane), as comp_sharded.cu's: a warp max on
// the float bits into the warp's own shared slot, then after the next
// step's barrier one warp per (substep, abs|rel) reduces the slots and adds
// one atomicMax per block into the caller's zeroed (k, d) rows (max on the
// bits of non-negative floats: a NaN wins); K9's pad planes add nothing,
// so their rows stay zero.
//
// Lane mode (K3 and K3f only: the ensemble's batch axis, wavetpu's vmap
// of fused_kstep in ensemble/batched.py): `lanes` whole states side by
// side, every chain array, output and field lane-major with one lane
// stride (the windows are views of the same batch), and per-lane oracle
// rows sxct and error rows (lanes, k, d).  Block z is lane * segments +
// segment, so a lane's blocks run the solo launch's op sequence on that
// lane: each lane equals the solo launch bit for bit.  The lane's offset
// is folded into the column's cell offsets once, before the pipeline, in
// instantiations of their own (the solo ones compile as before).
//
// Built by wavetpu_torch/kernels/build.py with --fmad=false, beside the
// other sources: 8 k x {f32, bf16} x field on/off x {solo, pad, lanes} =
// 96 instantiations (the pad mode is K9's with n_real < d; the lane mode
// K3's with lanes > 1, a compile-time mode, so the solo kernels carry
// none of it).  The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().  Wrappers, plain PyTorch
// versions and launch counters: stencil_cuda.fused_kstep,
// fused_kstep_sharded, fused_kstep_padded and fused_kstep_sharded_xy; the
// tile: stencil_cuda.kstep_pipe_tile.

#include "plane.cuh"

// The longest segment (the oracle rows of a segment sit in shared memory)
// and the largest k.
constexpr int kStdMaxSeg = 128;
constexpr int kStdMaxK = 8;

// Shared memory of a block, declared at file scope so that every access is
// a shared-space access: the stages' u rings [k][2][cols] (dynamic), the
// warps' error maxima [step parity][stage][abs|rel][warp] and the
// segment's oracle rows sxct[stage][plane].
extern __shared__ float std_ring[];
__shared__ unsigned std_wmax[2][kStdMaxK][2][32];
__shared__ float std_sx[kStdMaxK][kStdMaxSeg];

namespace {

// Threads per block (one per halo-face column): 1024 for k <= 4, fewer
// above, where the per-stage registers (u x3, u_prev x2, field x2) add up
// (stencil_cuda.pipe_max_threads).
// Where chain plane xu (-k <= xu < d + k) of a column at plane offset `row`
// lies in the chain lo window | block[:n_real] | hi window | zero: 0 the lo
// window, 1 the block, 2 the hi window, 3 past it (a zero cell); `g` is the
// cell's index in that array.  With n_real == d it is plane.cuh's
// `chain_pos`.
__device__ __forceinline__ int pad_chain_pos(int xu, int k, int n_real,
                                             int64_t nn, int64_t row,
                                             int64_t& g) {
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

template <int K>
struct StdThreads {
  static constexpr int value = K <= 4 ? 1024 : 640;
};

template <int PH>
struct StdPhase {};

// One thread's pipeline: its column, its operands and its registers.  PAD
// (K9) reads the chain through `pad_chain_pos` and zeroes the planes past
// n_real; without it the chain is plane.cuh's `chain_pos` over the d
// planes, so K3's, K8's and K10's instantiations carry none of it (a
// run-time n_real costs them 4 registers at k=4 and makes the field form
// spill).
template <int K, typename T, bool HF, bool PAD>
struct StdPipe {
  Chain<T> up;  // u_prev
  Chain<T> u;
  Chain<float> c2;
  T* prev_out;
  T* out;
  unsigned* dmax;
  unsigned* rmax;
  PlaneCone pc;
  int d, L;
  int n_real;  // the block's real planes: outputs and rows past them are 0
  int reach;  // the last stage whose face holds this column (-1: padding)
  float coeff, ix, iy, iz, syz_c, rsyz_c;
  bool errors;  // error rows are wanted and this warp holds a central cell

  float W[K][3];  // u of stage s at the planes it made in the last 3 steps
  float P[K][2];  // u_prev and field cell of stage s's last 2 planes
  float F[K][2];
  // The incoming plane's cells as stored: converted where stage 0 takes
  // them, a step after the load, so no thread waits for its load.
  T nu, np;
  float nf;

  // Load chain plane j (x = x0 - K + j) of this column into nu, np, nf.
  __device__ __forceinline__ void load(int j) {
    const Cone& cn = pc.c;
    if (!cn.live) return;
    int64_t g;
    const int w =
        PAD ? pad_chain_pos(cn.x1 - K + j, K, n_real, cn.nn, cn.row, g)
            : chain_pos(cn.x1 - K + j, K, d, cn.nn, cn.row, g);
    if (PAD && w == 3) {
      nu = np = Conv<T>::from(0.0f);
      nf = 0.0f;
      return;
    }
    nu = (w == 0 ? u.lo : (w == 1 ? u.blk : u.hi))[g];
    np = (w == 0 ? up.lo : (w == 1 ? up.blk : up.hi))[g];
    if (HF) nf = (w == 0 ? c2.lo : (w == 1 ? c2.blk : c2.hi))[g];
  }

  // Stage s made x plane x0 + p at step parity q: the warp's max of its
  // central cells' errors into its slot std_wmax[q][s-1][.][warp].  Every
  // lane of a warp that holds a central cell calls it; the other warps'
  // slots stay zero.
  __device__ __forceinline__ void reduce(int q, int s, int p, float o) {
    const Cone& cn = pc.c;
    const float diff = fabsf(o - std_sx[s - 1][p] * syz_c);
    unsigned db = cn.central ? __float_as_uint(diff) : 0u;
    unsigned rb = cn.central ? __float_as_uint(fabsf(diff * rsyz_c)) : 0u;
    db = __reduce_max_sync(0xffffffffu, db);
    rb = __reduce_max_sync(0xffffffffu, rb);
    if ((cn.tid & 31) == 0) {
      std_wmax[q][s - 1][0][cn.tid >> 5] = db;
      std_wmax[q][s - 1][1][cn.tid >> 5] = rb;
    }
  }

  // Flush the rows reduced at step t (parity q) into dmax / rmax: warp w
  // takes (stage, abs|rel) pairs w, w + warps, ..., reduces the warps'
  // slots and adds one atomicMax per block; a pad plane's rows stay as the
  // caller zeroed them.  Call after a barrier that follows step t.
  __device__ __forceinline__ void flush(int q, int t) {
    const int lane = pc.c.tid & 31, warps = (blockDim.x + 31) >> 5;
    for (int pair = pc.c.tid >> 5; pair < 2 * K; pair += warps) {
      const int s = (pair >> 1) + 1, which = pair & 1, p = t - s;
      // uniform across the warp
      if (p < K || p >= K + L || (PAD && pc.c.x1 - K + p >= n_real))
        continue;
      unsigned m = lane < warps ? std_wmax[q][s - 1][which][lane] : 0u;
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) {
        unsigned* rows = which ? rmax : dmax;
        atomicMax(&rows[(int64_t)(s - 1) * d + pc.c.x1 - K + p], m);
      }
    }
  }

  // Pipeline step t, t = PH (mod 6): every register slot and ring slot is
  // known at compile time.
  template <int PH>
  __device__ __forceinline__ void step(int t, StdPhase<PH>) {
    constexpr int w0 = PH % 3;        // W slot of this step's plane
    constexpr int w1 = (PH + 2) % 3;  // ... of the last step's
    constexpr int w2 = (PH + 1) % 3;  // ... of the step before
    constexpr int r0 = PH % 2, r1 = (PH + 1) % 2;
    const Cone& cn = pc.c;
    const int planes = L + 2 * K;
    __syncthreads();
    if (dmax && t > 0) flush(r1, t - 1);
    if (t < planes) {  // stage 0: the incoming plane t
      const float u0 = Conv<T>::to(nu);
      W[0][w0] = u0;
      P[0][r0] = Conv<T>::to(np);
      if (HF) F[0][r0] = nf;
      if (cn.live) std_ring[r0 * cn.cols + cn.tid] = u0;
      if (t + 1 < planes) load(t + 1);
    }
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int p = t - s;  // the plane stage s makes at this step
      if (p < s || p >= planes - s) continue;  // uniform across the block
      const float c = W[s - 1][w1];
      float o = c;
      if (reach >= s) {
        const float* pl = std_ring + ((s - 1) * 2 + r1) * cn.cols;
        const float lap = cone_laplacian(W[s - 1][w2], W[s - 1][w0], c, pl,
                                         cn.tid, cn.ez, ix, iy, iz);
        const float co = HF ? F[s - 1][r1] : coeff;
        o = 2.0f * c + co * lap;
        o = o - P[s - 1][r1];
        o = cn.interior ? o : 0.0f;
        o = Conv<T>::to(Conv<T>::from(o));  // the 1-step path's store
      }
      if (s < K) {
        W[s][w0] = o;
        P[s][r0] = c;
        if (HF) F[s][r0] = F[s - 1][r1];
        if (cn.live) std_ring[(s * 2 + r0) * cn.cols + cn.tid] = o;
      } else if (cn.central) {
        const int x = cn.x1 - K + p;
        const bool real = !PAD || x < n_real;
        const int64_t g = (int64_t)x * pc.onn + pc.orow;
        prev_out[g] = Conv<T>::from(real ? c : 0.0f);
        out[g] = Conv<T>::from(real ? o : 0.0f);
      }
      if (errors && p >= K && p < K + L) reduce(r0, s, p - K, o);
    }
  }
};

template <int K, typename T, bool HF, bool PAD, bool LANES>
__global__ void __launch_bounds__(StdThreads<K>::value, 1)
kstep_pipe_kernel(Chain<T> up, Chain<T> u, T* __restrict__ prev_out,
                  T* __restrict__ out, Chain<float> c2,
                  const float* __restrict__ syz,
                  const float* __restrict__ rsyz,
                  const float* __restrict__ sxct,
                  unsigned* __restrict__ dmax, unsigned* __restrict__ rmax,
                  int d, int n, int n_real, int py, int ny, int y0, int seg,
                  int ty, int tz, float coeff, float ix, float iy,
                  float iz, int64_t lane_stride) {
  // LANES (K3's lane mode): block z = lane * segments + segment.  The
  // lane's rows lie K * d on; its cells lane_stride on in every state
  // array, an offset folded into the column's cell offsets below (not
  // into the array pointers, which then stay kernel parameters).  The
  // solo instantiations compile without any of it.
  int xs = blockIdx.z, lane = 0;
  if (LANES) {
    const int nseg = (d + seg - 1) / seg;
    lane = xs / nseg;
    xs -= lane * nseg;
    if (dmax) {
      const int64_t ro = (int64_t)lane * K * d;
      sxct += ro, dmax += ro, rmax += ro;
    }
  }
  StdPipe<K, T, HF, PAD> pp;
  pp.L = seg;
  pp.pc = plane_cone(K, pp.L, ty, tz, n, py, ny, y0, xs);
  // The last segment ends at d: where seg does not divide d it starts at
  // d - seg and remakes planes of the segment before it (the same bits).
  pp.pc.c.x1 = min(pp.pc.c.x1, d - seg);
  const Cone& cn = pp.pc.c;
  pp.up = up;
  pp.u = u;
  pp.c2 = c2;
  pp.prev_out = prev_out;
  pp.out = out;
  pp.dmax = dmax;
  pp.rmax = rmax;
  pp.reach = cn.live ? min(min(cn.ly, cn.ey - 1 - cn.ly),
                           min(cn.lz, cn.ez - 1 - cn.lz))
                     : -1;
  pp.d = d;
  pp.n_real = n_real;
  pp.coeff = coeff;
  pp.ix = ix;
  pp.iy = iy;
  pp.iz = iz;
  // Warp-uniform: the blocks hold whole warps (padding lanes included).
  pp.errors = dmax != nullptr && __any_sync(0xffffffffu, cn.central);
  pp.syz_c = pp.rsyz_c = 0.0f;
  if (dmax) {
    if (cn.central) {
      pp.syz_c = syz[pp.pc.orow];
      pp.rsyz_c = rsyz[pp.pc.orow];
    }
    // The segment's oracle rows and zeroed warp slots; the first step's
    // barrier publishes them.
    for (int i = cn.tid; i < K * pp.L; i += blockDim.x)
      std_sx[i / pp.L][i % pp.L] =
          sxct[(int64_t)(i / pp.L) * d + cn.x1 + i % pp.L];
    for (int i = cn.tid; i < 2 * kStdMaxK * 2 * 32; i += blockDim.x)
      (&std_wmax[0][0][0][0])[i] = 0u;
  }
  if (LANES) {
    pp.pc.c.row += lane * lane_stride;
    pp.pc.orow += lane * lane_stride;
  }
  pp.nu = pp.np = Conv<T>::from(0.0f);
  pp.nf = 0.0f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    pp.W[s][0] = pp.W[s][1] = pp.W[s][2] = 0.0f;
    pp.P[s][0] = pp.P[s][1] = pp.F[s][0] = pp.F[s][1] = 0.0f;
  }
  pp.load(0);
  // Steps 0 .. L + 2k - 1 make the planes; step L + 2k flushes the last
  // rows; the steps past it (to a multiple of 6) only pass the barrier.
  const int steps = pp.L + 2 * K + 1;
  for (int t = 0; t < steps; t += 6) {
    pp.step(t, StdPhase<0>());
    pp.step(t + 1, StdPhase<1>());
    pp.step(t + 2, StdPhase<2>());
    pp.step(t + 3, StdPhase<3>());
    pp.step(t + 4, StdPhase<4>());
    pp.step(t + 5, StdPhase<5>());
  }
}

struct StdArgs {
  const void *up, *uplo, *uphi, *u, *ulo, *uhi;
  void *prev_out, *out;
  const void *c2, *c2lo, *c2hi, *syz, *rsyz, *sxct;
  void *dmax, *rmax;
  int d, n, n_real, py, ny, y0, seg, ty, tz;
  float coeff, ix, iy, iz;
  int lanes;
  int64_t lane_stride;
};

template <int K, typename T, bool HF, bool PAD, bool LANES>
int launch_std(const StdArgs& a, cudaStream_t stream) {
  auto kern = kstep_pipe_kernel<K, T, HF, PAD, LANES>;
  const int cols = (a.ty + 2 * K) * (a.tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > StdThreads<K>::value || a.seg > kStdMaxSeg)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * K * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + a.tz - 1) / a.tz, (a.ny + a.ty - 1) / a.ty,
                  (a.d + a.seg - 1) / a.seg * a.lanes);
  const Chain<T> up{static_cast<const T*>(a.uplo),
                    static_cast<const T*>(a.up),
                    static_cast<const T*>(a.uphi)};
  const Chain<T> u{static_cast<const T*>(a.ulo), static_cast<const T*>(a.u),
                   static_cast<const T*>(a.uhi)};
  const Chain<float> c2{static_cast<const float*>(a.c2lo),
                        static_cast<const float*>(a.c2),
                        static_cast<const float*>(a.c2hi)};
  kern<<<grid, threads, shmem, stream>>>(
      up, u, static_cast<T*>(a.prev_out), static_cast<T*>(a.out), c2,
      static_cast<const float*>(a.syz), static_cast<const float*>(a.rsyz),
      static_cast<const float*>(a.sxct), static_cast<unsigned*>(a.dmax),
      static_cast<unsigned*>(a.rmax), a.d, a.n, a.n_real, a.py, a.ny, a.y0,
      a.seg, a.ty, a.tz, a.coeff, a.ix, a.iy, a.iz, a.lane_stride);
  return (int)cudaGetLastError();
}

template <int K, typename T>
int launch_std_mode(const StdArgs& a, cudaStream_t st) {
  const bool field = a.c2 != nullptr, pad = a.n_real < a.d;
  if (a.lanes > 1)
    return field ? launch_std<K, T, true, false, true>(a, st)
                 : launch_std<K, T, false, false, true>(a, st);
  if (pad)
    return field ? launch_std<K, T, true, true, false>(a, st)
                 : launch_std<K, T, false, true, false>(a, st);
  return field ? launch_std<K, T, true, false, false>(a, st)
               : launch_std<K, T, false, false, false>(a, st);
}

template <int K>
int launch_std_dtype(int dtype, const StdArgs& a, cudaStream_t st) {
  if (dtype == WT_F32) return launch_std_mode<K, float>(a, st);
  if (dtype == WT_BF16) return launch_std_mode<K, __nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K3, K8, K9 and K10.  uprev and u (f32 or bf16, `dtype`): the block
// (d, py, n) and their (k, py, n) x windows (lo: the k planes before the
// block, hi: the k after its last real plane); both outputs are the
// block's central (d, ny, n) rows.  Whole y rows (py == ny == n, y0 = 0;
// K3, K8, K9) or the y-extended block (py == ny + 2k, 0 <= y0 < n, y0 the
// global row of the first central row; K10).  1 <= n_real <= d planes are
// real (K9; the others pass d): outputs and rows past them are zero.  c2
// is the f32 (d, py, n) field block with (k, py, n) f32 windows, or null.
// dmax/rmax are (k, d) uint32 rows zeroed by the caller, or null (then
// syz, rsyz - the central (ny, n) oracle planes - and sxct (k, d) are not
// read).  1 <= k <= 8; the segment length seg <= min(d, 128) (the last of
// ceil(d / seg) segments ends at d); (ty + 2k)(tz + 2k) columns fit a
// block.  `lanes` > 1 is K3's lane mode (whole y rows, no pad): every
// state, window, output and field array holds `lanes` lanes `lane_stride`
// elements apart, sxct and the rows (lanes, k, d).
int wt_kstep_pipe(const void* uprev, const void* uplo, const void* uphi,
                  const void* u, const void* ulo, const void* uhi,
                  void* prev_out, void* out, const void* c2,
                  const void* c2lo, const void* c2hi, const void* syz,
                  const void* rsyz, const void* sxct, void* dmax,
                  void* rmax, int d, int n, int n_real, int py, int ny,
                  int y0, int k, int seg, int ty, int tz, int dtype,
                  double coeff, double ix, double iy, double iz, int lanes,
                  int64_t lane_stride, void* stream) {
  const bool whole = py == ny && ny == n && y0 == 0;
  const bool ext = py == ny + 2 * k && y0 >= 0 && y0 < n;
  if (seg < 1 || seg > d || k < 1 || k > kStdMaxK || ny < 1 ||
      !(whole || ext) || n_real < 1 || n_real > d || ty < 1 || tz < 1 ||
      lanes < 1 || (lanes > 1 && !(whole && n_real == d)) ||
      (int64_t)((d + seg - 1) / seg) * lanes > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StdArgs a{uprev, uplo, uphi, u, ulo, uhi,
                  prev_out, out,
                  c2, c2lo, c2hi, syz, rsyz, sxct,
                  dmax, rmax,
                  d, n, n_real, py, ny, y0, seg, ty, tz,
                  (float)coeff, (float)ix, (float)iy, (float)iz,
                  lanes, lane_stride};
#define WT_K(KK) \
  case KK:       \
    return launch_std_dtype<KK>(dtype, a, st)
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

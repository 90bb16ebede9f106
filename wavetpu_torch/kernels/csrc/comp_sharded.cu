// K4, K11 and K12: k compensated (velocity-form) substeps of the flagship's
// state or of one shard block of the distributed flagship - the
// hand-written Hopper (sm_90a) counterparts of wavetpu's Pallas kernels
// (wavetpu/kernels/stencil_pallas.py):
//
//   K4   kstep_comp_pipe_kernel, py == ny, d == n
//                                          <- _kstep_comp_kernel
//                                             (fused_kstep_comp)
//   K11  kstep_comp_pipe_kernel, py == ny  <- _kstep_comp_sharded_kernel
//                                             (fused_kstep_comp_sharded)
//   K12  kstep_comp_pipe_kernel, py == ny + 2k
//                                          <- _kstep_comp_sharded_xy_kernel
//                                             (fused_kstep_comp_sharded_xy)
//
// One kernel with a run-time y mode (csrc/plane.cuh): K11 takes the x-sharded
// block (d, n, n) with whole y rows that wrap; K12 the y-extended block of an
// (MX, MY, 1) mesh (d, ny + 2k, n) with central outputs and the wrapped
// global-row mask.  u and v (and a field) reach their x neighbours through
// the chain lo window | block | hi window (k-plane windows of the x
// neighbours' blocks, for K12 cut from their y-extended blocks), read in
// place.  K4 is K11 on the whole (n, n, n) state, its windows the state's
// own last and first k planes.
//
// Each substep is op for op the TPU kernel's (`_kstep_comp_kernel`):
//   d = mask(coeff*lap(u)); v' = v + d; Kahan two-sum u' = u + v' through
//   the carry (y = v' - C; t = u + y; C = (t - u) - y),
// the Laplacian summed x, then y, then z (common.cuh `cone_laplacian`).
// The carry rides slab-only: zero outside the block_x slab in x and, for
// K12, outside the central rows in y (wavetpu's zero-seeded carry halos).
// For one block_x K11 runs K4's op sequence, so an x-sharded flagship
// equals the single-device one; K12's zero y-ghost carry differs from
// K4's (within the scheme's 1e-6 tolerance).  Storage modes as K4: f32
// u; (v, carry) f32/bf16, f32/f32, f32/none, bf16/none.  A field (f32) has
// its own chain, its cells in place of coeff (K11f / K12f).
//
// Bound: bytes.  Per launch u, v and their windows read once, the carry
// read once, u, v and the carry written once: ~20 B per output cell at f32
// u/v with a bf16 carry (+4 with a field, +0.5 per extra row of K12's
// extension).
//
// Design: an x-streaming pipeline.  A block owns a (ty x tz) y/z output
// face and an x segment of L planes inside one block_x slab (L | bx), and
// walks x through the segment's L + 2k chain planes, one plane per step,
// as a wavefront of k stages: at step t stage 0 takes chain plane t (the
// incoming u, v, carry and field cells), and stage s (1..k) updates plane
// t - s, after stage s-1 has made planes t-s-1, t-s and t-s+1 (t-s+1 in
// this very step: the stages run in order inside the step).  One thread
// per (y, z) column of the (ty+2k)(tz+2k) halo face:
//   * u's x neighbours are the thread's own registers - per stage the last
//     three planes it made (`W`, slot = step mod 3); v, the carry and the
//     field cell of each stage's current plane ride in registers beside it
//     (two slots, step mod 2).  Registers scale with k, not with the
//     segment: L is only the loop's trip count.
//   * The y/z neighbours come from shared memory: each stage publishes its
//     plane into its own two-slot ring [k][2][cols], read one step later,
//     so one barrier per step orders everything (a slot is rewritten two
//     steps after it was published, behind a barrier its readers passed).
//     A stage computes only the columns inside a face that shrinks by one
//     cell per side per stage, as the cone's does.
//   * The chain is resolved once per incoming plane (a uniform choice of
//     the lo window, the block or the hi window), and the field is read
//     once as its plane enters, not at every substep.
//   * Loads: each thread loads the next plane's cells of its own column
//     one step ahead into registers (issued before the step's stages, so
//     they land during the stages and the barrier), kept as stored (a bf16
//     cell is widened only when stage 0 takes it: widening it at the load
//     made every thread wait for its load each step).  Neither cp.async nor
//     TMA: the thread that consumes a cell is the one that loads it, so a
//     shared-memory stage would add a store and a load per cell; a bf16
//     carry or v cell is 2 bytes, under cp.async's 4-byte minimum; and a
//     TMA box cannot follow the z wrap of the first and last tiles nor the
//     three arrays of a chain without a tensor map per array.
// Against the cone kernel it replaces (the design K4, K11 and K12 had
// before: a tile of at most 8 x planes, the column's u, v and carry for
// all 8 + 2k planes in registers, an 8x32 face, 95 registers, one
// 640-thread block per SM, the field looked up through the chain per cell
// and substep), at k=4, L=32 and a 24x24 face:
// x loads 1.25x the output planes instead of 2x, the y/z halo 1.78x
// instead of 2.5x, and the substeps' work ~1.27x instead of ~2.2x.
//
// Error rows per (substep, x plane): a warp max on the float bits into the
// warp's own shared slot, then after the next step's barrier one warp per
// (substep, abs|rel) reduces the slots and adds one atomicMax per block into
// the caller's zeroed (k, d) rows (max on the bits of non-negative floats,
// as common.cuh's protocol: a NaN wins).  Slots instead of common.cuh's
// shared atomics: 32 warps updating one word per stage and step serialise.
//
// Lane mode (K4 only: the ensemble's batch axis, wavetpu's vmap of
// fused_kstep_comp in ensemble/batched.py): `lanes` whole states side by
// side, u, v, the carry and every output lane-major with one lane stride
// (the windows are views of the same batch), and per-lane oracle
// rows sxct and error rows (lanes, k, d).  Block z is lane * segments +
// segment, so a lane's blocks run the solo launch's op sequence on that
// lane, slab by slab: each lane equals the solo launch bit for bit.  The
// lane's offset is folded into the column's cell offsets once, before the
// pipeline.  The lane mode takes the flagship's storage (f32 u and v, a
// bf16 carry) without a field, the compensated ensemble's only form.
//
// Built by wavetpu_torch/kernels/build.py with --fmad=false, beside the
// other sources: 8 k x 4 storage modes x field on/off = 64 instantiations,
// and 8 of the lane mode (its own instantiations, so the solo ones carry
// none of it).
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().  Wrappers, plain PyTorch
// versions and launch counters: stencil_cuda.fused_kstep_comp,
// fused_kstep_comp_sharded and fused_kstep_comp_sharded_xy; the tile:
// stencil_cuda.comp_pipe_tile.

#include "plane.cuh"

// The longest segment (the oracle rows of a segment sit in shared memory)
// and the largest k.
constexpr int kPipeMaxSeg = 64;
constexpr int kPipeMaxK = 8;

// Shared memory of a block, declared at file scope so that every access is
// a shared-space access: the stages' u rings [k][2][cols] (dynamic), the
// warps' error maxima [step parity][stage][abs|rel][warp] and the
// segment's oracle rows sxct[stage][plane].
extern __shared__ float pipe_ring[];
__shared__ unsigned pipe_wmax[2][kPipeMaxK][2][32];
__shared__ float pipe_sx[kPipeMaxK][kPipeMaxSeg];

namespace {

// Threads per block (one per halo-face column): the per-stage registers
// (u x3, v x2, carry x2, field x2) grow with k, so blocks of k > 4 are
// smaller (stencil_cuda.pipe_max_threads).
template <int K>
struct PipeThreads {
  static constexpr int value = K <= 4 ? 1024 : 640;
};

template <int PH>
struct Phase {};

// One thread's pipeline: its column, its operands and its registers.
template <int K, typename VT, typename CT, bool HC, bool HF>
struct CompPipe {
  Chain<float> u;
  Chain<VT> v;
  Chain<float> c2;
  const CT* carry;
  float* u_out;
  VT* v_out;
  CT* carry_out;
  unsigned* dmax;
  unsigned* rmax;
  PlaneCone pc;
  int d, L, bx, xb0;
  int reach;  // the last stage whose face holds this column (-1: padding)
  float coeff, ix, iy, iz, syz_c, rsyz_c;
  bool errors;

  float W[K][3];  // u of stage s at the planes it made in the last 3 steps
  float V[K][2];  // v, carry and field cell of stage s's last 2 planes
  float C[K][2];
  float F[K][2];
  // The incoming plane's cells as stored: converted where stage 0 takes
  // them, a step after the load, so no thread waits for its load.
  float nu, nf;
  VT nv;
  CT nc;

  // Load chain plane j (x = x0 - K + j) of this column into nu..nc.
  __device__ __forceinline__ void load(int j) {
    const Cone& cn = pc.c;
    if (!cn.live) return;
    const int xu = cn.x1 - K + j;
    int64_t g;
    const int w = chain_pos(xu, K, d, cn.nn, cn.row, g);
    nu = (w == 0 ? u.lo : (w == 1 ? u.blk : u.hi))[g];
    nv = (w == 0 ? v.lo : (w == 1 ? v.blk : v.hi))[g];
    if (HF) nf = (w == 0 ? c2.lo : (w == 1 ? c2.blk : c2.hi))[g];
    if (HC && pc.orow_ok && xu >= xb0 && xu < xb0 + bx)
      nc = carry[(int64_t)xu * pc.onn + pc.orow];
  }

  // Stage s made x plane xu = x0 + p at step parity q: the warp's max of
  // its central cells' errors into its slot pipe_wmax[q][s-1][.][warp].
  // Every lane of every warp calls it (a slot per warp: no atomics on one
  // word); it has no branch, so its reads schedule with the stage's work.
  __device__ __forceinline__ void reduce(int q, int s, int p, float t) {
    const Cone& cn = pc.c;
    const float diff = fabsf(t - pipe_sx[s - 1][p] * syz_c);
    unsigned db = cn.central ? __float_as_uint(diff) : 0u;
    unsigned rb = cn.central ? __float_as_uint(fabsf(diff * rsyz_c)) : 0u;
    db = __reduce_max_sync(0xffffffffu, db);
    rb = __reduce_max_sync(0xffffffffu, rb);
    if ((cn.tid & 31) == 0) {
      pipe_wmax[q][s - 1][0][cn.tid >> 5] = db;
      pipe_wmax[q][s - 1][1][cn.tid >> 5] = rb;
    }
  }

  // Flush the rows reduced at step t (parity q) into dmax / rmax: warp w
  // takes (stage, abs|rel) pairs w, w + warps, ..., reduces the warps'
  // slots and adds one atomicMax per block.  Call after a barrier that
  // follows step t.
  __device__ __forceinline__ void flush(int q, int t) {
    const int lane = pc.c.tid & 31, warps = (blockDim.x + 31) >> 5;
    for (int pair = pc.c.tid >> 5; pair < 2 * K; pair += warps) {
      const int s = (pair >> 1) + 1, which = pair & 1, p = t - s;
      if (p < K || p >= K + L) continue;  // uniform across the warp
      unsigned m = lane < warps ? pipe_wmax[q][s - 1][which][lane] : 0u;
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
  __device__ __forceinline__ void step(int t, Phase<PH>) {
    constexpr int w0 = PH % 3;        // W slot of this step's plane
    constexpr int w1 = (PH + 2) % 3;  // ... of the last step's
    constexpr int w2 = (PH + 1) % 3;  // ... of the step before
    constexpr int r0 = PH % 2, r1 = (PH + 1) % 2;
    const Cone& cn = pc.c;
    const int T = L + 2 * K;
    __syncthreads();
    if (errors && t > 0) flush(r1, t - 1);
    if (t < T) {  // stage 0: the incoming plane t
      W[0][w0] = nu;
      V[0][r0] = Conv<VT>::to(nv);
      if (HC) C[0][r0] = Conv<CT>::to(nc);
      if (HF) F[0][r0] = nf;
      if (cn.live) pipe_ring[r0 * cn.cols + cn.tid] = nu;
      if (HC) nc = Conv<CT>::from(0.0f);
      if (t + 1 < T) load(t + 1);
    }
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int p = t - s;  // the plane stage s makes at this step
      if (p < s || p >= T - s) continue;  // uniform across the block
      const float c = W[s - 1][w1];
      const float vo = V[s - 1][r1];
      const float co0 = HC ? C[s - 1][r1] : 0.0f;
      float tn = c, vn = vo, cc = co0;
      if (reach >= s) {
        const float* pl = pipe_ring + ((s - 1) * 2 + r1) * cn.cols;
        const float lap = cone_laplacian(W[s - 1][w2], W[s - 1][w0], c, pl,
                                         cn.tid, cn.ez, ix, iy, iz);
        const float co = HF ? F[s - 1][r1] : coeff;
        const float dd = cn.interior ? co * lap : 0.0f;
        vn = vo + dd;
        const float yy = HC ? vn - co0 : vn;
        tn = c + yy;
        if (HC) cc = (tn - c) - yy;
      }
      if (s < K) {
        W[s][w0] = tn;
        V[s][r0] = vn;
        if (HC) C[s][r0] = cc;
        if (HF) F[s][r0] = F[s - 1][r1];
        if (cn.live) pipe_ring[(s * 2 + r0) * cn.cols + cn.tid] = tn;
      } else if (cn.central) {
        const int64_t g = (int64_t)(cn.x1 - K + p) * pc.onn + pc.orow;
        u_out[g] = tn;
        v_out[g] = Conv<VT>::from(vn);
        if (HC) carry_out[g] = Conv<CT>::from(cc);
      }
      if (errors && p >= K && p < K + L) reduce(r0, s, p - K, tn);
    }
  }
};

template <int K, typename VT, typename CT, bool HC, bool HF, bool LANES>
__global__ void __launch_bounds__(PipeThreads<K>::value, 1)
kstep_comp_pipe_kernel(Chain<float> u, Chain<VT> v,
                       const CT* __restrict__ carry,
                       float* __restrict__ u_out, VT* __restrict__ v_out,
                       CT* __restrict__ carry_out, Chain<float> c2,
                       const float* __restrict__ syz,
                       const float* __restrict__ rsyz,
                       const float* __restrict__ sxct,
                       unsigned* __restrict__ dmax,
                       unsigned* __restrict__ rmax, int d, int n, int py,
                       int ny, int y0, int bx, int seg, int ty, int tz,
                       float coeff, float ix, float iy, float iz,
                       int64_t lane_stride) {
  // LANES (K4's lane mode): block z = lane * segments + segment.  The
  // lane's rows lie K * d on; its cells lane_stride on in every state
  // array, an offset folded into the column's cell offsets below (not
  // into the array pointers, which then stay kernel parameters).  The
  // solo instantiations compile without any of it.
  int xs = blockIdx.z, lane = 0;
  if (LANES) {
    const int nseg = d / seg;
    lane = xs / nseg;
    xs -= lane * nseg;
    if (dmax) {
      const int64_t ro = (int64_t)lane * K * d;
      sxct += ro, dmax += ro, rmax += ro;
    }
  }
  CompPipe<K, VT, CT, HC, HF> pp;
  pp.L = seg;
  pp.pc = plane_cone(K, pp.L, ty, tz, n, py, ny, y0, xs);
  const Cone& cn = pp.pc.c;
  pp.u = u;
  pp.v = v;
  pp.c2 = c2;
  pp.carry = carry;
  pp.u_out = u_out;
  pp.v_out = v_out;
  pp.carry_out = carry_out;
  pp.dmax = dmax;
  pp.rmax = rmax;
  pp.reach = cn.live ? min(min(cn.ly, cn.ey - 1 - cn.ly),
                           min(cn.lz, cn.ez - 1 - cn.lz))
                     : -1;
  pp.d = d;
  pp.bx = bx;
  pp.xb0 = (cn.x1 / bx) * bx;  // the block_x slab the segment lies in
  pp.coeff = coeff;
  pp.ix = ix;
  pp.iy = iy;
  pp.iz = iz;
  pp.errors = dmax != nullptr;
  pp.syz_c = pp.rsyz_c = 0.0f;
  if (pp.errors) {
    if (cn.central) {
      pp.syz_c = syz[pp.pc.orow];
      pp.rsyz_c = rsyz[pp.pc.orow];
    }
    // The segment's oracle rows; the first step's barrier publishes them.
    for (int i = cn.tid; i < K * pp.L; i += blockDim.x)
      pipe_sx[i / pp.L][i % pp.L] =
          sxct[(int64_t)(i / pp.L) * d + cn.x1 + i % pp.L];
  }
  if (LANES) {
    pp.pc.c.row += lane * lane_stride;
    pp.pc.orow += lane * lane_stride;
  }
  pp.nu = pp.nf = 0.0f;
  pp.nv = Conv<VT>::from(0.0f);
  pp.nc = Conv<CT>::from(0.0f);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    pp.W[s][0] = pp.W[s][1] = pp.W[s][2] = 0.0f;
    pp.V[s][0] = pp.V[s][1] = pp.C[s][0] = pp.C[s][1] = 0.0f;
    pp.F[s][0] = pp.F[s][1] = 0.0f;
  }
  pp.load(0);
  // Steps 0 .. L + 2k - 1 make the planes; step L + 2k flushes the last
  // rows; the steps past it (to a multiple of 6) only pass the barrier.
  const int steps = pp.L + 2 * K + 1;
  for (int t = 0; t < steps; t += 6) {
    pp.step(t, Phase<0>());
    pp.step(t + 1, Phase<1>());
    pp.step(t + 2, Phase<2>());
    pp.step(t + 3, Phase<3>());
    pp.step(t + 4, Phase<4>());
    pp.step(t + 5, Phase<5>());
  }
}

struct Args {
  const void *u, *ulo, *uhi, *v, *vlo, *vhi, *carry;
  void *u_out, *v_out, *carry_out;
  const void *c2, *c2lo, *c2hi, *syz, *rsyz, *sxct;
  void *dmax, *rmax;
  int d, n, py, ny, y0, bx, seg, ty, tz;
  float coeff, ix, iy, iz;
  int lanes;
  int64_t lane_stride;
};

template <int K, typename VT, typename CT, bool HC, bool HF, bool LANES>
int launch_pipe(const Args& a, cudaStream_t stream) {
  auto kern = kstep_comp_pipe_kernel<K, VT, CT, HC, HF, LANES>;
  const int cols = (a.ty + 2 * K) * (a.tz + 2 * K);
  const int threads = (cols + 31) / 32 * 32;
  if (threads > PipeThreads<K>::value || a.seg > kPipeMaxSeg)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = (size_t)2 * K * cols * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.n + a.tz - 1) / a.tz, (a.ny + a.ty - 1) / a.ty,
                  a.d / a.seg * a.lanes);
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
      static_cast<unsigned*>(a.rmax), a.d, a.n, a.py, a.ny, a.y0, a.bx,
      a.seg, a.ty, a.tz, a.coeff, a.ix, a.iy, a.iz, a.lane_stride);
  return (int)cudaGetLastError();
}

// K4's storage modes, each with and without a field; the lane mode in
// the flagship's storage (f32 v, bf16 carry), without a field.
template <int K>
int launch_comp_mode(int v_dtype, int carry_dtype, const Args& a,
                     cudaStream_t st) {
  const bool field = a.c2 != nullptr;
  if (a.lanes > 1)
    return v_dtype == WT_F32 && carry_dtype == WT_BF16 && !field
               ? launch_pipe<K, float, __nv_bfloat16, true, false, true>(
                     a, st)
               : (int)cudaErrorInvalidValue;
#define WT_COMP(VT, CT, HC)                                         \
  return field ? launch_pipe<K, VT, CT, HC, true, false>(a, st) \
               : launch_pipe<K, VT, CT, HC, false, false>(a, st)
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

// K4 and K11 (py == ny == n, y0 = 0) and K12 (py == ny + 2k, 0 <= y0 < n).  u f32
// and v (f32 or bf16): the block (d, py, n) and its (k, py, n) x windows;
// the carry (null, or f32/bf16 with an f32 v) and every output are the
// central (d, ny, n) rows.  c2 is the f32 (d, py, n) field block with
// (k, py, n) f32 windows, or null.  dmax/rmax are (k, d) uint32 rows zeroed
// by the caller, or null (then syz, rsyz - the central (ny, n) oracle
// planes - and sxct (k, d) are not read).  1 <= k <= 8; the segment length
// seg <= 64 divides bx, bx divides d; (ty + 2k)(tz + 2k) columns fit a
// block.  `lanes` > 1 is K4's lane mode (whole y rows, f32 v, a bf16
// carry, no field): u, v, the carry, their windows and the outputs hold
// `lanes` lanes `lane_stride` elements apart, sxct and the rows (lanes, k,
// d).
int wt_kstep_comp_chain(const void* u, const void* ulo, const void* uhi,
                        const void* v, const void* vlo, const void* vhi,
                        const void* carry, void* u_out, void* v_out,
                        void* carry_out, const void* c2, const void* c2lo,
                        const void* c2hi, const void* syz, const void* rsyz,
                        const void* sxct, void* dmax, void* rmax, int d,
                        int n, int py, int ny, int y0, int k, int bx,
                        int seg, int ty, int tz, int v_dtype,
                        int carry_dtype, double coeff, double ix, double iy,
                        double iz, int lanes, int64_t lane_stride,
                        void* stream) {
  const bool whole = py == ny && ny == n && y0 == 0;
  const bool ext = py == ny + 2 * k && y0 >= 0 && y0 < n;
  if (seg < 1 || bx < 1 || bx % seg || d % bx || k < 1 || k > 8 ||
      ny < 1 || !(whole || ext) || ty < 1 || tz < 1 || lanes < 1 ||
      (lanes > 1 && !whole) || (int64_t)(d / seg) * lanes > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{u, ulo, uhi, v, vlo, vhi, carry,
               u_out, v_out, carry_out,
               c2, c2lo, c2hi, syz, rsyz, sxct,
               dmax, rmax,
               d, n, py, ny, y0, bx, seg, ty, tz,
               (float)coeff, (float)ix, (float)iy, (float)iz,
               lanes, lane_stride};
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

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
// the Laplacian summed x, then y, then z (common.cuh `cone_laplacian`'s
// order).  The carry rides slab-only: zero outside the block_x slab in x
// and, for K12, outside the central rows in y (wavetpu's zero-seeded carry
// halos).  For one block_x K11 runs K4's op sequence, so an x-sharded
// flagship equals the single-device one; K12's zero y-ghost carry differs
// from K4's (within the scheme's 1e-6 tolerance).  Storage modes as K4: f32
// u; (v, carry) f32/bf16, f32/f32, f32/none, bf16/none.  A field (f32) has
// its own chain, its cells in place of coeff (K11f / K12f).
//
// Bound: bytes.  Per launch u, v and their windows read once, the carry
// read once, u, v and the carry written once: ~20 B per output cell at f32
// u/v with a bf16 carry (+4 with a field, +0.5 per extra row of K12's
// extension).  It runs far from that bound on instructions: each stage of
// a cell costs ~20 f32 operations (rounded one by one under --fmad=false)
// and its error fold, and a block computes its halo face beside its
// outputs.
//
// Design: an x-streaming pipeline.  A block owns a (ty x tz) y/z output
// face and an x segment of L planes inside one block_x slab (L | bx), and
// walks x through the segment's L + 2k chain planes, one plane per step,
// as a wavefront of k stages: at step t stage 0 takes chain plane t (the
// incoming u, v, carry and field cells), and stage s (1..k) updates plane
// t - s, after stage s-1 has made planes t-s-1, t-s and t-s+1 (t-s+1 in
// this very step: the stages run in order inside the step).  The block
// holds the (ey x ez) = (ty+2k)(tz+2k) halo face; stage s computes the
// face shrunk by s cells a side, as the cone's does.
//
// Register blocking: a thread owns R cells of the face, R adjacent y rows
// of one z column (lz = tid mod ez, rows R*(tid / ez) .. + R-1), so a
// block has ceil(ey / R) * ez threads.  Per cell and stage:
//   * Registers: u of the plane the stage made last step (the next
//     stage's centre) and this step (its right x neighbour), and v, the
//     carry and the field cell beside them (`W`, `V`, `C`, `F`, slot =
//     step mod 2).  Registers scale with k and R, not with the segment.
//   * The ring: each stage publishes its plane into its own three-slot
//     ring [k][3][R planes of the thread index] (plane r holds row r of
//     every thread's rows, at kPipeMaxEz + tid: a guard of kPipeMaxEz
//     words either side, so every read stays inside the ring and every
//     offset from the thread's index is fixed at compile time but the
//     face width ez).  A stage reads the slot of last step's plane for
//     its z neighbours and its outer rows' y neighbours (the y neighbours
//     between the thread's rows are its registers), and the slot of two
//     steps ago for its left x neighbour (its own word).  One barrier per
//     step orders everything: a slot is rewritten three steps after it
//     was published, behind barriers its readers passed.
//   * The R cells are R independent chains inside a stage, computed
//     without a branch; a thread whose cells all lie outside the stage's
//     face skips the stage (whole warps, for a face 32 columns wide).  A
//     cell outside the face computes from whatever its neighbours hold and
//     nothing reads it: a cell of stage s's face reads only cells of stage
//     s-1's, and only central cells are stored or reduced.
//   * Per step a thread resolves the x chain once for its R cells (a
//     uniform choice of the lo window, the block or the hi window) and
//     issues R loads per array, one step ahead into registers (they land
//     during the stages and the barrier), kept as stored (a bf16 cell is
//     widened only when stage 0 takes it).  Neither cp.async nor TMA: the
//     thread that consumes a cell is the one that loads it; a bf16 cell is
//     under cp.async's 4-byte minimum; a TMA box cannot follow the z wrap
//     of the first and last tiles nor the three arrays of a chain.
//   * The error rows: a thread folds its R central cells' errors into one
//     value (a max on the float bits) before the warp's reduction; a warp
//     with no central cell skips them, its slots held at 0.  A cell's
//     oracle pair (syz, rsyz) waits in shared memory beside the ring (one
//     64-bit read per stage), not in registers.
// At R = 1 a thread holds one column, as K4's body before register
// blocking did (1024 threads for k <= 4, <= 64 registers).  A blocked shape
// (`Shape`: R and the block's threads NT) trades threads for registers:
// per cell and stage it shares the ring's addressing, the chain lookup,
// the reduction and the barrier over R cells and runs R chains where one
// ran; it reads 3 + 2/R shared words a cell and stage (the left x
// neighbour from the ring frees a register a stage and cell).  The face
// grows with the cells a block holds (40 x 32 at R = 2 on 640 threads,
// 48 x 32 at R = 3 on 512: the halo 1.67x and 1.6x the output, against
// 1.78x for 32 x 32).  stencil_cuda.comp_pipe_block
// picks the shape per k, storage mode, field and lane mode: the fastest
// of kernels/tile_ab.py's A/B that ptxas builds without a spill.
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
// lane's offset is added to the plane's offset, once a step.  The lane
// mode takes the flagship's storage (f32 u and v, a bf16 carry) without a
// field, the compensated ensemble's only form.
//
// Built by wavetpu_torch/kernels/build.py with --fmad=false, beside the
// other sources: 8 k x 4 storage modes x field on/off at R = 1, and the
// lane mode's 8 (its own instantiations, so the solo ones carry none of
// it), plus the blocked shapes of `launch_shape` (k = 4, the flagship's
// storage, solo and lanes).
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().  Wrappers, plain PyTorch
// versions and launch counters: stencil_cuda.fused_kstep_comp,
// fused_kstep_comp_sharded and fused_kstep_comp_sharded_xy; the shape:
// stencil_cuda.comp_pipe_block.

#include <type_traits>

#include "plane.cuh"

// The longest segment (the oracle rows of a segment sit in shared memory)
// and the largest k.
constexpr int kPipeMaxSeg = 64;
constexpr int kPipeMaxK = 8;
// The widest face (columns) a ring's guards hold.
constexpr int kPipeMaxEz = 64;

// Shared memory of a block, declared at file scope so that every access is
// a shared-space access: the stages' u rings [k][3][R][plane] and the
// cells' oracle pairs [R][plane] (dynamic), the warps' error maxima [step
// parity][stage][abs|rel][warp] and the segment's oracle rows
// sxct[stage][plane].
extern __shared__ float pipe_ring[];
__shared__ unsigned pipe_wmax[2][kPipeMaxK][2][32];
__shared__ float pipe_sx[kPipeMaxK][kPipeMaxSeg];

namespace {

// Threads per block of the one-cell-a-thread shape (R = 1): the
// per-stage registers (u, v, carry and field, two of each) grow with k,
// so blocks of k > 4 are smaller (stencil_cuda.pipe_max_threads).
template <int K>
struct PipeThreads {
  static constexpr int value = K <= 4 ? 1024 : 640;
};

// A block's shape: R face rows a thread, at most NT threads, one block an
// SM (__launch_bounds__: 65536 / NT registers a thread, in steps of 8).
template <int R_, int NT_>
struct Shape {
  static constexpr int R = R_, NT = NT_;
};

template <int PH>
struct Phase {};

// One thread's pipeline: its R cells, its operands and its registers.
template <int K, class S, typename VT, typename CT, bool HC, bool HF>
struct CompPipe {
  static constexpr int R = S::R;
  // A ring slot: R planes of the thread rows (plane r holds row r of every
  // thread's rows, index tid), each with a guard of kPipeMaxEz words on
  // either side, so every offset from the thread's index is known at
  // compile time but the face's width ez.
  static constexpr int kPlane = S::NT + 2 * kPipeMaxEz;
  static constexpr int kSlot = R * kPlane;
  Chain<float> u;
  Chain<VT> v;
  Chain<float> c2;
  const CT* carry;
  float* u_out;
  VT* v_out;
  CT* carry_out;
  unsigned* dmax;
  unsigned* rmax;
  int tid, d, L, bx, x1, xb0;
  int ez;     // the face's columns
  int reach;  // the last stage whose face holds one of its cells (-1: none)
  bool wcentral;  // the warp holds a central cell (its rows are reduced)
  int nn, onn;  // input / output plane strides (cells)
  int odelta;   // a cell's input-plane offset less its output-plane offset
  int64_t lane_off;  // the lane's first cell (lane mode)
  // Per cell: its (y, z) offset in an input plane, and bits r, R + r and
  // 2R + r of `flags`: off the Dirichlet planes, a central (output) cell,
  // on an output row.
  int row[R];
  unsigned flags;
  float coeff, ix, iy, iz;
  bool errors;

  float W[K][R][2];  // u of stage s at the planes it made in the last 2 steps
  float V[K][R][2];  // v, carry and field cell of stage s's last 2 planes
  float C[K][R][2];
  float F[K][R][2];
  // The incoming plane's cells as stored: converted where stage 0 takes
  // them, a step after the load, so no thread waits for its load.
  float nu[R], nf[R];
  VT nv[R];
  CT nc[R];

  __device__ __forceinline__ bool bit(int b) const { return (flags >> b) & 1u; }

  // The oracle plane's (syz, rsyz) at the thread's cell r, after the ring.
  __device__ __forceinline__ float2* oracle(int r) const {
    return reinterpret_cast<float2*>(pipe_ring + 3 * K * kSlot) +
           r * kPlane + kPipeMaxEz + tid;
  }

  // The ring word of the thread's cell r in slot q of stage s.
  __device__ __forceinline__ float* ring(int s, int q, int r) const {
    return pipe_ring + (s * 3 + q) * kSlot + r * kPlane + kPipeMaxEz + tid;
  }

  // Load chain plane j (x = x1 - K + j) of the thread's cells into nu..nc.
  __device__ __forceinline__ void load(int j) {
    if (reach < 0) return;
    const int xu = x1 - K + j;
    const int w = xu < 0 ? 0 : (xu < d ? 1 : 2);
    const int64_t base =
        lane_off + (int64_t)(w == 0 ? xu + K : (w == 1 ? xu : xu - d)) * nn;
    const float* pu = (w == 0 ? u.lo : (w == 1 ? u.blk : u.hi)) + base;
    const VT* pv = (w == 0 ? v.lo : (w == 1 ? v.blk : v.hi)) + base;
    const float* pf = HF ? (w == 0 ? c2.lo : (w == 1 ? c2.blk : c2.hi)) + base
                         : nullptr;
    const bool slab = HC && xu >= xb0 && xu < xb0 + bx;
    const CT* pc = slab ? carry + lane_off + (int64_t)xu * onn - odelta
                        : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r) {  // a padding row's cell reads a valid one
      nu[r] = pu[row[r]];
      nv[r] = pv[row[r]];
      if (HF) nf[r] = pf[row[r]];
      if (slab && bit(2 * R + r)) nc[r] = pc[row[r]];
    }
  }

  // The warp's max of its cells' folded errors into its slot
  // pipe_wmax[q][s-1][.][warp].  Every lane of a warp that holds central
  // cells calls it (a slot per warp: no atomics on one word).
  __device__ __forceinline__ void reduce(int q, int s, unsigned db,
                                         unsigned rb) {
    db = __reduce_max_sync(0xffffffffu, db);
    rb = __reduce_max_sync(0xffffffffu, rb);
    if ((tid & 31) == 0) {
      pipe_wmax[q][s - 1][0][tid >> 5] = db;
      pipe_wmax[q][s - 1][1][tid >> 5] = rb;
    }
  }

  // Flush the rows reduced at step t (parity q) into dmax / rmax: warp w
  // takes (stage, abs|rel) pairs w, w + warps, ..., reduces the warps'
  // slots and adds one atomicMax per block.  Call after a barrier that
  // follows step t.
  __device__ __forceinline__ void flush(int q, int t) {
    const int lane = tid & 31, warps = (blockDim.x + 31) >> 5;
    for (int pair = tid >> 5; pair < 2 * K; pair += warps) {
      const int s = (pair >> 1) + 1, which = pair & 1, p = t - s;
      if (p < K || p >= K + L) continue;  // uniform across the warp
      unsigned m = lane < warps ? pipe_wmax[q][s - 1][which][lane] : 0u;
      m = __reduce_max_sync(0xffffffffu, m);
      if (lane == 0) {
        unsigned* rows = which ? rmax : dmax;
        atomicMax(&rows[(int64_t)(s - 1) * d + x1 - K + p], m);
      }
    }
  }

  // Pipeline step t, t = PH (mod 6): every register slot and ring slot is
  // known at compile time.
  template <int PH>
  __device__ __forceinline__ void step(int t, Phase<PH>) {
    constexpr int q0 = PH % 3;        // ring slot of this step's plane
    constexpr int q1 = (PH + 2) % 3;  // ... of the last step's
    constexpr int q2 = (PH + 1) % 3;  // ... of the step before
    constexpr int r0 = PH % 2, r1 = (PH + 1) % 2;  // register slots
    const int T = L + 2 * K;
    __syncthreads();
    if (errors && t > 0) flush(r1, t - 1);
    if (t < T) {  // stage 0: the incoming plane t
#pragma unroll
      for (int r = 0; r < R; ++r) {
        W[0][r][r0] = nu[r];
        V[0][r][r0] = Conv<VT>::to(nv[r]);
        if (HC) C[0][r][r0] = Conv<CT>::to(nc[r]);
        if (HF) F[0][r][r0] = nf[r];
        if (reach >= 0) *ring(0, q0, r) = nu[r];
        if (HC) nc[r] = Conv<CT>::from(0.0f);
      }
      if (t + 1 < T) load(t + 1);
    }
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int p = t - s;  // the plane stage s makes at this step
      if (p < s || p >= T - s) continue;  // uniform across the block
      // The rows of this plane, reduced by the warps that hold central
      // cells (the others' slots stay 0).
      const bool rows = errors && wcentral && p >= K && p < K + L;
      unsigned db = 0u, rb = 0u;
      if (reach >= s) {
        // The outer rows' y neighbours: the last row of the thread rows
        // above, the first of those below.
        const float up = ring(s - 1, q1, R - 1)[-ez];
        const float dn = ring(s - 1, q1, 0)[ez];
        const float sxs = rows ? pipe_sx[s - 1][p - K] : 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float c = W[s - 1][r][r1];
          const float ym = r == 0 ? up : W[s - 1][r - 1][r1];
          const float yp = r == R - 1 ? dn : W[s - 1][r + 1][r1];
          const float* pz = ring(s - 1, q1, r);
          // common.cuh cone_laplacian's sums: the right x neighbour (made
          // by stage s-1 this step) and the inner y neighbours from
          // registers, the left x neighbour from the ring's slot of two
          // steps ago.
          float lap = (*ring(s - 1, q2, r) + W[s - 1][r][r0] - 2.0f * c) * ix;
          lap = lap + (ym + yp - 2.0f * c) * iy;
          lap = lap + (pz[-1] + pz[1] - 2.0f * c) * iz;
          const float co = HF ? F[s - 1][r][r1] : coeff;
          const float dd = bit(r) ? co * lap : 0.0f;
          const float co0 = HC ? C[s - 1][r][r1] : 0.0f;
          const float vn = V[s - 1][r][r1] + dd;
          const float yy = HC ? vn - co0 : vn;
          const float tn = c + yy;
          if (s < K) {
            W[s][r][r0] = tn;
            V[s][r][r0] = vn;
            if (HC) C[s][r][r0] = (tn - c) - yy;
            if (HF) F[s][r][r0] = F[s - 1][r][r1];
            *ring(s, q0, r) = tn;
          } else if (bit(R + r)) {
            const int64_t o = lane_off + (int64_t)(x1 - K + p) * onn - odelta;
            u_out[o + row[r]] = tn;
            v_out[o + row[r]] = Conv<VT>::from(vn);
            if (HC) carry_out[o + row[r]] = Conv<CT>::from((tn - c) - yy);
          }
          if (rows) {
            const float2 o = *oracle(r);
            const float diff = fabsf(tn - sxs * o.x);
            const unsigned a = __float_as_uint(diff);
            const unsigned b = __float_as_uint(fabsf(diff * o.y));
            db = bit(R + r) ? max(db, a) : db;
            rb = bit(R + r) ? max(rb, b) : rb;
          }
        }
      }
      if (rows) reduce(r0, s, db, rb);
    }
  }
};

template <int K, class S, typename VT, typename CT, bool HC, bool HF,
          bool LANES>
__global__ void __launch_bounds__(S::NT, 1)
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
  constexpr int R = S::R;
  // LANES (K4's lane mode): block z = lane * segments + segment.  The
  // lane's rows lie K * d on; its cells lane_stride on in every state
  // array, an offset added to each plane's (not to the array pointers,
  // which then stay kernel parameters).  The solo instantiations compile
  // without any of it.
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
  CompPipe<K, S, VT, CT, HC, HF> pp;
  pp.u = u;
  pp.v = v;
  pp.c2 = c2;
  pp.carry = carry;
  pp.u_out = u_out;
  pp.v_out = v_out;
  pp.carry_out = carry_out;
  pp.dmax = dmax;
  pp.rmax = rmax;
  pp.L = seg;
  pp.d = d;
  pp.bx = bx;
  pp.x1 = xs * seg;
  pp.xb0 = (pp.x1 / bx) * bx;  // the block_x slab the segment lies in
  pp.coeff = coeff;
  pp.ix = ix;
  pp.iy = iy;
  pp.iz = iz;
  pp.errors = dmax != nullptr;
  pp.nn = py * n;
  pp.onn = ny * n;
  pp.lane_off = LANES ? lane * lane_stride : 0;
  // The face (plane.cuh's geometry, R rows a thread): the thread's column
  // lz and its first row R * rb; the y mode as plane_cone's.  An output
  // row oy of a K12 block is input row oy + K (a clamped input row is no
  // output row); K4 and K11 read and write the same row.
  const int ey = ty + 2 * K, ez = tz + 2 * K, nrb = (ey + R - 1) / R;
  const int tid = threadIdx.x;
  const bool live = tid < nrb * ez;
  const int lz = live ? tid % ez : 0, rb = live ? tid / ez : 0;
  pp.tid = tid;
  pp.ez = ez;
  const int y1 = blockIdx.y * ty, z1 = blockIdx.x * tz;
  const int gz = wrap(z1 - K + lz, n);
  const bool ext = py != ny;
  pp.odelta = ext ? K * n : 0;
  const bool zc = lz >= K && lz < K + tz && z1 + lz - K < n;
  const int zreach = min(lz, ez - 1 - lz);
  pp.reach = -1;
  pp.flags = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int ly = rb * R + r;
    const bool cl = live && ly < ey;
    const int yo = y1 - K + ly;  // the cell's row among the output rows
    const int pr = ext ? min(yo + K, py - 1) : wrap(yo, py);  // input row
    const int oy = ext ? yo : pr;
    const bool central = cl && ly >= K && ly < K + ty && zc && yo < ny;
    pp.row[r] = pr * n + gz;
    pp.flags |= (unsigned)(wrap(y0 + yo, n) != 0 && gz != 0) << r |
                (unsigned)central << (R + r) |
                (unsigned)(oy >= 0 && oy < ny) << (2 * R + r);
    if (cl) pp.reach = max(pp.reach, min(min(ly, ey - 1 - ly), zreach));
    if (pp.errors && live)
      *pp.oracle(r) = central ? make_float2(syz[oy * n + gz], rsyz[oy * n + gz])
                              : make_float2(0.0f, 0.0f);
    pp.nu[r] = pp.nf[r] = 0.0f;
    pp.nv[r] = Conv<VT>::from(0.0f);
    pp.nc[r] = Conv<CT>::from(0.0f);
#pragma unroll
    for (int s = 0; s < K; ++s) {
      pp.W[s][r][0] = pp.W[s][r][1] = 0.0f;
      pp.V[s][r][0] = pp.V[s][r][1] = pp.C[s][r][0] = pp.C[s][r][1] = 0.0f;
      pp.F[s][r][0] = pp.F[s][r][1] = 0.0f;
    }
  }
  pp.wcentral = __any_sync(0xffffffffu, (pp.flags >> R) & ((1u << R) - 1u));
  if (pp.errors) {
    // The segment's oracle rows; the first step's barrier publishes them.
    for (int i = tid; i < K * pp.L; i += blockDim.x)
      pipe_sx[i / pp.L][i % pp.L] =
          sxct[(int64_t)(i / pp.L) * d + pp.x1 + i % pp.L];
    // A warp without central cells never reduces: its slots hold 0.
    if (!pp.wcentral && (tid & 31) < 2 * 2 * K)
      pipe_wmax[(tid & 31) / (2 * K)][(tid & 31) / 2 % K][tid & 1][tid >> 5] =
          0u;
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
  int d, n, py, ny, y0, bx, seg, ty, tz, r;
  float coeff, ix, iy, iz;
  int lanes;
  int64_t lane_stride;
};

// The threads a launch of face (ty, tz) at R rows a thread takes.
template <int K>
int pipe_threads(const Args& a) {
  const int ez = a.tz + 2 * K, nrb = (a.ty + 2 * K + a.r - 1) / a.r;
  return (nrb * ez + 31) / 32 * 32;
}

template <int K, class S, typename VT, typename CT, bool HC, bool HF,
          bool LANES>
int launch_pipe(const Args& a, cudaStream_t stream) {
  auto kern = kstep_comp_pipe_kernel<K, S, VT, CT, HC, HF, LANES>;
  const int threads = pipe_threads<K>(a);
  if (threads > S::NT || a.seg > kPipeMaxSeg || a.tz + 2 * K > kPipeMaxEz)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem =
      (size_t)3 * K * CompPipe<K, S, VT, CT, HC, HF>::kSlot * sizeof(float) +
      (size_t)S::R * CompPipe<K, S, VT, CT, HC, HF>::kPlane * sizeof(float2);
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

// The blocked shapes (R > 1) built for a (k, storage, field, lane mode):
// the flagship's storage (f32 v, a bf16 carry) without a field, solo and
// lanes, at k = 4; one block size for each R.  Elsewhere R = 1 alone.
template <int K, typename VT, typename CT, bool HC, bool HF>
struct Blocked {
  static constexpr bool value = K == 4 && !HF && HC &&
                                std::is_same<VT, float>::value &&
                                std::is_same<CT, __nv_bfloat16>::value;
};

template <int K, typename VT, typename CT, bool HC, bool HF, bool LANES>
int launch_shape(const Args& a, cudaStream_t st) {
  if (a.r == 1)
    return launch_pipe<K, Shape<1, PipeThreads<K>::value>, VT, CT, HC, HF,
                       LANES>(a, st);
  if constexpr (Blocked<K, VT, CT, HC, HF>::value) {
    if (a.r == 2)
      return launch_pipe<K, Shape<2, 640>, VT, CT, HC, HF, LANES>(a, st);
    if (a.r == 3)
      return launch_pipe<K, Shape<3, 512>, VT, CT, HC, HF, LANES>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K4's storage modes, each with and without a field; the lane mode in
// the flagship's storage (f32 v, bf16 carry), without a field.
template <int K>
int launch_comp_mode(int v_dtype, int carry_dtype, const Args& a,
                     cudaStream_t st) {
  const bool field = a.c2 != nullptr;
  if (a.lanes > 1)
    return v_dtype == WT_F32 && carry_dtype == WT_BF16 && !field
               ? launch_shape<K, float, __nv_bfloat16, true, false, true>(
                     a, st)
               : (int)cudaErrorInvalidValue;
#define WT_COMP(VT, CT, HC)                                          \
  return field ? launch_shape<K, VT, CT, HC, true, false>(a, st) \
               : launch_shape<K, VT, CT, HC, false, false>(a, st)
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
// seg <= 64 divides bx, bx divides d; r face rows a thread (a shape built
// for this k and storage), ceil((ty + 2k) / r)(tz + 2k) threads fit its
// block; a plane holds fewer than 2^31 cells.  `lanes` > 1 is K4's lane
// mode (whole y rows, f32 v, a bf16 carry, no field): u, v, the carry,
// their windows and the outputs hold `lanes` lanes `lane_stride` elements
// apart, sxct and the rows (lanes, k, d).
int wt_kstep_comp_chain(const void* u, const void* ulo, const void* uhi,
                        const void* v, const void* vlo, const void* vhi,
                        const void* carry, void* u_out, void* v_out,
                        void* carry_out, const void* c2, const void* c2lo,
                        const void* c2hi, const void* syz, const void* rsyz,
                        const void* sxct, void* dmax, void* rmax, int d,
                        int n, int py, int ny, int y0, int k, int bx,
                        int seg, int ty, int tz, int r, int v_dtype,
                        int carry_dtype, double coeff, double ix, double iy,
                        double iz, int lanes, int64_t lane_stride,
                        void* stream) {
  const bool whole = py == ny && ny == n && y0 == 0;
  const bool ext = py == ny + 2 * k && y0 >= 0 && y0 < n;
  if (seg < 1 || bx < 1 || bx % seg || d % bx || k < 1 || k > 8 ||
      ny < 1 || !(whole || ext) || ty < 1 || tz < 1 || r < 1 || lanes < 1 ||
      (lanes > 1 && !whole) || (int64_t)(d / seg) * lanes > 65535 ||
      (int64_t)py * n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{u, ulo, uhi, v, vlo, vhi, carry,
               u_out, v_out, carry_out,
               c2, c2lo, c2hi, syz, rsyz, sxct,
               dmax, rmax,
               d, n, py, ny, y0, bx, seg, ty, tz, r,
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

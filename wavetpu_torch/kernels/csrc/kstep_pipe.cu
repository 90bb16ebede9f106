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
// At R = 1 (`StdPipe`) one thread per (y, z) column of the (ty+2k)(tz+2k)
// halo face:
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
// Register blocking (`StdBlock`, as comp_sharded.cu's K4 body): in a
// blocked shape (`Shape`: R face rows a thread, at most NT threads) a
// thread owns R adjacent y rows of one z column (lz = tid mod ez, rows
// R*(tid / ez) .. + R-1), so a block has ceil(ey / R) * ez threads.  Per
// cell and stage:
//   * Registers: u of the plane the stage made last step (the next
//     stage's centre) and this step (its right x neighbour), and u_prev and
//     the field cell beside them (`W`, `P`, `F`, slot = step mod 2).
//   * The ring: each stage publishes its plane into its own three-slot ring
//     [k][3][R planes of the thread index] (plane r holds row r of every
//     thread's rows, at kStdMaxEz + tid: a guard of kStdMaxEz words either
//     side, so every read stays inside the ring and every offset from the
//     thread's index is fixed at compile time but the face width ez).  A
//     stage reads the slot of last step's plane for its z neighbours and
//     its outer rows' y neighbours (the y neighbours between the thread's
//     rows are its registers), and the slot of two steps ago for its left
//     x neighbour (its own word).  One barrier per step orders everything:
//     a slot is rewritten three steps after it was published.
//   * The R cells are R independent chains inside a stage, computed without
//     a branch; a thread whose cells all lie outside the stage's face skips
//     the stage.  A cell outside the face computes from whatever its
//     neighbours hold and nothing reads it: a cell of stage s's face reads
//     only cells of stage s-1's, and only central cells are stored or
//     reduced.
//   * Per step a thread resolves the x chain once for its R cells and
//     issues R loads per array, one step ahead, kept as stored.
//   * The error rows: a thread folds its R central cells' errors into one
//     value (a max on the float bits) before the warp's reduction; a warp
//     with no central cell skips it, its slots held at 0.  A cell's oracle
//     pair (syz, rsyz) waits in shared memory beside the ring.
// The op order of each cell is R = 1's, so every shape gives the same bits.
// stencil_cuda.kstep_pipe_block picks the shape per k, state dtype, field,
// pad, lane and y mode: the fastest of kernels/tile_ab.py's A/B (part
// `kpipe`) that ptxas builds without a spill; the rest keep R = 1.
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
// 96 instantiations at R = 1 (the pad mode is K9's with n_real < d; the
// lane mode K3's with lanes > 1, a compile-time mode, so the solo kernels
// carry none of it), plus the seven blocked shapes of `launch_shape`
// (those stencil_cuda._KSTEP_CHOICE launches, k = 4, f32).  The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().  Wrappers, plain PyTorch
// versions and launch counters: stencil_cuda.fused_kstep,
// fused_kstep_sharded, fused_kstep_padded and fused_kstep_sharded_xy; the
// shape: stencil_cuda.kstep_pipe_block.

#include <type_traits>

#include "plane.cuh"

// The longest segment (the oracle rows of a segment sit in shared memory)
// and the largest k.
constexpr int kStdMaxSeg = 128;
constexpr int kStdMaxK = 8;
// The widest face (columns) a blocked shape's ring guards hold.
constexpr int kStdMaxEz = 64;

// Shared memory of a block, declared at file scope so that every access is
// a shared-space access: the stages' u rings (dynamic: [k][2][cols] at
// R = 1; [k][3][R][plane] and the cells' oracle pairs [R][plane] in a
// blocked shape), the warps' error maxima [step parity][stage][abs|rel]
// [warp] and the segment's oracle rows sxct[stage][plane].
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

// A block's shape: R face rows a thread, at most NT threads, one block an
// SM (__launch_bounds__: 65536 / NT registers a thread, in steps of 8).
// R = 1 is the one-column-a-thread body (`StdPipe`), at StdThreads<K>.
template <int R_, int NT_>
struct Shape {
  static constexpr int R = R_, NT = NT_;
};

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

// One thread's pipeline in a blocked shape: R adjacent y rows of one z
// column of the halo face (rows R * (tid / ez) .. + R-1, column tid mod
// ez), their operands and their registers.  Per cell and stage the
// registers hold u of the plane the stage made last step (the next
// stage's centre) and this step (its right x neighbour), and u_prev and
// the field cell beside them (`W`, `P`, `F`, slot = step mod 2); the left
// x neighbour is the stage's ring word of two steps ago.
template <int K, class S, typename T, bool HF, bool PAD>
struct StdBlock {
  static constexpr int R = S::R;
  // A ring slot: R planes of the thread rows (plane r holds row r of every
  // thread's rows, index tid), each with a guard of kStdMaxEz words on
  // either side, so every offset from the thread's index is known at
  // compile time but the face's width ez.
  static constexpr int kPlane = S::NT + 2 * kStdMaxEz;
  static constexpr int kSlot = R * kPlane;
  Chain<T> up;  // u_prev
  Chain<T> u;
  Chain<float> c2;
  T* prev_out;
  T* out;
  unsigned* dmax;
  unsigned* rmax;
  int tid, d, L, x1;
  int n_real;  // the block's real planes: outputs and rows past them are 0
  int ez;      // the face's columns
  int reach;   // the last stage whose face holds one of its cells (-1: none)
  bool wcentral;  // the warp holds a central cell (its rows are reduced)
  int nn, onn;    // input / output plane strides (cells)
  int odelta;     // a cell's input-plane offset less its output-plane offset
  int64_t lane_off;  // the lane's first cell (lane mode)
  // Per cell: its (y, z) offset in an input plane, and bits r and R + r of
  // `flags`: off the Dirichlet planes, a central (output) cell.
  int row[R];
  unsigned flags;
  float coeff, ix, iy, iz;
  bool errors;

  float W[K][R][2];  // u of stage s at the planes it made in the last 2 steps
  float P[K][R][2];  // u_prev and field cell of stage s's last 2 planes
  float F[K][R][2];
  // The incoming plane's cells as stored: converted where stage 0 takes
  // them, a step after the load, so no thread waits for its load.
  T nu[R], np[R];
  float nf[R];

  __device__ __forceinline__ bool bit(int b) const { return (flags >> b) & 1u; }

  // The oracle plane's (syz, rsyz) at the thread's cell r, after the ring.
  __device__ __forceinline__ float2* oracle(int r) const {
    return reinterpret_cast<float2*>(std_ring + 3 * K * kSlot) + r * kPlane +
           kStdMaxEz + tid;
  }

  // The ring word of the thread's cell r in slot q of stage s.
  __device__ __forceinline__ float* ring(int s, int q, int r) const {
    return std_ring + (s * 3 + q) * kSlot + r * kPlane + kStdMaxEz + tid;
  }

  // Load chain plane j (x = x1 - K + j) of the thread's cells into nu, np,
  // nf: the chain lo window | block[:n_real] | hi window | zero resolved
  // once for the R cells (`pad_chain_pos`'s cases; n_real = d without PAD,
  // so the last case never arises and is not compiled).
  __device__ __forceinline__ void load(int j) {
    if (reach < 0) return;
    const int xu = x1 - K + j;
    const int end = PAD ? n_real : d;
    const int w = xu < 0 ? 0 : (xu < end ? 1 : 2);
    if (PAD && xu >= end + K) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        nu[r] = np[r] = Conv<T>::from(0.0f);
        nf[r] = 0.0f;
      }
      return;
    }
    const int64_t base =
        lane_off + (int64_t)(w == 0 ? xu + K : (w == 1 ? xu : xu - end)) * nn;
    const T* pu = (w == 0 ? u.lo : (w == 1 ? u.blk : u.hi)) + base;
    const T* pp = (w == 0 ? up.lo : (w == 1 ? up.blk : up.hi)) + base;
    const float* pf = HF ? (w == 0 ? c2.lo : (w == 1 ? c2.blk : c2.hi)) + base
                         : nullptr;
#pragma unroll
    for (int r = 0; r < R; ++r) {  // a padding row's cell reads a valid one
      nu[r] = pu[row[r]];
      np[r] = pp[row[r]];
      if (HF) nf[r] = pf[row[r]];
    }
  }

  // The warp's max of its cells' folded errors into its slot
  // std_wmax[q][s-1][.][warp].  Every lane of a warp that holds central
  // cells calls it.
  __device__ __forceinline__ void reduce(int q, int s, unsigned db,
                                         unsigned rb) {
    db = __reduce_max_sync(0xffffffffu, db);
    rb = __reduce_max_sync(0xffffffffu, rb);
    if ((tid & 31) == 0) {
      std_wmax[q][s - 1][0][tid >> 5] = db;
      std_wmax[q][s - 1][1][tid >> 5] = rb;
    }
  }

  // Flush the rows reduced at step t (parity q) into dmax / rmax, as
  // StdPipe::flush.
  __device__ __forceinline__ void flush(int q, int t) {
    const int lane = tid & 31, warps = (blockDim.x + 31) >> 5;
    for (int pair = tid >> 5; pair < 2 * K; pair += warps) {
      const int s = (pair >> 1) + 1, which = pair & 1, p = t - s;
      // uniform across the warp
      if (p < K || p >= K + L || (PAD && x1 - K + p >= n_real)) continue;
      unsigned m = lane < warps ? std_wmax[q][s - 1][which][lane] : 0u;
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
  __device__ __forceinline__ void step(int t, StdPhase<PH>) {
    constexpr int q0 = PH % 3;        // ring slot of this step's plane
    constexpr int q1 = (PH + 2) % 3;  // ... of the last step's
    constexpr int q2 = (PH + 1) % 3;  // ... of the step before
    constexpr int r0 = PH % 2, r1 = (PH + 1) % 2;  // register slots
    const int planes = L + 2 * K;
    __syncthreads();
    if (errors && t > 0) flush(r1, t - 1);
    if (t < planes) {  // stage 0: the incoming plane t
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float u0 = Conv<T>::to(nu[r]);
        W[0][r][r0] = u0;
        P[0][r][r0] = Conv<T>::to(np[r]);
        if (HF) F[0][r][r0] = nf[r];
        if (reach >= 0) *ring(0, q0, r) = u0;
      }
      if (t + 1 < planes) load(t + 1);
    }
#pragma unroll
    for (int s = 1; s <= K; ++s) {
      const int p = t - s;  // the plane stage s makes at this step
      if (p < s || p >= planes - s) continue;  // uniform across the block
      // The rows of this plane, reduced by the warps that hold central
      // cells (the others' slots stay 0).
      const bool rows = errors && wcentral && p >= K && p < K + L;
      unsigned db = 0u, rb = 0u;
      if (reach >= s) {
        // The outer rows' y neighbours: the last row of the thread rows
        // above, the first of those below.
        const float ym0 = ring(s - 1, q1, R - 1)[-ez];
        const float ypR = ring(s - 1, q1, 0)[ez];
        const float sxs = rows ? std_sx[s - 1][p - K] : 0.0f;
        const int x = x1 - K + p;  // the plane's index in the block
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float c = W[s - 1][r][r1];
          const float ym = r == 0 ? ym0 : W[s - 1][r - 1][r1];
          const float yp = r == R - 1 ? ypR : W[s - 1][r + 1][r1];
          const float* pz = ring(s - 1, q1, r);
          // common.cuh cone_laplacian's sums: the right x neighbour (made
          // by stage s-1 this step) and the inner y neighbours from
          // registers, the left x neighbour from the ring's slot of two
          // steps ago.
          float lap = (*ring(s - 1, q2, r) + W[s - 1][r][r0] - 2.0f * c) * ix;
          lap = lap + (ym + yp - 2.0f * c) * iy;
          lap = lap + (pz[-1] + pz[1] - 2.0f * c) * iz;
          const float co = HF ? F[s - 1][r][r1] : coeff;
          float o = 2.0f * c + co * lap;
          o = o - P[s - 1][r][r1];
          o = bit(r) ? o : 0.0f;
          o = Conv<T>::to(Conv<T>::from(o));  // the 1-step path's store
          if (s < K) {
            W[s][r][r0] = o;
            P[s][r][r0] = c;
            if (HF) F[s][r][r0] = F[s - 1][r][r1];
            *ring(s, q0, r) = o;
          } else if (bit(R + r)) {
            const bool real = !PAD || x < n_real;
            const int64_t g = lane_off + (int64_t)x * onn - odelta + row[r];
            prev_out[g] = Conv<T>::from(real ? c : 0.0f);
            out[g] = Conv<T>::from(real ? o : 0.0f);
          }
          if (rows) {
            const float2 orc = *oracle(r);
            const float diff = fabsf(o - sxs * orc.x);
            const unsigned a = __float_as_uint(diff);
            const unsigned b = __float_as_uint(fabsf(diff * orc.y));
            db = bit(R + r) ? max(db, a) : db;
            rb = bit(R + r) ? max(rb, b) : rb;
          }
        }
      }
      if (rows) reduce(r0, s, db, rb);
    }
  }
};

// The kernel's body at R = 1 (`StdPipe`, one column a thread).
template <int K, typename T, bool HF, bool PAD, bool LANES>
__device__ __forceinline__ void run_one(
    Chain<T> up, Chain<T> u, T* __restrict__ prev_out, T* __restrict__ out,
    Chain<float> c2, const float* __restrict__ syz,
    const float* __restrict__ rsyz, const float* __restrict__ sxct,
    unsigned* __restrict__ dmax, unsigned* __restrict__ rmax, int d, int n,
    int n_real, int py, int ny, int y0, int seg, int ty, int tz, float coeff,
    float ix, float iy, float iz, int xs, int lane, int64_t lane_stride) {
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

// The kernel's body in a blocked shape S (`StdBlock`, R rows a thread).
template <int K, class S, typename T, bool HF, bool PAD, bool LANES>
__device__ __forceinline__ void run_blocked(
    Chain<T> up, Chain<T> u, T* __restrict__ prev_out, T* __restrict__ out,
    Chain<float> c2, const float* __restrict__ syz,
    const float* __restrict__ rsyz, const float* __restrict__ sxct,
    unsigned* __restrict__ dmax, unsigned* __restrict__ rmax, int d, int n,
    int n_real, int py, int ny, int y0, int seg, int ty, int tz, float coeff,
    float ix, float iy, float iz, int xs, int lane, int64_t lane_stride) {
  constexpr int R = S::R;
  StdBlock<K, S, T, HF, PAD> pp;
  pp.up = up;
  pp.u = u;
  pp.c2 = c2;
  pp.prev_out = prev_out;
  pp.out = out;
  pp.dmax = dmax;
  pp.rmax = rmax;
  pp.L = seg;
  pp.d = d;
  pp.n_real = n_real;
  // The last segment ends at d: where seg does not divide d it starts at
  // d - seg and remakes planes of the segment before it (the same bits).
  pp.x1 = min(xs * seg, d - seg);
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
  // row oy of a K10 block is input row oy + K (a clamped input row is no
  // output row); K3, K8 and K9 read and write the same row.
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
                (unsigned)central << (R + r);
    if (cl) pp.reach = max(pp.reach, min(min(ly, ey - 1 - ly), zreach));
    if (pp.errors && live)
      *pp.oracle(r) = central ? make_float2(syz[oy * n + gz], rsyz[oy * n + gz])
                              : make_float2(0.0f, 0.0f);
    pp.nu[r] = pp.np[r] = Conv<T>::from(0.0f);
    pp.nf[r] = 0.0f;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      pp.W[s][r][0] = pp.W[s][r][1] = 0.0f;
      pp.P[s][r][0] = pp.P[s][r][1] = pp.F[s][r][0] = pp.F[s][r][1] = 0.0f;
    }
  }
  pp.wcentral = __any_sync(0xffffffffu, (pp.flags >> R) & ((1u << R) - 1u));
  if (pp.errors) {
    // The segment's oracle rows; the first step's barrier publishes them.
    for (int i = tid; i < K * pp.L; i += blockDim.x)
      std_sx[i / pp.L][i % pp.L] =
          sxct[(int64_t)(i / pp.L) * d + pp.x1 + i % pp.L];
    // A warp without central cells never reduces: its slots hold 0.
    if (!pp.wcentral && (tid & 31) < 2 * 2 * K)
      std_wmax[(tid & 31) / (2 * K)][(tid & 31) / 2 % K][tid & 1][tid >> 5] =
          0u;
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

template <int K, class S, typename T, bool HF, bool PAD, bool LANES>
__global__ void __launch_bounds__(S::NT, 1)
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
  // array, an offset folded into the column's cell offsets (R = 1) or
  // added to each plane's (blocked), not into the array pointers, which
  // then stay kernel parameters.  The solo instantiations compile without
  // any of it.
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
  if constexpr (S::R == 1)
    run_one<K, T, HF, PAD, LANES>(up, u, prev_out, out, c2, syz, rsyz, sxct,
                                  dmax, rmax, d, n, n_real, py, ny, y0, seg,
                                  ty, tz, coeff, ix, iy, iz, xs, lane,
                                  lane_stride);
  else
    run_blocked<K, S, T, HF, PAD, LANES>(
        up, u, prev_out, out, c2, syz, rsyz, sxct, dmax, rmax, d, n, n_real,
        py, ny, y0, seg, ty, tz, coeff, ix, iy, iz, xs, lane, lane_stride);
}

struct StdArgs {
  const void *up, *uplo, *uphi, *u, *ulo, *uhi;
  void *prev_out, *out;
  const void *c2, *c2lo, *c2hi, *syz, *rsyz, *sxct;
  void *dmax, *rmax;
  int d, n, n_real, py, ny, y0, seg, ty, tz, r, nt;
  float coeff, ix, iy, iz;
  int lanes;
  int64_t lane_stride;
};

template <int K, class S, typename T, bool HF, bool PAD, bool LANES>
int launch_std(const StdArgs& a, cudaStream_t stream) {
  constexpr int R = S::R;
  auto kern = kstep_pipe_kernel<K, S, T, HF, PAD, LANES>;
  const int ez = a.tz + 2 * K, nrb = (a.ty + 2 * K + R - 1) / R;
  const int threads = (nrb * ez + 31) / 32 * 32;
  if (threads > S::NT || a.seg > kStdMaxSeg || (R > 1 && ez > kStdMaxEz))
    return (int)cudaErrorInvalidConfiguration;
  using B = StdBlock<K, S, T, HF, PAD>;
  const size_t shmem =
      R == 1 ? (size_t)2 * K * (a.ty + 2 * K) * ez * sizeof(float)
             : (size_t)3 * K * B::kSlot * sizeof(float) +
                   (size_t)R * B::kPlane * sizeof(float2);
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

// The instantiation of shape (a.r, a.nt): R = 1 at StdThreads<K>, or a
// blocked shape built for this (k, state dtype, field, pad, lane mode):
// those stencil_cuda._KSTEP_CHOICE launches, at k = 4 for an f32 state
// (the fastest spill-free shapes of kernels/tile_ab.py part `kpipe`;
// PERF.md).  Elsewhere R = 1 alone.
template <int K, typename T, bool HF, bool PAD, bool LANES>
int launch_shape(const StdArgs& a, cudaStream_t st) {
  if (a.r == 1 && a.nt == StdThreads<K>::value)
    return launch_std<K, Shape<1, StdThreads<K>::value>, T, HF, PAD, LANES>(
        a, st);
  if constexpr (K == 4 && std::is_same<T, float>::value) {
#define WT_SHAPE(RR, NN)       \
  if (a.r == RR && a.nt == NN) \
  return launch_std<K, Shape<RR, NN>, T, HF, PAD, LANES>(a, st)
    if constexpr (!HF && !PAD) {  // K3, K8, K10 and K3's lanes
      WT_SHAPE(4, 512);
    } else if constexpr (!HF) {  // K9
      WT_SHAPE(2, 768);
    } else {  // K3f, K8f, K9f and K3f's lanes; K10f
      WT_SHAPE(3, 512);
      if constexpr (!PAD && !LANES) WT_SHAPE(2, 640);
    }
#undef WT_SHAPE
  }
  return (int)cudaErrorInvalidValue;
}

template <int K, typename T>
int launch_std_mode(const StdArgs& a, cudaStream_t st) {
  const bool field = a.c2 != nullptr, pad = a.n_real < a.d;
  if (a.lanes > 1)
    return field ? launch_shape<K, T, true, false, true>(a, st)
                 : launch_shape<K, T, false, false, true>(a, st);
  if (pad)
    return field ? launch_shape<K, T, true, true, false>(a, st)
                 : launch_shape<K, T, false, true, false>(a, st);
  return field ? launch_shape<K, T, true, false, false>(a, st)
               : launch_shape<K, T, false, false, false>(a, st);
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
// ceil(d / seg) segments ends at d); r face rows a thread on blocks of at
// most nt threads (a shape built for this k, dtype, field and mode: r = 1
// at 1024 threads for k <= 4, 640 above), ceil((ty + 2k) / r)(tz + 2k)
// threads fit it; at r > 1 tz + 2k <= 64 and a plane holds fewer than
// 2^31 cells.  `lanes` > 1 is K3's lane mode (whole y rows, no pad): every
// state, window, output and field array holds `lanes` lanes `lane_stride`
// elements apart, sxct and the rows (lanes, k, d).
int wt_kstep_pipe(const void* uprev, const void* uplo, const void* uphi,
                  const void* u, const void* ulo, const void* uhi,
                  void* prev_out, void* out, const void* c2,
                  const void* c2lo, const void* c2hi, const void* syz,
                  const void* rsyz, const void* sxct, void* dmax,
                  void* rmax, int d, int n, int n_real, int py, int ny,
                  int y0, int k, int seg, int ty, int tz, int r, int nt,
                  int dtype, double coeff, double ix, double iy, double iz,
                  int lanes, int64_t lane_stride, void* stream) {
  const bool whole = py == ny && ny == n && y0 == 0;
  const bool ext = py == ny + 2 * k && y0 >= 0 && y0 < n;
  if (seg < 1 || seg > d || k < 1 || k > kStdMaxK || ny < 1 ||
      !(whole || ext) || n_real < 1 || n_real > d || ty < 1 || tz < 1 ||
      r < 1 || lanes < 1 || (lanes > 1 && !(whole && n_real == d)) ||
      (int64_t)((d + seg - 1) / seg) * lanes > 65535 ||
      (r > 1 && (int64_t)py * n > 0x7fffffff))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StdArgs a{uprev, uplo, uphi, u, ulo, uhi,
                  prev_out, out,
                  c2, c2lo, c2hi, syz, rsyz, sxct,
                  dmax, rmax,
                  d, n, n_real, py, ny, y0, seg, ty, tz, r, nt,
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

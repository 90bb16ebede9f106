// The sharded kernels: hand-written Hopper (sm_90a) counterparts of the
// Pallas kernels that wavetpu's multi-shard solvers launch on every shard
// (wavetpu/kernels/stencil_pallas.py):
//
//   K6  sharded_lanes_kernel    <- _sharded_kernel (sharded_fused_step)
//       (constant speed: the lane mode, and solo blocks of >= 32 planes
//       and >= 32 rows; x-streaming)
//       sharded_step_kernel     (constant speed: thinner solo blocks)
//   K6f sharded_step_kernel     <- _sharded_kernel with a field
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
// (comm/halo.collect_ghosts with lanes).  It is its own kernel,
// `sharded_lanes_kernel`, an x-streaming design (below), and the solo
// constant-speed K6 is that kernel on one lane where the block is thick
// enough (kernels/stencil_cuda.py k6_solo_streams); a lane's cells run
// the one-thread-per-cell body's op sequence.  That body
// (sharded_step_kernel) runs K6f and the thin solo blocks (the overlap
// mode's one-plane faces).  Every entry point launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
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
// written; 16 with a field), 24 for K7 f32.  Design (K6f, K7): K1's, one
// thread per cell in a 32 (z) x 8 (y) block per x plane; the ghost planes
// are read in place of the wrapped neighbour at the block faces only.

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

// ---------------------------------------------------------------------------
// K6's lane mode: an x-streaming kernel for Hopper.
//
// Bound: bytes, 12 B a cell in f32 (u and u_prev read once, out written
// once; the ghost faces besides), about 19 f32 operations a cell - far
// below the f32 ridge (~20 operations a byte), so no tensor cores.  The
// solo body reads each u cell from L1/L2 up to seven times, once for each
// neighbour, and its x neighbours live in other blocks' planes.  Here a
// block owns one (ty x 32) y/z tile of one lane's block and marches it
// through an x segment of `seg` planes:
//   * each plane's u tile with its y/z halo ((ty+2) x 34 cells, the
//     corners skipped) and the plane's u_prev tile arrive in shared memory
//     by cp.async, kLaneDepth planes ahead of the plane being computed,
//     in a ring of kLaneDepth + 2 buffers (one barrier a plane);
//   * a thread owns one (y, z) column: its x-1 cell is the last plane's
//     centre, kept in a register, its x+1 cell the next buffer's centre;
//     its y and z neighbours are read from the tile.
// So each u cell comes from device memory about once (plus the tile
// halo, which neighbouring tiles share through L2, and one plane at each
// segment end), u_prev once and out is written once, coalesced along z.
// The lane, segment and tile come from blockIdx.x once per block and the
// state and ghost pointers are offset once per block.  The halo cells are
// classified (block, ghost face or the block's wrap plane) once per block
// too: each thread keeps one source pointer and x stride for its centre
// cell and at most one for a halo cell.  A bf16 cell (2 bytes; cp.async
// copies 4, 8 or 16) is copied by the thread itself, synchronously.
// The op sequence is the solo body's (ghost_laplacian, then the update),
// so each lane equals the solo launch bit for bit.

constexpr int kLaneTz = 32;            // threads (columns) along z
constexpr int kLaneMaxTy = 8;          // rows along y, at most
constexpr int kLaneDepth = 8;          // planes fetched ahead
constexpr int kLaneRow = kLaneTz + 2;  // a tile row with its z halo
// Six resident blocks an SM: <= 42 registers a thread (ptxas: 40).  The
// ty, depth and register budget won a sweep on the card (PERF.md).
constexpr int kLaneMinBlocks = 6;

// The launch's tiling: z tiles, y tiles, x segments of `seg` planes.
struct LaneTiles {
  int nzt, nyt, nseg, seg;
};

template <typename T>
struct Src {
  const T* p;  // the cell at plane x = 0 (null: no cell to fetch)
  int64_t sx;  // its stride along x
};

// Where the tile cell at block row yy (-1..by) and column zz (-1..bz)
// comes from: the block, a y or z ghost face, or the block's own wrap
// plane (mesh dim 1), as ghost_laplacian reads it; null where no owned
// column reads it (a tile corner, or past the block's hi neighbour).
template <typename T>
__device__ __forceinline__ Src<T> tile_src(const T* u, const Halo<T>& h,
                                           const Geom& g, int yy, int zz) {
  const int64_t pl = (int64_t)g.by * g.bz;
  const bool yin = yy >= 0 && yy < g.by, zin = zz >= 0 && zz < g.bz;
  if (yin && zin) return {u + (int64_t)yy * g.bz + zz, pl};
  if (zin && (yy == -1 || yy == g.by)) {
    const T* gh = yy < 0 ? h.ylo : h.yhi;  // (bx, 1, bz): x * bz + z
    if (gh) return {gh + zz, g.bz};
    return {u + (int64_t)(yy < 0 ? g.by - 1 : 0) * g.bz + zz, pl};
  }
  if (yin && (zz == -1 || zz == g.bz)) {
    const T* gh = zz < 0 ? h.zlo : h.zhi;  // (bx, by, 1): x * by + y
    if (gh) return {gh + yy, g.by};
    return {u + (int64_t)yy * g.bz + (zz < 0 ? g.bz - 1 : 0), pl};
  }
  return {nullptr, 0};
}

// One cell into shared memory: cp.async for 4- and 8-byte cells, a plain
// copy for bf16.
template <typename T>
__device__ __forceinline__ void fetch(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"((int)sizeof(T)));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void fetch_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void fetch_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

template <typename T>
__global__ void __launch_bounds__(kLaneTz * kLaneMaxTy, kLaneMinBlocks)
    sharded_lanes_kernel(const T* __restrict__ uprev,
                         const T* __restrict__ u, T* __restrict__ out,
                         Halo<T> h, Geom g, LaneTiles t,
                         typename Conv<T>::F alpha, typename Conv<T>::F beta,
                         typename Conv<T>::F coeff, typename Conv<T>::F ix,
                         typename Conv<T>::F iy, typename Conv<T>::F iz,
                         int use_beta) {
  using F = typename Conv<T>::F;
  constexpr int kStages = kLaneDepth + 2;  // i - 1 .. i + kLaneDepth
  extern __shared__ __align__(16) unsigned char lane_smem[];
  T* const ring = reinterpret_cast<T*>(lane_smem);
  const int ty = blockDim.y;
  const int tile = (ty + 2) * kLaneRow;  // a stage: u tile, then u_prev
  const int stage = tile + ty * kLaneTz;

  // The block's tile, segment and lane, and the lane's operands.
  int b = blockIdx.x;
  const int zt = b % t.nzt;
  b /= t.nzt;
  const int yt = b % t.nyt;
  b /= t.nyt;
  const int sg = b % t.nseg;
  const int lane = b / t.nseg;
  const int x0 = sg * t.seg, nx = min(t.seg, g.bx - x0);
  const int64_t pl = (int64_t)g.by * g.bz;
  const int64_t blk = (int64_t)lane * g.bx * pl;
  uprev += blk;
  u += blk;
  out += blk;
  if (h.xlo) h.xlo += lane * pl, h.xhi += lane * pl;
  if (h.ylo) {
    const int64_t f = (int64_t)lane * g.bx * g.bz;
    h.ylo += f, h.yhi += f;
  }
  if (h.zlo) {
    const int64_t f = (int64_t)lane * g.bx * g.by;
    h.zlo += f, h.zhi += f;
  }

  // This thread's column, its cells in a stage and their sources.
  const int lz = threadIdx.x, ly = threadIdx.y;
  const int tid = ly * kLaneTz + lz;
  const int y1 = yt * ty, z1 = zt * kLaneTz;
  const int y = y1 + ly, z = z1 + lz;
  const bool owner = y < g.by && z < g.bz;
  const int centre = (ly + 1) * kLaneRow + lz + 1;
  const Src<T> cs = tile_src(u, h, g, y, z);
  int halo = -1;  // the halo cell this thread fetches (corners skipped)
  Src<T> hs{nullptr, 0};
  if (tid < 2 * (kLaneTz + ty)) {
    int r, c;
    if (tid < kLaneTz) {
      r = 0, c = tid + 1;
    } else if (tid < 2 * kLaneTz) {
      r = ty + 1, c = tid - kLaneTz + 1;
    } else if (tid < 2 * kLaneTz + ty) {
      r = tid - 2 * kLaneTz + 1, c = 0;
    } else {
      r = tid - 2 * kLaneTz - ty + 1, c = kLaneTz + 1;
    }
    halo = r * kLaneRow + c;
    hs = tile_src(u, h, g, y1 - 1 + r, z1 - 1 + c);
  }
  const bool with_prev = owner && use_beta;
  const int64_t yz = (int64_t)y * g.bz + z;
  // in_domain, split: the column's y/z half once, x < x_end per plane.
  const int gy = g.oy + y, gz = g.oz + z;
  const bool col_in = gy != 0 && gz != 0 && (!g.pady || gy < g.n) &&
                      (!g.padz || gz < g.n);
  const int x_end = g.padx ? g.n - g.ox : g.bx;

  auto fetch_plane = [&](int i) {  // plane x0 + i into its stage
    T* st = ring + (i % kStages) * stage;
    const int64_t x = x0 + i;
    if (cs.p) fetch(st + centre, cs.p + x * cs.sx);
    if (hs.p) fetch(st + halo, hs.p + x * hs.sx);
    if (with_prev) fetch(st + tile + tid, uprev + x * pl + yz);
  };
#pragma unroll
  for (int i = 0; i < kLaneDepth; ++i) {
    if (i < nx) fetch_plane(i);
    fetch_commit();
  }
  // The x neighbours past the segment's ends: the block's planes, an x
  // ghost face, or the block's wrap plane.
  F xm = F(0), last = F(0), c = F(0);
  if (owner) {
    xm = Conv<T>::to(x0 > 0 ? u[(x0 - 1) * pl + yz]
                     : h.xlo ? h.xlo[yz]
                             : u[(g.bx - 1) * pl + yz]);
    const int x1 = x0 + nx;
    last = Conv<T>::to(x1 < g.bx ? u[x1 * pl + yz]
                       : h.xhi   ? h.xhi[yz]
                                 : u[yz]);
  }
  for (int i = 0; i < nx; ++i) {
    if (i + kLaneDepth < nx) fetch_plane(i + kLaneDepth);
    fetch_commit();
    fetch_wait<kLaneDepth - 1>();  // planes i and i + 1 have landed
    __syncthreads();
    if (owner) {
      const T* st = ring + (i % kStages) * stage;
      if (i == 0) c = Conv<T>::to(st[centre]);
      const F xp =
          i + 1 < nx
              ? Conv<T>::to(ring[((i + 1) % kStages) * stage + centre])
              : last;
      F lap = (xm + xp - F(2) * c) * ix;
      lap = lap + (Conv<T>::to(st[centre - kLaneRow]) +
                   Conv<T>::to(st[centre + kLaneRow]) - F(2) * c) *
                      iy;
      lap = lap + (Conv<T>::to(st[centre - 1]) + Conv<T>::to(st[centre + 1]) -
                   F(2) * c) *
                      iz;
      F o = alpha * c + coeff * lap;
      if (use_beta) o = o - beta * Conv<T>::to(st[tile + tid]);
      const int x = x0 + i;
      out[x * pl + yz] = Conv<T>::from(col_in && x < x_end ? o : F(0));
      xm = c;
      c = xp;
    }
  }
}

dim3 grid_block(const Geom& g) {
  return dim3((g.bz + kRowThreads - 1) / kRowThreads,
              (g.by + kColThreads - 1) / kColThreads, g.bx);
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
  if (bx < 1 || by < 1 || bz < 1 || bx > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{bx, by, bz, ox, oy, oz, n, padx, pady, padz};
  const dim3 grid = grid_block(g), block(kRowThreads, kColThreads);
#define WT_STEP_F(T, F, FIELD)                                               \
  sharded_step_kernel<T, FIELD><<<grid, block, 0, st>>>(                     \
      static_cast<const T*>(uprev), static_cast<const T*>(u),                \
      static_cast<T*>(out), static_cast<const F*>(c2),                       \
      halo_of<T>(xlo, xhi, ylo, yhi, zlo, zhi), g, (F)alpha, (F)beta,        \
      (F)coeff, (F)ix, (F)iy, (F)iz, use_beta)
#define WT_STEP(T, F)                                                        \
  if (c2)                                                                    \
    WT_STEP_F(T, F, true);                                                   \
  else                                                                       \
    WT_STEP_F(T, F, false)
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
#undef WT_STEP_F
  return (int)cudaGetLastError();
}

// K6's lane mode: `lanes` blocks (lanes, bx, by, bz) and their (lanes,
// face) ghosts, constant speed; ghosts and pads as wt_sharded_step.  The
// block is 32 x ty threads (3 <= ty <= 8), the x segments `seg` planes
// (kernels/stencil_cuda.py k6_lane_tile chooses both); the grid is one
// dimension, so the batch has no cap but 2^31 - 1 blocks.
int wt_sharded_lanes(const void* uprev, const void* u, void* out,
                     const void* xlo, const void* xhi, const void* ylo,
                     const void* yhi, const void* zlo, const void* zhi,
                     int bx, int by, int bz, int ox, int oy, int oz, int n,
                     int padx, int pady, int padz, int dtype, double alpha,
                     double beta, double coeff, double ix, double iy,
                     double iz, int use_beta, int lanes, int seg, int ty,
                     void* stream) {
  // ty >= 3: the tile's 2 (32 + ty) halo cells need a thread each.
  if (bx < 1 || by < 1 || bz < 1 || lanes < 1 || seg < 1 || ty < 3 ||
      ty > kLaneMaxTy)
    return (int)cudaErrorInvalidValue;
  const LaneTiles t{(bz + kLaneTz - 1) / kLaneTz, (by + ty - 1) / ty,
                    (bx + seg - 1) / seg, seg};
  const int64_t blocks = (int64_t)t.nzt * t.nyt * t.nseg * lanes;
  if (blocks > 2147483647) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g{bx, by, bz, ox, oy, oz, n, padx, pady, padz};
  const dim3 block(kLaneTz, ty);
  // At most (8 + 2) x 596 cells: 47680 bytes for f64, under the 48 KB a
  // launch takes without opting in.
  const size_t cells =
      (kLaneDepth + 2) * ((ty + 2) * kLaneRow + ty * kLaneTz);
#define WT_LANES(T, F)                                                       \
  sharded_lanes_kernel<T><<<(unsigned)blocks, block, cells * sizeof(T),      \
                            st>>>(                                           \
      static_cast<const T*>(uprev), static_cast<const T*>(u),                \
      static_cast<T*>(out), halo_of<T>(xlo, xhi, ylo, yhi, zlo, zhi), g, t,  \
      (F)alpha, (F)beta, (F)coeff, (F)ix, (F)iy, (F)iz, use_beta)
  switch (dtype) {
    case WT_F32:
      WT_LANES(float, float);
      break;
    case WT_F64:
      WT_LANES(double, double);
      break;
    case WT_BF16:
      WT_LANES(__nv_bfloat16, float);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WT_LANES
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

}  // extern "C"

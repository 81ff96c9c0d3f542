// Volume preparation on the card: the gradient precompute of a density
// volume (K10) with its transpose (K13) and the cubic B-spline prefilter
// (K11) with its transpose (K12).
//
// None of the four replaces a TPU kernel (pl.pallas_call).  They are the
// port's counterparts of the JAX package's host C++ module
// photon_tpu/native/photon_native.cpp (gradient_field, :89;
// bspline_prefilter_3d, :165), which that package runs on the host before it
// hands arrays to the TPU; the prefilter the JAX fast path actually runs is
// photon_tpu/ops/march_dense.py::bspline_prefilter_jax (f32, lax.scan), and
// K12 is what jax.grad takes through it.  The reference photon ran the
// prefilter as CUDA kernels too (CubicInterpolationCUDA).
//
// This library is built with -fmad=false (kernels.py): no product and sum
// fuse, so each kernel rounds as its plain PyTorch version, whose eager
// operations cannot fuse either.
//
// K10, photon_gradient_field.  (dn/dx, dn/dy, dn/dz, n-1) as float4 in the
// march's (D, H, W) layout from float32 n-1 in the NRRD's (W, H, D) layout:
// the float32 samples widened to double, central differences inside,
// second-order one-sided differences at the faces, one rounding to float32
// at the end (native's arithmetic and the plain version's,
// photon_tpu_torch/native.py::gradient_field_plain, bit for bit).  Bound:
// bytes, 4 B in and 16 B out a voxel (5.2 MB at 64^3, 1.6 us at 3.35 TB/s;
// 2.7 GB at 512^3, 0.80 ms).  The input's contiguous axis is z and the
// output's is x, so a thread a voxel reads one of them strided (H*D floats
// between a warp's x taps, 32 sectors a load).  gradient_tile_kernel: a
// block of 256 threads owns an x-z tile of 32 x 32 voxels and walks a run
// of y planes (native.py, gradient_plan: runs of up to 16 planes, shorter
// where the grid would hold fewer than two waves of four blocks an SM).
// Each plane the stencils reach, with the tile's x and z halo (the samples
// reach_lo .. reach_hi of each axis: i - 1 .. i + 1 inside, 0 .. 2 and
// n - 3 .. n - 1 at the faces, so a last tile of one or two columns takes
// two columns below it), is copied into a staging buffer with cp.async, a
// row of contiguous z for each x (16 bytes a copy, the row widened to whole
// 16-byte words, where D is a multiple of 4 and the input 16-byte aligned),
// two planes in flight ahead of the one in hand.  Each sample is widened to
// double once, as it moves from the staging buffer into a ring of three
// double planes (plane p in slot p mod 3), not at each of the up to seven
// stencils that read it.  Conversions to and from double issue at 16 a
// clock on an SM, a quarter of the double adds: widened at each read, a
// voxel would spend seven of them beside the four roundings of its result,
// against about one; the price is a warp's 8-byte reads of the ring, two
// shared-memory wavefronts each (a ring row is an odd number of doubles,
// so 16 lanes meet 32 banks), where float reads would take one.  The
// stencils of any y read three consecutive planes, reach_lo(y) ..
// reach_lo(y) + 2, so output plane y is computed as soon as plane
// reach_hi(y) has entered (two planes at once at each face).  A warp
// computes z rows of the plane in hand, lane = x, and stores each as 32
// float4 in a row along x (512 contiguous bytes, evict-first).  The
// divisions stay IEEE double divisions: on an H100 the voxel loop's 115
// SASS instructions an interior voxel (33 of them double arithmetic, 3
// reciprocal seeds, 4 conversions) issue in 0.46 ms at 512^3, under the
// bytes bound, and the kernel takes 1.07-1.08 ms there (chip_smoke.py phase
// 14).

// K13, photon_gradient_field_transpose.  K10's transpose, the backward of
// photon_tpu_torch/inverse.py::volume_from_rho on the card: the (D, H, W, 4)
// float32 cotangent of the packed field -> the (W, H, D) float32 cotangent
// of rho, gd (S_x^T c0 + S_y^T c1 + S_z^T c2 + c3) with gd the
// Gladstone-Dale constant (n - 1 = gd rho), S an axis's stencil and c the
// field's four channels.  It replaces no TPU kernel: the JAX package's
// volume_from_rho (photon_tpu/inverse.py) leaves this transpose to XLA's
// autodiff, and the port ran it as PyTorch's autograd through the float32
// stencil (strided adds, cat and permute copies, some 68 ms a step at
// 512^3 on an H100).  In gather form sample j of an axis of n takes
// (c[j-1] - c[j+1]) / 2h, each term where its row is central, and the
// one-sided rows' weights (-1.5, 2, -0.5) / h on c[0] for j <= 2 and
// (0.5, -2, 1.5) / h on c[n-1] for j >= n - 3; a voxel sums
// ((x + z) + c3) + y in double, each 1 / 2h and 1 / h a reciprocal formed
// once, and rounds once (the plain version's order,
// native.py::gradient_field_transpose_plain, bit for bit).  Bound: bytes,
// 16 B in and 4 B out a voxel, as K10 (2.7 GB at 512^3, 0.80 ms).  The
// layouts are K10's swapped, so the design is K10's mirror on its grid
// (gradient_plan): a block of 256 threads owns an x-z tile of 32 x 32
// voxels and walks a run of y planes.  Each plane, with the tile's x and z
// halo (treach_lo .. treach_hi: j - 1 .. j + 1 and the faces' samples, up
// to 35 a side), enters a staging buffer as rows of float4 along x with
// cp.async (16 bytes a copy where d_field is 16-byte aligned), two planes
// in flight ahead of the one in hand.  A warp takes four x rows of the
// tile, lane = z, and a thread the same voxels in every plane: it reads the
// staging buffer down its columns (an odd pitch of 35 float4 keeps eight
// lanes' 16-byte reads in distinct banks), takes channel 0 at x - 1 and
// x + 1 from the row before and after (each widened to double once),
// channel 2 at z - 1 and z + 1 from the neighbouring lanes, and keeps in
// double, in shared memory slots that only it reads, channel 1 of the last
// two planes and the in-plane sum (x + z) + c3 of the last; as plane y + 1
// enters it finishes output plane y, written in rows of 32 floats along z,
// so the tile's transpose happens in the reads of the staging buffer and
// no barrier guards the slots.  The y faces' samples (planes 0 and H - 1,
// six output planes of H) are read from device memory.  The first design
// divided by 2h and h (IEEE double divisions, as K10) and made a second
// pass over the tile for the y part, a float ring of three planes read
// twice: 1.476 ms at 512^3 on an H100, 54% of the bound.

// K11, photon_bspline_prefilter.  Cubic B-spline coefficients of a
// (D, H, W, C) float32 field along axes 0, 1 and 2 in turn, the plain
// version's function and rounding (ops/march_dense.py::_prefilter_axis):
// pole z = sqrt(3) - 2, the causal start summed over the first `horizon`
// samples in order k = 0, 1, ..., the causal pass c_i = lam x_i + z c_{i-1},
// the anticausal start last (z c_{n-2} + c_{n-1}) and pass
// o_i = z (o_{i+1} - c_i), with the plain version's float32 constants (the
// wrapper passes them), so that K11 is the plain version bit for bit.  The
// first axis runs out of place and the other two in place, so a call needs
// the field and one copy.  Bound: bytes, one read of the field and one write
// of the coefficients (8.4 MB at 64^3 x 4, 2.5 us; 4.3 GB at 512^3 x 4,
// 1.28 ms).  The tiles below move the field once in and once out an axis,
// three times that (3.85 ms at 512^3 x 4); fewer passes would need axes 1
// and 2 run a D-plane at a time (4 MB a plane at 512^2 x 4, held in L2).
//
// A line (the two other spatial indices and the channel) is a recurrence of
// n dependent steps each way, so a thread runs a line; what the design has
// to get right is the memory.  prefilter_tile_kernel: a block owns a tile of
// whole lines in shared memory.  Its threads copy the tile in with
// cp.async (16 bytes a copy where the strides allow, all of a thread's
// copies in flight at once and none through registers), its first R x T
// threads (one warp) run both passes of a line each out of shared memory,
// and all copy the tile back: the field is read once and written once an
// axis.  In place is safe because a block writes nothing before its whole
// tile has arrived and the tiles are disjoint sets of lines.  An axis of
// stride s (the product of the later dimensions, C included) has lines
// (o, j): o the product of the earlier indices, j < s; sample i of line
// (o, j) lies at (o n + i) s + j.  Where s > 32 (axes 0 and 1) a tile is T
// consecutive j of one o, T = 32 (16 or 8 for longer lines): n rows of T
// contiguous floats, stored in shared memory as [i][t], so the T threads of
// one sample read T banks.  Where s <= 32 (axis 2, C floats a voxel) a tile
// is R consecutive o with all s of their j (T = s): R whole rows of n s
// contiguous floats, each row stored at a pitch that is T more than a
// multiple of 32 floats, so that line k = r T + t reads sample i from bank
// (k + i T) mod 32 and a warp's reads of a sample fall in distinct banks
// (an unpadded pitch of 2048 would put all eight rows of a 512 x 4 tile in
// one bank).  A pass runs whole chunks of eight steps with no test inside,
// the next chunk's samples loaded ahead, so that the dependent chain is the
// multiply and the add.  native.py plans the tiles from the shape
// (prefilter_plan): about 32 lines and at most 75 KB a tile, three tiles an
// SM (the kernel is held to 85 registers for that).  On an H100 at 512^3 x 4
// a tile spends about 4.5 us copying in, 10 us in its 1,037 steps a line
// and 3.4 us copying out (global-timer stamps): the passes, one warp's
// dependent chain, are the larger part, and with three tiles an SM the
// memory is idle while all three run them.  A line too long for a tile of 8
// lines in 227 KB (about n > 7,260 samples, or n C > 58,000 floats on axis
// 2) takes prefilter_axis_kernel, one thread a line straight from device
// memory (lines along D and H coalesced across a warp, along W a warp covers
// C channels of 32 / C rows; each line read twice and written twice, in
// chunks of eight samples loaded before any is written).
//
// K12, photon_bspline_prefilter_bwd.  K11's transpose, the axes in reverse
// order.  For one line with cotangent g: u_0 = g_0, u_{i+1} = g_{i+1} + z u_i
// and pbar_i = -z u_i (i <= n-2); the anticausal start sets
// pbar_{n-1} = last u_{n-1} and adds z pbar_{n-1} to pbar_{n-2}; then backwards
// xbar_i = lam pbar_i and pbar_{i-1} += z pbar_i (i = n-1 .. 1); finally
// xbar_k += z^k (lam pbar_0) for k < horizon.  The same tiles, routes and
// bound as K11 (prefilter_tile_bwd_kernel; prefilter_axis_bwd_kernel for the
// long lines): all three sweeps run in shared memory between the tile's one
// load and one store.  Neither K11 nor K12 uses atomics: two runs are equal.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include <cuda_runtime.h>

#include <type_traits>

namespace {

// the plain version's float32 constants for one axis (native.py,
// prefilter_constants); the same layout as native.py's _Pole
struct Pole {
  float zk[16];   // z^k rounded once to float32, k < horizon
  float lam;      // the gain (1 - z)(1 - 1/z)
  float z;        // the pole
  float last;     // z / (z^2 - 1), the anticausal start's factor
  int horizon;    // terms of the causal start (at most 16)
};

// one axis's route and tile (native.py, prefilter_plan; the same layout as
// native.py's _AxisPlan)
struct AxisPlan {
  int tiled;      // 1: the tile kernels; 0: one thread a line
  int cols;       // T: lines of one outer index a tile (all s where s <= 32)
  int rows;       // R: outer indices a tile
  int pitch;      // floats of shared memory a tile row holds
};

constexpr int kChunk = 8;

// the line of thread l: `stride` consecutive lines share their outer index
__device__ __forceinline__ long long line_base(long long l, long long n,
                                               long long stride) {
  return (l / stride) * n * stride + l % stride;
}

// K11 along one axis: in and out may be the same array
__global__ void prefilter_axis_kernel(const float* in, float* out,
                                      long long lines, long long n,
                                      long long stride, Pole p) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lines) return;
  const long long base = line_base(l, n, stride);
  const float* x = in + base;
  float* c = out + base;
  const float z = p.z, lam = p.lam;
  float acc = p.zk[0] * x[0];
  for (int k = 1; k < p.horizon; ++k) acc = acc + p.zk[k] * x[k * stride];
  float prev2 = 0.0f;            // c_{i-2}
  float prev = lam * acc;        // c_{i-1}
  c[0] = prev;
  float buf[kChunk];
  for (long long i0 = 1; i0 < n; i0 += kChunk) {
    const int m = (int)(n - i0 < kChunk ? n - i0 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = x[(i0 + j) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        const float ci = lam * buf[j] + z * prev;
        c[(i0 + j) * stride] = ci;
        prev2 = prev;
        prev = ci;
      }
  }
  // n >= 2: prev = c_{n-1}, prev2 = c_{n-2}
  float o = p.last * (z * prev2 + prev);
  c[(n - 1) * stride] = o;
  for (long long i1 = n - 2; i1 >= 0; i1 -= kChunk) {
    const int m = (int)(i1 + 1 < kChunk ? i1 + 1 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = c[(i1 - j) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        o = z * (o - buf[j]);
        c[(i1 - j) * stride] = o;
      }
  }
}

// K12 along one axis: g and xbar may be the same array
__global__ void prefilter_axis_bwd_kernel(const float* g, float* xbar,
                                          long long lines, long long n,
                                          long long stride, Pole p) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lines) return;
  const long long base = line_base(l, n, stride);
  const float* gl = g + base;
  float* q = xbar + base;        // holds pbar, then xbar
  const float z = p.z, lam = p.lam;
  float buf[kChunk];
  // the anticausal pass's transpose, forwards: q_i = pbar_i = -z u_i
  float u = gl[0];
  for (long long i0 = 0; i0 < n - 1; i0 += kChunk) {
    const int m = (int)(n - 1 - i0 < kChunk ? n - 1 - i0 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = gl[(i0 + j + 1) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        q[(i0 + j) * stride] = -(z * u);
        u = buf[j] + z * u;
      }
  }
  // the anticausal start's transpose (n >= 2)
  float P = p.last * u;          // pbar_{n-1}
  q[(n - 2) * stride] = q[(n - 2) * stride] + z * P;
  // the causal pass's transpose, backwards
  for (long long i1 = n - 1; i1 >= 1; i1 -= kChunk) {
    const int m = (int)(i1 < kChunk ? i1 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = q[(i1 - j - 1) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        q[(i1 - j) * stride] = lam * P;
        P = buf[j] + z * P;
      }
  }
  // the causal start's transpose: P = pbar_0
  const float t = lam * P;
  q[0] = p.zk[0] * t;
  for (int k = 1; k < p.horizon; ++k)
    q[k * stride] = q[k * stride] + p.zk[k] * t;
}

// ---------------------------------------------------------------------------
// the tile kernels
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kTileBlocks = 3;          // blocks an SM (registers <= 85)
constexpr int kCopyBatch = 4;           // stores a thread keeps in flight

// a tile's shape in the field (prefilter_plan's, checked by launch_tiles)
struct TileGeom {
  long long n, s, outer;  // samples a line, stride, outer indices
  long long tiles_j;      // tiles across j (1 where T = s)
  int cols, rows, pitch;  // T, R, floats a tile row holds in shared memory
  int shift;              // log2 T where T < s (T a power of two), else -1
};

// Unit u of tile row r (a float4 when kVec, else a float): its offset from
// the tile's first sample in the field and in shared memory.  False where it
// lies past the axis's last line (j >= s in the last tile across j).
template <bool kVec>
__device__ __forceinline__ bool tile_unit(const TileGeom& g, long long j0,
                                          int r, int u, long long& goff,
                                          int& soff) {
  const int e = kVec ? 4 * u : u;        // element i T + t of the row
  soff = r * g.pitch + e;
  goff = (long long)r * g.n * g.s;
  if (g.shift < 0) {                     // T = s: the row is contiguous
    goff += e;
    return true;
  }
  const int t = e & (g.cols - 1);
  goff += (long long)(e >> g.shift) * g.s + t;
  return j0 + t < g.s;
}

// 16 or 4 bytes from device memory into shared memory without passing
// through registers (cp.async): a thread starts all of its copies at once
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// the tile from device memory (`src`, from `base`) into shared memory
template <bool kVec>
__device__ __forceinline__ void tile_load(const TileGeom& g, const float* src,
                                          float* sm, long long base,
                                          long long j0, int rows_here) {
  const int per_row = (int)(g.n * g.cols) / (kVec ? 4 : 1);
  const int units = rows_here * per_row;
  for (int f = threadIdx.x; f < units; f += kTileThreads) {
    const int r = f / per_row;
    long long goff;
    int soff;
    if (tile_unit<kVec>(g, j0, r, f - r * per_row, goff, soff))
      copy_async(sm + soff, src + base + goff, kVec);
  }
  copy_async_wait();
}

// the tile from shared memory back to device memory (`dst`, from `base`),
// kCopyBatch units a thread in flight
template <bool kVec>
__device__ __forceinline__ void tile_store(const TileGeom& g, float* dst,
                                           const float* sm, long long base,
                                           long long j0, int rows_here) {
  using Unit = typename std::conditional<kVec, float4, float>::type;
  const int per_row = (int)(g.n * g.cols) / (kVec ? 4 : 1);
  const int units = rows_here * per_row;
  for (int f0 = threadIdx.x; f0 < units; f0 += kCopyBatch * kTileThreads) {
    Unit v[kCopyBatch];
    long long goff[kCopyBatch];
    bool ok[kCopyBatch];
#pragma unroll
    for (int b = 0; b < kCopyBatch; ++b) {
      const int f = f0 + b * kTileThreads;
      ok[b] = false;
      if (f < units) {
        const int r = f / per_row;
        int soff;
        ok[b] = tile_unit<kVec>(g, j0, r, f - r * per_row, goff[b], soff);
        if (ok[b]) v[b] = *reinterpret_cast<const Unit*>(sm + soff);
      }
    }
#pragma unroll
    for (int b = 0; b < kCopyBatch; ++b)
      if (ok[b]) *reinterpret_cast<Unit*>(dst + base + goff[b]) = v[b];
  }
}

// The passes over a line in shared memory (samples x[i st]), in place.
// Each runs whole chunks of kChunk steps with no test inside a chunk, the
// next chunk's samples loaded before the current chunk's steps, then the
// last whole chunk, then the remaining steps one at a time: with a test in
// every step a step took some 45 cycles.  kSt > 0 is the stride as a
// constant (32 and 4, the bench's tiles), so that a step's addresses are
// immediate offsets: with the stride in a register a step took ten
// instructions, four of them address arithmetic, and one warp runs them
// one at a time (4 to 6.6 a step with the constant).

// the causal start's sum, in order k = 0, 1, ...: sum_k zk[k] x[k st]
template <int kSt>
__device__ __forceinline__ float causal_start(const float* x, int st_,
                                              const Pole& p) {
  const int st = kSt > 0 ? kSt : st_;
  float acc = p.zk[0] * x[0];
#pragma unroll
  for (int k = 1; k < 16; ++k)
    if (k < p.horizon) acc = acc + p.zk[k] * x[k * st];
  return acc;
}

// K11 along one line
template <int kSt>
__device__ __forceinline__ void filter_line(float* x, int st_, int n,
                                            const Pole& p) {
  const int st = kSt > 0 ? kSt : st_;
  const float z = p.z, lam = p.lam;
  float prev2 = 0.0f;                               // c_{i-2}
  float prev = lam * causal_start<kSt>(x, st, p);   // c_{i-1}
  x[0] = prev;
  float cur[kChunk], nxt[kChunk];
  int i = 1;
  if (i + kChunk <= n) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = x[(i + j) * st];
    for (; i + 2 * kChunk <= n; i += kChunk) {
      float* xi = x + i * st;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) nxt[j] = xi[(kChunk + j) * st];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float ci = lam * cur[j] + z * prev;
        xi[j * st] = ci;
        prev2 = prev;
        prev = ci;
        cur[j] = nxt[j];
      }
    }
    float* xi = x + i * st;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float ci = lam * cur[j] + z * prev;
      xi[j * st] = ci;
      prev2 = prev;
      prev = ci;
    }
    i += kChunk;
  }
  for (; i < n; ++i) {
    const float ci = lam * x[i * st] + z * prev;
    x[i * st] = ci;
    prev2 = prev;
    prev = ci;
  }
  // n >= 2: prev = c_{n-1}, prev2 = c_{n-2}
  float o = p.last * (z * prev2 + prev);
  x[(n - 1) * st] = o;
  i = n - 2;
  if (i - kChunk + 1 >= 0) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = x[(i - j) * st];
    for (; i - 2 * kChunk + 1 >= 0; i -= kChunk) {
      float* xi = x + i * st;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) nxt[j] = xi[-(kChunk + j) * st];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        o = z * (o - cur[j]);
        xi[-j * st] = o;
        cur[j] = nxt[j];
      }
    }
    float* xi = x + i * st;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      o = z * (o - cur[j]);
      xi[-j * st] = o;
    }
    i -= kChunk;
  }
  for (; i >= 0; --i) {
    o = z * (o - x[i * st]);
    x[i * st] = o;
  }
}

// K12 along one line: the cotangent g in, xbar out (the slots hold g, then
// pbar, then xbar)
template <int kSt>
__device__ __forceinline__ void transpose_line(float* x, int st_, int n,
                                               const Pole& p) {
  const int st = kSt > 0 ? kSt : st_;
  const float z = p.z, lam = p.lam;
  float cur[kChunk], nxt[kChunk];
  // the anticausal pass's transpose, forwards: x_i = pbar_i = -z u_i
  float u = x[0];
  int i = 0;
  if (i + kChunk <= n - 1) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = x[(i + 1 + j) * st];
    for (; i + 2 * kChunk <= n - 1; i += kChunk) {
      float* xi = x + i * st;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) nxt[j] = xi[(1 + kChunk + j) * st];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        xi[j * st] = -(z * u);
        u = cur[j] + z * u;
        cur[j] = nxt[j];
      }
    }
    float* xi = x + i * st;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      xi[j * st] = -(z * u);
      u = cur[j] + z * u;
    }
    i += kChunk;
  }
  for (; i < n - 1; ++i) {
    x[i * st] = -(z * u);
    u = x[(i + 1) * st] + z * u;
  }
  // the anticausal start's transpose (n >= 2)
  float P = p.last * u;          // pbar_{n-1}
  x[(n - 2) * st] = x[(n - 2) * st] + z * P;
  // the causal pass's transpose, backwards
  i = n - 1;
  if (i - kChunk + 1 >= 1) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) cur[j] = x[(i - 1 - j) * st];
    for (; i - 2 * kChunk >= 0; i -= kChunk) {
      float* xi = x + i * st;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) nxt[j] = xi[-(1 + kChunk + j) * st];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        xi[-j * st] = lam * P;
        P = cur[j] + z * P;
        cur[j] = nxt[j];
      }
    }
    float* xi = x + i * st;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      xi[-j * st] = lam * P;
      P = cur[j] + z * P;
    }
    i -= kChunk;
  }
  for (; i >= 1; --i) {
    x[i * st] = lam * P;
    P = x[(i - 1) * st] + z * P;
  }
  // the causal start's transpose: P = pbar_0
  const float t = lam * P;
  x[0] = p.zk[0] * t;
#pragma unroll
  for (int k = 1; k < 16; ++k)
    if (k < p.horizon) x[k * st] = x[k * st] + p.zk[k] * t;
}

// the passes over the line at x, the stride a constant where it is 32 or 4
template <bool kBackward>
__device__ __forceinline__ void run_line(float* x, int st, int n,
                                         const Pole& p) {
  if (st == 32)
    kBackward ? transpose_line<32>(x, st, n, p) : filter_line<32>(x, st, n, p);
  else if (st == 4)
    kBackward ? transpose_line<4>(x, st, n, p) : filter_line<4>(x, st, n, p);
  else
    kBackward ? transpose_line<0>(x, st, n, p) : filter_line<0>(x, st, n, p);
}

// no stamps: what the tile kernels pass prefilter_tile (a probe of where a
// tile's time goes passes a functor that records the time at each stamp)
struct NoStamps {
  __device__ __forceinline__ void operator()(int) const {}
};

// one tile: copy in, a line a thread, copy out; stamp(k) is called by every
// thread at the tile's start (0), after its copy in (1), after its passes
// (2) and after its copy out (3)
template <bool kBackward, bool kVec, class Stamp>
__device__ __forceinline__ void prefilter_tile(const float* in, float* out,
                                               const TileGeom& g,
                                               const Pole& p, float* sm,
                                               Stamp stamp) {
  stamp(0);
  const long long jt = blockIdx.x % g.tiles_j;
  const long long o0 = (blockIdx.x / g.tiles_j) * g.rows;
  const long long j0 = jt * g.cols;
  const int rows_here =
      (int)(g.outer - o0 < g.rows ? g.outer - o0 : (long long)g.rows);
  const long long base = o0 * g.n * g.s + j0;
  tile_load<kVec>(g, in, sm, base, j0, rows_here);
  __syncthreads();
  stamp(1);
  const int k = threadIdx.x;
  if (k < g.rows * g.cols) {
    const int r = k / g.cols, t = k - r * g.cols;
    if (r < rows_here && (g.shift < 0 || j0 + t < g.s)) {
      run_line<kBackward>(sm + r * g.pitch + t, g.cols, (int)g.n, p);
    }
  }
  __syncthreads();
  stamp(2);
  tile_store<kVec>(g, out, sm, base, j0, rows_here);
  stamp(3);
}

// prefilter_tile with 16-byte copies where `vec`, else 4-byte ones
template <bool kBackward, class Stamp>
__device__ __forceinline__ void run_tile(const float* in, float* out,
                                         const TileGeom& g, const Pole& p,
                                         int vec, float* sm, Stamp stamp) {
  if (vec)
    prefilter_tile<kBackward, true>(in, out, g, p, sm, stamp);
  else
    prefilter_tile<kBackward, false>(in, out, g, p, sm, stamp);
}

// K11 along one axis, a tile a block: in and out may be the same array
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    prefilter_tile_kernel(const float* in, float* out, TileGeom g, Pole p,
                          int vec) {
  extern __shared__ float4 tile_sm[];
  run_tile<false>(in, out, g, p, vec, reinterpret_cast<float*>(tile_sm),
                  NoStamps());
}

// K12 along one axis, a tile a block: g and xbar may be the same array
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    prefilter_tile_bwd_kernel(const float* in, float* out, TileGeom g, Pole p,
                              int vec) {
  extern __shared__ float4 tile_sm[];
  run_tile<true>(in, out, g, p, vec, reinterpret_cast<float*>(tile_sm),
                 NoStamps());
}

// ---------------------------------------------------------------------------
// K10: the gradient precompute, an x-z tile a block walking along y
// ---------------------------------------------------------------------------

__device__ __forceinline__ double one_sided_lo(double s0, double s1, double s2,
                                               double h) {
  return (-1.5 * s0 + 2.0 * s1 - 0.5 * s2) / h;
}

__device__ __forceinline__ double one_sided_hi(double e1, double e2, double e3,
                                               double h) {
  return (1.5 * e1 - 2.0 * e2 + 0.5 * e3) / h;
}

// the derivative along one axis at index i of n, the samples at i - 1,
// i + 1 and the faces' neighbours read through `at(j)`
template <typename At>
__device__ __forceinline__ double axis_derivative(At at, int i, int n,
                                                  double h) {
  if (i == 0) return one_sided_lo(at(0), at(1), at(2), h);
  if (i == n - 1) return one_sided_hi(at(n - 1), at(n - 2), at(n - 3), h);
  return (at(i + 1) - at(i - 1)) / (2.0 * h);
}

// kGradTile, kGradSpan and kGradStagePitch are native.py's GRADIENT_TILE,
// GRADIENT_SPAN and GRADIENT_STAGE_PITCH, which its plan and tests use
constexpr int kGradTile = 32;                   // x and z a tile
constexpr int kGradSpan = kGradTile + 2;        // with the stencils' halo
constexpr int kGradPitch = kGradSpan + 1;       // doubles a ring row: odd
constexpr int kGradStagePitch = kGradTile + 8;  // floats a staging row
constexpr int kGradThreads = 256;
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kGradBlocks = 4;                  // blocks an SM (<= 64 regs)

// the first and the last sample that the stencils of indices a .. b - 1
// along an axis of n >= 3 read (native.gradient_reach)
__device__ __forceinline__ int reach_lo(int a, int n) {
  const int lo = a - 1 < n - 3 ? a - 1 : n - 3;
  return lo > 0 ? lo : 0;
}

__device__ __forceinline__ int reach_hi(int b, int n) {
  const int hi = b > 2 ? b : 2;
  return hi < n - 1 ? hi : n - 1;
}

// the grid of K10 (native.py, gradient_plan) and the input's strides
struct GradGeom {
  int W, H, D;            // the input's (W, H, D), each at most 2^30
  int tiles_x, tiles_z;   // kGradTile-voxel tiles along x and z
  int y_run;              // output planes a block computes
  int vec;                // 16-byte copies: D % 4 == 0, the input aligned
  double dx, dy, dz;
};

// f(r, c) for the elements t, t + kGradThreads, ... (t the thread) of an
// nr x nc grid (nc <= kGradThreads) in row order, with no division in the
// loop
template <class F>
__device__ __forceinline__ void grid_walk(int nr, int nc, F f) {
  const int dr = kGradThreads / nc, dc = kGradThreads - dr * nc;
  int r = threadIdx.x / nc, c = threadIdx.x - r * nc;
  while (r < nr) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= nc) {
      c -= nc;
      ++r;
    }
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Block b: z tile b % tiles_z, x tile (b / tiles_z) % tiles_x, y run
// b / (tiles_z tiles_x).  Planes reach_lo(y0) .. reach_hi(y1) enter in
// order, plane p through staging buffer (p - plo) % 2 into ring slot p % 3.
__global__ void __launch_bounds__(kGradThreads, kGradBlocks)
    gradient_tile_kernel(const float* __restrict__ data,
                         float4* __restrict__ out, GradGeom g) {
  __shared__ __align__(16) float stage[2][kGradSpan * kGradStagePitch];
  __shared__ double ring[3][kGradSpan * kGradPitch];
  const int tz = (int)(blockIdx.x % (unsigned)g.tiles_z);
  const int rest = (int)(blockIdx.x / (unsigned)g.tiles_z);
  const int tx = rest % g.tiles_x, ty = rest / g.tiles_x;
  const int x0 = tx * kGradTile, x1 = min(g.W, x0 + kGradTile);
  const int z0 = tz * kGradTile, z1 = min(g.D, z0 + kGradTile);
  const int y0 = ty * g.y_run, y1 = min(g.H, y0 + g.y_run);
  const int xlo = reach_lo(x0, g.W), nx = reach_hi(x1, g.W) - xlo + 1;
  const int zlo = reach_lo(z0, g.D), nz = reach_hi(z1, g.D) - zlo + 1;
  const int plo = reach_lo(y0, g.H), phi = reach_hi(y1, g.H);
  // a staging row: the z of one x from zbase (zlo, or the 16-byte word that
  // holds it), `per_row` copies of `w` floats
  const int zbase = g.vec ? zlo & ~3 : zlo;
  const int w = g.vec ? 4 : 1;
  const int per_row = g.vec ? (((zlo + nz + 3) & ~3) - zbase) / 4 : nz;
  const int zoff = zlo - zbase;
  const long long row = (long long)g.H * g.D;   // floats from x to x + 1
  const float* src0 = data + xlo * row + zbase;

  // plane p of the tile and its halo into the staging buffer st, as one
  // group of copies
  auto issue = [&](int p, float* st) {
    const float* src = src0 + (long long)p * g.D;
    grid_walk(nx, per_row, [&](int r, int c) {
      copy_async(st + r * kGradStagePitch + c * w, src + r * row + c * w,
                 g.vec);
    });
    copy_commit();
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = x0 + lane, xr = x - xlo;
  // this warp's z rows of the tile: z0 + warp + kGradWarps k, k < nk
  const int nk = z1 - z0 > warp
                     ? (z1 - z0 - warp + kGradWarps - 1) / kGradWarps
                     : 0;
  const long long out_step = (long long)kGradWarps * g.H * g.W;
  issue(plo, stage[0]);
  issue(plo + 1, stage[1]);      // phi >= plo + 2
  int y = y0;
  for (int p = plo; p <= phi; ++p) {
    float* st = stage[(p - plo) & 1];
    double* pl = ring[p % 3];
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();             // plane p is in st; ring slot p % 3 is free
    grid_walk(nx, nz, [&](int r, int c) {
      pl[r * kGradPitch + c] = (double)st[r * kGradStagePitch + zoff + c];
    });
    __syncthreads();             // plane p is in the ring; st is free
    if (p + 2 <= phi)
      issue(p + 2, st);
    else
      copy_commit();
    // the output planes whose stencils reach no further than p: they read
    // planes ylo .. ylo + 2, all in the ring
    for (; y < y1 && reach_hi(y + 1, g.H) <= p; ++y) {
      if (x >= x1) continue;
      const int ylo = reach_lo(y, g.H);
      const double* q0 = ring[ylo % 3];
      const double* q1 = ring[(ylo + 1) % 3];
      const double* q2 = ring[(ylo + 2) % 3];
      const double* cy = ring[y % 3];
      float4* dst = out + ((long long)(z0 + warp) * g.H + y) * g.W + x;
#pragma unroll 1
      for (int k = 0; k < nk; ++k) {
        const int z = z0 + warp + k * kGradWarps;
        const int o = xr * kGradPitch + (z - zlo);
        const double gx = axis_derivative(
            [&](int j) { return cy[o + (j - x) * kGradPitch]; }, x, g.W,
            g.dx);
        const double gy = axis_derivative(
            [&](int j) {
              const int d = j - ylo;
              return (d == 0 ? q0 : d == 1 ? q1 : q2)[o];
            },
            y, g.H, g.dy);
        const double gz = axis_derivative(
            [&](int j) { return cy[o + (j - z)]; }, z, g.D, g.dz);
        __stcs(dst, make_float4((float)gx, (float)gy, (float)gz,
                                (float)cy[o]));
        dst += out_step;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K13: K10's transpose, an x-z tile a block walking along y
// ---------------------------------------------------------------------------

// the first and the last sample that the transposed stencils of indices
// a .. b - 1 along an axis of n >= 3 read (native.gradient_transpose_reach):
// j - 1 and j + 1, and the faces' samples 0 (j <= 2) and n - 1 (j >= n - 3)
__device__ __forceinline__ int treach_lo(int a) { return a <= 2 ? 0 : a - 1; }

__device__ __forceinline__ int treach_hi(int b, int n) {
  return b >= n - 2 ? n - 1 : b;
}

// the one-sided rows' weights on sample j of 0, 1, 2 (first row) and on
// sample n - 3 + k, k = j - (n - 3), of n - 3 .. n - 1 (last row)
__device__ __forceinline__ double face_lo(int j) {
  return j == 0 ? -1.5 : j == 1 ? 2.0 : -0.5;
}

__device__ __forceinline__ double face_hi(int k) {
  return k == 0 ? 0.5 : k == 1 ? -2.0 : 1.5;
}

// S^T g at sample j of n along one axis, in the plain version's order
// (native.py, grad_axis_transpose): the central rows j - 1 and j + 1 (gm,
// gp: their samples where the row is central, else 0) times 1 / 2h, then
// the first row where j <= 2 and the last where j >= n - 3, whose samples
// g[0] and g[n - 1] `first()` and `last()` read, times 1 / h; inv2h and
// invh are those reciprocals, each formed once in double
template <class First, class Last>
__device__ __forceinline__ double transpose_at(double gm, double gp, int j,
                                               int n, double inv2h,
                                               double invh, First first,
                                               Last last) {
  double t = (gm - gp) * inv2h;
  if (j <= 2) t = t + (face_lo(j) * first()) * invh;
  if (j >= n - 3) t = t + (face_hi(j - (n - 3)) * last()) * invh;
  return t;
}

// kTrSpan is native.py's GRADIENT_TRANSPOSE_SPAN
constexpr int kTrSpan = kGradTile + 3;          // x or z a tile reads
constexpr int kTrPitch = kTrSpan;               // float4 a staging row: odd
constexpr int kTrThreads = kGradThreads;
constexpr int kTrRows = kGradTile / kGradWarps; // x rows a warp
constexpr int kTrBlocks = 3;                    // blocks an SM (<= 85 regs)
constexpr int kTrStage = kTrSpan * kTrPitch;    // float4 a staging plane
constexpr int kTrTile = kGradTile * kGradTile;  // voxels a tile
// two staging planes, and two planes each (double) of channel 1 and of the
// in-plane sums: 71,968 bytes, three blocks in an SM's 228 KB
constexpr int kTrSmemBytes = 2 * kTrStage * 16 + 4 * kTrTile * 8;

// the grid of K13 (K10's, native.gradient_plan) and what a voxel needs
struct TransposeGeom {
  int W, H, D;            // rho's (W, H, D), each at most 2^30
  int tiles_x, tiles_z;   // kGradTile-voxel tiles along x and z
  int y_run;              // output planes a block computes
  int vec;                // 16-byte copies: d_field 16-byte aligned
  double dx, dy, dz, gd;
};

// Block b: z tile b % tiles_z, x tile (b / tiles_z) % tiles_x, y run
// b / (tiles_z tiles_x), as K10.  Planes treach_lo(y0) .. treach_hi(y1)
// of d_field enter in order, plane p through staging buffer (p - plo) % 2:
// the tile's x-z window of float4 with its halo (treach_lo .. treach_hi
// of each axis).  A thread owns the voxels (x, z) of its warp's kTrRows x
// rows and its lane's z in every plane, and keeps, in shared memory slots
// that no other thread reads, channel 1 of the last two planes (c1, slot
// p % 2) and the in-plane sum (x + z) + c3 of the last output plane (part,
// slot p % 2), in double.  As plane p enters, the thread forms plane p's
// in-plane sum and finishes output plane p - 1, whose central y rows
// p - 2 and p are c1's and the plane in hand's (and p itself where p + 1
// is no central row); its z rows are written along z, so the tile's
// transpose happens in the reads of the staging buffer.  The one-sided
// rows' samples along y (planes 0 and H - 1) are read from device memory
// where y <= 2 or y >= H - 3.
__global__ void __launch_bounds__(kTrThreads, kTrBlocks)
    gradient_transpose_kernel(const float* __restrict__ dfield,
                              float* __restrict__ drho, TransposeGeom g) {
  extern __shared__ float4 tr_sm[];
  float4* stage = tr_sm;
  double* c1 = reinterpret_cast<double*>(tr_sm + 2 * kTrStage);
  double* part = c1 + 2 * kTrTile;
  const int tz = (int)(blockIdx.x % (unsigned)g.tiles_z);
  const int rest = (int)(blockIdx.x / (unsigned)g.tiles_z);
  const int tx = rest % g.tiles_x, ty = rest / g.tiles_x;
  const int x0 = tx * kGradTile, x1 = min(g.W, x0 + kGradTile);
  const int z0 = tz * kGradTile, z1 = min(g.D, z0 + kGradTile);
  const int y0 = ty * g.y_run, y1 = min(g.H, y0 + g.y_run);
  const int xlo = treach_lo(x0), nx = treach_hi(x1, g.W) - xlo + 1;
  const int zlo = treach_lo(z0), nz = treach_hi(z1, g.D) - zlo + 1;
  const int plo = treach_lo(y0), phi = treach_hi(y1, g.H);
  const long long zstep = 4LL * g.H * g.W;     // floats from z to z + 1
  const float* src0 = dfield + (long long)zlo * zstep + 4LL * xlo;
  const int per_row = g.vec ? nx : 4 * nx;      // copies a staging row
  const double inv2x = 1.0 / (2.0 * g.dx), invx = 1.0 / g.dx;
  const double inv2y = 1.0 / (2.0 * g.dy), invy = 1.0 / g.dy;
  const double inv2z = 1.0 / (2.0 * g.dz), invz = 1.0 / g.dz;

  // plane p of the tile's window into the staging buffer st, as one group
  // of copies
  auto issue = [&](int p, float4* st) {
    const float* src = src0 + 4LL * p * g.W;
    float* dst = reinterpret_cast<float*>(st);
    const int w = g.vec ? 4 : 1;
    grid_walk(nz, per_row, [&](int r, int c) {
      copy_async(dst + 4 * r * kTrPitch + c * w, src + r * zstep + c * w,
                 g.vec);
    });
    copy_commit();
  };

  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int z = z0 + lane, zr = z - zlo;
  const bool zin = z < z1;
  const int xa = x0 + warp * kTrRows;
  const int nrows = max(0, min(kTrRows, x1 - xa));
  // channel 1 of (z, x) in plane q, read from device memory
  auto face = [&](int x, int q) {
    return (double)__ldg(dfield + (long long)z * zstep +
                         4LL * ((long long)q * g.W + x) + 1);
  };
  issue(plo, stage);
  issue(plo + 1, stage + kTrStage);   // phi >= plo + 1
  for (int p = plo; p <= phi; ++p) {
    float4* st = stage + ((p - plo) & 1) * kTrStage;
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();             // plane p is in st
    const bool out_p = p >= y0 && p < y1;
    // output plane p - 1 is finished now where p is its central row y + 1;
    // output plane p too where p + 1 is no central row (p >= H - 2)
    const bool fin_prev = p - 1 >= y0 && p - 1 < y1 && p <= g.H - 2;
    const bool fin_p = out_p && p >= g.H - 2;
    if (nrows > 0) {
      // this lane's z row of the window, walked along x: g0m holds
      // channel 0 at x - 1, cur the voxel x, nxt the voxel x + 1
      const float4* row = st + zr * kTrPitch;
      int xw = xa - xlo;
      double g0m = xa - 1 >= xlo ? (double)row[xw - 1].x : 0.0;
      float4 cur = row[xw];
      double g0c = (double)cur.x;
#pragma unroll 1
      for (int k = 0; k < nrows; ++k, ++xw) {
        const int x = xa + k, i = (x - x0) * kGradTile + lane;
        const float4 nxt = row[xw + 1];
        const double g0p = (double)nxt.x;
        const double g1 = (double)cur.y;
        double s = 0.0;
        if (out_p) {
          const double tx_ = transpose_at(
              x >= 2 ? g0m : 0.0, x <= g.W - 3 ? g0p : 0.0, x, g.W, inv2x,
              invx, [&] { return (double)row[-xlo].x; },
              [&] { return (double)row[g.W - 1 - xlo].x; });
          // channel 2 at z - 1 and z + 1 from the neighbouring lanes, the
          // tile's first and last lanes from the window's halo rows
          float g2m = __shfl_up_sync(full, cur.z, 1);
          float g2p = __shfl_down_sync(full, cur.z, 1);
          if (lane == 0 && z >= 2) g2m = st[(zr - 1) * kTrPitch + xw].z;
          if (lane == 31 && z <= g.D - 3)
            g2p = st[(zr + 1) * kTrPitch + xw].z;
          const double tz_ = transpose_at(
              z >= 2 ? (double)g2m : 0.0, z <= g.D - 3 ? (double)g2p : 0.0,
              z, g.D, inv2z, invz,
              [&] { return (double)st[(0 - zlo) * kTrPitch + xw].z; },
              [&] { return (double)st[(g.D - 1 - zlo) * kTrPitch + xw].z; });
          s = (tx_ + tz_) + (double)cur.w;
        }
        if (zin && fin_prev) {
          const int y = p - 1;
          const double ty_ = transpose_at(
              y >= 2 ? c1[(p & 1) * kTrTile + i] : 0.0, g1, y, g.H, inv2y,
              invy, [&] { return face(x, 0); },
              [&] { return face(x, g.H - 1); });
          __stcs(drho + ((long long)x * g.H + y) * g.D + z,
                 (float)(g.gd * (part[((p - 1) & 1) * kTrTile + i] + ty_)));
        }
        if (zin && fin_p) {
          const double ty_ = transpose_at(
              p >= 2 ? c1[((p - 1) & 1) * kTrTile + i] : 0.0, 0.0, p, g.H,
              inv2y, invy, [&] { return face(x, 0); },
              [&] { return face(x, g.H - 1); });
          __stcs(drho + ((long long)x * g.H + p) * g.D + z,
                 (float)(g.gd * (s + ty_)));
        }
        c1[(p & 1) * kTrTile + i] = g1;
        part[(p & 1) * kTrTile + i] = s;
        g0m = g0c;
        g0c = g0p;
        cur = nxt;
      }
    }
    __syncthreads();             // st is free
    if (p + 2 <= phi)
      issue(p + 2, st);
    else
      copy_commit();
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;            // one thread a line
constexpr int kMaxTileBytes = 232448;    // shared memory a block can take

bool aligned16(const void* ptr) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
}

// axis `axis` of a (D, H, W, C) field: n samples a line, stride s (the
// product of the later dimensions, C included), `outer` outer indices
void axis_shape(const long long dims[4], int axis, long long& n,
                long long& s, long long& outer) {
  n = dims[axis];
  s = dims[3];
  for (int a = axis + 1; a < 3; ++a) s *= dims[a];
  outer = 1;
  for (int a = 0; a < axis; ++a) outer *= dims[a];
}

// the tiles `plan` gives an axis of n samples, stride s and `outer` outer
// indices: their geometry and number; a plan that would overrun shared
// memory or the block is refused
int make_geom(long long n, long long s, long long outer, const AxisPlan& plan,
              TileGeom& g, long long& tiles) {
  const long long T = plan.cols, R = plan.rows;
  const bool contig = T == s;
  const bool pow2 = T > 0 && (T & (T - 1)) == 0;
  if (T < 1 || R < 1 || R * T > kTileThreads ||
      (!contig && (!pow2 || T > s)) || plan.pitch < n * T ||
      R * plan.pitch * 4 > kMaxTileBytes)
    return (int)cudaErrorInvalidValue;
  g.n = n;
  g.s = s;
  g.outer = outer;
  g.cols = (int)T;
  g.rows = (int)R;
  g.pitch = plan.pitch;
  g.tiles_j = contig ? 1 : (s + T - 1) / T;
  g.shift = -1;
  if (!contig)
    for (g.shift = 0; (1LL << g.shift) < T; ++g.shift) {
    }
  tiles = g.tiles_j * ((outer + R - 1) / R);
  return tiles > 0x7fffffffLL ? (int)cudaErrorInvalidValue : 0;
}

// `kernel` (prefilter_tile_kernel, prefilter_tile_bwd_kernel, or a kernel
// of the same arguments and `extra` after them) along one axis as `plan`
// tiles it
template <class Kernel, class... Extra>
int launch_tile_kernel(Kernel kernel, const float* in, float* out,
                       long long n, long long s, long long outer,
                       const AxisPlan& plan, const Pole& p,
                       cudaStream_t stream, Extra... extra) {
  TileGeom g;
  long long tiles;
  const int code = make_geom(n, s, outer, plan, g, tiles);
  if (code != 0) return code;
  const int vec = g.cols % 4 == 0 && s % 4 == 0 && g.pitch % 4 == 0 &&
                  aligned16(in) && aligned16(out);
  const int bytes = g.rows * g.pitch * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)tiles, kTileThreads, (size_t)bytes, stream>>>(
      in, out, g, p, vec, extra...);
  return (int)cudaGetLastError();
}

int launch_axis(bool backward, const float* in, float* out,
                const long long dims[4], int axis, const Pole& p,
                const AxisPlan& plan, cudaStream_t stream) {
  long long n, stride, outer;
  axis_shape(dims, axis, n, stride, outer);
  if (plan.tiled)
    return backward ? launch_tile_kernel(prefilter_tile_bwd_kernel, in, out,
                                         n, stride, outer, plan, p, stream)
                    : launch_tile_kernel(prefilter_tile_kernel, in, out, n,
                                         stride, outer, plan, p, stream);
  const long long lines = outer * stride;
  const long long blocks = (lines + kThreads - 1) / kThreads;
  if (backward)
    prefilter_axis_bwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, lines, n, stride, p);
  else
    prefilter_axis_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, lines, n, stride, p);
  return (int)cudaGetLastError();
}

int prefilter(bool backward, const float* in, float* out, long long D,
              long long H, long long W, long long C, const Pole* poles,
              const AxisPlan* plans, void* stream) {
  const long long dims[4] = {D, H, W, C};
  for (int a = 0; a < 3; ++a)
    if (dims[a] < 2 || poles[a].horizon < 1 || poles[a].horizon > 16 ||
        poles[a].horizon > dims[a])
      return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  // the forward takes axes 0, 1, 2 and the transpose 2, 1, 0; the first
  // launch reads `in`, the other two work in place on `out`
  for (int s = 0; s < 3; ++s) {
    const int axis = backward ? 2 - s : s;
    const int code = launch_axis(backward, s == 0 ? in : out, out, dims, axis,
                                 poles[axis], plans[axis],
                                 (cudaStream_t)stream);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// n_minus_1: (W, H, D) float32; out: (D, H, W, 4) float32; y_run: the
// output planes a block computes (native.py, gradient_plan).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int photon_gradient_field(const float* n_minus_1, float* out,
                                     long long W, long long H, long long D,
                                     double dx, double dy, double dz,
                                     long long y_run, void* stream) {
  const long long most = 1LL << 30;
  if (W < 3 || H < 3 || D < 3 || W > most || H > most || D > most ||
      y_run < 1 || y_run > H)
    return (int)cudaErrorInvalidValue;
  GradGeom g;
  g.W = (int)W;
  g.H = (int)H;
  g.D = (int)D;
  g.tiles_x = (int)((W + kGradTile - 1) / kGradTile);
  g.tiles_z = (int)((D + kGradTile - 1) / kGradTile);
  g.y_run = (int)y_run;
  g.vec = D % 4 == 0 && aligned16(n_minus_1);
  g.dx = dx;
  g.dy = dy;
  g.dz = dz;
  const long long blocks =
      (long long)g.tiles_x * g.tiles_z * ((H + y_run - 1) / y_run);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gradient_tile_kernel<<<(unsigned)blocks, kGradThreads, 0,
                         (cudaStream_t)stream>>>(
      n_minus_1, reinterpret_cast<float4*>(out), g);
  return (int)cudaGetLastError();
}

// d_field: (D, H, W, 4) float32; d_rho: (W, H, D) float32, distinct
// arrays; gd: the Gladstone-Dale constant; y_run: the output planes a block
// computes (native.py, gradient_plan).  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int photon_gradient_field_transpose(
    const float* d_field, float* d_rho, long long W, long long H, long long D,
    double dx, double dy, double dz, double gd, long long y_run,
    void* stream) {
  const long long most = 1LL << 30;
  if (W < 3 || H < 3 || D < 3 || W > most || H > most || D > most ||
      y_run < 1 || y_run > H)
    return (int)cudaErrorInvalidValue;
  TransposeGeom g;
  g.W = (int)W;
  g.H = (int)H;
  g.D = (int)D;
  g.tiles_x = (int)((W + kGradTile - 1) / kGradTile);
  g.tiles_z = (int)((D + kGradTile - 1) / kGradTile);
  g.y_run = (int)y_run;
  g.vec = aligned16(d_field);
  g.dx = dx;
  g.dy = dy;
  g.dz = dz;
  g.gd = gd;
  const long long blocks =
      (long long)g.tiles_x * g.tiles_z * ((H + y_run - 1) / y_run);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)gradient_transpose_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTrSmemBytes);
  if (e != cudaSuccess) return (int)e;
  gradient_transpose_kernel<<<(unsigned)blocks, kTrThreads, kTrSmemBytes,
                              (cudaStream_t)stream>>>(d_field, d_rho, g);
  return (int)cudaGetLastError();
}

// field, out: (D, H, W, C) float32, distinct arrays; poles and plans: three
// Pole and three AxisPlan records in host memory, one an axis (0 = D, 1 = H,
// 2 = W).  Three launches; returns the first nonzero cudaGetLastError(),
// else 0.
extern "C" int photon_bspline_prefilter(const float* field, float* out,
                                        long long D, long long H, long long W,
                                        long long C, const void* poles,
                                        const void* plans, void* stream) {
  return prefilter(false, field, out, D, H, W, C,
                   static_cast<const Pole*>(poles),
                   static_cast<const AxisPlan*>(plans), stream);
}

// ct, out: (D, H, W, C) float32, distinct arrays: out = K11^T ct.
extern "C" int photon_bspline_prefilter_bwd(const float* ct, float* out,
                                            long long D, long long H,
                                            long long W, long long C,
                                            const void* poles,
                                            const void* plans, void* stream) {
  return prefilter(true, ct, out, D, H, W, C,
                   static_cast<const Pole*>(poles),
                   static_cast<const AxisPlan*>(plans), stream);
}

// Particle splat: one erf spot per particle accumulated into the image, and
// its transpose (photon_splat_bwd, at the end of this file).
//
// Replaces both TPU kernels of photon_tpu/ops/splat_pallas.py: _splat_kernel
// (v1, roll + read-modify-write per particle into an image held in fast
// memory) and _splat_v2_kernel (particles sorted by image tile, one window
// per tile).  Both exist because a TPU has no scatter; their split by patch
// size and frame size disappears here: any K <= 64 and any frame go through
// this one kernel.
//
// Contract (that of splat_particles_pallas): Xs, Ys (P,) spot centres in
// pixels, A (P,) amplitudes already scaled by pi/32, col0, row0 (P,) int32
// patch anchors, a K x K patch per particle, the circular render mask
//   fc^2 + fr^2 <= (render_fraction * diameter)^2,
// and per pixel
//   A * [erf(s (fr - .5)) - erf(s (fr + .5))] * [erf(s (fc - .5)) - erf(s (fc + .5))],
//   s = sqrt(8) / diameter.
//
// The spot is separable: the weight of patch column j is E(j) - E(j + 1)
// with E(j) = erf(s ((col0 + j - Xs) - 1/2)), so a patch needs one erff a
// column edge and one a row edge, not four a pixel (the TPU kernels also
// form their weights per axis).  s is formed once a launch; an edge's
// argument may round an ulp apart from the plain version's fc +/- 0.5 over D.
// Only the rows and columns of the patch that the circle reaches (and the
// frame holds) are visited: at the bench's K = 8, D ~ 3.3 some 5 x 5 of the
// 8 x 8 pixels; every visited pixel still takes the plain version's circle
// test, so no deposit changes.
//
// What bounds it on an H100: the instructions it issues and their latency,
// then the atomics; not bytes (20 a particle in, one image out).  A spot's
// own work (its box, some 12 edges, 10 weights) is small, so one warp a
// particle leaves most lanes idle: a warp takes n consecutive particles
// (n = 1 .. 32, more where the launch is large), a group of 32 / n lanes
// each, which form the particles' edges and weights in the warp's slice of
// shared memory.  The deposits then go one particle at a time over the
// whole warp, one float atomic a pixel straight into the image, so the
// lanes of one instruction hit distinct pixels.  A small launch (the BOS
// pair's 2000-spot chunks) takes one particle a warp.  Particles with
// A == 0 deposit nothing.  Float atomics add in an order that changes from
// run to run, so the image differs in its last bits between runs (the TPU
// kernels are deterministic).
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include <cuda_runtime.h>

namespace {

constexpr double kSqrt8 = 2.8284271247461903;
constexpr double kTwoOverSqrtPi = 1.1283791670955126;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;          // warps a block, both kernels
constexpr int kWarpBytes = 12288;  // shared memory a warp, at most
// a quarter of an H100's resident warps (132 SMs x 64): a warp takes more
// particles only while the launch keeps that many busy
constexpr long long kBusyWarps = 132 * 16;

// Particles a warp: a power of two up to 32 while P keeps kBusyWarps warps
// busy and the warp's slice (bytes_for(n)) fits kWarpBytes.
template <class F>
int particles_a_warp(long long P, F bytes_for) {
  int n = 1;
  while (n < 32 && P >= 2LL * n * kBusyWarps && bytes_for(2 * n) <= kWarpBytes)
    n *= 2;
  return n;
}

// A particle's spot: the rows and columns of its K x K patch that the
// circle of radius rf_d about (x, y) can reach and the frame holds, from
// (c0 + j0, r0 + i0), nc x nr of them (nc = nr = 0: none).  The margin of
// 1e-3 px keeps every pixel that passes the circle test in f32.
struct Spot {
  int j0, i0, nc, nr;
};

__device__ __forceinline__ Spot spot_box(float x, float y, int c0, int r0,
                                         int K, int nx, int ny, float rf_d) {
  Spot b;
  b.j0 = max(max(0, -c0), (int)ceilf(x - rf_d - 1e-3f) - c0);
  b.i0 = max(max(0, -r0), (int)ceilf(y - rf_d - 1e-3f) - r0);
  b.nc = min(min(K - 1, nx - 1 - c0), (int)floorf(x + rf_d + 1e-3f) - c0)
         - b.j0 + 1;
  b.nr = min(min(K - 1, ny - 1 - r0), (int)floorf(y + rf_d + 1e-3f) - r0)
         - b.i0 + 1;
  if (b.nc <= 0 || b.nr <= 0) b.nc = b.nr = 0;
  return b;
}

// The spot's nc + 1 column and nr + 1 row edges, columns first, and its
// nc + nr weights, in the particle's slot of shared memory, by the g lanes
// of its group (h = 0 .. g - 1): ed[e] = erff(t) (and eg[e] = expf(-t^2)
// where eg is given), t = s ((pixel - centre) - .5) at the edge's pixel;
// wt[j] = ed[j'] - ed[j' + 1] (rows times `a`) and dw[j] = c (eg[j'] -
// eg[j' + 1]) where dw is given, j' = j for columns and j + 1 for rows.
// Every lane of the warp calls it.
__device__ __forceinline__ void spot_weights(
    int h, int g, const Spot& b, int c0, int r0, float x, float y, float s,
    float a, float c, float* ed, float* eg, float* wt, float* dw) {
  const int ne = b.nc ? b.nc + b.nr + 2 : 0;
  for (int e = h; e < ne; e += g) {
    const bool row = e > b.nc;
    const int at = row ? r0 + b.i0 + (e - b.nc - 1) : c0 + b.j0 + e;
    const float t = s * (((float)at - (row ? y : x)) - 0.5f);
    ed[e] = erff(t);
    if (eg) eg[e] = expf(-t * t);
  }
  __syncwarp();
  for (int j = h; j < b.nc + b.nr; j += g) {
    const int e = j + (j >= b.nc);
    const float w = ed[e] - ed[e + 1];
    wt[j] = j >= b.nc ? w * a : w;
    if (dw) dw[j] = c * (eg[e] - eg[e + 1]);
  }
  __syncwarp();
}

// the plain version's circle test, rounded as it rounds (no contraction)
__device__ __forceinline__ bool in_circle(float fc, float fr, float rf_d) {
  return __fadd_rn(__fmul_rn(fc, fc), __fmul_rn(fr, fr)) <=
         __fmul_rn(rf_d, rf_d);
}

// row of the k-th pixel of a spot nc wide: exact for k < 2^12, nc <= 64
// (the quotient lies at least 1 / (2 nc) from an integer)
__device__ __forceinline__ int spot_row(int k, float inv_nc) {
  return (int)(((float)k + 0.5f) * inv_nc);
}

// Warp w of block b takes the particles (b kWarps + w) n + l, l < n; lane
// l g + h (h < g = 32 / n) works for particle l.  Dynamic shared memory: n
// slots of 4 K + 3 floats a warp.
__global__ void __launch_bounds__(kWarps * 32) splat_kernel(
    const float* __restrict__ Xs, const float* __restrict__ Ys,
    const float* __restrict__ A, const int* __restrict__ col0,
    const int* __restrict__ row0, float* __restrict__ image, long long P,
    int K, int ny, int nx, float s, float rf_d, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = 32 / n, l = lane / g, h = lane - l * g;
  const int slot = 4 * K + 3;
  float* slots = smem + warp * n * slot;
  const long long p = ((long long)blockIdx.x * kWarps + warp) * n + l;
  float a = 0.0f, x = 0.0f, y = 0.0f;
  int c0 = 0, r0 = 0;
  if (p < P) {
    a = A[p];
    x = Xs[p];
    y = Ys[p];
    c0 = col0[p];
    r0 = row0[p];
  }
  Spot b = spot_box(x, y, c0, r0, K, nx, ny, rf_d);
  if (p >= P || a == 0.0f) b.nc = b.nr = 0;
  spot_weights(h, g, b, c0, r0, x, y, s, a, 0.0f, slots + l * slot, nullptr,
               slots + l * slot + 2 * (K + 1), nullptr);
  for (int q = 0; q < n; q++) {        // uniform over the warp
    const int nc = __shfl_sync(kFull, b.nc, q * g);
    const int nr = __shfl_sync(kFull, b.nr, q * g);
    const int cb = __shfl_sync(kFull, c0 + b.j0, q * g);
    const int rb = __shfl_sync(kFull, r0 + b.i0, q * g);
    const float qx = __shfl_sync(kFull, x, q * g);
    const float qy = __shfl_sync(kFull, y, q * g);
    if (nc == 0) continue;
    const float* wt = slots + q * slot + 2 * (K + 1);
    const float inv_nc = 1.0f / (float)nc;
    for (int k = lane; k < nc * nr; k += 32) {
      const int i = spot_row(k, inv_nc), j = k - i * nc;
      const int col = cb + j, row = rb + i;
      if (in_circle((float)col - qx, (float)row - qy, rf_d))
        atomicAdd(image + (long long)row * nx + col, wt[nc + i] * wt[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Transpose of the splat: d(Xs, Ys, A) from the image's cotangent.
//
// Replaces the backward of photon_tpu/ops/sensor_fast.py::
// _particle_splat_fused (_particle_splat_fused_bwd, the XLA transpose of the
// patch scatter): per particle, gather its K x K patch of the cotangent at
// (row0, col0), apply the circular mask, and reduce
//   d_A  =      sum ct * wy * wx,
//   d_Xs = -A * sum ct * wy * wx',
//   d_Ys = -A * sum ct * wy' * wx,
// with wx, wy the separable weights above and w' their derivatives, c (G(j)
// - G(j + 1)) with G(j) = exp(-t_j^2) of the same edge arguments and
// c = 2 s / sqrt(pi).  A warp takes n consecutive particles, a group of
// g = 32 / n lanes each: the group forms its spot's edges (an erff and an
// expf each) and weights in the particle's slot of shared memory, strides
// over the spot's rows and columns with a gather and products a pixel, and
// reduces over its g lanes with shuffles (at n = 32 a lane owns a particle
// and nothing is reduced).  No atomics, so the result is the same from run
// to run.  The bytes are 20 a particle in, 12 out, and the patches of the
// cotangent, which the dots' overlapping patches serve from L1 / L2.
// ---------------------------------------------------------------------------

// out: (3, P) rows d_Xs, d_Ys, d_A.  Dynamic shared memory: n slots of
// 8 K + 5 floats a warp.
__global__ void __launch_bounds__(kWarps * 32) splat_bwd_kernel(
    const float* __restrict__ Xs, const float* __restrict__ Ys,
    const float* __restrict__ A, const int* __restrict__ col0,
    const int* __restrict__ row0, const float* __restrict__ ct,
    float* __restrict__ out, long long P, int K, int ny, int nx, float s,
    float c, float rf_d, int n) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = 32 / n, l = lane / g, h = lane - l * g;
  const int slot = 8 * K + 5;
  float* ed = smem + (warp * n + l) * slot;
  float* eg = ed + 2 * (K + 1);
  float* wt = eg + 2 * (K + 1);
  float* dw = wt + 2 * K;
  const long long p = ((long long)blockIdx.x * kWarps + warp) * n + l;
  float x = 0.0f, y = 0.0f;
  int c0 = 0, r0 = 0;
  if (p < P) {
    x = Xs[p];
    y = Ys[p];
    c0 = col0[p];
    r0 = row0[p];
  }
  Spot b = spot_box(x, y, c0, r0, K, nx, ny, rf_d);
  if (p >= P) b.nc = b.nr = 0;
  spot_weights(h, g, b, c0, r0, x, y, s, 1.0f, c, ed, eg, wt, dw);
  float sA = 0.0f, sX = 0.0f, sY = 0.0f;
  if (b.nc) {
    const int cb = c0 + b.j0, rb = r0 + b.i0;
    const float inv_nc = 1.0f / (float)b.nc;
    for (int k = h; k < b.nc * b.nr; k += g) {
      const int i = spot_row(k, inv_nc), j = k - i * b.nc;
      const int col = cb + j, row = rb + i;
      if (!in_circle((float)col - x, (float)row - y, rf_d)) continue;
      const float gc = ct[(long long)row * nx + col];
      const float gy = gc * wt[b.nc + i];
      sA += gy * wt[j];
      sX += gy * dw[j];
      sY += gc * dw[b.nc + i] * wt[j];
    }
  }
  for (int off = g >> 1; off > 0; off >>= 1) {   // within the group
    sA += __shfl_xor_sync(kFull, sA, off);
    sX += __shfl_xor_sync(kFull, sX, off);
    sY += __shfl_xor_sync(kFull, sY, off);
  }
  if (h == 0 && p < P) {
    const float a = A[p];
    out[p] = -a * sX;                  // fc = col - Xs
    out[P + p] = -a * sY;
    out[2 * P + p] = sA;
  }
}

}  // namespace

// image: (ny, nx) f32, accumulated into (the wrapper zeroes it).  rf_d is
// render_fraction * diameter.  Returns cudaGetLastError() after the launch.
extern "C" int photon_splat(const float* Xs, const float* Ys, const float* A,
                            const int* col0, const int* row0, float* image,
                            long long P, int K, int ny, int nx,
                            float diameter, float rf_d, void* stream) {
  if (P <= 0) return 0;
  auto bytes_for = [&](int n) {
    return (int)(n * (4 * K + 3) * sizeof(float));
  };
  const int n = particles_a_warp(P, bytes_for);
  const long long per_block = (long long)kWarps * n;
  const long long blocks = (P + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  splat_kernel<<<(unsigned)blocks, kWarps * 32, kWarps * bytes_for(n),
                 (cudaStream_t)stream>>>(
      Xs, Ys, A, col0, row0, image, P, K, ny, nx,
      (float)(kSqrt8 / diameter), rf_d, n);
  return (int)cudaGetLastError();
}

// ct: (ny, nx) cotangent of the image; out: (3, P) rows d_Xs, d_Ys, d_A.
extern "C" int photon_splat_bwd(const float* Xs, const float* Ys,
                                const float* A, const int* col0,
                                const int* row0, const float* ct, float* out,
                                long long P, int K, int ny, int nx,
                                float diameter, float rf_d, void* stream) {
  if (P <= 0) return 0;
  auto bytes_for = [&](int n) {
    return (int)(n * (8 * K + 5) * sizeof(float));
  };
  const int n = particles_a_warp(P, bytes_for);
  const long long per_block = (long long)kWarps * n;
  const long long blocks = (P + per_block - 1) / per_block;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  splat_bwd_kernel<<<(unsigned)blocks, kWarps * 32, kWarps * bytes_for(n),
                     (cudaStream_t)stream>>>(
      Xs, Ys, A, col0, row0, ct, out, P, K, ny, nx,
      (float)(kSqrt8 / diameter),
      (float)(kTwoOverSqrtPi * kSqrt8 / diameter), rf_d, n);
  return (int)cudaGetLastError();
}

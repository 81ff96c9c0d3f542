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
// What bounds it on an H100: operations (four erff a patch pixel) and the
// atomic units, not bytes: 20 bytes a particle in, one image out.  Threads
// own (particle, patch pixel) pairs under a 64-bit index; particles with
// A == 0 return at once and pixels outside the circle or the frame make no
// atomic.  Float atomics add in an order that changes from run to run, so the
// image differs in its last bits between runs (the TPU kernels are
// deterministic); an ordered, tile-owned accumulation is a later design.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float erf_pair(float f, float sqrt8,
                                          float diameter) {
  return erff(sqrt8 * (f - 0.5f) / diameter) -
         erff(sqrt8 * (f + 0.5f) / diameter);
}

__global__ void splat_kernel(const float* __restrict__ Xs,
                             const float* __restrict__ Ys,
                             const float* __restrict__ A,
                             const int* __restrict__ col0,
                             const int* __restrict__ row0,
                             float* __restrict__ image, long long total,
                             int K, int ny, int nx, float diameter,
                             float rf_d) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int kk = K * K;
  long long p = idx / kk;
  float a = A[p];
  if (a == 0.0f) return;
  int k = (int)(idx - p * kk);
  int i = k / K, j = k - i * K;          // patch row, patch column
  int col = col0[p] + j, row = row0[p] + i;
  if (col < 0 || col >= nx || row < 0 || row >= ny) return;
  float fc = (float)col - Xs[p];
  float fr = (float)row - Ys[p];
  if (!(fc * fc + fr * fr <= rf_d * rf_d)) return;
  const float sqrt8 = 2.8284271247461903f;
  float wx = erf_pair(fc, sqrt8, diameter);
  float wy = erf_pair(fr, sqrt8, diameter) * a;
  atomicAdd(image + (long long)row * nx + col, wy * wx);
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
// with wx = erf_pair(fc), wy = erf_pair(fr) and w' the derivative of erf_pair
// (two Gaussians).  One warp owns a particle, lanes stride over the patch and
// reduce with shuffles: no atomics, so the result is the same from run to
// run.  Bound by operations (four erff and four expf a patch pixel); the
// bytes are 20 a particle in, 12 out, and the patches of the cotangent.
// ---------------------------------------------------------------------------

// d/df of erf_pair(f)
__device__ __forceinline__ float erf_pair_df(float f, float sqrt8,
                                             float diameter) {
  const float two_over_sqrt_pi = 1.1283791670955126f;
  float u0 = sqrt8 * (f - 0.5f) / diameter;
  float u1 = sqrt8 * (f + 0.5f) / diameter;
  return two_over_sqrt_pi * (sqrt8 / diameter) *
         (expf(-u0 * u0) - expf(-u1 * u1));
}

// out: (3, P) rows d_Xs, d_Ys, d_A
__global__ void splat_bwd_kernel(const float* __restrict__ Xs,
                                 const float* __restrict__ Ys,
                                 const float* __restrict__ A,
                                 const int* __restrict__ col0,
                                 const int* __restrict__ row0,
                                 const float* __restrict__ ct,
                                 float* __restrict__ out, long long P, int K,
                                 int ny, int nx, float diameter, float rf_d) {
  const int lane = threadIdx.x & 31;
  const long long p =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;                  // whole warps leave together
  const float x = Xs[p], y = Ys[p];
  const int c0 = col0[p], r0 = row0[p];
  const float sqrt8 = 2.8284271247461903f;
  float sA = 0.0f, sX = 0.0f, sY = 0.0f;
  for (int k = lane; k < K * K; k += 32) {
    int i = k / K, j = k - i * K;
    int col = c0 + j, row = r0 + i;
    if (col < 0 || col >= nx || row < 0 || row >= ny) continue;
    float fc = (float)col - x;
    float fr = (float)row - y;
    if (!(fc * fc + fr * fr <= rf_d * rf_d)) continue;
    float g = ct[(long long)row * nx + col];
    float wx = erf_pair(fc, sqrt8, diameter);
    float wy = erf_pair(fr, sqrt8, diameter);
    sA += g * wy * wx;
    sX += g * wy * erf_pair_df(fc, sqrt8, diameter);
    sY += g * erf_pair_df(fr, sqrt8, diameter) * wx;
  }
  for (int off = 16; off > 0; off >>= 1) {
    sA += __shfl_down_sync(0xffffffffu, sA, off);
    sX += __shfl_down_sync(0xffffffffu, sX, off);
    sY += __shfl_down_sync(0xffffffffu, sY, off);
  }
  if (lane == 0) {
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
  long long total = P * (long long)K * K;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  splat_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      Xs, Ys, A, col0, row0, image, total, K, ny, nx, diameter, rf_d);
  return (int)cudaGetLastError();
}

// ct: (ny, nx) cotangent of the image; out: (3, P) rows d_Xs, d_Ys, d_A.
extern "C" int photon_splat_bwd(const float* Xs, const float* Ys,
                                const float* A, const int* col0,
                                const int* row0, const float* ct, float* out,
                                long long P, int K, int ny, int nx,
                                float diameter, float rf_d, void* stream) {
  if (P <= 0) return 0;
  const int threads = 128;             // four particles a block
  long long blocks = (P + 3) / 4;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  splat_bwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      Xs, Ys, A, col0, row0, ct, out, P, K, ny, nx, diameter, rf_d);
  return (int)cudaGetLastError();
}

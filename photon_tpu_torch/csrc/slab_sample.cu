// The per-stage slab sampler of the dense march and its backward.
//
// photon_slab_sample replaces the TPU kernel
// photon_tpu/ops/march_dense_pallas.py::_fwd_kernel and photon_slab_sample_bwd
// replaces ::_bwd_kernel: (grad n, n-1) for P rays at voxel coordinates
// (ux, uy) between one pair of z slabs, blended by uz, and the VJP of that
// sample.  The march calls them once per integrator stage where no fused
// kernel covers the integrator (Adams-Bashforth; the gradient of RK4 with
// substeps), with the stage arithmetic in PyTorch around them.
//
// The TPU kernels build dense (W, B) and (H, B) weight matrices for blocks of
// 1024 rays, contract them against the slab pair in a transposed (4W, H)
// layout with bf16-split matrix products, and sum the slabs' cotangent across
// a sequential grid.  Here one thread owns one ray: it gathers its 2 x 2 x 2
// (trilinear) or 4 x 4 x 2 (cubic) taps as 16-byte loads straight from the
// two (H, W, 4) slabs of the (D, H, W, 4) field, in f32, with the same device
// functions as the fused march kernels (march_common.cuh: sample, sample_vjp).
// No transposed copy of the field, no ray blocks, no padding, no split
// passes; the backward adds the slabs' cotangent with one 16-byte atomicAdd a
// tap into the caller's zeroed slabs, where the TPU kernel accumulates over
// its grid.
//
// What bounds them on an H100: bytes in principle (28 bytes a ray and the two
// slabs forward, 56 bytes a ray and four slabs backward, a few microseconds
// at 1e5 rays), the launch in practice; the backward also the atomic units
// when neighbouring rays share voxels.  Float atomics make d_lo and d_hi
// differ in their last bits from run to run.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include "march_common.cuh"

namespace {

// a geometry that carries the slab's extent only: sampling reads nothing else
inline MarchGeom slab_geom(int W, int H) {
  return {0.0f, 0.0f, 1.0f, 1.0f, 0.0f, 0.0f, 1.0f, 1.0f, W, H, 2};
}

// out: (4, P) rows gx, gy, gz, n-1
template <int SCHEME>
__global__ void slab_sample_kernel(const float* __restrict__ ux,
                                   const float* __restrict__ uy,
                                   const float* __restrict__ uz,
                                   const float4* __restrict__ lo,
                                   const float4* __restrict__ hi,
                                   float* __restrict__ out, long long P,
                                   MarchGeom g) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float4 f = sample<SCHEME>(lo, hi, g, ux[p], uy[p], uz[p]);
  out[p] = f.x;
  out[P + p] = f.y;
  out[2 * P + p] = f.z;
  out[3 * P + p] = f.w;
}

// ct: (4, P) cotangent of the sample; d_u: (3, P) rows d_ux, d_uy, d_uz;
// d_lo, d_hi: zeroed (H, W) float4 slabs
template <int SCHEME>
__global__ void slab_sample_bwd_kernel(const float* __restrict__ ux,
                                       const float* __restrict__ uy,
                                       const float* __restrict__ uz,
                                       const float4* __restrict__ lo,
                                       const float4* __restrict__ hi,
                                       const float* __restrict__ ct,
                                       float* __restrict__ d_u,
                                       float4* __restrict__ d_lo,
                                       float4* __restrict__ d_hi, long long P,
                                       MarchGeom g) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float4 ds = make_float4(ct[p], ct[P + p], ct[2 * P + p], ct[3 * P + p]);
  SampleVjp v =
      sample_vjp<SCHEME>(lo, hi, d_lo, d_hi, g, ux[p], uy[p], uz[p], ds);
  d_u[p] = v.d_ux;
  d_u[P + p] = v.d_uy;
  d_u[2 * P + p] = v.d_uz;
}

}  // namespace

// scheme: 1 trilinear, 2 cubic (the slabs then hold B-spline coefficients).
// Both return cudaGetLastError() after the launch (0 = launched).
extern "C" int photon_slab_sample(const float* ux, const float* uy,
                                  const float* uz, const float* lo,
                                  const float* hi, float* out, long long P,
                                  int W, int H, int scheme, void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const int threads = 128;
  long long blocks = (P + threads - 1) / threads;
  auto kernel = scheme == 2 ? slab_sample_kernel<2> : slab_sample_kernel<1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      ux, uy, uz, reinterpret_cast<const float4*>(lo),
      reinterpret_cast<const float4*>(hi), out, P, slab_geom(W, H));
  return (int)cudaGetLastError();
}

// The wrapper zeroes d_lo and d_hi.
extern "C" int photon_slab_sample_bwd(const float* ux, const float* uy,
                                      const float* uz, const float* lo,
                                      const float* hi, const float* ct,
                                      float* d_u, float* d_lo, float* d_hi,
                                      long long P, int W, int H, int scheme,
                                      void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const int threads = 128;
  long long blocks = (P + threads - 1) / threads;
  auto kernel =
      scheme == 2 ? slab_sample_bwd_kernel<2> : slab_sample_bwd_kernel<1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      ux, uy, uz, reinterpret_cast<const float4*>(lo),
      reinterpret_cast<const float4*>(hi), ct, d_u,
      reinterpret_cast<float4*>(d_lo), reinterpret_cast<float4*>(d_hi), P,
      slab_geom(W, H));
  return (int)cudaGetLastError();
}

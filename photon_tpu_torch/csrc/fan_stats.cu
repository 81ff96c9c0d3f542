// Per-particle ray-fan statistics, forward.
//
// photon_fan_stats replaces the TPU kernel
// photon_tpu/ops/fan_pallas.py::_fan_fwd_kernel (tile math _fan_tile); its
// backward is fan_stats_bwd.cu.  For every (particle, ray): generate the ray
// toward its lens-aperture sample, apply the chief-ray march deltas, run the
// apparent / thin / thick biconvex lens (fan_common.cuh), intersect the
// sensor (x mirrored on the diffraction path), mask rays that leave the
// aperture or the sensor (fan_common.cuh, fan_path), weigh by cos^4; per
// particle
//   A = sum amp,  AX = sum amp * X,  AY = sum amp * Y      (X = d_x - 0.5).
//
// What bounds it on an H100: instructions.  Inputs are ten floats a particle
// and two floats a ray (shared by all particles), outputs three floats a
// particle, while every (particle, ray) pair costs a few hundred f32
// operations with ten square roots and nine divisions, whose rounding the
// image depends on (below), so the pair loop issues some four hundred
// instructions and the kernel runs near the SMs' issue rate.  The design
// spends little beside the pair loop.  One warp owns one particle (four a
// block): its lanes stride over the R rays with partial sums in registers,
// and shuffles end it, with no shared memory and no barrier.  The sums are
// added in one order, so the result is the same from run to run, in a
// launch of any size, and bit-equal to the kernel's first design; there are
// no atomics.  What every ray of a particle shares is formed once
// (load_particle), and the four divisions by a divisor that many rays share
// (the particle's distance to the image plane, the pixel pitch) multiply by
// a reciprocal and correct once (div_rn.cuh), with the division's bits.  The
// grid's index is the particle and the ray loop is 32-bit, so P * R is never
// formed (it is 6e7 on the BOS path).  The kernel masks its own ragged edge:
// no ray_mask row and no padding.
//
// Reciprocal square roots are 1.0f / sqrtf(x) (correctly rounded), the same
// as the plain PyTorch version beside the wrapper.  Build this file with
// -fmad=false (kernels.py does): every product and sum then rounds as the
// plain version rounds it, so the image agrees with the plain render to the
// order of the sums (with contraction the thick lens's discriminant moved the
// ray centroids by ~0.03 px).  The path itself (fan_path) pins its rounding
// with intrinsics, for the backward's sake, and computes what this kernel
// computed before it moved there, bit for bit.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include "fan_common.cuh"

namespace {

constexpr int kFanWarps = 4;     // warps (particles) a block
constexpr int kFanGroups = 4;    // lane groups of a particle's order

// A particle's rays are summed in the order of the kernel's first design, a
// block of 32 x kFanGroups threads a particle: ray r belongs to lane r % 32 of
// group (r / 32) % kFanGroups, each lane sums its rays in order, each group
// by a shuffle tree, and the groups' sums are added in order.  One warp
// carries that order, a group after another, so a particle's sums have the
// same bits in a launch of any size.
template <int LENS, bool MARCH>
__global__ void __launch_bounds__(32 * kFanWarps) fan_stats_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, const float* __restrict__ amp0,
    const float* __restrict__ dze, const float* __restrict__ dpx,
    const float* __restrict__ dpy, const float* __restrict__ ddx,
    const float* __restrict__ ddy, const float* __restrict__ ddz,
    const float* __restrict__ x_lens, const float* __restrict__ y_lens,
    float* __restrict__ out, long long P, int R, FanConst c, int mirror_x) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kFanWarps + (threadIdx.x >> 5);
  if (p >= P) return;                  // a whole warp
  const Particle pt = load_particle<MARCH>(c, p, xs, ys, zs, dze, dpx, dpy,
                                           ddx, ddy, ddz);
  const float a0 = amp0[p];

  float tA = 0.0f, tAX = 0.0f, tAY = 0.0f;
  for (int lg = 0; lg < kFanGroups; ++lg) {
    float sA = 0.0f, sAX = 0.0f, sAY = 0.0f;
    for (int r = 32 * lg + lane; r < R; r += 32 * kFanGroups) {
      const FanPath f = fan_path<LENS, MARCH>(c, pt, __ldg(x_lens + r),
                                              __ldg(y_lens + r), mirror_x);
      float qq;
      float cos2 = cos2_of(f.fd, qq);
      // amp, X and Y of a culled ray are zeroed under the same mask, so
      // that 0 * inf never reaches the sums
      float amp = f.valid ? a0 * cos2 * cos2 : 0.0f;
      float X = f.valid ? f.d_x - 0.5f : 0.0f;
      float Y = f.valid ? f.d_y - 0.5f : 0.0f;
      sA += amp;
      sAX += amp * X;
      sAY += amp * Y;
    }
    for (int off = 16; off > 0; off >>= 1) {
      sA += __shfl_xor_sync(0xffffffffu, sA, off);
      sAX += __shfl_xor_sync(0xffffffffu, sAX, off);
      sAY += __shfl_xor_sync(0xffffffffu, sAY, off);
    }
    tA += sA;
    tAX += sAX;
    tAY += sAY;
  }
  if (lane == 0) {
    out[p] = tA;
    out[P + p] = tAX;
    out[2 * P + p] = tAY;
  }
}

}  // namespace

// consts: host array of photon_fan_const_floats() floats in FanConst order.
// deltas (dze .. ddz) may be null when has_march is 0.  out: (3, P) rows
// A, AX, AY.  Returns cudaGetLastError() after the launch.
extern "C" int photon_fan_const_floats() { return kFanConstFloats; }

extern "C" int photon_fan_stats(
    const float* xs, const float* ys, const float* zs, const float* amp0,
    const float* dze, const float* dpx, const float* dpy, const float* ddx,
    const float* ddy, const float* ddz, const float* x_lens,
    const float* y_lens, float* out, long long P, int R, const float* consts,
    int lens_model, int has_march, int mirror_x, void* stream) {
  if (P <= 0) return 0;
  FanConst c;
  float* cf = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kFanConstFloats; ++i) cf[i] = consts[i];
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((P + kFanWarps - 1) / kFanWarps);
#define PHOTON_FAN_LAUNCH(L, M)                                              \
  fan_stats_kernel<L, M><<<blocks, 32 * kFanWarps, 0, st>>>(                 \
      xs, ys, zs, amp0, dze, dpx, dpy, ddx, ddy, ddz, x_lens, y_lens, out,   \
      P, R, c, mirror_x)
  if (has_march) {
    if (lens_model == LENS_APPARENT) PHOTON_FAN_LAUNCH(LENS_APPARENT, true);
    else if (lens_model == LENS_THIN) PHOTON_FAN_LAUNCH(LENS_THIN, true);
    else PHOTON_FAN_LAUNCH(LENS_GENERAL, true);
  } else {
    if (lens_model == LENS_APPARENT) PHOTON_FAN_LAUNCH(LENS_APPARENT, false);
    else if (lens_model == LENS_THIN) PHOTON_FAN_LAUNCH(LENS_THIN, false);
    else PHOTON_FAN_LAUNCH(LENS_GENERAL, false);
  }
#undef PHOTON_FAN_LAUNCH
  return (int)cudaGetLastError();
}

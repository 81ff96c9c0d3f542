// Dense chief-ray march through a (D, H, W, 4) refractive-index field, forward.
//
// Replaces the TPU kernel photon_tpu/ops/march_dense_fused.py::_fused_kernel_impl
// (both heads, both interpolation schemes): the plain head, and the `_traj`
// head that also writes every step's stage input states for the stage
// backward kernel.  It also replaces photon_tpu/ops/march_window.py::
// _window_kernel_impl, the TPU's march for slabs over 256 x 256 voxels (the same
// integrator over windows of the field that are planned on the host): voxels
// are gathered from device memory with 64-bit slab offsets, so one kernel
// serves every slab size below 2^31 voxels and needs no window.
// That kernel turns interpolation into a (W*4, 2H) x (2H, B) matrix product
// per integrator stage because a TPU cannot gather, which costs O(W*H) per ray
// and stage and needs a bf16 split.
// Here a thread owns chief rays, the slab loop runs inside the thread (it
// takes the place of the TPU kernel's sequential grid axis), the state
// (x, y, z, Tx, Ty, Tz) stays in registers, and every integrator stage does
// eight (trilinear) or thirty-two (cubic B-spline in x and y over prefiltered
// coefficients, linear in z) 16-byte loads of (grad n, n-1) voxels straight
// from the field: O(1) per ray and stage, all in f32.
//
// What bounds it on an H100: the latency of each ray's chain of stages and
// the instructions they issue, not bytes.  The inputs and outputs are 48
// bytes a ray and the field is read once from device memory (a 64^3 field is
// 4 MB and then sits in the 50 MB L2; of a 512^3 field only the slab pairs
// the rays are in do), while a ray does S slabs x 4 stages, each some 120
// SASS instructions with 8 gathers and a division that wait on the stage
// before.  120,000 rays are 29 warps an SM at most: too few chains to hide
// that latency one ray a thread.  So under the trilinear scheme a thread
// marches two rays (march_dense_kernel_rays): twice the independent chains
// for each warp's scheduler, and half the warps, which also leaves more of
// L1 to each where rays share no voxels.  A sample's coordinates divide by
// the voxel sizes through their reciprocals (div_rn.cuh, the division's
// bits), and the slab pair's base addresses are formed once a step.  Under
// the cubic scheme a thread marches one ray (march_dense_kernel, the first
// design): two rays a thread there took 1.27 against 1.05 ms of device time
// at 64^3 (NVIDIA H100 80GB HBM3, 700 W; PERF.md) and moved 45 of its
// 720,000 outputs.  Every output is bit-equal to the one-ray kernel's, for
// both heads and schemes.
//
// Integrates the z-parametrised eikonal ODE in Sharma's T = n dr/ds form,
//   d(x, y)/dz = (Tx/Tz, Ty/Tz),   dT/dz = (n/Tz) grad n,
// one step per slab (Euler, RK4, or RK4 with `substeps` substeps), landing on
//   z_plane = max(z_min + (ks - 0.5) dz_slab, z_min),  ks = S-1-s,  S = D-1,
// blending field[ks] (weight 1-uz) and field[ks+1] (weight uz).
//
// Each kernel has two instantiations of one integrator.  GRAD = false is the
// plain head: chief rays in, (x, y, z, dirx, diry, dirz) out.  GRAD = true is
// the head of the gradient route: the same arithmetic, and beside it the
// raw exit T of every ray that entered (the backward kernels start from it)
// and, when `traj` is not null, the stage residual: 5 floats a ray and
// in-band slab for Euler, 20 for RK4, laid out (S, rows, P) so that
// neighbouring threads write neighbouring floats.  With the residual the
// kernel is bound by bytes: S x 20 x 4 bytes a ray against 48.  The two heads
// return bit-equal outputs.
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// and called through ctypes (photon_tpu_torch/kernels.py).
#include "march_common.cuh"

namespace {

// Scheme 2: one ray a thread.  out: (6, P) rows x, y, z, dirx, diry, dirz
// after traversal; texit: (3, P) rows Tx, Ty, Tz before the normalisation
// (GRAD only; rays that never entered leave theirs unwritten)
template <bool GRAD>
__global__ void march_dense_kernel(const float* __restrict__ xs,
                                   const float* __restrict__ ys,
                                   const float* __restrict__ zs,
                                   const float* __restrict__ dcx,
                                   const float* __restrict__ dcy,
                                   const float* __restrict__ dcz,
                                   const float4* __restrict__ field,
                                   float* __restrict__ out,
                                   float* __restrict__ texit,
                                   float* __restrict__ traj, long long P,
                                   MarchGeom g, int algorithm, int substeps) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float cx = dcx[p], cy = dcy[p], cz = dcz[p];
  Entry e = entry_advance(g, xs[p], ys[p], zs[p], cx, cy, cz);
  float x = e.x, y = e.y, z = e.z;

  float dirx = cx, diry = cy, dirz = cz;
  if (e.inside) {
    State5 st = {x, y, g.n0 * cx, g.n0 * cy, g.n0 * cz};
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    const int rows = algorithm == 1 ? 5 : 20;
    for (int s = 0; s < S; ++s) {
      int ks = S - 1 - s;
      float z_plane = landing_plane(g, ks);
      if (!(z > z_plane)) continue;   // not yet in this slab's band
      const float4* lo = field + (long long)ks * slab;
      const float4* hi = lo + slab;
      float hstep = -(z - z_plane);
      float* tr = (GRAD && traj != nullptr)
                      ? traj + (long long)s * rows * P + p : nullptr;
      if (algorithm == 1) {
        if (tr != nullptr) store_state5(tr, P, st);
        st = axpy(st, hstep, rhs<2>(lo, hi, g, z_plane, st, z));
      } else if (substeps == 1) {
        if (tr != nullptr) {
          Stages sg;
          st = rk4<2>(lo, hi, g, z_plane, st, hstep, z, &sg);
          store_state5(tr, P, sg.s1);
          store_state5(tr + 5 * P, P, sg.s2);
          store_state5(tr + 10 * P, P, sg.s3);
          store_state5(tr + 15 * P, P, sg.s4);
        } else {
          st = rk4<2>(lo, hi, g, z_plane, st, hstep, z);
        }
      } else {
        float hs = hstep / (float)substeps;
        for (int si = 0; si < substeps; ++si)
          st = rk4<2>(lo, hi, g, z_plane, st, hs, z + (float)si * hs);
      }
      z = z_plane;
    }
    x = st.x;
    y = st.y;
    float tn = sqrtf(st.tx * st.tx + st.ty * st.ty + st.tz * st.tz);
    dirx = st.tx / tn;
    diry = st.ty / tn;
    dirz = st.tz / tn;
    if (GRAD) {
      texit[p] = st.tx;
      texit[P + p] = st.ty;
      texit[2 * P + p] = st.tz;
    }
  }
  out[p] = x;
  out[P + p] = y;
  out[2 * P + p] = z;
  out[3 * P + p] = dirx;
  out[4 * P + p] = diry;
  out[5 * P + p] = dirz;
}

// Scheme 1: kRays rays a thread.  Lane L of warp w owns rays
// 32 (kRays w + k) + L, k < kRays, so a warp's rays stay neighbours in the
// input as with one ray a thread, and each thread carries kRays independent
// stage chains that the scheduler interleaves: one ray's gathers wait while
// the other's arithmetic issues, where one ray a thread left the SMs idle
// for the latency of each stage's gathers and divisions.  The arithmetic of
// a ray is the one-ray kernel's (the same inlined stage functions in the
// same order), and its outputs are bit-equal to it.  A ray outside its
// slab's band computes the step all the same and drops it (its taps are
// clamped into the field), so that both chains sit in one basic block; the
// slab is skipped when no ray of the thread is in band.
//
// Bit-equal is a property of the compiled code, not only of the source:
// ptxas contracts a product and a sum into an FMA where it sees fit, so a
// change of the code around the arithmetic can move the bits.  Measured on
// the card (PERF.md): the integrator as a template parameter, a staged
// shared-memory box of voxels read through generic loads, and this loop
// under the cubic scheme each moved some outputs by an ulp; this form does
// not, for both heads, every integrator and every ray order.
constexpr int kRays = 2;

template <bool GRAD>
__global__ void march_dense_kernel_rays(const float* __restrict__ xs,
                                        const float* __restrict__ ys,
                                        const float* __restrict__ zs,
                                        const float* __restrict__ dcx,
                                        const float* __restrict__ dcy,
                                        const float* __restrict__ dcz,
                                        const float4* __restrict__ field,
                                        float* __restrict__ out,
                                        float* __restrict__ texit,
                                        float* __restrict__ traj, long long P,
                                        MarchGeom g, int algorithm,
                                        int substeps) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long first = warp * (32 * kRays) + (threadIdx.x & 31);
  long long p[kRays];
  bool inside[kRays];
  float x[kRays], y[kRays], z[kRays], d0[kRays][3];
  State5 st[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    p[k] = first + 32 * k;
    const long long q = p[k] < P ? p[k] : 0;
    const float cx = dcx[q], cy = dcy[q], cz = dcz[q];
    const Entry e = entry_advance(g, xs[q], ys[q], zs[q], cx, cy, cz);
    x[k] = e.x;
    y[k] = e.y;
    z[k] = e.z;
    d0[k][0] = cx;
    d0[k][1] = cy;
    d0[k][2] = cz;
    inside[k] = e.inside && p[k] < P;
    st[k] = {e.x, e.y, g.n0 * cx, g.n0 * cy, g.n0 * cz};
  }
  const int S = g.D - 1;
  const long long slab = (long long)g.H * g.W;
  const int rows = algorithm == 1 ? 5 : 20;
  for (int s = 0; s < S; ++s) {
    const int ks = S - 1 - s;
    const float z_plane = landing_plane(g, ks);
    bool band[kRays], any = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      band[k] = inside[k] && z[k] > z_plane;
      any = any || band[k];
    }
    if (!any) continue;
    // the slab pair's bases, formed once a slab step: the empty asm keeps
    // the compiler from folding the slab's 64-bit offset into the address
    // of every tap (some twenty integer instructions a stage; with the
    // bases, four wide multiply-adds)
    const float4* lo = field + (long long)ks * slab;
    asm("" : "+l"(lo));
    const float4* hi = lo + slab;
    asm("" : "+l"(hi));
    State5 next[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float hstep = -(z[k] - z_plane);
      float* tr = (GRAD && traj != nullptr && band[k])
                      ? traj + (long long)s * rows * P + p[k] : nullptr;
      if (algorithm == 1) {
        if (tr != nullptr) store_state5(tr, P, st[k]);
        next[k] = axpy(st[k], hstep, rhs<1>(lo, hi, g, z_plane, st[k], z[k]));
      } else if (substeps == 1) {
        if (tr != nullptr) {
          Stages sg;
          next[k] = rk4<1>(lo, hi, g, z_plane, st[k], hstep, z[k], &sg);
          store_state5(tr, P, sg.s1);
          store_state5(tr + 5 * P, P, sg.s2);
          store_state5(tr + 10 * P, P, sg.s3);
          store_state5(tr + 15 * P, P, sg.s4);
        } else {
          next[k] = rk4<1>(lo, hi, g, z_plane, st[k], hstep, z[k]);
        }
      } else {
        const float hs = hstep / (float)substeps;
        next[k] = st[k];
        for (int si = 0; si < substeps; ++si)
          next[k] = rk4<1>(lo, hi, g, z_plane, next[k], hs,
                           z[k] + (float)si * hs);
      }
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      if (band[k]) {
        st[k] = next[k];
        z[k] = z_plane;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (p[k] >= P) continue;
    float dirx = d0[k][0], diry = d0[k][1], dirz = d0[k][2];
    if (inside[k]) {
      x[k] = st[k].x;
      y[k] = st[k].y;
      const State5& t = st[k];
      float tn = sqrtf(t.tx * t.tx + t.ty * t.ty + t.tz * t.tz);
      dirx = t.tx / tn;
      diry = t.ty / tn;
      dirz = t.tz / tn;
      if (GRAD) {
        texit[p[k]] = t.tx;
        texit[P + p[k]] = t.ty;
        texit[2 * P + p[k]] = t.tz;
      }
    }
    const long long q = p[k];
    out[q] = x[k];
    out[P + q] = y[k];
    out[2 * P + q] = z[k];
    out[3 * P + q] = dirx;
    out[4 * P + q] = diry;
    out[5 * P + q] = dirz;
  }
}

template <bool GRAD>
int launch_march(const float* rays[6], const float* field, float* out,
                 float* texit, float* traj, long long P, int W, int H, int D,
                 const float* geom, int algorithm, int substeps, int scheme,
                 void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  MarchGeom g = make_geom(geom, W, H, D);
  const int threads = 128;
  const float4* f4 = reinterpret_cast<const float4*>(field);
  cudaStream_t st = (cudaStream_t)stream;
  if (scheme == 1) {
    const long long per_block = (long long)threads * kRays;
    march_dense_kernel_rays<GRAD>
        <<<(unsigned)((P + per_block - 1) / per_block), threads, 0, st>>>(
            rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], f4, out,
            texit, traj, P, g, algorithm, substeps);
  } else {
    march_dense_kernel<GRAD>
        <<<(unsigned)((P + threads - 1) / threads), threads, 0, st>>>(
            rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], f4, out,
            texit, traj, P, g, algorithm, substeps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// geom: host array [min_x, min_y, sx, sy, z_min, z_max, dz_slab, n0];
// scheme: 1 trilinear, 2 cubic (the field then holds B-spline coefficients).
// Both functions return cudaGetLastError() after the launch (0 = launched).
extern "C" int photon_march_dense(const float* xs, const float* ys,
                                  const float* zs, const float* dcx,
                                  const float* dcy, const float* dcz,
                                  const float* field, float* out,
                                  long long P, int W, int H, int D,
                                  const float* geom, int algorithm,
                                  int substeps, int scheme, void* stream) {
  const float* rays[6] = {xs, ys, zs, dcx, dcy, dcz};
  return launch_march<false>(rays, field, out, nullptr, nullptr, P, W, H, D,
                             geom, algorithm, substeps, scheme, stream);
}

// rays: (6, P) rows xs, ys, zs, dcx, dcy, dcz; texit: (3, P); traj:
// (S, rows, P) stage residual or null.  One step per slab only (Euler, or
// RK4 without substeps).
extern "C" int photon_march_dense_grad(const float* rays6, const float* field,
                                       float* out, float* texit, float* traj,
                                       long long P, int W, int H, int D,
                                       const float* geom, int algorithm,
                                       int scheme, void* stream) {
  const float* rays[6] = {rays6,         rays6 + P,     rays6 + 2 * P,
                          rays6 + 3 * P, rays6 + 4 * P, rays6 + 5 * P};
  return launch_march<true>(rays, field, out, texit, traj, P, W, H, D, geom,
                            algorithm, 1, scheme, stream);
}

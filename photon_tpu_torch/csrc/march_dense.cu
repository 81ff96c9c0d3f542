// Dense chief-ray march through a (D, H, W, 4) refractive-index field, forward.
//
// Replaces the TPU kernel photon_tpu/ops/march_dense_fused.py::_fused_kernel_impl
// (both heads, both interpolation schemes): the plain head, and the `_traj`
// head that also writes every step's stage input states for the stage
// backward kernel.
// That kernel turns interpolation into a (W*4, 2H) x (2H, B) matrix product
// per integrator stage because a TPU cannot gather, which costs O(W*H) per ray
// and stage and needs a bf16 split.
// Here one thread owns one chief ray, the slab loop runs inside the thread (it
// takes the place of the TPU kernel's sequential grid axis), the state
// (x, y, z, Tx, Ty, Tz) stays in registers, and every integrator stage does
// eight (trilinear) or thirty-two (cubic B-spline in x and y over prefiltered
// coefficients, linear in z) 16-byte loads of (grad n, n-1) voxels straight
// from the field: O(1) per ray and stage, all in f32.  The scheme is a
// template parameter, so the trilinear instantiation is the arithmetic it
// always was.
//
// What bounds it on an H100: operations and load latency, not bytes.  The
// inputs and outputs are 48 bytes a ray and the field is read once from
// device memory (a 64^3 field is 4 MB and then sits in the 50 MB L2), while a
// ray does S slabs x 4 stages x 8 gathers with a few hundred f32 operations
// a stage, each stage depending on the one before.  The design answers with
// parallelism across rays (one thread each, 128-thread blocks) and with
// neighbouring rays reading neighbouring voxels (particles of one dot are
// adjacent in the input).
//
// Integrates the z-parametrised eikonal ODE in Sharma's T = n dr/ds form,
//   d(x, y)/dz = (Tx/Tz, Ty/Tz),   dT/dz = (n/Tz) grad n,
// one step per slab (Euler, RK4, or RK4 with `substeps` substeps), landing on
//   z_plane = max(z_min + (ks - 0.5) dz_slab, z_min),  ks = S-1-s,  S = D-1,
// blending field[ks] (weight 1-uz) and field[ks+1] (weight uz).
//
// The kernel has two instantiations of one integrator.  GRAD = false is the
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

// out: (6, P) rows x, y, z, dirx, diry, dirz after traversal; texit: (3, P)
// rows Tx, Ty, Tz before the normalisation (GRAD only; rays that never
// entered leave theirs unwritten)
template <bool GRAD, int SCHEME>
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
        st = axpy(st, hstep, rhs<SCHEME>(lo, hi, g, z_plane, st, z));
      } else if (substeps == 1) {
        if (tr != nullptr) {
          Stages sg;
          st = rk4<SCHEME>(lo, hi, g, z_plane, st, hstep, z, &sg);
          store_state5(tr, P, sg.s1);
          store_state5(tr + 5 * P, P, sg.s2);
          store_state5(tr + 10 * P, P, sg.s3);
          store_state5(tr + 15 * P, P, sg.s4);
        } else {
          st = rk4<SCHEME>(lo, hi, g, z_plane, st, hstep, z);
        }
      } else {
        float hs = hstep / (float)substeps;
        for (int si = 0; si < substeps; ++si)
          st = rk4<SCHEME>(lo, hi, g, z_plane, st, hs, z + (float)si * hs);
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

template <bool GRAD>
int launch_march(const float* rays[6], const float* field, float* out,
                 float* texit, float* traj, long long P, int W, int H, int D,
                 const float* geom, int algorithm, int substeps, int scheme,
                 void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  MarchGeom g = make_geom(geom, W, H, D);
  const int threads = 128;
  long long blocks = (P + threads - 1) / threads;
  auto kernel = scheme == 2 ? march_dense_kernel<GRAD, 2>
                            : march_dense_kernel<GRAD, 1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays[0], rays[1], rays[2], rays[3], rays[4], rays[5],
      reinterpret_cast<const float4*>(field), out, texit, traj, P, g,
      algorithm, substeps);
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

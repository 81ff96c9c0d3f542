// Dense chief-ray march through a (D, H, W, 4) refractive-index field, forward.
//
// Replaces the TPU kernel photon_tpu/ops/march_dense_fused.py::_fused_kernel_impl
// (the no-trajectory head, trilinear scheme).  That kernel turns interpolation
// into a (W*4, 2H) x (2H, B) matrix product per integrator stage because a TPU
// cannot gather, which costs O(W*H) per ray and stage and needs a bf16 split.
// Here one thread owns one chief ray, the slab loop runs inside the thread (it
// takes the place of the TPU kernel's sequential grid axis), the state
// (x, y, z, Tx, Ty, Tz) stays in registers, and every integrator stage does
// eight 16-byte loads of (grad n, n-1) voxels straight from the field: O(1)
// per ray and stage, all in f32.
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
// Plain C interface, no PyTorch headers: built by nvcc into a shared library
// and called through ctypes (photon_tpu_torch/kernels.py).
#include <cuda_runtime.h>

namespace {

struct MarchGeom {
  float min_x, min_y, sx, sy, z_min, z_max, dz_slab, n0;
  int W, H, D;
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  // NaN-safe in the sense that fminf/fmaxf return the non-NaN operand
  return fminf(fmaxf(v, lo), hi);
}

// (grad n, n-1) at voxel coordinates between slab `lo` (weight 1-uz) and
// `hi` (weight uz): clamp-then-hat addressing, i.e. the two-tap clamped
// fetch per axis that the dense hat weights max(0, 1-|clip(u,0,n-1)-i|)
// evaluate to.
__device__ __forceinline__ float4 sample(const float4* __restrict__ lo,
                                         const float4* __restrict__ hi,
                                         const MarchGeom& g, float ux,
                                         float uy, float uz) {
  ux = clampf(ux, 0.0f, (float)(g.W - 1));
  uy = clampf(uy, 0.0f, (float)(g.H - 1));
  int ix = min((int)ux, g.W - 2);
  int iy = min((int)uy, g.H - 2);
  float fx = ux - (float)ix;
  float fy = uy - (float)iy;
  int o00 = iy * g.W + ix;
  int o10 = o00 + g.W;
  float4 a00 = __ldg(lo + o00), a01 = __ldg(lo + o00 + 1);
  float4 a10 = __ldg(lo + o10), a11 = __ldg(lo + o10 + 1);
  float4 b00 = __ldg(hi + o00), b01 = __ldg(hi + o00 + 1);
  float4 b10 = __ldg(hi + o10), b11 = __ldg(hi + o10 + 1);
  float wx0 = 1.0f - fx, wx1 = fx;
  float wy0 = 1.0f - fy, wy1 = fy;
  float wz0 = 1.0f - uz, wz1 = uz;
  float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
  float4 r;
#define PHOTON_BLEND(c)                                                     \
  r.c = wz0 * (w00 * a00.c + w01 * a01.c + w10 * a10.c + w11 * a11.c) +     \
        wz1 * (w00 * b00.c + w01 * b01.c + w10 * b10.c + w11 * b11.c);
  PHOTON_BLEND(x) PHOTON_BLEND(y) PHOTON_BLEND(z) PHOTON_BLEND(w)
#undef PHOTON_BLEND
  return r;
}

struct State5 {
  float x, y, tx, ty, tz;
};

__device__ __forceinline__ State5 axpy(const State5& s, float h,
                                       const State5& k) {
  return {s.x + h * k.x, s.y + h * k.y, s.tx + h * k.tx, s.ty + h * k.ty,
          s.tz + h * k.tz};
}

__device__ __forceinline__ State5 rhs(const float4* __restrict__ lo,
                                      const float4* __restrict__ hi,
                                      const MarchGeom& g, float z_plane,
                                      const State5& s, float z_at) {
  float uz = clampf((z_at - z_plane) / g.dz_slab, 0.0f, 1.0f);
  float ux = 0.5f + (s.x - g.min_x) / g.sx;
  float uy = 0.5f + (s.y - g.min_y) / g.sy;
  float4 f = sample(lo, hi, g, ux, uy, uz);
  float inv_tz = 1.0f / s.tz;
  float gn = (1.0f + f.w) * inv_tz;
  return {s.tx * inv_tz, s.ty * inv_tz, gn * f.x, gn * f.y, gn * f.z};
}

__device__ __forceinline__ State5 rk4(const float4* __restrict__ lo,
                                      const float4* __restrict__ hi,
                                      const MarchGeom& g, float z_plane,
                                      const State5& s, float h, float z0) {
  State5 k1 = rhs(lo, hi, g, z_plane, s, z0);
  float h2 = h / 2.0f;
  State5 k2 = rhs(lo, hi, g, z_plane, axpy(s, h2, k1), z0 + h2);
  State5 k3 = rhs(lo, hi, g, z_plane, axpy(s, h2, k2), z0 + h2);
  State5 k4 = rhs(lo, hi, g, z_plane, axpy(s, h, k3), z0 + h);
  float s6 = h / 6.0f;
  State5 sum = {k1.x + 2.0f * k2.x + 2.0f * k3.x + k4.x,
                k1.y + 2.0f * k2.y + 2.0f * k3.y + k4.y,
                k1.tx + 2.0f * k2.tx + 2.0f * k3.tx + k4.tx,
                k1.ty + 2.0f * k2.ty + 2.0f * k3.ty + k4.ty,
                k1.tz + 2.0f * k2.tz + 2.0f * k3.tz + k4.tz};
  return axpy(s, s6, sum);
}

// out: (6, P) rows x, y, z, dirx, diry, dirz after traversal
__global__ void march_dense_kernel(const float* __restrict__ xs,
                                   const float* __restrict__ ys,
                                   const float* __restrict__ zs,
                                   const float* __restrict__ dcx,
                                   const float* __restrict__ dcy,
                                   const float* __restrict__ dcz,
                                   const float4* __restrict__ field,
                                   float* __restrict__ out, long long P,
                                   MarchGeom g, int algorithm, int substeps) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x0 = xs[p], y0 = ys[p], z0 = zs[p];
  float cx = dcx[p], cy = dcy[p], cz = dcz[p];

  // entry advance to the volume top; rays that start above it are moved
  // onto it, the rest start where they are
  bool above = z0 >= g.z_max;
  float adv = above ? fmaxf((g.z_max - z0) / cz, 0.0f) : 0.0f;
  float x = x0 + cx * adv;
  float y = y0 + cy * adv;
  float z = above ? g.z_max : z0 + cz * adv;
  bool inside = (z <= g.z_max) && (z >= g.z_min) && (cz < 0.0f);

  float dirx = cx, diry = cy, dirz = cz;
  if (inside) {
    State5 st = {x, y, g.n0 * cx, g.n0 * cy, g.n0 * cz};
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    for (int s = 0; s < S; ++s) {
      int ks = S - 1 - s;
      // product and sum rounded separately (no FMA), as the plain version
      // forms the planes on the host
      float z_plane = fmaxf(
          __fadd_rn(g.z_min, __fmul_rn((float)ks - 0.5f, g.dz_slab)),
          g.z_min);
      if (!(z > z_plane)) continue;   // not yet in this slab's band
      const float4* lo = field + (long long)ks * slab;
      const float4* hi = lo + slab;
      float hstep = -(z - z_plane);
      if (algorithm == 1) {
        st = axpy(st, hstep, rhs(lo, hi, g, z_plane, st, z));
      } else if (substeps == 1) {
        st = rk4(lo, hi, g, z_plane, st, hstep, z);
      } else {
        float hs = hstep / (float)substeps;
        for (int si = 0; si < substeps; ++si)
          st = rk4(lo, hi, g, z_plane, st, hs, z + (float)si * hs);
      }
      z = z_plane;
    }
    x = st.x;
    y = st.y;
    float tn = sqrtf(st.tx * st.tx + st.ty * st.ty + st.tz * st.tz);
    dirx = st.tx / tn;
    diry = st.ty / tn;
    dirz = st.tz / tn;
  }
  out[p] = x;
  out[P + p] = y;
  out[2 * P + p] = z;
  out[3 * P + p] = dirx;
  out[4 * P + p] = diry;
  out[5 * P + p] = dirz;
}

}  // namespace

// geom: host array [min_x, min_y, sx, sy, z_min, z_max, dz_slab, n0].
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int photon_march_dense(const float* xs, const float* ys,
                                  const float* zs, const float* dcx,
                                  const float* dcy, const float* dcz,
                                  const float* field, float* out,
                                  long long P, int W, int H, int D,
                                  const float* geom, int algorithm,
                                  int substeps, void* stream) {
  if (P <= 0) return 0;
  MarchGeom g = {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5],
                 geom[6], geom[7], W, H, D};
  const int threads = 128;
  long long blocks = (P + threads - 1) / threads;
  march_dense_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      xs, ys, zs, dcx, dcy, dcz, reinterpret_cast<const float4*>(field), out,
      P, g, algorithm, substeps);
  return (int)cudaGetLastError();
}

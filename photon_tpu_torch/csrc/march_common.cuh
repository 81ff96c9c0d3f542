// Device functions shared by the dense march kernels: the forward march
// (march_dense.cu) and its two backward kernels (march_bwd.cu).
//
// The march integrates the z-parametrised eikonal ODE in Sharma's
// T = n dr/ds form,
//   d(x, y)/dz = (Tx/Tz, Ty/Tz),   dT/dz = (n/Tz) grad n,
// one step per slab, landing on
//   z_plane = max(z_min + (ks - 0.5) dz_slab, z_min),  ks = S-1-s,  S = D-1,
// and blending field[ks] (weight 1-uz) with field[ks+1] (weight uz).
#pragma once
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

// landing plane of the slab step that blends field[ks] and field[ks+1];
// product and sum rounded separately (no FMA), as the plain version forms the
// planes on the host
__device__ __forceinline__ float landing_plane(const MarchGeom& g, int ks) {
  return fmaxf(
      __fadd_rn(g.z_min, __fmul_rn((float)ks - 0.5f, g.dz_slab)), g.z_min);
}

// the plane the ray stands on when it reaches that slab step from the one
// above: landing_plane(g, ks + 1), which never needs its clamp
__device__ __forceinline__ float plane_above(const MarchGeom& g, int ks) {
  return __fadd_rn(g.z_min, __fmul_rn((float)ks + 0.5f, g.dz_slab));
}

// Entry advance to the volume top: rays that start above it are moved onto
// it, the rest start where they are.  `inside`: in the z range after the
// advance and travelling down.
struct Entry {
  float x, y, z, adv;
  bool above, inside;
};

__device__ __forceinline__ Entry entry_advance(const MarchGeom& g, float x0,
                                               float y0, float z0, float cx,
                                               float cy, float cz) {
  Entry e;
  e.above = z0 >= g.z_max;
  e.adv = e.above ? fmaxf((g.z_max - z0) / cz, 0.0f) : 0.0f;
  e.x = x0 + cx * e.adv;
  e.y = y0 + cy * e.adv;
  e.z = e.above ? g.z_max : z0 + cz * e.adv;
  e.inside = (e.z <= g.z_max) && (e.z >= g.z_min) && (cz < 0.0f);
  return e;
}

// Clamp-then-hat addressing of one stage sample: the lower corner, the
// upper-tap weights and whether the clamp let the coordinate through.
struct Taps {
  int o00, o10;
  float fx, fy;
  bool free_x, free_y;
};

__device__ __forceinline__ Taps taps(const MarchGeom& g, float ux, float uy) {
  Taps t;
  t.free_x = (ux > 0.0f) && (ux < (float)(g.W - 1));
  t.free_y = (uy > 0.0f) && (uy < (float)(g.H - 1));
  ux = clampf(ux, 0.0f, (float)(g.W - 1));
  uy = clampf(uy, 0.0f, (float)(g.H - 1));
  int ix = min((int)ux, g.W - 2);
  int iy = min((int)uy, g.H - 2);
  t.fx = ux - (float)ix;
  t.fy = uy - (float)iy;
  t.o00 = iy * g.W + ix;
  t.o10 = t.o00 + g.W;
  return t;
}

// (grad n, n-1) at voxel coordinates between slab `lo` (weight 1-uz) and
// `hi` (weight uz): the two-tap clamped fetch per axis that the dense hat
// weights max(0, 1-|clip(u,0,n-1)-i|) evaluate to.
__device__ __forceinline__ float4 sample(const float4* __restrict__ lo,
                                         const float4* __restrict__ hi,
                                         const MarchGeom& g, float ux,
                                         float uy, float uz) {
  Taps t = taps(g, ux, uy);
  float4 a00 = __ldg(lo + t.o00), a01 = __ldg(lo + t.o00 + 1);
  float4 a10 = __ldg(lo + t.o10), a11 = __ldg(lo + t.o10 + 1);
  float4 b00 = __ldg(hi + t.o00), b01 = __ldg(hi + t.o00 + 1);
  float4 b10 = __ldg(hi + t.o10), b11 = __ldg(hi + t.o10 + 1);
  float wx0 = 1.0f - t.fx, wx1 = t.fx;
  float wy0 = 1.0f - t.fy, wy1 = t.fy;
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

__device__ __forceinline__ float dot5(const State5& a, const State5& b) {
  return a.x * b.x + a.y * b.y + a.tx * b.tx + a.ty * b.ty + a.tz * b.tz;
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

// The input states of the four RK4 stages of one step.
struct Stages {
  State5 s1, s2, s3, s4;
};

__device__ __forceinline__ State5 rk4_combine(const State5& s, float h,
                                              const State5& k1,
                                              const State5& k2,
                                              const State5& k3,
                                              const State5& k4) {
  float s6 = h / 6.0f;
  State5 sum = {k1.x + 2.0f * k2.x + 2.0f * k3.x + k4.x,
                k1.y + 2.0f * k2.y + 2.0f * k3.y + k4.y,
                k1.tx + 2.0f * k2.tx + 2.0f * k3.tx + k4.tx,
                k1.ty + 2.0f * k2.ty + 2.0f * k3.ty + k4.ty,
                k1.tz + 2.0f * k2.tz + 2.0f * k3.tz + k4.tz};
  return axpy(s, s6, sum);
}

// One RK4 step; `st`, when not null, receives the stage input states.
__device__ __forceinline__ State5 rk4(const float4* __restrict__ lo,
                                      const float4* __restrict__ hi,
                                      const MarchGeom& g, float z_plane,
                                      const State5& s, float h, float z0,
                                      Stages* st = nullptr) {
  State5 k1 = rhs(lo, hi, g, z_plane, s, z0);
  float h2 = h / 2.0f;
  State5 s2 = axpy(s, h2, k1);
  State5 k2 = rhs(lo, hi, g, z_plane, s2, z0 + h2);
  State5 s3 = axpy(s, h2, k2);
  State5 k3 = rhs(lo, hi, g, z_plane, s3, z0 + h2);
  State5 s4 = axpy(s, h, k3);
  State5 k4 = rhs(lo, hi, g, z_plane, s4, z0 + h);
  if (st != nullptr) *st = {s, s2, s3, s4};
  return rk4_combine(s, h, k1, k2, k3, k4);
}

// Stage residual layout: (S, rows, P) floats, rows = 5 (Euler) or 20 (RK4,
// stages s1..s4), each stage as (x, y, Tx, Ty, Tz); neighbouring rays are
// neighbouring floats.
__device__ __forceinline__ void store_state5(float* t, long long P,
                                             const State5& s) {
  t[0] = s.x;
  t[P] = s.y;
  t[2 * P] = s.tx;
  t[3 * P] = s.ty;
  t[4 * P] = s.tz;
}

__device__ __forceinline__ State5 load_state5(const float* t, long long P) {
  return {t[0], t[P], t[2 * P], t[3 * P], t[4 * P]};
}

inline MarchGeom make_geom(const float* geom, int W, int H, int D) {
  return {geom[0], geom[1], geom[2], geom[3], geom[4], geom[5],
          geom[6], geom[7], W, H, D};
}

}  // namespace

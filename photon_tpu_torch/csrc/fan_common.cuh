// What the per-particle ray-fan kernels share: the forward (fan_stats.cu,
// built without FMA contraction) and its backward (fan_stats_bwd.cu, built
// with it).  The host-side constants and the path of one (particle, ray)
// from its source point through the march deltas, the lens and onto the
// sensor: fan_path.
//
// The path is written with rounding intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn), which the compiler never contracts into an FMA, so that it
// rounds as the plain PyTorch version rounds it in both files.  The backward
// depends on that: the thick lens's discriminant beta^2 - 4 gamma falls from
// ~1e16 to ~1e9 in f32 (1e8 um radii), so one ulp of a ray entering the lens
// moves where it lands on the sensor, and the centroid loss's cotangent
// ct_A + ct_AX X + ct_AY Y nearly cancels for every ray, so the pixel
// coordinates X and Y must be the plain version's to the last bit.  Divisions
// and square roots are IEEE in both files (nvcc's default), as in PyTorch;
// a division by a divisor that every ray of a particle, or every ray, shares
// (the particle's distance to the image plane, the pixel pitch, the focal
// length) multiplies by its reciprocal and corrects once (div_rn.cuh), which
// returns the division's bits in fewer instructions.
#pragma once
#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

// host-precomputed scalars (formed in float64, rounded once to f32); the
// last two are the correctly rounded f32 reciprocals of the f32 pixel pitch
// and focal length, the divisors of div_rn_by
struct FanConst {
  float image_distance, shift, z_object, magnification;
  float z_lens, half_pitch_sq, focal_length;
  float czf, r_front, czb, r_back, n_lens, inv_n_lens;
  float z_sensor, pixel_pitch, pixel_1_x, pixel_1_y;
  float nx_f, ny_f, nx_m1;
  float inv_pixel_pitch, inv_focal_length;
};
constexpr int kFanConstFloats = sizeof(FanConst) / sizeof(float);

enum { LENS_APPARENT = 0, LENS_THIN = 1, LENS_GENERAL = 2 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float rsq(float v) { return 1.0f / sqrtf(v); }

// one rounding a product or a sum, never fused
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dot3_rn(const V3& a, const V3& b) {
  return add_rn(add_rn(mul_rn(a.x, b.x), mul_rn(a.y, b.y)), mul_rn(a.z, b.z));
}
// p + d t, componentwise
__device__ __forceinline__ V3 along_rn(const V3& p, const V3& d, float t) {
  return {add_rn(p.x, mul_rn(d.x, t)), add_rn(p.y, mul_rn(d.y, t)),
          add_rn(p.z, mul_rn(d.z, t))};
}
__device__ __forceinline__ V3 scale_rn(const V3& v, float s) {
  return {mul_rn(v.x, s), mul_rn(v.y, s), mul_rn(v.z, s)};
}

// Snell refraction of the unit direction d at the unit normal n, index ratio
// `ratio`: the direction o before its normalisation and 1 / |o|; `ok` false
// on total internal reflection
struct Refraction {
  V3 o;
  float inv;
  bool ok;
};

__device__ __forceinline__ Refraction refract(const V3& d, const V3& n,
                                              float ratio) {
  Refraction r;
  const float cos_i = -dot3_rn(d, n);
  const float radicand =
      sub_rn(1.0f, mul_rn(mul_rn(ratio, ratio),
                          sub_rn(1.0f, mul_rn(cos_i, cos_i))));
  const float k = sub_rn(mul_rn(ratio, cos_i), sqrtf(fmaxf(radicand, 0.0f)));
  r.o = {add_rn(mul_rn(d.x, ratio), mul_rn(k, n.x)),
         add_rn(mul_rn(d.y, ratio), mul_rn(k, n.y)),
         add_rn(mul_rn(d.z, ratio), mul_rn(k, n.z))};
  r.inv = rsq(dot3_rn(r.o, r.o));
  r.ok = !(radicand < 0.0f);
  return r;
}

// o = p - centre, beta = 2 d.o, gamma = o.o - r^2, disc = beta^2 - 4 gamma
struct SphereTerms {
  V3 o;
  float beta, disc;
};

__device__ __forceinline__ SphereTerms sphere_terms(const V3& p, const V3& d,
                                                    float cz, float radius) {
  SphereTerms s;
  s.o = {p.x, p.y, p.z - cz};
  s.beta = mul_rn(2.0f, dot3_rn(d, s.o));
  const float gamma = sub_rn(dot3_rn(s.o, s.o), mul_rn(radius, radius));
  s.disc = sub_rn(mul_rn(s.beta, s.beta), mul_rn(4.0f, gamma));
  return s;
}

// distance along d to the first intersection with the sphere centred
// (0, 0, cz): the nearer root for a positive radius, the farther for a
// negative one; `hit` false on a miss
__device__ __forceinline__ float sphere_t(const V3& p, const V3& d, float cz,
                                          float radius, bool& hit) {
  const SphereTerms s = sphere_terms(p, d, cz, radius);
  const float sq = sqrtf(fmaxf(s.disc, 0.0f));
  const float t1 = (-s.beta + sq) / 2.0f;
  const float t2 = (-s.beta - sq) / 2.0f;
  hit = !(s.disc < 0.0f);
  return radius > 0.0f ? fminf(t1, t2) : fmaxf(t1, t2);
}

// The chief-ray march's deltas of one particle (zero without a march).
struct Deltas {
  float dze, dpx, dpy, ddx, ddy, ddz;
};

// What the path of every ray of one particle shares, formed once: the
// source point, its distance to the image plane and that distance's
// reciprocal, the deltas, and the source's and the exit's z in the other
// frame of the march.
struct Particle {
  float x0, y0, z0;
  float denom, inv_denom;     // image_distance - z0, RN(1 / denom)
  Deltas m;
  float z_march, z_exit;      // z0 - shift, dze + shift
};

template <bool MARCH>
__device__ __forceinline__ Particle load_particle(
    const FanConst& c, long long p, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ zs,
    const float* __restrict__ dze, const float* __restrict__ dpx,
    const float* __restrict__ dpy, const float* __restrict__ ddx,
    const float* __restrict__ ddy, const float* __restrict__ ddz) {
  Particle t;
  t.x0 = xs[p];
  t.y0 = ys[p];
  t.z0 = zs[p];
  t.m = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (MARCH) t.m = {dze[p], dpx[p], dpy[p], ddx[p], ddy[p], ddz[p]};
  t.denom = sub_rn(c.image_distance, t.z0);
  t.inv_denom = __frcp_rn(t.denom);
  t.z_march = sub_rn(t.z0, c.shift);
  t.z_exit = add_rn(t.m.dze, c.shift);
  return t;
}

// One (particle, ray) from its source point to the sensor, with what the
// backward needs of each stage.
struct FanPath {
  float tx, ty, inv;          // generated direction dg = (tx, ty, -1) inv
  float t_m, inv_m;           // march: p0 = p + dg t_m + dpos, d0 = o_m inv_m
  V3 o_m;
  V3 p0, d0;                  // the ray entering the lens
  float t_l, inv_thin;        // thin lens: hit at p0 + d0 t_l, then o_thin
  V3 o_thin;
  V3 h1, n1, d1, n2;          // thick lens: front hit, its unit normal, the
  float invn1, inv_r1;        //   direction inside, the back unit normal, the
  float invn2, inv_r2;        //   inverse norms of normals and refractions
  V3 pl, dl;                  // the ray leaving the lens (apparent: entering)
  float t_s;                  // to the sensor (apparent: the object plane)
  V3 fd;                      // direction of the cos^4 weight
  float d_x, d_y;             // pixel coordinates
  bool valid;
};

template <int LENS, bool MARCH>
__device__ __forceinline__ FanPath fan_path(const FanConst& c,
                                            const Particle& pt, float xl,
                                            float yl, int mirror_x) {
  FanPath f;
  const Deltas& m = pt.m;
  f.tx = div_rn_by(-sub_rn(xl, pt.x0), pt.denom, pt.inv_denom);
  f.ty = div_rn_by(-sub_rn(yl, pt.y0), pt.denom, pt.inv_denom);
  f.inv = rsq(add_rn(add_rn(mul_rn(f.tx, f.tx), mul_rn(f.ty, f.ty)), 1.0f));
  V3 p = {pt.x0, pt.y0, pt.z0};
  V3 d = {mul_rn(f.tx, f.inv), mul_rn(f.ty, f.inv), -f.inv};
  f.valid = true;

  if (MARCH) {
    // camera -> march frame (z shift only: unrotated camera), apply the
    // chief deltas, back to the camera frame
    f.t_m = (m.dze - pt.z_march) / d.z;
    p.x = add_rn(add_rn(p.x, mul_rn(d.x, f.t_m)), m.dpx);
    p.y = add_rn(add_rn(p.y, mul_rn(d.y, f.t_m)), m.dpy);
    f.o_m = {d.x + m.ddx, d.y + m.ddy, d.z + m.ddz};
    f.inv_m = rsq(dot3_rn(f.o_m, f.o_m));
    d = scale_rn(f.o_m, f.inv_m);
    p.z = pt.z_exit;
  }
  f.p0 = p;
  f.d0 = d;

  float ix, iy;
  if (LENS == LENS_APPARENT) {
    const V3 rd = {-d.x, -d.y, -d.z};
    f.t_s = (c.z_object - p.z) / rd.z;
    ix = mul_rn(-add_rn(p.x, mul_rn(rd.x, f.t_s)), c.magnification);
    iy = mul_rn(-add_rn(p.y, mul_rn(rd.y, f.t_s)), c.magnification);
    f.pl = p;
    f.dl = d;
    f.fd = rd;
  } else {
    if (LENS == LENS_THIN) {
      f.t_l = (c.z_lens - p.z) / d.z;
      const float hx = add_rn(p.x, mul_rn(d.x, f.t_l));
      const float hy = add_rn(p.y, mul_rn(d.y, f.t_l));
      f.valid = add_rn(mul_rn(hx, hx), mul_rn(hy, hy)) <= c.half_pitch_sq;
      f.o_thin = {
          add_rn(div_rn_by(-hx, c.focal_length, c.inv_focal_length), d.x),
          add_rn(div_rn_by(-hy, c.focal_length, c.inv_focal_length), d.y),
          d.z};
      f.inv_thin = rsq(dot3_rn(f.o_thin, f.o_thin));
      p = {hx, hy, c.z_lens};
      d = scale_rn(f.o_thin, f.inv_thin);
    } else {
      // front surface
      bool hit;
      float t = sphere_t(p, d, c.czf, c.r_front, hit);
      p = along_rn(p, d, t);
      f.valid = hit && add_rn(mul_rn(p.x, p.x), mul_rn(p.y, p.y)) <=
                           c.half_pitch_sq;
      f.h1 = p;
      const V3 n1raw = {p.x, p.y, p.z - c.czf};
      f.invn1 = rsq(dot3_rn(n1raw, n1raw));
      f.n1 = scale_rn(n1raw, f.invn1);
      Refraction r = refract(d, f.n1, c.inv_n_lens);
      f.inv_r1 = r.inv;
      d = scale_rn(r.o, r.inv);
      f.valid = f.valid && r.ok;
      f.d1 = d;
      // back surface
      t = sphere_t(p, d, c.czb, c.r_back, hit);
      p = along_rn(p, d, t);
      f.valid = f.valid && hit &&
                add_rn(mul_rn(p.x, p.x), mul_rn(p.y, p.y)) <= c.half_pitch_sq;
      const V3 n2raw = {-p.x, -p.y, -(p.z - c.czb)};
      f.invn2 = rsq(dot3_rn(n2raw, n2raw));
      f.n2 = scale_rn(n2raw, f.invn2);
      r = refract(d, f.n2, c.n_lens);
      f.inv_r2 = r.inv;
      d = scale_rn(r.o, r.inv);
      f.valid = f.valid && r.ok;
    }
    f.pl = p;
    f.dl = d;
    f.t_s = (c.z_sensor - p.z) / d.z;
    ix = add_rn(p.x, mul_rn(d.x, f.t_s));
    iy = add_rn(p.y, mul_rn(d.y, f.t_s));
    f.fd = d;
  }

  f.d_x = div_rn_by(sub_rn(ix, c.pixel_1_x), c.pixel_pitch,
                    c.inv_pixel_pitch);
  if (mirror_x) f.d_x = c.nx_m1 - f.d_x;
  f.d_y = div_rn_by(sub_rn(iy, c.pixel_1_y), c.pixel_pitch,
                    c.inv_pixel_pitch);
  const bool on_sensor = (f.d_x >= 0.0f) && (f.d_x < c.nx_f) &&
                         (f.d_y >= 0.0f) && (f.d_y < c.ny_f);
  f.valid = f.valid && on_sensor;
  return f;
}

// cos^2 of the angle to the optical axis, and q = |fd|^2
__device__ __forceinline__ float cos2_of(const V3& fd, float& q) {
  q = dot3_rn(fd, fd);
  return mul_rn(fd.z, fd.z) / q;
}

}  // namespace

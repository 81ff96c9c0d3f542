// Backward of the per-particle ray-fan statistics: cotangents of the ten
// per-particle columns
//   [xs, ys, zs, amp0, dz_exit, dpx, dpy, ddx, ddy, ddz]
// from (ct_A, ct_AX, ct_AY).
//
// photon_fan_stats_bwd replaces the TPU kernel
// photon_tpu/ops/fan_pallas.py::_fan_bwd_kernel, which runs jax.vjp of the
// tile function in fast memory.  Here the chain is reversed by hand: one
// block owns one particle as in the forward (fan_stats.cu), each thread
// recomputes the forward for its ray with the stage inputs kept in
// registers, sweeps back through sensor, lens, march deltas and ray
// generation, and adds into ten per-thread sums that the block reduces with
// shuffles.  No atomics and no (P, R) array, so the result is the same from
// run to run.  Masks pass no gradient: a culled ray is skipped, so it
// contributes exactly zero.  The lens rows x_lens / y_lens get no cotangent.
//
// What bounds it on an H100: f32 operations, some 600 a (particle, ray) pair
// for the thick lens with the march deltas, two thirds of them the backward
// sweep.  This file is built with FMA contraction, which the forward's file
// is not (kernels.py), and the sweep contracts; what must round as the plain
// version rounds is written with intrinsics.  (1) The forward recomputation
// is fan_path of fan_common.cuh, the forward kernel's own, bit for bit: the
// thick lens's discriminant turns an ulp of a ray into a shift on the sensor.
// (2) The discriminant's cotangent 2 beta d_beta - 4 d_gamma and what it
// passes to the ray (sphere_hit_bwd) cancel like the discriminant.  (3) The
// amplitude's cotangent ct_A + ct_AX X + ct_AY Y and its sum over the rays
// cancel for a centroid loss (scaling a particle's amplitude moves no
// centroid).  Beside contraction: no division by a launch constant (the
// reciprocals of the pixel pitch and the focal length come from the host,
// formed in float64, FanBwdConst), one reciprocal for each per-ray divisor
// (a direction's z at a plane, |fd|^2), the inverse norms of the forward kept
// instead of formed again, and 1 / s beside rsq(s) as rsq(s)^3.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include "fan_common.cuh"

namespace {

// the forward's constants and the reciprocals of those the backward divides
// by (formed in float64 on the host, rounded once to f32)
struct FanBwdConst {
  FanConst c;
  float inv_pixel_pitch, inv_focal_length;
};
constexpr int kFanBwdConstFloats = sizeof(FanBwdConst) / sizeof(float);

__device__ __forceinline__ float dot3(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ void add_scaled(V3& acc, float c, const V3& v) {
  acc.x += c * v.x;
  acc.y += c * v.y;
  acc.z += c * v.z;
}

// out = o * inv, inv = 1 / |o| (as the forward formed it): adds the
// cotangent of o
__device__ __forceinline__ void normalize_bwd(const V3& o, float inv,
                                              const V3& g_out, V3& g_o) {
  float g_s = -0.5f * dot3(o, g_out) * (inv * inv * inv);
  g_o.x += inv * g_out.x + 2.0f * o.x * g_s;
  g_o.y += inv * g_out.y + 2.0f * o.y * g_s;
  g_o.z += inv * g_out.z + 2.0f * o.z * g_s;
}

// backward of refract(): incoming unit direction d, unit normal n, `inv` the
// forward's 1 / |o|; adds the cotangents of d and n
__device__ __forceinline__ void refract_bwd(const V3& d, const V3& n,
                                            float ratio, float inv,
                                            const V3& g_out, V3& g_d,
                                            V3& g_n) {
  float cos_i = -dot3(d, n);
  float radicand = 1.0f - ratio * ratio * (1.0f - cos_i * cos_i);
  float sq = sqrtf(fmaxf(radicand, 0.0f));
  float k = ratio * cos_i - sq;
  V3 o = {d.x * ratio + k * n.x, d.y * ratio + k * n.y,
          d.z * ratio + k * n.z};
  V3 g_o = {0.0f, 0.0f, 0.0f};
  normalize_bwd(o, inv, g_out, g_o);
  add_scaled(g_d, ratio, g_o);
  add_scaled(g_n, k, g_o);
  float g_k = dot3(n, g_o);
  float g_rad = sq > 0.0f ? -g_k * 0.5f / sq : 0.0f;
  float g_cos = ratio * g_k + g_rad * (ratio * ratio) * 2.0f * cos_i;
  add_scaled(g_d, -g_cos, n);
  add_scaled(g_n, -g_cos, d);
}

// acc += c * v, one rounding for the product and one for each sum
__device__ __forceinline__ void add_scaled_rn(V3& acc, float c, const V3& v) {
  acc = {add_rn(acc.x, mul_rn(c, v.x)), add_rn(acc.y, mul_rn(c, v.y)),
         add_rn(acc.z, mul_rn(c, v.z))};
}

// backward of the sphere intersection (fan_path): ray (p, d) before the hit;
// adds the cotangents of p and d.  The discriminant's cotangent
// 2 beta d_beta - 4 d_gamma cancels like the discriminant: o, beta, gamma,
// disc and every term they pass to p and d round one operation at a time, as
// in the plain version's autograd.
__device__ __forceinline__ void sphere_hit_bwd(const V3& p, const V3& d,
                                               float cz, float radius,
                                               const V3& g_h, V3& g_p,
                                               V3& g_d) {
  const SphereTerms s = sphere_terms(p, d, cz, radius);
  const V3& o = s.o;
  float sq = sqrtf(fmaxf(s.disc, 0.0f));
  float t = radius > 0.0f ? (-s.beta - sq) / 2.0f : (-s.beta + sq) / 2.0f;
  add_scaled_rn(g_p, 1.0f, g_h);
  add_scaled_rn(g_d, t, g_h);
  float g_t = dot3_rn(g_h, d);
  float g_sq = radius > 0.0f ? -g_t / 2.0f : g_t / 2.0f;
  float g_disc = sq > 0.0f ? g_sq * 0.5f / sq : 0.0f;
  float g_beta = add_rn(-g_t / 2.0f, mul_rn(2.0f, mul_rn(g_disc, s.beta)));
  float g_gamma = -4.0f * g_disc;
  float g_dot = 2.0f * g_beta;
  add_scaled_rn(g_d, g_dot, o);
  const float g2 = 2.0f * g_gamma;
  const V3 g_o = {add_rn(mul_rn(g_dot, d.x), mul_rn(g2, o.x)),
                  add_rn(mul_rn(g_dot, d.y), mul_rn(g2, o.y)),
                  add_rn(mul_rn(g_dot, d.z), mul_rn(g2, o.z))};
  add_scaled_rn(g_p, 1.0f, g_o);
}

constexpr int kFanCols = 10;

template <int LENS, bool MARCH>
__global__ void fan_stats_bwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, const float* __restrict__ amp0,
    const float* __restrict__ dze, const float* __restrict__ dpx,
    const float* __restrict__ dpy, const float* __restrict__ ddx,
    const float* __restrict__ ddy, const float* __restrict__ ddz,
    const float* __restrict__ x_lens, const float* __restrict__ y_lens,
    const float* __restrict__ ct, float* __restrict__ d_cols, long long P,
    int R, FanBwdConst kc, int mirror_x) {
  const FanConst& c = kc.c;
  const long long p = blockIdx.x;
  const Particle pt = load_particle<MARCH>(c, p, xs, ys, zs, dze, dpx, dpy,
                                           ddx, ddy, ddz);
  const float a0 = amp0[p];
  const float cA = ct[p], cAX = ct[P + p], cAY = ct[2 * P + p];
  const float inv_denom = pt.inv_denom;

  float acc[kFanCols];
#pragma unroll
  for (int j = 0; j < kFanCols; ++j) acc[j] = 0.0f;

  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    // ---- forward, as the forward kernel computes it -------------------
    const FanPath f = fan_path<LENS, MARCH>(c, pt, __ldg(x_lens + r),
                                            __ldg(y_lens + r), mirror_x);
    if (!f.valid) continue;          // a culled ray contributes exactly zero
    float q;
    const float cos2 = cos2_of(f.fd, q);
    const float inv_q = 1.0f / q;
    const float amp = a0 * cos2 * cos2;
    const float X = f.d_x - 0.5f, Y = f.d_y - 0.5f;

    // ---- backward -----------------------------------------------------
    // the amplitude's cotangent and its sum cancel: one rounding at a time
    const float g_amp = add_rn(add_rn(cA, mul_rn(cAX, X)), mul_rn(cAY, Y));
    acc[3] = add_rn(acc[3], mul_rn(g_amp, mul_rn(cos2, cos2)));
    const float g_cos2 = g_amp * a0 * 2.0f * cos2;
    const float g_q = -g_cos2 * cos2 * inv_q;
    const V3& fd = f.fd;
    V3 g_fd = {2.0f * fd.x * g_q, 2.0f * fd.y * g_q,
               g_cos2 * 2.0f * fd.z * inv_q + 2.0f * fd.z * g_q};
    const float g_X = cAX * amp, g_Y = cAY * amp;
    const float g_ix = (mirror_x ? -g_X : g_X) * kc.inv_pixel_pitch;
    const float g_iy = g_Y * kc.inv_pixel_pitch;
    const V3& d0 = f.d0;

    V3 g_p, g_d;                     // cotangent of the ray entering the lens
    if (LENS == LENS_APPARENT) {
      const V3& rd = f.fd;           // = -d0
      const float inv_rdz = 1.0f / rd.z;
      float g_hx = -c.magnification * g_ix, g_hy = -c.magnification * g_iy;
      float g_t = g_hx * rd.x + g_hy * rd.y;
      V3 g_rd = {g_fd.x + g_hx * f.t_s, g_fd.y + g_hy * f.t_s,
                 g_fd.z - g_t * f.t_s * inv_rdz};
      g_p = {g_hx, g_hy, -g_t * inv_rdz};
      g_d = {-g_rd.x, -g_rd.y, -g_rd.z};
    } else {
      // sensor intersection: (f.pl, f.dl) leave the lens
      const float inv_dz = 1.0f / f.dl.z;
      float g_t = g_ix * f.dl.x + g_iy * f.dl.y;
      V3 g_pl = {g_ix, g_iy, -g_t * inv_dz};
      V3 g_dl = {g_fd.x + g_ix * f.t_s, g_fd.y + g_iy * f.t_s,
                 g_fd.z - g_t * f.t_s * inv_dz};
      if (LENS == LENS_THIN) {
        const float inv_d0z = 1.0f / d0.z;
        V3 g_o = {0.0f, 0.0f, 0.0f};
        normalize_bwd(f.o_thin, f.inv_thin, g_dl, g_o);
        float g_hx = g_pl.x - g_o.x * kc.inv_focal_length;
        float g_hy = g_pl.y - g_o.y * kc.inv_focal_length;
        float g_tl = g_hx * d0.x + g_hy * d0.y;
        g_p = {g_hx, g_hy, -g_tl * inv_d0z};
        g_d = {g_o.x + g_hx * f.t_l, g_o.y + g_hy * f.t_l,
               g_o.z - g_tl * f.t_l * inv_d0z};
      } else {
        const V3& h2 = f.pl;
        // back surface: refraction at n2 = -(h2 - centre) / |.|
        V3 n2raw = {-h2.x, -h2.y, -(h2.z - c.czb)};
        V3 g_d1 = {0.0f, 0.0f, 0.0f}, g_n2 = {0.0f, 0.0f, 0.0f};
        refract_bwd(f.d1, f.n2, c.n_lens, f.inv_r2, g_dl, g_d1, g_n2);
        V3 g_n2raw = {0.0f, 0.0f, 0.0f};
        normalize_bwd(n2raw, f.invn2, g_n2, g_n2raw);
        V3 g_h2 = {g_pl.x - g_n2raw.x, g_pl.y - g_n2raw.y,
                   g_pl.z - g_n2raw.z};
        V3 g_h1 = {0.0f, 0.0f, 0.0f};
        sphere_hit_bwd(f.h1, f.d1, c.czb, c.r_back, g_h2, g_h1, g_d1);
        // front surface: refraction at n1 = (h1 - centre) / |.|
        V3 n1raw = {f.h1.x, f.h1.y, f.h1.z - c.czf};
        V3 g_n1 = {0.0f, 0.0f, 0.0f};
        g_d = {0.0f, 0.0f, 0.0f};
        refract_bwd(d0, f.n1, c.inv_n_lens, f.inv_r1, g_d1, g_d, g_n1);
        normalize_bwd(n1raw, f.invn1, g_n1, g_h1);
        g_p = {0.0f, 0.0f, 0.0f};
        sphere_hit_bwd(f.p0, d0, c.czf, c.r_front, g_h1, g_p, g_d);
      }
    }

    if (MARCH) {
      // d0 = o_m / |o_m|, o_m = dg + dd; p0 = p + dg t_m + dpos;
      // p0.z = dze + shift
      const float inv_dgz = -1.0f / f.inv;          // 1 / dg.z
      V3 g_o = {0.0f, 0.0f, 0.0f};
      normalize_bwd(f.o_m, f.inv_m, g_d, g_o);
      acc[7] += g_o.x;
      acc[8] += g_o.y;
      acc[9] += g_o.z;
      acc[5] += g_p.x;
      acc[6] += g_p.y;
      float g_t = (g_p.x * f.tx + g_p.y * f.ty) * f.inv;
      acc[4] += g_p.z + g_t * inv_dgz;
      g_d = {g_o.x + g_p.x * f.t_m, g_o.y + g_p.y * f.t_m,
             g_o.z - g_t * f.t_m * inv_dgz};
      g_p.z = -g_t * inv_dgz;
    }

    // ray generation: p = (x0, y0, z0), dg = (tx, ty, -1) inv
    const float tx = f.tx, ty = f.ty, inv = f.inv;
    acc[0] += g_p.x;
    acc[1] += g_p.y;
    acc[2] += g_p.z;
    float g_s = -0.5f * (g_d.x * tx + g_d.y * ty - g_d.z) * (inv * inv * inv);
    float g_tx = g_d.x * inv + 2.0f * tx * g_s;
    float g_ty = g_d.y * inv + 2.0f * ty * g_s;
    acc[0] += g_tx * inv_denom;
    acc[1] += g_ty * inv_denom;
    acc[2] += (g_tx * tx + g_ty * ty) * inv_denom;
  }

  // block reduction: shuffles inside a warp, shared memory across warps
#pragma unroll
  for (int j = 0; j < kFanCols; ++j)
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  __shared__ float red[kFanCols][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kFanCols; ++j) red[j][warp] = acc[j];
  }
  __syncthreads();
  if (threadIdx.x < kFanCols) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float v = 0.0f;
    for (int w = 0; w < nwarps; ++w) v += red[threadIdx.x][w];
    d_cols[(long long)threadIdx.x * P + p] = v;
  }
}

}  // namespace

// consts: host array of photon_fan_bwd_const_floats() floats in FanBwdConst
// order.  ct: (3, P) cotangents of A, AX, AY.  d_cols: (10, P) rows
// [xs, ys, zs, amp0, dz_exit, dpx, dpy, ddx, ddy, ddz]; the six delta rows
// are zero when has_march is 0.  Returns cudaGetLastError() after the launch.
extern "C" int photon_fan_bwd_const_floats() { return kFanBwdConstFloats; }

extern "C" int photon_fan_stats_bwd(
    const float* xs, const float* ys, const float* zs, const float* amp0,
    const float* dze, const float* dpx, const float* dpy, const float* ddx,
    const float* ddy, const float* ddz, const float* x_lens,
    const float* y_lens, const float* ct, float* d_cols, long long P, int R,
    const float* consts, int lens_model, int has_march, int mirror_x,
    void* stream) {
  if (P <= 0) return 0;
  FanBwdConst c;
  float* cf = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kFanBwdConstFloats; ++i) cf[i] = consts[i];
  int threads = 128;
  if (R <= 32) threads = 32;
  else if (R <= 64) threads = 64;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned blocks = (unsigned)P;
#define PHOTON_FAN_BWD_LAUNCH(L, M)                                          \
  fan_stats_bwd_kernel<L, M><<<blocks, threads, 0, st>>>(                    \
      xs, ys, zs, amp0, dze, dpx, dpy, ddx, ddy, ddz, x_lens, y_lens, ct,    \
      d_cols, P, R, c, mirror_x)
  if (has_march) {
    if (lens_model == LENS_APPARENT) PHOTON_FAN_BWD_LAUNCH(LENS_APPARENT, true);
    else if (lens_model == LENS_THIN) PHOTON_FAN_BWD_LAUNCH(LENS_THIN, true);
    else PHOTON_FAN_BWD_LAUNCH(LENS_GENERAL, true);
  } else {
    if (lens_model == LENS_APPARENT) PHOTON_FAN_BWD_LAUNCH(LENS_APPARENT, false);
    else if (lens_model == LENS_THIN) PHOTON_FAN_BWD_LAUNCH(LENS_THIN, false);
    else PHOTON_FAN_BWD_LAUNCH(LENS_GENERAL, false);
  }
#undef PHOTON_FAN_BWD_LAUNCH
  return (int)cudaGetLastError();
}

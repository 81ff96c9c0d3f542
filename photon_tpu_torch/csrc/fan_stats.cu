// Per-particle ray-fan statistics, forward and backward.
//
// photon_fan_stats replaces the TPU kernel
// photon_tpu/ops/fan_pallas.py::_fan_fwd_kernel (tile math _fan_tile);
// photon_fan_stats_bwd, at the end of this file, replaces ::_fan_bwd_kernel.  For every (particle, ray): generate the ray toward its
// lens-aperture sample, apply the chief-ray march deltas, run the apparent /
// thin / thick biconvex lens, intersect the sensor (x mirrored on the
// diffraction path), mask rays that leave the aperture or the sensor, weigh
// by cos^4; per particle
//   A = sum amp,  AX = sum amp * X,  AY = sum amp * Y      (X = d_x - 0.5).
//
// What bounds it on an H100: operations.  Inputs are ten floats a particle
// and two floats a ray (shared by all particles), outputs three floats a
// particle, while every (particle, ray) pair costs a few hundred f32
// operations with several square roots and divisions.  No (P, R) array ever
// exists.  One block owns one particle: its threads stride over the R rays
// with partial sums in registers, then reduce with warp shuffles and one
// shared-memory step and store once.  There are no atomics, so the result is
// the same from run to run.  The block index is the particle and the ray loop
// is 32-bit, so P * R is never formed (it is 5e7 on the BOS path and larger
// elsewhere).  The kernel masks its own ragged edge: no ray_mask row and no
// padding.
//
// Reciprocal square roots are 1.0f / sqrtf(x) (correctly rounded), the same
// as the plain PyTorch version beside the wrapper.  Build this file with
// -fmad=false (kernels.py does): the thick lens's discriminant cancels from
// 1e16 down to ~1e9 in f32, and with products contracted into FMAs the ray
// centroids land ~0.03 px away from the plain version's.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include <cuda_runtime.h>

namespace {

// host-precomputed scalars (formed in float64, rounded once to f32)
struct FanConst {
  float image_distance, shift, z_object, magnification;
  float z_lens, half_pitch_sq, focal_length;
  float czf, r_front, czb, r_back, n_lens, inv_n_lens;
  float z_sensor, pixel_pitch, pixel_1_x, pixel_1_y;
  float nx_f, ny_f, nx_m1;
};
constexpr int kFanConstFloats = sizeof(FanConst) / sizeof(float);

enum { LENS_APPARENT = 0, LENS_THIN = 1, LENS_GENERAL = 2 };

struct Ray {
  float px, py, pz, dx, dy, dz;
};

__device__ __forceinline__ float rsq(float v) { return 1.0f / sqrtf(v); }

// Snell refraction at unit normal n, index ratio `ratio`; false on total
// internal reflection
__device__ __forceinline__ bool refract(Ray& r, float nx, float ny, float nz,
                                        float ratio) {
  float cos_i = -(r.dx * nx + r.dy * ny + r.dz * nz);
  float radicand = 1.0f - ratio * ratio * (1.0f - cos_i * cos_i);
  float k = ratio * cos_i - sqrtf(fmaxf(radicand, 0.0f));
  float ox = r.dx * ratio + k * nx;
  float oy = r.dy * ratio + k * ny;
  float oz = r.dz * ratio + k * nz;
  float inv = rsq(ox * ox + oy * oy + oz * oz);
  r.dx = ox * inv;
  r.dy = oy * inv;
  r.dz = oz * inv;
  return !(radicand < 0.0f);
}

// first intersection with the sphere centred (0, 0, cz); moves the ray's
// point onto it; false on a miss
__device__ __forceinline__ bool sphere_hit(Ray& r, float cz, float radius) {
  float ox = r.px, oy = r.py, oz = r.pz - cz;
  float beta = 2.0f * (r.dx * ox + r.dy * oy + r.dz * oz);
  float gamma = ox * ox + oy * oy + oz * oz - radius * radius;
  float disc = beta * beta - 4.0f * gamma;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t1 = (-beta + sq) / 2.0f;
  float t2 = (-beta - sq) / 2.0f;
  float t = radius > 0.0f ? fminf(t1, t2) : fmaxf(t1, t2);
  r.px = r.px + r.dx * t;
  r.py = r.py + r.dy * t;
  r.pz = r.pz + r.dz * t;
  return !(disc < 0.0f);
}

template <int LENS, bool MARCH>
__global__ void fan_stats_kernel(
    const float* __restrict__ xs, const float* __restrict__ ys,
    const float* __restrict__ zs, const float* __restrict__ amp0,
    const float* __restrict__ dze, const float* __restrict__ dpx,
    const float* __restrict__ dpy, const float* __restrict__ ddx,
    const float* __restrict__ ddy, const float* __restrict__ ddz,
    const float* __restrict__ x_lens, const float* __restrict__ y_lens,
    float* __restrict__ out, long long P, int R, FanConst c, int mirror_x) {
  const long long p = blockIdx.x;
  const float x0 = xs[p], y0 = ys[p], z0 = zs[p], a0 = amp0[p];
  float m_dze = 0.f, m_dpx = 0.f, m_dpy = 0.f, m_ddx = 0.f, m_ddy = 0.f,
        m_ddz = 0.f;
  if (MARCH) {
    m_dze = dze[p]; m_dpx = dpx[p]; m_dpy = dpy[p];
    m_ddx = ddx[p]; m_ddy = ddy[p]; m_ddz = ddz[p];
  }
  const float denom = c.image_distance - z0;

  float sA = 0.0f, sAX = 0.0f, sAY = 0.0f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float tx = -(__ldg(x_lens + r) - x0) / denom;
    float ty = -(__ldg(y_lens + r) - y0) / denom;
    float inv = rsq(tx * tx + ty * ty + 1.0f);
    Ray ray = {x0, y0, z0, tx * inv, ty * inv, -inv};
    bool valid = true;

    if (MARCH) {
      // camera -> march frame (z shift only: unrotated camera), apply the
      // chief deltas, back to the camera frame
      float pzw = ray.pz - c.shift;
      float t = (m_dze - pzw) / ray.dz;
      ray.px = ray.px + ray.dx * t + m_dpx;
      ray.py = ray.py + ray.dy * t + m_dpy;
      float ox = ray.dx + m_ddx, oy = ray.dy + m_ddy, oz = ray.dz + m_ddz;
      float inv2 = rsq(ox * ox + oy * oy + oz * oz);
      ray.dx = ox * inv2;
      ray.dy = oy * inv2;
      ray.dz = oz * inv2;
      ray.pz = m_dze + c.shift;
    }

    float ix, iy, fdx, fdy, fdz;
    if (LENS == LENS_APPARENT) {
      float rdx = -ray.dx, rdy = -ray.dy, rdz = -ray.dz;
      float t = (c.z_object - ray.pz) / rdz;
      float hx = ray.px + rdx * t;
      float hy = ray.py + rdy * t;
      ix = -hx * c.magnification;
      iy = -hy * c.magnification;
      fdx = rdx; fdy = rdy; fdz = rdz;
    } else {
      if (LENS == LENS_THIN) {
        float t = (c.z_lens - ray.pz) / ray.dz;
        float hx = ray.px + ray.dx * t, hy = ray.py + ray.dy * t;
        valid = valid && (hx * hx + hy * hy <= c.half_pitch_sq);
        float ox = -hx / c.focal_length + ray.dx;
        float oy = -hy / c.focal_length + ray.dy;
        float oz = ray.dz;
        float inv3 = rsq(ox * ox + oy * oy + oz * oz);
        ray.px = hx; ray.py = hy; ray.pz = c.z_lens;
        ray.dx = ox * inv3; ray.dy = oy * inv3; ray.dz = oz * inv3;
      } else {
        // front surface
        bool hit = sphere_hit(ray, c.czf, c.r_front);
        valid = valid && hit &&
                (ray.px * ray.px + ray.py * ray.py <= c.half_pitch_sq);
        float nx = ray.px, ny = ray.py, nz = ray.pz - c.czf;
        float invn = rsq(nx * nx + ny * ny + nz * nz);
        bool ok = refract(ray, nx * invn, ny * invn, nz * invn, c.inv_n_lens);
        valid = valid && ok;
        // back surface
        hit = sphere_hit(ray, c.czb, c.r_back);
        valid = valid && hit &&
                (ray.px * ray.px + ray.py * ray.py <= c.half_pitch_sq);
        nx = -ray.px; ny = -ray.py; nz = -(ray.pz - c.czb);
        invn = rsq(nx * nx + ny * ny + nz * nz);
        ok = refract(ray, nx * invn, ny * invn, nz * invn, c.n_lens);
        valid = valid && ok;
      }
      float t = (c.z_sensor - ray.pz) / ray.dz;
      ix = ray.px + ray.dx * t;
      iy = ray.py + ray.dy * t;
      fdx = ray.dx; fdy = ray.dy; fdz = ray.dz;
    }

    float d_x = (ix - c.pixel_1_x) / c.pixel_pitch;
    if (mirror_x) d_x = c.nx_m1 - d_x;
    float d_y = (iy - c.pixel_1_y) / c.pixel_pitch;
    bool on_sensor =
        (d_x >= 0.0f) && (d_x < c.nx_f) && (d_y >= 0.0f) && (d_y < c.ny_f);
    valid = valid && on_sensor;

    float cos2 = (fdz * fdz) / (fdx * fdx + fdy * fdy + fdz * fdz);
    // amp, X and Y of a culled ray are zeroed under the same mask, so that
    // 0 * inf never reaches the sums
    float amp = valid ? a0 * cos2 * cos2 : 0.0f;
    float X = valid ? d_x - 0.5f : 0.0f;
    float Y = valid ? d_y - 0.5f : 0.0f;
    sA += amp;
    sAX += amp * X;
    sAY += amp * Y;
  }

  // block reduction: shuffles inside a warp, shared memory across warps
  for (int off = 16; off > 0; off >>= 1) {
    sA += __shfl_down_sync(0xffffffffu, sA, off);
    sAX += __shfl_down_sync(0xffffffffu, sAX, off);
    sAY += __shfl_down_sync(0xffffffffu, sAY, off);
  }
  __shared__ float red[3][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = sA;
    red[1][warp] = sAX;
    red[2][warp] = sAY;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float a = 0.0f, ax = 0.0f, ay = 0.0f;
    for (int w = 0; w < nwarps; ++w) {
      a += red[0][w];
      ax += red[1][w];
      ay += red[2][w];
    }
    out[p] = a;
    out[P + p] = ax;
    out[2 * P + p] = ay;
  }
}

// ---------------------------------------------------------------------------
// Backward: cotangents of the ten per-particle columns
//   [xs, ys, zs, amp0, dz_exit, dpx, dpy, ddx, ddy, ddz]
// from (ct_A, ct_AX, ct_AY).
//
// The TPU kernel runs jax.vjp of the tile function in fast memory.  Here the
// chain is reversed by hand: one block owns one particle as in the forward,
// each thread recomputes the forward for its ray with the stage inputs kept
// in registers, sweeps back through sensor, lens, march deltas and ray
// generation, and adds into ten per-thread sums that the block reduces with
// shuffles.  No atomics and no (P, R) array, so the result is the same from
// run to run.  Bound by operations, like the forward (about three times its
// count).  Masks pass no gradient: a culled ray is skipped, so it contributes
// exactly zero.  The lens rows x_lens / y_lens get no cotangent.  Every
// product and sum is formed as autograd forms it through the plain version
// (no algebraic shortcuts), because the discriminant's cotangent
// 2 beta d_beta - 4 d_gamma cancels like the discriminant itself.
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ void add_scaled(V3& acc, float c, const V3& v) {
  acc.x += c * v.x;
  acc.y += c * v.y;
  acc.z += c * v.z;
}

// out = o / |o|: adds the cotangent of o
__device__ __forceinline__ void normalize_bwd(const V3& o, const V3& g_out,
                                              V3& g_o) {
  float s = dot3(o, o);
  float inv = rsq(s);
  float g_s = -0.5f * dot3(o, g_out) * inv / s;
  g_o.x += inv * g_out.x + 2.0f * o.x * g_s;
  g_o.y += inv * g_out.y + 2.0f * o.y * g_s;
  g_o.z += inv * g_out.z + 2.0f * o.z * g_s;
}

// backward of refract(): incoming unit direction d, unit normal n; adds the
// cotangents of d and n
__device__ __forceinline__ void refract_bwd(const V3& d, const V3& n,
                                            float ratio, const V3& g_out,
                                            V3& g_d, V3& g_n) {
  float cos_i = -dot3(d, n);
  float radicand = 1.0f - ratio * ratio * (1.0f - cos_i * cos_i);
  float sq = sqrtf(fmaxf(radicand, 0.0f));
  float k = ratio * cos_i - sq;
  V3 o = {d.x * ratio + k * n.x, d.y * ratio + k * n.y,
          d.z * ratio + k * n.z};
  V3 g_o = {0.0f, 0.0f, 0.0f};
  normalize_bwd(o, g_out, g_o);
  add_scaled(g_d, ratio, g_o);
  add_scaled(g_n, k, g_o);
  float g_k = dot3(n, g_o);
  float g_rad = sq > 0.0f ? -g_k * 0.5f / sq : 0.0f;
  float g_cos = ratio * g_k + g_rad * (ratio * ratio) * 2.0f * cos_i;
  add_scaled(g_d, -g_cos, n);
  add_scaled(g_n, -g_cos, d);
}

// backward of sphere_hit(): ray (p, d) before the hit; adds the cotangents
// of p and d
__device__ __forceinline__ void sphere_hit_bwd(const V3& p, const V3& d,
                                               float cz, float radius,
                                               const V3& g_h, V3& g_p,
                                               V3& g_d) {
  V3 o = {p.x, p.y, p.z - cz};
  float beta = 2.0f * dot3(d, o);
  float gamma = dot3(o, o) - radius * radius;
  float disc = beta * beta - 4.0f * gamma;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t = radius > 0.0f ? (-beta - sq) / 2.0f : (-beta + sq) / 2.0f;
  add_scaled(g_p, 1.0f, g_h);
  add_scaled(g_d, t, g_h);
  float g_t = dot3(g_h, d);
  float g_sq = radius > 0.0f ? -g_t / 2.0f : g_t / 2.0f;
  float g_disc = sq > 0.0f ? g_sq * 0.5f / sq : 0.0f;
  float g_beta = -g_t / 2.0f + 2.0f * (g_disc * beta);
  float g_gamma = -4.0f * g_disc;
  float g_dot = 2.0f * g_beta;
  add_scaled(g_d, g_dot, o);
  V3 g_o = {g_dot * d.x + 2.0f * (g_gamma * o.x),
            g_dot * d.y + 2.0f * (g_gamma * o.y),
            g_dot * d.z + 2.0f * (g_gamma * o.z)};
  add_scaled(g_p, 1.0f, g_o);
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
    int R, FanConst c, int mirror_x) {
  const long long p = blockIdx.x;
  const float x0 = xs[p], y0 = ys[p], z0 = zs[p], a0 = amp0[p];
  float m_dze = 0.f, m_dpx = 0.f, m_dpy = 0.f, m_ddx = 0.f, m_ddy = 0.f,
        m_ddz = 0.f;
  if (MARCH) {
    m_dze = dze[p]; m_dpx = dpx[p]; m_dpy = dpy[p];
    m_ddx = ddx[p]; m_ddy = ddy[p]; m_ddz = ddz[p];
  }
  const float cA = ct[p], cAX = ct[P + p], cAY = ct[2 * P + p];
  const float denom = c.image_distance - z0;

  float acc[kFanCols];
#pragma unroll
  for (int j = 0; j < kFanCols; ++j) acc[j] = 0.0f;

  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    // ---- forward, keeping each stage's inputs -------------------------
    const float tx = -(__ldg(x_lens + r) - x0) / denom;
    const float ty = -(__ldg(y_lens + r) - y0) / denom;
    const float inv = rsq(tx * tx + ty * ty + 1.0f);
    const V3 dg = {tx * inv, ty * inv, -inv};       // generated direction
    Ray ray = {x0, y0, z0, dg.x, dg.y, dg.z};
    bool valid = true;

    float t_m = 0.0f;
    V3 o_m = {0.0f, 0.0f, 0.0f};
    if (MARCH) {
      float pzw = ray.pz - c.shift;
      t_m = (m_dze - pzw) / ray.dz;
      ray.px = ray.px + ray.dx * t_m + m_dpx;
      ray.py = ray.py + ray.dy * t_m + m_dpy;
      o_m = {ray.dx + m_ddx, ray.dy + m_ddy, ray.dz + m_ddz};
      float inv2 = rsq(dot3(o_m, o_m));
      ray.dx = o_m.x * inv2;
      ray.dy = o_m.y * inv2;
      ray.dz = o_m.z * inv2;
      ray.pz = m_dze + c.shift;
    }
    const V3 p0 = {ray.px, ray.py, ray.pz};          // entering the lens
    const V3 d0 = {ray.dx, ray.dy, ray.dz};

    float ix, iy, fdx, fdy, fdz, t_s = 0.0f;
    V3 h1 = p0, d1 = d0, o_thin = d0;                // lens saves
    float t_l = 0.0f;
    if (LENS == LENS_APPARENT) {
      float rdx = -ray.dx, rdy = -ray.dy, rdz = -ray.dz;
      t_s = (c.z_object - ray.pz) / rdz;
      float hx = ray.px + rdx * t_s;
      float hy = ray.py + rdy * t_s;
      ix = -hx * c.magnification;
      iy = -hy * c.magnification;
      fdx = rdx; fdy = rdy; fdz = rdz;
    } else {
      if (LENS == LENS_THIN) {
        t_l = (c.z_lens - ray.pz) / ray.dz;
        float hx = ray.px + ray.dx * t_l, hy = ray.py + ray.dy * t_l;
        valid = valid && (hx * hx + hy * hy <= c.half_pitch_sq);
        o_thin = {-hx / c.focal_length + ray.dx,
                  -hy / c.focal_length + ray.dy, ray.dz};
        float inv3 = rsq(dot3(o_thin, o_thin));
        ray.px = hx; ray.py = hy; ray.pz = c.z_lens;
        ray.dx = o_thin.x * inv3; ray.dy = o_thin.y * inv3;
        ray.dz = o_thin.z * inv3;
      } else {
        bool hit = sphere_hit(ray, c.czf, c.r_front);
        valid = valid && hit &&
                (ray.px * ray.px + ray.py * ray.py <= c.half_pitch_sq);
        h1 = {ray.px, ray.py, ray.pz};
        float nx = ray.px, ny = ray.py, nz = ray.pz - c.czf;
        float invn = rsq(nx * nx + ny * ny + nz * nz);
        bool ok = refract(ray, nx * invn, ny * invn, nz * invn, c.inv_n_lens);
        valid = valid && ok;
        d1 = {ray.dx, ray.dy, ray.dz};
        hit = sphere_hit(ray, c.czb, c.r_back);
        valid = valid && hit &&
                (ray.px * ray.px + ray.py * ray.py <= c.half_pitch_sq);
        nx = -ray.px; ny = -ray.py; nz = -(ray.pz - c.czb);
        invn = rsq(nx * nx + ny * ny + nz * nz);
        ok = refract(ray, nx * invn, ny * invn, nz * invn, c.n_lens);
        valid = valid && ok;
      }
      t_s = (c.z_sensor - ray.pz) / ray.dz;
      ix = ray.px + ray.dx * t_s;
      iy = ray.py + ray.dy * t_s;
      fdx = ray.dx; fdy = ray.dy; fdz = ray.dz;
    }

    float d_x = (ix - c.pixel_1_x) / c.pixel_pitch;
    if (mirror_x) d_x = c.nx_m1 - d_x;
    float d_y = (iy - c.pixel_1_y) / c.pixel_pitch;
    bool on_sensor =
        (d_x >= 0.0f) && (d_x < c.nx_f) && (d_y >= 0.0f) && (d_y < c.ny_f);
    valid = valid && on_sensor;
    if (!valid) continue;            // a culled ray contributes exactly zero

    const float q = fdx * fdx + fdy * fdy + fdz * fdz;
    const float cos2 = (fdz * fdz) / q;
    const float amp = a0 * cos2 * cos2;
    const float X = d_x - 0.5f, Y = d_y - 0.5f;

    // ---- backward -----------------------------------------------------
    const float g_amp = cA + cAX * X + cAY * Y;
    acc[3] += g_amp * (cos2 * cos2);
    const float g_cos2 = g_amp * a0 * 2.0f * cos2;
    const float g_q = -g_cos2 * cos2 / q;
    V3 g_fd = {2.0f * fdx * g_q, 2.0f * fdy * g_q,
               g_cos2 * 2.0f * fdz / q + 2.0f * fdz * g_q};
    const float g_X = cAX * amp, g_Y = cAY * amp;
    const float g_ix = (mirror_x ? -g_X : g_X) / c.pixel_pitch;
    const float g_iy = g_Y / c.pixel_pitch;

    V3 g_p, g_d;                     // cotangent of the ray entering the lens
    if (LENS == LENS_APPARENT) {
      const V3 rd = {-d0.x, -d0.y, -d0.z};
      float g_hx = -c.magnification * g_ix, g_hy = -c.magnification * g_iy;
      float g_t = g_hx * rd.x + g_hy * rd.y;
      V3 g_rd = {g_fd.x + g_hx * t_s, g_fd.y + g_hy * t_s,
                 g_fd.z - g_t * t_s / rd.z};
      g_p = {g_hx, g_hy, -g_t / rd.z};
      g_d = {-g_rd.x, -g_rd.y, -g_rd.z};
    } else {
      // sensor intersection: (ray.p, ray.d) leave the lens
      float g_t = g_ix * ray.dx + g_iy * ray.dy;
      V3 g_pl = {g_ix, g_iy, -g_t / ray.dz};
      V3 g_dl = {g_fd.x + g_ix * t_s, g_fd.y + g_iy * t_s,
                 g_fd.z - g_t * t_s / ray.dz};
      if (LENS == LENS_THIN) {
        V3 g_o = {0.0f, 0.0f, 0.0f};
        normalize_bwd(o_thin, g_dl, g_o);
        float g_hx = g_pl.x - g_o.x / c.focal_length;
        float g_hy = g_pl.y - g_o.y / c.focal_length;
        float g_tl = g_hx * d0.x + g_hy * d0.y;
        g_p = {g_hx, g_hy, -g_tl / d0.z};
        g_d = {g_o.x + g_hx * t_l, g_o.y + g_hy * t_l,
               g_o.z - g_tl * t_l / d0.z};
      } else {
        const V3 h2 = {ray.px, ray.py, ray.pz};
        // back surface: refraction at n2 = -(h2 - centre) / |.|
        V3 n2raw = {-h2.x, -h2.y, -(h2.z - c.czb)};
        float invn2 = rsq(dot3(n2raw, n2raw));
        V3 n2 = {n2raw.x * invn2, n2raw.y * invn2, n2raw.z * invn2};
        V3 g_d1 = {0.0f, 0.0f, 0.0f}, g_n2 = {0.0f, 0.0f, 0.0f};
        refract_bwd(d1, n2, c.n_lens, g_dl, g_d1, g_n2);
        V3 g_n2raw = {0.0f, 0.0f, 0.0f};
        normalize_bwd(n2raw, g_n2, g_n2raw);
        V3 g_h2 = {g_pl.x - g_n2raw.x, g_pl.y - g_n2raw.y,
                   g_pl.z - g_n2raw.z};
        V3 g_h1 = {0.0f, 0.0f, 0.0f};
        sphere_hit_bwd(h1, d1, c.czb, c.r_back, g_h2, g_h1, g_d1);
        // front surface: refraction at n1 = (h1 - centre) / |.|
        V3 n1raw = {h1.x, h1.y, h1.z - c.czf};
        float invn1 = rsq(dot3(n1raw, n1raw));
        V3 n1 = {n1raw.x * invn1, n1raw.y * invn1, n1raw.z * invn1};
        V3 g_n1 = {0.0f, 0.0f, 0.0f};
        g_d = {0.0f, 0.0f, 0.0f};
        refract_bwd(d0, n1, c.inv_n_lens, g_d1, g_d, g_n1);
        normalize_bwd(n1raw, g_n1, g_h1);
        g_p = {0.0f, 0.0f, 0.0f};
        sphere_hit_bwd(p0, d0, c.czf, c.r_front, g_h1, g_p, g_d);
      }
    }

    if (MARCH) {
      // d0 = o_m / |o_m|, o_m = dg + dd; p0 = p + dg t_m + dpos;
      // p0.z = dze + shift
      V3 g_o = {0.0f, 0.0f, 0.0f};
      normalize_bwd(o_m, g_d, g_o);
      acc[7] += g_o.x;
      acc[8] += g_o.y;
      acc[9] += g_o.z;
      acc[5] += g_p.x;
      acc[6] += g_p.y;
      float g_t = g_p.x * dg.x + g_p.y * dg.y;
      acc[4] += g_p.z + g_t / dg.z;
      g_d = {g_o.x + g_p.x * t_m, g_o.y + g_p.y * t_m,
             g_o.z - g_t * t_m / dg.z};
      g_p.z = -g_t / dg.z;
    }

    // ray generation: p = (x0, y0, z0), dg = (tx, ty, -1) inv
    acc[0] += g_p.x;
    acc[1] += g_p.y;
    acc[2] += g_p.z;
    float s = tx * tx + ty * ty + 1.0f;
    float g_s = -0.5f * (g_d.x * tx + g_d.y * ty - g_d.z) * inv / s;
    float g_tx = g_d.x * inv + 2.0f * tx * g_s;
    float g_ty = g_d.y * inv + 2.0f * ty * g_s;
    acc[0] += g_tx / denom;
    acc[1] += g_ty / denom;
    acc[2] += (g_tx * tx + g_ty * ty) / denom;
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
  // one block a particle; threads cover the rays in a few strides
  int threads = 128;
  if (R <= 32) threads = 32;
  else if (R <= 64) threads = 64;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned blocks = (unsigned)P;
#define PHOTON_FAN_LAUNCH(L, M)                                              \
  fan_stats_kernel<L, M><<<blocks, threads, 0, st>>>(                        \
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

// ct: (3, P) cotangents of A, AX, AY.  d_cols: (10, P) rows
// [xs, ys, zs, amp0, dz_exit, dpx, dpy, ddx, ddy, ddz]; the six delta rows
// are zero when has_march is 0.
extern "C" int photon_fan_stats_bwd(
    const float* xs, const float* ys, const float* zs, const float* amp0,
    const float* dze, const float* dpx, const float* dpy, const float* ddx,
    const float* ddy, const float* ddz, const float* x_lens,
    const float* y_lens, const float* ct, float* d_cols, long long P, int R,
    const float* consts, int lens_model, int has_march, int mirror_x,
    void* stream) {
  if (P <= 0) return 0;
  FanConst c;
  float* cf = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kFanConstFloats; ++i) cf[i] = consts[i];
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

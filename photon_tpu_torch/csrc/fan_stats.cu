// Per-particle ray-fan statistics, forward.
//
// Replaces the TPU kernel photon_tpu/ops/fan_pallas.py::_fan_fwd_kernel (tile
// math _fan_tile).  For every (particle, ray): generate the ray toward its
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

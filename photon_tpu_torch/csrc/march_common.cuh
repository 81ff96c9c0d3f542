// Device functions shared by the dense march kernels: the forward march
// (march_dense.cu), its two backward kernels (march_bwd.cu) and the per-stage
// slab sampler with its backward (slab_sample.cu); the backward kernels share
// the warp-merged scatter of the field's cotangent (scatter8).
//
// Interpolation scheme 1 is trilinear; scheme 2 is the cubic B-spline in x
// and y over prefiltered coefficients, blended linearly in z (4 x 4 x 2 taps).
// Every device function that samples is a template on the scheme.
//
// The march integrates the z-parametrised eikonal ODE in Sharma's
// T = n dr/ds form,
//   d(x, y)/dz = (Tx/Tz, Ty/Tz),   dT/dz = (n/Tz) grad n,
// one step per slab, landing on
//   z_plane = max(z_min + (ks - 0.5) dz_slab, z_min),  ks = S-1-s,  S = D-1,
// and blending field[ks] (weight 1-uz) with field[ks+1] (weight uz).
#pragma once
#include <cuda_runtime.h>

#include "div_rn.cuh"

namespace {

struct MarchGeom {
  float min_x, min_y, sx, sy, z_min, z_max, dz_slab, n0;
  int W, H, D;
  // 1 / sx, 1 / sy, 1 / dz_slab, correctly rounded (make_geom): a sample's
  // coordinates divide by sx, sy, dz_slab with them (div_rn_by, the
  // division's bits, so the voxels the plain version picks), and the
  // backward kernels scale cotangents with them
  float inv_sx, inv_sy, inv_dz;
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

// Cubic B-spline kernel B3(x), support |x| < 2, and its derivative.
__device__ __forceinline__ float b3(float x) {
  float ax = fabsf(x);
  float inner = (4.0f - 6.0f * ax * ax + 3.0f * ax * ax * ax) / 6.0f;
  float t = 2.0f - ax;
  float outer = t * t * t / 6.0f;
  return ax < 1.0f ? inner : (ax < 2.0f ? outer : 0.0f);
}

__device__ __forceinline__ float b3_d(float x) {
  float ax = fabsf(x);
  float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  float inner = sgn * (-12.0f * ax + 9.0f * ax * ax) / 6.0f;
  float t = 2.0f - ax;
  float outer = -sgn * t * t / 2.0f;
  return ax < 1.0f ? inner : (ax < 2.0f ? outer : 0.0f);
}

// Cubic addressing of one axis: the coordinate is clamped into [-2, n+1],
// the four taps sit at floor(uc)-1 .. floor(uc)+2 with weight B3(uc - j), and
// every tap's index is clipped into [0, n-1].  Taps that clip onto a border
// voxel add up there: that is the border fold of the dense cubic weights
// (up to three taps a border).  `free`: the clamp let the coordinate through,
// so the weights' derivatives `d` are live.
struct CubicAxis {
  int i[4];
  float w[4], d[4];
  int j0;        // the first tap before clipping: the four i[] follow from it
  bool free;
};

template <bool DERIV>
__device__ __forceinline__ CubicAxis cubic_axis(float u, int n) {
  CubicAxis a;
  a.free = (u > -2.0f) && (u < (float)(n + 1));
  float uc = clampf(u, -2.0f, (float)(n + 1));
  int j0 = (int)floorf(uc) - 1;
  a.j0 = j0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int j = j0 + k;
    float x = uc - (float)j;
    a.w[k] = b3(x);
    a.d[k] = DERIV ? b3_d(x) : 0.0f;
    a.i[k] = min(max(j, 0), n - 1);
  }
  return a;
}

// (grad n, n-1) at voxel coordinates between slab `lo` (weight 1-uz) and
// `hi` (weight uz).  Scheme 1: the two-tap clamped fetch per axis that the
// dense hat weights max(0, 1-|clip(u,0,n-1)-i|) evaluate to.  Scheme 2: the
// four-tap clipped fetch per axis that the dense cubic weights evaluate to.
template <int SCHEME>
__device__ __forceinline__ float4 sample(const float4* __restrict__ lo,
                                         const float4* __restrict__ hi,
                                         const MarchGeom& g, float ux,
                                         float uy, float uz) {
  float wz0 = 1.0f - uz, wz1 = uz;
  float4 r;
  if constexpr (SCHEME == 2) {
    CubicAxis ax = cubic_axis<false>(ux, g.W);
    CubicAxis ay = cubic_axis<false>(uy, g.H);
    float4 sl = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sh = sl;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ay.i[j] * g.W;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float w = ay.w[j] * ax.w[i];
        float4 a = __ldg(lo + row + ax.i[i]);
        float4 b = __ldg(hi + row + ax.i[i]);
        sl.x += w * a.x; sl.y += w * a.y; sl.z += w * a.z; sl.w += w * a.w;
        sh.x += w * b.x; sh.y += w * b.y; sh.z += w * b.z; sh.w += w * b.w;
      }
    }
    r = make_float4(wz0 * sl.x + wz1 * sh.x, wz0 * sl.y + wz1 * sh.y,
                    wz0 * sl.z + wz1 * sh.z, wz0 * sl.w + wz1 * sh.w);
  } else {
    Taps t = taps(g, ux, uy);
    float4 a00 = __ldg(lo + t.o00), a01 = __ldg(lo + t.o00 + 1);
    float4 a10 = __ldg(lo + t.o10), a11 = __ldg(lo + t.o10 + 1);
    float4 b00 = __ldg(hi + t.o00), b01 = __ldg(hi + t.o00 + 1);
    float4 b10 = __ldg(hi + t.o10), b11 = __ldg(hi + t.o10 + 1);
    float wx0 = 1.0f - t.fx, wx1 = t.fx;
    float wy0 = 1.0f - t.fy, wy1 = t.fy;
    float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;
#define PHOTON_BLEND(c)                                                     \
  r.c = wz0 * (w00 * a00.c + w01 * a01.c + w10 * a10.c + w11 * a11.c) +     \
        wz1 * (w00 * b00.c + w01 * b01.c + w10 * b10.c + w11 * b11.c);
    PHOTON_BLEND(x) PHOTON_BLEND(y) PHOTON_BLEND(z) PHOTON_BLEND(w)
#undef PHOTON_BLEND
  }
  return r;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---------------------------------------------------------------------------
// The field's cotangent, merged across the warp before it goes to L2.
//
// Neighbouring rays of a dot sample the same voxels, and one 16-byte atomic a
// lane and tap serialises on those voxels in the atomic units.  Lanes whose
// samples have the same lower corner share every tap, so a sample's key is
// one integer: the clamped lower corner (scheme 1), or the two unclipped
// first tap indices packed (scheme 2, whose clipped taps follow from them).
// Lanes with one key sum their contributions in registers (a reduce-scatter
// by shuffles: lane L ends with channel L % 4 of tap L / 4) and four of them
// gather a tap's four channels for one atomic.  The groups are found by
// ballots: a version that found them with __match_any_sync read K4 and K5 at
// one time though K5 gathers three times as much (PERF.md, PR 5).
//
// Every lane of the warp calls these at the same point: the callers keep
// their slab loops uniform across the warp (no early return, no per-lane
// `continue`), and a lane with nothing to add passes live = false.  That is
// why the full mask is right here.
// ---------------------------------------------------------------------------
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxMerges = 4;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// one halving step of the reduce-scatter: keep the half of v that this
// lane's bit HALF selects, add the partner's copy of it
template <int HALF>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? v[k] : v[k + HALF];
    const float keep = upper ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(kFullMask, send, HALF);
  }
}

// For every live lane, adds val(t) (a float4) into the voxel addr(key, t),
// t = 0..7.  Groups of lanes with one key, found by probing the key of the
// lowest live lane not yet placed (a ballot, a shuffle and a ballot), sum
// their contributions and issue one 16-byte atomic a tap of non-zero sum; at
// most kMaxMerges probes a call, and a lane alone or not reached issues its
// own atomics, one a tap for which skip(t) is false.
template <class Key, class Val, class Skip, class Addr>
__device__ __forceinline__ void merged_scatter(bool live, Key key,
                                               const Val& val,
                                               const Skip& skip,
                                               const Addr& addr) {
  const int lane = lane_id();
  unsigned pending = __ballot_sync(kFullMask, live);
  bool done = !live;
#pragma unroll 1
  for (int m = 0; m < kMaxMerges && pending != 0; ++m) {
    const Key gk = __shfl_sync(kFullMask, key, __ffs(pending) - 1);
    const unsigned group = __ballot_sync(kFullMask, live && key == gk);
    pending &= ~group;
    if (__popc(group) < 2) continue;
    const bool mine = (group >> lane) & 1u;
    // selected, not multiplied by zero: another lane's NaN stays out
    float s[32];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float4 x = val(t);
      s[4 * t] = mine ? x.x : 0.0f;
      s[4 * t + 1] = mine ? x.y : 0.0f;
      s[4 * t + 2] = mine ? x.z : 0.0f;
      s[4 * t + 3] = mine ? x.w : 0.0f;
    }
    halve<16>(s, lane);
    halve<8>(s, lane);
    halve<4>(s, lane);
    halve<2>(s, lane);
    halve<1>(s, lane);
    const float sx = s[0];
    const float sy = __shfl_down_sync(kFullMask, sx, 1);
    const float sz = __shfl_down_sync(kFullMask, sx, 2);
    const float sw = __shfl_down_sync(kFullMask, sx, 3);
    if ((lane & 3) == 0 &&
        (sx != 0.0f || sy != 0.0f || sz != 0.0f || sw != 0.0f))
      atomicAdd(addr(gk, lane >> 2), make_float4(sx, sy, sz, sw));
    done = done || mine;
  }
  if (!done) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (!skip(t)) atomicAdd(addr(key, t), val(t));
  }
}

// Adds w[t] * ds into the voxel addr(key, t), t = 0..7, for every live lane
// of the warp: merged where lanes share the key, else one atomic a tap of
// non-zero weight: a tap of zero weight adds nothing.
template <class Key, class Addr>
__device__ __forceinline__ void scatter8(bool live, Key key,
                                         const float (&w)[8],
                                         const float4& ds, const Addr& addr) {
  merged_scatter(
      live, key,
      [&](int t) {
        return make_float4(w[t] * ds.x, w[t] * ds.y, w[t] * ds.z,
                           w[t] * ds.w);
      },
      [&](int t) { return w[t] == 0.0f; }, addr);
}

// The eight trilinear taps of a sample in scatter8's order (o00, o00 + 1,
// o10, o10 + 1 on lo, then on hi) from its lower corner `key`.
struct TrilinearTaps {
  float4* lo;
  float4* hi;
  int W;
  __device__ __forceinline__ float4* operator()(unsigned key,
                                                int t) const {
    return (t < 4 ? lo : hi) + (int)key + ((t & 2) ? W : 0) + (t & 1);
  }
};

// The trilinear sample's VJP without its scatter: the coordinate
// cotangents, the eight taps' weights and the lower corner.
struct TrilinearVjp {
  float d_ux, d_uy, d_uz;
  float w8[8];
  int key;
};

__device__ __forceinline__ TrilinearVjp trilinear_vjp(
    const float4* __restrict__ lo, const float4* __restrict__ hi,
    const MarchGeom& g, float ux, float uy, float uz, const float4& ds) {
  float wz0 = 1.0f - uz, wz1 = uz;
  TrilinearVjp r;
  Taps t = taps(g, ux, uy);
  float4 a00 = __ldg(lo + t.o00), a01 = __ldg(lo + t.o00 + 1);
  float4 a10 = __ldg(lo + t.o10), a11 = __ldg(lo + t.o10 + 1);
  float4 b00 = __ldg(hi + t.o00), b01 = __ldg(hi + t.o00 + 1);
  float4 b10 = __ldg(hi + t.o10), b11 = __ldg(hi + t.o10 + 1);
  float wx0 = 1.0f - t.fx, wx1 = t.fx;
  float wy0 = 1.0f - t.fy, wy1 = t.fy;
  float w00 = wy0 * wx0, w01 = wy0 * wx1, w10 = wy1 * wx0, w11 = wy1 * wx1;

  // to the slabs: the eight taps' weights (times ds where they are added)
  r.w8[0] = wz0 * w00; r.w8[1] = wz0 * w01;
  r.w8[2] = wz0 * w10; r.w8[3] = wz0 * w11;
  r.w8[4] = wz1 * w00; r.w8[5] = wz1 * w01;
  r.w8[6] = wz1 * w10; r.w8[7] = wz1 * w11;
  r.key = t.o00;

  // to the coordinates: differences of the taps along each axis
  float qa00 = dot4(a00, ds), qa01 = dot4(a01, ds);
  float qa10 = dot4(a10, ds), qa11 = dot4(a11, ds);
  float qb00 = dot4(b00, ds), qb01 = dot4(b01, ds);
  float qb10 = dot4(b10, ds), qb11 = dot4(b11, ds);
  r.d_ux = wz0 * (wy0 * (qa01 - qa00) + wy1 * (qa11 - qa10)) +
           wz1 * (wy0 * (qb01 - qb00) + wy1 * (qb11 - qb10));
  r.d_uy = wz0 * (wx0 * (qa10 - qa00) + wx1 * (qa11 - qa01)) +
           wz1 * (wx0 * (qb10 - qb00) + wx1 * (qb11 - qb01));
  r.d_uz = (w00 * qb00 + w01 * qb01 + w10 * qb10 + w11 * qb11) -
           (w00 * qa00 + w01 * qa01 + w10 * qa10 + w11 * qa11);
  if (!t.free_x) r.d_ux = 0.0f;
  if (!t.free_y) r.d_uy = 0.0f;
  return r;
}

// The sample's VJP: the cotangent `ds` of (grad n, n-1) pulled back to the
// two slabs (scattered into `dlo`, `dhi` with the taps' weights, merged over
// the warp as above) and to the coordinates.  d_ux and d_uy come from the
// weights' derivatives and are zero where the clamp held the coordinate;
// d_uz is the hi blend minus the lo blend, unmasked (uz is clipped by the
// caller, who masks it).  Every lane of the warp calls it; a lane with
// live = false scatters nothing and its results are to be dropped.
struct SampleVjp {
  float d_ux, d_uy, d_uz;
};

template <int SCHEME>
__device__ __forceinline__ SampleVjp sample_vjp(
    const float4* __restrict__ lo, const float4* __restrict__ hi,
    float4* __restrict__ dlo, float4* __restrict__ dhi, const MarchGeom& g,
    float ux, float uy, float uz, const float4& ds, bool live) {
  float wz0 = 1.0f - uz, wz1 = uz;
  SampleVjp v;
  if constexpr (SCHEME == 2) {
    CubicAxis ax = cubic_axis<true>(ux, g.W);
    CubicAxis ay = cubic_axis<true>(uy, g.H);
    // j0 lies in [-3, n]: both fit 32 bits after the shift by 3
    const unsigned long long key =
        ((unsigned long long)(unsigned)(ay.j0 + 3) << 32) |
        (unsigned)(ax.j0 + 3);
    float d_ux = 0.0f, d_uy = 0.0f, d_uz = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ay.i[j] * g.W;
      float rx = 0.0f, ry = 0.0f, rz = 0.0f;
      float w8[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = row + ax.i[i];
        float w = ay.w[j] * ax.w[i];
        float qa = dot4(__ldg(lo + o), ds);
        float qb = dot4(__ldg(hi + o), ds);
        w8[i] = wz0 * w;
        w8[4 + i] = wz1 * w;
        float q = wz0 * qa + wz1 * qb;
        rx += ax.d[i] * q;
        ry += ax.w[i] * q;
        rz += ax.w[i] * (qb - qa);
      }
      // row j of the 4 x 4 taps of the key's sample, on both slabs
      scatter8(live, key, w8, ds, [&](unsigned long long k, int t) {
        const int jx = (int)(unsigned)(k & 0xffffffffu) - 3 + (t & 3);
        const int jy = (int)(unsigned)(k >> 32) - 3 + j;
        const int o =
            min(max(jy, 0), g.H - 1) * g.W + min(max(jx, 0), g.W - 1);
        return (t < 4 ? dlo : dhi) + o;
      });
      d_ux += ay.w[j] * rx;
      d_uy += ay.d[j] * ry;
      d_uz += ay.w[j] * rz;
    }
    v.d_ux = ax.free ? d_ux : 0.0f;
    v.d_uy = ay.free ? d_uy : 0.0f;
    v.d_uz = d_uz;
  } else {
    const TrilinearVjp r = trilinear_vjp(lo, hi, g, ux, uy, uz, ds);
    scatter8(live, (unsigned)r.key, r.w8, ds,
             TrilinearTaps{dlo, dhi, g.W});
    v.d_ux = r.d_ux;
    v.d_uy = r.d_uy;
    v.d_uz = r.d_uz;
  }
  return v;
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

template <int SCHEME>
__device__ __forceinline__ State5 rhs(const float4* __restrict__ lo,
                                      const float4* __restrict__ hi,
                                      const MarchGeom& g, float z_plane,
                                      const State5& s, float z_at) {
  float uz = clampf(div_rn_by(z_at - z_plane, g.dz_slab, g.inv_dz), 0.0f,
                    1.0f);
  float ux = 0.5f + div_rn_by(s.x - g.min_x, g.sx, g.inv_sx);
  float uy = 0.5f + div_rn_by(s.y - g.min_y, g.sy, g.inv_sy);
  float4 f = sample<SCHEME>(lo, hi, g, ux, uy, uz);
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
template <int SCHEME>
__device__ __forceinline__ State5 rk4(const float4* __restrict__ lo,
                                      const float4* __restrict__ hi,
                                      const MarchGeom& g, float z_plane,
                                      const State5& s, float h, float z0,
                                      Stages* st = nullptr) {
  State5 k1 = rhs<SCHEME>(lo, hi, g, z_plane, s, z0);
  float h2 = h / 2.0f;
  State5 s2 = axpy(s, h2, k1);
  State5 k2 = rhs<SCHEME>(lo, hi, g, z_plane, s2, z0 + h2);
  State5 s3 = axpy(s, h2, k2);
  State5 k3 = rhs<SCHEME>(lo, hi, g, z_plane, s3, z0 + h2);
  State5 s4 = axpy(s, h, k3);
  State5 k4 = rhs<SCHEME>(lo, hi, g, z_plane, s4, z0 + h);
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

// host side: the reciprocals are IEEE f32 divisions, so correctly rounded
inline MarchGeom make_geom(const float* geom, int W, int H, int D) {
  return {geom[0], geom[1], geom[2],        geom[3],
          geom[4], geom[5], geom[6],        geom[7],
          W,       H,       D,              1.0f / geom[2],
          1.0f / geom[3],   1.0f / geom[6]};
}

}  // namespace

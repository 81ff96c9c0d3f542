// Backward of the dense chief-ray march: two kernels over one VJP chain, and
// the stagewise backward of Adams-Bashforth and substeps over the same
// chain (its own section below).
//
// photon_march_bwd_stage replaces the TPU kernel
// photon_tpu/ops/march_dense_fused.py::_bwd_stage_kernel: the backward over
// the stage input states that the forward's `_traj` head saved.
// photon_march_bwd_remarch replaces ::_bwd_fused_kernel: the same backward
// without a residual, each step's entry state reconstructed from its exit
// state by a reverse RK4 step plus `defect_iters` corrections against the
// discrete forward map (Euler: a fixed point of 3 + 2 `defect_iters`
// evaluations; the TPU kernel always takes three).  The two also replace the
// two flavours of photon_tpu/ops/march_window.py::_bwd_window_kernel, the
// backward of the TPU's march for slabs over 256 x 256 voxels, whose
// read-modify-write of window cotangents is here the same atomicAdd at a
// 64-bit offset into a field cotangent of any size.
//
// The TPU kernels sweep a (slab, ray block) grid, keep the cotangent state of
// all rays in a scratch register file, form the sample's VJP as matrix
// products against dense weight matrices and accumulate the slab pair's
// cotangent in fast memory.  Here one thread owns one ray, as in the forward:
// the reversed slab loop runs inside the thread, the cotangent state
// (ct_x, ct_y, ct_z, ct_Tx, ct_Ty, ct_Tz) stays in registers, each stage
// re-gathers its eight voxels (thirty-two under the cubic scheme 2, whose
// weights' derivatives the kernels form as the TPU kernels do), and the
// field's cotangent goes with 16-byte atomicAdds into a zeroed (D, H, W, 4)
// tensor; under scheme 2 that tensor is the cotangent of the B-spline
// coefficients, which the caller pulls back through the prefilter.  Where the
// TPU kernel sums a slab pair's cotangent in fast memory, the lanes of a warp
// that sample the same voxels sum theirs in registers first and issue one
// atomic a voxel (march_common.cuh, scatter8): the rays of a warp are
// neighbours of one dot in the caller's order (under scheme 2 the caller
// sorts each block's rays by where they cross the volume,
// march_dense_fused.block_ray_order) and mostly share their lower
// corner.  So the slab loop is uniform across a warp, and no lane leaves
// before the last slab.  No ray blocks, no chunking of the rays, no
// re-blocking, no packed slab pairs.
// The forward kernel does the entry advance and the final normalisation
// itself, so these kernels differentiate both by hand around the slab sweep
// (the TPU kernels leave them to the surrounding array code): cotangents of
// the march's outputs (x, y, z, dirx, diry, dirz) in, cotangents of the chief
// rays (xs, ys, zs, dcx, dcy, dcz) out.
//
// What bounds them on an H100: bytes (80 of residual a ray and in-band slab,
// the stage kernel) or operations (twelve more stage evaluations, the
// re-march kernel) in principle; dependent-load latency and the atomic units
// in practice.  Unmerged, a ray and in-band slab costs 4 stages x 8 (cubic:
// 32) vector atomics on voxels its neighbours hit too, and those atomics set
// the time; merged, a warp whose rays share one corner issues 8 (32) a stage
// for all its lanes.  Float atomics add in an order that changes from run to
// run, so d_field differs in its last bits between runs; the rays'
// cotangents have no atomics and are run-to-run equal.
//
// Gradients with respect to the geometry scalars are not produced (volume
// bounds are never optimisation variables).
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include "march_common.cuh"

namespace {

struct Cot6 {
  float x, y, z, tx, ty, tz;
};

struct StageVjp {
  State5 v;     // cotangent of the stage's input state
  float d_z;    // cotangent of the z the stage was sampled at
  State5 k;     // the stage's right-hand side (for d_h)
};

// The field's cotangent of one slab step under the trilinear scheme, in the
// stage backward (K4).  A lane sums the contributions of its stages in
// registers while they fall on one lower corner (a ray moves far less than a
// voxel in a slab step), and the warp merges the sums (flush,
// march_common.cuh's merged_scatter) at the step's end: one merge and at most
// eight atomics a group and step, where a merge a stage takes four merges
// and up to 24 atomics.  Where more than kFewMovers lanes of the warp move to
// another corner at one stage (they cross a voxel face together, as the rays
// of a dot do on a coarse grid), the warp merges what it has and starts
// again; a lane that moves with fewer sends its stage straight out.  A tap of
// zero weight adds nothing, as in scatter8.  Under scheme 2 a stage has 32
// taps, 128 registers of sums, and the re-march backward (K5) needs its
// registers for the reconstruction, so there each stage is merged as it goes
// (scatter8, sample_vjp).
constexpr int kFewMovers = 8;

struct SlabAcc {
  float4 v[8];
  int key;       // the lower corner, -1 while nothing is summed
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int t = 0; t < 8; ++t) v[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    key = -1;
  }
  // every lane of the warp, for each stage
  __device__ __forceinline__ void add(const TrilinearVjp& r, const float4& ds,
                                      bool live, const TrilinearTaps& taps) {
    const bool moves = live && key >= 0 && r.key != key;
    if (__popc(__ballot_sync(kFullMask, moves)) > kFewMovers) flush(taps);
    if (!live) return;
    if (key >= 0 && r.key != key) {
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (r.w8[t] != 0.0f)
          atomicAdd(taps((unsigned)r.key, t),
                    make_float4(r.w8[t] * ds.x, r.w8[t] * ds.y,
                                r.w8[t] * ds.z, r.w8[t] * ds.w));
      return;
    }
    key = r.key;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (r.w8[t] == 0.0f) continue;
      v[t].x += r.w8[t] * ds.x;
      v[t].y += r.w8[t] * ds.y;
      v[t].z += r.w8[t] * ds.z;
      v[t].w += r.w8[t] * ds.w;
    }
  }
  // every lane of the warp
  __device__ __forceinline__ void flush(const TrilinearTaps& taps) {
    merged_scatter(
        key >= 0, (unsigned)key, [&](int t) { return v[t]; },
        [&](int t) {
          return v[t].x == 0.0f && v[t].y == 0.0f && v[t].z == 0.0f &&
                 v[t].w == 0.0f;
        },
        taps);
    reset();
  }
};

// One stage: recompute the sample at state `s`, rebuild k, and pull the
// cotangent d5 of k back to the state, to z_at and to the field (the
// sample's own VJP: trilinear_vjp with its cotangent summed in `acc` where
// STEP_SUMS, else sample_vjp, which merges it at once; march_common.cuh).
template <int SCHEME, bool STEP_SUMS>
__device__ __forceinline__ StageVjp vjp_stage(
    const float4* __restrict__ lo, const float4* __restrict__ hi,
    float4* __restrict__ dlo, float4* __restrict__ dhi, const MarchGeom& g,
    float z_plane, const State5& s, float z_at, const State5& d5, bool live,
    SlabAcc* acc) {
  float uz_raw = div_rn_by(z_at - z_plane, g.dz_slab, g.inv_dz);
  float uz = clampf(uz_raw, 0.0f, 1.0f);
  float ux = 0.5f + div_rn_by(s.x - g.min_x, g.sx, g.inv_sx);
  float uy = 0.5f + div_rn_by(s.y - g.min_y, g.sy, g.inv_sy);
  float4 f = sample<SCHEME>(lo, hi, g, ux, uy, uz);

  StageVjp r;
  float inv = 1.0f / s.tz;
  float gfac = (1.0f + f.w) * inv;
  r.k = {s.tx * inv, s.ty * inv, gfac * f.x, gfac * f.y, gfac * f.z};

  // k = (tx inv, ty inv, gfac gx, gfac gy, gfac gz)
  float d_gfac = d5.tx * f.x + d5.ty * f.y + d5.tz * f.z;
  float d_inv = d5.x * s.tx + d5.y * s.ty + d_gfac * (1.0f + f.w);
  // cotangent of the sample (gx, gy, gz, n-1)
  float4 ds = make_float4(d5.tx * gfac, d5.ty * gfac, d5.tz * gfac,
                          d_gfac * inv);
  SampleVjp v;
  if constexpr (SCHEME == 1 && STEP_SUMS) {
    const TrilinearVjp t = trilinear_vjp(lo, hi, g, ux, uy, uz, ds);
    acc->add(t, ds, live, TrilinearTaps{dlo, dhi, g.W});
    v = {t.d_ux, t.d_uy, t.d_uz};
  } else {
    v = sample_vjp<SCHEME>(lo, hi, dlo, dhi, g, ux, uy, uz, ds, live);
  }
  if (!(uz_raw >= 0.0f && uz_raw <= 1.0f)) v.d_uz = 0.0f;

  r.v = {v.d_ux * g.inv_sx, v.d_uy * g.inv_sy, d5.x * inv, d5.y * inv,
         -(inv * inv) * d_inv};
  r.d_z = v.d_uz * g.inv_dz;
  return r;
}

__device__ __forceinline__ State5 scale_s5(float c, const State5& d) {
  return {c * d.x, c * d.y, c * d.tx, c * d.ty, c * d.tz};
}

// The VJP of one RK4 step's stages k4, k3 and k2 from their input states,
// for the cotangent `ct` of the step's output; every lane of the warp calls
// it.  The stage k1 is left to the caller (rk4_k1_cot, rk4_step_vjp).
struct Rk4Tail {
  StageVjp r2, r3, r4;
};

template <int SCHEME, bool STEP_SUMS>
__device__ __forceinline__ Rk4Tail rk4_vjp_tail(
    const float4* __restrict__ lo, const float4* __restrict__ hi,
    float4* __restrict__ dlo, float4* __restrict__ dhi, const MarchGeom& g,
    float z_plane, float z0, float h, const Stages& sg, const State5& ct,
    bool live, SlabAcc* acc) {
  auto stage = [&](const State5& s, float z_at, const State5& d5) {
    return vjp_stage<SCHEME, STEP_SUMS>(lo, hi, dlo, dhi, g, z_plane, s, z_at,
                                        d5, live, acc);
  };
  const float h2 = h / 2.0f;
  Rk4Tail t;
  t.r4 = stage(sg.s4, z0 + h, scale_s5(h / 6.0f, ct));
  t.r3 = stage(sg.s3, z0 + h2, axpy(scale_s5(h / 3.0f, ct), h, t.r4.v));
  t.r2 = stage(sg.s2, z0 + h2, axpy(scale_s5(h / 3.0f, ct), h2, t.r3.v));
  return t;
}

// the cotangent that the step's output gives its first stage k1
__device__ __forceinline__ State5 rk4_k1_cot(float h, const State5& ct,
                                             const Rk4Tail& t) {
  return axpy(scale_s5(h / 6.0f, ct), h / 2.0f, t.r2.v);
}

// The VJP of one RK4 step with its four stages pulled back: the cotangents
// of its input state, of its start z0 and of its length h, each alone.
struct StepVjp {
  State5 d_s;
  float d_z0, d_h;
};

__device__ __forceinline__ StepVjp rk4_step_vjp(const State5& ct,
                                                const Rk4Tail& t,
                                                const StageVjp& r1) {
  StepVjp v;
  v.d_s = axpy(axpy(axpy(axpy(ct, 1.0f, t.r4.v), 1.0f, t.r3.v), 1.0f,
                    t.r2.v),
               1.0f, r1.v);
  const State5 combo = {
      r1.k.x + 2.0f * t.r2.k.x + 2.0f * t.r3.k.x + t.r4.k.x,
      r1.k.y + 2.0f * t.r2.k.y + 2.0f * t.r3.k.y + t.r4.k.y,
      r1.k.tx + 2.0f * t.r2.k.tx + 2.0f * t.r3.k.tx + t.r4.k.tx,
      r1.k.ty + 2.0f * t.r2.k.ty + 2.0f * t.r3.k.ty + t.r4.k.ty,
      r1.k.tz + 2.0f * t.r2.k.tz + 2.0f * t.r3.k.tz + t.r4.k.tz};
  v.d_h = dot5(ct, combo) / 6.0f + dot5(t.r4.v, t.r3.k) + t.r4.d_z +
          0.5f * dot5(t.r3.v, t.r2.k) + 0.5f * t.r3.d_z +
          0.5f * dot5(t.r2.v, r1.k) + 0.5f * t.r2.d_z;
  v.d_z0 = t.r4.d_z + t.r3.d_z + t.r2.d_z + r1.d_z;
  return v;
}

// Backward of one slab step given its stage input states; updates the
// cotangent state in place where `live` (the step is in the ray's band).
// Every lane of the warp calls it (the scatter merges across the warp); a
// lane that is not live computes on whatever it holds and keeps its state.
// h = z_plane - z_entry is the forward step.
template <int SCHEME, bool STEP_SUMS>
__device__ __forceinline__ void slab_backward(
    int algorithm, const float4* __restrict__ lo,
    const float4* __restrict__ hi, float4* __restrict__ dlo,
    float4* __restrict__ dhi, const MarchGeom& g, float z_plane,
    float z_entry, float h, const Stages& sg, Cot6& ct, bool live,
    SlabAcc* acc) {
  const State5 d_new = {ct.x, ct.y, ct.tx, ct.ty, ct.tz};
  auto stage = [&](const State5& s, float z_at, const State5& d5) {
    return vjp_stage<SCHEME, STEP_SUMS>(lo, hi, dlo, dhi, g, z_plane, s, z_at,
                                        d5, live, acc);
  };
  State5 d_st;
  float d_z;
  if (algorithm == 1) {
    StageVjp r1 = stage(sg.s1, z_entry, scale_s5(h, d_new));
    d_st = axpy(d_new, 1.0f, r1.v);
    d_z = r1.d_z - dot5(d_new, r1.k);
  } else {
    const Rk4Tail t = rk4_vjp_tail<SCHEME, STEP_SUMS>(
        lo, hi, dlo, dhi, g, z_plane, z_entry, h, sg, d_new, live, acc);
    const StepVjp v =
        rk4_step_vjp(d_new, t, stage(sg.s1, z_entry, rk4_k1_cot(h, d_new, t)));
    d_st = v.d_s;
    d_z = v.d_z0 - v.d_h;
  }
  // the step lands on a fixed plane, so the cotangent of its exit z ends
  // here and that of its entry z takes its place
  if (live) ct = {d_st.x, d_st.y, d_z, d_st.tx, d_st.ty, d_st.tz};
}

__device__ __forceinline__ Cot6 load_cot(const float* ct, long long P,
                                         long long p) {
  return {ct[p], ct[P + p], ct[2 * P + p], ct[3 * P + p], ct[4 * P + p],
          ct[5 * P + p]};
}

struct ChiefRay {
  float x0, y0, z0, cx, cy, cz;
};

__device__ __forceinline__ ChiefRay load_ray(const float* rays, long long P,
                                             long long p) {
  return {rays[p], rays[P + p], rays[2 * P + p], rays[3 * P + p],
          rays[4 * P + p], rays[5 * P + p]};
}

// dir = T / |T| at the exit: turns the cotangent of dir held in
// (ct.tx, ct.ty, ct.tz) into that of the raw exit T
__device__ __forceinline__ void normalise_bwd(float tx, float ty, float tz,
                                              Cot6& ct) {
  float tn = sqrtf(tx * tx + ty * ty + tz * tz);
  float dx = tx / tn, dy = ty / tn, dz = tz / tn;
  float along = dx * ct.tx + dy * ct.ty + dz * ct.tz;
  ct.tx = (ct.tx - dx * along) / tn;
  ct.ty = (ct.ty - dy * along) / tn;
  ct.tz = (ct.tz - dz * along) / tn;
}

// Entry advance and T = n0 c, backwards: `ct` is the cotangent of the entry
// state (x, y, z, Tx, Ty, Tz) of a ray that entered, or of the outputs
// (x, y, z, dirx, diry, dirz) of one that passed through unchanged; writes
// the cotangents of (xs, ys, zs, dcx, dcy, dcz).
__device__ __forceinline__ void entry_bwd(const MarchGeom& g,
                                          const ChiefRay& r, const Entry& e,
                                          const Cot6& ct, float* d_rays,
                                          long long P, long long p) {
  const float scale = e.inside ? g.n0 : 1.0f;
  float g_cx = scale * ct.tx + ct.x * e.adv;
  float g_cy = scale * ct.ty + ct.y * e.adv;
  float g_cz = scale * ct.tz;
  float g_z0 = 0.0f;
  if (e.above) {
    // z lands on the volume top; adv = max((z_max - z0) / cz, 0)
    float t_entry = (g.z_max - r.z0) / r.cz;
    if (t_entry >= 0.0f) {
      float g_adv = ct.x * r.cx + ct.y * r.cy;
      g_z0 = -g_adv / r.cz;
      g_cz -= g_adv * t_entry / r.cz;
    }
  } else {
    g_z0 = ct.z;
  }
  d_rays[p] = ct.x;
  d_rays[P + p] = ct.y;
  d_rays[2 * P + p] = g_z0;
  d_rays[3 * P + p] = g_cx;
  d_rays[4 * P + p] = g_cy;
  d_rays[5 * P + p] = g_cz;
}

// 128 threads a block, and registers for three blocks an SM (168 a
// thread): the stage kernel's sums of a slab step (SlabAcc, 32 registers)
// would otherwise leave two, a third fewer warps to hide the gathers'
// latency (the readings are in PERF.md).
constexpr int kThreads = 128;

// rays, ct_out, d_rays: (6, P); texit: (3, P) raw exit T of the forward;
// traj: the forward's (S, rows, P) stage residual; d_field: zeroed
// (D, H, W) float4.
template <int SCHEME>
__global__ void __launch_bounds__(kThreads, 3)
    march_bwd_stage_kernel(const float* __restrict__ rays,
                           const float* __restrict__ texit,
                           const float* __restrict__ traj,
                           const float* __restrict__ ct_out,
                           const float4* __restrict__ field,
                           float4* __restrict__ d_field,
                           float* __restrict__ d_rays, long long P,
                           MarchGeom g, int algorithm) {
  // A lane past the last ray stays to the end, because every lane of a warp
  // takes part in each merged scatter: it reads ray P-1, scatters nothing
  // and writes nothing.  For the same reason the slab loop is uniform across
  // the warp and skips only the steps that no lane of it takes.
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = p < P;
  const long long q = real ? p : P - 1;
  const ChiefRay r = load_ray(rays, P, q);
  const Entry e = entry_advance(g, r.x0, r.y0, r.z0, r.cx, r.cy, r.cz);
  Cot6 ct = load_cot(ct_out, P, q);
  const bool inside = real && e.inside;
  if (__any_sync(kFullMask, inside)) {
    if (inside) normalise_bwd(texit[q], texit[P + q], texit[2 * P + q], ct);
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    const int rows = algorithm == 1 ? 5 : 20;
    SlabAcc acc;
    acc.reset();
    for (int ks = 0; ks < S; ++ks) {       // forward step s = S-1-ks
      float z_plane = landing_plane(g, ks);
      float z_entry = fminf(e.z, plane_above(g, ks));
      const bool live = inside && z_entry > z_plane;
      if (!__any_sync(kFullMask, live)) continue;
      Stages sg = {};
      if (live) {
        const float* tr = traj + (long long)(S - 1 - ks) * rows * P + q;
        sg.s1 = load_state5(tr, P);
        if (algorithm != 1) {
          sg.s2 = load_state5(tr + 5 * P, P);
          sg.s3 = load_state5(tr + 10 * P, P);
          sg.s4 = load_state5(tr + 15 * P, P);
        }
      }
      const long long off = (long long)ks * slab;
      slab_backward<SCHEME, SCHEME == 1>(
          algorithm, field + off, field + off + slab, d_field + off,
          d_field + off + slab, g, z_plane, z_entry, z_plane - z_entry, sg,
          ct, live, &acc);
      if constexpr (SCHEME == 1)
        acc.flush(TrilinearTaps{d_field + off, d_field + off + slab, g.W});
    }
  }
  if (real) entry_bwd(g, r, e, ct, d_rays, P, p);
}

// as above, with the forward's outputs `out` (6, P) in place of the residual
template <int SCHEME>
__global__ void __launch_bounds__(kThreads, 3)
    march_bwd_remarch_kernel(const float* __restrict__ rays,
                             const float* __restrict__ texit,
                             const float* __restrict__ out,
                             const float* __restrict__ ct_out,
                             const float4* __restrict__ field,
                             float4* __restrict__ d_field,
                             float* __restrict__ d_rays, long long P,
                             MarchGeom g, int algorithm, int defect_iters) {
  // lanes past the last ray and the uniform slab loop: as the stage kernel
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = p < P;
  const long long q = real ? p : P - 1;
  const ChiefRay r = load_ray(rays, P, q);
  const Entry e = entry_advance(g, r.x0, r.y0, r.z0, r.cx, r.cy, r.cz);
  Cot6 ct = load_cot(ct_out, P, q);
  const bool inside = real && e.inside;
  if (__any_sync(kFullMask, inside)) {
    State5 st = {out[q], out[P + q], texit[q], texit[P + q],
                 texit[2 * P + q]};
    if (inside) normalise_bwd(st.tx, st.ty, st.tz, ct);
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    for (int ks = 0; ks < S; ++ks) {
      float z_plane = landing_plane(g, ks);
      float z_entry = fminf(e.z, plane_above(g, ks));
      const bool live = inside && z_entry > z_plane;
      if (!__any_sync(kFullMask, live)) continue;
      const long long off = (long long)ks * slab;
      const float4* lo = field + off;
      const float4* hi = lo + slab;
      const float h = z_plane - z_entry;
      // reverse reconstruction: exit state of the step -> its entry state
      // (a lane that does not take the step keeps zero stages)
      Stages sg = {};
      if (live && algorithm == 1) {
        // fixed-point inverse of the Euler step (entry = exit - h k(entry)):
        // three evaluations as in the TPU kernel, two more for each defect
        // iteration that the grid's anisotropy asks for
        State5 guess =
            axpy(st, -h, rhs<SCHEME>(lo, hi, g, z_plane, st, z_plane));
        for (int it = 0; it < 2 + 2 * defect_iters; ++it)
          guess =
              axpy(st, -h, rhs<SCHEME>(lo, hi, g, z_plane, guess, z_entry));
        sg.s1 = guess;
      } else if (live) {
        State5 rec = rk4<SCHEME>(lo, hi, g, z_plane, st, -h, z_plane);
        for (int it = 0; it < defect_iters; ++it) {
          State5 fwd = rk4<SCHEME>(lo, hi, g, z_plane, rec, h, z_entry);
          rec = {rec.x - (fwd.x - st.x), rec.y - (fwd.y - st.y),
                 rec.tx - (fwd.tx - st.tx), rec.ty - (fwd.ty - st.ty),
                 rec.tz - (fwd.tz - st.tz)};
        }
        // replay the forward stages from the reconstructed entry
        rk4<SCHEME>(lo, hi, g, z_plane, rec, h, z_entry, &sg);
      }
      slab_backward<SCHEME, false>(algorithm, lo, hi, d_field + off,
                                   d_field + off + slab, g, z_plane, z_entry,
                                   h, sg, ct, live, nullptr);
      if (live) st = sg.s1;
    }
  }
  if (real) entry_bwd(g, r, e, ct, d_rays, P, p);
}

// ---------------------------------------------------------------------------
// The stagewise backward: the VJP of march_dense.cu's stagewise march
// (Adams-Bashforth, RK4 with substeps) in one launch.
//
// Replaces, on the routes it serves, the per-stage loop over the sampler's
// backward photon_slab_sample_bwd (csrc/slab_sample.cu, the port of the TPU
// kernel photon_tpu/ops/march_dense_pallas.py::_bwd_kernel), one launch a
// stage with the stages' VJP in array code between launches.  Here one thread
// owns one ray, as in K4: the reversed slab loop runs inside the thread with
// the cotangent state in registers, starting from each slab step's entry
// state (the forward's 5-row residual), and the field's cotangent goes out
// through the same stage VJP (vjp_stage) and warp-merged scatter (SlabAcc
// under scheme 1, which sums all stages of a slab step first; scatter8 under
// scheme 2) as K4's.  What bounds it: the stages it samples again and their
// atomics, as K4, plus the replay of each step's stages from its entry state.
//
// Algorithm 3: each slab step replays its S substeps from the entry state
// (substep i from the entry by i RK4 steps, then once more with the stage
// states recorded: S (S + 1) / 2 RK4 steps a slab, no local memory for any
// S) and pulls the cotangent back through them in reverse.  Algorithm 4: a
// step's output is linear in the three stored right-hand sides, so the
// backward needs no values of them, only their cotangents: three State5
// slots that the reverse loop shifts as the forward shifted the history.
// Each step's entry right-hand side f_now is pulled back through vjp_stage at
// the stored entry state with its whole cotangent (55 h/24 of the output's
// and what the three later steps' formulas gave it); the stages k4, k3, k2 of
// a bootstrap step (a ray's first three) run only in warps that hold one.
// A step's length h and its entry z are constants of the grid for every step
// but a ray's first (it enters on a landing plane), so only the first step's
// cotangent reaches the ray's z, and the first step is always RK4.  Every
// lane of a warp reaches every merge, masked by `live` (or `boot`).
// ---------------------------------------------------------------------------

// rays, ct_out, d_rays: (6, P); texit: (3, P) raw exit T of the forward;
// traj: its (S, 5, P) entry states; d_field: zeroed (D, H, W) float4.
// Trilinear: registers for three blocks an SM, as K4.  Left to itself
// ptxas takes 216 a thread (two blocks); capped at 168, with 264 bytes of
// spills, it ran 6-10% faster at the bench's 120,000 rays.  Tricubic: the
// 255 ptxas takes; capped at 168 (412 bytes of spills) it ran Adams-Bashforth
// as fast and 2 substeps 21% slower (PERF.md).
template <int SCHEME>
__global__ void __launch_bounds__(kThreads, SCHEME == 1 ? 3 : 2)
    march_stagewise_bwd_kernel(const float* __restrict__ rays,
                               const float* __restrict__ texit,
                               const float* __restrict__ traj,
                               const float* __restrict__ ct_out,
                               const float4* __restrict__ field,
                               float4* __restrict__ d_field,
                               float* __restrict__ d_rays, long long P,
                               MarchGeom g, int algorithm, int substeps) {
  // lanes past the last ray and the uniform slab loop: as the stage kernel
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = p < P;
  const long long q = real ? p : P - 1;
  const ChiefRay r = load_ray(rays, P, q);
  const Entry e = entry_advance(g, r.x0, r.y0, r.z0, r.cx, r.cy, r.cz);
  Cot6 ct = load_cot(ct_out, P, q);
  const bool inside = real && e.inside;
  if (__any_sync(kFullMask, inside)) {
    if (inside) normalise_bwd(texit[q], texit[P + q], texit[2 * P + q], ct);
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    // the ray's in-band steps are every slab step from its first down to the
    // last, so the forward's step number of slab ks is steps - 1 - ks
    int steps = 0;
    for (int ks = 0; ks < S; ++ks)
      steps += (inside && fminf(e.z, plane_above(g, ks)) >
                              landing_plane(g, ks)) ? 1 : 0;
    // Adams-Bashforth: the cotangents of the entry right-hand sides of the
    // step at hand (d_f0) and of the one (d_f1) and two (d_f2) before it
    State5 d_f0 = {}, d_f1 = {}, d_f2 = {};
    SlabAcc acc;
    acc.reset();
    for (int ks = 0; ks < S; ++ks) {       // forward step s = S-1-ks
      const float z_plane = landing_plane(g, ks);
      const float z_entry = fminf(e.z, plane_above(g, ks));
      const bool live = inside && z_entry > z_plane;
      if (!__any_sync(kFullMask, live)) continue;
      const long long off = (long long)ks * slab;
      const float4* lo = field + off;
      const float4* hi = lo + slab;
      float4* dlo = d_field + off;
      float4* dhi = dlo + slab;
      const float h = z_plane - z_entry;
      State5 s_in = {};
      if (live) s_in = load_state5(traj + (long long)(S - 1 - ks) * 5 * P + q, P);
      const State5 c5 = {ct.x, ct.y, ct.tx, ct.ty, ct.tz};
      auto stage1 = [&](const State5& d5) {
        return vjp_stage<SCHEME, SCHEME == 1>(lo, hi, dlo, dhi, g, z_plane,
                                              s_in, z_entry, d5, live, &acc);
      };
      if (algorithm == 4) {
        const bool boot = live && steps - 1 - ks < 3;
        const float c = h / 24.0f;
        Rk4Tail t = {};
        if (__any_sync(kFullMask, boot)) {
          Stages sg = {};
          if (boot) rk4<SCHEME>(lo, hi, g, z_plane, s_in, h, z_entry, &sg);
          t = rk4_vjp_tail<SCHEME, SCHEME == 1>(lo, hi, dlo, dhi, g, z_plane,
                                                z_entry, h, sg, c5, boot,
                                                &acc);
        }
        const State5 d_k1 = boot ? axpy(rk4_k1_cot(h, c5, t), 1.0f, d_f0)
                                 : axpy(d_f0, 55.0f * c, c5);
        const StageVjp r1 = stage1(d_k1);
        if (live) {
          if (boot) {
            const StepVjp v = rk4_step_vjp(c5, t, r1);
            ct = {v.d_s.x, v.d_s.y, v.d_z0 - v.d_h, v.d_s.tx, v.d_s.ty,
                  v.d_s.tz};
            d_f0 = d_f1;
            d_f1 = d_f2;
            d_f2 = {};
          } else {
            // the entry z of a step past a ray's first is a landing plane
            const State5 d_s = axpy(c5, 1.0f, r1.v);
            ct = {d_s.x, d_s.y, 0.0f, d_s.tx, d_s.ty, d_s.tz};
            d_f0 = axpy(d_f1, -59.0f * c, c5);
            d_f1 = axpy(d_f2, 37.0f * c, c5);
            d_f2 = scale_s5(-9.0f * c, c5);
          }
        }
      } else {
        // z0 of substep i is z_entry + i hs, and hs = (z_plane - z_entry) / S
        const float hs = h / (float)substeps;
        State5 d = c5;
        float d_z0s = 0.0f, d_hs = 0.0f;
        for (int i = substeps - 1; i >= 0; --i) {
          Stages sg = {};
          if (live) {
            State5 sub = s_in;
            for (int k = 0; k < i; ++k)
              sub = rk4<SCHEME>(lo, hi, g, z_plane, sub, hs,
                                z_entry + (float)k * hs);
            rk4<SCHEME>(lo, hi, g, z_plane, sub, hs, z_entry + (float)i * hs,
                        &sg);
          }
          const float z0 = z_entry + (float)i * hs;
          const Rk4Tail t = rk4_vjp_tail<SCHEME, SCHEME == 1>(
              lo, hi, dlo, dhi, g, z_plane, z0, hs, sg, d, live, &acc);
          const StageVjp r1 = vjp_stage<SCHEME, SCHEME == 1>(
              lo, hi, dlo, dhi, g, z_plane, sg.s1, z0, rk4_k1_cot(hs, d, t),
              live, &acc);
          const StepVjp v = rk4_step_vjp(d, t, r1);
          d = v.d_s;
          d_z0s += v.d_z0;
          d_hs += v.d_h + (float)i * v.d_z0;
        }
        if (live)
          ct = {d.x, d.y, d_z0s - d_hs / (float)substeps, d.tx, d.ty, d.tz};
      }
      if constexpr (SCHEME == 1) acc.flush(TrilinearTaps{dlo, dhi, g.W});
    }
  }
  if (real) entry_bwd(g, r, e, ct, d_rays, P, p);
}

}  // namespace

// Both return cudaGetLastError() after the launch.  The wrapper zeroes
// d_field; geom and scheme as in march_dense.cu.
extern "C" int photon_march_bwd_stage(const float* rays, const float* texit,
                                      const float* traj, const float* ct_out,
                                      const float* field, float* d_field,
                                      float* d_rays, long long P, int W,
                                      int H, int D, const float* geom,
                                      int algorithm, int scheme,
                                      void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  MarchGeom g = make_geom(geom, W, H, D);
  const int threads = kThreads;
  long long blocks = (P + threads - 1) / threads;
  auto kernel = scheme == 2 ? march_bwd_stage_kernel<2>
                            : march_bwd_stage_kernel<1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays, texit, traj, ct_out, reinterpret_cast<const float4*>(field),
      reinterpret_cast<float4*>(d_field), d_rays, P, g, algorithm);
  return (int)cudaGetLastError();
}

extern "C" int photon_march_bwd_remarch(const float* rays, const float* texit,
                                        const float* out, const float* ct_out,
                                        const float* field, float* d_field,
                                        float* d_rays, long long P, int W,
                                        int H, int D, const float* geom,
                                        int algorithm, int scheme,
                                        int defect_iters, void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  MarchGeom g = make_geom(geom, W, H, D);
  const int threads = kThreads;
  long long blocks = (P + threads - 1) / threads;
  auto kernel = scheme == 2 ? march_bwd_remarch_kernel<2>
                            : march_bwd_remarch_kernel<1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays, texit, out, ct_out, reinterpret_cast<const float4*>(field),
      reinterpret_cast<float4*>(d_field), d_rays, P, g, algorithm,
      defect_iters);
  return (int)cudaGetLastError();
}

// The backward of photon_march_stagewise from its (S, 5, P) residual
// `traj`: algorithm 3 with `substeps`, or 4.  The wrapper zeroes d_field.
extern "C" int photon_march_stagewise_bwd(const float* rays,
                                          const float* texit,
                                          const float* traj,
                                          const float* ct_out,
                                          const float* field, float* d_field,
                                          float* d_rays, long long P, int W,
                                          int H, int D, const float* geom,
                                          int algorithm, int substeps,
                                          int scheme, void* stream) {
  if (scheme != 1 && scheme != 2) return (int)cudaErrorInvalidValue;
  if ((algorithm != 3 && algorithm != 4) || substeps < 1)
    return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  MarchGeom g = make_geom(geom, W, H, D);
  const int threads = kThreads;
  long long blocks = (P + threads - 1) / threads;
  auto kernel = scheme == 2 ? march_stagewise_bwd_kernel<2>
                            : march_stagewise_bwd_kernel<1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays, texit, traj, ct_out, reinterpret_cast<const float4*>(field),
      reinterpret_cast<float4*>(d_field), d_rays, P, g, algorithm, substeps);
  return (int)cudaGetLastError();
}

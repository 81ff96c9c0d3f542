// Backward of the dense chief-ray march: two kernels over one VJP chain.
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
// neighbours of one dot in the caller's order and mostly share their lower
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

__device__ __forceinline__ State5 scale5(float c, const Cot6& d) {
  return {c * d.x, c * d.y, c * d.tx, c * d.ty, c * d.tz};
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
    StageVjp r1 = stage(sg.s1, z_entry, scale5(h, ct));
    d_st = axpy(d_new, 1.0f, r1.v);
    d_z = r1.d_z - dot5(d_new, r1.k);
  } else {
    float h2 = h / 2.0f;
    StageVjp r4 = stage(sg.s4, z_entry + h, scale5(h / 6.0f, ct));
    StageVjp r3 =
        stage(sg.s3, z_entry + h2, axpy(scale5(h / 3.0f, ct), h, r4.v));
    StageVjp r2 =
        stage(sg.s2, z_entry + h2, axpy(scale5(h / 3.0f, ct), h2, r3.v));
    StageVjp r1 = stage(sg.s1, z_entry, axpy(scale5(h / 6.0f, ct), h2, r2.v));
    d_st = axpy(axpy(axpy(axpy(d_new, 1.0f, r4.v), 1.0f, r3.v), 1.0f, r2.v),
                1.0f, r1.v);
    State5 combo = {r1.k.x + 2.0f * r2.k.x + 2.0f * r3.k.x + r4.k.x,
                    r1.k.y + 2.0f * r2.k.y + 2.0f * r3.k.y + r4.k.y,
                    r1.k.tx + 2.0f * r2.k.tx + 2.0f * r3.k.tx + r4.k.tx,
                    r1.k.ty + 2.0f * r2.k.ty + 2.0f * r3.k.ty + r4.k.ty,
                    r1.k.tz + 2.0f * r2.k.tz + 2.0f * r3.k.tz + r4.k.tz};
    float d_h = dot5(d_new, combo) / 6.0f + dot5(r4.v, r3.k) + r4.d_z +
                0.5f * dot5(r3.v, r2.k) + 0.5f * r3.d_z +
                0.5f * dot5(r2.v, r1.k) + 0.5f * r2.d_z;
    d_z = r4.d_z + r3.d_z + r2.d_z + r1.d_z - d_h;
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

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
// field's cotangent is scattered with one 16-byte atomicAdd a voxel into a
// zeroed (D, H, W, 4) tensor; under scheme 2 that tensor is the cotangent of
// the B-spline coefficients, which the caller pulls back through the
// prefilter.  No ray
// blocks, no chunking of the rays, no re-blocking, no packed slab pairs.
// The forward kernel does the entry advance and the final normalisation
// itself, so these kernels differentiate both by hand around the slab sweep
// (the TPU kernels leave them to the surrounding array code): cotangents of
// the march's outputs (x, y, z, dirx, diry, dirz) in, cotangents of the chief
// rays (xs, ys, zs, dcx, dcy, dcz) out.
//
// What bounds them on an H100: the atomic units and dependent-load latency.
// A ray and in-band slab costs 4 stages x 8 (cubic: 32) vector atomics
// (neighbouring rays hit the same voxels) beside 80 bytes of residual (stage
// kernel) or twelve more stage evaluations (re-march kernel).  Float atomics add in an order
// that changes from run to run, so d_field differs in its last bits between
// runs; the rays' cotangents have no atomics and are run-to-run equal.
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

// One stage: recompute the sample at state `s`, rebuild k, and pull the
// cotangent d5 of k back to the state, to z_at and to the field (the
// sample's own VJP is sample_vjp of march_common.cuh).
template <int SCHEME>
__device__ __forceinline__ StageVjp vjp_stage(
    const float4* __restrict__ lo, const float4* __restrict__ hi,
    float4* __restrict__ dlo, float4* __restrict__ dhi, const MarchGeom& g,
    float z_plane, const State5& s, float z_at, const State5& d5) {
  float uz_raw = (z_at - z_plane) / g.dz_slab;
  float uz = clampf(uz_raw, 0.0f, 1.0f);
  float ux = 0.5f + (s.x - g.min_x) / g.sx;
  float uy = 0.5f + (s.y - g.min_y) / g.sy;
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
  SampleVjp v = sample_vjp<SCHEME>(lo, hi, dlo, dhi, g, ux, uy, uz, ds);
  if (!(uz_raw >= 0.0f && uz_raw <= 1.0f)) v.d_uz = 0.0f;

  r.v = {v.d_ux / g.sx, v.d_uy / g.sy, d5.x * inv, d5.y * inv,
         -(inv * inv) * d_inv};
  r.d_z = v.d_uz / g.dz_slab;
  return r;
}

__device__ __forceinline__ State5 scale5(float c, const Cot6& d) {
  return {c * d.x, c * d.y, c * d.tx, c * d.ty, c * d.tz};
}

// Backward of one in-band slab step given its stage input states; updates
// the cotangent state in place.  h = z_plane - z_entry is the forward step.
template <int SCHEME>
__device__ __forceinline__ void slab_backward(
    int algorithm, const float4* __restrict__ lo,
    const float4* __restrict__ hi, float4* __restrict__ dlo,
    float4* __restrict__ dhi, const MarchGeom& g, float z_plane,
    float z_entry, float h, const Stages& sg, Cot6& ct) {
  const State5 d_new = {ct.x, ct.y, ct.tx, ct.ty, ct.tz};
  State5 d_st;
  float d_z;
  if (algorithm == 1) {
    StageVjp r1 = vjp_stage<SCHEME>(lo, hi, dlo, dhi, g, z_plane, sg.s1,
                                    z_entry, scale5(h, ct));
    d_st = axpy(d_new, 1.0f, r1.v);
    d_z = r1.d_z - dot5(d_new, r1.k);
  } else {
    float h2 = h / 2.0f;
    StageVjp r4 = vjp_stage<SCHEME>(lo, hi, dlo, dhi, g, z_plane, sg.s4,
                                    z_entry + h, scale5(h / 6.0f, ct));
    StageVjp r3 = vjp_stage<SCHEME>(lo, hi, dlo, dhi, g, z_plane, sg.s3,
                                    z_entry + h2,
                                    axpy(scale5(h / 3.0f, ct), h, r4.v));
    StageVjp r2 = vjp_stage<SCHEME>(lo, hi, dlo, dhi, g, z_plane, sg.s2,
                                    z_entry + h2,
                                    axpy(scale5(h / 3.0f, ct), h2, r3.v));
    StageVjp r1 = vjp_stage<SCHEME>(lo, hi, dlo, dhi, g, z_plane, sg.s1,
                                    z_entry,
                                    axpy(scale5(h / 6.0f, ct), h2, r2.v));
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
  ct = {d_st.x, d_st.y, d_z, d_st.tx, d_st.ty, d_st.tz};
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

// rays, ct_out, d_rays: (6, P); texit: (3, P) raw exit T of the forward;
// traj: the forward's (S, rows, P) stage residual; d_field: zeroed
// (D, H, W) float4.
template <int SCHEME>
__global__ void march_bwd_stage_kernel(const float* __restrict__ rays,
                                       const float* __restrict__ texit,
                                       const float* __restrict__ traj,
                                       const float* __restrict__ ct_out,
                                       const float4* __restrict__ field,
                                       float4* __restrict__ d_field,
                                       float* __restrict__ d_rays,
                                       long long P, MarchGeom g,
                                       int algorithm) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const ChiefRay r = load_ray(rays, P, p);
  const Entry e = entry_advance(g, r.x0, r.y0, r.z0, r.cx, r.cy, r.cz);
  Cot6 ct = load_cot(ct_out, P, p);
  if (e.inside) {
    normalise_bwd(texit[p], texit[P + p], texit[2 * P + p], ct);
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    const int rows = algorithm == 1 ? 5 : 20;
    for (int ks = 0; ks < S; ++ks) {       // forward step s = S-1-ks
      float z_plane = landing_plane(g, ks);
      float z_entry = fminf(e.z, plane_above(g, ks));
      if (!(z_entry > z_plane)) continue;
      const float* tr = traj + (long long)(S - 1 - ks) * rows * P + p;
      Stages sg;
      sg.s1 = load_state5(tr, P);
      if (algorithm != 1) {
        sg.s2 = load_state5(tr + 5 * P, P);
        sg.s3 = load_state5(tr + 10 * P, P);
        sg.s4 = load_state5(tr + 15 * P, P);
      }
      const long long off = (long long)ks * slab;
      slab_backward<SCHEME>(algorithm, field + off, field + off + slab,
                            d_field + off, d_field + off + slab, g, z_plane,
                            z_entry, z_plane - z_entry, sg, ct);
    }
  }
  entry_bwd(g, r, e, ct, d_rays, P, p);
}

// as above, with the forward's outputs `out` (6, P) in place of the residual
template <int SCHEME>
__global__ void march_bwd_remarch_kernel(const float* __restrict__ rays,
                                         const float* __restrict__ texit,
                                         const float* __restrict__ out,
                                         const float* __restrict__ ct_out,
                                         const float4* __restrict__ field,
                                         float4* __restrict__ d_field,
                                         float* __restrict__ d_rays,
                                         long long P, MarchGeom g,
                                         int algorithm, int defect_iters) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const ChiefRay r = load_ray(rays, P, p);
  const Entry e = entry_advance(g, r.x0, r.y0, r.z0, r.cx, r.cy, r.cz);
  Cot6 ct = load_cot(ct_out, P, p);
  if (e.inside) {
    State5 st = {out[p], out[P + p], texit[p], texit[P + p],
                 texit[2 * P + p]};
    normalise_bwd(st.tx, st.ty, st.tz, ct);
    const int S = g.D - 1;
    const long long slab = (long long)g.H * g.W;
    for (int ks = 0; ks < S; ++ks) {
      float z_plane = landing_plane(g, ks);
      float z_entry = fminf(e.z, plane_above(g, ks));
      if (!(z_entry > z_plane)) continue;
      const long long off = (long long)ks * slab;
      const float4* lo = field + off;
      const float4* hi = lo + slab;
      const float h = z_plane - z_entry;
      // reverse reconstruction: exit state of the step -> its entry state
      Stages sg;
      if (algorithm == 1) {
        // fixed-point inverse of the Euler step (entry = exit - h k(entry)):
        // three evaluations as in the TPU kernel, two more for each defect
        // iteration that the grid's anisotropy asks for
        State5 guess =
            axpy(st, -h, rhs<SCHEME>(lo, hi, g, z_plane, st, z_plane));
        for (int it = 0; it < 2 + 2 * defect_iters; ++it)
          guess =
              axpy(st, -h, rhs<SCHEME>(lo, hi, g, z_plane, guess, z_entry));
        sg.s1 = guess;
      } else {
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
      slab_backward<SCHEME>(algorithm, lo, hi, d_field + off,
                            d_field + off + slab, g, z_plane, z_entry, h, sg,
                            ct);
      st = sg.s1;
    }
  }
  entry_bwd(g, r, e, ct, d_rays, P, p);
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
  const int threads = 128;
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
  const int threads = 128;
  long long blocks = (P + threads - 1) / threads;
  auto kernel = scheme == 2 ? march_bwd_remarch_kernel<2>
                            : march_bwd_remarch_kernel<1>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rays, texit, out, ct_out, reinterpret_cast<const float4*>(field),
      reinterpret_cast<float4*>(d_field), d_rays, P, g, algorithm,
      defect_iters);
  return (int)cudaGetLastError();
}

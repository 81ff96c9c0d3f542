// Volume preparation on the card: the gradient precompute of a density
// volume (K10) and the cubic B-spline prefilter (K11) with its transpose
// (K12).
//
// None of the three replaces a TPU kernel (pl.pallas_call).  They are the
// port's counterparts of the JAX package's host C++ module
// photon_tpu/native/photon_native.cpp (gradient_field, :89;
// bspline_prefilter_3d, :165), which that package runs on the host before it
// hands arrays to the TPU; the prefilter the JAX fast path actually runs is
// photon_tpu/ops/march_dense.py::bspline_prefilter_jax (f32, lax.scan), and
// K12 is what jax.grad takes through it.  The reference photon ran the
// prefilter as CUDA kernels too (CubicInterpolationCUDA).
//
// This library is built with -fmad=false (kernels.py): no product and sum
// fuse, so each kernel rounds as its plain PyTorch version, whose eager
// operations cannot fuse either.
//
// K10, photon_gradient_field.  (dn/dx, dn/dy, dn/dz, n-1) as float4 in the
// march's (D, H, W) layout from float32 n-1 in the NRRD's (W, H, D) layout:
// the float32 samples widened to double, central differences inside,
// second-order one-sided differences at the faces, one rounding to float32
// at the end (native's arithmetic and the plain version's,
// photon_tpu_torch/volume.py::gradient_field, bit for bit).  One thread an
// output voxel, x fastest: the 16-byte stores are coalesced, but the input's
// x stride is H*D floats, so a warp's 32 loads of one tap fall in 32
// different sectors (each sector's other seven floats serve the threads of
// the next z planes through L2).  That stride is the known cost; a
// shared-memory x-z tile would read the input coalesced.  Bound: bytes, 4 B
// in and 16 B out a voxel (5.2 MB at 64^3, 1.6 us at 3.35 TB/s; 2.7 GB at
// 512^3, 0.80 ms).
//
// K11, photon_bspline_prefilter.  Cubic B-spline coefficients of a
// (D, H, W, C) float32 field along axes 0, 1 and 2 in turn, the plain
// version's function and rounding (ops/march_dense.py::_prefilter_axis):
// pole z = sqrt(3) - 2, the causal start summed over the first `horizon`
// samples in order k = 0, 1, ..., the causal pass c_i = lam x_i + z c_{i-1},
// the anticausal start last (z c_{n-2} + c_{n-1}) and pass
// o_i = z (o_{i+1} - c_i), with the plain version's float32 constants (the
// wrapper passes them), so that K11 is the plain version bit for bit.  One
// thread a line (the two other spatial indices and the channel); the causal
// pass writes c into the output and the anticausal pass reads it back from
// the end and overwrites it.  The first axis runs out of place and the
// other two in place, so a call needs the field and one copy.  Lines along
// D and H are coalesced across a warp's threads; lines along W (stride C)
// are not: a warp's threads cover C channels of 32 / C rows.  Each line is
// read twice and written twice, in chunks of eight samples loaded before any
// is written.  Bound: bytes, one read and one write of the field an axis
// (25.2 MB at 64^3 x 4, 7.5 us; 12.9 GB at 512^3 x 4, 3.85 ms).
//
// K12, photon_bspline_prefilter_bwd.  K11's transpose, the axes in reverse
// order.  For one line with cotangent g: u_0 = g_0, u_{i+1} = g_{i+1} + z u_i
// and pbar_i = -z u_i (i <= n-2); the anticausal start sets
// pbar_{n-1} = last u_{n-1} and adds z pbar_{n-1} to pbar_{n-2}; then backwards
// xbar_i = lam pbar_i and pbar_{i-1} += z pbar_i (i = n-1 .. 1); finally
// xbar_k += z^k (lam pbar_0) for k < horizon.  Same layout, passes and
// bound as K11.  Neither K11 nor K12 uses atomics: two runs are equal.
//
// Plain C interface, no PyTorch headers (photon_tpu_torch/kernels.py).
#include <cuda_runtime.h>

namespace {

// the plain version's float32 constants for one axis (native.py,
// prefilter_constants); the same layout as native.py's _Pole
struct Pole {
  float zk[16];   // z^k rounded once to float32, k < horizon
  float lam;      // the gain (1 - z)(1 - 1/z)
  float z;        // the pole
  float last;     // z / (z^2 - 1), the anticausal start's factor
  int horizon;    // terms of the causal start (at most 16)
};

constexpr int kChunk = 8;

__device__ __forceinline__ double one_sided_lo(double s0, double s1, double s2,
                                               double h) {
  return (-1.5 * s0 + 2.0 * s1 - 0.5 * s2) / h;
}

__device__ __forceinline__ double one_sided_hi(double e1, double e2, double e3,
                                               double h) {
  return (1.5 * e1 - 2.0 * e2 + 0.5 * e3) / h;
}

// the derivative along one axis at index i of n, the samples at i - 1,
// i + 1 and the faces' neighbours read through `at(j)`
template <typename At>
__device__ __forceinline__ double axis_derivative(At at, long long i,
                                                  long long n, double h) {
  if (i == 0) return one_sided_lo(at(0), at(1), at(2), h);
  if (i == n - 1) return one_sided_hi(at(n - 1), at(n - 2), at(n - 3), h);
  return (at(i + 1) - at(i - 1)) / (2.0 * h);
}

__global__ void gradient_field_kernel(const float* __restrict__ data,
                                      float4* __restrict__ out, long long W,
                                      long long H, long long D, double dx,
                                      double dy, double dz) {
  const long long total = W * H * D;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < total; v += (long long)gridDim.x * blockDim.x) {
    const long long x = v % W;
    const long long y = (v / W) % H;
    const long long z = v / (W * H);
    // data[(x H + y) D + z]
    const float* col_x = data + y * D + z;              // x varies, stride H D
    const float* col_y = data + x * H * D + z;          // y varies, stride D
    const float* col_z = data + (x * H + y) * D;        // z varies, stride 1
    const double gx = axis_derivative(
        [&](long long j) { return (double)col_x[j * H * D]; }, x, W, dx);
    const double gy = axis_derivative(
        [&](long long j) { return (double)col_y[j * D]; }, y, H, dy);
    const double gz = axis_derivative(
        [&](long long j) { return (double)col_z[j]; }, z, D, dz);
    out[v] = make_float4((float)gx, (float)gy, (float)gz, col_z[z]);
  }
}

// the line of thread l: `stride` consecutive lines share their outer index
__device__ __forceinline__ long long line_base(long long l, long long n,
                                               long long stride) {
  return (l / stride) * n * stride + l % stride;
}

// K11 along one axis: in and out may be the same array
__global__ void prefilter_axis_kernel(const float* in, float* out,
                                      long long lines, long long n,
                                      long long stride, Pole p) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lines) return;
  const long long base = line_base(l, n, stride);
  const float* x = in + base;
  float* c = out + base;
  const float z = p.z, lam = p.lam;
  float acc = p.zk[0] * x[0];
  for (int k = 1; k < p.horizon; ++k) acc = acc + p.zk[k] * x[k * stride];
  float prev2 = 0.0f;            // c_{i-2}
  float prev = lam * acc;        // c_{i-1}
  c[0] = prev;
  float buf[kChunk];
  for (long long i0 = 1; i0 < n; i0 += kChunk) {
    const int m = (int)(n - i0 < kChunk ? n - i0 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = x[(i0 + j) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        const float ci = lam * buf[j] + z * prev;
        c[(i0 + j) * stride] = ci;
        prev2 = prev;
        prev = ci;
      }
  }
  // n >= 2: prev = c_{n-1}, prev2 = c_{n-2}
  float o = p.last * (z * prev2 + prev);
  c[(n - 1) * stride] = o;
  for (long long i1 = n - 2; i1 >= 0; i1 -= kChunk) {
    const int m = (int)(i1 + 1 < kChunk ? i1 + 1 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = c[(i1 - j) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        o = z * (o - buf[j]);
        c[(i1 - j) * stride] = o;
      }
  }
}

// K12 along one axis: g and xbar may be the same array
__global__ void prefilter_axis_bwd_kernel(const float* g, float* xbar,
                                          long long lines, long long n,
                                          long long stride, Pole p) {
  const long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lines) return;
  const long long base = line_base(l, n, stride);
  const float* gl = g + base;
  float* q = xbar + base;        // holds pbar, then xbar
  const float z = p.z, lam = p.lam;
  float buf[kChunk];
  // the anticausal pass's transpose, forwards: q_i = pbar_i = -z u_i
  float u = gl[0];
  for (long long i0 = 0; i0 < n - 1; i0 += kChunk) {
    const int m = (int)(n - 1 - i0 < kChunk ? n - 1 - i0 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = gl[(i0 + j + 1) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        q[(i0 + j) * stride] = -(z * u);
        u = buf[j] + z * u;
      }
  }
  // the anticausal start's transpose (n >= 2)
  float P = p.last * u;          // pbar_{n-1}
  q[(n - 2) * stride] = q[(n - 2) * stride] + z * P;
  // the causal pass's transpose, backwards
  for (long long i1 = n - 1; i1 >= 1; i1 -= kChunk) {
    const int m = (int)(i1 < kChunk ? i1 : kChunk);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) buf[j] = q[(i1 - j - 1) * stride];
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (j < m) {
        q[(i1 - j) * stride] = lam * P;
        P = buf[j] + z * P;
      }
  }
  // the causal start's transpose: P = pbar_0
  const float t = lam * P;
  q[0] = p.zk[0] * t;
  for (int k = 1; k < p.horizon; ++k)
    q[k * stride] = q[k * stride] + p.zk[k] * t;
}

constexpr int kThreads = 128;

int launch_axis(bool backward, const float* in, float* out,
                const long long dims[4], int axis, const Pole& p,
                cudaStream_t stream) {
  const long long n = dims[axis];
  long long stride = dims[3];
  for (int a = axis + 1; a < 3; ++a) stride *= dims[a];
  long long outer = 1;
  for (int a = 0; a < axis; ++a) outer *= dims[a];
  const long long lines = outer * stride;
  const long long blocks = (lines + kThreads - 1) / kThreads;
  if (backward)
    prefilter_axis_bwd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, lines, n, stride, p);
  else
    prefilter_axis_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        in, out, lines, n, stride, p);
  return (int)cudaGetLastError();
}

int prefilter(bool backward, const float* in, float* out, long long D,
              long long H, long long W, long long C, const Pole* poles,
              void* stream) {
  const long long dims[4] = {D, H, W, C};
  for (int a = 0; a < 3; ++a)
    if (dims[a] < 2 || poles[a].horizon < 1 || poles[a].horizon > 16 ||
        poles[a].horizon > dims[a])
      return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  // the forward takes axes 0, 1, 2 and the transpose 2, 1, 0; the first
  // launch reads `in`, the other two work in place on `out`
  for (int s = 0; s < 3; ++s) {
    const int axis = backward ? 2 - s : s;
    const int code = launch_axis(backward, s == 0 ? in : out, out, dims, axis,
                                 poles[axis], (cudaStream_t)stream);
    if (code != 0) return code;
  }
  return 0;
}

}  // namespace

// n_minus_1: (W, H, D) float32; out: (D, H, W, 4) float32.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int photon_gradient_field(const float* n_minus_1, float* out,
                                     long long W, long long H, long long D,
                                     double dx, double dy, double dz,
                                     void* stream) {
  if (W < 3 || H < 3 || D < 3) return (int)cudaErrorInvalidValue;
  const long long total = W * H * D;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  gradient_field_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      n_minus_1, reinterpret_cast<float4*>(out), W, H, D, dx, dy, dz);
  return (int)cudaGetLastError();
}

// field, out: (D, H, W, C) float32, distinct arrays; poles: three Pole
// records in host memory, one an axis (0 = D, 1 = H, 2 = W).  Three
// launches; returns the first nonzero cudaGetLastError(), else 0.
extern "C" int photon_bspline_prefilter(const float* field, float* out,
                                        long long D, long long H, long long W,
                                        long long C, const void* poles,
                                        void* stream) {
  return prefilter(false, field, out, D, H, W, C,
                   static_cast<const Pole*>(poles), stream);
}

// ct, out: (D, H, W, C) float32, distinct arrays: out = K11^T ct.
extern "C" int photon_bspline_prefilter_bwd(const float* ct, float* out,
                                            long long D, long long H,
                                            long long W, long long C,
                                            const void* poles, void* stream) {
  return prefilter(true, ct, out, D, H, W, C,
                   static_cast<const Pole*>(poles), stream);
}

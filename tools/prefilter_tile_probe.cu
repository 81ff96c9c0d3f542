// Where a tile of K11 / K12 (csrc/volume_prep.cu) spends its time: the tile
// kernels' own code, compiled into this file with stamps of the global
// timer at each block's start, after its copy in, after its passes and after
// its copy out, and the SM it ran on.  Built and driven by
// tools/prefilter_tile_probe.py.
#include "../photon_tpu_torch/csrc/volume_prep.cu"

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

// the stamps of one block: stamps[5 b ..] = start, copied in, passes done,
// copied out (ns), SM
struct Stamps {
  unsigned long long* stamps;
  __device__ __forceinline__ void operator()(int k) const {
    if (k == 3) __syncthreads();        // the whole tile copied out
    if (threadIdx.x == 0) {
      unsigned long long* s = stamps + 5 * (unsigned long long)blockIdx.x;
      s[k] = global_ns();
      if (k == 3) s[4] = sm_id();
    }
  }
};

// the tile kernels' body (prefilter_tile) with the stamps
template <bool kBackward>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
    stamped_tile_kernel(const float* in, float* out, TileGeom g, Pole p,
                        int vec, Stamps stamps) {
  extern __shared__ float4 tile_sm[];
  run_tile<kBackward>(in, out, g, p, vec, reinterpret_cast<float*>(tile_sm),
                      stamps);
}

}  // namespace

// One axis of K11 (backward = 0) or K12 through the stamped kernel, tiled and
// launched as the library's launcher does (launch_tile_kernel) from `plans`
// (native.py's AxisPlan records).  Returns cudaGetLastError().
extern "C" int probe_axis(int backward, const float* in, float* out,
                          long long D, long long H, long long W, long long C,
                          const void* poles, const void* plans, int axis,
                          unsigned long long* stamps) {
  const long long dims[4] = {D, H, W, C};
  const Pole& p = static_cast<const Pole*>(poles)[axis];
  const AxisPlan& plan = static_cast<const AxisPlan*>(plans)[axis];
  long long n, s, outer;
  axis_shape(dims, axis, n, s, outer);
  const Stamps st{stamps};
  return backward ? launch_tile_kernel(stamped_tile_kernel<true>, in, out, n,
                                       s, outer, plan, p, nullptr, st)
                  : launch_tile_kernel(stamped_tile_kernel<false>, in, out, n,
                                       s, outer, plan, p, nullptr, st);
}

// blocks an SM, registers and local bytes of prefilter_tile_kernel and
// prefilter_tile_bwd_kernel at `bytes` of dynamic shared memory: out[0..5]
extern "C" int probe_occupancy(int bytes, int* out) {
  const void* ks[2] = {(const void*)prefilter_tile_kernel,
                       (const void*)prefilter_tile_bwd_kernel};
  for (int i = 0; i < 2; ++i) {
    cudaFuncSetAttribute(ks[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes > 48 * 1024 ? bytes : 48 * 1024);
    int blocks = -1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ks[i],
                                                  kTileThreads, bytes);
    cudaFuncAttributes a;
    cudaFuncGetAttributes(&a, ks[i]);
    out[3 * i] = blocks;
    out[3 * i + 1] = a.numRegs;
    out[3 * i + 2] = (int)a.localSizeBytes;
  }
  return (int)cudaGetLastError();
}

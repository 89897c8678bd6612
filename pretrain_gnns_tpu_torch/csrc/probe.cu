// Build-and-launch probe (P) for Hopper (sm_90a): out = 2 * x on a small
// float32 matrix whose rows are 300 wide.
//
// Replaces the lowering probe of the Pallas TPU package,
// pretrain_gnns_tpu/ops/pallas_spmm.py::_nopad_ok: there a one-time
// compile of `out = 2 * x` on [8, 300] told whether the TPU compiler takes
// a trailing dimension that is no multiple of its 128 lanes, and the
// kernels padded their features to 128 when it did not. Every kernel of
// this package takes unpadded rows (a lane per feature in 32-wide tiles,
// the ragged last tile masked), so there is no second layout to give way
// to: the probe runs that access pattern once per process, before the
// first kernel launch, and a failed build, launch or comparison stops the
// run (ops/_build.probe).
//
// What bounds it: 19 KB in and out, so the launch itself; no bound by
// bytes or operations is worth stating.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;  // feature tile: one warp wide
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / FT;

// One CTA per 32-wide feature tile, a lane per feature, the warps striding
// the rows: the layout of every aggregation kernel of the package.
__global__ void __launch_bounds__(THREADS)
probe_scale2_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int rows, int F) {
  const int lane = threadIdx.x % FT;
  const int warp = threadIdx.x / FT;
  const int f = blockIdx.x * FT + lane;
  if (f >= F) return;
  for (int r = warp; r < rows; r += WARPS)
    out[(long long)r * F + f] = 2.f * x[(long long)r * F + f];
}

}  // namespace

extern "C" {

// Writes out [rows, F] = 2 * x [rows, F]. Returns the first CUDA error, 0
// if none.
int pgt_probe_scale2(const float* x, float* out, int rows, int F,
                     void* stream) {
  if (rows <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  probe_scale2_kernel<<<(F + FT - 1) / FT, THREADS, 0,
                        (cudaStream_t)stream>>>(x, out, rows, F);
  return (int)cudaGetLastError();
}

}  // extern "C"

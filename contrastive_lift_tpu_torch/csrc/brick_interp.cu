// Brick-atlas trilinear density for Hopper (sm_90a).
//
// Replaces the repository's only TPU kernel,
// contrastive_lift_tpu/ops/pallas_interp.py::brick_interp (kernel body
// _interp_kernel), and its XLA twin that production renders call,
// contrastive_lift_tpu/ops/fused_grid.py::sample_density_brick.
//
// An atlas row holds the 5x5x5 corner lattice of a 4-voxel brick (lane
// a*25+b*5+c, lanes 125-127 zero). The value at in-brick position (fx,fy,fz)
// is sum over lanes of row[lane] * hat(fx-a) * hat(fy-b) * hat(fz-c) with
// hat(t) = max(0, 1-|t|). The TPU kernel reduces all 128 lanes because the
// TPU has no dynamic lane indexing; a GPU thread reads only the 2x2x2 lanes
// whose hat weight can be non-zero, a in {a0, a0+1} with
// a0 = clamp(floor(fx), 0, 3). The weights stay in the hat form, so samples
// outside the box get the same clamped weights as the lane form (not linear
// extrapolation). The sum runs over 8 terms instead of 128, in another order,
// so results agree with the lane form to rounding, not bit for bit.
//
// What bounds it on an H100: one thread per sample, no tensor-core work.
// Per sample the fused entry reads 12 B of coordinates and writes 4 B to
// device memory and gathers 8 floats from one 512 B atlas row (about 4 L2
// sectors). At the r5b checkpoint the atlas is 33*33*30 rows * 512 B =
// 16.7 MB, which stays resident in the 50 MB L2, so the kernel is bound by
// memory and L2 traffic, not arithmetic (about 60 flops per sample).
//
// Built by nvcc into a shared library with a plain C interface and bound with
// ctypes (contrastive_lift_tpu_torch/ops/brick_interp.py). Each entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// Lowest lattice index whose hat weight can be non-zero, in [0, 3].
__device__ __forceinline__ int lattice_lo(float f) {
  return static_cast<int>(fminf(fmaxf(floorf(f), 0.0f), 3.0f));
}

__device__ __forceinline__ float interp_row(const float* __restrict__ row,
                                            float fx, float fy, float fz) {
  const int a0 = lattice_lo(fx), b0 = lattice_lo(fy), c0 = lattice_lo(fz);
  float acc = 0.0f;
#pragma unroll
  for (int da = 0; da < 2; ++da) {
    const int a = a0 + da;
    const float wa = hat(fx - static_cast<float>(a));
#pragma unroll
    for (int db = 0; db < 2; ++db) {
      const int b = b0 + db;
      const float wab = wa * hat(fy - static_cast<float>(b));
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int c = c0 + dc;
        const float w = wab * hat(fz - static_cast<float>(c));
        acc += __ldg(row + a * 25 + b * 5 + c) * w;
      }
    }
  }
  return acc;
}

__global__ void brick_interp_kernel(const float* __restrict__ rows,
                                    const float* __restrict__ frac,
                                    float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = interp_row(rows + i * kLanes, frac[3 * i], frac[3 * i + 1],
                      frac[3 * i + 2]);
}

// Mirrors contrastive_lift_tpu/ops/fused_grid.py::_brick_coords: the
// sample's clamped cell picks the brick, frac is the position inside it.
__global__ void sample_density_brick_kernel(const float* __restrict__ atlas,
                                            const float* __restrict__ xyz,
                                            float* __restrict__ out, int64_t n,
                                            int gx, int gy, int gz,
                                            float splus_shift) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int by = (gy - 1 + 3) / 4;
  const int bz = (gz - 1 + 3) / 4;
  const float g[3] = {static_cast<float>(gx), static_cast<float>(gy),
                      static_cast<float>(gz)};
  float f[3];
  int brick[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float p = (xyz[3 * i + k] + 1.0f) * 0.5f * (g[k] - 1.0f);
    const float cell = fminf(fmaxf(floorf(p), 0.0f), g[k] - 2.0f);
    brick[k] = static_cast<int>(cell) / 4;
    f[k] = p - 4.0f * static_cast<float>(brick[k]);
  }
  const int64_t row = (static_cast<int64_t>(brick[0]) * by + brick[1]) * bz + brick[2];
  out[i] = interp_row(atlas + row * kLanes, f[0], f[1], f[2]) + splus_shift;
}

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int brick_interp_launch(const float* rows, const float* frac,
                                   float* out, int64_t n, void* stream) {
  brick_interp_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(rows, frac, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_density_brick_launch(const float* atlas, const float* xyz,
                                           float* out, int64_t n, int gx, int gy,
                                           int gz, float splus_shift,
                                           void* stream) {
  sample_density_brick_kernel<<<blocks_for(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      atlas, xyz, out, n, gx, gy, gz, splus_shift);
  return static_cast<int>(cudaGetLastError());
}

// Histogram equalization statistics of the scene detector, for Hopper
// (sm_90a).  Built by facerec_torch/ops/_build.py into a shared library
// with a plain C interface and bound with ctypes
// (facerec_torch/ops/equalize.py).
//
// Replaces the three Pallas TPU kernels of
// facerec_tpu/ops/pallas/equalize.py:
//   - _fused_kernel  (launched by _equalize_fused, one frame per step)
//   - _hist_kernel   (launched by _equalize_tiled, per-frame counts)
//   - _eq_kernel     (launched by _equalize_tiled, cdf lookup)
// The TPU split between the fused and tiled forms is a VMEM residency
// decision; here one pair of kernels serves every plane size:
//   hist256     = _hist_kernel, and the first half of _fused_kernel
//   cum_lookup  = _eq_kernel, and the second half of _fused_kernel
// The radix-16 one-hot matrix formulation of the TPU kernels exists
// only because the TPU has no scatter; it is not carried over.
//
// Input: y (B, R, W) f32 luminance, rows padded with -1 (padding is
// any y < 0).  A pixel's bin is clip(int(y), 0, 255).
// Outputs: hist (B, 256) int32 counts (zeroed by the caller), cum
// (B, 256) f32 inclusive cumulative counts, eq (B, R, W) f32 holding
// cum[bin] per pixel and 0 at padding.  Counts are integer atomics, so
// the result is exact and the same on every run.
//
// Bound: device-memory bytes.  Both passes do O(1) integer work per
// pixel; hist256 reads the plane once, cum_lookup reads it again and
// writes eq once.  At (128, 384, 768) f32 (a 576x768 film after its
// 2:1 crop, one 128-frame block) the plane is 151 MB, so the block
// moves 3 x 151 MB = 453 MB: 0.135 ms at the H100 SXM's 3.35 TB/s.
// The function itself (one read of y, one write of eq) needs 302 MB,
// 0.090 ms; chip_smoke.py reports that bound beside the measured time.
//
// Left for a later change: fusing the u8 RGB -> luminance read into
// hist256 (so no f32 plane is written at all), and keeping the plane
// on chip between the two passes (a thread-block cluster with
// distributed shared memory holding one frame).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;   // cum_lookup's scan needs one thread a bin

__device__ __forceinline__ int bin_of(float v) {
    int b = (int)v;   // truncation, as int32(y) in the reference
    return min(max(b, 0), kBins - 1);
}

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const float* __restrict__ y, int* __restrict__ hist,
               int rows, int width, int rows_per_cta) {
    __shared__ int sh[kBins];
    const int frame = blockIdx.y;
    sh[threadIdx.x] = 0;
    __syncthreads();

    const int r0 = blockIdx.x * rows_per_cta;
    const int r1 = min(r0 + rows_per_cta, rows);
    const float* base = y + (size_t)frame * rows * width;
    const size_t end = (size_t)r1 * width;
    for (size_t i = (size_t)r0 * width + threadIdx.x; i < end;
         i += kThreads) {
        const float v = base[i];
        if (!(v < 0.f)) atomicAdd(&sh[bin_of(v)], 1);
    }
    __syncthreads();
    const int c = sh[threadIdx.x];
    if (c) atomicAdd(&hist[frame * kBins + threadIdx.x], c);
}

__global__ void __launch_bounds__(kThreads)
cum_lookup_kernel(const float* __restrict__ y,
                  const int* __restrict__ hist, float* __restrict__ eq,
                  float* __restrict__ cum, int rows, int width,
                  int rows_per_cta) {
    __shared__ int sc[kBins];
    const int frame = blockIdx.y;
    const int t = threadIdx.x;
    sc[t] = hist[frame * kBins + t];
    __syncthreads();
    // inclusive Hillis-Steele scan over the 256 bins, in int32
    for (int off = 1; off < kBins; off <<= 1) {
        const int v = t >= off ? sc[t - off] : 0;
        __syncthreads();
        sc[t] += v;
        __syncthreads();
    }
    if (blockIdx.x == 0) cum[frame * kBins + t] = (float)sc[t];

    const int r0 = blockIdx.x * rows_per_cta;
    const int r1 = min(r0 + rows_per_cta, rows);
    const size_t off = (size_t)frame * rows * width;
    const size_t end = (size_t)r1 * width;
    for (size_t i = (size_t)r0 * width + t; i < end; i += kThreads) {
        const float v = y[off + i];
        eq[off + i] = v < 0.f ? 0.f : (float)sc[bin_of(v)];
    }
}

}  // namespace

extern "C" {

// Both functions launch on `stream`, do not synchronise, allocate
// nothing, and return the launch's cudaError_t (0 on success).

int fr_hist256(const float* y, int* hist, int frames, int rows,
               int width, int rows_per_cta, cudaStream_t stream) {
    const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, frames);
    hist256_kernel<<<grid, kThreads, 0, stream>>>(y, hist, rows, width,
                                                 rows_per_cta);
    return (int)cudaGetLastError();
}

int fr_cum_lookup(const float* y, const int* hist, float* eq, float* cum,
                  int frames, int rows, int width, int rows_per_cta,
                  cudaStream_t stream) {
    const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, frames);
    cum_lookup_kernel<<<grid, kThreads, 0, stream>>>(
        y, hist, eq, cum, rows, width, rows_per_cta);
    return (int)cudaGetLastError();
}

}  // extern "C"

// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + g_t,
// elementwise over the width, with a float32 carry.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::_rglru_kernel and
// computes what it computes: a, g [B, S, W] (float32 or bf16, contiguous) ->
// y [B, S, W] in the same type, h starting at zero.  The gates (sigmoids,
// softplus, exp, sqrt(1 - a^2)) are computed outside by the caller, as the
// TPU wrapper's caller does; the final state is y[:, -1] in float32, taken
// by the wrapper.  Each step is a product then a sum, each rounded to
// nearest (__fmul_rn, __fadd_rn: no contraction into an FMA), so the kernel
// gives the plain version (kernels/ref.py::linear_recurrence) bit for bit.
//
// Layout.  One thread per (batch row, channel) walks the S steps in order;
// a CTA of 128 threads covers 128 neighbouring channels of one batch row, so
// every load and store of a step is coalesced across the warp.  The loads of
// the next U steps of a and g are issued before the U dependent steps of the
// current group run, so that 2U loads a thread are in flight while the
// carry's chain of rounded products and sums goes on.
//
// Bound.  At the main path's shape ([4, 4096, 4096] float32) the function
// reads a and g once and writes y once: 805 MB, 0.240 ms at 3.35 TB/s; its
// 6.7e7 multiply-adds take nothing by comparison.  It is bound by bytes.
// This first version has B * W / 128 CTAs (128 at the serve shape, about
// four warps on each of 132 SMs), so it can keep only ~2 MB of loads in
// flight and is bound by memory latency; a split of the steps into chunks
// (local scans, then the carries) is the way to more parallelism.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ g, T* __restrict__ y,
                  int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t off = static_cast<size_t>(blockIdx.y) * S * W + w;
  const size_t step = static_cast<size_t>(W);
  a += off;
  g += off;
  y += off;

  const int full = S / kUnroll * kUnroll;
  float an[kUnroll], gn[kUnroll];
  if (full > 0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      an[i] = to_float(a[i * step]);
      gn[i] = to_float(g[i * step]);
    }
  }
  float h = 0.0f;
  for (int t0 = 0; t0 < full; t0 += kUnroll) {
    float ac[kUnroll], gc[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ac[i] = an[i];
      gc[i] = gn[i];
    }
    if (t0 + kUnroll < full) {  // the next group's loads, ahead of this group's chain
      const size_t next = static_cast<size_t>(t0 + kUnroll) * step;
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        an[i] = to_float(a[next + i * step]);
        gn[i] = to_float(g[next + i * step]);
      }
    }
    const size_t base = static_cast<size_t>(t0) * step;
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      h = __fadd_rn(__fmul_rn(ac[i], h), gc[i]);
      y[base + i * step] = from_float<T>(h);
    }
  }
  for (int t = full; t < S; ++t) {
    const size_t at = static_cast<size_t>(t) * step;
    h = __fadd_rn(__fmul_rn(to_float(a[at]), h), to_float(g[at]));
    y[at] = from_float<T>(h);
  }
}

template <typename T>
int launch(const void* a, const void* g, void* y, int B, int S, int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(g), static_cast<T*>(y), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (ctypes).  a, g and y are dense [B, S, W] of one type.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rglru_scan_f32(const void* a, const void* g, void* y, int B, int S, int W,
                              void* stream) {
  return launch<float>(a, g, y, B, S, W, stream);
}

extern "C" int rglru_scan_bf16(const void* a, const void* g, void* y, int B, int S, int W,
                               void* stream) {
  return launch<__nv_bfloat16>(a, g, y, B, S, W, stream);
}

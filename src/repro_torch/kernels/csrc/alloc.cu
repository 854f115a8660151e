// Fused heSRPT allocate for Hopper (sm_90a): ranks -> Thm-7 theta -> chips.
//
// Replaces the TPU kernel repro/kernels/alloc.py::_alloc_kernel (Pallas).
// One CTA per sweep cell of a [cells, M] batch, one thread per job; the
// block is P = next power of two >= max(M, 32) threads (P <= 1024).
//
// What bounds it: O(M^2) comparisons per cell per event (two stable-
// position passes) against shared memory, plus ~20 block reductions; the
// device traffic is only x in, theta and chips out (~3.8 MB per launch at
// [192, 1000] in f64).  So it is compute and shared-memory bound, not
// bandwidth bound.  The design keeps every intermediate in registers or
// shared memory (16 KB at P = 1024 in f64) and launches once per event
// for all cells; a shared-memory sort in place of the counting passes is
// later work.
//
// Exactness: the result must equal the plain PyTorch version
// (repro_torch/kernels/alloc.py::hesrpt_alloc_fused_ref) bit for bit.
// - No multiply-add contraction the plain version's separate ops do not
//   make: every product, sum and difference here is a __*_rn intrinsic,
//   which nvcc never fuses.  The build keeps nvcc's default -fmad=true on
//   purpose: libdevice's pow is compiled with the caller's flags, and under
//   -fmad=false theta differed from the plain version's by one ulp on 158
//   of 46.08M entries (H100, CUDA 12.9; tools/alloc_fmad_check.py),
//   against 0 with the default.
// - bracket_pow takes the same cases as policies.bracket_pow: products for
//   c in {1, 2, 3}, device pow otherwise.
// - The one floating-point sum (the oversubscription renormalizer) is the
//   pairwise tree over P entries that kernels/alloc.py::pairwise_sum
//   spells out; every other reduction is an exact integer sum.
// - Stable positions by comparison counting,
//   pos_i = #{j : key_j < key_i or (key_j == key_i and j < i)},
//   equal a stable argsort's positions, inf keys included.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 1024;

template <typename T> __device__ __forceinline__ T inf_value();
template <> __device__ __forceinline__ double inf_value<double>() { return CUDART_INF; }
template <> __device__ __forceinline__ float inf_value<float>() { return CUDART_INF_F; }

// Round-to-nearest products, sums and differences that nvcc never fuses
// into a multiply-add (the plain version's ops are separate kernels).
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// mode: 1, 2, 3 -> b^mode by products; 0 -> device pow(b, c).
template <typename T>
__device__ __forceinline__ T bracket_pow(T b, T c, int mode) {
  if (mode == 1) return b;
  if (mode == 2) return mul_rn(b, b);
  if (mode == 3) return mul_rn(mul_rn(b, b), b);
  return pow(b, c);
}

// Exact integer sum over the block, broadcast to every thread.  blockDim.x
// is a multiple of 32, so every warp is full.
__device__ int block_sum(int v, int* sred) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous call's readers are done with sred
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) total += sred[w];
  return total;
}

// Pairwise tree sum over blockDim.x (a power of two) entries:
// level k holds s[i] = s[2i] + s[2i+1] of level k-1.
template <typename T>
__device__ T pairwise_sum(T v, T* sbuf) {
  const int i = threadIdx.x;
  __syncthreads();
  sbuf[i] = v;
  __syncthreads();
  for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
    T a = T(0);
    if (i < s) a = add_rn(sbuf[2 * i], sbuf[2 * i + 1]);
    __syncthreads();
    if (i < s) sbuf[i] = a;
    __syncthreads();
  }
  return sbuf[0];
}

// Stable-argsort position of this thread's key among the row's M keys.
template <typename T>
__device__ int stable_pos(T key, int M, T* skey) {
  const int i = threadIdx.x;
  __syncthreads();
  skey[i] = key;
  __syncthreads();
  int pos = 0;
  for (int j = 0; j < M; ++j) {
    const T kj = skey[j];
    pos += (kj < key) || (kj == key && j < i);
  }
  return pos;
}

template <typename T>
__global__ void hesrpt_alloc_kernel(const T* __restrict__ x, T* __restrict__ theta_out,
                                    int* __restrict__ chips_out, int M, double c_in,
                                    int n_chips, int min_chips) {
  __shared__ T skey[kMaxThreads];
  __shared__ T sbuf[kMaxThreads];
  __shared__ int sred[32];

  const int i = threadIdx.x;
  const bool live = i < M;
  const size_t at = static_cast<size_t>(blockIdx.x) * M + i;
  const T inf = inf_value<T>();
  const T zero = T(0);

  // Descending-size ranks of the active jobs (1-based, 0 = inactive).
  const T xi = live ? x[at] : zero;
  const bool active = live && xi > zero;
  const int pos_x = stable_pos<T>(active ? -xi : inf, M, skey);
  const int rank = active ? pos_x + 1 : 0;
  const int m = block_sum(active ? 1 : 0, sred);

  // Thm-7 brackets: the op sequence of policies.hesrpt_theta_from_ranks.
  const int mode = c_in == 1.0 ? 1 : c_in == 2.0 ? 2 : c_in == 3.0 ? 3 : 0;
  const T c = static_cast<T>(c_in);
  const T rf = static_cast<T>(rank);
  const T m_safe = static_cast<T>(m > 1 ? m : 1);
  const T hi = bracket_pow<T>(rf / m_safe, c, mode);
  const T lo = bracket_pow<T>(sub_rn(rf, T(1)) / m_safe, c, mode);
  const T theta = active ? sub_rn(hi, lo) : zero;
  if (live) theta_out[at] = theta;

  if (n_chips <= 0 || min_chips <= 0) {  // uniform across the block
    if (live) chips_out[at] = 0;
    return;
  }

  // Oversubscription cut in rank space: keep the cap highest ranks.
  const int cap = n_chips / min_chips;
  const bool active0 = theta > zero;
  const int n_active = block_sum(active0 ? 1 : 0, sred);
  const bool servable = active0 && rank > m - cap;
  const bool over = n_active * min_chips > n_chips;
  const T sub = servable ? theta : zero;
  const T tot = pairwise_sum<T>(sub, sbuf);
  const T theta_eff = over ? (tot > zero ? sub / tot : zero) : theta;
  const bool active_q = theta_eff > zero;

  // Largest-remainder rounding with a min-chips floor.
  const T raw = mul_rn(theta_eff, static_cast<T>(n_chips));
  const T fl = floor(raw);
  const T frac = sub_rn(raw, fl);
  int base = active_q ? static_cast<int>(fmax(fl, static_cast<T>(min_chips))) : 0;

  const int over_by = block_sum(base, sred) - n_chips;
  const int K = over_by > 0 ? over_by : 0;
  const int capj = base > min_chips ? base - min_chips : 0;

  // Full trim rounds: smallest r with sum(min(capj, r)) >= K, by bisection.
  const int n_bits = 32 - __clz(n_chips + 1);
  int lo_r = 0, hi_r = n_chips;
  for (int b = 0; b < n_bits; ++b) {
    const int mid = (lo_r + hi_r) / 2;
    const bool ge = block_sum(capj < mid ? capj : mid, sred) >= K;
    lo_r = ge ? lo_r : mid + 1;
    hi_r = ge ? mid : hi_r;
  }
  const int r_star = lo_r;
  const int r_full = r_star - 1 > 0 ? r_star - 1 : 0;
  const int full = capj < r_full ? capj : r_full;
  const int extra_needed = K - block_sum(full, sred);
  const bool elig = capj >= (r_star > 1 ? r_star : 1);

  // One stable pass serves the partial trim round (K > 0) or the leftover
  // chips (K == 0): the two are mutually exclusive.
  const T key_q = K > 0 ? (elig ? frac : inf) : (active_q ? -frac : inf);
  const int pos_q = stable_pos<T>(key_q, M, skey);
  base = base - full - ((elig && pos_q < extra_needed) ? 1 : 0);
  const int remainder = n_chips - block_sum(base, sred);
  const int chips = base + ((active_q && pos_q < remainder) ? 1 : 0);
  if (live) chips_out[at] = chips;
}

template <typename T>
int launch(const void* x, void* theta, void* chips, int cells, int M, int threads,
           double c, int n_chips, int min_chips, void* stream) {
  hesrpt_alloc_kernel<T><<<cells, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(theta), static_cast<int*>(chips), M, c,
      n_chips, min_chips);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int hesrpt_alloc_f64(const void* x, void* theta, void* chips, int cells, int M, int threads,
                     double c, int n_chips, int min_chips, void* stream) {
  return launch<double>(x, theta, chips, cells, M, threads, c, n_chips, min_chips, stream);
}

int hesrpt_alloc_f32(const void* x, void* theta, void* chips, int cells, int M, int threads,
                     double c, int n_chips, int min_chips, void* stream) {
  return launch<float>(x, theta, chips, cells, M, threads, c, n_chips, min_chips, stream);
}

}  // extern "C"

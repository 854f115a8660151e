// One event step of the fluid loop for Hopper (sm_90a): everything in
// core/engine.py::run's step after the allocate, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA, which
// fuses it inside jit / lax.scan (repro/core/engine.py::run's scan body).
// The port's eager loop ran it as ~45 PyTorch ops a step, each a pass over
// the [cells, M] state; this kernel is one pass.
//
// Layout: one CTA per cell row, its threads striding over the row, so any M
// (no job limit).  Each thread keeps its first kCache jobs' sizes and rates
// in registers between the two passes (M <= 1024 at 256 threads: the
// sweeps' 1000 jobs); jobs past those are read again in the second pass.
// - Pass 1: each active job's time to depart x / rate (rate > 0), and the
//   block's argmin: a warp shuffle reduction, then one across the warps.
// - Thread 0: the next arrival, dt, the admit / departure flags, the new
//   clock and the admission count (a search of the sorted arrival row past
//   the admitted jobs); the row's t, i and dt.  Under a drifting p the
//   row's next regime boundary is a third candidate event (t_next_drift,
//   null without drift); ties go to the arrival, then the departure, then
//   the boundary, as in the plain version.
// - Pass 2: the new sizes with the departure and the tol clamp, the
//   completion time of each job that leaves (times is written only there),
//   and the next step's allocate input x_act.
//
// What bounds it: device traffic.  x read and the new x and x_act written
// once, the rate read once for the active jobs: at [6144, 1000] f64, at
// most 196.6 MB, 58.7 us at 3.35 TB/s.  The arithmetic is a few ops a job.
// A CTA's chain of dependent loads is what is left: x, then the rate of the
// active jobs, then after the argmin the admission count.  Thread 0 fetches
// the next two arrivals with the row, so the count needs no further load
// unless three or more jobs arrive at one time (a binary search over the
// whole row took log2 M dependent loads: 0.110 ms a step at [6144, 1000]).
//
// Exactness: the result equals the plain PyTorch version
// (repro_torch/kernels/event_step.py::event_step_ref) bit for bit.
// - Every quotient, product, sum and difference is a __*_rn intrinsic:
//   nvcc never contracts them, so x - dt * rate rounds twice, as the plain
//   version's two ops do.
// - The argmin keeps torch.argmin's order: NaN first, then the smaller
//   value, ties to the smaller index; a total order, so the reduction's
//   shape does not matter.  The amin is the argmin's value.
// - clamp(min=0) and torch.minimum propagate NaN, then take fmax / fmin, as
//   PyTorch's CUDA functors do (clamp0, min_nan).
// - The admission count is the one count of a sorted row's arrivals that
//   are <= t_new, which torch.searchsorted's binary search finds too
//   (the loop's rows are sorted; a NaN arrival would make the two searches
//   part, and neither answer would mean anything).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kCache = 4;  // jobs a thread keeps in registers between the passes
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ T inf_value();
template <> __device__ __forceinline__ double inf_value<double>() { return CUDART_INF; }
template <> __device__ __forceinline__ float inf_value<float>() { return CUDART_INF_F; }

__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// clamp(v, min=0) and torch.minimum(a, b) as PyTorch's CUDA functors: NaN
// propagates.
template <typename T>
__device__ __forceinline__ T clamp0(T v) { return isnan(v) ? v : fmax(v, T(0)); }

template <typename T>
__device__ __forceinline__ T min_nan(T a, T b) {
  return isnan(a) ? a : isnan(b) ? b : fmin(a, b);
}

// torch.argmin's order (LessOrNan): whether (a, ia) comes before (b, ib).
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

template <typename T>
__device__ __forceinline__ void consider(T v, int j, T& best, int& best_j) {
  if (before(v, j, best, best_j)) {
    best = v;
    best_j = j;
  }
}

// Pass 1 for one job: its time to depart, if it is active with rate > 0.
template <typename T>
__device__ __forceinline__ void departure(T xj, T rj, bool active, int j, T& best,
                                          int& best_j) {
  if (active && rj > T(0)) consider(div_rn(xj, rj), j, best, best_j);
}

// Pass 2 for one job: its new size, its completion time when it leaves, and
// the next step's x_act.
template <typename T>
__device__ __forceinline__ void advance(T xj, T rj, bool active, int j, T dt, T tol, T t_new,
                                        int dep_j, long long i_next, size_t at,
                                        T* __restrict__ times, T* __restrict__ x_out,
                                        T* __restrict__ x_act_out) {
  T xn = xj;
  if (active) {
    xn = sub_rn(xj, mul_rn(dt, rj));
    if (j == dep_j || xn <= tol) xn = T(0);
    if (xn == T(0)) times[at] = t_new;
  }
  x_out[at] = xn;
  x_act_out[at] = (j < i_next && xn > T(0)) ? xn : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fluid_event_step_kernel(const T* __restrict__ x, const T* __restrict__ rate,
                        const T* __restrict__ arr, const T* __restrict__ t,
                        const long long* __restrict__ i_in, const T* __restrict__ tol,
                        const T* __restrict__ t_next_drift, T* __restrict__ times,
                        T* __restrict__ x_out, T* __restrict__ x_act_out, T* __restrict__ t_out,
                        long long* __restrict__ i_out, T* __restrict__ dt_out, int M) {
  __shared__ T s_best[kMaxWarps];
  __shared__ int s_best_j[kMaxWarps];
  __shared__ T s_dt, s_t_new;
  __shared__ int s_dep_j;
  __shared__ long long s_i_next;

  const int cell = blockIdx.x;
  const size_t row = static_cast<size_t>(cell) * M;
  const T inf = inf_value<T>();
  const long long i0 = i_in[cell];
  // Thread 0 fetches the row's clock, its next two arrivals and its next
  // boundary while the block reads the row, so its tail below waits on no
  // load in most steps.
  T t0 = T(0), t_arr = inf, t_arr2 = inf, t_drift = inf;
  if (threadIdx.x == 0) {
    t0 = t[cell];
    if (i0 < M) t_arr = arr[row + i0];
    if (i0 + 1 < M) t_arr2 = arr[row + i0 + 1];
    if (t_next_drift != nullptr) t_drift = t_next_drift[cell];
  }

  // Pass 1: the block's first argmin of the times to depart.
  T best = inf;
  int best_j = M;  // past every job: any real job wins a tie
  T xc[kCache], rc[kCache];
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    xc[k] = T(0);
    rc[k] = T(0);
    if (j < M) {
      xc[k] = x[row + j];
      const bool active = j < i0 && xc[k] > T(0);
      if (active) rc[k] = rate[row + j];
      departure(xc[k], rc[k], active, j, best, best_j);
    }
  }
  for (int j = threadIdx.x + kCache * blockDim.x; j < M; j += blockDim.x) {
    const T xj = x[row + j];
    const bool active = j < i0 && xj > T(0);
    departure(xj, active ? rate[row + j] : T(0), active, j, best, best_j);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T v = __shfl_down_sync(kFull, best, o);
    const int vj = __shfl_down_sync(kFull, best_j, o);
    consider(v, vj, best, best_j);
  }
  if ((threadIdx.x & 31) == 0) {
    s_best[threadIdx.x >> 5] = best;
    s_best_j[threadIdx.x >> 5] = best_j;
  }
  __syncthreads();

  // The row's event: the op sequence of event_step_ref after the argmin.
  if (threadIdx.x == 0) {
    const int n_warps = blockDim.x >> 5;
    for (int w = 1; w < n_warps; ++w) consider(s_best[w], s_best_j[w], best, best_j);
    const T dt_dep = best;
    const T dt_arr = clamp0(sub_rn(t_arr, t0));
    T dt = min_nan(dt_dep, dt_arr);
    const bool drift = t_next_drift != nullptr;
    const T dt_drift = drift ? clamp0(sub_rn(t_drift, t0)) : inf;
    if (drift) dt = min_nan(dt, dt_drift);
    const bool any_event = isfinite(dt);
    if (!any_event) dt = T(0);
    // Without drift the comparisons are the plain version's two-way ones.
    const bool admit = any_event && dt_arr <= (drift ? min_nan(dt_dep, dt_drift) : dt_dep);
    const bool take_dep = any_event && dt_dep <= (drift ? min_nan(dt_arr, dt_drift) : dt_arr);
    const bool take_drift = drift && any_event && !admit && !take_dep;
    const T t_new = admit ? t_arr : take_drift ? t_drift : add_rn(t0, dt);
    // max(i, searchsorted(arr, t_new, right=True)): the count of the
    // sorted row's arrivals <= t_new, searched only past i0 (the count is
    // at most i0 when arr[i0] > t_new), galloping from i0 + 1 and then
    // bisecting.  A step admits one job, or several arriving at once.
    long long i_next = i0;
    if (i0 < M && !(t_arr > t_new)) {
      int lo = static_cast<int>(i0) + 1, hi = lo, stride = 1;  // arr[lo - 1] <= t_new
      T next = t_arr2;
      while (hi < M && !(next > t_new)) {
        lo = hi + 1;
        hi = lo + stride;
        stride <<= 1;
        if (hi < M) next = arr[row + hi];
      }
      if (hi > M) hi = M;
      while (lo < hi) {  // the first index in [lo, hi) whose arrival is > t_new
        const int mid = lo + ((hi - lo) >> 1);
        if (!(arr[row + mid] > t_new)) lo = mid + 1;
        else hi = mid;
      }
      i_next = lo;
    }
    s_dt = dt;
    s_t_new = t_new;
    s_dep_j = take_dep ? best_j : -1;
    s_i_next = i_next;
    t_out[cell] = t_new;
    i_out[cell] = i_next;
    dt_out[cell] = dt;
  }
  __syncthreads();

  // Pass 2: every job advances by dt.
  const T dt = s_dt, t_new = s_t_new, row_tol = tol[cell];
  const int dep_j = s_dep_j;
  const long long i_next = s_i_next;
#pragma unroll
  for (int k = 0; k < kCache; ++k) {
    const int j = threadIdx.x + k * blockDim.x;
    if (j < M) {
      const bool active = j < i0 && xc[k] > T(0);
      advance(xc[k], rc[k], active, j, dt, row_tol, t_new, dep_j, i_next, row + j, times,
              x_out, x_act_out);
    }
  }
  for (int j = threadIdx.x + kCache * blockDim.x; j < M; j += blockDim.x) {
    const T xj = x[row + j];
    const bool active = j < i0 && xj > T(0);
    advance(xj, active ? rate[row + j] : T(0), active, j, dt, row_tol, t_new, dep_j, i_next,
            row + j, times, x_out, x_act_out);
  }
}

template <typename T>
int launch(const void* x, const void* rate, const void* arr, const void* t, const void* i,
           const void* tol, const void* t_next_drift, void* times, void* x_out,
           void* x_act_out, void* t_out, void* i_out, void* dt_out, int cells, int M,
           void* stream) {
  if (cells <= 0 || M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // A whole number of warps, at most kMaxThreads, no more than the row needs.
  const int warps = (M + 31) / 32;
  const int threads = 32 * (warps < kMaxWarps ? warps : kMaxWarps);
  fluid_event_step_kernel<T><<<cells, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(rate), static_cast<const T*>(arr),
      static_cast<const T*>(t), static_cast<const long long*>(i), static_cast<const T*>(tol),
      static_cast<const T*>(t_next_drift), static_cast<T*>(times), static_cast<T*>(x_out),
      static_cast<T*>(x_act_out), static_cast<T*>(t_out), static_cast<long long*>(i_out),
      static_cast<T*>(dt_out), M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).  x, rate,
// arr, times, x_out and x_act_out are [cells, M]; t, tol, t_next_drift
// (null without drift), t_out and dt_out [cells, 1] of the same type; i and
// i_out [cells, 1] int64.  times is updated in place; nothing else is
// written that is read.
int fluid_event_step_f64(const void* x, const void* rate, const void* arr, const void* t,
                         const void* i, const void* tol, const void* t_next_drift,
                         void* times, void* x_out, void* x_act_out, void* t_out, void* i_out,
                         void* dt_out, int cells, int M, void* stream) {
  return launch<double>(x, rate, arr, t, i, tol, t_next_drift, times, x_out, x_act_out, t_out,
                        i_out, dt_out, cells, M, stream);
}

int fluid_event_step_f32(const void* x, const void* rate, const void* arr, const void* t,
                         const void* i, const void* tol, const void* t_next_drift,
                         void* times, void* x_out, void* x_act_out, void* t_out, void* i_out,
                         void* dt_out, int cells, int M, void* stream) {
  return launch<float>(x, rate, arr, t, i, tol, t_next_drift, times, x_out, x_act_out, t_out,
                       i_out, dt_out, cells, M, stream);
}

}  // extern "C"

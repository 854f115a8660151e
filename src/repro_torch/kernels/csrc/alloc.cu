// Fused heSRPT allocate for Hopper (sm_90a): ranks -> Thm-7 theta -> chips.
//
// Replaces the TPU kernel repro/kernels/alloc.py::_alloc_kernel (Pallas),
// which finds its stable positions by O(M^2) comparison counting.
//
// Layout: one CTA per sweep cell of a [cells, M] batch.  The row is padded
// to P = next power of two >= max(M, 32) entries; the block has
// min(P, 256) threads and thread t holds the ITEMS = P / threads
// consecutive entries t * ITEMS ... t * ITEMS + ITEMS - 1 in registers
// ("blocked" layout).  So the thread count no longer follows M: at the
// lane's M = 1000 a cell is 256 threads of 4 items, several CTAs share an
// SM, and 192 cells run in one wave.  P is at most 4096 (16 items a
// thread): the f64 instance then holds its per-item state in 254 of a
// thread's 255 registers, though the keys' shared memory (P x (key +
// int32 index), 48 KB in f64) would hold more.
//
// Stable positions: the TPU kernel's pos_i = #{j : key_j < key_i or
// (key_j == key_i and j < i)} is the slot of (key_i, i) when the P pairs
// are sorted by key, then index.  The index makes every pair distinct, so
// any correct sort gives that one order; a bitonic network sorts them in
// O(P log^2 P) compare-exchanges instead of O(M^2) comparisons a pass.
// Its stages inside a thread run on registers, those inside a warp on
// __shfl_xor_sync with no barrier, and only the cross-warp ones (in 3 of
// a sort's 10 merge levels at M = 1000) through shared memory.  Keys
// compare as floating point, so -0.0 == 0.0 as in the plain version's
// argsort; +inf marks inactive jobs and the padding (whose indices, >= M,
// sort after every real one).  The first sort (key -x) leaves the job of
// rank r in slot r - 1, so theta and everything up to the second sort are
// computed slot by slot; the second sort (the trim / leftover key) is
// written back to job order through the indices.
//
// What bounds it: not the device traffic (x in, theta and chips out: ~3.8
// MB at [192, 1000] in f64, ~1.1 us at 3.35 TB/s) but one cell's chain of
// dependent steps: on an H100 a lone CTA takes ~3/4 of a full [192, 1000]
// launch, and the two sorts take ~70% of a cell's cycles, most of it in
// the warp-shuffle stages (tools/alloc_phase_clock.py, which also shows
// 128 and 512 threads a CTA slower than 256).  The ~15 block reductions
// are a warp reduction plus one barrier each (the broadcast buffer
// alternates, so no second barrier guards its reuse).
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
//   spells out: each thread's ITEMS leaves, then adjacent threads by
//   __shfl_down_sync 1, 2, ..., 16, then the warps' partials.  Every leaf
//   is >= +0, so the zeros that pad the last level to 8 warps change no
//   sum.  Every other reduction is an exact integer sum.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;               // threads a CTA once P >= 256
constexpr int kMaxWarps = kThreads / 32;
constexpr int kMaxItems = 16;               // so P <= 4096
constexpr unsigned kFull = 0xffffffffu;

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

// The sort's order: by key as floating point, then by index.
template <typename T>
__device__ __forceinline__ bool before(T ka, int ia, T kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Shared-memory slot of entry e in an array of 8-byte (kslot<double>) or
// 4-byte entries: bits 0-3 (0-4) XOR the next four (five) bits.  In the
// blocked layout a warp's lanes touch entries ITEMS apart, which without
// the swizzle share one bank (32-way at 16 items in f64); with it they and
// runs of consecutive entries both fall on distinct banks.
template <typename T>
__device__ __forceinline__ int kslot(int e) {
  return sizeof(T) == 8 ? e ^ ((e >> 4) & 15) : e ^ ((e >> 5) & 31);
}
__device__ __forceinline__ int islot(int e) { return e ^ ((e >> 5) & 31); }

// Exact integer sum over the block, broadcast to every thread.  Every warp
// is full.  sred holds two buffers of kMaxWarps: a call writes the one the
// call before last read, and every thread has passed the last call's
// barrier after its reads of that buffer, so one barrier a call suffices.
__device__ __forceinline__ int block_sum(int v, int* sred, int& parity) {
  v = __reduce_add_sync(kFull, v);
  int* buf = sred + parity * kMaxWarps;
  parity ^= 1;
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) total += buf[w];
  return total;
}

// Pairwise tree sum of leaves 0 .. P - 1 (P = blockDim.x * ITEMS, leaf j
// at kslot(j) in shared memory): level k holds s[i] = s[2i] + s[2i+1] of
// level k-1.  Broadcast.
template <typename T, int ITEMS>
__device__ T pairwise_sum(const T* leaves, T* swarp) {
  T s[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) s[i] = leaves[kslot<T>(threadIdx.x * ITEMS + i)];
#pragma unroll
  for (int w = 1; w < ITEMS; w <<= 1)
#pragma unroll
    for (int i = 0; i < ITEMS; i += 2 * w) s[i] = add_rn(s[i], s[i + w]);
  T v = s[0];
  // Lane l with l % 2o == 0 holds the subtree of its 2o threads after the
  // step of offset o; the other lanes' sums are never read.
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v = add_rn(v, __shfl_down_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  T w[kMaxWarps];
#pragma unroll
  for (int i = 0; i < kMaxWarps; ++i) w[i] = i < n_warps ? swarp[i] : T(0);
#pragma unroll
  for (int d = 1; d < kMaxWarps; d <<= 1)
#pragma unroll
    for (int i = 0; i < kMaxWarps; i += 2 * d) w[i] = add_rn(w[i], w[i + d]);
  return w[0];
}

// Ascending bitonic sort of the block's P = blockDim.x * ITEMS pairs
// (key[i], idx[i]) of entry e = threadIdx.x * ITEMS + i, by before().
// skey / sidx (P each, entry e at kslot / islot) carry the cross-warp
// stages.  On return each thread holds entries e of the sorted order in
// the same layout; shared memory may still be read by other threads until
// the caller's next barrier.
template <typename T, int ITEMS>
__device__ void bitonic_sort(T (&key)[ITEMS], int (&idx)[ITEMS], T* skey, int* sidx) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int P = blockDim.x * ITEMS;
  const int first = t * ITEMS;
  for (int k = 2; k <= P; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * ITEMS) {  // partners in other warps: through shared memory
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        skey[kslot<T>(first + i)] = key[i];
        sidx[islot(first + i)] = idx[i];
      }
      __syncthreads();
      for (; j >= 32 * ITEMS; j >>= 1) {
        for (int q = t; q < P / 2; q += blockDim.x) {
          const int lo = 2 * q - (q & (j - 1));
          const int hi = lo + j;
          const T klo = skey[kslot<T>(lo)], khi = skey[kslot<T>(hi)];
          const int ilo = sidx[islot(lo)], ihi = sidx[islot(hi)];
          const bool up = (lo & k) == 0;
          if (before(khi, ihi, klo, ilo) == up) {
            skey[kslot<T>(lo)] = khi; skey[kslot<T>(hi)] = klo;
            sidx[islot(lo)] = ihi; sidx[islot(hi)] = ilo;
          }
        }
        __syncthreads();
      }
      // Each thread reads back only its own entries, which no thread
      // writes before the next barrier: no barrier needed here.
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        key[i] = skey[kslot<T>(first + i)];
        idx[i] = sidx[islot(first + i)];
      }
    }
    for (; j >= ITEMS; j >>= 1) {  // partners in this warp: shuffles
      const int lm = j / ITEMS;
      const bool lower = (lane & lm) == 0;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const T ko = __shfl_xor_sync(kFull, key[i], lm);
        const int io = __shfl_xor_sync(kFull, idx[i], lm);
        const bool up = ((first + i) & k) == 0;
        // The lower entry keeps the smaller pair when ascending.
        if (before(ko, io, key[i], idx[i]) == (lower == up)) {
          key[i] = ko;
          idx[i] = io;
        }
      }
    }
#pragma unroll
    for (int jj = ITEMS / 2; jj > 0; jj >>= 1) {  // partners in this thread
      if (jj < k) {
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
          if (i & jj) continue;
          const bool up = ((first + i) & k) == 0;
          if (before(key[i + jj], idx[i + jj], key[i], idx[i]) == up) {
            const T kt = key[i]; key[i] = key[i + jj]; key[i + jj] = kt;
            const int it = idx[i]; idx[i] = idx[i + jj]; idx[i + jj] = it;
          }
        }
      }
    }
  }
}

// Scatter each slot's theta and chips to its job (idx) through shared
// memory, then store rows coalesced.
template <typename T, int ITEMS>
__device__ void store_rows(const T (&theta)[ITEMS], const int (&chips)[ITEMS],
                           const int (&idx)[ITEMS], T* skey, int* sidx, int M,
                           T* __restrict__ theta_out, int* __restrict__ chips_out) {
  __syncthreads();  // every thread is done reading skey / sidx
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    skey[kslot<T>(idx[i])] = theta[i];
    sidx[islot(idx[i])] = chips[i];
  }
  __syncthreads();
  const size_t row = static_cast<size_t>(blockIdx.x) * M;
  for (int j = threadIdx.x; j < M; j += blockDim.x) {
    theta_out[row + j] = skey[kslot<T>(j)];
    chips_out[row + j] = sidx[islot(j)];
  }
}

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
hesrpt_alloc_kernel(const T* __restrict__ x, T* __restrict__ theta_out,
                    int* __restrict__ chips_out, int M, double c_in, int n_chips,
                    int min_chips) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sred[2 * kMaxWarps];
  __shared__ T swarp[kMaxWarps];
  const int P = blockDim.x * ITEMS;
  T* skey = reinterpret_cast<T*>(smem);
  int* sidx = reinterpret_cast<int*>(skey + P);

  const int first = threadIdx.x * ITEMS;
  const size_t row = static_cast<size_t>(blockIdx.x) * M;
  const T inf = inf_value<T>();
  const T zero = T(0);
  int parity = 0;

  // Descending-size order of the active jobs: key -x, inactive and padding +inf.
  T key[ITEMS];
  int idx[ITEMS];
  int n_live = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = first + i;
    const T xj = j < M ? x[row + j] : zero;
    const bool active = xj > zero;
    key[i] = active ? -xj : inf;
    idx[i] = j;
    n_live += active;
  }
  const int m = block_sum(n_live, sred, parity);
  bitonic_sort<T, ITEMS>(key, idx, skey, sidx);
  // Slot e = first + i now holds job idx[i], of rank e + 1 when e < m.

  // Thm-7 brackets: the op sequence of policies.hesrpt_theta_from_ranks.
  const int mode = c_in == 1.0 ? 1 : c_in == 2.0 ? 2 : c_in == 3.0 ? 3 : 0;
  const T c = static_cast<T>(c_in);
  const T m_safe = static_cast<T>(m > 1 ? m : 1);
  T theta[ITEMS];
  int n_pos = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    theta[i] = zero;
    if (first + i < m) {
      const T rf = static_cast<T>(first + i + 1);
      const T hi = bracket_pow<T>(rf / m_safe, c, mode);
      const T lo = bracket_pow<T>(sub_rn(rf, T(1)) / m_safe, c, mode);
      theta[i] = sub_rn(hi, lo);
    }
    n_pos += theta[i] > zero;
  }

  int chips[ITEMS];
  if (n_chips <= 0 || min_chips <= 0) {  // uniform across the block
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) chips[i] = 0;
    store_rows<T, ITEMS>(theta, chips, idx, skey, sidx, M, theta_out, chips_out);
    return;
  }

  // Oversubscription cut in rank space: keep the cap highest ranks.  The
  // renormalizer sums the kept shares in job order, so they go back to it.
  const int cap = n_chips / min_chips;
  // block_sum's barrier also orders the sort's last reads of skey before
  // the scatter below.
  const int n_active = block_sum(n_pos, sred, parity);
  const bool over = n_active * min_chips > n_chips;
  unsigned servable = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool s = theta[i] > zero && first + i + 1 > m - cap;
    servable |= static_cast<unsigned>(s) << i;
    skey[kslot<T>(idx[i])] = s ? theta[i] : zero;
  }
  __syncthreads();
  const T tot = pairwise_sum<T, ITEMS>(skey, swarp);

  // Largest-remainder rounding with a min-chips floor.
  T frac[ITEMS];
  int base[ITEMS];
  unsigned active_q = 0;
  int sum_base = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const T sub = (servable >> i) & 1u ? theta[i] : zero;
    const T theta_eff = over ? (tot > zero ? sub / tot : zero) : theta[i];
    const bool a = theta_eff > zero;
    const T raw = mul_rn(theta_eff, static_cast<T>(n_chips));
    const T fl = floor(raw);
    frac[i] = sub_rn(raw, fl);
    base[i] = a ? static_cast<int>(fmax(fl, static_cast<T>(min_chips))) : 0;
    active_q |= static_cast<unsigned>(a) << i;
    sum_base += base[i];
  }
  const int over_by = block_sum(sum_base, sred, parity) - n_chips;
  const int K = over_by > 0 ? over_by : 0;

  // Full trim rounds: smallest r with sum(min(capj, r)) >= K, by bisection.
  const int n_bits = 32 - __clz(n_chips + 1);
  int lo_r = 0, hi_r = n_chips;
  for (int b = 0; b < n_bits; ++b) {
    const int mid = (lo_r + hi_r) / 2;
    int s = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int capj = base[i] > min_chips ? base[i] - min_chips : 0;
      s += capj < mid ? capj : mid;
    }
    const bool ge = block_sum(s, sred, parity) >= K;
    lo_r = ge ? lo_r : mid + 1;
    hi_r = ge ? mid : hi_r;
  }
  const int r_star = lo_r;
  const int r_full = r_star - 1 > 0 ? r_star - 1 : 0;
  const int r_elig = r_star > 1 ? r_star : 1;
  int sum_full = 0;
  T key2[ITEMS];
  int idx2[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int capj = base[i] > min_chips ? base[i] - min_chips : 0;
    sum_full += capj < r_full ? capj : r_full;
    // One stable pass serves the partial trim round (K > 0) or the leftover
    // chips (K == 0): the two are mutually exclusive.
    const bool elig = capj >= r_elig;
    const bool a = (active_q >> i) & 1u;
    key2[i] = K > 0 ? (elig ? frac[i] : inf) : (a ? -frac[i] : inf);
    idx2[i] = idx[i];
  }
  const int extra_needed = K - block_sum(sum_full, sred, parity);

  // The pairwise sum read only this thread's entries of skey, which are
  // the ones the sort's first stores overwrite.
  bitonic_sort<T, ITEMS>(key2, idx2, skey, sidx);
  __syncthreads();  // the sort's last reads of sidx are done
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) sidx[islot(idx2[i])] = first + i;  // job -> position
  __syncthreads();

  int sum_new = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int capj = base[i] > min_chips ? base[i] - min_chips : 0;
    const bool elig = capj >= r_elig;
    const int full = capj < r_full ? capj : r_full;
    chips[i] = base[i] - full - ((elig && sidx[islot(idx[i])] < extra_needed) ? 1 : 0);
    sum_new += chips[i];
  }
  const int remainder = n_chips - block_sum(sum_new, sred, parity);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    chips[i] += (((active_q >> i) & 1u) && sidx[islot(idx[i])] < remainder) ? 1 : 0;
  store_rows<T, ITEMS>(theta, chips, idx, skey, sidx, M, theta_out, chips_out);
}

template <typename T>
using KernelFn = void (*)(const T*, T*, int*, int, double, int, int);

// The instance for P padded entries and its thread count; nullptr when P is
// not a power of two in [32, kThreads * kMaxItems].
template <typename T>
KernelFn<T> instance(int P, int* threads) {
  if (P < 32 || (P & (P - 1)) != 0 || P > kThreads * kMaxItems) return nullptr;
  *threads = P < kThreads ? P : kThreads;
  switch (P / *threads) {
    case 1: return hesrpt_alloc_kernel<T, 1>;
    case 2: return hesrpt_alloc_kernel<T, 2>;
    case 4: return hesrpt_alloc_kernel<T, 4>;
    case 8: return hesrpt_alloc_kernel<T, 8>;
    case 16: return hesrpt_alloc_kernel<T, 16>;
  }
  return nullptr;
}

// Dynamic shared memory of an instance, with the opt-in above 48 KB.
template <typename T>
cudaError_t prepare(KernelFn<T> kernel, int P, size_t* smem) {
  *smem = static_cast<size_t>(P) * (sizeof(T) + sizeof(int));
  if (*smem + 2 * kMaxWarps * sizeof(int) + kMaxWarps * sizeof(T) <= 48 * 1024)
    return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
int launch(const void* x, void* theta, void* chips, int cells, int M, int P, double c,
           int n_chips, int min_chips, void* stream) {
  int threads = 0;
  size_t smem = 0;
  const KernelFn<T> kernel = instance<T>(P, &threads);
  if (kernel == nullptr || M > P) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare<T>(kernel, P, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<cells, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(theta), static_cast<int*>(chips), M, c,
      n_chips, min_chips);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int occupancy(int P, int* registers, int* ctas_per_sm) {
  int threads = 0;
  size_t smem = 0;
  const KernelFn<T> kernel = instance<T>(P, &threads);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare<T>(kernel, P, &smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    *registers = attr.numRegs;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).  P is the
// padded row length, kernels/alloc.py::pad_len(M).
int hesrpt_alloc_f64(const void* x, void* theta, void* chips, int cells, int M, int P,
                     double c, int n_chips, int min_chips, void* stream) {
  return launch<double>(x, theta, chips, cells, M, P, c, n_chips, min_chips, stream);
}

int hesrpt_alloc_f32(const void* x, void* theta, void* chips, int cells, int M, int P,
                     double c, int n_chips, int min_chips, void* stream) {
  return launch<float>(x, theta, chips, cells, M, P, c, n_chips, min_chips, stream);
}

// Registers a thread and resident CTAs an SM of the instance for P padded
// entries (f64 when is_f64 is not 0).  Returns a cudaError_t (0 = success).
int hesrpt_alloc_occupancy(int P, int is_f64, int* registers, int* ctas_per_sm) {
  return is_f64 ? occupancy<double>(P, registers, ctas_per_sm)
                : occupancy<float>(P, registers, ctas_per_sm);
}

}  // extern "C"

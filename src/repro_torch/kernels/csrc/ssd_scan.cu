// Mamba2 SSD chunked scan for Hopper (sm_90a): the chunked dual form with a
// float32 state carried from chunk to chunk.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel and
// computes what it computes.  For each (batch row, head) and each chunk of
// Q steps, with s = inclusive cumsum(a * dt) inside the chunk:
//   y_t  = sum_{u <= t} (c_t . b_u) exp(s_t - s_u) dt_u x_u     (intra-chunk)
//        + exp(s_t) c_t h_prev                                   (inter-chunk)
//   h    = exp(s_Q) h_prev + sum_u exp(s_Q - s_u) dt_u x_u b_u^T (state)
// x [B, S, H, P], dt [B, S, H] float32, a [H] float32, b/c [B, S, N] (one
// group); y [B, S, H, P] in x's type, the final state [B, H, P, N] float32.
// Steps past S act as dt = 0: they write no output and leave the state as it
// is.  The D skip is added outside the kernel, as the TPU wrapper does.
//
// Layout.  One CTA of 128 threads per (slice of PS head channels, head,
// batch row), walking the chunks in order; PS = 32 (16 where P is not a
// multiple of 32) splits P across CTAs so that batch 4 x 24 heads fills the
// card with 192 CTAs; each CTA recomputes the chunk's Q x Q scores.  A chunk
// is Q = 64 steps (the TPU kernel's 128 would need ~256 KB of shared memory
// for its b, c, x, score and state tiles in float32, more than a CTA may
// have).  The chunk's b and c rows (N zero-padded to NP, a multiple of 16),
// its x slice, the score tile and the CTA's [PS, NP] state live in shared
// memory; rows are padded by one float so that the column walks below hit
// distinct banks.  Every product is float32 FMAs on the CUDA cores from
// register tiles: scores 4 x 8 per thread (the tile pairs that lie wholly
// above the diagonal are skipped at compile time), y 4 x PS/8, state
// PS/8 x NP/16.  The exponential is taken only inside the lower triangle:
// above it the exponent s_t - s_u is positive and may overflow, and masking
// an inf by multiplication would give NaN.
//
// Bound.  At the main path's shape (x [4, 30000, 24, 64], b/c [4, 30000,
// 128], float32) the function needs ~1.6 GB of x, y, b, c and dt (0.5 ms at
// 3.35 TB/s) against ~107 GFLOP at Q = 64 with C B^T counted once per batch
// row (1.6 ms at 67 TFLOP/s float32): it is bound by operations.  This
// first version is limited by shared-memory loads (about 0.4 per FMA), by
// the C B^T product recomputed for every head and P slice, and by one CTA
// per SM on the SMs that hold a single CTA; sharing C B^T across heads and
// bf16/tf32 wgmma tiles are the ways to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int Q = 64;  // steps per chunk
constexpr int THREADS = 128;
constexpr int LDQ = Q + 1;  // score tile row

struct Strides {  // in elements; the last dim of x, b and c is unit-stride
  long long x[3];   // batch, sequence, head
  long long dt[3];  // batch, sequence, head
  long long b[2];   // batch, sequence
  long long c[2];   // batch, sequence
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int PS, int NJ>
__host__ __device__ constexpr int smem_floats() {
  constexpr int LDN = NJ * 16 + 1;
  // b, c, x, state, scores, and four per-step vectors (dt, s, exp(s), w)
  return 2 * Q * LDN + Q * PS + PS * LDN + Q * LDQ + 4 * Q;
}

template <typename T, int PS, int NJ>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
               T* __restrict__ y, float* __restrict__ state, Strides st, int S, int H, int P,
               int N) {
  constexpr int NP = NJ * 16;
  constexpr int LDN = NP + 1;
  constexpr int PJ = PS / 8;  // y: head channels per thread
  extern __shared__ float smem[];
  float* sB = smem;                // [Q][LDN]
  float* sC = sB + Q * LDN;        // [Q][LDN]
  float* sX = sC + Q * LDN;        // [Q][PS]
  float* sH = sX + Q * PS;         // [PS][LDN]  the carried state
  float* sScore = sH + PS * LDN;   // [Q][LDQ]
  float* sDt = sScore + Q * LDQ;   // [Q]  dt, 0 past S
  float* sS = sDt + Q;             // [Q]  inclusive cumsum of a * dt
  float* sE = sS + Q;              // [Q]  exp(s_t)
  float* sW = sE + Q;              // [Q]  exp(s_Q - s_u) * dt_u

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const float ah = a[h];

  const T* xb = x + bi * st.x[0] + h * st.x[2] + p0;
  const float* dtb = dt + bi * st.dt[0] + h * st.dt[2];
  const T* bb = b + bi * st.b[0];
  const T* cb = c + bi * st.c[0];

  for (int i = tid; i < PS * LDN; i += THREADS) sH[i] = 0.0f;

  // Thread tiles.  Scores and y: rows t = ty + 16 i; score columns u = tx + 8 j;
  // y columns p = tx + 8 j.  State: p = py + 8 i, n = nx + 16 j.
  const int ty = tid / 8, tx = tid % 8;
  const int py = tid / 16, nx = tid % 16;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;

    // ---- dt, s = cumsum(a dt), exp(s), w: warp 0, two steps a lane
    if (tid < 32) {
      float d[2], v[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int gt = t0 + 2 * lane + k;
        d[k] = gt < S ? dtb[gt * st.dt[1]] : 0.0f;
        v[k] = ah * d[k];
      }
      float inc = v[0] + v[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) excl = 0.0f;
      const float s0 = excl + v[0];
      const float s1 = s0 + v[1];
      const float total = __shfl_sync(0xffffffffu, s1, 31);
      const float s[2] = {s0, s1};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        sDt[t] = d[k];
        sS[t] = s[k];
        sE[t] = expf(s[k]);
        sW[t] = expf(total - s[k]) * d[k];
      }
    }
    // ---- b, c rows and the x slice, zero past S and past N
    for (int i = tid; i < Q * NP; i += THREADS) {
      const int t = i / NP, n = i % NP;
      const int gt = t0 + t;
      const bool ok = gt < S && n < N;
      sB[t * LDN + n] = ok ? load_f32(bb + gt * st.b[1] + n) : 0.0f;
      sC[t * LDN + n] = ok ? load_f32(cb + gt * st.c[1] + n) : 0.0f;
    }
    for (int i = tid; i < Q * PS; i += THREADS) {
      const int t = i / PS, p = i % PS;
      const int gt = t0 + t;
      sX[i] = gt < S ? load_f32(xb + gt * st.x[1] + p) : 0.0f;
    }
    __syncthreads();

    // ---- scores[t][u] = (c_t . b_u) exp(s_t - s_u) dt_u for u <= t, else 0
    {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        float cv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = sB[(tx + 8 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            // u >= 8 j > 16 i + 15 >= t: wholly above the diagonal
            if (j <= 2 * i + 1) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = tx + 8 * j;
          sScore[t * LDQ + u] = u <= t ? acc[i][j] * expf(sS[t] - sS[u]) * sDt[u] : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- y = scores x + exp(s_t) c_t h_prev
    {
      float acc[4][PJ], inter[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = inter[i][j] = 0.0f;
      const int u_end = ty + 16 * 3 + 1;  // scores past the last row's diagonal are 0
      for (int u = 0; u < u_end; ++u) {
        float sv[4], xv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = sScore[(ty + 16 * i) * LDQ + u];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = sX[u * PS + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < NP; ++n) {
        float cv[4], hv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = sH[(tx + 8 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) inter[i][j] = fmaf(cv[i], hv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const int gt = t0 + t;
        if (gt < S) {
          T* yrow = y + ((static_cast<long long>(bi) * S + gt) * H + h) * P + p0;
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            store(yrow + tx + 8 * j, acc[i][j] + sE[t] * inter[i][j]);
        }
      }
    }
    __syncthreads();  // every read of h_prev is done

    // ---- h = exp(s_Q) h_prev + sum_u (x_u w_u) b_u^T, each thread its own entries
    {
      float acc[PS / 8][NJ];
#pragma unroll
      for (int i = 0; i < PS / 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int u = 0; u < Q; ++u) {
        const float w = sW[u];
        float xw[PS / 8], bv[NJ];
#pragma unroll
        for (int i = 0; i < PS / 8; ++i) xw[i] = sX[u * PS + py + 8 * i] * w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = sB[u * LDN + nx + 16 * j];
#pragma unroll
        for (int i = 0; i < PS / 8; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(xw[i], bv[j], acc[i][j]);
      }
      const float decay = expf(sS[Q - 1]);
#pragma unroll
      for (int i = 0; i < PS / 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float* hp = sH + (py + 8 * i) * LDN + nx + 16 * j;
          *hp = decay * *hp + acc[i][j];
        }
    }
    __syncthreads();  // the next chunk overwrites b, x, dt, s and w
  }

  // ---- final state, from the entries each thread updated itself
  float* sb = state + ((static_cast<long long>(bi) * H + h) * P + p0) * N;
#pragma unroll
  for (int i = 0; i < PS / 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int p = py + 8 * i, n = nx + 16 * j;
      if (n < N) sb[p * N + n] = sH[p * LDN + n];
    }
}

template <typename T, int PS, int NJ>
int launch(const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
           void* state, int B, int S, int H, int P, int N, const long long* strides,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<PS, NJ>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<T, PS, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    st.b[i] = strides[6 + i];
    st.c[i] = strides[8 + i];
  }
  const dim3 grid(P / PS, H, B);
  ssd_chunk_scan<T, PS, NJ><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), st, S, H, P, N);
  return (int)cudaGetLastError();
}

// Two state widths are built: N <= 16 (one 16-column tile) and N <= 128
// (eight, mamba2's state); a wider state is refused.
template <typename T, int PS>
int dispatch_n(const void* x, const void* dt, const void* a, const void* b, const void* c,
               void* y, void* state, int B, int S, int H, int P, int N,
               const long long* strides, cudaStream_t s) {
  if (N <= 16) return launch<T, PS, 1>(x, dt, a, b, c, y, state, B, S, H, P, N, strides, s);
  if (N <= 128) return launch<T, PS, 8>(x, dt, a, b, c, y, state, B, S, H, P, N, strides, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* b, const void* c,
             void* y, void* state, int B, int S, int H, int P, int N,
             const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S < 1 || N < 1 || P < 16 || P % 16) return (int)cudaErrorInvalidValue;
  if (P % 32 == 0) return dispatch_n<T, 32>(x, dt, a, b, c, y, state, B, S, H, P, N, strides, s);
  return dispatch_n<T, 16>(x, dt, a, b, c, y, state, B, S, H, P, N, strides, s);
}

}  // namespace

// C entry points (ctypes).  strides: 10 int64 in elements: x (batch,
// sequence, head), dt (batch, sequence, head), b (batch, sequence), c (batch,
// sequence).  y is a dense [B, S, H, P] and state a dense [B, H, P, N].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, void* y, void* state, int B, int S, int H, int P,
                            int N, const long long* strides, void* stream) {
  return dispatch<float>(x, dt, a, b, c, y, state, B, S, H, P, N, strides, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                             const void* c, void* y, void* state, int B, int S, int H, int P,
                             int N, const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, a, b, c, y, state, B, S, H, P, N, strides, stream);
}

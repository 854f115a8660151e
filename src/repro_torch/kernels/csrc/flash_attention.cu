// Flash-attention forward for Hopper (sm_90a): tiled online softmax, causal
// with a query offset, sliding window, GQA/MQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// and computes what it computes:
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[b, h / group, j]
// over the keys j that the masks allow (k_pos < Skv; causal: k_pos <= q_pos;
// window > 0: k_pos > q_pos - window; q_pos = i + q_offset), with float32
// running max, denominator and accumulator, masked logits set to -1e30 (the
// reference's NEG_INF, not -inf), the denominator clamped at 1e-30, and the
// output in the input's type (float32 or bfloat16).
//
// Layout.  One CTA of 256 threads per (q-tile of BQ = 64 rows, query head,
// batch row).  The CTA stages its Q tile (pre-scaled) and, in turn, each
// BK = 64-key tile of K and V in shared memory as float32; rows are padded
// to D + 1 floats so that the column walks below hit 32 distinct banks.
// Thread (ty, tx), ty = tid / 16, tx = tid % 16, owns query rows 4ty..4ty+3,
// the logits of key columns tx + 16c (c = 0..3) and the output columns
// tx + 16c (c = 0..D/16-1).  Both products are float32 FMAs (no tensor cores,
// no TF32); a row's max and sum reduce over the 16 lanes of a half-warp.
// The probability tile P is written over the K tile once the logits are
// done, which keeps D = 128 at 99 KB of shared memory (two CTAs per SM);
// D = 160 (stablelm) takes 121 KB and D = 256 193 KB, one CTA per SM.  The
// instances are D = 16, 32, 64, 128, 160 and 256; the wrapper zero-pads any
// other D <= 256 to the next one (zero columns change neither q . k nor the
// output's real columns) and passes the true D's scale.  It refuses D > 256:
// the three [64][D + 1] float32 tiles outgrow shared memory soon after (at
// D = 320 they take 241 KB, more than the 227 KB a CTA may have).
//
// Bound.  At the main path's shape ([4, 24, 1000, 128], causal, float32)
// the two products are 4 * D flops per (query, key) pair: about 24.6 GFLOP
// against 131 MB of q, k, v and o, so it is bound by operations (0.37 ms at
// 67 TFLOP/s float32) far more than by bytes (0.04 ms at 3.35 TB/s).  This
// first version is limited by shared-memory traffic (two loads per two to
// three FMAs) and by the lack of overlap between tile loads and compute;
// wgmma on bf16 tiles fed by TMA is the way to the bound.
//
// Tiles that lie wholly outside the causal or window band of all the CTA's
// rows are skipped.  For a row with at least one allowed key that changes
// nothing: a fully masked tile seen before the row's first allowed key adds
// p = exp(-1e30 - (-1e30)) = 1 terms that the later correction
// exp(-1e30 - m) = 0 wipes out, and one seen after adds exp(-1e30 - m) = 0.
// Key columns past Skv are not part of the input: their logit is -inf, so
// they add exactly 0 (the TPU kernel pads them and masks them to -1e30,
// which gives the same result for every row with an allowed key).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr float MASKED = -1e30f;  // the reference's NEG_INF

struct Strides {  // in elements: batch, head, sequence (the last dim is unit-stride)
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__host__ __device__ constexpr int smem_floats() {
  constexpr int LD = D + 1;
  constexpr int kp = BK * LD > BQ * (BK + 1) ? BK * LD : BQ * (BK + 1);  // K tile, then P
  return BQ * LD + kp + BK * LD;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Strides st, int group, int Sq, int Skv, float scale,
          int causal, int window, int q_offset) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sq = smem;                                      // [BQ][LD]
  float* sk = sq + BQ * LD;                              // [BK][LD], then P [BQ][LDP]
  float* sv = smem + smem_floats<D>() - BK * LD;         // [BK][LD]
  float* sp = sk;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, row = q0 + r;
    sq[r * LD + c] = row < Sq ? load_f32(qb + row * st.q[2] + c) * scale : 0.f;
  }

  // Key tiles that can hold an allowed key for some row of this CTA.
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + q_offset + 1);
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1);
  if (kv_lo >= kv_hi) {  // no row has an allowed key: take every tile, as the reference does
    kv_lo = 0;
    kv_hi = Skv;
  }
  const int t_lo = kv_lo / BK, t_hi = (kv_hi + BK - 1) / BK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P and V are read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool in = row < Skv;
      sk[r * LD + c] = in ? load_f32(kb + row * st.k[2] + c) : 0.f;
      sv[r * LD + c] = in ? load_f32(vb + row * st.v[2] + c) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sk[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
    }
    __syncthreads();  // every thread is done with K: P goes over it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + 4 * ty + i + q_offset;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (k_pos >= Skv) x = -INFINITY;
        else if ((causal && k_pos > q_pos) || (window > 0 && k_pos <= q_pos - window)) x = MASKED;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(4 * ty + i) * LDP + tx + 16 * j] = p;
        row_sum += p;
      }
      l[i] = corr * l[i] + half_warp_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(4 * ty + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sv[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + row * st.o[2];
#pragma unroll
    for (int c = 0; c < NC; ++c) store(orow + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
           int Sq, int Skv, const long long* strides, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, Hq / Hkv, Sq, Skv, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
             int Sq, int Skv, int D, const long long* strides, float scale, int causal,
             int window, int q_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 160: return launch<T, 160>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (ctypes).  strides: 12 int64 in elements, (batch, head,
// sequence) of q, k, v, o in that order; the head dim is unit-stride.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                   const long long* strides, float scale, int causal,
                                   int window, int q_offset, void* stream) {
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, scale, causal, window,
                         q_offset, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                    const long long* strides, float scale, int causal,
                                    int window, int q_offset, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, scale, causal,
                                 window, q_offset, stream);
}

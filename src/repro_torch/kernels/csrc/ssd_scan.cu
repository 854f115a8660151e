// Mamba2 SSD chunked scan for Hopper (sm_90a): chunk-parallel passes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel and
// computes what it computes.  For each (batch row, head) and each chunk k of
// Q = 64 steps, with s = inclusive cumsum(a * dt) inside the chunk:
//   y_t  = sum_{u <= t} (c_t . b_u) exp(s_t - s_u) dt_u x_u     (intra-chunk)
//        + exp(s_t) c_t h_{k-1}                                  (inter-chunk)
//   h_k  = exp(s_Q) h_{k-1} + sum_u exp(s_Q - s_u) dt_u x_u b_u^T (state)
// x [B, S, H, P], dt [B, S, H] float32, a [H] float32, b/c [B, S, N] (one
// group); y [B, S, H, P] in x's type, the final state h [B, H, P, N]
// float32, h before the first chunk 0.  Steps past S act as dt = 0: they
// write no output and leave the state as it is.  The D skip is added outside
// the kernel, as the TPU wrapper does.
//
// The TPU kernel walks the chunks in order with the state in VMEM.  Here the
// SSD paper's chunked algorithm (arXiv:2405.21060) splits that walk so that
// only a small elementwise pass is sequential; four launches a call:
//   0. ssd_chunk_cb: C B^T of each chunk, once for all heads;
//   1. ssd_chunk_states: per (chunk, head) the chunk's own state
//      local_k = sum_u exp(s_Q - s_u) dt_u x_u b_u^T, and exp(s_Q);
//   2. ssd_state_pass: h_k = exp(s_Q,k) h_{k-1} + local_k over the chunks,
//      one thread per four (batch row, head, n, p) lanes, in place: slot k
//      of the scratch then holds h_{k-1}, the state entering chunk k;
//   3. ssd_chunk_outputs: per (chunk, two heads) y from h_{k-1}, C B^T and x.
// Passes 0, 1 and 3 are independent per chunk: at x [4, 30000, 24, 64] pass
// 1 has 469 chunks x 4 rows x 3 groups of 8 heads = 5628 CTAs and pass 3
// 22,512, where one CTA per (P slice, head, row) walking all chunks gave 192.
// The scratch (chunk states [B, n_chunks, H, N, P] float32, 1.47 GB there;
// exp(s_Q) [B, n_chunks, H]; C B^T [B, n_chunks, Q, Q], 31 MB) is allocated
// by the wrapper; the kernel allocates nothing.
//
// Layout.  A chunk is Q = 64 steps; the state is padded to NP = 128 (zeros
// past N) and the head channels are taken in slices of 64 (masked past P),
// so one instance serves every P (a multiple of 16) and N <= 128.  Tiles
// live in shared memory as float32; the products are float32 FMAs from 8 x 8
// register tiles per thread fed by two 16-byte shared loads of each operand
// a step (0.25 loads per FMA): pass 1 a tile of [P] x [N] per head, pass 3
// a tile of [t] x [two heads' P] over C^T and the stacked states, then over
// the scores and x, on the same accumulators.  The scratch is laid out
// [N][P] so that pass 3 reads h_{k-1} as the k-major operand without a
// transpose.  Copies go by cp.async (Hopper's asynchronous copy, zero-filled
// past S, P, N and H): pass 1 copies the next head's x and dt while the
// current head computes, pass 3 copies x and C B^T into the space that the
// first half of its C h^T product has freed while the second half computes.
// bf16 inputs take the same code with synchronous loads converted to
// float32.  The exponential is taken only inside the lower triangle: above
// it the exponent s_t - s_u is positive and may overflow, and masking an inf
// by multiplication would give NaN.
//
// Why float32 stays on the CUDA cores.  The main path runs float32 and is
// held to its plain version at 2e-5 + 2e-5 |y|.  wgmma takes float32 only
// as TF32, which keeps about three decimal digits (a relative error near
// 5e-4 per product), far outside that tolerance; a 3xTF32 split (three
// wgmma products per tile) would restore float32 accuracy and is later work
// if it is ever needed.
//
// Bound.  At the main path's shape (x [4, 30000, 24, 64], b/c [4, 30000,
// 128], float32) the function needs ~1.6 GB of x, y, b, c and dt (0.5 ms at
// 3.35 TB/s) against ~107 GFLOP at Q = 64 with C B^T counted once per batch
// row (1.6 ms at 67 TFLOP/s float32): it is bound by operations.  The
// passes do ~115 GFLOP and move another ~5.9 GB of chunk states (written
// by pass 1, read and written by pass 2, read by pass 3: ~1.8 ms at 3.35
// TB/s), which is what this design pays for its parallelism.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int Q = 64;    // steps per chunk
constexpr int PT1 = 64;  // head channels per CTA of pass 1
constexpr int NP = 128;  // state width, padded
constexpr int LDB = NP + 4;  // pass 0's B rows: conflict-free 16-byte column walks
constexpr int HEADS_PER_CTA = 8;
constexpr int STATES_THREADS = 128;
constexpr int PASS_THREADS = 256;

struct Strides {  // in elements; the last dim of x, b and c is unit-stride
  long long x[3];   // batch, sequence, head
  long long dt[3];  // batch, sequence, head
  long long b[2];   // batch, sequence
  long long c[2];   // batch, sequence
};

struct Shape {
  int S, H, P, N, n_chunks;
};

// ---- copies into shared memory: cp.async for float32 sources (zero-filled
// where !ok), synchronous loads converted to float32 for bf16 ones.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_in(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy_in(float* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.0f;
}

// 16 bytes, both ends 16-byte aligned (the chunk-state scratch).
__device__ __forceinline__ void copy_in16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float v0, float v1, float v2, float v3) {
  *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float v0, float v1, float v2,
                                       float v3) {
  p[0] = __float2bfloat16_rn(v0);
  p[1] = __float2bfloat16_rn(v1);
  p[2] = __float2bfloat16_rn(v2);
  p[3] = __float2bfloat16_rn(v3);
}

// One warp: s = inclusive cumsum(a dt) over the chunk's Q = 64 steps, two a
// lane (steps 2 lane and 2 lane + 1), from dt in shared memory; *total = s_Q.
__device__ __forceinline__ float2 chunk_cumsum(const float* sdt, float ah, int lane,
                                               float* total) {
  const float v0 = ah * sdt[2 * lane], v1 = ah * sdt[2 * lane + 1];
  float inc = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) excl = 0.0f;
  const float s0 = excl + v0;
  const float s1 = s0 + v1;
  *total = __shfl_sync(0xffffffffu, s1, 31);
  return make_float2(s0, s1);
}

// Pass 1's x [Q][PT1] and dt [Q] of head h in chunk t0 / Q, batch row bi,
// channels p0...
template <typename T>
__device__ __forceinline__ void load_x_dt(float* sx, float* sdt, const T* x, const float* dt,
                                          const Strides& st, const Shape& sh, int bi, int h,
                                          int t0, int p0, int tid) {
  const T* xb = x + bi * st.x[0] + h * st.x[2] + p0;
  for (int i = tid; i < Q * PT1; i += STATES_THREADS) {
    const int t = i / PT1, p = i % PT1, gt = t0 + t;
    const bool ok = gt < sh.S && p0 + p < sh.P;
    copy_in(sx + i, ok ? xb + gt * st.x[1] + p : x, ok);
  }
  if (tid < Q) {
    const int gt = t0 + tid;
    const bool ok = gt < sh.S;
    copy_in(sdt + tid, ok ? dt + bi * st.dt[0] + gt * st.dt[1] + h * st.dt[2] : dt, ok);
  }
}

// A [Q][ld] tile of b or c rows (zero past S and past N).
template <typename T, int THREADS>
__device__ __forceinline__ void load_bc(float* dst, int ld, const T* src, long long s_batch,
                                        long long s_seq, const Shape& sh, int bi, int t0,
                                        int tid) {
  const T* base = src + bi * s_batch;
  for (int i = tid; i < Q * NP; i += THREADS) {
    const int t = i / NP, n = i % NP, gt = t0 + t;
    const bool ok = gt < sh.S && n < sh.N;
    copy_in(dst + t * ld + n, ok ? base + gt * s_seq + n : src, ok);
  }
}

// ---------------------------------------------------------------- pass 0
// C B^T of each chunk, once for all heads: grid (chunk, batch row), 256
// threads; thread (ty, tx) = (tid / 16, tid % 16) owns rows t = ty + 16 i,
// columns u = tx + 16 j (i, j < 4); the pairs wholly above the diagonal
// (j > i) are skipped and written as 0.  Stored transposed, cb[u][t], as
// pass 3 reads it.
constexpr int CB_THREADS = 256;
constexpr int CB_SMEM_FLOATS = Q * NP + Q * LDB;

template <typename T>
__global__ void __launch_bounds__(CB_THREADS)
ssd_chunk_cb(const T* __restrict__ b, const T* __restrict__ c, Strides st, Shape sh,
             float* __restrict__ cb) {
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);  // [Q][NP]
  float* sB = sC + Q * NP;                      // [Q][LDB]
  const int k = blockIdx.x, bi = blockIdx.y, t0 = k * Q;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  load_bc<T, CB_THREADS>(sC, NP, c, st.c[0], st.c[1], sh, bi, t0, tid);
  load_bc<T, CB_THREADS>(sB, LDB, b, st.b[0], st.b[1], sh, bi, t0, tid);
  commit();
  wait_copies<0>();
  __syncthreads();
  float g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;
#pragma unroll 2
  for (int n = 0; n < NP; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = ld4(sC + (ty + 16 * i) * NP + n);
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = ld4(sB + (tx + 16 * j) * LDB + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j <= i) {
          g[i][j] = fmaf(cv[i].x, bv[j].x, g[i][j]);
          g[i][j] = fmaf(cv[i].y, bv[j].y, g[i][j]);
          g[i][j] = fmaf(cv[i].z, bv[j].z, g[i][j]);
          g[i][j] = fmaf(cv[i].w, bv[j].w, g[i][j]);
        }
  }
  float* out = cb + (static_cast<long long>(bi) * sh.n_chunks + k) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(tx + 16 * j) * Q + ty + 16 * i] = g[i][j];
}

// ---------------------------------------------------------------- pass 1
// Grid (chunk, head group x P slice, batch row), 128 threads.  Thread
// (ty, tx) = (tid / 8, tid % 8) owns the state entries p = 4 tx + {0..3} and
// 32 + 4 tx + {0..3}, n = 4 ty + {0..3} and 64 + 4 ty + {0..3}.
constexpr int STATES_SMEM_FLOATS = Q * NP + 2 * Q * PT1 + 2 * Q + (STATES_THREADS / 32) * Q;

template <typename T>
__global__ void __launch_bounds__(STATES_THREADS)
ssd_chunk_states(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ b, Strides st, Shape sh,
                 float* __restrict__ states, float* __restrict__ decay) {
  extern __shared__ float4 smem4[];
  float* sB = reinterpret_cast<float*>(smem4);  // [Q][NP]
  float* sX = sB + Q * NP;                      // [2][Q][PT1]
  float* sDt = sX + 2 * Q * PT1;                // [2][Q]
  float* sW = sDt + 2 * Q;                      // [warp][Q]  exp(s_Q - s_u) dt_u

  const int k = blockIdx.x, bi = blockIdx.z;
  const int n_slices = (sh.P + PT1 - 1) / PT1;
  const int p0 = (blockIdx.y % n_slices) * PT1;
  const int h_begin = (blockIdx.y / n_slices) * HEADS_PER_CTA;
  const int h_end = min(sh.H, h_begin + HEADS_PER_CTA);
  const int t0 = k * Q;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid % 8, ty = tid / 8;
  float* const wv = sW + (tid / 32) * Q;  // this warp's copy of w

  load_bc<T, STATES_THREADS>(sB, NP, b, st.b[0], st.b[1], sh, bi, t0, tid);
  load_x_dt<T>(sX, sDt, x, dt, st, sh, bi, h_begin, t0, p0, tid);
  commit();

  for (int h = h_begin; h < h_end; ++h) {
    const int buf = (h - h_begin) & 1;
    wait_copies<0>();
    __syncthreads();  // this head's tiles are in; every thread is done with the last head
    if (h + 1 < h_end) {
      load_x_dt<T>(sX + (buf ^ 1) * Q * PT1, sDt + (buf ^ 1) * Q, x, dt, st, sh, bi, h + 1, t0,
                   p0, tid);
      commit();
    }

    {  // every warp takes the chunk's cumsum itself: no block-wide wait for it
      float total;
      const float* sdt = sDt + buf * Q;
      const float2 s = chunk_cumsum(sdt, a[h], lane, &total);
      wv[2 * lane] = expf(total - s.x) * sdt[2 * lane];
      wv[2 * lane + 1] = expf(total - s.y) * sdt[2 * lane + 1];
      if (tid == 0 && p0 == 0)
        decay[(static_cast<long long>(bi) * sh.n_chunks + k) * sh.H + h] = expf(total);
      __syncwarp();
    }

    // local[p][n] = sum_u (x_u[p] w_u) b_u[n]
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const float* xs = sX + buf * Q * PT1;
#pragma unroll 4
    for (int u = 0; u < Q; ++u) {
      const float w = wv[u];
      const float4 x0 = ld4(xs + u * PT1 + 4 * tx), x1 = ld4(xs + u * PT1 + 32 + 4 * tx);
      const float4 b0 = ld4(sB + u * NP + 4 * ty), b1 = ld4(sB + u * NP + 64 + 4 * ty);
      const float xv[8] = {x0.x * w, x0.y * w, x0.z * w, x0.w * w,
                           x1.x * w, x1.y * w, x1.z * w, x1.w * w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }

    // states[bi][k][h] is [N][P]: one 16-byte store per (n, half of the p's)
    float* out = states + ((static_cast<long long>(bi) * sh.n_chunks + k) * sh.H + h) *
                              static_cast<long long>(sh.N) * sh.P;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (j < 4 ? 0 : 64) + 4 * ty + (j & 3);
      if (n >= sh.N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = p0 + 32 * half + 4 * tx;
        if (p < sh.P)
          store4(out + static_cast<long long>(n) * sh.P + p, acc[4 * half][j],
                 acc[4 * half + 1][j], acc[4 * half + 2][j], acc[4 * half + 3][j]);
      }
    }
  }
}

// ---------------------------------------------------------------- pass 2
// One thread per four consecutive p of one (batch row, head, n): coalesced
// 16-byte walks over the chunks, eight chunks' loads in flight ahead of the
// carry.  It is bound by the bytes of the scratch, read and written once.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               float* __restrict__ final_state, int B, Shape sh) {
  const long long NP4 = static_cast<long long>(sh.N) * sh.P / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * PASS_THREADS + threadIdx.x;
  if (idx >= B * sh.H * NP4) return;
  const long long e4 = idx % NP4, bh = idx / NP4;
  const int h = static_cast<int>(bh % sh.H), bi = static_cast<int>(bh / sh.H);
  const long long chunk_stride = sh.H * NP4;
  float4* ptr = reinterpret_cast<float4*>(states) +
                static_cast<long long>(bi) * sh.n_chunks * chunk_stride + h * NP4 + e4;
  const float* dec = decay + static_cast<long long>(bi) * sh.n_chunks * sh.H + h;
  constexpr int AHEAD = 8;
  float4 cur[AHEAD];
  float dcur[AHEAD];
  auto fetch = [&](float4* loc, float* dk, int k0) {
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      if (k0 + j < sh.n_chunks) {
        loc[j] = __ldcs(ptr + (k0 + j) * chunk_stride);
        dk[j] = dec[(k0 + j) * sh.H];
      }
    }
  };
  fetch(cur, dcur, 0);
  float4 carry = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < sh.n_chunks; k0 += AHEAD) {
    float4 nxt[AHEAD];
    float dnxt[AHEAD];
    fetch(nxt, dnxt, k0 + AHEAD);  // the next eight chunks' loads fly during these
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      if (k0 + j < sh.n_chunks) {
        __stcs(ptr + (k0 + j) * chunk_stride, carry);  // the state entering chunk k0 + j
        carry.x = fmaf(dcur[j], carry.x, cur[j].x);
        carry.y = fmaf(dcur[j], carry.y, cur[j].y);
        carry.z = fmaf(dcur[j], carry.z, cur[j].z);
        carry.w = fmaf(dcur[j], carry.w, cur[j].w);
      }
      cur[j] = nxt[j];
      dcur[j] = dnxt[j];
    }
  }
  const int n = static_cast<int>(4 * e4 / sh.P), p = static_cast<int>(4 * e4 % sh.P);
  float* out = final_state + ((static_cast<long long>(bi) * sh.H + h) * sh.P + p) * sh.N + n;
  out[0] = carry.x;
  out[sh.N] = carry.y;
  out[2 * sh.N] = carry.z;
  out[3 * sh.N] = carry.w;
}

// ---------------------------------------------------------------- pass 3
// Grid (chunk, head pair x P slice, batch row), 128 threads, a slice of
// PT3 = 64 channels of two heads: the output tile is [64 t] x [2 x 64], so
// that each thread owns an 8 x 8 tile (rows t = 4 ty + {0..3} and
// 32 + 4 ty + {0..3}; head tx / 8, channels 4 (tx % 8) + {0..3} and 32 + ...)
// fed by two 16-byte loads of each operand a step: 0.25 shared loads per FMA.
// First y = exp(s_t) sum_n c_t[n] h_{k-1}[n][p] over the stacked heads'
// states (C^T and h as k-major tiles), in two halves of n: the copies of x
// and cb go into the space of the first half while the second computes.
// Then the scores' turn, on the same accumulators:
// y += sum_{u <= t} scores[t][u] x_u[p].  101 KB of shared memory, two CTAs
// an SM, so that one CTA's copies and barriers overlap the other's products.
constexpr int OUTPUTS_THREADS = 128;
constexpr int PT3 = 64;       // head channels per head
constexpr int COLS = 2 * PT3;  // two heads side by side
constexpr int LDT = Q + 8;     // C^T rows: the transposing copy hits 32 distinct banks
constexpr int OUTPUTS_SMEM_FLOATS = NP * LDT    // C^T [n][t]; its first half then cb [u][t]
                                    + NP * COLS  // h [n][COLS]; its halves then x, scores^T
                                    + 4 * Q;     // dt and s of the two heads
static_assert(OUTPUTS_THREADS == 2 * Q, "one thread per (head, row) builds the scores");
static_assert(Q * Q <= NP / 2 * LDT && Q * COLS <= NP / 2 * COLS && 2 * Q * Q <= NP / 2 * COLS,
              "cb, x and the scores fit in the halves");

template <typename T>
__global__ void __launch_bounds__(OUTPUTS_THREADS, 2)
ssd_chunk_outputs(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ c,
                  const float* __restrict__ cb, const float* __restrict__ states, Strides st,
                  Shape sh, T* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* sCT = reinterpret_cast<float*>(smem4);  // [NP][LDT]
  float* sH = sCT + NP * LDT;                    // [NP][COLS]
  float* sDt = sH + NP * COLS;                   // [2][Q]
  float* sS = sDt + 2 * Q;                       // [2][Q]
  float* const sG = sCT;                  // cb [u][t], over C^T's first half
  float* const sX = sH;                   // x [u][COLS], over h's first half
  float* const sScore = sH + NP / 2 * COLS;  // scores^T [2][u][t], over h's second half

  const int k = blockIdx.x, bi = blockIdx.z;
  const int n_slices = (sh.P + PT3 - 1) / PT3;
  const int p0 = (blockIdx.y % n_slices) * PT3;
  const int h0 = (blockIdx.y / n_slices) * 2;
  const int t0 = k * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int hl = tx / 8, col = hl * PT3 + 4 * (tx % 8);  // this thread's head, first column
  const long long NPsz = static_cast<long long>(sh.N) * sh.P;

  // C^T [n][t] (zero past S and N), h_{k-1} of both heads [n][COLS] (zero
  // past N, P and H), dt of both heads.
  {
    // A warp copies 8 rows t x 4 columns n: 16 bytes of each row.
    const T* cbase = c + bi * st.c[0];
    for (int i = tid; i < Q * NP; i += OUTPUTS_THREADS) {
      const int w = i / 32, l = i % 32;
      const int n = (w % (NP / 4)) * 4 + l / 8, t = (w / (NP / 4)) * 8 + l % 8, gt = t0 + t;
      const bool ok = gt < sh.S && n < sh.N;
      copy_in(sCT + n * LDT + t, ok ? cbase + gt * st.c[1] + n : c, ok);
    }
    for (int i = tid; i < NP * COLS / 4; i += OUTPUTS_THREADS) {
      const int n = i / (COLS / 4), cc = 4 * (i % (COLS / 4));
      const int h = h0 + cc / PT3, p = p0 + cc % PT3;
      const bool ok = n < sh.N && p < sh.P && h < sh.H;
      const float* src =
          states + ((static_cast<long long>(bi) * sh.n_chunks + k) * sh.H + h) * NPsz;
      copy_in16(sH + n * COLS + cc, ok ? src + n * sh.P + p : states, ok);
    }
    if (tid < 2 * Q) {
      const int h = h0 + tid / Q, gt = t0 + tid % Q;
      const bool ok = gt < sh.S && h < sh.H;
      copy_in(sDt + tid, ok ? dt + bi * st.dt[0] + gt * st.dt[1] + h * st.dt[2] : dt, ok);
    }
    commit();
    wait_copies<0>();
    __syncthreads();
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // inter-chunk: sum_n C^T[n][t] h[n][col], n in [n0, n0 + NP / 2)
  auto inter_half = [&](int n0) {
#pragma unroll 2
    for (int n = n0; n < n0 + NP / 2; ++n) {
      const float4 a0 = ld4(sCT + n * LDT + 4 * ty), a1 = ld4(sCT + n * LDT + 32 + 4 * ty);
      const float4 b0 = ld4(sH + n * COLS + col), b1 = ld4(sH + n * COLS + col + 32);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };
  inter_half(0);
  __syncthreads();  // the first halves are read: cb and x take their space

  // x of both heads [u][COLS] (zero past S, P and H), and cb
  for (int i = tid; i < Q * COLS; i += OUTPUTS_THREADS) {
    const int u = i / COLS, cc = i % COLS, gt = t0 + u;
    const int h = h0 + cc / PT3, p = p0 + cc % PT3;
    const bool ok = gt < sh.S && p < sh.P && h < sh.H;
    copy_in(sX + i, ok ? x + bi * st.x[0] + gt * st.x[1] + h * st.x[2] + p : x, ok);
  }
  {
    const float* g = cb + (static_cast<long long>(bi) * sh.n_chunks + k) * Q * Q;
    for (int i = 4 * tid; i < Q * Q; i += 4 * OUTPUTS_THREADS) copy_in16(sG + i, g + i, true);
  }
  commit();
  inter_half(NP / 2);
  if (warp < 2) {  // s = cumsum(a dt) of head h0 + warp
    float total;
    const float2 s = chunk_cumsum(sDt + warp * Q, h0 + warp < sh.H ? a[h0 + warp] : 0.0f,
                                  lane, &total);
    sS[warp * Q + 2 * lane] = s.x;
    sS[warp * Q + 2 * lane + 1] = s.y;
  }
  wait_copies<0>();
  __syncthreads();  // x, cb and s are in; h's second half is read

  // scores^T[hh][u][t] = (c_t . b_u) exp(s_t - s_u) dt_u for u <= t, else 0:
  // thread (hh, t) = (tid / 64, tid % 64) writes its column of one head.
  {
    const int hh = tid / Q, t = tid % Q;
    const float* ss = sS + hh * Q;
    const float* dd = sDt + hh * Q;
    const float s_t = ss[t];
    float* out = sScore + hh * Q * Q + t;
#pragma unroll 8
    for (int u = 0; u < Q; ++u) out[u * Q] = u <= t ? sG[u * Q + t] * expf(s_t - ss[u]) * dd[u] : 0.0f;
  }
  // the inter-chunk sum takes exp(s_t) of this thread's head
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float e = expf(sS[hl * Q + (i < 4 ? 0 : 32) + 4 * ty + (i & 3)]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] *= e;
  }
  __syncthreads();

  // intra-chunk: sum_u scores^T[hl][u][t] x[u][col]; rows of this warp's
  // threads end at t = 8 w + 39, so the scores past u = 8 w + 39 are 0.
  const float* sc = sScore + hl * Q * Q;
  const int u_end = 8 * warp + 40;
#pragma unroll 2
  for (int u = 0; u < u_end; ++u) {
    const float4 a0 = ld4(sc + u * Q + 4 * ty), a1 = ld4(sc + u * Q + 32 + 4 * ty);
    const float4 b0 = ld4(sX + u * COLS + col), b1 = ld4(sX + u * COLS + col + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }

  const int h = h0 + hl;
  if (h >= sh.H) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = (i < 4 ? 0 : 32) + 4 * ty + (i & 3), gt = t0 + t;
    if (gt >= sh.S) continue;
    T* row = y + ((static_cast<long long>(bi) * sh.S + gt) * sh.H + h) * sh.P + p0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = col % PT3 + 32 * half;
      if (p0 + p < sh.P)
        store4(row + p, acc[i][4 * half], acc[i][4 * half + 1], acc[i][4 * half + 2],
               acc[i][4 * half + 3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int run(const void* x, const void* dt, const void* a, const void* b, const void* c, void* y,
        void* state, void* chunk_states, void* decay, void* cb, int B, int S, int H, int P,
        int N, const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || N < 1 || N > NP || P < 16 || P % 16)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
  }
  for (int i = 0; i < 2; ++i) {
    st.b[i] = strides[6 + i];
    st.c[i] = strides[8 + i];
  }
  const Shape sh{S, H, P, N, (S + Q - 1) / Q};
  const dim3 grid0(sh.n_chunks, B);
  const dim3 grid1(sh.n_chunks, ((H + HEADS_PER_CTA - 1) / HEADS_PER_CTA) * ((P + PT1 - 1) / PT1),
                   B);
  const dim3 grid3(sh.n_chunks, ((H + 1) / 2) * ((P + PT3 - 1) / PT3), B);
  constexpr int cb_bytes = CB_SMEM_FLOATS * (int)sizeof(float);
  constexpr int states_bytes = STATES_SMEM_FLOATS * (int)sizeof(float);
  constexpr int outputs_bytes = OUTPUTS_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = allow_smem(ssd_chunk_cb<T>, cb_bytes);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_states<T>, states_bytes);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_outputs<T>, outputs_bytes);
  if (err != cudaSuccess) return (int)err;

  float* cs = static_cast<float*>(chunk_states);
  float* dec = static_cast<float*>(decay);
  float* cbt = static_cast<float*>(cb);
  ssd_chunk_cb<T><<<grid0, CB_THREADS, cb_bytes, s>>>(static_cast<const T*>(b),
                                                      static_cast<const T*>(c), st, sh, cbt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_states<T><<<grid1, STATES_THREADS, states_bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(b), st, sh, cs, dec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long lanes = static_cast<long long>(B) * H * N * P / 4;
  ssd_state_pass<<<(unsigned)((lanes + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS, 0, s>>>(
      cs, dec, static_cast<float*>(state), B, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_outputs<T><<<grid3, OUTPUTS_THREADS, outputs_bytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(c), cbt, cs, st, sh, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (ctypes).  strides: 10 int64 in elements: x (batch,
// sequence, head), dt (batch, sequence, head), b (batch, sequence), c (batch,
// sequence).  y is a dense [B, S, H, P], state a dense [B, H, P, N];
// chunk_states a float32 scratch of B * ceil(S / 64) * H * N * P, decay one
// of B * ceil(S / 64) * H and cb one of B * ceil(S / 64) * 64 * 64 (C B^T of
// each chunk), all 16-byte aligned.  Four launches on `stream` (C B^T, chunk
// states, state pass, outputs); returns the first cudaError_t (0 on success).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a, const void* b,
                            const void* c, void* y, void* state, void* chunk_states,
                            void* decay, void* cb, int B, int S, int H, int P, int N,
                            const long long* strides, void* stream) {
  return run<float>(x, dt, a, b, c, y, state, chunk_states, decay, cb, B, S, H, P, N, strides,
                    stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a, const void* b,
                             const void* c, void* y, void* state, void* chunk_states,
                             void* decay, void* cb, int B, int S, int H, int P, int N,
                             const long long* strides, void* stream) {
  return run<__nv_bfloat16>(x, dt, a, b, c, y, state, chunk_states, decay, cb, B, S, H, P, N,
                            strides, stream);
}

// Flash-attention forward for Hopper (sm_90a): tiled online softmax, causal
// with a query offset, sliding window, GQA/MQA.  Two designs, one per input
// type: float32 on the CUDA cores (flash_fwd), bfloat16 on the tensor cores
// (flash_fwd_tc).
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
// float32 (flash_fwd_f32<D>).  Its bound is the CUDA cores' FFMA rate (no
// tensor cores and no TF32: the reference is float32), so the design keeps
// the FFMA pipes fed: few instructions besides FFMA, and K/V copies that run
// behind the products.  One CTA of 256 threads (8 warps) per (q-tile of
// F_BQ = 64 rows, query head, batch row); the q-tile is the slowest grid
// dimension, so the longest causal tiles of every head are issued first.
//   - Register tiles.  Lane (lr, lk) of warp w, lr = lane / 16, lk = lane %
//     16, owns query rows 8 w + lr + 2 i (i = 0..3); of a tile's logits, key
//     columns lk + 16 j (j = 0..3), a 4 x 4 tile; of the output, the 16-byte
//     column chunks lk + 16 u (4 x 8 floats at D = 128, 4 x 16 at 256).  Every
//     operand comes from shared memory as a float4 (LDS.128): in S = Q K^T
//     four d cost 4 loads of Q and 4 of K for 64 FFMAs; in O += P V four keys
//     cost 4 loads of P and D / 16 of V for 4 D FFMAs.  Each word loaded
//     feeds 4 FFMAs (Q, K, V) or D / 16 (P), and one load instruction brings
//     4 words, so loads take few of the issue slots.
//   - Swizzle.  Q, K and V tiles lie [rows][D], unpadded, with 16-byte chunk
//     c of row r at c ^ (r % 8) (r % 4 at D = 16, whose rows have 4 chunks),
//     P [64][64] likewise; a load's rows (the 16 keys lk + 16 j, or Q's and
//     P's 2 rows a warp) then hit distinct banks.  A lane's offsets follow
//     from lk % 8 and the parity of lr, with one XOR a K or V load.
//   - A ring of K/V half-tiles.  K and V tiles of F_BK = 64 keys take turns
//     in STAGES slots (K of tile t, V of t, K of t + 1, ...), copied with
//     cp.async (16 bytes a copy, rows past Skv zero-filled) by every thread,
//     one commit group a half-tile.  Before each half-tile a thread waits for
//     its own copies of it (cp.async.wait_group STAGES - 2), one
//     __syncthreads makes everyone's visible and frees the slot of the half
//     before, and the copy STAGES - 1 halves ahead goes into that slot before
//     the product starts: V_t lands behind S_t and K_t+1 behind P_t V_t.  Two
//     barriers a tile.
//   - P goes to shared memory between the products; a row's 64 entries are
//     written and read by the 16 lanes of one half-warp.
//   - Shared memory: Q [64][D] + P [64][64] + STAGES x [64][D] floats.  D =
//     128: 2 stages, 112 KB, two CTAs an SM (at most 128 registers a thread).
//     D = 256: 2 stages, 208 KB of the 227 a CTA may have, one CTA (K and V
//     staged apart: two whole K + V stages would take 336 KB).  D = 160: 3
//     stages, 176 KB, one CTA.  D = 32 and 64: 3 stages, two CTAs; D = 16
//     one (at two, its 128 registers spilled).
//   - Arithmetic: the TPU kernel's operations (Q pre-scaled on load, the
//     masks, expf, the running max and correction, P in float32, the 1e-30
//     clamp), the logits summed over d and P V over the keys in order by
//     fmaf; a row's max and sum reduce over the 16 lanes of a half-warp.
//   - Inputs: the copies need 16-byte aligned rows (a 16-byte aligned start;
//     batch, head and sequence strides multiples of 4 elements).  The wrapper
//     copies any other float32 input once and counts it.
// The instances are D = 16, 32, 64, 128, 160 and 256; the wrapper zero-pads
// any other D <= 256 to the next one (zero columns change neither q . k nor
// the output's real columns) and passes the true D's scale.  It refuses D >
// 256: at D = 320 the float32 design's Q, P and two half-tile slots would
// take 256 KB.
//
// Bound.  At the main path's shape ([4, 24, 1000, 128], causal) the two
// products are 4 * D flops per allowed (query, key) pair: about 24.6 GFLOP
// against 131 MB (float32) or 66 MB (bf16) of q, k, v and o, so both types
// are bound by operations: 0.37 ms at 67 TFLOP/s float32, 0.025 ms at 989
// TFLOP/s on the bf16 tensor cores (bytes: 0.04 and 0.02 ms).  The float32
// design reaches ~45% of its bound on an H100.  tools/flash_f32_probe.py
// times it with one cost taken out at a time (PERF.md): its FFMAs alone run
// at 54-60% of the bound, at the full clock, so they take most of the gap;
// operand loads, copies and barriers the rest, none much above a tenth.  Larger register tiles
// (8 rows a thread) cost the warps that hide latency and ran no faster.
//
// bfloat16 (flash_fwd_tc<D>).  Its bound is the tensor cores', 15x below the
// float32 one, so both products run as wgmma.mma_async m64n64k16, bf16 in,
// float32 accumulate.  One CTA of two warpgroups per (q-tile of TC_BQ = 128
// rows, query head, batch row); each warpgroup owns 64 query rows.
//   - Tiles move by TMA (cp.async.bulk.tensor) in 64 x 64 boxes, described
//     by tensor maps over the caller's strides (the wrapper passes only
//     16-byte aligned ones and copies any other input); rows and columns
//     past the tensor arrive as zeros.  Q comes once; K and V tiles of
//     TC_BK = 64 keys go through a ring of 2 stages (3 at D = 160), each
//     with a "full" mbarrier that the copies complete and an "empty" one
//     that every consumer warp signs.  Thread 0 keeps the ring STAGES - 1
//     tiles ahead: it refills the stage of tile t - 1 once that is signed.
//     There is no CTA-wide barrier in the loop, so the two warpgroups drift
//     apart and one's softmax overlaps the other's products.  At D <= 128
//     two CTAs share an SM (128 registers a thread), so one's prologue and
//     epilogue hide behind the other's products.  (Copies issued by every
//     thread with cp.async and a __syncthreads pair per tile were slower:
//     the copies and barriers held the consumers in lockstep; a producer
//     warp issuing them alone could not keep up with two warpgroups.)
//   - Every tile lies [D / 64 column blocks][rows][64] with the 128-byte
//     swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)) that both the
//     tensor maps and the wgmma descriptors name; a block's 8-row groups are
//     1024 bytes apart.  S = Q K^T: A = Q and B = K, both K-major (D
//     contiguous), D / 16 steps of k16.  O += P V: B = V, the transposed
//     (MN-major) operand that bf16 allows, one m64n64 product per 64 output
//     columns.
//   - The online softmax stays in float32 registers.  The scale, folded with
//     log2 e, goes into the exponent (one FFMA, then ex2.approx) on a tile
//     without masked keys; a tile with any is scaled and masked first, as
//     above.  The running max, sum, correction and the 1e-30 clamp are as
//     above.  A row is held by the four threads of a quad (max by two
//     shuffles; the sum is reduced once, at the end).
//   - P is rounded to bf16 in registers.  The logits' accumulator fragment
//     of a 16-key slice is, element for element, the register A operand of
//     the next product, so P never goes to shared memory.  This is the one
//     place the bf16 result departs from float32 arithmetic: the TPU kernel
//     and the float32 design keep P in float32.
//   - Head dims 16 and 32 take one column block (only D / 16 k-steps of the
//     logits run) and 160 takes three (192 output columns, of which 160 are
//     stored); shared memory is 1 KB (alignment) + 128 x D_b + STAGES x 2 x
//     64 x D_b bytes and the barriers, D_b = 128 * ceil(D / 64): 49 KB at
//     D <= 64, 97 KB at 128, 193 KB at 160 and at 256.
//   - Each warpgroup runs only the tiles of its own 64 rows' band (the
//     float32 rule below, per 64 rows), so a causal CTA's first warpgroup
//     idles on the last tiles; the CTA walks the union.  CTAs are issued
//     longest q-tile first over all heads (the q-tile is the slowest grid
//     dimension), which balances the causal grid's tail.
//
// Tiles that lie wholly outside the causal or window band of all the rows
// (of a CTA, or of a warpgroup in the bf16 design) are skipped.  For a row
// with at least one allowed key that changes nothing: a fully masked tile
// seen before the row's first allowed key adds p = exp(-1e30 - (-1e30)) = 1
// terms that the later correction exp(-1e30 - m) = 0 wipes out, and one seen
// after adds exp(-1e30 - m) = 0.  Key columns past Skv are not part of the
// input: their logit is -inf, so they add exactly 0 (the TPU kernel pads them
// and masks them to -1e30, which gives the same result for every row with an
// allowed key).

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime, no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -1e30f;  // the reference's NEG_INF

// ------------------------------------------------------------ float32, CUDA cores

constexpr int F_THREADS = 256;  // 8 warps; 16 lanes share a row
constexpr int F_BQ = 64;        // query rows a CTA: 8 a warp, 4 a thread
constexpr int F_BK = 64;        // keys a K or V tile: 4 of a tile's logits a thread

struct Strides {  // in elements: batch, head, sequence (the last dim is unit-stride)
  long long q[3], k[3], v[3], o[3];
};

template <int D>
struct F32Tile {
  static constexpr int DC = D / 4;               // 16-byte chunks a row
  static constexpr int SW = DC < 8 ? DC - 1 : 7;  // chunk c of row r lies at c ^ (r & SW)
  static constexpr int G = SW + 1;               // chunks a swizzle period
  static constexpr int NU = (DC + 15) / 16;      // output chunks a thread: lk + 16 u
  static constexpr bool PARTIAL = 16 * NU > DC;  // the last of them only for lk + 16 u < DC
  static constexpr int STAGES = (D == 128 || D == 256) ? 2 : 3;  // K/V half-tile slots
  // Two CTAs an SM cap a thread at 128 registers; D = 16, whose whole logits
  // product is one unrolled block, spills under that cap, so it takes one.
  static constexpr int CTAS_PER_SM = D <= 128 && D != 16 ? 2 : 1;
  static constexpr int SLOT = F_BK * D;          // floats of one K or V tile
  static constexpr int SMEM = 4 * (F_BQ * D + F_BQ * F_BK + STAGES * SLOT);  // Q, P, ring
  // Hopper: 227 KB a CTA; two CTAs share 228 KB, with 1 KB reserved for each.
  static_assert(SMEM <= 232448, "a CTA's shared memory exceeds Hopper's 227 KB");
  static_assert(CTAS_PER_SM == 1 || CTAS_PER_SM * (SMEM + 1024) <= 233472,
                "CTAS_PER_SM CTAs do not fit an SM's shared memory");
  static_assert(D % 16 == 0 && F_BK % 16 == 0, "a tile is whole 16-byte chunks");
};

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

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes from global memory to shared memory, asynchronously; zeros when
// src_bytes is 0 (nothing is read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// acc (+)= a * b, element by element over b's four lanes.
__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS, F32Tile<D>::CTAS_PER_SM)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Strides st, int group, int Sq,
              int Skv, float scale, int causal, int window, int q_offset) {
  using L = F32Tile<D>;
  constexpr int DC = L::DC, SW = L::SW, G = L::G, NU = L::NU, STAGES = L::STAGES;
  extern __shared__ float4 f32_smem[];
  float* sq = reinterpret_cast<float*>(f32_smem);  // [F_BQ][D], pre-scaled
  float* sp = sq + F_BQ * D;                       // [F_BQ][F_BK]
  float* ring = sp + F_BQ * F_BK;                  // STAGES x [F_BK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lr = (tid >> 4) & 1, lk = tid & 15;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * F_BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];

  // Key tiles that can hold an allowed key for some row of this CTA.
  const int q_last = min(q0 + F_BQ, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + q_offset + 1);
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1);
  if (kv_lo >= kv_hi) {  // no row has an allowed key: take every tile, as the reference does
    kv_lo = 0;
    kv_hi = Skv;
  }
  const int t_lo = kv_lo / F_BK, t_hi = (kv_hi + F_BK - 1) / F_BK;
  const int halves = 2 * (t_hi - t_lo);  // K of tile t_lo, V of t_lo, K of t_lo + 1, ...

  // Half-tile n into slot n % STAGES, one commit group (empty past the last).
  // Where a row's chunks divide the CTA (D != 160), a thread copies chunk cc
  // of rows cr + RSTEP m; as RSTEP % 4 == 0, row cr + RSTEP m's swizzle is
  // cr's, with bit 2 flipped for odd m when RSTEP % 8 == 4 (D = 256).
  constexpr int RSTEP = F_THREADS % DC == 0 ? F_THREADS / DC : 0;
  const int cr = RSTEP ? tid / DC : 0, cc = RSTEP ? tid % DC : 0;
  const int cx = cc ^ (cr & SW);
  const int d_even = cr * D + 4 * cx, d_odd = cr * D + 4 * (cx ^ 4);
  auto issue = [&](int n) {
    if (n < halves) {
      const int k0 = (t_lo + (n >> 1)) * F_BK;
      const float* src = (n & 1) ? vb : kb;
      const long long rs = (n & 1) ? st.v[2] : st.k[2];
      float* dst = ring + (n % STAGES) * L::SLOT;
      if constexpr (RSTEP != 0) {
        static_assert(RSTEP % 4 == 0 && F_BK % RSTEP == 0, "rows a pass");
        const float* s0 = src + (k0 + cr) * rs + cc * 4;
#pragma unroll
        for (int m = 0; m < F_BK / RSTEP; ++m) {
          const bool in = k0 + cr + RSTEP * m < Skv;
          const int d = (((RSTEP * m) & SW) ? d_odd : d_even) + RSTEP * m * D;
          cp_async16(dst + d, in ? s0 + RSTEP * m * rs : src, in ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int m = 0; m < F_BK * DC / F_THREADS; ++m) {
          const int i = tid + m * F_THREADS, r = i / DC, c = i % DC, row = k0 + r;
          const bool in = row < Skv;
          cp_async16(dst + r * D + 4 * (c ^ (r & SW)), in ? src + row * rs + 4 * c : src,
                     in ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) issue(n);

  for (int i = tid; i < F_BQ * DC; i += F_THREADS) {
    const int r = i / DC, c = i % DC, row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < Sq) {
      x = __ldg(reinterpret_cast<const float4*>(qb + row * st.q[2]) + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(sq + r * D + 4 * (c ^ (r & SW))) = x;
  }

  // This lane's rows are row0 + 2 i; their swizzle is (2 i & SW) ^ lr, so a
  // Q or P chunk y ^ lr lies at y + lr (y even) or y - lr (y odd).  Its keys
  // lk + 16 j share lk & SW: K and V chunk x of a swizzle period lies at
  // x ^ (lk & SW), 4 (x ^ (lk & SW)) = (4 x) ^ lk4 floats into it.
  const int row0 = 8 * warp + lr, lk4 = 4 * (lk & SW);
  const float* q_even = sq + row0 * D + 4 * lr;
  const float* q_odd = sq + row0 * D - 4 * lr;
  const float* p_row = sp + row0 * F_BK;
  const bool lk_in = !L::PARTIAL || lk + 16 * (NU - 1) < DC;

  float m[4], l[4], s[4][4];
  float4 acc[4][NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int n = 0; n < halves; ++n) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of half n have landed
    __syncthreads();              // everyone's have, and half n - 1 is done with
    issue(n + STAGES - 1);        // into the slot of half n - 1
    const float* tile = ring + (n % STAGES) * L::SLOT;
    const int k0 = (t_lo + (n >> 1)) * F_BK;

    if (!(n & 1)) {  // S = Q K^T, then the online softmax; P to shared memory
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      }
      const float* k_row = tile + lk * D;
#pragma unroll 1
      for (int c0 = 0; c0 < DC; c0 += G) {
#pragma unroll
        for (int x = 0; x < G; ++x) {
          float4 qa[4], ka[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int y = x ^ ((2 * i) & SW);
            qa[i] = lds4(((y & 1) ? q_odd : q_even) + 2 * i * D + 4 * (c0 + y));
          }
          const float* kx = k_row + 4 * c0 + ((4 * x) ^ lk4);
#pragma unroll
          for (int j = 0; j < 4; ++j) ka[j] = lds4(kx + 16 * j * D);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
              s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
              s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
              s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + 2 * i, q_pos = q0 + row + q_offset;
        float row_max = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k_pos = k0 + lk + 16 * j;
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
          sp[row * F_BK + 4 * (((lk >> 2) + 4 * j) ^ (row & 7)) + (lk & 3)] = p;
          row_sum += p;
        }
        l[i] = corr * l[i] + half_warp_sum(row_sum);
        m[i] = m_new;
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          acc[i][u].x *= corr;
          acc[i][u].y *= corr;
          acc[i][u].z *= corr;
          acc[i][u].w *= corr;
        }
      }
    } else {  // O += P V, keys in order; P's chunk z of a 16-key group g lies
              // at 4 (g ^ (i >> 1)) + (z ^ 2 (i & 1)) ^ lr for row i
      const float* v_row = tile + 4 * (lk & ~SW);
#pragma unroll 1
      for (int g = 0; g < F_BK / 16; ++g) {
        const float* p_g[2] = {p_row + 16 * g, p_row + 16 * (g ^ 1)};
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          float4 pa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int y = z ^ (2 * (i & 1));
            pa[i] = lds4(p_g[i >> 1] + 2 * i * F_BK + 4 * y + ((y & 1) ? -4 * lr : 4 * lr));
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int key = 16 * g + 4 * z + jj;
            const float* vk = v_row + key * D + ((4 * ((4 * z + jj) & SW)) ^ lk4);
            float4 vv[NU];
#pragma unroll
            for (int u = 0; u < NU; ++u) {
              vv[u] = (u < NU - 1 || lk_in) ? lds4(vk + 64 * u) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
#pragma unroll
              for (int u = 0; u < NU; ++u) fma4(acc[i][u], p, vv[u]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA (the last groups are empty)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + row0 + 2 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float4* orow = reinterpret_cast<float4*>(ob + row * st.o[2]);
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      if (u < NU - 1 || lk_in) {
        const float4 a = acc[i][u];
        orow[lk + 16 * u] = make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
               int Sq, int Skv, const long long* strides, float scale, int causal, int window,
               int q_offset, cudaStream_t stream) {
  constexpr int bytes = F32Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid(Hq, B, (Sq + F_BQ - 1) / F_BQ);
  flash_fwd_f32<D><<<grid, F_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, Hq / Hkv, Sq, Skv, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// Registers a thread and resident CTAs an SM of the instance for head dim D.
template <int D>
int instance_occupancy(int* registers, int* ctas_per_sm) {
  constexpr int bytes = F32Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, flash_fwd_f32<D>);
  if (err == cudaSuccess) {
    *registers = attr.numRegs;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, flash_fwd_f32<D>,
                                                        F_THREADS, bytes);
  }
  return (int)err;
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                 int Sq, int Skv, int D, const long long* strides, float scale, int causal,
                 int window, int q_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_f32<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 32: return launch_f32<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 64: return launch_f32<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 128: return launch_f32<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 160: return launch_f32<160>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 256: return launch_f32<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int occupancy_f32(int D, int* registers, int* ctas_per_sm) {
  switch (D) {
    case 16: return instance_occupancy<16>(registers, ctas_per_sm);
    case 32: return instance_occupancy<32>(registers, ctas_per_sm);
    case 64: return instance_occupancy<64>(registers, ctas_per_sm);
    case 128: return instance_occupancy<128>(registers, ctas_per_sm);
    case 160: return instance_occupancy<160>(registers, ctas_per_sm);
    case 256: return instance_occupancy<256>(registers, ctas_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ bfloat16, wgmma

constexpr int TC_WG = 2;                 // consumer warpgroups a CTA
constexpr int TC_THREADS = 128 * TC_WG;
constexpr int TC_BQ = 64 * TC_WG;        // query rows a CTA
constexpr int TC_BK = 64;                // keys a K/V tile
constexpr int TC_BOX = 64 * 64 * 2;      // bytes of one TMA box: 64 rows x 64 columns
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcTile {
  static constexpr int DB = (D + 63) / 64;              // 64-column (128-byte) blocks
  // K/V tiles in the ring; at D <= 128 two CTAs share an SM (97 KB each).
  static constexpr int STAGES = D == 160 ? 3 : 2;
  static constexpr int CTAS_PER_SM = D <= 128 ? 2 : 1;
  static constexpr int Q_BYTES = DB * TC_BQ * 128;
  static constexpr int KV_BYTES = DB * TC_BK * 128;     // K or V, one stage
  // 1 KB aligns the swizzle atoms; Q's barrier and two a stage follow the tiles.
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 + STAGES * 16;
  // Hopper: 227 KB a CTA; two CTAs share 228 KB, with 1 KB reserved for each.
  static_assert(SMEM <= 232448, "a CTA's shared memory exceeds Hopper's 227 KB");
  static_assert(CTAS_PER_SM == 1 || CTAS_PER_SM * (SMEM + 1024) <= 233472,
                "CTAS_PER_SM CTAs do not fit an SM's shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Arrives and announces `bytes` of TMA copies that will complete the phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT%=;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One 64 x 64 box of a [B][H][S][D] bf16 tensor (coordinates innermost
// first: column, row, head, batch) into shared memory at dst, 128-byte
// swizzled; rows and columns outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
         "r"(batch), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset, stride byte offset (between 8-row groups: 1024), all >> 4.
// The K-major operands (Q, K) ignore the leading offset (a k16 step lies in
// one 128-byte row); V, MN-major, has one 64-column atom per product, so its
// leading offset is never stepped either.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving register reads or writes across a wgmma's
// issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define ACC8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d) ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in shared
// memory (transposed: tnsp-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC32
#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the special-function unit (relative error ~2^-22; -inf and -1e30
// give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key tiles [lo, hi) that can hold an allowed key for some of the 64 rows
// from r0 (the float32 CTA's rule); empty when the rows start past Sq.
__device__ __forceinline__ void band_tiles(int r0, int Sq, int Skv, int causal, int window,
                                           int q_offset, int& lo, int& hi) {
  if (r0 >= Sq) {
    lo = hi = 0;
    return;
  }
  const int q_last = min(r0 + 64, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + q_offset + 1);
  if (window > 0) kv_lo = max(0, r0 + q_offset - window + 1);
  if (kv_lo >= kv_hi) {  // no row has an allowed key: take every tile, as the reference does
    kv_lo = 0;
    kv_hi = Skv;
  }
  lo = kv_lo / TC_BK;
  hi = (kv_hi + TC_BK - 1) / TC_BK;
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, TcTile<D>::CTAS_PER_SM)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
             long long o_batch, long long o_head, long long o_row, int group, int Sq, int Skv,
             float scale_log2, int causal, int window, int q_offset) {
  using L = TcTile<D>;
  constexpr int DB = L::DB, STAGES = L::STAGES;
  extern __shared__ unsigned char tc_smem[];
  const uint32_t sq = (smem_u32(tc_smem) + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t skv = sq + L::Q_BYTES;  // stage s: K at skv + 2 s KV_BYTES, V after it
  // Stage s is full when its TMA copies have landed, and empty again when
  // every consumer warp is done with it.
  const uint32_t qbar = skv + STAGES * 2 * L::KV_BYTES, full = qbar + 8,
                 empty = full + STAGES * 8;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // The q-tile is the slowest grid dimension, so the longest causal tiles of
  // every head are issued first.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / group;

  // The CTA walks the union of its warpgroups' bands; each computes its own.
  int my_lo = 0, my_hi = 0, t_lo = 0, t_hi = 0;
#pragma unroll
  for (int g = 0; g < TC_WG; ++g) {
    int lo, hi;
    band_tiles(q0 + 64 * g, Sq, Skv, causal, window, q_offset, lo, hi);
    if (g == wg) {
      my_lo = lo;
      my_hi = hi;
    }
    if (lo < hi) {
      t_lo = t_hi > t_lo ? min(t_lo, lo) : lo;
      t_hi = max(t_hi, hi);
    }
  }

  // Thread 0 drives the copies: tile t goes to stage (t - t_lo) % STAGES.
  auto load_kv = [&](int t, int stage) {
    const uint32_t dst = skv + stage * 2 * L::KV_BYTES, bar = full + 8 * stage;
    mbar_expect(bar, 2 * L::KV_BYTES);
#pragma unroll
    for (int nb = 0; nb < DB; ++nb) {
      tma_load(dst + nb * TC_BOX, &tk, bar, 64 * nb, t * TC_BK, hk, b);
      tma_load(dst + L::KV_BYTES + nb * TC_BOX, &tv, bar, 64 * nb, t * TC_BK, hk, b);
    }
  };
  if (tid == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, TC_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // seen by the TMA unit
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(qbar, L::Q_BYTES);
#pragma unroll
    for (int nb = 0; nb < DB; ++nb) {
#pragma unroll
      for (int g = 0; g < TC_WG; ++g)
        tma_load(sq + nb * (TC_BQ * 128) + g * TC_BOX, &tq, qbar, 64 * nb, q0 + 64 * g, h, b);
    }
    for (int a = 0; a + 1 < STAGES && t_lo + a < t_hi; ++a) load_kv(t_lo + a, a);
  }
  mbar_wait(qbar, 0);

  // Thread (warp, lane) of a warpgroup holds rows r and r + 8, r = 16 warp +
  // lane / 4, and, of each 8-column block, columns 2 (lane % 4) and + 1.
  const uint32_t sqw = sq + wg * TC_BOX;
  const int row0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int col = 2 * (lane & 3);
  const int wq_first = q0 + 64 * wg + q_offset, wq_last = wq_first + 63;
  float acc[DB][32], m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < DB; ++nb) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[nb][i] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int n = t - t_lo, stage = n % STAGES;
    // Refill the stage of tile t - 1 with tile t + STAGES - 1 once every warp
    // has signed it off; a warpgroup that runs ahead never waits here.
    if (tid == 0 && t + STAGES - 1 < t_hi) {
      if (n > 0) mbar_wait(empty + 8 * ((n - 1) % STAGES), ((n - 1) / STAGES) & 1);
      load_kv(t + STAGES - 1, (n + STAGES - 1) % STAGES);
    }
    mbar_wait(full + 8 * stage, (n / STAGES) & 1);
    if (t >= my_lo && t < my_hi) {  // uniform over the warpgroup
      const uint32_t sk = skv + stage * 2 * L::KV_BYTES, sv = sk + L::KV_BYTES;
      const int k0 = t * TC_BK;
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // k16 step inside a 128-byte row
        wgmma_ss(s, sw128_desc(sqw + (kk >> 2) * (TC_BQ * 128) + off, 16),
                 sw128_desc(sk + (kk >> 2) * TC_BOX + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // s[4 j + e]: row row0 + 8 (e / 2), key k0 + 8 j + col + e % 2.  A tile
      // with a masked or missing key is scaled and masked here; any other
      // keeps its raw logits and folds the scale into the exponent below.
      const bool edge = k0 + TC_BK > Skv || (causal && k0 + TC_BK - 1 > wq_first) ||
                        (window > 0 && k0 <= wq_last - window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int k_pos = k0 + (i >> 2) * 8 + col + (i & 1);
          const int q_pos = row0 + ((i >> 1) & 1) * 8 + q_offset;
          float x = s[i] * scale_log2;
          if (k_pos >= Skv) x = -INFINITY;
          else if ((causal && k_pos > q_pos) || (window > 0 && k_pos <= q_pos - window)) x = MASKED;
          s[i] = x;
        }
      }
      const float mul = edge ? 1.f : scale_log2;
      float neg_m[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx[j] = fmaxf(fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]),
                        fmaxf(s[4 * j + 16 + 2 * r], s[4 * j + 17 + 2 * r]));
        const float row_max = quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
        const float m_new = fmaxf(m[r], row_max * mul);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        neg_m[r] = -m_new;
      }
      // P's 16-key slice c is the A fragment {s[8c..8c+7]} in bf16 pairs.
      uint32_t pa[TC_BK / 16][4];
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < TC_BK / 16; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p0 = ex2(fmaf(s[8 * c + 2 * e], mul, neg_m[e & 1]));
          const float p1 = ex2(fmaf(s[8 * c + 2 * e + 1], mul, neg_m[e & 1]));
          sum[e & 1][c & 1] += p0 + p1;
          pa[c][e] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + (sum[r][0] + sum[r][1]);
#pragma unroll
      for (int nb = 0; nb < DB; ++nb) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[nb][i] *= corr[(i >> 1) & 1];
        fence_regs(acc[nb]);
      }
#pragma unroll
      for (int c = 0; c < TC_BK / 16; ++c) fence_regs(pa[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < TC_BK / 16; ++c) {
#pragma unroll
        for (int nb = 0; nb < DB; ++nb) {
          wgmma_rs(acc[nb], pa[c], sw128_desc(sv + nb * TC_BOX + c * (16 * 128), 1024));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < DB; ++nb) fence_regs(acc[nb]);
    }
    // Every warp signs off (after its wgmma wait), so none can fall a whole
    // ring behind and mistake a later phase of `full` for this one.
    if (lane == 0) mbar_arrive(empty + 8 * stage);
  }

  __nv_bfloat16* ob = o + b * o_batch + h * o_head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float inv = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + row * o_row;
#pragma unroll
    for (int nb = 0; nb < DB; ++nb) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (nb * 64 + j * 8 >= D) continue;
        *reinterpret_cast<__nv_bfloat162*>(orow + nb * 64 + j * 8 + col) =
            __floats2bfloat162_rn(acc[nb][4 * j + 2 * r] * inv, acc[nb][4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The [B][H][S][D] bf16 tensor at ptr (strides in elements: batch, head,
// sequence; D unit-stride) as 64 x 64 boxes, 128-byte swizzled.  A dim of
// size 1 is never stepped, so any legal stride stands in for its own.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
                const long long* strides) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const int sizes[3] = {S, H, B};
  const long long elems[3] = {strides[2], strides[1], strides[0]};
  cuuint64_t bytes[3];
  for (int i = 0; i < 3; ++i) bytes[i] = sizes[i] == 1 ? 16 : (cuuint64_t)elems[i] * 2;
  const cuuint32_t box[4] = {64, 64, 1, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, bytes,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
              int Sq, int Skv, const long long* strides, float scale, int causal, int window,
              int q_offset, cudaStream_t stream) {
  constexpr int bytes = TcTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Hq, Sq, D, strides) || !tensor_map(&tk, k, B, Hkv, Skv, D, strides + 3) ||
      !tensor_map(&tv, v, B, Hkv, Skv, D, strides + 6))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, B, (Sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_tc<D><<<grid, TC_THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), strides[9], strides[10], strides[11], Hq / Hkv,
      Sq, Skv, scale * LOG2E, causal, window, q_offset);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                int Sq, int Skv, int D, const long long* strides, float scale, int causal,
                int window, int q_offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 32: return launch_tc<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 64: return launch_tc<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 128: return launch_tc<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 160: return launch_tc<160>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
    case 256: return launch_tc<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, strides, scale, causal, window, q_offset, s);
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
  return dispatch_f32(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, scale, causal, window,
                      q_offset, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int B, int Hq, int Hkv, int Sq, int Skv, int D,
                                    const long long* strides, float scale, int causal,
                                    int window, int q_offset, void* stream) {
  return dispatch_tc(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, strides, scale, causal, window,
                     q_offset, stream);
}
// Registers a thread and resident CTAs an SM of the float32 instance for head
// dim D.  Returns a cudaError_t (0 = success).
extern "C" int flash_attention_f32_occupancy(int D, int* registers, int* ctas_per_sm) {
  return occupancy_f32(D, registers, ctas_per_sm);
}

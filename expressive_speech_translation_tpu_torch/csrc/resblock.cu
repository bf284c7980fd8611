// One HiFi-GAN stage's resblock battery in one launch, hand-written for
// Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_vocoder.py,
//           fused_resblock_stage (Pallas kernel `_stage_kernel`).
//
// Computes, for every kernel-size branch (3, 7, 11 on the main path) with its
// dilations (1, 3, 5):
//   h = x;  for d: h += c2(lrelu(c1(lrelu(h), d)), 1)
// and returns the mean of the branches' h. Before every conv the input is
// zeroed outside [0, T), which is XLA's per-conv zero padding. Conv operands
// are in the io dtype (bf16 in serving, f32 in tests) and the sums in f32, as
// the JAX kernel does; the branch state h stays f32 between convs.
//
// What bounds it on the H100: operations. A stage costs 2 * C^2 * T * 126
// FLOP (126 taps over the 18 convs): 248 GFLOP for stage 3 of 10 s of speech
// (C=64, T=240000), against ~61 MB of bf16 in and out: 0.25 ms at the
// 989 TFLOP/s bf16 tensor-core peak. Two variants compute the same stage:
// serving (bf16, C % 32 == 0) runs each conv's per-tap product on the tensor
// cores (mma.sync m16n8k16, see resblock_stage_mma_kernel); f32 io, and
// channel counts that are not a multiple of 32, run it as FP32 FMA on the CUDA
// cores (resblock_stage_kernel).
//
// Design: a block owns one batch row and one time window of W columns across
// all C channels, because every conv mixes all channels and the 18 convs run
// in sequence. The window carries a halo of the stage's receptive half-width
// (60 on the main path) per side and writes only its W - 2 * halo centre
// columns, so no block needs another's data; the halo is recomputed per
// window. Shared memory holds the branch state h [C][W] in f32 and the conv
// operand a = io(lrelu(mask(.))) in the io dtype, with 32 zero columns on
// each side so dilated taps never branch. The branch sum goes to an f32
// scratch row in device memory, and the last branch writes the mean in the
// io dtype through shared memory, so the output is written once.
//
// CUDA-core variant: W = 32 * RT; warp w owns output channels 8w..8w+7 and
// lane l owns columns l, l + 32, ...: its reads of a [C][W + 64] are
// conflict-free and its 8 weights per (tap, input channel) are one broadcast
// load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RC = 8;      // output channels per thread (one warp's share)
constexpr int PADA = 32;   // zero columns each side of an operand row
constexpr int MAX_BRANCH = 4;
constexpr int MAX_DIL = 4;

struct StageArgs {
  const void* x;      // [B, T, C] logical, element strides below
  void* out;          // [B, T, C] logical
  float* sum;         // [B, C, T] f32 scratch for the branch sum
  const void* w;      // [taps, C_in, C_out] io dtype, branches/units in order
  const void* bias;   // [convs, C] io dtype
  long long sxb, sxt, sxc, sob, sot, soc;
  int T, C, halo;
  int n_branch;
  int ks[MAX_BRANCH];
  int n_dil[MAX_BRANCH];
  int dil[MAX_BRANCH][MAX_DIL];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

// 8 consecutive weights (one warp's output channels) as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[RC]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[RC]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// acc[r][s] = bias[co0 + r] + sum_{ci, j} w[j][ci][co0 + r] * a[ci][t_s + (j - K/2) d]
// with t_s = lane + 32 s. `a` points at column 0 of row 0 (past the margin).
template <typename T, int RT, int K>
__device__ __forceinline__ void conv(float (&acc)[RC][RT], const T* a, int arow,
                                     const T* __restrict__ w,
                                     const T* __restrict__ bias, int C, int d,
                                     int co0, int lane) {
  constexpr int HALF = (K - 1) / 2;
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int s = 0; s < RT; ++s) acc[r][s] = 0.f;
  for (int ci = 0; ci < C; ++ci) {
    const T* row = a + ci * arow + lane;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int off = (j - HALF) * d;
      float wv[RC];
      load8(w + ((size_t)j * C + ci) * C + co0, wv);
#pragma unroll
      for (int s = 0; s < RT; ++s) {
        const float v = to_f(row[32 * s + off]);
#pragma unroll
        for (int r = 0; r < RC; ++r) acc[r][s] = fmaf(wv[r], v, acc[r][s]);
      }
    }
  }
  float bv[RC];
#pragma unroll
  for (int r = 0; r < RC; ++r) bv[r] = to_f(bias[co0 + r]);
#pragma unroll
  for (int r = 0; r < RC; ++r)
#pragma unroll
    for (int s = 0; s < RT; ++s) acc[r][s] += bv[r];
}

template <typename T, int RT>
__device__ __forceinline__ void conv_k(int k, float (&acc)[RC][RT], const T* a,
                                       int arow, const T* w, const T* bias,
                                       int C, int d, int co0, int lane) {
  switch (k) {
    case 3: conv<T, RT, 3>(acc, a, arow, w, bias, C, d, co0, lane); break;
    case 5: conv<T, RT, 5>(acc, a, arow, w, bias, C, d, co0, lane); break;
    case 7: conv<T, RT, 7>(acc, a, arow, w, bias, C, d, co0, lane); break;
    case 9: conv<T, RT, 9>(acc, a, arow, w, bias, C, d, co0, lane); break;
    default: conv<T, RT, 11>(acc, a, arow, w, bias, C, d, co0, lane); break;
  }
}

template <typename T, int RT>
__global__ void __launch_bounds__(512, 1) resblock_stage_kernel(StageArgs p) {
  constexpr int W = 32 * RT;
  constexpr int HROW = W + 1;             // +1: transposed loads hit distinct banks
  constexpr int AROW = W + 2 * PADA;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C;
  float* h_s = reinterpret_cast<float*>(smem);
  const size_t h_bytes = ((size_t)C * HROW * sizeof(float) + 15) & ~(size_t)15;
  T* a_s = reinterpret_cast<T*>(smem + h_bytes);
  T* a0 = a_s + PADA;                     // column 0 of row 0

  const int lane = threadIdx.x & 31;
  const int co0 = (threadIdx.x >> 5) * RC;
  const int nthreads = blockDim.x;
  const int tile = W - 2 * p.halo;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - p.halo;  // global time of window column 0
  const int T_len = p.T;
  const T* x = static_cast<const T*>(p.x) + (size_t)b * p.sxb;
  T* out = static_cast<T*>(p.out) + (size_t)b * p.sob;
  float* sum = p.sum + (size_t)b * C * T_len;
  const T* w = static_cast<const T*>(p.w);
  const T* bias = static_cast<const T*>(p.bias);
  const bool x_c_fast = p.sxc == 1;
  const bool o_c_fast = p.soc == 1;

  for (int i = threadIdx.x; i < C * 2 * PADA; i += nthreads) {
    const int c = i / (2 * PADA), m = i - c * 2 * PADA;
    a_s[c * AROW + (m < PADA ? m : W + m)] = from_f<T>(0.f);
  }

  int tap = 0, conv_idx = 0;
  for (int br = 0; br < p.n_branch; ++br) {
    const int k = p.ks[br];
    // h = x over the window (zero outside [0, T)); walk memory in its
    // contiguous direction
    for (int i = threadIdx.x; i < C * W; i += nthreads) {
      int c, t;
      if (x_c_fast) { c = i % C; t = i / C; } else { c = i / W; t = i - c * W; }
      const int tg = t0 + t;
      h_s[c * HROW + t] = (tg >= 0 && tg < T_len)
                              ? to_f(x[(size_t)tg * p.sxt + (size_t)c * p.sxc]) : 0.f;
    }
    __syncthreads();
    for (int u = 0; u < p.n_dil[br]; ++u) {
      const int d = p.dil[br][u];
      // a = io(lrelu(h)), zero outside [0, T)
      for (int i = threadIdx.x; i < C * W; i += nthreads) {
        const int c = i / W, t = i - c * W;
        const int tg = t0 + t;
        a0[c * AROW + t] = from_f<T>((tg >= 0 && tg < T_len) ? lrelu(h_s[c * HROW + t]) : 0.f);
      }
      __syncthreads();
      float acc[RC][RT];
      conv_k<T, RT>(k, acc, a0, AROW, w + (size_t)tap * C * C, bias + (size_t)conv_idx * C,
                    C, d, co0, lane);
      tap += k;
      ++conv_idx;
      __syncthreads();  // every read of a is done
#pragma unroll
      for (int s = 0; s < RT; ++s) {
        const int t = lane + 32 * s;
        const int tg = t0 + t;
        const bool valid = tg >= 0 && tg < T_len;
#pragma unroll
        for (int r = 0; r < RC; ++r)
          a0[(co0 + r) * AROW + t] = from_f<T>(valid ? lrelu(acc[r][s]) : 0.f);
      }
      __syncthreads();
      conv_k<T, RT>(k, acc, a0, AROW, w + (size_t)tap * C * C, bias + (size_t)conv_idx * C,
                    C, 1, co0, lane);
      tap += k;
      ++conv_idx;
#pragma unroll
      for (int s = 0; s < RT; ++s)
#pragma unroll
        for (int r = 0; r < RC; ++r) h_s[(co0 + r) * HROW + lane + 32 * s] += acc[r][s];
      __syncthreads();  // h is whole before the next unit reads it
    }
    // branch sum over the centre columns this thread owns
    const bool last = br == p.n_branch - 1;
#pragma unroll
    for (int s = 0; s < RT; ++s) {
      const int t = lane + 32 * s;
      const int tg = t0 + t;
      if (t < p.halo || t >= p.halo + tile || tg < 0 || tg >= T_len) continue;
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float* sp = sum + (size_t)(co0 + r) * T_len + tg;
        float* hp = h_s + (co0 + r) * HROW + t;
        if (br == 0) {
          *sp = *hp;
        } else if (!last) {
          *sp = *sp + *hp;
        } else {
          *hp = (*sp + *hp) / (float)p.n_branch;
        }
      }
    }
    __syncthreads();
  }

  // the mean sits in h's centre columns: write it out once
  for (int i = threadIdx.x; i < C * tile; i += nthreads) {
    int c, t;
    if (o_c_fast) { c = i % C; t = i / C; } else { c = i / tile; t = i - c * tile; }
    const int tg = t0 + p.halo + t;
    if (tg >= T_len) continue;
    out[(size_t)tg * p.sot + (size_t)c * p.soc] = from_f<T>(h_s[c * HROW + p.halo + t]);
  }
}

// ----------------------------------------------------------------------------
// Tensor-core variant for bf16 io (C % 32 == 0): the same stage, with each
// conv's per-tap product [C_out x C_in] x [C_in x W] on mma.sync m16n8k16
// (bf16 in, f32 accumulate). The operand lives transposed, aT [t][c] with a
// row stride of C + 8 elements, so ldmatrix reads B fragments at any dilated
// tap offset (rows are time) from 16-byte-aligned, bank-conflict-free rows.
// A fragments (weights, [tap][C_out][C_in]) come straight from L1/L2. Warp
// (wm, wn) owns output channels 32 wm.. + 31 and columns 64 wn.. + 63, i.e.
// 2 x 8 tiles of 16 x 8 accumulators.

constexpr int MMA_CS_PAD = 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned ldg_u32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned& d0, unsigned& d1,
                                        unsigned& d2, unsigned& d3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d0), "=r"(d1), "=r"(d2), "=r"(d3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][nt][r]: output channel m_base + 16 mt + g (+8 for r >= 2), column
// n_base + 8 nt + 2 tig + (r & 1), with g = lane / 4, tig = lane % 4.
template <int K>
__device__ __forceinline__ void conv_mma(float (&acc)[2][8][4], const __nv_bfloat16* aT,
                                         int cs, const __nv_bfloat16* __restrict__ w,
                                         const __nv_bfloat16* __restrict__ bias, int C,
                                         int d, int m_base, int n_base, int lane) {
  constexpr int HALF = (K - 1) / 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix.x4 row addresses: matrices (n-tile 0, k 0-7), (n-tile 0, k 8-15),
  // (n-tile 1, k 0-7), (n-tile 1, k 8-15)
  const int lrow = (lane >> 4) * 8 + (lane & 7);
  const int lcol = ((lane >> 3) & 1) * 8;
  const unsigned b_base = smem_u32(aT + (size_t)(n_base + lrow) * cs + lcol);
  for (int ci0 = 0; ci0 < C; ci0 += 16) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int off = (j - HALF) * d;
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* wp = w + ((size_t)j * C + m_base + 16 * mt + g) * C + ci0 + 2 * tig;
        af[mt][0] = ldg_u32(wp);
        af[mt][1] = ldg_u32(wp + 8 * C);
        af[mt][2] = ldg_u32(wp + 8);
        af[mt][3] = ldg_u32(wp + 8 * C + 8);
      }
      const unsigned addr = b_base + static_cast<unsigned>((off * cs + ci0) * 2);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(addr + static_cast<unsigned>(np * 16 * cs * 2), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], b0, b1);
          mma_bf16(acc[mt][2 * np + 1], af[mt], b2, b3);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float b_lo = __bfloat162float(bias[m_base + 16 * mt + g]);
    const float b_hi = __bfloat162float(bias[m_base + 16 * mt + g + 8]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[mt][nt][0] += b_lo;
      acc[mt][nt][1] += b_lo;
      acc[mt][nt][2] += b_hi;
      acc[mt][nt][3] += b_hi;
    }
  }
}

__device__ __forceinline__ void conv_mma_k(int k, float (&acc)[2][8][4], const __nv_bfloat16* aT,
                                           int cs, const __nv_bfloat16* w,
                                           const __nv_bfloat16* bias, int C, int d, int m_base,
                                           int n_base, int lane) {
  switch (k) {
    case 3: conv_mma<3>(acc, aT, cs, w, bias, C, d, m_base, n_base, lane); break;
    case 5: conv_mma<5>(acc, aT, cs, w, bias, C, d, m_base, n_base, lane); break;
    case 7: conv_mma<7>(acc, aT, cs, w, bias, C, d, m_base, n_base, lane); break;
    case 9: conv_mma<9>(acc, aT, cs, w, bias, C, d, m_base, n_base, lane); break;
    default: conv_mma<11>(acc, aT, cs, w, bias, C, d, m_base, n_base, lane); break;
  }
}

template <int W>
__global__ void __launch_bounds__(512, 1) resblock_stage_mma_kernel(StageArgs p) {
  constexpr int HROW = W + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C;
  const int cs = C + MMA_CS_PAD;
  float* h_s = reinterpret_cast<float*>(smem);
  const size_t h_bytes = ((size_t)C * HROW * sizeof(float) + 15) & ~(size_t)15;
  __nv_bfloat16* aT_s = reinterpret_cast<__nv_bfloat16*>(smem + h_bytes);
  __nv_bfloat16* aT = aT_s + (size_t)PADA * cs;  // row t = 0

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_m = C / 32;
  const int m_base = (warp % warps_m) * 32;
  const int n_base = (warp / warps_m) * 64;
  const int g = lane >> 2, tig = lane & 3;
  const int nthreads = blockDim.x;
  const int tile = W - 2 * p.halo;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tile - p.halo;
  const int T_len = p.T;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x) + (size_t)b * p.sxb;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + (size_t)b * p.sob;
  float* sum = p.sum + (size_t)b * C * T_len;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);
  const bool x_c_fast = p.sxc == 1;
  const bool o_c_fast = p.soc == 1;

  // zero margin rows, above and below the window
  for (int i = threadIdx.x; i < 2 * PADA * cs; i += nthreads) {
    const int row = i / cs, col = i - row * cs;
    aT_s[(size_t)(row < PADA ? row : W + row) * cs + col] = __float2bfloat16_rn(0.f);
  }

  int tap = 0, conv_idx = 0;
  for (int br = 0; br < p.n_branch; ++br) {
    const int k = p.ks[br];
    for (int i = threadIdx.x; i < C * W; i += nthreads) {
      int c, t;
      if (x_c_fast) { c = i % C; t = i / C; } else { c = i / W; t = i - c * W; }
      const int tg = t0 + t;
      h_s[c * HROW + t] = (tg >= 0 && tg < T_len)
                              ? __bfloat162float(x[(size_t)tg * p.sxt + (size_t)c * p.sxc]) : 0.f;
    }
    __syncthreads();
    for (int u = 0; u < p.n_dil[br]; ++u) {
      const int d = p.dil[br][u];
      for (int i = threadIdx.x; i < C * W; i += nthreads) {
        const int c = i % C, t = i / C;
        const int tg = t0 + t;
        aT[(size_t)t * cs + c] = __float2bfloat16_rn(
            (tg >= 0 && tg < T_len) ? lrelu(h_s[c * HROW + t]) : 0.f);
      }
      __syncthreads();
      float acc[2][8][4];
      conv_mma_k(k, acc, aT, cs, w + (size_t)tap * C * C, bias + (size_t)conv_idx * C, C, d,
                 m_base, n_base, lane);
      tap += k;
      ++conv_idx;
      __syncthreads();  // every read of aT is done
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int co = m_base + 16 * mt + g + (r >> 1) * 8;
            const int t = n_base + 8 * nt + 2 * tig + (r & 1);
            const int tg = t0 + t;
            aT[(size_t)t * cs + co] = __float2bfloat16_rn(
                (tg >= 0 && tg < T_len) ? lrelu(acc[mt][nt][r]) : 0.f);
          }
      __syncthreads();
      conv_mma_k(k, acc, aT, cs, w + (size_t)tap * C * C, bias + (size_t)conv_idx * C, C, 1,
                 m_base, n_base, lane);
      tap += k;
      ++conv_idx;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int co = m_base + 16 * mt + g + (r >> 1) * 8;
            const int t = n_base + 8 * nt + 2 * tig + (r & 1);
            h_s[co * HROW + t] += acc[mt][nt][r];
          }
      __syncthreads();
    }
    const bool last = br == p.n_branch - 1;
    for (int i = threadIdx.x; i < C * tile; i += nthreads) {
      const int c = i / tile, t = p.halo + (i - c * tile);
      const int tg = t0 + t;
      if (tg >= T_len) continue;
      float* sp = sum + (size_t)c * T_len + tg;
      float* hp = h_s + c * HROW + t;
      if (br == 0) {
        *sp = *hp;
      } else if (!last) {
        *sp = *sp + *hp;
      } else {
        *hp = (*sp + *hp) / (float)p.n_branch;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < C * tile; i += nthreads) {
    int c, t;
    if (o_c_fast) { c = i % C; t = i / C; } else { c = i / tile; t = i - c * tile; }
    const int tg = t0 + p.halo + t;
    if (tg >= T_len) continue;
    out[(size_t)tg * p.sot + (size_t)c * p.soc] = __float2bfloat16_rn(h_s[c * HROW + p.halo + t]);
  }
}

template <typename T, int RT>
int launch(const StageArgs& a, int batch, size_t smem, cudaStream_t stream) {
  const int tile = 32 * RT - 2 * a.halo;
  const dim3 grid((a.T + tile - 1) / tile, batch);
  const dim3 block(a.C / RC * 32);
  cudaError_t err = cudaFuncSetAttribute(resblock_stage_kernel<T, RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  resblock_stage_kernel<T, RT><<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_mma(const StageArgs& a, int batch, size_t smem, cudaStream_t stream) {
  const int tile = W - 2 * a.halo;
  const dim3 grid((a.T + tile - 1) / tile, batch);
  const dim3 block(a.C / 32 * (W / 64) * 32);
  cudaError_t err = cudaFuncSetAttribute(resblock_stage_mma_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  resblock_stage_mma_kernel<W><<<grid, block, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes the kernel needs for C channels, a window of 32 * rt
// columns and an io element of io_bytes.
extern "C" long long est_resblock_smem_bytes(int C, int rt, int io_bytes) {
  const long long w = 32LL * rt;
  const long long h = ((long long)C * (w + 1) * 4 + 15) & ~15LL;
  return h + (long long)C * (w + 2 * PADA) * io_bytes;
}

// Shared-memory bytes of the tensor-core variant for C channels and a window
// of w columns (w = 256 or 512).
extern "C" long long est_resblock_mma_smem_bytes(int C, int w) {
  const long long h = ((long long)C * (w + 1) * 4 + 15) & ~15LL;
  return h + (long long)(w + 2 * PADA) * (C + MMA_CS_PAD) * 2;
}

// x/out: element strides (sxb, sxt, sxc) / (sob, sot, soc) of [B, T, C];
// sum: [B, C, T] f32 scratch; bias: [convs, C]; io_bf16 picks the io dtype
// (bf16 or f32); ks/n_dil/dil: host arrays (dil row-major [n_branch][MAX_DIL]).
// mma_w = 0 runs the CUDA-core kernel with a window of 32 * rt columns and w
// as [taps, C_in, C_out]; mma_w = 256 or 512 runs the tensor-core variant
// (bf16, C % 32 == 0) with that window and w as [taps, C_out, C_in]. C must be
// a multiple of 8 and at most 128, and every tap offset (k-1)/2 * d at most
// 32. Returns cudaGetLastError().
extern "C" int est_resblock_stage(const void* x, void* out, void* sum,
                                  const void* w, const void* bias, int B, int T,
                                  int C, long long sxb, long long sxt,
                                  long long sxc, long long sob, long long sot,
                                  long long soc, int halo, int n_branch,
                                  const void* ks, const void* n_dil,
                                  const void* dil, int io_bf16, int rt,
                                  int mma_w, void* stream) {
  StageArgs a;
  a.x = x; a.out = out; a.sum = static_cast<float*>(sum);
  a.w = w; a.bias = bias;
  a.sxb = sxb; a.sxt = sxt; a.sxc = sxc; a.sob = sob; a.sot = sot; a.soc = soc;
  a.T = T; a.C = C; a.halo = halo; a.n_branch = n_branch;
  const int* ks_h = static_cast<const int*>(ks);
  const int* nd_h = static_cast<const int*>(n_dil);
  const int* dil_h = static_cast<const int*>(dil);
  for (int i = 0; i < MAX_BRANCH; ++i) {
    a.ks[i] = i < n_branch ? ks_h[i] : 0;
    a.n_dil[i] = i < n_branch ? nd_h[i] : 0;
    for (int j = 0; j < MAX_DIL; ++j) a.dil[i][j] = i < n_branch ? dil_h[i * MAX_DIL + j] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mma_w) {
    const size_t smem = static_cast<size_t>(est_resblock_mma_smem_bytes(C, mma_w));
    return mma_w == 512 ? launch_mma<512>(a, B, smem, s) : launch_mma<256>(a, B, smem, s);
  }
  const size_t smem = static_cast<size_t>(est_resblock_smem_bytes(C, rt, io_bf16 ? 2 : 4));
  if (io_bf16) {
    switch (rt) {
      case 4: return launch<__nv_bfloat16, 4>(a, B, smem, s);
      case 6: return launch<__nv_bfloat16, 6>(a, B, smem, s);
      default: return launch<__nv_bfloat16, 8>(a, B, smem, s);
    }
  }
  switch (rt) {
    case 4: return launch<float, 4>(a, B, smem, s);
    case 6: return launch<float, 6>(a, B, smem, s);
    default: return launch<float, 8>(a, B, smem, s);
  }
}

// One HiFi-GAN stage's resblock battery in one launch, hand-written for
// Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_vocoder.py:113, fused_resblock_stage
//           (Pallas kernel `_stage_kernel`).
//
// Computes, for every kernel-size branch (3, 7, 11 on the main path) with its
// dilations (1, 3, 5):
//   h = x;  for d: h += c2(io(lrelu(mask(c1(io(lrelu(mask(h))), d)))), 1)
// and returns the mean of the branches' h. mask zeroes a conv's input outside
// [0, T), which is XLA's per-conv zero padding. Conv operands are in the io
// dtype (bf16 in serving, f32 in tests) and the sums in f32, as the JAX kernel
// does; the branch state h stays f32 between convs.
//
// What bounds it on the H100: operations. A stage costs 2 * C^2 * T * 126
// FLOP (126 taps over the 18 convs): 99 GFLOP at stage 2 and 248 GFLOP at
// stage 3 of 10 s of speech (C=128, T=24000; C=64, T=240000), against 12 and
// 61 MB of bf16 in and out: 0.1002 ms and 0.2505 ms at the 989 TFLOP/s bf16
// tensor-core peak (NVIDIA H100 80GB HBM3 data sheet, 700 W).
//
// What the design does about it: the products run on wgmma, the only path to
// that peak (resblock_stage_wg_kernel, bf16 with C = 64 or 128). A block owns
// one batch row and one time window of W rows across all C channels, because
// every conv mixes all channels and the 18 convs run in sequence; each block
// streams every tap's weights once through a ring in shared memory by bulk
// async copies (a producer lane, mbarriers), so no warp reloads them from L2,
// and two consumer warpgroups keep their accumulators in registers and run
// the epilogues from there. The window carries a halo of the stage's receptive
// half-width (60 on the main path) per side and writes only its W - 2 * halo
// centre rows, so no block needs another's data; the halo is recomputed per
// window. The branch sum goes to an f32 scratch in device memory, and the
// last branch writes the mean in the io dtype with the strides it is given,
// so the output is written once; x, the scratch and the output move 8 bytes
// a thread along their unit-stride axis. f32 io, and bf16 with other channel
// counts, run the products as FP32 FMA on the CUDA cores
// (resblock_stage_kernel).
//
// What binds the wgmma variant now (obs/resblock_probe.py, cutting parts out
// of copies of this kernel, NVIDIA H100 80GB HBM3, 700 W): not the products,
// which run near the tensor rate and take 36-40 % of its time, but the work
// the tensor cores wait for between barriers: the window's passes through
// device memory (x three times, the branch sum, the output: 16 % at C = 128,
// 26 % at C = 64), the conv-2 epilogue (8 %, 13 %) and the weight stream
// from L2 (7 %, 5 %).
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
  float* sum;         // B * C * T f32 scratch for the branch sum ([B, C, T] for the
                      // CUDA-core kernel, [B, T, C] for the tensor-core one)
  const void* w;      // CUDA-core: [taps, C_in, C_out] io dtype, branches/units in
                      // order; tensor-core: the swizzled chunk image (wgmma_weight_image)
  const void* bias;   // [convs, C] io dtype
  long long sxb, sxt, sxc, sob, sot, soc;
  int T, C, halo;
  int margin;         // tensor-core: zero rows each side of aT (the largest tap offset)
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
// Tensor-core variant for bf16 io with C = 64 or 128 (resblock_stage_wg_kernel):
// every conv's per-tap product D[t][c_out] += A[t + off][c_in] W_j[c_in][c_out]
// on wgmma m64nCk16 (bf16 in, f32 accumulate). A, the activations, comes from
// registers, loaded with ldmatrix from the operand aT [t][c] (row stride
// C + 8 elements, conflict-free) at the tap's dilated row offset. B, the tap's
// weights, is read by wgmma from shared memory through a descriptor, in the
// canonical K-major swizzled layout: the wrapper lays the weights out once as
// the shared-memory image of each chunk of N = C rows (c_out) by KW columns
// (c_in), 128-byte swizzle for KW = 64 (C = 64), 64-byte for KW = 32
// (C = 128). One lane of a producer warpgroup (which hands its registers to
// the consumers with setmaxnreg) copies the chunks, in the order the
// consumers use them, into a ring of WG_STAGES slots with cp.async.bulk, each
// completing on its slot's `full` mbarrier; the consumers release a slot on
// its `empty` mbarrier once their products from it are done.
//
// Two consumer warpgroups own the window's rows: warpgroup g owns the m-tiles
// (64 rows each) g * MT .. g * MT + MT - 1 and keeps their accumulators,
// MT x C / 2 floats a thread, in registers through a conv. Epilogues run from
// those registers on the rows the warpgroup owns: after conv 1,
// aT <- bf16(lrelu(mask(acc))); after conv 2, h += acc and, for the next
// unit, aT <- bf16(lrelu(mask(h))). A named barrier over the 256 consumer
// threads separates each conv's reads of aT from the next writes, and those
// writes from the next conv. h [t][c] stays f32, its 8-float groups swizzled
// by t % 8 so the accumulator layout's float2 stores are conflict-free.

constexpr int WG_CONSUMERS = 2;                       // consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS * 128 + 128;  // + the producer warpgroup
constexpr int WG_STAGES = 2;                          // weight ring slots
constexpr int WG_PRODUCER_REGS = 40;                  // setmaxnreg: 128 x 40 + 256 x 232
constexpr int WG_CONSUMER_REGS = 232;                 //   registers fit the SM's 65,536
constexpr int WG_CS_PAD = 8;                          // aT row padding, elements
constexpr int XB = 16;                                // loads in flight a thread

template <int C> struct WgShape {
  static constexpr int KW = C == 64 ? 64 : 32;          // c_in columns a chunk
  static constexpr int ROW_BYTES = KW * 2;              // one chunk row (c_out)
  static constexpr int SBO = 8 * ROW_BYTES;             // stride of 8-row groups
  static constexpr int LAYOUT = KW == 64 ? 1 : 2;       // descriptor: 128B / 64B swizzle
  static constexpr int CHUNK_BYTES = C * ROW_BYTES;     // 8 KB either way
  static constexpr int CHUNKS_PER_TAP = C / KW;
  static constexpr int KSTEPS = KW / 16;                // wgmma k-steps a chunk
  static constexpr int CS = C + WG_CS_PAD;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Waits for the phase of parity `parity` of an mbarrier; traps after ~2^34
// cycles (several seconds), so a fault in the pipeline ends the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  long long start = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(WG_CONSUMERS * 128) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps a register's value where it is until this point: orders the
// accumulators' reads after wgmma.wait_group, and keeps A's registers from
// being reused while an issued wgmma may still read them.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void fence_reg(unsigned& r) { asm volatile("" : "+r"(r) :: "memory"); }

// B descriptor of a K-major swizzled chunk starting at shared address `addr`
// (the leading byte offset is unused with a swizzle; 1 by convention).
template <int C>
__device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  using S = WgShape<C>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(S::SBO >> 4) << 32) | (static_cast<uint64_t>(S::LAYOUT) << 62);
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <int C>
__device__ __forceinline__ void wgmma_c(float (&d)[C / 2], const unsigned (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_c<64>(float (&d)[32], const unsigned (&a)[4], uint64_t desc) {
  wgmma_n64(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_c<128>(float (&d)[64], const unsigned (&a)[4], uint64_t desc) {
  wgmma_n128(d, a, desc);
}

// h [t][c] f32 with c's 8-float groups swizzled by t % 8 (C >= 64).
__device__ __forceinline__ int h_idx(int t, int c, int C) { return t * C + (c ^ ((t & 7) << 3)); }

// Per-thread consumer state: which rows it owns, where its operand reads start,
// and its place in the weight ring.
struct WgLane {
  unsigned a_lane;   // shared address of this lane's ldmatrix row at row 0, column 0
  unsigned ring;     // shared address of ring slot 0
  unsigned full, empty;  // shared addresses of the slot barriers (8 bytes a slot)
  int row0;          // first row of the warpgroup's first m-tile
  int g, tig, lane;
  unsigned q;        // chunks consumed so far
};

// acc[m] = bias + sum_j W_j^T aT[rows of m-tile m + (j - K/2) d], the chunks of
// the conv's k taps taken from the ring in order.
template <int C, int MT>
__device__ __forceinline__ void conv_wg(float (&acc)[MT][C / 2], WgLane& L,
                                        const __nv_bfloat16* __restrict__ bias, int k, int d) {
  using S = WgShape<C>;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const __nv_bfloat162 bv =
        *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * i + 2 * L.tig);
    const float2 bf = __bfloat1622float2(bv);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][4 * i + 0] = bf.x;
      acc[m][4 * i + 1] = bf.y;
      acc[m][4 * i + 2] = bf.x;
      acc[m][4 * i + 3] = bf.y;
    }
  }
  // A is double-buffered across a chunk's k-steps: a k-step's group is left
  // in flight while the next one's fragments load, and wait_group 1 frees the
  // other buffer. At the chunk's end wait_group 0 and the slot is released at
  // once, which gives the producer a whole chunk of time to refill it.
  const int half = (k - 1) / 2;
  unsigned a[2][MT][4];
  for (int j = 0; j < k; ++j) {
    const int off = (j - half) * d;
#pragma unroll 1
    for (int kc = 0; kc < S::CHUNKS_PER_TAP; ++kc) {
      const unsigned slot = L.q % WG_STAGES;
      mbar_wait(L.full + 8 * slot, (L.q / WG_STAGES) & 1);
      __syncwarp();
      const unsigned b_base = L.ring + slot * S::CHUNK_BYTES;
#pragma unroll
      for (int ks = 0; ks < S::KSTEPS; ++ks) {
        const int buf = ks & 1;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldsm_x4(L.a_lane + static_cast<unsigned>(
                                 ((L.row0 + 64 * m + off) * S::CS + kc * S::KW + 16 * ks) * 2),
                  a[buf][m]);
        wgmma_fence();
        const uint64_t desc = b_desc<C>(b_base + 32 * ks);
#pragma unroll
        for (int m = 0; m < MT; ++m) wgmma_c<C>(acc[m], a[buf][m], desc);
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int r = 0; r < 4; ++r) fence_reg(a[buf ^ 1][m][r]);
      }
      wgmma_wait<0>();   // the slot's products are done: release it at once
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int r = 0; r < 4; ++r) fence_reg(a[(S::KSTEPS - 1) & 1][m][r]);
      if (L.lane == 0) mbar_arrive(L.empty + 8 * slot);
      ++L.q;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < C / 2; ++r) fence_reg(acc[m][r]);
  }
}

// What a consumer thread needs beyond its ring state: the block's window,
// its shared arrays and the rows it owns in the accumulator layout (m-tile
// m, half hf: rows g and g + 8 of its warp's 16; columns 8 i + 2 tig, + 1).
struct WgWindow {
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  float* sum;           // [T, C] of this batch row
  float* h;             // [W][C] swizzled
  __nv_bfloat16* aT;    // row t = 0 of [W + 2 margin][C + 8]
  long long sxt, sxc, sot, soc;
  int t0, T, halo, tile, ctid, row_base;
  // the axis along which x and out are read and written four elements at a
  // time: 1 for t (stride 1 there), 2 for c, 0 for one element at a time
  int x_vec, o_vec;
  __device__ int row(int m, int hf) const { return row_base + 64 * m + 8 * hf; }
  __device__ bool valid(int t) const { return t0 + t >= 0 && t0 + t < T; }
};

constexpr int WG_NCT = WG_CONSUMERS * 128;   // consumer threads

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xFFFF0000u); }

// Four bf16 of x from (c, t) on along the vector axis `axis` (1: t, 2: c),
// zero where t lies outside [0, T); one 8-byte load where all four lie inside.
__device__ __forceinline__ uint2 load4(const WgWindow& v, int axis, int c, int t) {
  const int tg = v.t0 + t;
  const size_t at = (size_t)tg * v.sxt + (size_t)c * v.sxc;
  const bool inside = axis == 2 ? (tg >= 0 && tg < v.T) : (tg >= 0 && tg + 3 < v.T);
  if (inside) return __ldg(reinterpret_cast<const uint2*>(v.x + at));
  unsigned short e[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int tk = axis == 1 ? tg + k : tg;   // the vector axis has stride 1
    e[k] = (tk >= 0 && tk < v.T) ? __bfloat16_as_ushort(v.x[at + k]) : 0;
  }
  return make_uint2(e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16);
}

// The (c, t) of group g of four elements along the vector axis, of a slice
// of `rows` rows. Along t a warp takes 8 channels by 4 consecutive groups:
// each channel's 32 bytes are one sector of device memory, and the four rows
// it writes into h and aT at each step fall on different banks but for one
// pair; the groups number C * 4 * ceil(rows / 16), and those at t >= rows
// are to be skipped. Along c a warp takes consecutive groups of a row, and
// the groups number rows * C / 4.
template <int C>
__device__ __forceinline__ int group_count(int axis, int rows) {
  return axis == 1 ? C * 4 * ((rows / 4 + 3) / 4) : rows * (C / 4);
}
template <int C>
__device__ __forceinline__ void group_of(int axis, int rows, int g, int& c, int& t) {
  if (axis == 1) {
    const int tb = (rows / 4 + 3) / 4;               // blocks of 4 groups a channel
    const int rest = g >> 5;
    const int cb = rest / tb;
    c = 8 * cb + ((g >> 2) & 7);
    t = 4 * (4 * (rest - cb * tb) + (g & 3));
  } else {
    t = g / (C / 4);
    c = 4 * (g - t * (C / 4));
  }
}

// h = x over the window (zero outside [0, T)) and the first operand
// io(lrelu(h)). Elements go four at a time along x's unit-stride axis where
// it is aligned (the main path's transposed [B, C, T] view: along t), each
// thread keeping XB 8-byte loads in flight before it stores.
template <int C, int W>
__device__ __forceinline__ void load_window(const WgWindow& v) {
  using S = WgShape<C>;
  if (v.x_vec == 0) {
    for (int i = v.ctid; i < C * W; i += WG_NCT) {
      const int c = i / W, t = i - c * W;
      const float x = v.valid(t)
          ? __bfloat162float(v.x[(size_t)(v.t0 + t) * v.sxt + (size_t)c * v.sxc]) : 0.f;
      v.h[h_idx(t, c, C)] = x;
      v.aT[(size_t)t * S::CS + c] = __float2bfloat16_rn(lrelu(x));
    }
    return;
  }
  constexpr int N4 = C * W / 4;                      // W is a multiple of 16: no group skipped
  for (int g0 = v.ctid; g0 < N4; g0 += WG_NCT * XB) {
    uint2 raw[XB];
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int g = g0 + u * WG_NCT;
      int c, t;
      group_of<C>(v.x_vec, W, g, c, t);
      raw[u] = g < N4 ? load4(v, v.x_vec, c, t) : make_uint2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < XB; ++u) {
      const int g = g0 + u * WG_NCT;
      if (g >= N4) break;
      int c, t;
      group_of<C>(v.x_vec, W, g, c, t);
      const float x[4] = {bf16_lo(raw[u].x), bf16_hi(raw[u].x), bf16_lo(raw[u].y),
                          bf16_hi(raw[u].y)};
      if (v.x_vec == 1) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v.h[h_idx(t + k, c, C)] = x[k];
          v.aT[(size_t)(t + k) * S::CS + c] = __float2bfloat16_rn(lrelu(x[k]));
        }
      } else {
        *reinterpret_cast<float4*>(v.h + h_idx(t, c, C)) = make_float4(x[0], x[1], x[2], x[3]);
        __nv_bfloat162* a2 = reinterpret_cast<__nv_bfloat162*>(v.aT + (size_t)t * S::CS + c);
        a2[0] = __floats2bfloat162_rn(lrelu(x[0]), lrelu(x[1]));
        a2[1] = __floats2bfloat162_rn(lrelu(x[2]), lrelu(x[3]));
      }
    }
  }
}

// After conv 1: aT <- io(lrelu(mask(acc))) on the rows this thread owns.
template <int C, int MT>
__device__ __forceinline__ void store_operand(const WgWindow& v, const float (&acc)[MT][C / 2],
                                              int tig) {
  using S = WgShape<C>;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = v.row(m, hf);
      const bool valid = v.valid(t);
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        const float v0 = valid ? lrelu(acc[m][4 * i + 2 * hf]) : 0.f;
        const float v1 = valid ? lrelu(acc[m][4 * i + 2 * hf + 1]) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(v.aT + (size_t)t * S::CS + 8 * i + 2 * tig) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// After conv 2: h += acc, and (unless the branch ends) the next unit's
// operand aT <- io(lrelu(mask(h))), on the rows this thread owns.
template <int C, int MT>
__device__ __forceinline__ void add_to_state(const WgWindow& v, const float (&acc)[MT][C / 2],
                                             int tig, bool operand) {
  using S = WgShape<C>;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = v.row(m, hf);
      const bool valid = v.valid(t);
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        float2* hp = reinterpret_cast<float2*>(v.h + h_idx(t, 8 * i + 2 * tig, C));
        float2 hv = *hp;
        hv.x += acc[m][4 * i + 2 * hf];
        hv.y += acc[m][4 * i + 2 * hf + 1];
        *hp = hv;
        if (operand)
          *reinterpret_cast<__nv_bfloat162*>(v.aT + (size_t)t * S::CS + 8 * i + 2 * tig) =
              __floats2bfloat162_rn(valid ? lrelu(hv.x) : 0.f, valid ? lrelu(hv.y) : 0.f);
      }
    }
}

// The branch sum over the centre rows this thread owns, all its sums
// loaded together (the accumulators are free here): sum = h (first branch),
// sum += h, and in the last branch h = (sum + h) / n_branch. The scratch is
// [T, C], so each of the thread's column pairs is one 8-byte access.
template <int C, int MT>
__device__ __forceinline__ void branch_sum(const WgWindow& v, int tig, int br, int n_branch) {
  const bool last = br == n_branch - 1;
  float2 sv[MT][2][C / 8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = v.row(m, hf);
      const bool mine = t >= v.halo && t < v.halo + v.tile && v.t0 + t < v.T;
      const float2* s = reinterpret_cast<const float2*>(v.sum + (size_t)(v.t0 + t) * C + 2 * tig);
#pragma unroll
      for (int i = 0; i < C / 8; ++i)
        sv[m][hf][i] = (mine && br > 0) ? s[4 * i] : make_float2(0.f, 0.f);
    }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = v.row(m, hf);
      if (t < v.halo || t >= v.halo + v.tile || v.t0 + t >= v.T) continue;
      float2* s = reinterpret_cast<float2*>(v.sum + (size_t)(v.t0 + t) * C + 2 * tig);
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        float2* hp = reinterpret_cast<float2*>(v.h + h_idx(t, 8 * i + 2 * tig, C));
        float2 hv = *hp;
        hv.x += sv[m][hf][i].x;
        hv.y += sv[m][hf][i].y;
        if (!last) {
          s[4 * i] = hv;
        } else {
          hv.x /= (float)n_branch;
          hv.y /= (float)n_branch;
          *hp = hv;
        }
      }
    }
}

// The mean in h's centre rows, written out once in the io dtype, four
// elements at a time along out's unit-stride axis where it is aligned.
template <int C>
__device__ __forceinline__ void write_out(const WgWindow& v) {
  if (v.o_vec == 0) {
    for (int i = v.ctid; i < C * v.tile; i += WG_NCT) {
      const int c = i / v.tile, t = i - c * v.tile;
      const int tg = v.t0 + v.halo + t;
      if (tg < v.T)
        v.out[(size_t)tg * v.sot + (size_t)c * v.soc] =
            __float2bfloat16_rn(v.h[h_idx(v.halo + t, c, C)]);
    }
    return;
  }
  const int n4 = group_count<C>(v.o_vec, v.tile);   // o_vec == 1: the tile a multiple of 4
  for (int g = v.ctid; g < n4; g += WG_NCT) {
    int c, t;
    group_of<C>(v.o_vec, v.tile, g, c, t);
    const int tg = v.t0 + v.halo + t;
    if (t >= v.tile || tg >= v.T) continue;
    float y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = v.o_vec == 1 ? v.h[h_idx(v.halo + t + k, c, C)] : v.h[h_idx(v.halo + t, c + k, C)];
    __nv_bfloat16* o = v.out + (size_t)tg * v.sot + (size_t)c * v.soc;
    if (v.o_vec == 2 || tg + 3 < v.T) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]), hi = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<unsigned*>(&lo),
                                                *reinterpret_cast<unsigned*>(&hi));
    } else {
      for (int k = 0; k < 4 && tg + k < v.T; ++k) o[k] = __float2bfloat16_rn(y[k]);
    }
  }
}

// The axis along which a [T, C] slice with element strides (st, sc), moved
// from row t_first on, goes four elements (8 bytes) at a time: 1 for t, 2 for
// c, 0 for neither (no unit stride, or addresses not 8-byte aligned).
__device__ __forceinline__ int vec_axis(const void* base, long long st, long long sc,
                                        int t_first) {
  if ((reinterpret_cast<uintptr_t>(base) & 7) != 0) return 0;
  if (st == 1 && sc % 4 == 0 && t_first % 4 == 0) return 1;
  if (sc == 1 && st % 4 == 0) return 2;
  return 0;
}

template <int C, int W>
__global__ void __launch_bounds__(WG_THREADS, 1) resblock_stage_wg_kernel(StageArgs p) {
  using S = WgShape<C>;
  constexpr int MT = W / 64 / WG_CONSUMERS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring's swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring_p = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + WG_STAGES * S::CHUNK_BYTES);
  float* h_s = reinterpret_cast<float*>(smem + WG_STAGES * S::CHUNK_BYTES + 16 * WG_STAGES);
  __nv_bfloat16* aT_s = reinterpret_cast<__nv_bfloat16*>(h_s + W * C);
  const int MG = p.margin;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(smem_u32(bars + s), 1);
      mbar_init(smem_u32(bars + WG_STAGES + s), WG_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS * 4) {
    // producer: one lane streams every chunk of the stage's weights through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(WG_PRODUCER_REGS));
    if (warp == WG_CONSUMERS * 4 && lane == 0) {
      int n_taps = 0;
      for (int br = 0; br < p.n_branch; ++br) n_taps += 2 * p.ks[br] * p.n_dil[br];
      const unsigned char* w = static_cast<const unsigned char*>(p.w);
      const unsigned total = static_cast<unsigned>(n_taps * S::CHUNKS_PER_TAP);
      for (unsigned q = 0; q < total; ++q) {
        const unsigned slot = q % WG_STAGES;
        mbar_wait(smem_u32(bars + WG_STAGES + slot), ((q / WG_STAGES) & 1) ^ 1);
        const unsigned full = smem_u32(bars + slot);
        mbar_expect_tx(full, S::CHUNK_BYTES);
        bulk_copy(smem_u32(ring_p + slot * S::CHUNK_BYTES), w + (size_t)q * S::CHUNK_BYTES,
                  S::CHUNK_BYTES, full);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(WG_CONSUMER_REGS));
  const int wg = warp >> 2;
  const int wl = warp & 3;
  __nv_bfloat16* aT = aT_s + MG * S::CS;   // row t = 0
  WgLane L;
  L.lane = lane;
  L.g = lane >> 2;
  L.tig = lane & 3;
  L.row0 = wg * MT * 64;
  L.a_lane = smem_u32(aT + (16 * wl + (lane & 15)) * S::CS + (lane >> 4) * 8);
  L.ring = smem_u32(ring_p);
  L.full = smem_u32(bars);
  L.empty = smem_u32(bars + WG_STAGES);
  L.q = 0;

  WgWindow v;
  v.ctid = tid;
  v.tile = W - 2 * p.halo;
  v.halo = p.halo;
  v.T = p.T;
  v.t0 = blockIdx.x * v.tile - p.halo;
  v.x = static_cast<const __nv_bfloat16*>(p.x) + (size_t)blockIdx.y * p.sxb;
  v.out = static_cast<__nv_bfloat16*>(p.out) + (size_t)blockIdx.y * p.sob;
  v.sum = p.sum + (size_t)blockIdx.y * C * p.T;
  v.h = h_s;
  v.aT = aT;
  v.sxt = p.sxt; v.sxc = p.sxc; v.sot = p.sot; v.soc = p.soc;
  // x is read from row t0 on, out written from row t0 + halo (a multiple of
  // the tile) on
  v.x_vec = vec_axis(v.x, p.sxt, p.sxc, v.t0);
  v.o_vec = vec_axis(v.out, p.sot, p.soc, v.tile);
  v.row_base = L.row0 + 16 * wl + L.g;
  const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(p.bias);

  // zero margin rows above and below the window
  for (int i = tid; i < 2 * MG * S::CS; i += WG_NCT) {
    const int row = i / S::CS, col = i - row * S::CS;
    aT_s[(size_t)(row < MG ? row : W + row) * S::CS + col] = __float2bfloat16_rn(0.f);
  }

  float acc[MT][C / 2];
  int conv_idx = 0;
  for (int br = 0; br < p.n_branch; ++br) {
    const int k = p.ks[br];
    load_window<C, W>(v);
    consumer_sync();
    // conv 1 (dilated) and conv 2 of each unit, from one call site
    for (int step = 0; step < 2 * p.n_dil[br]; ++step) {
      const int u = step >> 1;
      const bool second = step & 1, last_unit = u == p.n_dil[br] - 1;
      conv_wg<C, MT>(acc, L, bias + (size_t)conv_idx * C, k, second ? 1 : p.dil[br][u]);
      ++conv_idx;
      consumer_sync();  // every read of aT is done
      if (!second) store_operand<C, MT>(v, acc, L.tig);
      else add_to_state<C, MT>(v, acc, L.tig, !last_unit);
      if (!(second && last_unit)) consumer_sync();  // the next conv's operand is whole
    }
    branch_sum<C, MT>(v, L.tig, br, p.n_branch);
    consumer_sync();  // h and aT are free for the next branch, or the mean is whole
  }
  write_out<C>(v);
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

template <int C, int W>
int launch_wg(const StageArgs& a, int batch, size_t smem, cudaStream_t stream) {
  const int tile = W - 2 * a.halo;
  const dim3 grid((a.T + tile - 1) / tile, batch);
  cudaError_t err = cudaFuncSetAttribute(resblock_stage_wg_kernel<C, W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  resblock_stage_wg_kernel<C, W><<<grid, WG_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes the CUDA-core kernel needs for C channels, a window of
// 32 * rt columns and an io element of io_bytes.
extern "C" long long est_resblock_smem_bytes(int C, int rt, int io_bytes) {
  const long long w = 32LL * rt;
  const long long h = ((long long)C * (w + 1) * 4 + 15) & ~15LL;
  return h + (long long)C * (w + 2 * PADA) * io_bytes;
}

// Shared-memory bytes of the tensor-core variant for C channels, a window of
// w rows and `margin` zero rows each side of the operand: alignment slack,
// the weight ring and its barriers, h in f32, aT in bf16.
extern "C" long long est_resblock_wg_smem_bytes(int C, int w, int margin) {
  const long long chunk = (long long)C * (C == 64 ? 64 : 32) * 2;
  return 1024 + WG_STAGES * chunk + 16 * WG_STAGES + 4LL * w * C +
         2LL * (w + 2 * margin) * (C + WG_CS_PAD);
}

// x/out: element strides (sxb, sxt, sxc) / (sob, sot, soc) of [B, T, C];
// sum: B * C * T f32 scratch; bias: [convs, C]; io_bf16 picks the io dtype
// (bf16 or f32); ks/n_dil/dil: host arrays (dil row-major [n_branch][MAX_DIL]).
// wg_w = 0 runs the CUDA-core kernel with a window of 32 * rt columns and w
// as [taps, C_in, C_out], C a multiple of 8 and at most 128; wg_w = 512
// (C = 64) or 256 (C = 128) runs the tensor-core variant (bf16) with w as the
// swizzled chunk image and `margin` zero rows each side of its operand. Every tap offset (k-1)/2 * d is at most 32 (and
// at most `margin`). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a shape no variant takes.
extern "C" int est_resblock_stage(const void* x, void* out, void* sum,
                                  const void* w, const void* bias, int B, int T,
                                  int C, long long sxb, long long sxt,
                                  long long sxc, long long sob, long long sot,
                                  long long soc, int halo, int n_branch,
                                  const void* ks, const void* n_dil,
                                  const void* dil, int io_bf16, int rt,
                                  int wg_w, int margin, void* stream) {
  StageArgs a;
  a.x = x; a.out = out; a.sum = static_cast<float*>(sum);
  a.w = w; a.bias = bias;
  a.sxb = sxb; a.sxt = sxt; a.sxc = sxc; a.sob = sob; a.sot = sot; a.soc = soc;
  a.T = T; a.C = C; a.halo = halo; a.margin = margin; a.n_branch = n_branch;
  const int* ks_h = static_cast<const int*>(ks);
  const int* nd_h = static_cast<const int*>(n_dil);
  const int* dil_h = static_cast<const int*>(dil);
  for (int i = 0; i < MAX_BRANCH; ++i) {
    a.ks[i] = i < n_branch ? ks_h[i] : 0;
    a.n_dil[i] = i < n_branch ? nd_h[i] : 0;
    for (int j = 0; j < MAX_DIL; ++j) a.dil[i][j] = i < n_branch ? dil_h[i * MAX_DIL + j] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wg_w) {
    const size_t smem = static_cast<size_t>(est_resblock_wg_smem_bytes(C, wg_w, margin));
    if (!io_bf16) return static_cast<int>(cudaErrorInvalidValue);
    if (C == 64 && wg_w == 512) return launch_wg<64, 512>(a, B, smem, s);
    if (C == 128 && wg_w == 256) return launch_wg<128, 256>(a, B, smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
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

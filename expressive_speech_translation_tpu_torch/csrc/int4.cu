// Packed-int4 weight-only matmul, hand-written for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_int4.py, matmul_int4 (Pallas kernel
//           `_kernel`), with weights from pack_int4.
//
// Computes y = T((x[:, :K/2] @ lo(P) + x[:, K/2:] @ hi(P)) * scale) for
// x [B, K] in T (bf16 or f32), P [K/2, N] int8 holding two signed 4-bit
// weights a byte (low nibble: row k of the [K, N] weights, high nibble: row
// k + K/2) and scale [N] f32. The nibbles are exact in bf16 and f32, so every
// product is exact for bf16 x; the sums are f32, the scale comes after them
// and the output is rounded once to T.
//
// What bounds it on the H100: bytes. The packed weights are K*N/2 bytes
// (8.4 MB at K=2048, N=8192: 2.56 us at 3.35 TB/s) and each byte feeds 4B
// operations, far below the ~295 a byte at which the tensor cores would bind.
//
// Why the first version (kept below for f32 x) missed that bound for bf16 x:
// its products ran on the CUDA cores. Each packed byte cost two int->float
// conversions (reduced-rate instructions on sm_90) and 2B FP32 FMAs, each FMA
// reading two shared-memory scalars of x, so its work grew with B and at B=8
// it was bound by issue, not by memory (22.4 us against 2.56).
//
// The bf16 design (int4_mma_kernel):
// 1. Operands swapped: y^T [N, B] = W^T x^T on mma.sync m16n8k16 (bf16 in,
//    f32 accumulate). A is 16 output columns x 16 k of weights, B is 8 batch
//    rows x 16 k of x, read k-contiguous from x's row-major layout. B <= 8
//    fills one n-tile of 8 (rows past B are zeros); up to 16 rows take two
//    n-tiles in the same launch, so no weight is read twice; larger B runs
//    further groups of 16.
// 2. Byte stream: a warp owns 128 columns (one 128-byte line a packed row) and
//    every fourth 16-row k-step of the block's slice. Each lane copies the
//    four 16-byte pieces it will itself consume (rows 2t, 2t+1, 2t+8, 2t+9,
//    columns 16g..16g+15, with g = lane / 4, t = lane % 4) with cp.async into
//    a private ring of STAGES k-steps, so a warp keeps up to 8 KB and a block
//    32 KB in flight and no barrier guards the ring. Rows are padded to 144
//    bytes: the 16-byte copies and reads are free of bank conflicts.
// 3. Dequant without conversions: the sum over k and the order of the 16
//    output columns inside an mma tile are free, so the A fragment's
//    (row, k) slots are mapped onto the bytes a lane already holds: m-tile j
//    row g is column 16g + 2j, row g + 8 is column 16g + 2j + 1, and k slot
//    kk is packed row kk of the step. One byte_perm pairs rows 2t and 2t+1
//    (the two k halves of a register), then per pair of weights a shift, an
//    and/xor (lop3) putting nibble ^ 8 into the mantissa of bf16 128.0 (one
//    ulp is 1 there), and one bf16x2 subtraction of 136.0 give the signed
//    values -8..7 exactly. A low nibble feeds the chain against x[:, r] and
//    the high nibble of the same byte the chain against x[:, K/2 + r], both
//    into the same f32 accumulators. The dequantised weights never go back
//    through shared memory, and no ldmatrix is needed.
// 4. Filling the card: the K/2 packed rows are cut into slices (a multiple of
//    64 rows, at most 1024) so the grid holds about two blocks an SM; the
//    block copies its slice of x's two halves into shared memory as bf16
//    (with cp.async in the weights' first group when K % 16 == 0; zero past B
//    and past the last packed row), and the four warps' sums meet in shared
//    memory at the end.
// 5. Edges: any B >= 1, K even, N % 128 == 0. A ragged last k-step is
//    zero-filled in both W (cp.async with source size 0) and x.
// Slices write f32 partials that a second kernel adds in slice order
// (deterministic, no atomics) before the scale and the rounding to T; with one
// slice the first kernel finishes alone. The second kernel is a programmatic
// dependent launch, so its launch overlaps the first kernel instead of
// following it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TN = 128;          // columns of N a block

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* x; const int8_t* p; const float* scale; void* out; float* part;
  int nb, K, N, ks;
};

// Per device (the card the calling thread has current): a launch on any card
// plans for that card.
constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

int sm_count() {
  static std::atomic<int> cached[kMaxDevices];
  const int dev = current_device();
  if (dev < 0 || dev >= kMaxDevices) return 132;
  int n = cached[dev].load(std::memory_order_acquire);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
    cached[dev].store(n, std::memory_order_release);
  }
  return n;
}

// Packed rows a block takes: about two blocks per SM, a multiple of `unit`,
// at most `cap`.
int slice_rows(int kh, int N, int unit, int cap) {
  const int tiles = N / TN;
  const int want = (2 * sm_count() + tiles - 1) / tiles;
  const int splits = want < 1 ? 1 : want;
  int ks = (kh + splits - 1) / splits;
  ks = (ks + unit - 1) / unit * unit;
  if (ks > cap) ks = cap;
  return ks < unit ? unit : ks;
}

// Once per kernel and card: let its launches on the current card take up to
// that card's opt-in maximum of dynamic shared memory (the attribute is set
// per device; no CUDA API call per launch, and none inside a CUDA graph
// capture once the card has launched the kernel).
template <auto Kernel>
int allow_smem() {
  static std::atomic<int> status[kMaxDevices];  // 0: not set yet, else 1 + cudaError_t
  const int dev = current_device();
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int s = status[dev].load(std::memory_order_acquire);
  if (s == 0) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    s = 1 + static_cast<int>(
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
    status[dev].store(s, std::memory_order_release);
  }
  return s - 1;
}

// out[b][n] = T((sum_s part[s][b][n]) * scale[n]), slices in order. Launched
// as a programmatic dependent of the kernel before it: it may start early and
// waits here until that grid has finished and its partials are visible.
template <typename T>
__global__ void finish_kernel(const float* __restrict__ part, int splits, int nb, int n,
                              const float* __restrict__ scale, T* __restrict__ out) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb * n) return;
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * nb * n + i];  // loads issued together
  out[i] = from_f<T>(s * scale[i % n]);
}

template <typename T>
int finish(const Args& a, int splits, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.nb * a.N + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, finish_kernel<T>,
                                             static_cast<const float*>(a.part), splits, a.nb,
                                             a.N, static_cast<const float*>(a.scale),
                                             static_cast<T*>(a.out)));
}

// ----------------------------------------------------------------------------
// bf16 x: tensor cores (see the note at the top).

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int KSTEP = 16;                      // packed rows an mma k-step
constexpr int STAGES = 5;                      // k-steps in a warp's ring
constexpr int ROW_BYTES = TN + 16;             // padded ring row
constexpr int STAGE_BYTES = KSTEP * ROW_BYTES;
constexpr int MMA_UNIT = KSTEP * MMA_WARPS;    // slices are whole rounds of the warps
constexpr int MMA_KS_MAX = 1024;               // bounds the x slice in shared memory
constexpr int MMA_MAX_ROWS = 16;               // batch rows a launch: two n-tiles
constexpr int XPAD = 8;                        // x row stride ks + 8: conflict-free B reads
constexpr int RED_STRIDE = TN + 4;             // row of the warps' sums: conflict-free
constexpr unsigned BF16X2_136 = 0x43084308u;   // bf16 136.0 in both halves

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the rest
// written as zeros (bytes = 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bits 0-3 and 16-19 of v, two's-complement nibbles -> bf16x2 of their values.
__device__ __forceinline__ unsigned dequant2(unsigned v) {
  const unsigned biased = (v & 0x000F000Fu) ^ BF16X2_136;  // 128 + (nibble ^ 8)
  __nv_bfloat162 h, bias;
  const unsigned magic = BF16X2_136;
  memcpy(&h, &biased, 4);
  memcpy(&bias, &magic, 4);
  h = __hsub2(h, bias);
  unsigned out;
  memcpy(&out, &h, 4);
  return out;
}

__host__ __device__ constexpr size_t mma_ring_bytes(int rows) {
  return (size_t)MMA_WARPS * STAGES * STAGE_BYTES > (size_t)MMA_WARPS * rows * RED_STRIDE * 4
             ? (size_t)MMA_WARPS * STAGES * STAGE_BYTES
             : (size_t)MMA_WARPS * rows * RED_STRIDE * 4;
}

// xs[h][b][k] = x[b][h K/2 + r0 + k] for k < span, zero for b >= nb or
// k >= rows, in 16-byte copies (K % 16 == 0 keeps every x row offset aligned)
template <int ROWS>
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs, int xstride,
                                        const __nv_bfloat16* x, const Args& a, int kh, int r0,
                                        int rows, int span) {
  const int chunks = span / 8;
  for (int i = threadIdx.x; i < 2 * ROWS * chunks; i += MMA_THREADS) {
    const int k = i % chunks * 8, hb = i / chunks, b = hb % ROWS, h = hb / ROWS;
    const int live = b < a.nb ? max(0, min(8, rows - k)) : 0;
    cp_async16(xs + hb * xstride + k, live ? x + (size_t)b * a.K + h * kh + r0 + k : x,
               2 * live);
  }
}

template <int NT>
__global__ void __launch_bounds__(MMA_THREADS) int4_mma_kernel(Args a) {
  constexpr int ROWS = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][ROWS][TN], after the loop
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + mma_ring_bytes(ROWS));
  const int xstride = a.ks + XPAD;              // xs [2][ROWS][xstride]: halves lo, hi

  const int kh = a.K / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * a.ks;
  const int rows = min(a.ks, kh - r0);
  const int steps = (rows + KSTEP - 1) / KSTEP;
  const int mine = steps > warp ? (steps - warp + MMA_WARPS - 1) / MMA_WARPS : 0;

  // this lane's four rows of a step (2t, 2t+1, 2t+8, 2t+9), 16 bytes each
  unsigned char* ring = smem + warp * STAGES * STAGE_BYTES + 16 * g;
  const int8_t* src = a.p + (size_t)r0 * a.N + n0 + 16 * g;
  auto issue = [&](int i) {  // the warp's i-th step (step warp + 4i) -> slot i % STAGES
    if (i < mine) {
      const int s = warp + i * MMA_WARPS;
      unsigned char* slot = ring + (i % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = 2 * t + (q & 1) + 8 * (q >> 1);
        const int row = s * KSTEP + rr;
        const bool live = row < rows;
        cp_async16(slot + rr * ROW_BYTES, live ? src + (size_t)row * a.N : a.p, live ? 16 : 0);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  // x's two halves for this slice, zero past B and past the last row: with
  // cp.async (joining the first group) where K allows aligned copies, else
  // element by element
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const int span = steps * KSTEP;
  if (a.K % 16 == 0) {
    stage_x<ROWS>(xs, xstride, x, a, kh, r0, rows, span);
  } else {
    for (int i = threadIdx.x; i < 2 * ROWS * span; i += MMA_THREADS) {
      const int k = i % span, hb = i / span, b = hb % ROWS, h = hb / ROWS;
      xs[hb * xstride + k] = b < a.nb && k < rows ? x[(size_t)b * a.K + h * kh + r0 + k]
                                                  : __ushort_as_bfloat16(0);
    }
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  cp_async_wait<STAGES - 2>();  // this thread's x and first step
  __syncthreads();
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // let finish_kernel launch

  float acc[8][NT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][nt][c] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();
    const unsigned char* slot = ring + (i % STAGES) * STAGE_BYTES;
    uint4 r[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      r[q] = *reinterpret_cast<const uint4*>(slot + (2 * t + (q & 1) + 8 * (q >> 1)) * ROW_BYTES);
    issue(i + STAGES - 1);  // refills the slot read one step ago

    const int kk = (warp + i * MMA_WARPS) * KSTEP + 2 * t;
    unsigned blo[NT][2], bhi[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* xl = xs + (nt * 8 + g) * xstride + kk;
      const __nv_bfloat16* xh = xl + ROWS * xstride;
      blo[nt][0] = *reinterpret_cast<const unsigned*>(xl);
      blo[nt][1] = *reinterpret_cast<const unsigned*>(xl + 8);
      bhi[nt][0] = *reinterpret_cast<const unsigned*>(xh);
      bhi[nt][1] = *reinterpret_cast<const unsigned*>(xh + 8);
    }
    const unsigned w0[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
    const unsigned w1[4] = {r[1].x, r[1].y, r[1].z, r[1].w};
    const unsigned w8[4] = {r[2].x, r[2].y, r[2].z, r[2].w};
    const unsigned w9[4] = {r[3].x, r[3].y, r[3].z, r[3].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // bytes 2(j%2) and 2(j%2)+1 of word j/2: columns 16g + 2j and 16g + 2j + 1
      const unsigned sel = j & 1 ? 0x7632u : 0x5410u;
      const unsigned v01 = __byte_perm(w0[j / 2], w1[j / 2], sel);  // rows 2t, 2t+1
      const unsigned v89 = __byte_perm(w8[j / 2], w9[j / 2], sel);  // rows 2t+8, 2t+9
      const unsigned alo[4] = {dequant2(v01), dequant2(v01 >> 8), dequant2(v89),
                               dequant2(v89 >> 8)};
      const unsigned ahi[4] = {dequant2(v01 >> 4), dequant2(v01 >> 12), dequant2(v89 >> 4),
                               dequant2(v89 >> 12)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(acc[j][nt], alo, blo[nt][0], blo[nt][1]);
        mma_bf16(acc[j][nt], ahi, bhi[nt][0], bhi[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: red reuses it

  // acc[j][nt][c]: column 16g + 2j + (c >> 1), batch row 8 nt + 2t + (c & 1).
  // red [WARPS][ROWS][RED_STRIDE] holds column n at (n % 16) * 8 + n / 16:
  // the stores and the loads below are free of bank conflicts.
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * ROWS + nt * 8 + 2 * t + (c & 1)) * RED_STRIDE + (2 * j + (c >> 1)) * 8 + g] =
            acc[j][nt][c];
  __syncthreads();
  for (int i = threadIdx.x; i < a.nb * TN; i += MMA_THREADS) {
    const int b = i / TN, c = i % TN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MMA_WARPS; ++w) s += red[(w * ROWS + b) * RED_STRIDE + c];
    const int n = n0 + (c % 8) * 16 + c / 8;
    if (gridDim.y == 1) {
      static_cast<__nv_bfloat16*>(a.out)[(size_t)b * a.N + n] = __float2bfloat16(s * a.scale[n]);
    } else {
      a.part[((size_t)blockIdx.y * a.nb + b) * a.N + n] = s;
    }
  }
}

int mma_slice_rows(int K, int N) { return slice_rows(K / 2, N, MMA_UNIT, MMA_KS_MAX); }

size_t mma_smem_bytes(int nt, int ks) {
  return mma_ring_bytes(8 * nt) + sizeof(__nv_bfloat16) * 2 * 8 * nt * (size_t)(ks + XPAD);
}

template <int NT>
int mma_group(Args a, cudaStream_t st) {
  a.ks = mma_slice_rows(a.K, a.N);
  const int splits = (a.K / 2 + a.ks - 1) / a.ks;
  int e = allow_smem<int4_mma_kernel<NT>>();
  if (e) return e;
  int4_mma_kernel<NT><<<dim3(a.N / TN, splits), MMA_THREADS, mma_smem_bytes(NT, a.ks), st>>>(a);
  e = static_cast<int>(cudaGetLastError());
  return e || splits == 1 ? e : finish<__nv_bfloat16>(a, splits, st);
}

int run_mma(Args a, cudaStream_t st) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  for (int b0 = 0; b0 < a.nb; b0 += MMA_MAX_ROWS) {
    Args g = a;
    g.nb = a.nb - b0 < MMA_MAX_ROWS ? a.nb - b0 : MMA_MAX_ROWS;
    g.x = x + (size_t)b0 * a.K;
    g.out = out + (size_t)b0 * a.N;
    const int e = g.nb > 8 ? mma_group<2>(g, st) : mma_group<1>(g, st);
    if (e) return e;
  }
  return 0;
}

// ----------------------------------------------------------------------------
// f32 x: CUDA cores. The tensor cores would round x to bf16 or TF32, and the
// f32 result is held to 1e-5 of its peak. A block owns 128 columns and a
// slice of the K/2 packed rows; 16 lanes read a row with 8-byte loads and a
// warp covers two rows. The block stages x's two halves for its slice in
// shared memory, unpacks each byte in registers (the low nibble sign-extended
// by mask and xor, the high one by an arithmetic shift), and accumulates lo
// and hi products into one f32 sum a column. Row groups reduce by warp
// shuffle, warps through shared memory.

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BB = 8;
constexpr int VB = 8;            // packed bytes (columns) a lane loads
constexpr int LPR = TN / VB;     // lanes a row: 16
constexpr int RP = THREADS / LPR;  // packed rows a pass: 16
constexpr int UNROLL = 4;

template <int BB>
__global__ void __launch_bounds__(THREADS) int4_kernel(Args a) {
  extern __shared__ float smem_f[];
  const int kh = a.K / 2;
  float* xlo = smem_f;                     // [BB][ks]
  float* xhi = xlo + BB * a.ks;            // [BB][ks]
  float* wsum = xhi + BB * a.ks;           // [WARPS][BB][TN]

  const float* x = static_cast<const float*>(a.x);
  const int n0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * a.ks;
  const int rows = min(a.ks, kh - r0);
  for (int i = threadIdx.x; i < BB * a.ks; i += THREADS) {
    const int b = i / a.ks, r = i % a.ks;
    const bool live = b < a.nb && r < rows;
    xlo[i] = live ? x[(size_t)b * a.K + r0 + r] : 0.f;
    xhi[i] = live ? x[(size_t)b * a.K + kh + r0 + r] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x % LPR, rg = threadIdx.x / LPR;
  const int8_t* pp = a.p + (size_t)r0 * a.N + n0 + lane * VB;
  float acc[BB][VB];
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int v = 0; v < VB; ++v) acc[b][v] = 0.f;

  for (int r = rg; r < rows; r += RP * UNROLL) {
    uint2 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * RP;
      q[u] = rr < rows ? __ldg(reinterpret_cast<const uint2*>(pp + (size_t)rr * a.N))
                       : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * RP;
      if (rr >= rows) continue;
      float lo[VB], hi[VB];
#pragma unroll
      for (int v = 0; v < VB; ++v) {
        const uint32_t word = v < 4 ? q[u].x : q[u].y;
        const int byte = static_cast<int>(static_cast<int8_t>((word >> (8 * (v % 4))) & 0xffu));
        lo[v] = static_cast<float>(((byte & 15) ^ 8) - 8);  // sign-extended low nibble
        hi[v] = static_cast<float>(byte >> 4);            // arithmetic shift: high nibble
      }
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        const float xl = xlo[b * a.ks + rr], xh = xhi[b * a.ks + rr];
#pragma unroll
        for (int v = 0; v < VB; ++v) acc[b][v] = fmaf(xh, hi[v], fmaf(xl, lo[v], acc[b][v]));
      }
    }
  }

  // row groups of a warp: lanes l and l + 16 hold the same columns
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int v = 0; v < VB; ++v) acc[b][v] += __shfl_xor_sync(0xffffffffu, acc[b][v], LPR);
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  if (wl < LPR) {
#pragma unroll
    for (int b = 0; b < BB; ++b)
#pragma unroll
      for (int v = 0; v < VB; ++v) wsum[(warp * BB + b) * TN + wl * VB + v] = acc[b][v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.nb * TN; i += THREADS) {
    const int b = i / TN, c = i % TN;
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s += wsum[(k * BB + b) * TN + c];
    const int n = n0 + c;
    if (gridDim.y == 1) {
      static_cast<float*>(a.out)[(size_t)b * a.N + n] = s * a.scale[n];
    } else {
      a.part[((size_t)blockIdx.y * a.nb + b) * a.N + n] = s;
    }
  }
}

int fma_slice_rows(int K, int N) { return slice_rows(K / 2, N, RP, 1 << 30); }

size_t fma_smem_bytes(int bb, int ks) {
  return sizeof(float) * (2 * (size_t)bb * ks + (size_t)WARPS * bb * TN);
}

template <int BB>
int fma_group(Args a, cudaStream_t st) {
  a.ks = fma_slice_rows(a.K, a.N);
  const int splits = (a.K / 2 + a.ks - 1) / a.ks;
  int e = allow_smem<int4_kernel<BB>>();
  if (e) return e;
  int4_kernel<BB><<<dim3(a.N / TN, splits), THREADS, fma_smem_bytes(BB, a.ks), st>>>(a);
  e = static_cast<int>(cudaGetLastError());
  return e || splits == 1 ? e : finish<float>(a, splits, st);
}

int run_fma(Args a, cudaStream_t st) {
  const float* x = static_cast<const float*>(a.x);
  float* out = static_cast<float*>(a.out);
  for (int b0 = 0; b0 < a.nb; b0 += MAX_BB) {
    Args g = a;
    g.nb = a.nb - b0 < MAX_BB ? a.nb - b0 : MAX_BB;
    g.x = x + (size_t)b0 * a.K;
    g.out = out + (size_t)b0 * a.N;
    int e;
    if (g.nb == 1) e = fma_group<1>(g, st);
    else if (g.nb == 2) e = fma_group<2>(g, st);
    else if (g.nb <= 4) e = fma_group<4>(g, st);
    else e = fma_group<8>(g, st);
    if (e) return e;
  }
  return 0;
}

int splits_of(int ks, int K) { return (K / 2 + ks - 1) / ks; }

}  // namespace

// f32 scratch the partials of one batch group take (0: one slice, none), and
// the shared memory of a block, for the wrapper. bf16 selects the tensor-core
// kernel, else the CUDA-core one.
extern "C" long long est_int4_scratch_floats(int B, int K, int N, int bf16) {
  const int ks = bf16 ? mma_slice_rows(K, N) : fma_slice_rows(K, N);
  const int splits = splits_of(ks, K);
  const int rows = bf16 ? MMA_MAX_ROWS : MAX_BB;
  return splits > 1 ? (long long)splits * (B < rows ? B : rows) * N : 0;
}

extern "C" long long est_int4_smem(int B, int K, int N, int bf16) {
  if (bf16) return static_cast<long long>(mma_smem_bytes(B > 8 ? 2 : 1, mma_slice_rows(K, N)));
  const int bb = B > 4 ? 8 : (B > 2 ? 4 : B);
  return static_cast<long long>(fma_smem_bytes(bb, fma_slice_rows(K, N)));
}

// x [B, K] and out [B, N] in T (bf16 if bf16 else f32), p [K/2, N] int8,
// scale [N] f32, all contiguous; K even, N % 128 == 0, p 16-byte aligned.
// Returns the first CUDA error.
extern "C" int est_matmul_int4(const void* x, const void* p, const void* scale, void* out,
                               void* part, int B, int K, int N, int bf16, void* stream) {
  Args a{x, static_cast<const int8_t*>(p), static_cast<const float*>(scale), out,
         static_cast<float*>(part), B, K, N, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run_mma(a, st) : run_fma(a, st);
}

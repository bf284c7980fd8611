// Packed-int4 weight-only matmul, hand-written for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_int4.py, matmul_int4 (Pallas kernel
//           `_kernel`), with weights from pack_int4.
//
// Computes y = T((x[:, :K/2] @ lo(P) + x[:, K/2:] @ hi(P)) * scale) for
// x [B, K] in T (bf16 or f32), P [K/2, N] int8 holding two signed 4-bit
// weights a byte (low nibble: row k of the [K, N] weights, high nibble: row
// k + K/2) and scale [N] f32. The nibbles are exact in f32, so every product
// is exact for bf16 x and every sum is f32.
//
// What bounds it on the H100: bytes. The packed weights are K*N/2 bytes and
// each byte feeds 2B multiply-adds; at decode batch B <= 8 that is far below
// the card's ~295 operations per byte.
//
// Design. A block owns 128 columns of N (one 128-byte line a packed row) and
// a slice of the K/2 packed rows, sized so the grid holds about two blocks per
// SM; 16 lanes read a row with 8-byte loads and a warp covers two rows. The
// block stages x's two halves for its slice in shared memory as f32, unpacks
// each byte in registers (the low nibble sign-extended by mask and xor, the
// high one by an arithmetic shift), and accumulates lo and hi products into
// one f32 sum a column. Row groups reduce by warp shuffle,
// warps through shared memory. Slices write f32 partials that a second kernel
// adds in slice order (deterministic) before the scale and the rounding to T;
// with one slice the first kernel finishes alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BB = 8;
constexpr int TN = 128;          // columns of N a block
constexpr int VB = 8;            // packed bytes (columns) a lane loads
constexpr int LPR = TN / VB;     // lanes a row: 16
constexpr int RP = THREADS / LPR;  // packed rows a pass: 16
constexpr int UNROLL = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* x; const int8_t* p; const float* scale; void* out; float* part;
  int nb, K, N, ks;
};

template <typename T, int BB>
__global__ void __launch_bounds__(THREADS) int4_kernel(Args a) {
  extern __shared__ float smem[];
  const int kh = a.K / 2;
  float* xlo = smem;                       // [BB][ks]
  float* xhi = xlo + BB * a.ks;            // [BB][ks]
  float* wsum = xhi + BB * a.ks;           // [WARPS][BB][TN]

  const T* x = static_cast<const T*>(a.x);
  const int n0 = blockIdx.x * TN;
  const int r0 = blockIdx.y * a.ks;
  const int rows = min(a.ks, kh - r0);
  for (int i = threadIdx.x; i < BB * a.ks; i += THREADS) {
    const int b = i / a.ks, r = i % a.ks;
    const bool live = b < a.nb && r < rows;
    xlo[i] = live ? to_f(x[(size_t)b * a.K + r0 + r]) : 0.f;
    xhi[i] = live ? to_f(x[(size_t)b * a.K + kh + r0 + r]) : 0.f;
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
      static_cast<T*>(a.out)[(size_t)b * a.N + n] = from_f<T>(s * a.scale[n]);
    } else {
      a.part[((size_t)blockIdx.y * a.nb + b) * a.N + n] = s;
    }
  }
}

// out[b][n] = T((sum_s part[s][b][n]) * scale[n]), slices in order
template <typename T>
__global__ void finish_kernel(const float* __restrict__ part, int splits, int nb, int n,
                              const float* __restrict__ scale, T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb * n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * nb * n + i];
  out[i] = from_f<T>(s * scale[i % n]);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// packed rows a block takes: about two blocks per SM, whole passes of RP rows
int slice_rows(int kh, int N) {
  const int tiles = N / TN;
  const int want = (2 * sm_count() + tiles - 1) / tiles;
  const int splits = want < 1 ? 1 : want;
  int ks = (kh + splits - 1) / splits;
  ks = (ks + RP - 1) / RP * RP;
  return ks < RP ? RP : ks;
}

// Once per kernel: let its launches take up to the card's opt-in maximum of
// dynamic shared memory (no CUDA API call per launch, and none inside a CUDA
// graph capture).
template <auto Kernel>
int allow_smem() {
  static const int status = [] {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return static_cast<int>(
        cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
  }();
  return status;
}

size_t smem_bytes(int bb, int ks) {
  return sizeof(float) * (2 * (size_t)bb * ks + (size_t)WARPS * bb * TN);
}

template <typename T, int BB>
int group(Args a, cudaStream_t st) {
  a.ks = slice_rows(a.K / 2, a.N);
  const int splits = (a.K / 2 + a.ks - 1) / a.ks;
  const size_t smem = smem_bytes(BB, a.ks);
  int e = allow_smem<int4_kernel<T, BB>>();
  if (e) return e;
  int4_kernel<T, BB><<<dim3(a.N / TN, splits), THREADS, smem, st>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e || splits == 1) return e;
  const int total = a.nb * a.N;
  finish_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(a.part, splits, a.nb, a.N, a.scale,
                                                       static_cast<T*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(Args a, cudaStream_t st) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int B = a.nb;
  for (int b0 = 0; b0 < B; b0 += MAX_BB) {
    Args g = a;
    g.nb = B - b0 < MAX_BB ? B - b0 : MAX_BB;
    g.x = x + (size_t)b0 * a.K;
    g.out = out + (size_t)b0 * a.N;
    int e;
    if (g.nb == 1) e = group<T, 1>(g, st);
    else if (g.nb == 2) e = group<T, 2>(g, st);
    else if (g.nb <= 4) e = group<T, 4>(g, st);
    else e = group<T, 8>(g, st);
    if (e) return e;
  }
  return 0;
}

}  // namespace

// Slices the K/2 packed rows are cut into (the scratch takes splits *
// min(B, 8) * N floats) and the shared memory of a block, for the wrapper.
extern "C" int est_int4_splits(int K, int N) {
  const int ks = slice_rows(K / 2, N);
  return (K / 2 + ks - 1) / ks;
}

extern "C" long long est_int4_smem(int K, int N, int B) {
  const int bb = B > 4 ? 8 : (B > 2 ? 4 : B);
  return static_cast<long long>(smem_bytes(bb, slice_rows(K / 2, N)));
}

// x [B, K] and out [B, N] in T (bf16 if bf16 else f32), p [K/2, N] int8,
// scale [N] f32, all contiguous; K even, N % 128 == 0, p 8-byte aligned.
// Returns the first CUDA error.
extern "C" int est_matmul_int4(const void* x, const void* p, const void* scale, void* out,
                               void* part, int B, int K, int N, int bf16, void* stream) {
  Args a{x, static_cast<const int8_t*>(p), static_cast<const float*>(scale), out,
         static_cast<float*>(part), B, K, N, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(a, st) : run<float>(a, st);
}

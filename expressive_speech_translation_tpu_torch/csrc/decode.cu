// Fused norm -> matvec and norm -> MLP for decode steps, hand-written for
// Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_decode.py, fused_ln_matvec
//           (Pallas kernel `_ln_matvec_kernel`) and fused_ln_mlp
//           (`_ln_mlp_kernel`, weights from pack_mlp).
//
// Computes, for x [B, D] in the io type T (bf16 or f32):
//   x^ = T(norm(x))                with norm in {layer, rms, none}, stats in f32
//   ln_matvec: out = T(x^ @ W + b)                        W [D, N]
//   ln_mlp:    u   = T(act(x^ @ W1 + b1))                 W1 = packed[0:D]
//         gated:u  = T(act(x^ @ Wg) * (x^ @ W1 + b1))     Wg = packed[2D:3D]
//              out = T([x +] u @ W2 + b2)                 W2^T = packed[D:2D], [D, F]
// Products are exact in f32 (T operands), every sum is f32; the small vectors
// (norm scale and bias, b, b1, b2) are read as f32. gelu is the exact erf.
//
// What bounds it on the H100: bytes. At decode batch B <= 8 each weight
// element is used for B multiply-adds, far below the ~295 operations per byte
// where the tensor cores would start to bind; the weights (2-27 MB a call in
// bf16 at Whisper-medium and Qwen2-0.5B widths) have to stream from device
// memory once, at 3.35 TB/s.
//
// Design. Hopper's blocks run in parallel and in no order, so nothing carries
// across a grid the way the TPU kernel carries its accumulator; and one block
// per 128 columns would leave most of the 132 SMs idle (24 blocks at
// N = 3072). So:
// - ln_matvec splits both N (64 columns a block) and D (a slice of rows a
//   block, chosen so the grid holds about two blocks per SM). Each block
//   computes the norm statistics over the whole row (x is a few KB, read from
//   L2) and keeps x^ for its slice in shared memory. Lanes read weight rows
//   along N with 16-byte loads, 128 contiguous bytes a row; a warp covers
//   several rows, shuffles reduce the row groups of a warp and shared memory
//   the warps of a block. A block writes its f32 partial sums; a second,
//   small kernel adds the slices in a fixed order (deterministic), adds the
//   bias and rounds to T. With a single slice the first kernel finishes alone.
// - ln_mlp gives each block 32 columns of F (one chunk). The block computes
//   x^ over all of D, u for its chunk (the first product needs the whole of D
//   before the activation), then its chunk's share of the second product for
//   every output column (rows of W2^T, read along F). The per-chunk f32
//   partials are summed in chunk order by the second kernel, which adds b2 and
//   the residual.
// B rows are taken up to 8 at a time (template BB); the host loops over
// groups of 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BB = 8;
constexpr int MV_TN = 64;    // ln_matvec: columns of N a block
constexpr int MLP_TF = 32;   // ln_mlp: columns of F a block
constexpr int UNROLL = 4;    // weight loads in flight per thread

enum Norm { NORM_NONE = 0, NORM_LAYER = 1, NORM_RMS = 2 };
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// f32 value of v rounded to T (the cast the JAX kernel makes before a product)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 bytes at p (16-byte aligned) -> f32 values
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float act_fn(float u, int act) {
  switch (act) {
    case ACT_GELU: return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
    case ACT_SILU: return u / (1.0f + expf(-u));
    case ACT_RELU: return fmaxf(u, 0.0f);
    default: return u;
  }
}

// Sum of v over the block; every thread gets the result. `red` holds WARPS
// floats; the caller's loop keeps uses apart with the syncs inside.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// x^ rows [0, nb) over columns [d0, d0 + cols) of x [nb, D] into xs[b][cols]
// as f32 values rounded to T (rows nb..BB-1 are zero). Statistics over all D.
template <typename T, int BB>
__device__ void normed_rows(const T* __restrict__ x, int nb, int D, int d0, int cols,
                            const float* __restrict__ scale, const float* __restrict__ bias,
                            int norm, float eps, float* xs, float* red) {
  for (int b = 0; b < BB; ++b) {
    float* row = xs + (size_t)b * cols;
    if (b >= nb) {
      for (int c = threadIdx.x; c < cols; c += THREADS) row[c] = 0.f;
      continue;
    }
    const T* xr = x + (size_t)b * D;
    float mean = 0.f, inv = 1.f;
    if (norm == NORM_LAYER) {
      float s = 0.f;
      for (int d = threadIdx.x; d < D; d += THREADS) s += to_f(xr[d]);
      mean = block_sum(s, red) / D;
      float q = 0.f;
      for (int d = threadIdx.x; d < D; d += THREADS) {
        const float c = to_f(xr[d]) - mean;
        q += c * c;
      }
      inv = 1.0f / sqrtf(block_sum(q, red) / D + eps);
    } else if (norm == NORM_RMS) {
      float q = 0.f;
      for (int d = threadIdx.x; d < D; d += THREADS) {
        const float v = to_f(xr[d]);
        q += v * v;
      }
      inv = 1.0f / sqrtf(block_sum(q, red) / D + eps);
    }
    for (int c = threadIdx.x; c < cols; c += THREADS) {
      const int d = d0 + c;
      float y = 0.f;
      if (d < D) {
        const float v = to_f(xr[d]);
        if (norm == NORM_LAYER) y = (v - mean) * inv * scale[d] + bias[d];
        else if (norm == NORM_RMS) y = v * inv * scale[d];
        else y = v;
      }
      row[c] = round_to<T>(y);
    }
  }
  __syncthreads();
}

// acc[b][v] over the row groups of a warp: lanes l, l + lpr, l + 2 lpr, ...
// hold the same columns. After it, lanes < lpr hold the warp's sums.
template <int BB, int V>
__device__ __forceinline__ void warp_rowgroup_sum(float (&acc)[BB][V], int lpr) {
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int b = 0; b < BB; ++b)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[b][v] += __shfl_xor_sync(0xffffffffu, acc[b][v], o);
  }
}

// -------------------------------------------------------------- ln -> matvec

struct MatvecArgs {
  const void* x; const float* scale; const float* bias; const void* w; const float* b;
  void* out; float* part; int nb, D, N, ks, norm; float eps;
};

template <typename T, int BB>
__global__ void __launch_bounds__(THREADS) ln_matvec_kernel(MatvecArgs a) {
  constexpr int V = Vec<T>::N;
  constexpr int LPR = MV_TN / V;          // lanes a row
  constexpr int RP = THREADS / LPR;       // rows a pass
  extern __shared__ float smem[];
  float* red = smem;                      // [WARPS]
  float* xs = smem + WARPS;               // [BB][ks]
  float* wsum = xs + BB * a.ks;           // [WARPS][BB][MV_TN]

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int n0 = blockIdx.x * MV_TN;
  const int d0 = blockIdx.y * a.ks;
  const int rows = min(a.ks, a.D - d0);
  normed_rows<T, BB>(x, a.nb, a.D, d0, a.ks, a.scale, a.bias, a.norm, a.eps, xs, red);

  const int lane = threadIdx.x % LPR, rg = threadIdx.x / LPR;
  const T* wp = w + (size_t)d0 * a.N + n0 + lane * V;
  float acc[BB][V];
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[b][v] = 0.f;

  for (int r = rg; r < rows; r += RP * UNROLL) {
    float wv[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * RP;
      if (rr < rows) load16(wp + (size_t)rr * a.N, wv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * RP;
      if (rr < rows) {
#pragma unroll
        for (int b = 0; b < BB; ++b) {
          const float xv = xs[b * a.ks + rr];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[b][v] = fmaf(xv, wv[u][v], acc[b][v]);
        }
      }
    }
  }

  warp_rowgroup_sum<BB, V>(acc, LPR);
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  if (wl < LPR) {
#pragma unroll
    for (int b = 0; b < BB; ++b)
#pragma unroll
      for (int v = 0; v < V; ++v) wsum[(warp * BB + b) * MV_TN + wl * V + v] = acc[b][v];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.nb * MV_TN; i += THREADS) {
    const int b = i / MV_TN, c = i % MV_TN;
    float s = 0.f;
    for (int k = 0; k < WARPS; ++k) s += wsum[(k * BB + b) * MV_TN + c];
    const int n = n0 + c;
    if (gridDim.y == 1) {
      static_cast<T*>(a.out)[(size_t)b * a.N + n] = from_f<T>(s + a.b[n]);
    } else {
      a.part[((size_t)blockIdx.y * a.nb + b) * a.N + n] = s;
    }
  }
}

// ------------------------------------------------------------------ ln -> mlp

struct MlpArgs {
  const void* x; const float* scale; const float* bias; const void* w; const float* b1;
  float* part; int nb, D, F, norm, act; float eps;
};

template <typename T, int BB, bool GATED>
__global__ void __launch_bounds__(THREADS) ln_mlp_kernel(MlpArgs a) {
  constexpr int V = Vec<T>::N;
  constexpr int LPR = MLP_TF / V;         // lanes a row of a chunk
  constexpr int RP = THREADS / LPR;       // rows a pass
  constexpr int G = GATED ? 2 : 1;
  extern __shared__ float smem[];
  float* red = smem;                      // [WARPS]
  float* us = smem + WARPS;               // [BB][MLP_TF]
  float* wsum = us + BB * MLP_TF;         // [G][WARPS][BB][MLP_TF]
  float* xs = wsum + G * WARPS * BB * MLP_TF;  // [BB][D]

  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int D = a.D, F = a.F;
  const int f0 = blockIdx.x * MLP_TF;
  normed_rows<T, BB>(x, a.nb, D, 0, D, a.scale, a.bias, a.norm, a.eps, xs, red);

  const int lane = threadIdx.x % LPR, rg = threadIdx.x / LPR;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;

  // first product: x^ @ W1 (and x^ @ Wg) over all of D for this chunk
  {
    float acc[G][BB][V];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int b = 0; b < BB; ++b)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[g][b][v] = 0.f;
    const T* w1 = w + f0 + lane * V;
    const T* wg = w + (size_t)2 * D * F + f0 + lane * V;
    for (int r = rg; r < D; r += RP * UNROLL) {
      float wv[G][UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int rr = r + u * RP;
        if (rr < D) {
          load16(w1 + (size_t)rr * F, wv[0][u]);
          if (GATED) load16(wg + (size_t)rr * F, wv[G - 1][u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int rr = r + u * RP;
        if (rr < D) {
#pragma unroll
          for (int b = 0; b < BB; ++b) {
            const float xv = xs[b * D + rr];
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int v = 0; v < V; ++v) acc[g][b][v] = fmaf(xv, wv[g][u][v], acc[g][b][v]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) warp_rowgroup_sum<BB, V>(acc[g], LPR);
    if (wl < LPR) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int b = 0; b < BB; ++b)
#pragma unroll
          for (int v = 0; v < V; ++v)
            wsum[((g * WARPS + warp) * BB + b) * MLP_TF + wl * V + v] = acc[g][b][v];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BB * MLP_TF; i += THREADS) {
    const int b = i / MLP_TF, c = i % MLP_TF;
    float h = 0.f, gate = 0.f;
    for (int k = 0; k < WARPS; ++k) {
      h += wsum[(k * BB + b) * MLP_TF + c];
      if (GATED) gate += wsum[((WARPS + k) * BB + b) * MLP_TF + c];
    }
    h += a.b1[f0 + c];
    const float u = GATED ? act_fn(gate, a.act) * h : act_fn(h, a.act);
    us[i] = b < a.nb ? round_to<T>(u) : 0.f;
  }
  __syncthreads();

  // second product: this chunk's share u[:, chunk] @ W2[chunk, :] for every
  // output column d, from rows d of W2^T read along F
  float uv[BB][V];
#pragma unroll
  for (int b = 0; b < BB; ++b)
#pragma unroll
    for (int v = 0; v < V; ++v) uv[b][v] = us[b * MLP_TF + lane * V + v];
  const T* w2 = w + (size_t)D * F + f0 + lane * V;
  for (int r = rg; r < D; r += RP * UNROLL) {
    float wv[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * RP;
      if (rr < D) load16(w2 + (size_t)rr * F, wv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int rr = r + u * RP;  // uniform across the LPR lanes of a row
      float s[BB];
#pragma unroll
      for (int b = 0; b < BB; ++b) {
        s[b] = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) s[b] = fmaf(uv[b][v], wv[u][v], s[b]);
      }
#pragma unroll
      for (int o = 1; o < LPR; o <<= 1)
#pragma unroll
        for (int b = 0; b < BB; ++b) s[b] += __shfl_xor_sync(0xffffffffu, s[b], o);
      if (rr < D && lane == 0) {
#pragma unroll
        for (int b = 0; b < BB; ++b)
          if (b < a.nb) a.part[((size_t)blockIdx.x * a.nb + b) * D + rr] = s[b];
      }
    }
  }
}

// -------------------------------------------------------------------- finish

// out[b][n] = T(sum_s part[s][b][n] + bias[n] [+ resid[b][n]]), slices in order
template <typename T>
__global__ void finish_kernel(const float* __restrict__ part, int splits, int nb, int n,
                              const float* __restrict__ bias, const T* __restrict__ resid,
                              T* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb * n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * nb * n + i];
  s += bias[i % n];
  if (resid != nullptr) s += to_f(resid[i]);
  out[i] = from_f<T>(s);
}

template <typename T>
int launch_finish(const float* part, int splits, int nb, int n, const float* bias,
                  const T* resid, T* out, cudaStream_t st) {
  const int total = nb * n;
  finish_kernel<T><<<(total + 255) / 256, 256, 0, st>>>(part, splits, nb, n, bias, resid, out);
  return static_cast<int>(cudaGetLastError());
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

// rows of D a ln_matvec block takes: about two blocks per SM over the grid,
// whole passes of rp rows
int matvec_rows(int D, int N, int rp) {
  const int tiles = N / MV_TN;
  const int want = (2 * sm_count() + tiles - 1) / tiles;
  const int splits = want < 1 ? 1 : want;
  int ks = (D + splits - 1) / splits;
  ks = (ks + rp - 1) / rp * rp;
  return ks < rp ? rp : ks;
}

size_t matvec_smem(int bb, int ks) {
  return sizeof(float) * ((size_t)WARPS + (size_t)bb * ks + (size_t)WARPS * bb * MV_TN);
}

size_t mlp_smem(int bb, int D, bool gated) {
  const size_t g = gated ? 2 : 1;
  return sizeof(float) *
         ((size_t)WARPS + (size_t)bb * MLP_TF + g * WARPS * bb * MLP_TF + (size_t)bb * D);
}

template <typename T, int BB>
int matvec_group(MatvecArgs a, cudaStream_t st) {
  constexpr int RP = THREADS / (MV_TN / Vec<T>::N);
  a.ks = matvec_rows(a.D, a.N, RP);
  const int splits = (a.D + a.ks - 1) / a.ks;
  const size_t smem = matvec_smem(BB, a.ks);
  int e = allow_smem<ln_matvec_kernel<T, BB>>();
  if (e) return e;
  ln_matvec_kernel<T, BB><<<dim3(a.N / MV_TN, splits), THREADS, smem, st>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e || splits == 1) return e;
  return launch_finish<T>(a.part, splits, a.nb, a.N, a.b, nullptr, static_cast<T*>(a.out), st);
}

template <typename T, int BB, bool GATED>
int mlp_group(MlpArgs a, const float* b2, const T* resid, T* out, cudaStream_t st) {
  const size_t smem = mlp_smem(BB, a.D, GATED);
  int e = allow_smem<ln_mlp_kernel<T, BB, GATED>>();
  if (e) return e;
  ln_mlp_kernel<T, BB, GATED><<<a.F / MLP_TF, THREADS, smem, st>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  return launch_finish<T>(a.part, a.F / MLP_TF, a.nb, a.D, b2, resid, out, st);
}

template <typename T>
int matvec_all(MatvecArgs a, cudaStream_t st) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int B = a.nb;
  for (int b0 = 0; b0 < B; b0 += MAX_BB) {
    MatvecArgs g = a;
    g.nb = B - b0 < MAX_BB ? B - b0 : MAX_BB;
    g.x = x + (size_t)b0 * a.D;
    g.out = out + (size_t)b0 * a.N;
    int e;
    if (g.nb == 1) e = matvec_group<T, 1>(g, st);
    else if (g.nb == 2) e = matvec_group<T, 2>(g, st);
    else if (g.nb <= 4) e = matvec_group<T, 4>(g, st);
    else e = matvec_group<T, 8>(g, st);
    if (e) return e;
  }
  return 0;
}

template <typename T, bool GATED>
int mlp_all(MlpArgs a, const float* b2, int residual, void* out_v, cudaStream_t st) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(out_v);
  const int B = a.nb;
  for (int b0 = 0; b0 < B; b0 += MAX_BB) {
    MlpArgs g = a;
    g.nb = B - b0 < MAX_BB ? B - b0 : MAX_BB;
    g.x = x + (size_t)b0 * a.D;
    const T* resid = residual ? x + (size_t)b0 * a.D : nullptr;
    T* o = out + (size_t)b0 * a.D;
    int e;
    if (g.nb == 1) e = mlp_group<T, 1, GATED>(g, b2, resid, o, st);
    else if (g.nb == 2) e = mlp_group<T, 2, GATED>(g, b2, resid, o, st);
    else if (g.nb <= 4) e = mlp_group<T, 4, GATED>(g, b2, resid, o, st);
    else e = mlp_group<T, 8, GATED>(g, b2, resid, o, st);
    if (e) return e;
  }
  return 0;
}

}  // namespace

// Scratch (f32) each call needs, in floats: ln_matvec min(B, 8) * N * splits
// (est_ln_matvec_splits), ln_mlp min(B, 8) * D * F / 32.
extern "C" int est_ln_matvec_splits(int D, int N, int bf16) {
  const int rp = THREADS / (MV_TN / (bf16 ? 8 : 4));
  const int ks = matvec_rows(D, N, rp);
  return (D + ks - 1) / ks;
}

extern "C" long long est_ln_matvec_smem(int D, int N, int B, int bf16) {
  const int rp = THREADS / (MV_TN / (bf16 ? 8 : 4));
  const int bb = B > 4 ? 8 : (B > 2 ? 4 : B);
  return static_cast<long long>(matvec_smem(bb, matvec_rows(D, N, rp)));
}

extern "C" long long est_ln_mlp_smem(int D, int B, int gated) {
  const int bb = B > 4 ? 8 : (B > 2 ? 4 : B);
  return static_cast<long long>(mlp_smem(bb, D, gated != 0));
}

// x [B, D], w [D, N], out [B, N] in T (bf16 if bf16 else f32), contiguous,
// 16-byte aligned, N % 64 == 0; scale, bias [D] and b [N] f32; part: scratch.
// norm: 0 none, 1 layer, 2 rms. Returns the first CUDA error.
extern "C" int est_ln_matvec(const void* x, const void* scale, const void* bias, const void* w,
                             const void* b, void* out, void* part, int B, int D, int N,
                             int norm, float eps, int bf16, void* stream) {
  MatvecArgs a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), w,
               static_cast<const float*>(b), out, static_cast<float*>(part), B, D, N, 0,
               norm, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? matvec_all<__nv_bfloat16>(a, st) : matvec_all<float>(a, st);
}

// x [B, D] and out [B, D] in T; w: pack_mlp rows [w1; w2^T (; w_gate)] of
// [D, F] each, F % 32 == 0; scale, bias, b2 [D] and b1 [F] f32; part:
// scratch. act: 0 none, 1 gelu, 2 silu, 3 relu.
extern "C" int est_ln_mlp(const void* x, const void* scale, const void* bias, const void* w,
                          const void* b1, const void* b2, void* out, void* part, int B, int D,
                          int F, int norm, float eps, int act, int gated, int residual,
                          int bf16, void* stream) {
  MlpArgs a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), w,
            static_cast<const float*>(b1), static_cast<float*>(part), B, D, F, norm, act, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b2f = static_cast<const float*>(b2);
  if (bf16) {
    return gated ? mlp_all<__nv_bfloat16, true>(a, b2f, residual, out, st)
                 : mlp_all<__nv_bfloat16, false>(a, b2f, residual, out, st);
  }
  return gated ? mlp_all<float, true>(a, b2f, residual, out, st)
               : mlp_all<float, false>(a, b2f, residual, out, st);
}

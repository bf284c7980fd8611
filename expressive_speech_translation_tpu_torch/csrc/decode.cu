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
// What bounds it on the H100: bytes. At decode batch B <= 16 each weight
// element is used for B multiply-adds, far below the ~295 operations per byte
// where the tensor cores would start to bind; the weights (2-27 MB a call in
// bf16 at Whisper-medium and Qwen2-0.5B widths) have to stream from device
// memory once, at 3.35 TB/s, and at about a microsecond of latency that needs
// megabytes in flight across the card from the first cycle.
//
// Design.
// - The stream kernel (ln_matvec, and the MLP's first product) gives each
//   block one tile of 128 bytes a row (64 bf16 or 32 f32 columns) over a slice
//   of D. The slices of one tile form a thread-block cluster (1-8 blocks,
//   chosen from the SM count so every SM streams). Each warp first issues the
//   loads of its row of x (so they do not queue behind the weights); then one
//   thread issues the whole ring of TMA copies of the slice (2-D tiles of 16
//   rows from a tensor map over the JAX layout, 128-byte swizzled, a 32-row
//   stage to an mbarrier): the weights do not depend on x, so they stream at
//   once. While they fly, one warp a batch row computes the norm statistics
//   over all of D with shuffles and writes x^ for the block's slice to
//   shared memory; one block barrier. The products: bf16 on mma.sync
//   m16n8k16 (the weight tile is the 16-row operand by ldmatrix.trans, x^
//   the 8-column one, f32 sums), f32 on the CUDA cores. The split-K sum stays
//   on chip: each block sends each column's sum to the rank that owns the
//   column by st.async into its shared memory, completing on the owner's
//   mbarrier; the owner adds the ranks' sums in rank order (deterministic),
//   the bias (and, in the MLP, the activation and the gate), rounds and
//   stores. One launch, no partials in device memory, no second kernel, and
//   no cluster-wide barrier at the end.
// - The MLP's second product runs in a second kernel joined to the first by
//   programmatic dependent launch. A cluster of 2 blocks takes 8 rows of W2^T
//   (read along F: TMA boxes of 8 rows x 128 bytes, 512 bytes of each row a
//   stage), each block half of F; both issue their whole ring of W2^T copies
//   first, then wait at griddepcontrol.wait for the first kernel's u (B x F in
//   T, the only buffer between the kernels, brought in by bulk copies), and
//   the row sums meet at their owner as in the stream kernel, which adds b2
//   and the residual. No F/32 x B x D scratch.
// Up to 16 batch rows a launch (two 8-column mma tiles); the host loops over
// groups of 16.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_NB = 16;          // batch rows a launch
constexpr int ROW_BYTES = 128;      // a tile row: 64 bf16 or 32 f32 columns
constexpr int STAGE_ROWS = 32;      // weight rows a stream-kernel ring stage
constexpr int STAGE_BYTES = STAGE_ROWS * ROW_BYTES;  // 4 KB: two TMA boxes of a k-step
constexpr int KSTEP = 16;           // rows an mma k-step and a TMA box; a slice is whole k-steps
constexpr int BOX_BYTES = KSTEP * ROW_BYTES;
constexpr int MAX_CLUSTER = 8;      // blocks a cluster (the portable limit)
constexpr int RING_BYTES = 64 * 1024;   // stream kernel: ring budget a block
constexpr int OUT_ROWS = 8;         // second MLP kernel: rows of W2^T a block
constexpr int OUT_CLUSTER = 2;      // ... blocks a cluster, each a slice of F
constexpr int OUT_STAGE_ROW = 512;  // ... bytes of a row a stage: 4 boxes of 8 x 128 bytes
constexpr int RING2_BYTES = 96 * 1024;  // second MLP kernel: ring budget a block
constexpr int SMEM_OPTIN = 232448;  // shared memory a block may opt into on Hopper
constexpr int NORM_CHUNKS = 4;      // 16-byte chunks of a row a lane loads before the stream

enum Norm { NORM_NONE = 0, NORM_LAYER = 1, NORM_RMS = 2 };
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_SILU = 2, ACT_RELU = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// 16 bytes -> f32 values
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes at p (16-byte aligned) -> f32 values
template <typename T, int V>
__device__ __forceinline__ void load16(const T* p, float (&v)[V]) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ float act_fn(float u, int act) {
  switch (act) {
    case ACT_GELU: return 0.5f * u * (1.0f + erff(u * 0.70710678118654752f));
    case ACT_SILU: return u / (1.0f + expf(-u));
    case ACT_RELU: return fmaxf(u, 0.0f);
    default: return u;
  }
}

__device__ __forceinline__ int ceil_div_dev(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a box of 128-byte
// rows as TMA's 128-byte swizzle lays it out: chunks XOR-ed with row % 8, so
// the 8 rows an ldmatrix (or a warp's same-column loads) reads fall in 8
// different bank groups
__device__ __forceinline__ unsigned swz(int row, int chunk) {
  return row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned at both ends) from src to shared
// dst by the bulk copy engine, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The box of tensor map `map` at (column x, row y) to shared dst (1024-byte
// aligned: the map's 128-byte swizzle is the one swz() computes), completing
// on mbarrier `bar`; rows past the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, int x, int y,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar) : "memory");
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

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&d)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(addr));
}

// c += a (16 x 16, bf16) @ b (16 x 8, bf16), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Split cluster barrier: every block arrives once it has started, and waits
// before its first store into a peer's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared::cluster address of shared address `addr` in block `rank`
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// v into a peer's shared memory (shared::cluster address), completing on the
// peer's mbarrier `bar` (its shared::cluster address) as 4 bytes of its tx count
__device__ __forceinline__ void store_to_peer(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Programmatic dependent launch: let the next kernel in the stream start, and
// (in that kernel) wait until this one has finished and its writes are seen.
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ------------------------------------------------------------ stream kernel

struct StreamArgs {
  const void* x; const float* scale; const float* bias;
  const void* w0; const void* w1;   // W (or W1) and, gated, Wg: rows of ld columns
  const float* b; void* out;        // bias of the N columns; out [nb, N] in T
  int nb, D, N, ks, stages, slots, norm, act; float eps;
};

template <typename T> struct Stream {
  static constexpr int TN = ROW_BYTES / sizeof(T);           // columns a tile
  static constexpr int PARTS = sizeof(T) == 2 ? 2 : WARPS;   // partial sums a block
  static constexpr int XPAD = 16 / sizeof(T);                // x^ row padding
};

// One elected thread: stage i of the slice (its one or two 16-row boxes of
// each of the G tiles) into ring slot `slot`, completing on the slot's
// barrier. A box never reaches past the slice: slices are whole k-steps.
template <int G>
__device__ __forceinline__ void issue_stage(const CUtensorMap* m0, const CUtensorMap* m1,
                                            unsigned ring, unsigned bars, int i, int slot,
                                            int d0, int ks, int n0) {
  const int boxes = ks - i * STAGE_ROWS >= STAGE_ROWS ? 2 : 1;
  const unsigned bar = bars + 8 * slot;
  mbar_expect_tx(bar, boxes * G * BOX_BYTES);
#pragma unroll
  for (int g = 0; g < G; ++g)
    for (int h = 0; h < boxes; ++h)
      tma_load_2d(ring + (slot * G + g) * STAGE_BYTES + h * BOX_BYTES, g == 0 ? m0 : m1, n0,
                  d0 + i * STAGE_ROWS + h * KSTEP, bar);
}

// 16 bytes of T from f32 values, into shared memory
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// x, scale and bias at columns [d0 + k, d0 + k + V) of a row, as f32 (16-byte
// loads where the chunk lies inside the row; scale and bias are 16-byte
// aligned); zeros past D
template <typename T, int V>
__device__ __forceinline__ void load_slice(const StreamArgs& a, const T* xr, int d0, int k,
                                           float (&y)[V], float (&sc)[V], float (&bs)[V]) {
  const int d = d0 + k;
  if (a.D % V == 0 && d + V <= a.D) {
    load16(xr + d, y);
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 s4 =
          a.norm != NORM_NONE ? __ldg(reinterpret_cast<const float4*>(a.scale + d + j)) : zero;
      const float4 b4 =
          a.norm == NORM_LAYER ? __ldg(reinterpret_cast<const float4*>(a.bias + d + j)) : zero;
      sc[j] = s4.x; sc[j + 1] = s4.y; sc[j + 2] = s4.z; sc[j + 3] = s4.w;
      bs[j] = b4.x; bs[j + 1] = b4.y; bs[j + 2] = b4.z; bs[j + 3] = b4.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool in = d + j < a.D;
    y[j] = in ? to_f(xr[d + j]) : 0.f;
    sc[j] = in && a.norm != NORM_NONE ? __ldg(a.scale + d + j) : 0.f;
    bs[j] = in && a.norm == NORM_LAYER ? __ldg(a.bias + d + j) : 0.f;
  }
}

// What a lane loads for the norm of its warp's first row before the weight
// stream starts (so these loads do not queue behind it): the row's first
// NORM_CHUNKS x 32 16-byte chunks for the statistics, and its first 16 bytes
// of the slice with their scale and bias.
template <typename T> struct NormLoads {
  static constexpr int V = Vec<T>::N;
  uint4 raw[NORM_CHUNKS];
  float y[V], sc[V], bs[V];
};

template <typename T>
__device__ __forceinline__ void norm_prefetch(const StreamArgs& a, int d0, NormLoads<T>& p) {
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= a.nb) return;
  const T* xr = static_cast<const T*>(a.x) + (size_t)warp * a.D;
  const int nv = a.D % V == 0 ? a.D / V : 0;
#pragma unroll
  for (int c = 0; c < NORM_CHUNKS; ++c)
    if (lane + 32 * c < nv) p.raw[c] = __ldg(reinterpret_cast<const uint4*>(xr) + lane + 32 * c);
  if (lane * V < a.ks) load_slice(a, xr, d0, lane * V, p.y, p.sc, p.bs);
}

// x^ rows [0, nbp) over the slice [d0, d0 + ks) of x [nb, D] into xh (row
// stride xs), rounded to T; rows >= nb and columns past D are zero. One warp a
// row: statistics over all of D by shuffles; a warp's first row starts from
// what norm_prefetch loaded. Then each lane normalises 16 bytes of the slice
// at a time. (Statistics merged across the cluster instead, from each rank's
// slice, cost an extra cluster barrier: slower on the card.)
template <typename T>
__device__ __forceinline__ void normed_slice(const StreamArgs& a, int nbp, int d0, int xs, T* xh,
                                             const NormLoads<T>& pf) {
  constexpr int V = Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = a.D;
  const int nv = D % V == 0 ? D / V : 0;   // 16-byte loads when rows stay aligned
  for (int bi = warp; bi < nbp; bi += WARPS) {
    T* row = xh + (size_t)bi * xs;
    if (bi >= a.nb) {
      for (int k = lane * V; k < a.ks; k += 32 * V) {
        const float z[V] = {};
        store16(row + k, z);
      }
      continue;
    }
    const bool first = bi == warp;
    const T* __restrict__ xr = static_cast<const T*>(a.x) + (size_t)bi * D;
    // f(v) for each value of the row this lane sums: the prefetched chunks
    // from registers (first row; indices known at compile time), the rest
    // from L2, 16 bytes at a time, four loads in flight
    auto over_row = [&](auto&& f) {
      int c0 = 0;
      if (first) {
#pragma unroll
        for (int c = 0; c < NORM_CHUNKS; ++c)
          if (lane + 32 * c < nv) {
            float v[V];
            unpack16(pf.raw[c], v);
#pragma unroll
            for (int j = 0; j < V; ++j) f(v[j]);
          }
        c0 = NORM_CHUNKS;
      }
#pragma unroll 4
      for (int c = c0; lane + 32 * c < nv; ++c) {
        float v[V];
        load16(xr + (lane + 32 * c) * V, v);
#pragma unroll
        for (int j = 0; j < V; ++j) f(v[j]);
      }
      for (int d = nv * V + lane; d < D; d += 32) f(to_f(xr[d]));
    };
    float mean = 0.f, inv = 1.f;
    if (a.norm != NORM_NONE) {
      if (a.norm == NORM_LAYER) {
        float s = 0.f;
        over_row([&](float v) { s += v; });
        mean = warp_sum(s) / D;
      }
      float q = 0.f;
      over_row([&](float v) { q += (v - mean) * (v - mean); });
      inv = 1.0f / sqrtf(warp_sum(q) / D + a.eps);
    }
    for (int k = lane * V; k < a.ks; k += 32 * V) {
      float y[V], sc[V], bs[V];
      if (first && k == lane * V) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          y[j] = pf.y[j];
          sc[j] = pf.sc[j];
          bs[j] = pf.bs[j];
        }
      } else {
        load_slice(a, xr, d0, k, y, sc, bs);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (a.norm == NORM_LAYER) y[j] = (y[j] - mean) * inv * sc[j] + bs[j];
        else if (a.norm == NORM_RMS) y[j] = y[j] * inv * sc[j];
        if (d0 + k + j >= D) y[j] = 0.f;
      }
      store16(row + k, y);
    }
  }
}

// The split-K sum across the cluster. Rank r owns columns [r TN/c, (r+1)
// TN/c) of the tile. Each block adds its own partials (wpart
// [G][PARTS][nbp][TN]) and sends each column's sum to its owner's recv
// [c][G][nbp][TN/c] by st.async, which completes on the owner's mbarrier
// `rbar` (armed at the start for the bytes its peers send); each owner waits
// for its own sums only, adds them in rank order (deterministic), then the
// bias, the activation and, gated, the gate, rounds to T and stores. No
// cluster-wide barrier at the end: a block leaves once its own columns are
// stored, and no block sends to a block that is not waiting for it.
template <typename T, int G>
__device__ void cluster_reduce(const StreamArgs& a, float* wpart, float* recv, unsigned rbar,
                               int nbp, int n0) {
  using S = Stream<T>;
  cg::cluster_group cl = cg::this_cluster();
  const int c = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  const int cpr = S::TN / c;
  __syncthreads();
  cluster_wait();   // every peer has started and armed its rbar
  for (int i = threadIdx.x; i < G * a.nb * S::TN; i += THREADS) {
    const int col = i % S::TN, n = (i / S::TN) % a.nb, g = i / (S::TN * a.nb);
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < S::PARTS; ++p) s += wpart[((g * S::PARTS + p) * nbp + n) * S::TN + col];
    const int owner = col / cpr;
    float* dst = recv + ((rank * G + g) * nbp + n) * cpr + col % cpr;
    if (owner == rank) *dst = s;
    else store_to_peer(peer_addr(smem_u32(dst), owner), s, peer_addr(rbar, owner));
  }
  mbar_wait(rbar, 0);   // the peers' sums have landed
  __syncthreads();      // ... and this block's own
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < a.nb * cpr; i += THREADS) {
    const int n = i / cpr, cl_col = i % cpr, col = rank * cpr + cl_col;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < c) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += recv[((q * G + g) * nbp + n) * cpr + cl_col];
      }
    const float h = s[0] + a.b[n0 + col];
    const float v = G == 2 ? act_fn(s[G - 1], a.act) * h : act_fn(h, a.act);
    out[(size_t)n * a.N + n0 + col] = from_f<T>(v);
  }
}

// bf16: warp w owns the 16-column m-tile w % 4 of the tile and the k-step
// w / 4 of each 32-row stage; acc[g][nt] its sums for the 8 batch columns of
// n-tile nt.
template <int G, int NT>
__device__ __forceinline__ void stage_products(const __nv_bfloat16* xh, int xs, unsigned stage,
                                               int i, int ks, float (&acc)[G][NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp & 3, kk = warp >> 2;
  const int k0 = i * STAGE_ROWS + kk * KSTEP;
  if (k0 >= ks) return;
  unsigned bf[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat16* xr = xh + (size_t)(nt * 8 + lane / 4) * xs + k0 + 2 * (lane % 4);
    bf[nt][0] = *reinterpret_cast<const unsigned*>(xr);
    bf[nt][1] = *reinterpret_cast<const unsigned*>(xr + 8);
  }
  const int row = kk * KSTEP + ((lane >> 4) & 1) * 8 + (lane & 7);
  const int chunk = mt * 2 + ((lane >> 3) & 1);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unsigned af[4];
    ldsm_x4_t(stage + g * STAGE_BYTES + swz(row, chunk), af);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[g][nt], af, bf[nt][0], bf[nt][1]);
  }
}

// f32: thread t takes row t / 8 of each stage and its 4 columns (t % 8).
template <int G, int NT>
__device__ __forceinline__ void stage_products(const float* xh, int xs, unsigned stage, int i,
                                               int ks, float (&acc)[G][NT * 8][4]) {
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  const int k = i * STAGE_ROWS + r;
  if (k >= ks) return;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float4 w;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(w.x), "=f"(w.y), "=f"(w.z), "=f"(w.w)
                 : "r"(stage + g * STAGE_BYTES + swz(r, c)));
#pragma unroll
    for (int b = 0; b < NT * 8; ++b) {
      const float xv = xh[(size_t)b * xs + k];
      acc[g][b][0] = fmaf(xv, w.x, acc[g][b][0]);
      acc[g][b][1] = fmaf(xv, w.y, acc[g][b][1]);
      acc[g][b][2] = fmaf(xv, w.z, acc[g][b][2]);
      acc[g][b][3] = fmaf(xv, w.w, acc[g][b][3]);
    }
  }
}

// A warp's sums into wpart [G][PARTS][nbp][TN].
template <int G, int NT>
__device__ __forceinline__ void store_partials(float* wpart, const float (&acc)[G][NT][4]) {
  constexpr int TN = Stream<__nv_bfloat16>::TN, PARTS = Stream<__nv_bfloat16>::PARTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = warp & 3, kk = warp >> 2;
  const int col = mt * 16 + lane / 4;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * (lane % 4);
      float* p = wpart + ((size_t)(g * PARTS + kk) * NT * 8) * TN;
      p[n * TN + col] = acc[g][nt][0];
      p[(n + 1) * TN + col] = acc[g][nt][1];
      p[n * TN + col + 8] = acc[g][nt][2];
      p[(n + 1) * TN + col + 8] = acc[g][nt][3];
    }
}

template <int G, int NT>
__device__ __forceinline__ void store_partials(float* wpart, float (&acc)[G][NT * 8][4]) {
  constexpr int TN = Stream<float>::TN, PARTS = Stream<float>::PARTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int b = 0; b < NT * 8; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float s = acc[g][b][v];
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        acc[g][b][v] = s;
      }
  if (lane < 8) {
    float* p = wpart + ((size_t)(0 * PARTS + warp) * NT * 8) * TN;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int b = 0; b < NT * 8; ++b)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          p[((size_t)g * PARTS * NT * 8 + b) * TN + lane * 4 + v] = acc[g][b][v];
  }
}

template <typename T, int G, int NT> struct Acc;
template <int G, int NT> struct Acc<__nv_bfloat16, G, NT> { float v[G][NT][4]; };
template <int G, int NT> struct Acc<float, G, NT> { float v[G][NT * 8][4]; };

// One tile of 128-byte rows over one slice of D a block; the slices of a tile
// are one cluster along gridDim.x. Shared memory: the ring (slots x G x 4 KB),
// x^ [nbp][ks + XPAD] in T, the partials [G][PARTS][nbp][TN] f32, the sums the
// cluster sends this block [G][nbp][TN] f32, one mbarrier a slot and one for
// the cluster's sums.
template <typename T, int G, int NT>
__global__ void __launch_bounds__(THREADS, 2)
    ln_stream_kernel(StreamArgs a, const __grid_constant__ CUtensorMap m0,
                     const __grid_constant__ CUtensorMap m1) {
  using S = Stream<T>;
  constexpr int NBP = NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int xs = a.ks + S::XPAD;
  T* xh = reinterpret_cast<T*>(smem + (size_t)a.slots * G * STAGE_BYTES);
  float* wpart = reinterpret_cast<float*>(xh + (size_t)NBP * xs);
  float* recv = wpart + (size_t)G * S::PARTS * NBP * S::TN;
  uint64_t* bar = reinterpret_cast<uint64_t*>(recv + (size_t)G * NBP * S::TN);
  const unsigned ring = smem_u32(smem), bars = smem_u32(bar);

  const int rank = blockIdx.x, n0 = blockIdx.y * S::TN;
  const int d0 = rank * a.ks;
  NormLoads<T> pf;
  norm_prefetch<T>(a, d0, pf);   // ahead of the weight stream in the memory queues
  const unsigned rbar = bars + 8 * a.slots;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= a.slots; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the bytes of column sums the other ranks send this block
    mbar_expect_tx(rbar, (gridDim.x - 1) * G * a.nb * (S::TN / gridDim.x) * 4);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < a.slots; ++s) issue_stage<G>(&m0, &m1, ring, bars, s, s, d0, a.ks, n0);
  griddep_launch();
  cluster_arrive_relaxed();
  normed_slice<T>(a, NBP, d0, xs, xh, pf);
  __syncthreads();

  Acc<T, G, NT> acc = {};
  for (int i = 0; i < a.stages; ++i) {
    const int slot = i % a.slots;
    mbar_wait(bars + 8 * slot, (i / a.slots) & 1);
    stage_products<G, NT>(xh, xs, ring + slot * G * STAGE_BYTES, i, a.ks, acc.v);
    if (i + a.slots < a.stages) {
      __syncthreads();
      if (threadIdx.x == 0)
        issue_stage<G>(&m0, &m1, ring, bars, i + a.slots, slot, d0, a.ks, n0);
    }
  }
  store_partials<G, NT>(wpart, acc.v);
  cluster_reduce<T, G>(a, wpart, recv, rbar, NBP, n0);
}

// --------------------------------------------------- second MLP kernel (W2)

struct OutArgs {
  const void* u;       // [nb, F] in T, from the stream kernel
  const void* w2;      // W2^T [D, F] in T
  const float* b2; const void* resid;   // resid: x [nb, D] or null
  void* out; int nb, D, F, fs, stages, slots;   // fs: columns of F a rank
};

// One elected thread: stage i of the block's slice of its 8 rows of W2^T
// (512 bytes of each row from column f0 + i FS: the 8 x 128-byte TMA boxes
// that overlap the slice) into ring slot `slot`, completing on the slot's
// barrier; rows past D arrive as zeros.
template <typename T>
__device__ __forceinline__ void issue_out_stage(const CUtensorMap* m2, unsigned ring,
                                                unsigned bars, int i, int slot, int d0, int f0,
                                                int width) {
  constexpr int FS = OUT_STAGE_ROW / sizeof(T), BOX = ROW_BYTES / sizeof(T);
  const int boxes = max(0, min(OUT_STAGE_ROW / ROW_BYTES, ceil_div_dev(width - i * FS, BOX)));
  const unsigned bar = bars + 8 * slot;
  mbar_expect_tx(bar, boxes * OUT_ROWS * ROW_BYTES);
  for (int h = 0; h < boxes; ++h)
    tma_load_2d(ring + slot * OUT_ROWS * OUT_STAGE_ROW + h * OUT_ROWS * ROW_BYTES, m2,
                f0 + i * FS + h * BOX, d0, bar);
}

// bf16: out^T is u (16 batch rows, the m16 operand, the rank's slice staged in
// shared memory as us [nbp][fs + 8]) times W2^T's 8 rows (the n8 operand,
// ldmatrix from the stage's swizzled boxes); warp w takes k-steps w and w + 8
// of each 256-column stage.
template <int NT>
__device__ __forceinline__ void out_products(const OutArgs& a, const __nv_bfloat16* us,
                                             unsigned stage, int i, int width, float (&acc)[4]) {
  constexpr int FS = OUT_STAGE_ROW / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ustride = a.fs + 8;
  unsigned bf[4];
  {
    const int j = lane >> 3;   // matrix j: k-step warp + 8 (j / 2), k half j % 2
    const int col = (warp + 8 * (j >> 1)) * KSTEP + (j & 1) * 8;   // of the stage's 256
    ldsm_x4(stage + (col / 64) * OUT_ROWS * ROW_BYTES + swz(lane & 7, col % 64 / 8), bf);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = i * FS + (warp + 8 * h) * KSTEP + 2 * (lane % 4);
    if (f >= width) continue;
    const __nv_bfloat16* ur = us + (size_t)(lane / 4) * ustride + f;
    unsigned af[4] = {0u, 0u, 0u, 0u};
    af[0] = *reinterpret_cast<const unsigned*>(ur);
    af[2] = *reinterpret_cast<const unsigned*>(ur + 8);
    if (NT > 1) {
      af[1] = *reinterpret_cast<const unsigned*>(ur + 8 * ustride);
      af[3] = *reinterpret_cast<const unsigned*>(ur + 8 * ustride + 8);
    }
    mma_bf16(acc, af, bf[2 * h], bf[2 * h + 1]);
  }
}

// 8 rows of W2^T a cluster of OUT_CLUSTER blocks, each a slice of F (fs
// columns): each block's sums for the 8 rows go to their owner (rank r owns
// rows [r 8/c, (r+1) 8/c)) by st.async, as in the stream kernel; the owner
// adds the ranks' sums in rank order, b2 and the residual. Shared memory: the
// ring, the warps' partials [WARPS][16][8] f32 (bf16), the block's sums
// [nbp][8] f32, the sums sent to it [c][nbp][8/c] f32, u's slice [nbp][fs +
// 8] (bf16; f32 reads u from device memory), barriers (a ring slot's, u's,
// the cluster's sums'), after 1 KB of slack that aligns the swizzled ring.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
    ln_out_kernel(OutArgs a, const __grid_constant__ CUtensorMap m2) {
  constexpr int NBP = NT * 8;
  constexpr int FS = OUT_STAGE_ROW / sizeof(T);
  constexpr int STAGE2 = OUT_ROWS * OUT_STAGE_ROW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cl = cg::this_cluster();
  const int c = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  const int rpr = OUT_ROWS / c;   // rows a rank owns
  float* wpart = reinterpret_cast<float*>(smem + (size_t)a.slots * STAGE2);
  float* sums = wpart + (sizeof(T) == 2 ? WARPS * 16 * OUT_ROWS : 0);   // [nbp][8]
  float* recv = sums + NBP * OUT_ROWS;                                  // [c][nbp][rpr]
  T* us = reinterpret_cast<T*>(recv + NBP * OUT_ROWS);
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(us) + (sizeof(T) == 2 ? NBP * (a.fs * 2 + 16) : 0));
  const unsigned ring = smem_u32(smem), bars = smem_u32(bar);
  const unsigned ubar = bars + 8 * a.slots, rbar = ubar + 8;
  const int d0 = blockIdx.y * OUT_ROWS;
  const int f0 = rank * a.fs, f1 = min(a.F, f0 + a.fs), width = max(0, f1 - f0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s <= a.slots + 1; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(rbar, (c - 1) * a.nb * rpr * 4);   // the sums the other ranks send
    for (int s = 0; s < a.slots; ++s) issue_out_stage<T>(&m2, ring, bars, s, s, d0, f0, width);
  }
  __syncthreads();
  cluster_arrive_relaxed();
  griddep_wait();   // u comes from the stream kernel before this one

  if constexpr (sizeof(T) == 2) {
    if (threadIdx.x == 0) {   // u's slice, a bulk copy a row
      mbar_expect_tx(ubar, a.nb * width * 2);
      for (int b = 0; b < a.nb && width > 0; ++b)
        bulk_copy(smem_u32(us + (size_t)b * (a.fs + 8)),
                  static_cast<const T*>(a.u) + (size_t)b * a.F + f0, width * 2, ubar);
    }
    mbar_wait(ubar, 0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < a.stages; ++i) {
      const int slot = i % a.slots;
      mbar_wait(bars + 8 * slot, (i / a.slots) & 1);
      out_products<NT>(a, us, ring + slot * STAGE2, i, width, acc);
      if (i + a.slots < a.stages) {
        __syncthreads();
        if (threadIdx.x == 0)
          issue_out_stage<T>(&m2, ring, bars, i + a.slots, slot, d0, f0, width);
      }
    }
    // acc: rows b = lane / 4 (+ 8) of u, columns d = 2 (lane % 4) (+ 1)
    float* p = wpart + (size_t)warp * 16 * OUT_ROWS;
    const int b = lane / 4, d = 2 * (lane % 4);
    p[b * OUT_ROWS + d] = acc[0];
    p[b * OUT_ROWS + d + 1] = acc[1];
    p[(b + 8) * OUT_ROWS + d] = acc[2];
    p[(b + 8) * OUT_ROWS + d + 1] = acc[3];
    __syncthreads();
    for (int i = threadIdx.x; i < a.nb * OUT_ROWS; i += THREADS) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += wpart[w * 16 * OUT_ROWS + i];
      sums[i] = s;
    }
  } else {
    // f32: warp w takes row w of the block, lane l the 4 columns l of each stage
    const float* u = static_cast<const float*>(a.u);
    float acc[NBP];
#pragma unroll
    for (int b = 0; b < NBP; ++b) acc[b] = 0.f;
    for (int i = 0; i < a.stages; ++i) {
      const int slot = i % a.slots;
      mbar_wait(bars + 8 * slot, (i / a.slots) & 1);
      const int f = f0 + i * FS + lane * 4;
      if (f < f1) {
        float4 w;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(w.x), "=f"(w.y), "=f"(w.z), "=f"(w.w)
                     : "r"(ring + slot * STAGE2 + lane / 8 * OUT_ROWS * ROW_BYTES +
                           swz(warp, lane % 8)));
#pragma unroll
        for (int b = 0; b < NBP; ++b) {
          if (b < a.nb) {
            const float4 uv = __ldcg(reinterpret_cast<const float4*>(u + (size_t)b * a.F + f));
            acc[b] = fmaf(uv.x, w.x, fmaf(uv.y, w.y, fmaf(uv.z, w.z, fmaf(uv.w, w.w, acc[b]))));
          }
        }
      }
      if (i + a.slots < a.stages) {
        __syncthreads();
        if (threadIdx.x == 0)
          issue_out_stage<T>(&m2, ring, bars, i + a.slots, slot, d0, f0, width);
      }
    }
#pragma unroll
    for (int b = 0; b < NBP; ++b) {
      const float s = warp_sum(acc[b]);
      if (lane == 0 && b < a.nb) sums[b * OUT_ROWS + warp] = s;
    }
  }
  // the block's sums to their owners; then the owner's rows
  __syncthreads();
  cluster_wait();   // every peer has started and armed its rbar
  for (int i = threadIdx.x; i < a.nb * OUT_ROWS; i += THREADS) {
    const int b = i / OUT_ROWS, r = i % OUT_ROWS, owner = r / rpr;
    float* dst = recv + (rank * NBP + b) * rpr + r % rpr;
    if (owner == rank) *dst = sums[i];
    else store_to_peer(peer_addr(smem_u32(dst), owner), sums[i], peer_addr(rbar, owner));
  }
  mbar_wait(rbar, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < a.nb * rpr; i += THREADS) {
    const int b = i / rpr, r = i % rpr, dd = d0 + rank * rpr + r;
    if (dd >= a.D) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < OUT_CLUSTER; ++q)
      if (q < c) s += recv[(q * NBP + b) * rpr + r];
    s += a.b2[dd];
    if (a.resid != nullptr) s += to_f(static_cast<const T*>(a.resid)[(size_t)b * a.D + dd]);
    static_cast<T*>(a.out)[(size_t)b * a.D + dd] = from_f<T>(s);
  }
}

// ---------------------------------------------------------------------- host

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

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The work split of the stream kernel for nb batch rows (up to 16), g weight
// tiles a block (2 when gated), es bytes an element: the smallest cluster of
// 1, 2, 4 or 8 slices of D that gives every SM a block and whose ring holds
// the whole slice (or 8); slices of whole k-steps. Shared memory: 1 KB of
// alignment slack for the ring, the ring, x^, the partials, the cluster's
// sums, barriers (a ring slot's, and one for the cluster's sums).
struct Plan { int cluster, ks, stages, slots, smem; };

Plan stream_plan(int D, int N, int nb, int g, int es, int sms) {
  const int tn = ROW_BYTES / es, tiles = N / tn, nbp = nb > 8 ? 16 : 8;
  const int parts = es == 2 ? 2 : WARPS;
  const int max_slots = RING_BYTES / (g * STAGE_BYTES);
  Plan p{};
  for (p.cluster = 1;; p.cluster *= 2) {
    p.ks = ceil_div(ceil_div(D, p.cluster), KSTEP) * KSTEP;
    p.stages = ceil_div(p.ks, STAGE_ROWS);
    if (p.cluster == MAX_CLUSTER || (tiles * p.cluster >= sms && p.stages <= max_slots)) break;
  }
  p.slots = p.stages < max_slots ? p.stages : max_slots;
  p.smem = 1024 + p.slots * g * STAGE_BYTES + nbp * (p.ks * es + 16) +
           g * (parts + 1) * nbp * tn * 4 + (p.slots + 1) * 8;
  return p;
}

// The second MLP kernel: clusters of OUT_CLUSTER blocks over 8 rows of W2^T,
// each block a slice of F (whole 128-column groups) in stages of 512 bytes a
// row; bf16 keeps the slice of u [nbp][fs + 8] and the warps' partials beside
// the ring, which takes what is left of the block's shared memory up to its
// budget.
Plan out_plan(int F, int nb, int es) {
  const int stage = OUT_ROWS * OUT_STAGE_ROW, nbp = nb > 8 ? 16 : 8;
  const int fs = ceil_div(F, OUT_CLUSTER * 128) * 128;
  const int fixed = 1024 + 2 * nbp * OUT_ROWS * 4 +
                    (es == 2 ? WARPS * 16 * OUT_ROWS * 4 + nbp * (fs * es + 16) : 0) + 16;
  const int room = SMEM_OPTIN - fixed < RING2_BYTES ? SMEM_OPTIN - fixed : RING2_BYTES;
  const int max_slots = room / (stage + 8) > 1 ? room / (stage + 8) : 1;
  Plan p{};
  p.cluster = OUT_CLUSTER;
  p.ks = fs;
  p.stages = ceil_div(fs * es, OUT_STAGE_ROW);
  p.slots = p.stages < max_slots ? p.stages : max_slots;
  p.smem = p.slots * (stage + 8) + fixed;
  return p;
}

// cuTensorMapEncodeTiled from the driver, found once through the runtime (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A map of `rows` rows of `cols` elements (row pitch `cols`) at w, in boxes of
// `box_rows` 128-byte rows, swizzled by 128 bytes; rows and columns past the
// tensor read as zeros.
int weight_map(CUtensorMap* map, const void* w, int rows, int cols, int es, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(cols) * es};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(ROW_BYTES / es),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<void*>(w), dims, pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int G, int NT>
int stream_launch(StreamArgs a, int sms, cudaStream_t st) {
  const Plan p = stream_plan(a.D, a.N, a.nb, G, sizeof(T), sms);
  CUtensorMap m0, m1;
  int e = weight_map(&m0, a.w0, a.D, a.N, sizeof(T), KSTEP);
  if (!e) e = weight_map(&m1, a.w1, a.D, a.N, sizeof(T), KSTEP);
  if (e) return e;
  a.ks = p.ks;
  a.stages = p.stages;
  a.slots = p.slots;
  e = allow_smem<ln_stream_kernel<T, G, NT>>();
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, a.N / Stream<T>::TN, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = static_cast<int>(cudaLaunchKernelEx(&cfg, ln_stream_kernel<T, G, NT>, a, m0, m1));
  return e ? e : static_cast<int>(cudaGetLastError());
}

template <typename T, int NT>
int out_launch(OutArgs a, cudaStream_t st) {
  const Plan p = out_plan(a.F, a.nb, sizeof(T));
  a.fs = p.ks;
  a.stages = p.stages;
  a.slots = p.slots;
  CUtensorMap m2;
  int e = weight_map(&m2, a.w2, a.D, a.F, sizeof(T), OUT_ROWS);
  if (e) return e;
  e = allow_smem<ln_out_kernel<T, NT>>();
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, ceil_div(a.D, OUT_ROWS), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = p.cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = static_cast<int>(cudaLaunchKernelEx(&cfg, ln_out_kernel<T, NT>, a, m2));
  return e ? e : static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int stream_all(StreamArgs a, int ldx, cudaStream_t st) {
  const int sms = sm_count();
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int B = a.nb;
  for (int b0 = 0; b0 < B; b0 += MAX_NB) {
    StreamArgs g = a;
    g.nb = B - b0 < MAX_NB ? B - b0 : MAX_NB;
    g.x = x + (size_t)b0 * ldx;
    g.out = out + (size_t)b0 * a.N;
    const int e =
        g.nb > 8 ? stream_launch<T, G, 2>(g, sms, st) : stream_launch<T, G, 1>(g, sms, st);
    if (e) return e;
  }
  return 0;
}

template <typename T, int G>
int mlp_all(StreamArgs a, OutArgs o, cudaStream_t st) {
  const int sms = sm_count();
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(o.out);
  const int B = a.nb, D = a.D;
  for (int b0 = 0; b0 < B; b0 += MAX_NB) {
    StreamArgs g = a;
    OutArgs h = o;
    g.nb = h.nb = B - b0 < MAX_NB ? B - b0 : MAX_NB;
    g.x = x + (size_t)b0 * D;
    if (o.resid != nullptr) h.resid = x + (size_t)b0 * D;
    h.out = out + (size_t)b0 * D;
    int e = g.nb > 8 ? stream_launch<T, G, 2>(g, sms, st) : stream_launch<T, G, 1>(g, sms, st);
    if (e) return e;
    e = g.nb > 8 ? out_launch<T, 2>(h, st) : out_launch<T, 1>(h, st);
    if (e) return e;
  }
  return 0;
}

void put_plan(const Plan& p, int* out) {
  out[0] = p.cluster;
  out[1] = p.ks;
  out[2] = p.stages;
  out[3] = p.slots;
  out[4] = p.smem;
}

}  // namespace

// The work split a call of B rows takes (its first group of up to 16): out
// {cluster, ks, stages, slots, shared bytes} of the stream kernel, and for
// ln_mlp then {-, rows, stages, slots, shared bytes} of the second kernel.
// sms 0: this card's SM count.
extern "C" void est_ln_matvec_plan(int D, int N, int B, int bf16, int sms, int* out) {
  const int nb = B < MAX_NB ? B : MAX_NB;
  put_plan(stream_plan(D, N, nb, 1, bf16 ? 2 : 4, sms > 0 ? sms : sm_count()), out);
}

extern "C" void est_ln_mlp_plan(int D, int F, int B, int gated, int bf16, int sms, int* out) {
  const int nb = B < MAX_NB ? B : MAX_NB, es = bf16 ? 2 : 4;
  put_plan(stream_plan(D, F, nb, gated ? 2 : 1, es, sms > 0 ? sms : sm_count()), out);
  put_plan(out_plan(F, nb, es), out + 5);
}

// x [B, D], w [D, N], out [B, N] in T (bf16 if bf16 else f32), contiguous,
// 16-byte aligned, N % 128 == 0; scale, bias [D] and b [N] f32. norm: 0 none,
// 1 layer, 2 rms. One launch for each 16 rows. Returns the first CUDA error.
extern "C" int est_ln_matvec(const void* x, const void* scale, const void* bias, const void* w,
                             const void* b, void* out, int B, int D, int N, int norm, float eps,
                             int bf16, void* stream) {
  StreamArgs a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), w, w,
               static_cast<const float*>(b), out, B, D, N, 0, 0, 0, norm, ACT_NONE, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? stream_all<__nv_bfloat16, 1>(a, D, st) : stream_all<float, 1>(a, D, st);
}

// x [B, D] and out [B, D] in T; w: pack_mlp rows [w1; w2^T (; w_gate)] of
// [D, F] each, F % 128 == 0; scale, bias, b2 [D] and b1 [F] f32; u: min(B, 16)
// x F of T, the hidden rows between the two kernels. act: 0 none, 1 gelu,
// 2 silu, 3 relu. Two launches for each 16 rows.
extern "C" int est_ln_mlp(const void* x, const void* scale, const void* bias, const void* w,
                          const void* b1, const void* b2, void* out, void* u, int B, int D, int F,
                          int norm, float eps, int act, int gated, int residual, int bf16,
                          void* stream) {
  const int es = bf16 ? 2 : 4;
  const char* wb = static_cast<const char*>(w);
  StreamArgs a{x, static_cast<const float*>(scale), static_cast<const float*>(bias), w,
               gated ? wb + (size_t)2 * D * F * es : w, static_cast<const float*>(b1), u, B, D,
               F, 0, 0, 0, norm, act, eps};
  OutArgs o{u, wb + (size_t)D * F * es, static_cast<const float*>(b2), residual ? x : nullptr,
            out, B, D, F, 0, 0, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return gated ? mlp_all<__nv_bfloat16, 2>(a, o, st) : mlp_all<__nv_bfloat16, 1>(a, o, st);
  }
  return gated ? mlp_all<float, 2>(a, o, st) : mlp_all<float, 1>(a, o, st);
}

// Whisper log-mel frames for one waveform, hand-written for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_mel.py,
//           whisper_log_mel_pallas (Pallas kernel `_kernel`).
//
// Computes, for frame f of the reflect-padded waveform (pad 200, hop 160,
// n_fft 400) with x_f[n] = hann[n] * signal[160 f + n - 200]:
//   X_f[k]    = sum_n x_f[n] exp(-2 pi i n k / 400),   k = 0 .. 200
//   out[f][m] = log10(max(sum_{k in band m} |X_f[k]|^2 fb[k][m], 1e-10))
// The global (max - 8) floor, the affine (x + 4) / 4 and the transpose need
// the whole spectrogram and stay outside, as they do in the JAX package.
//
// Design: a real FFT per frame, IEEE FP32 throughout (the JAX kernel runs at
// HIGHEST precision, and spectra span about 8 decades into a log10).
// - One warp owns one frame and works alone: no block-wide barrier, only
//   __syncwarp between passes. It folds the frame's 400 windowed samples into
//   200 complex points z[m] = x[2m] + i x[2m+1] (the half-length trick), takes
//   their 200-point FFT in three Stockham passes of radix 8, 5 and 5
//   (200 = 8 * 5 * 5; 25, 40 and 40 butterflies over the warp's 32 lanes,
//   ping-ponging between two 200-point buffers in shared memory), and splits
//   Z into the real frame's spectrum:
//     X[k] = E[k] + W^k O[k],  E = (Z[k] + conj Z[200-k]) / 2,
//                              O = -i (Z[k] - conj Z[200-k]) / 2,
//   W = exp(-2 pi i / 400). The first pass reads its samples straight from
//   device memory, applying the zero pad to chunk_samples, the reflect pad and
//   the window on the load, so no padded or framed copy is ever written.
// - Every constant of the transform (the passes' twiddles, the radix-5 and
//   radix-8 butterflies' constants and the split's W^k) is read from one
//   table of W^j, j = 0 .. 399, which the caller computes in float64 and
//   rounds to f32. Nothing is computed with __sinf.
// - Each mel filter is summed over its own nonzero band [lo_m, hi_m) of the
//   slaney filterbank, in ascending k, from a compact table of the
//   filterbank's nonzeros (each bin feeds at most two filters: ~390 products a
//   frame at 80 or 128 mels, against 201 * n_mels for the dense projection).
// - Occupancy: a block is FRAMES_PER_BLOCK = 2 warps (2 frames), so a 10 s
//   window (1000 frames) launches 500 blocks, 3.8 an SM on the H100's 132,
//   and a 30 s window 1500 blocks; 4 KB of shared memory a warp.
// - Latency: a lane's rounds of a pass (2 in the radix-5 passes, 7 in the
//   split, up to MAX_MELS / 32 in the mel sums) and a band's bins, 8 at a
//   time, are unrolled so that their loads issue together.
//
// What bounds it on the H100: about 14 kFLOP a frame (42 MFLOP at 30 s, 0.6
// us at the 67 TFLOP/s FP32 peak) against the samples read once and the
// frames written once (2.9 MB at 30 s, 0.86 us at 3.35 TB/s): bytes, on
// paper. In practice each warp's chain of dependent shared-memory passes
// (latency) and the launch itself set the time; the design keeps every frame
// independent so all warps of a window are resident at once.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_BINS = N_FFT / 2 + 1;  // 201
constexpr int PAD = N_FFT / 2;         // reflect pad per side
constexpr int M = N_FFT / 2;           // complex FFT length: 200 = 8 * 5 * 5
constexpr int FRAMES_PER_BLOCK = 2;    // one warp a frame
constexpr int THREADS = 32 * FRAMES_PER_BLOCK;
constexpr int MAX_MELS = 128;          // the wrapper refuses more

__device__ __forceinline__ int reflect_index(int j, int n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * (n - 1) - j;
  return j;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// In-place 4-point DFT (forward, W = -i).
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2);
  const float2 t2 = cadd(a1, a3), t3 = mul_neg_i(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// In-place 8-point DFT: two 4-point DFTs of the even and odd inputs, then
// W8^k = exp(-2 pi i k / 8) on the odd half. r = 1/sqrt(2) from the table.
__device__ __forceinline__ void dft8(float2 v[8], float r) {
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  const float2 o1 = make_float2(r * (v[3].x + v[3].y), r * (v[3].y - v[3].x));   // * W8^1
  const float2 o2 = mul_neg_i(v[5]);                                               // * W8^2
  const float2 o3 = make_float2(r * (v[7].y - v[7].x), -r * (v[7].x + v[7].y));  // * W8^3
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
  v[0] = cadd(e0, v[1]);
  v[4] = csub(e0, v[1]);
  v[1] = cadd(e1, o1);
  v[5] = csub(e1, o1);
  v[2] = cadd(e2, o2);
  v[6] = csub(e2, o2);
  v[3] = cadd(e3, o3);
  v[7] = csub(e3, o3);
}

// In-place 5-point DFT; c1, s1 = cos, sin(2 pi / 5), c2, s2 = cos, sin(4 pi / 5).
__device__ __forceinline__ void dft5(float2 v[5], float c1, float s1, float c2, float s2) {
  const float2 t1 = cadd(v[1], v[4]), t2 = cadd(v[2], v[3]);
  const float2 d1 = csub(v[1], v[4]), d2 = csub(v[2], v[3]);
  const float2 a1 = make_float2(v[0].x + c1 * t1.x + c2 * t2.x, v[0].y + c1 * t1.y + c2 * t2.y);
  const float2 a2 = make_float2(v[0].x + c2 * t1.x + c1 * t2.x, v[0].y + c2 * t1.y + c1 * t2.y);
  // b1 = -i (s1 d1 + s2 d2), b2 = -i (s2 d1 - s1 d2)
  const float2 b1 = mul_neg_i(make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y));
  const float2 b2 = mul_neg_i(make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y));
  v[0] = cadd(v[0], cadd(t1, t2));
  v[1] = cadd(a1, b1);
  v[4] = csub(a1, b1);
  v[2] = cadd(a2, b2);
  v[3] = csub(a2, b2);
}

// One radix-5 Stockham pass over M points after passes of total radix ns:
// butterfly j takes in[j + 40 r] * W200^((j % ns) r (M / (5 ns))) and writes
// out[(j / ns) 5 ns + j % ns + r ns].
template <int NS>
__device__ __forceinline__ void radix5_pass(const float2* __restrict__ in, float2* __restrict__ out,
                                            const float2* __restrict__ tw, int lane, float c1,
                                            float s1, float c2, float s2) {
  constexpr int STEP = 2 * M / (5 * NS);  // twiddle step in units of W400 (W200 = W400^2)
#pragma unroll
  for (int round = 0; round < (M / 5 + 31) / 32; ++round) {
    const int j = lane + 32 * round;
    if (j >= M / 5) break;
    const int k = j % NS;
    float2 v[5];
    v[0] = in[j];
#pragma unroll
    for (int r = 1; r < 5; ++r) v[r] = cmul(in[j + r * (M / 5)], __ldg(&tw[k * r * STEP]));
    dft5(v, c1, s1, c2, s2);
    const int d = (j / NS) * 5 * NS + k;
#pragma unroll
    for (int r = 0; r < 5; ++r) out[d + r * NS] = v[r];
  }
}

__global__ void __launch_bounds__(THREADS)
log_mel_frames_kernel(const float* __restrict__ audio, int audio_len, int chunk_samples,
                      const float* __restrict__ window, const float2* __restrict__ tw,
                      const int* __restrict__ bands, const float* __restrict__ band_w,
                      int n_mels, int n_frames, float* __restrict__ out) {
  __shared__ float2 s_a[FRAMES_PER_BLOCK][M];
  __shared__ float2 s_b[FRAMES_PER_BLOCK][M];
  __shared__ float s_pow[FRAMES_PER_BLOCK][N_BINS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * FRAMES_PER_BLOCK + warp;
  if (f >= n_frames) return;  // whole warps only: no block-wide barrier below
  float2* a = s_a[warp];
  float2* b = s_b[warp];
  float* pw = s_pow[warp];

  // The butterflies' constants, from the table of W400^j = exp(-2 pi i j / 400).
  const float2 w50 = __ldg(&tw[50]), w80 = __ldg(&tw[80]), w160 = __ldg(&tw[160]);
  const float rsqrt2 = w50.x;                   // cos(pi / 4)
  const float c1 = w80.x, s1 = -w80.y;          // 2 pi / 5
  const float c2 = w160.x, s2 = -w160.y;        // 4 pi / 5

  // Pass 1, radix 8 (no twiddles): butterfly j < 25 loads z[j + 25 r], i.e.
  // samples n = 2 (j + 25 r) and n + 1, windowed, from the padded signal.
  if (lane < M / 8) {
    const int base = f * HOP - PAD;
    float2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = 2 * (lane + 25 * r);
      const int j0 = reflect_index(base + n, chunk_samples);
      const int j1 = reflect_index(base + n + 1, chunk_samples);
      const float x0 = j0 < audio_len ? __ldg(&audio[j0]) : 0.f;
      const float x1 = j1 < audio_len ? __ldg(&audio[j1]) : 0.f;
      v[r] = make_float2(x0 * __ldg(&window[n]), x1 * __ldg(&window[n + 1]));
    }
    dft8(v, rsqrt2);
#pragma unroll
    for (int r = 0; r < 8; ++r) a[8 * lane + r] = v[r];
  }
  __syncwarp();
  radix5_pass<8>(a, b, tw, lane, c1, s1, c2, s2);   // Ns 8 -> 40
  __syncwarp();
  radix5_pass<40>(b, a, tw, lane, c1, s1, c2, s2);  // Ns 40 -> 200: a holds Z
  __syncwarp();

  // Split Z into the real frame's bins and take the power: 2 X[k] =
  // (Z[k] + conj Z[-k]) - i W^k (Z[k] - conj Z[-k]).
#pragma unroll
  for (int round = 0; round < (N_BINS + 31) / 32; ++round) {
    const int k = lane + 32 * round;
    if (k >= N_BINS) break;
    const float2 z = a[k % M];
    const float2 zc = a[(M - k) % M];
    const float2 p = make_float2(z.x + zc.x, z.y - zc.y);  // Z[k] + conj Z[-k]
    const float2 q = make_float2(z.x - zc.x, z.y + zc.y);  // Z[k] - conj Z[-k]
    const float2 x = cadd(p, cmul(__ldg(&tw[k]), mul_neg_i(q)));
    pw[k] = 0.25f * (x.x * x.x + x.y * x.y);
  }
  __syncwarp();

  // Mel filter m over its band [lo, hi) of bins, weights at band_w[off ..].
  float* row = out + static_cast<size_t>(f) * n_mels;
#pragma unroll
  for (int round = 0; round < MAX_MELS / 32; ++round) {
    const int m = lane + 32 * round;
    if (m >= n_mels) break;
    const int lo = __ldg(&bands[3 * m]), width = __ldg(&bands[3 * m + 1]) - lo;
    const float* w = band_w + __ldg(&bands[3 * m + 2]);
    float acc = 0.f;
    for (int i0 = 0; i0 < width; i0 += 8) {  // 8 bins at a time: their loads issue together
#pragma unroll
      for (int i = i0; i < i0 + 8; ++i)
        if (i < width) acc = fmaf(pw[lo + i], __ldg(&w[i]), acc);
    }
    row[m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio: [audio_len] f32 (audio_len <= chunk_samples); window: [400] f32 Hann;
// twiddles: [400] complex f32, exp(-2 pi i j / 400); bands: [n_mels, 3] i32
// (lo, hi, offset of the band's first weight); band_w: the filterbank's
// nonzeros, band after band, f32; out: [n_frames, n_mels] f32 with
// n_frames = chunk_samples / 160. Returns cudaGetLastError().
extern "C" int est_log_mel_frames(const void* audio, int audio_len, int chunk_samples,
                                  const void* window, const void* twiddles, const void* bands,
                                  const void* band_w, int n_mels, void* out, void* stream) {
  const int n_frames = chunk_samples / HOP;
  const dim3 grid((n_frames + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK);
  log_mel_frames_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), audio_len, chunk_samples,
      static_cast<const float*>(window), static_cast<const float2*>(twiddles),
      static_cast<const int*>(bands), static_cast<const float*>(band_w), n_mels, n_frames,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

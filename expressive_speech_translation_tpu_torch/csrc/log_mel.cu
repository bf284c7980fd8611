// Whisper log-mel frames for one waveform, hand-written for Hopper (sm_90a).
//
// Replaces: the JAX package's ops/pallas_mel.py,
//           whisper_log_mel_pallas (Pallas kernel `_kernel`).
//
// Computes, for frame f of the reflect-padded waveform (pad 200, hop 160,
// n_fft 400):
//   re[k]  = sum_n x[160 f + n] * hann[n] cos(-2 pi n k / 400)
//   im[k]  = sum_n x[160 f + n] * hann[n] sin(-2 pi n k / 400)
//   out[f][m] = log10(max(sum_k (re[k]^2 + im[k]^2) fb[k][m], 1e-10))
// The window is folded into the bases by the caller. The global (max - 8)
// floor, the affine (x + 4) / 4 and the transpose need the whole spectrogram
// and stay outside, as they do in the JAX package.
//
// What bounds it on the H100: operations. At 30 s and 80 mels the work is
// 2*3000*400*402 + 2*3000*201*80 = 1.06 GFLOP of FP32 (16 us at the 67 TFLOP/s
// non-tensor FP32 peak) against ~3.6 MB of traffic (1 us at 3.35 TB/s). The
// JAX kernel runs its products at HIGHEST precision, so this one uses IEEE
// FP32 FMA throughout: no TF32, no tensor cores.
//
// Design: one block owns TILE_F consecutive frames. It stages the samples the
// tile spans ((TILE_F - 1) * 160 + 400) in shared memory once, applying the
// zero pad to the chunk length and the reflect pad on the way in, so no padded
// copy of the waveform is ever written. Thread k owns DFT bin k for every
// frame of the tile: the sample it needs is the same for the whole warp (a
// shared-memory broadcast), and the bases, which are 643 KB together and do
// not fit, stream through shared memory in slices of SLICE rows with coalesced
// loads. The power spectrum never leaves the block: it goes to shared memory
// and the same block projects it onto the mel filterbank and takes the log.

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N_BINS = N_FFT / 2 + 1;  // 201
constexpr int PAD = N_FFT / 2;         // reflect pad per side
constexpr int TILE_F = 16;             // frames per block
constexpr int THREADS = 224;           // 7 warps >= N_BINS
constexpr int SLICE = 10;              // basis rows per shared-memory slice
constexpr int SPAN = (TILE_F - 1) * HOP + N_FFT;

__device__ __forceinline__ int reflect_index(int j, int n) {
  if (j < 0) j = -j;
  if (j >= n) j = 2 * (n - 1) - j;
  return j;
}

__global__ void __launch_bounds__(THREADS)
log_mel_frames_kernel(const float* __restrict__ audio, int audio_len,
                      int chunk_samples, const float* __restrict__ wcos,
                      const float* __restrict__ wsin,
                      const float* __restrict__ fb, int n_mels, int n_frames,
                      float* __restrict__ out) {
  __shared__ float s_audio[SPAN];
  __shared__ float s_cos[SLICE][N_BINS];
  __shared__ float s_sin[SLICE][N_BINS];
  __shared__ float s_pow[TILE_F][N_BINS];

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * TILE_F;
  const int padded_len = chunk_samples + 2 * PAD;

  // Samples of the tile: padded index p -> signal index by reflection; the
  // signal is the audio zero-padded (or trimmed) to chunk_samples.
  for (int i = tid; i < SPAN; i += THREADS) {
    const int p = f0 * HOP + i;
    float v = 0.f;
    if (p < padded_len) {
      const int j = reflect_index(p - PAD, chunk_samples);
      v = j < audio_len ? audio[j] : 0.f;
    }
    s_audio[i] = v;
  }

  float re[TILE_F], im[TILE_F];
#pragma unroll
  for (int f = 0; f < TILE_F; ++f) {
    re[f] = 0.f;
    im[f] = 0.f;
  }

  const int k = tid;
  for (int n0 = 0; n0 < N_FFT; n0 += SLICE) {
    __syncthreads();  // the previous slice is consumed (and s_audio is ready)
    for (int i = tid; i < SLICE * N_BINS; i += THREADS) {
      const int r = i / N_BINS, c = i - r * N_BINS;
      s_cos[r][c] = wcos[(n0 + r) * N_BINS + c];
      s_sin[r][c] = wsin[(n0 + r) * N_BINS + c];
    }
    __syncthreads();
    if (k < N_BINS) {
#pragma unroll 2
      for (int r = 0; r < SLICE; ++r) {
        const float c = s_cos[r][k];
        const float s = s_sin[r][k];
        const float* xs = s_audio + n0 + r;
#pragma unroll
        for (int f = 0; f < TILE_F; ++f) {
          const float x = xs[f * HOP];
          re[f] = fmaf(x, c, re[f]);
          im[f] = fmaf(x, s, im[f]);
        }
      }
    }
  }

  if (k < N_BINS) {
#pragma unroll
    for (int f = 0; f < TILE_F; ++f) s_pow[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = tid; idx < TILE_F * n_mels; idx += THREADS) {
    const int f = idx / n_mels, m = idx - f * n_mels;
    if (f0 + f >= n_frames) continue;
    float acc = 0.f;
    for (int kk = 0; kk < N_BINS; ++kk) acc = fmaf(s_pow[f][kk], fb[kk * n_mels + m], acc);
    out[(size_t)(f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio: [audio_len] f32 (audio_len <= chunk_samples); wcos/wsin: [400, 201]
// f32 window-folded DFT bases; fb: [201, n_mels] f32; out: [n_frames, n_mels]
// f32 with n_frames = chunk_samples / 160. Returns cudaGetLastError().
extern "C" int est_log_mel_frames(const void* audio, int audio_len,
                                  int chunk_samples, const void* wcos,
                                  const void* wsin, const void* fb, int n_mels,
                                  void* out, void* stream) {
  const int n_frames = chunk_samples / HOP;
  const dim3 grid((n_frames + TILE_F - 1) / TILE_F);
  log_mel_frames_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), audio_len, chunk_samples,
      static_cast<const float*>(wcos), static_cast<const float*>(wsin),
      static_cast<const float*>(fb), n_mels, n_frames, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Log-mel front end: windowed DFT power -> mel -> log, then utterance CMVN.
//
// Replaces ops/pallas_features.py::_mel_kernel (via PallasLogMelFrontEnd).
// The folded bases (kernels/mel.py::folded_bases) carry the povey window,
// DC removal, pre-emphasis and the 2^15 waveform scale, and drop the
// all-zero Nyquist bin, so the kernel computes, per frame f:
//   c|s = frame_f @ [cos | sin]     (L x 2*NB, fp32 FFMA: the "highest" contract)
//   mel = (c^2 + s^2) @ melbank     (NB x n_mel, fp32)
//   out = log(max(mel, floor))
// Frame f is samples [f*hop, f*hop + L); the TPU kernel's hop-row bands are a
// layout for its matrix unit and have no counterpart here.
//
// What bounds it on the H100: fp32 FFMA (about 0.4 MFLOP per frame for the
// DFT). A block takes 16 frames of one utterance, stages their samples in
// shared memory once, and each thread owns one frequency bin (its cos and sin
// columns): every basis value read from L2 feeds 16 frames x 2 FMAs, and the
// samples are broadcast reads. The power spectrum stays in shared memory for
// the mel product, so only the (B, frames, n_mel) log-mel is written.
//
// CMVN needs statistics over the whole utterance, so it is a second pass:
// one block per utterance, one thread per (mel bin, row group), fp32 sums,
// in the TPU kernel's op order (count clamped at 1, divide by sqrt(var) with
// no epsilon), masked rows written as exact zeros, output bf16.
#include "common.cuh"

namespace {

constexpr int FT = 16;  // frames per block

__global__ void mel_kernel(const float* __restrict__ wav, int S, const float* __restrict__ dft,
                           const float* __restrict__ melbank, float* __restrict__ out,
                           int n_frames, int L, int hop, int NB, int n_mel, float floor_) {
    extern __shared__ __align__(16) float smem[];
    const int span = (FT - 1) * hop + L;
    float* xs = smem;          // [span]
    float* pw = smem + span;   // [FT][NB]
    const int f0 = blockIdx.x * FT, b = blockIdx.y;
    const size_t s0 = (size_t)f0 * hop;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const size_t s = s0 + i;
        xs[i] = s < (size_t)S ? wav[(size_t)b * S + s] : 0.0f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < NB; j += blockDim.x) {
        float ac[FT], as[FT];
#pragma unroll
        for (int f = 0; f < FT; ++f) ac[f] = as[f] = 0.0f;
        for (int n = 0; n < L; ++n) {
            const float dc = dft[(size_t)n * 2 * NB + j];
            const float ds = dft[(size_t)n * 2 * NB + NB + j];
#pragma unroll
            for (int f = 0; f < FT; ++f) {
                const float x = xs[f * hop + n];
                ac[f] = fmaf(x, dc, ac[f]);
                as[f] = fmaf(x, ds, as[f]);
            }
        }
#pragma unroll
        for (int f = 0; f < FT; ++f) pw[f * NB + j] = ac[f] * ac[f] + as[f] * as[f];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < FT * n_mel; i += blockDim.x) {
        const int f = i / n_mel, m = i % n_mel;
        if (f0 + f >= n_frames) continue;
        float acc = 0.0f;
        for (int j = 0; j < NB; ++j) acc = fmaf(pw[f * NB + j], melbank[(size_t)j * n_mel + m], acc);
        out[((size_t)b * n_frames + f0 + f) * n_mel + m] = logf(fmaxf(acc, floor_));
    }
}

constexpr int CMVN_GROUPS = 4;

__global__ void cmvn_kernel(const float* __restrict__ lm, const int* __restrict__ lengths,
                            bf16* __restrict__ out, int n_frames, int n_mel, int norm_means,
                            int norm_vars) {
    extern __shared__ float red[];  // [CMVN_GROUPS][n_mel]
    const int b = blockIdx.x;
    const int m = threadIdx.x % n_mel, g = threadIdx.x / n_mel;
    const int n = lengths[b];
    const float count = fmaxf((float)n, 1.0f);
    const float* x = lm + (size_t)b * n_frames * n_mel;

    auto block_sum = [&](float v) {
        red[g * n_mel + m] = v;
        __syncthreads();
        float s = 0.0f;
        for (int i = 0; i < CMVN_GROUPS; ++i) s += red[i * n_mel + m];
        __syncthreads();
        return s;
    };

    float s = 0.0f;
    for (int t = g; t < n; t += CMVN_GROUPS) s += x[(size_t)t * n_mel + m];
    const float mean = block_sum(s) / count;
    const float shift = norm_means ? mean : 0.0f;
    float sd = 1.0f;
    if (norm_vars) {
        float q = 0.0f;
        for (int t = g; t < n; t += CMVN_GROUPS) {
            const float d = x[(size_t)t * n_mel + m] - shift;
            q += d * d;
        }
        float var = block_sum(q) / count;
        if (!norm_means) var -= mean * mean;
        sd = sqrtf(var);
    }
    for (int t = g; t < n_frames; t += CMVN_GROUPS) {
        const float v = t < n ? (x[(size_t)t * n_mel + m] - shift) / sd : 0.0f;
        out[((size_t)b * n_frames + t) * n_mel + m] = to_bf(v);
    }
}

}  // namespace

// wav: [B, S] fp32; dft: [L, 2*NB] fp32; melbank: [NB, n_mel] fp32;
// out: [B, n_frames, n_mel] fp32 log-mel.
ASR_API int asr_log_mel(const void* wav, const void* dft, const void* melbank, void* out, int B,
                        int S, int n_frames, int L, int hop, int NB, int n_mel, float floor_,
                        void* stream) {
    const size_t smem = ((size_t)(FT - 1) * hop + L + (size_t)FT * NB) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(ceil_div(n_frames, FT), B);
    mel_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(wav), S, static_cast<const float*>(dft),
        static_cast<const float*>(melbank), static_cast<float*>(out), n_frames, L, hop, NB, n_mel,
        floor_);
    return static_cast<int>(cudaGetLastError());
}

// lm: [B, n_frames, n_mel] fp32; lengths: [B] int32 frame counts;
// out: [B, n_frames, n_mel] bf16, rows >= length exact zeros.
ASR_API int asr_cmvn(const void* lm, const void* lengths, void* out, int B, int n_frames,
                     int n_mel, int norm_means, int norm_vars, void* stream) {
    const int threads = n_mel * CMVN_GROUPS;
    if (threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
    cmvn_kernel<<<B, threads, threads * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lm), static_cast<const int*>(lengths), static_cast<bf16*>(out),
        n_frames, n_mel, norm_means, norm_vars);
    return static_cast<int>(cudaGetLastError());
}

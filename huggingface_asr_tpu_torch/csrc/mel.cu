// Log-mel front end: windowed DFT power -> mel -> log, then utterance CMVN.
//
// Replaces ops/pallas_features.py::_mel_kernel (via PallasLogMelFrontEnd) at
// its "highest" contract. The folded bases (kernels/mel.py::folded_bases)
// carry the povey window, DC removal, pre-emphasis and the 2^15 waveform
// scale, and drop the all-zero Nyquist bin, so the kernel computes, per
// frame f (samples [f*hop, f*hop + L)):
//   c|s = frame_f @ [cos | sin]     (L x 2*NB, fp32 FFMA)
//   mel = (c^2 + s^2) @ melbank     (NB x n_mel, fp32 FFMA)
//   out = log(max(mel, floor))
// The TPU kernel's hop-row bands are a layout for its matrix unit and have no
// counterpart here.
//
// What bounds it on the H100: fp32 operations, 0.42 MFLOP a frame (57.5 GFLOP
// at B=128 x 10 s, 0.86 ms at 67 TFLOP/s). The contract is fp32, and each
// (frame, column) sum runs over k in order with one rounding a term, as the
// cuBLAS fp32 product does: on a bin whose sum cancels (the low bins of a
// loud frame) the log-mel error is then that product's. (3xTF32 on the
// tensor cores was built and measured first: the tensor core truncates its
// adds, and on such bins its error came to 2.25x the cuBLAS product's on one
// of the speech inputs, past the 2x gate; PERF.md, section 6.) The design is a
// register-tiled product:
//   * a block owns 64 frames of one utterance; a pass takes 64 bins (their
//     64 cos and 64 sin columns), four passes cover the 256 bins;
//   * k-chunks of 16 samples: the frames' samples (frames overlap: frame f's
//     row starts hop samples after frame f - 1's) and the basis rows are
//     staged in shared memory through two buffers, the next chunk's global
//     loads in flight under this one's products;
//   * a thread owns 8 frames x 4 bins, cos and sin: per k it reads 8 frame
//     values and 8 basis values as four 16-byte shared loads and does 64
//     FMAs, so c and s of a bin meet in one thread and the power is formed
//     in registers;
//   * at the end of a pass the power goes to shared memory and each thread
//     adds its 8 frames x 5 mel columns of power @ melbank over the pass's
//     bins, in bin order; after the last pass, log and one fp32 store.
//
// CMVN needs statistics over the whole utterance, so it is a second pass:
// one block per utterance, one thread per (mel bin, row group), fp32 sums,
// in the TPU kernel's op order (count clamped at 1, divide by sqrt(var) with
// no epsilon), masked rows written as exact zeros, output bf16.
#include "common.cuh"

namespace {

constexpr int FT = 64;                 // frames of a block
constexpr int PASS_BINS = 64;          // bins of a pass
constexpr int KC = 16;                 // k-values of a chunk
constexpr int THREADS = 128;           // 16 bin groups x 8 frame groups
constexpr int F_LD = FT + 4;           // row stride (floats) of the staged frames, k-major
constexpr int B_LD = 2 * PASS_BINS;    // row stride of the staged basis: the pass's cos, then sin columns
constexpr int PW_LD = PASS_BINS + 1;   // row stride of the staged power
constexpr int MEL_J = 5;               // mel columns of a thread, 16 apart: n_mel <= 80

// wav: [B, S] fp32; dft: [L, 2*NB] fp32 (cos columns, then sin);
// melbank: [NB, n_mel] fp32; out: [B, n_frames, n_mel] fp32.
__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ wav, int S, const float* __restrict__ dft,
           const float* __restrict__ melbank, float* __restrict__ out, int n_frames, int L, int hop,
           int NB, int n_mel, float floor_) {
    __shared__ __align__(16) float fs[2][KC][F_LD];
    __shared__ __align__(16) float bs[2][KC][B_LD];
    __shared__ float pw[FT][PW_LD];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int b = blockIdx.y, f0 = blockIdx.x * FT;
    const float* x = wav + (size_t)b * S;
    const int chunks = (L + KC - 1) / KC;

    float mel[8][MEL_J];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < MEL_J; ++c) mel[i][c] = 0.0f;

    for (int p = 0; p < NB / PASS_BINS; ++p) {
        // A chunk's staging: this thread's samples are k = tid % 16 of the
        // frames tid / 16 + 8 i (a half-warp reads 16 contiguous samples); its
        // basis pieces are four of the 32 16-byte pieces of rows tid / 32 + 4 i
        // (16 cos, then 16 sin). Past L (and past S), zeros.
        float xr[8];
        float4 br[4];
        auto load = [&](int chunk) {
            const int k = chunk * KC + tid % 16;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const long long at = (long long)(f0 + tid / 16 + 8 * i) * hop + k;
                xr[i] = k < L && at < S ? __ldg(x + at) : 0.0f;
            }
            const int c4 = tid % 32;
            const int col = c4 < 16 ? p * PASS_BINS + 4 * c4 : NB + p * PASS_BINS + 4 * (c4 - 16);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int kk = chunk * KC + tid / 32 + 4 * i;
                br[i] = kk < L ? __ldg(reinterpret_cast<const float4*>(dft + (size_t)kk * 2 * NB + col))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
        };
        auto store = [&](int buf) {
#pragma unroll
            for (int i = 0; i < 8; ++i) fs[buf][tid % 16][tid / 16 + 8 * i] = xr[i];
#pragma unroll
            for (int i = 0; i < 4; ++i) *reinterpret_cast<float4*>(&bs[buf][tid / 32 + 4 * i][4 * (tid % 32)]) = br[i];
        };

        float ac[8][4], as[8][4];  // c and s of frames 8 ty + i, bins 4 tx + j of the pass
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) ac[i][j] = as[i][j] = 0.0f;
        load(0);
        store(0);
        __syncthreads();
        for (int chunk = 0; chunk < chunks; ++chunk) {
            const int buf = chunk & 1;
            if (chunk + 1 < chunks) load(chunk + 1);
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                const float4 a0 = *reinterpret_cast<const float4*>(&fs[buf][k][8 * ty]);
                const float4 a1 = *reinterpret_cast<const float4*>(&fs[buf][k][8 * ty + 4]);
                const float4 cc = *reinterpret_cast<const float4*>(&bs[buf][k][4 * tx]);
                const float4 ss = *reinterpret_cast<const float4*>(&bs[buf][k][PASS_BINS + 4 * tx]);
                const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                const float cv[4] = {cc.x, cc.y, cc.z, cc.w}, sv[4] = {ss.x, ss.y, ss.z, ss.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        ac[i][j] = fmaf(a[i], cv[j], ac[i][j]);
                        as[i][j] = fmaf(a[i], sv[j], as[i][j]);
                    }
            }
            // every thread is done with the other buffer (the barrier below, one chunk ago)
            if (chunk + 1 < chunks) store(buf ^ 1);
            __syncthreads();
        }
        // the pass's power, c^2 + s^2 as the plain version rounds it
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                pw[8 * ty + i][4 * tx + j] = __fadd_rn(__fmul_rn(ac[i][j], ac[i][j]), __fmul_rn(as[i][j], as[i][j]));
        __syncthreads();
        // this thread's 8 frames x 5 mel columns (fg = ty, mg = tx), over the pass's bins in order;
        // eight bins' melbank loads in flight
        const float* wrow = melbank + (size_t)p * PASS_BINS * n_mel;
#pragma unroll 8
        for (int j = 0; j < PASS_BINS; ++j) {
            float w[MEL_J];
#pragma unroll
            for (int c = 0; c < MEL_J; ++c) {
                const int m = tx + 16 * c;
                w[c] = m < n_mel ? __ldg(wrow + (size_t)j * n_mel + m) : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float v = pw[8 * ty + i][j];
#pragma unroll
                for (int c = 0; c < MEL_J; ++c) mel[i][c] = fmaf(v, w[c], mel[i][c]);
            }
        }
        // the next pass writes pw again only after its chunks' barriers
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int f = f0 + 8 * ty + i;
        if (f >= n_frames) break;
        float* o = out + ((size_t)b * n_frames + f) * n_mel;
#pragma unroll
        for (int c = 0; c < MEL_J; ++c) {
            const int m = tx + 16 * c;
            if (m < n_mel) o[m] = logf(fmaxf(mel[i][c], floor_));
        }
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
// out: [B, n_frames, n_mel] fp32 log-mel. Takes NB % 64 == 0, n_mel <= 80 and
// frames within S (the wrapper checks).
ASR_API int asr_log_mel(const void* wav, const void* dft, const void* melbank, void* out, int B, int S,
                        int n_frames, int L, int hop, int NB, int n_mel, float floor_, void* stream) {
    if (B < 1 || B > 65535 || n_frames < 1 || L < 1 || NB < PASS_BINS || NB % PASS_BINS || n_mel < 1 ||
        n_mel > 16 * MEL_J)
        return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(ceil_div(n_frames, FT), B);
    mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
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

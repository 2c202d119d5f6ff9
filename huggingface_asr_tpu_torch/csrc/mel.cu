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
//   * past 80 mel bins (WIDE) 8 x 8 mel sums held through the passes would
//     spill (the 80-bin kernel is at ~250 registers a thread), so every
//     pass's power stays in shared memory ([64 frames][NB + 1], 66 KB at 256
//     bins) and, after the last pass, the threads run the mel product in
//     groups of 80 columns, each group over all bins in order: the same sums,
//     bit for bit, with no mel sum live during the DFT.
//
// CMVN needs statistics over the whole utterance, so it is a second kernel,
// in the TPU kernel's op order (the mean first, then the variance of the
// centred values, var - mean^2 only without mean normalisation; count clamped
// at 1, divide by sqrt(var) with no epsilon), rows at and past the length
// written as exact zeros, output bf16. It is bound by bytes (the fp32 log-mel
// read once, the bf16 features written once: 0.018 ms at B=128 x 10 s), so
// an utterance is spread over a thread-block cluster of 8 blocks, each
// holding its eighth of the frames (40 KB at 10 s) in shared memory from one
// bulk copy: the per-bin sums of both passes are read from there and
// exchanged through distributed shared memory (sums in frame order per
// thread, then over the block's frame groups, then over the cluster in rank
// order), and the block writes its frames in 16-byte pieces. A block whose
// frames do not fit 160 KB reads them again, chunk by chunk, in every pass.
// A bin count that is no multiple of 8 (Kaldi's 23) takes the same kernel in
// column groups of one bin, loaded and written a value a thread (V = 1).
// What holds it at ~2.4x its byte bound at B=128 (about twice a bf16 cast of
// the same input, PERF.md section 6): the cluster exchange, a quarter of its time
// there, since a block waits at the first cluster barrier for the slowest
// load of its cluster while its writes and the next blocks' loads wait behind
// it (1,024 blocks, four an SM, two waves).
#include "hopper.cuh"

namespace {

constexpr int FT = 64;                 // frames of a block
constexpr int PASS_BINS = 64;          // bins of a pass
constexpr int KC = 16;                 // k-values of a chunk
constexpr int THREADS = 128;           // 16 bin groups x 8 frame groups
constexpr int F_LD = FT + 4;           // row stride (floats) of the staged frames, k-major
constexpr int B_LD = 2 * PASS_BINS;    // row stride of the staged basis: the pass's cos, then sin columns
constexpr int PW_LD = PASS_BINS + 1;   // row stride of the staged power
constexpr int MEL_J = 5;               // mel columns of a thread, 16 apart: 80 a group
constexpr int MEL_GROUP = 16 * MEL_J;  // mel columns of a group

// wav: [B, S] fp32; dft: [L, 2*NB] fp32 (cos columns, then sin);
// melbank: [NB, n_mel] fp32; out: [B, n_frames, n_mel] fp32. WIDE (n_mel >
// MEL_GROUP): the power of every pass in the dynamic shared memory, [FT][NB + 1].
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
mel_kernel(const float* __restrict__ wav, int S, const float* __restrict__ dft,
           const float* __restrict__ melbank, float* __restrict__ out, int n_frames, int L, int hop,
           int NB, int n_mel, float floor_) {
    __shared__ __align__(16) float fs[2][KC][F_LD];
    __shared__ __align__(16) float bs[2][KC][B_LD];
    __shared__ float pw_pass[WIDE ? 1 : FT][PW_LD];
    extern __shared__ float pw_all[];
    float* pw = WIDE ? pw_all : &pw_pass[0][0];
    const int pw_ld = WIDE ? NB + 1 : PW_LD;
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
        // the pass's power, c^2 + s^2 as the plain version rounds it (WIDE: at its bins' columns)
        float* pw_p = pw + (WIDE ? p * PASS_BINS : 0);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                pw_p[(8 * ty + i) * pw_ld + 4 * tx + j] =
                    __fadd_rn(__fmul_rn(ac[i][j], ac[i][j]), __fmul_rn(as[i][j], as[i][j]));
        if constexpr (WIDE) continue;  // the mel product waits for every pass's power
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
                const float v = pw[(8 * ty + i) * PW_LD + j];
#pragma unroll
                for (int c = 0; c < MEL_J; ++c) mel[i][c] = fmaf(v, w[c], mel[i][c]);
            }
        }
        // the next pass writes pw again only after its chunks' barriers
    }
    // this thread's 8 frames x 5 mel columns of group m0 (all of them where !WIDE), log, one store each
    auto write_out = [&](int m0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int f = f0 + 8 * ty + i;
            if (f >= n_frames) break;
            float* o = out + ((size_t)b * n_frames + f) * n_mel + m0;
#pragma unroll
            for (int c = 0; c < MEL_J; ++c) {
                const int m = tx + 16 * c;
                if (m0 + m < n_mel) o[m] = logf(fmaxf(mel[i][c], floor_));
            }
        }
    };
    if constexpr (!WIDE) {
        write_out(0);
    } else {
        __syncthreads();  // every pass's power is in place
        for (int m0 = 0; m0 < n_mel; m0 += MEL_GROUP) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int c = 0; c < MEL_J; ++c) mel[i][c] = 0.0f;
#pragma unroll 8
            for (int j = 0; j < NB; ++j) {
                float w[MEL_J];
#pragma unroll
                for (int c = 0; c < MEL_J; ++c) {
                    const int m = m0 + tx + 16 * c;
                    w[c] = m < n_mel ? __ldg(melbank + (size_t)j * n_mel + m) : 0.0f;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float v = pw[(8 * ty + i) * pw_ld + j];
#pragma unroll
                    for (int c = 0; c < MEL_J; ++c) mel[i][c] = fmaf(v, w[c], mel[i][c]);
                }
            }
            write_out(m0);
        }
    }
}

constexpr int CMVN_CLUSTER = 8;                 // blocks of an utterance
constexpr int CMVN_THREADS = 320;               // 20 column groups of 4 bins x 16 frame groups at 80 bins
constexpr int CMVN_CHUNK_BYTES = 160 * 1024;    // of a block's frames held in shared memory at once

// lm: [B, n_frames, n_mel] fp32; lengths: [B]; out: [B, n_frames, n_mel] bf16.
// A cluster of CMVN_CLUSTER blocks per utterance (grid (CMVN_CLUSTER, B)),
// block r owning frames [r * per, (r + 1) * per). Shared memory: the block's
// frames ([chunk][n_mel] fp32), the frame groups' partial sums ([G][n_mel]),
// the block's sums of both passes ([2][n_mel], read by the whole cluster),
// shift and divisor ([2][n_mel]), the mbarrier (8-byte aligned).
// V = 4 (n_mel % 8 == 0, 16-byte aligned tensors): a thread sums a column
// group of 4 bins, the frames arrive by one bulk copy and leave in 16-byte
// pieces of 8 bins. V = 1 (any n_mel; a 23-bin row is 92 bytes, which those
// pieces do not tile): a thread sums one bin, the threads load the frames
// and write the features a value each, in the rows' order.
template <int V>
__global__ void __launch_bounds__(CMVN_THREADS)
cmvn_kernel(const float* __restrict__ lm, const int* __restrict__ lengths, bf16* __restrict__ out,
            int n_frames, int n_mel, int per, int chunk, int norm_means, int norm_vars) {
    using namespace hopper;
    static_assert(V == 4 || V == 1, "column groups of 4 bins or of one");
    extern __shared__ __align__(16) unsigned char smem[];
    const int Q = n_mel / V, G = CMVN_THREADS / Q;
    float* xs = reinterpret_cast<float*>(smem);
    float* part = xs + (size_t)chunk * n_mel;
    float* sums = part + G * n_mel;
    float* stat = sums + 2 * n_mel;
    const uint32_t bar = (smem_u32(stat + 2 * n_mel) + 7u) & ~7u;
    const int tid = threadIdx.x, q = tid % Q, g = tid / Q;  // bins V q .. V q + V - 1 of frames g, g + G, ..
    const int b = blockIdx.y;
    const int f_lo = (int)cluster_rank() * per, f_hi = min(f_lo + per, n_frames);
    const int n = min(lengths[b], n_frames);
    const int n_ld = max(0, min(n, f_hi) - f_lo);  // this block's frames below the length
    const float count = fmaxf((float)n, 1.0f);
    const float* x = lm + ((size_t)b * n_frames + f_lo) * n_mel;
    bf16* o = out + ((size_t)b * n_frames + f_lo) * n_mel;
    const bool resident = n_ld <= chunk;

    if (V == 4 && tid == 0) {
        mbar_init(bar, 1);
        mbar_init_fence();
    }
    __syncthreads();
    uint32_t phase = 0;
    auto load = [&](int c0, int cn) {  // this block's frames c0 .. c0 + cn - 1 into xs
        if constexpr (V == 4) {
            if (tid == 0) {
                const uint32_t bytes = (uint32_t)cn * n_mel * 4;
                mbar_arrive_expect_tx(bar, bytes);
                bulk_load(smem_u32(xs), x + (size_t)c0 * n_mel, bytes, bar);
            }
            mbar_wait(bar, phase);
            phase ^= 1;
        } else {
            const float* src = x + (size_t)c0 * n_mel;
            for (int i = tid; i < cn * n_mel; i += CMVN_THREADS) xs[i] = __ldg(src + i);
            __syncthreads();
        }
    };
    // body(c0, cn) over the block's frames below the length: held once where
    // they fit, else chunk by chunk (read again by every pass)
    auto visit = [&](auto&& body) {
        if (resident) {
            body(0, n_ld);
            return;
        }
        for (int c0 = 0; c0 < n_ld; c0 += chunk) {
            __syncthreads();  // every thread is done with the previous chunk
            load(c0, min(chunk, n_ld - c0));
            body(c0, min(chunk, n_ld - c0));
        }
    };
    // dst[m] = the whole utterance's sum of term(x, m) over the frames below
    // the length: per thread in frame order, then over the frame groups, then
    // over the cluster's blocks in rank order (every block gets the same sum)
    auto utterance_sums = [&](float* mine, float* dst, auto&& term) {
        if constexpr (V == 4) {
            float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            visit([&](int, int cn) {
                if (g < G)
                    for (int f = g; f < cn; f += G) {
                        const float4 v = reinterpret_cast<const float4*>(xs + (size_t)f * n_mel)[q];
                        s.x += term(v.x, 4 * q);
                        s.y += term(v.y, 4 * q + 1);
                        s.z += term(v.z, 4 * q + 2);
                        s.w += term(v.w, 4 * q + 3);
                    }
            });
            if (g < G) reinterpret_cast<float4*>(part + g * n_mel)[q] = s;
        } else {
            float s = 0.0f;
            visit([&](int, int cn) {
                if (g < G)
                    for (int f = g; f < cn; f += G) s += term(xs[(size_t)f * n_mel + q], q);
            });
            if (g < G) part[g * n_mel + q] = s;
        }
        __syncthreads();
        if (tid < n_mel) {
            float t = 0.0f;
            for (int i = 0; i < G; ++i) t += part[i * n_mel + tid];
            mine[tid] = t;
        }
        cluster_arrive();
        cluster_wait();  // every block's sums are in place
        if (tid < n_mel) {
            float t = 0.0f;
            for (int r = 0; r < CMVN_CLUSTER; ++r) t += ld_cluster(mine + tid, r);
            dst[tid] = t;
        }
        __syncthreads();
    };

    if (resident && n_ld > 0) load(0, n_ld);
    float* shift = stat;
    float* sd = stat + n_mel;
    if (tid < n_mel) {
        shift[tid] = 0.0f;
        sd[tid] = 1.0f;
    }
    if (norm_means || norm_vars) {
        utterance_sums(sums, part, [](float v, int) { return v; });
        // part[m] holds the sum; part is reused only after the next barrier
        float mean = 0.0f;
        if (tid < n_mel) {
            mean = part[tid] / count;
            if (norm_means) shift[tid] = mean;
        }
        __syncthreads();
        if (norm_vars) {
            utterance_sums(sums + n_mel, part, [&](float v, int m) {
                const float d = v - shift[m];
                return __fmul_rn(d, d);
            });
            if (tid < n_mel) {
                float var = part[tid] / count;
                if (!norm_means) var = var - __fmul_rn(mean, mean);
                sd[tid] = sqrtf(var);
            }
            __syncthreads();
        }
        cluster_arrive();  // this block reads no other block's shared memory after here
    }

    // bf16 out: (x - shift) / sd below the length, zeros from it on
    if constexpr (V == 4) {  // in 16-byte pieces of 8 bins
        const int P = n_mel / 8;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        for (int i = tid; i < (f_hi - f_lo - n_ld) * P; i += CMVN_THREADS)
            reinterpret_cast<uint4*>(o + (size_t)(n_ld + i / P) * n_mel)[i % P] = zero;
        visit([&](int c0, int cn) {
            for (int i = tid; i < cn * P; i += CMVN_THREADS) {
                const int f = i / P, p = i % P;
                const float* v = xs + (size_t)f * n_mel + 8 * p;
                uint32_t w[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int m = 8 * p + 2 * j;
                    const __nv_bfloat162 y = __floats2bfloat162_rn((v[2 * j] - shift[m]) / sd[m],
                                                                   (v[2 * j + 1] - shift[m + 1]) / sd[m + 1]);
                    w[j] = *reinterpret_cast<const uint32_t*>(&y);
                }
                reinterpret_cast<uint4*>(o + (size_t)(c0 + f) * n_mel)[p] = make_uint4(w[0], w[1], w[2], w[3]);
            }
        });
    } else {  // a value a thread, the block's rows as one run
        for (int i = tid; i < (f_hi - f_lo - n_ld) * n_mel; i += CMVN_THREADS)
            o[(size_t)n_ld * n_mel + i] = __float2bfloat16_rn(0.0f);
        visit([&](int c0, int cn) {
            for (int i = tid; i < cn * n_mel; i += CMVN_THREADS) {
                const int m = i % n_mel;
                o[(size_t)c0 * n_mel + i] = __float2bfloat16_rn((xs[i] - shift[m]) / sd[m]);
            }
        });
    }
    if (norm_means || norm_vars) cluster_wait();  // no block leaves while another reads its sums
}

}  // namespace

// wav: [B, S] fp32; dft: [L, 2*NB] fp32; melbank: [NB, n_mel] fp32;
// out: [B, n_frames, n_mel] fp32 log-mel. Takes NB % 64 == 0, any n_mel (past
// 80 while the power of all NB bins fits the shared memory: NB <= 768) and
// frames within S (the wrapper checks).
ASR_API int asr_log_mel(const void* wav, const void* dft, const void* melbank, void* out, int B, int S,
                        int n_frames, int L, int hop, int NB, int n_mel, float floor_, void* stream) {
    if (B < 1 || B > 65535 || n_frames < 1 || L < 1 || NB < PASS_BINS || NB % PASS_BINS || n_mel < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(ceil_div(n_frames, FT), B);
    auto st = static_cast<cudaStream_t>(stream);
    const float* w = static_cast<const float*>(wav);
    const float* d = static_cast<const float*>(dft);
    const float* m = static_cast<const float*>(melbank);
    float* o = static_cast<float*>(out);
    if (n_mel <= MEL_GROUP) {
        mel_kernel<false><<<grid, THREADS, 0, st>>>(w, S, d, m, o, n_frames, L, hop, NB, n_mel, floor_);
    } else {
        const size_t smem = (size_t)FT * (NB + 1) * sizeof(float);
        if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
        cudaError_t err = cudaFuncSetAttribute(mel_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        mel_kernel<true><<<grid, THREADS, smem, st>>>(w, S, d, m, o, n_frames, L, hop, NB, n_mel, floor_);
    }
    return static_cast<int>(cudaGetLastError());
}

// lm: [B, n_frames, n_mel] fp32; lengths: [B] int32 frame counts;
// out: [B, n_frames, n_mel] bf16, rows >= length exact zeros. Takes any
// n_mel <= CMVN_THREADS (a thread a bin for the sums); where n_mel % 8 == 0
// and both tensors are 16-byte aligned (the wrapper's are) the V = 4 kernel
// runs, else V = 1.
ASR_API int asr_cmvn(const void* lm, const void* lengths, void* out, int B, int n_frames,
                     int n_mel, int norm_means, int norm_vars, void* stream) {
    if (B < 1 || B > 65535 || n_frames < 1 || n_mel < 1 || n_mel > CMVN_THREADS)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = n_mel % 8 == 0 && reinterpret_cast<uintptr_t>(lm) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const int per = ceil_div(n_frames, CMVN_CLUSTER);
    const int max_chunk = CMVN_CHUNK_BYTES / (n_mel * 4);
    const int chunk = per < max_chunk ? per : max_chunk;
    const int G = CMVN_THREADS / (vec ? n_mel / 4 : n_mel);
    const size_t smem = ((size_t)chunk + G + 4) * n_mel * 4 + 16;
    auto kernel = vec ? cmvn_kernel<4> : cmvn_kernel<1>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CMVN_CLUSTER, B);
    cfg.blockDim = dim3(CMVN_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CMVN_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(lm), static_cast<const int*>(lengths),
                             static_cast<bf16*>(out), n_frames, n_mel, per, chunk, norm_means, norm_vars);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

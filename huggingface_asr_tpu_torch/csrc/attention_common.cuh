// Shared device helpers of the attention kernels: the mask, the visited keys
// and the dropout hash serve them all (the fp32 training kernels of
// rel_attention_train.cu, the shift-form inference kernel of
// rel_attention_shift.cu and the kernels on wgmma, attention_wgmma.cuh);
// Tile, copy_row and warp_mm serve the fp32 shift-form kernel.
//
// One template parameter E is the element type of the inputs and outputs of
// the shift-form kernel that is not on wgmma. Only float is instantiated
// today (tile products as exact fp32 FMA loops); bf16 runs the wgmma kernels.
// Everything between the products (scores, softmax, dropout, dS) is fp32.
//
// Tiles (warp_mm's kernels): a block owns TILE<E> query rows, one warp per 16
// rows, and walks the other direction in tiles of the same size. Rows past
// the sequence end are zero-filled on load and masked on store, so any
// sequence length runs.
//
// Head width: every kernel is a template on it, DH, instantiated for 32 and
// 64 (with_head_width below picks the instantiation at run time). Other head
// sizes are padded with zero columns to the next of the two by the caller
// (kernels/layer.py folds the padding into the layer's weights; the wrappers
// of kernels/train_attention.py and kernels/attention.py copy the operands):
// a zero column adds an exact zero to every fp32 sum, so the scores and the
// true columns of the output are those of the unpadded head. The softmax
// scale is the caller's, from the true head size.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace attn {

constexpr float MASK_NEG = -1.0e9f;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a Hopper block can use

template <typename E> struct Tile;
template <> struct Tile<float> { static constexpr int B = 32; };

__device__ __forceinline__ float as_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float as_float(float v) { return v; }
template <typename E> __device__ __forceinline__ E from_float(float v);
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
// Round to the element type and return as float.
template <typename E> __device__ __forceinline__ float round_to(float v) {
    return as_float(from_float<E>(v));
}

__host__ __device__ inline size_t up128(size_t x) { return (x + 127) / 128 * 128; }

// fn(std::integral_constant<int, DH>{}) for the instantiated head width dh;
// cudaErrorInvalidValue for any other.
template <typename Fn>
inline int with_head_width(int dh, Fn&& fn) {
    if (dh == 32) return fn(std::integral_constant<int, 32>{});
    if (dh == 64) return fn(std::integral_constant<int, 64>{});
    return (int)cudaErrorInvalidValue;
}

// Copy `n` elements (n a multiple of 16 bytes, both sides 16-byte aligned), or zeros.
template <typename E>
__device__ __forceinline__ void copy_row(E* dst, const E* src, int n, bool valid, int lane) {
    constexpr int V = 16 / (int)sizeof(E);  // elements in one 16-byte vector
    for (int c = lane * V; c < n; c += 32 * V) {
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (valid) val = *reinterpret_cast<const uint4*>(src + c);
        *reinterpret_cast<uint4*>(dst + c) = val;
    }
}

// Warp-level product on shared-memory tiles, fp32 result in shared memory,
// as exact FMA loops:
//   C[16 x 16*n_tiles] (+)= A[16 x K] * B[K x 16*n_tiles]
//   A_COL: A(i, k) at A[k * lda + i], else A[i * lda + k]
//   B_COL: B(k, j) at B[j * ldb + k], else B[k * ldb + j]
//   ACC:   add to what C holds, else overwrite.
// Ends with __syncwarp(), so the warp may read C.
template <bool A_COL, bool B_COL, bool ACC>
__device__ __forceinline__ void warp_mm(float* C, int ldc, const float* A, int lda, const float* B,
                                        int ldb, int K, int n_tiles) {
    const int lane = threadIdx.x % 32;
    for (int c = lane; c < 16 * n_tiles; c += 32) {
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = ACC ? C[i * ldc + c] : 0.0f;
        for (int k = 0; k < K; ++k) {
            const float b = B_COL ? B[(size_t)c * ldb + k] : B[(size_t)k * ldb + c];
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const float a = A_COL ? A[(size_t)k * lda + i] : A[(size_t)i * lda + k];
                acc[i] = fmaf(a, b, acc[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) C[i * ldc + c] = acc[i];
    }
    __syncwarp();
}

// Scaled and masked score of key column s: columns past the utterance's
// length are REPLACED by -1e9 (a zero-length row is then uniform over all T
// keys); columns past the sequence end (tile edge) take no part at all.
__device__ __forceinline__ float masked_score(float raw, float scale, int s, int len, int T) {
    if (s >= T) return -INFINITY;
    if (s >= len) return MASK_NEG;
    return raw * scale;
}

// Key columns a block has to visit: past an utterance's length every
// probability is an exact zero, except for a zero-length row.
__device__ __forceinline__ int visited_keys(int len, int T) { return len > 0 ? min(len, T) : T; }

// ---- dropout: the counter hash of ops/pallas_train_attention.py::_keep_mask
// (its interpret branch), all in wrapping uint32.
__device__ __forceinline__ uint32_t hash_round(uint32_t x) {
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// Per-(batch row, head) stream key.
__device__ __forceinline__ uint32_t dropout_key(uint32_t seed, int b, int h, int H) {
    uint32_t mixed = seed ^ ((uint32_t)(b * H + h) * 0x9E3779B9u);
    mixed = hash_round(hash_round(mixed));
    return mixed * 0x9E3779B9u;
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, int t, int s, int T, uint32_t thresh) {
    uint32_t x = ((uint32_t)t * (uint32_t)T + (uint32_t)s) ^ key;
    x = hash_round(hash_round(hash_round(x)));
    return x >= thresh;
}

struct DropoutArgs {
    uint32_t seed, thresh;
    float inv_keep;  // fp32(1 / (1 - rate))
    int enabled;
    int row0;  // the batch row that row 0 is (a data-parallel rank's first row of the global batch)
};

// The bf16 training forward (rel_attention_train_fwd.cu): builds its tensor
// maps, launches and returns cudaGetLastError(). D % 64 == 0, D <= 512, and
// the tiles within a block's shared memory (fa::supported).
template <int DH>
int train_fwd_bf16(const void* q_u, const void* q_rot, const void* k, const void* v,
                   const void* k_std, const void* lengths, void* out, void* stats, int B, int T,
                   int H, int D, float scale, DropoutArgs drop, cudaStream_t stream);

// The bf16 training backward (rel_attention_train_bwd.cu): the dq kernel,
// then the dk/dv kernel, which reads the first's delta. Same contract, and
// DH + D <= 288: the dq kernel's [dq_u | dq_rot] accumulator in registers
// (past that, asr_rel_attention_train_bwd_wide).
template <int DH>
int train_bwd_bf16(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std,
                   const void* lengths, const void* d_out, const void* stats, void* delta, void* dq_u,
                   void* dq_rot, void* dk, void* dv, int B, int T, int H, int D, float scale,
                   DropoutArgs drop, cudaStream_t stream);

// The bf16 shift-form inference kernel (rel_attention_shift_bf16.cu): same
// contract. Tensors (B, T, H, DH) contiguous, the table (2T - 1, H, DH).
template <int DH>
int shift_fwd_bf16(const void* q_u, const void* q_v, const void* k, const void* v, const void* pos,
                   const void* lengths, void* out, int B, int T, int H, float scale,
                   cudaStream_t stream);

}  // namespace attn

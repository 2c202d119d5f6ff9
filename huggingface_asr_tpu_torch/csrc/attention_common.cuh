// Shared device helpers of the attention kernels: the mask, the visited keys
// and the dropout hash serve them all (the fp32 training kernels of
// rel_attention_train.cu, the fp32 shift-form inference kernel of
// rel_attention_shift.cu and the kernels on wgmma, attention_wgmma.cuh); the
// cp.async helpers and the 16-lane row reductions serve the two fp32 files.
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

// fn(std::integral_constant<int, DH>{}) for the instantiated head width dh;
// cudaErrorInvalidValue for any other.
template <typename Fn>
inline int with_head_width(int dh, Fn&& fn) {
    if (dh == 32) return fn(std::integral_constant<int, 32>{});
    if (dh == 64) return fn(std::integral_constant<int, 64>{});
    return (int)cudaErrorInvalidValue;
}

// 16-byte cp.async.cg into shared memory (a shared-space address); with
// valid false, src-size 0 fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// max and sum over the 16 lanes of a row group (lanes 0-15 and 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
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

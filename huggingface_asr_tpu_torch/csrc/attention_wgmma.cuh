// What the attention kernels on wgmma + TMA share.
//
// rel_attention_train_fwd.cu (training forward: two walks, dropout, stats)
// and rel_attention.cu (inference: one walk, online softmax) compute the same
// scores, S = [q_u | q_rot] . [k | k_std], with one block structure, set out
// in namespace attn::fa below: a block owns 128 query rows of one (batch row,
// head), two consumer warpgroups of 64 rows and one producer thread;
// [q_u | q_rot] is loaded once and stays, [k | k_std] and v arrive as 64-key
// tiles through a ring of three stages. Every tile is a TMA box of the tensor
// as it lies in device memory, written in the swizzled layout wgmma reads and
// reported to an mbarrier. Rows past the sequence end come back as zeros.
//
// The quad reductions and the P.V step also serve rel_attention_shift_bf16.cu,
// whose ring carries other tiles; the quad reductions, the P packing and the
// O store serve the training backward, rel_attention_train_bwd.cu, whose two
// kernels have their own layout (the keys are resident in one of them).
#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"

namespace attn {

using namespace hopper;

constexpr int BQ = 128;    // query rows of a block
constexpr int BKEY = 64;   // key rows of a tile
constexpr int STAGES = 3;  // key tiles in the ring
constexpr int N_CONSUMER_WARPS = 8;
constexpr int BLOCK_THREADS = 384;  // two consumer warpgroups and the producer's

// The shared-memory layout of a (rows, DH) head tile: one row of DH bf16 values
// is one swizzle row, 64 bytes (DH = 32) or 128 bytes (DH = 64, the layout of
// the 64-column q_rot / k_std chunks), so a TMA box of the head's columns lands
// in the layout wgmma reads (hopper.cuh, head of file).
template <int DH>
struct Head {
    static_assert(DH == 32 || DH == 64, "head tiles are 32 or 64 columns wide");
    static constexpr uint64_t SWIZZLE = DH == 32 ? SWIZZLE_64 : SWIZZLE_128;
    static constexpr CUtensorMapSwizzle MAP_SWIZZLE =
        DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    static constexpr uint32_t SBO = 8 * DH * 2;             // bytes of 8 rows
    static constexpr uint32_t Q_BYTES = BQ * DH * 2;        // a (128, DH) query tile
    static constexpr uint32_t K_BYTES = BKEY * DH * 2;      // a (64, DH) key or value tile
    static constexpr uint32_t WG_Q = 64 * DH * 2;           // one warpgroup's 64 rows of a query tile
};

// Descriptor of a K-major (rows, DH) head tile; + 2 is the next k16 step.
template <int DH>
__device__ __forceinline__ uint64_t head_desc(uint32_t tile) {
    return make_desc(tile, 16, Head<DH>::SBO, Head<DH>::SWIZZLE);
}

// acc += (64 x 16 of rows . DH columns): the k16 steps of a product whose inner
// width is the head's (q_u k^T, dO v^T), both operands K-major head tiles.
template <int DH, int N>
__device__ __forceinline__ void head_product(float (&acc)[N], uint64_t a, uint64_t b, int scale_first) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
        if constexpr (N == 32) wgmma_m64n64k16_ss(acc, a + 2 * kk, b + 2 * kk, kk > 0 || scale_first);
        else wgmma_m64n128k16_ss(acc, a + 2 * kk, b + 2 * kk, kk > 0 || scale_first);
    }
}

// One k16 step of acc (64 x DH) += A (64 x 16, registers) B, B a head tile
// stored (k, n): the transposed B operand.
__device__ __forceinline__ void wgmma_head_rs_bt(float (&acc)[16], const uint32_t (&a)[4], uint64_t b) {
    wgmma_m64n32k16_rs_bt(acc, a, b, 1);
}
__device__ __forceinline__ void wgmma_head_rs_bt(float (&acc)[32], const uint32_t (&a)[4], uint64_t b) {
    wgmma_m64n64k16_rs_bt(acc, a, b, 1);
}

// acc (64 x DH) += A (64 x 64 keys or queries, registers) . tile, a (64, DH)
// head tile read as the transposed B operand. Issued into the open group.
template <int DH>
__device__ __forceinline__ void add_head(float (&acc)[DH / 2], const uint32_t (&a)[4][4], uint32_t tile) {
    const uint64_t b = head_desc<DH>(tile);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_head_rs_bt(acc, a[kk], b + kk * (16 * DH * 2 / 16));
}

// The barriers of a block: one for the query tiles, and a full / empty pair per
// ring stage (8 bytes each, STAGES in a row). Called by every thread of the
// block before it splits into roles.
__device__ __forceinline__ void init_block_barriers(uint32_t q_full, uint32_t full, uint32_t empty) {
    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, N_CONSUMER_WARPS);
        }
        mbar_init_fence();
    }
    __syncthreads();
}

// A row of the accumulator fragment lives in the four lanes of a quad.
__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The 64 x 64 score fragment as the register A operand of the P.V product:
// column pair j of the fragment is pair j % 2 of k16 step j / 2.
__device__ __forceinline__ void pack_p(uint32_t (&pd)[4][4], int j, float a0, float a1, float b0,
                                       float b1) {
    pd[j / 2][2 * (j % 2)] = pack_bf16(a0, a1);
    pd[j / 2][2 * (j % 2) + 1] = pack_bf16(b0, b1);
}

// O (64 x DH, registers) += P (64 x 64, registers) v (64 keys x DH in shared
// memory as TMA wrote it: the transposed B operand). Waits for the product.
template <int DH>
__device__ __forceinline__ void add_pv(float (&o)[DH / 2], const uint32_t (&pd)[4][4], uint32_t v_tile) {
    fence_regs(o);
    wgmma_fence();
    add_head<DH>(o, pd, v_tile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
}

// Write this thread's part of the O fragment: rows ta and ta + 8 of `out`
// (row stride ld elements), columns 8j + cq, 8j + cq + 1 of head h.
template <int DH>
__device__ __forceinline__ void store_o(const float (&o)[DH / 2], float scale_a, float scale_b,
                                        bf16* __restrict__ out, size_t ld, int b, int T, int ta,
                                        int h, int cq) {
    bf16* out_a = out + ((size_t)b * T + ta) * ld + (size_t)h * DH + cq;
    bf16* out_b = out_a + 8 * ld;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
        if (ta < T)
            *reinterpret_cast<uint32_t*>(out_a + 8 * j) = pack_bf16(o[4 * j] * scale_a, o[4 * j + 1] * scale_a);
        if (ta + 8 < T)
            *reinterpret_cast<uint32_t*>(out_b + 8 * j) = pack_bf16(o[4 * j + 2] * scale_b, o[4 * j + 3] * scale_b);
    }
}


// ---- q_rot / k_std past 256 columns: the wide chunks streamed
//
// A block's resident operand ([q_u | q_rot] of 128 query rows in the
// forwards, 144 KB at D = 512; [q_u | q_rot | dO] or [k | k_std | v] in the
// backward, 160 KB) leaves no room for stages that each hold a key tile's
// chunks of the other side (64 KB at D = 512): three of them would take the
// block to 384 KB of its 227. The wide kernels keep the resident operand as
// it is and pass the streamed side's 64-column chunks through a ring of their
// own, apart from the narrow tiles (k, v; q_u, dO), which keep the stage ring
// without chunks and stay for the whole tile. A chunk slot is 8 KB (64 rows x
// 64 columns in the 128-byte swizzle) under a full/empty mbarrier pair; the
// producer thread fills the slots in the order the consumers take them, and a
// slot goes back as soon as the product that reads it is done. The score
// product is then 1 + nc groups committed one after another (the narrow
// part with the first chunk), each chunk's slot released while the next
// chunk's products run: the resident chunks are the A operand, the slot the
// B operand, as in the stage form.
namespace wide {

constexpr int CW = 64;                          // columns of a chunk
constexpr uint32_t SLOT = BKEY * CW * 2;        // one 64-row chunk
constexpr int MIN_SLOTS = 2, MAX_SLOTS = 8;
constexpr int MAX_D = 512;                      // the widest q_rot the kernels hold resident
constexpr uint32_t BAR_BYTES = 8 * 2 * MAX_SLOTS;  // full and empty barriers, MAX_SLOTS each

// Chunk slots that fit beside `fixed` bytes of a block's shared memory (the
// alignment slack included), at most MAX_SLOTS; 0 where fewer than MIN_SLOTS fit.
__host__ __device__ inline int slots_beside(size_t fixed) {
    if (fixed + BAR_BYTES + MIN_SLOTS * SLOT > MAX_SMEM) return 0;
    const size_t n = (MAX_SMEM - fixed - BAR_BYTES) / SLOT;
    return n < (size_t)MAX_SLOTS ? (int)n : MAX_SLOTS;
}

struct Ring {
    uint32_t base = 0, full = 0, empty = 0;  // the slots; full and empty barriers (8 bytes each)
    int n = 0;
    __device__ uint32_t slot(int i) const { return base + i * SLOT; }
};

// One side's place in the ring's sequence: the slot, and the parity of the
// phase its barriers are in.
struct Cursor {
    int i = 0;
    uint32_t phase = 0;
    __device__ void next(int n) {
        if (++i == n) {
            i = 0;
            phase ^= 1;
        }
    }
};

// Thread 0, before the block splits into roles.
__device__ __forceinline__ void init_ring(const Ring& r, uint32_t consumer_warps) {
    for (int s = 0; s < r.n; ++s) {
        mbar_init(r.full + 8 * s, 1);
        mbar_init(r.empty + 8 * s, consumer_warps);
    }
}

// Producer: the next chunk into the next slot, once the consumers gave it
// back; load(dst, bar) starts the TMA copy.
template <typename Load>
__device__ __forceinline__ void put(const Ring& r, Cursor& c, Load&& load) {
    mbar_wait(r.empty + 8 * c.i, c.phase ^ 1);
    mbar_arrive_expect_tx(r.full + 8 * c.i, SLOT);
    load(r.slot(c.i), r.full + 8 * c.i);
    c.next(r.n);
}

// Consumers: acc (64 x 64) += sum over the nc chunks of A_c . slot^T, A_c the
// resident K-major chunk at a + c * a_step, the slots the next nc of the ring.
// first() starts the products that open the first group (the narrow part,
// whose first step overwrites acc) into registers the caller fenced. Returns
// with every product done and every slot given back (one arrival per warp).
template <typename First>
__device__ __forceinline__ void chunk_products(float (&acc)[32], uint32_t a, uint32_t a_step, const Ring& r,
                                               Cursor& c, int nc, int lane, First&& first) {
    int prev = 0;
    for (int k = 0; k < nc; ++k) {
        mbar_wait(r.full + 8 * c.i, c.phase);
        fence_regs(acc);
        wgmma_fence();
        if (k == 0) first();
        const uint64_t da = make_desc(a + k * a_step, 16, 1024, SWIZZLE_128);
        const uint64_t db = make_desc(r.slot(c.i), 16, 1024, SWIZZLE_128);
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) wgmma_m64n64k16_ss(acc, da + 2 * kk, db + 2 * kk, 1);
        wgmma_commit();
        if (k > 0) {
            wgmma_wait<1>();  // the previous chunk's products are done: its slot can go
            fence_regs(acc);
            if (lane == 0) mbar_arrive(r.empty + 8 * prev);
        }
        prev = c.i;
        c.next(r.n);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(r.empty + 8 * prev);
}

}  // namespace wide

namespace fa {  // the factored form: S = [q_u | q_rot] . [k | k_std]

constexpr int CW = 64;  // columns of one 128-byte-swizzled chunk of q_rot / k_std
constexpr uint32_t QR_CHUNK = BQ * CW * 2, KS_CHUNK = BKEY * CW * 2;

struct Maps {
    CUtensorMap qu, qrot, k, v, kstd;
};

// Shared memory past the 1024-byte aligned base, for D = 64 * nc:
//   q_u | q_rot chunks | STAGES x (k | k_std chunks | v) | barriers
// and with WIDE (D past 256):
//   q_u | q_rot chunks | STAGES x (k | v) | n_slots chunk slots | barriers | chunk barriers
template <int DH>
__host__ __device__ inline uint32_t stage_bytes(int nc) { return 2 * Head<DH>::K_BYTES + nc * KS_CHUNK; }
template <int DH>
__host__ __device__ inline uint32_t smem_bytes(int nc) {
    return 1024 + Head<DH>::Q_BYTES + nc * QR_CHUNK + STAGES * stage_bytes<DH>(nc) + 8 * (1 + 2 * STAGES);
}
// WIDE: the bytes beside the chunk slots, the slots that fit, and the total.
template <int DH>
__host__ __device__ inline uint32_t wide_fixed_bytes(int nc) {
    return 1024 + Head<DH>::Q_BYTES + nc * QR_CHUNK + STAGES * stage_bytes<DH>(0) + 8 * (1 + 2 * STAGES);
}
template <int DH>
__host__ __device__ inline int wide_slots(int nc) { return wide::slots_beside(wide_fixed_bytes<DH>(nc)); }
template <int DH>
__host__ __device__ inline uint32_t wide_smem_bytes(int nc) {
    return wide_fixed_bytes<DH>(nc) + wide_slots<DH>(nc) * wide::SLOT + wide::BAR_BYTES;
}

template <int DH, bool WIDE = false>
struct Smem {
    int nc, stage_nc;  // chunks of q_rot; chunks of k_std in a stage (0 with WIDE)
    uint32_t qu, qr, ring, stage_sz, q_full, full, empty;
    wide::Ring chunks;  // WIDE only
    __device__ Smem(const unsigned char* raw, int D) {
        nc = D / CW;
        stage_nc = WIDE ? 0 : nc;
        qu = (smem_u32(raw) + 1023u) & ~1023u;
        qr = qu + Head<DH>::Q_BYTES;
        ring = qr + nc * QR_CHUNK;
        stage_sz = stage_bytes<DH>(stage_nc);
        uint32_t at = ring + STAGES * stage_sz;
        if constexpr (WIDE) {
            chunks.base = at;
            chunks.n = wide_slots<DH>(nc);
            at += chunks.n * wide::SLOT;
        }
        q_full = at;
        full = q_full + 8;
        empty = full + 8 * STAGES;
        if constexpr (WIDE) {
            chunks.full = empty + 8 * STAGES;
            chunks.empty = chunks.full + 8 * wide::MAX_SLOTS;
        }
    }
    __device__ uint32_t stage(int it) const { return ring + (it % STAGES) * stage_sz; }
    __device__ uint32_t v_tile(int it) const { return stage(it) + Head<DH>::K_BYTES + stage_nc * KS_CHUNK; }
    __device__ uint32_t full_bar(int it) const { return full + 8 * (it % STAGES); }
    __device__ uint32_t empty_bar(int it) const { return empty + 8 * (it % STAGES); }
};

template <int DH, bool WIDE>
__device__ __forceinline__ void init_barriers(const Smem<DH, WIDE>& sm) {
    if constexpr (WIDE) {
        if (threadIdx.x == 0) wide::init_ring(sm.chunks, N_CONSUMER_WARPS);
    }
    init_block_barriers(sm.q_full, sm.full, sm.empty);
}

// The producer thread: the query tile once, then the ring kept full, walk
// after walk over the n_keys visited keys; v rides along from walk `v_from` on.
// WIDE: a stage holds k (and v), and each key tile's k_std chunks follow it
// through the chunk ring.
template <int DH, bool WIDE>
__device__ __forceinline__ void produce(const Smem<DH, WIDE>& sm, const Maps& maps, int b, int h, int t0, int D,
                                        int n_keys, int walks, int v_from) {
    constexpr uint32_t KH = Head<DH>::K_BYTES;
    const int nc = sm.nc, snc = sm.stage_nc;
    mbar_arrive_expect_tx(sm.q_full, Head<DH>::Q_BYTES + nc * QR_CHUNK);
    tma_load_3d(sm.qu, &maps.qu, sm.q_full, h * DH, t0, b);
    for (int c = 0; c < nc; ++c) tma_load_3d(sm.qr + c * QR_CHUNK, &maps.qrot, sm.q_full, h * D + c * CW, t0, b);
    wide::Cursor cur;
    int it = 0;
    for (int walk = 0; walk < walks; ++walk) {
        const bool with_v = walk >= v_from;
        for (int s0 = 0; s0 < n_keys; s0 += BKEY, ++it) {
            const uint32_t stage = sm.stage(it), bar = sm.full_bar(it);
            mbar_wait(sm.empty_bar(it), ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(bar, KH + snc * KS_CHUNK + (with_v ? KH : 0));
            tma_load_3d(stage, &maps.k, bar, h * DH, s0, b);
            for (int c = 0; c < snc; ++c)
                tma_load_2d(stage + KH + c * KS_CHUNK, &maps.kstd, bar, c * CW, s0);
            if (with_v) tma_load_3d(sm.v_tile(it), &maps.v, bar, h * DH, s0, b);
            if constexpr (WIDE) {
                for (int c = 0; c < nc; ++c)
                    wide::put(sm.chunks, cur, [&](uint32_t dst, uint32_t cbar) {
                        tma_load_2d(dst, &maps.kstd, cbar, c * CW, s0);
                    });
            }
        }
    }
}

// S (this warpgroup's 64 rows x the stage's 64 keys) = [q_u | q_rot] . [k | k_std]^T
// Started and committed as one group; the caller waits for it.
template <int DH>
__device__ __forceinline__ void start_scores(float (&s)[32], uint32_t qu, uint32_t qr,
                                             uint32_t stage, int nc) {
    fence_regs(s);
    wgmma_fence();
    head_product<DH>(s, head_desc<DH>(qu), head_desc<DH>(stage), 0);
    for (int c = 0; c < nc; ++c) {
        const uint64_t a_r = make_desc(qr + c * QR_CHUNK, 16, 1024, SWIZZLE_128);
        const uint64_t b_r = make_desc(stage + Head<DH>::K_BYTES + c * KS_CHUNK, 16, 1024, SWIZZLE_128);
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) wgmma_m64n64k16_ss(s, a_r + 2 * kk, b_r + 2 * kk, 1);
    }
    wgmma_commit();
}

// The same S with WIDE: the k_std chunks from the chunk ring. Returns with S done.
template <int DH>
__device__ __forceinline__ void wide_scores(float (&s)[32], uint32_t qu, uint32_t qr, uint32_t stage,
                                            const Smem<DH, true>& sm, wide::Cursor& cur, int lane) {
    fence_regs(s);
    wide::chunk_products(s, qr, QR_CHUNK, sm.chunks, cur, sm.nc, lane,
                         [&] { head_product<DH>(s, head_desc<DH>(qu), head_desc<DH>(stage), 0); });
}

// ---- host

// The kernels take D in whole 64-column chunks: up to 256 with k_std in the
// stages (WIDE false), past that up to wide::MAX_D with the chunk ring
// (wide_path(D)); either way the tiles within a block's shared memory.
inline bool wide_path(int D) { return D > 256; }
template <int DH>
inline bool supported(int B, int H, int D) {
    if (D % CW != 0 || D < CW || B > 65535 || H > 65535) return false;
    if (!wide_path(D)) return smem_bytes<DH>(D / CW) <= MAX_SMEM;
    return D <= wide::MAX_D && wide_slots<DH>(D / CW) >= wide::MIN_SLOTS && wide_smem_bytes<DH>(D / CW) <= MAX_SMEM;
}
template <int DH>
inline uint32_t block_smem(int D) { return wide_path(D) ? wide_smem_bytes<DH>(D / CW) : smem_bytes<DH>(D / CW); }

// Tensor maps of q_u, k, v as (B, T, H * DH) views whose rows are ld_qkv
// elements apart (columns of a wider buffer are fine), q_rot (B, T, H * D)
// and k_std (T, D), both contiguous. Coordinates are (column, t, b); rows
// past T read as zeros.
template <int DH>
inline cudaError_t make_maps(Maps* m, const void* q_u, const void* q_rot, const void* k,
                             const void* v, const void* k_std, int B, int T, int H, int D,
                             int ld_qkv) {
    const cuuint64_t dims_h[3] = {(cuuint64_t)H * DH, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_h[2] = {(cuuint64_t)ld_qkv * 2, (cuuint64_t)T * ld_qkv * 2};
    const cuuint64_t dims_r[3] = {(cuuint64_t)H * D, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_r[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)T * H * D * 2};
    const cuuint64_t dims_s[2] = {(cuuint64_t)D, (cuuint64_t)T};
    const cuuint64_t strides_s[1] = {(cuuint64_t)D * 2};
    const cuuint32_t box_qu[3] = {DH, BQ, 1}, box_qr[3] = {CW, BQ, 1}, box_kv[3] = {DH, BKEY, 1};
    const cuuint32_t box_ks[2] = {CW, BKEY};
    constexpr CUtensorMapSwizzle SW = Head<DH>::MAP_SWIZZLE;
    cudaError_t err = tensor_map_bf16(&m->qu, q_u, 3, dims_h, strides_h, box_qu, SW);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m->qrot, q_rot, 3, dims_r, strides_r, box_qr, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess) err = tensor_map_bf16(&m->k, k, 3, dims_h, strides_h, box_kv, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&m->v, v, 3, dims_h, strides_h, box_kv, SW);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m->kstd, k_std, 2, dims_s, strides_s, box_ks, CU_TENSOR_MAP_SWIZZLE_128B);
    return err;
}

// Give `kernel` its shared memory; the launch is <<<grid(T), BLOCK_THREADS, block_smem<DH>(D)>>>.
template <int DH, typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int D) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)block_smem<DH>(D));
}
inline dim3 grid(int B, int T, int H) { return dim3(ceil_div(T, BQ), H, B); }

}  // namespace fa
}  // namespace attn

// Relative-position attention for INFERENCE, shift form: the entry point and
// the fp32 kernel.
//
// Replaces ops/pallas_attention.py::_rel_attn_kernel of the JAX package:
//
//   S[t, s] = (q_u[t] . k[s] + q_v[t] . pos[t - s + T - 1, h]) / sqrt(dh)
//   S[:, s >= length] := -1e9;  P = softmax(S) in fp32, rounded to v's type;  out = P v
//
// The TPU kernel multiplies q_v against the whole reversed (2T, dh) table and
// barrel-shifts every row by log2(T) masked rolls, because a per-row lane
// offset does not lower there. On the GPU a per-row offset is an index: the
// table rows t - s + T - 1 of a (query tile, key tile) pair form one band of
// 127 rows, and a thread whose scores are 4 consecutive queries by 4
// consecutive keys needs 7 of them, one for each diagonal of its 4 x 4 tile.
//
// bf16 inputs run rel_attention_shift_bf16.cu (wgmma + TMA, two walks: P is
// rounded to bf16 from the final max and sum). In fp32 the JAX kernel's
// rounding of P to v's type is no rounding at all, so this kernel walks the
// keys once.
//
// What bounds the fp32 kernel on the H100: fp32 FFMA at 67 TFLOP/s. Each score
// costs 3 dh FMAs (q_u k, q_v band, P v) against a few bytes; the design keeps
// the FFMA pipes fed:
//
//   block     64 query rows of one (b, h), 256 threads, two blocks an SM
//             (shift_smem below). q_u and q_v stay in shared memory. A thread
//             holds S for rows row0 .. row0 + 3 and keys 4 cg .. 4 cg + 3 of
//             a 64-key tile (row0 = 8 warp + 4 half, cg = lane % 16), and out
//             for those rows and columns VW cg .. VW cg + VW - 1.
//   one walk  the online row max and sum of FlashAttention-2: P v
//             accumulates exp(x - m_run) v in registers, rescaled when m_run
//             moves, divided by the row sum at the end. Equal to the plain
//             version's P v with P = exp(x - m) / l up to fp32 rounding.
//   products  register-tiled FFMA with float4 operands out of shared memory:
//             S = q_u k^T reads 4 q_u and 4 k vectors for 64 FMAs; the
//             positional term reads 4 q_v and the 7 band vectors of the
//             thread's diagonals for 64 FMAs (band row (t - t0) - (s - s0) +
//             63, so no product of G = q_v band^T is formed and none is
//             wasted); P v reads 4 P vectors and one v vector a key.
//   the band  key tile j needs table rows t0 + T - 1 - 64 j + [-63, 63]: the
//             64-row chunks j (upper half) and j + 1 (lower half) of the
//             sequence chunk m = rows t0 + T - 1 - 64 m + [0, 64). Tile j + 1
//             reuses chunk j + 1, so each tile brings one new chunk into a
//             ring of two. Rows outside [0, 2T - 1) are zeros; they belong
//             only to pairs with t >= T or s >= T, which are masked or never
//             written.
//   loads     16-byte cp.async.cg, each overlapping the other phase of the
//             walk: v of tile j during S of tile j, k and the band chunk of
//             tile j + 1 during the softmax and P v of tile j. Three barriers
//             a tile.
//   layout    no padding (two blocks of 114,944 bytes fill an SM's 228 KB):
//             conflicts are avoided by XOR-swizzling the 16-byte chunks of a
//             row. k rows and band rows are stored in the order 16 (x & 3) +
//             (x >> 2) of their index x, so that the 16 lanes of a row group,
//             which read keys 4 cg + j or diagonals 64 + row0 - 4 cg + d, hit
//             16 consecutive stored rows, swizzled by the row's low 3 bits; q
//             and P rows by bit 2 of the row (the two row groups of a warp).
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 64;        // query rows a block
constexpr int BN = 64;        // keys a tile, and rows of a band chunk
constexpr int ALIGN = 256;    // the layout's base alignment: each row then starts at a multiple of its size
static_assert(BM == BN, "q, k, v and a band chunk are tiles of the same 64 rows");

// Shared-memory bytes at head width dh: q_u, q_v (BM rows), k, v (BN rows), two band chunks (BN rows each),
// P (BM x BN), and the slack that aligns the base. tests/test_torch_fp32_k5_walk.py recomputes it: change
// both together. Two blocks an SM need 2 (bytes + 1 KB reserved) <= 228 KB.
constexpr size_t shift_smem(int dh) { return ALIGN + 4 * (size_t)(2 * BM * dh + 4 * BN * dh + BM * BN); }

__device__ __forceinline__ void lds4(float (&d)[4], uint32_t addr) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]) : "r"(addr));
}
__device__ __forceinline__ void lds2(float (&d)[2], uint32_t addr) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(d[0]), "=f"(d[1]) : "r"(addr));
}
__device__ __forceinline__ void sts4(uint32_t addr, const float (&d)[4]) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(d[0]), "f"(d[1]), "f"(d[2]),
                 "f"(d[3]) : "memory");
}

// stored row of key (or band row) x of a 64-row tile
__device__ __forceinline__ int perm(int x) { return 16 * (x & 3) + (x >> 2); }

// s[i][j] += q_u[row0 + i] . k[4 cg + j]: qa is row row0's address with its swizzle, ka stored row cg's
// (key 4 cg + j is stored row 16 j + cg, whose swizzle is cg's).
template <int DH>
__device__ __forceinline__ void content_scores(float (&s)[4][4], uint32_t qa, uint32_t ka) {
    constexpr uint32_t ROW = DH * 4;
#pragma unroll
    for (int c = 0; c < DH / 4; ++c) {
        float a[4][4], b[4][4];
        const uint32_t q = qa ^ (uint32_t)(c << 4), kk = ka ^ (uint32_t)(c << 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) lds4(a[i], q + i * ROW);
#pragma unroll
        for (int j = 0; j < 4; ++j) lds4(b[j], kk + j * 16 * ROW);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i][e], b[j][e], s[i][j]);
    }
}

// s[i][j] += q_v[row0 + i] . band[diagonal i - j]: bp[d] is the address (with its swizzle) of the band row
// of diagonal d - 3.
template <int DH>
__device__ __forceinline__ void positional_scores(float (&s)[4][4], uint32_t qa, const uint32_t (&bp)[7]) {
    constexpr uint32_t ROW = DH * 4;
#pragma unroll
    for (int c = 0; c < DH / 4; ++c) {
        float a[4][4], b[7][4];
        const uint32_t q = qa ^ (uint32_t)(c << 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) lds4(a[i], q + i * ROW);
#pragma unroll
        for (int d = 0; d < 7; ++d) lds4(b[d], bp[d] ^ (uint32_t)(c << 4));
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i][e], b[i - j + 3][e], s[i][j]);
    }
}

// o[i][w] += sum over the tile's keys of P[row0 + i][key] v[key][VW cg + w]: pa is row row0's address in
// P with its swizzle, va the address of column VW cg of v's first row.
template <int DH>
__device__ __forceinline__ void pv(float (&o)[4][DH / 16], uint32_t pa, uint32_t va) {
    constexpr int VW = DH / 16;
    constexpr uint32_t ROW = DH * 4;
#pragma unroll
    for (int c = 0; c < BN / 4; ++c) {
        float a[4][4];
        const uint32_t p = pa ^ (uint32_t)(c << 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) lds4(a[i], p + i * BN * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float b[VW];
            if constexpr (VW == 4)
                lds4(b, va + (4 * c + e) * ROW);
            else
                lds2(b, va + (4 * c + e) * ROW);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int w = 0; w < VW; ++w) o[i][w] = fmaf(a[i][e], b[w], o[i][w]);
        }
    }
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 2)
shift_fp32_kernel(const float* __restrict__ q_u, const float* __restrict__ q_v, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ pos, const int* __restrict__ lengths,
                  float* __restrict__ out, int T, int H, float scale) {
    constexpr int NC = DH / 4;           // 16-byte chunks of a row
    constexpr int PER = BM * NC / THREADS;  // chunks a thread copies of a 64-row tile
    constexpr int VW = DH / 16;          // out columns a thread
    constexpr uint32_t ROW = DH * 4, TILE = BN * ROW;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const uint32_t QU = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
    const uint32_t QV = QU + TILE, KS = QV + TILE, VS = KS + TILE, BANDS = VS + TILE, PS = BANDS + 2 * TILE;

    const int t0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, half = lane / 16, cg = lane % 16;
    const int row0 = warp * 8 + half * 4;
    const int len = lengths[b], n_keys = visited_keys(len, T), n_tiles = (n_keys + BN - 1) / BN;
    const size_t hs = (size_t)H * DH;  // row stride of (B, T, H, dh) and of the (2T - 1, H, dh) table
    const size_t at = (size_t)b * T * hs + (size_t)h * DH;
    const float* k_b = k + at;
    const float* v_b = v + at;
    const float* pos_h = pos + (size_t)h * DH;

    // copies of 64-row tiles: rows of q (swizzled by bit 2 of the row), keys, band rows
    auto load_q = [&](uint32_t dst, const float* src) {
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = threadIdx.x + u * THREADS, r = i / NC, c = i % NC;
            const bool ok = t0 + r < T;
            cp_async16(dst + r * ROW + ((c ^ ((r >> 2) & 1)) << 4), src + (size_t)(ok ? t0 + r : 0) * hs + 4 * c, ok);
        }
    };
    auto load_k = [&](int s0) {
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = threadIdx.x + u * THREADS, r = i / NC, c = i % NC, kr = perm(r);
            const bool ok = s0 + r < T;
            cp_async16(KS + kr * ROW + ((c ^ (kr & 7)) << 4), k_b + (size_t)(ok ? s0 + r : 0) * hs + 4 * c, ok);
        }
    };
    auto load_v = [&](int s0) {
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = threadIdx.x + u * THREADS, r = i / NC, c = i % NC;
            const bool ok = s0 + r < T;
            cp_async16(VS + r * ROW + (c << 4), v_b + (size_t)(ok ? s0 + r : 0) * hs + 4 * c, ok);
        }
    };
    auto load_band = [&](int m) {  // chunk m: table rows t0 + T - 1 - 64 m + [0, 64), into slot m % 2
        const uint32_t slot = BANDS + (m & 1) * TILE;
#pragma unroll
        for (int u = 0; u < PER; ++u) {
            const int i = threadIdx.x + u * THREADS, r = i / NC, c = i % NC, br = perm(r);
            const int row = t0 + T - 1 - BN * m + r;
            const bool ok = row >= 0 && row < 2 * T - 1;
            cp_async16(slot + br * ROW + ((c ^ (br & 7)) << 4), pos_h + (size_t)(ok ? row : 0) * hs + 4 * c, ok);
        }
    };

    load_q(QU, q_u + at);
    load_q(QV, q_v + at);
    load_k(0);
    load_band(0);
    load_band(1);
    cp_async_commit();

    const uint32_t xq = (uint32_t)half << 4;  // the swizzle of this thread's q and P rows
    const uint32_t qu_a = (QU + row0 * ROW) | xq, qv_a = (QV + row0 * ROW) | xq;
    const uint32_t k_a = (KS + cg * ROW) | ((uint32_t)(cg & 7) << 4);
    const uint32_t p_a = (PS + row0 * BN * 4) | xq;
    const uint32_t v_a = VS + VW * cg * 4;
    float o[4][VW], m_run[4], l_part[4];  // l_part: this thread's keys' share of the row sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_run[i] = -INFINITY;
        l_part[i] = 0.0f;
#pragma unroll
        for (int w = 0; w < VW; ++w) o[i][w] = 0.0f;
    }

    for (int j = 0; j < n_tiles; ++j) {
        const int s0 = j * BN;
        cp_async_wait<0>();
        __syncthreads();  // q, k and band chunks j, j + 1 in place; every warp is done with v and P of tile j - 1
        load_v(s0);
        cp_async_commit();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.0f;
        content_scores<DH>(s, qu_a, k_a);
        // diagonal d - 3: band row 64 + row0 - 4 cg + d - 3 of chunks j + 1 (rows 0-63) and j (64-127)
        uint32_t bp[7];
#pragma unroll
        for (int d = 0; d < 7; ++d) {
            const int x = BN + row0 - 4 * cg + d - 3, br = perm(x & (BN - 1));
            bp[d] = (BANDS + (uint32_t)((j + (x < BN)) & 1) * TILE + br * ROW) | ((uint32_t)(br & 7) << 4);
        }
        positional_scores<DH>(s, qv_a, bp);
        __syncthreads();  // every warp is done with k and band chunk j
        if (j + 1 < n_tiles) {
            load_k(s0 + BN);
            load_band(j + 2);
        }
        cp_async_commit();

        // online softmax over this key tile
        float mx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            mx[i] = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                s[i][jj] = masked_score(s[i][jj], scale, s0 + 4 * cg + jj, len, T);
                mx[i] = fmaxf(mx[i], s[i][jj]);
            }
            mx[i] = group_max(mx[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float m_new = fmaxf(m_run[i], mx[i]);
            const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile (m_run = -inf)
            m_run[i] = m_new;
            l_part[i] *= alpha;
#pragma unroll
            for (int w = 0; w < VW; ++w) o[i][w] *= alpha;
            float p[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                p[jj] = expf(s[i][jj] - m_new);
                l_part[i] += p[jj];
            }
            sts4((p_a ^ (uint32_t)(cg << 4)) + i * BN * 4, p);
        }
        cp_async_wait<1>();
        __syncthreads();  // v of the tile and every row of P in place
        pv<DH>(o, p_a, v_a);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float l = group_sum(l_part[i]);
        const int t = t0 + row0 + i;
        if (t >= T) continue;
        float* dst = out + at + (size_t)t * hs + VW * cg;
        if constexpr (VW == 4)
            *reinterpret_cast<float4*>(dst) = make_float4(o[i][0] / l, o[i][1] / l, o[i][2] / l, o[i][3] / l);
        else
            *reinterpret_cast<float2*>(dst) = make_float2(o[i][0] / l, o[i][1] / l);
    }
}

template <int DH>
int run(const void* q_u, const void* q_v, const void* k, const void* v, const void* pos, const void* lengths,
        void* out, int B, int T, int H, float scale, cudaStream_t stream) {
    const size_t bytes = shift_smem(DH);
    static_assert(shift_smem(64) <= MAX_SMEM, "the fp32 shift kernel's tiles fit a block's shared memory");
    cudaError_t err = cudaFuncSetAttribute(shift_fp32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(shift_fp32_kernel<DH>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + BM - 1) / BM, H, B);
    shift_fp32_kernel<DH><<<grid, THREADS, bytes, stream>>>(
        (const float*)q_u, (const float*)q_v, (const float*)k, (const float*)v, (const float*)pos,
        (const int*)lengths, (float*)out, T, H, scale);
    return (int)cudaGetLastError();
}

}  // namespace

// q_u, q_v, k, v, out: (B, T, H, dh) contiguous; pos: (2T - 1, H, dh); lengths: (B,) int32.
// dh = 32 or 64 (the wrapper pads other head sizes with zero columns).
ASR_API int asr_rel_attention_shift(const void* q_u, const void* q_v, const void* k, const void* v,
                                    const void* pos, const void* lengths, void* out, int B, int T,
                                    int H, int dh, int is_bf16, float scale, void* stream) {
    if (T < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        return is_bf16 ? shift_fwd_bf16<DH>(q_u, q_v, k, v, pos, lengths, out, B, T, H, scale, st)
                       : run<DH>(q_u, q_v, k, v, pos, lengths, out, B, T, H, scale, st);
    });
}

// Relative-position attention for TRAINING: the bf16 backward kernels.
//
// Replaces ops/pallas_train_attention.py::_bwd_kernel of the JAX package (the
// function, its rounding points and the dropout hash are set out at the head
// of rel_attention_train.cu, which keeps the fp32 backward):
//
//   S   = ([q_u | q_rot] . [k | k_std]) * scale,  columns >= length := -1e9
//   P32 = exp(S - m) / l           from the forward's saved (row max, row sum)
//   Pd  = keep ? bf16(bf16(P32) * bf16(1 / (1 - rate))) : 0;   dv = Pd^T dO
//   dP  = keep ? (dO v^T) * fp32(1 / (1 - rate)) : 0
//   delta = rowsum(dP * P32);  dS = bf16(P32 * (dP - delta) * scale)
//   dq_u = dS k;  dq_rot = dS k_std;  dk = dS^T q_u
//
// What bounds it on the H100: by the roofline, bytes (q_rot is read and
// dq_rot written once, 33 MB each at B=32, T=250: 28 us). In practice, the
// fp32 work on every score (mask, exp, three hash rounds, the dS chain), done
// three times per (query, key) pair, and after it the products of inner width
// dh + D (288 at the flagship's widths, 64 + 192 at the 176-wide configs'
// padded ones); so both must run at once, and nothing else may cost a cycle.
// Head width dh = 32 or 64, a template parameter (the wrapper pads other head
// sizes with zero columns).
//
// What the design does about it. Two kernels, each a block of two consumer
// warpgroups (64 rows each) and one producer thread; every operand tile is a
// TMA box of the tensor as it lies in device memory, in the swizzled layout
// wgmma reads, through a ring of three stages under full/empty mbarriers;
// every product runs on wgmma with its accumulator in registers, and every
// score is worked on in the accumulator fragment. No fp32 tile touches shared
// memory. While one warpgroup works on its scores the other's products run.
//   * dq kernel, owner of 128 query rows: [q_u | q_rot] and dO stay resident,
//     64-key tiles of [k | k_std] and v pass through the ring, twice. Walk 1
//     takes delta (S and dP = dO v^T side by side in registers, one quad
//     reduction at its end, written out for the other kernel); walk 2 forms
//     dS on the fragment and feeds it as the register A operand of
//     [dq_u | dq_rot] += dS [k | k_std], the key tile read as the transposed B
//     operand. That accumulator is dh / 2 + 32 * D / 64 registers a thread beside
//     S's and dP's 32 each, so the consumers take 240 registers and the
//     producer's warpgroup gives its own up (setmaxnreg). dq_rot leaves as
//     16-byte stores (quad_transpose).
//   * dk/dv kernel, owner of 128 keys: [k | k_std] and v stay resident, 64-row
//     tiles of [q_u | q_rot] and dO pass through the ring. The scores are
//     taken transposed, S^T = [k | k_std] [q_u | q_rot]^T, and dP^T = v dO^T,
//     so that Pd^T and dS^T come out of the accumulator fragment already in
//     the register A layout of dv += Pd^T dO and dk += dS^T q_u. Row max, 1 /
//     row sum and delta are then per COLUMN of the fragment: each warpgroup
//     puts the tile's 64 of each into a small shared array (double buffered,
//     one named barrier per tile). The length mask is per row.
//   * Key tiles at or past the visited keys (see visited_keys) have P = 0:
//     the dq kernel never loads them, the dk/dv kernel writes zeros. Query
//     rows past T in a ragged last tile get P = 0 (max := +inf); rows and
//     columns past T arrive as the TMA's zeros and are never stored.
//   * dh + D past 288 (WIDE, D up to 512): the dq kernel's [dq_u | dq_rot]
//     accumulator does not fit its registers (576 columns at D = 512), nor
//     past D = 256 the resident operand beside stages of k_std chunks
//     (160 + 3 x 80 KB at 512). Both
//     kernels keep their resident operand and take the streamed side's wide
//     chunks through attention_wgmma.cuh's chunk ring; the stages hold the
//     narrow tiles only (two of them). The dq kernel accumulates dq_u alone
//     and writes dS, bf16 (the rounding its products read anyway), to a
//     (B, T, H, ld) scratch that the caller zeroes; dq_rot = dS k_std is then
//     one GEMM (gemm.cuh, from the Python wrapper) over rows (b, t, h), whose
//     output rows are dq_rot's own order.
//   * S is still computed three times per pair; taking delta as rowsum(dO O)
//     would save one, but differs from the TPU kernel at bf16 level.
#include "attention_wgmma.cuh"

namespace attn {

namespace {

constexpr int NWG = 2;             // consumer warpgroups of a block
constexpr int ROWS = 64 * NWG;     // rows a block owns
constexpr int CW = fa::CW;         // columns of one 128-byte-swizzled chunk
constexpr int THREADS = 128 * (NWG + 1);
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr int ACC_COLS = 288;      // [dq_u | dq_rot] columns a dq thread's registers hold: DH + D <= 288
constexpr uint32_t RES_W = ROWS * CW * 2, T_W = BKEY * CW * 2, WG_W = 64 * CW * 2;  // a wide chunk: resident, ring, one warpgroup's

// The narrow (head-wide) tiles of head width DH: resident (ROWS rows), in the
// ring (64 rows), one warpgroup's rows of a resident tile.
template <int DH>
struct Narrow {
    static constexpr uint32_t RES = ROWS * DH * 2, RING = BKEY * DH * 2, WG = 64 * DH * 2;
    static constexpr int MAX_CHUNKS = (ACC_COLS - DH) / CW;  // dq_rot chunks beside dq_u in registers
};

struct Maps {
    CUtensorMap qu, qrot, k, kstd, v, d_o;
};

// Shared memory of both kernels past the 1024-byte aligned base, D = 64 * nc:
//   resident: narrow | nc wide chunks | second narrow
//             (dq: q_u, q_rot, dO;  dk/dv: k, k_std, v)
//   ring:     NS x (narrow | stage_nc wide chunks | second narrow)
//             (dq: k, k_std, v;     dk/dv: q_u, q_rot, dO)
//   WIDE:     the chunk ring's slots (stage_nc = 0, NS = 2)
//   barriers: resident full, NS x full, NS x empty (WIDE: the chunk ring's)
//   columns:  per warpgroup 2 x 3 x 64 floats (dk/dv kernel only)
constexpr int COL_FLOATS = NWG * 2 * 3 * BKEY;
template <bool WIDE> constexpr int n_stages() { return WIDE ? 2 : STAGES; }
template <int DH, bool WIDE>
inline uint32_t fixed_bytes(int nc) {
    constexpr int NS = n_stages<WIDE>();
    return 1024 + 2 * Narrow<DH>::RES + nc * RES_W + NS * (2 * Narrow<DH>::RING + (WIDE ? 0 : nc) * T_W) +
           8 * (2 + 2 * NS) + 4 * COL_FLOATS;
}
template <int DH>
__host__ __device__ inline int wide_slots(int nc) {
    constexpr int NS = n_stages<true>();
    return wide::slots_beside(1024 + 2 * Narrow<DH>::RES + nc * RES_W + NS * 2 * Narrow<DH>::RING +
                              8 * (2 + 2 * NS) + 4 * COL_FLOATS);
}
template <int DH, bool WIDE>
inline uint32_t smem_bytes(int nc) {
    return fixed_bytes<DH, WIDE>(nc) + (WIDE ? wide_slots<DH>(nc) * wide::SLOT + wide::BAR_BYTES : 0);
}

template <int DH, bool WIDE>
struct Smem {
    static constexpr int NS = n_stages<WIDE>();
    int nc, stage_nc;
    uint32_t res_h, res_w, res_h2, ring, stage_sz, res_full, full, empty, cols;
    wide::Ring chunks;  // WIDE only
    __device__ Smem(const unsigned char* raw, int D) {
        nc = D / CW;
        stage_nc = WIDE ? 0 : nc;
        res_h = (smem_u32(raw) + 1023u) & ~1023u;
        res_w = res_h + Narrow<DH>::RES;
        res_h2 = res_w + nc * RES_W;
        ring = res_h2 + Narrow<DH>::RES;
        stage_sz = 2 * Narrow<DH>::RING + stage_nc * T_W;
        uint32_t at = ring + NS * stage_sz;
        if constexpr (WIDE) {
            chunks.base = at;
            chunks.n = wide_slots<DH>(nc);
            at += chunks.n * wide::SLOT;
        }
        res_full = at;
        full = res_full + 8;
        empty = full + 8 * NS;
        at = empty + 8 * NS;
        if constexpr (WIDE) {
            chunks.full = at;
            chunks.empty = at + 8 * wide::MAX_SLOTS;
            at += wide::BAR_BYTES;
        }
        cols = at + 8;  // 16-byte aligned
    }
    __device__ uint32_t stage(int it) const { return ring + (it % NS) * stage_sz; }
    __device__ uint32_t full_bar(int it) const { return full + 8 * (it % NS); }
    __device__ uint32_t empty_bar(int it) const { return empty + 8 * (it % NS); }
    __device__ uint32_t parity(int it) const { return (it / NS) & 1; }
    // the second narrow tile of a stage (dq: v; dk/dv: dO)
    __device__ uint32_t narrow2(int it) const { return stage(it) + Narrow<DH>::RING + stage_nc * T_W; }
};

// s (64 x 64) = [a_h | a_w chunks] . [b_h | b_w chunks]^T over DH + 64 nc
// columns, and d (64 x 64) = a2 . b2^T over DH: both K-major operand pairs out
// of shared memory, started and committed as one group; the caller waits.
template <int DH>
__device__ __forceinline__ void start_pair(float (&s)[32], float (&d)[32], uint32_t a_h, uint32_t a_w,
                                           uint32_t a_chunk, uint32_t a2, uint32_t b_h, uint32_t b_w,
                                           uint32_t b2, int nc) {
    fence_regs(s);
    fence_regs(d);
    wgmma_fence();
    head_product<DH>(s, head_desc<DH>(a_h), head_desc<DH>(b_h), 0);
    for (int c = 0; c < nc; ++c) {
        const uint64_t a_r = make_desc(a_w + c * a_chunk, 16, 1024, SWIZZLE_128);
        const uint64_t b_r = make_desc(b_w + c * T_W, 16, 1024, SWIZZLE_128);
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) wgmma_m64n64k16_ss(s, a_r + 2 * kk, b_r + 2 * kk, 1);
    }
    head_product<DH>(d, head_desc<DH>(a2), head_desc<DH>(b2), 0);
    wgmma_commit();
}

template <int DH, bool WIDE>
__device__ __forceinline__ void init_barriers(const Smem<DH, WIDE>& sm) {
    if (threadIdx.x == 0) {
        mbar_init(sm.res_full, 1);
        for (int s = 0; s < Smem<DH, WIDE>::NS; ++s) {
            mbar_init(sm.full + 8 * s, 1);
            mbar_init(sm.empty + 8 * s, 4 * NWG);
        }
        if constexpr (WIDE) wide::init_ring(sm.chunks, 4 * NWG);
        mbar_init_fence();
    }
    __syncthreads();
}

// S = [a_h | a_w chunks] . [b_h | streamed chunks]^T and d = a2 . b2^T with
// WIDE: the chunks of the B side from the chunk ring. Returns with both done.
template <int DH>
__device__ __forceinline__ void wide_pair(float (&s)[32], float (&d)[32], uint32_t a_h, uint32_t a_w,
                                          uint32_t a2, uint32_t b_h, uint32_t b2, const wide::Ring& ring,
                                          wide::Cursor& cur, int nc, int lane) {
    fence_regs(s);
    fence_regs(d);
    wide::chunk_products(s, a_w, RES_W, ring, cur, nc, lane, [&] {
        head_product<DH>(s, head_desc<DH>(a_h), head_desc<DH>(b_h), 0);
        head_product<DH>(d, head_desc<DH>(a2), head_desc<DH>(b2), 0);
    });
    fence_regs(d);
}

// ---------------------------------------------------------------------------
// dq: block = (128 query rows, head, batch row)

// WIDE: dq_rot is unused; dS goes to ds_out (B, T, H, ld_ds) instead.
template <int DH, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
train_bwd_dq_bf16_kernel(const __grid_constant__ Maps maps, const int* __restrict__ lengths,
                         const float* __restrict__ stats, float* __restrict__ delta_out,
                         bf16* __restrict__ dq_u, bf16* __restrict__ dq_rot, bf16* __restrict__ ds_out,
                         int ld_ds, int B, int T, int H, int D, float scale, DropoutArgs drop) {
    using N = Narrow<DH>;
    constexpr int MAXC = WIDE ? 0 : N::MAX_CHUNKS;  // dq_rot chunks in registers (WIDE: none)
    extern __shared__ unsigned char smem_raw[];
    const Smem<DH, WIDE> sm(smem_raw, D);
    const int nc = sm.nc;
    init_barriers(sm);

    const int t0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];
    const int n_keys = visited_keys(len, T);
    const int n_tiles = (n_keys + BKEY - 1) / BKEY;
    const int wg = threadIdx.x / 128;

    if (wg == NWG) {
        // producer: the resident tiles once, then both walks through the ring
        if (NWG > 1 && !WIDE) setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x != 128 * NWG) return;
        mbar_arrive_expect_tx(sm.res_full, 2 * N::RES + nc * RES_W);
        tma_load_3d(sm.res_h, &maps.qu, sm.res_full, h * DH, t0, b);
        for (int c = 0; c < nc; ++c) tma_load_3d(sm.res_w + c * RES_W, &maps.qrot, sm.res_full, h * D + c * CW, t0, b);
        tma_load_3d(sm.res_h2, &maps.d_o, sm.res_full, h * DH, t0, b);
        wide::Cursor cur;
        for (int it = 0; it < 2 * n_tiles; ++it) {
            const int s0 = (it % n_tiles) * BKEY;
            const uint32_t stage = sm.stage(it), bar = sm.full_bar(it);
            mbar_wait(sm.empty_bar(it), sm.parity(it) ^ 1);
            mbar_arrive_expect_tx(bar, sm.stage_sz);
            tma_load_3d(stage, &maps.k, bar, h * DH, s0, b);
            for (int c = 0; c < sm.stage_nc; ++c) tma_load_2d(stage + N::RING + c * T_W, &maps.kstd, bar, c * CW, s0);
            tma_load_3d(sm.narrow2(it), &maps.v, bar, h * DH, s0, b);
            if constexpr (WIDE) {
                for (int c = 0; c < nc; ++c)
                    wide::put(sm.chunks, cur, [&](uint32_t dst, uint32_t cbar) {
                        tma_load_2d(dst, &maps.kstd, cbar, c * CW, s0);
                    });
            }
        }
        return;
    }
    if (NWG > 1 && !WIDE) setmaxnreg_inc<CONSUMER_REGS>();  // (a single consumer warpgroup has 255 from the launch)

    // consumers: warpgroup wg owns query rows t0 + 64 * wg .. + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int q = lane % 4, cq = 2 * q;
    const int ta = t0 + wg * 64 + warp * 16 + lane / 4, tb = ta + 8;  // this thread's rows
    const uint32_t my_h = sm.res_h + wg * N::WG, my_w = sm.res_w + wg * WG_W, my_do = sm.res_h2 + wg * N::WG;

    const size_t at = ((size_t)b * H + h) * T, n_stats = (size_t)B * H * T;
    const float m_a = stats[at + min(ta, T - 1)], m_b = stats[at + min(tb, T - 1)];
    const float il_a = 1.0f / stats[n_stats + at + min(ta, T - 1)];
    const float il_b = 1.0f / stats[n_stats + at + min(tb, T - 1)];
    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);

    float s[32], dp[32], acc_u[DH / 2], acc_r[MAXC > 0 ? MAXC : 1][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_u[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc_r[c][i] = 0.0f;
    float delta_a = 0.0f, delta_b = 0.0f;
    wide::Cursor cur;  // WIDE: this consumer's place in the k_std chunk ring

    mbar_wait(sm.res_full, 0);

    for (int it = 0; it < 2 * n_tiles; ++it) {
        const bool second = it >= n_tiles;
        const int s0 = (second ? it - n_tiles : it) * BKEY;
        const uint32_t stage = sm.stage(it);
        mbar_wait(sm.full_bar(it), sm.parity(it));
        if constexpr (WIDE) {
            wide_pair<DH>(s, dp, my_h, my_w, my_do, stage, sm.narrow2(it), sm.chunks, cur, nc, lane);
        } else {
            start_pair<DH>(s, dp, my_h, my_w, RES_W, my_do, stage, stage + N::RING, sm.narrow2(it), nc);
            wgmma_wait<0>();
            fence_regs(s);
            fence_regs(dp);
        }
        if (!second && lane == 0) mbar_arrive(sm.empty_bar(it));

        uint32_t ds[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float v[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = s0 + 8 * j + cq + e;
                const float p_a = expf(masked_score(s[4 * j + e], scale, col, len, T) - m_a) * il_a;
                const float p_b = expf(masked_score(s[4 * j + 2 + e], scale, col, len, T) - m_b) * il_b;
                float dp_a = dp[4 * j + e], dp_b = dp[4 * j + 2 + e];
                if (drop.enabled) {
                    dp_a = dropout_keep(key, ta, col, T, drop.thresh) ? dp_a * drop.inv_keep : 0.0f;
                    dp_b = dropout_keep(key, tb, col, T, drop.thresh) ? dp_b * drop.inv_keep : 0.0f;
                }
                if (!second) {
                    delta_a += p_a * dp_a;
                    delta_b += p_b * dp_b;
                } else {
                    v[e] = p_a * (dp_a - delta_a) * scale;
                    v[2 + e] = p_b * (dp_b - delta_b) * scale;
                }
            }
            if (second) pack_p(ds, j, v[0], v[1], v[2], v[3]);
        }
        if (!second) {
            if (it == n_tiles - 1) {
                // the walk's end: the row sums, kept for walk 2 and written for the dk/dv kernel
                delta_a = quad_sum(delta_a);
                delta_b = quad_sum(delta_b);
                if (q == 0) {
                    if (ta < T) delta_out[at + ta] = delta_a;
                    if (tb < T) delta_out[at + tb] = delta_b;
                }
            }
            continue;
        }
        if constexpr (WIDE) {
            // dS, rounded as the products read it, to its scratch: a lane's 8
            // consecutive columns of a row as one 16-byte store; columns past
            // ld_ds (and rows past T) are never written
            bf16* ds_a = ds_out + (((size_t)b * T + ta) * H + h) * ld_ds;
            bf16* ds_b = ds_a + (size_t)8 * H * ld_ds;
#pragma unroll
            for (int j0 = 0; j0 < 8; j0 += 4) {
                uint32_t wa[4], wb[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    wa[i] = ds[(j0 + i) / 2][2 * ((j0 + i) % 2)];
                    wb[i] = ds[(j0 + i) / 2][2 * ((j0 + i) % 2) + 1];
                }
                quad_transpose(wa, q);
                quad_transpose(wb, q);
                const int col = s0 + 8 * (j0 + q);
                if (col < ld_ds) {
                    if (ta < T) *reinterpret_cast<uint4*>(ds_a + col) = make_uint4(wa[0], wa[1], wa[2], wa[3]);
                    if (tb < T) *reinterpret_cast<uint4*>(ds_b + col) = make_uint4(wb[0], wb[1], wb[2], wb[3]);
                }
            }
        }
        // [dq_u | dq_rot] += dS [k | k_std]  (WIDE: dq_u alone)
        fence_regs(acc_u);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) fence_regs(acc_r[c]);
        wgmma_fence();
        add_head<DH>(acc_u, ds, stage);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < nc) {
                const uint64_t b_s = make_desc(stage + N::RING + c * T_W, T_W, 1024, SWIZZLE_128);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs_bt(acc_r[c], ds[kk], b_s + kk * (16 * CW * 2 / 16), 1);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_u);
#pragma unroll
        for (int c = 0; c < MAXC; ++c) fence_regs(acc_r[c]);
        if (lane == 0) mbar_arrive(sm.empty_bar(it));
    }

    store_o<DH>(acc_u, 1.0f, 1.0f, dq_u, (size_t)H * DH, b, T, ta, h, cq);
    // dq_rot (B, T, H, D): a lane's 8 consecutive columns of a row as one 16-byte store
    bf16* row_a = dq_rot + (((size_t)b * T + ta) * H + h) * D + 8 * q;
    bf16* row_b = row_a + (size_t)8 * H * D;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < nc) {
#pragma unroll
            for (int j0 = 0; j0 < 8; j0 += 4) {
                uint32_t wa[4], wb[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    wa[i] = pack_bf16(acc_r[c][4 * (j0 + i)], acc_r[c][4 * (j0 + i) + 1]);
                    wb[i] = pack_bf16(acc_r[c][4 * (j0 + i) + 2], acc_r[c][4 * (j0 + i) + 3]);
                }
                quad_transpose(wa, q);
                quad_transpose(wb, q);
                const int col = c * CW + 8 * j0;
                if (ta < T) *reinterpret_cast<uint4*>(row_a + col) = make_uint4(wa[0], wa[1], wa[2], wa[3]);
                if (tb < T) *reinterpret_cast<uint4*>(row_b + col) = make_uint4(wb[0], wb[1], wb[2], wb[3]);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// dk, dv: block = (128 keys, head, batch row)

template <int DH, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
train_bwd_dkv_bf16_kernel(const __grid_constant__ Maps maps, const int* __restrict__ lengths,
                          const float* __restrict__ stats, const float* __restrict__ delta_in,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int T, int H, int D,
                          float scale, DropoutArgs drop) {
    using N = Narrow<DH>;
    extern __shared__ unsigned char smem_raw[];
    const Smem<DH, WIDE> sm(smem_raw, D);
    const int nc = sm.nc;
    const int s0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
    const int len = lengths[b];

    if (s0 >= visited_keys(len, T)) {
        // every probability of these keys is an exact zero: so are dk and dv
        for (int i = threadIdx.x; i < ROWS * (DH / 2); i += THREADS) {
            const int s = s0 + i / (DH / 2), d = 2 * (i % (DH / 2));
            if (s < T) {
                const size_t at = (((size_t)b * T + s) * H + h) * DH + d;
                *reinterpret_cast<uint32_t*>(dk + at) = 0u;
                *reinterpret_cast<uint32_t*>(dv + at) = 0u;
            }
        }
        return;
    }
    init_barriers(sm);

    const int n_tiles = (T + BKEY - 1) / BKEY;  // query tiles
    const int wg = threadIdx.x / 128;

    if (wg == NWG) {
        // producer: the block's keys once, then every query tile through the ring
        if (threadIdx.x != 128 * NWG) return;
        mbar_arrive_expect_tx(sm.res_full, 2 * N::RES + nc * RES_W);
        tma_load_3d(sm.res_h, &maps.k, sm.res_full, h * DH, s0, b);
        for (int c = 0; c < nc; ++c) tma_load_2d(sm.res_w + c * RES_W, &maps.kstd, sm.res_full, c * CW, s0);
        tma_load_3d(sm.res_h2, &maps.v, sm.res_full, h * DH, s0, b);
        wide::Cursor cur;
        for (int it = 0; it < n_tiles; ++it) {
            const int t0 = it * BKEY;
            const uint32_t stage = sm.stage(it), bar = sm.full_bar(it);
            mbar_wait(sm.empty_bar(it), sm.parity(it) ^ 1);
            mbar_arrive_expect_tx(bar, sm.stage_sz);
            tma_load_3d(stage, &maps.qu, bar, h * DH, t0, b);
            for (int c = 0; c < sm.stage_nc; ++c)
                tma_load_3d(stage + N::RING + c * T_W, &maps.qrot, bar, h * D + c * CW, t0, b);
            tma_load_3d(sm.narrow2(it), &maps.d_o, bar, h * DH, t0, b);
            if constexpr (WIDE) {
                for (int c = 0; c < nc; ++c)
                    wide::put(sm.chunks, cur, [&](uint32_t dst, uint32_t cbar) {
                        tma_load_3d(dst, &maps.qrot, cbar, h * D + c * CW, t0, b);
                    });
            }
        }
        return;
    }

    // consumers: warpgroup wg owns keys s0 + 64 * wg .. + 63, the ROWS of the
    // transposed fragments; their columns are the tile's queries
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int cq = 2 * (lane % 4);
    const int key_a = s0 + wg * 64 + warp * 16 + lane / 4, key_b = key_a + 8;
    const uint32_t my_h = sm.res_h + wg * N::WG, my_w = sm.res_w + wg * WG_W, my_v = sm.res_h2 + wg * N::WG;
    float* cols = reinterpret_cast<float*>(smem_raw + (sm.cols - smem_u32(smem_raw))) + wg * (2 * 3 * BKEY);

    const size_t at = ((size_t)b * H + h) * T, n_stats = (size_t)B * H * T;
    const uint32_t key = dropout_key(drop.seed, drop.row0 + b, h, H);
    const float inv_keep_e = round_bf(drop.inv_keep);

    float st[32], dpt[32], acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
    wide::Cursor cur;  // WIDE: this consumer's place in the q_rot chunk ring

    mbar_wait(sm.res_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
        const int t0 = it * BKEY;
        const uint32_t stage = sm.stage(it);
        // the tile's per-query numbers: row max, 1 / row sum, delta
        float* col = cols + (it & 1) * (3 * BKEY);
        const int i = threadIdx.x % 128;
        if (i < BKEY) {
            const int t = t0 + i;
            const bool in = t < T;
            col[i] = in ? stats[at + t] : INFINITY;  // exp(x - inf) = 0: a row past T has P = 0
            col[BKEY + i] = in ? 1.0f / stats[n_stats + at + t] : 0.0f;
            col[2 * BKEY + i] = in ? delta_in[at + t] : 0.0f;
        }
        named_barrier(1 + wg, 128);

        mbar_wait(sm.full_bar(it), sm.parity(it));
        // S^T = [k | k_std] [q_u | q_rot]^T and dP^T = v dO^T
        if constexpr (WIDE) {
            wide_pair<DH>(st, dpt, my_h, my_w, my_v, stage, sm.narrow2(it), sm.chunks, cur, nc, lane);
        } else {
            start_pair<DH>(st, dpt, my_h, my_w, RES_W, my_v, stage, stage + N::RING, sm.narrow2(it), nc);
            wgmma_wait<0>();
            fence_regs(st);
            fence_regs(dpt);
        }

        uint32_t pd[4][4], ds[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float2 mx = *reinterpret_cast<const float2*>(col + 8 * j + cq);
            const float2 il = *reinterpret_cast<const float2*>(col + BKEY + 8 * j + cq);
            const float2 dl = *reinterpret_cast<const float2*>(col + 2 * BKEY + 8 * j + cq);
            float pv[4], dv_[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int t = t0 + 8 * j + cq + e;
                const float m = e ? mx.y : mx.x, inv_l = e ? il.y : il.x, delta = e ? dl.y : dl.x;
                const float p_a = expf(masked_score(st[4 * j + e], scale, key_a, len, T) - m) * inv_l;
                const float p_b = expf(masked_score(st[4 * j + 2 + e], scale, key_b, len, T) - m) * inv_l;
                float pd_a = round_bf(p_a), pd_b = round_bf(p_b);
                float dp_a = dpt[4 * j + e], dp_b = dpt[4 * j + 2 + e];
                if (drop.enabled) {
                    const bool keep_a = dropout_keep(key, t, key_a, T, drop.thresh);
                    const bool keep_b = dropout_keep(key, t, key_b, T, drop.thresh);
                    pd_a = keep_a ? pd_a * inv_keep_e : 0.0f;
                    pd_b = keep_b ? pd_b * inv_keep_e : 0.0f;
                    dp_a = keep_a ? dp_a * drop.inv_keep : 0.0f;
                    dp_b = keep_b ? dp_b * drop.inv_keep : 0.0f;
                }
                pv[e] = pd_a;
                pv[2 + e] = pd_b;
                dv_[e] = p_a * (dp_a - delta) * scale;
                dv_[2 + e] = p_b * (dp_b - delta) * scale;
            }
            pack_p(pd, j, pv[0], pv[1], pv[2], pv[3]);
            pack_p(ds, j, dv_[0], dv_[1], dv_[2], dv_[3]);
        }
        // dv += Pd^T dO, dk += dS^T q_u
        fence_regs(acc_v);
        fence_regs(acc_k);
        wgmma_fence();
        add_head<DH>(acc_v, pd, sm.narrow2(it));
        add_head<DH>(acc_k, ds, stage);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
        if (lane == 0) mbar_arrive(sm.empty_bar(it));
    }

    store_o<DH>(acc_k, 1.0f, 1.0f, dk, (size_t)H * DH, b, T, key_a, h, cq);
    store_o<DH>(acc_v, 1.0f, 1.0f, dv, (size_t)H * DH, b, T, key_a, h, cq);
}

// Tensor maps of one kernel: q_u, q_rot, dO in boxes of `rows_q` rows, k,
// k_std, v in boxes of `rows_k` rows. All contiguous: (B, T, H * DH),
// (B, T, H * D) and k_std (T, D); coordinates (column, t, b); rows past T read
// as zeros.
template <int DH>
cudaError_t make_maps(Maps* m, const void* q_u, const void* q_rot, const void* k, const void* v,
                      const void* k_std, const void* d_out, int B, int T, int H, int D,
                      cuuint32_t rows_q, cuuint32_t rows_k) {
    const cuuint64_t dims_h[3] = {(cuuint64_t)H * DH, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_h[2] = {(cuuint64_t)H * DH * 2, (cuuint64_t)T * H * DH * 2};
    const cuuint64_t dims_r[3] = {(cuuint64_t)H * D, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides_r[2] = {(cuuint64_t)H * D * 2, (cuuint64_t)T * H * D * 2};
    const cuuint64_t dims_s[2] = {(cuuint64_t)D, (cuuint64_t)T};
    const cuuint64_t strides_s[1] = {(cuuint64_t)D * 2};
    const cuuint32_t box_hq[3] = {DH, rows_q, 1}, box_rq[3] = {(cuuint32_t)CW, rows_q, 1};
    const cuuint32_t box_hk[3] = {DH, rows_k, 1}, box_sk[2] = {(cuuint32_t)CW, rows_k};
    constexpr CUtensorMapSwizzle SW = Head<DH>::MAP_SWIZZLE;
    cudaError_t err = tensor_map_bf16(&m->qu, q_u, 3, dims_h, strides_h, box_hq, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&m->d_o, d_out, 3, dims_h, strides_h, box_hq, SW);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m->qrot, q_rot, 3, dims_r, strides_r, box_rq, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess) err = tensor_map_bf16(&m->k, k, 3, dims_h, strides_h, box_hk, SW);
    if (err == cudaSuccess) err = tensor_map_bf16(&m->v, v, 3, dims_h, strides_h, box_hk, SW);
    if (err == cudaSuccess)
        err = tensor_map_bf16(&m->kstd, k_std, 2, dims_s, strides_s, box_sk, CU_TENSOR_MAP_SWIZZLE_128B);
    return err;
}

// Give `kernel` its shared memory. The dq kernel's warpgroups re-divide the
// block's registers, 2 x 240 + 24 a thread (not with WIDE, which holds no
// dq_rot): the block must have been given that many, or a consumer would wait
// for registers that never come.
template <int DH, bool WIDE, typename Kernel>
cudaError_t prepare(Kernel kernel, int nc, bool redivides_registers) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<DH, WIDE>(nc));
    if (err != cudaSuccess || !redivides_registers) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    return attr.numRegs * THREADS >= 128 * (NWG * CONSUMER_REGS + PRODUCER_REGS) ? cudaSuccess
                                                                                 : cudaErrorLaunchOutOfResources;
}

template <int DH, bool WIDE>
int launch_bwd(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std,
               const void* lengths, const void* d_out, const void* stats, void* delta, void* dq_u, void* dq_rot,
               void* ds, int ld_ds, void* dk, void* dv, int B, int T, int H, int D, float scale, DropoutArgs drop,
               cudaStream_t stream) {
    const int nc = D / CW;
    Maps maps_q, maps_k;
    cudaError_t err = make_maps<DH>(&maps_q, q_u, q_rot, k, v, k_std, d_out, B, T, H, D, ROWS, BKEY);
    if (err == cudaSuccess) err = make_maps<DH>(&maps_k, q_u, q_rot, k, v, k_std, d_out, B, T, H, D, BKEY, ROWS);
    if (err == cudaSuccess) err = prepare<DH, WIDE>(train_bwd_dq_bf16_kernel<DH, WIDE>, nc, NWG > 1 && !WIDE);
    if (err == cudaSuccess) err = prepare<DH, WIDE>(train_bwd_dkv_bf16_kernel<DH, WIDE>, nc, false);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(T, ROWS), H, B);
    train_bwd_dq_bf16_kernel<DH, WIDE><<<grid, THREADS, smem_bytes<DH, WIDE>(nc), stream>>>(
        maps_q, (const int*)lengths, (const float*)stats, (float*)delta, (bf16*)dq_u, (bf16*)dq_rot, (bf16*)ds,
        ld_ds, B, T, H, D, scale, drop);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    train_bwd_dkv_bf16_kernel<DH, WIDE><<<grid, THREADS, smem_bytes<DH, WIDE>(nc), stream>>>(
        maps_k, (const int*)lengths, (const float*)stats, (const float*)delta, (bf16*)dk, (bf16*)dv, B, T, H, D,
        scale, drop);
    return (int)cudaGetLastError();
}

}  // namespace

template <int DH>
int train_bwd_bf16(const void* q_u, const void* q_rot, const void* k, const void* v, const void* k_std,
                   const void* lengths, const void* d_out, const void* stats, void* delta, void* dq_u,
                   void* dq_rot, void* dk, void* dv, int B, int T, int H, int D, float scale,
                   DropoutArgs drop, cudaStream_t stream) {
    const int nc = D / CW;
    if (!fa::supported<DH>(B, H, D) || nc > Narrow<DH>::MAX_CHUNKS ||
        smem_bytes<DH, false>(nc) > MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    return launch_bwd<DH, false>(q_u, q_rot, k, v, k_std, lengths, d_out, stats, delta, dq_u, dq_rot, nullptr, 0,
                                 dk, dv, B, T, H, D, scale, drop, stream);
}

#define INSTANTIATE(DH)                                                                                     \
    template int train_bwd_bf16<DH>(const void*, const void*, const void*, const void*, const void*,        \
                                    const void*, const void*, const void*, void*, void*, void*, void*, void*, \
                                    int, int, int, int, float, DropoutArgs, cudaStream_t);
INSTANTIATE(32)
INSTANTIATE(64)
#undef INSTANTIATE

}  // namespace attn

// The bf16 backward where [dq_u | dq_rot] passes the dq kernel's register
// accumulator, dh + D > 288 (WIDE, up to D = 512): the dq kernel writes
// dq_u and dS, bf16, into `ds` (B, T, H, ld_ds), ld_ds a multiple of 8 of at
// least T, zeroed by the caller (columns of unvisited keys stay 0); the dk/dv
// kernel writes dk and dv. dq_rot = dS k_std is the caller's GEMM.
ASR_API int asr_rel_attention_train_bwd_wide(const void* q_u, const void* q_rot, const void* k, const void* v,
                                             const void* k_std, const void* lengths, const void* d_out,
                                             const void* stats, void* delta, void* dq_u, void* ds, void* dk,
                                             void* dv, int B, int T, int H, int dh, int D, int ld_ds, float scale,
                                             unsigned seed, unsigned thresh, float inv_keep, int dropout,
                                             int row0, void* stream) {
    using namespace attn;
    if (T < 1 || ld_ds < T || ld_ds % 8 != 0) return (int)cudaErrorInvalidValue;
    const DropoutArgs drop{seed, thresh, inv_keep, dropout, row0};
    return with_head_width(dh, [&](auto head) {
        constexpr int DH = decltype(head)::value;
        if (!fa::supported<DH>(B, H, D) || wide_slots<DH>(D / CW) < wide::MIN_SLOTS ||
            smem_bytes<DH, true>(D / CW) > MAX_SMEM)
            return (int)cudaErrorInvalidValue;
        return launch_bwd<DH, true>(q_u, q_rot, k, v, k_std, lengths, d_out, stats, delta, dq_u, nullptr, ds, ld_ds,
                                    dk, dv, B, T, H, D, scale, drop, static_cast<cudaStream_t>(stream));
    });
}

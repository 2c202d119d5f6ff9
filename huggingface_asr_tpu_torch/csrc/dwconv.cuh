// Depthwise convolution along T for the E-Branchformer layer, in three forms.
//
// Replaces `_dwconv` and its callers inside ops/pallas_layer.py::_layer_kernel
// (`_dwconv` at :395, called at :570-593):
//   CSGU  (dwconv_csgu_kernel):  g = LN(l[:, C:]) over the C gate channels (bf16);
//                                gated = bf16(l[:, :C] * bf16(act(dwconv(g))))
//   CSGU, ungated (dwconv_csgu_conv_kernel): bf16(dwconv(g)) alone, for a model
//                                with csgu_use_linear_after_conv (:578-583),
//                                whose linear, activation and gate follow in
//                                the GEMM's gate epilogue (gemm.cuh); the
//                                x_r rows are neither staged nor read
//   merge (dwconv_merge_kernel): out = bf16(x + bf16(dwconv(x)))  over all C channels
// with dwconv(x)[t, c] = bias[c] + sum_j x[t + j - P, c] * w[j, c] accumulated
// in fp32 (bias first, then j = 0..K-1), P = (K - 1) / 2, and rows outside
// [0, t_valid) read as zero — the TPU kernel's t_mask, so padding rows of a
// bucket never reach valid frames. Output rows at or past t_valid are
// computed as the TPU kernel computes them; rows past T are never written.
//
// What bounds it on the H100: bytes. A call reads its input once and writes
// its output once (CSGU at B=128 x 10 s: 67 MB read, 33.5 MB written,
// 0.030 ms at 3.35 TB/s), and its 31 fp32 FMAs per output element take about
// half that time in issue slots on 132 SMs, so the design has to stage every
// byte once, in wide copies that are in flight together, and come near one
// issued instruction per FMA.
//
// The design:
//   * A tile is TT output rows of one utterance by CS channels (CSGU: all C,
//     which the LayerNorm needs; merge: 128-channel slices, whose channels
//     are independent), staged as boxes of 128 channels. A block stays on
//     its SM and walks tiles through two stages of shared memory. Thread 0
//     moves every byte by TMA, a few instructions a tile: the tile's
//     TT + KP - 1 input rows through a 3-D map (channel, frame, utterance)
//     whose frame extent is t_valid, so that the masked rows and the rows
//     before 0 are the TMA's zero fill; (CSGU) the x_r rows of its output
//     rows; and at the end the output boxes, through a map whose frame extent
//     is T, so that rows past T are never written. The tile after next is
//     loaded as soon as a stage is free, and the stores drain while the block
//     works on the next tile.
//   * CSGU normalises each staged row in place, one warp a row: one read into
//     registers gives both sums, and the bf16 row goes back from registers.
//   * CSGU past 768 channels (up to 1,024): a 16-row tile of [x_r | x_g]
//     with its 30-row halo, 2 x 127 KB at C = 1,024, no longer double-buffers
//     in 227 KB. There the tiles are 128-channel slices, as merge's are, and
//     a first kernel (csgu_stats_kernel, one warp a row, a read of x_g's valid
//     rows) writes each row's mean and 1 / std, which the slices' LayerNorm
//     reads; the rows' sums are the whole-row path's, in the same order.
//   * A thread owns a channel (or a few) of the tile and walks its groups of
//     R = 16 output rows. The KP weights of the channel sit in registers,
//     loaded once as 32-bit words; a group walks its R + KP - 1 input rows,
//     256 bytes apart in the box (each shared load with a constant offset),
//     each value feeding up to min(R, KP) independent fp32 accumulators: 46
//     shared loads for 496 FMAs at KP = 31. KP is a compile-time size (7, 31
//     or 33): a smaller odd K runs with zero taps on both sides, which leave
//     every sum as it is.
//   * The output rows go to a buffer of their own in shared memory: CSGU's
//     finished by the thread that computed them, with the staged x_r; merge's
//     rounded conv rows get the staged input row of the same frame added
//     after a barrier, 16 bytes a thread (finishing them in the conv thread
//     was 8 % slower). Thread 0 stores the boxes.
//   * Two tilings, chosen in use_large() from the number of tiles: CSGU tiles
//     of 32 rows and merge tiles of 64 (halo 62/32 and 94/64 at K = 31) where
//     there are at least two an SM (B=128: one CSGU block of 512 threads an
//     SM, three merge blocks of 128), 16-row tiles where there are not (B=8:
//     128 CSGU tiles and 512 merge tiles, one a block).
// The designs measured before this one, and what still holds it back, are in
// PERF.md.
#pragma once

#include "hopper.cuh"

namespace dwconv {

constexpr int MAX_K = 33;
constexpr int ROWS = 16;     // output rows of a group (R)
constexpr int BOX = 128;     // channels of a TMA box: a staged row of a box is 256 bytes
constexpr int MAX_THREADS = 512;
constexpr int MAX_C_CSGU = 768, MAX_C_MERGE = 1024;  // the 16-row tile's two stages within 227 KB
constexpr int MAX_C_CSGU_SPLIT = 1024;  // CSGU in channel slices, the row statistics from a first pass
constexpr int LN_CHUNKS = MAX_C_CSGU / 256;  // 16-byte chunks of a row a lane holds in the LayerNorm

struct Args {
    const bf16* x;  // [B*T, ldx]: CSGU [x_r | x_g], merge x
    const float* ln_g;
    const float* ln_b;
    const bf16* w;  // [K, C]
    const float* bias;
    bf16* out;  // [B*T, C]
    int ldx, B, T, t_valid, C, K, act;
    float eps;
    float2* stats;  // [B*T] (mean, 1 / std) of x_g's rows: CSGU past MAX_C_CSGU only
    int gated;      // CSGU: 1 the gated form, 0 the ungated conv (no x_r staged)
};

// 3-D views (channel, frame, utterance) of the input rows (frames at or past
// t_valid out of bounds, so that the TMA fills them with zeros), of x_r
// (CSGU) and of the output (frames past T out of bounds, so never written).
struct Maps {
    CUtensorMap in, xr, out;
};

__device__ __forceinline__ float bf16_bits(unsigned short u) { return __uint_as_float((uint32_t)u << 16); }

// The CSGU activation other than the identity, out of line: its inlined
// transcendental code would compete with the conv's registers.
static __device__ __noinline__ float act_call(int act, float v) { return apply_act(act, v); }

// The tiles of one launch, TT rows of one utterance by CS channels (nbox
// boxes of 128), and the shared memory of a block: two stages, each the
// tile's input rows [nbox][rows_in][128] (CSGU: then its x_r rows
// [nbox][TT][128]); the output rows [nbox][TT][128]; (CSGU) the LayerNorm's
// g and b [2][C] fp32; the stages' two mbarriers. `xr`: the tile stages its
// x_r rows (the gated CSGU form; the ungated one stages none).
struct Tiles {
    int TT, CS, nbox, rows_in, per_utt, n_slices, n;
    size_t in_bytes, stage_bytes, out_off, gs_off, bar_off, smem;
    __host__ __device__ Tiles(const Args& a, bool csgu, int KP, int rows, int chans, bool xr)
        : TT(rows), CS(chans), nbox((chans + BOX - 1) / BOX), rows_in(rows + KP - 1),
          per_utt((a.T + rows - 1) / rows), n_slices(a.C / chans),
          n(a.B * ((a.T + rows - 1) / rows) * (a.C / chans)),
          in_bytes((size_t)nbox * rows_in * BOX * 2),
          stage_bytes(in_bytes + (xr ? (size_t)nbox * rows * BOX * 2 : 0)),
          out_off(2 * stage_bytes), gs_off(out_off + (size_t)nbox * rows * BOX * 2),
          bar_off(gs_off + (csgu ? 2 * (size_t)a.C * sizeof(float) : 0)), smem(bar_off + 16) {}
};

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
                 ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// One thread loads a tile into a stage: a TMA box of 128 channels by the
// tile's input rows for each box (CSGU: and one of its x_r rows), counted in
// bytes on the stage's mbarrier. A tile past the last loads nothing. SPLIT:
// CSGU in channel slices (past MAX_C_CSGU); GATE: CSGU's gated form.
template <bool CSGU, int KP, bool SPLIT, bool GATE>
__device__ __forceinline__ void load_tile(const Args& a, const Maps& maps, const Tiles& tl, int tile,
                                          uint32_t stage, uint32_t bar) {
    if (tile >= tl.n) return;
    constexpr int P = (KP - 1) / 2;
    const int slice = tile % tl.n_slices, bt = tile / tl.n_slices;
    const int b = bt / tl.per_utt, t0 = (bt % tl.per_utt) * tl.TT;
    // With t_valid = 0 every frame is masked: ask for frames far out of bounds.
    const int t_in = t0 - P + (a.t_valid > 0 ? 0 : (1 << 24));
    hopper::mbar_arrive_expect_tx(bar, (uint32_t)(tl.stage_bytes));
    for (int j = 0; j < tl.nbox; ++j) {
        hopper::tma_load_3d(stage + j * tl.rows_in * BOX * 2, &maps.in, bar, slice * tl.CS + j * BOX, t_in, b);
        if (CSGU && GATE)
            hopper::tma_load_3d(stage + (uint32_t)tl.in_bytes + j * tl.TT * BOX * 2, &maps.xr, bar,
                                (SPLIT ? slice * tl.CS : 0) + j * BOX, t0, b);
    }
}

// LayerNorm of every valid staged row of a tile, in place, one warp a row:
// one read of the row into registers gives both sums, and the normalised
// bf16 row goes back from the registers. Masked rows stay 0.
template <int KP>
__device__ __forceinline__ void layer_norm_rows(const Args& a, unsigned char* xs, const float* gs, int rows_in,
                                                int t0, int tv) {
    constexpr int P = (KP - 1) / 2;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32, cq = a.C / 8;
    for (int r = warp; r < rows_in; r += nwarps) {
        const int t = t0 - P + r;
        if (t < 0 || t >= tv) continue;
        uint4 v[LN_CHUNKS];
        float s = 0.0f, ss = 0.0f;
#pragma unroll
        for (int k = 0; k < LN_CHUNKS; ++k) {
            const int q = lane + 32 * k;  // 8 channels: box q / 16, 16 bytes q % 16 of its row
            if (q < cq) {
                v[k] = *reinterpret_cast<const uint4*>(xs + ((size_t)(q >> 4) * rows_in + r) * BOX * 2 + (q & 15) * 16);
                const uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float lo = hopper::bf16_lo(u[e]), hi = hopper::bf16_hi(u[e]);
                    s += lo + hi;
                    ss = fmaf(lo, lo, fmaf(hi, hi, ss));
                }
            }
        }
        s = warp_sum(s);
        ss = warp_sum(ss);
        const float mu = s / (float)a.C;
        const float rs = rsqrtf(fmaxf(ss / (float)a.C - mu * mu, 0.0f) + a.eps);
#pragma unroll
        for (int k = 0; k < LN_CHUNKS; ++k) {
            const int q = lane + 32 * k;
            if (q < cq) {
                const float4* g4 = reinterpret_cast<const float4*>(gs + 8 * q);
                const float4* b4 = reinterpret_cast<const float4*>(gs + a.C + 8 * q);
                const float4 ga = g4[0], gb = g4[1], ba = b4[0], bb = b4[1];
                const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
                const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
                uint32_t u[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float lo = (hopper::bf16_lo(u[e]) - mu) * (rs * g[2 * e]) + bi[2 * e];
                    const float hi = (hopper::bf16_hi(u[e]) - mu) * (rs * g[2 * e + 1]) + bi[2 * e + 1];
                    u[e] = hopper::pack_bf16(lo, hi);
                }
                *reinterpret_cast<uint4*>(xs + ((size_t)(q >> 4) * rows_in + r) * BOX * 2 + (q & 15) * 16) =
                    make_uint4(u[0], u[1], u[2], u[3]);
            }
        }
    }
}

// The sums of layer_norm_rows for one row of x_g in device memory, one warp:
// the same chunks to a lane, added in the same order.
__device__ __forceinline__ float2 row_stats(const Args& a, const bf16* row) {
    const int lane = threadIdx.x % 32, cq = a.C / 8;
    float s = 0.0f, ss = 0.0f;
    for (int q = lane; q < cq; q += 32) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + q);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float lo = hopper::bf16_lo(u[e]), hi = hopper::bf16_hi(u[e]);
            s += lo + hi;
            ss = fmaf(lo, lo, fmaf(hi, hi, ss));
        }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / (float)a.C;
    return make_float2(mu, rsqrtf(fmaxf(ss / (float)a.C - mu * mu, 0.0f) + a.eps));
}

// CSGU past MAX_C_CSGU, first pass: (mean, 1 / std) of every valid row of
// x_g (frames below t_valid), one warp a row.
static __global__ void __launch_bounds__(256) csgu_stats_kernel(const Args a) {
    const int row = blockIdx.x * 8 + threadIdx.x / 32;
    const int tv = max(0, min(a.t_valid, a.T));
    if (row >= a.B * a.T || row % a.T >= tv) return;
    const float2 st = row_stats(a, a.x + (size_t)row * a.ldx + a.C);
    if (threadIdx.x % 32 == 0) a.stats[row] = st;
}

// The LayerNorm of a slice tile's valid staged rows, in place, from the
// first pass's statistics: 16 bytes (8 channels) a thread at a time.
template <int KP>
__device__ __forceinline__ void layer_norm_slice(const Args& a, const Tiles& tl, unsigned char* xs, const float* gs,
                                                 int b, int t0, int c0, int tv) {
    constexpr int P = (KP - 1) / 2;
    const int per_row = BOX / 8, per_box = tl.rows_in * per_row;
    for (int idx = threadIdx.x; idx < tl.nbox * per_box; idx += blockDim.x) {
        const int j = idx / per_box, r = (idx - j * per_box) / per_row, q = idx % per_row;
        const int t = t0 - P + r;
        if (t < 0 || t >= tv) continue;
        const float2 st = a.stats[(size_t)b * a.T + t];
        const int ch = c0 + j * BOX + q * 8;
        const float4* g4 = reinterpret_cast<const float4*>(gs + ch);
        const float4* b4 = reinterpret_cast<const float4*>(gs + a.C + ch);
        const float4 ga = g4[0], gb = g4[1], ba = b4[0], bb = b4[1];
        const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        const float bi[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
        uint4* p = reinterpret_cast<uint4*>(xs + ((size_t)j * tl.rows_in + r) * BOX * 2 + q * 16);
        const uint4 v = *p;
        uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float lo = (hopper::bf16_lo(u[e]) - st.x) * (st.y * g[2 * e]) + bi[2 * e];
            const float hi = (hopper::bf16_hi(u[e]) - st.x) * (st.y * g[2 * e + 1]) + bi[2 * e + 1];
            u[e] = hopper::pack_bf16(lo, hi);
        }
        *p = make_uint4(u[0], u[1], u[2], u[3]);
    }
}

// Merge's output of one tile, in place in `ys` (16 bytes a thread):
// bf16(x + y) with x the staged input row of the same frame, or device memory
// for a frame at or past t_valid (staged as 0).
template <int KP>
__device__ __forceinline__ void merge_residual(const Args& a, const Tiles& tl, const unsigned char* stage,
                                              unsigned char* ys, int b, int t0, int c0, int tv) {
    constexpr int P = (KP - 1) / 2;
    const int per_box = tl.TT * (BOX / 8);
    for (int idx = threadIdx.x; idx < tl.nbox * per_box; idx += blockDim.x) {
        const int j = idx / per_box, r = (idx - j * per_box) / (BOX / 8), q = idx % (BOX / 8);
        const int ch = j * BOX + q * 8, t = t0 + r;
        if (ch >= tl.CS || t >= a.T) continue;  // outside the tensor: the store leaves it out
        const uint4 xv = t < tv
            ? *reinterpret_cast<const uint4*>(stage + ((size_t)j * tl.rows_in + r + P) * BOX * 2 + q * 16)
            : __ldg(reinterpret_cast<const uint4*>(a.x + ((size_t)b * a.T + t) * a.ldx + c0 + ch));
        uint4* yp = reinterpret_cast<uint4*>(ys + (size_t)idx * 16);
        const uint4 yv = *yp;
        const uint32_t xu[4] = {xv.x, xv.y, xv.z, xv.w};
        const uint32_t yu[4] = {yv.x, yv.y, yv.z, yv.w};
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            o[e] = hopper::pack_bf16(hopper::bf16_lo(xu[e]) + hopper::bf16_lo(yu[e]),
                                     hopper::bf16_hi(xu[e]) + hopper::bf16_hi(yu[e]));
        *yp = make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// A block stays on its SM and walks tiles blockIdx.x, + gridDim.x, ...
// through two stages. Thread 0 moves the bytes by TMA: it loads the tile
// after next into a stage as soon as the block is done with it, and stores a
// tile's output boxes from shared memory; both run while the block works on
// the next tile. SPLIT: CSGU in 128-channel slices, normalised from the
// statistics pass's output (a second instantiation: the whole-row path keeps
// its code). GATE = false: CSGU's ungated form, which writes bf16(acc).
template <bool CSGU, int KP, int R, bool SPLIT = false, bool GATE = true>
__device__ __forceinline__ void dwconv_body(const Args& a, const Maps& maps, int TT, int CS) {
    extern __shared__ __align__(128) unsigned char smem[];
    constexpr int ROW = BOX * 2;  // bytes of a staged row of a box
    const int NT = blockDim.x, tid = threadIdx.x;
    const Tiles tl(a, CSGU, KP, TT, CS, CSGU && GATE);
    const int tv = max(0, min(a.t_valid, a.T));
    float* gs = reinterpret_cast<float*>(smem + tl.gs_off);
    unsigned char* ys = smem + tl.out_off;
    const uint32_t smem0 = hopper::smem_u32(smem), bar0 = smem0 + (uint32_t)tl.bar_off;

    if (tid == 0) {
        hopper::mbar_init(bar0, 1);
        hopper::mbar_init(bar0 + 8, 1);
        hopper::mbar_init_fence();
    }
    if (CSGU) {
        for (int i = tid; i < a.C; i += NT) {
            gs[i] = a.ln_g[i];
            gs[a.C + i] = a.ln_b[i];
        }
    }
    __syncthreads();
    if (tid == 0) {
        load_tile<CSGU, KP, SPLIT, GATE>(a, maps, tl, blockIdx.x, smem0, bar0);
        load_tile<CSGU, KP, SPLIT, GATE>(a, maps, tl, blockIdx.x + gridDim.x, smem0 + (uint32_t)tl.stage_bytes,
                                         bar0 + 8);
    }

    const int off = (KP - a.K) / 2;  // zero taps on each side of a smaller kernel
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(a.w);
    float wk[KP];
    int have_cc = -1;
    int k = 0;
    for (int tile = blockIdx.x; tile < tl.n; tile += gridDim.x, ++k) {
        const int slice = tile % tl.n_slices, bt = tile / tl.n_slices;
        const int b = bt / tl.per_utt, t0 = (bt % tl.per_utt) * TT, c0 = slice * CS;
        unsigned char* stage = smem + (k & 1) * tl.stage_bytes;
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // the last tile's store
        hopper::mbar_wait(bar0 + 8 * (k & 1), (k >> 1) & 1);  // this tile's rows have landed
        if constexpr (SPLIT) layer_norm_slice<KP>(a, tl, stage, gs, b, t0, c0, tv);
        else if (CSGU) layer_norm_rows<KP>(a, stage, gs, tl.rows_in, t0, tv);
        __syncthreads();

        // The convolution: a thread owns channels c = tid, tid + NT, ... of
        // the tile, and walks the groups of R rows of each. A channel's rows
        // are 256 bytes apart: every shared load has its own constant offset.
        for (int c = tid; c < CS; c += NT) {
            const int cc = c0 + c;
            if (cc != have_cc) {  // the weights of channel cc, read as 32-bit words
#pragma unroll
                for (int jp = 0; jp < KP; ++jp) {
                    const int j = jp - off;
                    const uint32_t u = (j >= 0 && j < a.K) ? __ldg(w32 + ((size_t)j * a.C + cc) / 2) : 0u;
                    wk[jp] = (cc & 1) ? hopper::bf16_hi(u) : hopper::bf16_lo(u);
                }
                have_cc = cc;
            }
            const float bc = __ldg(a.bias + cc);
            const unsigned char* col = stage + (size_t)(c / BOX) * tl.rows_in * ROW + (c % BOX) * 2;
            unsigned char* out_col = ys + (size_t)(c / BOX) * TT * ROW + (c % BOX) * 2;
            const unsigned short* xr_col = reinterpret_cast<const unsigned short*>(  // CSGU: channel c's x_r rows
                stage + tl.in_bytes + (size_t)(c / BOX) * TT * ROW + (c % BOX) * 2);
            for (int g = 0; g < TT / R; ++g) {
                const unsigned short* row0 = reinterpret_cast<const unsigned short*>(col + (size_t)g * R * ROW);
                float acc[R];
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = bc;
#pragma unroll
                for (int i = 0; i < R + KP - 1; ++i) {
                    const float xi = bf16_bits(row0[i * BOX]);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const int j = i - r;
                        if (j >= 0 && j < KP) acc[r] = fmaf(xi, wk[j], acc[r]);
                    }
                }
                if (CSGU && GATE && a.act != ACT_IDENTITY) {
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r] = act_call(a.act, acc[r]);
                }
                // CSGU's output rows, bf16(x_r * bf16(act(acc))) with the staged x_r;
                // the ungated CSGU's bf16(acc); merge's rounded conv rows, to
                // which merge_residual adds x
                unsigned short* y0 = reinterpret_cast<unsigned short*>(out_col + (size_t)g * R * ROW);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float y = round_bf(acc[r]);
                    y0[r * BOX] = __bfloat16_as_ushort(
                        to_bf(CSGU && GATE ? bf16_bits(xr_col[(g * R + r) * BOX]) * y : y));
                }
            }
        }
        if (!CSGU) {
            __syncthreads();
            merge_residual<KP>(a, tl, stage, ys, b, t0, c0, tv);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the TMA store reads what we wrote
        __syncthreads();
        if (tid == 0) {
            for (int j = 0; j < tl.nbox; ++j)
                tma_store_3d(&maps.out, hopper::smem_u32(ys + (size_t)j * TT * ROW), c0 + j * BOX, t0, b);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
            load_tile<CSGU, KP, SPLIT, GATE>(a, maps, tl, tile + 2 * gridDim.x, hopper::smem_u32(stage),
                                             bar0 + 8 * (k & 1));
        }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The tiling of one launch: rows and channels of a tile, threads of a block.
struct Tiling {
    int rows, chans, threads;
};

// CSGU tiles span all C channels (the LayerNorm needs them) up to
// MAX_C_CSGU, merge tiles and wider CSGU tiles 128 where C allows; one thread
// a channel, up to 512.
inline bool csgu_split(const Args& a) { return a.C > MAX_C_CSGU; }
inline Tiling choose_tiling(const Args& a, bool csgu, bool large) {
    Tiling t;
    const bool slices = !csgu || csgu_split(a);
    t.rows = large ? (slices ? 64 : 32) : 16;
    t.chans = (slices && a.C % BOX == 0) ? BOX : a.C;
    t.threads = (((t.chans < MAX_THREADS ? t.chans : MAX_THREADS) + 31) / 32) * 32;
    return t;
}

inline void device_limits(int& n_sm, int& max_smem) {
    static int sm = 0, smem = 0;
    if (sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        cudaDeviceGetAttribute(&sm, cudaDevAttrMultiProcessorCount, dev);
    }
    n_sm = sm;
    max_smem = smem;
}

// The larger tiles where there are at least two of them an SM and they fit.
inline bool use_large(const Args& a, bool csgu, int KP) {
    int n_sm, max_smem;
    device_limits(n_sm, max_smem);
    const Tiling t = choose_tiling(a, csgu, true);
    const Tiles tl(a, csgu, KP, t.rows, t.chans, csgu && a.gated);
    return tl.n >= 2 * n_sm && tl.smem <= (size_t)max_smem;
}

// As many blocks as fit on the card at once (a multiple of the slices, so
// that a block keeps its channels and their weights), at most one a tile.
template <typename Kernel>
inline cudaError_t launch_tiled(Kernel kernel, const Args& a, bool csgu, int KP, cudaStream_t stream) {
    const Tiling t = choose_tiling(a, csgu, use_large(a, csgu, KP));
    const Tiles tl(a, csgu, KP, t.rows, t.chans, csgu && a.gated);
    Maps maps{};
    const cuuint64_t ld = (cuuint64_t)a.ldx * 2, tv = a.t_valid > 0 ? (a.t_valid < a.T ? a.t_valid : a.T) : 1;
    const cuuint64_t dims_in[3] = {(cuuint64_t)a.C, tv, (cuuint64_t)a.B};
    const cuuint64_t dims[3] = {(cuuint64_t)a.C, (cuuint64_t)a.T, (cuuint64_t)a.B};
    const cuuint64_t strides_x[2] = {ld, ld * a.T};
    const cuuint64_t strides_out[2] = {(cuuint64_t)a.C * 2, (cuuint64_t)a.C * 2 * a.T};
    const cuuint32_t box_in[3] = {BOX, (cuuint32_t)tl.rows_in, 1}, box_rows[3] = {BOX, (cuuint32_t)t.rows, 1};
    cudaError_t err = hopper::tensor_map_bf16(&maps.in, a.x + (csgu ? a.C : 0), 3, dims_in, strides_x, box_in,
                                              CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess && csgu && a.gated)
        err = hopper::tensor_map_bf16(&maps.xr, a.x, 3, dims, strides_x, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
        err = hopper::tensor_map_bf16(&maps.out, a.out, 3, dims, strides_out, box_rows, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(tl.smem));
    if (err != cudaSuccess) return err;
    int n_sm, max_smem, per_sm = 0;
    device_limits(n_sm, max_smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, t.threads, tl.smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    int grid = per_sm * n_sm;
    grid = grid >= tl.n_slices ? grid - grid % tl.n_slices : grid;
    grid = grid < tl.n ? grid : tl.n;
    if (csgu && t.chans < a.C) {
        csgu_stats_kernel<<<ceil_div(a.B * a.T, 8), 256, 0, stream>>>(a);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, t.threads, tl.smem, stream>>>(a, maps, t.rows, t.chans);
    return cudaGetLastError();
}

// The kernel size the launch compiles for: the smallest of 7, 31, 33 that holds K.
inline int padded_k(int K) { return K <= 7 ? 7 : K <= 31 ? 31 : 33; }

cudaError_t launch_csgu(const Args& a, cudaStream_t stream);
cudaError_t launch_merge(const Args& a, cudaStream_t stream);

}  // namespace dwconv

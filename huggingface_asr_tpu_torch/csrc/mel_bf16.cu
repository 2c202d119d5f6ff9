// Log-mel front end with the DFT as a bf16 tensor-core product: the "bf16"
// and "high" modes of ops/pallas_features.py::_mel_kernel (the serving
// path's front end, PallasLogMelFrontEnd(LogMelConfig(matmul_precision=
// "bf16"))). mel.cu keeps the "highest" contract in fp32 FFMA; the CMVN
// kernel there follows either.
//
// Per frame f (samples [f*hop, f*hop + L)) and bin n of the folded bases
// (kernels/mel.py::folded_bases, Nyquist bin dropped), whose cos and sin are
// the output columns 2n and 2n + 1 (kernels/mel.py::split_bases):
//   bf16: coef[f, c] = sum_k bf16(x[f*hop + k]) hi[k, c]
//   high: coef[f, c] = sum_k  bf16(x) hi + bf16(x) lo + bf16(x - bf16(x)) hi
// (hi = bf16(dft), lo = bf16(dft - hi); the lo x lo term dropped, as the TPU
// kernel drops it), fp32 accumulation, then the power c^2 + s^2, the mel
// product and log(max(mel, floor)).
//
// What bounds it on the H100: operations, the DFT's. At B=128 x 10 s it is
// 52 GFLOP of bf16 products (0.053 ms at 989 TFLOP/s; three times that in
// "high"), against 0.037 ms for the waveform and the log-mel moved once. The
// Kaldi bank is 97.6 % zeros (501 weights of 256 x 80; each filter one run of
// at most 16 bins): its product, 0.13 GFLOP of fp32 FMA once the zeros are
// skipped, is nothing beside the DFT. What the card spends beyond that bound
// (PERF.md section 6) is latency inside a block: one block an SM at
// 128 frames, whose staging, products and mel sums follow one another.
//
// What the design does about it:
//   * the DFT runs on wgmma (m64n128k16, fp32 accumulators in registers);
//     the basis arrives by TMA, 128 output columns (64 bins: a pass) x 64
//     k-values a box, in the 128-byte-swizzled K-major layout wgmma reads,
//     through a ring of stages under full/empty mbarriers filled by one
//     producer thread (in "high" a stage holds the hi and the lo box); the
//     ring's first round goes out before the waveform is staged;
//   * the frames are the A operand, read as register fragments: frame f's band
//     j (samples j*hop .. j*hop + hop - 1 of the frame) is hop-row f + j of the
//     waveform, so a block stages the hop-rows its frames read once, as bf16
//     (and, in "high", the low halves beside them), in shared memory rows
//     padded to hop + 8 values, and a k16 step, which lies in one band because
//     hop % 16 == 0, loads its fragment from the rows f + j: a shifted row is
//     a shifted address, which a swizzled shared-memory A tile could not take.
//     The padding puts the eight rows of a fragment on eight different bank
//     quads (168 / 2 = 84 words, 84 = 20 mod 32). Each step's offset comes
//     from a table made once a block (no division in the loop). In "bf16"
//     two register sets take the boxes in pairs, so that a box's products run
//     while the next box's fragments load (wgmma_wait<1>); an odd box count
//     ends on one box from the first set (ODD);
//   * the tensor core rounds each product's sum toward zero, so one
//     accumulator over a pass's 84 "high" products (4 k16 steps x 3 terms x 7
//     boxes) ends about 2e-6 low in log-mel at every bin count, which the
//     fp64 gate sees at 1 bin (one filter over 255 bins, whose random errors
//     average out). "high" sums each box into a fresh accumulator, its 8
//     small terms (hi x lo, lo x hi) before its 4 large ones, so that only
//     the large ones round at the box's scale, and adds the boxes with
//     round-to-nearest fp32 adds, as the plain version adds its bands'
//     products. The sum is added before the next box is issued, so "high"
//     takes its boxes one at a time from one register set. "bf16" (28
//     products, its error the bf16 rounding of the waveform) keeps one
//     accumulator a pass;
//   * the waveform arrives by one bulk copy into the rows that the power and
//     the log-mel take later, and the threads convert it there;
//   * two consumer warpgroups (CW = 2), 64 frames each, share every basis
//     tile: a tile feeds 128 frames, half the L2 reads of one warpgroup a
//     tile. Where that grid would not cover the card's SMs (B=8 x 10 s: 64
//     blocks) the block has one consumer warpgroup and 64 frames (CW = 1):
//     twice the blocks, all SMs busy;
//   * the bases' columns interleave each bin's cos and sin, so that the two
//     sit in one thread's accumulator pair (fragment columns 2q, 2q + 1) and
//     the power is formed in registers, then stored for the pass, bin b in
//     column b % 128 of the block's power rows: the last two passes' power;
//   * the mel product is sparse: each filter is summed over its own run of
//     nonzero bins (kernels/mel.py::mel_bands: the runs, ordered by the pass
//     in which each ends, a run within that pass and the one before it), in
//     bin order and in fp32 FMA, its weights packed after the runs. A run
//     that spans more passes (a bank of few, wide filters: the Kaldi bank's
//     at 1-7 and 9-11 bins) is cut into segments that each lie so, summed in
//     the rounds after their passes: a segment hands its two sums to the next
//     through a carry slot in shared memory (CARRY_OUT), which starts from
//     them (CARRY_IN), and only the last takes the log, so the filter is
//     still one chain of FMAs in bin order. Only a table with carry slots
//     runs the kernel that reads the flags (template CARRY): the flags'
//     branches cost 4-5 % of the device time at 80 and 128 bins on an H100
//     (profile_kernel_variants.py melbf16). A skipped
//     zero weight would have added fma(p, 0, acc) = acc for a finite power
//     p >= 0: the sum is the dense in-order sum bit for bit. A pass's sums run
//     while the next pass's products do (two filters a warp after each box),
//     a warp a filter, a lane two frames: the weight loads are broadcasts and
//     a column of the power rows (stride 133) lies in 32 banks. The log-mel
//     rows wait in shared memory and leave in 16-byte stores (where they fit
//     beside the rest: not in "high" at CW = 2, which stores each value as
//     its filter is summed; "bf16" at CW = 2 past 92 bins (TIGHT) keeps them
//     with a ring of 3 stages, not 4, and rows of 4-byte pieces).
//     Nothing else holds the bin count: a segment row a warp takes, its run
//     any width within two passes, so 1, 23 or 128 bins run the same code.
#include "hopper.cuh"

// With ASR_MEL_PHASES defined (profile_mel_phases.py builds such a copy),
// thread 0 of each block in the first frame tile records clock64() at the
// phases' ends and writes the cycles since its start over its utterance's
// first log-mel row: the staging, each pass's products, the end.
#ifdef ASR_MEL_PHASES
#define MEL_PHASE() (phase_n < 15 ? (void)(phase_t[phase_n++] = clock64()) : (void)0)
#else
#define MEL_PHASE() ((void)0)
#endif

namespace {

using namespace hopper;

constexpr int BINS = 64;                // bins of a pass
constexpr int COLS = 2 * BINS;          // output columns of a pass: a box's rows
constexpr int BK = 64;                  // k-values of a box: one 128-byte swizzled row
constexpr int BOX_BYTES = COLS * BK * 2;
constexpr int PW_COLS = 2 * BINS;       // the power of the last two passes, bin b in column b % 128
constexpr int PW_LD = PW_COLS + 5;      // its row stride in floats: 133, odd (a column in 32 banks)
constexpr int UNROLL = 8;               // float4 loads a thread has in flight while staging
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // CW = 2: 128 * (2 * 232 + 40) = 384 * 168
// a segment row's last field: the filter (bits 0-7), its carry slot (8-15) and
// these flags (kernels/mel.py::MEL_CARRY_IN, MEL_CARRY_OUT)
constexpr int CARRY_IN = 1 << 16, CARRY_OUT = 1 << 17;

// TIGHT ("bf16" at CW = 2 where the staged log-mel rows of 4 stages do not
// fit: 93-128 bins): a stage fewer, and the rows at an odd stride.
template <bool HIGH, int CW, bool TIGHT = false> struct Ring {
    static constexpr int STAGES = HIGH ? 2 : TIGHT ? 3 : 4;
    static constexpr int STAGE_BYTES = (HIGH ? 2 : 1) * BOX_BYTES;
    // the log-mel rows wait in shared memory and leave coalesced, where they fit
    static constexpr bool STAGE_OUT = !(HIGH && CW == 2);
};

// Row stride (floats) of the staged log-mel: 16-byte rows, four floats past
// the bins (84 at 80 bins); TIGHT: n_mel + 1 or n_mel, odd (129 at 128), rows
// of 4-byte pieces, still one bank a lane.
__host__ __device__ inline int out_ld(int n_mel, bool tight) { return tight ? n_mel | 1 : (n_mel + 3) / 4 * 4 + 4; }

// Byte offsets of the dynamic shared memory past the 1024-aligned ring, the
// same on the host (its size) and in the kernel.
// The power, log-mel and carry rows come last: until the first pass they hold
// the block's waveform in fp32, where it fits. A carry slot is a float a frame.
struct Layout {
    int bars, steps, table, xh, xl, pw, lm, carry, end;
    __host__ __device__ Layout(int stages, int n_steps, int ft, int table_rows, int rows, int rs, bool high,
                               bool stage_out, int lm_ld, int n_slots) {
        bars = 0;
        steps = bars + 16 * stages + 16;
        table = steps + 16 * ((n_steps + 3) / 4);
        xh = table + 16 * table_rows;
        xl = xh + 2 * rows * rs;
        pw = xl + (high ? 2 * rows * rs : 0);
        lm = pw + 4 * ft * PW_LD;
        carry = lm + (stage_out ? 4 * ft * lm_ld : 0);
        end = carry + 4 * ft * n_slots;
    }
};

// Loads the register A fragments of box kb's four k16 steps into ah (and al)
// and issues its products into acc: four, twelve in "high". xh and xl point
// at this lane's first fragment row and column pair; step s's fragment lies
// steps[s] values further (hop-row j = 16 s / hop, column 16 s - j hop), or,
// where steps[s] < 0 (past L, whose basis rows the TMA filled with zeros),
// is zero. Every box issues the same products, so the issue is straight-line
// code; "high" starts acc afresh (its first product does not read it) and
// issues the small terms first. The caller commits.
template <bool HIGH>
__device__ __forceinline__ void issue_box(float (&acc)[64], uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                                          const bf16* xh, const bf16* xl, const int* steps, int kb, int RS,
                                          uint32_t stage) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int off = steps[4 * kb + i];
        const bool in = off >= 0;
        const int at = in ? off : 0;
        ah[i][0] = in ? *reinterpret_cast<const uint32_t*>(xh + at) : 0u;
        ah[i][1] = in ? *reinterpret_cast<const uint32_t*>(xh + at + 8 * RS) : 0u;
        ah[i][2] = in ? *reinterpret_cast<const uint32_t*>(xh + at + 8) : 0u;
        ah[i][3] = in ? *reinterpret_cast<const uint32_t*>(xh + at + 8 * RS + 8) : 0u;
        if constexpr (HIGH) {
            al[i][0] = in ? *reinterpret_cast<const uint32_t*>(xl + at) : 0u;
            al[i][1] = in ? *reinterpret_cast<const uint32_t*>(xl + at + 8 * RS) : 0u;
            al[i][2] = in ? *reinterpret_cast<const uint32_t*>(xl + at + 8) : 0u;
            al[i][3] = in ? *reinterpret_cast<const uint32_t*>(xl + at + 8 * RS + 8) : 0u;
        }
    }
    const uint64_t bh = make_desc(stage, 16, 1024, SWIZZLE_128);
    const uint64_t bl = make_desc(stage + BOX_BYTES, 16, 1024, SWIZZLE_128);
    wgmma_fence();
    if constexpr (HIGH) {
#pragma unroll
        for (int i = 0; i < 4; ++i) wgmma_m64n128k16_rs(acc, ah[i], bl + 2 * i, i > 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) wgmma_m64n128k16_rs(acc, al[i], bh + 2 * i, 1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) wgmma_m64n128k16_rs(acc, ah[i], bh + 2 * i, 1);
}

// wav: [B, S] fp32; map: the bases [P * 2*NB, L] bf16 (P = 1 + HIGH, a row per
// output column, each bin's cos then sin); table: kernels/mel.py::
// mel_kernel_table, table_rows x 4 int32, n_rows segment rows first (CARRY:
// n_slots > 0, so some rows carry flags); out: [B, n_frames, n_mel] fp32.
template <bool HIGH, int CW, bool ODD, bool TIGHT, bool CARRY>
__global__ void __launch_bounds__(128 * (CW + 1), 1)
mel_bf16_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ wav, int S,
                const int4* __restrict__ table, int table_rows, int n_rows, int n_slots, float* __restrict__ out,
                int n_frames, int L, int hop, int NB, int n_mel, float floor_) {
    using R = Ring<HIGH, CW, TIGHT>;
    constexpr int STAGES = R::STAGES, FT = 64 * CW, THREADS = 128 * (CW + 1);
    extern __shared__ unsigned char smem_raw[];
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    unsigned char* base = smem_raw + (ring - smem_u32(smem_raw)) + STAGES * R::STAGE_BYTES;
    // a pass's boxes: pairs, whose two register sets take turns, and where
    // ODD, one more from the first set
    const int passes = NB / BINS, boxes = (L + BK - 1) / BK, total = passes * boxes;
    const int rows = FT + (L - 1) / hop, RS = hop + 8;
    const int OUT_LD = out_ld(n_mel, TIGHT);
    const Layout lay(STAGES, 4 * boxes, FT, table_rows, rows, RS, HIGH, R::STAGE_OUT, OUT_LD, n_slots);
    const uint32_t full = smem_u32(base + lay.bars), empty = full + 8 * STAGES, wav_bar = empty + 8 * STAGES;
    int4* bands_s = reinterpret_cast<int4*>(base + lay.table);
    const float* w_s = reinterpret_cast<const float*>(bands_s + n_rows + passes);
    float* pw = reinterpret_cast<float*>(base + lay.pw);
    bf16* xh = reinterpret_cast<bf16*>(base + lay.xh);
    bf16* xl = reinterpret_cast<bf16*>(base + lay.xl);
    float* lm = reinterpret_cast<float*>(base + lay.lm);
    float* carry = reinterpret_cast<float*>(base + lay.carry);
    int* steps = reinterpret_cast<int*>(base + lay.steps);
    const int tid = threadIdx.x, b = blockIdx.y, f0 = blockIdx.x * FT;
#ifdef ASR_MEL_PHASES
    long long phase_t[16];
    int phase_n = 0;
#endif
    MEL_PHASE();

    // The block's samples from its first frame's, to the end of the utterance
    // or of its hop-rows: one bulk copy into the power's and log-mel's rows
    // where the utterance's rows are 16-byte aligned and the samples fit there,
    // else loads by the threads.
    const float* x = wav + (size_t)b * S + (size_t)f0 * hop;
    const long long left = (long long)S - (long long)f0 * hop;  // samples of the utterance from the block's first
    const int n_samples = rows * hop, n_copy = (int)min((long long)n_samples, left);
    const bool bulk = S % 4 == 0 && 4 * n_samples <= lay.end - lay.pw;
    float* xf = reinterpret_cast<float*>(base + lay.pw);
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 4 * CW);
        }
        mbar_init(wav_bar, 1);
        mbar_init_fence();
        if (bulk) {
            mbar_arrive_expect_tx(wav_bar, 4 * n_copy);
            bulk_load(smem_u32(xf), x, 4 * n_copy, wav_bar);
        }
    }
    __syncthreads();
    // the first round of the ring goes out before the waveform is staged
    const bool producer = tid == 128 * CW;
    auto load = [&](int g) {
        const int s = g % STAGES, p = g / boxes, kb = g - p * boxes;
        const uint32_t st = ring + s * R::STAGE_BYTES, bar = full + 8 * s;
        mbar_wait(empty + 8 * s, ((g / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, R::STAGE_BYTES);
        tma_load_2d(st, &map, bar, kb * BK, p * COLS);
        if constexpr (HIGH) tma_load_2d(st + BOX_BYTES, &map, bar, kb * BK, 2 * NB + p * COLS);
    };
    if (producer)
        for (int g = 0; g < STAGES && g < total; ++g) load(g);

    // the filters' segments (in the order the passes take them), the passes'
    // rows and the filters' weights
    for (int r = tid; r < table_rows; r += THREADS) bands_s[r] = __ldg(table + r);
    // where each k16 step's A fragment lies past a frame's first sample
    for (int i = tid; i < 4 * boxes; i += THREADS) {
        const int k = 16 * i, j = k / hop;
        steps[i] = k < L ? j * RS + k - j * hop : -1;
    }
    // hop-rows f0 .. f0 + rows - 1 as bf16 (and their low halves), zeros past
    // S: from the bulk copy, or UNROLL loads in flight a thread before the
    // first is converted
    const int n4 = n_samples / 4;
    const float inv_hop = 1.0f / hop;  // r = floor(4 i / hop) for 4 i < 2^22, the half keeping it off a boundary
    if (bulk) mbar_wait(wav_bar, 0);
    for (int i0 = tid; i0 < n4; i0 += UNROLL * THREADS) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * THREADS;
            const long long at = 4LL * i;
            if (bulk) {
                v[u] = at < n_copy ? reinterpret_cast<const float4*>(xf)[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            } else if (i < n4 && S % 4 == 0 && at + 3 < left) {
                v[u] = __ldg(reinterpret_cast<const float4*>(x + at));
            } else {
                v[u].x = i < n4 && at < left ? __ldg(x + at) : 0.0f;
                v[u].y = i < n4 && at + 1 < left ? __ldg(x + at + 1) : 0.0f;
                v[u].z = i < n4 && at + 2 < left ? __ldg(x + at + 2) : 0.0f;
                v[u].w = i < n4 && at + 3 < left ? __ldg(x + at + 3) : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int i = i0 + u * THREADS;
            if (i < n4) {
                const int r = __float2int_rz((4.0f * i + 0.5f) * inv_hop), col = 4 * i - r * hop;
                const uint32_t h01 = pack_bf16(v[u].x, v[u].y), h23 = pack_bf16(v[u].z, v[u].w);
                *reinterpret_cast<uint2*>(xh + r * RS + col) = make_uint2(h01, h23);
                if constexpr (HIGH)
                    *reinterpret_cast<uint2*>(xl + r * RS + col) =
                        make_uint2(pack_bf16(v[u].x - bf16_lo(h01), v[u].y - bf16_hi(h01)),
                                   pack_bf16(v[u].z - bf16_lo(h23), v[u].w - bf16_hi(h23)));
            }
        }
    }
    __syncthreads();
    MEL_PHASE();

    const int wg = tid / 128;
    if (wg == CW) {
        // ---- producer: one thread keeps the ring full
        if constexpr (CW == 2) setmaxnreg_dec<PRODUCER_REGS>();
        if (producer)
            for (int g = STAGES; g < total; ++g) load(g);
        return;
    }
    if constexpr (CW == 2) setmaxnreg_inc<CONSUMER_REGS>();

    // ---- consumer warpgroup wg: the block's frames 64 wg .. + 63
    const int t = tid % 128, lane = tid % 32, warp = t / 32;
    const int row = 64 * wg + 16 * warp + lane / 4, q = lane % 4;  // fragment rows row, row + 8
    const float* pw_wg = pw + 64 * wg * PW_LD;
    float* lm_wg = lm + 64 * wg * OUT_LD;
    float* carry_wg = carry + 64 * wg;       // slot s of this warpgroup's frames: carry_wg[s * FT + 0..63]
    const float* r0 = pw_wg + lane * PW_LD;  // this lane's two frames' power: frames lane, lane + 32
    const float* r1 = r0 + 32 * PW_LD;
    const int fa = f0 + 64 * wg + lane;      // their indices in the utterance

    // Sum of segment row e over its run (the power of its pass and the one
    // before it) in bin order, for this lane's two frames: a filter's bins
    // are the same for all lanes (a weight load, broadcast, for 64 power
    // loads in 32 banks); from 0 or the segment before's sums (CARRY_IN), to
    // the carry slot (CARRY_OUT) or the log, which goes to the staged rows or
    // out. The slot was written in an earlier round, before the named barrier
    // that ends it. Four bins a step, their loads issued together; a step's
    // bins past the run add fma(0, 0, a) = a.
    auto mel_filter = [&](int e) {
        const int4 band = bands_s[e];
        const float* w = w_s + band.z;  // w[i]: the filter's weight of bin band.x + i
        float* slot = carry_wg + FT * ((band.w >> 8) & 0xff);
        float a0 = 0.0f, a1 = 0.0f;
        if (CARRY && (band.w & CARRY_IN)) {
            a0 = slot[lane];
            a1 = slot[lane + 32];
        }
        for (int i = 0; i < band.y; i += 4) {
            float wk[4], p0[4], p1[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const bool in = i + u < band.y;
                const int c = (band.x + i + u) & (PW_COLS - 1);
                wk[u] = in ? w[i + u] : 0.0f;
                p0[u] = in ? r0[c] : 0.0f;  // a column past the run may hold anything, a NaN too
                p1[u] = in ? r1[c] : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                a0 = fmaf(p0[u], wk[u], a0);
                a1 = fmaf(p1[u], wk[u], a1);
            }
        }
        if (CARRY && (band.w & CARRY_OUT)) {
            slot[lane] = a0;
            slot[lane + 32] = a1;
            return;
        }
        const int m = CARRY ? band.w & 0xff : band.w;
        a0 = logf(fmaxf(a0, floor_));
        a1 = logf(fmaxf(a1, floor_));
        if constexpr (R::STAGE_OUT) {
            lm_wg[lane * OUT_LD + m] = a0;
            lm_wg[(lane + 32) * OUT_LD + m] = a1;
        } else {
            float* o = out + ((size_t)b * n_frames + fa) * n_mel + m;
            if (fa < n_frames) *o = a0;
            if (fa + 32 < n_frames) o[32 * (size_t)n_mel] = a1;
        }
    };

    const bf16* xa = xh + row * RS + 2 * q;  // this lane's first A fragment row and column pair
    const bf16* xla = xl + row * RS + 2 * q;
    uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
    int g = 0;  // boxes taken so far
    // Pass p's products run while the warps sum pass p - 1's filters (warp w
    // takes the pass's filter rows w, w + 4, ...): two filters after each box
    // is issued, the rest after the pass's last box. A last round, p ==
    // passes, sums the last pass's filters alone.
    for (int p = 0; p <= passes; ++p) {
        const int4 range = p > 0 ? bands_s[n_rows + p - 1] : make_int4(0, 0, 0, 0);
        int e = warp;  // the next of pass p - 1's filter rows this warp sums
        if (p < passes) {
            float acc[64], sum[64];  // sum: "high"'s boxes, added
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;
            fence_regs(acc);
            if constexpr (HIGH) {
                for (int kb = 0; kb < boxes; ++kb, ++g) {
                    mbar_wait(full + 8 * (g % STAGES), (g / STAGES) & 1);
                    issue_box<HIGH>(acc, ah0, al0, xa, xla, steps, kb, RS, ring + (g % STAGES) * R::STAGE_BYTES);
                    wgmma_commit();
                    for (int n = 0; n < 2 && e < range.y; ++n, e += 4) mel_filter(range.x + e);
                    wgmma_wait<0>();
                    fence_regs(acc);
                    if (lane == 0) mbar_arrive(empty + 8 * (g % STAGES));
#pragma unroll
                    for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
                }
            } else {
                for (int kb = 0; kb + 1 < boxes; kb += 2, g += 2) {
                    // box kb from register set 0, box kb + 1 from set 1; a set is
                    // loaded again only after the products that read it are done
                    mbar_wait(full + 8 * (g % STAGES), (g / STAGES) & 1);
                    issue_box<HIGH>(acc, ah0, al0, xa, xla, steps, kb, RS, ring + (g % STAGES) * R::STAGE_BYTES);
                    wgmma_commit();
                    for (int n = 0; n < 2 && e < range.y; ++n, e += 4) mel_filter(range.x + e);
                    wgmma_wait<1>();  // the box before is done: hand its stage back
                    if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
                    mbar_wait(full + 8 * ((g + 1) % STAGES), ((g + 1) / STAGES) & 1);
                    issue_box<HIGH>(acc, ah1, al1, xa, xla, steps, kb + 1, RS,
                                    ring + ((g + 1) % STAGES) * R::STAGE_BYTES);
                    wgmma_commit();
                    for (int n = 0; n < 2 && e < range.y; ++n, e += 4) mel_filter(range.x + e);
                    wgmma_wait<1>();
                    if (lane == 0) mbar_arrive(empty + 8 * (g % STAGES));
                }
                if constexpr (ODD) {
                    mbar_wait(full + 8 * (g % STAGES), (g / STAGES) & 1);
                    issue_box<HIGH>(acc, ah0, al0, xa, xla, steps, boxes - 1, RS,
                                    ring + (g % STAGES) * R::STAGE_BYTES);
                    wgmma_commit();
                    for (int n = 0; n < 2 && e < range.y; ++n, e += 4) mel_filter(range.x + e);
                    wgmma_wait<1>();
                    if (boxes > 1 && lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
                    ++g;
                }
                wgmma_wait<0>();
                fence_regs(acc);
                if (lane == 0) mbar_arrive(empty + 8 * ((g - 1) % STAGES));
            }
            MEL_PHASE();
            for (; e < range.y; e += 4) mel_filter(range.x + e);
            // the power of pass p goes over that of pass p - 2: pass p - 1's
            // sums, which read it, are done
            named_barrier(1 + wg, 128);
            // c^2 + s^2 as the plain version rounds it: the pair (4j + 2h,
            // 4j + 2h + 1) is the cos and sin of bin 4j + q, row row + 8h
            const int col0 = BINS * (p & 1) + q;
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float c = HIGH ? sum[4 * j + 2 * h] : acc[4 * j + 2 * h];
                    const float s = HIGH ? sum[4 * j + 2 * h + 1] : acc[4 * j + 2 * h + 1];
                    pw[(row + 8 * h) * PW_LD + col0 + 4 * j] = __fadd_rn(__fmul_rn(c, c), __fmul_rn(s, s));
                }
            named_barrier(1 + wg, 128);
        } else {
            for (; e < range.y; e += 4) mel_filter(range.x + e);
        }
    }
    if constexpr (R::STAGE_OUT) {
        // this warpgroup's log-mel rows leave in one coalesced run
        named_barrier(1 + wg, 128);
        const int fw = f0 + 64 * wg, n_out = min(64, n_frames - fw);
        if (n_mel % 4 == 0 && !TIGHT) {
            const int q4 = n_mel / 4;  // 16-byte pieces a row
            float4* o = reinterpret_cast<float4*>(out + ((size_t)b * n_frames + fw) * n_mel);
            for (int i = t; i < n_out * q4; i += 128) {
                const int r = i / q4;
                o[i] = *reinterpret_cast<const float4*>(lm_wg + r * OUT_LD + 4 * (i - r * q4));
            }
        } else {
            for (int r = warp; r < n_out; r += 4) {
                float* o = out + ((size_t)b * n_frames + fw + r) * n_mel;
                for (int c = lane; c < n_mel; c += 32) o[c] = lm_wg[r * OUT_LD + c];
            }
        }
    }
#ifdef ASR_MEL_PHASES
    MEL_PHASE();
    if (tid == 0 && blockIdx.x == 0) {
        for (int k = 1; k < phase_n; ++k) out[(size_t)b * n_frames * n_mel + k - 1] = (float)(phase_t[k] - phase_t[0]);
        out[(size_t)b * n_frames * n_mel + 15] = (float)(phase_n - 1);
    }
#endif
}

// The dynamic shared memory of a block.
template <bool HIGH, int CW, bool TIGHT>
size_t mel_smem(int L, int hop, int table_rows, int n_mel, int n_slots) {
    using R = Ring<HIGH, CW, TIGHT>;
    constexpr int FT = 64 * CW;
    const Layout lay(R::STAGES, 4 * ((L + BK - 1) / BK), FT, table_rows, FT + (L - 1) / hop, hop + 8, HIGH,
                     R::STAGE_OUT, out_ld(n_mel, TIGHT), n_slots);
    return 1024 + (size_t)R::STAGES * R::STAGE_BYTES + lay.end;
}

// Registers of the CW = 2 kernel: setmaxnreg.inc waits until the pool the
// block was launched with can give what the consumers take, so a kernel
// compiled with fewer would hang, not trap.
template <bool HIGH, int CW, bool ODD, bool TIGHT = false, bool CARRY = false>
cudaError_t launch_mel(const CUtensorMap& map, const float* wav, int B, int S, const int4* table, int table_rows,
                       int n_rows, int n_slots, float* out, int n_frames, int L, int hop, int NB, int n_mel,
                       float floor_, cudaStream_t stream) {
    using R = Ring<HIGH, CW, TIGHT>;
    constexpr int FT = 64 * CW, THREADS = 128 * (CW + 1);
    auto kernel = mel_bf16_kernel<HIGH, CW, ODD, TIGHT, CARRY>;
    const size_t smem = mel_smem<HIGH, CW, TIGHT>(L, hop, table_rows, n_mel, n_slots);
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (CW == 2) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return err;
        if (attr.numRegs * THREADS < 128 * (CW * CONSUMER_REGS + PRODUCER_REGS)) return cudaErrorLaunchOutOfResources;
    }
    dim3 grid(ceil_div(n_frames, FT), B);
    kernel<<<grid, THREADS, smem, stream>>>(map, wav, S, table, table_rows, n_rows, n_slots, out, n_frames, L, hop,
                                            NB, n_mel, floor_);
    return cudaGetLastError();
}

}  // namespace

// wav: [B, S] fp32; dft: [1 + high, 2*NB, L] bf16 (kernels/mel.py::split_bases:
// the transposed hi and lo bases, a bin's cos and sin in adjacent rows);
// table: [table_rows, 4] int32, kernels/mel.py::mel_kernel_table: n_rows
// segment rows (first nonzero bin, width, offset of its weights, filter | carry
// slot << 8 | CARRY_IN | CARRY_OUT) ordered by the pass of 64 bins in which
// the segment ends, each within that pass and the one before it, a filter's
// segments in bin order, n_slots carry slots among them; a row per pass (its
// segments' first row, their count, 0, 0); then the filters' nonzero
// weights, fp32 bits, four a row; out: [B, n_frames, n_mel] fp32 log-mel.
// Takes NB % 64 == 0, any n_mel whose block fits the shared memory (at L =
// 400, hop = 160: up to 128 bins, which is kernels/mel.py::MEL_MAX_BINS; else
// an error is returned), L % 16 == 0, hop % 16 == 0 and frames within S (the
// wrapper checks). The block has two consumer warpgroups (128 frames) when
// that grid covers the card's SMs at least once, else one (64 frames).
ASR_API int asr_log_mel_bf16(const void* wav, const void* dft, const void* table, int table_rows, int n_rows,
                             int n_slots, void* out, int B, int S, int n_frames, int L, int hop, int NB, int n_mel,
                             float floor_, int high, void* stream) {
    if (B < 1 || B > 65535 || n_frames < 1 || L < 16 || L % 16 || hop < 16 || hop % 16 || NB < BINS ||
        NB % BINS || n_mel < 1 || n_mel > 256 || n_rows < n_mel || n_slots < 0 || n_slots > 256 ||
        table_rows < n_rows + NB / BINS || table_rows > 4096)
        return static_cast<int>(cudaErrorInvalidValue);
    const int P = high ? 2 : 1;
    const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)P * 2 * NB}, strides[1] = {(cuuint64_t)L * 2};
    const cuuint32_t box[2] = {BK, COLS};
    CUtensorMap map;
    cudaError_t err = tensor_map_bf16(&map, dft, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool wide = (long long)ceil_div(n_frames, 128) * B >= 132;
    auto st = static_cast<cudaStream_t>(stream);
    const float* w = static_cast<const float*>(wav);
    const int4* tb = static_cast<const int4*>(table);
    float* o = static_cast<float*>(out);
    const bool odd = (L + BK - 1) / BK % 2;
    // "bf16" at CW = 2 whose block does not fit with 4 stages (93-128 bins at L = 400, hop = 160, no carry
    // slots there): TIGHT, which takes no carry
    const bool tight = !high && wide && mel_smem<false, 2, false>(L, hop, table_rows, n_mel, n_slots) > 232448;
#define ASR_MEL_LAUNCH(H, C, O) \
    (n_slots ? launch_mel<H, C, O, false, true>(map, w, B, S, tb, table_rows, n_rows, n_slots, o, n_frames, L, hop, \
                                                NB, n_mel, floor_, st) \
             : launch_mel<H, C, O>(map, w, B, S, tb, table_rows, n_rows, n_slots, o, n_frames, L, hop, NB, n_mel, \
                                   floor_, st))
#define ASR_MEL_TIGHT(O) \
    launch_mel<false, 2, O, true>(map, w, B, S, tb, table_rows, n_rows, n_slots, o, n_frames, L, hop, NB, n_mel, \
                                  floor_, st)
    if (high)  // "high" takes its boxes one at a time: ODD is bf16's
        err = wide ? ASR_MEL_LAUNCH(true, 2, false) : ASR_MEL_LAUNCH(true, 1, false);
    else if (tight && n_slots)
        err = cudaErrorInvalidValue;
    else if (tight)
        err = odd ? ASR_MEL_TIGHT(true) : ASR_MEL_TIGHT(false);
    else
        err = wide ? (odd ? ASR_MEL_LAUNCH(false, 2, true) : ASR_MEL_LAUNCH(false, 2, false))
                   : (odd ? ASR_MEL_LAUNCH(false, 1, true) : ASR_MEL_LAUNCH(false, 1, false));
#undef ASR_MEL_LAUNCH
#undef ASR_MEL_TIGHT
    return static_cast<int>(err);
}

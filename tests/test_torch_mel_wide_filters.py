"""PyTorch port: the bf16/high log-mel kernel's table (``kernels/mel.py::
mel_bands``) at every mel-bin count, wide filters included.

``csrc/mel_bf16.cu`` keeps the power of the last two passes of 64 bins. The
Kaldi bank at 1-7 and 9-11 bins has filters whose run of nonzero bins spans
more (filter 9 of 11 runs over bins 127..203); the table cuts such a run into
segments, each within the pass it ends in and the one before, and the kernel
carries a segment's two sums to the next through a slot in shared memory, so
each filter is still one chain of FMAs in bin order. Here, with numpy and
torch alone but for the last test, which imports JAX: the table builds and fits the kernel's
shared memory at every count, a walk of it in the kernel's round order reads
only what the kernel keeps and gives the dense in-order sums bit for bit, the
tables that built before segments existed are byte for byte the same, both
gates admit exactly what builds, and the 10-bin "bf16" front end's plain
version matches the JAX package's Pallas kernel in interpret mode.
"""

import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from huggingface_asr_tpu_torch.cli.evaluate import recipe_frontend_refusal
from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.fast_infer import fused_encoder_refusal
from huggingface_asr_tpu_torch.ops.features import LogMelConfig

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "huggingface_asr_tpu_torch" / "csrc" / "mel_bf16.cu"
FLAGSHIP = EBranchformerConfig.from_dict(json.loads((ROOT / "configs" / "ebranchformer_base_ctc.json").read_text()))
CONFIGS = ({}, {"min_frequency": 0.0})
COUNTS = range(1, K3.MEL_MAX_BINS + 1)
PASS = K3.MEL_PASS_BINS

# The lines of csrc/mel_bf16.cu that ``_smem`` recomputes, in their order
# there (comments dropped): the pass and box, the power rows' stride, the
# ring, the staged log-mel rows' stride, ``Layout`` and ``mel_smem``.
SMEM_LINES = (
    "constexpr int BINS = 64;",
    "constexpr int COLS = 2 * BINS;",
    "constexpr int BK = 64;",
    "constexpr int BOX_BYTES = COLS * BK * 2;",
    "constexpr int PW_COLS = 2 * BINS;",
    "constexpr int PW_LD = PW_COLS + 5;",
    "static constexpr int STAGES = HIGH ? 2 : TIGHT ? 3 : 4;",
    "static constexpr int STAGE_BYTES = (HIGH ? 2 : 1) * BOX_BYTES;",
    "static constexpr bool STAGE_OUT = !(HIGH && CW == 2);",
    "__host__ __device__ inline int out_ld(int n_mel, bool tight) { "
    "return tight ? n_mel | 1 : (n_mel + 3) / 4 * 4 + 4; }",
    "bars = 0;",
    "steps = bars + 16 * stages + 16;",
    "table = steps + 16 * ((n_steps + 3) / 4);",
    "xh = table + 16 * table_rows;",
    "xl = xh + 2 * rows * rs;",
    "pw = xl + (high ? 2 * rows * rs : 0);",
    "lm = pw + 4 * ft * PW_LD;",
    "carry = lm + (stage_out ? 4 * ft * lm_ld : 0);",
    "end = carry + 4 * ft * n_slots;",
    "const Layout lay(R::STAGES, 4 * ((L + BK - 1) / BK), FT, table_rows, FT + (L - 1) / hop, hop + 8, HIGH,",
    "R::STAGE_OUT, out_ld(n_mel, TIGHT), n_slots);",
    "return 1024 + (size_t)R::STAGES * R::STAGE_BYTES + lay.end;",
)


def _banks():
    for kw in CONFIGS:
        for n in COUNTS:
            yield kw, n, K3.folded_bank(LogMelConfig(num_mel_bins=n, **kw))


def _smem(high, cw, tight, table_rows, n_mel, n_slots, L=400, hop=160):
    """``mel_smem`` of csrc/mel_bf16.cu recomputed from the lines in
    ``SMEM_LINES``: change the two together."""
    stages = 2 if high else 3 if tight else 4
    stage_out = not (high and cw == 2)
    ft, boxes = 64 * cw, -(-L // 64)
    rows, rs = ft + (L - 1) // hop, hop + 8
    lm_ld = n_mel | 1 if tight else (n_mel + 3) // 4 * 4 + 4
    end = 16 * stages + 16 + 16 * -(-4 * boxes // 4) + 16 * table_rows + 2 * rows * rs * (2 if high else 1)
    end += 4 * ft * 133 + (4 * ft * lm_ld if stage_out else 0) + 4 * ft * n_slots
    return 1024 + stages * (2 if high else 1) * 128 * 64 * 2 + end


def test_table_builds_and_fits_at_every_count():
    """At every count from 1 to ``MEL_MAX_BINS`` (128), of the default front
    end and at ``min_frequency=0.0``, the table builds: counts 1-7 and 9-11
    need carry slots (at most 2), the others none, so the tables of 12 bins
    and up are one row a filter. The block fits the card's 232,448 bytes of
    shared memory in every variant the entry can launch: "high" and "bf16"
    at one and two consumer warpgroups, "bf16"'s ``TIGHT`` form where the
    four-stage one does not fit (93-128 bins, no slot among them)."""
    code = [line.split("//")[0].strip() for line in CSRC.read_text().splitlines()]
    at = 0
    for line in SMEM_LINES:
        assert line in code[at:], line
        at = code.index(line, at) + 1
    tight_counts = set()
    for kw, n, mel in _banks():
        table, n_rows, slots = K3._kernel_table(mel)
        assert np.array_equal(table, K3.mel_kernel_table(mel))
        assert (slots > 0) == (n in set(range(1, 8)) | {9, 10, 11}), (kw, n, slots)
        assert slots <= 2 and (n_rows == n) == (slots == 0), (kw, n, n_rows, slots)
        rows = table.shape[0]
        for high, cw in ((True, 1), (True, 2), (False, 1)):
            assert _smem(high, cw, False, rows, n, slots) <= 232448, (kw, n, high, cw)
        if _smem(False, 2, False, rows, n, slots) > 232448:
            tight_counts.add(n)
            assert slots == 0 and _smem(False, 2, True, rows, n, slots) <= 232448, (kw, n)
    assert tight_counts == set(range(93, 129)), sorted(tight_counts)


def _fma(acc, p, w):
    """fp32 fmaf, emulated in fp64 (fp32 x fp32 is exact there)."""
    return (acc.astype(np.float64) + p.astype(np.float64) * np.float64(w)).astype(np.float32)


def test_table_walk_in_round_order_rebuilds_each_filter():
    """A walk of the table as the kernel takes it: after pass p (of 64 bins)
    its power goes over the columns of pass p - 2 (bin b in column b % 128,
    NaN before any pass), and round p + 1 sums pass p's segments from the
    two passes kept, from 0 or the segment before's slot, into the slot or
    the filter's output. At every count of both front ends each segment lies
    within its round's two passes, each filter's segments rebuild its run of
    nonzero bins in bin order with the bank's weights at their offsets, every
    filter is stored once and no slot is left, and the sums are the dense
    in-order fp32 sums bit for bit on powers spread over 20 decades."""
    rng = np.random.default_rng(26)
    power = (10.0 ** rng.uniform(-12, 8, (8, 256))).astype(np.float32)
    power[0] = 0.0
    for kw, n, mel in _banks():
        table, n_rows, _ = K3._kernel_table(mel)
        nb = mel.shape[0]
        passes = nb // PASS
        weights = table[n_rows + passes:].reshape(-1).view(np.float32)
        window = np.full((power.shape[0], 2 * PASS), np.nan, np.float32)
        slots, out, runs = {}, {}, {m: [] for m in range(n)}
        for p in range(passes + 1):
            if p:
                start, count = table[n_rows + p - 1, :2]
                for first, width, off, tag in table[start:start + count]:
                    m, slot = int(tag) & 0xFF, int(tag) >> 8 & 0xFF
                    if width:
                        assert PASS * (p - 2) <= first and (first + width - 1) // PASS == p - 1, (kw, n, m, p)
                    acc = slots.pop(slot) if tag & K3.MEL_CARRY_IN else np.zeros(power.shape[0], np.float32)
                    for i in range(width):
                        acc = _fma(acc, window[:, (first + i) % (2 * PASS)], weights[off + i])
                    if tag & K3.MEL_CARRY_OUT:
                        assert slot not in slots
                        slots[slot] = acc
                    else:
                        assert m not in out
                        out[m] = acc
                    runs[m].append((int(first), int(width), int(off)))
            if p < passes:
                window[:, PASS * (p % 2):PASS * (p % 2 + 1)] = power[:, PASS * p:PASS * (p + 1)]
        assert not slots and sorted(out) == list(range(n)), (kw, n)
        for m in range(n):
            nz = np.flatnonzero(mel[:, m])
            segs = runs[m]
            bins = np.concatenate([np.arange(f, f + w) for f, w, _ in segs])
            np.testing.assert_array_equal(bins, nz)
            for f, w, o in segs:
                np.testing.assert_array_equal(weights[o:o + w], mel[f:f + w, m])
            dense = np.zeros(power.shape[0], np.float32)
            for k in nz:
                dense = _fma(dense, power[:, k], mel[k, m])
            np.testing.assert_array_equal(out[m].view(np.int32), dense.view(np.int32))


# sha256 of the tables at 23, 80 and 128 bins before runs were cut into segments
DIGESTS = {
    ((), 23): "aa27d2228bdb93b8e10ba8d33ac8785de95d0075b8d51df7b19c82f62892217b",
    ((), 80): "1fb180b18e1a63a8f911a2440282f9a521dc831824a918356d41ff3d3f8ce38b",
    ((), 128): "37a8e775498e05c2b0e143a4e34026f303cf99c3a39316aa2ea962d0a69f5cee",
    ((("min_frequency", 0.0),), 23): "fef968d6c0cc086323002b19341bf1c9b38c0f6c018e09a1211935ee67a07011",
    ((("min_frequency", 0.0),), 80): "04e97213d461a9ba43a3abdec732294b137916fbc760db9c2b70c8a458702f26",
    ((("min_frequency", 0.0),), 128): "3e3903c51cee0fd6b95f0b342bef0320ac9aa8cd555bef135d6cd591c620078e",
}


def test_tables_that_built_before_are_unchanged():
    """At 23, 80 and 128 bins, of both front ends, the table is the one
    built before runs were cut into segments, byte for byte."""
    for (kw, n), digest in DIGESTS.items():
        table = K3.mel_kernel_table(K3.folded_bases(LogMelConfig(num_mel_bins=n, **dict(kw)))[1])
        assert hashlib.sha256(table.tobytes()).hexdigest() == digest, (kw, n)


def test_gates_admit_exactly_what_builds(monkeypatch):
    """The CTC kernel route's gate (``fused_encoder_refusal(...,
    log_mel=True)``) and a recipe route's (``recipe_frontend_refusal``) admit
    the flagship at every count from 1 to 128, and the table of the bank the
    front end builds there builds. A bank whose table cannot build (a filter
    of two runs at 10 bins) is refused by both, naming the filter, before any
    request."""
    cuda = torch.device("cuda")  # the recipe gate reads the device type only
    for n in COUNTS:
        cfg = dataclasses.replace(FLAGSHIP, num_fbanks=n)
        assert fused_encoder_refusal(cfg, torch.bfloat16, log_mel=True) is None, n
        assert recipe_frontend_refusal(cuda, n, torch.bfloat16) is None, n
        K3.mel_kernel_table(K3.folded_bank(LogMelConfig(num_mel_bins=n)))
    real = K3.folded_bank

    def broken(cfg):
        mel = real(cfg).copy()
        if cfg.num_mel_bins == 10:
            mel[250, 2] = 0.5  # filter 2 runs over bins 14..34: a second run
        return mel

    monkeypatch.setattr(K3, "folded_bank", broken)
    K3.mel_bins_refusal.cache_clear()
    try:
        reason = fused_encoder_refusal(dataclasses.replace(FLAGSHIP, num_fbanks=10), torch.bfloat16,
                                       log_mel=True)
        assert reason is not None and "num_fbanks 10" in reason and "mel filter 2" in reason, reason
        reason = recipe_frontend_refusal(cuda, 10, torch.bfloat16)
        assert reason is not None and "num_mel_bins 10" in reason and "mel filter 2" in reason, reason
        assert fused_encoder_refusal(dataclasses.replace(FLAGSHIP, num_fbanks=11), torch.bfloat16,
                                     log_mel=True) is None
    finally:
        monkeypatch.undo()
        K3.mel_bins_refusal.cache_clear()


def test_bf16_front_end_at_10_bins_matches_pallas_interpret():
    """At 10 bins (filter 8 runs over bins 119..199, three passes), on the seeded noise of
    tests/test_torch_mel_bins.py (zero past 150, 171 and 200 frames):
    ``log_mel_plain`` in "bf16" against ``_mel_kernel`` in "bf16" in
    interpret mode, no CMVN, within 2e-4 as the 23-bin log-mel test; and
    ``MelFrontEnd`` in "bf16" (plain log-mel, ``cmvn_plain``, bf16 out)
    against ``PallasLogMelFrontEnd(..., fused_cmvn_bf16=True)`` at those
    lengths, within 2^-7 of the features' scale and 99 % bit for bit, rows
    past each length zeros, as the 23-bin CMVN test."""
    import jax.numpy as jnp

    from huggingface_asr_tpu.ops.features import LogMelConfig as JLogMelConfig
    from huggingface_asr_tpu.ops.pallas_features import PallasLogMelFrontEnd
    from test_torch_mel_bins import LENS, S

    noise = (0.1 * np.random.default_rng(11).standard_normal((3, S))).astype(np.float32)  # its fixture's
    for i, n in enumerate(LENS):
        noise[i, n:] = 0.0
    n_mel = 10
    wav = jnp.asarray(noise)
    jcfg = JLogMelConfig(num_mel_bins=n_mel, norm_type="none", matmul_precision="bf16")
    ref, _ = PallasLogMelFrontEnd(jcfg, interpret=True)(wav, jnp.full((3,), S, jnp.int32))
    cfg = LogMelConfig(num_mel_bins=n_mel, matmul_precision="bf16")
    fe = K3.MelFrontEnd(cfg)
    got = K3.log_mel_plain(torch.from_numpy(noise), int(cfg.num_frames(S)), fe.dft, fe.mel, cfg.hop_length,
                           cfg.mel_floor, "bf16").numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape == (3, 200, n_mel)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    j_fe = PallasLogMelFrontEnd(JLogMelConfig(num_mel_bins=n_mel, matmul_precision="bf16"), interpret=True,
                                fused_cmvn_bf16=True)
    f_ref, l_ref = j_fe(wav, jnp.asarray(LENS))
    f_got, l_got = fe(torch.from_numpy(noise), torch.from_numpy(LENS))
    assert f_got.dtype == torch.bfloat16 and f_got.shape == (3, 200, n_mel)
    np.testing.assert_array_equal(l_got.numpy(), np.asarray(l_ref))
    g, r = f_got.float().numpy(), np.asarray(f_ref, np.float32)[:, :200]
    assert np.isfinite(g).all() and np.isfinite(r).all()
    d = np.abs(g - r)
    assert d.max() <= 2 ** -7 * max(1.0, float(np.abs(r).max())), d.max()
    assert np.mean(d == 0) > 0.99, np.mean(d == 0)
    for i, n in enumerate((150, 171, 200)):
        assert np.all(g[i, n:] == 0.0)

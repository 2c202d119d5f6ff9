"""PyTorch port: the numerics the serving route's two Hopper kernels rest on,
checked on the CPU.

* The bf16 log-mel kernel (``csrc/mel_bf16.cu``) sums each mel filter over
  its own run of nonzero bins, read from ``kernels/mel.py::mel_bands``: the
  table must rebuild the folded bank exactly, a bank whose filter has two
  runs must be refused, and the in-order sum over a run must equal the dense
  in-order sum bit for bit (a skipped zero weight adds nothing).
* ``csrc/common.cuh::gelu_serving8`` reaches the correctly rounded 1 / p^4
  by rcp.approx and one Newton step in FMA: for every p^4 a bf16 input
  reaches, any start within 2 ulps (rcp.approx is within 1) rounds to
  ``1.0 / d``, the IEEE quotient ``act_plain`` takes. The step is emulated
  exactly with rationals.
"""

import json
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from huggingface_asr_tpu_torch.kernels import mel as K3
from huggingface_asr_tpu_torch.kernels.layer import _ERFC4
from huggingface_asr_tpu_torch.ops.features import LogMelConfig

ROOT = Path(__file__).resolve().parent.parent


def _shipped_mel_bins():
    bins = set()
    for path in (ROOT / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if "num_fbanks" in cfg:
            bins.add(int(cfg["num_fbanks"]))
    return sorted(bins)


@pytest.mark.parametrize("n_mel", sorted(set(_shipped_mel_bins()) | {40, 64}))
def test_mel_bands_rebuild_the_folded_bank(n_mel):
    """Each filter's row (first bin, width, offset, filter) covers exactly its
    nonzero weights: the bank rebuilt from the kernel's table alone (the rows
    and the weights packed after them) equals the folded bank, every run starts and ends on a nonzero weight, the offsets are the
    running sum of the widths in filter order, and each pass's rows hold the
    filters whose run ends in it, in filter order, none begun before the pass
    before."""
    _, mel = K3.folded_bases(LogMelConfig(num_mel_bins=n_mel))
    table = K3.mel_bands(mel)
    passes = mel.shape[0] // K3.MEL_PASS_BINS
    assert table.shape == (n_mel + passes, 4) and table.dtype == np.int32
    rows = table[:n_mel]
    assert sorted(rows[:, 3].tolist()) == list(range(n_mel))
    kernel_table = K3.mel_kernel_table(mel)
    np.testing.assert_array_equal(kernel_table[:n_mel + passes], table)
    weights = kernel_table[n_mel + passes:].reshape(-1).view(np.float32)
    rebuilt = np.zeros_like(mel)
    for first, width, off, m in rows:
        assert width > 0 and weights[off] != 0 and weights[off + width - 1] != 0
        rebuilt[first:first + width, m] = weights[off:off + width]
    np.testing.assert_array_equal(rebuilt, mel)
    by_filter = rows[np.argsort(rows[:, 3])]
    np.testing.assert_array_equal(by_filter[:, 2], np.concatenate([[0], np.cumsum(by_filter[:-1, 1])]))
    assert int(rows[:, 1].sum()) == int((mel != 0).sum())
    assert int(table[n_mel:, 1].sum()) == n_mel
    for p, (start, count, _, _) in enumerate(table[n_mel:]):
        mine = rows[start:start + count]
        assert np.all(np.diff(mine[:, 3]) > 0)
        assert np.all((mine[:, 0] + mine[:, 1] - 1) // K3.MEL_PASS_BINS == p)
        assert np.all(mine[:, 0] >= K3.MEL_PASS_BINS * (p - 1))


def test_mel_bands_refuse_what_the_kernel_cannot_sum():
    """A filter with two runs, and a bank of more than ``MEL_MAX_BINS``
    filters, are refused; a run over three passes is cut into segments that
    each lie within their pass and the one before (the first hands its sums
    on, the second starts from them); an all-zero filter is a run of width 0
    in the first pass."""
    _, mel = K3.folded_bases(LogMelConfig())
    bad = mel.copy()
    first = int(np.flatnonzero(bad[:, 40])[0])
    bad[first + 30, 40] = 0.5  # a second run, far past the first
    with pytest.raises(ValueError, match="filter 40 has nonzero"):
        K3.mel_bands(bad)
    with pytest.raises(ValueError, match="at most MEL_MAX_BINS = 128"):
        K3.mel_bands(np.zeros((256, 129), np.float32))
    wide = mel.copy()
    wide[:, 50] = 0.0
    wide[60:140, 50] = 0.25  # bins 60..139: passes 0, 1 and 2
    table = K3.mel_bands(wide)
    n_rows = table.shape[0] - 4
    assert n_rows == 81
    rows = table[:n_rows][table[:n_rows, 3] & 0xFF == 50]
    off = int(table[:n_rows][table[:n_rows, 3] == 49][0, 2]) + int((mel[:, 49] != 0).sum())
    assert rows.tolist() == [[60, 4, off, 50 | K3.MEL_CARRY_OUT], [64, 76, off + 4, 50 | K3.MEL_CARRY_IN]]
    for p in (0, 2):  # a segment in each of the passes it ends in
        start, count = table[n_rows + p, :2]
        assert int(np.sum(table[start:start + count, 3] & 0xFF == 50)) == 1
    zero = mel.copy()
    zero[:, 3] = 0.0
    table = K3.mel_bands(zero)
    row = table[:80][table[:80, 3] == 3][0]
    assert tuple(row[:2]) == (0, 0) and table[80, 0] <= list(table[:80, 3]).index(3) < table[80, 0] + table[80, 1]


@pytest.mark.parametrize("fused", [False, True])
def test_sparse_in_order_sum_equals_dense_in_order_sum(fused):
    """Powers >= 0 (0, subnormal, huge, a seeded spread over 20 decades) times
    the Kaldi bank: each filter summed over its band in bin order equals the
    sum over all 256 bins in bin order, bit for bit, in fp32, with each
    product rounded before its add or fused into it (the fused step emulated
    in fp64, where fp32 x fp32 is exact, then rounded to fp32: both sums take
    the same step, and a zero weight leaves the sum as it was)."""
    _, mel = K3.folded_bases(LogMelConfig())
    rows = K3.mel_bands(mel)[:mel.shape[1]]
    rng = np.random.default_rng(3)
    power = (10.0 ** rng.uniform(-12, 8, (64, mel.shape[0]))).astype(np.float32)
    power[0] = 0.0
    power[1, ::3] = np.float32(1e-45)
    power[2, ::5] = np.float32(3e34)

    def step(acc, p, w):
        if fused:
            return (acc.astype(np.float64) + p.astype(np.float64) * np.float64(w)).astype(np.float32)
        return acc + p * w

    for first, width, _, m in rows:
        dense = np.zeros(power.shape[0], np.float32)
        for k in range(mel.shape[0]):
            dense = step(dense, power[:, k], mel[k, m])
        sparse = np.zeros(power.shape[0], np.float32)
        for k in range(first, first + width):
            sparse = step(sparse, power[:, k], mel[k, m])
        assert dense.dtype == sparse.dtype == np.float32
        np.testing.assert_array_equal(dense.view(np.int32), sparse.view(np.int32))


def _rn32(q: Fraction) -> np.float32:
    """q (zero, or of a normal fp32's magnitude) rounded to nearest even fp32."""
    if q == 0:
        return np.float32(0.0)
    sign, q = (-1, -q) if q < 0 else (1, q)
    e = math.floor(math.log2(q))
    while Fraction(2) ** e > q:
        e -= 1
    while Fraction(2) ** (e + 1) <= q:
        e += 1
    scaled = q * Fraction(2) ** (23 - e)
    n, rem = divmod(scaled.numerator, scaled.denominator)
    rem = Fraction(rem, scaled.denominator)
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and n % 2):
        n += 1
    return np.float32(sign * float(Fraction(n) * Fraction(2) ** (e - 23)))


def test_gelu_serving8_reciprocal_step_is_correctly_rounded():
    """Every d = p^4 that ``erfc4`` forms from a finite bf16 input with |u|
    <= 10.06 (past that the reciprocal is flushed), in fp32 IEEE operations
    as ``act_plain`` forms it; from each start r0 within 2 ulps of 1 / d,
    e = fma(-d, r0, 1) and r0 + r0 e rounded once give fp32(1.0 / d)."""
    f32 = np.float32
    a4, a3, a2, a1 = (f32(a) for a in _ERFC4)
    xs = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    u = np.abs(xs[np.isfinite(xs)] * f32(-0.70710678118654752))
    u = u[u <= f32(10.06)]
    p = u * a4 + a3
    p = p * u + a2
    p = p * u + a1
    p = np.minimum(p * u + f32(1.0), f32(1e9))
    p2 = p * p
    ds = np.unique(p2 * p2)
    assert ds.dtype == np.float32 and 1000 < ds.size < 5000 and ds.min() >= 1.0
    for d in ds:
        want = f32(1.0) / d
        dq = Fraction(float(d))
        starts = [want]
        lo = hi = want
        for _ in range(2):
            lo, hi = np.nextafter(lo, f32(0)), np.nextafter(hi, f32(2))
            starts += [lo, hi]
        for r0 in starts:
            r0q = Fraction(float(r0))
            e = Fraction(float(_rn32(1 - dq * r0q)))  # fma(-d, r0, 1)
            assert _rn32(r0q + r0q * e) == want, (d, r0)  # fma(r0, e, r0)

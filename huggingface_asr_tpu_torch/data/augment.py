"""Host-side waveform augmentation: speed perturbation (the port's own copy of
``huggingface_asr_tpu/data/augment.py``; numpy and scipy).

The reference applies ``torchaudio.transforms.SpeedPerturbation`` with
factors {0.9, 1.0, 1.1} on the waveform in dataloader workers (reference:
configs/default_data_preprocessing.json:4-18). Equivalent here via polyphase
resampling (scipy): speed s = resample by 1/s. Runs in the input pipeline
(train split only); SpecAugment runs on the device inside the training step.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SpeedPerturbationConfig:
    factors: Sequence[float] = (0.9, 1.0, 1.1)
    orig_freq: int = 16000


class SpeedPerturbation:
    def __init__(self, config: SpeedPerturbationConfig = SpeedPerturbationConfig(),
                 seed: int = 0):
        self.config = config
        self._rng = np.random.default_rng(seed)
        # Precompute rational approximations of 1/factor.
        self._ratios = [
            Fraction(1.0 / f).limit_denominator(100) for f in config.factors
        ]

    def __call__(self, waveform: np.ndarray) -> np.ndarray:
        idx = int(self._rng.integers(len(self.config.factors)))
        ratio = self._ratios[idx]
        if ratio == 1:
            return waveform
        from scipy.signal import resample_poly

        return resample_poly(
            np.asarray(waveform, np.float32), ratio.numerator, ratio.denominator
        ).astype(np.float32)

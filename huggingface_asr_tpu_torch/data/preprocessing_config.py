"""Loader for reference-style on-the-fly preprocessing JSON configs (the port's
own copy of ``huggingface_asr_tpu/data/preprocessing_config.py``).

The reference drives per-split transform chains from JSON files
(reference: configs/default_data_preprocessing2d.json, interpreted by
DataPreprocessingManagerCallback, callbacks.py:69-140): entries name a
transform (dotted import path or "feature_extractor"), constructor params,
``fn_call_params``, a ``return_behaviour`` extraction spec and a
``steps_before_activation`` delay. This loader maps that SAME schema onto
the port's placement (as the JAX package places them):

  * torchaudio.transforms.SpeedPerturbation  -> host-side SpeedPerturbation
  * feature_extractor                        -> in-step log-mel (no host op)
  * augmentations.spec_aug.SpecAug           -> in-step SpecAugmentConfig
                                                (+ start-step scheduling)
  * any other dotted import path             -> resolved via importlib and
    run HOST-SIDE on the raw waveform in chain order, wrapped with the
    reference's return-extraction (general_utils.py:34-60
    FunctionReturnWrapper) and delayed-start (callbacks.py:52-66
    DelayedStartWrapper) semantics. Transforms receive numpy arrays (the
    reference hands torch tensors — the schema is identical, the array
    library is not).

Unknown non-dotted names raise (the reference would fail the same way at
``importlib.import_module``); a silent drop would make a user's custom
augmentation vanish.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from huggingface_asr_tpu_torch.data.augment import SpeedPerturbation, SpeedPerturbationConfig
from huggingface_asr_tpu_torch.ops.spec_augment import SpecAugmentConfig


def _resolve_dotted(name: str) -> Callable:
    """Import ``pkg.mod.Attr[.Nested]`` (reference callbacks.py:86-89 +
    resolve_attribute_from_nested_class)."""
    parts = name.split(".")
    last_err = None
    for split in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(module_name)
        except ImportError as e:  # try a shorter module path
            last_err = e
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError as e:
            raise ValueError(
                f"preprocessing transform {name!r}: module {module_name!r} "
                f"has no attribute path {'.'.join(parts[split:])!r}"
            ) from e
        return obj
    raise ValueError(
        f"preprocessing transform {name!r} is not importable"
    ) from last_err


def _extract_return(result: Any, behaviour: Optional[Sequence]) -> Any:
    """Reference FunctionReturnWrapper semantics (general_utils.py:34-60):
    a list of ints (tuple indices) and/or strings evaluated against the
    result's namespace (e.g. "input_features[0]")."""
    if behaviour is None:
        return result
    if not isinstance(behaviour, (list, tuple)) or not all(
        isinstance(i, (int, str)) for i in behaviour
    ):
        raise ValueError(
            "Invalid return_behaviour: use a list of integers/strings"
        )
    out = tuple(
        eval(key, {}, result) if isinstance(key, str) else result[key]  # noqa: S307 - reference-compatible extraction over the transform's result namespace
        for key in behaviour
    )
    return out[0] if len(out) == 1 else out


class HostTransformChain:
    """Ordered host-side waveform transforms with delayed-start scheduling.

    Called per example by the collator; ``advance_batch`` is called once per
    assembled batch so ``steps_before_activation`` counts train steps
    (reference DelayedStartWrapper, callbacks.py:52-66 — there the step is
    propagated from the trainer; here batch count since ``set_step``).
    """

    def __init__(self):
        self._stages: List[tuple] = []  # (fn, fn_call_params, behaviour, start)
        self._step = 0

    def append(self, fn, fn_call_params=None, return_behaviour=None,
               steps_before_activation=0):
        self._stages.append(
            (fn, dict(fn_call_params or {}), return_behaviour,
             int(steps_before_activation))
        )

    def __len__(self):
        return len(self._stages)

    def set_step(self, step: int) -> None:
        self._step = int(step)

    def advance_batch(self) -> None:
        self._step += 1

    def __call__(self, audio: np.ndarray) -> np.ndarray:
        for fn, kwargs, behaviour, start in self._stages:
            if self._step < start:
                continue
            audio = _extract_return(fn(audio, **kwargs), behaviour)
        return np.asarray(audio)


@dataclasses.dataclass
class PreprocessingPlan:
    # host-side waveform transform chain (train split): speed perturbation
    # and any custom dotted-path transforms, in JSON order
    audio_transform: Optional[HostTransformChain] = None
    # on-device augmentation + activation step
    spec_augment: Optional[SpecAugmentConfig] = None
    spec_augment_start_step: int = 0
    featurize_on_device: bool = True

    # kept for backward compatibility: the chain's first speed-perturbation
    # stage, if any (tests/tools that want the bare object)
    speed_perturbation: Optional[SpeedPerturbation] = None


def load_preprocessing_config(path: str, seed: int = 0) -> PreprocessingPlan:
    with open(path) as f:
        cfg = json.load(f)
    plan = PreprocessingPlan()
    chain = HostTransformChain()
    for entry in cfg.get("train", []):
        name = entry.get("name", "")
        params = entry.get("params", {})
        start = entry.get("steps_before_activation", 0)
        if "SpeedPerturbation" in name:
            sp = SpeedPerturbation(
                SpeedPerturbationConfig(
                    factors=tuple(params.get("factors", (0.9, 1.0, 1.1))),
                    orig_freq=params.get("orig_freq", 16000),
                ),
                seed=seed,
            )
            plan.speed_perturbation = sp
            chain.append(sp, steps_before_activation=start)
        elif name == "feature_extractor":
            plan.featurize_on_device = True
        elif "SpecAug" in name:
            kwargs = {}
            mapping = {
                "apply_time_warp": "apply_time_warp",
                "time_warp_window": "time_warp_window",
                "apply_freq_mask": "apply_freq_mask",
                "freq_mask_width_range": "freq_mask_width_range",
                "num_freq_mask": "num_freq_mask",
                "apply_time_mask": "apply_time_mask",
                "time_mask_width_range": "time_mask_width_range",
                "time_mask_width_ratio_range": "time_mask_width_ratio_range",
                "num_time_mask": "num_time_mask",
            }
            for src, dst in mapping.items():
                if src in params:
                    v = params[src]
                    kwargs[dst] = tuple(v) if isinstance(v, list) else v
            if "time_mask_width_range" in kwargs:
                kwargs.setdefault("time_mask_width_ratio_range", None)
            plan.spec_augment = SpecAugmentConfig(**kwargs)
            plan.spec_augment_start_step = start
        elif "." in name:
            # custom transform: importlib-resolved, host-side, chain order
            fn = _resolve_dotted(name)(**params)
            chain.append(
                fn,
                fn_call_params=entry.get("fn_call_params"),
                return_behaviour=entry.get("return_behaviour"),
                steps_before_activation=start,
            )
        else:
            raise ValueError(
                f"unknown preprocessing transform {name!r}: use "
                "'feature_extractor', a SpecAug/SpeedPerturbation entry, or "
                "a dotted import path"
            )
    if len(chain):
        plan.audio_transform = chain
    return plan

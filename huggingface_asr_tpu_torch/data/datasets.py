"""Config-driven multi-corpus dataset pipeline over HF ``datasets`` (the port's
own copy of ``huggingface_asr_tpu/data/datasets.py``).

Behavioral twin of the reference pipeline (reference:
src/utilities/data_utils.py:218-657): per-corpus JSON entries
(dataset_name/dataset_id/load_from_disk/splits/columns/text_transformations/
additional_args — schema recipes/librispeech/librispeech.json) are loaded,
resampled, chunked, duration-filtered, text-transformed, renamed to global
column names, and merged into global train/validation plus per-corpus test
splits named ``{dataset_id}_{split}``.

The port runs in one process, so the JAX package's host barrier (process 0
does the Arrow work, the other hosts wait) is not carried over: every Arrow
operation is a direct call. ``datasets`` is imported inside the functions
that need it. ``ColumnTable`` holds a split in memory for callers without
``datasets``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

from huggingface_asr_tpu_torch.data.text_transforms import TEXT_FILTERS, TEXT_TRANSFORMS
from huggingface_asr_tpu_torch.parallel.distributed import host_barrier, is_primary

logger = logging.getLogger(__name__)

MIN_INPUT_LEN = 0.1  # hard bounds for eval splits (conv subsampling floor /
MAX_INPUT_LEN = 100.0  # memory ceiling), reference data_utils.py:45-46


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Mirrors the reference's DataTrainingArguments surface (subset)."""

    dataset_name: Optional[str] = None  # single-corpus path or JSON config path
    dataset_config: Optional[str] = None
    datasets_creation_config: Optional[str] = None  # multi-corpus JSON
    audio_column_name: str = "audio"
    text_column_name: str = "text"
    length_column_name: str = "input_len"
    train_split: str = "train"
    validation_split: str = "validation"
    test_splits: tuple = ()
    sampling_rate: int = 16000
    max_duration_in_seconds: float = 20.0
    min_duration_in_seconds: float = 0.0
    preprocessing_num_workers: int = 4
    writer_batch_size: int = 500
    load_from_disk: bool = False
    do_resample: bool = True  # cast audio column to target rate (needs codec)
    split_long_segments_to_chunks: bool = False
    reshuffle_at_start: bool = False
    do_lower_case: bool = False
    remove_punctuation: bool = False
    validation_slice: Optional[str] = None  # "N" or "N%"
    cut_validation_from_train: bool = False
    validation_slice_seed: int = 42
    dump_prepared_dataset_to: Optional[str] = None


def _run_on_primary(dataset, method: str, tag: str, **kwargs):
    """Rank 0 runs the Arrow call; the other ranks wait for it, then make
    the same call, which ``datasets`` serves from the cache it wrote."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return getattr(dataset, method)(**kwargs)
    if is_primary():
        result = getattr(dataset, method)(**kwargs)
        host_barrier(f"{tag}:done")
        return result
    host_barrier(f"{tag}:done")
    return getattr(dataset, method)(**kwargs)  # served from the cache


def _extract_lens(audios, length_column, sampling_rate):
    """``audios``: the audio column of a batch (``map(..., input_columns=[audio])``
    passes the column itself; the JAX package's version indexes it by name
    and raises there)."""
    lens = []
    for audio in audios:
        arr = audio["array"] if isinstance(audio, dict) else audio
        lens.append(len(np.trim_zeros(np.asarray(arr))) / sampling_rate)
    return {length_column: lens}


def _chunk_long_segments(audios, audio_column, length_column, max_len, sampling_rate):
    """``audios``: the audio column of a batch, as in ``_extract_lens``."""
    from datasets import Audio

    encoder = Audio(sampling_rate=sampling_rate, mono=True)
    chunk_samples = int(max_len * sampling_rate)
    chunks, lens = [], []
    for audio in audios:
        arr = np.asarray(audio["array"] if isinstance(audio, dict) else audio)
        arr = np.trim_zeros(arr)
        for i in range(0, len(arr), chunk_samples):
            piece = arr[i : i + chunk_samples]
            chunks.append(
                encoder.encode_example({"array": piece, "sampling_rate": sampling_rate})
            )
            lens.append(len(piece) / sampling_rate)
    return {audio_column: chunks, length_column: lens}


def _apply_text_pipeline(dataset_dict, names, text_column, train_split, num_proc, writer_bs):
    """Apply named transforms/filters per split, honoring the _train suffix."""
    for raw in names or []:
        for split in list(dataset_dict.keys()):
            name = raw
            if name.endswith("_train"):
                if split != train_split:
                    continue
                name = name[: -len("_train")]
            if name in TEXT_TRANSFORMS:
                fn = TEXT_TRANSFORMS[name]
                dataset_dict[split] = _run_on_primary(
                    dataset_dict[split],
                    "map",
                    f"text:{name}:{split}",
                    function=lambda ex: {text_column: fn(ex[text_column])},
                    num_proc=num_proc,
                    writer_batch_size=writer_bs,
                    desc=f"{name} on {split}",
                )
            elif name in TEXT_FILTERS:
                fn = TEXT_FILTERS[name]
                dataset_dict[split] = _run_on_primary(
                    dataset_dict[split],
                    "filter",
                    f"filter:{name}:{split}",
                    function=lambda ex: fn(ex[text_column]),
                    num_proc=num_proc,
                    writer_batch_size=writer_bs,
                    desc=f"{name} on {split}",
                )
            else:
                raise KeyError(f"unknown text transformation '{raw}'")
    return dataset_dict


def prepare_dataset(
    dataset_dict,
    *,
    config: DataConfig,
    train_split: Optional[str],
    text_transformations: Optional[List[str]] = None,
    do_resample: bool = True,
    dataset_name: str = "",
):
    """Resample → chunk → extract lengths → duration filter → text transforms."""
    from datasets import Audio

    cfg = config
    audio_col, text_col, len_col = (
        cfg.audio_column_name,
        cfg.text_column_name,
        cfg.length_column_name,
    )

    if cfg.reshuffle_at_start:
        dataset_dict = _run_on_primary(dataset_dict, "shuffle", "shuffle", seed=42)

    if audio_col and do_resample:
        dataset_dict = dataset_dict.cast_column(
            audio_col, Audio(sampling_rate=cfg.sampling_rate)
        )

    have_lens = all(len_col in cols for cols in _column_names(dataset_dict).values())
    if audio_col and (not have_lens or "kaldi" in dataset_name):
        dataset_dict = _run_on_primary(
            dataset_dict,
            "map",
            "extract_lens",
            function=_extract_lens,
            batched=True,
            batch_size=max(cfg.writer_batch_size // 4, 1),
            num_proc=cfg.preprocessing_num_workers,
            writer_batch_size=cfg.writer_batch_size,
            input_columns=[audio_col],
            fn_kwargs={
                "length_column": len_col,
                "sampling_rate": cfg.sampling_rate,
            },
            desc="Extracting audio lens",
        )

    if audio_col and cfg.split_long_segments_to_chunks:
        first_split = next(iter(dataset_dict))
        dataset_dict = _run_on_primary(
            dataset_dict,
            "map",
            "chunk",
            function=_chunk_long_segments,
            batched=True,
            batch_size=max(cfg.writer_batch_size // 4, 1),
            num_proc=cfg.preprocessing_num_workers,
            writer_batch_size=cfg.writer_batch_size,
            input_columns=[audio_col],
            remove_columns=dataset_dict[first_split].column_names,
            fn_kwargs={
                "audio_column": audio_col,
                "length_column": len_col,
                "max_len": cfg.max_duration_in_seconds,
                "sampling_rate": cfg.sampling_rate,
            },
            desc="Splitting long segments to chunks",
        )

    # Duration filtering: user bounds on train, hard bounds on eval splits.
    for split in list(dataset_dict.keys()):
        if split == train_split:
            lo, hi = cfg.min_duration_in_seconds, cfg.max_duration_in_seconds
        else:
            lo, hi = MIN_INPUT_LEN, MAX_INPUT_LEN
        dataset_dict[split] = _run_on_primary(
            dataset_dict[split],
            "filter",
            f"durfilter:{split}",
            function=lambda ex, lo=lo, hi=hi: lo <= ex[len_col] <= hi,
            num_proc=cfg.preprocessing_num_workers,
            writer_batch_size=cfg.writer_batch_size,
            desc=f"Duration filter {split} [{lo},{hi}]s",
        )

    if text_col and text_transformations:
        dataset_dict = _apply_text_pipeline(
            dataset_dict,
            text_transformations,
            text_col,
            train_split,
            cfg.preprocessing_num_workers,
            cfg.writer_batch_size,
        )
    return dataset_dict


def _column_names(dataset_dict) -> Dict[str, List[str]]:
    return {split: list(ds.column_names) for split, ds in dataset_dict.items()}


def load_multiple_datasets(config: DataConfig):
    """Load + prepare every corpus in the JSON config, then merge.

    Train/validation splits concatenate into global ``train``/``validation``;
    test splits become ``{dataset_id}_{split}`` (reference data_utils.py:383-527).
    """
    from datasets import DatasetDict, concatenate_datasets, load_dataset, load_from_disk

    with open(config.datasets_creation_config) as f:
        corpora = json.load(f)

    merged = DatasetDict()
    train_parts, val_parts = [], []
    for corpus in corpora:
        name = corpus["dataset_name"]
        dataset_id = corpus.get("dataset_id", name)
        splits = {
            "train": corpus.get("train_splits", []),
            "validation": corpus.get("validation_splits", []),
            "test": corpus.get("test_splits", []),
        }
        logger.info("loading corpus %s", name)
        if corpus.get("load_from_disk"):
            loaded = load_from_disk(name, **corpus.get("additional_args", {}))
            if not isinstance(loaded, DatasetDict):
                loaded = DatasetDict({"train": loaded})
        else:
            loaded = DatasetDict()
            for split_list in splits.values():
                for split in split_list:
                    loaded[split] = load_dataset(
                        name, split=split, **corpus.get("additional_args", {})
                    )

        local_cfg = dataclasses.replace(
            config,
            audio_column_name=corpus.get("audio_column_name", config.audio_column_name),
            text_column_name=corpus.get("text_column_name", config.text_column_name),
            length_column_name=corpus.get(
                "length_column_name", config.length_column_name
            ),
        )
        train_split = splits["train"][0] if splits["train"] else None
        loaded = prepare_dataset(
            loaded,
            config=local_cfg,
            train_split=train_split,
            text_transformations=corpus.get("text_transformations"),
            do_resample=config.do_resample,
            dataset_name=name,
        )

        # Rename corpus-local columns to the global names + strip extras.
        renames = {
            corpus.get("audio_column_name", config.audio_column_name): config.audio_column_name,
            corpus.get("text_column_name", config.text_column_name): config.text_column_name,
            corpus.get("length_column_name", config.length_column_name): config.length_column_name,
        }
        keep = {config.audio_column_name, config.text_column_name, config.length_column_name}
        for split in list(loaded.keys()):
            ds = loaded[split]
            for src, dst in renames.items():
                if src != dst and src in ds.column_names:
                    ds = ds.rename_column(src, dst)
            ds = ds.remove_columns([c for c in ds.column_names if c not in keep])
            loaded[split] = ds

        for split in splits["train"]:
            train_parts.append(loaded[split])
        for split in splits["validation"]:
            val_parts.append(loaded[split])
        for split in splits["test"]:
            merged[f"{dataset_id}_{split}"] = loaded[split]

    if train_parts:
        merged["train"] = concatenate_datasets(train_parts)
    if val_parts:
        merged["validation"] = concatenate_datasets(val_parts)
    return merged


def _extract_num_samples(dataset, slice_str: str) -> int:
    """"N" or "N%" (reference data_utils.py:669-680)."""
    if slice_str.endswith("%"):
        return int(len(dataset) * float(slice_str[:-1]) / 100.0)
    return int(slice_str)


def resolve_validation(dataset_dict, config: DataConfig):
    """Validation slicing / carving from train (reference data_utils.py:530-574)."""
    train, valid = config.train_split, config.validation_split
    if config.cut_validation_from_train:
        if valid in dataset_dict and valid != train:
            raise ValueError("cut_validation_from_train requires no explicit validation")
        n = _extract_num_samples(dataset_dict[train], config.validation_slice or "10%")
        splits = dataset_dict[train].train_test_split(
            test_size=n, seed=config.validation_slice_seed
        )
        dataset_dict[train] = splits["train"]
        dataset_dict[valid] = splits["test"]
    elif config.validation_slice and valid in dataset_dict:
        n = _extract_num_samples(dataset_dict[valid], config.validation_slice)
        sliced = dataset_dict[valid].shuffle(seed=config.validation_slice_seed).select(range(n))
        dataset_dict[f"{valid}_full"] = dataset_dict[valid]
        dataset_dict[valid] = sliced
    return dataset_dict


def get_dataset(config: DataConfig):
    """Entry point: single corpus or multi-corpus JSON; optional dump to disk."""
    from datasets import DatasetDict, load_dataset, load_from_disk

    if config.datasets_creation_config:
        dataset = load_multiple_datasets(config)
    else:
        if config.load_from_disk:
            dataset = load_from_disk(config.dataset_name)
            if not isinstance(dataset, DatasetDict):
                dataset = DatasetDict({"train": dataset})
        else:
            dataset = load_dataset(config.dataset_name, config.dataset_config)
        transformations = []
        if config.do_lower_case:
            transformations.append("do_lower_case")
        if config.remove_punctuation:
            transformations.append("remove_punctuation")
        dataset = prepare_dataset(
            dataset,
            config=config,
            train_split=config.train_split,
            text_transformations=transformations,
            do_resample=config.do_resample,
            dataset_name=config.dataset_name or "",
        )

    dataset = resolve_validation(dataset, config)

    if config.dump_prepared_dataset_to:
        if is_primary():
            dataset.save_to_disk(config.dump_prepared_dataset_to)
        host_barrier("dump")
    return dataset


class ColumnTable:
    """One split held in memory as equal-length columns: the part of a
    ``datasets.Dataset`` that the CLIs read (``len``, ``column_names``,
    ``table[column]`` -> list, ``table[row]`` -> dict), for runs on a machine
    without ``datasets``."""

    def __init__(self, columns: Dict[str, List[Any]]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths: { {k: len(v) for k, v in columns.items()} }")
        self._columns = {k: list(v) for k, v in columns.items()}
        self._n = lengths.pop() if lengths else 0

    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._columns[key]
        return {k: v[key] for k, v in self._columns.items()}

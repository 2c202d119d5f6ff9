"""PyTorch port, the CLI slice's copied modules held against their JAX originals.

Each module the port keeps its own copy of (argument parsing and groups, the
text transforms, the dataset pipeline, the preprocessing plan, speed
perturbation, the normalizer, the evaluation artifacts, the synthetic corpus,
the CLI batch iterators, the config overrides) gets the same inputs on both
sides and must give the same outputs: equal dataclasses, equal arrays, equal
files byte for byte. ``average_checkpoints`` is held against a numpy mean.
"""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from huggingface_asr_tpu.cli import common as j_common
from huggingface_asr_tpu.data import augment as j_augment
from huggingface_asr_tpu.data import bucketing as j_bucketing
from huggingface_asr_tpu.data import collator as j_collator
from huggingface_asr_tpu.data import datasets as j_datasets
from huggingface_asr_tpu.data import preprocessing_config as j_prep
from huggingface_asr_tpu.data import synthetic_speech as j_synth
from huggingface_asr_tpu.data import text_transforms as j_text
from huggingface_asr_tpu.decoding.beam_search import BeamSearchConfig as JBeamCfg
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.training import arguments as j_args
from huggingface_asr_tpu.training import model_factory as j_factory
from huggingface_asr_tpu.utils import argparsing as j_argparsing
from huggingface_asr_tpu.utils import eval_utils as j_eval
from huggingface_asr_tpu.utils import normalizer as j_norm

from huggingface_asr_tpu_torch.cli import common as p_common
from huggingface_asr_tpu_torch.cli.evaluate import EvalArguments, build_generation_config
from huggingface_asr_tpu_torch.data import augment as p_augment
from huggingface_asr_tpu_torch.data import bucketing as p_bucketing
from huggingface_asr_tpu_torch.data import collator as p_collator
from huggingface_asr_tpu_torch.data import datasets as p_datasets
from huggingface_asr_tpu_torch.data import preprocessing_config as p_prep
from huggingface_asr_tpu_torch.data import synthetic_speech as p_synth
from huggingface_asr_tpu_torch.data import text_transforms as p_text
from huggingface_asr_tpu_torch.decoding.beam_search import BeamSearchConfig
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.gpt2_decoder import GPT2DecoderConfig
from huggingface_asr_tpu_torch.models.joint_ctc_aed import JointCTCAttentionConfig
from huggingface_asr_tpu_torch.training import arguments as p_args
from huggingface_asr_tpu_torch.training import model_factory as p_factory
from huggingface_asr_tpu_torch.utils import argparsing as p_argparsing
from huggingface_asr_tpu_torch.utils import eval_utils as p_eval
from huggingface_asr_tpu_torch.utils import normalizer as p_norm

datasets = pytest.importorskip("datasets")

ARGVS = [
    [],
    ["--output_dir", "o", "--max_steps", "7", "--no-apply_spec_augment", "--test_splits", "a", "b",
     "--ctc_weight", "0.5", "--config_overrides", "hidden_size=64;encoder_num_hidden_layers=2",
     "--num_beams", "4", "--save_nbest", "--learning_rate", "3e-4", "--validation_slice", "10%"],
    ["--dtype", "float32", "--from_pretrained", "x", "--greater_is_better", "--lm_weight", "0.3",
     "--max_duration_in_seconds", "6", "--pad_to_multiple", "25", "--no-do_resample"],
]


def _groups(module):
    return [module.ModelArguments, module.GeneralTrainingArguments, module.GenerationArguments,
            module.DataConfig]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "training", "model"])
def test_argument_parser_gives_the_jax_dataclasses(argv):
    j = j_argparsing.DataclassArgumentParser(_groups(j_args)).parse_args_into_dataclasses(argv)
    p = p_argparsing.DataclassArgumentParser(_groups(p_args)).parse_args_into_dataclasses(argv)
    for jd, pd in zip(j, p):
        d = dataclasses.asdict(pd)
        if isinstance(pd, p_args.ModelArguments):
            assert d.pop("device") == "cuda"
        assert d == dataclasses.asdict(jd)
    # the port's one extra field, and the evaluate CLI's group
    eval_argv = ["--model_type", "aed", "--fused_encoder", "off", "--batch_size", "8", "--device", "cpu"]
    ev, model = p_argparsing.DataclassArgumentParser([EvalArguments, p_args.ModelArguments]) \
        .parse_args_into_dataclasses(eval_argv)
    assert (ev.model_type, ev.fused_encoder, ev.batch_size, model.device) == ("aed", "off", 8, "cpu")


@pytest.mark.parametrize("override", ["num_beams=3;ctc_weight=0.25;early_exit=false", "length_penalty=0.5;",
                                      "max_length=40;apply_eos_space_trick=1;space_token_id=5"])
def test_override_strings_and_generation_config(override):
    gen = j_args.GenerationArguments(num_beams=2, ctc_weight=0.3, num_candidates=8, lm_weight=0.1)
    ids = {"bos": 0, "eos": 1, "pad": 3}
    j_cfg = j_argparsing.parse_override_string(override, JBeamCfg(num_beams=2, ctc_weight=0.3))
    p_cfg = p_argparsing.parse_override_string(override, BeamSearchConfig(num_beams=2, ctc_weight=0.3))
    j_d = dataclasses.asdict(j_cfg)
    for tpu_only in ("approx_candidate_topk", "approx_topk_recall"):
        j_d.pop(tpu_only)
    assert dataclasses.asdict(p_cfg) == j_d
    from huggingface_asr_tpu.cli.train_aed import build_generation_config as j_build

    j_g = dataclasses.asdict(j_build(gen, ids))
    for tpu_only in ("approx_candidate_topk", "approx_topk_recall"):
        j_g.pop(tpu_only)
    assert dataclasses.asdict(build_generation_config(gen, ids)) == j_g
    kw = {"encoder_hidden_size": 64, "decoder_n_layer": 2, "decoder_start_token_id": 5, "x": 1}
    assert p_argparsing.split_prefixed_overrides(kw) == j_argparsing.split_prefixed_overrides(kw)


TEXTS = ["Hello, World!  It's (noise) a test-", "  ignore_time_segment_in_scoring ", "",
         "WE'RE <COMMA> here <PERIOD> the 's cat 'll go", "uh-) (unfin-) done... ok?"]


def test_text_transforms_and_filters():
    assert sorted(p_text.TEXT_TRANSFORMS) == sorted(j_text.TEXT_TRANSFORMS)
    assert sorted(p_text.TEXT_FILTERS) == sorted(j_text.TEXT_FILTERS)
    for name in p_text.TEXT_TRANSFORMS:
        for t in TEXTS:
            assert p_text.TEXT_TRANSFORMS[name](t) == j_text.TEXT_TRANSFORMS[name](t), (name, t)
    for name in p_text.TEXT_FILTERS:
        assert [p_text.TEXT_FILTERS[name](t) for t in TEXTS] == [j_text.TEXT_FILTERS[name](t) for t in TEXTS]
    names = ["do_lower_case", "remove_punctuation_train", "remove_multiple_whitespaces_and_strip",
             "filter_empty_transcriptions"]
    for t in TEXTS:
        for train in (True, False):
            assert p_text.apply_text_transforms(t, names, train) == j_text.apply_text_transforms(t, names, train)


def _small_dataset_dict(rng, with_lengths):
    rows = {"audio": [], "text": [], "input_len": []}
    for i in range(12):
        n = int(rng.integers(800, 24000))
        wav = rng.standard_normal(n).astype(np.float32) * 0.1
        wav[:int(rng.integers(0, 200))] = 0.0  # leading silence that the extracted length drops
        rows["audio"].append(wav)
        rows["text"].append(TEXTS[i % len(TEXTS)])
        rows["input_len"].append(len(np.trim_zeros(wav)) / 16000)
    if not with_lengths:
        del rows["input_len"]
    ds = datasets.Dataset.from_dict(rows)
    return datasets.DatasetDict({"train": ds, "test": ds.select(range(6))})


PREPARE = dict(min_duration_in_seconds=0.2, max_duration_in_seconds=1.2, preprocessing_num_workers=1)
TRANSFORMS = ["do_lower_case", "remove_punctuation_train", "filter_empty_transcriptions"]


def _prepare(mod, with_lengths):
    return mod.prepare_dataset(_small_dataset_dict(np.random.default_rng(3), with_lengths),
                               config=mod.DataConfig(**PREPARE), train_split="train", do_resample=False,
                               text_transformations=TRANSFORMS)


def test_prepare_dataset_gives_the_jax_splits():
    j_dd, p_dd = _prepare(j_datasets, True), _prepare(p_datasets, True)
    assert sorted(j_dd) == sorted(p_dd)
    for split in j_dd:
        assert len(p_dd[split]) == len(j_dd[split]) > 0
        for col in ("text", "input_len"):
            assert list(p_dd[split][col]) == list(j_dd[split][col])
        for a, b in zip(p_dd[split]["audio"], j_dd[split]["audio"]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Without a length column both extract it; the JAX version indexes the
    # audio column that ``map(input_columns=...)`` hands it by name and raises
    # (a fault of the reference, repaired in the port's copy), so the port is
    # held against the lengths the column above was made with.
    with pytest.raises(TypeError):
        _prepare(j_datasets, False)
    extracted = _prepare(p_datasets, False)
    for split in p_dd:
        assert list(extracted[split]["input_len"]) == list(p_dd[split]["input_len"])
        assert list(extracted[split]["text"]) == list(p_dd[split]["text"])
    # the validation carve and slice
    for kw in (dict(cut_validation_from_train=True, validation_slice="3"), dict(validation_slice="50%")):
        carve = "cut_validation_from_train" in kw
        j_v = j_datasets.resolve_validation(dict(j_dd) if carve else dict(j_dd, validation=j_dd["test"]),
                                            j_datasets.DataConfig(**kw))
        p_v = p_datasets.resolve_validation(dict(p_dd) if carve else dict(p_dd, validation=p_dd["test"]),
                                            p_datasets.DataConfig(**kw))
        assert sorted(j_v) == sorted(p_v)
        for split in j_v:
            assert list(p_v[split]["text"]) == list(j_v[split]["text"])


def test_column_table_reads_like_a_dataset():
    rows = {"audio": [np.zeros(3, np.float32), np.ones(2, np.float32)], "text": ["a", "b"], "input_len": [0.1, 0.2]}
    table, ds = p_datasets.ColumnTable(rows), datasets.Dataset.from_dict(rows)
    assert len(table) == len(ds) and table.column_names == ds.column_names
    assert table["text"] == ds["text"] and table[1]["text"] == ds[1]["text"]
    with pytest.raises(ValueError):
        p_datasets.ColumnTable({"a": [1], "b": [1, 2]})


class _TimesN:
    def __init__(self, n):
        self.n = n

    def __call__(self, x, offset=0.0):
        return (x * self.n + offset,)


def test_preprocessing_plan_gives_the_jax_plan(tmp_path):
    cfg = {"train": [
        {"name": "torchaudio.transforms.SpeedPerturbation", "params": {"orig_freq": 16000, "factors": [0.9, 1.0, 1.1]},
         "steps_before_activation": 0},
        {"name": "feature_extractor", "steps_before_activation": 0},
        {"name": f"{__name__}._TimesN", "params": {"n": 3.0}, "steps_before_activation": 2,
         "fn_call_params": {"offset": 1.0}, "return_behaviour": [0]},
        {"name": "augmentations.spec_aug.SpecAug",
         "params": {"apply_time_warp": False, "freq_mask_width_range": [0, 13], "num_freq_mask": 1,
                    "time_mask_width_range": [0, 20], "num_time_mask": 3},
         "steps_before_activation": 100},
    ]}
    path = tmp_path / "prep.json"
    path.write_text(json.dumps(cfg))
    j_plan, p_plan = j_prep.load_preprocessing_config(str(path), 7), p_prep.load_preprocessing_config(str(path), 7)
    assert dataclasses.asdict(p_plan.spec_augment) == dataclasses.asdict(j_plan.spec_augment)
    assert p_plan.spec_augment_start_step == j_plan.spec_augment_start_step == 100
    assert p_plan.featurize_on_device == j_plan.featurize_on_device
    x = np.random.default_rng(0).standard_normal(8000).astype(np.float32)
    for step in range(5):
        np.testing.assert_array_equal(p_plan.audio_transform(x), j_plan.audio_transform(x))
        p_plan.audio_transform.advance_batch()
        j_plan.audio_transform.advance_batch()


@pytest.mark.parametrize("factors", [(0.9, 1.0, 1.1), (0.95, 1.05)])
def test_speed_perturbation_draws_as_jax(factors):
    j_sp = j_augment.SpeedPerturbation(j_augment.SpeedPerturbationConfig(factors=factors), seed=11)
    p_sp = p_augment.SpeedPerturbation(p_augment.SpeedPerturbationConfig(factors=factors), seed=11)
    rng = np.random.default_rng(1)
    for _ in range(6):
        x = rng.standard_normal(int(rng.integers(1000, 5000))).astype(np.float32)
        np.testing.assert_array_equal(p_sp(x), j_sp(x))


def test_english_normalizer_and_its_spelling_file():
    j_file = os.path.join(os.path.dirname(j_norm.__file__), "..", "data", "assets", "english_spelling.json")
    p_file = os.path.join(os.path.dirname(p_norm.__file__), "..", "data", "assets", "english_spelling.json")
    assert filecmp.cmp(j_file, p_file, shallow=False)
    texts = ["The colour of the Centre, uh, is grey!", "Mr. Smith paid $1,000.50 on 2nd May.",
             "[noise] <laugh> (%hesitation) *cough it's OK -- zero point five", "ignore_time_segment_in_scoring",
             ",comma he said .period hmm mm"]
    j_n, p_n = j_norm.EnglishNormalizer(), p_norm.EnglishNormalizer()
    assert [p_n(t) for t in texts] == [j_n(t) for t in texts]


REFS = ["the cat sat", "a b c d", "hello world", "one two"]
HYPS = ["the cat sad", "a c d", "hello world", "one two three"]


def test_metrics_and_evaluate_splits_write_the_jax_artifacts(tmp_path):
    assert p_eval.get_metrics(REFS, HYPS) == j_eval.get_metrics(REFS, HYPS)

    def batches():
        for i in range(0, 4, 3):
            yield {"_num_real": np.asarray(min(3, 4 - i)), "i": i}

    def decode(batch):
        return [HYPS[batch["i"] + k] if batch["i"] + k < 4 else "pad" for k in range(3)], None

    results = {}
    for name, mod in (("jax", j_eval), ("port", p_eval)):
        results[name] = mod.evaluate_splits(decode, {"test": batches(), "dev": batches()},
                                            {"test": REFS, "dev": REFS}, output_dir=str(tmp_path / name),
                                            normalizer=str.upper)
        mod.save_nbests(str(tmp_path / name / "nbest"), np.arange(24).reshape(2, 3, 4), np.linspace(-3, 0, 6)
                        .reshape(2, 3), lambda toks: " ".join(map(str, toks)))
    for split in ("test", "dev"):
        assert results["port"][split].metrics == results["jax"][split].metrics
        assert results["port"][split].num_examples == results["jax"][split].num_examples == 4
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 10
    for f in files:
        if f.startswith("metrics_"):  # wall time and rate differ run to run
            j, p = (json.loads((tmp_path / n / f).read_text()) for n in ("jax", "port"))
            for timing in ("wall_time", "tokens_per_sec"):
                j.pop(timing), p.pop(timing)
            assert p == j
        else:
            assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f


@pytest.mark.parametrize("hard", [False, True])
def test_corpus_rows_are_the_jax_corpus(tmp_path, hard):
    j_dd = j_synth.build_corpus(str(tmp_path / "c"), n_train=5, n_eval=3, seed=4, hard=hard)
    rows = p_synth.corpus_rows(n_train=5, n_eval=3, seed=4, hard=hard)
    loaded = datasets.load_from_disk(str(tmp_path / "c"))
    assert sorted(rows) == sorted(j_dd) == sorted(loaded)
    for split in rows:
        assert rows[split]["text"] == list(j_dd[split]["text"]) == list(loaded[split]["text"])
        assert rows[split]["input_len"] == list(loaded[split]["input_len"])
        for a, b in zip(rows[split]["audio"], loaded[split]["audio"]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))


class _Tok:
    def encode(self, text):
        return [ord(c) % 17 for c in text] + [1]


def test_epoch_iterator_and_eval_batches_give_the_jax_batches():
    rows = p_synth.corpus_rows(n_train=13, n_eval=5, seed=2)["train"]
    ds = datasets.Dataset.from_dict(rows)
    out = []
    for common, bucketing, collator in ((j_common, j_bucketing, j_collator), (p_common, p_bucketing, p_collator)):
        ccfg = collator.CollatorConfig(bucketing=bucketing.BucketingConfig(batch_size=4, pad_to_multiple=1600))
        coll = collator.SpeechCollator(ccfg, tokenizer=_Tok())
        sampler = bucketing.BucketedBatchSampler(common.dataset_lengths(ds, "input_len"),
                                                 bucketing.BucketingConfig(batch_size=4, seed=5))
        train = list(common.epoch_iterator(ds, sampler, coll, max_steps=6))
        evals = list(common.eval_batches(ds, coll, 5))
        out.append((train, evals, common.split_references(ds, "text")))
    (j_train, j_evals, j_refs), (p_train, p_evals, p_refs) = out
    assert p_refs == j_refs
    assert len(p_train) == len(j_train) == 6 and len(p_evals) == len(j_evals) == 3
    for pb, jb in zip(p_train + p_evals, j_train + j_evals):
        assert sorted(pb) == sorted(jb)
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("joint", [False, True])
def test_config_overrides_route_as_jax(joint):
    overrides = {"encoder_num_hidden_layers": 3, "hidden_dropout": 0.2} if not joint else \
        {"encoder_num_hidden_layers": 3, "decoder_n_layer": 2, "ctc_weight": 0.5, "decoder_start_token_id": 2}
    if joint:
        enc, dec = dict(hidden_size=64, num_attention_heads=2), dict(n_embd=64, n_layer=1, n_head=2)
        j_cfg = JJoint(encoder=JConfig(**enc), decoder=JDec(**dec))
        p_cfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**enc), decoder=GPT2DecoderConfig(**dec))
    else:
        j_cfg, p_cfg = JConfig(hidden_size=64), EBranchformerConfig(hidden_size=64)
    j_out = dataclasses.asdict(j_factory.apply_config_overrides(j_cfg, overrides))
    p_out = dataclasses.asdict(p_factory.apply_config_overrides(p_cfg, overrides))
    p_keys = set(p_out) if not joint else set(p_out["encoder"]) | set(p_out["decoder"])

    def common(d):
        if joint:
            return {**{k: v for k, v in d.items() if k not in ("encoder", "decoder")},
                    **{f"e.{k}": v for k, v in d["encoder"].items() if k in p_keys},
                    **{f"d.{k}": v for k, v in d["decoder"].items() if k in p_keys}}
        return {k: v for k, v in d.items() if k in p_keys}

    assert common(p_out) == common(j_out)


def test_average_checkpoints_is_the_numpy_mean(tmp_path):
    rng = np.random.default_rng(8)
    states = []
    for step in (10, 20, 30, 40):
        sd = {"a.weight": rng.standard_normal((5, 3)).astype(np.float32) * 1e3,
              "a.bias": rng.standard_normal(3).astype(np.float32) + 1e4}
        states.append(sd)
        p_factory.save_trainer_checkpoint(str(tmp_path), step, {"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                                                                "step": step}, keep=0)
    for last_n, chosen in ((None, states), (2, states[-2:])):
        avg = p_factory.average_checkpoints(str(tmp_path), last_n)
        for k in states[0]:
            want = np.mean(np.stack([s[k].astype(np.float64) for s in chosen]), axis=0).astype(np.float32)
            assert avg[k].dtype == torch.float32
            np.testing.assert_array_equal(avg[k].numpy(), want)
    with pytest.raises(FileNotFoundError):
        p_factory.average_checkpoints(str(tmp_path / "none"))

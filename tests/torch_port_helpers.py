"""Shared setup for the tests that hold the PyTorch port against the JAX package.

One seeded numpy parameter tree feeds both packages: the Flax model reads it
as its params, the port loads it through ``state_dict_from_flax``.
"""

import numpy as np

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from huggingface_asr_tpu_torch.interop.from_jax import state_dict_from_flax
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import EBranchformerForCTC

# 2 layers, D=128, I=256, k=7; the fused subsampler's gate forces conv_dim (256, 256).
SMALL = dict(
    hidden_size=128, num_hidden_layers=2, num_attention_heads=4, intermediate_size=256,
    conv_dim=(256, 256), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1),
    csgu_kernel_size=7, merge_conv_kernel=7, vocab_size=50,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    csgu_conv_dropout=0.0, final_dropout=0.0,
)


def randomize(tree, rng):
    """Seeded params of useful scale: kernels ~ N(0, 1/fan_in), LayerNorm
    scales ~ 1 + N(0, 0.1^2), biases and position biases ~ N(0, 0.1^2)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
            continue
        shape = np.shape(v)
        z = rng.standard_normal(shape).astype(np.float32)
        if k == "kernel":
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif k == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        out[k] = z.astype(np.float32)
    return out


def make_models(seed=0, **overrides):
    """(jax config, port config, numpy param tree, Flax fp32 model, port model)."""
    kw = {**SMALL, **overrides}
    jcfg, pcfg = JConfig(**kw), EBranchformerConfig(**kw)
    jmodel = JModel(jcfg, dtype=jnp.float32)
    x = jnp.zeros((1, 64, jcfg.num_fbanks), jnp.float32)
    # only the tree's shapes are used: the values are drawn by ``randomize``
    params = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x, jnp.asarray([64], jnp.int32)))["params"]
    tree = randomize(params, np.random.default_rng(seed))
    pmodel = EBranchformerForCTC(pcfg)
    pmodel.load_state_dict(state_dict_from_flax(tree, pcfg), strict=True)
    return jcfg, pcfg, tree, jmodel, pmodel.eval()


# ---- the recipe families' command-line tests (test_torch_recipe_cli.py, test_torch_whisper_cli.py)

# batches of 8: the JAX CLIs shard them over the 8 CPU devices of tests/conftest.py; one
# preprocessing process (no forks of a process that runs JAX)
RECIPE_TRAIN = ["--load_from_disk", "--no-do_resample", "--preprocessing_num_workers", "1", "--dtype", "float32",
                "--per_device_train_batch_size", "8", "--per_device_eval_batch_size", "4", "--max_steps", "2",
                "--logging_steps", "1", "--eval_steps", "100", "--save_steps", "100", "--warmup_steps", "1",
                "--max_duration_in_seconds", "2", "--pad_to_multiple", "25", "--no-apply_spec_augment"]
RECIPE_WORDS = ["hello", "world", "speech", "model", "test", "data"]


def recipe_corpus(root, configs):
    """Eight seeded noise utterances of 0.5-1 s saved twice under ``root``:
    the train split alone (a JAX CLI run on it compiles no final decode) and
    with a 4-row test split; a 48-piece unigram tokenizer trained by the JAX
    CLI; each of ``configs`` (name -> dict) written as ``root/name.json``.
    Returns (root, train-only corpus, train + test corpus, tokenizer dir)."""
    import json

    import datasets

    from huggingface_asr_tpu.cli.train_tokenizer import main as train_tokenizer

    rng = np.random.default_rng(3)
    rows = {"audio": [], "text": [], "input_len": []}
    for _ in range(8):
        n = int(rng.integers(8000, 16000))
        rows["audio"].append(rng.standard_normal(n).astype(np.float32) * 0.1)
        rows["text"].append(" ".join(rng.choice(RECIPE_WORDS, size=rng.integers(2, 4))))
        rows["input_len"].append(n / 16000.0)
    ds = datasets.Dataset.from_dict(rows)
    train_only, with_test = str(root / "train"), str(root / "full")
    datasets.DatasetDict({"train": ds}).save_to_disk(train_only)
    datasets.DatasetDict({"train": ds, "test": ds.select(range(4))}).save_to_disk(with_test)
    tok = str(root / "tok")
    train_tokenizer(["--dataset_name", with_test, "--load_from_disk", "--no-do_resample",
                     "--preprocessing_num_workers", "1", "--tokenizer_type", "unigram", "--vocab_size", "48",
                     "--tokenizer_output_dir", tok])
    for name, cfg in configs.items():
        (root / f"{name}.json").write_text(json.dumps(cfg))
    return root, train_only, with_test, tok


def logged(out_dir):
    """The step records of a CLI run's ``metrics.jsonl``."""
    import json
    import os

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "loss" in r]

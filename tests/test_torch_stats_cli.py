"""The port's ``compute_dataset_statistics`` and ``publish_model`` CLIs
against the JAX package's, on the seeded corpus and weights of
``tests/test_torch_tool_clis.py`` (split from it, whose fixtures and helpers
these tests share, so that the two files run on two workers).
"""

import json
import os

import numpy as np
import pytest
import torch

from huggingface_asr_tpu.cli import compute_dataset_statistics as j_stats
from test_torch_tool_clis import DATA_ARGS, _jax_final, corpus  # noqa: F401  (fixture)

from huggingface_asr_tpu_torch.cli import compute_dataset_statistics as p_stats
from huggingface_asr_tpu_torch.cli.publish_model import main as p_publish_main
from huggingface_asr_tpu_torch.training.model_factory import load_ctc_model, load_state

# The two sides' log-mel: JAX's plain front end (the unfolded fp32 product)
# and the port's log-mel kernel's plain version on the CPU (the folded bases
# in fp32; the card's fp64 gate holds the kernel within twice the fp32
# product's error). Each is a few 1e-7 relative off the fp64 log-mel, on
# values of 10-25, so the float64 statistics (means 12-23, stds 0.4-3.2 on
# this corpus) differ by 1.4e-6 and 2.0e-6 at most here; the bound is ten
# times that.
STATS_ATOL = 2e-5


@pytest.mark.parametrize("batch_size", [4, 3])
def test_compute_dataset_statistics_match_jax(corpus, batch_size, tmp_path):
    """Batches of 4 and 3 (the last one padded with repeated rows, which both
    drop) over the ten train rows."""
    path, _ = corpus
    outs = {n: str(tmp_path / n) for n in ("jax", "port")}
    j_mean, j_std = j_stats.main(["--dataset_name", path, *DATA_ARGS, "--output_dir", outs["jax"],
                                  "--batch_size", str(batch_size)])
    p_mean, p_std = p_stats.main(["--dataset_name", path, *DATA_ARGS, "--output_dir", outs["port"],
                                  "--batch_size", str(batch_size), "--device", "cpu"])
    np.testing.assert_allclose(p_mean, j_mean, rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(p_std, j_std, rtol=0, atol=STATS_ATOL)
    assert p_mean.dtype == np.float64 and p_mean.shape == (80,) and np.all(p_std > 0)
    for name in ("global_means.npy", "global_stds.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(outs["port"], name)),
                                      p_mean if "means" in name else p_std)
    with open(os.path.join(outs["port"], "global_stats.json")) as f:
        assert json.load(f) == {"means": p_mean.tolist(), "stds": p_std.tolist()}


def test_statistics_of_the_rows_equal_the_whole_batch_statistics(corpus, tmp_path):
    """``run`` on the rows directly: one batch of all ten equals batches of 3."""
    from huggingface_asr_tpu_torch.data.datasets import ColumnTable

    _, rows = corpus
    table = ColumnTable({k: v[:10] for k, v in rows.items()})
    whole = p_stats.run(p_stats.StatsArguments(output_dir=str(tmp_path / "a"), batch_size=10, device="cpu"), table)
    parts = p_stats.run(p_stats.StatsArguments(output_dir=str(tmp_path / "b"), batch_size=3, device="cpu"), table)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9)


def test_publish_model_cli_builds_a_repo_that_loads_back(tmp_path):
    """The CLI's repo: its weights load strictly into the port's CTC model
    and give the logits of the ``final/`` it was built from."""
    _, p_final = _jax_final("ctc", tmp_path)
    out = str(tmp_path / "repo")
    p_publish_main(["--checkpoint", p_final, "--output_dir", out, "--model_type", "ctc", "--repo_id", "user/tiny"])
    model = load_ctc_model(p_final, device="cpu")
    twin = load_ctc_model(p_final, device="cpu")
    twin.load_state_dict(torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True), strict=True)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 64, 80)).astype(np.float32))
    lens = torch.tensor([64, 50], dtype=torch.int32)
    with torch.no_grad():
        assert torch.equal(model(feats, lens).logits, twin(feats, lens).logits)
    assert set(load_state(p_final)) == set(torch.load(os.path.join(out, "pytorch_model.bin"), weights_only=True))

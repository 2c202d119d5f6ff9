"""PyTorch port, fine-tuning from an SSL pretraining checkpoint vs the JAX package, on the CPU.

- The BEST-RQ fine-tuning adapters of ``models/ebranchformer.py::EBranchformerForCTC``
  (layer mixing, the additional layer, both) on a tiny config, a seeded
  parameter tree carried across by the extended ``param_table``: fp32 logits
  (every frame, the padded ones included) and loss within 1e-5 relative of
  their scale, the parameter gradients (``per_layer_weights`` included) within
  1e-5 of their norm; bf16 logits within 5e-2 of their scale (each side's
  bf16 logits are 1.0-3.0e-2 of scale from its own fp32 ones on these
  seeded weights), loss within 5e-3, gradients within 5e-2 of their norm.
- The additional layer takes the plain attention, as the Flax model does (it
  is called without ``lengths``): with ``attention_impl="pallas"`` a training
  forward reaches the training attention wrapper and an inference forward the
  shift-form one once per encoder layer, never for the additional layer.
- ``init_from_scratch_``: ``per_layer_weights`` exactly one-hot on the last
  entry, the additional layer drawn as the Flax init draws it (the statistics
  of ``tests/test_torch_init.py``).
- ``ASRPipeline(device="cpu")`` serves an adapter model (the plain route).

The graft of a pretraining checkpoint through both CLIs is held in
``tests/test_torch_finetune_cli.py``.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from huggingface_asr_tpu.models.configs import EBranchformerConfig as JConfig
from huggingface_asr_tpu.models.ebranchformer import EBranchformerForCTC as JModel
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.interop.from_jax import flax_tree_from_state_dict, state_dict_from_flax
from huggingface_asr_tpu_torch.models import ebranchformer as model_module
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, EBranchformerForCTC, init_from_scratch_

TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64, conv_dim=(8, 8),
    conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=30,
    best_rq_codebook_size=32, best_rq_codebook_dim=8, best_rq_num_books=1,
    num_codevectors_per_group=16, codevector_dim=16, proj_codevector_dim=16, num_negatives=4,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0, final_dropout=0.0,
)
ADAPTERS = {"mixing": dict(finetune_with_layer_mixing=True), "additional": dict(finetune_with_additional_layer=True),
            "both": dict(finetune_with_layer_mixing=True, finetune_with_additional_layer=True)}
B, T_MEL = 2, 100
LENS = np.asarray([100, 70], np.int32)


def _norm_rel(got, ref):
    got, ref = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert len(got) == len(ref)
    diff = np.sqrt(sum(float(np.sum((np.float64(g) - np.float64(r)) ** 2)) for g, r in zip(got, ref)))
    return diff / np.sqrt(sum(float(np.sum(np.float64(r) ** 2)) for r in ref))


def _adapter_models(kind, seed=0):
    kw = {**TINY, **ADAPTERS[kind]}
    jmodel = JModel(JConfig(**kw))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 64, 80)), jnp.asarray([64])))
    tree = randomize(shapes["params"], np.random.default_rng(seed))
    pmodel = EBranchformerForCTC(EBranchformerConfig(**kw))
    pmodel.load_state_dict(state_dict_from_flax(tree, pmodel.config), strict=True)
    return jmodel, tree, pmodel


# ---- the adapters against JAX


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(ADAPTERS))
def test_adapters_match_jax(kind, dtype):
    _, tree, pmodel = _adapter_models(kind)
    jdt, pdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = JModel(JConfig(**{**TINY, **ADAPTERS[kind]}), dtype=jdt)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((B, T_MEL, 80)).astype(np.float32)
    labels, label_lens = rng.integers(0, 30, (B, 5)).astype(np.int32), np.asarray([5, 3], np.int32)

    def j_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(feats).astype(jdt), jnp.asarray(LENS),
                           jnp.asarray(labels), jnp.asarray(label_lens), deterministic=True)
        return out.loss, out.logits

    (j_value, j_logits), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(tree)
    out = pmodel(torch.from_numpy(feats).to(pdt), torch.from_numpy(LENS), torch.from_numpy(labels).long(),
                 torch.from_numpy(label_lens))
    out.loss.backward()
    grads = flax_tree_from_state_dict({n: p.grad for n, p in pmodel.named_parameters()}, pmodel.config)
    tol = {"float32": (1e-5, 1e-5, 1e-5), "bfloat16": (5e-2, 5e-3, 5e-2)}[dtype]
    j_logits = np.asarray(j_logits.astype(jnp.float32))
    logit_err = np.abs(out.logits.detach().float().numpy() - j_logits).max() / np.abs(j_logits).max()
    loss_err = abs(float(out.loss.detach()) - float(j_value)) / abs(float(j_value))
    grad_err = _norm_rel(grads, jax.tree.map(np.asarray, j_grads))
    print(f"\n{kind} {dtype}: logits {logit_err:.2e}, loss {loss_err:.2e}, gradients {grad_err:.2e}")
    assert logit_err <= tol[0] and loss_err <= tol[1] and grad_err <= tol[2]
    if "finetune_with_layer_mixing" in ADAPTERS[kind]:
        assert float(np.abs(np.asarray(j_grads["per_layer_weights"])).max()) > 0
        assert pmodel.per_layer_weights.grad.abs().max() > 0


def test_the_additional_layer_launches_no_attention_kernel(monkeypatch):
    """attention_impl "pallas": one training attention call per encoder layer in a
    training forward, one shift-form call per encoder layer in an inference
    forward, none for the additional layer, which runs without lengths."""
    cfg = EBranchformerConfig(**{**TINY, **ADAPTERS["both"], "attention_impl": "pallas"})
    model = init_from_scratch_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(0))
    calls = {"train": 0, "shift": 0}
    for name, key in (("rel_attention_train", "train"), ("rel_attention", "shift")):
        real = getattr(model_module, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(model_module, name, counted)
    feats = torch.randn(B, T_MEL, 80, generator=torch.Generator().manual_seed(2))
    model(feats, torch.from_numpy(LENS), rng=DropoutRng(0))
    assert calls == {"train": cfg.num_hidden_layers, "shift": 0}
    with torch.no_grad():
        model(feats, torch.from_numpy(LENS))
    assert calls == {"train": cfg.num_hidden_layers, "shift": cfg.num_hidden_layers}
    h = torch.randn(B, 25, cfg.hidden_size)
    assert model.additional_layer(h).shape == h.shape  # no mask, no lengths


# ---- the initialiser


def test_init_from_scratch_draws_the_adapters_as_flax_does():
    cfg = {**TINY, **ADAPTERS["both"], "hidden_size": 64, "intermediate_size": 256}
    jmodel = JModel(JConfig(**cfg))
    x, lens = jnp.zeros((1, 64, 80)), jnp.asarray([64])
    init = jax.jit(lambda k: jmodel.init(k, x, lens)["params"])
    pooled = {"dense": ([], []), "lecun": ([], [])}
    for seed in (0, 1, 2):
        j_tree = jax.tree.map(np.asarray, init(jax.random.key(seed)))
        np.testing.assert_array_equal(j_tree["per_layer_weights"], [0.0, 0.0, 1.0])
        model = init_from_scratch_(EBranchformerForCTC(EBranchformerConfig(**cfg)), torch.Generator().manual_seed(seed))
        assert torch.equal(model.per_layer_weights, torch.tensor([0.0, 0.0, 1.0]))
        j_sd = state_dict_from_flax(j_tree, model.config)
        for mname, m in model.additional_layer.named_modules():
            for pname, p in m.named_parameters(recurse=False):
                key = f"additional_layer.{mname}.{pname}".replace("..", ".")
                ref = j_sd[key].numpy()
                got = p.detach().numpy()
                if isinstance(m, nn.LayerNorm) or pname != "weight":
                    want = 1.0 if isinstance(m, nn.LayerNorm) and pname == "weight" else 0.0
                    assert np.all(got == want) and np.all(ref == want), key
                    continue
                kind, std = (("dense", model.config.initializer_range) if isinstance(m, nn.Linear)
                             else ("lecun", float(np.sqrt(1.0 / p[0].numel()))))
                pooled[kind][0].append(got.ravel() / std)
                pooled[kind][1].append(ref.ravel() / std)
    for kind, (p_parts, j_parts) in pooled.items():
        p, j = np.concatenate(p_parts).astype(np.float64), np.concatenate(j_parts).astype(np.float64)
        n = p.size
        assert n == j.size and n > 10_000, (kind, n)
        assert abs(p.mean() - j.mean()) <= 6 * np.sqrt(2.0 / n)
        assert abs(p.std() - j.std()) <= 6 * np.sqrt(1.0 / n) and abs(p.std() - 1.0) <= 6 * np.sqrt(0.5 / n)
        kurt = [float(np.mean((x - x.mean()) ** 4) / x.var() ** 2 - 3.0) for x in (p, j)]
        assert abs(kurt[0] - kurt[1]) <= 6 * np.sqrt(48.0 / n), (kind, kurt)


def test_pipeline_serves_an_adapter_model_on_the_plain_route(tmp_path):
    from huggingface_asr_tpu_torch.serving.pipeline import ASRPipeline
    from huggingface_asr_tpu_torch.training.model_factory import save_params

    cfg = EBranchformerConfig(**{**TINY, **ADAPTERS["both"], "attention_impl": "pallas"})
    model = init_from_scratch_(EBranchformerForCTC(cfg), torch.Generator().manual_seed(5))
    save_params(model, str(tmp_path))

    class Tok:
        def decode(self, ids, skip_special_tokens=True):
            return " ".join(map(str, ids))

    audio = [np.random.default_rng(i).standard_normal(8000 + 1600 * i).astype(np.float32) * 0.1 for i in range(3)]
    pipe = ASRPipeline(str(tmp_path), model_type="ctc", dtype="float32", device="cpu", tokenizer=Tok())
    assert not pipe._use_fused
    texts = pipe(audio)
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)

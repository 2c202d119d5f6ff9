"""PyTorch port, the joint CTC/attention model's training half against the JAX package on the CPU.

The same numpy-seeded parameters (carried across by ``interop/from_jax.py``)
and inputs go through each JAX function and its counterpart, at fp32 with
``jax_default_matmul_precision="highest"`` and every dropout rate 0:
``smoothed_cross_entropy``; the decoder's loss, logits and gradients with
labels for each head option; the joint forward with labels (three
``JointTrainer`` steps from one initial state in
``tests/test_torch_aed_trainer_steps.py``); the from-scratch
initialiser's moments against the Flax init's; the decoder's two weight
layouts (fp32 master weights cast at use, serving weights cast once) giving
the same bf16 logits; and dropout drawn from the step's stream.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import huggingface_asr_tpu.ops.pallas_train_attention as j_train_attention
from huggingface_asr_tpu.models.configs import EBranchformerConfig as JEnc
from huggingface_asr_tpu.models.gpt2_decoder import GPT2DecoderConfig as JDec
from huggingface_asr_tpu.models.gpt2_decoder import GPT2MultiHeadDecoder as JDecoder
from huggingface_asr_tpu.models.gpt2_decoder import smoothed_cross_entropy as j_smoothed_ce
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionConfig as JJoint
from huggingface_asr_tpu.models.joint_ctc_aed import JointCTCAttentionEncoderDecoder as JModel
from torch_port_helpers import randomize

from huggingface_asr_tpu_torch.interop.from_jax import (
    decoder_flax_tree_from_state_dict,
    decoder_state_dict_from_flax,
    decoder_tree_shape,
    joint_state_dict_from_flax,
)
from huggingface_asr_tpu_torch.kernels import _build
from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng
from huggingface_asr_tpu_torch.models.gpt2_decoder import (
    GPT2DecoderConfig,
    GPT2MultiHeadDecoder,
    init_decoder_from_scratch_,
    smoothed_cross_entropy,
)
from huggingface_asr_tpu_torch.models.joint_ctc_aed import (
    JointCTCAttentionConfig,
    JointCTCAttentionEncoderDecoder,
    init_joint_from_scratch_,
    shift_right,
)
from huggingface_asr_tpu_torch.training.loop import JointTrainer
from huggingface_asr_tpu_torch.training.model_factory import instantiate_aed_model, merge_pretrained_halves

ENC = dict(
    hidden_size=48, num_hidden_layers=1, num_attention_heads=2, intermediate_size=96,
    conv_dim=(8, 8), conv_kernel=(3, 3), conv_stride=(2, 2), conv_padding=(1, 1), vocab_size=40,
    hidden_dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, csgu_conv_dropout=0.0, final_dropout=0.0,
)
DEC = dict(
    vocab_size=40, n_positions=64, n_embd=32, n_layer=2, n_head=2,
    head_locations=(1,), head_weights=(0.3, 0.7), lsm_factor=0.1,
    resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, bos_token_id=0, eos_token_id=1, pad_token_id=3,
)
# the decoder's head options
HEADS = {
    "none": dict(head_locations=(), head_weights=(1.0,)),
    "intermediate": {},
    "average_logits": dict(average_logits=True),
    "mixing_full": dict(mixing_mode="full"),
    "mixing_linear": dict(mixing_mode="linear"),
    "mixing_scalar": dict(mixing_mode="scalar"),
    "connected_residuals": dict(connected_residuals=(1, 2)),
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _shape_tree(module, *args, **kwargs):
    return jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kwargs))["params"]


def _decoder_tree(cfg: JDec, seed: int):
    tokens = jnp.zeros((1, 3), jnp.int32)
    kw = dict(labels=tokens, label_mask=jnp.ones((1, 3), bool),
              encoder_hidden=jnp.zeros((1, 4, cfg.n_embd)), encoder_lengths=jnp.asarray([4]))
    return randomize(_shape_tree(JDecoder(cfg), tokens, **kw), np.random.default_rng(seed))


# ------------------------------------------------------------ smoothed CE

@pytest.mark.parametrize("lsm", [0.0, 0.1])
@pytest.mark.parametrize("lengths", [(7, 7, 7), (7, 3, 0)])
def test_smoothed_cross_entropy_matches_jax(lsm, lengths):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 11))).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = np.arange(7)[None, :] < np.asarray(lengths)[:, None]
    ref = float(j_smoothed_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask, jnp.float32), lsm))
    got = float(smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(mask),
                                       lsm))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    empty = smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), torch.zeros(3, 7), lsm)
    assert float(empty) == 0.0  # the denominator max(sum(mask), 1)


# ------------------------------------------------------------ the decoder with labels

def _decoder_case(seed=2):
    rng = np.random.default_rng(seed)
    B, T, S = 3, 7, 11
    tokens = rng.integers(0, 40, (B, T))
    labels = rng.integers(0, 40, (B, T))
    mask = np.arange(T)[None, :] < np.asarray([7, 5, 2])[:, None]
    enc = rng.standard_normal((B, S, 32)).astype(np.float32)
    enc_lens = np.asarray([11, 6, 9])
    return tokens, labels, mask, enc, enc_lens


@pytest.fixture(scope="module", params=list(HEADS))
def decoder_run(request):
    """(variant, JAX loss, logits, gradients; port loss, logits, gradients)."""
    over = HEADS[request.param]
    jcfg, pcfg = JDec(**{**DEC, **over}), GPT2DecoderConfig(**{**DEC, **over})
    tree = _decoder_tree(jcfg, seed=1)
    tokens, labels, mask, enc, enc_lens = _decoder_case()

    def f(p):
        out = JDecoder(jcfg).apply({"params": p}, jnp.asarray(tokens), encoder_hidden=jnp.asarray(enc),
                                   encoder_lengths=jnp.asarray(enc_lens), labels=jnp.asarray(labels),
                                   label_mask=jnp.asarray(mask))
        return out.loss, out.logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(f, has_aux=True)(tree)
    dec = GPT2MultiHeadDecoder(pcfg)
    dec.load_state_dict(decoder_state_dict_from_flax(tree, pcfg), strict=True)
    out = dec(torch.from_numpy(tokens), torch.from_numpy(enc), torch.from_numpy(enc_lens),
              labels=torch.from_numpy(labels), label_mask=torch.from_numpy(mask))
    out.loss.backward()
    grads = decoder_flax_tree_from_state_dict({n: p.grad for n, p in dec.named_parameters()}, pcfg)
    return (request.param, float(j_loss), np.asarray(j_logits), dict(_flat(jax.tree.map(np.asarray, j_grads))),
            float(out.loss.detach()), out.logits.detach().numpy(), dict(_flat(grads)))


def test_decoder_loss_and_logits_with_labels_match_jax(decoder_run):
    """Loss within 1e-5 relative, logits within 1e-4 of their scale."""
    variant, j_loss, j_logits, _, p_loss, p_logits, _ = decoder_run
    assert np.isfinite(p_loss)
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5, err_msg=variant)
    assert p_logits.shape == j_logits.shape
    assert np.abs(p_logits - j_logits).max() <= 1e-4 * max(1.0, np.abs(j_logits).max()), variant


def test_decoder_gradients_match_jax(decoder_run):
    """Every parameter's gradient within 1e-4 of the largest gradient entry."""
    variant, _, _, j_grads, _, _, p_grads = decoder_run
    assert set(j_grads) == set(p_grads), variant
    scale = max(np.abs(g).max() for g in j_grads.values())
    for name in sorted(j_grads):
        err = np.abs(p_grads[name] - j_grads[name]).max()
        assert err <= 1e-4 * scale, (variant, name, err, scale)


@pytest.mark.parametrize("variant", ["mixing_full", "mixing_linear", "mixing_scalar", "connected_residuals"])
def test_head_options_decode_through_the_cache(variant):
    """The mixing and residual heads no longer raise, and one token at a
    time through the cache gives the whole sequence's logits."""
    over = HEADS[variant]
    pcfg = GPT2DecoderConfig(**{**DEC, **over})
    dec = GPT2MultiHeadDecoder(pcfg)
    dec.load_state_dict(decoder_state_dict_from_flax(_decoder_tree(JDec(**{**DEC, **over}), seed=3), pcfg),
                        strict=True)
    tokens, _, _, enc, enc_lens = _decoder_case(seed=4)
    tokens, enc, enc_lens = torch.from_numpy(tokens), torch.from_numpy(enc), torch.from_numpy(enc_lens)
    with torch.no_grad():
        full = dec(tokens, enc, enc_lens).logits
        cache = dec.write_cross_kv(dec.init_cache(3, 16), enc)
        steps = [dec(tokens[:, t:t + 1], encoder_lengths=enc_lens, position_offset=torch.full((3,), t),
                     cache=cache).logits[:, 0] for t in range(tokens.shape[1])]
    torch.testing.assert_close(torch.stack(steps, dim=1), full, atol=1e-5, rtol=1e-5)


def test_unknown_mixing_mode_raises():
    with pytest.raises(NotImplementedError, match="mixing_mode"):
        GPT2MultiHeadDecoder(GPT2DecoderConfig(**{**DEC, "mixing_mode": "attention"}))


@pytest.mark.parametrize("variant", list(HEADS))
def test_decoder_tree_shape_is_the_flax_tree(variant):
    """The conversion table covers exactly the Flax tree of each head option,
    both ways."""
    over = HEADS[variant]
    pcfg = GPT2DecoderConfig(**{**DEC, **over})
    tree = _decoder_tree(JDec(**{**DEC, **over}), seed=5)
    optional = lambda keys: {k for k in keys if not k.startswith(("h_", "wte", "ln_f"))}  # noqa: E731
    assert optional(decoder_tree_shape(pcfg)) == optional(tree)
    back = decoder_flax_tree_from_state_dict(decoder_state_dict_from_flax(tree, pcfg), pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))


# ------------------------------------------------------------ the joint forward with labels

def _joint_configs(impl="xla", **dec_over):
    enc = {**ENC, "attention_impl": impl}
    jcfg = JJoint(encoder=JEnc(**enc), decoder=JDec(**{**DEC, **dec_over}), ctc_weight=0.3)
    pcfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**enc), decoder=GPT2DecoderConfig(**{**DEC, **dec_over}),
                                   ctc_weight=0.3)
    return jcfg, pcfg


def _joint_inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 80, 80)).astype(np.float32)
    lens = np.asarray([80, 61, 47], np.int32)
    # label rows with the special ids in them, as a tokenizer's rows may hold
    labels = rng.integers(0, 40, (3, 8)).astype(np.int32)
    labels[:, 0] = 0
    label_lengths = np.asarray([8, 5, 3], np.int32)
    return feats, lens, labels, label_lengths


@pytest.fixture(scope="module")
def joint_tree():
    jcfg, _ = _joint_configs()
    feats, lens, labels, llens = _joint_inputs()
    shapes = _shape_tree(JModel(jcfg), jnp.asarray(feats), jnp.asarray(lens), labels=jnp.asarray(labels),
                         label_lengths=jnp.asarray(llens))
    return randomize(shapes, np.random.default_rng(7))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_joint_forward_with_labels_matches_jax(joint_tree, impl):
    """loss, enc_loss and dec_loss of the training forward within 1e-5
    relative (2e-5 for the CTC half through the attention kernels' plain
    versions), the decoder logits within 1e-4 of scale. The JAX "pallas"
    forward runs its kernel in interpret mode; the port's, on the CPU, the
    kernel's plain version (no launch)."""
    jcfg, pcfg = _joint_configs(impl)
    feats, lens, labels, llens = _joint_inputs()
    orig = j_train_attention.rel_attention_train
    j_train_attention.rel_attention_train = lambda *a: orig(*a, True)
    try:
        ref = JModel(jcfg).apply({"params": joint_tree}, jnp.asarray(feats), jnp.asarray(lens),
                                 labels=jnp.asarray(labels), label_lengths=jnp.asarray(llens), deterministic=False,
                                 rngs={"dropout": jax.random.key(0)})
    finally:
        j_train_attention.rel_attention_train = orig
    model = JointCTCAttentionEncoderDecoder(pcfg, param_dtype=torch.float32)
    model.load_state_dict(joint_state_dict_from_flax(joint_tree, pcfg.encoder, pcfg.decoder), strict=True)
    _build.reset_launch_counts()
    out = model(torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(labels), torch.from_numpy(llens),
                rng=DropoutRng(0))
    assert sum(_build.LAUNCHES.values()) == 0
    rtol = {"loss": 1e-5, "enc_loss": 2e-5, "dec_loss": 1e-5}
    for name, tol in rtol.items():
        np.testing.assert_allclose(float(getattr(out, name).detach()), float(getattr(ref, name)), rtol=tol,
                                   err_msg=name)
    r = np.asarray(ref.logits)
    assert np.abs(out.logits.detach().numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())
    np.testing.assert_array_equal(out.encoder_lengths.numpy(), np.asarray(ref.encoder_lengths))


def test_joint_forward_without_labels_is_the_start_token_pass(joint_tree):
    jcfg, pcfg = _joint_configs()
    feats, lens, _, _ = _joint_inputs()
    ref = JModel(jcfg).apply({"params": joint_tree}, jnp.asarray(feats), jnp.asarray(lens))
    model = JointCTCAttentionEncoderDecoder(pcfg).eval()
    model.load_state_dict(joint_state_dict_from_flax(joint_tree, pcfg.encoder, pcfg.decoder), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(feats), torch.from_numpy(lens))
    assert out.loss is None and out.enc_loss is None and out.dec_loss is None
    r = np.asarray(ref.logits)
    assert out.logits.shape == (3, 1, 40)
    assert np.abs(out.logits.numpy() - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


def test_shift_right():
    got = shift_right(torch.tensor([[5, 6, 7], [8, 9, 1]]), 0)
    assert got.tolist() == [[0, 5, 6], [0, 8, 9]]


# ------------------------------------------------------------ the trainer


def test_joint_trainer_refuses_a_model_of_another_dtype():
    _, pcfg = _joint_configs()
    with pytest.raises(ValueError, match="computes in"):
        JointTrainer(JointCTCAttentionEncoderDecoder(pcfg), device="cpu", dtype="bfloat16")


def test_training_dropout_repeats_with_its_seed_and_is_inverted_dropout():
    """With dropout on, the same stream repeats the step's loss; another
    stream, or none, changes it. The decoder's dropout is inverted dropout at
    its rate: at rate 0.5 on the embeddings alone (the other rates 0), the
    first layer's input is 0 or twice the embedding."""
    rates = dict(resid_pdrop=0.2, embd_pdrop=0.2, attn_pdrop=0.2)
    pcfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**{**ENC, "hidden_dropout": 0.1}),
                                   decoder=GPT2DecoderConfig(**{**DEC, **rates}))
    model = init_joint_from_scratch_(JointCTCAttentionEncoderDecoder(pcfg, param_dtype=torch.float32),
                                     torch.Generator().manual_seed(0))
    feats, lens, labels, llens = (torch.from_numpy(a) for a in _joint_inputs())
    loss = [float(model(feats, lens, labels, llens, rng=r).loss.detach()) for r in (DropoutRng(5), DropoutRng(5),
                                                                          DropoutRng(6), None)]
    assert loss[0] == loss[1] and loss[0] != loss[2] and loss[0] != loss[3]
    dec = GPT2MultiHeadDecoder(GPT2DecoderConfig(**{**DEC, "embd_pdrop": 0.5}))
    init_decoder_from_scratch_(dec, torch.Generator().manual_seed(1))
    tokens = torch.randint(0, 40, (4, 9), generator=torch.Generator().manual_seed(2))
    clean = dec(tokens).hidden_states[0]
    dropped = dec(tokens, rng=DropoutRng(3)).hidden_states[0]
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], 2.0 * clean[kept])
    assert 0.4 < float(kept.float().mean()) < 0.6


# ------------------------------------------------------------ the two weight layouts

def test_fp32_master_and_serving_layouts_give_equal_bf16_logits():
    """A trained joint model's state loads into the serving layout (bf16
    weights, cast once) and into the trainer's (fp32 weights, cast at use):
    the bf16 decoder logits are equal, and every decoder product weight is
    fp32 in the second."""
    _, pcfg = _joint_configs(**HEADS["average_logits"])
    trained = init_joint_from_scratch_(JointCTCAttentionEncoderDecoder(pcfg, param_dtype=torch.float32),
                                       torch.Generator().manual_seed(3))
    sd = trained.state_dict()
    serving = JointCTCAttentionEncoderDecoder(pcfg, torch.bfloat16)
    master = JointCTCAttentionEncoderDecoder(pcfg, torch.bfloat16, param_dtype=torch.float32)
    serving.load_state_dict(sd, strict=True)
    master.load_state_dict(sd, strict=True)
    assert serving.decoder.transformer.h[0].attn.c_attn.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in master.parameters())
    feats, lens, labels, llens = (torch.from_numpy(a) for a in _joint_inputs())
    with torch.no_grad():
        a = serving(feats, lens, labels, llens)
        b = master(feats, lens, labels, llens)
        tok = shift_right(labels, 0).long()
        _, hid = serving.encode(feats, lens)
        c = serving.decoder(tok, hid, a.encoder_lengths).logits
        d = master.decoder(tok, hid, a.encoder_lengths).logits
    assert torch.equal(a.logits, b.logits) and torch.equal(c, d) and c.dtype == torch.bfloat16
    assert float(a.loss) == float(b.loss)


# ------------------------------------------------------------ the initialiser

def _flax_init(seed, pcfg, jcfg):
    """The Flax init's draws of the decoder (initialised with labels, so that
    every head exists) and of ``enc_to_dec_proj`` (a Flax Dense), as the
    port's state dict keys them."""
    import flax.linen as fnn

    k_dec, k_proj = jax.random.split(jax.random.key(seed))
    tokens = jnp.zeros((1, 3), jnp.int32)
    dec = JDecoder(jcfg.decoder).init(k_dec, tokens, labels=tokens, label_mask=jnp.ones((1, 3), bool),
                                      encoder_hidden=jnp.zeros((1, 4, jcfg.decoder.n_embd)),
                                      encoder_lengths=jnp.asarray([4]))["params"]
    proj = fnn.Dense(jcfg.decoder.n_embd).init(k_proj, jnp.zeros((1, jcfg.encoder.hidden_size)))["params"]
    sd = {f"decoder.{k}": v.numpy() for k, v in decoder_state_dict_from_flax(jax.tree.map(np.asarray, dec),
                                                                              pcfg.decoder).items()}
    sd["enc_to_dec_proj.weight"] = np.asarray(proj["kernel"]).T
    sd["enc_to_dec_proj.bias"] = np.asarray(proj["bias"])
    return sd


INIT_DEC = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=2, head_locations=(1,),
                head_weights=(0.3, 0.7))


@pytest.mark.parametrize("variant", ["intermediate", "mixing_full", "connected_residuals"])
def test_initialiser_moments_match_the_flax_init(variant):
    """Per group of the decoder (and ``enc_to_dec_proj``), three seeds pooled,
    each tensor divided by the std its initialiser names: means within
    6 sqrt(2 / n), stds within 6 sqrt(1 / n), excess kurtoses within
    6 sqrt(48 / n), as tests/test_torch_init.py holds the encoder's; the
    entries the Flax init sets to a constant are equal to it."""
    over = {"intermediate": {}, "mixing_full": dict(mixing_mode="full"),
            "connected_residuals": dict(connected_residuals=(1, 2))}[variant]
    enc = {**ENC, "hidden_size": 32, "vocab_size": 256}
    jcfg = JJoint(encoder=JEnc(**enc), decoder=JDec(**{**INIT_DEC, **over}))
    pcfg = JointCTCAttentionConfig(encoder=EBranchformerConfig(**enc),
                                   decoder=GPT2DecoderConfig(**{**INIT_DEC, **over}))
    resid = 0.02 / np.sqrt(2 * INIT_DEC["n_layer"])

    def group(key, shape):  # the encoder's groups: tests/test_torch_init.py
        if ".ln_" in key:
            return ("const", None)
        if key.endswith(".bias"):
            return ("const", None)
        if key == "decoder.lm_mixing.weight":
            return ("const", None)
        if key == "decoder.transformer.wpe.weight":
            return ("normal", 0.01)
        if key == "enc_to_dec_proj.weight" or (key == "decoder.lm_head.weight" and over.get("connected_residuals")):
            return ("lecun", float(np.sqrt(1.0 / shape[1])))
        if key.endswith("c_proj.weight"):
            return ("normal", resid)
        return ("normal", 0.02)

    jax_sds, port_sds = [], []
    for seed in (0, 1, 2):
        jax_sds.append(_flax_init(seed, pcfg, jcfg))
        model = init_joint_from_scratch_(JointCTCAttentionEncoderDecoder(pcfg, param_dtype=torch.float32),
                                         torch.Generator().manual_seed(seed))
        port_sds.append({k: v.numpy().copy() for k, v in model.state_dict().items()
                         if k.startswith(("decoder.", "enc_to_dec_proj"))})
    assert set(jax_sds[0]) == set(port_sds[0])
    pools = {}
    for key, v in jax_sds[0].items():
        g = group(key, v.shape)
        if g[0] == "const":
            for j, p in zip(jax_sds, port_sds):
                np.testing.assert_array_equal(p[key], j[key], err_msg=key)
            continue
        pools.setdefault(g, []).append(key)
    assert ("normal", resid) in pools and ("normal", 0.02) in pools
    for (kind, std), keys in pools.items():
        sides = [np.concatenate([sd[k].ravel() / std for sd in sds for k in keys]) for sds in (jax_sds, port_sds)]
        n = min(s.size for s in sides)
        (jm, pm), (js, ps) = [s.mean() for s in sides], [s.std() for s in sides]
        kurt = [((s - s.mean()) ** 4).mean() / s.var() ** 2 - 3.0 for s in sides]
        assert abs(jm - pm) <= 6 * np.sqrt(2 / n), (kind, std, jm, pm)
        assert abs(js - ps) <= 6 * np.sqrt(1 / n) and abs(ps - 1.0) <= 6 * np.sqrt(1 / (2 * n)), (kind, std, js, ps)
        assert abs(kurt[0] - kurt[1]) <= 6 * np.sqrt(48 / n), (kind, std, kurt)


# ------------------------------------------------------------ the model factory

def test_merge_pretrained_halves_grafts_each_half():
    _, pcfg = _joint_configs()
    model, state = instantiate_aed_model(pcfg)
    assert state is None and all(p.dtype == torch.float32 for p in model.parameters())
    init = init_joint_from_scratch_(model, torch.Generator().manual_seed(0)).state_dict()
    other = init_joint_from_scratch_(instantiate_aed_model(pcfg)[0], torch.Generator().manual_seed(1)).state_dict()
    enc_half = {k[len("encoder."):]: v for k, v in other.items() if k.startswith("encoder.")}
    dec_half = {k[len("decoder."):]: v for k, v in other.items() if k.startswith("decoder.")}
    _, halves = instantiate_aed_model(pcfg, encoder_state=enc_half)
    assert set(halves) == {k for k in init if k.startswith("encoder.")}
    merged = merge_pretrained_halves(init, enc_half, dec_half)
    assert set(merged) == set(init)
    for k, v in merged.items():
        want = other[k] if k.startswith(("encoder.", "decoder.")) else init[k]
        assert torch.equal(v, want), k
    model.load_state_dict(merged, strict=True)

"""wav2vec2-style contrastive pretraining over the E-Branchformer body
(counterpart of ``huggingface_asr_tpu/models/wav2vec2_ssl.py``; reference
src/models/encoders/e_branchformer.py:337-358, HF's Wav2Vec2ForPreTraining
objective on the custom encoder, the quantizer reading ``hidden_size``).

- ``GumbelVectorQuantizer``: G groups x V codes. In training a Gumbel-softmax
  at the step's temperature picks the codes with a straight-through estimator,
  the perplexity from the soft marginals; in evaluation the hard argmax picks
  them and the perplexity comes from that one-hot.
- ``Wav2Vec2ForPreTraining``: the encoder with the learned ``masked_spec_embed``
  in its masked frames, ``project_hid`` over its output, the quantizer over
  the feature projection's LayerNorm output (``extract_features``, with no
  gradient where ``feat_quantizer_dropout`` is 0) and ``project_q`` over the
  codes; cosine-similarity logits of each frame against its target and the
  sampled negatives (a negative equal to the target, by ``isclose``, is masked
  to -inf), divided by the logits temperature; the loss is the contrastive
  cross entropy summed over the masked valid frames plus
  ``diversity_loss_weight * (GV - perplexity) / GV * num_masked``.

Training mode is a forward with ``rng`` given (a ``DropoutRng``), as in
``models/ebranchformer.py``. The Gumbel draws are ``-log(-log(U))`` from an
explicit ``torch.Generator``, or ``gumbel_noise`` handed in (the tests hand
JAX's ``jax.random.gumbel`` draw). The model computes in the dtype of the
features it is given (or ``dtype``); the quantizer's logits, softmaxes and
codevector sums are fp32, with the JAX package's rounding points.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from huggingface_asr_tpu_torch.models.configs import EBranchformerConfig
from huggingface_asr_tpu_torch.models.ebranchformer import DropoutRng, EBranchformerModel, _lin
from huggingface_asr_tpu_torch.parallel.mesh import global_sum, row_draw
from huggingface_asr_tpu_torch.ops.lengths import lengths_to_mask


@dataclasses.dataclass
class Wav2Vec2SSLOutput:
    loss: torch.Tensor
    contrastive_loss: torch.Tensor
    diversity_loss: torch.Tensor
    codevector_perplexity: torch.Tensor
    num_masked: torch.Tensor
    projected_states: torch.Tensor
    projected_quantized_states: torch.Tensor


def draw_gumbel(shape, generator: Optional[torch.Generator], device=None) -> torch.Tensor:
    """``-log(-log(U))`` in fp32, U uniform on [tiny, 1) (``jax.random.gumbel``'s transform)."""
    u = row_draw(torch.rand, shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


class GumbelVectorQuantizer(nn.Module):
    """G x V codebook (``codevectors``, (1, G V, d / G), fp32) and the Dense
    ``weight_proj`` that scores the codes."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.G, self.V, self.d = cfg.num_codevector_groups, cfg.num_codevectors_per_group, cfg.codevector_dim
        self.codevectors = nn.Parameter(torch.rand(1, self.G * self.V, self.d // self.G))
        self.weight_proj = nn.Linear(cfg.hidden_size, self.G * self.V)

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor, temperature, train: bool = False,
                gumbel_noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """hidden (B, T, H) in the compute dtype, mask (B, T) the valid masked
        frames. Returns the codes (B, T, d) in hidden's dtype and the
        perplexity (fp32). In training the Gumbel draw is ``gumbel_noise``
        (B T G, V) or else one from ``generator``."""
        G, V, d = self.G, self.V, self.d
        B, T, _ = hidden.shape
        logits = _lin(self.weight_proj, hidden).reshape(B * T * G, V).float()
        if train:
            g = draw_gumbel(logits.shape, generator, logits.device) if gumbel_noise is None else gumbel_noise
            noisy = logits + g.to(logits.device, torch.float32)
            probs_hard = F.one_hot(noisy.argmax(dim=-1), V).float()
            probs_soft = torch.softmax(noisy / temperature, dim=-1)
            codevector_probs = probs_soft + (probs_hard - probs_soft).detach()  # straight-through
            marginal = torch.softmax(logits.reshape(B * T, G, V), dim=-1)
        else:
            codevector_probs = F.one_hot(logits.argmax(dim=-1), V).float()
            marginal = codevector_probs.reshape(B * T, G, V)

        # perplexity over the valid masked frames
        m = mask.reshape(B * T, 1, 1).float()
        # the marginal of the global batch's masked frames in a data-parallel step
        probs_mean = global_sum(torch.sum(marginal * m, dim=0), differentiable=True) / torch.clamp(
            global_sum(torch.sum(m)), min=1.0)
        perplexity = torch.sum(torch.exp(-torch.sum(probs_mean * torch.log(probs_mean + 1e-7), dim=-1)))

        # the probability-weighted sum of each group's codes (a contraction over V)
        cv = torch.einsum("ngv,gvc->ngc", codevector_probs.reshape(B * T, G, V),
                          self.codevectors.float().reshape(G, V, d // G))
        return cv.reshape(B, T, d).to(hidden.dtype), perplexity


def _cosine_sim(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=eps)
    return torch.sum(a * b, dim=-1)


class Wav2Vec2ForPreTraining(nn.Module):
    """E-Branchformer encoder (``wav2vec2``, with ``masked_spec_embed``) +
    ``project_hid``, ``quantizer`` and ``project_q``."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        self.config = cfg
        self.wav2vec2 = EBranchformerModel(cfg, masked_spec_embed=True)
        self.project_hid = nn.Linear(cfg.hidden_size, cfg.proj_codevector_dim)
        self.quantizer = GumbelVectorQuantizer(cfg)
        self.project_q = nn.Linear(cfg.codevector_dim, cfg.proj_codevector_dim)

    def forward(
        self,
        input_features: torch.Tensor,
        input_lengths: torch.Tensor,
        mask_time_indices: torch.Tensor,
        sampled_negative_indices: torch.Tensor,
        gumbel_temperature: Union[float, torch.Tensor] = 2.0,
        rng: Optional[DropoutRng] = None,
        gumbel_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> Wav2Vec2SSLOutput:
        """input_features (B, T_mel, F); mask_time_indices (B, T_enc) bool
        over encoder frames; sampled_negative_indices (B, T_enc, N), flat
        time indices into each utterance. ``rng`` given: the training forward
        (dropout on, Gumbel-softmax codes from ``gumbel_noise`` or
        ``generator``); else the hard codes."""
        cfg = self.config
        dtype = dtype or input_features.dtype
        mask = mask_time_indices.to(torch.bool)
        last, lengths, _, extract_features = self.wav2vec2(input_features.to(dtype), input_lengths, rng,
                                                           mask_time_indices=mask)
        B, T, _ = last.shape
        valid = lengths_to_mask(lengths, T)
        transformer_out = _lin(self.project_hid, last)

        quantized, perplexity = self.quantizer(
            extract_features.detach() if cfg.feat_quantizer_dropout == 0.0 else extract_features,
            valid & mask, gumbel_temperature, train=rng is not None, gumbel_noise=gumbel_noise,
            generator=generator)
        quantized = _lin(self.project_q, quantized)

        # negatives: the targets at the sampled time positions, (B, T, N, D)
        neg = quantized[torch.arange(B, device=quantized.device)[:, None, None],
                        sampled_negative_indices.to(device=quantized.device, dtype=torch.long)]
        pos_logits = _cosine_sim(transformer_out, quantized)  # (B, T)
        neg_logits = _cosine_sim(transformer_out[:, :, None, :], neg)  # (B, T, N)
        # HF: a negative equal to the positive target is masked with -inf
        same = torch.all(torch.isclose(neg, quantized[:, :, None, :]), dim=-1)
        neg_logits = torch.where(same, torch.full((), float("-inf"), dtype=neg_logits.dtype,
                                                  device=neg_logits.device), neg_logits)

        logits = torch.cat([pos_logits[..., None], neg_logits], dim=-1) / cfg.contrastive_logits_temperature
        logp = torch.log_softmax(logits, dim=-1)
        target_mask = (mask & valid).float()
        contrastive = -torch.sum(logp[..., 0].float() * target_mask)
        num_masked = torch.sum(target_mask)

        G, V = cfg.num_codevector_groups, cfg.num_codevectors_per_group
        diversity = (G * V - perplexity) / (G * V)
        loss = contrastive + cfg.diversity_loss_weight * diversity * num_masked
        return Wav2Vec2SSLOutput(
            loss=loss,
            contrastive_loss=contrastive,
            diversity_loss=diversity,
            codevector_perplexity=perplexity,
            num_masked=num_masked,
            projected_states=transformer_out,
            projected_quantized_states=quantized,
        )

"""Convolution output-length math (counterpart of ``huggingface_asr_tpu/ops/lengths.py``).

Works on Python ints, numpy arrays and torch tensors alike: only ``+``, ``-``
and ``//`` are used.
"""

from __future__ import annotations

from typing import Sequence

import torch


def conv_output_length(input_length, kernel_size: int, stride: int = 1, padding: int = 0,
                       dilation: int = 1):
    """floor((L + 2*pad - dilation*(k-1) - 1) / stride) + 1."""
    return (input_length + 2 * padding - dilation * (kernel_size - 1) - 1) // stride + 1


def causal_conv_output_length(input_length, kernel_size: int, stride: int = 1,
                              dilation: int = 1):
    """Causal conv: left-pad of dilation*(k-1); length = floor((L-1)/stride)+1."""
    pad = dilation * (kernel_size - 1)
    return (input_length + pad - dilation * (kernel_size - 1) - 1) // stride + 1


def conv_stack_output_length(input_length, kernels: Sequence[int], strides: Sequence[int],
                             paddings: Sequence[int] = None, causal: bool = False):
    length = input_length
    if paddings is None:
        paddings = [0] * len(kernels)
    for k, s, p in zip(kernels, strides, paddings):
        if causal:
            length = causal_conv_output_length(length, k, s)
        else:
            length = conv_output_length(length, k, s, p)
    return length


def lengths_to_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) int -> (B, T) bool padding mask (True = valid)."""
    return torch.arange(max_length, device=lengths.device)[None, :] < lengths[:, None]

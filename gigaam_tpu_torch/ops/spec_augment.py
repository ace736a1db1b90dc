"""SpecAugment: frequency + time masking with an explicit generator (port of
``gigaam_tpu/ops/spec_augment.py``).

Matches torchaudio's ``FrequencyMasking``/``TimeMasking`` semantics used by
the reference (``train_utils/module.py:48-55,123-127``): mask width drawn
uniform in [0, param), start uniform in [0, size - width), zero fill,
applied ``n`` times per axis.  ``spec_augment_from_draws`` takes the uniform
draws as tensors, so that a test can feed it another package's draws.
"""

from __future__ import annotations

import torch


def _mask_axis(feats: torch.Tensor, u_width: torch.Tensor,
               u_start: torch.Tensor, max_width: int, axis: int
               ) -> torch.Tensor:
    """One zero-mask along ``axis`` of feats [B, F, T] from two uniform
    draws [B].  torchaudio truncates the sampled floats to integers after
    both draws: the start range uses the un-floored width, so flooring the
    width first would widen it by up to one bin."""
    b, axis_size = feats.shape[0], feats.shape[axis]
    width_f = u_width * max_width
    width = torch.floor(width_f)
    start = torch.floor(u_start * (axis_size - width_f))
    idx = torch.arange(axis_size, device=feats.device)[None, :]
    mask = (idx >= start[:, None]) & (idx < (start + width)[:, None])
    shape = [b, 1, 1]
    shape[axis] = axis_size
    return torch.where(mask.reshape(shape),
                       torch.zeros((), dtype=feats.dtype, device=feats.device),
                       feats)


def spec_augment_from_draws(feats: torch.Tensor, draws: torch.Tensor,
                            freq_masks: int = 2, freq_width: int = 27,
                            time_masks: int = 2, time_width: int = 20
                            ) -> torch.Tensor:
    """feats [B, F, T]; draws [freq_masks + time_masks, 2, B] uniform in
    [0, 1): per mask the width draw, then the start draw; the frequency
    masks come first."""
    for i in range(freq_masks):
        feats = _mask_axis(feats, draws[i, 0], draws[i, 1], freq_width, 1)
    for i in range(freq_masks, freq_masks + time_masks):
        feats = _mask_axis(feats, draws[i, 0], draws[i, 1], time_width, 2)
    return feats


def spec_augment(gen: torch.Generator, feats: torch.Tensor,
                 freq_masks: int = 2, freq_width: int = 27,
                 time_masks: int = 2, time_width: int = 20) -> torch.Tensor:
    """feats [B, F, T] -> masked features (training-time augmentation); the
    draws come from ``gen``, which lives on feats' device."""
    draws = torch.rand((freq_masks + time_masks, 2, feats.shape[0]),
                       generator=gen, device=feats.device)
    return spec_augment_from_draws(feats, draws, freq_masks, freq_width,
                                   time_masks, time_width)

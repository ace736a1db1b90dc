"""The port's log-mel frontend against ``gigaam_tpu.frontend`` on the CPU in
fp32: features for ``center`` True and False on a ragged batch, ``out_len``
(including the clamp at 0 for audio shorter than one window) and
``num_frames``.  Tolerance: atol 1e-4 on the log-mel."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gigaam_tpu import frontend as jfe
from gigaam_tpu.config import FeaturesConfig

from gigaam_tpu_torch import frontend as tfe
from gigaam_tpu_torch.config import FeaturesConfig as PortFeatures

ATOL = 1e-4


@pytest.mark.parametrize("center", [True, False])
def test_logmel_matches_jax(center):
    rng = np.random.default_rng(0)
    n = 16000
    wavs = (0.3 * rng.standard_normal((3, n))).astype(np.float32)
    lengths = np.array([n, 11000, 3000], np.int32)
    for i, l in enumerate(lengths):
        wavs[i, l:] = 0.0
    ref, ref_len = jfe.LogMelFrontend(FeaturesConfig(center=center))(
        jnp.asarray(wavs), jnp.asarray(lengths))
    got, got_len = tfe.LogMelFrontend(PortFeatures(center=center))(
        torch.from_numpy(wavs), torch.from_numpy(lengths))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))


@pytest.mark.parametrize("center", [True, False])
def test_out_len_and_num_frames_match_jax(center):
    lengths = np.array([0, 1, 159, 160, 399, 400, 401, 16000], np.int32)
    cfg, pcfg = FeaturesConfig(center=center), PortFeatures(center=center)
    got = tfe.out_len(torch.from_numpy(lengths), pcfg).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfe.out_len(jnp.asarray(lengths), cfg)))
    assert got.min() >= 0                   # the short-audio clamp
    for n in (400, 401, 16000, 320000):
        assert tfe.num_frames(n, pcfg) == jfe.num_frames(n, cfg)


def test_short_audio_gives_zero_length_not_negative():
    """center=False audio shorter than one window has no valid frame."""
    lens = tfe.out_len(torch.tensor([0, 100, 399]), PortFeatures(center=False))
    assert lens.tolist() == [0, 0, 0]

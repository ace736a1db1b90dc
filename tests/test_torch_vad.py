"""The port's voice-activity segmentation (``gigaam_tpu_torch/vad.py``)
against ``gigaam_tpu.vad`` on the same inputs, drawn with
``numpy.random.default_rng``: the energy VAD on bursts, silence, short
input, stationary noise and 8 kHz input, the chunk-merge policy (fixed
cases and a ``hypothesis`` property), ``segment_audio_file`` on arrays and
WAV files; then the neural-artifact discovery: the opt-out, the cache
default, the cached detector, the corrupt-artifact warning and the device
rule.  Host numpy on both sides: regions and chunks must be equal."""

import os
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gigaam_tpu import vad as jvad

from gigaam_tpu_torch import vad
from gigaam_tpu_torch.audio import save_wav
from gigaam_tpu_torch.models.vad_net import (
    PyanNet,
    VADNetConfig,
    init_vad_state,
    make_speech_regions_fn,
    save_vad,
)

SR = 16000
TINY = VADNetConfig(
    sinc_filters=8, sinc_kernel=31, sinc_stride=10,
    conv_channels=6, conv_kernel=5, n_conv_blocks=2, pool=3,
    lstm_hidden=8, lstm_layers=2, linear_hidden=8, linear_layers=2,
    n_classes=7, window_s=0.5, step_s=0.25)


def bursts(seconds, sr=SR, seed=0):
    """Tone bursts of 0.2-5 s under 0.1-0.5 s gaps of faint noise."""
    rng = np.random.default_rng(seed)
    audio = (1e-4 * rng.standard_normal(int(sr * seconds))).astype(
        np.float32)
    t_cur, i = 0.0, 0
    while True:
        dur = float(rng.uniform(0.2, 5.0))
        if t_cur + dur > seconds:
            break
        n = int(sr * dur)
        t = np.arange(n) / sr
        seg = (0.4 * np.sin(2 * np.pi * (100 + 20 * i) * t)
               + 0.2 * np.sin(2 * np.pi * (300 + 40 * i) * t)
               + 0.02 * rng.standard_normal(n))
        start = int(t_cur * sr)
        audio[start:start + n] += seg.astype(np.float32)
        t_cur += dur + float(rng.uniform(0.1, 0.5))
        i += 1
    return audio


INPUTS = {
    "bursts": lambda: (bursts(60.0), SR),
    "silence": lambda: (np.zeros(SR * 5, np.float32), SR),
    "empty": lambda: (np.zeros(0, np.float32), SR),
    "short_loud": lambda: (0.3 * np.ones(100, np.float32), SR),
    "short_quiet": lambda: (1e-5 * np.ones(100, np.float32), SR),
    "noise": lambda: ((0.1 * np.random.default_rng(1).standard_normal(
        SR * 20)).astype(np.float32), SR),
    "bursts_8k": lambda: (bursts(40.0, sr=8000, seed=2), 8000),
}


@pytest.mark.parametrize("name", list(INPUTS))
def test_energy_vad_matches_jax(name):
    wav, sr = INPUTS[name]()
    got = vad.energy_speech_regions(wav, sr)
    assert got == jvad.energy_speech_regions(wav, sr)
    if name in ("bursts", "bursts_8k"):
        assert len(got) > 5
    if name in ("silence", "empty", "short_quiet"):
        assert got == []
    if name in ("noise", "short_loud"):
        assert got == [(0.0, len(wav) / sr)]


@pytest.mark.parametrize("name", ["bursts", "noise", "bursts_8k"])
def test_segment_audio_file_matches_jax(name, tmp_path):
    wav, sr = INPUTS[name]()
    segs, bounds = vad.segment_audio_file(wav, sr)
    ref_segs, ref_bounds = jvad.segment_audio_file(wav, sr)
    assert bounds == ref_bounds
    assert len(segs) == len(ref_segs) > 0
    for a, b in zip(segs, ref_segs):
        np.testing.assert_array_equal(a, b)
    # a WAV file, read at 16 kHz, with the policy's keywords passed through
    path = str(tmp_path / "audio.wav")
    save_wav(path, wav, sr)
    kw = dict(max_duration=8.0, min_duration=5.0)
    got = vad.segment_audio_file(path, **kw)
    ref = jvad.segment_audio_file(path, **kw)
    assert got[1] == ref[1]
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(a, b)


MERGE_CASES = [
    [],
    [(0.0, 0.1)],                               # below the 0.2 s floor
    [(0.5, 3.0), (3.5, 9.0), (9.2, 14.0), (14.5, 20.0), (21.0, 25.0)],
    [(0.0, 75.0)],                              # split evenly above 30 s
    [(-1.0, 5.0), (6.0, 40.0), (40.5, 41.0)],   # clipped to the audio
]


@pytest.mark.parametrize("regions", MERGE_CASES)
def test_merge_regions_matches_jax(regions):
    total = 40.0
    assert (vad.merge_regions_into_chunks(regions, total)
            == jvad.merge_regions_into_chunks(regions, total))


@st.composite
def region_lists(draw):
    """Ordered, non-overlapping regions: (gap, length) pairs in seconds."""
    pairs = draw(st.lists(st.tuples(
        st.floats(0.0, 3.0, allow_nan=False),
        st.floats(0.0, 40.0, allow_nan=False)), max_size=30))
    regions, t = [], 0.0
    for gap, length in pairs:
        regions.append((t + gap, t + gap + length))
        t += gap + length
    return regions, max(t, 1.0)


@settings(max_examples=150, deadline=None)
@given(region_lists(),
       st.sampled_from([(22.0, 15.0, 30.0), (8.0, 5.0, 12.0),
                        (30.0, 25.0, 30.0)]))
def test_merge_policy_property(case, limits):
    """The chunks equal the JAX package's, are ordered and disjoint, lie in
    the audio, are longer than the drop threshold and no longer than the
    hard limit; every region's speech lies in some chunk unless it was
    dropped with a chunk under the threshold."""
    regions, total = case
    max_d, min_d, strict = limits
    kw = dict(max_duration=max_d, min_duration=min_d,
              strict_limit_duration=strict)
    chunks = vad.merge_regions_into_chunks(regions, total, **kw)
    assert chunks == jvad.merge_regions_into_chunks(regions, total, **kw)
    eps = 1e-9
    for s, e in chunks:
        assert 0.0 <= s < e <= total + eps
        assert 0.2 < e - s <= strict + eps
    for (_, e0), (s1, _) in zip(chunks, chunks[1:]):
        assert e0 <= s1 + eps
    for s, e in regions:
        if e - s > 0.2 and e <= total:
            mid = 0.5 * (s + e)
            assert any(cs - eps <= mid <= ce + eps for cs, ce in chunks)


# ---------------------------------------------------------------------------
# Discovery of a neural VAD artifact
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """No cached detector, an empty cache directory."""
    monkeypatch.setattr(vad, "_NEURAL_VAD", None)
    monkeypatch.setattr(vad, "CACHE_DIR", str(tmp_path / "empty"))
    monkeypatch.delenv("GIGAAM_VAD_ARTIFACT", raising=False)
    return tmp_path


def tiny_net(seed=0):
    return PyanNet(TINY, init_vad_state(TINY, seed))


def test_discovery_finds_the_artifact(fresh, monkeypatch):
    net = tiny_net()
    art = str(fresh / "vad_segmentation")
    save_vad(art, net)
    wav = bursts(3.0, seed=5)

    assert vad._discover_neural_vad("cpu") is None     # nothing anywhere
    monkeypatch.setenv("GIGAAM_VAD_ARTIFACT", art + ".npz")
    fn = vad._discover_neural_vad("cpu")
    assert fn is not None and fn(wav) == make_speech_regions_fn(net)(wav)
    assert vad._discover_neural_vad("cpu") is fn        # cached
    segs, bounds = vad.segment_audio_file(wav, device="cpu")
    assert bounds == vad.merge_regions_into_chunks(
        make_speech_regions_fn(net)(wav), len(wav) / SR)
    for value in ("energy", "off", "0", "None"):
        monkeypatch.setenv("GIGAAM_VAD_ARTIFACT", value)
        assert vad._discover_neural_vad("cpu") is None
    # the cache default
    monkeypatch.delenv("GIGAAM_VAD_ARTIFACT")
    monkeypatch.setattr(vad, "CACHE_DIR", str(fresh))
    assert vad._discover_neural_vad("cpu") is not None


def test_discovery_runs_on_the_card_unless_told(fresh, monkeypatch):
    """An artifact with no device named runs on the card: without CUDA
    that raises, it does not fall back to the CPU."""
    import torch

    art = str(fresh / "vad_segmentation")
    save_vad(art, tiny_net())
    monkeypatch.setenv("GIGAAM_VAD_ARTIFACT", art)
    if torch.cuda.is_available():
        assert vad._discover_neural_vad() is not None
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vad.segment_audio_file(bursts(2.0))


def test_corrupt_artifact_falls_back_to_energy(fresh, monkeypatch):
    """A half-written artifact (an npz that is not one, no json) becomes
    the energy VAD with one warning, cached."""
    bad = fresh / "vad_segmentation.npz"
    bad.write_bytes(b"not an npz")
    monkeypatch.setenv("GIGAAM_VAD_ARTIFACT", str(bad))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert vad._discover_neural_vad("cpu") is None
        assert any("unusable VAD artifact" in str(x.message) for x in w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert vad._discover_neural_vad("cpu") is None
        assert not w
    wav = bursts(20.0, seed=3)
    assert (vad.segment_audio_file(wav, device="cpu")[1]
            == jvad.merge_regions_into_chunks(
                jvad.energy_speech_regions(wav), len(wav) / SR))
    # an artifact whose tensors do not fit its config is unreadable too
    art = str(fresh / "mismatch")
    save_vad(art, tiny_net())
    with open(art + ".json", "w") as f:
        f.write('{"lstm_hidden": 16}')
    monkeypatch.setenv("GIGAAM_VAD_ARTIFACT", art + ".npz")
    with pytest.warns(UserWarning, match="unusable VAD artifact"):
        assert vad._discover_neural_vad("cpu") is None
    assert os.path.isfile(art + ".npz")

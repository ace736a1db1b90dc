"""Longform transcription and the batch API of the port against the JAX
package, on the CPU in fp32, on the same weights (``params_from_jax``) and
audio drawn with ``numpy.random.default_rng``:

* ``transcribe_longform`` of a tiny v3 CTC model and a tiny rotary RNNT
  model on ~70 s of speech-like bursts, with ``fr_batch_size=4`` and the
  chunk policy's keywords set so that more than two chunk batches run (two
  in flight): segment boundaries and texts equal, word times within
  TIME_ATOL, confidences within CONF_RTOL;
* ``_decode_batch`` with ``pad_rows_to`` and ``bucket``, and what it
  refuses of the beam/LM keywords;
* the ``_int16_wire``;
* ``GigaAM``'s ``compute_dtype`` and ``use_fused_attention`` (the encoder's
  routing observed through the kernel wrappers) and ``load_model``'s
  ``bf16_encoder``.
"""

import types

import numpy as np
import pytest
import torch

import jax

from gigaam_tpu import config as jcfg
from gigaam_tpu.models.model import GigaAMASR as JaxASR

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.models import encoder as tenc
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.weights import save_model

# word times: segment offsets plus frame * shift, rounded to the ms by
# Word.shifted on both sides
TIME_ATOL = 1e-6
# exp(mean logp) of fp32 log-probs from encoders summed in another order
CONF_RTOL = 1e-4
SR = 16000
# smaller chunks than the default 15-22 s, so that ~70 s make > 8 chunks
POLICY = dict(max_duration=8.0, min_duration=5.0)


def ctc_cfg(attention="rotary"):
    v = len(jcfg.RU_VOCAB) + 1
    return jcfg.ModelConfig(
        model_name=f"tiny_{attention}_ctc", model_class="asr",
        preprocessor=jcfg.FeaturesConfig(center=attention != "rotary"),
        encoder=jcfg.EncoderConfig(
            feat_in=64, n_layers=2, d_model=64, n_heads=4,
            ff_expansion_factor=2, conv_kernel_size=7, pos_emb_max_len=256,
            self_attention_model=attention),
        head=jcfg.CTCHeadConfig(feat_in=64, num_classes=v),
        decoding=jcfg.DecodingConfig(kind="ctc_greedy",
                                     vocabulary=list(jcfg.RU_VOCAB)))


def port_of(jm, **kw):
    return gt.GigaAMASR(gt.ModelConfig.from_dict(jm.cfg.to_dict()),
                        state=gt.params_from_jax(
                            jax.tree.map(np.asarray, jm.params)),
                        device="cpu", **kw)


@pytest.fixture(scope="module")
def ctc_pair():
    jm = JaxASR(ctc_cfg(), seed=5)
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def rnnt_pair():
    from test_torch_rnnt import rnnt_pair as make

    return make(types.SimpleNamespace(cfg=jcfg))


def voice(seconds, rng):
    tt = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(100, 220)
    sig = sum(np.sin(2 * np.pi * f0 * h * tt) / h for h in range(1, 5))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * tt + rng.uniform(0, 6)))
    return (0.2 * sig * env + 0.02 * rng.standard_normal(tt.shape)).astype(
        np.float32)


def longform_audio(seconds, seed):
    """Bursts of 2-9 s between 0.6-1.5 s of faint noise (-80 dBFS)."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < seconds * SR:
        burst = voice(rng.uniform(2.0, 9.0), rng)
        gap = (1e-4 * rng.standard_normal(
            int(rng.uniform(0.6, 1.5) * SR))).astype(np.float32)
        parts += [burst, gap]
        total += len(burst) + len(gap)
    return np.concatenate(parts)


def assert_same_longform(got, ref, with_words=True):
    assert [(s.start, s.end) for s in got] == [(s.start, s.end) for s in ref]
    assert [s.text for s in got] == [s.text for s in ref]
    if not with_words:
        assert all(s.words is None for s in got)
        return
    for g, r in zip(got, ref):
        assert [w.text for w in g.words] == [w.text for w in r.words]
        np.testing.assert_allclose([(w.start, w.end) for w in g.words],
                                   np.reshape([(w.start, w.end)
                                               for w in r.words], (-1, 2)),
                                   atol=TIME_ATOL, rtol=0)
        np.testing.assert_allclose([w.confidence for w in g.words],
                                   [w.confidence for w in r.words],
                                   rtol=CONF_RTOL)


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_transcribe_longform_matches_jax(kind, ctc_pair, rnnt_pair,
                                         monkeypatch):
    jm, tm = ctc_pair if kind == "ctc" else rnnt_pair
    wav = longform_audio(70.0, seed=11)
    submits = []
    inner = tm._decode_batch_submit

    def counting(wavs, *a, **kw):
        submits.append((len(wavs), kw["pad_rows_to"]))
        return inner(wavs, *a, **kw)

    monkeypatch.setattr(tm, "_decode_batch_submit", counting)
    ref = jm.transcribe_longform(wav, word_timestamps=True, fr_batch_size=4,
                                 **POLICY)
    got = tm.transcribe_longform(wav, word_timestamps=True,
                                 fr_batch_size=4, **POLICY)
    assert len(submits) > 2 and all(p == 4 for _, p in submits)
    assert isinstance(got, gt.LongformTranscriptionResult)
    assert_same_longform(got, ref)
    assert sum(len(s.words) for s in got) > 3
    for s in got:
        assert all(s.start - 1e-3 <= w.start <= w.end <= s.end + 1e-3
                   for w in s.words)
    if kind == "ctc":
        plain = tm.transcribe_longform(wav, fr_batch_size=4, **POLICY)
        assert_same_longform(plain, ref, with_words=False)


def test_transcribe_longform_of_silence_is_empty(ctc_pair):
    _, tm = ctc_pair
    res = tm.transcribe_longform(np.zeros(SR * 30, np.float32))
    assert res.segments == [] and res.text == ""


def test_decode_batch_pads_rows_and_buckets_as_jax(ctc_pair):
    """Filler rows and a coarser bucket change the padded shapes, not the
    results; the filler rows never reach the host decode."""
    jm, tm = ctc_pair
    rng = np.random.default_rng(3)
    wavs = [voice(s, rng) for s in (1.2, 2.7, 0.6)]
    base = tm._decode_batch(wavs, True)
    for kw in (dict(pad_rows_to=8), dict(bucket=4 * SR),
               dict(pad_rows_to=5, bucket=SR // 2)):
        got = tm._decode_batch(wavs, True, **kw)
        ref = jm._decode_batch(wavs, True, **kw)
        assert len(got) == 3
        assert [t for t, _ in got] == [t for t, _ in ref] == \
            [t for t, _ in base]
        for (_, gw), (_, rw) in zip(got, ref):
            assert [(w.text, w.start, w.end) for w in gw] == \
                [(w.text, w.start, w.end) for w in rw]
    finalize = tm._decode_batch_submit(wavs, False, pad_rows_to=4)
    assert [t for t, _ in finalize()] == [t for t, _ in base]


def test_decode_batch_refuses_beam_and_lm(ctc_pair, tmp_path):
    """What ``_decode_batch`` still refuses, as the JAX package does: an LM
    without a beam, an LM over another vocabulary, an LM path that holds
    none; a beam (with an LM) now runs, in ``transcribe_longform`` too
    (its results against JAX's: ``tests/test_torch_beam.py``)."""
    from gigaam_tpu_torch.decode.lm import NGramLM

    _, tm = ctc_pair
    wav = [np.zeros(SR, np.float32)]
    with pytest.raises(ValueError, match="requires beam_size > 1"):
        tm._decode_batch(wav, False, lm="lm.npz")
    with pytest.raises(ValueError, match="vocab"):
        tm._decode_batch(wav, False, beam_size=4,
                         lm=NGramLM.train([[0, 1]], vocab_size=5, order=2))
    with pytest.raises(FileNotFoundError):
        tm._decode_batch(wav, False, beam_size=4,
                         lm=str(tmp_path / "missing.npz"))
    lm = NGramLM.train([[0, 1, 2]], vocab_size=len(tm.tokenizer), order=2)
    for kw in (dict(beam_size=4), dict(beam_size=4, lm=lm)):
        assert len(tm._decode_batch(wav, False, **kw)) == 1
    res = tm.transcribe_longform(longform_audio(20.0, seed=1), beam_size=2)
    assert isinstance(res, gt.LongformTranscriptionResult) and res.segments


def test_int16_wire_matches_jax(ctc_pair):
    """Audio on the 16-bit grid (as read from a WAV) crosses the int16 wire
    exactly: the same results as the float wire, and as the JAX package's
    int16 wire; other audio within one quantisation step of the input."""
    jm, tm = ctc_pair
    rng = np.random.default_rng(8)
    wavs = [np.round(voice(s, rng) * 32768.0) / 32768.0
            for s in (1.5, 2.5)]
    base = tm._decode_batch(wavs, True)
    tm._int16_wire = jm._int16_wire = True
    try:
        batch, _, _, _ = tm._device_batch(wavs)
        assert batch.dtype == torch.int16
        got = tm._decode_batch(wavs, True)
        ref = jm._decode_batch(wavs, True)
        enc_wire = tm.encode_batch(wavs)[0]
    finally:
        tm._int16_wire = jm._int16_wire = False
    assert got == base
    assert [t for t, _ in got] == [t for t, _ in ref]
    torch.testing.assert_close(enc_wire, tm.encode_batch(wavs)[0], rtol=0,
                               atol=0)


def run_counting(monkeypatch, model, wavs):
    """``_decode_batch`` with the kernel wrappers that the encoder calls
    counted (on the CPU each takes its plain version)."""
    calls = []
    for name in ("folded_rotary_attention", "folded_rotary_attention_lnres"):
        fn = getattr(tenc, name)
        monkeypatch.setattr(tenc, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    for name in ("fused_mha", "fused_relpos_mha"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    out = model._decode_batch(wavs, True)
    monkeypatch.undo()
    return out, calls


@pytest.mark.parametrize("attention", ["rotary", "rel_pos"])
def test_use_fused_attention_routes_the_encoder(attention, monkeypatch):
    """``use_fused_attention=False`` keeps every layer off the kernel
    wrappers and gives the JAX results; the default takes them.  One
    config object serves both models and is not modified."""
    jm = JaxASR(ctc_cfg(attention), seed=2)
    cfg = gt.ModelConfig.from_dict(jm.cfg.to_dict())
    before = cfg.to_dict()
    state = gt.params_from_jax(jax.tree.map(np.asarray, jm.params))
    fused = gt.GigaAMASR(cfg, state=state, device="cpu")
    plain = gt.GigaAMASR(cfg, state=state, device="cpu",
                         use_fused_attention=False)
    assert fused.use_fused_attention and not plain.use_fused_attention
    assert cfg.to_dict() == before and plain.cfg is fused.cfg
    rng = np.random.default_rng(6)
    wavs = [voice(s, rng) for s in (1.0, 2.0)]
    got_f, calls_f = run_counting(monkeypatch, fused, wavs)
    got_p, calls_p = run_counting(monkeypatch, plain, wavs)
    assert calls_p == [] and len(calls_f) == 2       # one per layer
    ref = jm._decode_batch(wavs, True)
    assert [t for t, _ in got_p] == [t for t, _ in got_f] == \
        [t for t, _ in ref]


def test_compute_dtype_and_bf16_encoder(ctc_pair, tmp_path):
    _, tm = ctc_pair
    assert tm.compute_dtype == torch.float32
    rng = np.random.default_rng(9)
    wavs = [voice(1.5, rng)]
    bf16 = port_of(ctc_pair[0], compute_dtype=torch.bfloat16)
    enc, _ = bf16.encode_batch(wavs)
    assert enc.dtype == torch.bfloat16
    ref, _ = tm.encode_batch(wavs)
    err = float((enc.float() - ref).norm() / ref.norm())
    assert err < 0.05                # bf16 activations over 2 layers
    path = str(tmp_path / "tiny")
    save_model(tm, path)
    loaded = gt.load_model(path, device="cpu", bf16_encoder=True,
                           use_fused_attention=False,
                           compute_dtype=torch.bfloat16)
    # bf16_encoder casts on a CUDA device only
    assert all(p.dtype == torch.float32 for p in loaded.encoder.parameters())
    assert loaded.compute_dtype == torch.bfloat16
    assert not loaded.use_fused_attention

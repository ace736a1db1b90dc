"""The port's streaming transcriber against the JAX package's, on the CPU
in fp32, on the same weights (``params_from_jax``): the 7 cases of
``tests/test_streaming.py``, each also holding the port's events (kind,
text, word times) and committed text to those of the JAX
``StreamingTranscriber`` fed the same chunks: LocalAgreement-2 commits,
their stability, trims on a long stream, ``stream_file``, the oracle that
pins zero word loss, the flush contract, and an RNNT model."""

import types

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.audio import save_wav
from gigaam_tpu_torch.streaming import StreamingTranscriber, stream_file
from gigaam_tpu_torch.types import Word

SR = 16000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test workers beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ctc_pair():
    from test_torch_model import model_pair

    return model_pair()


def _speechy(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.3 * np.sin(2 * np.pi * 280 * t)
            + 0.08 * rng.standard_normal(t.size)).astype(np.float32)


def _as_tuples(events):
    return [(e.kind, e.text, [(w.text, w.start, w.end) for w in e.words])
            for e in events]


def _run(transcriber_cls, model, pieces, **kw):
    """Push ``pieces`` then flush -> (events, the transcriber)."""
    st = transcriber_cls(model, **kw)
    events = [ev for p in pieces for ev in st.push(p)]
    events.append(st.flush())
    return events, st


def _pieces(wav, step):
    return [wav[i: i + step] for i in range(0, len(wav), step)]


def assert_same_stream(pair, pieces, **kw):
    """The port's and the JAX transcriber's events and texts for the same
    chunks; returns the port's (events, transcriber)."""
    from gigaam_tpu.streaming import StreamingTranscriber as JaxST

    jm, tm = pair
    got, st = _run(StreamingTranscriber, tm, pieces, **kw)
    ref, jst = _run(JaxST, jm, pieces, **kw)
    assert _as_tuples(got) == _as_tuples(ref)
    assert st.text == jst.text
    assert st._base == jst._base
    return got, st


def test_short_stream_matches_offline(ctc_pair, tmp_path):
    """Committed text after flush == offline transcribe (no trims for
    streams shorter than the window; the flush decodes the whole buffer)."""
    wav = _speechy(6.0, seed=1)
    path = str(tmp_path / "s.wav")
    save_wav(path, wav)
    offline = ctc_pair[1].transcribe(path).text
    assert offline == ctc_pair[0].transcribe(path).text
    # 16-bit quantized input (as the wav file stores it) so both paths see
    # identical samples
    q = (np.clip(np.rint(wav * 32767.0), -32768, 32767) / 32768.0).astype(
        np.float32)
    _, st = assert_same_stream(ctc_pair, _pieces(q, SR // 2), window_s=20.0,
                               stride_s=2.0, trim_s=12.0)
    assert st.text == offline and st.text


def test_committed_text_is_stable(ctc_pair):
    """Committed words are never retracted or reordered as audio grows."""
    from gigaam_tpu.streaming import StreamingTranscriber as JaxST

    jm, tm = ctc_pair
    wav = _speechy(10.0, seed=2)
    st = StreamingTranscriber(tm, window_s=20.0, stride_s=1.0)
    jst = JaxST(jm, window_s=20.0, stride_s=1.0)
    snapshots = []
    for piece in _pieces(wav, SR // 2):
        assert _as_tuples(st.push(piece)) == _as_tuples(jst.push(piece))
        snapshots.append(st.text)
    st.flush()
    jst.flush()
    snapshots.append(st.text)
    assert st.text == jst.text
    for a, b in zip(snapshots, snapshots[1:]):
        assert b.startswith(a), (a, b)
    times = [(w.start, w.end) for w in st.committed]
    assert times == sorted(times)
    for w in st.committed:
        assert w.start < w.end


def test_long_stream_trims_buffer(ctc_pair):
    """A stream longer than trim_s keeps the rolling buffer bounded."""
    wav = _speechy(30.0, seed=3)
    kw = dict(window_s=16.0, stride_s=2.0, trim_s=8.0)
    st = StreamingTranscriber(ctc_pair[1], **kw)
    for piece in _pieces(wav, SR):
        st.push(piece)
        assert len(st._buf) <= st.window
    _, st = assert_same_stream(ctc_pair, _pieces(wav, SR), **kw)
    assert st.text
    assert st._base > 0, "expected at least one buffer trim on 30 s audio"


def test_stream_file_events(ctc_pair):
    """stream_file yields partial + committed events and one final flush,
    the JAX ``stream_file``'s."""
    from gigaam_tpu.streaming import stream_file as jax_stream_file

    jm, tm = ctc_pair
    wav = _speechy(8.0, seed=4)
    kw = dict(chunk_s=0.5, window_s=20.0, stride_s=2.0)
    events = list(stream_file(tm, wav, **kw))
    kinds = [e.kind for e in events]
    assert kinds[-1] == "committed"
    assert "partial" in kinds
    assert set(events[-1].to_dict()) == {"kind", "text", "words"}
    assert _as_tuples(events) == _as_tuples(jax_stream_file(jm, wav, **kw))


def test_localagreement_zero_word_loss_oracle(ctc_pair):
    """Zero word loss and zero duplication on a seeded 60 s stream, pinned
    against the policy itself: each buffer decode returns the ground-truth
    words fully inside the buffer, a word near the unstable right edge
    mangled.  LocalAgreement-2 + midpoint dedup + trims must reproduce the
    truth exactly, and the JAX transcriber's commits."""
    from gigaam_tpu.streaming import StreamingTranscriber as JaxST
    from gigaam_tpu.types import Word as JaxWord

    truth = [(f"w{k}", 2.0 * k + 0.3, 2.0 * k + 1.5) for k in range(29)]
    total_s = 60.0

    def oracle(st, buf, word_cls):
        lo = st._base / SR
        hi = lo + len(buf) / SR
        out = []
        for text, start, end in truth:
            if start >= lo and end <= hi:
                if hi - end < 0.8 and hi < total_s:
                    text = text[:1] + "?"  # still being heard
                out.append(word_cls(text, start - lo, end - lo))
        return out

    made = {}
    for name, cls, word_cls, model in (("port", StreamingTranscriber, Word,
                                        ctc_pair[1]),
                                       ("jax", JaxST, JaxWord, ctc_pair[0])):
        st = cls(model, window_s=20.0, stride_s=2.0, trim_s=12.0,
                 right_margin_s=1.0,
                 decode_fn=lambda buf, c=word_cls: oracle(made[name], buf, c))
        made[name] = st
        rng = np.random.default_rng(0)
        pos, n_total = 0, int(total_s * SR)
        while pos < n_total:
            step = int(rng.uniform(0.3, 0.9) * SR)  # ragged chunk sizes
            st.push(np.zeros(min(step, n_total - pos), np.float32))
            pos += step
        st.flush()

    st = made["port"]
    assert st.text.split() == [t for t, _, _ in truth]
    for a, (_, start, end) in zip(st.committed, truth):
        assert abs(a.start - start) < 1e-6 and abs(a.end - end) < 1e-6
    assert st._base > 0, "stream this long must have trimmed"
    assert [(w.text, w.start, w.end) for w in st.committed] == [
        (w.text, w.start, w.end) for w in made["jax"].committed]


def test_push_after_flush_raises(ctc_pair):
    st = StreamingTranscriber(ctc_pair[1])
    st.push(np.zeros(SR, np.float32))
    st.flush()
    with pytest.raises(AssertionError):
        st.push(np.zeros(100, np.float32))


def test_streaming_rnnt_model():
    """Streaming an RNNT model (frames from its greedy label loop): a
    short-stream flush equals the offline decode (whose runs of the
    boosted word-boundary token the stream's word join collapses) and the
    JAX stream."""
    from gigaam_tpu import config as jcfg
    from test_torch_model import voice
    from test_torch_rnnt import rnnt_pair

    pair = rnnt_pair(types.SimpleNamespace(cfg=jcfg))
    wav = voice(5.0, np.random.default_rng(0))
    _, st = assert_same_stream(pair, _pieces(wav, SR // 2), window_s=20.0,
                               stride_s=2.0)
    offline = pair[1]._decode_batch([wav], word_timestamps=False)[0][0]
    assert st.text == " ".join(offline.split()) and st.text

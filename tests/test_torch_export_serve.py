"""Export, artifact-only inference, the batching HTTP server and the client of
the port against the JAX package, on the CPU in fp32, on the same weights
(``params_from_jax``) and audio drawn with ``numpy.random.default_rng``.

The 26 cases of ``tests/test_export_serve.py``, each with the port's
numbers or texts held to the JAX model's:

* the CTC round trip: the exported log-probs equal the port's live ones
  and the JAX model's live ones within ATOL (fp32, another summation
  order), the lengths exactly;
* the RNNT ``decoder``/``joint`` programs against JAX's
  ``rnnt_predict_step``/``rnnt_joint_step`` within STEP_ATOL;
* ``infer_exported`` texts (CTC, RNNT, a bundled SentencePiece model),
  emo probabilities and SSL embeddings against the JAX model's live ones;
* every server case (``/transcribe`` as JSON and as 16/24-bit WAV,
  ``/transcribe_longform``, ``/transcribe_stream``, the client) with its
  texts equal to the JAX model's for the same rows and bucket.

Then the thread-safety of step 0: ``PosTables`` grown from 8 threads,
``full_fp32`` nested across threads, ``_decode_batch`` and
``transcribe_longform`` from 4 threads at once against the serial results;
the registered ops; and a subprocess that drives the new entry points with
neither JAX nor the JAX package imported.

The tests marked ``gpu`` hold an exported graph to the live model on the
card (K1/K2 counted in the graph); they skip without one.  JAX is imported
inside the CPU tests only: ``pytest --noconftest -m gpu
tests/test_torch_export_serve.py`` runs on a host without it.
"""

import http.client
import json
import os
import shutil
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.export import export_model, load_exported
from gigaam_tpu_torch.frontend import LogMelFrontend
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.serve import BatchingASRServer, _Request, make_handler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# fp32 on both sides, the same math summed in another order
ATOL = 1e-4
STEP_ATOL = 1e-5
BUCKET = 5 * SR          # the server's default bucket
ROWS = 4                 # the module server's max_batch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them as fast and
    leaves the other cores to the test workers beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_of(jm, cls=None):
    import jax

    return (cls or gt.GigaAMASR)(
        gt.ModelConfig.from_dict(jm.cfg.to_dict()),
        state=gt.params_from_jax(jax.tree.map(np.asarray, jm.params)),
        device="cpu")


@pytest.fixture(scope="module")
def ctc_pair():
    from test_torch_model import model_pair

    return model_pair()


@pytest.fixture(scope="module")
def rnnt_pair():
    from gigaam_tpu import config as jcfg
    from test_torch_rnnt import rnnt_pair as make

    return make(types.SimpleNamespace(cfg=jcfg))


def noise(n, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(n)).astype(
        np.float32)


def speechy(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (0.3 * np.sin(2 * np.pi * 280 * t)
            + 0.08 * rng.standard_normal(t.size)).astype(np.float32)


def bursts(seed, n=3, seconds=9):
    """Tone bursts between 1 s silences: VAD boundaries for longform."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR * seconds) / SR
    pieces = []
    for _ in range(n):
        pieces.append(0.3 * np.sin(2 * np.pi * 300 * t)
                      + 0.02 * rng.standard_normal(t.size))
        pieces.append(np.zeros(SR))
    return np.concatenate(pieces).astype(np.float32)


def jax_texts(jm, wavs, rows=ROWS, bucket=BUCKET, **kw):
    """The JAX model's texts for the rows and bucket the server uses."""
    return [t for t, _ in jm._decode_batch(list(wavs), word_timestamps=False,
                                           pad_rows_to=rows, bucket=bucket,
                                           **kw)]


@pytest.fixture(scope="module")
def http_server(ctc_pair):
    server = BatchingASRServer(ctc_pair[1], max_batch=ROWS,
                               batch_window_ms=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    server.shutdown()


def _post_json(url, payload, query=""):
    req = urllib.request.Request(
        url + "/transcribe" + query,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- export ----------------------------------------------------------------


def test_export_ctc_roundtrip(tmp_path, ctc_pair):
    import jax.numpy as jnp

    from gigaam_tpu.models.heads import ctc_log_probs

    jm, tm = ctc_pair
    out = str(tmp_path / "export")
    manifest = export_model(tm, out, batch_sizes=(2,), audio_seconds=(1,))
    assert "ctc" in manifest["graphs"]
    cfg, graphs = load_exported(out, device="cpu")
    assert cfg.model_name == tm.cfg.model_name
    g = graphs["ctc"][0]

    batch = np.zeros((2, SR), np.float32)
    batch[0], batch[1, :12000] = noise(SR, 0), noise(12000, 1)
    lens = np.array([SR, 12000], np.int32)
    fe = LogMelFrontend(cfg.preprocessor)
    with torch.inference_mode():
        feats, feat_lens = fe(torch.from_numpy(batch), torch.from_numpy(lens))
        log_probs, enc_lens = g(feats.transpose(1, 2), feat_lens)
        dev_batch, dev_lens, _, pos = tm._device_batch(
            [batch[0], batch[1, :12000]])
        lp_port, lens_port = tm._ctc_logprobs(dev_batch, dev_lens, pos)
    enc_live, lens_live = jm._encode_jit(
        jm.params, jnp.asarray(batch), jnp.asarray(lens), jm._pos_for(SR))
    lp_jax = np.asarray(ctc_log_probs(jm.params["head"], enc_live))
    np.testing.assert_array_equal(enc_lens.numpy(), np.asarray(lens_live))
    np.testing.assert_array_equal(enc_lens.numpy(), lens_port.numpy())
    for i, n in enumerate(enc_lens.tolist()):
        np.testing.assert_allclose(log_probs[i, :n].numpy(),
                                   lp_port[i, :n].numpy(), atol=ATOL)
        np.testing.assert_allclose(log_probs[i, :n].numpy(), lp_jax[i, :n],
                                   atol=ATOL)


def test_export_rnnt_parts(tmp_path, rnnt_pair):
    import jax.numpy as jnp

    from gigaam_tpu.models.heads import rnnt_joint_step, rnnt_predict_step

    jm, tm = rnnt_pair
    out = str(tmp_path / "export_rnnt")
    manifest = export_model(tm, out, batch_sizes=(1,), audio_seconds=(1,))
    assert set(manifest["graphs"]) >= {"encoder", "decoder", "joint"}
    _, graphs = load_exported(out, device="cpu")
    dec, jnt = graphs["decoder"][0], graphs["joint"][0]
    assert dec.fp32 and jnt.fp32

    head = tm.cfg.head
    rng = np.random.default_rng(1)
    shape = (head.decoder.pred_rnn_layers, 1, head.decoder.pred_hidden)
    h0, c0 = (rng.standard_normal(shape).astype(np.float32) for _ in "hc")
    labels = np.array([3], np.int32)
    pred, h1, c1 = dec(labels, h0, c0)
    ref = rnnt_predict_step(jm.params["head"], jnp.asarray(labels),
                            jnp.asarray(h0), jnp.asarray(c0))
    for got, want in zip((pred, h1, c1), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=STEP_ATOL)

    enc_t = rng.standard_normal((1, head.joint.enc_hidden)).astype(np.float32)
    lp = jnt(enc_t, pred)
    lp_ref = rnnt_joint_step(jm.params["head"], jnp.asarray(enc_t), ref[0])
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), atol=STEP_ATOL)


# -- server ----------------------------------------------------------------


def test_server_health_and_transcribe(http_server, ctc_pair):
    with urllib.request.urlopen(http_server + "/health", timeout=10) as r:
        health = json.loads(r.read())
    assert health == {"status": "ok", "model": ctc_pair[1].cfg.model_name}

    wav = speechy(1.0, 0)
    status, out = _post_json(http_server, {"audio": wav.tolist()})
    assert status == 200 and out["text"] == jax_texts(ctc_pair[0], [wav])[0]

    status, ts = _post_json(http_server, {"audio": wav.tolist()},
                            "?timestamps=1")
    assert status == 200 and "words" in ts
    ref = ctc_pair[0]._decode_batch([wav], True, pad_rows_to=ROWS,
                                    bucket=BUCKET)[0][1]
    assert [w["word"] for w in ts["words"]] == [w.text for w in ref]
    np.testing.assert_allclose([w["start"] for w in ts["words"]],
                               [w.start for w in ref], atol=1e-3)


def test_server_concurrent_batching(http_server, ctc_pair):
    wavs = [speechy(1.0, 10 + i) for i in range(4)]
    results = [None] * 4

    def worker(i):
        results[i] = _post_json(http_server, {"audio": wavs[i].tolist()})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r is not None and r[0] == 200 for r in results)
    assert [r[1]["text"] for r in results] == jax_texts(ctc_pair[0], wavs)


def test_server_pads_rows_to_max_batch(ctc_pair, monkeypatch):
    """Every decode call uses exactly max_batch rows: one shape per
    duration bucket, not one per batch size."""
    jm, tm = ctc_pair
    server = BatchingASRServer(tm, max_batch=4, batch_window_ms=5.0)
    try:
        seen = []
        orig = tm._decode_batch_submit

        def spy(wavs, *a, **kw):
            seen.append(kw.get("pad_rows_to", 0))
            return orig(wavs, *a, **kw)

        monkeypatch.setattr(tm, "_decode_batch_submit", spy)
        wav = noise(8000, 4)
        req = server.submit(wav, timestamps=False)
        assert req.error is None
        assert req.result["text"] == jax_texts(jm, [wav])[0]
        assert seen and all(n == 4 for n in seen), seen
    finally:
        server.shutdown()


def test_server_error_paths(http_server):
    status, out = _post_json(http_server, {"audio": []})
    assert status == 400 and "empty" in out["error"]
    status, out = _post_json(http_server, {"audio": [0.0] * (26 * SR)})
    assert status == 400 and "longform" in out["error"]
    status, out = _post_json(http_server, {"wrong_key": 1})
    assert status == 400


def test_server_longform_endpoint(http_server, ctc_pair):
    """>25 s audio transcribes via /transcribe_longform with segments equal
    to the JAX model's (its VAD, chunk batches of 16, the server's bucket)."""
    wav = bursts(5)
    req = urllib.request.Request(
        http_server + "/transcribe_longform",
        data=json.dumps({"audio": wav.tolist()}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
    assert out["segments"], "expected at least one VAD segment"
    for seg in out["segments"]:
        assert seg["start"] < seg["end"]
    ref = ctc_pair[0].transcribe_longform(wav, fr_batch_size=16,
                                          bucket=BUCKET)
    assert [s["text"] for s in out["segments"]] == [s.text for s in ref]
    assert [(s["start"], s["end"]) for s in out["segments"]] == [
        (s.start, s.end) for s in ref]
    assert out["text"] == ref.text


def test_server_overload_returns_503(ctc_pair):
    """A full queue answers 'overloaded' (503 over HTTP) immediately."""
    server = BatchingASRServer(ctc_pair[1], max_batch=2, batch_window_ms=5.0,
                               max_queue=1)
    try:
        # freeze the batch loop, then stuff the queue so submit() sees it full
        server._stop.set()
        server._thread.join(timeout=2)
        server.q.put_nowait(_Request(np.zeros(1000, np.float32), False))
        req = server.submit(noise(4000, 6), timestamps=False, timeout=1.0)
        assert req.error == "overloaded"
    finally:
        server.shutdown()


# -- artifact-only inference -------------------------------------------------


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_infer_exported_matches_live(tmp_path, kind, ctc_pair, rnnt_pair):
    """Transcripts from the artifacts alone equal the JAX model's live ones
    (and the port's)."""
    from gigaam_tpu_torch.exported_infer import infer_exported

    jm, tm = ctc_pair if kind == "ctc" else rnnt_pair
    out = str(tmp_path / f"export_{kind}")
    export_model(tm, out, batch_sizes=(4,), audio_seconds=(1,))
    wavs = [noise(SR - 1000 * i, 2 + i) for i in range(3)]
    live = [t for t, _ in jm._decode_batch(wavs, word_timestamps=False)]
    got = infer_exported(out, wavs, batch_size=4, device="cpu")["hypotheses"]
    assert got == live
    assert got == [t for t, _ in tm._decode_batch(wavs, False)]
    assert any(got), "the texts should hold tokens"


def test_infer_exported_emo_and_ssl(tmp_path):
    """Emo probs and SSL embeddings from artifacts alone match the live JAX
    models (the reference's emo/ssl ``infer_onnx`` branches)."""
    import jax.numpy as jnp

    from gigaam_tpu.config import (EmoHeadConfig, FeaturesConfig,
                                   ModelConfig)
    from gigaam_tpu.models.model import GigaAM, GigaAMEmo, pad_wav_batch
    from gigaam_tpu_torch.exported_infer import infer_exported

    from test_torch_model import v3_cfg

    enc = v3_cfg().encoder
    wavs = [noise(SR - 2000 * i, 5 + i) for i in range(2)]
    emo_cfg = ModelConfig(
        model_name="tiny_emo", model_class="emo",
        preprocessor=FeaturesConfig(), encoder=enc,
        head=EmoHeadConfig(feat_in=64, num_classes=4),
        id2name=["angry", "sad", "neutral", "positive"])
    emo = GigaAMEmo(emo_cfg, seed=0, compute_dtype=jnp.float32)
    out = str(tmp_path / "export_emo")
    manifest = export_model(port_of(emo, gt.GigaAMEmo), out,
                            batch_sizes=(2,), audio_seconds=(1,))
    assert "probs" in manifest["graphs"]
    got = infer_exported(out, wavs, batch_size=2, device="cpu")["hypotheses"]
    for i, w in enumerate(wavs):
        batch, lens = pad_wav_batch([w])
        live = np.asarray(emo._probs_jit(
            emo.params, jnp.asarray(batch), jnp.asarray(lens),
            emo._pos_for(batch.shape[1])))[0]
        np.testing.assert_allclose(got[i], live, atol=ATOL)
        np.testing.assert_allclose(got[i].sum(), 1.0, atol=1e-5)

    ssl_cfg = ModelConfig(model_name="tiny_ssl", model_class="ssl",
                          preprocessor=FeaturesConfig(), encoder=enc)
    ssl = GigaAM(ssl_cfg, seed=0, compute_dtype=jnp.float32)
    out2 = str(tmp_path / "export_ssl")
    export_model(port_of(ssl, gt.GigaAM), out2, batch_sizes=(2,),
                 audio_seconds=(1,))
    embeds = infer_exported(out2, wavs, batch_size=2,
                            device="cpu")["hypotheses"]
    for i, w in enumerate(wavs):
        enc_live, len_live = ssl.encode_batch([w])
        tl = int(len_live[0])
        assert embeds[i].shape == (tl, 64)
        np.testing.assert_allclose(embeds[i], np.asarray(enc_live)[0, :tl],
                                   atol=ATOL)


def test_infer_exported_wer_and_buckets(tmp_path, ctc_pair):
    from gigaam_tpu_torch.exported_infer import infer_exported

    jm, tm = ctc_pair
    out = str(tmp_path / "export_wer")
    export_model(tm, out, batch_sizes=(2,), audio_seconds=(1,))
    wavs = [noise(8000, 30), noise(8000, 31)]
    hyps = infer_exported(out, wavs, device="cpu")["hypotheses"]
    assert hyps == [t for t, _ in jm._decode_batch(wavs, False)]
    res = infer_exported(out, wavs, refs=hyps, device="cpu")
    assert res["wer_e2e"] == 0.0

    # a batch_size above the largest exported row bucket clamps (with a
    # warning) and still transcribes every item: no silent truncation
    with pytest.warns(UserWarning, match="largest"):
        res4 = infer_exported(out, wavs * 2, batch_size=4, device="cpu")
    assert res4["hypotheses"] == hyps * 2

    # audio longer than any exported duration bucket fails loudly
    with pytest.raises(ValueError):
        infer_exported(out, [noise(3 * SR, 32)], batch_size=2, device="cpu")


# -- client ------------------------------------------------------------------


def test_client_transcribe_files(tmp_path, http_server, ctc_pair):
    from gigaam_tpu_torch.audio import load_audio, save_wav
    from gigaam_tpu_torch.client import health, transcribe_files

    assert health(http_server)["status"] == "ok"
    files = []
    for i in range(3):
        p = str(tmp_path / f"utt{i}.wav")
        save_wav(p, speechy(1.0, 40 + i))
        files.append(p)
    results = transcribe_files(http_server, files, concurrency=3)
    assert [r["text"] for r in results] == jax_texts(
        ctc_pair[0], [load_audio(f) for f in files])

    with_ts = transcribe_files(http_server, files[:1], timestamps=True)
    assert "words" in with_ts[0]


def test_server_beam_size(rnnt_pair):
    """A beam-configured server serves the JAX model's beam texts."""
    jm, tm = rnnt_pair
    srv = BatchingASRServer(tm, max_batch=2, batch_window_ms=5.0,
                            beam_size=4)
    try:
        wav = noise(SR, 0)
        req = srv.submit(wav, timestamps=True)
        assert req.error is None
        assert req.result["text"] == jax_texts(jm, [wav], rows=2,
                                               beam_size=4)[0]
    finally:
        srv.shutdown()


def test_exported_artifact_bundles_sp_tokenizer(tmp_path):
    """SP-tokenizer models export a relocatable artifact dir: the .model
    file is bundled with a relative path, and the moved dir still decodes,
    to the JAX model's texts."""
    import jax.numpy as jnp

    from gigaam_tpu.config import CTCHeadConfig, DecodingConfig, ModelConfig
    from gigaam_tpu.models.model import GigaAMASR as JaxASR
    from gigaam_tpu_torch.decode.tokenizer import write_sp_model
    from gigaam_tpu_torch.exported_infer import infer_exported

    from test_torch_model import v3_cfg
    from test_torch_tokenizer import sp_pieces

    sp_path = str(tmp_path / "tok.model")
    pieces = sp_pieces()
    write_sp_model(sp_path, pieces)
    base = v3_cfg()
    cfg = ModelConfig(
        model_name="tiny_sp_ctc", model_class="asr",
        preprocessor=base.preprocessor, encoder=base.encoder,
        head=CTCHeadConfig(feat_in=64, num_classes=len(pieces) + 1),
        decoding=DecodingConfig(kind="ctc_greedy", vocabulary=[],
                                model_path=sp_path))
    jm = JaxASR(cfg, seed=0, compute_dtype=jnp.float32)
    out = str(tmp_path / "artifact")
    export_model(port_of(jm), out, batch_sizes=(2,), audio_seconds=(1,))
    assert (tmp_path / "artifact" / "tokenizer.model").exists()
    wavs = [noise(12000, 8)]
    live = [t for t, _ in jm._decode_batch(wavs, False)]

    moved = str(tmp_path / "moved_artifact")
    shutil.move(out, moved)
    os.remove(sp_path)
    hyps = infer_exported(moved, wavs, device="cpu")["hypotheses"]
    assert hyps == live


def test_client_routes_longform_files(tmp_path, http_server, ctc_pair):
    """transcribe_files sends >25 s files to the longform endpoint."""
    from gigaam_tpu_torch.audio import load_audio, save_wav
    from gigaam_tpu_torch.client import transcribe_files

    short = str(tmp_path / "short.wav")
    save_wav(short, noise(SR, 7))
    long_p = str(tmp_path / "long.wav")
    save_wav(long_p, bursts(7))
    out = transcribe_files(http_server, [short, long_p])
    assert "text" in out[0] and "segments" not in out[0]
    assert "segments" in out[1]
    jm = ctc_pair[0]
    assert out[0]["text"] == jax_texts(jm, [load_audio(short)])[0]
    ref = jm.transcribe_longform(load_audio(long_p), fr_batch_size=16,
                                 bucket=BUCKET)
    assert [s["text"] for s in out[1]["segments"]] == [s.text for s in ref]


# -- serving bucket coverage + request-body handling -------------------------


def _wav_bytes(wav, sampwidth=2):
    """A float waveform as PCM WAV bytes at the given sample width."""
    import io
    import wave

    clipped = np.clip(wav, -1.0, 1.0)
    if sampwidth == 2:
        data = (clipped * 32767.0).astype("<i2").tobytes()
    else:
        vals = (clipped * 8388607.0).astype("<i4")
        data = vals.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(sampwidth)
        wf.setframerate(SR)
        wf.writeframes(data)
    return buf.getvalue()


def _post_wav(url, body, path="/transcribe"):
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "audio/wav"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_wav_body_sample_widths(http_server, ctc_pair):
    """Every sample width ``load_audio`` accepts (incl. 24-bit) works over
    the wire, through the port's ``load_wav_bytes``."""
    from gigaam_tpu_torch.audio import load_wav_bytes

    wav = speechy(1.0, 7)
    for width in (2, 3):
        body = _wav_bytes(wav, width)
        status, out = _post_wav(http_server, body)
        assert status == 200, (width, status, out)
        assert out["text"] == jax_texts(ctc_pair[0],
                                        [load_wav_bytes(body)])[0]


def test_server_body_size_cap(ctc_pair):
    """Bodies over max_body_bytes are rejected (413) before being read."""
    server = BatchingASRServer(ctc_pair[1], max_batch=2, batch_window_ms=5.0)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), make_handler(server, max_body_bytes=1024))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        status, out = _post_wav(url, _wav_bytes(np.zeros(4000, np.float32)))
        assert status == 413 and "larger" in out["error"]
        status, out = _post_wav(url, _wav_bytes(np.zeros(400, np.float32)))
        assert status == 200
    finally:
        httpd.shutdown()
        server.shutdown()


def test_warmup_covers_every_reachable_graph(ctc_pair, monkeypatch):
    """Default warmup runs every (rows, bucket) a request can route to:
    shortform edges up to the 25 s cap at max_batch rows, longform edges up
    to the VAD's 30 s split cap at longform_batch rows."""
    tm = ctc_pair[1]
    server = BatchingASRServer(tm, max_batch=4, batch_window_ms=5.0,
                               bucket_seconds=5, longform_batch=16)
    seen = []

    def spy(wavs, word_timestamps, beam_size=1, pad_rows_to=0, bucket=0):
        seen.append((pad_rows_to, bucket, max(len(w) for w in wavs)))
        return [("", None)] * len(wavs)

    try:
        monkeypatch.setattr(tm, "_decode_batch", spy)
        server.warmup()
        assert all(b == 5 * SR for _, b, _ in seen)
        got = {(rows, length // SR) for rows, _, length in seen}
        short = {(4, s) for s in (5, 10, 15, 20, 25)}
        long = {(16, s) for s in (5, 10, 15, 20, 25, 30)}
        assert got == short | long, got
    finally:
        server.shutdown()


def test_bucket_coarsening_preserves_output(ctc_pair):
    """Coarse buckets only add masked padding: the transcript and word
    times equal the 1 s-bucket result, and the JAX model's."""
    jm, tm = ctc_pair
    wav = noise(int(1.5 * SR), 8)
    fine = tm._decode_batch([wav], word_timestamps=True)
    coarse = tm._decode_batch([wav], word_timestamps=True, bucket=BUCKET)
    ref = jm._decode_batch([wav], word_timestamps=True, bucket=BUCKET)
    assert fine[0][0] == coarse[0][0] == ref[0][0]
    as_tuples = lambda r: [(w.text, w.start, w.end) for w in r[0][1] or []]  # noqa: E731
    assert as_tuples(fine) == as_tuples(coarse) == as_tuples(ref)


# -- streaming endpoint --------------------------------------------------------


def _server_pushes(wav, chunk_s):
    """The float pieces the stream handler pushes for ``transcribe_stream``
    of ``wav`` in ``chunk_s`` chunks: each chunk read in pieces of at most
    32 KiB (``_body_chunks``)."""
    pcm = np.clip(np.rint(wav * 32768.0), -32768, 32767).astype("<i2")
    step = int(chunk_s * SR)
    out = []
    for i in range(0, len(pcm), step):
        chunk = pcm[i: i + step]
        for j in range(0, len(chunk), 1 << 14):
            out.append(chunk[j: j + (1 << 14)].astype(np.float32) / 32768.0)
    return out


def jax_stream_events(jm, pieces, rows=ROWS):
    """The JAX ``StreamingTranscriber``'s events for the server's pushes,
    its strides decoded as the server's queue decodes them."""
    from gigaam_tpu.streaming import StreamingTranscriber

    from gigaam_tpu.types import Word

    def decode(buf):
        words = jm._decode_batch([buf], True, pad_rows_to=rows,
                                 bucket=BUCKET)[0][1]
        # the times the server's JSON result carries
        return [Word(text=d["word"], start=d["start"], end=d["end"])
                for d in (w.to_dict() for w in words or [])]

    st = StreamingTranscriber(jm, bucket_s=BUCKET / SR, decode_fn=decode)
    events = [ev.to_dict() for p in pieces for ev in st.push(p)]
    return events + [st.flush().to_dict()]


def test_server_streaming_endpoint(http_server, ctc_pair, tmp_path):
    """Chunked s16 PCM upload -> NDJSON events equal to the JAX
    transcriber's; the final committed text equals offline transcribe for a
    short stream."""
    from gigaam_tpu_torch.audio import save_wav
    from gigaam_tpu_torch.client import transcribe_stream

    jm = ctc_pair[0]
    wav = speechy(6.0, 9)
    events = transcribe_stream(http_server, wav, chunk_s=0.5)
    assert events and events[-1]["kind"] == "committed"
    ref = jax_stream_events(jm, _server_pushes(wav, 0.5))
    assert [(e["kind"], e["text"]) for e in events] == [
        (e["kind"], e["text"]) for e in ref]
    committed = " ".join(e["text"] for e in events
                         if e["kind"] == "committed" and e["text"])
    path = str(tmp_path / "stream_ref.wav")
    save_wav(path, wav)
    assert committed == jm.transcribe(path).text


def test_server_streaming_overload(ctc_pair):
    """Streams over the slot cap answer 503 immediately."""
    server = BatchingASRServer(ctc_pair[1], max_batch=2, batch_window_ms=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        while server.stream_slots.acquire(blocking=False):
            pass
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_port,
                                          timeout=30)
        conn.request("POST", "/transcribe_stream", body=b"",
                     headers={"Content-Type": "audio/l16"})
        assert conn.getresponse().status == 503
        conn.close()
    finally:
        httpd.shutdown()
        server.shutdown()


def test_server_stream_error_event_on_malformed_framing(http_server):
    """A garbled chunk-size line surfaces as a final NDJSON error event and
    a cleanly terminated chunked stream."""
    from urllib.parse import urlparse

    u = urlparse(http_server)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=60)
    try:
        conn.putrequest("POST", "/transcribe_stream")
        conn.putheader("Content-Type", "audio/l16")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        conn.send(b"NOT-A-HEX-SIZE\r\n")
        resp = conn.getresponse()
        assert resp.status == 200
        lines = [json.loads(x) for x in resp.read().splitlines() if x.strip()]
        assert lines and lines[-1]["kind"] == "error"
        assert "ValueError" in lines[-1]["error"]
    finally:
        conn.close()


def test_server_stream_long_upload_duplex(http_server, ctc_pair):
    """A 60 s stream (~1.9 MB) does not deadlock: the client reads events
    while it uploads; the events (trims included) equal the JAX
    transcriber's."""
    from gigaam_tpu_torch.client import transcribe_stream

    wav = noise(60 * SR, 11)
    events = transcribe_stream(http_server, wav, chunk_s=2.0, timeout=300)
    assert events and events[-1]["kind"] == "committed"
    ref = jax_stream_events(ctc_pair[0], _server_pushes(wav, 2.0))
    assert [(e["kind"], e["text"]) for e in events] == [
        (e["kind"], e["text"]) for e in ref]


def test_server_stream_decodes_ride_the_batch_queue(ctc_pair, monkeypatch):
    """Stream stride decodes go through the dynamic-batching queue (padded
    to max_batch rows), not their own single-row decodes."""
    from gigaam_tpu_torch.client import transcribe_stream

    tm = ctc_pair[1]
    server = BatchingASRServer(tm, max_batch=2, batch_window_ms=5.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        seen_rows = []
        orig = tm._decode_batch_submit

        def spy(wavs, *a, **kw):
            seen_rows.append(kw.get("pad_rows_to", 0))
            return orig(wavs, *a, **kw)

        monkeypatch.setattr(tm, "_decode_batch_submit", spy)
        wav = noise(5 * SR, 12)
        events = transcribe_stream(f"http://127.0.0.1:{httpd.server_port}",
                                   wav, chunk_s=1.0)
        assert events and events[-1]["kind"] == "committed"
        assert seen_rows and all(r == 2 for r in seen_rows), seen_rows
        ref = jax_stream_events(ctc_pair[0], _server_pushes(wav, 1.0), rows=2)
        assert [e["text"] for e in events] == [e["text"] for e in ref]
    finally:
        httpd.shutdown()
        server.shutdown()


def test_server_lm_fusion(ctc_pair, monkeypatch):
    """Server-wide LM shallow fusion plumbs into every decode call, and the
    fused beam's text equals the JAX model's."""
    from gigaam_tpu.decode.lm import NGramLM as JaxLM

    jm, tm = ctc_pair
    seqs = [[0, 1, 2]] * 5
    lm = gt.NGramLM.train(seqs, vocab_size=len(tm.tokenizer), order=2)
    server = BatchingASRServer(tm, max_batch=2, batch_window_ms=5.0,
                               beam_size=4, lm=lm, lm_weight=0.3)
    try:
        seen = []
        orig = tm._decode_batch_submit

        def spy(wavs, *a, **kw):
            seen.append((kw.get("beam_size"), kw.get("lm") is not None))
            return orig(wavs, *a, **kw)

        monkeypatch.setattr(tm, "_decode_batch_submit", spy)
        wav = noise(8000, 5)
        req = server.submit(wav, timestamps=False)
        assert req.error is None
        assert seen == [(4, True)], seen
        jlm = JaxLM.train(seqs, vocab_size=len(tm.tokenizer), order=2)
        assert req.result["text"] == jax_texts(jm, [wav], rows=2, beam_size=4,
                                               lm=jlm, lm_weight=0.3)[0]
    finally:
        server.shutdown()


# -- thread safety -------------------------------------------------------------


def test_pos_tables_grow_from_8_threads():
    """8 threads asking for tables of 8 lengths at once (each length past
    the last, so the host table grows while others read) all get the
    values a fresh table gives, and no KeyError."""
    from gigaam_tpu_torch.config import EncoderConfig
    from gigaam_tpu_torch.models.encoder import PosTables

    for kind in ("rotary", "rel_pos"):
        cfg = EncoderConfig(n_layers=1, d_model=64, n_heads=4,
                            pos_emb_max_len=16, self_attention_model=kind)
        lengths = [16 + 37 * i for i in range(8)]
        for _ in range(3):
            tables = PosTables(cfg)
            barrier = threading.Barrier(8)
            got, errors = {}, []

            def grow(t):
                barrier.wait()
                try:
                    for tt in (t, t // 2 + 1, t):
                        got[tt] = (tables.rotary(tt, "cpu") if kind == "rotary"
                                   else tables.relpos(tt, "cpu"))
                except Exception as exc:  # surfaced below
                    errors.append(exc)

            threads = [threading.Thread(target=grow, args=(t,))
                       for t in lengths]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert not errors, errors
            for t, value in got.items():
                fresh = PosTables(cfg)
                want = (fresh.rotary(t, "cpu") if kind == "rotary"
                        else fresh.relpos(t, "cpu"))
                for a, b in zip(value if kind == "rotary" else [value],
                                want if kind == "rotary" else [want]):
                    assert torch.equal(a, b)


def test_full_fp32_nested_across_threads():
    """TF32 stays off while any thread is inside ``full_fp32``, also after
    the first thread to enter has left; the last one out restores it."""
    from gigaam_tpu_torch.ops.precision import full_fp32

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32, cudnn.allow_tf32 = True, True
    a_in, b_in, a_out, b_may_leave = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with full_fp32():
            a_in.set()
            b_in.wait()
        a_out.set()

    def b():
        a_in.wait()
        with full_fp32():
            with full_fp32():                 # nested in one thread too
                b_in.set()
                a_out.wait()
                seen["after_a_left"] = (matmul.allow_tf32, cudnn.allow_tf32)
            seen["inner_closed"] = (matmul.allow_tf32, cudnn.allow_tf32)
            b_may_leave.wait()

    try:
        ta, tb = threading.Thread(target=a), threading.Thread(target=b)
        ta.start()
        tb.start()
        ta.join()
        a_out.wait()
        while "inner_closed" not in seen:
            threading.Event().wait(0.001)
        assert seen["after_a_left"] == (False, False)
        assert seen["inner_closed"] == (False, False)
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
        b_may_leave.set()
        tb.join()
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_decode_and_longform_from_4_threads_equal_serial(ctc_pair, rnnt_pair):
    """Two ``_decode_batch`` and two ``transcribe_longform`` calls at once,
    on a CTC and an RNNT model, equal the same calls made one by one."""
    calls = []
    for i, (_, tm) in enumerate((ctc_pair, rnnt_pair)):
        wavs = [speechy(1.0 + 0.5 * j, 60 + j) for j in range(3)]
        calls.append(lambda tm=tm, wavs=wavs: tm._decode_batch(
            wavs, True, pad_rows_to=4, bucket=BUCKET))
        long_wav = bursts(70 + i, n=3, seconds=8)
        calls.append(lambda tm=tm, w=long_wav: tm.transcribe_longform(
            w, word_timestamps=True, fr_batch_size=2).to_dict())
    serial = [fn() for fn in calls]
    barrier = threading.Barrier(len(calls))
    got = [None] * len(calls)

    def run(i):
        barrier.wait()
        got[i] = calls[i]()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for g, s in zip(got, serial):
        if isinstance(s, dict):
            assert g == s
        else:
            assert [t for t, _ in g] == [t for t, _ in s]
            assert [[w.to_dict() for w in ws] for _, ws in g] == [
                [w.to_dict() for w in ws] for _, ws in s]


# -- the registered ops --------------------------------------------------------


def test_wrappers_reach_the_registered_ops(ctc_pair, monkeypatch):
    """The inference wrappers of K1/K2/K3/K5 call the ``gigaam`` ops; a
    recorded gradient keeps K3 on its autograd function."""
    ops = ("fused_mha", "fused_relpos_mha", "folded_rotary_attention",
           "folded_rotary_attention_lnres")
    for name in ops:
        assert hasattr(torch.ops.gigaam, name)
    seen = []
    real = torch.ops.gigaam.folded_rotary_attention_lnres
    monkeypatch.setattr(torch.ops.gigaam, "folded_rotary_attention_lnres",
                        lambda *a: seen.append(len(a)) or real(*a))
    tm = ctc_pair[1]
    tm._decode_batch([noise(SR, 1), noise(SR, 2)], False)
    # x, cos, sin, valid, the 10 folded tensors, n_heads
    assert seen == [15] * tm.cfg.encoder.n_layers

    q = torch.randn(1, 2, 5, 48, requires_grad=True)
    valid = torch.ones(1, 5, dtype=torch.bool)
    assert fa.fused_mha(q, q, q, valid).grad_fn is not None
    with torch.no_grad():
        assert torch.equal(fa.fused_mha(q, q, q, valid),
                           torch.ops.gigaam.fused_mha(q, q, q, valid))


def test_fold_checks_take_k2s_weights_without_the_layernorm():
    """K2's op rebuilds ``FoldedWeights`` without the LayerNorm's tensors:
    the card path's weight checks accept that set, and K1's refuses it
    before any launch (both checks run on any device)."""
    d, heads = 384, 8
    w = fa.FoldedWeights(
        *(torch.zeros(d, d, dtype=torch.bfloat16) for _ in range(4)),
        *(torch.zeros(d) for _ in range(4)), None, None)
    fa._check_fold_weights(w, d, torch.device("cpu"))
    x = torch.zeros(1, 4, d, dtype=torch.bfloat16)
    cos = sin = torch.zeros(4, 48)
    valid = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="LayerNorm"):
        fa._folded_cuda(w, x, cos, sin, valid, heads, lnres=True)


# -- import boundary -----------------------------------------------------------


def test_new_entry_points_run_without_jax(tmp_path):
    """Export, artifact-only inference, the server, the client and
    streaming in a process that never imports JAX or the JAX package."""
    code = (
        "import sys, os, json, threading, urllib.request\n"
        "import numpy as np\n"
        "import gigaam_tpu_torch as gt\n"
        "from gigaam_tpu_torch.config import EncoderConfig\n"
        "from gigaam_tpu_torch.exported_infer import infer_exported\n"
        "from gigaam_tpu_torch.serve import ASRHTTPServer, BatchingASRServer, "
        "make_handler\n"
        "from gigaam_tpu_torch.client import transcribe_one, "
        "transcribe_stream, health\n"
        "from gigaam_tpu_torch.streaming import stream_file\n"
        "from gigaam_tpu_torch.audio import load_wav_bytes\n"
        "cfg = gt.make_preset('v3_ctc')\n"
        "cfg.encoder = EncoderConfig(n_layers=1, d_model=64, n_heads=4,\n"
        "                            ff_expansion_factor=2)\n"
        "cfg.head.feat_in = 64\n"
        "m = gt.GigaAMASR(cfg, device='cpu')\n"
        f"out = {str(tmp_path / 'art')!r}\n"
        "m.to_exported(out, batch_sizes=(2,), audio_seconds=(1,))\n"
        "wav = (0.1 * np.random.default_rng(0).standard_normal(16000))"
        ".astype(np.float32)\n"
        "h = infer_exported(out, [wav], device='cpu')['hypotheses']\n"
        "print('exported', h == [m._decode_batch([wav], False)[0][0]])\n"
        "srv = BatchingASRServer(m, max_batch=2, batch_window_ms=5.0)\n"
        "httpd = ASRHTTPServer(('127.0.0.1', 0), make_handler(srv))\n"
        "threading.Thread(target=httpd.serve_forever, daemon=True).start()\n"
        "url = f'http://127.0.0.1:{httpd.server_port}'\n"
        "print('health', health(url)['status'])\n"
        "print('served', 'text' in transcribe_one(url, wav))\n"
        "print('stream', transcribe_stream(url, wav)[-1]['kind'])\n"
        "print('streaming', list(stream_file(m, wav))[-1].kind)\n"
        "httpd.shutdown(); srv.shutdown()\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'gigaam_tpu' or n.startswith('gigaam_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    for line in ("exported True", "health ok", "served True",
                 "stream committed", "streaming committed"):
        assert line in out.stdout, out.stdout


# -- on the card -----------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_export_serve.py)")
    from gigaam_tpu_torch.ops import cuda_lib

    cuda_lib.build(names=("attention", "projection", "relpos_attention"))
    return torch.device("cuda")


def _tiny_card_model(kind="v3_ctc"):
    """Two layers at the kernels' width (768 = 16 heads of 48), bf16."""
    from gigaam_tpu_torch.config import EncoderConfig

    cfg = gt.make_preset(kind)
    cfg.encoder = EncoderConfig(n_layers=2, d_model=768, n_heads=16)
    return gt.GigaAMASR(cfg, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,kernel", [(1, "K2"), (2, "K1")])
def test_cuda_exported_graph_equals_live(cuda, tmp_path, batch, kernel):
    """An exported v3_ctc graph on the card launches K1 (batch 2) or K2
    (batch 1) once per layer through the registered ops, and its log-probs
    are bit-equal to the live model's at the same shapes."""
    from gigaam_tpu_torch.exported_infer import ExportedASR

    model = _tiny_card_model()
    out = str(tmp_path / "art")
    model.to_exported(out, batch_sizes=(batch,), audio_seconds=(3,))
    runner = ExportedASR(out)
    wavs = [noise(3 * SR - 4000 * i, 20 + i) for i in range(batch)]
    with torch.inference_mode():
        g, feats, lens = runner._bucketed("ctc", wavs)
        fa.reset_launch_counts()
        lp, enc_lens = g(feats, lens)
        torch.cuda.synchronize()
        launches = (fa.folded_rotary_attention.launches,
                    fa.folded_rotary_attention_lnres.launches)
        dev_batch, dev_lens, _, pos = model._device_batch(wavs, 3 * SR)
        lp_live, lens_live = model._ctc_logprobs(dev_batch, dev_lens, pos)
    assert launches == ((2, 0) if kernel == "K2" else (0, 2))
    assert torch.equal(enc_lens, lens_live)
    assert torch.equal(lp, lp_live)
    assert runner.transcribe_batch(wavs) == [
        t for t, _ in model._decode_batch(wavs, False, bucket=3 * SR)]


@pytest.mark.gpu
def test_cuda_program_exported_on_the_cpu_loads_on_the_card(cuda, tmp_path):
    """A graph exported from a CPU model runs on the card when loaded there
    (its ops take their CUDA bodies: K5 counted)."""
    from gigaam_tpu_torch.config import EncoderConfig

    cfg = gt.make_preset("v2_ctc")
    cfg.encoder = EncoderConfig(n_layers=1, d_model=768, n_heads=16,
                                self_attention_model="rel_pos")
    cpu = gt.GigaAMASR(cfg, device="cpu", seed=4,
                       compute_dtype=torch.bfloat16)
    out = str(tmp_path / "art")
    cpu.to_exported(out, batch_sizes=(1,), audio_seconds=(2,))
    _, graphs = load_exported(out)
    g = graphs["ctc"][0]
    assert g.device.type == "cuda"
    feats = torch.randn(1, g.meta["t_feat"], 64)
    lens = torch.tensor([g.meta["t_feat"]], dtype=torch.int32)
    fa.reset_launch_counts()
    with torch.inference_mode():
        lp, _ = g(feats, lens)
        ref, _ = load_exported(out, device="cpu")[1]["ctc"][0](feats, lens)
    assert fa.fused_relpos_mha.launches == 1
    assert lp.device.type == "cuda"
    # bf16 on both, with other kernels: within the encoder's bf16 class
    assert (lp.float().cpu() - ref.float()).abs().max() < 0.25

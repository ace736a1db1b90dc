"""The port's model API against the JAX package on the CPU in fp32, on the
same random weights: ``transcribe`` (token ids, frames, text, word
timestamps and confidences), a batch of 16 (the K1 dispatch), a 45 s
``encode_batch`` (T' > 1024: the K3 dispatch) and ``embed_audio``; plus the
port's import boundary (no ``jax``, no ``gigaam_tpu``) and ``load_model``'s
refusal to fall back to the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from gigaam_tpu.config import (
    CTCHeadConfig,
    DecodingConfig,
    EncoderConfig,
    FeaturesConfig,
    ModelConfig,
    RU_VOCAB,
)
from gigaam_tpu.decode.ctc_greedy import ctc_extract as jax_ctc_extract
from gigaam_tpu.models.model import GigaAMASR as JaxASR

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.decode.ctc_greedy import ctc_extract

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4


def v3_cfg(d_model=64, n_heads=4):
    v = len(RU_VOCAB)
    return ModelConfig(
        model_name="tiny_v3_ctc", model_class="asr",
        preprocessor=FeaturesConfig(center=False),
        encoder=EncoderConfig(feat_in=64, n_layers=2, d_model=d_model,
                              n_heads=n_heads, ff_expansion_factor=2,
                              conv_kernel_size=7, pos_emb_max_len=256),
        head=CTCHeadConfig(feat_in=d_model, num_classes=v + 1),
        decoding=DecodingConfig(kind="ctc_greedy", vocabulary=list(RU_VOCAB)))


def model_pair(d_model=64, n_heads=4, seed=0):
    jm = JaxASR(v3_cfg(d_model, n_heads), seed=seed)
    tm = gt.GigaAMASR(gt.ModelConfig.from_dict(jm.cfg.to_dict()),
                      state=gt.params_from_jax(
                          jax.tree.map(np.asarray, jm.params)),
                      device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def tiny_pair():
    return model_pair()


def voice(seconds, rng):
    """A tone stack under a syllable-rate envelope, plus noise."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    sig = sum(np.sin(2 * np.pi * 150 * h * t) / h for h in range(1, 5))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t))
    return (0.2 * sig * env + 0.02 * rng.standard_normal(t.shape)).astype(
        np.float32)


def jax_ids_frames(jm, wavs):
    from gigaam_tpu.models.model import pad_wav_batch

    batch, lens = pad_wav_batch(wavs)
    labels, keep, tok_lp, enc_lens = jm._asr_fwd(
        jm.params, *jm._device_batch(batch, lens), jm._pos_for(batch.shape[1]))
    return (jax_ctc_extract(np.asarray(labels), np.asarray(keep)),
            np.asarray(tok_lp), np.asarray(enc_lens))


def port_ids_frames(tm, wavs):
    dev_batch, dev_lens, _, pos = tm._device_batch(wavs)
    with torch.inference_mode():
        labels, keep, tok_lp, enc_lens = tm._ctc_forward(dev_batch, dev_lens,
                                                         pos)
    return (ctc_extract(labels.numpy(), keep.numpy()), tok_lp.numpy(),
            enc_lens.numpy())


def assert_same_words(got, ref):
    assert [w.text for w in got] == [w.text for w in ref]
    np.testing.assert_allclose([w.start for w in got], [w.start for w in ref])
    np.testing.assert_allclose([w.end for w in got], [w.end for w in ref])
    np.testing.assert_allclose([w.confidence for w in got],
                               [w.confidence for w in ref], rtol=1e-4)


@pytest.mark.parametrize("d_model,n_heads", [(64, 4), (192, 4)])
def test_transcribe_matches_jax(d_model, n_heads):
    jm, tm = model_pair(d_model, n_heads, seed=1)
    wav = voice(3.0, np.random.default_rng(0))
    ref = jm.transcribe(wav, word_timestamps=True)
    got = tm.transcribe(wav, word_timestamps=True)
    assert got.text == ref.text
    assert_same_words(got.words, ref.words)
    (ref_pairs, ref_lp, ref_len) = jax_ids_frames(jm, [wav])
    (got_pairs, got_lp, got_len) = port_ids_frames(tm, [wav])
    assert got_pairs == ref_pairs
    np.testing.assert_array_equal(got_len, ref_len)
    np.testing.assert_allclose(got_lp[0, :ref_len[0]], ref_lp[0, :ref_len[0]],
                               atol=ATOL)


def test_decode_batch_of_16_matches_jax(tiny_pair):
    """Batch 16 takes the K1 (LN + residual fold) dispatch in the port."""
    jm, tm = tiny_pair
    rng = np.random.default_rng(1)
    wavs = [voice(s, rng) for s in np.linspace(0.7, 3.2, 16)]
    ref = jm._decode_batch(wavs, word_timestamps=True)
    got = tm._decode_batch(wavs, word_timestamps=True)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for (_, gw), (_, rw) in zip(got, ref):
        assert_same_words(gw, rw)
    assert port_ids_frames(tm, wavs)[0] == jax_ids_frames(jm, wavs)[0]


def test_encode_batch_45s_matches_jax(tiny_pair, monkeypatch):
    """45 s of audio gives T' = 1125 > 1024: the K3 (composed) dispatch."""
    from gigaam_tpu_torch.ops import fused_attention as fa

    calls = []
    plain_k3 = fa.fused_mha
    monkeypatch.setattr(fa, "fused_mha",
                        lambda *a: calls.append(1) or plain_k3(*a))
    jm, tm = tiny_pair
    wav = voice(45.0, np.random.default_rng(2))
    ref, ref_len = jm.encode_batch([wav])
    got, got_len = tm.encode_batch([wav])
    assert len(calls) == tm.cfg.encoder.n_layers
    assert int(got_len[0]) == int(ref_len[0]) == 1125
    np.testing.assert_allclose(got[0, :1125].numpy(), np.asarray(ref)[0, :1125],
                               atol=ATOL)


def test_embed_audio_layouts(tiny_pair):
    jm, tm = tiny_pair
    wav = voice(1.5, np.random.default_rng(3))
    btd, n = tm.embed_audio(wav)
    bdt, _ = tm.embed_audio(wav, layout="bdt")
    ref, _ = jm.embed_audio(wav, layout="bdt")
    assert torch.equal(btd.transpose(1, 2), bdt)
    valid = int(n[0])             # padded frames are garbage by contract
    np.testing.assert_allclose(bdt[..., :valid].numpy(),
                               np.asarray(ref)[..., :valid], atol=ATOL)
    with pytest.raises(ValueError, match="layout"):
        tm.embed_audio(wav, layout="tbd")


def test_cast_encoder_keeps_the_head_and_reprepares_the_folds():
    _, tm = model_pair(seed=4)
    wav = voice(1.0, np.random.default_rng(4))
    ref, n = tm.encode_batch([wav])
    tm.cast_encoder(torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in tm.encoder.parameters())
    assert all(p.dtype == torch.float32 for p in tm.head.parameters())
    got, _ = tm.encode_batch([wav])
    layer = tm.encoder.layers[0]
    wq = layer["self_attn"]["linear_q"]["w"].float() / np.sqrt(16)
    assert torch.equal(layer.folded_weights(torch.float32).wq, wq)
    valid = int(n[0])
    rel = ((got - ref)[0, :valid].norm() / ref[0, :valid].norm()).item()
    assert rel < 0.05                  # bf16-rounded weights, fp32 compute


def test_port_runs_without_jax_or_the_jax_package():
    """A fresh interpreter imports the port, runs CPU forwards of the rotary
    (v3_ctc) and the rel-pos (v2_ctc, emo) models, imports the training CLI
    and takes one CPU train step, and has imported neither
    ``jax`` nor ``gigaam_tpu``."""
    code = (
        "import sys, numpy as np\n"
        "import gigaam_tpu_torch as gt\n"
        "from gigaam_tpu_torch.config import EncoderConfig\n"
        "wav = np.zeros(16000, np.float32)\n"
        "for name in ('v3_ctc', 'v2_ctc', 'emo'):\n"
        "    cfg = gt.make_preset(name)\n"
        "    cfg.encoder = EncoderConfig(\n"
        "        n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2,\n"
        "        self_attention_model=cfg.encoder.self_attention_model)\n"
        "    cfg.head.feat_in = 64\n"
        "    m = gt.model_class_for(cfg)(cfg, device='cpu')\n"
        "    out = m.get_probs(wav) if name == 'emo' else m.transcribe(wav).text\n"
        "    print(name, type(out))\n"
        "from gigaam_tpu_torch.train import train, eval as eval_cli\n"
        "from gigaam_tpu_torch.train.finetune import FineTuner, TrainConfig\n"
        "cfg = gt.make_preset('v2_ctc')\n"
        "cfg.encoder = EncoderConfig(\n"
        "    n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2,\n"
        "    self_attention_model='rel_pos')\n"
        "cfg.head.feat_in = 64\n"
        "ft = FineTuner(gt.GigaAMASR(cfg, device='cpu'),\n"
        "               TrainConfig(precision='fp32'))\n"
        "batch = (wav[None], np.array([16000], np.int32),\n"
        "         np.array([[1, 2, 3]], np.int32), np.array([3], np.int32))\n"
        "print('train step', float(ft.train_step(batch)['loss']) > 0)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'gigaam_tpu' or n.startswith('gigaam_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "v3_ctc <class 'str'>" in out.stdout
    assert "v2_ctc <class 'str'>" in out.stdout
    assert "emo <class 'dict'>" in out.stdout
    assert "train step True" in out.stdout


def test_port_sources_import_neither_jax_nor_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "gigaam_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "gigaam_tpu"), (path, name)


def test_load_model_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.load_model("v3_ctc", init="random")

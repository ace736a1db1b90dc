"""The port's model API against the JAX package on the CPU in fp32, on the
same random weights: ``transcribe`` (token ids, frames, text, word
timestamps and confidences), a batch of 16 (the K1 dispatch), a 45 s
``encode_batch`` (T' = 1125 at batch 1: the K2 dispatch) and ``embed_audio``; plus the
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
    """45 s of audio gives T' = 1125 <= 3000 at batch 1: the K2 (fold)
    dispatch, where the JAX package composes (its fold ends at 1024)."""
    from gigaam_tpu_torch.models import encoder as tenc
    from gigaam_tpu_torch.ops import fused_attention as fa

    calls = []
    for name in ("folded_rotary_attention", "folded_rotary_attention_lnres"):
        fn = getattr(tenc, name)
        monkeypatch.setattr(tenc, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    plain_k3 = fa.fused_mha
    monkeypatch.setattr(fa, "fused_mha",
                        lambda *a: calls.append("fused_mha") or plain_k3(*a))
    jm, tm = tiny_pair
    wav = voice(45.0, np.random.default_rng(2))
    ref, ref_len = jm.encode_batch([wav])
    got, got_len = tm.encode_batch([wav])
    assert calls == ["folded_rotary_attention"] * tm.cfg.encoder.n_layers
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
    and takes one CPU train step, times a CPU call of the SDPA ablation's
    full variant with the port's ``device_timeit``, runs the fold probes and
    the subsampling probe's P1 on the CPU, runs both attention-fold probe
    runners on the CPU at width 96, transcribes with a v3_rnnt model (the
    greedy label loop) and a SentencePiece e2e_rnnt model, encodes and
    decodes with a SentencePiece tokenizer, saves and runs a PyanNet VAD
    artifact, runs ``transcribe_longform`` with the neural and the energy
    VAD, ``align`` and ``align_batch``, trains an n-gram LM, saves and
    reloads it, decodes with the CTC prefix beam and the RNNT beam (with
    the LM as an object, a path, and a dense and a sparse device table), runs
    the eval CLI with its beam and LM flags, loads a reference ``.ckpt``
    (the committed OmegaConf fixture) through ``load_model`` and converts it
    with the converter's entry point, computes an RNNT loss, takes an RNNT
    train step under ``remat_policy="dots"`` and a BEST-RQ step, and has
    imported neither ``jax`` nor ``gigaam_tpu``."""
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
        "import torch\n"
        "from gigaam_tpu_torch.profiling import device_timeit\n"
        "from gigaam_tpu_torch.probes import sdpa_ablation as sa\n"
        "x = torch.zeros(4, 8, 48, dtype=torch.bfloat16)\n"
        "m = torch.ones(1, 1, 8, dtype=torch.int8)\n"
        "print('probe', device_timeit(lambda q: sa.full_sdpa(q, x, x, m),\n"
        "                             [x], k=1, windows=1, reps=1,\n"
        "                             chain=True) > 0)\n"
        "from gigaam_tpu_torch.probes import fold_probes as fp\n"
        "fp.D, fp.DFF = 64, 256\n"
        "for probe in fp.PROBES:\n"
        "    r = fp.run(2, 8, 1, probe, device='cpu')\n"
        "    print('fold', probe, r[fp.FOLD_KEY[probe]] > 0)\n"
        "from gigaam_tpu_torch.probes import subsampling_probe as ssp\n"
        "ssp.D, ssp.CALLS = 64, 1\n"
        "r = ssp.probe_taps(2, True, device='cpu')\n"
        "print('subsampling', r['us'] > 0 and r['library_us'] > 0)\n"
        "from gigaam_tpu_torch.probes import attn_fold_probes as afp\n"
        "afp.D, afp.H, afp.DH, afp.CALLS = 96, 2, 48, 1\n"
        "r = afp.run(2, 16, device='cpu')\n"
        "print('attn fold', r['foldA_us'] > 0 and r['foldC_nb2_us'] > 0)\n"
        "r = afp.run_lnres(2, 16, 2, device='cpu')\n"
        "print('attn lnres', r['foldLN_us'] > 0 and r['K1_us'] > 0)\n"
        "import os, tempfile\n"
        "from gigaam_tpu_torch.decode.tokenizer import Tokenizer, write_sp_model\n"
        "sp = os.path.join(tempfile.mkdtemp(), 'sp.model')\n"
        "pieces = [('<unk>', 0.0, 2), ('\u2581', -2.0, 1)] + [\n"
        "    (c, -1.0, 1) for c in 'абвгд'] + [('\u2581аб', -0.5, 1)]\n"
        "write_sp_model(sp, pieces)\n"
        "tok = Tokenizer([], sp)\n"
        "print('sp', tok.decode(tok.encode('аб вг')))\n"
        "for name in ('v3_rnnt', 'v3_e2e_rnnt'):\n"
        "    cfg = gt.make_preset(name)\n"
        "    cfg.encoder = EncoderConfig(\n"
        "        n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2)\n"
        "    cfg.head.joint.enc_hidden = 64\n"
        "    if name == 'v3_e2e_rnnt':\n"
        "        cfg.decoding.model_path = sp\n"
        "        cfg.head.decoder.num_classes = len(pieces) + 1\n"
        "        cfg.head.joint.num_classes = len(pieces) + 1\n"
        "    m = gt.model_class_for(cfg)(cfg, device='cpu')\n"
        "    print(name, type(m.transcribe(wav).text), m.rnnt.host_reads > 0)\n"
        "from gigaam_tpu_torch import vad\n"
        "from gigaam_tpu_torch.models.vad_net import (\n"
        "    PyanNet, VADNetConfig, init_vad_state, load_vad_regions_fn,\n"
        "    save_vad)\n"
        "vcfg = VADNetConfig(sinc_filters=8, sinc_kernel=31, conv_channels=6,\n"
        "                    lstm_hidden=8, lstm_layers=1, linear_hidden=8,\n"
        "                    linear_layers=1, window_s=0.5, step_s=0.25)\n"
        "art = os.path.join(tempfile.mkdtemp(), 'vad_segmentation')\n"
        "save_vad(art, PyanNet(vcfg, init_vad_state(vcfg)))\n"
        "tone = 0.3 * np.sin(np.arange(3 * 16000) / 5.0).astype(np.float32)\n"
        "long = np.concatenate([tone, np.zeros(16000, np.float32)] * 10)\n"
        "regions = load_vad_regions_fn(art, device='cpu')(long)\n"
        "print('vad', isinstance(regions, list),\n"
        "      len(vad.segment_audio_file(long)[0]) > 1)\n"
        "cfg = gt.make_preset('v3_ctc')\n"
        "cfg.encoder = EncoderConfig(\n"
        "    n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2)\n"
        "cfg.head.feat_in = 64\n"
        "m = gt.GigaAMASR(cfg, device='cpu')\n"
        "os.environ['GIGAAM_VAD_ARTIFACT'] = art + '.npz'\n"
        "r = m.transcribe_longform(long, fr_batch_size=2, word_timestamps=True)\n"
        "print('longform neural', type(r).__name__)\n"
        "os.environ['GIGAAM_VAD_ARTIFACT'] = 'energy'\n"
        "r = m.transcribe_longform(long, fr_batch_size=2)\n"
        "print('longform energy', len(r.segments) > 1)\n"
        "print('align', type(m.align(tone, 'аб')).__name__,\n"
        "      len(m.align_batch([tone, tone[:16000]], ['а', 'б'])))\n"
        "lm = gt.train_lm_from_texts(['привет мир', 'мир'], m.tokenizer)\n"
        "lm_path = os.path.join(tempfile.mkdtemp(), 'lm.npz')\n"
        "lm.save(lm_path)\n"
        "print('ctc beam', type(m.transcribe(wav, beam_size=4, lm=lm_path)\n"
        "      .text), len(m.transcribe_longform(long, fr_batch_size=2,\n"
        "                                        beam_size=2).segments) > 1)\n"
        "from gigaam_tpu_torch.decode.rnnt_beam import (\n"
        "    lm_device_table, rnnt_beam_decode)\n"
        "cfg = gt.make_preset('v3_rnnt')\n"
        "cfg.encoder = EncoderConfig(\n"
        "    n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2)\n"
        "cfg.head.joint.enc_hidden = 64\n"
        "r = gt.GigaAMASR(cfg, device='cpu')\n"
        "out = r._decode_batch([wav, wav[:8000]], True, beam_size=4,\n"
        "                      lm=gt.NGramLM.load(lm_path), lm_weight=0.3)\n"
        "enc, lens = r.encode_batch([wav])\n"
        "for sparse in (False, True):\n"
        "    table, base, ctx = lm_device_table(lm, 'cpu', sparse=sparse)\n"
        "    rnnt_beam_decode(r.head, enc, lens, beam_size=2, lm_table=table,\n"
        "                     lm_base=base, lm_ctx_len=ctx)\n"
        "print('rnnt beam', len(out), r.rnnt_beam.host_reads > 0)\n"
        "import contextlib, io\n"
        "from gigaam_tpu_torch.audio import save_wav\n"
        "from gigaam_tpu_torch.data import write_manifest\n"
        "from gigaam_tpu_torch.weights import save_model\n"
        "root = tempfile.mkdtemp()\n"
        "save_model(m, os.path.join(root, 'tiny'))\n"
        "save_wav(os.path.join(root, 'a.wav'), tone[:16000])\n"
        "write_manifest(os.path.join(root, 'm.tsv'), [('a.wav', 1.0, 'аб')])\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    eval_cli.main(['--model_name', os.path.join(root, 'tiny.npz'),\n"
        "                   '--device', 'cpu', '--manifest',\n"
        "                   os.path.join(root, 'm.tsv'), '--beam_size', '2',\n"
        "                   '--lm', lm_path, '--out',\n"
        "                   os.path.join(root, 'p.jsonl')])\n"
        "print('eval beam', os.path.isfile(os.path.join(root, 'p.jsonl')))\n"
        "from gigaam_tpu_torch import checkpoint as ck\n"
        "fixture = os.path.join('tests', 'data', 'ref_cfg_omegaconf.ckpt')\n"
        "m = gt.load_model(fixture, device='cpu')\n"
        "print('ckpt', type(m.transcribe(wav).text).__name__,\n"
        "      ck.config_from_reference is not None)\n"
        "from gigaam_tpu_torch.tools import convert_checkpoint, convert_vad\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    convert_checkpoint.main([fixture, '--out',\n"
        "                             os.path.join(root, 'conv')])\n"
        "print('convert', os.path.isfile(os.path.join(root, 'conv.npz')),\n"
        "      callable(convert_vad.main))\n"
        "from gigaam_tpu_torch.ops.rnnt_loss import rnnt_loss\n"
        "enc, lens = r.encode_batch([wav])\n"
        "with torch.inference_mode():\n"
        "    loss = rnnt_loss(r.head, enc.float(), torch.tensor([[1, 2]]),\n"
        "                     lens, torch.tensor([2]), r.blank_id)\n"
        "print('rnnt loss', bool(torch.isfinite(loss)))\n"
        "cfg = gt.make_preset('v3_rnnt')\n"
        "cfg.encoder = EncoderConfig(\n"
        "    n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2)\n"
        "cfg.head.joint.enc_hidden = 64\n"
        "ft = FineTuner(gt.GigaAMASR(cfg, device='cpu'), TrainConfig(\n"
        "    precision='fp32', activation_checkpointing=True,\n"
        "    remat_policy='dots'))\n"
        "print('rnnt step', float(ft.train_step(batch)['loss']) > 0)\n"
        "from gigaam_tpu_torch.train.pretrain import (\n"
        "    PretrainConfig, SSLPretrainer)\n"
        "cfg = gt.make_preset('v3_ssl')\n"
        "cfg.encoder = EncoderConfig(\n"
        "    n_layers=1, d_model=64, n_heads=4, ff_expansion_factor=2)\n"
        "pt = SSLPretrainer(gt.GigaAM(cfg, device='cpu'), PretrainConfig(\n"
        "    precision='fp32', codebook_size=64, mask_prob=0.3))\n"
        "print('ssl step', float(pt.train_step(batch[:2])['loss']) > 0)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'gigaam_tpu' or n.startswith('gigaam_tpu.')]\n"
        "assert not bad, bad\n")
    # one intra-op thread: beside other test workers, torch's default of
    # one thread a core oversubscribed the host and took most of the limit
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert "v3_ctc <class 'str'>" in out.stdout
    assert "v2_ctc <class 'str'>" in out.stdout
    assert "emo <class 'dict'>" in out.stdout
    assert "train step True" in out.stdout
    assert "probe True" in out.stdout
    assert "fold ffn True" in out.stdout
    assert "fold conv True" in out.stdout
    assert "subsampling True" in out.stdout
    assert "attn fold True" in out.stdout
    assert "attn lnres True" in out.stdout
    assert "sp аб вг" in out.stdout
    assert "v3_rnnt <class 'str'> True" in out.stdout
    assert "v3_e2e_rnnt <class 'str'> True" in out.stdout
    assert "vad True True" in out.stdout
    assert "longform neural LongformTranscriptionResult" in out.stdout
    assert "longform energy True" in out.stdout
    assert "align TranscriptionResult 2" in out.stdout
    assert "ctc beam <class 'str'> True" in out.stdout
    assert "rnnt beam 2 True" in out.stdout
    assert "eval beam True" in out.stdout
    assert "ckpt str True" in out.stdout
    assert "convert True True" in out.stdout
    assert "rnnt loss True" in out.stdout
    assert "rnnt step True" in out.stdout
    assert "ssl step True" in out.stdout


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """Every Python source of the port (and ``chip_smoke.py``) imports
    neither JAX nor the JAX package nor ``benchmarks`` (and the LM and the
    CTC prefix beam not even torch); every CUDA source
    includes only system headers and the port's own ``csrc`` headers."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    cuda = []
    for root, _, files in os.walk(os.path.join(REPO, "gigaam_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
        cuda += [os.path.join(root, f) for f in files
                 if f.endswith((".cu", ".cuh"))]
    rel = {os.path.relpath(p, REPO) for p in paths + cuda}
    assert {"gigaam_tpu_torch/probes/attn_fold_probes.py",
            "gigaam_tpu_torch/csrc/attn_fold_probe.cu",
            "gigaam_tpu_torch/csrc/subsampling_ws.cu",
            "gigaam_tpu_torch/csrc/conv_ws.cuh",
            "gigaam_tpu_torch/csrc/sdpa_groups_ws.cu",
            "gigaam_tpu_torch/csrc/ffn_ws.cu",
            "gigaam_tpu_torch/csrc/attn_fold_ws.cu",
            "gigaam_tpu_torch/csrc/attn_fold_ws.cuh",
            "gigaam_tpu_torch/csrc/attn_lnres_ws.cu",
            "gigaam_tpu_torch/csrc/conv_fold_ws.cu",
            "gigaam_tpu_torch/csrc/sdpa_walk.cuh",
            "gigaam_tpu_torch/csrc/sdpa_heads_ws.cu",
            "gigaam_tpu_torch/csrc/sdpa_heads_walk.cuh",
            "gigaam_tpu_torch/csrc/sdpa_packed_heads_ws.cu",
            "gigaam_tpu_torch/csrc/smem_probe_ws.cu",
            "gigaam_tpu_torch/probes/ws_plan.py",
            "gigaam_tpu_torch/csrc/projection.cuh",
            "gigaam_tpu_torch/ops/lstm.py",
            "gigaam_tpu_torch/decode/rnnt_greedy.py",
            "gigaam_tpu_torch/decode/tokenizer.py",
            "gigaam_tpu_torch/decode/lm.py",
            "gigaam_tpu_torch/decode/ctc_beam.py",
            "gigaam_tpu_torch/decode/rnnt_beam.py",
            "gigaam_tpu_torch/checkpoint.py",
            "gigaam_tpu_torch/ops/rnnt_loss.py",
            "gigaam_tpu_torch/train/pretrain.py",
            "gigaam_tpu_torch/tools/convert_checkpoint.py",
            "gigaam_tpu_torch/tools/convert_vad.py",
            "gigaam_tpu_torch/tools/sass_compare.py",
            "gigaam_tpu_torch/ops/custom_ops.py",
            "gigaam_tpu_torch/export.py",
            "gigaam_tpu_torch/exported_infer.py",
            "gigaam_tpu_torch/serve.py",
            "gigaam_tpu_torch/streaming.py",
            "gigaam_tpu_torch/client.py",
            "gigaam_tpu_torch/parallel/collectives.py",
            "gigaam_tpu_torch/parallel/distributed.py",
            "gigaam_tpu_torch/parallel/mesh.py",
            "gigaam_tpu_torch/tools/train_lm.py",
            "gigaam_tpu_torch/tools/export_hf_dataset.py",
            "gigaam_tpu_torch/tools/run_parity.py",
            "gigaam_tpu_torch/examples/common.py",
            "gigaam_tpu_torch/examples/quickstart.py",
            "gigaam_tpu_torch/examples/serving.py",
            "gigaam_tpu_torch/examples/streaming.py"} <= rel
    for path in cuda:
        with open(path) as f:
            for line in f:
                if line.startswith("#include"):
                    name = line.split()[1]
                    assert name.startswith("<") or os.path.isfile(
                        os.path.join(os.path.dirname(path),
                                     name.strip('"'))), (path, line)
                    assert "gigaam_tpu/" not in name and "jax" not in name
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
                assert top not in ("jax", "jaxlib", "gigaam_tpu",
                                   "benchmarks"), (path, name)
                # the LM and the CTC prefix beam are host numpy
                if path.endswith(("decode/lm.py", "decode/ctc_beam.py")):
                    assert top != "torch", (path, name)


def test_load_model_without_device_raises_on_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.load_model("v3_ctc", init="random")

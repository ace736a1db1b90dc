"""The rel-pos RNNT and SSL family (v1_rnnt, v2_rnnt, v1_ssl, v2_ssl) and
RNNT longform at a beam, in the port against the JAX package on the CPU in
fp32, at tiny widths (2 layers, 4 heads of 16 or 2 of 48), from the same
numpy-seeded inputs and bridged weights.  K5 and K6 run as their plain
versions (the tensors lie on the CPU); the JAX package's rel-pos attention
runs its Pallas kernels in interpret mode, as its own tests run them.  The
``pos_bias_u``/``pos_bias_v`` leaves, zero in a fresh init, are drawn apart
(``with_pos_biases``), so that a swap of the two shows.

* a. ``FineTuner`` on a rel-pos encoder with the RNNT head: every gradient
  of one step within 1e-4 of its leaf's largest entry, the positional
  leaves' nonzero; three optimizer steps without remat and under ``"dots"``
  (the positional product among the saved ones; loss and grad_norm at
  rtol 1e-4, the parameters after within 4 lr, 0.1 lr where the gradient
  is firm).  These run the bodies of
  ``test_finetuner_gradients_match_jax`` and
  ``test_optimizer_steps_match_jax`` (``tests/test_torch_training.py``) on
  this configuration, whose tolerances say why.
* b. BEST-RQ on a rel-pos encoder with the JAX trainer's quantizer, head,
  starts and noise injected: loss at rtol 1e-4, accuracy equal, every
  gradient within 1e-4 of its leaf's largest entry, through the body of
  ``test_loss_accuracy_and_gradients_match_jax``
  (``tests/test_torch_pretrain.py``).
* c. ``transcribe`` and ``_decode_batch`` of a rel-pos RNNT model, with a
  char vocabulary and with a SentencePiece model, at beam 4 with and
  without an n-gram LM (``_decode_batch`` greedy too): texts equal, word
  times equal, word confidences at rtol 1e-5 (``assert_same_words``).
* d. ``transcribe_longform`` of a rotary RNNT model at beam 4: segments,
  texts and words as ``assert_same_longform`` holds them (times at 1e-6 s,
  confidences at rtol 1e-4).

The tests marked ``gpu`` count the kernels' launches of these paths on the
card at full width with 2 layers; they skip without a card.  JAX is imported
inside the CPU tests only (``pytest --noconftest -m gpu
tests/test_torch_relpos_rnnt.py`` on the card's host, which has no JAX).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.ops import fused_attention as fa

# the char LM's texts and the fusion's knobs
LM_TEXTS = ["привет мир", "мир вам", "привет всем вам", "в мире"]
LM_KW = dict(lm_weight=0.3, token_bonus=1.0)
BEAM = 4


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    import gigaam_tpu
    from gigaam_tpu import config as jcfg
    from gigaam_tpu.config import ModelConfig as JaxModelConfig
    from gigaam_tpu.models.model import GigaAM, GigaAMASR
    from gigaam_tpu.train import pretrain as jpre

    # the namespace test_torch_pretrain's helpers take, and the config module
    return types.SimpleNamespace(jax=jax, jnp=jnp, pkg=gigaam_tpu,
                                 GigaAM=GigaAM, ASR=GigaAMASR, pre=jpre,
                                 ModelConfig=JaxModelConfig, cfg=jcfg)


# ---------------------------------------------------------------------------
# a. FineTuner: rel-pos encoder, RNNT loss
# ---------------------------------------------------------------------------

def relpos_rnnt_train_cfg(tiny_cfg):
    """``tiny_cfg("rnnt")`` (a 2-layer predictor, joint 48 wide) on a
    rel-pos encoder with v2's centred frames."""
    cfg = tiny_cfg("rnnt")
    return dataclasses.replace(
        cfg, model_name="tiny_rel_pos_rnnt",
        preprocessor=dataclasses.replace(cfg.preprocessor, center=True),
        encoder=dataclasses.replace(cfg.encoder,
                                    self_attention_model="rel_pos"))


@pytest.fixture
def training(monkeypatch, jx):
    """``tests/test_torch_training.py`` with its ``"rel_pos"`` model made
    the rel-pos RNNT one (``model_pair`` then draws its pos biases) and
    STEP_CASES holding it under remat ``"dots"``."""
    import test_torch_training as tt

    inner = tt.tiny_cfg
    monkeypatch.setattr(tt, "tiny_cfg", lambda kind: (
        relpos_rnnt_train_cfg(inner) if kind == "rel_pos" else inner(kind)))
    monkeypatch.setitem(tt.STEP_CASES, "relpos_rnnt_dots", (
        "rel_pos", {"activation_checkpointing": True,
                    "remat_policy": "dots"}))
    cfg = tt.tiny_cfg("rel_pos")
    assert cfg.encoder.self_attention_model == "rel_pos"
    assert cfg.decoding.kind == "rnnt_greedy" and cfg.preprocessor.center
    return tt


def test_relpos_rnnt_finetuner_gradients_match_jax(training):
    training.test_finetuner_gradients_match_jax("rel_pos")


@pytest.mark.parametrize("case", ["rel_pos", "relpos_rnnt_dots"])
def test_relpos_rnnt_optimizer_steps_match_jax(training, case):
    training.test_optimizer_steps_match_jax(case)


# ---------------------------------------------------------------------------
# b. BEST-RQ on a rel-pos encoder
# ---------------------------------------------------------------------------

@pytest.fixture
def pretraining(monkeypatch, jx):
    """``tests/test_torch_pretrain.py`` with ``tiny_ssl_cfg`` on a rel-pos
    encoder and ``pair`` drawing the pos biases into both trainers; the
    port's trainers it made are kept in ``made``."""
    import test_torch_pretrain as tp
    from test_torch_relpos import with_pos_biases

    inner_cfg, inner_pair = tp.tiny_ssl_cfg, tp.pair
    made = []

    def relpos_cfg():
        cfg = inner_cfg()
        return dataclasses.replace(cfg, model_name="tiny_rel_pos_ssl",
                                   encoder=dataclasses.replace(
                                       cfg.encoder,
                                       self_attention_model="rel_pos"))

    def relpos_pair(jx, seed=0, **pc):
        jpt, tpt = inner_pair(jx, seed, **pc)
        with_pos_biases(jpt.params, seed + 7)
        attn = jpt.params["encoder"]["layers"]["self_attn"]
        with torch.no_grad():
            for i, layer in enumerate(tpt.model.encoder.layers):
                for name in ("pos_bias_u", "pos_bias_v"):
                    layer["self_attn"][name].copy_(torch.from_numpy(
                        np.array(attn[name][i])))
        made.append(tpt)
        return jpt, tpt

    monkeypatch.setattr(tp, "tiny_ssl_cfg", relpos_cfg)
    monkeypatch.setattr(tp, "pair", relpos_pair)
    return types.SimpleNamespace(tp=tp, made=made)


@pytest.mark.parametrize("train", [True, False])
def test_relpos_bestrq_loss_and_gradients_match_jax(pretraining, jx, train):
    pretraining.tp.test_loss_accuracy_and_gradients_match_jax(jx, train)
    (tpt,) = pretraining.made
    assert tpt.model.cfg.encoder.self_attention_model == "rel_pos"
    if not train:
        return
    # the gradients held to JAX's reach the positional leaves
    named = dict(tpt._named_parameters())
    for i in range(len(tpt.model.encoder.layers)):
        attn = f"encoder.layers.{i}.self_attn."
        gu, gv, gp = (named[attn + n].grad for n in (
            "pos_bias_u", "pos_bias_v", "linear_pos.w"))
        assert float(gu.abs().max()) > 0 and float(gv.abs().max()) > 0
        assert float(gp.abs().max()) > 0 and not torch.equal(gu, gv)


# ---------------------------------------------------------------------------
# c. Rel-pos RNNT transcription: greedy and beam, char and SentencePiece
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_path(tmp_path_factory):
    from test_torch_tokenizer import sp_pieces

    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    path = str(tmp_path_factory.mktemp("sp") / "tiny.model")
    write_sp_model(path, sp_pieces())
    return path


@pytest.fixture(scope="module", params=["char", "sp"])
def relpos_pair(request, jx, sp_path):
    """A tiny rel-pos RNNT model in both packages (2 heads of 48, the
    joint shaped as ``test_torch_rnnt.shape_joint`` shapes it), its pos
    biases drawn apart: a char vocabulary, or v1_rnnt's SentencePiece
    kind."""
    from test_torch_relpos import with_pos_biases
    from test_torch_rnnt import rnnt_model_cfg, shape_joint
    from test_torch_tokenizer import sp_pieces

    if request.param == "char":
        cfg = rnnt_model_cfg(jx.cfg, attention="rel_pos")
        boundary = [0]                       # the space
    else:
        pieces = sp_pieces()
        boundary = [i for i, (p, _, kind) in enumerate(pieces)
                    if kind == 1 and p.startswith("▁")]
        cfg = rnnt_model_cfg(jx.cfg, attention="rel_pos", vocab=[],
                             sp_path=sp_path, classes=len(pieces) + 1)
    jm = jx.ASR(cfg, seed=1)
    shape_joint(jm, boundary)
    jm.params = with_pos_biases(jm.params, 4)
    tm = gt.GigaAMASR(gt.ModelConfig.from_dict(jm.cfg.to_dict()),
                      state=gt.params_from_jax(jm.params), device="cpu")
    return jm, tm


def lms_of(pair, order=3):
    """The same LM in both packages, over the model's tokenizer."""
    from gigaam_tpu.decode.lm import train_lm_from_texts as jax_train

    jm, tm = pair
    return (gt.train_lm_from_texts(LM_TEXTS, tm.tokenizer, order=order),
            jax_train(LM_TEXTS, jm.tokenizer, order=order))


def decode_kwargs(pair, mode):
    """(the port's keywords, the JAX package's) of a decode ``mode``:
    greedy, beam 4, beam 4 with the LM."""
    if mode == "greedy":
        return {}, {}
    if mode == "beam":
        return dict(beam_size=BEAM), dict(beam_size=BEAM)
    ours, ref = lms_of(pair)
    return (dict(beam_size=BEAM, lm=ours, **LM_KW),
            dict(beam_size=BEAM, lm=ref, **LM_KW))


def voice(seconds, rng):
    from test_torch_rnnt import voice as make

    return make(seconds, rng)


def assert_same(got, ref):
    from test_torch_rnnt import assert_same_words

    assert [g for g, _ in got] == [r for r, _ in ref]
    for (_, gw), (_, rw) in zip(got, ref):
        assert_same_words(gw, rw)


@pytest.mark.parametrize("mode", ["beam", "beam_lm"])
def test_relpos_rnnt_transcribe_matches_jax(relpos_pair, mode):
    jm, tm = relpos_pair
    assert tm.cfg.encoder.self_attention_model == "rel_pos"
    ours, ref = decode_kwargs(relpos_pair, mode)
    wav = voice(2.0, np.random.default_rng(31))
    got = tm.transcribe(wav, word_timestamps=True, **ours)
    want = jm.transcribe(wav, word_timestamps=True, **ref)
    assert_same([(got.text, got.words)], [(want.text, want.words)])
    assert len(got.words) >= 1


@pytest.mark.parametrize("mode", ["greedy", "beam", "beam_lm"])
def test_relpos_rnnt_decode_batch_matches_jax(relpos_pair, mode):
    """A batch of 4 ragged clips; at a beam the beam's loop ran (its host
    reads counted, no graph on the CPU)."""
    jm, tm = relpos_pair
    ours, ref = decode_kwargs(relpos_pair, mode)
    rng = np.random.default_rng(32)
    wavs = [voice(s, rng) for s in (0.6, 1.7, 1.1, 2.3)]
    want = jm._decode_batch(wavs, True, **ref)
    dec = tm.rnnt_beam if mode != "greedy" else tm.rnnt
    reads = dec.host_reads
    got = tm._decode_batch(wavs, True, **ours)
    assert_same(got, want)
    assert sum(len(w) for _, w in got) > 4
    assert dec.host_reads > reads and dec.replays == 0


def test_lm_spans_the_tokenizer(relpos_pair):
    """The LM spans the model's vocabulary, characters or SentencePiece
    pieces (the joint's width less the blank), and the beam's device table
    is built for it."""
    jm, tm = relpos_pair
    ours, ref = lms_of(relpos_pair)
    assert ours.vocab_size == ref.vocab_size == len(tm.tokenizer)
    assert len(tm.tokenizer) == tm.blank_id == jm.blank_id
    lm, spec = tm._resolve_lm(ours)
    assert lm is ours and spec is not None


# ---------------------------------------------------------------------------
# d. RNNT longform at beam 4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rotary_rnnt_pair(jx):
    from test_torch_rnnt import rnnt_pair

    return rnnt_pair(jx)


def test_rnnt_longform_at_beam_4_matches_jax(rotary_rnnt_pair):
    from test_torch_longform import (POLICY, assert_same_longform,
                                     longform_audio)

    jm, tm = rotary_rnnt_pair
    wav = longform_audio(24.0, seed=13)
    kw = dict(word_timestamps=True, fr_batch_size=2, beam_size=BEAM,
              **POLICY)
    reads = tm.rnnt_beam.host_reads
    got = tm.transcribe_longform(wav, **kw)
    assert_same_longform(got, jm.transcribe_longform(wav, **kw))
    assert len(got.segments) > 2 and sum(len(s.words) for s in got) > 3
    assert tm.rnnt_beam.host_reads > reads


# ---------------------------------------------------------------------------
# e. On the card: launch counts at full width, 2 layers
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_relpos_rnnt.py)")
    return torch.device("cuda")


def two_layers(name):
    cfg = gt.make_preset(name)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))


def launches():
    return {"K1": fa.folded_rotary_attention_lnres.launches,
            "K2": fa.folded_rotary_attention.launches,
            "K3": fa.fused_mha.launches,
            "K5": fa.fused_relpos_mha.launches,
            "K4": fa.mha_bwd.launches,
            "K6": fa.relpos_mha_bwd.launches}


def only(**want):
    return {k: want.get(k, 0) for k in launches()}


def card_voice(seconds, seed):
    return voice(seconds, np.random.default_rng(seed))


@pytest.mark.gpu
@pytest.mark.parametrize("beam_size", [1, BEAM])
def test_cuda_v2_rnnt_decodes_through_k5(cuda, beam_size):
    """``transcribe`` and ``_decode_batch`` of 4: K5 once a layer a call,
    greedy and at beam 4."""
    model = gt.GigaAMASR(two_layers("v2_rnnt"), device=cuda, seed=0)
    wavs = [card_voice(s, i) for i, s in enumerate((2.0, 1.0, 3.0, 1.5))]
    for call in (lambda: model.transcribe(wavs[0], beam_size=beam_size),
                 lambda: model._decode_batch(wavs, True,
                                             beam_size=beam_size)):
        fa.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        assert launches() == only(K5=2)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", [None, "full"])
def test_cuda_v2_rnnt_train_step_launches(cuda, policy):
    """A v2_rnnt train step in bf16: K5 forward and K6 backward once a
    layer; under ``"full"`` K5 runs again in the recomputation."""
    from gigaam_tpu_torch.train import finetune as tft

    model = gt.GigaAMASR(two_layers("v2_rnnt"), device=cuda, seed=0)
    ft = tft.FineTuner(model, tft.TrainConfig(
        total_steps=4, precision="bf16",
        activation_checkpointing=policy is not None,
        remat_policy=policy or "full"))
    lens = np.array([32000, 20000], np.int32)
    wavs = np.stack([card_voice(2.0, 5), card_voice(2.0, 6)])
    wavs[1, lens[1]:] = 0.0
    tokens = np.random.default_rng(7).integers(0, 33, (2, 12)).astype(
        np.int32)
    batch = (wavs, lens, tokens, np.array([12, 7], np.int32))
    for _ in range(2):
        fa.reset_launch_counts()
        m = ft.train_step(batch)
        assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
        assert launches() == only(K5=4 if policy else 2, K6=2)


@pytest.mark.gpu
def test_cuda_v2_ssl_train_step_launches(cuda):
    """A v2_ssl BEST-RQ step: K5 forward, K6 backward once a layer; the
    quantizer never moves."""
    from gigaam_tpu_torch.train import pretrain as tpre

    pt = tpre.SSLPretrainer(gt.GigaAM(two_layers("v2_ssl"), device=cuda,
                                      seed=0),
                            tpre.PretrainConfig(total_steps=4))
    q0 = pt.quantizer["codebook"].clone()
    wavs = np.stack([card_voice(3.0, s) for s in range(4)])
    batch = (wavs, np.full((4,), wavs.shape[1], np.int32))
    for _ in range(2):
        fa.reset_launch_counts()
        m = pt.train_step(batch)
        assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
        assert launches() == only(K5=2, K6=2)
    assert torch.equal(pt.quantizer["codebook"], q0)


@pytest.mark.gpu
def test_cuda_rnnt_longform_at_beam_4_runs_k1(cuda):
    """v3_rnnt ``transcribe_longform`` at beam 4: K1 once a layer a chunk
    batch, and each chunk's text that of ``_decode_batch`` of its batch."""
    from gigaam_tpu_torch.vad import segment_audio_file

    model = gt.GigaAMASR(two_layers("v3_rnnt"), device=cuda, seed=0)
    rng = np.random.default_rng(8)
    parts = []
    for _ in range(8):
        parts += [voice(rng.uniform(3.0, 8.0), rng),
                  (1e-4 * rng.standard_normal(16000)).astype(np.float32)]
    wav = np.concatenate(parts)
    kw = dict(max_duration=8.0, min_duration=5.0)
    fa.reset_launch_counts()
    res = model.transcribe_longform(wav, fr_batch_size=4, beam_size=BEAM,
                                    **kw)
    torch.cuda.synchronize()
    batches = -(-len(res.segments) // 4)
    assert batches >= 2 and launches() == only(K1=2 * batches)
    segments, _ = segment_audio_file(wav, 16000, **kw)
    texts = []
    for i in range(0, len(segments), 4):
        texts += [t for t, _ in model._decode_batch(
            segments[i:i + 4], False, beam_size=BEAM, pad_rows_to=4)]
    assert [s.text for s in res.segments] == texts

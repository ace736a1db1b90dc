"""The port's RNNT path against the JAX package on the CPU in fp32, on the
same weights (``params_from_jax``) and inputs drawn with
``numpy.random.default_rng``:

* ``ops/lstm.py`` and the RNNT head functions, within 1e-5 (the same fp32
  math, summed in another order);
* ``init_rnnt_head``'s distributions;
* ``rnnt_greedy_decode``: tokens, frames and counts equal and log-probs
  within 1e-5, at ragged lengths (one sample at 0), ``max_symbols`` 1, 2
  and 10 with the cap hit, a ``max_tokens`` that binds, with and without
  log-probs, for chunk lengths 1, 7 and 64; the host reads per call;
* ``transcribe`` and ``_decode_batch`` of a tiny rotary RNNT model and of a
  v1_rnnt-style rel-pos model with a SentencePiece tokenizer: text and
  word timestamps equal to the JAX ``GigaAMASR``'s.

The tests marked ``gpu`` hold the CUDA-graph decode to the eager loop on
the card, bit for bit, and check that a weight update reaches the graphs;
they skip without a card.  JAX is imported inside the CPU tests only, so
that the card's host, which has no JAX, runs them with
``pytest --noconftest -m gpu tests/test_torch_rnnt.py``.
"""

import math
import types

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.config import (
    RNNTDecoderConfig,
    RNNTHeadConfig,
    RNNTJointConfig,
)
from gigaam_tpu_torch.decode.rnnt_greedy import (
    RNNTGreedyDecoder,
    rnnt_greedy_decode,
    trip_count,
    weights_stamp,
)
from gigaam_tpu_torch.models import heads
from gigaam_tpu_torch.ops import lstm
from gigaam_tpu_torch.weights import sub_block_from_jax

# fp32 on both sides; the products and sums run in another order
ATOL = 1e-5
CHUNKS = [1, 7, 64]


def head_cfg(hidden=32, layers=2, classes=11, enc=24, joint=40):
    return RNNTHeadConfig(
        decoder=RNNTDecoderConfig(pred_hidden=hidden, pred_rnn_layers=layers,
                                  num_classes=classes),
        joint=RNNTJointConfig(enc_hidden=enc, pred_hidden=hidden,
                              joint_hidden=joint, num_classes=classes))


@pytest.fixture(scope="module")
def jx():
    import jax

    from gigaam_tpu import config as jcfg
    from gigaam_tpu.decode import rnnt_greedy as jdec
    from gigaam_tpu.models import heads as jheads
    from gigaam_tpu.ops import lstm as jlstm

    cfg = jcfg.RNNTHeadConfig(
        decoder=jcfg.RNNTDecoderConfig(**vars(head_cfg().decoder)),
        joint=jcfg.RNNTJointConfig(**vars(head_cfg().joint)))
    params = jax.tree.map(np.asarray,
                          jheads.init_rnnt_head(jax.random.PRNGKey(0), cfg))
    return types.SimpleNamespace(jax=jax, heads=jheads, lstm=jlstm,
                                 dec=jdec, cfg=jcfg, params=params)


def port_head(jax_head):
    """The port's head from a JAX head tree (through the weights bridge)."""
    return sub_block_from_jax(jax_head)


def with_bias(head, token, value):
    """The JAX head tree with ``value`` added to the joint's output bias at
    ``token``."""
    out = {**head, "joint": {**head["joint"]}}
    b = head["joint"]["out"]["b"].copy()
    b[token] += value
    out["joint"]["out"] = {**head["joint"]["out"], "b": b}
    return out


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_lstm_matches_jax(jx):
    rng = np.random.default_rng(0)
    layers = jx.params["decoder"]["lstm"]
    ours = port_head(jx.params)["decoder"]["lstm"]
    x = rng.standard_normal((3, 32)).astype(np.float32)
    h = rng.standard_normal((2, 3, 32)).astype(np.float32)
    c = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ref = jx.lstm.lstm_cell(layers[0], x, h[0], c[0])
    got = lstm.lstm_cell(ours[0], t(x), t(h[0]), t(c[0]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    ref = jx.lstm.lstm_step_stacked(layers, x, h, c)
    got = lstm.lstm_step_stacked(ours, t(x), t(h), t(c))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    xs = rng.standard_normal((3, 9, 32)).astype(np.float32)
    ref = jx.lstm.lstm_sequence(layers, xs, h, c)
    got = lstm.lstm_sequence(ours, t(xs), t(h), t(c))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


HEAD_FUNCTIONS = ["rnnt_predict_step", "rnnt_predict_sequence",
                  "rnnt_joint_step", "rnnt_joint_enc_proj",
                  "rnnt_joint_step_preproj", "rnnt_joint_logits"]


@pytest.mark.parametrize("name", HEAD_FUNCTIONS)
def test_head_function_matches_jax(jx, name):
    rng = np.random.default_rng(1)
    labels = np.array([10, 3, 0], np.int32)          # blank, two tokens
    h = rng.standard_normal((2, 3, 32)).astype(np.float32)
    c = rng.standard_normal((2, 3, 32)).astype(np.float32)
    enc = rng.standard_normal((3, 5, 24)).astype(np.float32)
    pred = rng.standard_normal((3, 32)).astype(np.float32)
    args = {
        "rnnt_predict_step": (labels, h, c),
        "rnnt_predict_sequence": (rng.integers(0, 10, (3, 4)).astype(
            np.int32),),
        "rnnt_joint_step": (enc[:, 0], pred),
        "rnnt_joint_enc_proj": (enc,),
        "rnnt_joint_step_preproj": (rng.standard_normal((3, 40)).astype(
            np.float32), pred),
        "rnnt_joint_logits": (enc, rng.standard_normal((3, 4, 32)).astype(
            np.float32)),
    }[name]
    ref = getattr(jx.heads, name)(jx.params, *args)
    got = getattr(heads, name)(port_head(jx.params),
                               *(t(a).long() if a.dtype == np.int32 else t(a)
                                 for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(np.shape(r))
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_init_rnnt_head_distributions():
    cfg = head_cfg(hidden=320, layers=2, classes=34, enc=768, joint=320)
    p = heads.init_rnnt_head(torch.Generator().manual_seed(0), cfg)
    embed = p["decoder"]["embed"]
    assert torch.equal(embed[33], torch.zeros(320))     # padding_idx row
    assert abs(float(embed[:33].std()) - 1.0) < 0.05     # N(0, 1)
    bound = 1.0 / math.sqrt(320)
    for layer in p["decoder"]["lstm"]:
        for name in ("w_ih", "w_hh"):
            assert float(layer[name].abs().max()) <= bound
            # U(-b, b): variance b^2 / 3
            assert abs(float(layer[name].var()) / (bound ** 2 / 3) - 1) < 0.05
    b = torch.cat([layer["b"] for layer in p["decoder"]["lstm"]])
    # the sum of two U(-b, b): variance 2 b^2 / 3 (one U(-2b, 2b) draw
    # would give 4 b^2 / 3), support [-2b, 2b]
    assert abs(float(b.var()) / (2 * bound ** 2 / 3) - 1) < 0.1
    assert float(b.abs().max()) <= 2 * bound
    for name, d_in in (("enc", 768), ("pred", 320), ("out", 320)):
        w = p["joint"][name]["w"]
        assert float(w.abs().max()) <= 1.0 / math.sqrt(d_in)
    assert p["joint"]["out"]["w"].shape == (320, 34)


# (name, enc_len, max_symbols, max_tokens, bias (token, value) or None)
DECODE_CASES = [
    ("ragged", [17, 9, 0, 3], 10, 0, None),
    ("sym1", [17, 17, 12, 5], 1, 0, (4, 3.0)),
    ("sym2", [17, 17, 12, 5], 2, 0, (4, 3.0)),
    ("sym10", [17, 17, 12, 5], 10, 0, (4, 3.0)),
    ("u_cap", [17, 9, 0, 3], 10, 6, None),
    ("blank_leaning", [17, 14, 1, 8], 3, 0, (10, 1.0)),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in
                                                    DECODE_CASES])
@pytest.mark.parametrize("with_logps", [True, False])
def test_greedy_decode_matches_jax(jx, case, with_logps):
    name, lens, max_symbols, max_tokens, bias = case
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((len(lens), 17, 24)).astype(np.float32)
    lens = np.array(lens, np.int32)
    head = jx.params if bias is None else with_bias(jx.params, *bias)
    ref = [np.asarray(r) for r in jx.dec.rnnt_greedy_decode(
        head, enc, lens, max_symbols=max_symbols, max_tokens=max_tokens,
        with_logps=with_logps)]
    ours = port_head(head)
    for chunk in CHUNKS:
        got = [g.numpy() for g in rnnt_greedy_decode(
            ours, t(enc), t(lens), max_symbols=max_symbols,
            max_tokens=max_tokens, with_logps=with_logps, chunk=chunk)]
        assert len(got) == len(ref) == (4 if with_logps else 3)
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g, r)
        if with_logps:
            np.testing.assert_allclose(got[3], ref[3], atol=ATOL)
    tokens, frames, counts = ref[:3]
    if name == "ragged":
        assert counts[2] == 0
    if bias is not None and bias[0] != 10:      # the symbol cap is hit
        assert any((np.bincount(frames[i, :counts[i]]) == max_symbols).any()
                   for i in range(len(lens)))
    if name == "u_cap":
        assert counts.max() == max_tokens


@pytest.mark.parametrize("chunk", CHUNKS)
def test_host_reads_per_call(jx, chunk):
    """One host read per chunk: ceil(steps / chunk), at least one, where
    the steps are the JAX loop's trip count (at chunk 1, exactly it)."""
    rng = np.random.default_rng(3)
    enc = t(rng.standard_normal((4, 17, 24)).astype(np.float32))
    ours = port_head(with_bias(jx.params, 4, 3.0))
    for lens, max_symbols in (([17, 9, 0, 3], 2), ([0, 0, 0, 0], 10),
                              ([17, 17, 17, 17], 10)):
        dec = RNNTGreedyDecoder()
        tokens, frames, counts = dec.decode(ours, enc, t(np.array(lens)),
                                            max_symbols=max_symbols,
                                            chunk=chunk)
        steps = trip_count(frames.numpy(), counts.numpy(), np.array(lens),
                           max_symbols, 17)
        assert dec.host_reads == max(1, math.ceil(steps / chunk))
        assert dec.eager_chunks == dec.host_reads and dec.replays == 0
        if chunk == 1:
            assert dec.host_reads == max(1, steps)


def test_weights_stamp_sees_updates_and_casts(jx):
    from gigaam_tpu_torch.models.encoder import as_module

    module = as_module(port_head(jx.params))
    before = weights_stamp(module)
    assert weights_stamp(module) == before
    with torch.no_grad():
        module["joint"]["out"]["b"][3] += 1.0
    after = weights_stamp(module)
    assert after != before
    module["decoder"]["lstm"][1]["w_hh"].data = (
        module["decoder"]["lstm"][1]["w_hh"].data.clone())
    assert weights_stamp(module) != after
    assert len(before) == 1 + 2 * 3 + 3 * 2    # embed, 2 LSTM layers, joint


# ---------------------------------------------------------------------------
# The model: tiny rotary RNNT, and v1_rnnt-style rel-pos with SentencePiece
# ---------------------------------------------------------------------------

def rnnt_model_cfg(cfgmod, attention="rotary", vocab=None, sp_path=None,
                   classes=None):
    """2 encoder layers at width 96 (2 heads of 48), a 2-layer predictor."""
    v = classes or len(cfgmod.RU_VOCAB) + 1
    return cfgmod.ModelConfig(
        model_name=f"tiny_{attention}_rnnt", model_class="asr",
        preprocessor=cfgmod.FeaturesConfig(center=attention != "rotary"),
        encoder=cfgmod.EncoderConfig(
            feat_in=64, n_layers=2, d_model=96, n_heads=2,
            ff_expansion_factor=2, conv_kernel_size=7, pos_emb_max_len=256,
            self_attention_model=attention),
        head=cfgmod.RNNTHeadConfig(
            decoder=cfgmod.RNNTDecoderConfig(pred_hidden=32,
                                             pred_rnn_layers=2,
                                             num_classes=v),
            joint=cfgmod.RNNTJointConfig(enc_hidden=96, pred_hidden=32,
                                         joint_hidden=48, num_classes=v)),
        decoding=cfgmod.DecodingConfig(
            kind="rnnt_greedy",
            vocabulary=(list(cfgmod.RU_VOCAB) if vocab is None else vocab),
            model_path=sp_path))


def shape_joint(jm, boundary_ids):
    """A random joint emits one token, mostly regardless of the input.  So
    that the texts hold words: the encoder side x8 (the frames steer), the
    output weights centred over the joint's width, x3, the output bias zero
    but blank +3 and the word-boundary tokens +8."""
    import jax.numpy as jnp

    joint = jm.params["head"]["joint"]
    joint["enc"]["w"] = joint["enc"]["w"] * 8.0
    w = np.asarray(joint["out"]["w"])
    joint["out"]["w"] = jnp.asarray(3.0 * (w - w.mean(axis=0)))
    b = np.zeros(w.shape[1], np.float32)
    b[-1], b[boundary_ids] = 3.0, 8.0
    joint["out"]["b"] = jnp.asarray(b)


def rnnt_pair(jx, boundary_ids=(0,), **kw):
    from gigaam_tpu.models.model import GigaAMASR as JaxASR

    jm = JaxASR(rnnt_model_cfg(jx.cfg, **kw), seed=0)
    shape_joint(jm, list(boundary_ids))
    tm = gt.GigaAMASR(gt.ModelConfig.from_dict(jm.cfg.to_dict()),
                      state=gt.params_from_jax(jm.params), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def sp_path(tmp_path_factory):
    from test_torch_tokenizer import sp_pieces

    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    path = str(tmp_path_factory.mktemp("sp") / "tiny.model")
    write_sp_model(path, sp_pieces())
    return path


@pytest.fixture(scope="module", params=["rotary", "rel_pos_sp"])
def model_pair(request, jx, sp_path):
    if request.param == "rotary":
        return rnnt_pair(jx)
    from test_torch_tokenizer import sp_pieces

    pieces = sp_pieces()
    words = [i for i, (p, _, kind) in enumerate(pieces)
             if kind == 1 and p.startswith("▁")]
    return rnnt_pair(jx, words, attention="rel_pos", vocab=[],
                     sp_path=sp_path, classes=len(pieces) + 1)


def voice(seconds, rng):
    tt = np.arange(int(seconds * 16000)) / 16000.0
    sig = sum(np.sin(2 * np.pi * 150 * h * tt) / h for h in range(1, 5))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * tt))
    return (0.2 * sig * env + 0.02 * rng.standard_normal(tt.shape)).astype(
        np.float32)


def assert_same_words(got, ref):
    assert [w.text for w in got] == [w.text for w in ref]
    np.testing.assert_allclose([w.start for w in got], [w.start for w in ref])
    np.testing.assert_allclose([w.end for w in got], [w.end for w in ref])
    # exp(mean logp): relative ATOL
    np.testing.assert_allclose([w.confidence for w in got],
                               [w.confidence for w in ref], rtol=ATOL)


def test_transcribe_matches_jax(model_pair):
    jm, tm = model_pair
    assert tm.blank_id == jm.blank_id == len(tm.tokenizer)
    wav = voice(2.0, np.random.default_rng(4))
    ref = jm.transcribe(wav, word_timestamps=True)
    got = tm.transcribe(wav, word_timestamps=True)
    assert got.text == ref.text
    assert_same_words(got.words, ref.words)
    assert len(got.words) > 2
    assert tm.rnnt.host_reads >= 1 and tm.rnnt.replays == 0


def test_decode_batch_matches_jax(model_pair):
    """A batch of 5 ragged clips (K1's dispatch in the port) and the token
    log-probs of the one transfer."""
    jm, tm = model_pair
    rng = np.random.default_rng(5)
    wavs = [voice(s, rng) for s in (0.4, 1.3, 2.2, 0.9, 1.7)]
    ref = jm._decode_batch(wavs, word_timestamps=True)
    got = tm._decode_batch(wavs, word_timestamps=True)
    assert [g for g, _ in got] == [r for r, _ in ref]
    for (_, gw), (_, rw) in zip(got, ref):
        assert_same_words(gw, rw)
    assert sum(len(w) for _, w in got) > 10


def test_decode_log_probs_match_jax(model_pair):
    """The per-token log-probs that ``_decode_batch`` reads, against the JAX
    decode of the JAX encoder's output, within ATOL."""
    from gigaam_tpu.decode.rnnt_greedy import rnnt_greedy_decode as jax_dec

    jm, tm = model_pair
    rng = np.random.default_rng(6)
    wavs = [voice(s, rng) for s in (1.1, 2.0)]
    enc_j, len_j = jm.encode_batch(wavs)
    ref = jax_dec(jm.params["head"], enc_j, len_j, max_symbols=10,
                  with_logps=True)
    enc_t, len_t = tm.encode_batch(wavs)
    got = tm.rnnt.decode(tm.head, enc_t, len_t, max_symbols=10,
                         with_logps=True)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=ATOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest --noconftest -m gpu tests/test_torch_rnnt.py)")
    return torch.device("cuda")


def card_head(cuda, seed=0):
    from gigaam_tpu_torch.models.encoder import as_module

    cfg = head_cfg(hidden=320, layers=1, classes=34, enc=768, joint=320)
    return as_module(heads.init_rnnt_head(
        torch.Generator().manual_seed(seed), cfg)).to(cuda)


def card_inputs(cuda, b=4, tt=120):
    gen = torch.Generator().manual_seed(1)
    enc = torch.randn(b, tt, 768, generator=gen).to(cuda, torch.bfloat16)
    lens = torch.tensor([tt, tt - 17, 0, 33][:b], device=cuda)
    return enc, lens


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7, 32])
def test_graph_decode_is_the_eager_loop_bit_for_bit(cuda, chunk):
    head = card_head(cuda)
    enc, lens = card_inputs(cuda)
    dec = RNNTGreedyDecoder()
    eager = dec.decode_eager(head, enc, lens, max_symbols=3, with_logps=True,
                             chunk=chunk)
    for _ in range(2):                   # capture, then a replay of it
        got = dec.decode(head, enc, lens, max_symbols=3, with_logps=True,
                         chunk=chunk)
        for g, e in zip(got, eager):
            assert torch.equal(g, e)
    assert dec.captures == 1 and dec.replays == 2 * dec.eager_chunks
    assert int(got[2].sum()) > 0


@pytest.mark.gpu
def test_graph_decode_sees_a_weight_update(cuda):
    head = card_head(cuda)
    enc, lens = card_inputs(cuda)
    dec = RNNTGreedyDecoder()
    before = dec.decode(head, enc, lens, with_logps=True)
    with torch.no_grad():
        head["joint"]["out"]["b"][33] += 1e4     # blank everywhere
    after = dec.decode(head, enc, lens, with_logps=True)
    assert dec.captures == 2
    assert int(before[2].sum()) > 0 and int(after[2].sum()) == 0
    for g, e in zip(after, dec.decode_eager(head, enc, lens,
                                            with_logps=True)):
        assert torch.equal(g, e)

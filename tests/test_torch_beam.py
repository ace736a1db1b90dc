"""The port's beam decoders against the JAX package's, on the CPU in fp32,
on the same weights (``params_from_jax``) and inputs drawn with
``numpy.random.default_rng``:

* ``top_k``: values and indices equal to ``jax.lax.top_k`` on pools full of
  exact ties (the lower index first);
* ``ctc_prefix_beam`` and ``ctc_beam_batch``: identical ids and frames,
  without and with an LM, at ``lm_weight`` 0, with a ``token_bonus``, with
  a binding ``merge_cap``;
* ``rnnt_beam_decode``: tokens, frames and counts equal, log-probs within
  1e-5, for K 1, 2 and 4 without an LM and with a dense and a sparse one,
  at chunk lengths 1, 7 and 64; the expansions and host reads per call;
  ``max_tokens``; ``lm_weight`` 0 equal to the plain beam; dense equal to
  sparse; K 1 equal to the greedy decoder.  Before comparing, each case
  checks that its decisions are not near ties: in every pool of the
  port's eager run (whose decisions the comparison then holds to JAX's),
  the gap between the K-th and the (K+1)-th score exceeds MARGIN, so a
  mismatch is a defect and not a rounding flip;
* ``transcribe`` and ``_decode_batch`` at ``beam_size`` 4 with an LM, of a
  tiny CTC and a tiny RNNT model: texts and word timestamps equal to the
  JAX ``GigaAMASR``'s; ``transcribe_longform`` with a beam; the eval CLI's
  beam and LM flags.

The tests marked ``gpu`` hold the beam's CUDA graphs to its eager loop on
the card, bit for bit, and check that a retrained LM and a weight update
reach the graphs; they skip without a card.  JAX is imported inside the
CPU tests only (``pytest --noconftest -m gpu tests/test_torch_beam.py`` on
the card's host, which has no JAX).
"""

import json
import math
import types

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.decode import rnnt_beam
from gigaam_tpu_torch.decode.ctc_beam import ctc_beam_batch, ctc_prefix_beam
from gigaam_tpu_torch.decode.lm import NGramLM
from gigaam_tpu_torch.decode.rnnt_beam import (
    NEG_INF,
    RNNTBeamDecoder,
    lm_device_table,
    rnnt_beam_decode,
)
from gigaam_tpu_torch.decode.rnnt_greedy import rnnt_greedy_decode
from test_torch_rnnt import card_head, card_inputs, head_cfg, port_head, t

# fp32 on both sides; the products and sums run in another order
ATOL = 1e-5
CHUNKS = [1, 7, 64]
# the smallest score gap a compared decision may have
MARGIN = 1e-4
LM_WEIGHT, TOKEN_BONUS = 0.5, 0.5


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from gigaam_tpu import config as jcfg
    from gigaam_tpu.decode import ctc_beam, lm, rnnt_beam as jbeam
    from gigaam_tpu.models import heads as jheads

    cfg = jcfg.RNNTHeadConfig(
        decoder=jcfg.RNNTDecoderConfig(**vars(head_cfg().decoder)),
        joint=jcfg.RNNTJointConfig(**vars(head_cfg().joint)))
    params = jax.tree.map(np.asarray,
                          jheads.init_rnnt_head(jax.random.PRNGKey(0), cfg))
    return types.SimpleNamespace(jax=jax, jnp=jnp, beam=jbeam, lm=lm,
                                 ctc_beam=ctc_beam, params=params,
                                 head=shaped(params))


def shaped(head):
    """A random joint emits one token whatever its input.  So that the
    frames steer the decisions and their scores lie apart (few near ties,
    see MARGIN): the encoder side x4, the predictor side x2, the output
    weights centred over the joint's width and x4, the output bias zero
    but blank +4."""
    j = head["joint"]
    w = j["out"]["w"]
    b = np.zeros(w.shape[1], np.float32)
    b[-1] = 4.0
    return {**head, "joint": {
        "enc": {**j["enc"], "w": j["enc"]["w"] * 4.0},
        "pred": {**j["pred"], "w": j["pred"]["w"] * 2.0},
        "out": {"w": 4.0 * (w - w.mean(axis=0)), "b": b}}}


def corpus(v, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, v, size=rng.integers(3, 12)).tolist()
            for _ in range(n)]


def lm_pair(jx, v, order=3):
    seqs = corpus(v)
    return (NGramLM.train(seqs, vocab_size=v, order=order),
            jx.lm.NGramLM.train(seqs, vocab_size=v, order=order))


# ---------------------------------------------------------------------------
# The selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4, 8])
def test_top_k_orders_ties_as_lax_top_k(jx, k):
    """Pools like the beam's: many exact ties among real scores, dead
    entries at -1e30 (and -1e30 + x, which rounds back to -1e30)."""
    rng = np.random.default_rng(k)
    pool = rng.choice(np.float32([0.0, -1.0, -2.5, -1.0, NEG_INF]),
                      size=(6, 45))
    pool[:, ::3] = np.float32(NEG_INF) + rng.standard_normal(
        (6, 15)).astype(np.float32)
    pool[0] = 0.0                                   # one row all tied
    values, idx = rnnt_beam.top_k(t(pool), k)
    ref_values, ref_idx = jx.jax.lax.top_k(pool, k)
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert idx[0].tolist() == list(range(k))


# ---------------------------------------------------------------------------
# The CTC prefix beam (host numpy in both packages)
# ---------------------------------------------------------------------------

def posteriors(t_max, v, seed, peaky):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t_max, v)) * (1.0 if peaky else 2.0)
    if peaky:           # one dominant symbol a frame, blank most often
        hot = rng.integers(0, v, t_max)
        hot[rng.random(t_max) < 0.6] = v - 1
        logits[np.arange(t_max), hot] += 6.0
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


# (name, lm order or None, lm_weight, token_bonus)
CTC_CASES = [("plain", None, 0.5, 0.0), ("lm", 3, 0.5, 0.0),
             ("lm_weight_0", 3, 0.0, 0.0), ("bonus", 2, 0.3, 1.0),
             ("penalty", 3, 0.8, -1.5)]


@pytest.mark.parametrize("case", CTC_CASES, ids=[c[0] for c in CTC_CASES])
def test_ctc_prefix_beam_matches_jax(jx, case):
    _, order, weight, bonus = case
    for v, t_max, peaky, length in ((12, 20, False, None), (40, 60, True, 47)):
        lp = posteriors(t_max, v, seed=v, peaky=peaky)
        ours = ref = None
        if order is not None:
            ours, ref = lm_pair(jx, v - 1, order)
        kw = dict(beam_size=8, lm_weight=weight, token_bonus=bonus)
        got = ctc_prefix_beam(lp, length, lm=ours, **kw)
        want = jx.ctc_beam.ctc_prefix_beam(lp, length, lm=ref, **kw)
        assert got == want
        assert len(got[0]) == len(got[1]) > 0
    if order is not None and weight == 0.0:
        assert got == ctc_prefix_beam(lp, length, beam_size=8)


def test_ctc_beam_batch_matches_jax(jx):
    lp = np.stack([posteriors(30, 34, seed=s, peaky=True) for s in range(3)])
    lens = np.array([30, 12, 0])
    ours, ref = lm_pair(jx, 33, 2)
    got = ctc_beam_batch(lp, lens, beam_size=4, lm=ours, lm_weight=0.4,
                         token_bonus=0.2)
    want = jx.ctc_beam.ctc_beam_batch(lp, lens, beam_size=4, lm=ref,
                                      lm_weight=0.4, token_bonus=0.2)
    assert got == want and got[2] == ([], [])
    # merge_cap binds at V 34, K 8 (128 cells against 32) without an LM
    for cap in (4, 10 ** 9):
        assert ctc_prefix_beam(lp[0], merge_cap=cap) == \
            jx.ctc_beam.ctc_prefix_beam(lp[0], merge_cap=cap)


# ---------------------------------------------------------------------------
# The RNNT beam
# ---------------------------------------------------------------------------

def rnnt_inputs(seed=2):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((4, 17, 24)).astype(np.float32)
    return enc, np.array([17, 9, 0, 3], np.int32)


def lm_kwargs(jx, kind, weight=LM_WEIGHT, bonus=TOKEN_BONUS):
    """(port kwargs, JAX kwargs) of ``rnnt_beam_decode`` for an LM over the
    head's 10 labels: None, "dense" or "sparse"."""
    if kind is None:
        return {}, {}
    ours, ref = lm_pair(jx, 10)
    table, base, ctx_len = lm_device_table(ours, "cpu",
                                           sparse=kind == "sparse")
    ref_table = (jx.jnp.asarray(ref.dense_table()) if kind == "dense" else
                 jx.jax.tree.map(jx.jnp.asarray, ref.sparse_table()))
    common = dict(lm_base=base, lm_ctx_len=ctx_len, lm_weight=weight,
                  token_bonus=bonus)
    return dict(lm_table=table, **common), dict(lm_table=ref_table, **common)


def smallest_gap(run, k):
    """``run()`` with ``rnnt_beam.top_k`` recording, for every pool, the gap
    between its k-th and (k+1)-th score where the latter is not dead
    (-1e30); returns (run's result, the smallest gap, the pools)."""
    gaps = []
    inner = rnnt_beam.top_k

    def recording(pool, kk):
        best = torch.sort(pool, dim=-1, descending=True).values[:, :kk + 1]
        live = best[:, kk] > NEG_INF / 2
        gap = (best[:, kk - 1] - best[:, kk])[live]
        gaps.append(float(gap.min()) if gap.numel() else math.inf)
        return inner(pool, kk)

    rnnt_beam.top_k = recording
    try:
        out = run()
    finally:
        rnnt_beam.top_k = inner
    return out, min(gaps), len(gaps)


@pytest.mark.parametrize("lm_kind", [None, "dense", "sparse"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_rnnt_beam_matches_jax(jx, k, lm_kind):
    enc, lens = rnnt_inputs()
    ours_kw, ref_kw = lm_kwargs(jx, lm_kind)
    ref = [np.asarray(r) for r in jx.beam.rnnt_beam_decode(
        jx.head, enc, lens, beam_size=k, with_logps=True, **ref_kw)]
    head = port_head(jx.head)
    dec = RNNTBeamDecoder()
    # at chunk 1 every step is an expansion: one pool each
    _, gap, pools = smallest_gap(lambda: dec.decode(
        head, t(enc), t(lens), beam_size=k, with_logps=True, chunk=1,
        **({} if lm_kind is None else dict(
            lm=(ours_kw["lm_table"], ours_kw["lm_base"],
                ours_kw["lm_ctx_len"]), lm_weight=LM_WEIGHT,
            token_bonus=TOKEN_BONUS))), k)
    assert gap > MARGIN, f"a decision within {gap} of a tie"
    assert dec.last_expansions() == pools > int(lens.max())
    for chunk in CHUNKS:
        dec = RNNTBeamDecoder()
        got = [g.numpy() for g in dec.decode(
            head, t(enc), t(lens), beam_size=k, with_logps=True,
            chunk=chunk, **({} if lm_kind is None else dict(
                lm=(ours_kw["lm_table"], ours_kw["lm_base"],
                    ours_kw["lm_ctx_len"]), lm_weight=LM_WEIGHT,
                token_bonus=TOKEN_BONUS)))]
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(got[3], ref[3], atol=ATOL)
        assert dec.host_reads == dec.eager_chunks == math.ceil(pools / chunk)
        assert dec.last_expansions() == pools
    counts = ref[2]
    assert counts[2] == 0 and counts.sum() > 0
    assert (counts < 17 * 10).all()       # under the symbol cap


def test_rnnt_beam_function_matches_jax_with_max_tokens(jx):
    enc, lens = rnnt_inputs(seed=3)
    ours_kw, ref_kw = lm_kwargs(jx, "dense", weight=0.3, bonus=0.2)
    ref = [np.asarray(r) for r in jx.beam.rnnt_beam_decode(
        jx.head, enc, lens, beam_size=2, max_tokens=6, **ref_kw)]
    got = [g.numpy() for g in rnnt_beam_decode(
        port_head(jx.head), t(enc), t(lens), beam_size=2, max_tokens=6,
        **ours_kw)]
    assert len(got) == len(ref) == 3 and got[0].shape == (4, 6)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert ref[2].max() == 6


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_lm_weight_zero_is_the_plain_beam(jx, kind):
    enc, lens = rnnt_inputs()
    head = port_head(jx.head)
    plain = rnnt_beam_decode(head, t(enc), t(lens), beam_size=4,
                             with_logps=True)
    ours_kw, _ = lm_kwargs(jx, kind, weight=0.0, bonus=0.0)
    fused = rnnt_beam_decode(head, t(enc), t(lens), beam_size=4,
                             with_logps=True, **ours_kw)
    for a, b in zip(plain, fused):
        assert torch.equal(a, b)


def test_sparse_table_beam_equals_dense(jx):
    enc, lens = rnnt_inputs(seed=4)
    head = port_head(jx.head)
    outs = [rnnt_beam_decode(head, t(enc), t(lens), beam_size=4,
                             with_logps=True, **lm_kwargs(jx, kind)[0])
            for kind in ("dense", "sparse")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][2].sum()) > 0


@pytest.mark.parametrize("head_kind", ["shaped", "scaled_input"])
def test_beam_size_1_is_the_greedy_decoder(jx, head_kind):
    """At K 1 every selection is the argmax over {blank} and the labels:
    the greedy decisions, wherever no exact tie breaks them apart (the
    greedy argmax prefers a label, the pool blank).  Inputs: the shaped
    head, and the drawn head with its input scaled x2."""
    enc, lens = rnnt_inputs(seed=5)
    params = jx.head if head_kind == "shaped" else jx.params
    if head_kind == "scaled_input":
        enc = enc * 2.0
    head = port_head(params)
    (beam, gap, _) = smallest_gap(lambda: rnnt_beam_decode(
        head, t(enc), t(lens), beam_size=1, with_logps=True, chunk=1), 1)
    assert gap > MARGIN
    greedy = rnnt_greedy_decode(head, t(enc), t(lens), with_logps=True)
    for a, b in zip(beam[:3], greedy[:3]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(beam[3].numpy(), greedy[3].numpy(), atol=ATOL)
    assert int(beam[2].sum()) > 0


def test_lm_table_without_its_base_raises(jx):
    enc, lens = rnnt_inputs()
    with pytest.raises(ValueError, match="lm_base"):
        rnnt_beam_decode(port_head(jx.head), t(enc), t(lens),
                         lm_table=torch.zeros(11, 10))


# ---------------------------------------------------------------------------
# The model: transcribe, _decode_batch, transcribe_longform, eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rnnt_pair():
    from gigaam_tpu import config as jcfg
    from test_torch_rnnt import rnnt_pair as make

    return make(types.SimpleNamespace(cfg=jcfg))


@pytest.fixture(scope="module")
def ctc_pair():
    from gigaam_tpu.models.model import GigaAMASR as JaxASR
    from test_torch_longform import ctc_cfg, port_of

    jm = JaxASR(ctc_cfg(), seed=5)
    return jm, port_of(jm)


def lm_of(model_pair, order=3):
    """The same char LM in both packages, over the model's tokenizer."""
    from gigaam_tpu.decode.lm import train_lm_from_texts as jax_train

    jm, tm = model_pair
    texts = ["привет мир", "мир вам", "привет всем вам", "в мире"]
    return (gt.train_lm_from_texts(texts, tm.tokenizer, order=order),
            jax_train(texts, jm.tokenizer, order=order))


def voice(seconds, rng):
    from test_torch_rnnt import voice as make

    return make(seconds, rng)


def assert_same(got, ref):
    from test_torch_rnnt import assert_same_words

    assert [g for g, _ in got] == [r for r, _ in ref]
    for (_, gw), (_, rw) in zip(got, ref):
        assert_same_words(gw, rw)


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_transcribe_with_beam_and_lm_matches_jax(kind, ctc_pair, rnnt_pair):
    jm, tm = ctc_pair if kind == "ctc" else rnnt_pair
    ours, ref = lm_of((jm, tm))
    wav = voice(2.0, np.random.default_rng(21))
    for kw_ours, kw_ref in ((dict(beam_size=4), dict(beam_size=4)),
                            (dict(beam_size=4, lm=ours, lm_weight=0.3,
                                  token_bonus=1.0),
                             dict(beam_size=4, lm=ref, lm_weight=0.3,
                                  token_bonus=1.0))):
        got = tm.transcribe(wav, word_timestamps=True, **kw_ours)
        want = jm.transcribe(wav, word_timestamps=True, **kw_ref)
        assert_same([(got.text, got.words)], [(want.text, want.words)])
        assert len(got.words) >= 1
    with pytest.raises(ValueError, match="beam_size"):
        tm.transcribe(wav, lm=ours)


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_decode_batch_with_beam_and_lm_matches_jax(kind, ctc_pair, rnnt_pair,
                                                   tmp_path):
    """A batch of 4 ragged clips, the LM from an npz path, through
    ``_decode_batch`` and ``_decode_batch_submit``; for RNNT the beam's
    loop ran (its host reads counted), for CTC the host beam."""
    jm, tm = ctc_pair if kind == "ctc" else rnnt_pair
    ours, _ = lm_of((jm, tm))
    path = str(tmp_path / "lm.npz")
    ours.save(path)
    rng = np.random.default_rng(22)
    wavs = [voice(s, rng) for s in (0.6, 1.7, 1.1, 2.3)]
    kw = dict(beam_size=4, lm=path, lm_weight=0.3, token_bonus=1.0)
    want = jm._decode_batch(wavs, True, **kw)
    if tm.rnnt_beam is not None:
        reads = tm.rnnt_beam.host_reads
    got = tm._decode_batch(wavs, True, **kw)
    assert_same(got, want)
    assert sum(len(w) for _, w in got) > 4
    assert_same(tm._decode_batch_submit(wavs, True, pad_rows_to=6, **kw)(),
                want)
    if tm.rnnt_beam is not None:
        assert tm.rnnt_beam.host_reads > reads
        assert tm.rnnt_beam.replays == 0


def test_transcribe_longform_with_beam_matches_jax(ctc_pair):
    from test_torch_longform import POLICY, assert_same_longform, \
        longform_audio

    jm, tm = ctc_pair
    wav = longform_audio(30.0, seed=12)
    kw = dict(word_timestamps=True, fr_batch_size=2, beam_size=3, **POLICY)
    assert_same_longform(tm.transcribe_longform(wav, **kw),
                         jm.transcribe_longform(wav, **kw))


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_eval_cli_beam_and_lm_flags(kind, ctc_pair, rnnt_pair, tmp_path,
                                    capsys):
    from gigaam_tpu_torch import data as tdata
    from gigaam_tpu_torch.audio import save_wav
    from gigaam_tpu_torch.train import eval as eval_cli
    from gigaam_tpu_torch.weights import save_model

    jm, tm = ctc_pair if kind == "ctc" else rnnt_pair
    save_model(tm, str(tmp_path / "tiny"))
    ours, _ = lm_of((jm, tm), order=2)
    ours.save(str(tmp_path / "lm.npz"))
    rng = np.random.default_rng(23)
    rows, wavs = [], []
    for i, sec in enumerate((1.2, 0.7, 1.9)):
        wavs.append(np.round(voice(sec, rng) * 32768.0) / 32768.0)
        save_wav(str(tmp_path / f"c{i}.wav"), wavs[-1])
        rows.append((f"c{i}.wav", sec, "привет мир"))
    tdata.write_manifest(str(tmp_path / "m.tsv"), rows)
    out = str(tmp_path / "preds.jsonl")
    eval_cli.main(["--model_name", str(tmp_path / "tiny.npz"), "--device",
                   "cpu", "--manifest", str(tmp_path / "m.tsv"),
                   "--batch_size", "2", "--out", out, "--beam_size", "4",
                   "--lm", str(tmp_path / "lm.npz"), "--lm_weight", "0.4",
                   "--token_bonus", "0.1"])
    assert "WER (e2e)" in capsys.readouterr().out
    preds = [json.loads(line)["prediction"] for line in open(out)]
    want = [text for text, _ in tm._decode_batch(
        wavs, False, beam_size=4, lm=ours, lm_weight=0.4, token_bonus=0.1)]
    assert preds == want


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest --noconftest -m gpu tests/test_torch_beam.py)")
    return torch.device("cuda")


def card_lm(cuda, sparse):
    lm = NGramLM.train(corpus(33, n=200), vocab_size=33, order=3)
    return lm, lm_device_table(lm, cuda, sparse=sparse)


@pytest.mark.gpu
@pytest.mark.parametrize("lm_kind", [None, "dense", "sparse"])
def test_graph_beam_is_the_eager_loop_bit_for_bit(cuda, lm_kind):
    head = card_head(cuda)
    enc, lens = card_inputs(cuda)
    spec = None if lm_kind is None else card_lm(cuda, lm_kind == "sparse")[1]
    dec = RNNTBeamDecoder()
    # the bonus offsets the random LM's ~log(1/33) a token
    kw = dict(beam_size=4, max_symbols=3, lm=spec, lm_weight=0.3,
              token_bonus=1.5, with_logps=True, chunk=16)
    eager = dec.decode_eager(head, enc, lens, **kw)
    for _ in range(2):                   # capture, then a replay of it
        got = dec.decode(head, enc, lens, **kw)
        for g, e in zip(got, eager):
            assert torch.equal(g, e)
    assert dec.captures == 1 and dec.replays == 2 * dec.eager_chunks
    assert int(got[2].sum()) > 0


@pytest.mark.gpu
def test_graph_beam_sees_a_retrained_lm_and_a_weight_update(cuda):
    head = card_head(cuda)
    enc, lens = card_inputs(cuda)
    lm, spec = card_lm(cuda, sparse=False)
    dec = RNNTBeamDecoder()
    kw = dict(beam_size=4, max_symbols=3, with_logps=True, chunk=16)
    dec.decode(head, enc, lens, lm=spec, **kw)
    lm.add_sequence([5] * 30)            # retrained: a new device table
    spec = lm_device_table(lm, cuda)
    got = dec.decode(head, enc, lens, lm=spec, **kw)
    assert dec.captures == 2
    for g, e in zip(got, dec.decode_eager(head, enc, lens, lm=spec, **kw)):
        assert torch.equal(g, e)
    with torch.no_grad():
        spec[0][:, 5] += 5.0             # the table edited in place
    got = dec.decode(head, enc, lens, lm=spec, **kw)
    assert dec.captures == 3
    for g, e in zip(got, dec.decode_eager(head, enc, lens, lm=spec, **kw)):
        assert torch.equal(g, e)
    with torch.no_grad():
        head["joint"]["out"]["b"][33] += 1e4     # blank everywhere
    got = dec.decode(head, enc, lens, lm=spec, **kw)
    assert dec.captures == 4 and int(got[2].sum()) == 0

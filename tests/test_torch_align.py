"""CTC forced alignment in the port against the JAX package, on the CPU in
fp32, on inputs drawn with ``numpy.random.default_rng``:

* ``viterbi_align`` (batched over B) against the JAX DP ``vmap``-ed: a
  planted path, repeated tokens, an infeasible transcript, ``enc_len <
  T``, a ragged batch with tied scores: backpointers and final states
  bit-equal, scores within SCORE_ATOL;
* ``backtrack`` and ``pad_targets`` against the JAX host copies;
* ``align``/``align_batch`` of a tiny CTC model against the JAX model on
  the same weights (``params_from_jax``): texts and word times equal,
  confidences within CONF_RTOL; the same errors.

The tests marked ``gpu`` hold the CUDA-graph DP to the eager loop on the
card, bit for bit, and skip without a card.  JAX is imported inside the
CPU tests only, so that the card's host, which has no JAX, runs them with
``pytest --noconftest -m gpu tests/test_torch_align.py``.
"""

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.decode.align import (
    NEG,
    ViterbiAligner,
    backtrack,
    pad_targets,
    viterbi_align,
)

# the same fp32 adds and maxima in the same order: equal in practice; the
# limit covers one rounding of a score of magnitude ~100
SCORE_ATOL = 1e-5
# word confidence = exp(mean of fp32 log-probs from two encoders whose
# products are summed in another order)
CONF_RTOL = 1e-4
BLANK = 8


def planted(t, v, path):
    """log-probs peaked on ``path`` (one label a frame)."""
    lp = np.full((t, v), -20.0, np.float32)
    for i, lab in enumerate(path):
        lp[i, lab] = -0.01
    return lp


def ragged_batch(rng, b=5, t=40, v=9):
    """Normalised log-probs rounded to 0.1 (many tied scores), transcripts
    of 3 to 25 tokens, one empty, ragged enc_len."""
    lp = rng.standard_normal((b, t, v)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    lp = np.round(lp, 1).astype(np.float32)
    ids = [list(rng.integers(0, v - 1, n)) for n in (3, 7, 0, 12, 25)][:b]
    enc = np.array([40, 33, 10, 20, 40][:b], np.int32)
    return lp, enc, ids


CASES = {
    # frames: b 1 1 b 2 3 3 b, tokens 1 2 3
    "planted": ([planted(8, 9, [BLANK, 1, 1, BLANK, 2, 3, 3, BLANK])], [8],
                [[1, 2, 3]]),
    # '1 1' in two frames cannot pass the blank between; [1] and [1, 2] fit
    "repeated": ([planted(2, 9, [1, 1]), planted(2, 9, [1, 1]),
                  planted(2, 9, [1, 2])], [2, 2, 2], [[1, 1], [1], [1, 2]]),
    "infeasible": ([planted(3, 9, [1, 2, 3])], [3], [[1, 2, 3, 1, 2]]),
    # token 3 only after enc_len
    "enc_len": ([planted(6, 9, [1, 2, BLANK, BLANK, 3, 3])] * 2, [4, 6],
                [[1, 2, 3], [1, 2, 3]]),
}


def batch_inputs(lps, enc, ids):
    per = [pad_targets(i) for i in ids]
    targets = np.zeros((len(ids), max(len(p) for p in per)), np.int32)
    for i, p in enumerate(per):
        targets[i, :len(p)] = p
    return (np.stack(lps).astype(np.float32), np.asarray(enc, np.int32),
            targets, np.array([len(i) for i in ids], np.int32))


def jax_dp(lp, enc, targets, tlens):
    import jax

    from gigaam_tpu.decode.align import viterbi_align as jax_viterbi

    f = jax.vmap(jax_viterbi, in_axes=(0, 0, 0, 0, None))
    return [np.asarray(x) for x in f(lp, enc, targets, tlens,
                                     np.int32(BLANK))]


def port_dp(lp, enc, targets, tlens):
    return [x.numpy() for x in viterbi_align(
        torch.from_numpy(lp), torch.from_numpy(enc),
        torch.from_numpy(targets), torch.from_numpy(tlens), BLANK)]


def case_inputs(case):
    if case == "ragged":
        lp, enc, ids = ragged_batch(np.random.default_rng(0))
        return batch_inputs(list(lp), enc, ids), ids
    lps, enc, ids = CASES[case]
    return batch_inputs(lps, enc, ids), ids


@pytest.mark.parametrize("case", list(CASES) + ["ragged"])
def test_viterbi_matches_jax(case):
    inputs, _ = case_inputs(case)
    bp, fs, score = port_dp(*inputs)
    bp_j, fs_j, score_j = jax_dp(*inputs)
    assert bp.dtype == np.int8 and bp.shape == bp_j.shape
    np.testing.assert_array_equal(bp, bp_j)
    np.testing.assert_array_equal(fs, fs_j)
    np.testing.assert_allclose(score, score_j, atol=SCORE_ATOL, rtol=0)
    if case == "infeasible":
        assert score[0] <= NEG / 2
    if case == "repeated":
        assert score[0] <= NEG / 2 and score[1] > -1 and score[2] > -1
    if case == "enc_len":
        assert score[0] < -15 and score[1] > -1


@pytest.mark.parametrize("case", ["planted", "enc_len", "ragged"])
def test_backtrack_matches_jax(case):
    from gigaam_tpu.decode.align import backtrack as jax_backtrack

    (lp, enc, targets, tlens), ids = case_inputs(case)
    bp, fs, score = port_dp(lp, enc, targets, tlens)
    for i, u in enumerate(ids):
        if not u or score[i] <= NEG / 2:
            continue
        got = backtrack(bp[i], int(fs[i]), int(enc[i]), len(u), lp[i],
                        targets[i])
        ref = jax_backtrack(bp[i], int(fs[i]), int(enc[i]), len(u), lp[i],
                            targets[i])
        assert got == ref
        frames = got[0]
        assert all(b > a for a, b in zip(frames, frames[1:]))
        assert frames[-1] < enc[i]
    if case == "planted":
        assert got[0] == [1, 4, 5]


@pytest.mark.parametrize("ids,bucket", [([1, 2, 3], 8), (list(range(9)), 8),
                                        ([], 8), ([5], 4), ([7] * 40, 32)])
def test_pad_targets_matches_jax(ids, bucket):
    from gigaam_tpu.decode.align import pad_targets as jax_pad

    np.testing.assert_array_equal(pad_targets(ids, bucket),
                                  jax_pad(ids, bucket))


# ---------------------------------------------------------------------------
# The model API
# ---------------------------------------------------------------------------

def tiny_cfg(cfgmod, rnnt=False):
    """2 layers at width 64 (4 heads), the char vocabulary."""
    v = len(cfgmod.RU_VOCAB) + 1
    if rnnt:
        head = cfgmod.RNNTHeadConfig(
            decoder=cfgmod.RNNTDecoderConfig(pred_hidden=32,
                                             pred_rnn_layers=1,
                                             num_classes=v),
            joint=cfgmod.RNNTJointConfig(enc_hidden=64, pred_hidden=32,
                                         joint_hidden=32, num_classes=v))
    else:
        head = cfgmod.CTCHeadConfig(feat_in=64, num_classes=v)
    return cfgmod.ModelConfig(
        model_name="tiny_align", model_class="asr",
        preprocessor=cfgmod.FeaturesConfig(center=False),
        encoder=cfgmod.EncoderConfig(feat_in=64, n_layers=2, d_model=64,
                                     n_heads=4, ff_expansion_factor=2,
                                     conv_kernel_size=7,
                                     pos_emb_max_len=256),
        head=head,
        decoding=cfgmod.DecodingConfig(
            kind="rnnt_greedy" if rnnt else "ctc_greedy",
            vocabulary=list(cfgmod.RU_VOCAB)))


def pair(rnnt=False, seed=0):
    import jax

    from gigaam_tpu import config as jcfg
    from gigaam_tpu.models.model import GigaAMASR as JaxASR

    jm = JaxASR(tiny_cfg(jcfg, rnnt), seed=seed)
    tm = gt.GigaAMASR(gt.ModelConfig.from_dict(jm.cfg.to_dict()),
                      state=gt.params_from_jax(
                          jax.tree.map(np.asarray, jm.params)),
                      device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def ctc_pair():
    return pair(seed=3)


def noise(seconds, rng):
    return (0.2 * rng.standard_normal(int(16000 * seconds))).astype(
        np.float32)


def same_results(got, ref):
    assert [g.text for g in got] == [r.text for r in ref]
    for g, r in zip(got, ref):
        assert ([(w.text, w.start, w.end) for w in g.words]
                == [(w.text, w.start, w.end) for w in r.words])
        np.testing.assert_allclose([w.confidence for w in g.words],
                                   [w.confidence for w in r.words],
                                   rtol=CONF_RTOL)


def test_align_batch_matches_jax(ctc_pair):
    """The model's own greedy transcripts (plus an empty one and one with
    'ё', which normalises to 'е'), batched and one by one."""
    jm, tm = ctc_pair
    rng = np.random.default_rng(7)
    wavs = [noise(s, rng) for s in (1.0, 2.0, 1.5)]
    texts = [jm.transcribe(w).text for w in wavs]
    assert all(t.strip() for t in texts)
    texts[2] = ""
    texts[1] = texts[1] + " ёж"
    ref = jm.align_batch(wavs, texts)
    got = tm.align_batch(wavs, texts)
    same_results(got, ref)
    assert got[1].text.endswith("еж") and got[2].words == []
    assert sum(len(g.words) for g in got) > 2
    same_results([tm.align(wavs[0], texts[0])], [jm.align(wavs[0],
                                                          texts[0])])
    assert tm.aligner.eager_runs == 2 and tm.aligner.replays == 0


def test_align_errors_match_jax(ctc_pair):
    jm, tm = ctc_pair
    rng = np.random.default_rng(4)
    short = noise(0.25, rng)
    for model in (jm, tm):
        with pytest.raises(ValueError, match="does not fit"):
            model.align(short, "а" * 300)   # a repeat needs two frames
        with pytest.raises(ValueError, match="wavs vs"):
            model.align_batch([short, short], ["а"])
        with pytest.raises(ValueError, match="too long"):
            model.align(noise(26.0, rng), "а")
        assert model.align_batch([], []) == []
    _, rnnt = pair(rnnt=True)
    with pytest.raises(ValueError, match="CTC"):
        rnnt.align(short, "привет")


def test_align_raises_on_zero_frames(ctc_pair):
    """An empty clip has no encoder frame: the port raises where the JAX
    DP would read frame 0 (``decode/align.py:82`` there)."""
    _, tm = ctc_pair
    with pytest.raises(ValueError, match="does not fit"):
        tm.align(np.zeros(0, np.float32), "а")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "pytest --noconftest -m gpu tests/test_torch_align.py)")
    return torch.device("cuda")


CARD_BLANK = 33


def card_batch(cuda, b=4, t=120, v=CARD_BLANK + 1, seed=1):
    rng = np.random.default_rng(seed)
    lp = rng.standard_normal((b, t, v)).astype(np.float32)
    lp = np.round(lp - np.log(np.exp(lp).sum(-1, keepdims=True)), 1)
    # sample 2 cannot fit 12 tokens into 9 frames
    ids = [list(rng.integers(0, v - 1, n)) for n in (50, 17, 12, 70)][:b]
    enc = np.array([t, t - 17, 9, t - 1][:b], np.int32)
    lp, enc, targets, tlens = batch_inputs(list(lp), enc, ids)
    return [torch.from_numpy(a).to(cuda) for a in (lp, enc, targets, tlens)]


@pytest.mark.gpu
def test_graph_dp_is_the_eager_loop_bit_for_bit(cuda):
    args = card_batch(cuda)
    al = ViterbiAligner()
    eager = al.align_eager(*args, CARD_BLANK)
    ref = ViterbiAligner().align(*(a.cpu() for a in args), CARD_BLANK)
    for _ in range(2):                   # capture, then a replay of it
        got = al.align(*args, CARD_BLANK)
        for g, e, r in zip(got, eager, ref):
            assert torch.equal(g, e) and torch.equal(g.cpu(), r)
    assert al.captures == 1 and al.replays == 2 and al.eager_runs == 1
    assert float(got[2][0]) > NEG / 2 and float(got[2][2]) <= NEG / 2


@pytest.mark.gpu
def test_graph_dp_is_keyed_by_shape(cuda):
    al = ViterbiAligner()
    for b, t in ((4, 120), (2, 120), (4, 96), (4, 120)):
        args = card_batch(cuda, b=b, t=t)
        got = al.align(*args, CARD_BLANK)
        for g, e in zip(got, al.align_eager(*args, CARD_BLANK)):
            assert torch.equal(g, e)
    assert al.captures == 3 and al.replays == 4

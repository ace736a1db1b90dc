"""The port's n-gram LM (``gigaam_tpu_torch/decode/lm.py``) against the JAX
package's, on the same corpora (drawn with ``numpy.random.default_rng``):

* ``logp`` and ``score_sequence`` within 1e-12 (the same float64 math),
  the context packing, the counts and ``version``;
* ``dense_table`` and ``sparse_table`` within 1e-6 (fp32 tables; the ids
  equal), and their size guards (the dense elements, int32 context ids);
* ``save``/``load``: an npz written by either package loads in the other;
* ``train_lm_from_texts`` over the char and a SentencePiece tokenizer;
* ``lm_device_table`` (the RNNT beam's tables) against the numpy tables,
  and ``GigaAMASR._resolve_lm``'s caches.

CPU only, float64 and fp32.
"""

import numpy as np
import pytest
import torch

from gigaam_tpu.decode import lm as jlm
from gigaam_tpu.decode.tokenizer import Tokenizer as JaxTokenizer

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.decode import lm as tlm
from gigaam_tpu_torch.decode.rnnt_beam import _lm_rows, lm_device_table
from gigaam_tpu_torch.decode.tokenizer import Tokenizer

LOGP_ATOL = 1e-12
TABLE_ATOL = 1e-6


def corpus(v=6, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, v, size=rng.integers(3, 12)).tolist()
            for _ in range(n)]


def pair(order, v=6, seed=0):
    seqs = corpus(v, seed=seed)
    return (tlm.NGramLM.train(seqs, vocab_size=v, order=order),
            jlm.NGramLM.train(seqs, vocab_size=v, order=order))


def contexts(v, order, seed=1):
    rng = np.random.default_rng(seed)
    return [[]] + [rng.integers(0, v, size=rng.integers(1, order + 2))
                   .tolist() for _ in range(20)]


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_logp_matches_jax(order):
    ours, ref = pair(order)
    assert ours._counts == ref._counts
    assert ours.num_counted_ngrams() == ref.num_counted_ngrams()
    for ctx in contexts(6, order):
        assert ours.pack_context(ctx) == ref.pack_context(ctx)
        for tok in range(6):
            assert abs(ours.logp(tok, ctx) - ref.logp(tok, ctx)) <= LOGP_ATOL
        packed = ours.pack_context(ctx)
        assert ours.shift_context(packed, 3) == ref.shift_context(packed, 3)
    for seq in corpus(6, n=5, seed=2):
        assert abs(ours.score_sequence(seq)
                   - ref.score_sequence(seq)) <= LOGP_ATOL


@pytest.mark.parametrize("order", [1, 2, 3])
def test_dense_table_matches_jax(order):
    ours, ref = pair(order)
    got, want = ours.dense_table(), ref.dense_table()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TABLE_ATOL, rtol=0)


@pytest.mark.parametrize("order", [2, 3, 4])
def test_sparse_table_matches_jax(order):
    ours, ref = pair(order)
    got, want = ours.sparse_table(), ref.sparse_table()
    np.testing.assert_allclose(got["row0"], want["row0"], atol=TABLE_ATOL)
    assert len(got["levels"]) == len(want["levels"]) == order - 1
    for (ids, rows), (rids, rrows) in zip(got["levels"], want["levels"]):
        assert ids.dtype == np.int32
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_allclose(rows, rrows, atol=TABLE_ATOL, rtol=0)


def test_table_guards():
    lm = tlm.NGramLM(vocab_size=512, order=3)
    lm.add_sequence([1, 2, 3])
    with pytest.raises(ValueError, match="dense table"):
        lm.dense_table()
    assert lm.sparse_table()["levels"][1][0].dtype == np.int32
    # (V+1)^(order-1) >= 2^31: packed ids overflow int32 (lm.py:254)
    big = tlm.NGramLM(vocab_size=2000, order=4)
    big.add_sequence([1, 2, 3])
    with pytest.raises(ValueError, match="int32"):
        big.sparse_table()
    with pytest.raises(ValueError, match="out of range"):
        lm.add_sequence([512])


def test_version_bumps_on_every_mutation():
    lm = tlm.NGramLM(vocab_size=5, order=2)
    v0 = lm.version
    lm.add_sequence([1, 2])
    assert lm.version == v0 + 1
    lm.add_sequence([3])
    assert lm.version == v0 + 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_in_the_other_package(tmp_path, writer):
    ours, ref = pair(3, seed=4)
    path = str(tmp_path / "lm")                  # no .npz: both add it
    (ours if writer == "port" else ref).save(path)
    loaded = (jlm.NGramLM if writer == "port" else tlm.NGramLM).load(path)
    assert loaded._counts == ours._counts
    assert (loaded.vocab_size, loaded.order) == (6, 3)
    for ctx in contexts(6, 3):
        for tok in range(6):
            assert loaded.logp(tok, ctx) == ours.logp(tok, ctx)


def test_load_refuses_another_format(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, meta=np.frombuffer(b'{"format": "other"}', np.uint8))
    with pytest.raises(ValueError, match="not a gigaam_tpu n-gram LM"):
        tlm.NGramLM.load(path)


@pytest.fixture(scope="module")
def sp_path(tmp_path_factory):
    from test_torch_tokenizer import sp_pieces

    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    path = str(tmp_path_factory.mktemp("sp") / "tiny.model")
    write_sp_model(path, sp_pieces())
    return path


TEXTS = ["привет мир", "привет всем", "мир вам", "", "в мире привет"]


@pytest.mark.parametrize("kind", ["char", "sp"])
def test_train_lm_from_texts_matches_jax(kind, sp_path):
    if kind == "char":
        ours_tok = Tokenizer(list(gt.RU_VOCAB))
        ref_tok = JaxTokenizer(list(gt.RU_VOCAB))
    else:
        ours_tok, ref_tok = Tokenizer([], sp_path), JaxTokenizer([], sp_path)
    assert len(ours_tok) == len(ref_tok)
    ours = gt.train_lm_from_texts(TEXTS, ours_tok, order=3)
    ref = jlm.train_lm_from_texts(TEXTS, ref_tok, order=3)
    assert ours.vocab_size == len(ours_tok) and ours._counts == ref._counts
    ids = ours_tok.encode("привет")
    assert ours.score_sequence(ids) == ref.score_sequence(ids)
    if kind == "char":
        with pytest.raises(ValueError, match="no trainable text"):
            gt.train_lm_from_texts(["", ""], ours_tok)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_device_tables_match_the_host_scorer(order):
    """Each packed context's row from ``lm_device_table`` (dense gather, or
    the sparse table's deepest ``searchsorted`` hit) equals ``logp`` to
    fp32, and the dense and sparse rows agree."""
    lm, _ = pair(order)
    dense, base, ctx_len = lm_device_table(lm, "cpu")
    sparse, base_s, ctx_len_s = lm_device_table(lm, "cpu", sparse=True)
    assert (base, ctx_len) == (base_s, ctx_len_s) == (7, order - 1)
    assert isinstance(dense, torch.Tensor) and isinstance(sparse, dict)
    ctx = torch.tensor([[lm.pack_context(c) for c in contexts(6, order)]])
    rows_d = _lm_rows(dense, base, ctx)[0].numpy()
    rows_s = _lm_rows(sparse, base, ctx)[0].numpy()
    want = np.array([[lm.logp(t, c) for t in range(6)]
                     for c in contexts(6, order)])
    np.testing.assert_allclose(rows_d, want, atol=TABLE_ATOL, rtol=0)
    np.testing.assert_allclose(rows_s, want, atol=TABLE_ATOL, rtol=0)


def test_large_vocabulary_gets_the_sparse_table():
    rng = np.random.default_rng(3)
    lm = tlm.NGramLM.train([rng.integers(0, 512, 12).tolist()
                            for _ in range(20)], vocab_size=512, order=3)
    table, base, ctx_len = lm_device_table(lm, "cpu")
    assert isinstance(table, dict) and (base, ctx_len) == (513, 2)
    assert [ids.dtype for ids, _ in table["levels"]] == [torch.int32] * 2
    with pytest.raises(ValueError, match="dense table"):
        lm_device_table(lm, "cpu", sparse=False)


def tiny_asr(kind):
    cfg = gt.make_preset("v3_ctc" if kind == "ctc" else "v3_rnnt")
    cfg.encoder = gt.config.EncoderConfig(n_layers=1, d_model=64, n_heads=4,
                                          ff_expansion_factor=2)
    if kind == "ctc":
        cfg.head.feat_in = 64
    else:
        cfg.head.joint.enc_hidden = 64
    return gt.GigaAMASR(cfg, device="cpu")


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_resolve_lm_caches_by_path_object_and_version(tmp_path, kind):
    model = tiny_asr(kind)
    v = len(model.tokenizer)
    lm = tlm.NGramLM.train([[0, 1, 2]] * 3, vocab_size=v, order=2)
    path = str(tmp_path / "lm.npz")
    lm.save(path)
    assert model._resolve_lm(None) == (None, None)
    first, spec = model._resolve_lm(path)
    again, spec_again = model._resolve_lm(path)
    assert again is first and first._counts == lm._counts
    if kind == "ctc":
        assert spec is None and spec_again is None
        return
    assert spec_again is spec and spec[1:] == (v + 1, 1)
    assert spec[0].shape == (v + 1, v)
    _, by_object = model._resolve_lm(lm)
    assert by_object is not spec
    assert model._resolve_lm(lm)[1] is by_object
    old = by_object[0].clone()
    lm.add_sequence([3, 3, 3])           # retrained in place: a new table
    _, rebuilt = model._resolve_lm(lm)
    assert rebuilt is not by_object and not torch.equal(rebuilt[0], old)
    np.testing.assert_allclose(rebuilt[0].numpy(), lm.dense_table())
    with pytest.raises(ValueError, match="vocab"):
        model._resolve_lm(tlm.NGramLM.train([[0]], vocab_size=3, order=2))

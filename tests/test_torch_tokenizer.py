"""The port's tokenizer (``gigaam_tpu_torch/decode/tokenizer.py``) against
the JAX package's, on a tiny SentencePiece ``.model`` with word-boundary
pieces, one ``unk``, control pieces and the 256 byte-fallback pieces:
the parsed pieces, ``encode``, ``decode`` and ``id_to_str`` are equal, on
fixed strings and on ``hypothesis`` strings of Cyrillic, Latin, spaces and
characters outside the vocabulary.  Also ``load_model(init="random")``'s
placeholder pieces for the SentencePiece presets, against the JAX
package's (with the encoder shrunk: the tests never build a full-width
model on the CPU)."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import gigaam_tpu
from gigaam_tpu.config import make_preset as jax_make_preset
from gigaam_tpu.decode.tokenizer import Tokenizer as JaxTokenizer

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.config import make_preset as port_make_preset
from gigaam_tpu_torch.decode.tokenizer import (
    SentencePieceModel,
    Tokenizer,
    parse_sp_model,
    write_sp_model,
)

_CYRILLIC = "абвгдеёжзийклмнопрстуфхцчшщъыьэюя"
_LATIN = "abcdefghijklmnopqrstuvwxyz"


def sp_pieces():
    """unk, two control pieces, 256 bytes, then normal pieces: the boundary
    alone, single letters (no 'ё', 'щ', 'q', 'z': those take the byte
    fallback), and some multi-letter pieces with and without '▁'."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces.append(("▁", -2.0, 1))
    letters = [c for c in _CYRILLIC + _LATIN if c not in "ёщqz"]
    pieces += [(c, -3.0 - 0.01 * i, 1) for i, c in enumerate(letters)]
    words = ["▁пр", "▁при", "вет", "▁мир", "ив", "ет", "▁в", "ни", "▁the",
             "ing", "▁а", "ст", "▁привет", "ого"]
    pieces += [(w, -1.0 - 0.1 * i, 1) for i, w in enumerate(words)]
    return pieces


@pytest.fixture(scope="module")
def sp_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sp") / "tiny.model")
    write_sp_model(path, sp_pieces())
    return path


@pytest.fixture(scope="module")
def tokenizers(sp_path):
    return Tokenizer([], sp_path), JaxTokenizer([], sp_path)


def test_writer_is_the_export_tests_writer(tmp_path):
    from test_export_serve import _write_tiny_sp_model

    ours, theirs = str(tmp_path / "a.model"), str(tmp_path / "b.model")
    write_sp_model(ours, sp_pieces())
    _write_tiny_sp_model(theirs, sp_pieces())
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_parse_matches_jax(sp_path):
    from gigaam_tpu.decode.tokenizer import parse_sp_model as jax_parse

    got = parse_sp_model(sp_path)
    assert got == jax_parse(sp_path)
    assert [p for p, _, _ in got] == [p for p, _, _ in sp_pieces()]
    model = SentencePieceModel(sp_path)
    assert model.unk_id == 0 and model._byte_ids is not None


FIXED = ["привет мир", "при вет", "the thing", "ёлка и щука", "quiz",
         "  два  пробела ", "", "日本語 и emoji 🙂", "a▁b", "ПРИВЕТ"]


@pytest.mark.parametrize("text", FIXED)
def test_encode_decode_match_jax(tokenizers, text):
    ours, theirs = tokenizers
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert ours.decode(ids) == theirs.decode(ids)
    assert [ours.id_to_str(i) for i in ids] == [
        theirs.id_to_str(i) for i in ids]


def test_byte_fallback_and_word_boundaries(tokenizers):
    ours, _ = tokenizers
    ids = ours.encode("ёж")
    # 'ё' is no piece: its two UTF-8 bytes, then 'ж'
    assert [ours.id_to_str(i) for i in ids[:3]] == ["▁", "<0xD1>", "<0x91>"]
    assert ours.decode(ids) == "ёж"
    assert ours.decode(ours.encode("привет мир")) == "привет мир"
    assert ours.id_to_str(0) == "⁇" and ours.id_to_str(1) == ""
    assert ours.decode([0, 1]) == " ⁇ "
    assert len(ours) == len(sp_pieces()) and not ours.charwise


def test_every_piece_id_matches_jax(tokenizers):
    ours, theirs = tokenizers
    for i in range(len(ours)):
        assert ours.id_to_str(i) == theirs.id_to_str(i)
        assert ours.decode([i]) == theirs.decode([i])


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=st.sampled_from(
    list(_CYRILLIC + _LATIN + _CYRILLIC.upper() + "  .,!?ß日🙂▁")),
    max_size=40))
def test_hypothesis_strings_match_jax(tokenizers, text):
    ours, theirs = tokenizers
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert ours.decode(ids) == theirs.decode(ids)


def shrunk(cfg):
    """The preset with a 1-layer, 64-wide encoder and the head's input
    widths to match; the head's classes and the decoding config stay."""
    enc = dataclasses.replace(cfg.encoder, n_layers=1, d_model=64, n_heads=4,
                              ff_expansion_factor=2)
    head = cfg.head
    if head.kind == "ctc":
        head = dataclasses.replace(head, feat_in=64)
    else:
        head = dataclasses.replace(head, joint=dataclasses.replace(
            head.joint, enc_hidden=64))
    return dataclasses.replace(cfg, encoder=enc, head=head)


@pytest.mark.parametrize("name", ["e2e_ctc", "e2e_rnnt", "v1_rnnt", "rnnt"])
def test_placeholder_pieces_match_jax(monkeypatch, tmp_path, name):
    """``load_model(name, init="random")`` of both packages: the same
    vocabulary (for a SentencePiece preset, placeholder pieces, one per
    non-blank class) and a model that transcribes."""
    monkeypatch.setattr(gt, "make_preset",
                        lambda n: shrunk(port_make_preset(n)))
    monkeypatch.setattr(gigaam_tpu, "make_preset",
                        lambda n: shrunk(jax_make_preset(n)))
    ours = gt.load_model(name, init="random", device="cpu")
    theirs = gigaam_tpu.load_model(name, init="random",
                                   download_root=str(tmp_path))
    vocab = ours.cfg.decoding.vocabulary
    assert vocab == theirs.cfg.decoding.vocabulary
    classes = (ours.cfg.head.num_classes if name == "e2e_ctc"
               else ours.cfg.head.joint.num_classes)
    if name != "rnnt":
        assert vocab == [f"<{i}>" for i in range(classes - 1)]
    assert ours.blank_id == len(vocab) == classes - 1 == theirs.blank_id
    wav = (0.1 * np.random.default_rng(0).standard_normal(16000)).astype(
        np.float32)
    assert isinstance(ours.transcribe(wav).text, str)

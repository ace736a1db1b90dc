"""The port's weights bridge: a JAX v3_ctc model saved with ``save_model``
and reloaded by the port keeps every leaf bit-exact (in the JAX layout
after undoing the port's layout changes), as does ``params_from_jax`` on
the in-memory tree and a legacy fused-GLU artifact through
``migrate_params``.  An RNNT model with two LSTM layers and a
SentencePiece tokenizer goes both ways: saved by either package and loaded
by the other, its leaves equal and its layers in order, the tokenizer
copied beside the artifact under a relative path.  The PyanNet VAD tree
(``vad_params_from_jax``) goes to the port's layout and back leaf for
leaf, and a JAX ``save_vad`` artifact reads through the port's
``load_vad`` into the same state."""

import json
import os
import shutil

import numpy as np
import pytest

import jax

from gigaam_tpu.config import (
    CTCHeadConfig,
    DecodingConfig,
    EncoderConfig,
    FeaturesConfig,
    ModelConfig,
    RNNTDecoderConfig,
    RNNTHeadConfig,
    RNNTJointConfig,
    RU_VOCAB,
)
from gigaam_tpu.models.model import GigaAMASR, _flatten, save_model
from gigaam_tpu.models.model import load_native as jax_load_native

import gigaam_tpu_torch as gt
from gigaam_tpu_torch import weights


def tiny_v3_cfg():
    v = len(RU_VOCAB)
    return ModelConfig(
        model_name="tiny_v3_ctc", model_class="asr",
        preprocessor=FeaturesConfig(center=False),
        encoder=EncoderConfig(feat_in=64, n_layers=2, d_model=64, n_heads=4,
                              ff_expansion_factor=2, conv_kernel_size=7,
                              pos_emb_max_len=256),
        head=CTCHeadConfig(feat_in=64, num_classes=v + 1),
        decoding=DecodingConfig(kind="ctc_greedy", vocabulary=list(RU_VOCAB)))


@pytest.fixture(scope="module")
def jax_model():
    return GigaAMASR(tiny_v3_cfg(), seed=0)


def jax_layout(model) -> dict:
    """The port model's weights back in the JAX layout, under the JAX
    package's ``/``-joined keys, layers stacked on a leading axis."""
    flat, layers = {}, {}
    for name, p in model.state_dict().items():
        if name.startswith("frontend."):
            continue
        parts = name.split(".")
        a = p.numpy()
        if parts[:2] == ["encoder", "layers"]:
            rest = parts[3:]
            if rest[-2:] == ["depthwise_conv", "w"]:
                a = a.transpose(2, 1, 0)
            layers.setdefault("/".join(rest), []).append(a)
            continue
        if parts[:2] == ["encoder", "pre_encode"] and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        flat["/".join(parts)] = a
    for key, per_layer in layers.items():
        flat[f"encoder/layers/{key}"] = np.stack(per_layer)
    return flat


def assert_bit_exact(port_flat, jax_flat):
    assert sorted(port_flat) == sorted(jax_flat)
    for key, ref in jax_flat.items():
        got = port_flat[key]
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        assert np.array_equal(got, ref), key


def test_native_artifact_reloads_bit_exact(jax_model, tmp_path):
    path = str(tmp_path / "tiny")
    save_model(jax_model, path)
    port = gt.load_model(path + ".npz", device="cpu")
    assert isinstance(port, gt.GigaAMASR)
    assert port.cfg.to_dict() == jax_model.cfg.to_dict()
    assert_bit_exact(jax_layout(port),
                     _flatten(jax.tree.map(np.asarray, jax_model.params)))


def test_params_from_jax_bit_exact(jax_model):
    tree = jax.tree.map(np.asarray, jax_model.params)
    port = gt.GigaAMASR(gt.ModelConfig.from_dict(jax_model.cfg.to_dict()),
                        state=gt.params_from_jax(tree), device="cpu")
    assert_bit_exact(jax_layout(port), _flatten(tree))


def test_legacy_fused_glu_artifact_migrates(jax_model, tmp_path):
    """Artifacts with the old fused ``pointwise_conv1 {w, b}`` load into the
    split value/gate leaves, bit-exact."""
    flat = _flatten(jax.tree.map(np.asarray, jax_model.params))
    legacy = {}
    for k, v in flat.items():
        if k.endswith("pointwise_conv1/w_value"):
            base = k[: -len("w_value")]
            legacy[base + "w"] = np.concatenate(
                [v, flat[base + "w_gate"]], axis=-1)
            legacy[base + "b"] = np.concatenate(
                [flat[base + "b_value"], flat[base + "b_gate"]], axis=-1)
        elif "pointwise_conv1" not in k:
            legacy[k] = v
    path = str(tmp_path / "legacy")
    np.savez(path + ".npz", **legacy)
    with open(path + ".json", "w") as f:
        f.write(jax_model.cfg.to_json())
    tree = weights.load_params_npz(path + ".npz")
    pc1 = tree["encoder"]["layers"]["conv"]["pointwise_conv1"]
    assert set(pc1) == {"w_value", "w_gate", "b_value", "b_gate"}
    assert_bit_exact(jax_layout(gt.load_model(path, device="cpu")), flat)


def test_load_model_rejects_missing_artifact(tmp_path):
    with pytest.raises(FileNotFoundError):
        gt.load_model(str(tmp_path / "absent"), device="cpu")


SP_PIECES = ([("<unk>", 0.0, 2)] + [(c, -1.0, 1) for c in "абвгде"]
             + [("▁пр", -0.5, 1)])


def tiny_rnnt_cfg(sp_path):
    v = len(SP_PIECES) + 1
    return ModelConfig(
        model_name="tiny_v3_rnnt", model_class="asr",
        preprocessor=FeaturesConfig(center=False),
        encoder=EncoderConfig(feat_in=64, n_layers=2, d_model=64, n_heads=4,
                              ff_expansion_factor=2, conv_kernel_size=7,
                              pos_emb_max_len=256),
        head=RNNTHeadConfig(
            decoder=RNNTDecoderConfig(pred_hidden=32, pred_rnn_layers=2,
                                      num_classes=v),
            joint=RNNTJointConfig(enc_hidden=64, pred_hidden=32,
                                  joint_hidden=32, num_classes=v)),
        decoding=DecodingConfig(kind="rnnt_greedy", vocabulary=[],
                                model_path=sp_path))


@pytest.fixture(scope="module")
def rnnt_model(tmp_path_factory):
    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    sp_path = str(tmp_path_factory.mktemp("tok") / "sp.model")
    write_sp_model(sp_path, SP_PIECES)
    return GigaAMASR(tiny_rnnt_cfg(sp_path), seed=0)


def assert_lstm_layers(port, jax_params):
    layers = port.head["decoder"]["lstm"]
    ref = jax_params["head"]["decoder"]["lstm"]
    assert isinstance(ref, list) and len(layers) == len(ref) == 2
    for got, want in zip(layers, ref):
        for name in ("w_ih", "w_hh", "b"):
            assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


def test_params_from_jax_takes_a_live_rnnt_tree(rnnt_model):
    """The JAX tree as the model holds it (jax arrays, ``lstm`` a list)."""
    port = gt.GigaAMASR(
        gt.ModelConfig.from_dict(rnnt_model.cfg.to_dict()),
        state=gt.params_from_jax(rnnt_model.params), device="cpu")
    assert_lstm_layers(port, rnnt_model.params)
    assert_bit_exact(jax_layout(port), _flatten(
        jax.tree.map(np.asarray, rnnt_model.params)))
    assert port.blank_id == rnnt_model.blank_id == len(SP_PIECES)


def test_rnnt_artifact_from_jax_to_port_and_back(rnnt_model, tmp_path):
    ref = _flatten(jax.tree.map(np.asarray, rnnt_model.params))
    save_model(rnnt_model, str(tmp_path / "jax" / "m"))
    port = gt.load_model(str(tmp_path / "jax" / "m.npz"), device="cpu")
    assert_lstm_layers(port, rnnt_model.params)
    assert_bit_exact(jax_layout(port), ref)
    assert port.cfg.decoding.model_path == os.path.join(
        str(tmp_path / "jax"), "m_tokenizer.model")
    assert len(port.tokenizer) == len(SP_PIECES)

    weights.save_model(port, str(tmp_path / "port" / "p"))
    with open(tmp_path / "port" / "p.json") as f:
        stored = json.load(f)["decoding"]["model_path"]
    assert stored == "p_tokenizer.model"
    with open(tmp_path / "port" / stored, "rb") as a, \
            open(rnnt_model.cfg.decoding.model_path, "rb") as b:
        assert a.read() == b.read()
    # the artifact moves with its tokenizer
    shutil.move(str(tmp_path / "port"), str(tmp_path / "moved"))
    back = jax_load_native(str(tmp_path / "moved" / "p.npz"))
    assert isinstance(back.params["head"]["decoder"]["lstm"], list)
    assert_bit_exact(_flatten(jax.tree.map(np.asarray, back.params)), ref)
    assert back.tokenizer.decode([7, 1]) == rnnt_model.tokenizer.decode(
        [7, 1])
    again = gt.load_model(str(tmp_path / "moved" / "p"), device="cpu")
    assert_bit_exact(jax_layout(again), ref)
    assert again.tokenizer.encode("пр аб") == rnnt_model.tokenizer.encode(
        "пр аб")


def test_port_saved_rnnt_keys_are_the_jax_keys(rnnt_model, tmp_path):
    port = gt.GigaAMASR(
        gt.ModelConfig.from_dict(rnnt_model.cfg.to_dict()),
        state=gt.params_from_jax(rnnt_model.params), device="cpu")
    weights.save_model(port, str(tmp_path / "p"))
    with np.load(tmp_path / "p.npz") as z:
        keys = set(z.files)
    assert keys == set(_flatten(jax.tree.map(np.asarray, rnnt_model.params)))
    assert {"head/decoder/lstm/0/w_ih", "head/decoder/lstm/1/b"} <= keys


# ---------------------------------------------------------------------------
# The PyanNet VAD
# ---------------------------------------------------------------------------

def vad_cfg():
    from gigaam_tpu.models.vad_net import VADNetConfig

    return VADNetConfig(sinc_filters=8, sinc_kernel=31, conv_channels=6,
                        lstm_hidden=8, lstm_layers=3, linear_hidden=8,
                        linear_layers=2)


def test_vad_params_from_jax_round_trip():
    """JAX tree -> the port's layout (taps and convs to torch's, the LSTM
    transposed under ``nn.LSTM``'s names, its bias in ``bias_ih``) -> back,
    bit-exact; the layouts checked on one leaf each."""
    from gigaam_tpu.models.vad_net import init_vad_params

    from gigaam_tpu_torch.models.vad_net import PyanNet, VADNetConfig

    cfg = vad_cfg()
    tree = jax.tree.map(np.asarray, init_vad_params(jax.random.PRNGKey(3),
                                                    cfg))
    # a bias that is not zero, so that the bias move is seen
    tree["lstm"][1]["bwd"]["b"] = np.arange(32, dtype=np.float32)
    state = weights.vad_params_from_jax(tree)
    np.testing.assert_array_equal(state["sinc"]["taps"].numpy(),
                                  tree["sinc"]["taps"].transpose(2, 1, 0))
    np.testing.assert_array_equal(state["convs"][1]["w"].numpy(),
                                  tree["convs"][1]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["lstm"]["weight_hh_l1_reverse"].numpy(),
        tree["lstm"][1]["bwd"]["w_hh"].T)
    np.testing.assert_array_equal(state["lstm"]["bias_ih_l1_reverse"],
                                  np.arange(32))
    assert not state["lstm"]["bias_hh_l1_reverse"].any()
    net = PyanNet(VADNetConfig(**vars(cfg)), state)
    back = weights.vad_params_to_jax(net)
    assert (jax.tree.structure(back) == jax.tree.structure(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_vad_artifact_reads_into_the_same_state(tmp_path):
    from gigaam_tpu.models.vad_net import init_vad_params, save_vad

    from gigaam_tpu_torch.models.vad_net import load_vad

    cfg = vad_cfg()
    params = init_vad_params(jax.random.PRNGKey(4), cfg)
    save_vad(str(tmp_path / "vad"), cfg, params)
    got_cfg, state = load_vad(str(tmp_path / "vad"))
    assert vars(got_cfg) == vars(cfg)
    want = weights.vad_params_from_jax(jax.tree.map(np.asarray, params))
    assert jax.tree.structure(state) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(want)):
        assert a.shape == b.shape and bool((a == b).all())

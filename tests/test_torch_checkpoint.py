"""Reference-checkpoint ingestion in the port (``gigaam_tpu_torch/
checkpoint.py`` and the reference branches of ``load_model``) against the
JAX package's converter on the CPU: every test of ``tests/test_checkpoint.py``
rewritten for the port, and more.

* The reference-layout checkpoints are written here with ``torch.save``:
  a tiny random port model per head kind (CTC, RNNT, emo, SSL; rel-pos with
  a LayerNorm conv module; conv1d subsampling) is turned into reference
  names and layouts (``reference_cfg``, ``reference_state_dict``, with
  ``${...}`` interpolations in the cfg), and every tensor is perturbed from
  a seed so that no bias, BatchNorm statistic or LSTM ``bias_hh`` is zero.
  The committed ``tests/data/ref_cfg_omegaconf.ckpt`` carries a real
  OmegaConf pickle.
* The port's ``ModelConfig`` equals the JAX converter's; its numpy tree
  equals ``gigaam_tpu.checkpoint.convert_state_dict``'s leaf by leaf, bit
  for bit; the models then agree within fp32 tolerance (encoder output
  atol 1e-4 as in ``tests/test_torch_model.py``, probabilities 1e-5).
* The download, md5, cache, Lightning and SentencePiece branches of
  ``load_model`` run against a ``file://`` URL in the test's directory, as
  ``tests/test_checkpoint.py`` does: nothing reaches the network.

The test marked ``gpu`` ingests a full-width checkpoint on the card and
holds it bit-equal to its source model; it skips without a card.  JAX is
imported inside the CPU tests only.
"""

import dataclasses
import inspect
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch import checkpoint as tck
from gigaam_tpu_torch.config import (
    CTCHeadConfig,
    DecodingConfig,
    EmoHeadConfig,
    EncoderConfig,
    FeaturesConfig,
    ModelConfig,
    RNNTDecoderConfig,
    RNNTHeadConfig,
    RNNTJointConfig,
    RU_VOCAB,
)
from gigaam_tpu_torch.weights import params_to_jax

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "ref_cfg_omegaconf.ckpt")
ENC_ATOL = 1e-4
PROB_ATOL = 1e-5
KINDS = ("ctc", "rnnt", "emo", "ssl", "relpos_layernorm", "conv1d")


def tiny_cfg(kind: str, d_model: int = 32, v: int = len(RU_VOCAB) + 1,
             name: str = None) -> ModelConfig:
    enc = EncoderConfig(
        feat_in=64, n_layers=2, d_model=d_model, n_heads=4,
        ff_expansion_factor=2, conv_kernel_size=7, pos_emb_max_len=256,
        subsampling="conv1d" if kind == "conv1d" else "conv2d",
        self_attention_model=("rel_pos" if kind in ("relpos_layernorm", "emo")
                              else "rotary"),
        conv_norm_type=("layer_norm" if kind == "relpos_layernorm"
                        else "batch_norm"))
    feats = FeaturesConfig(center=kind in ("relpos_layernorm", "emo"))
    vocab = list(RU_VOCAB)[:v - 1]
    head, decoding, cls, id2name = None, None, "asr", None
    if kind == "rnnt":
        head = RNNTHeadConfig(
            decoder=RNNTDecoderConfig(pred_hidden=16, pred_rnn_layers=1,
                                      num_classes=v),
            joint=RNNTJointConfig(enc_hidden=d_model, pred_hidden=16,
                                  joint_hidden=16, num_classes=v))
        decoding = DecodingConfig(kind="rnnt_greedy", vocabulary=vocab)
    elif kind == "emo":
        head, cls = EmoHeadConfig(feat_in=d_model, num_classes=4), "emo"
        id2name = ["angry", "sad", "neutral", "positive"]
    elif kind == "ssl":
        cls = "ssl"
    else:
        head = CTCHeadConfig(feat_in=d_model, num_classes=v)
        decoding = DecodingConfig(kind="ctc_greedy", vocabulary=vocab)
    return ModelConfig(model_name=name or f"synth_{kind}", model_class=cls,
                       preprocessor=feats, encoder=enc, head=head,
                       decoding=decoding, id2name=id2name)


def ref_state_dict(cfg: ModelConfig, seed: int = 0):
    """A reference-named state dict of torch tensors for ``cfg``: a random
    port model in the reference layout, every tensor perturbed from
    ``seed`` (running variances kept positive)."""
    model = gt.model_class_for(cfg)(cfg, device="cpu", seed=seed)
    sd = tck.reference_state_dict(params_to_jax(model), cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    out = {}
    for k, a in sd.items():
        x = torch.from_numpy(a) + 0.05 * torch.randn(a.shape, generator=gen)
        out[k] = x.abs() + 0.5 if k.endswith("running_var") else x
    return out


def write_ckpt(path, cfg: ModelConfig, seed: int = 0):
    sd = ref_state_dict(cfg, seed)
    torch.save({"cfg": tck.reference_cfg(cfg), "state_dict": sd}, str(path))
    return sd


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_bit_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        assert np.array_equal(got[k], a), k


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp

    import gigaam_tpu
    from gigaam_tpu import checkpoint as jck
    from gigaam_tpu.models import model as jmodel

    return types.SimpleNamespace(jax=jax, jnp=jnp, pkg=gigaam_tpu, ck=jck,
                                 model=jmodel)


def voice(seconds, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(int(seconds * 16000)) / 16000.0
    return (0.2 * np.sin(2 * np.pi * 180 * tt * (1 + 0.3 * np.sin(3 * tt)))
            + 0.02 * rng.standard_normal(tt.size)).astype(np.float32)


def assert_models_agree(tm, jm, kind):
    wavs = [voice(1.5, 0), voice(1.0, 1)]
    if kind == "emo":
        got, want = tm.get_probs(wavs[0]), jm.get_probs(wavs[0])
        assert got.keys() == want.keys()
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   atol=PROB_ATOL)
        return
    enc, lens = tm.encode_batch(wavs)
    jenc, jlens = jm.encode_batch(wavs)
    assert lens.tolist() == np.asarray(jlens).tolist()
    for i, n in enumerate(lens.tolist()):
        np.testing.assert_allclose(enc[i, :n].numpy(),
                                   np.asarray(jenc)[i, :n], atol=ENC_ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_convert_equals_the_jax_converter_and_runs(tmp_path, jx, kind):
    cfg = tiny_cfg(kind)
    path = tmp_path / f"synth_{kind}.ckpt"
    write_ckpt(path, cfg, seed=KINDS.index(kind))
    got_cfg, got = tck.convert_reference_checkpoint(str(path))
    want_cfg, want = jx.ck.convert_reference_checkpoint(str(path))
    assert got_cfg.to_dict() == want_cfg.to_dict()
    assert_bit_equal(got, jx.jax.tree.map(np.asarray, want))
    assert got_cfg.to_dict() == cfg.to_dict()
    # stacked layer axis, contiguous float32 leaves
    assert got["encoder"]["layers"]["norm_out"]["scale"].shape == (2, 32)
    assert all(a.flags.c_contiguous and a.dtype == np.float32
               for a in flat(got).values())

    tm = gt.load_model(str(path), device="cpu")
    jm = jx.model.model_class_for(want_cfg)(want_cfg, params=want,
                                            compute_dtype=jx.jnp.float32)
    assert type(tm).__name__ == type(jm).__name__
    assert_bit_equal(params_to_jax(tm), jx.jax.tree.map(np.asarray, want))
    assert_models_agree(tm, jm, kind)
    # the inverse: the tree back in the reference layout is the input
    sd = torch.load(str(path), weights_only=False)["state_dict"]
    back = tck.reference_state_dict(got, got_cfg)
    assert back.keys() == sd.keys()
    for k, a in back.items():
        if "bias_" not in k:               # the LSTM's biases are summed
            assert np.array_equal(a, sd[k].numpy()), k


@pytest.mark.parametrize("kind", ["ctc", "rnnt"])
def test_reference_names_are_the_jax_tests(jx, kind):
    """The names and shapes of ``reference_state_dict`` are those of the
    JAX package's own synthetic reference checkpoint."""
    from test_checkpoint import _ref_state_dict

    want = {k: tuple(v.shape) for k, v in _ref_state_dict(kind).items()}
    got = {k: tuple(v.shape) for k, v in ref_state_dict(tiny_cfg(kind))
           .items()}
    assert got == want


def test_config_translation_relpos_layernorm(jx):
    tree = tck.reference_cfg(tiny_cfg("ctc"))
    tree["encoder"]["self_attention_model"] = "rel_pos"
    tree["encoder"]["conv_norm_type"] = "layer_norm"
    tree["preprocessor"]["center"] = False
    tree = tck._resolve_interpolations(tree)
    cfg = tck.config_from_reference(tree, "x")
    assert cfg.encoder.self_attention_model == "rel_pos"
    assert cfg.encoder.conv_norm_type == "layer_norm"
    assert cfg.preprocessor.center is False
    assert cfg.decoding is not None and len(cfg.decoding.vocabulary) == 33
    assert cfg.to_dict() == jx.ck.config_from_reference(tree, "x").to_dict()


def test_id2name_in_numeric_order():
    tree = tck.reference_cfg(tiny_cfg("emo"))
    tree["id2name"] = {str(i): f"c{i}" for i in range(12)}
    cfg = tck.config_from_reference(tck._resolve_interpolations(tree), "e")
    assert cfg.id2name == [f"c{i}" for i in range(12)]
    assert cfg.head.feat_in == 32 and cfg.model_class == "emo"


def test_lstm_bias_summed(jx):
    cfg = tiny_cfg("rnnt")
    sd = ref_state_dict(cfg, seed=3)
    want = (sd["head.decoder.lstm.bias_ih_l0"]
            + sd["head.decoder.lstm.bias_hh_l0"]).numpy()
    assert float(sd["head.decoder.lstm.bias_hh_l0"].abs().max()) > 0
    tree = tck.convert_state_dict(tck.state_dict_to_numpy(sd), cfg)
    np.testing.assert_allclose(tree["head"]["decoder"]["lstm"][0]["b"], want,
                               atol=1e-6)


def test_lightning_checkpoint_needs_its_base():
    with pytest.raises(ValueError, match="apply_finetuned_state_dict"):
        tck.convert_reference_checkpoint(
            "x.ckpt", ckpt={"hyper_parameters": {"model_name": "v3_ctc"},
                            "state_dict": {}})


# ---------------------------------------------------------------------------
# load_model: the reference branches
# ---------------------------------------------------------------------------

@pytest.fixture
def shrunk_presets(monkeypatch, jx):
    """The presets at the tiny width, in both packages: ``load_model`` by
    name builds them (``init="random"``, the Lightning branch's base)."""
    def port(name):
        cfg = gt.config.make_preset(name)
        return dataclasses.replace(
            cfg, encoder=tiny_cfg("ctc").encoder,
            head=shrink_head(cfg.head))

    monkeypatch.setattr(gt, "make_preset", port)
    monkeypatch.setattr(jx.pkg, "make_preset", lambda name: (
        jx.pkg.config.ModelConfig.from_dict(port(name).to_dict())))
    return port


def shrink_head(head):
    if isinstance(head, CTCHeadConfig):
        return dataclasses.replace(head, feat_in=32)
    if isinstance(head, RNNTHeadConfig):
        return dataclasses.replace(head, joint=dataclasses.replace(
            head.joint, enc_hidden=32))
    return head


def cdn_with(tmp_path, monkeypatch, files, pin=True):
    """A local CDN directory served by ``file://`` with ``files`` (name ->
    (cfg, seed)) written as reference checkpoints; md5 pins set to them."""
    cdn = tmp_path / "cdn"
    cdn.mkdir(exist_ok=True)
    hashes = dict(gt._MODEL_HASHES)
    for name, (cfg, seed) in files.items():
        path = str(cdn / f"{name}.ckpt")
        write_ckpt(path, cfg, seed)
        if pin:
            hashes[name] = gt.hash_path(path)
    monkeypatch.setattr(gt, "_URL_DIR", f"file://{cdn}")
    monkeypatch.setattr(gt, "_MODEL_HASHES", hashes)
    return cdn


def test_load_model_downloads_verifies_and_caches(tmp_path, monkeypatch, jx):
    """``load_model("ctc")`` with no cache: the reference ``.ckpt`` comes
    from the CDN, is md5-checked and converted, the artifact is cached under
    the resolved name (and loads in the JAX package, bit for bit), and the
    second call reads the cache, not the CDN."""
    cdn = cdn_with(tmp_path, monkeypatch,
                   {"v3_ctc": (tiny_cfg("ctc", name="v3_ctc"), 0)})
    root = tmp_path / "cache"
    model = gt.load_model("ctc", device="cpu", download_root=str(root))
    assert isinstance(model, gt.GigaAMASR)
    assert (root / "v3_ctc.npz").exists() and (root / "v3_ctc.json").exists()
    assert (root / "v3_ctc.ckpt").exists()
    want = jx.ck.convert_reference_checkpoint(str(cdn / "v3_ctc.ckpt"))[1]
    assert_bit_equal(params_to_jax(model), jx.jax.tree.map(np.asarray, want))
    jm = jx.pkg.load_model(str(root / "v3_ctc"))
    assert_bit_equal(jx.jax.tree.map(np.asarray, jm.params),
                     params_to_jax(model))

    monkeypatch.setattr(gt, "_URL_DIR", "file:///nonexistent")
    (root / "v3_ctc.ckpt").unlink()
    again = gt.load_model("v3_ctc", device="cpu", download_root=str(root))
    assert_bit_equal(params_to_jax(again), params_to_jax(model))


def test_load_model_checksum_mismatch_removes_the_file(tmp_path,
                                                        monkeypatch):
    cdn_with(tmp_path, monkeypatch,
             {"v3_ctc": (tiny_cfg("ctc", name="v3_ctc"), 0)}, pin=False)
    root = tmp_path / "cache2"
    with pytest.raises(RuntimeError, match="Checksum mismatch"):
        gt.load_model("ctc", device="cpu", download_root=str(root))
    assert not (root / "v3_ctc.ckpt").exists()
    assert not (root / "v3_ctc.npz").exists()


def test_load_model_without_network_or_cache_fails_loudly(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(gt, "_URL_DIR", f"file://{tmp_path}/no_such_cdn")
    with pytest.raises(FileNotFoundError, match="download failed"):
        gt.load_model("v3_rnnt", device="cpu",
                      download_root=str(tmp_path / "c"))
    with pytest.raises(FileNotFoundError, match="no model of that name"):
        gt.load_model("v9_ctc", device="cpu",
                      download_root=str(tmp_path / "c"))


def test_load_model_finetuned_lightning_ckpt(tmp_path, monkeypatch, jx,
                                             shrunk_presets):
    """A fine-tuned Lightning ``.ckpt`` takes its config from
    ``hyper_parameters.model_name`` and its weights from its own
    ``encoder.``/``head.`` keys; other keys are left out."""
    cfg = shrunk_presets("v3_ctc")
    sd = ref_state_dict(cfg, seed=4)
    sd["head.decoder_layers.0.weight"] = sd["head.decoder_layers.0.weight"] + 1
    sd["optimizer.some_buffer"] = torch.zeros(3)
    ft_path = str(tmp_path / "finetuned.ckpt")
    torch.save({"hyper_parameters": {"model_name": "ctc"},
                "state_dict": sd}, ft_path)
    monkeypatch.setattr(gt, "_URL_DIR", "file:///nonexistent")
    model = gt.load_model(ft_path, device="cpu",
                          download_root=str(tmp_path / "cache"))
    assert isinstance(model, gt.GigaAMASR)
    assert model.cfg.to_dict() == cfg.to_dict()
    want = jx.ck.apply_finetuned_state_dict(
        jx.pkg.config.ModelConfig.from_dict(cfg.to_dict()), ft_path)
    assert_bit_equal(params_to_jax(model), jx.jax.tree.map(np.asarray, want))
    np.testing.assert_allclose(
        model.head["proj"]["w"].detach().numpy(),
        sd["head.decoder_layers.0.weight"][:, :, 0].T.numpy(), atol=0)


def test_load_model_finetuned_falls_back_to_the_base_config(
        tmp_path, monkeypatch, shrunk_presets):
    """A state dict that the preset does not fit (here 1 layer of the
    preset's 2) takes the config of the base checkpoint itself, from the
    CDN."""
    cfg = shrunk_presets("v3_ctc")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=1))
    cdn_with(tmp_path, monkeypatch, {"v3_ctc": (cfg, 5)})
    sd = ref_state_dict(cfg, seed=6)
    ft_path = str(tmp_path / "ft1.ckpt")
    torch.save({"hyper_parameters": {"model_name": "v3_ctc"},
                "state_dict": sd}, ft_path)
    model = gt.load_model(ft_path, device="cpu",
                          download_root=str(tmp_path / "cache"))
    assert len(model.encoder.layers) == 1
    assert torch.equal(model.encoder.layers[0]["norm_out"]["scale"],
                       sd["encoder.layers.0.norm_out.weight"])


def sp_pieces():
    return ([("<unk>", 0.0, 2)] + [(c, -1.0, 1) for c in "абвгд"]
            + [("▁пр", -0.5, 1)])


def test_load_model_finetuned_sp_base_uses_the_real_tokenizer(
        tmp_path, monkeypatch, shrunk_presets):
    """A fine-tuned checkpoint whose base needs a SentencePiece tokenizer
    resolves the real one (here cached), never placeholder pieces."""
    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    pieces = sp_pieces()
    root = tmp_path / "cache"
    root.mkdir()
    write_sp_model(str(root / "v3_e2e_ctc_tokenizer.model"), pieces)
    monkeypatch.setattr(gt, "_URL_DIR", "file:///nonexistent")
    cfg = dataclasses.replace(shrunk_presets("v3_e2e_ctc"), head=CTCHeadConfig(
        feat_in=32, num_classes=len(pieces) + 1))
    sd = ref_state_dict(cfg, seed=7)
    ft_path = str(tmp_path / "ft_e2e.ckpt")
    torch.save({"hyper_parameters": {"model_name": "e2e_ctc"},
                "state_dict": sd}, ft_path)
    model = gt.load_model(ft_path, device="cpu", download_root=str(root))
    assert not model.tokenizer.charwise
    assert model.tokenizer.decode([1, 2]) == "аб"
    assert model.blank_id == len(pieces)
    assert torch.equal(model.head["proj"]["b"].detach(),
                       sd["head.decoder_layers.0.bias"])


def test_load_model_finetuned_sp_base_offline_fails_loudly(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(gt, "_URL_DIR", f"file://{tmp_path}/no_such_cdn")
    ft_path = str(tmp_path / "ft_e2e.ckpt")
    torch.save({"hyper_parameters": {"model_name": "v3_e2e_ctc"},
                "state_dict": {}}, ft_path)
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        gt.load_model(ft_path, device="cpu",
                      download_root=str(tmp_path / "empty_cache"))


def test_random_init_picks_up_a_cached_sp_tokenizer(tmp_path, jx,
                                                   shrunk_presets):
    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    pieces = sp_pieces()
    root = tmp_path / "cache"
    root.mkdir()
    write_sp_model(str(root / "v3_e2e_rnnt_tokenizer.model"), pieces)
    model = gt.load_model("v3_e2e_rnnt", device="cpu", init="random",
                          download_root=str(root))
    assert not model.tokenizer.charwise
    assert len(model.tokenizer) == len(pieces)
    assert model.cfg.head.joint.num_classes == len(pieces) + 1
    assert model.cfg.head.decoder.num_classes == len(pieces) + 1
    jm = jx.pkg.load_model("v3_e2e_rnnt", init="random",
                           download_root=str(root))
    assert jm.cfg.head.joint.num_classes == len(pieces) + 1


def test_load_model_positional_order_is_the_jax_packages(tmp_path, jx,
                                                         shrunk_presets):
    """Both functions called positionally: the third argument is the
    download root (a cached tokenizer under it is found), the fourth
    ``init``, the fifth the seed."""
    from gigaam_tpu_torch.decode.tokenizer import write_sp_model

    ours = list(inspect.signature(gt.load_model).parameters)
    theirs = list(inspect.signature(jx.pkg.load_model).parameters)
    assert ours == theirs
    root = tmp_path / "cache"
    root.mkdir()
    write_sp_model(str(root / "v3_e2e_ctc_tokenizer.model"), sp_pieces())
    a = gt.load_model("e2e_ctc", "cpu", str(root), "random", 3)
    b = gt.load_model("e2e_ctc", device="cpu", download_root=str(root),
                      init="random", seed=3)
    jm = jx.pkg.load_model("e2e_ctc", None, str(root), "random", 3)
    assert a.cfg.decoding.model_path == str(root /
                                            "v3_e2e_ctc_tokenizer.model")
    assert jm.cfg.decoding.model_path == a.cfg.decoding.model_path
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n


def test_load_model_places_the_model_on_the_device(tmp_path, monkeypatch):
    cdn_with(tmp_path, monkeypatch,
             {"v3_ctc": (tiny_cfg("ctc", name="v3_ctc"), 0)})
    model = gt.load_model("ctc", "cpu", str(tmp_path / "c"))
    assert all(p.device.type == "cpu" for p in model.parameters())


# ---------------------------------------------------------------------------
# The committed OmegaConf fixture
# ---------------------------------------------------------------------------

def test_real_omegaconf_pickle_fixture(jx):
    """A cfg pickled with the real OmegaConf layout (GLOBALs into
    ``omegaconf.*``, parent back-references, typed value nodes, unresolved
    interpolations), loaded without omegaconf installed: the stubs leave
    ``sys.modules`` as they found it."""
    before = {k for k in sys.modules if k.startswith("omegaconf")}
    ckpt = tck.load_torch_checkpoint(FIXTURE)
    assert {k for k in sys.modules if k.startswith("omegaconf")} == before
    tree = tck._unwrap(ckpt["cfg"])
    assert tree["model_name"] == "v3_ctc"
    assert tree["encoder"]["n_layers"] == 2
    assert tree["encoder"]["flash_attn"] is False
    assert tree["preprocessor"]["dither"] == 0.0
    assert tree["preprocessor"]["center"] is False
    assert tree["decoding"]["model_path"] is None
    assert tree["head"]["_target_"] == "gigaam.decoder.CTCHead"
    voc = tree["decoding"]["vocabulary"]
    assert isinstance(voc, list) and len(voc) == 33 and voc[0] == " "
    assert tree["encoder"]["feat_in"] == "${preprocessor.features}"
    assert tree["head"]["feat_in"] == "${encoder.d_model}"
    tree = tck._resolve_interpolations(tree)
    assert tree["encoder"]["feat_in"] == 64
    assert tree["head"]["feat_in"] == 32

    cfg, params = tck.convert_reference_checkpoint(FIXTURE)
    jcfg, jparams = jx.ck.convert_reference_checkpoint(FIXTURE)
    assert cfg.to_dict() == jcfg.to_dict()
    assert_bit_equal(params, jx.jax.tree.map(np.asarray, jparams))
    assert cfg.model_name == "v3_ctc" and cfg.encoder.feat_in == 64
    assert cfg.head.feat_in == 32 and cfg.preprocessor.center is False
    model = gt.load_model(FIXTURE, device="cpu")
    jm = jx.model.model_class_for(jcfg)(jcfg, params=jparams,
                                        compute_dtype=jx.jnp.float32)
    assert_models_agree(model, jm, "ctc")
    text, _ = model._decode_batch([voice(1.0, 2)], word_timestamps=False)[0]
    assert isinstance(text, str)


def test_omegaconf_fixture_with_real_classes_importable(jx):
    """With omegaconf importable (a user coming from the reference), the
    pickle makes real node objects: ``_unwrap`` duck-types on ``_val`` and
    ``_content`` (the replica classes of
    ``tools/make_omegaconf_fixture.py`` act as the installed package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_omegaconf_fixture",
        os.path.join(os.path.dirname(__file__), "..", "tools",
                     "make_omegaconf_fixture.py"))
    gen = importlib.util.module_from_spec(spec)
    sys.modules["make_omegaconf_fixture"] = gen
    spec.loader.exec_module(gen)
    created = gen._register_replica()
    try:
        ckpt = tck.load_torch_checkpoint(FIXTURE)
        assert type(ckpt["cfg"]).__module__.startswith("omegaconf")
        assert not isinstance(ckpt["cfg"], tck._StubObject)
        cfg, params = tck.convert_reference_checkpoint(FIXTURE, ckpt=ckpt)
        assert cfg.model_name == "v3_ctc" and cfg.encoder.feat_in == 64
        assert cfg.head.feat_in == 32
        jcfg, jparams = jx.ck.convert_reference_checkpoint(FIXTURE)
        assert cfg.to_dict() == jcfg.to_dict()
        assert_bit_equal(params, jx.jax.tree.map(np.asarray, jparams))
    finally:
        for name in created:
            sys.modules.pop(name, None)
        sys.modules.pop("make_omegaconf_fixture", None)


def test_legacy_fused_glu_artifact_migrates(tmp_path):
    """An artifact with the old fused ``pointwise_conv1 {w, b}`` leaves
    loads into the value/gate schema with the same outputs."""
    from gigaam_tpu_torch.weights import save_model

    model = gt.load_model(FIXTURE, device="cpu")
    save_model(model, str(tmp_path / "m"))
    with np.load(str(tmp_path / "m.npz")) as z:
        flat_ = {k: z[k] for k in z.files}
    legacy = {}
    for k, v in flat_.items():
        if k.endswith("pointwise_conv1/w_value"):
            base = k[: -len("w_value")]
            legacy[base + "w"] = np.concatenate([v, flat_[base + "w_gate"]],
                                                axis=-1)
            legacy[base + "b"] = np.concatenate(
                [flat_[base + "b_value"], flat_[base + "b_gate"]], axis=-1)
        elif "pointwise_conv1" not in k:
            legacy[k] = v
    np.savez(str(tmp_path / "legacy.npz"), **legacy)
    shutil.copyfile(str(tmp_path / "m.json"), str(tmp_path / "legacy.json"))
    loaded = gt.load_model(str(tmp_path / "legacy.npz"), device="cpu")
    wav = voice(0.5, 3)
    assert loaded.transcribe(wav).text == model.transcribe(wav).text
    assert flat(params_to_jax(loaded)).keys() == set(flat_)


# ---------------------------------------------------------------------------
# The converters' entry points and the pyannote converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rnnt", "conv1d"])
def test_convert_checkpoint_cli_writes_what_the_jax_package_loads(
        tmp_path, jx, kind, capsys):
    from gigaam_tpu_torch.decode.tokenizer import write_sp_model
    from gigaam_tpu_torch.tools import convert_checkpoint

    cfg = tiny_cfg(kind)
    ckpt = tmp_path / "ref.ckpt"
    write_ckpt(ckpt, cfg, seed=8)
    out = str(tmp_path / "art" / "model")
    argv = [str(ckpt), "--out", out]
    if kind == "rnnt":
        write_sp_model(str(tmp_path / "sp.model"), sp_pieces())
        argv += ["--tokenizer", str(tmp_path / "sp.model")]
    convert_checkpoint.main(argv)
    assert "Converted" in capsys.readouterr().out
    want = jx.ck.convert_reference_checkpoint(str(ckpt))[1]
    jm = jx.pkg.load_model(out)
    assert_bit_equal(jx.jax.tree.map(np.asarray, jm.params),
                     jx.jax.tree.map(np.asarray, want))
    tm = gt.load_model(out, device="cpu")
    assert_bit_equal(params_to_jax(tm), jx.jax.tree.map(np.asarray, want))
    if kind == "rnnt":
        assert os.path.isfile(str(tmp_path / "art" /
                                  "model_tokenizer.model"))
        assert not tm.tokenizer.charwise and not jm.tokenizer.charwise


def test_pyannote_converter_equals_the_jax_one(tmp_path, jx):
    """The same (VADNetConfig, tree) as ``gigaam_tpu.checkpoint.
    convert_pyannote_vad``, bit for bit, from a pyannote-named state dict
    (a Lightning ``model.`` prefix included); the fallback sinc taps equal
    the JAX ones; the CLI's artifact loads in both packages."""
    from test_vad_net import TINY, _torch_state_dict

    from gigaam_tpu_torch.models import vad_net as tvad
    from gigaam_tpu_torch.tools import convert_vad

    sd = _torch_state_dict(TINY, seed=3)
    path = str(tmp_path / "pyannote.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()}}, path)
    cfg, tree = tck.convert_pyannote_vad(path, kernel_size=TINY.sinc_kernel)
    jcfg, jtree = jx.ck.convert_pyannote_vad(path,
                                             kernel_size=TINY.sinc_kernel)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_bit_equal(tree, jx.jax.tree.map(np.asarray, jtree))
    low, band = np.array([200.0, 1000.0]), np.array([100.0, 300.0])
    assert np.array_equal(tck._sinc_taps_fallback(low, band, 251),
                          jx.ck._sinc_taps_fallback(low, band, 251))

    out = str(tmp_path / "vad")
    convert_vad.main([str(tmp_path / "pyannote.ckpt"), "--out", out])
    from gigaam_tpu.models.vad_net import load_vad as jax_load_vad

    jcfg2, jparams = jax_load_vad(out)
    assert dataclasses.asdict(jcfg2)["sinc_kernel"] == 251
    got_cfg, state = tvad.load_vad(out)
    assert got_cfg.lstm_layers == TINY.lstm_layers
    want = tck.convert_pyannote_vad(path)[1]
    assert_bit_equal(jx.jax.tree.map(np.asarray, jparams), want)
    assert set(state) == {"wav_norm", "sinc", "norms", "convs", "lstm",
                          "linear", "classifier"}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_checkpoint.py)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ingested_checkpoint_is_bit_equal_to_its_source(cuda, tmp_path):
    """A full-width v3_ctc of 2 layers on the card, written as a reference
    checkpoint and loaded back: equal parameters, and logits bit-equal
    through K2 (batch 1) and K1 (batch 4)."""
    from gigaam_tpu_torch.models.heads import ctc_log_probs

    cfg = gt.make_preset("v3_ctc")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    src = gt.GigaAMASR(cfg, device=cuda, seed=0)
    path = str(tmp_path / "v3_ctc.ckpt")
    sd = tck.reference_state_dict(params_to_jax(src), cfg)
    torch.save({"cfg": tck.reference_cfg(cfg),
                "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               path)
    got = gt.load_model(path)
    want = dict(src.named_parameters())
    have = dict(got.named_parameters())
    assert have.keys() == want.keys()
    for n, p in want.items():
        assert torch.equal(p, have[n]), n
    for wavs in ([voice(6.0, 0)], [voice(2.0 + i, i) for i in range(4)]):
        with torch.inference_mode():
            a, la = src.encode_batch(wavs)
            b, lb = got.encode_batch(wavs)
            assert torch.equal(la, lb)
            assert torch.equal(ctc_log_probs(src.head, a),
                               ctc_log_probs(got.head, b))

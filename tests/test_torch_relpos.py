"""The port's rel-pos (v1/v2) slice against the JAX package on the CPU in
fp32, on the same weights: the positional tables, ``rel_shift``, K5's plain
version (against the Pallas kernel in interpret mode and its XLA twin),
``relpos_mha``, a 2-layer rel-pos encoder, tiny v2_ctc ``transcribe`` and a
batch of 16, tiny emo ``get_probs``, rel-pos ``embed_audio``, the conv
module's ``layer_norm`` variant, and the weights bridge for v2_ctc and emo
artifacts.

Wherever a positional bias enters, ``pos_bias_u`` and ``pos_bias_v`` are
nonzero and different (the JAX init makes both zero, which would hide a
u/v swap).  Tolerance: atol 1e-4 on valid rows (fp32, the same math summed
in another order); emo probabilities within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigaam_tpu.config import (
    CTCHeadConfig,
    DecodingConfig,
    EmoHeadConfig,
    EncoderConfig,
    FeaturesConfig,
    ModelConfig,
    RU_VOCAB,
)
from gigaam_tpu.models import encoder as jenc
from gigaam_tpu.models.model import GigaAM as JaxSSL
from gigaam_tpu.models.model import GigaAMASR as JaxASR
from gigaam_tpu.models.model import GigaAMEmo as JaxEmo
from gigaam_tpu.models.model import _flatten, save_model
from gigaam_tpu.ops import attention as jattn
from gigaam_tpu.ops import conformer_ops as jops
from gigaam_tpu.ops import pallas_attention as pa

import gigaam_tpu_torch as gt
import gigaam_tpu_torch.models.encoder as tenc
from gigaam_tpu_torch import config as tconfig
from gigaam_tpu_torch.ops import attention as tattn
from gigaam_tpu_torch.ops import conformer_ops as tops
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.weights import params_from_jax

from test_torch_model import (
    assert_same_words,
    jax_ids_frames,
    port_ids_frames,
    voice,
)
from test_torch_weights import assert_bit_exact, jax_layout

ATOL = 1e-4
SHAPES = [(64, 4), (192, 4)]     # the model-API width, and d_h = 48


def t(a):
    return torch.from_numpy(np.array(a))


def encoder_cfg(d_model=64, n_heads=4, n_layers=2):
    return EncoderConfig(feat_in=64, n_layers=n_layers, d_model=d_model,
                         n_heads=n_heads, ff_expansion_factor=2,
                         conv_kernel_size=7, pos_emb_max_len=256,
                         self_attention_model="rel_pos")


def with_pos_biases(params, seed):
    """JAX params with nonzero, different ``pos_bias_u``/``pos_bias_v``
    (stacked [L, H, d_h] under ``encoder/layers`` or [H, d_h] in one
    attention node)."""
    rng = np.random.default_rng(seed)
    attn = (params["encoder"]["layers"]["self_attn"] if "encoder" in params
            else params)
    for name in ("pos_bias_u", "pos_bias_v"):
        shape = attn[name].shape
        attn[name] = jnp.asarray(
            0.5 * rng.standard_normal(shape).astype(np.float32))
    assert not np.array_equal(attn["pos_bias_u"], attn["pos_bias_v"])
    return params


def valid_rows(lengths, t_max):
    return np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]


# ---------------------------------------------------------------------------
# Positional tables and the shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,dim", [(5, 8), (256, 64), (300, 192)])
def test_relpos_table_bit_exact(length, dim):
    np.testing.assert_array_equal(tenc.relpos_table(length, dim),
                                  jenc.relpos_table(length, dim))


def test_pos_tables_relpos_bit_exact_and_kinds_grow_apart():
    """``PosTables.relpos`` equals the JAX slice below and past
    ``pos_emb_max_len``; growing the rotary table neither hides nor shrinks
    the rel-pos one, and the other way round."""
    cfg = encoder_cfg()
    port = tenc.PosTables(tconfig.EncoderConfig(**dataclasses.asdict(cfg)))
    cpu = torch.device("cpu")
    for tt in (7, 256, 300, 40):
        ref = np.asarray(jenc.PosTables(cfg).relpos(tt))
        np.testing.assert_array_equal(port.relpos(tt, cpu).numpy(), ref)
    rot_cfg = dataclasses.replace(cfg, self_attention_model="rotary")
    cos, sin = port.rotary(400, cpu)
    jcos, jsin = jenc.PosTables(rot_cfg).rotary(400)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    rel = port.relpos(350, cpu)
    assert rel.shape == (699, 64)
    np.testing.assert_array_equal(rel.numpy(),
                                  np.asarray(jenc.PosTables(cfg).relpos(350)))
    assert port.rotary(20, cpu)[0].shape == (20, 16)


def test_rel_shift_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 9, 17)).astype(
        np.float32)
    np.testing.assert_array_equal(tattn.rel_shift(t(x)).numpy(),
                                  np.asarray(jattn.rel_shift(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# K5's plain version
# ---------------------------------------------------------------------------

def relpos_case(rng, b, h, tt, dh):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q_u, k, v, q_v = (f32(b, h, tt, dh) for _ in range(4))
    p_heads = f32(h, 2 * tt - 1, dh)
    valid = np.ones((b, tt), bool)
    valid[1, tt * 2 // 3:] = False
    valid[2, 9:] = False
    return q_u, k, v, q_v, p_heads, valid


@pytest.mark.parametrize("tt,dh", [(96, 48), (130, 16)])
def test_k5_plain_matches_pallas_and_xla(tt, dh):
    rng = np.random.default_rng(tt)
    q_u, k, v, q_v, p_heads, valid = relpos_case(rng, 3, 4, tt, dh)
    args = [jnp.asarray(a) for a in (q_u, k, v, q_v, p_heads, valid)]
    ref_pallas = np.asarray(pa.fused_relpos_mha(*args, interpret=True))
    ref_xla = np.asarray(pa._xla_relpos(*args, 1.0 / np.sqrt(dh)))
    got = fa.fused_relpos_mha(*(t(a) for a in (q_u, k, v, q_v, p_heads,
                                                valid))).numpy()
    for b, n in enumerate(valid.sum(1)):
        np.testing.assert_allclose(got[b, :, :n], ref_pallas[b, :, :n],
                                   atol=ATOL, err_msg=f"Pallas, row {b}")
        np.testing.assert_allclose(got[b, :, :n], ref_xla[b, :, :n],
                                   atol=ATOL, err_msg=f"XLA twin, row {b}")


def test_k5_plain_tells_u_from_v_and_the_shift_direction():
    """Swapping q_u and q_v, or reversing the position table, moves the
    output far beyond the tolerance: the comparisons above can see both."""
    rng = np.random.default_rng(7)
    q_u, k, v, q_v, p_heads, valid = (t(a) for a in relpos_case(
        rng, 3, 4, 40, 16))
    ref = fa.relpos_mha_plain(q_u, k, v, q_v, p_heads, valid)
    for bad in (fa.relpos_mha_plain(q_v, k, v, q_u, p_heads, valid),
                fa.relpos_mha_plain(q_u, k, v, q_v, p_heads.flip(1), valid)):
        assert float((bad - ref)[0].abs().max()) > 100 * ATOL


def test_k5_cuda_path_rejects_what_the_kernel_does_not_take():
    rng = np.random.default_rng(8)
    q_u, k, v, q_v, p_heads, valid = (t(a) for a in relpos_case(
        rng, 3, 2, 8, 48))
    bf = [a.to(torch.bfloat16) for a in (q_u, k, v, q_v, p_heads)]
    with pytest.raises(ValueError, match="bfloat16"):
        fa._check_relpos_args(q_u, k, v, q_v, p_heads, valid)
    with pytest.raises(ValueError, match="p_heads has shape"):
        fa._check_relpos_args(*bf[:4], bf[4][:, :-1].contiguous(), valid)
    # inputs that require a gradient are taken: K5 carries one (K6)
    fa._check_relpos_args(bf[0].requires_grad_(), *bf[1:], valid)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_relpos_args(bf[0].transpose(1, 2).contiguous()
                              .transpose(1, 2), *bf[1:], valid)
    leaves = [a.clone().requires_grad_() for a in (q_u, k, v, q_v, p_heads)]
    grads = torch.autograd.grad(
        fa.fused_relpos_mha(*leaves, valid).sum(), leaves)
    assert all(float(g.abs().max()) > 0 for g in grads)


def test_k5_cpu_calls_do_not_count_launches():
    rng = np.random.default_rng(9)
    before = fa.fused_relpos_mha.launches
    fa.fused_relpos_mha(*(t(a) for a in relpos_case(rng, 3, 2, 12, 16)))
    assert fa.fused_relpos_mha.launches == before
    assert fa.fused_relpos_mha in fa.KERNELS


# ---------------------------------------------------------------------------
# relpos_mha and the encoder
# ---------------------------------------------------------------------------

def jax_encoder_and_port(cfg, seed=0):
    params = jenc.init_encoder_params(jax.random.PRNGKey(seed), cfg)
    params = with_pos_biases({"encoder": params}, seed)["encoder"]
    state = params_from_jax({"encoder": jax.tree.map(np.asarray, params)})
    port = tenc.ConformerEncoder(
        tconfig.EncoderConfig(**dataclasses.asdict(cfg)), state["encoder"])
    return params, port


@pytest.mark.parametrize("d_model,n_heads", SHAPES)
@pytest.mark.parametrize("use_fused", [False, True])
def test_relpos_mha_matches_jax(d_model, n_heads, use_fused):
    """``use_fused`` routes the core through K5 (its plain version on the
    CPU); both must equal the JAX composed path on valid rows."""
    cfg = encoder_cfg(d_model, n_heads)
    params, enc = jax_encoder_and_port(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 50, d_model)).astype(np.float32)
    valid = valid_rows([50, 31], 50)
    pos = jenc.PosTables(cfg).relpos(50)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    ref = np.asarray(jattn.relpos_mha(lp["self_attn"], jnp.asarray(x), pos,
                                      jnp.asarray(valid), n_heads))
    got = tattn.relpos_mha(enc.layers[0]["self_attn"], t(x), t(pos),
                           t(valid), n_heads, use_fused=use_fused).numpy()
    for b, n in enumerate(valid.sum(1)):
        np.testing.assert_allclose(got[b, :n], ref[b, :n], atol=ATOL)


@pytest.mark.parametrize("d_model,n_heads", SHAPES)
@pytest.mark.parametrize("batch,t_feat", [(3, 121), (16, 97)])
def test_relpos_encoder_matches_jax(monkeypatch, d_model, n_heads, batch,
                                    t_feat):
    """The whole rel-pos encoder against ``conformer_forward`` on valid
    frames of a variable-length batch; every layer goes through K5 and
    none through the rotary kernels."""
    calls = []
    plain_k5 = fa.fused_relpos_mha
    monkeypatch.setattr(fa, "fused_relpos_mha",
                        lambda *a: calls.append(1) or plain_k5(*a))
    for name in ("folded_rotary_attention", "folded_rotary_attention_lnres"):
        monkeypatch.setattr(tenc, name, None)
    monkeypatch.setattr(fa, "fused_mha", None)

    cfg = encoder_cfg(d_model, n_heads)
    params, enc = jax_encoder_and_port(cfg, seed=3)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((batch, t_feat, 64)).astype(np.float32)
    lengths = np.linspace(t_feat, t_feat // 3, batch).astype(np.int32)
    t_sub = jops.static_subsampled_length(t_feat, 2)
    ref, ref_len, _ = jenc.conformer_forward(
        params, jnp.asarray(feats), jnp.asarray(lengths), cfg,
        jenc.PosTables(cfg).relpos(t_sub))
    got, got_len, _ = tenc.conformer_forward(
        enc, t(feats), t(lengths), enc.cfg,
        tenc.PosTables(enc.cfg).relpos(t_sub, torch.device("cpu")))
    assert len(calls) == cfg.n_layers
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    ref = np.asarray(ref)
    for b, n in enumerate(np.asarray(ref_len)):
        np.testing.assert_allclose(got[b, :n].numpy(), ref[b, :n], atol=ATOL)


def test_conv1d_subsampling_is_refused():
    cfg = tconfig.EncoderConfig(subsampling="conv1d")
    with pytest.raises(NotImplementedError, match="conv1d"):
        tenc.ConformerEncoder(cfg, {"pre_encode": {}, "layers": []})


def test_random_init_has_the_rel_pos_leaves():
    cfg = gt.make_preset("v2_ctc")
    cfg.encoder = tconfig.EncoderConfig(n_layers=1, d_model=64, n_heads=4,
                                        ff_expansion_factor=2,
                                        self_attention_model="rel_pos")
    cfg.head.feat_in = 64
    attn = gt.GigaAMASR(cfg, device="cpu").encoder.layers[0]["self_attn"]
    assert "b" not in attn["linear_pos"] and "pos_bias_u" in attn
    assert attn["linear_pos"]["w"].shape == (64, 64)
    assert attn["pos_bias_u"].shape == attn["pos_bias_v"].shape == (4, 16)


# ---------------------------------------------------------------------------
# v2_ctc and emo models
# ---------------------------------------------------------------------------

def tiny_encoder(d_model):
    return EncoderConfig(feat_in=64, n_layers=2, d_model=d_model, n_heads=4,
                         ff_expansion_factor=2, conv_kernel_size=7,
                         pos_emb_max_len=256, self_attention_model="rel_pos")


def v2_cfg(d_model=64):
    return ModelConfig(
        model_name="tiny_v2_ctc", model_class="asr",
        preprocessor=FeaturesConfig(center=True),
        encoder=tiny_encoder(d_model),
        head=CTCHeadConfig(feat_in=d_model, num_classes=len(RU_VOCAB) + 1),
        decoding=DecodingConfig(kind="ctc_greedy", vocabulary=list(RU_VOCAB)))


def emo_cfg(d_model=64):
    return ModelConfig(
        model_name="tiny_emo", model_class="emo",
        preprocessor=FeaturesConfig(), encoder=tiny_encoder(d_model),
        head=EmoHeadConfig(feat_in=d_model, num_classes=4),
        id2name=["angry", "sad", "neutral", "positive"])


def port_of(jm):
    cfg = gt.ModelConfig.from_dict(jm.cfg.to_dict())
    state = gt.params_from_jax(jax.tree.map(np.asarray, jm.params))
    return gt.model_class_for(cfg)(cfg, state=state, device="cpu")


def jax_model(cls, cfg, seed):
    jm = cls(cfg, seed=seed)
    jm.params = with_pos_biases(jm.params, seed)
    return jm


@pytest.fixture(scope="module")
def v2_pair():
    jm = jax_model(JaxASR, v2_cfg(), seed=5)
    return jm, port_of(jm)


@pytest.mark.parametrize("d_model", [64, 192])
def test_v2_transcribe_matches_jax(d_model):
    jm = jax_model(JaxASR, v2_cfg(d_model), seed=6)
    tm = port_of(jm)
    wav = voice(3.0, np.random.default_rng(10))
    ref = jm.transcribe(wav, word_timestamps=True)
    got = tm.transcribe(wav, word_timestamps=True)
    assert got.text == ref.text
    assert_same_words(got.words, ref.words)
    ref_pairs, ref_lp, ref_len = jax_ids_frames(jm, [wav])
    got_pairs, got_lp, got_len = port_ids_frames(tm, [wav])
    assert got_pairs == ref_pairs
    np.testing.assert_array_equal(got_len, ref_len)
    np.testing.assert_allclose(got_lp[0, :ref_len[0]], ref_lp[0, :ref_len[0]],
                               atol=ATOL)


def test_v2_decode_batch_of_16_matches_jax(v2_pair):
    jm, tm = v2_pair
    rng = np.random.default_rng(11)
    wavs = [voice(s, rng) for s in np.linspace(0.7, 3.2, 16)]
    ref = jm._decode_batch(wavs, word_timestamps=True)
    got = tm._decode_batch(wavs, word_timestamps=True)
    assert [t for t, _ in got] == [t for t, _ in ref]
    for (_, gw), (_, rw) in zip(got, ref):
        assert_same_words(gw, rw)
    assert port_ids_frames(tm, wavs)[0] == jax_ids_frames(jm, wavs)[0]


@pytest.mark.parametrize("seconds", [1.3, 4.0])
def test_emo_get_probs_matches_jax(seconds):
    jm = jax_model(JaxEmo, emo_cfg(), seed=12)
    tm = port_of(jm)
    assert isinstance(tm, gt.GigaAMEmo)
    wav = voice(seconds, np.random.default_rng(13))
    ref = jm.get_probs(wav)
    got = tm.get_probs(wav)
    assert list(got) == list(ref) == ["angry", "sad", "neutral", "positive"]
    np.testing.assert_allclose(list(got.values()), list(ref.values()),
                               atol=1e-5)
    assert abs(sum(got.values()) - 1.0) < 1e-5


def test_v2_ssl_embed_audio_matches_jax():
    """The rel-pos encoder behind ``embed_audio`` (v1/v2 SSL)."""
    cfg = dataclasses.replace(v2_cfg(), model_name="tiny_v2_ssl",
                              model_class="ssl", head=None, decoding=None)
    jm = jax_model(JaxSSL, cfg, seed=16)
    tm = port_of(jm)
    assert type(tm) is gt.GigaAM
    wav = voice(2.5, np.random.default_rng(17))
    ref, ref_len = jm.embed_audio(wav, layout="bdt")
    got, got_len = tm.embed_audio(wav, layout="bdt")
    n = int(ref_len[0])
    assert int(got_len[0]) == n
    np.testing.assert_allclose(got[..., :n].numpy(), np.asarray(ref)[..., :n],
                               atol=ATOL)


def test_emo_probs_pool_only_valid_frames():
    from gigaam_tpu.models.heads import emo_probs as jax_emo_probs

    from gigaam_tpu_torch.models.heads import emo_probs

    rng = np.random.default_rng(14)
    enc = rng.standard_normal((3, 20, 8)).astype(np.float32)
    lens = np.array([20, 11, 0], np.int32)
    head = {"proj": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                     "b": rng.standard_normal(4).astype(np.float32)}}
    ref = np.asarray(jax_emo_probs(jax.tree.map(jnp.asarray, head),
                                   jnp.asarray(enc), jnp.asarray(lens)))
    got = emo_probs({"proj": {k: t(a) for k, a in head["proj"].items()}},
                    t(enc), t(lens)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ---------------------------------------------------------------------------
# Weights bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["v2_ctc", "emo"])
def test_artifacts_reload_bit_exact(kind, tmp_path):
    """``save_model`` artifacts and the in-memory tree of a rel-pos model
    reach the port leaf for leaf: ``pos_bias_u``/``pos_bias_v`` per layer
    as [H, d_h], ``linear_pos`` without a bias, the emo head."""
    cls, cfg = (JaxASR, v2_cfg()) if kind == "v2_ctc" else (JaxEmo, emo_cfg())
    jm = jax_model(cls, cfg, seed=15)
    path = str(tmp_path / kind)
    save_model(jm, path)
    want = _flatten(jax.tree.map(np.asarray, jm.params))
    assert "encoder/layers/self_attn/linear_pos/b" not in want
    loaded = gt.load_model(path + ".npz", device="cpu")
    assert type(loaded) is type(port_of(jm))
    assert loaded.cfg.to_dict() == jm.cfg.to_dict()
    stacked = jm.params["encoder"]["layers"]["self_attn"]["pos_bias_v"]
    np.testing.assert_array_equal(
        loaded.encoder.layers[1]["self_attn"]["pos_bias_v"].numpy(),
        np.asarray(stacked[1]))
    for port in (loaded, port_of(jm)):
        assert_bit_exact(jax_layout(port), want)


def test_layer_norm_conv_module_matches_jax():
    """The conv module's ``layer_norm`` variant (Queue 1 item 7; no preset
    uses it)."""
    cfg = dataclasses.replace(encoder_cfg(), conv_norm_type="layer_norm")
    params, enc = jax_encoder_and_port(cfg)
    rng = np.random.default_rng(18)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    valid = valid_rows([40, 23], 40)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    ref, _ = jops.conformer_conv(lp["conv"], jnp.asarray(x),
                                 jnp.asarray(valid), "layer_norm")
    got, _ = tops.conformer_conv(enc.layers[0]["conv"], t(x), t(valid),
                              "layer_norm")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

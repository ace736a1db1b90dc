"""The PyTorch port's encoder modules against the JAX package on the CPU in
fp32, on the same weights: subsampling (tail masking, batch invariance), the
conv module, ``rotary_mha`` (plain and through K3) and the whole encoder
(through K2, K1 and K3 dispatch).  Tolerance: atol 1e-4 (fp32, the same math
summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gigaam_tpu.config import EncoderConfig
from gigaam_tpu.models import encoder as jenc
from gigaam_tpu.ops import attention as jattn
from gigaam_tpu.ops import conformer_ops as jops

import gigaam_tpu_torch.models.encoder as tenc
from gigaam_tpu_torch import config as tconfig
from gigaam_tpu_torch.ops import attention as tattn
from gigaam_tpu_torch.ops import conformer_ops as tops
from gigaam_tpu_torch.weights import params_from_jax

ATOL = 1e-4

# the model-API test shape, and a d_h = 48 case (the CUDA kernels' width)
SHAPES = [(64, 4), (192, 4)]


def encoder_cfg(d_model=64, n_heads=4, n_layers=2):
    return EncoderConfig(feat_in=64, n_layers=n_layers, d_model=d_model,
                         n_heads=n_heads, ff_expansion_factor=2,
                         conv_kernel_size=7, pos_emb_max_len=256)


def port_cfg(cfg):
    """The same config as the port's own dataclass."""
    import dataclasses

    return tconfig.EncoderConfig(**dataclasses.asdict(cfg))


def jax_encoder_and_port(cfg, seed=0):
    params = jenc.init_encoder_params(jax.random.PRNGKey(seed), cfg)
    tree = {"encoder": jax.tree.map(np.asarray, params)}
    state = params_from_jax(tree)["encoder"]
    return params, tenc.ConformerEncoder(port_cfg(cfg), state)


def t(a):
    return torch.from_numpy(np.array(a))


def valid_rows(lengths, t_max):
    return np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]


def test_subsampling_matches_jax_with_tail_masking():
    cfg = encoder_cfg()
    params, enc = jax_encoder_and_port(cfg)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 101, 64)).astype(np.float32)
    feats[1, 60:] = np.log(1e-9)          # the log-mel pad floor
    lengths = np.array([101, 60, 13], np.int32)
    ref, ref_len = jops.striding_subsampling_conv2d(
        params["pre_encode"], jnp.asarray(feats), jnp.asarray(lengths), 2)
    got, got_len = tops.striding_subsampling_conv2d(
        enc.pre_encode, t(feats), t(lengths), 2)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)

    # batch invariance: the short sample alone equals its batched valid rows
    alone, alone_len = tops.striding_subsampling_conv2d(
        enc.pre_encode, t(feats[2:3, :13]), t(lengths[2:]), 2)
    n = int(alone_len[0])
    np.testing.assert_allclose(got[2, :n].numpy(), alone[0, :n].numpy(),
                               atol=ATOL)


def test_conformer_conv_matches_jax():
    cfg = encoder_cfg()
    params, enc = jax_encoder_and_port(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    valid = valid_rows([40, 23], 40)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    ref, _ = jops.conformer_conv(lp["conv"], jnp.asarray(x),
                                 jnp.asarray(valid), "batch_norm")
    got, _ = tops.conformer_conv(enc.layers[0]["conv"], t(x), t(valid),
                              "batch_norm")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("d_model,n_heads", SHAPES)
def test_rotary_matches_jax(d_model, n_heads):
    from gigaam_tpu.ops import rotary as jrot

    from gigaam_tpu_torch.ops import rotary as trot

    cos, sin = jrot.rotary_tables(30, d_model // n_heads, 256.0)
    tcos, tsin = trot.rotary_tables(30, d_model // n_heads, 256.0)
    np.testing.assert_array_equal(tcos, cos)
    np.testing.assert_array_equal(tsin, sin)
    x = np.random.default_rng(5).standard_normal(
        (2, 30, d_model)).astype(np.float32)
    wide = jrot.apply_rotary_wide(jnp.asarray(x), cos, sin, n_heads)
    np.testing.assert_allclose(
        trot.apply_rotary_wide(t(x), t(cos), t(sin), n_heads).numpy(),
        np.asarray(wide), atol=1e-6)
    xh = x.reshape(2, 30, n_heads, -1)
    np.testing.assert_allclose(
        trot.apply_rotary(t(xh), t(cos), t(sin)).numpy(),
        np.asarray(jrot.apply_rotary(jnp.asarray(xh), cos, sin)), atol=1e-6)


@pytest.mark.parametrize("d_model,n_heads", SHAPES)
@pytest.mark.parametrize("use_fused", [False, True])
def test_rotary_mha_matches_jax(d_model, n_heads, use_fused):
    """``use_fused`` routes the SDPA core through K3 (its plain version on
    the CPU); both must equal the JAX composed path on valid rows."""
    cfg = encoder_cfg(d_model, n_heads)
    params, enc = jax_encoder_and_port(cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 50, d_model)).astype(np.float32)
    valid = valid_rows([50, 31], 50)
    tables = jenc.PosTables(cfg)
    cos, sin = tables.rotary(50)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    ref = np.asarray(jattn.rotary_mha(lp["self_attn"], jnp.asarray(x), cos,
                                      sin, jnp.asarray(valid), n_heads))
    got = tattn.rotary_mha(enc.layers[0]["self_attn"], t(x), t(cos), t(sin),
                           t(valid), n_heads, use_fused=use_fused).numpy()
    for b, n in enumerate(valid.sum(1)):
        np.testing.assert_allclose(got[b, :n], ref[b, :n], atol=ATOL)


def run_both(cfg, params, enc, feats, lengths):
    t_sub = jops.static_subsampled_length(feats.shape[1], 2)
    cos, sin = jenc.PosTables(cfg).rotary(t_sub)
    ref, ref_len, _ = jenc.conformer_forward(
        params, jnp.asarray(feats), jnp.asarray(lengths), cfg, (cos, sin))
    pos = tenc.PosTables(enc.cfg).rotary(t_sub, torch.device("cpu"))
    got, got_len, _ = tenc.conformer_forward(enc, t(feats), t(lengths),
                                          enc.cfg, pos)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    return got.numpy(), np.asarray(ref), np.asarray(ref_len)


@pytest.mark.parametrize("d_model,n_heads", SHAPES)
@pytest.mark.parametrize("batch,t_feat,kernel", [
    (2, 121, "folded_rotary_attention"),          # K2: batch < 16
    (16, 121, "folded_rotary_attention_lnres"),   # K1: batch >= 16
    (1, 4101, "fused_mha"),                        # K3: T' = 1026 > 1024
])
def test_encoder_matches_jax(monkeypatch, d_model, n_heads, batch, t_feat,
                             kernel):
    """The whole encoder against ``conformer_forward`` on valid frames, with
    the attention dispatch pinned: only ``kernel`` runs, once per layer."""
    from gigaam_tpu_torch.ops import fused_attention as fa

    calls = {}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for name in ("folded_rotary_attention", "folded_rotary_attention_lnres"):
        monkeypatch.setattr(tenc, name, spy(name, getattr(tenc, name)))
    monkeypatch.setattr(fa, "fused_mha", spy("fused_mha", fa.fused_mha))

    cfg = encoder_cfg(d_model, n_heads)
    params, enc = jax_encoder_and_port(cfg, seed=3)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((batch, t_feat, 64)).astype(np.float32)
    lengths = np.linspace(t_feat, t_feat // 2, batch).astype(np.int32)
    got, ref, ref_len = run_both(cfg, params, enc, feats, lengths)
    assert calls == {kernel: cfg.n_layers}
    for b, n in enumerate(ref_len):
        np.testing.assert_allclose(got[b, :n], ref[b, :n], atol=ATOL)

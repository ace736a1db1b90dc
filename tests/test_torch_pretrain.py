"""BEST-RQ pretraining in the port (``gigaam_tpu_torch/train/pretrain.py``)
against the JAX package's ``SSLPretrainer`` on the CPU in fp32, on the same
encoder weights (the bridge) and numpy-seeded audio.

The port draws from ``torch.Generator``s, which cannot match
``jax.random``: the JAX trainer's quantizer and head go in through the
constructor, and its mask starts and noise through ``sample_starts`` and
``sample_noise`` (a subclass).  With those:

* target ids equal on every frame whose top-2 cosine margin exceeds 1e-5,
  at the default 8192 codes of dim 16 (the frames compared are counted and
  must be at least 95% of the valid ones), from the same features;
* span masks equal exactly, the loss within rtol 1e-4 (the encoders agree
  within ~1e-5), the accuracy equal, and every gradient of the first step
  within 1e-4 of its leaf's largest entry, as the fine-tuner's tests hold;
* the quantizer stays frozen and out of the optimizer, the loss falls on
  two overfit clips, eval is deterministic, the CLI resumes, the artifact
  loads in both packages, and the SSL-to-ASR handoff beats random init.

The test marked ``gpu`` counts the launches of a v3_ssl train step on the
card; it skips without a card.  JAX is imported inside the CPU tests only.
"""

import json
import os

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
from gigaam_tpu_torch.audio import save_wav
from gigaam_tpu_torch.config import EncoderConfig, FeaturesConfig, ModelConfig
from gigaam_tpu_torch.data import write_manifest
from gigaam_tpu_torch.train import pretrain as tpre

MARGIN = 1e-5


def tiny_ssl_cfg():
    return ModelConfig(
        model_name="tiny_ssl", model_class="ssl",
        preprocessor=FeaturesConfig(),
        encoder=EncoderConfig(feat_in=64, n_layers=2, d_model=32, n_heads=4,
                              ff_expansion_factor=2, conv_kernel_size=7,
                              pos_emb_max_len=128))


def tiny_pc(**kw):
    base = dict(lr=2e-3, total_steps=30, precision="fp32", codebook_size=32,
                codebook_dim=8, mask_prob=0.2, mask_span=3)
    base.update(kw)
    return base


def synth_batch(b=2, seconds=1.0, seed=0, ragged=True):
    """Tonal clips (structure to predict); with ``ragged`` the last row is
    shorter than the padded length."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    wavs = np.stack([
        (0.3 * np.sin(2 * np.pi * (200 + 80 * i + 50 * np.sin(3 * t)) * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
        for i in range(b)])
    lens = np.full((b,), n, np.int32)
    if ragged and b > 1:
        lens[-1] = n * 5 // 8
        wavs[-1, lens[-1]:] = 0.0
    return wavs, lens


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp

    import gigaam_tpu
    from gigaam_tpu.config import ModelConfig as JaxModelConfig
    from gigaam_tpu.models.model import GigaAM
    from gigaam_tpu.train import pretrain as jpre

    return types.SimpleNamespace(jax=jax, jnp=jnp, pkg=gigaam_tpu,
                                 GigaAM=GigaAM, pre=jpre,
                                 ModelConfig=JaxModelConfig)


def pair(jx, seed=0, **pc):
    """The JAX trainer and the port's, on the same encoder weights, with
    the JAX quantizer and head put into the port."""
    jcfg = jx.ModelConfig.from_dict(tiny_ssl_cfg().to_dict())
    jm = jx.GigaAM(jcfg, seed=seed, compute_dtype=jx.jnp.float32)
    jpt = jx.pre.SSLPretrainer(jm, jx.pre.PretrainConfig(**tiny_pc(**pc)))
    host = jx.jax.tree.map(np.asarray, jpt.params)
    tm = gt.GigaAM(tiny_ssl_cfg(), state=gt.params_from_jax(host),
                   device="cpu")
    tpt = Injected(tm, tpre.PretrainConfig(**tiny_pc(**pc)),
                   quantizer=host["quantizer"], ssl_head=host["ssl_head"])
    return jpt, tpt


class Injected(tpre.SSLPretrainer):
    """The port's trainer drawing the JAX trainer's starts and noise."""

    starts = noise = None

    def sample_starts(self, b, t_sub, gen):
        return torch.from_numpy(np.array(self.starts))

    def sample_noise(self, shape, gen):
        return torch.from_numpy(np.array(self.noise))


def jax_draws(jx, jpt, rng, batch):
    """The starts and noise that ``jpt._forward_loss(..., rng)`` draws."""
    feats, _ = jpt.frontend.forward(jx.jnp.asarray(batch[0]),
                                    jx.jnp.asarray(batch[1]))
    b, f, t_feat = feats.shape
    t_sub = jpt._static_t_sub(t_feat)
    rng_mask, rng_noise = jx.jax.random.split(rng)
    starts = jx.jax.random.bernoulli(rng_mask, jpt.pc.mask_prob, (b, t_sub))
    noise = jpt.pc.noise_std * jx.jax.random.normal(
        rng_noise, (b, t_feat, f), jx.jnp.float32)
    return np.asarray(starts), np.asarray(noise)


def test_targets_match_jax_past_near_ties(jx):
    """At 8192 codes of dim 16, from the JAX frontend's features."""
    jpt, tpt = pair(jx, codebook_size=8192, codebook_dim=16)
    wavs, lens = synth_batch(b=3, seconds=2.0, seed=1)
    feats, feat_lens = jpt.frontend.forward(jx.jnp.asarray(wavs),
                                            jx.jnp.asarray(lens))
    feats = jx.jnp.transpose(feats, (0, 2, 1)).astype(jx.jnp.float32)
    t_sub = jpt._static_t_sub(feats.shape[1])
    ref, ref_n = jpt._targets(jpt.params, feats, feat_lens, t_sub)
    tf, tl = torch.from_numpy(np.array(feats)), torch.from_numpy(
        np.array(feat_lens))
    got, n_codes = tpt._targets(tf, tl, t_sub)
    assert n_codes == ref_n and got.shape == (3, t_sub)
    sims = tpt._code_similarities(tf, tl, t_sub)
    top2 = sims.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > MARGIN
    sub_lens = np.asarray(jx.pkg.ops.conformer_ops.subsampled_length(
        feat_lens, 2, 3))
    valid = np.arange(n_codes)[None, :] < sub_lens[:, None]
    compared = clear.numpy() & valid
    print(f"targets compared on {int(compared.sum())} of {int(valid.sum())} "
          f"valid frames (top-2 margin > {MARGIN})")
    assert compared.sum() >= 0.95 * valid.sum()
    np.testing.assert_array_equal(got[:, :n_codes].numpy()[compared],
                                  np.asarray(ref)[:, :n_codes][compared])
    assert len(np.unique(got.numpy())) > 3
    again, _ = tpt._targets(tf, tl, t_sub)
    assert torch.equal(again, got)


def test_mask_spans_match_jax(jx):
    jpt, tpt = pair(jx, mask_prob=0.1, mask_span=4)
    key = jx.jax.random.PRNGKey(0)
    sub_lens = np.array([50, 20], np.int32)
    ref = np.asarray(jpt._sample_mask(key, 2, 50, jx.jnp.asarray(sub_lens)))
    tpt.starts = jx.jax.random.bernoulli(key, 0.1, (2, 50))
    got = tpt._sample_mask(2, 50, torch.from_numpy(sub_lens), tpt.gen)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not ref[1, 20:].any() and ref.any()
    # the port's own draws: spans of at least mask_span frames
    own = tpre.SSLPretrainer(tpt.model, tpt.pc)
    mask = own._sample_mask(2, 50, torch.from_numpy(sub_lens), own.gen)
    assert not mask[1, 20:].any()
    assert 0.05 < float(mask[0].float().mean()) < 0.9


@pytest.mark.parametrize("train", [True, False])
def test_loss_accuracy_and_gradients_match_jax(jx, train):
    jpt, tpt = pair(jx, seed=2)
    batch = synth_batch(b=3, seconds=1.5, seed=2)
    rng = jx.jax.random.PRNGKey(5)
    tpt.starts, tpt.noise = jax_draws(jx, jpt, rng, batch)
    jb = tuple(jx.jnp.asarray(x) for x in batch)

    def jloss(p):
        loss, (_, acc, _) = jpt._forward_loss(p, jb, rng, train=train)
        return loss, acc

    (ref_loss, ref_acc), ref_g = jx.jax.value_and_grad(jloss, has_aux=True)(
        jpt.params)
    if not train:
        with torch.no_grad():
            loss, (_, acc, _) = tpt._forward_loss(tpt._to_device(batch),
                                                  False)
        np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
        assert float(acc) == float(ref_acc)
        return
    # no clip, and the first update has lr 0: .grad stays as backward left
    # it, and no parameter moves
    tpt.tc.grad_clip = 1e30
    m = tpt.train_step(batch)
    np.testing.assert_allclose(float(m["loss"]), float(ref_loss), rtol=1e-4)
    ref = {f"encoder.{k}": v for k, v in flat_port(jx, ref_g["encoder"])
           .items()}
    ref.update({f"ssl_head.{k}": torch.from_numpy(np.asarray(v))
                for k, v in ref_g["ssl_head"].items()})
    floor = 1e-3 * max(float(r.abs().max()) for r in ref.values())
    named = dict(tpt._named_parameters())
    assert sorted(named) == sorted(ref)
    for name, p in named.items():
        if "batch_norm" in name and name.endswith((".mean", ".var")):
            continue
        r = ref[name]
        tol = 1e-4 * max(float(r.abs().max()), floor)
        if name.endswith("depthwise_conv.b"):     # BatchNorm removes it
            tol = 1e-2 * floor
        assert float((p.grad - r).abs().max()) <= tol, name


def flat_port(jx, enc_tree):
    """A JAX encoder tree (gradients) -> {named_parameters name: tensor} of
    the port's encoder."""
    from test_torch_training import flat_state

    state = gt.params_from_jax({"encoder": jx.jax.tree.map(np.asarray,
                                                            enc_tree)})
    return flat_state(state["encoder"])


def test_quantizer_frozen_and_loss_falls(jx):
    pt = tpre.SSLPretrainer(gt.GigaAM(tiny_ssl_cfg(), device="cpu", seed=0),
                            tpre.PretrainConfig(**tiny_pc(
                                lr=5e-3, total_steps=60)))
    batch = synth_batch(ragged=False)
    q0 = {k: v.clone() for k, v in pt.quantizer.items()}
    head0 = pt.ssl_head["w"].detach().clone()
    in_opt = {id(p) for g in pt.optimizer.param_groups for p in g["params"]}
    assert not any(id(v) in in_opt for v in pt.quantizer.values())
    assert id(pt.ssl_head["w"]) in in_opt
    losses = [float(pt.train_step(batch)["loss"]) for _ in range(60)]
    for k, v in pt.quantizer.items():
        assert torch.equal(v, q0[k]) and not v.requires_grad, k
    assert not torch.equal(pt.ssl_head["w"].detach(), head0)
    assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
    vl, va = pt.eval_step(batch)
    assert np.isfinite(vl) and 0.0 <= va <= 1.0
    assert pt.eval_step(batch) == (vl, va)


def test_quantizer_draws_follow_the_seed():
    cfg = tiny_ssl_cfg()
    a, b, c = (tpre.SSLPretrainer(gt.GigaAM(cfg, device="cpu"),
                                  tpre.PretrainConfig(**tiny_pc(
                                      quantizer_seed=s)))
               for s in (0, 0, 1))
    assert torch.equal(a.quantizer["proj"], b.quantizer["proj"])
    assert not torch.equal(a.quantizer["proj"], c.quantizer["proj"])
    norms = a.quantizer["codebook"].norm(dim=-1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    limit = np.sqrt(6.0 / (64 * 4 + 8))
    assert float(a.quantizer["proj"].abs().max()) <= limit


def write_set(tmp_path, texts, tonal=True):
    rng = np.random.default_rng(0)
    rows = []
    for i, text in enumerate(texts):
        n = 16000 + 1600 * i
        t = np.arange(n) / 16000.0
        wav = (0.3 * np.sin(2 * np.pi * (220 + 60 * i + 40 * np.sin(3 * t))
                            * t) * tonal
               + 0.02 * rng.standard_normal(n)).astype(np.float32)
        path = str(tmp_path / f"utt{i}.wav")
        save_wav(path, wav)
        rows.append((path, n / 16000.0, text))
    manifest = str(tmp_path / "manifest.tsv")
    write_manifest(manifest, rows)
    return manifest, rows


def test_pretrain_cli_and_resume(tmp_path, jx):
    from gigaam_tpu_torch.weights import save_model

    manifest, rows = write_set(tmp_path, [""] * 4, tonal=False)
    art = str(tmp_path / "tiny_ssl")
    save_model(gt.GigaAM(tiny_ssl_cfg(), device="cpu"), art)
    save_dir = str(tmp_path / "exp")
    args = ["--model_name", art, "--init", "weights", "--device", "cpu",
            "--train_manifest", manifest, "--val_manifest", manifest,
            "--batch_size", "2", "--max_steps", "3", "--lr", "1e-3",
            "--precision", "fp32", "--save_dir", save_dir,
            "--log_every_n_steps", "1", "--save_top_k", "1",
            "--codebook_size", "32", "--codebook_dim", "8",
            "--mask_prob", "0.2", "--mask_span", "3"]
    tpre.main(args)
    assert os.path.exists(os.path.join(save_dir, "final.npz"))
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert {"train", "val"} <= {r["kind"] for r in recs}
    ckpts = [f for f in os.listdir(save_dir) if f.endswith(".ckpt")]
    assert len(ckpts) == 1

    tpre.main(args + ["--resume_from_checkpoint",
                      os.path.join(save_dir, ckpts[0]), "--max_steps", "5"])
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f
                 if json.loads(line)["kind"] == "train"]
    assert steps == [1, 2, 3, 4, 5]

    # the pretrained encoder loads back as an SSL model, in both packages
    m2 = gt.load_model(os.path.join(save_dir, "final"), device="cpu")
    emb, _ = m2.embed_audio(rows[0][0])
    assert torch.isfinite(emb).all()
    jm = jx.pkg.load_model(os.path.join(save_dir, "final"))
    np.testing.assert_allclose(np.asarray(jm.embed_audio(rows[0][0])[0]),
                               emb.numpy(), atol=1e-4)


def test_resume_restores_the_head_quantizer_and_moments(tmp_path):
    kw = tiny_pc(lr=1e-3, total_steps=6)
    batch = synth_batch(seed=4)
    pt = tpre.SSLPretrainer(gt.GigaAM(tiny_ssl_cfg(), device="cpu", seed=1),
                            tpre.PretrainConfig(**kw), seed=3)
    for _ in range(2):
        pt.train_step(batch)
    path = str(tmp_path / "state.ckpt")
    pt.save_checkpoint(path)
    for _ in range(2):
        pt.train_step(batch)
    want = {n: p.detach().clone() for n, p in pt._named_parameters()}

    fresh = tpre.SSLPretrainer(
        gt.GigaAM(tiny_ssl_cfg(), device="cpu", seed=2),
        tpre.PretrainConfig(**dict(kw, quantizer_seed=9)), seed=0)
    fresh.restore_checkpoint(path)
    assert fresh.step == 2
    assert torch.equal(fresh.quantizer["proj"], pt.quantizer["proj"])
    for _ in range(2):
        fresh.train_step(batch)
    for name, p in fresh._named_parameters():
        assert torch.equal(p.detach(), want[name]), name


def test_ssl_to_asr_handoff(tmp_path):
    """Pretrain an SSL encoder (CLI), fine-tune a CTC model from it
    (``--init_encoder_from``, CLI), and beat the same fine-tune from random
    init on the overfit task: the reference's SSL lineage."""
    from test_torch_training import tiny_cfg

    from gigaam_tpu_torch.train import train as train_cli
    from gigaam_tpu_torch.weights import save_model

    texts = ["аб ва", "ба гд", "дг аб", "вг ба"]
    manifest, _ = write_set(tmp_path, texts)
    ssl_cfg = tiny_ssl_cfg()
    ssl_art = str(tmp_path / "tiny_ssl")
    save_model(gt.GigaAM(ssl_cfg, device="cpu", seed=1), ssl_art)
    pre_dir = str(tmp_path / "pre")
    tpre.main(["--model_name", ssl_art, "--init", "weights", "--device",
               "cpu", "--train_manifest", manifest, "--val_manifest",
               manifest, "--batch_size", "4", "--max_steps", "150", "--lr",
               "5e-3", "--precision", "fp32", "--save_dir", pre_dir,
               "--log_every_n_steps", "50", "--codebook_size", "32",
               "--codebook_dim", "8", "--mask_prob", "0.3", "--mask_span",
               "3"])
    with open(os.path.join(pre_dir, "metrics.jsonl")) as f:
        vals = [json.loads(line) for line in f]
    final_acc = [r for r in vals if r["kind"] == "val"][-1]["mask_acc"]
    assert final_acc > 0.8, final_acc

    cfg = gt.ModelConfig.from_dict(tiny_cfg("rotary").to_dict())
    cfg.encoder = ssl_cfg.encoder
    cfg.head.feat_in = ssl_cfg.encoder.d_model
    ctc_art = str(tmp_path / "tiny_ctc")
    save_model(gt.GigaAMASR(cfg, device="cpu", seed=0), ctc_art)
    common = ["--model_name", ctc_art + ".npz", "--device", "cpu",
              "--train_manifest", manifest, "--val_manifest", manifest,
              "--batch_size", "2", "--max_steps", "30", "--lr", "3e-3",
              "--precision", "fp32", "--log_every_n_steps", "15",
              "--save_top_k", "1"]
    losses = {}
    for label, extra in (("pre", ["--init_encoder_from",
                                  os.path.join(pre_dir, "final.npz")]),
                         ("rand", [])):
        out = str(tmp_path / f"ft_{label}")
        train_cli.main(common + ["--save_dir", out] + extra)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses[label] = [json.loads(line) for line in f
                             if json.loads(line)["kind"] == "val"][-1]["loss"]
    assert np.isfinite(losses["pre"]) and np.isfinite(losses["rand"])
    assert losses["pre"] < losses["rand"], losses


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_pretrain.py)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_ssl_train_step_launches(cuda):
    """A v3_ssl of 2 layers at full width, bf16 over fp32 masters: K3
    forward and K4 backward once per layer a step, no fold; eval through
    K1; the quantizer never moves."""
    import dataclasses

    from gigaam_tpu_torch.ops import fused_attention as fa

    cfg = gt.make_preset("v3_ssl")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    pt = tpre.SSLPretrainer(gt.GigaAM(cfg, device=cuda, seed=0),
                            tpre.PretrainConfig(total_steps=4))
    q0 = pt.quantizer["codebook"].clone()
    batch = synth_batch(b=4, seconds=4.0, seed=6)
    for _ in range(2):
        fa.reset_launch_counts()
        m = pt.train_step(batch)
        assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
        assert (fa.fused_mha.launches, fa.mha_bwd.launches) == (2, 2)
        assert fa.folded_rotary_attention_lnres.launches == 0
    fa.reset_launch_counts()
    loss, acc = pt.eval_step(batch)
    assert fa.folded_rotary_attention_lnres.launches == 2
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert torch.equal(pt.quantizer["codebook"], q0)

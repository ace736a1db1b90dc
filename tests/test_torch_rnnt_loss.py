"""The port's RNNT loss (``gigaam_tpu_torch/ops/rnnt_loss.py``) against the
JAX package's on the CPU in fp32, from inputs drawn with
``numpy.random.default_rng`` and head weights carried by the bridge:

* the wavefront against a textbook numpy alpha recursion and against
  ``gigaam_tpu.ops.rnnt_loss.rnnt_loss_from_log_probs``, values at rtol and
  atol 1e-5; its gradient (the beta recursion of the port's
  ``autograd.Function``) against ``jax.grad`` at atol 1e-5 (gradients of
  size ~1), and ``gradcheck`` in float64;
* the chunked joint's blank and emit log-probs at time chunks 1, 4 and 64
  against the JAX function and the full lattice, atol 1e-5;
* ``rnnt_loss`` end to end, the loss and the gradients of every head leaf
  and of the encoder output against ``jax.value_and_grad`` (rtol 1e-5,
  atol 1e-5), with rows of zero frames (left out of the mean), empty
  transcripts, and more targets than frames;
* the sentinel arithmetic: ``logaddexp(-1e30, -1e30)`` and its gradient
  stay finite.

The tests marked ``gpu`` run the RNNT ``FineTuner`` on the card (K3/K4
launches per step, with and without activation checkpointing, ``"dots"``
against ``"full"`` in bf16); they skip without a card.  JAX is imported
inside the CPU tests only (``pytest --noconftest -m gpu`` on the card).
"""

import numpy as np
import pytest
import torch

from gigaam_tpu_torch.config import (
    RNNTDecoderConfig,
    RNNTHeadConfig,
    RNNTJointConfig,
)
from gigaam_tpu_torch.models import heads
from gigaam_tpu_torch.ops import rnnt_loss as trl
from gigaam_tpu_torch.weights import sub_block_from_jax

ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp

    from gigaam_tpu import config as jcfg
    from gigaam_tpu.models import heads as jheads
    from gigaam_tpu.ops import rnnt_loss as jrl

    return types.SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, heads=jheads,
                                 rl=jrl)


def numpy_rnnt_forward(blank_lp, emit_lp, t_len, u_len):
    """Textbook alpha recursion, per sample, in float64."""
    losses = []
    for bi in range(blank_lp.shape[0]):
        t_b, u_b = int(t_len[bi]), int(u_len[bi])
        alpha = np.full((t_b, u_b + 1), -np.inf)
        alpha[0, 0] = 0.0
        for t in range(t_b):
            for u in range(u_b + 1):
                if t == 0 and u == 0:
                    continue
                cands = []
                if t > 0:
                    cands.append(alpha[t - 1, u] + blank_lp[bi, t - 1, u])
                if u > 0:
                    cands.append(alpha[t, u - 1] + emit_lp[bi, t, u - 1])
                alpha[t, u] = np.logaddexp.reduce(cands)
        losses.append(-(alpha[t_b - 1, u_b] + blank_lp[bi, t_b - 1, u_b]))
    return np.array(losses)


def lattice(seed, b=3, t=9, u1=6):
    rng = np.random.default_rng(seed)
    blank = np.log(rng.uniform(0.05, 0.9, (b, t, u1))).astype(np.float32)
    emit = np.log(rng.uniform(0.05, 0.9, (b, t, u1))).astype(np.float32)
    emit[:, :, -1] = trl.NEG              # no emission out of the last row
    return blank, emit


# (T_b, U_b) per row: full, shorter, an empty transcript, and U_b > T_b
LENGTHS = {
    "ragged": ([9, 6, 4], [5, 3, 0]),
    "more_targets_than_frames": ([2, 9, 1], [5, 5, 4]),
    "single_frame": ([1, 1, 9], [0, 2, 5]),
}


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_wavefront_matches_numpy_and_jax(jx, case):
    blank, emit = lattice(0)
    t_len, u_len = (np.array(x, np.int32) for x in LENGTHS[case])
    got = trl.rnnt_loss_from_log_probs(
        torch.tensor(blank), torch.tensor(emit), torch.tensor(t_len),
        torch.tensor(u_len)).numpy()
    ref = np.asarray(jx.rl.rnnt_loss_from_log_probs(
        jx.jnp.asarray(blank), jx.jnp.asarray(emit), jx.jnp.asarray(t_len),
        jx.jnp.asarray(u_len)))
    oracle = numpy_rnnt_forward(blank.astype(np.float64),
                                emit.astype(np.float64), t_len, u_len)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_wavefront_gradient_matches_jax_grad(jx, case):
    """The beta recursion against XLA's autodiff of the JAX wavefront; the
    rows weigh 1, 2 and 3, so that each row's upstream gradient shows."""
    blank, emit = lattice(1)
    t_len, u_len = (np.array(x, np.int32) for x in LENGTHS[case])
    w = np.array([1.0, 2.0, 3.0], np.float32)
    ref = jx.jax.grad(lambda bl, em: (jx.rl.rnnt_loss_from_log_probs(
        bl, em, jx.jnp.asarray(t_len), jx.jnp.asarray(u_len)) * w).sum(),
        argnums=(0, 1))(jx.jnp.asarray(blank), jx.jnp.asarray(emit))
    bt = torch.tensor(blank, requires_grad=True)
    et = torch.tensor(emit, requires_grad=True)
    (trl.rnnt_loss_from_log_probs(bt, et, torch.tensor(t_len),
                                  torch.tensor(u_len))
     * torch.tensor(w)).sum().backward()
    for got, want in ((bt.grad, ref[0]), (et.grad, ref[1])):
        assert float(np.abs(np.asarray(want)).max()) > 0.1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wavefront_gradcheck_float64():
    blank, emit = lattice(2, b=2, t=5, u1=4)
    args = (torch.tensor(blank, dtype=torch.float64, requires_grad=True),
            torch.tensor(emit, dtype=torch.float64, requires_grad=True),
            torch.tensor([5, 3]), torch.tensor([3, 1]))
    assert torch.autograd.gradcheck(trl.rnnt_loss_from_log_probs, args)


def test_sentinel_arithmetic_stays_finite():
    neg = torch.full((3,), trl.NEG, requires_grad=True)
    out = torch.logaddexp(neg, neg.detach().clone().requires_grad_())
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(neg.grad).all()
    neg32 = torch.tensor(trl.NEG)
    assert bool(neg32 + torch.tensor(-7.0) == neg32)


def head_cfg(v=8, h=16, d=12):
    return RNNTHeadConfig(
        decoder=RNNTDecoderConfig(pred_hidden=h, pred_rnn_layers=2,
                                  num_classes=v),
        joint=RNNTJointConfig(enc_hidden=d, pred_hidden=h, joint_hidden=h,
                              num_classes=v))


def jax_head(jx, seed=3):
    cfg = head_cfg()
    jcfg = jx.cfg.RNNTHeadConfig(
        decoder=jx.cfg.RNNTDecoderConfig(**vars(cfg.decoder)),
        joint=jx.cfg.RNNTJointConfig(**vars(cfg.joint)))
    return jx.jax.tree.map(np.asarray, jx.heads.init_rnnt_head(
        jx.jax.random.PRNGKey(seed), jcfg)), cfg


def port_head(tree, requires_grad=False):
    return jax_tree_map(lambda a: torch.tensor(a, requires_grad=requires_grad),
                        tree)


def jax_tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: jax_tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_chunked_blank_emit_matches_jax(jx, chunk):
    params, cfg = jax_head(jx)
    v = cfg.joint.num_classes
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, 11, 12)).astype(np.float32)
    tgt = rng.integers(0, v - 1, (2, 4)).astype(np.int32)
    jp = jx.jax.tree.map(jx.jnp.asarray, params)
    pred = jx.heads.rnnt_predict_sequence(jp, jx.jnp.asarray(tgt))
    ref = jx.rl.rnnt_blank_emit_log_probs(jp, jx.jnp.asarray(enc), pred,
                                          jx.jnp.asarray(tgt), v - 1,
                                          time_chunk=chunk)
    head = sub_block_from_jax(params)
    tpred = heads.rnnt_predict_sequence(head, torch.tensor(tgt).long())
    got = trl.rnnt_blank_emit_log_probs(head, torch.tensor(enc), tpred,
                                        torch.tensor(tgt), v - 1,
                                        time_chunk=chunk)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)
    # the full lattice, gathered at once
    lp = torch.log_softmax(heads.rnnt_joint_logits(head, torch.tensor(enc),
                                                   tpred), dim=-1)
    np.testing.assert_allclose(got[0].numpy(), lp[..., v - 1].numpy(),
                               atol=ATOL)
    emit = lp[:, :, :4].gather(-1, torch.tensor(tgt).long()[:, None, :, None]
                               .expand(-1, 11, -1, -1))[..., 0]
    np.testing.assert_allclose(got[1][:, :, :4].numpy(), emit.numpy(),
                               atol=ATOL)
    assert (got[1][:, :, 4] == trl.NEG).all()


# (logit lengths, target lengths) of a batch of 4 rows at T 10, U 4: ragged
# with an empty transcript, a pad row of zero frames, and more targets than
# frames
LOSS_CASES = {
    "ragged": ([10, 7, 4, 10], [4, 2, 0, 3]),
    "pad_row": ([10, 7, 0, 5], [4, 2, 0, 1]),
    "targets_past_frames": ([2, 3, 10, 1], [4, 4, 1, 2]),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_rnnt_loss_and_gradients_match_jax(jx, case):
    params, cfg = jax_head(jx, seed=5)
    v = cfg.joint.num_classes
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((4, 10, 12)).astype(np.float32)
    tgt = rng.integers(0, v - 1, (4, 4)).astype(np.int32)
    t_len, u_len = (np.array(x, np.int32) for x in LOSS_CASES[case])

    def jloss(p, e):
        return jx.rl.rnnt_loss(p, e, jx.jnp.asarray(tgt),
                               jx.jnp.asarray(t_len), jx.jnp.asarray(u_len),
                               blank_id=v - 1, time_chunk=4)

    ref_loss, (ref_p, ref_e) = jx.jax.value_and_grad(jloss, argnums=(0, 1))(
        jx.jax.tree.map(jx.jnp.asarray, params), jx.jnp.asarray(enc))
    head = port_head(params, requires_grad=True)
    e = torch.tensor(enc, requires_grad=True)
    loss = trl.rnnt_loss(head, e, torch.tensor(tgt), torch.tensor(t_len),
                         torch.tensor(u_len), v - 1, time_chunk=4)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_e), atol=ATOL)
    want = dict(leaves(jx.jax.tree.map(np.asarray, ref_p)))
    got = dict(leaves(head))
    assert got.keys() == want.keys()
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    if case == "pad_row":
        # the pad row is inert: the loss and gradients of the other three
        keep = [0, 1, 3]
        head2 = port_head(params, requires_grad=True)
        only = trl.rnnt_loss(head2, torch.tensor(enc[keep]),
                             torch.tensor(tgt[keep]),
                             torch.tensor(t_len[keep]),
                             torch.tensor(u_len[keep]), v - 1, time_chunk=4)
        only.backward()
        np.testing.assert_allclose(float(only.detach()), float(loss.detach()),
                                   rtol=1e-6)
        for (name, a), (_, b) in zip(leaves(head), leaves(head2)):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                       atol=1e-6, err_msg=name)
        assert float(e.grad[2].abs().max()) == 0.0


def test_rnnt_loss_runs_under_inference_mode():
    """``eval_step`` computes the loss under ``inference_mode``: the chunk
    checkpoints and the ``autograd.Function`` run there without a graph."""
    gen = torch.Generator().manual_seed(0)
    head = heads.init_rnnt_head(gen, head_cfg())
    enc = torch.randn(2, 9, 12, generator=gen)
    args = (head, enc, torch.tensor([[1, 2, 3], [4, 5, 6]]),
            torch.tensor([9, 5]), torch.tensor([3, 1]), 7)
    with torch.inference_mode():
        got = trl.rnnt_loss(*args, time_chunk=4)
    assert float(got) == float(trl.rnnt_loss(*args, time_chunk=4))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest "
                    "--noconftest -m gpu tests/test_torch_rnnt_loss.py)")
    return torch.device("cuda")


def card_trainer(cuda, **tc):
    """A v3_rnnt of 2 layers at full width on the card, bf16 over fp32
    masters, and a batch of 4 clips of 2-4 s with random transcripts."""
    import dataclasses

    import gigaam_tpu_torch as gt
    from gigaam_tpu_torch.train.finetune import FineTuner, TrainConfig

    cfg = gt.make_preset("v3_rnnt")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    model = gt.GigaAMASR(cfg, device=cuda, seed=0)
    rng = np.random.default_rng(0)
    lens = np.array([64000, 48000, 40000, 32000], np.int32)
    wavs = (0.1 * rng.standard_normal((4, 64000))).astype(np.float32)
    for i, n in enumerate(lens):
        wavs[i, n:] = 0.0
    tokens = rng.integers(0, 33, (4, 12)).astype(np.int32)
    batch = (wavs, lens, tokens, np.array([12, 9, 7, 5], np.int32))
    return FineTuner(model, TrainConfig(total_steps=4, grad_clip=1e30, **tc)
                     ), batch


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [None, "full", "dots"])
def test_cuda_rnnt_train_step_launches(cuda, remat):
    from gigaam_tpu_torch.ops import fused_attention as fa

    kw = {} if remat is None else {"activation_checkpointing": True,
                                   "remat_policy": remat}
    ft, batch = card_trainer(cuda, **kw)
    fa.reset_launch_counts()
    m = ft.train_step(batch)
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) > 0
    assert fa.fused_mha.launches == (2 if remat is None else 4)
    assert fa.mha_bwd.launches == 2
    assert fa.folded_rotary_attention.launches == 0
    assert fa.folded_rotary_attention_lnres.launches == 0


@pytest.mark.gpu
def test_cuda_dots_gradients_are_full_in_bf16(cuda):
    """The same step under both policies: the forward is the same, so the
    loss is bit-equal; a gradient differs only where a recomputed product
    is rounded again (bf16: within 1% of each leaf group's norm)."""
    grads, losses = {}, {}
    for remat in ("full", "dots"):
        ft, batch = card_trainer(cuda, activation_checkpointing=True,
                                 remat_policy=remat)
        losses[remat] = float(ft.train_step(batch)["loss"])
        grads[remat] = {n: p.grad.float() for n, p in
                        ft.model.named_parameters() if p.grad is not None}
    assert losses["full"] == losses["dots"]
    for name, g in grads["full"].items():
        err = float((grads["dots"][name] - g).norm())
        assert err <= 1e-2 * float(g.norm()) + 1e-6, name

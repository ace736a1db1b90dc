"""The port's CTC fine-tuning slice against the JAX package on the CPU in
fp32, from the same numpy-seeded inputs and bridged weights.

* K4 and K6: the plain backward versions against the Pallas backward
  kernels in interpret mode and against ``jax.vjp`` of their XLA twins, on
  valid rows at atol 2e-3 / rtol 1e-3 (the tolerance
  ``tests/test_pallas_attention.py`` holds the Pallas kernels to); both also
  in the form their kernels compute, from the forward's saved output and
  log-sum-exp, in fp32 and in bf16 (tolerance at ``BF16_ATOL``);
  the two ``autograd.Function``s against autograd through the plain forward
  (atol 1e-5) and ``gradcheck`` in float64.
* ``batch_norm_train``, ``ctc_loss``, ``ctc_logits``, SpecAugment from JAX's
  own uniform draws, the lr schedule: atol 1e-5 or exact, as stated at each.
* One ``FineTuner`` step: every leaf's gradient within 1e-4 of the leaf's
  largest gradient entry (a bias in front of a BatchNorm has an exactly zero
  gradient, which both packages return as rounding noise: the scale has a
  floor of a thousandth of the largest entry of any leaf); three optimizer
  steps: loss and grad_norm per step
  at rtol 1e-4, the reported lr, the BatchNorm buffers, and the parameters
  after step 3.  AdamW divides a gradient by the root of its
  second moment, so where a gradient is near zero (a bias in front of a
  BatchNorm has an exactly zero one) rounding noise decides the update's
  sign: every element is held to 4 lr (two updates of at most lr, either
  sign), and the elements whose gradient is above a hundredth of the leaf's
  largest to 0.1 lr.  The depthwise bias is such a leaf, and it shifts
  the batch mean that BatchNorm records by its own difference: the buffers
  are held to 1e-5 while lr is 0 and to lr / 2 (momentum 0.1 of at most 4 lr,
  with room) after.
* The folded-weights cache after an optimizer step, the K1/K2 gradient
  guard, ``save_model`` into the JAX package, checkpoint resume, the CLI.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gigaam_tpu
from gigaam_tpu.config import (
    CTCHeadConfig,
    DecodingConfig,
    EncoderConfig,
    FeaturesConfig,
    ModelConfig,
    RU_VOCAB,
)
from gigaam_tpu import data as jdata
from gigaam_tpu import metrics as jmetrics
from gigaam_tpu.models import heads as jheads
from gigaam_tpu.models.model import GigaAMASR as JaxASR
from gigaam_tpu.ops import conformer_ops as jops
from gigaam_tpu.ops import pallas_attention as pa
from gigaam_tpu.ops.ctc_loss import ctc_loss as jax_ctc_loss
from gigaam_tpu.ops.spec_augment import spec_augment as jax_spec_augment
from gigaam_tpu.train import finetune as jft

import gigaam_tpu_torch as gt
from gigaam_tpu_torch import data as tdata
from gigaam_tpu_torch import metrics as tmetrics
from gigaam_tpu_torch.audio import save_wav
from gigaam_tpu_torch.models import heads as theads
from gigaam_tpu_torch.ops import conformer_ops as tops
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.ctc_loss import ctc_loss
from gigaam_tpu_torch.ops.spec_augment import spec_augment_from_draws
from gigaam_tpu_torch.train import finetune as tft
from gigaam_tpu_torch.train import eval as eval_cli
from gigaam_tpu_torch.train import train as train_cli
from gigaam_tpu_torch.weights import (
    init_encoder_from_artifact,
    params_from_jax,
    params_to_jax,
    save_model,
)

from test_torch_relpos import with_pos_biases

KERNEL_ATOL, KERNEL_RTOL = 2e-3, 1e-3
LR = 1e-3


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# K4 and K6: the plain backward versions
# ---------------------------------------------------------------------------

def attention_case(tt, relpos, b=3, h=2, d=48):
    rng = np.random.default_rng(tt + relpos)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    valid = np.ones((b, tt), bool)
    valid[1, tt * 2 // 3:] = False
    valid[2, 10:] = False
    case = {"q": f32(b, h, tt, d), "k": f32(b, h, tt, d), "v": f32(b, h, tt, d)}
    if relpos:
        case["q_v"] = f32(b, h, tt, d)
        case["p"] = f32(h, 2 * tt - 1, d)
    case["do"] = f32(b, h, tt, d)
    return case, valid


def assert_grads_close(names, got, ref, valid):
    for name, g, r in zip(names, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        if name == "dp":                 # every row, summed over the batch
            np.testing.assert_allclose(g, r, atol=KERNEL_ATOL,
                                       rtol=KERNEL_RTOL, err_msg=name)
            continue
        for i, n in enumerate(valid.sum(1)):
            np.testing.assert_allclose(g[i, :, :n], r[i, :, :n],
                                       atol=KERNEL_ATOL, rtol=KERNEL_RTOL,
                                       err_msg=f"{name} row {i}")


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("tt", [128, 130])
def test_mha_bwd_plain_matches_jax(tt, oracle):
    c, valid = attention_case(tt, relpos=False)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    if oracle == "pallas":
        ref = pa._mha_bwd_pallas(j["q"], j["k"], j["v"], j["do"],
                                 jnp.asarray(valid), True)
    else:
        _, vjp = jax.vjp(lambda q, k, v: pa._xla_mha(
            q, k, v, jnp.asarray(valid), 1.0 / np.sqrt(48)),
            j["q"], j["k"], j["v"])
        ref = vjp(j["do"])
    got = fa.mha_bwd(t(c["q"]), t(c["k"]), t(c["v"]), t(c["do"]), t(valid))
    assert_grads_close(("dq", "dk", "dv"), [g.numpy() for g in got], ref,
                       valid)


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("tt", [128, 130])
def test_relpos_bwd_plain_matches_jax(tt, oracle):
    """B = 3, so a ``dp`` that is not summed over the batch shows."""
    c, valid = attention_case(tt, relpos=True)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    if oracle == "pallas":
        ref = pa._relpos_bwd_pallas(j["q"], j["k"], j["v"], j["q_v"], j["p"],
                                    j["do"], jnp.asarray(valid), True)
    else:
        _, vjp = jax.vjp(lambda *a: pa._xla_relpos(
            *a, jnp.asarray(valid), 1.0 / np.sqrt(48)),
            j["q"], j["k"], j["v"], j["q_v"], j["p"])
        ref = vjp(j["do"])
    got = fa.relpos_mha_bwd(t(c["q"]), t(c["k"]), t(c["v"]), t(c["q_v"]),
                            t(c["p"]), t(c["do"]), t(valid))
    assert_grads_close(("dq_u", "dk", "dv", "dq_v", "dp"),
                       [g.numpy() for g in got], ref, valid)
    one = fa.relpos_mha_bwd_plain(*(t(c[k][-1:]) for k in ("q", "k", "v",
                                                            "q_v")),
                                  t(c["p"]), t(c["do"][-1:]), t(valid[-1:]))
    assert not np.allclose(one[4].numpy(), got[4].numpy(), atol=KERNEL_ATOL)


def test_mha_plain_lse_is_the_log_sum_exp_of_the_jax_scores():
    """``mha_plain(..., return_lse=True)`` against ``logsumexp`` of
    ``_xla_mha``'s scores (scaled, key mask added as (mask-1)*1e9), fp32,
    T no multiple of 64; atol 1e-5: the same sum in another order."""
    c, valid = attention_case(130, relpos=False)
    q, k = jnp.asarray(c["q"]), jnp.asarray(c["k"])
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   preferred_element_type=jnp.float32) / np.sqrt(48)
    mask = jnp.asarray(valid)[:, None, None, :].astype(jnp.float32)
    ref = jax.nn.logsumexp(s + (mask - 1.0) * (-pa.NEG_INF), axis=-1)
    out, lse = fa.mha_plain(t(c["q"]), t(c["k"]), t(c["v"]), t(valid),
                            return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (3, 2, 130)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.equal(out, fa.mha_plain(t(c["q"]), t(c["k"]), t(c["v"]),
                                         t(valid)))


# bf16 on both sides: every output is a bf16 value (one rounding, 2^-8
# relative, covered by rtol 2^-7) of sums whose terms were rounded at the
# same points; beyond that the pair form takes D from the bf16 ``out``
# (sum_c do out, each ``out`` entry rounded by up to 2^-9) where the Pallas
# kernel takes it from its fp32 probabilities.  On these gradients (largest
# entries 1.5 to 5.4) that leaves at most 0.007 over the rtol; atol 0.02
BF16_ATOL, BF16_RTOL = 2e-2, 2.0 ** -7


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("tt", [128, 130])
def test_mha_bwd_plain_from_the_saved_pair_matches_jax(tt, oracle, dtype):
    """K4's arithmetic (P = exp(s - lse), D = rowsum(do out)) from the plain
    forward's (out, lse), against the Pallas backward in interpret mode and
    against ``jax.vjp`` of ``_xla_mha``, on ragged ``valid``."""
    c, valid = attention_case(tt, relpos=False)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    j = {k: jnp.asarray(v).astype(jdt) for k, v in c.items()}
    if oracle == "pallas":
        ref = pa._mha_bwd_pallas(j["q"], j["k"], j["v"], j["do"],
                                 jnp.asarray(valid), True)
    else:
        _, vjp = jax.vjp(lambda q, k, v: pa._xla_mha(
            q, k, v, jnp.asarray(valid), 1.0 / np.sqrt(48)),
            j["q"], j["k"], j["v"])
        ref = vjp(j["do"])
    q, k, v, do = (t(c[n]).to(tdt) for n in ("q", "k", "v", "do"))
    out, lse = fa.mha_plain(q, k, v, t(valid), return_lse=True)
    got = fa.mha_bwd(q, k, v, do, t(valid), out, lse)
    assert all(g.dtype == tdt for g in got)
    atol, rtol = ((KERNEL_ATOL, KERNEL_RTOL) if dtype == "fp32"
                  else (BF16_ATOL, BF16_RTOL))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g = g.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        for i, n in enumerate(valid.sum(1)):
            np.testing.assert_allclose(g[i, :, :n], r[i, :, :n], atol=atol,
                                       rtol=rtol, err_msg=f"{name} row {i}")


@pytest.mark.parametrize("tt", [40, 130])
def test_both_forms_of_the_plain_backward_agree_in_fp32(tt):
    """With an fp32 ``out`` D = rowsum(do out) is rowsum(dP P) up to the
    order of the sums: atol 1e-5 on gradients of size ~1."""
    c, valid = attention_case(tt, relpos=False)
    q, k, v, do = (t(c[n]) for n in ("q", "k", "v", "do"))
    pair = fa.mha_plain(q, k, v, t(valid), return_lse=True)
    for g, r in zip(fa.mha_bwd_plain(q, k, v, do, t(valid), *pair),
                    fa.mha_bwd_plain(q, k, v, do, t(valid))):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="both or neither"):
        fa.mha_bwd(q, k, v, do, t(valid), out=pair[0])


def test_fused_mha_saves_the_pair_and_its_backward_uses_it(monkeypatch):
    """Under autograd ``fused_mha`` saves (q, k, v, valid, out, lse) and
    hands the pair to ``mha_bwd``; without a gradient it asks for no lse and
    saves nothing."""
    args, valid, do = function_case(False, torch.float32, 2, 2, 40, 16)
    leaves = [x.clone().requires_grad_() for x in args]
    out = fa.fused_mha(*leaves, valid)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 6
    ref_out, ref_lse = fa.mha_plain(*args, valid, return_lse=True)
    assert torch.equal(saved[4], ref_out) and torch.equal(saved[5], ref_lse)

    seen = {}
    real = fa.mha_bwd

    def spy(q, k, v, do, valid, out=None, lse=None):
        seen["pair"] = (out, lse)
        return real(q, k, v, do, valid, out, lse)

    monkeypatch.setattr(fa, "mha_bwd", spy)
    got = torch.autograd.grad(out, leaves, do)
    assert seen["pair"][0] is not None and torch.equal(seen["pair"][1], ref_lse)
    ref = fa.mha_bwd_plain(*args, do, valid, ref_out, ref_lse)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))

    asked = {}
    real_forward = fa._mha_forward

    def spy_forward(q, k, v, valid, want_lse):
        asked["want_lse"] = want_lse
        return real_forward(q, k, v, valid, want_lse)

    monkeypatch.setattr(fa, "_mha_forward", spy_forward)
    with torch.no_grad():
        plain_out = fa.fused_mha(*leaves, valid)
    assert asked["want_lse"] is False and plain_out.grad_fn is None
    fa.fused_mha(*args, valid)
    assert asked["want_lse"] is False


def test_relpos_mha_plain_lse_is_the_log_sum_exp_of_the_jax_scores():
    """``relpos_mha_plain(..., return_lse=True)`` against ``logsumexp`` of
    ``_xla_relpos``'s scores (q_u.k plus the shifted positional term, scaled,
    key mask added as (mask-1)*1e9), fp32, T no multiple of 64; atol 1e-5:
    the same sums in another order."""
    c, valid = attention_case(130, relpos=True)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    ac = jnp.einsum("bhqd,bhkd->bhqk", j["q"], j["k"],
                    preferred_element_type=jnp.float32)
    bd = jnp.einsum("bhqd,hpd->bhqp", j["q_v"], j["p"],
                    preferred_element_type=jnp.float32)
    b, h, tt, pdim = bd.shape
    bd = jnp.pad(bd, ((0, 0), (0, 0), (0, 0), (1, 0)))
    bd = bd.reshape(b, h, pdim + 1, tt)[:, :, 1:].reshape(b, h, tt, pdim)
    mask = jnp.asarray(valid)[:, None, None, :].astype(jnp.float32)
    s = (ac + bd[..., :tt]) / np.sqrt(48) + (mask - 1.0) * (-pa.NEG_INF)
    ref = jax.nn.logsumexp(s, axis=-1)
    args = [t(c[n]) for n in ("q", "k", "v", "q_v", "p")] + [t(valid)]
    out, lse = fa.relpos_mha_plain(*args, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (3, 2, 130)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref), atol=1e-5)
    assert torch.equal(out, fa.relpos_mha_plain(*args))
    # the output is the JAX twin's: the scores above are the ones it uses
    twin = pa._xla_relpos(j["q"], j["k"], j["v"], j["q_v"], j["p"],
                          jnp.asarray(valid), 1.0 / np.sqrt(48))
    np.testing.assert_allclose(out.numpy(), np.asarray(twin), atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("oracle", ["pallas", "xla"])
@pytest.mark.parametrize("tt", [128, 130])
def test_relpos_bwd_plain_from_the_saved_pair_matches_jax(tt, oracle, dtype):
    """K6's arithmetic (P = exp(s - lse), D = rowsum(do out)) from the plain
    forward's (out, lse), against the Pallas backward in interpret mode and
    against ``jax.vjp`` of ``_xla_relpos``, on ragged ``valid``; fp32 at the
    Pallas tests' own tolerance, bf16 at ``BF16_ATOL`` (the pair form's D
    from the bf16 ``out``, as for K4; dp sums three batch elements, its
    largest entries are ~20, and stays inside the same limits)."""
    c, valid = attention_case(tt, relpos=True)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    j = {k: jnp.asarray(v).astype(jdt) for k, v in c.items()}
    if oracle == "pallas":
        ref = pa._relpos_bwd_pallas(j["q"], j["k"], j["v"], j["q_v"], j["p"],
                                    j["do"], jnp.asarray(valid), True)
    else:
        _, vjp = jax.vjp(lambda *a: pa._xla_relpos(
            *a, jnp.asarray(valid), 1.0 / np.sqrt(48)),
            j["q"], j["k"], j["v"], j["q_v"], j["p"])
        ref = vjp(j["do"])
    q, k, v, q_v, p, do = (t(c[n]).to(tdt)
                           for n in ("q", "k", "v", "q_v", "p", "do"))
    out, lse = fa.relpos_mha_plain(q, k, v, q_v, p, t(valid), return_lse=True)
    got = fa.relpos_mha_bwd(q, k, v, q_v, p, do, t(valid), out, lse)
    assert all(g.dtype == tdt for g in got)
    atol, rtol = ((KERNEL_ATOL, KERNEL_RTOL) if dtype == "fp32"
                  else (BF16_ATOL, BF16_RTOL))
    for name, g, r in zip(("dq_u", "dk", "dv", "dq_v", "dp"), got, ref):
        g = g.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        if name == "dp":
            np.testing.assert_allclose(g, r, atol=atol, rtol=rtol,
                                       err_msg=name)
            continue
        for i, n in enumerate(valid.sum(1)):
            np.testing.assert_allclose(g[i, :, :n], r[i, :, :n], atol=atol,
                                       rtol=rtol, err_msg=f"{name} row {i}")


@pytest.mark.parametrize("tt", [40, 130])
def test_both_forms_of_the_relpos_plain_backward_agree_in_fp32(tt):
    """With an fp32 ``out`` D = rowsum(do out) is rowsum(dP P) up to the
    order of the sums: atol 1e-5 on gradients of size ~1 (dp, a sum over the
    batch and the queries of entries up to ~20: 5e-5).  One of ``out`` /
    ``lse`` without the other is refused."""
    c, valid = attention_case(tt, relpos=True)
    args = [t(c[n]) for n in ("q", "k", "v", "q_v", "p")]
    do = t(c["do"])
    pair = fa.relpos_mha_plain(*args, t(valid), return_lse=True)
    got = fa.relpos_mha_bwd_plain(*args, do, t(valid), *pair)
    ref = fa.relpos_mha_bwd_plain(*args, do, t(valid))
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), r.numpy(),
                                   atol=5e-5 if i == 4 else 1e-5)
    with pytest.raises(ValueError, match="both or neither"):
        fa.relpos_mha_bwd(*args, do, t(valid), out=pair[0])
    with pytest.raises(ValueError, match="both or neither"):
        fa.relpos_mha_bwd_plain(*args, do, t(valid), lse=pair[1])


def test_fused_relpos_mha_saves_the_pair_and_its_backward_uses_it(monkeypatch):
    """Under autograd ``fused_relpos_mha`` saves (q_u, k, v, q_v, p_heads,
    valid, out, lse) and hands the pair to ``relpos_mha_bwd``; without a
    gradient it asks for no lse and saves nothing."""
    args, valid, do = function_case(True, torch.float32, 2, 2, 40, 16)
    leaves = [x.clone().requires_grad_() for x in args]
    out = fa.fused_relpos_mha(*leaves, valid)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 8
    ref_out, ref_lse = fa.relpos_mha_plain(*args, valid, return_lse=True)
    assert torch.equal(saved[6], ref_out) and torch.equal(saved[7], ref_lse)

    seen = {}
    real = fa.relpos_mha_bwd

    def spy(q_u, k, v, q_v, p_heads, do, valid, out=None, lse=None):
        seen["pair"] = (out, lse)
        return real(q_u, k, v, q_v, p_heads, do, valid, out, lse)

    monkeypatch.setattr(fa, "relpos_mha_bwd", spy)
    got = torch.autograd.grad(out, leaves, do)
    assert seen["pair"][0] is not None and torch.equal(seen["pair"][1], ref_lse)
    ref = fa.relpos_mha_bwd_plain(*args, do, valid, ref_out, ref_lse)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))

    asked = {}
    real_forward = fa._relpos_forward

    def spy_forward(q_u, k, v, q_v, p_heads, valid, want_lse):
        asked["want_lse"] = want_lse
        return real_forward(q_u, k, v, q_v, p_heads, valid, want_lse)

    monkeypatch.setattr(fa, "_relpos_forward", spy_forward)
    with torch.no_grad():
        plain_out = fa.fused_relpos_mha(*leaves, valid)
    assert asked["want_lse"] is False and plain_out.grad_fn is None
    fa.fused_relpos_mha(*args, valid)
    assert asked["want_lse"] is False
    # a gradient wanted by the position table alone is enough to save the pair
    only_p = list(args)
    only_p[4] = args[4].clone().requires_grad_()
    fa.fused_relpos_mha(*only_p, valid)
    assert asked["want_lse"] is True


def function_case(relpos, dtype, b, h, tt, d):
    rng = np.random.default_rng(11 + relpos)
    draw = lambda *s: torch.from_numpy(rng.standard_normal(s)).to(dtype)
    args = [draw(b, h, tt, d) for _ in range(4 if relpos else 3)]
    if relpos:
        args.append(draw(h, 2 * tt - 1, d))
    valid = torch.ones(b, tt, dtype=torch.bool)
    valid[-1, tt - 2:] = False
    return args, valid, draw(b, h, tt, d) * valid[:, None, :, None]


@pytest.mark.parametrize("relpos", [False, True])
def test_fused_function_gradient_is_the_plain_forwards(relpos):
    """``fused_mha`` / ``fused_relpos_mha`` on CPU tensors: the Function's
    backward (the plain backward) equals autograd through the plain
    forward."""
    args, valid, do = function_case(relpos, torch.float32, 2, 2, 40, 16)
    fused, plain = ((fa.fused_relpos_mha, fa.relpos_mha_plain) if relpos
                    else (fa.fused_mha, fa.mha_plain))
    a = [x.clone().requires_grad_() for x in args]
    b = [x.clone().requires_grad_() for x in args]
    got = torch.autograd.grad(fused(*a, valid), a, do)
    ref = torch.autograd.grad(plain(*b, valid), b, do)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)
    # a gradient handed over in another layout is made contiguous
    strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    again = torch.autograd.grad(fused(*a, valid), a, strided)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("relpos", [False, True])
def test_fused_function_gradcheck_float64(relpos):
    args, valid, _ = function_case(relpos, torch.float64, 1, 2, 5, 4)
    fused = fa.fused_relpos_mha if relpos else fa.fused_mha
    leaves = [x.requires_grad_() for x in args]
    # padded query rows are garbage by contract: leave them out
    assert torch.autograd.gradcheck(
        lambda *a: fused(*a, valid)[:, :, :3], leaves)


# ---------------------------------------------------------------------------
# The ops around the encoder
# ---------------------------------------------------------------------------

def test_batch_norm_train_matches_jax():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"scale": 1 + 0.1 * f32(24), "bias": 0.1 * f32(24),
         "mean": 0.3 * f32(24), "var": 1 + 0.2 * np.abs(f32(24))}
    x = f32(3, 17, 24) * 2 + 0.5
    x[1, 9:] = 0.0                       # the zeroed padding counts
    ref, ref_stats = jops.batch_norm_train(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got, stats = tops.batch_norm_train({k: t(v) for k, v in p.items()}, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(ref_stats[k]),
                                   atol=1e-6)
        assert not stats[k].requires_grad


CTC_CASES = {
    "ragged": ([20, 13, 7], [[1, 2, 3, 4], [2, 2, 0, 0], [5, 0, 0, 0]],
               [4, 2, 1]),
    "zero_length_row": ([20, 0, 9], [[1, 2, 3, 0], [1, 0, 0, 0], [4, 4, 0, 0]],
                        [3, 1, 2]),
    # row 1: 3 labels with 2 repeats need 5 frames, it has 4
    "infeasible_repeats": ([20, 4, 25], [[1, 2, 3, 0], [3, 3, 3, 0],
                                         [4, 4, 1, 0]], [3, 3, 3]),
    "empty_transcript": ([12, 20, 9], [[0, 0, 0, 0], [1, 2, 0, 0],
                                       [3, 0, 0, 0]], [0, 2, 1]),
}


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_loss_matches_jax(case):
    in_lens, targets, tgt_lens = (np.array(a, np.int32)
                                  for a in CTC_CASES[case])
    in_lens[0] = 99                      # clamped to T
    rng = np.random.default_rng(len(case))
    logits = rng.standard_normal((3, 20, 7)).astype(np.float32) * 2
    blank = 6
    ref, ref_grad = jax.value_and_grad(lambda x: jax_ctc_loss(
        x, jnp.asarray(in_lens), jnp.asarray(targets), jnp.asarray(tgt_lens),
        blank))(jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = ctc_loss(x, t(in_lens), t(targets), t(tgt_lens), blank)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-5)


def test_ctc_logits_matches_jax():
    rng = np.random.default_rng(1)
    p = {"proj": {"w": rng.standard_normal((16, 9)).astype(np.float32),
                  "b": rng.standard_normal(9).astype(np.float32)}}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    ref = jheads.ctc_logits(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = theads.ctc_logits({"proj": {k: t(v) for k, v in p["proj"].items()}},
                            t(x).to(torch.bfloat16).float())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0.1)
    got = theads.ctc_logits({"proj": {k: t(v) for k, v in p["proj"].items()}},
                            t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_spec_augment_from_jax_draws():
    """The JAX function's own uniform draws, reproduced from its key
    splits, give the same mask bit for bit."""
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((4, 64, 90)).astype(np.float32) + 3.0
    ref = np.asarray(jax_spec_augment(key, jnp.asarray(feats), 2, 27, 3, 20))
    draws = []
    for k in jax.random.split(key, 5):
        k1, k2 = jax.random.split(k)
        draws.append([np.asarray(jax.random.uniform(k1, (4,))),
                      np.asarray(jax.random.uniform(k2, (4,)))])
    got = spec_augment_from_draws(t(feats), t(np.array(draws)), 2, 27, 3, 20)
    assert (ref == 0).any() and np.array_equal(got.numpy(), ref)


def test_host_lr_schedule_matches_optax_at_every_step():
    tc = tft.TrainConfig(lr=3e-4, warmup_ratio=0.25, total_steps=20)
    _, schedule = jft.make_optimizer(jft.TrainConfig(
        lr=3e-4, warmup_ratio=0.25, total_steps=20))
    lr = tft.host_lr_schedule(tc)
    jlr = jft.host_lr_schedule(jft.TrainConfig(
        lr=3e-4, warmup_ratio=0.25, total_steps=20))
    for step in range(22):
        assert lr(step) == jlr(step)
        np.testing.assert_allclose(lr(step), float(schedule(step)),
                                   rtol=1e-5, atol=1e-12)
    assert lr(0) == 0.0 and lr(5) == 3e-4
    one = tft.host_lr_schedule(tft.TrainConfig(total_steps=1))
    assert one(0) == 0.0 and one(1) == 1e-4      # decay_steps = warmup + 1


def test_train_config_has_the_jax_fields_and_defaults():
    assert (dataclasses.asdict(tft.TrainConfig())
            == dataclasses.asdict(jft.TrainConfig()))


def test_data_and_metrics_copies_agree(tmp_path):
    rng = np.random.default_rng(2)
    rows = []
    for i, sec in enumerate((0.7, 1.4, 0.9, 2.2, 1.1)):
        path = str(tmp_path / f"c{i}.wav")
        save_wav(path, 0.1 * rng.standard_normal(int(sec * 16000))
                 .astype(np.float32))
        rows.append((path, sec, ["да нет", "привет мир", "Ёж", "а б в", ""][i]))
    tdata.write_manifest(str(tmp_path / "m.tsv"), rows)
    jtok = gigaam_tpu.decode.tokenizer.Tokenizer(list(RU_VOCAB))
    ttok = gt.decode.tokenizer.Tokenizer(list(RU_VOCAB))
    assert ttok.encode("привет, мир") == jtok.encode("привет, мир")
    kw = dict(raw_text=True, return_tokens=True, min_duration=0.8)
    jds = jdata.AudioDataset(str(tmp_path / "m.tsv"), tokenizer=jtok, **kw)
    tds = tdata.AudioDataset(str(tmp_path / "m.tsv"), tokenizer=ttok, **kw)
    assert len(tds) == len(jds) == 4
    bkw = dict(shuffle=True, seed=1, sort_by_duration=True, drop_last=True)
    for got, ref in zip(tdata.prefetch_batches(tds.batches(2, **bkw)),
                        jds.batches(2, **bkw)):
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
    hyps, refs = ["да нет да", "мир", ""], ["да да", "привет мир", "а"]
    assert tmetrics.wer_counts(hyps, refs) == jmetrics.wer_counts(hyps, refs)
    assert tmetrics.compute_wer(hyps, refs) == jmetrics.compute_wer(hyps, refs)


# ---------------------------------------------------------------------------
# FineTuner
# ---------------------------------------------------------------------------

def tiny_cfg(kind):
    rotary = kind == "rotary"
    return ModelConfig(
        model_name=f"tiny_{kind}_ctc", model_class="asr",
        preprocessor=FeaturesConfig(center=not rotary),
        encoder=EncoderConfig(
            feat_in=64, n_layers=2, d_model=64, n_heads=4,
            ff_expansion_factor=2, conv_kernel_size=7, pos_emb_max_len=256,
            self_attention_model="rotary" if rotary else "rel_pos"),
        head=CTCHeadConfig(feat_in=64, num_classes=len(RU_VOCAB) + 1),
        decoding=DecodingConfig(kind="ctc_greedy", vocabulary=list(RU_VOCAB)))


def model_pair(kind, seed=0):
    jm = JaxASR(tiny_cfg(kind), seed=seed, compute_dtype=jnp.float32)
    if kind == "rel_pos":
        jm.params = with_pos_biases(jm.params, seed)
    tm = gt.GigaAMASR(gt.ModelConfig.from_dict(jm.cfg.to_dict()),
                      state=params_from_jax(jax.tree.map(np.asarray,
                                                         jm.params)),
                      device="cpu")
    return jm, tm


def make_batch(seed=0):
    """Three rows of 1.5 s, 1.0 s and a pad row of length 0."""
    rng = np.random.default_rng(seed)
    lens = np.array([24000, 16000, 0], np.int32)
    wavs = np.zeros((3, 24000), np.float32)
    for i, n in enumerate(lens):
        wavs[i, :n] = 0.1 * rng.standard_normal(n)
    tokens = rng.integers(0, len(RU_VOCAB), (3, 16)).astype(np.int32)
    return wavs, lens, tokens, np.array([9, 5, 0], np.int32)


def flat_state(state, prefix=""):
    """The port's nested state -> {``named_parameters`` name: tensor}."""
    out = {}
    items = enumerate(state) if isinstance(state, list) else state.items()
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat_state(v, name + "."))
        else:
            out[name] = v
    return out


def jax_tree_as_port(tree):
    return flat_state(params_from_jax(jax.tree.map(np.asarray, tree)))


def jax_loss_and_grads(trainer, batch):
    jb = tuple(jnp.asarray(x) for x in batch)
    return jax.value_and_grad(lambda p: trainer._forward_loss(
        p, jb, jax.random.PRNGKey(0), train=True)[0])(trainer.params)


def assert_params_after_updates(tm, jparams, g0):
    """See the module docstring: 4 lr everywhere, 0.1 lr where the
    gradient is well away from zero."""
    ref = jax_tree_as_port(jparams)
    noise = 1e-3 * max(float(g.abs().max()) for g in g0.values())
    for name, p in tm.named_parameters():
        diff = (p.detach() - ref[name]).abs()
        assert float(diff.max()) <= 4 * LR, (name, float(diff.max()))
        g = g0[name].abs()
        firm = g > 1e-2 * g.max()
        if tft.is_bn_buffer(name) or float(g.max()) <= noise:
            continue
        assert float(diff[firm].max()) <= 0.1 * LR, (name,
                                                      float(diff[firm].max()))


@pytest.mark.parametrize("kind", ["rotary", "rel_pos"])
def test_finetuner_gradients_match_jax(kind):
    jm, tm = model_pair(kind, seed=1)
    batch = make_batch(1)
    jtrainer = jft.FineTuner(jm, jft.TrainConfig(precision="fp32"))
    ref_loss, ref = jax_loss_and_grads(jtrainer, batch)
    ref = jax_tree_as_port(ref)
    # no clip, and the first update has lr 0: .grad stays as backward left it
    ft = tft.FineTuner(tm, tft.TrainConfig(precision="fp32", grad_clip=1e30))
    m = ft.train_step(batch)
    np.testing.assert_allclose(float(m["loss"]), float(ref_loss), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(ref)
    floor = 1e-3 * max(float(r.abs().max()) for r in ref.values())
    for name, p in tm.named_parameters():
        r = ref[name]
        if tft.is_bn_buffer(name):       # batch statistics: no gradient
            assert p.grad is None and float(r.abs().max()) == 0.0
            continue
        if name.endswith("depthwise_conv.b"):
            # BatchNorm removes the mean: zero, up to rounding, in both
            assert float(p.grad.abs().max()) <= 1e-2 * floor
            assert float(r.abs().max()) <= 1e-2 * floor
            continue
        assert p.grad is not None, name
        tol = 1e-4 * max(float(r.abs().max()), floor)
        assert float((p.grad - r).abs().max()) <= tol, (
            name, float((p.grad - r).abs().max()), tol)
    if kind == "rel_pos":
        for name in names:
            if "pos_bias" in name or "linear_pos" in name:
                assert float(dict(tm.named_parameters())[name].grad.abs()
                             .max()) > 0, name


STEP_CASES = {
    "rotary": ("rotary", {}),
    "rel_pos": ("rel_pos", {}),
    "freeze_encoder": ("rotary", {"freeze_encoder": True}),
    "accumulate_2": ("rel_pos", {"accumulate_grad_batches": 2}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_optimizer_steps_match_jax(case):
    kind, extra = STEP_CASES[case]
    k = extra.get("accumulate_grad_batches", 1)
    kw = dict(lr=LR, total_steps=4, precision="fp32", **extra)
    jm, tm = model_pair(kind, seed=2)
    jtrainer = jft.FineTuner(jm, jft.TrainConfig(**kw))
    ft = tft.FineTuner(tm, tft.TrainConfig(**kw))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    g0 = None                    # the first update's (summed) gradient
    for j in range(k):
        g = jax_tree_as_port(jax_loss_and_grads(jtrainer, make_batch(j))[1])
        g0 = g if g0 is None else {n: g0[n] + g[n] for n in g}
    for step in range(3 * k):
        batch = make_batch(step % k)
        ref = jtrainer.train_step(batch, jax.random.PRNGKey(step))
        got = ft.train_step(batch)
        assert isinstance(got["loss"], torch.Tensor)
        assert isinstance(got["grad_norm"], torch.Tensor)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got["grad_norm"]),
                                   float(ref["grad_norm"]), rtol=1e-4)
        assert got["lr"] == ref["lr"]
        bn = jax_tree_as_port(jtrainer.params)
        for name, p in tm.named_parameters():
            if tft.is_bn_buffer(name):
                np.testing.assert_allclose(
                    p.detach().numpy(), bn[name].numpy(),
                    atol=1e-5 if step < 2 * k else LR / 2, err_msg=name)
    assert ft.step == 3 * k and got["lr"] == LR * 0.75
    assert_params_after_updates(tm, jtrainer.params, g0)
    moved = {n: not torch.equal(p.detach(), before[n])
             for n, p in tm.named_parameters()}
    if extra.get("freeze_encoder"):
        assert not any(v for n, v in moved.items() if n.startswith("encoder."))
        assert all(v for n, v in moved.items() if n.startswith("head."))
    else:
        assert all(moved.values()), [n for n, v in moved.items() if not v]


def test_activation_checkpointing_gives_the_same_gradients():
    grads = {}
    for remat in (False, True):
        _, tm = model_pair("rel_pos", seed=3)
        ft = tft.FineTuner(tm, tft.TrainConfig(
            precision="fp32", grad_clip=1e30, activation_checkpointing=remat))
        ft.train_step(make_batch(3))
        grads[remat] = {n: p.grad for n, p in tm.named_parameters()
                        if p.grad is not None}
    assert grads[True].keys() == grads[False].keys()
    for name, g in grads[False].items():
        np.testing.assert_allclose(grads[True][name].numpy(), g.numpy(),
                                   atol=1e-6, err_msg=name)
    _, tm = model_pair("rotary", seed=3)
    ft = tft.FineTuner(tm, tft.TrainConfig(
        precision="fp32", activation_checkpointing=True, remat_policy="dots"))
    with pytest.raises(NotImplementedError, match="remat_policy"):
        ft.train_step(make_batch(3))


def test_eval_step_sees_the_weights_of_the_last_update():
    """``eval_step`` runs the inference forward, whose folded attention
    weights are prepared once and kept: an optimizer step must invalidate
    them."""
    jm, tm = model_pair("rotary", seed=4)
    batch = make_batch(4)
    kw = dict(lr=0.05, total_steps=4, precision="fp32")
    ft = tft.FineTuner(tm, tft.TrainConfig(**kw))
    jtrainer = jft.FineTuner(jm, jft.TrainConfig(**kw))
    loss0, _ = ft.eval_step(batch)
    for step in range(2):
        ft.train_step(batch)
        jtrainer.train_step(batch, jax.random.PRNGKey(step))
    loss1, hyps = ft.eval_step(batch)
    assert loss1 != loss0 and len(hyps) == 3
    layer = tm.encoder.layers[0]
    want = layer["self_attn"]["linear_q"]["w"].detach() / np.sqrt(16)
    assert torch.equal(layer.folded_weights(torch.float32).wq, want)
    for lyr in tm.encoder.layers:
        lyr.clear_prepared()
    assert ft.eval_step(batch)[0] == loss1
    ref_loss, ref_hyps = jtrainer.eval_step(batch)
    np.testing.assert_allclose(loss1, ref_loss, rtol=2e-2)   # lr 0.05 steps
    assert ft.batch_wer(hyps, batch[2], batch[3])[1] == jtrainer.batch_wer(
        ref_hyps, batch[2], batch[3])[1]


@pytest.mark.parametrize("lnres", [False, True])
def test_folded_kernels_refuse_inputs_that_require_a_gradient(lnres):
    from test_torch_kernels import make_case, port_weights

    params, ln, x, cos, sin, valid = make_case(np.random.default_rng(5), 2,
                                               16, 64, 4)
    w = port_weights(params, ln, 4)
    fold = (fa.folded_rotary_attention_lnres if lnres
            else fa.folded_rotary_attention)
    args = (t(cos), t(sin), t(valid), 4)
    with pytest.raises(RuntimeError, match="no backward"):
        fold(w, t(x).requires_grad_(), *args)
    w_grad = dataclasses.replace(w, wq=w.wq.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="no backward"):
        fold(w_grad, t(x), *args)
    with torch.no_grad():
        assert fold(w_grad, t(x).requires_grad_(), *args).shape == x.shape


def test_finetuner_refuses_a_cast_encoder():
    _, tm = model_pair("rotary", seed=6)
    tm.cast_encoder(torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 master weights"):
        tft.FineTuner(tm, tft.TrainConfig())


def test_fine_tuned_model_loads_in_the_jax_package(tmp_path):
    from test_torch_model import voice

    _, tm = model_pair("rel_pos", seed=7)
    ft = tft.FineTuner(tm, tft.TrainConfig(lr=LR, total_steps=4,
                                           precision="fp32"))
    for _ in range(2):
        ft.train_step(make_batch(7))
    ft.sync_model()
    save_model(tm, str(tmp_path / "tuned"))
    jm = gigaam_tpu.load_model(str(tmp_path / "tuned.npz"))
    got = jax.tree.map(np.asarray, jm.params)
    want = params_to_jax(tm)
    flat_got, flat_want = flat_state(got), flat_state(want)
    assert flat_got.keys() == flat_want.keys()
    for name, a in flat_want.items():
        assert a.dtype == flat_got[name].dtype and np.array_equal(
            a, flat_got[name]), name
    wav = voice(1.5, np.random.default_rng(7))
    assert jm.transcribe(wav).text == tm.transcribe(wav).text


def test_train_checkpoint_resumes_to_the_same_parameters(tmp_path):
    kw = dict(lr=LR, total_steps=6, precision="fp32", spec_augment=True,
              accumulate_grad_batches=2)
    _, tm = model_pair("rotary", seed=8)
    ft = tft.FineTuner(tm, tft.TrainConfig(**kw), seed=5)
    for step in range(3):
        ft.train_step(make_batch(step))
    path = str(tmp_path / "state.ckpt")
    ft.save_checkpoint(path)
    for step in range(3, 6):
        ft.train_step(make_batch(step))
    want = {n: p.detach().clone() for n, p in tm.named_parameters()}

    _, fresh = model_pair("rotary", seed=9)
    ft2 = tft.FineTuner(fresh, tft.TrainConfig(**kw), seed=0)
    ft2.restore_checkpoint(path)
    assert ft2.step == 3
    for step in range(3, 6):
        ft2.train_step(make_batch(step))
    for name, p in fresh.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    with open(path, "rb") as f:
        meta = json.loads(str(np.load(f, allow_pickle=False)["__meta__"]))
    assert meta["step"] == 3 and meta["format"] == ft._CKPT_FORMAT


def test_init_encoder_from_artifact(tmp_path):
    _, src = model_pair("rel_pos", seed=11)
    _, dst = model_pair("rel_pos", seed=12)
    save_model(src, str(tmp_path / "src"))
    head = {n: p.detach().clone() for n, p in dst.head.named_parameters()}
    init_encoder_from_artifact(dst, str(tmp_path / "src.npz"))
    for (n, a), (_, b) in zip(src.encoder.named_parameters(),
                              dst.encoder.named_parameters()):
        assert torch.equal(a, b), n
    for n, p in dst.head.named_parameters():
        assert torch.equal(p, head[n]), n
    _, rotary = model_pair("rotary", seed=12)
    with pytest.raises(ValueError, match="architecture mismatch"):
        init_encoder_from_artifact(rotary, str(tmp_path / "src.npz"))


def tiny_manifest(tmp_path, seed):
    _, tm = model_pair("rotary", seed=seed)
    save_model(tm, str(tmp_path / "tiny"))
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(6):
        sec = 1.0 + 0.2 * i
        save_wav(str(tmp_path / f"c{i}.wav"),
                 (0.1 * rng.standard_normal(int(sec * 16000)))
                 .astype(np.float32))
        rows.append((f"c{i}.wav", sec, "привет мир"[:4 + i]))
    tdata.write_manifest(str(tmp_path / "m.tsv"), rows)
    return tm


def test_eval_cli_writes_predictions(tmp_path):
    tm = tiny_manifest(tmp_path, 13)
    out = str(tmp_path / "preds.jsonl")
    eval_cli.main(["--model_name", str(tmp_path / "tiny.npz"), "--device",
                   "cpu", "--manifest", str(tmp_path / "m.tsv"),
                   "--batch_size", "4", "--out", out])
    preds = [json.loads(line) for line in open(out)]
    assert [p["reference"] for p in preds] == ["привет мир"[:4 + i].strip()
                                               for i in range(6)]
    wav = tdata.AudioDataset(str(tmp_path / "m.tsv")).load_wav(2)
    assert preds[2]["prediction"] == tm.transcribe(wav).text
    summary = json.load(open(out + ".summary.json"))
    assert summary["samples"] == 6 and 0.0 <= summary["wer_e2e"]


def test_train_cli_on_a_tiny_manifest(tmp_path):
    tiny_manifest(tmp_path, 10)
    out = tmp_path / "exp"
    train_cli.main([
        "--model_name", str(tmp_path / "tiny.npz"), "--device", "cpu",
        "--train_manifest", str(tmp_path / "m.tsv"),
        "--val_manifest", str(tmp_path / "m.tsv"), "--precision", "fp32",
        "--batch_size", "2", "--max_steps", "4", "--log_every_n_steps", "1",
        "--spec_augment", "--save_dir", str(out)])
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert [r["step"] for r in recs if r["kind"] == "train"] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert [r["step"] for r in recs if r["kind"] == "val"] == [3, 4]
    assert len([f for f in os.listdir(out) if f.endswith(".ckpt")]) == 1
    assert (out / "final.npz").exists() and (out / "final.json").exists()
    assert train_cli.experiment_name(train_cli.parse_args([
        "--model_name", "v3_ctc", "--train_manifest", "a", "--val_manifest",
        "b", "--max_steps", "7", "--freeze_encoder"])) == (
        "v3ctc_lr0.0001_wd0.01_b16_7steps_frenc")

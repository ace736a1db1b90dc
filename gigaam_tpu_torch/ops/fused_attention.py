"""The encoder's attention kernels, written by hand for Hopper.

Each public wrapper replaces one Pallas kernel of
``gigaam_tpu/ops/pallas_attention.py``:

* ``fused_mha`` (K3) replaces ``fused_mha`` -> ``_mha_pallas``
  (``_attn_kernel``): masked SDPA on [B, H, T, 48] q/k/v.  CUDA:
  ``csrc/attention.cu``.  When a gradient is recorded it also returns the
  rows' log-sum-exp, which the backward starts from.
* ``folded_rotary_attention`` (K2) replaces ``_folded_rotary_pallas``
  (``_fold_rotary_kernel``): RoPE -> Q/K/V projections -> masked SDPA ->
  output projection, on the post-LN input.  CUDA: ``csrc/projection.cu``
  (QKV prologue and output epilogue) around ``csrc/attention.cu``.
* ``folded_rotary_attention_lnres`` (K1) replaces ``_folded_lnres_pallas``
  (``_fold_rotary_lnres_kernel``): K2 with the LayerNorm in its prologue and
  the residual add in its epilogue, on the pre-LN residual stream.
* ``fused_relpos_mha`` (K5) replaces ``fused_relpos_mha`` ->
  ``_relpos_pallas`` (``_attn_relpos_kernel``): Transformer-XL
  relative-position SDPA for the v1/v2 encoder.  CUDA:
  ``csrc/relpos_attention.cu``.  Like K3 it also returns the rows'
  log-sum-exp (of the scaled, biased and masked scores) when a gradient is
  recorded.
* ``mha_bwd`` (K4) replaces ``_mha_bwd_pallas`` (``_attn_bwd_kernel``), the
  gradient of K3: dq, dk, dv from q, k, v, the output gradient and the
  forward's saved pair (output, log-sum-exp).  CUDA:
  ``csrc/attention_bwd.cu``.  ``fused_mha`` reaches it through autograd.
* ``relpos_mha_bwd`` (K6) replaces ``_relpos_bwd_pallas``
  (``_attn_relpos_bwd_kernel``), the gradient of K5: dq_u, dk, dv, dq_v and
  the position table's gradient dp, summed over the batch, from the inputs,
  the output gradient and the forward's saved pair.  CUDA:
  ``csrc/relpos_attention_bwd.cu``.  ``fused_relpos_mha`` reaches it through
  autograd.

K3-K6 share one design (``csrc/wgmma.cuh``): tiles streamed through a
``cp.async`` ring, every product on ``wgmma``, scores and probabilities kept
in registers, a backward that sweeps the other side's tiles once per launch
from the saved (output, log-sum-exp).  All are bounded by operations at the
encoder's shapes.

K1 and K2 are inference kernels, as in the JAX package: they refuse inputs
that require a gradient while gradients are recorded.

What bounds each on the card, and what its design does about it, is in the
note at the top of each ``.cu`` file.

Beside each wrapper is its plain PyTorch version, which follows the fold's
numerics (RoPE in fp32 then cast, fp32 accumulation, P cast to the compute
dtype before P.V, the division after it).  A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``<wrapper>.launches`` counts the wrapper's calls that reach the
card: one CUDA launch for K3 and K5, three (QKV, SDPA core, output) for K2
and K1, two (dq, then dk and dv) for K4 and K6 (called without the saved
pair they first run the forward's kernel for it: three).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional

import torch

from . import cuda_lib
from .attention import NEG_INF, _split_heads
from .conformer_ops import Params
from .precision import full_fp32

D_HEAD = 48           # the CUDA kernels' head width (768 / 16)
_TILE_N = 64          # output tile width of the projection GEMMs


@dataclass(frozen=True)
class FoldedWeights:
    """Attention-module weights prepared once per model for K1/K2, as
    ``pallas_attention.py:373-388,495-512`` prepares them per call: ``wq`` and
    ``bq`` scaled by 1/sqrt(d_h) in fp32 before any cast, the weights cast to
    the compute dtype, biases and the LayerNorm scale/bias kept fp32."""

    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: torch.Tensor
    bk: torch.Tensor
    bv: torch.Tensor
    bo: torch.Tensor
    ln_scale: torch.Tensor
    ln_bias: torch.Tensor


def prepare_folded_weights(attn: Mapping[str, Params], ln: Params,
                           n_heads: int, dtype: torch.dtype) -> FoldedWeights:
    d = attn["linear_q"]["w"].shape[0]
    scale = 1.0 / math.sqrt(d // n_heads)
    f32 = torch.float32

    def w(name: str) -> torch.Tensor:
        return attn[name]["w"].to(f32)

    def b(name: str) -> torch.Tensor:
        return attn[name]["b"].to(f32).contiguous()

    return FoldedWeights(
        wq=(w("linear_q") * scale).to(dtype).contiguous(),
        wk=w("linear_k").to(dtype).contiguous(),
        wv=w("linear_v").to(dtype).contiguous(),
        wo=w("linear_out").to(dtype).contiguous(),
        bq=(b("linear_q") * scale).contiguous(),
        bk=b("linear_k"), bv=b("linear_v"), bo=b("linear_out"),
        ln_scale=ln["scale"].to(f32).contiguous(),
        ln_bias=ln["bias"].to(f32).contiguous())


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _wide(x: torch.Tensor) -> torch.Tensor:
    """fp32 for the arithmetic, as the kernels accumulate; float64 inputs
    (gradient checks) stay float64."""
    return x if x.dtype == torch.float64 else x.float()


def _key_mask(valid: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The additive key mask (mask - 1) * 1e9, [B, 1, 1, T]."""
    return (valid[:, None, None, :].to(like.dtype) - 1.0) * (-NEG_INF)


def _sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor, scale: float,
                bias: Optional[torch.Tensor] = None,
                return_lse: bool = False):
    """The math of ``_attn_kernel``: fp32 scores and softmax with the key
    mask added as (mask-1)*1e9, P cast to v's dtype, division after P.V.
    An fp32 ``bias`` [B, H, T, T] joins the scores before the scale, as in
    ``_attn_relpos_kernel``.  With ``return_lse`` also the rows' log-sum-exp
    of the scaled and masked scores, [B, H, T] in the wide type."""
    with full_fp32():
        s = _wide(q) @ _wide(k).transpose(-1, -2)
        if bias is not None:
            s = s + bias
        s = s * scale
        s = s + _key_mask(valid, s)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        o = _wide(p.to(v.dtype)) @ _wide(v)
    out = (o / denom).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(denom)).squeeze(-1)
    return out


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor, return_lse: bool = False):
    """Plain version of K3; with ``return_lse`` -> (out, lse [B, H, T])."""
    return _sdpa_plain(q, k, v, valid, 1.0 / math.sqrt(q.shape[-1]),
                       return_lse=return_lse)


def relpos_mha_plain(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_v: torch.Tensor, p_heads: torch.Tensor,
                     valid: torch.Tensor, return_lse: bool = False):
    """Plain version of K5: the positional term ``q_v . p_heads^T`` in fp32,
    sheared to relative position i - j (``bias[i, j] = raw[i, T-1-i+j]``)
    and rounded to the inputs' dtype, as ``_attn_relpos_kernel`` rounds it
    before the shear; then ``_sdpa_plain`` with that bias.  With
    ``return_lse`` -> (out, lse [B, H, T])."""
    return _sdpa_plain(q_u, k, v, valid, 1.0 / math.sqrt(q_u.shape[-1]),
                       _relpos_bias(q_v, p_heads), return_lse=return_lse)


def _shear_index(b: int, h: int, t: int, device) -> torch.Tensor:
    """[B, H, T, T] index of relative position i - j in the table:
    ``bias[i, j] = raw[i, T-1-i+j]``."""
    ar = torch.arange(t, device=device)
    return ((t - 1) - ar[:, None] + ar[None, :]).expand(b, h, t, t)


def _relpos_bias(q_v: torch.Tensor, p_heads: torch.Tensor) -> torch.Tensor:
    """The sheared positional term [B, H, T, T], rounded to the inputs'
    dtype as K5 rounds it, widened again for the scores."""
    b, h, t, _ = q_v.shape
    with full_fp32():
        raw = _wide(q_v) @ _wide(p_heads).transpose(-1, -2)     # [B, H, T, P]
        bias = raw.gather(-1, _shear_index(b, h, t, q_v.device))
    return _wide(bias.to(q_v.dtype))


def _sdpa_bwd_plain(q, k, v, do, valid, scale, bias=None, out=None,
                    lse=None):
    """The math of ``_attn_bwd_kernel``: recompute the fp32 probabilities,
    ``dv`` from P cast to the compute dtype, ``ds = P (dP - rowsum(dP P))
    scale`` cast to the compute dtype before ``dq`` and ``dk``.  Given the
    forward's pair it follows K4's arithmetic instead: ``P = exp(s - lse)``
    and ``rowsum(dP P) = rowsum(do out)``, which differs by ``out``'s
    rounding.  Returns (dq, dk, dv, ds) with ds [B, H, T, T] still wide, for
    the rel-pos unshear."""
    dt = q.dtype
    with full_fp32():
        s = _wide(q) @ _wide(k).transpose(-1, -2)
        if bias is not None:
            s = s + bias
        s = s * scale + _key_mask(valid, s)
        dprob = _wide(do) @ _wide(v).transpose(-1, -2)
        if out is None:
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            prob = p / p.sum(dim=-1, keepdim=True)
            row = (dprob * prob).sum(dim=-1, keepdim=True)
        else:
            prob = torch.exp(s - _wide(lse)[..., None])
            row = (_wide(do) * _wide(out)).sum(dim=-1, keepdim=True)
        dv = _wide(prob.to(dt)).transpose(-1, -2) @ _wide(do)
        ds = _wide(((prob * (dprob - row)) * scale).to(dt))
        dq = ds @ _wide(k)
        dk = ds.transpose(-1, -2) @ _wide(q)
    return dq.to(dt), dk.to(dt), dv.to(dt), ds


def _require_pair(out, lse) -> None:
    _require((out is None) == (lse is None),
             "out and lse come from one forward: give both or neither")


def mha_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, valid: torch.Tensor,
                  out: Optional[torch.Tensor] = None,
                  lse: Optional[torch.Tensor] = None):
    """Plain version of K4: (dq, dk, dv) of ``mha_plain`` for the output
    gradient ``do``.  With the forward's ``(out, lse)`` it follows the
    kernel's arithmetic (P from lse, D = rowsum(do out)); without, the
    Pallas kernel's (row statistics recomputed, D = rowsum(dP P))."""
    _require_pair(out, lse)
    return _sdpa_bwd_plain(q, k, v, do, valid, 1.0 / math.sqrt(q.shape[-1]),
                           out=out, lse=lse)[:3]


def relpos_mha_bwd_plain(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_v: torch.Tensor, p_heads: torch.Tensor,
                         do: torch.Tensor, valid: torch.Tensor,
                         out: Optional[torch.Tensor] = None,
                         lse: Optional[torch.Tensor] = None):
    """Plain version of K6: (dq_u, dk, dv, dq_v, dp) of ``relpos_mha_plain``.
    The score gradient dz is unsheared into the table's coordinates
    (``d_raw[i, T-1-i+j] = dz[i, j]``, zero elsewhere); ``dp`` is summed over
    the batch in the wide type and cast once.  With the forward's
    ``(out, lse)`` it follows the kernel's arithmetic (P from lse,
    D = rowsum(do out)); without, the Pallas kernel's (row statistics
    recomputed, D = rowsum(dP P))."""
    _require_pair(out, lse)
    b, h, t, d = q_u.shape
    dq_u, dk, dv, dz = _sdpa_bwd_plain(
        q_u, k, v, do, valid, 1.0 / math.sqrt(d), _relpos_bias(q_v, p_heads),
        out=out, lse=lse)
    with full_fp32():
        d_raw = dz.new_zeros((b, h, t, p_heads.shape[1]))
        d_raw.scatter_(-1, _shear_index(b, h, t, q_u.device), dz)
        dq_v = d_raw @ _wide(p_heads)
        dp = torch.einsum("bhtp,bhtd->hpd", d_raw, _wide(q_v))
    return dq_u, dk, dv, dq_v.to(q_u.dtype), dp.to(p_heads.dtype)


def _rotate_half_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """rotate_half within each head of the flat [B, T, H*d] layout; the
    value of ``x @ _rope_perm_matrix`` (products are exactly 0 or +-x)."""
    b, t, dd = x.shape
    xh = x.reshape(b, t, n_heads, dd // n_heads)
    half = xh.shape[-1] // 2
    return torch.cat([-xh[..., half:], xh[..., :half]], dim=-1).reshape(b, t, dd)


def _folded_plain(w: FoldedWeights, x: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, valid: torch.Tensor, n_heads: int,
                  lnres: bool) -> torch.Tensor:
    dt = x.dtype
    with full_fp32():
        if lnres:
            xf = x.float()
            mean = xf.mean(dim=-1, keepdim=True)
            var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
            xin = ((xf - mean) * torch.rsqrt(var + 1e-5) * w.ln_scale
                   + w.ln_bias).to(dt)
        else:
            xin = x
        xf = xin.float()
        xr = (xf * cos.repeat(1, n_heads)
              + _rotate_half_heads(xf, n_heads) * sin.repeat(1, n_heads)).to(dt)

        def proj(a: torch.Tensor, wm: torch.Tensor, bias: torch.Tensor):
            return _split_heads((a.float() @ wm.float() + bias).to(dt), n_heads)

        q, k, v = proj(xr, w.wq, w.bq), proj(xr, w.wk, w.bk), proj(xin, w.wv, w.bv)
        o = _sdpa_plain(q, k, v, valid, 1.0)            # wq carries the scale
        b, h, t, d = o.shape
        merged = o.transpose(1, 2).reshape(b, t, h * d)
        out = (merged.float() @ w.wo.float() + w.bo).to(dt)
    return out + x if lnres else out


def folded_rotary_attention_plain(w: FoldedWeights, x: torch.Tensor,
                                  cos: torch.Tensor, sin: torch.Tensor,
                                  valid: torch.Tensor, n_heads: int
                                  ) -> torch.Tensor:
    """Plain version of K2."""
    return _folded_plain(w, x, cos, sin, valid, n_heads, lnres=False)


def folded_rotary_attention_lnres_plain(w: FoldedWeights, x: torch.Tensor,
                                        cos: torch.Tensor, sin: torch.Tensor,
                                        valid: torch.Tensor, n_heads: int
                                        ) -> torch.Tensor:
    """Plain version of K1."""
    return _folded_plain(w, x, cos, sin, valid, n_heads, lnres=True)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensor(name: str, x: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, shape) -> None:
    _require(x.device == device, f"{name} on {x.device}, expected {device}")
    _require(x.dtype == dtype, f"{name} is {x.dtype}, expected {dtype}")
    _require(tuple(x.shape) == tuple(shape),
             f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    _require(x.is_contiguous(), f"{name} must be contiguous")
    _require(x.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch_sdpa(q, k, v, valid, out, scale: float,
                 lse: Optional[torch.Tensor] = None) -> None:
    """The SDPA core; ``lse`` [B, H, T] fp32 is written when given."""
    b, h, t, d = q.shape
    lib = cuda_lib.library("attention")
    cuda_lib.check(lib.gigaam_sdpa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, h, t,
        scale, _stream(q.device)), "gigaam_sdpa")


def _check_sdpa_args(q, k, v, valid) -> None:
    _require(q.dim() == 4 and q.shape[-1] == D_HEAD,
             f"q must be [B, H, T, {D_HEAD}], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, x, q.device, torch.bfloat16, (b, h, t, d))
    _check_tensor("valid", valid, q.device, torch.bool, (b, t))


def _grad_recorded(*tensors: torch.Tensor) -> bool:
    """Whether a backward may be asked for these inputs.  Read before
    ``Function.apply``: grad mode is off inside ``Function.forward``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _new_lse(q: torch.Tensor) -> torch.Tensor:
    return torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)


def _mha_forward(q, k, v, valid, want_lse: bool):
    """K3 -> (out, lse or None)."""
    if q.device.type == "cpu":
        return (mha_plain(q, k, v, valid, return_lse=True) if want_lse
                else (mha_plain(q, k, v, valid), None))
    _check_sdpa_args(q, k, v, valid)
    out = torch.empty_like(q)
    lse = _new_lse(q) if want_lse else None
    with torch.cuda.device(q.device):
        _launch_sdpa(q, k, v, valid, out, 1.0 / math.sqrt(D_HEAD), lse)
    fused_mha.launches += 1
    return out, lse


def _bwd_stats(q: torch.Tensor, n: int) -> torch.Tensor:
    """Scratch for ``n`` per-row statistics that a backward's first launch
    leaves for its second."""
    b, h, t, _ = q.shape
    return torch.empty((n, b, h, t), dtype=torch.float32, device=q.device)


def mha_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, valid: torch.Tensor,
            out: Optional[torch.Tensor] = None,
            lse: Optional[torch.Tensor] = None):
    """K4: the gradient of ``fused_mha``.  q/k/v/do [B, H, T, d]; valid
    [B, T] bool; ``out`` [B, H, T, d] and ``lse`` [B, H, T] fp32 are what the
    forward returned for these inputs -> (dq, dk, dv).  Without the pair the
    forward's kernel runs first to make it.  Rows of padded queries hold
    garbage in dq unless ``do`` is zero there, as it is in a train step.
    CUDA: bf16, d = 48, any T."""
    _require_pair(out, lse)
    if q.device.type == "cpu":
        return mha_bwd_plain(q, k, v, do, valid, out, lse)
    _check_sdpa_args(q, k, v, valid)
    _check_tensor("do", do, q.device, torch.bfloat16, q.shape)
    b, h, t, _ = q.shape
    scale = 1.0 / math.sqrt(D_HEAD)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = _bwd_stats(q, 2)
    lib = cuda_lib.library("attention_bwd")
    with torch.cuda.device(q.device):
        if out is None:
            out, lse = torch.empty_like(q), _new_lse(q)
            _launch_sdpa(q, k, v, valid, out, scale, lse)
        _check_tensor("out", out, q.device, torch.bfloat16, q.shape)
        _check_tensor("lse", lse, q.device, torch.float32, (b, h, t))
        cuda_lib.check(lib.gigaam_sdpa_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), valid.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, t, scale,
            _stream(q.device)), "gigaam_sdpa_bwd")
    mha_bwd.launches += 1
    return dq, dk, dv


mha_bwd.launches = 0


class _FusedMHA(torch.autograd.Function):
    """K3 with K4 as its gradient.  The residuals are the inputs, as in the
    JAX package's custom VJP, and the forward's output and log-sum-exp: K4
    starts from them instead of recomputing the row statistics."""

    @staticmethod
    def forward(ctx, q, k, v, valid, want_lse):
        out, lse = _mha_forward(q, k, v, valid, want_lse)
        if want_lse:
            ctx.save_for_backward(q, k, v, valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid, out, lse = ctx.saved_tensors
        # autograd hands over whatever layout the consumer's backward made
        dq, dk, dv = mha_bwd(q, k, v, do.contiguous(), valid, out, lse)
        return dq, dk, dv, None, None


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """K3: masked SDPA.  q/k/v [B, H, T, d]; valid [B, T] bool ->
    [B, H, T, d].  Output rows of invalid query positions are garbage, as in
    the JAX package.  Differentiable in q, k and v: the backward is K4
    (``mha_bwd``), which starts from the output and the rows' log-sum-exp;
    the log-sum-exp is computed only when a gradient is being recorded.
    CUDA: bf16, d = 48, any T."""
    return _FusedMHA.apply(q, k, v, valid, _grad_recorded(q, k, v))


fused_mha.launches = 0


def _refuse_grad(name: str, tensors) -> None:
    """K1 and K2 are inference kernels (the JAX package trains through the
    composed path): refuse to cut a gradient silently."""
    if _grad_recorded(*tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or "
            f"torch.inference_mode(); training goes through rotary_mha("
            f"use_fused=True)")


def _folded_cuda(w: FoldedWeights, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, valid: torch.Tensor, n_heads: int,
                 lnres: bool) -> torch.Tensor:
    _require(x.dim() == 3, f"x must be [B, T, D], got {tuple(x.shape)}")
    b, t, d = x.shape
    dev = x.device
    _require(d == n_heads * D_HEAD and d % _TILE_N == 0,
             f"the CUDA fold needs D = {D_HEAD} * n_heads and D % {_TILE_N} "
             f"== 0, got D={d}, n_heads={n_heads}")
    _check_tensor("x", x, dev, torch.bfloat16, (b, t, d))
    for name in ("wq", "wk", "wv", "wo"):
        _check_tensor(name, getattr(w, name), dev, torch.bfloat16, (d, d))
    for name in ("bq", "bk", "bv", "bo", "ln_scale", "ln_bias"):
        _check_tensor(name, getattr(w, name), dev, torch.float32, (d,))
    _check_tensor("cos", cos, dev, torch.float32, (t, D_HEAD))
    _check_tensor("sin", sin, dev, torch.float32, (t, D_HEAD))
    _check_tensor("valid", valid, dev, torch.bool, (b, t))

    q, k, v, o = (torch.empty((b, n_heads, t, D_HEAD), dtype=x.dtype,
                              device=dev) for _ in range(4))
    out = torch.empty_like(x)
    proj = cuda_lib.library("projection")
    stream = _stream(dev)
    ln_g, ln_b = ((w.ln_scale.data_ptr(), w.ln_bias.data_ptr()) if lnres
                  else (None, None))
    with torch.cuda.device(dev):
        cuda_lib.check(proj.gigaam_qkv_proj(
            x.data_ptr(), ln_g, ln_b, cos.data_ptr(), sin.data_ptr(),
            w.wq.data_ptr(), w.wk.data_ptr(), w.wv.data_ptr(),
            w.bq.data_ptr(), w.bk.data_ptr(), w.bv.data_ptr(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            b, t, d, n_heads, stream), "gigaam_qkv_proj")
        _launch_sdpa(q, k, v, valid, o, 1.0)            # wq carries the scale
        cuda_lib.check(proj.gigaam_out_proj(
            o.data_ptr(), w.wo.data_ptr(), w.bo.data_ptr(),
            x.data_ptr() if lnres else None, out.data_ptr(),
            b, t, d, n_heads, stream), "gigaam_out_proj")
    return out


def folded_rotary_attention(w: FoldedWeights, x: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor,
                            valid: torch.Tensor, n_heads: int) -> torch.Tensor:
    """K2: the rotary attention module on the post-LN input x [B, T, D];
    cos/sin [T, d_head] fp32; valid [B, T] bool.  Padded query rows are
    garbage, as in the JAX package."""
    _refuse_grad("folded_rotary_attention",
                 (x, *vars(w).values()))
    if x.device.type == "cpu":
        return folded_rotary_attention_plain(w, x, cos, sin, valid, n_heads)
    out = _folded_cuda(w, x, cos, sin, valid, n_heads, lnres=False)
    folded_rotary_attention.launches += 1
    return out


folded_rotary_attention.launches = 0


def folded_rotary_attention_lnres(w: FoldedWeights, x: torch.Tensor,
                                  cos: torch.Tensor, sin: torch.Tensor,
                                  valid: torch.Tensor, n_heads: int
                                  ) -> torch.Tensor:
    """K1: ``x + attention(layer_norm(x))`` on the pre-LN residual stream
    x [B, T, D]; LN statistics in fp32, the residual added in x's dtype."""
    _refuse_grad("folded_rotary_attention_lnres",
                 (x, *vars(w).values()))
    if x.device.type == "cpu":
        return folded_rotary_attention_lnres_plain(w, x, cos, sin, valid,
                                                   n_heads)
    out = _folded_cuda(w, x, cos, sin, valid, n_heads, lnres=True)
    folded_rotary_attention_lnres.launches += 1
    return out


folded_rotary_attention_lnres.launches = 0


def _check_relpos_args(q_u, k, v, q_v, p_heads, valid) -> None:
    _check_sdpa_args(q_u, k, v, valid)
    b, h, t, d = q_u.shape
    _check_tensor("q_v", q_v, q_u.device, torch.bfloat16, (b, h, t, d))
    _check_tensor("p_heads", p_heads, q_u.device, torch.bfloat16,
                  (h, 2 * t - 1, d))


def _launch_relpos_sdpa(q_u, k, v, q_v, p_heads, valid, out, scale: float,
                        lse: Optional[torch.Tensor] = None) -> None:
    """The rel-pos SDPA core; ``lse`` [B, H, T] fp32 is written when given."""
    b, h, t, _ = q_u.shape
    lib = cuda_lib.library("relpos_attention")
    cuda_lib.check(lib.gigaam_relpos_sdpa(
        q_u.data_ptr(), k.data_ptr(), v.data_ptr(), q_v.data_ptr(),
        p_heads.data_ptr(), valid.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, t, scale,
        _stream(q_u.device)), "gigaam_relpos_sdpa")


def _relpos_forward(q_u, k, v, q_v, p_heads, valid, want_lse: bool):
    """K5 -> (out, lse or None)."""
    if q_u.device.type == "cpu":
        args = (q_u, k, v, q_v, p_heads, valid)
        return (relpos_mha_plain(*args, return_lse=True) if want_lse
                else (relpos_mha_plain(*args), None))
    _check_relpos_args(q_u, k, v, q_v, p_heads, valid)
    out = torch.empty_like(q_u)
    lse = _new_lse(q_u) if want_lse else None
    with torch.cuda.device(q_u.device):
        _launch_relpos_sdpa(q_u, k, v, q_v, p_heads, valid, out,
                            1.0 / math.sqrt(D_HEAD), lse)
    fused_relpos_mha.launches += 1
    return out, lse


def relpos_mha_bwd(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_v: torch.Tensor, p_heads: torch.Tensor,
                   do: torch.Tensor, valid: torch.Tensor,
                   out: Optional[torch.Tensor] = None,
                   lse: Optional[torch.Tensor] = None):
    """K6: the gradient of ``fused_relpos_mha`` -> (dq_u, dk, dv, dq_v, dp);
    ``out`` [B, H, T, d] and ``lse`` [B, H, T] fp32 are what the forward
    returned for these inputs; without the pair the forward's kernel runs
    first to make it.  dp [H, 2T-1, d] is summed over the batch in fp32 and
    cast once.  On CUDA (bf16, d = 48, any T) that sum uses fp32 atomics, so
    dp's low bits depend on the order of the blocks; the other four are
    deterministic.  Rows of padded queries hold garbage in dq_u and dq_v
    unless ``do`` is zero there, as it is in a train step."""
    _require_pair(out, lse)
    if q_u.device.type == "cpu":
        return relpos_mha_bwd_plain(q_u, k, v, q_v, p_heads, do, valid, out,
                                    lse)
    _check_relpos_args(q_u, k, v, q_v, p_heads, valid)
    _check_tensor("do", do, q_u.device, torch.bfloat16, q_u.shape)
    b, h, t, _ = q_u.shape
    scale = 1.0 / math.sqrt(D_HEAD)
    dq_u, dk, dv, dq_v = (torch.empty_like(q_u) for _ in range(4))
    dp = torch.zeros(p_heads.shape, dtype=torch.float32, device=q_u.device)
    stats = _bwd_stats(q_u, 2)
    lib = cuda_lib.library("relpos_attention_bwd")
    with torch.cuda.device(q_u.device):
        if out is None:
            out, lse = torch.empty_like(q_u), _new_lse(q_u)
            _launch_relpos_sdpa(q_u, k, v, q_v, p_heads, valid, out, scale,
                                lse)
        _check_tensor("out", out, q_u.device, torch.bfloat16, q_u.shape)
        _check_tensor("lse", lse, q_u.device, torch.float32, (b, h, t))
        cuda_lib.check(lib.gigaam_relpos_sdpa_bwd(
            q_u.data_ptr(), k.data_ptr(), v.data_ptr(), q_v.data_ptr(),
            p_heads.data_ptr(), do.data_ptr(), out.data_ptr(),
            lse.data_ptr(), valid.data_ptr(), dq_u.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dq_v.data_ptr(), dp.data_ptr(), stats.data_ptr(),
            b, h, t, scale, _stream(q_u.device)), "gigaam_relpos_sdpa_bwd")
    relpos_mha_bwd.launches += 1
    return dq_u, dk, dv, dq_v, dp.to(p_heads.dtype)


relpos_mha_bwd.launches = 0


class _FusedRelposMHA(torch.autograd.Function):
    """K5 with K6 as its gradient.  The residuals are the inputs, as in the
    JAX package's custom VJP, and the forward's output and log-sum-exp: K6
    starts from them instead of recomputing the row statistics."""

    @staticmethod
    def forward(ctx, q_u, k, v, q_v, p_heads, valid, want_lse):
        out, lse = _relpos_forward(q_u, k, v, q_v, p_heads, valid, want_lse)
        if want_lse:
            ctx.save_for_backward(q_u, k, v, q_v, p_heads, valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q_u, k, v, q_v, p_heads, valid, out, lse = ctx.saved_tensors
        return relpos_mha_bwd(q_u, k, v, q_v, p_heads, do.contiguous(),
                              valid, out, lse) + (None, None)


def fused_relpos_mha(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_v: torch.Tensor, p_heads: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """K5: Transformer-XL relative-position SDPA.  q_u/k/v/q_v [B, H, T, d]
    (q_u = q + pos_bias_u, q_v = q + pos_bias_v); p_heads [H, 2T-1, d], the
    projected position table of positions T-1 .. -(T-1), one copy for the
    whole batch; valid [B, T] bool -> [B, H, T, d].  Output rows of invalid
    query positions are garbage, as in the JAX package.  Differentiable in
    all five: the backward is K6 (``relpos_mha_bwd``), which starts from the
    output and the rows' log-sum-exp; the log-sum-exp is computed only when
    a gradient is being recorded.  CUDA: bf16, d = 48, any T."""
    return _FusedRelposMHA.apply(q_u, k, v, q_v, p_heads, valid,
                                 _grad_recorded(q_u, k, v, q_v, p_heads))


fused_relpos_mha.launches = 0

KERNELS = (fused_mha, folded_rotary_attention, folded_rotary_attention_lnres,
           fused_relpos_mha, mha_bwd, relpos_mha_bwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0

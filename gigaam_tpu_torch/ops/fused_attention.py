"""The encoder's attention kernels, written by hand for Hopper.

Each public wrapper replaces one Pallas kernel of
``gigaam_tpu/ops/pallas_attention.py``:

* ``fused_mha`` (K3) replaces ``fused_mha`` -> ``_mha_pallas``
  (``_attn_kernel``): masked SDPA on [B, H, T, 48] q/k/v.  CUDA:
  ``csrc/attention.cu``.
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
  ``csrc/relpos_attention.cu``.

What bounds each on the card, and what its design does about it, is in the
note at the top of each ``.cu`` file.

Beside each wrapper is its plain PyTorch version, which follows the fold's
numerics (RoPE in fp32 then cast, fp32 accumulation, P cast to the compute
dtype before P.V, the division after it).  A wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  ``<wrapper>.launches`` counts the wrapper's calls that reach the
card: one CUDA launch for K3 and K5, three (QKV, SDPA core, output) for K2
and K1.
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

def _sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor, scale: float,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The math of ``_attn_kernel``: fp32 scores and softmax with the key
    mask added as (mask-1)*1e9, P cast to v's dtype, division after P.V.
    An fp32 ``bias`` [B, H, T, T] joins the scores before the scale, as in
    ``_attn_relpos_kernel``."""
    with full_fp32():
        s = q.float() @ k.float().transpose(-1, -2)
        if bias is not None:
            s = s + bias
        s = s * scale
        s = s + (valid[:, None, None, :].float() - 1.0) * (-NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        denom = p.sum(dim=-1, keepdim=True)
        o = p.to(v.dtype).float() @ v.float()
    return (o / denom).to(q.dtype)


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    return _sdpa_plain(q, k, v, valid, 1.0 / math.sqrt(q.shape[-1]))


def relpos_mha_plain(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_v: torch.Tensor, p_heads: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: the positional term ``q_v . p_heads^T`` in fp32,
    sheared to relative position i - j (``bias[i, j] = raw[i, T-1-i+j]``)
    and rounded to the inputs' dtype, as ``_attn_relpos_kernel`` rounds it
    before the shear; then ``_sdpa_plain`` with that bias."""
    b, h, t, d = q_u.shape
    with full_fp32():
        raw = q_v.float() @ p_heads.float().transpose(-1, -2)   # [B, H, T, P]
        ar = torch.arange(t, device=q_u.device)
        idx = (t - 1) - ar[:, None] + ar[None, :]                # [T, T]
        bias = raw.gather(-1, idx.expand(b, h, t, t))
    return _sdpa_plain(q_u, k, v, valid, 1.0 / math.sqrt(d),
                       bias.to(q_u.dtype).float())


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


def _launch_sdpa(q, k, v, valid, out, scale: float) -> None:
    b, h, t, d = q.shape
    lib = cuda_lib.library("attention")
    cuda_lib.check(lib.gigaam_sdpa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        out.data_ptr(), b, h, t, scale, _stream(q.device)), "gigaam_sdpa")


def _check_sdpa_args(q, k, v, valid) -> None:
    _require(q.dim() == 4 and q.shape[-1] == D_HEAD,
             f"q must be [B, H, T, {D_HEAD}], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, x, q.device, torch.bfloat16, (b, h, t, d))
    _check_tensor("valid", valid, q.device, torch.bool, (b, t))


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """K3: masked SDPA.  q/k/v [B, H, T, d]; valid [B, T] bool ->
    [B, H, T, d].  Output rows of invalid query positions are garbage, as in
    the JAX package.  CUDA: bf16, d = 48, any T."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, valid)
    _check_sdpa_args(q, k, v, valid)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch_sdpa(q, k, v, valid, out, 1.0 / math.sqrt(D_HEAD))
    fused_mha.launches += 1
    return out


fused_mha.launches = 0


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
    _require(not any(x.requires_grad for x in (q_u, k, v, q_v, p_heads)),
             "fused_relpos_mha has no backward on the card yet: call it "
             "under torch.no_grad() or torch.inference_mode()")


def fused_relpos_mha(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_v: torch.Tensor, p_heads: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """K5: Transformer-XL relative-position SDPA.  q_u/k/v/q_v [B, H, T, d]
    (q_u = q + pos_bias_u, q_v = q + pos_bias_v); p_heads [H, 2T-1, d], the
    projected position table of positions T-1 .. -(T-1), one copy for the
    whole batch; valid [B, T] bool -> [B, H, T, d].  Output rows of invalid
    query positions are garbage, as in the JAX package.  CUDA: bf16,
    d = 48, any T.

    Inference only: the CUDA path has no gradient (its backward, the port
    of ``_relpos_bwd_pallas``, comes with training) and refuses inputs that
    require one."""
    if q_u.device.type == "cpu":
        return relpos_mha_plain(q_u, k, v, q_v, p_heads, valid)
    _check_relpos_args(q_u, k, v, q_v, p_heads, valid)
    b, h, t, _ = q_u.shape
    out = torch.empty_like(q_u)
    lib = cuda_lib.library("relpos_attention")
    with torch.cuda.device(q_u.device):
        cuda_lib.check(lib.gigaam_relpos_sdpa(
            q_u.data_ptr(), k.data_ptr(), v.data_ptr(), q_v.data_ptr(),
            p_heads.data_ptr(), valid.data_ptr(), out.data_ptr(), b, h, t,
            1.0 / math.sqrt(D_HEAD), _stream(q_u.device)),
            "gigaam_relpos_sdpa")
    fused_relpos_mha.launches += 1
    return out


fused_relpos_mha.launches = 0

KERNELS = (fused_mha, folded_rotary_attention, folded_rotary_attention_lnres,
           fused_relpos_mha)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0

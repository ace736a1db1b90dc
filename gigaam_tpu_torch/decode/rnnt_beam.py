"""RNNT beam search with the expansion loop on the device (port of
``gigaam_tpu/decode/rnnt_beam.py``).

The JAX package runs a time-synchronous beam as one ``lax.fori_loop`` over
frames around a ``lax.while_loop`` of expansions.  The port keeps its
semantics exactly:

* all B x K hypotheses advance in lock-step over the frames
  ``0 .. max(enc_len) - 1``; within a frame, expansions run while fewer
  than ``max_symbols`` have run and not every hypothesis is done with the
  frame;
* an expansion's pool per sample is K stay candidates (an open hypothesis
  pays its blank log-prob; a done or inactive one carries its score) then
  K x V label candidates; the best K are kept, the lower pool index first
  among equal scores, as ``lax.top_k`` orders them;
* hypotheses are not prefix-merged; blank pays no LM term;
* shallow fusion adds ``lm_weight * log p_LM + token_bonus`` to the label
  candidates, the context a packed integer (``decode/lm.py``) that shifts
  as ``(ctx % base^(n-1)) * base + label`` on an emission: the dense table
  gathers a row per context, the sparse one takes the deepest hit of a
  ``searchsorted`` per level on ``ctx % base^kk``;
* ``with_logps`` tracks the acoustic (pre-fusion) log-prob of each emitted
  token; the result is beam 0, the best.

As in ``decode/rnnt_greedy.py``, one step function updates preallocated
buffers in place.  A step is one expansion attempt of the flattened frame
and expansion loop: device scalars ``t`` and ``e`` and a [B, K]
``frame_done`` say where the loop stands, a step whose guard (``t <
t_hi``, ``e < max_symbols``, not all done) is false changes nothing (every
update is selected with ``torch.where``), and after the last expansion of
a frame ``t`` advances and ``e`` and ``frame_done`` reset.  The host reads
one flag (``t < t_hi``) per chunk of steps; on CUDA each chunk is a CUDA
graph, on the CPU the steps run eagerly, and that eager loop is the plain
version.  The pool is ordered with a stable descending sort: ``torch.topk``
promises no order among ties, and the pool has exact ties in every call
(the K-1 dead beams of the first expansion score -1e30 whatever they add).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..models.heads import (
    rnnt_joint_enc_proj,
    rnnt_joint_step_preproj,
    rnnt_predict_step,
)
from ..ops.precision import full_fp32
from .lm import _MAX_DENSE_ELEMS, NGramLM
from .rnnt_greedy import CHUNK, GraphedLoops, weights_stamp

NEG_INF = -1.0e30

# a dense table [C, V], or the sparse {"row0": [V], "levels": [(ids, rows)]}
LMTable = Union[torch.Tensor, Dict[str, Any]]


def lm_device_table(lm: NGramLM, device: Union[str, torch.device],
                    sparse: Optional[bool] = None
                    ) -> Tuple[LMTable, int, int]:
    """``(table, base, ctx_len)`` of ``lm`` on ``device`` for the beam.

    Dense (``NGramLM.dense_table``, one [C, V] fp32 tensor) while the table
    stays under ``_MAX_DENSE_ELEMS``, else sparse (``sparse_table``: row0
    and per level the sorted int32 context ids and their [n, V] rows);
    ``sparse`` forces either."""
    base, ctx_len = lm.vocab_size + 1, lm.order - 1
    if sparse is None:
        sparse = base ** ctx_len * lm.vocab_size > _MAX_DENSE_ELEMS
    if not sparse:
        return torch.from_numpy(lm.dense_table()).to(device), base, ctx_len
    spec = lm.sparse_table()
    table = {"row0": torch.from_numpy(spec["row0"]).to(device),
             "levels": [(torch.from_numpy(ids).to(device),
                         torch.from_numpy(rows).to(device))
                        for ids, rows in spec["levels"]]}
    return table, base, ctx_len


def top_k(pool: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of ``pool`` and their indices,
    in descending order, the lower index first among equal values
    (``lax.top_k``'s order), from a stable sort."""
    values, idx = torch.sort(pool, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _lm_rows(table: LMTable, base: int, ctx: torch.Tensor) -> torch.Tensor:
    """The LM's log-prob rows [B, K, V] of the packed contexts [B, K]."""
    if isinstance(table, torch.Tensor):
        return table[ctx]
    row = table["row0"].expand(*ctx.shape, table["row0"].shape[0])
    mod = 1
    for ids, rows in table["levels"]:
        mod *= base
        if ids.shape[0] == 0:
            continue
        suffix = (ctx % mod).to(ids.dtype)
        i = torch.searchsorted(ids, suffix).clamp_(0, ids.shape[0] - 1)
        row = torch.where((ids[i] == suffix)[..., None], rows[i], row)
    return row


class _BeamLoop:
    """The beam state of one shape, as preallocated buffers ([B, K, ...];
    the LSTM state [L, B*K, H]), and the step that updates them in place.
    ``lm``: None or (table, base, ctx_len, weight, bonus)."""

    def __init__(self, head, b: int, k: int, t_max: int, u_cap: int,
                 max_symbols: int, lm: Optional[tuple], with_logps: bool,
                 device: torch.device):
        embed = head["decoder"]["embed"]
        n_layers = len(head["decoder"]["lstm"])
        joint = head["joint"]["enc"]["w"].shape[1]
        self.head, self.lm = head, lm
        self.b, self.k, self.blank = b, k, embed.shape[0] - 1
        self.t_max, self.u_cap, self.max_symbols = t_max, u_cap, max_symbols
        zeros = lambda *shape, dtype=torch.int64: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=device)
        self.enc_proj = zeros(b, t_max, joint, dtype=torch.float32)
        self.enc_len = zeros(b)
        self.t_hi, self.t, self.e, self.expansions = (zeros() for _ in
                                                      range(4))
        self.frame_done = zeros(b, k, dtype=torch.bool)
        self.score = zeros(b, k, dtype=torch.float32)
        self.label, self.count, self.lm_ctx = (zeros(b, k) for _ in range(3))
        # the state lives in the predictor's dtype (the embedding's)
        self.h = zeros(n_layers, b * k, embed.shape[1], dtype=embed.dtype)
        self.c = torch.zeros_like(self.h)
        self.tokens = zeros(b, k, u_cap, dtype=torch.int32)
        self.frames = torch.zeros_like(self.tokens)
        self.logps = (zeros(b, k, u_cap, dtype=torch.float32) if with_logps
                      else None)
        self.beams = torch.arange(k, device=device)
        # only beam 0 lives at first, so the first selection cannot pick
        # duplicate empty hypotheses
        self.init_score = torch.full((k,), NEG_INF, device=device)
        self.init_score[0] = 0.0
        self.more = torch.zeros((), dtype=torch.bool, device=device)

    def reset(self, enc_proj: torch.Tensor, enc_len: torch.Tensor) -> None:
        self.enc_proj.copy_(enc_proj)
        self.enc_len.copy_(enc_len.clamp(0, self.t_max))
        self.t_hi.copy_(self.enc_len.max())
        for buf in (self.t, self.e, self.expansions, self.frame_done,
                    self.count, self.h, self.c, self.tokens, self.frames):
            buf.zero_()
        if self.logps is not None:
            self.logps.zero_()
        self.score.copy_(self.init_score.expand(self.b, self.k))
        self.label.fill_(self.blank)
        # all-BOS context: BOS = base - 1 in every digit
        self.lm_ctx.fill_(self.lm[1] ** self.lm[2] - 1 if self.lm else 0)

    def _record(self, buf: torch.Tensor, src3: torch.Tensor,
                slot: torch.Tensor, emit: torch.Tensor,
                value: torch.Tensor) -> None:
        """``buf`` gathered by source beam, ``value`` written at ``slot``
        where a beam emitted."""
        out = buf.gather(1, src3)
        old = out.gather(2, slot)[..., 0]
        out.scatter_(2, slot,
                     torch.where(emit, value.to(out.dtype), old)[..., None])
        buf.copy_(out)

    def step(self) -> None:
        b, k, blank = self.b, self.k, self.blank
        run = ((self.t < self.t_hi) & (self.e < self.max_symbols)
               & ~self.frame_done.all())
        active = (self.t < self.enc_len)[:, None]                  # [B, 1]
        t_safe = self.t.clamp(max=self.t_max - 1)
        pred, h_new, c_new = rnnt_predict_step(
            self.head, self.label.view(b * k), self.h, self.c)
        enc_t = self.enc_proj.index_select(1, t_safe.view(1))      # [B, 1, J]
        logp = rnnt_joint_step_preproj(
            self.head, enc_t.expand(b, k, -1).reshape(b * k, -1),
            pred).view(b, k, -1)                                   # [B, K, V+1]

        may_expand = ~self.frame_done & active & (self.count < self.u_cap)
        acoustic = logp[:, :, :blank]
        lab = acoustic
        if self.lm is not None:
            table, base, _, weight, bonus = self.lm
            lab = lab + weight * _lm_rows(table, base, self.lm_ctx) + bonus
        lab_scores = torch.where(may_expand[..., None],
                                 self.score[..., None] + lab, NEG_INF)
        take_blank = ~self.frame_done & active
        stay = self.score + torch.where(take_blank, logp[..., blank], 0.0)
        pool = torch.cat([stay, lab_scores.reshape(b, k * blank)], dim=1)
        top, idx = top_k(pool, k)

        is_stay = idx < k
        lab_idx = (idx - k).clamp(min=0)
        new_lab = torch.where(is_stay, 0, lab_idx % blank)
        # a step that does not run keeps every hypothesis where it is
        src = torch.where(run & ~is_stay, lab_idx // blank,
                          torch.where(run, idx, self.beams))
        emit = ~is_stay & run

        n_layers, _, hidden = self.h.shape
        src4 = src[None, :, :, None].expand(n_layers, b, k, hidden)
        m4 = emit[None, :, :, None]
        for state, new in ((self.h, h_new), (self.c, c_new)):
            old = state.view(n_layers, b, k, hidden).gather(2, src4)
            new = new.view(n_layers, b, k, hidden).gather(2, src4)
            state.copy_(torch.where(m4, new, old).view_as(state))

        count = self.count.gather(1, src)
        slot = count.clamp(max=self.u_cap - 1)[..., None]
        src3 = src[..., None].expand(b, k, self.u_cap)
        self._record(self.tokens, src3, slot, emit, new_lab)
        self._record(self.frames, src3, slot, emit, self.t.expand(b, k))
        if self.logps is not None:
            ac = acoustic.gather(1, src[..., None].expand(b, k, blank))
            self._record(self.logps, src3, slot, emit,
                         ac.gather(2, new_lab[..., None])[..., 0])
        self.count.copy_(count + emit)
        label = torch.where(emit, new_lab, self.label.gather(1, src))
        lm_ctx = self.lm_ctx.gather(1, src)
        if self.lm is not None and self.lm[2] > 0:
            base, ctx_len = self.lm[1], self.lm[2]
            shifted = (lm_ctx % base ** (ctx_len - 1)) * base + new_lab
            lm_ctx = torch.where(emit, shifted, lm_ctx)
        # a stay selection means the hypothesis finished frame t (took
        # blank, was already done, or its sample is past enc_len)
        frame_done = torch.where(
            run, torch.where(emit, self.frame_done.gather(1, src), True),
            self.frame_done)
        self.score.copy_(torch.where(run, top, self.score))
        self.label.copy_(label)
        self.lm_ctx.copy_(lm_ctx)

        # the frame ends after its last expansion
        e = self.e + run
        finish = run & ((e >= self.max_symbols) | frame_done.all())
        self.t += finish
        self.e.copy_(torch.where(finish, 0, e))
        self.frame_done.copy_(frame_done & ~finish)
        self.expansions += run

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()
        self.more.copy_(self.t < self.t_hi)

    def outputs(self) -> Tuple[torch.Tensor, ...]:
        # beams come out of the sort in descending order: beam 0 is best
        out = (self.tokens[:, 0].clone(), self.frames[:, 0].clone(),
               self.count[:, 0].int())
        if self.logps is not None:
            out += (self.logps[:, 0].clone(),)
        return out


class RNNTBeamDecoder(GraphedLoops):
    """RNNT beam search, with its CUDA graphs and counters
    (``GraphedLoops``).

    ``decode`` replays one captured graph of ``chunk`` steps (expansion
    attempts) per host read on CUDA, captured once for each (B, K, T',
    u_cap, ``max_symbols``, LM kind and settings, ``with_logps``, chunk) and
    again when a head weight's or an LM table's storage or version changes;
    on the CPU the steps run eagerly.  ``decode_eager`` runs the eager loop
    on any device: the plain version.  ``last_expansions()`` reads the
    expansions the last decode ran (a host read of its own)."""

    def __init__(self):
        super().__init__()
        self._last: Optional[_BeamLoop] = None

    def decode(self, head, encoded: torch.Tensor, enc_len: torch.Tensor,
               beam_size: int = 4, max_symbols: int = 10,
               max_tokens: int = 0, lm: Optional[tuple] = None,
               lm_weight: float = 0.5, token_bonus: float = 0.0,
               with_logps: bool = False, chunk: int = CHUNK
               ) -> Tuple[torch.Tensor, ...]:
        """encoded [B, T', D], enc_len [B] -> (tokens [B, U_cap], frames
        [B, U_cap], counts [B]) of the best beam, int32; ``with_logps``
        adds the emitted tokens' acoustic fp32 log-probs [B, U_cap].
        ``U_cap = max_tokens or T' * max_symbols``.  ``lm``: None or
        ``lm_device_table``'s (table, base, ctx_len) on the same device."""
        return self._decode(head, encoded, enc_len, beam_size, max_symbols,
                            max_tokens, lm, lm_weight, token_bonus,
                            with_logps, chunk, graph=encoded.is_cuda)

    def decode_eager(self, head, encoded: torch.Tensor,
                     enc_len: torch.Tensor, beam_size: int = 4,
                     max_symbols: int = 10, max_tokens: int = 0,
                     lm: Optional[tuple] = None, lm_weight: float = 0.5,
                     token_bonus: float = 0.0, with_logps: bool = False,
                     chunk: int = CHUNK) -> Tuple[torch.Tensor, ...]:
        """``decode`` with the steps launched one by one, on any device."""
        return self._decode(head, encoded, enc_len, beam_size, max_symbols,
                            max_tokens, lm, lm_weight, token_bonus,
                            with_logps, chunk, graph=False)

    def last_expansions(self) -> int:
        return int(self._last.expansions) if self._last is not None else 0

    @torch.inference_mode()
    def _decode(self, head, encoded, enc_len, beam_size, max_symbols,
                max_tokens, lm, lm_weight, token_bonus, with_logps, chunk,
                graph: bool):
        b, t_max, _ = encoded.shape
        u_cap = max_tokens if max_tokens > 0 else t_max * max_symbols
        dev = encoded.device
        fusion = None
        if lm is not None:
            table, base, ctx_len = lm
            fusion = (table, base, ctx_len, float(lm_weight),
                      float(token_bonus))
        with full_fp32():
            enc_proj = rnnt_joint_enc_proj(head, encoded.float())
            lm_key = None if fusion is None else (
                isinstance(fusion[0], torch.Tensor),) + fusion[1:]
            key = (b, beam_size, t_max, u_cap, max_symbols, lm_key,
                   with_logps, chunk, str(dev))
            stamp = weights_stamp(head) + (
                () if fusion is None else weights_stamp(fusion[0]))
            self._last = self._drive(
                key, stamp,
                lambda: _BeamLoop(head, b, beam_size, t_max, u_cap,
                                  max_symbols, fusion, with_logps, dev),
                (enc_proj, enc_len), chunk, graph, dev)
            return self._last.outputs()


def rnnt_beam_decode(head, encoded: torch.Tensor, enc_len: torch.Tensor,
                     beam_size: int = 4, max_symbols: int = 10,
                     max_tokens: int = 0, lm_table: Optional[LMTable] = None,
                     lm_base: int = 0, lm_ctx_len: int = 0,
                     lm_weight: float = 0.5, token_bonus: float = 0.0,
                     with_logps: bool = False, chunk: int = CHUNK
                     ) -> Tuple[torch.Tensor, ...]:
    """``RNNTBeamDecoder().decode`` for a one-off call, with the JAX
    function's signature: the LM as ``lm_table`` (a dense [C, V] tensor or
    the sparse dict of ``lm_device_table``), ``lm_base`` and
    ``lm_ctx_len``."""
    if lm_table is not None and (lm_base <= 0 or lm_ctx_len < 0):
        raise ValueError(
            "lm_table given but lm_base/lm_ctx_len not set — pass the "
            "(table, base, ctx_len) triple of lm_device_table; silently "
            "ignoring the table would decode without fusion")
    lm = None if lm_table is None else (lm_table, lm_base, lm_ctx_len)
    return RNNTBeamDecoder().decode(head, encoded, enc_len, beam_size,
                                    max_symbols, max_tokens, lm, lm_weight,
                                    token_bonus, with_logps, chunk)


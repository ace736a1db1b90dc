"""RNNT greedy decoding with the label loop on the device (port of
``gigaam_tpu/decode/rnnt_greedy.py``).

The JAX package runs the loop as one ``lax.while_loop``: per-sample frame
pointers and symbol counts, a dense masked step, one host sync per batch.
The port keeps those semantics exactly:

* every sample follows its own (frame, symbol-count) trajectory; the
  predictor state and label advance only on an emission, which needs
  ``k != blank``, ``t < enc_len`` and ``count < u_cap``;
* the frame advances on blank, on an inactive sample, or when the symbol
  count reaches ``max_symbols``;
* a fresh sample needs no special case: the blank embedding row is zero and
  the zero LSTM state is torch's ``None`` state;
* the encoder side of the joint is projected once, before the loop.

One step function updates preallocated buffers in place.  The host reads
one device flag, ``any(t < enc_len)``, after every chunk of ``chunk``
steps and nothing inside a chunk.  Steps after every sample has finished
are no-ops (only ``t`` moves, and it is clamped before the gather), so the
result does not depend on the chunk length.  On CUDA each chunk is a CUDA
graph, captured once per shape and replayed; on the CPU the same steps run
eagerly, and that eager loop is the plain version.  Total steps:
max_b(T'_b + U_b - frames where the symbol cap was hit).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..models.heads import (
    rnnt_joint_enc_proj,
    rnnt_joint_step_preproj,
    rnnt_predict_step,
)
from ..ops.precision import full_fp32

# Steps per host read (and per captured graph).  Chosen on the card by
# chip_smoke.py's chunk A/B (16, 32, 64): see PERF.md.
CHUNK = 32


def _head_leaves(head: Any) -> List[torch.Tensor]:
    if isinstance(head, torch.nn.Module):
        return list(head.parameters())
    if isinstance(head, dict):
        return [t for v in head.values() for t in _head_leaves(v)]
    if isinstance(head, (list, tuple)):
        return [t for v in head for t in _head_leaves(v)]
    return [head]


def weights_stamp(head: Any) -> tuple:
    """Storage and version of every head weight: an in-place update bumps a
    version, a cast or a move replaces a storage.  A captured graph reads
    the weights at the addresses it was captured with."""
    return tuple((t.data_ptr(), t._version) for t in _head_leaves(head))


class _Loop:
    """The loop state of one shape, as preallocated buffers, and the step
    that updates them in place."""

    def __init__(self, head, b: int, t_max: int, u_cap: int,
                 max_symbols: int, with_logps: bool, device: torch.device):
        embed = head["decoder"]["embed"]
        n_layers = len(head["decoder"]["lstm"])
        joint = head["joint"]["enc"]["w"].shape[1]
        self.head = head
        self.blank = embed.shape[0] - 1
        self.t_max, self.u_cap, self.max_symbols = t_max, u_cap, max_symbols
        zeros = lambda *shape, dtype=torch.int64: torch.zeros(  # noqa: E731
            shape, dtype=dtype, device=device)
        self.rows = torch.arange(b, device=device)
        self.enc_proj = zeros(b, t_max, joint, dtype=torch.float32)
        self.enc_len = zeros(b)
        self.t, self.sym, self.label, self.count = (zeros(b) for _ in range(4))
        # the state lives in the predictor's dtype (the embedding's)
        self.h = zeros(n_layers, b, embed.shape[1], dtype=embed.dtype)
        self.c = torch.zeros_like(self.h)
        self.tokens = zeros(b, u_cap)
        self.frames = zeros(b, u_cap)
        self.logps = (zeros(b, u_cap, dtype=torch.float32) if with_logps
                      else None)
        self.more = torch.zeros((), dtype=torch.bool, device=device)

    def reset(self, enc_proj: torch.Tensor, enc_len: torch.Tensor) -> None:
        self.enc_proj.copy_(enc_proj)
        self.enc_len.copy_(enc_len.clamp(0, self.t_max))
        for buf in (self.t, self.sym, self.count, self.h, self.c,
                    self.tokens, self.frames):
            buf.zero_()
        self.label.fill_(self.blank)
        if self.logps is not None:
            self.logps.zero_()

    def step(self) -> None:
        active = self.t < self.enc_len
        t_safe = self.t.clamp(max=self.t_max - 1)
        enc_t = self.enc_proj[self.rows, t_safe]                   # [B, J]
        pred, h_new, c_new = rnnt_predict_step(self.head, self.label,
                                               self.h, self.c)
        logp = rnnt_joint_step_preproj(self.head, enc_t, pred)     # [B, V]
        k = torch.argmax(logp, dim=-1)           # the first maximum
        emit = (k != self.blank) & active & (self.count < self.u_cap)
        # record emissions; a non-emission writes the slot's old value back
        at = (self.rows, self.count.clamp(max=self.u_cap - 1))
        self.tokens[at] = torch.where(emit, k, self.tokens[at])
        self.frames[at] = torch.where(emit, self.t, self.frames[at])
        if self.logps is not None:
            k_lp = logp.gather(1, k[:, None])[:, 0]
            self.logps[at] = torch.where(emit, k_lp, self.logps[at])
        self.count += emit
        # the predictor advances only on an emission
        m = emit[None, :, None]
        torch.where(m, h_new, self.h, out=self.h)
        torch.where(m, c_new, self.c, out=self.c)
        torch.where(emit, k, self.label, out=self.label)
        # the frame advances on blank or inactive, or at the symbol cap
        self.sym += emit
        frame_done = ~emit | (self.sym >= self.max_symbols)
        self.t += frame_done
        self.sym.masked_fill_(frame_done, 0)

    def run(self, steps: int) -> None:
        for _ in range(steps):
            self.step()
        self.more.copy_((self.t < self.enc_len).any())

    def outputs(self) -> Tuple[torch.Tensor, ...]:
        out = (self.tokens.int(), self.frames.int(), self.count.int())
        if self.logps is not None:
            out += (self.logps.clone(),)
        return out


class GraphedLoops:
    """The host side of a device loop (a ``_Loop``-like object with
    ``reset``, ``run(steps)``, a device flag ``more`` and ``outputs``), and
    its CUDA graphs.

    ``_drive`` runs chunks of ``chunk`` steps until the flag is false,
    reading it once per chunk.  With ``graph`` each chunk is one replay of a
    graph captured once per ``key`` (and again when ``stamp``, the storage
    and version of every tensor the loop reads in place, changes); without
    it the steps run eagerly.  A capture or a replay that fails raises.

    Counters: ``captures``, ``replays`` (graph replays), ``eager_chunks``
    and ``host_reads`` (one per chunk: the flag that ends the loop)."""

    def __init__(self):
        self._graphs: Dict[tuple, Tuple[tuple, Any, Any]] = {}
        self.captures = self.replays = self.eager_chunks = 0
        self.host_reads = 0

    def _drive(self, key: tuple, stamp: tuple, make_loop, reset_args: tuple,
               chunk: int, graph: bool, device: torch.device):
        if graph:
            loop, g = self._graph(key, stamp, make_loop, chunk, device)
            run = g.replay
        else:
            loop = make_loop()
            run = lambda: loop.run(chunk)  # noqa: E731
        loop.reset(*reset_args)
        while True:
            run()
            if graph:
                self.replays += 1
            else:
                self.eager_chunks += 1
            self.host_reads += 1
            if not bool(loop.more):
                break
        return loop

    def _graph(self, key, stamp, make_loop, chunk, device):
        have = self._graphs.get(key)
        if have is not None and have[0] == stamp:
            return have[1], have[2]
        self._graphs.pop(key, None)
        loop = make_loop()
        # one eager step on a side stream first: cuBLAS creates its handle
        # and workspace outside the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            loop.run(1)
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        # the caller holds its model's device lock, so no other call on
        # this model launches work now; other threads (another model, a
        # caller waiting for its results) may use the card meanwhile, which
        # the global capture mode would refuse
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            loop.run(chunk)
        self.captures += 1
        self._graphs[key] = (stamp, loop, g)
        return loop, g


class RNNTGreedyDecoder(GraphedLoops):
    """Greedy RNNT decoding, with its CUDA graphs and counters
    (``GraphedLoops``).

    ``decode`` replays one captured graph of ``chunk`` steps per host read
    on CUDA (captured once for each batch rows, T', u_cap, ``max_symbols``,
    ``with_logps`` and chunk, and again when a head weight's storage or
    version changes) and runs the steps eagerly on the CPU.  ``decode_eager``
    runs the eager loop on any device: the plain version."""

    def decode(self, head, encoded: torch.Tensor, enc_len: torch.Tensor,
               max_symbols: int = 10, max_tokens: int = 0,
               with_logps: bool = False, chunk: int = CHUNK
               ) -> Tuple[torch.Tensor, ...]:
        """encoded [B, T', D], enc_len [B] -> (tokens [B, U_cap], frames
        [B, U_cap], counts [B]), int32; ``with_logps`` adds the emitted
        token's fp32 log-prob per slot [B, U_cap].
        ``U_cap = max_tokens or T' * max_symbols``."""
        return self._decode(head, encoded, enc_len, max_symbols, max_tokens,
                            with_logps, chunk, graph=encoded.is_cuda)

    def decode_eager(self, head, encoded: torch.Tensor,
                     enc_len: torch.Tensor, max_symbols: int = 10,
                     max_tokens: int = 0, with_logps: bool = False,
                     chunk: int = CHUNK) -> Tuple[torch.Tensor, ...]:
        """``decode`` with the steps launched one by one, on any device."""
        return self._decode(head, encoded, enc_len, max_symbols, max_tokens,
                            with_logps, chunk, graph=False)

    @torch.inference_mode()
    def _decode(self, head, encoded, enc_len, max_symbols, max_tokens,
                with_logps, chunk, graph: bool):
        b, t_max, _ = encoded.shape
        u_cap = max_tokens if max_tokens > 0 else t_max * max_symbols
        dev = encoded.device
        with full_fp32():
            enc_proj = rnnt_joint_enc_proj(head, encoded.float())
            key = (b, t_max, u_cap, max_symbols, with_logps, chunk, str(dev))
            loop = self._drive(
                key, weights_stamp(head),
                lambda: _Loop(head, b, t_max, u_cap, max_symbols, with_logps,
                              dev),
                (enc_proj, enc_len), chunk, graph, dev)
            return loop.outputs()


def rnnt_greedy_decode(head, encoded: torch.Tensor, enc_len: torch.Tensor,
                       max_symbols: int = 10, max_tokens: int = 0,
                       with_logps: bool = False, chunk: int = CHUNK
                       ) -> Tuple[torch.Tensor, ...]:
    """``RNNTGreedyDecoder().decode`` for a one-off call (a caller that
    decodes repeatedly keeps a decoder, and with it the captured graphs)."""
    return RNNTGreedyDecoder().decode(head, encoded, enc_len, max_symbols,
                                      max_tokens, with_logps, chunk)


def rnnt_extract(
    tokens: np.ndarray, frames: np.ndarray, counts: np.ndarray
) -> List[Tuple[List[int], List[int]]]:
    """Host-side: per sample (token_ids, token_frames)."""
    return [
        (tokens[i, : counts[i]].tolist(), frames[i, : counts[i]].tolist())
        for i in range(tokens.shape[0])
    ]


def trip_count(frames: np.ndarray, counts: np.ndarray, enc_len: np.ndarray,
               max_symbols: int, t_max: int) -> int:
    """The steps the JAX ``while_loop`` takes for these outputs:
    max_b(T'_b + U_b - capped_b), where ``capped_b`` counts the frames at
    which sample b emitted ``max_symbols`` tokens (that emission also
    advanced the frame).  ``enc_len`` is clipped to [0, ``t_max``]."""
    lens = np.clip(np.asarray(enc_len), 0, t_max)
    steps = [0]
    for i in range(frames.shape[0]):
        per_frame = np.bincount(frames[i, :counts[i]])
        capped = int((per_frame == max_symbols).sum())
        steps.append(int(lens[i]) + int(counts[i]) - capped)
    return max(steps)

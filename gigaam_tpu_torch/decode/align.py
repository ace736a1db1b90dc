"""CTC forced alignment: Viterbi over the blank-interleaved target lattice
(port of ``gigaam_tpu/decode/align.py``).

Given audio and a KNOWN transcript, the most probable CTC path that emits
exactly that transcript gives per-token frames, hence word timestamps and
confidences.  States: even = blank, odd s = target token (s-1)//2; the
diagonal skip s-2 -> s is allowed only between distinct adjacent targets
(Graves 2006).  S = 2 * U_pad + 1 with the targets padded to a bucket
(``pad_targets``), so one shape serves every transcript length in it.

The DP is batched over B: the JAX package ``vmap``s its ``lax.scan``; here
one frame step updates [B, S] buffers in place, in a loop with a static trip
count (T' - 1 steps).  ``ViterbiAligner.align`` captures that loop once per
(B, T', S) as one CUDA graph and replays it, with no host read inside; on
the CPU, and in ``align_eager`` on any device, the same steps run eagerly:
the plain version.  Only the int8 backpointers [B, T', S], the final state
and the score leave the device; the O(T) backtrack is host numpy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

NEG = -1e30


class _Lattice:
    """The DP of one shape as preallocated buffers: the emissions, the skip
    mask, the alphas (two NEG columns in front, so that the shifted reads
    s-1 and s-2 are plain views) and the backpointers."""

    def __init__(self, b: int, t_max: int, s: int, device: torch.device):
        f32 = dict(dtype=torch.float32, device=device)
        self.emit = torch.zeros(b, t_max, s, **f32)
        self.can_skip = torch.zeros(b, s, dtype=torch.bool, device=device)
        self.alphas = torch.full((b, t_max, s + 2), NEG, **f32)
        self.bp = torch.zeros(b, t_max, s, dtype=torch.int8, device=device)
        self.neg = torch.full((), NEG, **f32)
        self.two = torch.full((), 2, dtype=torch.int8, device=device)

    def reset(self, emit: torch.Tensor, can_skip: torch.Tensor) -> None:
        self.emit.copy_(emit)
        self.can_skip.copy_(can_skip)
        s_idx = torch.arange(emit.shape[2], device=emit.device)
        self.alphas[:, 0, 2:] = torch.where(s_idx <= 1, emit[:, 0], self.neg)

    def step(self, t: int) -> None:
        """Frame t from frame t-1: stay (0), advance (1) or skip (2), the
        first of equal scores winning, as ``jnp.argmax`` picks."""
        prev = self.alphas[:, t - 1]
        stay, advance = prev[:, 2:], prev[:, 1:-1]
        skip = torch.where(self.can_skip, prev[:, :-2], self.neg)
        take1 = advance > stay
        best = torch.where(take1, advance, stay)
        take2 = skip > best
        best = torch.where(take2, skip, best)
        torch.where(take2, self.two, take1, out=self.bp[:, t])
        new = self.alphas[:, t, 2:]
        torch.add(best, self.emit[:, t], out=new)
        # the floor keeps long infeasible stretches from drifting to -inf
        new.clamp_(min=NEG)

    def run(self) -> None:
        for t in range(1, self.emit.shape[1]):
            self.step(t)


def _lattice_inputs(log_probs: torch.Tensor, targets: torch.Tensor,
                    target_len: torch.Tensor, blank: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(emit [B, T, S], can_skip [B, S]): the log-prob of each state's label
    per frame, NEG on states past 2 * target_len."""
    b, t_max, _ = log_probs.shape
    u_pad = targets.shape[1]
    s = 2 * u_pad + 1
    dev = log_probs.device
    s_idx = torch.arange(s, device=dev)
    is_odd = (s_idx % 2) == 1
    u_idx = torch.div(s_idx - 1, 2, rounding_mode="floor").clamp(
        0, max(u_pad - 1, 0))
    targets = targets.long()
    tok = targets[:, u_idx]                                      # [B, S]
    labels = torch.where(is_odd, tok, blank)
    valid_state = s_idx[None, :] <= 2 * target_len.long()[:, None]
    prev_u = (u_idx - 1).clamp(0, max(u_pad - 1, 0))
    can_skip = is_odd & (s_idx >= 3) & (tok != targets[:, prev_u])
    emit = log_probs.float().gather(
        2, labels[:, None, :].expand(b, t_max, s))
    emit = torch.where(valid_state[:, None, :], emit,
                       torch.full((), NEG, device=dev))
    return emit, can_skip


def _finish(lat: _Lattice, enc_len: torch.Tensor, target_len: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t_max = lat.bp.shape[:2]
    rows = torch.arange(b, device=lat.bp.device)
    last = (enc_len.long() - 1).clamp(0, t_max - 1)
    alpha_final = lat.alphas[rows, last, 2:]                     # [B, S]
    tl = target_len.long()
    end_a = 2 * tl                                               # final blank
    end_b = (2 * tl - 1).clamp(min=0)                            # final token
    score_a = alpha_final[rows, end_a]
    score_b = torch.where(tl > 0, alpha_final[rows, end_b], lat.neg)
    final_state = torch.where(score_a >= score_b, end_a, end_b)
    score = torch.maximum(score_a, score_b)
    # a path that merely survived the NEG floor is still infeasible
    score = torch.where(score <= NEG / 2, lat.neg, score)
    return lat.bp.clone(), final_state.int(), score


class ViterbiAligner:
    """The batched Viterbi DP, with its CUDA graphs and counters.

    ``align`` replays one captured graph of the T' - 1 frame steps per call
    on CUDA (captured once for each (B, T', S) and device) and runs the
    steps eagerly on the CPU; ``align_eager`` runs them eagerly on any
    device: the plain version.  A capture or a replay that fails raises.
    Counters: ``captures``, ``replays``, ``eager_runs``."""

    def __init__(self):
        self._graphs: Dict[tuple, Tuple[_Lattice, Any]] = {}
        self.captures = self.replays = self.eager_runs = 0

    def align(self, log_probs: torch.Tensor, enc_len: torch.Tensor,
              targets: torch.Tensor, target_len: torch.Tensor, blank: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``log_probs`` [B, T, V] (log-softmax over V, blank included),
        ``enc_len`` [B], ``targets`` [B, U_pad] (entries past
        ``target_len`` [B] are padding) -> (backpointers [B, T, S] int8,
        final state [B] int32, score [B] fp32), S = 2 * U_pad + 1;
        ``score`` is the best complete path's log-prob, NEG where the
        transcript cannot fit into ``enc_len`` frames."""
        return self._align(log_probs, enc_len, targets, target_len, blank,
                           graph=log_probs.is_cuda)

    def align_eager(self, log_probs, enc_len, targets, target_len, blank):
        """``align`` with the steps launched one by one, on any device."""
        return self._align(log_probs, enc_len, targets, target_len, blank,
                           graph=False)

    @torch.inference_mode()
    def _align(self, log_probs, enc_len, targets, target_len, blank,
               graph: bool):
        emit, can_skip = _lattice_inputs(log_probs, targets, target_len,
                                         blank)
        b, t_max, s = emit.shape
        if graph and t_max > 1:
            lat, g = self._graph(b, t_max, s, emit.device)
            lat.reset(emit, can_skip)
            g.replay()
            self.replays += 1
        else:
            lat = _Lattice(b, t_max, s, emit.device)
            lat.reset(emit, can_skip)
            lat.run()
            self.eager_runs += 1
        return _finish(lat, enc_len, target_len)

    def _graph(self, b: int, t_max: int, s: int, device: torch.device):
        key = (b, t_max, s, str(device))
        have = self._graphs.get(key)
        if have is not None:
            return have
        lat = _Lattice(b, t_max, s, device)
        # one eager step on a side stream first, outside the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            lat.step(1)
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        # the caller holds its model's device lock, so no other call on
        # this model launches work now; other threads (another model, a
        # caller waiting for its results) may use the card meanwhile, which
        # the global capture mode would refuse
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            lat.run()
        self.captures += 1
        self._graphs[key] = (lat, g)
        return lat, g


def viterbi_align(log_probs: torch.Tensor, enc_len: torch.Tensor,
                  targets: torch.Tensor, target_len: torch.Tensor,
                  blank: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ViterbiAligner().align`` for a one-off call (a caller that aligns
    repeatedly keeps an aligner, and with it the captured graphs)."""
    return ViterbiAligner().align(log_probs, enc_len, targets, target_len,
                                  blank)


def backtrack(
    bp: np.ndarray,
    final_state: int,
    enc_len: int,
    n_targets: int,
    log_probs: Optional[np.ndarray] = None,
    targets: Optional[np.ndarray] = None,
) -> Tuple[List[int], Optional[List[float]]]:
    """Host-side O(T) walk of one sample's backpointers [T, S].

    Returns ``(first_frames [n_targets], mean_logps or None)``:
    ``first_frames[u]`` is the frame at which the path ENTERS token u's
    state (the CTC greedy decoder's first-emission semantics) and
    ``mean_logps[u]`` averages the token's posterior over every frame the
    path occupies it (feeds ``Word.confidence``)."""
    first = [0] * n_targets
    sums = [0.0] * n_targets
    counts = [0] * n_targets
    state = int(final_state)
    for t in range(int(enc_len) - 1, -1, -1):
        if state % 2 == 1:
            u = (state - 1) // 2
            if u < n_targets:
                first[u] = t
                if log_probs is not None and targets is not None:
                    sums[u] += float(log_probs[t, int(targets[u])])
                    counts[u] += 1
        if t > 0:
            state -= int(bp[t, state])
    if log_probs is None or targets is None:
        return first, None
    logps = [sums[u] / counts[u] if counts[u] else NEG
             for u in range(n_targets)]
    return first, logps


def pad_targets(ids: List[int], bucket: int = 32) -> np.ndarray:
    """Token ids padded with 0 to the next multiple of ``bucket`` (the DP
    masks states past ``target_len``)."""
    u = max(len(ids), 1)
    u_pad = ((u + bucket - 1) // bucket) * bucket
    out = np.zeros((u_pad,), np.int32)
    out[:len(ids)] = ids
    return out

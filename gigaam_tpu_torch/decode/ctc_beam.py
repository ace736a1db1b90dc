"""CTC prefix beam search (sum over alignments) on the host: a copy of
``gigaam_tpu/decode/ctc_beam.py`` (numpy only).

The reference decodes CTC by per-frame argmax only
(``gigaam/decoding.py:47-96``); prefix beam search instead scores label
*strings* by the sum of all alignments (Hannun et al., 2014), which can
recover tokens the best path misses.  This is an extension over the
reference — ``transcribe(..., beam_size=N)`` uses it for CTC models.

Runs on host numpy over the [T, V] log-probs the fused forward already
produces: label-string bookkeeping is dict-of-prefixes work that has no
dense device formulation, matches how CTC beam decoders deploy in practice
(CPU post-processing of acoustic posteriors), and only runs when the user
asks for beam decoding — the hot serving path stays the fused on-device
greedy graph.

Per-frame candidate *scoring* is vectorized: the [K, P] stay/collapse/
extension score grid is one numpy pass, and only the ``merge_cap * K``
best candidate cells enter the Python dict-merge (when that cap covers
the whole grid — as in every unit-test shape — the result is identical
to the unpruned algorithm; beyond it, dropped cells are the lowest-
scoring summands of surviving prefixes, the standard beam approximation).
The merge loop is scalar Python, so ``_lae`` is a scalar logaddexp.
"""

from __future__ import annotations

from math import exp, log1p
from typing import Dict, List, Optional, Tuple

import numpy as np

NEG_INF = -np.inf


def _lae(a: float, b: float) -> float:
    """Scalar logaddexp: ~10x faster than np.logaddexp on Python floats
    (the per-frame merge loop is scalar-bound)."""
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    d = a - b
    return a + log1p(exp(-d)) if d > 0 else b + log1p(exp(d))


def ctc_prefix_beam(
    log_probs: np.ndarray,
    length: Optional[int] = None,
    beam_size: int = 8,
    prune_vocab: int = 16,
    blank: Optional[int] = None,
    lm=None,
    lm_weight: float = 0.5,
    token_bonus: float = 0.0,
    merge_cap: int = 4,
) -> Tuple[List[int], List[int]]:
    """Prefix beam search over ``log_probs`` [T, V] (blank = V-1 by the
    framework's convention).  Returns (token_ids, emit_frames) of the best
    prefix by total (blank + non-blank) log probability.

    ``prune_vocab`` caps per-frame expansion to the top-P symbols (the
    standard emission-pruning heuristic); the blank is always considered.
    ``merge_cap``: at most ``merge_cap * beam_size`` non-blank candidate
    cells per frame enter the prefix merge — *without* an LM.  Under
    shallow fusion the cap is disabled entirely (every cell of the pruned
    ``beam x prune_vocab`` grid is merged): the acoustic-only ranking the
    cap would use can discard exactly the extensions the LM rescues, and
    the grid is already bounded by ``prune_vocab``, so the perf cost is
    bounded too.

    ``lm`` (a ``decode.lm.NGramLM`` or anything with
    ``logp(token, context)``) enables shallow fusion: prefixes are ranked
    and pruned by ``log p_acoustic + lm_weight * log p_LM(prefix)
    + token_bonus * len(prefix)``.  The acoustic probabilities themselves
    stay unfused (the forward recursion must sum true posteriors); only
    selection is biased — standard shallow fusion.
    """
    if blank is None:
        blank = log_probs.shape[-1] - 1
    t_max = log_probs.shape[0] if length is None else min(
        int(length), log_probs.shape[0])
    use_lm = lm is not None and lm_weight != 0.0

    # beam state as parallel arrays/lists (index k = one live prefix)
    prefixes: List[Tuple[int, ...]] = [()]
    frames: List[List[int]] = [[]]
    lm_scores: List[float] = [0.0]
    p_b = np.array([0.0])
    p_nb = np.array([NEG_INF])
    last = np.array([-1])

    for t in range(t_max):
        lp = log_probs[t]
        if prune_vocab < len(lp):
            cand = np.argpartition(lp, -prune_vocab)[-prune_vocab:]
        else:
            cand = np.arange(len(lp))
        cand = cand[cand != blank]
        k_beams, n_cand = len(prefixes), len(cand)

        with np.errstate(invalid="ignore"):
            total = np.logaddexp(p_b, p_nb)                       # [K]
            is_rep = cand[None, :] == last[:, None]               # [K, P]
            lp_cand = lp[cand][None, :]
            # extension: repeated symbols may only extend through a
            # separating blank (source p_b); others from the full mass
            ext_score = np.where(is_rep, p_b[:, None],
                                 total[:, None]) + lp_cand
            # collapse: repeated symbol without blank stays on the prefix
            col_score = np.where(is_rep, p_nb[:, None] + lp_cand, NEG_INF)
        rank = np.maximum(ext_score, col_score)

        flat = rank.ravel()
        # Cap selection ranks by acoustic score only; under shallow fusion
        # an LM-favored extension could be dropped before the fused ranking
        # ever sees it, so the cap never binds when an LM is active.
        m = flat.size if use_lm else min(merge_cap * beam_size, flat.size)
        if m < flat.size:
            sel = np.argpartition(flat, -m)[-m:]
        else:
            sel = np.arange(flat.size)

        # prefix -> [p_b, p_nb, frames, best_source_score, lm_score];
        # frames follow the highest-scoring way of *creating* the prefix
        nxt: Dict[Tuple[int, ...], List] = {}

        # stay-via-blank for every live prefix
        stay_k = (total + lp[blank]).tolist()
        total_l = total.tolist()
        for k in range(k_beams):
            key = prefixes[k]
            s = nxt.get(key)
            if s is None:
                s = [NEG_INF, NEG_INF, None, NEG_INF, lm_scores[k]]
                nxt[key] = s
            s[0] = _lae(s[0], stay_k[k])
            if s[3] < total_l[k]:
                s[2], s[3] = frames[k], total_l[k]

        ext_l = ext_score
        col_l = col_score
        for fi in sel:
            if flat[fi] == NEG_INF:
                continue
            k, j = divmod(int(fi), n_cand)
            c = int(cand[j])
            if is_rep[k, j] and col_score[k, j] != NEG_INF:
                s = nxt.get(prefixes[k])
                if s is None:
                    s = [NEG_INF, NEG_INF, None, NEG_INF, lm_scores[k]]
                    nxt[prefixes[k]] = s
                s[1] = _lae(s[1], col_l[k, j])
                if s[3] < total_l[k]:
                    s[2], s[3] = frames[k], total_l[k]
            if ext_score[k, j] != NEG_INF:
                key = prefixes[k] + (c,)
                e = nxt.get(key)
                if e is None:
                    e_lm = (lm_scores[k] + lm.logp(c, prefixes[k])
                            if use_lm else 0.0)
                    e = [NEG_INF, NEG_INF, None, NEG_INF, e_lm]
                    nxt[key] = e
                e[1] = _lae(e[1], ext_l[k, j])
                src = p_b[k] if is_rep[k, j] else total_l[k]
                if e[3] < src:
                    e[2], e[3] = frames[k] + [t], src

        def fused(key, v):
            return (_lae(v[0], v[1]) + lm_weight * v[4]
                    + token_bonus * len(key))

        ranked = sorted(nxt.items(), key=lambda kv: fused(*kv),
                        reverse=True)[:beam_size]
        prefixes = [k for k, _ in ranked]
        p_b = np.array([v[0] for _, v in ranked])
        p_nb = np.array([v[1] for _, v in ranked])
        frames = [v[2] for _, v in ranked]
        lm_scores = [v[4] for _, v in ranked]
        last = np.array([k[-1] if k else -1 for k in prefixes])

    best_i = int(np.argmax([
        _lae(p_b[k], p_nb[k]) + lm_weight * lm_scores[k]
        + token_bonus * len(prefixes[k])
        for k in range(len(prefixes))
    ]))
    if frames[best_i] is None:  # every path had -inf score (degenerate)
        return [], []
    return list(prefixes[best_i]), list(frames[best_i])


def ctc_beam_batch(
    log_probs: np.ndarray,
    lengths: np.ndarray,
    beam_size: int = 8,
    lm=None,
    lm_weight: float = 0.5,
    token_bonus: float = 0.0,
) -> List[Tuple[List[int], List[int]]]:
    """Batch wrapper: [B, T, V] + [B] -> per-sample (tokens, frames)."""
    return [
        ctc_prefix_beam(log_probs[b], int(lengths[b]), beam_size=beam_size,
                        lm=lm, lm_weight=lm_weight, token_bonus=token_bonus)
        for b in range(log_probs.shape[0])
    ]

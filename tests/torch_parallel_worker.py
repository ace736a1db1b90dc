"""The ranks of ``tests/test_torch_parallel.py``, and the scenarios both
sides of its comparisons run.

Run as a script, one process per rank, on the CPU over ``gloo``::

    python tests/torch_parallel_worker.py <task> <rank> <world> <port> <out>

``task`` is ``inference`` (data 2: ``GigaAM.set_mesh`` and the batch entry
points) or ``training`` (data 2 x model 2: ``FineTuner`` for a rotary and a
rel-pos CTC model, ``SSLPretrainer``, the artifact and the train
checkpoint).  Each rank pickles what it saw to ``<out>/rank<r>.pkl``; the
test runs the same scenario in one process and compares.  This module
imports torch, numpy and the port only: the ranks never load jax.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Dict, List

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import gigaam_tpu_torch as gt  # noqa: E402
from gigaam_tpu_torch import config as cfgmod  # noqa: E402
from gigaam_tpu_torch.models import encoder as tenc  # noqa: E402
from gigaam_tpu_torch.parallel.mesh import gather_params  # noqa: E402
from gigaam_tpu_torch.train.finetune import FineTuner, TrainConfig  # noqa
from gigaam_tpu_torch.train.pretrain import (  # noqa: E402
    PretrainConfig,
    SSLPretrainer,
)
from gigaam_tpu_torch.weights import save_model  # noqa: E402

SR = 16000
# the chunk policy's keywords: ~40 s make more than two batches of 2
POLICY = dict(max_duration=8.0, min_duration=5.0)


def encoder_cfg(attention: str, d_model: int = 64, n_heads: int = 4):
    return cfgmod.EncoderConfig(
        feat_in=64, n_layers=2, d_model=d_model, n_heads=n_heads,
        ff_expansion_factor=2, conv_kernel_size=7, pos_emb_max_len=256,
        self_attention_model=attention)


def ctc_cfg(attention: str = "rotary") -> gt.ModelConfig:
    return gt.ModelConfig(
        model_name=f"tiny_{attention}_ctc", model_class="asr",
        preprocessor=cfgmod.FeaturesConfig(center=attention != "rotary"),
        encoder=encoder_cfg(attention),
        head=cfgmod.CTCHeadConfig(feat_in=64,
                                  num_classes=len(cfgmod.RU_VOCAB) + 1),
        decoding=cfgmod.DecodingConfig(kind="ctc_greedy",
                                       vocabulary=list(cfgmod.RU_VOCAB)))


def rnnt_cfg() -> gt.ModelConfig:
    v = len(cfgmod.RU_VOCAB) + 1
    return gt.ModelConfig(
        model_name="tiny_rotary_rnnt", model_class="asr",
        preprocessor=cfgmod.FeaturesConfig(center=False),
        encoder=encoder_cfg("rotary"),
        head=cfgmod.RNNTHeadConfig(
            decoder=cfgmod.RNNTDecoderConfig(pred_hidden=32,
                                             pred_rnn_layers=1,
                                             num_classes=v),
            joint=cfgmod.RNNTJointConfig(enc_hidden=64, pred_hidden=32,
                                         joint_hidden=48, num_classes=v)),
        decoding=cfgmod.DecodingConfig(kind="rnnt_greedy",
                                       vocabulary=list(cfgmod.RU_VOCAB)))


def ssl_cfg() -> gt.ModelConfig:
    return gt.ModelConfig(model_name="tiny_ssl", model_class="ssl",
                          preprocessor=cfgmod.FeaturesConfig(),
                          encoder=encoder_cfg("rotary", d_model=32))


def voice(seconds: float, rng) -> np.ndarray:
    tt = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(100, 220)
    sig = sum(np.sin(2 * np.pi * f0 * h * tt) / h for h in range(1, 5))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * tt + rng.uniform(0, 6)))
    return (0.2 * sig * env + 0.02 * rng.standard_normal(tt.shape)).astype(
        np.float32)


def clips(n: int, seed: int, lo: float = 1.0, hi: float = 3.0):
    rng = np.random.default_rng(seed)
    return [voice(rng.uniform(lo, hi), rng) for _ in range(n)]


def longform_audio(seconds: float, seed: int) -> np.ndarray:
    """Bursts of 2-7 s between 0.6-1.5 s of faint noise."""
    rng = np.random.default_rng(seed)
    parts, total = [], 0
    while total < seconds * SR:
        parts += [voice(rng.uniform(2.0, 7.0), rng),
                  (1e-4 * rng.standard_normal(
                      int(rng.uniform(0.6, 1.5) * SR))).astype(np.float32)]
        total += len(parts[-2]) + len(parts[-1])
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

class FoldCounter:
    """Counts the encoder's K1 and K2 calls (their CPU plain versions run
    here; the card's launch counters stay at 0 on the CPU)."""

    def __init__(self):
        self.calls = {"K1": 0, "K2": 0}
        self._orig = (tenc.folded_rotary_attention_lnres,
                      tenc.folded_rotary_attention)

        def counted(key, fn):
            def wrapper(*a, **k):
                self.calls[key] += 1
                return fn(*a, **k)
            return wrapper

        tenc.folded_rotary_attention_lnres = counted("K1", self._orig[0])
        tenc.folded_rotary_attention = counted("K2", self._orig[1])

    def take(self) -> Dict[str, int]:
        out, self.calls = self.calls, {"K1": 0, "K2": 0}
        return out

    def close(self) -> None:
        (tenc.folded_rotary_attention_lnres,
         tenc.folded_rotary_attention) = self._orig


def inference_models():
    ctc = gt.GigaAMASR(ctc_cfg(), seed=3, device="cpu")
    rnnt = gt.GigaAMASR(rnnt_cfg(), seed=4, device="cpu")
    # a random CTC head emits one token everywhere: centre its weights so
    # that the frames steer it and the texts and alignments hold words
    with torch.no_grad():
        w = ctc.head["proj"]["w"]
        w.mul_(8.0).sub_(w.mean(dim=1, keepdim=True))
    return ctc, rnnt


def words_of(words) -> List[tuple]:
    return [(w.text, w.start, w.end, w.confidence) for w in words or []]


def inference_results(ctc, rnnt, port: bool = True) -> Dict[str, Any]:
    """Every batch entry point once, in one order; what each returned and,
    for the port's models (``port``), the K1/K2 calls of the first four.
    The same calls run on the JAX package's models, which return the same
    types."""
    fold = FoldCounter() if port else None
    try:
        return _inference_results(ctc, rnnt, fold)
    finally:
        if fold is not None:
            fold.close()


def _inference_results(ctc, rnnt, fold) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, model in (("ctc", ctc), ("rnnt", rnnt)):
        for b in (2, 3):
            rows = model._decode_batch(clips(b, seed=10 + b), True)
            out[f"{name}_batch{b}"] = [(t, words_of(w)) for t, w in rows]
            if fold is not None:
                out[f"{name}_batch{b}_folds"] = fold.take()
    res = ctc.transcribe_longform(longform_audio(40.0, seed=7),
                                  word_timestamps=True, fr_batch_size=2,
                                  **POLICY)
    out["longform"] = [(s.text, words_of(s.words), s.start, s.end)
                       for s in res.segments]
    texts = [t for t, _ in out["ctc_batch3"]]
    aligned = ctc.align_batch(clips(3, seed=13), texts)
    out["align"] = [(r.text, words_of(r.words)) for r in aligned]
    enc, lens = ctc.encode_batch(clips(3, seed=20))
    out["encode"] = (np.asarray(enc), np.asarray(lens))
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def ctc_batch(vocab: int, b: int = 4, seed: int = 5):
    """b clips of 1-2 s with transcripts of ids below ``vocab`` (rows of
    several lengths, so that the padded tail and the BatchNorm's zeros
    count)."""
    rng = np.random.default_rng(seed)
    wavs = clips(b, seed, lo=1.0, hi=2.0)
    n = max(len(w) for w in wavs)
    batch = np.zeros((b, n), np.float32)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = w
    lens = np.array([len(w) for w in wavs], np.int32)
    tok_lens = rng.integers(2, 6, size=b).astype(np.int32)
    tokens = np.zeros((b, int(tok_lens.max())), np.int32)
    for i, k in enumerate(tok_lens):
        tokens[i, :k] = rng.integers(0, vocab, size=k)
    return batch, lens, tokens, tok_lens


# the trainers' settings, the same for the JAX package's trainers
TRAIN_KW = dict(lr=1e-3, total_steps=10, precision="fp32")
SSL_KW = dict(lr=2e-3, total_steps=10, precision="fp32", codebook_size=32,
              codebook_dim=8, mask_prob=0.2, mask_span=3)
TRAIN_SEEDS = {"rotary": 6, "rel_pos": 6, "ssl": 8}


def train_model(kind: str):
    """The initial model of a trainer kind ("rotary", "rel_pos", "ssl")."""
    if kind == "ssl":
        return gt.GigaAM(ssl_cfg(), seed=TRAIN_SEEDS[kind], device="cpu")
    return gt.GigaAMASR(ctc_cfg(kind), seed=TRAIN_SEEDS[kind], device="cpu")


def train_batch(kind: str, model):
    """The batch of a trainer kind: 4 rows, (wavs, lens) for BEST-RQ."""
    if kind == "ssl":
        return ctc_batch(2)[:2]
    return ctc_batch(len(model.tokenizer))


def draw_starts(shape, p: float) -> np.ndarray:
    """BEST-RQ's span starts, drawn by numpy from their shape."""
    rng = np.random.default_rng(100 + int(np.prod(shape)))
    return rng.random(shape) < p


def draw_normal(shape) -> np.ndarray:
    """BEST-RQ's unit noise, drawn by numpy from its shape."""
    rng = np.random.default_rng(200 + int(np.prod(shape)))
    return rng.standard_normal(shape).astype(np.float32)


class InjectedSSL(SSLPretrainer):
    """BEST-RQ with its starts and noise drawn by numpy from the call's
    shape: the same draws in one process, on every rank and in the JAX
    package's trainer (``jax.random`` patched to the same functions)."""

    def sample_starts(self, b, t_sub, gen):
        return torch.from_numpy(draw_starts((b, t_sub), self.pc.mask_prob))

    def sample_noise(self, shape, gen):
        return torch.from_numpy(self.pc.noise_std * draw_normal(shape))


def snapshot(model) -> Dict[str, Any]:
    """The whole parameter tree, copied (``params_to_jax`` gives views of
    the CPU parameters, which the next step updates in place)."""
    def copied(tree):
        if isinstance(tree, dict):
            return {k: copied(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [copied(v) for v in tree]
        return np.array(tree)

    return copied(gather_params(model))


def by_name(trainer, kind: str, grads: bool = False) -> Dict[str, Any]:
    """Every leaf's parameter (or gradient), whole, by its port name."""
    return trainer._gather_shards({
        f"{kind}/{n}": (p.grad if grads else p.detach()).numpy().copy()
        for n, p in trainer._named if not grads or p.grad is not None})


def step_record(trainer, m) -> Dict[str, Any]:
    """A step's loss, norm and applied rate, the whole parameter tree after
    it, and every leaf's gradient (clipped, as AdamW took it) and value by
    port name."""
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "lr": m["lr"], "params": snapshot(trainer.model),
            "grads": by_name(trainer, "grad", grads=True),
            "named": by_name(trainer, "param")}


def training_results(mesh, out_dir: str, tag: str) -> Dict[str, Any]:
    """Three steps of each trainer (rotary and rel-pos CTC, BEST-RQ): each
    step's record (``step_record``) and the leaves before the first; after
    the first step (whose rate is 0, so that both sides still hold the same
    weights) the eval step and, for the rotary model, the saved artifact;
    after the third a train checkpoint and whether restoring it keeps every
    leaf."""
    tc = TrainConfig(**TRAIN_KW)
    out: Dict[str, Any] = {}
    for attention in ("rotary", "rel_pos"):
        model = train_model(attention)
        ft = FineTuner(model, tc, mesh=mesh)
        batch = train_batch(attention, model)
        out[f"{attention}_init"] = by_name(ft, "param")
        out[attention] = [step_record(ft, ft.train_step(batch))]
        out[f"{attention}_eval"] = ft.eval_step(batch)
        # 3 rows over data 2: padded with a zero-length row, which no mean
        # counts
        out[f"{attention}_eval3"] = ft.eval_step(tuple(x[:3] for x in batch))
        if attention == "rotary":
            save_model(model, os.path.join(out_dir, f"{tag}_art"))
        out[attention] += [step_record(ft, ft.train_step(batch))
                           for _ in range(2)]
        if attention == "rotary":
            path = os.path.join(out_dir, f"{tag}.ckpt")
            ft.save_checkpoint(path)
            before = snapshot(model)
            ft.restore_checkpoint(path)
            out["restored_equal"] = all(
                np.array_equal(a, b) for a, b in zip(
                    flat(before), flat(snapshot(model))))
    pt = InjectedSSL(train_model("ssl"), PretrainConfig(**SSL_KW), mesh=mesh)
    batch = train_batch("ssl", pt.model)
    out["ssl_init"] = by_name(pt, "param")
    out["ssl"] = [step_record(pt, pt.train_step(batch))]
    out["ssl_eval"] = pt.eval_step(batch)
    out["ssl_eval3"] = pt.eval_step(tuple(x[:3] for x in batch))
    out["ssl"] += [step_record(pt, pt.train_step(batch)) for _ in range(2)]
    return out


def flat(tree) -> List[np.ndarray]:
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in flat(v)]
    return [np.asarray(tree)]


def main(argv: List[str]) -> None:
    import torch.distributed as tdist

    from gigaam_tpu_torch.parallel import distributed as pdist
    from gigaam_tpu_torch.parallel.mesh import make_mesh

    task, rank, world, port, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pdist.initialize("gloo", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=world, rank=rank)
    if task == "inference":
        mesh = make_mesh(data=world)
        ctc, rnnt = inference_models()
        ctc.set_mesh(mesh)
        rnnt.set_mesh(mesh)
        result = inference_results(ctc, rnnt)
    else:
        mesh = make_mesh(data=2, model=world // 2)
        result = training_results(mesh, out_dir, "mesh")
    result["jax_loaded"] = any(
        m in ("jax", "gigaam_tpu") or m.startswith(("jax.", "gigaam_tpu."))
        for m in sys.modules)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    tdist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])

"""Fine-tuning CLI (port of ``gigaam_tpu/train/train.py``, the mirror of
the reference ``train_utils/train.py``).

Usage:
  python -m gigaam_tpu_torch.train.train --model_name v3_ctc \\
      --train_manifest train.tsv --val_manifest val.tsv \\
      --save_dir exp/run1 [flags]

``--model_name`` is anything ``load_model`` takes: a ``save_model``
artifact (``.npz`` + ``.json``), a reference ``.ckpt`` file, a model name
(``v3_ctc``, ``ctc``, ...; downloaded and converted once), or a preset name
with ``--init random``.  The run is on the card unless ``--device cpu`` is
given.

Across devices, one process per device under ``torchrun``::

  torchrun --nproc_per_node 4 -m gigaam_tpu_torch.train.train \
      --model_name v3_ctc --data_parallel 2 --model_parallel 2 [flags]

``--model_parallel`` shards the encoder over that many ranks
(tensor parallelism), ``--data_parallel`` (0: the largest size that divides
``--batch_size`` and fits the processes, the JAX CLI's choice) splits each
batch's rows; their product must be the number of processes.  Every rank
reads the same batches; rank 0 alone writes metrics and checkpoints.  The
backend is ``nccl`` on the card (each rank takes the card of its
``LOCAL_RANK``) and ``gloo`` with ``--device cpu``.

Differences from the reference:
  * a ("data", "model") ``DeviceMesh`` with explicit collectives
    (``parallel/mesh.py``), not Lightning DDP;
  * batches are padded to bucketed lengths, as the JAX package pads them;
  * metrics stream to ``<save_dir>/metrics.jsonl`` (+ stdout); checkpoints
    are npz train states with top-k selection on val WER; the final model
    is a ``save_model`` artifact that the JAX package loads too.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Tuple


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GigaAM fine-tuning (PyTorch/CUDA)")
    # model / data
    p.add_argument("--model_name", required=True,
                   help="native artifact, reference .ckpt or model name, "
                        "or a preset name with --init random")
    p.add_argument("--init", choices=["weights", "random"], default="weights",
                   help="'random': seed-initialized weights for a preset")
    p.add_argument("--device", default=None,
                   help="torch device; default: the card (raises without "
                        "one)")
    p.add_argument("--train_manifest", required=True)
    p.add_argument("--val_manifest", required=True)
    p.add_argument("--min_duration", type=float, default=0.0)
    p.add_argument("--max_duration", type=float, default=None)
    p.add_argument("--raw_text", action="store_true")
    p.add_argument("--eval_batch_size", type=int, default=None,
                   help="validation batch size (default: --batch_size)")
    p.add_argument("--val_first_batches", type=int, default=None,
                   help="validate on only the first N batches")
    # optimization (reference ``train.py:23-74``)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_steps", type=int, default=0,
                   help="step-mode scheduling; 0 = use --epochs")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--freeze_encoder", action="store_true")
    p.add_argument("--activation_checkpointing", action="store_true")
    p.add_argument("--remat_policy", choices=["full", "dots"], default="full",
                   help="with --activation_checkpointing: 'full' recomputes "
                        "whole layers in backward (reference semantics); "
                        "'dots' saves matmul outputs (faster, more memory)")
    p.add_argument("--rnnt_time_chunk", type=int, default=64)
    # spec augment (reference defaults, ``module.py:29-32``)
    p.add_argument("--spec_augment", action="store_true")
    p.add_argument("--freq_masks", type=int, default=2)
    p.add_argument("--freq_width", type=int, default=27)
    p.add_argument("--time_masks", type=int, default=2)
    p.add_argument("--time_width", type=int, default=20)
    # loop control
    p.add_argument("--val_every_n_steps", type=int, default=0,
                   help="0 = validate once per epoch")
    p.add_argument("--log_every_n_steps", type=int, default=10)
    p.add_argument("--train_wer_every_n_steps", type=int, default=0,
                   help="decode the current train batch and log train/wer "
                        "every N steps (reference module.py:200-213); 0=off")
    p.add_argument("--save_dir", default="exp/default")
    p.add_argument("--exp_name", default=None,
                   help="run subdirectory under --save_dir; the literal "
                        "'auto' derives a name from the hyperparameters "
                        "(reference build_exp_name, "
                        "train_utils/utils.py:168-218)")
    p.add_argument("--save_top_k", type=int, default=1,
                   help="best-val_wer checkpoints to keep; 0 = none, "
                        "-1 = keep all (Lightning convention)")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--init_encoder_from", default=None,
                   help="native SSL/model artifact (.npz/.json pair, e.g. "
                        "pretrain.py's final.npz) whose encoder initializes "
                        "this model before fine-tuning — the SSL->ASR "
                        "handoff (reference v*_ssl lineage)")
    p.add_argument("--initial_validation", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    add_parallel_args(p)
    return p.parse_args(argv)


def add_parallel_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_parallel", type=int, default=0,
                   help="data-parallel size; 0 = the largest that divides "
                        "--batch_size and fits the processes")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel size (the encoder's shards)")


def parallel_setup(args) -> Tuple[Optional[str], object]:
    """(this process's device, its mesh or None) from the CLI's flags and
    ``torchrun``'s environment (``gigaam_tpu/train/train.py:265-283``)."""
    from ..parallel import distributed as pdist

    device = args.device
    if pdist._env_configured() and device is None:
        import torch

        device = f"cuda:{pdist.local_rank()}"
        torch.cuda.set_device(device)
    backend = ("gloo" if device is not None and device.startswith("cpu")
               else "nccl")
    pdist.initialize(backend)
    world, mp = pdist.world_size(), args.model_parallel
    if world == 1 and mp == 1:
        return device, None
    dp = args.data_parallel
    if dp == 0:
        dp = next((c for c in range(world // mp, 0, -1)
                   if args.batch_size % c == 0), 1)
    if args.batch_size % dp:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible "
                         f"by data-parallel size {dp}")
    if dp * mp != world:
        raise SystemExit(f"data {dp} x model {mp} needs {dp * mp} "
                         f"processes, {world} were launched")
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(data=dp, model=mp,
                     device_type="cuda" if backend == "nccl" else "cpu")
    if pdist.rank() == 0:
        print(f"mesh: data={dp} model={mp} ({world} processes, {backend})")
    return device, mesh


def _fmt_num(v) -> str:
    return f"{v:g}".replace("+0", "+").replace("-0", "-")


def _sanitize_name(name: str) -> str:
    import re

    return re.sub(r"[^a-zA-Z0-9._-]+", "_", name).strip("._-") or "exp"


def experiment_name(args) -> str:
    """Unique run name derived from the hyperparameters that affect
    training dynamics, skipping values at their defaults (reference
    ``build_exp_name``, ``train_utils/utils.py:168-218``)."""
    base = os.path.basename(str(args.model_name))
    for suf in (".npz", ".json", ".ckpt"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    parts = [base.replace("_", "")]
    parts += [f"lr{_fmt_num(args.lr)}", f"wd{_fmt_num(args.weight_decay)}",
              f"b{args.batch_size}"]
    if args.accumulate_grad_batches > 1:
        parts.append(f"agb{args.accumulate_grad_batches}")
    if args.max_steps:
        parts.append(f"{args.max_steps}steps")
    else:
        parts.append(f"{args.epochs}ep")
    if args.warmup_ratio != 0.1:
        parts.append(f"wmp{_fmt_num(args.warmup_ratio)}")
    if args.freeze_encoder:
        parts.append("frenc")
    if args.activation_checkpointing:
        parts.append("acckpt" if args.remat_policy == "full"
                     else f"acckpt-{args.remat_policy}")
    if args.min_duration or args.max_duration is not None:
        hi = "inf" if args.max_duration is None else _fmt_num(args.max_duration)
        parts.append(f"dur{_fmt_num(args.min_duration)}-{hi}s")
    if args.grad_clip != 1.0:
        parts.append(f"gc{_fmt_num(args.grad_clip)}")
    if args.precision != "bf16":
        parts.append(f"pr-{args.precision}")
    if args.seed != 0:
        parts.append(f"seed{args.seed}")
    if args.raw_text:
        parts.append("raw")
    if args.val_first_batches is not None:
        parts.append(f"vfb{args.val_first_batches}")
    if args.spec_augment:
        parts.append("specaug")
        if args.freq_masks != 2:
            parts.append(f"fm{args.freq_masks}")
        if args.freq_width != 27:
            parts.append(f"fw{args.freq_width}")
        if args.time_masks != 2:
            parts.append(f"tm{args.time_masks}")
        if args.time_width != 20:
            parts.append(f"tw{args.time_width}")
    return _sanitize_name("_".join(parts))


class TopKKeeper:
    """Keep the k best (lowest val_wer) checkpoints on disk.

    Lightning ModelCheckpoint semantics (reference ``train.py:157-163``):
    ``k == 0`` disables checkpointing, ``k < 0`` keeps every checkpoint.
    In a multi-process run every rank keeps the books and calls
    ``save_fn`` (a collective), and only the ``writer`` removes files."""

    def __init__(self, save_dir: str, k: int, writer: bool = True):
        self.save_dir = save_dir
        self.k = k
        self.writer = writer
        self.kept: List[Tuple[float, str]] = []

    def submit(self, wer: float, step: int, save_fn) -> Optional[str]:
        if self.k == 0:
            return None
        path = os.path.join(self.save_dir,
                            f"step{step:07d}-wer{wer:.4f}.ckpt")
        if (self.k < 0 or len(self.kept) < self.k
                or wer < max(w for w, _ in self.kept)):
            save_fn(path)
            self.kept.append((wer, path))
            self.kept.sort()
            while self.k > 0 and len(self.kept) > self.k:
                _, worst = self.kept.pop()
                if self.writer and os.path.exists(worst):
                    os.remove(worst)
            return path
        return None


def run_validation(ft, val_ds, batch_size: int,
                   first_batches: Optional[int] = None
                   ) -> Tuple[float, float]:
    """Full-val loss + WER (reference ``module.py:216-250``: WER counts
    aggregated over the whole set; under a mesh ``eval_step`` returns each
    batch's loss and hypotheses gathered over "data", so the counts are
    the whole set's on every rank).  ``first_batches``
    caps validation to the first N batches (reference
    ``--val_first_batches``)."""
    tot_loss, n_batches, n_rows = 0.0, 0, 0
    errors = words = 0
    for batch in val_ds.batches(batch_size, sort_by_duration=True):
        if first_batches is not None and n_batches >= first_batches:
            break
        loss, hyps = ft.eval_step(batch)
        e, w = ft.batch_wer(hyps, batch[2], batch[3])
        errors += e
        words += w
        # weight per-batch mean losses by row count: an unweighted mean
        # would give the ragged final batch's few samples outsized weight
        rows = len(batch[1])
        tot_loss += loss * rows
        n_rows += rows
        n_batches += 1
    return tot_loss / max(n_rows, 1), errors / max(words, 1)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.exp_name:
        name = (experiment_name(args) if args.exp_name == "auto"
                else _sanitize_name(args.exp_name))
        args.save_dir = os.path.join(args.save_dir, name)
        print(f"experiment: {name} -> {args.save_dir}")

    import gigaam_tpu_torch
    from gigaam_tpu_torch.data import AudioDataset, prefetch_batches
    from gigaam_tpu_torch.parallel.distributed import rank
    from gigaam_tpu_torch.train.finetune import FineTuner, TrainConfig
    from gigaam_tpu_torch.weights import (
        init_encoder_from_artifact,
        save_model,
    )

    device, mesh = parallel_setup(args)
    is_main = rank() == 0
    # fp32 master weights for training (bf16 is the compute dtype only)
    model = gigaam_tpu_torch.load_model(args.model_name, device=device,
                                        init=args.init, seed=args.seed)
    assert model.cfg.decoding is not None, "ASR model required"
    if args.init_encoder_from:
        init_encoder_from_artifact(model, args.init_encoder_from)
        print(f"initialized encoder from {args.init_encoder_from}")

    train_ds = AudioDataset(
        args.train_manifest, tokenizer=model.tokenizer,
        min_duration=args.min_duration, max_duration=args.max_duration,
        raw_text=args.raw_text, return_tokens=True)
    val_ds = AudioDataset(
        args.val_manifest, tokenizer=model.tokenizer,
        raw_text=args.raw_text, return_tokens=True)

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    total_opt_steps = (args.max_steps if args.max_steps > 0
                       else args.epochs * steps_per_epoch
                       ) // max(1, args.accumulate_grad_batches)

    tc = TrainConfig(
        lr=args.lr, weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        total_steps=max(1, total_opt_steps), grad_clip=args.grad_clip,
        freeze_encoder=args.freeze_encoder, spec_augment=args.spec_augment,
        freq_masks=args.freq_masks, freq_width=args.freq_width,
        time_masks=args.time_masks, time_width=args.time_width,
        precision=args.precision, rnnt_time_chunk=args.rnnt_time_chunk,
        activation_checkpointing=args.activation_checkpointing,
        remat_policy=args.remat_policy,
        accumulate_grad_batches=args.accumulate_grad_batches)

    ft = FineTuner(model, tc, seed=args.seed, mesh=mesh)
    if args.resume_from_checkpoint:
        ft.restore_checkpoint(args.resume_from_checkpoint)
        print(f"resumed from {args.resume_from_checkpoint} @ step {ft.step}")

    os.makedirs(args.save_dir, exist_ok=True)
    metrics_f = (open(os.path.join(args.save_dir, "metrics.jsonl"), "a")
                 if is_main else None)

    def log(rec):
        if not is_main:
            return
        rec["time"] = round(time.time(), 3)
        metrics_f.write(json.dumps(rec) + "\n")
        metrics_f.flush()

    keeper = TopKKeeper(args.save_dir, args.save_top_k, writer=is_main)

    def validate(step):
        vl, vw = run_validation(ft, val_ds,
                                args.eval_batch_size or args.batch_size,
                                args.val_first_batches)
        print(f"  [val] step={step} val/loss={vl:.4f} val/wer={vw:.4f}")
        log({"kind": "val", "step": step, "loss": vl, "wer": vw})
        keeper.submit(vw, step, ft.save_checkpoint)

    if args.initial_validation:
        validate(ft.step)

    max_steps = args.max_steps if args.max_steps > 0 else (
        args.epochs * steps_per_epoch)
    epoch = 0
    t_epoch = time.time()
    done = False
    while not done:
        steps_this_epoch = 0
        for batch in prefetch_batches(
                train_ds.batches(args.batch_size, shuffle=True,
                                 seed=args.seed + epoch,
                                 sort_by_duration=True, drop_last=True)):
            steps_this_epoch += 1
            m = ft.train_step(batch)
            if (args.log_every_n_steps
                    and ft.step % args.log_every_n_steps == 0):
                # metrics arrive as device scalars; sync only on log cadence
                m = {k: float(v) for k, v in m.items()}
                print(f"step {ft.step}/{max_steps} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f}")
                log({"kind": "train", "step": ft.step, **m})
            if (args.train_wer_every_n_steps
                    and ft.step % args.train_wer_every_n_steps == 0):
                _, hyps = ft.eval_step(batch)
                e, w = ft.batch_wer(hyps, batch[2], batch[3])
                twer = e / max(1, w)
                print(f"  [train/wer] step={ft.step} wer={twer:.4f}")
                log({"kind": "train_wer", "step": ft.step, "wer": twer})
            if (args.val_every_n_steps
                    and ft.step % args.val_every_n_steps == 0):
                validate(ft.step)
            if ft.step >= max_steps:
                done = True
                break
        else:
            if steps_this_epoch == 0:
                raise RuntimeError(
                    f"train set yields no batches at batch_size="
                    f"{args.batch_size} with drop_last "
                    f"({len(train_ds)} samples) — lower --batch_size")
            epoch += 1
            print(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
            t_epoch = time.time()
            if not args.val_every_n_steps:
                validate(ft.step)

    # final validation — unless this exact step was already validated above
    if not (args.val_every_n_steps and ft.step % args.val_every_n_steps == 0):
        validate(ft.step)
    ft.sync_model()
    save_model(model, os.path.join(args.save_dir, "final"))
    if is_main:
        print(f"saved final model to {args.save_dir}/final.npz")
        metrics_f.close()


if __name__ == "__main__":
    main()

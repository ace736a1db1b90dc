"""BEST-RQ self-supervised pretraining of the SSL encoders (port of
``gigaam_tpu/train/pretrain.py``).

The reference ships ``v{1,2,3}_ssl`` checkpoints but no pretraining code.
BEST-RQ (Chiu et al., 2022) needs no learned codebook and no negatives: a
frozen random projection and a frozen random codebook turn features into
discrete targets, and the encoder learns them by cross-entropy on masked
frames.

Objective, per batch:
  1. log-mel features [B, T, F] from the fp32 frontend;
  2. per-utterance, per-bin standardisation over the valid frames (the
     quantizer needs standardised inputs, or its codes collapse);
  3. ``2**num_subsampling_stages`` consecutive frames stacked to the
     encoder's frame rate, projected by the frozen matrix, L2-normalised,
     and the nearest codebook row by cosine (``argmax``: the first of
     equal maxima, as ``jnp.argmax``) is the target id;
  4. span masks on the subsampled grid (a span starts with ``mask_prob``
     and covers ``mask_span`` sub-frames: a rolling sum of the starts),
     upsampled to input frames, where the features are replaced by
     N(0, ``noise_std``^2) noise;
  5. the encoder on the masked features, a linear softmax head over the
     codebook, cross-entropy and accuracy at the masked valid frames.

The draws (quantizer, head init, mask starts, noise) come from
``torch.Generator``s and cannot match ``jax.random``; the constructor's
``quantizer``/``ssl_head`` arguments and the ``sample_starts``/
``sample_noise`` methods are where a caller (the tests) puts in other
draws.  The trainer is ``TrainerBase``'s: AdamW and its schedule, remat,
gradient accumulation, npz train checkpoints, the mesh (``mesh``: DP x TP
over a ("data", "model") ``DeviceMesh``; the starts and the noise are drawn
for the global batch and cut to each rank's rows, and the loss's count of
masked positions, which differs between ranks, is the batch's).  The
quantizer is no parameter at all, so no optimizer ever sees it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.encoder import as_module, conformer_forward
from ..ops.conformer_ops import static_subsampled_length, subsampled_length
from ..ops.precision import full_fp32
from ..parallel.collectives import global_count
from .finetune import TrainConfig, TrainerBase


@dataclasses.dataclass
class PretrainConfig(TrainConfig):
    # masking: BEST-RQ masks ~400 ms spans, 10 frames of the 40 ms grid; a
    # start probability of 0.04 covers ~1 - 0.96^10 ~ 33% of the frames
    mask_prob: float = 0.04
    mask_span: int = 10
    noise_std: float = 0.1
    # the random-projection quantizer
    codebook_size: int = 8192
    codebook_dim: int = 16
    quantizer_seed: int = 0


def _array(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


class SSLPretrainer(TrainerBase):
    """BEST-RQ pretraining around a ``GigaAM`` (SSL) model.  Batches are
    (wavs, wav_lens).  ``quantizer`` ({"proj", "codebook"}) and ``ssl_head``
    ({"w", "b"}) replace the draws of ``quantizer_seed``; ``mesh`` is
    ``TrainerBase``'s."""

    def __init__(self, model, pc: PretrainConfig, seed: int = 0,
                 quantizer: Optional[Dict[str, Any]] = None,
                 ssl_head: Optional[Dict[str, Any]] = None, mesh=None):
        self.pc = pc
        enc = model.cfg.encoder
        self.stack = 2 ** enc.num_subsampling_stages
        f_stack = enc.feat_in * self.stack
        gen = torch.Generator().manual_seed(pc.quantizer_seed)
        # Xavier-uniform projection (paper section 2.1), unit-norm codebook
        limit = math.sqrt(6.0 / (f_stack + pc.codebook_dim))
        proj = (torch.rand((f_stack, pc.codebook_dim), generator=gen) * 2
                - 1) * limit
        codebook = torch.randn((pc.codebook_size, pc.codebook_dim),
                               generator=gen)
        codebook = codebook / codebook.norm(dim=-1, keepdim=True)
        head = {"w": torch.randn((enc.d_model, pc.codebook_size),
                                 generator=gen) * 0.02,
                "b": torch.zeros(pc.codebook_size)}
        dev = model.device
        q = quantizer or {"proj": proj, "codebook": codebook}
        self.quantizer = {k: _array(q[k], dev) for k in ("proj", "codebook")}
        h = ssl_head or head
        self.ssl_head = as_module({k: _array(h[k], dev).clone()
                                   for k in ("w", "b")})
        super().__init__(model, pc, seed, mesh)

    # hooks ------------------------------------------------------------

    def _named_parameters(self) -> List[Tuple[str, torch.nn.Parameter]]:
        return (list(self.model.named_parameters())
                + [(f"ssl_head.{k}", p)
                   for k, p in self.ssl_head.named_parameters()])

    def _extra_arrays(self) -> Dict[str, np.ndarray]:
        out = {f"ssl_head/{k}": p.detach().cpu().numpy()
               for k, p in self.ssl_head.named_parameters()}
        out.update({f"quantizer/{k}": v.cpu().numpy()
                    for k, v in self.quantizer.items()})
        return out

    def _restore_extra(self, tree: Dict[str, Any]) -> None:
        with torch.no_grad():
            for k, p in self.ssl_head.named_parameters():
                p.copy_(torch.from_numpy(np.asarray(tree["ssl_head"][k])))
        self.quantizer = {k: _array(tree["quantizer"][k], self.device)
                          for k in self.quantizer}

    # draws ------------------------------------------------------------

    def sample_starts(self, b: int, t_sub: int,
                      gen: torch.Generator) -> torch.Tensor:
        """Span starts [B, t_sub] bool: Bernoulli(``mask_prob``)."""
        return torch.rand((b, t_sub), generator=gen,
                          device=self.device) < self.pc.mask_prob

    def sample_noise(self, shape: Tuple[int, ...],
                     gen: torch.Generator) -> torch.Tensor:
        """The substitute features: N(0, ``noise_std``^2), fp32."""
        return self.pc.noise_std * torch.randn(shape, generator=gen,
                                               device=self.device)

    # objective --------------------------------------------------------

    def _code_similarities(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                           t_sub: int) -> torch.Tensor:
        """Cosine similarities [B, n_codes, codebook_size] of the stacked,
        standardised, projected frames to the codebook (fp32, TF32 off)."""
        b, t_feat, f = feats.shape
        valid = (torch.arange(t_feat, device=feats.device)[None, :]
                 < feat_lens[:, None])
        vf = valid[:, :, None].float()
        n = vf.sum(dim=1, keepdim=True).clamp(min=1.0)
        mean = (feats * vf).sum(dim=1, keepdim=True) / n
        var = ((feats - mean) ** 2 * vf).sum(dim=1, keepdim=True) / n
        normed = torch.where(valid[:, :, None],
                             (feats - mean) * torch.rsqrt(var + 1e-5), 0.0)
        t_use = min(t_feat - t_feat % self.stack, t_sub * self.stack)
        stacked = normed[:, :t_use].reshape(b, t_use // self.stack,
                                            self.stack * f)
        with full_fp32():
            z = stacked @ self.quantizer["proj"]
            z = z * torch.rsqrt((z * z).sum(dim=-1, keepdim=True) + 1e-12)
            return z @ self.quantizer["codebook"].T

    def _targets(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                 t_sub: int) -> Tuple[torch.Tensor, int]:
        """Code ids [B, t_sub] (int64) of the unmasked features, and how many
        leading frames carry a real code (conv padding can make t_sub exceed
        the stacked frames; the rest are zero and never scored)."""
        ids = self._code_similarities(feats, feat_lens, t_sub).argmax(dim=-1)
        n_codes = ids.shape[1]
        if t_sub > n_codes:
            ids = F.pad(ids, (0, t_sub - n_codes))
        return ids[:, :t_sub], min(n_codes, t_sub)

    def _sample_mask(self, b: int, t_sub: int, sub_lens: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
        """Span mask [B, t_sub] bool: frame i is masked when a span starts
        in (i - mask_span, i], and only on valid frames."""
        starts = self._rows_of(lambda n: self.sample_starts(n, t_sub, gen), b)
        cs = torch.cumsum(starts.int(), dim=1)
        shifted = F.pad(cs, (self.pc.mask_span, 0))[:, :t_sub]
        valid = (torch.arange(t_sub, device=cs.device)[None, :]
                 < sub_lens[:, None])
        return ((cs - shifted) > 0) & valid

    def _forward_loss(self, batch, train: bool,
                      gen: Optional[torch.Generator] = None):
        wavs, wav_lens = batch
        pc, enc = self.pc, self.enc_cfg
        gen = self.gen if gen is None else gen
        compute_dtype = (torch.bfloat16 if pc.precision == "bf16"
                         else torch.float32)
        feats, feat_lens = self.model.frontend(wavs, wav_lens)   # [B, F, T]
        feats = feats.transpose(1, 2).float()                   # [B, T, F]
        b, t_feat, _ = feats.shape
        t_sub = static_subsampled_length(t_feat, enc.num_subsampling_stages,
                                         enc.subs_kernel_size)
        sub_lens = subsampled_length(feat_lens, enc.num_subsampling_stages,
                                     enc.subs_kernel_size)
        with torch.no_grad():
            targets, n_codes = self._targets(feats, feat_lens, t_sub)
        mask_sub = self._sample_mask(b, t_sub, sub_lens, gen)
        mask_feat = mask_sub.repeat_interleave(self.stack, dim=1)[:, :t_feat]
        if mask_feat.shape[1] < t_feat:
            mask_feat = F.pad(mask_feat, (0, t_feat - mask_feat.shape[1]))
        # masked in eval too: the objective means nothing on clean features
        # (eval draws from a fixed generator)
        noise = self._rows_of(
            lambda n: self.sample_noise((n, *feats.shape[1:]), gen), b)
        feats_in = torch.where(mask_feat[:, :, None], noise, feats)
        encoded, enc_lens, bn_stats = conformer_forward(
            self.model.encoder, feats_in, feat_lens, enc,
            self._pos(wavs.shape[1]), compute_dtype, train=train,
            bn_train=train and not pc.freeze_encoder,
            bn_group=self._data_group)
        enc_lens = self._without_padding(enc_lens)
        with full_fp32():
            logits = encoded.float() @ self.ssl_head["w"] + self.ssl_head["b"]
        ce = -torch.log_softmax(logits, dim=-1).gather(
            -1, targets[:, :, None])[:, :, 0]
        active = mask_sub & (torch.arange(t_sub, device=ce.device)[None, :]
                             < torch.clamp(enc_lens, max=n_codes)[:, None])
        denom = global_count(active.sum(), self._data_group).clamp(min=1)
        loss = torch.where(active, ce, 0.0).sum() / denom
        acc = ((logits.argmax(dim=-1) == targets) & active).sum() / denom
        return loss, (bn_stats, acc, enc_lens)

    def eval_step(self, batch) -> Tuple[float, float]:
        """(masked-prediction loss, masked accuracy), through the inference
        forward, with the same mask and noise each call (a generator seeded
        0), so that validation numbers compare across steps.  Under a mesh, the whole batch's."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        with torch.inference_mode():
            loss, (_, acc, _) = self._forward_loss(
                self._local_batch(batch, pad=True), train=False, gen=gen)
            return (float(self._sum_over_data(loss)),
                    float(self._sum_over_data(acc)))


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def parse_args(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="GigaAM BEST-RQ SSL pretraining (PyTorch/CUDA)")
    p.add_argument("--model_name", default="ssl",
                   help="SSL preset or artifact to (continue) pretraining; "
                        "'ssl' with --init random starts from scratch")
    p.add_argument("--init", default="random", choices=["random", "weights"],
                   help="random: from scratch; weights: continue from the "
                        "named artifact")
    p.add_argument("--device", default=None,
                   help="torch device; default: the card (raises without "
                        "one)")
    p.add_argument("--train_manifest", required=True,
                   help="TSV manifest; the transcription column may be empty")
    p.add_argument("--val_manifest", required=True)
    p.add_argument("--min_duration", type=float, default=0.0)
    p.add_argument("--max_duration", type=float, default=None)
    # optimization
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_ratio", type=float, default=0.08)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--activation_checkpointing", action="store_true")
    p.add_argument("--remat_policy", choices=["full", "dots"],
                   default="full")
    # BEST-RQ
    p.add_argument("--mask_prob", type=float, default=0.04)
    p.add_argument("--mask_span", type=int, default=10)
    p.add_argument("--noise_std", type=float, default=0.1)
    p.add_argument("--codebook_size", type=int, default=8192)
    p.add_argument("--codebook_dim", type=int, default=16)
    p.add_argument("--quantizer_seed", type=int, default=0)
    # loop control
    p.add_argument("--val_every_n_steps", type=int, default=0)
    p.add_argument("--log_every_n_steps", type=int, default=10)
    p.add_argument("--save_dir", default="exp/pretrain")
    p.add_argument("--save_top_k", type=int, default=1)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0)
    # parallelism (``train.py``'s flags and launch)
    from .train import add_parallel_args

    add_parallel_args(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    import json
    import os
    import time

    import gigaam_tpu_torch
    from gigaam_tpu_torch.data import AudioDataset, prefetch_batches
    from gigaam_tpu_torch.parallel.distributed import rank
    from gigaam_tpu_torch.train.train import TopKKeeper, parallel_setup
    from gigaam_tpu_torch.weights import save_model

    args = parse_args(argv)
    device, mesh = parallel_setup(args)
    is_main = rank() == 0
    # fp32 master weights (bf16 is the compute dtype only)
    model = gigaam_tpu_torch.load_model(args.model_name, device=device,
                                        init=args.init, seed=args.seed)
    train_ds = AudioDataset(args.train_manifest,
                            min_duration=args.min_duration,
                            max_duration=args.max_duration)
    val_ds = AudioDataset(args.val_manifest)

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    max_steps = (args.max_steps if args.max_steps > 0
                 else args.epochs * steps_per_epoch)
    pc = PretrainConfig(
        lr=args.lr, weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        total_steps=max(1, max_steps // max(1, args.accumulate_grad_batches)),
        grad_clip=args.grad_clip, precision=args.precision,
        activation_checkpointing=args.activation_checkpointing,
        remat_policy=args.remat_policy,
        accumulate_grad_batches=args.accumulate_grad_batches,
        mask_prob=args.mask_prob, mask_span=args.mask_span,
        noise_std=args.noise_std, codebook_size=args.codebook_size,
        codebook_dim=args.codebook_dim, quantizer_seed=args.quantizer_seed)

    pt = SSLPretrainer(model, pc, seed=args.seed, mesh=mesh)
    if args.resume_from_checkpoint:
        pt.restore_checkpoint(args.resume_from_checkpoint)
        print(f"resumed from {args.resume_from_checkpoint} @ step {pt.step}")

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
        tot_loss = tot_acc = rows = 0.0
        for batch in val_ds.batches(args.batch_size, sort_by_duration=True):
            loss, acc = pt.eval_step(batch)
            r = len(batch[1])
            tot_loss += loss * r
            tot_acc += acc * r
            rows += r
        vl, va = tot_loss / max(rows, 1), tot_acc / max(rows, 1)
        print(f"  [val] step={step} val/loss={vl:.4f} val/mask_acc={va:.4f}")
        log({"kind": "val", "step": step, "loss": vl, "mask_acc": va})
        # top-k keeps the lowest values: the masked loss is the criterion
        keeper.submit(vl, step, pt.save_checkpoint)

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
            m = pt.train_step(batch)
            if (args.log_every_n_steps
                    and pt.step % args.log_every_n_steps == 0):
                m = {k: float(v) for k, v in m.items()}
                print(f"step {pt.step}/{max_steps} loss={m['loss']:.4f} "
                      f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.2f}")
                log({"kind": "train", "step": pt.step, **m})
            if (args.val_every_n_steps
                    and pt.step % args.val_every_n_steps == 0):
                validate(pt.step)
            if pt.step >= max_steps:
                done = True
                break
        else:
            if steps_this_epoch == 0:
                raise RuntimeError(
                    f"train set yields no batches at batch_size="
                    f"{args.batch_size} with drop_last "
                    f"({len(train_ds)} samples): lower --batch_size")
            epoch += 1
            print(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s")
            t_epoch = time.time()
            if not args.val_every_n_steps:
                validate(pt.step)

    if not (args.val_every_n_steps and pt.step % args.val_every_n_steps == 0):
        validate(pt.step)
    pt.sync_model()
    save_model(model, os.path.join(args.save_dir, "final"))
    if is_main:
        print(f"saved the pretrained encoder to {args.save_dir}/final.npz")
        metrics_f.close()


if __name__ == "__main__":
    main()

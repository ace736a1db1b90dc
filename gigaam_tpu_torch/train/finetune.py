"""CTC fine-tuning: train state and train step (port of
``gigaam_tpu/train/finetune.py``, itself a re-architecture of the reference
Lightning module, ``train_utils/module.py:16-271``).

* one eager ``train_step`` on the model's device: forward in the compute
  dtype (bf16 on the card) over fp32 master weights, ``loss.backward()``
  through the attention kernels' own backward kernels, one AdamW update;
* AdamW + linear-warmup/cosine schedule per optimizer step
  (``module.py:252-271``), with the JAX package's (optax) semantics where
  PyTorch's helpers differ: the clip scales by ``clip / max(norm, clip)``
  over the trainable leaves only, the N-th update applies ``schedule(N-1)``
  (so the first update has lr 0), the decay reaches every trainable leaf;
* SpecAugment on features (``module.py:48-55,123-127``);
* BatchNorm running stats are buffers by convention: never given to AdamW,
  overwritten from the forward pass's batch statistics each (micro-)step;
* the frontend is parameter-free and always fp32;
* encoder freeze (``module.py:76-78``) leaves the encoder out of AdamW and
  runs BatchNorm in eval mode; its gradients are still computed and still
  count in the reported ``grad_norm``, as in the JAX package.

Not ported here: the RNNT objective, and training across devices (the JAX
package's ``mesh`` argument).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import CTCHeadConfig, ModelConfig
from ..decode.ctc_greedy import ctc_extract, ctc_greedy_mask
from ..metrics import wer_counts
from ..models import heads as heads_lib
from ..models.encoder import conformer_forward
from ..ops.ctc_loss import ctc_loss
from ..ops.spec_augment import spec_augment
from ..weights import (
    _flatten,
    _unflatten,
    load_state_into,
    migrate_params,
    params_from_jax,
    params_to_jax,
)


@dataclasses.dataclass
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1
    total_steps: int = 1000
    grad_clip: float = 1.0
    freeze_encoder: bool = False
    spec_augment: bool = False
    freq_masks: int = 2
    freq_width: int = 27
    time_masks: int = 2
    time_width: int = 20
    precision: str = "bf16"          # "bf16" | "fp32"
    rnnt_time_chunk: int = 64
    activation_checkpointing: bool = False
    # "full" (reference semantics: recompute whole layers); "dots" (save
    # matmul outputs) is not ported and raises in the encoder
    remat_policy: str = "full"
    accumulate_grad_batches: int = 1


def host_lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """The warmup-cosine schedule as a pure-Python function of the update
    count: linear from 0 to ``lr`` over ``max(1, warmup_ratio * total)``
    updates, then a cosine to 0 at ``max(total, warmup + 1)``."""
    warmup = max(1, int(tc.warmup_ratio * tc.total_steps))
    decay = max(tc.total_steps, warmup + 1)

    def lr(step: int) -> float:
        if step < warmup:
            return tc.lr * step / warmup
        t = min(step - warmup, decay - warmup) / (decay - warmup)
        return tc.lr * 0.5 * (1.0 + math.cos(math.pi * t))

    return lr


def make_optimizer(tc: TrainConfig, params: List[torch.nn.Parameter]
                   ) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """AdamW over ``params`` (decoupled decay on every one of them, eps 1e-8
    outside the root, as ``optax.adamw``) and the schedule; the trainer sets
    the learning rate before each update."""
    opt = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tc.weight_decay)
    return opt, host_lr_schedule(tc)


def is_bn_buffer(name: str) -> bool:
    parts = name.split(".")
    return "batch_norm" in parts and parts[-1] in ("mean", "var")


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, on the device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class TrainerBase:
    """Shared training machinery: optimizer build, the train step, npz
    checkpointing.  Subclasses define the objective (``_forward_loss``)."""

    def __init__(self, model, tc: TrainConfig, seed: int = 0):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.tc = tc
        self.device = model.device
        self.enc_cfg = dataclasses.replace(
            self.cfg.encoder,
            activation_checkpointing=tc.activation_checkpointing,
            remat_policy=tc.remat_policy)

        named = list(model.named_parameters())
        not_fp32 = [n for n, p in named if n.startswith("encoder.")
                    and p.dtype != torch.float32]
        if not_fp32:
            raise ValueError(
                "training needs fp32 master weights, but the encoder was "
                f"cast ({not_fp32[0]} is "
                f"{dict(named)[not_fp32[0]].dtype}): load the model again "
                "without cast_encoder")
        # every leaf records a gradient (the reported grad_norm is over all
        # of them); AdamW owns the trainable ones only
        self._named = named
        for _, p in named:
            p.requires_grad_(True)
        self._train_names = [n for n, _ in named if self._trainable(n)]
        lookup = dict(named)
        self._train_params = [lookup[n] for n in self._train_names]
        self.optimizer, self._host_lr = make_optimizer(tc, self._train_params)
        self._acc: Optional[List[torch.Tensor]] = None
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        #: called with "start", "forward", "backward", "optimizer" as a
        #: train step passes each phase's end (a profiler's event marks)
        self.on_phase: Optional[Callable[[str], None]] = None

    # hooks ------------------------------------------------------------

    def _trainable(self, name: str) -> bool:
        if is_bn_buffer(name):
            return False
        return not (self.tc.freeze_encoder and name.startswith("encoder."))

    def _forward_loss(self, batch, train: bool):
        raise NotImplementedError

    # ------------------------------------------------------------------

    def _mark(self, phase: str) -> None:
        if self.on_phase is not None:
            self.on_phase(phase)

    def _to_device(self, batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(x).to(self.device) for x in batch)

    def _pos(self, padded_samples: int):
        return self.model._pos_for(padded_samples)

    def _write_bn_stats(self, bn_stats: Dict[str, torch.Tensor]) -> None:
        for i, layer in enumerate(self.model.encoder.layers):
            bn = layer["conv"]["batch_norm"]
            bn["mean"].copy_(bn_stats["mean"][i])
            bn["var"].copy_(bn_stats["var"][i])

    def _update(self) -> None:
        """One micro-batch's gradients into the optimizer: averaged over
        ``accumulate_grad_batches`` micro-batches, then clipped over the
        trainable leaves, then one AdamW update at ``schedule(N - 1)``."""
        k = max(1, self.tc.accumulate_grad_batches)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._train_params]
        if k > 1:
            mini = self.step % k
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # running mean of the micro-batch gradients
            torch._foreach_add_(self._acc, torch._foreach_sub(grads, self._acc),
                                alpha=1.0 / (mini + 1))
            if mini != k - 1:
                return
            grads, self._acc = self._acc, None
        scale = self.tc.grad_clip / torch.clamp(global_norm(grads),
                                                min=self.tc.grad_clip)
        torch._foreach_mul_(grads, scale)
        for p, g in zip(self._train_params, grads):
            p.grad = g
        lr = self._host_lr(self.step // k)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def train_step(self, batch) -> Dict[str, Any]:
        """One (micro-)step.  ``loss`` and ``grad_norm`` come back as device
        scalars: nothing here waits for the device, so a caller pays one
        host sync per logged step, not per step.  SpecAugment draws from the
        trainer's own generator (``seed``).  ``lr`` is the rate the last
        update applied."""
        batch = self._to_device(batch)
        for _, p in self._named:
            p.grad = None
        self._mark("start")
        loss, (bn_stats, _, _) = self._forward_loss(batch, train=True)
        self._mark("forward")
        loss.backward()
        self._mark("backward")
        with torch.no_grad():
            if bn_stats is not None:
                self._write_bn_stats(bn_stats)
            grad_norm = global_norm(
                [p.grad for _, p in self._named if p.grad is not None])
            self._update()
        self._mark("optimizer")
        self.step += 1
        opt_steps = self.step // max(1, self.tc.accumulate_grad_batches)
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "lr": self._host_lr(max(0, opt_steps - 1))}

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    _CKPT_FORMAT = "gigaam_tpu_torch_train_ckpt_v1"

    def save_checkpoint(self, path: str) -> None:
        """Write one self-describing npz file: the parameters in the JAX
        package's layout, AdamW's moments by parameter name, pending
        accumulated gradients, the SpecAugment generator's state, and a
        JSON metadata entry.  No pickle anywhere."""
        arrays = {f"params/{k}": v
                  for k, v in _flatten(params_to_jax(self.model)).items()}
        opt_step = 0.0
        for i, (name, p) in enumerate(zip(self._train_names,
                                          self._train_params)):
            state = self.optimizer.state.get(p)
            if state:
                opt_step = float(state["step"])
                arrays[f"opt/{name}/exp_avg"] = state["exp_avg"].cpu().numpy()
                arrays[f"opt/{name}/exp_avg_sq"] = (
                    state["exp_avg_sq"].cpu().numpy())
            if self._acc is not None:
                arrays[f"acc/{name}"] = self._acc[i].cpu().numpy()
        arrays["gen_state"] = self.gen.get_state().cpu().numpy()
        meta = {
            "format": self._CKPT_FORMAT,
            "step": self.step,
            "opt_step": opt_step,
            "model_config": self.cfg.to_dict(),
            "train_config": dataclasses.asdict(self.tc),
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # file handle: savez must not append .npz
            np.savez(f, __meta__=np.asarray(json.dumps(meta)), **arrays)
        os.replace(tmp, path)

    def restore_checkpoint(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("format") != self._CKPT_FORMAT:
                raise ValueError(
                    f"{path}: unknown train-checkpoint format "
                    f"{meta.get('format')!r} (expected {self._CKPT_FORMAT})")
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        if meta["train_config"] != dataclasses.asdict(self.tc):
            diff = {k: (meta["train_config"].get(k), v) for k, v in
                    dataclasses.asdict(self.tc).items()
                    if meta["train_config"].get(k) != v}
            warnings.warn(f"restoring {path} under a different TrainConfig "
                          f"(ckpt vs current): {diff}")
        state = params_from_jax(migrate_params(_unflatten(
            {k[len("params/"):]: v for k, v in arrays.items()
             if k.startswith("params/")})))
        enc = self.model.encoder
        load_state_into(enc.pre_encode, state["encoder"]["pre_encode"])
        if len(state["encoder"]["layers"]) != len(enc.layers):
            raise ValueError(f"{path}: layer count does not match the model")
        for layer, tree in zip(enc.layers, state["encoder"]["layers"]):
            load_state_into(layer, tree)
        load_state_into(self.model.head, state["head"])

        def like(p: torch.Tensor, a: np.ndarray) -> torch.Tensor:
            # the parameter's own strides, as AdamW allocates its moments
            return torch.zeros_like(p).copy_(torch.from_numpy(a))

        has_acc = any(k.startswith("acc/") for k in arrays)
        acc = []
        for name, p in zip(self._train_names, self._train_params):
            key = f"opt/{name}/exp_avg"
            if key in arrays:
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(meta["opt_step"]),
                                         dtype=torch.float32),
                    "exp_avg": like(p, arrays[key]),
                    "exp_avg_sq": like(p, arrays[f"opt/{name}/exp_avg_sq"]),
                }
            elif meta["opt_step"]:
                raise ValueError(
                    f"{path}: no optimizer state for {name}: TrainConfig "
                    "(freeze_encoder) mismatch")
            if has_acc:
                acc.append(like(p, arrays[f"acc/{name}"]))
        self._acc = acc if has_acc else None
        self.gen.set_state(torch.from_numpy(arrays["gen_state"]))
        self.step = int(meta["step"])

    def sync_model(self) -> None:
        """Kept for the JAX trainer's interface: the port updates the
        wrapped model's parameters in place, so there is nothing to copy."""


class FineTuner(TrainerBase):
    """CTC fine-tuning loop around a ``GigaAMASR`` model (reference
    ``train_utils/module.py:16-271``).  The model's device is the trainer's;
    build the model with ``device="cpu"`` to train on the CPU."""

    def __init__(self, model, tc: TrainConfig, seed: int = 0):
        if not isinstance(model.cfg.head, CTCHeadConfig):
            raise NotImplementedError(
                "only the CTC objective is ported; the RNNT loss is not")
        self.blank_id = model.cfg.head.num_classes - 1
        self.mode = "ctc"
        super().__init__(model, tc, seed)

    # ------------------------------------------------------------------
    # forward / loss
    # ------------------------------------------------------------------

    def _forward_loss(self, batch, train: bool):
        wavs, wav_lens, tokens, tok_lens = batch
        compute_dtype = (torch.bfloat16 if self.tc.precision == "bf16"
                         else torch.float32)
        feats, feat_lens = self.model.frontend(wavs, wav_lens)   # [B, F, T]
        if train and self.tc.spec_augment:
            feats = spec_augment(self.gen, feats, self.tc.freq_masks,
                                 self.tc.freq_width, self.tc.time_masks,
                                 self.tc.time_width)
        # a frozen encoder still passes gradients (they count in grad_norm),
        # so it keeps the differentiable attention path; only its BatchNorm
        # switches to the running stats
        encoded, enc_lens, bn_stats = conformer_forward(
            self.model.encoder, feats.transpose(1, 2), feat_lens,
            self.enc_cfg, self._pos(wavs.shape[1]), compute_dtype,
            train=train, bn_train=train and not self.tc.freeze_encoder)
        logits = heads_lib.ctc_logits(self.model.head, encoded)
        loss = ctc_loss(logits, enc_lens, tokens, tok_lens, self.blank_id)
        return loss, (bn_stats, encoded, enc_lens)

    # ------------------------------------------------------------------
    # eval / decode
    # ------------------------------------------------------------------

    def eval_step(self, batch) -> Tuple[float, List[str]]:
        """(loss, hypotheses) of a batch, through the inference forward."""
        with torch.inference_mode():
            loss, (_, encoded, enc_lens) = self._forward_loss(
                self._to_device(batch), train=False)
            hyps = self.decode(encoded, enc_lens)
        return float(loss), hyps

    def decode(self, encoded: torch.Tensor, enc_lens: torch.Tensor
               ) -> List[str]:
        with torch.inference_mode():
            log_probs = heads_lib.ctc_log_probs(self.model.head, encoded)
            labels, keep = ctc_greedy_mask(log_probs, enc_lens)
        decoded = ctc_extract(labels.cpu().numpy(), keep.cpu().numpy())
        tok = self.model.tokenizer
        return [tok.decode(ids) for ids, _ in decoded]

    def batch_wer(self, hyps: List[str], tokens, tok_lens) -> Tuple[int, int]:
        tok = self.model.tokenizer
        refs = [
            tok.decode(np.asarray(tokens[i, : int(tok_lens[i])]).tolist())
            for i in range(len(hyps))
        ]
        return wer_counts(hyps, refs)

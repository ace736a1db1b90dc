"""CTC and RNNT fine-tuning: train state and train step (port of
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

* the RNNT objective runs on fp32 encodings through the chunked joint and
  the wavefront loss (``ops/rnnt_loss.py``), as the JAX package's does;
* activation checkpointing recomputes each encoder layer in the backward,
  whole (``remat_policy="full"``) or but for its 2-D products' outputs
  (``"dots"``, ``models/encoder.py::save_dots``).

Across devices (``mesh``, a ("data", "model") ``DeviceMesh`` of
``parallel/mesh.py``, one process per device; the JAX package's ``mesh``
argument, ``finetune.py:136-200``):

* every rank is given the same global batch and runs its contiguous block
  of rows; random draws (SpecAugment, BEST-RQ's starts and noise) are made
  for the global batch from the trainer's generator, which every rank
  seeds alike, and sliced, so a rank draws what one process draws;
* the encoder is sharded over "model" (``parallel.mesh.shard_model``), the
  AdamW moments live on the shards;
* one convention on "data": a rank's loss is its part of the global
  numerator over the global count (``parallel.collectives.global_count``), the
  gradients are summed over "data" (then the sync-BN backward, whose sum
  runs over "data" too, agrees), the reported loss is that sum;
* the global-norm clip counts a sharded leaf's squares summed over "model"
  and a replicated leaf once;
* eval runs under the mesh and returns the whole batch's loss and
  hypotheses; checkpoints gather the shards and rank 0 alone writes them;
  a restore re-shards.
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
import torch.distributed as tdist

from ..config import CTCHeadConfig, ModelConfig
from ..decode.ctc_greedy import ctc_extract, ctc_greedy_mask
from ..decode.rnnt_greedy import rnnt_extract
from ..metrics import wer_counts
from ..models import heads as heads_lib
from ..models.encoder import conformer_forward
from ..ops.ctc_loss import ctc_loss
from ..ops.rnnt_loss import rnnt_loss
from ..ops.spec_augment import spec_augment_from_draws
from ..parallel.collectives import all_gather_rows, all_reduce_
from ..parallel.mesh import (
    axis_group,
    axis_rank,
    axis_size,
    data_rows,
    gather_params,
    model_specs,
    shard_model,
    shard_params,
)
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
    # "full" (reference semantics: recompute whole layers) or "dots" (save
    # the 2-D products' outputs; a faster backward for more memory)
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


def _sum_squares(tensors: List[torch.Tensor], like: torch.Tensor
                 ) -> torch.Tensor:
    if not tensors:
        return torch.zeros((), dtype=torch.float32, device=like.device)
    return torch.stack(torch._foreach_norm(tensors)).float().square().sum()


def _split_axis(full: Tuple[int, ...], local: Tuple[int, ...]
                ) -> Optional[int]:
    """The axis along which a leaf of shape ``full`` was sharded into
    ``local``, or None for a replicated leaf."""
    diff = [i for i, (a, b) in enumerate(zip(full, local)) if a != b]
    return diff[0] if diff else None


class TrainerBase:
    """Shared training machinery: optimizer build, the train step, npz
    checkpointing, the mesh.  Subclasses define the objective
    (``_forward_loss``)."""

    def __init__(self, model, tc: TrainConfig, seed: int = 0, mesh=None):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.tc = tc
        self.device = model.device
        self.mesh = mesh
        self._data_group = axis_group(mesh, "data")
        self._model_group = (axis_group(mesh, "model")
                             if axis_size(mesh, "model") > 1 else None)
        # (global row count, this rank's rows, the rows before eval's
        # padding) of the batch in flight, under a mesh
        self._batch: Optional[Tuple[int, slice, int]] = None
        full_shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        if mesh is not None:
            shard_model(model, mesh)
        self.enc_cfg = dataclasses.replace(
            self.cfg.encoder,
            activation_checkpointing=tc.activation_checkpointing,
            remat_policy=tc.remat_policy)

        named = self._named_parameters()
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
        # the leaves shard_model split, by name, with their axis
        self._shard_axis = {
            n: ax for n, p in named if n in full_shapes and (ax := _split_axis(
                full_shapes[n], tuple(p.shape))) is not None}
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

    def _named_parameters(self) -> List[Tuple[str, torch.nn.Parameter]]:
        """Every leaf that records a gradient, by name; a subclass with
        leaves of its own (an extra head) adds them."""
        return list(self.model.named_parameters())

    def _extra_arrays(self) -> Dict[str, np.ndarray]:
        """Arrays beyond the model's parameters that a train checkpoint
        keeps (a subclass's own leaves), by ``/``-joined name."""
        return {}

    def _restore_extra(self, tree: Dict[str, Any]) -> None:
        """Read back what ``_extra_arrays`` saved (the unflattened tree of
        every ``params/`` array)."""

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

    def _local_batch(self, batch, pad: bool = False
                     ) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of a global batch, on the device; without a
        mesh the whole batch.  ``pad`` (evaluation) first pads the rows to
        a multiple of the data size with zero-length rows, which every
        objective leaves out of its mean (``_without_padding``); a train
        batch must divide."""
        if self.mesh is None:
            return self._to_device(batch)
        n = len(batch[0])
        extra = (-n) % axis_size(self.mesh, "data") if pad else 0
        if extra:
            batch = tuple(np.concatenate([np.asarray(x), np.zeros(
                (extra, *np.shape(x)[1:]), np.asarray(x).dtype)])
                for x in batch)
        self._batch = (n + extra, data_rows(self.mesh, n + extra), n)
        return self._to_device(tuple(x[self._batch[1]] for x in batch))

    def _rows_of(self, draw: Callable[[int], torch.Tensor], b: int,
                 axis: int = 0) -> torch.Tensor:
        """``draw(n)``, a draw whose ``axis`` runs over the rows of a batch,
        made for the global batch and cut to this rank's rows: every rank
        draws what one process draws.  ``b`` is the rows this rank holds."""
        if self._batch is None:
            return draw(b)
        n, rows, real = self._batch
        drawn = draw(real)
        if n > real:               # eval's padding rows: never counted
            shape = list(drawn.shape)
            shape[axis] = n - real
            drawn = torch.cat([drawn, drawn.new_zeros(shape)], axis)
        return drawn.narrow(axis, rows.start, rows.stop - rows.start)

    def _without_padding(self, lens: torch.Tensor) -> torch.Tensor:
        """Encoder lengths with eval's padding rows at 0, so that every
        objective leaves them out of its mean (a zero-length row may still
        get a frame from a centred frontend)."""
        if self._batch is None or self._batch[0] == self._batch[2]:
            return lens
        _, rows, real = self._batch
        idx = torch.arange(rows.start, rows.stop, device=lens.device)
        return torch.where(idx < real, lens, torch.zeros_like(lens))

    def _sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        """A reported number (a loss, an accuracy) summed over "data"."""
        return all_reduce_(t.detach().clone(), self._data_group)

    def _norm(self, names: List[str], tensors: List[torch.Tensor]
              ) -> torch.Tensor:
        """The global norm of leaves of which some may be "model" shards:
        their squares are summed over "model", a replicated leaf's counted
        once."""
        if self._model_group is None:
            return global_norm(tensors)
        sharded = [t for n, t in zip(names, tensors) if n in self._shard_axis]
        whole = [t for n, t in zip(names, tensors)
                 if n not in self._shard_axis]
        sq = all_reduce_(_sum_squares(sharded, tensors[0]), self._model_group)
        return torch.sqrt(_sum_squares(whole, tensors[0]) + sq)

    def _sum_grads_over_data(self) -> None:
        """Sum every leaf's gradient over "data", in one flat buffer."""
        grads = [p.grad for _, p in self._named if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        all_reduce_(flat, self._data_group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

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
        scale = self.tc.grad_clip / torch.clamp(
            self._norm(self._train_names, grads), min=self.tc.grad_clip)
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
        update applied.  Under a mesh every rank passes the same global
        batch and gets the global loss and norm."""
        batch = self._local_batch(batch)
        for _, p in self._named:
            p.grad = None
        self._mark("start")
        loss, (bn_stats, _, _) = self._forward_loss(batch, train=True)
        self._mark("forward")
        loss.backward()
        self._mark("backward")
        with torch.no_grad():
            if self.mesh is not None:
                self._sum_grads_over_data()
            if bn_stats is not None:
                self._write_bn_stats(bn_stats)
            with_grad = [(n, p.grad) for n, p in self._named
                         if p.grad is not None]
            grad_norm = self._norm([n for n, _ in with_grad],
                                   [g for _, g in with_grad])
            self._update()
        self._mark("optimizer")
        self.step += 1
        opt_steps = self.step // max(1, self.tc.accumulate_grad_batches)
        return {"loss": self._sum_over_data(loss), "grad_norm": grad_norm,
                "lr": self._host_lr(max(0, opt_steps - 1))}

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    _CKPT_FORMAT = "gigaam_tpu_torch_train_ckpt_v1"

    def _gather_shards(self, arrays: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
        """Arrays keyed ``<kind>/<leaf name>/...`` with the sharded leaves'
        parts joined over "model" (one collective every rank joins)."""
        if self._model_group is None:
            return arrays
        mine = {k: a for k, a in arrays.items()
                if k.split("/")[1] in self._shard_axis}
        parts: List[Any] = [None] * tdist.get_world_size(self._model_group)
        tdist.all_gather_object(parts, mine, group=self._model_group)
        return dict(arrays, **{
            k: np.concatenate([part[k] for part in parts],
                              self._shard_axis[k.split("/")[1]])
            for k in mine})

    def _local_part(self, name: str, a: np.ndarray) -> np.ndarray:
        """This rank's "model" part of a whole leaf's array."""
        axis = self._shard_axis.get(name)
        if axis is None or self._model_group is None:
            return a
        return np.split(a, axis_size(self.mesh, "model"), axis)[
            axis_rank(self.mesh, "model")]

    def save_checkpoint(self, path: str) -> None:
        """Write one self-describing npz file: the parameters in the JAX
        package's layout, AdamW's moments by parameter name, pending
        accumulated gradients, the SpecAugment generator's state, and a
        JSON metadata entry.  No pickle anywhere.  Under a mesh every rank
        calls it: the shards are gathered and rank 0 alone writes, the same
        file one process writes; the call returns once the file is there."""
        arrays = {f"params/{k}": v
                  for k, v in _flatten(gather_params(self.model)).items()}
        arrays.update({f"params/{k}": v
                       for k, v in self._extra_arrays().items()})
        opt_step = 0.0
        state_arrays = {}
        for i, (name, p) in enumerate(zip(self._train_names,
                                          self._train_params)):
            state = self.optimizer.state.get(p)
            if state:
                opt_step = float(state["step"])
                state_arrays[f"opt/{name}/exp_avg"] = (
                    state["exp_avg"].cpu().numpy())
                state_arrays[f"opt/{name}/exp_avg_sq"] = (
                    state["exp_avg_sq"].cpu().numpy())
            if self._acc is not None:
                state_arrays[f"acc/{name}"] = self._acc[i].cpu().numpy()
        arrays.update(self._gather_shards(state_arrays))
        if self.mesh is None or tdist.get_rank() == 0:
            self._write_checkpoint(path, arrays, opt_step)
        if self.mesh is not None:
            tdist.barrier()          # the file exists when any rank returns

    def _write_checkpoint(self, path: str, arrays: Dict[str, np.ndarray],
                          opt_step: float) -> None:
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
        """Read a ``save_checkpoint`` file (of this or any mesh) back, each
        rank taking its "model" part."""
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
        tree = migrate_params(_unflatten(
            {k[len("params/"):]: v for k, v in arrays.items()
             if k.startswith("params/")}))
        if self._model_group is not None:
            tree = shard_params(tree, model_specs(self.model, tree),
                                axis_rank(self.mesh, "model"),
                                axis_size(self.mesh, "model"))
        state = params_from_jax(tree)
        enc = self.model.encoder
        load_state_into(enc.pre_encode, state["encoder"]["pre_encode"])
        if len(state["encoder"]["layers"]) != len(enc.layers):
            raise ValueError(f"{path}: layer count does not match the model")
        for layer, layer_tree in zip(enc.layers, state["encoder"]["layers"]):
            load_state_into(layer, layer_tree)
        if hasattr(self.model, "head"):
            load_state_into(self.model.head, state["head"])
        self._restore_extra(tree)

        def like(p: torch.Tensor, name: str, a: np.ndarray) -> torch.Tensor:
            # the parameter's own strides, as AdamW allocates its moments
            return torch.zeros_like(p).copy_(
                torch.from_numpy(self._local_part(name, a)))

        has_acc = any(k.startswith("acc/") for k in arrays)
        acc = []
        for name, p in zip(self._train_names, self._train_params):
            key = f"opt/{name}/exp_avg"
            if key in arrays:
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(meta["opt_step"]),
                                         dtype=torch.float32),
                    "exp_avg": like(p, name, arrays[key]),
                    "exp_avg_sq": like(p, name,
                                       arrays[f"opt/{name}/exp_avg_sq"]),
                }
            elif meta["opt_step"]:
                raise ValueError(
                    f"{path}: no optimizer state for {name}: TrainConfig "
                    "(freeze_encoder) mismatch")
            if has_acc:
                acc.append(like(p, name, arrays[f"acc/{name}"]))
        self._acc = acc if has_acc else None
        self.gen.set_state(torch.from_numpy(arrays["gen_state"]))
        self.step = int(meta["step"])

    def sync_model(self) -> None:
        """Kept for the JAX trainer's interface: the port updates the
        wrapped model's parameters in place, so there is nothing to copy."""


class FineTuner(TrainerBase):
    """CTC or RNNT fine-tuning loop around a ``GigaAMASR`` model (reference
    ``train_utils/module.py:16-271``); the head decides the objective.  The
    model's device is the trainer's; build the model with ``device="cpu"``
    to train on the CPU.  ``mesh``: see the module's docstring."""

    def __init__(self, model, tc: TrainConfig, seed: int = 0, mesh=None):
        self.blank_id = model.blank_id
        self.mode = ("ctc" if isinstance(model.cfg.head, CTCHeadConfig)
                     else "rnnt")
        super().__init__(model, tc, seed, mesh)

    # ------------------------------------------------------------------
    # forward / loss
    # ------------------------------------------------------------------

    def _forward_loss(self, batch, train: bool):
        wavs, wav_lens, tokens, tok_lens = batch
        compute_dtype = (torch.bfloat16 if self.tc.precision == "bf16"
                         else torch.float32)
        feats, feat_lens = self.model.frontend(wavs, wav_lens)   # [B, F, T]
        if train and self.tc.spec_augment:
            tc = self.tc
            draws = self._rows_of(lambda n: torch.rand(
                (tc.freq_masks + tc.time_masks, 2, n), generator=self.gen,
                device=feats.device), feats.shape[0], axis=2)
            feats = spec_augment_from_draws(feats, draws, tc.freq_masks,
                                            tc.freq_width, tc.time_masks,
                                            tc.time_width)
        # a frozen encoder still passes gradients (they count in grad_norm),
        # so it keeps the differentiable attention path; only its BatchNorm
        # switches to the running stats
        encoded, enc_lens, bn_stats = conformer_forward(
            self.model.encoder, feats.transpose(1, 2), feat_lens,
            self.enc_cfg, self._pos(wavs.shape[1]), compute_dtype,
            train=train, bn_train=train and not self.tc.freeze_encoder,
            bn_group=self._data_group)
        enc_lens = self._without_padding(enc_lens)
        if self.mode == "ctc":
            logits = heads_lib.ctc_logits(self.model.head, encoded)
            loss = ctc_loss(logits, enc_lens, tokens, tok_lens, self.blank_id,
                            self._data_group)
        else:
            # no lower clip on enc_lens: a pad row must reach the loss as 0
            # to leave the mean; an empty transcript (tok_lens 0) is valid
            loss = rnnt_loss(
                self.model.head, encoded.float(), tokens,
                torch.clamp(enc_lens, max=encoded.shape[1]),
                torch.clamp(tok_lens, 0, tokens.shape[1]),
                self.blank_id, self.tc.rnnt_time_chunk, self._data_group)
        return loss, (bn_stats, encoded, enc_lens)

    # ------------------------------------------------------------------
    # eval / decode
    # ------------------------------------------------------------------

    def eval_step(self, batch) -> Tuple[float, List[str]]:
        """(loss, hypotheses) of a batch, through the inference forward;
        under a mesh each rank runs its rows and every rank gets the whole
        batch's loss and hypotheses."""
        with torch.inference_mode():
            loss, (_, encoded, enc_lens) = self._forward_loss(
                self._local_batch(batch, pad=True), train=False)
            hyps = self.decode(encoded, enc_lens)
            loss = float(self._sum_over_data(loss))
        if self.mesh is not None:
            hyps = all_gather_rows(self._data_group, hyps)[:len(batch[0])]
        return loss, hyps

    def decode(self, encoded: torch.Tensor, enc_lens: torch.Tensor
               ) -> List[str]:
        if self.mode == "ctc":
            with torch.inference_mode():
                log_probs = heads_lib.ctc_log_probs(self.model.head, encoded)
                labels, keep = ctc_greedy_mask(log_probs, enc_lens)
            decoded = ctc_extract(labels.cpu().numpy(), keep.cpu().numpy())
        else:
            tokens, frames, counts = self.model.rnnt.decode(
                self.model.head, encoded, enc_lens,
                max_symbols=self.cfg.decoding.max_symbols_per_step)
            decoded = rnnt_extract(tokens.cpu().numpy(), frames.cpu().numpy(),
                                   counts.cpu().numpy())
        tok = self.model.tokenizer
        return [tok.decode(ids) for ids, _ in decoded]

    def batch_wer(self, hyps: List[str], tokens, tok_lens) -> Tuple[int, int]:
        tok = self.model.tokenizer
        refs = [
            tok.decode(np.asarray(tokens[i, : int(tok_lens[i])]).tolist())
            for i in range(len(hyps))
        ]
        return wer_counts(hyps, refs)

"""GigaAM in PyTorch and CUDA: the port of ``gigaam_tpu`` to an NVIDIA
H100, with the attention kernels written by hand for Hopper.

It imports neither ``jax`` nor ``gigaam_tpu``.  Entry points run on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import tempfile
from typing import Optional, Tuple, Union

import torch

from .audio import load_audio
from .config import (
    RU_VOCAB,
    SAMPLE_RATE,
    CTCHeadConfig,
    ModelConfig,
    make_preset,
)
from .decode.lm import NGramLM, train_lm_from_texts
from .models.model import GigaAM, GigaAMASR, GigaAMEmo, model_class_for
from .types import (
    LongformTranscriptionResult,
    Segment,
    TranscriptionResult,
    Word,
)
from .weights import load_native, params_from_jax

__all__ = [
    "GigaAM",
    "GigaAMASR",
    "GigaAMEmo",
    "LongformTranscriptionResult",
    "ModelConfig",
    "NGramLM",
    "RU_VOCAB",
    "SAMPLE_RATE",
    "Segment",
    "TranscriptionResult",
    "Word",
    "load_audio",
    "load_model",
    "load_native",
    "make_preset",
    "params_from_jax",
    "train_lm_from_texts",
]


_CACHE_DIR = os.path.expanduser("~/.cache/gigaam_tpu")

# The reference checkpoints' CDN and md5 pins (reference
# ``gigaam/__init__.py:26-41``).  A ``.ckpt`` fetched from there is
# converted on first load, and the converted ``.npz``/``.json`` pair (which
# loads in either package) is what the cache keeps.
_URL_DIR = "https://cdn.chatwm.opensmodel.sberdevices.ru/GigaAM"
_MODEL_HASHES = {
    "emo": "7ce76f9535cb254488985057c0d33006",
    "v1_ctc": "f027f199e590a391d015aeede2e66174",
    "v1_rnnt": "02c758999bcdc6afcb2087ef256d47ef",
    "v1_ssl": "dc7f7b231f7f91c4968dc21910e7b396",
    "v2_ctc": "e00f59cb5d39624fb30d1786044795bf",
    "v2_rnnt": "547460139acfebd842323f59ed54ab54",
    "v2_ssl": "cd4cf819c8191a07b9d7edcad111668e",
    "v3_ctc": "73413e7be9c6a5935827bfab5c0dd678",
    "v3_rnnt": "0fd2c9a1ff66abd8d32a3a07f7592815",
    "v3_e2e_ctc": "367074d6498f426d960b25f49531cf68",
    "v3_e2e_rnnt": "2730de7545ac43ad256485a462b0a27a",
    "v3_ssl": "70cbf5ed7303a0ed242ddb257e9dc6a6",
}
_SHORT_NAMES = ["ctc", "rnnt", "e2e_ctc", "e2e_rnnt", "ssl"]
_KNOWN_MODELS = list(_MODEL_HASHES) + _SHORT_NAMES


def hash_path(path: str) -> str:
    """md5 of a file (reference ``gigaam/__init__.py:95-97``)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _download_file(file_url: str, file_path: str) -> str:
    """Stream a URL to ``file_path`` unless it is there already (reference
    ``gigaam/__init__.py:44-66``), through a per-process ``.part`` file
    renamed at the end, so that an interrupted or concurrent fetch never
    leaves a partial file under the final name."""
    import urllib.request

    if os.path.exists(file_path):
        return file_path
    folder = os.path.dirname(file_path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".part",
                               prefix=os.path.basename(file_path) + ".")
    os.close(fd)
    try:
        with urllib.request.urlopen(file_url) as src, open(tmp, "wb") as out:
            shutil.copyfileobj(src, out, 1 << 20)
        os.replace(tmp, file_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return file_path


def _resolve(model_name: str) -> str:
    return f"v3_{model_name}" if model_name in _SHORT_NAMES else model_name


def _needs_sentencepiece(resolved: str) -> bool:
    return resolved == "v1_rnnt" or "e2e" in resolved


def _download_model(model_name: str, download_root: str) -> Tuple[str, str]:
    """Fetch the reference ``.ckpt`` by name: (resolved name, path)
    (reference ``gigaam/__init__.py:69-82``)."""
    resolved = _resolve(model_name)
    path = _download_file(f"{_URL_DIR}/{resolved}.ckpt",
                          os.path.join(download_root, resolved + ".ckpt"))
    return resolved, path


def _download_tokenizer(model_name: str, download_root: str) -> Optional[str]:
    """Fetch the SentencePiece model of a model that needs one (reference
    ``gigaam/__init__.py:85-92``)."""
    if not _needs_sentencepiece(model_name):
        return None
    return _download_file(
        f"{_URL_DIR}/{model_name}_tokenizer.model",
        os.path.join(download_root, model_name + "_tokenizer.model"))


def load_model(model_name: str,
               device: Optional[Union[str, torch.device]] = None,
               download_root: Optional[str] = None, init: str = "weights",
               seed: int = 0, bf16_encoder: bool = False, **kw) -> GigaAM:
    """A model by name or from a file, in the JAX package's argument order
    (reference ``gigaam/__init__.py:110-192``):

    * a ``save_model`` artifact (``model.npz``, or ``model`` with its
      ``.json`` beside it), read by ``load_native``;
    * a reference torch ``.ckpt``, converted on the fly; a fine-tuned
      Lightning ``.ckpt`` (``hyper_parameters``, no ``cfg``) takes its
      config from its base model's name and its weights from itself;
    * a known model name with ``init="random"``: random weights from a
      ``torch.Generator`` seeded with ``seed``; a SentencePiece preset
      (v1_rnnt, the e2e models) uses a ``<name>_tokenizer.model`` cached
      under ``download_root`` and sizes its head to it, or else gets
      placeholder pieces ``"<i>"``;
    * a known model name: the converted artifact cached under
      ``download_root`` (default ``~/.cache/gigaam_tpu``, shared with the
      JAX package), or else the reference ``.ckpt`` downloaded there,
      md5-checked (a corrupt file is removed), converted and cached.

    ``device=None`` means the card; it raises on a host without CUDA.
    ``bf16_encoder`` casts the encoder weights to bfloat16 on a CUDA device
    (the reference's ``fp16_encoder``; the JAX package casts off the CPU);
    on the CPU it does nothing.  ``kw`` (``compute_dtype``,
    ``use_fused_attention``) go to the model class.
    """
    if init not in ("weights", "random"):
        raise ValueError(f"init must be 'weights' or 'random', got {init!r}")
    root = download_root or _CACHE_DIR

    def finish(model: GigaAM) -> GigaAM:
        if bf16_encoder and model.device.type == "cuda":
            model.cast_encoder()
        return model

    def build(cfg: ModelConfig, tree) -> GigaAM:
        return model_class_for(cfg)(cfg, state=params_from_jax(tree),
                                    device=device, **kw)

    local = os.path.expanduser(model_name)
    if os.path.isfile(local) or os.path.isfile(local + ".npz"):
        if not local.endswith(".ckpt"):
            return finish(load_native(local, device=device, **kw))
        from .checkpoint import (
            apply_finetuned_state_dict,
            convert_reference_checkpoint,
            is_lightning_checkpoint,
            load_torch_checkpoint,
        )

        ckpt = load_torch_checkpoint(local)
        if not is_lightning_checkpoint(ckpt):
            return finish(build(*convert_reference_checkpoint(local,
                                                              ckpt=ckpt)))
        # a fine-tuned Lightning checkpoint holds the whole wrapped model:
        # the base's config comes by name (the preset, sized to a cached
        # tokenizer), the weights from the checkpoint alone
        base_name = ckpt["hyper_parameters"]["model_name"]
        resolved = _resolve(base_name)
        if _needs_sentencepiece(resolved):
            try:
                _download_tokenizer(resolved, root)
            except OSError:
                pass        # offline: a cached tokenizer may still serve
        cfg = _random_config(base_name, root)
        if (_needs_sentencepiece(resolved)
                and cfg.decoding.model_path is None):
            raise FileNotFoundError(
                f"Fine-tuned checkpoint '{local}' is based on '{resolved}', "
                f"which needs a sentencepiece tokenizer, and none is cached "
                f"under {root} nor downloadable. Place "
                f"{resolved}_tokenizer.model there first.")
        try:
            tree = apply_finetuned_state_dict(cfg, local, ckpt=ckpt)
        except KeyError:
            # the preset does not fit this state dict (a non-standard base):
            # take the config of the base itself, cached or downloaded
            cfg = load_model(base_name, device="cpu",
                             download_root=download_root, seed=seed).cfg
            tree = apply_finetuned_state_dict(cfg, local, ckpt=ckpt)
        return finish(build(cfg, tree))

    if model_name not in _KNOWN_MODELS:
        raise FileNotFoundError(
            f"no artifact at {model_name!r} and no model of that name: pass "
            f"a save_model .npz/.json pair, a reference .ckpt, or one of "
            f"{_KNOWN_MODELS}")
    resolved = _resolve(model_name)
    # init="random" wins over a cached artifact: a weight-free run never
    # returns trained weights because an earlier load filled the cache
    if init == "random":
        cfg = _random_config(model_name, root)
        return finish(model_class_for(cfg)(cfg, device=device, seed=seed,
                                           **kw))
    cached = os.path.join(root, f"{resolved}.npz")
    if os.path.isfile(cached):
        return finish(load_native(cached, device=device, **kw))

    from .checkpoint import convert_reference_checkpoint
    from .weights import save_model

    try:
        resolved, ckpt_path = _download_model(model_name, root)
        tok_path = _download_tokenizer(resolved, root)
    except OSError as e:  # no network, a proxy, the CDN down
        raise FileNotFoundError(
            f"No converted weights for '{model_name}' under {root} and the "
            f"checkpoint download failed ({e}). Convert a reference "
            f"checkpoint offline with python -m "
            f"gigaam_tpu_torch.tools.convert_checkpoint, or pass "
            f"init='random' for an untrained model.") from e
    expected = _MODEL_HASHES.get(resolved)
    if expected is not None and hash_path(ckpt_path) != expected:
        # remove the bad file, so that a retry downloads it again
        os.remove(ckpt_path)
        raise RuntimeError(
            f"Checksum mismatch for {ckpt_path}; the corrupted download was "
            f"removed: retry load_model.")
    cfg, tree = convert_reference_checkpoint(ckpt_path, resolved)
    if tok_path and cfg.decoding is not None:
        cfg.decoding.model_path = tok_path
    model = build(cfg, tree)
    save_model(model, os.path.join(root, resolved))
    return finish(model)


def _random_config(model_name: str, root: str) -> ModelConfig:
    """The preset of ``init="random"``.  A SentencePiece preset resolves its
    vocabulary from its tokenizer: a ``<name>_tokenizer.model`` cached under
    ``root`` sizes the head to its pieces; without one, pieces ``"<i>"``
    sized to the head stand in (``gigaam_tpu/__init__.py:287-323``)."""
    cfg = make_preset(model_name)
    dec = cfg.decoding
    if dec is None or dec.vocabulary or dec.model_path is not None:
        return cfg
    tok_file = os.path.join(root, f"{_resolve(model_name)}_tokenizer.model")
    if os.path.isfile(tok_file):
        from .decode.tokenizer import Tokenizer

        n = len(Tokenizer([], tok_file)) + 1
        if isinstance(cfg.head, CTCHeadConfig):
            head = dataclasses.replace(cfg.head, num_classes=n)
        else:
            head = dataclasses.replace(
                cfg.head,
                decoder=dataclasses.replace(cfg.head.decoder, num_classes=n),
                joint=dataclasses.replace(cfg.head.joint, num_classes=n))
        return dataclasses.replace(
            cfg, head=head,
            decoding=dataclasses.replace(dec, model_path=tok_file))
    n = (cfg.head.num_classes if isinstance(cfg.head, CTCHeadConfig)
         else cfg.head.joint.num_classes) - 1
    return dataclasses.replace(cfg, decoding=dataclasses.replace(
        dec, vocabulary=[f"<{i}>" for i in range(n)]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card (``nvidia-smi`` name and power limit, torch's name);
2. build the hand-written kernels (``gigaam_tpu_torch/csrc``, one ``nvcc``
   per source, all started together) and print each kernel's registers,
   spills and shared memory (none of the ``wgmma`` kernels may spill, and
   K3's, P1/P2's, P4's, P6/P7's and P9's instances keep their registers,
   ``KEPT_REGISTERS``);
3. hold each kernel (K3, K2, K1, K5) against its plain PyTorch version at
   the main path's shapes in bf16, show that the check fails for a kernel
   with a planted fault (fed through its inputs: RoPE sign flipped, key mask
   ignored, 1/sqrt(d_h) missing, q zeroed, Wv swapped for Wk, LayerNorm
   skipped, the residual left out; for K5 also q_u/q_v swapped, the shift
   reversed, the positional term dropped), and time the kernel, its plain
   version and the library call with CUDA events; K3 and K5 also return
   their log-sum-exp, held against the plain one and timed with and
   without; K1 and K2 at B 1, 8, 16, 32 (T' 500) and B 2, T' 1024, three
   calls bit-equal, also by the profile's kernel sum, then split into their
   four stages (row pass, QKV GEMM, K3, output GEMM), each beside its bound
   and the GEMMs beside the same products as ``F.linear`` calls; then the
   dispatch A/B: K1 against LN + K2 + the residual add at T' 500 (B 1 to
   32), K2 against the composed path (``F.linear`` projections around K3)
   at T' 1024 to 3000 (B 1 and 8);
4. drive full-width v3_ctc (16 x 768, random weights from a seed, bf16)
   through the user entry points: ``transcribe`` on a 20 s clip (batch 1:
   K2), ``_decode_batch`` on 16 clips of 10-20 s (K1) and ``encode_batch``
   on a 125 s clip (T' = 3125, past the fold: K3), asserting from the
   launch counts that each path went through its kernel, then profiling
   each call
   (``torch.profiler``): device busy time, idle share, kernel launches and
   device time by kernel group;
5. compare the card's bf16 v3_ctc encoder output with the port's own CPU
   float32 output on the same weights, on small inputs through each of the
   three rotary attention paths;
6. the same for the rel-pos encoder (K5): full-width v2_ctc (its
   ``pos_bias_u``/``pos_bias_v`` drawn nonzero and apart from a seed)
   through ``transcribe`` on 20 s and ``_decode_batch`` on 16 clips of
   10-20 s (T' = 501), full-width emo through ``get_probs`` on 10 s
   (T' = 251), each profiled, then the v2_ctc reference comparison at 4 s,
   16 x 1-2 s and 42 s (T' = 1051);
7. the backward kernels: K4 and K6 against their plain backward in bf16 at
   B 16 T' 500/501 (the training shape), B 8 T' 750 and B 2 T' 1000, per
   gradient, with ``do`` zero on padded rows; the plain backward against
   ``torch.autograd.grad`` through the plain forward in fp32; planted faults
   (key mask ignored, scale missing from ds, the rowsum term dropped and, fed
   through the inputs, the log-sum-exp of another batch element and D from
   a zeroed forward output; for K6 also P without the bias, the unshear
   reversed, dp from the last batch element only), each of which must land
   above the limit; each kernel from its forward's saved (out, lse) and
   without them, the same bits; times (with the pair given, and without),
   bounds, two runs bit-equal, but for K6's dp, whose spread over two runs
   is printed (its batch sum uses atomics); K4's library time is SDPA's
   backward alone on a pinned backend (``SDPA_YARDSTICK``), printed beside
   the backend PyTorch picks unpinned and each backend's reading;
8. the SDPA ablation (P9-P12, ``gigaam_tpu_torch/probes/sdpa_ablation.py``):
   each of its eleven variants of K3 against its plain version at B 8,
   T' 501 and B 16, T' 500 (ragged masks, peaked scores), with planted faults
   fed through the inputs (key mask ignored; the k of the next head group;
   for I and J also the V of the previous head, a slip of the redesign's
   ring; another batch element's mask row per head; heads permuted in the
   packed q), ``A_full`` bit-equal to K3, each timed by CUDA events and by
   the profile's kernel sum beside its bound, its plain version and the
   library call, and the exponential unit's floor at its published rate
   printed beside the bound; I and J (the head-group walk, P9) on its
   warp-specialised redesign (``csrc/sdpa_groups_ws.cu``), against the kept head-group kernel of
   ``csrc/sdpa_ablation.cu`` (held to the plain version too, the two
   compared bit for bit) in turns by events, the kernel sum and graph
   replays, with each grid's blocks; P12's six computing bodies and P10 on
   the per-head walk's redesign (``csrc/sdpa_heads_ws.cu``), with more
   planted faults (the two query tiles of a unit swapped, the K/V of the
   previous head, each persistent block skipping its last unit), each
   against its kept kernel of ``csrc/sdpa_ablation.cu`` (held to the plain
   version too, compared bit for bit; ``A_full`` and P10 in turns as P9,
   the other kept bodies by one fenced kernel sum at the first shape); the
   copy, on its kept kernel, beside ``q4.clone()``'s fenced sum; P11 on
   the per-head walk's packed instance (``csrc/sdpa_packed_heads_ws.cu``,
   each head read through a 4-D tensor map), bit-equal to K3's heads moved
   to the packed layout and to its kept kernel, in turns with it at both
   shapes, with the per-head walk's planted faults in the packed layout and
   two slips of its map (a 3-D map over the flat 768 columns at column 48 h,
   whose box reaches 16 columns into the next head where no product reads,
   must keep the bits; the same 16 columns over must be caught), beside two
   library calls (SDPA on contiguous heads with the transposes, and on
   strided views of the packed tensors); then the
   ablation's own ``main`` with both switches, from zeroed launch counts,
   printed as an ``ablation`` line in microseconds, and the phase's wall;
9. the FFN and conv-module fold probes (P4, P5,
   ``gigaam_tpu_torch/probes/fold_probes.py``): each fold against its plain
   version at the scripts' B 32, T 512 and B 128, T 768 and at the main
   path's B 16, T' 500 (the script's ragged lengths for P5), with planted
   faults at the first shape (the 0.5 dropped, SiLU skipped, W2 one K item
   late, a slip of the redesign's ring; the mask skipped, the depthwise
   window shifted by one tap, the depthwise bias left out of the BatchNorm
   fold), each timed by CUDA events and by the profile's kernel sum beside
   its bound, its plain version and both stock paths (the in-model
   baseline, and the lean path as the library call); P4 on its redesign
   (``csrc/ffn_ws.cu``: a row pass and two products on the warp-specialised
   core) and P5 on its (``csrc/conv_fold_ws.cu``: P4's row pass, the GLU
   and pointwise products on the ping-pong core, the depthwise pass between
   them; each of its four stages held to its plain stage, a slip of W_vg's
   value/gate interleave planted), each against the kept kernels (held to
   the plain version too, compared bit for bit; P5's timed by events, the
   kernel sum and graph replays, in turns at B 16, T 500 and B 128, T 768,
   P4's no longer timed), the redesign's sum by kernel; then the probes'
   own ``main``, from zeroed launch counts, printed as a ``fold_probes``
   line in microseconds;
10. the conv2d-subsampling probes (P1-P3,
   ``gigaam_tpu_torch/probes/subsampling_probe.py``): the tap products (P1,
   aligned and with copies) and the im2col product (P2, without and with the
   linear), on the warp-specialised redesign (``csrc/subsampling_ws.cu``),
   against their plain versions at the script's B 1, T 32-128 and
   at the main path's stage 2, B 16, T' 500 (the blocks of a stage-1 output
   drawn on the card), with planted faults (the misaligned taps read
   aligned, the odd-time blocks' hi offset dropped, two taps' weights
   swapped, ReLU skipped before the linear and, fed through the inputs, a
   tile that reads across a batch edge), each timed by CUDA events, by
   the profile's kernel sum and by graph replays beside its bound,
   its plain version, the library call (cuDNN's stride-2 conv in the
   port's NCHW layout and in ``channels_last``; a ``torch.matmul`` for P1
   aligned) and the earlier design (the TMA ring of
   ``csrc/subsampling_probe.cu``, also held to the plain version); the
   redesign's steps one by one at B 16, T 500 and B 1, T 64, the forced
   K splits at B 1, T 64, the linear's K splits at B 16; at B 16 each
   call's kernels, P2's peak memory (no patch, no ``patch_kernel``) and,
   for P1, the SM clock and power under 400 gapless calls (``nvidia-smi``
   samples), which turns the card's reading into the graph's;
   P3's shared-memory ceiling against the card's opt-in limit, with 2 x
   exact at every granted size from its bulk-copy redesign
   (``csrc/smem_probe_ws.cu``) and its kept kernel, the two timed in turns
   beside an empty kernel on the same grid (the floor of one launch) and
   ``x * 2``; then the probe's own ``main``, from zeroed
   launch counts, printed as a ``subsampling_probe`` line in microseconds;
11. the attention-fold probes (P6-P8,
   ``gigaam_tpu_torch/probes/attn_fold_probes.py``): P6 (nb 2 and 4), P7
   (foldA: per-head N-48 products; foldB: N-128 lane slices) and P8 (the
   residual added in fp32) against their plain versions at the scripts'
   shapes, the main path's B 16, T' 500 and, for P7, B 1, T' 500 (at B 128
   the first and last 8 batch rows), three calls bit-equal, with planted
   faults at B 8, T 512 (RoPE sign flipped, key mask ignored, bq left
   unscaled, q zeroed, Wv swapped for Wk; foldA's head h reading head h+1's
   block; P8's LayerNorm skipped and residual left out; for the redesign
   the packed o one head off and a 64-row tile stored into its partner's
   rows), each timed by CUDA events, by the profile's kernel sum (and its
   four stages) and by graph replays beside its bound, its plain version,
   the script's baseline, K2 (P8: K1) and the lean stock path; every
   variant on its redesign (``csrc/attn_fold_ws.cu``; P8's output product
   with the fp32 residual in ``csrc/attn_lnres_ws.cu``, each of its stages
   and its three output instances held to their plain stages) against the
   kept kernels (``fold_ring``, ``lnres_ring``), in turns at B 16, T 500
   and B 128, T 768; P8 against K1 and each against the fp32 module; then
   the probes' own ``main``, from zeroed launch counts, printed as an
   ``attn_fold_probes`` line in microseconds;
12. CTC fine-tuning at full width, bf16 over fp32 master weights, batch 16 of
   10-20 s clips written as WAVs with a TSV manifest to a temporary
   directory: the CLI ``gigaam_tpu_torch.train.train.main`` for v3_ctc
   (4 steps, SpecAugment, validation on the first batch), then
   ``FineTuner.train_step`` directly for v2_ctc, for v3_ctc, and for v3_ctc
   with activation checkpointing (3 steps each), asserting from the launch counts that
   every layer's backward went through K4 / K6 and no train step through
   K1/K2, that every trainable leaf and every BatchNorm buffer moved, that
   the positional parameters got a gradient, and that ``eval_step`` after
   the steps sees the new weights; per step wall time, peak memory, the
   forward/backward/optimizer split and a profile;
13. one train step at full width but 2 layers, batch 4 of 2-4 s: the card's
   bf16 loss and gradients against the port's CPU fp32 ones;
14. RNNT and SentencePiece: full-width v3_rnnt (random weights from a seed,
   bf16 encoder, fp32 head, the joint's blank logit raised by a fixed
   ``RNNT_BLANK_BIAS``) through ``transcribe`` on 20 s (K2) and
   ``_decode_batch`` on 16 clips of 10-20 s (K1), asserted from the launch
   counts and profiled, each with its greedy label loop alone on the same
   encoded batch (graph replays, host reads, iterations, device and wall
   ms, and the eager loop's); then, on the batch's encoded output, under
   a blank bias of +1e4 (exactly T' iterations) and the moderate one
   (0.2-0.6 tokens a frame, asserted): the CUDA-graph decode bit-equal to
   the eager loop on the card, equal to the port's CPU fp32 decode of the
   same tensor (tokens, frames, counts; log-probs within 1e-4), the
   smallest top-1/top-2 margin of its decisions, host reads at most
   ceil(iterations / chunk) + 1, and the wall time by chunk length (16, 32,
   64); then full-width v3_e2e_rnnt (its joint unbiased) and v3_e2e_ctc
   with a synthetic 512-piece SentencePiece model, one ``transcribe`` on
   20 s (K2) and one ``_decode_batch`` of 16 (K1) each, launch counts
   asserted, their texts' lengths printed;
15. longform and alignment: full-width v3_ctc through
   ``transcribe_longform`` on a 6-minute WAV of speech-like bursts between
   -80 dBFS gaps (energy VAD, chunk batches of 16, two in flight), launch
   counts asserted (K1 in every layer of every batch), segments and word
   times checked; one batch in flight against two (same texts, walls in
   turns, idle shares, each profiled), the ``_int16_wire`` A/B (same texts,
   walls, H2D ms), the energy VAD's host ms per audio minute; a random
   PyanNet at pyannote's widths saved with ``save_vad`` and found through
   ``GIGAAM_VAD_ARTIFACT`` (one ``transcribe_longform``; its class
   probabilities on the card against the port's CPU fp32 ones, within
   1e-4, argmax equal past a 1e-3 margin; device ms per audio minute);
   ``align_batch`` on 16 clips of 10-20 s with the model's own greedy
   transcripts (the CTC head centred on the clips and its blank raised so
   that they hold words) (K1) and ``align`` on one (K2); the DP alone: its
   CUDA graph bit-equal to the eager loop and to the CPU fp32 DP, its
   device and wall ms and its share of ``align_batch``; then v2_ctc's
   ``transcribe_longform`` (K5 in every layer);
16. beam decoding and n-gram fusion: full-width v3_rnnt (the blank bias
   and the LM's token bonus of BEAM_SHAPE, at which the K-4 beam, plain
   and fused with a char trigram trained by ``train_lm_from_texts`` on
   seeded synthetic Russian text, emits 0.2-0.8 tokens a frame on the
   batch, asserted: at phase 14's bias the beam emits nothing) at beam 4
   through ``transcribe`` on 20 s (K2) and ``_decode_batch`` on 16 clips
   of 10-20 s with the trigram (its dense table on the card) (K1), launch
   counts asserted, each timed once unprofiled, each with its beam alone on
   the call's encoded output, profiled (expansions, host reads at most
   ceil(expansions / chunk) + 1, graph replays, device and wall us per
   expansion; for the batch the CUDA graphs bit-equal to the eager loop);
   on the
   batch: equal to the port's CPU fp32 beam of the same tensor on every
   row whose decisions all lie more than BEAM_TIE_GAP from a tie (rows
   and gaps printed), ``lm_weight`` 0 equal to no LM, K 1 equal to the
   greedy decoder on every row where no decision's cumulative scores tie
   exactly in fp32 (greedy's argmax then takes the label, the beam's pool
   the blank); then full-width v3_e2e_rnnt with the synthetic 512-piece
   SentencePiece model (shaped the same way) and a SentencePiece trigram
   (its sparse table) through
   ``_decode_batch`` of 16 (K1), and a bigram whose dense and sparse
   tables give equal tokens; then v3_ctc ``_decode_batch`` of 16 at beam 8
   with the char trigram (the host prefix beam; the head centred and its
   blank raised as in phase 15) (K1), device ms and host beam ms a clip;
17. reference checkpoints, RNNT fine-tuning, BEST-RQ and conv1d: full-width
   v3_ctc and v3_rnnt written as reference ``.ckpt`` files (the cfg a plain
   dict with ``${...}`` interpolations) and a fine-tuned Lightning v3_ctc,
   each loaded with ``load_model(path)``, the v3_ctc also by name through
   ``download_root`` from a ``file://`` CDN (md5 pinned) and then from the
   converted cache: parameters equal, encoder outputs and log-probs (RNNT:
   the greedy decode) bit-equal to the source's, texts equal, and the
   ingested model's ``transcribe`` 20 s (K2) and ``_decode_batch`` of 16
   (K1) from zeroed counts, with the host seconds of ``torch.save`` and
   of a full-width conversion; v3_rnnt fine-tuning at batch 16 of 10-20 s
   (the CLI for 3 steps, ``FineTuner.train_step`` x 3 without activation
   checkpointing and under ``remat_policy`` "full" and "dots", launch
   counts asserted per step, every leaf moved, "dots" against "full" on one
   step's gradients), the RNNT loss alone (forward and backward ms, peak
   memory), one step at 2 layers against the CPU's fp32; v3_ssl BEST-RQ
   (``SSLPretrainer.train_step`` x 3, ``eval_step``, the pretrain CLI for
   2 steps and a resume for a third); a v3 config with conv1d subsampling,
   ``encode_batch`` of 16 in bf16 (K1) against the CPU fp32 model, and in
   fp32 (composed attention), whose greedy ids must equal the CPU's on
   every frame with a margin of ``CONV1D_MARGIN``;
18. export, serving, streaming and the client: a 2-layer full-width
   v3_ctc (bf16 weights) exported with ``to_exported`` at batch 1 and 8 x
   20 s, a 2-layer full-width v3_ssl at 125 s (T' 3125)
   and a 2-layer emo, into a temporary directory, reloaded by a fresh
   process that imports ``exported_infer`` (and the launch counters): K1
   twice in the batch-8 graph, K2 twice in the batch-1 graph, K3 and K5
   twice, counted there; the
   log-probs bit-equal to the live model's at the same shapes (greedy ids
   and texts equal), within ENCODER_RTOL of the composed attention; the
   exported and the live batch-8 call timed and profiled; v3_rnnt's
   encoder, ``decoder`` and ``joint`` at batch 8 (blank bias
   RNNT_BLANK_BIAS), the exported label loop's tokens equal to the live
   greedy decoder's up to any first difference, which must lie within
   RNNT_EXPORT_MARGIN of a tie; then a full-depth v3_ctc and a v3_rnnt
   ``BatchingASRServer`` (max_batch 8, window 15 ms, ``warmup(seconds=[5])``
   only) at once under 32 posts of 3-20 s from 8 client threads, a 120 s
   ``/transcribe_longform`` and a 30 s ``/transcribe_stream`` in 0.5 s
   chunks each: every served batch equal to the live ``_decode_batch`` of
   its rows, the longform result equal to the live one, the RNNT graphs
   captured during the load, post latency, batches, stride latency; a
   burst of 24 posts against a queue of 1 answered partly 503;
19. data- and tensor-parallel inference and training (``parallel_path``):
   2 ranks spawned on the one card over gloo (NCCL refuses two ranks on
   one device) against one process, both bf16 at full width: v3_ctc under
   ``set_mesh`` (data 2) through ``_decode_batch`` of 16 (K1 on 8 rows a
   rank), of 2 (K2 on one) and of 3 (padded to 4: K1), the 6-minute
   ``transcribe_longform`` and ``align_batch`` of 16, every text equal to
   the host's greedy decode of the log-probs its call decoded and every
   alignment to one process's ``align_batch`` on the log-probs its call
   aligned (on every row), the log-probs within PAR_LOGP_ATOL of one
   process's, the greedy ids equal on every frame past twice that, texts
   and alignments equal on every row whose ids are; v3_ctc (K3+K4)
   and v2_ctc (K5+K6) cut to PAR_TRAIN_LAYERS (4) ``FineTuner`` at data 2
   x model 1 and data 1 x model 2, two steps on a batch of 16 (T' 500):
   loss, norm, the gathered
   gradients by group, the sync-BN moments, the gathered leaves after the
   first real update, K3-K6 launches and heads a rank; the position
   group's run-to-run spread of one process; planted faults that must be
   caught (a reduce dropped, the bias added twice, per-rank BN statistics,
   a rank's rows swapped, ``pos_bias_u`` from the other model rank); then
   the v3_ctc step in a one-rank
   ``nccl`` group, bit-equal to the step with no group;
20. the rel-pos RNNT family (``relpos_rnnt_path``): full-width v2_rnnt
   (pos biases drawn apart) against the CPU fp32 model first (encoded
   lengths, the encoder within ENCODER_RTOL, each layer's attention module
   within KERNEL_REL x RMS; ``pos_bias_u``/``pos_bias_v`` swapped on the
   card must land outside), then at RELPOS_RNNT_SHAPE's blank bias
   ``transcribe`` 20 s and ``_decode_batch`` 16 (K5 in every layer), each
   profiled with its label loop alone, the graph decode bit-equal to the
   eager loop and equal to the CPU fp32 decode of the same encoded tensor,
   then the K-4 beam at its own bias (and a char trigram at its token
   bonus) through both calls without and with the trigram (each timed
   once, K5 counted, the batch's rates held to BEAM_RATE, the fused
   batch's beam profiled and bit-equal to its eager loop); then v1_rnnt
   through ``load_model`` with a synthetic 512-piece SentencePiece model
   in its ``download_root``: the same greedy calls and checks,
   ``_decode_batch``'s texts equal to the CPU decode's ids read by a
   tokenizer of its own (piece ids read one off must be caught), and
   ``_decode_batch`` 16 at beam 4 with an SP trigram (sparse table);
21. v2_rnnt fine-tuning (``relpos_rnnt_train_path``): the train CLI for 3
   steps and 2 validation batches, ``FineTuner.train_step`` x 3 without
   remat and under "full" and "dots" (K5 and K6 counted a step), "dots"
   against "full", the RNNT loss alone, a fenced step (``device_ms``), K6
   on one step's own inputs against its plain version
   (``k6_step_check``), then one step at 2 layers, batch 4, against the
   CPU's fp32 loss and gradients, with K6 on that step's inputs (dq
   scaled by 1.01 must be caught);
22. v2_ssl BEST-RQ (``ssl_phase`` with ``name="v2_ssl"``):
   ``SSLPretrainer.train_step`` x 3 at batch 16 (K5 and K6 counted), the
   quantizer frozen, ``eval_step`` (K5), the pretrain CLI for 2 steps and
   a resume for a third;
23. RNNT longform (``rnnt_longform_path``): full-width v3_rnnt
   ``transcribe_longform`` on phase 15's 6-minute WAV, greedy and at beam
   4 (K1 in every layer of every chunk batch), each chunk's text equal to
   ``_decode_batch`` of its batch, two batches in flight against one (row
   0's encoded length halved in every batch must be caught).

Before the card's line, an ``rnnt`` line holds phase 14's numbers, a
``longform`` line phase 15's, an ``rnnt_beam`` line phase 16's, an
``ingest_train`` line phase 17's, ``export`` and ``serve`` lines phase
18's, a ``parallel`` line phase 19's, ``relpos_rnnt``,
``relpos_rnnt_train``, ``relpos_ssl`` and ``rnnt_longform`` lines phases
20-23's and a ``phase walls`` line the wall seconds of each phase.
``python3 chip_smoke.py --batch1-wall`` times batch-1 ``transcribe`` alone
(``batch1_wall``).  The
last two lines of output are a JSON object with every kernel's numbers
(``shape`` names the shape of a row's numbers, ``also`` holds the same
numbers at the kernel's other shapes; the probes' rows add ``sum_ms``,
the profile's kernel sum, and their ``main``'s reading, ``ablation_us``,
``fold_us`` or ``probe_us``; the fold probes' also ``baseline_ms``, the
in-model path, the subsampling probes' ``graph_ms`` and ``library_cl_ms``,
the conv in ``channels_last``; the attention-fold probes' also
``stages_ms``, ``baseline_*``, ``K2_*`` or ``K1_*`` and, for P8,
``k1_vs_p8``) and
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import gigaam_tpu_torch as gt
from gigaam_tpu_torch import checkpoint as gt_ckpt
from gigaam_tpu_torch import vad as gt_vad
from gigaam_tpu_torch.audio import save_wav
from gigaam_tpu_torch.config import RU_VOCAB, SAMPLE_RATE, make_preset
from gigaam_tpu_torch.data import AudioDataset, normalize_text, write_manifest
from gigaam_tpu_torch.decode import rnnt_beam, rnnt_greedy
from gigaam_tpu_torch.decode.align import (
    ViterbiAligner,
    backtrack,
    pad_targets,
)
from gigaam_tpu_torch.decode.ctc_greedy import ctc_greedy_mask
from gigaam_tpu_torch.decode.rnnt_beam import RNNTBeamDecoder
from gigaam_tpu_torch.decode.rnnt_greedy import RNNTGreedyDecoder, trip_count
from gigaam_tpu_torch.decode.tokenizer import write_sp_model
from gigaam_tpu_torch.models.vad_net import (
    PyanNet,
    VADNetConfig,
    init_vad_state,
    save_vad,
    sliding_class_probs,
)
from gigaam_tpu_torch.models.model import model_class_for
from gigaam_tpu_torch.models.heads import (
    ctc_log_probs,
    rnnt_joint_enc_proj,
    rnnt_joint_step_preproj,
    rnnt_predict_sequence,
)
from gigaam_tpu_torch.ops import cuda_lib
from gigaam_tpu_torch.ops import fused_attention as fa
from gigaam_tpu_torch.ops.attention import relpos_mha, rotary_mha
from gigaam_tpu_torch.ops.conformer_ops import layer_norm
from gigaam_tpu_torch.ops.precision import full_fp32
from gigaam_tpu_torch.ops.rnnt_loss import rnnt_loss
from gigaam_tpu_torch.ops.rotary import rotary_tables
from gigaam_tpu_torch.profiling import device_timeit
from gigaam_tpu_torch.train import pretrain as gt_pretrain
from gigaam_tpu_torch.train import train as train_cli
from gigaam_tpu_torch.train.finetune import FineTuner, TrainConfig
from gigaam_tpu_torch.types import LongformTranscriptionResult, Segment
from gigaam_tpu_torch.weights import params_to_jax

# A kernel passes where, on every valid query row,
#   |got - ref| <= KERNEL_REL * RMS(attention output of ref) + KERNEL_RTOL * |ref|:
# a tenth of the output's own size, plus one bf16 rounding of the value (K1
# adds the residual in bf16).  The attention output is ref itself for K3/K2
# and ref - x for K1.  The planted faults must land above the same limit.
KERNEL_REL = 0.1
KERNEL_RTOL = 2.0 ** -7
# q/k projections at QK_GAIN / sqrt(d) (K3: q, k ~ N(0, QK_GAIN^2)) give
# scores with a standard deviation of about QK_GAIN^2 = 2.25, so each query
# weighs a few keys (about T' e^-5) instead of averaging all of them; x has a
# per-channel mean and a per-row scale, so LayerNorm changes it
QK_GAIN = 1.5
# CUDA bf16 vs CPU fp32 encoder output, relative Frobenius error: bf16 keeps
# 8 bits of mantissa (~0.4% per rounding) and every layer ends in a LayerNorm,
# so 16 layers stay well inside 10%
ENCODER_RTOL = 0.1
# One train step, CUDA bf16 vs CPU fp32 on the same weights and batch, at 2
# layers.  The loss is a mean of fp32 log-probabilities over bf16 encodings
# that are within ~1% of the fp32 ones: 2%.  A gradient passes through every
# bf16 rounding of the forward and again through those of the backward (P and
# ds rounded in K4/K6, bf16 matmul outputs), each ~0.4%, and sums over
# B x T' positions whose errors partly add: a leaf group's relative Frobenius
# error stays inside 10%, the encoder's own limit
TRAIN_LOSS_RTOL = 0.02
TRAIN_GRAD_RTOL = 0.1
# the plain backward on fp32 inputs (its rounding points are then no-ops)
# against autograd through the plain forward: the same math in another order
PLAIN_BWD_REL = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): bf16 tensor cores, fp32
# outside them, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

D_MODEL, N_HEADS, D_HEAD = 768, 16, 48
# registers a thread of K3's kernel, of P1/P2's, P4's and P6/P7's core
# instances and of P9's and P10/P12's walks as ptxas (CUDA 12.8) reports
# them for sm_90a,
# which the kernels added beside them must leave as they are (no spills is
# checked for every `wgmma` kernel)
KEPT_REGISTERS = {"sdpa_kernel": 98, "ws_conv_kernel<256, 2, true>": 168,
                  "ws_conv_kernel<256, 1, true>": 168,
                  "ws_conv_kernel<128, 1, true>": 168,
                  "ws_conv_kernel<128, 1, false>": 168,
                  "sdpa_groups_ws_kernel": 168, "ffn_ws_kernel<1>": 168,
                  "ffn_ws_kernel<2>": 168,
                  **{k: 168 for k in cuda_lib.ATTN_FOLD_WS_KERNELS
                     + cuda_lib.HEADS_WS_KERNELS}}
# the inference main path of K3: a clip past the encoder's fold bound
# (_MAX_FOLD_T = 3000 frames at 25 a second)
K3_SECONDS, K3_T = 125.0, 3125

# device-time groups of the main-path profile, matched in this order
PROFILE_GROUPS = (
    # sdpa_kernel matches K5's relpos_sdpa_kernel too
    # and the backward kernels: sdpa_bwd_*, relpos_bwd_*
    ("attention kernels (csrc)",
     r"sdpa_kernel|ln_rope_kernel|qkv_kernel|out_proj_kernel|bwd_dq_kernel|"
     r"bwd_dkv_kernel"),
    # PyTorch's own depthwise kernels (conv_depthwise2d_*), not cuDNN
    ("depthwise conv", r"conv_depthwise"),
    ("convolution", r"conv_|convolve|cudnn|winograd|fprop"),
    ("GEMM (cuBLAS)", r"nvjet|gemm|xmma|cutlass|cublas"),
    ("host-device copies", r"^Memcpy|^Memset"),
    ("other (elementwise, reductions)", r""),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_kernels(prof) -> dict:
    """{name: (device us, count)} of a profile's device activities (kernels,
    copies, sets), from the profiler's raw events: ``key_averages`` builds
    an event tree at ~100 us an event, which the 10^5-10^6 kernels of an
    RNNT call turn into minutes.  Spans mirrored on the device timeline
    (user annotations, the optimizer's range) are not activities."""
    out = {}
    for evt in prof.profiler.kineto_results.events():
        if (evt.device_type() != torch.autograd.DeviceType.CUDA
                or evt.is_user_annotation()
                or evt.name().startswith("Optimizer.")):
            continue
        us, n = out.get(evt.name(), (0.0, 0))
        out[evt.name()] = (us + evt.duration_ns() / 1e3, n + 1)
    return out


# the profiler has dropped the device activities at the start of a window
# (the first call's kernels, most of the calls', or all); a window opens
# with MARK_LEAD long spin kernels that take the loss, and every call is
# fenced by short ones on the current stream, so that a reading counts
# whole calls only
MARK, MARK_LEAD, MARK_LEAD_CYCLES = "spin_kernel", 8, 50_000


def window_kernels(prof) -> tuple:
    """(calls, {name: (device us, count)}) of a marked window: the calls
    whose fences both came through (marker intervals that hold any device
    activity, after the first marker recorded), and the device activities
    in them."""
    events = sorted(
        (evt.start_ns(), evt.name(), evt.duration_ns())
        for evt in prof.profiler.kineto_results.events()
        if evt.device_type() == torch.autograd.DeviceType.CUDA
        and not evt.is_user_annotation()
        and not evt.name().startswith("Optimizer."))
    marks = [i for i, (_, name, _) in enumerate(events) if MARK in name]
    calls, out = 0, {}
    for lo, hi in zip(marks, marks[1:]):
        calls += hi > lo + 1
        for _, name, ns in events[lo + 1:hi]:
            us, n = out.get(name, (0.0, 0))
            out[name] = (us + ns / 1e3, n + 1)
    return calls, out


def device_ms(fn, calls: int = 10, attempts: int = 4) -> dict:
    """Device time per call of ``fn`` (whose work runs on the current
    stream) by kernel name, from ``calls`` calls under ``torch.profiler``
    (after one unprofiled call), fenced by marker kernels
    (``window_kernels``), over the calls that the profile kept whole.  A
    profile that kept fewer than half of the calls, or a kernel a number of
    times that is no multiple of them, is taken again, up to ``attempts``
    profiles in all; raises if none was whole, so that no partial profile
    reaches a reading."""
    fn()
    torch.cuda.synchronize()
    got, odd = 0, {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(MARK_LEAD):
                torch.cuda._sleep(MARK_LEAD_CYCLES)
            for _ in range(calls):
                torch.cuda._sleep(0)
                fn()
            torch.cuda._sleep(0)
            torch.cuda.synchronize()
        got, kernels = window_kernels(prof)
        odd = {name[:60]: n for name, (_, n) in kernels.items()
               if got and n % got}
        if 2 * got >= calls and not odd:
            return {name: us / 1e3 / got
                    for name, (us, _) in kernels.items() if us > 0}
        print(f"  a profile kept {got} of {calls} calls whole"
              + (f", kernels {odd} times" if odd else "") + ": taken again",
              flush=True)
    raise AssertionError(f"no whole profile in {attempts} (the last: {got} "
                         f"of {calls} calls, {odd})")


def window_ms(fn, calls: int = 1, attempts: int = 3) -> dict:
    """Device time per call of ``fn`` by kernel name, every device activity
    of a window of ``calls`` calls under ``torch.profiler`` (after one
    unprofiled call), unfenced: for the model paths' loops, whose graph
    captures and host reads put work on other streams.  A profile that
    recorded no device activity is taken again, up to ``attempts`` times;
    raises if none did."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {name: us / 1e3 / calls
               for name, (us, _) in device_kernels(prof).items() if us > 0}
        if out:
            return out
    raise AssertionError("the profiler recorded no device time")


def bound(n_bytes: float, tensor_ops: float, fp32_ops: float):
    """(least ms, "bytes" | "operations") for the work on this card."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = tensor_ops / PEAK_BF16 + fp32_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def ragged_valid(b: int, t: int, dev) -> torch.Tensor:
    lens = torch.tensor([t - 7 - (i * t) // (2 * b) for i in range(b)],
                        device=dev)
    return torch.arange(t, device=dev)[None, :] < lens[:, None]


def synth_wav(seconds: float, rng) -> np.ndarray:
    """A few harmonics under a syllable-rate envelope, plus noise."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    f0 = rng.uniform(100, 220)
    sig = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4 * t + rng.uniform(0, 6)))
    return (0.1 * sig * env + 0.01 * rng.standard_normal(t.shape)).astype(
        np.float32)


def distance(got, ref, valid, time_dim: int, residual=None):
    """(max |got - ref|, max (|got - ref| - KERNEL_RTOL |ref|) / RMS) over
    the valid query rows, where RMS is that of ref's attention output."""
    shape = [1] * got.dim()
    shape[0], shape[time_dim] = valid.shape
    rows = valid.reshape(shape).expand_as(got)
    ref = ref.float()[rows]
    attn = ref if residual is None else ref - residual.float()[rows]
    rms = float(attn.pow(2).mean().sqrt())
    err = (got.float()[rows] - ref).abs()
    return float(err.max()), max(
        0.0, float((err - KERNEL_RTOL * ref.abs()).max()) / rms)


def check_kernel(name: str, got, ref, valid, time_dim: int, faults,
                 residual=None):
    """Raise unless ``got`` is within the limit of ``ref`` and each planted
    fault ``(label, fn)`` lands outside it; returns (max_abs_err, in RMS)."""
    err, rel = distance(got, ref, valid, time_dim, residual)
    if not rel <= KERNEL_REL:
        raise AssertionError(f"{name}: max error {rel:.4f} x RMS over "
                             f"{KERNEL_REL} x RMS + |ref|/128 (max_abs_err {err})")
    for label, fn in faults:
        _, fault_rel = distance(fn(), ref, valid, time_dim, residual)
        print(f"  {name} planted fault, {label}: {fault_rel:.4f} x RMS "
              f"(limit {KERNEL_REL})", flush=True)
        if not fault_rel > KERNEL_REL:
            raise AssertionError(f"{name}: the check misses the fault {label}")
    return err, rel


def attention_params(gen, dev):
    """(attention module parameters, its LayerNorm's), fp32 on ``dev``."""
    def lin(gain):
        return {"w": torch.randn(D_MODEL, D_MODEL, generator=gen)
                * (gain / D_MODEL ** 0.5),
                "b": 0.1 * torch.randn(D_MODEL, generator=gen)}
    attn = {"linear_q": lin(QK_GAIN), "linear_k": lin(QK_GAIN),
            "linear_v": lin(1.0), "linear_out": lin(1.0)}
    ln = {"scale": 1.0 + 0.1 * torch.randn(D_MODEL, generator=gen),
          "bias": 0.1 * torch.randn(D_MODEL, generator=gen)}
    attn = {n: {k: v.to(dev) for k, v in p.items()} for n, p in attn.items()}
    return attn, {k: v.to(dev) for k, v in ln.items()}


def attention_input(gen, b: int, t: int, dev) -> torch.Tensor:
    """[B, T, D] bf16 with a per-channel mean and a per-row scale in
    [0.5, 2], so that LayerNorm changes it."""
    mean = 0.5 * torch.randn(D_MODEL, generator=gen)
    scale = 0.5 + 1.5 * torch.rand(b, t, 1, generator=gen)
    x = mean + scale * torch.randn(b, t, D_MODEL, generator=gen)
    return x.to(dev, torch.bfloat16)


# lse is fp32 on both sides, from the same bf16 inputs: another order of
# accumulation and the kernel's exp2/log2 approximations (relative 2^-22)
LSE_ATOL = 1e-3
# K5's lse: the share of rows held to LSE_ATOL (relpos_kernel_phase says why
# not all)
LSE_SHARE = 0.999


def shaped_row(readings: dict, main) -> dict:
    """The JSON row of a kernel timed at several shapes: the numbers at
    ``main`` (b, t), the others under ``also``."""
    def named(shape):
        return dict(readings[shape], shape=f"B {shape[0]}, T' {shape[1]}")
    return dict(named(main), also=[named(s) for s in readings if s != main])


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version; returns the JSON rows.  The
    planted faults run at the shape the JSON row reports."""
    gen = torch.Generator().manual_seed(0)
    rows = {}
    k3 = {}
    # K3 at T' = 500 (B 1 and 16, the shape inside K1 and a train step), at
    # T' = 1125 and at the inference main path's T' = 3125 (B 1)
    for b, t in ((1, 500), (16, 500), (1, 1125), (1, K3_T)):
        q, k, v = (torch.randn(b, N_HEADS, t, D_HEAD, generator=gen)
                   * gain for gain in (QK_GAIN, QK_GAIN, 1.0))
        q, k, v = (a.to(dev, torch.bfloat16) for a in (q, k, v))
        valid = ragged_valid(b, t, dev)
        got = fa.fused_mha(q, k, v, valid)
        ref, lse_ref = fa.mha_plain(q, k, v, valid, return_lse=True)
        out2, lse = fa._mha_forward(q, k, v, valid, want_lse=True)
        lse_err = float((lse - lse_ref).abs().max())
        if not (torch.equal(out2, got) and lse_err <= LSE_ATOL):
            raise AssertionError(f"K3 B={b} T'={t}: lse off by {lse_err} "
                                 f"(limit {LSE_ATOL}) or the output changed")
        faults = () if (b, t) != (1, K3_T) else (
            ("key mask ignored",
             lambda: fa.fused_mha(q, k, v, torch.ones_like(valid))),
            ("1/sqrt(d_h) missing",
             lambda: fa.fused_mha(q * math.sqrt(D_HEAD), k, v, valid)),
            ("q zeroed",
             lambda: fa.fused_mha(torch.zeros_like(q), k, v, valid)))
        err, rel = check_kernel(f"K3 B={b} T'={t}", got, ref, valid, 2, faults)
        ms = time_ms(lambda: fa.fused_mha(q, k, v, valid))
        lse_ms = time_ms(lambda: fa._mha_forward(q, k, v, valid,
                                                 want_lse=True))
        plain_ms = time_ms(lambda: fa.mha_plain(q, k, v, valid), iters=5)
        mask4 = valid[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4))
        scores = b * N_HEADS * t * t
        bms, by = bound(4 * b * N_HEADS * t * D_HEAD * 2 + b * t,
                        4 * scores * D_HEAD, 4 * scores)
        print(f"K3 fused_mha B={b} T'={t}: max_abs_err {err:.3e}, "
              f"{rel:.4f} x RMS (limit {KERNEL_REL}), lse within {lse_err:.2e} "
              f"(limit {LSE_ATOL}); kernel {ms:.4f} ms ({lse_ms:.4f} writing "
              f"lse), plain {plain_ms:.4f} ms, F.sdpa {lib_ms:.4f} ms, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        k3[(b, t)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=lib_ms, max_abs_err=err)
    rows["K3"] = shaped_row(k3, (1, K3_T))

    attn, ln = attention_params(gen, dev)
    w = fa.prepare_folded_weights(attn, ln, N_HEADS, torch.bfloat16)
    rows.update(fold_kernel_phase(gen, dev, w))
    fold_stage_phase(gen, dev, w)
    dispatch_phase(gen, dev, w, attn, ln)
    rows["K5"] = relpos_kernel_phase(gen, dev)
    return rows


# K1 and K2: the shapes timed (B, T'); the planted faults and the JSON rows
# at K2's batch 1 and K1's batch 16 (the two main-path calls)
FOLD_SHAPES = ((1, 500), (8, 500), (16, 500), (32, 500), (2, 1024))
FOLD_MAIN = {"K2": (1, 500), "K1": (16, 500)}


def rope_tables(t: int, dev):
    cos, sin = rotary_tables(t, D_HEAD, 5000.0)
    return torch.from_numpy(cos).to(dev), torch.from_numpy(sin).to(dev)


def fold_bound(b: int, t: int, lnres: bool):
    """K1/K2's least time: x in, the output out, the four weights, biases
    and tables once; the four products and the scores' fp32 work."""
    m, scores = b * t, b * N_HEADS * t * t
    n_bytes = (2 * m * D_MODEL * 2 + 4 * D_MODEL * D_MODEL * 2
               + 6 * D_MODEL * 4 + 2 * t * D_HEAD * 4 + b * t)
    fp32_ops = 4 * scores + 3 * m * D_MODEL + (8 * m * D_MODEL
                                               if lnres else 0)
    return bound(n_bytes, 8 * m * D_MODEL * D_MODEL + 4 * scores * D_HEAD,
                 fp32_ops)


def fold_kernel_phase(gen, dev, w) -> dict:
    """K2 and K1 against their plain versions at FOLD_SHAPES; times by CUDA
    events (at batch 1 these read the wrapper's host work) and by the
    profile's kernel sum."""
    root_dh = math.sqrt(D_HEAD)
    w_unscaled = dataclasses.replace(
        w, wq=(w.wq.float() * root_dh).to(w.wq.dtype), bq=w.bq * root_dh)
    w_q0 = dataclasses.replace(w, wq=torch.zeros_like(w.wq),
                               bq=torch.zeros_like(w.bq))
    w_v_is_k = dataclasses.replace(w, wv=w.wk, bv=w.bk)
    rows = {}
    for name, wrapper, plain, lnres in (
            ("K2", fa.folded_rotary_attention,
             fa.folded_rotary_attention_plain, False),
            ("K1", fa.folded_rotary_attention_lnres,
             fa.folded_rotary_attention_lnres_plain, True)):
        readings = {}
        for b, t in FOLD_SHAPES:
            cos, sin = rope_tables(t, dev)
            x = attention_input(gen, b, t, dev)
            valid = ragged_valid(b, t, dev)
            got = wrapper(w, x, cos, sin, valid, N_HEADS)
            ref = plain(w, x, cos, sin, valid, N_HEADS)
            repeat = all(torch.equal(wrapper(w, x, cos, sin, valid, N_HEADS),
                                     got) for _ in range(3))
            if not repeat:
                raise AssertionError(f"{name} B={b} T'={t}: three calls did "
                                     f"not give the same bits")
            faults = () if (b, t) != FOLD_MAIN[name] else (
                ("RoPE sign flipped",
                 lambda: wrapper(w, x, cos, -sin, valid, N_HEADS)),
                ("key mask ignored",
                 lambda: wrapper(w, x, cos, sin, torch.ones_like(valid),
                                 N_HEADS)),
                ("1/sqrt(d_h) missing",
                 lambda: wrapper(w_unscaled, x, cos, sin, valid, N_HEADS)),
                ("q zeroed", lambda: wrapper(w_q0, x, cos, sin, valid, N_HEADS)),
                ("Wv swapped for Wk",
                 lambda: wrapper(w_v_is_k, x, cos, sin, valid, N_HEADS)),
            ) + (((
                "LayerNorm skipped", lambda: x + fa.folded_rotary_attention(
                    w, x, cos, sin, valid, N_HEADS)),
                ("residual left out", lambda: fa.folded_rotary_attention(
                    w, fa.ln_rope_plain(x, cos, sin, N_HEADS, w.ln_scale,
                                        w.ln_bias)[0],
                    cos, sin, valid, N_HEADS))) if lnres else ())
            err, rel = check_kernel(f"{name} B={b} T'={t}", got, ref, valid, 1,
                                    faults, residual=x if lnres else None)
            ms = time_ms(lambda: wrapper(w, x, cos, sin, valid, N_HEADS))
            dev_ms = sum(device_ms(
                lambda: wrapper(w, x, cos, sin, valid, N_HEADS)).values())
            plain_ms = time_ms(lambda: plain(w, x, cos, sin, valid, N_HEADS),
                               iters=5)
            bms, by = fold_bound(b, t, lnres)
            print(f"{name} {wrapper.__name__} B={b} T'={t}: max_abs_err "
                  f"{err:.3e}, {rel:.4f} x RMS (limit {KERNEL_REL}), three "
                  f"calls bit-equal; kernel {ms:.4f} ms (events), "
                  f"{dev_ms:.4f} ms (profile kernel sum), plain "
                  f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
            readings[(b, t)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                    bound_ms=bms, bound_by=by, library_ms=None,
                                    max_abs_err=err)
        rows[name] = shaped_row(readings, FOLD_MAIN[name])
    return rows


# the dispatch A/B: K1 against LN + K2 + add at T' 500 over these batches;
# K2 against the composed path at the long T' over these batches
DISPATCH_SHORT = (500, (1, 2, 4, 8, 16, 32))
DISPATCH_LONG = ((1024, 1125, 1500, 2000, 3000), (1, 8))

# the four stages of K1/K2 by kernel name, in launch order
FOLD_STAGES = (("row pass", "ln_rope_kernel"), ("QKV GEMM", "qkv_kernel"),
               ("K3 SDPA", "sdpa_kernel"), ("output GEMM", "out_proj_kernel"))


def fold_stage_phase(gen, dev, w) -> None:
    """K1 at B 16 and K2 at B 1 (T' 500), one stage per kernel: its device
    time (profile), its own bound and, for the GEMMs, the time of the same
    products as F.linear calls (three [M, 768] x [768, 768] for QKV, one for
    the output) as the library's yardstick."""
    for name, wrapper, lnres in (
            ("K1", fa.folded_rotary_attention_lnres, True),
            ("K2", fa.folded_rotary_attention, False)):
        b, t = FOLD_MAIN[name]
        cos, sin = rope_tables(t, dev)
        m, scores = b * t, b * N_HEADS * t * t
        x = attention_input(gen, b, t, dev)
        valid = ragged_valid(b, t, dev)
        times = device_ms(lambda: wrapper(w, x, cos, sin, valid, N_HEADS))
        act = m * D_MODEL * 2
        bounds = {
            "row pass": bound((3 if lnres else 2) * act + 2 * t * D_HEAD * 4,
                              0, (12 if lnres else 4) * m * D_MODEL),
            "QKV GEMM": bound(5 * act + 3 * D_MODEL * D_MODEL * 2,
                              6 * m * D_MODEL * D_MODEL, 0),
            "K3 SDPA": bound(4 * act + b * t, 4 * scores * D_HEAD, 4 * scores),
            "output GEMM": bound((3 if lnres else 2) * act
                                 + D_MODEL * D_MODEL * 2,
                                 2 * m * D_MODEL * D_MODEL, 0)}
        a = x.reshape(m, D_MODEL)
        wt = w.wq.t()
        lib = {"QKV GEMM": sum(device_ms(lambda: [
                   F.linear(a, wt), F.linear(a, wt), F.linear(a, wt)]).values()),
               "output GEMM": sum(device_ms(lambda: F.linear(a, wt)).values())}
        parts = []
        for stage, kernel in FOLD_STAGES:
            ms = sum(v for k, v in times.items() if kernel in k)
            bms, by = bounds[stage]
            parts.append(f"{stage} {ms:.4f} ms (bound {bms:.4f}, {by}"
                         + (f"; F.linear {lib[stage]:.4f}" if stage in lib
                            else "") + ")")
        print(f"{name} stages B={b} T'={t}: " + ", ".join(parts)
              + f"; kernel sum {sum(times.values()):.4f} ms", flush=True)


def dispatch_phase(gen, dev, w, attn, ln) -> None:
    """The attention sub-block per layer two ways, device time per call
    (profile) and CUDA events: at T' 500, K1 against LN + K2 + the residual
    add (the encoder's _LNRES_MIN_BATCH); at T' 1024 to 3000, K2 against
    the composed path, F.linear projections around K3 (_MAX_FOLD_T)."""
    attn16 = {n: {k: v.to(torch.bfloat16) for k, v in p.items()}
              for n, p in attn.items()}

    def both(fn):
        return sum(device_ms(fn).values()), time_ms(fn)

    t, batches = DISPATCH_SHORT
    cos, sin = rope_tables(t, dev)
    for b in batches:
        x = attention_input(gen, b, t, dev)
        valid = ragged_valid(b, t, dev)
        k1 = both(lambda: fa.folded_rotary_attention_lnres(
            w, x, cos, sin, valid, N_HEADS))
        k2 = both(lambda: x + fa.folded_rotary_attention(
            w, layer_norm(ln, x), cos, sin, valid, N_HEADS))
        print(f"dispatch T'={t} B={b}: K1 {k1[0]:.4f} ms device / "
              f"{k1[1]:.4f} events; LN + K2 + add {k2[0]:.4f} / {k2[1]:.4f}; "
              f"K1 / (LN + K2 + add) device {k1[0] / k2[0]:.3f}", flush=True)
    for t in DISPATCH_LONG[0]:
        cos, sin = rope_tables(t, dev)
        for b in DISPATCH_LONG[1]:
            y = attention_input(gen, b, t, dev)
            valid = ragged_valid(b, t, dev)
            k2 = both(lambda: fa.folded_rotary_attention(
                w, y, cos, sin, valid, N_HEADS))
            comp = both(lambda: rotary_mha(attn16, y, cos, sin, valid,
                                           N_HEADS, use_fused=True))
            print(f"dispatch T'={t} B={b}: K2 {k2[0]:.4f} ms device / "
                  f"{k2[1]:.4f} events; composed (F.linear + K3) "
                  f"{comp[0]:.4f} / {comp[1]:.4f}; K2 / composed device "
                  f"{k2[0] / comp[0]:.3f}", flush=True)


def relpos_kernel_phase(gen, dev) -> dict:
    """K5 at the v2 main path's T' = 501 (B 1 and 16) and at T' = 1126
    (B 1, a 45 s clip); the faults and the JSON row at B 16."""
    k5 = {}
    for b, t in ((1, 501), (16, 501), (1, 1126)):
        def draw(shape, gain):
            return (torch.randn(shape, generator=gen) * gain).to(
                dev, torch.bfloat16)
        # q_u.k and the positional term of one size (both at QK_GAIN), q_u
        # and q_v drawn apart so that a swap shows
        q_u, k, q_v = (draw((b, N_HEADS, t, D_HEAD), QK_GAIN)
                       for _ in range(3))
        v = draw((b, N_HEADS, t, D_HEAD), 1.0)
        p_heads = draw((N_HEADS, 2 * t - 1, D_HEAD), QK_GAIN)
        valid = ragged_valid(b, t, dev)
        args = (q_u, k, v, q_v, p_heads, valid)
        got = fa.fused_relpos_mha(*args)
        ref, lse_ref = fa.relpos_mha_plain(*args, return_lse=True)
        out2, lse = fa._relpos_forward(*args, want_lse=True)
        # The kernel and the plain version round the same fp32 positional
        # product, summed in two orders, to bf16: where they round apart a
        # score moves by one bf16 step of the bias, and the row's lse by that
        # times the key's probability.  Every row within LSE_ATOL plus one
        # step at the largest bias, LSE_SHARE of the rows within LSE_ATOL.
        lse_diff = (lse - lse_ref).abs()
        lse_err = float(lse_diff.max())
        lse_share = float((lse_diff <= LSE_ATOL).float().mean())
        step = (float(fa._relpos_bias(q_v, p_heads).abs().max()) * 2.0 ** -7
                / math.sqrt(D_HEAD))
        if not (torch.equal(out2, got) and lse_err <= LSE_ATOL + step
                and lse_share >= LSE_SHARE):
            raise AssertionError(
                f"K5 B={b} T'={t}: lse off by {lse_err} (limit {LSE_ATOL} + "
                f"{step}), within {LSE_ATOL} on {lse_share} of the rows "
                f"(limit {LSE_SHARE}), or the output changed")
        root_dh = math.sqrt(D_HEAD)
        faults = () if (b, t) != (16, 501) else (
            ("key mask ignored", lambda: fa.fused_relpos_mha(
                q_u, k, v, q_v, p_heads, torch.ones_like(valid))),
            ("1/sqrt(d_h) missing", lambda: fa.fused_relpos_mha(
                q_u * root_dh, k, v, q_v * root_dh, p_heads, valid)),
            ("q_u/q_v swapped", lambda: fa.fused_relpos_mha(
                q_v, k, v, q_u, p_heads, valid)),
            ("shift reversed", lambda: fa.fused_relpos_mha(
                q_u, k, v, q_v, p_heads.flip(1).contiguous(), valid)),
            ("positional term dropped", lambda: fa.fused_relpos_mha(
                q_u, k, v, q_v, torch.zeros_like(p_heads), valid)))
        err, rel = check_kernel(f"K5 B={b} T'={t}", got, ref, valid, 2, faults)
        ms = time_ms(lambda: fa.fused_relpos_mha(*args))
        lse_ms = time_ms(lambda: fa._relpos_forward(*args, want_lse=True))
        plain_ms = time_ms(lambda: fa.relpos_mha_plain(*args), iters=5)
        scores = b * N_HEADS * t * t
        bms, by = bound(
            (5 * b * N_HEADS * t * D_HEAD + N_HEADS * (2 * t - 1) * D_HEAD) * 2
            + b * t, 6 * scores * D_HEAD, 5 * scores)
        print(f"K5 fused_relpos_mha B={b} T'={t}: max_abs_err {err:.3e}, "
              f"{rel:.4f} x RMS (limit {KERNEL_REL}), lse within {lse_err:.2e} "
              f"(limit {LSE_ATOL} + a bf16 step of the bias, {step:.2e}) and "
              f"within {LSE_ATOL} on {lse_share:.5f} of the rows (limit "
              f"{LSE_SHARE}); kernel {ms:.4f} ms ({lse_ms:.4f} writing lse), "
              f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
        k5[(b, t)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=None, max_abs_err=err)
        if (b, t) == (16, 501):
            # the three readings: fenced card sum, graph replays, events
            three, _ = three_times(lambda: fa.fused_relpos_mha(*args), got)
            print(f"  K5 B={b} T'={t}: {times_text(three)}", flush=True)
            k5[(b, t)].update(sum_ms=three["sum_ms"],
                              graph_ms=three["graph_ms"])
    return shaped_row(k5, (16, 501))


# ---------------------------------------------------------------------------
# The backward kernels
# ---------------------------------------------------------------------------

def bwd_inputs(gen, b: int, t: int, dev, relpos: bool):
    """Peaked inputs as the forward checks use, and a ``do`` that is zero on
    padded query rows, as in a train step."""
    def draw(shape, gain):
        return (torch.randn(shape, generator=gen) * gain).to(
            dev, torch.bfloat16)

    shape = (b, N_HEADS, t, D_HEAD)
    valid = ragged_valid(b, t, dev)
    q, k = draw(shape, QK_GAIN), draw(shape, QK_GAIN)
    v = draw(shape, 1.0)
    do = draw(shape, 1.0) * valid[:, None, :, None]
    if not relpos:
        return (q, k, v, do, valid)
    q_v = draw(shape, QK_GAIN)
    p_heads = draw((N_HEADS, 2 * t - 1, D_HEAD), QK_GAIN)
    return (q, k, v, q_v, p_heads, do, valid)


def faulty_backward(args, fault: str, relpos: bool):
    """The attention backward in fp32 with one fault planted: what a kernel
    with that fault would return, up to rounding."""
    if relpos:
        q, k, v, q_v, p, do, valid = args
        q_v, p = q_v.float(), p.float()
    else:
        q, k, v, do, valid = args
    q, k, v, do = (x.float() for x in (q, k, v, do))
    b, h, t, d = q.shape
    scale = 1.0 / math.sqrt(d)
    with full_fp32():
        s = q @ k.transpose(-1, -2)
        if relpos:
            ar = torch.arange(t, device=q.device)
            idx = ((t - 1) - ar[:, None] + ar[None, :]).expand(b, h, t, t)
            if fault != "P without the bias":
                raw = q_v @ p.transpose(-1, -2)
                s = s + raw.gather(-1, idx).bfloat16().float()
        s = s * scale
        if fault != "key mask ignored":
            s = s + (valid[:, None, None, :].float() - 1.0) * 1e9
        prob = torch.softmax(s, dim=-1)
        dv = prob.transpose(-1, -2) @ do
        dprob = do @ v.transpose(-1, -2)
        row = (dprob * prob).sum(-1, keepdim=True)
        if fault == "rowsum term dropped":
            row = torch.zeros_like(row)
        ds = prob * (dprob - row)
        if fault != "scale missing from ds":
            ds = ds * scale
        out = [ds @ k, ds.transpose(-1, -2) @ q, dv]
        if relpos:
            if fault == "unshear reversed":
                idx = (2 * t - 2) - idx
            d_raw = ds.new_zeros((b, h, t, 2 * t - 1)).scatter_(-1, idx, ds)
            out.append(d_raw @ p)
            if fault == "dp from the last batch element":
                d_raw, q_v = d_raw[-1:], q_v[-1:]
            out.append(torch.einsum("bhtp,bhtd->hpd", d_raw, q_v))
    return out


def grad_distances(names, got, ref, valid):
    """Per gradient (max_abs_err, error in that gradient's RMS), over the
    valid rows (query rows for dq*, key rows for dk and dv, all of dp)."""
    out = {}
    for name, g, r in zip(names, got, ref):
        if name == "dp":
            g, r = g[None], r[None]
            rows = torch.ones((1, g.shape[2]), dtype=torch.bool,
                              device=g.device)
        else:
            rows = valid
        out[name] = distance(g, r, rows, 2)
    return out


# the SDPA backend K4's library yardstick is pinned to: the one PyTorch
# picks unpinned for K4's inputs on an H100 (a boolean key mask, d_h 48,
# bf16; flash takes no mask), whose backward is also the fastest of the
# three that take them
SDPA_YARDSTICK = "CUDNN_ATTENTION"
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def sdpa_backward_yardstick(label: str, leaves, mask4, do) -> float:
    """K4's library time: SDPA's backward alone (the forward's graph kept
    and its gradient taken again) by CUDA events, on the backend
    SDPA_YARDSTICK pinned with ``sdpa_kernel``.  Prints the backend that
    PyTorch picks unpinned (its kernels' names) and each backend's backward
    by events and by the profile's kernel sum, beside the old reading
    (forward + backward less forward, both by events with the host in the
    loop)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def fwd():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask4)

    def both():
        torch.autograd.grad(fwd(), leaves, do)

    unpinned = sorted(device_ms(both))
    readings = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out = fwd()
                both_less_fwd = time_ms(both) - time_ms(fwd)
            bwd = lambda: torch.autograd.grad(out, leaves, do,
                                              retain_graph=True)
            split = device_ms(bwd)
            readings[name] = dict(events=time_ms(bwd),
                                  card=sum(split.values()),
                                  both_less_fwd=both_less_fwd,
                                  kernels=[n[:60] for n in sorted(split)][:3])
            del out
        except RuntimeError as e:     # a backend that refuses these inputs
            readings[name] = {"refused": str(e).splitlines()[0][:120]}
    print(f"  {label} SDPA backward yardstick: unpinned kernels "
          f"{[n[:60] for n in unpinned]}; by backend {json.dumps(readings)};"
          f" pinned to {SDPA_YARDSTICK}", flush=True)
    return readings[SDPA_YARDSTICK]["events"]


def bwd_kernel_phase(gen, dev, relpos: bool) -> dict:
    key = "K6" if relpos else "K4"
    kernel, plain, fwd_kernel, fwd_plain = (
        (fa.relpos_mha_bwd, fa.relpos_mha_bwd_plain, fa._relpos_forward,
         fa.relpos_mha_plain) if relpos else
        (fa.mha_bwd, fa.mha_bwd_plain, fa._mha_forward, fa.mha_plain))
    names = (("dq_u", "dk", "dv", "dq_v", "dp") if relpos
             else ("dq", "dk", "dv"))
    # dp's sum over the batch uses atomics; the others give the same bits
    n_exact = 4 if relpos else 3
    exact = ", ".join(names[:n_exact])
    faults = ("key mask ignored", "scale missing from ds",
              "rowsum term dropped") + ((
                  "P without the bias", "unshear reversed",
                  "dp from the last batch element") if relpos else ())
    readings = {}
    t_train = 501 if relpos else 500   # the JSON row: the training shape
    for b, t in ((16, t_train), (8, 750), (2, 1000)):
        args = bwd_inputs(gen, b, t, dev, relpos)
        valid = args[-1]
        fwd_args = args[:-2] + (valid,)
        # the backward starts from what the forward saved: the kernel from
        # the forward kernel's own (out, lse), the plain backward from the
        # plain forward's
        pair = fwd_kernel(*fwd_args, want_lse=True)
        plain_pair = fwd_plain(*fwd_args, return_lse=True)
        got = kernel(*args, *pair)
        torch.cuda.synchronize()
        ref = plain(*args, *plain_pair)
        dist = grad_distances(names, got, ref, valid)
        worst = max(rel for _, rel in dist.values())
        err = max(e for e, _ in dist.values())
        print(f"{key} {kernel.__name__} B={b} T'={t}: " + ", ".join(
            f"{n} {rel:.4f} x RMS (max_abs_err {e:.3e})"
            for n, (e, rel) in dist.items()) + f" (limit {KERNEL_REL})",
            flush=True)
        if not worst <= KERNEL_REL:
            raise AssertionError(f"{key} B={b} T'={t}: {dist}")
        # without the pair the backward runs the forward kernel for it first:
        # the same bits; and the plain backward's other form (row statistics
        # recomputed, D = rowsum(dP P), as the Pallas kernel) stays close
        unsaved = kernel(*args)
        if not all(torch.equal(a, g) for a, g in
                   zip(unsaved[:n_exact], got[:n_exact])):
            raise AssertionError(f"{key}: without the saved pair the "
                                 f"gradients differ")
        odist = grad_distances(names, unsaved, plain(*args), valid)
        oworst = max(rel for _, rel in odist.values())
        print(f"  {key} without the saved pair: {exact} bit-equal; against "
              f"the plain backward that recomputes the row statistics: worst "
              f"{oworst:.4f} x RMS (limit {KERNEL_REL})", flush=True)
        if not oworst <= KERNEL_REL:
            raise AssertionError(f"{key} B={b} T'={t}: {odist}")

        # the plain backward itself, in both forms, on fp32 inputs, against
        # autograd through the plain forward
        wide = [x.float() for x in args[:-1]]
        do32 = wide.pop(-1)
        leaves = [x.clone().requires_grad_() for x in wide]
        auto = torch.autograd.grad(fwd_plain(*leaves, valid), leaves, do32)
        pdist = grad_distances(names, plain(*wide, do32, valid), auto, valid)
        pworst = max(rel for _, rel in pdist.values())
        with torch.no_grad():
            pair32 = fwd_plain(*wide, valid, return_lse=True)
        pdist = grad_distances(
            names, plain(*wide, do32, valid, *pair32), auto, valid)
        pworst = max(pworst, *(rel for _, rel in pdist.values()))
        print(f"  {key} plain backward vs autograd of the plain forward, "
              f"fp32: worst {pworst:.2e} x RMS (limit {PLAIN_BWD_REL})",
              flush=True)
        if not pworst <= PLAIN_BWD_REL:
            raise AssertionError(f"{key} plain backward: {pdist}")
        del leaves, auto, wide, pair32

        if b == 16:
            def must_show(fault, fdist):
                name, (_, rel) = max(fdist.items(), key=lambda kv: kv[1][1])
                print(f"  {key} planted fault, {fault}: {name} {rel:.4f} x "
                      f"RMS (limit {KERNEL_REL})", flush=True)
                if not rel > KERNEL_REL:
                    raise AssertionError(f"{key}: the check misses {fault}")

            # faults in the arithmetic: the kernel against a faulty reference
            for fault in faults:
                must_show(fault, grad_distances(
                    names, got, faulty_backward(args, fault, relpos), valid))
            # faults in what the forward handed over: fed through the inputs
            out_k, lse_k = pair
            must_show("lse of another batch element", grad_distances(
                names, kernel(*args, out_k, lse_k.roll(1, 0).contiguous()),
                ref, valid))
            must_show("D from a zeroed out", grad_distances(
                names, kernel(*args, torch.zeros_like(out_k), lse_k), ref,
                valid))
            again = kernel(*args, *pair)
            same = all(torch.equal(a, g) for a, g in
                       zip(again[:n_exact], got[:n_exact]))
            spread = "" if not relpos else (
                f"; dp differs by at most "
                f"{float((again[4].float() - got[4].float()).abs().max()):.3e}"
                f" (max |dp| {float(got[4].float().abs().max()):.3e})")
            print(f"  {key} two runs: {exact} bit-equal: {same}{spread}",
                  flush=True)
            if not same:
                raise AssertionError(f"{key}: a deterministic output changed "
                                     f"between two runs")
        ms = time_ms(lambda: kernel(*args, *pair))
        unsaved_ms = time_ms(lambda: kernel(*args))
        plain_ms = time_ms(lambda: plain(*args, *plain_pair), iters=5)
        print(f"  {key} B={b} T'={t} without the saved pair (the forward's "
              f"kernel first): {unsaved_ms:.4f} ms", flush=True)
        scores = b * N_HEADS * t * t
        tile = b * N_HEADS * t * D_HEAD * 2
        lse_bytes = b * N_HEADS * t * 4
        if relpos:
            # q_u, k, v, q_v, do, out in, dq_u, dk, dv, dq_v out, the table in
            # and its gradient out, lse, the mask
            table = N_HEADS * (2 * t - 1) * D_HEAD * 2
            bms, by = bound(10 * tile + 2 * table + lse_bytes + b * t,
                            16 * scores * D_HEAD, 10 * scores)
            lib_ms = None
        else:
            # q, k, v, do, out in, dq, dk, dv out, lse, the mask
            bms, by = bound(8 * tile + lse_bytes + b * t,
                            10 * scores * D_HEAD, 8 * scores)
            mask4 = valid[:, None, None, :]
            q, k, v, do = (x for x in args[:4])
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            lib_ms = sdpa_backward_yardstick(f"{key} B={b} T'={t}", leaves,
                                             mask4, do)
        print(f"  {key} B={b} T'={t}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, library "
              f"{'none' if lib_ms is None else format(lib_ms, '.4f') + ' ms'}"
              f", bound {bms:.4f} ms ({by})", flush=True)
        readings[(b, t)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by, library_ms=lib_ms,
                                max_abs_err=err)
        if relpos and b == 16:
            # the three readings: fenced card sum, graph replays, events
            three, _ = three_times(lambda: kernel(*args, *pair), got[0])
            print(f"  {key} B={b} T'={t}: {times_text(three)}", flush=True)
            readings[(b, t)].update(sum_ms=three["sum_ms"],
                                    graph_ms=three["graph_ms"])
    return shaped_row(readings, (16, t_train))


# ---------------------------------------------------------------------------
# The SDPA ablation (P9-P12)
# ---------------------------------------------------------------------------

# the ablation's own shape (the JSON rows) and K3's table shape
ABLATION_SHAPES = ((8, 501), (16, 500))
# label -> (the id of its Pallas probe, the wrapper's name); P9's two labels
# are one wrapper, and its JSON row carries J under "also"
ABLATION = {
    "A_full": ("P12", "full_sdpa"),
    "F_copy_only": ("P12", "copy_sdpa"),
    "B_two_matmuls": ("P12", "scores_only_sdpa"),
    "D_no_max_pass": ("P12", "no_max_sdpa"),
    "E_prescaled_q": ("P12", "prescaled_sdpa"),
    "E2_madd_row": ("P12", "maddrow_sdpa"),
    "G_bf16_softmax": ("P12", "bf16_softmax_sdpa"),
    "I_allheads_cell": ("P9", "allheads_sdpa"),
    "J_4heads_cell": ("P9", "allheads_sdpa"),
    "K_identity_maps": ("P10", "identity_maps_sdpa"),
    "H_packed_lane_slice": ("P11", "packed_sdpa"),
}
# the `pallas_call` of each probe in benchmarks/sdpa_ablation.py
ABLATION_REPLACES = {"P12": 258, "P9": 186, "P10": 212, "P11": 235}
# P9's labels: heads a cell
P9_CELLS = {"I_allheads_cell": N_HEADS, "J_4heads_cell": 4}
# P12's computing bodies and P10, on the per-head walk's redesign (the copy
# keeps its kernel); the first two timed against their kept kernels in
# turns, the others' kept kernels by the fenced kernel sum at the first shape
HEADS_WS_LABELS = ("A_full", "K_identity_maps", "B_two_matmuls",
                   "D_no_max_pass", "E_prescaled_q", "E2_madd_row",
                   "G_bf16_softmax")
HEADS_WS_AB = HEADS_WS_LABELS[:2]
# P11: on the per-head walk's packed instance, timed against its kept kernel
# in turns at both shapes
P11_LABEL = "H_packed_lane_slice"
# the exponential unit's rate on an H100 SXM as FlashAttention-3 (arXiv
# 2407.08608) states it, about 3.9 T exponentials a second: a published
# figure, not measured here, so its floor is printed and kept out of the
# kernels line
EXP_RATE = 3.9e12


def exp_floor(label: str, b: int, t: int) -> float:
    """The least ms of a variant's exponentials at EXP_RATE: one a score
    (G's bf16 pairs taken as one an instruction, so half; none for the bare
    products and the copy)."""
    scores = b * N_HEADS * t * t
    share = {"B_two_matmuls": 0, "F_copy_only": 0, "G_bf16_softmax": 0.5}
    return share.get(label, 1) * scores / EXP_RATE * 1e3


def swap_query_tiles(x):
    """[N, T, 48] with the query tiles 2 p and 2 p + 1 of every row swapped
    (T padded with zeros to whole pairs): what a unit whose two consumers
    swap their tiles computes."""
    n, t, d = x.shape
    pad = -(-t // 128) * 128
    y = F.pad(x, (0, 0, 0, pad - t)).view(n, pad // 128, 2, 64, d)
    return y.flip(2).reshape(n, pad, d)[:, :t].contiguous()


def ablation_bound(label: str, b: int, t: int):
    """The least time of one variant's own work: q, k, v in and o out (the
    copy: q in, o out) and its mask; the two products and the fp32 work per
    score (scale and mask, max, exponential, sum: 4; no max: 3; none for the
    bare products; G's bf16 exponential counted at the fp32 rate)."""
    n = b * N_HEADS
    rows = n * t * D_HEAD * 2
    if label == "F_copy_only":
        return bound(2 * rows, 0, 0)
    mask_bytes = {"B_two_matmuls": 0, "E2_madd_row": 4 * b * t,
                  "G_bf16_softmax": 4 * b * t, "K_identity_maps": n * t}
    per_score = {"B_two_matmuls": 0, "D_no_max_pass": 3}
    scores = n * t * t
    return bound(4 * rows + mask_bytes.get(label, b * t),
                 4 * scores * D_HEAD, per_score.get(label, 4) * scores)


def ablation_calls(sa, q, k, v, valid, b: int, t: int):
    """({label: (kernel call, plain call, library call or None, planted
    faults)}, {label: the mask argument of its wrapper} of the bodies that
    take q, k, v [B*H, T, 48], {label: {"same_bits": planted slips that
    must keep the kernel's bits, "library_strided": a second library
    call}}); each call returns [B, H, T, 48] (packed: [B, T, H*48])."""
    h = N_HEADS
    mask = valid[:, None].to(torch.int8).contiguous()
    madd = ((mask.float() - 1.0) * 1e9).contiguous()
    mask_bh = mask.repeat_interleave(h, dim=0)
    q4, k4, v4 = (x.view(b, h, t, D_HEAD) for x in (q, k, v))
    q3, k3, v3 = (x4.transpose(1, 2).reshape(b, t, h * D_HEAD)
                  for x4 in (q4, k4, v4))

    def heads(fn):
        return lambda *a: fn(*a).view(b, h, t, D_HEAD)

    def sdpa(mask4, scale=None):
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, scale=scale)

    valid4 = valid[:, None, None, :]
    madd4 = madd[:, None].to(torch.bfloat16)
    calls = {}
    masks = {"K_identity_maps": mask_bh}
    for label, plain, m, lib in (
            ("A_full", sa.full_plain, mask, sdpa(valid4)),
            ("F_copy_only", sa.copy_plain, mask, lambda: q4.clone()),
            ("B_two_matmuls", sa.scores_only_plain, mask, None),
            # the shift cancels: the same function as A
            ("D_no_max_pass", sa.no_max_plain, mask, sdpa(valid4)),
            ("E_prescaled_q", sa.prescaled_plain, mask, sdpa(valid4, 1.0)),
            ("E2_madd_row", sa.maddrow_plain, madd, sdpa(madd4, 1.0)),
            ("G_bf16_softmax", sa.bf16_softmax_plain, madd, None)):
        kernel = getattr(sa, ABLATION[label][1])
        masks[label] = m
        calls[label] = (
            lambda kernel=kernel, m=m: heads(kernel)(q, k, v, m),
            lambda plain=plain, m=m: heads(plain)(
                q, k, v, m.repeat_interleave(h, dim=0)), lib, ())
    calls["A_full"] = calls["A_full"][:3] + ((
        ("key mask ignored",
         lambda: heads(sa.full_sdpa)(q, k, v, torch.ones_like(mask))),),)
    # a slip of the redesign's ring by one head: each head reads the V of
    # the head before it
    v_prev = v4.roll(1, 1)
    for label, hc in P9_CELLS.items():
        # each head group reads the k of the next group (of the next batch
        # element when one group holds all heads)
        k_next = k4.reshape(b * h // hc, hc, t, D_HEAD).roll(-1, 0).view(
            b, h, t, D_HEAD)
        calls[label] = (
            lambda hc=hc: sa.allheads_sdpa(q4, k4, v4, mask, hc),
            lambda: sa.allheads_plain(q4, k4, v4, mask), sdpa(valid4),
            (("k of the next head group",
              lambda hc=hc, k_next=k_next: sa.allheads_sdpa(
                  q4, k_next, v4, mask, hc)),
             ("V of the previous head",
              lambda hc=hc: sa.allheads_sdpa(q4, k4, v_prev, mask, hc))))
    calls["K_identity_maps"] = (
        lambda: heads(sa.identity_maps_sdpa)(q, k, v, mask_bh),
        lambda: heads(sa.full_plain)(q, k, v, mask_bh), sdpa(valid4),
        (("the mask row of another head's batch element",
          lambda: heads(sa.identity_maps_sdpa)(
              q, k, v, mask.roll(-1, 0).repeat_interleave(h, dim=0))),))
    q_swapped = swap_query_tiles(q)
    k_prev, v_prev3 = k.roll(1, 0), v.roll(1, 0)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    for label in HEADS_WS_LABELS:
        wrapper = getattr(sa, ABLATION[label][1])
        variant, layout = sa._HEADS_WS[wrapper.__name__]
        m = masks[label]
        batch, n_heads = (1, b * h) if layout == sa._MASK_PER_HEAD else (b, h)
        # every block skips its last unit: its rows keep the output's zeros
        short = sa.heads_plan(b * h, t, sms)
        short[:, 1] -= 1
        short = torch.from_numpy(short).to(q.device)
        faults = calls[label][3] + (
            ("the K/V of the previous head",
             lambda wrapper=wrapper, m=m: heads(wrapper)(q, k_prev, v_prev3,
                                                         m)),
            ("the two query tiles of a unit swapped",
             lambda wrapper=wrapper, m=m: heads(wrapper)(q_swapped, k, v, m)),
            ("each persistent block skipping its last unit",
             lambda variant=variant, layout=layout, m=m, batch=batch,
             n_heads=n_heads, short=short: sa._walk(
                 variant, layout, q, k, v, m, batch, n_heads, t, short,
                 torch.zeros_like(q)).view(b, h, t, D_HEAD)))
        calls[label] = calls[label][:3] + (faults,)
    q3_permuted = q3.view(b, t, h, D_HEAD).roll(1, 2).reshape(b, t, -1)
    k3_prev, v3_prev = (x.view(b, t, h, D_HEAD).roll(1, 2).reshape(b, t, -1)
                        for x in (k3, v3))
    q3_swapped = swap_query_tiles(q3)
    short = sa.heads_plan(b * h, t, sms)
    short[:, 1] -= 1
    short = torch.from_numpy(short).to(q.device)

    def packed_library():
        # what the packed layout would remove around K3: the head transposes
        # in and out, around the library's SDPA
        split = (x.view(b, t, h, D_HEAD).transpose(1, 2).contiguous()
                 for x in (q3, k3, v3))
        out = F.scaled_dot_product_attention(*split, attn_mask=valid4)
        return out.transpose(1, 2).reshape(b, t, h * D_HEAD)

    def packed_library_strided():
        # the library's SDPA on strided views of the packed tensors (no
        # input copies), then the output back to the packed layout
        views = (x.view(b, t, h, D_HEAD).transpose(1, 2) for x in (q3, k3, v3))
        out = F.scaled_dot_product_attention(*views, attn_mask=valid4)
        return out.transpose(1, 2).reshape(b, t, h * D_HEAD)

    calls["H_packed_lane_slice"] = (
        lambda: sa.packed_sdpa(q3, k3, v3, mask),
        lambda: sa.full_packed_plain(q3, k3, v3, mask), packed_library,
        (("heads permuted in the packed q",
          lambda: sa.packed_sdpa(q3_permuted, k3, v3, mask)),
         ("columns 32-47 of each box from the next head (the flat map 16 "
          "columns over)",
          lambda: sa._packed_walk(q3, k3, v3, mask, b, t, flat=16)),
         ("the K/V of the previous head",
          lambda: sa.packed_sdpa(q3, k3_prev, v3_prev, mask)),
         ("the two query tiles of a unit swapped",
          lambda: sa.packed_sdpa(q3_swapped, k3, v3, mask)),
         ("each persistent block skipping its last unit",
          lambda: sa._packed_walk(q3, k3, v3, mask, b, t, short,
                                  torch.zeros_like(q3)))))
    extras = {"H_packed_lane_slice": dict(
        # slips that must keep the kernel's bits
        same_bits=(("the flat map over the 768 columns: columns 48-63 of "
                    "each box from the next head, which no product reads",
                    lambda: sa._packed_walk(q3, k3, v3, mask, b, t,
                                            flat=0)),),
        library_strided=packed_library_strided)}
    return calls, masks, extras


def ablation_phase(gen, dev):
    """P9-P12: every variant of the SDPA ablation against its plain version
    at ABLATION_SHAPES (the planted faults at the first), A_full bit-equal
    to K3, each timed by CUDA events and by the profile's kernel sum beside
    its bound (the exponential floor printed beside it), its plain version
    and the library call, and each redesign (P9, P10, P12) against the
    kernel it replaced (``kept_ab``); then the ablation's own ``main`` with
    both switches, from zeroed launch counts.  Returns ({label: JSON row},
    {wrapper name: launches in ``main``})."""
    from gigaam_tpu_torch.probes import sdpa_ablation as sa

    t_phase = time.perf_counter()
    readings = defaultdict(dict)
    for b, t in ABLATION_SHAPES:
        q, k, v = (torch.randn(b * N_HEADS, t, D_HEAD, generator=gen) * gain
                   for gain in (QK_GAIN, QK_GAIN, 1.0))
        q, k, v = (a.to(dev, torch.bfloat16) for a in (q, k, v))
        valid = ragged_valid(b, t, dev)
        calls, masks, extras = ablation_calls(sa, q, k, v, valid, b, t)
        k3 = fa.fused_mha(*(x.view(b, N_HEADS, t, D_HEAD) for x in (q, k, v)),
                          valid)
        if not torch.equal(calls["A_full"][0](), k3):
            raise AssertionError(f"A_full B={b} T'={t}: not K3's bits")
        # P11: K3's heads moved to the packed layout
        if not torch.equal(calls[P11_LABEL][0](), k3.transpose(1, 2).reshape(
                b, t, N_HEADS * D_HEAD)):
            raise AssertionError(f"{P11_LABEL} B={b} T'={t}: not K3's bits")
        for label, (kernel, plain, lib, faults) in calls.items():
            packed = label == P11_LABEL
            got = kernel()
            if not torch.equal(kernel(), got):
                raise AssertionError(f"{label}: two calls differ")
            err, rel = check_kernel(
                f"{label} B={b} T'={t}", got, plain(), valid,
                1 if packed else 2, faults if (b, t) == ABLATION_SHAPES[0]
                else ())
            for what, fn in extras.get(label, {}).get("same_bits", ()):
                same = torch.equal(fn(), got)
                print(f"  {label} B={b} T'={t} planted slip, {what}: "
                      f"bit-equal {same}", flush=True)
                if not same:
                    raise AssertionError(f"{label}: {what} moved the bits")
            ms = time_ms(kernel)
            sum_ms = sum(device_ms(kernel).values())
            plain_ms = time_ms(plain, iters=5)
            lib_ms = None if lib is None else time_ms(lib)
            bms, by = ablation_bound(label, b, t)
            exp_ms = exp_floor(label, b, t)
            print(f"{label} B={b} T'={t}: max_abs_err {err:.3e}, {rel:.4f} x "
                  f"RMS (limit {KERNEL_REL}); kernel {ms:.4f} ms by events, "
                  f"{sum_ms:.4f} ms on the card; plain {plain_ms:.4f} ms, "
                  f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f", bound {bms:.4f} ms ({by}), exponential floor at the "
                  f"published rate {exp_ms:.4f} ms", flush=True)
            readings[label][(b, t)] = dict(
                ms=ms, sum_ms=sum_ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, max_abs_err=err)
            if label in P9_CELLS or label in HEADS_WS_LABELS or packed:
                readings[label][(b, t)].update(kept_ab(
                    sa, label, q, k, v, masks.get(label), valid, b, t,
                    kernel, got, plain(), lib))
            if packed:
                # the library's SDPA on strided views, beside the one on
                # contiguous heads (``lib``)
                strided = extras[label]["library_strided"]
                r = readings[label][(b, t)]
                r["library_strided_ms"] = time_ms(strided)
                r["library_strided_sum_ms"] = sum(device_ms(strided).values())
                print(f"  {label} B={b} T'={t} library: contiguous heads "
                      f"{r['library_sum_ms']:.4f} ms on the card, "
                      f"{lib_ms:.4f} ms by events; strided views "
                      f"{r['library_strided_sum_ms']:.4f} ms on the card, "
                      f"{r['library_strided_ms']:.4f} ms by events; the walk "
                      f"{r['ab']['sum_ms']:.4f} ms on the card", flush=True)
            if label == "F_copy_only":
                # the copy against the library's, both fenced
                clone_ms = sum(device_ms(lib).values())
                print(f"  F_copy_only B={b} T'={t}: q4.clone() {clone_ms:.4f}"
                      f" ms on the card", flush=True)
                readings[label][(b, t)]["library_sum_ms"] = clone_ms
        print(f"A_full B={b} T'={t}: K3's bits", flush=True)
        del calls, extras, q, k, v
    torch.cuda.empty_cache()

    # the ablation's main path: the script's main with both switches
    saved = {n: os.environ.get(n) for n in ("SDPA_ABLATION_FULLSET",
                                            "SDPA_ABLATION_PACKED")}
    os.environ.update(dict.fromkeys(saved, "1"))
    sa.reset_launch_counts()
    try:
        results = sa.main()
    finally:
        for name, value in saved.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value
    launches = {fn.__name__: fn.launches for fn in sa.KERNELS}
    print("ablation " + json.dumps(results), flush=True)
    print(f"ablation launches {launches}", flush=True)
    if set(results) != set(ABLATION) or not all(launches.values()):
        raise AssertionError(f"the ablation ran {sorted(results)} with "
                             f"launches {launches}")
    print(f"ablation phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return ({label: dict(shaped_row(r, ABLATION_SHAPES[0]),
                         ablation_us=results[label])
             for label, r in readings.items()}, launches)


def kept_ab(sa, label, q, k, v, m, valid, b: int, t: int, kernel, got,
            ref, lib) -> dict:
    """A redesigned kernel of the ablation (P9's head-group walk, the
    per-head walk of P10 and P12's bodies, whose wrapper takes the mask
    ``m``, and its packed instance, P11, on q, k, v moved to [B, T, H*48])
    against the kernel it replaced (held to the plain version ``ref`` too)
    at one shape: the blocks of each grid, whether the two agree bit for bit
    (P11 must), and the times: for P9, HEADS_WS_AB and P11 both in turns
    (redesign, kept, kept, redesign) by CUDA events, the profile's kernel
    sum and graph replays, beside the library call's kernel sum; for the
    other bodies the kept kernel's fenced kernel sum at the first shape."""
    sms = torch.cuda.get_device_properties(valid.device).multi_processor_count
    time_dim = 2
    if label == P11_LABEL:
        mask = valid[:, None].to(torch.int8).contiguous()
        q3, k3, v3 = (x.view(b, N_HEADS, t, D_HEAD).transpose(1, 2).reshape(
            b, t, N_HEADS * D_HEAD) for x in (q, k, v))
        kept = lambda: sa.packed_sdpa_kept(q3, k3, v3, mask)
        blocks = len(sa.heads_plan(b * N_HEADS, t, sms))
        old_blocks = -(-t // 64) * N_HEADS * b
        time_dim = 1
    elif label in P9_CELLS:
        hc = P9_CELLS[label]
        q4, k4, v4 = (x.view(b, N_HEADS, t, D_HEAD) for x in (q, k, v))
        mask = valid[:, None].to(torch.int8).contiguous()
        kept = lambda: sa.allheads_sdpa_serial(q4, k4, v4, mask, hc)
        blocks = len(sa.groups_plan(b, N_HEADS, t, hc, sms))
        old_blocks = -(-t // 64) * (N_HEADS // hc) * b
    else:
        wrapper = getattr(sa, ABLATION[label][1])
        kept = lambda: sa.heads_sdpa_kept(wrapper, q, k, v, m).view(
            b, N_HEADS, t, D_HEAD)
        blocks = len(sa.heads_plan(b * N_HEADS, t, sms))
        old_blocks = -(-t // 64) * N_HEADS * b
    old = kept()
    old_err, _ = check_kernel(f"{label} B={b} T'={t} (the kept kernel)", old,
                              ref, valid, time_dim, ())
    same = torch.equal(old, got)
    if label == P11_LABEL and not same:
        raise AssertionError(f"{label} B={b} T'={t}: not its kept kernel's "
                             f"bits")
    out = dict(blocks=blocks, bit_equal_kept=same)
    text = f"the kept kernel ({old_blocks} blocks) "
    if label in P9_CELLS or label in HEADS_WS_AB or label == P11_LABEL:
        times, split, old_times, _ = ab_times(kernel, kept, got)
        lib_ms = sum(device_ms(lib).values())
        text += (f"{times_text(old_times)}; the redesign ({blocks} blocks) "
                 f"{times_text(times)}; redesign / kept "
                 f"{times['sum_ms'] / old_times['sum_ms']:.3f} card, "
                 f"{times['ms'] / old_times['ms']:.3f} events; SDPA "
                 f"{lib_ms:.4f} ms on the card; kernels "
                 + json.dumps([[n[:60], round(v, 4)]
                               for n, v in split.items()]))
        out.update(graph_ms=times["graph_ms"], ab=times, library_sum_ms=lib_ms)
    elif (b, t) == ABLATION_SHAPES[0]:
        old_times = dict(sum_ms=sum(device_ms(kept).values()))
        text += f"{old_times['sum_ms']:.4f} card"
    else:
        old_times = {}
        text += "not timed"
    print(f"  {label} B={b} T'={t} A/B: {text}; bit-equal to the kept "
          f"kernel: {same}", flush=True)
    return dict(out, kept=dict(old_times, max_abs_err=old_err,
                               blocks=old_blocks))


def ablation_kernel_rows(rows: dict, launches: dict) -> list:
    """The kernels line's rows of P9-P12: one per wrapper, P9's J under
    "also"."""
    out = []
    for label, (probe, wrapper) in ABLATION.items():
        if label == "J_4heads_cell":
            continue
        r = dict(rows[label])
        if label == "I_allheads_cell":
            j = rows["J_4heads_cell"]
            r["also"] = r["also"] + [
                dict(a, shape=f"J_4heads_cell, {a['shape']}")
                for a in [{k: v for k, v in j.items() if k != "also"},
                          *j["also"]]]
        p9, walk = label in P9_CELLS, label in HEADS_WS_LABELS
        p11 = label == P11_LABEL
        redesign = ("graph_ms", "ab", "blocks", "kept", "bit_equal_kept")
        out.append({
            "name": f"{probe} {label} {wrapper}", "route": "cuda",
            "source": "gigaam_tpu_torch/csrc/" + (
                "sdpa_groups_ws.cu" if p9 else
                "sdpa_heads_ws.cu" if walk else
                "sdpa_packed_heads_ws.cu" if p11 else "sdpa_ablation.cu"),
            "replaces": f"benchmarks/sdpa_ablation.py:"
                        f"{ABLATION_REPLACES[probe]}",
            "launches": launches[wrapper], **{
                key: r[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "sum_ms", "ablation_us", "shape", "also")},
            **({"status": "redesigned"} if p9 or walk or p11 else {}),
            **{key: r[key] for key in redesign + (
                "library_sum_ms", "library_strided_ms",
                "library_strided_sum_ms") if key in r}})
    return out


# P4 and P5: the scripts' two shapes, then the main path's B 16, T' 500;
# the JSON rows and the planted faults at the first
FOLD_PROBE_SHAPES = ((32, 512), (128, 768), (16, 500))
# id -> (probe, wrapper, the `pallas_call` it replaces)
FOLD_PROBES = {
    "P4": ("ffn", "ffn_fold", "benchmarks/pallas_ffn_fold_probe.py:69"),
    "P5": ("conv", "conv_fold", "benchmarks/pallas_conv_fold_probe.py:108"),
}
FOLD_PROBE_SOURCES = {"P4": "ffn_ws.cu", "P5": "conv_fold_ws.cu"}
# the redesign against the kept kernels in turns at these shapes, once each
# at the others; P4's kept fold is no longer timed (PERF.md section 6 holds
# its readings), only held to the plain version
FOLD_PROBE_AB_SHAPES = ((128, 768), (16, 500))
FOLD_PROBE_RING_TIMED = ("P5",)
# P5's stages by kernel name
CONV_FOLD_STAGES = (("row pass", "ffn_rows_kernel"),
                    ("GLU product", "conv_fold_ws_kernel<1>"),
                    ("depthwise", "conv_dw_kernel"),
                    ("W2 product", "conv_fold_ws_kernel<2>"))


def fold_probe_bound(probe: str, b: int, t: int):
    """The least time of one fold: x in and out once, the weights and
    vectors once (P5: and the mask); the products' tensor operations and the
    fp32 work a row (P4: LN 8 a channel, h's bias and SiLU 5 a column, the
    bias, 0.5 and residual 3 a channel; P5: LN 8, the GLU's biases, sigmoid
    and mask 7, the 31 taps' 62, BatchNorm 2, SiLU 4, bias and residual 2 a
    channel)."""
    m, d = b * t, D_MODEL
    act = 2 * m * d * 2
    if probe == "ffn":
        dff = 4 * d
        return bound(act + 2 * d * dff * 2 + (4 * d + dff) * 4,
                     4 * m * d * dff, m * (11 * d + 5 * dff))
    return bound(act + m + 3 * d * d * 2 + (8 + 31) * d * 4,
                 6 * m * d * d, m * d * (8 + 7 + 62 + 2 + 4 + 2))


def fold_probe_calls(fp, probe: str, b: int, t: int, dev):
    """(kernel call, plain call, baseline call, lean call, faults, x, valid,
    the kept kernel's call or None) for the probe at (b, t) on the script's
    weights; each call returns the [B, T, 768] output."""
    from gigaam_tpu_torch.weights import sub_block_from_jax

    bf = torch.bfloat16
    if probe == "ffn":
        ln_np, p_np, x_np = fp.ffn_inputs(b, t)
        valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    else:
        ln_np, p_np, x_np, valid_np = fp.conv_inputs(b, t)
        valid = torch.from_numpy(valid_np).to(dev)
    x = torch.from_numpy(x_np).to(dev, bf)
    ln_p = fp.tree_to(sub_block_from_jax(ln_np), dev)
    p32 = fp.tree_to(sub_block_from_jax(p_np), dev)
    p16 = fp.tree_to(p32, dev, bf)
    if probe == "ffn":
        w = fp.prepare_ffn(ln_p, p32, bf)
        lw = fp.lean_ffn_weights(ln_p, p32, bf)
        doubled = dataclasses.replace(w, w2=w.w2 * 2, b2=w.b2 * 2)
        # a slip of the W2 product's ring by one K item: each item of 64
        # rows of W2 reads the item before it
        late = dataclasses.replace(w, w2=w.w2.roll(64, 0))

        def silu_skipped():
            # what the kernel would return without its SiLU, up to rounding
            xn = layer_norm({"scale": w.ln_g, "bias": w.ln_b}, x)
            with full_fp32():
                h = (xn.float() @ w.w1.float() + w.b1).to(bf)
                y = h.float() @ w.w2.float() + w.b2
            return (0.5 * y).to(bf) + x

        return (lambda: fp.ffn_fold(w, x), lambda: fp.ffn_fold_plain(w, x),
                lambda: fp.ffn_baseline(ln_p, p16, x),
                lambda: fp.ffn_lean(lw, x),
                (("the 0.5 dropped", lambda: fp.ffn_fold(doubled, x)),
                 ("SiLU skipped", silu_skipped),
                 ("W2 one K item late", lambda: fp.ffn_fold(late, x))), x,
                valid, lambda: fp.ffn_fold_ring(w, x))
    w = fp.prepare_conv(ln_p, p32, bf)
    lw = fp.lean_conv_weights(ln_p, p32, bf)
    mask = valid[..., None].to(bf)
    shifted = dataclasses.replace(w, dw=torch.cat(
        [torch.zeros_like(w.dw[:1]), w.dw[:-1]]).contiguous())
    no_dw_bias = dataclasses.replace(w, bnb=fp.bn_affine(
        {**p32, "depthwise_conv": {"w": p32["depthwise_conv"]["w"]}})[1])
    # a slip of the redesign's interleave: each tile's value and gate
    # blocks in each other's place
    vg_swapped = dataclasses.replace(w, w_vg=fp.interleave_vg(w.wg, w.wv))
    return (lambda: fp.conv_fold(w, x, valid),
            lambda: fp.conv_fold_plain(w, x, valid),
            lambda: fp.conv_baseline(ln_p, p16, x, valid),
            lambda: fp.conv_lean(lw, x, mask),
            (("the mask skipped",
              lambda: fp.conv_fold(w, x, torch.ones_like(valid))),
             ("the depthwise window shifted by one tap",
              lambda: fp.conv_fold(shifted, x, valid)),
             ("the depthwise bias left out of the BatchNorm fold",
              lambda: fp.conv_fold(no_dw_bias, x, valid)),
             ("the GLU's value and gate blocks swapped in W_vg",
              lambda: fp.conv_fold(vg_swapped, x, valid))), x, valid,
            lambda: fp.conv_fold_ring(w, x, valid))


def conv_stage_checks(fp, label: str, x, valid) -> None:
    """P5's four stages, each on the card stage's input, held to its plain
    stage (the GLU's output also zero on padded frames), each two calls
    bit-equal."""
    from gigaam_tpu_torch.weights import sub_block_from_jax

    ln_np, p_np, _, _ = fp.conv_inputs(1, 1)
    dev = x.device
    w = fp.prepare_conv(fp.tree_to(sub_block_from_jax(ln_np), dev),
                        fp.tree_to(sub_block_from_jax(p_np), dev),
                        torch.bfloat16)
    xn = fp.conv_rows_ws(w, x)
    y = fp.glu_product_ws(w, xn, valid)
    c = fp.depthwise_ws(w, y)
    stages = (("row pass", xn, lambda: fp.conv_rows_ws(w, x),
               fp.conv_rows_plain(w, x), None),
              ("GLU product", y, lambda: fp.glu_product_ws(w, xn, valid),
               fp.glu_product_plain(w, xn, valid), None),
              ("depthwise", c, lambda: fp.depthwise_ws(w, y),
               fp.depthwise_plain(w, y), None),
              ("W2 product", fp.conv_residual_product_ws(w, c, x),
               lambda: fp.conv_residual_product_ws(w, c, x),
               fp.conv_residual_product_plain(w, c, x), x))
    errs = {}
    for name, got, again, ref, residual in stages:
        errs[name], _ = check_kernel(f"{label} {name} stage", got, ref,
                                     valid, 1, (), residual=residual)
        if not torch.equal(again(), got):
            raise AssertionError(f"{label} {name} stage: two calls differ")
    if bool(y[~valid].any()):
        raise AssertionError(f"{label}: the GLU stage left padded frames "
                             f"nonzero")
    print(f"  {label} stages against their plain stages, max_abs_err "
          + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
          + "; each two calls bit-equal", flush=True)


def fold_probe_phase(dev):
    """P4 and P5: each fold against its plain version at FOLD_PROBE_SHAPES
    (the planted faults at the first, against the limit on the sub-block's
    term, out - x), two calls bit-equal, each timed by CUDA events and by
    the profile's kernel sum beside its bound, its plain version, the
    in-model baseline and the lean path; P5's four stages against their
    plain stages (``conv_stage_checks``); each redesign against the kernels
    it replaced (``fold_ring_ab``: held to the plain version too; P5's
    timed by events, the kernel sum and graph replays, in turns at
    FOLD_PROBE_AB_SHAPES); then the probes' own ``main``, from zeroed
    launch counts.  Returns ({id: JSON row}, {wrapper: launches in
    ``main``})."""
    from gigaam_tpu_torch.probes import fold_probes as fp

    readings = defaultdict(dict)
    for b, t in FOLD_PROBE_SHAPES:
        for pid, (probe, wrapper, _) in FOLD_PROBES.items():
            kernel, plain, base, lean, faults, x, valid, ring = (
                fold_probe_calls(fp, probe, b, t, dev))
            got = kernel()
            if not torch.equal(kernel(), got):
                raise AssertionError(f"{pid} B={b} T={t}: two calls differ")
            err, rel = check_kernel(
                f"{pid} {wrapper} B={b} T={t}", got, plain(), valid, 1,
                faults if (b, t) == FOLD_PROBE_SHAPES[0] else (), residual=x)
            ms = time_ms(kernel)
            split = device_ms(kernel)
            sum_ms = sum(split.values())
            plain_ms = time_ms(plain, iters=3, warmup=1)
            base_ms, lean_ms = time_ms(base), time_ms(lean)
            bms, by = fold_probe_bound(probe, b, t)
            if (b, t) == FOLD_PROBE_SHAPES[0]:
                # where each path's device time goes, by kernel
                for label, times in (("fold", split), ("lean", device_ms(lean)),
                                     ("baseline", device_ms(base))):
                    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
                    print(f"  {pid} {label} B={b} T={t} on the card by kernel "
                          f"(sum {sum(times.values()):.4f} ms): " + json.dumps(
                              [[k[:60], round(v, 4)] for k, v in top]),
                          flush=True)
            print(f"{pid} {wrapper} B={b} T={t}: max_abs_err {err:.3e}, "
                  f"{rel:.4f} x RMS (limit {KERNEL_REL}); kernel {ms:.4f} ms "
                  f"by events, {sum_ms:.4f} ms on the card; plain "
                  f"{plain_ms:.4f} ms, baseline {base_ms:.4f} ms, lean "
                  f"{lean_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
            readings[pid][(b, t)] = dict(
                ms=ms, sum_ms=sum_ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lean_ms, baseline_ms=base_ms,
                max_abs_err=err)
            if pid == "P5":
                conv_stage_checks(fp, f"{pid} B={b} T={t}", x, valid)
            readings[pid][(b, t)].update(fold_ring_ab(
                f"{pid} {wrapper} B={b} T={t}", kernel, ring, got, plain(),
                x, valid, bms, lean, (b, t) in FOLD_PROBE_AB_SHAPES,
                CONV_FOLD_STAGES if pid == "P5" else None,
                timed=pid in FOLD_PROBE_RING_TIMED))
            del kernel, plain, base, lean, faults, got, x, ring
        torch.cuda.empty_cache()

    # the probes' main path: their main, both probes at the scripts' shapes
    fp.reset_launch_counts()
    results = fp.main()
    launches = {fn.__name__: fn.launches for fn in fp.KERNELS}
    print("fold_probes " + json.dumps(results), flush=True)
    print(f"fold_probes launches {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"the fold probes' main launched {launches}")
    torch.cuda.empty_cache()
    rows = {}
    for pid, (probe, _, _) in FOLD_PROBES.items():
        main_us = results[probe][f"b{FOLD_PROBE_SHAPES[0][0]}_t"
                                 f"{FOLD_PROBE_SHAPES[0][1]}"]
        rows[pid] = dict(shaped_row(readings[pid], FOLD_PROBE_SHAPES[0]),
                         fold_us=main_us[fp.FOLD_KEY[probe]])
    return rows, launches


def fold_ring_ab(label: str, kernel, ring, got, ref, x, valid, bms: float,
                 lean, turns: bool, stages=None, timed: bool = True) -> dict:
    """A fold's redesign against the kernels it replaced (P4's one-launch
    fold, P5's two kernels) at one shape: the kept kernels held to the
    plain version and compared with the redesign bit for bit; with
    ``timed`` both timed by CUDA events, the profile's kernel sum and graph
    replays, in turns (redesign, kept, kept, redesign) with ``turns``, else
    once each; without it the redesign alone, once; the redesign's sum
    split by kernel (P4: row pass, the two products, a reduction where K is
    split; P5 also by ``stages``)."""
    old = ring()
    old_err, _ = check_kernel(f"{label} (the kept kernels)", old, ref,
                              valid, 1, (), residual=x)
    same = torch.equal(old, got)
    if timed and turns:
        times, split, old_times, _ = ab_times(kernel, ring, got)
    elif timed:
        (times, split), (old_times, _) = (three_times(kernel, got),
                                          three_times(ring, got))
    else:
        (times, split), old_times = three_times(kernel, got), {}
    old_times["max_abs_err"] = old_err
    lean_ms = sum(device_ms(lean).values())
    kept = (f"the kept kernels {times_text(old_times)}; " if timed
            else "the kept kernels untimed; ")
    ratio = (f"redesign / kept {times['sum_ms'] / old_times['sum_ms']:.3f} "
             f"card, {times['graph_ms'] / old_times['graph_ms']:.3f} graph; "
             if timed else "")
    print(f"  {label} A/B{' in turns' if timed and turns else ''}: " + kept
          + f"the redesign {times_text(times)}; " + ratio
          + f"bit-equal to the kept kernels: {same}; bound {bms:.4f} ms "
          f"({bms / times['sum_ms']:.3f} of it on the card), lean "
          f"{lean_ms:.4f} ms on the card; the redesign by kernel "
          + json.dumps([[n[:60], round(v, 4)] for n, v in split.items()]),
          flush=True)
    out = dict(graph_ms=times["graph_ms"], ab=times, ring=old_times,
               stages={n[:60]: v for n, v in split.items()},
               library_sum_ms=lean_ms, bit_equal_to_kept=same,
               in_turns=timed and turns)
    if stages is not None:
        out["stages_ms"] = stage_split(split, stages)
        print(f"  {label} the redesign by stage "
              + json.dumps({k: round(v, 4)
                            for k, v in out["stages_ms"].items()}),
              flush=True)
    return out


def fold_probe_kernel_rows(rows: dict, launches: dict) -> list:
    """The kernels line's rows of P4 and P5, each redesigned (the kept
    kernels' readings under ``ring``)."""
    return [{
        "name": f"{pid} {wrapper}", "route": "cuda",
        "source": "gigaam_tpu_torch/csrc/" + FOLD_PROBE_SOURCES[pid],
        "status": "redesigned", "replaces": repl,
        "launches": launches[wrapper], **{
            key: rows[pid][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "sum_ms", "baseline_ms", "fold_us", "shape",
                "also", "graph_ms", "ab", "ring", "stages",
                "library_sum_ms")},
        **({"stages_ms": rows[pid]["stages_ms"]} if pid == "P5" else {})}
        for pid, (_, wrapper, repl) in FOLD_PROBES.items()]


# P1-P3: the script's shapes (B 1), then the main path's stage 2 at B 16,
# T' 500, whose readings make the JSON rows of P1 and P2; the planted
# faults at B 1, T 64 and, for the batch edge, at B 16
SUB_SHAPES = (("P1", 1, 32, False), ("P1", 1, 32, True), ("P1", 1, 64, False),
              ("P1", 1, 64, True), ("P1", 1, 128, False), ("P1", 1, 128, True),
              ("P1", 16, 500, True), ("P2", 1, 64, False), ("P2", 1, 64, True),
              ("P2", 1, 128, False), ("P2", 1, 128, True),
              ("P2", 16, 500, False), ("P2", 16, 500, True))
SUB_ROW = (16, 500, True)
SUB_FAULTS = (1, 64)
# P1's step instances (sp.WS_STEPS) are held to the plain version at the
# main path's stage 2 and the script's middle shape, the forced K splits
# (fp32 partials and a reduction pass) at B 1, T 64, the linear's at B 16,
# T 500: checks only, their one-time timing study is PERF.md's (PR 18)
SUB_STEP_SHAPES = ((16, 500), (1, 64))
SUB_SPLITS = (1, 2, 3, 4, 5, 6, 8, 11)
SUB_LIN_SPLITS = (1, 2, 3, 4)
# id -> (wrapper, the `pallas_call` it replaces, what the variant flag means)
SUB_PROBES = {
    "P1": ("taps_product", "benchmarks/pallas_subsampling_probe.py:78",
           ("aligned", "with copies")),
    "P2": ("im2col_product", "benchmarks/pallas_subsampling_probe.py:136",
           ("without the linear", "with the linear")),
    "P3": ("smem_copy", "benchmarks/pallas_subsampling_probe.py:162", ()),
}


def subsampling_bound(pid: str, b: int, t: int, variant: bool):
    """The least time of one probe call: the blocks it reads (P1 aligned:
    ee and oe only), the weights and the output once; the products' tensor
    operations (P2: the whole [B T 16, 768] product, and the linear), P2's
    ReLU as fp32 work.  ``variant``: P1 with copies, P2 with the linear."""
    d, m = D_MODEL, b * t * 16
    fe = 17 if pid == "P2" or variant else 16
    ee, oe = b * t * 16 * d * 2, b * (t + 1) * 16 * d * 2
    eo, oo = b * t * fe * d * 2, b * (t + 1) * fe * d * 2
    ops = 2 * 9 * m * d * d
    if pid == "P1":
        reads = ee + oe + (eo + oo if variant else 0)
        return bound(reads + 9 * d * d * 2 + m * d * 2, ops, 0)
    lin = 2 * b * t * 16 * d * d if variant else 0
    return bound(ee + eo + oe + oo + 9 * d * d * 2
                 + (16 * d * d * 2 if variant else 0) + b * t * d * 2,
                 ops + lin, m * d if variant else 0)


def subsampling_inputs(sp, pid: str, b: int, t: int, variant: bool, dev):
    """(ee, eo, oe, oo, w [9, 768, 768], wl [12288, 768], x1): at B 1 the
    script's draws for the probe, x1 None; at B 16 the blocks of a stage-1
    output x1 [B, 768, 2T, 32] drawn on the card, as the stage-2 conv with
    padding 1 reads them."""
    bf = torch.bfloat16
    if b == 1:
        drawn = (sp.taps_inputs(t, variant) if pid == "P1"
                 else sp.im2col_inputs(t))
        *blocks, w = (torch.from_numpy(a).to(dev, bf) for a in drawn[:5])
        wl = (torch.from_numpy(drawn[5]).to(dev, bf) if pid == "P2"
              else None)
        return (*(x[None] for x in blocks), w.view(9, D_MODEL, D_MODEL), wl,
                None)
    gen = torch.Generator(device=dev).manual_seed(5)
    x1 = torch.randn(b, D_MODEL, 2 * t, 32, generator=gen, device=dev,
                     dtype=bf)
    w = 0.02 * torch.randn(9, D_MODEL, D_MODEL, generator=gen, device=dev,
                           dtype=bf)
    wl = 0.02 * torch.randn(16 * D_MODEL, D_MODEL, generator=gen, device=dev,
                            dtype=bf)
    return (*sp.stage2_blocks(x1), w, wl, x1)


def batch_merged(blocks):
    """The blocks with the batch folded into time, each odd-time block's
    extra step kept only for the last element: a kernel given them runs
    tiles across the batch edges, and the last step of each element reads
    the next element's first odd-time row in place of its own last one."""
    ee, eo, oe, oo = blocks
    b, t = ee.shape[:2]

    def odd(x):
        return torch.cat([x[:, :t].reshape(1, b * t, *x.shape[2:]),
                          x[-1:, t:]], dim=1)

    return (ee.reshape(1, b * t, *ee.shape[2:]),
            eo.reshape(1, b * t, *eo.shape[2:]), odd(oe), odd(oo))


def subsampling_calls(sp, pid: str, variant: bool, inputs):
    """(kernel call, plain call, library call, the conv in channels_last or
    None, faults, the TMA ring's call) of P1 (``variant``: with copies) or
    P2 (with the linear) on ``inputs``; the faults at B 1 with copies or
    for P2, at B 16 the batch edge (P1 only)."""
    ee, eo, oe, oo, w, wl, x1 = inputs
    b, t = ee.shape[:2]
    blocks = (ee, eo, oe, oo)
    swapped = w.clone()
    swapped[[1, 2]] = w[[2, 1]]
    w4 = sp.conv_weight(w)
    if x1 is not None:
        cl = torch.channels_last
        x1c, w4c = (x1.contiguous(memory_format=cl),
                    w4.contiguous(memory_format=cl))
    if (pid == "P1") != variant:
        lib_cl = None          # P1 aligned, P2 with the linear: no conv
    elif x1 is not None:
        lib_cl = lambda: sp.conv_library(x1c, w4c, padding=1)
    else:
        fn_cl, args_cl = sp.conv_cl_library(*blocks, w)
        lib_cl = lambda: fn_cl(*args_cl)
    if pid == "P1":
        taps = sp.TAPS[variant]
        if x1 is not None:
            lib = lambda: sp.conv_library(x1, w4, padding=1)
            merged = batch_merged(blocks)
            faults = (("a tile that reads across a batch edge",
                       lambda: sp.taps_product(*merged, w, taps).view(
                           ee.shape)),)
        else:
            fn, args = sp.taps_library(*blocks, w, variant)
            lib = lambda: fn(*args)
            faults = (
                ("the misaligned taps read aligned", lambda: sp.taps_product(
                    *blocks, w, tuple((k, dt, 0) for k, dt, _ in taps))),
                ("the odd-time blocks' hi offset dropped",
                 lambda: sp.taps_product(*blocks, w, tuple(
                     (k, 0, df) for k, _, df in taps))),
                ("two taps' weights swapped",
                 lambda: sp.taps_product(*blocks, swapped, taps)))
        return (lambda: sp.taps_product(*blocks, w, taps),
                lambda: sp.taps_plain(*blocks, w, taps), lib, lib_cl,
                faults if variant else (),
                lambda: sp.taps_product_ring(*blocks, w, taps))
    w2 = w.view(9 * D_MODEL, D_MODEL)
    lin = wl if variant else None
    if x1 is None:
        fn, args = sp.im2col_library(*blocks, w2, lin)
        lib = lambda: fn(*args)
    elif variant:
        wl_t = wl.t().contiguous()
        lib = lambda: sp.conv_linear_library(x1c, w4c, wl_t, padding=1)
    else:
        lib = lambda: sp.conv_library(x1, w4, padding=1)

    def relu_skipped():
        # what P2 with the linear would return without its ReLU
        with full_fp32():
            s2 = sp.patch_plain(*blocks).float() @ w2.float()
            s2b = s2.to(ee.dtype).reshape(b, t, -1)
            return (s2b.float() @ wl.float()).to(ee.dtype)

    faults = () if x1 is not None else (
        ("two taps' weights swapped", lambda: sp.im2col_product(
            *blocks, swapped.view(9 * D_MODEL, D_MODEL), lin)),
        *((("ReLU skipped before the linear", relu_skipped),) if variant
          else ()))
    return (lambda: sp.im2col_product(*blocks, w2, lin),
            lambda: sp.im2col_plain(*blocks, w2, lin), lib, lib_cl, faults,
            lambda: sp.im2col_product_ring(*blocks, w2, lin))


# a profile whose kernel sum reads under this share of the graph replays'
# time is taken again (three times at most), then refused: the profiler has
# returned windows whose every kernel read about half its time (0.47-0.50
# of the replays), where graph replays and CUDA events did not move; whole
# profiles have read 0.67-1.06 of the replays (the least at B 1, where the
# replays' time holds the gaps between short kernels; the power cap alone
# gives ~0.75 under gapless load)
PROFILE_FLOOR = 0.6


def checked_split(fn, graph_ms: float, attempts: int = 4) -> dict:
    """``device_ms`` of ``fn`` whose sum reads at least PROFILE_FLOOR of
    ``graph_ms``, taken up to ``attempts`` times; raises if none did."""
    for _ in range(attempts):
        split = device_ms(fn)
        if sum(split.values()) >= PROFILE_FLOOR * graph_ms:
            return split
        print(f"  a profile read {sum(split.values()):.4f} ms against "
              f"{graph_ms:.4f} by graph replays: taken again", flush=True)
    raise AssertionError(f"no profile in {attempts} read {PROFILE_FLOOR} of "
                         f"the graph replays' {graph_ms:.4f} ms")


def three_times(fn, out):
    """({ms: CUDA events, sum_ms: the profile's kernel sum, graph_ms:
    graph replays}, the profile's ms by kernel) of ``fn``, whose output is
    shaped like ``out``."""
    graph_ms = device_timeit(lambda _: fn(), [out], k=5) * 1e3
    split = checked_split(fn, graph_ms)
    return dict(ms=time_ms(fn), sum_ms=sum(split.values()),
                graph_ms=graph_ms), split


def launch_times(fn, x):
    """``three_times`` without the profile's floor, for kernels of a few
    microseconds, where the profile's sum and the graph replays, which hold
    the gaps between launches, need not agree; ``x``, a CUDA tensor,
    selects the device and is not chained."""
    split = device_ms(fn)
    return dict(ms=time_ms(fn), sum_ms=sum(split.values()),
                graph_ms=device_timeit(lambda _: fn(), [x], k=20) * 1e3), split


def ab_times(kernel, ring, out, measure=three_times):
    """``measure`` (``three_times``) of the redesign and the ring in turns
    (redesign, ring, ring, redesign), each reading the mean of its two:
    (redesign's, its kernels, ring's, its kernels)."""
    got = {}
    for name, fn in (("k", kernel), ("r", ring), ("r", ring), ("k", kernel)):
        got.setdefault(name, []).append(measure(fn, out))
    mean = lambda runs: {key: sum(r[key] for r, _ in runs) / len(runs)
                         for key in runs[0][0]}
    return mean(got["k"]), got["k"][0][1], mean(got["r"]), got["r"][0][1]


def times_text(r: dict) -> str:
    return (f"{r['sum_ms']:.4f} card, {r['graph_ms']:.4f} graph, "
            f"{r['ms']:.4f} events")


def subsampling_variant_checks(sp, pid: str, label: str, inputs, ref, valid,
                               b: int, t: int) -> None:
    """P1 with copies in each of the redesign's steps (at SUB_STEP_SHAPES)
    and at each forced K split (at SUB_FAULTS), P2's linear alone at each
    forced K split (at B 16) on relu(s2), held to its fp32 product: the
    instances and options that the wrappers do not launch, checked, not
    timed."""
    blocks, w, wl = inputs[:4], inputs[4], inputs[5]
    taps, errs = sp.TAPS_WITH_COPIES, {}
    if pid == "P1" and (b, t) in SUB_STEP_SHAPES:
        for step, variant, persistent in sp.WS_STEPS:
            errs[f"step {step}"], _ = check_kernel(
                f"{label} step {step}", sp.taps_ws(*blocks, w, taps, variant,
                                                   persistent),
                ref, valid, 1, ())
    if pid == "P1" and (b, t) == SUB_FAULTS:
        for n in SUB_SPLITS:
            errs[f"{n} splits"], _ = check_kernel(
                f"{label} {n} splits", sp.taps_ws(*blocks, w, taps, splits=n),
                ref, valid, 1, ())
    if pid == "P2" and b > 1:
        a = torch.relu(sp.taps_ws(*blocks, w, taps)).view(b * t, 16 * D_MODEL)
        with full_fp32():
            lin_ref = (a.float() @ wl.float()).to(a.dtype)
        rows = torch.ones(b * t, 1, dtype=torch.bool, device=a.device)
        for n in SUB_LIN_SPLITS:
            errs[f"linear, {n} splits"], _ = check_kernel(
                f"{label} linear, {n} splits", sp.linear_ws(a, wl, splits=n),
                lin_ref, rows, 1, ())
    if errs:
        print(f"  {label} held to the plain version (max_abs_err): "
              + "; ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)


def no_patch_check(label, kernel, split: dict, b: int, t: int) -> None:
    """P2's path launches no ``patch_kernel`` and allocates far less than
    the [B T 16, 6912] patch."""
    names = sorted(split)
    if (any("patch_kernel" in n for n in names)
            or not any("ws_conv_kernel" in n for n in names)):
        raise AssertionError(f"{label}: kernels {names}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernel()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    patch = b * t * 16 * 9 * D_MODEL * 2
    print(f"  {label}: kernels {[n[:40] for n in names]}, no patch_kernel; "
          f"{peak} bytes allocated at the peak against the patch's {patch}",
          flush=True)
    if peak >= patch // 2:
        raise AssertionError(f"{label}: {peak} bytes at the peak")


def subsampling_probe_phase(dev):
    """P1-P3: P1 and P2 (the warp-specialised redesign) against their plain
    versions at SUB_SHAPES (the planted faults at SUB_FAULTS, the batch edge
    at B 16), two calls bit-equal, each timed by CUDA events, by the
    profile's kernel sum and by graph replays beside its bound, its plain
    version, the library call and the TMA ring of the earlier design (held
    to the plain version too); the redesign's step instances and forced K
    splits held to the plain version (``subsampling_variant_checks``); at
    B 16 P2's kernels and peak memory (no patch); P3's ceiling against the
    card's opt-in limit, 2 x exact at every granted size from the bulk copy
    and the kept kernel, the two timed in turns beside an empty kernel and
    ``x * 2``; then
    the probe's own ``main``, from zeroed launch counts.  Returns ({id:
    JSON row}, {wrapper: launches in ``main``})."""
    from gigaam_tpu_torch.probes import subsampling_probe as sp

    t_phase = time.perf_counter()
    readings = defaultdict(dict)
    for pid, b, t, variant in SUB_SHAPES:
        inputs = subsampling_inputs(sp, pid, b, t, variant, dev)
        kernel, plain, lib, lib_cl, faults, ring = subsampling_calls(
            sp, pid, variant, inputs)
        shape = f"B {b}, T {t}, {SUB_PROBES[pid][2][variant]}"
        label = f"{pid} {SUB_PROBES[pid][0]} {shape}"
        got = kernel()
        if not torch.equal(kernel(), got):
            raise AssertionError(f"{label}: two calls differ")
        valid = torch.ones(b, t, dtype=torch.bool, device=dev)
        ref = plain()
        err, rel = check_kernel(
            label, got, ref, valid, 1,
            faults if (b, t) in (SUB_FAULTS, SUB_ROW[:2]) else ())
        ring_got = ring()
        ring_err, _ = check_kernel(f"{label} (the TMA ring)", ring_got, ref,
                                   valid, 1, ())
        del ring_got
        if variant:
            subsampling_variant_checks(sp, pid, label, inputs, ref, valid, b,
                                       t)
        times, split, ring_times, ring_split = ab_times(kernel, ring, got)
        ring_times["max_abs_err"] = ring_err
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = time_ms(lib)
        lib_cl_ms = None if lib_cl is None else time_ms(lib_cl)
        bms, by = subsampling_bound(pid, b, t, variant)
        print(f"  {label} A/B: the TMA ring {times_text(ring_times)} "
              f"({bms / ring_times['sum_ms']:.3f} of the bound on the card); "
              f"the redesign {times_text(times)} "
              f"({bms / times['sum_ms']:.3f}); redesign / ring "
              f"{times['sum_ms'] / ring_times['sum_ms']:.3f} card, "
              f"{times['graph_ms'] / ring_times['graph_ms']:.3f} graph",
              flush=True)
        if b > 1:
            # where each call's device time goes, by kernel
            for name, sp_times in (
                    ("kernel", split), ("ring", ring_split),
                    ("library", device_ms(lib)),
                    ("channels_last", None if lib_cl is None
                     else device_ms(lib_cl))):
                if sp_times is None:
                    continue
                top = sorted(sp_times.items(), key=lambda kv: -kv[1])[:6]
                print(f"  {label} {name} on the card by kernel (sum "
                      f"{sum(sp_times.values()):.4f} ms): " + json.dumps(
                          [[k[:70], round(v, 4)] for k, v in top]),
                      flush=True)
            if pid == "P2":
                no_patch_check(label, kernel, split, b, t)
        cl_text = ("" if lib_cl_ms is None
                   else f", channels_last {lib_cl_ms:.4f} ms")
        print(f"{label}: max_abs_err {err:.3e}, {rel:.4f} x RMS (limit "
              f"{KERNEL_REL}); kernel {times['ms']:.4f} ms by events, "
              f"{times['sum_ms']:.4f} ms on the card, {times['graph_ms']:.4f}"
              f" ms by graph replays; plain {plain_ms:.4f} ms, library "
              f"{lib_ms:.4f} ms{cl_text}, bound {bms:.4f} ms ({by})",
              flush=True)
        readings[pid][(b, t, variant)] = dict(
            times, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=lib_ms, library_cl_ms=lib_cl_ms, max_abs_err=err,
            shape=shape, ring=ring_times)
        del inputs, kernel, plain, lib, lib_cl, faults, got, ref, ring
        torch.cuda.empty_cache()

    # P3: the ceiling is the card's opt-in limit; 2 x comes back exactly at
    # every granted size, from the bulk-copy redesign and the kept kernel,
    # and the next size is refused
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    x = torch.randn(8, 1024, device=dev).to(torch.bfloat16)
    sizes = [kb * 1024 for kb in sp.SMEM_LADDER_KB if kb * 1024 <= limit]
    blocks = {}
    for n_bytes in sizes:
        out, blocks[n_bytes] = sp.smem_copy(x, n_bytes)
        if not (torch.equal(out, x * 2)
                and torch.equal(sp.smem_copy_kept(x, n_bytes)[0], out)):
            raise AssertionError(f"P3 at {n_bytes} bytes: not 2 x, or not "
                                 f"the kept kernel's")
    try:
        sp.smem_copy(x, limit + 1024)
    except sp.SharedMemoryRefused as e:
        print(f"P3 smem_copy: 2 x exact at {len(sizes)} sizes up to {limit} "
              f"bytes (the kept kernel too), blocks an SM {blocks}; "
              f"{limit + 1024} refused ({e})", flush=True)
    else:
        raise AssertionError(f"P3: {limit + 1024} bytes were granted")
    kernel = lambda: sp.smem_copy(x, limit)[0]
    kept = lambda: sp.smem_copy_kept(x, limit)[0]
    times, _, kept_times, _ = ab_times(kernel, kept, x, launch_times)
    floor = launch_times(lambda: sp.empty_launch(dev), x)[0]
    lib = launch_times(lambda: x * 2, x)[0]
    p3 = dict(times, plain_ms=time_ms(lambda: sp.vmem_plain(x, limit)),
              library_ms=lib["ms"], library_sum_ms=lib["sum_ms"],
              library_graph_ms=lib["graph_ms"], library_cl_ms=None,
              floor=floor, kept=kept_times, blocks_per_sm=blocks[limit],
              max_abs_err=0.0,
              shape=f"x [8, 1024] through {limit} bytes of shared memory")
    p3["bound_ms"], p3["bound_by"] = bound(4 * x.numel(), 0, 0)
    print(f"P3 smem_copy A/B: the kept kernel {times_text(kept_times)}; the "
          f"bulk copy {times_text(times)}; an empty kernel on its grid "
          f"{times_text(floor)}; x * 2 {times_text(lib)}", flush=True)
    print(f"P3 smem_copy: {json.dumps(p3)}", flush=True)

    # the probe's main path: the script's main at its shapes
    sp.reset_launch_counts()
    results = sp.main()
    launches = {fn.__name__: fn.launches for fn in sp.KERNELS}
    print("subsampling_probe " + json.dumps(results), flush=True)
    print(f"subsampling_probe launches {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"the subsampling probe's main launched "
                             f"{launches}")
    vmem = results["vmem"]
    if vmem["max_scratch_bytes"] != limit or "fail_at_mb" not in vmem:
        raise AssertionError(f"P3's ceiling {vmem}, the card's opt-in limit "
                             f"{limit}")
    torch.cuda.empty_cache()

    def probe_us(pid, b, t, variant):
        """The probe's own graph-replay reading of a B 1 shape."""
        if b != 1:
            return None
        if pid == "P1":
            key = f"taps_tb{t}_" + ("with_copies" if variant else "aligned")
        else:
            key = f"im2col_lin_tb{t}" if variant else f"im2col_tb{t}"
        return results[key]["us"]

    rows = {}
    for pid, r in readings.items():
        entries = {k: dict(v, probe_us=probe_us(pid, *k))
                   for k, v in r.items()}
        main = entries.pop(SUB_ROW)
        rows[pid] = dict(main, also=list(entries.values()))
    rows["P3"] = dict(p3, probe_us=None, also=[])
    print(f"subsampling probe phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows, launches


def subsampling_kernel_rows(rows: dict, launches: dict) -> list:
    """The kernels line's rows of P1-P3: P1 and P2 the redesign
    (``csrc/subsampling_ws.cu``), with the ring's readings under ``ring``;
    P3 the bulk copy (``csrc/smem_probe_ws.cu``), with the kept kernel's
    readings under ``kept`` and an empty kernel's under ``floor``."""
    return [{
        "name": f"{pid} {wrapper}", "route": "cuda",
        "source": ("gigaam_tpu_torch/csrc/smem_probe_ws.cu" if pid == "P3"
                   else "gigaam_tpu_torch/csrc/subsampling_ws.cu"),
        "replaces": repl, "launches": launches[wrapper], "status":
        "redesigned", **{
            key: rows[pid][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "sum_ms", "graph_ms", "library_cl_ms",
                "probe_us", "shape", "also") + tuple(
                    k for k in ("ring", "kept", "floor", "library_sum_ms",
                                "library_graph_ms", "blocks_per_sm")
                    if k in rows[pid])}}
        for pid, (wrapper, repl, _) in SUB_PROBES.items()]


# P6-P8, the attention-fold probes: the scripts' shapes, then the main
# path's B 16, T' 500 (K1's call) and, for P7, B 1, T' 500 (K2's); the JSON
# rows at B 16, T' 500, the planted faults at B 8, T 512.  P6 runs where its
# nb divides B; P8 at its script's (B, T, nb) and at B 16 with nb 2, K1's
# own row tile there
ATTN_FOLD_SHAPES = ((8, 512), (32, 512), (16, 768), (128, 768), (16, 500),
                    (1, 500))
ATTN_FOLD_LNRES_NB = {(8, 512): 1, (32, 512): 1, (128, 768): 4, (16, 500): 2}
ATTN_FOLD_MAIN, ATTN_FOLD_FAULTS = (16, 500), (8, 512)
# label -> (wrapper, nb, the `pallas_call` it replaces)
ATTN_FOLD = {
    "P6 nb2": ("fold_nb", 2, "benchmarks/pallas_attn_fold_probe.py:205"),
    "P6 nb4": ("fold_nb", 4, "benchmarks/pallas_attn_fold_probe.py:205"),
    "P7 foldA": ("fold_heads", 1, "benchmarks/pallas_attn_fold_probe.py:247"),
    "P7 foldB": ("fold_lane_slices", 1,
                 "benchmarks/pallas_attn_fold_probe.py:247"),
    "P8": ("fold_lnres", None, "benchmarks/pallas_attn_lnres_probe.py:123"),
}
# the probes' stages by kernel name: P8 and the kept kernels of P6/P7
# (foldA's Q/K/V GEMM is qkv_head_kernel), and P6/P7's redesign
ATTN_FOLD_STAGES = (("row pass", "ln_rope_kernel"), ("QKV GEMM", "qkv_"),
                    ("SDPA", "sdpa_kernel"),
                    ("output GEMM", "out_proj_kernel"))
ATTN_FOLD_WS_STAGES = (("row pass", "ln_rope_kernel"),
                       ("QKV GEMM", "fold_qkv_"),
                       ("SDPA", "sdpa_packed_ws_kernel"),
                       ("output GEMM", "fold_out_"))
# P8's: the same with its own output product (csrc/attn_lnres_ws.cu)
ATTN_LNRES_WS_STAGES = ATTN_FOLD_WS_STAGES[:3] + (("output GEMM",
                                                   "lnres_out_"),)
# every variant runs on its redesign (csrc/attn_fold_ws.cu, and for P8
# csrc/attn_lnres_ws.cu); the redesign against the kept kernels of
# csrc/attn_fold_probe.cu at every shape, in turns at these
ATTN_FOLD_REDESIGNED = ("P6 nb2", "P6 nb4", "P7 foldA", "P7 foldB", "P8")
ATTN_FOLD_AB_SHAPES = ((16, 500), (128, 768))
# at B 128 the plain version's fp32 scores alone would be 4.8 GB: the
# kernel runs on the whole batch and its first and last rows are held to
# the plain version on those rows (rows are independent, so this is exact)
SAMPLED_ROWS = 8


def compared_rows(b: int) -> torch.Tensor:
    if b <= 2 * SAMPLED_ROWS:
        return torch.arange(b)
    return torch.cat([torch.arange(SAMPLED_ROWS),
                      torch.arange(b - SAMPLED_ROWS, b)])


def attn_fold_kernel(afp, label: str, w, x, valid, nb: int):
    wrapper = getattr(afp, ATTN_FOLD[label][0])
    if wrapper in (afp.fold_nb, afp.fold_lnres):
        return wrapper(w, x, valid, nb)
    return wrapper(w, x, valid)


def attn_fold_plain(afp, label: str, w, x, valid):
    if label == "P8":
        return afp.lnres_plain(w, x, valid)
    return afp.fold_plain(w, x, valid, heads=label == "P7 foldA")


def attn_fold_schedule(afp, label: str, nb: int) -> int:
    """The redesign's schedule that a redesigned variant's wrapper runs."""
    if label == "P7 foldA":
        return afp.FOLDA_SCHEDULE
    return afp.FOLDB_SCHEDULE if label == "P7 foldB" else afp.NB_SCHEDULE[nb]


def ws_stages(label: str):
    return ATTN_LNRES_WS_STAGES if label == "P8" else ATTN_FOLD_WS_STAGES


def lnres_stage_checks(afp, w, x, valid, rows, b: int, t: int) -> None:
    """P8's stages, each on the card stage's input, held to its plain
    stage: the row pass with the LayerNorm (xn, xr), the Q/K/V product of
    its schedule (V on xn), the packed walk (on the compared rows) and the
    output product with the fp32 residual at each of P8's schedules (its
    three template instances), each two calls bit-equal."""
    f = w.fold
    label = f"P8 B={b} T={t}"
    sched = afp.NB_SCHEDULE[ATTN_FOLD_LNRES_NB[(b, t)]]
    xn, xr = fa.ln_rope(x, w.cos, w.sin, N_HEADS, f.ln_scale, f.ln_bias)
    xn_p, xr_p = fa.ln_rope_plain(x, w.cos, w.sin, N_HEADS, f.ln_scale,
                                  f.ln_bias)
    qkv = afp.qkv_ws(w, xr, xn, sched)
    o = afp.sdpa_packed_ws(*qkv, valid)
    checks = [("row pass xn", xn, xn_p, None),
              ("row pass xr", xr, xr_p, None)]
    checks += [(f"Q/K/V {n}", a.transpose(1, 2), r.transpose(1, 2), None)
               for n, a, r in zip("qkv", qkv, afp.qkv_plain(w, xr, xn))]
    checks.append(("SDPA", o[rows], afp.sdpa_packed_plain(
        *(a[rows] for a in qkv), valid[rows]), None))
    again = [afp.qkv_ws(w, xr, xn, sched), afp.sdpa_packed_ws(*qkv, valid)]
    same = (all(torch.equal(a, g) for a, g in zip(again[0], qkv))
            and torch.equal(again[1], o))
    out_ref = afp.out_residual_plain(w, o, x)
    for sc in afp.LNRES_SCHEDULES:
        got = afp.out_residual_ws(w, o, x, sc)
        same = same and torch.equal(afp.out_residual_ws(w, o, x, sc), got)
        checks.append((f"output, schedule {sc}", got, out_ref, x))
    errs = {}
    for name, got, ref, residual in checks:
        vv = valid[rows] if name == "SDPA" else valid
        errs[name], _ = check_kernel(f"{label} {name} stage", got, ref, vv, 1,
                                     (), residual=residual)
    if not same:
        raise AssertionError(f"{label}: two calls of a stage differ")
    print(f"  {label} stages against their plain stages, max_abs_err "
          + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
          + "; each two calls bit-equal", flush=True)


def stage_split(split: dict, stages) -> dict:
    return {stage: sum(v for k, v in split.items() if name in k)
            for stage, name in stages}


def attn_fold_faults(afp, label: str, w, x, valid, nb: int):
    """The planted faults, each fed through the variant's inputs (P8's
    LayerNorm and residual through what the kernel would return without
    them: foldB's kernel on x plus x, and on LN(x)); for the redesign two
    slips of its schedule, through its stages on the card: the packed o
    handed to the output product one head off, and each 64-row tile stored
    into its partner's rows (a consumer warpgroup storing into the other's
    tile; B T must be a multiple of 128)."""
    f = w.fold
    call = lambda ww=w, vv=valid: attn_fold_kernel(afp, label, ww, x, vv, nb)
    fold = lambda **kw: dataclasses.replace(w, fold=dataclasses.replace(f, **kw))
    zero = lambda a: None if a is None else torch.zeros_like(a)
    faults = [
        ("RoPE sign flipped", lambda: call(dataclasses.replace(w, sin=-w.sin))),
        ("key mask ignored", lambda: call(vv=torch.ones_like(valid))),
        ("bq left unscaled", lambda: call(fold(bq=f.bq * math.sqrt(D_HEAD)))),
        ("q zeroed", lambda: call(dataclasses.replace(
            fold(wq=zero(f.wq), bq=zero(f.bq)), wq_heads=zero(w.wq_heads)))),
        ("Wv swapped for Wk", lambda: call(fold(wv=f.wk, bv=f.bk)))]
    if label == "P7 foldA":
        faults.append(("head h reading head h+1's weight block",
                       lambda: call(dataclasses.replace(
                           w, wq_heads=w.wq_heads.roll(-1, 0).contiguous(),
                           wk_heads=w.wk_heads.roll(-1, 0).contiguous()))))
    if label in ATTN_FOLD_REDESIGNED:
        sched = attn_fold_schedule(afp, label, nb)

        def o_one_head_off():
            if label == "P8":
                xn, xr = fa.ln_rope(x, w.cos, w.sin, N_HEADS, f.ln_scale,
                                    f.ln_bias)
                o = afp.sdpa_packed_ws(*afp.qkv_ws(w, xr, xn, sched), valid)
                return afp.out_residual_ws(
                    w, o.roll(D_HEAD, -1).contiguous(), x, sched)
            xr = fa.ln_rope(x, w.cos, w.sin, N_HEADS)[1]
            o = afp.sdpa_packed_ws(*afp.qkv_ws(w, xr, x, sched), valid)
            return afp.out_ws(w, o.roll(D_HEAD, -1).contiguous(), sched)

        faults += [
            ("the packed o one head off", o_one_head_off),
            ("each 64-row tile stored into its partner's rows",
             lambda: call().reshape(-1, 2, 64, D_MODEL).flip(1).reshape(
                 x.shape))]
    if label == "P8":
        xn = fa.ln_rope_plain(x, w.cos, w.sin, N_HEADS, f.ln_scale,
                              f.ln_bias)[0]
        faults += [
            ("LayerNorm skipped",
             lambda: x + afp.fold_lane_slices(w, x, valid)),
            ("residual left out", lambda: afp.fold_lane_slices(w, xn, valid))]
    return faults


def timed(fn, x) -> dict:
    """ms by CUDA events, by the profile's kernel sum and by
    ``device_timeit``'s graph replays (40 calls a replay), and the profile's
    kernel times by name."""
    graph_ms = device_timeit(lambda _: fn(), [x], k=40) * 1e3
    split = checked_split(fn, graph_ms)
    return dict(ms=time_ms(fn), sum_ms=sum(split.values()),
                graph_ms=graph_ms, split=split)


def attn_fold_ring_ab(afp, label: str, w, x, valid, nb: int, rows, ref,
                      kernel, got, times: dict, b: int, t: int) -> dict:
    """A redesigned variant against the kernels it replaced (``fold_ring``,
    P8's ``lnres_ring``) at one shape: those held to the plain version too,
    compared with the redesign bit for bit and timed (events, the
    profile's sum with its four stages, graph replays); at
    ATTN_FOLD_AB_SHAPES the two timed in turns instead (redesign, kept,
    kept, redesign; the mean of each pair)."""
    name = f"{label} B={b} T={t}"
    lnres = label == "P8"
    if lnres:
        ring = lambda: afp.lnres_ring(w, x, valid, nb)
    else:
        ring = lambda: afp.fold_ring(w, x, valid, nb,
                                     heads=label == "P7 foldA")
    old_out = ring()
    err, _ = check_kernel(f"{name} (the kept kernels)", old_out[rows], ref,
                          valid[rows], 1, (),
                          residual=x[rows] if lnres else None)
    same = torch.equal(old_out, got)
    del old_out
    turns = (b, t) in ATTN_FOLD_AB_SHAPES
    if turns:
        k_t, k_split, rt, r_split = ab_times(kernel, ring, got)
    else:
        rt = timed(ring, x)
        r_split = rt["split"]
    old = dict(max_abs_err=err, ms=rt["ms"], sum_ms=rt["sum_ms"],
               graph_ms=rt["graph_ms"],
               stages_ms=stage_split(r_split, ATTN_FOLD_STAGES),
               bit_equal_to_redesign=same)
    new = stage_split(times["split"], ws_stages(label))
    print(f"  {name} A/B (bit-equal: {same}): the kept kernels "
          f"{times_text(rt)} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in old["stages_ms"].items())
          + f"); the redesign {times_text(times)} ("
          + ", ".join(f"{k} {v:.4f}" for k, v in new.items())
          + f"); redesign / kept {times['sum_ms'] / rt['sum_ms']:.3f} card, "
          f"{times['graph_ms'] / rt['graph_ms']:.3f} graph, "
          f"{times['ms'] / rt['ms']:.3f} events", flush=True)
    if turns:
        old["in_turns"] = {"redesign": k_t, "kept": rt}
        print(f"  {name} A/B in turns (the mean of two each): the kept "
              f"kernels {times_text(rt)}; the redesign {times_text(k_t)}; "
              f"redesign / kept {k_t['sum_ms'] / rt['sum_ms']:.3f} card, "
              f"{k_t['graph_ms'] / rt['graph_ms']:.3f} graph, "
              f"{k_t['ms'] / rt['ms']:.3f} events; the redesign by stage "
              + json.dumps(stage_split(k_split, ws_stages(label))),
              flush=True)
    return old


def attn_fold_probe_phase(dev):
    """P6-P8: each variant against its plain version at ATTN_FOLD_SHAPES on
    peaked weights (``attention_params``) and the scripts' ragged lengths,
    three calls bit-equal, the planted faults at ATTN_FOLD_FAULTS; each
    timed (events, profile sum with its four stages, graph replays) beside
    its bound, its plain version, the script's baseline, K2 (P8: K1) and
    the lean stock path; P8's stages and its three output instances
    against their plain stages (``lnres_stage_checks``); each redesign
    against the kernels it replaced (``attn_fold_ring_ab``); P8 against K1
    and both against the fp32 module; then the probes' own ``main`` from
    zeroed launch counts.
    Returns ({row name: JSON row}, {wrapper: launches in ``main``})."""
    from gigaam_tpu_torch.probes import attn_fold_probes as afp

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(11)
    bf = torch.bfloat16
    readings = defaultdict(dict)
    for b, t in ATTN_FOLD_SHAPES:
        attn, ln = attention_params(gen, dev)
        x = attention_input(gen, b, t, dev)
        valid = torch.from_numpy(afp.ragged_valid(b, t)).to(dev)
        cos, sin, cos_w, sin_w, r = afp._tables(t, dev)
        weights = {
            "P7": afp.prepare_fold(attn, cos_w, sin_w, r, bf,
                                   per_head_weights=True, divide=True),
            "P6": afp.prepare_fold(attn, cos_w, sin_w, r, bf),
            "P8": afp.prepare_fold(attn, cos_w, sin_w, r, bf, ln_params=ln)}
        mask = valid[:, None, None, :]
        lcos, lsin = afp.lean_tables(cos, sin, bf)
        p16 = {n: {k: v.to(bf) for k, v in p.items()} for n, p in attn.items()}
        lw, lw8 = afp.lean_weights(attn, bf), afp.lean_weights(attn, bf, ln)
        w6, w8 = weights["P6"], weights["P8"]
        stock = {
            "fold": {"baseline": lambda: afp.baseline(p16, x, cos, sin, valid),
                     "K2": lambda: fa.folded_rotary_attention(
                         w6.fold, x, cos, sin, valid, N_HEADS),
                     "lean": lambda: afp.fold_lean(lw, x, lcos, lsin, mask)},
            "lnres": {"baseline": lambda: afp.lnres_baseline(w8, ln, x, valid),
                      "K1": lambda: fa.folded_rotary_attention_lnres(
                          w8.fold, x, cos, sin, valid, N_HEADS),
                      "lean": lambda: afp.lnres_lean(lw8, x, lcos, lsin,
                                                     mask)}}
        stock_ms = {}
        rows = compared_rows(b).to(dev)
        xs, vs = x[rows], valid[rows]
        for label, (wrapper, nb, _) in ATTN_FOLD.items():
            lnres = label == "P8"
            if lnres:
                nb = ATTN_FOLD_LNRES_NB.get((b, t))
            if nb is None or b % nb or (label.startswith("P6") and b == 1):
                continue
            w = weights[label[:2]]
            kernel = lambda: attn_fold_kernel(afp, label, w, x, valid, nb)
            got = kernel()
            if not all(torch.equal(kernel(), got) for _ in range(2)):
                raise AssertionError(f"{label} B={b} T={t}: three calls did "
                                     f"not give the same bits")
            ref = attn_fold_plain(afp, label, w, xs, vs)
            faults = (attn_fold_faults(afp, label, w, x, valid, nb)
                      if (b, t) == ATTN_FOLD_FAULTS else ())
            err, rel = check_kernel(
                f"{label} {wrapper} B={b} T={t} nb {nb}", got[rows], ref, vs,
                1, [(name, lambda fn=fn: fn()[rows]) for name, fn in faults],
                residual=xs if lnres else None)
            kind = "lnres" if lnres else "fold"
            if kind not in stock_ms:
                stock_ms[kind] = {k: timed(fn, x) for k, fn in
                                  stock[kind].items()}
                if (b, t) == ATTN_FOLD_MAIN:
                    # where the stock paths' device time goes, by kernel
                    for name, st in stock_ms[kind].items():
                        top = sorted(st["split"].items(),
                                     key=lambda kv: -kv[1])[:8]
                        print(f"  {kind} {name} B={b} T={t} on the card by "
                              f"kernel (sum {st['sum_ms']:.4f} ms): "
                              + json.dumps([[k[:60], round(v, 4)]
                                            for k, v in top]), flush=True)
            if lnres:
                lnres_stage_checks(afp, w, x, valid, rows, b, t)
            times = timed(kernel, x)
            redesigned = label in ATTN_FOLD_REDESIGNED
            stages = stage_split(times["split"], ws_stages(label)
                                 if redesigned else ATTN_FOLD_STAGES)
            plain_ms = time_ms(lambda: attn_fold_plain(afp, label, w, xs, vs),
                               iters=3, warmup=1)
            bms, by = fold_bound(b, t, lnres)
            sm = stock_ms[kind]
            own = "K1" if lnres else "K2"
            print(f"{label} {wrapper} B={b} T={t} nb {nb}: max_abs_err "
                  f"{err:.3e}, {rel:.4f} x RMS (limit {KERNEL_REL}), three "
                  f"calls bit-equal; kernel {times['ms']:.4f} ms by events, "
                  f"{times['sum_ms']:.4f} on the card ("
                  + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
                  + f"), {times['graph_ms']:.4f} by graph replays; plain "
                  f"{plain_ms:.4f} ms" + ("" if len(rows) == b else
                                          f" on {len(rows)} of {b} rows")
                  + f"; bound {bms:.4f} ms ({by}); baseline "
                  f"{sm['baseline']['sum_ms']:.4f} card / "
                  f"{sm['baseline']['graph_ms']:.4f} graph, {own} "
                  f"{sm[own]['sum_ms']:.4f} / {sm[own]['graph_ms']:.4f}, lean "
                  f"{sm['lean']['sum_ms']:.4f} / {sm['lean']['graph_ms']:.4f}",
                  flush=True)
            reading = dict(
                shape=f"B {b}, T' {t}, nb {nb}", max_abs_err=err,
                ms=times["ms"], sum_ms=times["sum_ms"],
                graph_ms=times["graph_ms"], stages_ms=stages,
                plain_ms=plain_ms, plain_rows=len(rows), bound_ms=bms,
                bound_by=by, library_ms=sm["lean"]["ms"],
                library_sum_ms=sm["lean"]["sum_ms"],
                library_graph_ms=sm["lean"]["graph_ms"],
                baseline_ms=sm["baseline"]["ms"],
                baseline_sum_ms=sm["baseline"]["sum_ms"],
                baseline_graph_ms=sm["baseline"]["graph_ms"],
                **{f"{own}_{k}": sm[own][k]
                   for k in ("ms", "sum_ms", "graph_ms")})
            if lnres:
                reading["k1_vs_p8"] = p8_against_k1(
                    afp, attn, ln, w, x, valid, got, rows, b, t)
            if redesigned:
                reading["kept"] = attn_fold_ring_ab(
                    afp, label, w, x, valid, nb, rows, ref, kernel, got,
                    times, b, t)
            readings[label][(b, t)] = reading
            del got, ref, faults, kernel
        del x, weights, stock, stock_ms, w6, w8
        torch.cuda.empty_cache()

    # the probes' main path: their main, both scripts at their shapes
    afp.reset_launch_counts()
    results = afp.main()
    launches = {fn.__name__: fn.launches for fn in afp.KERNELS}
    print("attn_fold_probes " + json.dumps(results), flush=True)
    print(f"attn_fold_probes launches {launches}", flush=True)
    if not all(launches.values()):
        raise AssertionError(f"the attention-fold probes' main launched "
                             f"{launches}")
    torch.cuda.empty_cache()
    main_key = {"P6 nb2": "foldC_nb2_us", "P6 nb4": "foldC_nb4_us",
                "P7 foldA": "foldA_us", "P7 foldB": "foldB_laneslice_us",
                "P8": "foldLN_us"}
    rows = {}
    for label, r in readings.items():
        script = "lnres" if label == "P8" else "fold"
        entries = [dict(v, probe_us=results[script][f"b{b}_t{t}"][
            main_key[label]] if f"b{b}_t{t}" in results[script] else None)
            for (b, t), v in r.items()]
        main = next(e for (b, t), e in zip(r, entries)
                    if (b, t) == ATTN_FOLD_MAIN)
        rows[label] = dict(main, also=[e for e in entries if e is not main])
    # P6's one wrapper: nb 2's row, nb 4's readings under "also"
    nb4 = rows.pop("P6 nb4")
    rows["P6 nb2"]["also"] += [nb4] + nb4.pop("also")
    print(f"attention-fold probe phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return rows, launches


def p8_against_k1(afp, attn, ln, w, x, valid, got, rows, b: int, t: int):
    """Where the residual is rounded: P8 (added to the fp32 accumulator)
    against K1 (added in bf16 to the rounded output) on the same inputs, and
    each against the module in fp32 (the plain version on fp32 weights and
    the widened x, no rounding point), on the compared rows' valid frames;
    in absolute terms and in units of the RMS of the module term."""
    cos_w, sin_w = w.cos.repeat(1, N_HEADS), w.sin.repeat(1, N_HEADS)
    r = torch.from_numpy(afp.rope_tables_wide(w.cos[:1].cpu().numpy(),
                                              w.sin[:1].cpu().numpy())[2])
    w32 = afp.prepare_fold(attn, cos_w, sin_w, r.to(x.device), torch.float32,
                           ln_params=ln)
    xs, vs = x[rows], valid[rows]
    ref = afp.lnres_plain(w32, xs.float(), vs)[vs]
    k1 = fa.folded_rotary_attention_lnres(w.fold, x, w.cos, w.sin, valid,
                                          N_HEADS)[rows][vs].float()
    p8 = got[rows][vs].float()
    rms = float((ref - xs[vs].float()).pow(2).mean().sqrt())
    out = {}
    for name, a, bb in (("p8_minus_k1", p8, k1), ("p8_minus_fp32", p8, ref),
                        ("k1_minus_fp32", k1, ref)):
        d = (a - bb).abs()
        out[name] = {"max_abs": float(d.max()),
                     "max_in_rms": float(d.max()) / rms,
                     "mean_abs": float(d.mean()),
                     "rms_in_rms": float(d.pow(2).mean().sqrt()) / rms}
    print(f"P8 against K1 B={b} T={t}: " + "; ".join(
        f"{k} max {v['max_abs']:.3e} ({v['max_in_rms']:.4f} x RMS of the "
        f"module term), mean {v['mean_abs']:.3e}, RMS "
        f"{v['rms_in_rms']:.5f} x" for k, v in out.items()), flush=True)
    return out


def attn_fold_probe_kernel_rows(rows: dict, launches: dict) -> list:
    """The kernels line's rows of P6, P7 (foldA and foldB) and P8, each
    redesigned (the kept kernels' readings under ``kept``; P8's source is
    its output product's, its other stages are P6's)."""
    names = {"P6 nb2": "P6", "P7 foldA": "P7 foldA", "P7 foldB": "P7 foldB",
             "P8": "P8"}
    return [{
        "name": f"{names[label]} {ATTN_FOLD[label][0]}", "route": "cuda",
        "source": ("gigaam_tpu_torch/csrc/attn_lnres_ws.cu" if label == "P8"
                   else "gigaam_tpu_torch/csrc/attn_fold_ws.cu"
                   if label in ATTN_FOLD_REDESIGNED
                   else "gigaam_tpu_torch/csrc/attn_fold_probe.cu"),
        "status": ("redesigned" if label in ATTN_FOLD_REDESIGNED
                   else "ported"),
        "replaces": ATTN_FOLD[label][2],
        "launches": launches[ATTN_FOLD[label][0]], **rows[label]}
        for label in names]


def counts() -> dict:
    return {"K3": fa.fused_mha.launches,
            "K2": fa.folded_rotary_attention.launches,
            "K1": fa.folded_rotary_attention_lnres.launches,
            "K5": fa.fused_relpos_mha.launches,
            "K4": fa.mha_bwd.launches,
            "K6": fa.relpos_mha_bwd.launches}


def by_group(ms_by_kernel: dict) -> dict:
    """Device ms by PROFILE_GROUPS group of {kernel name: ms}."""
    groups = defaultdict(float)
    for name, ms in ms_by_kernel.items():
        group = next(g for g, pattern in PROFILE_GROUPS
                     if re.search(pattern, name, re.IGNORECASE))
        groups[group] += ms
    return groups


def profile_calls(label: str, fn, calls: int, wall_ms: float) -> dict:
    """Print (and return) device busy time, idle share, launches and device
    time by group per call of ``fn``, from ``calls`` calls under
    ``torch.profiler``, and the host seconds the profile took, its calls
    included (``profile_s``)."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {name: (us / 1e3 / calls, n // calls)
               for name, (us, n) in device_kernels(prof).items() if us > 0}
    groups = by_group({name: ms for name, (ms, _) in kernels.items()})
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    record = {
        "call": label, "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "launches": sum(n for _, n in kernels.values()),
        "groups_ms": groups,
        "top_kernels": [[k[:90], ms, n] for k, (ms, n) in top],
        "profile_s": time.perf_counter() - t0}
    print("  profile " + json.dumps(record), flush=True)
    return record


def run_path(label: str, fn, kernel: str, n_layers: int, calls: int = 3,
             profiled: bool = True):
    """Warm ``fn`` once, then run it ``calls`` times from zeroed counts and
    assert that only ``kernel``'s wrapper ran, once per layer per call; then
    (``profiled``) profile ``calls`` more calls.  The wall time per call
    comes from the unprofiled calls.  Returns (the last output, the kernel's
    launches, the profile's record, or only the wall without a profile)."""
    fn()
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    got = counts()
    want = {k: (n_layers * calls if k == kernel else 0) for k in got}
    print(f"main path {label}: {wall_ms:.2f} ms per call (wall, after "
          f"warm-up), launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    if not profiled:
        return out, got[kernel], {"call": label, "wall_ms": wall_ms}
    return out, got[kernel], profile_calls(label, fn, calls, wall_ms)


def main_path(model, rng, card: str) -> dict:
    n_layers = model.cfg.encoder.n_layers
    launches = {}
    wav20 = synth_wav(20.0, rng)
    res, launches["K2"], _ = run_path(
        "transcribe 20 s, batch 1 (K2)",
        lambda: model.transcribe(wav20, word_timestamps=True), "K2", n_layers)
    if not (isinstance(res.text, str) and isinstance(res.words, list)):
        raise AssertionError(f"transcribe returned {res!r}")
    print(f"  transcribe: {len(res.text)} chars, {len(res.words)} words; "
          f"card {card}", flush=True)

    wavs16 = [synth_wav(s, rng) for s in np.linspace(10.0, 20.0, 16)]
    outs, launches["K1"], _ = run_path(
        "_decode_batch 16 x 10-20 s (K1)",
        lambda: model._decode_batch(wavs16, word_timestamps=True), "K1",
        n_layers)
    if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
        raise AssertionError("_decode_batch returned a malformed batch")
    print(f"  _decode_batch: 16 results; card {card}", flush=True)

    wav_long = synth_wav(K3_SECONDS, rng)
    (enc, enc_len), launches["K3"], _ = run_path(
        f"encode_batch {K3_SECONDS:.0f} s, T'={K3_T} (K3)",
        lambda: model.encode_batch([wav_long]), "K3", n_layers)
    if (tuple(enc.shape) != (1, K3_T, D_MODEL) or int(enc_len[0]) != K3_T
            or not bool(torch.isfinite(enc).all())):
        raise AssertionError(f"encode_batch: {tuple(enc.shape)}, "
                             f"len {enc_len.tolist()}")
    print(f"  encode_batch: {tuple(enc.shape)} finite; card {card}", flush=True)
    return launches


def relpos_main_path(asr, emo, rng, card: str) -> int:
    """v2_ctc ``transcribe`` 20 s and ``_decode_batch`` 16 x 10-20 s
    (T' = 501), emo ``get_probs`` 10 s (T' = 251): K5 in every layer, none
    of K1-K3.  Returns K5's launches over the three paths."""
    n_layers = asr.cfg.encoder.n_layers
    wav20 = synth_wav(20.0, rng)
    res, n_transcribe, _ = run_path(
        "v2_ctc transcribe 20 s, batch 1 (K5)",
        lambda: asr.transcribe(wav20, word_timestamps=True), "K5", n_layers)
    if not (isinstance(res.text, str) and isinstance(res.words, list)):
        raise AssertionError(f"transcribe returned {res!r}")
    print(f"  v2_ctc transcribe: {len(res.text)} chars, {len(res.words)} "
          f"words; card {card}", flush=True)

    wavs16 = [synth_wav(s, rng) for s in np.linspace(10.0, 20.0, 16)]
    outs, n_batch, _ = run_path(
        "v2_ctc _decode_batch 16 x 10-20 s (K5)",
        lambda: asr._decode_batch(wavs16, word_timestamps=True), "K5",
        n_layers)
    if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
        raise AssertionError("_decode_batch returned a malformed batch")
    print(f"  v2_ctc _decode_batch: 16 results; card {card}", flush=True)

    wav10 = synth_wav(10.0, rng)
    probs, n_emo, _ = run_path("emo get_probs 10 s, T'=251 (K5)",
                            lambda: emo.get_probs(wav10), "K5",
                            emo.cfg.encoder.n_layers)
    values = np.array(list(probs.values()))
    if (list(probs) != emo.id2name or not np.isfinite(values).all()
            or abs(values.sum() - 1.0) > 1e-3):
        raise AssertionError(f"get_probs returned {probs}")
    print(f"  emo get_probs: {probs}; card {card}", flush=True)
    return n_transcribe + n_batch + n_emo


def nonzero_pos_biases(model, seed: int) -> None:
    """Draw ``pos_bias_u``/``pos_bias_v`` (zero in a fresh init, as in the
    JAX package) from ``seed``, apart from each other, so that a u/v swap
    changes the output."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in model.encoder.layers:
            for name in ("pos_bias_u", "pos_bias_v"):
                p = layer["self_attn"][name]
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))


def v2_ctc(device=None):
    model = gt.load_model("v2_ctc", init="random", seed=0, device=device)
    nonzero_pos_biases(model, seed=1)
    return model


def reference_phase(model, cpu, rng, paths, long_s: float = 42.0) -> None:
    """CUDA bf16 against the port's CPU fp32 on the same weights, on small
    inputs through each attention path: 4 s at batch 1, 16 clips of 1-2 s
    and ``long_s`` at batch 1 (42 s: T' = 1051 with v2's centred frames;
    v3 takes K3_SECONDS, past the fold); ``paths`` names the kernel of
    each."""
    cases = ((f"4 s, batch 1 ({paths[0]})", [synth_wav(4.0, rng)]),
             (f"16 x 1-2 s ({paths[1]})", [synth_wav(s, rng)
                                           for s in np.linspace(1.0, 2.0, 16)]),
             (f"{long_s:.0f} s, batch 1 ({paths[2]})",
              [synth_wav(long_s, rng)]))
    name = model.cfg.model_name
    for label, wavs in cases:
        with torch.inference_mode():
            enc_g, len_g = model.encode_batch(wavs)
            enc_c, len_c = cpu.encode_batch(wavs)
            ids_g = ctc_log_probs(model.head, enc_g).argmax(-1).cpu()
            ids_c = ctc_log_probs(cpu.head, enc_c).argmax(-1)
        enc_g, len_g = enc_g.float().cpu(), len_g.cpu()
        if not torch.equal(len_g, len_c) or not bool(torch.isfinite(enc_g).all()):
            raise AssertionError(f"{label}: lengths differ or output not finite")
        rows = torch.arange(enc_c.shape[1])[None, :] < len_c[:, None]
        diff, ref = (enc_g - enc_c)[rows], enc_c[rows]
        max_abs = float(diff.abs().max())
        rel = float(diff.norm() / ref.norm())
        agree = float((ids_g == ids_c)[rows].float().mean())
        print(f"reference {name} {label}, T'={enc_c.shape[1]}: CUDA bf16 vs "
              f"CPU fp32 encoder max_abs {max_abs:.4f}, relative {rel:.4f} "
              f"(tol {ENCODER_RTOL}); greedy ids agree on {agree:.4f} of "
              f"frames", flush=True)
        if not rel <= ENCODER_RTOL:
            raise AssertionError(f"{label}: encoder relative error {rel} > "
                                 f"{ENCODER_RTOL}")


# ---------------------------------------------------------------------------
# Fine-tuning
# ---------------------------------------------------------------------------

def write_train_set(root: str, rng, n: int, lo: float, hi: float) -> str:
    """``n`` synthetic clips of ``lo``-``hi`` seconds as 16-bit WAVs with
    random transcripts over the model's characters; returns the manifest."""
    rows = []
    for i, seconds in enumerate(np.linspace(lo, hi, n)):
        path = os.path.join(root, f"clip{i:02d}.wav")
        save_wav(path, synth_wav(float(seconds), rng))
        n_chars = int(rng.integers(int(2 * seconds), int(4 * seconds)))
        text = "".join(rng.choice(RU_VOCAB, size=n_chars))
        rows.append((path, float(seconds), " ".join(text.split()) or "а"))
    manifest = os.path.join(root, "train.tsv")
    write_manifest(manifest, rows)
    return manifest


def snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def assert_training_moved(label: str, ft, before: dict) -> None:
    """Every trainable leaf and every BatchNorm buffer differs from
    ``before``; the positional parameters hold a nonzero gradient."""
    stuck = [n for n, p in ft.model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    if stuck:
        raise AssertionError(f"{label}: {len(stuck)} leaves did not move, "
                             f"e.g. {stuck[:3]}")
    n_pos = 0
    for name, p in ft.model.named_parameters():
        if any(k in name for k in ("pos_bias_u", "pos_bias_v", "linear_pos")):
            n_pos += 1
            if p.grad is None or not float(p.grad.abs().max()) > 0.0:
                raise AssertionError(f"{label}: {name} got no gradient")
    print(f"  {label}: all {len(before)} leaves moved (BatchNorm mean/var "
          f"included); {n_pos} positional leaves hold a nonzero gradient",
          flush=True)


def drive_train_steps(label: str, ft, batch, steps: int, want: dict,
                      card: str, records: list = None) -> dict:
    """``steps`` calls of ``train_step`` from zeroed counts, each timed and
    held to ``want`` launches; returns the launches over all steps.  Each
    step's wall ms, phase ms, loss and peak GiB go into ``records``."""
    total = defaultdict(int)
    marks = []

    def mark(name: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    ft.on_phase = mark
    for step in range(steps):
        marks.clear()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ft.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        got = counts()
        for k, n in got.items():
            total[k] += n
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        phases = {b_[0]: a[1].elapsed_time(b_[1])
                  for a, b_ in zip(marks, marks[1:])}
        print(f"train {label} step {step + 1}: {wall_ms:.1f} ms wall, "
              f"forward {phases['forward']:.1f} backward "
              f"{phases['backward']:.1f} optimizer {phases['optimizer']:.1f} "
              f"ms (CUDA events), loss {loss:.4f}, grad_norm {gnorm:.3f}, "
              f"lr {m['lr']:.2e}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"launches {got}; card {card}", flush=True)
        if records is not None:
            records.append({
                "wall_ms": wall_ms, "loss": loss, **{
                    f"{k}_ms": v for k, v in phases.items()},
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if not (math.isfinite(loss) and loss > 0 and math.isfinite(gnorm)
                and gnorm > 0):
            raise AssertionError(f"{label}: loss {loss}, grad_norm {gnorm}")
    ft.on_phase = None
    profile_calls(f"train_step {label}", lambda: ft.train_step(batch), 1,
                  wall_ms)
    return total


def first_batch(manifest: str, tokenizer, batch_size: int, stride: int = 1):
    """The first duration-sorted batch of every ``stride``-th clip."""
    ds = AudioDataset(manifest, tokenizer=tokenizer, return_tokens=True)
    ds.samples = ds.samples[::stride]
    return next(iter(ds.batches(batch_size, sort_by_duration=True)))


def training_path(model_v3, model_v2, manifest: str, card: str) -> dict:
    """The CLI for v3_ctc, then ``FineTuner`` directly for v2_ctc, for v3_ctc
    and for v3_ctc with activation checkpointing; returns the launches."""
    n_layers = model_v3.cfg.encoder.n_layers
    save_dir = os.path.join(os.path.dirname(manifest), "exp")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    train_cli.main([
        "--model_name", "v3_ctc", "--init", "random", "--seed", "0",
        "--train_manifest", manifest, "--val_manifest", manifest,
        "--batch_size", "16", "--precision", "bf16", "--max_steps", "4",
        "--spec_augment", "--val_first_batches", "1", "--save_top_k", "0",
        "--log_every_n_steps", "1", "--save_dir", save_dir])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    got = counts()
    # 4 train steps (K3 forward, K4 backward), one validation batch at the
    # end of the first epoch and one at the end (K1)
    want = {"K3": 4 * n_layers, "K4": 4 * n_layers, "K1": 2 * n_layers}
    print(f"main path train CLI v3_ctc, 4 steps + 2 validation batches: "
          f"{cli_s:.1f} s, launches {got}; card {card}", flush=True)
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"train CLI: launches {got}, expected {want}")
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if r["kind"] == "train"]
    if len(train_recs) != 4 or not all(
            math.isfinite(r["loss"]) and r["loss"] > 0
            and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
            for r in train_recs):
        raise AssertionError(f"train CLI: metrics {train_recs}")
    if not os.path.exists(os.path.join(save_dir, "final.npz")):
        raise AssertionError("train CLI wrote no final.npz")
    print("  CLI losses " + ", ".join(f"{r['loss']:.4f}" for r in train_recs)
          + "; val " + ", ".join(f"{r['loss']:.4f}" for r in recs
                                  if r["kind"] == "val"), flush=True)
    launches = defaultdict(int, got)
    torch.cuda.empty_cache()

    tc = TrainConfig(total_steps=4, precision="bf16")
    # every other of the 32 clips: 16 clips that span 10-20 s (T' = 500)
    batch = first_batch(manifest, model_v2.tokenizer, 16, stride=2)
    ft = FineTuner(model_v2, tc)
    before = snapshot(model_v2)
    total = drive_train_steps("v2_ctc", ft, batch, 3,
                              {"K5": n_layers, "K6": n_layers}, card)
    assert_training_moved("v2_ctc", ft, before)
    for k, n in total.items():
        launches[k] += n
    del ft, before
    torch.cuda.empty_cache()

    ft = FineTuner(model_v3, tc)
    before = snapshot(model_v3)
    fa.reset_launch_counts()
    loss0, _ = ft.eval_step(batch)
    if counts()["K1"] != n_layers:
        raise AssertionError(f"eval_step: launches {counts()}")
    total = drive_train_steps("v3_ctc", ft, batch, 3,
                              {"K3": n_layers, "K4": n_layers}, card)
    assert_training_moved("v3_ctc", ft, before)
    for k, n in total.items():
        launches[k] += n
    del before
    ft = FineTuner(model_v3, dataclasses.replace(
        tc, activation_checkpointing=True))
    total = drive_train_steps("v3_ctc, activation checkpointing", ft, batch,
                              3, {"K3": 2 * n_layers, "K4": n_layers}, card)
    for k, n in total.items():
        launches[k] += n
    # eval_step goes through K1, whose prepared weights must follow the
    # optimizer's updates
    fa.reset_launch_counts()
    loss1, hyps = ft.eval_step(batch)
    got = counts()
    for layer in model_v3.encoder.layers:
        layer.clear_prepared()
    loss2, _ = ft.eval_step(batch)
    print(f"eval_step v3_ctc: loss {loss0:.4f} before training, {loss1:.4f} "
          f"after, {loss2:.4f} with freshly prepared folded weights; "
          f"launches {got}", flush=True)
    if got != {k: (n_layers if k == "K1" else 0) for k in got}:
        raise AssertionError(f"eval_step: launches {got}")
    if loss1 == loss0 or loss1 != loss2 or len(hyps) != 16:
        raise AssertionError("eval_step does not see the updated weights")
    return launches


GRAD_GROUPS = (
    ("pos biases and linear_pos", r"pos_bias_|linear_pos"),
    ("attention projections", r"self_attn\.linear_"),
    ("FFN", r"feed_forward"),
    ("conv module", r"\.conv\."),
    ("head", r"^head\."),
    ("norms and subsampling", r""),
)


def training_reference_phase(name: str, manifest: str) -> dict:
    """One train step at full width, 2 layers, batch 4: the card's bf16 loss
    and gradients against the CPU's fp32 ones on the same weights; on a
    rel-pos encoder (its pos biases drawn apart), K6 on the card step's own
    inputs against its plain version (``k6_step_check``).  Returns the
    readings."""
    cfg = make_preset(name)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    relpos = cfg.encoder.self_attention_model == "rel_pos"
    grads, losses = {}, {}
    batch = None
    k6 = None
    for device, precision in (("cuda", "bf16"), ("cpu", "fp32")):
        model = gt.GigaAMASR(cfg, device=device, seed=0)
        if relpos:
            nonzero_pos_biases(model, seed=1)
        if batch is None:
            batch = first_batch(manifest, model.tokenizer, 4)
        # no clipping, and the first update has lr 0: the gradients stay in
        # .grad as the backward left them
        ft = FineTuner(model, TrainConfig(total_steps=4, precision=precision,
                                          grad_clip=1e30))
        if device == "cuda" and relpos:
            with K6Recorder() as rec:
                losses[device] = float(ft.train_step(batch)["loss"])
            k6 = k6_step_check(f"{name} 2 layers, batch 4", rec.calls)
        else:
            losses[device] = float(ft.train_step(batch)["loss"])
        grads[device] = {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()
                         if p.grad is not None}
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    groups = defaultdict(lambda: [0.0, 0.0])
    for n, g_ref in grads["cpu"].items():
        group = next(g for g, pattern in GRAD_GROUPS if re.search(pattern, n))
        groups[group][0] += float((grads["cuda"][n] - g_ref).pow(2).sum())
        groups[group][1] += float(g_ref.pow(2).sum())
    rels = {g: math.sqrt(num / den) for g, (num, den) in groups.items()
            if den > 0}
    print(f"training reference {name}, 2 layers, batch 4, T' from "
          f"{batch[0].shape[1] / SAMPLE_RATE:.0f} s: loss CUDA bf16 "
          f"{losses['cuda']:.4f} vs CPU fp32 {losses['cpu']:.4f} (relative "
          f"{loss_rel:.4f}, tol {TRAIN_LOSS_RTOL}); gradient relative "
          f"Frobenius error by group (tol {TRAIN_GRAD_RTOL}): "
          + ", ".join(f"{g} {r:.4f}" for g, r in rels.items()), flush=True)
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{name}: loss relative error {loss_rel}")
    if not all(r <= TRAIN_GRAD_RTOL for r in rels.values()):
        raise AssertionError(f"{name}: gradient error {rels}")
    return {"loss_cuda": losses["cuda"], "loss_cpu": losses["cpu"],
            "loss_rel": loss_rel, "grad_rel_by_group": rels, "k6": k6}

# ---------------------------------------------------------------------------
# RNNT transcription and the SentencePiece tokenizer
# ---------------------------------------------------------------------------

# Added to the joint's blank logit.  A random joint argmaxes to a non-blank
# token at almost every step, so every frame would burn max_symbols steps;
# BLANK_ALL makes every step blank: exactly T' steps, the trip count of a
# trained model (benchmarks/run_benchmarks.py:160-167).  RNNT_BLANK_BIAS,
# fixed, makes the batch of 16 clips of seed 12 emit RNNT_RATE tokens a
# frame: the bias of the main-path calls.  It was read off a scan on the
# card (0.84: 0.62 tokens a frame, 0.85: 0.40, 0.86: 0.27): a random joint
# varies little with its input, so the rate falls steeply with the bias.
BLANK_ALL = 1e4
RNNT_BLANK_BIAS = 0.85
RNNT_RATE = (0.2, 0.6)
RNNT_CHUNKS = (16, 32, 64)
# the card's fp32 decode against the port's CPU fp32 decode of the same
# encoded batch: the same ops in another order (cuBLAS, MKL), log-probs of
# magnitude <= ~10
RNNT_LOGP_ATOL = 1e-4
SP_PIECES = 512


def sp_model_pieces(n: int) -> list:
    """A SentencePiece vocabulary of ``n`` pieces: unk, two control pieces,
    the 256 byte-fallback pieces, then the word boundary, the letters,
    word-initial letters and letter pairs."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    letters = RU_VOCAB[1:]
    normal = (["\u2581"] + letters + ["\u2581" + c for c in letters]
              + [a + b for a in letters for b in letters])
    pieces += [(p, -1.0 - 0.01 * i, 1)
               for i, p in enumerate(normal[:n - len(pieces)])]
    return pieces


def set_blank_bias(model, base: float, bias: float) -> None:
    """The joint's blank logit bias = its drawn value ``base`` + ``bias``
    (an in-place update: the decoder's graphs are captured again)."""
    with torch.no_grad():
        model.head["joint"]["out"]["b"][model.blank_id] = base + bias


def decode_call(model, enc, lens, chunk: int, eager: bool = False):
    """One decode of ``enc`` by the model's decoder: (outputs on the host,
    host reads, graph replays, wall ms)."""
    dec = model.rnnt
    fn = dec.decode_eager if eager else dec.decode
    reads, replays = dec.host_reads, dec.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(model.head, enc, lens,
             max_symbols=model.cfg.decoding.max_symbols_per_step,
             with_logps=True, chunk=chunk)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return ([o.cpu() for o in out], dec.host_reads - reads,
            dec.replays - replays, wall)


def loop_share(label: str, model, wavs, call: dict, card: str,
               eager: bool = True) -> dict:
    """The decode loop of one main-path call, alone on that call's encoded
    output: graph replays, host reads, iterations, device ms (profile sum)
    and wall, and with ``eager`` the eager loop's wall; its share of the
    call's device busy time."""
    enc, lens = model.encode_batch(wavs)
    ms = model.cfg.decoding.max_symbols_per_step
    chunk = rnnt_greedy.CHUNK
    out, reads, replays, wall = decode_call(model, enc, lens, chunk)
    iters = trip_count(out[1].numpy(), out[2].numpy(), lens.cpu().numpy(),
                       ms, enc.shape[1])
    if reads > math.ceil(iters / chunk) + 1:
        raise AssertionError(f"{label}: {reads} host reads for {iters} "
                             f"iterations at chunk {chunk}")
    args = dict(max_symbols=ms, with_logps=True, chunk=chunk)
    by_kernel = window_ms(lambda: model.rnnt.decode(model.head, enc, lens,
                                                    **args), calls=1)
    graph_ms = sum(by_kernel.values())
    eager_reads, eager_wall = 0, math.nan
    if eager:
        _, eager_reads, _, eager_wall = decode_call(model, enc, lens, chunk,
                                                    eager=True)
    row = {"call": label, "iterations": iters, "host_reads": reads,
           "graph_replays": replays, "tokens": int(out[2].sum()),
           "frames": int(lens.sum()),
           "graph_device_ms": graph_ms, "graph_wall_ms": wall,
           "graph_us_per_iteration": 1e3 * graph_ms / max(iters, 1),
           "graph_wall_us_per_iteration": 1e3 * wall / max(iters, 1),
           "eager_wall_ms": eager_wall,
           "eager_wall_us_per_iteration": 1e3 * eager_wall / max(iters, 1),
           "loop_share_of_call_busy": graph_ms / call["device_busy_ms"],
           "call_wall_ms": call["wall_ms"],
           "call_device_busy_ms": call["device_busy_ms"],
           "call_idle_share": call["idle_share"],
           "call_launches": call["launches"],
           "top_kernels_ms": [[k[:60], v] for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:6]]}
    print(f"  decode loop of {label}: {iters} iterations, {reads} host "
          f"reads, {replays} graph replays; graph {graph_ms:.3f} ms device, "
          f"{wall:.3f} ms wall; eager {eager_wall:.3f} ms wall "
          f"({eager_reads} reads); "
          f"{row['loop_share_of_call_busy']:.3f} of the call's device busy "
          f"time; card {card}", flush=True)
    return row


def decision_margins(head, enc, lens, out, max_symbols: int) -> float:
    """The smallest top-1 minus top-2 log-prob over the decisions the greedy
    loop took, from a teacher-forced replay on the CPU in fp32: at frame t
    of sample b, one decision per token emitted there and one more (the
    blank) unless the symbol cap was hit."""
    tokens, frames, counts = out[0], out[1], out[2]
    smallest = math.inf
    with torch.inference_mode(), full_fp32():
        enc_proj = rnnt_joint_enc_proj(head, enc)
        for b in range(enc.shape[0]):
            n = int(counts[b])
            pred = rnnt_predict_sequence(head, tokens[b:b + 1, :n].long())[0]
            per_frame = np.bincount(frames[b, :n].numpy(),
                                    minlength=int(lens[b]))
            t_idx, u_idx, u = [], [], 0
            for t in range(int(lens[b])):
                k = int(per_frame[t])
                steps = k + (1 if k < max_symbols else 0)
                t_idx += [t] * steps
                u_idx += range(u, u + steps)
                u += k
            if not t_idx:
                continue
            logp = rnnt_joint_step_preproj(head, enc_proj[b, t_idx],
                                           pred[u_idx])
            top = logp.topk(2, dim=-1).values
            smallest = min(smallest, float((top[:, 0] - top[:, 1]).min()))
    return smallest


def decode_checks(model, base: float, wavs, card: str,
                  bias_moderate: float = RNNT_BLANK_BIAS,
                  chunks=RNNT_CHUNKS) -> dict:
    """On the encoded batch of ``wavs``, under each blank bias (all blank,
    and ``bias_moderate``): the graph decode bit-equal to the eager loop on
    the card, and equal to the port's CPU fp32 decode of the same encoded
    tensor (log-probs within RNNT_LOGP_ATOL), the host reads bounded, and
    the A/B of ``chunks``."""
    enc, lens = model.encode_batch(wavs)
    enc_cpu, lens_cpu = enc.float().cpu(), lens.cpu()
    cpu_head = copy.deepcopy(model.head).cpu()
    ms = model.cfg.decoding.max_symbols_per_step
    rows = {}
    for name, bias in (("blank_all", BLANK_ALL),
                       ("blank_moderate", bias_moderate)):
        set_blank_bias(model, base, bias)
        with torch.no_grad():
            cpu_head["joint"]["out"]["b"][model.blank_id] = base + bias
        graph, reads, _, _ = decode_call(model, enc, lens, rnnt_greedy.CHUNK)
        eager, _, _, _ = decode_call(model, enc, lens, rnnt_greedy.CHUNK,
                                     eager=True)
        if not all(torch.equal(g, e) for g, e in zip(graph, eager)):
            raise AssertionError(f"{name}: the graph decode differs from "
                                 f"the eager loop on the card")
        ref = RNNTGreedyDecoder().decode(cpu_head, enc_cpu, lens_cpu,
                                         max_symbols=ms, with_logps=True)
        if not all(torch.equal(g, r) for g, r in zip(graph[:3], ref[:3])):
            raise AssertionError(f"{name}: card and CPU decodes differ")
        logp_err = float((graph[3] - ref[3]).abs().max())
        if not logp_err <= RNNT_LOGP_ATOL:
            raise AssertionError(f"{name}: log-prob error {logp_err}")
        iters = trip_count(graph[1].numpy(), graph[2].numpy(),
                           lens_cpu.numpy(), ms, enc.shape[1])
        if reads > math.ceil(iters / rnnt_greedy.CHUNK) + 1:
            raise AssertionError(f"{name}: {reads} host reads for {iters} "
                                 f"iterations")
        rate = float(graph[2].sum()) / float(lens_cpu.sum())
        if bias == BLANK_ALL and (iters != int(lens_cpu.max())
                                  or int(graph[2].sum()) != 0):
            raise AssertionError(f"{name}: {iters} iterations, "
                                 f"{int(graph[2].sum())} tokens")
        margin = decision_margins(cpu_head, enc_cpu, lens_cpu, ref, ms)
        ab = {}
        for chunk in tuple(chunks) + tuple(chunks)[::-1]:
            decode_call(model, enc, lens, chunk)          # capture, warm
            walls = [decode_call(model, enc, lens, chunk)[3]
                     for _ in range(2)]
            ab.setdefault(str(chunk), []).extend(walls)
        ab_ms = {c: float(np.median(w)) for c, w in ab.items()}
        rows[name] = {"bias": bias, "iterations": iters, "host_reads": reads,
                      "tokens_per_frame": rate, "logp_max_abs_err": logp_err,
                      "min_top2_margin": margin, "chunk_wall_ms": ab_ms}
        print(f"rnnt decode checks, {name} (+{bias:g}), batch 16, "
              f"T'={enc.shape[1]}: graph == eager on the card (tokens, "
              f"frames, counts, logps bit-equal); == CPU fp32 (tokens, "
              f"frames, counts; logps max_abs {logp_err:.2e}, tol "
              f"{RNNT_LOGP_ATOL}); {iters} iterations, {reads} host reads "
              f"(chunk {rnnt_greedy.CHUNK}); {rate:.3f} tokens a frame; "
              f"smallest top-1/top-2 margin {margin:.4f}; wall ms per decode "
              f"by chunk (median of 4) {ab_ms}; card {card}", flush=True)
    lo, hi = RNNT_RATE
    if not lo <= rows["blank_moderate"]["tokens_per_frame"] <= hi:
        raise AssertionError(f"blank bias {bias_moderate}: "
                             f"{rows['blank_moderate']['tokens_per_frame']} "
                             f"tokens a frame, outside {RNNT_RATE}")
    set_blank_bias(model, base, bias_moderate)
    return rows


def rnnt_path(card: str) -> dict:
    """Full-width v3_rnnt (random weights from seed 0, bf16 encoder, fp32
    head, the blank bias RNNT_BLANK_BIAS): ``transcribe`` 20 s (K2) and
    ``_decode_batch`` 16 x 10-20 s (K1), each timed and profiled over one
    call (a call is 26,000-98,000 kernels, and the profiler's bookkeeping
    of three took most of a minute) with its decode loop's share; the decode checks on the batch; then v3_e2e_rnnt (its
    joint unbiased: RNNT_BLANK_BIAS was read off v3_rnnt's head, and an
    unbiased random joint emits at almost every step, so the texts are
    long) and v3_e2e_ctc with a synthetic 512-piece SentencePiece model.
    The clips come from a generator of their own, so the emission rate
    that fixes RNNT_BLANK_BIAS does not depend on the phases before."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(12)
    model = gt.load_model("rnnt", init="random", seed=0)
    n_layers = model.cfg.encoder.n_layers
    base = float(model.head["joint"]["out"]["b"][model.blank_id])
    set_blank_bias(model, base, RNNT_BLANK_BIAS)
    report = {"seconds_by_step": {}}
    launches = {"K1": 0, "K2": 0}

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())

    wav20 = synth_wav(20.0, rng)
    res, n, prof = run_path(
        "v3_rnnt transcribe 20 s, batch 1 (K2)",
        lambda: model.transcribe(wav20, word_timestamps=True), "K2", n_layers,
        calls=1)
    if not (isinstance(res.text, str) and isinstance(res.words, list)):
        raise AssertionError(f"transcribe returned {res!r}")
    launches["K2"] += n
    print(f"  v3_rnnt transcribe: {len(res.text)} chars, {len(res.words)} "
          f"words; card {card}", flush=True)
    lap("load, transcribe")
    report["transcribe"] = loop_share("v3_rnnt transcribe 20 s", model,
                                      [wav20], prof, card)
    lap("transcribe's loop")
    wavs16 = [synth_wav(sec, rng) for sec in np.linspace(10.0, 20.0, 16)]
    outs, n, prof = run_path(
        "v3_rnnt _decode_batch 16 x 10-20 s (K1)",
        lambda: model._decode_batch(wavs16, word_timestamps=True), "K1",
        n_layers, calls=1)
    if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
        raise AssertionError("_decode_batch returned a malformed batch")
    launches["K1"] += n
    print(f"  v3_rnnt _decode_batch: text lengths "
          f"{[len(t) for t, _ in outs]}; card {card}", flush=True)
    lap("_decode_batch")
    report["decode_batch"] = loop_share("v3_rnnt _decode_batch 16", model,
                                        wavs16, prof, card)
    lap("_decode_batch's loop")
    report["checks"] = decode_checks(model, base, wavs16, card)
    lap("decode checks")
    report["captures"] = model.rnnt.captures
    del model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        sp = os.path.join(root, "sp512.model")
        write_sp_model(sp, sp_model_pieces(SP_PIECES))
        for name in ("v3_e2e_rnnt", "v3_e2e_ctc"):
            cfg = make_preset(name)
            cfg = dataclasses.replace(cfg, decoding=dataclasses.replace(
                cfg.decoding, model_path=sp))
            model = gt.GigaAMASR(cfg, seed=0)
            if len(model.tokenizer) != SP_PIECES or model.blank_id != SP_PIECES:
                raise AssertionError(f"{name}: {len(model.tokenizer)} pieces")
            # one call each, from zeroed counts: the unbiased RNNT loop
            # runs T' x max_symbols steps, too many to profile in the phase
            fa.reset_launch_counts()
            res = model.transcribe(wav20, word_timestamps=True)
            outs = model._decode_batch(wavs16, word_timestamps=True)
            torch.cuda.synchronize()
            got = counts()
            want = {k: (n_layers if k in ("K1", "K2") else 0) for k in got}
            if got != want:
                raise AssertionError(f"{name}: launches {got}, expected "
                                     f"{want}")
            if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
                raise AssertionError(f"{name}: malformed batch")
            launches["K2"] += got["K2"]
            launches["K1"] += got["K1"]
            lengths = [len(res.text)] + [len(t) for t, _ in outs]
            print(f"  {name} with a {SP_PIECES}-piece SentencePiece model: "
                  f"transcribe 20 s (K2) and _decode_batch 16 x 10-20 s "
                  f"(K1), launches {got}; text lengths {lengths} "
                  f"(transcribe, then the batch); card {card}", flush=True)
            report[name] = {"text_lengths": lengths}
            lap(name)
            del model
            torch.cuda.empty_cache()
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# Longform and alignment (phase 15)
# ---------------------------------------------------------------------------

LONGFORM_SECONDS = 360.0
LONGFORM_BATCH = 16
# the card's PyanNet class probabilities against the port's CPU fp32 ones:
# the same fp32 ops (cuDNN's conv and LSTM with TF32 off against the CPU's)
# summed in another order; probabilities lie in [0, 1]
VAD_PROB_ATOL = 1e-4
# the argmax must agree wherever the top-1/top-2 margin exceeds this
VAD_MARGIN = 1e-3
# word times are rounded to the millisecond when shifted to file time
WORD_TIME_SLACK = 1e-3
ALIGN_CLIPS = 16
# A random CTC head gives almost every frame the same label (one token on
# each of the phase's 16 clips at full width), so its greedy transcripts
# are a character long.  So that the DP aligns transcripts of a speech-like
# length, the head is centred on the clips (its bias less the mean
# encoder frame's logits) and the blank logit raised by the first shift of
# ALIGN_BLANK_SHIFTS whose greedy transcripts hold at most ALIGN_RATE
# tokens a frame (Russian speech: ~12-15 characters a second, 25 frames).
ALIGN_BLANK_SHIFTS = (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)
ALIGN_RATE = 0.5


def longform_audio(seconds: float, rng) -> np.ndarray:
    """Speech-like bursts of 3-12 s (``synth_wav``) between gaps of 0.6-1.5
    s of noise at about -80 dBFS (RMS 1e-4)."""
    parts, total, n = [], 0, int(seconds * SAMPLE_RATE)
    while total < n:
        burst = synth_wav(rng.uniform(3.0, 12.0), rng)
        gap = 1e-4 * rng.standard_normal(
            int(rng.uniform(0.6, 1.5) * SAMPLE_RATE))
        parts += [burst, gap.astype(np.float32)]
        total += len(burst) + len(gap)
    return np.concatenate(parts)[:n]


def check_longform(label: str, res, duration: float) -> None:
    """Segments ordered, inside the audio, at most 30 s long, each word
    inside its segment (to the millisecond the shift rounds to)."""
    if not res.segments:
        raise AssertionError(f"{label}: no segments")
    prev_end = 0.0
    for s in res.segments:
        if not (prev_end <= s.start < s.end <= duration + 1e-6
                and s.end - s.start <= 30.0 + 1e-6):
            raise AssertionError(f"{label}: segment {s.start}-{s.end} after "
                                 f"{prev_end} in {duration} s")
        for w in s.words or []:
            if not (s.start - WORD_TIME_SLACK <= w.start <= w.end
                    <= s.end + WORD_TIME_SLACK):
                raise AssertionError(f"{label}: word {w} outside segment "
                                     f"{s.start}-{s.end}")
        prev_end = s.end


def longform_serial(model, path: str, batch: int, **kw):
    """``transcribe_longform`` with one chunk batch in flight: each batch is
    finalized before the next is submitted (``kw``: ``_decode_batch``'s
    beam and LM keywords).  Returns (result, [wall ms of each batch
    call])."""
    segments, bounds = gt_vad.segment_audio_file(path, SAMPLE_RATE,
                                                  device=model.device)
    out, walls = [], []
    for i in range(0, len(segments), batch):
        t0 = time.perf_counter()
        res = model._decode_batch(segments[i:i + batch], True,
                                  pad_rows_to=batch, **kw)
        walls.append((time.perf_counter() - t0) * 1e3)
        out += [Segment(text=text, start=s, end=e,
                        words=[w.shifted(s) for w in words or []])
                for (s, e), (text, words) in zip(bounds[i:i + batch], res)]
    return LongformTranscriptionResult(segments=out), walls


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def alternating_walls(fns: dict, rounds: int = 3) -> dict:
    """Wall ms of each of two calls, in turns (a, b, b, a) ``rounds``
    times after one warm call each: {name: [walls]}."""
    (a, fa_), (b, fb) = fns.items()
    fa_(), fb()
    walls = {a: [], b: []}
    for _ in range(rounds):
        for name, fn in ((a, fa_), (b, fb), (b, fb), (a, fa_)):
            walls[name].append(wall_ms(fn))
    return walls


def texts_of(res) -> list:
    return [s.text for s in res.segments]


def h2d_ms(fn) -> float:
    """Device ms of host-to-device copies in one call of ``fn``."""
    return sum(ms for name, ms in window_ms(fn, calls=1).items()
               if "HtoD" in name)


def assert_launches(label: str, want: dict) -> dict:
    got = counts()
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, expected {full}")
    return got


def neural_vad_phase(model, path: str, audio: np.ndarray, root: str,
                     card: str) -> dict:
    """Random PyanNet weights at pyannote's widths, saved with ``save_vad``
    and found through ``GIGAAM_VAD_ARTIFACT``: one ``transcribe_longform``,
    then the card's class probabilities against the port's CPU fp32 ones
    on the same audio, and the VAD's device time."""
    cfg = VADNetConfig()
    cpu_net = PyanNet(cfg, init_vad_state(cfg, seed=3))
    artifact = os.path.join(root, "vad_segmentation")
    save_vad(artifact, cpu_net)
    os.environ["GIGAAM_VAD_ARTIFACT"] = artifact + ".npz"
    try:
        t0 = time.perf_counter()
        res = model.transcribe_longform(path, fr_batch_size=LONGFORM_BATCH,
                                        word_timestamps=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        os.environ["GIGAAM_VAD_ARTIFACT"] = "energy"
    check_longform("neural VAD longform", res, len(audio) / SAMPLE_RATE)
    card_net = copy.deepcopy(cpu_net).to(model.device)
    got, times_g = sliding_class_probs(card_net, audio)
    ref, times_c = sliding_class_probs(cpu_net, audio)
    if got.shape != ref.shape or not np.array_equal(times_g, times_c):
        raise AssertionError(f"VAD probs {got.shape} vs {ref.shape}")
    err = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > VAD_MARGIN
    agree = got.argmax(-1) == ref.argmax(-1)
    if not err <= VAD_PROB_ATOL or not agree[decided].all():
        raise AssertionError(f"VAD probs max_abs {err} (tol {VAD_PROB_ATOL}),"
                             f" argmax differs on {int((~agree[decided]).sum())}"
                             f" frames past the margin")
    minutes = len(audio) / SAMPLE_RATE / 60.0
    by_kernel = window_ms(lambda: sliding_class_probs(card_net, audio),
                          calls=1)
    vad_wall = min(wall_ms(lambda: sliding_class_probs(card_net, audio))
                   for _ in range(3))
    row = {"longform_wall_ms": wall, "segments": len(res.segments),
           "probs_max_abs_err": err, "frames": int(len(ref)),
           "frames_past_margin": int(decided.sum()),
           "argmax_agree_all": float(agree.mean()),
           "device_ms_per_audio_min": sum(by_kernel.values()) / minutes,
           "wall_ms_per_audio_min": vad_wall / minutes,
           "top_kernels_ms": [[k[:60], v] for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:6]]}
    print(f"neural VAD: longform {wall:.1f} ms, {len(res.segments)} segments;"
          f" card vs CPU fp32 probs max_abs {err:.2e} (tol {VAD_PROB_ATOL}),"
          f" argmax equal on all {int(decided.sum())} of {len(ref)} frames "
          f"past the margin {VAD_MARGIN}; {row['device_ms_per_audio_min']:.2f}"
          f" device ms and {row['wall_ms_per_audio_min']:.2f} wall ms per "
          f"audio minute; card {card}", flush=True)
    return row


def shape_ctc_head(model, clips) -> dict:
    """Centre the CTC head on ``clips`` and raise its blank logit by the
    first of ALIGN_BLANK_SHIFTS whose greedy rate is at most ALIGN_RATE
    tokens a frame (in place); returns the shift and the rate."""
    head = model.head["proj"]
    with torch.inference_mode():
        enc, lens = model.encode_batch(clips)
        enc = enc.float()
        valid = torch.arange(enc.shape[1], device=enc.device)[None] < \
            lens[:, None]
        mean = enc[valid].mean(dim=0)
        bias = head["b"] - mean @ head["w"]
        for shift in ALIGN_BLANK_SHIFTS:
            b = bias.clone()
            b[model.blank_id] += shift
            _, keep = ctc_greedy_mask(torch.log_softmax(
                enc @ head["w"] + b, dim=-1), lens)
            rate = float(keep.sum()) / float(lens.sum())
            if rate <= ALIGN_RATE:
                break
    with torch.no_grad():
        head["b"].copy_(b)
    return {"blank_shift": shift, "tokens_per_frame": rate}


def align_phase(model, rng, card: str) -> dict:
    """``align_batch`` on 16 clips of 10-20 s with the model's own greedy
    transcripts (K1), ``align`` on one (K2), then the DP alone on the
    batch's log-probs: the CUDA graph bit-equal to the eager loop on the
    card and equal to the CPU fp32 DP, its device and wall ms and its share
    of ``align_batch``."""
    n_layers = model.cfg.encoder.n_layers
    clips = [synth_wav(s, rng) for s in np.linspace(10.0, 20.0, ALIGN_CLIPS)]
    shape = shape_ctc_head(model, clips)
    texts = [t for t, _ in model._decode_batch(clips, False)]
    model.align_batch(clips, texts)                         # warm, capture
    fa.reset_launch_counts()
    batch_wall = wall_ms(lambda: model.align_batch(clips, texts))
    launches = assert_launches("align_batch", {"K1": n_layers})
    res = model.align_batch(clips, texts)
    for clip, text, r in zip(clips, texts, res):
        starts = [w.start for w in r.words]
        if (starts != sorted(starts) or any(
                w.end > len(clip) / SAMPLE_RATE + WORD_TIME_SLACK
                for w in r.words)):
            raise AssertionError(f"align_batch: words {r.words}")
    prof = profile_calls(f"align_batch {ALIGN_CLIPS} x 10-20 s (K1)",
                         lambda: model.align_batch(clips, texts), 1,
                         batch_wall)
    model.align(clips[-1], texts[-1])
    fa.reset_launch_counts()
    one = model.align(clips[-1], texts[-1])
    torch.cuda.synchronize()
    launches["K2"] = assert_launches("align", {"K2": n_layers})["K2"]
    print(f"  align_batch: {sum(len(r.words) for r in res)} words, "
          f"{batch_wall:.1f} ms wall; align: {len(one.words)} words; "
          f"card {card}", flush=True)

    # the DP alone
    vocab = model.cfg.decoding.vocabulary
    ids = [model.tokenizer.encode(normalize_text(t, vocab, raw_text=True))
           for t in texts]
    per = [pad_targets(i) for i in ids]
    tg = np.zeros((len(ids), max(len(p) for p in per)), np.int32)
    for i, p in enumerate(per):
        tg[i, :len(p)] = p
    tl = np.array([len(i) for i in ids], np.int32)
    with torch.inference_mode():
        dev_batch, dev_lens, _, pos = model._device_batch(clips)
        lp, enc_lens = model._ctc_logprobs(dev_batch, dev_lens, pos)
    targets = torch.from_numpy(tg).to(model.device)
    tlens = torch.from_numpy(tl).to(model.device)
    args = (lp, enc_lens, targets, tlens, model.blank_id)
    al = model.aligner
    graph = [o.cpu() for o in al.align(*args)]
    eager = [o.cpu() for o in al.align_eager(*args)]
    ref = ViterbiAligner().align(*(a.cpu() for a in args[:4]),
                                 model.blank_id)
    if not all(torch.equal(g, e) for g, e in zip(graph, eager)):
        raise AssertionError("the DP's graph differs from the eager loop")
    if not all(torch.equal(g, r) for g, r in zip(graph, ref)):
        raise AssertionError("the DP on the card differs from the CPU's")
    bp, fs, score = (o.numpy() for o in graph)
    lens_np = enc_lens.cpu().numpy()
    for i, u in enumerate(ids):
        if not u:
            continue
        frames, _ = backtrack(bp[i], int(fs[i]), int(lens_np[i]), len(u))
        if (not np.isfinite(score[i]) or score[i] <= -1e29
                or any(b <= a for a, b in zip(frames, frames[1:]))
                or frames[-1] >= lens_np[i]):
            raise AssertionError(f"DP sample {i}: score {score[i]}, frames "
                                 f"{frames[:8]}...")
    by_kernel = window_ms(lambda: al.align(*args), calls=3)
    dp_device = sum(by_kernel.values())
    dp_wall = float(np.median([wall_ms(lambda: al.align(*args))
                               for _ in range(5)]))
    eager_wall = float(np.median([wall_ms(lambda: al.align_eager(*args))
                                  for _ in range(3)]))
    s = bp.shape[2]
    row = {"align_batch_wall_ms": batch_wall,
           "align_batch_device_busy_ms": prof["device_busy_ms"],
           "align_batch_idle_share": prof["idle_share"],
           "T": int(lp.shape[1]), "S": int(s),
           "head_shape": shape, "tokens": [len(u) for u in ids],
           "dp_graph_device_ms": dp_device, "dp_graph_wall_ms": dp_wall,
           "dp_eager_wall_ms": eager_wall,
           "dp_share_of_align_batch_busy": dp_device / prof["device_busy_ms"],
           "dp_share_of_align_batch_wall": dp_wall / batch_wall,
           "graph_equals_eager": True, "card_equals_cpu_fp32": True,
           "captures": al.captures, "launches": launches,
           "dp_top_kernels_ms": [[k[:60], v] for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:6]]}
    print(f"alignment DP, batch {ALIGN_CLIPS}, T'={lp.shape[1]}, S={s}: "
          f"graph == eager on the card, == CPU fp32 (backpointers, final "
          f"states, scores bit-equal); graph {dp_device:.3f} ms device, "
          f"{dp_wall:.3f} ms wall; eager {eager_wall:.3f} ms wall; "
          f"{row['dp_share_of_align_batch_busy']:.3f} of align_batch's device"
          f" busy time; card {card}", flush=True)
    return row


def longform_path(card: str) -> dict:
    """Phase 15: full-width v3_ctc (random weights from seed 0, bf16)
    through ``transcribe_longform`` on a 6-minute WAV with the energy VAD:
    launch counts (K1 in all 16 layers of every chunk batch), two batches
    in flight against one (same texts; walls and idle shares), the int16
    wire A/B, the energy VAD's host time; the neural VAD; v2_ctc's
    longform (K5); then ``align_batch`` (K1), ``align`` (K2) and the DP
    alone."""
    t0 = time.perf_counter()
    os.environ["GIGAAM_VAD_ARTIFACT"] = "energy"
    rng = np.random.default_rng(15)
    audio = longform_audio(LONGFORM_SECONDS, rng)
    report = {"seconds_by_step": {}}
    launches = {"K1": 0, "K2": 0, "K5": 0}

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())

    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "longform.wav")
        save_wav(path, audio)
        audio = gt.load_audio(path)               # what the model reads
        duration = len(audio) / SAMPLE_RATE
        model = gt.load_model("v3_ctc", init="random", seed=0)
        n_layers = model.cfg.encoder.n_layers

        def longform():
            return model.transcribe_longform(
                path, fr_batch_size=LONGFORM_BATCH, word_timestamps=True)

        res = longform()
        n_seg = len(res.segments)
        n_batches = -(-n_seg // LONGFORM_BATCH)
        if n_batches < 2:
            raise AssertionError(f"{n_seg} segments: fewer than 2 batches")
        fa.reset_launch_counts()
        res = longform()
        torch.cuda.synchronize()
        launches["K1"] += assert_launches(
            "longform v3_ctc", {"K1": n_layers * n_batches})["K1"]
        check_longform("longform v3_ctc", res, duration)
        lap("load, first longform")

        serial_res, batch_walls = longform_serial(model, path,
                                                  LONGFORM_BATCH)
        if texts_of(serial_res) != texts_of(res):
            raise AssertionError("one batch in flight gives other texts")
        walls = alternating_walls({
            "one_in_flight": lambda: longform_serial(model, path,
                                                     LONGFORM_BATCH),
            "two_in_flight": longform})
        med = {k: float(np.median(v)) for k, v in walls.items()}
        prof_two = profile_calls(
            f"longform {duration:.0f} s, two batches in flight (K1)",
            longform, 1, med["two_in_flight"])
        prof_one = profile_calls(
            f"longform {duration:.0f} s, one batch in flight (K1)",
            lambda: longform_serial(model, path, LONGFORM_BATCH), 1,
            med["one_in_flight"])
        segs = gt_vad.segment_audio_file(path)[1]
        vad_walls = [wall_ms(lambda: gt_vad.segment_audio_file(path))
                     for _ in range(3)]
        energy = [wall_ms(lambda: gt_vad.energy_speech_regions(audio))
                  for _ in range(5)]
        report["v3_ctc"] = {
            "audio_s": duration, "segments": n_seg, "batches": n_batches,
            "segment_s": [round(e - s, 3) for s, e in segs],
            "walls_ms": walls, "median_ms": med,
            "two_over_one": med["two_in_flight"] / med["one_in_flight"],
            "batch_call_walls_ms": batch_walls,
            "load_and_vad_wall_ms": float(np.median(vad_walls)),
            "sum_of_batch_calls_ms": sum(batch_walls),
            "idle_share_two": prof_two["idle_share"],
            "idle_share_one": prof_one["idle_share"],
            "device_busy_ms_two": prof_two["device_busy_ms"],
            "device_busy_ms_one": prof_one["device_busy_ms"],
            "energy_vad_host_ms_per_audio_min":
                float(np.median(energy)) / (duration / 60.0),
            "audio_s_per_s_two": duration / (med["two_in_flight"] / 1e3)}
        print(f"longform v3_ctc {duration:.0f} s, {n_seg} segments in "
              f"{n_batches} batches of {LONGFORM_BATCH}: two in flight "
              f"{med['two_in_flight']:.1f} ms, one {med['one_in_flight']:.1f}"
              f" ms (median of {len(walls['two_in_flight'])}, in turns); "
              f"idle share {prof_two['idle_share']:.3f} / "
              f"{prof_one['idle_share']:.3f}; same texts; card {card}",
              flush=True)
        lap("two vs one in flight")

        def wire(on: bool):
            model._int16_wire = on
            try:
                return longform()
            finally:
                model._int16_wire = False

        if texts_of(wire(True)) != texts_of(res):
            raise AssertionError("the int16 wire changes the texts")
        wire_walls = alternating_walls({"fp32": lambda: wire(False),
                                        "int16": lambda: wire(True)})
        report["int16_wire"] = {
            "median_ms": {k: float(np.median(v))
                          for k, v in wire_walls.items()},
            "h2d_ms": {"fp32": h2d_ms(lambda: wire(False)),
                       "int16": h2d_ms(lambda: wire(True))},
            "same_texts": True}
        print(f"int16 wire: {report['int16_wire']}; card {card}", flush=True)
        lap("int16 wire")

        report["neural_vad"] = neural_vad_phase(model, path, audio, root,
                                                card)
        lap("neural VAD")
        report["align"] = align_phase(model, rng, card)
        launches["K1"] += report["align"]["launches"]["K1"]
        launches["K2"] += report["align"]["launches"]["K2"]
        lap("alignment")
        del model
        torch.cuda.empty_cache()

        asr = v2_ctc()
        asr.transcribe_longform(path, fr_batch_size=LONGFORM_BATCH)
        fa.reset_launch_counts()
        v2_wall = wall_ms(lambda: asr.transcribe_longform(
            path, fr_batch_size=LONGFORM_BATCH, word_timestamps=True))
        launches["K5"] += assert_launches(
            "longform v2_ctc",
            {"K5": asr.cfg.encoder.n_layers * n_batches})["K5"]
        v2 = asr.transcribe_longform(path, fr_batch_size=LONGFORM_BATCH,
                                     word_timestamps=True)
        check_longform("longform v2_ctc", v2, duration)
        report["v2_ctc"] = {"wall_ms": v2_wall, "segments": len(v2.segments)}
        print(f"longform v2_ctc: {v2_wall:.1f} ms, {len(v2.segments)} "
              f"segments (K5 in every layer); card {card}", flush=True)
        del asr
        torch.cuda.empty_cache()
        lap("v2_ctc longform")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# Beam decoding and n-gram fusion (phase 16)
# ---------------------------------------------------------------------------

BEAM = 4
CTC_BEAM = 8
LM_WEIGHT = 0.3
# A random joint's emission rate is a steep step in its blank bias, and the
# K-4 beam keeps the all-blank hypothesis at a bias where greedy still
# emits (phase 14's RNNT_BLANK_BIAS: greedy 0.40 tokens a frame, the beam
# none); an LM trained on real text then penalises the random model's
# tokens.  So each model gets (blank bias, token bonus): the bias at which
# the plain K-4 beam emits 0.2-0.8 tokens a frame on the phase's batch, and
# the LM's token bonus at which the fused beam does too (the two knobs a
# user tunes).  Read off a bisection on the card: v3_rnnt plain 0.565,
# fused 0.689 tokens a frame; v3_e2e_rnnt 0.546 and 0.597.
BEAM_SHAPE = {"v3_rnnt": (0.734375, 1.3125), "v3_e2e_rnnt": (0.453125,
                                                             2.390625)}
BEAM_RATE = (0.2, 0.8)
# the card's fp32 beam against the port's CPU fp32 beam of the same encoded
# batch: a row may differ only where the CPU run took a decision within this
# gap of a tie (its K-th and (K+1)-th pool scores; the two differ by the
# order of their sums, ~1e-6 at scores of ~100)
BEAM_TIE_GAP = 1e-4
LM_WORDS = ("привет мир как дела сегодня хорошая погода мы идём домой "
            "вечером будет дождь она читает книгу они работают в городе "
            "наш дом стоит у реки дети играют во дворе").split()


def lm_texts(rng, n: int = 2000) -> list:
    """Seeded synthetic Russian text: sentences of 3-12 words drawn from
    LM_WORDS."""
    return [" ".join(rng.choice(LM_WORDS, size=rng.integers(3, 13)))
            for _ in range(n)]


def beam_call(model, enc, lens, chunk: int = rnnt_beam.CHUNK,
              eager: bool = False, **kw):
    """One beam decode of ``enc`` by the model's beam decoder: (outputs on
    the host, host reads, graph replays, expansions, wall ms)."""
    dec = model.rnnt_beam
    fn = dec.decode_eager if eager else dec.decode
    reads, replays = dec.host_reads, dec.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(model.head, enc, lens,
             max_symbols=model.cfg.decoding.max_symbols_per_step,
             with_logps=True, chunk=chunk, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return ([o.cpu() for o in out], dec.host_reads - reads,
            dec.replays - replays, dec.last_expansions(), wall)


def eager_beam_gaps(head, enc, lens, k: int, max_symbols: int, **kw):
    """The port's eager beam of ``enc`` on its device (one expansion a step)
    and, per row, the smallest gap between the K-th and (K+1)-th score of
    its pools (pools whose (K+1)-th is dead excluded)."""
    gaps = torch.full((enc.shape[0],), math.inf, dtype=torch.float64,
                      device=enc.device)
    inner = rnnt_beam.top_k

    def recording(pool, kk):
        best = torch.sort(pool, dim=-1, descending=True).values
        gap = (best[:, kk - 1] - best[:, kk]).double()
        live = best[:, kk] > rnnt_beam.NEG_INF / 2
        torch.minimum(gaps, torch.where(live, gap, math.inf), out=gaps)
        return inner(pool, kk)

    rnnt_beam.top_k = recording
    try:
        out = RNNTBeamDecoder().decode_eager(
            head, enc, lens, beam_size=k, max_symbols=max_symbols,
            with_logps=True, chunk=1, **kw)
    finally:
        rnnt_beam.top_k = inner
    return [o.cpu() for o in out], gaps.cpu()


def rows_equal(a, b) -> list:
    return [bool(torch.equal(a[0][i], b[0][i]) and torch.equal(a[1][i], b[1][i])
                 and a[2][i] == b[2][i]) for i in range(len(a[2]))]


def beam_rows_agree(label: str, got, ref, gaps) -> dict:
    """Rows equal (tokens, frames, counts; log-probs within RNNT_LOGP_ATOL)
    wherever the reference run's smallest gap exceeds BEAM_TIE_GAP."""
    same = rows_equal(got, ref)
    decided = [float(g) > BEAM_TIE_GAP for g in gaps]
    bad = [i for i, (s_, d) in enumerate(zip(same, decided)) if d and not s_]
    err = max((float((got[3][i] - ref[3][i]).abs().max())
               for i in range(len(gaps)) if same[i]), default=0.0)
    if bad or not err <= RNNT_LOGP_ATOL:
        raise AssertionError(f"{label}: rows {bad} differ past the gap "
                             f"{BEAM_TIE_GAP} (gaps {gaps.tolist()}), logp "
                             f"error {err}")
    return {"rows_equal": sum(same), "rows": len(same),
            "rows_past_gap": sum(decided), "smallest_gap": float(gaps.min()),
            "logp_max_abs_err": err}


def beam_rate(model, enc, lens, **kw) -> float:
    """Tokens a frame of the K-4 beam of ``enc``, asserted in BEAM_RATE."""
    out = beam_call(model, enc, lens, beam_size=BEAM, **kw)[0]
    rate = float(out[2].sum()) / float(lens.sum())
    if not BEAM_RATE[0] <= rate <= BEAM_RATE[1]:
        raise AssertionError(f"the beam emits {rate} tokens a frame, outside"
                             f" {BEAM_RATE}")
    return rate


def shape_beam(name: str, model, enc, lens, lm_spec) -> dict:
    """Set the joint's blank bias of BEAM_SHAPE[name] (added to the drawn
    one) and return it, its token bonus and the plain and fused beams'
    tokens a frame on ``enc``."""
    bias, bonus = BEAM_SHAPE[name]
    set_blank_bias(model, float(model.head["joint"]["out"]["b"][
        model.blank_id]), bias)
    return {"blank_bias": bias, "token_bonus": bonus,
            "plain_tokens_per_frame": beam_rate(model, enc, lens),
            "fused_tokens_per_frame": beam_rate(
                model, enc, lens, lm=lm_spec, lm_weight=LM_WEIGHT,
                token_bonus=bonus)}


def beam_loop_row(label: str, model, wavs, card: str, eager: bool = True,
                  **fused) -> dict:
    """The beam of one main-path call, alone on that call's encoded output:
    expansions, host reads (at most ceil(expansions / chunk) + 1), graph
    replays, device ms (the profile's sum) and wall, with ``eager`` the
    eager loop's wall and the graph bit-equal to it.  Returns (row,
    encoded, lengths, the graph's outputs)."""
    enc, lens = model.encode_batch(wavs)
    graph, reads, replays, steps, wall = beam_call(model, enc, lens,
                                                   beam_size=BEAM, **fused)
    eager_wall = None
    if eager:
        out, _, _, _, eager_wall = beam_call(model, enc, lens, eager=True,
                                             beam_size=BEAM, **fused)
        if not all(torch.equal(g, e) for g, e in zip(graph, out)):
            raise AssertionError(f"{label}: the beam's graph differs from "
                                 f"its eager loop")
    if reads > math.ceil(steps / rnnt_beam.CHUNK) + 1:
        raise AssertionError(f"{label}: {reads} host reads for {steps} "
                             f"expansions")
    by_kernel = window_ms(lambda: model.rnnt_beam.decode(
        model.head, enc, lens, beam_size=BEAM,
        max_symbols=model.cfg.decoding.max_symbols_per_step,
        with_logps=True, **fused), calls=1)
    loop_ms = sum(by_kernel.values())
    row = {"call": label, "expansions": steps, "host_reads": reads,
           "graph_replays": replays, "frames_max": int(lens.max()),
           "tokens": int(graph[2].sum()), "graph_device_ms": loop_ms,
           "graph_wall_ms": wall,
           "device_us_per_expansion": 1e3 * loop_ms / max(steps, 1),
           "wall_us_per_expansion": 1e3 * wall / max(steps, 1),
           "eager_wall_ms": eager_wall,
           "top_kernels_ms": [[k[:60], v] for k, v in sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:8]]}
    print(f"  beam loop of {label}: {steps} expansions (T' "
          f"{int(lens.max())}), {reads} host reads, {replays} graph replays;"
          f" graph {loop_ms:.3f} ms device "
          f"({row['device_us_per_expansion']:.1f} us an expansion), "
          f"{wall:.3f} ms wall ({row['wall_us_per_expansion']:.1f} us); "
          f"eager {eager_wall} ms{'; graph == eager' if eager else ''}; "
          f"card {card}", flush=True)
    return row, enc, lens, graph


def beam_checks(model, lm, bonus: float, enc, lens, graph, card: str
                ) -> dict:
    """On the batch's encoded output: the card's beam (with the LM) equal
    to the CPU fp32 beam past BEAM_TIE_GAP, ``lm_weight`` 0 equal to no LM,
    the K-1 beam equal to greedy on every row but those where the K-1 run's
    cumulative scores tie exactly (greedy's argmax then takes the label, the
    pool the blank)."""
    ms = model.cfg.decoding.max_symbols_per_step
    ref, gaps = eager_beam_gaps(
        copy.deepcopy(model.head).cpu(), enc.float().cpu(), lens.cpu(), BEAM,
        ms, lm=rnnt_beam.lm_device_table(lm, "cpu"), lm_weight=LM_WEIGHT,
        token_bonus=bonus)
    cpu = beam_rows_agree("card vs CPU beam", graph, ref, gaps)
    zero = beam_call(model, enc, lens, beam_size=BEAM,
                     lm=model._resolve_lm(lm)[1], lm_weight=0.0,
                     token_bonus=0.0)[0]
    plain = beam_call(model, enc, lens, beam_size=BEAM)[0]
    if not all(torch.equal(a, b) for a, b in zip(zero, plain)):
        raise AssertionError("lm_weight 0 differs from no LM")
    k1, k1_gaps = eager_beam_gaps(model.head, enc, lens, 1, ms)
    greedy = [o.cpu() for o in model.rnnt.decode(
        model.head, enc, lens, max_symbols=ms, with_logps=True)]
    same = rows_equal(k1, greedy)
    bad = [i for i, s_ in enumerate(same) if not s_ and float(k1_gaps[i]) > 0]
    if bad:
        raise AssertionError(f"the K 1 beam differs from greedy on rows {bad}"
                             f" with no exact tie (gaps {k1_gaps.tolist()})")
    k1_err = max((float((k1[3][i] - greedy[3][i]).abs().max())
                  for i in range(len(same)) if same[i]), default=0.0)
    row = {"card_vs_cpu_fp32": cpu, "lm_weight_0_is_no_lm": True,
           "k1_rows_equal_greedy": sum(same),
           "k1_rows_with_an_exact_tie": int((k1_gaps == 0).sum()),
           "k1_logp_max_abs_err": k1_err}
    print(f"beam checks, batch {enc.shape[0]}, T'={enc.shape[1]}: card == "
          f"CPU fp32 past a gap of {BEAM_TIE_GAP} {cpu}; lm_weight 0 == no "
          f"LM; K 1 == greedy on {sum(same)} of {len(same)} rows (rows with "
          f"an exact fp32 tie of the K-1 scores: "
          f"{row['k1_rows_with_an_exact_tie']}; logps {k1_err:.1e}); card "
          f"{card}", flush=True)
    return row


def beam_path(card: str) -> dict:
    """Phase 16: full-width v3_rnnt (random weights from seed 0, bf16
    encoder, fp32 head; blank bias and token bonus from BEAM_SHAPE) at
    beam 4: ``transcribe`` 20 s (K2) and ``_decode_batch`` 16 x 10-20 s
    with a char trigram from ``train_lm_from_texts`` (dense table) (K1),
    each timed once unprofiled (a profile of a call's 10^5-10^6 kernels
    costs tens of seconds of host time), with its beam alone profiled
    (``beam_loop_row``), then
    ``beam_checks`` on the batch; v3_e2e_rnnt with the synthetic 512-piece
    SentencePiece model (shaped the same way) and a SentencePiece trigram
    (sparse table) through ``_decode_batch`` (K1), and a bigram whose dense
    and sparse tables give equal tokens; v3_ctc ``_decode_batch`` 16 at
    beam 8 with the char trigram, its head centred and blank raised
    (``shape_ctc_head``), device ms and host beam ms a clip."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(16)
    texts = lm_texts(rng)
    report = {"seconds_by_step": {}}
    launches = {"K1": 0, "K2": 0}

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())
        print(f"  [{step}: {report['seconds_by_step'][step]:.1f} s]",
              flush=True)

    model = gt.load_model("rnnt", init="random", seed=0)
    n_layers = model.cfg.encoder.n_layers
    wav20 = synth_wav(20.0, rng)
    wavs16 = [synth_wav(sec, rng) for sec in np.linspace(10.0, 20.0, 16)]
    char_lm = gt.train_lm_from_texts(texts, model.tokenizer, order=3)
    spec = model._resolve_lm(char_lm)[1]
    if not isinstance(spec[0], torch.Tensor):
        raise AssertionError("the char trigram did not get a dense table")
    enc, lens = model.encode_batch(wavs16)
    report["shape"] = shape_beam("v3_rnnt", model, enc, lens, spec)
    bonus = report["shape"]["token_bonus"]
    del enc
    lap("load")
    res, n, prof = run_path(
        f"v3_rnnt transcribe 20 s, beam {BEAM} (K2)",
        lambda: model.transcribe(wav20, word_timestamps=True,
                                 beam_size=BEAM), "K2", n_layers, calls=1,
        profiled=False)
    launches["K2"] += n
    report["transcribe"] = dict(beam_loop_row(
        "v3_rnnt transcribe 20 s", model, [wav20], card, eager=False)[0],
        call_wall_ms=prof["wall_ms"])
    lap("transcribe")
    outs, n, prof = run_path(
        f"v3_rnnt _decode_batch 16 x 10-20 s, beam {BEAM}, char trigram (K1)",
        lambda: model._decode_batch(wavs16, True, beam_size=BEAM, lm=char_lm,
                                    lm_weight=LM_WEIGHT, token_bonus=bonus),
        "K1", n_layers, calls=1, profiled=False)
    launches["K1"] += n
    if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
        raise AssertionError("_decode_batch returned a malformed batch")
    print(f"  v3_rnnt beam {BEAM}: transcribe {len(res.text)} chars; batch "
          f"text lengths {[len(t) for t, _ in outs]}; card {card}",
          flush=True)
    row, enc, lens, graph = beam_loop_row(
        "v3_rnnt _decode_batch 16, char trigram", model, wavs16, card,
        lm=spec, lm_weight=LM_WEIGHT, token_bonus=bonus)
    report["decode_batch"] = dict(row, call_wall_ms=prof["wall_ms"])
    lap("_decode_batch")
    report["checks"] = beam_checks(model, char_lm, bonus, enc, lens, graph,
                                   card)
    report["captures"] = model.rnnt_beam.captures
    lap("beam checks")
    del model, enc, graph
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        sp = os.path.join(root, "sp512.model")
        write_sp_model(sp, sp_model_pieces(SP_PIECES))
        cfg = make_preset("v3_e2e_rnnt")
        cfg = dataclasses.replace(cfg, decoding=dataclasses.replace(
            cfg.decoding, model_path=sp))
        model = gt.GigaAMASR(cfg, seed=0)
        sp_lm = gt.train_lm_from_texts(texts, model.tokenizer, order=3)
        spec = model._resolve_lm(sp_lm)[1]
        if not isinstance(spec[0], dict):
            raise AssertionError("the SP trigram did not get a sparse table")
        enc, lens = model.encode_batch(wavs16)
        shape = shape_beam("v3_e2e_rnnt", model, enc, lens, spec)
        sp_kw = dict(lm_weight=LM_WEIGHT, token_bonus=shape["token_bonus"])

        def sp_call():
            return model._decode_batch(wavs16, False, beam_size=BEAM,
                                       lm=sp_lm, **sp_kw)

        sp_call()
        fa.reset_launch_counts()
        sp_wall = wall_ms(sp_call)
        launches["K1"] += assert_launches("v3_e2e_rnnt beam",
                                          {"K1": n_layers})["K1"]
        bigram = gt.train_lm_from_texts(texts, model.tokenizer, order=2)
        dense_sparse = [beam_call(model, enc, lens, beam_size=BEAM,
                                  lm=rnnt_beam.lm_device_table(
                                      bigram, model.device, sparse=sparse),
                                  **sp_kw)
                        for sparse in (False, True)]
        if not all(torch.equal(a, b) for a, b in zip(dense_sparse[0][0][:3],
                                                     dense_sparse[1][0][:3])):
            raise AssertionError("SP bigram: dense and sparse tables give "
                                 "other tokens")
        report["v3_e2e_rnnt"] = {
            "shape": shape, "wall_ms": sp_wall,
            "bigram_expansions": dense_sparse[0][3],
            "bigram_tokens": int(dense_sparse[0][0][2].sum()),
            "bigram_wall_ms_dense_sparse": [d[4] for d in dense_sparse],
            "trigram_sparse_levels": [int(ids.shape[0]) for ids, _ in
                                      spec[0]["levels"]]}
        print(f"  v3_e2e_rnnt beam {BEAM}, SP trigram (sparse, levels "
              f"{report['v3_e2e_rnnt']['trigram_sparse_levels']}): "
              f"{sp_wall:.1f} ms wall; SP bigram: dense == sparse tokens "
              f"({report['v3_e2e_rnnt']['bigram_tokens']} tokens, "
              f"{dense_sparse[0][3]} expansions, "
              f"{dense_sparse[0][4]:.1f} / {dense_sparse[1][4]:.1f} ms); "
              f"card {card}", flush=True)
        del model, enc
        torch.cuda.empty_cache()
    lap("v3_e2e_rnnt")

    model = gt.load_model("v3_ctc", init="random", seed=0)
    shape = shape_ctc_head(model, wavs16)
    ctc_lm = gt.train_lm_from_texts(texts, model.tokenizer, order=3)
    ctc_kw = dict(beam_size=CTC_BEAM, lm=ctc_lm, lm_weight=LM_WEIGHT,
                  token_bonus=bonus)
    # the host beam takes seconds a batch: one timed call, one profiled
    fa.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    finalize = model._decode_batch_submit(wavs16, True, **ctc_kw)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    outs = finalize()
    t3 = time.perf_counter()
    host_ms, ctc_wall = (t3 - t2) * 1e3, (t3 - t1) * 1e3
    launches["K1"] += assert_launches("v3_ctc beam", {"K1": n_layers})["K1"]
    ctc_prof = profile_calls(
        f"v3_ctc _decode_batch 16, prefix beam {CTC_BEAM}, char trigram (K1)",
        lambda: model._decode_batch(wavs16, True, **ctc_kw), 1, ctc_wall)
    greedy = [t for t, _ in model._decode_batch(wavs16, False)]
    report["v3_ctc"] = {
        "head_shape": shape, "wall_ms": ctc_wall,
        "device_busy_ms": ctc_prof["device_busy_ms"],
        "idle_share": ctc_prof["idle_share"],
        "host_beam_ms_per_clip": host_ms / len(wavs16),
        "text_lengths": [len(t) for t, _ in outs],
        "greedy_text_lengths": [len(t) for t in greedy]}
    print(f"  v3_ctc prefix beam {CTC_BEAM} with the char trigram: "
          f"{ctc_prof['device_busy_ms']:.2f} device ms a batch, "
          f"{host_ms / len(wavs16):.1f} host beam ms a clip, {ctc_wall:.1f} "
          f"ms wall; text lengths {report['v3_ctc']['text_lengths']}; card "
          f"{card}", flush=True)
    del model
    torch.cuda.empty_cache()
    lap("v3_ctc")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    print(f"beam phase: {report['seconds']:.1f} s", flush=True)
    return report


# ---------------------------------------------------------------------------
# Reference checkpoints, RNNT fine-tuning, BEST-RQ, conv1d (phase 17)
# ---------------------------------------------------------------------------

# conv1d on the card in fp32 (TF32 off, the composed attention) against the
# CPU fp32 model: the same ops summed in another order, so every frame whose
# CPU top-1/top-2 log-prob margin is at least this keeps its argmax
CONV1D_MARGIN = 1e-3


def write_reference_ckpt(model, path: str, base_name: str = None) -> float:
    """``model`` as a reference checkpoint: ``{"cfg", "state_dict"}`` (the
    cfg a plain dict with ``${...}`` interpolations, reference names and
    layouts), or with ``base_name`` a fine-tuned Lightning checkpoint
    (``hyper_parameters``, an optimizer entry, no ``cfg``).  Returns the
    seconds of ``torch.save``."""
    cfg = model.cfg
    sd = {k: torch.from_numpy(v) for k, v in gt_ckpt.reference_state_dict(
        params_to_jax(model), cfg).items()}
    if base_name is None:
        obj = {"cfg": gt_ckpt.reference_cfg(cfg), "state_dict": sd}
    else:
        obj = {"hyper_parameters": {"model_name": base_name},
               "state_dict": dict(sd, **{"optimizer.step": torch.zeros(1)})}
    t0 = time.perf_counter()
    torch.save(obj, path)
    return time.perf_counter() - t0


def assert_same_parameters(label: str, src, got) -> None:
    a, b = dict(src.named_parameters()), dict(got.named_parameters())
    if a.keys() != b.keys():
        raise AssertionError(f"{label}: parameter names differ")
    bad = [n for n, p in a.items()
           if p.dtype != b[n].dtype or not torch.equal(p, b[n])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} parameters differ, e.g. "
                             f"{bad[:3]}")


def ingested_outputs(model, wav20, wavs16) -> list:
    """The tensors that must be bit-equal between a model and its ingested
    copy: per call, the encoder output and, for CTC, the log-probs and
    their argmax ids; for RNNT the greedy decode's tokens, frames, counts
    and log-probs."""
    outs = []
    with torch.inference_mode():
        for wavs in ([wav20], wavs16):
            enc, lens = model.encode_batch(wavs)
            outs += [enc, lens]
            if model.rnnt is None:
                lp = ctc_log_probs(model.head, enc)
                outs += [lp, lp.argmax(-1)]
            else:
                outs += list(model.rnnt.decode(
                    model.head, enc, lens, with_logps=True))
    return outs


def ingest_one(label: str, src, path: str, wav20, wavs16, card: str,
               load) -> dict:
    """Load ``path`` with ``load``; equal parameters, bit-equal outputs,
    equal texts; ``transcribe`` (K2) and ``_decode_batch`` (K1) of the
    ingested model from zeroed counts."""
    t0 = time.perf_counter()
    got = load()
    load_s = time.perf_counter() - t0
    assert_same_parameters(label, src, got)
    same = [torch.equal(a, b) for a, b in zip(
        ingested_outputs(src, wav20, wavs16),
        ingested_outputs(got, wav20, wavs16))]
    if not all(same):
        raise AssertionError(f"{label}: outputs differ ({same})")
    want_texts = ([src.transcribe(wav20).text]
                  + [t for t, _ in src._decode_batch(wavs16, False)])
    n_layers = src.cfg.encoder.n_layers
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    texts = [got.transcribe(wav20).text]
    k2 = counts()["K2"]
    texts += [t for t, _ in got._decode_batch(wavs16, False)]
    torch.cuda.synchronize()
    launches = counts()
    if (k2, launches["K2"], launches["K1"]) != (n_layers,) * 3 or any(
            n for k, n in launches.items() if k not in ("K1", "K2")):
        raise AssertionError(f"{label}: launches {launches}")
    if texts != want_texts:
        raise AssertionError(f"{label}: texts differ from the source's")
    print(f"ingest {label}: load {load_s:.1f} s, parameters equal, encoder "
          f"output and {'decode' if src.rnnt is not None else 'log-probs'} "
          f"bit-equal on transcribe 20 s and _decode_batch 16 x 10-20 s, "
          f"texts equal; launches {launches}; card {card}", flush=True)
    return {"load_s": load_s, "launches": launches}


def ingestion_phase(root: str, rng, card: str) -> dict:
    """Full-width v3_ctc and v3_rnnt written as reference checkpoints, and a
    fine-tuned Lightning v3_ctc, each loaded with ``load_model(path)``; the
    v3_ctc also by name through ``download_root`` from a ``file://`` CDN
    (md5 pinned to the file), then from the converted cache."""
    report = {}
    launches = {"K1": 0, "K2": 0}
    wav20 = synth_wav(20.0, rng)
    wavs16 = [synth_wav(s, rng) for s in np.linspace(10.0, 20.0, 16)]
    cdn = os.path.join(root, "cdn")
    os.makedirs(cdn)
    for name in ("v3_ctc", "v3_rnnt"):
        src = gt.load_model(name, init="random", seed=3)
        if src.rnnt is not None:
            set_blank_bias(src, float(
                src.head["joint"]["out"]["b"][src.blank_id]), RNNT_BLANK_BIAS)
        path = os.path.join(cdn, f"{name}.ckpt")
        save_s = write_reference_ckpt(src, path)
        rec = ingest_one(f"{name} .ckpt", src, path, wav20, wavs16, card,
                         lambda: gt.load_model(path))
        rec["save_s"] = save_s
        if name == "v3_ctc":
            t0 = time.perf_counter()
            gt_ckpt.convert_reference_checkpoint(path)
            rec["convert_s"] = time.perf_counter() - t0
            print(f"ingest {name}: torch.save {save_s:.1f} s, "
                  f"{os.path.getsize(path) / 2 ** 30:.2f} GiB; "
                  f"convert_reference_checkpoint (torch.load, cfg, "
                  f"layouts) {rec['convert_s']:.1f} s host; card {card}",
                  flush=True)
        report[name] = rec
        for k in launches:
            launches[k] += rec["launches"][k]
        if name == "v3_ctc":
            ft_path = os.path.join(root, "finetuned.ckpt")
            write_reference_ckpt(src, ft_path, base_name="ctc")
            rec = ingest_one("v3_ctc fine-tuned Lightning .ckpt", src,
                             ft_path, wav20, wavs16, card,
                             lambda: gt.load_model(
                                 ft_path, download_root=os.path.join(
                                     root, "empty")))
            report["lightning"] = rec
            os.remove(ft_path)
            saved = (gt._URL_DIR, gt._MODEL_HASHES)
            gt._URL_DIR = f"file://{cdn}"
            gt._MODEL_HASHES = dict(saved[1], v3_ctc=gt.hash_path(path))
            cache = os.path.join(root, "cache")
            try:
                report["by_name"] = ingest_one(
                    "ctc by name (download, md5, convert, cache)", src,
                    path, wav20, wavs16, card,
                    lambda: gt.load_model("ctc", download_root=cache))
                if not os.path.isfile(os.path.join(cache, "v3_ctc.npz")):
                    raise AssertionError("no converted artifact cached")
                gt._URL_DIR = "file:///nonexistent"
                report["cached"] = ingest_one(
                    "ctc by name (cached artifact)", src, path, wav20,
                    wavs16, card,
                    lambda: gt.load_model("v3_ctc", download_root=cache))
            finally:
                gt._URL_DIR, gt._MODEL_HASHES = saved
            shutil.rmtree(cache)
            for key in ("lightning", "by_name", "cached"):
                for k in launches:
                    launches[k] += report[key]["launches"][k]
        os.remove(path)
        del src
        torch.cuda.empty_cache()
    report["launches"] = launches
    return report


def rnnt_loss_timing(ft, batch, card: str) -> dict:
    """The RNNT loss alone on one batch's encoder output (fp32): forward and
    backward ms by CUDA events (the median of 3), its peak memory above
    what was allocated before, and the wavefront's T' + U steps."""
    dev_batch = ft._to_device(batch)
    with torch.no_grad():
        _, (_, encoded, enc_lens) = ft._forward_loss(dev_batch, train=True)
    tokens, tok_lens = dev_batch[2], dev_batch[3]
    times = []
    for _ in range(3):
        enc = encoded.detach().float().requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = rnnt_loss(ft.model.head, enc, tokens, enc_lens, tok_lens,
                         ft.blank_id, ft.tc.rnnt_time_chunk)
        ev[1].record()
        loss.backward()
        ev[2].record()
        torch.cuda.synchronize()
        times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      (torch.cuda.max_memory_allocated() - base) / 2 ** 20))
        if not (math.isfinite(float(loss.detach())) and bool(
                torch.isfinite(enc.grad).all())):
            raise AssertionError("rnnt loss or its gradient not finite")
    fwd, bwd, peak = (sorted(c)[1] for c in zip(*times))
    rec = {"forward_ms": fwd, "backward_ms": bwd, "peak_mib": peak,
           "t_prime": int(encoded.shape[1]), "u": int(tokens.shape[1]),
           "diagonals": int(encoded.shape[1] + tokens.shape[1])}
    print(f"rnnt loss alone, B {encoded.shape[0]}, T' {rec['t_prime']}, "
          f"U {rec['u']}: forward {fwd:.1f} ms, backward {bwd:.1f} ms "
          f"(CUDA events, median of 3), peak {peak:.0f} MiB above the "
          f"encoder output; card {card}", flush=True)
    return rec


def step_summary(records: list) -> dict:
    return {"step_ms": [r["wall_ms"] for r in records],
            "forward_ms": [r["forward_ms"] for r in records],
            "backward_ms": [r["backward_ms"] for r in records],
            "peak_gib": max(r["peak_gib"] for r in records)}


def remat_gradients(model, batch, policy: str, before: dict) -> dict:
    """One step under ``policy`` from ``before`` (no clip, lr 0 at the first
    update): the raw gradients; the parameters are restored after."""
    ft = FineTuner(model, TrainConfig(
        total_steps=4, precision="bf16", grad_clip=1e30,
        activation_checkpointing=True, remat_policy=policy))
    ft.train_step(batch)
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    restore(model, before)
    return grads


def restore(model, snap: dict) -> None:
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(snap[n])


def grad_group_errors(got: dict, ref: dict) -> dict:
    groups = defaultdict(lambda: [0.0, 0.0])
    for n, g_ref in ref.items():
        group = next(g for g, pattern in GRAD_GROUPS if re.search(pattern, n))
        groups[group][0] += float((got[n] - g_ref).pow(2).sum())
        groups[group][1] += float(g_ref.pow(2).sum())
    return {g: math.sqrt(num / den) for g, (num, den) in groups.items()
            if den > 0}


def attention_kernels(name: str) -> tuple:
    """(forward in training, its backward, inference at batch 16) of the
    attention of preset ``name``: K3, K4, K1 (rotary) or K5, K6, K5."""
    if make_preset(name).encoder.self_attention_model == "rel_pos":
        return "K5", "K6", "K5"
    return "K3", "K4", "K1"


def rnnt_training_phase(manifest: str, card: str,
                        name: str = "v3_rnnt") -> dict:
    """``name`` (v3_rnnt or v2_rnnt) at batch 16 of 10-20 s, bf16 over fp32
    masters: the CLI for 3 steps, then ``FineTuner.train_step`` x 3 without
    activation checkpointing and under ``remat_policy`` "full" and "dots";
    "dots" against "full" on one step's gradients; the loss alone.  A
    rel-pos model's pos biases are drawn apart, and a step without remat is
    taken fenced (``device_ms``) and once more with K6's launches recorded
    and held to its plain version (``k6_step_check``)."""
    report = {}
    n_layers = make_preset(name).encoder.n_layers
    fwd, bwd, infer = attention_kernels(name)
    save_dir = os.path.join(os.path.dirname(manifest), f"exp_{name}")
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    train_cli.main([
        "--model_name", name, "--init", "random", "--seed", "0",
        "--train_manifest", manifest, "--val_manifest", manifest,
        "--batch_size", "16", "--precision", "bf16", "--max_steps", "3",
        "--val_first_batches", "1", "--save_top_k", "0",
        "--log_every_n_steps", "1", "--save_dir", save_dir])
    torch.cuda.synchronize()
    got = counts()
    # 3 steps (K3 or K5 forward, K4 or K6 backward), a validation batch at
    # the end of the first epoch (2 steps) and one at the end (K1 or K5)
    want = defaultdict(int)
    want[fwd] += 3 * n_layers
    want[bwd] += 3 * n_layers
    want[infer] += 2 * n_layers
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if r["kind"] == "train"]
    print(f"main path train CLI {name}, 3 steps + 2 validation batches: "
          f"{time.perf_counter() - t0:.1f} s, launches {got}; losses "
          + ", ".join(f"{r['loss']:.4f}" for r in train_recs) + "; card "
          + card, flush=True)
    if got != {k: want.get(k, 0) for k in got}:
        raise AssertionError(f"rnnt train CLI: launches {got}, want {want}")
    if [r["step"] for r in train_recs] != [1, 2, 3] or not all(
            math.isfinite(r["loss"]) and r["loss"] > 0 for r in train_recs):
        raise AssertionError(f"rnnt train CLI: metrics {train_recs}")
    launches = defaultdict(int, got)
    report["cli"] = {"losses": [r["loss"] for r in train_recs],
                     "val_losses": [r["loss"] for r in recs
                                    if r["kind"] == "val"],
                     "seconds": time.perf_counter() - t0}
    shutil.rmtree(save_dir)

    model = gt.load_model(name, init="random", seed=0)
    if fwd == "K5":
        nonzero_pos_biases(model, seed=3)
    batch = first_batch(manifest, model.tokenizer, 16, stride=2)
    for policy, want in ((None, {fwd: n_layers, bwd: n_layers}),
                         ("full", {fwd: 2 * n_layers, bwd: n_layers}),
                         ("dots", {fwd: 2 * n_layers, bwd: n_layers})):
        label = f"{name}, remat {policy}" if policy else name
        if policy == "full":
            before = snapshot(model)
            g_full = remat_gradients(model, batch, "full", before)
            g_dots = remat_gradients(model, batch, "dots", before)
            rels = grad_group_errors(g_dots, g_full)
            print(f"{name} dots vs full, one step from the same weights: "
                  "gradient relative Frobenius error by group (tol "
                  f"{TRAIN_GRAD_RTOL}): " + ", ".join(
                      f"{g} {r:.2e}" for g, r in rels.items()), flush=True)
            if not all(r <= TRAIN_GRAD_RTOL for r in rels.values()):
                raise AssertionError(f"dots vs full gradients: {rels}")
            report["dots_vs_full"] = rels
            del g_full, g_dots, before
        tc = TrainConfig(total_steps=4, precision="bf16",
                         activation_checkpointing=policy is not None,
                         remat_policy=policy or "full")
        ft = FineTuner(model, tc)
        before = snapshot(model)
        records = []
        total = drive_train_steps(label, ft, batch, 3, want, card, records)
        assert_training_moved(label, ft, before)
        report[policy or "no_remat"] = step_summary(records)
        for k, n in total.items():
            launches[k] += n
        if policy is None:
            report["loss"] = rnnt_loss_timing(ft, batch, card)
        if policy is None and fwd == "K5":
            fa.reset_launch_counts()
            report["fenced_step"] = fenced_step(f"{name} train_step", ft,
                                                batch, card)
            with K6Recorder() as rec:
                ft.train_step(batch)
            torch.cuda.synchronize()
            for k, n in counts().items():
                launches[k] += n
            report["k6_step"] = k6_step_check(f"{name} batch 16", rec.calls)
        del ft, before
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    report["launches"] = dict(launches)
    return report


def ssl_phase(manifest: str, small_manifest: str, card: str,
              name: str = "v3_ssl") -> dict:
    """``name`` (v3_ssl, or v2_ssl with its pos biases drawn apart) at batch
    16 of 10-20 s: ``SSLPretrainer.train_step`` x 3, then the pretrain CLI
    for 2 steps and a resume for a third."""
    n_layers = make_preset(name).encoder.n_layers
    fwd, bwd, infer = attention_kernels(name)
    report = {}
    model = gt.load_model(name, init="random", seed=0)
    if fwd == "K5":
        nonzero_pos_biases(model, seed=5)
    batch = first_batch(manifest, gt_tokenizer(), 16, stride=2)[:2]
    pt = gt_pretrain.SSLPretrainer(model, gt_pretrain.PretrainConfig(
        total_steps=4, precision="bf16"))
    q0 = {k: v.clone() for k, v in pt.quantizer.items()}
    head0 = pt.ssl_head["w"].detach().clone()
    before = snapshot(model)
    records = []
    launches = defaultdict(int, drive_train_steps(
        f"{name} BEST-RQ", pt, batch, 3, {fwd: n_layers, bwd: n_layers},
        card, records))
    assert_training_moved(f"{name} BEST-RQ", pt, before)
    if torch.equal(pt.ssl_head["w"].detach(), head0) or not all(
            torch.equal(v, q0[k]) for k, v in pt.quantizer.items()):
        raise AssertionError("ssl: the head did not move or the quantizer "
                             "did")
    fa.reset_launch_counts()
    loss, acc = pt.eval_step(batch)
    got = counts()
    print(f"{name} eval_step: masked loss {loss:.4f}, accuracy {acc:.4f}, "
          f"launches {got}", flush=True)
    if got != {k: (n_layers if k == infer else 0) for k in got} or not (
            math.isfinite(loss)):
        raise AssertionError(f"ssl eval_step: launches {got}, loss {loss}")
    launches[infer] += got[infer]
    report["steps"] = step_summary(records)
    report["eval"] = {"loss": loss, "accuracy": acc}
    del pt, model, before
    torch.cuda.empty_cache()

    save_dir = os.path.join(os.path.dirname(manifest), f"exp_{name}")
    args = ["--model_name", name, "--init", "random", "--train_manifest",
            manifest, "--val_manifest", small_manifest, "--batch_size", "16",
            "--save_dir", save_dir, "--log_every_n_steps", "1",
            "--save_top_k", "1"]
    t0 = time.perf_counter()
    fa.reset_launch_counts()
    gt_pretrain.main(args + ["--max_steps", "2"])
    ckpts = [f for f in os.listdir(save_dir) if f.endswith(".ckpt")]
    gt_pretrain.main(args + ["--max_steps", "3", "--resume_from_checkpoint",
                             os.path.join(save_dir, ckpts[0])])
    torch.cuda.synchronize()
    got = counts()
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs if r["kind"] == "train"]
    # 3 steps in all, one validation batch after each run
    want = defaultdict(int)
    want[fwd] += 3 * n_layers
    want[bwd] += 3 * n_layers
    want[infer] += 2 * n_layers
    print(f"main path pretrain CLI {name}, 2 steps, then a resume for 1: "
          f"{time.perf_counter() - t0:.1f} s, steps {steps}, launches {got}; "
          f"card {card}", flush=True)
    if got != {k: want.get(k, 0) for k in got} or steps != [1, 2, 3]:
        raise AssertionError(f"pretrain CLI: launches {got}, steps {steps}")
    if not os.path.isfile(os.path.join(save_dir, "final.npz")):
        raise AssertionError("pretrain CLI wrote no final.npz")
    for k, n in got.items():
        launches[k] += n
    report["cli"] = {"steps": steps, "seconds": time.perf_counter() - t0}
    shutil.rmtree(save_dir)
    report["launches"] = dict(launches)
    return report


def gt_tokenizer():
    from gigaam_tpu_torch.decode.tokenizer import Tokenizer

    return Tokenizer(list(RU_VOCAB))


def conv1d_phase(rng, card: str) -> dict:
    """A full-width v3 config with conv1d subsampling: ``encode_batch`` of
    16 clips of 1-2 s on the card in bf16 (K1) against the CPU fp32 model;
    then the card in fp32 (TF32 off, the composed attention), whose greedy
    ids equal the CPU's on every frame with a margin of CONV1D_MARGIN."""
    cfg = make_preset("v3_ctc")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, subsampling="conv1d"))
    wavs = [synth_wav(s, rng) for s in np.linspace(1.0, 2.0, 16)]
    card_model = gt.GigaAMASR(cfg, seed=0)
    cpu = gt.GigaAMASR(cfg, seed=0, device="cpu")
    with torch.inference_mode():
        enc_c, len_c = cpu.encode_batch(wavs)
        lp_c = ctc_log_probs(cpu.head, enc_c)
        fa.reset_launch_counts()
        enc_g, len_g = card_model.encode_batch(wavs)
        torch.cuda.synchronize()
        got = counts()
        lp_g = ctc_log_probs(card_model.head, enc_g).float().cpu()
        card_model.compute_dtype = torch.float32
        card_model.use_fused_attention = False
        enc_32, _ = card_model.encode_batch(wavs)
        lp_32 = ctc_log_probs(card_model.head, enc_32).cpu()
    if got != {k: (cfg.encoder.n_layers if k == "K1" else 0) for k in got}:
        raise AssertionError(f"conv1d: launches {got}")
    if not torch.equal(len_g.cpu(), len_c):
        raise AssertionError("conv1d: lengths differ")
    rows = torch.arange(enc_c.shape[1])[None, :] < len_c[:, None]
    diff = (enc_g.float().cpu() - enc_c)[rows]
    rel = float(diff.norm() / enc_c[rows].norm())
    top2 = lp_c.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[rows]
    ids_c = lp_c.argmax(-1)[rows]
    ids_g, ids_32 = lp_g.argmax(-1)[rows], lp_32.argmax(-1)[rows]
    clear = margin >= CONV1D_MARGIN
    flips_32 = int((ids_32 != ids_c)[clear].sum())
    bf16_agree = float((ids_g == ids_c).float().mean())
    wrong = margin[ids_g != ids_c]
    rec = {"launches": got, "bf16_relative": rel,
           "bf16_ids_agree": bf16_agree,
           "bf16_largest_flipped_margin": (float(wrong.max()) if len(wrong)
                                           else 0.0),
           "fp32_frames_compared": int(clear.sum()),
           "frames": int(rows.sum()), "fp32_flips": flips_32}
    print(f"conv1d v3 encode_batch 16 x 1-2 s, T'={enc_c.shape[1]}: card "
          f"bf16 (K1, launches {got}) vs CPU fp32 relative {rel:.4f} (tol "
          f"{ENCODER_RTOL}), ids agree on {bf16_agree:.4f}; card fp32 "
          f"(composed attention) ids equal the CPU's on "
          f"{int(clear.sum()) - flips_32} of {int(clear.sum())} frames with a "
          f"margin >= {CONV1D_MARGIN} ({int(rows.sum())} valid); card "
          f"{card}", flush=True)
    if not rel <= ENCODER_RTOL or flips_32:
        raise AssertionError(f"conv1d: {rec}")
    del card_model, cpu
    torch.cuda.empty_cache()
    return rec


def ingest_train_path(card: str) -> dict:
    """Phase 17: reference checkpoints in, RNNT fine-tuning with selective
    remat, BEST-RQ pretraining, conv1d subsampling."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    report = {"seconds_by_step": {}}

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())

    with tempfile.TemporaryDirectory() as root:
        report["ingest"] = ingestion_phase(root, rng, card)
        lap("ingestion")
        manifest = write_train_set(root, rng, 32, 10.0, 20.0)
        small = os.path.join(root, "small")
        os.makedirs(small)
        small_manifest = write_train_set(small, rng, 4, 2.0, 4.0)
        report["rnnt_train"] = rnnt_training_phase(manifest, card)
        lap("rnnt training")
        training_reference_phase("v3_rnnt", small_manifest)
        lap("rnnt training reference")
        report["ssl"] = ssl_phase(manifest, small_manifest, card)
        lap("BEST-RQ")
    report["conv1d"] = conv1d_phase(rng, card)
    lap("conv1d")
    launches = defaultdict(int)
    for part in (report["ingest"], report["rnnt_train"], report["ssl"],
                 report["conv1d"]):
        for k, n in part["launches"].items():
            launches[k] += n
    report["launches"] = dict(launches)
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# Export, serving, streaming and the client (phase 18)
# ---------------------------------------------------------------------------

EXPORT_SECONDS = 20
EXPORT_BATCHES = (1, 8)
SSL_SECONDS = 125          # T' 3125, past the fold: K3
EMO_SECONDS = 10
# the exported RNNT loop projects the encoder frame per step, the live one
# once per call (heads.py): fp32 sums in another order, which may flip a
# decision only where the joint's top two log-probs lie this close
RNNT_EXPORT_MARGIN = 1e-4
SERVE_MAX_BATCH = 8
SERVE_WINDOW_MS = 15.0
SERVE_POSTS, SERVE_CLIENTS = 32, 8
SERVE_LONG_S, SERVE_STREAM_S, SERVE_CHUNK_S = 120.0, 30.0, 0.5
SERVE_BURST = 24           # posts at once against a queue of SERVE_SMALL_QUEUE
SERVE_SMALL_QUEUE = 1

# The fresh process that reloads the exported artifacts: it imports
# exported_infer (and the launch counters) only, loads each artifact dir
# onto the card and writes what the parent compares with the live models.
EXPORTED_CHILD = r'''
import json, os, sys, time
import numpy as np
import torch
from gigaam_tpu_torch import exported_infer as ei
from gigaam_tpu_torch.ops import fused_attention as fa

root = sys.argv[1]
clips = np.load(os.path.join(root, "clips.npz"))
report = {}


def counted(fn):
    fa.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {"K1": fa.folded_rotary_attention_lnres.launches,
                 "K2": fa.folded_rotary_attention.launches,
                 "K3": fa.fused_mha.launches, "K5": fa.fused_relpos_mha.launches}


t0 = time.perf_counter()
asr = ei.ExportedASR(os.path.join(root, "v3_ctc"))
report["v3_ctc_load_s"] = time.perf_counter() - t0
for name, wavs in (("b8", [clips[f"w8_{i}"] for i in range(8)]),
                   ("b1", [clips["w1"]])):
    with torch.inference_mode():
        g, feats, lens = asr._bucketed("ctc", wavs)
        (lp, enc_lens), n = counted(lambda: g(feats, lens))
    np.save(os.path.join(root, f"lp_{name}.npy"), lp.float().cpu().numpy())
    texts, n_texts = counted(lambda: asr.transcribe_batch(wavs))
    report[name] = {"launches": n, "transcribe_launches": n_texts,
                    "texts": texts, "bucket": [g.meta["batch"], g.meta["t_feat"]],
                    "enc_lens": enc_lens.cpu().tolist()}
for kind in ("ssl", "emo"):
    t0 = time.perf_counter()
    cls = ei.ExportedClassifier(os.path.join(root, kind))
    load_s = time.perf_counter() - t0
    out, n = counted(lambda: cls.infer_batch([clips[kind]]))
    np.save(os.path.join(root, f"out_{kind}.npy"), out[0])
    report[kind] = {"launches": n, "load_s": load_s}
report["jax_modules"] = [m for m in sys.modules if m.split(".")[0] in
                         ("jax", "jaxlib", "gigaam_tpu")]
with open(os.path.join(root, "child.json"), "w") as f:
    json.dump(report, f)
'''


def two_layer(name: str, seed: int):
    """A full-width (16 x 48) model of ``name`` cut to 2 layers, bf16
    weights, random from ``seed``."""
    cfg = make_preset(name)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2))
    model = model_class_for(cfg)(cfg, seed=seed)
    model.cast_encoder()
    return model


def graph_files(root: str, manifest: dict) -> dict:
    return {e["file"]: os.path.getsize(os.path.join(root, e["file"])) / 1e9
            for entries in manifest["graphs"].values() for e in entries}


def relative(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float().cpu(), ref.float().cpu()
    return float((got - ref).norm() / ref.norm())


def live_logprobs(model, wavs, bucket: int, rows: int):
    """The live model's log-probs and lengths for ``wavs`` padded to
    ``rows`` and ``bucket`` samples, the shapes of an exported bucket."""
    wavs = list(wavs) + [np.zeros(0, np.float32)] * (rows - len(wavs))
    with torch.inference_mode():
        dev_batch, dev_lens, _, pos = model._device_batch(wavs, bucket)
        return model._ctc_logprobs(dev_batch, dev_lens, pos)


def export_ctc_checks(model, root: str, clips: dict, child: dict,
                      card: str) -> dict:
    """The reloaded v3_ctc graphs against the live model: greedy ids and
    texts equal, log-probs against the fused live path (max abs) and the
    composed one (relative, ENCODER_RTOL), K1/K2 counted in the child."""
    bucket = EXPORT_SECONDS * SAMPLE_RATE
    out = {}
    for name, wavs, kernel in (("b8", [clips[f"w8_{i}"] for i in range(8)],
                                "K1"),
                               ("b1", [clips["w1"]], "K2")):
        rows = 8 if name == "b8" else 1
        got = child[name]
        want = {k: (model.cfg.encoder.n_layers if k == kernel else 0)
                for k in got["launches"]}
        if got["launches"] != want:
            raise AssertionError(f"exported {name}: launches "
                                 f"{got['launches']}, expected {want}")
        lp = torch.from_numpy(np.load(os.path.join(root, f"lp_{name}.npy")))
        lp_live, lens = live_logprobs(model, wavs, bucket, rows)
        model.use_fused_attention = False
        lp_plain, _ = live_logprobs(model, wavs, bucket, rows)
        model.use_fused_attention = True
        lens = lens.cpu()
        if lens.tolist() != got["enc_lens"]:
            raise AssertionError(f"exported {name}: lengths")
        valid = torch.arange(lp.shape[1])[None, :] < lens[:, None]
        ids_equal = bool((lp.argmax(-1) == lp_live.cpu().argmax(-1))[valid]
                         .all())
        live_texts = [t for t, _ in model._decode_batch(
            wavs, False, pad_rows_to=rows, bucket=bucket)]
        row = {"launches": got["launches"],
               "max_abs_vs_live": float((lp - lp_live.cpu())[valid].abs()
                                        .max()),
               "relative_vs_composed": relative(lp[valid],
                                                lp_plain.cpu()[valid]),
               "ids_agree_composed": float((lp.argmax(-1) == lp_plain.cpu()
                                            .argmax(-1))[valid].float()
                                           .mean()),
               "ids_equal_live": ids_equal,
               "texts_equal_live": got["texts"] == live_texts}
        print(f"  exported v3_ctc {name} ({kernel}): launches "
              f"{got['launches']}; vs live max_abs {row['max_abs_vs_live']:.3g}"
              f", ids equal {ids_equal}, texts equal "
              f"{row['texts_equal_live']}; vs composed relative "
              f"{row['relative_vs_composed']:.4f}; card {card}", flush=True)
        if not (ids_equal and row["texts_equal_live"]
                and row["relative_vs_composed"] <= ENCODER_RTOL):
            raise AssertionError(f"exported v3_ctc {name}: {row}")
        out[name] = row
    return out


def export_classifier_checks(models: dict, root: str, clips: dict,
                             child: dict, card: str) -> dict:
    """The reloaded 2-layer SSL (125 s: K3) and emo (K5) graphs against the
    live models: within 1% of the largest live output of the fused live
    path (the same kernels at the same shapes), within ENCODER_RTOL of the
    composed one, their kernel counted in the child."""
    out = {}
    for kind, kernel in (("ssl", "K3"), ("emo", "K5")):
        model = models[kind]
        got = child[kind]
        want = {k: (2 if k == kernel else 0) for k in got["launches"]}
        if got["launches"] != want:
            raise AssertionError(f"exported {kind}: launches "
                                 f"{got['launches']}, expected {want}")
        exported = torch.from_numpy(np.load(os.path.join(root,
                                                         f"out_{kind}.npy")))
        refs = []
        for fused in (True, False):
            model.use_fused_attention = fused
            with torch.inference_mode():
                if kind == "ssl":
                    enc, lens = model.encode_batch([clips[kind]])
                    refs.append(enc[0, :int(lens[0])].float().cpu())
                else:
                    refs.append(torch.tensor(list(
                        model.get_probs(clips[kind]).values())))
        model.use_fused_attention = True
        row = {"launches": got["launches"], "load_s": got["load_s"],
               "shape": list(exported.shape),
               "max_abs_vs_live": float((exported - refs[0]).abs().max()),
               "relative_vs_composed": relative(exported, refs[1])}
        print(f"  exported {kind} ({kernel}): launches {got['launches']}, "
              f"{row['shape']}; vs live max_abs {row['max_abs_vs_live']:.3g};"
              f" vs composed relative {row['relative_vs_composed']:.4f}; "
              f"card {card}", flush=True)
        if not (row["max_abs_vs_live"] <= 1e-2 * float(refs[0].abs().max())
                and row["relative_vs_composed"] <= ENCODER_RTOL):
            raise AssertionError(f"exported {kind}: {row}")
        out[kind] = row
    return out


def first_divergence(live, exported):
    """(index, frame) of the first decision where two (tokens, frames)
    sequences part, or None."""
    (lt, lf), (et, ef) = live, exported
    for i in range(max(len(lt), len(et))):
        a = (lt[i], lf[i]) if i < len(lt) else None
        b = (et[i], ef[i]) if i < len(et) else None
        if a != b:
            frames = [x[1] for x in (a, b) if x is not None]
            return i, min(frames)
    return None


def export_rnnt_checks(model, root: str, wavs8, card: str) -> dict:
    """Full-width v3_rnnt (blank bias RNNT_BLANK_BIAS) exported at batch 8
    x 20 s: encoder, ``decoder`` and ``joint``.  The exported label loop's
    (token, frame) sequences against the live greedy decoder's on the same
    encoder output: every row equal up to its first differing decision,
    which must be a near tie (top-2 margin <= RNNT_EXPORT_MARGIN, from a
    teacher-forced fp32 replay of the live prefix); such rows are counted
    and their tails not compared."""
    from gigaam_tpu_torch import exported_infer as ei

    bucket = EXPORT_SECONDS * SAMPLE_RATE
    art = os.path.join(root, "v3_rnnt")
    t0 = time.perf_counter()
    manifest = model.to_exported(art, batch_sizes=(8,),
                                 audio_seconds=(EXPORT_SECONDS,))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = ei.ExportedASR(art)
    load_s = time.perf_counter() - t0
    ms = model.cfg.decoding.max_symbols_per_step
    head = model.cfg.head
    with torch.inference_mode():
        g, feats, lens = runner._bucketed("encoder", wavs8)
        encoded, enc_lens = g(feats, lens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pairs = ei._rnnt_label_loop(
            encoded.float(), enc_lens.cpu().numpy(), runner.graphs["decoder"][0],
            runner.graphs["joint"][0], model.blank_id,
            (head.decoder.pred_rnn_layers, 8, head.decoder.pred_hidden), ms)
        loop_ms = (time.perf_counter() - t0) * 1e3
        dev_batch, dev_lens, _, pos = model._device_batch(wavs8, bucket)
        enc_live, lens_live = model._encode(dev_batch, dev_lens, pos)
        tokens, frames, counts_ = (o.cpu() for o in model.rnnt.decode(
            model.head, enc_live, lens_live, max_symbols=ms))
    enc_equal = bool(torch.equal(encoded, enc_live.float()))
    live = [(tokens[b, :counts_[b]].tolist(), frames[b, :counts_[b]].tolist())
            for b in range(8)]
    near_ties, margins, compared = 0, [], 0
    cpu_head = copy.deepcopy(model.head).cpu()
    enc_cpu = enc_live.float().cpu()
    for b in range(8):
        split = first_divergence(live[b], pairs[b])
        if split is None:
            compared += int(lens_live[b])
            continue
        i, t = split
        with torch.inference_mode(), full_fp32():
            pred = rnnt_predict_sequence(
                cpu_head, torch.tensor([live[b][0][:i]]).long())[0, i]
            logp = rnnt_joint_step_preproj(
                cpu_head, rnnt_joint_enc_proj(cpu_head, enc_cpu[b, t][None]),
                pred[None])[0]
        top = logp.topk(2).values
        margin = float(top[0] - top[1])
        margins.append(margin)
        if margin > RNNT_EXPORT_MARGIN:
            raise AssertionError(f"exported v3_rnnt row {b}: decision {i} at "
                                 f"frame {t} differs with margin {margin}")
        near_ties += 1
        compared += t
    row = {"export_s": export_s, "load_s": load_s,
           "files_gb": graph_files(art, manifest),
           "encoder_equal_live": enc_equal, "rows_equal": 8 - near_ties,
           "rows_parted_at_a_near_tie": near_ties,
           "parting_margins": margins, "frames_compared": compared,
           "frames": int(lens_live.sum()),
           "tokens": int(sum(len(p[0]) for p in pairs)),
           "exported_loop_wall_ms": loop_ms}
    print(f"  exported v3_rnnt b8: encoder equal live {enc_equal}; "
          f"{row['rows_equal']} rows equal the live greedy decode, "
          f"{near_ties} part at a near tie (margins {margins}); "
          f"{row['tokens']} tokens; exported loop {loop_ms:.1f} ms wall; "
          f"card {card}", flush=True)
    if not enc_equal:
        raise AssertionError("exported v3_rnnt encoder differs from live")
    return row


class Recorder:
    """Records every ``_decode_batch_submit`` of a served model (rows,
    keywords, finalized outputs) and the wall of each ``submit``."""

    def __init__(self, model, server):
        self.model, self.batches, self.submits = model, [], []
        self._lock = threading.Lock()
        real_submit, real_srv_submit = model._decode_batch_submit, server.submit

        def submit(wavs, *a, **kw):
            fin = real_submit(wavs, *a, **kw)
            rec = {"wavs": [np.array(w) for w in wavs], "args": a, "kw": kw}

            def finalize():
                rec["out"] = fin()
                with self._lock:
                    self.batches.append(rec)
                return rec["out"]
            return finalize

        def srv_submit(wav, timestamps, timeout=120.0):
            t0 = time.perf_counter()
            req = real_srv_submit(wav, timestamps, timeout)
            with self._lock:
                self.submits.append((timestamps, (time.perf_counter() - t0)
                                     * 1e3, req.error))
            return req

        model._decode_batch_submit = submit
        server.submit = srv_submit

    def replay(self, label: str) -> dict:
        """Each recorded batch again through ``_decode_batch`` (the same
        rows and keywords), with the recording removed: texts and words
        must be equal."""
        del self.model._decode_batch_submit
        sizes = []
        for rec in self.batches:
            again = self.model._decode_batch(rec["wavs"], *rec["args"],
                                             **rec["kw"])
            flat = lambda out: [(t, None if w is None else [x.to_dict()  # noqa: E731
                                                            for x in w])
                                for t, w in out]
            if flat(again) != flat(rec["out"]):
                raise AssertionError(f"{label}: a served batch differs from "
                                     f"the live call on its rows")
            sizes.append(len(rec["wavs"]))
        return {"batches": len(sizes), "rows": sizes}


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def serve_load(url: str, posts, long_wav, stream_wav):
    """The load on one server, from its own threads: SERVE_POSTS posts from
    SERVE_CLIENTS threads, one longform post, one chunked stream.  Returns
    the threads (started) and where their results land."""
    from gigaam_tpu_torch import client

    res = {"posts": [None] * len(posts), "latency_ms": [None] * len(posts)}

    def post(i):
        t0 = time.perf_counter()
        res["posts"][i] = client.transcribe_one(url, posts[i], timeout=600)
        res["latency_ms"][i] = (time.perf_counter() - t0) * 1e3

    def posts_worker(k):
        for i in range(k, len(posts), SERVE_CLIENTS):
            post(i)

    def longform():
        t0 = time.perf_counter()
        res["longform"] = client.transcribe_longform(url, long_wav,
                                                     timeout=600)
        res["longform_ms"] = (time.perf_counter() - t0) * 1e3

    def stream():
        t0 = time.perf_counter()
        res["stream"] = client.transcribe_stream(url, stream_wav,
                                                 chunk_s=SERVE_CHUNK_S,
                                                 timeout=600)
        res["stream_ms"] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=posts_worker, args=(k,))
               for k in range(SERVE_CLIENTS)]
    threads += [threading.Thread(target=longform),
                threading.Thread(target=stream)]
    return threads, res


def serve_phase(models: dict, rng, card: str) -> dict:
    """A v3_ctc and a v3_rnnt ``BatchingASRServer`` on 127.0.0.1
    (max_batch 8, window 15 ms), each after ``warmup(seconds=[5])`` only,
    under the same load at once (so the RNNT server captures its loop's
    graphs while the other threads submit): every served batch equal to
    the live call on its rows, the longform result equal to the live
    ``transcribe_longform``, each post's text against a lone live call,
    the stream's stride latency; then a small queue's 503s."""
    from gigaam_tpu_torch import client
    from gigaam_tpu_torch.audio import load_wav_bytes
    from gigaam_tpu_torch.serve import (ASRHTTPServer, BatchingASRServer,
                                        make_handler)

    posts = [synth_wav(s, rng) for s in rng.uniform(3.0, 20.0, SERVE_POSTS)]
    long_wav = longform_audio(SERVE_LONG_S, rng)
    stream_wav = synth_wav(SERVE_STREAM_S, rng)
    # what the server decodes: the 16-bit WAV body the client sends
    as_served = lambda w: load_wav_bytes(client._wav_bytes(w))  # noqa: E731
    report, running = {}, []
    fa.reset_launch_counts()
    for name, model in models.items():
        srv = BatchingASRServer(model, SERVE_MAX_BATCH, SERVE_WINDOW_MS)
        t0 = time.perf_counter()
        srv.warmup(seconds=[5])
        warm_s = time.perf_counter() - t0
        httpd = ASRHTTPServer(("127.0.0.1", 0), make_handler(srv))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        rec = Recorder(model, srv)
        captures = model.rnnt.captures if model.rnnt is not None else None
        threads, res = serve_load(f"http://127.0.0.1:{httpd.server_port}",
                                  posts, long_wav, stream_wav)
        running.append((name, model, srv, httpd, rec, threads, res, warm_s,
                        captures))
    t0 = time.perf_counter()
    for *_, threads, _, _, _ in running:
        for th in threads:
            th.start()
    for *_, threads, _, _, _ in running:
        for th in threads:
            th.join()
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = counts()
    for name, model, srv, httpd, rec, _, res, warm_s, captures in running:
        httpd.shutdown()
        srv.shutdown()
        if any(p is None or "text" not in p for p in res["posts"]):
            raise AssertionError(f"{name} server: a post failed")
        errors = [e for _, _, e in rec.submits if e]
        if errors:
            raise AssertionError(f"{name} server: {errors[:3]}")
        replay = rec.replay(f"{name} server")
        lone = [t for t, _ in (model._decode_batch([as_served(w)], False,
                                                   pad_rows_to=SERVE_MAX_BATCH,
                                                   bucket=5 * SAMPLE_RATE)[0]
                               for w in posts)]
        lone_equal = sum(p["text"] == t for p, t in zip(res["posts"], lone))
        ref = model.transcribe_longform(as_served(long_wav),
                                        fr_batch_size=srv.longform_batch,
                                        bucket=srv.bucket_samples)
        if res["longform"] != json.loads(json.dumps(
                ref.to_dict(timestamps=False))):
            raise AssertionError(f"{name} server: longform differs from live")
        stream = res["stream"]
        if not stream or stream[-1]["kind"] != "committed":
            raise AssertionError(f"{name} server: stream {stream[-1:]}")
        strides = [ms for ts, ms, _ in rec.submits if ts]
        row = {"warmup_s": warm_s, "posts": len(posts),
               "latency_ms_p50": percentile(res["latency_ms"], 50),
               "latency_ms_p95": percentile(res["latency_ms"], 95),
               "batches": replay["batches"],
               "rows_per_batch": replay["rows"],
               "posts_equal_lone_live_call": lone_equal,
               "longform_ms": res["longform_ms"],
               "longform_segments": len(ref.segments),
               "stream_ms": res["stream_ms"], "stream_events": len(stream),
               "stride_decodes": len(strides),
               "stride_ms_p50": percentile(strides, 50),
               "stride_ms_p95": percentile(strides, 95)}
        if captures is not None:
            row["captures_during_load"] = model.rnnt.captures - captures
        print(f"  serve {name}: {len(posts)} posts p50 "
              f"{row['latency_ms_p50']:.1f} ms p95 {row['latency_ms_p95']:.1f}"
              f" ms, {row['batches']} batches {row['rows_per_batch']}, "
              f"{lone_equal}/{len(posts)} equal to a lone call; longform "
              f"{row['longform_ms']:.0f} ms; stream {len(strides)} strides "
              f"p50 {row['stride_ms_p50']:.1f} ms; card {card}", flush=True)
        report[name] = row
    report["load_s"] = load_s
    report["launches"] = launches

    # overload: a queue of SERVE_SMALL_QUEUE under a burst of SERVE_BURST
    model = models["v3_ctc"]
    srv = BatchingASRServer(model, SERVE_MAX_BATCH, SERVE_WINDOW_MS,
                            max_queue=SERVE_SMALL_QUEUE)
    httpd = ASRHTTPServer(("127.0.0.1", 0), make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    codes = []

    def burst(w):
        try:
            client.transcribe_one(url, w, timeout=120)
            codes.append(200)
        except urllib.error.HTTPError as e:
            codes.append(e.code)

    threads = [threading.Thread(target=burst, args=(posts[i % len(posts)],))
               for i in range(SERVE_BURST)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    httpd.shutdown()
    srv.shutdown()
    report["overload"] = {"burst": SERVE_BURST, "max_queue": SERVE_SMALL_QUEUE,
                          "ok": codes.count(200), "503": codes.count(503)}
    print(f"  serve overload: {report['overload']}; card {card}", flush=True)
    if codes.count(503) == 0 or codes.count(200) + codes.count(503) != len(
            codes):
        raise AssertionError(f"overload: {codes}")
    return report


def export_timings(model, art: str, wavs8, card: str) -> dict:
    """Exported (``ExportedASR.transcribe_batch``) against live
    (``_decode_batch``, the same rows and bucket) at batch 8 x 20 s: wall
    and device busy ms per call, profiled."""
    from gigaam_tpu_torch import exported_infer as ei

    runner = ei.ExportedASR(art)
    bucket = EXPORT_SECONDS * SAMPLE_RATE
    out = {}
    for label, fn in (
            ("exported", lambda: runner.transcribe_batch(wavs8)),
            ("live", lambda: model._decode_batch(wavs8, False, pad_rows_to=8,
                                                 bucket=bucket))):
        fn()
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
        got = assert_launches(f"{label} b8",
                              {"K1": 3 * model.cfg.encoder.n_layers})
        prof = profile_calls(f"v3_ctc {label} 8 x 20 s (K1)", fn, 3, wall)
        out[label] = {"wall_ms": wall, "device_busy_ms":
                      prof["device_busy_ms"], "idle_share": prof["idle_share"],
                      "launches": prof["launches"], "k1": got["K1"]}
    print(f"  exported vs live 8 x 20 s: wall {out['exported']['wall_ms']:.2f}"
          f" / {out['live']['wall_ms']:.2f} ms, device busy "
          f"{out['exported']['device_busy_ms']:.2f} / "
          f"{out['live']['device_busy_ms']:.2f} ms; card {card}", flush=True)
    return out


def export_serve_path(card: str) -> dict:
    """Phase 18: export (2-layer v3_ctc at batch 1 and 8 x 20 s, reloaded
    in a fresh process; 2-layer SSL at 125 s and emo; v3_rnnt's three
    graphs), then two servers under load and the overload check.  Tracing,
    saving and loading a graph take seconds a layer, and each layer is the
    same program; v3_rnnt keeps its 16 layers, at which RNNT_BLANK_BIAS
    makes its random joint emit."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(18)
    report = {"seconds_by_step": {}}
    launches = defaultdict(int)

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())

    ctc = gt.load_model("v3_ctc", init="random", seed=0, bf16_encoder=True)
    ctc_x = two_layer("v3_ctc", 0)
    ssl, emo = two_layer("v3_ssl", 1), two_layer("emo", 2)
    nonzero_pos_biases(emo, seed=3)
    clips = {f"w8_{i}": synth_wav(s, rng) for i, s in
             enumerate(np.linspace(EXPORT_SECONDS - 0.9, EXPORT_SECONDS, 8))}
    clips.update(w1=synth_wav(EXPORT_SECONDS - 0.5, rng),
                 ssl=synth_wav(SSL_SECONDS - 0.5, rng),
                 emo=synth_wav(EMO_SECONDS - 0.5, rng))
    with tempfile.TemporaryDirectory() as root:
        exports = {}
        for name, model, batches, seconds in (
                ("v3_ctc", ctc_x, EXPORT_BATCHES, EXPORT_SECONDS),
                ("ssl", ssl, (1,), SSL_SECONDS), ("emo", emo, (1,), EMO_SECONDS)):
            s0 = time.perf_counter()
            art = os.path.join(root, name)
            manifest = model.to_exported(art, batch_sizes=batches,
                                         audio_seconds=(seconds,))
            exports[name] = {"export_s": time.perf_counter() - s0,
                             "files_gb": graph_files(art, manifest)}
            print(f"  export {name}: {exports[name]}; card {card}", flush=True)
        lap("export")
        np.savez(os.path.join(root, "clips.npz"), **clips)
        s0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", EXPORTED_CHILD, root],
                               cwd=os.path.dirname(os.path.abspath(__file__)),
                               capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise AssertionError(f"exported child failed:\n{child.stderr}")
        with open(os.path.join(root, "child.json")) as f:
            got = json.load(f)
        if got["jax_modules"]:
            raise AssertionError(f"child imported {got['jax_modules']}")
        exports["v3_ctc"]["load_s"] = got["v3_ctc_load_s"]
        exports["child_s"] = time.perf_counter() - s0
        for part in ("b8", "b1", "ssl", "emo"):
            for k, n in got[part]["launches"].items():
                launches[k] += n
        lap("fresh process")
        exports["v3_ctc"]["checks"] = export_ctc_checks(ctc_x, root, clips,
                                                        got, card)
        exports.update(export_classifier_checks({"ssl": ssl, "emo": emo},
                                                root, clips, got, card))
        del ssl, emo
        lap("export checks")
        exports["v3_ctc"]["timings"] = export_timings(
            ctc_x, os.path.join(root, "v3_ctc"),
            [clips[f"w8_{i}"] for i in range(8)], card)
        launches["K1"] += 2 * 3 * ctc_x.cfg.encoder.n_layers
        del ctc_x
        lap("export timings")
        rnnt = gt.load_model("rnnt", init="random", seed=0, bf16_encoder=True)
        set_blank_bias(rnnt, float(rnnt.head["joint"]["out"]["b"][
            rnnt.blank_id]), RNNT_BLANK_BIAS)
        fa.reset_launch_counts()
        exports["v3_rnnt"] = export_rnnt_checks(
            rnnt, root, [clips[f"w8_{i}"] for i in range(8)], card)
        for k, n in counts().items():
            launches[k] += n
        lap("v3_rnnt export")
    report["export"] = exports
    report["serve"] = serve_phase({"v3_ctc": ctc, "v3_rnnt": rnnt}, rng, card)
    for k, n in report["serve"]["launches"].items():
        launches[k] += n
    lap("serve")
    report["launches"] = dict(launches)
    report["seconds"] = time.perf_counter() - t0
    return report


# ---------------------------------------------------------------------------
# Phase 19: data- and tensor-parallel inference and training
# ---------------------------------------------------------------------------

PAR_CLIPS = 16
PAR_LONGFORM_SECONDS = 360.0
# the training layouts' depth (full width): a step's collectives and its
# gloo transfers grow with the layers, and each layer is the same program
PAR_TRAIN_LAYERS = 4
# DP x TP against one process, both bf16 on the card.  The ranks run the same
# kernels on other row counts (cuBLAS may take another algorithm), and a
# row-parallel product's partial sums meet in fp32 after each has been
# rounded to bf16: an error of the bf16 step's own class.  The limits are
# the bf16 step's errors against fp32 (PERF.md, phase 13: loss 0.0009,
# gradient groups 0.0051-0.0176), rounded up: PAR_LOSS_RTOL for the loss,
# PAR_GRAD_RTOL for the gradient norm, the gradient groups and the sync-BN
# moments.  The position biases' and linear_pos' gradient is a sum over
# every (query, key) pair that cancels to a small remainder, so it carries
# the bf16 rounding of every pair, which a split over ranks changes: on the
# CPU in bf16 a 2-way split moved it 0.003 (data) and 0.015 (model) where
# fp32 moved nothing above 1e-7 (tests/test_torch_parallel.py).  On the
# H100 (NVIDIA H100 80GB HBM3, 700 W) at 16 layers the split read 0.026
# (data 2) and 0.046 (model 2), two one-process runs 4.4e-5 apart (K6's
# fp32 atomics: not the cause), and pos_bias_u taken from the other model
# rank 0.33; at PAR_TRAIN_LAYERS 0.008, 0.023, 2.3e-5 and 0.22.
# PAR_POS_GRAD_RTOL sits between the split and the fault, which must land
# PAR_FAULT_GAIN above it; all three are read in every run.
PAR_LOSS_RTOL = 0.002
PAR_GRAD_RTOL = 0.02
PAR_POS_GRAD_RTOL = 0.06
# DP log-probs against one process's on valid frames: one bf16 step of a
# logit of magnitude 8-16 is 0.0625 (the head's product is bf16)
PAR_LOGP_ATOL = 0.1
# a planted fault must land at least this far above its check's limit
PAR_FAULT_GAIN = 2.0
# (model, data, model) of the training layouts
PAR_CONFIGS = (("v3_ctc", 2, 1), ("v3_ctc", 1, 2), ("v2_ctc", 2, 1),
               ("v2_ctc", 1, 2))


def par_leaves(n_layers: int) -> str:
    """The leaves whose gradients and updates are compared whole: the first
    and the last layer, the subsampling and the head."""
    return (rf"^(encoder\.layers\.(0|{n_layers - 1})\.|encoder\.pre_encode\."
            r"|head\.)")


def par_model(name: str, n_layers: int = None):
    """Full-width ``name`` with random weights from seed 0 (v2: its position
    biases drawn nonzero), fp32 masters, cut to ``n_layers`` if given."""
    cfg = make_preset(name)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=n_layers or cfg.encoder.n_layers))
    model = model_class_for(cfg)(cfg, seed=0)
    if name == "v2_ctc":
        nonzero_pos_biases(model, seed=1)
    return model


def par_inference(model, clips, long_path: str, texts=None) -> dict:
    """The DP inference calls, in one order (every rank makes the same):
    ``_decode_batch`` of the 16 clips, of 2 and of 3, ``encode_batch`` of
    the 16, ``transcribe_longform`` and ``align_batch`` of the 16 (with
    ``texts``, else the call's own greedy texts); each call's launches and
    wall, what it returned, and the log-probs it decoded or aligned, read
    where the call computes them (the greedy mask's input, the aligner's
    input: fp32 on the card) and gathered in rank order, each submitted
    batch cut to its real rows: ``lp[label]`` is a list of (log-probs
    [T', V] on the CPU, length)."""
    from gigaam_tpu_torch.models import model as model_mod
    from gigaam_tpu_torch.parallel.collectives import all_gather_rows

    out = {"launches": {}, "wall_ms": {}, "lp": {}}
    seen, sizes = [], []        # this rank's blocks, each batch's rows

    def greedy_mask(lp, lens):
        seen.append((lp.float().cpu(), lens.cpu()))
        return ctc_greedy_mask(lp, lens)

    def ctc_logprobs(*args):
        lp, lens = type(model)._ctc_logprobs(model, *args)
        seen.append((lp.float().cpu(), lens.cpu()))
        return lp, lens

    def submit(wavs, *args, **kw):
        sizes.append(len(wavs))
        return type(model)._decode_batch_submit(model, wavs, *args, **kw)

    def gathered() -> list:
        blocks = [[(lp[i], int(n)) for i, n in enumerate(lens)]
                  for lp, lens in seen]
        per_rank = all_gather_rows(model._data_group, [blocks])
        rows = [row for k, n in enumerate(sizes)
                for row in [r for blocks_r in per_rank
                            for r in blocks_r[k]][:n]]
        seen.clear()
        sizes.clear()
        return rows

    def run(label, fn):
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["wall_ms"][label] = (time.perf_counter() - t0) * 1e3
        out["launches"][label] = {k: n for k, n in counts().items() if n}
        return res

    model_mod.ctc_greedy_mask = greedy_mask
    model._ctc_logprobs, model._decode_batch_submit = ctc_logprobs, submit
    try:
        for label, rows in (("decode16", clips), ("decode2", clips[:2]),
                            ("decode3", clips[2:5])):
            out[label] = [t for t, _ in run(label, lambda r=rows:
                                            model._decode_batch(r, False))]
            out["lp"][label] = gathered()
        run("encode16", lambda: model.encode_batch(clips))
        res = run("longform", lambda: model.transcribe_longform(
            long_path, fr_batch_size=LONGFORM_BATCH))
        out["longform"] = [(s.text, s.start, s.end) for s in res.segments]
        out["lp"]["longform"] = gathered()
        aligned = run("align16", lambda: model.align_batch(
            clips, texts if texts is not None else out["decode16"]))
        sizes.append(len(clips))
        out["lp"]["align16"] = gathered()
    finally:
        model_mod.ctc_greedy_mask = ctc_greedy_mask
        del model._ctc_logprobs, model._decode_batch_submit
    out["align16"] = [[(w.text, w.start, w.end) for w in r.words]
                      for r in aligned]
    out["texts16"] = texts if texts is not None else out["decode16"]
    # what each call's own log-probs give: the greedy texts decoded on the
    # host, and one process's ``align_batch`` on the aligned log-probs
    out["replayed"] = {label: par_greedy_texts(model, out["lp"][label])
                       for label in ("decode16", "decode2", "decode3",
                                     "longform")}
    out["replayed"]["align16"] = par_replay_align(
        model, clips, out["texts16"], out["lp"]["align16"])
    return out


def par_greedy_texts(model, rows) -> list:
    """Each (log-probs, length) row decoded greedily on the host, with the
    functions ``_ctc_submit`` decodes with."""
    from gigaam_tpu_torch.decode.ctc_greedy import ctc_extract

    texts = []
    for lp, n in rows:
        labels, keep = ctc_greedy_mask(lp[None], torch.tensor([n]))
        ((ids, _),) = ctc_extract(labels.numpy(), keep.numpy())
        texts.append(model.tokenizer.decode(ids))
    return texts


def par_replay_align(model, clips, texts, rows) -> list:
    """One process's ``align_batch`` of ``clips`` to ``texts`` with its
    encoder's log-probs replaced by ``rows`` (the DP call's, gathered): the
    Viterbi, the backtrack and the words on exactly what the DP call
    aligned."""
    lp = torch.stack([r for r, _ in rows]).to(model.device)
    lens = torch.tensor([n for _, n in rows], device=model.device)
    mesh = model.mesh
    model.mesh = None
    model._ctc_logprobs = lambda *args: (lp, lens)
    try:
        aligned = model.align_batch(clips, texts)
    finally:
        model.mesh = mesh
        del model._ctc_logprobs
    return [[(w.text, w.start, w.end) for w in r.words] for r in aligned]


def par_step_record(ft, m, names, arrays: bool) -> dict:
    """A step's loss and norm and, with ``arrays``, (gathered whole) the
    gradients of ``names``, the BatchNorm stats and, after the update,
    ``names``."""
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "lr": m["lr"]}
    if not arrays:
        return out
    with torch.no_grad():
        arrays = {f"grad/{n}": p.grad.float().cpu() for n, p in ft._named
                  if n in names and p.grad is not None}
        arrays.update({f"leaf/{n}": p.detach().float().cpu()
                       for n, p in ft._named
                       if n in names or "batch_norm" in n})
    out["arrays"] = ft._gather_shards({k: v.numpy()
                                       for k, v in arrays.items()})
    return out


def par_training(name: str, manifest: str, mesh=None, steps: int = 2,
                 fault: str = None) -> dict:
    """``steps`` ``FineTuner`` steps (bf16) of ``par_model(name,
    PAR_TRAIN_LAYERS)`` on the first batch of 16: each step's record (the
    last with its arrays), the launches and the heads a rank's K3/K5 ran
    on.  ``fault``
    "pos_bias_u from the other rank" gives each "model" rank of a rel-pos
    model the other rank's heads' ``pos_bias_u``."""
    from gigaam_tpu_torch.parallel import mesh as pmesh

    model = par_model(name, PAR_TRAIN_LAYERS)
    batch = first_batch(manifest, model.tokenizer, PAR_CLIPS)
    full = [layer["self_attn"]["pos_bias_u"].detach().clone()
            for layer in model.encoder.layers] if fault else None
    ft = FineTuner(model, TrainConfig(total_steps=10, precision="bf16"),
                   mesh=mesh)
    if fault == "pos_bias_u from the other rank":
        m = pmesh.axis_size(mesh, "model")
        h = full[0].shape[0] // m
        other = (pmesh.axis_rank(mesh, "model") + 1) % m
        with torch.no_grad():
            for layer, u in zip(model.encoder.layers, full):
                layer["self_attn"]["pos_bias_u"].copy_(
                    u[other * h:(other + 1) * h])
    elif fault is not None:
        raise ValueError(fault)
    leaves = par_leaves(model.cfg.encoder.n_layers)
    names = {n for n, _ in ft._named if re.search(leaves, n)}
    fa.reset_launch_counts()
    records, walls = [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ft.train_step(batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        records.append(par_step_record(ft, m, names, step == steps - 1))
    q = model.encoder.layers[0]["self_attn"]["linear_q"]["w"]
    out = {"steps": records, "launches": {k: n for k, n in counts().items()
                                          if n},
           "heads": q.shape[1] * model.cfg.encoder.n_heads
           // model.cfg.encoder.d_model, "step_wall_ms": walls,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del ft, model
    torch.cuda.empty_cache()
    return out


def masked_encode(model, clips) -> torch.Tensor:
    """``encode_batch``'s output with its padded frames zeroed, fp32, CPU."""
    enc, lens = model.encode_batch(clips)
    valid = torch.arange(enc.shape[1], device=enc.device)[None] < \
        lens[:, None]
    return torch.where(valid[..., None], enc.float(), 0.0).cpu()


def par_fault_encode(clips, mesh=None, fault: str = None) -> torch.Tensor:
    """The 2-layer v3_ctc's encoder output on ``clips`` (fp32, CPU): one
    process, or tensor-parallel over ``mesh`` with ``fault`` planted."""
    from gigaam_tpu_torch.ops import attention as att
    from gigaam_tpu_torch.ops import conformer_ops as co
    from gigaam_tpu_torch.parallel import collectives
    from gigaam_tpu_torch.parallel import mesh as pmesh

    model = par_model("v3_ctc", n_layers=2)
    if mesh is not None:
        pmesh.shard_model(model, mesh)
    saved = (co.reduce_from_model, att.reduce_from_model, co.row_parallel)
    if fault == "reduce dropped":
        co.reduce_from_model = att.reduce_from_model = lambda x, g: x
    elif fault == "bias added twice":
        co.row_parallel = lambda p, x, tp: collectives.reduce_from_model(
            co.linear(p, x), tp)
    try:
        return masked_encode(model, clips)
    finally:
        co.reduce_from_model, att.reduce_from_model, co.row_parallel = saved


def par_fault_step(manifest: str, mesh=None, fault: str = None) -> dict:
    """One bf16 step of the 2-layer v3_ctc on the first batch of 16 (sorted
    by duration: data rank 0 holds the shorter clips, so more padding):
    the batch moments the BatchNorm took (read back from the running stats:
    momentum 0.1 from a mean of 0 and a variance of 1) and the loss;
    ``fault`` "per-rank BN statistics" runs the BatchNorm without its data
    group."""
    from gigaam_tpu_torch.ops import conformer_ops as co

    model = par_model("v3_ctc", n_layers=2)
    batch = first_batch(manifest, model.tokenizer, PAR_CLIPS)
    ft = FineTuner(model, TrainConfig(total_steps=10, precision="bf16"),
                   mesh=mesh)
    saved = co.batch_norm_train
    if fault == "per-rank BN statistics":
        co.batch_norm_train = lambda p, x, group=None: saved(p, x)
    try:
        m = ft.train_step(batch)
    finally:
        co.batch_norm_train = saved
    stats = {k: torch.stack([layer["conv"]["batch_norm"][k].detach().cpu()
                             for layer in model.encoder.layers])
             for k in ("mean", "var")}
    return {"loss": float(m["loss"]), "bn": {
        "mean": stats["mean"] / 0.1, "var": (stats["var"] - 0.9) / 0.1}}


def par_rank(rank: int, world: int, port: int, root: str) -> None:
    """One of the 2 ranks that share the card over gloo: the DP inference
    calls, the four training layouts, the planted faults.  Writes what it
    saw to ``<root>/rank<r>.pt``."""
    from gigaam_tpu_torch.models import model as model_mod
    from gigaam_tpu_torch.parallel import distributed as pdist
    from gigaam_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.initialize("gloo", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=world, rank=rank)
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    out = {"seconds": {}}
    t0 = time.perf_counter()

    def lap(step):
        out["seconds"][step] = time.perf_counter() - t0 - sum(
            out["seconds"].values())

    dp = pmesh.make_mesh(data=2)
    model = par_model("v3_ctc")
    with torch.no_grad():
        model.head["proj"]["b"].copy_(inp["head_b"])
    model.set_mesh(dp)
    out["inference"] = par_inference(model, inp["clips"], inp["long_path"],
                                     inp["texts16"])
    lap("inference")
    # a rank's rows swapped: each rank runs the other's block
    saved = model_mod.data_rows
    model_mod.data_rows = lambda mesh, n: saved(mesh, n) if mesh is None \
        else [slice(n // 2, n), slice(0, n // 2)][pmesh.axis_rank(mesh,
                                                                  "data")]
    try:
        out["rows_swapped"] = masked_encode(model, inp["clips"][:4])
    finally:
        model_mod.data_rows = saved
    del model
    torch.cuda.empty_cache()
    lap("rows swapped")
    out["training"] = {}
    for name, d, m in PAR_CONFIGS:
        mesh = pmesh.make_mesh(data=d, model=m)
        out["training"][f"{name} data {d} x model {m}"] = par_training(
            name, inp["manifest"], mesh)
        lap(f"{name} {d}x{m}")
    tp = pmesh.make_mesh(data=1, model=2)
    # one step: the reference's second step ran on the same weights (the
    # first update's rate is 0)
    out["pos fault"] = par_training("v2_ctc", inp["manifest"], tp, steps=1,
                                    fault="pos_bias_u from the other rank")
    out["tp_encode"] = par_fault_encode(inp["clips"][:4], tp)
    for fault in ("reduce dropped", "bias added twice"):
        out[fault] = par_fault_encode(inp["clips"][:4], tp, fault)
    out["dp_step"] = par_fault_step(inp["manifest"], dp)
    out["per-rank BN statistics"] = par_fault_step(
        inp["manifest"], dp, "per-rank BN statistics")
    lap("faults")
    out["jax_loaded"] = [m_ for m_ in sys.modules if m_ == "jax"
                         or m_.startswith(("jax.", "gigaam_tpu."))]
    if rank:                 # rank 0's arrays are the ones compared
        for g in [*out["training"].values(), out["pos fault"]]:
            g["steps"][-1].pop("arrays")
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def par_nccl(port: int, root: str) -> None:
    """One rank in a one-rank ``nccl`` group: the v3_ctc train step under a
    1 x 1 mesh against the same step with no group, in this process."""
    from gigaam_tpu_torch.parallel import distributed as pdist
    from gigaam_tpu_torch.parallel import mesh as pmesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pdist.initialize("nccl", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=1, rank=0)
    manifest = torch.load(os.path.join(root, "inputs.pt"),
                          weights_only=False)["manifest"]
    got = {}
    for label, mesh in (("no group", None),
                        ("nccl 1x1", pmesh.make_mesh(1, 1, "cuda"))):
        got[label] = par_training("v3_ctc", manifest, mesh)
    a, b = got["no group"]["steps"], got["nccl 1x1"]["steps"]
    equal = all(ra["loss"] == rb["loss"] and ra["grad_norm"] == rb["grad_norm"]
                for ra, rb in zip(a, b))
    arrays_a, arrays_b = a[-1]["arrays"], b[-1]["arrays"]
    equal = equal and arrays_a.keys() == arrays_b.keys() and all(
        np.array_equal(arrays_a[k], arrays_b[k]) for k in arrays_a)
    torch.save({"bit_equal": equal, "backend": torch.distributed.get_backend(),
                "launches": got["nccl 1x1"]["launches"],
                "loss": [r["loss"] for r in b]},
               os.path.join(root, "nccl.pt"))
    torch.distributed.destroy_process_group()


def par_spawn(target, args, n: int) -> None:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args) if n > 1 else args)
             for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise AssertionError(f"phase 19: rank exit codes "
                             f"{[p.exitcode for p in procs]}")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel_err(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def par_outputs(res: dict, label: str) -> list:
    """A call's per-row outputs: texts, or the 16 alignments."""
    if label == "longform":
        return [t for t, *_ in res["longform"]]
    return res[label]


def par_compare_inference(ref: dict, got: dict, failures: list) -> dict:
    """DP results, first against their own log-probs, exactly, on every
    row: each text is the host's greedy decode of the log-probs its call
    decoded, each alignment one process's ``align_batch`` on the
    log-probs its call aligned (one process's results are held so too).
    Then against one process: ``err`` is the largest difference of the
    log-probs on valid frames; on every frame whose top-1/top-2 gap
    exceeds 2 err the greedy ids are equal; every row (segment) whose ids
    are equal on all its frames has the same text or alignment; the
    longform segment bounds are equal."""
    bad = []
    for side, res in (("one process", ref), ("DP", got)):
        for label, replayed in res["replayed"].items():
            own = par_outputs(res, label)
            if len(own) != len(replayed):
                bad.append(f"{side} {label}: {len(own)} rows, "
                           f"{len(replayed)} decoded")
            bad += [f"{side} {label}[{i}] not its log-probs' result"
                    for i, (a, b) in enumerate(zip(own, replayed)) if a != b]
    err = max(float((g[:n] - r[:n]).abs().max())
              for label in ref["lp"]
              for (r, n), (g, _) in zip(ref["lp"][label], got["lp"][label]))
    report = {"logprob_max_abs_err": err, "rows": {},
              "rows_checked_against_own_logprobs": {
                  label: len(v) for label, v in got["replayed"].items()}}
    for label, rows in ref["lp"].items():
        same_ids = []
        for i, ((r, n), (g, n_got)) in enumerate(zip(rows, got["lp"][label])):
            if n != n_got:
                bad.append(f"{label}[{i}] length")
                continue
            top = r[:n].topk(2, dim=-1).values
            clear = (top[:, 0] - top[:, 1]) > 2 * err
            ids_r, ids_g = r[:n].argmax(-1), g[:n].argmax(-1)
            if bool((ids_r != ids_g)[clear].any()):
                bad.append(f"{label}[{i}] ids past a tie")
            same_ids.append(bool((ids_r == ids_g).all()))
        mine, theirs = par_outputs(got, label), par_outputs(ref, label)
        bad += [f"{label}[{i}] differs from one process"
                for i, same in enumerate(same_ids)
                if same and mine[i] != theirs[i]]
        report["rows"][label] = f"{sum(same_ids)}/{len(same_ids)}"
    if [s[1:] for s in got["longform"]] != [s[1:] for s in ref["longform"]]:
        bad.append("longform segment bounds")
    if not err <= PAR_LOGP_ATOL:
        bad.append(f"log-probs {err}")
    failures += [f"DP inference: {b}" for b in bad]
    return report


def par_compare_training(ref: dict, got: dict, failures: list, label: str
                         ) -> dict:
    """A layout's steps against one process's: the loss within
    PAR_LOSS_RTOL; the norm, gradients and BatchNorm stats by group within
    PAR_GRAD_RTOL (the position group within PAR_POS_GRAD_RTOL); after
    the second update (the first's rate is 0) every
    compared leaf within 2 lr of one process's (an Adam step moves an
    element by at most about lr; a misplaced shard by the weights' own
    size)."""
    report = {"loss_rel": [], "grad_norm_rel": [], "grad_groups": [],
              "bn_rel": [], "leaf_max_abs": None}
    for r, g in zip(ref["steps"], got["steps"]):
        report["loss_rel"].append(abs(g["loss"] - r["loss"]) / abs(r["loss"]))
        report["grad_norm_rel"].append(
            abs(g["grad_norm"] - r["grad_norm"]) / r["grad_norm"])
        if "arrays" not in r:
            continue
        grads = {k[5:]: torch.from_numpy(v) for k, v in g["arrays"].items()
                 if k.startswith("grad/")}
        grads_ref = {k[5:]: torch.from_numpy(v)
                     for k, v in r["arrays"].items() if k.startswith("grad/")}
        if grads.keys() != grads_ref.keys():
            raise AssertionError("phase 19: gradient leaves differ")
        report["grad_groups"].append(grad_group_errors(grads, grads_ref))
        bn = [k for k in r["arrays"] if "batch_norm" in k and (
            k.endswith(".mean") or k.endswith(".var"))]
        report["bn_rel"].append(max(rel_err(
            torch.from_numpy(g["arrays"][k]), torch.from_numpy(
                r["arrays"][k])) for k in bn))
    last_r, last_g = ref["steps"][-1], got["steps"][-1]
    leaves = [k for k in last_r["arrays"] if k.startswith("leaf/")
              and "batch_norm" not in k]
    report["leaf_max_abs"] = max(float(np.abs(last_g["arrays"][k]
                                              - last_r["arrays"][k]).max())
                                 for k in leaves)
    lr = last_r["lr"]
    ok = (max(report["loss_rel"]) <= PAR_LOSS_RTOL
          and max(report["grad_norm_rel"]) <= PAR_GRAD_RTOL
          and all(v <= (PAR_POS_GRAD_RTOL if g == GRAD_GROUPS[0][0]
                        else PAR_GRAD_RTOL)
                  for gr in report["grad_groups"] for g, v in gr.items())
          and max(report["bn_rel"]) <= PAR_GRAD_RTOL
          and 0 < lr and report["leaf_max_abs"] <= 2 * lr * (1 + 1e-3))
    if not ok:
        failures.append(f"{label}: training differs")
    return report


def parallel_path(card: str) -> dict:
    """Phase 19: DP inference (v3_ctc over 2 ranks on the one card) and
    DP x TP fine-tuning (v3_ctc, v2_ctc at data 2 and at model 2) against
    one process, the planted faults, and the one-rank nccl step."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(19)
    report = {"seconds_by_step": {}, "backends": {
        "ranks": "gloo: 2 processes share the card, which NCCL refuses",
        "one-rank step": "nccl"}}

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())

    with tempfile.TemporaryDirectory() as root:
        clips = [synth_wav(float(s), rng)
                 for s in np.linspace(10.0, 20.0, PAR_CLIPS)]
        long_path = os.path.join(root, "long.wav")
        save_wav(long_path, longform_audio(PAR_LONGFORM_SECONDS, rng))
        manifest = write_train_set(root, rng, PAR_CLIPS, 10.0, 20.0)
        model = par_model("v3_ctc")
        shape_ctc_head(model, clips)
        ref = par_inference(model, clips, long_path)
        ref_rows = masked_encode(model, clips[:4])
        torch.save({"clips": clips, "long_path": long_path,
                    "manifest": manifest, "texts16": ref["decode16"],
                    "head_b": model.head["proj"]["b"].detach().cpu()},
                   os.path.join(root, "inputs.pt"))
        del model
        torch.cuda.empty_cache()
        lap("one-process inference")
        ref_train = {name: par_training(name, manifest)
                     for name in ("v3_ctc", "v2_ctc")}
        # the same one-process v2 steps again: the card's run-to-run spread
        ref_v2_again = par_training("v2_ctc", manifest)
        ref_encode = par_fault_encode(clips[:4])
        ref_step = par_fault_step(manifest)
        lap("one-process training")
        par_spawn(par_rank, (2, free_port(), root), 2)
        lap("2 gloo ranks")
        par_spawn(par_nccl, (free_port(), root), 1)
        lap("1 nccl rank")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        nccl = torch.load(os.path.join(root, "nccl.pt"), weights_only=False)
    failures = []
    if any(r["jax_loaded"] for r in ranks):
        failures.append(f"a rank imported {[r['jax_loaded'] for r in ranks]}")
    enc_cfg = make_preset("v3_ctc").encoder
    n_layers = enc_cfg.n_layers
    report["inference"] = [par_compare_inference(ref, r["inference"],
                                                 failures) for r in ranks]
    # K1 at a per-rank batch of 8 (16 rows) and 2 (3 rows padded to 4), K2
    # at one row a rank (2 rows)
    want = {"decode16": {"K1": n_layers}, "decode2": {"K2": n_layers},
            "decode3": {"K1": n_layers}, "encode16": {"K1": n_layers}}
    for r in ranks:
        got = r["inference"]["launches"]
        if {k: got[k] for k in want} != want:
            failures.append(f"DP launches {got}")
    report["inference_launches"] = [r["inference"]["launches"] for r in ranks]
    report["inference_wall_ms"] = {"one process": ref["wall_ms"], **{
        f"rank {i}": r["inference"]["wall_ms"] for i, r in enumerate(ranks)}}
    report["training"] = {}
    for label, got in ranks[0]["training"].items():
        name = label.split()[0]
        two_steps = 2 * PAR_TRAIN_LAYERS
        want = dict.fromkeys(("K3", "K4") if name == "v3_ctc"
                             else ("K5", "K6"), two_steps)
        heads = enc_cfg.n_heads // (2 if "model 2" in label else 1)
        for r in ranks:
            g = r["training"][label]
            if g["launches"] != want or g["heads"] != heads:
                failures.append(f"{label}: launches {g['launches']}, heads "
                                f"{g['heads']}")
        report["training"][label] = dict(
            par_compare_training(ref_train[name], got, failures, label),
            launches=want, heads_per_rank=heads,
            step_wall_ms=got["step_wall_ms"],
            one_process_step_wall_ms=ref_train[name]["step_wall_ms"],
            peak_gib=got["peak_gib"])

    def bn_err(got):
        return max(rel_err(got["bn"][k], ref_step["bn"][k])
                   for k in ("mean", "var"))

    tp_err = rel_err(ranks[0]["tp_encode"], ref_encode)
    dp_bn_err = bn_err(ranks[0]["dp_step"])
    faults = {
        "reduce dropped": rel_err(ranks[0]["reduce dropped"], ref_encode),
        "bias added twice": rel_err(ranks[0]["bias added twice"],
                                    ref_encode),
        "per-rank BN statistics": bn_err(ranks[0]["per-rank BN statistics"]),
        "a rank's rows swapped": rel_err(ranks[0]["rows_swapped"],
                                         ref_rows),
    }
    report["tp_encode_rel"], report["dp_bn_rel"] = tp_err, dp_bn_err
    report["faults_rel"] = faults

    def pos_group(got, ref) -> float:
        grads = [{k[5:]: torch.from_numpy(v)
                  for k, v in r["steps"][-1]["arrays"].items()
                  if k.startswith("grad/")} for r in (got, ref)]
        return grad_group_errors(*grads)[GRAD_GROUPS[0][0]]

    v2 = ref_train["v2_ctc"]
    pos = {"one-process run to run": pos_group(ref_v2_again, v2), **{
        label.split(" ", 1)[1]: g["grad_groups"][-1][GRAD_GROUPS[0][0]]
        for label, g in report["training"].items()
        if label.startswith("v2_ctc")},
        "pos_bias_u from the other rank": pos_group(ranks[0]["pos fault"],
                                                    v2),
        "limit": PAR_POS_GRAD_RTOL}
    report["pos_group_rel"] = pos
    if not pos["one-process run to run"] <= PAR_POS_GRAD_RTOL:
        failures.append(f"one-process v2 steps differ: {pos}")
    if not pos["pos_bias_u from the other rank"] > (PAR_FAULT_GAIN
                                                    * PAR_POS_GRAD_RTOL):
        failures.append(f"planted fault not caught: pos_bias_u {pos}")
    if not (tp_err <= PAR_GRAD_RTOL and dp_bn_err <= PAR_GRAD_RTOL):
        failures.append(f"2-layer TP encode {tp_err}, DP BN {dp_bn_err}")
    failures += [f"planted fault not caught: {k} {v}"
                 for k, v in faults.items()
                 if not v > PAR_FAULT_GAIN * PAR_GRAD_RTOL]
    if not nccl["bit_equal"] or nccl["backend"] != "nccl":
        failures.append(f"one-rank nccl step {nccl}")
    report["nccl_one_rank"] = nccl
    report["rank_seconds"] = ranks[0]["seconds"]
    report["seconds"] = time.perf_counter() - t0
    report["launches"] = {
        k: sum(r["inference"]["launches"][c].get(k, 0)
               for r in ranks for c in r["inference"]["launches"])
        + sum(g["launches"].get(k, 0) for r in ranks
              for g in r["training"].values())
        + nccl["launches"].get(k, 0)
        for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
    print(f"parallel phase: {report['seconds']:.1f} s; card {card}",
          flush=True)
    if failures:
        print("parallel " + json.dumps(report, default=str), flush=True)
        raise AssertionError(f"phase 19: {failures}")
    return report


# ---------------------------------------------------------------------------
# The rel-pos RNNT family, its fine-tuning, rel-pos BEST-RQ and RNNT
# longform (phases 20-23)
# ---------------------------------------------------------------------------

# The joint's blank bias (added to the drawn one) of each rel-pos RNNT
# model, and (blank bias, token bonus) of its K-4 beam with the phase's
# trigram (char for v2_rnnt, SentencePiece for v1_rnnt).  Each was read off
# a bisection on an H100 on the phase's batch of 16 clips: the first knob
# whose emission rate lay in RNNT_RATE (greedy) or BEAM_RATE (the plain and
# the fused beam).  The rate is a steep step
# in the bias (v2_rnnt greedy: +0.375 1.45 tokens a frame, +0.4141 0.55,
# +0.4531 0.12), and each model's step lies elsewhere (v3_rnnt's at 0.85,
# phase 14).  The phase asserts the rates again.
RELPOS_RNNT_SHAPE = {"v2_rnnt": (0.4140625, 0.2421875, 1.25),
                     "v1_rnnt": (0.4140625, 0.2890625, 1.34375)}
# K6 on a train step's own inputs against its plain version.  Both round
# dS to bf16 before dq = dS K (and dq_v = d_raw P), apart by the order of
# their fp32 sums, so some entries round one ulp apart.  A row of dS sums to
# zero in exact arithmetic, so what K and the table have in common (their
# mean over the keys a row reads) cancels from the true dq; the rounding
# slips do not cancel, and put an error along that mean that grows with it.
# Drawn inputs have zero-mean keys and do not show it (bwd_kernel_phase,
# KERNEL_REL x RMS); a model's keys have a mean several times their spread,
# and there the max-based reading of dq runs to several RMS.  So dq_u and
# dq_v are held with that common direction taken out of both
# (``k6_common_free``), every gradient by its relative Frobenius error
# within K6_FROB_RTOL (four bf16 steps of 2^-7) and by its least-squares
# gain over the plain one, <got, ref> / <ref, ref>, within K6_GAIN_TOL of 1:
# roundings to nearest move the gain by about their size over the root of
# the gradient's 10^5-10^7 entries, while a gradient scaled by
# K6_FAULT_SCALE moves it by 1e-2.  The max-based readings are printed.
K6_FROB_RTOL = 2.0 ** -5
K6_GAIN_TOL = 2e-3
K6_NAMES = ("dq_u", "dk", "dv", "dq_v", "dp")
K6_FAULT_SCALE = 1.01


def swap_pos_biases(model) -> None:
    """``pos_bias_u`` and ``pos_bias_v`` of every layer swapped in place
    (a planted fault; a second call undoes it)."""
    with torch.no_grad():
        for layer in model.encoder.layers:
            attn = layer["self_attn"]
            u = attn["pos_bias_u"].clone()
            attn["pos_bias_u"].copy_(attn["pos_bias_v"])
            attn["pos_bias_v"].copy_(u)


def encoder_error(model, cpu, wavs) -> tuple:
    """(lengths equal and output finite, relative Frobenius error on the
    valid frames) of the card's encoding of ``wavs`` against the CPU
    model's."""
    with torch.inference_mode():
        enc_g, len_g = model.encode_batch(wavs)
        enc_c, len_c = cpu.encode_batch(wavs)
    enc_g, len_g = enc_g.float().cpu(), len_g.cpu()
    ok = (torch.equal(len_g, len_c) and enc_g.shape == enc_c.shape
          and bool(torch.isfinite(enc_g).all()))
    if not ok:
        return False, math.inf
    rows = torch.arange(enc_c.shape[1])[None, :] < len_c[:, None]
    diff, ref = (enc_g - enc_c)[rows], enc_c[rows]
    return True, float(diff.norm() / ref.norm())


def relpos_reference(name: str, model, cpu, rng, card: str) -> dict:
    """v2's centred frames and the rel-pos encoder first: the card's
    encoded lengths equal to the port's CPU fp32 ones and its output within
    ENCODER_RTOL, on 4 s at batch 1 and 16 clips of 1-2 s.  Then each
    layer's attention module on the model's own weights, the card's (bf16,
    K5) against the CPU's fp32 composed one on the same LayerNorm'd input
    (B 4, T' 251, ragged), within KERNEL_REL x RMS (``distance``); the
    planted fault, ``pos_bias_u``/``pos_bias_v`` swapped on the card, must
    land outside it in every layer.  (The swap moves a whole encoding by
    about 1%, inside ENCODER_RTOL, and one module's output by about 8%.)"""
    cases = (("4 s, batch 1", [synth_wav(4.0, rng)]),
             ("16 x 1-2 s", [synth_wav(s, rng)
                             for s in np.linspace(1.0, 2.0, 16)]))
    rels = {}
    for label, wavs in cases:
        ok, rel = encoder_error(model, cpu, wavs)
        print(f"reference {name} {label}: lengths equal {ok}; CUDA bf16 vs "
              f"CPU fp32 encoder relative {rel:.4f} (tol {ENCODER_RTOL}); "
              f"card {card}", flush=True)
        if not (ok and rel <= ENCODER_RTOL):
            raise AssertionError(f"{name} {label}: lengths differ or the "
                                 f"encoder is off by {rel}")
        rels[label] = rel

    gen = torch.Generator().manual_seed(20)
    b, t = 4, 251
    d = model.cfg.encoder.d_model
    # a per-channel mean and a per-row scale, as ``attention_input`` draws
    x = (0.5 * torch.randn(d, generator=gen)
         + (0.5 + 1.5 * torch.rand(b, t, 1, generator=gen))
         * torch.randn(b, t, d, generator=gen))
    valid = ragged_valid(b, t, "cpu")
    n_heads = model.cfg.encoder.n_heads
    pos_g = model.pos_tables.relpos(t, model.device)
    pos_c = cpu.pos_tables.relpos(t, torch.device("cpu"))

    def module_errors():
        out = []
        for lg, lc in zip(model.encoder.layers, cpu.encoder.layers):
            with torch.inference_mode():
                y = layer_norm(lc["norm_self_att"], x)
                ref = relpos_mha(lc["self_attn"], y, pos_c, valid, n_heads)
                got = relpos_mha(lg["self_attn"],
                                 y.to(model.device, torch.bfloat16), pos_g,
                                 valid.to(model.device), n_heads,
                                 use_fused=True)
            out.append(distance(got.float().cpu(), ref, valid, 1)[1])
        return out

    errors = module_errors()
    swap_pos_biases(model)
    try:
        swapped = module_errors()
    finally:
        swap_pos_biases(model)
    print(f"  {name} attention modules, card bf16 (K5) vs CPU fp32 on the "
          f"model's weights: worst {max(errors):.4f} x RMS (limit "
          f"{KERNEL_REL}); planted fault, pos_bias_u/pos_bias_v swapped: "
          f"least {min(swapped):.4f} x RMS over the {len(swapped)} layers",
          flush=True)
    if not max(errors) <= KERNEL_REL:
        raise AssertionError(f"{name}: attention modules off by {errors}")
    if not min(swapped) > KERNEL_REL:
        raise AssertionError(f"{name}: the module check misses a u/v swap "
                             f"({swapped})")
    return {"encoder_rel": rels, "module_worst": max(errors),
            "uv_swap_least": min(swapped)}


class OffByOne:
    """A tokenizer that decodes piece i as piece i + 1 (a planted fault)."""

    def __init__(self, inner):
        self.inner = inner

    def decode(self, ids):
        return self.inner.decode([(i + 1) % len(self.inner) for i in ids])

    def __len__(self):
        return len(self.inner)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def sp_texts_agree(label: str, model, wavs, want: list) -> None:
    got = [t for t, _ in model._decode_batch(wavs, False)]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{label}: texts of rows {bad} differ from the "
                             f"CPU decode's")


def sp_text_checks(model, sp_path: str, wavs, card: str) -> dict:
    """``_decode_batch``'s texts equal the port's CPU fp32 greedy decode of
    the card's encoded batch, its ids read by a tokenizer of its own on the
    SentencePiece model; then the planted fault, each piece id read one
    off, must change a text."""
    from gigaam_tpu_torch.decode.tokenizer import Tokenizer

    enc, lens = model.encode_batch(wavs)
    ref = RNNTGreedyDecoder().decode(
        copy.deepcopy(model.head).cpu(), enc.float().cpu(), lens.cpu(),
        max_symbols=model.cfg.decoding.max_symbols_per_step)
    tok = Tokenizer([], sp_path)
    want = [tok.decode(ref[0][i, :int(ref[2][i])].tolist())
            for i in range(len(wavs))]
    sp_texts_agree("v1_rnnt", model, wavs, want)
    inner = model.tokenizer
    model.tokenizer = OffByOne(inner)
    try:
        sp_texts_agree("v1_rnnt, piece ids one off", model, wavs, want)
    except AssertionError as e:
        caught = str(e)
    else:
        raise AssertionError("v1_rnnt: the text check misses piece ids one "
                             "off")
    finally:
        model.tokenizer = inner
    chars = sum(len(t) for t in want)
    print(f"v1_rnnt texts: _decode_batch == the CPU fp32 decode read by its "
          f"own SentencePiece tokenizer on all {len(want)} rows ({chars} "
          f"chars); planted fault, piece ids one off: caught ({caught}); "
          f"card {card}", flush=True)
    return {"rows": len(want), "chars": chars, "off_by_one_caught": True}


def relpos_beam_calls(name: str, model, wav20, wavs16, lm, spec, bonus: float,
                      card: str, n_layers: int, sp: bool = False) -> tuple:
    """The K-4 beam through ``transcribe`` 20 s and ``_decode_batch`` 16,
    each without and with the LM ``lm`` (its device table ``spec``); with
    ``sp`` (a SentencePiece model) ``_decode_batch`` 16 with the LM only.
    Each call timed once from zeroed counts (``run_path``, K5 in every
    layer), unprofiled: a call runs 10^5-10^6 kernels, whose profile costs
    tens of seconds of host time; the batch's beams alone on its encoded
    output, each rate held to BEAM_RATE; the fused batch's beam profiled
    (``beam_loop_row``: device us an expansion) and, without ``sp``,
    bit-equal to the eager loop.  Returns ({label: row}, K5 launches)."""
    fused = dict(lm_weight=LM_WEIGHT, token_bonus=bonus)
    cases = [("_decode_batch 16, trigram", wavs16, lm)]
    if not sp:
        cases = [("transcribe 20 s", [wav20], None),
                 ("transcribe 20 s, trigram", [wav20], lm),
                 ("_decode_batch 16", wavs16, None)] + cases
    enc, lens = model.encode_batch(wavs16)
    rows, n_k5 = {}, 0
    for label, wavs, with_lm in cases:
        kw = {} if with_lm is None else dict(lm=with_lm, **fused)
        loop_kw = {} if with_lm is None else dict(lm=spec, **fused)
        if len(wavs) == 1:
            call = (lambda kw=kw: model.transcribe(
                wav20, word_timestamps=True, beam_size=BEAM, **kw))
        else:
            call = (lambda kw=kw: model._decode_batch(
                wavs16, True, beam_size=BEAM, **kw))
        _, n, prof = run_path(f"{name} {label}, beam {BEAM} (K5)", call,
                              "K5", n_layers, calls=1, profiled=False)
        n_k5 += n
        row = {"call": label, "call_wall_ms": prof["wall_ms"],
               "expansions": model.rnnt_beam.last_expansions()}
        if len(wavs) > 1:
            out, reads, replays, steps, loop_wall = beam_call(
                model, enc, lens, beam_size=BEAM, **loop_kw)
            rate = float(out[2].sum()) / float(lens.sum())
            row.update(tokens=int(out[2].sum()), tokens_per_frame=rate,
                       loop_wall_ms=loop_wall, host_reads=reads,
                       graph_replays=replays)
            print(f"  {name} {label}: {rate:.3f} tokens a frame (band "
                  f"{BEAM_RATE}), {steps} expansions, loop {loop_wall:.1f} "
                  f"ms wall", flush=True)
            if not BEAM_RATE[0] <= rate <= BEAM_RATE[1]:
                raise AssertionError(f"{name} {label}: {rate} tokens a "
                                     f"frame, outside {BEAM_RATE}")
            if with_lm is not None:
                row["loop"] = beam_loop_row(f"{name} {label}", model, wavs,
                                            card, eager=not sp,
                                            **loop_kw)[0]
        rows[label] = row
    return rows, n_k5


def relpos_rnnt_path(card: str) -> dict:
    """Phase 20: full-width v2_rnnt (random weights from seed 0, its pos
    biases drawn apart, bf16 encoder, fp32 head, TF32 off): the encoder
    against the CPU fp32 model (lengths, output, each attention module, the
    planted u/v swap); at RELPOS_RNNT_SHAPE's greedy blank bias
    ``transcribe`` 20 s and ``_decode_batch`` 16 x 10-20 s (K5 in every
    layer), each profiled once with its loop alone; the decode checks
    (graph == eager bit for bit, == the CPU fp32 decode of the same encoded
    tensor); the K-4 beam at its bias (and with a char trigram at its token
    bonus) through both calls without and with the trigram
    (``relpos_beam_calls``).  Then full-width v1_rnnt through ``load_model``
    with a synthetic 512-piece SentencePiece model in its
    ``download_root``: the same greedy calls and checks,
    ``_decode_batch``'s texts against the CPU decode's (and the planted
    piece-id slip), and ``_decode_batch`` 16 at beam 4 with a SentencePiece
    trigram (sparse table)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    texts = lm_texts(rng)
    report = {"seconds_by_step": {}}
    launches = {"K5": 0}

    def lap(step: str) -> None:
        report["seconds_by_step"][step] = time.perf_counter() - t0 - sum(
            report["seconds_by_step"].values())
        print(f"  [{step}: {report['seconds_by_step'][step]:.1f} s]",
              flush=True)

    wav20 = synth_wav(20.0, rng)
    wavs16 = [synth_wav(sec, rng) for sec in np.linspace(10.0, 20.0, 16)]

    def shaped(name: str, model) -> tuple:
        bias, beam_bias, bonus = RELPOS_RNNT_SHAPE[name]
        base = float(model.head["joint"]["out"]["b"][model.blank_id])
        set_blank_bias(model, base, bias)
        print(f"{name}: greedy blank bias +{bias}, beam {BEAM} blank bias "
              f"+{beam_bias} and token bonus {bonus} (RELPOS_RNNT_SHAPE)",
              flush=True)
        return base, bias, beam_bias, bonus

    def greedy_calls(name: str, model, profile_transcribe: bool) -> None:
        res, n, prof = run_path(
            f"{name} transcribe 20 s, batch 1 (K5)",
            lambda: model.transcribe(wav20, word_timestamps=True), "K5",
            n_layers, calls=1)
        if not (isinstance(res.text, str) and isinstance(res.words, list)):
            raise AssertionError(f"transcribe returned {res!r}")
        launches["K5"] += n
        if profile_transcribe:
            report[f"{name} transcribe"] = loop_share(
                f"{name} transcribe 20 s", model, [wav20], prof, card)
        outs, n, prof = run_path(
            f"{name} _decode_batch 16 x 10-20 s (K5)",
            lambda: model._decode_batch(wavs16, word_timestamps=True), "K5",
            n_layers, calls=1)
        if len(outs) != 16 or not all(isinstance(t, str) for t, _ in outs):
            raise AssertionError(f"{name}: _decode_batch returned a "
                                 f"malformed batch")
        launches["K5"] += n
        print(f"  {name}: transcribe {len(res.text)} chars; _decode_batch "
              f"text lengths {[len(t) for t, _ in outs]}; card {card}",
              flush=True)
        report[f"{name} decode_batch"] = loop_share(
            f"{name} _decode_batch 16", model, wavs16, prof, card,
            eager=profile_transcribe)

    model = gt.load_model("v2_rnnt", init="random", seed=0)
    nonzero_pos_biases(model, seed=3)
    cpu = gt.load_model("v2_rnnt", init="random", seed=0, device="cpu")
    nonzero_pos_biases(cpu, seed=3)
    n_layers = model.cfg.encoder.n_layers
    report["reference"] = relpos_reference("v2_rnnt", model, cpu, rng, card)
    del cpu
    lap("v2_rnnt load, encoder reference")
    base, bias, beam_bias, bonus = shaped("v2_rnnt", model)
    greedy_calls("v2_rnnt", model, True)
    report["v2_rnnt checks"] = decode_checks(model, base, wavs16, card,
                                             bias_moderate=bias, chunks=())
    lap("v2_rnnt greedy")
    set_blank_bias(model, base, beam_bias)
    char_lm = gt.train_lm_from_texts(texts, model.tokenizer, order=3)
    spec = model._resolve_lm(char_lm)[1]
    report["v2_rnnt beam"], n = relpos_beam_calls(
        "v2_rnnt", model, wav20, wavs16, char_lm, spec, bonus, card,
        n_layers)
    launches["K5"] += n
    report["captures"] = {"greedy": model.rnnt.captures,
                          "beam": model.rnnt_beam.captures}
    del model
    torch.cuda.empty_cache()
    lap("v2_rnnt beam")

    with tempfile.TemporaryDirectory() as root:
        sp = os.path.join(root, "v1_rnnt_tokenizer.model")
        write_sp_model(sp, sp_model_pieces(SP_PIECES))
        model = gt.load_model("v1_rnnt", init="random", seed=0,
                              download_root=root)
        joint = model.head["joint"]["out"]["b"].shape[0]
        if (len(model.tokenizer) != SP_PIECES or model.blank_id != SP_PIECES
                or joint != SP_PIECES + 1
                or model.cfg.encoder.self_attention_model != "rel_pos"):
            raise AssertionError(f"v1_rnnt: {len(model.tokenizer)} pieces, "
                                 f"blank {model.blank_id}, joint {joint}")
        nonzero_pos_biases(model, seed=4)
        base, bias, beam_bias, bonus = shaped("v1_rnnt", model)
        greedy_calls("v1_rnnt", model, False)
        report["v1_rnnt checks"] = decode_checks(
            model, base, wavs16, card, bias_moderate=bias, chunks=())
        report["v1_rnnt texts"] = sp_text_checks(model, sp, wavs16, card)
        lap("v1_rnnt greedy")
        set_blank_bias(model, base, beam_bias)
        sp_lm = gt.train_lm_from_texts(texts, model.tokenizer, order=3)
        spec = model._resolve_lm(sp_lm)[1]
        if not isinstance(spec[0], dict):
            raise AssertionError("the SP trigram did not get a sparse table")
        report["v1_rnnt beam"], n = relpos_beam_calls(
            "v1_rnnt", model, wav20, wavs16, sp_lm, spec, bonus, card,
            n_layers, sp=True)
        launches["K5"] += n
        report["v1_rnnt trigram_sparse_levels"] = [
            int(ids.shape[0]) for ids, _ in spec[0]["levels"]]
        del model
        torch.cuda.empty_cache()
        lap("v1_rnnt beam")
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    print(f"relpos_rnnt phase: {report['seconds']:.1f} s", flush=True)
    return report


class K6Recorder:
    """While active, each K6 launch's inputs and outputs are kept in
    ``calls``: the wrapper is swapped in ``fa``'s namespace, where the
    rel-pos autograd Function looks it up, and its launch count carries
    over."""

    def __enter__(self):
        self.calls = []
        inner = self.inner = fa.relpos_mha_bwd

        def recording(*args):
            out = inner(*args)
            self.calls.append((args, out))
            return out

        recording.launches = inner.launches
        fa.relpos_mha_bwd = recording
        return self

    def __exit__(self, *exc) -> bool:
        self.inner.launches = fa.relpos_mha_bwd.launches
        fa.relpos_mha_bwd = self.inner
        return False


def k6_common_free(grads, k, p_heads, valid) -> list:
    """K6's five gradients with dq_u's component along the mean of K over
    the valid keys (per row and head) and dq_v's along the mean of the
    table rows its valid keys read (per query row) taken out; dk, dv and dp
    as they are.  ``valid`` is a prefix mask, as the model's lengths make
    it."""
    def unit(x):
        return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-30)

    def project(g, u):
        g = g.float()
        return g - (g * u).sum(-1, keepdim=True) * u

    b, h, t, _ = k.shape
    lens = valid.sum(1).clamp(min=1)                               # [B]
    mask = valid[:, None, :, None].float()
    k_mean = (k.float() * mask).sum(2, keepdim=True) / lens[:, None, None,
                                                            None]
    # row i's valid key j reads table row T-1-i+j: a window of lens[b] rows
    csum = F.pad(p_heads.float().cumsum(1), (0, 0, 1, 0))     # [H, P+1, d]
    start = (t - 1) - torch.arange(t, device=k.device)              # [T]
    end = start[None, :] + lens[:, None]                            # [B, T]
    p_mean = ((csum[:, end] - csum[:, start][:, None])
              / lens[None, :, None, None]).permute(1, 0, 2, 3)  # [B, H, T, d]
    dq_u, dk, dv, dq_v, dp = grads
    return [project(dq_u, unit(k_mean)), dk, dv,
            project(dq_v, unit(p_mean)), dp]


def k6_rows(name: str, g, valid):
    """The entries ``grad_distances`` compares, flat, in float64: query
    rows of dq_u and dq_v, key rows of dk and dv, all of dp."""
    if name == "dp":
        return g.double().flatten()
    return g.double()[valid[:, None, :, None].expand_as(g)]


def k6_readings(got, ref, valid) -> dict:
    """Per gradient (relative Frobenius error, least-squares gain
    <got, ref> / <ref, ref>) over ``k6_rows``."""
    out = {}
    for name, g, r in zip(K6_NAMES, got, ref):
        g, r = k6_rows(name, g, valid), k6_rows(name, r, valid)
        out[name] = (float((g - r).norm() / r.norm()),
                     float((g * r).sum() / (r * r).sum()))
    return out


def k6_step_check(label: str, calls: list) -> dict:
    """Each K6 launch of a train step (``K6Recorder``) against the plain
    backward on the same bf16 inputs, from the plain forward's own (out,
    lse) as ``bwd_kernel_phase`` holds it, dq_u and dq_v without their
    common direction (``k6_common_free``): every gradient within
    K6_FROB_RTOL (relative Frobenius) and its gain within K6_GAIN_TOL of 1;
    the planted fault, dq_u and dq_v scaled by K6_FAULT_SCALE, must fall
    outside.  The max-based readings (``grad_distances``, raw and without
    the common direction) are printed and returned beside the worst of
    each."""
    if not calls:
        raise AssertionError(f"{label}: no K6 launch was recorded")
    # per gradient: [relative Frobenius, |gain - 1|, x RMS, x RMS raw]
    worst = {n: [0.0, 0.0, 0.0, 0.0] for n in K6_NAMES}
    max_abs, fault_off = 0.0, math.inf
    for args, got in calls:
        q_u, k, v, q_v, p_heads, do, valid = (a.detach() for a in args[:7])
        got = [g.detach() for g in got]
        with torch.no_grad():
            plain_pair = fa.relpos_mha_plain(q_u, k, v, q_v, p_heads, valid,
                                             return_lse=True)
            ref = fa.relpos_mha_bwd_plain(q_u, k, v, q_v, p_heads, do,
                                          valid, *plain_pair)
            raw = grad_distances(K6_NAMES, got, ref, valid)
            got_c, ref_c = (k6_common_free(x, k, p_heads, valid)
                            for x in (got, ref))
            dist = grad_distances(K6_NAMES, got_c, ref_c, valid)
            read = k6_readings(got_c, ref_c, valid)
            faulty = [x * K6_FAULT_SCALE if n in ("dq_u", "dq_v") else x
                      for n, x in zip(K6_NAMES, got_c)]
            fault = k6_readings(faulty, ref_c, valid)
        off = max(max(f - K6_FROB_RTOL, abs(g - 1.0) - K6_GAIN_TOL)
                  for n, (f, g) in fault.items() if n in ("dq_u", "dq_v"))
        if not off > 0:
            raise AssertionError(f"{label}: the K6 check misses dq scaled by "
                                 f"{K6_FAULT_SCALE} ({fault})")
        fault_off = min(fault_off, min(abs(fault[n][1] - 1.0)
                                       for n in ("dq_u", "dq_v")))
        for n in K6_NAMES:
            w = worst[n]
            w[0] = max(w[0], read[n][0])
            w[1] = max(w[1], abs(read[n][1] - 1.0))
            w[2] = max(w[2], dist[n][1])
            w[3] = max(w[3], raw[n][1])
        max_abs = max(max_abs, max(e for e, _ in raw.values()))
        del plain_pair, ref, got_c, ref_c, faulty
    b, h, t, _ = calls[0][0][0].shape
    frob = max(w[0] for w in worst.values())
    gain_off = max(w[1] for w in worst.values())
    print(f"K6 on the train step's own inputs, {label} ({len(calls)} "
          f"launches, B {b}, T' {t}; dq_u and dq_v without their common "
          f"direction): worst relative Frobenius {frob:.2e} (limit "
          f"{K6_FROB_RTOL}), worst |gain - 1| {gain_off:.2e} (limit "
          f"{K6_GAIN_TOL}), max_abs_err {max_abs:.3e}; by gradient "
          f"[Frobenius, |gain - 1|, x RMS, x RMS raw] " + json.dumps(
              {n: [float(f"{x:.3g}") for x in w] for n, w in worst.items()})
          + f"; planted fault, dq_u and dq_v x {K6_FAULT_SCALE}: |gain - 1| "
          f"{fault_off:.2e}, caught", flush=True)
    if not (frob <= K6_FROB_RTOL and gain_off <= K6_GAIN_TOL):
        raise AssertionError(f"{label}: K6 against its plain version "
                             f"{worst}")
    torch.cuda.empty_cache()
    return {"launches": len(calls), "shape": f"B {b}, T' {t}",
            "frobenius": frob, "gain_off": gain_off, "max_abs_err": max_abs,
            "fault_gain_off": fault_off,
            "by_gradient_frobenius_gain_rms_rawrms": worst}


def fenced_step(label: str, ft, batch, card: str) -> dict:
    """Device time of ``ft.train_step`` (whose work runs on the current
    stream), fenced (``device_ms``, 2 calls after one unfenced), by group,
    beside the wall of 2 more steps: busy ms, idle share, launches."""
    split = device_ms(lambda: ft.train_step(batch), calls=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        ft.train_step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / 2
    busy = sum(split.values())
    rec = {"call": label, "reading": "device_ms (fenced)", "wall_ms": wall,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
           "groups_ms": by_group(split),
           "top_kernels": [[k[:90], ms] for k, ms in sorted(
               split.items(), key=lambda kv: -kv[1])[:8]]}
    print("  fenced " + json.dumps(rec) + f"; card {card}", flush=True)
    return rec


def relpos_rnnt_train_path(manifest: str, small_manifest: str,
                           card: str) -> dict:
    """Phase 21: v2_rnnt fine-tuning at batch 16 of 10-20 s
    (``rnnt_training_phase``: the CLI for 3 steps, ``FineTuner`` x 3 with no
    remat and under "full" and "dots", launch counts asserted, "dots"
    against "full", the RNNT loss alone, a fenced step, K6 on one step's
    inputs), then one step at 2 layers, batch 4, against the CPU's fp32
    (K6 on that step's inputs, with the planted dq slip)."""
    t0 = time.perf_counter()
    report = rnnt_training_phase(manifest, card, name="v2_rnnt")
    report["reference"] = training_reference_phase("v2_rnnt", small_manifest)
    report["seconds"] = time.perf_counter() - t0
    return report


def chunk_texts_agree(label: str, res, serial) -> None:
    got, want = texts_of(res), texts_of(serial)
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{label}: chunks {bad} of {len(want)} differ "
                             f"from _decode_batch of the same chunks")


def shortened_row(model, fn):
    """``fn()`` with row 0 of every chunk batch given half its encoded
    length (a planted fault)."""
    inner = model._encode

    def encode(*args, **kw):
        enc, lens = inner(*args, **kw)
        lens = lens.clone()
        lens[0] = lens[0] // 2
        return enc, lens

    model._encode = encode
    try:
        return fn()
    finally:
        del model._encode


def rnnt_longform_path(card: str) -> dict:
    """Phase 23: full-width v3_rnnt (random weights from seed 0, bf16
    encoder, fp32 head) through ``transcribe_longform`` on phase 15's
    6-minute WAV with the energy VAD, in batches of 16: greedy at
    RNNT_BLANK_BIAS and at beam 4 at BEAM_SHAPE's bias; launch counts (K1
    in all 16 layers of every chunk batch), segments checked, each chunk's
    text equal to ``_decode_batch`` of the same chunks with one batch in
    flight, walls of two batches in flight against one in turns (greedy's
    two in flight profiled); the planted fault, row 0's encoded length
    halved in every batch, must change a chunk's text."""
    t0 = time.perf_counter()
    os.environ["GIGAAM_VAD_ARTIFACT"] = "energy"
    rng = np.random.default_rng(15)
    audio = longform_audio(LONGFORM_SECONDS, rng)
    report = {}
    launches = {"K1": 0}
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "longform.wav")
        save_wav(path, audio)
        duration = len(gt.load_audio(path)) / SAMPLE_RATE
        model = gt.load_model("rnnt", init="random", seed=0)
        n_layers = model.cfg.encoder.n_layers
        base = float(model.head["joint"]["out"]["b"][model.blank_id])
        for mode, bias, kw in (
                ("greedy", RNNT_BLANK_BIAS, {}),
                (f"beam {BEAM}", BEAM_SHAPE["v3_rnnt"][0],
                 {"beam_size": BEAM})):
            set_blank_bias(model, base, bias)
            label = f"v3_rnnt longform {mode}"

            def longform(kw=kw):
                return model.transcribe_longform(
                    path, fr_batch_size=LONGFORM_BATCH,
                    word_timestamps=True, **kw)

            def serial(kw=kw):
                return longform_serial(model, path, LONGFORM_BATCH, **kw)

            fa.reset_launch_counts()
            res = longform()                 # the loops' graphs captured
            torch.cuda.synchronize()
            n_seg = len(res.segments)
            n_batches = -(-n_seg // LONGFORM_BATCH)
            if n_batches < 2:
                raise AssertionError(f"{n_seg} segments: fewer than 2 "
                                     f"batches")
            launches["K1"] += assert_launches(
                label, {"K1": n_layers * n_batches})["K1"]
            check_longform(label, res, duration)
            ref, batch_walls = serial()
            chunk_texts_agree(label, res, ref)
            chars = sum(len(t) for t in texts_of(res))
            if not chars:
                raise AssertionError(f"{label}: every chunk's text is empty")
            if mode == "greedy":
                try:
                    chunk_texts_agree(f"{label}, row 0 shortened",
                                      shortened_row(model, longform), ref)
                except AssertionError as e:
                    print(f"  {label} planted fault, row 0's encoded length "
                          f"halved in every batch: caught ({e})", flush=True)
                else:
                    raise AssertionError(f"{label}: the chunk check misses a "
                                         f"shortened row")
            walls = alternating_walls({"one_in_flight": serial,
                                       "two_in_flight": longform}, rounds=1)
            med = {k: float(np.median(v)) for k, v in walls.items()}
            report[mode] = {
                "blank_bias": bias, "audio_s": duration, "segments": n_seg,
                "batches": n_batches, "chars": chars, "walls_ms": walls,
                "median_ms": med,
                "two_over_one": med["two_in_flight"] / med["one_in_flight"],
                "batch_call_walls_ms": batch_walls,
                "audio_s_per_s_two": duration / (med["two_in_flight"] / 1e3)}
            if mode == "greedy":
                # the beam's calls run ~10^6 kernels: their profile would
                # cost tens of seconds of host time
                prof = profile_calls(f"{label}, two batches in flight (K1)",
                                     longform, 1, med["two_in_flight"])
                report[mode].update(
                    idle_share_two=prof["idle_share"],
                    device_busy_ms_two=prof["device_busy_ms"],
                    launches_two=prof["launches"],
                    groups_ms_two=prof["groups_ms"])
            print(f"{label} {duration:.0f} s, {n_seg} segments in {n_batches}"
                  f" batches of {LONGFORM_BATCH} ({chars} chars): each chunk "
                  f"== _decode_batch of its batch; two in flight "
                  f"{med['two_in_flight']:.1f} ms, one "
                  f"{med['one_in_flight']:.1f} ms (in turns); card {card}",
                  flush=True)
        del model
        torch.cuda.empty_cache()
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    return report


def batch1_wall(rounds: int = 7, calls: int = 20) -> None:
    """``python3 chip_smoke.py --batch1-wall``: the wall of v3_ctc
    ``transcribe`` on 20 s (batch 1, K2) of whichever ``gigaam_tpu_torch``
    is first on the path, the median over ``rounds`` rounds of ``calls``
    calls after a warm-up.  Where the tree has them, in turns with the
    same calls without the device lock (a no-op in its place) and without
    the op dispatch (the encoder calling K2's body directly, the parent's
    route), each round in another order.  Prints one ``batch1 {...}``
    line."""
    import contextlib
    import statistics

    from gigaam_tpu_torch.models import encoder as gt_encoder

    cuda_lib.build(names=("attention", "projection"))
    model = gt.load_model("v3_ctc", init="random", seed=0)
    wav = synth_wav(20.0, np.random.default_rng(0))
    lock = getattr(model, "_device_lock", None)
    routed = gt_encoder.folded_rotary_attention

    def direct(w, x, cos, sin, valid, n_heads):
        return fa._folded_forward(w, x, cos, sin, valid, n_heads, False)

    variants = {"as_shipped": (lock, routed)}
    if lock is not None:
        variants["no_lock"] = (contextlib.nullcontext(), routed)
        variants["no_op_dispatch"] = (lock, direct)
    for _ in range(3):
        model.transcribe(wav)
    walls = {k: [] for k in variants}
    names = list(variants)
    for r in range(rounds):
        # each variant first, then last, in turn: no position favours one
        turn = names[r % len(names):] + names[:r % len(names)]
        for name in turn + turn[::-1]:
            if lock is not None:
                model._device_lock, gt_encoder.folded_rotary_attention = (
                    variants[name])
            walls[name].append(wall_ms(lambda: [model.transcribe(wav)
                                                for _ in range(calls)])
                               / calls)
    if lock is not None:
        model._device_lock, gt_encoder.folded_rotary_attention = lock, routed
    print("batch1 " + json.dumps({
        "package": os.path.dirname(gt.__file__), "card": card_line(),
        "median_ms": {k: statistics.median(v) for k, v in walls.items()},
        "walls_ms": walls}), flush=True)


def build_kernels() -> dict:
    """Builds every kernel from csrc/ (all sources at once, always anew),
    prints each kernel's registers, spills and shared memory, fails if a
    `wgmma` kernel spills or a kept kernel's registers moved, and prints
    the dynamic shared memory and blocks per SM of the kernels that size
    it at launch.  Returns the resources by kernel."""
    logs = []
    build_s = cuda_lib.build(verbose=True, logs=logs, force=True)
    print(f"kernel build: {build_s:.1f} s", flush=True)
    resources = cuda_lib.kernel_resources("\n".join(logs))
    print("kernel resources " + json.dumps(resources), flush=True)
    # the SDPA ablation's kernels: every variant head-major, the full
    # variant in the other three layouts
    ablation_kernels = tuple(
        f"sdpa_ablation_kernel<{variant}, {layout}>"
        for variant, layout in [(v, 0) for v in range(7)]
        + [(0, layout) for layout in (1, 2, 3)])
    wgmma_kernels = ("sdpa_kernel", "sdpa_bwd_dq_kernel", "sdpa_bwd_dkv_kernel",
                     "relpos_sdpa_kernel", "relpos_bwd_dq_kernel",
                     "relpos_bwd_dkv_kernel", "qkv_kernel<2, 128>",
                     "qkv_kernel<1, 128>", "out_proj_kernel<2, 128, 1>",
                     "out_proj_kernel<2, 128, 0>",
                     "out_proj_kernel<1, 64, 1>",
                     "out_proj_kernel<1, 64, 0>", "ffn_fold_kernel",
                     "glu_fold_kernel", "dw_proj_kernel", "taps_kernel",
                     "probe_gemm_kernel", "ws_conv_kernel<256, 2, true>",
                     "ws_conv_kernel<256, 1, true>",
                     "ws_conv_kernel<128, 1, true>",
                     "ws_conv_kernel<128, 1, false>",
                     "sdpa_groups_ws_kernel", "ffn_ws_kernel<1>",
                     "ffn_ws_kernel<2>") + ablation_kernels
    # the attention-fold probes' GEMMs; the instances that K1/K2's library
    # also compiles carry the probe library's name (kernel_resources)
    wgmma_kernels += (
        "qkv_kernel<1, 128> (attn_fold_probe)",
        "qkv_kernel<2, 128> (attn_fold_probe)", "qkv_kernel<4, 128>",
        "qkv_head_kernel", "out_proj_kernel<1, 128, 0>",
        "out_proj_kernel<2, 128, 0> (attn_fold_probe)",
        "out_proj_kernel<4, 128, 0>", "out_proj_kernel<1, 128, 2>",
        "out_proj_kernel<2, 128, 2>", "out_proj_kernel<4, 128, 2>")
    # P6/P7's redesign: its products and the walk's packed instance; P8's
    # output products; P5's redesign's products
    wgmma_kernels += (cuda_lib.ATTN_FOLD_WS_KERNELS
                      + cuda_lib.ATTN_LNRES_WS_KERNELS
                      + cuda_lib.CONV_FOLD_WS_KERNELS[:2]
                      + cuda_lib.HEADS_WS_KERNELS
                      + (cuda_lib.PACKED_HEADS_WS_KERNEL,))
    if not set(wgmma_kernels) | {"ln_rope_kernel<true>",
                                 "ln_rope_kernel<false>",
                                 "conv_dw_kernel", "smem_bulk_kernel",
                                 "smem_probe_kernel"} <= set(resources):
        raise AssertionError(f"the build reported {sorted(resources)}")
    spilled = [k for k in wgmma_kernels if resources[k]["spill_bytes"]]
    if spilled:
        raise AssertionError(f"register spills in {spilled}")
    # the per-head walk and its packed instance keep their products in
    # flight (ptxas C7513: a product's register input redefined in flight,
    # the products serialised)
    serialised = [line for line in "\n".join(logs).splitlines()
                  if "C7513" in line and "heads_ws" in line]
    if serialised:
        raise AssertionError(f"ptxas serialised the per-head walk: "
                             f"{serialised}")
    moved = {k: resources[k]["registers"] for k in KEPT_REGISTERS
             if resources[k]["registers"] != KEPT_REGISTERS[k]}
    if moved:
        raise AssertionError(f"registers moved: {moved}, were "
                             f"{KEPT_REGISTERS}")
    # the rel-pos kernels size their shared memory at launch
    print("kernel dynamic resources "
          + json.dumps(cuda_lib.dynamic_resources()), flush=True)
    return resources


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--batch1-wall"]:
        batch1_wall()
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch.cuda.get_device_name(0): {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # the wall seconds of each phase, printed before the card's line
    walls, last = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        walls[name] = round(now - last[0], 1)
        last[0] = now

    build_kernels()
    lap("kernel build")

    rows = kernel_phase(dev)
    gen = torch.Generator().manual_seed(1)
    rows["K4"] = bwd_kernel_phase(gen, dev, relpos=False)
    rows["K6"] = bwd_kernel_phase(gen, dev, relpos=True)
    lap("kernels K1-K6")
    ablation_rows, ablation_launches = ablation_phase(gen, dev)
    lap("ablation P9-P12")
    fold_rows, fold_launches = fold_probe_phase(dev)
    torch.cuda.empty_cache()
    lap("fold probes P4/P5")
    sub_rows, sub_launches = subsampling_probe_phase(dev)
    torch.cuda.empty_cache()
    lap("subsampling probes P1-P3")
    attn_fold_rows, attn_fold_launches = attn_fold_probe_phase(dev)
    torch.cuda.empty_cache()
    lap("attention-fold probes P6-P8")
    rng = np.random.default_rng(0)
    model = gt.load_model("v3_ctc", init="random", seed=0)
    launches = main_path(model, rng, card)
    reference_phase(model, gt.load_model("v3_ctc", init="random", seed=0,
                                         device="cpu"), rng, ("K2", "K1", "K3"),
                    long_s=K3_SECONDS)
    asr = v2_ctc()
    emo = gt.load_model("emo", init="random", seed=0)
    nonzero_pos_biases(emo, seed=2)
    launches["K5"] = relpos_main_path(asr, emo, rng, card)
    del emo
    reference_phase(asr, v2_ctc(device="cpu"), rng, ("K5",) * 3)
    torch.cuda.empty_cache()
    lap("inference paths")

    with tempfile.TemporaryDirectory() as root:
        manifest = write_train_set(root, rng, 32, 10.0, 20.0)
        train_launches = training_path(model, asr, manifest, card)
        del model, asr
        torch.cuda.empty_cache()
        small = os.path.join(root, "small")
        os.makedirs(small)
        manifest = write_train_set(small, rng, 4, 2.0, 4.0)
        for name in ("v3_ctc", "v2_ctc"):
            training_reference_phase(name, manifest)
    launches["K4"], launches["K6"] = train_launches["K4"], train_launches["K6"]
    lap("training")
    rnnt = rnnt_path(card)
    lap("rnnt")
    for key in ("K1", "K2"):
        launches[key] += rnnt["launches"][key]
    longform = longform_path(card)
    lap("longform")
    for key in ("K1", "K2", "K5"):
        launches[key] += longform["launches"][key]
    beam = beam_path(card)
    lap("beam")
    for key in ("K1", "K2"):
        launches[key] += beam["launches"][key]
    ingest_train = ingest_train_path(card)
    lap("ingest and train")
    for key, n in ingest_train["launches"].items():
        launches[key] += n
    export_serve = export_serve_path(card)
    lap("export and serve")
    for key, n in export_serve["launches"].items():
        launches[key] += n
    parallel = parallel_path(card)
    lap("parallel")
    for key, n in parallel["launches"].items():
        launches[key] += n
    relpos_rnnt = relpos_rnnt_path(card)
    lap("relpos_rnnt")
    with tempfile.TemporaryDirectory() as root:
        rng = np.random.default_rng(21)
        manifest = write_train_set(root, rng, 32, 10.0, 20.0)
        small = os.path.join(root, "small")
        os.makedirs(small)
        small_manifest = write_train_set(small, rng, 4, 2.0, 4.0)
        relpos_train = relpos_rnnt_train_path(manifest, small_manifest, card)
        lap("relpos_rnnt_train")
        relpos_ssl = ssl_phase(manifest, small_manifest, card, name="v2_ssl")
        lap("relpos_ssl")
    rnnt_longform = rnnt_longform_path(card)
    lap("rnnt_longform")
    for part in (relpos_rnnt, relpos_train, relpos_ssl, rnnt_longform):
        for key, n in part["launches"].items():
            launches[key] += n

    replaces = {
        "K3": ("fused_mha", "gigaam_tpu_torch/csrc/attention.cu",
               "gigaam_tpu/ops/pallas_attention.py:1108"),
        "K2": ("folded_rotary_attention", "gigaam_tpu_torch/csrc/projection.cu",
               "gigaam_tpu/ops/pallas_attention.py:297"),
        "K1": ("folded_rotary_attention_lnres",
               "gigaam_tpu_torch/csrc/projection.cu",
               "gigaam_tpu/ops/pallas_attention.py:414"),
        "K5": ("fused_relpos_mha", "gigaam_tpu_torch/csrc/relpos_attention.cu",
               "gigaam_tpu/ops/pallas_attention.py:977"),
        "K4": ("mha_bwd", "gigaam_tpu_torch/csrc/attention_bwd.cu",
               "gigaam_tpu/ops/pallas_attention.py:573"),
        "K6": ("relpos_mha_bwd",
               "gigaam_tpu_torch/csrc/relpos_attention_bwd.cu",
               "gigaam_tpu/ops/pallas_attention.py:731"),
    }
    kernels = []
    for key in ("K3", "K2", "K1", "K5", "K4", "K6"):
        name, source, repl = replaces[key]
        r = rows[key]
        kernels.append({
            "name": f"{key} {name}", "route": "cuda", "source": source,
            "replaces": repl, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "also": r.get("also", [])})
    kernels += ablation_kernel_rows(ablation_rows, ablation_launches)
    kernels += fold_probe_kernel_rows(fold_rows, fold_launches)
    kernels += subsampling_kernel_rows(sub_rows, sub_launches)
    kernels += attn_fold_probe_kernel_rows(attn_fold_rows, attn_fold_launches)
    print("rnnt " + json.dumps(rnnt))
    print("longform " + json.dumps(longform))
    print("rnnt_beam " + json.dumps(beam))
    print("ingest_train " + json.dumps(ingest_train))
    print("export " + json.dumps(export_serve["export"]))
    print("serve " + json.dumps(dict(export_serve["serve"], seconds_by_step=
                                     export_serve["seconds_by_step"],
                                     seconds=export_serve["seconds"])))
    print("parallel " + json.dumps(parallel))
    print("relpos_rnnt " + json.dumps(relpos_rnnt))
    print("relpos_rnnt_train " + json.dumps(relpos_train))
    print("relpos_ssl " + json.dumps(relpos_ssl))
    print("rnnt_longform " + json.dumps(rnnt_longform))
    print("phase walls " + json.dumps(walls), flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

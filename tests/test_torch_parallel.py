"""The port's parallel layer (``gigaam_tpu_torch/parallel``) on the CPU.

* the partition specs against the JAX package's, leaf by leaf, and
  ``shard_params`` then ``unshard_params`` bit-equal;
* ``process_shard``/``process_shard_indices`` against the JAX functions
  (their process count and index patched), ``initialize``'s refusal;
* two spawned ranks over ``gloo`` (``tests/torch_parallel_worker.py``,
  which imports torch and the port only): ``GigaAM.set_mesh`` with data 2,
  CTC and RNNT ``_decode_batch`` on batches of 2 and 3,
  ``transcribe_longform``, ``align_batch`` and ``encode_batch``, each
  rank's results against the one-process port's (texts equal, fp32 numbers
  within ATOL), and the K1/K2 choice made on the per-rank batch;
* four spawned ranks, data 2 x model 2 (the JAX tests' layout): three
  steps of ``FineTuner`` on a rotary and a rel-pos CTC model and of
  ``SSLPretrainer`` with injected draws, against the one-process port:
  loss and ``grad_norm`` of each step, every leaf's gathered gradient at
  each step, the BatchNorm stats after the steps that ran on the same
  weights (the first's rate is 0), every leaf after the first step, and
  every leaf after each step against AdamW replayed on the gathered
  gradients (after the first update, one process's leaves and the mesh's
  differ by Adam's normalisation of fp32 noise: a bias whose exact
  gradient is 0, such as the depthwise conv's before the BatchNorm, moves
  by up to the rate either way); the eval step; the rank-0 artifact
  through the JAX loader, and the train checkpoint's round trips.

Each rank is also held to the JAX package on the same weights and
inputs, run in this process (one device, fp32), with the tolerances of the
port's one-process tests against it: the DP rows to the JAX model's
``_decode_batch``, ``transcribe_longform``, ``align_batch`` and
``encode_batch`` (texts equal, word times within 1e-6, confidences within
rtol 1e-4, the encoder output within 1e-4); the DP x TP steps to the JAX
``FineTuner`` and ``SSLPretrainer`` (BEST-RQ's quantizer and head the
port's, ``jax.random``'s draws the ranks' numpy draws): loss and norm of
each step within rtol 1e-4, the first step's gradients within 1e-4 of each
leaf's largest entry (or of 1e-2 of the largest gradient), the BatchNorm
stats within 1e-5, the fine-tuners' leaves after three steps as
``tests/test_torch_training.py`` holds them, the eval steps and the
artifact.  The JAX trainers read the port's log-mel features of the batch
(``jax_trainer``).

One spawn per layout (a module fixture) serves all of its checks.
"""

import contextlib

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from gigaam_tpu_torch.parallel import distributed as pdist
from gigaam_tpu_torch.parallel import mesh as tmesh
from gigaam_tpu_torch.train.finetune import (
    FineTuner,
    TrainConfig,
    is_bn_buffer,
    make_optimizer,
)
from gigaam_tpu_torch.train.pretrain import PretrainConfig
from gigaam_tpu_torch.weights import _flatten, params_from_jax, params_to_jax

# fp32 on both sides, the sums in another order and split over ranks
ATOL = 1e-5
# against the JAX package: another framework's kernels in fp32 (the port's
# one-process tests hold it so: tests/test_torch_training.py,
# test_torch_longform.py, test_torch_encoder.py)
JAX_RTOL = 1e-4          # loss, norm; a gradient to its leaf's largest entry
TIME_ATOL = 1e-6         # word times, rounded to the ms on both sides
CONF_RTOL = 1e-4         # exp(mean logp) of a word
ENC_ATOL = 1e-4          # the encoder output
# a gradient's tolerance is JAX_RTOL of its leaf's largest entry, or of
# GRAD_FLOOR of the largest gradient if that is more.  The one-process tests
# take 1e-3; the mesh adds every batch sum in another order (each data
# rank its rows, then the ranks' sums) and splits the tensor-parallel
# products' sums, an error of the order of the rounding of the sum's terms:
# the GLU gate's bias, whose gradient cancels to 3e-3 of the largest, moves
# by 1.3e-4 of its own largest entry at data 2 x model 2 (4e-7 of the
# largest gradient, less than the one-process port's largest error)
GRAD_FLOOR = 1e-2
KINDS = ("rotary", "rel_pos", "ssl")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(task: str, world: int, out: str):
    """Start ``world`` ranks of ``task``; returns a function that waits for
    them and returns each rank's pickled results (this process works on
    while the ranks run)."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, str(r), str(world), str(port), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]

    def results() -> list:
        logs = [p.communicate(timeout=240)[0].decode(errors="replace")
                for p in procs]
        failed = [r for r, p in enumerate(procs) if p.returncode]
        assert not failed, "\n".join(f"rank {r} failed:\n{logs[r][-3000:]}"
                                      for r in failed)
        ranks = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        return ranks

    return results


@pytest.fixture(scope="module")
def _inference_runs(tmp_path_factory):
    """The 2 ranks, and meanwhile the one-process port and the JAX models
    on the same weights and clips."""
    ranks = spawn("inference", 2, str(tmp_path_factory.mktemp("dp")))
    one = worker.inference_results(*worker.inference_models())
    ref = jax_inference_run()
    return {"one": one, "jax": ref, "ranks": ranks()}


@pytest.fixture(scope="module")
def inference(_inference_runs):
    return _inference_runs["one"], _inference_runs["ranks"]


@pytest.fixture(scope="module")
def jax_inference(_inference_runs):
    return _inference_runs["jax"]


@pytest.fixture(scope="module")
def _training_runs(tmp_path_factory):
    """The 4 ranks, and meanwhile the one-process port and the JAX
    trainers."""
    out = str(tmp_path_factory.mktemp("dptp"))
    ranks = spawn("training", 4, out)
    one = worker.training_results(None, out, "one")
    ref = {kind: jax_training_run(kind) for kind in KINDS}
    return {"one": one, "jax": ref, "ranks": ranks(), "out": out}


@pytest.fixture(scope="module")
def training(_training_runs):
    r = _training_runs
    return r["one"], r["ranks"], r["out"]


@pytest.fixture(scope="module")
def jax_training(_training_runs):
    return _training_runs["jax"]


# ---------------------------------------------------------------------------
# Specs, shards, process helpers
# ---------------------------------------------------------------------------

def tiny_tree(attention, conv_norm="batch_norm", subsampling="conv2d"):
    import dataclasses

    import gigaam_tpu_torch as gt

    cfg = worker.ctc_cfg(attention)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, conv_norm_type=conv_norm, subsampling=subsampling))
    return cfg, params_to_jax(gt.GigaAMASR(cfg, seed=1, device="cpu"))


SPEC_CASES = [("rotary", "batch_norm", "conv2d"),
              ("rel_pos", "batch_norm", "conv2d"),
              ("rotary", "layer_norm", "conv2d"),
              ("rel_pos", "layer_norm", "conv2d"),
              ("rotary", "batch_norm", "conv1d")]


@pytest.mark.parametrize("case", SPEC_CASES, ids=["-".join(c)
                                                 for c in SPEC_CASES])
def test_pspecs_match_jax(case):
    """Each leaf's sharded axis (or None) is the JAX spec's "model" axis."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gigaam_tpu.parallel.mesh import params_pspecs as jax_pspecs

    cfg, tree = tiny_tree(*case)
    enc = cfg.encoder
    ours = _flatten(tmesh.params_pspecs(
        tree, enc.self_attention_model, enc.conv_norm_type))
    ref = jax_pspecs(tree, enc.self_attention_model, enc.conv_norm_type)
    leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, P))[0]
    theirs = {"/".join(k.key for k in path): (
        spec.index("model") if "model" in spec else None)
        for path, spec in leaves}
    assert set(ours) == set(_flatten(tree)) == set(theirs)
    assert ours == theirs


@pytest.mark.parametrize("attention", ["rotary", "rel_pos"])
@pytest.mark.parametrize("m", [2, 4])
def test_shard_then_unshard_is_bit_equal(attention, m):
    cfg, tree = tiny_tree(attention)
    enc = cfg.encoder
    specs = tmesh.params_pspecs(tree, enc.self_attention_model,
                                enc.conv_norm_type)
    parts = [tmesh.shard_params(tree, specs, i, m) for i in range(m)]
    flat = _flatten(parts[0])
    assert flat["encoder/layers/feed_forward1/linear1/w"].shape[-1] == (
        enc.d_model * enc.ff_expansion_factor // m)
    assert flat["encoder/layers/self_attn/linear_out/b"].shape == (
        enc.n_layers, enc.d_model)
    back = _flatten(tmesh.unshard_params(parts, specs))
    whole = _flatten(tree)
    assert set(back) == set(whole)
    for k, a in whole.items():
        assert back[k].dtype == a.dtype and np.array_equal(back[k], a), k


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_process_shard_matches_jax(p, pad, monkeypatch):
    import jax

    from gigaam_tpu.parallel import distributed as jdist

    monkeypatch.setattr(jax, "process_count", lambda: p)
    monkeypatch.setattr(pdist, "world_size", lambda: p)
    for r in range(p):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(pdist, "rank", lambda r=r: r)
        for n in range(10):
            items = [f"item{i}" for i in range(n)]
            assert (pdist.process_shard(items, pad=pad)
                    == jdist.process_shard(items, pad=pad))
            assert (pdist.process_shard_indices(n, pad=pad)
                    == jdist.process_shard_indices(n, pad=pad))


def test_initialize_refuses_a_silent_single_process_run(monkeypatch):
    for k in ("WORLD_SIZE", "MASTER_ADDR", "OMPI_COMM_WORLD_SIZE",
              "SLURM_NTASKS", "PMI_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="rendezvous"):
        pdist.initialize("gloo", world_size=2)
    with pytest.raises(ValueError, match="rendezvous"):
        pdist.initialize("gloo", rank=1)
    with pytest.raises(ValueError, match="backend"):
        pdist.initialize("mpi")
    pdist.initialize("gloo")                  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    assert (pdist.world_size(), pdist.rank()) == (1, 0)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert not pdist._env_configured()        # no rendezvous address
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    assert pdist._env_configured()


# ---------------------------------------------------------------------------
# Data-parallel inference, 2 ranks
# ---------------------------------------------------------------------------

def assert_same_rows(got, ref):
    """(text, words, ...) rows: texts and word texts equal, word times and
    confidences and any trailing numbers within ATOL."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g[0] == r[0]
        assert [w[0] for w in g[1]] == [w[0] for w in r[1]]
        np.testing.assert_allclose([w[1:] for w in g[1]],
                                   np.reshape([w[1:] for w in r[1]], (-1, 3)),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(g[2:], r[2:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("key", ["ctc_batch2", "ctc_batch3", "rnnt_batch2",
                                 "rnnt_batch3", "longform", "align"])
def test_dp_inference_matches_one_process(inference, key):
    ref, ranks = inference
    assert ref[key] and any(row[0] for row in ref[key])
    for got in ranks:
        assert_same_rows(got[key], ref[key])


def test_dp_encode_batch_matches_one_process(inference):
    ref, ranks = inference
    for got in ranks:
        assert got["encode"][0].shape == ref["encode"][0].shape
        np.testing.assert_array_equal(got["encode"][1], ref["encode"][1])
        np.testing.assert_allclose(got["encode"][0], ref["encode"][0],
                                   atol=ATOL, rtol=0)


def test_dp_k1_gate_reads_the_per_rank_batch(inference):
    """One process folds LN + residual (K1) at batch 2 and 3; over 2 ranks
    a batch of 2 is one row a rank (K2) and a batch of 3, padded to 4, is
    two rows a rank (K1): one call a layer each."""
    ref, ranks = inference
    for kind in ("ctc", "rnnt"):
        assert ref[f"{kind}_batch2_folds"] == {"K1": 2, "K2": 0}
        assert ref[f"{kind}_batch3_folds"] == {"K1": 2, "K2": 0}
        for got in ranks:
            assert got[f"{kind}_batch2_folds"] == {"K1": 0, "K2": 2}
            assert got[f"{kind}_batch3_folds"] == {"K1": 2, "K2": 0}


@pytest.mark.parametrize("layout", ["inference", "training"])
def test_ranks_import_no_jax(layout, request):
    ranks = request.getfixturevalue(layout)[1]
    assert not any(r["jax_loaded"] for r in ranks)


# ---------------------------------------------------------------------------
# DP x TP training, 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_loss_and_norm(training, kind):
    ref, ranks, _ = training
    for got in ranks:
        for g, r in zip(got[kind], ref[kind]):
            assert g["lr"] == r["lr"]
            assert abs(g["loss"] - r["loss"]) <= ATOL * max(1, abs(r["loss"]))
            assert abs(g["grad_norm"] - r["grad_norm"]) <= (
                ATOL * r["grad_norm"])


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_gradients(training, kind):
    """Every leaf's gradient, gathered whole, at every step."""
    ref, ranks, _ = training
    for got in ranks:
        for g, r in zip(got[kind], ref[kind]):
            assert set(g["grads"]) == set(r["grads"])
            for k, a in r["grads"].items():
                np.testing.assert_allclose(g["grads"][k], a, atol=ATOL,
                                           rtol=0, err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_batch_norm_stats(training, kind):
    """Sync-BN: the running stats after the steps whose forward ran on the
    same weights (the first two: the first update's rate is 0)."""
    ref, ranks, _ = training
    for got in ranks:
        for g, r in zip(got[kind][:2], ref[kind][:2]):
            a = r["params"]["encoder"]["layers"]["conv"]["batch_norm"]
            b = g["params"]["encoder"]["layers"]["conv"]["batch_norm"]
            assert np.abs(a["mean"]).max() > 1e-3     # the stats moved
            for stat in ("mean", "var"):
                np.testing.assert_allclose(b[stat], a[stat], atol=ATOL,
                                           rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_leaves_after_the_first_step(training, kind):
    ref, ranks, _ = training
    whole = _flatten(ref[kind][0]["params"])
    for got in ranks:
        mine = _flatten(got[kind][0]["params"])
        assert set(mine) == set(whole)
        for k, a in whole.items():
            np.testing.assert_allclose(mine[k], a, atol=ATOL, rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_leaves_follow_adamw(training, kind):
    """Each step's leaves, gathered, are AdamW's on the gathered gradients:
    the moments live on the shards and each update lands on its shard."""
    _, ranks, _ = training
    tc = TrainConfig()
    for got in ranks:
        init = got[f"{kind}_init"]
        names = [k.split("/", 1)[1] for k in got[kind][0]["grads"]]
        params = {n: torch.nn.Parameter(torch.from_numpy(
            init[f"param/{n}"].copy())) for n in names}
        opt, _ = make_optimizer(tc, list(params.values()))
        for rec in got[kind]:
            for n, p in params.items():
                p.grad = torch.from_numpy(rec["grads"][f"grad/{n}"])
            for group in opt.param_groups:
                group["lr"] = rec["lr"]
            opt.step()
            for n, p in params.items():
                np.testing.assert_array_equal(
                    p.detach().numpy(), rec["named"][f"param/{n}"],
                    err_msg=n)


@pytest.mark.parametrize("rows", ["", "3"])
@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_eval_step(training, kind, rows):
    """The eval step of the whole batch, also of 3 rows over data 2 (a
    zero-length row pads them, and no mean counts it)."""
    ref, ranks, _ = training
    r = ref[f"{kind}_eval{rows}"]
    for got in ranks:
        g = got[f"{kind}_eval{rows}"]
        assert abs(g[0] - r[0]) <= ATOL * max(1, abs(r[0]))
        if kind == "ssl":
            assert abs(g[1] - r[1]) <= ATOL
        else:
            assert g[1] == r[1] and len(g[1]) == int(rows or 4)


def test_dp_tp_artifact_loads_in_jax(training):
    """Rank 0 alone wrote the gathered artifact; the JAX package's loader
    reads it equal to the one-process artifact."""
    import jax

    from gigaam_tpu.models.model import load_native

    _, ranks, out = training
    got = load_native(os.path.join(out, "mesh_art"))
    ref = load_native(os.path.join(out, "one_art"))
    g = _flatten(jax.tree.map(np.asarray, got.params))
    r = _flatten(jax.tree.map(np.asarray, ref.params))
    assert set(g) == set(r)
    for k, a in r.items():
        np.testing.assert_allclose(g[k], a, atol=ATOL, rtol=0, err_msg=k)
    assert got.cfg.to_dict() == ref.cfg.to_dict()


def test_dp_tp_checkpoint_round_trips(training):
    """The mesh's train checkpoint restores on the mesh (every leaf kept)
    and in one process, re-sharded the other way: the leaves the mesh held
    and AdamW's moments, whole."""
    import gigaam_tpu_torch as gt

    ref, ranks, out = training
    assert all(r["restored_equal"] for r in ranks) and ref["restored_equal"]
    model = gt.GigaAMASR(worker.ctc_cfg("rotary"), seed=0, device="cpu")
    ft = FineTuner(model, TrainConfig(lr=1e-3, total_steps=10,
                                      precision="fp32"))
    ft.restore_checkpoint(os.path.join(out, "mesh.ckpt"))
    assert ft.step == 3
    named = worker.by_name(ft, "param")
    for k, a in ranks[0]["rotary"][-1]["named"].items():
        np.testing.assert_array_equal(named[k], a, err_msg=k)
    with np.load(os.path.join(out, "mesh.ckpt")) as z:
        for n, p in zip(ft._train_names, ft._train_params):
            np.testing.assert_array_equal(
                ft.optimizer.state[p]["exp_avg"].numpy(),
                z[f"opt/{n}/exp_avg"])
            assert z[f"opt/{n}/exp_avg"].shape == tuple(p.shape)


# ---------------------------------------------------------------------------
# The JAX package on the same weights and inputs
# ---------------------------------------------------------------------------

def port_tree(model) -> dict:
    """A port model's JAX-layout tree, copied into jax arrays."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                        params_to_jax(model))


def jax_config(model):
    from gigaam_tpu.config import ModelConfig

    return ModelConfig.from_dict(model.cfg.to_dict())


def port_names(tree) -> dict:
    """A JAX-layout tree (parameters or gradients) -> {the port's parameter
    name: numpy array}: the model's leaves through the bridge, an SSL
    head's as they are."""
    import jax

    host = jax.tree.map(np.asarray, tree)
    state = params_from_jax({k: host[k] for k in ("encoder", "head")
                             if k in host})

    def walk(node, prefix):
        items = enumerate(node) if isinstance(node, list) else node.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v.numpy()

    out = dict(walk(state, ""))
    out.update({f"ssl_head.{k}": v
                for k, v in host.get("ssl_head", {}).items()})
    return out


@contextlib.contextmanager
def rank_draws():
    """``jax.random.bernoulli`` and ``normal`` drawing what the ranks'
    ``InjectedSSL`` draws for the same shapes."""
    import jax
    import jax.numpy as jnp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", lambda key, p, shape: (
            jnp.asarray(worker.draw_starts(tuple(shape), p))))
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(
                       worker.draw_normal(tuple(shape)), dtype))
        yield


def jax_trainer(kind: str):
    """The JAX package's trainer of ``kind`` on the ranks' initial weights
    (BEST-RQ with the port's quantizer and head), and the ranks' batch.
    Its frontend returns the port's log-mel features of the batch's rows
    (``tests/test_torch_frontend.py`` holds the frontends to each other):
    they differ by up to 2e-4 on features up to 20.7 here, which moves
    BEST-RQ's first subsampling conv's gradient by 1e-3 of its largest
    entry, whatever the encoder, the losses and the collectives do."""
    import jax.numpy as jnp

    from gigaam_tpu.models.model import GigaAM as JaxGigaAM
    from gigaam_tpu.models.model import GigaAMASR as JaxASR
    from gigaam_tpu.train import finetune as jft
    from gigaam_tpu.train import pretrain as jpre

    model = worker.train_model(kind)
    batch = worker.train_batch(kind, model)
    cls = JaxGigaAM if kind == "ssl" else JaxASR
    jm = cls(jax_config(model), params=port_tree(model),
             compute_dtype=jnp.float32)
    with torch.no_grad():
        feats, lens = (t.numpy() for t in model.frontend(
            torch.from_numpy(batch[0]), torch.from_numpy(batch[1])))
    jm.frontend.forward = lambda wavs, wav_lens: (
        jnp.asarray(feats[:wavs.shape[0]]), jnp.asarray(lens[:wavs.shape[0]]))
    if kind != "ssl":
        return jft.FineTuner(jm, jft.TrainConfig(**worker.TRAIN_KW)), batch
    port = worker.InjectedSSL(model, PretrainConfig(**worker.SSL_KW))
    extra = {"quantizer": {k: jnp.asarray(v.numpy())
                           for k, v in port.quantizer.items()},
             "ssl_head": {k: jnp.asarray(p.detach().numpy())
                          for k, p in port.ssl_head.named_parameters()}}

    class PortQuantizer(jpre.SSLPretrainer):
        def _init_params(self, params):
            return dict(params, **extra)

    return PortQuantizer(jm, jpre.PretrainConfig(**worker.SSL_KW)), batch


def jax_training_run(kind: str) -> dict:
    """Three steps of the JAX trainer: each step's loss, norm, rate and
    leaves after it (by port name), the tree after the first, the first
    step's gradients clipped as the port clips them, and the eval steps
    after the first."""
    import jax
    import jax.numpy as jnp

    trainer, batch = jax_trainer(kind)
    jb = tuple(jnp.asarray(x) for x in batch)
    key = jax.random.PRNGKey(0)
    out = {"steps": []}
    with rank_draws():
        grads = jax.jit(jax.grad(lambda p: trainer._forward_loss(
            p, jb, key, train=True)[0]))(trainer.params)
        for step in range(3):
            m = trainer.train_step(batch, key)
            out["steps"].append({
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "lr": m["lr"], "named": port_names(trainer.params)})
            if step == 0:
                out["tree"] = jax.tree.map(np.asarray, trainer.params)
                out["eval"] = trainer.eval_step(batch)
                out["eval3"] = trainer.eval_step(tuple(x[:3] for x in batch))
    clip = trainer.tc.grad_clip
    scale = clip / max(out["steps"][0]["grad_norm"], clip)
    out["grads"] = {n: g * scale for n, g in port_names(grads).items()}
    return out


def jax_inference_run() -> dict:
    import jax.numpy as jnp

    from gigaam_tpu.models.model import GigaAMASR as JaxASR

    models = [JaxASR(jax_config(m), params=port_tree(m),
                     compute_dtype=jnp.float32)
              for m in worker.inference_models()]
    return worker.inference_results(*models, port=False)


@pytest.mark.parametrize("key", ["ctc_batch2", "ctc_batch3", "rnnt_batch2",
                                 "rnnt_batch3", "longform", "align"])
def test_dp_inference_matches_jax(inference, jax_inference, key):
    """Each rank's gathered rows against the JAX model's on the same
    weights: texts and word texts equal, word times within TIME_ATOL,
    confidences within CONF_RTOL, segment bounds equal."""
    ref = jax_inference[key]
    assert ref and any(row[0] for row in ref)
    for got in inference[1]:
        got = got[key]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g[0] == r[0]
            assert [w[0] for w in g[1]] == [w[0] for w in r[1]]
            np.testing.assert_allclose(
                [w[1:3] for w in g[1]],
                np.reshape([w[1:3] for w in r[1]], (-1, 2)),
                atol=TIME_ATOL, rtol=0)
            np.testing.assert_allclose([w[3] for w in g[1]],
                                       [w[3] for w in r[1]], rtol=CONF_RTOL)
            np.testing.assert_allclose(g[2:], r[2:], atol=TIME_ATOL, rtol=0)


def test_dp_encode_batch_matches_jax(inference, jax_inference):
    """The encoder output on every row's valid frames (the padded ones hold
    what each framework's attention leaves there)."""
    enc, lens = jax_inference["encode"]
    for got in inference[1]:
        np.testing.assert_array_equal(got["encode"][1], lens)
        assert got["encode"][0].shape == enc.shape
        for i, n in enumerate(lens):
            np.testing.assert_allclose(got["encode"][0][i, :n], enc[i, :n],
                                       atol=ENC_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_steps_match_jax(training, jax_training, kind):
    """Each step's loss, norm and rate against the JAX trainer's."""
    ref = jax_training[kind]["steps"]
    for got in training[1]:
        assert len(got[kind]) == len(ref)
        for g, r in zip(got[kind], ref):
            assert g["lr"] == r["lr"]
            np.testing.assert_allclose(g["loss"], r["loss"], rtol=JAX_RTOL)
            np.testing.assert_allclose(g["grad_norm"], r["grad_norm"],
                                       rtol=JAX_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_gradients_match_jax(training, jax_training, kind):
    """The first step's gradient of every leaf, gathered whole, within
    JAX_RTOL of the leaf's largest entry (with a floor of GRAD_FLOOR of the
    largest gradient); the depthwise conv's bias, whose gradient the
    BatchNorm removes, near zero on both sides (below 1e-5 of the largest
    gradient)."""
    ref = jax_training[kind]["grads"]
    largest = max(float(np.abs(r).max()) for r in ref.values())
    floor = GRAD_FLOOR * largest
    for got in training[1]:
        grads = {k.split("/", 1)[1]: v for k, v in got[kind][0]["grads"]
                 .items()}
        assert set(grads) == {n for n in ref if not is_bn_buffer(n)}
        for name, g in grads.items():
            r = ref[name]
            if name.endswith("depthwise_conv.b"):
                assert float(np.abs(g).max()) <= 1e-5 * largest, name
                assert float(np.abs(r).max()) <= 1e-5 * largest, name
                continue
            tol = JAX_RTOL * max(float(np.abs(r).max()), floor)
            assert float(np.abs(g - r).max()) <= tol, name


@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_batch_norm_stats_match_jax(training, jax_training, kind):
    """Sync-BN: the running stats after the first two steps (the first's
    rate is 0, so both ran on the initial weights) against JAX's, whose
    statistics span the whole batch."""
    ref = jax_training[kind]["steps"]
    for got in training[1]:
        for g, r in zip(got[kind][:2], ref[:2]):
            names = [n for n in r["named"] if is_bn_buffer(n)]
            assert names
            for n in names:
                np.testing.assert_allclose(g["named"][f"param/{n}"],
                                           r["named"][n], atol=ATOL, rtol=0,
                                           err_msg=n)


@pytest.mark.parametrize("kind", ["rotary", "rel_pos"])
def test_dp_tp_leaves_match_jax(training, jax_training, kind):
    """The fine-tuners' leaves after three steps, as
    ``tests/test_torch_training.py`` holds the one-process port's to JAX:
    every entry within 4 lr, and within 0.1 lr where the first gradient is
    well away from zero (above 1e-2 of its leaf's largest entry, in a leaf
    whose gradient is above 1e-3 of the largest).  BEST-RQ's one-process
    port already moves an entry of ``pre_encode.conv_1.w`` (its first
    gradient 1.2e-2 of the leaf's largest) by 0.117 lr from JAX's over these
    steps: Adam divides by the gradient's own size.  Its leaves are held by
    the gradients, each step's loss and norm, and AdamW replayed on the
    mesh's gradients (``test_dp_tp_leaves_follow_adamw``)."""
    ref = jax_training[kind]
    lr = worker.TRAIN_KW["lr"]
    noise = 1e-3 * max(float(np.abs(g).max()) for g in ref["grads"].values())
    for got in training[1]:
        named = got[kind][-1]["named"]
        for n, r in ref["steps"][-1]["named"].items():
            diff = np.abs(named[f"param/{n}"] - r)
            assert float(diff.max()) <= 4 * lr, n
            g = np.abs(ref["grads"][n])
            if is_bn_buffer(n) or float(g.max()) <= noise:
                continue
            firm = g > 1e-2 * g.max()
            assert float(diff[firm].max()) <= 0.1 * lr, n


@pytest.mark.parametrize("rows", ["", "3"])
@pytest.mark.parametrize("kind", KINDS)
def test_dp_tp_eval_step_matches_jax(training, jax_training, kind, rows):
    """The eval step after the first train step, of 4 rows and of 3 (a
    zero-length row pads them over data 2): the loss within JAX_RTOL, the
    hypotheses (BEST-RQ: the accuracy) equal."""
    r = jax_training[kind][f"eval{rows}"]
    for got in training[1]:
        g = got[f"{kind}_eval{rows}"]
        np.testing.assert_allclose(g[0], float(r[0]), rtol=JAX_RTOL)
        if kind == "ssl":
            assert float(g[1]) == float(r[1])
        else:
            assert list(g[1]) == list(r[1])


def test_dp_tp_artifact_matches_the_jax_trainer(training, jax_training):
    """The rank-0 artifact, read by the JAX loader, against the JAX
    trainer's tree after the same first step."""
    import jax

    from gigaam_tpu.models.model import load_native

    got = _flatten(jax.tree.map(np.asarray, load_native(
        os.path.join(training[2], "mesh_art")).params))
    ref = _flatten(jax_training["rotary"]["tree"])
    assert set(got) == set(ref)
    for k, a in ref.items():
        np.testing.assert_allclose(got[k], a, atol=ATOL, rtol=0, err_msg=k)

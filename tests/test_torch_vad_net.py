"""The port's PyanNet (``gigaam_tpu_torch/models/vad_net.py``) against the
JAX module on the same weights, carried by ``weights.vad_params_from_jax``,
on the CPU in fp32 at a small width (8 sinc filters, 6 conv channels,
2-layer BiLSTM of 8), with inputs drawn from ``numpy.random.default_rng``:

* ``frame_logits`` (the module's forward) within LOGIT_ATOL;
* ``sliding_class_probs`` with a 2 s window and a 1 s hop over 70 s (past
  one 64-window mega-batch) and on clips shorter than a window or than the
  receptive field, within PROB_ATOL, the frame times equal;
* ``speech_regions`` (with and without the min-duration post-processing)
  equal, with the classifier scaled so that the powerset argmax has a
  top-1/top-2 margin above MARGIN on every frame (random weights give
  near-ties; the precondition is asserted, not assumed);
* a JAX ``save_vad`` artifact read by the port's ``load_vad`` and
  ``load_vad_regions_fn``, and the port's artifact read by the JAX one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from gigaam_tpu.models import vad_net as jv

from gigaam_tpu_torch.models import vad_net as tv
from gigaam_tpu_torch.weights import vad_params_from_jax

# fp32 on both sides: the same convs, LSTM and linears summed in another
# order, log-probs of magnitude <= ~5
LOGIT_ATOL = 1e-5
# probabilities in [0, 1], averaged over <= 2 windows
PROB_ATOL = 1e-5
# argmax decisions are compared where the top-1/top-2 gap exceeds this
MARGIN = 1e-4
SR = 16000

SMALL = dict(sinc_filters=8, sinc_kernel=31, sinc_stride=10,
             conv_channels=6, conv_kernel=5, n_conv_blocks=2, pool=3,
             lstm_hidden=8, lstm_layers=2, linear_hidden=8, linear_layers=2,
             n_classes=7, window_s=2.0, step_s=1.0)


@pytest.fixture(scope="module")
def nets():
    jcfg = jv.VADNetConfig(**SMALL)
    params = jax.tree.map(np.asarray,
                          jv.init_vad_params(jax.random.PRNGKey(0), jcfg))
    net = tv.PyanNet(tv.VADNetConfig(**SMALL), vad_params_from_jax(params))
    return jcfg, params, net


def audio(seconds, seed):
    """Noise under a slow envelope: loud and quiet stretches."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    env = 0.5 * (1 + np.sin(2 * np.pi * 0.3 * np.arange(n) / SR))
    return (0.2 * env * rng.standard_normal(n)).astype(np.float32)


def test_config_is_the_jax_one():
    assert (dataclasses.asdict(tv.VADNetConfig())
            == dataclasses.asdict(jv.VADNetConfig()))
    for kw in ({}, SMALL):
        j, t = jv.VADNetConfig(**kw), tv.VADNetConfig(**kw)
        assert j.receptive_field() == t.receptive_field()
        assert [j.num_frames(n) for n in (400, 32000, 160000)] == \
            [t.num_frames(n) for n in (400, 32000, 160000)]


@pytest.mark.parametrize("batch,seconds", [(1, 0.5), (3, 2.0), (8, 2.0)])
def test_frame_logits_match_jax(nets, batch, seconds):
    jcfg, params, net = nets
    rng = np.random.default_rng(batch)
    wavs = (0.1 * rng.standard_normal((batch, int(seconds * SR)))).astype(
        np.float32)
    ref = np.asarray(jv.frame_logits(params, wavs, jcfg))
    with torch.inference_mode():
        got = net(torch.from_numpy(wavs)).numpy()
    assert got.shape == ref.shape == (batch, jcfg.num_frames(wavs.shape[1]),
                                      jcfg.n_classes)
    np.testing.assert_allclose(got, ref, atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("seconds", [70.0, 1.3, 0.01])
def test_sliding_class_probs_match_jax(nets, seconds):
    """70 s at a 1 s hop is 69 windows: a mega-batch of 64, then one of 5
    padded to 8.  1.3 s is one zero-padded window; 0.01 s is shorter than
    the receptive field."""
    jcfg, params, net = nets
    wav = audio(seconds, seed=int(seconds * 10))
    ref, ref_t = jv.sliding_class_probs(params, jcfg, wav)
    got, got_t = tv.sliding_class_probs(net, wav)
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


# A random classifier at its init scale gives near-uniform class
# probabilities (top-1/top-2 margins down to 1e-7 over 40 s); the regions
# test scales its weights by this, which decides every frame of its input
CLASSIFIER_GAIN = 100.0


@pytest.fixture(scope="module")
def decided_nets(nets):
    jcfg, params, _ = nets
    params = dict(params, classifier={
        "w": params["classifier"]["w"] * CLASSIFIER_GAIN,
        "b": params["classifier"]["b"]})
    return jcfg, params, tv.PyanNet(tv.VADNetConfig(**SMALL),
                                    vad_params_from_jax(params))


def margins(probs):
    top = np.sort(probs, axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("on,off", [(0.0, 0.0), (0.3, 0.2)])
def test_speech_regions_match_jax(decided_nets, on, off):
    jcfg, params, net = decided_nets
    wav = audio(40.0, seed=3)
    ref_p, _ = jv.sliding_class_probs(params, jcfg, wav)
    assert margins(ref_p).min() > MARGIN
    got = tv.speech_regions(net, wav, min_duration_on=on,
                            min_duration_off=off)
    assert got == jv.speech_regions(params, jcfg, wav, min_duration_on=on,
                                    min_duration_off=off)
    assert len(got) > 2
    assert tv.make_speech_regions_fn(net)(wav) == \
        jv.make_speech_regions_fn(params, jcfg)(wav)


def test_jax_artifact_loads_in_the_port(tmp_path):
    """``init_vad_params`` (its ``norms`` entries share one dict) saved by
    the JAX ``save_vad``, read by the port; the port's artifact read by
    the JAX ``load_vad``, leaf for leaf."""
    jcfg = jv.VADNetConfig(**SMALL)
    params = jv.init_vad_params(jax.random.PRNGKey(2), jcfg)
    path = str(tmp_path / "vad")
    jv.save_vad(path, jcfg, params)
    cfg, state = tv.load_vad(path + ".npz")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    net = tv.PyanNet(cfg, state)
    wav = audio(5.0, seed=9)
    ref, _ = jv.sliding_class_probs(params, jcfg, wav)
    got, _ = tv.sliding_class_probs(net, wav)
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL, rtol=0)
    fn = tv.load_vad_regions_fn(path, device="cpu")
    assert fn(wav) == tv.speech_regions(net, wav)

    tv.save_vad(str(tmp_path / "port"), net)
    back_cfg, back = jv.load_vad(str(tmp_path / "port.npz"))
    assert back_cfg == jcfg
    flat = jax.tree.leaves(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, back)), flat):
        np.testing.assert_array_equal(a, b)
    assert len(jax.tree.leaves(back)) == len(flat)


def test_init_vad_state_distributions():
    """Shapes of the JAX tree after the bridge, and the JAX init's scales:
    normal / sqrt(fan-in) for the LSTM and linears, 0.02 for the taps,
    0.05 for the convs; zero biases, unit norms."""
    cfg = tv.VADNetConfig()
    state = tv.init_vad_state(cfg, seed=0)
    ref = vad_params_from_jax(jax.tree.map(
        np.asarray, jv.init_vad_params(jax.random.PRNGKey(0),
                                       jv.VADNetConfig())))
    shapes = jax.tree.map(lambda t: tuple(t.shape), (state, ref))
    assert shapes[0] == shapes[1]
    assert abs(float(state["sinc"]["taps"].std()) - 0.02) < 0.002
    assert abs(float(state["convs"][0]["w"].std()) - 0.05) < 0.005
    w = state["lstm"]["weight_ih_l1_reverse"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
    assert float(state["lstm"]["bias_hh_l0"].abs().max()) == 0.0
    assert torch.equal(state["norms"][2]["w"], torch.ones(cfg.conv_channels))

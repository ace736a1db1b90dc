"""The port's helpers, tools and examples, on the CPU:

* ``audio.format_time`` against the JAX package's on a grid;
* ``profiling.trace`` writes a Chrome trace of its block;
* ``tools/train_lm.py``'s npz against ``tools/train_lm.py``'s (the JAX
  tool), array for array;
* ``tools/export_hf_dataset.py`` through its ``main`` with a stubbed
  ``datasets`` package, against the JAX tool's export of the same rows;
* ``tools/run_parity.py`` with its downloads and its model loads stubbed
  (no network);
* the three examples at tiny width with ``--device cpu``;
* the train CLI on a reference ``.ckpt``, and under ``--data_parallel 2``
  with 2 ``gloo`` ranks against the one-process CLI;
* the new entry points in a process that imports no jax.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import gigaam_tpu_torch as gt
import torch_parallel_worker as worker
from gigaam_tpu_torch.audio import format_time, save_wav
from gigaam_tpu_torch.data import write_manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
# fp32 on both sides, sums in another order and split over ranks
ATOL = 1e-5


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", [1e-2, 1.0, 60.0, 3600.0])
def test_format_time_matches_jax(scale):
    from gigaam_tpu.audio import format_time as jax_format_time

    rng = np.random.default_rng(int(scale * 100))
    grid = np.concatenate([np.arange(0, 200) * scale / 7,
                           rng.uniform(0, 100 * scale, 200)])
    for s in grid:
        assert format_time(float(s)) == jax_format_time(float(s)), s


def test_trace_writes_a_profile(tmp_path):
    from gigaam_tpu_torch.profiling import trace

    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        (x @ x).sum()
    with trace(str(tmp_path / "prof")):
        x + 1
    files = sorted(os.listdir(tmp_path / "prof"))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in k.key for k in prof.key_averages())


def write_text_sources(tmp_path):
    manifest = str(tmp_path / "m.tsv")
    write_manifest(manifest, [("a.wav", 1.0, "Привет, мир!"),
                              ("b.wav", 2.0, "ёлка и мир"),
                              ("c.wav", 1.0, "")])
    text = tmp_path / "corpus.txt"
    text.write_text("мир дому\n\nмир миру мир\nкак дела\n", encoding="utf-8")
    return manifest, str(text)


@pytest.mark.parametrize("order", [2, 3])
def test_train_lm_matches_the_jax_tool(tmp_path, monkeypatch, order):
    from gigaam_tpu_torch.tools import train_lm

    manifest, text = write_text_sources(tmp_path)
    args = ["--manifest", manifest, "--text", text, "--order", str(order)]
    train_lm.main(args + ["--out", str(tmp_path / "port.npz")])
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args, "--out",
                                      str(tmp_path / "jax.npz")])
    jax_tool("train_lm").main()
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(SystemExit):
        train_lm.main(["--out", str(tmp_path / "none.npz")])


class FakeSplit:
    """A ``datasets`` split cast to 16 kHz audio, in memory."""

    def __init__(self, rows):
        self.rows = rows
        self.cast = None

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def cast_column(self, column, feature):
        self.cast = (column, feature.sampling_rate)
        return self


def test_export_hf_dataset_with_a_stubbed_datasets(tmp_path, monkeypatch):
    from gigaam_tpu_torch.data import AudioDataset
    from gigaam_tpu_torch.tools import export_hf_dataset

    rng = np.random.default_rng(0)
    rows = [{"speech": {"array": 0.1 * rng.standard_normal(SR // 2 + 80 * i)},
             "sentence": f"пример {i}"} for i in range(5)]
    data = FakeSplit(rows)
    calls = []

    def load_dataset(name, config, split=None):
        calls.append((name, config, split))
        return data

    fake = types.ModuleType("datasets")
    fake.load_dataset = load_dataset
    fake.Audio = lambda sampling_rate: types.SimpleNamespace(
        sampling_rate=sampling_rate)
    monkeypatch.setitem(sys.modules, "datasets", fake)
    out = str(tmp_path / "port")
    export_hf_dataset.main(["--dataset", "some/set", "--split", "dev",
                            "--audio-column", "speech", "--text-column",
                            "sentence", "--out", out, "--limit", "4",
                            "--workers", "2"])
    assert calls == [("some/set", None, "dev")]
    assert data.cast == ("speech", SR)
    ref = jax_tool("export_hf_dataset").export_dataset(
        data, str(tmp_path / "jax"), "speech", "sentence", 2, 4)
    with open(os.path.join(out, "manifest.tsv")) as f, open(ref) as g:
        assert f.read() == g.read()
    ds = AudioDataset(os.path.join(out, "manifest.tsv"))
    assert [s.text for s in ds.samples] == [f"пример {i}" for i in range(4)]
    for i in range(4):
        with open(os.path.join(out, "wavs", f"{i:07d}.wav"), "rb") as f, \
                open(os.path.join(tmp_path, "jax", "wavs",
                                  f"{i:07d}.wav"), "rb") as g:
            assert f.read() == g.read()


def tiny(name):
    """The examples' tiny model of a preset, on the CPU."""
    from gigaam_tpu_torch.examples.common import example_model

    return example_model(name, "cpu", full=False)


def test_run_parity_with_stubbed_downloads(tmp_path, monkeypatch):
    """The bundle's sections with the network stubbed out: the example
    audio written locally, each model (also the eval CLI's load of the
    cached artifact) a tiny random one.  Random weights regress against
    the reference's WER: the bundle must say so and exit 1."""
    from gigaam_tpu_torch.tools import run_parity

    fetched, loads = [], []

    def download(url, path):
        fetched.append(url)
        rng = np.random.default_rng(len(fetched))
        seconds = 3 if path.endswith("/example.wav") else 30
        save_wav(path, worker.longform_audio(seconds, len(fetched))
                 if seconds > 3 else worker.voice(seconds, rng))
        return path

    models = {}

    def load_model(name, device=None, download_root=None, **kw):
        loads.append((name, device))
        base = os.path.basename(name)
        if base not in models:
            models[base] = tiny(base)
        return models[base]

    monkeypatch.setattr(gt, "_download_file", download)
    monkeypatch.setattr(gt, "load_model", load_model)
    manifest = str(tmp_path / "test.tsv")
    clip = str(tmp_path / "clip.wav")
    save_wav(clip, worker.voice(2.0, np.random.default_rng(3)))
    write_manifest(manifest, [(clip, 2.0, "привет мир")])
    out = str(tmp_path / "bundle.json")
    rc = run_parity.main(["--models", "v3_ctc,emo", "--device", "cpu",
                          "--root", str(tmp_path / "root"), "--manifest",
                          manifest, "--out", out])
    with open(out) as f:
        bundle = json.load(f)
    assert [u.rsplit("/", 1)[1] for u in fetched] == list(run_parity.AUDIO)
    assert ("v3_ctc", "cpu") in loads and ("emo", "cpu") in loads
    assert bundle["models"]["v3_ctc"]["status"] == "converted"
    assert isinstance(bundle["models"]["v3_ctc"]["text"], str)
    assert "text" not in bundle["models"]["emo"]
    assert 0.0 <= bundle["sections"]["streaming_wer"][
        "streaming_vs_offline_wer"]
    row = bundle["sections"]["wer_table"]["v3_ctc"]
    assert row["ref"] == run_parity.REF_WER["v3_ctc"]
    assert row["wer"] > row["ref"] + 0.5
    assert rc == 1 and not bundle["pass"]
    assert any(f.startswith("WER regression v3_ctc")
               for f in bundle["failures"])


def test_example_quickstart(tmp_path):
    from gigaam_tpu_torch.examples import quickstart

    out = str(tmp_path / "qs")
    quickstart.main(["--device", "cpu", "--out", out])
    assert os.path.isfile(os.path.join(out, "model.npz"))
    assert os.path.isfile(os.path.join(out, "exp", "final.npz"))


def test_example_serving(tmp_path):
    from gigaam_tpu_torch.examples import serving

    res = serving.main(["--device", "cpu", "--out", str(tmp_path / "srv")])
    assert isinstance(res["short"]["text"], str)
    assert res["long"]["segments"]


def test_example_streaming():
    from gigaam_tpu_torch.examples import streaming

    events = streaming.main(["--device", "cpu", "--seconds", "5"])
    assert events and events[-1].kind == "committed"


def train_set(tmp_path, n=4):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        path = str(tmp_path / f"c{i}.wav")
        save_wav(path, worker.voice(1.0 + 0.3 * i, rng))
        rows.append((path, 1.0 + 0.3 * i, ["привет мир", "как дела"][i % 2]))
    manifest = str(tmp_path / "train.tsv")
    write_manifest(manifest, rows)
    return manifest


def cli_args(model_name, manifest, save_dir, steps=1):
    return ["--model_name", model_name, "--train_manifest", manifest,
            "--val_manifest", manifest, "--batch_size", "2",
            "--max_steps", str(steps), "--precision", "fp32", "--device",
            "cpu", "--save_dir", save_dir, "--log_every_n_steps", "1",
            "--save_top_k", "1"]


def test_train_cli_on_a_reference_ckpt(tmp_path):
    """``--model_name`` takes a reference ``.ckpt``: the run starts from
    its weights and writes the final artifact."""
    from gigaam_tpu_torch import checkpoint as tck
    from gigaam_tpu_torch.train.train import main
    from gigaam_tpu_torch.weights import params_to_jax

    src = gt.GigaAMASR(worker.ctc_cfg(), seed=2, device="cpu")
    ckpt = str(tmp_path / "tiny_ctc.ckpt")
    torch.save({"cfg": tck.reference_cfg(src.cfg),
                "state_dict": tck.reference_state_dict(params_to_jax(src),
                                                       src.cfg)}, ckpt)
    main(cli_args(ckpt, train_set(tmp_path), str(tmp_path / "exp")))
    got = gt.load_model(str(tmp_path / "exp" / "final"), device="cpu")
    a, b = params_to_jax(got), params_to_jax(src)
    np.testing.assert_array_equal(a["head"]["proj"]["w"],
                                  b["head"]["proj"]["w"])
    with open(tmp_path / "exp" / "metrics.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds.count("train") == 1 and "val" in kinds


def test_train_cli_data_parallel_matches_one_process(tmp_path):
    """The CLI under ``torchrun``'s environment with ``--data_parallel 2``
    on 2 gloo ranks: rank 0 alone writes metrics and the final artifact,
    which hold the one-process CLI's numbers (one step, whose rate is 0:
    the BatchNorm's sync-BN stats, the train and validation losses)."""
    from gigaam_tpu_torch.train.train import main
    from gigaam_tpu_torch.weights import save_model

    from test_torch_parallel import free_port

    model = gt.GigaAMASR(worker.ctc_cfg(), seed=2, device="cpu")
    art = str(tmp_path / "tiny")
    save_model(model, art)
    manifest = train_set(tmp_path)
    main(cli_args(art, manifest, str(tmp_path / "one")))
    port = free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(r),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gigaam_tpu_torch.train.train",
             *cli_args(art, manifest, str(tmp_path / "dp")),
             "--data_parallel", "2"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = [p.communicate(timeout=240)[0].decode(errors="replace")
            for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "mesh: data=2 model=1 (2 processes, gloo)" in logs[0]

    def metrics(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return [json.loads(line) for line in f]

    got, ref = metrics("dp"), metrics("one")
    assert [m["kind"] for m in got] == [m["kind"] for m in ref]
    for g, r in zip(got, ref):
        assert abs(g["loss"] - r["loss"]) <= ATOL * max(1, abs(r["loss"]))
    with np.load(tmp_path / "dp" / "final.npz") as a, \
            np.load(tmp_path / "one" / "final.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, rtol=0,
                                       err_msg=k)


def test_new_entry_points_import_no_jax():
    code = (
        "import sys\n"
        "import gigaam_tpu_torch.parallel.distributed\n"
        "import gigaam_tpu_torch.parallel.mesh\n"
        "import gigaam_tpu_torch.tools.train_lm\n"
        "import gigaam_tpu_torch.tools.export_hf_dataset\n"
        "import gigaam_tpu_torch.tools.run_parity\n"
        "import gigaam_tpu_torch.examples.quickstart\n"
        "import gigaam_tpu_torch.examples.serving\n"
        "import gigaam_tpu_torch.examples.streaming\n"
        "from gigaam_tpu_torch.audio import format_time\n"
        "from gigaam_tpu_torch.profiling import trace\n"
        "bad = [m for m in sys.modules if m in ('jax', 'gigaam_tpu')\n"
        "       or m.startswith(('jax.', 'gigaam_tpu.', 'benchmarks'))]\n"
        "print('loaded', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "loaded []" in out.stdout

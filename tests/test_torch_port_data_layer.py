"""The rest of the port's data layer against the JAX package's on the same
files: WSJ0 items and ``WSJ0DataModule`` batches, the MixIT and
AudioSlient items, ``online_mixing_collate`` on the same numpy generator,
the video pipelines, ``SBAudioDataset``, and the native wav reader (equal
to the ``wave`` reader and to the JAX package's bindings, built once
however many processes and threads ask for it together)."""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import audio_only_speech_separation_tpu.data as jdatas
from audio_only_speech_separation_tpu.data import augment as jaugment
from audio_only_speech_separation_tpu.data import native as jnative
from audio_only_speech_separation_tpu.data import sbdataset as jsb
from audio_only_speech_separation_tpu.data import transform as jtransform
from audio_only_speech_separation_tpu_torch import data as datas
from audio_only_speech_separation_tpu_torch.data import augment, audio_io, native, sbdataset, transform

SR = 8000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_reads_natively(monkeypatch):
    """The JAX package's native bindings on the port's build of the same
    source (``native/wavio.cpp``), so the JAX side reads through its own
    ``native.read_window`` without running ``make`` in ``native/``."""
    monkeypatch.setattr(jnative, "_LIB_PATH", str(native.library_path() if native.available() else ""))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)
    assert jnative.available()


@pytest.fixture(scope="module")
def wsj0(tmp_path_factory):
    """wsj0-layout manifests (mix.json, s1-s3.json) of 0.3 s utterances, 6
    train, 3 cv, 3 tt; the third source of cv item 1 is missing (null)."""
    root = tmp_path_factory.mktemp("wsj0")
    rng = np.random.default_rng(7)
    for split, n in (("tr", 6), ("cv", 3), ("tt", 3)):
        infos = {c: [] for c in ("mix", "s1", "s2", "s3")}
        for c in infos:
            (root / split / c).mkdir(parents=True)
        for i in range(n):
            s = (0.1 * rng.standard_normal((3, 2400 + 80 * i))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), *s)):
                path = str(root / split / c / f"u{i}.wav")
                audio_io.write_wav(path, wav, SR)
                infos[c].append([path, wav.shape[-1]])
        if split == "cv":
            infos["s3"][1] = None
        for c, lst in infos.items():
            (root / split / f"{c}.json").write_text(json.dumps(lst))
    return root


def same_items(a, b):
    assert len(a) == len(b) > 0
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert len(x) == len(y)
        for u, v in zip(x, y):
            if isinstance(u, np.ndarray):
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("split,segment,normalize", [("tr", 0.25, False), ("cv", None, True), ("tt", 0.25, True)])
def test_wsj0_items_match_jax(wsj0, jax_reads_natively, split, segment, normalize):
    """Random crops (per seed, epoch, item), test mode, normalisation and a
    missing source (zeros) give the JAX package's items, epoch by epoch."""
    kw = dict(n_src=3, sample_rate=SR, segment=segment, normalize_audio=normalize, seed=4)
    ours, theirs = datas.WSJ0Dataset(str(wsj0 / split), **kw), jdatas.WSJ0Dataset(str(wsj0 / split), **kw)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        same_items(ours, theirs)
    if split == "cv":
        assert not ours[1][1][2].any()


def test_wsj0_datamodule_batches_match_jax(wsj0, jax_reads_natively):
    """``data.get("WSJ0DataModule")`` resolves, and its train, val and test
    loaders give the JAX datamodule's batches for two epochs, sharded 2
    ways as a data-parallel rank loads them and whole."""
    for shard in ((0, 1), (1, 2)):
        kw = dict(train_dir=str(wsj0 / "tr"), valid_dir=str(wsj0 / "cv"), test_dir=str(wsj0 / "tt"), n_src=3,
                  sample_rate=SR, segment=0.25, batch_size=2, num_workers=2, shard_id=shard[0],
                  num_shards=shard[1])
        ours, theirs = datas.get("WSJ0DataModule")(**kw), jdatas.get("WSJ0DataModule")(**kw)
        ours.setup()
        theirs.setup()
        for epoch in (0, 1):
            for a, b in zip(ours.make_loader, theirs.make_loader):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                got, want = list(a), list(b)
                assert len(got) == len(want) > 0
                for (m1, s1, k1), (m2, s2, k2) in zip(got, want):
                    assert np.array_equal(m1, m2) and np.array_equal(s1, s2) and k1 == k2


@pytest.mark.parametrize("cls,kw", [("MixITDataset", dict(n_src=3)), ("MixITDataset", dict(n_src=2)),
                                    ("AudioSlientDataset", dict(n_src=3, slient=0.1)),
                                    ("AudioSlientDataset", dict(n_src=2, gauss=True, slient=0.05, snr_db=-20.0))])
def test_extra_datasets_match_jax(wsj0, jax_reads_natively, cls, kw):
    """MixIT's mixtures of mixtures and AudioSlient's prepended silence or
    noise, drawn per (seed, epoch, item), are the JAX package's."""
    kw = dict(kw, sample_rate=SR, segment=0.25, normalize_audio=True, seed=2)
    ours, theirs = getattr(datas, cls)(str(wsj0 / "tr"), **kw), getattr(jdatas, cls)(str(wsj0 / "tr"), **kw)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        same_items(ours, theirs)


def test_av_speech_items_match_jax(tmp_path, jax_reads_natively):
    """The audio-visual dataset's audio and mouth streams in test mode (the
    val pipeline: gray, center crop, normalised) are the JAX package's."""
    rng = np.random.default_rng(3)
    infos = {c: [] for c in ("mix", "s1", "s2")}
    for i in range(2):
        s = (0.1 * rng.standard_normal((2, 2000))).astype(np.float32)
        for c, wav in zip(infos, (s.sum(0), *s)):
            path = str(tmp_path / f"{c}{i}.wav")
            audio_io.write_wav(path, wav, SR)
            if c == "mix":
                infos[c].append([path, 2000])
            else:
                npz = str(tmp_path / f"{c}{i}.npz")
                np.savez(npz, data=rng.integers(0, 255, (6, 96, 96, 3)).astype(np.uint8))
                infos[c].append([path, npz, 2000])
    for c, lst in infos.items():
        (tmp_path / f"{c}.json").write_text(json.dumps(lst))
    kw = dict(sample_rate=SR, segment=None)
    ours, theirs = datas.AVSpeechDataset(str(tmp_path), **kw), jdatas.AVSpeechDataset(str(tmp_path), **kw)
    same_items(ours, theirs)
    assert ours[0][2].shape == (2, 6, 88, 88)


def test_online_mixing_matches_jax():
    """The same numpy generator gives the JAX package's remix: each slot
    permuted over the batch and energy-matched, the mixture their sum."""
    rng = np.random.default_rng(0)
    targets = rng.standard_normal((5, 3, 400)).astype(np.float32)
    mix = targets.sum(1)
    got = augment.online_mixing_collate(mix, targets, np.random.default_rng(9))
    want = jaugment.online_mixing_collate(mix, targets, np.random.default_rng(9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose((got[1] ** 2).sum(-1), (targets ** 2).sum(-1), rtol=1e-4)


@pytest.mark.parametrize("frames_shape", [(4, 100, 96, 3), (4, 92, 90)])
def test_video_pipelines_match_jax(frames_shape):
    """Every pipeline (train with seeded crops and flips; val; test) on RGB
    and gray frames gives the JAX package's frames."""
    frames = np.random.default_rng(1).integers(0, 255, frames_shape).astype(np.uint8)
    ours, theirs = transform.get_preprocessing_pipelines(), jtransform.get_preprocessing_pipelines()
    for stage in ("val", "test"):
        np.testing.assert_array_equal(ours[stage](frames), theirs[stage](frames))
    for seed in range(4):
        mods = []
        for mod in (transform, jtransform):
            mods.append(mod.Compose([mod.RgbToGray(), mod.Normalize(0.0, 255.0),
                                     mod.RandomCrop((88, 88), rng=np.random.default_rng(seed)),
                                     mod.HorizontalFlip(0.5, rng=np.random.default_rng(seed + 10)),
                                     mod.Normalize(0.421, 0.165)]))
        got, want = mods[0](frames), mods[1](frames)
        assert got.shape == (4, 88, 88)
        np.testing.assert_array_equal(got, want)
    assert [type(t).__name__ for t in ours["train"].transforms] == [
        type(t).__name__ for t in theirs["train"].transforms]


@pytest.mark.parametrize("segment", [None, 0.2])
def test_sb_dataset_matches_jax(tmp_path, jax_reads_natively, segment):
    """The SpeechBrain CSV contract, with and without seeded crops."""
    rng = np.random.default_rng(2)
    rows = []
    for i in range(3):
        row = {"id": f"utt{i}", "duration": "0.3"}
        for c in ("mix", "s1", "s2"):
            path = str(tmp_path / f"{c}{i}.wav")
            audio_io.write_wav(path, (0.1 * rng.standard_normal(2400 + 40 * i)).astype(np.float32), SR)
            row[f"{c}_wav"] = path
        rows.append(row)
    path = str(tmp_path / "set.csv")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    kw = dict(n_src=2, sample_rate=SR, segment=segment, seed=5)
    same_items(sbdataset.SBAudioDataset(path, **kw), jsb.SBAudioDataset(path, **kw))


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    """A PCM16 file and a PCM32 one with three channels."""
    import wave

    root = tmp_path_factory.mktemp("wavs")
    x = (0.4 * np.sin(np.linspace(0, 50, 4000))).astype(np.float32)
    pcm16 = str(root / "a.wav")
    audio_io.write_wav(pcm16, x, SR)
    pcm32 = str(root / "b.wav")
    frames = (np.random.default_rng(0).uniform(-0.9, 0.9, (4000, 3)) * 2**31).astype("<i4")
    with wave.open(pcm32, "wb") as w:
        w.setnchannels(3)
        w.setsampwidth(4)
        w.setframerate(SR)
        w.writeframes(frames.tobytes())
    return pcm16, pcm32


@pytest.mark.parametrize("start,stop", [(0, None), (123, 579), (3990, 4100), (500, 400), (0, 1)])
def test_native_reader_matches_wave_and_jax(wav_files, jax_reads_natively, start, stop):
    """``read_wav`` through the native reader equals the ``wave`` reader
    and the JAX package's ``native.read_window``, windows past the end and
    empty ones included; the batch read equals the windows."""
    assert native.available()
    for path in wav_files:
        count = -1 if stop is None else max(stop - start, 0)
        got = audio_io.read_wav(path, start, stop)
        np.testing.assert_array_equal(got, audio_io._read_wave_module(path, start, stop))
        np.testing.assert_array_equal(got, jnative.read_window(path, start, count))
        np.testing.assert_array_equal(native.read_window(path, start, count), got)
    path = wav_files[0]
    starts = [0, 10, 3950]
    out = native.read_batch([path] * 3, starts, 100, n_threads=2)
    np.testing.assert_array_equal(out, jnative.read_batch([path] * 3, starts, 100, n_threads=2))
    np.testing.assert_array_equal(out[1], audio_io.read_wav(path, 10, 110))
    assert not out[2, 50:].any()  # zero-filled past the end
    assert native.num_frames(path) == jnative.num_frames(path) == 4000


def test_native_build_has_no_race(tmp_path):
    """Six processes, each asking from eight threads at once, build the
    library into one empty directory together: each loads it, one file is
    built, and no partial file or work directory is left."""
    code = ("import sys, threading, pathlib;"
            "from audio_only_speech_separation_tpu_torch.data import native;"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1]);"
            "got = [];"
            "ts = [threading.Thread(target=lambda: got.append(native.get_lib())) for _ in range(8)];"
            "[t.start() for t in ts]; [t.join(120) for t in ts];"
            "assert len(got) == 8 and len({id(g) for g in got}) == 1 and got[0] is not None;"
            "print(native.library_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(6)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), outs
    assert {o.strip() for o in outs} == {native.library_path().name}
    assert sorted(os.listdir(tmp_path)) == sorted([native.library_path().name, "lock"])


def test_nothing_is_built_while_the_data_layer_imports(tmp_path):
    """Importing every module of the port's data layer builds nothing."""
    code = ("import sys, pathlib, pkgutil, importlib;"
            "import audio_only_speech_separation_tpu_torch.data as d;"
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages(d.__path__, d.__name__ + '.')];"
            "from audio_only_speech_separation_tpu_torch.data import native;"
            "assert native._lib is None and not native._tried; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "ok", res.stderr


@pytest.fixture
def untried(monkeypatch):
    """``native`` as before its first ``get_lib()`` (restored afterwards)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def test_no_compiler_is_looked_for_once(untried, monkeypatch, wav_files):
    """Without a compiler the first ``get_lib()`` searches for one, later
    calls (every ``read_wav``) do not, and reads go through ``wave``."""
    looked = []
    monkeypatch.setattr(native, "_compiler", lambda: looked.append(1))
    for _ in range(3):
        assert native.get_lib() is None and not native.available()
        np.testing.assert_array_equal(audio_io.read_wav(wav_files[0], 5, 50),
                                      audio_io._read_wave_module(wav_files[0], 5, 50))
    assert looked == [1]
    with pytest.raises(RuntimeError, match="no native wav reader"):
        native.read_window(wav_files[0])


def test_a_failed_build_raises_once_and_is_not_retried(untried, monkeypatch, wav_files):
    """A build that fails raises its error at the first call; later calls
    build nothing and read through ``wave``."""
    builds = []

    def failing_build(cxx):
        builds.append(cxx)
        raise RuntimeError("g++ failed (1)")

    monkeypatch.setattr(native, "_compiler", lambda: "g++")
    monkeypatch.setattr(native, "build", failing_build)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    for _ in range(3):
        assert not native.available()
        np.testing.assert_array_equal(audio_io.read_wav(wav_files[0]),
                                      audio_io._read_wave_module(wav_files[0], 0, None))
    assert builds == ["g++"]

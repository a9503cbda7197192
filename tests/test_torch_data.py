"""Training data, checkpoints and the trainer of the PyTorch port (CPU).

Held to the JAX package where it has a counterpart: the converters'
encoders, the metrics, the generators (byte-equal records), the record
reader and the loader (the same batches from one seed, images equal to
PIL's bicubic resize).  Then the port's torch-native checkpoints, its
``Trainer`` (logs, checkpoints, resume, the bridge into ``engines.CRNN``)
and the trainer's command line, at a tiny width.
"""
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lightly_ocr_tpu.data import generator as jgen
from lightly_ocr_tpu.data.loader import DataLoader as JDataLoader
from lightly_ocr_tpu.data.records import RecordDataset as JRecordDataset
from lightly_ocr_tpu.text.converters import build_converter as jbuild_converter
from lightly_ocr_tpu.utils import metrics as jmetrics
from lightly_ocr_tpu_torch.config import Config, load_config
from lightly_ocr_tpu_torch.data import generator
from lightly_ocr_tpu_torch.data.loader import DataLoader, align_collate, resize_bicubic_uint8
from lightly_ocr_tpu_torch.data.records import RecordDataset, RecordWriter, encode_png, open_dataset
from lightly_ocr_tpu_torch.engines import CRNN
from lightly_ocr_tpu_torch.text.converters import build_converter
from lightly_ocr_tpu_torch.train.train_step import init_train_state, make_train_step
from lightly_ocr_tpu_torch.train.trainer import Trainer, build_loaders, main
from lightly_ocr_tpu_torch.utils import checkpoint as ckpt
from lightly_ocr_tpu_torch.utils import metrics

ROOT = Path(__file__).resolve().parents[1]
CHARS = "abcdefghij"
TINY = dict(output_channel=32, hidden_size=16, batch_max_len=8, character=CHARS, num_fiducial=8,
            batch_size=8, adam=True, lr=1e-3, workers=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist several
    test processes share the machine's cores, and torch's default of a
    thread a core oversubscribes them many times over (this module's tiny
    steps then take minutes, not seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def words(tmp_path_factory):
    """JAX-written word records (PIL renders): 48 to train, 16 to validate."""
    d = tmp_path_factory.mktemp("words")
    train, val = str(d / "train.lor"), str(d / "val.lor")
    labels = jgen.synthesize_words(train, n=48, charset=CHARS, max_len=6, seed=1)
    jgen.synthesize_words(val, n=16, charset=CHARS, max_len=6, seed=2)
    return {"train": train, "val": val, "labels": labels, "dir": d}


# -- converters, metrics, generators ---------------------------------------

@pytest.mark.parametrize("head", ["CTC", "Attention"])
def test_encoders_match_jax(head):
    texts = ["abc", "", "jjih", "a" * 8]
    conv, jconv = build_converter(head, CHARS), jbuild_converter(head, CHARS)
    for got, ref in zip(conv.encode(texts, 8), jconv.encode(texts, 8)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype == np.int32
    if head == "CTC":
        for got, ref in zip(conv.encode_padded(texts, 6), jconv.encode_padded(texts, 6)):
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="not in the charset"):
        conv.encode(["abz"], 8)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    pairs = [("".join(rng.choice(list("abcd"), int(rng.integers(0, 7)))),
              "".join(rng.choice(list("abcd"), int(rng.integers(0, 7))))) for _ in range(40)]
    for a, b in pairs:
        assert metrics.edit_distance(a, b) == jmetrics.edit_distance(a, b)
    preds, labels = zip(*pairs)
    assert metrics.exact_match_accuracy(list(preds), list(labels)) == \
        jmetrics.exact_match_accuracy(list(preds), list(labels))
    assert metrics.normalized_edit_distance(list(preds), list(labels)) == \
        jmetrics.normalized_edit_distance(list(preds), list(labels))
    avg = metrics.Averager()
    avg.add(np.asarray([1.0, 2.0]))
    avg.add(3.0)
    assert avg.val() == 2.0


def test_generators_write_the_jax_records(tmp_path, words):
    """Same seeds, byte-equal files: clean words, noisy receipt-vocabulary
    words, and word crops cut from composed receipts."""
    for fn, kw in ((generator.synthesize_words, dict(n=12, charset=CHARS, seed=1, vocab_frac=0.5,
                                                     noise=9.0)),
                   (generator.synthesize_receipt_crops, dict(n=6, height=96, width=128, seed=3))):
        got, ref = tmp_path / f"{fn.__name__}.lor", tmp_path / f"{fn.__name__}_jax.lor"
        assert fn(str(got), **kw) == getattr(jgen, fn.__name__)(str(ref), **kw)
        assert got.read_bytes() == ref.read_bytes()
    pngs = tmp_path / "mj"
    (pngs / "sub").mkdir(parents=True)
    ds = RecordDataset(words["train"])
    for i in range(3):
        (pngs / "sub" / f"{i}_word{i}_0.png").write_bytes(bytes(ds.raw(i)[1]))
    ds.close()
    (pngs / "sub" / "9_bad_0.png").write_bytes(b"not an image")
    (pngs / "annotation_train.txt").write_text(
        "".join(f"./sub/{i}_word{i}_0.png {i}\n" for i in range(3)) + "./sub/9_bad_0.png 9\n")
    assert generator.anno2list(str(pngs)) == jgen.anno2list(str(pngs))
    assert generator.convert_mjsynth(str(pngs), str(tmp_path / "mj.lor"), log_dir=str(tmp_path)) == 3
    assert (tmp_path / "error_image.txt").read_text().strip().endswith("9_bad_0.png")
    assert [RecordDataset(str(tmp_path / "mj.lor")).raw(i)[0] for i in range(3)] == \
        ["word0", "word1", "word2"]


# -- records and the loader ------------------------------------------------

def test_records_read_as_the_jax_reader(words, tmp_path):
    """Filtering (length, charset after lowercasing), label cleaning and the
    decoded images equal the JAX reader's (PIL) ones; concatenation and
    the ways to name a root."""
    path = str(tmp_path / "mixed.lor")
    ds0 = RecordDataset(words["train"])
    with RecordWriter(path) as w:
        for label in ("ok", "TOOLONGLABEL", "Abc", "a-b", "x!"):
            w.add(label, bytes(ds0.raw(0)[1]))
    kw = dict(character=CHARS, batch_max_len=6)
    got, ref = RecordDataset(path, **kw), JRecordDataset(path, **kw)
    assert len(got) == len(ref) == 1  # "Abc" passes the lowercase check and is cleaned to "bc"
    assert got[0][1] == ref[0][1] == "bc"
    for i in range(len(ref)):
        (img, label), (jimg, jlabel) = got[i], ref[i]
        assert label == jlabel
        np.testing.assert_array_equal(img, np.asarray(jimg))
    a, b = RecordDataset(words["train"]), JRecordDataset(words["train"])
    for i in (0, 7, 47):
        np.testing.assert_array_equal(a[i][0], np.asarray(b[i][0]))
        assert a[i][1] == b[i][1] == words["labels"][i]
    rgb = RecordDataset(words["train"], rgb=True)[5][0]
    assert rgb.shape[2] == 3 and rgb.dtype == np.uint8
    both = open_dataset(words["train"] + "," + words["val"])
    assert len(both) == 64 and both[50][1] == RecordDataset(words["val"])[2][1]
    os.makedirs(tmp_path / "root")
    os.link(words["val"], tmp_path / "root" / "data.lor")
    assert len(open_dataset(str(tmp_path / "root"))) == 16
    with pytest.raises(FileNotFoundError):
        open_dataset(str(tmp_path / "nothing"))


def test_records_decode_without_pil(words, tmp_path, monkeypatch):
    """Without PIL (the card's installation), PNG records decode in numpy
    to the same pixels; a JPEG record raises, it is never skipped."""
    from PIL import Image

    pil = RecordDataset(words["train"])
    ref = [pil[i][0] for i in range(6)]
    buf = io.BytesIO()
    Image.fromarray(ref[0]).save(buf, format="JPEG")
    jpeg = str(tmp_path / "jpeg.lor")
    with RecordWriter(jpeg) as w:
        w.add("abc", buf.getvalue())
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = RecordDataset(words["train"])
    for i in range(6):
        np.testing.assert_array_equal(ds[i][0], ref[i])
    with pytest.raises(RuntimeError, match="not a PNG"):
        RecordDataset(jpeg)[0]


@pytest.mark.parametrize("shape", [(9, 13), (9, 13, 3), (1, 1, 3), (31, 2)], ids=["gray", "rgb", "pixel", "narrow"])
def test_encode_png_decodes_under_pil_for_every_filter(shape):
    """``encode_png`` (no PIL) writes PNG that PIL decodes to the same
    array, for each row filter (None, Sub, Up, Average, Paeth), gray and
    RGB; the numpy decoder reads it too."""
    from PIL import Image

    from lightly_ocr_tpu_torch.serving.upload import decode_png

    img = np.random.default_rng(len(shape)).integers(0, 256, shape).astype(np.uint8)
    img.flat[0], img.flat[-1] = 0, 255
    for filt in range(5):
        data = encode_png(img, filt)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img, err_msg=str(filt))
        rgb = decode_png(data)
        np.testing.assert_array_equal(rgb if img.ndim == 3 else rgb[..., 0], img, err_msg=str(filt))


def test_resize_is_pils_bicubic():
    """The numpy resize equals PIL's BICUBIC resize on every pixel, up- and
    downscaling, gray and RGB, at 150 seeded sizes."""
    from PIL import Image

    rng = np.random.default_rng(11)
    for i in range(150):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 320))
        H, W = int(rng.integers(1, 48)), int(rng.integers(1, 160))
        shape = (h, w, 3) if i % 10 == 0 else (h, w)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        if i % 3 == 1:  # hard edges: the overshoot that uint8 clipping cuts
            img = np.where(img > 127, 255, 0).astype(np.uint8)
        ref = np.asarray(Image.fromarray(img).resize((W, H), Image.BICUBIC))
        np.testing.assert_array_equal(resize_bicubic_uint8(img, W, H), ref, err_msg=str((shape, H, W)))


@pytest.mark.parametrize("keep_ratio", [True, False])
def test_loader_batches_match_jax(words, keep_ratio):
    """One seed, the same batches as the JAX loader: labels equal, images
    within one uint8 level (2/255 after normalisation) on every pixel and
    equal on at least 99% (the resize is PIL's, so all are equal)."""
    kw = dict(batch_size=8, keep_ratio=keep_ratio, seed=5, workers=2)
    ours = list(DataLoader(RecordDataset(words["train"], character=CHARS), **kw))
    ref = list(JDataLoader(JRecordDataset(words["train"], character=CHARS), **kw))
    assert len(ours) == len(ref) == 6
    for (im, lab), (jim, jlab) in zip(ours, ref):
        assert lab == jlab
        assert im.shape == jim.shape == (8, 32, 100, 1) and im.dtype == np.float32
        assert np.abs(im - jim).max() <= 2 / 255 + 1e-6
        assert np.mean(im == jim) >= 0.99


def test_loader_decodes_only_its_rows(words):
    """``rows``: a process's share of each global batch, equal to the whole
    batch's rows, with only those samples read from the records."""
    kw = dict(batch_size=8, keep_ratio=True, seed=5, workers=2)
    full = list(DataLoader(RecordDataset(words["train"], character=CHARS), **kw))
    ds = RecordDataset(words["train"], character=CHARS)
    read = []
    get = ds.__getitem__

    class Counting:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            read.append(i)
            return get(i)

    part = list(DataLoader(Counting(), **kw, rows=slice(4, 8)))
    assert len(part) == len(full) and len(read) == 4 * len(full)
    for (im, lab), (fim, flab) in zip(part, full):
        assert lab == flab[4:8]
        np.testing.assert_array_equal(im, fim[4:8])


def test_loader_raises_a_worker_error(tmp_path):
    path = str(tmp_path / "bad.lor")
    with RecordWriter(path) as w:
        for _ in range(4):
            w.add("ab", b"\x89PNG\r\n\x1a\n broken")
    with pytest.raises(Exception):
        list(DataLoader(RecordDataset(path), batch_size=2, workers=2))


def test_align_collate_pads_by_replicating_the_last_column():
    img = np.tile(np.arange(10, dtype=np.uint8) * 20, (16, 1))  # 16 x 10, ramp
    out, labels = align_collate([(img, "x")], height=32, width=100, keep_ratio=True)
    assert labels == ["x"] and out.shape == (1, 32, 100, 1)
    assert (out[0, :, 20:] == out[0, :, 19:20]).all()  # resized to 20 wide, then replicated


# -- checkpoints -------------------------------------------------------------

def _tiny_state(seed=0, **kw):
    cfg = Config(**{**TINY, "prediction": "CTC", "transform": "None", **kw})
    model, state = init_train_state(cfg, seed, "cpu")
    return cfg, model, state


def _step(cfg, model, state, seed=0):
    conv = build_converter("CTC", CHARS)
    labels, lengths = conv.encode_padded(["abc", "de", "f", "ghij"], cfg.batch_max_len)
    batch = {"images": torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 32, 100, 1)).astype(np.float32)),
        "labels": torch.from_numpy(labels).long(), "lengths": torch.from_numpy(lengths).long()}
    return make_train_step(model, cfg)(state, batch)


def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    cfg, model, state = _tiny_state()
    for i in range(7):
        _step(cfg, model, state, i)
        ckpt.save_checkpoint(str(tmp_path), state.step, state)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5", "6", "7"]
    assert ckpt.latest_step(str(tmp_path)) == 7
    _, model2, state2 = _tiny_state(seed=9)
    state2, step = ckpt.restore_checkpoint(str(tmp_path), state2)
    assert step == state2.step == 7
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), state2.optimizer.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, slots in a["state"].items():
        for name, v in slots.items():
            assert torch.equal(b["state"][i][name], v)
    # a step from the restored state equals a step from the original
    _, m1 = _step(cfg, model, state, 99)
    _, m2 = _step(cfg, model2, state2, 99)
    assert m1["loss"].item() == m2["loss"].item()
    assert "num_batches_tracked" not in "".join(ckpt.load_variables_for_inference(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), state2)


def test_checkpoint_same_step_is_replaced_safely(tmp_path, monkeypatch):
    """A step saved again replaces the old one; a save that dies in the
    middle leaves the old step whole and no debris."""
    cfg, model, state = _tiny_state()
    ckpt.save_checkpoint(str(tmp_path), 5, state)
    first = ckpt.load_variables_for_inference(str(tmp_path), 5)
    _step(cfg, model, state)
    ckpt.save_checkpoint(str(tmp_path), 5, state)
    second = ckpt.load_variables_for_inference(str(tmp_path), 5)
    assert any(not torch.equal(first[k], second[k]) for k in first)
    assert all(torch.equal(second[k], v) for k, v in model.state_dict().items())

    real_save = torch.save

    def dying_save(obj, path):
        real_save({"partial": 1}, path)
        raise KeyboardInterrupt("killed in the middle of the save")

    _step(cfg, model, state)
    monkeypatch.setattr(ckpt.torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(str(tmp_path), 5, state)
    monkeypatch.setattr(ckpt.torch, "save", real_save)
    assert sorted(os.listdir(tmp_path)) == ["5"]
    kept = ckpt.load_variables_for_inference(str(tmp_path), 5)
    assert all(torch.equal(kept[k], second[k]) for k in second)


def test_record_best(tmp_path):
    d = str(tmp_path)
    assert ckpt.record_best(d, 10, 50.0)
    assert not ckpt.record_best(d, 20, 40.0)
    assert not ckpt.record_best(d, 25, 50.0)
    assert ckpt.record_best(d, 30, 60.0)
    assert json.loads((tmp_path / "best.json").read_text()) == {"step": 30, "metric": 60.0}


# -- the trainer -------------------------------------------------------------

def test_trainer_fits_logs_checkpoints_resumes_and_serves(words, tmp_path):
    """12 steps of the TPS + attention model on the CPU with an eval and a
    checkpoint every 6; resume from the checkpoints to step 14; the best
    checkpoint read by ``engines.CRNN`` with a strict load."""
    log_dir = str(tmp_path / "logs")
    cfg = Config(**{**TINY, "prediction": "Attention", "transform": "TPS"}, train_root=words["train"],
                 val_root=words["val"], num_iters=12, val_interval=6, save_interval=6,
                 log_dir=log_dir, max_iter=1)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.fit(*build_loaders(cfg))
    assert state.step == 12
    logs = sorted(os.listdir(log_dir))
    assert logs == ["best.json", "best_acc", "checkpoints", "log_config.txt", "log_dataset.txt",
                    "log_model.txt", "log_train.txt"]
    text = (tmp_path / "logs" / "log_train.txt").read_text()
    assert "[6/12] train_loss:" in text and "[12/12] train_loss:" in text
    assert "ground truth         | prediction           | confidence | T&F" in text
    assert sorted(os.listdir(os.path.join(log_dir, "checkpoints"))) == ["12", "6"]
    assert "structure:TPS-ResNet-biLSTM-Attention" in (tmp_path / "logs" / "log_model.txt").read_text()

    resumed = Trainer(cfg.replace(saved_model_path=os.path.join(log_dir, "checkpoints"), num_iters=14),
                      device="cpu")
    state2 = resumed.fit(*build_loaders(cfg))
    assert state2.step == 14

    sd = ckpt.load_variables_for_inference(os.path.join(log_dir, "best_acc"))
    engine = CRNN(cfg, state_dict=sd, device="cpu")
    crops, _ = align_collate([RecordDataset(words["train"], character=CHARS)[i] for i in range(3)],
                             keep_ratio=True)
    texts, conf = engine.recognize_crops(crops)
    assert len(texts) == 3 and conf.shape == (3,)


def test_trainer_refuses_int8_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(Config(**TINY, quant_int8=True), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(Config(**TINY))


def test_trainer_cli(words, tmp_path, monkeypatch):
    """``python -m lightly_ocr_tpu_torch.train.trainer --device cpu`` trains
    from a JSON config (read without pyyaml, as on the card); without
    ``--device`` it wants the card; ``--model CRAFT`` goes to the detector's
    trainer (its ``--data-parallel`` on the CPU, which has one device, trains
    in this process), and a CRAFT flag is refused without it; a model axis
    (``mesh_model`` 2) that the one CPU device cannot hold raises the JAX
    package's ``make_mesh`` error."""
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps({**TINY, "prediction": "CTC", "transform": "None",
                                    "val_interval": 2, "save_interval": 2, "max_iter": 1,
                                    "log_dir": str(tmp_path / "logs")}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['yaml'] = None; "
         "from lightly_ocr_tpu_torch.train.trainer import main; raise SystemExit(main())",
         "--config", str(cfg_path), "--train-root", words["train"], "--val-root", words["val"],
         "--num-iters", "2", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "training on device cpu" in out.stdout and "[2/2] train_loss" in out.stdout
    assert os.listdir(tmp_path / "logs" / "checkpoints") == ["2"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", str(cfg_path), "--train-root", words["train"], "--val-root", words["val"]])
    assert main(["--model", "CRAFT", "--data-parallel", "--device", "cpu", "--num-steps", "1",
                 "--batch", "1", "--height", "32", "--width", "32", "--log-every", "0"]) == 0
    model_axis = tmp_path / "model_axis.json"
    model_axis.write_text(json.dumps({**TINY, "mesh_model": 2}))
    with pytest.raises(ValueError, match="model axis 2 must divide device count 1"):
        main(["--config", str(model_axis), "--device", "cpu"])
    with pytest.raises(SystemExit):
        main(["--config", str(cfg_path), "--num-steps", "2", "--device", "cpu"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert load_config(str(cfg_path)).output_channel == 32
    (tmp_path / "bad.yml").write_text("output_channel: 32\n")
    with pytest.raises(ValueError, match="not JSON"):
        load_config(str(tmp_path / "bad.yml"))

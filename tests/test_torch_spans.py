"""The port's own spans and counters (``utils/profiling.py``): where the
serving and training paths open them, on which threads, that they record
nothing without a profiler, the ``InferenceWorker``'s counters, and the
benchmark readers that turn them into per-layer metrics."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from lightly_ocr_tpu_torch.config import Config
from lightly_ocr_tpu_torch.data.loader import DataLoader
from lightly_ocr_tpu_torch.data.records import RecordWriter, encode_png, open_dataset
from lightly_ocr_tpu_torch.models.crnn import CRNNet
from lightly_ocr_tpu_torch.models.layers import init_module
from lightly_ocr_tpu_torch.models.vgg_unet import VGG_UNet
from lightly_ocr_tpu_torch.serving.batch import BatchedOCR
from lightly_ocr_tpu_torch.serving.server import InferenceWorker
from lightly_ocr_tpu_torch.train.trainer import Trainer
from lightly_ocr_tpu_torch.utils import profiling
from lightly_ocr_tpu_torch.utils.profiling import SYNC, TRACE_FILE, count, counter_values, trace

TINY = dict(prediction="Attention", transform="TPS", sequence="biLSTM", output_channel=32,
            hidden_size=16, num_fiducial=8, max_boxes=4, character="abcdefghij", batch_max_len=8)
SERVING = ("ocr.dispatch", "ocr.prepare", "ocr.detector", "ocr.detector.prefix", "ocr.boxes",
           "ocr.recognize", "crnn.features", "crnn.prediction", "ocr.decode", SYNC)
PROGRAM = ("ocr.", "crnn.", "loader.", "train.")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ocr():
    """A bf16 ``tail,s2d`` BatchedOCR of seeded weights at a tiny width (the
    CPU takes the kernels' plain versions), and two small receipts."""
    cfg = Config(**TINY, canvas_size=128)
    g = torch.Generator().manual_seed(0)
    det = init_module(VGG_UNet(), g).state_dict()
    rec = init_module(CRNNet(cfg), g).state_dict()
    rng = np.random.default_rng(0)
    images = [(rng.random((48, 64, 3)) * 255).astype(np.uint8) for _ in range(2)]
    return BatchedOCR(cfg, det, rec, boxes_per_image=4, device="cpu"), images


def events(d) -> list:
    with open(os.path.join(d, TRACE_FILE)) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def spans(evs, name) -> list:
    return [e for e in evs if e["name"] == name and e.get("cat") == "user_annotation"]


def inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def within(evs, child, parent) -> list:
    """The spans ``child`` inside a span ``parent``."""
    return [c for c in spans(evs, child) if any(inside(c, p) for p in spans(evs, parent))]


def test_a_dispatch_opens_each_serving_span_nested(ocr, tmp_path):
    model, images = ocr
    model.run_images(images)  # builds every shape outside the trace
    with trace(str(tmp_path), cuda=False, all_threads=True):
        model.run_images(images)
    evs = events(tmp_path)
    for name in SERVING:
        assert spans(evs, name), name
    assert len(spans(evs, "ocr.dispatch")) == 1  # one canvas bucket, one dispatch
    for child, parent in (("ocr.prepare", "ocr.dispatch"), ("ocr.detector", "ocr.dispatch"),
                          ("ocr.detector.prefix", "ocr.detector"), ("ocr.boxes", "ocr.dispatch"),
                          ("ocr.recognize", "ocr.dispatch"), ("crnn.features", "ocr.recognize"),
                          ("crnn.prediction", "ocr.recognize"), ("ocr.decode", "ocr.dispatch")):
        assert len(within(evs, child, parent)) == len(spans(evs, child)) == 1, (child, parent)
    # every sync inside a stage: none in prep (its uploads wait for
    # nothing), the twelve masked indexings and the dummy rect in boxes,
    # four copies in decode
    syncs = {stage: len(within(evs, SYNC, stage)) for stage in ("ocr.prepare", "ocr.boxes", "ocr.decode")}
    assert syncs == {"ocr.prepare": 0, "ocr.boxes": 13, "ocr.decode": 4}
    assert sum(syncs.values()) == len(spans(evs, SYNC))


def _records(path, n: int, rng) -> None:
    with RecordWriter(path) as w:
        for i in range(n):
            w.add("abcdefghij"[i % 10] * (1 + i % 4),
                  encode_png((rng.random((12, 30)) * 255).astype(np.uint8)))


@pytest.fixture
def fitted(tmp_path):
    """(trainer, loader) of a tiny CRNN over eight records, two rows a
    batch, the loader on two threads."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "w.lor")
    _records(path, 8, rng)
    cfg = Config(**TINY, batch_size=2, num_iters=2, val_interval=1 << 30, save_interval=1 << 30,
                 log_dir=str(tmp_path / "logs"), workers=2, height=32, width=64)
    ds = open_dataset(path, character=cfg.character, batch_max_len=cfg.batch_max_len)
    loader = DataLoader(ds, batch_size=2, height=32, width=64, seed=0, workers=2)
    yield Trainer(cfg, device=torch.device("cpu")), loader
    ds.close()


def test_a_fit_opens_loader_spans_on_its_threads_and_step_phases(fitted, tmp_path):
    trainer, loader = fitted
    d = str(tmp_path / "trace")
    with trace(d, cuda=False, all_threads=True):
        trainer.fit(loader, None)
    evs = events(d)
    main = threading.get_ident()
    batches = spans(evs, "loader.batch")
    assert batches and {e["tid"] for e in batches}.isdisjoint({main, spans(evs, "train.step")[0]["tid"]})
    assert len(within(evs, "loader.decode", "loader.batch")) == len(batches)
    assert len(within(evs, "loader.collate", "loader.batch")) == len(batches)
    steps = spans(evs, "train.step")
    assert len(steps) == 2 and len(spans(evs, "train.sync")) == 2
    assert len(spans(evs, "loader.wait")) >= 2
    for phase in ("train.forward", "train.backward", "train.optimizer", "crnn.features"):
        assert len(within(evs, phase, "train.step")) == 2, phase
    for s in spans(evs, "train.sync") + spans(evs, "loader.wait"):
        assert not any(inside(s, p) for p in steps)


def test_no_span_is_recorded_without_a_profiler(ocr, fitted, monkeypatch):
    """With no profiler running, the program opens no ``record_function``
    (PyTorch's own optimizer spans are not the program's)."""
    opened = []
    real = torch.autograd.profiler.record_function

    def recording(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", recording)
    model, images = ocr
    model.run_images(images)
    trainer, loader = fitted
    trainer.fit(loader, None)
    assert trainer.state.step == 2
    assert opened  # the patch sees PyTorch's own optimizer spans
    assert [n for n in opened if n.startswith(PROGRAM) or n in ("seam_tail", "conv12_pool")] == []
    assert all(n.startswith("Optimizer.") for n in opened), opened


def test_annotate_records_only_under_a_profiler(tmp_path):
    assert profiling.annotate("x") is profiling.annotate("y")  # one shared no-op
    with trace(str(tmp_path), cuda=False):
        with profiling.annotate("under"):
            pass
    assert spans(events(tmp_path), "under")


def test_worker_counts_one_wait_a_request_and_one_size_a_batch():
    """A stub ``predict_fn`` holds its first batch until every request is
    queued: one wait a request, one size a batch, each stamped inside the
    test."""
    held, go = threading.Event(), threading.Event()
    sizes = []

    def predict(images):
        held.set()
        go.wait(5)
        sizes.append(len(images))
        return images

    t0 = time.perf_counter()
    w = InferenceWorker(predict, max_batch=4, max_queue=0)
    try:
        first = w.submit(0)
        assert held.wait(5)
        futures = [first] + [w.submit(i) for i in range(1, 10)]
        time.sleep(0.02)
        go.set()
        assert [f.result(5) for f in futures] == list(range(10))
    finally:
        w.close()
    waits = counter_values("worker.queue_wait_s", t0)
    assert len(waits) == 10 and all(v >= 0 for v in waits)
    assert max(waits) >= 0.02  # the requests queued behind the held batch
    assert counter_values("worker.batch_size", t0) == sizes and sizes[0] == 1 and sum(sizes) == 10


def test_counters_keep_their_newest_values_in_order():
    t0 = time.perf_counter()
    for v in range(profiling.COUNTER_LEN + 5):
        count("test.counter", v)
    got = counter_values("test.counter")
    assert len(got) == profiling.COUNTER_LEN and got[0] == 5 and got[-1] == profiling.COUNTER_LEN + 4
    assert counter_values("test.counter", until=t0) == [] and counter_values("no.such") == []


# ---------------------------------------------------------------------------
# the benchmark's readers of these spans and counters, on a hand-built trace


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _kernel(corr, launched, ts, dur, tid=1):
    """A launch on the host at ``launched`` and its kernel on the card."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launched, "dur": 1,
             "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "tid": 7,
             "args": {"correlation": corr}}]


def _serving_events() -> list:
    """Two dispatches 400 us apart, each: prep 60 us (two syncs, a copy of
    10 us), detector 40 (prefix kernel 4, trunk kernel 30), boxes 80 (two
    syncs of 20 and 10), recognize 15 (features kernel 8, prediction 6),
    decode 5 (one sync); a sync outside them, one on another thread."""
    evs = [_span("ocr_bench.window", 0, 1000)]
    for k, o in enumerate((0, 400)):
        c = 10 * k
        evs += [_span("ocr.dispatch", 100 + o, 300), _span("ocr.prepare", 100 + o, 60),
                _span("ocr.sync", 110 + o, 10), _span("ocr.sync", 130 + o, 5),
                _span("ocr.detector", 160 + o, 40), _span("ocr.detector.prefix", 165 + o, 10),
                _span("ocr.boxes", 200 + o, 80), _span("ocr.sync", 210 + o, 20),
                _span("ocr.sync", 240 + o, 10), _span("ocr.recognize", 280 + o, 15),
                _span("crnn.features", 281 + o, 5), _span("crnn.prediction", 287 + o, 7),
                _span("ocr.decode", 295 + o, 5), _span("ocr.sync", 296 + o, 2),
                _span("ocr.sync", 250 + o, 3, tid=2)]
        evs += (_kernel(c + 1, 166 + o, 170 + o, 4) + _kernel(c + 2, 180 + o, 180 + o, 30)
                + _kernel(c + 3, 282 + o, 285 + o, 8) + _kernel(c + 4, 288 + o, 293 + o, 6))
        evs.append(dict(_kernel(c + 5, 120 + o, 120 + o, 10)[1], cat="gpu_memcpy"))
        evs.append(_kernel(c + 5, 120 + o, 120 + o, 10)[0])
    return evs + [_span("ocr.sync", 950, 1)]


def _training_events() -> list:
    """Two steps 300 us apart, each: a wait of 40 us (the card busy for 10
    of it), a step of 200 (forward kernel 40, backward 50, optimizer 10),
    a sync of 5; two loader batches on another thread."""
    evs = [_span("ocr_bench.window", 0, 1000)]
    for k, o in enumerate((0, 300)):
        c = 10 * k
        evs += [_span("loader.wait", 10 + o, 40), _span("train.step", 50 + o, 200),
                _span("train.forward", 55 + o, 50), _span("train.backward", 110 + o, 70),
                _span("train.optimizer", 185 + o, 55), _span("train.sync", 250 + o, 5)]
        evs += (_kernel(c, 5 + o, 10 + o, 10) + _kernel(c + 1, 60 + o, 60 + o, 40)
                + _kernel(c + 2, 120 + o, 120 + o, 50, tid=3) + _kernel(c + 3, 190 + o, 190 + o, 10))
    for ts, decode, collate in ((400, 30, 70), (600, 20, 60)):
        evs += [_span("loader.batch", ts, decode + collate, tid=2), _span("loader.decode", ts, decode, tid=2),
                _span("loader.collate", ts + decode, collate, tid=2)]
    return evs


SERVE_READS = {"prepare_ms.serve": 0.06, "detector_device_ms.serve": 0.034, "prefix_ms.serve": 0.004,
               "boxes_self_ms.serve": 0.05, "boxes_sync_ms.serve": 0.03, "syncs_per_dispatch.serve": 5,
               "recognizer_device_ms.serve": 0.014, "recognize_host_ms.serve": 0.015,
               "features_ms.serve": 0.008, "prediction_ms.serve": 0.006, "decode_ms.serve": 0.005,
               "idle_in_prepare_ms.serve": 0.05}
TRAIN_READS = {"batch_wait_ms.train": 0.04, "loader_batch_ms.train": 0.09, "loader_decode_ms.train": 0.025,
               "loader_collate_ms.train": 0.065, "train_step_device_ms.train": 0.1,
               "train_step_kernels.train": 3, "forward_ms.train": 0.04, "backward_ms.train": 0.05,
               "optimizer_ms.train": 0.01, "loss_sync_ms.train": 0.005, "idle_in_wait_ms.train": 0.03,
               "idle_in_step_ms.train": 0.1}
COUNTER_READS = {"queue_wait_ms.serve": 200.0, "batch_size.serve": 5.0}


def _reader(name):
    from ocr_bench import harness

    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "test_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,want", sorted({**SERVE_READS, **TRAIN_READS}.items()))
def test_reader_on_a_built_trace(name, want):
    from ocr_bench.trace import Trace

    evs = _serving_events() if name in SERVE_READS else _training_events()
    assert _reader(name).read({"trace": Trace(evs), "traced": (0.0, 1.0)}) == pytest.approx(want)


def test_counter_readers_take_the_traced_part():
    from ocr_bench.trace import Trace

    count("worker.queue_wait_s", 9.0)
    count("worker.batch_size", 16)
    a = time.perf_counter()
    for wait, size in ((0.1, 4), (0.3, 6)):
        count("worker.queue_wait_s", wait)
        count("worker.batch_size", size)
    rec = {"trace": Trace([_span("ocr_bench.window", 0, 10)]), "traced": (a, time.perf_counter())}
    count("worker.queue_wait_s", 9.0)
    for name, want in COUNTER_READS.items():
        assert _reader(name).read(rec) == pytest.approx(want), name


def test_readers_find_nothing_in_a_program_without_the_spans():
    """The parent program has no such spans: every reader returns None."""
    from ocr_bench.trace import Trace

    evs = [e for e in _serving_events() + _training_events()
           if e["cat"] != "user_annotation" or e["name"] == "ocr_bench.window"]
    rec = {"trace": Trace(evs), "traced": (0.0, 0.0)}
    for name in list(SERVE_READS) + list(TRAIN_READS) + list(COUNTER_READS):
        assert _reader(name).read(rec) is None, name

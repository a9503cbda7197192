"""The port's pipeline end to end on the committed demo checkpoints.

``save_models/demo_{craft,crnn}_bf16`` (orbax; a CTC recognizer with
``transform="None"``, ``scripts/train_demo.py``) are restored with the JAX
package once per module and exported to reference-format ``.pth`` files by
``export_torch_checkpoints.py``; the port's engines read those from
``cfg.pretrained``.  On the demo's synthetic receipts
(``synthesize_receipt``, 320x256) the port's ``get_text_detailed``,
``getText``, ``serveModel`` and CLI are held to the JAX pipeline in float32
on the CPU: mean box IoU at least 0.99 and equal texts (the end-to-end gate
of ``tests/test_e2e_parity.py``).
"""
import numpy as np
import pytest

from lightly_ocr_tpu.data.generator import synthesize_receipt
from lightly_ocr_tpu.engines import CRAFT as JCRAFT
from lightly_ocr_tpu.engines import CRNN as JCRNN
from lightly_ocr_tpu.pipeline import getText as jgetText
from lightly_ocr_tpu.pipeline import get_text_detailed as jget_text_detailed
from lightly_ocr_tpu.pipeline import prepModel as jprepModel
from lightly_ocr_tpu_torch import pipeline
from lightly_ocr_tpu_torch.config import Config

RH, RW = 320, 256  # the demo's receipt and training geometry


def rect_iou(a, b) -> float:
    r0, c0 = max(a[0], b[0]), max(a[1], b[1])
    r1, c1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0, r1 - r0) * max(0, c1 - c0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(union, 1e-9)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The demo config (``scripts/train_demo.py::_demo_cfg``'s serving
    fields), the JAX engines on the restored weights, and the ``.pth``
    directory that ``export_torch_checkpoints.py`` writes and the port
    reads."""
    import export_torch_checkpoints

    pth = tmp_path_factory.mktemp("pth")
    jcfg, variables = export_torch_checkpoints.export(str(pth))
    cfg = Config.from_dict({**jcfg.to_dict(), "pretrained": str(pth)})
    return {"cfg": cfg, "pth": pth,
            "jdet": JCRAFT(jcfg, variables=variables["CRAFT.pth"]),
            "jrec": JCRNN(jcfg, variables=variables["CRNN.pth"]),
            "port": pipeline.prepModel(cfg, device="cpu")}


def _receipts(n: int, seed: int = 23):
    """The first ``n`` receipts of ``scripts/train_demo.py``'s evaluation
    (rng 23); the tests share them, and so the JAX compiles."""
    rng = np.random.default_rng(seed)
    return [synthesize_receipt(rng, RH, RW) for _ in range(n)]


def test_demo_checkpoints_end_to_end_match_jax(demo):
    """Three demo receipts through ``get_text_detailed`` of both packages:
    the same words in reading order, equal texts, mean box IoU >= 0.99,
    confidences within 1e-4; and the trained models read real words."""
    det, rec = demo["port"]
    assert rec.cfg.prediction == "CTC" and rec.cfg.transform == "None"
    ious, read = [], 0
    receipts = _receipts(3)
    for image, words in receipts:
        want = jget_text_detailed(image, demo["jdet"], demo["jrec"])
        got = pipeline.get_text_detailed(image, det, rec)
        assert len(got) == len(want) >= 5
        assert [g["text"] for g in got] == [w["text"] for w in want]
        ious += [rect_iou(g["rect"], w["rect"]) for g, w in zip(got, want)]
        np.testing.assert_allclose([g["confidence"] for g in got],
                                   [w["confidence"] for w in want], rtol=0, atol=1e-4)
        read += len({w["text"] for w in words} & {g["text"] for g in got})
    assert np.mean(ious) >= 0.99
    assert read >= 0.8 * sum(len(words) for _, words in receipts)


@pytest.mark.slow
def test_demo_read_accuracy_equals_jax(demo):
    """``scripts/train_demo.py``'s end-to-end read accuracy (12 receipts,
    rng 23: a ground-truth word counts when the best-IoU prediction, IoU >=
    0.3, reads it exactly) is the same for the port as for the JAX
    package (``docs/DEMO_REPORT.md``: 0.942 on the TPU)."""
    det, rec = demo["port"]
    acc = {}
    for name, read in (("jax", lambda im: jget_text_detailed(im, demo["jdet"], demo["jrec"])),
                       ("port", lambda im: pipeline.get_text_detailed(im, det, rec))):
        got = total = 0
        for image, words in _receipts(12):
            items = read(image)
            total += len(words)
            for w in words:
                best = max(items, key=lambda it: rect_iou(w["rect"], it["rect"]), default=None)
                if best is not None and rect_iou(w["rect"], best["rect"]) >= 0.3:
                    got += best["text"] == w["text"]
        acc[name] = got / total
    print(f"demo read accuracy: {acc}")
    assert acc["port"] == acc["jax"]
    assert acc["port"] >= 0.9


def test_get_text_and_serve_model_match_jax(demo):
    """``getText`` ({confidence: text}) and ``serveModel.predict`` (texts
    above the threshold) on a demo receipt; ``serveModel`` builds its
    engines from the ``.pth`` files of ``cfg.pretrained``."""
    image, _ = _receipts(1)[0]
    want = jgetText(image, demo["jdet"], demo["jrec"])
    got = pipeline.getText(image, *demo["port"])
    assert len(got) == len(want) >= 5
    assert sorted(got.values()) == sorted(want.values())
    np.testing.assert_allclose(sorted(got), sorted(want), rtol=0, atol=1e-4)
    thresh = float(np.median(list(want)))
    model = pipeline.serveModel(config=demo["cfg"], thresh=thresh, device="cpu")
    assert model.predict(image) == [v for k, v in want.items() if k > thresh]
    assert [it["text"] for it in model.predict_detailed(image)] == model.predict(image)


def test_prep_model_validates(demo):
    """A pipeline other than CRAFT-CRNN is refused as the JAX ``prepModel``
    refuses it."""
    for prep in (jprepModel, pipeline.prepModel):
        bad = demo["cfg"].replace()
        object.__setattr__(bad, "pipeline", "YOLO-CRNN")
        with pytest.raises(AssertionError):
            prep(bad)


def test_main_reads_a_png_on_the_cpu(demo, tmp_path, capsys):
    """``python -m lightly_ocr_tpu_torch.pipeline --device cpu`` on a PNG
    written with PIL, with a YAML config naming the ``.pth`` directory:
    prints the texts the JAX pipeline reads above the threshold."""
    from PIL import Image
    import yaml

    image, _ = _receipts(1)[0]
    Image.fromarray(image).save(tmp_path / "receipt.png")
    (tmp_path / "config.yml").write_text(yaml.safe_dump(demo["cfg"].to_dict()))
    want = jgetText(pipeline.read_image(str(tmp_path / "receipt.png")), demo["jdet"], demo["jrec"])
    rc = pipeline.main(["--img", str(tmp_path / "receipt.png"), "--config",
                        str(tmp_path / "config.yml"), "--thresh", "0.5", "--device", "cpu"])
    assert rc == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed == [v for k, v in want.items() if k > 0.5] and len(printed) >= 3
    pipeline.main(["--img", str(tmp_path / "receipt.png"), "--config", str(tmp_path / "config.yml"),
                   "--thresh", "0.5", "--device", "cpu", "--debug"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("\t")[2] for ln in lines[:-1]] == printed
    assert lines[-1].startswith("[debug] end-to-end:")
    with pytest.raises(SystemExit):
        pipeline.main(["--img", str(tmp_path / "missing.png"), "--device", "cpu"])

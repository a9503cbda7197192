"""CRNN train step: device operations launched in the span around
Trainer.train_step, a step."""


def read(rec):
    tr = rec["trace"]
    spans = tr.spans("ocr_bench.train_step")
    if not spans or not tr.device:
        return None
    return sum(len(tr.span_kernels(s)) for s in spans) / len(spans)

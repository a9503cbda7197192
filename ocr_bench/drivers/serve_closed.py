"""Closed loop: ``clients`` callers, each sending its next receipt when its
last answer comes back (bulk posting).  End to end: ``receipts_per_s``,
receipts answered in the window over the window's seconds."""
from __future__ import annotations

import time

from ocr_bench import serving


def run(ctx) -> dict:
    tr = ctx.traffic
    served = serving.Served(ctx)
    served.warm(tr["warm_batches"])
    state = {"n": 0, "open": True}

    def send(client: int) -> None:
        with served.lock:
            k = state["n"]
            state["n"] += 1
        served.submit(int(served.order[k % len(served.order)]), client, time.perf_counter(), then=again)

    def again(req) -> None:
        if state["open"]:
            send(req.client)

    def window(t0: float, t1: float) -> None:
        for c in range(int(tr["clients"])):
            send(c)
        ctx.sleep_until(t1)
        state["open"] = False

    try:
        t0, t1, traced = ctx.run_window(window)
        served.settle()
    except BaseException:
        served.close()
        raise
    done = [r for r in served.requests if r.done is not None and r.done <= t1]
    out = serving.finish(ctx, served, t0, t1, traced)
    out["e2e"] = {"receipts_per_s": len(done) / (t1 - t0)}
    return out

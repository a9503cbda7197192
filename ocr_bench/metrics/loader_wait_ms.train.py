"""Training loader (data/loader.py::DataLoader): host ms a step waits for
its batch, over the steps of the traced window."""


def read(rec):
    a, b = rec["traced"]
    waits = [got - ask for ask, got in rec["steps"] if a <= ask <= b]
    return 1e3 * sum(waits) / len(waits) if waits else None

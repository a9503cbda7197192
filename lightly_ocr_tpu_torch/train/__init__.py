"""Training of the port: the CRNN recognizer (train steps and the trainer)
and the CRAFT detector (``craft``, with ``pseudo_labels`` for word-box
records)."""

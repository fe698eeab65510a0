"""CUDA kernel launches in the traced steps, per step (the train loop's layer:
training/loop.py's step issues them, and their issue time paces a step the
device does not)."""


def read(rec):
    return len(rec["kernels"]) / rec["steps"] if rec["kernels"] else None

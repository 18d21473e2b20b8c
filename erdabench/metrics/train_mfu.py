"""Per cent of the H100's dense bf16 peak that training reaches: the model
operations of a step (``counts.train_flops``, PaLM's convention) over every
step's host time outside the traced slice."""
from erdabench import counts


def read(r):
    n, secs = r.count("step"), r.seconds("step")
    if not n:
        return None
    flops = n * counts.train_flops(r.model, r.mix["batch"], r.mix["seq_len"])
    return 100.0 * flops / secs / counts.BF16_TENSOR_OPS_PER_S

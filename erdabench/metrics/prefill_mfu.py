"""Per cent of the H100's dense bf16 peak that the prefills reach: the
nominal operations of each prefill (``counts.prefill_flops``) over the host
time from the call into ``prefill`` to the first token on the host, summed
over every prefill outside the traced slice."""
from erdabench import counts


def read(r):
    n, secs = r.count("prefill"), r.seconds("prefill")
    if not n:
        return None
    flops = n * counts.prefill_flops(r.model, r.mix["batch"], r.mix["prompt_len"])
    return 100.0 * flops / secs / counts.BF16_TENSOR_OPS_PER_S

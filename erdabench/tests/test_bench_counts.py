"""The frozen yardstick against the bounds PERF.md's kernel table was made
with (``chip_smoke.py::flash_bound_ms`` / ``crc_bound_ms``) and against
operation counts worked out by hand."""
import pytest

from erdabench import counts

FLASH = [((32, 1536, 128, "bfloat16", True), 0.0195, "operations"),
         ((96, 1024, 64, "bfloat16", True), 0.0150, "bytes"),
         ((64, 256, 128, "bfloat16", True), 0.00501, "bytes"),
         ((16, 1536, 256, "bfloat16", True), 0.0195, "operations"),
         ((48, 1500, 64, "bfloat16", False), 0.0280, "operations"),
         ((32, 2048, 128, "bfloat16", True), 0.0347, "operations"),
         ((3, 192, 256, "float32", True), 0.00085, "operations")]
CRC = [((3, 25165843), 0.0901, "bytes"), ((4, 12582931), 0.0601, "bytes"),
       ((120, 1048581), 0.150, "bytes"), ((6, 52428820), 0.3756, "bytes"),
       ((1, 261), 3.1e-7, "bytes")]


@pytest.mark.parametrize("shape,ms,by", FLASH)
def test_flash_bound(shape, ms, by):
    got, got_by = counts.flash_bound_ms(*shape)
    assert got == pytest.approx(ms, rel=0.01) and got_by == by


@pytest.mark.parametrize("shape,ms,by", CRC)
def test_crc_bound(shape, ms, by):
    got, got_by = counts.crc_bound_ms(*shape)
    assert got == pytest.approx(ms, rel=0.01) and got_by == by


OLMO = {"n_layers": 16, "d_model": 2048, "n_heads": 16, "n_kv_heads": 16,
        "head_dim": 128, "d_ff": 8192, "vocab_size": 50304}
GRANITE = {"n_layers": 32, "d_model": 1536, "n_heads": 24, "n_kv_heads": 8,
           "head_dim": 64, "d_ff": 512, "vocab_size": 49155, "n_experts": 40,
           "n_experts_active": 8}


def test_matmul_weights():
    # OLMo: 4 d^2 of attention + 3 d f of SwiGLU a layer
    assert counts.matmul_params_per_token(OLMO) == 16 * (4 * 2048 ** 2 + 3 * 2048 * 8192)
    # granite: q, o d^2; k, v d x 512; 8 experts of 3 d f; the router d x 40
    per = 2 * 1536 ** 2 + 2 * 1536 * 512 + 8 * 3 * 1536 * 512 + 1536 * 40
    assert counts.matmul_params_per_token(GRANITE) == 32 * per


def test_prefill_flops():
    # olmo chat: 32 x 512 tokens, the 36 ms bound of PERF.md's prediction
    got = counts.prefill_flops(OLMO, 32, 512)
    assert got == pytest.approx(3.57e13, rel=0.005)
    assert got / counts.BF16_TENSOR_OPS_PER_S == pytest.approx(0.0361, rel=0.01)
    # granite long prompt: 4 x 3840 tokens
    assert counts.prefill_flops(GRANITE, 4, 3840) == pytest.approx(3.06e13, rel=0.01)


def test_train_flops():
    # 6 N T with N the matmul weights and the unembedding, + 12 L H hd S T
    n = counts.matmul_params_per_token(OLMO) + 2048 * 50304
    tokens = 4 * 2048
    want = 6 * n * tokens + 12 * 16 * 16 * 128 * 2048 * tokens
    assert counts.train_flops(OLMO, 4, 2048) == want
    assert want == pytest.approx(6.45e13, rel=0.005)

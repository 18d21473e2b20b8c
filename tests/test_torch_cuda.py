"""The port's CUDA kernels against their plain versions, on the card.
JAX-free, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each test skips where there is no CUDA device."""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import ServerConfig, layout, make_store
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,w", [(1, 1), (4, 16), (32, 64), (128, 7),
                                 (1000, 3), (512, 256), (65, 4097)])
def test_crc32_kernel_matches_plain_and_zlib(cuda_device, n, w):
    data = np.random.default_rng(n * 100 + w).integers(
        0, 2**32, size=(n, w), dtype=np.uint32)
    words = torch.from_numpy(data.view(np.int32)).to(cuda_device)
    before = ops.COUNTS["crc32_batch"].launches
    got = ops.crc32_batch(words)
    assert ops.COUNTS["crc32_batch"].launches == before + 1
    assert got.is_cuda and torch.equal(got, ref.crc32_ref(words))
    assert got.cpu().tolist() == [zlib.crc32(r.tobytes()) for r in data]


def test_verify_records_on_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(0)
    bufs = []
    for n in (0, 5, 64, 1000):
        rec = layout.pack_record(int(rng.integers(1, 2**62)), rng.bytes(n))
        flip = bytearray(rec)
        flip[-1] ^= 4
        bufs += [rec, rec[:-2], bytes(flip), rec + bytes(7)]
    bufs.append(layout.pack_record(9, None, delete=True))
    np.testing.assert_array_equal(layout.verify_records(bufs, cuda_device),
                                  layout.verify_records(bufs, "cpu"))


def test_store_round_trip_on_card(cuda_device):
    s = make_store("erda-cluster", n_shards=2, replication=2,
                   cfg=ServerConfig(device_size=4 << 20, table_capacity=1 << 9,
                                    n_heads=2, region_size=256 << 10,
                                    segment_size=32 << 10))
    s.multi_write([(k, bytes([k]) * k) for k in range(1, 40)])
    before = ops.COUNTS["crc32_batch"].launches
    assert s.multi_read(list(range(1, 40))) == [bytes([k]) * k for k in range(1, 40)]
    assert ops.COUNTS["crc32_batch"].launches > before

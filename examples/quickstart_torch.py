"""Quickstart on the PyTorch/CUDA port: the Erda store in 40 lines —
write/read/update/delete, a torn write detected by CRC and healed from the
old version, plus the NVM write accounting that reproduces Table 1's ≈50 %
saving.  Every read CRC-verifies what it fetched on ``--device``: on the
card, through the CRC kernel.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import ErdaStore, make_store
from repro_torch.nvmsim.device import TornWrite


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args(argv).device

    store = ErdaStore(device=device)

    # --- basic ops: metadata flip (8-byte atomic) + one one-sided data write each
    store.write(1, b"hello erda")
    store.write(2, b"another object")
    store.write(1, b"hello again (v2)")          # out-of-place update; v1 survives
    assert store.read(1) == b"hello again (v2)"
    store.delete(2)
    assert store.read(2) is None

    # --- the RDA story: a client dies mid-write; the object is torn in NVM
    store.dev.fault.arm(countdown=0, fraction=0.5)
    try:
        store.write(1, b"this write will be cut off half way")
    except TornWrite as e:
        print(f"client crashed mid-write: {e}")

    value = store.read(1)                         # CRC fails → old-version fallback
    print(f"reader still sees a consistent value: {value!r}")
    assert value == b"hello again (v2)"
    print(f"fallbacks={store.stats['fallbacks']}, repairs={store.stats['repairs']}")

    # --- Table 1: NVM bytes per update, Erda vs redo logging
    erda, redo = make_store("erda", device=device), make_store("redo")
    for s in (erda, redo):
        s.write(7, b"x" * 1024)
    b0e, b0r = erda.dev.stats.bytes_written, redo.dev.stats.bytes_written
    erda.write(7, b"y" * 1024)
    redo.write(7, b"y" * 1024)
    de = erda.dev.stats.bytes_written - b0e
    dr = redo.dev.stats.bytes_written - b0r
    print(f"update of a 1 KiB value: Erda wrote {de} B, Redo Logging wrote {dr} B "
          f"({de/dr:.0%} — the paper's ≈50 % claim)")


if __name__ == "__main__":
    main()

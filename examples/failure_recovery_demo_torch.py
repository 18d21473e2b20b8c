"""The paper's §4.2 failure scenarios on the PyTorch/CUDA port, end to end,
at checkpoint scale (the train state on ``--device``; every restore
CRC-verifies its shards there, on the card through the CRC kernel):

  1. a checkpoint writer dies mid-shard  → committed checkpoint unaffected
  2. the manifest data write itself tears → old manifest version served
  3. the server crashes with torn objects → recovery scan repairs metadata
  4. training resumes from the last consistent checkpoint

    PYTHONPATH=src python examples/failure_recovery_demo_torch.py [--device cpu]
"""
import argparse
import json

from repro_torch.checkpoint import ErdaCheckpointManager
from repro_torch.checkpoint.erda_ckpt import MANIFEST_KEY
from repro_torch.launch.train import save_train_state, train
from repro_torch.models.convert import to_reference_tree
from repro_torch.nvmsim.device import TornWrite


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = ap.parse_args(argv).device
    mgr = ErdaCheckpointManager(device=device)

    print("=== train 8 steps, checkpoint every 4 ===")
    state, losses, _ = train(arch="olmo_1b", scale="smoke", steps=8, batch=2,
                             seq=64, ckpt_every=4, ckpt_mgr=mgr, log_every=4,
                             device=device)
    template = to_reference_tree(state)  # the checkpoint's tree

    print("\n=== scenario 1: writer crash mid-checkpoint (step 12) ===")
    try:
        save_train_state(mgr, 12, state, fail_after_shards=3)
    except RuntimeError as e:
        print(f"writer died: {e}")
    step, _ = mgr.restore(template)
    print(f"restore still serves committed step {step} (expected 8)")
    assert step == 8

    print("\n=== scenario 2: torn manifest write ===")
    mgr.store.dev.fault.arm(countdown=0, fraction=0.3)
    try:
        mgr.store.write(MANIFEST_KEY, json.dumps({"step": 99, "entries": []}).encode())
    except TornWrite:
        print("manifest write torn at the NIC cache")
    step, _ = mgr.restore(template)
    print(f"CRC fallback serves step {step} (expected 8)")
    assert step == 8

    print("\n=== scenario 3: server crash + recovery scan ===")
    stats = mgr.crash_recover()
    print(f"recovery: {stats}")
    step, _ = mgr.restore(template)
    assert step == 8

    print("\n=== scenario 4: resume training from the consistent checkpoint ===")
    _, losses2, _ = train(arch="olmo_1b", scale="smoke", steps=10, batch=2,
                          seq=64, resume=True, ckpt_mgr=mgr, log_every=2,
                          device=device)
    print(f"resumed and ran {len(losses2)} more steps — all invariants held")


if __name__ == "__main__":
    main()

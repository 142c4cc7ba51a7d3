"""Table II (scaled down): accuracy ordering DuDNN ≈ FR ≫ CA ≫ BO.

Counterpart of ``benchmarks/table2_accuracy.py``: the same protocol
(pretrained frozen backbone, equal adapter budgets, identical steps) on the
synthetic bigram-LM task, the same rows and the same ordering row.

    PYTHONPATH=src python -m repro_torch.bench.table2_accuracy --device cuda

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.
"""
from __future__ import annotations

import time

from repro_torch.bench import common

ARMS = ("duplex", "full", "chain", "branch_only")


def run(device="cuda", pretrain_steps: int = 150,
        arm_steps: int = 200) -> tuple[list[str], dict]:
    """The rows, and ``{arm: (val_loss, val_acc, train_s)}`` beside them."""
    t0 = time.time()
    backbone, pre_loss = common.pretrain_backbone(steps=pretrain_steps,
                                                  device=device)
    rows = []
    results = {}
    for arm in ARMS:
        loss, acc, dt = common.train_arm(arm, backbone, steps=arm_steps,
                                         device=device)
        results[arm] = (loss, acc, dt)
        rows.append(f"table2/{arm},{dt*1e6/arm_steps:.0f},"
                    f"loss={loss:.4f};acc={acc:.4f}")

    # the paper's ordering (Table II): DuDNN ≈ FR  ≫  CA  ≫  BO
    d, f = results["duplex"][0], results["full"][0]
    c, b = results["chain"][0], results["branch_only"][0]
    ok_df = d <= f * 1.15          # DuDNN within 15% of full finetune
    ok_dc = d < c                  # beats chain
    ok_cb = c < b                  # chain beats branch-only
    rows.append(f"table2/ordering,{(time.time()-t0)*1e6:.0f},"
                f"DuDNN~FR={ok_df};DuDNN<CA={ok_dc};CA<BO={ok_cb}")
    return rows, results


def main(argv=None) -> list[str]:
    return common.cli(run, argv)


if __name__ == "__main__":
    main()

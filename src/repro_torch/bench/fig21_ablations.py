"""Fig 21 (scaled down): (a) pooling-factor ablation — halving the pool
factor quadruples branch compute for ~no accuracy gain; (b) norm-free branch
matches the normalized branch under backbone guidance.

Counterpart of ``benchmarks/fig21_ablations.py``: the same backbone, arms,
configurations and step counts, and the same rows in the same order.

    PYTHONPATH=src python -m repro_torch.bench.fig21_ablations --device cuda

``duplex_cfg(use_norm=False)`` is the same configuration as
``duplex_cfg(pool=4)`` (pool 4, no norm, BFP (3,3), branch key 1, the same
data), so ``fig21b/norm_free`` trains the ``fig21a/pool4`` arm again, as
the reference does; ``results`` keeps both runs.

Runs on ``cuda`` unless ``--device cpu`` is given; a CUDA request without a
card raises.
"""
from __future__ import annotations

from repro_torch.bench import common


def run(device="cuda", pretrain_steps: int = 150,
        arm_steps: int = 200) -> tuple[list[str], dict]:
    """The rows, and ``{row name: (val_loss, val_acc, train_s)}`` for each
    trained arm beside them."""
    backbone, _ = common.pretrain_backbone(steps=pretrain_steps,
                                           device=device)
    rows = []
    results = {}

    def arm(name, dcfg):
        loss, acc, dt = common.train_arm("duplex", backbone, steps=arm_steps,
                                         dcfg=dcfg, device=device)
        results[name] = (loss, acc, dt)
        rows.append(f"{name},{dt*1e6/arm_steps:.0f},"
                    f"loss={loss:.4f};acc={acc:.4f}")
        return loss

    # (a) pooling: pool=8 ("7×7") vs pool=4 ("14×14" — 4× the branch tokens)
    loss = {pool: arm(f"fig21a/pool{pool}", common.duplex_cfg(pool=pool))
            for pool in (8, 4)}
    gain = loss[8] - loss[4]     # loss delta from 4× more branch compute
    rows.append(f"fig21a/verdict,0,loss_gain_from_4x_compute={gain:.4f}")

    # (b) normalization in the branch
    for use_norm in (False, True):
        arm("fig21b/norm" if use_norm else "fig21b/norm_free",
            common.duplex_cfg(use_norm=use_norm))
    return rows, results


def main(argv=None) -> list[str]:
    return common.cli(run, argv)


if __name__ == "__main__":
    main()

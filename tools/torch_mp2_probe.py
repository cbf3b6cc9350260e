"""How far two ranks of ``chip_smoke.py``'s ``mesh_mp2`` phase drift from
one process with the GK's learning rate.

Runs the phase's GK case (the shipped-width GK in f32 with ``seq_shard``,
two gloo ranks on one card at ``mesh_shape dp=1,mp=2``, batch 4, 3 steps)
at the shipped lr 0.01, at lr 1e-7 with dropout on and at lr 1e-7 with the
encoder's dropout off, each against the same steps in one process, and
prints the phase's line with every reading, where the phase's limits
(``chip_smoke.F32_LIMITS``) would fail it (``failed``) or not. The phase
itself runs the GK at lr 1e-4.

    PYTHONPATH=. python3 tools/torch_mp2_probe.py

Needs a card; builds the kernels first (``chip_smoke.phase_build``).
"""

import sys

import torch

import chip_smoke as cs


def main() -> None:
    cs.phase_env()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    gk = cs.MP2_CASES["gk"]
    slow = dict(gk["cfg"], lr=1e-7)
    cs.MP2_CASES = {
        "gk_lr_0.01": dict(gk, cfg=cs.GK_TRAIN_CFG),
        "gk_lr_1e-7": dict(gk, cfg=slow),
        "gk_no_dropout_lr_1e-7": dict(gk, cfg=slow,
                                      model=dict(gk["model"], encoder_dropout=0.0)),
    }
    try:
        cs.phase_mesh_mp2(dev)       # prints its line before it judges
    except AssertionError as e:
        print(f"over the phase's limits: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()

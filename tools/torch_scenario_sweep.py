#!/usr/bin/env python3
"""Every scenario pair of ``chip_smoke.py``'s scenarios phase at its shipped
batches on one card: the training step at the config's train_batch_size and
the prediction at its test_batch_size × N_autoregressive, in the shipped
f32, with the scenarios phase's seeded weights and inputs at the scenario's
window.

    python3 tools/torch_scenario_sweep.py [--held] [--steps 2]
        [--out sweep.jsonl] [PAIR ...]

From the repository root on a host with a Hopper card and nvcc (the kernels
are built, or found built, first). A PAIR is ``scenario/name`` (for example
``fsi/unet``, or ``combustion/surrogate_model/unet`` for the surrogate's two
configs at their 20x128x128 windows, 17 channels in and 1 out); none: the 34
pairs of ``chip_smoke.SCENARIO_PAIRS``, and with ``--held`` also the 13 that
chip_smoke's earlier phases hold at the cylinder's window
(``SCENARIO_HELD``). Per pair one JSON line: the configs it covers; the step's steps/s over a window of ``--steps`` steps after one
counted and one warm-up step, and its peak memory; the prediction's
frames/s (one counted prediction after a warm-up at batch 2) and peak
memory; exact launch and variant counts as chip_smoke holds them. A pair
that does not fit, does not finish or launches otherwise is a fault: its
line names the error, the sweep goes on, and the script exits 1 after the
last pair. The card's name and power limit stand on the first lines.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the surrogate's configs at their own windows (chip_smoke's SURROGATE_IN/OUT);
# they carry no N_autoregressive: their prediction is one window a forward
cs.SCENARIO_WINDOWS.setdefault("combustion/surrogate_model", (cs.SURROGATE_IN, cs.SURROGATE_OUT))
_load = cs._scenario
cs._scenario = lambda scenario, name: {"N_autoregressive": 1, **_load(scenario, name)}


def _fault(exc: BaseException) -> dict:
    oom = isinstance(exc, torch.OutOfMemoryError)
    return dict(fault="out of memory" if oom else type(exc).__name__,
                error=str(exc)[:2000], where=traceback.format_exc(limit=4)[-1500:])


def sweep_pair(dev, scenario: str, name: str, steps: int) -> dict:
    """The pair's shipped-batch step and prediction; a fault in either is
    recorded and the other still runs."""
    cfg = cs._scenario(scenario, name)
    row = dict(pair=f"{scenario}/{name}.yaml", window=cs.SCENARIO_WINDOWS[scenario],
               train_batch=cfg.get("train_batch_size"), test_batch=cfg["test_batch_size"],
               n_autoregressive=cfg["N_autoregressive"])
    if cfg["model_name"] != "dmd":          # training-free
        try:
            _, row["step"] = cs.scenario_step(dev, scenario, name,
                                              int(cfg["train_batch_size"]), compare=False,
                                              timed_steps=steps, tag="shipped_step")
        except Exception as exc:        # noqa: BLE001 (the sweep goes on)
            row["step"] = _fault(exc)
        cs._free()
    try:
        _, row["prediction"] = cs.scenario_prediction(dev, scenario, name,
                                                      int(cfg["test_batch_size"]),
                                                      compare=False, timed=True)
    except Exception as exc:            # noqa: BLE001
        row["prediction"] = _fault(exc)
    cs._free()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("pairs", nargs="*")
    ap.add_argument("--held", action="store_true")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    name = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    pairs = list(cs.SCENARIO_PAIRS)
    if args.held:
        pairs += [tuple(k[: -len(".yaml")].rsplit("/", 1)) for k in cs.SCENARIO_HELD]
    if args.pairs:
        pairs = [tuple(p.rsplit("/", 1)) for p in args.pairs]
    covers = cs.scenario_covers()
    out = open(args.out, "w") if args.out else None
    faults = []
    t_all = time.perf_counter()
    for scenario, model in pairs:
        t0 = time.perf_counter()
        row = sweep_pair(dev, scenario, model, args.steps)
        row.update(covers=covers.get(row["pair"], [row["pair"]]),
                   seconds=time.perf_counter() - t0,
                   device=name)
        faults += [f"{row['pair']}:{k}" for k in ("step", "prediction")
                   if "fault" in row.get(k, {})]
        line = json.dumps(row, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    print(json.dumps(dict(pairs=len(pairs), faults=faults,
                          seconds=time.perf_counter() - t_all)), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())

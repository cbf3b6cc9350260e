"""Split arithmetic and sim/time-id assignment: pure host-side functions.

Counterpart of ``realpdebench_tpu/data/splits.py``, line for line (numpy
and json only; this package keeps its own copy). Reference semantics:
`realpdebench/data/dataset.py:7-127` (window, horizon and count
arithmetic) and `realpdebench/data/fluid_dataset.py:87-344` (test-mode
filtering, horizon filtering, parameter-extreme test-set selection,
trunk-based temporal splitting), as standalone functions over plain Python
containers.

Shipped id-mapping artifacts (``sim_id_mapping_{type}.pt`` etc.) are used
as they are when present; regeneration is for synthetic trees.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SplitSpec:
    """Window/horizon/count arithmetic (reference dataset.py:72-106)."""

    n_sim: int
    n_sim_frame: int
    in_step: int
    out_step: int  # per autoregressive step
    N_autoregressive: int
    interval: int
    train_ratio: float
    dataset_type: str  # real | numerical
    split_numerical: bool
    n_sim_in_distribution: int
    n_sim_out_distribution: int
    trunk_length: int

    @property
    def total_out_step(self) -> int:
        return self.out_step * self.N_autoregressive

    @property
    def horizon(self) -> int:
        return self.in_step + self.total_out_step

    @property
    def n_data_per_sim(self) -> int:
        return (self.n_sim_frame - self.horizon + 1) // self.interval


def compute_split_counts(spec: SplitSpec) -> dict:
    """Counts of train/val/test samples (reference dataset.py:85-106)."""
    n_total = spec.n_sim * spec.n_data_per_sim
    if spec.dataset_type == "real" or spec.split_numerical:
        n_train = int(n_total * spec.train_ratio)
        n_val_test = n_total - n_train
        n_val = int(n_val_test * 0.5)
        n_test = n_val_test - n_val
        n_in = spec.n_sim_in_distribution * spec.n_data_per_sim
        n_out = spec.n_sim_out_distribution * spec.n_data_per_sim
        return dict(
            n_data_train=n_train,
            n_data_val_test=n_val_test,
            n_data_val=n_val,
            n_data_test=n_test,
            n_data_in_distribution=n_in,
            n_data_out_distribution=n_out,
            n_data_remain=n_val_test - n_in - n_out,
        )
    elif spec.dataset_type == "numerical":
        return dict(
            n_data_train=n_total,
            n_data_val_test=0,
            n_data_val=0,
            n_data_test=0,
            n_data_in_distribution=0,
            n_data_out_distribution=0,
            n_data_remain=0,
        )
    raise ValueError(f"Dataset type {spec.dataset_type} not supported.")


# ---------------------------------------------------------------------------
# Id-mapping artifact IO
# ---------------------------------------------------------------------------

def load_id_mappings(dataset_dir: str, dataset_type: str):
    """Load the five shipped id-mapping artifacts for a scenario.

    Prefers JSON sidecars (our native format + the HF variant's format,
    `fluid_hf_dataset.py:196-220`); falls back to the reference's torch ``.pt``
    pickles when torch is importable. Returns
    (in_dist_params, out_dist_params, remain_params, sim_id_mapping,
    time_id_mapping) or None when no artifacts exist.
    """
    names = [
        f"in_dist_test_params_{dataset_type}",
        f"out_dist_test_params_{dataset_type}",
        f"remain_params_{dataset_type}",
        f"sim_id_mapping_{dataset_type}",
        f"time_id_mapping_{dataset_type}",
    ]
    out = []
    for name in names:
        jpath = os.path.join(dataset_dir, name + ".json")
        ppath = os.path.join(dataset_dir, name + ".pt")
        if os.path.exists(jpath):
            with open(jpath) as f:
                out.append(json.load(f))
        elif os.path.exists(ppath):
            import torch  # host-side artifact decode only

            out.append(torch.load(ppath, map_location="cpu", weights_only=False))
        else:
            return None
    return tuple(out)


def save_id_mappings(dataset_dir: str, dataset_type: str, mappings) -> None:
    """Persist id mappings as JSON (tuples become lists; fine for params)."""
    names = [
        f"in_dist_test_params_{dataset_type}",
        f"out_dist_test_params_{dataset_type}",
        f"remain_params_{dataset_type}",
        f"sim_id_mapping_{dataset_type}",
        f"time_id_mapping_{dataset_type}",
    ]
    os.makedirs(dataset_dir, exist_ok=True)
    for name, obj in zip(names, mappings):
        with open(os.path.join(dataset_dir, name + ".json"), "w") as f:
            json.dump(obj, f)


# ---------------------------------------------------------------------------
# Regeneration (used for synthetic fixtures; reference fluid_dataset.py:124-344)
# ---------------------------------------------------------------------------

def parse_h5_files(dataset_path: str, file_name_pattern: str) -> Dict[str, tuple]:
    """filename → parameter tuple, parsed with the scenario regex
    (reference `_parse_h5_files`, fluid_dataset.py:124-152)."""
    if not os.path.exists(dataset_path):
        return {}
    return parse_file_names(os.listdir(dataset_path), file_name_pattern)


def parse_file_names(names, file_name_pattern: str) -> Dict[str, tuple]:
    """``parse_h5_files`` over a list of file names: the ``.h5`` names the
    regex matches with one or two groups, sorted."""
    file_params: Dict[str, tuple] = {}
    for filename in sorted(names):
        if not filename.endswith(".h5"):
            continue
        match = re.match(file_name_pattern, filename)
        if match:
            groups = match.groups()
            if 1 <= len(groups) <= 2:
                file_params[filename] = tuple(float(g) for g in groups)
    return file_params


def separate_test_params(
    file_params: Dict[str, tuple],
    n_sim_in_distribution: int,
    n_sim_out_distribution: int,
    rng: random.Random,
):
    """Split trajectories into in-dist (middle parameter values), out-dist
    (parameter extremes), and remain sets (reference fluid_dataset.py:154-250).

    Single-parameter scenarios: sort by the parameter, the outer 10% on each
    side are out-dist candidates, the middle are in-dist candidates.
    Two-parameter scenarios: rows at a global min/max of either parameter are
    out-dist; within each para1 group, the per-group para2 extremes are
    excluded from in-dist candidates.
    """
    first = next(iter(file_params.values()))
    single = len(first) == 1

    if single:
        allp = sorted(
            [(fn, p[0]) for fn, p in file_params.items()], key=lambda x: x[1]
        )
        mid = len(allp) // 10
        out_cand = allp[:mid] + allp[len(allp) - mid:]
        in_cand = allp[mid: len(allp) - mid]
    else:
        allp = sorted(
            [(fn, p[0], p[1]) for fn, p in file_params.items()],
            key=lambda x: (x[1], x[2]),
        )
        p1s = [x[1] for x in allp]
        p2s = [x[2] for x in allp]
        mn1, mx1, mn2, mx2 = min(p1s), max(p1s), min(p2s), max(p2s)
        out_cand = [
            x for x in allp if x[1] in (mn1, mx1) or x[2] in (mn2, mx2)
        ]
        remain = [x for x in allp if x not in out_cand]
        groups: Dict[float, list] = {}
        for x in remain:
            groups.setdefault(x[1], []).append(x)
        edge = []
        for g in groups.values():
            g2 = [x[2] for x in g]
            lo, hi = min(g2), max(g2)
            edge.extend([x for x in g if x[2] in (lo, hi)])
        in_cand = [x for x in remain if x not in edge]

    rng.shuffle(out_cand)
    sel_out = out_cand[:n_sim_out_distribution]
    rng.shuffle(in_cand)
    sel_in = in_cand[:n_sim_in_distribution]
    remain = [x for x in allp if x not in sel_in and x not in sel_out]

    def to_dict(items):
        return {x[0]: tuple(x[1:]) for x in items}

    return to_dict(sel_in), to_dict(sel_out), to_dict(remain)


def assign_sim_and_time_ids(
    spec: SplitSpec,
    in_dist_params: Dict[str, tuple],
    out_dist_params: Dict[str, tuple],
    remain_params: Dict[str, tuple],
    rng: random.Random,
):
    """Assign (sim_id, time_id) pairs to train/val/test.

    Reference `_assign_sim_and_time_ids` (fluid_dataset.py:260-344): train
    takes whole temporal *trunks* of the remain sims until n_data_train is
    reached; the rest of the remain trunks plus half the in/out-dist windows
    form val, the other half test. Time ids step by ``interval``.
    """
    counts = compute_split_counts(spec)
    n_per = spec.n_data_per_sim

    def pairs_for(params):
        out = []
        for sim_id in params.keys():
            for t in range(n_per):
                out.append((sim_id, t * spec.interval))
        return out

    in_pairs = pairs_for(in_dist_params)
    out_pairs = pairs_for(out_dist_params)

    n_trunks = int(np.ceil(spec.n_sim_frame / spec.trunk_length))
    trunks = []
    for sim_id in remain_params.keys():
        for trunk_idx in range(n_trunks):
            start = trunk_idx * spec.trunk_length
            end = min(
                (trunk_idx + 1) * spec.trunk_length,
                spec.n_sim_frame - spec.horizon + 1,
            )
            trunks.append(
                [(sim_id, t) for t in range(start, end, spec.interval)]
            )
    rng.shuffle(trunks)
    train_pairs: list = []
    valtest_pairs: list = []
    for trunk in trunks:
        if len(train_pairs) < counts["n_data_train"]:
            train_pairs.extend(trunk)
        else:
            valtest_pairs.extend(trunk)

    rng.shuffle(in_pairs)
    rng.shuffle(out_pairs)
    rng.shuffle(train_pairs)
    rng.shuffle(valtest_pairs)

    n_in_half = counts["n_data_in_distribution"] // 2
    n_out_half = counts["n_data_out_distribution"] // 2
    val_pairs = (
        in_pairs[:n_in_half]
        + out_pairs[:n_out_half]
        + valtest_pairs[: len(valtest_pairs) // 2]
    )
    test_pairs = (
        in_pairs[n_in_half:]
        + out_pairs[n_out_half:]
        + valtest_pairs[len(valtest_pairs) // 2:]
    )
    rng.shuffle(val_pairs)
    rng.shuffle(test_pairs)
    rng.shuffle(train_pairs)

    sim_id_mapping = {
        k: [sid for sid, _ in v]
        for k, v in zip(("train", "val", "test"), (train_pairs, val_pairs, test_pairs))
    }
    time_id_mapping = {
        k: [tid for _, tid in v]
        for k, v in zip(("train", "val", "test"), (train_pairs, val_pairs, test_pairs))
    }
    return sim_id_mapping, time_id_mapping


# ---------------------------------------------------------------------------
# Runtime filters
# ---------------------------------------------------------------------------

def filter_test_mode(
    sim_ids: Sequence,
    time_ids: Sequence[int],
    test_mode: str,
    in_dist_params: Dict,
    out_dist_params: Dict,
    remain_params: Dict,
) -> Tuple[list, list]:
    """Restrict (sim, time) pairs to the requested generalization regime
    (reference `_get_test_mode_sim_and_time_ids`, fluid_dataset.py:87-112)."""
    if test_mode == "in_dist":
        target = set(in_dist_params.keys())
    elif test_mode == "out_dist":
        target = set(out_dist_params.keys())
    elif test_mode == "seen":
        target = set(remain_params.keys())
    elif test_mode == "unseen":
        target = set(in_dist_params.keys()) | set(out_dist_params.keys())
    else:
        raise ValueError(f"Invalid test_mode: {test_mode}")
    keep = [(s, t) for s, t in zip(sim_ids, time_ids) if s in target]
    return [s for s, _ in keep], [t for _, t in keep]


def filter_horizon(
    sim_ids: Sequence,
    time_ids: Sequence[int],
    horizon: int,
    n_sim_frame: int,
) -> Tuple[list, list]:
    """Drop windows whose autoregressive horizon overruns the trajectory
    (reference `_filter_time_ids`, fluid_dataset.py:114-122)."""
    keep = [
        (s, t) for s, t in zip(sim_ids, time_ids) if t + horizon < n_sim_frame
    ]
    return [s for s, _ in keep], [t for _, t in keep]

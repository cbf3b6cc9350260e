"""Hugging Face Hub artifact downloader.

Counterpart of ``realpdebench_tpu/data/hf_download.py`` (reference
`realpdebench/hf_download.py`): pattern-scoped ``snapshot_download`` of the
published dataset repo, with a version.json pre-check that aborts before
pulling large files when the data needs a newer data contract than this
package implements (hf_download.py:23-106), and an ``ensure_hf_artifacts``
hook used by the Arrow-backed datasets for lazy auto-download
(hf_download.py:281-322). ``huggingface_hub`` is imported only where a
fetch happens; ``dry_run`` resolves the patterns without it.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from pathlib import Path
from typing import Iterable, Optional, Sequence

from realpdebench_tpu_torch import DATA_CONTRACT_VERSION, _parse_version

ALL_SCENARIOS = (
    "cylinder", "controlled_cylinder", "fsi", "foil", "combustion",
)
DEFAULT_HF_DATASET_REPO_ID = "AI4Science-WestlakeU/RealPDEBench"


def _dedup_keep_order(items: Iterable[str]) -> list:
    seen = set()
    out = []
    for x in items:
        if x not in seen:
            seen.add(x)
            out.append(x)
    return out


def build_allow_patterns(
    *,
    scenarios: Sequence[str],
    what: str,
    dataset_types: Optional[Sequence[str]] = None,
    splits: Optional[Sequence[str]] = None,
    include_surrogate_train: bool = False,
) -> list:
    """Glob patterns for ``snapshot_download`` (reference hf_download.py:129-195).

    ``what``: 'metadata' (test-params JSONs only), 'hf_dataset' (Arrow shards
    + index JSONs), or 'all'.
    """
    if not scenarios:
        raise ValueError("scenarios must be non-empty.")
    dataset_types = dataset_types or ("real", "numerical")
    splits = splits or ("train", "val", "test")

    patterns = ["README.md", "version.json"]
    for scenario in scenarios:
        if what in ("metadata", "all"):
            patterns += [
                f"{scenario}/in_dist_test_params_*.json",
                f"{scenario}/out_dist_test_params_*.json",
                f"{scenario}/remain_params_*.json",
            ]
        if what in ("hf_dataset", "all"):
            for dt in dataset_types:
                patterns.append(f"{scenario}/hf_dataset/{dt}/**")
                for sp in splits:
                    patterns.append(
                        f"{scenario}/hf_dataset/{sp}_index_{dt}.json"
                    )
        if include_surrogate_train and scenario == "combustion":
            patterns += [
                "combustion/hf_dataset/surrogate_train/**",
                "combustion/hf_dataset/surrogate_train_sim_ids.txt",
                "combustion/hf_dataset/surrogate_train_meta.json",
            ]
    return _dedup_keep_order(patterns)


def _check_version_before_download(repo_id, endpoint, revision, token):
    """Fetch the ~1KB version.json first and refuse incompatible data
    (reference hf_download.py:23-106)."""
    from huggingface_hub import snapshot_download

    with tempfile.TemporaryDirectory() as tmpdir:
        try:
            snapshot_download(
                repo_id=repo_id, repo_type="dataset",
                allow_patterns=["version.json"], local_dir=tmpdir,
                endpoint=endpoint, revision=revision, token=token,
            )
        except Exception as e:
            logging.debug(f"Could not fetch version.json for pre-check: {e}")
            return
        vf = Path(tmpdir) / "version.json"
        if not vf.exists():
            return
        try:
            info = json.loads(vf.read_text())
        except (json.JSONDecodeError, OSError):
            return
        min_code = info.get("min_code_version", "0.0.0")
        if _parse_version(DATA_CONTRACT_VERSION) < _parse_version(min_code):
            raise RuntimeError(
                f"Data version {info.get('data_version')} requires code >= "
                f"{min_code}; this package implements {DATA_CONTRACT_VERSION}. "
                f"Upgrade before downloading."
            )


def download_realpdebench(
    *,
    dataset_root,
    scenarios: Sequence[str],
    what: str = "metadata",
    dataset_types: Optional[Sequence[str]] = None,
    splits: Optional[Sequence[str]] = None,
    include_surrogate_train: bool = False,
    repo_id: str = DEFAULT_HF_DATASET_REPO_ID,
    endpoint: Optional[str] = None,
    revision: Optional[str] = None,
    token: Optional[str] = None,
    dry_run: bool = False,
) -> dict:
    """Pattern-scoped snapshot download (reference hf_download.py:198-278);
    ``dry_run`` returns the resolved patterns without network."""
    allow_patterns = build_allow_patterns(
        scenarios=scenarios, what=what, dataset_types=dataset_types,
        splits=splits, include_surrogate_train=include_surrogate_train,
    )
    root = Path(dataset_root).expanduser().resolve()
    root.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("HF_HUB_DISABLE_XET", "1")

    result = {
        "repo_id": repo_id,
        "dataset_root": str(root),
        "allow_patterns": allow_patterns,
    }
    if dry_run:
        return result

    endpoint = endpoint or os.environ.get("HF_ENDPOINT")
    _check_version_before_download(repo_id, endpoint, revision, token)

    from huggingface_hub import snapshot_download

    try:
        snapshot_path = snapshot_download(
            repo_id=repo_id, repo_type="dataset",
            allow_patterns=allow_patterns, local_dir=str(root),
            endpoint=endpoint, revision=revision, token=token,
        )
    except Exception as e:
        raise RuntimeError(
            "Failed to download from Hugging Face Hub.\n"
            "Tips: try `--endpoint https://hf-mirror.com` or env HF_ENDPOINT; "
            "for auth/rate limits set HF_TOKEN; set HF_HUB_DISABLE_XET=1.\n"
            f"Details: {type(e).__name__}: {e}"
        ) from e
    result["snapshot_path"] = snapshot_path
    return result


def ensure_hf_artifacts(
    *,
    dataset_root,
    scenario: str,
    dataset_type: str,
    split: str,
    need_test_params_json: bool,
    hf_auto_download: bool,
    repo_id: str = DEFAULT_HF_DATASET_REPO_ID,
    endpoint: Optional[str] = None,
    revision: Optional[str] = None,
    token: Optional[str] = None,
) -> None:
    """Lazy auto-download hook for the Arrow datasets
    (reference hf_download.py:281-322)."""
    root = Path(dataset_root).expanduser().resolve()
    traj = root / scenario / "hf_dataset" / dataset_type
    index = root / scenario / "hf_dataset" / f"{split}_index_{dataset_type}.json"
    if traj.exists() and index.exists():
        return
    if not hf_auto_download:
        return
    download_realpdebench(
        dataset_root=str(root), scenarios=[scenario],
        what="all" if need_test_params_json else "hf_dataset",
        dataset_types=[dataset_type], splits=[split],
        repo_id=repo_id, endpoint=endpoint, revision=revision, token=token,
    )

"""`python -m realpdebench_tpu_torch` command-line interface.

Counterpart of ``realpdebench_tpu/cli.py`` (reference
`realpdebench/cli.py:12-138`): a ``download`` subcommand with
pattern-based Hugging Face snapshotting, a safe ``--what metadata``
default and ``--dry-run`` returning the resolved patterns without
network; ``train``, ``eval``, ``train-surrogate``, ``convert`` and
``parity`` take the flags of ``python -m realpdebench_tpu_torch.train``,
``.eval``, ``.train.surrogate``, ``.tools.convert_hdf5_to_hf`` and
``.eval.parity`` (dispatched before argparse, as there). The
JAX CLI's other subcommands are listed by ``--help`` and exit non-zero
naming the ROADMAP.md item they wait for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from realpdebench_tpu_torch import __version__
from realpdebench_tpu_torch.data.hf_download import (
    ALL_SCENARIOS,
    download_realpdebench,
)
from realpdebench_tpu_torch.utils.misc import use_expandable_segments

# subcommand → (help, what it waits for)
_NOT_PORTED = {
    "export-torch": ("Export an orbax checkpoint to a reference .pth",
                     "ROADMAP.md queue A, item 5 (orbax checkpoints: the port's "
                     "own checkpoints are reference .pth files already)"),
}
_PASSTHROUGH = {
    "train": "Train a model (flags of python -m realpdebench_tpu_torch.train)",
    "eval": "Evaluate a checkpoint",
    "train-surrogate": "Train the combustion surrogate (flags of "
                       "python -m realpdebench_tpu_torch.train.surrogate)",
    "convert": "Convert HDF5 trees to the Arrow V2 layout",
    "parity": "Evaluate a reference .pth through the port and through the "
              "reference PyTorch package, side by side",
}


def _entry(name):
    if name == "train":
        from realpdebench_tpu_torch.train.__main__ import main
    elif name == "eval":
        from realpdebench_tpu_torch.eval.__main__ import main
    elif name == "train-surrogate":
        from realpdebench_tpu_torch.train.surrogate import main
    elif name == "parity":
        from realpdebench_tpu_torch.eval.parity import main
    else:
        from realpdebench_tpu_torch.tools.convert_hdf5_to_hf import main
    return main


def _add_download_subcommand(subparsers) -> None:
    p = subparsers.add_parser(
        "download",
        help="Download RealPDEBench datasets/metadata from Hugging Face.",
    )
    p.add_argument("--dataset-root", required=True)
    p.add_argument("--scenario", action="append",
                   choices=list(ALL_SCENARIOS),
                   help="Repeatable; or pass --all.")
    p.add_argument("--all", action="store_true")
    p.add_argument("--what", default="metadata",
                   choices=["metadata", "hf_dataset", "all"],
                   help="Default: metadata (safe).")
    p.add_argument("--dataset-type", action="append",
                   choices=["real", "numerical"])
    p.add_argument("--split", action="append",
                   choices=["train", "val", "test"])
    p.add_argument("--include-surrogate-train", action="store_true")
    p.add_argument("--repo-id", default="AI4Science-WestlakeU/RealPDEBench")
    p.add_argument("--endpoint", default=os.environ.get("HF_ENDPOINT"))
    p.add_argument("--revision", default=None)
    p.add_argument("--token", default=None)
    p.add_argument("--dry-run", action="store_true",
                   help="Print resolved allow_patterns without downloading.")
    p.set_defaults(func=_cmd_download)


def _cmd_download(args) -> int:
    scenarios = list(ALL_SCENARIOS) if args.all else (args.scenario or [])
    if not scenarios:
        raise SystemExit("Please pass at least one --scenario or use --all.")
    try:
        result = download_realpdebench(
            dataset_root=args.dataset_root,
            scenarios=scenarios,
            what=args.what,
            dataset_types=args.dataset_type,
            splits=args.split,
            include_surrogate_train=bool(args.include_surrogate_train),
            repo_id=args.repo_id,
            endpoint=args.endpoint,
            revision=args.revision,
            token=args.token,
            dry_run=bool(args.dry_run),
        )
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    print(json.dumps(result, indent=2, sort_keys=True))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="realpdebench-tpu-torch")
    parser.add_argument("--version", action="version",
                        version=f"realpdebench_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_download_subcommand(sub)
    for name, help_ in _PASSTHROUGH.items():
        sub.add_parser(name, add_help=False, help=help_)
    for name, (help_, _) in _NOT_PORTED.items():
        sub.add_parser(name, add_help=False, help=f"{help_} (not ported)")
    return parser


def main(argv: Optional[list] = None) -> None:
    use_expandable_segments()
    if argv is None:
        argv = sys.argv[1:]
    # argparse's REMAINDER does not take leading optionals after the
    # subcommand, so the passthrough subcommands are dispatched before
    # argparse
    if argv and argv[0] in _PASSTHROUGH:
        _entry(argv[0])(argv[1:])
        raise SystemExit(0)
    if argv and argv[0] in _NOT_PORTED:
        print(f"realpdebench_tpu_torch {argv[0]}: not ported yet; it waits for "
              f"{_NOT_PORTED[argv[0]][1]}", file=sys.stderr)
        raise SystemExit(2)
    args = build_parser().parse_args(argv)
    raise SystemExit(args.func(args))


if __name__ == "__main__":
    main(sys.argv[1:])

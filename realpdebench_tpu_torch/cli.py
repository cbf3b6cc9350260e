"""`python -m realpdebench_tpu_torch` command-line interface.

Counterpart of ``realpdebench_tpu/cli.py``: the ``train`` and ``eval``
subcommands take the flags of ``python -m realpdebench_tpu_torch.train``
and ``.eval`` (dispatched before argparse, as there). The JAX CLI's other
subcommands are listed by ``--help`` and exit non-zero naming the
ROADMAP.md item they wait for.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from realpdebench_tpu_torch import __version__

# subcommand → (help, what it waits for)
_NOT_PORTED = {
    "download": ("Download RealPDEBench datasets/metadata from Hugging Face.",
                 "ROADMAP.md queue A, item 5 (data/hf_download: needs the network)"),
    "parity": ("Side-by-side reference-torch vs port eval of a .pth",
               "ROADMAP.md queue A, item 10 (the port-vs-JAX parity CLI)"),
    "train-surrogate": ("Train the combustion surrogate",
                        "ROADMAP.md queue A, item 7 (the combustion surrogate pipeline)"),
    "convert": ("Convert HDF5 trees to the Arrow V2 layout",
                "ROADMAP.md queue A, item 7 (tools/convert_hdf5_to_hf)"),
    "export-torch": ("Export an orbax checkpoint to a reference .pth",
                     "ROADMAP.md queue A, item 5 (orbax checkpoints: the port's "
                     "own checkpoints are reference .pth files already)"),
}


def _entry(name):
    if name == "train":
        from realpdebench_tpu_torch.train.__main__ import main
    else:
        from realpdebench_tpu_torch.eval.__main__ import main
    return main


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="realpdebench-tpu-torch")
    parser.add_argument("--version", action="version",
                        version=f"realpdebench_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("train", add_help=False,
                   help="Train a model (flags of python -m realpdebench_tpu_torch.train)")
    sub.add_parser("eval", add_help=False, help="Evaluate a checkpoint")
    for name, (help_, _) in _NOT_PORTED.items():
        sub.add_parser(name, add_help=False, help=f"{help_} (not ported)")
    return parser


def main(argv: Optional[list] = None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    # argparse's REMAINDER does not take leading optionals after the
    # subcommand, so train and eval are dispatched before argparse
    if argv and argv[0] in ("train", "eval"):
        _entry(argv[0])(argv[1:])
        raise SystemExit(0)
    if argv and argv[0] in _NOT_PORTED:
        print(f"realpdebench_tpu_torch {argv[0]}: not ported yet; it waits for "
              f"{_NOT_PORTED[argv[0]][1]}", file=sys.stderr)
        raise SystemExit(2)
    build_parser().parse_args(argv)


if __name__ == "__main__":
    main(sys.argv[1:])

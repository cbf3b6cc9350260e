"""Config system: YAML merged over argparse-style defaults, CLI wins.

Counterpart of ``realpdebench_tpu/config.py``, with the same merge
semantics and keys, so the reference's config files run unmodified. Config
names resolve in this package's own ``configs/`` tree. The parser gains
``--device`` (default ``cuda``): the entry points run on the card unless
asked for the CPU.

The entry points also take any other config key on the command line as
``--key value`` (``parse_overrides``); a bare ``--key`` sets it true. The
value is read as YAML, so ``--num_update 100`` is an int and
``--checkpoint_path null`` is None. Those keys win over the YAML file.
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace


class Config(SimpleNamespace):
    """Attribute-style config. ``get`` mirrors dict.get for optional keys."""

    def get(self, key, default=None):
        return getattr(self, key, default)

    def to_dict(self):
        return dict(vars(self))

    def replace(self, **kwargs):
        d = self.to_dict()
        d.update(kwargs)
        return Config(**d)


def resolve_config_path(path: str) -> str:
    """Resolve a config path: as-is, relative to this package, or relative to
    this package's ``configs/`` tree."""
    if os.path.exists(path):
        return path
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for candidate in (
        os.path.join(pkg_dir, path),
        os.path.join(pkg_dir, "configs", path),
    ):
        if os.path.exists(candidate):
            return candidate
    return path


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def merge_config(args: argparse.Namespace, explicit_keys=None) -> Config:
    """Merge a YAML config file into parsed args.

    Every YAML key that is not already an attribute of ``args`` is added,
    and so is every key that argparse left at None. ``explicit_keys`` (if
    given) lists the keys passed on the command line: YAML then overrides
    the parser's defaults but not those keys.
    """
    cfg_path = resolve_config_path(args.config)
    data = load_yaml(cfg_path)
    out = dict(vars(args))
    out["config"] = cfg_path
    existing = set(out.keys()) if explicit_keys is None else set(explicit_keys)
    for key, value in data.items():
        if key not in existing or out.get(key) is None:
            out[key] = value
    return Config(**out)


def load_config(path: str, **overrides) -> Config:
    """Programmatic entry: YAML file + keyword overrides (overrides win)."""
    data = load_yaml(resolve_config_path(path))
    data["config"] = resolve_config_path(path)
    data.update(overrides)
    return Config(**data)


def _flag(text: str) -> bool:
    import yaml

    value = yaml.safe_load(text)
    if not isinstance(value, bool):
        raise argparse.ArgumentTypeError(f"expected true or false, got {text!r}")
    return value


def make_arg_parser(description="RealPDEBench (PyTorch)") -> argparse.ArgumentParser:
    """The JAX package's shared CLI flags, plus ``--device``."""
    # no abbreviations: a key the parser does not know is a config override
    parser = argparse.ArgumentParser(description=description, allow_abbrev=False)
    parser.add_argument("--config", type=str, default="configs/cylinder/fno.yaml")
    parser.add_argument("--train_data_type", type=str, default="numerical",
                        help="numerical | real")
    # the JAX package's switches; here a bare ``--flag`` is true, as there,
    # and ``--flag true|false`` is taken too
    flag = dict(nargs="?", const=True, default=False, type=_flag)
    parser.add_argument("--is_finetune", help="enable finetuning mode", **flag)
    parser.add_argument("--use_hf_dataset",
                        help="Use the HuggingFace Arrow-backed dataset source", **flag)
    parser.add_argument("--hf_auto_download", **flag)
    parser.add_argument("--hf_repo_id", type=str,
                        default="AI4Science-WestlakeU/RealPDEBench")
    parser.add_argument("--hf_endpoint", type=str, default=None)
    parser.add_argument("--hf_revision", type=str, default=None)
    parser.add_argument("--mesh_shape", type=str, default=None,
                        help="only null (one device) is supported")
    parser.add_argument("--compute_dtype", type=str, default=None,
                        help="bfloat16 | float32 (default per-model policy)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) | cuda:N | cpu")
    return parser


def parse_overrides(rest: list) -> dict:
    """``--key value`` pairs (and bare ``--key`` flags, true) left over by
    ``parse_known_args``, as a dict of config overrides."""
    import yaml

    out, i = {}, 0
    while i < len(rest):
        tok = rest[i]
        if not tok.startswith("--") or len(tok) < 3:
            raise SystemExit(f"unexpected argument {tok!r}: config overrides "
                             "take the form --key value")
        if "=" in tok:
            key, text = tok[2:].split("=", 1)
            i += 1
        elif i + 1 < len(rest) and not rest[i + 1].startswith("--"):
            key, text = tok[2:], rest[i + 1]
            i += 2
        else:
            key, text = tok[2:], "true"
            i += 1
        out[key] = yaml.safe_load(text)
    return out


def parse_config(parser: argparse.ArgumentParser, argv=None) -> Config:
    """Parse ``argv`` with ``parser``, merge the YAML config under it, and
    apply the ``--key value`` overrides on top."""
    args, rest = parser.parse_known_args(argv)
    cfg = merge_config(args)
    overrides = parse_overrides(rest)
    return cfg.replace(**overrides) if overrides else cfg

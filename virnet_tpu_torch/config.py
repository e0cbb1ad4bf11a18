"""Config system: JSON-with-comments files + programmatic overrides
(counterpart of virnet_tpu/config.py; it reads the same configs/*.json).

Mirrors the reference's commentjson + argparse merge
(utils/util_opts.py:23-26) with a dependency-free comment stripper.  Boolean
values may be real JSON booleans or the reference's "True"/"False" strings —
both are accepted (the reference's str2bool quirk, utils/util_opts.py:9-15).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict


_LINE_COMMENT = re.compile(r'(?m)^\s*(#|//).*$')
_TRAILING_COMMENT = re.compile(
    r'(?m)(?<=[,\{\[\]\}0-9"elsu])\s*(#|//)[^"\n]*$')


def loads_commented_json(text: str) -> Dict[str, Any]:
    """Parse JSON allowing full-line and trailing '#'/'//' comments."""
    text = _LINE_COMMENT.sub("", text)
    text = _TRAILING_COMMENT.sub("", text)
    return json.loads(text)


def load_config(path) -> Dict[str, Any]:
    return loads_commented_json(Path(path).read_text())


def as_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        if v.lower() in ("true", "yes", "1"):
            return True
        if v.lower() in ("false", "no", "0"):
            return False
    raise ValueError(f"cannot interpret {v!r} as bool")


def update_args(cfg: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Merge non-None overrides over a config dict (argparse-style)."""
    out = dict(cfg)
    for k, v in overrides.items():
        if v is not None:
            out[k] = v
    return out

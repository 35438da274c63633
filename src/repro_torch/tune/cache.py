"""Persistent JSON tuning cache.

Port of ``repro/tune/cache.py``: the same schema, records and key
anatomy,

    <structural fingerprint> / <device kind> / <dtype policy> [/ extra]

* **structural fingerprint** -- ``formats.structural_fingerprint``: sha1
  of shape + indptr + indices, values excluded;
* **device kind** -- ``measure.device_kind(device)``: measurements do
  not transfer between cards (``torch-cuda:<name>`` or ``torch-cpu``);
* **dtype policy** -- the caller's storage precision contract
  (:func:`dtype_policy`);
* an optional trailing segment (a format restriction, a solver method).

The file is ``$REPRO_TORCH_TUNE_CACHE`` when set, else
``~/.cache/repro-torch-spmv/tune_cache.json`` -- not the reference's
file: both packages would otherwise store timings of different code
under the same CPU keys.  A corrupt or schema-mismatched file is an
empty cache, never an error; a record with an unknown ``schema`` stamp
or missing required keys is QUARANTINED (a miss, listed in
``cache.quarantined``), so it degrades to a re-measurement.
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
from typing import Optional

import numpy as np
import torch

__all__ = [
    "SCHEMA_VERSION",
    "RECORD_SCHEMA",
    "TuneCache",
    "default_cache",
    "cache_key",
    "dtype_policy",
]

SCHEMA_VERSION = 1
RECORD_SCHEMA = 1
_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def _default_path() -> pathlib.Path:
    env = os.environ.get(_ENV_VAR)
    if env:
        return pathlib.Path(env)
    return (pathlib.Path.home() / ".cache" / "repro-torch-spmv"
            / "tune_cache.json")


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if dt == "bfloat16":         # numpy knows the name only via ml_dtypes
        return "bfloat16"
    return np.dtype(dt).name


def dtype_policy(dtype, index_dtype) -> str:
    """Canonical string for the (value dtype, index dtype) storage
    contract, as the reference spells it: ``"native+auto"`` (default
    build) or ``"bfloat16+int16"``; torch and numpy dtypes (or their
    names) give the same string."""
    v = "native" if dtype is None else _dtype_name(dtype)
    i = "auto" if index_dtype == "auto" else _dtype_name(index_dtype)
    return f"{v}+{i}"


def cache_key(fingerprint: str, device: str, policy: str,
              extra: str = "") -> str:
    key = f"{fingerprint}/{device}/{policy}"
    return f"{key}/{extra}" if extra else key


class TuneCache:
    """Lazy-loading JSON key-value store for tuning decisions.

    ``get``/``put`` operate on plain JSON-serialisable dicts; ``put``
    persists at once by write-to-temp + ``os.replace``, so a crashed
    process never leaves a truncated cache behind."""

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = pathlib.Path(path) if path is not None \
            else _default_path()
        self._entries: Optional[dict] = None
        self.quarantined: dict = {}    # key -> reason, see module doc

    def _load(self) -> dict:
        if self._entries is None:
            self._entries = {}
            try:
                payload = json.loads(self.path.read_text())
                if payload.get("schema") == SCHEMA_VERSION:
                    self._entries = dict(payload.get("entries", {}))
            except (OSError, ValueError):
                pass
        return self._entries

    def get(self, key: str, require: tuple = ()) -> Optional[dict]:
        """Look ``key`` up; a malformed record -- not a dict, an unknown
        ``schema`` stamp, or missing any of the ``require``d keys -- is
        QUARANTINED: a miss (the caller re-measures and overwrites it),
        neither crashed on nor reused."""
        rec = self._load().get(key)
        if rec is None:
            return None
        reason = None
        if not isinstance(rec, dict):
            reason = f"record is {type(rec).__name__}, not a dict"
        elif rec.get("schema") != RECORD_SCHEMA:
            reason = f"unknown record schema {rec.get('schema')!r}"
        else:
            missing = [k for k in require if k not in rec]
            if missing:
                reason = f"missing keys {missing}"
        if reason is not None:
            self.quarantined[key] = reason
            return None
        return rec

    def put(self, key: str, record: dict) -> None:
        entries = self._load()
        entries[key] = {**record, "schema": RECORD_SCHEMA}
        self.quarantined.pop(key, None)
        self._flush()

    def clear(self) -> None:
        self._entries = {}
        self._flush()

    def __len__(self) -> int:
        return len(self._load())

    def _flush(self) -> None:
        payload = {"schema": SCHEMA_VERSION, "entries": self._entries}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


_DEFAULT: Optional[TuneCache] = None


def default_cache() -> TuneCache:
    """The process-wide cache at the default path (shared, so repeated
    ``tune="auto"`` calls load the file once; a changed
    ``$REPRO_TORCH_TUNE_CACHE`` gives a new instance)."""
    global _DEFAULT
    if _DEFAULT is None or _DEFAULT.path != _default_path():
        _DEFAULT = TuneCache()
    return _DEFAULT

"""Layered INI configuration, compatible with the reference's file format.

The reference's configuration surface (which grid settings and `.dataset`
files rely on) is an INI dialect with:

  - ``key = value`` lines, ``#`` comments;
  - ``INCLUDE(file)`` — splice another file's keys at lower precedence than
    keys in this file, and ``DEFAULT(file)`` — same but the included file's
    *own* includes resolve relative to it (reference: IniObjects.f90 and
    settings.f90:176-222 behavior);
  - macro expansion ``%DATASETDIR%``, ``%LOCALDIR%`` and user macros
    (reference: settings.f90:176-222);
  - tagged multi-instance keys ``name[tag] = value`` plus per-tag overrides
    ``name[tag,key] = value`` (reference: settings.f90:224-287, used for
    ``cmb_dataset[SPTSZ] = ...``);
  - every *read* key recorded so a provenance dump (`.inputparams`) can be
    written (reference: driver.F90:188-202).

Precedence: a key defined in the top file wins over any included file; among
includes, earlier DEFAULT/INCLUDE lines win over later ones (first
definition sticks once the parent has been read). This matches the
reference's "values already set are not overwritten by defaults" semantics.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

_INCLUDE_RE = re.compile(r"^(INCLUDE|DEFAULT)\s*\(\s*(.+?)\s*\)\s*$")


class IniError(Exception):
    pass


def _parse_bool(s: str) -> bool:
    t = s.strip().lower()
    if t in ("t", "true", "1", "y", "yes"):
        return True
    if t in ("f", "false", "0", "n", "no"):
        return False
    raise IniError(f"not a boolean: {s!r}")


class IniFile:
    """An in-memory key->string mapping with typed accessors and provenance."""

    def __init__(self, path: Optional[str] = None, keys: Optional[Dict[str, str]] = None,
                 search_dirs: Optional[List[str]] = None, macros: Optional[Dict[str, str]] = None):
        self.params: Dict[str, str] = {}
        self.read_values: Dict[str, str] = {}  # provenance of every accessed key
        self.original_file: Optional[str] = path
        self.search_dirs: List[str] = list(search_dirs or [])
        self.macros: Dict[str, str] = dict(macros or {})
        if path is not None:
            self._read_file(path, override=False)
        if keys:
            for k, v in keys.items():
                self.params[k] = str(v)

    # ---------- file reading ----------

    def _resolve(self, fname: str, rel_to: Optional[str]) -> str:
        cands = []
        if os.path.isabs(fname):
            cands.append(fname)
        else:
            if rel_to:
                cands.append(os.path.join(os.path.dirname(rel_to), fname))
            cands.append(fname)
            cands.extend(os.path.join(d, fname) for d in self.search_dirs)
        for c in cands:
            if os.path.isfile(c):
                return c
        raise IniError(f"included file not found: {fname!r} (searched {cands})")

    def _read_file(self, path: str, override: bool) -> None:
        """Read `path`; keys already present always win (defaults semantics)."""
        pending_includes: List[Tuple[str, str]] = []
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#") or line.startswith(";"):
                    continue
                m = _INCLUDE_RE.match(line)
                if m:
                    pending_includes.append((m.group(1), m.group(2)))
                    continue
                if "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key = key.strip()
                # strip trailing comment (reference allows '#...' after value)
                val = val.split("#", 1)[0].strip()
                if key and key not in self.params:
                    self.params[key] = val
        # includes are lower-precedence: read after this file's own keys
        for _kind, fname in pending_includes:
            self._read_file(self._resolve(fname, path), override=False)

    # ---------- macros ----------

    def expand(self, value: str) -> str:
        out = value
        for name, repl in self.macros.items():
            out = out.replace(f"%{name}%", repl)
        return out

    # ---------- typed access ----------

    def has_key(self, key: str) -> bool:
        return key in self.params

    __contains__ = has_key

    def _get(self, key: str, default: Any, required: bool) -> Optional[str]:
        if key in self.params:
            v = self.expand(self.params[key])
            self.read_values[key] = v
            return v
        if required:
            raise IniError(f"missing required ini key: {key!r}"
                           + (f" in {self.original_file}" if self.original_file else ""))
        if default is not None:
            self.read_values[key] = str(default)
        return None

    def string(self, key: str, default: Optional[str] = None, required: bool = False) -> Optional[str]:
        v = self._get(key, default, required)
        return v if v is not None else default

    def int(self, key: str, default: Optional[int] = None, required: bool = False) -> Optional[int]:
        v = self._get(key, default, required)
        return int(v) if v is not None and v != "" else default

    def float(self, key: str, default: Optional[float] = None, required: bool = False) -> Optional[float]:
        v = self._get(key, default, required)
        return float(v) if v is not None and v != "" else default

    def bool(self, key: str, default: Optional[bool] = None, required: bool = False) -> Optional[bool]:
        v = self._get(key, default, required)
        return _parse_bool(v) if v is not None and v != "" else default

    def float_list(self, key: str, default: Optional[List[float]] = None) -> Optional[List[float]]:
        v = self._get(key, None, False)
        if v is None:
            return default
        return [float(x) for x in v.split()]

    def string_list(self, key: str, default: Optional[List[str]] = None,
                    required: bool = False) -> Optional[List[str]]:
        v = self._get(key, None, required)
        if v is None:
            return default
        return v.split()

    # ---------- tagged keys: name[tag] = ..., name[tag,key] = ... ----------

    def tags(self, base: str) -> List[str]:
        """All tags T for which `base[T] =` is defined, in file order."""
        out = []
        pat = re.compile(re.escape(base) + r"\[([^,\]]+)\]$")
        for k in self.params:
            m = pat.match(k)
            if m:
                out.append(m.group(1))
        return out

    def tagged(self, base: str, tag: str) -> Optional[str]:
        return self.string(f"{base}[{tag}]")

    def tag_overrides(self, base: str, tag: str) -> Dict[str, str]:
        """All `base[tag,key] = value` entries as {key: value}."""
        out: Dict[str, str] = {}
        prefix = f"{base}[{tag},"
        for k, v in self.params.items():
            if k.startswith(prefix) and k.endswith("]"):
                out[k[len(prefix):-1].strip()] = self.expand(v)
        return out

    # ---------- provenance ----------

    def write_read_values(self, path: str, header: Iterable[str] = ()) -> None:
        """Dump every accessed key (the `.inputparams` provenance file)."""
        with open(path, "w", encoding="utf-8") as f:
            for line in header:
                f.write(f"# {line}\n")
            for k in sorted(self.read_values):
                f.write(f"{k} = {self.read_values[k]}\n")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IniFile":
        return cls(keys={k: str(v) for k, v in d.items()})

"""`.paramnames` registry: name, LaTeX label, derived flag.

File format (reference: source/ObjectParamNames.f90, files under the
reference's paramnames/ directory): one parameter per line,

    name[*]    latex label    # comment

a trailing ``*`` on the name marks a derived parameter. Ordering defines the
column order of chain files (after weight and -logL).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ParamInfo:
    name: str
    label: str = ""
    derived: bool = False
    comment: str = ""


class ParamNames:
    def __init__(self, names: Optional[List[ParamInfo]] = None):
        self.names: List[ParamInfo] = list(names or [])
        self._index: Dict[str, int] = {p.name: i for i, p in enumerate(self.names)}

    @classmethod
    def from_file(cls, path: str) -> "ParamNames":
        out = cls()
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                body, _, comment = line.partition("#")
                parts = body.split(None, 1)
                if not parts:
                    continue
                name = parts[0]
                label = parts[1].strip() if len(parts) > 1 else ""
                derived = name.endswith("*")
                if derived:
                    name = name[:-1]
                out.add(ParamInfo(name, label, derived, comment.strip()))
        return out

    def add(self, p: ParamInfo) -> None:
        if p.name in self._index:
            raise ValueError(f"duplicate parameter name {p.name!r}")
        self._index[p.name] = len(self.names)
        self.names.append(p)

    def merge(self, other: "ParamNames") -> None:
        """Append parameters from `other` not already present
        (reference: ObjectParamNames.f90:511 merging for nuisance blocks)."""
        for p in other.names:
            if p.name not in self._index:
                self.add(ParamInfo(p.name, p.label, p.derived, p.comment))

    def index(self, name: str) -> int:
        return self._index[name]

    def has(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self.names)

    def __iter__(self):
        return iter(self.names)

    def sampled(self) -> List[ParamInfo]:
        return [p for p in self.names if not p.derived]

    def derived(self) -> List[ParamInfo]:
        return [p for p in self.names if p.derived]

    def labels(self) -> List[str]:
        return [p.label for p in self.names]

    def write(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for p in self.names:
                star = "*" if p.derived else ""
                f.write(f"{p.name + star}\t{p.label}\n")

"""Typed device attributes for the KND resource model.

DRA distinguishes *attributes* (qualitative: strings, bools, versions,
ints) from *capacity* (quantitative: allocatable quantities). The paper's
core argument (§II) is that the legacy device-plugin model is *purely
quantitative* — a count — while topology-aware placement needs rich
qualitative attributes (PCI root, NUMA node, link speed). This module is
the typed substrate for both.

The port's own copy of the JAX package's ``core/attributes.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Quantities
# ---------------------------------------------------------------------------

_QUANTITY_SUFFIXES = {
    "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50,
    "m": 1e-3,  # milli (e.g. CPU millicores)
}

_QUANTITY_RE = re.compile(r"^(-?\d+(?:\.\d+)?)([A-Za-z]*)$")


@dataclass(frozen=True, order=False)
class Quantity:
    """A Kubernetes-style resource quantity ("16Gi", "50G", "8", "500m")."""

    value: float
    raw: str = ""

    @staticmethod
    def parse(s: Union[str, int, float, "Quantity"]) -> "Quantity":
        if isinstance(s, Quantity):
            return s
        if isinstance(s, (int, float)):
            return Quantity(float(s), str(s))
        m = _QUANTITY_RE.match(s.strip())
        if not m:
            raise ValueError(f"invalid quantity: {s!r}")
        num, suffix = m.groups()
        if suffix not in _QUANTITY_SUFFIXES:
            raise ValueError(f"invalid quantity suffix {suffix!r} in {s!r}")
        return Quantity(float(num) * _QUANTITY_SUFFIXES[suffix], s)

    def __float__(self) -> float:
        return self.value

    def __int__(self) -> int:
        return int(self.value)

    # comparisons against numbers or quantities
    def _coerce(self, other: Any) -> float:
        if isinstance(other, Quantity):
            return other.value
        if isinstance(other, (int, float)):
            return float(other)
        if isinstance(other, str):
            return Quantity.parse(other).value
        return NotImplemented  # type: ignore[return-value]

    def __eq__(self, other: Any) -> bool:
        c = self._coerce(other)
        return NotImplemented if c is NotImplemented else self.value == c

    def __lt__(self, other: Any) -> bool:
        return self.value < self._coerce(other)

    def __le__(self, other: Any) -> bool:
        return self.value <= self._coerce(other)

    def __gt__(self, other: Any) -> bool:
        return self.value > self._coerce(other)

    def __ge__(self, other: Any) -> bool:
        return self.value >= self._coerce(other)

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"Quantity({self.raw or self.value})"


# ---------------------------------------------------------------------------
# Semantic versions (DRA supports version-typed attributes)
# ---------------------------------------------------------------------------

_VERSION_RE = re.compile(r"^v?(\d+)\.(\d+)(?:\.(\d+))?")


@dataclass(frozen=True)
class Version:
    major: int
    minor: int
    patch: int = 0

    @staticmethod
    def parse(s: str) -> "Version":
        m = _VERSION_RE.match(s.strip())
        if not m:
            raise ValueError(f"invalid version: {s!r}")
        return Version(int(m.group(1)), int(m.group(2)), int(m.group(3) or 0))

    def _tuple(self) -> Tuple[int, int, int]:
        return (self.major, self.minor, self.patch)

    def __lt__(self, other: "Version") -> bool:
        return self._tuple() < other._tuple()

    def __le__(self, other: "Version") -> bool:
        return self._tuple() <= other._tuple()

    def __gt__(self, other: "Version") -> bool:
        return self._tuple() > other._tuple()

    def __ge__(self, other: "Version") -> bool:
        return self._tuple() >= other._tuple()

    def __str__(self) -> str:
        return f"{self.major}.{self.minor}.{self.patch}"


# An attribute value is one of the CEL-representable scalars.
AttrValue = Union[bool, int, float, str, Version, Quantity, tuple]


def normalize_attr(v: Any) -> AttrValue:
    """Normalize arbitrary python values into attribute values."""
    if isinstance(v, (bool, int, float, str, Version, Quantity)):
        return v
    if isinstance(v, (list, tuple)):
        return tuple(normalize_attr(x) for x in v)
    raise TypeError(f"unsupported attribute value type: {type(v).__name__}")


@dataclass
class AttributeSet:
    """An ordered, typed mapping of attribute name -> value.

    Names are namespaced like DRA's ("repro.dev/pciRoot"); the short
    name (after the last '/') is also addressable for CEL ergonomics.
    """

    _attrs: Dict[str, AttrValue] = field(default_factory=dict)

    def set(self, name: str, value: Any) -> "AttributeSet":
        self._attrs[name] = normalize_attr(value)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        if name in self._attrs:
            return self._attrs[name]
        # short-name fallback: "pciRoot" matches "repro.dev/pciRoot"
        for full, v in self._attrs.items():
            if full.rsplit("/", 1)[-1] == name:
                return v
        return default

    def __contains__(self, name: str) -> bool:
        sentinel = object()
        return self.get(name, sentinel) is not sentinel

    def __getitem__(self, name: str) -> AttrValue:
        sentinel = object()
        v = self.get(name, sentinel)
        if v is sentinel:
            raise KeyError(name)
        return v  # type: ignore[return-value]

    def items(self) -> Iterator[Tuple[str, AttrValue]]:
        return iter(self._attrs.items())

    def as_dict(self) -> Dict[str, AttrValue]:
        return dict(self._attrs)

    def short_dict(self) -> Dict[str, AttrValue]:
        """Map with namespace prefixes stripped (last wins on collision)."""
        return {k.rsplit("/", 1)[-1]: v for k, v in self._attrs.items()}

    @staticmethod
    def of(mapping: Optional[Mapping[str, Any]] = None, **kwargs: Any) -> "AttributeSet":
        s = AttributeSet()
        for k, v in {**(dict(mapping) if mapping else {}), **kwargs}.items():
            s.set(k, v)
        return s

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._attrs.items())
        return f"AttributeSet({inner})"

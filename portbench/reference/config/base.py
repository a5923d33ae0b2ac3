"""Telescope-keyed parameter resolution.

The reference resolves every setting through ``get_par(par, tel)``: a plain
value applies to all telescopes, a dict is keyed by telescope name with a
prefix fallback (``'BG3'`` falls back to ``'BG'``) — see
reference buildref.py:3889-3906.  The same contract is kept here, on
top of a dataclass settings tree instead of mutable setting modules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


def get_par(par: Any, tel: str) -> Any:
    """Resolve a possibly telescope-keyed parameter for telescope ``tel``."""
    if isinstance(par, Mapping):
        if tel in par:
            return par[tel]
        # prefix fallback: BG2/BG3/BG4 -> BG
        for n in range(len(tel) - 1, 0, -1):
            key = tel[:n]
            if key in par:
                return par[key]
        raise KeyError(f"parameter has no entry for telescope {tel!r}: {par}")
    return par


@dataclasses.dataclass
class Settings:
    """Base class: ``resolve(name, tel)`` applies get_par to a field."""

    def resolve(self, name: str, tel: str) -> Any:
        return get_par(getattr(self, name), tel)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

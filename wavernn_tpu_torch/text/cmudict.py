"""CMU pronouncing dictionary parser (reference utils/text/cmudict.py)."""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from .symbols import ARPABET

_valid_symbol_set = set(ARPABET)
_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Word -> list of ARPAbet pronunciations."""

    def __init__(self, file_or_path, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        return self._entries.get(word.upper())


def _parse_cmudict(file) -> Dict[str, List[str]]:
    cmudict: Dict[str, List[str]] = {}
    for line in file:
        if len(line) and (line[0] >= "A" and line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            word = re.sub(_alt_re, "", parts[0])
            pronunciation = _get_pronunciation(parts[1])
            if pronunciation:
                cmudict.setdefault(word, []).append(pronunciation)
    return cmudict


def _get_pronunciation(s: str) -> Optional[str]:
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _valid_symbol_set:
            return None
    return " ".join(parts)

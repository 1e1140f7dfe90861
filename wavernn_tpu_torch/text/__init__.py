"""Text frontend: text -> symbol-id sequences (reference utils/text/__init__.py).

Supports inline ARPAbet in curly braces: "Turn left on {HH AW1 S} Street."
"""
from __future__ import annotations

import re
from typing import Iterable, List, Sequence

from .cleaners import CLEANERS
from .symbols import id_to_symbol, symbol_to_id, symbols

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def _clean_text(text: str, cleaner_names: Iterable[str]) -> str:
    for name in cleaner_names:
        cleaner = CLEANERS.get(name)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _should_keep(s: str) -> bool:
    return s in symbol_to_id and s not in ("_", "~")


def _symbols_to_sequence(syms: Iterable[str]) -> List[int]:
    return [symbol_to_id[s] for s in syms if _should_keep(s)]


def _arpabet_to_sequence(text: str) -> List[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def text_to_sequence(text: str, cleaner_names: Iterable[str]) -> List[int]:
    """Convert text to symbol ids; curly-brace spans are ARPAbet."""
    sequence: List[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: Sequence[int]) -> str:
    result = ""
    for sid in sequence:
        if sid in id_to_symbol:
            s = id_to_symbol[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


__all__ = ["text_to_sequence", "sequence_to_text", "symbols", "symbol_to_id",
           "id_to_symbol"]

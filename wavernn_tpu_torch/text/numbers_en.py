"""English number normalization (reference utils/text/numbers.py).

The reference leans on the ``inflect`` package; this is a self-contained
implementation of the subset of ``inflect.number_to_words`` behavior the
cleaners rely on (cardinals with comma-separated scale groups, hyphenated
tens, ordinals, two-digit year grouping with 'oh').
"""
from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = ["", " thousand", " million", " billion", " trillion",
           " quadrillion", " quintillion", " sextillion", " septillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + (f"-{_ONES[ones]}" if ones else "")


def _under_1000(n: int, andword: str = "") -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES[hundreds]} hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_under_100(rest))
    return " ".join(parts) if parts else _ONES[0]


def number_to_words(n: int, andword: str = "", zero: str = "zero",
                    group: int = 0) -> str:
    """Cardinal words for an integer, inflect-compatible for the cleaner's
    usage patterns."""
    if n < 0:
        return "minus " + number_to_words(-n, andword=andword, zero=zero, group=group)
    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            digits = "0" + digits
        pairs = [digits[i:i + 2] for i in range(0, len(digits), 2)]
        words = []
        for p in pairs:
            v = int(p)
            if v == 0:
                words.append(f"{zero} {zero}")
            elif p[0] == "0":
                words.append(f"{zero} {_ONES[v]}")
            else:
                words.append(_under_100(v))
        return ", ".join(words)
    if n == 0:
        return zero
    groups = []
    scale = 0
    while n > 0:
        n, chunk = divmod(n, 1000) if False else (n // 1000, n % 1000)
        if chunk:
            groups.append(_under_1000(chunk, andword) + _SCALES[scale])
        scale += 1
    return ", ".join(reversed(groups))


def ordinal_words(n: int) -> str:
    words = number_to_words(n)
    head, sep, last = words.rpartition(" ")
    hy_head, hy_sep, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_IRREGULAR:
        last = hy_head + hy_sep + _ORDINAL_IRREGULAR[hy_last]
    elif hy_last.endswith("y"):
        last = hy_head + hy_sep + hy_last[:-1] + "ieth"
    else:
        last = hy_head + hy_sep + hy_last + "th"
    return head + sep + last


# ---- cleaner-facing regex pipeline (numbers.py:8-76) ----------------------

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    elif dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    elif cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        elif 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        elif num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        else:
            return number_to_words(num, zero="oh", group=2).replace(", ", " ")
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text

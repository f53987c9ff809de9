"""Perl Unicode-property character classes for the Moses tokenizer.

The reference loads these as raw byte strings from ``data/perluniprops/``
and splices them into ``std::regex`` classes byte-wise
(``mosestokenizer.cpp:99-178``) — which silently breaks for
multi-byte UTF-8. Here the same canonical classes are embedded as inclusive
codepoint ranges (``_uniprops_data.py``) and compiled into proper Unicode
regex character classes.
"""

from __future__ import annotations

import functools

from . import _uniprops_data as _data

# Indic combining marks the Moses community adds to the alphabetic classes
# so indic scripts keep clusters together (viramas + nuktas).
_VIRAMAS = (
    0x94D, 0x9CD, 0xA4D, 0xACD, 0xB4D, 0xBCD, 0xC4D, 0xCCD, 0xD3B, 0xD3C,
    0xD4D, 0xEBA, 0x1039, 0x1714, 0x1BAB, 0xA8C4, 0xA8F3, 0xA8F4, 0xA953,
    0xAAF6, 0x10A3F, 0x11046, 0x110B9, 0x11133, 0x111C0, 0x11235, 0x112EA,
    0x1134D, 0x11442, 0x114C2, 0x115BF, 0x1163F, 0x116B6, 0x11839, 0x119E0,
    0x11A34, 0x11C3F, 0x11D45, 0x11D97, 0xDCA,
)
_NUKTAS = (
    0x93C, 0x9BC, 0xA3C, 0xABC, 0xAFD, 0xAFE, 0xAFF, 0xB3C, 0xCBC, 0x1C37,
    0x110BA, 0x11173, 0x111CA, 0x11236, 0x112E9, 0x1133C, 0x11446, 0x114C3,
    0x115C0, 0x116B7, 0x1183A, 0x11D42, 0x1E94A,
)


def _class_str(ranges, extra=()) -> str:
    """Inclusive (start, end) ranges -> regex character-class body string."""
    parts = []
    for a, b in ranges:
        ca = chr(a)
        if a == b:
            parts.append(_esc(ca))
        else:
            parts.append(f"{_esc(ca)}-{_esc(chr(b))}")
    parts.extend(_esc(chr(c)) for c in extra)
    return "".join(parts)


def _esc(ch: str) -> str:
    # escape regex-class metacharacters
    return "\\" + ch if ch in r"\^]-[" else ch


@functools.lru_cache(maxsize=None)
def char_class(name: str) -> str:
    """Regex class body for IsN/IsAlnum/IsSc/IsSo/IsAlpha/IsLower."""
    ranges = getattr(_data, name.upper() + "_RANGES")
    if name in ("IsAlnum", "IsAlpha"):
        return _class_str(ranges, extra=_VIRAMAS + _NUKTAS)
    return _class_str(ranges)


@functools.lru_cache(maxsize=None)
def char_set(name: str) -> frozenset:
    """Membership set of characters for a class (for predicates)."""
    ranges = getattr(_data, name.upper() + "_RANGES")
    chars = set()
    for a, b in ranges:
        chars.update(map(chr, range(a, b + 1)))
    if name in ("IsAlnum", "IsAlpha"):
        chars.update(map(chr, _VIRAMAS + _NUKTAS))
    return frozenset(chars)


def is_lower(text: str) -> bool:
    """True iff every char of `text` is in IsLower (empty string: True)."""
    return not set(text).difference(char_set("IsLower"))


def is_any_alpha(text: str) -> bool:
    """True iff any char of `text` is in IsAlpha."""
    return any(set(text).intersection(char_set("IsAlpha")))


# CJK block ranges (exclusive bounds semantics matching the Moses port:
# char in (start, end) strictly).
_CJK_RANGES = (
    (4352, 4607), (11904, 42191), (43072, 43135), (44032, 55215),
    (63744, 64255), (65072, 65103), (65381, 65500), (94208, 101119),
    (110592, 110895), (110960, 111359), (131072, 196607),
)


def is_cjk(ch: str) -> bool:
    cp = ord(ch)
    for start, end in _CJK_RANGES:
        if cp < end:
            return cp > start
    return False

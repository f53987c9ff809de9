"""Moses tokenizer / detokenizer (Unicode-aware reimplementation).

Implements the Moses tokenization pipeline the reference ports to C++
(``mosestokenizer.cpp:290-358`` / ``:360-466``) and that HF's
``BioGptTokenizer`` invokes with ``aggressive_dash_splits=True, escape=True``.
This is a fresh Python implementation against the Moses rule set (the regex
rules are the public Moses-decoder spec); it fixes the reference port's known
defects — byte-wise regex classes, the always-False lowercase check
(mosestokenizer.cpp:264), and the discarded XML-unescape result
(mosestokenizer.cpp:379) — while keeping identical token output on the
pipeline's supported languages.

Lineage note: the rule tables and their names (DEDUPLICATE_SPACE,
AGGRESSIVE_HYPHEN_SPLIT, COMMA_SEPARATE_*, the detokenizer's quote-pairing
state machine) deliberately track **sacremoses** — the public Python Moses
port used as this module's parity oracle (tests/test_tokenizer.py) — since
rule-for-rule identity is what the parity requirement forces. The Unicode
character classes here are codepoint-range based (tokenizer/uniprops.py)
rather than sacremoses' splatted literal sets.
"""

from __future__ import annotations

import re
from functools import lru_cache

from .uniprops import char_class, is_any_alpha, is_cjk, is_lower
from ._nbp_data import NONBREAKING_PREFIXES

_IsN = char_class("IsN")
_IsAlnum = char_class("IsAlnum")
_IsAlpha = char_class("IsAlpha")
_IsSc = char_class("IsSc")

# --- tokenizer rules -------------------------------------------------------

DEDUPLICATE_SPACE = re.compile(r"\s+")
ASCII_JUNK = re.compile(r"[\000-\037]")
PAD_NOT_ISALNUM = re.compile(r"([^" + _IsAlnum + r"\s\.'\`\,\-])")
AGGRESSIVE_HYPHEN_SPLIT = re.compile(r"([" + _IsAlnum + r"])\-(?=[" + _IsAlnum + r"])")
COMMA_SEPARATE_1 = re.compile(r"([^" + _IsN + r"])[,]")
COMMA_SEPARATE_2 = re.compile(r"[,]([^" + _IsN + r"])")
COMMA_SEPARATE_3 = re.compile(r"([" + _IsN + r"])[,]$")

EN_APOSTROPHE = [
    (re.compile(r"([^" + _IsAlpha + r"])[']([^" + _IsAlpha + r"])"), r"\1 ' \2"),
    (re.compile(r"([^" + _IsAlpha + _IsN + r"])[']([" + _IsAlpha + r"])"), r"\1 ' \2"),
    (re.compile(r"([" + _IsAlpha + r"])[']([^" + _IsAlpha + r"])"), r"\1 ' \2"),
    (re.compile(r"([" + _IsAlpha + r"])[']([" + _IsAlpha + r"])"), r"\1 '\2"),
    (re.compile(r"([" + _IsN + r"])[']([s])"), r"\1 '\2"),
]
FR_IT_APOSTROPHE = [
    (re.compile(r"([^" + _IsAlpha + r"])[']([^" + _IsAlpha + r"])"), r"\1 ' \2"),
    (re.compile(r"([^" + _IsAlpha + r"])[']([" + _IsAlpha + r"])"), r"\1 ' \2"),
    (re.compile(r"([" + _IsAlpha + r"])[']([^" + _IsAlpha + r"])"), r"\1 ' \2"),
    (re.compile(r"([" + _IsAlpha + r"])[']([" + _IsAlpha + r"])"), r"\1' \2"),
]
NON_SPECIFIC_APOSTROPHE = re.compile(r"\'")
TRAILING_DOT_APOSTROPHE = re.compile(r"\.' ?$")

ESCAPE_XML = [
    (re.compile(r"&"), "&amp;"),
    (re.compile(r"\|"), "&#124;"),
    (re.compile(r"<"), "&lt;"),
    (re.compile(r">"), "&gt;"),
    (re.compile(r"\'"), "&apos;"),
    (re.compile(r"\""), "&quot;"),
    (re.compile(r"\["), "&#91;"),
    (re.compile(r"]"), "&#93;"),
]
UNESCAPE_XML = [
    (re.compile(r"&bar;"), "|"),       # legacy Moses escapes first
    (re.compile(r"&#124;"), "|"),
    (re.compile(r"&lt;"), "<"),
    (re.compile(r"&gt;"), ">"),
    (re.compile(r"&bra;"), "["),
    (re.compile(r"&ket;"), "]"),
    (re.compile(r"&quot;"), '"'),
    (re.compile(r"&apos;"), "'"),
    (re.compile(r"&#91;"), "["),
    (re.compile(r"&#93;"), "]"),
    (re.compile(r"&amp;"), "&"),
]

_DOTMULTI_DOT = re.compile(r"DOTMULTI\.")
_DOTDOTMULTI = re.compile(r"DOTDOTMULTI")
_TOKEN_ENDS_WITH_PERIOD = re.compile(r"^(\S+)\.$")
_STARTS_WITH_DIGIT = re.compile(r"^[0-9]+")

# --- detokenizer rules -----------------------------------------------------

DETOK_HYPHEN = re.compile(r" \@\-\@ ")
ONE_SPACE = re.compile(r" {2,}")
IS_CURRENCY_SYMBOL = re.compile(r"^[" + _IsSc + r"\(\[\{\¿\¡]+$")
IS_PUNCT = re.compile(r"^[\,\.\?\!\:\;\\\%\}\]\)]+$")
IS_FR_PUNCT = re.compile(r"^[\?\!\:\;\\\%]$")
IS_ENGLISH_CONTRACTION = re.compile(r"^['][" + _IsAlpha + r"]")
IS_FRENCH_CONTRACTION = re.compile(r"[" + _IsAlpha + r"][']$")
STARTS_WITH_ALPHA = re.compile(r"^[" + _IsAlpha + r"]")
IS_OPEN_QUOTE = re.compile(r"^[\'\"„“`]+$")
_NORMALIZE_QUOTE = re.compile(r"^[„“”]+$")
_ENDS_WITH_S = re.compile(r"[s]$")


def replace_multidots(text: str) -> str:
    """Protect runs of dots ("..." etc.) from the dot-splitting rules."""
    text = re.sub(r"\.([\.]+)", r" DOTMULTI\1", text)
    while _DOTMULTI_DOT.search(text):
        text = re.sub(r"DOTMULTI\.([^\.])", r"DOTDOTMULTI \1", text)
        text = _DOTMULTI_DOT.sub("DOTDOTMULTI", text)
    return text


def restore_multidots(text: str) -> str:
    while _DOTDOTMULTI.search(text):
        text = _DOTDOTMULTI.sub("DOTMULTI.", text)
    return text.replace("DOTMULTI", ".")


def escape_xml(text: str) -> str:
    for pattern, repl in ESCAPE_XML:
        text = pattern.sub(repl, text)
    return text


def unescape_xml(text: str) -> str:
    for pattern, repl in UNESCAPE_XML:
        text = pattern.sub(repl, text)
    return text


@lru_cache(maxsize=None)
def _prefixes(lang: str) -> tuple[frozenset, frozenset]:
    """(nonbreaking prefixes, numeric-only prefixes) for a language.

    An empty/unknown lang merges every language's list with English last —
    the behavior the reference degrades to with its broken ``-l`` flag
    (mosestokenizer.cpp:17-26 with biogpt.cpp:992-993).
    """
    if lang in NONBREAKING_PREFIXES:
        entries = NONBREAKING_PREFIXES[lang]
    else:
        entries = []
        for lg, words in NONBREAKING_PREFIXES.items():
            if lg != "en":
                entries.extend(words)
        entries.extend(NONBREAKING_PREFIXES["en"])
    numeric = frozenset(
        e.rsplit(" ", 1)[0] for e in entries if e.endswith("#NUMERIC_ONLY#")
    )
    plain = frozenset(e.split(" ")[0] for e in entries)
    return plain, numeric


def handle_nonbreaking_prefixes(text: str, lang: str) -> str:
    """Split trailing dots off tokens unless the stem is an abbreviation."""
    tokens = text.split()
    prefixes, numeric_only = _prefixes(lang)
    n = len(tokens)
    for i, token in enumerate(tokens):
        m = _TOKEN_ENDS_WITH_PERIOD.search(token)
        if not m:
            continue
        prefix = m.group(1)
        if (
            ("." in prefix and is_any_alpha(prefix))
            or (prefix in prefixes and prefix not in numeric_only)
            or (i != n - 1 and tokens[i + 1] and is_lower(tokens[i + 1][0]))
        ):
            pass  # keep the dot attached
        elif (
            prefix in numeric_only
            and i + 1 < n
            and _STARTS_WITH_DIGIT.search(tokens[i + 1])
        ):
            pass  # numeric-only prefix followed by a number
        else:
            tokens[i] = prefix + " ."
    return " ".join(tokens)


def moses_tokenize(
    text: str,
    lang: str = "en",
    aggressive_dash_splits: bool = True,
    escape: bool = True,
) -> list[str]:
    """Tokenize a sentence with the Moses rules.

    Defaults match HF BioGptTokenizer's invocation (aggressive dash splits,
    XML escaping). The reference's ``moses_tokenize`` hard-codes both on
    (mosestokenizer.cpp:290-358).
    """
    text = DEDUPLICATE_SPACE.sub(" ", text)
    text = ASCII_JUNK.sub("", text)
    text = text.strip()
    text = PAD_NOT_ISALNUM.sub(r" \1 ", text)
    if aggressive_dash_splits:
        text = AGGRESSIVE_HYPHEN_SPLIT.sub(r"\1 @-@ ", text)
    text = replace_multidots(text)
    text = COMMA_SEPARATE_1.sub(r"\1 , ", text)
    text = COMMA_SEPARATE_2.sub(r" , \1", text)
    text = COMMA_SEPARATE_3.sub(r"\1 , ", text)
    if lang == "en":
        for pattern, repl in EN_APOSTROPHE:
            text = pattern.sub(repl, text)
    elif lang in ("fr", "it"):
        for pattern, repl in FR_IT_APOSTROPHE:
            text = pattern.sub(repl, text)
    else:
        text = NON_SPECIFIC_APOSTROPHE.sub(" ' ", text)
    text = handle_nonbreaking_prefixes(text, lang)
    text = DEDUPLICATE_SPACE.sub(" ", text).strip()
    text = TRAILING_DOT_APOSTROPHE.sub(" . ' ", text)
    text = restore_multidots(text)
    if escape:
        text = escape_xml(text)
    return text.split()


def moses_detokenize(tokens: list[str], lang: str = "en", unescape: bool = True) -> str:
    """Join Moses tokens back into running text.

    Implements the quote-pairing/shift state machine of the Moses
    detokenizer (reference port: mosestokenizer.cpp:360-466, with its
    XML-unescape no-op fixed).
    """
    text = " " + " ".join(tokens) + " "
    text = DETOK_HYPHEN.sub("-", text)
    if unescape:
        text = unescape_xml(text)

    quote_counts = {"'": 0, '"': 0, "``": 0, "`": 0, "''": 0}
    prepend_space = " "
    out = ""
    tokens = text.split()
    n = len(tokens)
    for i, token in enumerate(tokens):
        if is_cjk(token[0]) and lang != "ko":
            if i > 0 and is_cjk(tokens[i - 1][-1]):
                out += token
            else:
                out += prepend_space + token
            prepend_space = " "
        elif IS_CURRENCY_SYMBOL.search(token):
            out += prepend_space + token
            prepend_space = ""
        elif IS_PUNCT.search(token):
            if lang == "fr" and IS_FR_PUNCT.search(token):
                out += " "
            out += token
            prepend_space = " "
        elif lang == "en" and i > 0 and IS_ENGLISH_CONTRACTION.search(token):
            out += token
            prepend_space = " "
        elif (
            lang in ("fr", "it", "ga")
            and i <= n - 2
            and IS_FRENCH_CONTRACTION.search(token)
            and STARTS_WITH_ALPHA.search(tokens[i + 1])
        ):
            out += prepend_space + token
            prepend_space = ""
        elif IS_OPEN_QUOTE.search(token):
            normalized = '"' if _NORMALIZE_QUOTE.search(token) else token
            quote_counts.setdefault(normalized, 0)
            if quote_counts[normalized] % 2 == 0:
                if (
                    lang == "en"
                    and token == "'"
                    and i > 0
                    and _ENDS_WITH_S.search(tokens[i - 1])
                ):
                    out += token           # possessive: the Jones' house
                    prepend_space = " "
                else:
                    out += prepend_space + token
                    prepend_space = ""
                    quote_counts[normalized] += 1
            else:
                out += token
                prepend_space = " "
                quote_counts[normalized] += 1
        else:
            out += prepend_space + token
            prepend_space = " "

    out = ONE_SPACE.sub(" ", out)
    return out.strip()

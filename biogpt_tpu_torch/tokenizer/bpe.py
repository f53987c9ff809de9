"""Byte-pair encoding with the fairseq/BioGPT ``</w>`` word-end convention.

Greedy lowest-rank merge loop equivalent to the reference's ``bpe()``
(``bpe.cpp:20-91``): the word's last character carries a
``</w>`` marker, merges apply in rank order until no ranked pair remains,
and the literal newline special case is preserved.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

Pair = Tuple[str, str]


def get_pairs(word: Iterable[str]) -> set[Pair]:
    word = tuple(word)
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class BpeEncoder:
    """Applies BPE merges; caches per-word segmentations."""

    def __init__(self, merges: Iterable[Pair]):
        self.bpe_ranks: Dict[Pair, int] = {tuple(m): i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {}

    def __call__(self, token: str) -> str:
        """Return the space-joined BPE segmentation of one Moses token."""
        if not token:
            return token
        cached = self._cache.get(token)
        if cached is not None:
            return cached

        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        result = " ".join(word)
        if result == "\n  </w>":
            result = "\n</w>"
        self._cache[token] = result
        return result

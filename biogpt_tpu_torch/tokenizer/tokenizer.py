"""BioGPT text <-> token-id pipeline: Moses + BPE + vocabulary.

Equivalent of the reference's ``gpt_tokenize``/``gpt_decode``
(``biogpt.cpp:850-906``): Moses-tokenize, BPE-encode, map
subwords to ids with a leading ``</s>`` (id 2); decoding strips the BPE
``</w>`` markers and runs the Moses detokenizer.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from .bpe import BpeEncoder
from .moses import moses_detokenize, moses_tokenize

BOS_EOS_ID = 2  # </s> — fairseq BioGPT starts sequences with it
UNK_TOKEN = "<unk>"


class BioGptTokenizer:
    def __init__(
        self,
        token_to_id: Dict[str, int],
        merges: Iterable[Tuple[str, str]],
        lang: str = "en",
    ):
        self.token_to_id = dict(token_to_id)
        self.id_to_token = {i: t for t, i in self.token_to_id.items()}
        self.bpe = BpeEncoder(merges)
        self.lang = lang
        self.unk_id: Optional[int] = self.token_to_id.get(UNK_TOKEN)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_hf_files(cls, vocab_json: str | Path, merges_txt: str | Path, lang: str = "en"):
        """Build from HF ``vocab.json`` + ``merges.txt`` (convert.py inputs)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")[:-1]
        merges = [tuple(parts[:2]) for line in lines
                  if len(parts := line.split()) >= 2]
        return cls(vocab, merges, lang=lang)

    # -- encode -------------------------------------------------------------

    def tokenize_to_subwords(self, text: str) -> List[str]:
        """Moses + BPE, no id mapping (HF ``_tokenize`` equivalent)."""
        words = moses_tokenize(text, self.lang)
        subwords: List[str] = []
        for word in words:
            if word:
                subwords.extend(self.bpe(word).split(" "))
        return subwords

    def encode(
        self,
        text: str,
        add_bos: bool = True,
        drop_unknown: bool = False,
    ) -> List[int]:
        """Text -> ids, prefixed with ``</s>`` (id 2) like the reference.

        Unknown subwords map to ``<unk>`` by default; ``drop_unknown=True``
        reproduces the reference's skip-and-log behavior
        (``biogpt.cpp:866-870``).
        """
        ids: List[int] = [BOS_EOS_ID] if add_bos else []
        for sub in self.tokenize_to_subwords(text):
            tid = self.token_to_id.get(sub)
            if tid is not None:
                ids.append(tid)
            elif not drop_unknown and self.unk_id is not None:
                ids.append(self.unk_id)
        return ids

    # -- decode -------------------------------------------------------------

    def decode_tokens(self, tokens: List[str], skip_special_tokens: bool = True) -> str:
        """Subword strings -> text (reference ``gpt_decode`` semantics).

        ``skip_special_tokens`` drops <s>/<pad>/<unk> like HF decode;
        ``</s>`` always becomes a space (``biogpt.cpp:884``).
        """
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in ("<s>", "<pad>", UNK_TOKEN)]
        cleaned = [t.replace(" ", "").replace("</w>", " ").replace("</s>", " ")
                   for t in tokens]
        words = "".join(cleaned).split()
        return moses_detokenize(words, self.lang)

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        tokens = [self.id_to_token.get(i, UNK_TOKEN) for i in ids]
        return self.decode_tokens(tokens, skip_special_tokens=skip_special_tokens)

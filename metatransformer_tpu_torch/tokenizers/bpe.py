"""CLIP byte-level BPE: raw strings -> token ids, on the host.

Port of ``metatransformer_tpu/tokenizers/bpe.py``, this package's own
copy: the reference module holds no JAX, but importing it runs its
package's ``__init__``, which imports JAX. The algorithm (lowercase,
whitespace-collapse, byte-to-unicode mapping, end-of-word ``</w>`` marker,
ranked pair merges, ``<|startoftext|>`` / ``<|endoftext|>`` specials,
context length 77 with EOT-truncate) is driven by a merges file.

Without a merges file the tokenizer is pure byte-level (merges = ()),
which keeps the exact id layout for the 256+256 byte symbols and the two
specials, so raw strings still reach the text tower deterministically.

Deliberate deltas from openai/CLIP's simple_tokenizer, as the reference's:
- no ftfy pass (external dep); unicode is assumed well-formed,
- ``str.isalpha``/``str.isdigit`` stand in for the regex \\p{L}/\\p{N}
  classes (same result on ASCII and common unicode text).
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def bytes_to_unicode() -> Dict[int, str]:
    """Bijection byte -> printable unicode char (the GPT-2/CLIP scheme):
    visible latin ranges map to themselves, the rest shift to 256+k so
    every byte becomes a distinct printable character."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _word_split(text: str) -> List[str]:
    """CLIP's word pattern (contractions | letter runs | single digits |
    other non-space runs), as a scanner instead of a \\p{...} regex."""
    words: List[str] = []
    i, n = 0, len(text)

    def other_run(j: int) -> int:
        while (
            j < n
            and not text[j].isspace()
            and not text[j].isalpha()
            and not text[j].isdigit()
        ):
            j += 1
        return j

    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "'":
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    words.append(c)
                    i += len(c)
                    break
            else:
                j = other_run(i)
                words.append(text[i:j])
                i = j
            continue
        if ch.isalpha():
            j = i
            while j < n and text[j].isalpha():
                j += 1
            words.append(text[i:j])
            i = j
            continue
        if ch.isdigit():
            words.append(ch)
            i += 1
            continue
        j = other_run(i)
        words.append(text[i:j])
        i = j
    return words


def load_merges(path: str, limit: Optional[int] = None) -> Tuple[Tuple[str, str], ...]:
    """Read a merges file (plain or .gz; first line = version header).
    CLIP keeps the first 49152-256-2+1 merges; pass ``limit`` to match."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    lines = lines[1:]  # version header
    if limit is None:
        limit = 49152 - 256 - 2 + 1
    merges = []
    for line in lines[:limit]:
        parts = line.split()
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    return tuple(merges)


@dataclasses.dataclass
class CLIPBPE:
    """Byte-level BPE with CLIP's vocab layout:
    ids [0, 256) byte symbols, [256, 512) byte+``</w>`` symbols, then one
    id per merge, then ``<|startoftext|>``, ``<|endoftext|>``."""

    merges: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in self.merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(self.merges)}
        self._cache: Dict[str, Tuple[str, ...]] = {}

    @classmethod
    def from_file(cls, merges_path: str) -> "CLIPBPE":
        return cls(merges=load_merges(merges_path))

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_id(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_id(self) -> int:
        return self.encoder["<|endoftext|>"]

    def _bpe(self, word: str) -> Tuple[str, ...]:
        """Greedy ranked pair merging over one byte-mapped word; the last
        symbol carries the ``</w>`` end-of-word marker."""
        if word in self._cache:
            return self._cache[word]
        symbols: Tuple[str, ...] = tuple(word[:-1]) + (word[-1] + "</w>",)
        while len(symbols) > 1:
            pairs = set(zip(symbols[:-1], symbols[1:]))
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and (symbols[i], symbols[i + 1]) == best
                ):
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = tuple(merged)
        self._cache[word] = symbols
        return symbols

    def encode(self, text: str) -> List[int]:
        text = " ".join(text.split()).lower()  # whitespace_clean + lower
        ids: List[int] = []
        for word in _word_split(text):
            mapped = "".join(
                self.byte_encoder[b] for b in word.encode("utf-8")
            )
            ids.extend(self.encoder[s] for s in self._bpe(mapped))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(
            self.decoder[int(i)]
            for i in ids
            if int(i) not in (self.sot_id, self.eot_id, 0)
        )
        raw = bytes(self.byte_decoder[c] for c in text)
        return (
            raw.decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )

    def tokenize(
        self,
        texts: Sequence[str] | str,
        context_length: int = 77,
        truncate: bool = True,
    ) -> np.ndarray:
        """clip.tokenize semantics: [B, context_length] int32, SOT + ids +
        EOT, zero-padded; over-long inputs truncate with EOT last."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for r, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(
                        f"input {r} is {len(ids)} tokens "
                        f"(> {context_length})"
                    )
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[r, : len(ids)] = ids
        return out

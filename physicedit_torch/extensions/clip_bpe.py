"""CLIP byte-pair tokenizer (the open_clip SimpleTokenizer format), on the
standard library and NumPy alone (``physicedit_tpu/extensions/clip_bpe.py``).

The HPSv2 / CLIP preference scorers tokenize prompts with open_clip's
SimpleTokenizer over ``bpe_simple_vocab_16e6.txt.gz``:

- byte -> printable-unicode alphabet (the GPT-2 byte encoder),
- merge ranks from the gzip'd merge list (line 0 is a header; the CLIP
  vocab uses the first 49152-256-2 merges),
- per-word BPE with a ``</w>`` end-of-word marker,
- vocab = 256 byte symbols + 256 ``</w>`` variants + merged tokens +
  ``<|startoftext|>`` / ``<|endoftext|>`` (ids 49406/49407 at full size),
- ``tokenize()`` pads/truncates to the 77-token context with SOT/EOT.

The pre-tokenizer is open_clip's pattern, case-insensitive::

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

which needs the ``regex`` package for ``\\p{L}`` / ``\\p{N}``.
:func:`pre_tokenize` splits as that pattern does with a scanner over
``unicodedata`` categories instead (letters ``L*``, numbers ``N*``): the
alternatives are tried in order at each position and the first that matches
is taken, as a regex alternation does.  Two details of ``regex``'s
case-insensitive matching are kept: the literals' ``s`` also matches ``ſ``
(U+017F, which lowercasing keeps), and U+0345 (a combining mark that folds to
a Greek letter) matches no alternative, so it is skipped like whitespace.
Characters that Python's ``unicodedata`` does not assign (category ``Cn``)
count as symbols here; a newer ``regex`` may know some of them as letters.

Divergence note, kept from the JAX package: open_clip pipes text through
``ftfy.fix_text`` (mojibake repair); the same html-unescape + whitespace
clean-up is applied here and the mojibake pass is skipped (it affects only
malformed unicode inputs).
"""

from __future__ import annotations

import functools
import gzip
import html
import unicodedata

import numpy as np

SOT, EOT = "<|startoftext|>", "<|endoftext|>"
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# regex's simple case folding beyond str.lower() for the literals' letters
_FOLD = {"\u017f": "s"}
# matches none of the pattern's alternatives under regex's IGNORECASE
_UNMATCHED = {"\u0345"}


@functools.lru_cache()
def _bytes_to_unicode():
    """GPT-2 byte encoder: every byte maps to a printable unicode char."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _pairs(word):
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip()


def _kind(c: str) -> str:
    """"L" letter, "N" number, " " skipped (whitespace or U+0345), "P" other."""
    if c.isspace() or c in _UNMATCHED:
        return " "
    cat = unicodedata.category(c)
    return cat[0] if cat[0] in "LN" else "P"


def _literal_at(text: str, i: int, lit: str) -> bool:
    if i + len(lit) > len(text):
        return False
    return all(_FOLD.get(c, c) == want for c, want in zip(text[i:i + len(lit)], lit))


def pre_tokenize(text: str) -> list[str]:
    """The pieces open_clip's pattern finds in ``text`` (already cleaned and
    lowercased), in order."""
    kinds = [_kind(c) for c in text]
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((w for w in (SOT, EOT) + CONTRACTIONS if _literal_at(text, i, w)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = kinds[i]
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":         # [\p{L}]+ and [^\s\p{L}\p{N}]+ are runs, [\p{N}] one char
            while j < n and kinds[j] == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class ClipBpeTokenizer:
    """SimpleTokenizer-compatible encoder over a merge-list file.

    ``bpe_path``: the gzip'd merge list (header line + "a b" merge rows).
    ``max_merges`` defaults to the CLIP vocab budget (49152 - 256 - 2).
    """

    def __init__(self, bpe_path: str, max_merges: int | None = None):
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        budget = (49152 - 256 - 2) if max_merges is None else max_merges
        merges = [tuple(m.split()) for m in lines[1:budget + 1] if m.strip()]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.sot = self.encoder[SOT]
        self.eot = self.encoder[EOT]
        self._cache = {}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
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
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids = []
        for token in pre_tokenize(_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77) -> np.ndarray:
        """[SOT] ids [EOT], zero-padded/truncated: open_clip's tokenize()."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, :len(ids)] = ids
        return out

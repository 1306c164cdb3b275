"""CLIP's byte-level BPE tokenizer, read from a checkpoint directory.

Computes what `transformers`' `CLIPTokenizerFast` (the `tokenizers`
pipeline `AutoTokenizer.from_pretrained` builds from `vocab.json` and
`merges.txt`) returns for `tokenizer(texts, padding=True, truncation=True,
max_length=n)`, in this order:

  1. the special tokens (`<|startoftext|>`, `<|endoftext|>` and the others
     `special_tokens_map.json` names) are split out of the raw text and
     map to their ids;
  2. each other stretch is normalized: NFC, every run of Unicode
     White_Space turned into one space, lowercased one character at a time;
  3. pre-tokenized by ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
     (what no alternative matches, the spaces, is dropped). Stdlib `re` has
     no `\\p{...}`: the letter (L*) and number (N*) classes are built once
     at import from `unicodedata.category`;
  4. each piece's UTF-8 bytes go through GPT-2's `bytes_to_unicode` map;
  5. BPE: the piece's characters, the last with the `</w>` suffix, are
     merged by rank as `tokenizers` merges them (lowest rank first, then
     leftmost); a symbol outside the vocabulary becomes the unknown token;
  6. BOS + ids + EOS, the ids cut so the whole is at most `max_length`;
  7. padding to the longest sequence with the pad token, and the
     attention mask.

`transformers`' slow `CLIPTokenizer` differs from this where ftfy is
absent: its BasicTokenizer puts CJK ideographs in words of their own and
drops control characters (ROADMAP, known differences).
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from pathlib import Path

import numpy as np

# Unicode White_Space (what the pipeline's `\s` matches); Python's `\s`
# also takes U+001C..U+001F
_SPACE_CPS = [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
              0x2028, 0x2029, 0x202F, 0x205F, 0x3000]


def _class(cps) -> str:
    """A regex character-class body for the sorted code points `cps`."""
    out, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        out.append(f"\\U{cps[i]:08x}" if i == j else f"\\U{cps[i]:08x}-\\U{cps[j]:08x}")
        i = j + 1
    return "".join(out)


def _unicode_classes() -> tuple[str, str]:
    letters, numbers = [], []
    for cp in range(0x110000):
        cat = unicodedata.category(chr(cp))
        if cat[0] == "L":
            letters.append(cp)
        elif cat[0] == "N":
            numbers.append(cp)
    return _class(letters), _class(numbers)


_L, _N = _unicode_classes()
_S = _class(_SPACE_CPS)
_SPACE_RUN = re.compile(f"[{_S}]+")
_PIECE = re.compile(f"'s|'t|'re|'ve|'m|'ll|'d|[{_L}]+|[{_N}]|[^{_S}{_L}{_N}]+")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible map of the 256 byte values to printable characters."""
    bs = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
          *range(ord("®"), ord("ÿ") + 1)]
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHAR = bytes_to_unicode()


def normalize(text: str) -> str:
    """NFC, White_Space runs to one space, lowercase per character (so a
    final capital sigma lowers to σ, as `tokenizers` lowers it)."""
    text = _SPACE_RUN.sub(" ", unicodedata.normalize("NFC", text))
    return "".join(c.lower() for c in text)


def pre_tokenize(text: str) -> list[str]:
    """The normalized text's pieces, each in the byte-level alphabet."""
    return ["".join(_BYTE_CHAR[b] for b in m.encode("utf-8")) for m in _PIECE.findall(text)]


def _token(v) -> str | None:
    if isinstance(v, dict):
        return v.get("content")
    return v


class ClipTokenizer:
    """The BPE of one vocabulary and merge list, with CLIP's special tokens."""

    # the slow tokenizer reads this many merges and the fast one is built
    # from its table
    MAX_MERGES = 49152 - 256 - 2

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 bos="<|startoftext|>", eos="<|endoftext|>", unk="<|endoftext|>", pad=None):
        self.vocab = vocab
        self.bos_id, self.eos_id, self.unk_id = vocab[bos], vocab[eos], vocab[unk]
        self.pad_id = vocab[pad if pad is not None else eos]
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            try:
                self.merges[(vocab[a], vocab[b])] = (rank, vocab[a + b])
            except KeyError as e:
                raise ValueError(f"merge {a!r} {b!r} names a token outside the vocabulary: "
                                 f"{e.args[0]!r}") from None
        specials = sorted({bos, eos, unk, pad or eos}, key=len, reverse=True)
        self.special_ids = {s: vocab[s] for s in specials}
        self._special = re.compile("|".join(map(re.escape, specials)))
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_dir(cls, d: str | Path) -> ClipTokenizer:
        """Read `vocab.json`, `merges.txt` and the special tokens
        (`special_tokens_map.json`, else `tokenizer_config.json`, else CLIP's)."""
        d = Path(d)
        vocab = json.loads((d / "vocab.json").read_text(encoding="utf-8"))
        lines = (d / "merges.txt").read_text(encoding="utf-8").strip().split("\n")
        merges = [tuple(line.split()) for line in lines[1:cls.MAX_MERGES + 1]]
        special = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            if (d / name).is_file():
                doc = json.loads((d / name).read_text(encoding="utf-8"))
                special.update({k: _token(doc[k]) for k in
                                ("bos_token", "eos_token", "unk_token", "pad_token")
                                if doc.get(k) is not None})
        return cls(vocab, merges,
                   bos=special.get("bos_token", "<|startoftext|>"),
                   eos=special.get("eos_token", "<|endoftext|>"),
                   unk=special.get("unk_token", "<|endoftext|>"),
                   pad=special.get("pad_token"))

    def bpe(self, piece: str) -> list[int]:
        """One pre-tokenized piece's ids."""
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        syms = list(piece)
        syms[-1] += "</w>"
        ids = [self.vocab.get(s, self.unk_id) for s in syms]
        n = len(ids)
        nxt = list(range(1, n)) + [-1]
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j < 0:
                continue
            m = self.merges.get((ids[i], ids[j]))
            if m is None or m[1] != new:
                continue
            ids[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            if prv[i] >= 0:
                m = self.merges.get((ids[prv[i]], ids[i]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] >= 0:
                m = self.merges.get((ids[i], ids[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        out = [t for t, a in zip(ids, alive) if a]
        self._cache[piece] = out
        return out

    def encode(self, text: str) -> list[int]:
        """The text's ids without BOS and EOS."""
        ids, at = [], 0
        for m in self._special.finditer(text):
            ids += self._encode_plain(text[at:m.start()])
            ids.append(self.special_ids[m.group()])
            at = m.end()
        return ids + self._encode_plain(text[at:])

    def _encode_plain(self, text: str) -> list[int]:
        out = []
        for piece in pre_tokenize(normalize(text)):
            out += self.bpe(piece)
        return out

    def __call__(self, texts: list[str], max_length: int = 77) -> tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), int64 (N, T): BOS, at most
        max_length - 2 ids, EOS; right-padded to the longest row."""
        rows = [[self.bos_id] + self.encode(t)[:max(max_length - 2, 0)] + [self.eos_id]
                for t in texts]
        width = max(map(len, rows))
        ids = np.full((len(rows), width), self.pad_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask

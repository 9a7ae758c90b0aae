"""Whisper tokenizer: GPT-2-style byte-level BPE + Whisper special tokens.

The PyTorch port's own copy of `whisper_diarize_tpu/tokenizer.py`;
the port imports nothing of the JAX package.

The reference delegates tokenization to whisper.cpp's embedded vocabulary
(inside `ggml-{model}.bin`, consumed via FFI at `src/transcribe.rs:389`).
Here the tokenizer is a first-class component: it loads the HF `vocab.json`
+ `merges.txt` files shipped with `openai/whisper-*` checkpoints, and lays
out the special tokens exactly like OpenAI Whisper:

    base BPE vocab
    <|endoftext|> <|startoftranscript|> <|lang:xx|>*N <|translate|>
    <|transcribe|> <|startoflm|> <|startofprev|> <|nospeech|>
    <|notimestamps|> <|0.00|> ... <|30.00|>   (1501 timestamp tokens)

Multilingual v1/v2 checkpoints: base 50257, 99 languages (n_vocab 51865).
large-v3 / large-v3-turbo: base 50257, 100 languages (n_vocab 51866).
English-only checkpoints: base 50256, 99 languages (n_vocab 51864).

When no vocabulary files are available (e.g. air-gapped test environments),
`DebugTokenizer` provides a deterministic byte-level fallback with the same
special-token layout so the decode loop, timestamp rules and DTW path can be
exercised end-to-end without network access.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import regex as re

# Whisper's canonical language order (the key order of LANGUAGES in
# openai/whisper); language token i is <|LANGUAGES[i]|>. This matches the
# reference's language list (the reference crate's `src/utils.rs:75-87`) minus
# "auto", which is not a token.
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)

_BPE_PATTERN = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 reversible byte<->unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


@dataclass(frozen=True)
class SpecialTokens:
    """Resolved special-token ids for a checkpoint family."""

    base_vocab: int
    num_languages: int

    @property
    def eot(self) -> int:
        return self.base_vocab

    @property
    def sot(self) -> int:
        return self.base_vocab + 1

    def language_token(self, lang: str) -> int:
        try:
            idx = LANGUAGES.index(lang)
        except ValueError:
            raise KeyError(f"unknown language code: {lang!r}")
        if idx >= self.num_languages:
            raise KeyError(f"language {lang!r} not in this checkpoint's vocab")
        return self.sot + 1 + idx

    @property
    def translate(self) -> int:
        return self.sot + 1 + self.num_languages

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def sot_lm(self) -> int:
        return self.transcribe + 1

    @property
    def sot_prev(self) -> int:
        return self.sot_lm + 1

    @property
    def no_speech(self) -> int:
        return self.sot_prev + 1

    @property
    def no_timestamps(self) -> int:
        return self.no_speech + 1

    @property
    def timestamp_begin(self) -> int:
        return self.no_timestamps + 1

    @property
    def n_vocab(self) -> int:
        return self.timestamp_begin + 1501

    def is_timestamp(self, token_id: int) -> bool:
        return token_id >= self.timestamp_begin

    def timestamp_token(self, t_sec: float) -> int:
        """Quantize a time (0..30 s) to its timestamp token (20 ms grid)."""
        idx = int(round(t_sec / 0.02))
        idx = max(0, min(1500, idx))
        return self.timestamp_begin + idx

    def timestamp_value(self, token_id: int) -> float:
        return (token_id - self.timestamp_begin) * 0.02

    def language_of_token(self, token_id: int) -> Optional[str]:
        idx = token_id - (self.sot + 1)
        if 0 <= idx < self.num_languages:
            return LANGUAGES[idx]
        return None


def specials_for(multilingual: bool = True, num_languages: int = 99) -> SpecialTokens:
    base = 50257 if multilingual else 50256
    return SpecialTokens(base_vocab=base, num_languages=num_languages)


class WhisperTokenizer:
    """Byte-level BPE tokenizer with Whisper specials.

    Construct via `WhisperTokenizer.from_files(vocab.json, merges.txt)` (HF
    checkpoint layout) or `from_pretrained_dir` pointing at a downloaded
    snapshot directory.
    """

    def __init__(
        self,
        encoder: Dict[str, int],
        bpe_ranks: Dict[Tuple[str, str], int],
        multilingual: bool = True,
        num_languages: int = 99,
    ):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = bpe_ranks
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.multilingual = multilingual
        self.specials = specials_for(multilingual, num_languages)
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def from_files(
        cls,
        vocab_path: str,
        merges_path: str,
        multilingual: bool = True,
        num_languages: int = 99,
    ) -> "WhisperTokenizer":
        with open(vocab_path, "r", encoding="utf-8") as f:
            encoder = json.load(f)
        ranks: Dict[Tuple[str, str], int] = {}
        with open(merges_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                ranks[(a, b)] = len(ranks)
        return cls(encoder, ranks, multilingual, num_languages)

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "WhisperTokenizer":
        """Load from an `openai/whisper-*` snapshot dir (vocab.json +
        merges.txt + config.json for vocab size detection)."""
        vocab = os.path.join(path, "vocab.json")
        merges = os.path.join(path, "merges.txt")
        cfg_path = os.path.join(path, "config.json")
        multilingual, num_languages = True, 99
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            vs = int(cfg.get("vocab_size", 51865))
            if vs == 51864:
                multilingual, num_languages = False, 99
            elif vs == 51866:
                multilingual, num_languages = True, 100
        return cls.from_files(vocab, merges, multilingual, num_languages)

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> Tuple[str, ...]:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token)
        if not word:
            return ()
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 62))
            if best not in self.bpe_ranks:
                break
            a, b = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
        out = tuple(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _BPE_PATTERN.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder[piece])
        return ids

    def decode_token(self, token_id: int) -> str:
        """Decode a single (non-special) token id to text."""
        piece = self.decoder.get(token_id)
        if piece is None:
            return ""
        data = bytes(self.byte_decoder[c] for c in piece)
        return data.decode("utf-8", errors="replace")

    def decode_tokens_bytes(self, ids: Sequence[int]) -> bytes:
        parts = []
        for i in ids:
            piece = self.decoder.get(int(i))
            if piece is None:
                continue
            parts.append(bytes(self.byte_decoder[c] for c in piece))
        return b"".join(parts)

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        text_ids = [
            int(i)
            for i in ids
            if not (skip_special and int(i) >= self.specials.eot)
        ]
        return self.decode_tokens_bytes(text_ids).decode("utf-8", errors="replace")

    # -- whisper decode prompts --------------------------------------------
    def sot_sequence(
        self,
        task: str = "transcribe",
        language: Optional[str] = "en",
        no_timestamps: bool = False,
    ) -> List[int]:
        sp = self.specials
        seq = [sp.sot]
        if self.multilingual:
            seq.append(sp.language_token(language or "en"))
            seq.append(sp.translate if task == "translate" else sp.transcribe)
        if no_timestamps:
            seq.append(sp.no_timestamps)
        return seq

    @property
    def n_vocab(self) -> int:
        return self.specials.n_vocab

    def non_speech_tokens(self) -> List[int]:
        """Token ids whose text is bracketed noise/symbols, suppressed during
        sampling like openai-whisper's `suppress_tokens=\"-1\"` default."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + [
            "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"",
            "((", "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪",
        ]
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for t in [" -", " '"]:
            ids = self.encode(t)
            if len(ids) == 1:
                result.add(ids[0])
        for symbol in symbols + list(miscellaneous):
            for tok in [symbol, " " + symbol]:
                ids = self.encode(tok)
                if len(ids) == 1:
                    result.add(ids[0])
        return sorted(result)


class DebugTokenizer:
    """Deterministic byte-level tokenizer with the Whisper special layout.

    Token id i (0..255) is raw byte i; ids 256..base_vocab-1 are unused.
    Lets every decode/DTW/formatting path run without vocabulary files
    (there is no network in CI). Interface-compatible subset of
    `WhisperTokenizer`.
    """

    def __init__(self, multilingual: bool = True, num_languages: int = 99):
        self.multilingual = multilingual
        self.specials = specials_for(multilingual, num_languages)
        self._bpe_cache: Dict[str, Tuple[str, ...]] = {}

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode_token(self, token_id: int) -> str:
        if 0 <= token_id < 256:
            return bytes([token_id]).decode("utf-8", errors="replace")
        return ""

    def decode_tokens_bytes(self, ids: Sequence[int]) -> bytes:
        return bytes(int(i) for i in ids if 0 <= int(i) < 256)

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        text_ids = [
            int(i)
            for i in ids
            if int(i) < 256 or not skip_special
        ]
        return self.decode_tokens_bytes(text_ids).decode("utf-8", errors="replace")

    def sot_sequence(
        self,
        task: str = "transcribe",
        language: Optional[str] = "en",
        no_timestamps: bool = False,
    ) -> List[int]:
        sp = self.specials
        seq = [sp.sot]
        if self.multilingual:
            seq.append(sp.language_token(language or "en"))
            seq.append(sp.translate if task == "translate" else sp.transcribe)
        if no_timestamps:
            seq.append(sp.no_timestamps)
        return seq

    @property
    def n_vocab(self) -> int:
        return self.specials.n_vocab

    def non_speech_tokens(self) -> List[int]:
        return []


class VocabTokenizer:
    """Tokenizer built from a raw id -> bytes table (the vocabulary embedded
    in whisper.cpp GGML files — the reference's checkpoint format carries no
    merges, `model_manager.rs:162`).

    Decoding — what transcription needs — is exact. `encode` (used only to
    tokenize prompt text for conditioning) is greedy longest-match over the
    byte table; it may split differently from true BPE, which is harmless
    for prompts. Interface-compatible with `WhisperTokenizer`.
    """

    def __init__(self, vocab: Sequence[bytes], multilingual: bool = True,
                 num_languages: int = 99):
        self.multilingual = multilingual
        self.specials = specials_for(multilingual, num_languages)
        self._table: List[bytes] = [bytes(v) for v in vocab]
        self._lookup = {}
        for i, b in enumerate(self._table):
            self._lookup.setdefault(b, i)  # first id wins on duplicates
        self._max_len = max((len(b) for b in self._table), default=1)

    def encode(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        ids: List[int] = []
        i = 0
        while i < len(data):
            for ln in range(min(self._max_len, len(data) - i), 0, -1):
                tid = self._lookup.get(data[i: i + ln])
                if tid is not None:
                    ids.append(tid)
                    i += ln
                    break
            else:
                i += 1  # unencodable byte: skip
        return ids

    def decode_token(self, token_id: int) -> str:
        if 0 <= token_id < len(self._table):
            return self._table[token_id].decode("utf-8", errors="replace")
        return ""

    def decode_tokens_bytes(self, ids: Sequence[int]) -> bytes:
        return b"".join(
            self._table[int(i)] for i in ids if 0 <= int(i) < len(self._table)
        )

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        text_ids = [
            int(i) for i in ids
            if not (skip_special and int(i) >= self.specials.eot)
        ]
        return self.decode_tokens_bytes(text_ids).decode("utf-8", errors="replace")

    def sot_sequence(
        self,
        task: str = "transcribe",
        language: Optional[str] = "en",
        no_timestamps: bool = False,
    ) -> List[int]:
        sp = self.specials
        seq = [sp.sot]
        if self.multilingual:
            seq.append(sp.language_token(language or "en"))
            seq.append(sp.translate if task == "translate" else sp.transcribe)
        if no_timestamps:
            seq.append(sp.no_timestamps)
        return seq

    @property
    def n_vocab(self) -> int:
        return self.specials.n_vocab

    def non_speech_tokens(self) -> List[int]:
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        result = set()
        for sym in symbols:
            for tok in (sym, " " + sym):
                tid = self._lookup.get(tok.encode("utf-8"))
                if tid is not None:
                    result.add(tid)
        return sorted(result)


def load_tokenizer(model_dir: Optional[str], multilingual: bool = True,
                   num_languages: int = 99):
    """Load the real tokenizer from a checkpoint dir when available, else the
    byte-level debug fallback."""
    if model_dir and os.path.exists(os.path.join(model_dir, "vocab.json")):
        return WhisperTokenizer.from_pretrained_dir(model_dir)
    return DebugTokenizer(multilingual=multilingual, num_languages=num_languages)

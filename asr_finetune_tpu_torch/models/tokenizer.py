"""Whisper tokenizer: GPT2-style byte-level BPE + special-token layout.

Capability parity with the reference's use of HF `WhisperTokenizer` /
`WhisperProcessor` (finetune/training/models/whisper_models.py:24-42,
custom_seq2seq_trainers.py:61-72 `get_decoder_prompt_ids`), self-contained so
air-gapped clusters need only the vocab files (vocab.json + merges.txt from
any Whisper checkpoint directory), with a deterministic byte-level fallback
tokenizer for tests and vocab-less environments.

The PyTorch port keeps its own copy of this jax-free module (the port imports
nothing of asr_finetune_tpu); keep the two in step.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

# Whisper language order defines the language-token id layout:
# token id = first_language_token_id + index in this tuple.
LANGUAGES = (
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

LANGUAGE_ALIASES = {
    "english": "en", "german": "de", "french": "fr", "spanish": "es",
    "italian": "it", "dutch": "nl", "portuguese": "pt", "russian": "ru",
    "chinese": "zh", "japanese": "ja", "korean": "ko", "turkish": "tr",
    "polish": "pl", "arabic": "ar", "swedish": "sv", "czech": "cs",
    "ukrainian": "uk", "greek": "el", "danish": "da", "hungarian": "hu",
    "norwegian": "no", "finnish": "fi",
}


def language_index(language: str) -> int:
    lang = LANGUAGE_ALIASES.get(language.lower(), language.lower())
    try:
        return LANGUAGES.index(lang)
    except ValueError:
        raise ValueError(f"unknown language {language!r}") from None


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT2's reversible byte↔unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class SpecialTokens:
    """Special-token id layout (multilingual Whisper)."""

    def __init__(self, eot: int = 50257, sot: int = 50258,
                 first_language: int = 50259, n_languages: int = 99,
                 translate: int = 50358, transcribe: int = 50359,
                 no_timestamps: int = 50363, timestamp_begin: int = 50364):
        self.eot = eot
        self.sot = sot
        self.first_language = first_language
        self.n_languages = n_languages
        self.translate = translate
        self.transcribe = transcribe
        self.no_timestamps = no_timestamps
        self.timestamp_begin = timestamp_begin
        self.pad = eot

    @classmethod
    def for_vocab(cls, vocab_size: int) -> "SpecialTokens":
        if vocab_size >= 51866:  # large-v3 layout (adds <|yue|>)
            return cls(first_language=50259, n_languages=100, translate=50359,
                       transcribe=50360, no_timestamps=50364, timestamp_begin=50365)
        if vocab_size == 51864:  # English-only (.en): no language/task tokens
            return cls(eot=50256, sot=50257, first_language=50257,
                       n_languages=0, translate=50357, transcribe=50358,
                       no_timestamps=50362, timestamp_begin=50363)
        return cls()

    def language_token(self, language: str) -> int:
        if self.n_languages == 0:  # English-only layout has no language tokens
            return self.sot
        # mod keeps compact test layouts (n_languages=2) in range; identity
        # for the real 99/100-language layouts
        return self.first_language + language_index(language) % self.n_languages

    def is_special(self, token_id: int) -> bool:
        return token_id >= self.eot


class WhisperTokenizerBase:
    """Shared prompt/label construction; subclasses provide encode/decode."""

    special: SpecialTokens

    def prefix_tokens(self, language: str = "de", task: str = "transcribe",
                      predict_timestamps: bool = False) -> List[int]:
        """[sot, <|lang|>, <|task|>, (<|notimestamps|>)].

        The equivalent of `processor.get_decoder_prompt_ids(language, task)`
        the reference derives forced_decoder_ids from
        (custom_seq2seq_trainers.py:61-72).
        """
        sp = self.special
        if sp.n_languages == 0:
            # English-only (.en) layout: no language/task tokens exist;
            # HF forces only <|notimestamps|> (generation_config
            # forced_decoder_ids [(1, 50362)])
            toks = [sp.sot]
        else:
            toks = [sp.sot, sp.language_token(language),
                    sp.transcribe if task == "transcribe" else sp.translate]
        if not predict_timestamps:
            toks.append(sp.no_timestamps)
        return toks

    def forced_decoder_ids(self, language: str = "de", task: str = "transcribe",
                           predict_timestamps: bool = False):
        """HF-style [(position, token_id), ...] starting at position 1."""
        toks = self.prefix_tokens(language, task, predict_timestamps)[1:]
        return [(i + 1, t) for i, t in enumerate(toks)]

    def build_labels(self, text: str, language: str = "de",
                     task: str = "transcribe") -> List[int]:
        """Full label sequence: prefix + text tokens + <|endoftext|>."""
        return self.prefix_tokens(language, task) + self.encode(text) + [self.special.eot]

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = [i for i in ids if not self.special.is_special(i)]
        return self._decode_text(ids)

    def batch_decode(self, batch: Iterable[Iterable[int]],
                     skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    # subclass API
    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def _decode_text(self, ids: List[int]) -> str:
        raise NotImplementedError


class BPEWhisperTokenizer(WhisperTokenizerBase):
    """Byte-level BPE over vocab.json + merges.txt (real Whisper vocab)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[tuple],
                 special: Optional[SpecialTokens] = None):
        self.vocab = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.special = special or SpecialTokens.for_vocab(len(vocab) + 1501)
        self._cache: Dict[str, List[str]] = {}
        import regex  # ships with transformers
        self._pat = regex.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")

    @classmethod
    def from_dir(cls, path: str, special: Optional[SpecialTokens] = None):
        """Load from a checkpoint/tokenizer dir containing vocab.json+merges.txt."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                merges.append(tuple(line.split()))
        return cls(vocab, merges, special)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._pat.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self._bpe(mapped))
        return ids

    def _decode_text(self, ids: List[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace")


class ByteFallbackTokenizer(WhisperTokenizerBase):
    """Deterministic byte-level tokenizer: token id == byte value.

    Used by tests and vocab-less smoke runs; pairs with the `test-nano`
    model config (vocab 272 = 256 bytes + 16 special slots).
    """

    def __init__(self, special: Optional[SpecialTokens] = None):
        # compact layout: bytes 0..255, then eot=256, sot=257, langs 258/259,
        # translate=260, transcribe=261, no_timestamps=262, timestamps 263+
        self.special = special or SpecialTokens(
            eot=256, sot=257, first_language=258, n_languages=2,
            translate=260, transcribe=261, no_timestamps=262, timestamp_begin=263)

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def _decode_text(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def load_tokenizer(path: Optional[str] = None,
                   vocab_size: Optional[int] = None) -> WhisperTokenizerBase:
    """Real BPE tokenizer if vocab files exist at `path`, else byte fallback."""
    if path and os.path.exists(os.path.join(path, "vocab.json")):
        sp = SpecialTokens.for_vocab(vocab_size) if vocab_size else None
        return BPEWhisperTokenizer.from_dir(path, sp)
    return ByteFallbackTokenizer()

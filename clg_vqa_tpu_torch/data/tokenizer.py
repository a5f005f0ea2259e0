"""Tokenizers (own copy of clg_vqa_tpu/data/tokenizer.py:20-94).

The reference tokenizes with HF ``AutoTokenizer`` (XLM-R sentencepiece,
task_utils.py:468) and truncates as ``[t0] + t[1:-1][:max-2] + [t_last]``
(gqa_dataset_semantic_code_mix.py:629-630).

 - HFTokenizer: any HF tokenizer loaded from local files.
 - HashTokenizer: deterministic whitespace+hash tokenizer for tests and
   benchmarks (same special-token layout as XLM-R: bos=0, pad=1, eos=2).
"""
from __future__ import annotations

from typing import Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]:
        """Full encoding including BOS/EOS specials."""
        ...


def truncate_encoded(tokens: list[int], max_length: int) -> list[int]:
    """Reference truncation: keep first/last special, cap inner pieces."""
    return [tokens[0]] + tokens[1:-1][: max_length - 2] + [tokens[-1]]


def encode_padded(tok: Tokenizer, text: str, max_length: int
                  ) -> tuple[list[int], list[int], list[int]]:
    """tokens, input_mask, segment_ids — padded to max_length at the END
    with pad_id (gqa_dataset_semantic_code_mix.py:683-700)."""
    ids = truncate_encoded(tok.encode(text), max_length)
    n = len(ids)
    input_mask = [1] * n + [0] * (max_length - n)
    ids = ids + [tok.pad_id] * (max_length - n)
    segment_ids = [0] * max_length
    return ids, input_mask, segment_ids


class HFTokenizer:
    """HF tokenizer from a local directory (e.g. a downloaded
    xlm-roberta-base snapshot)."""

    def __init__(self, path_or_name: str):
        from transformers import AutoTokenizer
        self._t = AutoTokenizer.from_pretrained(path_or_name)
        self.bos_id = self._t.bos_token_id
        self.eos_id = self._t.eos_token_id
        self.pad_id = self._t.pad_token_id
        self.vocab_size = len(self._t)

    def encode(self, text: str) -> list[int]:
        return self._t.encode(text)

    def tokenize(self, text: str):
        return self._t.tokenize(text)

    def convert_tokens_to_ids(self, toks):
        return self._t.convert_tokens_to_ids(toks)


class HashTokenizer:
    """Deterministic test tokenizer: whitespace split, FNV-1a hash to vocab.
    Special ids match XLM-R (<s>=0, <pad>=1, </s>=2)."""

    bos_id, pad_id, eos_id = 0, 1, 2

    def __init__(self, vocab_size: int = 250002):
        self.vocab_size = vocab_size

    def _piece_id(self, piece: str) -> int:
        h = 2166136261
        for ch in piece.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return 3 + (h % (self.vocab_size - 3))

    def encode(self, text: str) -> list[int]:
        return ([self.bos_id]
                + [self._piece_id(p) for p in text.strip().split()]
                + [self.eos_id])

    def tokenize(self, text: str):
        return text.strip().split()

    def convert_tokens_to_ids(self, toks):
        return [self._piece_id(t) for t in toks]

"""String-item <-> sequential-integer-id tokenizer (port of
``bert4rec_tpu/tokenizers/simple_tokenizer.py``).

Ids are assigned sequentially from 0 in first-seen order; the vocab file
holds ``key|id`` lines; ``drop_tokens`` are dropped on detokenize. Arrays
and flat string lists are tokenized unique-first, in first-occurrence
order, without pandas (the JAX package uses ``pd.factorize``; the ids are
the same).
"""

import numbers
import os
import pathlib
from collections.abc import Iterable
from typing import Optional

import numpy as np

from bert4rec_tpu_torch.tokenizers.base_tokenizer import BaseTokenizer


class SimpleTokenizer(BaseTokenizer):
    """Converts a string to a unique sequential (numerical) id."""

    def __init__(self, vocab_file_path: Optional[pathlib.Path] = None,
                 extensible: bool = True):
        self._vocab: dict = {}
        self._inverse_vocab: dict = {}
        self._delimiter = "|"
        super().__init__(vocab_file_path=vocab_file_path, extensible=extensible)

    @property
    def identifier(self) -> str:
        return "simple"

    def get_vocab(self) -> list:
        return list(self._vocab.keys())

    def clear_vocab(self):
        self._vocab = {}
        self._inverse_vocab = {}
        self._vocab_size = 0

    # ------------------------------------------------------------------ #

    def tokenize(self, input, progress_bar: bool = False):
        if isinstance(input, bytes):
            input = input.decode("utf-8")
        if isinstance(input, str):
            return self._tokenize_string(input)
        if isinstance(input, np.ndarray):
            return self._tokenize_array(input)
        if isinstance(input, (list, tuple)) and input and all(
                isinstance(v, (str, bytes)) for v in input):
            return self._tokenize_array(
                np.asarray(input, dtype=object)).tolist()
        if isinstance(input, Iterable):
            return [self.tokenize(v) for v in input]
        raise ValueError(
            f"The provided argument of type {type(input)} is not supported")

    def _tokenize_string(self, string: str) -> int:
        if isinstance(string, bytes):
            string = string.decode("utf-8")
        token = self._vocab.get(string)
        if token is not None:
            return token
        if not self._extensible:
            raise RuntimeError(f'"{string}" is not known!')
        token = self._vocab_size
        self._vocab[string] = token
        self._inverse_vocab[token] = string
        self._vocab_size += 1
        return token

    def _tokenize_array(self, arr: np.ndarray):
        """Tokenize each unique value once, in first-occurrence order (the
        ids a sequential scan assigns), then map the whole array."""
        flat = arr.reshape(-1).tolist()
        if not flat:
            return np.zeros(arr.shape, dtype=np.int32)
        if any(v is None or (isinstance(v, float) and v != v) for v in flat):
            raise ValueError(
                "tokenize input contains null/NaN items; clean the item "
                "column before tokenizing")
        ids = {v: self.tokenize(v) for v in dict.fromkeys(flat)}
        return np.asarray([ids[v] for v in flat],
                          dtype=np.int32).reshape(arr.shape)

    # ------------------------------------------------------------------ #

    def detokenize(self, token, drop_tokens: Optional[list] = None,
                   progress_bar: bool = False):
        if isinstance(token, np.ndarray):
            token = token.tolist()
        if isinstance(token, numbers.Number):
            return self._detokenize_token(int(token), drop_tokens)
        if isinstance(token, Iterable):
            values = [self.detokenize(t, drop_tokens) for t in token]
            return [v for v in values if v is not None]
        raise ValueError(
            f"The provided argument of type {type(token)} is not supported")

    def _detokenize_token(self, token: int, drop_tokens: Optional[list] = None):
        value = self._inverse_vocab.get(token)
        if drop_tokens and value in drop_tokens:
            return None
        return value

    # ------------------------------------------------------------------ #
    # vocab file I/O — "key|id" lines
    # ------------------------------------------------------------------ #

    def import_vocab_from_file(self, vocab_file: pathlib.Path) -> bool:
        vocab_file = pathlib.Path(vocab_file)
        if not vocab_file.is_file():
            raise RuntimeError(f"No vocab file found at {vocab_file}.")

        self.clear_vocab()
        with open(vocab_file, "rb") as f:
            lines = f.readlines()
        if len(lines) <= 0:
            raise ValueError(f"Vocab file {vocab_file} has no lines.")
        first = lines[0].decode("utf-8")
        if self._delimiter not in first:
            raise ValueError(
                f'Vocab file {vocab_file} is missing the '
                f'"{self._delimiter}" delimiter on its first line.')
        if len(first.rstrip("\r\n").split(self._delimiter)) != 2:
            raise ValueError(
                f'Each line of {vocab_file} must be exactly one '
                f'"{self._delimiter}"-delimited key/id pair.')

        for line in lines:
            text = line.decode("utf-8").rstrip("\r\n")
            if not text:
                continue
            key, _, value = text.rpartition(self._delimiter)
            token = int(value)
            self._vocab[key] = token
            self._inverse_vocab[token] = key

        self._vocab_size = len(self._vocab)
        return True

    def export_vocab_to_file(self, file_path: pathlib.Path) -> bool:
        if len(self._vocab) <= 0:
            raise ValueError(
                "The vocab of the tokenizer is empty and therefore can't be "
                "written to a file.")
        with open(file_path, "wb") as f:
            for key, token in self._vocab.items():
                f.write(f"{key}{self._delimiter}{token}{os.linesep}"
                        .encode("utf-8"))
        return True

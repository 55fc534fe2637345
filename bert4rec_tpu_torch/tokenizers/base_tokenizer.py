"""Abstract tokenizer: item <-> integer-id vocabulary holder (port of
``bert4rec_tpu/tokenizers/base_tokenizer.py``)."""

import abc
import pathlib
from typing import Iterable, Optional


class BaseTokenizer(abc.ABC):
    """Holds an item->id vocabulary. When ``extensible`` is True, unknown
    items get new sequential ids on first sight; when False, tokenizing an
    unknown item raises."""

    def __init__(self, vocab_file_path: Optional[pathlib.Path] = None,
                 extensible: bool = True):
        self._extensible = extensible
        self._vocab_size = 0
        if vocab_file_path is not None:
            self.import_vocab_from_file(vocab_file_path)

    @property
    @abc.abstractmethod
    def identifier(self) -> str:
        ...

    @property
    def extensible(self) -> bool:
        return self._extensible

    def enable_extensibility(self):
        self._extensible = True

    def disable_extensibility(self):
        self._extensible = False

    def get_vocab_size(self) -> int:
        return self._vocab_size

    @abc.abstractmethod
    def get_vocab(self) -> Iterable:
        ...

    @abc.abstractmethod
    def clear_vocab(self):
        ...

    @abc.abstractmethod
    def tokenize(self, input, progress_bar: bool = False):
        ...

    @abc.abstractmethod
    def detokenize(self, token, drop_tokens: Optional[list] = None,
                   progress_bar: bool = False):
        ...

    def generate_vocab(self, source: Iterable) -> bool:
        """Fill the vocab by traversing ``source`` (any iterable of items)."""
        self.tokenize(source)
        return True

    @abc.abstractmethod
    def import_vocab_from_file(self, vocab_file: pathlib.Path) -> bool:
        ...

    @abc.abstractmethod
    def export_vocab_to_file(self, file_path: pathlib.Path) -> bool:
        ...

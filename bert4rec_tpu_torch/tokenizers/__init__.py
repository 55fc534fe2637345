"""Tokenizer factory (port of ``bert4rec_tpu/tokenizers/__init__.py``)."""

from typing import Union

from bert4rec_tpu_torch.tokenizers import tokenizer_utils
from bert4rec_tpu_torch.tokenizers.base_tokenizer import BaseTokenizer
from bert4rec_tpu_torch.tokenizers.simple_tokenizer import SimpleTokenizer

tokenizers_map = {
    "simple": SimpleTokenizer,
}


def get(identifier: Union[str, BaseTokenizer] = "simple",
        **kwargs) -> BaseTokenizer:
    """Resolve a tokenizer identifier (or pass an instance through)."""
    if isinstance(identifier, BaseTokenizer):
        return identifier
    if identifier in tokenizers_map:
        return tokenizers_map[identifier](**kwargs)
    raise ValueError(f"{identifier} is not a known tokenizer identifier!")


__all__ = ["BaseTokenizer", "SimpleTokenizer", "tokenizer_utils",
           "tokenizers_map", "get"]

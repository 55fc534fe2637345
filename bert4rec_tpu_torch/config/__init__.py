"""Shipped encoder configs — the port's own copy of the JAX package's 13
``bert4rec_train_configs/*.json`` files (per dataset x hidden size)."""

import json
import pathlib

from bert4rec_tpu_torch.models.config import BERT4RecConfig

CONFIG_DIR = pathlib.Path(__file__).parent / "bert4rec_train_configs"


def list_train_configs() -> list:
    return sorted(p.stem for p in CONFIG_DIR.glob("*.json"))


def load_train_config(name: str, vocab_size: int,
                      **overrides) -> BERT4RecConfig:
    """Load a shipped config by name (e.g. ``"ml-1m_128"``)."""
    path = CONFIG_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(
            f"No shipped train config {name!r}; available: "
            f"{list_train_configs()}")
    with open(path, encoding="utf-8") as f:
        return BERT4RecConfig.from_dict(json.load(f), vocab_size=vocab_size,
                                        **overrides)


__all__ = ["CONFIG_DIR", "list_train_configs", "load_train_config"]

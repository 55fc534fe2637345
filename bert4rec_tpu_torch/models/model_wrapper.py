"""Admin wrapper around a model (port of
``bert4rec_tpu/models/model_wrapper.py``): carries a ``_meta_config`` dict
``{model, tokenizer, last_trained, trained_on_dataset}``."""

from typing import Any


class ModelWrapper:

    def __init__(self, model: Any):
        self.model = model
        self._meta_config = {
            "model": type(model).__name__,
            "tokenizer": None,
            "last_trained": None,
            "trained_on_dataset": None,
        }

    def get_meta(self) -> dict:
        return dict(self._meta_config)

    def update_meta(self, updated_info: dict) -> None:
        self._meta_config.update(updated_info)

    def delete_keys_from_meta(self, keys) -> None:
        """Drops ``keys`` (one key, or a list of them) from the meta
        config; an absent key is ignored."""
        if isinstance(keys, str):
            keys = [keys]
        for key in keys:
            self._meta_config.pop(key, None)

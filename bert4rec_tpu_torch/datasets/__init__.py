"""Raw dataset acquisition (reference ``bert4rec/datasets/__init__.py:1-7``).
Port of ``bert4rec_tpu/datasets/__init__.py``."""

from bert4rec_tpu_torch.datasets.base_dataset import BaseDataset
from bert4rec_tpu_torch.datasets import dataset_utils
from bert4rec_tpu_torch.datasets.ml_1m import ML1M
from bert4rec_tpu_torch.datasets.ml_20m import ML20M
from bert4rec_tpu_torch.datasets.beauty import Beauty, load_beauty_2, load_beauty_3
from bert4rec_tpu_torch.datasets.steam import Steam, load_steam_2
from bert4rec_tpu_torch.datasets.reddit import Reddit

datasets_map = {
    "ml_1m": ML1M,
    "ml_20m": ML20M,
    "beauty": Beauty,
    "steam": Steam,
    "reddit": Reddit,
}


def get(identifier: str):
    if isinstance(identifier, type) and issubclass(identifier, BaseDataset):
        return identifier
    if identifier in datasets_map:
        return datasets_map[identifier]
    raise ValueError(f"{identifier} is not a known dataset identifier!")


__all__ = ["BaseDataset", "dataset_utils", "ML1M", "ML20M", "Beauty", "Steam",
           "Reddit", "load_beauty_2", "load_beauty_3", "load_steam_2",
           "datasets_map", "get"]

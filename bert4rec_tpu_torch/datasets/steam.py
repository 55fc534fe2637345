"""Steam dataset (reference ``bert4rec/datasets/steam.py``).

FeiSun pre-tokenized ``steam.txt`` of ``user_id item_id`` pairs (steam.py:18,
35-52).

Port of ``bert4rec_tpu/datasets/steam.py``.
"""

import pandas as pd

from bert4rec_tpu_torch.datasets import dataset_utils
from bert4rec_tpu_torch.datasets.base_dataset import BaseDataset
from bert4rec_tpu_torch.datasets.beauty import _parse_pair_file
from bert4rec_tpu_torch.utils import utils


class Steam(BaseDataset):
    source = "https://github.com/FeiSun/BERT4Rec/raw/master/data/steam.txt"
    dest = utils.get_data_dir() / "steam" / "ratings_steam_tokenized.txt"
    # byte size of the downloaded file (reference steam.py:24)
    download_size = 38226650

    @classmethod
    def is_available(cls) -> bool:
        return cls._size_gate()

    @classmethod
    def download(cls):
        dataset_utils.download(cls.source, cls.dest)

    @classmethod
    def extract_data(cls) -> pd.DataFrame:
        return _parse_pair_file(cls.dest, cls.load_n_records)


def load_steam_2(custom_filter=None) -> pd.DataFrame:
    """Alternative loader from the UCSD raw dump (steam.py:55-84)."""
    url = "http://jmcauley.ucsd.edu/data/steam/australian_users_items.json.gz"
    dest = utils.get_data_dir() / "steam" / "australian_users_items.json.gz"
    if not dest.exists():
        dataset_utils.download(url, dest)
    df = pd.read_json(dest, lines=True, compression="gzip")
    if custom_filter is not None:
        df = custom_filter(df)
    return df

"""Amazon Beauty dataset (reference ``bert4rec/datasets/beauty.py``).

Primary loader uses the FeiSun/BERT4Rec pre-tokenized ``beauty.txt`` of
``user_id item_id`` pairs per line (beauty.py:18, 35-51).

Port of ``bert4rec_tpu/datasets/beauty.py``.
"""

import pandas as pd

from bert4rec_tpu_torch.datasets import dataset_utils
from bert4rec_tpu_torch.datasets.base_dataset import BaseDataset
from bert4rec_tpu_torch.utils import utils


def _parse_pair_file(path, load_n_records=None,
                     user_col="user_id", item_col="item_id") -> pd.DataFrame:
    """Parse a whitespace-separated ``user item`` pair file.

    user ids are ints; item ids stay strings so the tokenizer can assign
    vocab entries (reference beauty.py:43-48).
    """
    users, items = [], []
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            if load_n_records is not None and i >= load_n_records:
                break
            parts = line.split()
            if len(parts) < 2:
                continue
            users.append(int(parts[0]))
            items.append(parts[1])
    return pd.DataFrame({user_col: users, item_col: items})


class Beauty(BaseDataset):
    source = "https://github.com/FeiSun/BERT4Rec/raw/master/data/beauty.txt"
    dest = utils.get_data_dir() / "beauty" / "ratings_beauty_tokenized.txt"
    # byte size of the downloaded file (reference beauty.py:24)
    download_size = 3912093

    @classmethod
    def is_available(cls) -> bool:
        return cls._size_gate()

    @classmethod
    def download(cls):
        dataset_utils.download(cls.source, cls.dest)

    @classmethod
    def extract_data(cls) -> pd.DataFrame:
        return _parse_pair_file(cls.dest, cls.load_n_records)


def load_beauty_2(custom_filter=None) -> pd.DataFrame:
    """Alternative loader from the SNAP raw review dump (beauty.py:54-88)."""
    url = ("http://snap.stanford.edu/data/amazon/productGraph/categoryFiles/"
           "reviews_Beauty.json.gz")
    dest = utils.get_data_dir() / "beauty" / "reviews_Beauty.json.gz"
    if not dataset_utils.check_availability_via_download_size(dest, 352748278):
        dataset_utils.download(url, dest)
    df = pd.read_json(dest, lines=True, compression="gzip")
    if custom_filter is not None:
        df = custom_filter(df)
    return df


def load_beauty_3(custom_filter=None) -> pd.DataFrame:
    """Alternative loader from the SNAP ratings csv (beauty.py:90-114)."""
    url = ("http://snap.stanford.edu/data/amazon/productGraph/categoryFiles/"
           "ratings_Beauty.csv")
    dest = utils.get_data_dir() / "beauty" / "ratings_Beauty.csv"
    if not dataset_utils.check_availability_via_download_size(dest, 82432164):
        dataset_utils.download(url, dest)
    df = pd.read_csv(dest, header=None,
                     names=["user_id", "item_id", "rating", "timestamp"])
    if custom_filter is not None:
        df = custom_filter(df)
    return df

"""Reddit comments dataset (reference ``bert4rec/datasets/reddit.py``).

Streams a zstd-compressed pushshift.io comment dump (reddit.py:49-58);
``filter_data`` drops ``[deleted]`` authors and items/users with fewer than
three occurrences (reddit.py:66-80).

Port of ``bert4rec_tpu/datasets/reddit.py``.
"""

import io
import json

import pandas as pd

from bert4rec_tpu_torch.datasets import dataset_utils
from bert4rec_tpu_torch.datasets.base_dataset import BaseDataset
from bert4rec_tpu_torch.utils import utils

try:
    import zstandard as zstd
except ImportError:  # zstandard is optional; only needed for this dataset
    zstd = None


class Reddit(BaseDataset):
    category = "comments"
    file_name = "RC_2011-01.zst"
    source = f"https://files.pushshift.io/reddit/{category}/{file_name}"
    dest = utils.get_data_dir() / "reddit" / category / file_name

    @classmethod
    def load_data(cls, category: str = "comments",
                  file_name: str = "RC_2011-01.zst") -> pd.DataFrame:
        cls.category = category
        cls.file_name = file_name
        cls.source = f"https://files.pushshift.io/reddit/{category}/{file_name}"
        cls.dest = utils.get_data_dir() / "reddit" / category / file_name
        return super().load_data()

    @classmethod
    def is_available(cls) -> bool:
        return cls.dest.exists()

    @classmethod
    def download(cls):
        dataset_utils.download(cls.source, cls.dest)

    @classmethod
    def extract_data(cls) -> pd.DataFrame:
        if zstd is None:
            raise ImportError(
                "The Reddit dataset requires the `zstandard` package for "
                "streaming decompression of pushshift dumps.")
        records = {}
        with open(cls.dest, "rb") as f:
            # cap window size to avoid memory blow-up on big dumps
            dctx = zstd.ZstdDecompressor(max_window_size=2147483648)
            reader = dctx.stream_reader(f)
            text = io.TextIOWrapper(reader, encoding="utf-8")
            for i, line in enumerate(text):
                if cls.load_n_records and i >= cls.load_n_records:
                    break
                records[i] = json.loads(line)
        return pd.DataFrame.from_dict(records, orient="index")

    @classmethod
    def filter_data(cls, df: pd.DataFrame) -> pd.DataFrame:
        df = df[df["author"] != "[deleted]"]
        item_counts = df.groupby("parent_id").size()
        df = df[df["parent_id"].isin(item_counts.index[item_counts >= 3])]
        user_counts = df.groupby("author").size()
        df = df[df["author"].isin(user_counts.index[user_counts >= 3])]
        return df

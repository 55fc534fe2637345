"""MovieLens-20M dataset (reference ``bert4rec/datasets/ml_20m.py``).

CSV variant of ML-1M; same output columns (ml_20m.py:38-47).

Port of ``bert4rec_tpu/datasets/ml_20m.py``.
"""

import pandas as pd

from bert4rec_tpu_torch.datasets import dataset_utils
from bert4rec_tpu_torch.datasets.base_dataset import BaseDataset
from bert4rec_tpu_torch.utils import utils


class ML20M(BaseDataset):
    source = "https://files.grouplens.org/datasets/movielens/ml-20m.zip"
    dest = utils.get_data_dir() / "ml-20m"
    # byte size of the fully unpacked dataset (reference ml_20m.py:27)
    download_size = 875588784

    @classmethod
    def is_available(cls) -> bool:
        return cls._size_gate()

    @classmethod
    def download(cls):
        dataset_utils.download_and_unpack_to_folder(
            cls.source, cls.dest, "zip", strip_top_level=True)

    @classmethod
    def extract_data(cls) -> pd.DataFrame:
        ratings = pd.read_csv(cls.dest / "ratings.csv", nrows=cls.load_n_records)
        ratings.columns = ["uid", "sid", "rating", "timestamp"]
        movies = pd.read_csv(cls.dest / "movies.csv", nrows=cls.load_n_records)
        movies.columns = ["sid", "movie_name", "categories"]
        return dataset_utils.join_movies(ratings, movies)

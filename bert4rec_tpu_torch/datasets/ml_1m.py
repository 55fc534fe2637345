"""MovieLens-1M dataset (reference ``bert4rec/datasets/ml_1m.py``).

Columns after extraction: ``uid, sid, rating, timestamp, movie_name,
categories`` (ml_1m.py:38-57).

Port of ``bert4rec_tpu/datasets/ml_1m.py``.
"""

import pandas as pd

from bert4rec_tpu_torch.datasets import dataset_utils
from bert4rec_tpu_torch.datasets.base_dataset import BaseDataset
from bert4rec_tpu_torch.utils import utils


class ML1M(BaseDataset):
    source = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"
    dest = utils.get_data_dir() / "ml-1m"
    # byte size of the fully unpacked dataset (reference ml_1m.py:27)
    download_size = 24905384

    @classmethod
    def is_available(cls) -> bool:
        return cls._size_gate()

    @classmethod
    def download(cls):
        dataset_utils.download_and_unpack_to_folder(
            cls.source, cls.dest, "zip", strip_top_level=True)

    @classmethod
    def extract_data(cls) -> pd.DataFrame:
        ratings = pd.read_csv(
            cls.dest / "ratings.dat", sep="::", header=None, engine="python",
            encoding="iso-8859-1", nrows=cls.load_n_records)
        ratings.columns = ["uid", "sid", "rating", "timestamp"]
        movies = pd.read_csv(
            cls.dest / "movies.dat", sep="::", header=None, engine="python",
            encoding="iso-8859-1", nrows=cls.load_n_records)
        movies.columns = ["sid", "movie_name", "categories"]
        return dataset_utils.join_movies(ratings, movies)

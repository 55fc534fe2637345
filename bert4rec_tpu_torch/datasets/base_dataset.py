"""Abstract raw dataset.

Same contract as reference ``bert4rec/datasets/base_dataset.py:9-61``:
classmethod-only API where ``load_data()`` orchestrates
``is_available() -> download() -> extract_data()`` and returns a
``pd.DataFrame``; ``load_n_records`` caps the number of records and
``set_load_n_records`` is daisy-chainable.

Port of ``bert4rec_tpu/datasets/base_dataset.py``.
"""

import abc
import os
from typing import Optional

import pandas as pd


class BaseDataset(abc.ABC):
    # concrete classes set these
    source: Optional[str] = None   # download URL
    dest: Optional[str] = None     # destination directory/file under the data dir
    download_size: Optional[int] = None  # full-corpus byte size (gate)
    load_n_records: Optional[int] = None

    @classmethod
    def set_load_n_records(cls, n: Optional[int]):
        """Cap the number of records returned by ``load_data`` (chainable)."""
        cls.load_n_records = n
        return cls

    @classmethod
    def _size_gate(cls) -> bool:
        """Availability = on-disk bytes within ±2% of the published
        full-corpus size (reference dataset_utils.py:37-51) — except
        under an active record cap, where the gate degrades to
        existence-only: a capped load declares up front that it will not
        consume the full corpus, so a partial-but-format-exact corpus
        (e.g. a synthetic test fixture) is exactly as available as the
        real thing. ``load_data`` resolves the ``BERT4REC_TPU_LOAD_N_RECORDS``
        env knob into class state before calling ``is_available``, so the
        env cap takes this path too."""
        from bert4rec_tpu_torch.datasets import dataset_utils
        if cls.load_n_records:
            return dataset_utils.get_byte_size(cls.dest) > 0
        return dataset_utils.check_availability_via_download_size(
            cls.dest, cls.download_size)

    @classmethod
    def load_data(cls) -> pd.DataFrame:
        # global smoke knob: ``BERT4REC_TPU_LOAD_N_RECORDS=<n>`` caps every
        # dataset that was not capped explicitly — this is how the example
        # scripts (full-corpus API surface) run offline in the test suite
        # on a synthetic corpus in minutes instead of hours. Resolved per
        # CALL and restored afterwards (subclass extract_data streams with
        # nrows=cls.load_n_records, so the cap is applied for the call's
        # duration only): unsetting the env var must restore full-corpus
        # loads in the same process, not leave a stale cap in class state
        n_records = cls.load_n_records
        if n_records is None:
            env = os.environ.get("BERT4REC_TPU_LOAD_N_RECORDS")
            if env:
                n_records = int(env)
        saved = cls.load_n_records
        cls.load_n_records = n_records
        try:
            if not cls.is_available():
                cls.download()
            df = cls.extract_data()
            if n_records is not None:
                df = df.head(n_records)
        finally:
            cls.load_n_records = saved
        return df

    @classmethod
    @abc.abstractmethod
    def is_available(cls) -> bool:
        ...

    @classmethod
    @abc.abstractmethod
    def download(cls):
        ...

    @classmethod
    @abc.abstractmethod
    def extract_data(cls) -> pd.DataFrame:
        ...

"""Per-dataset dataloaders (port of
``bert4rec_tpu/dataloaders/concrete_dataloaders.py``).

Mirrors the five reference subclasses (bert4rec_ml1m_dataloader.py etc.),
which differ only in hyperparameter defaults and dataframe column names —
captured here declaratively on one shared base.

Defaults (verified against the reference files):

=========  =======  ========  =====  ===  =======  ==========  ========  ===========
dataset    max_seq  max_pred  prob   dup  min_seq  sort_by     group_by  extract
=========  =======  ========  =====  ===  =======  ==========  ========  ===========
ML-1M      200      40        0.2    10   3        timestamp   uid       movie_name
ML-20M     200      40        0.2    5    3        timestamp   uid       movie_name
Beauty     50       30        0.6    5    3        (none)      user_id   item_id
Steam      50       20        0.4    3    3        (none)      user_id   item_id
Reddit     200      40        0.2    2    3        created_utc author    parent_id
=========  =======  ========  =====  ===  =======  ==========  ========  ===========
"""

from typing import Optional, Union

import pandas as pd

from bert4rec_tpu_torch import datasets, tokenizers
from bert4rec_tpu_torch.dataloaders import preprocessors
from bert4rec_tpu_torch.dataloaders.bert4rec_dataloader import BERT4RecDataloader


class _ConcreteBERT4RecDataloader(BERT4RecDataloader):
    """Shared implementation for dataset-specific dataloaders."""

    # subclasses set these
    _IDENTIFIER: str = None
    _DATA_SOURCE = None
    _SORT_BY: Optional[str] = None
    _GROUP_BY: str = None
    _EXTRACT: str = None
    _DEFAULTS: dict = {}

    def __init__(self,
                 max_seq_len: int = None,
                 max_predictions_per_seq: int = None,
                 tokenizer: Union[str, tokenizers.BaseTokenizer] = "simple",
                 data_source=None,
                 preprocessor=preprocessors.BERT4RecPreprocessor,
                 masked_lm_prob: float = None,
                 mask_token_rate: float = 1.0,
                 random_token_rate: float = 0.0,
                 input_duplication_factor: int = None,
                 min_sequence_len: int = None):
        d = self._DEFAULTS
        super().__init__(
            max_seq_len if max_seq_len is not None else d["max_seq_len"],
            max_predictions_per_seq if max_predictions_per_seq is not None
            else d["max_predictions_per_seq"],
            tokenizer,
            data_source if data_source is not None else self._DATA_SOURCE,
            preprocessor,
            masked_lm_prob if masked_lm_prob is not None else d["masked_lm_prob"],
            mask_token_rate,
            random_token_rate,
            input_duplication_factor if input_duplication_factor is not None
            else d["input_duplication_factor"],
            min_sequence_len if min_sequence_len is not None
            else d["min_sequence_len"])

    @property
    def dataset_identifier(self) -> str:
        return self._IDENTIFIER

    def load_data(self, split_data: bool = True, sort_by=None,
                  extract_data=None, duplication_factor=None, group_by=None,
                  datatypes=None) -> tuple:
        return super().load_data(
            split_data,
            sort_by if sort_by is not None else self._SORT_BY,
            extract_data if extract_data is not None else [self._EXTRACT],
            duplication_factor,
            group_by if group_by is not None else self._GROUP_BY)

    def get_data(self, split_data: bool = True, sort_by=None,
                 extract_data=None, duplication_factor=None, group_by=None,
                 apply_mlm: bool = True, finetuning_split: float = 0,
                 datatypes=None) -> tuple:
        return super().get_data(
            split_data,
            sort_by if sort_by is not None else self._SORT_BY,
            extract_data if extract_data is not None else [self._EXTRACT],
            duplication_factor,
            group_by if group_by is not None else self._GROUP_BY,
            apply_mlm,
            finetuning_split)

    def prepare_training(self, sort_by=None, extract_data=None, group_by=None,
                         finetuning_split: float = 0.1, datatypes=None) -> tuple:
        return super().prepare_training(
            sort_by if sort_by is not None else self._SORT_BY,
            extract_data if extract_data is not None else [self._EXTRACT],
            group_by if group_by is not None else self._GROUP_BY,
            finetuning_split)

    def _declared_columns(self) -> list:
        return [c for c in (self._GROUP_BY, self._SORT_BY, self._EXTRACT)
                if c is not None]

    def generate_vocab(self, source=None, progress_bar: bool = True) -> bool:
        if source is None:
            df = self._source_df([self._EXTRACT])
            # first-seen order (deterministic), unlike the reference's
            # arbitrary set() order — only size parity is contractual;
            # pd.unique is order-preserving at C speed (dict.fromkeys over
            # 20M strings cost ~30 s at ML-20M scale)
            source = pd.unique(df[self._EXTRACT]).tolist()
        return super().generate_vocab(source, progress_bar)

    def create_item_list(self) -> list:
        df = self._source_df([self._EXTRACT])
        return df[self._EXTRACT].to_list()


class BERT4RecML1MDataloader(_ConcreteBERT4RecDataloader):
    _IDENTIFIER = "ml_1m"
    _DATA_SOURCE = datasets.ML1M
    _SORT_BY = "timestamp"
    _GROUP_BY = "uid"
    _EXTRACT = "movie_name"
    _DEFAULTS = dict(max_seq_len=200, max_predictions_per_seq=40,
                     masked_lm_prob=0.2, input_duplication_factor=10,
                     min_sequence_len=3)


class BERT4RecML20MDataloader(_ConcreteBERT4RecDataloader):
    _IDENTIFIER = "ml_20m"
    _DATA_SOURCE = datasets.ML20M
    _SORT_BY = "timestamp"
    _GROUP_BY = "uid"
    _EXTRACT = "movie_name"
    _DEFAULTS = dict(max_seq_len=200, max_predictions_per_seq=40,
                     masked_lm_prob=0.2, input_duplication_factor=5,
                     min_sequence_len=3)


class BERT4RecBeautyDataloader(_ConcreteBERT4RecDataloader):
    _IDENTIFIER = "beauty"
    _DATA_SOURCE = datasets.Beauty
    _SORT_BY = None
    _GROUP_BY = "user_id"
    _EXTRACT = "item_id"
    _DEFAULTS = dict(max_seq_len=50, max_predictions_per_seq=30,
                     masked_lm_prob=0.6, input_duplication_factor=5,
                     min_sequence_len=3)


class BERT4RecSteamDataloader(_ConcreteBERT4RecDataloader):
    _IDENTIFIER = "steam"
    _DATA_SOURCE = datasets.Steam
    _SORT_BY = None
    _GROUP_BY = "user_id"
    _EXTRACT = "item_id"
    _DEFAULTS = dict(max_seq_len=50, max_predictions_per_seq=20,
                     masked_lm_prob=0.4, input_duplication_factor=3,
                     min_sequence_len=3)


class BERT4RecRedditDataloader(_ConcreteBERT4RecDataloader):
    _IDENTIFIER = "reddit"
    _DATA_SOURCE = datasets.Reddit
    _SORT_BY = "created_utc"
    _GROUP_BY = "author"
    _EXTRACT = "parent_id"
    _DEFAULTS = dict(max_seq_len=200, max_predictions_per_seq=40,
                     masked_lm_prob=0.2, input_duplication_factor=2,
                     min_sequence_len=3)

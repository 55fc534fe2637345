"""Generic BERT4Rec dataloader (port of
``bert4rec_tpu/dataloaders/bert4rec_dataloader.py``).

Capability parity with reference ``bert4rec/dataloaders/bert4rec_dataloader.py``:
special tokens ``[PAD],[MASK],[UNK]`` tokenized at init => ids 0,1,2 (:35-43);
``load_data`` = pandas -> sort -> group-by-user -> leave-one-out split ->
train duplication (:115-142); ``get_data`` adds per-split preprocessing and the
``finetuning_split`` carve-out (:64-113); ``prepare_training`` = vocab +
``get_data(split, mlm, finetuning_split=0.1)`` (:167-185).

The pipeline is host-side numpy end to end; the trainer moves its batches
to the card (``utils/prefetch.py``).
"""

import os
from typing import Optional, Union

from bert4rec_tpu_torch import tokenizers
from bert4rec_tpu_torch.dataloaders import dataloader_utils as utils
from bert4rec_tpu_torch.dataloaders import preprocessors
from bert4rec_tpu_torch.dataloaders.base_dataloader import BaseDataloader
from bert4rec_tpu_torch.dataloaders.processed_dataset import ProcessedDataset
from bert4rec_tpu_torch.dataloaders.sequence_dataset import split_dataset


class BERT4RecDataloader(BaseDataloader):
    """Not abstract — may be instantiated for pure feature preprocessing."""

    def __init__(self,
                 max_seq_len: int,
                 max_predictions_per_seq: int,
                 tokenizer: Union[str, tokenizers.BaseTokenizer] = "simple",
                 data_source=None,
                 preprocessor=preprocessors.BERT4RecPreprocessor,
                 masked_lm_prob: float = 0.2,
                 mask_token_rate: float = 1.0,
                 random_token_rate: float = 0.0,
                 input_duplication_factor: int = 1,
                 min_sequence_len: int = 5):
        tokenizer = tokenizers.get(tokenizer)
        preprocessor = preprocessors.get(preprocessor)
        super().__init__(tokenizer, data_source, preprocessor)

        if input_duplication_factor < 1:
            raise ValueError(
                "An input_duplication_factor of less than 1 is not allowed!")

        self._PAD_TOKEN = "[PAD]"
        self._MASK_TOKEN = "[MASK]"
        self._UNK_TOKEN = "[UNK]"
        self._PAD_TOKEN_ID = self.tokenizer.tokenize(self._PAD_TOKEN)
        self._MASK_TOKEN_ID = self.tokenizer.tokenize(self._MASK_TOKEN)
        self._UNK_TOKEN_ID = self.tokenizer.tokenize(self._UNK_TOKEN)
        self._SPECIAL_TOKENS = [self._PAD_TOKEN, self._UNK_TOKEN, self._MASK_TOKEN]
        # ordered: used for the models' prediction mask (reference :42-43)
        self._SPECIAL_TOKEN_IDS = [self._PAD_TOKEN_ID, self._MASK_TOKEN_ID,
                                   self._UNK_TOKEN_ID]
        self._MAX_PREDICTIONS_PER_SEQ = max_predictions_per_seq
        self._MAX_SEQ_LENGTH = max_seq_len
        self.masked_lm_prob = masked_lm_prob
        self.mask_token_rate = mask_token_rate
        self.random_token_rate = random_token_rate
        self.input_duplication_factor = input_duplication_factor
        self.min_sequence_len = min_sequence_len

    @property
    def dataset_identifier(self) -> str:
        raise NotImplementedError(
            "The dataset_identifier method hasn't been implemented.")

    # ------------------------------------------------------------------ #

    def _source_df(self, required_columns=None):
        """The raw extracted DataFrame, parsed once per (source, file,
        record cap): a full quality run otherwise re-parses the raw files
        three times (vocab generation, sequence building,
        item-list/popularity) — ~27 s each at ML-20M scale. The cached
        frame is pruned to the dataloader's declared columns (the unpruned
        ML-20M frame holds gigabytes of never-read rating/category
        strings); a caller needing other columns (``required_columns``)
        forces a fresh parse."""
        key = (self.data_source,
               getattr(self.data_source, "load_n_records", None),
               # the env smoke cap is resolved per load_data() call
               # (base_dataset.py), so it must be part of the cache
               # identity too — otherwise a capped frame could be served
               # after the cap is lifted
               os.environ.get("BERT4REC_TPU_LOAD_N_RECORDS"),
               str(getattr(self.data_source, "dest", None)))
        cached = getattr(self, "_raw_df_cache", None)
        if cached is not None and cached[0] == key:
            df = cached[1]
            if required_columns is None or all(
                    c in df.columns for c in required_columns):
                return df
        df = self.data_source.load_data()
        declared = [c for c in dict.fromkeys(
            getattr(self, "_declared_columns", lambda: [])())
            if c in df.columns]
        missing_req = [c for c in (required_columns or [])
                       if c not in declared]
        if declared and not missing_req:
            df = df[declared]
        self._raw_df_cache = (key, df)
        return df

    def _declared_columns(self) -> list:
        """Columns this dataloader reads from the raw frame (subclasses
        with declarative defaults narrow this; [] = keep everything)."""
        return []

    def load_data(self,
                  split_data: bool = True,
                  sort_by: Optional[str] = None,
                  extract_data: list = None,
                  duplication_factor: Optional[int] = None,
                  group_by: Optional[str] = None,
                  datatypes: list = None) -> tuple:
        """Raw df -> per-user sequences -> LOO split -> train duplication.

        ``datatypes`` is accepted for API parity but unused — the numpy
        pipeline needs no TF conversion hints.
        """
        extract_data = extract_data or []
        df = self._source_df([c for c in (group_by, sort_by, *extract_data)
                              if c is not None])
        # keep only the columns this pipeline reads BEFORE the sort — the
        # stable sort re-takes every column, and at ML-20M scale dropping
        # the unused ones (rating, categories, ...) saves tens of seconds
        needed = [c for c in dict.fromkeys(
            [group_by, sort_by, *extract_data]) if c in df.columns]
        if needed:
            df = df[needed]
        if sort_by is not None:
            df = df.sort_values(by=sort_by, kind="stable")

        main_col = extract_data[0]
        extra_cols = list(extract_data[1:])

        if not split_data:
            seq_df = utils.make_sequence_df(df, group_by, extract_data)
            dfs = (seq_df,)
        else:
            dfs = utils.split_sequence_df(df, group_by, extract_data,
                                          self.min_sequence_len)

        datasets = [
            utils.sequence_df_to_dataset(d, main_col, extra_cols) for d in dfs
        ]
        if duplication_factor is None:
            duplication_factor = self.input_duplication_factor
        datasets[0] = utils.duplicate_dataset(datasets[0], duplication_factor)
        return tuple(datasets)

    def get_data(self,
                 split_data: bool = True,
                 sort_by: Optional[str] = None,
                 extract_data: list = None,
                 duplication_factor: Optional[int] = None,
                 group_by: Optional[str] = None,
                 apply_mlm: bool = True,
                 finetuning_split: float = 0,
                 datatypes: list = None) -> tuple:
        if finetuning_split < 0 or finetuning_split > 1:
            raise ValueError(
                f"The finetuning_split argument has to be a float between 0 "
                f"and 1. Given: {finetuning_split}")

        datasets = self.load_data(split_data, sort_by, extract_data,
                                  duplication_factor, group_by)

        processed = []
        for i, ds in enumerate(datasets):
            if i >= 1:
                # val/test always use last-item-mask finetuning preprocessing
                processed.append(self.process_data(ds, apply_mlm,
                                                   finetuning=True))
            elif finetuning_split > 0:
                train_ds, ft_ds, _ = split_dataset(
                    ds, train_split=1 - finetuning_split,
                    val_split=finetuning_split, test_split=0.0)
                train = self.process_data(train_ds, apply_mlm, finetuning=False)
                ft = self.process_data(ft_ds, apply_mlm, finetuning=True)
                processed.append(train.concatenate(ft))
            else:
                processed.append(self.process_data(ds, apply_mlm,
                                                   finetuning=False))
        return tuple(processed)

    def process_data(self, ds, apply_mlm: bool = True,
                     finetuning: bool = False) -> ProcessedDataset:
        self._push_preprocessor_config()
        return self.preprocessor.process_dataset(ds, apply_mlm, finetuning)

    def _push_preprocessor_config(self):
        self.preprocessor.set_properties(
            tokenizer=self.tokenizer,
            max_seq_len=self._MAX_SEQ_LENGTH,
            max_predictions_per_seq=self._MAX_PREDICTIONS_PER_SEQ,
            mask_token_id=self._MASK_TOKEN_ID,
            unk_token_id=self._UNK_TOKEN_ID,
            pad_token_id=self._PAD_TOKEN_ID,
            masked_lm_rate=self.masked_lm_prob,
            mask_token_rate=self.mask_token_rate,
            random_token_rate=self.random_token_rate)

    def generate_vocab(self, source=None, progress_bar: bool = True) -> bool:
        if source is None:
            raise ValueError("Need a source to get the vocab from!")
        self.tokenizer.tokenize(source)
        return True

    def prepare_training(self,
                         sort_by: Optional[str] = None,
                         extract_data: list = None,
                         group_by: Optional[str] = None,
                         finetuning_split: float = 0.1,
                         datatypes: list = None) -> tuple:
        if finetuning_split < 0 or finetuning_split > 1:
            raise ValueError(
                "The finetuning_split argument has to be a float between 0 "
                f"and 1. Given: {finetuning_split}")
        self.generate_vocab()
        return self.get_data(split_data=True,
                             sort_by=sort_by,
                             extract_data=extract_data,
                             group_by=group_by,
                             apply_mlm=True,
                             finetuning_split=finetuning_split)

    def prepare_inference(self, data) -> dict:
        self._push_preprocessor_config()
        return self.preprocessor.prepare_inference(data)

    def prepare_inference_batch(self, sequences) -> dict:
        """Vectorized prepare_inference over many histories (serving)."""
        self._push_preprocessor_config()
        return self.preprocessor.prepare_inference_batch(sequences)

    def create_item_list(self) -> list:
        raise NotImplementedError(
            "This method hasn't been implemented yet in this dataloader "
            "class.")

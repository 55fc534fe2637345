"""BERT4Rec dataloader, inference half (port of
``bert4rec_tpu/dataloaders/bert4rec_dataloader.py``): the special tokens
``[PAD], [MASK], [UNK]`` are tokenized at construction, so a fresh
tokenizer gives them ids 0, 1, 2; ``prepare_inference`` and
``prepare_inference_batch`` turn raw item-string histories into features.
Training data loading is not ported yet."""

from typing import Union

from bert4rec_tpu_torch import tokenizers
from bert4rec_tpu_torch.dataloaders.preprocessors import BERT4RecPreprocessor


class BERT4RecDataloader:

    def __init__(self, max_seq_len: int, max_predictions_per_seq: int,
                 tokenizer: Union[str, tokenizers.BaseTokenizer] = "simple"):
        self.tokenizer = tokenizers.get(tokenizer)
        self.preprocessor = BERT4RecPreprocessor()
        self._PAD_TOKEN = "[PAD]"
        self._MASK_TOKEN = "[MASK]"
        self._UNK_TOKEN = "[UNK]"
        self._PAD_TOKEN_ID = self.tokenizer.tokenize(self._PAD_TOKEN)
        self._MASK_TOKEN_ID = self.tokenizer.tokenize(self._MASK_TOKEN)
        self._UNK_TOKEN_ID = self.tokenizer.tokenize(self._UNK_TOKEN)
        self._SPECIAL_TOKEN_IDS = [self._PAD_TOKEN_ID, self._MASK_TOKEN_ID,
                                   self._UNK_TOKEN_ID]
        self._MAX_PREDICTIONS_PER_SEQ = max_predictions_per_seq
        self._MAX_SEQ_LENGTH = max_seq_len

    def generate_vocab(self, source=None) -> bool:
        if source is None:
            raise ValueError("Need a source to get the vocab from!")
        self.tokenizer.tokenize(source)
        return True

    def _push_preprocessor_config(self):
        self.preprocessor.set_properties(
            tokenizer=self.tokenizer,
            max_seq_len=self._MAX_SEQ_LENGTH,
            max_predictions_per_seq=self._MAX_PREDICTIONS_PER_SEQ,
            mask_token_id=self._MASK_TOKEN_ID,
            unk_token_id=self._UNK_TOKEN_ID,
            pad_token_id=self._PAD_TOKEN_ID)

    def prepare_inference(self, data) -> dict:
        self._push_preprocessor_config()
        return self.preprocessor.prepare_inference(data)

    def prepare_inference_batch(self, sequences) -> dict:
        self._push_preprocessor_config()
        return self.preprocessor.prepare_inference_batch(sequences)

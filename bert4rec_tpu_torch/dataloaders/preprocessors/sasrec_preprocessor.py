"""SASRec feature preprocessor (port of
``bert4rec_tpu/dataloaders/preprocessors/sasrec_preprocessor.py``).

The tokenize / truncate / pad machinery of :class:`BERT4RecPreprocessor`;
the produced :class:`ProcessedDataset` runs the ``"next_item"`` task: the
final item leaves the model input and every remaining position predicts
its successor (finetuning rows predict only the held-out last item).

Inference keeps the append-a-placeholder step: the appended ``[UNK]``
becomes the "final item" the task drops, so the prediction slot sits at
the last real history position.
"""

import numpy as np

from bert4rec_tpu_torch.dataloaders.preprocessors.bert4rec_preprocessor import (
    BERT4RecPreprocessor,
)
from bert4rec_tpu_torch.dataloaders.processed_dataset import ProcessedDataset


class SASRecPreprocessor(BERT4RecPreprocessor):

    _TASK = "next_item"

    def prepare_inference_batch(self, sequences) -> dict:
        """Many histories at once: the placeholder-appended tokens as the
        next-item task's finetuning rows."""
        tokens = self._inference_tokens(sequences)
        return ProcessedDataset(
            tokens, self._masking_config(),
            vocab_size_fn=self.tokenizer.get_vocab_size, apply_mlm=True,
            finetuning=np.ones(len(tokens), bool),
            task=self._TASK).materialize()

from bert4rec_tpu_torch.dataloaders.preprocessors.bert4rec_preprocessor import (
    BERT4RecPreprocessor,
)

__all__ = ["BERT4RecPreprocessor"]

from bert4rec_tpu_torch.dataloaders.bert4rec_dataloader import (
    BERT4RecDataloader,
)

__all__ = ["BERT4RecDataloader"]

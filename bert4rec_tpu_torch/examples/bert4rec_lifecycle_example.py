"""Full model lifecycle on synthetic data (port of
``examples/bert4rec_lifecycle_example.py``; reference
examples/bert4rec_lifecycle_example.py): build -> train -> evaluate ->
save -> load -> recommend. Runs anywhere (no downloads); on the card the
fused layer and loss kernels run::

    python -m bert4rec_tpu_torch.examples.bert4rec_lifecycle_example \\
        [--device cpu]
"""

import pathlib
import tempfile

import numpy as np
import pandas as pd

from bert4rec_tpu_torch.apps import Recommender
from bert4rec_tpu_torch.dataloaders import BERT4RecML1MDataloader
from bert4rec_tpu_torch.evaluation import BERT4RecEvaluator
from bert4rec_tpu_torch.examples._common import card_config, command_line
from bert4rec_tpu_torch.models import (
    BERT4RecConfig, BERT4RecModel, BERT4RecModelWrapper,
)
from bert4rec_tpu_torch.trainers import BERT4RecTrainer, optimizers


def synthetic_interactions(n_users=60, n_items=50, seed=0):
    rng = np.random.default_rng(seed)
    items = [f"movie {i}" for i in range(n_items)]
    rows = []
    for uid in range(n_users):
        for t in range(int(rng.integers(6, 24))):
            rows.append((uid, items[int(rng.integers(0, n_items))], t))
    df = pd.DataFrame(rows, columns=["uid", "movie_name", "timestamp"])

    class SyntheticDataset:
        @classmethod
        def load_data(cls):
            return df
    return SyntheticDataset, items


def main(device="cuda") -> dict:
    data_source, items = synthetic_interactions()
    dataloader = BERT4RecML1MDataloader(
        max_seq_len=16, max_predictions_per_seq=4, data_source=data_source,
        input_duplication_factor=2)
    train_ds, val_ds, test_ds = dataloader.prepare_training()
    tokenizer = dataloader.get_tokenizer()

    config = card_config(BERT4RecConfig(
        vocab_size=tokenizer.get_vocab_size(), hidden_size=32, num_layers=2,
        num_attention_heads=4, inner_dim=64, max_sequence_length=16,
        max_predictions_per_seq=4), device)
    model = BERT4RecModel(config=config)
    trainer = BERT4RecTrainer(model)
    trainer.initialize_model(
        optimizer=optimizers.create_adam_w_optimizer(
            init_lr=1e-3, num_train_steps=2000, num_warmup_steps=20),
        seed=0, device=device)
    history = trainer.train(train_ds, val_ds, epochs=5, batch_size=32)

    evaluator = BERT4RecEvaluator(dataloader=dataloader, sample_size=20)
    metrics = evaluator.evaluate(model, trainer.params, test_ds)
    print("eval:", metrics)

    with tempfile.TemporaryDirectory() as td:
        save_path = pathlib.Path(td) / "lifecycle_model"
        wrapper = BERT4RecModelWrapper(model, trainer.params)
        trainer.update_wrapper_meta_info(wrapper, dataloader)
        wrapper.save(save_path, tokenizer=tokenizer, mode=2)
        files = sorted(p.name for p in save_path.iterdir())

        restored, extras = BERT4RecModelWrapper.load(save_path, mode=2,
                                                     device=device)
        recommender = Recommender(restored.model, restored.params,
                                  dataloader, device=device)
        history_items = items[:5]
        print("history:", history_items)
        recommendation = recommender(history_items)
        print("recommendation:", recommendation)
    return {"loss": history.history["loss"], "metrics": metrics,
            "files": files, "recommendation": recommendation}


if __name__ == "__main__":
    main(**command_line(__doc__))

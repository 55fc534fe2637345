"""Canonical end-to-end training example on ML-1M
(port of ``examples/bert4rec_ml_1m_example.py``; reference
examples/bert4rec_ml_1m_example.py:14-95): 150 epochs, batch 256,
input duplication 5, finetuning split 0.1, ml-1m_128 encoder config.

Trains on the dataset on disk (under ``BERT4REC_TPU_HOME``), evaluates,
and saves the model under ``saved_models/bert4rec_ml-1m_128``::

    python -m bert4rec_tpu_torch.examples.bert4rec_ml_1m_example \\
        [--device cpu]
"""

from bert4rec_tpu_torch.examples._common import (
    command_line, run_training_example,
)


def main(device="cuda"):
    return run_training_example(
        dataset="ml_1m",
        encoder_config="ml-1m_128",
        epochs=150,
        batch_size=256,
        input_duplication_factor=5,
        finetuning_split=0.1,
        early_stopping_patience=20,
        save_name="bert4rec_ml-1m_128",
        device=device,
    )


if __name__ == "__main__":
    main(**command_line(__doc__))
